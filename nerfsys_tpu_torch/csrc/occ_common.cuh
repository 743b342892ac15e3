// Kernel 2's cell selection (occ_probe.cu), which selects the plain
// version's cells bit for bit (nerfsys_tpu/ops/occupancy.py
// `_finest_level_index` :121). Kernel 11q (occ_query.cu) tests levels on
// the same bounds but selects its cells without division.
//
// The level table is ops/occupancy.py `level_bounds`: per level of each
// expert's box, BOX_FLOATS floats a[3], b[3], lo[3], w[3]. rel = (x - lo)
// / w is monotone in x, so 0 <= rel < 1 holds on an axis exactly for a <=
// x < b: a level is tested by comparison, and only the deciding level
// divides. Kernel 2 copies the table into shared memory and reads a level
// as three float4: (a, b.x), (b.y, b.z, lo.x, lo.y), (lo.z, w).
#pragma once

#include "common.cuh"

#define BOX_FLOATS 12  // a[3], b[3], lo[3], w[3] a level

// The flat cell index of expert k's deciding level at (x, y, z) in the
// stacked (K, L, R, R, R) grid, or -1 when no level contains the point.
// `box` holds the K x L level table.
__device__ __forceinline__ int locate(const float4* box, int k, int L, int R,
                                      float x, float y, float z) {
    for (int l = 0; l < L; ++l) {
        const float4* b = box + (k * L + l) * (BOX_FLOATS / 4);
        const float4 q0 = b[0], q1 = b[1];
        if (x >= q0.x && x < q0.w && y >= q0.y && y < q1.x && z >= q0.z &&
            z < q1.y) {
            const float4 q2 = b[2];
            const float rx = (x - q1.z) / q2.y;
            const float ry = (y - q1.w) / q2.z;
            const float rz = (z - q2.x) / q2.w;
            const int i0 = min(max(__float2int_rz(rx * (float)R), 0), R - 1);
            const int i1 = min(max(__float2int_rz(ry * (float)R), 0), R - 1);
            const int i2 = min(max(__float2int_rz(rz * (float)R), 0), R - 1);
            return (((k * L + l) * R + i0) * R + i1) * R + i2;
        }
    }
    return -1;
}
