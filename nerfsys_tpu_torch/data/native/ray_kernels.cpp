// Native host data-loader kernels: frame rays, per-image ray compaction,
// sampled and exact-DDA routing of rays to micro-cells.
//
// The port's own copy of nerfsys_tpu/data/native/ray_kernels.cpp, with the
// arithmetic of its four entry points unchanged. The C++ counterparts of
// the numpy math in nerfsys_tpu_torch/data/ram_rays.py (np_ray_directions /
// np_get_rays / np_ray_aabb_intersect / np_clamp_rays) and
// nerfsys_tpu_torch/data/task_dataset.py (route_rays_to_cells,
// _dda_route_numpy). One call handles a whole image or ray set with
// internal threading.
//
// Build: g++ -O3 -std=c++17 -fPIC -shared -pthread (see native/__init__.py;
// loaded via ctypes). -std=c++17 (not gnu++17) keeps GCC at
// -ffp-contract=off: no multiply-add is contracted, so the DDA rounds as
// the numpy router does, bit for bit.

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <limits>
#include <thread>
#include <vector>

namespace {

constexpr float kMiss = 1e10f;

struct Cam {
  int H, W;
  float fx, fy, cx, cy;
  bool center_pixels;
  const float* c2w;   // (3,4) row-major
  const float* aabb;  // 6 floats or nullptr: [min x y z, max x y z]
  float near_override;  // < 0 -> unset
  float far_override;   // < 0 -> unset
};

inline void slab_intersect(const float* aabb, const float o[3],
                           const float d[3], float* tmin_out,
                           float* tmax_out) {
  const float eps = 1e-8f;
  float tmin = -kMiss, tmax = kMiss;
  for (int a = 0; a < 3; ++a) {
    float da = d[a];
    if (std::fabs(da) < eps) da = (da >= 0.f) ? eps : -eps;
    const float inv = 1.0f / da;
    float t0 = (aabb[a] - o[a]) * inv;
    float t1 = (aabb[3 + a] - o[a]) * inv;
    if (t0 > t1) { const float tmp = t0; t0 = t1; t1 = tmp; }
    if (t0 > tmin) tmin = t0;
    if (t1 < tmax) tmax = t1;
  }
  if (tmin < 0.f) tmin = 0.f;
  if (tmin > kMiss) tmin = kMiss;
  if (tmax < -kMiss) tmax = -kMiss;
  if (tmax > kMiss) tmax = kMiss;
  const bool valid = tmax > tmin;
  *tmin_out = valid ? tmin : kMiss;
  *tmax_out = valid ? tmax : kMiss;
}

void rows_worker(const Cam cam, int j0, int j1, float* out_rays,
                 uint8_t* out_valid, std::atomic<long long>* n_valid) {
  const float* R = cam.c2w;  // rows: R[0..3], R[4..7], R[8..11] (3x4)
  const float ox = R[3], oy = R[7], oz = R[11];
  const float off = cam.center_pixels ? 0.5f : 0.0f;
  long long local_valid = 0;
  for (int j = j0; j < j1; ++j) {
    const float v = -((static_cast<float>(j) + off) - cam.cy) / cam.fy;
    float* row = out_rays + static_cast<long long>(j) * cam.W * 8;
    uint8_t* vrow = out_valid + static_cast<long long>(j) * cam.W;
    for (int i = 0; i < cam.W; ++i) {
      const float u = ((static_cast<float>(i) + off) - cam.cx) / cam.fx;
      // camera RUB dir (u, v, -1), normalized
      const float inv_n = 1.0f / std::sqrt(u * u + v * v + 1.0f);
      const float dc[3] = {u * inv_n, v * inv_n, -inv_n};
      // world dir = R(:, :3) @ dc
      const float d[3] = {
          R[0] * dc[0] + R[1] * dc[1] + R[2] * dc[2],
          R[4] * dc[0] + R[5] * dc[1] + R[6] * dc[2],
          R[8] * dc[0] + R[9] * dc[1] + R[10] * dc[2],
      };
      const float o[3] = {ox, oy, oz};

      float tn, tf;
      if (cam.aabb != nullptr) {
        slab_intersect(cam.aabb, o, d, &tn, &tf);
      } else {
        tn = cam.near_override >= 0.f ? cam.near_override : 0.0f;
        tf = cam.far_override >= 0.f ? cam.far_override : kMiss;
      }
      // clamp overrides (np_clamp_rays)
      if (cam.near_override >= 0.f && tn < cam.near_override)
        tn = cam.near_override;
      if (cam.far_override >= 0.f && tf > cam.far_override)
        tf = cam.far_override;
      const bool valid =
          std::isfinite(tn) && std::isfinite(tf) && (tf > tn + 1e-6f) &&
          (tn < 1e9f) && (tf < 1e10f);

      float* px = row + static_cast<long long>(i) * 8;
      px[0] = o[0]; px[1] = o[1]; px[2] = o[2];
      px[3] = d[0]; px[4] = d[1]; px[5] = d[2];
      const float inf = std::numeric_limits<float>::infinity();
      px[6] = valid ? tn : inf;
      px[7] = valid ? tf : inf;
      vrow[i] = valid ? 1 : 0;
      local_valid += valid ? 1 : 0;
    }
  }
  n_valid->fetch_add(local_valid, std::memory_order_relaxed);
}

}  // namespace

extern "C" {

// Compute all H*W rays of one pinhole image. Returns the number of valid
// rays. out_rays: (H*W, 8) float32 [o, d, near, far] (invalid -> near/far
// = +inf, matching np_clamp_rays); out_valid: (H*W,) uint8.
long long nerfsys_compute_rays(
    int H, int W, float fx, float fy, float cx, float cy, int center_pixels,
    const float* c2w, const float* aabb, float near_override,
    float far_override, float* out_rays, uint8_t* out_valid, int n_threads) {
  Cam cam{H, W, fx, fy, cx, cy, center_pixels != 0,
          c2w, aabb, near_override, far_override};
  if (n_threads <= 0) {
    n_threads = static_cast<int>(std::thread::hardware_concurrency());
    if (n_threads <= 0) n_threads = 4;
  }
  if (n_threads > H) n_threads = H > 0 ? H : 1;

  std::atomic<long long> n_valid{0};
  if (n_threads == 1) {
    rows_worker(cam, 0, H, out_rays, out_valid, &n_valid);
  } else {
    std::vector<std::thread> ts;
    ts.reserve(n_threads);
    const int rows = (H + n_threads - 1) / n_threads;
    for (int t = 0; t < n_threads; ++t) {
      const int j0 = t * rows;
      const int j1 = std::min(H, j0 + rows);
      if (j0 >= j1) break;
      ts.emplace_back(rows_worker, cam, j0, j1, out_rays, out_valid, &n_valid);
    }
    for (auto& th : ts) th.join();
  }
  return n_valid.load();
}

// Compact rays/rgb by a keep-mask AND validity; rgb is converted
// uint8 -> float32/255 in the same pass. Returns rows written.
long long nerfsys_compact_rays(
    const float* rays, const uint8_t* valid, const uint8_t* keep /*or null*/,
    const uint8_t* rgb_u8, long long n, float* out_rays, float* out_rgb) {
  long long m = 0;
  for (long long i = 0; i < n; ++i) {
    if (!valid[i]) continue;
    if (keep != nullptr && !keep[i]) continue;
    const float* src = rays + i * 8;
    float* dst = out_rays + m * 8;
    for (int k = 0; k < 8; ++k) dst[k] = src[k];
    const uint8_t* c = rgb_u8 + i * 3;
    float* oc = out_rgb + m * 3;
    oc[0] = c[0] * (1.0f / 255.0f);
    oc[1] = c[1] * (1.0f / 255.0f);
    oc[2] = c[2] * (1.0f / 255.0f);
    ++m;
  }
  return m;
}

}  // extern "C"

extern "C" {

// Route each ray to the micro-cell it overlaps most (majority vote over P
// uniform samples in [near, far]); -1 when the ray misses the grid. The
// native counterpart of data/task_dataset.route_rays_to_cells — numpy
// broadcasting materializes (N, P, 3) temporaries that crush small hosts.
void nerfsys_route_rays(
    const float* rays,       // (N, 8)
    long long n,
    const float* aabb,       // 6 floats [min xyz, max xyz]
    int dx, int dy, int dz,  // cell grid dims
    const float* ts,         // (P,) sample fractions in [0, 1)
    int P,
    long long* out_cell,     // (N,)
    int n_threads) {
  const int n_cells = dx * dy * dz;
  const float lox = aabb[0], loy = aabb[1], loz = aabb[2];
  const float ex = std::max(aabb[3] - aabb[0], 1e-8f);
  const float ey = std::max(aabb[4] - aabb[1], 1e-8f);
  const float ez = std::max(aabb[5] - aabb[2], 1e-8f);

  if (n_threads <= 0) {
    n_threads = static_cast<int>(std::thread::hardware_concurrency());
    if (n_threads <= 0) n_threads = 1;
  }

  auto worker = [&](long long i0, long long i1) {
    std::vector<int> counts(n_cells);
    for (long long i = i0; i < i1; ++i) {
      const float* r = rays + i * 8;
      float near = r[6], far = r[7];
      if (!std::isfinite(near) || !std::isfinite(far) || !(far > near)) {
        out_cell[i] = -1;
        continue;
      }
      std::fill(counts.begin(), counts.end(), 0);
      for (int p = 0; p < P; ++p) {
        const float t = near + (far - near) * ts[p];
        const float x = r[0] + r[3] * t;
        const float y = r[1] + r[4] * t;
        const float z = r[2] + r[5] * t;
        const int ix = static_cast<int>(std::floor((x - lox) / ex * dx));
        const int iy = static_cast<int>(std::floor((y - loy) / ey * dy));
        const int iz = static_cast<int>(std::floor((z - loz) / ez * dz));
        if (ix < 0 || ix >= dx || iy < 0 || iy >= dy || iz < 0 || iz >= dz)
          continue;
        const int c = (ix * dy + iy) * dz + iz;
        ++counts[c];
      }
      // argmax with lowest-index tie-break (numpy argmax parity)
      int best = -1, best_n = 0;
      for (int c = 0; c < n_cells; ++c) {
        if (counts[c] > best_n) { best_n = counts[c]; best = c; }
      }
      out_cell[i] = best;
    }
  };

  if (n_threads == 1 || n < 4096) {
    worker(0, n);
  } else {
    std::vector<std::thread> thr;
    const long long step = (n + n_threads - 1) / n_threads;
    for (int t = 0; t < n_threads; ++t) {
      const long long i0 = t * step, i1 = std::min(n, i0 + step);
      if (i0 >= i1) break;
      thr.emplace_back(worker, i0, i1);
    }
    for (auto& th : thr) th.join();
  }
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Exact 3D-DDA max-overlap routing — TaskDataset's routing policy plus its
// weak-overlap bin filter, reproduced bit-for-bit in scalar form. The
// Python counterpart (task_dataset._dda_route_numpy) is the vectorized
// spec; this kernel removes the 64x per-ray numpy broadcast cost. Unlike
// the JAX package's copy, the filter rounds the selected cell's box and its
// tolerance as the spec does (float64 fractions, a per-cell tolerance):
// that copy rounds them in float32 and disagrees with the spec on rays
// that start on or graze a cell face.
// ---------------------------------------------------------------------------
namespace {

constexpr float kBig = 1e30f;

// Reference _aabb_intersect semantics (task_dataset.py:129-152): IEEE 1/d
// (inf on axis-parallel), explicit outside-parallel miss test, NO clamping.
inline void ref_slab(const float o[3], const float d[3], const float lo[3],
                     const float hi[3], bool* hit, float* t_entry,
                     float* t_exit) {
  const float eps = 1e-12f;
  float tmin = -std::numeric_limits<float>::infinity();
  float tmax = std::numeric_limits<float>::infinity();
  bool miss_parallel = false;
  for (int a = 0; a < 3; ++a) {
    if (std::fabs(d[a]) < eps && !(o[a] >= lo[a] && o[a] <= hi[a]))
      miss_parallel = true;
    const float inv = 1.0f / d[a];  // +-inf when parallel, as in torch
    float t0 = (lo[a] - o[a]) * inv;
    float t1 = (hi[a] - o[a]) * inv;
    const float lo_t = std::fmin(t0, t1);  // fmin/fmax ignore one NaN arg
    const float hi_t = std::fmax(t0, t1);
    tmin = std::fmax(tmin, lo_t);
    tmax = std::fmin(tmax, hi_t);
  }
  *t_entry = tmin;
  *t_exit = tmax;
  *hit = (tmax >= tmin) && !miss_parallel;
}

// Overlap length of a ray (clipped to [max(near,0), far]) with one cell
// (task_dataset.py:210-226 _overlap_len_with_cell).
inline float overlap_len(const float* r, const float lo[3], const float hi[3]) {
  const float o[3] = {r[0], r[1], r[2]};
  const float d[3] = {r[3], r[4], r[5]};
  bool hit;
  float te, tx;
  ref_slab(o, d, lo, hi, &hit, &te, &tx);
  if (!hit) return 0.0f;
  float t0 = std::fmax(te, 0.0f);
  float t1 = tx;
  t0 = std::fmax(t0, r[6]);
  t1 = std::fmin(t1, r[7]);
  const float len = t1 - t0;
  return (std::isfinite(len) && len > 0.0f) ? len : 0.0f;
}

}  // namespace

extern "C" {

// Route each ray to the micro-cell whose in-cell path length is largest
// (exact amanatides-woo DDA, max_steps iterations), then apply the
// reference's weak-overlap filter against the SELECTED cell. out_cell[i]
// is -1 when the ray misses the region segment or fails the filter.
void nerfsys_dda_route(
    const float* rays,  // (N, 8) [o, d, near, far]
    long long n,
    const float* aabb,  // region box, 6 floats [min xyz, max xyz]
    int nx, int ny, int nz,
    int max_steps,
    long long* out_cell,  // (N,)
    int n_threads) {
  const float lo[3] = {aabb[0], aabb[1], aabb[2]};
  const float hi[3] = {aabb[3], aabb[4], aabb[5]};
  // grid-unit transform g = (p - lo) / cell_size  (task_dataset.py:242-250)
  float cell[3];
  const int dims[3] = {nx, ny, nz};
  for (int a = 0; a < 3; ++a)
    cell[a] = std::fmax((hi[a] - lo[a]) / static_cast<float>(dims[a]), 1e-12f);
  const long long nyz = static_cast<long long>(ny) * nz;

  auto worker = [&](long long i0, long long i1) {
    for (long long i = i0; i < i1; ++i) {
      const float* r = rays + i * 8;
      const float o[3] = {r[0], r[1], r[2]};
      const float d[3] = {r[3], r[4], r[5]};
      // region segment (task_dataset.py:154-171)
      bool hit;
      float te, tx;
      ref_slab(o, d, lo, hi, &hit, &te, &tx);
      float t0 = std::fmax(std::fmax(te, 0.0f), r[6]);
      float t1 = std::fmin(tx, r[7]);
      const float seg = t1 - t0;
      if (!hit || !(seg > 0.0f) || !std::isfinite(seg)) {
        out_cell[i] = -1;
        continue;
      }
      // DDA init at t0+eps (task_dataset.py:252-297)
      float g_o[3], g_d[3], p[3];
      for (int a = 0; a < 3; ++a) {
        g_o[a] = (o[a] - lo[a]) / cell[a];
        g_d[a] = d[a] / cell[a];
        p[a] = g_o[a] + g_d[a] * (t0 + 1e-6f);
      }
      long long ix[3];
      int step[3];
      float tMax[3], tDelta[3];
      for (int a = 0; a < 3; ++a) {
        ix[a] = static_cast<long long>(std::floor(p[a]));
        step[a] = (g_d[a] > 0.f) ? 1 : ((g_d[a] < 0.f) ? -1 : 0);
        const float nb = (step[a] > 0) ? std::floor(p[a]) + 1.0f
                                       : std::ceil(p[a]) - 1.0f;
        const float inv = 1.0f / g_d[a];
        float tm = (nb - p[a]) * inv;
        float td = static_cast<float>(step[a]) * inv;
        if (!std::isfinite(tm)) tm = kBig;
        if (!std::isfinite(td)) td = kBig;
        tMax[a] = tm;
        tDelta[a] = td;
        ix[a] = std::min<long long>(std::max<long long>(ix[a], 0),
                                    dims[a] - 1);
      }
      float t = t0;
      float best_len = 0.0f;
      long long best_cid = ix[0] * nyz + ix[1] * nz + ix[2];
      for (int s = 0; s < max_steps; ++s) {
        const float m = std::fmin(std::fmin(tMax[0], tMax[1]), tMax[2]);
        const float t_next = std::fmin(m, t1);
        const float dt = std::fmax(t_next - t, 0.0f);
        const long long cid = ix[0] * nyz + ix[1] * nz + ix[2];
        if (dt > best_len) {  // strict: first-best wins, as in reference
          best_len = dt;
          best_cid = cid;
        }
        if (t_next >= t1) break;
        // axis advance priority exactly as the reference's boolean algebra
        const bool adv_x = (tMax[0] <= tMax[1]) && (tMax[0] <= tMax[2]);
        const bool adv_y = !(tMax[0] <= tMax[1]) && (tMax[1] <= tMax[2]);
        const bool adv_z = !(adv_x || adv_y);
        if (adv_x) {
          ix[0] = std::min<long long>(std::max<long long>(ix[0] + step[0], 0),
                                      nx - 1);
          tMax[0] += tDelta[0];
        }
        if (adv_y) {
          ix[1] = std::min<long long>(std::max<long long>(ix[1] + step[1], 0),
                                      ny - 1);
          tMax[1] += tDelta[1];
        }
        if (adv_z) {
          ix[2] = std::min<long long>(std::max<long long>(ix[2] + step[2], 0),
                                      nz - 1);
          tMax[2] += tDelta[2];
        }
        t = t_next;
      }
      // weak-overlap filter vs the selected cell (task_dataset.py:589-599),
      // with the cell box and tolerance rounded as build_cell_bounds and
      // _weak_overlap_keep compute them: float64 fractions i * (1 / n)
      // (np.linspace; the last one exactly 1), the box size clamped at
      // 1e-9, lo + size * fraction in float64 rounded once to float32,
      // and the tolerance from that box's own widths
      const long long ijk[3] = {best_cid / nyz, (best_cid % nyz) / nz,
                                best_cid % nz};
      float clo[3], chi[3];
      for (int a = 0; a < 3; ++a) {
        const double size = std::fmax(hi[a] - lo[a], 1e-9f);
        const double step = 1.0 / dims[a];
        const double f0 = static_cast<double>(ijk[a]) * step;
        const double f1 = ijk[a] + 1 == dims[a]
                              ? 1.0
                              : static_cast<double>(ijk[a] + 1) * step;
        clo[a] = static_cast<float>(lo[a] + size * f0);
        chi[a] = static_cast<float>(lo[a] + size * f1);
      }
      const float w0 = chi[0] - clo[0], w1 = chi[1] - clo[1],
                  w2 = chi[2] - clo[2];
      const float keep_tol =
          std::fmax(1e-6f * std::sqrt(w0 * w0 + w1 * w1 + w2 * w2), 1e-9f);
      const float len = overlap_len(r, clo, chi);
      out_cell[i] = (len >= keep_tol) ? best_cid : -1;
    }
  };

  if (n_threads <= 0) {
    n_threads = static_cast<int>(std::thread::hardware_concurrency());
    if (n_threads <= 0) n_threads = 1;
  }
  if (n_threads == 1 || n < 4096) {
    worker(0, n);
  } else {
    std::vector<std::thread> thr;
    const long long chunk = (n + n_threads - 1) / n_threads;
    for (int t = 0; t < n_threads; ++t) {
      const long long i0 = t * chunk, i1 = std::min(n, i0 + chunk);
      if (i0 >= i1) break;
      thr.emplace_back(worker, i0, i1);
    }
    for (auto& th : thr) th.join();
  }
}

}  // extern "C"
