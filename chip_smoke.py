#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (nerfsys_tpu_torch) on one NVIDIA card.

Run from the repository root on a machine with a CUDA card:

    python3 chip_smoke.py

Phases, in order (any failure raises and the script exits non-zero before
printing its result lines):

1. Card: name and power limit (nvidia-smi).
2. Build: compile every kernel source in nerfsys_tpu_torch/csrc with nvcc
   (one process per source, all at once) and report the seconds; then
   the native host ray kernels (nerfsys_tpu_torch/data/native, g++) and
   their seconds. `native:` lines: one 800x800 frame of the serve pose
   through `frame_rays`, native and numpy in turns (host ms of each; the
   valid masks equal, o/d within 1e-5, near/far on valid rays within
   1e-4 + 1e-5 |x|, the largest errors printed), with the host's cores.
3. Kernels: hold each forward kernel against its plain PyTorch version on
   the card at one full serve chunk (65,536 rays, S=32 samples, P=128
   probes; K=4 experts at bench width; R=128, L=4 occupancy grids half
   occupied), and each backward kernel at one full inner step of one
   bench-width expert (4,000 rays x 32 samples), and time both with CUDA
   events. Kernels 1, 5 and 6 (the plane encoder and its light and exact
   backward) are also held to their plain versions on adversarial inputs
   at those shapes: every point in one cell, coordinates of exactly 0 and
   1 and outside [0, 1], a tail tile, a single point (5, 6), no lines,
   F=2 (the scalar variant), K=4 stacked experts, L=5 base 128, and the
   backward's line-gradient variants (the coarsest level private, all
   levels private, none); each line prints the launch plan. Kernel 4's
   VJP too, at 4,000 rays: alpha at its clip, sigma exactly 0, rgb
   exactly 0 and 1, dt at its floor, S = 2, 8, 31, 33, 64, 97, each
   upstream gradient alone and all four, no background, sigma_scale 25
   (`edge volume_render_bwd` lines), and kernel 4 on the same cases at
   4,013 rays (`edge volume_render_fwd` lines). Kernel 2 on adversarial
   inputs under both lane maps (`edge occupancy_probe_cdf` lines: probe
   points on level borders and one ulp either side, points outside every
   level, all-dead rays, one occupied cell, sum(val) on both sides of
   1e-12, P = 32, 100, 256, K=1 L=1, K=1 L=4, K=5, importance and
   ray_floor on and off; 0 bit flips, the cdf bit-equal), its bound also by
   the distinct 32-byte sectors the selected cells touch, its time by
   lane map and without value reads. Kernel 3 (the sampler) also on
   adversarial inputs (`edge sample_tvals_from_cdf` lines: rows that dip
   by one ulp after dead probes, entries under the 1e-12 clamp, targets
   equal to cdf entries and at 1 - 1e-6, all-dead rows, near = far,
   jittered targets out of order, P = 1, 127, 129, 256 x S = 1, 8, 24,
   64, and kernel 2's own rows over dead, tiny and random probes; error
   0 expected, tol 1e-5;
   each line with the rows that took the literal count and the rank sort,
   and both branches of both must be reached; each case also with the
   probe bits, kernel 3m: `edge sample_tvals_from_cdf mask` lines, the
   mask equal to the plain version's (its stable sort: ties of t within
   two ulps, in sorted and in rank-sorted rows) and t equal to the
   kernel's without the mask). Kernel 11q (the occupancy point query,
   unioned over the K experts) at the serve chunk's 2,097,152 sample
   points (K=4) and the step's 4,000 x 32 (the K=1 slice), in each mode
   (bits, values, pair; equal to the plain version), by device time,
   back to back and on the host clock beside its bound (points in,
   outputs out, the distinct 32-byte grid sectors read), and on
   adversarial inputs (`edge occupancy_query` lines: points on level
   faces and one ulp either side, outside every level, rel * R at the top
   of the last cell, on the cells' step points and one ulp either side
   at R = 128 and 127, invisible cells tagged -1,
   K = 1, 4, 5, a tail past whole blocks, M = 1 and 0); kernel 3m timed
   at both shapes beside kernel 3. Kernels 2, 3 and 4 are
   also timed at the step's shapes (the K=1 task probe, 4,000 x 32),
   back to back and by device time, beside their bounds, and kernel 3's
   jittered per-ray output is held to its plain version there; kernels 2,
   3 and 4's headline times are device times.
4. Serve: a soft-occupancy chunk renderer at bench width renders one
   warm-up frame and then 3 requests of 800x800 frames through
   `render_image`. Every output must be finite with rgb and acc in [0, 1],
   every serving kernel's launch counter must have moved during the 3
   requests, and one chunk rendered through the kernels must match the
   same chunk rendered through the plain versions. Camera: the live
   camera renderer (`make_live_camera_renderer`: rays generated on the
   card, every chunk dispatched before the one fetch) with the same
   settings renders one warm-up and 3 uint8 800x800 frames of the same
   poses (kernels 1-4 must launch during them), and `render_image` the
   same poses; both wall times per frame and one profiled frame of each
   (device busy ms, idle share); each pose's float planes against
   render_image's outputs within the serve tolerances, with at most 0.5%
   of the rays beyond them (the two generate their rays apart, an ulp from
   a cell wall a probe can take the other cell); the uint8 frame against the
   camera renderer's plain path within 1 level in >= 99.9% of the pixels;
   one hard-mask frame and one with the res-128 union probe grid against
   render_image through the chunk renderer of the same mode. The
   hard-mask frame is drawn in both forms: point-exact (kernel 11q
   launched) and with occ_probe_mask (the probe bits; 11q not launched),
   each camera frame and live frame (render_image through the two-wave
   renderer) against its plain path within the serve tolerances under
   the 0.5% flip share, ms per frame and device busy ms of both forms
   side by side.
5. Early stop: kernel row 8 (segmented compositing with a carried
   transmittance) against its plain version at one serve chunk's first
   segment (65,536 rays x 8 samples, fresh carry) and one resume slice
   (16,384 x 24, that carry), fog off and on, at two densities, timed
   back to back and by device time beside its byte bound; the 8 + 24
   split against kernel 4's one-shot; and on adversarial inputs (`edge
   composite_segment` lines: s = 1, 2, 8, 24, 31, 33, 64, alpha at its
   clip, sigma exactly 0, carried transmittance 0, 1 and 1e-30, fog on
   and off, t and dt as column slices and contiguous, N = 0, 1, tails;
   within 1e-5, each with its plan and device time). Then the soft-mode early-stop renderer (eps 1e-4,
   32 samples split 8 + 24) serves one warm-up and 3 requests of 800x800
   through `render_image` at sigma_scale 1 and at the opaque scale, each
   against the same frames through the one-shot program (within the eps
   bound; at the opaque scale rays must terminate); row 8 must have
   launched and kernel 4 not, during those requests. Then measure_perf's
   half-sky frame (640,000 rays) on its sky grid through
   `render_rays_chunked` with the hard-mask two-wave renderer (within
   1e-5 of the one-shot, chunks skipped or packed, a dead chunk through
   the background program equal to the one-shot) and the hard-mask
   early-stop renderer at the opaque scale; one frame at each scale is
   profiled (row 8's launches x ms watched).
6. Baked: bake the bench-width container into the serve snapshot (256³,
   SH-3, 32 directions, pack 8, sparse blocks of 8³, bf16, occupancy-aware
   on a synthetic R=64 L=2 grid, 2 dilations) through `bake_field`; hold
   a 128³ f32 sparse bake through the kernels against the same bake
   through `use_kernels=False` (same block index, values within 1e-5 of
   the table's max); hold
   kernel 8 (the packed-corner trilinear lookup) against its plain version
   at one full serve chunk on four tables (the serve table, 256³ pack-4
   dense bf16, 64³ pack-2 dense bf16, 128³ pack-4 sparse f32) and time it
   beside one `grid_sample` over the dense volume, and on adversarial
   points on each table (the box's top faces, exactly lo and outside the
   box, one cell, both sides of sparse block and super-block edges, a
   tail of 13 points past whole warps, a single point; error 0
   expected, each line with its launch plan); then serve one warm-up
   and 3 800x800 uint8 frames through `make_baked_camera_renderer` (rays
   generated on the card). Kernels 8 and 4 must have launched during the
   3 requests; the same frame through `use_kernels=False` must lie within
   1 level in >= 99.9% of pixels, and one chunk through
   `make_baked_chunk_renderer` within 1e-4 (rgb, acc) / 1e-3 (depth) of
   the plain path; one frame is profiled.
7. Train: bench.py's FoMAML configuration (K=4, B=3 tasks, 4,000 support
   and 2,000 query rays, 8 inner steps, 32 soft-occupancy samples, the
   light encoder backward) through `make_train_step`: one warm-up step,
   3 timed outer steps, then one step with the encoder's default exact
   backward (pos_grad=True). Loss finite, no step skipped, params moved,
   every kernel's launch counter moved and no second-order one (4'', 5'',
   6''); one step's gradients through the
   kernels match the same step through the plain versions
   (`make_train_step(..., use_kernels=False)`); one light and one exact
   step are profiled (device busy ms, idle share, kernel 6's launches x
   ms). Row 12 (`trunc_exp`, csrc/activations.cu): its three kernels
   (forward, backward, the second derivative) bit-equal to their plain
   versions (`edge trunc_exp` lines: +-inf, NaN, -0.0, +-88.7 and the
   floats on either side, far beyond both bounds, N(0, 40^2) at a frame
   call's points, an unaligned tail on the scalar path; 8k + 1 ... 8k + 7
   points at k = 0 and 16,000 (the grid-stride loop, one trip a thread)
   and 1,048,576 (the forward's exact-cover grid, whose n % 4 tail one
   thread takes; the loop, several trips a thread, for the other two),
   and unaligned 128,003 and 8,388,611 on both paths; the
   first and second derivative through autograd against `_TruncExp`, the
   plain path, on the card); its calls and launches in one live frame, one
   bench step and one MAML step (nothing may reach `_TruncExp` with a
   CUDA tensor); each kernel's device time beside its plain version's
   and its byte bound at a frame call's points and at a bench step's
   (`row 12 trunc_exp:` and `kernel trunc_exp_*:` lines). Occupancy:
   fresh K=4 grids at the reference's defaults (R=128, L=4) premarked
   from a ring of 8 bench cameras, one warmup update (every cell) and one
   subset update after warmup through
   `make_occ_update_fn` (kernel 1 launched), each timed to a synchronize
   and held against the same update through the plain versions with the
   same draws (occs within 1e-6 of their max, binary flips at most 1e-6
   of the cells); then one hard-mask FoMAML bench step
   (`occ_hard_mask=True`, the default of `MetaConfig()`): kernels 1-5
   launched, its gradients against the plain step within 2^-8 of each
   leaf's max, one step profiled with the device time of the hard mask's
   point queries (`occupancy_query`, kernel 11q; a profiler range around
   each) beside its busy time; then the same step with occ_probe_mask
   (the probe bits, no point query), held and profiled alike.
   MAML (`maml:` lines): second-order MAML (`MetaConfig(algo="maml")`).
   Kernel 4'' (the compositor's VJP differentiated again) against its
   plain version at one inner step's shapes (4,000 x 32) with the
   upstream of MAML's loss (rgb alone), all four upstreams, depth alone,
   sigma_scale 25 and the edge rays of `volrend_edge_inputs` (alpha at
   its clip, sigma exactly 0, rgb exactly 0 and 1, dt at its floor), and
   at S = 8, 24, 48, 64 and 160 (random rays with all four upstreams,
   alpha at its clip at sigma_scale 25; 8 lanes a ray, and 2 to 5 pieces
   with their carries):
   every output within 1e-5 of its max (d acc and d bg of the max over
   rays of sum |w'| and max |G| times it: acc' cancels on opaque rays);
   kernels 5'', 6'' and 5''b (the plane encoder's light and exact VJPs
   differentiated again; 5''b the light one under bfloat16 line matmuls)
   on one expert's tables and on three draws at the K=4 stack, every
   output within 1e-5 of its max (the tables against the plain version's
   shares summed in float64), the light tables at least twice that from
   the exact ones, 5''b at least twice that from 5''; device,
   back-to-back and plain times beside the byte bounds (the distinct
   table rows read), 5''b and 5'' in turns on the same inputs; and on
   kernel 5's adversarial inputs (`edge plane_encode_bwd2_light` / `edge
   plane_encode_bwd2` / `edge plane_encode_bwd2_light_lines_bf16` lines:
   one cell, coordinates on and outside the bounds, a tail tile, a single
   point, no lines (not 5''b), F=2 on the scalar path, the K=4 stack, L=5
   base 128; d ct bit-equal to the plain version, the tables within 1e-5
   of their max against the float64 sums, each line with its plan and
   device time). Then
   bench.py's step with algo="maml": its gradients through the kernels
   against the same step through the plain versions (2^-8 of each leaf's
   max), against the FoMAML step's from the same params and draws (they
   must differ by more than 2^-8 of a leaf's max, and the FoMAML step
   launches no second-order kernel), 1 timed step (host ms), peak
   memory, launches a step and one profiled step (device busy, idle
   share, 4'', 4', 5'', 5 watched); one exact-backward step (6''); the
   same under both precision options (`maml amp` lines: kernels 1b, 5b,
   5''b, 4, 4', 4'' and row 12's three launched, none of 1, 5, 5''; held
   to the plain path within 2^-8; ms, peak memory, device busy, idle
   share and the matrix products' ms; one exact-backward step, 6'' under
   bfloat16 lines, profiled alike); the runner's default hash experts: row 7c'' (kernel
   7a on the table cotangent) on the fused and packed paths against the
   plain path within 1e-6, its device time, and one MAML step (7a, 7c,
   4'').
8. Trainer: the runner's train op in process (`runner.main`), on a
   prepared scene that the phase writes to a temporary directory in the
   dataset layout (coordinates.pt; train|val metadata .pt and .png rgbs;
   masks/g22 with params.pt, scene_boxes.pt and zip-compressed per-image
   boolean masks): an aerial ring of 16 training and 2 validation
   1000x750 cameras (a 12 MP photo at configs/train.json's downscale
   0.25, read at --downscale 1.0) over a smooth procedural ground
   texture, 4 experts on a 2x2 ground Voronoi with margin 1.1 (14.6M
   training rays from 12M pixels: the margin puts boundary pixels in two
   experts). `--configPath configs/train.json` (bench width: K=4
   planes experts L=3 base 128 F=8, hidden 64, B=3 tasks of 4,000 + 2,000
   rays, 8 inner steps, 32 samples, soft importance occupancy R=128 L=4,
   nothing cut) for 36 steps, occupancy warmup 12 and an update every 6,
   eval and save every 12, one eval batch. Checks: every step's loss
   finite, the params moved, kernels 1-5 launched, 6 occupancy updates (2
   full, 4 subset), step12 / step24 / step36 / last / best written, the
   batches reach the step on the card, and two loop steps taken again
   through the plain path from the same params, batch, grid and generator
   state within 2^-8 of each gradient leaf's max: the first (stratified
   sampling, the grid not yet ready) and step 18 (importance sampling
   through kernels 2 and 3). Then a warm start from
   `last` (--outer_steps 40: start step 36, best and grids restored,
   params bit-equal to the saved ones, 4 more steps) and 4 steps of the
   hash experts at the runner's default widths (7a and 7c launched),
   and 4 steps with `--algo maml` under both precision options
   (`--use_amp --plane_lines_mm --plane_lines_mm_dtype bfloat16`) and an
   occupancy update every 2 steps (loss finite, params moved, kernels 1b,
   2-4, 5b, 4'', 5''b and row 12's launched, none of 1, 5, 5'', step 0
   held to the plain path as above), then `--op eval --tto 0,1` from its
   `last` over one val camera, all on 4 of the 16 training cameras
   (--cap_images 4: the host rebuilds each run's rays and routing, and
   no check reads them).
   Prints the scene's build seconds (dataset, routing, TaskDataset;
   native rays and routing) beside the numpy paths' on the same scene,
   seconds to the first step, then `native:` lines: the exact DDA router
   and the sampled router on 1,000,000 of the scene's rays, native
   against numpy (equal bit for bit, both host times), the median loop
   step on the host clock
   with meta_trainer's data_time and step_time, one profiled loop step
   with its occupancy update beside the train phase's bench step, and
   the checkpoint save and load seconds.
9. Eval (`eval:` lines), on the trainer phase's scene and run directory
   before it is removed: the runner's eval op in process (`runner.main`
   with `--op eval --configPath configs/eval.json --prefix best --tto
   0,1,10`: 96 samples, 4,000 support rays, nothing cut) over the scene's
   2 val cameras at 1000x750; the trained model (K=4 planes experts at
   bench width, soft importance occupancy R=128 L=4 restored from
   best.occ). Checks: every PSNR and SSIM finite, every adapt loss
   finite, the params moved after tto > 0, kernels 1-5 launched; the
   tto=10 run's first 4 adapt steps taken again from their own params,
   batch and generator state through the kernels and through the plain
   versions (losses within 1e-4, every gradient leaf within 2^-8 of its
   max; importance sampling, the grids are ready); its first val image
   through the plain versions from the adapted params (rgb within 1e-4 in
   all but 0.5% of the pixels, PSNR within 0.01 dB); the LPIPS graph on
   AlexNet-shaped random weights written here, on the card against the
   CPU (within 1e-4). Then a `--render_fast` run (`--tto 0,4`: bucketed
   top-1 adaptation and rendering, the dense fallbacks per call in each
   phase, 10a-i launched, 10a-ii / 10a-iii whenever a call stayed within
   capacity) and one image each at `--tto 0 --cap_images 1` with
   `--render_early_stop 1e-4` (the share of rays ending in the first
   segment; row 8 launched), `--render_coherent` (n_coherent, rays
   padded, 10b launched, PSNR within 0.01 dB of the live render's) and
   `--render_baked 256 --render_baked_occ` (bake seconds, alive share,
   row 9 launched). Prints PSNR / SSIM per tto for both runs, ms per
   adapt step (host clock, median of the tto=10 run; one profiled step),
   s per rendered image with its host ray generation, the phase's
   seconds. Between the main and the --render_fast run, a run at --tto
   0,1 through a JSON copy of configs/eval.json with occ_no_hard_mask
   false and occ_probe_mask true: its adapt step and first val image held
   to the plain path as above, no point query launched.
   Video (`video:` lines), on the same scene and checkpoint: the runner's
   video op (`runner.main` with `--op video --configPath
   configs/eval.json --prefix best --video_frames 6`, 96 samples) at the
   val cameras' 1000x750, five runs: the turntable with the hard mask on
   (a copy of configs/eval.json with occ_no_hard_mask false: host rays
   from the native generator, the two-wave dispatch), full_coverage soft
   (the pose path: the live camera renderer with the fused fog / sRGB /
   uint8 tail), the turntable baked at 256³ with --render_baked_occ (the
   baked camera renderer, row 9) and with --render_coherent (10b); and the
   hard-mask turntable again with occ_probe_mask true (the probe bits:
   11q not launched, its first frame against the plain path).
   Checks: each run rendered through the expected renderer, 6 uint8
   frames of the val shape, none constant, the output written, kernels
   1-4 launched (row 9 and 4 when baked; 10b too when coherent); the
   first frame of the host-ray and the pose-path run again through the
   plain versions from the same params and inputs, within 1 level on all
   but 0.5% of the pixels. Prints per run the writer used (mp4 through
   imageio, or the PNG sequence), ms per frame (median, min), host ray
   generation per frame on the host-ray paths, and the phase's seconds.
10. Hash: the runner's default experts (`container_config_from_args` with
   the flag defaults: K=4 Instant-NGP experts, hash L=16 F=2
   log2_hashmap_size 20, 16-4096, Linear, floor layout, fp32; 512 MiB of
   tables) on the same statics and occupancy grid. Kernel row 7 against
   its plain versions: 7a (`hash_encode_fwd`) at one full serve chunk and
   in Smoothstep, Nearest and the tcnn layout at 262,144 points of it, 7b
   (`hash_encode_fwd_packed`) at the full chunk (both within 1e-6 of the
   output's max), 7c (`hash_encode_bwd`, the table gradient) at one inner
   step (within 1e-4 of the gradient's max), timed beside a byte bound
   that counts each distinct table row once (7c's: its inputs and the
   dense gradient it zeroes and fills, written once); 7a and 7c also on adversarial inputs under both lane maps
   (every point in one cell, many in one cell of the finest level, the
   clip bounds and exactly 0 and 1, tails, a single point; 7a at F = 1,
   4, 8 and the other level grouping; 7b on the F = 2 cases and in
   Smoothstep; 7c with K=4 stacked experts, one level group of persistent
   blocks, and groups of 4 levels), and 7a and 7b at the step's shapes
   with their device times. Then one
   warm-up and 3 requests of 800x800 (7a, 2, 3, 4 launched, 7b and 7c
   not; one chunk against the plain path; one profiled frame), one chunk
   through the packed experts (7b alone) against the plain path, 2 packed
   800x800 frames timed in turns with 2 fp32 ones and one profiled packed
   frame, and the train phase below with the hash experts and a packed
   step in place of the exact-backward one (7a, 7b, 7c launched;
   gradients against the plain step; both steps profiled).
11. MoE: bucketed top-E routing, union-probe grids and coherent dispatch
   at the runner's default hash width (the hash phase's experts). Kernel
   row 10 against its plain versions at one full serve chunk (2,097,152
   points, K=4): 10a-i (`bucket_dispatch`) for E=1 and 2, soft and hard
   (integer outputs equal, weights within 1e-6, on two successive calls;
   device times) and on adversarial inputs (`edge bucket_dispatch`
   lines: every point on one expert, ties, distances at the margin, hard
   top-4, N off whole tiles and below one tile, both routing subspaces,
   3-wide rows, K = 1, 16, 64), 10a-ii / 10a-iii (the
   blend and its transpose, within 1e-6 of the output's max, with
   `embedding_bag` timed beside the blend; 10a-iii also on one chunk of
   the K=16 arm and on adversarial inputs, `edge bucket_combine_bwd`
   lines: E=1 and 8, hard routing, an empty bucket, an overflowing one,
   N off whole tiles, below one tile and a single point, no rgb, K=64;
   equal to the plain version expected, tol 1e-6), 10b (`coherent_expert`, ids
   equal; device and back-to-back times, its bound counting each ray's
   points up to its first break; the skew frame's first chunk too; and
   `edge coherent_expert` lines: K = 1, 2, 4, 16, 64, S = 1, 2, 8, 31,
   32, 33, 64, 97, both routing subspaces, margins 1.0, 1.1, 1.5, points
   on a bisector, at duplicated centroids, at d2 = 1.5 d1 exactly, a break
   only at sample 0, the last sample or sample 32, N = 0, 1, tails), and
   kernel 2 on the res-128 union probe grid. Then
   `--render_fast` (bucketed top-1, cf 1.5, the union grid): one warm-up
   and 3 requests of 800x800 through `render_image` (bucket_dispatch and
   the serve kernels launched; the dense-fallback count printed; one chunk
   against the plain path; one profiled frame) and the half-sky frame
   through the hard two-wave renderer with the union grid; the coherent
   renderer on measure_perf's skew-0.9 frame (640,000 rays) without and
   with the union grid against its full routed program (coherent_expert
   launched; one frame profiled, 10b watched); and measure_perf's K=16 arm (bench-width planes experts,
   1,572,864 points in 8 chunks; 10a-i first held to its plain version on
   one chunk, `kernel bucket_dispatch: K=16` line; kernel 11q in each
   mode on its first 1,048,576 points over K=16 L=4 R=128 grids 5%
   occupied, `kernel
   occupancy_query: K=16 chunk`), dense against
   bucketed E=2 cf 1.5, with
   times, peak memory and the dense-fallback count, and one chunk's
   gradient through the bucketed container against the plain path.
12. A JSON line listing every kernel (launches, error, times, bound):
   26 kernels from 15 libraries; every one must have launched in the
   phases' runs. Each phase prints its seconds (`phase <name>:` lines,
   then one `phases (s):` line).
13. The card line, then the last line:
   {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}.

It imports neither jax nor nerfsys_tpu. Weights are random, from a seed.
"""
from __future__ import annotations

import contextlib
import json
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
FP32_FLOPS_PER_S = 67e12  # H100 SXM, float32 outside the tensor cores
SEED = 0
SIDE = 800  # served frame side
CHECK_RAYS = 65536  # rays of the kernel-check chunk (one full serve chunk)
CHUNK = None  # serve chunk; None = default_chunk_rays(32) = 65536


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters: int = 20) -> float:
    """Mean device time per call of fn: the calls are enqueued while the
    card sleeps (~10 ms), so the events around them time the device alone,
    where back-to-back CUDA events also take in the host's launch time
    whenever the host is slower than the kernels."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(20_000_000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def nbytes(*tensors) -> int:
    total = 0
    for t in tensors:
        if isinstance(t, (list, tuple)):
            total += nbytes(*t)
        elif t is not None:
            total += t.numel() * t.element_size()
    return total


def bound(n_bytes: float, n_ops: float):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / FP32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_err(a, b) -> float:
    return float((a.double() - b.double()).abs().max())


def bench_setup_cfg():
    """The bench-width planes container config (bench.py:85-160)."""
    from nerfsys_tpu_torch.models.container import ContainerConfig
    from nerfsys_tpu_torch.models.ngp import NGPConfig
    from nerfsys_tpu_torch.ops.planes import PlaneEncodingConfig

    expert = NGPConfig(
        hidden=64, sigma_depth=2, color_hidden=64, color_depth=2,
        geo_feat_dim=15, sh_levels=4, xyz_encoding="planes",
        planes=PlaneEncodingConfig(levels=3, base_res=128, growth=2.0,
                                   features=8, pos_grad=False))
    return ContainerConfig(num_experts=4, expert=expert, boundary_margin=1.1,
                           bg_hidden=32)


def bench_setup(device):
    """The bench-width soft-occupancy serve configuration (K=4)."""
    import torch

    from nerfsys_tpu_torch.models.container import (
        ContainerStatics,
        init_container_params,
    )
    from nerfsys_tpu_torch.ops.occupancy import OccGridConfig, init_occ_state

    cfg = bench_setup_cfg()
    cents = torch.tensor([[0.0, -1, -1], [0.0, -1, 1], [0.0, 1, -1],
                          [0.0, 1, 1]])
    boxes = torch.stack([torch.stack([c - 1.2, c + 1.2]) for c in cents])
    statics = ContainerStatics(cents, boxes, torch.tensor(
        [[-2.2, -2.2, -2.2], [2.2, 2.2, 2.2]])).to(device)
    params = init_container_params(cfg, seed=SEED, device=device)
    occ = init_occ_state(OccGridConfig(resolution=128, levels=4,
                                       warmup_steps=0), 4, device=device)
    gen = torch.Generator().manual_seed(2)
    binary = torch.rand(occ["binary"].shape, generator=gen) < 0.5
    occ["binary"] = binary.to(device)
    occ["occs"] = torch.where(binary, 0.1, 0.0).to(device)
    occ["num_updates"] = torch.tensor(1000, dtype=torch.int32, device=device)
    return cfg, statics, params, occ


def pose(t):
    import numpy as np

    W = H = SIDE
    c2w = np.array([[1, 0, 0, t[0]], [0, 1, 0, t[1]], [0, 0, 1, t[2]]],
                   np.float32)
    return SimpleNamespace(H=H, W=W, c2w=c2w, intrinsics=np.array(
        [W * 0.8, W * 0.8, W / 2, H / 2], np.float32))


def query_sector_bytes(occs, binary, aabbs, pts, bits: bool,
                       values: bool) -> int:
    """Bytes of the distinct 32-byte sectors kernel 11q must read at these
    points: each expert's deciding cell, its bit and / or its value (the
    plain version's `_finest_level_index` selects the cells)."""
    import torch

    from nerfsys_tpu_torch.ops import occupancy as O

    K, L, R = binary.shape[:3]
    cells = L * R ** 3
    sectors = {"bits": [], "values": []}
    for k in range(K):
        dec, flat = O._finest_level_index(aabbs[k], L, R, pts)
        cell = k * cells + flat[dec]
        if bits:
            sectors["bits"].append(cell // 32)
        if values:
            sectors["values"].append(cell // 8)
    return 32 * sum(torch.unique(torch.cat(v)).numel()
                    for v in sectors.values() if v)


def host_us(fn, calls: int = 1000) -> float:
    """Host microseconds a call of fn: `calls` calls on the host clock,
    synchronized once at the end (the wrapper's launch path wherever the
    kernel is shorter)."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e6 / calls


def query_check(grids, pts, results, label):
    """Kernel 11q against its plain version at `pts` over `grids` in each
    mode (bits and values equal), timed by device time, back to back and
    on the host clock (1,000 calls) beside its bound (the points in, the
    outputs out, the distinct grid sectors read). The first call (the
    serve chunk) fills the kernel's results with the bits mode, the hard
    mask's; later calls append."""
    from nerfsys_tpu_torch import kernels
    from nerfsys_tpu_torch.ops import occupancy as O

    occs, binary, aabbs = grids
    M = pts.shape[0]
    parts = []
    for mode in O.QUERY_MODES:
        wrong = query_mismatches(occs, binary, aabbs, pts, mode)
        if wrong:
            raise SystemExit(f"kernel occupancy_query disagrees with its "
                             f"plain version at the {label} ({mode}): "
                             f"{wrong} outputs")
        outs = O.occupancy_query_kernel(occs, binary, aabbs, pts, mode)
        bits, values = mode != "values", mode != "bits"
        n_bytes = (nbytes(pts, outs)
                   + query_sector_bytes(occs, binary, aabbs, pts, bits,
                                        values))
        all_bytes = nbytes(pts, outs, occs if values else None,
                           binary if bits else None)

        def fn(mode=mode):
            return O.occupancy_query_kernel(occs, binary, aabbs, pts, mode)

        dev, b2b, host = device_ms(fn), cuda_ms(fn, 20), host_us(fn)
        plain = cuda_ms(lambda mode=mode: O.occupancy_query_plain(
            occs, binary, aabbs, pts, mode), 3)
        b_ms, b_by = bound(n_bytes, 0)
        parts.append((mode, dev, b2b, host, plain, n_bytes, b_ms, b_by,
                      all_bytes))
    K, L, R = occs.shape[:3]
    share = float(O.occupancy_query_plain(occs, binary, aabbs, pts,
                                          "bits").float().mean())
    text = (f"{label} ({M} points, K={K} L={L} R={R}, occupied "
            f"{share:.4f}): " + "; ".join(
                f"{mode}: mismatches 0, device_ms={dev:.4f} back to back "
                f"{b2b:.4f} host_us={host:.1f} plain_ms={plain:.4f} "
                f"bytes={n_bytes} (points, outputs, distinct 32-byte grid "
                f"sectors; every grid byte {all_bytes}) bound_ms="
                f"{b_ms:.4f} ({b_by}) device/bound={dev / b_ms:.1f}x"
                for mode, dev, b2b, host, plain, n_bytes, b_ms, b_by,
                all_bytes in parts))
    print(f"kernel occupancy_query: {text}", flush=True)
    name = kernels.OCC_QUERY.name
    if name not in results:
        _, dev, _, _, plain, _, b_ms, b_by, _ = parts[0]
        results[name] = dict(max_abs_err=0.0, ms=dev, plain_ms=plain,
                             bound_ms=b_ms, bound_by=b_by,
                             text=f"max_abs_err=0 tol=0 (bits and values "
                                  f"equal: the same cells); kernel_ms is the "
                                  f"bits mode's device time; {text}")
    else:
        results[name]["text"] += f"; {text}"


def mask_check(cdf, near, far, u, occ, t_ker, results, label):
    """Kernel 3m (the sampler with the probe bits) against its plain
    version: mask equal, t equal to the kernel's without the mask; its
    device and back-to-back times beside kernel 3's, appended to kernel 3's
    line."""
    from nerfsys_tpu_torch import kernels
    from nerfsys_tpu_torch.ops import occupancy as O

    N, S = t_ker.shape
    P = cdf.shape[1] - 1
    t_m, mask = O.sample_tvals_kernel(cdf, near, far, u, occ)
    _, want = O.sample_tvals_plain(cdf, near, far, u, occ)
    flips, t_diff = int((mask != want).sum()), max_err(t_m, t_ker)
    if flips or t_diff != 0.0:
        raise SystemExit(f"kernel sample_tvals_from_cdf's mask (3m) "
                         f"disagrees with its plain version at the {label}: "
                         f"{flips} bits, t {t_diff}")

    def fn():
        return O.sample_tvals_kernel(cdf, near, far, u, occ)

    dev, b2b = device_ms(fn), cuda_ms(fn, 20)
    plain = cuda_ms(lambda: O.sample_tvals_plain(cdf, near, far, u, occ), 3)
    n_bytes = nbytes(cdf, near, far, u, occ, t_m, mask)
    b_ms, b_by = bound(n_bytes, N * S * (P.bit_length() + 9) + N * P)
    text = (f"with the mask (3m) at the {label} ({N} x {S}): mask_flips=0 "
            f"t_vs_no_mask=0 device_ms={dev:.4f} back to back {b2b:.4f} "
            f"plain_ms={plain:.4f} (stable sort and gathers) bytes={n_bytes} "
            f"bound_ms={b_ms:.4f} ({b_by}) kept="
            f"{float(want.float().mean()):.4f}")
    print(f"kernel sample_tvals_from_cdf: {text}", flush=True)
    results[kernels.OCC_SAMPLE.name]["text"] += f"; {text}"


def check_kernels(cfg, statics, params, occ, rays_np, device):
    """Phase 3: every kernel against its plain version at one full chunk."""
    import torch

    from nerfsys_tpu_torch import kernels
    from nerfsys_tpu_torch.models.container import container_apply
    from nerfsys_tpu_torch.models.ngp import world_to_unit
    from nerfsys_tpu_torch.models.occupancy import _ray_validity
    from nerfsys_tpu_torch.ops import occupancy as O
    from nerfsys_tpu_torch.ops import planes as PL
    from nerfsys_tpu_torch.ops import volrend as V

    P, S = 128, 32
    rays = torch.from_numpy(rays_np).to(device)
    o, d = rays[:, 0:3].contiguous(), rays[:, 3:6].contiguous()
    valid, near, far = _ray_validity(rays)
    N = rays.shape[0]
    K, L, R = occ["occs"].shape[:3]
    grids = (occ["occs"], occ["binary"], statics.expert_aabbs)
    results = {}

    def report(kern, err, tol, why, ms, plain_ms, n_bytes, n_ops, extra=""):
        b_ms, b_by = bound(n_bytes, n_ops)
        text = (f"max_abs_err={err:.3e} tol={tol:g} ({why}) "
                f"kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} "
                f"bytes={n_bytes} bound_ms={b_ms:.4f} ({b_by}) at "
                f"{HBM_BYTES_PER_S / 1e12:g} TB/s{extra}")
        if not err <= tol:
            print(f"kernel {kern.name}: {text}", flush=True)
            raise SystemExit(f"kernel {kern.name} disagrees with its plain "
                             f"version: {err} > {tol}")
        results[kern.name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                  bound_ms=b_ms, bound_by=b_by, text=text)

    # kernel 2: union probe + CDF (soft mode: importance, uf .25, rf .25)
    probe_kw = dict(n_probes=P, importance=True, uniform_frac=0.25,
                    ray_floor=0.25)
    ker = O.occupancy_probe_cdf_kernel(*grids, o, d, near, far, **probe_kw)
    pln = O.occupancy_probe_cdf(*grids, o, d, near, far, **probe_kw,
                                use_kernels=False)
    torch.cuda.synchronize()
    flips = int((ker["occ"] != pln["occ"]).sum())
    alive_flips = int((ker["alive"] != pln["alive"]).sum())
    if flips or alive_flips:
        raise SystemExit(f"probe kernel selects other cells than the plain "
                         f"version: {flips} probe bits, {alive_flips} rays")
    io_bytes = nbytes(o, d, near, far, ker["cdf"], ker["alive"], ker["occ"])
    need = probe_sector_bytes(*grids, o, d, near, far, P, True, pln["occ"])
    all_bytes = nbytes(occ["occs"], occ["binary"]) + io_bytes
    n_ops = N * P * (9 + K * L * 14) + N * P * 12
    times = probe_times(grids, o, d, near, far, probe_kw)
    b_all, _ = bound(all_bytes, n_ops)
    report(kernels.OCC_PROBE_CDF, max_err(ker["cdf"], pln["cdf"]),
           PROBE_EDGE_TOL, "bit-equal: the plain version sums and scans in "
           "the kernel's order",
           times["device"],
           cuda_ms(lambda: O.occupancy_probe_cdf(
               *grids, o, d, near, far, **probe_kw, use_kernels=False), 3),
           need + io_bytes, n_ops,
           extra=(f" (bytes: the distinct 32-byte sectors of the selected "
                  f"cells, bits and the values read, plus rays and outputs; "
                  f"every grid byte once: {all_bytes}, bound_ms="
                  f"{b_all:.4f}) occ_bit_flips={flips} alive_flips="
                  f"{alive_flips}; kernel_ms is the device time; "
                  + probe_times_text(times)))
    del need
    probe_edges(device)

    # kernel 3: the sampler, fed the same cdf on both sides
    cdf_state = {"cdf": pln["cdf"], "alive": pln["alive"]}
    u = O._sample_targets(N, S, device, None, False).contiguous()
    branches = torch.zeros(2, dtype=torch.int32, device=device)
    t_ker = O.sample_tvals_kernel(pln["cdf"], near, far, u,
                                  branch_counts=branches)
    t_pln = O.sample_tvals_plain(pln["cdf"], near, far, u)
    b2b = cuda_ms(lambda: O.sample_tvals_kernel(pln["cdf"], near, far, u),
                  10)
    n_count, n_sort = branches.tolist()
    report(kernels.OCC_SAMPLE, max_err(t_ker, t_pln), 1e-5,
           "the same idx and the same lerps: 0 expected",
           device_ms(lambda: O.sample_tvals_kernel(pln["cdf"], near, far,
                                                   u)),
           cuda_ms(lambda: O.sample_tvals_plain(pln["cdf"], near, far, u), 3),
           nbytes(pln["cdf"], near, far, u, t_ker),
           N * S * (P.bit_length() + 8) + N * P,
           extra=(f"; kernel_ms is the device time, back to back {b2b:.4f} "
                  f"ms; rows that took the literal count {n_count}, the rank "
                  f"sort {n_sort} of {N}; plan "
                  + sample_plan_text(O.sample_plan(N, P, S))))
    mask_check(cdf_state["cdf"], near, far, u, pln["occ"], t_ker, results,
               "serve chunk")
    sample_edges(device)

    # kernel 1: the plane/line encoder at the chunk's sample points, K=4
    t_vals, _ = O.sample_tvals_from_cdf(cdf_state, near, far, S)
    pts = V.t_to_points(o, d, t_vals).reshape(-1, 3)
    x01 = world_to_unit(pts, statics.expert_aabbs, cfg.expert.enc_eps)
    enc_p = params["experts"]["planes_enc"]
    pc = cfg.expert.planes
    e_ker = PL.plane_encode_kernel(enc_p, x01, pc)
    e_pln = PL.plane_encode_plain(enc_p, x01, pc)
    n_out = e_ker.numel()
    report(kernels.PLANES_FWD, max_err(e_ker, e_pln), 0.0,
           "bit-equal: built with --fmad=false, the plain version's op "
           "order; a contracted build reads ~1e-7 here and flips MLP ReLUs "
           "in training",
           cuda_ms(lambda: PL.plane_encode_kernel(enc_p, x01, pc), 10),
           cuda_ms(lambda: PL.plane_encode_plain(enc_p, x01, pc), 3),
           nbytes(x01, enc_p["planes"], enc_p["lines"], e_ker),
           n_out * 15 + (n_out // pc.features) * 20,
           extra=" plan " + plan_text(PL.plane_fwd_plan(
               x01.shape[1], pc.level_resolutions(), pc.features)))
    del e_ker, e_pln
    plane_fwd_edges(pc, enc_p, x01, device)

    # kernel 11q: the point queries at the chunk's samples, K=4
    query_check(grids, pts, results, "serve chunk")
    query_edges(device)

    # kernel 4: the compositor on the chunk's routed field values
    dirs = d[:, None, :].expand(N, S, 3).reshape(-1, 3)
    rgb, sigma = container_apply(params, cfg, statics, pts, dirs,
                                 use_kernels=False)
    rgb_sigma = torch.cat([rgb.reshape(N, S, 3),
                           torch.where(valid[:, None], sigma.reshape(N, S),
                                       0.0)[..., None]], dim=-1)
    bg = torch.rand((N, 3), device=device)
    out_k = V.volume_render_kernel(rgb_sigma, t_vals, bg)
    out_p = V.volume_render_plain(rgb_sigma, t_vals, bg)
    err = max(max_err(out_k[0], out_p[0]), max_err(out_k[2], out_p[2]),
              max_err(out_k[3], out_p[3]), max_err(out_k[1], out_p[1]) / 10)
    b2b = cuda_ms(lambda: V.volume_render_kernel(rgb_sigma, t_vals, bg), 10)
    report(kernels.VOLREND_FWD, err, 1e-5,
           "rgb/weights/acc in [0,1] and depth/10 (t <= ~6): a product "
           "scan for T and sums of 32 products in another order than "
           "torch.cumprod / torch.sum",
           device_ms(lambda: V.volume_render_kernel(rgb_sigma, t_vals, bg)),
           cuda_ms(lambda: V.volume_render_plain(rgb_sigma, t_vals, bg), 3),
           nbytes(rgb_sigma, t_vals, bg, out_k),
           N * S * 24,
           extra=(f"; kernel_ms is the device time, back to back "
                  f"{b2b:.4f} ms; plan "
                  + volrend_plan_text(V.volrend_plan(N, S, backward=False))))
    volrend_fwd_edges(4000 + 13, device)
    return results


TRAIN_K, TRAIN_B, TRAIN_S, TRAIN_Q, TRAIN_INNER = 4, 3, 4000, 2000, 8
TRAIN_KERNELS = ("plane_encode_fwd", "occupancy_probe_cdf",
                 "sample_tvals_from_cdf", "volume_render_fwd",
                 "volume_render_bwd", "plane_encode_bwd_light",
                 "plane_encode_bwd", "trunc_exp_fwd", "trunc_exp_bwd")


def train_batch(device):
    """bench.py's synthetic episode (numpy seed 0), on the card."""
    import numpy as np
    import torch

    K, B = TRAIN_K, TRAIN_B
    rng = np.random.default_rng(0)

    def rays(n):
        o = rng.normal(size=(K, B, n, 3)).astype(np.float32) * 0.3
        d = rng.normal(size=(K, B, n, 3)).astype(np.float32)
        d /= np.linalg.norm(d, axis=-1, keepdims=True)
        nf = np.tile(np.array([0.1, 2.5], np.float32), (K, B, n, 1))
        return np.concatenate([o, d, nf], -1)

    batch = {
        "support_rays": rays(TRAIN_S),
        "support_rgbs": rng.uniform(size=(K, B, TRAIN_S, 3)).astype(
            np.float32),
        "query_rays": rays(TRAIN_Q),
        "query_rgbs": rng.uniform(size=(K, B, TRAIN_Q, 3)).astype(
            np.float32),
        "valid": np.ones((K, B), np.float32),
    }
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


def train_meta():
    from nerfsys_tpu_torch.pipelines.offline.meta_core import MetaConfig

    return MetaConfig(algo="fomaml", inner_iter=TRAIN_INNER, inner_lr=0.015,
                      ray_samples=32, occ_importance=True,
                      occ_hard_mask=False)


def rel_err(got, want) -> float:
    """max |got - want| over max |want| (the gradient's own scale)."""
    return max_err(got, want) / max(float(want.double().abs().max()), 1e-30)


def check_train_kernels(cfg, statics, params, occ, batch, device, results):
    """Phase 3, backward kernels: at one full inner step of one bench-width
    expert (expert 0's first support set: 4,000 rays x 32 samples, its
    K=1 probe, randomized samples), each against its plain version."""
    import dataclasses

    import torch

    from nerfsys_tpu_torch import kernels
    from nerfsys_tpu_torch.models.container import background_color
    from nerfsys_tpu_torch.models.ngp import ngp_apply, world_to_unit
    from nerfsys_tpu_torch.ops import occupancy as O
    from nerfsys_tpu_torch.ops import planes as PL
    from nerfsys_tpu_torch.ops import volrend as V
    from nerfsys_tpu_torch.utils.device import num_sms
    from nerfsys_tpu_torch.utils.tree import tree_map

    S = 32
    rays = batch["support_rays"][0, 0]
    o, d = rays[:, 0:3].contiguous(), rays[:, 3:6].contiguous()
    near, far = rays[:, 6].contiguous(), rays[:, 7].contiguous()
    N = rays.shape[0]
    grid = (occ["occs"][0:1], occ["binary"][0:1], statics.expert_aabbs[0:1])
    cdf = O.occupancy_probe_cdf(*grid, o, d, near, far, 128, importance=True,
                                ray_floor=0.25)
    gen = torch.Generator(device=device).manual_seed(3)
    t_vals, _ = O.sample_tvals_from_cdf(cdf, near, far, S, generator=gen,
                                        randomized=True)
    pts = V.t_to_points(o, d, t_vals).reshape(-1, 3)
    expert = tree_map(lambda t: t[0], params["experts"])
    aabb = statics.expert_aabbs[0]

    def report(kern, checks, why, ms, plain_ms, n_bytes, n_ops):
        """checks: (label, got, want, tol on max error / max |want|)."""
        b_ms, b_by = bound(n_bytes, n_ops)
        rels = [(label, rel_err(a, b), tol) for label, a, b, tol in checks]
        abs_err = max(max_err(a, b) for _, a, b, _ in checks)
        text = (" ".join(f"{label}_err/max={r:.3e} tol={tol:g}"
                         for label, r, tol in rels)
                + f" max_abs_err={abs_err:.3e} ({why}) kernel_ms={ms:.4f} "
                f"plain_ms={plain_ms:.4f} bytes={n_bytes} "
                f"bound_ms={b_ms:.4f} ({b_by}) at "
                f"{HBM_BYTES_PER_S / 1e12:g} TB/s")
        if not all(r <= tol for _, r, tol in rels):
            print(f"kernel {kern.name}: {text}", flush=True)
            raise SystemExit(f"kernel {kern.name} disagrees with its plain "
                             f"version: {rels}")
        results[kern.name] = dict(max_abs_err=abs_err, ms=ms,
                                  plain_ms=plain_ms, bound_ms=b_ms,
                                  bound_by=b_by, text=text)

    # kernel 4's VJP, rgb the only upstream (as on the loss path)
    with torch.no_grad():
        rgb, sigma = ngp_apply(expert, cfg.expert, aabb, pts,
                               d[:, None, :].expand(N, S, 3).reshape(-1, 3))
        bg = background_color(params, cfg, d).contiguous()
    rgb_sigma = torch.cat([rgb.reshape(N, S, 3), sigma.reshape(N, S, 1)],
                          dim=-1).contiguous()
    g_rgb = torch.randn((N, 3), device=device, generator=gen)
    grads = (g_rgb, None, None, None)
    k_rs, k_bg = V.volume_render_bwd_kernel(rgb_sigma, t_vals, bg, grads)
    p_rs, p_bg = V.volume_render_bwd_plain(rgb_sigma, t_vals, bg, grads)
    # its kernel time is the device time: the kernel takes less than the
    # wrapper's host path, so back-to-back events would time the host
    b2b_ms = cuda_ms(lambda: V.volume_render_bwd_kernel(
        rgb_sigma, t_vals, bg, grads), 20)
    report(kernels.VOLREND_BWD,
           [("rgb_sigma", k_rs, p_rs, 1e-5), ("bg", k_bg, p_bg, 1e-5)],
           "relative to each gradient's max: warp scans (a product scan for "
           "T, a division-free suffix scan of affine maps for the reverse "
           "recurrence) vs torch's cumprod backward, other summation "
           f"orders; kernel_ms is the device time, back to back "
           f"{b2b_ms:.4f} ms (the host's launch path); plan "
           f"{volrend_plan_text(V.volrend_plan(N, S, backward=True))}",
           device_ms(lambda: V.volume_render_bwd_kernel(rgb_sigma, t_vals,
                                                        bg, grads)),
           cuda_ms(lambda: V.volume_render_bwd_plain(rgb_sigma, t_vals, bg,
                                                     grads), 5),
           nbytes(rgb_sigma, t_vals, bg, g_rgb, k_rs, k_bg), N * S * 40)
    volrend_bwd_edges(N, device)
    step_shape_times(grid, o, d, near, far, cdf, gen, rgb_sigma, t_vals, bg,
                     results)

    # kernels 5 and 6: the encoder VJPs, one expert's tables (3 levels)
    enc = expert["planes_enc"]
    x01 = world_to_unit(pts, aabb, cfg.expert.enc_eps).contiguous()
    P = x01.shape[0]
    ct = torch.randn((P, cfg.expert.planes.out_dim), device=device,
                     generator=gen)
    tables = list(enc["planes"]) + list(enc["lines"])
    # the exact tables differ from the light ones only by the bf16 rounding
    # of the residuals: the light check must be tighter than that gap
    exact = PL.plane_encode_bwd_plain(
        enc, x01, ct, dataclasses.replace(cfg.expert.planes, pos_grad=True))
    for kern, pos_grad, tol, why in (
            (kernels.PLANES_BWD_LIGHT, False, 1e-4,
             "relative to each table's max; bf16 residuals round alike "
             "(--fmad=false), fp32 atomics add in another order: ~6e-6 "
             "measured; the tolerance must stay below the light-exact gap"),
            (kernels.PLANES_BWD, True, 1e-4,
             "relative to each gradient's max; warp-aggregated fp32 "
             "reductions add up to thousands of cancelling shares per line "
             "row in another order than index_add_, and each block's "
             "position partial sums its F products in another order than "
             "torch.sum")):
        pc = dataclasses.replace(cfg.expert.planes, pos_grad=pos_grad)
        got = PL.plane_encode_bwd_kernel(enc, x01, ct, pc)
        want = PL.plane_encode_bwd_plain(enc, x01, ct, pc)
        checks = [(f"{key}{l}", a, b, tol) for key, i in (("plane", 0),
                                                        ("line", 1))
                  for l, (a, b) in enumerate(zip(got[i], want[i]))]
        if pos_grad:
            checks.append(("x", got[2], want[2], tol))
        else:
            gap = min(rel_err(w, e) for w, e in zip(want[0] + want[1],
                                                    exact[0] + exact[1]))
            why += f"; light-exact gap/max >= {gap:.3e}"
            if not gap > 2 * tol:
                raise SystemExit(f"kernel {kern.name}: the light tables are "
                                 f"within {gap} of the exact ones, so its "
                                 f"check at {tol} cannot tell them apart")
        n_out = sum(t.numel() for t in got[0] + got[1])
        dev_ms = device_ms(lambda: PL.plane_encode_bwd_kernel(enc, x01, ct,
                                                              pc))
        plan = PL.plane_bwd_plan(P, 1, pc.level_resolutions(), pc.features,
                                 True, num_sms(device), exact=pos_grad)
        why += f"; device_ms={dev_ms:.4f}; plan {plan_text(plan)}"
        report(kern, checks, why,
               cuda_ms(lambda: PL.plane_encode_bwd_kernel(enc, x01, ct, pc),
                       10),
               cuda_ms(lambda: PL.plane_encode_bwd_plain(enc, x01, ct, pc),
                       3),
               nbytes(x01, ct, tables, got[0], got[1],
                      got[2] if pos_grad else None),
               P * 9 * cfg.expert.planes.features * (30 if pos_grad else 24)
               + n_out)
        del got, want, checks
    del exact
    plane_bwd_edges(cfg, statics, params, enc, pts, x01, ct, device)


def step_shape_times(grid, o, d, near, far, cdf, gen, rgb_sigma, t_vals,
                     bg, results):
    """Kernels 2, 3 (and 3m) and 4 and 11q at the bench step's shapes (one
    inner step of one expert: its K=1 task probe of 4,000 rays x 128
    probes, 32 randomized samples a ray, the compositor and the point
    queries at 4,000 x 32): back-to-back and device times beside each
    one's bytes and bound, appended to the kernel's line (its headline
    numbers stay those of the serve chunk)."""
    import torch

    from nerfsys_tpu_torch import kernels
    from nerfsys_tpu_torch.ops import occupancy as O
    from nerfsys_tpu_torch.ops import volrend as V

    N, S, P = t_vals.shape[0], t_vals.shape[1], cdf["cdf"].shape[1] - 1
    K, L = grid[0].shape[:2]
    u = O._sample_targets(N, S, o.device, gen, True).contiguous()
    branches = torch.zeros(2, dtype=torch.int32, device=o.device)
    t_ker = O.sample_tvals_kernel(cdf["cdf"], near, far, u,
                                  branch_counts=branches)
    t_err = max_err(t_ker, O.sample_tvals_plain(cdf["cdf"], near, far, u))
    if not t_err <= 1e-5:
        print(f"kernel sample_tvals_from_cdf: step shapes (randomized "
              f"samples, {N} rays x {S} samples): max_abs_err={t_err:.3e} "
              f"tol=1e-5", flush=True)
        raise SystemExit(f"kernel sample_tvals_from_cdf disagrees with its "
                         f"plain version at the step's shapes (per-ray u): "
                         f"{t_err}")
    outs = V.volume_render_kernel(rgb_sigma, t_vals, bg)
    ref = V.volume_render_plain(rgb_sigma, t_vals, bg)
    vr_err = max(max_err(outs[0], ref[0]), max_err(outs[2], ref[2]),
                 max_err(outs[3], ref[3]), rel_err(outs[1], ref[1]))
    if not vr_err <= 1e-5:
        raise SystemExit(f"kernel volume_render_fwd disagrees with its plain "
                         f"version at the step's shapes: {vr_err}")
    probe_kw = dict(n_probes=P, importance=True, ray_floor=0.25)
    cases = (
        (kernels.OCC_PROBE_CDF, "K=1 task probe",
         lambda: O.occupancy_probe_cdf_kernel(*grid, o, d, near, far,
                                              **probe_kw),
         nbytes(grid[0], grid[1], o, d, near, far, list(cdf.values())),
         N * P * (9 + K * L * 14) + N * P * 12),
        (kernels.OCC_SAMPLE, "randomized samples",
         lambda: O.sample_tvals_kernel(cdf["cdf"], near, far, u),
         nbytes(cdf["cdf"], near, far, u, t_ker),
         N * S * (P.bit_length() + 8) + N * P),
        (kernels.VOLREND_FWD, "compositor",
         lambda: V.volume_render_kernel(rgb_sigma, t_vals, bg),
         nbytes(rgb_sigma, t_vals, bg, outs), N * S * 24))
    want = O.occupancy_probe_cdf(*grid, o, d, near, far, **probe_kw,
                                 use_kernels=False)
    torch.cuda.synchronize()
    flips = (int((cdf["occ"] != want["occ"]).sum()),
             int((cdf["alive"] != want["alive"]).sum()))
    cdf_err = max_err(cdf["cdf"], want["cdf"])
    if flips != (0, 0) or not cdf_err <= PROBE_EDGE_TOL:
        raise SystemExit(f"kernel occupancy_probe_cdf disagrees with its "
                         f"plain version at the step's shapes: {flips} "
                         f"flips, cdf {cdf_err}")
    need = probe_sector_bytes(*grid, o, d, near, far, P, True, want["occ"])
    io_bytes = nbytes(o, d, near, far, list(cdf.values()))
    extra = {kernels.OCC_PROBE_CDF: lambda: (
                 f" (distinct-sector bytes {need + io_bytes}, bound_ms "
                 f"{bound(need + io_bytes, 0)[0]:.4f}); occ_bit_flips=0 "
                 f"alive_flips=0 cdf_err={cdf_err:.3e} vs the plain probe; "
                 + probe_times_text(probe_times(grid, o, d, near, far,
                                                probe_kw))),
             kernels.OCC_SAMPLE: lambda: (
                 f" max_abs_err={t_err:.3e} tol=1e-5 vs the plain version "
                 f"on the same per-ray u; rows that took the literal count "
                 f"{int(branches[0])}, the rank sort {int(branches[1])} of "
                 f"{N}"),
             kernels.VOLREND_FWD: lambda: (
                 f" max_err={vr_err:.3e} (depth relative) vs the plain "
                 f"version; plan " + volrend_plan_text(
                     V.volrend_plan(N, S, backward=False)))}
    for kern, label, fn, n_bytes, n_ops in cases:
        ms = cuda_ms(fn, 20)
        dev_ms = device_ms(fn)
        b_ms, b_by = bound(n_bytes, n_ops)
        text = (f"step shapes ({label}, {N} rays x {S} samples, {P} "
                f"probes): kernel_ms={ms:.4f} (back to back) "
                f"device_ms={dev_ms:.4f} bytes={n_bytes} bound_ms="
                f"{b_ms:.4f} ({b_by})")
        if kern in extra:
            text += extra[kern]()
        print(f"kernel {kern.name}: {text}", flush=True)
        results[kern.name]["text"] += f"; {text}"
    mask_check(cdf["cdf"], near, far, u, cdf["occ"], t_ker, results,
               "step shapes (per-ray u)")
    query_check(grid, V.t_to_points(o, d, t_vals).reshape(-1, 3), results,
                "step shapes (the K=1 task slice, the hard mask's points)")


VR_EDGE_TOL = 1e-5


def volrend_edge_inputs(kind: str, n: int, s: int, device, seed: int = 0):
    """Adversarial inputs of kernel 4's VJP from numpy seed `seed`:
    rgb_sigma (n, s, 4), t_vals (n, s), bg (n, 3) and the four upstream
    gradients (rgb, depth, weights, acc). "clip" puts alpha at its 1 - 1e-7
    bound (sigma * dt >= 17) at every third sample of the even rays and
    the middle one of the odd; "zero" sigma exactly 0 (alpha = 0 ties) on
    the even rays and every other sample of the odd, 1e-9 (alpha rounds
    to 0) at the rest of every fourth; "rgb01" rgb exactly 0 or 1;
    "dtfloor" zero-length intervals (dt at its 1e-4 floor), the last one
    included; otherwise uniform rgb around [0, 1] and exponential
    sigma."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    t = np.sort(rng.uniform(0.1, 2.5, (n, s)), axis=1).astype(np.float32)
    rgb = rng.uniform(-0.2, 1.2, (n, s, 3)).astype(np.float32)
    sigma = rng.exponential(1.0, (n, s)).astype(np.float32)
    if kind == "clip":
        sigma[0::2, ::3] = 17.0 / 1e-4
        sigma[1::2, s // 2] = 17.0 / 1e-4
    elif kind == "zero":
        sigma[0::2] = 0.0
        sigma[1::2, ::2] = 0.0
        sigma[3::4, 1::2] = 1e-9
    elif kind == "rgb01":
        rgb[0::2] = 0.0
        rgb[1::2] = 1.0
        rgb[0::4, ::2, 1] = 1.0
    elif kind == "dtfloor":
        t[:, 1::2] = t[:, 0:s - 1:2][:, :t[:, 1::2].shape[1]]
        t[:, -1] = t[:, -2]
    rgb_sigma = np.concatenate([rgb, sigma[..., None]], axis=-1)
    arrays = (rgb_sigma, t, rng.uniform(size=(n, 3)),
              rng.normal(size=(n, 3)), 0.2 * rng.normal(size=(n,)),
              rng.normal(size=(n, s)), rng.normal(size=(n,)))
    return [torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(device)
            for a in arrays]


def volrend_plan_text(plan) -> str:
    return (f"lanes={plan.lanes} rays_per_warp={plan.rays_per_warp} "
            f"pieces={plan.pieces} threads={plan.threads} "
            f"blocks={plan.blocks} smem={plan.smem}")


def lane_plan_text(plan) -> str:
    """Rows 8 and 10b's `RayLaneLaunchPlan`."""
    return (f"lanes={plan.lanes} pieces={plan.pieces} groups={plan.groups} "
            f"rays_per_warp={plan.rays_per_warp} threads={plan.threads} "
            f"blocks={plan.blocks}")


def volrend_bwd_edges(n: int, device):
    """Kernel 4's VJP against its plain version on adversarial inputs at
    one inner step's ray count (`volrend_edge_inputs`): alpha at its clip,
    sigma exactly 0, rgb exactly 0 and 1, dt at its floor, S = 2, 8, 31,
    33, 64 and 97 (every lane plan: several rays a warp, partial segments,
    pieces with a carry), each upstream gradient alone and all four, no
    background, sigma_scale 25. rgb_sigma within 1e-5 of its max; the
    background's gradient G (1 - acc) within 1e-5 of max |G| (where acc
    rounds to 1 the plain version's own 1 - sum(w) is an ulp of 1, so the
    gradient's own max is no scale there)."""
    import torch

    from nerfsys_tpu_torch.ops import volrend as V

    cases = volrend_edge_cases()
    for seed, (label, kind, s, used, with_bg, scale) in enumerate(cases):
        rs, t, bg, *ups = volrend_edge_inputs(kind, n, s, device, seed)
        bg = bg if with_bg else None
        grads = tuple(g if u else None for g, u in zip(ups, used))
        got, got_bg = V.volume_render_bwd_kernel(rs, t, bg, grads,
                                                 sigma_scale=scale)
        want, want_bg = V.volume_render_bwd_plain(rs, t, bg, grads,
                                                  sigma_scale=scale)
        torch.cuda.synchronize()
        err = rel_err(got, want)
        g_scale = float(ups[0].abs().max()) if used[0] else 1.0
        bg_err = (max_err(got_bg, want_bg) / g_scale if with_bg else 0.0)
        ms = device_ms(lambda: V.volume_render_bwd_kernel(
            rs, t, bg, grads, sigma_scale=scale), 5)
        print(f"edge volume_render_bwd {label}: N={n} S={s} "
              f"rgb_sigma_err/max={err:.3e} bg_err/max|G|={bg_err:.3e} "
              f"tol={VR_EDGE_TOL:g} device_ms={ms:.4f} plan "
              f"{volrend_plan_text(V.volrend_plan(n, s, backward=True))}",
              flush=True)
        if not (err <= VR_EDGE_TOL and bg_err <= VR_EDGE_TOL
                and bool(torch.isfinite(got).all())):
            raise SystemExit(f"kernel volume_render_bwd disagrees with its "
                             f"plain version on {label}: {err}, {bg_err}")
        if not bool((want != 0).any()):
            raise SystemExit(f"volume_render_bwd edge {label}: zero "
                             f"gradient")


def volrend_edge_cases():
    """The 18 adversarial cases of kernel 4 and its VJP at one inner step's
    ray count: (label, kind, S, upstream gradients used, background,
    sigma_scale); the forward ignores the upstream gradients."""
    all4 = (True, True, True, True)
    cases = [("alpha at the clip", "clip", 32, all4, True, 1.0),
             ("sigma exactly 0", "zero", 32, all4, True, 1.0),
             ("rgb exactly 0 and 1", "rgb01", 32, all4, True, 1.0),
             ("dt at the 1e-4 floor", "dtfloor", 32, all4, True, 1.0)]
    cases += [(f"S={s}", "rand", s, all4, True, 1.0)
              for s in (2, 8, 31, 33, 64, 97)]
    for i, name in enumerate(("rgb", "depth", "weights", "acc")):
        used = tuple(j == i for j in range(4))
        cases.append((f"{name} gradient alone", "rand", 32, used, True, 1.0))
    cases += [("all four gradients", "rand", 32, all4, True, 1.0),
              ("no background", "rand", 32, all4, False, 1.0),
              ("sigma_scale 25", "rand", 32, all4, True, 25.0),
              ("alpha at the clip, S=97, sigma_scale 25", "clip", 97, all4,
               True, 25.0)]
    return cases


def volrend_fwd_edges(n: int, device):
    """Kernel 4 against its plain version on `volrend_edge_cases` at n rays
    (a tail past whole warps at S <= 16 when n is odd): rgb, weights and
    acc within 1e-5, depth within 1e-5 of its max."""
    import torch

    from nerfsys_tpu_torch.ops import volrend as V

    for seed, (label, kind, s, _, with_bg, scale) in enumerate(
            volrend_edge_cases()):
        rs, t, bg, *_ = volrend_edge_inputs(kind, n, s, device, seed)
        bg = bg if with_bg else None
        got = V.volume_render_kernel(rs, t, bg, sigma_scale=scale)
        want = V.volume_render_plain(rs, t, bg, sigma_scale=scale)
        torch.cuda.synchronize()
        errs = (max_err(got[0], want[0]), max_err(got[2], want[2]),
                max_err(got[3], want[3]), rel_err(got[1], want[1]))
        ms = device_ms(lambda: V.volume_render_kernel(
            rs, t, bg, sigma_scale=scale), 5)
        print(f"edge volume_render_fwd {label}: N={n} S={s} rgb_err="
              f"{errs[0]:.3e} weights_err={errs[1]:.3e} acc_err="
              f"{errs[2]:.3e} depth_err/max={errs[3]:.3e} tol={VR_EDGE_TOL:g}"
              f" device_ms={ms:.4f} plan "
              f"{volrend_plan_text(V.volrend_plan(n, s, backward=False))}",
              flush=True)
        if not (max(errs) <= VR_EDGE_TOL
                and all(bool(torch.isfinite(x).all()) for x in got)):
            raise SystemExit(f"kernel volume_render_fwd disagrees with its "
                             f"plain version on {label}: {errs}")


def probe_plan_text(plan) -> str:
    return (f"lane_map={plan.lane_map} rays={plan.rays} threads="
            f"{plan.threads} blocks={plan.blocks} stride={plan.stride} "
            f"smem={plan.smem} group={plan.group} chunks={plan.chunks}")


def sample_plan_text(plan) -> str:
    return (f"warps={plan.warps} threads={plan.threads} blocks={plan.blocks} "
            f"(at most those resident at once are launched) stride="
            f"{plan.stride} smem={plan.smem} top={plan.top}")


def probe_sector_bytes(occs, binary, aabbs, o, d, near, far, P,
                       importance, union_occ) -> int:
    """Bytes of the distinct 32-byte sectors kernel 2 must read for these
    rays: each expert's deciding cell bit at every probe, and, with
    importance, its value where the union is occupied (the plain version's
    `_finest_level_index` selects the cells)."""
    import torch

    from nerfsys_tpu_torch.ops import occupancy as O

    K, L, R = occs.shape[:3]
    cells = L * R ** 3
    pts = O._probe_points(o, d, near, far, P).reshape(-1, 3)
    union = union_occ.reshape(-1)
    bits, vals = [], []
    for k in range(K):
        dec, flat = O._finest_level_index(aabbs[k], L, R, pts)
        bits.append((k * cells + flat[dec]) // 32)
        if importance:
            vals.append((k * cells + flat[dec & union]) // 8)
    n = torch.unique(torch.cat(bits)).numel()
    if importance:
        n += torch.unique(torch.cat(vals)).numel()
    return 32 * n


def probe_times(grids, o, d, near, far, kw):
    """Kernel 2's device time under its default plan and under each lane
    map, with importance off (no value reads), and back to back."""
    from nerfsys_tpu_torch.ops import occupancy as O

    def fn(**over):
        args = dict(kw, **over)
        return lambda: O.occupancy_probe_cdf_kernel(*grids, o, d, near, far,
                                                    **args)

    N, P = o.shape[0], kw["n_probes"]
    K, L = grids[0].shape[:2]
    return {"device": device_ms(fn()), "b2b": cuda_ms(fn(), 20),
            "rays": device_ms(fn(lane_map="rays")),
            "probes": device_ms(fn(lane_map="probes")),
            "no_values": device_ms(fn(importance=False)),
            "plan": O.occ_probe_plan(N, P, K, L)}


def probe_times_text(times) -> str:
    return (f"back to back {times['b2b']:.4f} ms; device by lane map: rays "
            f"{times['rays']:.4f}, probes {times['probes']:.4f}; importance "
            f"off (no value reads) {times['no_values']:.4f}; plan "
            + probe_plan_text(times["plan"]))


# the plain version sums and scans in the kernel's order: the cdf is
# bit-equal, and a rounding difference would move the samples kernel 3
# draws and with them a training step's gradients (the trainer phase)
PROBE_EDGE_TOL = 0.0
PROBE_EDGE_N = 4096 + 13  # a tail past whole 32-ray blocks


def probe_edge_inputs(kind: str, n: int, k: int, l: int, r: int, seed: int):
    """Adversarial inputs of kernel 2 from numpy seed `seed`: occs, binary
    (k, l, r, r, r), boxes (k, 2, 3) and rays o, d (n, 3), near, far (n,).
    "borders" puts every coordinate of a third of the rays on a level
    border or one ulp either side with d = 0 (every probe on it), moves
    another third along x only (y and z stay on borders), and aims the rest
    at random; "outside" starts half the rays far outside every level
    (some through none); "dead" has no occupied cell; "single" one
    occupied cell an expert, with the rays aimed through it; "tiny" values
    below 1.05e-14 (sum(val) on either side of the 1e-12 threshold, on rays
    with occupied probes);
    otherwise half the cells occupied at random values in [0, 1)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    cents = np.array([[0.0, -1, -1], [0.0, -1, 1], [0.0, 1, -1], [0.0, 1, 1],
                      [0.4, 0.2, 0.0]], np.float32)[np.arange(k) % 5]
    half = np.float32(1.2) if k > 1 else np.float32(0.9)
    boxes = np.stack([cents - half, cents + half], 1).astype(np.float32)
    binary = rng.uniform(size=(k, l, r, r, r)) < 0.5
    occs = rng.uniform(size=binary.shape).astype(np.float32)
    if kind == "dead":
        binary[:] = False
    elif kind == "single":
        binary[:] = False
        binary[:, 0, r // 2, r // 3, r // 2] = True
    elif kind == "tiny":
        occs = (occs * np.float32(1.05e-14)).astype(np.float32)
    o = rng.normal(size=(n, 3)).astype(np.float32) * np.float32(0.3)
    o[:, 0] += np.float32(-3.0)
    tgt = rng.uniform(-2, 2, (n, 3)).astype(np.float32)
    if kind == "single":  # through expert 0's occupied cell centre
        c = boxes[0, 0] + (boxes[0, 1] - boxes[0, 0]) * (
            np.array([r // 2, r // 3, r // 2]) + 0.5) / r
        tgt[:] = c.astype(np.float32)
    d = tgt - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    near = np.full(n, 0.5, np.float32)
    far = rng.uniform(4.0, 6.0, n).astype(np.float32)
    if kind == "borders":
        s = 2.0 ** np.arange(l, dtype=np.float32)
        ctr = np.float32(0.5) * (boxes[:, 0] + boxes[:, 1])
        hlf = np.float32(0.5) * (boxes[:, 1] - boxes[:, 0])
        lo = ctr[:, None] - hlf[:, None] * s[None, :, None]
        hi = ctr[:, None] + hlf[:, None] * s[None, :, None]
        edges = np.stack([lo, hi], 2).reshape(-1, 3)  # (k * l * 2, 3)
        pick = edges[rng.integers(len(edges), size=(n, 3)), np.arange(3)]
        ulp = rng.integers(-1, 2, size=(n, 3))
        pick = np.where(ulp > 0, np.nextafter(pick, np.float32(np.inf)),
                        np.where(ulp < 0,
                                 np.nextafter(pick, np.float32(-np.inf)),
                                 pick)).astype(np.float32)
        third = n // 3
        o[:third] = pick[:third]
        d[:third] = 0.0
        o[third:2 * third, 1:] = pick[third:2 * third, 1:]
        d[third:2 * third] = np.array([1.0, 0.0, 0.0], np.float32)
    elif kind == "outside":
        o[: n // 2] = rng.uniform(30, 40, (n // 2, 3)).astype(np.float32)
    return [np.ascontiguousarray(a) for a in (occs, binary, boxes, o, d,
                                              near, far)]


def probe_edge_cases():
    """(label, kind, P, K, L, R, importance, ray_floor) of `probe_edges`."""
    cases = [("level borders and one ulp either side", "borders", 128, 4, 4,
              32, True, 0.25),
             ("points outside every level", "outside", 128, 4, 4, 32, True,
              0.25),
             ("all-dead rays", "dead", 128, 4, 4, 32, True, 0.25),
             ("one occupied cell, rays through it", "single", 128, 4, 4, 64,
              True, 0.25),
             ("vsum on both sides of 1e-12 with occupied probes", "tiny",
              128, 4, 4, 32, True, 0.25)]
    cases += [(f"P={p}", "rand", p, 4, 4, 32, True, 0.25)
              for p in (32, 100, 256)]
    cases += [("K=1 L=1 (the union grid)", "rand", 128, 1, 1, 128, True,
               0.25),
              ("K=1 L=4 (a task probe)", "borders", 128, 1, 4, 32, True,
               0.25),
              ("K=5 (two expert groups)", "borders", 128, 5, 2, 16, True,
               0.25),
              ("importance off, ray_floor 0", "rand", 128, 4, 4, 32, False,
               0.0),
              ("importance on, ray_floor 0", "rand", 128, 4, 4, 32, True,
               0.0),
              ("importance off, ray_floor 0.25", "borders", 128, 4, 4, 32,
               False, 0.25)]
    return cases


def probe_edges(device):
    """Kernel 2 against its plain version on `probe_edge_cases`, under both
    lane maps: 0 occ-bit and 0 alive flips, the cdf bit-equal."""
    import torch

    from nerfsys_tpu_torch.ops import occupancy as O

    for seed, (label, kind, P, K, L, R, imp, rf) in enumerate(
            probe_edge_cases()):
        occs, binary, boxes, o, d, near, far = (
            torch.from_numpy(a).to(device) for a in probe_edge_inputs(
                kind, PROBE_EDGE_N, K, L, R, seed))
        kw = dict(n_probes=P, importance=imp, ray_floor=rf)
        want = O.occupancy_probe_cdf(occs, binary, boxes, o, d, near, far,
                                     **kw, use_kernels=False)
        for lane_map in O.PROBE_LANE_MAPS:
            got = O.occupancy_probe_cdf_kernel(occs, binary, boxes, o, d,
                                               near, far, **kw,
                                               lane_map=lane_map)
            torch.cuda.synchronize()
            flips = int((got["occ"] != want["occ"]).sum())
            alive = int((got["alive"] != want["alive"]).sum())
            err = max_err(got["cdf"], want["cdf"])
            ms = device_ms(lambda: O.occupancy_probe_cdf_kernel(
                occs, binary, boxes, o, d, near, far, **kw,
                lane_map=lane_map), 5)
            print(f"edge occupancy_probe_cdf {label}: N={PROBE_EDGE_N} P={P}"
                  f" K={K} L={L} R={R} importance={imp} ray_floor={rf} "
                  f"occ_bit_flips={flips} alive_flips={alive} occupied="
                  f"{float(want['occ'].float().mean()):.4f} alive="
                  f"{float(want['alive'].float().mean()):.4f} cdf_err="
                  f"{err:.3e} tol={PROBE_EDGE_TOL:g} device_ms={ms:.4f} plan "
                  + probe_plan_text(O.occ_probe_plan(PROBE_EDGE_N, P, K, L,
                                                     lane_map)), flush=True)
            if flips or alive or not err <= PROBE_EDGE_TOL:
                raise SystemExit(f"kernel occupancy_probe_cdf disagrees with "
                                 f"its plain version on {label} "
                                 f"({lane_map}): {flips} bits, {alive} "
                                 f"rays, cdf {err}")


# kernel 11q selects the plain version's cells with the same float-bound
# test as kernel 2: bits and values equal
QUERY_EDGE_N = 4096 * 8 + 13  # a tail past whole 256-point blocks


def query_step_points(lo, hi, r: int):
    """(..., r - 1) float32: for levels spanning lo to hi (...,) on one
    axis, the least float x with trunc(fl(fl(x - lo) / (hi - lo)) * r) >=
    j, j = 1 .. r - 1 (the plain version's cell formula), by bisection
    over the floats' order in numpy, apart from the port's own tables."""
    import numpy as np

    def key(x):
        u = x.astype(np.float32).view(np.int32).astype(np.int64)
        return np.where(u >= 0, u, -(u + 2 ** 31) - 1)

    def flt(kk):
        return np.where(kk >= 0, kk, -(kk + 1) - 2 ** 31).astype(
            np.int32).view(np.float32)

    lo = lo[..., None].astype(np.float32)
    hi = hi[..., None].astype(np.float32)
    w = hi - lo
    j = np.arange(1, r, dtype=np.float32)
    lo_k = np.broadcast_to(key(lo), lo.shape[:-1] + (r - 1,))
    hi_k = np.broadcast_to(key(hi), lo_k.shape)
    for _ in range(33):
        mid = lo_k + (hi_k - lo_k) // 2
        take = (flt(mid) - lo) / w * np.float32(r) >= j
        hi_k, lo_k = np.where(take, mid, hi_k), np.where(take, lo_k, mid)
    return flt(hi_k)


def query_edge_inputs(kind: str, m: int, k: int, l: int, r: int, seed: int):
    """Adversarial inputs of kernel 11q from numpy seed `seed`: occs,
    binary (k, l, r, r, r), boxes (k, 2, 3) and points (m, 3). "faces"
    puts every coordinate of the points on a level's lo or hi face (rel
    exactly 0 or exactly 1) or one ulp either side; "outside" puts half
    the points outside every level of every expert; "round" puts points
    within a few ulps below a level's hi face: rel just below 1, rel * R
    at the top of the last cell (the clamp at R - 1 guards it; rel < 1
    holds exactly where x < b, so rel * R stays below R even for R not a
    power of 2); "steps" puts every coordinate on a step point of one
    level (`query_step_points`: where the plain cell goes from j - 1 to
    j, which the kernel's multiply guess may miss by a cell) or one ulp
    either side; "invisible" tags a third of the
    cells -1 (the premark: never occupied, they read 0); otherwise points
    at random in and around the boxes, half the cells occupied at values
    in [0, 1)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    cents = np.array([[0.0, -1, -1], [0.0, -1, 1], [0.0, 1, -1], [0.0, 1, 1],
                      [0.4, 0.2, 0.0]], np.float32)[np.arange(k) % 5]
    half = np.float32(1.2) if k > 1 else np.float32(0.9)
    boxes = np.stack([cents - half, cents + half], 1).astype(np.float32)
    binary = rng.uniform(size=(k, l, r, r, r)) < 0.5
    occs = np.where(binary, rng.uniform(size=binary.shape),
                    0.0).astype(np.float32)
    if kind == "invisible":
        tag = rng.uniform(size=binary.shape) < 1.0 / 3
        occs[tag] = -1.0
        binary[tag] = False
    pts = rng.uniform(-2.0 * half - 1.5, 2.0 * half + 1.5,
                      (m, 3)).astype(np.float32)
    s = 2.0 ** np.arange(l, dtype=np.float32)
    ctr = np.float32(0.5) * (boxes[:, 0] + boxes[:, 1])
    hlf = np.float32(0.5) * (boxes[:, 1] - boxes[:, 0])
    lo = ctr[:, None] - hlf[:, None] * s[None, :, None]  # (k, l, 3)
    hi = ctr[:, None] + hlf[:, None] * s[None, :, None]
    if kind == "faces":
        faces = np.stack([lo, hi], 2).reshape(-1, 3)  # (k * l * 2, 3)
        pick = faces[rng.integers(len(faces), size=(m, 3)), np.arange(3)]
        ulp = rng.integers(-1, 2, size=(m, 3))
        pts = np.where(ulp > 0, np.nextafter(pick, np.float32(np.inf)),
                       np.where(ulp < 0,
                                np.nextafter(pick, np.float32(-np.inf)),
                                pick)).astype(np.float32)
    elif kind == "outside":
        far_out = rng.uniform(1.0, 3.0, (m // 2, 3)).astype(np.float32)
        sign = np.where(rng.uniform(size=(m // 2, 3)) < 0.5, -1.0, 1.0)
        top = np.abs(np.concatenate([lo, hi], 1)).max()
        pts[: m // 2] = (sign * (top + far_out)).astype(np.float32)
    elif kind == "round":
        face = hi.reshape(-1, 3)[rng.integers(k * l, size=m)]
        steps = rng.integers(1, 5, size=(m, 3))
        below = face.copy()
        for _ in range(4):  # a few ulps below the face
            below = np.where(steps > 0,
                             np.nextafter(below, np.float32(-np.inf)),
                             below).astype(np.float32)
            steps -= 1
        axis = rng.integers(0, 3, size=m)
        mix = rng.uniform(size=(m, 3)) < 0.5
        pts = np.where(mix | (np.arange(3)[None, :] == axis[:, None]),
                       below, pts).astype(np.float32)
    elif kind == "steps":
        steps = query_step_points(lo, hi, r)  # (k, l, 3, r - 1)
        lev = (rng.integers(k, size=(m, 1)), rng.integers(l, size=(m, 1)))
        pick = steps[lev[0], lev[1], np.arange(3)[None, :],
                     rng.integers(r - 1, size=(m, 3))]
        ulp = rng.integers(-1, 2, size=(m, 3))
        pts = np.where(ulp > 0, np.nextafter(pick, np.float32(np.inf)),
                       np.where(ulp < 0,
                                np.nextafter(pick, np.float32(-np.inf)),
                                pick)).astype(np.float32)
    return [np.ascontiguousarray(a) for a in (occs, binary, boxes, pts)]


def query_edge_cases():
    """(label, kind, M, K, L, R) of `query_edges`: every kind at K=4 and
    K=1, a tail past whole blocks, and M = 0."""
    n = QUERY_EDGE_N
    cases = [("points on level faces and one ulp either side", "faces", n,
              4, 4, 16),
             ("points outside every level", "outside", n, 4, 4, 16),
             ("rel * R at the top of the last cell (R=12)", "round", n, 4,
              3, 12),
             ("invisible cells tagged -1", "invisible", n, 4, 4, 16),
             ("random points", "rand", n, 4, 4, 32),
             ("K=1 faces (a task's slice)", "faces", n, 1, 4, 16),
             ("K=1 rel * R at the top of the last cell (R=24)", "round", n,
              1, 2, 24),
             ("K=1 L=1 (the union grid)", "rand", n, 1, 1, 128),
             ("K=5, M=1", "faces", 1, 5, 2, 16),
             ("M=0", "rand", 0, 4, 4, 16),
             ("points on the cells' step points and one ulp either side "
              "(R=128)", "steps", n, 4, 4, 128),
             ("K=1 step points (R=127)", "steps", n, 1, 4, 127)]
    return cases


def query_mismatches(occs, binary, boxes, pts, mode) -> int:
    """Outputs of kernel 11q in `mode` that differ from its plain
    version's."""
    from nerfsys_tpu_torch.ops import occupancy as O

    got = O.occupancy_query_kernel(occs, binary, boxes, pts, mode)
    want = O.occupancy_query_plain(occs, binary, boxes, pts, mode)
    if mode != "pair":
        got, want = (got,), (want,)
    return sum(int((g != w).sum()) for g, w in zip(got, want))


def query_case_line(label, occs, binary, boxes, pts) -> None:
    """Kernel 11q against its plain version in each mode on one input:
    prints one `edge occupancy_query` line, raises unless bits and values
    are equal."""
    from nerfsys_tpu_torch.ops import occupancy as O

    out = {mode: query_mismatches(occs, binary, boxes, pts, mode)
           for mode in O.QUERY_MODES}
    ms = (device_ms(lambda: O.occupancy_query_kernel(
        occs, binary, boxes, pts, "bits"), 5) if pts.shape[0] else 0.0)
    bits = O.occupancy_query_plain(occs, binary, boxes, pts, "bits").float()
    share = float(bits.mean()) if bits.numel() else 0.0
    K, L, R = occs.shape[:3]
    print(f"edge occupancy_query {label}: M={pts.shape[0]} K={K} L={L} "
          f"R={R} occupied={share:.4f} mismatches bits={out['bits']} values={out['values']} pair="
          f"{out['pair']} (equal expected) device_ms={ms:.4f}", flush=True)
    if any(out.values()):
        raise SystemExit(f"kernel occupancy_query disagrees with its plain "
                         f"version on {label}: {out}")


def query_edges(device):
    """Kernel 11q against its plain version on `query_edge_cases`."""
    import torch

    for seed, (label, kind, m, k, l, r) in enumerate(query_edge_cases()):
        query_case_line(label, *(torch.from_numpy(a).to(device) for a in
                                 query_edge_inputs(kind, m, k, l, r,
                                                   200 + seed)))


SAMPLE_EDGE_TOL = 1e-5
SAMPLE_STEP_N = 4000  # one inner step's rays (TRAIN_S)
SAMPLE_GRID_N = 4000 + 13  # a tail past whole 4-ray blocks


def sample_edge_inputs(kind: str, n: int, p: int, s: int, per_ray: bool,
                       seed: int, with_bits: bool = False):
    """Adversarial inputs of kernel 3 from numpy seed `seed`: cdf (n, p+1)
    rows built as kernel 2 builds them (probe weights, each + 1e-12, a
    float32 cumsum, divided by the last entry, a leading 0), near, far (n,)
    and targets u, (s,) midpoints or (n, s) jittered and clamped as
    `_sample_targets` makes them. Half the probes are dead (weight 0) in
    every kind but "dead" (all dead: the 1e-12 floor alone). "dip" lowers
    the entry after a dead probe to one ulp below its predecessor in half
    the rows (the dips of a Kogge-Stone scan); "tiny" kills the first 24
    probes of every row, so its first entries differ by less than 1e-12,
    and aims the first 8 targets of each ray into them (the clamp); "exact"
    sets targets equal to cdf entries; "top" sets the last 4 targets to
    1 - 1e-6, the jitter's clamp; "near=far" gives every ray far = near;
    "reversed" reverses each ray's targets; "tied" sets far two ulps above
    near, so every t is near or one of the next two floats and samples of
    different intervals tie (reversed targets too when per ray: ties in
    the rank sort). with_bits appends the probe bits (n, p) bool: a probe
    occupied where its weight is not 0 (as kernel 2's occ), but at random
    in "tied" and "reversed", so that samples of different intervals carry
    different bits (with kernel 2's bits every sample lands in an occupied
    interval) and their order decides the mask."""
    import numpy as np

    f32 = np.float32
    rng = np.random.default_rng(seed)
    w = rng.uniform(size=(n, p)).astype(f32)
    w[rng.uniform(size=(n, p)) < 0.5] = 0.0
    if kind == "dead":
        w[:] = 0.0
    if kind == "tiny":
        w[:, :24] = 0.0
    c = np.cumsum(w + f32(1e-12), axis=1, dtype=f32)
    c = np.concatenate([np.zeros((n, 1), f32), c / c[:, -1:]], 1)
    if kind == "dip" and p > 1:
        rows = np.arange(0, n, 2)
        q = rng.integers(0, p - 1, size=len(rows))
        c[rows, q + 1] = np.nextafter(c[rows, q], f32(-1.0))
    near = rng.uniform(0.1, 1.0, n).astype(f32)
    far = (near + rng.uniform(1.0, 5.0, n)).astype(f32)
    if kind == "near=far":
        far = near.copy()
    elif kind == "tied":
        far = np.nextafter(np.nextafter(near, np.float32(np.inf)),
                           np.float32(np.inf)).astype(f32)
    u = ((np.arange(s, dtype=f32) + f32(0.5)) / f32(s)).astype(f32)
    if per_ray:
        jit = ((rng.uniform(size=(n, s)).astype(f32) - f32(0.5)) / f32(s))
        u = np.clip(u + jit, f32(0.0), f32(1.0 - 1e-6)).astype(f32)
        if kind == "tiny":
            k = min(s, 8)
            u[:, :k] = c[:, 1:k + 1] * f32(1.5)
        elif kind == "exact":
            pick = np.sort(rng.integers(1, p + 1, size=(n, s)), axis=1)
            u = np.take_along_axis(c, pick, 1).astype(f32)
        elif kind == "top":
            u[:, -4:] = f32(1.0 - 1e-6)
        elif kind in ("reversed", "tied"):
            u = np.ascontiguousarray(u[:, ::-1])
    out = [c, near, far, u]
    if with_bits:
        out.append(rng.uniform(size=(n, p)) < 0.5
                   if kind in ("tied", "reversed") else w > 0)
    return [np.ascontiguousarray(a) for a in out]


def sample_edge_cases():
    """(label, kind, N, P, S, per_ray) of `sample_edges`: the serve chunk
    (65,536 rays, shared targets) and the step (4,000 rays, jittered
    targets) at P=128, S=32, then P in {1, 127, 129, 256} x S in {1, 8, 24,
    64} with shared targets."""
    chunk, step = CHECK_RAYS, SAMPLE_STEP_N
    cases = [("one-ulp dips after dead probes", "dip", chunk, 128, 32,
              False),
             ("one-ulp dips, jittered u", "dip", step, 128, 32, True),
             ("flat runs under the 1e-12 clamp", "tiny", step, 128, 32,
              True),
             ("u equal to cdf entries", "exact", step, 128, 32, True),
             ("u = 1 - 1e-6", "top", step, 128, 32, True),
             ("all-dead rows", "dead", chunk, 128, 32, False),
             ("near = far", "near=far", chunk, 128, 32, False),
             ("jittered u out of order", "reversed", step, 128, 32, True),
             ("ties: t within two ulps, samples of different intervals",
              "tied", step, 128, 32, False),
             ("ties in reversed rows (the rank sort)", "tied", step, 128, 32,
              True)]
    cases += [(f"P={p} S={s}", "rand", SAMPLE_GRID_N, p, s, False)
              for p in (1, 127, 129, 256) for s in (1, 8, 24, 64)]
    return cases


def sample_case_line(label, cdf, near, far, u, want, device,
                     occ=None) -> tuple:
    """Kernel 3 on one input: prints one `edge sample_tvals_from_cdf`
    line, raises on an error above SAMPLE_EDGE_TOL or when the rows that
    took the literal count are not the rows that dip, returns (rows that
    took the count, rows that took the rank sort, rows). With the probe
    bits `occ`, also 3m: one `edge sample_tvals_from_cdf mask` line, the
    mask equal to the plain version's and t equal to the kernel's without
    the mask."""
    import torch

    from nerfsys_tpu_torch.ops import occupancy as O

    counts = torch.zeros(2, dtype=torch.int32, device=device)
    got = O.sample_tvals_kernel(cdf, near, far, u, branch_counts=counts)
    err = max_err(got, want)
    n_count, n_sort = counts.tolist()
    dips = int((~(cdf[:, :-1] <= cdf[:, 1:]).all(1)).sum())
    ms = device_ms(lambda: O.sample_tvals_kernel(cdf, near, far, u), 5)
    N, S = got.shape
    print(f"edge sample_tvals_from_cdf {label}: N={N} P={cdf.shape[1] - 1} "
          f"S={S} u={'per ray' if u.dim() == 2 else 'shared'} "
          f"max_abs_err={err:.3e} tol={SAMPLE_EDGE_TOL:g} count_rows="
          f"{n_count} (rows failing c[q] <= c[q+1]: {dips}) search_rows={N - n_count} "
          f"rank_sort_rows={n_sort} sorted_rows={N - n_sort} device_ms="
          f"{ms:.4f}", flush=True)
    if not err <= SAMPLE_EDGE_TOL:
        raise SystemExit(f"kernel sample_tvals_from_cdf disagrees with its "
                         f"plain version on {label}: {err}")
    if n_count != dips:
        raise SystemExit(f"kernel sample_tvals_from_cdf: {n_count} rows took "
                         f"the count on {label}, {dips} rows dip")
    if occ is not None:
        t_m, mask = O.sample_tvals_kernel(cdf, near, far, u, occ)
        _, want_m = O.sample_tvals_plain(cdf, near, far, u, occ)
        flips = int((mask != want_m).sum())
        t_diff = max_err(t_m, got)
        ms_m = device_ms(lambda: O.sample_tvals_kernel(cdf, near, far, u,
                                                       occ), 5)
        print(f"edge sample_tvals_from_cdf mask {label}: N={N} S={S} "
              f"mask_flips={flips} (0 expected: the stable (value, index) "
              f"order) kept={float(want_m.float().mean()):.4f} t_vs_no_mask="
              f"{t_diff:.3e} (0 expected) device_ms={ms_m:.4f} "
              f"(without the mask {ms:.4f})", flush=True)
        if flips or t_diff != 0.0:
            raise SystemExit(f"kernel sample_tvals_from_cdf's mask disagrees "
                             f"with its plain version on {label}: {flips} "
                             f"bits, t {t_diff}")
    return n_count, n_sort, N


def sample_edges(device):
    """Kernel 3 against its plain version on `sample_edge_cases` and on
    kernel 2's own cdf rows over dead probes; every branch (binary search
    and literal count, written out sorted and rank-sorted) must be reached
    on the card."""
    import torch

    from nerfsys_tpu_torch.ops import occupancy as O

    totals = [0, 0, 0]
    for seed, (label, kind, n, p, s, per_ray) in enumerate(
            sample_edge_cases()):
        cdf, near, far, u, occ = (torch.from_numpy(a).to(device) for a in
                                  sample_edge_inputs(kind, n, p, s, per_ray,
                                                     seed, with_bits=True))
        want = O.sample_tvals_plain(cdf, near, far, u)
        for i, v in enumerate(sample_case_line(label, cdf, near, far, u,
                                               want, device, occ)):
            totals[i] += v
    for seed, kind in enumerate(("dead", "tiny", "rand")):
        occs, binary, boxes, o, d, near, far = (
            torch.from_numpy(a).to(device) for a in probe_edge_inputs(
                kind, SAMPLE_STEP_N, 4, 4, 32, 100 + seed))
        probed = O.occupancy_probe_cdf_kernel(occs, binary, boxes, o, d,
                                              near, far, 128,
                                              importance=True,
                                              ray_floor=0.25)
        cdf = probed["cdf"]
        gen = torch.Generator(device=device).manual_seed(seed)
        u = O._sample_targets(SAMPLE_STEP_N, 32, device, gen,
                              True).contiguous()
        want = O.sample_tvals_plain(cdf, near, far, u)
        for i, v in enumerate(sample_case_line(
                f"kernel 2's cdf, {kind} probes", cdf, near, far, u, want,
                device, probed["occ"])):
            totals[i] += v
    n_count, n_sort, rows = totals
    if not (0 < n_count < rows and 0 < n_sort < rows):
        raise SystemExit(f"kernel sample_tvals_from_cdf: the edge cases "
                         f"reached the count on {n_count} and the rank sort "
                         f"on {n_sort} of {rows} rows: a branch went "
                         f"unchecked")
    print(f"edge sample_tvals_from_cdf: all cases: {rows} rows, {n_count} "
          f"took the literal count and {rows - n_count} the binary search, "
          f"{n_sort} the rank sort and {rows - n_sort} were written out "
          f"sorted", flush=True)


def plan_text(plan) -> str:
    return (f"tile={plan.tile} threads={plan.threads} blocks={plan.blocks} "
            f"smem={plan.smem} vec={int(plan.vec)}"
            + (f" private_line_levels={plan.private_levels}"
               if plan.line_ofs else "")
            + (" exact" if plan.exact else "")
            + (" second-order" if plan.second else ""))


def edge_points(kind: str, k: int, n: int, device):
    """Adversarial unit-cube points (k, n, 3) from numpy seed 5: "one
    cell" puts every point at one interior point (every lane of every warp
    on the same rows); "bounds" mixes coordinates of exactly 0, exactly 1,
    -0.25 and 1.5 (clipped) with uniform ones."""
    import numpy as np
    import torch

    rng = np.random.default_rng(5)
    if kind == "one cell":
        x = np.empty((k, n, 3), np.float32)
        x[...] = np.array([0.31731, 0.60213, 0.44897], np.float32)
    else:
        x = rng.uniform(size=(k, n, 3)).astype(np.float32)
        pick = rng.integers(0, 5, size=(k, n, 3))
        special = np.array([0.0, 1.0, -0.25, 1.5], np.float32)
        x = np.where(pick < 4, special[np.minimum(pick, 3)], x)
    return torch.from_numpy(x).to(device)


def edge_tables(pc, k: int, device):
    import torch

    from nerfsys_tpu_torch.ops import planes as PL

    return PL.plane_encoding_init(pc, torch.Generator().manual_seed(6),
                                  device=device, num_experts=k)


def plane_fwd_edges(pc, enc_p, x01, device):
    """Kernel 1 against its plain version on adversarial inputs at the serve
    chunk (K=4, 2,097,152 points an expert unless stated): one cell,
    coordinates on and outside the bounds, a tail tile (N - 37), no lines,
    F=2 (the scalar variant), and L=5 base 128 (K=1, 120 output floats a
    point); bit-equal (tolerance 0), as the --fmad=false build is."""
    import dataclasses

    import torch

    from nerfsys_tpu_torch.ops import planes as PL

    K, N = x01.shape[:2]
    no_lines = dataclasses.replace(pc, include_lines=False)
    f2 = dataclasses.replace(pc, features=2)
    l5 = dataclasses.replace(pc, levels=5)
    cases = (
        ("one cell", pc, enc_p, edge_points("one cell", K, N, device)),
        ("bounds", pc, enc_p, edge_points("bounds", K, N, device)),
        ("tail N-37", pc, enc_p, x01[:, :N - 37].contiguous()),
        ("no lines", no_lines, {"planes": enc_p["planes"]}, x01),
        ("F=2 scalar", f2, edge_tables(f2, K, device), x01),
        ("L=5 base 128 K=1", l5, edge_tables(l5, 1, device),
         x01[:1].contiguous()))
    for label, c, tab, x in cases:
        got = PL.plane_encode_kernel(tab, x, c)
        want = PL.plane_encode_plain(tab, x, c)
        err = max_err(got, want)
        ms = cuda_ms(lambda: PL.plane_encode_kernel(tab, x, c), 3)
        plan = PL.plane_fwd_plan(x.shape[1], c.level_resolutions(),
                                 c.features)
        print(f"edge plane_encode_fwd {label}: K={x.shape[0]} "
              f"N={x.shape[1]} max_abs_err={err:.3e} tol=0 "
              f"kernel_ms={ms:.4f} plan {plan_text(plan)}", flush=True)
        if not err <= 0.0:
            raise SystemExit(f"kernel plane_encode_fwd disagrees with its "
                             f"plain version on {label}: {err}")
        del got, want
    torch.cuda.empty_cache()


def plane_bwd_edges(cfg, statics, params, enc, pts, x01, ct, device):
    """Kernels 5 (light) and 6 (exact, pos_grad=True) against their plain
    versions on adversarial inputs at the inner step (one expert, 128,000
    points unless stated), each table and the position gradient within
    1e-4 of its max: one cell (every lane of a warp on the same rows: the
    deepest aggregation), coordinates on and outside the bounds, a tail
    tile (P - 37), a single point, no lines, F=2 (the scalar variant), the
    K=4 experts stacked, L=5 base 128 (level 0 private, 1-4 on the global
    line path), and bench width with all three line levels private and
    with none (the global line path alone)."""
    import dataclasses

    import torch

    from nerfsys_tpu_torch.models.ngp import world_to_unit
    from nerfsys_tpu_torch.ops import planes as PL
    from nerfsys_tpu_torch.utils.device import num_sms

    P = x01.shape[0]
    gen = torch.Generator(device=device).manual_seed(8)

    def cot(c, *lead):
        return torch.randn((*lead, c.out_dim), device=device, generator=gen)

    xk = world_to_unit(pts, statics.expert_aabbs,
                       cfg.expert.enc_eps).contiguous()
    sms = num_sms(x01.device)
    for exact in (False, True):
        name = "plane_encode_bwd" if exact else "plane_encode_bwd_light"
        pc = dataclasses.replace(cfg.expert.planes, pos_grad=exact)
        no_lines = dataclasses.replace(pc, include_lines=False)
        f2 = dataclasses.replace(pc, features=2)
        l5 = dataclasses.replace(pc, levels=5)
        res = pc.level_resolutions()
        l5_plan = PL.plane_bwd_plan(P, 1, l5.level_resolutions(), 8, True,
                                    sms, exact=exact)
        if not (l5_plan.private_levels and len(l5_plan.private_levels) < 5):
            raise SystemExit(f"L=5 plan does not split the line levels: "
                             f"{l5_plan}")
        cases = (
            ("one cell", pc, enc, edge_points("one cell", 1, P, device)[0],
             ct, None),
            ("bounds", pc, enc, edge_points("bounds", 1, P, device)[0], ct,
             None),
            ("tail P-37", pc, enc, x01[:P - 37].contiguous(),
             ct[:P - 37].contiguous(), None),
            ("single point", pc, enc, x01[:1].contiguous(),
             ct[:1].contiguous(), None),
            ("no lines", no_lines, {"planes": enc["planes"]}, x01,
             cot(no_lines, P), None),
            ("F=2 scalar", f2, edge_tables(f2, 0, device), x01, cot(f2, P),
             None),
            ("stacked K=4", pc, params["experts"]["planes_enc"], xk,
             cot(pc, xk.shape[0], P), None),
            ("L=5 base 128", l5, edge_tables(l5, 0, device), x01,
             cot(l5, P), l5_plan),
            ("every line level private", pc, enc, x01, ct,
             PL.plane_bwd_plan(P, 1, res, 8, True, sms, line_budget=None,
                               exact=exact)),
            ("global line path", pc, enc, x01, ct,
             PL.plane_bwd_plan(P, 1, res, 8, True, sms, line_budget=0,
                               exact=exact)))
        for label, c, tab, x, g, plan in cases:
            got = PL.plane_encode_bwd_planned(tab, x, g, c, plan)
            want = PL.plane_encode_bwd_plain(tab, x, g, c)
            errs = [rel_err(a, b) for a, b in zip(
                got[0] + (got[1] or []), want[0] + (want[1] or []))]
            x_err = rel_err(got[2], want[2]) if exact else 0.0
            ms = cuda_ms(lambda: PL.plane_encode_bwd_planned(tab, x, g, c,
                                                             plan), 3)
            K = x.shape[0] if x.dim() == 3 else 1
            shown = plan or PL.plane_bwd_plan(
                x.shape[-2], K, c.level_resolutions(), c.features,
                c.include_lines, sms, exact=exact)
            print(f"edge {name} {label}: K={K} N={x.shape[-2]} "
                  f"table_err/max={max(errs):.3e}"
                  + (f" x_err/max={x_err:.3e}" if exact else "")
                  + f" tol=0.0001 kernel_ms={ms:.4f} plan "
                  + plan_text(shown), flush=True)
            if not max(errs + [x_err]) <= 1e-4:
                raise SystemExit(f"kernel {name} disagrees with its plain "
                                 f"version on {label}: {errs} x {x_err}")
            del got, want
    torch.cuda.empty_cache()


class GradRecorder:
    """Wraps an optimizer and keeps, by update index, the gradients of the
    updates whose indices are in `keep` (all of them by default)."""

    def __init__(self, opt, keep=None):
        self.opt, self.grads, self.keep, self.n = opt, {}, keep, 0

    def init(self, params):
        return self.opt.init(params)

    def update(self, grads, state, params=None):
        if self.keep is None or self.n in self.keep:
            self.grads[self.n] = grads
        self.n += 1
        return self.opt.update(grads, state, params)


def grads_through_plain_match(meta, cfg, opt, statics, params, occ, batch,
                              device, label="train", kernel_side=None,
                              gen_state=None):
    """One outer step's gradients (all B tasks) through the kernels against
    the same step through the plain versions, both through `make_train_step`
    on the card, from the same random draws (one generator seed each, or
    the generator state `gen_state`). `kernel_side`: the kernel path's
    (meta loss, gradient leaves) when they were already recorded. Returns
    the kernel path's (meta loss, gradient leaves)."""
    import torch

    from nerfsys_tpu_torch.pipelines.offline.meta_train_step import (
        make_train_step,
    )
    from nerfsys_tpu_torch.utils.tree import tree_leaves

    out = [] if kernel_side is None else [kernel_side]
    for use_kernels in (True, False)[len(out):]:
        rec = GradRecorder(opt)
        gen = torch.Generator(device=device)
        if gen_state is None:
            gen.manual_seed(7)
        else:
            gen.set_state(gen_state)
        _, _, aux = make_train_step(meta, cfg, rec, use_kernels=use_kernels)(
            params, rec.init(params), statics, batch, gen, occ)
        out.append((float(aux["loss_out_meta"]), tree_leaves(rec.grads[0])))
    (lk, gk), (lp, gp) = out
    errs = [rel_err(a, b) for a, b in zip(gk, gp)]
    tol = 2.0**-8
    print(f"{label}: one step through kernels vs plain: loss {lk:.7f} vs "
          f"{lp:.7f}; gradient error / leaf max: worst {max(errs):.3e} "
          f"median {sorted(errs)[len(errs) // 2]:.3e} over {len(errs)} "
          f"leaves (tol {tol:g}: 8 inner SGD steps carry encoder rounding "
          f"and bf16 residual flips, 2^-8 each, into the query gradients)",
          flush=True)
    if abs(lk - lp) > 1e-4 * abs(lp) or not max(errs) <= tol:
        raise SystemExit(f"{label}: kernel path gradients disagree with "
                         f"the plain path")
    return lk, gk


def profile_device(label: str, fn, extra: str = "", watch=(),
                   ranges=None) -> float:
    """Where one call's time goes: device time by kernel under
    torch.profiler, the device busy share of the (profiled) wall time;
    also the rows whose names contain every word of one `watch` entry.
    `ranges`: a dict whose keys name torch.profiler.record_function ranges
    opened inside fn (`named_range`); each value is set to (calls, device
    ms of the kernels launched inside them). Host ops are traced only for
    `ranges` (a MAML step's tens of thousands of host ops take the
    profiler tens of seconds to process, and tracing them lengthens the
    wall time). Returns the device busy ms (0 when the profiler saw no
    device events)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CUDA]
    if ranges is not None:
        activities.insert(0, ProfilerActivity.CPU)
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    return profile_report(label, prof, wall_ms, extra, watch, ranges)


PROFILES = {}  # label -> (wall ms, device busy ms) of each profile_report
# words of cuBLAS's matrix-product kernel names (sm80_xmma_gemm_*,
# cutlass_*_sgemm_*, gemv*, and the nvjet_* kernels of newer cuBLAS)
MATMUL_WORDS = ("gemm", "gemv", "nvjet")
WATCHED = {}  # (label, watch words) -> (launches, device ms) of its rows


def averaged_rows(prof, names=()):
    """(device ms, name, launches) of every device event name with time in
    a finished torch.profiler session, from `key_averages` (the profiler's
    event tree), leaving out the ranges `names`."""
    from torch.autograd import DeviceType

    rows = []
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA or ev.key in names:
            continue  # host-side ops and ranges carry their kernels' time too
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "self_cuda_time_total", 0)
        if dev_us > 0:
            rows.append((dev_us / 1e3, ev.key, ev.count))
    return sorted(rows, reverse=True)


def device_rows(prof):
    """`averaged_rows` summed straight from the session's kineto events:
    a device event has no children, so its self time is its duration.
    Building the event tree that `key_averages` reads took about 15 s a
    profiled MAML step (tens of thousands of device events) on an H100
    host, most of chip_smoke's time in profiles."""
    from torch.autograd import DeviceType
    from torch.autograd.profiler_util import _filter_name, _rewrite_name

    sums = {}
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type() != DeviceType.CUDA or _filter_name(ev.name()) \
                or ev.is_hidden_event():
            continue
        key = _rewrite_name(name=ev.name(), with_wildcard=True)
        n, ns = sums.get(key, (0, 0))
        sums[key] = (n + 1, ns + ev.end_ns() - ev.start_ns())
    return sorted(((ns / 1e6, key, n) for key, (n, ns) in sums.items()
                   if ns > 0), reverse=True)


ROWS_HELD = []  # the label whose device_rows were held to averaged_rows


def profile_report(label: str, prof, wall_ms: float, extra: str = "",
                   watch=(), ranges=None) -> float:
    """profile_device's report of a finished torch.profiler session that
    spanned `wall_ms` of host time; returns the device busy ms. With
    `ranges` the rows come from `averaged_rows` (the ranges' kernels need
    the event tree), else from `device_rows`, held once to
    `averaged_rows` (the same names and launches, ms within 1e-6)."""
    from torch.autograd import DeviceType

    names = set(ranges or ())
    if ranges is not None:
        rows = averaged_rows(prof, names)
    else:
        rows = device_rows(prof)
        if not ROWS_HELD:
            slow = averaged_rows(prof)
            fast = {key: (n, ms) for ms, key, n in rows}
            bad = [(key, n, ms, fast.get(key)) for ms, key, n in slow
                   if key not in fast or fast[key][0] != n
                   or abs(fast[key][1] - ms) > 1e-6 * max(ms, 1.0)]
            if bad or len(slow) != len(rows):
                raise SystemExit(f"profile: {label}: the kineto events' "
                                 f"sums disagree with key_averages: {bad}")
            print(f"profile: {label}: device rows summed from the kineto "
                  f"events equal key_averages' ({len(rows)} names, "
                  f"{sum(r[2] for r in rows)} launches)", flush=True)
            ROWS_HELD.append(label)
    busy_ms = sum(r[0] for r in rows)
    for name in names:
        evs = [ev for ev in prof.events()
               if ev.name == name and ev.device_type == DeviceType.CPU]
        dev_us = sum(ev.device_time_total if hasattr(ev, "device_time_total")
                     else ev.cuda_time_total for ev in evs)
        ranges[name] = (len(evs), dev_us / 1e3)
    if busy_ms > 0:
        print(f"profile: {label} wall_ms={wall_ms:.2f} (profiled) "
              f"device_busy_ms={busy_ms:.2f} "
              f"idle_share={1 - busy_ms / wall_ms:.3f}{extra}", flush=True)
        for dev_ms, key, count in rows[:12]:
            print(f"profile: {dev_ms:9.3f} ms {count:6d}x {key[:90]}")
        for words in watch:
            for dev_ms, key, count in rows:
                if all(w in key for w in words):
                    print(f"profile: {label} watch {count}x {key[:60]}: "
                          f"{dev_ms:.3f} ms ({dev_ms / count:.4f} ms each)",
                          flush=True)
                    n, ms = WATCHED.get((label, words), (0, 0.0))
                    WATCHED[label, words] = (n + count, ms + dev_ms)
        mm = [r for r in rows if any(w in r[1].lower() for w in MATMUL_WORDS)]
        print(f"profile: {label} matrix products (the MLPs' GEMMs and "
              f"GEMVs) {sum(r[2] for r in mm)}x {sum(r[0] for r in mm):.3f} "
              f"ms", flush=True)
        dtoh = [r for r in rows if "DtoH" in r[1]]
        print(f"profile: device-to-host copies {sum(r[2] for r in dtoh)}x "
              f"{sum(r[0] for r in dtoh):.3f} ms (each a host sync)",
              flush=True)
    else:
        print(f"profile: device time not measured (the profiler saw no "
              f"device events); {label} wall_ms={wall_ms:.2f}{extra}",
              flush=True)
    PROFILES[label] = (wall_ms, busy_ms)
    return busy_ms


@contextlib.contextmanager
def patched(module, attr: str, make):
    """While the block runs, `module.attr` is `make(original)`."""
    fn = getattr(module, attr)
    setattr(module, attr, make(fn))
    try:
        yield
    finally:
        setattr(module, attr, fn)


def named_range(module, attr: str, name: str):
    """While the block runs, every call of `module.attr` opens the
    torch.profiler.record_function range `name`, so that a profile sums
    the device time of the kernels launched inside those calls."""
    import torch

    def make(fn):
        def wrapped(*args, **kwargs):
            with torch.profiler.record_function(name):
                return fn(*args, **kwargs)
        return wrapped

    return patched(module, attr, make)


def exact_backward(cfg):
    """The planes experts with the encoder's default exact backward."""
    import dataclasses

    return dataclasses.replace(cfg, expert=dataclasses.replace(
        cfg.expert, planes=dataclasses.replace(cfg.expert.planes,
                                               pos_grad=True)))


def train(cfg, statics, params, occ, batch, device, label="train",
          extra=(exact_backward, "exact-backward"), need=TRAIN_KERNELS,
          meta=None, timed=3):
    """Phase 5: bench.py's step (FoMAML, or `meta`) through the port's
    entry point: a warm-up step, the counters zeroed just before `timed`
    steps (host ms each, ending in a host sync) and read just after one
    more step with the variant `extra` = (cfg -> cfg, its name) when
    given; the peak memory of the warm-up and timed steps; the kernel
    path's gradients against the plain path's; one profiled step, and one
    of the variant -> (launches of the timed steps, launches after the
    variant step, the kernel path's (meta loss, gradient leaves))."""
    import math

    import torch

    from nerfsys_tpu_torch import kernels
    from nerfsys_tpu_torch.models.container import param_group_labels
    from nerfsys_tpu_torch.pipelines.offline.meta_train_step import (
        make_train_step,
    )
    from nerfsys_tpu_torch.utils.optim import OptimConfig, build_optimizer
    from nerfsys_tpu_torch.utils.tree import tree_leaves

    meta = meta or train_meta()
    opt = build_optimizer(OptimConfig(outer_steps=10000),
                          param_group_labels(params))
    # the warm-up step is also the kernel side of the plain-path check
    # (grads_through_plain_match's seed); its gradients wait on the host
    rec = GradRecorder(opt, keep=(0,))
    step = make_train_step(meta, cfg, rec)
    gen = torch.Generator(device=device).manual_seed(7)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    t_start = time.perf_counter()
    state = rec.init(params)
    p, state, aux = step(params, state, statics, batch, gen, occ)  # warm-up
    first = (float(aux["loss_out_meta"]),
             [g.cpu() for g in tree_leaves(rec.grads.pop(0))])
    secs = {"warm-up": time.perf_counter() - t_start}

    kernels.reset_launches()
    times, losses = [], []
    for _ in range(timed):
        t0 = time.perf_counter()
        p, state, aux = step(p, state, statics, batch, gen, occ)
        losses.append(float(aux["loss_out"]))  # host sync ends the step
        times.append(time.perf_counter() - t0)
        if not math.isfinite(losses[-1]) or float(
                aux["skipped_nonfinite"]) != 0.0:
            raise SystemExit(f"{label}: step not finite: {aux}")
    secs["timed"] = sum(times)
    light = kernels.launches()
    peak = torch.cuda.max_memory_allocated()
    if meta.algo != "maml" and any(light[k] for k in MAML_NEW):
        raise SystemExit(f"{label}: a first-order step launched a "
                         f"second-order kernel: {light}")
    print(f"{label}: launches during {timed} bench steps {light}",
          flush=True)
    launches, step_x, loss_x = light, None, None
    if extra is not None:
        variant, name = extra
        t1 = time.perf_counter()
        step_x = make_train_step(meta, variant(cfg), opt)
        _, _, aux_x = step_x(p, state, statics, batch, gen, occ)
        loss_x = float(aux_x["loss_out"])
        launches = kernels.launches()
        print(f"{label}: launches after the {name} step {launches}",
              flush=True)
        if not math.isfinite(loss_x) or float(aux_x["skipped_nonfinite"]):
            raise SystemExit(f"{label}: {name} step not finite")
        secs[name] = time.perf_counter() - t1
    for k in need:
        if launches[k] <= 0:
            raise SystemExit(f"{label}: kernel {k} never launched")
    moved = [float((a - b).abs().max()) > 0
             for a, b in zip(tree_leaves(p), tree_leaves(params))]
    if not all(moved):
        raise SystemExit(f"{label}: {moved.count(False)} param leaves did "
                         f"not move")

    t1 = time.perf_counter()
    kernel_side = grads_through_plain_match(
        meta, cfg, opt, statics, params, occ, batch, device, label,
        kernel_side=(first[0], [g.to(device) for g in first[1]]))
    del first
    secs["plain-path step"] = time.perf_counter() - t1
    t1 = time.perf_counter()
    watch = (("volume_render_bwd_kernel",), ("volume_render_bwd2_kernel",),
             ("hash_fwd_kernel", "false"), ("hash_fwd_kernel", "true"),
             ("hash_bwd_kernel",), ("sample_tvals_kernel",),
             ("plane_encode_bwd_kernel",), ("plane_encode_bwd2_kernel",))
    profile_device(f"{label} step", lambda: float(
        step(p, state, statics, batch, gen, occ)[2]["loss_out"]),
        watch=watch)
    if step_x is not None:
        profile_device(f"{label} {name} step", lambda: float(
            step_x(p, state, statics, batch, gen, occ)[2]["loss_out"]),
            watch=watch)
    secs["profiles"] = time.perf_counter() - t1
    secs["in all"] = time.perf_counter() - t_start

    ms = [1e3 * t for t in times]
    n_rays = TRAIN_K * TRAIN_B * (TRAIN_S * TRAIN_INNER + TRAIN_Q)
    per = {k: light[k] / timed for k in MAML_WATCHED if light[k]}
    print(f"{label}: {meta.algo} K={TRAIN_K} B={TRAIN_B} S={TRAIN_S} "
          f"Q={TRAIN_Q} inner={TRAIN_INNER} samples=32 ms_per_step="
          f"{[round(x, 2) for x in ms]} mean_ms={sum(ms) / timed:.2f} "
          f"rays_per_s={n_rays / (sum(times) / timed):.1f} "
          f"(rays/step {n_rays}) loss_out={losses} "
          f"grad_norm={float(aux['grad_norm']):.4f} peak memory "
          f"{peak / 2**30:.2f} GiB (max_memory_allocated over the warm-up "
          f"and timed steps, {before / 2**30:.2f} GiB held before them); "
          f"launches per step {per}"
          + (f"; {name}_step_loss_out={loss_x:.6f}" if extra else "")
          + "; seconds " + ", ".join(f"{k} {v:.1f}" for k, v in secs.items()),
          flush=True)
    return light, launches, kernel_side


TRUNC_EXP_KERNELS = ("trunc_exp_fwd", "trunc_exp_bwd", "trunc_exp_bwd2")
TRUNC_EXP_STEP = 128_000  # points of a bench step's call (one inner step)


def trunc_exp_inputs(kind: str, n: int, device, seed: int):
    """(x, g, v) float32 of n points from numpy seed `seed`: "edges" the
    adversarial values (+-inf, NaN, -0.0, 0, +-88.7 and the floats on
    either side, far beyond both bounds) in turn, with g and v whose
    products with exp(88.7) overflow on some points; "random" x of
    N(0, 40^2) (a share beyond the clamp); "unaligned" the edges one float
    into a buffer (the scalar path)."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    m = np.float32(88.7)
    edge = np.array([-np.inf, -1e30, -100.0, np.nextafter(-m, -200), -m,
                     np.nextafter(-m, 0), -20.0, -1.0, -0.0, 0.0, 3.0,
                     50.0, np.nextafter(m, 0), m, np.nextafter(m, 200),
                     100.0, 1e30, np.inf, np.nan], np.float32)
    if kind == "random":
        x = (40.0 * rng.standard_normal(n)).astype(np.float32)
    else:
        x = np.resize(edge, n + (kind == "unaligned"))
    g = rng.uniform(-2.0, 2.0, x.size).astype(np.float32)
    v = rng.uniform(-2.0, 2.0, x.size).astype(np.float32)
    out = [torch.from_numpy(a).to(device) for a in (x, g, v)]
    if kind == "unaligned":
        out = [t[1:] for t in out]
    return out


def bit_equal(a, b) -> bool:
    """Equal bit for bit, zero signs and infinities included, NaN where the
    other is NaN (a NaN's payload depends on the instruction that made it:
    PyTorch's vectorised maximum on the CPU gives 0xffffffff)."""
    import torch

    nan = torch.isnan(a)
    if not torch.equal(nan, torch.isnan(b)):
        return False
    return torch.equal(a[~nan].view(torch.int32), b[~nan].view(torch.int32))


def trunc_exp_check(cfg, statics, params, occ, batch, device, results):
    """Row 12 of PERF.md's kernel table, `trunc_exp` (ops/activations.py,
    csrc/activations.cu): the three kernels against their plain versions
    bit for bit (`edge trunc_exp` lines: the adversarial values, N(0, 40^2)
    at a frame call's points, an unaligned tail on the scalar path;
    forward, backward and the second derivative's (d g, d x), and the
    first and second derivative through autograd against `_TruncExp`, the
    plain path, on the card); its calls and launches in one live frame
    (the serve renderer, 800x800), one bench FoMAML step and one MAML step
    (a counting wrapper on models.ngp's name; `_TruncExp` replaced by one
    that raises on a CUDA tensor: nothing may reach the plain path there);
    device times (20 calls queued while the card sleeps) of each kernel
    and its plain version at a frame call's points and at a bench step's,
    beside the byte bound: the forward reads x and writes y, the backward
    reads g and y and writes gx, the second derivative reads v, g, x and
    writes d g and d x. The backward's library call is `g * y` (one
    PyTorch call, the plain version itself); the forward and the second
    derivative have none. The kernels line takes each kernel at the size
    the main path launches it at: the forward at a frame call's points,
    the backward and the second derivative (launched only in steps) at a
    bench step's."""
    import torch

    from nerfsys_tpu_torch import kernels
    from nerfsys_tpu_torch.models import ngp
    from nerfsys_tpu_torch.models.container import param_group_labels
    from nerfsys_tpu_torch.ops import activations as TA
    from nerfsys_tpu_torch.pipelines.offline.meta_train_step import (
        make_train_step,
    )
    from nerfsys_tpu_torch.pipelines.online.runtime_adapt import (
        default_chunk_rays,
        make_chunk_renderer,
        render_image,
    )
    from nerfsys_tpu_torch.utils.optim import OptimConfig, build_optimizer

    calls = []

    def count(fn):
        def wrapped(x):
            if x.numel():  # an empty call launches nothing
                calls.append((x.numel(), x.requires_grad))
            return fn(x)
        return wrapped

    plain = TA._TruncExp

    class NoPlainOnCard(plain):
        @staticmethod
        def forward(ctx, x):
            if x.is_cuda:
                raise SystemExit("row 12: the plain _TruncExp ran on a CUDA "
                                 "tensor")
            return plain.forward(ctx, x)

    def counted(run):
        calls.clear()
        kernels.reset_launches()
        with patched(ngp, "trunc_exp", count), patched(
                TA, "_TruncExp", lambda _: NoPlainOnCard):
            run()
        torch.cuda.synchronize()
        got = kernels.launches()
        return list(calls), {k: got[k] for k in TRUNC_EXP_KERNELS}

    renderer = make_chunk_renderer(cfg, ray_samples=32, occ_state=occ,
                                   occ_importance=True, occ_hard_mask=False,
                                   device=device)
    frame, frame_l = counted(lambda: render_image(
        renderer, params, statics, pose(SERVE_POSES[0]),
        scene_aabb=statics.global_aabb.cpu().numpy(),
        chunk_rays=CHUNK or default_chunk_rays(32)))
    opt = build_optimizer(OptimConfig(outer_steps=10000),
                          param_group_labels(params))
    steps = {}
    for name, meta in (("bench step", train_meta()),
                       ("MAML step", maml_meta())):
        step = make_train_step(meta, cfg, opt)
        gen = torch.Generator(device=device).manual_seed(1)
        steps[name] = counted(lambda: float(step(
            params, opt.init(params), statics, batch, gen, occ)[2][
                "loss_out"]))
    if not (frame_l["trunc_exp_fwd"] == len(frame) > 0
            and all(l["trunc_exp_fwd"] == len(c) > 0
                    and l["trunc_exp_bwd"] > 0 for c, l in steps.values())
            and steps["MAML step"][1]["trunc_exp_bwd2"] > 0
            and steps["bench step"][1]["trunc_exp_bwd2"] == 0):
        seen = {k: (len(c), l) for k, (c, l) in steps.items()}
        raise SystemExit(f"row 12: launches do not match the calls: frame "
                         f"{len(frame)} calls {frame_l}, steps {seen}")
    text = [f"a live frame {len(frame)} calls ({sum(c[0] for c in frame)} "
            f"points) launches {frame_l}"] + [
        f"a {k} {len(c)} calls ({sum(n for n, _ in c)} points, "
        f"{sum(r for _, r in c)} needing a gradient) launches {l}"
        for k, (c, l) in steps.items()]
    print("row 12 trunc_exp: " + "; ".join(text), flush=True)

    n_frame = max(c[0] for c in frame)
    errs = {k: 0.0 for k in TRUNC_EXP_KERNELS}
    sizes = [("edges", 19 * 4096 + 3, 1), ("random", n_frame, 2),
             ("unaligned", 4099, 3), ("unaligned", 8 * 16_000 + 3, 4),
             ("unaligned", 8 * 1_048_576 + 3, 4)]
    sizes += [("edges", 8 * k + r, 5 + r) for k in (0, 16_000, 1_048_576)
              for r in range(1, 8)]  # both launch paths' tails
    for kind, n, seed in sizes:
        x, g, v = trunc_exp_inputs(kind, n, device, seed)
        y = TA.trunc_exp_fwd_kernel(x)
        gx = TA.trunc_exp_bwd_kernel(g, y)
        dg, dx = TA.trunc_exp_bwd2_kernel(v, g, x)
        want_y = TA.trunc_exp_fwd_plain(x)
        want_dg, want_dx = TA.trunc_exp_bwd2_plain(v, g, x)
        same = {"fwd": bit_equal(y, want_y),
                "bwd": bit_equal(gx, TA.trunc_exp_bwd_plain(g, want_y)),
                "bwd2 dg": bit_equal(dg, want_dg),
                "bwd2 dx": bit_equal(dx, want_dx)}
        # the same through autograd: trunc_exp (the kernels) against
        # _TruncExp (the plain path) on the card
        sides = []
        for fn in (TA.trunc_exp, TA._TruncExp.apply):
            xr = x.clone().requires_grad_(True)
            gr = g.clone().requires_grad_(True)
            first, = torch.autograd.grad(fn(xr), xr, gr, create_graph=True)
            second = torch.autograd.grad(first, (xr, gr), v)
            sides.append((first.detach(), *second))
        same.update({f"autograd {k}": bit_equal(a, b) for k, a, b in zip(
            ("gx", "d x", "d g"), *sides)})
        for k, a, b in (("trunc_exp_fwd", y, want_y),
                        ("trunc_exp_bwd2", dx, want_dx)):
            ok = torch.isfinite(b)
            if bool(ok.any()):
                errs[k] = max(errs[k], max_err(a[ok], b[ok]))
        print(f"edge trunc_exp {kind}: n={x.numel()} bit_equal "
              + " ".join(f"{k}={s}" for k, s in same.items())
              + f" (y inf {int(torch.isinf(want_y).sum())}, nan "
              f"{int(torch.isnan(want_y).sum())}, subnormal "
              f"{int(((want_y > 0) & (want_y < 1.1754944e-38)).sum())}; "
              f"d x nan {int(torch.isnan(want_dx).sum())})", flush=True)
        if not all(same.values()):
            raise SystemExit(f"row 12: a kernel differs from its plain "
                             f"version on {kind}: {same}")

    gen = torch.Generator(device=device).manual_seed(4)
    times, library = {}, {}
    for label, n in (("frame call", n_frame), ("bench step call",
                                                TRUNC_EXP_STEP)):
        x = 4.0 * torch.randn(n, device=device, generator=gen)
        g = torch.randn(n, device=device, generator=gen)
        v = torch.randn(n, device=device, generator=gen)
        y = TA.trunc_exp_fwd_kernel(x)
        times[label] = {
            "trunc_exp_fwd": (
                device_ms(lambda: TA.trunc_exp_fwd_kernel(x)),
                device_ms(lambda: TA.trunc_exp_fwd_plain(x)), 8 * n),
            "trunc_exp_bwd": (
                device_ms(lambda: TA.trunc_exp_bwd_kernel(g, y)),
                device_ms(lambda: TA.trunc_exp_bwd_plain(g, y)), 12 * n),
            "trunc_exp_bwd2": (
                device_ms(lambda: TA.trunc_exp_bwd2_kernel(v, g, x)),
                device_ms(lambda: TA.trunc_exp_bwd2_plain(v, g, x)),
                20 * n)}
        library[label] = device_ms(lambda: torch.mul(g, y))
    for k in TRUNC_EXP_KERNELS:
        parts = []
        for label, n in (("frame call", n_frame),
                         ("bench step call", TRUNC_EXP_STEP)):
            ms, plain, n_bytes = times[label][k]
            b_ms, b_by = bound(n_bytes, 0)
            lib = (f"library_ms={library[label]:.4f} (g * y) "
                   if k == "trunc_exp_bwd" else "")
            parts.append(f"{label} ({n} points) device_ms={ms:.4f} "
                         f"plain_ms={plain:.4f} {lib}bytes={n_bytes} "
                         f"bound_ms={b_ms:.4f} ({b_by}, "
                         f"{ms / b_ms:.2f}x)")
        # the kernels line: the size the main path launches the kernel at
        # (the forward a frame's calls; the backward and the second
        # derivative only in steps)
        size = "frame call" if k == "trunc_exp_fwd" else "bench step call"
        ms, plain, n_bytes = times[size][k]
        b_ms, b_by = bound(n_bytes, 0)
        lib_ms = library[size] if k == "trunc_exp_bwd" else None
        results[k] = dict(
            max_abs_err=errs[k], ms=ms, plain_ms=plain, bound_ms=b_ms,
            bound_by=b_by, library_ms=lib_ms,
            text=f"(a {size}'s points) bit-equal to the plain version "
            f"on every edge line (max_abs_err over finite values); "
            + "; ".join(parts) + "; kernel_ms, plain_ms and library_ms are "
            "device times; "
            + ("library_ms: g * y, one PyTorch call" if lib_ms is not None
               else "library_ms null: no single PyTorch call (the forward's "
               "clamp and exp are two, the second derivative's products "
               "and the clip's slope more)"))
        print(f"kernel {k}: " + "; ".join(parts), flush=True)


AMP_SERVE_KERNELS = ("plane_encode_fwd_lines_bf16", "occupancy_probe_cdf",
                     "sample_tvals_from_cdf", "volume_render_fwd",
                     "trunc_exp_fwd")
AMP_TRAIN_KERNELS = AMP_SERVE_KERNELS + ("volume_render_bwd",
                                         "plane_encode_bwd_light_lines_bf16",
                                         "trunc_exp_bwd")
AMP_IDLE = ("plane_encode_fwd", "plane_encode_bwd_light")  # their fp32 kin
AMP_FLAGS = ("--use_amp", "--plane_lines_mm", "--plane_lines_mm_dtype",
             "bfloat16")
AMP_STEPS = 4  # the runner's --op train steps with the precision options
AMP_FRAME_TOL = 0.05  # mean |amp - fp32| of a frame's rgb and acc


def amp_cfg(cfg):
    """The precision options: bfloat16 MLPs (--use_amp) and bfloat16 line
    matmuls (--plane_lines_mm --plane_lines_mm_dtype bfloat16)."""
    import dataclasses

    return dataclasses.replace(cfg, expert=dataclasses.replace(
        cfg.expert, use_bf16=True, planes=dataclasses.replace(
            cfg.expert.planes, lines_matmul=True,
            lines_mm_dtype="bfloat16")))


def amp_kernels(cfg, statics, params, occ, rays_np, batch, device, results):
    """Kernels 1b and 5b (the bfloat16 line matmuls) against their plain
    versions: 1b bit-equal at a serve chunk (K=4, 2,097,152 points an
    expert) and at a step (128,000 points), 5b within kernel 5's 1e-4 of
    each table's max at the step and at the serve chunk (K=4 stacked);
    both also on coordinates on and outside the bounds and with F=2 (the
    scalar variant) at the step. 5b must differ from kernel 5 (the float32
    lines' residuals) by more than twice its tolerance."""
    import dataclasses

    import torch

    from nerfsys_tpu_torch import kernels
    from nerfsys_tpu_torch.models.ngp import world_to_unit
    from nerfsys_tpu_torch.models.occupancy import _ray_validity
    from nerfsys_tpu_torch.ops import occupancy as O
    from nerfsys_tpu_torch.ops import planes as PL
    from nerfsys_tpu_torch.ops import volrend as V
    from nerfsys_tpu_torch.utils.device import num_sms

    pc = amp_cfg(cfg).expert.planes
    pc32 = cfg.expert.planes
    enc_k = params["experts"]["planes_enc"]
    enc = {k: [t[0] for t in v] for k, v in enc_k.items()}
    gen = torch.Generator(device=device).manual_seed(11)

    # the serve chunk's sample points (kernel 1's check inputs), K=4
    rays = torch.from_numpy(rays_np).to(device)
    o, d = rays[:, 0:3].contiguous(), rays[:, 3:6].contiguous()
    _, near, far = _ray_validity(rays)
    cdf = O.occupancy_probe_cdf(occ["occs"], occ["binary"],
                                statics.expert_aabbs, o, d, near, far, 128,
                                importance=True, uniform_frac=0.25,
                                ray_floor=0.25)
    t_vals, _ = O.sample_tvals_from_cdf(cdf, near, far, 32)
    x_serve = world_to_unit(V.t_to_points(o, d, t_vals).reshape(-1, 3),
                            statics.expert_aabbs, cfg.expert.enc_eps)
    del cdf, t_vals
    # a step's: expert 0's first support set, its K=1 probe, randomized
    srays = batch["support_rays"][0, 0]
    so, sd = srays[:, 0:3].contiguous(), srays[:, 3:6].contiguous()
    sn, sf = srays[:, 6].contiguous(), srays[:, 7].contiguous()
    scdf = O.occupancy_probe_cdf(occ["occs"][0:1], occ["binary"][0:1],
                                 statics.expert_aabbs[0:1], so, sd, sn, sf,
                                 128, importance=True, ray_floor=0.25)
    st, _ = O.sample_tvals_from_cdf(scdf, sn, sf, 32, generator=gen,
                                    randomized=True)
    x_step = world_to_unit(V.t_to_points(so, sd, st).reshape(-1, 3),
                           statics.expert_aabbs[0],
                           cfg.expert.enc_eps).contiguous()
    P = x_step.shape[0]
    f2 = dataclasses.replace(pc, features=2)
    enc_f2 = edge_tables(f2, 0, device)
    x_bounds = edge_points("bounds", 1, P, device)[0]

    def fwd_line(label, tab, x, c):
        got = PL.plane_encode_kernel(tab, x, c)
        want = PL.plane_encode_plain(tab, x, c)
        f32 = PL.plane_encode_plain(tab, x, dataclasses.replace(
            c, lines_mm_dtype="float32"))
        err = max_err(got, want)
        moved = float((want != f32).float().mean())
        ms = cuda_ms(lambda: PL.plane_encode_kernel(tab, x, c), 10)
        plan = PL.plane_fwd_plan(x.shape[-2], c.level_resolutions(),
                                 c.features)
        K = x.shape[0] if x.dim() == 3 else 1
        print(f"edge plane_encode_fwd_lines_bf16 {label}: K={K} "
              f"N={x.shape[-2]} max_abs_err={err:.3e} tol=0 "
              f"kernel_ms={ms:.4f} (share of values the bfloat16 lines "
              f"move from the float32 lines' {moved:.4f}) plan "
              f"{plan_text(plan)}", flush=True)
        if not err <= 0.0 or not moved > 0.1:
            raise SystemExit(f"kernel plane_encode_fwd_lines_bf16 on "
                             f"{label}: error {err}, moved {moved}")
        return got, want, ms

    got, want, ms = fwd_line("serve chunk", enc_k, x_serve, pc)
    n_out = got.numel()
    b_ms, b_by = bound(nbytes(x_serve, enc_k["planes"], enc_k["lines"], got),
                       n_out * 15 + (n_out // pc.features) * 24)
    plain_ms = cuda_ms(lambda: PL.plane_encode_plain(enc_k, x_serve, pc), 3)
    dev = device_ms(lambda: PL.plane_encode_kernel(enc_k, x_serve, pc))
    results["plane_encode_fwd_lines_bf16"] = dict(
        max_abs_err=max_err(got, want), ms=ms, plain_ms=plain_ms,
        bound_ms=b_ms, bound_by=b_by, text=(
            f"max_abs_err={max_err(got, want):.3e} tol=0 (bit-equal: "
            f"products of bfloat16 values are exact, one rounding in the "
            f"sum, --fmad=false) kernel_ms={ms:.4f} device_ms={dev:.4f} "
            f"plain_ms={plain_ms:.4f} bytes="
            f"{nbytes(x_serve, enc_k['planes'], enc_k['lines'], got)} "
            f"(kernel 1's count) bound_ms={b_ms:.4f} ({b_by}) at "
            f"{HBM_BYTES_PER_S / 1e12:g} TB/s; kernel 1 on the same points "
            f"{cuda_ms(lambda: PL.plane_encode_kernel(enc_k, x_serve, pc32), 10):.4f}"
            f" ms in this call"))
    del got, want
    fwd_line("step", enc, x_step, pc)
    fwd_line("bounds (step)", enc, x_bounds, pc)
    fwd_line("F=2 scalar (step)", enc_f2, x_step, f2)

    def bwd_line(label, tab, x, c):
        ct = torch.randn((*x.shape[:-1], c.out_dim), device=device,
                         generator=gen)
        got = PL.plane_encode_bwd_kernel(tab, x, ct, c)
        want = PL.plane_encode_bwd_plain(tab, x, ct, c)
        f32 = PL.plane_encode_bwd_plain(tab, x, ct, dataclasses.replace(
            c, lines_mm_dtype="float32"))
        errs = [rel_err(a, b) for a, b in zip(got[0] + got[1],
                                              want[0] + want[1])]
        gap = max(rel_err(a, b) for a, b in zip(want[0], f32[0]))
        ms = cuda_ms(lambda: PL.plane_encode_bwd_kernel(tab, x, ct, c), 10)
        K = x.shape[0] if x.dim() == 3 else 1
        plan = PL.plane_bwd_plan(x.shape[-2], K, c.level_resolutions(),
                                 c.features, True, num_sms(device))
        print(f"edge plane_encode_bwd_light_lines_bf16 {label}: K={K} "
              f"N={x.shape[-2]} table_err/max={max(errs):.3e} tol=0.0001 "
              f"(the float32 lines' plane tables differ by {gap:.3e}) "
              f"kernel_ms={ms:.4f} plan {plan_text(plan)}", flush=True)
        if not max(errs) <= 1e-4 or not gap > 2e-4:
            raise SystemExit(f"kernel plane_encode_bwd_light_lines_bf16 on "
                             f"{label}: errors {errs}, gap {gap}")
        return ct, got, want, ms

    ct, got, want, ms = bwd_line("step", enc, x_step, pc)
    tables = list(enc["planes"]) + list(enc["lines"])
    n_bytes = nbytes(x_step, ct, tables, got[0], got[1])
    b_ms, b_by = bound(n_bytes, P * 9 * pc.features * 24
                       + sum(t.numel() for t in got[0] + got[1]))
    errs = [rel_err(a, b) for a, b in zip(got[0] + got[1], want[0] + want[1])]
    abs_err = max(max_err(a, b) for a, b in zip(got[0] + got[1],
                                                want[0] + want[1]))
    plain_ms = cuda_ms(lambda: PL.plane_encode_bwd_plain(enc, x_step, ct, pc),
                       3)
    dev = device_ms(lambda: PL.plane_encode_bwd_kernel(enc, x_step, ct, pc))
    k5 = device_ms(lambda: PL.plane_encode_bwd_kernel(enc, x_step, ct, pc32))
    results["plane_encode_bwd_light_lines_bf16"] = dict(
        max_abs_err=abs_err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
        bound_by=b_by, text=(
            f"table_err/max={max(errs):.3e} tol=0.0001 max_abs_err="
            f"{abs_err:.3e} (relative to each table's max: kernel 5's "
            f"tolerance; the line values recomputed from bfloat16 operands "
            f"round alike, fp32 atomics add in another order) kernel_ms="
            f"{ms:.4f} device_ms={dev:.4f} plain_ms={plain_ms:.4f} bytes="
            f"{n_bytes} (kernel 5's count) bound_ms={b_ms:.4f} ({b_by}) at "
            f"{HBM_BYTES_PER_S / 1e12:g} TB/s; kernel 5 on the same inputs "
            f"device_ms={k5:.4f} in this call"))
    del ct, got, want
    bwd_line("bounds (step)", enc, x_bounds, pc)
    bwd_line("F=2 scalar (step)", enc_f2, x_step, f2)
    bwd_line("serve chunk (K=4 stacked)", enc_k, x_serve, pc)
    del x_serve
    torch.cuda.empty_cache()


def amp_phase(cfg, statics, params, occ, rays_np, batch, device, results):
    """Phase: the precision options (--use_amp: bfloat16 MLPs; bfloat16
    line matmuls) at bench width. Kernels 1b and 5b against their plain
    versions (`amp_kernels`); 3 live 800x800 frames through render_image
    (`serve`: kernel 1b launched, kernel 1 not; one chunk against the
    plain path; ms, device busy, idle share and the MLP GEMMs' ms from
    the profile), the frame against the float32 frame of the same pose;
    bench.py's FoMAML step with both options (`train`: kernels 1b and 5b
    launched, 1 and 5 not; its gradients against the plain path's) ->
    the launches of the frames and of the steps."""
    import numpy as np
    import torch

    from nerfsys_tpu_torch.pipelines.online.runtime_adapt import (
        default_chunk_rays,
        make_chunk_renderer,
        render_image,
    )

    t_phase = time.perf_counter()
    amp_kernels(cfg, statics, params, occ, rays_np, batch, device, results)
    acfg = amp_cfg(cfg)
    served = serve(acfg, statics, params, occ, device, label="amp serve",
                   need=AMP_SERVE_KERNELS, idle=AMP_IDLE)
    aabb = statics.global_aabb.cpu().numpy()
    md = pose(SERVE_POSES[0])
    frames = []
    for c in (acfg, cfg):
        ren = make_chunk_renderer(c, ray_samples=32, occ_state=occ,
                                  occ_importance=True, occ_hard_mask=False,
                                  device=device)
        frames.append(render_image(ren, params, statics, md,
                                   scene_aabb=aabb,
                                   chunk_rays=CHUNK or default_chunk_rays(32)))
    diffs = [np.abs(a.astype(np.float64) - b) for a, b in zip(*frames)]
    print(f"amp serve: the frame against the float32 frame of the same "
          f"pose: mean / max |diff| rgb {diffs[0].mean():.3e} / "
          f"{diffs[0].max():.3e}, depth {diffs[1].mean():.3e} / "
          f"{diffs[1].max():.3e}, acc {diffs[2].mean():.3e} / "
          f"{diffs[2].max():.3e} (tol: mean rgb and acc {AMP_FRAME_TOL}, "
          f"the same scene; bfloat16 MLPs and lines round apart)", flush=True)
    if not (diffs[0].mean() <= AMP_FRAME_TOL
            and diffs[2].mean() <= AMP_FRAME_TOL and diffs[0].max() > 0):
        raise SystemExit("amp serve: the frame is not the float32 frame's "
                         "scene")
    del frames, diffs
    light, _, _ = train(acfg, statics, params, occ, batch, device,
                        label="amp train", extra=None,
                        need=AMP_TRAIN_KERNELS, timed=2)
    launched = [k for k in AMP_IDLE if light[k]]
    if launched:
        raise SystemExit(f"amp train: the float32 kernels {launched} "
                         f"launched")
    torch.cuda.empty_cache()
    print(f"amp: phase took {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return {k: served[k] + light[k] for k in served}


def amp_runner(base, tmp, device):
    """The trainer phase's run with the precision options: AMP_STEPS steps
    of `--op train --use_amp --plane_lines_mm --plane_lines_mm_dtype
    bfloat16` on the written scene, then `--op eval --tto 0,1` from its
    `last` over one val camera; kernels 1b and 5b launched, 1 and 5 not
    -> the two runs' launches."""
    import torch

    ctx, probe = run_runner(base + [
        "--cap_images", str(TRAINER_CAP), *AMP_FLAGS,
        "--occ_warmup", "2", "--occ_update_interval", "2",
        "--outer_steps", str(AMP_STEPS), "--fname", str(tmp / "amp")])
    losses = loop_checks("amp run", probe, AMP_STEPS, AMP_TRAIN_KERNELS)
    e = ctx["cfg"].expert
    gaps = [1e3 * (b["t"] - a["t"])
            for a, b in zip(probe.steps, probe.steps[1:])]
    train_launches = dict(probe.launches)
    del ctx, probe
    torch.cuda.empty_cache()
    rows, eval_launches = options_eval("amp", tmp, device)
    launches = {k: v + eval_launches[k] for k, v in train_launches.items()}
    print(f"trainer: amp run ({' '.join(AMP_FLAGS)}) {AMP_STEPS} steps, "
          f"loss_out {losses}; median step ms (host clock, start to start) "
          f"{median(gaps):.2f}; use_bf16 {e.use_bf16} lines_bf16 "
          f"{e.planes.lines_bf16}; eval --tto 0,1 (tto, psnr, ssim) {rows}; "
          f"launches: train {train_launches}, eval {eval_launches}",
          flush=True)
    if not (e.use_bf16 and e.planes.lines_bf16):
        raise SystemExit("trainer: amp run: options not carried")
    launched = [k for k in AMP_IDLE if launches[k]]
    if launched:
        raise SystemExit(f"trainer: amp run: the float32 kernels {launched} "
                         f"launched")
    return launches


def options_eval(name, tmp, device):
    """`--op eval --tto 0,1` over one val camera from the `last` of the
    precision-options run `tmp / name`, the options carried -> ((tto, psnr,
    ssim) rows, its launches); kernels 1b and 5b launched."""
    import math

    import torch

    from nerfsys_tpu_torch import kernels, runner

    kernels.reset_launches()
    ev = runner.main([
        "--op", "eval", "--configPath",
        str(Path(__file__).resolve().parent / "configs" / "eval.json"),
        "--data_path", str(tmp), "--data_dirname", "scene",
        "--mask_dirname", "g22", "--downscale", "1.0",
        "--checkpoint_path", str(tmp / name), "--prefix", "last",
        "--tto", "0,1", "--cap_images", "1", *AMP_FLAGS,
        "--device", str(device), "--fname", str(tmp / f"{name}_eval"),
        *REHEARSAL_EXTRA])
    launches = kernels.launches()
    rows = [(r["tto"], r["psnr"], r["ssim"]) for r in ev["rows"]]
    ee = ev["cfg"].expert
    if not (ee.use_bf16 and ee.planes.lines_bf16) or [
            r[0] for r in rows] != [0, 1] or not all(
                math.isfinite(r[1]) for r in rows):
        raise SystemExit(f"trainer: {name} eval: options not carried or "
                         f"rows not finite: {rows}")
    for k in ("plane_encode_fwd_lines_bf16",
              "plane_encode_bwd_light_lines_bf16"):
        if not launches[k]:
            raise SystemExit(f"trainer: {name} eval: kernel {k} never "
                             f"launched")
    del ev
    torch.cuda.empty_cache()
    return rows, launches


OCC_RING = 8  # training cameras of the premark
OCC_LIGHT_KERNELS = ("plane_encode_fwd", "occupancy_probe_cdf",
                     "sample_tvals_from_cdf", "volume_render_fwd",
                     "volume_render_bwd", "plane_encode_bwd_light")


def ring_cameras(n: int, device):
    """n bench cameras (800x800, focal 0.8 W, serve()'s intrinsics) on a
    ring of radius 4 around the bench scene at height 2, each looking at
    the origin (RUB: the camera's -z axis points at it) -> c2ws (n, 3, 4),
    intrinsics (n, 4), wh (n, 2) on `device`."""
    import numpy as np
    import torch

    c2ws = []
    for a in np.linspace(0.0, 2.0 * np.pi, n, endpoint=False):
        eye = np.array([4.0 * np.cos(a), 4.0 * np.sin(a), 2.0])
        fwd = -eye / np.linalg.norm(eye)
        right = np.cross(fwd, [0.0, 0.0, 1.0])
        right /= np.linalg.norm(right)
        c2ws.append(np.stack([right, np.cross(right, fwd), -fwd, eye], 1))
    md = pose((0.0, 0.0, 0.0))
    intr = np.tile(md.intrinsics, (n, 1))
    wh = np.tile([float(md.W), float(md.H)], (n, 1))
    return tuple(torch.tensor(np.asarray(a), dtype=torch.float32,
                              device=device) for a in (c2ws, intr, wh))


def updates_match(label, got, want):
    """An occupancy update through the kernels against the same update
    (same draws) through the plain versions: occs within 1e-6 of their
    max; binary flips (cells within the field's rounding of the
    threshold) listed, at most 1e-6 of the cells (33 at K=4 R=128 L=4).
    Read on the H100 80GB HBM3 at 700 W: err/max 4.7e-10, 3 and 1 cells
    flipped."""
    err = rel_err(got["occs"], want["occs"])
    flips = int((got["binary"] != want["binary"]).sum())
    share = flips / got["binary"].numel()
    print(f"occupancy: {label} through kernels vs plain (the same draws): "
          f"occs err/max {err:.3e} (tol 1e-6) binary flips {flips} (share "
          f"{share:.3e}, at most 1e-6: cells at the threshold)", flush=True)
    if not err <= 1e-6 or share > 1e-6:
        raise SystemExit(f"occupancy: {label} disagrees with the plain path")


def occupancy(cfg, statics, params, occ, batch, device):
    """Phase: the occupancy grid's lifecycle and hard-mask training at
    bench width. The counters are zeroed just before and read just after
    the kernel path's work (the plain references launch nothing): premark
    K=4 fresh grids (R=128, L=4, the reference's OccGridConfig defaults)
    from a ring of 8 bench cameras; one warmup update (every cell) and
    one subset update after warmup (every second cell), each timed to a
    synchronize and held against `make_occ_update_fn(...,
    use_kernels=False)` with the same draws; then one hard-mask FoMAML
    bench step (`occ_hard_mask=True`, ray_floor 0) on the bench grids,
    its gradients held against `make_train_step(..., use_kernels=False)`
    within 2^-8 of each leaf's max, and one step profiled with the device
    time of the hard mask's point queries (`occupancy_query` in
    `render_rays_occ_field`, kernel 11q, one a render; a profiler range
    around each call) beside the step's device busy time; then the same
    with occ_probe_mask (the probe bits: 11q must not launch)."""
    import dataclasses

    import torch

    from nerfsys_tpu_torch import kernels
    from nerfsys_tpu_torch.models import occupancy as MO
    from nerfsys_tpu_torch.models.container import param_group_labels
    from nerfsys_tpu_torch.ops import occupancy as O
    from nerfsys_tpu_torch.ops.occupancy import OccGridConfig, init_occ_state
    from nerfsys_tpu_torch.pipelines.offline.meta_train_step import (
        make_train_step,
    )
    from nerfsys_tpu_torch.utils.optim import OptimConfig, build_optimizer

    t_phase = time.perf_counter()
    ocfg = OccGridConfig()
    K = statics.centroids.shape[0]
    cams = ring_cameras(OCC_RING, device)
    upd = MO.make_occ_update_fn(cfg, ocfg)
    plain = MO.make_occ_update_fn(cfg, ocfg, use_kernels=False)

    def gen(seed):
        return torch.Generator(device=device).manual_seed(seed)

    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    state = MO.premark_invisible_expert_cells(
        init_occ_state(ocfg, K, device=device), statics, ocfg, *cams)
    torch.cuda.synchronize()
    premark_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    warm = upd(state, params, statics, 0, gen(21))
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    sub = upd(warm, params, statics, ocfg.warmup_steps, gen(22))
    torch.cuda.synchronize()
    sub_s = time.perf_counter() - t0
    upd_launches = kernels.launches()
    if upd_launches["plane_encode_fwd"] <= 0:
        raise SystemExit("occupancy: the update never launched kernel 1")
    n_cells = state["occs"].numel()
    print(f"occupancy: premark of K={K} grids (R={ocfg.resolution} "
          f"L={ocfg.levels}, {n_cells} cells) from {OCC_RING} cameras "
          f"{premark_s:.3f} s, invisible share "
          f"{float((state['occs'] < 0).float().mean()):.4f}; warmup update "
          f"({n_cells} field evaluations) {warm_s:.3f} s, occupied share "
          f"{float(warm['binary'].float().mean()):.4f}; subset update "
          f"(every second cell) {sub_s:.3f} s, occupied share "
          f"{float(sub['binary'].float().mean()):.4f}; num_updates "
          f"{int(sub['num_updates'])}; launches {upd_launches}", flush=True)
    updates_match("warmup update", warm, plain(state, params, statics, 0,
                                               gen(21)))
    updates_match("subset update", sub, plain(warm, params, statics,
                                              ocfg.warmup_steps, gen(22)))
    del state, warm, sub
    torch.cuda.empty_cache()

    opt = build_optimizer(OptimConfig(outer_steps=10000),
                          param_group_labels(params))
    st = opt.init(params)
    n_renders = TRAIN_K * TRAIN_B * (TRAIN_INNER + 1)
    total = dict(upd_launches)
    forms = []
    for probe_mask in (False, True):
        meta = dataclasses.replace(train_meta(), occ_hard_mask=True,
                                   occ_probe_mask=probe_mask)
        form = "probe-bit" if probe_mask else "point-exact"
        step = make_train_step(meta, cfg, opt)
        g = gen(23)
        float(step(params, st, statics, batch, g, occ)[2]["loss_out"])
        torch.cuda.synchronize()  # the warm-up ends
        kernels.reset_launches()
        t0 = time.perf_counter()
        _, _, aux = step(params, st, statics, batch, g, occ)
        loss = float(aux["loss_out"])
        step_ms = 1e3 * (time.perf_counter() - t0)
        step_launches = kernels.launches()
        if loss != loss or float(aux["skipped_nonfinite"]):
            raise SystemExit(f"occupancy: {form} hard-mask step not finite")
        need = OCC_LIGHT_KERNELS + (() if probe_mask else
                                    ("occupancy_query",))
        for k in need:
            if step_launches[k] <= 0:
                raise SystemExit(f"occupancy: {form} hard-mask step never "
                                 f"launched {k}")
        if probe_mask and step_launches["occupancy_query"]:
            raise SystemExit("occupancy: the probe-bit step queried the "
                             "grid at its samples")
        for k, v in step_launches.items():
            total[k] += v
        print(f"occupancy: {form} hard-mask FoMAML step (K={TRAIN_K} "
              f"B={TRAIN_B} S={TRAIN_S} Q={TRAIN_Q} inner={TRAIN_INNER}, "
              f"ray_floor 0, occ_probe_mask={probe_mask}) ms={step_ms:.2f} "
              f"loss_out={loss:.6f} launches {step_launches}", flush=True)
        grads_through_plain_match(meta, cfg, opt, statics, params, occ,
                                  batch, device,
                                  f"occupancy {form} hard-mask step")
        query = {"hard_mask_point_query": None}
        label = f"occupancy {form} hard-mask step"
        with named_range(O, "occupancy_query", "hard_mask_point_query"):
            busy = profile_device(label, lambda: float(
                step(params, st, statics, batch, g, occ)[2]["loss_out"]),
                watch=(("occupancy_query_kernel",),
                       ("volume_render_bwd_kernel",),
                       ("sample_tvals_kernel",)), ranges=query)
        # the calls from the range; the device ms from 11q's own rows (a
        # range does not collect kernels launched through ctypes)
        calls = query["hard_mask_point_query"][0]
        q_ms = WATCHED.get((label, ("occupancy_query_kernel",)), (0, 0.0))[1]
        if calls < (0 if probe_mask else n_renders):
            raise SystemExit(f"occupancy: {calls} point queries in the "
                             f"profiled step, at least {n_renders} expected "
                             f"(a render)")
        forms.append((form, step_ms, busy, calls, q_ms))
    print("occupancy: the hard mask's point queries (occupancy_query, "
          "kernel 11q; calls by a profiler range, device ms from 11q's "
          "rows) in the profiled steps: " + "; ".join(
              f"{form}: {calls} calls, device ms {q_ms:.3f}, share "
              f"{q_ms / busy if busy else float('nan'):.4f} of the step's "
              f"device busy {busy:.2f} ms (step wall {ms:.2f} ms)"
              for form, ms, busy, calls, q_ms in forms)
          + "; an earlier run's plain query_binary (chip run 5, PR 14, "
          "H100 80GB HBM3, 700 W): 108 calls, 13.92 ms, share 0.056 of "
          f"247.55 ms; phase took {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return total


MAML_NEW = ("volume_render_bwd2", "plane_encode_bwd2_light",
            "plane_encode_bwd2", "trunc_exp_bwd2",
            "plane_encode_bwd2_light_lines_bf16")  # 4'', 5'', 6'', 12'', 5''b
MAML_F32 = MAML_NEW[:4]  # those a float32 MAML step launches
# the MAML step under both precision options: 1b, 5b, 5''b, 4, 4', 4'' and
# row 12's three (and kernels 2, 3)
AMP_MAML_KERNELS = AMP_TRAIN_KERNELS + (
    "volume_render_bwd2", "plane_encode_bwd2_light_lines_bf16",
    "trunc_exp_bwd2")
AMP_MAML_IDLE = AMP_IDLE + ("plane_encode_bwd2_light",)  # float32 kin
MAML_WATCHED = ("volume_render_fwd", "volume_render_bwd",
                "volume_render_bwd2", "plane_encode_fwd",
                "plane_encode_bwd_light", "plane_encode_bwd2_light",
                "plane_encode_bwd", "plane_encode_bwd2", "hash_encode_fwd",
                "hash_encode_bwd", "plane_encode_fwd_lines_bf16",
                "plane_encode_bwd_light_lines_bf16",
                "plane_encode_bwd2_light_lines_bf16")
BWD2_TOL = 1e-5  # 4'', 5'' and 6'' against their plain versions (the
# tables of 5'' and 6'' against the plain shares summed in float64)
HASH_BWD2_TOL = 1e-6  # 7c'' (kernel 7a on the cotangent)


def maml_meta():
    """bench.py's meta configuration with algo="maml" (second order)."""
    import dataclasses

    return dataclasses.replace(train_meta(), algo="maml")


def wdot_scale(rs, t, v_rs, scale) -> float:
    """max over rays of sum_s |w'_s|, the weights' JVP in the direction
    v_rs (the plain 4'''s d g_weights): the scale of acc' = sum w', which
    cancels to rounding noise on opaque rays, and so of d acc and of
    d bg = -G acc'."""
    import torch

    from nerfsys_tpu_torch.ops import volrend as V

    n, s = t.shape
    _, _, du = V.volume_render_bwd2_plain(
        rs, t, None, (None, None, torch.zeros((n, s), device=t.device),
                      None), v_rs, None, sigma_scale=scale)
    return float(du[2].abs().sum(1).max())


def bwd2_errs(got, want, grads, acc_scale):
    """(name, error over its scale) of 4'''s outputs: d rgb_sigma and each
    d u over their own max, d acc over `acc_scale`, d bg over max |G|
    acc_scale."""
    d_rs, d_bg, d_u = got
    out = [("rgb_sigma", rel_err(d_rs, want[0]))]
    if want[1] is not None:
        g_max = float(grads[0].abs().max()) if grads[0] is not None else 1.0
        out.append(("bg", max_err(d_bg, want[1])
                    / max(g_max * acc_scale, 1e-30)))
    for i, (a, b) in enumerate(zip(d_u, want[2])):
        if b is None:
            continue
        err = (max_err(a, b) / max(acc_scale, 1e-30) if i == 3
               else rel_err(a, b))
        out.append((("rgb", "depth", "weights", "acc")[i], err))
    return out


def check_maml_kernels(cfg, statics, params, occ, batch, device, results):
    """Phase maml, kernels: 4'', 5'' and 6'' against their plain versions
    at one inner step's shapes (expert 0's first support set: 4,000 rays x
    32 randomized samples from its probe CDF), every output within 1e-5
    of its max (the tables of 5'' and 6'' against the plain shares summed
    in float64); 4'' with the upstream of MAML's loss (rgb alone), all
    four, depth alone, sigma_scale 25 and on the edge rays of
    `volrend_edge_inputs`; 5'' and 6'' on one expert's tables and on three
    draws at the K=4 stack. Times: device, back to back, the plain
    version's, beside the byte bound."""
    import dataclasses

    import torch

    from nerfsys_tpu_torch import kernels
    from nerfsys_tpu_torch.models.container import background_color
    from nerfsys_tpu_torch.models.ngp import ngp_apply, world_to_unit
    from nerfsys_tpu_torch.ops import occupancy as O
    from nerfsys_tpu_torch.ops import planes as PL
    from nerfsys_tpu_torch.ops import volrend as V
    from nerfsys_tpu_torch.utils.tree import tree_map

    S = 32
    rays = batch["support_rays"][0, 0]
    o, d = rays[:, 0:3].contiguous(), rays[:, 3:6].contiguous()
    near, far = rays[:, 6].contiguous(), rays[:, 7].contiguous()
    N = rays.shape[0]
    grid = (occ["occs"][0:1], occ["binary"][0:1], statics.expert_aabbs[0:1])
    cdf = O.occupancy_probe_cdf(*grid, o, d, near, far, 128, importance=True,
                                ray_floor=0.25)
    gen = torch.Generator(device=device).manual_seed(11)
    t_vals, _ = O.sample_tvals_from_cdf(cdf, near, far, S, generator=gen,
                                        randomized=True)
    pts = V.t_to_points(o, d, t_vals).reshape(-1, 3)
    expert = tree_map(lambda t: t[0], params["experts"])
    aabb = statics.expert_aabbs[0]
    with torch.no_grad():
        rgb, sigma = ngp_apply(expert, cfg.expert, aabb, pts,
                               d[:, None, :].expand(N, S, 3).reshape(-1, 3))
        bg = background_color(params, cfg, d).contiguous()
    rgb_sigma = torch.cat([rgb.reshape(N, S, 3), sigma.reshape(N, S, 1)],
                          dim=-1).contiguous()

    def rnd(*shape):
        return torch.randn(shape, device=device, generator=gen)

    ups = (rnd(N, 3), 0.2 * rnd(N), rnd(N, S), rnd(N))
    v_rs, v_bg = rnd(N, S, 4), rnd(N, 3)
    cases = [("rgb only (MAML's loss)", rgb_sigma, t_vals, bg,
              (ups[0], None, None, None), 1.0),
             ("all four", rgb_sigma, t_vals, bg, ups, 1.0),
             ("depth alone", rgb_sigma, t_vals, bg,
              (None, ups[1], None, None), 1.0),
             ("sigma_scale 25", rgb_sigma, t_vals, bg, ups, 25.0)]
    for seed, kind in enumerate(("clip", "zero", "rgb01", "dtfloor")):
        rs_e, t_e, bg_e, *ups_e = volrend_edge_inputs(kind, N, S, device,
                                                      seed)
        cases.append((f"edge {kind}", rs_e, t_e, bg_e, tuple(ups_e), 1.0))
    cases = [(*c, v_rs, v_bg) for c in cases]
    # other lanes a ray and pieces of kernel 4''s plan
    for seed, s_other in enumerate((8, 24, 48, 64, 160)):
        v_other = (rnd(N, s_other, 4), rnd(N, 3))
        for kind, scale in (("rand", 1.0), ("clip", 25.0)):
            rs_e, t_e, bg_e, *ups_e = volrend_edge_inputs(
                kind, N, s_other, device, 20 + seed)
            cases.append((f"{kind} S={s_other} sigma_scale {scale:g}",
                          rs_e, t_e, bg_e, tuple(ups_e), scale, *v_other))
    head = None
    for label, rs, t, b, grads, scale, v_rs, v_bg in cases:
        got = V.volume_render_bwd2_kernel(rs, t, b, grads, v_rs, v_bg,
                                          sigma_scale=scale)
        want = V.volume_render_bwd2_plain(rs, t, b, grads, v_rs, v_bg,
                                          sigma_scale=scale)
        torch.cuda.synchronize()
        errs = bwd2_errs(got, want, grads, wdot_scale(rs, t, v_rs, scale))
        abs_err = max(max_err(a, w) for a, w in zip(
            (got[0], got[1], *got[2]), (want[0], want[1], *want[2]))
            if w is not None)
        dev_ms = device_ms(lambda: V.volume_render_bwd2_kernel(
            rs, t, b, grads, v_rs, v_bg, sigma_scale=scale), 10)
        text = (" ".join(f"{k}={e:.3e}" for k, e in errs)
                + f" tol={BWD2_TOL:g} device_ms={dev_ms:.4f}")
        print(f"edge volume_render_bwd2 {label}: N={N} S={t.shape[1]} "
              f"{text} plan "
              f"{volrend_plan_text(V.volrend_plan(*t.shape, backward=True))}",
              flush=True)
        if not all(e <= BWD2_TOL for _, e in errs) or not bool(
                torch.isfinite(got[0]).all()):
            raise SystemExit(f"kernel volume_render_bwd2 disagrees with its "
                             f"plain version on {label}: {errs}")
        if head is None:
            head = (rs, t, b, grads, v_rs, v_bg, got, abs_err, dev_ms, text)
    rs, t, b, grads, v_rs, v_bg, got, abs_err, dev_ms, text = head
    b2b = cuda_ms(lambda: V.volume_render_bwd2_kernel(
        rs, t, b, grads, v_rs, v_bg), 20)
    plain = cuda_ms(lambda: V.volume_render_bwd2_plain(
        rs, t, b, grads, v_rs, v_bg), 3)
    n_bytes = nbytes(rs, t, b, grads, v_rs, v_bg, got[0], got[1], got[2])
    b_ms, b_by = bound(n_bytes, N * S * 90)
    results["volume_render_bwd2"] = dict(
        max_abs_err=abs_err, ms=dev_ms, plain_ms=plain, bound_ms=b_ms,
        bound_by=b_by,
        text=f"(rgb upstream, MAML's loss) {text}; kernel_ms is the device "
        f"time, back to back {b2b:.4f} ms (the host's launch path); "
        f"plain_ms={plain:.4f} bytes={n_bytes} bound_ms={b_ms:.4f} "
        f"({b_by}); plan "
        f"{volrend_plan_text(V.volrend_plan(N, S, backward=True))}; tol "
        f"{BWD2_TOL:g} of each output's max (d acc and d bg: of max_rays "
        f"sum |w'| and max |G| times it), scans in a tree order")

    # 5'' and 6'': one expert's tables and three draws at the K=4 stack
    enc = expert["planes_enc"]
    x01 = world_to_unit(pts, aabb, cfg.expert.enc_eps).contiguous()
    P = x01.shape[0]
    D = cfg.expert.planes.out_dim
    stack = params["experts"]["planes_enc"]
    xk = world_to_unit(pts, statics.expert_aabbs,
                       cfg.expert.enc_eps).contiguous()

    def cot(tabs):
        return {k: [torch.randn(a.shape, device=device, generator=gen)
                    for a in v] for k, v in tabs.items()}

    sides = [("one expert", enc, x01, rnd(P, D), cot(enc))] + [
        (f"K=4 stack draw {i}", stack, xk, rnd(xk.shape[0], P, D),
         cot(stack)) for i in range(3)]
    light = {}
    pc16 = amp_cfg(cfg).expert.planes  # bfloat16 line matmuls
    for kern, pc in ((kernels.PLANES_BWD2_LIGHT, dataclasses.replace(
                          cfg.expert.planes, pos_grad=False)),
                     (kernels.PLANES_BWD2, dataclasses.replace(
                         cfg.expert.planes, pos_grad=True)),
                     (kernels.PLANES_BWD2_LIGHT_LINES_BF16,
                      dataclasses.replace(pc16, pos_grad=False))):
        pos_grad = pc.pos_grad
        for label, tabs, x, ct, v in sides:
            got = PL.plane_encode_bwd2_kernel(tabs, x, ct, v, pc)
            want = PL.plane_encode_bwd2_plain(tabs, x, ct, v, pc,
                                              sum_dtype=torch.float64)
            want32 = PL.plane_encode_bwd2_plain(tabs, x, ct, v, pc)
            torch.cuda.synchronize()
            outs = [("ct", got[0], want[0], want32[0])] + [
                (f"{key}{l}", a, w, w32) for key, i in (("plane", 1),
                                                       ("line", 2))
                for l, (a, w, w32) in enumerate(zip(got[i], want[i],
                                                    want32[i]))]
            errs = [(k, rel_err(a, w)) for k, a, w, _ in outs]
            abs_err = max(max_err(a, w) for _, a, w, _ in outs)
            gap, vs = "", []
            if pos_grad or pc.lines_bf16:  # against 5'''s plain version
                vs = [rel_err(a, w) for (_, a, _, _), w in zip(
                    outs, light[label])]
                gap = ("; light-exact" if pos_grad else "; 5''b-5''") + (
                    " gap/max " + " ".join(f"{k}={e:.3e}" for (
                        k, _, _, _), e in zip(outs, vs)))
            else:
                light[label] = [w for _, _, w, _ in outs]
            print(f"edge {kern.name} {label}: P={x.shape[-2]} "
                  + " ".join(f"{k}={e:.3e}" for k, e in errs)
                  + f" tol={BWD2_TOL:g}; against the float32 sums "
                  + " ".join(f"{k}={rel_err(a, w32):.3e}"
                             for k, a, _, w32 in outs) + gap, flush=True)
            if not all(e <= BWD2_TOL for _, e in errs):
                raise SystemExit(f"kernel {kern.name} disagrees with its "
                                 f"plain version on {label}: {errs}")
            if pos_grad and not min(vs[1:]) > 2 * BWD2_TOL:
                raise SystemExit(f"kernel {kern.name}: the light tables lie "
                                 f"within twice the tolerance of the exact "
                                 f"ones, so the check cannot tell them "
                                 f"apart")
            if pc.lines_bf16 and not max(vs) > 2 * BWD2_TOL:
                raise SystemExit(f"kernel {kern.name}: 5''b lies within "
                                 f"twice the tolerance of 5'' (the float32 "
                                 f"lines), so the check cannot tell them "
                                 f"apart")
            if label != "one expert":
                continue
            dev_ms = device_ms(lambda: PL.plane_encode_bwd2_kernel(
                tabs, x, ct, v, pc), 10)
            b2b = cuda_ms(lambda: PL.plane_encode_bwd2_kernel(
                tabs, x, ct, v, pc), 10)
            plain = cuda_ms(lambda: PL.plane_encode_bwd2_plain(
                tabs, x, ct, v, pc), 3)
            plane_rows, line_rows = plane_rows_read(x, pc)
            row_bytes = pc.features * 4
            n_bytes = (nbytes(x, ct, got[0], got[1], got[2])
                       + 2 * (plane_rows + line_rows) * row_bytes)
            b_ms, b_by = bound(n_bytes, P * 9 * pc.features * 60)
            beside = ""
            if pc.lines_bf16:  # 5''b and 5'' on the same inputs, in turns
                p32 = dataclasses.replace(pc, lines_mm_dtype="float32")
                turns = [(device_ms(lambda: PL.plane_encode_bwd2_kernel(
                    tabs, x, ct, v, pc), 10),
                          device_ms(lambda: PL.plane_encode_bwd2_kernel(
                              tabs, x, ct, v, p32), 10)) for _ in range(3)]
                beside = ("; device ms in turns (5''b, 5'') "
                          + " ".join(f"({a:.4f}, {b:.4f})" for a, b in turns)
                          + " in this call")
                print(f"kernel {kern.name}: one expert at one inner step"
                      f"{beside}", flush=True)
            results[kern.name] = dict(
                max_abs_err=abs_err, ms=dev_ms, plain_ms=plain,
                bound_ms=b_ms, bound_by=b_by,
                text=f"(one expert at one inner step) err/max d ct "
                f"{errs[0][1]:.3e}, tables "
                f"{max(e for _, e in errs[1:]):.3e} tol {BWD2_TOL:g} "
                f"(relative to each output's max, against the plain "
                f"version's shares summed in float64: the kernel's fp32 "
                f"atomics add in another order; the bf16-rounded products "
                f"are the plain version's bit for bit under --fmad=false); "
                f"kernel_ms is the device time, back to back {b2b:.4f} ms; "
                f"plain_ms={plain:.4f} (float32 sums) bytes={n_bytes} "
                f"(points, ct and d ct, the dense table gradients written "
                f"once, the distinct rows of P, L, vP and vL read: "
                f"{plane_rows} plane and {line_rows} line rows of "
                f"{row_bytes} B) bound_ms={b_ms:.4f} ({b_by}) at "
                f"{HBM_BYTES_PER_S / 1e12:g} TB/s{beside}")
        del got, want, want32, outs
    plane_bwd2_edges(cfg, params, enc, x01, xk, device)


def plane_bwd2_edges(cfg, params, enc, x01, xk, device):
    """Kernels 5'' (light), 6'' (exact) and 5''b (light, bfloat16 line
    matmuls) against their plain versions on kernel 5's adversarial inputs
    at one inner step (one expert, 128,000 points unless stated): one
    cell (every lane of a warp on the same rows), coordinates on and
    outside the bounds, a tail tile (P - 37), a single point, no lines
    (not for 5''b: without lines there is no line matmul), F=2 (the
    scalar path), the K=4 experts stacked and L=5 base 128. d ct
    bit-equal to the float32 plain version, every table within 1e-5 of
    its max against the plain shares summed in float64."""
    import dataclasses

    import torch

    from nerfsys_tpu_torch import kernels
    from nerfsys_tpu_torch.ops import planes as PL
    from nerfsys_tpu_torch.utils.device import num_sms

    P = x01.shape[0]
    gen = torch.Generator(device=device).manual_seed(15)
    sms = num_sms(x01.device)

    def rnd(*shape):
        return torch.randn(shape, device=device, generator=gen)

    def cot(tabs):
        return {k: [rnd(*a.shape) for a in v] for k, v in tabs.items()}

    for kern, exact, base in (
            (kernels.PLANES_BWD2_LIGHT.name, False, cfg.expert.planes),
            (kernels.PLANES_BWD2.name, True, cfg.expert.planes),
            (kernels.PLANES_BWD2_LIGHT_LINES_BF16.name, False,
             amp_cfg(cfg).expert.planes)):
        pc = dataclasses.replace(base, pos_grad=exact)
        no_lines = dataclasses.replace(pc, include_lines=False)
        f2 = dataclasses.replace(pc, features=2)
        l5 = dataclasses.replace(pc, levels=5)

        def plan(c, k, n):
            return PL.plane_bwd_plan(n, k, c.level_resolutions(), c.features,
                                     c.include_lines, sms, exact=exact,
                                     second=True)

        l5_tabs, f2_tabs = edge_tables(l5, 0, device), edge_tables(f2, 0,
                                                                   device)
        stack = params["experts"]["planes_enc"]
        cases = (
            ("one cell", pc, enc, edge_points("one cell", 1, P, device)[0]),
            ("bounds", pc, enc, edge_points("bounds", 1, P, device)[0]),
            ("tail P-37", pc, enc, x01[:P - 37].contiguous()),
            ("single point", pc, enc, x01[:1].contiguous()),
            ("no lines", no_lines, {"planes": enc["planes"]}, x01),
            ("F=2 scalar", f2, f2_tabs, x01),
            ("stacked K=4", pc, stack, xk),
            ("L=5 base 128", l5, l5_tabs, x01))
        for label, c, tab, x in cases:
            if pc.lines_bf16 and not c.lines_bf16:
                continue  # no lines: no line matmul, kernel 5'' serves it
            ct = rnd(*x.shape[:-1], c.out_dim)
            v = cot(tab)
            got = PL.plane_encode_bwd2_kernel(tab, x, ct, v, c)
            want = PL.plane_encode_bwd2_plain(tab, x, ct, v, c,
                                              sum_dtype=torch.float64)
            want_ct = PL.plane_encode_bwd2_plain(tab, x, ct, v, c)[0]
            torch.cuda.synchronize()
            ct_equal = bit_equal(got[0], want_ct)
            errs = [rel_err(a, b) for a, b in zip(  # 0 where both are 0
                got[1] + (got[2] or []), want[1] + (want[2] or []))]
            K = x.shape[0] if x.dim() == 3 else 1
            shown = plan(c, K, x.shape[-2])
            dev_ms = device_ms(lambda: PL.plane_encode_bwd2_kernel(
                tab, x, ct, v, c), 5)
            print(f"edge {kern} {label}: K={K} N={x.shape[-2]} d ct "
                  f"bit_equal={ct_equal} table_err/max="
                  f"{max(errs):.3e} tol={BWD2_TOL:g} "
                  f"device_ms={dev_ms:.4f} plan {plan_text(shown)}",
                  flush=True)
            if not ct_equal or not max(errs) <= BWD2_TOL:
                raise SystemExit(f"kernel {kern} disagrees with its plain "
                                 f"version on {label}: d ct bit-equal "
                                 f"{ct_equal}, tables {errs}")
            del got, want
    torch.cuda.empty_cache()


def plane_rows_read(x01, pc):
    """Distinct (plane rows, line rows) of (expert, level, orientation) an
    encode at x01 ((N, 3) or (K, N, 3)) reads: kernel 1's corners, each
    counted once (a bitmap a level)."""
    import torch

    from nerfsys_tpu_torch.ops import planes as PL

    x = torch.clamp((x01 if x01.dim() == 3 else x01[None]).float(), 0.0, 1.0)
    K = x.shape[0]
    kidx = torch.arange(K, device=x.device)[:, None]
    n_planes = n_lines = 0
    for R in pc.level_resolutions():
        coords = x * (R - 1)
        seen_p = torch.zeros(K * 3 * R * R, dtype=torch.bool,
                             device=x.device)
        seen_l = torch.zeros(K * 3 * R, dtype=torch.bool, device=x.device)

        def cell(a):
            c0 = torch.floor(torch.clamp(coords[..., a], 0.0,
                                         R - 1 - 1e-6)).long()
            return c0, torch.clamp(c0 + 1, max=R - 1)

        for o, (a, b, c) in enumerate(PL._ORIENTATIONS):
            (u0, u1), (v0, v1) = cell(a), cell(b)
            for r in (u0 * R + v0, u0 * R + v1, u1 * R + v0, u1 * R + v1):
                seen_p[((kidx * 3 + o) * R * R + r).reshape(-1)] = True
            if pc.include_lines:
                for w in cell(c):
                    seen_l[((kidx * 3 + o) * R + w).reshape(-1)] = True
        n_planes += int(seen_p.sum())
        n_lines += int(seen_l.sum())
    return n_planes, n_lines


def hash_bwd2_check(cfg, statics, params, occ, batch, device):
    """Row 7c'' on the card: the double backward of the hash encode through
    `HashEncodeBwd` (kernel 7a on the table cotangent), on the fused and
    the packed path, against the same through `use_kernels=False`, at one
    inner step's points of expert 0 (runner default widths); 7a's
    launches counted; its device time on the cotangent."""
    import torch

    from nerfsys_tpu_torch import kernels
    from nerfsys_tpu_torch.ops import encodings as E

    hc = cfg.expert.hash
    gen = torch.Generator(device=device).manual_seed(12)
    x01, _ = step_points(cfg, statics, occ, batch["support_rays"][0, 0], gen)
    table = params["experts"]["hash_table"][0].contiguous()
    dout = torch.randn((x01.shape[0], hc.out_dim), device=device,
                       generator=gen)
    v = torch.randn(table.shape, device=device, generator=gen)
    for packed in (False, True):
        d = []
        for use_kernels in (True, False):
            tt = table.detach().requires_grad_(True)
            c = dout.clone().requires_grad_(True)
            y = E.hash_encode(tt, x01, hc, packed=packed,
                              use_kernels=use_kernels)
            g, = torch.autograd.grad(y, tt, c, create_graph=True)
            n0 = kernels.HASH_FWD.launches
            d.append(torch.autograd.grad((g * v).sum(), c)[0])
            if use_kernels and kernels.HASH_FWD.launches != n0 + 1:
                raise SystemExit("hash 7c'': kernel 7a did not launch once "
                                 "on the cotangent")
        err = rel_err(d[0], d[1])
        path = "packed" if packed else "fused"
        print(f"kernel hash_encode_fwd as 7c'' ({path} path): d ct err/max="
              f"{err:.3e} tol {HASH_BWD2_TOL:g} (the fp32 encode of the "
              f"table cotangent, 7a on the packed path too)", flush=True)
        if not err <= HASH_BWD2_TOL:
            raise SystemExit(f"hash 7c'' disagrees with its plain version "
                             f"({path}): {err}")
    dev_ms = device_ms(lambda: E.hash_encode_kernel(v, x01, hc), 10)
    b2b = cuda_ms(lambda: E.hash_encode_kernel(v, x01, hc), 10)
    plain = cuda_ms(lambda: E.hash_encode_plain(v, x01, hc), 3)
    rows = hash_rows_read(x01[None], hc)
    n = x01.shape[0]
    n_bytes = (nbytes(x01) + n * hc.out_dim * 4
               + rows * hc.features_per_level * 4)
    b_ms, b_by = bound(n_bytes, n * hc.levels * (
        18 + 8 * (8 + 2 * hc.features_per_level)))
    print(f"kernel hash_encode_fwd as 7c'': one inner step ({n} points, one "
          f"expert's table cotangent) device_ms={dev_ms:.4f} (back to back "
          f"{b2b:.4f}) plain_ms={plain:.4f} bytes={n_bytes} (points read, "
          f"output written, the distinct rows of the cotangent read: "
          f"{rows}) bound_ms={b_ms:.4f} ({b_by}) at "
          f"{HBM_BYTES_PER_S / 1e12:g} TB/s", flush=True)


def maml_phase(cfg, statics, params, occ, batch, device, results):
    """Phase maml: second-order MAML (`MetaConfig(algo="maml")`). Kernels
    4'', 5'', 6'' against their plain versions (`check_maml_kernels`);
    bench.py's step at full width with algo="maml" (K=4 planes experts,
    B=3 tasks of 4,000 + 2,000 rays, 8 inner steps, 32 samples, the light
    backward) through `train`: 1 timed step with peak memory and
    launches, one step with the exact backward (6''), one step's
    gradients through the kernels against the same step through
    `make_train_step(..., use_kernels=False)` (2^-8 of each leaf's max),
    one profiled step of each; the MAML gradient against the FoMAML
    gradient from the same params and draws (they must differ by more
    than that gate, and the FoMAML step launches no 4'' or 5''); the same
    MAML step under both precision options (`amp_cfg`: kernels 1b, 5b,
    5''b; none of 1, 5, 5'' launched), held, timed and profiled alike with
    its exact-backward step under bfloat16 lines (6 and 6'', no 5''b); then
    the runner's default hash experts: 7c'' checked and one timed MAML step through
    `train` -> launches of the timed and exact-backward steps."""
    import torch

    from nerfsys_tpu_torch import kernels
    from nerfsys_tpu_torch.models.container import param_group_labels
    from nerfsys_tpu_torch.pipelines.offline.meta_train_step import (
        make_train_step,
    )
    from nerfsys_tpu_torch.utils.optim import OptimConfig, build_optimizer
    from nerfsys_tpu_torch.utils.tree import tree_leaves

    t0 = time.perf_counter()
    check_maml_kernels(cfg, statics, params, occ, batch, device, results)
    print(f"maml: kernel checks took {time.perf_counter() - t0:.1f} s",
          flush=True)
    _, launches, (lk, gk) = train(
        cfg, statics, params, occ, batch, device, label="maml",
        need=TRAIN_KERNELS + MAML_F32, meta=maml_meta(), timed=1)
    if launches["plane_encode_bwd2_light_lines_bf16"]:
        raise SystemExit("maml: the float32 step launched kernel 5''b")
    rec = GradRecorder(build_optimizer(OptimConfig(outer_steps=10000),
                                       param_group_labels(params)))
    gen = torch.Generator(device=device).manual_seed(7)
    kernels.reset_launches()
    _, _, aux = make_train_step(train_meta(), cfg, rec)(
        params, rec.init(params), statics, batch, gen, occ)
    fo = kernels.launches()
    gaps = [rel_err(a, b) for a, b in zip(gk, tree_leaves(rec.grads[0]))]
    print(f"maml: the MAML step's gradient against the FoMAML step's from "
          f"the same params and draws: loss {lk:.7f} vs "
          f"{float(aux['loss_out_meta']):.7f}; difference / leaf max: "
          f"largest {max(gaps):.3e} median "
          f"{sorted(gaps)[len(gaps) // 2]:.3e} smallest {min(gaps):.3e} "
          f"over {len(gaps)} leaves; the FoMAML step launched 4'' / 5'' / "
          f"6'' / 12'' {[fo[k] for k in MAML_NEW]}", flush=True)
    if not max(gaps) > 2.0**-8 or any(fo[k] for k in MAML_NEW):
        raise SystemExit("maml: the MAML gradient does not differ from the "
                         "FoMAML one beyond the kernel-vs-plain gate, or "
                         "the FoMAML step took a second-order kernel")
    del gk, rec
    torch.cuda.empty_cache()
    print(f"maml: planes steps and the FoMAML step at "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    amp, after, _ = train(amp_cfg(cfg), statics, params, occ, batch,
                          device, label="maml amp", need=AMP_MAML_KERNELS,
                          meta=maml_meta(), timed=1)
    # its exact backward under bfloat16 lines: 6 and 6'', not 5''b
    exact = {k: after[k] - amp[k] for k in after}
    missed = [k for k in AMP_MAML_KERNELS if not amp[k]]
    launched = [k for k in AMP_MAML_IDLE if after[k]]
    if missed or launched or not (exact["plane_encode_bwd"] and exact[
            "plane_encode_bwd2"]) or exact["plane_encode_bwd2_light_lines_bf16"]:
        raise SystemExit(f"maml amp: the timed step missed {missed}, the "
                         f"float32 kernels {launched} launched, or the exact "
                         f"step did not take 6 and 6'' alone: {exact}")
    amp = after
    torch.cuda.empty_cache()
    print(f"maml: the precision options' steps at "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    hcfg, hparams = hash_setup(device)
    hash_bwd2_check(hcfg, statics, hparams, occ, batch, device)
    hashed, _, _ = train(
        hcfg, statics, hparams, occ, batch, device, label="maml hash",
        extra=None, need=("hash_encode_fwd", "hash_encode_bwd",
                          "volume_render_bwd2"), meta=maml_meta(), timed=1)
    del hparams
    torch.cuda.empty_cache()
    print(f"maml: phase took {time.perf_counter() - t0:.1f} s", flush=True)
    return {k: launches[k] + amp[k] + hashed[k] for k in launches}


TRAINER_CAMS, TRAINER_VAL = 16, 2  # an aerial ring of training + val cameras
TRAINER_W, TRAINER_H = 1000, 750  # a 12 MP drone photo at downscale 0.25
TRAINER_FOCAL = 750.0
TRAINER_STEPS, TRAINER_WARM_STEPS, TRAINER_HASH_STEPS = 36, 4, 4
TRAINER_MAML_STEPS = 4  # --algo maml, an occupancy update every 2 steps
TRAINER_PROFILED = 18  # a loop step with an occupancy update after it
TRAINER_CAP = 4  # training cameras of the warm-start and hash runs (their
# checks do not depend on the data; the host builds the scene's rays anew)
GROUND_X, CAM_X, CAM_R = 0.5, -0.9, 0.4  # DRB: x points down
# the global box: the ground's altitude band, +-1.1 across (the cameras
# fly above it, as create_clusters' box holds the scene's points)
SCENE_BOX = ((0.2, -1.1, -1.1), (0.6, 1.1, 1.1))
MASK_SAMPLES, MASK_MARGIN = 32, 1.1
TRAINER_EXTRA = ()  # flags appended to every runner call (CPU rehearsals)
TRAINER_KERNELS = ("plane_encode_fwd", "occupancy_probe_cdf",
                   "sample_tvals_from_cdf", "volume_render_fwd",
                   "volume_render_bwd", "plane_encode_bwd_light")
TRAINER_HASH_KERNELS = ("hash_encode_fwd", "hash_encode_bwd")


def scene_cameras():
    """The ring's camera-to-world poses (RUB camera axes in the DRB world)
    and intrinsics: TRAINER_CAMS + TRAINER_VAL cameras at height -CAM_X,
    radius CAM_R, each looking at the ground's centre."""
    import numpy as np

    n = TRAINER_CAMS + TRAINER_VAL
    up = np.array([-1.0, 0.0, 0.0])
    target = np.array([GROUND_X, 0.0, 0.0])
    c2ws = []
    for a in np.linspace(0.0, 2.0 * np.pi, n, endpoint=False):
        eye = np.array([CAM_X, CAM_R * np.cos(a), CAM_R * np.sin(a)])
        fwd = (target - eye) / np.linalg.norm(target - eye)
        right = np.cross(fwd, up)
        right /= np.linalg.norm(right)
        c2ws.append(np.stack([right, np.cross(right, fwd), -fwd, eye],
                             1).astype(np.float32))
    intr = np.array([TRAINER_FOCAL, TRAINER_FOCAL, TRAINER_W / 2,
                     TRAINER_H / 2], np.float32)
    return c2ws, intr


def scene_image(c2w, intr, device):
    """(H, W, 3) uint8: a smooth procedural texture on the ground plane
    x = GROUND_X inside the scene box's footprint, a sky gradient
    elsewhere -> (image, camera rays (H*W, 3) origins, directions)."""
    import torch

    H, W = TRAINER_H, TRAINER_W
    fx, fy, cx, cy = (float(v) for v in intr)
    j, i = torch.meshgrid(torch.arange(H, device=device) + 0.5,
                          torch.arange(W, device=device) + 0.5,
                          indexing="ij")
    dirs = torch.stack([(i - cx) / fx, -(j - cy) / fy, -torch.ones_like(i)],
                       -1).reshape(-1, 3)
    dirs = dirs / dirs.norm(dim=-1, keepdim=True)
    c2w = torch.tensor(c2w, device=device)
    d = dirs @ c2w[:, :3].T
    o = c2w[:, 3].expand_as(d)
    t = (GROUND_X - o[:, 0]) / d[:, 0].clamp(min=1e-6)
    y, z = (o[:, 1] + d[:, 1] * t), (o[:, 2] + d[:, 2] * t)
    ground = (d[:, 0] > 1e-6) & (y.abs() <= SCENE_BOX[1][1]) & (
        z.abs() <= SCENE_BOX[1][2])
    tex = torch.stack([
        0.5 + 0.3 * torch.sin(3.1 * y + 1.7 * z + 0.3),
        0.5 + 0.3 * torch.sin(-2.3 * y + 2.9 * z + 1.1),
        0.5 + 0.25 * torch.cos(4.0 * torch.sqrt(y * y + z * z))], -1)
    sky = torch.stack([0.55 - 0.2 * d[:, 0], 0.65 - 0.2 * d[:, 0],
                       torch.full_like(y, 0.9)], -1)
    rgb = torch.where(ground[:, None], tex, sky).clamp(0, 1)
    img = (rgb * 255.0 + 0.5).to(torch.uint8).reshape(H, W, 3)
    return img, o, d


def voronoi_masks(o, d, cents, box, mins, maxs):
    """create_clusters' routing of one image on the card: MASK_SAMPLES
    points a ray between its entry to and exit from the global box; a
    pixel belongs to expert c iff min_x d2(x, c) <= margin^2 min_c'
    min_x d2(x, c') on (y, z); the experts' boxes grow over the points
    assigned to them (mins, maxs updated in place) -> (H*W, K) bool."""
    import torch

    inv = 1.0 / torch.where(d.abs() < 1e-8, torch.full_like(d, 1e-8), d)
    t0, t1 = (box[0] - o) * inv, (box[1] - o) * inv
    near = torch.minimum(t0, t1).amax(-1).clamp(min=0.0)
    far = torch.maximum(t0, t1).amin(-1)
    ok = far > near
    near, far = torch.where(ok, near, 0.0), torch.where(ok, far, 0.0)
    zs = torch.linspace(0.0, 1.0, MASK_SAMPLES, device=o.device)
    out = []
    for s in range(0, o.shape[0], 1 << 18):
        sl = slice(s, s + (1 << 18))
        t = near[sl, None] * (1 - zs) + far[sl, None] * zs
        x = o[sl, None] + d[sl, None] * t[..., None]  # (R, S, 3)
        d2 = ((x[..., None, 1:] - cents[:, 1:]) ** 2).sum(-1)  # (R, S, K)
        assign = (d2 <= MASK_MARGIN ** 2 * d2.amin(-1, keepdim=True)) & ok[
            sl, None, None]
        out.append(assign.any(1))
        for k in range(cents.shape[0]):
            pts = x[assign[..., k]]
            if pts.shape[0]:
                mins[k] = torch.minimum(mins[k], pts.amin(0))
                maxs[k] = torch.maximum(maxs[k], pts.amax(0))
    return torch.cat(out)


def save_zip_mask(path, mask) -> None:
    """A zip-compressed torch .pt bool tensor (create_clusters' format)."""
    import io
    import zipfile

    import torch

    buf = io.BytesIO()
    torch.save(mask.cpu().contiguous(), buf)
    with zipfile.ZipFile(path, "w", compression=zipfile.ZIP_DEFLATED) as zf:
        zf.writestr(path.name, buf.getvalue())


def write_scene(root, device) -> int:
    """A prepared scene in the dataset layout (nerfsys_tpu/data/dataset.py)
    under root: coordinates.pt, {train,val}/{metadata/*.pt, rgbs/*.png},
    masks/g22/{params.pt, scene_boxes.pt, <cid>/*.pt} (zip-compressed
    boolean masks of a 2x2 ground Voronoi with margin MASK_MARGIN) ->
    pixels written."""
    import numpy as np
    import torch
    from PIL import Image

    c2ws, intr = scene_cameras()
    n = len(c2ws)
    val = {round(n * (k + 0.25) / TRAINER_VAL) for k in range(TRAINER_VAL)}
    box = torch.tensor(SCENE_BOX, device=device)
    mid = 0.5 * (SCENE_BOX[0][0] + SCENE_BOX[1][0])
    cents = torch.tensor([[mid, sy * 0.55, sz * 0.55] for sy in (-1, 1)
                          for sz in (-1, 1)], device=device)
    K = cents.shape[0]
    mins = torch.full((K, 3), float("inf"), device=device)
    maxs = torch.full((K, 3), float("-inf"), device=device)
    masks_dir = root / "masks" / "g22"
    for d in ([root / s / k for s in ("train", "val")
               for k in ("metadata", "rgbs")]
              + [masks_dir / str(c) for c in range(K)]):
        d.mkdir(parents=True, exist_ok=True)
    torch.save({"origin_drb": torch.zeros(3), "pose_scale_factor": 1.0},
               root / "coordinates.pt")
    for i, c2w in enumerate(c2ws):
        split = "val" if i in val else "train"
        name = f"{i:06d}"
        img, o, d = scene_image(c2w, intr, device)
        Image.fromarray(img.cpu().numpy()).save(
            root / split / "rgbs" / f"{name}.png", compress_level=1)
        torch.save({"H": TRAINER_H, "W": TRAINER_W,
                    "c2w": torch.from_numpy(c2w),
                    "intrinsics": torch.from_numpy(intr),
                    "distortion": torch.zeros(4)},
                   root / split / "metadata" / f"{name}.pt")
        mask = voronoi_masks(o, d, cents, box, mins, maxs)
        for c in range(K):
            save_zip_mask(masks_dir / str(c) / f"{name}.pt",
                          mask[:, c].reshape(TRAINER_H, TRAINER_W))
    lo, hi = box[0], box[1]
    mins, maxs = torch.maximum(mins, lo), torch.minimum(maxs, hi)
    mins[:, 0], maxs[:, 0] = lo[0], hi[0]  # altitude unified
    aabb = box.cpu()
    torch.save({"format_version": 3, "centroid_mode": "grid",
                "centroids": cents.cpu(), "grid_dim": (1, 2, 2),
                "cluster_2d": True, "boundary_margin": MASK_MARGIN,
                "ray_samples": MASK_SAMPLES, "aabb_global": aabb,
                "scene_scale": 1.1, "near_far_override_m": (None, None)},
               masks_dir / "params.pt")
    torch.save({"format_version": 3, "aabb_global": aabb,
                "mins": mins.cpu(), "maxs": maxs.cpu()},
               masks_dir / "scene_boxes.pt")
    return n * TRAINER_H * TRAINER_W


class LoopProbe:
    """What chip_smoke reads of a runner.main run, through wrappers on
    the runner's names (`attach`): the build's seconds, each train step
    (its host start, metrics, the batch's devices), the inputs and
    gradients of the steps in `check_steps` (`checked`, by step index;
    with whether the occupancy grid was ready, so the step sampled by
    importance), the occupancy updates, the checkpoint saves and loads,
    meta_trainer's arguments and the meters' data_time / step_time; and
    one profiled loop step (`profile_step`, with the occupancy update
    after it)."""

    def __init__(self, profile_step=None, check_steps=(0,)):
        self.seconds = {}
        self.steps, self.updates, self.saves, self.meters = [], [], [], []
        self.check_steps, self.checked = frozenset(check_steps), {}
        self.last_params = None
        self.trainer_kwargs = None
        self.rec = None
        self.meta_cfg = None
        self.profile_step, self.prof = profile_step, None
        self.t_main = time.perf_counter()

    def timed(self, key):
        def make(fn):
            def wrapped(*args, **kwargs):
                t0 = time.perf_counter()
                try:
                    return fn(*args, **kwargs)
                finally:
                    self.seconds[key] = self.seconds.get(key, 0.0) + (
                        time.perf_counter() - t0)
            return wrapped
        return make

    def make_train_step(self, fn):
        import torch

        from nerfsys_tpu_torch.models.occupancy import occ_ready

        def make(meta, cfg, tx, **kw):
            self.meta_cfg = (meta, cfg, tx)
            step = fn(meta, cfg, tx, **kw)

            def wrapped(params, opt_state, statics, batch, gen, occ=None):
                i = len(self.steps)
                if i in self.check_steps:
                    self.checked[i] = dict(
                        params=params, statics=statics, batch=batch,
                        gen_state=gen.get_state(),
                        occ=None if occ is None else
                        {k: v.clone() for k, v in occ.items()},
                        occ_ready=occ is not None and bool(occ_ready(occ)))
                if i == self.profile_step:
                    self.start_profile()
                t = time.perf_counter()
                out = step(params, opt_state, statics, batch, gen, occ)
                self.last_params = out[0]
                self.steps.append(dict(
                    t=t, aux=out[2],
                    on_device=all(v.device.type == gen.device.type
                                  for v in batch.values()
                                  if isinstance(v, torch.Tensor))))
                return out
            return wrapped
        return make

    def build_optimizer(self, fn):
        def make(cfg, labels):
            self.rec = GradRecorder(fn(cfg, labels), keep=self.check_steps)
            return self.rec
        return make

    def make_occ_update_fn(self, fn):
        def make(cfg, occ_cfg, **kw):
            update = fn(cfg, occ_cfg, **kw)

            def wrapped(state, params, statics, step, gen):
                new = update(state, params, statics, step, gen)
                if new is not state:
                    self.updates.append((step, step < occ_cfg.warmup_steps,
                                         new["num_updates"]))
                if self.prof is not None:
                    self.stop_profile()
                return new
            return wrapped
        return make

    def meta_trainer(self, fn):
        def wrapped(**kw):
            self.trainer_kwargs = dict(kw)
            self.seconds["to first step"] = time.perf_counter() - self.t_main
            return fn(**kw)
        return wrapped

    def scalars(self, fn):
        def wrapped(logger, values, step, prefix=""):
            if prefix == "train/":
                self.meters.append((values["time_data"],
                                    values["time_step"]))
            return fn(logger, values, step, prefix)
        return wrapped

    def start_profile(self):
        import torch
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.start()
        self.t_prof = time.perf_counter()

    def stop_profile(self):
        import torch

        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - self.t_prof)
        self.prof.stop()
        prof, self.prof = self.prof, None
        profile_report("trainer loop step", prof, wall_ms,
                       extra=" (one runner loop step with its occupancy "
                       "update)", watch=(("plane_encode_fwd_kernel",),
                                         ("volume_render_bwd_kernel",)))

    def attach(self, stack):
        from nerfsys_tpu_torch import runner
        from nerfsys_tpu_torch.data import task_dataset
        from nerfsys_tpu_torch.models import occupancy as MO
        from nerfsys_tpu_torch.utils import checkpoint as ckpt
        from nerfsys_tpu_torch.utils.logging import Logger

        for module, attr, make in (
                (runner, "get_dataset", self.timed("dataset")),
                (runner, "TaskDataset", self.timed("TaskDataset")),
                (task_dataset, "route_rays_exact", self.timed("routing")),
                (runner, "make_train_step", self.make_train_step),
                (runner, "build_optimizer", self.build_optimizer),
                (runner, "meta_trainer", self.meta_trainer),
                (MO, "make_occ_update_fn", self.make_occ_update_fn),
                (ckpt, "save_checkpoint", self.timed("checkpoint save")),
                (ckpt, "save_aux_state", self.timed("checkpoint save")),
                (ckpt, "load_checkpoint", self.timed("checkpoint load")),
                (ckpt, "load_aux_state", self.timed("checkpoint load")),
                (Logger, "scalars", self.scalars)):
            stack.enter_context(patched(module, attr, make))
        return self


def run_runner(argv, profile_step=None, check_steps=(0,)):
    """runner.main(argv) with a LoopProbe attached -> (ctx, probe); the
    launch counters are zeroed just before and read just after."""
    from nerfsys_tpu_torch import kernels, runner

    with contextlib.ExitStack() as stack:
        probe = LoopProbe(profile_step, check_steps).attach(stack)
        kernels.reset_launches()
        ctx = runner.main(argv)
        probe.launches = kernels.launches()
    return ctx, probe


def median(xs):
    xs = sorted(xs)
    return xs[len(xs) // 2] if xs else float("nan")


def loop_checks(label, probe, n_steps, need):
    """Every step finite and fed from the card, the kernels `need`
    launched -> the losses."""
    import math

    losses = [float(s["aux"]["loss_out"]) for s in probe.steps]
    if len(losses) != n_steps or not all(map(math.isfinite, losses)):
        raise SystemExit(f"trainer: {label}: {len(losses)} steps, losses "
                         f"{losses}")
    if not all(s["on_device"] for s in probe.steps):
        raise SystemExit(f"trainer: {label}: a batch reached the step off "
                         f"the card")
    for k in need:
        if probe.launches[k] <= 0:
            raise SystemExit(f"trainer: {label}: kernel {k} never launched")
    return losses


def trainer_maml(base, tmp, device):
    """The trainer phase's `--algo maml` run on the written scene (`base`:
    the phase's runner flags) under both precision options (AMP_FLAGS),
    TRAINER_MAML_STEPS steps with an occupancy update every 2 steps: the
    losses finite, the params moved, kernels 1b-5b, 4'', 5''b and row
    12's second derivative launched and none of 1, 5, 5'', step 0 held to
    the plain path; then `--op eval --tto 0,1` from its `last` (the
    options from its flags) -> the run's and the eval's launches. The
    float32 second-order path is driven by the maml phase's bench step."""
    import torch

    from nerfsys_tpu_torch.utils.tree import tree_leaves

    name, n_steps = "maml", TRAINER_MAML_STEPS
    ctx, probe = run_runner(base + [
        "--cap_images", str(TRAINER_CAP), "--algo", "maml", *AMP_FLAGS,
        "--occ_warmup", "2", "--occ_update_interval", "2",
        "--outer_steps", str(n_steps), "--fname", str(tmp / name)])
    losses = loop_checks(f"{name} run", probe, n_steps, AMP_MAML_KERNELS)
    meta, cfg, opt = probe.meta_cfg
    f = probe.checked[0]
    moved = [not torch.equal(a, b) for a, b in zip(
        tree_leaves(probe.last_params), tree_leaves(f["params"]))]
    launched = [k for k in AMP_MAML_IDLE if probe.launches[k]]
    if meta.algo != "maml" or not all(moved) or not probe.updates or (
            cfg.expert.use_bf16, cfg.expert.planes.lines_bf16) != (
            True, True) or launched:
        raise SystemExit(f"trainer: {name} run: algo {meta.algo}, "
                         f"{moved.count(False)} param leaves did not move, "
                         f"occupancy updates {probe.updates}, options "
                         f"{cfg.expert.use_bf16} / "
                         f"{cfg.expert.planes.lines_bf16}, float32 kernels "
                         f"launched {launched}")
    grads_through_plain_match(
        meta, cfg, opt, f["statics"], f["params"], f["occ"], f["batch"],
        device, f"trainer {name} run step 0 (stratified, the grid not yet "
        "ready)", kernel_side=(float(probe.steps[0]["aux"]["loss_out_meta"]),
                               tree_leaves(probe.rec.grads[0])),
        gen_state=f["gen_state"])
    gaps = [1e3 * (b["t"] - a["t"])
            for a, b in zip(probe.steps, probe.steps[1:])]
    launches = dict(probe.launches)
    updates = [(s, w, int(n)) for s, w, n in probe.updates]
    del ctx, probe, f
    torch.cuda.empty_cache()
    rows, evaled = options_eval(name, tmp, device)
    print(f"trainer: {name} run (--algo maml {' '.join(AMP_FLAGS)}) {n_steps} "
          f"steps, loss_out {losses}; median step ms (host clock, start to "
          f"start) {median(gaps):.2f}; occupancy updates {updates}; eval "
          f"--tto 0,1 from its last (tto, psnr, ssim) {rows}; launches: "
          f"train {launches}, eval {evaled}", flush=True)
    return {k: v + evaled[k] for k, v in launches.items()}


def trainer(device):
    """Phase: the runner's train op (`runner.main`, configs/train.json's
    model at bench width: K=4 planes experts L=3 base 128 F=8, hidden 64,
    B=3 tasks of 4,000 + 2,000 rays, 8 inner steps, 32 samples, soft
    importance occupancy R=128 L=4) on a prepared scene written to a
    temporary directory: an aerial ring of 16 training and 2 validation
    1000x750 cameras over a textured ground, 4 experts on a 2x2 ground
    Voronoi. 36 steps with 6 occupancy updates, evals and saves every 12;
    the gradients of steps 0 (stratified) and 18 (importance sampling)
    against the same steps through the plain path; a warm start from
    `last` for 4 more steps; 4 steps of the hash experts (the runner's
    default encoder at its default widths); 4 steps with `--algo maml`
    under both precision options and an eval from them (`trainer_maml`);
    4 FoMAML steps with the precision options and an eval from them
    (`amp_runner`); then the eval
    and video phases on the main run's directory -> (launches of the four
    runs, the eval phase's launches, the video phase's, the precision
    runs')."""
    import json
    import shutil
    import tempfile

    import torch

    from nerfsys_tpu_torch.utils.tree import tree_leaves

    t_phase = time.perf_counter()
    tmp = Path(tempfile.mkdtemp(prefix="nerfsys_trainer_"))
    try:
        t0 = time.perf_counter()
        pixels = write_scene(tmp / "out" / "scene", device)
        scene_s = time.perf_counter() - t0
        base = ["--op", "train", "--configPath",
                str(Path(__file__).resolve().parent / "configs"
                    / "train.json"),
                "--data_path", str(tmp), "--data_dirname", "scene",
                "--mask_dirname", "g22", "--downscale", "1.0",
                "--occ_warmup", "12", "--occ_update_interval", "6",
                "--eval_step", "12", "--save_step", "12",
                "--max_test_tasks", "1", "--device", str(device),
                *TRAINER_EXTRA]
        run = tmp / "run"
        ctx, probe = run_runner(base + ["--outer_steps", str(TRAINER_STEPS),
                                        "--fname", str(run)],
                                profile_step=TRAINER_PROFILED,
                                check_steps=(0, TRAINER_PROFILED))
        losses = loop_checks("main run", probe, TRAINER_STEPS,
                             TRAINER_KERNELS)
        bundle = ctx["bundle"]
        n_rays = sum(len(ds) for ds in bundle.train_sets)
        moved = [not torch.equal(a, b) for a, b in zip(
            tree_leaves(probe.last_params),
            tree_leaves(probe.checked[0]["params"]))]
        if not all(moved):
            raise SystemExit(f"trainer: {moved.count(False)} param leaves "
                             f"did not move")
        ups = [(s, w, int(n)) for s, w, n in probe.updates]
        if [w for _, w, _ in ups] != [True] * 2 + [False] * 4 or \
                ups[-1][2] != 6:
            raise SystemExit(f"trainer: occupancy updates {ups}, expected "
                             f"2 full then 4 subset")
        tags = ("step12", "step24", "step36", "last", "best")
        missing = [t for t in tags if not (run / f"{t}.model").exists()
                   or not (run / f"{t}.occ").exists()]
        if missing:
            raise SystemExit(f"trainer: checkpoints missing: {missing}")
        print(f"trainer: scene {TRAINER_CAMS} + {TRAINER_VAL} cameras "
              f"{TRAINER_W}x{TRAINER_H} ({pixels} pixels) written in "
              f"{scene_s:.2f} s; {n_rays} training rays over "
              f"{len(bundle.train_sets)} experts "
              f"{[len(ds) for ds in bundle.train_sets]}; build s: dataset "
              f"{probe.seconds['dataset']:.2f}, TaskDataset "
              f"{probe.seconds['TaskDataset']:.2f} (routing "
              f"{probe.seconds['routing']:.2f}); seconds to the first step "
              f"{probe.seconds['to first step']:.2f} (native rays and "
              f"routing; {host_text()}; reference points, not measured in "
              f"this run: the numpy paths took dataset 11.05, routing 58.35, "
              f"74.48 s to the first step on this scene in an earlier run "
              f"on an H100 80GB HBM3 host)", flush=True)
        native_routing_check(bundle.train_sets[0].rays[:NATIVE_ROUTE_RAYS],
                             ctx["P"].cell_dim)
        gaps = [1e3 * (b["t"] - a["t"])
                for a, b in zip(probe.steps, probe.steps[1:])]
        data = [1e3 * m[0] for m in probe.meters]
        stept = [1e3 * m[1] for m in probe.meters]
        saves = probe.seconds.get("checkpoint save", 0.0)
        print(f"trainer: {TRAINER_STEPS} loop steps: median step ms (host "
              f"clock, start to start) {median(gaps):.2f}; meters: "
              f"data_time median {median(data):.2f} ms (max "
              f"{max(data):.2f}), step_time median {median(stept):.2f} ms; "
              f"loss_out first / last {losses[0]:.6f} / {losses[-1]:.6f} "
              f"(min {min(losses):.6f}); occupancy updates {ups}; "
              f"checkpoint saves (every tag and each new best) {saves:.2f} "
              f"s in all; launches {probe.launches}", flush=True)
        bench = PROFILES.get("train step")
        loop = PROFILES.get("trainer loop step")
        if loop is None:
            raise SystemExit("trainer: the loop step was not profiled")
        if bench is not None:
            print(f"trainer: profiled loop step (step {TRAINER_PROFILED} + "
                  f"its occupancy update) wall {loop[0]:.2f} ms, device busy "
                  f"{loop[1]:.2f} ms, idle share "
                  f"{1 - loop[1] / loop[0]:.3f}; the train phase's bench "
                  f"step on the same configuration wall {bench[0]:.2f} ms, "
                  f"busy {bench[1]:.2f} ms, idle share "
                  f"{1 - bench[1] / bench[0]:.3f}", flush=True)

        # the loop's first step samples stratified (the grid is not ready
        # before occ_warmup // occ_update_interval updates); the profiled
        # step samples by importance through kernels 2 and 3
        meta, cfg, opt = probe.meta_cfg
        for i, want_ready in ((0, False), (TRAINER_PROFILED, True)):
            f = probe.checked[i]
            if f["occ_ready"] != want_ready:
                raise SystemExit(f"trainer: loop step {i}: occupancy grid "
                                 f"ready {f['occ_ready']}, expected "
                                 f"{want_ready}")
            path = ("importance sampling from the occupancy grid" if
                    want_ready else "stratified, the grid not yet ready")
            grads_through_plain_match(
                meta, cfg, opt, f["statics"], f["params"], f["occ"],
                f["batch"], device, f"trainer loop step {i} ({path})",
                kernel_side=(float(probe.steps[i]["aux"]["loss_out_meta"]),
                             tree_leaves(probe.rec.grads[i])),
                gen_state=f["gen_state"])
        launches = dict(probe.launches)
        del ctx, probe, f, bundle
        torch.cuda.empty_cache()

        # warm start from the main run's `last`
        saved = torch.load(run / "last.model", weights_only=True)
        saved_occ = torch.load(run / "last.occ", weights_only=True)
        state = json.loads((run / "last.state.json").read_text())
        ctx, probe = run_runner(base + [
            "--cap_images", str(TRAINER_CAP),
            "--checkpoint_path", str(run), "--prefix", "last",
            "--outer_steps", str(TRAINER_STEPS + TRAINER_WARM_STEPS),
            "--fname", str(tmp / "warm")])
        kw = probe.trainer_kwargs
        same = all(torch.equal(a.cpu(), b) for a, b in zip(
            tree_leaves(probe.checked[0]["params"]), tree_leaves(saved)))
        same_occ = all(torch.equal(probe.checked[0]["occ"][k].cpu(), v)
                       for k, v in saved_occ.items())
        if kw["start_step"] != TRAINER_STEPS or kw["best"] != state[
                "best"] or not same or not same_occ:
            raise SystemExit(f"trainer: warm start restored step "
                             f"{kw['start_step']} best {kw['best']} (saved "
                             f"{state}), params equal {same}, grids equal "
                             f"{same_occ}")
        loop_checks("warm start", probe, TRAINER_WARM_STEPS, ())
        print(f"trainer: warm start from last: step {kw['start_step']}, "
              f"best {kw['best']:.4f}, params and grids bit-equal to the "
              f"saved ones; checkpoint load "
              f"{probe.seconds.get('checkpoint load', 0.0):.2f} s, seconds "
              f"to the first step {probe.seconds['to first step']:.2f}; "
              f"{TRAINER_WARM_STEPS} more steps; launches "
              f"{probe.launches}", flush=True)
        launches = {k: v + probe.launches[k] for k, v in launches.items()}
        del ctx, probe, saved, saved_occ
        torch.cuda.empty_cache()

        # the runner's default encoder at its default widths
        ctx, probe = run_runner(base + [
            "--cap_images", str(TRAINER_CAP), "--xyz_encoding", "hash",
            "--outer_steps", str(TRAINER_HASH_STEPS),
            "--fname", str(tmp / "hash")])
        hash_losses = loop_checks("hash run", probe, TRAINER_HASH_STEPS,
                                  TRAINER_HASH_KERNELS)
        hc = ctx["cfg"].expert.hash
        print(f"trainer: hash run (L={hc.levels} F="
              f"{hc.features_per_level} T={hc.log2_hashmap_size}) "
              f"{TRAINER_HASH_STEPS} steps, loss_out {hash_losses}; "
              f"launches {probe.launches}", flush=True)
        launches = {k: v + probe.launches[k] for k, v in launches.items()}
        del ctx, probe
        torch.cuda.empty_cache()

        maml = trainer_maml(base, tmp, device)
        launches = {k: v + maml[k] for k, v in launches.items()}
        amp_run = amp_runner(base, tmp, device)
        print(f"trainer: phase took {time.perf_counter() - t_phase:.1f} s",
              flush=True)
        evaluated = eval_phase(device, tmp, run)
        filmed = video_phase(device, tmp, run)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return launches, evaluated, filmed, amp_run


EVAL_TTO = "0,1,10"  # configs/eval.json's --tto
EVAL_FAST_TTO = "0,4"  # the --render_fast run
EVAL_CHECKED = 4  # adapt steps held against the plain path
# flags appended to every runner call of the eval and video phases (CPU
# rehearsals shrink them; the main path appends none)
REHEARSAL_EXTRA = ()
BAKE_R = 256  # --render_baked of the eval and video phases' baked runs
EVAL_KERNELS = TRAINER_KERNELS  # kernels 1-5 and 4'
EVAL_FLIP = 0.005  # the camera phase's rule: pixels beyond 1e-4
LPIPS_CFG = ((64, 11), (192, 5), (384, 3), (256, 3), (256, 3))


class EvalProbe:
    """What chip_smoke reads of a `runner.main(["--op", "eval", ...])` run,
    through wrappers on the runtime's names (`attach`): every adapt step
    (host ms to a synchronize, its loss, the bucketed container's calls
    and dense fallbacks during it; the inputs of the first EVAL_CHECKED
    steps of the run's last --tto entry, with the step's factory
    arguments), every `render_image` call (host s, the dispatch's stats,
    the prediction), each `runtime_evaluate` call's arguments and result,
    and the bake's seconds and alive share."""

    def __init__(self, capture_tto=None):
        self.steps, self.frames, self.evals = [], [], []
        self.captured, self.capture_tto, self.tto = [], capture_tto, None
        self.step_args = None
        self.bake = {}

    def runtime_evaluate(self, fn):
        def wrapped(**kw):
            self.tto = kw["tto_steps"]
            out = fn(**kw)
            self.evals.append((kw, out))
            return out
        return wrapped

    def make_adapt_step(self, fn):
        import torch

        from nerfsys_tpu_torch.models import container as co

        def make(cfg, optimizer, **kw):
            step = fn(cfg, optimizer, **kw)
            self.step_args = (cfg, optimizer, kw)

            def wrapped(params, opt_state, statics, rays, rgbs, gen,
                        occ=None):
                if (self.tto == self.capture_tto
                        and len(self.captured) < EVAL_CHECKED):
                    self.captured.append(dict(
                        params=params, opt_state=opt_state, statics=statics,
                        rays=rays, rgbs=rgbs, gen_state=gen.get_state(),
                        occ=occ))
                calls, dense = co.bucket_stats["calls"], co.bucket_stats[
                    "dense"]
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = step(params, opt_state, statics, rays, rgbs, gen, occ)
                torch.cuda.synchronize()
                self.steps.append(dict(
                    tto=self.tto, ms=1e3 * (time.perf_counter() - t0),
                    loss=float(out[2]),
                    calls=co.bucket_stats["calls"] - calls,
                    dense=co.bucket_stats["dense"] - dense))
                return out
            return wrapped
        return make

    def render_image(self, fn):
        from nerfsys_tpu_torch.models import container as co

        def wrapped(renderer, params, statics, md, **kw):
            stats = kw.setdefault("stats", {})
            calls, dense = co.bucket_stats["calls"], co.bucket_stats["dense"]
            t0 = time.perf_counter()
            out = fn(renderer, params, statics, md, **kw)
            self.frames.append(dict(
                tto=self.tto, s=time.perf_counter() - t0, md=md, stats=stats,
                pred=out[0], calls=co.bucket_stats["calls"] - calls,
                dense=co.bucket_stats["dense"] - dense))
            return out
        return wrapped

    def bake_field(self, fn):
        import torch

        def wrapped(*a, **kw):
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            self.bake["s"] = time.perf_counter() - t0
            return out
        return wrapped

    def bake_alive_mask(self, fn):
        def wrapped(*a, **kw):
            alive = fn(*a, **kw)
            if alive is not None:
                self.bake["alive"] = float(alive.float().mean())
            return alive
        return wrapped

    def attach(self, stack):
        from nerfsys_tpu_torch import runner
        from nerfsys_tpu_torch.models import baked
        from nerfsys_tpu_torch.pipelines.online import runtime_adapt as ra

        for module, attr, make in (
                (runner, "runtime_evaluate", self.runtime_evaluate),
                (ra, "make_adapt_step", self.make_adapt_step),
                (ra, "render_image", self.render_image),
                (baked, "bake_field", self.bake_field),
                (baked, "bake_alive_mask", self.bake_alive_mask)):
            stack.enter_context(patched(module, attr, make))
        return self


def run_eval(argv, capture_tto=None):
    """runner.main(argv) for the eval op with an EvalProbe attached ->
    (ctx, probe); the launch counters are zeroed just before and read
    just after."""
    from nerfsys_tpu_torch import kernels, runner

    with contextlib.ExitStack() as stack:
        probe = EvalProbe(capture_tto).attach(stack)
        kernels.reset_launches()
        ctx = runner.main(list(argv) + list(REHEARSAL_EXTRA))
        probe.launches = kernels.launches()
    return ctx, probe


def image_scores(pred_lin, md, color_space, device):
    """(PSNR, SSIM) of a rendered linear image against its ground truth,
    as runtime_evaluate scores it."""
    import torch

    from nerfsys_tpu_torch.ops.color_space import color_space_transformer
    from nerfsys_tpu_torch.ops.losses import psnr_from_mse
    from nerfsys_tpu_torch.utils.metrics import ssim

    gt = torch.from_numpy(md.load_image().astype("float32") / 255.0).to(
        device)
    pred, gt = color_space_transformer(torch.from_numpy(pred_lin).to(device),
                                       gt, color_space)
    return (float(psnr_from_mse(torch.mean((pred - gt) ** 2))),
            float(ssim(pred, gt)))


def eval_rows_text(ctx) -> str:
    return "; ".join(f"tto {r['tto']}: PSNR {r['psnr']:.4f} SSIM "
                     f"{r['ssim']:.5f} adapt {r['duration']:.2f} s render "
                     f"{r['render_time']:.2f} s" for r in ctx["rows"])


def eval_checks(label, ctx, probe, need, n_tto):
    """Every row finite, each adapted run's params moved from the
    checkpoint's, every adapt loss finite, the kernels `need` launched."""
    import math

    import torch

    from nerfsys_tpu_torch.utils.tree import tree_leaves

    rows = ctx["rows"]
    if len(rows) != n_tto or not all(
            math.isfinite(r["psnr"]) and math.isfinite(r["ssim"])
            for r in rows):
        raise SystemExit(f"eval: {label}: rows {rows}")
    if not all(math.isfinite(s["loss"]) for s in probe.steps):
        raise SystemExit(f"eval: {label}: adapt losses "
                         f"{[s['loss'] for s in probe.steps]}")
    base = tree_leaves(ctx["params"])
    for kw, out in probe.evals:
        if kw["tto_steps"] > 0 and not all(
                not torch.equal(a, b)
                for a, b in zip(tree_leaves(out["params"]), base)):
            raise SystemExit(f"eval: {label}: tto {kw['tto_steps']}: a "
                             f"param leaf did not move")
    for k in need:
        if probe.launches[k] <= 0:
            raise SystemExit(f"eval: {label}: kernel {k} never launched")


def adapt_steps_match(probe, device):
    """The captured adapt steps, each taken again from its own inputs and
    generator state through the kernels and through the plain versions:
    losses within 1e-4 relative, every gradient leaf within 2^-8 of its
    max, the updated params reported beside."""
    import torch

    from nerfsys_tpu_torch.pipelines.online.runtime_adapt import (
        make_adapt_step,
    )
    from nerfsys_tpu_torch.utils.tree import tree_leaves

    cfg, opt, kw = probe.step_args
    tol, worst, worst_p, losses = 2.0 ** -8, [], [], []
    for i, c in enumerate(probe.captured):
        side = []
        for use_kernels in (True, False):
            rec = GradRecorder(opt)
            gen = torch.Generator(device=device)
            gen.set_state(c["gen_state"])
            p, _, loss = make_adapt_step(cfg, rec, **kw,
                                         use_kernels=use_kernels)(
                c["params"], c["opt_state"], c["statics"], c["rays"],
                c["rgbs"], gen, c["occ"])
            side.append((float(loss), tree_leaves(rec.grads[0]),
                         tree_leaves(p)))
        (lk, gk, pk), (lp, gp, pp) = side
        errs = [rel_err(a, b) for a, b in zip(gk, gp)]
        worst.append(max(errs))
        worst_p.append(max(rel_err(a, b) for a, b in zip(pk, pp)))
        losses.append((lk, lp))
        if abs(lk - lp) > 1e-4 * abs(lp) or not max(errs) <= tol:
            raise SystemExit(f"eval: adapt step {i}: kernel path loss {lk} "
                             f"vs plain {lp}, gradient error / leaf max "
                             f"{max(errs):.3e} (tol {tol:g})")
    print(f"eval: {len(probe.captured)} adapt steps (importance sampling "
          f"from the restored grids) through kernels vs plain from the same "
          f"params, batch and generator state: losses "
          + ", ".join(f"{a:.7f}/{b:.7f}" for a, b in losses)
          + f"; gradient error / leaf max worst per step "
          + ", ".join(f"{e:.3e}" for e in worst)
          + f" (tol {tol:g}); updated params error / leaf max "
          + ", ".join(f"{e:.3e}" for e in worst_p), flush=True)
    return max(worst)


def val_image_matches_plain(ctx, probe, device):
    """The last --tto entry's first val image through the kernels (as the
    run rendered it) against the same image through the plain versions
    from the same adapted params: rgb within 1e-4 but for at most
    EVAL_FLIP of the pixels, PSNR within 0.01 dB; then the kernel path's
    image once more, profiled."""
    import numpy as np

    from nerfsys_tpu_torch.pipelines.online.runtime_adapt import (
        default_chunk_rays,
        make_chunk_renderer,
        render_image,
    )

    kw, out = probe.evals[-1]
    frame = next(f for f in probe.frames if f["tto"] == kw["tto_steps"])
    md = frame["md"]

    def image(use_kernels):
        renderer = make_chunk_renderer(
            kw["cfg"], ray_samples=kw["ray_samples"], bg_policy="white",
            occ_state=kw["occ_state"], occ_importance=kw["occ_importance"],
            occ_probe_grid_res=kw["occ_probe_grid_res"],
            occ_hard_mask=kw["occ_hard_mask"],
            occ_probe_mask=kw["occ_probe_mask"],
            early_stop_eps=kw["render_early_stop"], device=device,
            use_kernels=use_kernels)
        return render_image(
            renderer, out["params"], kw["statics"], md,
            scene_aabb=kw["global_aabb"], near=kw["near"], far=kw["far"],
            chunk_rays=default_chunk_rays(kw["ray_samples"]))[0]

    t0 = time.perf_counter()
    plain = image(False)
    plain_s = time.perf_counter() - t0
    diff = np.abs(frame["pred"] - plain).max(axis=-1)
    share = float((diff > 1e-4).mean())
    pk = image_scores(frame["pred"], md, kw["color_space"], device)
    pp = image_scores(plain, md, kw["color_space"], device)
    print(f"eval: val image {md.W}x{md.H} at tto {kw['tto_steps']} through "
          f"kernels vs plain: rgb max error {float(diff.max()):.3e}, "
          f"{share:.5f} of pixels beyond 1e-4 (limit {EVAL_FLIP}); PSNR "
          f"{pk[0]:.4f} vs {pp[0]:.4f} dB, SSIM {pk[1]:.5f} vs {pp[1]:.5f}; "
          f"kernel path {frame['s']:.2f} s, plain path {plain_s:.2f} s",
          flush=True)
    if share > EVAL_FLIP or abs(pk[0] - pp[0]) > 0.01:
        raise SystemExit("eval: the val image through the kernels disagrees "
                         "with the plain path")
    profile_device("eval val image", lambda: image(True),
                   extra=f" ({md.W}x{md.H}, {kw['ray_samples']} samples, "
                   f"adapted params)", watch=(("plane_encode_fwd_kernel",),))


def lpips_graph_check(pred_lin, md, device, tmp):
    """The LPIPS graph on AlexNet-shaped random weights (written here with
    numpy) on the card against the same call on the CPU: a check of the
    graph, not a quality figure."""
    import numpy as np
    import torch

    from nerfsys_tpu_torch.ops.color_space import linear_to_srgb
    from nerfsys_tpu_torch.utils.metrics import lpips, load_lpips_weights

    rng = np.random.default_rng(SEED)
    arrs, cin = {}, 3
    for i, (cout, k) in enumerate(LPIPS_CFG):
        arrs[f"conv{i}/w"] = rng.normal(0, 0.05, (k, k, cin, cout)).astype(
            np.float32)  # HWIO, the converter's layout
        arrs[f"conv{i}/b"] = rng.normal(0, 0.01, cout).astype(np.float32)
        arrs[f"lin{i}/w"] = rng.uniform(0, 1, (1, 1, cout, 1)).astype(
            np.float32)
        cin = cout
    path = tmp / "lpips_random.npz"
    np.savez(path, **arrs)
    w = load_lpips_weights(str(path))
    pred = linear_to_srgb(torch.from_numpy(pred_lin))
    gt = torch.from_numpy(md.load_image().astype(np.float32) / 255.0)
    t0 = time.perf_counter()
    card = float(lpips(pred.to(device), gt.to(device), w))
    card_s = time.perf_counter() - t0
    cpu = float(lpips(pred, gt, w))
    err = abs(card - cpu) / max(abs(cpu), 1e-30)
    print(f"eval: LPIPS graph on random AlexNet-shaped weights (a check of "
          f"the graph, not a quality figure) on the {md.W}x{md.H} val image: "
          f"card {card:.7f} ({card_s:.2f} s) vs CPU {cpu:.7f}, relative "
          f"error {err:.3e} (tol 1e-4)", flush=True)
    if not err <= 1e-4:
        raise SystemExit("eval: the LPIPS graph on the card disagrees with "
                         "the CPU")


def eval_phase(device, tmp, run):
    """Phase: the runner's eval op (`runner.main`, configs/eval.json:
    96 samples, 4,000 support rays, tto 0, 1, 10) on the trainer phase's
    scene and best checkpoint (K=4 planes experts at bench width, soft
    importance occupancy R=128 L=4 restored from best.occ), over the
    scene's 2 val cameras at 1000x750; then a run at tto 0, 1 with the
    hard mask from the probe bits (a JSON copy of configs/eval.json with
    occ_no_hard_mask false, occ_probe_mask true: its adapt step and first
    val image against the plain path, no point query launched); then a
    --render_fast run (tto 0, 4) and one image each with early stop,
    coherent experts and a bake -> the launches of all runs."""
    import torch

    from nerfsys_tpu_torch.data.ram_rays import frame_rays

    t_phase = time.perf_counter()
    base = ["--op", "eval", "--configPath",
            str(Path(__file__).resolve().parent / "configs" / "eval.json"),
            "--data_path", str(tmp), "--data_dirname", "scene",
            "--mask_dirname", "g22", "--downscale", "1.0",
            "--checkpoint_path", str(run), "--prefix", "best",
            "--device", str(device)]
    last_tto = int(EVAL_TTO.split(",")[-1])
    ctx, probe = run_eval(base + ["--tto", EVAL_TTO, "--fname",
                                  str(tmp / "eval")], capture_tto=last_tto)
    P = ctx["P"]
    eval_checks("main run", ctx, probe, EVAL_KERNELS, len(EVAL_TTO.split(",")))
    md = ctx["test_metadata"][0]
    t0 = time.perf_counter()
    frame_rays(md.H, md.W, md.intrinsics, md.c2w, aabb=ctx["global_aabb"],
               near=P.near, far=P.far)
    raygen = time.perf_counter() - t0
    steps = [s["ms"] for s in probe.steps if s["tto"] == last_tto]
    frames = [f["s"] for f in probe.frames]
    occ = ctx["occ_state"]
    print(f"eval: main run (configs/eval.json: {P.ray_samples} samples, "
          f"{P.support_rays} support rays; checkpoint {P.prefix} @ step "
          f"{ctx['ckpt_state']['step']}, grids restored, "
          f"{int(occ['num_updates'])} updates, "
          f"{float(occ['binary'].float().mean()):.4f} of cells occupied) "
          f"over {len(ctx['test_metadata'])} val cameras {md.W}x{md.H}: "
          f"{eval_rows_text(ctx)}", flush=True)
    every = [s["ms"] for s in probe.steps]
    print(f"eval: ms per adapt step (host clock to a synchronize) median "
          f"{median(steps):.2f} of the tto={last_tto} run's {len(steps)} "
          f"(all {len(every)}: min {min(every):.2f}, max {max(every):.2f}); "
          f"s per rendered "
          f"image median {median(frames):.3f} of {len(frames)} (min "
          f"{min(frames):.3f}, {md.W * md.H / median(frames):.0f} rays/s), of "
          f"which host ray generation (native) {raygen:.3f} s; launches "
          f"{probe.launches}", flush=True)
    live_psnr = image_scores(probe.frames[0]["pred"], md, P.color_space,
                             device)[0]
    adapt_steps_match(probe, device)
    c = probe.captured[0]
    step = probe.step_args
    from nerfsys_tpu_torch.pipelines.online.runtime_adapt import (
        make_adapt_step,
    )

    adapt = make_adapt_step(step[0], step[1], **step[2])
    gen = torch.Generator(device=device)
    gen.set_state(c["gen_state"])
    profile_device("eval adapt step", lambda: adapt(
        c["params"], c["opt_state"], c["statics"], c["rays"], c["rgbs"], gen,
        c["occ"]), extra=f" (one adapt step: {P.support_rays} rays x "
        f"{P.ray_samples} samples, Adam)",
        watch=(("plane_encode_fwd_kernel",), ("volume_render_bwd_kernel",)))
    val_image_matches_plain(ctx, probe, device)
    lpips_graph_check(probe.frames[0]["pred"], md, device, tmp)
    launches = dict(probe.launches)
    soft0 = probe.frames[0]["pred"]  # the first val image at tto 0
    del ctx, probe, c, adapt
    torch.cuda.empty_cache()

    # the hard mask from the probes' interval bits: a JSON copy of
    # configs/eval.json (its mode keys win over the checkpoint's)
    bits_json = tmp / "eval_probe.json"
    bits_json.write_text(json.dumps(dict(
        json.loads(Path(base[base.index("--configPath") + 1]).read_text()),
        occ_no_hard_mask=False, occ_probe_mask=True)))
    bits_base = list(base)
    bits_base[base.index("--configPath") + 1] = str(bits_json)
    ctx, probe = run_eval(bits_base + ["--tto", "0,1", "--fname",
                                       str(tmp / "eval_probe")],
                          capture_tto=1)
    eval_checks("probe bits", ctx, probe, EVAL_KERNELS, 2)
    P = ctx["P"]
    if not P.occ_probe_mask or P.occ_no_hard_mask or \
            probe.launches["occupancy_query"]:
        raise SystemExit(f"eval: probe bits: occ_probe_mask "
                         f"{P.occ_probe_mask}, occ_no_hard_mask "
                         f"{P.occ_no_hard_mask}, the point query launched "
                         f"{probe.launches['occupancy_query']} times")
    frames = [f["s"] for f in probe.frames]
    diff = float(abs(probe.frames[0]["pred"] - soft0).max())
    print(f"eval: probe bits run (hard mask from the probes' interval bits, "
          f"tto 0,1): {eval_rows_text(ctx)}; its first image at tto 0 "
          f"against the soft main run's: rgb max difference {diff:.3e}; s "
          f"per rendered image median {median(frames):.3f} of "
          f"{len(frames)}; launches {probe.launches}", flush=True)
    adapt_steps_match(probe, device)
    val_image_matches_plain(ctx, probe, device)
    launches = {k: v + probe.launches[k] for k, v in launches.items()}
    del ctx, probe
    torch.cuda.empty_cache()

    # --render_fast: bucketed top-1 adaptation and rendering
    ctx, probe = run_eval(base + ["--render_fast", "--tto", EVAL_FAST_TTO,
                                  "--fname", str(tmp / "eval_fast")])
    eval_checks("render_fast", ctx, probe, ("bucket_dispatch",),
                len(EVAL_FAST_TTO.split(",")))
    a_calls = sum(s["calls"] for s in probe.steps)
    a_dense = sum(s["dense"] for s in probe.steps)
    r_calls = sum(f["calls"] for f in probe.frames)
    r_dense = sum(f["dense"] for f in probe.frames)
    n = probe.launches
    print(f"eval: render_fast run (top-1 buckets, cf "
          f"{ctx['cfg'].capacity_factor}, union grid res "
          f"{ctx['P'].occ_union_probe_res}): {eval_rows_text(ctx)}; adapt "
          f"steps "
          f"{len(probe.steps)}: container calls {a_calls}, dense fallbacks "
          f"{a_dense}; rendering: calls {r_calls}, dense fallbacks "
          f"{r_dense}; launches bucket_dispatch {n['bucket_dispatch']}, "
          f"bucket_combine_fwd {n['bucket_combine_fwd']}, bucket_combine_bwd "
          f"{n['bucket_combine_bwd']}", flush=True)
    if (a_calls > a_dense and n["bucket_combine_bwd"] <= 0) or (
            a_calls + r_calls > a_dense + r_dense
            and n["bucket_combine_fwd"] <= 0):
        raise SystemExit("eval: render_fast: a call within capacity "
                         "launched no blend (10a-ii) or no transpose "
                         "(10a-iii)")
    launches = {k: v + n[k] for k, v in launches.items()}
    del ctx, probe
    torch.cuda.empty_cache()

    # one image each: early stop, coherent experts, a bake
    one = ["--tto", "0", "--cap_images", "1"]
    for label, flags, need in (
            ("early stop", ["--render_early_stop", "1e-4"],
             ("composite_segment",)),
            ("coherent", ["--render_coherent"], ("coherent_expert",)),
            ("baked", ["--render_baked", str(BAKE_R),
                       "--render_baked_occ"],
             ("baked_trilerp",))):
        ctx, probe = run_eval(base + one + flags + [
            "--fname", str(tmp / f"eval_{label.replace(' ', '_')}")])
        eval_checks(label, ctx, probe, need, 1)
        st, row = probe.frames[0]["stats"], ctx["rows"][0]
        if label == "early stop":
            done = st.get("n_terminated", 0) + st.get("n_resumed", 0)
            detail = (f"{st.get('n_terminated', 0)} of {done} rays end in "
                      f"the first segment "
                      f"({st.get('n_terminated', 0) / max(done, 1):.4f}), "
                      f"{st.get('resume_calls', 0)} resume calls, mode "
                      f"{st.get('mode')}")
        elif label == "coherent":
            detail = (f"n_coherent {st.get('n_coherent')}, n_boundary "
                      f"{st.get('n_boundary')}, rays_padded "
                      f"{st.get('rays_padded')}")
        else:
            detail = (f"bake {probe.bake.get('s', float('nan')):.2f} s, alive "
                      f"share {probe.bake.get('alive', float('nan')):.4f}")
        print(f"eval: {label}, one image at tto 0: PSNR {row['psnr']:.4f} "
              f"(live render {live_psnr:.4f}), SSIM {row['ssim']:.5f}, "
              f"{probe.frames[0]['s']:.3f} s; {detail}; launches "
              + str({k: probe.launches[k] for k in need}), flush=True)
        if label == "coherent" and abs(row["psnr"] - live_psnr) > 0.01:
            raise SystemExit("eval: coherent dispatch is exact, but its PSNR "
                             "differs from the live render's")
        launches = {k: v + probe.launches[k] for k, v in launches.items()}
        del ctx, probe
        torch.cuda.empty_cache()
    print(f"eval: phase took {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return launches


VIDEO_FRAMES = 6
VIDEO_LIVE_KERNELS = ("plane_encode_fwd", "occupancy_probe_cdf",
                      "sample_tvals_from_cdf", "volume_render_fwd")


class VideoProbe:
    """What chip_smoke reads of a `runner.main(["--op", "video", ...])`
    run, through wrappers on video_gen's names (`attach`): the renderer it
    built (factory and arguments), the host clock at each frame's start
    (the camera renderer's call on the pose path, `frame_rays` on the
    host-ray path) and at the writer, each frame's host ray generation,
    the first frame's renderer inputs and output, the frames and the path
    written."""

    def __init__(self):
        self.starts, self.raygen = [], []
        self.factory = self.first = self.frames = self.path = None
        self.t_end = self.write_s = None

    def camera_renderer(self, name):
        def make(fn):
            def build(*a, **kw):
                self.factory = (name, fn, a, dict(kw))
                render = fn(*a, **kw)

                def wrapped(params, statics, c2w, intr, *extra):
                    self.starts.append(time.perf_counter())
                    out = render(params, statics, c2w, intr, *extra)
                    if self.first is None:
                        self.first = dict(args=(params, statics, c2w, intr),
                                          out=out)
                    return out
                return wrapped
            return build
        return make

    def chunk_renderer(self, name):
        def make(fn):
            def build(*a, **kw):
                self.factory = (name, fn, a, dict(kw))
                return fn(*a, **kw)
            return build
        return make

    def frame_rays(self, fn):
        def wrapped(*a, **kw):
            t0 = time.perf_counter()
            self.starts.append(t0)
            out = fn(*a, **kw)
            self.raygen.append(time.perf_counter() - t0)
            return out
        return wrapped

    def render_rays_chunked(self, fn):
        def wrapped(renderer, params, statics, rays, chunk_rays, **kw):
            out = fn(renderer, params, statics, rays, chunk_rays, **kw)
            if self.first is None:
                self.first = dict(args=(params, statics, rays.copy(),
                                        chunk_rays), kw=dict(kw), out=out)
            return out
        return wrapped

    def write_video(self, fn):
        def wrapped(frames, *a, **kw):
            self.t_end = time.perf_counter()
            self.frames = list(frames)
            self.path = fn(frames, *a, **kw)
            self.write_s = time.perf_counter() - self.t_end
            return self.path
        return wrapped

    def attach(self, stack):
        from nerfsys_tpu_torch.models import baked
        from nerfsys_tpu_torch.pipelines import video_gen as vg

        for module, attr, make in (
                (vg, "make_live_camera_renderer",
                 self.camera_renderer("live camera")),
                (baked, "make_baked_camera_renderer",
                 self.camera_renderer("baked camera")),
                (vg, "make_chunk_renderer", self.chunk_renderer("chunk")),
                (vg, "make_coherent_renderer",
                 self.chunk_renderer("coherent")),
                (vg, "frame_rays", self.frame_rays),
                (vg, "render_rays_chunked", self.render_rays_chunked),
                (vg, "write_video", self.write_video)):
            stack.enter_context(patched(module, attr, make))
        return self

    def frame_ms(self):
        """Host ms of each frame, start to start (the last to the
        writer)."""
        t = self.starts + [self.t_end]
        return [1e3 * (b - a) for a, b in zip(t, t[1:])]


def run_video(argv):
    """runner.main(argv) for the video op with a VideoProbe attached ->
    (ctx, probe); the launch counters are zeroed just before and read
    just after."""
    from nerfsys_tpu_torch import kernels, runner

    with contextlib.ExitStack() as stack:
        probe = VideoProbe().attach(stack)
        kernels.reset_launches()
        ctx = runner.main(list(argv) + list(REHEARSAL_EXTRA))
        probe.launches = kernels.launches()
    return ctx, probe


def video_matches_plain(label, ctx, probe):
    """The run's first frame rendered again through the plain versions
    from the same params and inputs (the renderer rebuilt from the
    factory's arguments with use_kernels=False). Fog suppression sets
    most pixels of these frames to the background whatever the field
    computed, so the outputs before the frame tail are held first: rgb,
    depth and acc of every ray within the serve tolerances on all but
    CAMERA_FLIP of the rays (on the pose path both renderers rebuilt with
    map_outputs=None, out_u8=False; on the host-ray path the run's own
    chunk outputs); then the uint8 frames (host rays through the same
    tail) within 1 level on all but CAMERA_FLIP of the pixels."""
    from nerfsys_tpu_torch.pipelines import video_gen as vg

    name, fn, a, kw = probe.factory
    plain = fn(*a, **dict(kw, use_kernels=False))
    t0 = time.perf_counter()
    if "camera" in name:
        raw = dict(kw, map_outputs=None, out_u8=False)
        args = probe.first["args"]
        got_planes = fn(*a, **raw)(*args)
        want_planes = fn(*a, **dict(raw, use_kernels=False))(*args)
        want = plain(*args)
    else:
        params, statics, rays, chunk_rays = probe.first["args"]
        got_planes = probe.first["out"]
        want_planes = vg.render_rays_chunked(plain, params, statics, rays,
                                             chunk_rays, **probe.first["kw"])
        P = ctx["P"]
        md = ctx["test_metadata"][0]
        want = vg.host_frame_u8(want_planes, md.H, md.W,
                                not getattr(P, "no_suppress_fog", False))
    plain_s = time.perf_counter() - t0
    chunk_matches_plain(f"video: {label}: frame 0", planes_of(got_planes),
                        planes_of(want_planes), CAMERA_FLIP,
                        f"kernels vs plain before the frame tail "
                        f"({plain_s:.2f} s)")
    share = u8_within_one(f"video: {label}: frame 0 vs the plain path",
                          probe.frames[0], want)
    if share < 1.0 - CAMERA_FLIP:
        raise SystemExit(f"video: {label}: the frame disagrees with the "
                         f"plain path")
    return share


def video_phase(device, tmp, run):
    """Phase: the runner's video op (`runner.main(["--op", "video",
    ...])`, configs/eval.json: 96 samples) on the trainer phase's scene
    and `best` checkpoint (K=4 planes experts at bench width, grids
    restored), VIDEO_FRAMES frames at the val cameras' 1000x750: the
    turntable with the hard mask on (configs/eval.json plus
    occ_no_hard_mask false: the host-ray two-wave path, the point query
    11q), the same with occ_probe_mask true (the probe bits: 11q must not
    launch), full_coverage soft (the live camera renderer with the fused fog tail), the turntable
    baked at 256³ with --render_baked_occ (the baked camera renderer) and
    through --render_coherent (coherent dispatch over host rays). Checks:
    every frame uint8 of the val cameras' shape and not constant, the
    output written, each run's kernels launched; the first frame of the
    pose-path and the two host-ray runs against the plain path -> the
    launches of all runs."""
    import json

    import torch

    t_phase = time.perf_counter()
    root = Path(__file__).resolve().parent
    hard, probe_bits = tmp / "video_hard.json", tmp / "video_probe.json"
    cfg_json = json.loads((root / "configs" / "eval.json").read_text())
    hard.write_text(json.dumps(dict(cfg_json, occ_no_hard_mask=False)))
    probe_bits.write_text(json.dumps(dict(cfg_json, occ_no_hard_mask=False,
                                          occ_probe_mask=True)))
    base = ["--op", "video", "--data_path", str(tmp), "--data_dirname",
            "scene", "--mask_dirname", "g22", "--downscale", "1.0",
            "--checkpoint_path", str(run), "--prefix", "best",
            "--video_frames", str(VIDEO_FRAMES), "--device", str(device)]
    eval_json = str(root / "configs" / "eval.json")
    runs = (
        ("host-ray two-wave", ["--configPath", str(hard), "--camera_path",
                               "turntable"],
         VIDEO_LIVE_KERNELS + ("occupancy_query",), "chunk"),
        ("probe-bit two-wave", ["--configPath", str(probe_bits),
                                "--camera_path", "turntable"],
         VIDEO_LIVE_KERNELS, "chunk"),
        ("pose path", ["--configPath", eval_json, "--camera_path",
                       "full_coverage", "--occ_no_hard_mask"],
         VIDEO_LIVE_KERNELS, "live camera"),
        ("baked", ["--configPath", eval_json, "--camera_path", "turntable",
                   "--render_baked", str(BAKE_R),
                   "--render_baked_occ"],
         ("baked_trilerp", "volume_render_fwd"), "baked camera"),
        ("coherent", ["--configPath", eval_json, "--camera_path",
                      "turntable", "--render_coherent"],
         ("coherent_expert",) + VIDEO_LIVE_KERNELS, "coherent"),
    )
    launches = None
    for label, flags, need, factory in runs:
        t0 = time.perf_counter()
        ctx, probe = run_video(base + flags + [
            "--fname", str(tmp / f"video_{label.split()[0]}")])
        run_s = time.perf_counter() - t0
        md = ctx["test_metadata"][0]
        frames, path = probe.frames, Path(ctx["video_path"])
        if probe.factory is None or probe.factory[0] != factory:
            raise SystemExit(f"video: {label}: rendered through "
                             f"{probe.factory and probe.factory[0]}, "
                             f"expected {factory}")
        if len(frames) != VIDEO_FRAMES or not path.exists():
            raise SystemExit(f"video: {label}: {len(frames)} frames, "
                             f"{path} exists {path.exists()}")
        for f in frames:
            if f.dtype.name != "uint8" or f.shape != (md.H, md.W, 3) or \
                    int(f.min()) == int(f.max()):
                raise SystemExit(f"video: {label}: frame {f.dtype} "
                                 f"{f.shape} range {f.min()}-{f.max()}")
        for k in need:
            if probe.launches[k] <= 0:
                raise SystemExit(f"video: {label}: kernel {k} never "
                                 f"launched")
        if label.startswith("probe-bit") and (
                probe.launches["occupancy_query"]
                or not ctx["P"].occ_probe_mask):
            raise SystemExit(f"video: {label}: occ_probe_mask "
                             f"{ctx['P'].occ_probe_mask}, the point query "
                             f"launched {probe.launches['occupancy_query']} "
                             f"times")
        ms = probe.frame_ms()
        writer = ("mp4 through imageio" if path.suffix == ".mp4"
                  else "PNG sequence (no mp4 encoder)")
        raygen = (f"; host ray generation per frame (native) median "
                  f"{1e3 * median(probe.raygen):.2f} ms"
                  if probe.raygen else "")
        print(f"video: {label} ({factory} renderer, --camera_path "
              f"{ctx['P'].camera_path}): {len(frames)} frames {md.W}x{md.H} "
              f"written as {writer} to {path.name} "
              f"({probe.write_s:.2f} s); ms per frame (host clock, start to "
              f"start) median {median(ms):.2f}, min {min(ms):.2f}, all "
              f"{[round(x, 2) for x in ms]}{raygen}; mean uint8 "
              f"{float(sum(f.mean() for f in frames) / len(frames)):.2f}; "
              f"run {run_s:.2f} s; launches "
              + str({k: probe.launches[k] for k in need}), flush=True)
        if label in ("host-ray two-wave", "probe-bit two-wave",
                     "pose path"):
            video_matches_plain(label, ctx, probe)
        launches = (dict(probe.launches) if launches is None else
                    {k: v + probe.launches[k] for k, v in launches.items()})
        del ctx, probe, frames
        torch.cuda.empty_cache()
    print(f"video: phase took {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return launches


def profile_frame(renderer, params, statics, md, aabb, chunk,
                  label="frame", numpy_raygen=False):
    """Where one served frame's time goes: host ray generation (the
    native generator; with numpy_raygen also its numpy version), and the
    device time by kernel (one extra frame, after the launch counts were
    read)."""
    from nerfsys_tpu_torch.data.ram_rays import frame_rays
    from nerfsys_tpu_torch.pipelines.online.runtime_adapt import render_image

    t0 = time.perf_counter()
    frame_rays(md.H, md.W, md.intrinsics, md.c2w, aabb=aabb)
    raygen_ms = 1e3 * (time.perf_counter() - t0)
    extra = f" host_raygen_ms={raygen_ms:.2f}"
    if numpy_raygen:
        t0 = time.perf_counter()
        frame_rays(md.H, md.W, md.intrinsics, md.c2w, aabb=aabb,
                   native=False)
        extra += (f" (numpy path {1e3 * (time.perf_counter() - t0):.2f} ms; "
                  f"{host_text()})")
    profile_device(label, lambda: render_image(
        renderer, params, statics, md, scene_aabb=aabb, chunk_rays=chunk),
        extra=extra,
        watch=(("sample_tvals_kernel",), ("bucket_dispatch_kernel",),
               ("bucket_fill_kernel",), ("composite_segment_kernel",),
               ("coherent_expert_kernel",)))


SERVE_KERNELS = ("plane_encode_fwd", "occupancy_probe_cdf",
                 "sample_tvals_from_cdf", "volume_render_fwd",
                 "trunc_exp_fwd")
SERVE_POSES = ((0.0, 0.0, 2.0), (0.1, 0.0, 2.0), (0.0, -0.1, 2.1))
NATIVE_ROUTE_RAYS = 1_000_000  # trainer-scene rays the routers are held on


def host_text() -> str:
    """The host's machine type and cores (host times depend on them)."""
    import os
    import platform

    return (f"host {platform.machine()}, {os.cpu_count()} cores "
            f"({len(os.sched_getaffinity(0))} usable)")


def native_frame_check(statics):
    """`native:` lines: one SIDE x SIDE frame of serve()'s first pose
    through `frame_rays`, native and numpy (its plain version), in turns:
    host ms of each, the valid masks equal, o/d within 1e-5 and near/far
    on valid rays within 1e-4 + 1e-5 |x| (the reference's own test
    tolerances), the largest errors printed."""
    import numpy as np

    from nerfsys_tpu_torch.data.ram_rays import frame_rays

    md = pose(SERVE_POSES[0])
    aabb = statics.global_aabb.cpu().numpy()
    ms, out = {True: [], False: []}, {}
    for nat in (True, False, True, False):
        t0 = time.perf_counter()
        out[nat] = frame_rays(md.H, md.W, md.intrinsics, md.c2w, aabb=aabb,
                              native=nat)
        ms[nat].append(1e3 * (time.perf_counter() - t0))
    (rn, vn), (rp, vp) = out[True], out[False]
    same_valid = bool(np.array_equal(vn, vp))
    od = float(np.abs(rn[:, :6] - rp[:, :6]).max())
    nf_err = np.abs(rn[vn, 6:] - rp[vp, 6:]) if same_valid else None
    nf = float(nf_err.max()) if same_valid and vn.any() else float("inf")
    nf_ok = same_valid and bool(
        (nf_err <= 1e-4 + 1e-5 * np.abs(rp[vp, 6:])).all())
    print(f"native: {host_text()}; frame_rays {md.W}x{md.H} (serve pose 0) "
          f"host ms native {ms[True][0]:.2f} / {ms[True][1]:.2f}, numpy "
          f"{ms[False][0]:.2f} / {ms[False][1]:.2f} (in turns); valid masks "
          f"equal {same_valid} ({int(vn.sum())} of {vn.size} valid); o/d max "
          f"error {od:.3e} (tol 1e-5); near/far on valid rays max error "
          f"{nf:.3e} (tol 1e-4 + 1e-5 |x|)", flush=True)
    if not (same_valid and od <= 1e-5 and nf_ok):
        raise SystemExit("native: frame rays disagree with the numpy path")
    return min(ms[True]), min(ms[False])


def native_routing_check(rays, cell_dim: int):
    """`native:` lines: the exact DDA router (`route_rays_exact(policy=
    "dda")`) and the sampled router, native against numpy, on `rays`
    (NATIVE_ROUTE_RAYS of the trainer scene's first expert) over the
    region box and cells the TaskDataset infers: equal bit for bit, with
    both host times."""
    import numpy as np

    from nerfsys_tpu_torch.data.task_dataset import (
        route_rays_exact,
        route_rays_to_cells,
    )

    pts = rays[:, 0:3] + rays[:, 3:6] * rays[:, 6:7]
    pts = pts[np.isfinite(pts).all(axis=1)]
    aabb = np.stack([pts.min(0), pts.max(0)]).astype(np.float32)
    cells = (1, int(cell_dim), int(cell_dim))
    res = {}
    for name, fn in (
            ("dda", lambda nat: route_rays_exact(rays, aabb, cells,
                                                 policy="dda", native=nat)),
            ("sampled", lambda nat: route_rays_to_cells(
                rays, aabb, cells, rng=np.random.default_rng(SEED),
                native=nat))):
        got = {}
        for nat in (True, False):
            t0 = time.perf_counter()
            got[nat] = fn(nat)
            got[nat, "s"] = time.perf_counter() - t0
        diff = int((got[True] != got[False]).sum())
        res[name] = (got[True, "s"], got[False, "s"], diff)
        print(f"native: {name} router on {len(rays)} trainer rays, cells "
              f"{cells}: native {got[True, 's']:.3f} s, numpy "
              f"{got[False, 's']:.3f} s ({got[False, 's'] / got[True, 's']:.1f}"
              f"x); {diff} cells differ (bit-equal expected); hit rate "
              f"{float((got[True] >= 0).mean()):.4f}; {host_text()}",
              flush=True)
        if diff:
            raise SystemExit(f"native: the {name} router disagrees with "
                             f"its numpy version")
    return res


def chunk_matches_plain(label, got, ref, flip_share=0.0,
                        what="kernels vs plain on one chunk"):
    """One served chunk (rgb, depth, acc) through the kernels against the
    same chunk through the plain versions (or `what` else). flip_share:
    the share of rays allowed outside the tolerance, for hard-mask chunks,
    where a sample moved by an ulp across the exact occupancy boundary
    gains or loses its whole sigma."""
    rgb, depth, acc = (g.double() - r.double() for g, r in zip(got, ref))
    bad = ((rgb.abs() > 1e-4).any(dim=1) | (acc.abs() > 1e-4)
           | (depth.abs() > 1e-3))
    n_bad, n = int(bad.sum()), bad.shape[0]
    ok = ~bad
    errs = [float(x[ok].abs().max()) if bool(ok.any()) else 0.0
            for x in (rgb, depth, acc)]
    worst = [float(x.abs().max()) for x in (rgb, depth, acc)]
    print(f"{label}: {what}: rgb {errs[0]:.3e} "
          f"depth {errs[1]:.3e} acc {errs[2]:.3e} (tol rgb/acc 1e-4, depth "
          f"1e-3: encoder and cdf rounding move t by ulps through the "
          f"MLPs) on {n - n_bad} of {n} rays; {n_bad} rays beyond (allowed "
          f"{int(flip_share * n)}), worst rgb {worst[0]:.3e} depth "
          f"{worst[1]:.3e} acc {worst[2]:.3e}", flush=True)
    if n_bad > flip_share * n:
        raise SystemExit(f"{label}: {what}: the two disagree")


def serve(cfg, statics, params, occ, device, label="serve",
          need=SERVE_KERNELS, idle=()):
    """Phase 4: 3 requests of 800x800 frames through the port's entry
    points, the counters zeroed just before them and read just after:
    every kernel of `need` must have launched and none of `idle`."""
    import torch

    from nerfsys_tpu_torch import kernels
    from nerfsys_tpu_torch.data.ram_rays import frame_rays
    from nerfsys_tpu_torch.pipelines.online.runtime_adapt import (
        default_chunk_rays,
        make_chunk_renderer,
        render_image,
    )

    S = 32
    chunk = CHUNK or default_chunk_rays(S)
    aabb = statics.global_aabb.cpu().numpy()
    renderer = make_chunk_renderer(cfg, ray_samples=S, occ_state=occ,
                                   occ_importance=True, occ_hard_mask=False,
                                   device=device)
    poses = [pose(x) for x in SERVE_POSES]
    render_image(renderer, params, statics, poses[0], scene_aabb=aabb,
                 chunk_rays=chunk)  # warm-up
    torch.cuda.synchronize()

    kernels.reset_launches()
    times = []
    for md in poses:
        t0 = time.perf_counter()
        rgb, depth, acc = render_image(renderer, params, statics, md,
                                       scene_aabb=aabb, chunk_rays=chunk)
        times.append(time.perf_counter() - t0)
        check_frame("serve", rgb, depth, acc, (SIDE, SIDE, 3))
    launches = kernels.launches()
    print(f"{label}: launches during 3 requests {launches}", flush=True)
    for k in need:
        if launches[k] <= 0:
            raise SystemExit(f"{label}: kernel {k} never launched")
    for k in idle:
        if launches[k] != 0:
            raise SystemExit(f"{label}: kernel {k} launched")

    # one chunk through the kernels vs through the plain versions
    plain = make_chunk_renderer(cfg, ray_samples=S, occ_state=occ,
                                occ_importance=True, occ_hard_mask=False,
                                device=device, use_kernels=False)
    rays, _ = frame_rays(SIDE, SIDE, poses[0].intrinsics, poses[0].c2w,
                         aabb=aabb)
    chunk_rays = torch.from_numpy(rays[:chunk]).to(device)
    got = renderer(params, statics, chunk_rays)
    ref = plain(params, statics, chunk_rays)
    chunk_matches_plain(label, got, ref)

    profile_frame(renderer, params, statics, poses[0], aabb, chunk,
                  label=f"{label} frame", numpy_raygen=label == "serve")

    ms = [1e3 * t for t in times]
    n = SIDE * SIDE
    print(f"{label}: {SIDE}x{SIDE} frames ms={[round(x, 2) for x in ms]} "
          f"mean_ms={sum(ms) / 3:.2f} rays_per_s={n / (sum(times) / 3):.1f} "
          f"chunk_rays={chunk} mean_rgb={float(rgb.mean()):.4f} "
          f"mean_acc={float(acc.mean()):.4f}", flush=True)
    return launches


# the share of rays allowed beyond the serve tolerances when two renders
# generate their rays apart (the camera renderer on the card, render_image
# on the host): a probe point an ulp from a cell wall can take the other
# cell, which moves a soft ray's samples and adds or drops a hard-mask
# sample's sigma. Read on the H100 80GB HBM3 at 700 W: 705-805 of 640,000
# rays beyond in soft frames (0.11-0.13%), 987 in the hard-mask frame
# (0.15%), 0 with the union grid; 0.5% leaves 3x room over the worst
CAMERA_FLIP = 0.005


def planes_of(out):
    """Stacked (H*W, 5 or 7) planes -> (rgb, depth, acc) tensors."""
    import torch

    a = torch.from_numpy(out)
    return a[:, 0:3], a[:, 3], a[:, 4]


def frame_of(rgb, depth, acc):
    """render_image's (H, W, ...) arrays -> (rgb, depth, acc) tensors."""
    import torch

    return (torch.from_numpy(rgb.reshape(-1, 3)),
            torch.from_numpy(depth.reshape(-1)),
            torch.from_numpy(acc.reshape(-1)))


def u8_within_one(label, got, want) -> float:
    """The share of pixels whose uint8 channels lie within 1 level."""
    import numpy as np

    ok = (np.abs(got.astype(np.int16) - want.astype(np.int16)) <= 1).all(
        axis=-1)
    share = float(ok.mean())
    print(f"{label}: uint8 frames within 1 level in {share:.6f} of the "
          f"pixels", flush=True)
    return share


def camera(cfg, statics, params, occ, device):
    """Phase: the live camera renderer (`make_live_camera_renderer`, rays
    generated on the card, every chunk dispatched before the one fetch)
    with serve()'s settings (soft occupancy, importance, S=32, 65,536-ray
    chunks): one warm-up and 3 uint8 800x800 frames of serve()'s poses,
    the counters zeroed just before them and read just after (kernels 1-4
    must launch); the same poses through `render_image` (native rays on
    the host); wall ms per frame of both and one profiled frame of each. The
    float planes (out_u8=False) of each pose against render_image's
    outputs within the serve tolerances under CAMERA_FLIP; the uint8 frame
    against the camera renderer's plain path (use_kernels=False, the same
    rays) within 1 level in >= 99.9% of the pixels; one hard-mask frame
    in each form (point-exact through 11q, and with the probe bits; see
    `hard_forms`) and one with the res-128 union probe grid against
    render_image through the chunk renderer of the same mode, their
    launches counted with the 3 requests'."""
    import torch

    from nerfsys_tpu_torch import kernels
    from nerfsys_tpu_torch.pipelines.online.runtime_adapt import (
        default_chunk_rays,
        make_chunk_renderer,
        make_live_camera_renderer,
        render_image,
    )

    t_phase = time.perf_counter()
    S = 32
    chunk = CHUNK or default_chunk_rays(S)
    aabb = statics.global_aabb.cpu().numpy()
    soft = dict(occ_state=occ, occ_importance=True, occ_hard_mask=False)
    cam_kw = dict(H=SIDE, W=SIDE, ray_samples=S, chunk_rays=chunk,
                  scene_aabb=aabb, device=device)
    cam8 = make_live_camera_renderer(cfg, **cam_kw, **soft)
    poses = [pose(x) for x in SERVE_POSES]
    cam8(params, statics, poses[0].c2w, poses[0].intrinsics)  # warm-up
    torch.cuda.synchronize()

    kernels.reset_launches()
    cam_ms, frames = [], []
    for md in poses:
        t0 = time.perf_counter()
        frames.append(cam8(params, statics, md.c2w, md.intrinsics))
        cam_ms.append(1e3 * (time.perf_counter() - t0))
    launches = kernels.launches()
    print(f"camera: launches during 3 requests {launches}", flush=True)
    for k in SERVE_KERNELS:
        if launches[k] <= 0:
            raise SystemExit(f"camera: kernel {k} never launched")
    for img in frames:
        if img.dtype.name != "uint8" or img.shape != (SIDE, SIDE, 3):
            raise SystemExit(f"camera: frame {img.dtype} {img.shape}")

    ren = make_chunk_renderer(cfg, ray_samples=S, device=device, **soft)
    render_image(ren, params, statics, poses[0], scene_aabb=aabb,
                 chunk_rays=chunk)  # warm-up
    ri_ms, refs = [], []
    for md in poses:
        t0 = time.perf_counter()
        refs.append(render_image(ren, params, statics, md, scene_aabb=aabb,
                                 chunk_rays=chunk))
        ri_ms.append(1e3 * (time.perf_counter() - t0))

    camf = make_live_camera_renderer(cfg, **cam_kw, out_u8=False, **soft)
    for i, md in enumerate(poses):
        planes = camf(params, statics, md.c2w, md.intrinsics)
        check_frame("camera", planes[:, 0:3].reshape(SIDE, SIDE, 3),
                    planes[:, 3], planes[:, 4], (SIDE, SIDE, 3))
        chunk_matches_plain(f"camera pose {i}", planes_of(planes),
                            frame_of(*refs[i]), CAMERA_FLIP,
                            "camera frame vs render_image")
    plain8 = make_live_camera_renderer(cfg, **cam_kw, use_kernels=False,
                                       **soft)(params, statics,
                                               poses[0].c2w,
                                               poses[0].intrinsics)
    if u8_within_one("camera vs its plain path", frames[0], plain8) < 0.999:
        raise SystemExit("camera: uint8 frame disagrees with the plain path")
    import numpy as np

    ri8 = np.clip(refs[0][0] * 255.0 + 0.5, 0, 255).astype(np.uint8)
    u8_within_one("camera vs render_image", frames[0], ri8)

    hard = dict(occ_state=occ, occ_importance=True, occ_hard_mask=True)
    forms = {}
    for label, kw in (("hard mask", hard),
                      ("hard mask, probe bits",
                       dict(hard, occ_probe_mask=True)),
                      (f"union grid res {UNION_RES}",
                       dict(soft, occ_probe_grid_res=UNION_RES))):
        c2w, intr = poses[0].c2w, poses[0].intrinsics
        cam_x = make_live_camera_renderer(cfg, **cam_kw, out_u8=False, **kw)
        cam_x(params, statics, c2w, intr)
        torch.cuda.synchronize()
        kernels.reset_launches()
        t0 = time.perf_counter()
        planes = cam_x(params, statics, c2w, intr)
        x_ms = 1e3 * (time.perf_counter() - t0)
        x_launches = kernels.launches()
        for k, v in x_launches.items():
            launches[k] += v
        ren_x = make_chunk_renderer(cfg, ray_samples=S, device=device, **kw)
        ref = render_image(ren_x, params, statics, poses[0],
                           scene_aabb=aabb, chunk_rays=chunk)
        print(f"camera {label}: frame ms={x_ms:.2f} mean_acc="
              f"{float(planes[:, 4].mean()):.4f} occupancy_query launches "
              f"{x_launches['occupancy_query']}", flush=True)
        chunk_matches_plain(f"camera {label}", planes_of(planes),
                            frame_of(*ref), CAMERA_FLIP,
                            "camera frame vs render_image")
        if kw.get("occ_hard_mask"):
            forms[label] = hard_forms(
                label, cfg, params, statics, poses[0], aabb, chunk, cam_kw,
                kw, (planes, ref, x_ms, x_launches, cam_x, ren_x), device)
    hard_forms_text(forms)

    cam_busy = profile_device("camera frame", lambda: cam8(
        params, statics, poses[0].c2w, poses[0].intrinsics))
    ri_busy = profile_device("camera render_image frame", lambda: render_image(
        ren, params, statics, poses[0], scene_aabb=aabb, chunk_rays=chunk))
    print(f"camera: {SIDE}x{SIDE} uint8 frames ms="
          f"{[round(x, 2) for x in cam_ms]} mean_ms={sum(cam_ms) / 3:.2f} "
          f"rays_per_s={SIDE * SIDE / (sum(cam_ms) / 3e3):.1f}; render_image "
          f"ms={[round(x, 2) for x in ri_ms]} mean_ms={sum(ri_ms) / 3:.2f}; "
          f"device busy ms of one profiled frame: camera {cam_busy:.2f}, "
          f"render_image {ri_busy:.2f}; phase took "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    return launches


def hard_forms(label, cfg, params, statics, md, aabb, chunk, cam_kw, kw,
               drawn, device):
    """One hard-mask form (point-exact, or with the probe bits) of the
    camera phase: its camera frame and its live frame (render_image through
    the two-wave chunk renderer) against their plain paths (the same
    renderers with use_kernels=False) within the serve tolerances under
    CAMERA_FLIP; the point query (11q) must launch in the point-exact form
    and must not in the probe-bit form. `drawn`: the camera frame's planes,
    the live frame, the camera frame's ms and launches, and the two
    renderers. Returns (camera ms, camera busy, live ms, live busy, 11q
    launches)."""
    import torch

    from nerfsys_tpu_torch.pipelines.online.runtime_adapt import (
        make_chunk_renderer,
        make_live_camera_renderer,
        render_image,
    )

    planes, ref, cam_ms, cam_launches, cam_x, ren_x = drawn
    n_query = cam_launches["occupancy_query"]
    if (n_query > 0) == bool(kw.get("occ_probe_mask")):
        raise SystemExit(f"camera {label}: occupancy_query launched "
                         f"{n_query} times: expected "
                         f"{'none' if kw.get('occ_probe_mask') else 'some'}")
    plain = make_live_camera_renderer(cfg, **cam_kw, out_u8=False,
                                      use_kernels=False, **kw)(
        params, statics, md.c2w, md.intrinsics)
    chunk_matches_plain(f"camera {label}", planes_of(planes),
                        planes_of(plain), CAMERA_FLIP,
                        "camera frame vs its plain path")
    ren_p = make_chunk_renderer(cfg, ray_samples=cam_kw["ray_samples"],
                                device=device, use_kernels=False, **kw)
    live_plain = render_image(ren_p, params, statics, md, scene_aabb=aabb,
                              chunk_rays=chunk)
    chunk_matches_plain(f"live {label}", frame_of(*ref),
                        frame_of(*live_plain), CAMERA_FLIP,
                        "render_image frame vs its plain path")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    render_image(ren_x, params, statics, md, scene_aabb=aabb,
                 chunk_rays=chunk)
    live_ms = 1e3 * (time.perf_counter() - t0)
    cam_busy = profile_device(f"camera {label} frame", lambda: cam_x(
        params, statics, md.c2w, md.intrinsics))
    live_busy = profile_device(f"live {label} frame", lambda: render_image(
        ren_x, params, statics, md, scene_aabb=aabb, chunk_rays=chunk))
    return cam_ms, cam_busy, live_ms, live_busy, n_query


def hard_forms_text(forms) -> None:
    """The camera phase's two hard-mask forms side by side."""
    print("camera: hard-mask forms of one 800x800 frame, side by side: "
          + "; ".join(f"{label}: camera ms={c_ms:.2f} device busy "
                      f"{c_busy:.2f} ms, live (render_image) ms="
                      f"{l_ms:.2f} device busy {l_busy:.2f} ms, "
                      f"occupancy_query launches {n}"
                      for label, (c_ms, c_busy, l_ms, l_busy, n)
                      in forms.items()), flush=True)


ES_EPS = 1e-4  # nerfacc's default early_stop_eps
ES_SEG = 8  # the first segment: ray_samples // 4
# sigma_scale at which the random-init field reaches trained-scene opacity
# (measure_perf.py:491-494): at 25 most valid rays of the serve frames end
# after the first segment; the early-stop phase prints that share and
# requires at least half
OPAQUE = 25.0
SKY = 0.5  # the share of sky rays in the hard-mask frame
ES_KERNELS = ("plane_encode_fwd", "occupancy_probe_cdf",
              "sample_tvals_from_cdf", "composite_segment")


def check_segment_kernel(cfg, statics, params, occ, rays_np, device,
                         results):
    """Kernel row 8 against its plain version on the card: one serve chunk's
    first segment (65,536 rays x 8 samples, fresh carry) and one resume
    slice (16,384 rays x 24 samples, the first segment's carry), fog off
    and on, at the random-init density and the opaque one. The inputs come
    from the slice's own probe (soft, importance), sampler and field; t and
    dt are column slices of the (N, 32) sample arrays. Then the 8 + 24
    split, finalized, against kernel 4's one-shot volume_render on the same
    samples, and `composite_edge_cases`."""
    import torch

    from nerfsys_tpu_torch import kernels
    from nerfsys_tpu_torch.models.container import container_apply
    from nerfsys_tpu_torch.models.occupancy import _ray_validity
    from nerfsys_tpu_torch.ops import occupancy as O
    from nerfsys_tpu_torch.ops import volrend as V
    from nerfsys_tpu_torch.ops.activations import clip

    S, s1, cap = 32, ES_SEG, CHECK_RAYS // 4
    rays = torch.from_numpy(rays_np).to(device)
    o, d = rays[:, 0:3].contiguous(), rays[:, 3:6].contiguous()
    valid, near, far = _ray_validity(rays)
    N = rays.shape[0]
    cdf = O.occupancy_probe_cdf(occ["occs"], occ["binary"],
                                statics.expert_aabbs, o, d, near, far, 128,
                                importance=True, ray_floor=0.25)
    t_vals, _ = O.sample_tvals_from_cdf(cdf, near, far, S)
    dists = V.full_dists(t_vals)
    pts = V.t_to_points(o, d, t_vals).reshape(-1, 3)
    with torch.no_grad():
        rgb, sigma = container_apply(params, cfg, statics, pts,
                                     d[:, None, :].expand(N, S, 3)
                                     .reshape(-1, 3))
    rgb = clip(rgb.reshape(N, S, 3), 0.0, 1.0)
    sigma = torch.clamp(torch.where(valid[:, None], sigma.reshape(N, S),
                                    0.0), min=0.0)
    bg = torch.rand((N, 3), device=device)
    ids = torch.arange(cap, device=device)
    tol, worst, timed = 1e-5, 0.0, None
    for scale in (1.0, OPAQUE):
        sig = sigma * scale
        seg1 = (rgb[:, :s1].contiguous(), sig[:, :s1].contiguous(),
                t_vals[:, :s1], dists[:, :s1])
        seg2 = (rgb[:cap, s1:].contiguous(), sig[:cap, s1:].contiguous(),
                t_vals[:cap, s1:], dists[:cap, s1:])
        for fog in (False, True):
            fresh = V.composite_init(N, fog=fog, device=device)
            first = V.composite_segment(fresh, *seg1)
            want = V.composite_segment_plain(fresh, *seg1)
            carry = {k: v.index_select(0, ids) for k, v in first.items()}
            rest = V.composite_segment(carry, *seg2)
            rest_want = V.composite_segment_plain(carry, *seg2)
            torch.cuda.synchronize()
            errs = [max(max_err(a[k], b[k]) for k in a)
                    for a, b in ((first, want), (rest, rest_want))]
            # the 8 + 24 split against kernel 4's one-shot, every ray
            full = V.composite_segment(first, rgb[:, s1:].contiguous(),
                                       sig[:, s1:].contiguous(),
                                       t_vals[:, s1:], dists[:, s1:])
            split = V.composite_finalize(full, bg)
            one = V.volume_render_kernel(
                torch.cat([rgb, sigma[..., None]], dim=-1), t_vals, bg,
                sigma_scale=scale)
            split_err = (max_err(split[0], one[0]), max_err(split[2], one[3]),
                         rel_err(split[1], one[1]))
            print(f"kernel composite_segment: sigma_scale={scale:g} "
                  f"fog={fog} first segment {N}x{s1} max_abs_err="
                  f"{errs[0]:.3e}, resume slice {cap}x{S - s1} max_abs_err="
                  f"{errs[1]:.3e} (tol {tol:g}); 8+24 split vs "
                  f"volume_render_fwd one-shot: rgb {split_err[0]:.3e} acc "
                  f"{split_err[1]:.3e} depth/max {split_err[2]:.3e} (tol "
                  f"{tol:g})", flush=True)
            if not max(errs) <= tol:
                raise SystemExit(f"kernel composite_segment disagrees with "
                                 f"its plain version: {errs} > {tol}")
            if not max(split_err) <= tol:
                raise SystemExit("the 8 + 24 segment split disagrees with "
                                 f"kernel 4's one-shot: {split_err}")
            worst = max(worst, *errs)
            if scale == 1.0 and not fog:
                timed = (seg1, fresh, first, seg2, carry, rest)
    seg1, fresh, first, seg2, carry, rest = timed
    rows = []
    for label, c, args, out, n in (("first segment", fresh, seg1, first, N),
                                   ("resume slice", carry, seg2, rest, cap)):
        ms = cuda_ms(lambda: V.composite_segment(c, *args), 20)
        dev = device_ms(lambda: V.composite_segment(c, *args))
        plain_ms = cuda_ms(lambda: V.composite_segment_plain(c, *args), 5)
        n_bytes = nbytes(list(c.values()), args, list(out.values()))
        b_ms, b_by = bound(n_bytes, n * args[1].shape[1] * 24)
        rows.append((label, ms, dev, plain_ms, n_bytes, b_ms, b_by))
        print(f"kernel composite_segment: {label} {n}x{args[1].shape[1]} "
              f"fog=False kernel_ms={ms:.4f} (back to back) device_ms="
              f"{dev:.4f} plain_ms={plain_ms:.4f} bytes={n_bytes} bound_ms="
              f"{b_ms:.4f} ({b_by}) at {HBM_BYTES_PER_S / 1e12:g} TB/s; plan "
              f"{lane_plan_text(V.ray_lane_plan(n, args[1].shape[1], 1))}",
              flush=True)
    label, ms, dev, plain_ms, n_bytes, b_ms, b_by = rows[0]
    results[kernels.COMPOSITE_SEG.name] = dict(
        max_abs_err=worst, ms=dev, plain_ms=plain_ms, bound_ms=b_ms,
        bound_by=b_by,
        text=(f"max_abs_err={worst:.3e} tol={tol:g} (both shapes, fog off "
              f"and on, two densities; sums of 8-24 products in another "
              f"order than torch.sum) kernel_ms={dev:.4f} (the device time; "
              f"back to back {ms:.4f}) plain_ms={plain_ms:.4f} bytes="
              f"{n_bytes} bound_ms={b_ms:.4f} ({b_by}) at "
              f"{HBM_BYTES_PER_S / 1e12:g} TB/s (the first segment, "
              f"{N}x{s1}; resume slice device_ms={rows[1][2]:.4f}, back to "
              f"back {rows[1][1]:.4f}, bound_ms={rows[1][5]:.4f})"))
    composite_edges(device)


COMPOSITE_EDGE_N = 4096 + 13  # a tail past whole blocks at every plan


def composite_edge_inputs(kind: str, n: int, s: int, fog: bool,
                          layout: str, seed: int, device):
    """Adversarial inputs of row 8 from numpy seed `seed`: a carry (fog
    adds wmax and wlogw) and one segment, rgb (n, s, 3), sigma (n, s), t
    and dt (n, s). t and dt are columns 3 .. 3 + s of an (n, s + 9) sample
    set and of its `full_dists`: column slices ("slice", as the first
    segment passes them) or contiguous copies ("contiguous"). "clip" puts
    sigma * dt >= 20 on every second sample (alpha at 1 - 1e-7), "zero"
    sigma exactly 0 on the even rays and every third sample of the odd
    ones; "tc0", "tc1" and "tc_tiny" carry a transmittance of 0, 1 and
    1e-30; otherwise random."""
    import numpy as np
    import torch

    from nerfsys_tpu_torch.ops import volrend as V

    f32 = np.float32
    rng = np.random.default_rng(seed)
    t = np.sort(rng.uniform(0.1, 4.0, (n, s + 9)), axis=1).astype(f32)
    rgb = rng.uniform(0.0, 1.0, (n, s, 3)).astype(f32)
    sigma = rng.exponential(2.0, (n, s)).astype(f32)
    if kind == "clip":
        sigma[:, ::2] = 2e5
    elif kind == "zero":
        sigma[0::2] = 0.0
        sigma[1::2, ::3] = 0.0
    trans = rng.uniform(0.05, 1.0, n)
    trans = {"tc0": np.zeros(n), "tc1": np.ones(n),
             "tc_tiny": np.full(n, 1e-30)}.get(kind, trans)
    carry = {"rgb": rng.uniform(0.0, 0.5, (n, 3)),
             "depth": rng.uniform(0.0, 2.0, n),
             "acc": rng.uniform(0.0, 0.5, n), "trans": trans}
    if fog:
        carry["wmax"] = rng.uniform(0.0, 0.3, n)
        carry["wlogw"] = rng.uniform(-0.5, 0.0, n)
    carry = {key: torch.from_numpy(v.astype(f32)).to(device)
             for key, v in carry.items()}
    tt = torch.from_numpy(t).to(device)
    t_seg, d_seg = tt[:, 3:3 + s], V.full_dists(tt)[:, 3:3 + s]
    if layout == "contiguous":
        t_seg, d_seg = t_seg.contiguous(), d_seg.contiguous()
    return (carry, torch.from_numpy(rgb).to(device),
            torch.from_numpy(sigma).to(device), t_seg, d_seg)


def composite_edge_cases():
    """(label, kind, N, s, fog, layout) of `composite_edges`."""
    n = COMPOSITE_EDGE_N
    return ([(f"s={s}", "rand", n, s, False, "slice")
             for s in (1, 2, 8, 24, 31, 33, 64)]
            + [(f"s={s}, fog", "rand", n, s, True, "slice")
               for s in (1, 8, 24, 33, 64)]
            + [("alpha at its clip (sigma dt >= 17)", "clip", n, 8, False,
                "slice"),
               ("alpha at its clip, s=24, fog", "clip", n, 24, True,
                "slice"),
               ("alpha at its clip, s=64, fog", "clip", n, 64, True,
                "slice"),
               ("sigma exactly 0", "zero", n, 8, False, "slice"),
               ("sigma exactly 0, s=24, fog", "zero", n, 24, True, "slice"),
               ("T_carry 0", "tc0", n, 8, True, "slice"),
               ("T_carry 0, s=24", "tc0", n, 24, False, "contiguous"),
               ("T_carry 1", "tc1", n, 8, False, "slice"),
               ("T_carry 1, s=33, fog", "tc1", n, 33, True, "slice"),
               ("T_carry 1e-30", "tc_tiny", n, 8, True, "slice"),
               ("T_carry 1e-30, s=24", "tc_tiny", n, 24, False,
                "contiguous"),
               ("contiguous t and dt", "rand", n, 8, False, "contiguous"),
               ("contiguous t and dt, s=24, fog", "rand", n, 24, True,
                "contiguous"),
               ("contiguous t and dt, s=33", "rand", n, 33, False,
                "contiguous"),
               ("N=0", "rand", 0, 8, True, "slice"),
               ("N=1", "rand", 1, 8, False, "slice"),
               ("N=1, s=33, fog", "rand", 1, 33, True, "slice"),
               ("whole blocks only (N=4096), s=24", "rand", 4096, 24, False,
                "slice")])


def composite_edges(device):
    """Row 8 against its plain version on `composite_edge_cases` (every
    output within VR_EDGE_TOL), each line with its plan and device time."""
    import torch

    from nerfsys_tpu_torch.ops import volrend as V

    for seed, (label, kind, n, s, fog, layout) in enumerate(
            composite_edge_cases()):
        args = composite_edge_inputs(kind, n, s, fog, layout, seed, device)
        got = V.composite_segment(*args)
        want = V.composite_segment_plain(*args)
        torch.cuda.synchronize()
        if set(got) != set(want):
            raise SystemExit(f"edge composite_segment {label}: keys "
                             f"{sorted(got)} against {sorted(want)}")
        err = max((max_err(got[k], want[k]) for k in want if n), default=0.0)
        dev = device_ms(lambda: V.composite_segment(*args), 5) if n else 0.0
        print(f"edge composite_segment {label}: N={n} s={s} fog={fog} t/dt "
              f"{layout} max_abs_err={err:.3e} (tol {VR_EDGE_TOL:g}) "
              f"device_ms={dev:.4f}; plan "
              f"{lane_plan_text(V.ray_lane_plan(n, s, 1))}", flush=True)
        if not err <= VR_EDGE_TOL:
            raise SystemExit(f"edge composite_segment {label}: "
                             f"max_abs_err {err} > {VR_EDGE_TOL}")


def check_frame(label, rgb, depth, acc, shape):
    import numpy as np

    for name, a in (("rgb", rgb), ("depth", depth), ("acc", acc)):
        if not np.isfinite(a).all():
            raise SystemExit(f"{label}: non-finite {name}")
    for name, a in (("rgb", rgb), ("acc", acc)):
        if a.min() < -1e-5 or a.max() > 1 + 1e-5:
            raise SystemExit(f"{label}: {name} outside [0, 1]: "
                             f"[{a.min()}, {a.max()}]")
    if rgb.shape != shape:
        raise SystemExit(f"{label}: rgb shape {rgb.shape}")


def eps_errs(label, got, want, far_max):
    """Max differences (rgb, depth, acc) of an early-stop output from the
    one-shot's, held to the reference's bound for a terminated ray: rgb
    within 2 eps (the dropped tail and the background-weight shift, each
    <= eps), acc within eps, depth within eps * far; plus float32 slack."""
    errs = [float(abs(g - w).max()) for g, w in zip(got, want)]
    tols = (2 * ES_EPS + 1e-4, ES_EPS * far_max + 1e-3, ES_EPS + 1e-4)
    if not all(e <= t for e, t in zip(errs, tols)):
        raise SystemExit(f"{label}: early-stop output outside the eps bound "
                         f"of the one-shot: {errs} > {tols}")
    return errs, tols


def eps_text(errs, tols) -> str:
    return " ".join(f"{k} {e:.3e} (tol {t:.2e})"
                    for k, e, t in zip(("rgb", "depth", "acc"), errs, tols))


def sky_frame(n: int):
    """The hard-mask frame of measure_perf.measure_render (sky=0.5): rays
    from (0, 0, 2) in random downward directions, the last half from z=3
    pointing up, near/far 0.1/4.5 (scripts/measure_perf.py:497-527)."""
    import numpy as np

    rng = np.random.default_rng(0)
    o = np.tile(np.array([0.0, 0.0, 2.0], np.float32), (n, 1))
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d[:, 2] = -np.abs(d[:, 2]) - 0.5
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    i0 = int(n * (1.0 - SKY))
    o[i0:, 2] = 3.0
    d[i0:, 2] = np.abs(d[i0:, 2]) + 0.5
    d[i0:] /= np.linalg.norm(d[i0:], axis=1, keepdims=True)
    nf = np.tile(np.array([0.1, 4.5], np.float32), (n, 1))
    return np.concatenate([o, d, nf], 1)


def soft_early_stop(cfg, statics, params, occ, device, scale):
    """3 requests of 800x800 through `render_image` with the soft-mode
    early-stop renderer at `scale`, the counters zeroed just before them and
    read just after; then the same frames through the one-shot program."""
    import torch

    from nerfsys_tpu_torch import kernels
    from nerfsys_tpu_torch.data.ram_rays import frame_rays
    from nerfsys_tpu_torch.pipelines.online.runtime_adapt import (
        EarlyStopOccRenderer,
        make_chunk_renderer,
        render_image,
    )

    S = 32
    chunk = CHUNK or CHECK_RAYS
    aabb = statics.global_aabb.cpu().numpy()
    renderer = make_chunk_renderer(
        cfg, ray_samples=S, occ_state=occ, occ_importance=True,
        occ_hard_mask=False, early_stop_eps=ES_EPS, sigma_scale=scale,
        device=device)
    if not isinstance(renderer, EarlyStopOccRenderer) or (
            renderer.probe is not None):
        raise SystemExit("early-stop: expected the soft early-stop renderer")
    poses = [pose((0.0, 0.0, 2.0)), pose((0.1, 0.0, 2.0)),
             pose((0.0, -0.1, 2.1))]
    kw = dict(scene_aabb=aabb, chunk_rays=chunk)
    render_image(renderer, params, statics, poses[0], **kw)  # warm-up
    torch.cuda.synchronize()

    kernels.reset_launches()
    times, frames, stats = [], [], []
    for md in poses:
        st = {}
        t0 = time.perf_counter()
        frames.append(render_image(renderer, params, statics, md, stats=st,
                                   **kw))
        times.append(time.perf_counter() - t0)
        stats.append(st)
        check_frame("early-stop", *frames[-1], (SIDE, SIDE, 3))
    launches = kernels.launches()
    print(f"early-stop: soft sigma_scale={scale:g} launches during 3 "
          f"requests {launches}", flush=True)
    for k in ES_KERNELS:
        if launches[k] <= 0:
            raise SystemExit(f"early-stop: kernel {k} never launched")
    if launches["volume_render_fwd"] != 0:
        raise SystemExit("early-stop: the one-shot compositor ran during "
                         "the early-stop requests")

    full_times, worst, n_valid = [], [0.0, 0.0, 0.0], 0
    for md, got in zip(poses, frames):
        t0 = time.perf_counter()
        want = render_image(renderer.full, params, statics, md, **kw)
        full_times.append(time.perf_counter() - t0)
        check_frame("early-stop one-shot", *want, (SIDE, SIDE, 3))
        rays, valid = frame_rays(SIDE, SIDE, md.intrinsics, md.c2w,
                                 aabb=aabb)
        n_valid += int(valid.sum())
        errs, tols = eps_errs("early-stop", got, want,
                              float(rays[valid, 7].max()))
        worst = [max(a, b) for a, b in zip(worst, errs)]
    # invalid rays always end after the partial: count the valid ones
    term = (sum(s["n_terminated"] for s in stats)
            - (len(poses) * SIDE * SIDE - n_valid))
    if scale == OPAQUE and not term >= 0.5 * n_valid:
        raise SystemExit(f"early-stop: {term} of {n_valid} valid rays ended "
                         f"after the first segment at the opaque scale; "
                         f"need at least half")
    ms, full_ms = [1e3 * t for t in times], [1e3 * t for t in full_times]
    counts = " ".join(f"{k}={[s[k] for s in stats]}" for k in (
        "n_terminated", "n_resumed", "resume_calls"))
    print(f"early-stop: soft sigma_scale={scale:g} eps={ES_EPS:g} seg="
          f"{ES_SEG} {SIDE}x{SIDE} frames ms={[round(x, 2) for x in ms]} "
          f"mean_ms={sum(ms) / 3:.2f} one-shot ms="
          f"{[round(x, 2) for x in full_ms]} mean_ms={sum(full_ms) / 3:.2f} "
          f"skip_speedup={sum(full_ms) / sum(ms):.3f} mode="
          f"{stats[0]['mode']} {counts} terminated_share_of_valid="
          f"{term / max(n_valid, 1):.4f}", flush=True)
    print(f"early-stop: soft sigma_scale={scale:g} vs one-shot, worst of 3 "
          f"frames: {eps_text(worst, tols)}", flush=True)
    return renderer, launches


def hard_early_stop(cfg, statics, params, device):
    """The sky frame (640,000 rays, half sky) on measure_perf's sky grid
    through `render_rays_chunked` with the hard-mask two-wave renderer and
    the hard-mask early-stop renderer at the opaque scale, 3 requests each,
    the counters zeroed just before them and read just after."""
    import torch

    from nerfsys_tpu_torch import kernels
    from nerfsys_tpu_torch.pipelines.online.runtime_adapt import (
        EarlyStopOccRenderer,
        TwoWaveOccRenderer,
        make_chunk_renderer,
        render_rays_chunked,
    )

    S = 32
    chunk = CHUNK or CHECK_RAYS
    occ = synthetic_occ(statics, device, alive_frac=None)
    rays = sky_frame(SIDE * SIDE)
    far_max = float(rays[:, 7].max())
    total = {}
    for kind, scale, eps, cls in (
            ("two-wave", 1.0, 0.0, TwoWaveOccRenderer),
            ("early-stop", OPAQUE, ES_EPS, EarlyStopOccRenderer)):
        renderer = make_chunk_renderer(
            cfg, ray_samples=S, occ_state=occ, occ_importance=True,
            early_stop_eps=eps, sigma_scale=scale, device=device)
        if not isinstance(renderer, cls):
            raise SystemExit(f"hard mask: expected a {cls.__name__}")
        render_rays_chunked(renderer, params, statics, rays, chunk)  # warm
        torch.cuda.synchronize()
        kernels.reset_launches()
        times, outs, stats = [], [], []
        for _ in range(3):
            st = {}
            t0 = time.perf_counter()
            outs.append(render_rays_chunked(renderer, params, statics, rays,
                                            chunk, stats=st))
            times.append(time.perf_counter() - t0)
            stats.append(st)
        launches = kernels.launches()
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        t0 = time.perf_counter()
        want = render_rays_chunked(renderer.full, params, statics, rays,
                                   chunk)
        full_ms = 1e3 * (time.perf_counter() - t0)
        got = outs[-1]
        check_frame(f"hard {kind}", got[:, :3], got[:, 3], got[:, 4],
                    want[:, :3].shape)
        st = stats[-1]
        if st["chunks_skipped"] <= 0 and st.get("packed_chunks") is None:
            raise SystemExit(f"hard {kind}: no chunk skipped or packed: {st}")
        if kind == "two-wave":
            err = float(abs(got - want).max())
            text = f"max_abs_err vs one-shot {err:.3e} (tol 1e-5)"
            if not err <= 1e-5:
                raise SystemExit(f"hard two-wave: disagrees with the "
                                 f"one-shot: {err}")
        else:
            text = eps_text(*eps_errs(
                "hard early-stop", (got[:, :3], got[:, 3], got[:, 4]),
                (want[:, :3], want[:, 3], want[:, 4]), far_max))
            text += (f" n_terminated={st['n_terminated']} n_resumed="
                     f"{st['n_resumed']} resume_calls={st['resume_calls']}")
        ms = [1e3 * t for t in times]
        print(f"early-stop: hard {kind} sigma_scale={scale:g} sky frame "
              f"{rays.shape[0]} rays ms={[round(x, 2) for x in ms]} "
              f"mean_ms={sum(ms) / 3:.2f} one-shot_ms={full_ms:.2f} mode="
              f"{st['mode']} chunks_skipped={st['chunks_skipped']} n_alive="
              f"{st['n_alive']} packed_chunks={st.get('packed_chunks')} "
              f"launches {launches}; {text}", flush=True)

        if kind == "two-wave":  # one dead chunk: background program vs full
            sky = torch.from_numpy(rays[-chunk:]).to(device)
            dead_out = renderer.render_dead(params, statics, sky)
            full_out = renderer.full(params, statics, sky)
            err = max(max_err(a, b) for a, b in zip(dead_out, full_out))
            print(f"early-stop: dead chunk ({chunk} sky rays) through "
                  f"render_dead vs the one-shot max_abs_err={err:.3e} (tol "
                  f"1e-6, 0 expected)", flush=True)
            if not err <= 1e-6:
                raise SystemExit("hard two-wave: the dead program disagrees "
                                 "with the one-shot on a dead chunk")
    return total


def early_stop(cfg, statics, params, occ, rays_np, device, results):
    """Phase: live serving with early ray termination, and the hard-mask
    two-wave dispatch (kernel row 8 check, soft early-stop serve at two
    densities, the hard-mask sky frame, one profiled frame at each
    density)."""
    t0 = time.perf_counter()
    check_segment_kernel(cfg, statics, params, occ, rays_np, device,
                         results)
    total = {}
    renderers = {}
    for scale in (1.0, OPAQUE):
        renderers[scale], launches = soft_early_stop(cfg, statics, params,
                                                     occ, device, scale)
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
    for k, v in hard_early_stop(cfg, statics, params, device).items():
        total[k] += v
    for scale, renderer in renderers.items():
        profile_frame(renderer, params, statics, pose((0.0, 0.0, 2.0)),
                      statics.global_aabb.cpu().numpy(), CHUNK or CHECK_RAYS,
                      label=f"early-stop frame (soft, sigma_scale="
                            f"{scale:g})")
    print(f"early-stop: phase took {time.perf_counter() - t0:.1f} s",
          flush=True)
    return total


BAKE_R = 256  # the serve bake: 256³ SH-3, pack 8, sparse blocks of 8³
SMALL_R, F32_R = 64, 128  # the other two tables of kernel 8's check


def synthetic_occ(statics, device, alive_frac=0.35):
    """A ready occupancy state (K=4, R=64, L=2) whose cells in the bottom
    `alive_frac` of each expert's level box (along z) are alive: the serve
    configuration of the reference's baked-serve measurement
    (`_synthetic_occ_state(geometry=True, alive_frac=0.35)`). alive_frac
    None: the cells whose centres lie at z <= 2.2, below the level-0 box
    tops, the grid of its sky frame (`_synthetic_occ_state(geometry=True)`,
    scripts/measure_perf.py:416-452)."""
    import numpy as np
    import torch

    from nerfsys_tpu_torch.ops.occupancy import (
        OccGridConfig,
        init_occ_state,
        level_aabbs,
    )

    occ = init_occ_state(OccGridConfig(resolution=64, levels=2,
                                       warmup_steps=0), 4, device=device)
    K, L, R = occ["binary"].shape[:3]
    binary = np.zeros(occ["binary"].shape, bool)
    for k in range(K):
        la = level_aabbs(statics.expert_aabbs[k].cpu(), L).numpy()
        for lv in range(L):
            lo, hi = la[lv, 0, 2], la[lv, 1, 2]
            zc = lo + (np.arange(R) + 0.5) * (hi - lo) / R
            cut = 2.2 if alive_frac is None else lo + alive_frac * (hi - lo)
            binary[k, lv, :, :, zc <= cut] = True
    occ["binary"] = torch.from_numpy(binary).to(device)
    occ["num_updates"] = torch.tensor(1000, dtype=torch.int32, device=device)
    return occ


def unpack_cells(baked, bcfg):
    """(R³, C) payload of every cell, read back from a pack-8 table (corner
    block 0 of the cell's own row), in the table dtype."""
    import torch

    from nerfsys_tpu_torch.models.baked import table_rows

    R, C = bcfg.resolution, bcfg.channels
    cells = torch.arange(R**3, device=baked["table"].device)
    rows = table_rows(R, baked.get("block_index"), bcfg.sparse_block)(
        cells // (R * R), (cells // R) % R, cells % R)
    return baked["table"][rows, :C]


def lookup_bytes(baked, bcfg, pts) -> int:
    """Bytes one lookup at `pts` must move on this run's data: every
    distinct payload row it reads (its used channels), every distinct
    block-index entry (4 bytes) of a sparse table, each once; the points
    read and the values written once."""
    import torch

    from nerfsys_tpu_torch.models.baked import lookup_cells, table_rows

    R, C, Cp = bcfg.resolution, bcfg.channels, bcfg.padded_channels
    table, index = baked["table"], baked.get("block_index")
    pack = table.shape[1] // Cp
    _, xs, ys, iz = lookup_cells(baked["aabb"], pts, R, pack)
    row_of = table_rows(R, index, bcfg.sparse_block)
    rows = torch.unique(torch.cat([row_of(x, y, iz) for x in xs
                                   for y in ys]))
    n = rows.numel() * pack * C * table.element_size()
    if index is not None:
        B, Rb = bcfg.sparse_block, R // bcfg.sparse_block
        n += 4 * torch.unique(torch.cat([
            ((x // B) * Rb + y // B) * Rb + iz // B
            for x in xs for y in ys])).numel()
    return n + pts.shape[0] * (12 + 4 * C)


def check_baked_kernel(tables, pts, results):
    """Kernel 8 against its plain version at one full serve chunk
    (65,536 rays x 32 samples), for each (label, table, bcfg); the first
    is the serve table, whose numbers go into the kernel line. The
    library yardstick is one grid_sample over the dense volume of each
    table's values (corner block 0 of every cell's row)."""
    import torch
    import torch.nn.functional as F

    from nerfsys_tpu_torch import kernels
    from nerfsys_tpu_torch.models.baked import (
        baked_plan,
        baked_trilerp_kernel,
        baked_trilerp_plain,
    )

    N = pts.shape[0]
    tol = 1e-5
    for i, (label, baked, bcfg) in enumerate(tables):
        table, box = baked["table"], baked["aabb"]
        index = baked.get("block_index")
        R, C, Cp = bcfg.resolution, bcfg.channels, bcfg.padded_channels
        pack = table.shape[1] // Cp
        args = (table, box, pts, R, C, Cp, pack, index, bcfg.sparse_block)
        ker = baked_trilerp_kernel(*args)
        pln = baked_trilerp_plain(*args)
        torch.cuda.synchronize()
        scale = max(float(t.abs().max()) for t in table.split(1 << 20))
        err = max_err(ker, pln) / scale
        ms = cuda_ms(lambda: baked_trilerp_kernel(*args), 10)
        plain_ms = cuda_ms(lambda: baked_trilerp_plain(*args), 3)
        n_bytes = lookup_bytes(baked, bcfg, pts)
        b_ms, b_by = bound(n_bytes, N * C * 21)

        vol = (unpack_cells(baked, bcfg).float().reshape(R, R, R, C)
               .permute(3, 0, 1, 2)[None].contiguous())
        u = (pts - box[0]) / (box[1] - box[0]) * 2.0 - 1.0
        grid = u[:, [2, 1, 0]].reshape(1, N, 1, 1, 3).contiguous()

        def lib():
            return F.grid_sample(vol, grid, mode="bilinear",
                                 padding_mode="border", align_corners=False)

        lib_err = max_err(lib().reshape(C, N).T, pln)
        lib_ms = cuda_ms(lib, 10)
        del vol, grid
        text = (f"table {label}: err/payload_max={err:.3e} tol={tol:g} "
                f"(cell selection and lerps round alike, --fmad=false) "
                f"max_abs_err={max_err(ker, pln):.3e} kernel_ms={ms:.4f} "
                f"plain_ms={plain_ms:.4f} bytes={n_bytes} "
                f"bound_ms={b_ms:.4f} ({b_by}) at "
                f"{HBM_BYTES_PER_S / 1e12:g} TB/s library_ms={lib_ms:.4f} "
                f"(grid_sample bilinear, border, align_corners=False, over "
                f"the dense (1, {C}, {R}, {R}, {R}) float32 volume; "
                f"max_abs_err vs plain {lib_err:.3e}); plan "
                + baked_plan_text(baked_plan(N, pack, C, Cp,
                                             table.element_size())))
        print(f"kernel {kernels.BAKED_TRILERP.name}: {text}", flush=True)
        if not err <= tol:
            raise SystemExit(f"kernel baked_trilerp disagrees with its plain "
                             f"version on the {label} table: {err} > {tol}")
        if i == 0:
            results[kernels.BAKED_TRILERP.name] = dict(
                max_abs_err=max_err(ker, pln), ms=ms, plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms, text=text)
        del ker, pln


BAKED_EDGE_N = 2048 * 32 + 13  # a tail of 13 points past whole warps


def baked_edge_points(kind: str, baked, bcfg, device):
    """Adversarial lookup points (BAKED_EDGE_N, 3) from numpy seed 9 in a
    table's box: "top faces" puts coordinates exactly on the box's top
    faces (the clip to float32(R - 1.000001) gives R-1, weight 0, for
    R >= 64); "lo and outside" exactly at lo, one and three cells outside
    the box; "one cell" every point at one interior point; "block edges"
    cells on both sides of the sparse blocks' and super-blocks' edges
    (8-cell blocks for a dense table); "single point" one of them."""
    import numpy as np
    import torch

    rng = np.random.default_rng(9)
    box = baked["aabb"].cpu().numpy().astype(np.float32)
    lo, hi = box[0], box[1]
    R = bcfg.resolution
    h = (hi - lo) / np.float32(R)
    n = 1 if kind == "single point" else BAKED_EDGE_N
    u = rng.uniform(size=(n, 3)).astype(np.float32)
    p = lo + u * (hi - lo)
    pick = rng.integers(0, 3, size=(n, 3))
    if kind == "top faces":
        p = np.where(pick == 0, hi, p)
        p[:4] = [hi, [hi[0], lo[1], hi[2]], [lo[0], hi[1], hi[2]], lo]
    elif kind == "lo and outside":
        out = np.stack([lo - h, lo - 3 * h, hi + h, hi + 3 * h])
        p = np.where(pick == 0, lo, np.where(
            pick == 1, out[rng.integers(0, 4, size=(n, 3)), [0, 1, 2]], p))
    elif kind == "one cell":
        p[:] = lo + np.float32(0.41) * (hi - lo)
    elif kind in ("block edges", "single point"):
        B = bcfg.sparse_block or 8
        edges = np.unique(np.concatenate([
            np.arange(B, R, B) - 1, np.arange(B, R, B),
            np.arange(4 * B, R, 4 * B) - 1, np.arange(4 * B, R, 4 * B)]))
        cell = edges[rng.integers(0, edges.size, size=(n, 3))]
        p = lo + (cell + np.float32(0.5) + u).astype(np.float32) * h
    return torch.from_numpy(p.astype(np.float32)).to(device)


def baked_plan_text(plan) -> str:
    return (f"lanes={plan.lanes} sets={plan.sets} pieces={plan.pieces} "
            f"teams={plan.teams} warps={plan.warps} blocks={plan.blocks} "
            f"smem={plan.smem}")


def baked_edges(tables, device):
    """Kernel 8 against its plain version on adversarial points (see
    `baked_edge_points`), on each table of `check_baked_kernel`; error 0
    expected (cell selection and lerp tree round alike), 1e-5 of the
    table's payload max allowed."""
    import torch

    from nerfsys_tpu_torch.models.baked import (
        baked_plan,
        baked_trilerp_kernel,
        baked_trilerp_plain,
    )

    tol = 1e-5
    for label, baked, bcfg in tables:
        table = baked["table"]
        R, C, Cp = bcfg.resolution, bcfg.channels, bcfg.padded_channels
        pack = table.shape[1] // Cp
        scale = max(float(t.abs().max()) for t in table.split(1 << 20))
        for kind in ("top faces", "lo and outside", "one cell",
                     "block edges", "single point"):
            pts = baked_edge_points(kind, baked, bcfg, device)
            args = (table, baked["aabb"], pts, R, C, Cp, pack,
                    baked.get("block_index"), bcfg.sparse_block)
            err = max_err(baked_trilerp_kernel(*args),
                          baked_trilerp_plain(*args))
            plan = baked_plan(pts.shape[0], pack, C, Cp,
                              table.element_size())
            print(f"edge baked_trilerp {label} {kind}: N={pts.shape[0]} "
                  f"max_abs_err={err:.3e} err/payload_max={err / scale:.3e} "
                  f"tol={tol:g} plan {baked_plan_text(plan)}", flush=True)
            if not err / scale <= tol:
                raise SystemExit(f"kernel baked_trilerp disagrees with its "
                                 f"plain version on {label}, {kind}: {err}")
    torch.cuda.empty_cache()


def bake_matches_plain(cfg, statics, params, bcfg, occ, got, device):
    """The bake through kernel 1 (`got`) against the same bake through the
    plain versions (`bake_field(..., use_kernels=False)`): the same block
    index, and every table value within 1e-5 of the table's max (an f32
    table, so no cast hides a difference; kernel 1 sums the plane features
    in another order, and the MLPs and the SH projection carry the ulps)."""
    import torch

    from nerfsys_tpu_torch.models.baked import bake_field

    t0 = time.perf_counter()
    want = bake_field(params, cfg, statics, bcfg, occ_state=occ,
                      device=device, use_kernels=False)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    if not torch.equal(got["block_index"], want["block_index"]) \
            or got["table"].shape != want["table"].shape:
        raise SystemExit("baked: the bake through the kernels keeps other "
                         "blocks than the plain bake")
    pairs = list(zip(got["table"].split(1 << 18), want["table"].split(1 << 18)))
    scale = max(float(w.abs().max()) for _, w in pairs)
    err = max(float((g - w).abs().max()) for g, w in pairs) / scale
    tol = 1e-5
    print(f"baked: {bcfg.resolution}^3 f32 sparse bake through the kernels vs "
          f"plain: same block index, err/table_max={err:.3e} tol={tol:g} "
          f"(plain bake {plain_s:.2f} s)", flush=True)
    if not err <= tol:
        raise SystemExit("baked: the bake through the kernels disagrees with "
                         "the plain bake")


BAKED_KERNELS = ("baked_trilerp", "volume_render_fwd")


def baked(cfg, statics, params, device, results):
    """Phase: baked snapshot serving. Bake the serve configuration
    (256³, SH-3, 32 directions, pack 8, sparse blocks of 8³, bf16,
    occupancy-aware with 2 dilations) through `bake_field`, hold a bake
    through the kernels against the plain bake, check kernel 8 on four
    tables, then serve 3 800x800 uint8 frames through
    `make_baked_camera_renderer`, the counters zeroed just before them and
    read just after."""
    import dataclasses

    import numpy as np
    import torch

    from nerfsys_tpu_torch import kernels
    from nerfsys_tpu_torch.data.ram_rays import frame_rays
    from nerfsys_tpu_torch.models.baked import (
        BakedConfig,
        bake_field,
        make_baked_camera_renderer,
        make_baked_chunk_renderer,
        pack_dense,
    )
    from nerfsys_tpu_torch.ops.rays import frame_chunk_rays
    from nerfsys_tpu_torch.ops.scene_box import SceneBox
    from nerfsys_tpu_torch.ops.volrend import stratified_t_vals, t_to_points

    S = 32
    chunk = CHECK_RAYS
    aabb = statics.global_aabb.cpu().numpy()
    bcfg = BakedConfig(resolution=BAKE_R, sh_levels=3, n_dirs=32,
                       corner_pack=8, sparse_block=8, dtype="bfloat16")
    occ = synthetic_occ(statics, device)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    serve_table = bake_field(params, cfg, statics, bcfg, occ_state=occ,
                             occ_dilate=2, device=device)
    torch.cuda.synchronize()
    bake_s = time.perf_counter() - t0
    vals = unpack_cells(serve_table, bcfg)
    R, B = bcfg.resolution, bcfg.sparse_block
    cells = int((vals != 0).any(dim=1).sum())
    blocks = serve_table["table"].shape[0] // B**3 - 1
    table_gb = (serve_table["table"].numel() * 2
                + serve_table["block_index"].numel() * 4) / 1e9
    print(f"baked: bake_s={bake_s:.2f} ({R}^3 SH-3 n_dirs=32 pack 8 sparse "
          f"8 bf16, occupancy R=64 L=2 alive_frac 0.35, dilate 2) "
          f"nonzero_cells={cells}/{R**3} ({cells / R**3:.4f}) "
          f"alive_blocks={blocks}/{(R // B)**3} ({blocks / (R // B)**3:.4f}) "
          f"table_gb={table_gb:.3f} (dense pack-8 "
          f"{R**3 * 8 * bcfg.padded_channels * 2 / 1e9:.3f})", flush=True)

    # kernel 8 at one full serve chunk of the first pose, four tables
    md = pose((0.0, 0.0, 2.0))
    sb = SceneBox(statics.global_aabb)
    rays = frame_chunk_rays(
        torch.from_numpy(md.c2w).to(device),
        torch.from_numpy(md.intrinsics).to(device), 0, chunk, SIDE, SIDE,
        scene_box=sb)
    valid = torch.isfinite(rays[:, 6])
    t_vals = stratified_t_vals(torch.where(valid, rays[:, 6], 0.0),
                               torch.where(valid, rays[:, 7], 1.0), S)
    pts = t_to_points(rays[:, :3], rays[:, 3:6], t_vals).reshape(-1, 3)
    pack4 = dataclasses.replace(bcfg, corner_pack=4, sparse_block=0)
    dense4 = {"table": pack_dense(vals, R, bcfg.padded_channels, 4),
              "aabb": serve_table["aabb"], "corner_pack": 4}
    small = BakedConfig(resolution=SMALL_R, sh_levels=3, n_dirs=32,
                        corner_pack=2, dtype="bfloat16")
    f32 = BakedConfig(resolution=F32_R, sh_levels=3, n_dirs=32,
                      corner_pack=4, sparse_block=8, dtype="float32")
    f32_table = bake_field(params, cfg, statics, f32, occ_state=occ,
                           device=device)
    bake_matches_plain(cfg, statics, params, f32, occ, f32_table, device)
    tables = [
        (f"{R}^3 pack-8 sparse-8 bf16 (serve)", serve_table, bcfg),
        (f"{R}^3 pack-4 dense bf16", dense4, pack4),
        (f"{SMALL_R}^3 pack-2 dense bf16", bake_field(
            params, cfg, statics, small, device=device), small),
        (f"{F32_R}^3 pack-4 sparse-8 f32", f32_table, f32),
    ]
    del vals
    check_baked_kernel(tables, pts, results)
    baked_edges(tables, device)
    del tables, dense4, f32_table, pts, t_vals, rays

    renderer = make_baked_camera_renderer(
        serve_table, bcfg, cfg, H=SIDE, W=SIDE, ray_samples=S,
        chunk_rays=chunk, scene_aabb=aabb, out_u8=True, device=device)
    poses = [pose((0.0, 0.0, 2.0)), pose((0.1, 0.0, 2.0)),
             pose((0.0, -0.1, 2.1))]
    renderer(params, statics, poses[0].c2w, poses[0].intrinsics)  # warm-up
    torch.cuda.synchronize()

    kernels.reset_launches()
    times, frames = [], []
    for p in poses:
        t0 = time.perf_counter()
        img = renderer(params, statics, p.c2w, p.intrinsics)
        times.append(time.perf_counter() - t0)
        frames.append(img)
        if img.dtype != np.uint8 or img.shape != (SIDE, SIDE, 3):
            raise SystemExit(f"baked: frame {img.dtype} {img.shape}")
        if not np.isfinite(img.astype(np.float64).mean()):
            raise SystemExit("baked: frame mean not finite")
    launches = kernels.launches()
    print(f"baked: launches during 3 requests {launches}", flush=True)
    for k in BAKED_KERNELS:
        if launches[k] <= 0:
            raise SystemExit(f"baked: kernel {k} never launched")

    # the same frame through the plain versions
    plain = make_baked_camera_renderer(
        serve_table, bcfg, cfg, H=SIDE, W=SIDE, ray_samples=S,
        chunk_rays=chunk, scene_aabb=aabb, out_u8=True, device=device,
        use_kernels=False)
    ref = plain(params, statics, poses[0].c2w, poses[0].intrinsics)
    diff = np.abs(frames[0].astype(np.int16) - ref.astype(np.int16)).max(-1)
    within = float((diff <= 1).mean())
    print(f"baked: kernels vs plain frame: max level diff {int(diff.max())}, "
          f"share of pixels within 1 level {within:.6f} (need >= 0.999: the "
          f"compositor sums in another order, and a 1e-7 change can cross "
          f"a level of the truncating tonemap)", flush=True)
    if within < 0.999:
        raise SystemExit("baked: kernel frame disagrees with the plain path")

    # one chunk through make_baked_chunk_renderer, kernels vs plain
    host_rays, _ = frame_rays(SIDE, SIDE, poses[0].intrinsics,
                              poses[0].c2w, aabb=aabb)
    chunk_rays = torch.from_numpy(host_rays[:chunk]).to(device)
    got, want = (make_baked_chunk_renderer(
        serve_table, bcfg, cfg, ray_samples=S, device=device,
        use_kernels=use)(params, statics, chunk_rays) for use in (True,
                                                                  False))
    errs = [max_err(a, b) for a, b in zip(got, want)]
    print(f"baked: chunk renderer kernels vs plain: rgb {errs[0]:.3e} depth "
          f"{errs[1]:.3e} acc {errs[2]:.3e} (tol rgb/acc 1e-4, depth 1e-3)",
          flush=True)
    if errs[0] > 1e-4 or errs[2] > 1e-4 or errs[1] > 1e-3:
        raise SystemExit("baked: chunk renderer disagrees with the plain "
                         "path")

    profile_device("baked frame", lambda: renderer(
        params, statics, poses[0].c2w, poses[0].intrinsics))

    ms = [1e3 * t for t in times]
    n = SIDE * SIDE
    print(f"baked: {SIDE}x{SIDE} uint8 frames ms={[round(x, 2) for x in ms]} "
          f"mean_ms={sum(ms) / 3:.2f} rays_per_s={n / (sum(times) / 3):.1f} "
          f"chunk_rays={chunk} samples={S} "
          f"mean_level={float(frames[-1].mean()):.3f}", flush=True)
    return launches


HASH_SMALL = 262_144  # points of the Smoothstep / Nearest / tcnn checks
HASH_SERVE_KERNELS = ("hash_encode_fwd", "occupancy_probe_cdf",
                      "sample_tvals_from_cdf", "volume_render_fwd")
HASH_TRAIN_KERNELS = ("hash_encode_fwd", "hash_encode_fwd_packed",
                      "hash_encode_bwd", "occupancy_probe_cdf",
                      "sample_tvals_from_cdf", "volume_render_fwd",
                      "volume_render_bwd")


def hash_setup(device):
    """The runner's default experts (`container_config_from_args` with the
    flag defaults): K=4 Instant-NGP experts, hash L=16 F=2 T=20 min_res 16
    max_res 4096 Linear floor layout fp32, hidden 64, sigma depth 2, color
    hidden 64 depth 2, geo 15, SH-4, bg hidden 32, margin 1.1; random
    weights from the seed (4 x 16 x 2^20 x 2 float32 tables, 512 MiB)."""
    from nerfsys_tpu_torch.models.container import (
        ContainerConfig,
        init_container_params,
    )
    from nerfsys_tpu_torch.models.ngp import NGPConfig
    from nerfsys_tpu_torch.ops.encodings import HashGridConfig

    expert = NGPConfig(
        hidden=64, sigma_depth=2, color_hidden=64, color_depth=2,
        geo_feat_dim=15, sh_levels=4, xyz_encoding="hash",
        hash=HashGridConfig(levels=16, min_res=16, max_res=4096,
                            log2_hashmap_size=20, features_per_level=2))
    cfg = ContainerConfig(num_experts=4, expert=expert, boundary_margin=1.1,
                          bg_hidden=32)
    return cfg, init_container_params(cfg, seed=SEED, device=device)


def with_hash(cfg, **kw):
    """`cfg` with its experts' hash config changed by `kw`."""
    import dataclasses

    return dataclasses.replace(cfg, expert=dataclasses.replace(
        cfg.expert, hash=dataclasses.replace(cfg.expert.hash, **kw)))


def hash_rows_read(x01, hc) -> int:
    """Distinct table rows (expert, row) an encode at x01 (K, N, 3) reads,
    each counted once (a bitmap over the K x L x 2^T rows)."""
    import torch

    from nerfsys_tpu_torch.ops import encodings as E

    K = x01.shape[0]
    seen = torch.zeros(K * hc.levels * hc.table_size, dtype=torch.bool,
                       device=x01.device)
    for level in range(hc.levels):
        base = E._level_rows(K, hc, level, x01.device)
        for row, _ in E.level_corners(x01, hc, level):
            seen[(base + row).reshape(-1)] = True
    return int(seen.sum())


def check_hash_kernels(cfg, statics, params, occ, rays_np, batch, device,
                       results):
    """Kernel row 7 against its plain versions on the card: 7a (fp32) at
    one full serve chunk (65,536 rays x 32 samples, K=4) in the runner's
    Linear floor layout, and in Smoothstep, Nearest and the tcnn layout at
    262,144 points of it, and on the adversarial inputs of
    `hash_fwd_edges`; 7a timed at the step's shapes too (one inner step and
    one query set of expert 0, 128,000 and 64,000 points); 7b (packed bf16
    pairs) at the full chunk; 7c (the table gradient) at one inner step of
    one expert (expert 0's first support set, 4,000 rays x 32 samples,
    randomized), and on the adversarial inputs of `hash_bwd_edges`. Bytes:
    points read, output written, each distinct table row read once (7c:
    points and cotangent read, the dense table-shaped gradient written
    once)."""
    import torch

    from nerfsys_tpu_torch import kernels
    from nerfsys_tpu_torch.models.ngp import world_to_unit
    from nerfsys_tpu_torch.models.occupancy import _ray_validity
    from nerfsys_tpu_torch.ops import encodings as E
    from nerfsys_tpu_torch.ops import occupancy as O
    from nerfsys_tpu_torch.utils.device import num_sms
    from nerfsys_tpu_torch.ops import volrend as V

    S = 32
    hc = cfg.expert.hash
    table = params["experts"]["hash_table"]
    rays = torch.from_numpy(rays_np).to(device)
    o, d = rays[:, 0:3].contiguous(), rays[:, 3:6].contiguous()
    _, near, far = _ray_validity(rays)
    cdf = O.occupancy_probe_cdf(occ["occs"], occ["binary"],
                                statics.expert_aabbs, o, d, near, far, 128,
                                importance=True, ray_floor=0.25)
    t_vals, _ = O.sample_tvals_from_cdf(cdf, near, far, S)
    pts = V.t_to_points(o, d, t_vals).reshape(-1, 3)
    x01 = world_to_unit(pts, statics.expert_aabbs, cfg.expert.enc_eps)
    del cdf, t_vals, pts
    tol = 1e-6
    why = ("relative to the output's max; the kernel rounds every "
           "operation as the plain version does (--fmad=false), corners "
           "summed in the same order")

    def fwd(label, x, c, packed, kern):
        ker = E.hash_encode_kernel(table, x, c, packed)
        pln = (E.hash_encode_packed_plain if packed else E.hash_encode_plain)(
            table, x, c)
        torch.cuda.synchronize()
        err = rel_err(ker, pln)
        ms = cuda_ms(lambda: E.hash_encode_kernel(table, x, c, packed), 10)
        plain_ms = cuda_ms(
            lambda: (E.hash_encode_packed_plain if packed
                     else E.hash_encode_plain)(table, x, c), 3)
        rows = hash_rows_read(x, c)
        n_bytes = nbytes(x, ker) + rows * hc.features_per_level * 4
        # per corner: 3 index multiplies, 2 xors, a mask, 2 weight
        # multiplies, F multiply-adds; per axis ~6 for the cell
        n_ops = x.shape[0] * x.shape[1] * hc.levels * (
            18 + 8 * (8 + 2 * hc.features_per_level))
        b_ms, b_by = bound(n_bytes, n_ops)
        text = (f"{label}: err/max={err:.3e} tol={tol:g} ({why}) "
                f"max_abs_err={max_err(ker, pln):.3e} kernel_ms={ms:.4f} "
                f"plain_ms={plain_ms:.4f} bytes={n_bytes} (distinct rows "
                f"{rows}) bound_ms={b_ms:.4f} ({b_by}) at "
                f"{HBM_BYTES_PER_S / 1e12:g} TB/s")
        print(f"kernel {kern.name}: {text}", flush=True)
        if not err <= tol:
            raise SystemExit(f"kernel {kern.name} disagrees with its plain "
                             f"version ({label}): {err} > {tol}")
        return dict(max_abs_err=max_err(ker, pln), ms=ms, plain_ms=plain_ms,
                    bound_ms=b_ms, bound_by=b_by, text=text), ker

    K, N = x01.shape[0], x01.shape[1]
    results[kernels.HASH_FWD.name], fp32 = fwd(
        f"Linear floor layout {K}x{N} points", x01, hc, False,
        kernels.HASH_FWD)
    sms = num_sms(device)
    print(f"kernel hash_encode_fwd: plan "
          f"{hash_plan_text(E.hash_fwd_plan(N, hc, K, sms))}", flush=True)
    small = x01[:, :HASH_SMALL].contiguous()
    for label, kw in (("Smoothstep", dict(interpolation="Smoothstep")),
                      ("Nearest", dict(interpolation="Nearest")),
                      ("tcnn layout Linear", dict(tcnn_layout=True))):
        fwd(f"{label} {K}x{HASH_SMALL} points", small,
            with_hash(cfg, **kw).expert.hash, False, kernels.HASH_FWD)
    pc = with_hash(cfg, packed=True).expert.hash
    results[kernels.HASH_FWD_PACKED.name], packed = fwd(
        f"packed {K}x{N} points", x01, pc, True, kernels.HASH_FWD_PACKED)
    print(f"kernel hash_encode_fwd_packed: packed vs fp32 output "
          f"err/max={rel_err(packed, fp32):.3e} (the bf16 rounding)",
          flush=True)
    del fp32, packed, small

    hash_fwd_edges(hc, table, x01, device)
    del x01

    # 7a at the step's shapes, 7c at one inner step of expert 0
    gen = torch.Generator(device=device).manual_seed(3)
    x1, pts = step_points(cfg, statics, occ, batch["support_rays"][0, 0],
                          gen)
    xq, _ = step_points(cfg, statics, occ, batch["query_rays"][0, 0], gen)
    for kern, c, packed in ((kernels.HASH_FWD, hc, False),
                            (kernels.HASH_FWD_PACKED, pc, True)):
        plain = E.hash_encode_packed_plain if packed else E.hash_encode_plain
        steps = []
        for label, x in (("one inner step", x1), ("a query set", xq)):
            ker = E.hash_encode_kernel(table[0], x, c, packed)
            err = rel_err(ker, plain(table[0], x, c))
            ms = cuda_ms(lambda: E.hash_encode_kernel(table[0], x, c,
                                                      packed), 10)
            dev_ms = device_ms(lambda: E.hash_encode_kernel(table[0], x, c,
                                                            packed))
            plan = E.hash_fwd_plan(x.shape[0], c, 1, sms)
            steps.append(f"{label} 1x{x.shape[0]} points kernel_ms="
                         f"{ms:.4f} (back to back) device_ms={dev_ms:.4f} "
                         f"err/max={err:.3e} plan {hash_plan_text(plan)}")
            if not err <= tol:
                raise SystemExit(f"kernel {kern.name} disagrees with its "
                                 f"plain version at {label}: {err} > {tol}")
        fwd_step = "; ".join(steps)
        print(f"kernel {kern.name}: step shapes: {fwd_step}", flush=True)
        results[kern.name]["text"] += f"; step shapes: {fwd_step}"
    dout = torch.randn((x1.shape[0], hc.out_dim), device=device,
                       generator=gen)
    shape = table[0].shape
    got = E.hash_encode_bwd_kernel(x1, dout, hc, shape)
    want = E.hash_encode_bwd_plain(x1, dout, hc, shape)
    torch.cuda.synchronize()
    err, tol_b = rel_err(got, want), 1e-4
    ms = cuda_ms(lambda: E.hash_encode_bwd_kernel(x1, dout, hc, shape), 10)
    zero_ms = cuda_ms(lambda: torch.zeros(shape, device=device), 10)
    dev_ms = device_ms(lambda: E.hash_encode_bwd_kernel(x1, dout, hc, shape))
    zero_dev_ms = device_ms(lambda: torch.zeros(shape, device=device))
    plain_ms = cuda_ms(lambda: E.hash_encode_bwd_plain(x1, dout, hc, shape),
                       3)
    rows = hash_rows_read(x1[None], hc)
    # points and cotangent read, the dense table-shaped gradient written
    # once (the rows' read-modify-writes in the L2 are a cost of the
    # atomic design, not of the function)
    n_bytes = nbytes(x1, dout) + nbytes(got)
    b_ms, b_by = bound(n_bytes, x1.shape[0] * hc.levels * (
        18 + 8 * (8 + 2 * hc.features_per_level)))
    plan = E.hash_bwd_plan(x1.shape[0], 1, hc, sms)
    text = (f"one inner step {x1.shape[0]} points: err/max={err:.3e} "
            f"tol={tol_b:g} (relative to the gradient's max; fp32 atomics "
            f"add in another order than index_add_) max_abs_err="
            f"{max_err(got, want):.3e} kernel_ms={ms:.4f} (the zeroed "
            f"{nbytes(got)}-byte buffer included; the zero fill alone "
            f"{zero_ms:.4f}; device time {dev_ms:.4f}, of it the zero fill "
            f"{zero_dev_ms:.4f}) plain_ms={plain_ms:.4f} bytes={n_bytes} "
            f"(points and cotangent read, the dense gradient written once; "
            f"distinct rows {rows}) bound_ms={b_ms:.4f} ({b_by}) at "
            f"{HBM_BYTES_PER_S / 1e12:g} TB/s; plan {hash_plan_text(plan)}")
    print(f"kernel {kernels.HASH_BWD.name}: {text}", flush=True)
    if not err <= tol_b or not bool((want != 0).any()):
        raise SystemExit(f"kernel hash_encode_bwd disagrees with its plain "
                         f"version: {err} > {tol_b}")
    results[kernels.HASH_BWD.name] = dict(
        max_abs_err=max_err(got, want), ms=ms, plain_ms=plain_ms,
        bound_ms=b_ms, bound_by=b_by, text=text)
    del got, want
    xk = world_to_unit(pts, statics.expert_aabbs,
                       cfg.expert.enc_eps).contiguous()
    hash_bwd_edges(hc, table, x1, xk, dout, device)


def step_points(cfg, statics, occ, rays, gen):
    """Expert 0's unit-cube points of one support or query set of the
    bench step (rays (R, 8): 32 randomized samples each, from its
    probe-CDF), and the world points."""
    from nerfsys_tpu_torch.models.ngp import world_to_unit
    from nerfsys_tpu_torch.ops import occupancy as O
    from nerfsys_tpu_torch.ops import volrend as V

    o, d = rays[:, 0:3].contiguous(), rays[:, 3:6].contiguous()
    near, far = rays[:, 6].contiguous(), rays[:, 7].contiguous()
    grid = (occ["occs"][0:1], occ["binary"][0:1], statics.expert_aabbs[0:1])
    cdf = O.occupancy_probe_cdf(*grid, o, d, near, far, 128, importance=True,
                                ray_floor=0.25)
    t_vals, _ = O.sample_tvals_from_cdf(cdf, near, far, 32, generator=gen,
                                        randomized=True)
    pts = V.t_to_points(o, d, t_vals).reshape(-1, 3)
    return world_to_unit(pts, statics.expert_aabbs[0],
                         cfg.expert.enc_eps).contiguous(), pts


def hash_plan_text(plan) -> str:
    return (f"tile={plan.tile} threads={plan.threads} blocks={plan.blocks} "
            f"smem={plan.smem} lane_map={plan.lane_map} vec={int(plan.vec)} "
            f"level_group={plan.level_group}")


def hash_edge_points(kind: str, k: int, n: int, device, fine_scale=None):
    """Adversarial unit-cube points (k, n, 3) of the hash encoder, from
    numpy seed 5: "one cell" puts every point at one interior point (every
    lane of every warp on the same rows at every level); "fine cell"
    spreads them inside one cell of the level with scale `fine_scale` (many
    lanes on one row where no ray spacing would share it); "bounds" mixes
    coordinates at world_to_unit's clip bounds (1e-6 and 1 - 1e-6) and of
    exactly 0 and 1 with uniform ones."""
    import numpy as np
    import torch

    rng = np.random.default_rng(5)
    if kind == "one cell":
        x = np.empty((k, n, 3), np.float32)
        x[...] = np.array([0.31731, 0.60213, 0.44897], np.float32)
    elif kind == "fine cell":
        cell = np.array([1234.0, 2345.0, 3456.0], np.float64)
        u = rng.uniform(0.25, 0.75, size=(k, n, 3))
        x = ((cell + u) / fine_scale).astype(np.float32)
    else:
        x = rng.uniform(size=(k, n, 3)).astype(np.float32)
        pick = rng.integers(0, 6, size=(k, n, 3))
        special = np.array([1e-6, 1 - 1e-6, 0.0, 1.0], np.float32)
        x = np.where(pick < 4, special[np.minimum(pick, 3)], x)
    return torch.from_numpy(x).to(device)


def hash_fwd_edges(hc, table, x01, device):
    """Kernels 7a and 7b against their plain versions on adversarial
    inputs, within 1e-6 of the output's max (each line says whether the
    output is bit for bit equal), under both lane maps: at the serve chunk
    (K=4, 2,097,152 points an expert) every point in one cell, many points
    in one cell of the finest level, the bounds, a tail (N - 37) and a
    single point; at 262,144 points F = 1, 4 and 8 (tables of their own;
    7a only) and the other level grouping (one group if the plan splits
    the levels, groups of 4 if it does not); 7b also in Smoothstep."""
    import dataclasses

    import torch

    from nerfsys_tpu_torch.ops import encodings as E
    from nerfsys_tpu_torch.utils.device import num_sms

    K, N = x01.shape[:2]
    sms = num_sms(device)
    small = x01[:, :HASH_SMALL].contiguous()
    default_lg = E.hash_fwd_plan(N, hc, K, sms).level_group
    other_lg = 4 if default_lg == hc.levels else hc.levels
    cases = [
        ("one cell", hc, table, hash_edge_points("one cell", K, N, device),
         {}),
        ("fine cell", hc, table, hash_edge_points(
            "fine cell", K, N, device, float(hc.level_scales()[-1])), {}),
        ("bounds", hc, table, hash_edge_points("bounds", K, N, device), {}),
        ("tail N-37", hc, table, x01[:, :N - 37].contiguous(), {}),
        ("N=1", hc, table, x01[:, :1].contiguous(), {})]
    for F in (1, 4, 8):
        c = dataclasses.replace(hc, features_per_level=F)
        cases.append((f"F={F}", c, E.hash_grid_init(
            c, torch.Generator().manual_seed(6), device=device,
            num_experts=K), small, {}))
    cases.append((f"level groups of {other_lg}", hc, table, small,
                  dict(level_group=other_lg)))
    # 7b (F = 2 only) on the same inputs, and in Smoothstep
    packed = [(label, dataclasses.replace(c, packed=True), tab, x, kw)
              for label, c, tab, x, kw in cases if c.features_per_level == 2]
    packed.append(("Smoothstep", dataclasses.replace(
        hc, packed=True, interpolation="Smoothstep"), table, small, {}))
    for name, group in (("hash_encode_fwd", cases),
                        ("hash_encode_fwd_packed", packed)):
        for label, c, tab, x, kw in group:
            plain = (E.hash_encode_packed_plain if c.packed
                     else E.hash_encode_plain)
            want = plain(tab, x, c)
            for lane_map in E.LANE_MAPS:
                plan = E.hash_fwd_plan(x.shape[1], c, K, sms,
                                       lane_map=lane_map, **kw)
                got = E.hash_encode_planned(tab, x, c, packed=c.packed,
                                            plan=plan)
                err = rel_err(got, want)
                ms = cuda_ms(lambda: E.hash_encode_planned(
                    tab, x, c, packed=c.packed, plan=plan), 3)
                print(f"edge {name} {label}: K={K} N={x.shape[1]} "
                      f"F={c.features_per_level} err/max={err:.3e} "
                      f"tol=1e-06 bit_equal={bool(torch.equal(got, want))} "
                      f"kernel_ms={ms:.4f} plan {hash_plan_text(plan)}",
                      flush=True)
                if not err <= 1e-6:
                    raise SystemExit(f"kernel {name} disagrees with its "
                                     f"plain version on {label} "
                                     f"({lane_map}): {err}")
                del got
            del want
    torch.cuda.empty_cache()


def hash_bwd_edges(hc, table, x1, xk, dout, device):
    """Kernel 7c against its plain version on adversarial inputs at one
    inner step (one expert, 128,000 points unless stated), within 1e-4 of
    the gradient's max with the gradient nonzero, under both lane maps:
    every point in one cell (every lane of a warp on one row: the deepest
    aggregation), many points in one cell of the finest level, the bounds,
    a tail (P - 37) and a single point, the K=4 experts stacked; one level
    group of persistent blocks, and groups of 4 levels."""
    import torch

    from nerfsys_tpu_torch.ops import encodings as E
    from nerfsys_tpu_torch.utils.device import num_sms

    P = x1.shape[0]
    sms = num_sms(device)
    gen = torch.Generator(device=device).manual_seed(9)
    cases = (
        ("one cell", hash_edge_points("one cell", 1, P, device)[0], dout,
         {}),
        ("fine cell", hash_edge_points(
            "fine cell", 1, P, device, float(hc.level_scales()[-1]))[0],
         dout, {}),
        ("bounds", hash_edge_points("bounds", 1, P, device)[0], dout, {}),
        ("tail P-37", x1[:P - 37].contiguous(), dout[:P - 37].contiguous(),
         {}),
        ("N=1", x1[:1].contiguous(), dout[:1].contiguous(), {}),
        ("stacked K=4", xk, torch.randn((4, P, hc.out_dim), device=device,
                                        generator=gen), {}),
        ("one level group of persistent blocks", x1, dout,
         dict(level_group=None)),
        ("level groups of 4", x1, dout, dict(level_group=4)))
    for label, x, g, kw in cases:
        K = x.shape[0] if x.dim() == 3 else 1
        shape = table.shape if x.dim() == 3 else table[0].shape
        want = E.hash_encode_bwd_plain(x, g, hc, shape)
        if not bool((want != 0).any()):
            raise SystemExit(f"hash_encode_bwd edge {label}: zero gradient")
        for lane_map in E.LANE_MAPS:
            plan = E.hash_bwd_plan(x.shape[-2], K, hc, sms,
                                   lane_map=lane_map, **kw)
            got = E.hash_encode_bwd_planned(x, g, hc, shape, plan=plan)
            err = rel_err(got, want)
            ms = cuda_ms(lambda: E.hash_encode_bwd_planned(
                x, g, hc, shape, plan=plan), 3)
            print(f"edge hash_encode_bwd {label}: K={K} N={x.shape[-2]} "
                  f"err/max={err:.3e} tol=0.0001 kernel_ms={ms:.4f} plan "
                  f"{hash_plan_text(plan)}", flush=True)
            if not err <= 1e-4:
                raise SystemExit(f"kernel hash_encode_bwd disagrees with its "
                                 f"plain version on {label} ({lane_map}): "
                                 f"{err}")
            del got
        del want
    torch.cuda.empty_cache()


def packed_serve(cfg, statics, params, occ, device):
    """The packed-pair experts (the runner's --packed_gather) served: one
    chunk through the kernels against the plain path, then full 800x800
    frames through `render_image`, packed and fp32 in turns (fp32,
    packed, packed, fp32), and one profiled packed frame. The counters
    are zeroed just before the packed chunk; the packed renders' launches
    are summed (7b alone of the two forwards)."""
    import torch

    from nerfsys_tpu_torch import kernels
    from nerfsys_tpu_torch.data.ram_rays import frame_rays
    from nerfsys_tpu_torch.pipelines.online.runtime_adapt import (
        default_chunk_rays,
        make_chunk_renderer,
        render_image,
    )

    pcfg = with_hash(cfg, packed=True)
    md = pose((0.0, 0.0, 2.0))
    aabb = statics.global_aabb.cpu().numpy()
    rays, _ = frame_rays(SIDE, SIDE, md.intrinsics, md.c2w, aabb=aabb)
    chunk = torch.from_numpy(rays[:CHECK_RAYS]).to(device)
    renderers = {}
    out = []
    for use in (True, False):
        renderer = make_chunk_renderer(pcfg, ray_samples=32, occ_state=occ,
                                       occ_importance=True,
                                       occ_hard_mask=False, device=device,
                                       use_kernels=use)
        torch.cuda.synchronize()
        if use:
            kernels.reset_launches()
            renderers["packed"] = renderer
        out.append(renderer(params, statics, chunk))
        torch.cuda.synchronize()
        if use:
            launches = kernels.launches()
    chunk_matches_plain("hash serve packed", *out)
    del out
    renderers["fp32"] = make_chunk_renderer(
        cfg, ray_samples=32, occ_state=occ, occ_importance=True,
        occ_hard_mask=False, device=device)
    size = CHUNK or default_chunk_rays(32)
    render_image(renderers["fp32"], params, statics, md, scene_aabb=aabb,
                 chunk_rays=size)  # warm-up
    times = {"fp32": [], "packed": []}
    for name in ("fp32", "packed", "packed", "fp32"):
        torch.cuda.synchronize()
        before = kernels.launches()
        t0 = time.perf_counter()
        rgb, depth, acc = render_image(renderers[name], params, statics, md,
                                       scene_aabb=aabb, chunk_rays=size)
        times[name].append(1e3 * (time.perf_counter() - t0))
        check_frame(f"hash serve {name}", rgb, depth, acc, (SIDE, SIDE, 3))
        if name == "packed":
            after = kernels.launches()
            launches = {k: v + after[k] - before[k]
                        for k, v in launches.items()}
    print(f"hash serve packed: launches for one chunk and 2 frames "
          f"{launches}", flush=True)
    if launches["hash_encode_fwd_packed"] <= 0 or launches[
            "hash_encode_fwd"] != 0:
        raise SystemExit("hash serve packed: the packed renders did not go "
                         "through hash_encode_fwd_packed alone")
    mean = {k: sum(v) / len(v) for k, v in times.items()}
    print(f"hash serve packed: {SIDE}x{SIDE} frames in turns: packed ms="
          f"{[round(x, 2) for x in times['packed']]} mean_ms="
          f"{mean['packed']:.2f}; fp32 ms="
          f"{[round(x, 2) for x in times['fp32']]} mean_ms="
          f"{mean['fp32']:.2f}", flush=True)
    profile_frame(renderers["packed"], params, statics, md, aabb, size,
                  label="hash serve packed frame")
    return launches


def hash_phase(statics, occ, rays_np, batch, device, results):
    """Phase: the runner's default hash-grid experts served and trained
    (kernel row 7 checks, 3 live 800x800 frames, a packed chunk and 2
    packed frames, 3 bench FoMAML steps and one packed step) -> launches
    per part."""
    t0 = time.perf_counter()
    cfg, params = hash_setup(device)
    check_hash_kernels(cfg, statics, params, occ, rays_np, batch, device,
                       results)
    served = serve(cfg, statics, params, occ, device, label="hash serve",
                   need=HASH_SERVE_KERNELS,
                   idle=("hash_encode_fwd_packed", "hash_encode_bwd"))
    packed = packed_serve(cfg, statics, params, occ, device)
    light, trained, _ = train(
        cfg, statics, params, occ, batch, device, label="hash train",
        extra=(lambda c: with_hash(c, packed=True), "packed"),
        need=HASH_TRAIN_KERNELS)
    print(f"hash: phase took {time.perf_counter() - t0:.1f} s", flush=True)
    served = {k: v + packed[k] for k, v in served.items()}
    return served, light, trained


MOE_CF = 1.5  # capacity factor of --render_fast and measure_moe
UNION_RES = 128  # --render_fast's --occ_union_probe_res
SKEW = 0.9  # the share of rays aimed into expert 0 in the coherent frame
K16_PTS, K16_CHUNKS = 1_572_864, 8  # measure_moe's shape
FAST_KERNELS = ("bucket_dispatch", "hash_encode_fwd", "occupancy_probe_cdf",
                "sample_tvals_from_cdf", "volume_render_fwd")
COHERENT_KERNELS = ("coherent_expert", "hash_encode_fwd",
                    "occupancy_probe_cdf", "sample_tvals_from_cdf",
                    "volume_render_fwd")
K16_KERNELS = ("bucket_dispatch", "bucket_combine_fwd", "plane_encode_fwd")


def fast_cfg(cfg):
    """--render_fast's routing on `cfg`: bucketed top-1, cf 1.5."""
    import dataclasses

    return dataclasses.replace(cfg, bucketed=True, experts_per_point=1,
                               capacity_factor=MOE_CF)


def chunk_samples(statics, occ, rays_np, device):
    """The serve chunk's sample points (N, 32, 3) and per-point directions
    (N * 32, 3), from the soft importance probe and the sampler."""
    import torch

    from nerfsys_tpu_torch.models.occupancy import _ray_validity
    from nerfsys_tpu_torch.ops import occupancy as O
    from nerfsys_tpu_torch.ops import volrend as V

    rays = torch.from_numpy(rays_np).to(device)
    o, d = rays[:, 0:3].contiguous(), rays[:, 3:6].contiguous()
    _, near, far = _ray_validity(rays)
    cdf = O.occupancy_probe_cdf(occ["occs"], occ["binary"],
                                statics.expert_aabbs, o, d, near, far, 128,
                                importance=True, ray_floor=0.25)
    t_vals, _ = O.sample_tvals_from_cdf(cdf, near, far, 32)
    pts = V.t_to_points(o, d, t_vals).contiguous()
    dirs = d[:, None, :].expand(pts.shape).reshape(-1, 3).contiguous()
    return pts, dirs


DISPATCH_KEYS = ("idx", "dest", "counts", "bucket_rows", "rows")


def dispatch_check(label, pts, dirs, cents, cluster_2d, margin, E, C,
                   edge=False):
    """10a-i against its plain version on one input, called twice (a
    second call on recycled scratch must give the same outputs): idx,
    dest, counts, bucket_rows and rows equal, w within 1e-6. Prints one
    `kernel bucket_dispatch: <label>` (or `edge bucket_dispatch <label>:`)
    line with device and back-to-back times, bytes and bound; returns the
    kernel's outputs and (w error, device ms, plain ms, bound ms, bound
    by, bytes)."""
    import torch

    from nerfsys_tpu_torch.models import container as CO

    N, K = pts.shape[0], cents.shape[0]
    args = (pts, dirs, cents, cluster_2d, margin, E, C)
    ker = CO.bucket_dispatch_kernel(*args)
    again = CO.bucket_dispatch_kernel(*args)
    pln = CO.bucket_dispatch_plain(*args)
    torch.cuda.synchronize()
    for key in DISPATCH_KEYS:
        for name, got in (("first", ker), ("second", again)):
            if not torch.equal(got[key], pln[key]):
                bad = int((got[key] != pln[key]).sum())
                raise SystemExit(f"kernel bucket_dispatch: {key} differs from "
                                 f"the plain version at {bad} entries on the "
                                 f"{name} call ({label})")
    w_err = max(max_err(ker["w"], pln["w"]), max_err(again["w"], pln["w"]))
    if not w_err <= 1e-6:
        raise SystemExit(f"kernel bucket_dispatch: w error {w_err} ({label})")
    counts = pln["counts"].tolist()
    dropped = int((ker["dest"] == K * C).sum()) - int(
        (pln["w"] <= 0).sum())
    ms = device_ms(lambda: CO.bucket_dispatch_kernel(*args), 10)
    b2b = cuda_ms(lambda: CO.bucket_dispatch_kernel(*args), 10)
    plain_ms = 0.0 if edge else cuda_ms(
        lambda: CO.bucket_dispatch_plain(*args), 2)
    n_bytes = nbytes(pts, dirs, ker["idx"], ker["w"], ker["dest"],
                     ker["counts"], ker["bucket_rows"], ker["rows"])
    # distances: 5 products, 4 sums, max, sqrt a (point, expert)
    b_ms, b_by = bound(n_bytes, N * K * 12)
    head = (f"edge bucket_dispatch {label}:" if edge
            else f"kernel bucket_dispatch: {label}")
    print(f"{head} {N} points K={K} E={E} margin={margin:g} tile="
          f"{CO.dispatch_tile(E)} cluster_2d="
          f"{cluster_2d} width={ker['rows'].shape[-1]} C={C} demand="
          f"{counts if K <= 16 else max(counts)} overflow pairs {dropped}, "
          f"idx/dest/counts/bucket_rows/rows equal on two calls, w "
          f"max_abs_err={w_err:.3e} (tol 1e-6) device_ms={ms:.4f} "
          f"back_to_back_ms={b2b:.4f}"
          + ("" if edge else f" plain_ms={plain_ms:.4f}")
          + f" bytes={n_bytes} bound_ms={b_ms:.4f} ({b_by}) at "
          f"{HBM_BYTES_PER_S / 1e12:g} TB/s", flush=True)
    del again, pln
    return ker, (w_err, ms, plain_ms, b_ms, b_by, n_bytes)


def dispatch_edge_inputs(kind: str, n: int, k: int, with_dirs: bool,
                         cluster_2d: bool, margin: float, seed: int,
                         device):
    """Adversarial inputs of 10a-i from numpy seed `seed`: pts (n, 3), dirs
    (n, 3) or None, centroids (k, 3). K=4 takes the bench centroids
    ((0, +-1, +-1): pairs mirrored in y and in z), other K random ones in
    the bench box. "one" puts every point within 0.05 of centroid 0 (its
    demand exceeds any C of cf 1.5 with K > 1); "ties" sets z = 0 on half
    the points and y = 0 on a quarter (bit-equal distances to mirrored
    centroids); "margin" puts the points on the routing segments between
    neighbouring centroids at the least float step where the far
    centroid's distance falls within margin x the near one's (the soft
    weight's test), every second point one float step before it (a
    bisection over the floats on `device`); otherwise uniform in the box."""
    import numpy as np
    import torch

    from nerfsys_tpu_torch.models import container as CO
    from nerfsys_tpu_torch.ops import occupancy as O

    f32 = np.float32
    rng = np.random.default_rng(seed)
    if k == 4:
        cents = np.array([[0.0, -1, -1], [0.0, -1, 1], [0.0, 1, -1],
                          [0.0, 1, 1]], f32)
    else:
        cents = rng.uniform(-2.0, 2.0, (k, 3)).astype(f32)
    pts = rng.uniform(-2.2, 2.2, (n, 3)).astype(f32)
    if kind == "one":
        pts = (cents[0] + rng.uniform(-0.05, 0.05, (n, 3))).astype(f32)
    elif kind == "ties":
        pts[: n // 2, 2] = 0.0
        pts[: n // 4, 1] = 0.0
    dirs = rng.normal(size=(n, 3)).astype(f32)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    out = [torch.from_numpy(a).to(device) for a in (pts, dirs, cents)]
    if kind == "margin":
        pair = rng.integers(0, k, size=n)
        a = cents[pair] + rng.uniform(-0.05, 0.05, (n, 3)).astype(f32)
        b = cents[(pair + 1) % k]
        a, b = (torch.from_numpy(v.astype(f32)).to(device) for v in (a, b))
        c = out[2]

        def point(s):
            return a + s[:, None] * (b - a)

        def inside(s):  # the far end within margin x the nearest distance
            d = CO._centroid_dist(c, cluster_2d, point(s))
            d = torch.clamp(d, min=1e-6)
            near = d.gather(1, torch.from_numpy(pair).to(device)[:, None])
            far = d.gather(1, torch.from_numpy((pair + 1) % k).to(device)[
                :, None])
            return (far <= margin * near)[:, 0]

        s = O._first_float(inside, torch.zeros(n, device=device),
                           torch.ones(n, device=device))
        before = torch.nextafter(s, torch.zeros_like(s))
        s = torch.where(torch.arange(n, device=device) % 2 == 1, before, s)
        out[0] = point(s).contiguous()
    return out[0], out[1] if with_dirs else None, out[2]


def dispatch_edge_cases():
    """(label, kind, N, K, E, margin, cluster_2d, with_dirs) of
    `dispatch_edges`, at the serve chunk's 2,097,152 points (cf 1.5)
    unless N says otherwise."""
    n = CHECK_RAYS * 32
    return [("all points on one expert (demand > C)", "one", n, 4, 1, 1.1,
             True, True),
            ("all points on one expert, E=2", "one", n, 4, 2, 1.1, True,
             True),
            ("equidistant points (ties)", "ties", n, 4, 2, 1.1, True, True),
            ("ties, cluster_2d off", "ties", n, 4, 2, 1.1, False, True),
            ("distances at the margin", "margin", n, 4, 2, 1.1, True, True),
            ("hard routing, E=4 (3 zero-weight pairs a point)", "rand", n, 4,
             4, 1.0, True, True),
            ("N not a multiple of the tile", "rand", n - 13, 4, 2, 1.1, True,
             True),
            ("N below one tile", "rand", 200, 4, 2, 1.1, True, True),
            ("a single point", "rand", 1, 4, 1, 1.1, True, True),
            ("cluster_2d off", "rand", n, 4, 2, 1.1, False, True),
            ("no directions (3-wide rows)", "rand", n, 4, 2, 1.1, True,
             False),
            ("K=1", "rand", n, 1, 1, 1.1, True, True),
            ("K=16", "rand", n, 16, 2, 1.1, True, True),
            ("K=64", "rand", n, 64, 2, 1.1, True, True),
            ("K=64, E=8, margin 1.3", "rand", n // 8, 64, 8, 1.3, False,
             True)]


def dispatch_edges(device):
    """10a-i against its plain version on `dispatch_edge_cases`."""
    from nerfsys_tpu_torch.models import container as CO

    for seed, (label, kind, n, k, e, margin, c2d, with_dirs) in enumerate(
            dispatch_edge_cases()):
        pts, dirs, cents = dispatch_edge_inputs(kind, n, k, with_dirs, c2d,
                                                margin, seed, device)
        C = CO.bucket_capacity(n, k, e, MOE_CF)
        dispatch_check(label, pts, dirs, cents, c2d, margin, e, C,
                       edge=True)


COHERENT_EDGE_N = 4096 + 13  # a tail past whole blocks at every plan


def coherent_edge_inputs(kind: str, n: int, k: int, s: int, seed: int,
                         device):
    """Adversarial inputs of 10b from numpy seed `seed`: centroids (k, 3) on
    an integer lattice 4 apart, (0, 4 (i mod 8), 4 (i div 8)), distinct in
    (y, z), and points (n, s, 3) on a 1/64 grid, so that every routing
    distance below is exact in float32. A ray's samples lie around one
    centroid (spread 0.3; "rand" draws 0.05, 0.8 or 2.5 a ray, so that some
    rays are coherent and some are not). "bisector" moves samples of every
    ray onto the plane halfway to a lattice neighbour (equal distances: the
    argmin takes the first index, soft routing sees no singleton);
    "at_centroid" duplicates centroid 0 as centroid 1 and puts samples
    exactly on centroids (d = 0 clamps to 1e-6: at centroids 0 and 1 both
    do, so no singleton; elsewhere a singleton); "margin_eq" puts one
    sample a ray at distances 2 and 3 from centroids 0 and 1 (centroid 1
    moved to (0, 5, 0): d2 = 1.5 d1 exactly) on even rays and at 1.984375
    and 3.015625 on odd ones; "break0", "break_last" and "break32" move
    sample 0, the last sample or sample 32 of every even ray onto
    centroid 1."""
    import numpy as np
    import torch

    f32 = np.float32
    rng = np.random.default_rng(seed)
    i = np.arange(k)
    cents = np.stack([np.zeros(k), 4.0 * (i % 8), 4.0 * (i // 8)], 1)
    base = rng.integers(0, k, size=n)
    spread = np.full((n, 1, 1), 0.3)
    if kind == "rand":
        spread = rng.choice([0.05, 0.8, 2.5], size=(n, 1, 1))
    if kind == "at_centroid" and k > 1:
        cents[1] = cents[0]
    if kind in ("margin_eq", "break0", "break_last", "break32"):
        base[:] = 0
    if kind == "margin_eq" and k > 1:
        cents[1] = (0.0, 5.0, 0.0)
    pts = cents[base][:, None, :] + spread * rng.normal(size=(n, s, 3))
    pts = np.round(pts * 64.0) / 64.0
    even = np.arange(n) % 2 == 0
    col = rng.integers(0, s, size=n)  # a sample a ray
    if kind == "bisector" and k > 1:
        # the lattice neighbour in y (or the one before it at the row's end)
        up = (base % 8 < 7) & (base + 1 < k)
        other = np.where(up, base + 1, base - 1)
        mid = 0.5 * (cents[base] + cents[other])
        for j in range(s):
            on = rng.uniform(size=n) < 0.25
            pts[on, j, 1] = mid[on, 1]
            pts[on, j, 2] = np.where(cents[base[on], 2] == cents[other[on], 2],
                                     pts[on, j, 2], mid[on, 2])
    elif kind == "at_centroid":
        on = rng.uniform(size=(n, s)) < 0.3
        pts[on] = cents[base][:, None, :].repeat(s, 1)[on]
    elif kind == "margin_eq" and k > 1:
        rows = np.arange(n)
        pts[rows, col] = np.where(even[:, None], [[0.0, 2.0, 0.0]],
                                  [[0.0, 2.0 - 1 / 64, 0.0]])
    elif kind.startswith("break") and k > 1:
        j = {"break0": 0, "break_last": s - 1, "break32": min(32, s - 1)}[
            kind]
        pts[even, j] = cents[1]
    return (torch.from_numpy(cents.astype(f32)).to(device),
            torch.from_numpy(pts.astype(f32)).to(device))


def coherent_edge_cases():
    """(label, kind, N, K, S, cluster_2d, margin) of `coherent_edges`."""
    n = COHERENT_EDGE_N
    return ([(f"K={k}", "rand", n, k, 32, True, 1.1)
             for k in (1, 2, 4, 16, 64)]
            + [(f"S={s}", "rand", n, 4, s, True, 1.1)
               for s in (1, 2, 8, 31, 33, 64, 97)]
            + [("cluster_2d off", "rand", n, 4, 32, False, 1.1),
               ("cluster_2d off, K=16, S=97", "rand", n, 16, 97, False, 1.5),
               ("margin 1.0 (hard)", "rand", n, 4, 32, True, 1.0),
               ("margin 1.5", "rand", n, 4, 32, True, 1.5),
               ("points on a bisector, hard", "bisector", n, 4, 32, True,
                1.0),
               ("points on a bisector, soft", "bisector", n, 4, 32, True,
                1.1),
               ("points on a bisector, cluster_2d off, K=16, S=8",
                "bisector", n, 16, 8, False, 1.0),
               ("points at duplicated centroids, hard", "at_centroid", n, 4,
                32, True, 1.0),
               ("points at duplicated centroids, soft", "at_centroid", n, 4,
                32, True, 1.1),
               ("points at duplicated centroids, K=2, S=33", "at_centroid",
                n, 2, 33, True, 1.5),
               ("d2 = margin x d1 exactly, margin 1.5", "margin_eq", n, 4,
                32, True, 1.5),
               ("d2 = 1.5 d1, margin 1.1", "margin_eq", n, 4, 32, True, 1.1),
               ("d2 = 1.5 d1, cluster_2d off, S=64", "margin_eq", n, 4, 64,
                False, 1.5),
               ("a break only at sample 0", "break0", n, 4, 32, True, 1.0),
               ("a break only at sample 0, S=97", "break0", n, 4, 97, True,
                1.1),
               ("a break only at the last sample", "break_last", n, 4, 32,
                True, 1.1),
               ("a break only at the last sample, S=97", "break_last", n, 4,
                97, True, 1.0),
               ("a break only at sample 32 (a piece boundary), S=33",
                "break32", n, 4, 33, True, 1.1),
               ("a break only at sample 32, S=64", "break32", n, 4, 64, True,
                1.0),
               ("a break only at sample 32, S=97", "break32", n, 4, 97, True,
                1.5),
               ("N=0", "rand", 0, 4, 32, True, 1.1),
               ("N=1", "rand", 1, 4, 32, True, 1.1),
               ("N=1, S=97", "rand", 1, 4, 97, True, 1.1),
               ("N=1, S=1", "rand", 1, 4, 1, True, 1.1),
               ("whole blocks only (N=4096)", "rand", 4096, 4, 32, True,
                1.1)])


def coherent_needed(cents, pts_ns, cluster_2d: bool, margin: float):
    """(N,) samples 10b must read of each ray: up to its first sample that
    breaks coherence, all S for a coherent ray. The work depends on the
    data, so its bound counts these points (12 B each) and the ids."""
    import torch

    from nerfsys_tpu_torch.models import container as CO

    N, S, K = pts_ns.shape[0], pts_ns.shape[1], cents.shape[0]
    dist = CO._centroid_dist(cents, cluster_2d,
                             pts_ns.reshape(-1, 3)).reshape(N, S, K)
    a = torch.argmin(dist, dim=-1)
    ok = a == a[:, :1]
    if margin > 1.0 and K > 1:
        top2 = torch.sort(torch.clamp(dist, min=1e-6), dim=-1).values
        ok &= top2[..., 1] > margin * top2[..., 0]
    bad = ~ok
    return torch.where(bad.any(dim=1), bad.int().argmax(dim=1) + 1, S)


def coherent_bound(cents, pts_ns, cluster_2d: bool, margin: float):
    """(bytes, bound ms, bound_by) of 10b on these rays: the points each
    ray needs (`coherent_needed`) and the ids."""
    samples = int(coherent_needed(cents, pts_ns, cluster_2d, margin).sum())
    n_bytes = samples * 12 + pts_ns.shape[0] * 4
    return (n_bytes, *bound(n_bytes, samples * cents.shape[0] * 14))


def coherent_skew_chunk(statics, cents, margin: float, device):
    """10b on the first chunk of the skew-0.9 frame (the coherent
    renderer's probe samples): (coherent share, device ms, bound ms); ids
    equal to the plain version's."""
    import torch

    from nerfsys_tpu_torch.models import container as CO
    from nerfsys_tpu_torch.models.occupancy import occ_sample_positions

    rays = torch.from_numpy(skew_frame(SIDE * SIDE)[:CHECK_RAYS]).to(device)
    pts = occ_sample_positions(full_occ(device), statics, rays, 32,
                               importance=True,
                               hard_mask=False)[0].contiguous()
    got = CO.coherent_expert_kernel(cents, pts, True, margin)
    if not torch.equal(got, CO.coherent_expert_plain(cents, pts, True,
                                                     margin)):
        raise SystemExit("kernel coherent_expert: ids differ from the plain "
                         "version on the skew chunk")
    dev = device_ms(lambda: CO.coherent_expert_kernel(cents, pts, True,
                                                      margin))
    return (float((got >= 0).float().mean()), dev,
            coherent_bound(cents, pts, True, margin)[1])


def coherent_plan(n: int, s: int):
    """10b's launch plan for N rays of S samples."""
    from nerfsys_tpu_torch.models import container as CO
    from nerfsys_tpu_torch.ops.volrend import ray_lane_plan

    return ray_lane_plan(n, s, CO.COHERENT_GROUPS, CO.COHERENT_LANES)


def coherent_edges(device):
    """10b against its plain version on `coherent_edge_cases`: ids equal,
    each line with its plan and the share of coherent rays."""
    import torch

    from nerfsys_tpu_torch.models import container as CO

    for seed, (label, kind, n, k, s, c2d, margin) in enumerate(
            coherent_edge_cases()):
        cents, pts = coherent_edge_inputs(kind, n, k, s, seed, device)
        got = CO.coherent_expert_kernel(cents, pts, c2d, margin)
        want = CO.coherent_expert_plain(cents, pts, c2d, margin)
        torch.cuda.synchronize()
        differ = int((got != want).sum())
        share = float((want >= 0).float().mean()) if n else 0.0
        print(f"edge coherent_expert {label}: N={n} S={s} K={k} cluster_2d="
              f"{c2d} margin={margin:g} ids differ {differ} (0 required); "
              f"coherent share {share:.4f}; plan "
              f"{lane_plan_text(coherent_plan(n, s))}", flush=True)
        if differ:
            raise SystemExit(f"edge coherent_expert {label}: {differ} ids "
                             f"differ from the plain version")


def combine_bwd_check(label, w, dest, counts, g_s, g_r, n_slots,
                      edge=False):
    """10a-iii against its plain version on one input: equal (one product
    a slot; the error is also printed relative to the output's max, tol
    1e-6). Prints one `kernel bucket_combine_bwd: <label>` (or `edge
    bucket_combine_bwd <label>:`) line with device and back-to-back times,
    bytes and bound; returns (max abs error, device ms, back-to-back ms,
    plain ms, bound ms, bound by, bytes)."""
    import torch

    from nerfsys_tpu_torch.models import container as CO

    N, E = w.shape
    K = counts.shape[0]
    C = n_slots // K

    def call():
        return CO.bucket_combine_bwd_kernel(w, dest, g_s, g_r, n_slots,
                                            counts=counts)

    got = call()
    want = CO.bucket_combine_bwd_plain(w, dest, g_s, g_r, n_slots)
    torch.cuda.synchronize()
    pairs = [(got[0], want[0])] + ([] if g_r is None else
                                   [(got[1], want[1])])
    equal = all(torch.equal(a, b) for a, b in pairs)
    err = max(max_err(a, b) for a, b in pairs)
    rel = max(rel_err(a, b) for a, b in pairs)
    ms = device_ms(call, 10)
    b2b = cuda_ms(call, 10)
    plain_ms = 0.0 if edge else cuda_ms(
        lambda: CO.bucket_combine_bwd_plain(w, dest, g_s, g_r, n_slots), 3)
    width = 4 if g_r is None else 16
    n_bytes = nbytes(w, dest, counts, g_s, g_r) + n_slots * width
    b_ms, b_by = bound(n_bytes, N * E * (1 if g_r is None else 4))
    kept = int((dest < n_slots).sum())
    plan = CO.combine_bwd_plan(N, K, E, C, CO.num_sms(w.device))
    head = (f"edge bucket_combine_bwd {label}:" if edge
            else f"kernel bucket_combine_bwd: {label}")
    print(f"{head} N={N} K={K} E={E} C={C} kept slots {kept} of {n_slots}"
          f" (demand {counts.tolist() if K <= 16 else int(counts.max())}) "
          f"rgb={g_r is not None} plan tile={plan.tile} tiles={plan.tiles} "
          f"fill_blocks={plan.fill_blocks} equal={equal} max_abs_err="
          f"{err:.3e} err/max={rel:.3e} (tol 1e-6) device_ms={ms:.4f} "
          f"back_to_back_ms={b2b:.4f}"
          + ("" if edge else f" plain_ms={plain_ms:.4f}")
          + f" bytes={n_bytes} bound_ms={b_ms:.4f} ({b_by}) at "
          f"{HBM_BYTES_PER_S / 1e12:g} TB/s", flush=True)
    if not rel <= 1e-6:
        raise SystemExit(f"kernel bucket_combine_bwd disagrees with its "
                         f"plain version ({label}): {rel}")
    return err, ms, b2b, plain_ms, b_ms, b_by, n_bytes


def combine_edge_cases():
    """(label, kind, N, K, E, margin, with_rgb) of `combine_edges`: 10a-iii
    on dispatches of `dispatch_edge_inputs` (cf 1.5, cluster_2d), at the
    serve chunk's 2,097,152 points unless N says otherwise. "empty" adds a
    centroid far outside the box, whose bucket stays empty; "one" puts
    every point on expert 0, whose demand exceeds C (the overflow that
    `bucket_overflow_dense=False` renders through the buckets)."""
    n = CHECK_RAYS * 32
    return [("E=1", "rand", n, 4, 1, 1.1, True),
            ("E=8, K=16, margin 1.3", "rand", n // 8, 16, 8, 1.3, True),
            ("hard routing, E=2 (the second pair trashed)", "rand", n, 4, 2,
             1.0, True),
            ("an empty bucket", "empty", n, 5, 2, 1.1, True),
            ("overflow (bucket_overflow_dense=False)", "one", n, 4, 2, 1.1,
             True),
            ("N not a multiple of the tile", "rand", n - 13, 4, 2, 1.1,
             True),
            ("N below one tile", "rand", 200, 4, 2, 1.1, True),
            ("a single point", "rand", 1, 4, 1, 1.1, True),
            ("no rgb", "rand", n, 4, 2, 1.1, False),
            ("K=64", "rand", n, 64, 2, 1.1, True)]


def combine_edge_inputs(kind: str, n: int, k: int, e: int, margin: float,
                        with_rgb: bool, seed: int, device):
    """A dispatch of `dispatch_edge_inputs`' points on `device` and
    upstream gradients from numpy seed `seed` -> (w, dest, counts, g_sigma,
    g_rgb or None, n_slots)."""
    import numpy as np
    import torch

    from nerfsys_tpu_torch.models import container as CO

    far = kind == "empty"
    pts, dirs, cents = dispatch_edge_inputs(
        "rand" if far else kind, n, k - 1 if far else k, True, True, margin,
        seed, device)
    if far:
        cents = torch.cat([cents, torch.full((1, 3), 50.0, device=device)])
    C = CO.bucket_capacity(n, k, e, MOE_CF)
    dsp = CO.bucket_dispatch_kernel(pts, dirs, cents, True, margin, e, C)
    rng = np.random.default_rng(seed + 100)
    g_s = torch.from_numpy(rng.normal(size=n).astype(np.float32)).to(device)
    g_r = (torch.from_numpy(rng.normal(size=(n, 3)).astype(np.float32))
           .to(device) if with_rgb else None)
    return dsp["w"], dsp["dest"], dsp["counts"], g_s, g_r, k * C


def combine_edges(device):
    """10a-iii against its plain version on `combine_edge_cases`."""
    for seed, (label, kind, n, k, e, margin, rgb) in enumerate(
            combine_edge_cases()):
        combine_bwd_check(label, *combine_edge_inputs(
            kind, n, k, e, margin, rgb, seed, device), edge=True)


def check_dispatch_k16(cfg, statics, pts, dirs, results):
    """10a-i at the K=16 arm's shape: one chunk of measure_moe's points
    (196,608), E=2, cf 1.5, against its plain version on two calls."""
    from nerfsys_tpu_torch import kernels
    from nerfsys_tpu_torch.models import container as CO

    N, K = pts.shape[0], statics.centroids.shape[0]
    C = CO.bucket_capacity(N, K, 2, MOE_CF)
    _, (w_err, ms, plain_ms, b_ms, b_by, n_bytes) = dispatch_check(
        f"K={K} E=2 cf {MOE_CF:g} (one chunk of the K=16 arm)", pts, dirs,
        statics.centroids.contiguous(), cfg.cluster_2d,
        float(cfg.boundary_margin), 2, C)
    results[kernels.BUCKET_DISPATCH.name]["text"] += (
        f"; K={K} E=2 at {N} points: device_ms={ms:.4f} bytes={n_bytes} "
        f"bound_ms={b_ms:.4f} ({b_by}), equal on two calls")
    import torch

    dsp = CO.bucket_dispatch_kernel(pts, dirs, statics.centroids.contiguous(),
                                    cfg.cluster_2d,
                                    float(cfg.boundary_margin), 2, C)
    gen = torch.Generator(device=pts.device).manual_seed(12)
    g_s = torch.randn((N,), device=pts.device, generator=gen)
    g_r = torch.randn((N, 3), device=pts.device, generator=gen)
    _, ms, b2b, _, b_ms, b_by, n_bytes = combine_bwd_check(
        f"K={K} E=2 at {N} points (one chunk of the K=16 arm)", dsp["w"],
        dsp["dest"], dsp["counts"], g_s, g_r, K * C)
    results[kernels.BUCKET_COMBINE_BWD.name]["text"] += (
        f"; K={K} E=2 at {N} points: device_ms={ms:.4f} (back to back "
        f"{b2b:.4f}) bytes={n_bytes} bound_ms={b_ms:.4f} ({b_by})")


def check_moe_kernels(cfg, statics, occ, rays_np, device, results):
    """Kernel row 10 against its plain versions on the card at one full
    serve chunk (65,536 rays x 32 samples = 2,097,152 points, K=4): 10a-i
    for E=1 and 2, soft (margin 1.1) and hard (1.0), cf 1.5 (idx, dest,
    counts, bucket rows and gathered rows equal, w within 1e-6, on two
    successive calls) and on `dispatch_edge_cases`; 10a-ii and
    10a-iii on the E=2 soft dispatch with random bucket results (within
    1e-6 of the output's max), `embedding_bag` timed beside 10a-ii; 10b on
    the chunk's (65,536, 32, 3) samples (ids equal; device and back-to-back
    times) and on `coherent_edge_cases`; kernel 2 on the res-128 union
    probe grid of the bench occupancy."""
    import torch

    from nerfsys_tpu_torch import kernels
    from nerfsys_tpu_torch.models import container as CO
    from nerfsys_tpu_torch.models import occupancy as MO
    from nerfsys_tpu_torch.ops import occupancy as O

    pts_ns, dirs = chunk_samples(statics, occ, rays_np, device)
    pts = pts_ns.reshape(-1, 3).contiguous()
    cents = statics.centroids.contiguous()
    N, K = pts.shape[0], cents.shape[0]
    worst_w, timed, soft2 = 0.0, {}, None
    for E in (1, 2):
        for margin in (1.1, 1.0):
            C = CO.bucket_capacity(N, K, E, MOE_CF)
            ker, stats = dispatch_check(f"E={E} margin={margin:g}", pts,
                                        dirs, cents, True, margin, E, C)
            w_err, ms, plain_ms, b_ms, b_by, n_bytes = stats
            worst_w = max(worst_w, w_err)
            timed[(E, margin)] = (ms, plain_ms, b_ms, b_by, n_bytes)
            if E == 2 and margin > 1.0:
                soft2 = (ker, C)
            del ker
    ms, plain_ms, b_ms, b_by, n_bytes = timed[(1, 1.1)]
    results[kernels.BUCKET_DISPATCH.name] = dict(
        max_abs_err=worst_w, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
        bound_by=b_by,
        text=(f"E=1 margin 1.1 (--render_fast) at {N} points: kernel_ms="
              f"{ms:.4f} (device) plain_ms={plain_ms:.4f} bytes={n_bytes} "
              f"bound_ms={b_ms:.4f} ({b_by}); E=2 margin 1.1 device_ms="
              f"{timed[(2, 1.1)][0]:.4f}; integer outputs equal in all four "
              f"configurations on two successive calls, w max_abs_err="
              f"{worst_w:.3e} (tol 1e-6)"))
    dispatch_edges(device)

    # 10a-ii / 10a-iii on the E=2 soft dispatch
    dsp, C = soft2
    w, dest = dsp["w"], dsp["dest"]
    gen = torch.Generator(device=device).manual_seed(11)
    sb = torch.randn((K * C,), device=device, generator=gen)
    rb = torch.rand((K * C, 3), device=device, generator=gen)
    got = CO.bucket_combine_kernel(w, dest, sb, rb)
    want = CO.bucket_combine_plain(w, dest, sb, rb)
    torch.cuda.synchronize()
    err = max(rel_err(got[0], want[0]), rel_err(got[1], want[1]))
    table = torch.cat([torch.cat([rb, sb[:, None]], 1),
                       torch.zeros((1, 4), device=device)])
    bags = dest.view(N, 2).long()
    psw = torch.where(dest < K * C, w.reshape(-1), 0.0).view(N, 2)
    lib = torch.nn.functional.embedding_bag(bags, table,
                                            per_sample_weights=psw,
                                            mode="sum")
    lib_err = max(max_err(lib[:, 3], want[0]), max_err(lib[:, :3], want[1]))
    ms = cuda_ms(lambda: CO.bucket_combine_kernel(w, dest, sb, rb), 20)
    plain_ms = cuda_ms(lambda: CO.bucket_combine_plain(w, dest, sb, rb), 3)
    lib_ms = cuda_ms(lambda: torch.nn.functional.embedding_bag(
        bags, table, per_sample_weights=psw, mode="sum"), 20)
    n_bytes = N * 2 * (4 + 4 + 16) + N * 16
    b_ms, b_by = bound(n_bytes, N * 2 * 8)
    text = (f"E=2 margin 1.1 at {N} points: err/max={err:.3e} tol=1e-6 "
            f"(2-term sums in e order, as the plain version) kernel_ms="
            f"{ms:.4f} plain_ms={plain_ms:.4f} embedding_bag_ms={lib_ms:.4f} "
            f"(max_abs_err vs plain {lib_err:.3e}) bytes={n_bytes} bound_ms="
            f"{b_ms:.4f} ({b_by}) at {HBM_BYTES_PER_S / 1e12:g} TB/s")
    print(f"kernel bucket_combine_fwd: {text}", flush=True)
    if not err <= 1e-6:
        raise SystemExit(f"kernel bucket_combine_fwd disagrees: {err}")
    results[kernels.BUCKET_COMBINE_FWD.name] = dict(
        max_abs_err=max(max_err(got[0], want[0]), max_err(got[1], want[1])),
        ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
        library_ms=lib_ms, text=text)

    g_s = torch.randn((N,), device=device, generator=gen)
    g_r = torch.randn((N, 3), device=device, generator=gen)
    err, ms, b2b, plain_ms, b_ms, b_by, n_bytes = combine_bwd_check(
        f"E=2 margin 1.1 at {N} points", w, dest, dsp["counts"], g_s, g_r,
        K * C)
    results[kernels.BUCKET_COMBINE_BWD.name] = dict(
        max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
        bound_by=b_by,
        text=(f"E=2 margin 1.1 at {N} points into {K}x{C} slots: kernel_ms="
              f"{ms:.4f} (device; back to back {b2b:.4f}) plain_ms="
              f"{plain_ms:.4f} bytes={n_bytes} bound_ms={b_ms:.4f} "
              f"({b_by}), equal to the plain version"))
    combine_edges(device)
    del dsp, soft2, got, want, lib, table

    # 10b on the chunk's samples
    margin = float(cfg.boundary_margin)
    ker = CO.coherent_expert_kernel(cents, pts_ns, True, margin)
    pln = CO.coherent_expert_plain(cents, pts_ns, True, margin)
    torch.cuda.synchronize()
    if not torch.equal(ker, pln):
        raise SystemExit(f"kernel coherent_expert: {int((ker != pln).sum())} "
                         f"ids differ from the plain version")
    R, S = pts_ns.shape[0], pts_ns.shape[1]
    ms = cuda_ms(lambda: CO.coherent_expert_kernel(cents, pts_ns, True,
                                                   margin), 20)
    dev = device_ms(lambda: CO.coherent_expert_kernel(cents, pts_ns, True,
                                                      margin))
    plain_ms = cuda_ms(lambda: CO.coherent_expert_plain(cents, pts_ns, True,
                                                        margin), 3)
    n_bytes, b_ms, b_by = coherent_bound(cents, pts_ns, True, margin)
    skew, skew_ms, skew_b = coherent_skew_chunk(statics, cents, margin,
                                                device)
    text = (f"margin {margin:g} at {R}x{S} samples, K={K}: ids equal "
            f"(coherent share {float((ker >= 0).float().mean()):.4f}) "
            f"kernel_ms={dev:.4f} (the device time; back to back {ms:.4f}) "
            f"plain_ms={plain_ms:.4f} bytes={n_bytes} (each ray's points up "
            f"to its first break; all {nbytes(pts_ns, ker)} give "
            f"{bound(nbytes(pts_ns, ker), R * S * K * 14)[0]:.4f} ms) "
            f"bound_ms={b_ms:.4f} ({b_by}) at {HBM_BYTES_PER_S / 1e12:g} "
            f"TB/s; skew chunk (coherent share {skew:.4f}) device_ms="
            f"{skew_ms:.4f} bound_ms={skew_b:.4f}; plan "
            f"{lane_plan_text(coherent_plan(R, S))}")
    print(f"kernel coherent_expert: {text}", flush=True)
    results[kernels.COHERENT_EXPERT.name] = dict(
        max_abs_err=0.0, ms=dev, plain_ms=plain_ms, bound_ms=b_ms,
        bound_by=b_by, text=text)
    del pts_ns, pts, dirs, ker, pln
    coherent_edges(device)

    # kernel 2 over the union probe grid (a K=1, L=1 stack)
    from nerfsys_tpu_torch.models.occupancy import _ray_validity

    t0 = time.perf_counter()
    grid = MO.build_union_probe_grid(occ, statics, res=UNION_RES,
                                     importance=True)
    torch.cuda.synchronize()
    build_ms = 1e3 * (time.perf_counter() - t0)
    pf = MO.union_probe_fns(grid)
    rays = torch.from_numpy(rays_np).to(device)
    o, d = rays[:, 0:3].contiguous(), rays[:, 3:6].contiguous()
    _, near, far = _ray_validity(rays)
    kw = dict(n_probes=128, importance=pf.importance, ray_floor=0.25)
    ker = O.occupancy_probe_cdf_kernel(pf.occs, pf.binary, pf.aabbs, o, d,
                                       near, far, **kw)
    pln = O.occupancy_probe_cdf(pf.occs, pf.binary, pf.aabbs, o, d, near,
                                far, **kw, use_kernels=False)
    torch.cuda.synchronize()
    flips = int((ker["occ"] != pln["occ"]).sum())
    alive_flips = int((ker["alive"] != pln["alive"]).sum())
    err = max_err(ker["cdf"], pln["cdf"])
    ms = cuda_ms(lambda: O.occupancy_probe_cdf_kernel(
        pf.occs, pf.binary, pf.aabbs, o, d, near, far, **kw), 10)
    dev = device_ms(lambda: O.occupancy_probe_cdf_kernel(
        pf.occs, pf.binary, pf.aabbs, o, d, near, far, **kw))
    io_bytes = nbytes(o, d, near, far, ker["cdf"], ker["alive"], ker["occ"])
    n_bytes = nbytes(pf.occs, pf.binary) + io_bytes
    n_ops = o.shape[0] * 128 * 23 + o.shape[0] * 128 * 12
    b_ms, b_by = bound(n_bytes, n_ops)
    need = probe_sector_bytes(pf.occs, pf.binary, pf.aabbs, o, d, near, far,
                              128, pf.importance, pln["occ"]) + io_bytes
    exact_ms = cuda_ms(lambda: O.occupancy_probe_cdf_kernel(
        occ["occs"], occ["binary"], statics.expert_aabbs, o, d, near, far,
        **kw), 10)
    print(f"kernel occupancy_probe_cdf: union grid res {UNION_RES} (marked "
          f"share {float(grid['binary'].float().mean()):.4f}, built in "
          f"{build_ms:.1f} ms) at {o.shape[0]} rays x 128 probes: "
          f"max_abs_err={err:.3e} tol=1e-5 occ_bit_flips={flips} "
          f"alive_flips={alive_flips} kernel_ms={ms:.4f} (back to back) "
          f"device_ms={dev:.4f} bytes={n_bytes} bound_ms={b_ms:.4f} "
          f"({b_by}); distinct-sector bytes {need} bound_ms "
          f"{bound(need, n_ops)[0]:.4f}; plan "
          f"{probe_plan_text(O.occ_probe_plan(o.shape[0], 128, 1, 1))} vs "
          f"the exact K={K} L={occ['occs'].shape[1]} union {exact_ms:.4f}",
          flush=True)
    if flips or alive_flips or not err <= 1e-5:
        raise SystemExit("kernel occupancy_probe_cdf disagrees on the union "
                         "probe grid")


def render_fast(cfg, statics, params, occ, device):
    """--render_fast at the runner's default widths: bucketed top-1 (cf
    1.5) hash experts, the res-128 union probe grid, soft importance
    occupancy, S=32, 65,536-ray chunks: one warm-up and 3 requests of
    800x800 through `render_image`, the counters zeroed just before them
    and read just after; one chunk against the plain path; one profiled
    frame. Then measure_perf's half-sky frame on the sky grid through the
    hard two-wave renderer with the union grid (its probe is
    `_union_probe_wrap`'s): one warm-up and 2 requests, one alive chunk
    against the plain path."""
    import torch

    from nerfsys_tpu_torch import kernels
    from nerfsys_tpu_torch.data.ram_rays import frame_rays
    from nerfsys_tpu_torch.models import container as CO
    from nerfsys_tpu_torch.pipelines.online.runtime_adapt import (
        TwoWaveOccRenderer,
        make_chunk_renderer,
        render_image,
        render_rays_chunked,
    )

    S, chunk = 32, CHUNK or CHECK_RAYS
    fcfg = fast_cfg(cfg)
    aabb = statics.global_aabb.cpu().numpy()
    kw = dict(ray_samples=S, occ_state=occ, occ_importance=True,
              occ_hard_mask=False, occ_probe_grid_res=UNION_RES,
              device=device)
    renderer = make_chunk_renderer(fcfg, **kw)
    poses = [pose(x) for x in SERVE_POSES]
    render_image(renderer, params, statics, poses[0], scene_aabb=aabb,
                 chunk_rays=chunk)  # warm-up (builds the union grid)
    torch.cuda.synchronize()
    kernels.reset_launches()
    CO.bucket_stats.update(calls=0, dense=0)
    times = []
    for md in poses:
        t0 = time.perf_counter()
        rgb, depth, acc = render_image(renderer, params, statics, md,
                                       scene_aabb=aabb, chunk_rays=chunk)
        times.append(time.perf_counter() - t0)
        check_frame("render_fast", rgb, depth, acc, (SIDE, SIDE, 3))
    launches = kernels.launches()
    dense = dict(CO.bucket_stats)
    print(f"render_fast: launches during 3 requests {launches}", flush=True)
    for k in FAST_KERNELS:
        if launches[k] <= 0:
            raise SystemExit(f"render_fast: kernel {k} never launched")
    plain = make_chunk_renderer(fcfg, use_kernels=False, **kw)
    rays, _ = frame_rays(SIDE, SIDE, poses[0].intrinsics, poses[0].c2w,
                         aabb=aabb)
    c = torch.from_numpy(rays[:chunk]).to(device)
    chunk_matches_plain("render_fast", renderer(params, statics, c),
                        plain(params, statics, c))
    profile_frame(renderer, params, statics, poses[0], aabb, chunk,
                  label="render_fast frame")
    ms = [1e3 * t for t in times]
    print(f"render_fast: {SIDE}x{SIDE} frames ms={[round(x, 2) for x in ms]} "
          f"mean_ms={sum(ms) / 3:.2f} rays_per_s="
          f"{SIDE * SIDE / (sum(times) / 3):.1f} container calls "
          f"{dense['calls']}, dense fallbacks {dense['dense']} (a bucket "
          f"overflowed: the exact dense blend) mean_rgb="
          f"{float(rgb.mean()):.4f} mean_acc={float(acc.mean()):.4f}",
          flush=True)

    # the half-sky frame, hard mask, union grid, two-wave
    socc = synthetic_occ(statics, device, alive_frac=None)
    hkw = dict(kw, occ_state=socc, occ_hard_mask=True)
    ren = make_chunk_renderer(fcfg, **hkw)
    if not isinstance(ren, TwoWaveOccRenderer) or ren.packable:
        raise SystemExit("render_fast sky: expected an unpackable two-wave "
                         "renderer")
    sky = sky_frame(SIDE * SIDE)
    render_rays_chunked(ren, params, statics, sky, chunk)  # warm-up
    torch.cuda.synchronize()
    kernels.reset_launches()
    CO.bucket_stats.update(calls=0, dense=0)
    times, st = [], {}
    for _ in range(2):
        st = {}
        t0 = time.perf_counter()
        out = render_rays_chunked(ren, params, statics, sky, chunk, stats=st)
        times.append(time.perf_counter() - t0)
    sky_launches = kernels.launches()
    check_frame("render_fast sky", out[:, :3], out[:, 3], out[:, 4],
                out[:, :3].shape)
    if st["chunks_skipped"] <= 0 or st["mode"] != "two_wave":
        raise SystemExit(f"render_fast sky: no chunk skipped: {st}")
    for k in ("bucket_dispatch", "occupancy_probe_cdf"):
        if sky_launches[k] <= 0:
            raise SystemExit(f"render_fast sky: kernel {k} never launched")
    hplain = make_chunk_renderer(fcfg, use_kernels=False, **hkw)
    c = torch.from_numpy(sky[:chunk]).to(device)
    chunk_matches_plain(
        "render_fast sky (alive chunk from the union probe's CDF)",
        ren.render_from_cdf(params, statics, c, ren.probe(statics, c)[0]),
        hplain.render_from_cdf(params, statics, c,
                               hplain.probe(statics, c)[0]),
        flip_share=1e-4)
    est = {}
    exact = render_rays_chunked(make_chunk_renderer(
        fcfg, **{k: v for k, v in hkw.items()
                 if k != "occ_probe_grid_res"}), params, statics, sky, chunk,
        stats=est)
    ms = [1e3 * t for t in times]
    print(f"render_fast sky: {sky.shape[0]} rays ms="
          f"{[round(x, 2) for x in ms]} mode={st['mode']} chunks_skipped="
          f"{st['chunks_skipped']} n_alive={st['n_alive']} (exact-union "
          f"probe: {est['n_alive']}) dense fallbacks "
          f"{CO.bucket_stats['dense']} of {CO.bucket_stats['calls']} calls; "
          f"vs the exact-probe two-wave frame max_abs_diff="
          f"{float(abs(out - exact).max()):.3e} (the union grid moves "
          f"sample placement; not a tolerance) launches {sky_launches}",
          flush=True)
    return {k: launches[k] + sky_launches[k] for k in launches}


def skew_frame(n: int):
    """measure_perf's skewed frame (skew=0.9, scripts/measure_perf.py:
    497-527): rays from (0, 0, 2) in random downward directions, the first
    90% along -x from x=2 with (y, z) near (-1, -1), expert 0's region."""
    import numpy as np

    rng = np.random.default_rng(0)
    o = np.tile(np.array([0.0, 0.0, 2.0], np.float32), (n, 1))
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d[:, 2] = -np.abs(d[:, 2]) - 0.5
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    i1 = int(n * SKEW)
    o[:i1, 0] = 2.0
    o[:i1, 1] = -1.0 + rng.normal(scale=0.15, size=i1)
    o[:i1, 2] = -1.0 + rng.normal(scale=0.15, size=i1)
    d[:i1] = np.array([-1.0, 0.0, 0.0], np.float32)
    d[:i1, 1:] = rng.normal(scale=0.02, size=(i1, 2))
    d[:i1] /= np.linalg.norm(d[:i1], axis=1, keepdims=True)
    nf = np.tile(np.array([0.1, 4.5], np.float32), (n, 1))
    return np.concatenate([o, d, nf], 1).astype(np.float32)


def full_occ(device):
    """measure_perf's occupancy for frames without sky: every cell of K=4,
    R=64, L=2 grids occupied, values 0 (scripts/measure_perf.py:416-452)."""
    import torch

    from nerfsys_tpu_torch.ops.occupancy import OccGridConfig, init_occ_state

    occ = init_occ_state(OccGridConfig(resolution=64, levels=2,
                                       warmup_steps=0), 4, device=device)
    occ["binary"] = torch.ones_like(occ["binary"])
    occ["num_updates"] = torch.tensor(1000, dtype=torch.int32, device=device)
    return occ


def coherent_frames(cfg, statics, params, device):
    """The skew-0.9 frame (640,000 rays) through `make_coherent_renderer`,
    occupancy-guided (soft, importance, measure_perf's all-occupied grid),
    without and with the res-128 union grid, via `render_rays_chunked`: one
    warm-up and 3 requests each, the counters zeroed just before them and
    read just after; then the same rays through the bundle's full routed
    program; one frame without the union grid is profiled."""
    import torch

    from nerfsys_tpu_torch import kernels
    from nerfsys_tpu_torch.pipelines.online.runtime_adapt import (
        make_coherent_renderer,
        render_rays_chunked,
    )

    S, chunk = 32, CHUNK or CHECK_RAYS
    occ = full_occ(device)
    rays = skew_frame(SIDE * SIDE)
    total = {}
    for res in (0, UNION_RES):
        ren = make_coherent_renderer(cfg, ray_samples=S, occ_state=occ,
                                     occ_importance=True, occ_hard_mask=False,
                                     occ_probe_grid_res=res, device=device)
        render_rays_chunked(ren, params, statics, rays, chunk)  # warm-up
        torch.cuda.synchronize()
        kernels.reset_launches()
        times, st = [], {}
        for _ in range(3):
            st = {}
            t0 = time.perf_counter()
            got = render_rays_chunked(ren, params, statics, rays, chunk,
                                      stats=st)
            times.append(time.perf_counter() - t0)
        launches = kernels.launches()
        for k in COHERENT_KERNELS:
            if launches[k] <= 0:
                raise SystemExit(f"coherent: kernel {k} never launched")
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        t0 = time.perf_counter()
        want = render_rays_chunked(ren.full, params, statics, rays, chunk)
        full_ms = 1e3 * (time.perf_counter() - t0)
        check_frame("coherent", got[:, :3], got[:, 3], got[:, 4],
                    want[:, :3].shape)
        errs = [float(abs(got[:, c] - want[:, c]).max())
                for c in (slice(0, 3), 3, 4)]
        ms = [1e3 * t for t in times]
        print(f"coherent: union grid res {res} skew {SKEW:g} frame "
              f"{rays.shape[0]} rays ms={[round(x, 2) for x in ms]} "
              f"mean_ms={sum(ms) / 3:.2f} full routed program ms="
              f"{full_ms:.2f} n_coherent={st['n_coherent']} n_boundary="
              f"{st['n_boundary']} rays_padded={st['rays_padded']} chunks="
              f"{st['chunks_total']} vs the full routed program: rgb "
              f"{errs[0]:.3e} depth {errs[1]:.3e} acc {errs[2]:.3e} (tol "
              f"rgb/acc 1e-4, depth 1e-3: one expert's matmuls vs the "
              f"K-batched ones round differently on the card) launches "
              f"{launches}", flush=True)
        if errs[0] > 1e-4 or errs[2] > 1e-4 or errs[1] > 1e-3:
            raise SystemExit("coherent: the dispatch disagrees with the full "
                             "routed program")
        if not st["n_coherent"] >= 0.5 * rays.shape[0]:
            raise SystemExit(f"coherent: only {st['n_coherent']} coherent "
                             f"rays in the skewed frame")
        if res == 0:
            profile_device(f"coherent skew frame (union grid res {res})",
                           lambda: render_rays_chunked(ren, params, statics,
                                                       rays, chunk),
                           watch=(("coherent_expert_kernel",),))
    return total


def k16_setup(device):
    """measure_moe's K=16 shape: bench-width planes experts on a 4x4
    centroid grid in (y, z), boxes +-1.3, 1,572,864 points uniform in the
    global box, unit directions (scripts/measure_perf.py:649-700)."""
    import dataclasses

    import numpy as np
    import torch

    from nerfsys_tpu_torch.models.container import (
        ContainerStatics,
        init_container_params,
    )

    bench_cfg = bench_setup_cfg()
    dense = dataclasses.replace(bench_cfg, num_experts=16)
    cents = np.stack([[0.0, (i % 4) * 2.0 - 3.0, (i // 4) * 2.0 - 3.0]
                      for i in range(16)]).astype(np.float32)
    boxes = np.stack([np.stack([c - 1.3, c + 1.3]) for c in cents])
    glob = np.stack([cents.min(0) - 1.5, cents.max(0) + 1.5])
    statics = ContainerStatics(*(torch.tensor(a, dtype=torch.float32)
                                 for a in (cents, boxes, glob))).to(device)
    params = init_container_params(dense, seed=SEED, device=device)
    rng = np.random.default_rng(0)
    pts = rng.uniform(glob[0], glob[1], (K16_PTS, 3)).astype(np.float32)
    dirs = rng.normal(size=(K16_PTS, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    return (dense, statics, params, torch.from_numpy(pts).to(device),
            torch.from_numpy(dirs).to(device))


K16_QUERY_PTS = 1 << 20  # the union grid build's chunk of points


def k16_query_grids(statics, device):
    """Kernel 11q's grids on the K=16 arm's boxes: L=4 R=128, 5% of the
    cells occupied at random (seed 5; about half the points then read a
    set bit from one of their 16 experts) at value 0.1 (serve_ab.py's
    `query K=16 bits` case)."""
    import torch

    gen = torch.Generator(device=device).manual_seed(5)
    binary = torch.rand((16, 4, 128, 128, 128), generator=gen,
                        device=device) < 0.05
    return torch.where(binary, 0.1, 0.0), binary, statics.expert_aabbs


def k16_moe(device, results):
    """Dense vs bucketed (E=2, cf 1.5) container_apply at K=16 over
    1,572,864 points in 8 sequential chunks: one warm-up and 3 timed calls
    per arm, the counters zeroed just before the bucketed arm's calls and
    read just after; peak memory; the two arms against each other on the
    points whose margin support fits in E=2. Then the gradient of one
    chunk through the bucketed container (dispatch, buckets, the encoder's
    and the blend's VJPs) against the plain path."""
    import dataclasses

    import torch

    from nerfsys_tpu_torch import kernels
    from nerfsys_tpu_torch.models import container as CO
    from nerfsys_tpu_torch.utils.tree import tree_leaves, tree_map

    dense, statics, params, pts, dirs = k16_setup(device)
    buck = dataclasses.replace(dense, bucketed=True, experts_per_point=2,
                               capacity_factor=MOE_CF)
    n = K16_PTS // K16_CHUNKS
    xs, ds = pts.split(n), dirs.split(n)
    check_dispatch_k16(dense, statics, xs[0], ds[0], results)
    query_check(k16_query_grids(statics, device), pts[:K16_QUERY_PTS],
                results, "K=16 chunk (the arm's first 1,048,576 points)")
    torch.cuda.empty_cache()

    def run(cfg):
        with torch.no_grad():
            outs = [CO.container_apply(params, cfg, statics, x, d)
                    for x, d in zip(xs, ds)]
        return (torch.cat([o[0] for o in outs]),
                torch.cat([o[1] for o in outs]))

    arms, launches = {}, {}
    for label, cfg in (("dense", dense), ("bucketed", buck)):
        run(cfg)  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launches()
        CO.bucket_stats.update(calls=0, dense=0)
        t0 = time.perf_counter()
        for _ in range(3):
            out = run(cfg)
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0) / 3
        arms[label] = (out, ms, torch.cuda.max_memory_allocated(),
                       dict(CO.bucket_stats))
        if label == "bucketed":
            launches = kernels.launches()
    for k in K16_KERNELS:
        if launches[k] <= 0:
            raise SystemExit(f"K=16 bucketed: kernel {k} never launched")
    (d_out, d_ms, d_mem, _), (b_out, b_ms, b_mem, b_st) = (arms["dense"],
                                                           arms["bucketed"])
    if b_st["dense"]:
        raise SystemExit(f"K=16 bucketed: {b_st['dense']} of "
                         f"{b_st['calls']} calls took the dense branch")
    ok = torch.cat([(CO.routing_weights(statics, dense, x) > 0).sum(1) <= 2
                    for x in xs])
    errs = [max_err(b_out[i][ok], d_out[i][ok])
            / max(float(d_out[i][ok].abs().max()), 1e-30) for i in (0, 1)]
    C = CO.bucket_capacity(n, 16, 2, MOE_CF)
    print(f"K=16 moe: {K16_PTS} points in {K16_CHUNKS} chunks of {n}: dense "
          f"container_apply ms={d_ms:.2f} peak_bytes={d_mem} | bucketed E=2 "
          f"cf {MOE_CF:g} (buckets 16x{C}, the experts evaluated on 16*{C}="
          f"{16 * C} rows per chunk instead of 16*{n}={16 * n}) ms={b_ms:.2f}"
          f" peak_bytes={b_mem} dense fallbacks {b_st['dense']} of "
          f"{b_st['calls']} calls; speedup {d_ms / b_ms:.3f}x; bucketed vs "
          f"dense on the {int(ok.sum())} of {K16_PTS} points whose margin "
          f"support fits in E=2: rgb err/max {errs[0]:.3e} sigma err/max "
          f"{errs[1]:.3e} (tol 1e-4: the experts' matmuls run on other batch "
          f"shapes) launches {launches}", flush=True)
    if not max(errs) <= 1e-4:
        raise SystemExit("K=16: bucketed and dense disagree where the margin "
                         "support fits in E")

    # the gradient through the bucketed container on one chunk
    grads = []
    kernels.reset_launches()
    for use in (True, False):
        leaves = tree_map(lambda t: t.detach().clone().requires_grad_(True),
                          params)
        rgb, sigma = CO.container_apply(leaves, buck, statics, xs[0], ds[0],
                                        use_kernels=use)
        (rgb.sum() + sigma.sum()).backward()
        grads.append([t.grad for t in tree_leaves(leaves["experts"])])
        if use:
            grad_launches = kernels.launches()
            torch.cuda.synchronize()
    errs = [rel_err(a, b) for a, b in zip(*grads)]
    print(f"K=16 moe: gradient of sum(rgb) + sum(sigma) through the bucketed "
          f"container on {n} points, kernels vs plain: worst leaf err/max "
          f"{max(errs):.3e} (tol 1e-4: fp32 atomics in the encoder's table "
          f"gradient add in another order) launches {grad_launches}",
          flush=True)
    if not max(errs) <= 1e-4 or grad_launches["bucket_combine_bwd"] <= 0:
        raise SystemExit("K=16: the bucketed gradient disagrees with the "
                         "plain path or skipped bucket_combine_bwd")
    return {k: launches[k] + grad_launches[k] for k in launches}


def moe_phase(statics, occ, rays_np, device, results):
    """Phase: bucketed top-E MoE, union-probe grids and coherent dispatch
    (kernel row 10 checks, --render_fast frames and the sky frame, the
    coherent skew frame, the K=16 dense vs bucketed arm) -> launches."""
    import torch

    t0 = time.perf_counter()
    cfg, params = hash_setup(device)
    check_moe_kernels(cfg, statics, occ, rays_np, device, results)
    parts = [render_fast(cfg, statics, params, occ, device),
             coherent_frames(cfg, statics, params, device)]
    del params
    torch.cuda.empty_cache()
    parts.append(k16_moe(device, results))
    print(f"moe: phase took {time.perf_counter() - t0:.1f} s", flush=True)
    return {k: sum(p[k] for p in parts) for k in parts[0]}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    root = Path(__file__).resolve().parent
    if not (root / "nerfsys_tpu_torch").is_dir():
        print("chip_smoke: nerfsys_tpu_torch not found beside this script",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(root))
    from nerfsys_tpu_torch import kernels
    from nerfsys_tpu_torch.data import native
    from nerfsys_tpu_torch.data.ram_rays import frame_rays

    card = card_line()
    print(f"card: {card}", flush=True)

    build_s = kernels.build_all()
    print(f"build: {len(kernels.SOURCES)} libraries in {build_s:.2f} s",
          flush=True)
    t0 = time.perf_counter()
    native.get_lib()
    print(f"build: native host ray kernels ({native.CXX} "
          f"{' '.join(native.CXX_FLAGS)}) in {time.perf_counter() - t0:.2f} "
          f"s: {native.lib_path().name}", flush=True)
    for stem, log in kernels.build_log.items():
        for line in log.splitlines():  # ptxas -v, each entry's kernel first
            if any(w in line for w in ("entry function", "registers",
                                       "spill")):
                print(f"build[{stem}]: {line.strip()}")

    seconds = {}  # phase -> seconds, printed as each ends

    def phase(name, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        seconds[name] = time.perf_counter() - t
        print(f"phase {name}: {seconds[name]:.1f} s", flush=True)
        return out

    device = torch.device("cuda", 0)
    torch.manual_seed(SEED)
    cfg, statics, params, occ = bench_setup(device)
    native_frame_check(statics)
    md = pose((0.0, 0.0, 2.0))
    rays, _ = frame_rays(md.H, md.W, md.intrinsics, md.c2w,
                         aabb=statics.global_aabb.cpu().numpy())
    results = phase("check kernels", check_kernels, cfg, statics, params,
                    occ, rays[:CHECK_RAYS], device)
    batch = train_batch(device)
    phase("check train kernels", check_train_kernels, cfg, statics, params,
          occ, batch, device, results)
    served = phase("serve", serve, cfg, statics, params, occ, device)
    cam = phase("camera", camera, cfg, statics, params, occ, device)
    early = phase("early-stop", early_stop, cfg, statics, params, occ,
                  rays[:CHECK_RAYS], device, results)
    baked_n = phase("baked", baked, cfg, statics, params, device, results)
    light, trained, _ = phase("train", train, cfg, statics, params, occ,
                              batch, device)
    phase("trunc_exp", trunc_exp_check, cfg, statics, params, occ, batch,
          device, results)
    amp_n = phase("amp", amp_phase, cfg, statics, params, occ,
                  rays[:CHECK_RAYS], batch, device, results)
    occ_n = phase("occupancy", occupancy, cfg, statics, params, occ, batch,
                  device)
    maml_n = phase("maml", maml_phase, cfg, statics, params, occ, batch,
                   device, results)
    trainer_n, eval_n, video_n, amp_run_n = phase("trainer", trainer,
                                                  device)
    hash_served, hash_light, hash_trained = phase(
        "hash", hash_phase, statics, occ, rays[:CHECK_RAYS], batch, device,
        results)
    moe = phase("moe", moe_phase, statics, occ, rays[:CHECK_RAYS], device,
                results)
    print("phases (s): " + ", ".join(f"{k} {v:.1f}"
                                     for k, v in seconds.items())
          + f"; in all {sum(seconds.values()):.1f} s after the build",
          flush=True)

    parts = (("serve", served), ("camera", cam), ("early-stop", early),
             ("baked", baked_n), ("train", trained),
             ("occupancy", occ_n), ("maml", maml_n), ("trainer", trainer_n),
             ("eval", eval_n),
             ("video", video_n), ("hash serve", hash_served),
             ("hash train", hash_trained), ("moe", moe), ("amp", amp_n),
             ("amp runner", amp_run_n))
    for k in kernels.KERNELS:  # one line per kernel, with its launches
        n = k.name
        print(f"kernel {n}: launches={sum(p[n] for _, p in parts)} ("
              + ", ".join(f"{label} {p[n]}" for label, p in parts)
              + f"; per bench train step: planes {light[n] / 3:g}, hash "
              f"{hash_light[n] / 3:g}) {results[n].pop('text')}")
    idle = [k.name for k in kernels.KERNELS
            if not sum(p[k.name] for _, p in parts)]
    if idle:
        raise SystemExit(f"kernels never launched in the phases: {idle}")
    line = {"kernels": [
        {"name": k.name, "route": "cuda", "source": k.source,
         "replaces": k.replaces,
         "launches": sum(p[k.name] for _, p in parts),
         "library_ms": None, **results[k.name]}
        for k in kernels.KERNELS]}
    print("library_ms: grid_sample for baked_trilerp, embedding_bag (a "
          "weighted sum of the bucket rows each point's pairs index) for "
          "bucket_combine_fwd, g * y for trunc_exp_bwd; null for the "
          "others: no single PyTorch call "
          "computes the plane encoder or its table gradient with the "
          "interpolation weights, the hash encoder (its corner rows and "
          "weights from the points; embedding_bag would only sum rows "
          "already indexed and weighted) or its table gradient, the union "
          "probe + CDF, or the second-order products of the compositor "
          "and the encoder (autograd's double backward is many calls), "
          "trunc_exp's forward or second derivative (clamp and exp are two "
          "calls, the products and the clip's slope more), the "
          "inverse-CDF sampler (torch.searchsorted gives "
          "only the interval index, and only on rows that never decrease; "
          "the lerps and the sort are more calls), the compositor or its "
          "VJP, "
          "segmented compositing with a carried transmittance, the bucket "
          "dispatch (top-E routing and a stable counting sort; torch.sort "
          "and cumsum are several calls), the blend's transpose (a scatter "
          "whose indices are unique: index_copy_ would need the products "
          "formed first), the coherent-expert test or the occupancy point "
          "query (no single PyTorch call selects the finest level that "
          "holds a point and reads its cell; nor does one give the "
          "sampler's mask: torch.searchsorted gives no mask)")
    print(json.dumps(line))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
