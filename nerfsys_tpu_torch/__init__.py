"""nerfsys_tpu_torch: the PyTorch + CUDA (NVIDIA Hopper) port of nerfsys_tpu.

The JAX package `nerfsys_tpu` is the reference; this package is a second,
self-contained implementation beside it. It imports `torch` and never `jax`,
and nothing from `nerfsys_tpu`: what it needs from there it keeps as its own
copy. The layout mirrors the reference (`ops/`, `models/`,
`pipelines/online/`, `data/`, `utils/`) so that each counterpart is easy to
find.

Ported so far: the occupancy-guided mixture-of-experts render path over
hash-grid (the reference's default) or plane/line experts
(`pipelines.online.runtime_adapt.make_chunk_renderer` -> `render_image`:
the soft one-shot renderer, the hard-mask two-wave renderer and the
early-stop renderer),
baked snapshot serving (`models.baked.bake_field` ->
`make_baked_camera_renderer` / `make_baked_chunk_renderer`) and the
meta-training step
(`pipelines.offline.meta_train_step.make_train_step`: second-order maml,
fomaml and reptile, with `make_eval_step`). The TPU-specialised ops on those paths are
hand-written CUDA C++ kernels for `sm_90a` (`csrc/*.cu`, built at first use
by `kernels/`), each with a plain PyTorch version beside it in the same
module:

  - `ops.planes.plane_encode`                (plane/line encoder forward,
                                              its light and exact
                                              backwards via `PlaneEncode`
                                              and their second-order
                                              products via
                                              `PlaneEncodeBwd`)
  - `ops.occupancy.occupancy_probe_cdf`      (union occupancy probe + CDF)
  - `ops.occupancy.sample_tvals_from_cdf`    (inverse-CDF sampler)
  - `ops.volrend.volume_render`              (volume compositor forward,
                                              its VJP via `VolumeRender`
                                              and the VJP's own VJP via
                                              `VolumeRenderBwd`)
  - `models.baked.baked_trilerp`             (packed-corner trilinear
                                              lookup in the baked grid)
  - `ops.volrend.composite_segment`          (segmented compositing with a
                                              carried transmittance)
  - `ops.encodings.hash_encode`              (multiresolution hash-grid
                                              encoder, fp32 and packed
                                              bf16 pairs, and its table
                                              gradient via `HashEncode`,
                                              differentiable again through
                                              the fp32 forward,
                                              `HashEncodeBwd`)

A kernel wrapper uses the plain version only for a tensor on the CPU; given
a CUDA tensor it launches its kernel or raises. Entry points default to
`device="cuda"` and raise when no CUDA device exists unless the caller asks
for `device="cpu"`.

Precision is float32 throughout, matching the JAX package on CPU. TF32 is
kept OFF for matmuls and cuDNN: importing this package sets
`torch.backends.cuda.matmul.allow_tf32 = False` and
`torch.backends.cudnn.allow_tf32 = False`.
"""
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
