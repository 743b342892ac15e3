"""nerfsys_tpu_torch: the PyTorch + CUDA (NVIDIA Hopper) port of nerfsys_tpu.

The JAX package `nerfsys_tpu` is the reference; this package is a second,
self-contained implementation beside it. It imports `torch` and never `jax`,
and nothing from `nerfsys_tpu`: what it needs from there it keeps as its own
copy. The layout mirrors the reference (`ops/`, `models/`,
`pipelines/online/`, `data/`, `utils/`) so that each counterpart is easy to
find.

Ported so far: the soft-occupancy mixture-of-experts render path
(`pipelines.online.runtime_adapt.make_chunk_renderer` -> `render_image`)
and the first-order meta-training step
(`pipelines.offline.meta_train_step.make_train_step`, fomaml and reptile,
with `make_eval_step`). The TPU-specialised ops on those paths are
hand-written CUDA C++ kernels for `sm_90a` (`csrc/*.cu`, built at first use
by `kernels/`), each with a plain PyTorch version beside it in the same
module:

  - `ops.planes.plane_encode`                (plane/line encoder forward,
                                              and its light and exact
                                              backwards via `PlaneEncode`)
  - `ops.occupancy.occupancy_probe_cdf`      (union occupancy probe + CDF)
  - `ops.occupancy.sample_tvals_from_cdf`    (inverse-CDF sampler)
  - `ops.volrend.volume_render`              (volume compositor forward,
                                              and its VJP via
                                              `VolumeRender`)

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
