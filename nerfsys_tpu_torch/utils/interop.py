"""Carry weights and state from the JAX package into the port.

Takes plain host data, never JAX objects: nested dicts and lists of numpy
arrays (the caller runs `jax.tree_util.tree_map(np.asarray, tree)` first),
and any object exposing the attributes of the reference's config
dataclasses. Optimizer state arrives as optax's state tree with its arrays
converted the same way (its NamedTuples survive `tree_map`). The
container params keep the reference layout: 'experts' holds the K experts
stacked on a leading axis, with the (K, L * 2^T, F) 'hash_table' or the
per-level plane and line lists (nerfsys_tpu/models/ngp.py:105-136,
nerfsys_tpu/models/container.py:128-154); 'bg' holds the background MLP.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

import numpy as np
import torch

from nerfsys_tpu_torch.models.container import ContainerConfig, ContainerStatics
from nerfsys_tpu_torch.models.ngp import NGPConfig
from nerfsys_tpu_torch.ops.encodings import HashGridConfig
from nerfsys_tpu_torch.ops.occupancy import OccGridConfig
from nerfsys_tpu_torch.ops.planes import PlaneEncodingConfig
from nerfsys_tpu_torch.pipelines.offline.meta_core import MetaConfig
from nerfsys_tpu_torch.utils.device import resolve_device
from nerfsys_tpu_torch.utils.optim import OptimConfig
from nerfsys_tpu_torch.utils.tree import tree_leaves, tree_map


def tree_to_torch(tree: Any, device="cuda") -> Any:
    """Nested dicts/lists/tuples of arrays -> the same nesting of tensors
    (copied) on `device`."""
    dev = resolve_device(device)
    return tree_map(lambda a: torch.tensor(np.asarray(a), device=dev), tree)


def tree_to_numpy(tree: Any) -> Any:
    """The inverse: tensors -> numpy arrays, nesting kept."""
    return tree_map(lambda t: t.detach().cpu().numpy(), tree)


def container_params_from_jax(params: Dict, device="cuda") -> Dict:
    """JAX container params (as numpy) -> the port's params dict. Raises
    unless 'experts' holds the K experts stacked on one leading axis."""
    dev = resolve_device(device)
    experts = params.get("experts") if isinstance(params, dict) else None
    leads = {np.shape(a)[0] if np.ndim(a) else None
             for a in tree_leaves(experts)}
    if experts is None or len(leads) != 1 or None in leads:
        raise ValueError("container params need 'experts' with the K "
                         "experts stacked on a leading axis of every leaf")
    return tree_to_torch(params, dev)


def statics_from_jax(statics: Any, device="cuda") -> ContainerStatics:
    """Anything with centroids / expert_aabbs / global_aabb (as arrays)."""
    dev = resolve_device(device)

    def t(a):
        return torch.tensor(np.asarray(a), dtype=torch.float32, device=dev)

    return ContainerStatics(t(statics.centroids), t(statics.expert_aabbs),
                            t(statics.global_aabb))


def occ_state_from_jax(occ_state: Dict, device="cuda") -> Dict:
    """{occs (K,L,R,R,R) f32, binary bool, num_updates[, ready_after]}."""
    dev = resolve_device(device)
    out = {
        "occs": torch.tensor(np.asarray(occ_state["occs"], np.float32),
                             device=dev),
        "binary": torch.tensor(np.asarray(occ_state["binary"], bool),
                               device=dev),
    }
    for key in ("num_updates", "ready_after"):
        if key in occ_state:
            out[key] = torch.tensor(np.asarray(occ_state[key], np.int32),
                                    device=dev)
    return out


def _fields(obj: Any, cls) -> Dict:
    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(cls)
            if hasattr(obj, f.name)}


# Reference config keys dropped on purpose: TPU execution strategies that the
# reference documents as computing the same function (nerfsys_tpu/models/
# container.py:79-88 expert_map: lax.map vs vmap over the expert axis;
# nerfsys_tpu/ops/planes.py:56-115: the matmul backward and its chunking,
# zero-padded gather rows, the scatter backward, packed corner rows, the
# line matmuls' chunking); and the occupancy grid's alpha-threshold anneal
# and cone_angle (nerfsys_tpu/ops/occupancy.py:42-66): no renderer, update
# or trainer of the reference reads them (only `anneal_alpha_thre` :111,
# which nothing calls). `bwd_dtype` is the precision of the plane
# backward's one-hot contraction: the reference forces it to float32 on
# every backend but the TPU (nerfsys_tpu/ops/planes.py:461-465,576-578), and
# the port computes that float32 math for either value. The line matmuls
# themselves (`lines_matmul`, `lines_mm_dtype`) and the bfloat16 MLPs
# (`use_bf16`) are carried. Every other key the port lacks must hold the
# reference's default, or the import raises: it would change the math.
DROPPED_KEYS = {
    "ContainerConfig": ("expert_map",),
    "NGPConfig": (),
    "PlaneEncodingConfig": ("matmul_bwd", "bwd_chunk", "bwd_dtype",
                            "pad_plane_rows", "pad_line_rows",
                            "bwd_scatter_min_res", "packed_corners",
                            "lines_mm_chunk"),
    "HashGridConfig": (),
    "OccGridConfig": ("alpha_thre", "alpha_thre_start", "alpha_thre_end",
                      "cosine_anneal", "cone_angle"),
}


def _ported_fields(obj: Any, cls, path: str) -> Dict:
    """_fields, raising ValueError for a key of the reference config `obj`
    that the port's `cls` lacks, that is not in DROPPED_KEYS, and whose
    value differs from the reference class's own default."""
    have = {f.name for f in dataclasses.fields(cls)}
    dropped = DROPPED_KEYS[cls.__name__]
    if dataclasses.is_dataclass(obj):
        for f in dataclasses.fields(obj):
            if f.name in have or f.name in dropped:
                continue
            if f.default is not dataclasses.MISSING:
                default = f.default
            elif f.default_factory is not dataclasses.MISSING:
                default = f.default_factory()
            else:
                default = dataclasses.MISSING
            value = getattr(obj, f.name)
            if value != default:
                raise ValueError(
                    f"{path}.{f.name}={value!r}: the port has no counterpart "
                    f"(the reference's default is {default!r}); importing "
                    f"it would change what the model computes")
    return _fields(obj, cls)


def container_config_from_jax(cfg: Any) -> ContainerConfig:
    """The port's ContainerConfig with the keys of a reference
    ContainerConfig: the position encoder, the plane config with pos_grad,
    the whole hash config (packed, tcnn_layout and interpolation included),
    bucketed routing with experts_per_point, capacity_factor and
    bucket_overflow_dense. Raises ValueError, naming the key, for a key
    the port lacks whose value is not the reference's default, except
    the execution knobs of DROPPED_KEYS (expert_map and bwd_dtype among
    them), which are dropped on purpose. The precision options
    (expert.use_bf16, expert.planes.lines_matmul and lines_mm_dtype) are
    carried; bfloat16 line matmuls with matmul_bwd=False raise ValueError:
    that backward is autodiff of the bfloat16 dot, whose rounding no CPU
    run of the reference shows (nerfsys_tpu/ops/planes.py:237-240)."""
    ek = _ported_fields(cfg.expert, NGPConfig, "expert")
    ek["planes"] = PlaneEncodingConfig(**_ported_fields(
        cfg.expert.planes, PlaneEncodingConfig, "expert.planes"))
    if ek["planes"].lines_bf16 and not getattr(cfg.expert.planes,
                                               "matmul_bwd", True):
        raise ValueError(
            "expert.planes.matmul_bwd=False with bfloat16 line matmuls: the "
            "port has no counterpart (that backward is autodiff of the "
            "bfloat16 dot)")
    ek["hash"] = HashGridConfig(**_ported_fields(
        cfg.expert.hash, HashGridConfig, "expert.hash"))
    ck = _ported_fields(cfg, ContainerConfig, "cfg")
    ck["expert"] = NGPConfig(**ek)
    return ContainerConfig(**ck)


def occ_grid_config_from_jax(cfg: Any) -> OccGridConfig:
    """The port's OccGridConfig from a reference OccGridConfig: the grid's
    shape, warmup and the update's EMA, threshold, subset fraction and
    dilation; the unread keys of DROPPED_KEYS are dropped."""
    return OccGridConfig(**_ported_fields(cfg, OccGridConfig, "occ"))


def meta_config_from_jax(meta: Any) -> MetaConfig:
    """The port's MetaConfig with the semantic keys of a reference
    MetaConfig (expert_map, expert_unroll, task_unroll are TPU scheduling
    knobs with no counterpart)."""
    return MetaConfig(**_fields(meta, MetaConfig))


def optim_config_from_jax(cfg: Any) -> OptimConfig:
    return OptimConfig(**_fields(cfg, OptimConfig))


def _masked(x: Any) -> bool:
    """optax's MaskedNode (an empty NamedTuple) marks a leaf of another
    group in a multi_transform moment tree."""
    return isinstance(x, tuple) and len(x) == 0


def _find(tree: Any, *attrs: str):
    """Depth-first: the first node with every field in `attrs` (a field,
    not a method: every tuple has a `count` method)."""
    if all(not callable(getattr(tree, a, callable)) for a in attrs):
        return tree
    children = (tree.values() if isinstance(tree, dict)
                else tree if isinstance(tree, (list, tuple)) else ())
    for child in children:
        hit = _find(child, *attrs)
        if hit is not None:
            return hit
    return None


def _merge(trees, dev):
    """Per leaf, the one group tree that holds it (others hold MaskedNode)."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _merge([t[k] for t in trees], dev) for k in first}
    if isinstance(first, list) or (isinstance(first, tuple)
                                   and not _masked(first)):
        return type(first)(_merge([t[i] for t in trees], dev)
                           for i in range(len(first)))
    held = [t for t in trees if not _masked(t)]
    if len(held) != 1:
        raise ValueError("optimizer state: a leaf is held by "
                         f"{len(held)} groups, expected 1")
    return torch.tensor(np.asarray(held[0]), device=dev)


def opt_state_from_jax(opt_state: Any, device="cuda") -> Dict:
    """optax's `clip_by_global_norm -> multi_transform({group: chain(l2,
    adam | adamw | sgd)})` state (as numpy) -> the port's optimizer state
    (utils.optim), so that a JAX run resumes in the port: per group the
    count, and the moments merged back into the params' nesting."""
    dev = resolve_device(device)
    groups = _find(opt_state, "inner_states")
    if groups is None:
        raise ValueError("optimizer state: no multi_transform state found")
    counts, first, second, trace = {}, [], [], []
    for name, st in groups.inner_states.items():
        adam = _find(st, "count", "mu", "nu")
        tr = _find(st, "trace")
        if adam is not None:
            counts[name] = adam.count
            first.append(adam.mu)
            second.append(adam.nu)
        elif tr is not None:
            counts[name] = _find(st, "count").count
            trace.append(tr.trace)
        else:
            raise ValueError(f"optimizer state: group {name!r} holds "
                             f"neither adam moments nor an sgd trace")
    state = {"count": {g: torch.tensor(np.asarray(c, np.int32), device=dev)
                       for g, c in counts.items()}}
    if trace:
        state["trace"] = _merge(trace, dev)
    else:
        state["mu"], state["nu"] = _merge(first, dev), _merge(second, dev)
    return state
