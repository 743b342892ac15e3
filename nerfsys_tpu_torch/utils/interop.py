"""Carry weights and state from the JAX package into the port.

Takes plain host data, never JAX objects: nested dicts and lists of numpy
arrays (the caller runs `jax.tree_util.tree_map(np.asarray, tree)` first),
and any object exposing the attributes of the reference's config
dataclasses. Optimizer state arrives as optax's state tree with its arrays
converted the same way (its NamedTuples survive `tree_map`). The
container params keep the reference layout: 'experts' holds the K experts stacked on a leading axis, with per-level plane and
line lists (nerfsys_tpu/models/ngp.py:105-136,
nerfsys_tpu/models/container.py:128-154); 'bg' holds the background MLP.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

import numpy as np
import torch

from nerfsys_tpu_torch.models.container import ContainerConfig, ContainerStatics
from nerfsys_tpu_torch.models.ngp import NGPConfig
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


def container_config_from_jax(cfg: Any) -> ContainerConfig:
    """The port's ContainerConfig with the architecture keys of a reference
    ContainerConfig, pos_grad included (its TPU execution knobs have no
    counterpart)."""
    planes = PlaneEncodingConfig(**_fields(cfg.expert.planes,
                                           PlaneEncodingConfig))
    ek = _fields(cfg.expert, NGPConfig)
    ek["planes"] = planes
    ck = _fields(cfg, ContainerConfig)
    ck["expert"] = NGPConfig(**ek)
    return ContainerConfig(**ck)


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
