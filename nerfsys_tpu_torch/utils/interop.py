"""Carry weights and state from the JAX package into the port.

Takes plain host data, never JAX objects: nested dicts and lists of numpy
arrays (the caller runs `jax.tree_util.tree_map(np.asarray, tree)` first),
and any object exposing the attributes of the reference's config
dataclasses. The container params keep the reference layout: 'experts'
holds the K experts stacked on a leading axis, with per-level plane and
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
from nerfsys_tpu_torch.utils.device import resolve_device


def tree_to_torch(tree: Any, device="cuda") -> Any:
    """Nested dicts/lists/tuples of arrays -> the same nesting of tensors
    (copied) on `device`."""
    dev = resolve_device(device)
    if isinstance(tree, dict):
        return {k: tree_to_torch(v, dev) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_to_torch(v, dev) for v in tree)
    return torch.tensor(np.asarray(tree), device=dev)


def tree_to_numpy(tree: Any) -> Any:
    """The inverse: tensors -> numpy arrays, nesting kept."""
    if isinstance(tree, dict):
        return {k: tree_to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_to_numpy(v) for v in tree)
    return tree.detach().cpu().numpy()


def container_params_from_jax(params: Dict, device="cuda") -> Dict:
    """JAX container params (as numpy) -> the port's params dict. Raises
    unless 'experts' holds the K experts stacked on one leading axis."""
    dev = resolve_device(device)
    experts = params.get("experts") if isinstance(params, dict) else None
    leads = {np.shape(a)[0] if np.ndim(a) else None
             for a in _leaves(experts)}
    if experts is None or len(leads) != 1 or None in leads:
        raise ValueError("container params need 'experts' with the K "
                         "experts stacked on a leading axis of every leaf")
    return tree_to_torch(params, dev)


def _leaves(tree: Any):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    elif tree is not None:
        yield tree


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
    ContainerConfig (its TPU execution knobs have no counterpart)."""
    planes = PlaneEncodingConfig(**_fields(cfg.expert.planes,
                                           PlaneEncodingConfig))
    ek = _fields(cfg.expert, NGPConfig)
    ek["planes"] = planes
    ck = _fields(cfg, ContainerConfig)
    ck["expert"] = NGPConfig(**ek)
    return ContainerConfig(**ck)
