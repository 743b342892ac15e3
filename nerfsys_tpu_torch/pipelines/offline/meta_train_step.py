"""One outer meta-training step over a batched episode, and the eval step.

Port of nerfsys_tpu/pipelines/offline/meta_train_step.py (`_per_task_slice`
:47, `_finalize_metrics` :133, `make_train_step` :148, `make_eval_step`
:282) for fomaml and reptile. The batch is

    {'support_rays': (K, B, S, 8), 'support_rgbs': (K, B, S, 3),
     'query_rays':   (K, B, Q, 8), 'query_rgbs':   (K, B, Q, 3),
     'valid':        (K, B)}       -- padding mask of the tasks

and a step takes `(params, opt_state, statics, batch, generator,
occ_state)`. Tasks run task-major: for each of the B tasks, the K experts
adapt and answer their query one after the other, the task's loss
K * sum(qloss * v) / total_n (the reference's fed-avg scale) is
backpropagated at once, and its gradient adds to the previous tasks' (the
reference's scan with gradient accumulation). A step whose meta loss is not
finite keeps params AND optimizer state. All random draws come from the one
`generator`, on its device (a CUDA generator for the card).

The occupancy grid's readiness (`occ_ready`) is read once per step on the
host, where the reference branches with lax.cond.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from nerfsys_tpu_torch.models.container import ContainerConfig
from nerfsys_tpu_torch.models.occupancy import occ_ready
from nerfsys_tpu_torch.ops.losses import psnr_from_mse
from nerfsys_tpu_torch.pipelines.offline.meta_core import (
    MetaConfig,
    query_loss,
    task_adapt,
)
from nerfsys_tpu_torch.utils.optim import Optimizer, apply_updates, global_norm
from nerfsys_tpu_torch.utils.tree import tree_map

Params = Dict


def _occ_on(occ_state) -> Optional[bool]:
    return None if occ_state is None else bool(occ_ready(occ_state))


def _expert_grid(occ_state, statics, k: int):
    """Expert k's grid as the K=1 slices kernel 2 probes."""
    if occ_state is None:
        return None
    return (occ_state["occs"][k:k + 1], occ_state["binary"][k:k + 1],
            statics.expert_aabbs[k:k + 1])


def _per_task_slice(meta: MetaConfig, cfg: ContainerConfig, experts: Params,
                    statics, bg_params, slice_b: Dict[str, torch.Tensor],
                    generator, tto: Optional[int] = None, occ_state=None,
                    occ_on: Optional[bool] = None, use_kernels: bool = True):
    """Adapt + query for one task of every region, expert by expert ->
    (fast params list of K, qloss (K,), qpsnr (K,), inner_last (K,))."""
    K = slice_b["valid"].shape[0]
    fasts, ql, qp, il = [], [], [], []
    for k in range(K):
        p_k = tree_map(lambda t, k=k: t[k], experts)
        aabb = statics.expert_aabbs[k]
        grid = _expert_grid(occ_state, statics, k)
        fast, inner = task_adapt(
            meta, cfg, p_k, aabb, bg_params, slice_b["support_rays"][k],
            slice_b["support_rgbs"][k], generator, iterations=tto,
            occ_grid=grid, occ_on=occ_on, use_kernels=use_kernels)
        qloss, qpsnr = query_loss(
            meta, cfg, fast, aabb, bg_params, slice_b["query_rays"][k],
            slice_b["query_rgbs"][k], generator, occ_grid=grid,
            occ_on=occ_on, use_kernels=use_kernels)
        fasts.append(fast)
        ql.append(qloss)
        qp.append(qpsnr)
        il.append(inner[-1])
    return fasts, torch.stack(ql), torch.stack(qp), torch.stack(il)


def _masked(x: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return torch.where(v > 0, x, torch.zeros((), dtype=x.dtype,
                                             device=x.device))


def _finalize_metrics(region_q_sum, region_in_sum, region_n, total_n):
    region_out = region_q_sum / torch.clamp(region_n, min=1e-8)
    region_in = region_in_sum / torch.clamp(region_n, min=1e-8)
    loss_out = region_q_sum.sum() / total_n
    loss_in = region_in_sum.sum() / total_n
    return {"loss_in": loss_in, "loss_out": loss_out,
            "region_loss_in": region_in, "region_loss_out": region_out,
            "psnr_out": psnr_from_mse(loss_out),
            "region_psnr_out": psnr_from_mse(region_out)}


def _episode(batch):
    """(K, B, valid float (K, B), total_n)."""
    K, B = batch["valid"].shape
    valid = batch["valid"].to(torch.float32)
    return K, B, valid, torch.clamp(valid.sum(), min=1e-8)


def _task(batch, b: int) -> Dict[str, torch.Tensor]:
    return {k: v[:, b] for k, v in batch.items()}


def task_value_and_grad(meta: MetaConfig, cfg: ContainerConfig,
                        leaves: Params, statics, slice_b, generator,
                        total_n, occ_state=None, occ_on=None,
                        use_kernels: bool = True):
    """One task of every region: its meta-loss contribution
    K * sum(qloss * v) / total_n, backpropagated into the `.grad` of the
    params tree `leaves` (which require grad) -> (contribution, (qloss * v,
    inner_last * v, v))."""
    v = slice_b["valid"].to(torch.float32)
    K = v.shape[0]
    _, qloss, _, inner_last = _per_task_slice(
        meta, cfg, leaves["experts"], statics, leaves.get("bg"), slice_b,
        generator, occ_state=occ_state, occ_on=occ_on,
        use_kernels=use_kernels)
    qloss = _masked(qloss, v)
    contrib = K * (qloss * v).sum() / total_n
    contrib.backward()
    inner_last = _masked(inner_last, v)
    return contrib.detach(), ((qloss * v).detach(), inner_last * v, v)


def make_train_step(meta: MetaConfig, cfg: ContainerConfig,
                    optimizer: Optimizer, *, use_kernels: bool = True):
    """The outer step: (params, opt_state, statics, batch, generator,
    occ_state=None) -> (params, opt_state, metrics). use_kernels=False runs
    the plain versions of every kernel (the card's own reference)."""
    if meta.algo == "maml":
        raise NotImplementedError(
            "algo='maml' (second order) needs a double backward through the "
            "encoder and compositor kernels, which is not ported")

    def fomaml_step(params, opt_state, statics, batch, generator,
                    occ_state=None):
        K, B, valid, total_n = _episode(batch)
        occ_on = _occ_on(occ_state)
        leaves = tree_map(lambda t: t.detach().requires_grad_(True), params)
        m_acc = [torch.zeros(K, device=valid.device) for _ in range(3)]
        loss_meta = torch.zeros((), device=valid.device)
        for b in range(B):
            contrib, aux = task_value_and_grad(
                meta, cfg, leaves, statics, _task(batch, b), generator,
                total_n, occ_state, occ_on, use_kernels)
            m_acc = [a + x for a, x in zip(m_acc, aux)]
            loss_meta = loss_meta + contrib
        grads = tree_map(lambda t: torch.zeros_like(t) if t.grad is None
                         else t.grad, leaves)
        metrics = _finalize_metrics(*m_acc, total_n)
        base = tree_map(lambda t: t.detach(), params)
        finite = bool(torch.isfinite(loss_meta))
        if finite:
            updates, new_state = optimizer.update(grads, opt_state, base)
            new_params = apply_updates(base, updates)
        else:  # keep params and optimizer state; report zero gradients
            grads = tree_map(torch.zeros_like, grads)
            new_params, new_state = base, opt_state
        metrics["loss_out_meta"] = loss_meta
        metrics["grad_norm"] = global_norm(grads)
        metrics["skipped_nonfinite"] = torch.tensor(
            0.0 if finite else 1.0, device=valid.device)
        return new_params, new_state, metrics

    def reptile_step(params, opt_state, statics, batch, generator,
                     occ_state=None):
        K, B, valid, total_n = _episode(batch)
        occ_on = _occ_on(occ_state)
        experts = tree_map(lambda t: t.detach(), params["experts"])
        d_acc = tree_map(torch.zeros_like, experts)
        m_acc = [torch.zeros(K, device=valid.device) for _ in range(3)]
        for b in range(B):
            slice_b = _task(batch, b)
            with torch.no_grad():
                fasts, qloss, _, inner_last = _per_task_slice(
                    meta, cfg, experts, statics, params.get("bg"), slice_b,
                    generator, occ_state=occ_state, occ_on=occ_on,
                    use_kernels=use_kernels)
            v = slice_b["valid"].to(torch.float32)
            fast = tree_map(lambda *fs: torch.stack(fs), *fasts)

            def add_delta(acc, f, theta):
                w = v.reshape(-1, *((1,) * (f.dim() - 1)))
                return acc + _masked(f - theta, w) * w

            d_acc = tree_map(add_delta, d_acc, fast, experts)
            m_acc = [a + x for a, x in zip(
                m_acc, (_masked(qloss, v) * v, _masked(inner_last, v) * v,
                        v))]
        region_n = torch.clamp(m_acc[2], min=1.0)

        def apply(theta, dsum):
            n = region_n.reshape(-1, *((1,) * (dsum.dim() - 1)))
            return theta + meta.reptile_lr * dsum / n

        new_params = dict(params)
        new_params["experts"] = tree_map(apply, experts, d_acc)
        metrics = _finalize_metrics(*m_acc, total_n)
        metrics["loss_out_meta"] = metrics["loss_out"]
        metrics["grad_norm"] = torch.zeros((), device=valid.device)
        metrics["skipped_nonfinite"] = torch.zeros((), device=valid.device)
        return new_params, opt_state, metrics

    return reptile_step if meta.algo == "reptile" else fomaml_step


def make_eval_step(meta: MetaConfig, cfg: ContainerConfig, tto: int):
    """Episodic eval: adapt `tto` inner steps on the support set, score the
    query set -> (params, statics, batch, generator, occ_state=None) ->
    metrics."""

    def eval_step(params, statics, batch, generator, occ_state=None):
        K, B, valid, total_n = _episode(batch)
        occ_on = _occ_on(occ_state)
        experts = tree_map(lambda t: t.detach(), params["experts"])
        bg = None if params.get("bg") is None else tree_map(
            lambda t: t.detach(), params["bg"])
        m_acc = [torch.zeros(K, device=valid.device) for _ in range(3)]
        for b in range(B):
            slice_b = _task(batch, b)
            with torch.no_grad():
                _, qloss, _, inner_last = _per_task_slice(
                    meta, cfg, experts, statics, bg, slice_b, generator,
                    tto=tto, occ_state=occ_state, occ_on=occ_on)
            v = slice_b["valid"].to(torch.float32)
            m_acc = [a + x for a, x in zip(
                m_acc, (_masked(qloss, v) * v, _masked(inner_last, v) * v,
                        v))]
        return _finalize_metrics(*m_acc, total_n)

    return eval_step
