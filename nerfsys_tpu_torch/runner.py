"""The port's job entry point: --op train, --op eval and --op video.

Port of nerfsys_tpu/runner.py (`container_config_from_args` :54,
`optim_config_from_args` :119, `meta_config_from_args` :134,
`build_context` :154-271 for the train, eval and video ops,
`occ_config_from_args` :274, `_load_params_from_checkpoint` :289,
`train` :379-497, `evaluate` :500-584, `main` :599-614; the video op
calls `pipelines.video_gen.render_video` from `main`).
Run as:

    python -m nerfsys_tpu_torch.runner --op train --configPath configs/train.json
    python -m nerfsys_tpu_torch.runner --op eval --configPath configs/eval.json
    python -m nerfsys_tpu_torch.runner --op video --configPath configs/eval.json \
        --camera_path turntable --video_frames 60

It builds the context from the merged flags (utils.config): the prepared
scene under <data_path>/out/<data_dirname>, its clustering, the container
with weights from `init_container_params(cfg, seed=P.seed)` on `--device`
(default cuda). For train: the per-expert ray datasets, TaskDatasets and
prefetching episode loaders; then `train` warm-starts from
`--checkpoint_path` / `--prefix` when given, premarks the occupancy grids
from the training cameras (restoring the trained grids on a warm start)
and runs `meta_trainer`. For eval: the validation images (`--cap_images`
of them), the params of `--checkpoint_path` / `--prefix` (the port's
checkpoints or the JAX package's) and, under `--use_occ`, the grids of
`{prefix}.occ`; then `evaluate` runs `runtime_evaluate` once per `--tto`
entry, each from the checkpoint's params, and writes eval_results.json.
For video: the same context as eval (the validation images give the
frame size and intrinsics); `pipelines.video_gen.render_video` renders
the camera path and writes `<run_dir>/video_<path>.mp4`, or a PNG
sequence when no mp4 encoder is available.

Not ported, and refused at context build with the queue item that holds
it: `--op view` (item 8), `--mesh_shape` and `--fim` (item 7), the vanilla
model, the frequency direction encoding and the fourier background
encoding (item 7; the last three through the port's config classes).
`--occ_probe_mask` (the hard mask from the probes' interval bits) runs for
every op, and so does a checkpoint whose stored config sets it. So do the
precision options, with every `--algo` (second-order MAML included):
`--use_amp` (bfloat16 MLPs) and `--plane_lines_mm` (line lookups as the
reference's hat-stencil matmuls: in float32 kernel 1's function, with
`--plane_lines_mm_dtype bfloat16` kernels 1b and 5b, and 5''b under
`--algo maml`).
"""
from __future__ import annotations

import dataclasses
import json
import time
from pathlib import Path
from typing import List, Optional

import numpy as np
import torch

from nerfsys_tpu_torch.data.dataset import (
    cap_metadata,
    get_dataset,
    get_image_metadata,
    load_clustering_meta,
    load_coordinates,
    load_scene_boxes,
)
from nerfsys_tpu_torch.data.loaders import MetaBatcher, PrefetchLoader
from nerfsys_tpu_torch.data.task_dataset import TaskDataset
from nerfsys_tpu_torch.models.container import (
    ContainerConfig,
    ContainerStatics,
    init_container_params,
    param_group_labels,
)
from nerfsys_tpu_torch.models.ngp import NGPConfig
from nerfsys_tpu_torch.ops.encodings import HashGridConfig
from nerfsys_tpu_torch.ops.occupancy import OccGridConfig
from nerfsys_tpu_torch.ops.planes import PlaneEncodingConfig
from nerfsys_tpu_torch.pipelines.offline.meta_core import MetaConfig
from nerfsys_tpu_torch.pipelines.offline.meta_train_step import (
    make_eval_step,
    make_train_step,
)
from nerfsys_tpu_torch.pipelines.offline.trainer import meta_trainer
from nerfsys_tpu_torch.pipelines.online.runtime_adapt import runtime_evaluate
from nerfsys_tpu_torch.pipelines.video_gen import render_video
from nerfsys_tpu_torch.utils import checkpoint as ckpt
from nerfsys_tpu_torch.utils.config import namespace_to_dict, parse_args
from nerfsys_tpu_torch.utils.device import resolve_device
from nerfsys_tpu_torch.utils.logging import Logger
from nerfsys_tpu_torch.utils.optim import OptimConfig, build_optimizer

UNPORTED_OPS = {
    "view": "ROADMAP Queue 1 item 8 (the viewer)",
}


# --------------------------- model construction ------------------------------
def container_config_from_args(P) -> ContainerConfig:
    """The flat flag namespace onto the static model config; the port's
    config classes refuse what is not ported (the vanilla model, the
    frequency direction and fourier background encodings)."""
    expert = NGPConfig(
        hidden=P.dim_hidden,
        sigma_depth=P.sigma_depth,
        color_hidden=P.color_hidden,
        color_depth=P.color_depth,
        dir_encoding=P.dir_encoding,
        use_bf16=bool(getattr(P, "use_amp", False)),
        xyz_encoding="planes" if P.xyz_encoding == "planes" else "hash",
        hash=HashGridConfig(
            levels=getattr(P, "high_levels", 16),
            features_per_level=getattr(P, "high_features_per_level", 2),
            log2_hashmap_size=P.log2_hashmap_size,
            max_res=P.max_res,
            min_res=getattr(P, "high_min_res", 16),
            interpolation=getattr(P, "interpolation", "Linear"),
            packed=bool(getattr(P, "packed_gather", False)),
            tcnn_layout=bool(getattr(P, "hash_tcnn_layout", False)),
        ),
        planes=PlaneEncodingConfig(
            levels=P.plane_levels,
            base_res=P.plane_base_res,
            growth=P.plane_growth,
            features=P.plane_features,
            include_lines=not P.plane_no_lines,
            # positions never depend on trainable params on any runner
            # path, so the light backward is always valid here
            pos_grad=bool(getattr(P, "plane_pos_grad", False)),
            # line lookups as hat-stencil matmuls (an execution strategy in
            # float32; bfloat16 operands with the bfloat16 dtype)
            lines_matmul=bool(getattr(P, "plane_lines_mm", False)),
            lines_mm_dtype=getattr(P, "plane_lines_mm_dtype", "float32"),
        ),
    )
    return ContainerConfig(
        num_experts=P.num_submodules,
        nerf_variant=P.nerf_variant,
        bucketed=bool(getattr(P, "bucketed_moe", False)),
        experts_per_point=getattr(P, "experts_per_point", 2),
        capacity_factor=getattr(P, "capacity_factor", 1.5),
        boundary_margin=float(P.boundary_margin_effective),
        cluster_2d=bool(P.cluster_2d),
        use_bg_nerf=not P.no_bg_nerf,
        bg_hidden=P.bg_hidden,
        bg_encoding="spherical" if P.bg_encoding == "spherical" else "fourier",
        expert=expert,
    )


def optim_config_from_args(P) -> OptimConfig:
    return OptimConfig(
        optimizer=P.optimizer,
        lr=P.lr,
        encoding_lr=P.encoding_lr,
        sigma_lr=P.sigma_lr,
        color_lr=P.color_lr,
        bg_lr=P.bg_lr,
        use_scheduler=not P.no_scheduler,
        decay_factor=P.decay_factor,
        outer_steps=P.outer_steps,
        weight_decay=getattr(P, "weight_decay", 0.0),
    )


def meta_config_from_args(P) -> MetaConfig:
    """The reference's MetaConfig keys; its TPU scheduling knobs
    (--expert_unroll, --task_unroll) have no counterpart."""
    return MetaConfig(
        algo=P.algo,
        inner_iter=P.inner_iter,
        inner_lr=P.inner_lr,
        reptile_lr=P.lr,
        ray_samples=P.ray_samples,
        color_space=P.color_space,
        bg_policy=P.bg_color_default,
        occ_importance=getattr(P, "occ_importance", False),
        occ_probe_mask=getattr(P, "occ_probe_mask", False),
        occ_hard_mask=not getattr(P, "occ_no_hard_mask", False),
        occ_ray_floor=float(getattr(P, "occ_ray_floor", 0.25)),
        occ_probes=int(getattr(P, "occ_probes", 128)),
    )


def occ_config_from_args(P) -> OccGridConfig:
    """OccGridConfig from the flags."""
    return OccGridConfig(
        resolution=getattr(P, "occ_resolution", 128),
        levels=getattr(P, "occ_levels", 4),
        occ_thre=getattr(P, "occ_thre", 1e-2),
        ema_decay=getattr(P, "occ_ema_decay", 0.95),
        warmup_steps=getattr(P, "occ_warmup", 256),
        update_interval=getattr(P, "occ_update_interval", 16),
        dilate=getattr(P, "occ_dilate", 0),
    )


def refuse_unported(P, op: str) -> None:
    """NotImplementedError for an op or a flag whose code is not ported,
    naming where it waits."""
    if op in UNPORTED_OPS:
        raise NotImplementedError(
            f"--op {op} is not ported: {UNPORTED_OPS[op]}")
    if op not in ("train", "eval", "video"):
        raise ValueError(f"Unknown op: {op}")
    flags = (
        ("mesh_shape", getattr(P, "mesh_shape", None),
         "multi-GPU training and rendering (ROADMAP Queue 1 item 7)"),
        ("fim", getattr(P, "fim", False),
         "the FIM model (ROADMAP Queue 1 item 7)"),
    )
    for name, selected, where in flags:
        if selected:
            raise NotImplementedError(f"--{name} is not ported: {where}")


# --------------------------- context ------------------------------------------
def build_context(P, op: str) -> dict:
    """Resolve data paths, scene geometry, model and the op's data on
    P.device: the train op's episode loaders, or the eval and video ops'
    validation metadata and checkpoint."""
    refuse_unported(P, op)
    device = resolve_device(getattr(P, "device", "cuda"))
    np.random.seed(P.seed)

    ctx: dict = {"P": P, "op": op, "device": device}

    if getattr(P, "checkpoint_path", None):
        P.checkpoint_path = str(
            ckpt.resolve_checkpoint_dir(P.checkpoint_path, logs_root="logs"))
        print("Using checkpoint path:", P.checkpoint_path)

    data_path = Path(P.data_path) / "out" / P.data_dirname
    mask_dir = data_path / "masks" / P.mask_dirname
    clustering = load_clustering_meta(mask_dir)
    coordinate_info = load_coordinates(data_path)
    global_aabb, expert_aabbs = load_scene_boxes(mask_dir)

    scale = float(coordinate_info["pose_scale_factor"])
    P.near = P.near / scale if P.near is not None else None
    P.far = P.far / scale if P.far is not None else None

    # routing margin: min(max(1, P.bm), the clustering's margin)
    P.boundary_margin_effective = min(
        max(1.0, float(P.bm)), float(clustering["boundary_margin"]))
    P.cluster_2d = bool(clustering["cluster_2d"])

    cfg = container_config_from_args(P)
    statics = ContainerStatics(
        centroids=torch.tensor(np.asarray(clustering["centroids"]),
                               dtype=torch.float32, device=device),
        expert_aabbs=torch.tensor(expert_aabbs, dtype=torch.float32,
                                  device=device),
        global_aabb=torch.tensor(global_aabb, dtype=torch.float32,
                                 device=device))
    params = init_container_params(cfg, seed=P.seed, device=device)

    ctx.update(cfg=cfg, statics=statics, params=params,
               coordinate_info=coordinate_info, clustering=clustering,
               data_path=data_path, mask_dir=mask_dir,
               global_aabb=global_aabb, expert_aabbs=expert_aabbs)

    # default run name: the reference's hparam string; explicit fnames
    # are kept verbatim
    if P.fname:
        fname = P.fname
    else:
        if getattr(P, "data_type", "ray") != "ray":
            raise NotImplementedError(
                "Only ray-based data_type is implemented.")
        fname = (
            f"{P.data_type}/{P.dataset}/"
            f"cells-{P.num_submodules:02}/"
            + ("fim/" if getattr(P, "fim", False) else "mod/")
            + f"algo-{P.algo}/"
            f"{P.nerf_variant}_dir-{P.dir_encoding}_depth-{P.num_layers}"
            f"_hid-{P.dim_hidden}_ch-{P.color_hidden}/"
            + ("no_bg/" if P.no_bg_nerf else f"bg_{P.bg_hidden}/")
            + f"initer-{P.inner_iter:02}_samples-{P.ray_samples}/"
            f"lr-{int(P.inner_lr * 1e3):03d}-{int(P.lr * 1e6):04d}"
            f"_seed-{P.seed}"
        )
    logger = Logger(fn=fname, logs_path="logs", resume=op != "train",
                    today=bool(getattr(P, "log_date", False)))
    ctx["logger"] = logger
    ctx["run_dir"] = logger.logdir

    if op in ("eval", "video"):
        _, val_md = get_image_metadata(data_path, P.downscale)
        if P.cap_images:
            val_md = cap_metadata(val_md, P.cap_images)
        ctx["test_metadata"] = val_md
        _load_params_from_checkpoint(ctx)
        return ctx

    bundle = get_dataset(
        data_path, P.downscale, P.mask_dirname, P.num_submodules,
        cap_images=P.cap_images, near_far_override=(P.near, P.far),
        num_workers=P.num_workers)
    ctx["bundle"] = bundle
    check_expert_sets(bundle, P.num_submodules)
    # the reference runner's TaskDataset settings: region bounds inferred
    # from near points, exact DDA routing, image_cap 0.4,
    # min_rays = (S + Q) * 0.5
    task_kwargs = dict(region_aabb=None, support_rays=P.support_rays,
                       query_rays=P.query_rays, cell_dim=P.cell_dim,
                       routing_policy=P.routing_policy)
    task_sets = [TaskDataset(ds, seed=P.seed + i, **task_kwargs)
                 for i, ds in enumerate(bundle.train_sets)]
    print("Task cells per expert:",
          [len(td.eligible_cells) for td in task_sets])
    val_task_sets = [TaskDataset(ds, seed=P.seed + 1000 + i, **task_kwargs)
                     for i, ds in enumerate(bundle.val_sets)
                     ] if bundle.val_sets else None
    ctx["train_loader"] = PrefetchLoader(
        MetaBatcher(task_sets, P.batch_size), device=device)
    ctx["eval_loader"] = (PrefetchLoader(
        MetaBatcher(val_task_sets, P.test_batch_size), device=device)
        if val_task_sets else None)
    return ctx


def _load_params_from_checkpoint(ctx) -> None:
    """ctx's params (and ckpt_state) from --checkpoint_path / --prefix;
    under --use_occ also the grids of {prefix}.occ as ctx['occ_state']."""
    P = ctx["P"]
    if not getattr(P, "checkpoint_path", None):
        return
    params, state = ckpt.load_model_checkpoint(P.checkpoint_path, P.prefix,
                                               ctx["params"])
    ctx["params"] = params
    ctx["ckpt_state"] = state
    print(f"Loaded checkpoint {P.prefix} @ step {state['step']}")
    if getattr(P, "use_occ", False):
        from nerfsys_tpu_torch.ops.occupancy import init_occ_state

        tpl = init_occ_state(occ_config_from_args(P), P.num_submodules,
                             device=ctx["device"])
        occ = ckpt.load_aux_state(P.checkpoint_path, "occ", tpl,
                                  tag=P.prefix)
        if occ is not None:
            ctx["occ_state"] = occ
            print("Restored occupancy grids from checkpoint")


def check_expert_sets(bundle, num_experts: int) -> None:
    """ValueError naming each expert whose ray set `get_dataset` dropped
    (no rays): the episode batch's expert axis must line up with the
    params' (the reference fails later, in the step, on a shape error)."""
    for split, cells in (("train", bundle.train_cells),
                         ("val", bundle.val_cells)):
        if split == "val" and not cells:
            continue  # no eval loader
        missing = sorted(set(range(num_experts)) - set(cells))
        if missing:
            raise ValueError(
                f"expert(s) {missing} have no {split} rays in the prepared "
                f"scene: the batch would hold {len(cells)} experts for "
                f"{num_experts} experts' params")


# --------------------------- ops ----------------------------------------------
def build_occupancy(ctx, warm_tag: Optional[str] = None):
    """-> (occ_state, occ_update_fn), or (None, None) without --use_occ:
    fresh grids premarked from the training cameras, replaced by the
    checkpoint's trained grids on a warm start."""
    P = ctx["P"]
    if not getattr(P, "use_occ", False):
        return None, None
    from nerfsys_tpu_torch.models.occupancy import (
        make_occ_update_fn,
        premark_invisible_expert_cells,
    )
    from nerfsys_tpu_torch.ops.occupancy import init_occ_state

    device = ctx["device"]
    occ_cfg = occ_config_from_args(P)
    occ_state = init_occ_state(occ_cfg, P.num_submodules, device=device)
    train_md = getattr(ctx.get("bundle"), "train_metadata", None)
    if train_md:
        def stack(rows):
            return torch.tensor(np.stack(rows), dtype=torch.float32,
                                device=device)

        occ_state = premark_invisible_expert_cells(
            occ_state, ctx["statics"], occ_cfg,
            stack([m.c2w for m in train_md]),
            stack([m.intrinsics[:4] for m in train_md]),
            stack([np.array([m.W, m.H], np.float32) for m in train_md]),
            near=P.near or 0.0)
        print(f"[occ] premarked invisible cells from {len(train_md)} cams")
    if warm_tag is not None:
        occ_r = ckpt.load_aux_state(P.checkpoint_path, "occ", occ_state,
                                    tag=warm_tag)
        if occ_r is not None:
            occ_state = occ_r  # trained grids beat the fresh premark
            print("[warm-start] occupancy grids restored")
    return occ_state, make_occ_update_fn(ctx["cfg"], occ_cfg)


def train(ctx):
    P = ctx["P"]
    meta = meta_config_from_args(P)
    opt_cfg = optim_config_from_args(P)

    # warm start from --checkpoint_path / --prefix into a fresh run dir:
    # params here, the optimizer state after its init, the grids in
    # build_occupancy, step and best into the outer loop (ARCH_KEYS are
    # already pinned from the checkpoint's config by parse_args)
    start_step, best = 0, float("-inf")
    warm_tag = None
    if getattr(P, "checkpoint_path", None):
        warm_tag = (P.prefix
                    if ckpt.checkpoint_exists(P.checkpoint_path, P.prefix)
                    else ckpt.latest_step_tag(P.checkpoint_path))
        if warm_tag is None:
            print(f"[warm-start] no checkpoint under {P.checkpoint_path}; "
                  "training from scratch")
        else:
            params_r, _, w_state = ckpt.load_checkpoint(
                P.checkpoint_path, warm_tag, ctx["params"])
            ctx["params"] = params_r
            start_step = int(w_state.get("step", 0))
            best = float(w_state.get("best", float("-inf")))
            print(f"[warm-start] restored '{warm_tag}' @ step {start_step} "
                  f"(best {best:.3f}) from {P.checkpoint_path}")

    tx = build_optimizer(opt_cfg, param_group_labels(ctx["params"]))
    opt_state = tx.init(ctx["params"])
    if warm_tag is not None:
        _, opt_r, _ = ckpt.load_checkpoint(P.checkpoint_path, warm_tag,
                                           ctx["params"], opt_state)
        if opt_r is not None:
            opt_state = opt_r
            print("[warm-start] optimizer state restored")
    step_fn = make_train_step(meta, ctx["cfg"], tx)
    eval_fn = make_eval_step(meta, ctx["cfg"], tto=P.inner_iter)
    occ_state, occ_update_fn = build_occupancy(ctx, warm_tag)

    try:
        params, opt_state, best = meta_trainer(
            params=ctx["params"],
            opt_state=opt_state,
            train_step=step_fn,
            eval_step=eval_fn,
            statics=ctx["statics"],
            train_loader=ctx["train_loader"],
            eval_loader=ctx["eval_loader"],
            config=namespace_to_dict(P),
            outer_steps=P.outer_steps,
            eval_every=P.eval_step,
            save_every=P.save_step,
            print_every=P.print_step,
            run_dir=ctx["run_dir"],
            logger=ctx["logger"],
            seed=P.seed,
            start_step=start_step,
            best=best,
            trace_steps=getattr(P, "trace_steps", 0),
            occ_state=occ_state,
            occ_update_fn=occ_update_fn,
            fixed_eval=bool(getattr(P, "fixed_eval", False)),
            eval_batches=int(getattr(P, "max_test_tasks", 1)),
        )
    finally:
        for name in ("train_loader", "eval_loader"):
            if ctx.get(name) is not None:
                ctx[name].close()
    ctx["params"] = params
    return params


def evaluate(ctx):
    """One `runtime_evaluate` per --tto entry, each from the checkpoint's
    params with a fresh optimizer (no lr schedule) -> the result rows,
    also written to <run_dir>/eval_results.json."""
    P = ctx["P"]
    base_params = ctx["params"]
    tto_list = [int(t) for t in str(P.tto).split(",") if t != ""]
    opt_cfg = optim_config_from_args(P)
    rows = []
    for tto in tto_list:
        tx = build_optimizer(dataclasses.replace(opt_cfg, use_scheduler=False),
                             param_group_labels(base_params))
        result = runtime_evaluate(
            params=base_params,  # reset to the meta-learned base each time
            cfg=ctx["cfg"],
            statics=ctx["statics"],
            occ_state=ctx.get("occ_state"),
            occ_importance=getattr(P, "occ_importance", False),
            occ_probe_mask=getattr(P, "occ_probe_mask", False),
            occ_hard_mask=not getattr(P, "occ_no_hard_mask", False),
            occ_probe_grid_res=int(getattr(P, "occ_union_probe_res", 0)),
            render_early_stop=float(getattr(P, "render_early_stop", 0.0)),
            render_baked_res=int(getattr(P, "render_baked", 0)),
            render_baked_sh=int(getattr(P, "render_baked_sh", 3)),
            render_baked_occ=bool(getattr(P, "render_baked_occ", False)),
            render_baked_occ_dilate=int(
                getattr(P, "render_baked_occ_dilate", 2)),
            render_baked_sparse=int(getattr(P, "render_baked_sparse", 0)),
            render_baked_cache=str(
                getattr(P, "render_baked_cache", "") or ""),
            render_coherent=bool(getattr(P, "render_coherent", False)),
            optimizer=tx,
            test_metadata=ctx["test_metadata"],
            tto_steps=tto,
            support_batch=P.support_rays,
            ray_samples=P.ray_samples,
            color_space=P.color_space,
            bg_policy=P.bg_color_default,
            near=P.near,
            far=P.far,
            global_aabb=ctx["global_aabb"],
            out_dir=Path(ctx["run_dir"]) / "rendered",
            logger=ctx["logger"],
            seed=P.seed,
        )
        rows.append({"tto": tto, **{k: v for k, v in result.items()
                                    if k != "params"}})

    # the results table (the reference prints pandas and LaTeX)
    try:
        import pandas as pd

        df = pd.DataFrame(rows).set_index("tto")
        print(df.to_string())
        print(df.to_latex(float_format="%.3f"))
    except ImportError:
        print(json.dumps(rows, indent=2))
    out_path = Path(ctx["run_dir"]) / "eval_results.json"
    out_path.write_text(json.dumps(rows, indent=2))
    return rows


def main(argv: Optional[List[str]] = None):
    P = parse_args(argv)
    op = P.op
    ctx = build_context(P, op)
    t0 = time.time()
    if op == "eval":
        ctx["rows"] = evaluate(ctx)
    elif op == "video":
        ctx["video_path"] = render_video(ctx)
    else:
        train(ctx)
    print(f"[done] op={op} in {time.time() - t0:.1f}s")
    return ctx


if __name__ == "__main__":
    main()
