"""The config/flag system of the port's runner.

The port's own copy of nerfsys_tpu/utils/config.py: `ARCH_KEYS`,
`OCC_MODE_KEYS`, `build_parser` (the same flags, names and defaults),
`_cli_provided_dests`, `load_checkpoint_cfg`, `find_checkpoint_cfg`,
`_enforce_arch_from_ckpt`, `parse_args` and `namespace_to_dict`, with the
same merge order:

    defaults < checkpoint config < JSON --configPath < explicit CLI flags,
    EXCEPT the architecture keys (ARCH_KEYS), which are ALWAYS taken from
    the checkpoint, so restored weights always match the model;

the `--render_fast` preset is expanded after the merges. One flag is the
port's own: `--device` (default `cuda`), where the runner builds and
trains; the tests pass `cpu`. The reference's TPU execution knobs
(`--expert_unroll`, `--task_unroll`, `--plane_pad_rows`,
`--line_pad_rows`, `--plane_scatter_bwd`, `--chunk_points`) and its
`explicit_keys`, which only `chunk_points` read, have no counterpart: the
parser does not take them, and a JSON or checkpoint config that sets them
loads with those keys skipped. `--plane_lines_mm` and
`--plane_lines_mm_dtype` are taken and carried into the plane config (the
reference reads the dtype only under `--plane_lines_mm`: its bfloat16
line matmuls); `--use_amp` sets the experts' bfloat16 MLPs. Both run
with every `--algo`, second-order MAML included.

Checkpoint configs are JSON ({tag}.config.json, utils.checkpoint); the
loader also accepts the original implementation's pickled-argparse `.P`
files.
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path
from typing import List, Optional, Sequence

ARCH_KEYS = {
    # model topology
    "num_submodules",
    "nerf_variant",
    "num_layers",
    "sigma_depth",
    "color_depth",
    "dim_hidden",
    "color_hidden",
    # encodings / background
    "max_res",
    "log2_hashmap_size",
    "hash_tcnn_layout",
    "xyz_encoding",
    "dir_encoding",
    "no_bg_nerf",
    "bg_hidden",
    "bg_encoding",
    # factorized plane encoding topology
    "plane_levels",
    "plane_base_res",
    "plane_growth",
    "plane_features",
    "plane_no_lines",
    # occupancy grid topology: runner builds the .occ restore template from
    # these (runner.occ_config_from_args) — a mismatch silently drops the
    # trained grids, so they must always be pinned from the checkpoint
    "use_occ",
    "occ_resolution",
    "occ_levels",
}

# Occupancy RENDER-MODE keys: how a checkpoint was trained is how it should
# be rendered (a soft-trained model hard-masked at eval deletes density it
# legitimately holds — ~0.6 dB, BASELINE.md). Unlike ARCH_KEYS these are
# overridable: an explicit CLI flag or JSON entry wins; otherwise the
# checkpoint config decides.
OCC_MODE_KEYS = {
    "occ_no_hard_mask",
    "occ_importance",
    "occ_probe_mask",
    "occ_ray_floor",
}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Adaptive NeRF Framework (PyTorch + CUDA port)")
    p.add_argument("--op", type=str, default="train",
                   choices=["train", "eval", "view", "video"])

    # --- system
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--rank", type=int, default=0)
    p.add_argument("--use_amp", action="store_true",
                   help="bfloat16 compute in the render/MLP path")
    p.add_argument("--log_method", type=str, default="step",
                   choices=["step", "patch"])
    p.add_argument("--trace_steps", type=int, default=0,
                   help="capture a torch.profiler device trace of this many "
                        "training steps (written to the run dir)")
    p.add_argument("--device", type=str, default="cuda",
                   help="device the runner builds and trains on (cuda, "
                        "cuda:N or cpu)")

    # --- io / logging cadence
    p.add_argument("--eval_step", type=int, default=200)
    p.add_argument("--save_step", type=int, default=1000)
    p.add_argument("--print_step", type=int, default=1)

    # --- data
    p.add_argument("--dataset", type=str, default="drz",
                   choices=["ffhq", "celeba", "imagenette", "voxceleb", "drz"])
    p.add_argument("--data_type", type=str, default="ray",
                   choices=["img", "video", "ray"])
    p.add_argument("--data_path", type=str, default="data/drz/")
    p.add_argument("--data_dirname", type=str, default="balanced")
    p.add_argument("--mask_dirname", type=str, default="g22_grid_bm110_ss11")
    p.add_argument("--cap_images", type=int, default=None)
    p.add_argument("--downscale", type=float, default=0.25)
    p.add_argument("--near", type=float, default=None)
    p.add_argument("--far", type=float, default=None)
    p.add_argument("--bm", type=float, default=1.05,
                   help="routing boundary margin (soft MoE when > 1)")

    # --- episode generation
    p.add_argument("--support_rays", type=int, default=4000)
    p.add_argument("--query_rays", type=int, default=2000)
    p.add_argument("--cell_dim", type=int, default=5)

    # --- batching
    p.add_argument("--batch_size", type=int, default=3,
                   help="tasks per region per outer step")
    p.add_argument("--test_batch_size", type=int, default=1)

    # --- model
    p.add_argument("--num_submodules", type=int, default=4)
    p.add_argument("--nerf_variant", type=str, default="instant",
                   choices=["instant", "vanilla"])
    p.add_argument("--occ_probe_mask", action="store_true",
                   help="mask sigma by the sample's probe-interval bit "
                        "instead of re-querying the binary grid per sample "
                        "(saves one grid gather/sample/inner-iter; "
                        "interval-resolution masking is more conservative)")
    p.add_argument("--occ_no_hard_mask", action="store_true",
                   help="occupancy only steers sample placement (pure "
                        "importance sampling); never hard-zero sigma")
    p.add_argument("--occ_ray_floor", type=float, default=0.25,
                   help="soft mode only: fraction of the sampling pdf "
                        "spread uniformly over the WHOLE ray so unmarked "
                        "space stays sampled and trainable")
    p.add_argument("--occ_probes", type=int, default=128,
                   help="probes per ray for the occupancy CDF pass")
    p.add_argument("--occ_union_probe_res", type=int, default=0,
                   help="render-time probing from ONE resampled union grid "
                        "at this resolution instead of every expert's every "
                        "level (K x L fewer probe gathers; placement-only "
                        "approximation). 0 = exact per-expert probing")
    p.add_argument("--render_coherent", action="store_true",
                   help="eval: render Phase-B frames via coherent-expert "
                        "dispatch — rays provably inside ONE expert's "
                        "routing region render through single-expert "
                        "programs (1/K field evals, expert id traced), "
                        "boundary rays keep the full routed blend. EXACT; "
                        "fastest live mode on spatially-clustered frames. "
                        "Composes with --use_occ (union-CDF placement); "
                        "unsharded, no --render_early_stop")
    p.add_argument("--render_baked", type=int, default=0,
                   help="eval: render a baked SH-radiance snapshot of the "
                        "(adapted) field at this grid resolution instead of "
                        "the live field — 4 gather rows per sample vs "
                        "K x 18 per point (models/baked.py; serving-rate "
                        "mode, geometry resolution-limited). 0 = live field")
    p.add_argument("--render_baked_sh", type=int, default=3,
                   help="SH levels (degree + 1) for --render_baked")
    p.add_argument("--render_baked_occ", action="store_true",
                   help="with --render_baked on an occupancy checkpoint: "
                        "bake only cells alive under any expert's binary "
                        "grid (dead cells get zero rows without evaluating "
                        "the field — cuts bake cost by the dead fraction). "
                        "Hard-mask zeroing semantics: soft-trained "
                        "checkpoints lose the pdf-floor radiance in "
                        "unmarked space; A/B before trusting")
    p.add_argument("--render_baked_occ_dilate", type=int, default=2,
                   help="conservative 3^3 max-pool passes over the alive "
                        "mask in BAKE-grid space before skipping "
                        "(--render_baked_occ)")
    p.add_argument("--render_baked_cache", default="",
                   help="path to a .npz baked-snapshot cache: the bake is "
                        "loaded from here when the BakedConfig AND a "
                        "params fingerprint match, else re-baked and "
                        "saved — bake minutes once, serve seconds on "
                        "every later eval/video run of the same "
                        "checkpoint/adaptation")
    p.add_argument("--render_baked_sparse", type=int, default=0,
                   help="block-compact the baked table with this block edge "
                        "(cells): all-zero blocks collapse onto one shared "
                        "zero block behind an int32 indirection grid — "
                        "bit-exact at any alive fraction, table memory "
                        "scales with the alive fraction (pairs with "
                        "--render_baked_occ, which zeroes dead cells). "
                        "0 = dense table; 8 is a good default")
    p.add_argument("--render_early_stop", type=float, default=0.0,
                   help="early ray termination for renders: stop paying for "
                        "samples once transmittance < eps (reference parity: "
                        "nerfacc sampling defaults early_stop_eps=1e-4, "
                        "meta_ngp.py:430-443). Outputs approximate within "
                        "2*eps/channel (dropped tail radiance <= eps plus "
                        "shifted background weight <= eps). 0 = off. Occ "
                        "renders only; ignored for bucketed routing and "
                        "sharded meshes")
    p.add_argument("--render_fast", action="store_true",
                   help="preset for the measured fastest render config "
                        "(eval/video/view): top-1 bucketed expert routing + "
                        "union-probe grid (honest numbers: top1+union occ-32 "
                        "800² 9.77 s vs 11.4 s exact-probe two-wave; on SOFT "
                        "checkpoints the win is the union probe alone — "
                        "bucketed top-1 takes the exact overflow->dense "
                        "fallback on full frames; BASELINE.md serve ladder). "
                        "Changes blend semantics at expert boundaries (top-1 "
                        "instead of margin-soft); explicit flags still win")
    p.add_argument("--routing_policy", type=str, default="dda",
                   choices=["dda", "alpha", "sampled"],
                   help="TaskDataset micro-cell routing: exact DDA traversal "
                        "(reference runner default), alpha-point + neighbor "
                        "overlap, or cheap sampled majority vote")
    p.add_argument("--num_layers", type=int, default=2,
                   help="SIREN-variant stack depth + run-name tag (reference "
                        "args.py:59; only consumed by models/siren.py and "
                        "the default fname, like the reference)")
    p.add_argument("--sigma_depth", type=int, default=2)
    p.add_argument("--color_depth", type=int, default=2)
    p.add_argument("--dim_hidden", type=int, default=64)
    p.add_argument("--color_hidden", type=int, default=64)

    # --- hash encoding
    p.add_argument("--max_res", type=int, default=4096)
    p.add_argument("--log2_hashmap_size", type=int, default=20)
    p.add_argument("--hash_tcnn_layout", action="store_true",
                   help="tiny-cuda-nn grid layout (tcnn resolutions + dense "
                        "coarse levels) — set automatically by "
                        "convert_reference_checkpoint for tcnn-trained "
                        "checkpoints; ARCH key, pinned from the checkpoint")
    p.add_argument("--use_occ", action="store_true")
    # occupancy grid (reference occ conf, nerf_runner.py:125-149)
    p.add_argument("--occ_resolution", type=int, default=128)
    p.add_argument("--occ_levels", type=int, default=4)
    p.add_argument("--occ_thre", type=float, default=1e-2)
    p.add_argument("--occ_ema_decay", type=float, default=0.95)
    p.add_argument("--occ_warmup", type=int, default=256)
    p.add_argument("--occ_update_interval", type=int, default=16)
    p.add_argument("--occ_dilate", type=int, default=0,
                   help="box-dilation passes of the binary occupancy "
                        "field (conservative margin against probe "
                        "aliasing / thin-geometry pruning)")
    # bucketed (top-E block-sparse) MoE dispatch for large expert counts:
    # O(E*N) field evals instead of O(K*N); exact vs the dense blend when
    # the margin support fits in E experts (models/container.py)
    p.add_argument("--bucketed_moe", action="store_true")
    p.add_argument("--fixed_eval", action="store_true",
                   help="evaluate on one pinned episode set + key every "
                        "eval (removes episode-draw variance from the "
                        "eval curve)")
    p.add_argument("--experts_per_point", type=int, default=2)
    p.add_argument("--capacity_factor", type=float, default=1.5)
    p.add_argument("--occ_importance", action="store_true",
                   help="density-proportional importance sampling inside "
                        "occupied space (pdf from the occ grid's EMA values; "
                        "free - no extra MLP evals)")
    p.add_argument("--xyz_encoding", type=str, default="hash",
                   choices=["frequency", "hash", "planes"])
    p.add_argument("--packed_gather", action="store_true",
                   help="hash tables read as packed bf16 pairs (one gather "
                        "per corner; tcnn-fp16-equivalent precision)")
    # --- factorized plane/line encoding (xyz_encoding=planes, TPU-fast)
    p.add_argument("--plane_levels", type=int, default=3)
    p.add_argument("--plane_base_res", type=int, default=128)
    p.add_argument("--plane_growth", type=float, default=2.0)
    p.add_argument("--plane_features", type=int, default=8)
    p.add_argument("--plane_no_lines", action="store_true")
    p.add_argument("--plane_lines_mm", action="store_true",
                   help="line lookups as hat-stencil matmuls (in float32 "
                        "the gathers' function; bfloat16 operands with "
                        "--plane_lines_mm_dtype bfloat16)")
    p.add_argument("--plane_lines_mm_dtype", default="float32",
                   choices=["float32", "bfloat16"])
    p.add_argument("--plane_pos_grad", action="store_true",
                   help="compute exact position gradients through the plane "
                        "encoder (slower backward; only needed if sample "
                        "positions ever depend on differentiated values)")
    p.add_argument("--dir_encoding", type=str, default="spherical",
                   choices=["frequency", "spherical"])

    # --- background model
    p.add_argument("--no_bg_nerf", action="store_true")
    p.add_argument("--bg_color_default", type=str, default="random",
                   choices=["white", "black", "none", "last_sample", "random"])
    p.add_argument("--bg_hidden", type=int, default=32)
    p.add_argument("--bg_encoding", type=str, default="spherical",
                   choices=["frequency", "spherical"])

    # --- rendering
    p.add_argument("--ray_samples", type=int, default=96)
    p.add_argument("--color_space", type=str, default="linear",
                   choices=["srgb", "linear", "identity"])

    # --- FIM
    p.add_argument("--fim", action="store_true")
    p.add_argument("--fim_per_sample", action="store_true")
    p.add_argument("--fim_lambda", type=float, default=0.1)
    p.add_argument("--fim_beta", type=float, default=0.95)
    p.add_argument("--fim_epsilon", type=float, default=1e-6)

    # --- optimizer / scheduler
    p.add_argument("--optimizer", type=str, default="adam",
                   choices=["adamw", "sgd", "adam"])
    p.add_argument("--encoding_lr", type=float, default=1e-2)
    p.add_argument("--sigma_lr", type=float, default=2e-3)
    p.add_argument("--color_lr", type=float, default=2e-3)
    p.add_argument("--bg_lr", type=float, default=1e-3)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--no_scheduler", action="store_true")
    p.add_argument("--decay_factor", type=float, default=10)
    # reference get_optimizer reads getattr(P, "weight_decay", 0.0)
    # (common/utils.py:20,54-70); surfaced as a real flag here
    p.add_argument("--weight_decay", type=float, default=0.0)

    # --- meta training
    p.add_argument("--algo", type=str, default="fomaml",
                   choices=["maml", "fomaml", "reptile"])
    p.add_argument("--inner_iter", type=int, default=8)
    p.add_argument("--inner_lr", type=float, default=15e-3)
    p.add_argument("--outer_steps", type=int, default=20_000)
    p.add_argument("--max_test_tasks", type=int, default=4,
                   help="episode batches per in-training eval point "
                        "(reference eval_step caps its loop at this many "
                        "loader batches, meta_eval_step.py:31,94-96)")

    # --- eval
    p.add_argument("--tto", type=str, default="16",
                   help="comma-separated list of TTO iteration counts")

    # --- video & viewer
    p.add_argument("--suppress_fog", action="store_true",
                   help="deprecated no-op: fog suppression is the video "
                        "default, as in the reference (video_gen.py:506-514)")
    p.add_argument("--no_suppress_fog", action="store_true",
                   help="disable the default blanking of low-opacity / hazy "
                        "video pixels (reference video_gen.py:329-363)")
    # frame count / fps / intrinsics fallback: the reference video op renders
    # 210 frames at 30 fps with the first test image's intrinsics
    # (nerf_runner.py:417-425); width/height apply only without test data
    p.add_argument("--video_frames", type=int, default=210)
    p.add_argument("--video_fps", type=int, default=30)
    p.add_argument("--video_width", type=int, default=800)
    p.add_argument("--video_height", type=int, default=600)
    p.add_argument("--camera_path", type=str, default="full_coverage",
                   choices=["spiral_in", "turntable", "east_west",
                            "north_south", "full_coverage"])
    p.add_argument("--viewer_timeout", type=int, default=900)
    p.add_argument("--viewer_host", type=str, default="0.0.0.0",
                   help="bind address for the Viser server "
                        "(reference nerf_runner.py:442)")
    p.add_argument("--viewer_port", type=int, default=7070)
    p.add_argument("--viewer_public_host", type=str, default="127.0.0.1",
                   help="hostname printed in the viewer access URL (the "
                        "bind address is --viewer_host)")

    # --- extras
    p.add_argument("--configPath", type=str, default=None)
    p.add_argument("--num_workers", type=int, default=None)
    p.add_argument("--log_date", action="store_true")
    p.add_argument("--fname", default=None)
    p.add_argument("--checkpoint_path", type=str, default=None)
    p.add_argument("--prefix", type=str, default="best")
    p.add_argument("--no_strict", action="store_true")
    p.add_argument("--use_stored_args", action="store_true")

    # --- parallelism (TPU-native additions)
    p.add_argument("--mesh_shape", type=str, default=None,
                   help="device mesh, e.g. '4' (data) or '2x2' (data x expert)")
    return p


def _cli_provided_dests(parser: argparse.ArgumentParser, argv: Sequence[str]):
    """Dest names explicitly present on the CLI (args.py:190-207)."""
    opt_to_action = {}
    for action in parser._actions:
        for opt in action.option_strings:
            opt_to_action[opt] = action
    provided = set()
    for tok in argv:
        key = tok.split("=", 1)[0]
        act = opt_to_action.get(key)
        if act is not None:
            provided.add(act.dest)
    return provided


def load_checkpoint_cfg(cfg_path) -> dict:
    """Read a stored run config: our JSON, or a reference pickled `.P`."""
    cfg_path = Path(cfg_path)
    if cfg_path.suffix == ".json" or cfg_path.name.endswith(".config.json"):
        return json.loads(cfg_path.read_text())
    import torch  # reference .P compatibility (pickled argparse.Namespace)

    obj = torch.load(cfg_path, map_location="cpu", weights_only=False)
    return vars(obj) if hasattr(obj, "__dict__") else dict(obj)


def find_checkpoint_cfg(checkpoint_path, prefix: str) -> Optional[Path]:
    """Locate {prefix}.config.json (ours) or {prefix}.P (reference) in a dir."""
    d = Path(checkpoint_path)
    for cand in (d / f"{prefix}.config.json", d / f"{prefix}.P"):
        if cand.exists():
            return cand
    return None


def _enforce_arch_from_ckpt(args: argparse.Namespace, ckpt_cfg: dict):
    for k in ARCH_KEYS:
        if k in ckpt_cfg and hasattr(args, k):
            setattr(args, k, ckpt_cfg[k])
    return args


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    """Parse with the reference's merge priority (args.py:220-277):

    defaults < checkpoint cfg (if --use_stored_args or resuming) < JSON
    --configPath < explicit CLI; ARCH_KEYS always pinned to the checkpoint.
    """
    import sys

    argv = list(sys.argv[1:]) if argv is None else list(argv)
    parser = build_parser()
    args = parser.parse_args(argv)
    cli_set = _cli_provided_dests(parser, argv)

    # 1) JSON config file overrides defaults (but not explicit CLI)
    json_cfg = {}
    if args.configPath:
        json_cfg = json.loads(Path(args.configPath).read_text())
        # a stored run-config snapshot ({tag}.config.json) merges like a
        # hand-written config; keys the parser lacks are skipped
        json_cfg.pop("_config_snapshot", None)
        for k, v in json_cfg.items():
            if hasattr(args, k) and k not in cli_set:
                setattr(args, k, v)

    # 2) checkpoint config: fills anything not set by CLI or JSON when
    #    requested; ARCH_KEYS always forced
    ckpt_cfg = {}
    if args.checkpoint_path:
        cfg_file = find_checkpoint_cfg(args.checkpoint_path, args.prefix)
        if cfg_file is not None:
            ckpt_cfg = load_checkpoint_cfg(cfg_file)
            if args.use_stored_args:
                for k, v in ckpt_cfg.items():
                    if hasattr(args, k) and k not in cli_set and k not in json_cfg:
                        setattr(args, k, v)
            _enforce_arch_from_ckpt(args, ckpt_cfg)
            # render-mode keys follow the checkpoint unless explicitly set:
            # render how the model trained (soft/hard, importance, probe
            # masking) without requiring --use_stored_args
            for k in OCC_MODE_KEYS:
                if (k in ckpt_cfg and hasattr(args, k)
                        and k not in cli_set and k not in json_cfg):
                    setattr(args, k, ckpt_cfg[k])

    # --render_fast preset: the measured fastest render configuration
    # (top-1 bucketed routing + union-probe grid, BASELINE.md render
    # ladder). Expanded AFTER all merges so explicit choices still win.
    if getattr(args, "render_fast", False):
        for k, v in (("bucketed_moe", True), ("experts_per_point", 1),
                     ("occ_union_probe_res", 128)):
            if k not in cli_set and k not in json_cfg:
                setattr(args, k, v)
    return args


def namespace_to_dict(args: argparse.Namespace) -> dict:
    """JSON-serializable snapshot of the run config.

    Tagged _config_snapshot, as the reference tags its snapshots, so the
    reference's parse_args reads the port's snapshots as it reads its
    own."""
    out = {"_config_snapshot": True}
    for k, v in vars(args).items():
        try:
            json.dumps(v)
            out[k] = v
        except TypeError:
            out[k] = str(v)
    return out
