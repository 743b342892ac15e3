"""Port parity of the runner's train op: the flag system (`parse_args`),
the configs built from flags, and `runner.main(["--op", "train", ...])`
end to end on the prepared test scene (tests/test_torch_data.py's), on the
CPU.

Configs: for each of configs/*.json, with CLI overrides, the --render_fast
preset and an architecture key pinned from a checkpoint's config, the
port's Namespace equals the JAX package's on the keys they share: the
port adds `--device` and lacks the reference's TPU execution knobs
(`TPU_ONLY`), which it refuses on the command line and skips in a JSON
config; the port's `*_config_from_args` equal `interop.*_from_jax` of
the JAX package's. The runner trains 2 steps of configs/train.json's
model at test widths with soft importance occupancy (R=16, L=2), writes
`last.*`, and its premarked grids equal the JAX package's premark of the
same training cameras bit for bit.
"""
import json
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from test_dataprep_e2e import colmap_scene  # noqa: F401  (fixture)
from test_torch_data import prepare_scene

from nerfsys_tpu import runner as JR
from nerfsys_tpu.utils import config as JC
from nerfsys_tpu_torch import runner as TR
from nerfsys_tpu_torch.utils import config as TC
from nerfsys_tpu_torch.utils import interop

REPO = Path(__file__).resolve().parent.parent
CONFIGS = sorted(str(p.relative_to(REPO)) for p in (REPO / "configs").glob(
    "*.json"))
SMALL = ["--num_submodules", "4", "--downscale", "1.0",
         "--support_rays", "64", "--query_rays", "32", "--batch_size", "1",
         "--eval_step", "0", "--print_step", "1", "--inner_iter", "1",
         "--ray_samples", "8", "--dim_hidden", "8", "--color_hidden", "8",
         "--sigma_depth", "1", "--color_depth", "1", "--plane_levels", "1",
         "--plane_base_res", "8", "--plane_features", "4", "--bg_hidden",
         "8", "--occ_resolution", "16", "--occ_levels", "2", "--occ_warmup",
         "1", "--occ_update_interval", "1", "--occ_probes", "16"]


@pytest.fixture(scope="module")
def data_root(colmap_scene, tmp_path_factory):  # noqa: F811
    root = tmp_path_factory.mktemp("drz")
    prepare_scene(colmap_scene, root)
    return root


def _scene_args(data_root):
    return ["--data_path", str(data_root), "--data_dirname", "scene",
            "--mask_dirname", "g22"]


# the reference's TPU execution knobs and `explicit_keys`, which only
# chunk_points read; the port's parser has none of them (it takes
# --plane_lines_mm, to refuse only bfloat16 line matmuls)
TPU_ONLY = {"expert_unroll", "task_unroll", "plane_pad_rows",
            "line_pad_rows", "plane_scatter_bwd", "chunk_points",
            "explicit_keys"}


def _both(argv):
    """(JAX Namespace on the shared keys, port Namespace without
    `device`)."""
    j = vars(JC.parse_args(argv))
    t = vars(TC.parse_args(argv + ["--device", "cpu"]))
    assert t.pop("device") == "cpu"
    assert set(j) - set(t) == TPU_ONLY and set(t) <= set(j)
    return {k: j[k] for k in t}, t


@pytest.mark.parametrize("config", CONFIGS)
@pytest.mark.parametrize("extra", [
    [],
    ["--outer_steps", "7", "--plane_levels", "2", "--lr=0.5"],
    ["--render_fast", "--experts_per_point", "2"],
])
def test_parse_args_matches_jax(config, extra):
    j, t = _both(["--configPath", str(REPO / config)] + extra)
    assert t == j
    if "--render_fast" in extra:
        assert t["bucketed_moe"] and t["occ_union_probe_res"] == 128
        assert t["experts_per_point"] == 2  # the explicit flag wins


def test_parse_args_pins_arch_keys_from_a_checkpoint(tmp_path):
    snap = TC.namespace_to_dict(TC.parse_args(
        ["--plane_levels", "5", "--use_occ", "--occ_importance",
         "--dim_hidden", "32", "--device", "cpu"]))
    assert snap["_config_snapshot"] and snap["device"] == "cpu"
    (tmp_path / "best.config.json").write_text(json.dumps(snap))
    argv = ["--configPath", str(REPO / "configs" / "train.json"),
            "--checkpoint_path", str(tmp_path), "--dim_hidden", "16"]
    j, t = _both(argv)
    assert t == j
    # ARCH_KEYS win over the JSON file and the CLI; the occupancy mode
    # keys follow the checkpoint unless set
    assert t["plane_levels"] == 5 and t["dim_hidden"] == 32
    assert t["occ_importance"] and t["use_occ"]
    # a snapshot used as --configPath merges but sets nothing explicit
    j, t = _both(["--configPath", str(tmp_path / "best.config.json")])
    assert t == j


@pytest.mark.parametrize("flag", ["--expert_unroll", "--task_unroll",
                                  "--plane_scatter_bwd",
                                  "--plane_pad_rows=8", "--line_pad_rows=8",
                                  "--chunk_points=4096"])
def test_parse_args_refuses_tpu_only_flags(flag, tmp_path, capsys):
    with pytest.raises(SystemExit):
        TC.parse_args([flag, "--device", "cpu"])
    assert flag.split("=")[0] in capsys.readouterr().err
    # a JSON config that sets it loads; the key is skipped
    key = flag.lstrip("-").split("=")[0]
    cfg = tmp_path / "tpu.json"
    cfg.write_text(json.dumps({key: 8, "dim_hidden": 16}))
    t = TC.parse_args(["--configPath", str(cfg), "--device", "cpu"])
    assert not hasattr(t, key) and t.dim_hidden == 16


def _namespace(config, extra=()):
    argv = ["--configPath", str(REPO / config), *extra]
    P, Pj = TC.parse_args(argv + ["--device", "cpu"]), JC.parse_args(argv)
    for ns in (P, Pj):
        ns.boundary_margin_effective, ns.cluster_2d = 1.1, True
    return P, Pj


@pytest.mark.parametrize("config", CONFIGS)
@pytest.mark.parametrize("extra", [(), ("--xyz_encoding", "planes",
                                        "--plane_pos_grad", "--no_bg_nerf",
                                        "--occ_no_hard_mask",
                                        "--packed_gather")])
def test_configs_from_flags_match_jax(config, extra):
    P, Pj = _namespace(config, extra)
    assert TR.container_config_from_args(P) == \
        interop.container_config_from_jax(JR.container_config_from_args(Pj))
    assert TR.optim_config_from_args(P) == \
        interop.optim_config_from_jax(JR.optim_config_from_args(Pj))
    assert TR.meta_config_from_args(P) == \
        interop.meta_config_from_jax(JR.meta_config_from_args(Pj))
    assert TR.occ_config_from_args(P) == \
        interop.occ_grid_config_from_jax(JR.occ_config_from_args(Pj))


@pytest.mark.parametrize("op", ["eval", "video", "view"])
def test_unported_ops_raise(data_root, op):
    # the eval and video ops are ported; the Fisher-weighted adaptation
    # and mesh sharding are not
    item, extra = {"eval": ("item 7", ["--fim"]),
                   "video": ("item 7", ["--mesh_shape", "2"]),
                   "view": ("item 8", [])}[op]
    with pytest.raises(NotImplementedError, match=item):
        TR.main(["--op", op, "--device", "cpu", *_scene_args(data_root),
                 *extra])


@pytest.mark.parametrize("flags,match", [
    (["--mesh_shape", "2"], "mesh_shape"),
    (["--use_amp"], "use_amp"),
    (["--plane_lines_mm", "--plane_lines_mm_dtype", "bfloat16"],
     "plane_lines_mm_dtype"),
    (["--fim"], "fim"),
    (["--nerf_variant", "vanilla"], "vanilla"),
    (["--dir_encoding", "frequency"], "frequency"),
    (["--bg_encoding", "frequency"], "spherical"),
])
def test_unported_flags_raise_at_context_build(data_root, flags, match):
    P = TC.parse_args(["--device", "cpu", *_scene_args(data_root), *SMALL,
                       *flags])
    with pytest.raises(NotImplementedError, match=match):
        TR.build_context(P, "train")


@pytest.mark.parametrize("flags,refused", [
    (["--plane_lines_mm_dtype", "bfloat16"], False),
    (["--plane_lines_mm"], False),
    (["--plane_lines_mm", "--plane_lines_mm_dtype", "bfloat16"], True),
])
def test_line_matmul_dtype_refused_only_with_line_matmuls(flags, refused):
    """The reference reads --plane_lines_mm_dtype only with
    --plane_lines_mm (its bfloat16 line matmuls); float32 ones compute
    the gathers' function."""
    def parsed(extra):
        P = TC.parse_args(["--device", "cpu", "--xyz_encoding", "planes",
                           *extra])
        P.boundary_margin_effective, P.cluster_2d = 1.1, True
        return P

    if refused:
        with pytest.raises(NotImplementedError,
                           match="plane_lines_mm_dtype"):
            TR.container_config_from_args(parsed(flags))
    else:
        assert (TR.container_config_from_args(parsed(flags))
                == TR.container_config_from_args(parsed([])))


@pytest.mark.parametrize("op", ["train", "eval", "video"])
def test_probe_masks_pass_the_refusals(data_root, op):
    """--occ_probe_mask is ported: no op refuses it, and the train
    context's meta-learning config carries it as the JAX runner's does."""
    from nerfsys_tpu import runner as JR
    from nerfsys_tpu.utils import config as JC

    argv = [*_scene_args(data_root), *SMALL, "--occ_probe_mask"]
    P = TC.parse_args(["--device", "cpu", *argv])
    TR.refuse_unported(P, op)
    if op == "train":
        ctx = TR.build_context(P, "train")
        meta = TR.meta_config_from_args(ctx["P"])
        assert meta.occ_probe_mask
        assert meta == interop.meta_config_from_jax(
            JR.meta_config_from_args(JC.parse_args(argv)))


def test_the_card_is_the_default_and_no_card_raises(data_root):
    P = TC.parse_args([*_scene_args(data_root), *SMALL])
    assert P.device == "cuda"
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TR.build_context(P, "train")


def test_a_dropped_expert_raises_before_the_first_step(data_root):
    bundle = type("B", (), {"train_cells": [0, 1, 3], "val_cells": [0, 1,
                                                                    2, 3]})
    with pytest.raises(ValueError, match=r"expert\(s\) \[2\] have no train"):
        TR.check_expert_sets(bundle, 4)
    bundle.train_cells, bundle.val_cells = [0, 1, 2, 3], [1, 2, 3]
    with pytest.raises(ValueError, match=r"\[0\] have no val"):
        TR.check_expert_sets(bundle, 4)


def test_runner_trains_on_the_cpu_and_premarks_like_jax(data_root, tmp_path,
                                                        monkeypatch):
    from nerfsys_tpu.models import occupancy as JMO
    from nerfsys_tpu.ops import occupancy as JO

    monkeypatch.chdir(tmp_path)  # logs/ land in the tmp dir
    argv = ["--op", "train", "--configPath",
            str(REPO / "configs" / "train.json"), "--device", "cpu",
            *_scene_args(data_root), *SMALL, "--outer_steps", "2",
            "--save_step", "2", "--xyz_encoding", "planes",
            "--fname", "port_run"]
    ctx = TR.main(argv)
    run = Path(ctx["run_dir"])
    assert run == Path("logs") / "port_run"
    for ext in ("model", "optim", "config.json", "state.json", "occ"):
        for tag in ("last", "step2"):
            assert (run / f"{tag}.{ext}").exists()
    state = json.loads((run / "last.state.json").read_text())
    assert state["step"] == 2
    cfg = json.loads((run / "last.config.json").read_text())
    assert cfg["device"] == "cpu" and cfg["use_occ"]
    assert cfg["ray_samples"] == 8
    from nerfsys_tpu_torch.utils import checkpoint as ckpt
    from nerfsys_tpu_torch.utils.tree import tree_leaves

    occ = ckpt.load_aux_state(run, "occ", TR.build_occupancy(ctx)[0])
    assert int(occ["num_updates"]) == 2  # --occ_update_interval 1
    params, _, _ = ckpt.load_checkpoint(run, "last", ctx["params"])
    assert all(torch.isfinite(t).all() for t in tree_leaves(params))

    # the premark against the JAX package's (through interop), on the same
    # training cameras, eager as in tests/test_torch_occ_update.py
    P = TC.parse_args(argv + ["--fname", "premark"])
    tctx = TR.build_context(P, "train")
    got, _ = TR.build_occupancy(tctx)
    Pj = JC.parse_args(argv[:argv.index("--device")]
                       + argv[argv.index("--device") + 2:])
    jctx = JR.build_context(Pj, "train")
    md = jctx["bundle"].train_metadata
    ocfg = JR.occ_config_from_args(Pj)
    with jax.disable_jit():
        want = JMO.premark_invisible_expert_cells(
            JO.init_occ_state(ocfg, 4), jctx["statics"], ocfg,
            np.stack([m.c2w for m in md]),
            np.stack([m.intrinsics[:4] for m in md]),
            np.asarray([[m.W, m.H] for m in md], np.float32),
            near=Pj.near or 0.0)
    want = interop.occ_state_from_jax(
        jax.tree_util.tree_map(np.asarray, want), "cpu")
    for k in want:
        assert torch.equal(got[k], want[k]), k
    share = float((got["occs"] < 0).float().mean())
    assert 0.0 < share < 1.0
    for name in ("train_loader", "eval_loader"):
        tctx[name].close()
        jctx[name].close()
    tb = tctx["bundle"]
    for a, b in zip(jctx["bundle"].train_sets, tb.train_sets):
        assert np.array_equal(a.rays, b.rays)
