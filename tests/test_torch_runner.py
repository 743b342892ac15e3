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
same training cameras bit for bit. The precision options (`--use_amp`,
bfloat16 line matmuls, both) run train, eval and video from the
checkpoint's stored config, with FoMAML and with `--algo maml` (on the
default hash experts with `--use_amp`, on planes with both).
"""
import dataclasses
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
from test_torch_threads import one_intra_op_thread  # noqa: F401,E402 (autouse)

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


@pytest.mark.parametrize("flags", [
    ["--use_amp", "--algo", "maml"],
    ["--plane_lines_mm", "--plane_lines_mm_dtype", "bfloat16", "--algo",
     "maml", "--xyz_encoding", "planes"],
], ids=["use_amp", "lines_bf16"])
def test_maml_under_precision_options_builds(data_root, flags):
    """Second-order MAML under either precision option builds its train
    context and step (kernel 5''b under bfloat16 line matmuls)."""
    from nerfsys_tpu_torch.pipelines.offline.meta_train_step import (
        make_train_step,
    )

    P = TC.parse_args(["--device", "cpu", *_scene_args(data_root), *SMALL,
                       *flags])
    ctx = TR.build_context(P, "train")
    try:
        meta, cfg = TR.meta_config_from_args(ctx["P"]), ctx["cfg"]
        assert meta.algo == "maml" and not meta.first_order
        assert (cfg.expert.use_bf16, bool(cfg.expert.planes
                                          and cfg.expert.planes.lines_bf16)
                ) == ("--use_amp" in flags, "bfloat16" in flags)
        make_train_step(meta, cfg, TR.build_optimizer(
            TR.optim_config_from_args(ctx["P"]), TR.param_group_labels(
                ctx["params"])))
    finally:
        for name in ("train_loader", "eval_loader"):
            ctx[name].close()


@pytest.mark.parametrize("flags,refused", [
    (["--plane_lines_mm_dtype", "bfloat16"], False),
    (["--plane_lines_mm"], False),
    (["--plane_lines_mm", "--plane_lines_mm_dtype", "bfloat16"], True),
])
def test_line_matmul_dtype_refused_only_with_line_matmuls(flags, refused):
    """The reference reads --plane_lines_mm_dtype only with
    --plane_lines_mm (its bfloat16 line matmuls, kernels 1b and 5b, and
    5''b under MAML); float32 ones compute the gathers' function. The
    flags are carried as the JAX runner's container_config_from_args
    carries them (`refused`: the config's lines_bf16); every algorithm
    builds its step under them."""
    from nerfsys_tpu_torch.pipelines.offline.meta_core import MetaConfig
    from nerfsys_tpu_torch.pipelines.offline.meta_train_step import (
        make_train_step,
    )

    def parsed(extra):
        P = TC.parse_args(["--device", "cpu", "--xyz_encoding", "planes",
                           *extra])
        P.boundary_margin_effective, P.cluster_2d = 1.1, True
        return P

    cfg = TR.container_config_from_args(parsed(flags))
    planes = cfg.expert.planes
    assert planes.lines_matmul == ("--plane_lines_mm" in flags)
    assert planes.lines_mm_dtype == ("bfloat16" if "bfloat16" in flags
                                     else "float32")
    assert planes.lines_bf16 == refused
    Pj = JC.parse_args(["--xyz_encoding", "planes", *flags])
    Pj.boundary_margin_effective, Pj.cluster_2d = 1.1, True
    jplanes = JR.container_config_from_args(Pj).expert.planes
    assert (jplanes.lines_matmul, jplanes.lines_mm_dtype) == (
        planes.lines_matmul, planes.lines_mm_dtype)
    for algo in ("fomaml", "maml", "reptile"):
        make_train_step(MetaConfig(algo=algo), cfg, None)
    if not refused:
        assert dataclasses.replace(planes, lines_matmul=False,
                                   lines_mm_dtype="float32") == (
            TR.container_config_from_args(parsed([])).expert.planes)


PRECISION = {"amp": ["--use_amp"],
             "lines_bf16": ["--plane_lines_mm", "--plane_lines_mm_dtype",
                            "bfloat16"],
             "both": ["--use_amp", "--plane_lines_mm",
                      "--plane_lines_mm_dtype", "bfloat16"]}
# second-order MAML under the options: --use_amp on the default hash
# experts (a small table), both options on planes (kernel 5''b)
PRECISION_MAML = {
    "maml-amp-hash": ["--use_amp", "--algo", "maml", "--log2_hashmap_size",
                      "12", "--max_res", "64"],
    "maml-both": PRECISION["both"] + ["--algo", "maml"]}


@pytest.mark.parametrize("option", sorted(PRECISION) + sorted(
    PRECISION_MAML))
def test_precision_options_run_train_eval_video(data_root, tmp_path,
                                               monkeypatch, option):
    """--use_amp, bfloat16 line matmuls and both, with FoMAML, and
    second-order MAML with --use_amp (hash experts) and with both
    (planes): a train run, then eval (tto 0 and 1) and a video from its
    checkpoint. The options are not architecture keys: eval takes them
    from the stored config under --use_stored_args, the video from its own
    flags. Eval and video render in chunks of 1,024 rays: the default pads
    a 64x48 image to ~3.1M sample points a chunk, seconds of plain-version
    work on the CPU."""
    from nerfsys_tpu_torch.pipelines import video_gen
    from nerfsys_tpu_torch.pipelines.online import runtime_adapt
    from nerfsys_tpu_torch.utils import checkpoint as ckpt
    from nerfsys_tpu_torch.utils.tree import tree_leaves

    monkeypatch.chdir(tmp_path)  # logs/ land in the tmp dir
    for mod in (runtime_adapt, video_gen):
        monkeypatch.setattr(mod, "default_chunk_rays", lambda *a, **k: 1024)
    flags = PRECISION.get(option) or PRECISION_MAML[option]
    enc = ["--xyz_encoding", "hash" if "hash" in option else "planes"]
    scene = [*_scene_args(data_root), *SMALL, *enc, "--device", "cpu"]
    ctx = TR.main(["--op", "train", "--configPath",
                   str(REPO / "configs" / "train.json"), *scene,
                   *flags, "--outer_steps", "1", "--save_step",
                   "1", "--fname", "run"])
    run = Path(ctx["run_dir"])
    want = ("--use_amp" in flags, "bfloat16" in flags)

    def options(c):
        return c.expert.use_bf16, bool(c.expert.planes
                                       and c.expert.planes.lines_bf16)

    assert options(ctx["cfg"]) == want
    assert (ctx["cfg"].expert.xyz_encoding == "hash") == ("hash" in option)
    assert TR.meta_config_from_args(ctx["P"]).algo == (
        "maml" if option in PRECISION_MAML else "fomaml")
    stored = json.loads((run / "last.config.json").read_text())
    assert (stored["use_amp"], stored["plane_lines_mm"]) == want
    params, _, _ = ckpt.load_checkpoint(run, "last", ctx["params"])
    assert all(torch.isfinite(t).all() for t in tree_leaves(params))
    ev = TR.main(["--op", "eval", *scene, "--checkpoint_path", str(run),
                  "--prefix", "last", "--tto", "0,1", "--cap_images", "1",
                  "--support_rays", "64", "--use_stored_args", "--fname",
                  "eval"])
    assert options(ev["cfg"]) == want
    assert [r["tto"] for r in ev["rows"]] == [0, 1]
    assert all(np.isfinite(r["psnr"]) for r in ev["rows"])
    if option == "both":
        # the same params and grids as the JAX package writes them, with
        # the JAX runner's own config snapshot of the same flags: they
        # evaluate alike
        from nerfsys_tpu.utils import checkpoint as JCK

        jrun = tmp_path / "jax_ckpt"
        Pj = JC.parse_args(["--op", "train", "--configPath",
                            str(REPO / "configs" / "train.json"),
                            *scene[:scene.index("--device")],
                            *flags, "--outer_steps", "1"])
        JCK.save_checkpoint(jrun, "last", interop.tree_to_numpy(params),
                            config=JC.namespace_to_dict(Pj), step=1)
        occ = ckpt.load_aux_state(run, "occ", ev["occ_state"])
        JCK.save_aux_state(jrun, "last", "occ", interop.tree_to_numpy(occ))
        jev = TR.main(["--op", "eval", *scene, "--checkpoint_path",
                       str(jrun), "--prefix", "last", "--tto", "0",
                       "--cap_images", "1", "--support_rays", "64",
                       "--use_stored_args", "--fname", "jax_eval"])
        assert options(jev["cfg"]) == want
        assert jev["rows"][0]["psnr"] == ev["rows"][0]["psnr"]
    vid = TR.main(["--op", "video", *scene, "--checkpoint_path", str(run),
                   "--prefix", "last", "--camera_path", "turntable",
                   "--video_frames", "2", "--cap_images", "1",
                   "--downscale", "0.25", "--ray_samples", "4",
                   *flags, "--fname", "video"])
    assert options(vid["cfg"]) == want
    assert Path(vid["video_path"]).exists()


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
    # the premark reads no params: skip the JAX runner's init draw (eager
    # JAX compiles each init op), as tests/test_torch_video_runner.py does
    host = interop.tree_to_numpy(tctx["params"])
    monkeypatch.setattr(JR, "init_container_params", lambda key, cfg:
                        jax.tree_util.tree_map(jax.numpy.asarray, host))
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
