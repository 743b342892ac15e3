"""The port's eval op as a whole, against the JAX package's, on the
prepared COLMAP test scene (tests/test_torch_data.py's `prepare_scene`).

The port's runner trains configs/train.json's model at test widths (K=4
planes experts L=1 base 8 F=4, hidden 8, soft importance occupancy R=16
L=2, ready after the first update) for 2 steps (held to the JAX runner's
training in tests/test_torch_runner.py and test_torch_trainer.py); the
JAX package writes its `last` params and grids as flax checkpoints with
the JAX runner's config snapshot; then both runners evaluate that `last`
with configs/eval.json,
`--tto 0,1 --cap_images 1 --ray_samples 8 --support_rays 64` and LPIPS
weights from `random_weights` (the JAX one through `evaluate`, the port
through `runner.main(["--op", "eval", "--device", "cpu", ...])`).

Tolerances at tto 0, from what this fixture measures (PSNR equal to
1e-6 dB, SSIM 8e-7, LPIPS equal): PSNR within 0.005 dB, SSIM within 2e-5,
LPIPS within 1e-5 relative. The JAX side renders jitted, and XLA fuses
multiply-adds, which can move a probe point to the neighbouring cell; one
ray's color moved by 0.1 moves this image's PSNR by about 1e-4 dB. At tto
1 both are finite and the port's adapted params moved. A checkpoint that
the port writes from the restored params evaluates to the same numbers.
So does the hard mask from the probes' interval bits (`--occ_probe_mask`
through a JSON copy of configs/eval.json), at tto 0 within the same
tolerances.
"""
import json
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

from test_dataprep_e2e import colmap_scene  # noqa: F401  (fixture)
from test_torch_data import prepare_scene
from test_torch_runner import SMALL

from nerfsys_tpu_torch import runner as TR
from nerfsys_tpu_torch.utils import checkpoint as TCK
from nerfsys_tpu_torch.utils.tree import tree_leaves
from test_torch_threads import one_intra_op_thread  # noqa: F401,E402 (autouse)

REPO = Path(__file__).resolve().parent.parent
EVAL = ["--configPath", str(REPO / "configs" / "eval.json"),
        "--downscale", "1.0", "--prefix", "last", "--tto", "0,1",
        "--cap_images", "1", "--ray_samples", "8", "--support_rays", "64"]


def _scene_args(data_root):
    return ["--data_path", str(data_root), "--data_dirname", "scene",
            "--mask_dirname", "g22"]


def _jax_checkpoint(port_run: Path, run_dir: Path, train_argv) -> None:
    """The port run's trained `last` params and grids written by the JAX
    package (flax msgpack), with the JAX runner's own config snapshot of
    the same train flags."""
    from nerfsys_tpu.ops.occupancy import OccGridConfig, init_occ_state
    from nerfsys_tpu.utils import checkpoint as JCK
    from nerfsys_tpu.utils.config import namespace_to_dict, parse_args

    from nerfsys_tpu_torch.utils import interop

    params = torch.load(port_run / "last.model", weights_only=True)
    occ = torch.load(port_run / "last.occ", weights_only=True)
    P = parse_args(train_argv)
    JCK.save_checkpoint(run_dir, "last", interop.tree_to_numpy(params),
                        config=namespace_to_dict(P), step=2)
    jocc = init_occ_state(OccGridConfig(resolution=P.occ_resolution,
                                        levels=P.occ_levels),
                          P.num_submodules)
    JCK.save_aux_state(run_dir, "last", "occ", {
        k: np.asarray(occ[k].numpy(), np.asarray(v).dtype)
        for k, v in jocc.items()})


def _skip_jax_init(mp, params) -> None:
    """The checkpoint replaces the JAX runner's init params: hand it these
    (the same tree) instead of drawing them (eager JAX compiles each init
    op), as tests/test_torch_video_runner.py does."""
    import jax
    import jax.numpy as jnp
    from nerfsys_tpu import runner as JR

    from nerfsys_tpu_torch.utils import interop

    host = interop.tree_to_numpy(params)
    mp.setattr(JR, "init_container_params", lambda key, cfg:
               jax.tree_util.tree_map(jnp.asarray, host))


@pytest.fixture(scope="module")
def evals(colmap_scene, tmp_path_factory):  # noqa: F811
    """(JAX rows, the port's ctx with its results, scene args, the JAX
    checkpoint's dir, work dir)."""
    from nerfsys_tpu.runner import build_context, evaluate
    from nerfsys_tpu.scripts.convert_lpips_weights import random_weights
    from nerfsys_tpu.utils.config import parse_args

    work = tmp_path_factory.mktemp("eval")
    data_root = work / "drz"
    data_root.mkdir()
    prepare_scene(colmap_scene, data_root)
    scene = _scene_args(data_root)
    lpips_npz = work / "alex_random.npz"
    np.savez(lpips_npz, **random_weights(7))
    with pytest.MonkeyPatch.context() as mp:
        mp.chdir(work)  # logs/ land in the work dir
        mp.setenv("NERFSYS_LPIPS_WEIGHTS", str(lpips_npz))
        train_argv = ["--op", "train", "--configPath",
                      str(REPO / "configs" / "train.json"), *scene, *SMALL,
                      "--outer_steps", "2", "--save_step", "2"]
        port_run = Path(TR.main(train_argv + [
            "--fname", "port_run", "--device", "cpu"])["run_dir"]).resolve()
        run_dir = work / "jax_ckpt"
        _jax_checkpoint(port_run, run_dir, train_argv)
        _skip_jax_init(mp, torch.load(port_run / "last.model",
                                      weights_only=True))
        argv = ["--op", "eval", *scene, *EVAL, "--checkpoint_path",
                str(run_dir)]
        jrows = evaluate(build_context(parse_args(
            argv + ["--fname", "jax_eval"]), "eval"))
        results = []
        orig = TR.runtime_evaluate

        def keep(**kw):
            out = orig(**kw)
            results.append(out)
            return out

        mp.setattr(TR, "runtime_evaluate", keep)
        tctx = TR.main(argv + ["--fname", "port_eval", "--device", "cpu"])
        tctx["results"] = results
    return jrows, tctx, scene, run_dir, work


def test_eval_matches_jax_at_tto_0(evals):
    jrows, tctx, *_ = evals
    j, t = jrows[0], tctx["rows"][0]
    assert j["tto"] == t["tto"] == 0
    assert abs(t["psnr"] - j["psnr"]) <= 0.005, (t["psnr"], j["psnr"])
    assert abs(t["ssim"] - j["ssim"]) <= 2e-5, (t["ssim"], j["ssim"])
    assert abs(t["lpips"] - j["lpips"]) <= 1e-5 * abs(j["lpips"])
    assert t["num_images"] == j["num_images"] == 1
    assert "occ_state" in tctx and tctx["ckpt_state"]["step"] == 2


def test_eval_adapts_at_tto_1(evals):
    jrows, tctx, *_ = evals
    j, t = jrows[1], tctx["rows"][1]
    assert j["tto"] == t["tto"] == 1
    for k in ("psnr", "ssim", "lpips", "duration", "render_time"):
        assert np.isfinite(t[k]) and np.isfinite(j[k]), k
    base = tree_leaves(tctx["params"])
    r0, r1 = tctx["results"]
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(r0["params"]),
                                                 base))
    moved = [not torch.equal(a, b)
             for a, b in zip(tree_leaves(r1["params"]), base)]
    assert all(moved), moved.count(False)


def test_eval_writes_results_and_pngs(evals):
    from PIL import Image

    _, tctx, _, _, work = evals
    run = work / tctx["run_dir"]  # relative to the run's directory
    rows = json.loads((run / "eval_results.json").read_text())
    assert [r["tto"] for r in rows] == [0, 1]
    assert set(rows[0]) == {"tto", "psnr", "ssim", "lpips", "duration",
                            "render_time", "num_images"}
    md = tctx["test_metadata"][0]
    for sub in ("pred0", "pred1", "gt"):
        img = np.asarray(Image.open(run / "rendered" / sub / "000000.png"))
        assert img.shape == (md.H, md.W, 3) and img.dtype == np.uint8
    gt = np.asarray(Image.open(run / "rendered" / "gt" / "000000.png"))
    np.testing.assert_array_equal(gt, md.load_image())


def test_a_port_checkpoint_evaluates_alike(evals, monkeypatch):
    """The restored params written back by the port (torch.save) with the
    JAX run's config and grids evaluate to the same numbers."""
    jrows, tctx, scene, run_dir, work = evals
    own = work / "port_ckpt"
    TCK.save_checkpoint(own, "last", tctx["params"], step=2)
    TCK.save_aux_state(own, "last", "occ", tctx["occ_state"])
    shutil.copy(run_dir / "last.config.json", own / "last.config.json")
    monkeypatch.chdir(work)
    monkeypatch.setenv("NERFSYS_LPIPS_WEIGHTS", str(work /
                                                   "alex_random.npz"))
    ctx = TR.main(["--op", "eval", *scene, *EVAL, "--tto", "0",
                   "--checkpoint_path", str(own), "--fname", "port_own",
                   "--device", "cpu"])
    row, want = ctx["rows"][0], tctx["rows"][0]
    for k in ("psnr", "ssim", "lpips"):
        assert row[k] == want[k], k


def test_eval_with_probe_masks_matches_jax(evals, tmp_path, monkeypatch):
    """A JSON copy of configs/eval.json with the hard mask on and
    occ_probe_mask (its mode keys win over the soft checkpoint's): both
    runners evaluate the JAX run's `last` at tto 0 within the tolerances
    above, and the port's renders differ from its soft render."""
    from nerfsys_tpu.runner import build_context, evaluate
    from nerfsys_tpu.utils.config import parse_args

    _, tctx, scene, run_dir, work = evals
    cfg_json = json.loads((REPO / "configs" / "eval.json").read_text())
    bits = tmp_path / "eval_probe.json"
    bits.write_text(json.dumps(dict(cfg_json, occ_no_hard_mask=False,
                                    occ_probe_mask=True)))
    argv = ["--op", "eval", *scene, *EVAL, "--tto", "0", "--configPath",
            str(bits), "--checkpoint_path", str(run_dir)]
    monkeypatch.chdir(work)
    monkeypatch.setenv("NERFSYS_LPIPS_WEIGHTS", str(work /
                                                   "alex_random.npz"))
    _skip_jax_init(monkeypatch, tctx["params"])
    j = evaluate(build_context(parse_args(argv + ["--fname", "jax_bits"]),
                               "eval"))[0]
    ctx = TR.main(argv + ["--fname", "port_bits", "--device", "cpu"])
    assert ctx["P"].occ_probe_mask and not ctx["P"].occ_no_hard_mask
    t = ctx["rows"][0]
    assert abs(t["psnr"] - j["psnr"]) <= 0.005, (t["psnr"], j["psnr"])
    assert abs(t["ssim"] - j["ssim"]) <= 2e-5, (t["ssim"], j["ssim"])
    assert abs(t["lpips"] - j["lpips"]) <= 1e-5 * abs(j["lpips"])
    assert t["psnr"] != tctx["rows"][0]["psnr"]  # the mask changed it


@pytest.mark.parametrize("flags,match", [
    (["--fim"], "fim"), (["--mesh_shape", "2"], "mesh_shape")])
def test_eval_refuses_unported_flags(evals, flags, match):
    _, _, scene, run_dir, _ = evals
    with pytest.raises(NotImplementedError, match=f"{match}.*item 7"):
        TR.main(["--op", "eval", *scene, *EVAL, "--checkpoint_path",
                 str(run_dir), "--device", "cpu", *flags])


def test_eval_without_a_card_raises(evals):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    _, _, scene, run_dir, _ = evals
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TR.main(["--op", "eval", *scene, *EVAL, "--checkpoint_path",
                 str(run_dir)])
