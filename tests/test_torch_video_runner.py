"""The port's runner `--op video` end to end on `device="cpu"`, against
the JAX package's runner: both render the same flax checkpoint (the
port's init params at test widths and a ready grid, written by the JAX
package) on the prepared COLMAP test scene (tests/test_torch_data.py's
`prepare_scene`) at downscale 0.25, through the hard-mask two-wave
host-ray path. Frames must have the val camera's shape and the same
writer layout as the JAX runner's, and be uint8 within 1 level on all but
0.5% of the pixels (tests/test_torch_video.py's rule; the JAX side runs
jitted, as its video op serves).
"""
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np

from test_dataprep_e2e import colmap_scene  # noqa: F401  (fixture)
from test_torch_data import prepare_scene
from test_torch_runner import SMALL
from test_torch_video import _frames, _u8_close

from nerfsys_tpu.utils import config as JC
from nerfsys_tpu_torch.utils import config as TC
from nerfsys_tpu_torch.utils import interop


def test_runner_video_matches_jax_runner(colmap_scene, tmp_path,  # noqa: F811
                                         monkeypatch):
    from nerfsys_tpu import runner as JR
    from nerfsys_tpu.ops.occupancy import OccGridConfig, init_occ_state
    from nerfsys_tpu.utils import checkpoint as JCK
    from nerfsys_tpu_torch import runner as TR

    data_root = tmp_path / "drz"
    data_root.mkdir()
    prepare_scene(colmap_scene, data_root)
    monkeypatch.chdir(tmp_path)  # logs/ land in the tmp dir
    small = SMALL[:SMALL.index("--occ_resolution")] + [
        "--occ_resolution", "8", "--occ_levels", "2"]
    base = ["--op", "video", "--data_path", str(data_root),
            "--data_dirname", "scene", "--mask_dirname", "g22", *small,
            "--xyz_encoding", "planes", "--ray_samples", "4", "--use_occ",
            "--camera_path", "turntable", "--video_frames", "2",
            "--cap_images", "1", "--downscale", "0.25"]
    # a flax checkpoint of the port's init params (the same tree as the
    # JAX package's) and a ready grid, written by the JAX package
    init = TR.build_context(TC.parse_args(base + ["--fname", "init",
                                                  "--device", "cpu"]),
                            "video")
    run = tmp_path / "ckpt"
    JCK.save_checkpoint(run, "last", interop.tree_to_numpy(init["params"]),
                        step=0)
    occ = init_occ_state(OccGridConfig(resolution=8, levels=2), 4)
    rng = np.random.default_rng(0)
    occ["binary"] = jnp.asarray(rng.uniform(size=occ["binary"].shape) < 0.6)
    occ["occs"] = jnp.where(occ["binary"], 0.2, 0.0)
    occ["num_updates"] = jnp.asarray(10, jnp.int32)
    occ["ready_after"] = jnp.asarray(1, jnp.int32)
    JCK.save_aux_state(run, "last", "occ", occ)
    ck = ["--checkpoint_path", str(run), "--prefix", "last"]
    # the checkpoint replaces the JAX runner's init params: skip drawing
    # them (eager JAX compiles each init op, ~10 s here)
    host = interop.tree_to_numpy(init["params"])
    monkeypatch.setattr(JR, "init_container_params",
                        lambda key, cfg: jax.tree_util.tree_map(
                            jnp.asarray, host))

    jctx = JR.build_context(JC.parse_args(base + ck + ["--fname", "j"]),
                            "video")
    want, want_layout = _frames(JR.video(jctx))
    tctx = TR.main(base + ck + ["--fname", "t", "--device", "cpu"])
    got, got_layout = _frames(tctx["video_path"])
    assert "occ_state" in tctx and tctx["video_path"].parent == Path(
        tctx["run_dir"])
    md = tctx["test_metadata"][0]
    assert [f.shape for f in got] == [(md.H, md.W, 3)] * 2
    assert got_layout == want_layout
    _u8_close(got, want)
    assert any(len(np.unique(f)) > 1 for f in got)
