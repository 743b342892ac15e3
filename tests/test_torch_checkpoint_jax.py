"""The port reads the JAX package's checkpoints: `.model` params and
auxiliary trees such as `.occ`, which the JAX package writes as flax
msgpack (`save_checkpoint`, `save_aux_state`), here written in the test.

The params come from the JAX package's `init_container_params` at a small
size (K=2 planes experts, 2 plane levels with lines: per-level lists, which
flax writes as index-keyed maps; a learned background), the grids from its
`init_occ_state` filled from a numpy seed. flax's MAX_CHUNK_SIZE is set
small so that every array above 4 KiB is written in chunks. Restored trees
must equal `interop`'s conversion of the same arrays bit for bit, in the
port's template's nesting, dtypes and device. A file that is neither
format, a tree that does not fit the template and a missing `msgpack`
raise; an `.occ` written before `ready_after` existed restores by key.
"""
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from nerfsys_tpu.models import container as JCo
from nerfsys_tpu.models import ngp as JN
from nerfsys_tpu.ops import occupancy as JOC
from nerfsys_tpu.ops.planes import PlaneEncodingConfig
from nerfsys_tpu.utils import checkpoint as JCK
from nerfsys_tpu_torch.models import container as TCo
from nerfsys_tpu_torch.ops import occupancy as TOC
from nerfsys_tpu_torch.utils import checkpoint as TCK
from nerfsys_tpu_torch.utils import interop
from nerfsys_tpu_torch.utils.tree import tree_leaves

K = 2


def _cfg(features=4):
    expert = JN.NGPConfig(
        hidden=16, sigma_depth=2, color_hidden=16, color_depth=2,
        geo_feat_dim=7, xyz_encoding="planes",
        planes=PlaneEncodingConfig(levels=2, base_res=16, growth=2.0,
                                   features=features))
    return JCo.ContainerConfig(num_experts=K, expert=expert, bg_hidden=8)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def jax_params():
    return _np(JCo.init_container_params(jax.random.PRNGKey(3), _cfg()))


def _occ(seed=0, with_ready=True):
    cfg = JOC.OccGridConfig(resolution=16, levels=2)
    occ = _np(JOC.init_occ_state(cfg, K))
    rng = np.random.default_rng(seed)
    occ["occs"] = rng.uniform(-1, 1, occ["occs"].shape).astype(np.float32)
    occ["binary"] = occ["occs"] > 0.2
    occ["num_updates"] = np.asarray(7, np.int32)
    if not with_ready:
        del occ["ready_after"]
    return cfg, occ


def _port_template(features=4):
    return TCo.init_container_params(
        interop.container_config_from_jax(_cfg(features)), seed=1,
        device="cpu")


def _same(got, want):
    g, w = tree_leaves(got), tree_leaves(want)
    assert len(g) == len(w) > 0
    for a, b in zip(g, w):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a, b)


@pytest.mark.parametrize("chunk", [None, 4096])
def test_jax_model_checkpoint_restores_bit_for_bit(jax_params, tmp_path,
                                                   monkeypatch, chunk):
    if chunk is not None:
        monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", chunk)
    JCK.save_checkpoint(tmp_path, "best", jax_params, step=12, best=3.5)
    raw = TCK.load_flax_tree(tmp_path / "best.model")
    chunked = [k for k, v in raw["experts"]["planes_enc"]["planes"].items()
               if isinstance(v, dict)]
    assert chunked == [], "chunked arrays are joined by the reader"
    params, state = TCK.load_model_checkpoint(tmp_path, "best",
                                              _port_template())
    _same(params, interop.container_params_from_jax(jax_params, "cpu"))
    assert isinstance(params["experts"]["planes_enc"]["planes"], list)
    assert state["step"] == 12 and state["best"] == 3.5
    if chunk is not None:  # the file really held chunked arrays
        import msgpack

        top = msgpack.unpackb((tmp_path / "best.model").read_bytes(),
                              ext_hook=lambda c, d: None, raw=False)
        plane = top["experts"]["planes_enc"]["planes"]["1"]
        assert plane["__msgpack_chunked_array__"] is True
        assert len(plane["chunks"]) > 1


def test_jax_occ_state_restores_bit_for_bit(tmp_path):
    cfg, occ = _occ()
    JCK.save_aux_state(tmp_path, "best", "occ", occ)
    tpl = TOC.init_occ_state(interop.occ_grid_config_from_jax(cfg), K,
                             device="cpu")
    got = TCK.load_aux_state(tmp_path, "occ", tpl, tag="best")
    want = interop.occ_state_from_jax(occ, "cpu")
    assert set(got) == set(tpl) == set(want)
    for k in tpl:
        assert got[k].dtype == tpl[k].dtype and torch.equal(got[k], want[k])


def test_old_jax_occ_merges_by_key(tmp_path, capsys):
    """A grid saved before `ready_after` existed: the saved leaves are
    read, the missing one keeps the template's value."""
    cfg, occ = _occ(seed=1, with_ready=False)
    JCK.save_aux_state(tmp_path, "last", "occ", occ)
    tpl = TOC.init_occ_state(interop.occ_grid_config_from_jax(cfg), K,
                             device="cpu")
    got = TCK.load_aux_state(tmp_path, "occ", tpl)
    assert "merged by key" in capsys.readouterr().out
    want = interop.occ_state_from_jax(occ, "cpu")
    for k in ("occs", "binary", "num_updates"):
        assert torch.equal(got[k], want[k])
    assert torch.equal(got["ready_after"], tpl["ready_after"])


def test_bfloat16_and_scalar_leaves(tmp_path):
    tree = {"w": jnp.arange(12, dtype=jnp.bfloat16).reshape(3, 4) / 7,
            "n": np.int32(5), "z": np.zeros((0, 3), np.float32),
            "seq": [np.ones(2, np.uint8), np.array([True, False])]}
    JCK.save_aux_state(tmp_path, "best", "aux", _np(tree))
    tpl = {"w": torch.zeros(3, 4, dtype=torch.bfloat16),
           "n": torch.zeros((), dtype=torch.int32),
           "z": torch.zeros(0, 3), "seq": [torch.zeros(2, dtype=torch.uint8),
                                            torch.zeros(2, dtype=torch.bool)]}
    got = TCK.load_aux_state(tmp_path, "aux", tpl, tag="best")
    want = np.asarray(tree["w"]).astype(np.float32)
    assert got["w"].dtype == torch.bfloat16
    np.testing.assert_array_equal(got["w"].float().numpy(), want)
    assert int(got["n"]) == 5 and got["z"].shape == (0, 3)
    assert got["seq"][0].tolist() == [1, 1]
    assert got["seq"][1].tolist() == [True, False]


def test_port_checkpoint_still_reads(jax_params, tmp_path):
    want = interop.container_params_from_jax(jax_params, "cpu")
    TCK.save_checkpoint(tmp_path, "last", want, step=2)
    got, state = TCK.load_model_checkpoint(tmp_path, "last",
                                           _port_template())
    _same(got, want)
    assert state["step"] == 2


@pytest.mark.parametrize("payload", [b"\xc1 not msgpack", b"\x07",
                                     b"\x92\x01\x02"],
                         ids=["garbage", "an_int", "a_list"])
def test_neither_format_raises_naming_the_path(tmp_path, payload):
    (tmp_path / "best.model").write_bytes(payload)
    with pytest.raises(ValueError, match="best.model"):
        TCK.load_model_checkpoint(tmp_path, "best", _port_template())


def test_template_mismatch_raises(jax_params, tmp_path):
    JCK.save_checkpoint(tmp_path, "best", jax_params)
    with pytest.raises(ValueError, match="planes"):
        TCK.load_model_checkpoint(tmp_path, "best",
                                  _port_template(features=8))
    with pytest.raises(ValueError, match="keys"):
        TCK.load_model_checkpoint(tmp_path, "best", {"experts": {}})


def test_missing_msgpack_raises_naming_it(jax_params, tmp_path, monkeypatch):
    JCK.save_checkpoint(tmp_path, "best", jax_params)
    monkeypatch.setitem(sys.modules, "msgpack", None)
    with pytest.raises(ImportError, match="msgpack"):
        TCK.load_model_checkpoint(tmp_path, "best", _port_template())
