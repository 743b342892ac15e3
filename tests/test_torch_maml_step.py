"""Port parity of second-order MAML's outer step: two steps of
`make_train_step(MetaConfig(algo="maml"))` with bench.py's optimizer
(Adam per group, decay, clip 1.0; one task padded out) against the JAX
package's. The MAML step against the FoMAML step is in
tests/test_torch_maml_fomaml.py (the port alone).

The setup is tests/test_torch_train.py's (`_setup(seed=1)`: K=2 planes
experts, L=2 base 8 F=4, hidden 16, the light backward; soft importance
occupancy R=16 L=2; B=2 tasks of 64 support and 32 query rays, 2 inner
steps, 8 samples, randomized=False). JAX runs with jit disabled; its two
MAML steps (eager second-order autodiff through the inner loops of 2
tasks x 2 experts) are computed once for the module. Nearly all of their
time is eager JAX compiling each new primitive signature once (about
1,700 in the first step); the second step reuses them and takes about a
tenth of the first.

Tolerances: losses 1e-5 relative, gradients 1e-4 of each leaf's max (as
tests/test_torch_maml.py), the updated params 1e-5 (Adam moves each
weight by about lr * sign(g)).

One more outer step runs under both precision options (--use_amp:
bfloat16 MLPs; bfloat16 line matmuls: kernels 1b, 5b and 5''b) from the
same `_setup(seed=1)` shapes, so that the worker's eager JAX has already
compiled the encoder, compositor and sampler primitives and only the
bfloat16 ones are new. JAX on the CPU runs its line matmuls in float32,
so its `_linear_rows_mm` is replaced in this process by the TPU's
arithmetic with a straight-through table rounding
(tests/test_torch_lines_bf16.py `_mm_oracle`). Eager JAX on the CPU also
sums a bias's bfloat16 cotangent over the points in bfloat16 (its
bfloat16 add transposes to a bfloat16 `reduce_sum`), where PyTorch sums
in float32 and rounds once; MAML carries that sum through the inner
updates into every leaf (up to 6.7e-3 of a bias leaf's max, 2.4e-4 of a
weight's). So the JAX side adds its biases in `_bias_add` (the same
values, bit for bit: checked) and its MLPs and heads sum the bias
cotangents in float32, as PyTorch and the TPU do. Tolerances: metrics
1e-5 relative (measured equal), the gradients handed to Adam 1e-3 of
each leaf's max (measured <= 2.4e-4 on a weight, one bfloat16 rounding
of its product's float32 sum taken the other way; 4.1e-5 on the tables,
2.7e-7 on the biases; the same step with float32 line matmuls misses
the tables by 2.3e-2-5.9e-2: checked), grad_norm 1e-5 relative
(measured equal), the updated params 1e-4 (measured 6.0e-6).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerfsys_tpu.models import container as JCo
from nerfsys_tpu.models import ngp as JN
from nerfsys_tpu.ops import planes as JP
from nerfsys_tpu.pipelines.offline import meta_train_step as JS
from nerfsys_tpu.utils import optim as JO
from nerfsys_tpu_torch.models import container as TCo
from nerfsys_tpu_torch.pipelines.offline import meta_train_step as TS
from nerfsys_tpu_torch.utils import interop
from nerfsys_tpu_torch.utils import optim as TO
from nerfsys_tpu_torch.utils.tree import tree_leaves
from test_torch_lines_bf16 import _mm_oracle
from test_torch_train import (
    _close_rel,
    _meta,
    _metrics_close,
    _Recording,
    _setup,
    _sides,
)
from test_torch_threads import one_intra_op_thread  # noqa: F401,E402 (autouse)

GRAD_TOL = 1e-4  # of each leaf's max


@pytest.fixture(scope="module")
def step_pair():
    """Two MAML outer steps with bench.py's optimizer on both sides (one
    task padded out)."""
    cfg, params, statics, occ, batch = _setup(seed=1)
    batch["valid"][1, 1] = 0.0
    jmeta = _meta(algo="maml")
    jcfg = JO.OptimConfig(outer_steps=100)
    tx = _Recording(JO.build_optimizer(jcfg, JCo.param_group_labels(params)))
    opt = _Recording(TO.build_optimizer(interop.optim_config_from_jax(jcfg),
                                        TCo.param_group_labels(params)))
    (jp, jst, jocc, jb), (tcfg, tp, tst, tocc, tb) = _sides(
        cfg, params, statics, occ, batch)
    jstep = JS.make_train_step(jmeta, cfg, tx)
    tmeta = interop.meta_config_from_jax(jmeta)
    assert tmeta.algo == "maml" and not tmeta.first_order
    tstep = TS.make_train_step(tmeta, tcfg, opt)
    js, ts = tx.init(jp), opt.init(tp)
    steps = []
    for _ in range(2):
        with jax.disable_jit():
            jp, js, jm = jstep(jp, js, jst, jb, jax.random.PRNGKey(0), jocc)
        tp, ts, tm = tstep(tp, ts, tst, tb, torch.Generator(), tocc)
        steps.append((jm, tm, jp, tp))
    return steps, tx.grads, opt.grads, ts


@pytest.mark.parametrize("i", [0, 1])
def test_maml_steps_match_jax(step_pair, i):
    """Each of two outer steps: metrics, the gradients handed to Adam,
    the updated params."""
    steps, jgrads, tgrads, ts = step_pair
    jm, tm, jp, tp = steps[i]
    _metrics_close(tm, jm)
    np.testing.assert_allclose(float(tm["grad_norm"]),
                               float(jm["grad_norm"]), rtol=1e-4)
    assert float(tm["skipped_nonfinite"]) == 0.0
    _close_rel(tgrads[i], jgrads[i], GRAD_TOL)
    assert all(float(g.abs().max()) > 0 for g in tree_leaves(tgrads[i]))
    for a, b in zip(tree_leaves(tp), jax.tree_util.tree_leaves(jp)):
        assert float(np.abs(a.numpy() - np.asarray(b)).max()) <= 1e-5
    assert {int(c) for c in ts["count"].values()} == {2}



def _options(cfg, lines_dtype="bfloat16"):
    """--use_amp and --plane_lines_mm --plane_lines_mm_dtype bfloat16."""
    return dataclasses.replace(cfg, expert=dataclasses.replace(
        cfg.expert, use_bf16=True, planes=dataclasses.replace(
            cfg.expert.planes, lines_matmul=True,
            lines_mm_dtype=lines_dtype)))


def _bias_add(y, b):
    """y + b for bfloat16 y and b: their float32 sum rounded once, the
    bfloat16 add's value, with b's cotangent summed over the points in
    float32 before it is rounded to bfloat16."""
    return (y.astype(jnp.float32) + b.astype(jnp.float32)).astype(y.dtype)


def _mlp_f32_sums(x, layers, activate_last=False, dtype=None):
    """`nerfsys_tpu.models.ngp._mlp` under bfloat16 with `_bias_add`."""
    x = x.astype(dtype)
    for i, lyr in enumerate(layers):
        x = _bias_add(x @ lyr["w"].astype(dtype), lyr["b"].astype(dtype))
        if activate_last or i < len(layers) - 1:
            x = jax.nn.relu(x)
    return x


def _density_f32_sums(params, cfg, aabb, x, return_feats=False):
    """`nerfsys_tpu.models.ngp.ngp_density` for planes experts under
    bfloat16 MLPs, its two heads added with `_bias_add`."""
    assert cfg.use_bf16 and cfg.xyz_encoding == "planes"
    h = JN.plane_encode(params["planes_enc"],
                        JN.world_to_unit(x, aabb, cfg.enc_eps), cfg.planes)
    h = _mlp_f32_sums(h, params["sigma_trunk"], True, jnp.bfloat16)
    sigma_raw, geo = (_bias_add(
        h @ params[k]["w"].astype(jnp.bfloat16),
        params[k]["b"].astype(jnp.bfloat16)).astype(jnp.float32)
        for k in ("sigma_head", "geo_head"))
    sigma = JN.trunc_exp(sigma_raw[..., 0])
    return (sigma, geo) if return_feats else sigma


def _f32_bias_sums(mp):
    """Patch the JAX package's expert field to `_mlp_f32_sums` /
    `_density_f32_sums` for the context of `mp`."""
    mp.setattr(JN, "_mlp", _mlp_f32_sums)
    mp.setattr(JN, "ngp_density", _density_f32_sums)
    mp.setattr(JCo, "ngp_density", _density_f32_sums)


@pytest.fixture(scope="module")
def step_options(step_pair):
    """One MAML outer step under both precision options, bench.py's
    optimizer, one task padded out; after `step_pair`, whose eager
    primitives it reuses. Also the port's same step with float32 line
    matmuls (the control) and the JAX expert field's values with and
    without the float32 bias sums."""
    cfg, params, statics, occ, batch = _setup(seed=1)
    batch["valid"][1, 1] = 0.0
    jmeta = _meta(algo="maml")
    jcfg = JO.OptimConfig(outer_steps=100)
    tx = _Recording(JO.build_optimizer(jcfg, JCo.param_group_labels(params)))
    (jp, jst, jocc, jb), _ = _sides(_options(cfg), params, statics, occ,
                                    batch)
    jstep = JS.make_train_step(jmeta, _options(cfg), tx)
    ek = jax.tree_util.tree_map(lambda a: a[0], jp["experts"])
    pts = jnp.asarray(np.random.default_rng(5).uniform(
        -1.3, 1.3, (300, 3)).astype(np.float32))
    field = (ek, _options(cfg).expert, jst.expert_aabbs[0], pts, pts[::-1])
    with pytest.MonkeyPatch.context() as mp, jax.disable_jit():
        mp.setattr(JP, "_linear_rows_mm", _mm_oracle(straight=True))
        values = [JN.ngp_apply(*field)]
        _f32_bias_sums(mp)
        values.append(JN.ngp_apply(*field))
        jp, _, jm = jstep(jp, tx.init(jp), jst, jb, jax.random.PRNGKey(0),
                          jocc)
    ports = []
    for lines_dtype in ("bfloat16", "float32"):
        opt = _Recording(TO.build_optimizer(
            interop.optim_config_from_jax(jcfg),
            TCo.param_group_labels(params)))
        _, (tcfg, tp, tst, tocc, tb) = _sides(
            _options(cfg, lines_dtype), params, statics, occ, batch)
        assert tcfg.expert.use_bf16
        assert tcfg.expert.planes.lines_bf16 == (lines_dtype == "bfloat16")
        tstep = TS.make_train_step(interop.meta_config_from_jax(jmeta),
                                   tcfg, opt)
        tp, _, tm = tstep(tp, opt.init(tp), tst, tb, torch.Generator(), tocc)
        ports.append((tm, tp, opt.grads[0]))
    return jm, jp, tx.grads[0], ports, values


def test_maml_step_with_precision_options_matches_jax(step_options):
    """The MAML step with bfloat16 MLPs and bfloat16 line matmuls: metrics
    and grad_norm within 1e-5 relative, the gradients handed to Adam
    within 1e-3 of each leaf's max, the updated params within 1e-4 (the
    module docstring has the measured values)."""
    jm, jp, jg, ((tm, tp, tg), _), _ = step_options
    _metrics_close(tm, jm)
    assert float(tm["skipped_nonfinite"]) == 0.0
    np.testing.assert_allclose(float(tm["grad_norm"]),
                               float(jm["grad_norm"]), rtol=1e-5)
    _close_rel(tg, jg, 1e-3)
    assert all(float(g.abs().max()) > 0 for g in tree_leaves(tg))
    for a, b in zip(tree_leaves(tp), jax.tree_util.tree_leaves(jp)):
        assert float(np.abs(a.numpy() - np.asarray(b)).max()) <= 1e-4


def test_maml_step_oracle_pins_the_line_dtype(step_options):
    """The control: the port's step with float32 line matmuls (kernels 1,
    5, 5'' in place of 1b, 5b, 5''b) misses the tables' gradients by more
    than 10x that tolerance; and the float32 bias sums change no value of
    the JAX field (rgb and sigma bit for bit)."""
    _, _, jg, (_, (_, _, tg32)), values = step_options
    tables = jg["experts"]["planes_enc"]
    gaps = [float(np.abs(g.numpy() - np.asarray(w)).max())
            / float(np.abs(np.asarray(w)).max())
            for g, w in zip(tree_leaves(tg32["experts"]["planes_enc"]),
                            jax.tree_util.tree_leaves(tables))]
    assert min(gaps) > 1e-2, gaps
    for a, b in zip(*values):
        assert a.dtype == b.dtype and bool(jnp.array_equal(a, b))
