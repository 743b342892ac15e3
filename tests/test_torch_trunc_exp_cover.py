"""Row 12's kernels (csrc/activations.cu: `trunc_exp_fwd`, `trunc_exp_bwd`,
`trunc_exp_bwd2`): their launch, `ops.activations.act_launch`, which the
wrappers compute and pass to the entry points, and the kernels' index
maps walked in numpy.

The kernels run only on the card (chip_smoke's `edge trunc_exp` lines,
bit-equal to their plain versions); here every point of n is shown to be
taken by exactly one thread on either path: the grid-stride loop of all
three kernels (thread t takes vectors t, t + stride, ...; the n % 4 tail
points by the first threads; scalar points a grid's stride apart without
16-byte alignment), and the forward's exact-cover grid above one trip a
thread (a thread's ACT_VECS vectors b T V + k T + t, the tail by the
thread whose vector is the first past the whole ones; 4 V scalar points a
thread)."""
from __future__ import annotations

import re
from pathlib import Path

import numpy as np
import pytest

from nerfsys_tpu_torch.ops import activations as TA

SMS = 132  # the H100's SMs
T = TA.ACT_THREADS
ONE_WAVE = 4 * 8 * SMS * T  # 1,081,344 points: the last one-trip size
SIZES = [0, 1, 3, 4, 7, 8, 9, 128_000, ONE_WAVE, ONE_WAVE + 1, 8_388_608,
         8_388_611]
SOURCE = (Path(TA.__file__).resolve().parents[1] / "csrc" / "activations.cu")


def _walk(n, vec, cover):
    """How often the launch's (block, thread, trip or k) visit each
    point; the path taken."""
    if n == 0:  # the wrapper returns before any launch
        return np.zeros(0, np.int64), False
    exact, blocks = TA.act_launch(n, SMS, cover=cover)
    b = np.arange(blocks, dtype=np.int64)[:, None, None]
    t = np.arange(T, dtype=np.int64)[None, :, None]
    nv = n >> 2 if vec else 0
    taken = []  # every point a thread takes, once for each time
    if not exact:
        i = (b * T + t).ravel()  # the global thread
        stride = blocks * T
        for trip in range(-(-n // stride) + 1):
            j = i + trip * stride
            whole = j[j < nv]
            taken += [4 * whole + c for c in range(4)]
            q = 4 * nv + j
            taken.append(q[q < n])
        return np.bincount(np.concatenate(taken), minlength=n), exact
    V = TA.ACT_VECS
    if vec:
        k = np.arange(V, dtype=np.int64)[None, None, :]
        j = (b * T * V + k * T + t).ravel()
        whole = j[j < nv]
        taken += [4 * whole + c for c in range(4)]
        tail = j[j == nv]  # the thread that takes the tail
        assert tail.size == (1 if n % 4 else int(nv < blocks * T * V))
        if tail.size:
            taken.append(np.arange(4 * nv, n))
    else:
        k = np.arange(4 * V, dtype=np.int64)[None, None, :]
        q = (4 * b * T * V + k * T + t).ravel()
        taken.append(q[q < n])
    # the entry point refuses a grid that does not span n
    assert blocks * T * V * 4 >= n
    return np.bincount(np.concatenate(taken), minlength=n), exact


@pytest.mark.parametrize("cover", [True, False], ids=["fwd", "bwd"])
@pytest.mark.parametrize("vec", [True, False], ids=["vec", "scalar"])
@pytest.mark.parametrize("n", SIZES)
def test_every_point_taken_once(n, vec, cover):
    count, exact = _walk(n, vec, cover)
    assert (count == 1).all()
    assert exact == (cover and n > ONE_WAVE)


def test_paths_at_the_main_shapes():
    """A bench step's 128,000 points: the grid-stride loop on 125 blocks,
    one trip a thread, for all three kernels; a frame call's 8,388,608:
    the forward's exact-cover grid, 4,096 blocks of two vectors a thread,
    and the loop on 8 blocks an SM for the backward and the second
    derivative (no path launches them at that size); the one-trip bound
    is 8 blocks an SM of 256 threads at a vector each."""
    for cover in (True, False):
        assert TA.act_launch(128_000, SMS, cover) == (False, 125)
        assert TA.act_launch(1, SMS, cover) == (False, 1)
        assert TA.act_launch(ONE_WAVE, SMS, cover) == (False, 8 * SMS)
        assert TA.act_launch(128_000, 0, cover) == TA.act_launch(128_000,
                                                                 132, cover)
    assert TA.act_launch(8_388_608, SMS, cover=True) == (True, 4096)
    assert TA.act_launch(8_388_608, SMS) == (False, 8 * SMS)
    assert TA.act_launch(ONE_WAVE + 1, SMS, cover=True)[0]
    assert not TA.act_launch(ONE_WAVE + 1, SMS)[0]
    # the one-trip grid never strides: its blocks cover every vector
    for n in (4, 128_000, ONE_WAVE):
        _, blocks = TA.act_launch(n, SMS)
        assert blocks * T * 4 >= n


def test_launch_constants_match_the_source():
    """The wrapper sizes the grid with the kernels' block size and the
    exact-cover grid's vectors a thread, which the source defines."""
    text = SOURCE.read_text()
    got = {k: int(v) for k, v in re.findall(
        r"^#define (ACT_THREADS|ACT_VECS) (\d+)", text, re.M)}
    assert got == {"ACT_THREADS": TA.ACT_THREADS, "ACT_VECS": TA.ACT_VECS}
