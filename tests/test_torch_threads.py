"""One intra-op PyTorch thread for the port's CPU parity tests.

`one_intra_op_thread` is a module-scoped autouse fixture: every
tests/test_torch_*.py file imports it, runs with torch.set_num_threads(1)
and gets the count back after its last test. The port's CPU tensors at
test sizes are small, and under ROADMAP.md's tier-1 command (6 workers
on 8 cores) PyTorch's pool of a thread a core spends more in its
parallel regions than in the work. Measured on an 8-core x86_64 host:
tests/test_torch_early_stop.py took 151 s on one thread against 215 s
with the pool (6 such processes at once), and the tier-1 command 783 s
against 1,307 s.
"""
import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_the_module_runs_on_one_intra_op_thread():
    assert torch.get_num_threads() == 1
