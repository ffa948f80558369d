"""Tests of the port that need the card: the hand-written CUDA kernel
against its plain version, the launch wrapper's checks, and a whole run
through the kernel against one through the plain version.  They import no
JAX, so they run on a machine with a GPU and no JAX:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Without a CUDA device each test skips with its reason."""
import numpy as np
import pytest
import torch

from repro_torch.core import vectorsim
from repro_torch.core.pig import PigConfig
from repro_torch.kernels import ops, ref, segfanin

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (chip_smoke.py runs the kernel "
                    "there)")
    return torch.device("cuda")


def _burst(seed, B, G, gsize, device):
    """vectorsim-shaped inputs with ties (a 2**-8 grid) and one masked
    slot per segment."""
    rng = np.random.default_rng(seed)
    F = G * gsize
    vals = 1.0 + np.floor(rng.uniform(0, 256, (B, F))) / 256
    vals[:, rng.integers(0, gsize, G) + np.arange(G) * gsize] = np.inf
    coef = np.repeat(rng.uniform(0.0, 1e-3, (B, G)), gsize, axis=1)
    kcap = np.repeat(rng.integers(0, gsize - 1, G), gsize)
    t = dict(device=device)
    return (torch.tensor(vals, dtype=torch.float32, **t),
            torch.tensor(coef, dtype=torch.float32, **t),
            torch.tensor(np.repeat(np.arange(G), gsize), **t),
            torch.tensor(kcap, **t))


@pytest.mark.parametrize("G,gsize", [(3, 8), (16, 16), (32, 32), (5, 7)])
def test_kernel_matches_plain_version(cuda, G, gsize):
    vals, coef, segid, kcap = _burst(G * gsize, 8, G, gsize, cuda)
    anchor = torch.ones(8, device=cuda)
    before = segfanin.launches
    got = ops.seg_fanin(vals, coef, segid, kcap, -0.5, 3e-4, 2e-5, anchor)
    want = ref.seg_fanin_ref(vals, coef, segid, kcap, -0.5, 3e-4, 2e-5,
                             anchor)
    torch.cuda.synchronize()
    assert segfanin.launches == before + 1
    assert torch.equal(got, want)


def test_wrapper_checks_its_inputs(cuda):
    R, F, C = 16, 24, 2
    ok = dict(vals=torch.ones(R, F, device=cuda),
              coef=torch.zeros(R, F, device=cuda),
              segid=torch.zeros(C, F, dtype=torch.int32, device=cuda),
              kcap=torch.zeros(C, F, dtype=torch.int32, device=cuda),
              scal=torch.ones(R, 4, device=cuda))

    def call(**kw):
        a = dict(ok, **kw)
        return segfanin.seg_fanin_rows(a["vals"], a["coef"], a["segid"],
                                       a["kcap"], a["scal"], 8)
    assert call().shape == (R, F)
    with pytest.raises(TypeError, match="segid"):
        call(segid=ok["segid"].long())
    with pytest.raises(ValueError, match="contiguous"):
        call(coef=torch.zeros(F, R, device=cuda).t())
    with pytest.raises(ValueError, match="shape"):
        call(scal=torch.ones(R, 3, device=cuda))
    with pytest.raises(ValueError, match="on cpu"):
        call(kcap=ok["kcap"].cpu())
    wide = 4096
    with pytest.raises(ValueError, match="shared memory"):
        segfanin.seg_fanin_rows(
            torch.ones(8, wide, device=cuda), torch.zeros(8, wide, device=cuda),
            torch.zeros(1, wide, dtype=torch.int32, device=cuda),
            torch.zeros(1, wide, dtype=torch.int32, device=cuda),
            torch.ones(8, 4, device=cuda), 8)


def test_whole_run_through_the_kernel_equals_the_plain_run(cuda):
    """One launch per scan step, and the same results bit for bit."""
    kw = dict(pig=PigConfig(n_groups=3, prc=1), clients=(10, 20),
              seeds=(0, 1), duration=0.1, warmup=0.05, device=cuda)
    segfanin.launches = 0
    info: dict = {}
    a = vectorsim.simulate_scenario("pigpaxos", 25, info=info, **kw)
    assert segfanin.launches == info["scan_steps"] > 0
    b = vectorsim.simulate_scenario("pigpaxos", 25, kernel="torch", **kw)
    assert a == b
