"""The group step loop's draw block (``kernels/draws.py``,
``csrc/threefry_draws_sm90.cu``).

On the CPU: the dispatch's plain version against the composition of
``prng`` calls the step loop made before, a numpy model of the kernel's
rows and words (uint32 arithmetic, one row a (cell, step)) against it, the
build entry, and the counters ``simulate_scenario`` reports.

On the card (``-m cuda``; each test skips without a CUDA device): the
kernel against the plain version, ``torch.equal`` on every output, at
pig25.montecarlo's block, at blocks of several steps, with leased reads, at
a WAN-sized F and under keys with the high bit of each word set; its
exponential transform over every value a uniform can take against torch's
own; its launch count and its refusals.  This file imports no JAX:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_draws_sm90.py
"""
import numpy as np
import pytest
import torch

from repro_torch import prng
from repro_torch.core import vectorsim as vs
from repro_torch.core.pig import PigConfig
from repro_torch.kernels import build, draws, ops, ref

torch.set_num_threads(1)

M32 = 0xFFFFFFFF


def _keys(C, seed, high=False, device="cpu"):
    """(C, 2) int64 keys: the grid's own (``_stack_cells``: PRNGKey(seed x
    1_000_003 + cell)), or uniform over all of uint32 with ``high``."""
    if high:
        k = np.random.default_rng(seed).integers(0, 2**32, (C, 2))
        k[0] = M32                  # every bit of both words
        k[1] = (1 << 31, 1 << 31)
    else:
        s = seed * 1_000_003 + np.arange(C, dtype=np.int64)
        k = np.stack([(s >> 32) & M32, s & M32], -1)
    return torch.tensor(k, dtype=torch.int64, device=device)


def _composition(key, i0, n, B, n_draw, G, read):
    """The step loop's draw block as it was written before the kernel."""
    idx = torch.arange(i0, i0 + n, device=key.device)
    ks = prng.split(prng.fold_in(key[:, None, :], idx))
    e = prng.exponential(ks[:, :, 0], (B, n_draw))
    u = prng.uniform(ks[:, :, 1], (B, G))
    r = (prng.uniform(prng.fold_in(ks[:, :, 1], 1), (B,)) if read
         else None)
    return e, u, r


def _same(got, want):
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        if w is None:
            assert g is None
        else:
            assert g.dtype == w.dtype == torch.float32
            assert g.shape == w.shape and g.is_contiguous()
            assert torch.equal(g, w)


# (i0, n, B, G, F, read): the cell's shape (F 24, G 3, B 8), a block of
# several steps past step 0, leased reads, Paxos at N = 9, a WAN-sized F
BLOCKS = [(0, 1, 8, 3, 24, False), (37, 11, 8, 3, 24, False),
          (5, 4, 8, 3, 24, True), (0, 3, 4, 8, 8, True),
          (2, 2, 8, 32, 1024, False)]


@pytest.mark.parametrize("i0,n,B,G,F,read", BLOCKS)
def test_cpu_entry_equals_the_prng_composition(i0, n, B, G, F, read):
    key = _keys(3, 11)
    n_draw = 2 + 2 * G + 2 * F
    want = _composition(key, i0, n, B, n_draw, G, read)
    _same(ops.group_draws(key, i0, n, B, n_draw, G, read=read), want)
    _same(ref.group_draws_ref(key, i0, n, B, n_draw, G, read), want)


# ------------------------------------------------ the kernel, in numpy
def _threefry_np(k0, k1, x0, x1):
    """The kernel's unrolled Threefry-2x32 on uint32 numpy arrays."""
    rotl = lambda x, r: (x << np.uint32(r)) | (x >> np.uint32(32 - r))
    k2 = k0 ^ k1 ^ np.uint32(0x1BD11BDA)
    x0, x1 = x0 + k0, x1 + k1
    inject = ((k1, k2), (k2, k0), (k0, k1), (k1, k2), (k2, k0))
    for i, (a, b) in enumerate(inject):
        for r in ((13, 15, 26, 6), (17, 29, 16, 24))[i % 2]:
            x0 = x0 + x1
            x1 = rotl(x1, r) ^ x0
        x0, x1 = x0 + a, x1 + b + np.uint32(i + 1)
    return x0, x1


def _uniform_np(b):
    f = ((b >> np.uint32(9)) | np.uint32(0x3F800000)).view(np.float32)
    return np.maximum(f - np.float32(1.0), np.float32(0.0))


def _kernel_model(key, i0, n, e_words, u_words, r_words):
    """What the kernel writes, row by row: row = c x n + j takes cell c's
    key and step i0 + j, derives fold_in, split and (reads) fold_in(k2, 1)
    by three threefry calls, and its words w are the bits of counter
    (0, w).  Returns the uniforms behind e, and u and r, each (rows,
    words)."""
    k = key.numpy().astype(np.uint32)
    C = k.shape[0]
    rows = np.arange(C * n)
    c = rows // n
    step = (i0 + rows - c * n).astype(np.uint32)
    zero = np.zeros(C * n, np.uint32)
    f = _threefry_np(k[c, 0], k[c, 1], zero, step)
    k1 = _threefry_np(*f, zero, zero)
    k2 = _threefry_np(*f, zero, zero + np.uint32(1))
    kr = _threefry_np(*k2, zero, zero + np.uint32(1))

    def words(kk, count):
        w = np.arange(count, dtype=np.uint32)[None, :]
        x0, x1 = _threefry_np(kk[0][:, None], kk[1][:, None],
                              np.zeros_like(w), w)
        return _uniform_np(x0 ^ x1)
    return words(k1, e_words), words(k2, u_words), words(kr, r_words)


@pytest.mark.parametrize("i0,n,B,G,F,read", BLOCKS[:4])
def test_the_kernel_s_rows_and_words_give_the_plain_draws(i0, n, B, G, F,
                                                          read):
    key = _keys(4, 3, high=True)
    n_draw = 2 + 2 * G + 2 * F
    e, u, r = ref.group_draws_ref(key, i0, n, B, n_draw, G, read)
    ue, uu, ur = _kernel_model(key, i0, n, B * n_draw, B * G, B)
    C = key.shape[0]
    model_e = -torch.log1p(-torch.from_numpy(ue).double())
    assert torch.equal(e, model_e.float().reshape(C, n, B, n_draw))
    assert torch.equal(u, torch.from_numpy(uu).reshape(C, n, B, G))
    if read:
        assert torch.equal(r, torch.from_numpy(ur).reshape(C, n, B))


def test_other_devices_are_refused():
    key = torch.empty(4, 2, dtype=torch.int64, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        ops.group_draws(key, 0, 1, 8, 56, 3)


def test_the_build_names_the_kernel_and_builds_it_with_the_fanin(
        monkeypatch):
    assert "threefry_draws_sm90" in build.KERNEL_FLAGS
    assert (build.CSRC / "threefry_draws_sm90.cu").is_file()
    assert "arch=compute_90a,code=sm_90a" in build.flags(
        "threefry_draws_sm90")
    path = build.library_path("threefry_draws_sm90")
    assert path.parent == build.BUILD_DIR
    assert path.name.startswith("libthreefry_draws_sm90-")
    # loading either library of the group loop builds both in one call
    calls, loaded = [], []
    monkeypatch.setattr(build, "build_all",
                        lambda names: calls.append(tuple(names)) or
                        [build.BUILD_DIR / f"{n}.so" for n in names])
    monkeypatch.setattr(build.ctypes, "CDLL", loaded.append)
    build.load("threefry_draws_sm90")
    build.load("seg_fanin_sm90")
    build.load("pig_aggregate")
    pair = ("seg_fanin_sm90", "threefry_draws_sm90")
    assert calls == [pair, pair, ("pig_aggregate",)]
    assert loaded == [str(build.BUILD_DIR / f"{n}.so") for n in
                      ("threefry_draws_sm90", "seg_fanin_sm90",
                       "pig_aggregate")]


@pytest.mark.parametrize("protocol,kw", [
    ("pigpaxos", dict(pig=PigConfig(n_groups=3), clients=(20, 60))),
    ("paxos", dict(clients=(8,))),
    ("epaxos", dict(clients=(10,)))])
def test_cpu_runs_report_no_draw_launches(protocol, kw):
    info = {}
    vs.simulate_scenario(protocol, 25, duration=0.03, warmup=0.02,
                         seeds=(1, 2), device="cpu", info=info, **kw)
    assert info["draw_launches"] == 0
    assert 1 <= info["draw_blocks"] <= info["scan_steps"]


def test_the_step_loop_s_draws_are_the_prng_composition(monkeypatch):
    """The step loop draws through ``ops.group_draws`` with the block it
    computed before, and gets back the composition's draws."""
    seen = []
    real = ops.group_draws

    def spy(key, i0, n, B, n_draw, G, read=False, plain=False):
        out = real(key, i0, n, B, n_draw, G, read=read, plain=plain)
        _same(out, _composition(key, i0, n, B, n_draw, G, read))
        seen.append((i0, n))
        return out
    monkeypatch.setattr(ops, "group_draws", spy)
    info = {}
    vs.simulate_scenario("pigpaxos", 25, pig=PigConfig(n_groups=3),
                         clients=(20,), seeds=(3,), duration=0.03,
                         warmup=0.02, device="cpu", info=info)
    assert len(seen) == info["draw_blocks"] >= 1
    assert seen[0][0] == 0
    for (a, n), (b, _) in zip(seen, seen[1:]):
        assert b == a + n


# ------------------------------------------------------------ on the card
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (chip_smoke.py runs the kernel "
                    "there)")
    return torch.device("cuda")


def _kernel_vs_plain(cuda, C, i0, n, B, G, F, read, high=False, seed=5):
    key = _keys(C, seed, high=high, device=cuda)
    n_draw = 2 + 2 * G + 2 * F
    before = draws.launches_sm90
    got = ops.group_draws(key, i0, n, B, n_draw, G, read=read)
    torch.cuda.synchronize()
    assert draws.launches_sm90 == before + 1
    _same(got, _composition(key, i0, n, B, n_draw, G, read))


@pytest.mark.cuda
def test_card_the_cell_s_block(cuda):
    """pig25.montecarlo's block: 24,576 cells, one step, B 8, G 3, F 24."""
    _kernel_vs_plain(cuda, 24_576, 0, 1, 8, 3, 24, False, seed=2**31 + 7)
    _kernel_vs_plain(cuda, 24_576, 738, 1, 8, 3, 24, False, seed=91)


@pytest.mark.cuda
@pytest.mark.parametrize("i0,n,read", [(37, 11, False), (1, 64, False),
                                       (5, 7, True), (0, 3, True)])
def test_card_blocks_of_several_steps(cuda, i0, n, read):
    _kernel_vs_plain(cuda, 48, i0, n, 8, 3, 24, read)


@pytest.mark.cuda
def test_card_a_wan_sized_fan_out(cuda):
    """F 1,024 (N = 1025 at R = 32): 2,114 exponential words a burst row."""
    _kernel_vs_plain(cuda, 96, 4, 3, 8, 32, 1024, True)


@pytest.mark.cuda
@pytest.mark.parametrize("i0", [0, 2**31 - 40])
def test_card_keys_with_the_high_words_set(cuda, i0):
    _kernel_vs_plain(cuda, 512, i0, 9, 8, 3, 24, True, high=True)


@pytest.mark.cuda
def test_card_exponential_of_every_uniform(cuda):
    """All 2**23 values a uniform takes (m x 2**-23), through the kernel's
    transform and through torch's float64 log1p on the card: zero
    differing bits."""
    u = torch.arange(2**23, dtype=torch.float32, device=cuda) * 2.0**-23
    got = draws.exponential_of(u)
    want = (-torch.log1p(-u.double())).float()
    torch.cuda.synchronize()
    differ = (got.view(torch.int32) != want.view(torch.int32)).sum()
    assert int(differ) == 0


@pytest.mark.cuda
def test_card_launches_one_a_block_in_the_group_loop(cuda):
    kw = dict(pig=PigConfig(n_groups=3), clients=(20, 60), seeds=(1, 2),
              duration=0.03, warmup=0.02)
    info, plain = {}, {}
    got = vs.simulate_scenario("pigpaxos", 25, device=cuda, info=info, **kw)
    want = vs.simulate_scenario("pigpaxos", 25, device=cuda, kernel="torch",
                                info=plain, **kw)
    assert got == want
    assert info["draw_launches"] == info["draw_blocks"] >= 1
    assert plain["draw_launches"] == 0
    assert plain["draw_blocks"] == info["draw_blocks"]


@pytest.mark.cuda
def test_card_refuses_what_the_kernel_does_not_take(cuda):
    key = _keys(8, 1, device=cuda)
    with pytest.raises(TypeError, match="int64"):
        ops.group_draws(key.to(torch.int32), 0, 1, 8, 56, 3)
    with pytest.raises(ValueError, match="not contiguous"):
        ops.group_draws(key.t().contiguous().t(), 0, 1, 8, 56, 3)
    with pytest.raises(ValueError, match="shape"):
        ops.group_draws(key[:, :1], 0, 1, 8, 56, 3)
    with pytest.raises(ValueError, match="overflow"):
        ops.group_draws(key, 2**31 - 2, 4, 8, 56, 3)
