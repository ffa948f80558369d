"""The EPaxos step loop's draw block (``kernels/draws.py::epaxos_draws``,
the EPaxos entry of ``csrc/threefry_draws_sm90.cu``).

On the CPU: the dispatch's plain version against the composition of
``prng`` calls the step loop made before, a numpy model of the kernel's
rows, warps and words (uint32 arithmetic, 32 rows a warp, the keys of a
row made once and shared by index) against it, the step loop's calls, and
the refusal of other devices.

On the card (``-m cuda``; each test skips without a CUDA device): the
kernel against the plain version, ``torch.equal`` on every output, at
epaxos25.montecarlo's block, at blocks of several steps (a megagrid
chunk's), at odd and even n and under keys with the high bit of each word
set; a whole EPaxos grid with the kernel against one without it; its
launch count and its refusals.  This file imports no JAX:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_epaxos_draws_sm90.py
"""
import numpy as np
import pytest
import torch

from repro_torch import prng
from repro_torch.core import vectorsim as vs
from repro_torch.kernels import draws, ops, ref

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


def _composition(key, i0, b, n):
    """The step loop's draw block as it was written before the kernel."""
    idx = torch.arange(i0, i0 + b, device=key.device)
    ks = prng.split(prng.fold_in(key[:, None, :], idx), 5)
    return (prng.randint(ks[:, :, 0], (), 0, n),
            prng.exponential(ks[:, :, 1], (2,)),
            prng.exponential(ks[:, :, 2], (n,)),
            prng.exponential(ks[:, :, 3], (n,)),
            prng.uniform(ks[:, :, 4], ()))


def _same(got, want):
    assert len(got) == len(want) == 5
    dtypes = (torch.int64,) + (torch.float32,) * 4
    for g, w, dt in zip(got, want, dtypes):
        assert g.dtype == w.dtype == dt
        assert g.shape == w.shape and g.is_contiguous()
        assert torch.equal(g, w)


@pytest.mark.parametrize("high", [False, True])
@pytest.mark.parametrize("b", [1, 9])
@pytest.mark.parametrize("i0", [0, 1, 2**20])
@pytest.mark.parametrize("n", [3, 5, 25, 26])
def test_cpu_entry_equals_the_prng_composition(n, i0, b, high):
    key = _keys(3, 11, high=high)
    want = _composition(key, i0, b, n)
    assert want[0].shape == (3, b) and want[2].shape == (3, b, n)
    _same(ops.epaxos_draws(key, i0, b, n), want)
    _same(ops.epaxos_draws(key, i0, b, n, plain=True), want)
    _same(ref.epaxos_draws_ref(key, i0, b, n), want)


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


def _word_bits_np(k, w):
    x0, x1 = _threefry_np(k[0], k[1], np.zeros_like(w), w)
    return x0 ^ x1


def _uniform_np(bits):
    f = ((bits >> np.uint32(9)) | np.uint32(0x3F800000)).view(np.float32)
    return np.maximum(f - np.float32(1.0), np.float32(0.0))


def _warp_words(k, words, rows):
    """A warp's shared-out words, as the kernel walks them: lane l of the
    warp at row base takes the flat indices l, l + 32, ..., row r and word
    w kept by steps of (32 // words, 32 % words), the keys from row r's
    lane.  Returns the uniforms of the first ``rows`` rows, (rows,
    words)."""
    lanes = k[0].shape[0]
    out = np.full(lanes * words, np.nan, np.float32)
    lane = np.arange(32)
    for base in range(0, lanes, 32):
        r, w = lane // words, (lane % words).astype(np.uint32)
        for it in range(words):
            src = (k[0][base + r], k[1][base + r])
            out[base * words + lane + 32 * it] = _uniform_np(
                _word_bits_np(src, w))
            r, w = r + 32 // words, w + np.uint32(32 % words)
            wrap = w >= words
            w = np.where(wrap, w - np.uint32(words), w).astype(np.uint32)
            r = np.where(wrap, r + 1, r)
    return out[:rows * words].reshape(rows, words)


def _kernel_model(key, i0, b, n):
    """What the kernel writes: every lane of the ragged last warp holds a
    row (key 0 past the end); row = c x b + j takes cell c's key and step
    i0 + j, derives fold_in, the 5-way split and randint's split by 8
    threefry calls; randint's arithmetic in wrapping uint32.  Returns
    coord (rows,) and the uniforms behind ecl, eout and eback, and ukey."""
    k = key.numpy().astype(np.uint32)
    rows = key.shape[0] * b
    lanes = -(-rows // 32) * 32
    row = np.arange(lanes)
    valid = row < rows
    c = np.where(valid, row // b, 0)
    zero = np.zeros(lanes, np.uint32)
    step = np.where(valid, i0 + row - c * b, 0).astype(np.uint32)
    f = _threefry_np(np.where(valid, k[c, 0], 0).astype(np.uint32),
                     np.where(valid, k[c, 1], 0).astype(np.uint32),
                     zero, step)
    ks = [_threefry_np(*f, zero, zero + np.uint32(j)) for j in range(5)]
    ka = _threefry_np(*ks[0], zero, zero)
    kb = _threefry_np(*ks[0], zero, zero + np.uint32(1))
    hi, lo = _word_bits_np(ka, zero), _word_bits_np(kb, zero)
    span = np.full(lanes, max(n, 1), np.uint32)
    m = np.uint32(65536) % span
    mult = (m * m) % span                     # wraps to 0 above 2**16
    off = (hi % span) * mult + lo % span
    coord = (off % span).astype(np.int64)[:rows]
    ukey = _uniform_np(_word_bits_np(ks[4], zero))[:rows]
    return (coord, _warp_words(ks[1], 2, rows), _warp_words(ks[2], n, rows),
            _warp_words(ks[3], n, rows), ukey)


@pytest.mark.parametrize("C,i0,b,n", [
    (4, 0, 1, 25), (37, 5, 1, 25), (3, 2**20, 9, 3), (4, 1, 9, 26),
    (5, 0, 9, 5), (7, 3, 4, 1), (2, 11, 3, 40), (33, 2**31 - 40, 2, 17)])
def test_the_kernel_s_rows_warps_and_words_give_the_plain_draws(C, i0, b,
                                                                n):
    key = _keys(C, 3, high=True)
    want = ref.epaxos_draws_ref(key, i0, b, n)
    coord, uecl, ueout, ueback, ukey = _kernel_model(key, i0, b, n)
    exp = lambda u, *shape: (-torch.log1p(-torch.from_numpy(u).double())
                             ).float().reshape(C, b, *shape)
    assert not np.isnan(uecl).any() and not np.isnan(ueout).any()
    assert torch.equal(want[0], torch.from_numpy(coord).reshape(C, b))
    assert torch.equal(want[1], exp(uecl, 2))
    assert torch.equal(want[2], exp(ueout, n))
    assert torch.equal(want[3], exp(ueback, n))
    assert torch.equal(want[4], torch.from_numpy(ukey).reshape(C, b))


def test_other_devices_are_refused():
    key = torch.empty(4, 2, dtype=torch.int64, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        ops.epaxos_draws(key, 0, 1, 25)


@pytest.mark.parametrize("seeds,elems", [((3,), None),
                                         ((1, 2, 3), 3 * 55 * 7)])
def test_the_step_loop_s_draws_are_the_prng_composition(monkeypatch, seeds,
                                                        elems):
    """The EPaxos loop draws through ``ops.epaxos_draws`` with the block it
    computed before (``_DRAW_BLOCK_ELEMS // (C x (2n + 5))`` steps: the
    whole run, or 7 steps with ``elems``), and gets back the composition's
    draws; the cells are the same with and without the spy."""
    seen = []
    real = ops.epaxos_draws

    def spy(key, i0, b, n, plain=False):
        out = real(key, i0, b, n, plain=plain)
        _same(out, _composition(key, i0, b, n))
        seen.append((key.shape[0], i0, b, n))
        return out
    kw = dict(clients=(10,), seeds=seeds, duration=0.03, warmup=0.02,
              device="cpu")
    want = vs.simulate_scenario("epaxos", 25, **kw)
    if elems is not None:
        monkeypatch.setattr(vs, "_DRAW_BLOCK_ELEMS", elems)
    monkeypatch.setattr(ops, "epaxos_draws", spy)
    info = {}
    got = vs.simulate_scenario("epaxos", 25, info=info, **kw)
    assert got == want
    assert len(seen) == info["draw_blocks"] >= 1
    assert info["draw_launches"] == 0
    C, steps = len(seeds), info["scan_steps"]
    blk = max(1, min(steps, vs._DRAW_BLOCK_ELEMS // (C * (2 * 25 + 5))))
    assert blk == (7 if elems else steps)
    assert seen[0][1] == 0 and all(s[0] == C and s[3] == 25 for s in seen)
    assert [s[2] for s in seen] == [min(blk, steps - s[1]) for s in seen]
    for (_, a, m, _), (_, c, _, _) in zip(seen, seen[1:]):
        assert c == a + m
    assert seen[-1][1] + seen[-1][2] == steps


# ------------------------------------------------------------ on the card
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (chip_smoke.py runs the kernel "
                    "there)")
    return torch.device("cuda")


def _kernel_vs_plain(cuda, C, i0, b, n, high=False, seed=5):
    key = _keys(C, seed, high=high, device=cuda)
    before = draws.launches_sm90
    got = ops.epaxos_draws(key, i0, b, n)
    torch.cuda.synchronize()
    assert draws.launches_sm90 == before + 1
    _same(got, _composition(key, i0, b, n))
    _same(got, ref.epaxos_draws_ref(key, i0, b, n))


@pytest.mark.cuda
def test_card_the_cell_s_block(cuda):
    """epaxos25.montecarlo's block: 393,216 cells, one step, n 25."""
    _kernel_vs_plain(cuda, 393_216, 0, 1, 25, seed=2**31 + 7)
    _kernel_vs_plain(cuda, 393_216, 848, 1, 25, seed=91)


@pytest.mark.cuda
@pytest.mark.parametrize("i0,n", [(0, 17), (9, 25), (37, 26), (4, 3)])
def test_card_blocks_of_several_steps(cuda, i0, n):
    """A megagrid chunk's block: 4,096 cells, 9 steps."""
    _kernel_vs_plain(cuda, 4_096, i0, 9, n)


@pytest.mark.cuda
@pytest.mark.parametrize("C,b,n", [(33, 3, 1), (45, 7, 40), (1, 1, 25)])
def test_card_ragged_warps(cuda, C, b, n):
    """Rows that leave the last warp part-filled, n of 1 and above 32."""
    _kernel_vs_plain(cuda, C, 2, b, n)


@pytest.mark.cuda
@pytest.mark.parametrize("i0,n", [(0, 25), (2**31 - 40, 26)])
def test_card_keys_with_the_high_words_set(cuda, i0, n):
    _kernel_vs_plain(cuda, 512, i0, 9, n, high=True)


@pytest.mark.cuda
def test_card_launches_one_a_block_in_the_epaxos_loop(cuda):
    """A whole EPaxos grid with the kernel equals one without it, field for
    field; the kernel launches once a draw block."""
    kw = dict(clients=(10, 40), seeds=(1, 2), duration=0.05, warmup=0.02)
    info, plain = {}, {}
    got = vs.simulate_scenario("epaxos", 25, device=cuda, info=info, **kw)
    want = vs.simulate_scenario("epaxos", 25, device=cuda, kernel="torch",
                                info=plain, **kw)
    assert got == want
    assert info["draw_launches"] == info["draw_blocks"] >= 1
    assert plain["draw_launches"] == 0
    assert plain["draw_blocks"] == info["draw_blocks"]


@pytest.mark.cuda
def test_card_refuses_what_the_kernel_does_not_take(cuda):
    key = _keys(8, 1, device=cuda)
    with pytest.raises(TypeError, match="int64"):
        ops.epaxos_draws(key.to(torch.int32), 0, 1, 25)
    with pytest.raises(ValueError, match="not contiguous"):
        ops.epaxos_draws(key.t().contiguous().t(), 0, 1, 25)
    with pytest.raises(ValueError, match="shape"):
        ops.epaxos_draws(key[:, :1], 0, 1, 25)
    with pytest.raises(ValueError, match="overflow"):
        ops.epaxos_draws(key, 2**31 - 2, 4, 25)
    with pytest.raises(ValueError, match="at least 1"):
        ops.epaxos_draws(key, 0, 1, 0)
