"""Tests of the port that need the card: the hand-written CUDA kernels
against their plain versions, the launch wrappers' checks, and whole runs
through the kernels against runs through the plain versions (and, for the
Pig collective schedules, a one-rank NCCL world against a gloo one on the
CPU).  They import
no JAX, so they run on a machine with a GPU and no JAX:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Without a CUDA device each test skips with its reason."""
import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.core import vectorsim
from repro_torch.core.pig import PigConfig
from repro_torch.kernels import flash_attention, ops, pig_aggregate, ref, \
    segfanin, ssm_scan
from repro_torch.launch.serve import generate
from repro_torch.models import init_params, make_cache, param_tree_shapes
from repro_torch.train import build_prefill_step

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


# (name, real group sizes, padded groups of size 0, slots F): the main
# path's groups, Paxos's segments of 1, PigPaxos at R=1, a ragged layout
# whose segments cross 32-slot windows, and a mixed grid's padding
SM90_LAYOUTS = [
    ("R=3", [8, 8, 8], 0, 24), ("N=257/R=16", [16] * 16, 0, 256),
    ("N=1025/R=32", [32] * 32, 0, 1024), ("paxos", [1] * 24, 0, 24),
    ("R=1", [1024], 0, 1024),
    ("ragged", [5, 37, 12, 1, 33, 40, 2, 30], 0, 160),
    ("size-0 group", [8, 8, 8], 1, 24), ("tail", [7, 7, 6], 2, 24)]


def _groups(seed, sizes, pad, F, C, B, device):
    """The grouped entry's (layout, step) inputs: ties, ~10% masked slots,
    the first segment fully masked where there are two or more."""
    rng = np.random.default_rng(seed)
    G = len(sizes) + pad
    sz = np.array(list(sizes) + [0] * pad)
    gstart = np.cumsum(sz) - sz
    grp = np.full(F, G - 1)
    grp[:sz.sum()] = np.repeat(np.arange(G), sz)
    mask = rng.uniform(size=(C, B, F)) >= 0.1
    if len(sizes) > 1:
        mask[:, :, :sizes[0]] = False
    f = lambda a: torch.tensor(a, dtype=torch.float32, device=device)
    i = lambda a: torch.tensor(np.broadcast_to(a, (C, len(a))),
                               dtype=torch.int32, device=device)
    layout = (i(grp), i(gstart), i(sz),
              i(np.floor(rng.uniform(size=G) * np.maximum(sz, 1))))
    step = (f(1.0 + np.floor(rng.uniform(0, 256, (C, B, F))) / 256),
            torch.tensor(mask, device=device),
            f(rng.uniform(-1e-3, 1e-3, (C, B, G))),
            f(-0.05 - 0.9 * rng.uniform(size=C)),
            f(3e-4 * rng.uniform(size=C)), f(np.full(C, 2e-5)),
            f(1.0 + 1e-3 * rng.uniform(size=(C, B))))
    return layout, step


def _rows(layout, step):
    """The same step in the per-slot entry's layout."""
    grp, _, _, kg = layout
    arr, mask, B_r, rm1, md1, c, L1 = step
    C, B, F = arr.shape
    g = grp.long()
    per_row = lambda x: x[:, None].expand(C, B).reshape(-1)
    return (torch.where(mask, arr, torch.inf).reshape(C * B, F),
            torch.gather(B_r, 2, g[:, None, :].expand(C, B, F))
            .reshape(C * B, F),
            grp, torch.gather(kg.long(), 1, g).int(),
            torch.stack((per_row(rm1), per_row(md1), per_row(c),
                         L1.reshape(-1)), 1).contiguous(), B)


def _want_groups(layout, step):
    return ref.seg_fanin_groups_ref(*step[:3], layout[0], layout[1],
                                    layout[3], *step[3:])


@pytest.mark.parametrize("name,sizes,pad,F", SM90_LAYOUTS,
                         ids=[x[0] for x in SM90_LAYOUTS])
def test_sm90_entries_match_plain_version(cuda, name, sizes, pad, F):
    layout, step = _groups(F + len(sizes), sizes, pad, F, 3, 8, cuda)
    rows = _rows(layout, step)
    plan = segfanin.FaninGroups(*layout, 8)
    before = segfanin.launches
    got = plan(*step)
    got_rows = segfanin.seg_fanin_rows(*rows)
    torch.cuda.synchronize()
    assert segfanin.launches == before + 2
    assert torch.equal(got, _want_groups(layout, step))
    assert torch.equal(got_rows, ref.seg_fanin_rows_ref(*rows))


# the WAN scenarios' explicit per-region groups: 16/16/16 at F=48
# (wan/N=49) and 34/33/33 at F=100 (wan/N=101), whose segments cross
# 32-slot windows, and wan/N=25's 8/8/8
WAN_LAYOUTS = [("wan/N=25", [8, 8, 8], 24), ("wan/N=49", [16, 16, 16], 48),
               ("wan/N=101", [34, 33, 33], 100)]


@pytest.mark.parametrize("name,sizes,F", WAN_LAYOUTS,
                         ids=[x[0] for x in WAN_LAYOUTS])
def test_sm90_entries_match_plain_version_at_wan_widths(cuda, name, sizes,
                                                        F):
    """Both sm90 entries at the WAN layouts, bit for bit, at the full
    grids' rows (32 cells x 8)."""
    layout, step = _groups(F + 1, sizes, 0, F, 32, 8, cuda)
    rows = _rows(layout, step)
    before = segfanin.launches
    got = segfanin.FaninGroups(*layout, 8)(*step)
    got_rows = segfanin.seg_fanin_rows(*rows)
    torch.cuda.synchronize()
    assert segfanin.launches == before + 2
    assert torch.equal(got, _want_groups(layout, step))
    assert torch.equal(got_rows, ref.seg_fanin_rows_ref(*rows))


# the megagrid study's group buckets: F = 8 (N = 5 and 9), 16 and 24 slots,
# groups padded with size-0 groups to the bucket's count (N = 5's slots
# past its 4 followers form a tail)
MEGAGRID_LAYOUTS = [("N=5/paxos", [1] * 4, 4, 8), ("N=5/R=2", [2, 2], 6, 8),
                    ("N=9/R=1", [8], 7, 8), ("N=17/R=2", [8, 8], 14, 16),
                    ("N=17/R=8", [2] * 8, 8, 16),
                    ("N=25/R=4", [6] * 4, 20, 24)]


@pytest.mark.parametrize("B", [4, 8])
@pytest.mark.parametrize("name,sizes,pad,F", MEGAGRID_LAYOUTS,
                         ids=[x[0] for x in MEGAGRID_LAYOUTS])
def test_sm90_entries_match_plain_version_at_megagrid_layouts(
        cuda, name, sizes, pad, F, B):
    """Both sm90 entries at the megagrid's layouts, bit for bit, at a
    4,096-cell chunk and the bucket's requests a step."""
    layout, step = _groups(F + pad + B, sizes, pad, F, 4096, B, cuda)
    rows = _rows(layout, step)
    before = segfanin.launches
    got = segfanin.FaninGroups(*layout, B)(*step)
    got_rows = segfanin.seg_fanin_rows(*rows)
    torch.cuda.synchronize()
    assert segfanin.launches == before + 2
    assert torch.equal(got, _want_groups(layout, step))
    assert torch.equal(got_rows, ref.seg_fanin_rows_ref(*rows))


def _branch_kw(branch):
    from repro_torch.core.network import wan_topology
    from repro_torch.core.workload import WorkloadConfig
    from repro_torch.faults.plan import crash_window, slow_window
    if branch == "wan":
        per = [17, 16, 16]
        groups = [list(range(0, 17)), list(range(17, 33)),
                  list(range(33, 49))]
        return 49, dict(pig=PigConfig(n_groups=3, groups=groups, prc=1),
                        topo=wan_topology(per, [[0.15, 31, 35],
                                                [31, 0.15, 11],
                                                [35, 11, 0.15]]),
                        duration=0.4)
    if branch == "batching":
        return 25, dict(pig=PigConfig(n_groups=3, prc=1), batch_m=4,
                        clients=(16, 32))
    if branch == "avail":
        plan = crash_window(1, 0.06, 0.1) + slow_window(2,
                                                         extra_latency=2e-3)
        return 25, dict(pig=PigConfig(n_groups=3, prc=1),
                        masks=plan.to_masks(25, 0.65))
    if branch == "reads":
        return 25, dict(workload=WorkloadConfig(read_ratio=0.9,
                                                read_path="lease"))
    return 25, dict(pig=PigConfig(n_groups=5, prc=1), obs=True)


@pytest.mark.parametrize("branch", ["wan", "batching", "avail", "reads",
                                    "obs"])
def test_branch_run_through_the_kernel_equals_the_plain_run(cuda, branch):
    """Each optional branch of the group kernel: one sm90 launch a scan
    step, a rerun bit-identical, and the plain fan-in's run bit for bit,
    extras (timeline, obs, rw) included."""
    n, kw = _branch_kw(branch)
    kw = dict(dict(clients=(8, 20), seeds=(0, 1), duration=0.1,
                   warmup=0.05, device=cuda), **kw)
    proto = "paxos" if branch == "reads" else "pigpaxos"
    segfanin.launches = 0
    info: dict = {}
    a = vectorsim.simulate_scenario(proto, n, info=info, **kw)
    assert segfanin.launches == info["scan_steps"] > 0
    assert vectorsim.simulate_scenario(proto, n, **kw) == a
    b = vectorsim.simulate_scenario(proto, n, kernel="torch", **kw)
    assert a == b
    extra = {"avail": "timeline", "reads": "rw", "obs": "obs"}.get(branch)
    assert extra is None or all(extra in u for u in a)


def test_sm90_graph_replay_equals_eager_launch(cuda):
    layout, step = _groups(7, [32] * 32, 0, 1024, 6, 8, cuda)
    plan = segfanin.FaninGroups(*layout, 8)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        plan(*step)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = plan(*step)
    graph.replay()
    eager = plan(*step)
    torch.cuda.synchronize()
    assert torch.equal(captured, eager)
    assert torch.equal(eager, _want_groups(layout, step))


def test_sm90_wrappers_check_their_inputs(cuda):
    layout, step = _groups(3, [8, 8, 8], 1, 24, 2, 8, cuda)
    plan = segfanin.FaninGroups(*layout, 8)
    assert plan(*step).shape == (2, 8, 4)

    def call(i, t):
        return plan(*step[:i], t, *step[i + 1:])
    with pytest.raises(TypeError, match="arr_back"):
        call(0, step[0].double())
    with pytest.raises(TypeError, match="peer_mask"):
        call(1, step[1].float())
    with pytest.raises(ValueError, match="contiguous"):
        call(0, step[0].transpose(0, 1).contiguous().transpose(0, 1))
    with pytest.raises(ValueError, match="shape"):
        call(2, step[2][:, :, :3].contiguous())
    with pytest.raises(ValueError, match="on cpu"):
        call(6, step[6].cpu())
    grp, gstart, sz, kg = layout
    with pytest.raises(TypeError, match="integer"):
        segfanin.FaninGroups(grp.float(), gstart, sz, kg, 8)
    bad = gstart.clone()
    bad[:, 2] += 1
    with pytest.raises(ValueError, match="not contiguous"):
        segfanin.FaninGroups(grp, bad, sz, kg, 8)
    wide = torch.zeros(1, 4096, dtype=torch.int32, device=cuda)
    one = torch.zeros(1, 1, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="2048"):
        segfanin.FaninGroups(wide, one, one + 4096, one, 8)
    rows = _rows(*_groups(4, [8, 8, 8], 0, 24, 2, 8, cuda))
    with pytest.raises(TypeError, match="kcap"):
        segfanin.seg_fanin_rows(*rows[:3], rows[3].long(), *rows[4:])


def test_mixed_grid_launches_sm90_once_a_step(cuda):
    """PigPaxos R=3 beside R=4 at N=25: the R=3 cells carry a padded group
    of size 0.  One sm90 launch a scan step, and the plain run's results
    bit for bit."""
    cfgs = [vectorsim.build_config("pigpaxos", 25,
                                   pig=PigConfig(n_groups=r, prc=1))
            for r in (3, 4)]
    grid = [(ci, k, s) for ci in (0, 1) for k in (10, 30) for s in (0, 1)]
    segfanin.launches = 0
    a = vectorsim.simulate_grid(cfgs, grid, 0.1, 0.05, device=cuda)
    assert segfanin.launches == a["scan_steps"] > 0
    b = vectorsim.simulate_grid(cfgs, grid, 0.1, 0.05, kernel="torch",
                                device=cuda)
    for k, v in a.items():
        assert np.array_equal(v, b[k], equal_nan=True), k


# ------------------------------------------------------------------ flash
def _qkv(seed, B, Hq, Hkv, S, Dh, dtype, device):
    g = torch.Generator(device="cpu").manual_seed(seed)
    return [torch.randn(B, h, S, Dh, generator=g).to(dtype).to(device)
            for h in (Hq, Hkv, Hkv)]


@pytest.mark.parametrize("layout", ["bhsd", "bshd"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("B,Hq,Hkv,S,Dh,causal", [
    (2, 8, 2, 128, 64, True),      # GQA, whole tiles
    (1, 4, 4, 100, 128, True),     # ragged S
    (1, 4, 2, 70, 32, False),      # ragged, no mask
    (1, 4, 2, 1, 128, True),       # one row
    (2, 8, 2, 129, 128, True),     # one row past a 128-row tile
    (1, 8, 2, 1000, 128, True),    # ragged, eight key tiles
    (1, 4, 4, 200, 256, True),     # gemma-7b's head dim
])
def test_flash_kernel_matches_plain_version(cuda, layout, dtype, B, Hq, Hkv,
                                            S, Dh, causal):
    """Tolerance: both compute in f32 and round once; bf16 within 2 ulps
    (|d| <= 2e-3 + 1.6e-2 |ref|), f32 within 1e-5 + 1e-4 |ref| (other
    summation orders, expf against torch.exp).  bf16 at Dh 64/128/256
    launches the sm90 kernel (``launches_sm90`` moves), f32 and Dh 32 the
    CUDA-core kernel (it does not); (B, S, H, Dh) goes through
    ``flash_attention_bshd``."""
    q, k, v = _qkv(S + Dh, B, Hq, Hkv, S, Dh, dtype, cuda)
    f = flash_attention.flash_attention_bhsd
    if layout == "bshd":
        q, k, v = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        f = flash_attention.flash_attention_bshd
    before = flash_attention.launches
    before_sm90 = flash_attention.launches_sm90
    got = f(q, k, v, causal=causal)
    assert flash_attention.launches == before + 1
    sm90 = dtype == torch.bfloat16 and Dh in (64, 128, 256)
    assert flash_attention.launches_sm90 == before_sm90 + int(sm90)
    t = (lambda a: a) if layout == "bhsd" else (lambda a: a.transpose(1, 2))
    want = t(ref.flash_attention_ref(t(q), t(k), t(v), causal=causal))
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == q.shape
    atol, rtol = (2e-3, 1.6e-2) if dtype == torch.bfloat16 else (1e-5, 1e-4)
    err = (got.float() - want.float()).abs()
    assert bool((err <= atol + rtol * want.float().abs()).all()), err.max()
    assert torch.equal(got, f(q, k, v, causal=causal))


def test_flash_sm90_refuses_unaligned_views(cuda):
    """TMA reads 16-byte aligned bases and strides: a view 2 bytes off, or
    with an S stride of 264 bytes, raises before any launch."""
    B, S, H, Dh = 1, 64, 2, 64
    k, v = (torch.zeros(B, S, H, Dh, dtype=torch.bfloat16, device=cuda)
            for _ in range(2))
    flat = torch.zeros(B * S * H * Dh + 8, dtype=torch.bfloat16, device=cuda)
    shifted = flat[1:1 + B * S * H * Dh].view(B, S, H, Dh)
    wide = torch.zeros(B, S, H * Dh + 4, dtype=torch.bfloat16, device=cuda)
    narrow = wide[..., :H * Dh].unflatten(-1, (H, Dh))
    before = flash_attention.launches
    with pytest.raises(ValueError, match="16-byte aligned"):
        flash_attention.flash_attention_bshd(shifted, k, v)
    with pytest.raises(ValueError, match="multiple of 16"):
        flash_attention.flash_attention_bshd(narrow, k, v)
    assert flash_attention.launches == before
    # the strided view itself is served when its strides allow it
    qkv = torch.randn(B, S, 3 * H * Dh, device=cuda).to(torch.bfloat16)
    q3, k3, v3 = (qkv[..., i * H * Dh:(i + 1) * H * Dh].unflatten(
        -1, (H, Dh)) for i in range(3))
    got = flash_attention.flash_attention_bshd(q3, k3, v3)
    want = flash_attention.flash_attention_bshd(
        q3.contiguous(), k3.contiguous(), v3.contiguous())
    assert torch.equal(got, want)


def test_flash_wrapper_checks_its_inputs(cuda):
    q, k, v = _qkv(0, 1, 4, 2, 64, 64, torch.bfloat16, cuda)
    f = flash_attention.flash_attention_bhsd
    with pytest.raises(ValueError, match="on cpu"):
        f(q, k.cpu(), v)
    with pytest.raises(TypeError, match="float16"):
        f(q.half(), k.half(), v.half())
    with pytest.raises(TypeError, match="k is"):
        f(q, k.float(), v)
    with pytest.raises(ValueError, match="head dim 48"):
        f(q[..., :48].contiguous(), k[..., :48].contiguous(),
          v[..., :48].contiguous())
    with pytest.raises(ValueError, match="not contiguous"):
        f(q.transpose(1, 2), k, v)
    with pytest.raises(ValueError, match="multiple"):
        f(q[:, :3].contiguous(), k, v)
    before = flash_attention.launches
    f(q, k, v)
    assert flash_attention.launches == before + 1


def test_granite_smoke_generate_flash_equals_ref(cuda):
    """The serving path through the kernel against the same path through
    the plain attention, on the card: the kernel launches once per layer
    of the prefill and never in decode; the same last-token logits within
    the bf16 logit tolerance of the CPU tests (0.08), and the same greedy
    tokens while the margin allows (bf16 rounding of the attention output
    may flip a near-tie)."""
    cfg = get_smoke_config("granite-8b")
    params = init_params(cfg, torch.Generator(cuda).manual_seed(0),
                         device=cuda)
    prompts = torch.randint(0, cfg.vocab, (4, 64), device=cuda,
                            generator=torch.Generator(cuda).manual_seed(1))
    runs = {}
    for impl in ("flash", "ref"):
        n0 = flash_attention.launches
        logits, _ = build_prefill_step(cfg, impl=impl)(
            params, make_cache(cfg, 4, 64, device=cuda), tokens=prompts)
        n1 = flash_attention.launches
        toks = generate(params, cfg, make_cache(cfg, 4, 80, device=cuda),
                        tokens=prompts, gen=16, impl=impl).tokens
        n2 = flash_attention.launches
        runs[impl] = (toks, logits.float(), n1 - n0, n2 - n1)
    (tf, lf, pf, gf), (tr, lr, pr, gr) = runs["flash"], runs["ref"]
    assert (pf, gf) == (cfg.n_layers, cfg.n_layers)   # decode launches 0
    assert (pr, gr) == (0, 0)
    assert bool(torch.isfinite(lf).all())
    assert (lf - lr).abs().max().item() <= 0.08
    top2 = lr.topk(2, dim=-1).values
    clear = (top2[:, 0] - top2[:, 1]) > 0.08
    assert torch.equal(tf[clear, 0], tr[clear, 0])


# ------------------------------------------------------------ pig aggregate
def _same_bits(a, b):
    """Bit equality (``torch.equal`` takes -0 for +0)."""
    ints = {1: torch.int8, 2: torch.int16, 4: torch.int32}
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        a.view(ints[a.element_size()]), b.view(ints[b.element_size()]))


def _shards(seed, G, N, block, device, extremes=False):
    """G quantized rows (the relay's input) with one all-zero block, or
    random -127/+127 shards with random scales."""
    rng = np.random.default_rng(seed)
    if extremes:
        q = rng.choice(np.array([-127, 127], np.int8), (G, N))
        s = rng.uniform(1e-3, 10.0, (G, N // block)).astype(np.float32)
        return (torch.from_numpy(q).to(device),
                torch.from_numpy(s).to(device))
    x = torch.from_numpy(rng.standard_normal((G, N)).astype(np.float32))
    x[0, -block:] = 0.0
    q, s = zip(*(pig_aggregate.quantize_blockwise(r.to(device), block)
                 for r in x))
    return torch.stack(q), torch.stack(s)


def test_quantize_blockwise_card_equals_cpu(cuda):
    """The quantizer is plain PyTorch on both devices and must agree bit for
    bit (ties to even, the scale a true division by 127)."""
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(
        1 << 16).astype(np.float32))
    x[:1024] = 0.0
    qc, sc = pig_aggregate.quantize_blockwise(x, 1024)
    qg, sg = pig_aggregate.quantize_blockwise(x.to(cuda), 1024)
    assert _same_bits(qg.cpu(), qc) and _same_bits(sg.cpu(), sc)


@pytest.mark.parametrize("G,N,block,extremes", [
    (2, 2048, 1024, False), (5, 8192, 512, False), (16, 4096, 256, False),
    (3, 4096, 16, False), (4, 8192, 1024, True)])
def test_pig_aggregate_kernel_matches_plain_version(cuda, G, N, block,
                                                    extremes):
    shards, scales = _shards(G * N, G, N, block, cuda, extremes)
    before = pig_aggregate.launches
    got = ops.pig_aggregate(shards, scales, block=block)
    assert pig_aggregate.launches == before + 1
    want = ref.pig_aggregate_ref(shards, scales, block=block)
    torch.cuda.synchronize()
    assert _same_bits(got, want)
    assert _same_bits(got, ops.pig_aggregate(shards, scales, block=block))


def test_pig_aggregate_wrapper_checks_its_inputs(cuda):
    shards = torch.zeros(2, 2048, dtype=torch.int8, device=cuda)
    scales = torch.ones(2, 2, device=cuda)
    f = pig_aggregate.pig_aggregate
    with pytest.raises(ValueError, match="scales on cpu"):
        f(shards, scales.cpu(), 1024)
    with pytest.raises(TypeError, match="int8"):
        f(shards.float(), scales, 1024)
    with pytest.raises(ValueError, match="not a multiple of 16"):
        f(torch.zeros(2, 2040, dtype=torch.int8, device=cuda),
          torch.ones(2, 85, device=cuda), 24)
    with pytest.raises(ValueError, match="16-byte aligned"):
        buf = torch.zeros(2 * 2048 + 1, dtype=torch.int8, device=cuda)
        f(buf[1:].view(2, 2048), scales, 1024)
    with pytest.raises(ValueError, match="not contiguous"):
        f(torch.zeros(2048, 2, dtype=torch.int8, device=cuda).t(), scales,
          1024)
    before = pig_aggregate.launches
    assert bool((f(shards, scales, 1024) == 0).all())
    assert pig_aggregate.launches == before + 1


def test_one_rank_nccl_sync_grads_equals_gloo_on_the_cpu(cuda, tmp_path):
    """granite-smoke's gradient tree (the JAX layout, bf16 with f32 norms)
    through ``sync_grads`` in a one-rank NCCL world and through a one-rank
    gloo group on the CPU: two pig_q8 steps of error feedback bit for bit,
    one kernel launch a leaf on the card; direct and pig return the input
    (one term a sum)."""
    import torch.distributed as dist

    from repro_torch.collectives import sync_grads
    from repro_torch.collectives.schedules import tree_map
    from repro_torch.launch import mesh
    gen = torch.Generator().manual_seed(0)
    grads = tree_map(lambda sd: (0.05 * torch.randn(sd[0], generator=gen)
                                  ).to(sd[1]),
                      param_tree_shapes(get_smoke_config("granite-8b")))
    mesh.init(0, 1, dist.FileStore(str(tmp_path / "store"), 1))
    try:
        meshes = {"cuda": mesh.make_mesh(1, 1),
                  "cpu": mesh.make_mesh(1, 1, backend="gloo")}
        runs = {}
        for dev, m in meshes.items():
            g = tree_map(lambda t: t.to(dev), grads)
            before = pig_aggregate.launches
            s1, r1 = sync_grads(g, m, "pig_q8", block=64)
            s2, r2 = sync_grads(g, m, "pig_q8", residuals=r1, block=64)
            runs[dev] = (s1, r1, s2, r2, pig_aggregate.launches - before)
            for schedule in ("direct", "pig"):
                out, _ = sync_grads(g, m, schedule)
                tree_map(lambda a, b: _check(_same_bits(a, b)), out, g)
        torch.cuda.synchronize()
        assert runs["cuda"][4] == 2 * 12 and runs["cpu"][4] == 0
        for a, b in zip(runs["cuda"][:4], runs["cpu"][:4]):
            tree_map(lambda x, y: _check(_same_bits(x.cpu(), y)), a, b)
    finally:
        dist.destroy_process_group()


def _check(ok):
    assert ok


# ------------------------------------------------------------------ ssm scan
def _scan_inputs(seed, B, T, H, Dk, Dv, dtype, device, bonus, rwkv=False):
    """q, k, v ~ 0.3 N (in ``dtype``); log_a f32: the reference tests'
    -(0.5 |N| + 0.01), or RWKV's clamped range [-2.3, -1e-4]; u and a
    non-zero s0 for the bonus cases."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    n = lambda *s: torch.randn(*s, generator=g)
    q, k = n(B, T, H, Dk) * 0.3, n(B, T, H, Dk) * 0.3
    v = n(B, T, H, Dv) * 0.3
    if rwkv:
        la = -torch.exp(n(B, T, H, Dk) * 3.0).clamp(1e-4, 2.3)
    else:
        la = -n(B, T, H, Dk).abs() * 0.5 - 0.01
    u = n(H, Dk) * 0.1 if bonus else None
    s0 = n(B, H, Dk, Dv) * 0.5 if bonus else None
    to = lambda t, dt=torch.float32: None if t is None else t.to(dt).to(
        device)
    return (to(q, dtype), to(k, dtype), to(v, dtype), to(la), to(u),
            to(s0))


def _scan_close(got, want):
    """f32: |d| <= 2e-4 max(1, max|plain|) (the reference's own 2e-4
    between its kernel and oracle); bf16: that f32 slack plus 2 bf16 ulps
    of |plain| (each side rounds its f32 sum once)."""
    d = (got.float() - want.float()).abs()
    tol = 2e-4 * max(1.0, want.float().abs().max().item())
    if got.dtype == torch.bfloat16:
        mag = want.float().abs().clamp_min(torch.finfo(torch.float32).tiny)
        return bool((d <= tol + 2 * torch.exp2(torch.floor(torch.log2(mag))
                                               - 7)).all())
    return d.max().item() <= tol


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,T,H,Dk,Dv,chunk,bonus,rwkv", [
    (1, 128, 2, 64, 64, 32, False, False),
    (2, 96, 4, 64, 64, 32, False, False),
    (1, 100, 1, 32, 64, 32, False, False),     # ragged T
    (2, 64, 2, 16, 64, 16, False, False),
    (1, 64, 2, 32, 32, 16, True, False),       # the bonus case
    (2, 200, 3, 64, 64, 16, True, True),       # RWKV: clamped decays, s0
    (1, 130, 2, 64, 16, 64, False, False),     # chunk 64, one slab
    (1, 1000, 2, 64, 64, 16, True, True),      # sm90: ragged T, RWKV
    (2, 5, 3, 64, 64, 16, True, True),         # sm90: T < 16
    (2, 128, 2, 64, 128, 16, False, False),    # sm90: two column blocks
])
def test_ssm_scan_kernel_matches_plain_version(cuda, dtype, B, T, H, Dk, Dv,
                                               chunk, bonus, rwkv):
    """Dk 64, Dv a multiple of 64 and chunk 16 launch the sm90 kernel
    (``launches_sm90`` moves), the rest ssm_scan.cu."""
    q, k, v, la, u, s0 = _scan_inputs(T + Dk, B, T, H, Dk, Dv, dtype, cuda,
                                      bonus, rwkv)
    before, before_sm90 = ssm_scan.launches, ssm_scan.launches_sm90
    y, s = ops.ssm_scan(q, k, v, la, u=u, chunk=chunk, s0=s0,
                        return_state=True)
    assert ssm_scan.launches == before + 1
    sm90 = Dk == 64 and Dv % 64 == 0 and chunk == 16
    assert ssm_scan.launches_sm90 == before_sm90 + int(sm90)
    wy, ws = ref.ssm_scan_ref(q, k, v, la, u=u, chunk=chunk, s0=s0,
                              return_state=True)
    torch.cuda.synchronize()
    assert y.dtype == dtype and y.shape == (B, T, H, Dv)
    assert s.dtype == torch.float32 and s.shape == (B, H, Dk, Dv)
    assert _scan_close(y, wy) and _scan_close(s, ws)
    y2, s2 = ops.ssm_scan(q, k, v, la, u=u, chunk=chunk, s0=s0,
                          return_state=True)
    assert torch.equal(y, y2) and torch.equal(s, s2)


def test_ssm_scan_wrapper_checks_its_inputs(cuda):
    q, k, v, la, u, s0 = _scan_inputs(0, 1, 32, 2, 64, 64, torch.bfloat16,
                                      cuda, True)
    f = ssm_scan.ssm_scan
    with pytest.raises(ValueError, match="v on cpu"):
        f(q, k, v.cpu(), la, u)
    with pytest.raises(TypeError, match="log_a is torch.bfloat16"):
        f(q, k, v, la.bfloat16(), u)
    with pytest.raises(TypeError, match="k is torch.float32"):
        f(q, k.float(), v, la, u)
    with pytest.raises(TypeError, match="float16"):
        f(q.half(), k.half(), v.half(), la, u)
    with pytest.raises(ValueError, match="chunk 48"):
        f(q, k, v, la, u, chunk=48)
    with pytest.raises(ValueError, match="Dk 48"):
        f(*(t[..., :48].contiguous() for t in (q, k)), v,
          la[..., :48].contiguous(), u[:, :48].contiguous())
    with pytest.raises(ValueError, match="Dv 40"):
        f(q, k, v[..., :40].contiguous(), la, u)
    with pytest.raises(ValueError, match="u has shape"):
        f(q, k, v, la, u[:1])
    with pytest.raises(ValueError, match="s0 has shape"):
        f(q, k, v, la, u, s0=s0[:, :1])
    with pytest.raises(ValueError, match="not contiguous"):
        f(*(t.transpose(1, 2) for t in (q, k, v, la)))
    before = ssm_scan.launches
    f(q, k, v, la, u, s0=s0)
    assert ssm_scan.launches == before + 1


def test_ssm_scan_sm90_refuses_unaligned_inputs(cuda):
    """The sm90 kernel copies 16 bytes at a time: a q 2 bytes off its
    alignment raises before any launch; the same values aligned launch."""
    q, k, v, la, u, s0 = _scan_inputs(1, 1, 32, 2, 64, 64, torch.bfloat16,
                                      cuda, True)
    flat = torch.zeros(q.numel() + 8, dtype=q.dtype, device=cuda)
    shifted = flat[1:1 + q.numel()].view(q.shape)
    shifted.copy_(q)
    before, before_sm90 = ssm_scan.launches, ssm_scan.launches_sm90
    with pytest.raises(ValueError, match="16-byte aligned"):
        ssm_scan.ssm_scan(shifted, k, v, la, u, chunk=16)
    assert ssm_scan.launches == before
    y = ssm_scan.ssm_scan(q, k, v, la, u, chunk=16)
    assert ssm_scan.launches_sm90 == before_sm90 + 1
    assert torch.equal(y, ssm_scan.ssm_scan(shifted.clone(), k, v, la, u,
                                            chunk=16))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("Dh,Hq,Hkv", [(80, 8, 2), (112, 8, 8)])
def test_flash_padded_head_dims_match_plain_version(cuda, dtype, Dh, Hq,
                                                    Hkv):
    """``ops.flash_attention`` at head dims no kernel takes (h2o-danube's
    80, zamba2-7b's 112): padded to 128, one launch (of the sm90 kernel in
    bf16), within the kernels' tolerances of the plain version at the
    unpadded Dh."""
    B, S = 2, 300
    q, k, v = (t.transpose(1, 2).contiguous() for t in
               _qkv(Dh, B, Hq, Hkv, S, Dh, dtype, cuda))
    before = flash_attention.launches
    before_sm90 = flash_attention.launches_sm90
    got = ops.flash_attention(q, k, v, causal=True)
    assert flash_attention.launches == before + 1
    assert flash_attention.launches_sm90 == before_sm90 + int(
        dtype == torch.bfloat16)
    want = flash_attention._plain(q, k, v, True, None, "bshd")
    torch.cuda.synchronize()
    assert got.shape == q.shape and got.dtype == dtype
    atol, rtol = (2e-3, 1.6e-2) if dtype == torch.bfloat16 else (1e-5, 1e-4)
    err = (got.float() - want.float()).abs()
    assert bool((err <= atol + rtol * want.float().abs()).all()), err.max()
    assert torch.equal(got, ops.flash_attention(q, k, v, causal=True))


def test_rwkv_smoke_generate_kernel_equals_ref(cuda):
    """rwkv6-smoke served through the kernel (``impl="auto"``) against the
    same path through ``chunked_linear_scan`` (``impl="ref"``), on the card:
    the kernel launches once per layer of the prefill and never in decode;
    the last-token logits within the rwkv6 bf16 logit tolerance of the CPU
    tests (0.15, ``tests/test_torch_rwkv.py``), the greedy tokens equal
    while the margin allows."""
    cfg = get_smoke_config("rwkv6-3b")
    params = init_params(cfg, torch.Generator(cuda).manual_seed(0),
                         device=cuda)
    prompts = torch.randint(0, cfg.vocab, (4, 70), device=cuda,
                            generator=torch.Generator(cuda).manual_seed(1))
    runs = {}
    for impl in ("auto", "ref"):
        n0 = ssm_scan.launches
        logits, _ = build_prefill_step(cfg, impl=impl)(
            params, make_cache(cfg, 4, 70, device=cuda), tokens=prompts)
        n1 = ssm_scan.launches
        toks = generate(params, cfg, make_cache(cfg, 4, 86, device=cuda),
                        tokens=prompts, gen=16, impl=impl).tokens
        n2 = ssm_scan.launches
        runs[impl] = (toks, logits.float(), n1 - n0, n2 - n1)
    (ta, la, pa, ga), (tr, lr, pr, gr) = runs["auto"], runs["ref"]
    assert (pa, ga) == (cfg.n_layers, cfg.n_layers)   # decode launches 0
    assert (pr, gr) == (0, 0)
    assert bool(torch.isfinite(la).all())
    assert (la - lr).abs().max().item() <= 0.15
    top2 = lr.topk(2, dim=-1).values
    clear = (top2[:, 0] - top2[:, 1]) > 0.15
    assert torch.equal(ta[clear, 0], tr[clear, 0])


# ------------------------------------------------- Mamba2 and MoE serving
def _card_and_cpu(cfg, prompts, gen, dtype=torch.bfloat16):
    """The smoke config from one CPU init (in ``dtype``) on the card and on
    the CPU: the prefill step's last-token logits, generate's tokens, and
    the flash launches of each."""
    params = init_params(cfg, torch.Generator().manual_seed(0), dtype=dtype,
                         device="cpu")
    runs = {}
    for dev in ("cuda", "cpu"):
        p, x = params.to(dev), prompts.to(dev)
        n0 = flash_attention.launches
        logits, _ = build_prefill_step(cfg, impl="flash")(
            p, make_cache(cfg, 4, x.shape[1], dtype=dtype, device=dev),
            tokens=x)
        n1 = flash_attention.launches
        toks = generate(p, cfg, make_cache(cfg, 4, x.shape[1] + gen,
                                           dtype=dtype, device=dev),
                        tokens=x, gen=gen, impl="flash").tokens
        runs[dev] = (toks.cpu(), logits.float().cpu(), n1 - n0,
                     flash_attention.launches - n1)
    return runs["cuda"], runs["cpu"]


@pytest.mark.parametrize("family", ["hybrid", "ssm"])
def test_zamba2_smoke_generate_card_equals_cpu(cuda, family):
    """zamba2-smoke (and its ``ssm`` variant) served on the card against the
    CPU from the same parameters: the flash kernel launches once a
    shared-block application of the prefill (n_super = 2; none for
    ``ssm``) and never in decode; the last-token logits within the CPU
    tests' bf16 tolerances for the family (``tests/test_torch_hybrid.py``:
    relative L2 0.2, max |d| 1.0; a random Mamba2 stack amplifies an ulp
    of rounding), greedy first tokens equal where the margin exceeds
    1.0."""
    from repro_torch.models.model import n_super
    cfg = get_smoke_config("zamba2-7b").replace(family=family)
    prompts = torch.randint(0, cfg.vocab, (4, 70),
                            generator=torch.Generator().manual_seed(1))
    (tg, lg, pg, gg), (tc, lc, pc, gc) = _card_and_cpu(cfg, prompts, 16)
    want = n_super(cfg) if family == "hybrid" else 0
    assert (pg, gg) == (want, want)              # decode launches 0
    assert (pc, gc) == (0, 0)
    assert bool(torch.isfinite(lg).all())
    assert ((lg - lc).norm() / lc.norm()).item() <= 0.2
    assert (lg - lc).abs().max().item() <= 1.0
    top2 = lc.topk(2, dim=-1).values
    clear = (top2[:, 0] - top2[:, 1]) > 1.0
    assert torch.equal(tg[clear, 0], tc[clear, 0])


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "qwen3-moe-235b-a22b"])
def test_moe_smoke_generate_card_equals_cpu(cuda, arch):
    """qwen2-moe-smoke and qwen3-moe-smoke served on the card against the
    CPU.  In bf16 (the serving type) flash launches once a layer of the
    prefill and never in decode, and the logits are finite; a near-tie of
    two gates routes a token apart on the two devices in bf16
    (``tests/test_torch_moe.py``), so the values are held in f32, where
    the router's inputs agree to f32 rounding: the last-token logits
    within 1e-4 of the largest (f32 sums in other orders), greedy tokens
    equal where the first margin exceeds 1e-3."""
    cfg = get_smoke_config(arch)
    prompts = torch.randint(0, cfg.vocab, (4, 70),
                            generator=torch.Generator().manual_seed(1))
    (tg, lg, pg, gg), (_, _, pc, gc) = _card_and_cpu(cfg, prompts, 16)
    assert (pg, gg) == (cfg.n_layers, cfg.n_layers)   # decode launches 0
    assert (pc, gc) == (0, 0)
    assert bool(torch.isfinite(lg).all()) and tg.shape == (4, 16)
    (tg, lg, _, _), (tc, lc, _, _) = _card_and_cpu(cfg, prompts, 16,
                                                   torch.float32)
    assert (lg - lc).abs().max().item() <= 1e-4 * lc.abs().max().item()
    top2 = lc.topk(2, dim=-1).values
    clear = (top2[:, 0] - top2[:, 1]) > 1e-3
    assert torch.equal(tg[clear, 0], tc[clear, 0])


# ----------------------------------------------- the EPaxos kernel's fan-in
@pytest.mark.parametrize("F", [5, 9, 17, 25, 49])
@pytest.mark.parametrize("rows", [8, 4096])
@pytest.mark.parametrize("cap", ["fq", "majority"])
def test_epaxos_fanin_layouts_match_plain_version(cuda, F, rows, cap):
    """``seg_fanin_rows`` at the EPaxos kernel's layout (rows = cells, one
    segment of F = n slots, the coordinator's slot +inf, coef = W_C,
    scalars [-0.5, 0, c, L1], cap fq - 2 or majority - 2, ties on a 2**-8
    grid): the sm90 kernel equals the plain version bit for bit, one
    launch a call."""
    from repro_torch.core.quorums import fast_quorum, majority
    rng = np.random.default_rng(F * rows)
    vals = 1.0 + np.floor(rng.uniform(0, 256, (rows, F))) / 256
    vals[np.arange(rows), rng.integers(0, F, rows)] = np.inf
    wc = np.where(rng.uniform(size=rows) < 0.25, 0.0,
                  rng.uniform(0, 2e-3, rows))
    kcap = (fast_quorum(F) if cap == "fq" else majority(F)) - 2
    scal = np.stack([np.full(rows, -0.5), np.zeros(rows),
                     np.full(rows, 2e-5), 1.0 - rng.uniform(0, 1e-3, rows)],
                    axis=1)
    f = lambda a: torch.tensor(a, dtype=torch.float32, device=cuda)
    i = lambda a: torch.tensor(a, dtype=torch.int32, device=cuda)
    args = (f(vals), f(np.repeat(wc[:, None], F, 1)), i(np.zeros((rows, F))),
            i(np.full((rows, F), kcap)), f(scal), 1)
    n0 = segfanin.launches
    got = segfanin.seg_fanin_rows(*args)
    assert segfanin.launches == n0 + 1
    want = ref.seg_fanin_rows_ref(*args)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def test_epaxos_run_through_the_kernel_equals_the_plain_run(cuda):
    """Two launches a scan step; the kernel's run, the plain fan-in's run
    on the card and the CPU's run give the same units (hot keys, so the
    slow path runs too)."""
    from repro_torch.core.workload import WorkloadConfig
    kw = dict(workload=WorkloadConfig(key_dist="conflict",
                                      conflict_rate=0.5),
              clients=(10, 20), seeds=(0, 1), duration=0.05, warmup=0.05)
    segfanin.launches = 0
    info: dict = {}
    a = vectorsim.simulate_scenario("epaxos", 9, info=info, device=cuda,
                                    **kw)
    assert segfanin.launches == info["fanin_launches"] \
        == 2 * info["scan_steps"] > 0
    assert a == vectorsim.simulate_scenario("epaxos", 9, kernel="torch",
                                            device=cuda, **kw)
    c = vectorsim.simulate_scenario("epaxos", 9, device="cpu", **kw)
    for x, y in zip(a, c):
        assert abs(x["count"] - y["count"]) <= 1
        assert x["p99_ms"] == pytest.approx(y["p99_ms"], rel=1e-5)


def test_chunked_equals_unchunked_on_the_card(cuda):
    """``simulate_grid_sharded`` in ragged chunks == one ``simulate_grid``
    call, bit for bit, for the group and the EPaxos kernels."""
    from repro_torch.core.workload import WorkloadConfig
    for cfgs, grid in (
            ([vectorsim.build_config("pigpaxos", 9,
                                     pig=PigConfig(n_groups=2, prc=1)),
              vectorsim.build_config("paxos", 9)],
             [(ci, k, s) for ci in range(2) for k in (4, 8)
              for s in range(6)]),
            ([vectorsim.build_config("epaxos", 5),
              vectorsim.build_config("epaxos", 5, workload=WorkloadConfig(
                  key_dist="conflict", conflict_rate=0.5))],
             [(ci, k, s) for ci in range(2) for k in (2, 4)
              for s in range(3)])):
        want = vectorsim.simulate_grid(cfgs, grid, 0.05, 0.05, device=cuda)
        got = vectorsim.simulate_grid_sharded(cfgs, grid, 0.05, 0.05,
                                              chunk=7, device=cuda)
        assert got["sharding"]["kernel"] == "seg_fanin_sm90"
        for k in want:
            if k != "scan_steps":
                assert np.array_equal(want[k], got[k], equal_nan=True), k


def test_lowering_gathers_on_the_card_to_the_stacked_batch(cuda):
    """The runner's lowering of a 4,096-cell EPaxos grid on the card (the
    config's row shipped once, the cells' columns, the gather there) ==
    the per-cell batch ``_stack_cells`` builds, copied whole: key for key,
    dtype for dtype, bit for bit."""
    from repro_torch.convert import cells_from_numpy
    from repro_torch.core.workload import WorkloadConfig
    cfgs = [vectorsim.build_config("epaxos", 25, workload=WorkloadConfig(
        key_dist="conflict", conflict_rate=0.02))]
    grid = [(0, k, s) for k in (10, 20, 40)
            for s in range(2**31, 2**31 + 1366)][:4096]
    spec = vectorsim._pad_spec(cfgs, grid)
    rows = cells_from_numpy(vectorsim._config_rows(cfgs, spec, 0.1, 0.05),
                            cuda)
    got, nbytes = vectorsim._device_cells(
        rows, vectorsim._cell_columns(vectorsim._grid_array(grid)), cuda)
    want = cells_from_numpy(
        vectorsim._stack_cells(cfgs, grid, 0.1, 0.05)[0], cuda)
    assert nbytes == 32 * 4096 and list(got) == list(want)
    for k in want:
        assert got[k].device == want[k].device, k
        assert got[k].dtype == want[k].dtype, k
        assert got[k].shape == want[k].shape and got[k].is_contiguous(), k
        assert torch.equal(got[k], want[k]), k


def test_jaxsim_card_equals_cpu(cuda):
    from repro_torch import prng
    from repro_torch.core import jaxsim
    a = jaxsim.relay_load_mc(prng.PRNGKey(0), 25, 3, 8192, device=cuda)
    b = jaxsim.relay_load_mc(prng.PRNGKey(0), 25, 3, 8192, device="cpu")
    for k in b:
        assert torch.equal(a[k].cpu(), b[k]), k
    x = jaxsim.latency_curve([100.0, 1000.0, 1800.0], 25, 3, device=cuda)
    y = jaxsim.latency_curve([100.0, 1000.0, 1800.0], 25, 3, device="cpu")
    for k in y:
        torch.testing.assert_close(x[k].cpu(), y[k], rtol=1e-6, atol=0)


# ------------------------------------------------------------- training
def _loss_and_grads(model, cfg, batch, impl="auto", remat=True):
    from repro_torch import convert
    from repro_torch.train import loss_and_grads
    loss, grads = loss_and_grads(model, cfg, batch, impl, remat)
    return loss.cpu(), convert.stack_leaves(grads.items())


@pytest.mark.parametrize("arch", ["rwkv6-3b", "h2o-danube-1.8b"])
def test_training_grads_card_equal_cpu_in_f32(cuda, arch):
    """One f32 loss and its gradients from the same parameters and batch,
    card vs CPU: the loss to 1e-5 relative, each gradient leaf to 1e-4
    relative L2 (f32 sums in other orders; rwkv's scan through
    ssm_scan_sm90's 3xTF32 forward and the plain version's gradient)."""
    import copy
    from repro_torch.data import DataConfig, SyntheticLMStream
    cfg = get_smoke_config(arch)
    cpu = init_params(cfg, torch.Generator().manual_seed(0),
                      dtype=torch.float32, device="cpu")
    card = copy.deepcopy(cpu).to(cuda)
    batch = SyntheticLMStream(cfg, DataConfig(2, 40), device="cpu").batch_at(0)
    n0 = ssm_scan.launches_sm90
    lg, gg = _loss_and_grads(card, cfg, {k: t.to(cuda)
                                         for k, t in batch.items()})
    launched = ssm_scan.launches_sm90 - n0
    lw, gw = _loss_and_grads(cpu, cfg, batch)
    assert launched == (2 * cfg.n_layers if cfg.family == "rwkv" else 0)
    assert abs(lg.item() - lw.item()) <= 1e-5 * abs(lw.item())
    for name, w in gw.items():
        assert (gg[name] - w).norm() <= 1e-4 * w.norm(), name


def test_scan_function_on_the_card(cuda):
    """``ops.ssm_scan`` on CUDA tensors that require grad: the output has a
    ``grad_fn`` and is the kernel's (within ``_scan_close``), and every
    input gradient equals the plain version's own, bit for bit."""
    base = _scan_inputs(5, 2, 100, 2, 64, 64, torch.bfloat16, cuda, True,
                        rwkv=True)
    gy = torch.randn(2, 100, 2, 64, generator=torch.Generator().manual_seed(
        6)).to(torch.bfloat16).to(cuda)

    def run(fn):
        ins = [t.clone().requires_grad_(True) for t in base]
        y, _ = fn(*ins[:4], u=ins[4], chunk=16, s0=ins[5], return_state=True)
        y.backward(gy)
        return y, [t.grad for t in ins]

    n0 = ssm_scan.launches_sm90
    got_y, got = run(ops.ssm_scan)
    assert ssm_scan.launches_sm90 == n0 + 1
    want_y, want = run(ref.ssm_scan_ref)
    torch.cuda.synchronize()
    assert got_y.grad_fn is not None and _scan_close(got_y, want_y)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)


@pytest.mark.parametrize("remat", [False, True])
def test_rwkv_training_launches_the_scan(cuda, remat):
    """rwkv6-smoke's loss and backward with ``impl="auto"``: ssm_scan_sm90
    once a layer in the forward and once more a layer with remat (the
    backward recomputes each layer's forward); every time-mix weight gets
    a gradient (LoRA-B drawn non-zero: at the init's zero the LoRA and
    ``mu_w`` get none); no other kernel launches."""
    cfg = get_smoke_config("rwkv6-3b")
    model = init_params(cfg, torch.Generator(cuda).manual_seed(0),
                        device=cuda)
    with torch.no_grad():
        for lp in model.layers:
            lp.time.w_lora_b.normal_(generator=torch.Generator(
                cuda).manual_seed(2))
    from repro_torch.data import DataConfig, SyntheticLMStream
    batch = SyntheticLMStream(cfg, DataConfig(2, 64), device=cuda).batch_at(0)
    n0, f0 = ssm_scan.launches_sm90, flash_attention.launches
    _, grads = _loss_and_grads(model, cfg, batch, remat=remat)
    torch.cuda.synchronize()
    assert ssm_scan.launches_sm90 - n0 == cfg.n_layers * (2 if remat else 1)
    assert flash_attention.launches == f0
    for leaf in ("wr", "wk", "wv", "w_lora_a", "u", "w0", "mu_w"):
        g = grads[f"layers/time/{leaf}"]
        assert bool(torch.isfinite(g.float()).all()), leaf
        assert g.float().abs().sum() > 0, leaf


def test_flash_attention_refuses_grad_on_the_card(cuda):
    from repro_torch.models import lm_loss
    q = torch.randn(1, 64, 4, 64, device=cuda, dtype=torch.bfloat16)
    k = q.clone().requires_grad_(True)
    with pytest.raises(ValueError, match="no backward"):
        ops.flash_attention(q, k, k)
    with torch.no_grad():
        assert ops.flash_attention(q, k, k).shape == q.shape
    cfg = get_smoke_config("granite-8b")
    model = init_params(cfg, torch.Generator(cuda).manual_seed(0),
                        device=cuda)
    toks = torch.zeros(1, 8, dtype=torch.int32, device=cuda)
    n0 = flash_attention.launches
    with pytest.raises(ValueError, match="no backward"):
        lm_loss(model, cfg, {"tokens": toks, "labels": toks}, impl="flash")
    assert flash_attention.launches == n0
