"""The sm90 fan-in (``csrc/seg_fanin_sm90.cu``) on the CPU: its grouped
entry's plain version against the JAX package's Pallas kernel, a numpy
model of the kernel's work split and arithmetic against the plain version,
and the step loop's grouped route against the per-slot route it replaced.

The kernel itself runs only on the card (``tests/test_torch_cuda.py``;
``chip_smoke.py`` phases 3-6).  The model below follows its source step by
step: windows of 32 slots, several rows a block, run masks from the slots'
ids, the in-window route (a bitonic network over 64-bit keys cut to the
smallest aligned block of lanes that holds every segment, a segmented
prefix max by shuffles) and the crossing route through shared memory, in
float32 with one rounding per operation.  It is held to the plain version
bit for bit, and it records what each slot is compared with and how often
each output is written.
"""
import jax  # noqa: F401  (the Pallas kernel runs on JAX's CPU backend)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.core import vectorsim
from repro_torch.core.pig import PigConfig, partition_followers
from repro_torch.kernels import ops, ref, segfanin

# the CPU step loop is bound by per-operation overhead, not arithmetic:
# one intra-op thread is faster here and leaves the other test
# workers their cores
torch.set_num_threads(1)

f32 = np.float32


def _main_sizes(F, r):
    return [len(g) for g in partition_followers(list(range(1, F + 1)), r)]


def _ragged(F, salt=0):
    """Sizes 1..37 cycling: segments that cross 32-slot windows."""
    sizes, left, k = [], F, salt
    while left:
        s = min(left, 1 + (7 * k + 3) % 37)
        sizes.append(s)
        left -= s
        k += 1
    return sizes


# (name, real group sizes, padded groups of size 0, slots F)
LAYOUTS = [
    ("R=3", _main_sizes(24, 3), 0, 24),
    ("N=257/R=16", _main_sizes(256, 16), 0, 256),
    ("N=1025/R=32", _main_sizes(1024, 32), 0, 1024),
    ("paxos N=25", [1] * 24, 0, 24),
    ("paxos N=257", [1] * 256, 0, 256),
    ("one segment of 1024", [1024], 0, 1024),
    ("ragged 24", _ragged(24), 0, 24),
    ("ragged 256", _ragged(256, 1), 0, 256),
    ("ragged 1024", _ragged(1024, 2), 0, 1024),
    ("R=3 in a grid of R=4", _main_sizes(24, 3), 1, 24),
    ("R=3 of 20 slots, tail of 4", _main_sizes(20, 3), 2, 24),
    ("segments of 40, F=100", [40, 40, 20], 1, 100),
]


def _layout(sizes, pad, F, C):
    """Per-cell (grp, gstart, sizes) as ``vectorsim._stack_cells`` lays
    them out: groups contiguous in order, padded groups of size 0 at the
    end with gstart at the end of the real slots, the tail's slots in the
    last group."""
    G = len(sizes) + pad
    sz = np.array(list(sizes) + [0] * pad, np.int64)
    gstart = np.cumsum(sz) - sz
    grp = np.full(F, G - 1, np.int64)
    grp[:sz.sum()] = np.repeat(np.arange(G), sz)
    rep = lambda a: np.repeat(a[None], C, 0)
    return rep(grp), rep(gstart), rep(sz)


def _grouped_case(seed, sizes, pad, F, C=2, B=8):
    """One step's fan-in inputs: arrivals on a 2**-8 grid (ties), ~10%
    masked slots, the first segment fully masked (where there are two or
    more), per-group B_r of either sign, caps in [0, size)."""
    rng = np.random.default_rng(seed)
    grp, gstart, sz = _layout(sizes, pad, F, C)
    G = gstart.shape[1]
    arr = (1.0 + np.floor(rng.uniform(0, 256, (C, B, F))) / 256).astype(f32)
    mask = rng.uniform(size=(C, B, F)) >= 0.1
    if len(sizes) > 1:
        mask[:, :, :sizes[0]] = False
    B_r = rng.uniform(-1e-3, 1e-3, (C, B, G)).astype(f32)
    kg = np.floor(rng.uniform(size=(C, G)) * np.maximum(sz, 1)) \
        .astype(np.int64)
    rm1 = (-0.05 - 0.9 * rng.uniform(size=C)).astype(f32)
    md1 = (3e-4 * rng.uniform(size=C)).astype(f32)
    c = np.full(C, 2e-5, f32)
    L1 = (1.0 + 1e-3 * rng.uniform(size=(C, B))).astype(f32)
    return dict(arr=arr, mask=mask, B_r=B_r, grp=grp, gstart=gstart, sz=sz,
                kg=kg, rm1=rm1, md1=md1, c=c, L1=L1)


def _torch_groups(d):
    t = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in d.items()}
    return (t["arr"], t["mask"], t["B_r"], t["grp"], t["gstart"], t["kg"],
            t["rm1"], t["md1"], t["c"], t["L1"])


# ------------------------------------------- the plain version vs Pallas
@pytest.mark.parametrize("name,sizes,pad,F", [
    ("segments of 1", [1] * 24, 0, 24),
    ("segments of 8", _main_sizes(24, 3), 0, 24),
    ("segments of 16", _main_sizes(256, 16), 0, 256),
    ("segments of 32", _main_sizes(256, 8), 0, 256),
    ("ragged", _ragged(200), 0, 200),
    ("size-0 padded group", _main_sizes(24, 3), 1, 24),
    ("size-0 padded groups and a tail", _main_sizes(20, 3), 2, 24),
])
def test_grouped_plain_version_matches_pallas_kernel(name, sizes, pad, F):
    """``ops.seg_fanin_groups`` on CPU tensors (the plain version) against
    the reference's Pallas kernel in interpret mode, read at
    clip(gstart, 0, F - 1) as ``repro.core.vectorsim`` reads it; the first
    segment is fully masked."""
    d = _grouped_case(F + len(sizes) + pad, sizes, pad, F)
    a = _torch_groups(d)
    fan = ops.seg_fanin_groups(a[3], a[4], torch.from_numpy(d["sz"]), a[5],
                               d["arr"].shape[1])
    got = fan(a[0], a[1], a[2], a[6], a[7], a[8], a[9]).numpy()
    for ci in range(d["arr"].shape[0]):
        grp = d["grp"][ci]
        m = jops.seg_fanin(
            jnp.asarray(np.where(d["mask"][ci], d["arr"][ci], np.inf)),
            jnp.asarray(d["B_r"][ci][:, grp]), jnp.asarray(grp),
            jnp.asarray(d["kg"][ci][grp]), float(d["rm1"][ci]),
            float(d["md1"][ci]), float(d["c"][ci]),
            jnp.asarray(d["L1"][ci]))
        want = np.asarray(m)[:, np.clip(d["gstart"][ci], 0, F - 1)]
        np.testing.assert_allclose(got[ci], want, rtol=1e-6, atol=1e-6,
                                   err_msg=name)
    assert np.isneginf(got[:, :, 0]).all()          # fully masked
    assert np.isfinite(got[:, :, 1:]).mean() > 0.5


def test_grouped_plain_version_is_the_per_slot_version_gathered():
    d = _grouped_case(3, _ragged(100), 2, 110)
    arr, mask, B_r, grp, gstart, kg, rm1, md1, c, L1 = _torch_groups(d)
    C, B, F = arr.shape
    grp_b = grp[:, None, :].expand(C, B, F)
    m = ops.seg_fanin(torch.where(mask, arr, torch.inf),
                      torch.gather(B_r, 2, grp_b), grp.int(),
                      torch.gather(kg, 1, grp).int(), rm1, md1, c, L1)
    gread = torch.clamp(gstart, 0, F - 1)[:, None, :].expand(C, B, -1)
    want = torch.gather(m, 2, gread)
    got = ref.seg_fanin_groups_ref(arr, mask, B_r, grp, gstart, kg, rm1, md1,
                                   c, L1)
    assert torch.equal(got, want)


def test_cpu_grouped_call_never_builds_or_counts(monkeypatch):
    def refuse(name):
        raise AssertionError(f"built {name} for a CPU call")
    monkeypatch.setattr(segfanin.build, "load", refuse)
    monkeypatch.setattr(segfanin, "launches", 0)
    d = _grouped_case(5, _main_sizes(24, 3), 0, 24)
    a = _torch_groups(d)
    fan = segfanin.FaninGroups(a[3], a[4], torch.from_numpy(d["sz"]), a[5], 8)
    assert fan.plain
    assert fan(a[0], a[1], a[2], *a[6:]).shape == (2, 8, 3)
    assert segfanin.launches == 0


# --------------------------------------------- the layout check (set-up)
def test_layout_check_accepts_the_batch_layouts():
    for _, sizes, pad, F in LAYOUTS:
        grp, gstart, sz = _layout(sizes, pad, F, 3)
        segfanin.check_layout(grp, gstart, sz, np.zeros_like(sz))


@pytest.mark.parametrize("break_it,match", [
    (lambda g, s, z, k: s.__setitem__((1, 2), s[1, 2] + 1), "contiguous"),
    (lambda g, s, z, k: g.__setitem__((0, 9), 0), "grp does not match"),
    (lambda g, s, z, k: g.__setitem__((0, 23), 7), "outside"),
    (lambda g, s, z, k: z.__setitem__((0, 1), -1), "negative"),
    (lambda g, s, z, k: k.__setitem__((1, 0), -1), "cap kg"),
])
def test_layout_check_refuses_other_layouts(break_it, match):
    grp, gstart, sz = _layout(_main_sizes(24, 3), 0, 24, 2)
    kg = np.zeros_like(sz)
    break_it(grp, gstart, sz, kg)
    with pytest.raises(ValueError, match=match):
        segfanin.check_layout(grp, gstart, sz, kg)


def test_layout_check_refuses_groups_past_F():
    grp, gstart, sz = _layout([8, 8, 8], 0, 24, 1)
    sz[0, 2] = 9
    with pytest.raises(ValueError, match="more than"):
        segfanin.check_layout(grp, gstart, sz, np.zeros_like(sz))


@pytest.mark.parametrize("F,rows,warps", [
    (24, 8, 8), (1, 8, 8), (64, 4, 8), (96, 2, 6), (256, 1, 8),
    (257, 1, 9), (1024, 1, 32), (2048, 1, 32)])
def test_geometry(F, rows, warps):
    assert segfanin.geometry(F) == (rows, warps)
    assert segfanin.sm90_smem_bytes(F) <= segfanin.SMEM_LIMIT


# ------------------------------------------------- the kernel's model
FULL = 0xFFFFFFFF
LANES = np.arange(32)


def _ordered(v):
    """``ordered_bits``: a float's bits in an order that compares like the
    float, -0 as +0."""
    b = (v + f32(0)).view(np.uint32).astype(np.uint64)
    return np.where(b & 0x80000000, (~b) & FULL, b | 0x80000000)


def _from_ordered(b):
    b = b & FULL
    return np.where(b & 0x80000000, b ^ 0x80000000, (~b) & FULL) \
        .astype(np.uint32).view(f32)


def _y(v, u, rank, vcoef, md1, c, anchor):
    """``fanin_y``: one float32 rounding per operation, in its order."""
    with np.errstate(invalid="ignore", over="ignore"):
        t = v - anchor
        t = vcoef * t
        t = u + t
        t = np.maximum(t, f32(0))
        y = v + t
        y = y + md1
        y = y - f32(rank) * c if np.isscalar(rank) else \
            y - rank.astype(f32) * c
    return np.where(v < np.inf, y, f32(-np.inf)).astype(f32)


def _bitonic(key, K):
    """The warp's bitonic network up to blocks of K lanes, each sorted
    ascending: lane i keeps the min or the max of its key and lane i ^ d's
    at every stage."""
    k = 2
    while k <= K:
        d = k >> 1
        while d:
            o = key[LANES ^ d]
            up = (k == K) | ((LANES & k) == 0)
            keep_min = up == ((LANES & d) == 0)
            key = np.where((o < key) == keep_min, o, key)
            d >>= 1
        k <<= 1
    return key


def _emulate(vals, coef, seg, kcap, scal, rows_per_cell, trace):
    """The kernel on one call's per-slot inputs (both entries load these
    per lane): vals/coef (R, F) f32, seg/kcap (C, F), scal (R, 4).
    Returns (R, F) f32 and fills ``trace``: for each (r, slot) the slots
    its rank was decided against and the slots its max ran over, and how
    often each output slot was written."""
    R, F = vals.shape
    rpb, warps = segfanin.geometry(F)
    W = -(-F // 32)
    S = W * 32
    items = rpb * W
    out = np.zeros((R, F), f32)
    writes = trace["writes"]
    blocks = -(-R // rpb)
    done = np.zeros((blocks, items), int)
    for blk in range(blocks):
        r0 = blk * rpb
        sv = np.full((rpb, S), np.nan, f32)
        ss = np.full((rpb, S), np.nan, f32)
        sfirst = np.zeros((rpb, W), np.uint64)
        slast = np.zeros((rpb, W), np.uint64)
        crossing = False
        for warp in range(warps):
            for it in range(warp, items, warps):
                rl, w = divmod(it, W)
                r = r0 + rl
                if r >= R:
                    break
                done[blk, it] += 1
                cc = r // rows_per_cell
                j = w * 32 + LANES
                live = j < F
                jl = np.minimum(j, F - 1)
                sid = np.where(live, seg[cc, jl], -1)
                v = np.where(live, vals[r, jl], f32(np.inf)).astype(f32)
                prev = np.where(j > 0, seg[cc, np.clip(j - 1, 0, F - 1)], -2)
                nxt = np.where(j + 1 < F, seg[cc, np.minimum(j + 1, F - 1)],
                               -2)
                first = live & ((j == 0) | (prev != sid))
                last = live & ((j == F - 1) | (nxt != sid))
                fw = int((first.astype(np.uint64) << LANES.astype(np.uint64))
                         .sum())
                lw = int((last.astype(np.uint64) << LANES.astype(np.uint64))
                         .sum())
                sfirst[rl, w], slast[rl, w] = fw, lw
                fb = np.array([fw & (FULL >> (31 - i)) for i in LANES])
                la = np.array([lw & ((FULL << i) & FULL) for i in LANES])
                inwin = live & (fb != 0) & (la != 0)
                sv[rl, j] = v
                crossing |= bool((live & ~inwin).any())
                if not inwin.any():
                    continue
                lo = np.array([int(b).bit_length() - 1 if b else 0
                               for b in fb])
                hi = np.array([(int(b) & -int(b)).bit_length() - 1 if b
                               else 31 for b in la])
                key = np.where(live, (lo.astype(np.uint64) << 40)
                               | (_ordered(v) << 8) | LANES.astype(np.uint64),
                               np.uint64(2**64 - 1))
                span = max((int(lo[i]) ^ int(hi[i])) if inwin[i] else 0
                           for i in LANES)
                K = 1 << span.bit_length() if span else 1
                key = _bitonic(key, K)
                vs = _from_ordered(key >> 8)
                y = np.array([_y(vs[p], coef[r, jl[p]], p - lo[p],
                                 *scal[r]) for p in LANES], f32)
                y = np.where(live, y, f32(-np.inf))
                for d in (1, 2, 4, 8, 16):
                    if d >= K:
                        break
                    o = y[np.maximum(LANES - d, 0)]
                    o = np.where(LANES >= d, o, y)
                    y = np.where(LANES - d >= lo, np.maximum(y, o), y)
                kc = np.where(live, kcap[cc, jl], 0)
                src = lo + np.minimum(np.maximum(kc, 0), hi - lo)
                m = y[src & 31]
                for i in np.nonzero(inwin)[0]:
                    out[r, j[i]] = m[i]
                    writes[r, j[i]] += 1
                    same = np.nonzero((lo == lo[i]) & live)[0]
                    trace["rank"][(r, int(j[i]))] = list(w * 32 + same)
                    trace["max"][(r, int(j[i]))] = list(
                        range(w * 32 + lo[i], w * 32 + src[i] + 1))
        if not crossing:
            continue
        cross = []
        for rl in range(rpb):
            r = r0 + rl
            if r >= R:
                break
            for jj in range(F):
                w, lane = divmod(jj, 32)
                if (int(sfirst[rl, w]) & (FULL >> (31 - lane))) and \
                        (int(slast[rl, w]) & ((FULL << lane) & FULL)):
                    continue
                b, ww = int(sfirst[rl, w]) & (FULL >> (31 - lane)), w
                while not b:
                    ww -= 1
                    b = int(sfirst[rl, ww])
                lo_ = ww * 32 + b.bit_length() - 1
                b, ww = int(slast[rl, w]) & ((FULL << lane) & FULL), w
                while not b:
                    ww += 1
                    b = int(slast[rl, ww])
                hi_ = ww * 32 + (b & -b).bit_length() - 1
                cross.append((rl, r, jj, lo_, hi_))
        for rl, r, jj, lo_, hi_ in cross:          # ranks
            row = sv[rl]
            ks = np.arange(lo_, hi_ + 1)
            rank = int(((row[ks] < row[jj])
                        | ((row[ks] == row[jj]) & (ks < jj))).sum())
            ss[rl, lo_ + rank] = row[jj]
            trace["rank"][(r, jj)] = list(ks)
        for rl, r, jj, lo_, hi_ in cross:          # y at each sorted slot
            sv[rl, jj] = _y(ss[rl, jj], coef[r, jj], jj - lo_, *scal[r])
        for rl, r, jj, lo_, hi_ in cross:          # capped prefix max
            cc = r // rows_per_cell
            e = lo_ + min(max(int(kcap[cc, jj]), 0), hi_ - lo_)
            out[r, jj] = sv[rl, lo_:e + 1].max()
            writes[r, jj] += 1
            trace["max"][(r, jj)] = list(range(lo_, e + 1))
    # every (row, window) of the call went to exactly one warp
    rows = np.arange(blocks)[:, None] * rpb + np.arange(items) // W
    assert np.array_equal(done, (rows < R).astype(int))
    return out


def _runs(seg_row):
    """Each slot's segment (the plain version's: runs of equal id)."""
    F = len(seg_row)
    start = np.ones(F, bool)
    start[1:] = seg_row[1:] != seg_row[:-1]
    lo = np.maximum.accumulate(np.where(start, np.arange(F), 0))
    end = np.ones(F, bool)
    end[:-1] = start[1:]
    hi = np.minimum.accumulate(np.where(end, np.arange(F), F)[::-1])[::-1]
    return lo, hi


def _per_slot_inputs(d):
    """What each lane of the grouped entry loads: the masked value, its
    group's B_r and cap, the per-cell scalars and the row's anchor."""
    C, B, F = d["arr"].shape
    vals = np.where(d["mask"], d["arr"], f32(np.inf)).reshape(C * B, F)
    coef = np.take_along_axis(
        d["B_r"], np.broadcast_to(d["grp"][:, None, :], (C, B, F)), 2) \
        .reshape(C * B, F)
    kcap = np.take_along_axis(d["kg"], d["grp"], 1)
    scal = np.stack([np.repeat(d["rm1"], B), np.repeat(d["md1"], B),
                     np.repeat(d["c"], B), d["L1"].reshape(-1)], 1)
    return vals, coef, d["grp"], kcap, scal.astype(f32)


@pytest.mark.parametrize("name,sizes,pad,F", LAYOUTS,
                         ids=[x[0] for x in LAYOUTS])
def test_kernel_model_matches_plain_version_and_splits_work(name, sizes, pad,
                                                            F):
    """The model of ``seg_fanin_sm90.cu`` equals the plain version bit for
    bit on both entries; every slot's rank is decided against exactly its
    own segment's slots, once each, its max runs inside its segment, and
    every output slot (and every group) is written once."""
    C, B = 2, 4 if F >= 1024 else 8
    d = _grouped_case(len(sizes) * 7 + F, sizes, pad, F, C=C, B=B)
    vals, coef, seg, kcap, scal = _per_slot_inputs(d)
    trace = {"rank": {}, "max": {}, "writes": np.zeros(vals.shape, int)}
    got = _emulate(vals, coef, seg, kcap, scal, B, trace)
    want = ref.seg_fanin_rows_ref(
        torch.from_numpy(vals), torch.from_numpy(coef),
        torch.from_numpy(seg).int(), torch.from_numpy(kcap).int(),
        torch.from_numpy(scal), B).numpy()
    np.testing.assert_array_equal(got, want)
    assert (trace["writes"] == 1).all()
    for r in range(C * B):
        lo, hi = _runs(seg[r // B])
        for j in range(F):
            assert trace["rank"][(r, j)] == list(range(lo[j], hi[j] + 1))
            span = trace["max"][(r, j)]
            assert span[0] == lo[j] and lo[j] <= span[-1] <= hi[j]
    # the grouped entry: m at each group's read slot, one write a group
    G = d["gstart"].shape[1]
    rpb, _ = segfanin.geometry(F)
    written = np.zeros((C * B, G), int)
    for blk in range(-(-(C * B) // rpb)):
        for t in range(rpb * G):
            rl, g = divmod(t, G)
            if blk * rpb + rl < C * B:
                written[blk * rpb + rl, g] += 1
    assert (written == 1).all()
    read = np.clip(d["gstart"], 0, F - 1)
    mg = np.take_along_axis(got.reshape(C, B, F),
                            np.broadcast_to(read[:, None, :], (C, B, G)), 2)
    a = _torch_groups(d)
    np.testing.assert_array_equal(
        mg, ref.seg_fanin_groups_ref(*a).numpy())


def test_kernel_model_on_per_slot_inputs():
    """The per-slot entry as chip_smoke drives it: segment-constant coef
    and caps, values with ties, a fully masked segment, -0 beside +0."""
    rng = np.random.default_rng(11)
    sizes = _ragged(90)
    F, C, B = sum(sizes), 3, 8
    seg = np.repeat(np.arange(len(sizes)), sizes)
    vals = (np.floor(rng.uniform(0, 8, (C * B, F))) / 8 - 0.5).astype(f32)
    vals[:, ::7] = f32(-0.0)
    vals[rng.uniform(size=vals.shape) < 0.1] = np.inf
    vals[:, seg == 2] = np.inf
    coef = rng.uniform(0, 1e-3, (C * B, len(sizes))).astype(f32)[:, seg]
    kcap = np.floor(rng.uniform(size=(C, len(sizes)))
                    * np.array(sizes)).astype(np.int32)[:, seg]
    scal = np.stack([-0.05 - 0.9 * rng.uniform(size=C * B),
                     3e-4 * rng.uniform(size=C * B), np.full(C * B, 2e-5),
                     np.ones(C * B)], 1).astype(f32)
    segc = np.repeat(seg[None], C, 0).astype(np.int32)
    trace = {"rank": {}, "max": {}, "writes": np.zeros(vals.shape, int)}
    got = _emulate(vals, coef, segc, kcap, scal, B, trace)
    want = segfanin.seg_fanin_rows(
        torch.from_numpy(vals), torch.from_numpy(coef),
        torch.from_numpy(segc), torch.from_numpy(kcap),
        torch.from_numpy(scal), B).numpy()
    np.testing.assert_array_equal(got, want)


# ------------------------------------------------- the step loop's route
def test_group_cell_grouped_route_equals_the_per_slot_route(monkeypatch):
    """The quick R=3 cell (60 clients, seed 0, quick windows) through the
    grouped fan-in and through the per-slot route it replaced
    (``ops.seg_fanin``, then a gather at clamp(gstart, 0, F - 1)): the
    same results, bit for bit."""
    kw = dict(pig=PigConfig(n_groups=3, prc=1), clients=(60,), seeds=(0,),
              duration=0.25, warmup=0.25, device="cpu")
    calls = {"grouped": 0, "per-slot": 0}
    real = ops.seg_fanin_groups

    def grouped(*a, **k):
        calls["grouped"] += 1
        return real(*a, **k)
    monkeypatch.setattr(ops, "seg_fanin_groups", grouped)
    a = vectorsim.simulate_scenario("pigpaxos", 25, **kw)

    def per_slot(grp, gstart, sizes, kg, B, plain=False):
        calls["per-slot"] += 1
        C, F = grp.shape
        grp_b = grp[:, None, :].expand(C, B, F)
        kcap32 = torch.gather(kg, 1, grp).to(torch.int32)
        gread = torch.clamp(gstart, 0, F - 1)[:, None, :].expand(C, B, -1)

        def step(arr_back, peer_mask, B_r, rm1, md1, c_repl, L1):
            m = ops.seg_fanin(torch.where(peer_mask, arr_back, torch.inf),
                              torch.gather(B_r, 2, grp_b),
                              grp.to(torch.int32), kcap32, rm1, md1, c_repl,
                              L1)
            return torch.gather(m, 2, gread)
        return step
    monkeypatch.setattr(ops, "seg_fanin_groups", per_slot)
    b = vectorsim.simulate_scenario("pigpaxos", 25, **kw)
    assert calls == {"grouped": 1, "per-slot": 1}
    assert a == b and a[0]["count"] > 0
