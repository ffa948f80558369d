"""The port's segmented fan-in against the JAX reference, on the CPU.

``repro_torch.kernels.ops.seg_fanin`` on a CPU tensor runs the plain
PyTorch version (two stable sorts + the log-step segmented cummax); it is
held against ``repro.kernels.ref.seg_fanin_ref`` (the lax oracle) and
``repro.kernels.ops.seg_fanin`` (the Pallas kernel in interpret mode, as
``tests/test_kernels.py`` runs it) at rtol/atol 1e-6 — measured: equal bit
for bit on every case here.  The CUDA kernel itself runs only on the card
(``tests/test_torch_cuda.py``; ``chip_smoke.py`` holds it to bit equality
there)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import build, ops, ref, segfanin

# the CPU step loop is bound by per-operation overhead, not arithmetic:
# one intra-op thread is faster here and leaves the other test
# workers their cores
torch.set_num_threads(1)

_jref = jax.jit(jref.seg_fanin_ref)


def _fanin_case(seed, B, G, gsize, mask_per_seg=0):
    """A vectorsim-shaped burst from numpy: F = G*gsize contiguous slots,
    segment-constant coef/kcap, optionally one +inf slot per segment."""
    rng = np.random.default_rng(seed)
    F = G * gsize
    vals = rng.uniform(1.0, 2.0, (B, F)).astype(np.float32)
    segid = np.repeat(np.arange(G), gsize).astype(np.int32)
    coef = np.repeat(rng.uniform(0.0, 1e-3, (B, G)).astype(np.float32),
                     gsize, axis=1)
    kcap = np.repeat(rng.integers(0, gsize - mask_per_seg, G),
                     gsize).astype(np.float32)
    if mask_per_seg:
        drop = rng.integers(0, gsize, G)
        vals[:, drop + np.arange(G) * gsize] = np.inf
    anchor = np.full(B, 1.0, np.float32)
    return vals, coef, segid, kcap, -0.5, 3e-4, 2e-5, anchor


def _jax(args):
    return [jnp.asarray(a) if isinstance(a, np.ndarray) else a for a in args]


def _torch(args):
    return [torch.from_numpy(a) if isinstance(a, np.ndarray) else a
            for a in args]


@pytest.mark.parametrize("B,G,gsize", [
    (1, 1, 4),        # single segment
    (8, 4, 6),        # N=25, R=4
    (8, 8, 16),       # wide
    (3, 5, 7),        # odd everything
    (8, 32, 32),      # the N=1025/R=32 burst row
])
@pytest.mark.parametrize("mask", [0, 1])
def test_seg_fanin_vs_reference(B, G, gsize, mask):
    args = _fanin_case(B * 100 + G * 10 + gsize, B, G, gsize, mask)
    got = ops.seg_fanin(*_torch(args)).numpy()
    np.testing.assert_allclose(got, np.asarray(_jref(*_jax(args))),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got, np.asarray(jops.seg_fanin(*_jax(args))),
                               rtol=1e-6, atol=1e-6)


def test_seg_fanin_ties_match_stable_sort():
    """Duplicate values: the (value, index) tie-break equals lax.sort's
    stable order, so rank-dependent outputs agree exactly."""
    B, G, gsize = 4, 3, 5
    vals = np.tile(np.array([1.5, 1.25, 1.5, 1.25, 1.5], np.float32), (B, G))
    segid = np.repeat(np.arange(G), gsize).astype(np.int32)
    coef = np.zeros((B, G * gsize), np.float32)
    kcap = np.full(G * gsize, 2.0, np.float32)
    args = (vals, coef, segid, kcap, -0.5, 3e-4, 2e-5,
            np.ones(B, np.float32))
    got = ops.seg_fanin(*_torch(args)).numpy()
    np.testing.assert_array_equal(got, np.asarray(_jref(*_jax(args))))
    np.testing.assert_array_equal(got, np.asarray(jops.seg_fanin(*_jax(args))))


def test_seg_fanin_empty_admissible_set_is_neg_inf():
    """A fully masked segment gives -inf, as the Pallas kernel does."""
    B, F = 2, 6
    vals = np.where(np.arange(F)[None, :] < 3, np.inf,
                    np.ones((B, F), np.float32)).astype(np.float32)
    args = (vals, np.zeros((B, F), np.float32),
            np.repeat(np.arange(2), 3).astype(np.int32),
            np.ones(F, np.float32), -0.5, 0.0, 1e-5, np.ones(B, np.float32))
    got = ops.seg_fanin(*_torch(args)).numpy()
    assert np.all(np.isneginf(got[:, :3]))
    assert np.all(np.isfinite(got[:, 3:]))
    np.testing.assert_array_equal(got, np.asarray(jops.seg_fanin(*_jax(args))))


def test_seg_fanin_batched_over_cells_equals_per_cell():
    """The (C, B, F) form with per-cell scalars and per-cell segid/kcap
    equals C separate calls of the reference signature."""
    cases = [_fanin_case(s, 8, 4, 6, 1) for s in range(3)]
    stack = [torch.from_numpy(np.stack([c[i] for c in cases]))
             for i in (0, 1, 2, 3)]
    vcoef = torch.tensor([-0.5, -0.3, -0.9])
    got = ops.seg_fanin(*stack, vcoef, torch.full((3,), 3e-4),
                        torch.full((3,), 2e-5),
                        torch.from_numpy(np.stack([c[7] for c in cases])))
    for ci, c in enumerate(cases):
        one = ops.seg_fanin(*_torch(c[:4]), float(vcoef[ci]), *c[5:7],
                            torch.from_numpy(c[7]))
        assert torch.equal(got[ci], one)


@settings(max_examples=20, deadline=None)
@given(st.integers(1, 4), st.lists(st.integers(2, 9), min_size=1,
                                   max_size=5), st.integers(0, 10 ** 6))
def test_seg_fanin_property(B, sizes, salt):
    """Random ragged segment layouts: the port equals the lax oracle."""
    rng = np.random.default_rng(salt)
    F = sum(sizes)
    sizes_a = np.asarray(sizes)
    segid = np.repeat(np.arange(len(sizes)), sizes).astype(np.int32)
    vals = rng.uniform(0.5, 1.5, (B, F)).astype(np.float32)
    coef = np.repeat(rng.uniform(0.0, 1e-3, (B, len(sizes))).astype(
        np.float32), sizes, axis=1)
    kcap = np.minimum(np.repeat(rng.integers(0, 3, len(sizes)), sizes),
                      np.repeat(sizes_a, sizes) - 1).astype(np.float32)
    args = (vals, coef, segid, kcap, -0.3, 1e-4, 3e-5,
            np.full(B, 0.5, np.float32))
    np.testing.assert_allclose(ops.seg_fanin(*_torch(args)).numpy(),
                               np.asarray(_jref(*_jax(args))),
                               rtol=1e-6, atol=1e-6)


def test_cpu_call_never_builds_or_counts(monkeypatch):
    """A CPU tensor takes the plain version: no build, no kernel launch."""
    def refuse(*a, **k):
        raise AssertionError("the CPU path touched the CUDA build")
    monkeypatch.setattr(build, "build", refuse)
    monkeypatch.setattr(build, "load", refuse)
    monkeypatch.setattr(segfanin, "launches", 0)
    args = _fanin_case(5, 8, 3, 8, 1)
    out = ops.seg_fanin(*_torch(args))
    assert out.device.type == "cpu"
    assert segfanin.launches == 0


def test_rows_wrapper_is_the_plain_version_on_cpu():
    args = _fanin_case(9, 8, 4, 6, 1)
    vals, coef, segid, kcap = _torch(args[:4])
    scal = torch.tensor([[-0.5, 3e-4, 2e-5, 1.0]] * 8)
    got = segfanin.seg_fanin_rows(vals, coef, segid[None].int(),
                                  kcap[None].int(), scal, 8)
    assert torch.equal(got, ref.seg_fanin_rows_ref(
        vals, coef, segid[None], kcap[None], scal, 8))
    assert torch.equal(got, ops.seg_fanin(*_torch(args)))


def test_rows_wrapper_rejects_other_devices():
    t = torch.empty(8, 6, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        segfanin.seg_fanin_rows(t, t, t, t, t, 8)


def test_shared_memory_limit_is_checked_before_launch():
    assert segfanin.smem_bytes(1024) <= segfanin.SMEM_LIMIT
    assert segfanin.smem_bytes(4096) > segfanin.SMEM_LIMIT


def test_build_digest_covers_source_and_flags():
    path = build.library_path("seg_fanin")
    assert path.parent == build.BUILD_DIR
    assert path.name.startswith("libseg_fanin-") and path.suffix == ".so"
    assert "-fmad=false" in build.NVCC_FLAGS
    assert "arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS
