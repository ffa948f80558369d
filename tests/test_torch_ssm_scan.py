"""The port's chunked scan against the JAX package, on the CPU.

``repro_torch.kernels.ops.ssm_scan`` on a CPU tensor runs the plain
version (``ref.ssm_scan_ref`` -> ``models.ssm.chunked_linear_scan``); it is
held against ``repro.kernels.ops.ssm_scan`` and ``ssm_scan_bhtd(...,
interpret=True)``, the Pallas kernel in interpret mode as
``tests/test_kernels.py`` runs it, at that file's shapes and its bonus case,
rtol = atol = 2e-4 (the reference's own tolerance between its kernel and
its oracle).  The state (``s0`` in, ``return_state``) is held against
``repro.models.ssm.chunked_linear_scan`` at rtol = atol = 1e-5 (the same
algorithm in f32, summed in other orders), and everything against a float64
step-by-step recurrence in numpy at 1e-4 (f32 rounding over 100-odd steps
of |y| ~ 1).  The CUDA kernel runs only on the card
(``tests/test_torch_cuda.py`` and ``chip_smoke.py``)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels.ssm_scan import ssm_scan_bhtd
from repro.models import ssm as jssm
from repro_torch.kernels import ops, ref, ssm_scan
from repro_torch.models import ssm

torch.set_num_threads(1)

SHAPES = [(1, 128, 2, 64, 64, 32), (2, 96, 4, 64, 64, 32),
          (1, 100, 1, 32, 64, 32), (2, 64, 2, 16, 64, 16)]


def _inputs(seed, B, T, H, Dk, Dv, scalar_decay=False, bonus=False,
            state=False):
    """q, k, v ~ 0.3 N(0, 1); log_a = -(0.5 |N| + 0.01) (the reference
    tests' decays); u ~ 0.1 N; s0 ~ 0.5 N: numpy arrays in f32."""
    rng = np.random.default_rng(seed)
    n = lambda *s: rng.standard_normal(s).astype(np.float32)
    q, k = n(B, T, H, Dk) * 0.3, n(B, T, H, Dk) * 0.3
    v = n(B, T, H, Dv) * 0.3
    la = -np.abs(n(B, T, H, Dk)) * 0.5 - 0.01
    if scalar_decay:
        la = np.broadcast_to(la[..., :1], la.shape).copy()
    u = n(H, Dk) * 0.1 if bonus else None
    s0 = n(B, H, Dk, Dv) * 0.5 if state else None
    return q, k, v, la, u, s0


def _t(a):
    return None if a is None else torch.from_numpy(a)


def _j(a):
    return None if a is None else jnp.asarray(a)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _recurrence(q, k, v, la, u=None, s0=None):
    """y_t = q_t . S_t (inclusive) or q_t . (a_t S_{t-1}) + (q_t . (u k_t))
    v_t (bonus), S_t = a_t S_{t-1} + k_t v_t^T, step by step in float64."""
    q, k, v, la = (np.asarray(a, np.float64) for a in (q, k, v, la))
    B, T, H, Dk = q.shape
    S = (np.zeros((B, H, Dk, v.shape[-1])) if s0 is None
         else np.asarray(s0, np.float64).copy())
    y = np.zeros(v.shape)
    for t in range(T):
        a = np.exp(la[:, t])[..., None]
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]
        if u is None:
            S = S * a + kv
            y[:, t] = np.einsum("bhd,bhdv->bhv", q[:, t], S)
        else:
            y[:, t] = np.einsum("bhd,bhdv->bhv", q[:, t], S * a) + np.einsum(
                "bhd,bhd->bh", q[:, t], u * k[:, t])[..., None] * v[:, t]
            S = S * a + kv
    return y, S


@pytest.mark.parametrize("B,T,H,Dk,Dv,chunk", SHAPES)
@pytest.mark.parametrize("scalar_decay", [True, False])
def test_ssm_scan_matches_pallas_kernel(B, T, H, Dk, Dv, chunk,
                                        scalar_decay):
    q, k, v, la, _, _ = _inputs(2, B, T, H, Dk, Dv, scalar_decay)
    want = jops.ssm_scan(*map(_j, (q, k, v, la)), chunk=chunk)
    n0 = ssm_scan.launches
    got = ops.ssm_scan(*map(_t, (q, k, v, la)), chunk=chunk)
    assert ssm_scan.launches == n0             # the CPU never launches
    assert got.shape == (B, T, H, Dv) and got.dtype == torch.float32
    np.testing.assert_allclose(_np(got), _np(want), rtol=2e-4, atol=2e-4)


def test_ssm_scan_bonus_matches_pallas_kernel():
    """RWKV6 mode: the strict mask plus the bonus u."""
    q, k, v, la, u, _ = _inputs(3, 1, 64, 2, 32, 32, bonus=True)
    want = jops.ssm_scan(*map(_j, (q, k, v, la)), u=_j(u), chunk=16)
    got = ops.ssm_scan(*map(_t, (q, k, v, la)), u=_t(u), chunk=16)
    np.testing.assert_allclose(_np(got), _np(want), rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("bonus", [False, True])
def test_bhtd_helper_matches_pallas_bhtd(bonus):
    """``ref.ssm_scan_bhtd_ref`` against ``ssm_scan_bhtd`` directly, each
    of the BH rows with its own u."""
    BH, T, D, chunk = 6, 64, 32, 16
    q, k, v, la, _, _ = _inputs(4, 1, T, BH, D, D)
    rows = lambda a: np.ascontiguousarray(a[0].transpose(1, 0, 2))
    q, k, v, la = map(rows, (q, k, v, la))
    u = (np.random.default_rng(5).standard_normal((BH, D)) * 0.1).astype(
        np.float32) if bonus else None
    want = ssm_scan_bhtd(*map(_j, (q, k, v, la)), _j(u), chunk=chunk,
                         interpret=True)
    got = ref.ssm_scan_bhtd_ref(*map(_t, (q, k, v, la)), _t(u), chunk=chunk)
    np.testing.assert_allclose(_np(got), _np(want), rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("scalar_decay,bonus", [
    (False, True), (False, False), (True, False)])
def test_chunked_linear_scan_with_state_matches_jax(scalar_decay, bonus):
    """Both branches (per-channel decay, and a scalar decay per head
    evaluated unfactored), an initial state in and the final state out."""
    B, T, H, Dk, Dv, chunk = 2, 64, 3, 16, 32, 16
    q, k, v, la, u, s0 = _inputs(6, B, T, H, Dk, Dv, bonus=bonus,
                                 state=True)
    if scalar_decay:
        la = la[..., 0]
    wy, ws = jssm.chunked_linear_scan(*map(_j, (q, k, v, la)), chunk,
                                      bonus=_j(u), s0=_j(s0),
                                      return_state=True)
    gy, gs = ssm.chunked_linear_scan(*map(_t, (q, k, v, la)), chunk,
                                     bonus=_t(u), s0=_t(s0),
                                     return_state=True)
    assert gs.dtype == torch.float32 and gs.shape == (B, H, Dk, Dv)
    np.testing.assert_allclose(_np(gy), _np(wy), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(_np(gs), _np(ws), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("bonus,T", [(True, 64), (True, 37), (False, 37)])
def test_ssm_scan_matches_the_float64_recurrence(bonus, T):
    """The model-layout entry point (T padded to the chunk, the padded
    steps leaving the state unchanged) against the step-by-step recurrence
    in float64, y and the final state."""
    B, H, D, chunk = 2, 2, 32, 16
    q, k, v, la, u, s0 = _inputs(7, B, T, H, D, D, bonus=bonus, state=True)
    want_y, want_s = _recurrence(q, k, v, la, u, s0)
    got_y, got_s = ops.ssm_scan(*map(_t, (q, k, v, la)), u=_t(u),
                                chunk=chunk, s0=_t(s0), return_state=True)
    assert got_y.shape == (B, T, H, D)
    np.testing.assert_allclose(_np(got_y), want_y, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(_np(got_s), want_s, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("scalar_decay,bonus", [
    (False, True), (False, False), (True, False)])
def test_linear_scan_step_matches_jax(scalar_decay, bonus):
    B, H, Dk, Dv = 2, 3, 16, 32
    q, k, v, la, u, s0 = _inputs(8, B, 1, H, Dk, Dv, bonus=bonus, state=True)
    q, k, v, la = (a[:, 0] for a in (q, k, v, la))
    if scalar_decay:
        la = la[..., 0]
    ws, wy = jssm.linear_scan_step(*map(_j, (s0, q, k, v, la)), bonus=_j(u))
    gs, gy = ssm.linear_scan_step(*map(_t, (s0, q, k, v, la)), bonus=_t(u))
    np.testing.assert_allclose(_np(gy), _np(wy), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(_np(gs), _np(ws), rtol=1e-6, atol=1e-6)


def test_bf16_inputs_give_bf16_output_and_f32_state():
    """RWKV's prefill types: q, k, v bf16, log_a, u and s0 f32; y comes back
    in v's dtype and equals the f32 computation on the bf16 values, rounded
    once."""
    q, k, v, la, u, s0 = _inputs(9, 1, 48, 2, 64, 64, bonus=True, state=True)
    tq, tk, tv = (_t(a).to(torch.bfloat16) for a in (q, k, v))
    y, s = ops.ssm_scan(tq, tk, tv, _t(la), u=_t(u), chunk=16, s0=_t(s0),
                        return_state=True)
    y32, s32 = ops.ssm_scan(tq.float(), tk.float(), tv.float(), _t(la),
                            u=_t(u), chunk=16, s0=_t(s0), return_state=True)
    assert y.dtype == torch.bfloat16 and s.dtype == torch.float32
    assert torch.equal(y, y32.to(torch.bfloat16))
    assert torch.equal(s, s32)
