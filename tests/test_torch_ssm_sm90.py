"""The sm90 chunked-scan kernel's arithmetic and its dispatch rule, on the
CPU.

``csrc/ssm_scan_sm90.cu`` runs only on the card, so its arithmetic is
rehearsed here by a rounding model kept in this file: the sequence in
64-row tiles of four 16-row chunks (rows past T zero), each tile's
chunk-local work first (the cumulative decay row by row, the factors
q e^A, k e^-A, k e^{Atot-A} (as e^{Atot} e^{-A}) and e^{Atot}, the masked
scores with the bonus diagonal on them), then the chain over its chunks,
split into the product dS = (k e^{Atot-A})^T v and the elementwise step
S = e^{Atot} S + dS (one rounding, as the kernel's FMA).  Every product
takes its f32 operands as TF32 hi + lo (hi = x rounded to TF32 to nearest,
ties away from zero; lo = the rest rounded the same way) and sums
hi.hi + hi.lo + lo.hi, as the kernel's three mma passes do.

The model is held against the JAX package's Pallas kernel in interpret
mode (``repro.kernels.ops.ssm_scan`` as ``tests/test_kernels.py`` runs it)
at its own tolerance (rtol = atol = 2e-4), and against a float64
recurrence (1e-4, as ``tests/test_torch_ssm_scan.py``), with and without
the bonus, at ragged T and T < 16; at RWKV's clamped decays it stays
within ``chip_smoke.SSM_REL`` and a state relative L2 of 1e-6
(``RWKV_STATE_REL``) of the plain version where one TF32 pass does not."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import ref, ssm_scan

torch.set_num_threads(1)

C, TILE = 16, 64                 # rows a chunk and a tile of the kernel
SSM_REL = 2e-4                   # chip_smoke.SSM_REL
STATE_REL = 1e-6                 # chip_smoke.RWKV_STATE_REL


def tf32(x: torch.Tensor) -> torch.Tensor:
    """f32 rounded to TF32 (10 fraction bits), to nearest with ties away
    from zero: cvt.rna.tf32.f32."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split(x: torch.Tensor):
    hi = tf32(x)
    return hi, tf32(x - hi)


def mm3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b in three TF32 passes, the cross terms summed apart and added
    to hi.hi last, in f32."""
    ah, al = split(a)
    bh, bl = split(b)
    return ah @ bh + (al @ bh + ah @ bl)


def mm1(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b in one TF32 pass."""
    return tf32(a) @ tf32(b)


PASSES = {"3xtf32": mm3, "tf32": mm1, "f32": torch.matmul}


def sm90_model(q, k, v, log_a, u=None, s0=None, passes="3xtf32",
               out_dtype=None):
    """The sm90 kernel's arithmetic: q/k/log_a (B, T, H, Dk), v (B, T, H,
    Dv), u (H, Dk) or None, s0 (B, H, Dk, Dv) or None.  Returns y (B, T, H,
    Dv) in ``out_dtype`` (default v's) and the final f32 state."""
    mm = PASSES[passes]
    f32 = torch.float32
    B, T, H, Dk = q.shape
    Dv = v.shape[-1]
    pad = (-T) % TILE
    # (B, H, T + pad, D) in f32, rows past T zero (the kernel's zero fill)
    heads = lambda a: torch.nn.functional.pad(
        a.to(f32), (0, 0, 0, 0, 0, pad)).transpose(1, 2)
    qf, kf, vf, la = heads(q), heads(k), heads(v), heads(log_a)
    S = (torch.zeros(B, H, Dk, Dv) if s0 is None else s0.to(f32)).clone()
    y = torch.zeros(B, H, T + pad, Dv)
    idx = torch.arange(C)
    mask = idx[None, :] < idx[:, None] if u is not None else \
        idx[None, :] <= idx[:, None]
    for t0 in range(0, T, TILE):
        # phase L: the tile's chunk-local work, (B, H, 4, 16, D)
        rows = lambda a: a[:, :, t0:t0 + TILE].unflatten(2, (TILE // C, C))
        qc, kc, vc, lc = rows(qf), rows(kf), rows(vf), rows(la)
        A = torch.cumsum(lc, dim=3)
        Atot = A[:, :, :, -1:]
        qe = qc * torch.exp(A)
        ena = torch.exp(-A)
        ke = kc * ena
        kst = kc * (torch.exp(Atot) * ena)     # e^{Atot-A}: e^{Atot} e^{-A}
        ea = torch.exp(Atot)[:, :, :, 0]                   # (B, H, 4, Dk)
        sc = torch.where(mask, mm(qe, ke.transpose(-1, -2)), 0.0)
        if u is not None:
            diag = (qc * u.to(f32)[None, :, None, None] * kc).sum(-1)
            sc = sc + torch.diag_embed(diag)
        # phase C: the chain over the tile's chunks
        for c in range(TILE // C):
            if t0 + C * c >= T:
                break
            y[:, :, t0 + C * c:t0 + C * (c + 1)] = (
                mm(sc[:, :, c], vc[:, :, c]) + mm(qe[:, :, c], S))
            dS = mm(kst[:, :, c].transpose(-1, -2), vc[:, :, c])
            S = torch.addcmul(dS.double(), S.double(),
                              ea[:, :, c, :, None].double()).float()
    y = y[:, :, :T].transpose(1, 2)
    return y.to(v.dtype if out_dtype is None else out_dtype), S


def _inputs(seed, B, T, H, Dk, Dv, bonus, state, rwkv=False):
    """q, k, v ~ 0.3 N; log_a the reference tests' -(0.5 |N| + 0.01) or
    RWKV's clamp(-exp(0.5 + 5 N), -2.3, -1e-4); u ~ 0.1 N; s0 ~ 0.5 N:
    numpy f32."""
    rng = np.random.default_rng(seed)
    n = lambda *s: rng.standard_normal(s).astype(np.float32)
    q, k, v = n(B, T, H, Dk) * 0.3, n(B, T, H, Dk) * 0.3, n(B, T, H, Dv) * 0.3
    if rwkv:
        la = np.clip(-np.exp(0.5 + 5 * n(B, T, H, Dk)), -2.3, -1e-4)
    else:
        la = -np.abs(n(B, T, H, Dk)) * 0.5 - 0.01
    u = n(H, Dk) * 0.1 if bonus else None
    s0 = n(B, H, Dk, Dv) * 0.5 if state else None
    return q, k, v, la.astype(np.float32), u, s0


def _t(a):
    return None if a is None else torch.from_numpy(a)


def _recurrence(q, k, v, la, u=None, s0=None):
    """Step by step in float64: S_t = a_t S_{t-1} + k_t v_t^T; y_t = q_t S_t
    (inclusive) or q_t (a_t S_{t-1}) + (q_t . (u k_t)) v_t (bonus)."""
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


@pytest.mark.parametrize("B,T,H,Dv,bonus,state", [
    (1, 128, 2, 64, True, True),      # two whole tiles, RWKV mode
    (2, 100, 2, 64, True, True),      # ragged T: a tile of 36 rows
    (1, 5, 3, 64, True, False),       # T < 16: one part-chunk
    (1, 96, 2, 128, False, True),     # the inclusive mask, two column blocks
    (2, 37, 1, 64, False, False),     # ragged, no bonus, no s0
])
def test_model_matches_pallas_kernel_and_float64(B, T, H, Dv, bonus, state):
    Dk = 64
    q, k, v, la, u, s0 = _inputs(T + Dv, B, T, H, Dk, Dv, bonus, state)
    y, S = sm90_model(*map(_t, (q, k, v, la)), u=_t(u), s0=_t(s0))
    want_y, want_s = _recurrence(q, k, v, la, u, s0)
    np.testing.assert_allclose(y.numpy(), want_y, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(S.numpy(), want_s, rtol=1e-4, atol=1e-4)
    if s0 is None:      # the Pallas kernel starts from a zero state
        jy = jops.ssm_scan(*map(jnp.asarray, (q, k, v, la)),
                           u=None if u is None else jnp.asarray(u), chunk=C)
        np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=2e-4,
                                   atol=2e-4)


@pytest.mark.parametrize("bonus", [True, False])
def test_model_matches_pallas_kernel_from_zero_state(bonus):
    """Whole tiles and a ragged tail from a zero state, against the Pallas
    kernel itself (the case above with s0 checks the float64 recurrence)."""
    q, k, v, la, u, _ = _inputs(11, 2, 150, 2, 64, 64, bonus, False)
    y, _ = sm90_model(*map(_t, (q, k, v, la)), u=_t(u))
    jy = jops.ssm_scan(*map(jnp.asarray, (q, k, v, la)),
                       u=None if u is None else jnp.asarray(u), chunk=C)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=2e-4,
                               atol=2e-4)


def test_bf16_inputs_round_y_once():
    """bf16 q, k, v (exact in TF32): y is the f32 model's y rounded once to
    bf16, and the state is f32."""
    q, k, v, la, u, s0 = _inputs(3, 1, 48, 2, 64, 64, True, True)
    tq, tk, tv = (_t(a).to(torch.bfloat16) for a in (q, k, v))
    y, S = sm90_model(tq, tk, tv, _t(la), u=_t(u), s0=_t(s0))
    y32, S32 = sm90_model(tq.float(), tk.float(), tv.float(), _t(la),
                          u=_t(u), s0=_t(s0))
    assert y.dtype == torch.bfloat16 and S.dtype == torch.float32
    assert torch.equal(y, y32.to(torch.bfloat16)) and torch.equal(S, S32)


def test_3xtf32_holds_the_bounds_where_one_tf32_pass_does_not():
    """Why the kernel splits every f32 operand, at RWKV's clamped decays
    (T 1024, Dk = Dv 64, bf16-rounded q, k, v, u and s0 as rwkv6-3b's
    prefill has them), against the plain version in f32: with one TF32
    pass (2^-11 relative an operand) y leaves phase 14's tolerance
    2e-4 max(1, max|plain|) and the state leaves the layer check's relative
    L2 of 1e-6; three passes (~2^-22 an operand) stay well inside both."""
    q, k, v, la, u, s0 = _inputs(5, 1, 1024, 2, 64, 64, True, True,
                                 rwkv=True)
    tq, tk, tv = (_t(a).to(torch.bfloat16).float() for a in (q, k, v))
    args = (tq, tk, tv, _t(la))
    want_y, want_s = ref.ssm_scan_ref(*args, u=_t(u), chunk=C, s0=_t(s0),
                                      return_state=True)
    tol = SSM_REL * max(1.0, want_y.abs().max().item())

    def off(passes):
        y, S = sm90_model(*args, u=_t(u), s0=_t(s0), passes=passes)
        rel = ((S - want_s).norm() / want_s.norm()).item()
        return (y - want_y).abs().max().item() / tol, rel

    y3, s3 = off("3xtf32")
    y1, s1 = off("tf32")
    assert y3 < 0.05 and s3 < 0.1 * STATE_REL, (y3, s3)
    assert y1 > 1.0 and s1 > STATE_REL, (y1, s1)


def test_tf32_rounds_to_nearest_ties_away():
    one = 1.0 + 2.0 ** -10                       # one TF32 ulp above 1
    x = torch.tensor([1.0 + 2.0 ** -11, 1.0 + 2.0 ** -11 - 2.0 ** -20,
                      -(1.0 + 2.0 ** -11), one, 3.0e-3], dtype=torch.float32)
    got = tf32(x)
    assert got[:4].tolist() == [one, 1.0, -one, one]
    hi, lo = split(x)
    assert torch.equal(hi + lo, x)             # exact for these values


# ------------------------------------------------------------ the dispatch
@pytest.mark.parametrize("dtype,Dk,Dv,chunk,sm90", [
    (torch.bfloat16, 64, 64, 16, True),      # rwkv6's prefill
    (torch.float32, 64, 64, 16, True),       # its f32 copy
    (torch.bfloat16, 64, 128, 16, True),     # two column blocks
    (torch.bfloat16, 64, 16, 16, False),     # Dv not a multiple of 64
    (torch.bfloat16, 64, 96, 16, False),
    (torch.bfloat16, 32, 64, 16, False),     # Dk 32
    (torch.float32, 16, 64, 16, False),
    (torch.bfloat16, 64, 64, 32, False),     # chunk 32
    (torch.float32, 64, 64, 64, False),      # chunk 64 (Mamba2's default)
    (torch.float16, 64, 64, 16, False),      # a dtype no kernel takes
])
def test_dispatch_rule(dtype, Dk, Dv, chunk, sm90):
    assert ssm_scan.uses_sm90(dtype, Dk, Dv, chunk) is sm90


def test_cpu_never_launches():
    q, k, v, la, u, s0 = _inputs(2, 1, 40, 2, 64, 64, True, True)
    n0, n90 = ssm_scan.launches, ssm_scan.launches_sm90
    y, s = ssm_scan.ssm_scan(*map(_t, (q, k, v, la)), u=_t(u), chunk=C,
                             s0=_t(s0), return_state=True)
    assert (ssm_scan.launches, ssm_scan.launches_sm90) == (n0, n90)
    my, ms = sm90_model(*map(_t, (q, k, v, la)), u=_t(u), s0=_t(s0))
    np.testing.assert_allclose(y.numpy(), my.numpy(), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(s.numpy(), ms.numpy(), rtol=1e-5, atol=1e-5)
