"""Launch wrappers of the Hopper threefry kernels that make the batch step
loops' draw blocks (``csrc/threefry_draws_sm90.cu``).

``group_draws(key, i0, n, B, n_draw, G, read)`` returns what
``ref.group_draws_ref`` returns: for the cells' keys (C, 2) and the steps
[i0, i0 + n), the exponential draws (C, n, B, n_draw), the uniform relay
draws (C, n, B, G) and, with ``read``, the read mask's uniforms (C, n, B),
f32.  ``epaxos_draws(key, i0, b, n)`` returns what ``ref.epaxos_draws_ref``
returns: the EPaxos loop's coordinators (C, b) int64 and its draws (C, b,
2), (C, b, n), (C, b, n) and (C, b).  A CPU tensor, or ``plain=True``,
goes to the plain version; a CUDA tensor launches the kernel or raises.
The kernels' words equal the plain versions' bit for bit.
``launches_sm90`` counts the launches of both and nothing else.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import build
from .ref import epaxos_draws_ref, group_draws_ref
from .segfanin import INT32_MAX, _stream

launches_sm90 = 0


@functools.cache
def _lib():
    lib = build.load("threefry_draws_sm90")
    lib.threefry_draws_sm90_launch.argtypes = [ctypes.c_void_p] * 4 \
        + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    lib.threefry_epaxos_draws_sm90_launch.argtypes = [ctypes.c_void_p] * 6 \
        + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    lib.threefry_draws_sm90_exp_launch.argtypes = [ctypes.c_void_p] * 2 \
        + [ctypes.c_int, ctypes.c_void_p]
    for fn in (lib.threefry_draws_sm90_launch,
               lib.threefry_epaxos_draws_sm90_launch,
               lib.threefry_draws_sm90_exp_launch):
        fn.restype = ctypes.c_int
    return lib


def _check_key(name: str, key: torch.Tensor) -> None:
    if key.dtype != torch.int64:
        raise TypeError(f"{name}: key must be torch.int64, got {key.dtype}")
    if key.dim() != 2 or key.shape[1] != 2:
        raise ValueError(f"{name}: key has shape {tuple(key.shape)}, "
                         f"expected (C, 2)")
    if not key.is_contiguous():
        raise ValueError(f"{name}: key is not contiguous")


def group_draws(key: torch.Tensor, i0: int, n: int, B: int, n_draw: int,
                G: int, read: bool = False, plain: bool = False):
    """The draw block of steps [i0, i0 + n) for every cell's key (C, 2)
    int64 (uint32 values): (e, u, r) as ``ref.group_draws_ref`` defines
    them, r None without ``read``; on the card one launch of
    ``csrc/threefry_draws_sm90.cu``."""
    if plain or key.device.type == "cpu":
        return group_draws_ref(key, i0, n, B, n_draw, G, read)
    if key.device.type != "cuda":
        raise ValueError(f"group_draws: unsupported device {key.device}")
    _check_key("group_draws", key)
    C = key.shape[0]
    words = (B * n_draw, B * G, B if read else 0)
    if min(i0, n, *words) < 0 or i0 + n > INT32_MAX or C * n > INT32_MAX \
            or max(words) > INT32_MAX:
        raise ValueError(f"group_draws: steps [{i0}, {i0 + n}) of {C} "
                         f"cells x {max(words)} words overflow int32")
    new = lambda *shape: torch.empty(shape, dtype=torch.float32,
                                     device=key.device)
    e, u = new(C, n, B, n_draw), new(C, n, B, G)
    r = new(C, n, B) if read else None
    if C * n == 0:
        return e, u, r
    with torch.cuda.device(key.device):
        err = _lib().threefry_draws_sm90_launch(
            key.data_ptr(), e.data_ptr(), u.data_ptr(),
            None if r is None else r.data_ptr(), C, n, i0, *words,
            _stream(key.device))
    if err:
        raise RuntimeError(f"threefry_draws_sm90 kernel launch failed: CUDA "
                           f"error {err}")
    global launches_sm90
    launches_sm90 += 1
    return e, u, r


def epaxos_draws(key: torch.Tensor, i0: int, b: int, n: int,
                 plain: bool = False):
    """The EPaxos draw block of steps [i0, i0 + b) for every cell's key (C,
    2) int64 (uint32 values) at n nodes: (coord, ecl, eout, eback, ukey) as
    ``ref.epaxos_draws_ref`` defines them; on the card one launch of
    ``csrc/threefry_draws_sm90.cu``'s EPaxos entry."""
    if plain or key.device.type == "cpu":
        return epaxos_draws_ref(key, i0, b, n)
    if key.device.type != "cuda":
        raise ValueError(f"epaxos_draws: unsupported device {key.device}")
    _check_key("epaxos_draws", key)
    if n < 1:
        raise ValueError(f"epaxos_draws: n = {n}, expected at least 1")
    C = key.shape[0]
    if min(i0, b) < 0 or i0 + b > INT32_MAX or C * b > INT32_MAX \
            or 32 * n > INT32_MAX:
        raise ValueError(f"epaxos_draws: steps [{i0}, {i0 + b}) of {C} "
                         f"cells x {n} nodes overflow int32")
    new = lambda *shape: torch.empty(shape, dtype=torch.float32,
                                     device=key.device)
    coord = torch.empty(C, b, dtype=torch.int64, device=key.device)
    ecl, eout, eback, ukey = new(C, b, 2), new(C, b, n), new(C, b, n), \
        new(C, b)
    if C * b == 0:
        return coord, ecl, eout, eback, ukey
    with torch.cuda.device(key.device):
        err = _lib().threefry_epaxos_draws_sm90_launch(
            key.data_ptr(), coord.data_ptr(), ecl.data_ptr(),
            eout.data_ptr(), eback.data_ptr(), ukey.data_ptr(), C, b, i0, n,
            _stream(key.device))
    if err:
        raise RuntimeError(f"threefry_draws_sm90 EPaxos kernel launch "
                           f"failed: CUDA error {err}")
    global launches_sm90
    launches_sm90 += 1
    return coord, ecl, eout, eback, ukey


def exponential_of(u: torch.Tensor) -> torch.Tensor:
    """The kernel's exponential transform, ``-log1p(-u)`` in float64 rounded
    to f32, over given f32 uniforms on the card (what the tests hold to
    torch's own on every value a uniform can take).  Counts nothing."""
    if u.device.type != "cuda" or u.dtype != torch.float32 \
            or not u.is_contiguous() or u.numel() > INT32_MAX:
        raise ValueError("exponential_of: takes a contiguous f32 CUDA "
                         "tensor of fewer than 2**31 elements")
    out = torch.empty_like(u)
    if u.numel():
        with torch.cuda.device(u.device):
            err = _lib().threefry_draws_sm90_exp_launch(
                u.data_ptr(), out.data_ptr(), u.numel(), _stream(u.device))
        if err:
            raise RuntimeError(f"threefry_draws_sm90 exp launch failed: "
                               f"CUDA error {err}")
    return out
