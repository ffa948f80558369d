"""Logical-axis sharding annotations on DTensor: the port of ``repro.shard``.

Model code annotates activations with *logical* axis names
(``constrain(x, 'batch', 'seq', 'embed')``).  The launcher installs a
``DeviceMesh`` and logical -> mesh-axis rules (``sharding_rules``); outside
such a context, or on a plain tensor, every call here returns its input
unchanged, so the same model code runs on one device and on a mesh.

A ``PartitionSpec`` is the JAX package's: one entry a tensor dimension,
each ``None``, a mesh axis name or a tuple of names.  ``spec_to_placements``
turns it into DTensor placements, one a mesh dimension: ``Shard(d)`` on
every mesh dimension that dimension d names, ``Replicate()`` on the rest.
Where a dimension names several axes, DTensor splits it over them in mesh
order (``("pod", "data")``: pod-major, as JAX does); a spec that names them
out of mesh order gets the same shard sizes with the blocks dealt out to
the ranks in mesh order.

Inside a rules context plain tensors that meet a DTensor (positions,
masks, constants built with ``torch.arange``/``torch.full``) are taken as
replicated, as JAX treats an array it was given no sharding for.
"""
from __future__ import annotations

import threading
from contextlib import contextmanager
from typing import Dict, NamedTuple, Optional, Sequence, Tuple, Union

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import (implicit_replication,
                                                   local_map)

_CTX = threading.local()

MeshAxes = Union[None, str, Tuple[str, ...]]


class PartitionSpec(tuple):
    """A tuple of ``MeshAxes``, one a tensor dimension (trailing dimensions
    left out are unsharded).  As JAX's, an entry of one axis is that
    axis's name and an empty entry is ``None``."""

    def __new__(cls, *entries: MeshAxes):
        norm = lambda a: (None if a == () else a[0] if isinstance(a, tuple)
                          and len(a) == 1 else a)
        return super().__new__(cls, tuple(norm(a) for a in entries))

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


P = PartitionSpec


class MeshShape(NamedTuple):
    """The axis names and sizes of a mesh, without its devices: what the
    spec rules read, so specs can be computed for a world that does not
    exist (``train.sharding.fit_spec`` at 512 ranks in one process)."""
    axis_names: Tuple[str, ...]
    shape: Tuple[int, ...]


def axis_sizes(mesh) -> Dict[str, int]:
    """Axis name -> size of a ``DeviceMesh`` or a ``MeshShape``."""
    names = getattr(mesh, "mesh_dim_names", None) or mesh.axis_names
    return dict(zip(names, tuple(mesh.shape)))


def as_axes(a: MeshAxes) -> Tuple[str, ...]:
    return a if isinstance(a, tuple) else ((a,) if a else ())


def is_dtensor(x) -> bool:
    return isinstance(x, DTensor)


@contextmanager
def sharding_rules(mesh, rules: Dict[str, MeshAxes]):
    """Install ``mesh`` (a ``DeviceMesh`` with named dimensions) and the
    logical -> mesh-axis ``rules`` for this thread."""
    prev = getattr(_CTX, "state", None)
    _CTX.state = (mesh, dict(rules))
    try:
        if prev is None:
            with implicit_replication():
                yield
        else:
            yield
    finally:
        _CTX.state = prev


def current_mesh():
    st = getattr(_CTX, "state", None)
    return st[0] if st else None


def logical_to_spec(names: Sequence[Optional[str]]) -> Optional[P]:
    st = getattr(_CTX, "state", None)
    if st is None:
        return None
    _, rules = st
    return P(*[rules.get(n) if n is not None else None for n in names])


def named_sharding(*names: Optional[str]):
    """(mesh, placements) of the logical ``names`` under the installed
    rules (the counterpart of a ``NamedSharding``), or None outside a
    rules context."""
    st = getattr(_CTX, "state", None)
    if st is None:
        return None
    mesh, _ = st
    return mesh, spec_to_placements(logical_to_spec(names), mesh)


def spec_to_placements(spec: Sequence[MeshAxes], mesh) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``, one a mesh dimension."""
    names = getattr(mesh, "mesh_dim_names", None) or mesh.axis_names
    out = []
    for ax in names:
        dims = [d for d, a in enumerate(spec) if ax in as_axes(a)]
        if len(dims) > 1:
            raise ValueError(f"mesh axis {ax!r} shards two dimensions of "
                             f"{spec}")
        out.append(Shard(dims[0]) if dims else Replicate())
    return tuple(out)


def fitted_spec(shape: Sequence[int], names: Sequence[Optional[str]],
                rules: Dict[str, MeshAxes], mesh) -> P:
    """The spec ``constrain`` applies: each logical name's mesh axes, or
    None where their product does not divide the dimension."""
    sizes = axis_sizes(mesh)
    entries = []
    for dim, n in zip(shape, names):
        a = rules.get(n) if n is not None else None
        axes = as_axes(a)
        prod = 1
        for ax in axes:
            prod *= sizes[ax]
        entries.append(a if (axes and dim % prod == 0) else None)
    return P(*entries)


def constrain(x: torch.Tensor, *names: Optional[str]) -> torch.Tensor:
    """Apply a logical sharding constraint; no-op outside a rules context
    and on a plain tensor.  A DTensor is redistributed to the rules'
    placements.  Axes that don't divide the dimension are dropped (the
    reference's rule: constraining 8 kv heads over a 16-way 'model' axis
    would otherwise pad and reshard)."""
    st = getattr(_CTX, "state", None)
    if st is None or not is_dtensor(x):
        return x
    mesh, rules = st
    want = spec_to_placements(fitted_spec(x.shape, names, rules, mesh), mesh)
    if tuple(x.placements) == want:
        return x
    return x.redistribute(mesh, want)


def fsdp_gather(w: torch.Tensor) -> torch.Tensor:
    """A weight as its use needs it: gathered over the FSDP axes (the
    rules' batch axes: 'data', and 'pod' on a multi-pod mesh), still split
    over the rest ('model').  FSDP's all-gather before use, whose backward
    reduce-scatters the gradient; GSPMD makes the same choice, where
    DTensor's own matmul rule would move the activations instead.  No-op
    outside a rules context and on a plain tensor."""
    st = getattr(_CTX, "state", None)
    if st is None or not is_dtensor(w):
        return w
    mesh, rules = st
    fsdp = set(as_axes(rules.get("batch")))
    want = [Replicate() if n in fsdp else p
            for n, p in zip(mesh.mesh_dim_names, w.placements)]
    if list(w.placements) == want:
        return w
    return w.redistribute(mesh, want)


class gathered:
    """A module's view whose parameters (and its submodules') read through
    ``fsdp_gather``: model code runs a block on ``gathered(block)`` and
    each weight is gathered where it is used, again in remat's recompute.
    Outside a rules context, ``gathered(m)`` is ``m`` itself."""

    def __new__(cls, mod):
        if getattr(_CTX, "state", None) is None:
            return mod
        self = super().__new__(cls)
        self._mod = mod
        return self

    def __getattr__(self, name):
        v = getattr(self._mod, name)
        if isinstance(v, torch.nn.Module):
            return gathered(v)
        return fsdp_gather(v) if isinstance(v, torch.Tensor) else v


def unflatten(x: torch.Tensor, dim: int, sizes: Sequence[int]
              ) -> torch.Tensor:
    """``x.unflatten(dim, sizes)``.  DTensor refuses to split a sharded
    dimension whose first factor the shard count does not divide (GSPMD
    pads instead); such a DTensor is first replicated on those mesh
    dimensions (e.g. 2 KV heads from a 4-way 'model' shard)."""
    if is_dtensor(x):
        d = dim % x.dim()
        pl = list(x.placements)
        prod = 1
        for i, p in enumerate(pl):
            if isinstance(p, Shard) and p.dim == d:
                prod *= x.device_mesh.size(i)
        if sizes[0] % prod:
            pl = [Replicate() if isinstance(p, Shard) and p.dim == d else p
                  for p in pl]
            x = x.redistribute(x.device_mesh, pl)
    return x.unflatten(dim, tuple(sizes))


class _Flatten(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, n):
        ctx.dim, ctx.sizes = dim, tuple(x.shape[dim:dim + n])
        return x.flatten(dim, dim + n - 1)

    @staticmethod
    def backward(ctx, g):
        return unflatten(g, ctx.dim, ctx.sizes), None, None


def flatten(x: torch.Tensor, dim: int, n: int) -> torch.Tensor:
    """Merge dimensions dim .. dim + n - 1 of ``x``.  A DTensor split on
    one of the merged dimensions but the first is replicated on it first
    (DTensor cannot merge it as is: a head dim split under its heads), and
    its backward splits the gradient with ``unflatten`` (a gradient split
    where the merged dimensions were not cannot be unflattened as is)."""
    if not is_dtensor(x):
        return x.flatten(dim, dim + n - 1)
    d = dim % x.dim()
    inner = lambda p: isinstance(p, Shard) and d < p.dim < d + n
    if any(inner(p) for p in x.placements):
        x = x.redistribute(x.device_mesh, [Replicate() if inner(p) else p
                                           for p in x.placements])
    if torch.is_grad_enabled() and x.requires_grad:
        return _Flatten.apply(x, d, n)
    return x.flatten(d, d + n - 1)


def is_split(x: torch.Tensor, dim: int) -> bool:
    """Whether ``x`` is a DTensor whose dimension ``dim`` is sharded."""
    return is_dtensor(x) and any(isinstance(p, Shard) and p.dim == dim
                                 for p in x.placements)


def _local_offset(x, dim: int) -> tuple:
    """(offset, size) of this rank's shard of DTensor ``x`` on ``dim``."""
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    shape, off = compute_local_shape_and_global_offset(
        x.shape, x.device_mesh, x.placements)
    return off[dim], shape[dim]


def as_dtensor(t: torch.Tensor, mesh, placements) -> torch.Tensor:
    if not is_dtensor(t):
        t = DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                               run_check=False)
    return t.redistribute(mesh, placements)


def write_slots(buf: torch.Tensor, slots: torch.Tensor, val: torch.Tensor
                ) -> torch.Tensor:
    """``buf[b, slots[b, s]] = val[b, s]`` in place (a cache's ring-buffer
    write): buf (B, W, ...), slots (B, S) distinct slots a row, val (B, S,
    ...).  On a DTensor ``buf`` each rank writes its own shard: its rows of
    ``val`` (in ``buf``'s placements, S unsharded) at its rows' slots, and,
    where W itself is sharded (a long context's KV sequence), only the
    slots its block holds, by a select over the block (decode: S = 1)."""
    if not is_dtensor(buf):
        bidx = torch.arange(buf.shape[0], device=buf.device)[:, None]
        buf.index_put_((bidx, slots.long()), val.to(buf.dtype))
        return buf
    mesh, pl = buf.device_mesh, tuple(buf.placements)
    lead = tuple(Replicate() if isinstance(p, Shard) and p.dim == 1 else p
                 for p in pl)
    rows = tuple(p if isinstance(p, Shard) and p.dim == 0 else Replicate()
                 for p in pl)
    lv = as_dtensor(val, mesh, lead).to_local().to(buf.dtype)
    ls = as_dtensor(slots, mesh, rows).to_local().long()
    lb = buf.to_local()
    w0, wl = _local_offset(buf, 1)
    if wl == buf.shape[1]:
        bidx = torch.arange(lb.shape[0], device=lb.device)[:, None]
        lb.index_put_((bidx, ls), lv)
        return buf
    rel = ls - w0                                      # (Bl, S)
    hit = (rel >= 0) & (rel < wl)
    onehot = ((rel.clamp(0, wl - 1)[..., None]
               == torch.arange(wl, device=lb.device)) & hit[..., None])
    src = onehot.to(torch.int8).argmax(dim=1)          # (Bl, Wl): its s
    got = torch.gather(lv, 1, src.reshape(src.shape + (1,) * (lv.dim() - 2))
                       .expand((-1, -1) + lv.shape[2:]))
    keep = onehot.any(dim=1).reshape(src.shape + (1,) * (lv.dim() - 2))
    lb.copy_(torch.where(keep, got, lb))
    return buf


def local_call(fn, mesh, out_placements, in_placements: Sequence,
               args: Sequence):
    """``local_map(fn, ...)(*args)`` with the inputs redistributed to
    ``in_placements`` (plain tensors among ``args`` taken as replicated)
    and each input's gradient placements stated: an input replicated on a
    mesh dimension that splits another input feeds only that rank's part
    of the work there, so its gradient is a partial sum (``Partial``) on
    that dimension; elsewhere the gradient has the input's placements.
    ``out_placements``: a list for one output, a tuple of lists for
    several (``local_map``'s convention)."""
    rep = [Replicate()] * mesh.ndim
    args = [DTensor.from_local(a, mesh, rep, run_check=False)
            if isinstance(a, torch.Tensor) and not is_dtensor(a) else a
            for a in args]
    split = {i for pl in in_placements if pl is not None
             for i, p in enumerate(pl) if isinstance(p, Shard)}
    grads = tuple(None if pl is None else
                  [Partial() if i in split and isinstance(p, Replicate)
                   else p for i, p in enumerate(pl)]
                  for pl in in_placements)
    return local_map(fn, out_placements=out_placements,
                     in_placements=tuple(None if pl is None else list(pl)
                                         for pl in in_placements),
                     in_grad_placements=grads, device_mesh=mesh,
                     redistribute_inputs=True)(*args)


def shard_index(mesh, dims: Sequence[int]) -> int:
    """This rank's block index along the mesh dimensions ``dims``, which
    split one tensor dimension (mesh order, the first the major)."""
    coord = mesh.get_coordinate()
    idx = 0
    for i in dims:
        idx = idx * mesh.size(i) + coord[i]
    return idx


def local_heads(fn, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                *rows: Optional[torch.Tensor]) -> torch.Tensor:
    """``fn(q, k, v, *rows)`` (an attention: q (B, S, Hq, Dh), k/v (B, Sk,
    Hkv, Dh), ``rows`` per-batch tensors (B, ...) or None; returns (B, S,
    Hq, Dh)) on each rank's shard of batch and query heads, through
    ``local_map``: nothing it sums over (keys, head dim) is split.  Plain
    ``fn(...)`` when q is not a DTensor.

    q keeps the mesh dimensions that split its batch (dim 0) or heads
    (dim 2) and is replicated on the rest.  GQA: local query head i must
    meet the KV head of global head off + i, (off + i) // rep.  Where the
    head shards divide Hkv, k/v are split the same way (each block holds
    its query heads' KV heads); where a shard's query heads all fall in
    one group (rep a multiple of the local count), k/v are replicated over
    the head shards and each rank slices its one KV head; otherwise the
    heads are not split."""
    if not is_dtensor(q):
        return fn(q, k, v, *rows)
    mesh = q.device_mesh
    Hq, Hkv = q.shape[2], k.shape[2]
    group = Hq // Hkv
    batch = [i for i, p in enumerate(q.placements)
             if isinstance(p, Shard) and p.dim == 0]
    heads = [i for i, p in enumerate(q.placements)
             if isinstance(p, Shard) and p.dim == 2]
    hs = 1
    for i in heads:
        hs *= mesh.size(i)
    local = Hq // hs
    if Hq % hs or not (Hkv % hs == 0 or group % local == 0):
        heads, hs, local = [], 1, Hq
    kv_split = Hkv % hs == 0
    place = lambda i, on: [Shard(0) if j in batch else
                           Shard(on) if j in heads and i else Replicate()
                           for j in range(mesh.ndim)]
    q_pl = place(True, 2)
    kv_pl = place(kv_split, 2)
    row_pl = place(False, 0)

    def run(ql, kl, vl, *rl):
        if not kv_split:                  # one KV head serves this shard
            j = shard_index(mesh, heads) * local // group
            kl, vl = kl[:, :, j:j + 1], vl[:, :, j:j + 1]
        return fn(ql, kl, vl, *rl)

    return local_call(run, mesh, q_pl, (q_pl, kv_pl, kv_pl) + tuple(
        None if r is None else row_pl for r in rows), (q, k, v) + rows)


class _SumOver(torch.autograd.Function):
    """All-reduce (sum) over ``group``; the backward is the identity: the
    sum is used alike on every rank of the group (a replicated result), so
    each rank's incoming gradient is already the whole gradient of its
    partial sum (Megatron's forward all-reduce)."""

    @staticmethod
    def forward(ctx, x, group):
        import torch.distributed._functional_collectives as funcol
        return funcol.wait_tensor(funcol.all_reduce(x, "sum", group))

    @staticmethod
    def backward(ctx, g):
        return g, None


def sum_over(x: torch.Tensor, groups: Sequence) -> torch.Tensor:
    """``x`` summed over each process group of ``groups`` in turn (local
    code inside ``local_over``: a product over a split dimension)."""
    for g in groups:
        x = _SumOver.apply(x, g)
    return x


def local_over(fn, args: Sequence, in_names: Sequence, out_names):
    """``fn(*args)`` on each rank's local shards: inside a rules context,
    with a DTensor among ``args``, through ``local_map`` with the
    placements the rules give each logical name tuple (``in_names`` one an
    argument, ``None`` for a non-tensor; ``out_names`` one tuple, or a
    tuple of them for several outputs), the inputs redistributed to them;
    otherwise plain ``fn(*args)``.  For operations DTensor has no sharding
    rule for (sorts, scatters, searches) that are independent per row of
    the dimensions the names shard.  As in ``constrain``, a name's axes
    are dropped where they do not divide the dimension (an output's
    dimension is sized by the input dimension of the same name)."""
    st = getattr(_CTX, "state", None)
    if st is None or not any(is_dtensor(a) for a in args):
        return fn(*args)
    mesh, rules = st
    size = {}
    for a, names in zip(args, in_names):
        if names is not None:
            size.update((n, d) for n, d in zip(names, a.shape) if n)

    # local_map: a list of placements an output, a tuple of them for several
    def pl(names, shape=None):
        if names is None:
            return None
        shape = shape or [size.get(n, 1) for n in names]
        return list(spec_to_placements(
            fitted_spec(shape, names, rules, mesh), mesh))

    several = bool(out_names) and isinstance(out_names[0], tuple)
    out_pl = (tuple(pl(n) for n in out_names) if several
              else pl(out_names))
    return local_call(fn, mesh, out_pl, tuple(
        pl(n, None if a is None else a.shape)
        for n, a in zip(in_names, args)), args)
