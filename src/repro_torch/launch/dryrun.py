"""The production-mesh dry-run: one step of each arch x shape x mesh cell
traced on the meta device over a fake world of 256 or 512 ranks, in one
process and without a card.  The port of ``repro.launch.dryrun``.

The reference lowers and compiles each cell on 512 forced host devices
and reads XLA's memory analysis and HLO.  Here the step runs eagerly on
DTensors whose local shards live on the meta device (no data, no
compute), in a ``fake`` process group (every collective returns at once),
under the cell's sharding rules, while a dispatch mode records every
operation rank 0 dispatches below DTensor: the operation, its local input
and output shapes and types, its FLOPs (matrix products), its bytes, and
for a collective its kind, bytes and group.  From that record:

- ``hlo_flops`` / ``hlo_bytes``: the record's per-device counts x chips
  (``roofline.analyze_ops``; the record is loop-corrected by nature);
- ``memory.argument_bytes`` / ``output_bytes``: the local shard bytes of
  the step's arguments that it reads (state or parameters and cache,
  inputs; ``jax.jit`` drops an unused argument too) and of its results (no
  buffer donated, as in the reference);
- ``memory.temp_bytes``: the peak of live bytes the step allocated on
  rank 0 (storages it created, arguments excluded);
- ``code_bytes``, ``raw_cost_analysis``, ``compile_s``: ``None`` (there is
  no compiled program; ``not_applicable`` says so); ``lower_s`` is the
  trace time.

The record is written gzipped beside the JSON (``.ops.json.gz``, in place
of the reference's ``.hlo.gz``): ``launch.hlotop`` ranks it and
``launch.reanalyze`` rebuilds the JSON from it.

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch granite-8b \\
      --shape all --mesh single,multi
"""
from __future__ import annotations

import argparse
import gzip
import json
import os
import time
import traceback
import weakref
from typing import Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from ..configs import ARCHS, get_config
from ..data.pipeline import make_batch_specs
from ..launch.mesh import chips, make_production_mesh, mesh_axes
from ..models import make_cache, model_class
from ..optim import OptState, adamw_init
from ..roofline import (CONSTANTS, RooflineReport, analyze_ops,
                        model_flops_decode, model_flops_train)
from ..shard import P, sharding_rules
from ..train import (TrainOptions, TrainState, build_prefill_step,
                     build_serve_step, build_train_step)
from ..train.sharding import (activation_rules, batch_sharding,
                              cache_shardings, distribute, opt_shardings,
                              param_shardings, place, place_params)

SHAPES = {
    "train_4k": {"kind": "train", "seq": 4096, "batch": 256},
    "prefill_32k": {"kind": "prefill", "seq": 32768, "batch": 32},
    "decode_32k": {"kind": "decode", "seq": 32768, "batch": 128},
    "long_500k": {"kind": "decode", "seq": 524288, "batch": 1},
}

NOT_APPLICABLE = ("no compiled program: the step is traced eagerly on the "
                  "meta device, so there is no generated code, no XLA cost "
                  "analysis, no compile time and no while loop to correct")

_MATMULS = ("mm", "addmm", "bmm", "baddbmm")
_COLL = {"all_gather_into_tensor": "all-gather",
         "reduce_scatter_tensor": "reduce-scatter",
         "all_reduce": "all-reduce", "all_to_all_single": "all-to-all"}


def input_specs(cfg, shape_name: str) -> dict:
    """(shape, dtype) of every model input of this cell."""
    sh = SHAPES[shape_name]
    if sh["kind"] == "train":
        return make_batch_specs(cfg, sh["batch"], sh["seq"])
    if sh["kind"] == "prefill":
        if cfg.frontend:
            return {"embeds": ((sh["batch"], sh["seq"], cfg.d_model),
                               torch.bfloat16)}
        return {"tokens": ((sh["batch"], sh["seq"]), torch.int32)}
    # decode: one new token against a cache of seq_len
    return {"tokens": ((sh["batch"],), torch.int32),
            "pos": ((sh["batch"],), torch.int32)}


# ----------------------------------------------------------------- record
def _flat(xs, out: list) -> list:
    """The tensors among ``xs`` and its nested lists, tuples and dicts'
    values, appended to ``out``."""
    for y in xs:
        if isinstance(y, torch.Tensor):
            out.append(y)
        elif isinstance(y, (list, tuple)):
            _flat(y, out)
        elif isinstance(y, dict):
            _flat(y.values(), out)
    return out


def _tensors(tree) -> list:
    return _flat((tree,), [])


def _kind(func, name: str) -> str:
    """How the record counts an operation's bytes."""
    if func.namespace == "_c10d_functional" and name in _COLL:
        return "collective"
    if func.is_view or name in ("detach", "alias", "wait_tensor",
                                "_unsafe_view", "lift_fresh"):
        return "view"
    if any(a.alias_info is not None and a.alias_info.is_write
           for a in func._schema.arguments):
        return "inplace"
    return "op"


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _local(t: torch.Tensor) -> torch.Tensor:
    from ..shard import is_dtensor
    return t.to_local() if is_dtensor(t) else t


def _group_ranks(name: str) -> list:
    import torch.distributed as dist
    from torch.distributed.distributed_c10d import _resolve_process_group
    return dist.get_process_group_ranks(_resolve_process_group(name))


def _propagating() -> bool:
    """Whether DTensor is computing an output's global metadata (it runs
    the operation on fake global-shaped tensors under a ``FakeTensorMode``):
    no device work, not recorded."""
    return torch._C._get_dispatch_mode(
        torch._C._TorchDispatchModeKey.FAKE) is not None


class OpRecorder(TorchDispatchMode):
    """Records the operations dispatched below DTensor (DTensor's own
    calls pass through: ``NotImplemented`` hands them to DTensor, whose
    local operations then come here, as ``CommDebugMode`` sees
    collectives), and tracks the live bytes of the storages they
    create."""

    def __init__(self, argument_tensors=()):
        super().__init__()
        self.ops: list = []
        self._ranks: dict = {}
        self._kinds: dict = {}
        self._args = {_local(t).untyped_storage()._cdata
                      for t in argument_tensors}
        self._live: dict = {}
        self._held: set = set()
        self.read: set = set()          # storages some operation read
        self.live = self.peak = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if not _propagating():
            self._record(func, args, kwargs, out)
        return out

    def _record(self, func, args, kwargs, out):
        name = func.__name__.split(".")[0]
        ins = _flat(args, [])
        if kwargs:
            _flat(kwargs.values(), ins)
        outs = _flat((out,), [])
        entry = {"op": name,
                 "in": [[list(t.shape), str(t.dtype)[6:]] for t in ins],
                 "out": [[list(t.shape), str(t.dtype)[6:]] for t in outs]}
        kind = self._kinds.get(func)
        if kind is None:
            kind = self._kinds[func] = _kind(func, name)
        if kind != "view":
            self.read.update(t.untyped_storage()._cdata for t in ins)
        if kind == "view":
            entry["bytes"] = 0
        elif kind == "inplace":
            # in place: the update is read and written, the buffer is not
            keep = _flat([v for a, v in zip(func._schema.arguments, args)
                          if not (a.alias_info and a.alias_info.is_write)],
                         [])
            entry["bytes"] = 2 * sum(_nbytes(t) for t in keep)
        else:
            entry["bytes"] = (sum(_nbytes(t) for t in ins)
                              + sum(_nbytes(t) for t in outs))
        if name in _MATMULS:
            entry["flops"] = 2.0 * outs[0].numel() * args[-2].shape[-1]
        if kind == "collective":
            coll = _COLL[name]
            gname = args[-1]
            if gname not in self._ranks:
                self._ranks[gname] = _group_ranks(gname)
            o, i = _nbytes(outs[0]), _nbytes(ins[0])
            entry.update(coll=coll, ranks=self._ranks[gname],
                         coll_bytes=o if coll in ("all-gather", "all-reduce")
                         else max(o, i))
        self.ops.append(entry)
        self._track(outs)

    def _track(self, outs):
        """Exact live bytes without scanning every storage each operation:
        a storage is checked (``StorageWeakRef.expired``) when its Python
        object dies, and one still held from C++ (a tensor autograd saved)
        is polled from then on until it expires."""
        from torch.multiprocessing.reductions import StorageWeakRef
        for k in [k for k in self._held if self._live[k][0].expired()]:
            self._free(k)
        for t in outs:
            st = t.untyped_storage()
            k = st._cdata
            if k in self._args:
                continue
            if k in self._live:
                if not self._live[k][0].expired():
                    continue
                self._free(k)                   # its address was reused
            self._live[k] = (StorageWeakRef(st), st.nbytes())
            self.live += st.nbytes()
            weakref.finalize(st, self._dropped, k)
        self.peak = max(self.peak, self.live)

    def _dropped(self, k):
        if k in self._live:
            if self._live[k][0].expired():
                self._free(k)
            else:
                self._held.add(k)

    def _free(self, k):
        self.live -= self._live.pop(k)[1]
        self._held.discard(k)


# ----------------------------------------------------------------- world
def fake_world(n: int) -> None:
    """Make this process rank 0 of a fake world of ``n`` ranks (a process
    group whose collectives do nothing), replacing any fake world of
    another size."""
    import torch.distributed as dist
    try:
        from torch.testing._internal.distributed.fake_pg import FakeStore
    except ImportError as e:                       # pragma: no cover
        raise RuntimeError("the dry-run needs PyTorch's fake process group "
                           "(torch.testing._internal.distributed.fake_pg), "
                           "which this PyTorch does not have") from e
    if dist.is_initialized():
        if dist.get_world_size() == n and dist.get_backend() == "fake":
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)


def _meta(spec: tuple) -> torch.Tensor:
    shape, dtype = spec
    return torch.zeros(shape, dtype=dtype, device="meta")


def _local_bytes(tree) -> int:
    return sum(_nbytes(_local(t)) for t in _tensors(tree))


def run_cell(arch: str, shape_name: str, multi_pod: bool, fsdp: bool = True,
             microbatch: int = 1, record_path: Optional[str] = None) -> dict:
    """Trace one cell on a fake world of ``chips(multi_pod)`` ranks and
    return its JSON (the reference's keys)."""
    cfg = get_config(arch)
    sh = SHAPES[shape_name]
    mesh_kind = "multi" if multi_pod else "single"
    if shape_name == "long_500k" and not cfg.subquadratic:
        return {"arch": cfg.name, "shape": shape_name, "mesh": mesh_kind,
                "skipped": "pure full attention: 500k dense-KV decode is "
                           "not sub-quadratic (see DESIGN.md §5)"}
    fake_world(chips(multi_pod))
    mesh = make_production_mesh(multi_pod)
    n = mesh.size()
    long = shape_name == "long_500k"
    rules = activation_rules(multi_pod, shard_kv_seq=long)
    batch_axes = mesh_axes(multi_pod)[:-1]
    t0 = time.time()

    params = model_class(cfg)(cfg, device="meta")
    inputs = {k: _meta(v) for k, v in input_specs(cfg, shape_name).items()}
    if sh["kind"] == "train":
        opt = adamw_init(params)
        specs = opt_shardings(opt, mesh, fsdp)
        opt = OptState(mu=place(opt.mu, specs["mu"], mesh),
                       nu=place(opt.nu, specs["nu"], mesh), step=opt.step)
        bs = batch_sharding(inputs, mesh, multi_pod)
        args = {"batch": {k: distribute(t, mesh, bs[k])
                          for k, t in inputs.items()}}
        mflops = model_flops_train(cfg.active_param_count(),
                                   sh["batch"] * sh["seq"])
    else:
        cache = make_cache(cfg, sh["batch"], max_len=sh["seq"],
                           device="meta")
        cache = place(cache, cache_shardings(cache, mesh, multi_pod,
                                             shard_kv_seq=long), mesh)
        spec = P(batch_axes) if (sh["batch"] > 1
                                 or sh["kind"] == "prefill") else P()
        args = {"cache": cache,
                "inputs": {k: distribute(t, mesh, spec)
                           for k, t in inputs.items()}}
        tokens = sh["batch"] * (sh["seq"] if sh["kind"] == "prefill" else 1)
        mflops = model_flops_decode(cfg.active_param_count(), tokens)
    place_params(params, mesh, param_shardings(params, mesh, fsdp))
    if sh["kind"] == "train":
        args["state"] = TrainState(params, opt)
    else:
        args["params"] = params
    arg_tensors = list(_tensors(args)) + list(params.parameters())

    rec = OpRecorder(arg_tensors)
    with sharding_rules(mesh, rules), rec:
        if sh["kind"] == "train":
            step = build_train_step(cfg, TrainOptions(
                remat=True, impl="auto", microbatch=microbatch))
            state, metrics = step(args["state"], args["batch"])
            outputs = (list(state.params.parameters()), state.opt, metrics)
        elif sh["kind"] == "prefill":
            step = build_prefill_step(cfg, impl="auto")
            outputs = step(params, cache, **args["inputs"])
        else:
            step = build_serve_step(cfg, impl="auto")
            outputs = step(params, cache, args["inputs"]["tokens"],
                           args["inputs"]["pos"])
    t_trace = time.time() - t0

    if record_path:
        with gzip.open(record_path, "wt") as f:
            json.dump(rec.ops, f)
    pod_size = n // mesh.size(0) if multi_pod else None
    out = report(cfg.name, shape_name, mesh_kind, n, mflops, rec.ops,
                 pod_size)
    # the arguments the step reads: jax.jit drops an unused one (rwkv's
    # decode never reads ``pos``) from the compiled program's arguments
    arg_bytes = sum(_nbytes(_local(t)) for t in arg_tensors
                    if _local(t).untyped_storage()._cdata in rec.read)
    out.update({
        "memory": {"argument_bytes": arg_bytes,
                   "output_bytes": _local_bytes(outputs),
                   "temp_bytes": rec.peak, "code_bytes": None},
        "raw_cost_analysis": None, "not_applicable": NOT_APPLICABLE,
        "lower_s": round(t_trace, 1), "compile_s": None,
        "fsdp": fsdp, "microbatch": microbatch,
        "mesh_shape": list(mesh.shape), "pod_size": pod_size,
        "n_ops": len(rec.ops),
    })
    return out


def report(arch: str, shape: str, mesh_kind: str, chips: int,
           model_flops: float, record: list, pod_size: Optional[int]
           ) -> dict:
    """The JSON fields the op record decides: the roofline report with the
    H100 constants (``roofline.CONSTANTS``) under the reference's keys, the
    v5e terms beside them, and the collective bytes."""
    corr = analyze_ops(record, pod_size)
    kw = dict(arch=arch, shape=shape, mesh=mesh_kind, chips=chips,
              hlo_flops=corr["flops"] * chips,
              hlo_bytes=corr["traffic_bytes"] * chips,
              coll_bytes=corr["coll_total"] * chips,
              coll_cross_pod=corr["coll_cross_pod"] * chips,
              model_flops=model_flops)
    out = RooflineReport(**kw, **CONSTANTS["h100"]).to_dict()
    v5e = RooflineReport(**kw, **CONSTANTS["v5e"]).to_dict()
    out.update({
        "constants": "h100", "constants_values": CONSTANTS["h100"],
        "v5e": {k: v5e[k] for k in ("t_compute", "t_memory", "t_collective",
                                     "bottleneck", "roofline_fraction")},
        "collectives": corr["by_kind"], "loops": corr["loops"],
        "in_pod_bytes_per_chip": corr["coll_in_pod"],
        "cross_pod_bytes_per_chip": corr["coll_cross_pod"],
    })
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="single,multi")
    ap.add_argument("--out", default="artifacts/dryrun_torch")
    ap.add_argument("--fsdp", type=int, default=1)
    ap.add_argument("--microbatch", type=int, default=1)
    ap.add_argument("--tag", default="")
    ap.add_argument("--skip-existing", action="store_true")
    args = ap.parse_args(argv)

    archs = ARCHS if args.arch == "all" else args.arch.split(",")
    shapes = list(SHAPES) if args.shape == "all" else args.shape.split(",")
    meshes = args.mesh.split(",")
    os.makedirs(args.out, exist_ok=True)

    n_ok = n_skip = n_fail = 0
    for mesh_kind in meshes:
        for arch in archs:
            for shape in shapes:
                tag = f"-{args.tag}" if args.tag else ""
                path = os.path.join(args.out,
                                    f"{mesh_kind}--{arch}--{shape}{tag}.json")
                if args.skip_existing and os.path.exists(path):
                    print(f"[skip-existing] {path}", flush=True)
                    continue
                t0 = time.time()
                try:
                    out = run_cell(arch, shape, multi_pod=(mesh_kind == "multi"),
                                   fsdp=bool(args.fsdp),
                                   microbatch=args.microbatch,
                                   record_path=path.replace(".json",
                                                            ".ops.json.gz"))
                    if "skipped" in out:
                        n_skip += 1
                        print(f"[SKIP] {mesh_kind} {arch} {shape}: "
                              f"{out['skipped']}", flush=True)
                    else:
                        n_ok += 1
                        print(f"[OK]   {mesh_kind} {arch} {shape} "
                              f"({time.time()-t0:.0f}s) "
                              f"bottleneck={out['bottleneck']} "
                              f"frac={out['roofline_fraction']:.3f}",
                              flush=True)
                except Exception as e:   # noqa: BLE001
                    n_fail += 1
                    out = {"arch": arch, "shape": shape, "mesh": mesh_kind,
                           "error": f"{type(e).__name__}: {e}",
                           "traceback": traceback.format_exc()[-4000:]}
                    print(f"[FAIL] {mesh_kind} {arch} {shape}: {e}",
                          flush=True)
                with open(path, "w") as f:
                    json.dump(out, f, indent=1)
    print(f"done: ok={n_ok} skip={n_skip} fail={n_fail}", flush=True)
    if n_fail:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
