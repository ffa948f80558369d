"""The port's dry-run against the reference's, at smoke size, and the
roofline accounting.

Four worker processes (this file is also their script: ``python
tests/test_torch_dryrun.py ref|port single|multi OUT``), a side and a mesh
each, trace the same cells: the
smoke configs of granite-8b, rwkv6-3b, qwen2-moe-a2.7b and zamba2-7b x
train_4k / prefill_32k / decode_32k x a (2, 4) ``("data", "model")`` and a
(2, 2, 2) ``("pod", "data", "model")`` mesh of 8 ranks.

- The reference runs ``repro.launch.dryrun.run_cell`` on 8 forced host
  devices.  Its ``make_production_mesh`` builds the mesh with
  ``jax.make_mesh(shape, axes)``, whose axes are Explicit on this JAX, and
  ``constrain`` then raises (a fault of the reference, ROADMAP §3); the
  worker patches it (and ``chips``, ``get_config``) to build the same
  shapes with Auto axes and the smoke configs.  ``run_cell`` hard-codes a
  pod of 256 ranks, so the worker calls ``roofline.analyze_hlo`` itself on
  the HLO it writes, with this mesh's pod of 4.
- The port runs ``repro_torch.launch.dryrun.run_cell`` on a fake world of
  8 ranks in its own process (the fake world is process-global), its
  worker patching the same three names to the same shapes.

Held exactly: ``model_flops``, ``chips`` and the per-device
``memory.argument_bytes`` (they depend only on the configs, the specs and
the leaf shapes and types).  Held loosely: the matrix-product FLOPs
(port) against ``analyze_hlo``'s (reference) within [0.5, 2]; XLA and
DTensor choose different collectives and different recompute, so the
collective bytes by kind are printed side by side, not compared.
"""
import gzip
import json
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "src")
ARCHS = ["granite-8b", "rwkv6-3b", "qwen2-moe-a2.7b", "zamba2-7b"]
SHAPES = ["train_4k", "prefill_32k", "decode_32k"]
MESHES = {"single": (2, 4), "multi": (2, 2, 2)}
FLOP_RATIO = (0.5, 2.0)


# ----------------------------------------------------------------- workers
def _ref_side(kind, out):
    import jax
    jax.devices()              # 8 forced host devices, before dryrun's flag
    from jax.sharding import AxisType
    from repro.configs import get_smoke_config
    from repro.launch import dryrun
    from repro.roofline import analyze_hlo

    res = {}
    shape = MESHES[kind]
    axes = ("pod", "data", "model") if kind == "multi" else ("data", "model")
    dryrun.make_production_mesh = lambda multi_pod: jax.make_mesh(
        shape, axes, axis_types=(AxisType.Auto,) * len(shape))
    dryrun.chips = lambda multi_pod: 8
    dryrun.get_config = get_smoke_config
    for arch in ARCHS:
        for sh in SHAPES:
            hlo = os.path.join(out, f"{kind}-{arch}-{sh}.hlo.gz")
            d = dryrun.run_cell(arch, sh, multi_pod=(kind == "multi"),
                                hlo_path=hlo)
            with gzip.open(hlo, "rt") as f:
                corr = analyze_hlo(f.read(),
                                   pod_size=4 if kind == "multi" else None)
            res[f"{kind}/{arch}/{sh}"] = {
                "model_flops": d["model_flops"], "chips": d["chips"],
                "argument_bytes": d["memory"]["argument_bytes"],
                "flops": corr["flops"], "collectives": corr["by_kind"],
                "cross_pod": corr["coll_cross_pod"]}
            jax.clear_caches()
    with open(os.path.join(out, f"ref-{kind}.json"), "w") as f:
        json.dump(res, f)


def _port_side(kind, out):
    import torch
    from torch.distributed.device_mesh import DeviceMesh
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch import dryrun
    torch.set_num_threads(1)
    res = {}
    shape = MESHES[kind]
    dryrun.make_production_mesh = lambda multi_pod: DeviceMesh(
        "cpu", torch.arange(8).reshape(shape),
        mesh_dim_names=dryrun.mesh_axes(multi_pod))
    dryrun.chips = lambda multi_pod: 8
    dryrun.get_config = get_smoke_config
    for arch in ARCHS:
        for sh in SHAPES:
            d = dryrun.run_cell(arch, sh, multi_pod=(kind == "multi"))
            res[f"{kind}/{arch}/{sh}"] = {
                "model_flops": d["model_flops"], "chips": d["chips"],
                "argument_bytes": d["memory"]["argument_bytes"],
                "flops": d["hlo_flops"] / d["chips"],
                "collectives": d["collectives"],
                "cross_pod": d["cross_pod_bytes_per_chip"]}
    with open(os.path.join(out, f"port-{kind}.json"), "w") as f:
        json.dump(res, f)


# ----------------------------------------------------------------- tests
@pytest.fixture(scope="module")
def cells(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("dryrun"))
    me = os.path.abspath(__file__)
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               OMP_NUM_THREADS="1")
    ref_env = dict(env, XLA_FLAGS="--xla_force_host_platform_device_count=8")
    procs = [subprocess.Popen([sys.executable, me, side, kind, d], env=e,
                              cwd=ROOT, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for side, e in (("ref", ref_env), ("port", env))
             for kind in MESHES]
    logs = []
    for p in procs:
        try:
            logs.append(p.communicate(timeout=600)[0])
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
    for p, log in zip(procs, logs):
        assert p.returncode == 0, f"{p.args}:\n{log[-6000:]}"
    ref, port = {}, {}
    for kind in MESHES:
        for side, res in (("ref", ref), ("port", port)):
            with open(os.path.join(d, f"{side}-{kind}.json")) as f:
                res.update(json.load(f))
    return ref, port


KEYS = [f"{k}/{a}/{s}" for k in MESHES for a in ARCHS for s in SHAPES]


@pytest.mark.parametrize("key", KEYS)
def test_dryrun_cell_matches_reference(cells, key):
    ref, port = cells[0][key], cells[1][key]
    ratio = port["flops"] / ref["flops"]
    print(f"{key}: flops port {port['flops']:.4g} ref {ref['flops']:.4g} "
          f"(port / ref {ratio:.4f}); collectives port "
          f"{port['collectives']} ref {ref['collectives']}; cross-pod port "
          f"{port['cross_pod']:.4g} ref {ref['cross_pod']:.4g}")
    assert port["model_flops"] == ref["model_flops"]
    assert port["chips"] == ref["chips"] == 8
    assert port["argument_bytes"] == ref["argument_bytes"]
    assert FLOP_RATIO[0] <= ratio <= FLOP_RATIO[1], ratio


# ----------------------------------------------------------------- roofline
FIELDS = dict(arch="granite-8b", shape="train_4k", mesh="multi", chips=512,
              hlo_flops=3.1e19, hlo_bytes=7.7e16, coll_bytes=2.2e15,
              coll_cross_pod=1.3e14, model_flops=2.9e19)


@pytest.mark.parametrize("cross", [0.0, 1.3e14, 2.2e15])
def test_roofline_report_equals_reference_with_v5e_constants(cross):
    from repro.roofline import RooflineReport as Ref
    from repro_torch.roofline import RooflineReport
    f = dict(FIELDS, coll_cross_pod=cross)
    assert RooflineReport(**f).to_dict() == Ref(**f).to_dict()


def _program():
    """A hand-built record: two products, an all-gather over the pod axis
    (ranks 0 and 4 of a 2 x 4 world) and a reduce-scatter within a pod."""
    return [
        {"op": "mm", "in": [[[8, 16], "bfloat16"], [[16, 32], "bfloat16"]],
         "out": [[[8, 32], "bfloat16"]], "flops": 2.0 * 8 * 16 * 32,
         "bytes": 2 * (8 * 16 + 16 * 32 + 8 * 32)},
        {"op": "bmm", "in": [[[2, 4, 8], "float32"], [[2, 8, 4], "float32"]],
         "out": [[[2, 4, 4], "float32"]], "flops": 2.0 * 2 * 4 * 4 * 8,
         "bytes": 4 * (64 + 64 + 32)},
        {"op": "view", "in": [[[8, 32], "bfloat16"]],
         "out": [[[256], "bfloat16"]], "bytes": 0},
        {"op": "all_gather_into_tensor", "in": [[[256], "bfloat16"]],
         "out": [[[512], "bfloat16"]], "bytes": 2 * 768,
         "coll": "all-gather", "coll_bytes": 1024, "ranks": [0, 4]},
        {"op": "reduce_scatter_tensor", "in": [[[512], "float32"]],
         "out": [[[128], "float32"]], "bytes": 4 * 640,
         "coll": "reduce-scatter", "coll_bytes": 2048,
         "ranks": [0, 1, 2, 3]},
    ]


def test_analyze_ops_counts_a_known_program():
    from repro_torch.roofline import analyze_ops
    a = analyze_ops(_program(), pod_size=4)
    assert a["flops"] == 2.0 * 8 * 16 * 32 + 2.0 * 2 * 4 * 4 * 8
    assert a["traffic_bytes"] == (2 * (128 + 512 + 256) + 4 * 160
                                  + 2 * 768 + 4 * 640)
    assert a["by_kind"] == {"all-gather": 1024, "reduce-scatter": 2048}
    assert (a["coll_total"], a["coll_cross_pod"], a["coll_in_pod"]) == (
        3072, 1024, 2048)
    assert a["loops"] == []
    b = analyze_ops(_program(), pod_size=None)
    assert (b["coll_cross_pod"], b["coll_in_pod"]) == (0.0, 0.0)


def test_reanalyze_round_trip_and_hlotop(tmp_path):
    from repro_torch.launch import dryrun, hlotop, reanalyze
    rec = _program()
    d = dryrun.report("granite-8b", "train_4k", "multi", 8, 1e6, rec, 4)
    d.update({"pod_size": 4, "memory": {"argument_bytes": 1}})
    path = tmp_path / "multi--granite-8b--train_4k.json"
    path.write_text(json.dumps(d, indent=1))
    with gzip.open(str(path).replace(".json", ".ops.json.gz"), "wt") as f:
        json.dump(rec, f)
    before = json.loads(path.read_text())
    assert reanalyze.reanalyze(str(path))
    assert json.loads(path.read_text()) == before
    assert d["hlo_flops"] == 8 * (2.0 * 8 * 16 * 32 + 2.0 * 2 * 4 * 4 * 8)
    colls, dots, traffic = hlotop.top_ops(rec, k=2)
    assert [c[1] for c in colls] == ["reduce-scatter", "all-gather"]
    assert [x[1] for x in dots] == ["mm", "bmm"]
    assert [x[0] for x in traffic] == [4 * 640, 2 * 896]


if __name__ == "__main__":
    {"ref": _ref_side, "port": _port_side}[sys.argv[1]](sys.argv[2],
                                                        sys.argv[3])
