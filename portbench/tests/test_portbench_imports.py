"""Nothing the benchmark runs loads JAX or the JAX package, compared by
whole top-level names (``repro_torch`` begins with ``repro``), and the
plain reference loads nothing of the port."""
import json
import subprocess
import sys

from portbench import spec

BENCH = spec.load_benchmark()


def _loaded_after(code):
    prog = (f"import sys\nsys.path[:0] = [{str(spec.ROOT)!r}, "
            f"{str(spec.ROOT / 'src')!r}]\n{code}\n"
            "import json\nprint(json.dumps(sorted({m.split('.')[0] "
            "for m in sys.modules})))")
    p = subprocess.run([sys.executable, "-c", prog], capture_output=True,
                       text=True, timeout=300, cwd=spec.ROOT)
    assert p.returncode == 0, p.stderr
    return set(json.loads(p.stdout.strip().splitlines()[-1]))


def test_the_harness_and_the_port_load_no_jax_and_no_repro():
    readers = "".join(f"spec.metric_reader({m['name']!r})\n"
                      for m in BENCH["per_layer"])
    top = _loaded_after(
        "from portbench import (compare, control, harness, profiling, spec,"
        " system, traffic, yardstick)\n"
        "from portbench.reference import epaxos_lan, group_lan\n"
        "system.port()\n" + readers)
    assert "repro_torch" in top and "portbench" in top
    assert not top & {"jax", "jaxlib", "flax", "repro"}


def test_the_reference_loads_nothing_of_the_port():
    top = _loaded_after(
        "import portbench.reference.group_lan, "
        "portbench.reference.epaxos_lan")
    assert "torch" in top
    assert not top & {"repro_torch", "repro", "jax", "jaxlib", "flax"}


def test_the_harness_refuses_by_whole_top_level_names(monkeypatch):
    from portbench import harness
    before = set(harness.forbidden_modules())
    for name in ("repro_torch.core", "reprox", "jax_like", "repro.core.vs",
                 "jax.numpy", "flax"):
        monkeypatch.setitem(sys.modules, name, sys)
    assert set(harness.forbidden_modules()) - before <= {
        "repro.core.vs", "jax.numpy", "flax"}
    assert {"repro.core.vs", "jax.numpy", "flax"} <= set(
        harness.forbidden_modules())
