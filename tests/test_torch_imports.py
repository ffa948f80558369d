"""The port imports nothing of JAX and nothing of the JAX package: every
module of ``repro_torch`` and ``chip_smoke.py``."""
import os
import pkgutil
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "src")


def _modules():
    import repro_torch
    return ["repro_torch"] + [
        m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                              "repro_torch.")]


def test_importing_every_module_loads_no_jax_and_no_repro():
    mods = _modules()
    assert "repro_torch.core.vectorsim" in mods
    assert "repro_torch.experiments.run" in mods
    for m in ("repro_torch.models.model", "repro_torch.launch.serve",
              "repro_torch.kernels.flash_attention",
              "repro_torch.kernels.pig_aggregate",
              "repro_torch.collectives.schedules",
              "repro_torch.launch.mesh", "repro_torch.models.rwkv",
              "repro_torch.models.ssm", "repro_torch.models.moe",
              "repro_torch.kernels.ssm_scan",
              "repro_torch.faults.plan", "repro_torch.core.workload",
              "repro_torch.core.network", "repro_torch.experiments.catalog",
              "repro_torch.core.jaxsim", "repro_torch.core.analytical",
              "repro_torch.experiments.megagrid",
              "repro_torch.kernels.autograd", "repro_torch.optim.adamw",
              "repro_torch.data.pipeline", "repro_torch.train.step",
              "repro_torch.checkpoint.manager", "repro_torch.launch.train",
              "repro_torch.shard", "repro_torch.train.sharding",
              "repro_torch.roofline", "repro_torch.launch.dryrun",
              "repro_torch.launch.hlotop", "repro_torch.launch.reanalyze",
              "repro_torch.core.events", "repro_torch.core.messages",
              "repro_torch.core.quorums", "repro_torch.core.node",
              "repro_torch.core.pig", "repro_torch.core.paxos",
              "repro_torch.core.pigpaxos", "repro_torch.core.epaxos",
              "repro_torch.core.cluster", "repro_torch.faults.audit"):
        assert m in mods, m
    code = (
        "import importlib, sys\n"
        f"sys.path.insert(0, {ROOT!r})\n"
        f"for m in {mods!r} + ['chip_smoke']:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' "
        "or m.startswith(('jax.', 'jaxlib')) or m == 'repro' "
        "or m.startswith('repro.'))\n"
        "print('BAD', bad)\n")
    env = dict(os.environ, PYTHONPATH=SRC)
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=env, timeout=300, cwd=ROOT)
    assert r.returncode == 0, r.stderr
    assert "BAD []" in r.stdout, r.stdout


def test_sources_name_no_jax_and_no_repro():
    pat = re.compile(r"^\s*(import\s+(jax|jaxlib|repro)\b|"
                     r"from\s+(jax|jaxlib|repro)(\.|\s))", re.M)
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, names in os.walk(os.path.join(SRC, "repro_torch")):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    assert len(files) > 15
    for f in files:
        with open(f) as fh:
            hits = pat.findall(fh.read())
        assert not hits, (f, hits)
