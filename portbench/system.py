"""The system under test: a deployment file lowered to the arguments of
``repro_torch.core.vectorsim.simulate_scenario``, the port's public batch
entry (the call ``experiments/runner.py::_run_batch_scenario`` makes).
Only this module imports the port."""
from __future__ import annotations

import functools


@functools.lru_cache(maxsize=None)
def port():
    from repro_torch.core import PigConfig, WorkloadConfig, vectorsim
    from repro_torch.core.network import Topology
    return vectorsim, PigConfig, WorkloadConfig, Topology


def entry_kwargs(dep: dict) -> dict:
    """simulate_scenario's deployment arguments."""
    vectorsim, PigConfig, WorkloadConfig, Topology = port()
    net, wl = dep["network"], dep["workload"]
    if net["kind"] != "lan" or dep["clients"] != "closed":
        raise ValueError(f"{dep['name']}: only closed-loop LAN deployments "
                         f"are lowered here")
    kw = {"protocol": dep["protocol"], "n": int(dep["n"]),
          "topo": Topology(n=int(dep["n"]),
                           base_latency=float(net["oneway_latency_s"]),
                           jitter=float(net["jitter_s"])),
          "workload": WorkloadConfig(
              n_keys=int(wl["n_keys"]), payload_bytes=int(wl["payload_bytes"]),
              write_fraction=float(wl["write_fraction"]),
              key_dist=wl["key_dist"],
              conflict_rate=float(wl["conflict_rate"]))}
    if dep["protocol"] == "pigpaxos":
        kw["pig"] = PigConfig(n_groups=int(dep["relay_groups"]),
                              prc=int(dep["prc"]),
                              rotate_relays=bool(dep["rotate_relays"]),
                              single_group_majority=bool(
                                  dep["single_group_majority"]))
    return kw


def simulate(dep: dict, grid, device, info: dict):
    """One whole grid through the entry: per-cell result dicts, on the
    host.  ``info`` receives the entry's own counts (scan steps, fan-in
    launches)."""
    vectorsim = port()[0]
    return vectorsim.simulate_scenario(
        **entry_kwargs(dep), clients=grid.clients, seeds=grid.seeds,
        duration=grid.duration_s, warmup=grid.warmup_s, device=device,
        info=info)


def step_functions():
    """The entry's stages, by the names the traced grid puts spans
    around: lowering, the step loop, its summary."""
    vectorsim = port()[0]
    return vectorsim, {"lowering": ("build_config", "_stack_cells",
                                    "cells_from_numpy"),
                       "step loop": ("_run_cells",),
                       "summary": ("_summarize",)}
