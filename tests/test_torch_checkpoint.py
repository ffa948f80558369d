"""The port's checkpoints (``repro_torch.checkpoint``) against
``repro.checkpoint``, on the CPU: a state saved by both packages gives the
same manifest and the same bytes in every leaf file, and each package
restores the other's checkpoint bit for bit; a restart replays bit for
bit; a directory without a manifest is ignored; the JAX package's
``CoordinationService`` (handed in by the test: the port imports none)
commits the port's checkpoints; and ``launch.train`` trains, saves and
resumes."""
import filecmp
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro import models as jmodels
from repro import optim as joptim
from repro import train as jtrain
from repro.checkpoint import CheckpointManager as JManager
from repro.runtime import CoordinationService
from repro_torch import configs, convert, optim, train
from repro_torch.checkpoint import CheckpointManager
from repro_torch.data import DataConfig, SyntheticLMStream
from repro_torch.launch import train as train_cli

torch.set_num_threads(1)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _bits(a):
    if isinstance(a, torch.Tensor):
        a = a.view(torch.uint16) if a.dtype == torch.bfloat16 else a
        return a.numpy()
    a = np.asarray(a)
    return a.view(np.uint16) if str(a.dtype) == "bfloat16" else a


def _jax_state(arch, seed):
    """A JAX ``TrainState`` of ``arch``'s smoke config in bf16 with
    non-zero moments at step 5."""
    cfg = jconfigs.get_smoke_config(arch)
    params = jax.tree.map(np.asarray, jmodels.init_params(
        cfg, jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)
    noise = lambda t: jax.tree.map(lambda a: rng.standard_normal(
        a.shape).astype(np.float32), t)
    opt = joptim.adamw.OptState(noise(params), noise(params),
                                jnp.asarray(5, jnp.int32))
    return jtrain.TrainState(params, opt)


def _jax_leaves(state):
    return {f"params/{n}": a for n, a in _flat(state.params).items()} | {
        f"opt/{f}/{n}": a for f in ("mu", "nu")
        for n, a in _flat(getattr(state.opt, f)).items()} | {
        "opt/step": state.opt.step}


def _port_leaves(state):
    return {f"params/{n}": t for n, t in convert.stacked_params(
        state.params).items()} | {
        f"opt/{f}/{n}": t for f in ("mu", "nu")
        for n, t in getattr(state.opt, f).items()} | {
        "opt/step": state.opt.step}


def _same_state(port, ref):
    got, want = _port_leaves(port), _jax_leaves(ref)
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        np.testing.assert_array_equal(_bits(got[name]), _bits(w),
                                      err_msg=name)


@pytest.mark.parametrize("arch", ["rwkv6_3b", "zamba2_7b"])
def test_same_layout_and_bytes_as_the_reference(arch, tmp_path):
    ref = _jax_state(arch, 1)
    port = convert.train_state_from_jax(ref, configs.get_smoke_config(arch),
                                        "cpu")
    JManager(str(tmp_path / "jax"), async_save=False).save(7, ref)
    CheckpointManager(str(tmp_path / "port"), async_save=False).save(7, port)
    d_jax, d_port = tmp_path / "jax" / "step_7", tmp_path / "port" / "step_7"
    with open(d_jax / "manifest.json") as f:
        want = json.load(f)
    with open(d_port / "manifest.json") as f:
        got = json.load(f)
    assert got == want
    assert list(got["files"]) == list(want["files"])      # leaf order
    names = sorted(os.listdir(d_jax))
    assert names == sorted(os.listdir(d_port))
    match, mismatch, errors = filecmp.cmpfiles(d_jax, d_port, names,
                                               shallow=False)
    assert not mismatch and not errors and len(match) == len(names)


@pytest.mark.parametrize("arch", ["rwkv6_3b", "zamba2_7b",
                                  "qwen2_moe_a2_7b"])
def test_each_package_restores_the_others_checkpoint(arch, tmp_path):
    cfg = configs.get_smoke_config(arch)
    ref = _jax_state(arch, 2)
    # the port writes, the JAX package restores
    mgr = CheckpointManager(str(tmp_path / "p"), async_save=True)
    mgr.save(3, convert.train_state_from_jax(ref, cfg, "cpu"))
    mgr.wait()
    restored, step = JManager(str(tmp_path / "p")).restore(_jax_state(arch, 9))
    assert step == 3
    for name, a in _jax_leaves(restored).items():
        np.testing.assert_array_equal(_bits(a), _bits(_jax_leaves(ref)[name]),
                                      err_msg=name)
    # the JAX package writes, the port restores (into another state)
    JManager(str(tmp_path / "j"), async_save=False).save(4, ref)
    like = convert.train_state_from_jax(_jax_state(arch, 9), cfg, "cpu")
    got, step = CheckpointManager(str(tmp_path / "j")).restore(like)
    assert step == 4 and got is like
    _same_state(got, ref)


def _train(cfg, state, steps, start):
    stream = SyntheticLMStream(cfg, DataConfig(4, 32), device="cpu")
    opts = train.TrainOptions(remat=False, adamw=optim.AdamWConfig(
        lr=1e-2, warmup_steps=5, total_steps=200))
    fn = train.build_train_step(cfg, opts)
    for s in range(start, start + steps):
        state, _ = fn(state, stream.batch_at(s))
    return state


def test_restart_replays_bit_for_bit(tmp_path):
    """``tests/test_runtime.py::test_checkpoint_restart_bitexact`` on the
    port: save after step 5, go on to step 8, restore into a fresh state,
    replay steps 6-8: identical."""
    cfg = configs.get_smoke_config("musicgen_large").replace(n_layers=1,
                                                             vocab=64)
    new = lambda seed: train.init_train_state(
        cfg, torch.Generator().manual_seed(seed), "cpu")
    mgr = CheckpointManager(str(tmp_path), async_save=True)
    state = _train(cfg, new(0), 5, 0)
    mgr.save(5, state)
    mgr.wait()
    assert mgr.latest_step() == 5
    lost = _train(cfg, state, 3, 5)
    want = {n: t.clone() for n, t in _port_leaves(lost).items()}
    restored, step = mgr.restore(new(1))
    assert step == 5
    replay = _train(cfg, restored, 3, 5)
    for name, t in _port_leaves(replay).items():
        assert torch.equal(t, want[name]), name


def test_a_directory_without_a_manifest_is_ignored(tmp_path):
    cfg = configs.get_smoke_config("granite_8b")
    state = train.init_train_state(cfg, torch.Generator().manual_seed(0),
                                   "cpu")
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    assert mgr.latest_step() is None and mgr.restore(state) is None
    mgr.save(3, state)
    os.makedirs(tmp_path / "step_9")                  # a save cut short
    (tmp_path / "step_9" / "leaf_0.npy").write_bytes(b"")
    assert mgr.latest_step() == 3
    assert mgr.restore(state)[1] == 3


def test_the_reference_coordination_service_commits(tmp_path):
    """Any object with get/put commits ``ckpt/latest``; the JAX package's
    PigPaxos ``CoordinationService``, handed in here, does.  A step whose
    manifest exists but was not committed does not count."""
    cfg = configs.get_smoke_config("rwkv6_3b")
    state = train.init_train_state(cfg, torch.Generator().manual_seed(0),
                                   "cpu")
    coord = CoordinationService(n_nodes=5, n_groups=2)
    mgr = CheckpointManager(str(tmp_path), coord=coord, async_save=True)
    mgr.save(2, state)
    mgr.wait()
    assert coord.get("ckpt/latest") == {"step": 2, "dir": "step_2"}
    CheckpointManager(str(tmp_path), async_save=False).save(4, state)
    assert mgr.latest_step() == 2
    assert CheckpointManager(str(tmp_path)).latest_step() == 4
    assert mgr.restore(state)[1] == 2


def test_restore_refuses_another_config(tmp_path):
    small = configs.get_smoke_config("granite_8b")
    state = train.init_train_state(small, torch.Generator().manual_seed(0),
                                   "cpu")
    CheckpointManager(str(tmp_path), async_save=False).save(1, state)
    other = train.init_train_state(small.replace(d_ff=small.d_ff * 2),
                                   torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(ValueError, match="shape"):
        CheckpointManager(str(tmp_path)).restore(other)


def test_launch_train_trains_saves_and_resumes(tmp_path, capsys):
    args = ["--arch", "rwkv6-3b", "--smoke", "--device", "cpu", "--batch",
            "2", "--seq", "32", "--ckpt-dir", str(tmp_path),
            "--ckpt-every", "2"]
    out = train_cli.main(args + ["--steps", "3"])
    assert out["start"] == 0 and len(out["losses"]) == 3
    assert np.isfinite(out["losses"]).all() and out["latest"] == 2
    log = capsys.readouterr().out
    assert "arch=rwkv6-smoke" in log and "tokens/s" in log
    out = train_cli.main(args + ["--steps", "5", "--resume"])
    assert out["start"] == 2 and len(out["losses"]) == 3
    assert out["latest"] == 4
    assert "resumed from step 2" in capsys.readouterr().out
