"""The port's Pig collective schedules against the JAX package, on the CPU.

Each side runs in its own processes, from the same numpy-seeded inputs:
the JAX package in one subprocess on 4 forced host devices with a
``(2, 2)`` ``("pod", "data")`` mesh (as ``tests/collective_worker.py``
runs it, without its replicated ``model`` axis), and the port as 4 gloo
ranks (``repro_torch.launch.mesh``), one subprocess each, meeting through
a ``FileStore`` under ``tmp_path`` so that parallel test workers never
clash on a port.  This file is both the test and the workers' script
(``python tests/test_torch_collectives.py jax|torch DIR [RANK]``).

What is compared, and how closely:
- ``pig_allreduce`` with and without rotation: every sum has two terms
  (two pods, two ranks a pod), so bit for bit;
- ``direct_allreduce`` sums four terms in another order: rtol 1e-6, with
  an atol of 1e-6 (two f32 ulps at the largest partial sum, ~4) where the
  four values cancel;
- ``pig_allreduce_quantized`` and ``sync_grads("pig_q8")``: bit for bit
  against the reference run op by op (``shard_map`` outside ``jit``), with
  its relay sum in the reference's plain version
  (``repro.kernels.ref.pig_aggregate_ref``, patched in for the Pallas
  kernel inside the JAX subprocess: the interpret-mode kernel takes
  minutes outside ``jit``).  Under ``jit``, as the package runs it, XLA
  rewrites the division by 127 and contracts multiply-adds into FMAs, so
  the port is held there within two quantization steps.
"""
import os
import subprocess
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "src")
RANKS, NPODS, G = 4, 2, 2
X_SHAPE = (RANKS, 1031)          # one row a rank; odd: the padding path
X_BLOCK = 256
TREE_BLOCK = 64                  # G * 64 = 128 divides every smoke leaf
ROTATION = 3
ARCH = "granite-8b"
EAGER_LEAVES = ("final_norm", "layers/attn/wk")


# ------------------------------------------------------------ shared data
def _flat(tree, prefix=""):
    out = {}
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            out.update(_flat(tree[k], f"{prefix}{k}/"))
        else:
            out[prefix + k] = tree[k]
    return out


def _nest(flat):
    tree = {}
    for path, v in flat.items():
        *parents, leaf = path.split("/")
        node = tree
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = v
    return tree


def _bits(a):
    """An array as (storable bits, dtype name): bf16 through uint16."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return a.view(np.uint16), "bfloat16"
    return a, a.dtype.name


def _unbits(a, dtype):
    if dtype == "bfloat16":
        import ml_dtypes
        return a.view(ml_dtypes.bfloat16)
    return a


def _save(path, arrays):
    data = {}
    for k, v in arrays.items():
        data["a:" + k], dt = _bits(v)
        data["t:" + k] = np.array(dt)
    np.savez(path, **data)


def _load(path):
    with np.load(path) as z:
        return {k[2:]: _unbits(z[k], str(z["t:" + k[2:]]))
                for k in z.files if k.startswith("a:")}


def _make_inputs(d):
    """x, and two steps of per-rank granite-smoke gradients in the JAX
    ``init_params`` layout (layer axis stacked; bf16 weights, f32 norms),
    each leaf with a leading rank axis; values from numpy, rounded to the
    leaf's dtype by JAX."""
    import jax
    import jax.numpy as jnp
    from repro.configs import get_smoke_config
    from repro.models import init_params
    rng = np.random.default_rng(13)
    x = rng.standard_normal(X_SHAPE).astype(np.float32)
    shapes = jax.eval_shape(lambda k: init_params(get_smoke_config(ARCH), k),
                            jax.random.PRNGKey(0))
    arrays = {"x": x}
    for step in (1, 2):
        for path, s in _flat(shapes).items():
            v = rng.standard_normal((RANKS,) + s.shape).astype(np.float32)
            arrays[f"g{step}/{path}"] = np.asarray(
                jnp.asarray(v * 0.05).astype(s.dtype))
    _save(os.path.join(d, "inputs.npz"), arrays)
    return arrays


def _tree(arrays, prefix):
    return _nest({k[len(prefix):]: v for k, v in arrays.items()
                  if k.startswith(prefix)})


# -------------------------------------------------------------- JAX side
def _jax_side(d):
    import jax
    from jax.experimental.shard_map import shard_map
    from jax.sharding import PartitionSpec as P

    import repro.collectives.schedules as sch
    from repro.kernels import ref as jref
    assert jax.device_count() == RANKS, jax.device_count()
    mesh = jax.make_mesh((NPODS, G), ("pod", "data"))
    spec = P(("pod", "data"))
    inp = _load(os.path.join(d, "inputs.npz"))

    def run(fn, *args, outs=spec, eager=False):
        m = shard_map(fn, mesh=mesh, in_specs=(spec,) * len(args),
                      out_specs=outs, check_rep=False)
        return (m if eager else jax.jit(m))(*args)

    out = {}
    x = inp["x"]
    out["direct"] = run(lambda a: sch.direct_allreduce(a, ("pod", "data")), x)
    out["pig"] = run(lambda a: sch.pig_allreduce(a, "data", "pod"), x)
    out["pig_rot"] = run(lambda a: sch.pig_allreduce(a, "data", "pod",
                                                     rotation=ROTATION), x)
    g1, g2 = _tree(inp, "g1/"), _tree(inp, "g2/")

    def quantized(tag, g1, g2, eager):
        y, r = run(lambda a: sch.pig_allreduce_quantized(
            a, None, "data", "pod", block=X_BLOCK, rotation=ROTATION), x,
            outs=(spec, spec), eager=eager)
        out[f"{tag}q8/y"], out[f"{tag}q8/r"] = y, r
        s1, r1 = run(lambda t: sch.sync_grads(t, "pig_q8", block=TREE_BLOCK),
                     g1, outs=(spec, spec), eager=eager)
        s2, r2 = run(lambda t, r: sch.sync_grads(
            t, "pig_q8", residuals=r, block=TREE_BLOCK), g2, r1,
            outs=(spec, spec), eager=eager)
        for name, t in (("s1", s1), ("r1", r1), ("s2", s2), ("r2", r2)):
            for path, v in _flat(t).items():
                out[f"{tag}{name}/{path}"] = v

    # as the JAX package runs it: under jit, the relay sum in the Pallas
    # kernel (interpret mode)
    quantized("", g1, g2, eager=False)
    # op by op, the relay sum in the reference's plain version (the
    # interpret-mode kernel takes minutes outside jit), over the x row and
    # an f32 and a bf16 leaf (every op compiles on its own: ~3 s a leaf)
    sch.pig_aggregate_op = jref.pig_aggregate_ref
    quantized("eager_", *({k: t[k] for k in EAGER_LEAVES} for t in (
        _flat(g1), _flat(g2))), eager=True)
    try:
        run(lambda a: sch.sync_grads({"w": a}, "pig_q8", block=X_BLOCK), x,
            outs=(spec, spec))
        out["refused"] = np.array("")
    except TypeError as e:
        out["refused"] = np.array(f"TypeError: {e}")
    _save(os.path.join(d, "jax.npz"), {k: np.asarray(v)
                                       for k, v in out.items()})


# ------------------------------------------------------------ port side
def _torch_side(d, rank):
    from unittest import mock

    import torch
    import torch.distributed as dist

    from repro_torch.collectives import schedules as sch
    from repro_torch.convert import tree_from_jax
    from repro_torch.launch import mesh as tmesh
    torch.set_num_threads(1)
    tmesh.init(rank, RANKS, dist.FileStore(os.path.join(d, "store"), RANKS),
               device="cpu")
    m = tmesh.make_mesh(NPODS, G)
    assert (m.group.rank(), m.pod.rank()) == (rank % G, rank // G)
    inp = _load(os.path.join(d, "inputs.npz"))
    x = torch.from_numpy(inp["x"][rank:rank + 1])
    mine = {k: v[rank:rank + 1] for k, v in inp.items() if k != "x"}
    g1 = tree_from_jax(_tree(mine, "g1/"), "cpu")
    g2 = tree_from_jax(_tree(mine, "g2/"), "cpu")

    # bytes each schedule hands to a group that spans pods (the port's form
    # of collective_worker.py's HLO check): torch.distributed is patched
    # here, never in the package
    crossing = {}
    counting = {"now": None}

    def counted(name):
        real = getattr(dist, name)

        def wrapped(*args, group=None, **kw):
            t = args[0] if name == "all_reduce" else args[1]
            ranks = dist.get_process_group_ranks(group or dist.group.WORLD)
            if len({r // G for r in ranks}) > 1:
                key = counting["now"]
                crossing[key] = crossing.get(key, 0) + \
                    t.numel() * t.element_size()
            return real(*args, group=group, **kw)
        return wrapped

    names = ("all_reduce", "all_gather_into_tensor", "reduce_scatter_tensor")
    out = {}
    with mock.patch.multiple(dist, **{n: counted(n) for n in names}):
        for key, fn in (
                ("direct", lambda: sch.direct_allreduce(x, m.world)),
                ("pig", lambda: sch.pig_allreduce(x, m.group, m.pod)),
                ("pig_rot", lambda: sch.pig_allreduce(x, m.group, m.pod,
                                                      rotation=ROTATION)),
                ("q8", lambda: sch.pig_allreduce_quantized(
                    x, None, m.group, m.pod, block=X_BLOCK,
                    rotation=ROTATION))):
            counting["now"] = key
            res = fn()
            if key == "q8":
                out["q8/y"], out["q8/r"] = res
            else:
                out[key] = res
    s1, r1 = sch.sync_grads(g1, m, "pig_q8", block=TREE_BLOCK)
    s2, r2 = sch.sync_grads(g2, m, "pig_q8", residuals=r1, block=TREE_BLOCK)
    for name, t in (("s1", s1), ("r1", r1), ("s2", s2), ("r2", r2)):
        for path, v in _flat(t).items():
            out[f"{name}/{path}"] = v
    try:
        sch.sync_grads({"w": x}, m, "pig_q8", block=X_BLOCK)
        out["refused"] = ""
    except ValueError as e:
        out["refused"] = f"ValueError: {e}"
    arrays = {k: (np.array(v) if isinstance(v, str) else
                  v.view(torch.uint16).numpy().view(_bf16())
                  if v.dtype == torch.bfloat16 else v.numpy())
              for k, v in out.items()}
    arrays.update({f"bytes/{k}": np.array(v) for k, v in crossing.items()})
    _save(os.path.join(d, f"torch{rank}.npz"), arrays)
    dist.destroy_process_group()


def _bf16():
    import ml_dtypes
    return ml_dtypes.bfloat16


# ----------------------------------------------------------------- tests
@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both sides' outputs: (inputs, jax, [torch rank 0..3])."""
    d = str(tmp_path_factory.mktemp("pig_collectives"))
    inputs = _make_inputs(d)
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               OMP_NUM_THREADS="1")
    me = os.path.abspath(__file__)
    procs = [subprocess.Popen([sys.executable, me, "jax", d], env=env,
                              cwd=ROOT, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)]
    procs += [subprocess.Popen([sys.executable, me, "torch", d, str(r)],
                               env=env, cwd=ROOT, stdout=subprocess.PIPE,
                               stderr=subprocess.STDOUT, text=True)
              for r in range(RANKS)]
    logs = []
    for p in procs:
        try:
            logs.append(p.communicate(timeout=300)[0])
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
    for p, log in zip(procs, logs):
        assert p.returncode == 0, f"{p.args}:\n{log}"
    jax_out = _load(os.path.join(d, "jax.npz"))
    torch_out = [_load(os.path.join(d, f"torch{r}.npz"))
                 for r in range(RANKS)]
    return inputs, jax_out, torch_out


def _stacked(torch_out, key):
    return np.concatenate([t[key] for t in torch_out])


def _f32(a):
    return np.asarray(a).astype(np.float32)


@pytest.mark.parametrize("key", ["pig", "pig_rot"])
def test_pig_allreduce_matches_jax_bit_for_bit(runs, key):
    _, jx, tx = runs
    got = _stacked(tx, key)
    assert got.shape == X_SHAPE
    np.testing.assert_array_equal(got, jx[key])


def test_direct_allreduce_matches_jax(runs):
    inputs, jx, tx = runs
    got = _stacked(tx, "direct")
    np.testing.assert_allclose(got, jx["direct"], rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got[0], inputs["x"].sum(0), rtol=1e-6,
                               atol=1e-6)
    for r in range(1, RANKS):
        np.testing.assert_array_equal(got[r], got[0])


def _tree_keys(jx, prefix):
    return sorted(k[len(prefix):] for k in jx if k.startswith(prefix))


def _close_to_jit(got, want, largest_input):
    """The port against the reference under jit: XLA rewrites the division
    by 127 into a product with its rounded reciprocal (a scale one ulp off)
    and contracts the relay sum and the error subtraction into FMAs, so a
    value on a rounding tie may quantize one step apart in either pod.
    Bound: two quantization steps of an in-group shard (G ranks' sum),
    plus one ulp of the output's dtype."""
    got, want = _f32(got), _f32(want)
    step = G * largest_input / 127.0
    ulp = 2.0 ** -7 if np.asarray(got).dtype.name == "bfloat16" else 1e-6
    assert (np.abs(got - want) <= 2 * step + ulp * np.abs(want) + 1e-6).all()


@pytest.mark.parametrize("out", ["y", "r"])
def test_pig_q8_matches_jax(runs, out):
    """Bit for bit against the reference run op by op; within two
    quantization steps of it under jit."""
    inputs, jx, tx = runs
    got = _stacked(tx, f"q8/{out}")
    np.testing.assert_array_equal(got, jx[f"eager_q8/{out}"])
    _close_to_jit(got, jx[f"q8/{out}"], np.abs(inputs["x"]).max())
    if out == "y":
        # collective_worker.py's bound: within the quantization steps
        step = np.abs(inputs["x"]).max() / 127.0
        assert np.abs(got - inputs["x"].sum(0)).max() <= 2 * 2 * step + 1e-5


@pytest.mark.parametrize("step", ["s1", "r1", "s2", "r2"])
def test_sync_grads_pig_q8_tree_matches_jax(runs, step):
    """Two steps of error feedback over granite-smoke's 12 gradient leaves
    (bf16 weights, f32 norms), carried across with
    ``convert.tree_from_jax``: every leaf within two quantization steps of
    the reference under jit, and an f32 and a bf16 leaf bit for bit
    against the reference run op by op."""
    inputs, jx, tx = runs
    paths = _tree_keys(jx, f"{step}/")
    assert len(paths) == 12, paths
    for path in paths:
        got = _stacked(tx, f"{step}/{path}")
        want = jx[f"{step}/{path}"]
        assert got.dtype == want.dtype and got.shape == want.shape, path
        largest = np.abs(_f32(inputs[f"g{step[1]}/{path}"])).max()
        if step[1] == "2":      # the second step adds the first's residual
            largest += np.abs(_f32(_stacked(tx, f"r1/{path}"))).max()
        _close_to_jit(got, want, largest)
    for path in EAGER_LEAVES:
        got = _stacked(tx, f"{step}/{path}")
        want = jx[f"eager_{step}/{path}"]
        np.testing.assert_array_equal(got.view(np.uint8), want.view(np.uint8),
                                      err_msg=path)


def test_both_packages_refuse_a_padded_leaf_with_a_residual(runs):
    _, jx, tx = runs
    jmsg = str(jx["refused"])
    assert jmsg.startswith("TypeError") and "(1536,)" in jmsg \
        and "(1031,)" in jmsg, jmsg
    for t in tx:
        msg = str(t["refused"])
        assert msg.startswith("ValueError") and "1031 elements" in msg \
            and f"G*block = {G * X_BLOCK}" in msg, msg


def test_pig_hands_the_pod_group_at_most_055_of_direct(runs):
    """The cross-pod bytes of each schedule, counted on every rank: pig
    hands ~1/G of direct's to groups that span pods, pig_q8 less again."""
    _, _, tx = runs
    for t in tx:
        direct, pig = int(t["bytes/direct"]), int(t["bytes/pig"])
        assert direct == 4 * X_SHAPE[1]
        assert pig <= 0.55 * direct, (pig, direct)
        assert int(t["bytes/pig_rot"]) == pig
        assert int(t["bytes/q8"]) < pig


@pytest.mark.parametrize("arch", ["granite-8b", "qwen2.5-32b", "gemma-7b",
                                  "h2o-danube-1.8b"])
@pytest.mark.parametrize("smoke", [False, True])
def test_param_tree_shapes_match_jax_init_params(arch, smoke):
    """The gradient tree's layout (``models.param_tree_shapes``) is the JAX
    ``init_params`` tree's, leaf for leaf, shape and dtype."""
    import jax
    from repro.configs import get_config, get_smoke_config
    from repro.models import init_params
    from repro_torch import configs as tconfigs
    from repro_torch.models import param_tree_shapes
    jcfg = (get_smoke_config if smoke else get_config)(arch)
    tcfg = (tconfigs.get_smoke_config if smoke else tconfigs.get_config)(arch)
    want = _flat(jax.eval_shape(lambda k: init_params(jcfg, k),
                                jax.random.PRNGKey(0)))
    got = _flat(param_tree_shapes(tcfg))
    assert sorted(got) == sorted(want)
    for path, (shape, dtype) in got.items():
        assert shape == want[path].shape, path
        assert str(dtype).removeprefix("torch.") == want[path].dtype.name, path


def test_dcn_bytes_per_chip_equals_the_reference():
    from repro.collectives.schedules import dcn_bytes_per_chip as want
    from repro_torch.collectives.schedules import dcn_bytes_per_chip as got
    for args in ((1e9, 1, 2), (1e9, 256, 2), (3.5e8, 16, 4), (100.0, 4, 2),
                 (2**33, 16, 2)):
        for schedule in ("direct", "pig", "pig_q8"):
            assert got(*args, schedule) == want(*args, schedule)
    with pytest.raises(ValueError):
        got(1.0, 1, 2, "ring")


if __name__ == "__main__":
    if sys.argv[1] == "jax":
        _jax_side(sys.argv[2])
    else:
        _torch_side(sys.argv[2], int(sys.argv[3]))
