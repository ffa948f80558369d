"""The port's sharding specs against the reference's, at full width.

For every arch of the registry, both production meshes (16 x 16 and
2 x 16 x 16) and fsdp on and off, every parameter, AdamW moment, cache and
batch leaf must get the reference's ``PartitionSpec``, entry for entry.
Neither side needs devices or a world: the reference's ``_leaf_spec`` and
``fit_spec`` read only a mesh's ``axis_names`` and ``devices.shape`` (a
duck-typed mesh here), its trees come from ``jax.eval_shape``, and its
``cache_shardings`` / ``batch_sharding`` run with ``NamedSharding`` patched
to hand back the spec; the port's specs are computed on ``MeshShape``s and
meta-device modules.  A per-layer parameter of the port takes its stacked
leaf's spec without the L entry, which must be ``None``.  Also here: the
rules of ``shard`` itself (``fitted_spec``, ``spec_to_placements``,
``constrain`` outside a context) and of ``fit_spec``.
"""
import functools
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch.configs import ARCHS, get_config
from repro_torch.models import make_cache, model_class, reference_leaf
from repro_torch.optim import adamw_init
from repro_torch.shard import (MeshShape, P, constrain, fitted_spec,
                               spec_to_placements, unflatten)
from repro_torch.train import sharding as S

MESHES = {"single": (("data", "model"), (16, 16)),
          "multi": (("pod", "data", "model"), (2, 16, 16))}
CACHE_CELLS = {"decode_32k": (128, 32768, False),
               "long_500k": (1, 524288, True)}


def _ref_mesh(kind):
    names, shape = MESHES[kind]
    return SimpleNamespace(axis_names=names,
                           devices=SimpleNamespace(shape=shape))


def _port_mesh(kind):
    return MeshShape(*MESHES[kind])


@functools.cache
def _ref_params(arch):
    import jax
    from repro.configs import get_config as ref_config
    from repro.models import init_params
    cfg = ref_config(arch)
    return jax.eval_shape(lambda: init_params(cfg, jax.random.PRNGKey(0)))


def _ref_param_specs(arch, kind, fsdp):
    import jax
    from repro.train.sharding import _leaf_spec, fit_spec
    mesh = _ref_mesh(kind)
    out = {}

    def one(path, leaf):
        names = [getattr(k, "key", getattr(k, "name", str(k))) for k in path]
        spec = fit_spec(_leaf_spec(path, leaf.shape, fsdp), leaf.shape, mesh)
        out["/".join(names)] = tuple(spec)
    jax.tree_util.tree_map_with_path(one, _ref_params(arch))
    return out


@pytest.fixture
def spec_sharding(monkeypatch):
    """The reference's sharding module with NamedSharding handing back its
    spec (so the duck-typed mesh suffices)."""
    import repro.train.sharding as ref
    monkeypatch.setattr(ref, "NamedSharding", lambda mesh, spec: tuple(spec))
    return ref


@functools.cache
def _meta_model(arch):
    cfg = get_config(arch)
    return model_class(cfg)(cfg, device="meta")


@pytest.mark.parametrize("fsdp", [True, False])
@pytest.mark.parametrize("kind", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_and_moment_specs_match_reference(arch, kind, fsdp):
    ref = _ref_param_specs(arch, kind, fsdp)
    params = _meta_model(arch)
    got = S.param_shardings(params, _port_mesh(kind), fsdp)
    assert len(got) == len(dict(params.named_parameters()))
    for name, spec in got.items():
        leaf, layer = reference_leaf(name)
        want = ref[leaf]
        if layer is not None:
            assert want[0] is None, (leaf, want)
            want = want[1:]
        assert tuple(spec) == want, (name, spec, want)
    moments = S.opt_shardings(adamw_init(params), _port_mesh(kind), fsdp)
    assert set(moments["mu"]) == set(ref)
    for leaf, spec in moments["mu"].items():
        assert tuple(spec) == ref[leaf], (leaf, spec, ref[leaf])
        assert moments["nu"][leaf] == spec
    assert moments["step"] == P()


@pytest.mark.parametrize("cell", list(CACHE_CELLS))
@pytest.mark.parametrize("kind", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_specs_match_reference(arch, kind, cell, spec_sharding):
    import jax
    from repro.configs import get_config as ref_config
    from repro.models import make_cache as ref_make_cache
    B, seq, long = CACHE_CELLS[cell]
    ref_cache = jax.eval_shape(lambda: ref_make_cache(ref_config(arch), B,
                                                      max_len=seq))
    want = spec_sharding.cache_shardings(ref_cache, _ref_mesh(kind),
                                         kind == "multi", shard_kv_seq=long)
    cache = make_cache(get_config(arch), B, max_len=seq, device="meta")
    got = S.cache_shardings(cache, _port_mesh(kind), kind == "multi",
                            shard_kv_seq=long)
    assert set(got) == set(want)
    for g in got:
        assert set(got[g]) == set(want[g])
        for n, spec in got[g].items():
            assert tuple(spec) == want[g][n], (g, n, spec, want[g][n])


@pytest.mark.parametrize("kind", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_batch_specs_match_reference(arch, kind, spec_sharding):
    from repro.configs import get_config as ref_config
    from repro.data.pipeline import make_batch_specs as ref_specs
    from repro_torch.data.pipeline import make_batch_specs
    want = spec_sharding.batch_sharding(ref_specs(ref_config(arch), 256, 4096),
                                        _ref_mesh(kind), kind == "multi")
    got = S.batch_sharding(make_batch_specs(get_config(arch), 256, 4096),
                           _port_mesh(kind), kind == "multi")
    assert {n: tuple(s) for n, s in got.items()} == want


# ----------------------------------------------------------------- rules
def test_fit_spec_drops_and_replaces_axes():
    mesh = MeshShape(("data", "model"), (16, 16))
    # 60 experts can't split 16 ways: 'model' goes to the next dim that
    # takes it, from the last, never dim 0 of a stacked leaf
    assert S.fit_spec(P(None, "model", "data", None), (24, 60, 2048, 1408),
                      mesh) == P(None, None, "data", "model")
    assert S.fit_spec(P(None, "model", "data", None), (24, 60, 2048, 1000),
                      mesh) == P(None, None, ("data", "model"), None)
    # L = 32 would take 'model', but dim 0 of a stacked leaf is skipped
    assert S.fit_spec(P(None, "model", None), (32, 40, 24), mesh) == \
        P(None, None, None)
    # two dims: dim 0 is not a layer axis
    assert S.fit_spec(P("model", None), (40, 32), mesh) == P(None, "model")
    # a divisible prefix of a two-axis entry is kept
    assert S.fit_spec(P(("data", "model"),), (48,), mesh) == P("data")


def test_fitted_spec_and_placements():
    from torch.distributed.tensor import Replicate, Shard
    mesh = MeshShape(("pod", "data", "model"), (2, 4, 4))
    rules = S.activation_rules(True)
    spec = fitted_spec((16, 7, 8, 6), ("batch", "seq", "heads", None),
                       rules, mesh)
    assert spec == P(("pod", "data"), None, "model", None)
    # 2 kv heads over a 4-way axis: dropped
    assert fitted_spec((16, 7, 2, 6), ("batch", "seq", "kv_heads", None),
                       rules, mesh) == P(("pod", "data"), None, None, None)
    assert spec_to_placements(spec, mesh) == (Shard(0), Shard(0), Shard(2))
    assert spec_to_placements(P(None, "model"), mesh) == (
        Replicate(), Replicate(), Shard(1))
    with pytest.raises(ValueError, match="shards two dimensions"):
        spec_to_placements(P("model", "model"), mesh)


def test_constrain_and_unflatten_are_plain_outside_a_mesh():
    x = torch.arange(24.0).reshape(2, 12)
    assert constrain(x, "batch", "embed") is x
    assert torch.equal(unflatten(x, 1, (3, 4)), x.reshape(2, 3, 4))


def test_spec_rules_equal_reference_rules():
    from repro.train import sharding as ref
    assert S.activation_rules(True, True) == ref.activation_rules(True, True)
    assert S.activation_rules(False) == ref.activation_rules(False)
    assert {k: (tuple(a), tuple(b)) for k, (a, b) in
            S._MATRIX_RULES.items()} == {
        k: (tuple(a), tuple(b)) for k, (a, b) in ref._MATRIX_RULES.items()}
    assert {k: (tuple(a), tuple(b)) for k, (a, b) in
            S._MOE_RULES.items()} == {
        k: (tuple(a), tuple(b)) for k, (a, b) in ref._MOE_RULES.items()}
    np.testing.assert_equal(len(S._MATRIX_RULES), 15)
