"""The port's data stream (``repro_torch.data``) against ``repro.data``, on
the CPU: both draw from numpy, so tokens, labels and the stub frontends'
embeddings (f32 rounded to bf16 to nearest even) are held bit for bit;
the prefetch thread yields the steps in order and stops."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro import data as jdata
from repro_torch import configs, data


def _bits(a):
    a = np.asarray(a)
    return a.view(np.uint16) if str(a.dtype) == "bfloat16" else a


def _torch_bits(t):
    if t.dtype == torch.bfloat16:
        return t.view(torch.uint16).numpy()
    return t.numpy()


def test_config_mirrors_the_reference():
    assert ([f.name for f in dataclasses.fields(data.DataConfig)]
            == [f.name for f in dataclasses.fields(jdata.DataConfig)])
    assert (dataclasses.asdict(data.DataConfig(8, 64))
            == dataclasses.asdict(jdata.DataConfig(8, 64)))


@pytest.mark.parametrize("arch", ["h2o_danube_1_8b", "rwkv6_3b",
                                  "musicgen_large", "internvl2_76b"])
@pytest.mark.parametrize("seed,n_hosts,host_id", [(0, 1, 0), (3, 2, 1)])
def test_batch_at_bit_for_bit(arch, seed, n_hosts, host_id):
    dc = dict(global_batch=4, seq_len=24, seed=seed, n_hosts=n_hosts,
              host_id=host_id)
    ref = jdata.SyntheticLMStream(jconfigs.get_smoke_config(arch),
                                  jdata.DataConfig(**dc))
    ours = data.SyntheticLMStream(configs.get_smoke_config(arch),
                                  data.DataConfig(**dc), device="cpu")
    for step in (0, 1, 17):
        want, got = ref.batch_at(step), ours.batch_at(step)
        assert sorted(got) == sorted(want)
        for name, w in want.items():
            assert got[name].device.type == "cpu"
            assert tuple(got[name].shape) == w.shape
            assert str(got[name].dtype).split(".")[-1] == str(w.dtype)
            np.testing.assert_array_equal(_torch_bits(got[name]), _bits(w),
                                          err_msg=f"{name} step {step}")
    assert (got.get("embeds") is not None) == bool(
        configs.get_smoke_config(arch).frontend)


def test_prefetch_yields_steps_in_order_and_stops():
    cfg = configs.get_smoke_config("granite_8b")
    stream = data.SyntheticLMStream(cfg, data.DataConfig(2, 16, seed=5),
                                    prefetch=2, device="cpu")
    stream.start(step=7)
    try:
        got = []
        for step, batch in stream:
            got.append(step)
            want = stream.batch_at(step)
            for name in want:
                assert torch.equal(batch[name], want[name])
            if len(got) == 5:
                break
    finally:
        stream.stop()
    assert got == [7, 8, 9, 10, 11]
    assert stream._thread is None and stream._q.empty()


def test_batch_specs_match_the_reference():
    for arch in ("granite_8b", "musicgen_large"):
        want = jdata.make_batch_specs(jconfigs.get_smoke_config(arch), 8, 32)
        got = data.make_batch_specs(configs.get_smoke_config(arch), 8, 32)
        assert sorted(got) == sorted(want)
        for name, spec in want.items():
            shape, dtype = got[name]
            assert shape == spec.shape
            assert jnp.dtype(str(dtype).split(".")[-1]) == spec.dtype


def test_stream_refuses_an_uneven_host_split():
    with pytest.raises(ValueError, match="hosts"):
        data.SyntheticLMStream(configs.get_smoke_config("granite_8b"),
                               data.DataConfig(5, 16, n_hosts=2),
                               device="cpu")
