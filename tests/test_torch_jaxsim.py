"""The port's ``core/jaxsim.py`` against the reference's
(``tests/test_analytical.py``'s Monte-Carlo and queueing cases, mirrored):
the relay-rotation loads equal the reference's bit for bit (the same
threefry draws, small-integer sums), the M/D/1 curves agree within 1e-6
relative (XLA contracts some of the curve's multiply-adds; the latency
times its 1 / (1 - rho) conditioning near saturation), and both meet the
paper's closed forms."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import analytical
from repro.core import jaxsim as rj
from repro_torch import prng
from repro_torch.core import analytical as tan
from repro_torch.core import jaxsim as tj


# ------------------------------------------------------- MC vs closed form
@pytest.mark.parametrize("n,r", [(9, 1), (9, 3), (25, 1), (25, 3), (25, 6)])
def test_mc_matches_closed_form(n, r):
    out = tj.mc_summary(n, r, rounds=8192, device="cpu")
    assert abs(out["leader"] - analytical.leader_messages(r)) < 1e-3
    assert abs(out["follower_mean"]
               - analytical.follower_messages(n, r)) < 0.05
    ref = rj.mc_summary(n, r, rounds=8192)
    assert sorted(out) == sorted(ref)
    for k in ref:
        assert out[k].dtype == ref[k].dtype and np.array_equal(out[k],
                                                               ref[k]), k


def test_mc_static_hotspot():
    """Without rotation the static relay's average load is the group
    cost; rotation amortizes it."""
    out = tj.mc_summary(25, 3, rounds=1024, rotating=False, device="cpu")
    assert abs(out["maxavg"] - analytical.static_relay_load(25, 3)) < 1e-3
    rot = tj.mc_summary(25, 3, rounds=8192, rotating=True, device="cpu")
    assert rot["maxavg"] < out["maxavg"]
    ref = rj.mc_summary(25, 3, rounds=1024, rotating=False)
    assert all(np.array_equal(out[k], ref[k]) for k in ref)


def test_per_round_loads_equal_reference():
    """Every round's loads, under a key other than seed 0's."""
    key = jax.random.PRNGKey(7)
    want = np.asarray(rj.relay_load_mc(key, 25, 3, 2048)["per_round"])
    got = tj.relay_load_mc(prng.PRNGKey(7), 25, 3, 2048, device="cpu")
    assert np.array_equal(got["per_round"].numpy(), want)
    assert got["mean"].dtype == torch.float32


# ------------------------------------------------------- queueing model
def test_latency_curve_hockey_stick():
    offered = [100.0, 1000.0, 1800.0]
    out = tj.latency_curve(offered, n=25, r=24, protocol="paxos",
                           device="cpu")
    lat = out["latency"].numpy()
    assert lat[0] < lat[1] < lat[2]
    assert np.all(np.isfinite(lat))
    out_sat = tj.latency_curve([2100.0], n=25, r=24, protocol="paxos",
                               device="cpu")
    assert not np.isfinite(out_sat["latency"].numpy())[0]


@pytest.mark.parametrize("protocol,r", [("paxos", 24), ("pigpaxos", 3),
                                        ("pigpaxos", 1), ("epaxos", 1)])
def test_latency_curve_matches_reference(protocol, r):
    offered = np.linspace(100.0, 60000.0, 97, dtype=np.float32)
    want = rj.latency_curve(jnp.asarray(offered), n=25, r=r,
                            protocol=protocol)
    got = tj.latency_curve(torch.from_numpy(offered), 25, r,
                           protocol=protocol, device="cpu")
    assert sorted(got) == sorted(want)
    # the M/D/1 wait carries 1 / (1 - rho): a last-bit change of rho
    # (XLA contracts lam * s) moves the latency by that factor more, so
    # the latency is held to 1e-6 relative times its conditioning
    rho = np.asarray(want["rho_leader"], np.float64)
    cond = 1.0 / (1.0 - np.clip(rho, 0.0, 0.999))
    for k in want:
        a, b = got[k].numpy(), np.asarray(want[k])
        assert np.array_equal(np.isfinite(a), np.isfinite(b)), k
        fin = np.isfinite(b)
        rel = np.abs(a[fin].astype(np.float64) - b[fin]) / np.abs(b[fin])
        tol = 1e-6 * (cond[fin] if k == "latency" else 1.0)
        assert (rel <= tol).all(), (k, rel.max())


def test_saturation_ordering_matches_paper():
    """Fig 9: PigPaxos >> EPaxos > Paxos at N=25."""
    paxos = tj.saturation_point(25, 24, protocol="paxos")
    pig = tj.saturation_point(25, 3, protocol="pigpaxos")
    assert pig > 3 * paxos    # ">3 folds improved throughput" (abstract)
    for proto, r in (("paxos", 24), ("pigpaxos", 3), ("epaxos", 1)):
        assert tj.saturation_point(25, r, protocol=proto) \
            == rj.saturation_point(25, r, protocol=proto)


# -------------------------------------------------- EPaxos fast-quorum dedupe
def test_epaxos_messages_pins_both_call_sites():
    """``analytical.epaxos_messages`` (the port's copy, equal to the
    reference's) is the fast-quorum message-load formula both call sites
    read."""
    for n in (5, 9, 25, 49):
        m = tan.epaxos_messages(n)
        assert m == analytical.epaxos_messages(n)
        cpu = 10e-6
        assert tj.saturation_point(n, 1, cpu_per_msg=cpu,
                                   protocol="epaxos") \
            == pytest.approx(1.0 / (m * cpu))
        out = tj.latency_curve([100.0], n=n, r=1, cpu_per_msg=cpu,
                               protocol="epaxos", device="cpu")
        assert float(out["rho_follower"][0]) \
            == pytest.approx(100.0 * m * cpu, rel=1e-5)


def test_default_device_is_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tj.mc_summary(9, 1, rounds=16)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tj.latency_curve([100.0], 9, 1)
