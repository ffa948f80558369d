"""On the card (``pytest -m cuda portbench``): one short traced run of the
measured cell reads every span metric, and the port's spans cover the
traced grid's idle gaps.  Without a card this skips."""
import math
import time

import pytest

SPAN_METRICS = ("draws_device_ms_per_step", "draws_host_ms_per_step",
                "lowering_ms_per_grid", "budget_ms_per_grid",
                "units_ms_per_grid", "idle_outside_spans_share")


@pytest.mark.cuda
def test_a_traced_run_reads_the_port_s_spans(cuda_device):
    from portbench import harness
    out = harness.run_cell("pig25.montecarlo", 3000000023, 1.0, True,
                           cuda_device, time.perf_counter())
    assert out["correct"] and out["failed"] == 0
    m = {k: v["value"] for k, v in out["metrics"].items()}
    for name in SPAN_METRICS:
        assert math.isfinite(m[name]) and m[name] >= 0, name
    assert m["idle_outside_spans_share"] < 1.0
    # the traced grid's recording: its draws' busy device time lies
    # within the device's, and its entry spans the traced window
    from repro_torch.core import spans
    rec = spans.last()
    (entry,) = [s for s in rec.spans if s.name == "entry"]
    host_ms = 1e3 * sum(s.t1 - s.t0 for s in rec.spans if s.name == "draws")
    steps = round(host_ms / m["draws_host_ms_per_step"])
    draws_s = 1e-3 * m["draws_device_ms_per_step"] * steps
    assert steps > 0 and 0 < draws_s <= out["device"]["busy_s"]
    assert entry.t1 - entry.t0 >= 0.99 * out["device"]["window_s"]
