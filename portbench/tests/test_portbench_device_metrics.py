"""The readers of the device's time a query (``device_ms_per_mquery``) and
of the step's share of the peak over that time (``mfu.busy``), on made-up
traces: busy time is the union of the device operations' intervals, a
served batch is one score readback, and a stretch with no kernel reads
nothing.  And which cells profile a stretch in their untraced runs."""

from __future__ import annotations

import types

import pytest

from portbench import loader, yardstick
from portbench.trace import Trace

B = 4096


def trace(ops):
    ops = sorted(ops, key=lambda o: o[1])
    busy, cur_s, cur_e = 0, ops[0][1], ops[0][2]
    for _n, s, e in ops[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    return Trace(ops, [], ops[0][1], max(e for _n, _s, e in ops), busy, [])


def batch(t0):
    """One served batch from ``t0`` (ns): its copy in, the lookup, the tower
    (overlapping the copy's end) and the score readback; 600 us busy."""
    return [("Memcpy HtoD (Pageable -> Device)", t0, t0 + 50_000),
            ("void lookup_fused_kernel<signed char, int, false>()", t0 + 40_000, t0 + 60_000),
            ("void ffma_product<128, 128>(float const*)", t0 + 60_000, t0 + 590_000),
            ("Memcpy DtoH (Device -> Pageable)", t0 + 590_000, t0 + 600_000)]


def outcome(tr, model):
    cell = types.SimpleNamespace(model=model, chips=1)
    return types.SimpleNamespace(trace=tr, batch=B, cell=cell)


def criteo():
    return loader.cell("criteo_int8.b4096.stream").model


@pytest.mark.parametrize("gap_ns", [0, 400_000, 5_000_000])
def test_device_ms_per_mquery_is_busy_time_over_scored_queries(gap_ns):
    ops = [o for k in range(10) for o in batch(k * (600_000 + gap_ns))]
    got = loader.reader("device_ms_per_mquery")(outcome(trace(ops), criteo()))
    # 10 batches, 0.6 ms busy each, whatever the idle between them
    assert got == pytest.approx(10 * 0.6 / (10 * B / 1e6))


def test_mfu_busy_is_the_step_flops_over_busy_time_and_peak():
    m = criteo()
    ops = [o for k in range(10) for o in batch(k * 1_000_000)]
    got = loader.reader("mfu.busy")(outcome(trace(ops), m))
    want = 100.0 * yardstick.step_flops_per_query(m) * 10 * B / (
        10 * 0.6e-3 * yardstick.PEAK_FLOPS[m["dtype"]])
    assert got == pytest.approx(want) and 0 < got < 100


@pytest.mark.parametrize("name", ["device_ms_per_mquery", "mfu.busy"])
def test_no_reading_without_kernels_or_trace(name):
    copies = [("Memcpy HtoD (Pageable -> Device)", 0, 10), ("Memcpy DtoH (Device -> Pageable)", 20, 30)]
    read = loader.reader(name)
    assert read(outcome(trace(copies), criteo())) is None
    assert read(outcome(None, criteo())) is None
    no_readback = [o for o in batch(0) if not o[0].startswith("Memcpy DtoH")]
    assert read(outcome(trace(no_readback), criteo())) is None


def test_cells_whose_end_to_end_metrics_read_the_trace_profile_every_run(tmp_path):
    import json

    bench = {"workloads": [{"name": "a"}, {"name": "b"}],
             "end_to_end": [{"name": "dev", "source": "device_trace", "workloads": ["a"]},
                            {"name": "setup_s", "source": "host_clock"}],
             "per_layer": []}
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    assert loader.needs_trace("a", root=str(tmp_path))
    assert not loader.needs_trace("b", root=str(tmp_path))
    assert loader.needs_trace("criteo_int8.b4096.stream")
