"""The port's trace report (``repro_torch/obs/report.py``), the counterpart
of tests/test_obs_report.py: validation catches malformed traces, the
summaries aggregate spans and counters, and the CLI exits 0 on a valid
trace and 1 on an invalid one.  The same fixtures go through the JAX
package's ``repro.obs.report`` (standard library only) and must give the
same errors, summaries and tables; a trace that the port's tracer writes
around a real sweep on the CPU must validate under both.
"""

import json

import numpy as np
import pytest

from repro.obs import report as r_report
from repro_torch.core.allpairs import quorum_allpairs
from repro_torch.core.comm import SingleProcessComm, shard
from repro_torch.core.placement import get_placement
from repro_torch.obs import report as report_mod
from repro_torch.obs import trace as trace_mod


def _sample_trace():
    tr = trace_mod.Tracer()
    with tr.span("sweep.gather", P=8):
        pass
    with tr.span("sweep.gather"):
        pass
    tr.record("faults.round", 0.002, round=0)
    tr.count("comm.ppermute.gather_bytes", 864)
    tr.count("serving.queries", 5, device=0)
    tr.count("serving.queries", 7, device=1)
    return tr.chrome_trace()


def test_validate_accepts_tracer_output():
    assert report_mod.validate_chrome_trace(_sample_trace()) == []


MUTATIONS = [
    (lambda o: o.pop("traceEvents"), "traceEvents"),
    (lambda o: o["traceEvents"][0].pop("name"), "missing 'name'"),
    (lambda o: o["traceEvents"][0].pop("dur"), "ph=X needs dur"),
    (lambda o: o["traceEvents"][0].update(dur=-1.0), "ph=X needs dur"),
    (lambda o: o["repro"].update(version="x"), "repro.version"),
    (lambda o: o["repro"].update(counters=[1]), "repro.counters"),
]


@pytest.mark.parametrize("mutate,needle", MUTATIONS)
def test_validate_flags_malformed(mutate, needle):
    """Each malformed trace is flagged, with the reference's messages."""
    obj = _sample_trace()
    mutate(obj)
    errors = report_mod.validate_chrome_trace(obj)
    assert errors and any(needle in e for e in errors), errors
    assert errors == r_report.validate_chrome_trace(obj)


def test_validate_counter_sample_needs_value():
    obj = _sample_trace()
    c = next(e for e in obj["traceEvents"] if e["ph"] == "C")
    del c["args"]["value"]
    errors = report_mod.validate_chrome_trace(obj)
    assert any("ph=C needs args.value" in e for e in errors), errors


def test_validate_non_dict_top_level():
    assert report_mod.validate_chrome_trace([1, 2]) == [
        "top level is not an object"]


def test_span_summary_aggregates_per_name():
    s = report_mod.span_summary(_sample_trace())
    assert s["sweep.gather"]["count"] == 2
    assert s["faults.round"]["count"] == 1
    assert abs(s["faults.round"]["total_ms"] - 2.0) < 0.5
    for row in s.values():
        assert row["max_ms"] >= row["mean_ms"] >= 0
    totals = [row["total_ms"] for row in s.values()]
    assert totals == sorted(totals, reverse=True)


def test_counter_summary_prefers_repro_section():
    c = report_mod.counter_summary(_sample_trace())
    assert c["comm.ppermute.gather_bytes"] == {"-1": 864.0, "total": 864.0}
    assert c["serving.queries"] == {"0": 5.0, "1": 7.0, "total": 12.0}


def test_counter_summary_falls_back_to_samples():
    obj = _sample_trace()
    del obj["repro"]["counters"]
    c = report_mod.counter_summary(obj)
    assert c["serving.queries"]["total"] == 12.0
    assert c == r_report.counter_summary(obj)


def test_render_tables():
    obj = _sample_trace()
    out = report_mod.render(obj)
    assert "sweep.gather" in out and "faults.round" in out
    assert "comm.ppermute.gather_bytes" in out
    assert "(program-wide)" in out            # device -1 counters
    assert "0:5 1:7" in out                   # per-device counters
    assert out == r_report.render(obj)


def test_load_trace_raises_on_invalid(tmp_path):
    p = tmp_path / "bad.json"
    p.write_text(json.dumps({"traceEvents": [{"ph": "X"}]}))
    with pytest.raises(ValueError, match="invalid Chrome trace"):
        report_mod.load_trace(p)


def test_cli_valid_and_invalid(tmp_path, capsys):
    good = tmp_path / "good.json"
    good.write_text(json.dumps(_sample_trace()))
    assert report_mod.main([str(good)]) == 0
    out = capsys.readouterr().out
    assert "sweep.gather" in out and "trace:" in out

    bad = tmp_path / "bad.json"
    bad.write_text("{not json")
    assert report_mod.main([str(bad)]) == 1
    assert "INVALID" in capsys.readouterr().out

    missing = tmp_path / "nope.json"
    assert report_mod.main([str(missing)]) == 1


@pytest.mark.parametrize("mode", ["batched", "overlap", "scan"])
def test_report_reads_a_traced_sweep(tmp_path, capsys, mode):
    """A trace the port's tracer exports around a dense sweep on the CPU is
    valid, and both packages' reports read the same spans and counters."""
    comm = SingleProcessComm(5, "cpu")
    x = shard(np.random.default_rng(0).normal(size=(20, 3)), comm)
    path = tmp_path / "sweep.json"
    tr = trace_mod.configure(path=path)
    try:
        quorum_allpairs(lambda a, b: (a * b.sum(), b * a.sum()), x, comm,
                        mode=mode, placement=get_placement("cyclic", 5))
        tr.export()
    finally:
        trace_mod.reset()
    assert report_mod.main([str(path)]) == 0
    out = capsys.readouterr().out
    assert "sweep.gather" in out and "comm.ppermute.gather_bytes" in out
    obj = report_mod.load_trace(path)
    assert report_mod.counter_summary(obj) == r_report.counter_summary(obj)
    assert set(report_mod.span_summary(obj)) == set(
        r_report.span_summary(obj))
    assert r_report.main([str(path)]) == 0
