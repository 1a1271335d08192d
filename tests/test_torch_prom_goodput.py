"""The port's Prometheus exposition and goodput ledger against the JAX
package's, on the CPU. ``prom``: ``render``, ``merge_expositions`` and
``write_textfile`` are byte-equal over registries filled alike (label and
help escapes, NaN / ±Inf / large values, histograms, the gauge merge
policy, injected labels), and the scrape endpoint serves the render.
``goodput``: the same timer / attribute sequence under the same patched
``perf_counter_ns`` gives equal window reports (pid and wall time aside),
``merge_reports`` agrees, and each package's ``write_gang_report`` over
the other's rank files writes the same GOODPUT.json. Tolerances: none.
"""
import json
import math
import os
import time
import urllib.request

import pytest

from paddle_tpu.observability import goodput as JGP
from paddle_tpu.observability import metrics as JM
from paddle_tpu.observability import prom as JP
from paddle_tpu_torch.observability import goodput as TGP
from paddle_tpu_torch.observability import metrics as TM
from paddle_tpu_torch.observability import prom as TP
from paddle_tpu_torch.tools import goodput_report as GR


def _fill(mod):
    """One registry of every kind, filled the same way."""
    reg = mod.MetricsRegistry()
    c = reg.counter("paddle_test_requests_total",
                    'Requests "served"\\n by code', ("code", "route"))
    c.labels("200", "/generate").inc(3)
    c.labels("429", 'a"b\\c\nd').inc(1.5)
    g = reg.gauge("paddle_serve_queue_depth", "queue depth")
    g.set(4)
    lv = reg.gauge("paddle_test_level", "levels", ("k",))
    lv.labels("nan").set(float("nan"))
    lv.labels("inf").set(float("inf"))
    lv.labels("ninf").set(float("-inf"))
    lv.labels("big").set(3e15)
    lv.labels("frac").set(0.1)
    h = reg.histogram("paddle_test_ms", "latency", ("phase",),
                      buckets=(1.0, 5.0, 25.0))
    for v in (0.5, 3.0, 3.0, 30.0, 7.25):
        h.labels("prefill").observe(v)
    h.labels("decode").observe(2.0)
    reg.counter("paddle_test_empty_total", "")
    return reg


def test_render_is_byte_equal():
    got, want = TP.render(_fill(TM)), JP.render(_fill(JM))
    assert got == want
    assert 'le="+Inf"' in got and "NaN" in got and '\\"' in got
    assert TP.render(TM.MetricsRegistry()) == "" == JP.render(
        JM.MetricsRegistry())


def test_merge_and_textfile_are_byte_equal(tmp_path):
    texts = [TP.render(_fill(TM)), JP.render(_fill(JM))]
    extra = [[("replica", "0"), ("role", "prefill")],
             [("replica", "1"), ("role", "decode")]]
    for kw in ({}, {"extra_labels": extra},
               {"gauge_merge": {"paddle_test_level": "sum"}}):
        assert TP.merge_expositions(texts, **kw) == \
            JP.merge_expositions(texts, **kw)
    assert TP.GAUGE_MERGE_POLICY == JP.GAUGE_MERGE_POLICY
    assert TP.GAUGE_MERGE_SUM == JP.GAUGE_MERGE_SUM
    a = TP.write_textfile(str(tmp_path / "t.prom"), _fill(TM))
    b = JP.write_textfile(str(tmp_path / "j.prom"), _fill(JM))
    with open(a) as fa, open(b) as fb:
        assert fa.read() == fb.read()


def test_scrape_endpoint_serves_the_render():
    reg = _fill(TM)
    srv = TP.MetricsHTTPServer(port=0, registry=reg).start()
    try:
        with urllib.request.urlopen(
                f"http://127.0.0.1:{srv.port}/metrics", timeout=10) as r:
            assert r.headers["Content-Type"].startswith(
                "text/plain; version=0.0.4")
            assert r.read().decode() == TP.render(reg)
    finally:
        srv.stop()


class _Clock:
    def __init__(self):
        self.t = 0

    def __call__(self):
        self.t += 1_000_000          # 1 ms a call
        return self.t


def _ledger_script(mod, monkeypatch):
    """A window with nested exclusive timers, an attributed span and an
    uncovered stretch; the report and the ledger's totals."""
    monkeypatch.setattr(time, "perf_counter_ns", _Clock())
    led = mod.GoodputLedger(registry=(TM if mod is TGP else JM)
                            .MetricsRegistry())
    led.start_window()
    with led.timer("productive_step"):
        with led.timer("compile"):
            pass
        with led.timer("device_wait"):
            with led.timer("input_stall"):
                pass
    led.attribute("restart_downtime", 0.25)
    with led.timer("checkpoint_save"):
        pass
    time.perf_counter_ns()           # an uncovered millisecond: other
    report = led.end_window(extra={"exit": "complete"})
    return report, led.totals()


def test_same_timers_give_equal_window_reports(monkeypatch):
    got, got_tot = _ledger_script(TGP, monkeypatch)
    want, want_tot = _ledger_script(JGP, monkeypatch)
    for r in (got, want):
        assert r.pop("pid") == os.getpid()
        r.pop("time")
    assert got == want and got_tot == want_tot
    assert TGP.CATEGORIES == JGP.CATEGORIES
    # the window's timers and its uncovered remainder add up to its wall;
    # the attributed 0.25 s lies outside it
    assert sum(got["categories"].values()) - 0.25 == pytest.approx(
        got["wall_s"])
    assert got["categories"]["other"] > 0
    reports = [dict(got, rank=0), dict(got, rank=1)]
    assert TGP.merge_reports(reports, restart_downtime_s=1.5) == \
        JGP.merge_reports(reports, restart_downtime_s=1.5)


def _rank_files(mod, d, monkeypatch):
    for rank in (0, 1):
        monkeypatch.setenv("PADDLE_TRAINER_ID", str(rank))
        report, _ = _ledger_script(mod, monkeypatch)
        assert mod.maybe_export(report, dirname=str(d))


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_gang_reports_read_each_others_rank_files(tmp_path, monkeypatch,
                                                  writer):
    """Rank files by one package, GOODPUT.json by each: equal documents
    (paths aside), with the restart downtime charged to every rank."""
    src, other = (JGP, TGP) if writer == "port" else (TGP, JGP)
    _rank_files(src, tmp_path, monkeypatch)
    docs = {}
    for name, mod in (("a", other), ("b", src)):
        out = str(tmp_path / f"GOODPUT.{name}.json")
        assert mod.write_gang_report(str(tmp_path), restart_downtime_s=2.0,
                                     nranks=2, extra={"restarts": 1},
                                     out_path=out) == out
        with open(out) as f:
            docs[name] = json.load(f)
        docs[name].pop("gang_exposition")
    assert docs["a"] == docs["b"]
    gang = docs["a"]
    assert gang["rank_reports"] == 2 and gang["restarts"] == 1
    assert gang["categories"]["restart_downtime"] == pytest.approx(
        2 * (2.0 + 0.25))
    assert 0 < gang["gang_goodput_fraction"] <= 1
    with open(tmp_path / "gang_metrics.prom") as f:
        assert "paddle_goodput_seconds_total" in f.read()


def test_goodput_report_cli(tmp_path, monkeypatch, capsys):
    _rank_files(TGP, tmp_path, monkeypatch)
    assert GR.main(["--dir", str(tmp_path), "--restart-downtime", "0.5",
                    "--max-unaccounted", "1.0"]) == 0
    with open(tmp_path / "GOODPUT.json") as f:
        gang = json.load(f)
    assert gang["nranks"] == 2 and gang["restart_downtime_s"] == 0.5
    # an instrumentation gap fails the gate
    assert GR.main(["--dir", str(tmp_path),
                    "--max-unaccounted", "0.0"]) == 1
    assert GR.main(["--dir", str(tmp_path / "none")]) == 1
    assert not math.isnan(gang["unaccounted_fraction"])
