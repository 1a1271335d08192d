"""The port's SLO engine and fleet poller against the JAX package's, on
the CPU. The same request stream under an injected clock gives equal
``slo_status()`` documents at every evaluation (burn rates, the latched
alert, the error-budget ledger), one forensic dump per alert, and the
ledger survives a warm restart through the port's ``ElasticCheckpointer``
— restored by either package from the other's store. ``role_rollups``
are equal over equal replica samples, and a ``FleetPoller`` tick writes
the reference's ``FLEET.json`` (its timestamp aside) with the merged
exposition byte-equal. Tolerances: none.
"""
import json

import pytest

from paddle_tpu.observability import fleet as JFL
from paddle_tpu.observability import slo as JSLO
from paddle_tpu_torch.observability import fleet as TFL
from paddle_tpu_torch.observability import slo as TSLO


def _stream(engine):
    """60 s of traffic at 4 requests a second, turning bad at t=30 (slow
    first tokens, errors, sheds), evaluated every 5 s; the statuses."""
    out = []
    for i in range(240):
        t = i * 0.25
        bad = t >= 30 and i % 3 != 0
        engine.note_request(
            ttft_ms=900.0 if bad else 120.0 + i % 7,
            tpot_ms=20.0 + (i % 5) * (20 if bad else 1),
            code=500 if bad and i % 5 == 0 else 200,
            shed=bad and i % 7 == 0, trace_id=i, request_id=f"r{i}", t=t)
        if i % 20 == 19:
            out.append(engine.evaluate(now=t))
    return out


def _engine(mod, **kw):
    return mod.SLOEngine(fast_window_s=10.0, slow_window_s=40.0, **kw)


def test_same_stream_gives_equal_status(tmp_path):
    want = _stream(_engine(JSLO, forensics=JSLO.ForensicDir(
        str(tmp_path / "j"))))
    eng = _engine(TSLO, forensics=TSLO.ForensicDir(str(tmp_path / "t")),
                  state_fn=lambda: {"queue_depth": 3})
    got = _stream(eng)
    assert got == want
    last = got[-1]
    assert not last["ok"] and "ttft_p99" in last["alerting"]
    fired = sum(s["objectives"]["ttft_p99"]["alert_fired"] for s in got)
    assert fired == 1 and last["alerts_total"]["ttft_p99"] == 1  # latched
    files = eng.forensics.files()
    assert len(files) == sum(last["alerts_total"].values())
    with open(tmp_path / "t" / files[0]) as f:
        dump = json.load(f)
    assert dump["kind"] == "slo_breach" and dump["state"] == {
        "queue_depth": 3}
    assert TSLO.DEFAULT_OBJECTIVES == tuple(
        TSLO.Objective(o.name, o.signal, o.target, o.percentile, o.budget)
        for o in JSLO.DEFAULT_OBJECTIVES)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_error_budget_survives_a_restart_across_packages(tmp_path, writer):
    """One package's engine checkpoints its ledger; the other's resumes
    it (the store is the elastic checkpoint format both read)."""
    src, dst = (TSLO, JSLO) if writer == "port" else (JSLO, TSLO)
    a = _engine(src, ledger_dir=str(tmp_path))
    _stream(a)
    status = a.evaluate(now=60.0)
    a.close()
    b = _engine(dst, ledger_dir=str(tmp_path))
    again = b.evaluate(now=1e6)          # every sample out of its windows
    for name, obj in status["objectives"].items():
        assert again["objectives"][name]["ledger"] == obj["ledger"]
        assert again["objectives"][name]["budget_remaining"] == \
            obj["budget_remaining"]
    assert again["alerts_total"] == status["alerts_total"]
    b.close()


def _samples(mod):
    text = ("# HELP paddle_serve_requests_total r\n"
            "# TYPE paddle_serve_requests_total counter\n"
            'paddle_serve_requests_total{code="200"} 5\n'
            'paddle_serve_requests_total{code="429"} 2\n'
            "# TYPE paddle_serve_queue_depth gauge\n"
            "paddle_serve_queue_depth 3\n"
            "# TYPE paddle_serve_slot_occupancy gauge\n"
            "paddle_serve_slot_occupancy 0.75\n"
            "# TYPE paddle_serve_ttft_ms histogram\n"
            'paddle_serve_ttft_ms_bucket{le="+Inf"} 4\n'
            "paddle_serve_ttft_ms_sum 480\n"
            "paddle_serve_ttft_ms_count 4\n")
    return [mod.ReplicaSample(0, "prefill", True, 0.5, text, 1, 2),
            mod.ReplicaSample(1, "decode", True, 1.5,
                              text.replace(" 3\n", " 1\n"), 0, 1),
            mod.ReplicaSample(2, "decode", False, None, None, 2, 0),
            mod.ReplicaSample(3, "decode", True, 0.1, "garbage line\n")]


def test_role_rollups_equal():
    got = TFL.role_rollups(_samples(TFL))
    assert got == JFL.role_rollups(_samples(JFL))
    assert got["decode"]["replicas"] == 3 and got["decode"]["alive"] == 2
    assert got["prefill"]["latency_mean_ms"]["paddle_serve_ttft_ms"] == 120


def test_fleet_poller_tick_matches(tmp_path):
    docs = {}
    for name, mod, slo in (("port", TFL, TSLO), ("jax", JFL, JSLO)):
        out = str(tmp_path / f"FLEET.{name}.json")
        poller = mod.FleetPoller(lambda m=mod: _samples(m), out_path=out,
                                 slo=slo.SLOEngine())
        poller.tick()
        with open(out) as f:
            docs[name] = json.load(f)
        docs[name].pop("ts")
        docs[name]["exposition"] = poller.exposition()
        assert poller.fleet_doc()["n_replicas"] == 4
        poller.stop()
    assert docs["port"] == docs["jax"]
    assert 'replica="1",role="decode"' in docs["port"]["exposition"]
