"""The port's front-door overload control against the JAX front door, on
the CPU: the measured drain rate, queue ETA and Retry-After of the
scheduler, deadline-aware shedding, and the 429/503 answers with their
``Retry-After`` header and ``retry_after_s`` body field.

Both sides serve an engine that never admits (the queue only grows), so
the traffic is deterministic; the drain rate is made so by setting the
schedulers' done-times: 4 requests over the last 8 s.
"""
import json
import time
import types
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from paddle_tpu import serving as JS
from paddle_tpu.serving import metrics as JM
from paddle_tpu_torch import serving as TS
from paddle_tpu_torch.serving import metrics as TM

PROMPT = [1, 2, 3]
DONE_AGO = (8.0, 6.0, 4.0, 2.0)     # seconds before now: ~0.5 requests/s


class _Cache:
    occupancy = 0.0

    def free_slot_count(self):
        return 0


class _Engine:
    """What both schedulers touch when nothing is ever admitted."""

    ecfg = types.SimpleNamespace(eos_id=None, max_batch=4)
    cache = _Cache()
    poisoned = None
    role = "colocated"
    device = torch.device("cpu")

    def bucket_for(self, n):
        return 16

    def can_admit(self, n):
        return False


def _schedulers(max_queue):
    return (JS.Scheduler(_Engine(), JS.SchedulerConfig(max_queue=max_queue)),
            TS.Scheduler(_Engine(), TS.SchedulerConfig(max_queue=max_queue),
                         device="cpu"))


def _stamp(sched, now):
    with sched._rate_lock:
        sched._done_times.extend(now - d for d in DONE_AGO)


def _post(port, body):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/generate", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            code, raw, headers = r.status, r.read(), r.headers
    except urllib.error.HTTPError as e:
        code, raw, headers = e.code, e.read(), e.headers
    return (code, json.loads(raw), headers.get("Retry-After"),
            headers.get("Content-Type"))


def _shed_counts(metrics):
    return {r: metrics.m_shed.labels(r).value
            for r in ("queue_full", "deadline")}


def test_drain_rate_eta_and_retry_after_match_jax():
    """Same done-times, same queue: the same rate (up to the clock read
    between the two calls), ETA and Retry-After, and the same shed
    verdicts."""
    js, ts = _schedulers(16)
    for s, mod in ((js, JS), (ts, TS)):
        assert s.drain_rate() is None and s.queue_eta_s() == 0.0
        assert s.retry_after_s() == 1
        s.submit(PROMPT, timeout_s=600)
        assert s.queue_eta_s() is None          # no rate yet: no evidence
        assert mod.shed_decision(s, 0.001) is None
    now = time.monotonic()
    for s in (js, ts):
        _stamp(s, now)
        for _ in range(5):
            s.submit(PROMPT, timeout_s=600)
    np.testing.assert_allclose(ts.drain_rate(), js.drain_rate(), rtol=1e-3)
    np.testing.assert_allclose(ts.queue_eta_s(), js.queue_eta_s(),
                               rtol=1e-3)
    assert 11.0 < ts.queue_eta_s() < 13.0       # 6 queued at ~0.5/s
    for cap in (60.0, 3.0):
        assert ts.retry_after_s(cap) == js.retry_after_s(cap)
    assert ts.retry_after_s(3.0) == 3
    before = (_shed_counts(JM), _shed_counts(TM))
    verdicts = [(TS.shed_decision(ts, t), JS.shed_decision(js, t))
                for t in (1.0, 120.0)]
    assert verdicts == [(("deadline", 13),) * 2, (None, None)]
    assert (_shed_counts(JM)["deadline"] - before[0]["deadline"]
            == _shed_counts(TM)["deadline"] - before[1]["deadline"] == 1)


def _traffic(sched, door):
    """One request stream against one front door; returns the answers
    and the shed counters' increments."""
    metrics = TM if isinstance(door, TS.FrontDoor) else JM
    before = _shed_counts(metrics)
    out = []
    for _ in range(2):                      # fills the queue (2)
        sched.submit(PROMPT, timeout_s=600)
    # queue full, no measurable rate: 429, Retry-After 1
    out.append(_post(door.port, {"prompt": PROMPT, "timeout_s": 1.0}))
    _stamp(sched, time.monotonic())         # ETA of 2 queued: ~4 s
    # queue full with a rate: 429, Retry-After ceil(ETA)
    out.append(_post(door.port, {"prompt": PROMPT, "timeout_s": 600}))
    # the ETA exceeds a 1 s deadline: shed before the queue is tried
    out.append(_post(door.port, {"prompt": PROMPT, "timeout_s": 1.0,
                                 "max_new_tokens": 4}))
    # the scheduler refuses behind an open door: 503
    sched._draining = True
    out.append(_post(door.port, {"prompt": PROMPT, "timeout_s": 600}))
    # the door itself drains: 503 before the body is read
    door._draining = True
    out.append(_post(door.port, {"prompt": PROMPT}))
    after = _shed_counts(metrics)
    return out, {r: after[r] - before[r] for r in after}


def test_front_door_answers_match_jax():
    """Codes, bodies, Retry-After headers and shed counts of the port's
    front door equal the JAX front door's over the same traffic: queue
    full without and with a measured rate, a deadline the drain ETA
    exceeds, a refusing scheduler, a draining door."""
    js, ts = _schedulers(2)
    jdoor = JS.FrontDoor(scheduler=js, max_queue=2).start()
    tdoor = TS.FrontDoor(ts).start()
    try:
        want, want_shed = _traffic(js, jdoor)
        got, got_shed = _traffic(ts, tdoor)
    finally:
        jdoor.stop()
        tdoor.stop()
    assert got == want
    assert got_shed == want_shed == {"queue_full": 2, "deadline": 1}
    codes = [a[0] for a in got]
    assert codes == [429, 429, 429, 503, 503]
    retry = [a[2] for a in got]
    assert retry == ["1", "5", "5", "5", "5"]
    assert all(a[1]["retry_after_s"] == int(a[2]) for a in got)
    assert "shed (deadline)" in got[2][1]["error"]


def test_shedding_can_be_turned_off():
    """``shed_deadline_aware=False`` (both doors): the request whose
    deadline the ETA exceeds is queued and answers 504 at its deadline,
    not 429."""
    js, ts = _schedulers(4)
    jdoor = JS.FrontDoor(scheduler=js, max_queue=4,
                         shed_deadline_aware=False).start()
    tdoor = TS.FrontDoor(ts, shed_deadline_aware=False).start()
    try:
        answers = []
        for sched, door in ((js, jdoor), (ts, tdoor)):
            sched.submit(PROMPT, timeout_s=600)
            _stamp(sched, time.monotonic())
            answers.append(_post(door.port, {"prompt": PROMPT,
                                             "timeout_s": 0.2}))
    finally:
        jdoor.stop()
        tdoor.stop()
    assert answers[0] == answers[1]
    assert answers[1][0] == 504 and answers[1][2] is None


@pytest.mark.parametrize("cap", [60.0, 2.0])
def test_retry_after_cap(cap):
    """The door's ``retry_after_cap_s`` bounds every Retry-After."""
    _js, ts = _schedulers(1)
    door = TS.FrontDoor(ts, retry_after_cap_s=cap).start()
    try:
        ts.submit(PROMPT, timeout_s=600)
        _stamp(ts, time.monotonic())
        code, body, retry, _ctype = _post(door.port, {"prompt": PROMPT,
                                                      "timeout_s": 600})
    finally:
        door.stop()
    assert code == 429
    assert int(retry) == body["retry_after_s"] == min(3, int(cap))
