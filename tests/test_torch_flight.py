"""The port's flight recorder and blame engine against the JAX package's,
on the CPU. The port's recorder writes a two-rank gang's sidecars (rank 1
stops before the third exchange); the reference's
``tools/flight_assemble.py`` and the port's
``paddle_tpu_torch.tools.flight_assemble`` give the same verdict over
them. The port's assembler gives the reference's verdict over the
reference's own synthetic rank files (``tests/test_flight_blame.py``'s
``_write_rank``: the dead rank, death inside the exchange, the clean
gang, a sequence gap, the stall taxonomy, a divergent fingerprint, the
attempt selection). The ring, the dumps and their counter, the per-call
fingerprint stamps of ``comm_opt.record_collective``, the blame gauges
and ``goodput_report --by-rank`` are checked beside. Tolerances: none.
"""
import importlib.util
import json
import os

import pytest

from paddle_tpu.observability import flight as JF
from paddle_tpu_torch.observability import default_registry
from paddle_tpu_torch.observability import flight as TF
from paddle_tpu_torch.parallel import comm_opt
from paddle_tpu_torch.tools import flight_assemble as FA
from paddle_tpu_torch.tools import goodput_report as GR

import test_flight_blame as REF          # the reference's synthetic files

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MS = REF.MS


def _ref_assembler():
    spec = importlib.util.spec_from_file_location(
        "ref_flight_assemble", os.path.join(REPO, "tools",
                                            "flight_assemble.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


RFA = _ref_assembler()


@pytest.fixture(autouse=True)
def _fresh():
    for mod in (TF, JF):
        mod.reset(detach=True)
        mod.set_flight_enabled(True)
    yield
    for mod in (TF, JF):
        mod.reset(detach=True)
        mod.set_flight_enabled(True)


def _gauge(name):
    series = default_registry().snapshot().get(name, {}).get("series", [])
    return series[0]["value"] if series else None


def _port_gang(d, monkeypatch, stop_rank=1, stop_before=3, steps=4):
    """Two ranks' sidecars from the port's recorder: each step a
    step_begin, one stamped collective call and one allreduce_grads
    exchange; ``stop_rank`` goes quiet before exchange ``stop_before``."""
    monkeypatch.setenv(TF.ENV_DIR, str(d))
    for rank in (0, 1):
        TF.reset(detach=True)
        monkeypatch.setenv("PADDLE_TRAINER_ID", str(rank))
        monkeypatch.setenv("PADDLE_RESTART_ATTEMPT", "0")
        path = TF.attach_sink(str(d))
        assert os.path.basename(path).startswith(f"flight-rank{rank}-")
        os.rename(path, os.path.join(str(d),
                                     f"flight-rank{rank}-{100 + rank}.jsonl"))
        TF.default_recorder().set_sink(os.path.join(
            str(d), f"flight-rank{rank}-{100 + rank}.jsonl"))
        for step in range(1, steps + 1):
            TF.event("step_begin", step=step)
            comm_opt.record_collective("psum", "float32", 64, 2)
            if rank == stop_rank and step == stop_before:
                break
            with TF.collective("allreduce_grads", nbytes=16):
                pass
            TF.event("step_end", step=step)
        TF.default_recorder().set_sink(None)


def test_both_assemblers_agree_on_the_ports_files(tmp_path, monkeypatch):
    _port_gang(tmp_path, monkeypatch)
    got = FA.assemble_dir(str(tmp_path))
    want = RFA.assemble_dir(str(tmp_path))
    assert got == want
    v = got["verdict"]
    assert v["blamed_ranks"] == [1] and v["blame_mode"] == "never_entered"
    assert v["missed_seq"] == 3 and v["missed_name"] == "allreduce_grads"
    assert v["seq_gaps_total"] == 0 and v["divergent_ranks"] == []
    assert v["per_rank"]["0"]["entered"] == 4


def test_per_call_stamps_fingerprint(tmp_path, monkeypatch):
    """``record_collective`` stamps every call with ranks > 1 (none at one
    rank, where it moves no bytes); differing calls are a divergence."""
    _port_gang(tmp_path, monkeypatch, stop_rank=None)
    ev = [json.loads(ln) for ln in open(
        tmp_path / "flight-rank0-100.jsonl")]
    lowered = [e for e in ev if e["ev"] == "coll_lowered"]
    assert [e["lseq"] for e in lowered] == [1, 2, 3, 4]
    assert lowered[0]["op"] == "psum" and lowered[0]["ranks"] == 2
    n = len(TF.default_recorder().events())
    assert comm_opt.record_collective("psum", "float32", 64, 1) == 0
    assert len(TF.default_recorder().events()) == n    # no new stamp
    for rank, op in ((0, "all_gather"), (1, "psum")):
        with open(tmp_path / f"flight-rank{rank}-{100 + rank}.jsonl",
                  "a") as f:
            f.write(json.dumps({"ev": "coll_lowered", "t_ns": 10 ** 12,
                                "lseq": 5, "op": op, "dtype": "float32",
                                "bytes": 8, "ranks": 2, "site": op}) + "\n")
    v = FA.assemble_dir(str(tmp_path))["verdict"]
    assert v == RFA.assemble_dir(str(tmp_path))["verdict"]
    assert v["divergent_ranks"] == [1]        # measured against rank 0's


SYNTHETIC = {
    "dead_rank": REF.test_blame_dead_rank_never_entered,
    "stuck_inside": REF.test_blame_stuck_inside_the_exchange,
    "clean_gang": REF.test_blame_clean_gang_blames_nobody,
    "seq_gap": REF.test_seq_gap_detection,
    "stall_taxonomy": REF.test_stall_taxonomy_feeds_goodput_categories,
    "divergence": REF.test_lowered_stream_divergence,
    "attempts": REF.test_assemble_selects_attempt,
}


@pytest.mark.parametrize("case", sorted(SYNTHETIC))
def test_port_assembler_on_the_reference_files(tmp_path, monkeypatch,
                                               case):
    """The reference's own case writes its files and checks its verdict
    with the port's assembler in place of the reference's; the two
    reports are then equal whole."""
    monkeypatch.setattr(REF, "fa", FA)
    SYNTHETIC[case](tmp_path)
    got = FA.assemble_dir(str(tmp_path))
    want = RFA.assemble_dir(str(tmp_path))
    assert got == want and got["files"]


def test_rank_goodput_and_by_rank_report(tmp_path, monkeypatch):
    evs = [{"ev": "step_begin", "t_ns": 0, "step": 1},
           {"ev": "data_wait", "t_ns": MS, "dur_ns": 500 * MS},
           {"ev": "coll_enter", "t_ns": 600 * MS, "seq": 1, "name": "a"},
           {"ev": "coll_exit", "t_ns": 800 * MS, "seq": 1},
           {"ev": "ckpt_write", "t_ns": 900 * MS, "dur_ns": 250 * MS},
           {"ev": "step_end", "t_ns": 2000 * MS, "step": 1}]
    assert FA.rank_goodput(evs) == RFA.rank_goodput(evs)
    REF._write_rank(tmp_path, 0, evs)
    out = str(tmp_path / "by_rank.json")
    assert GR.main(["--by-rank", "--flight-dir", str(tmp_path),
                    "--out", out]) == 0
    with open(out) as f:
        rows = json.load(f)["by_rank"]
    assert rows["0"]["input_stall"] == pytest.approx(0.5)
    assert rows["0"]["device_wait"] == pytest.approx(0.2)


def test_ring_dump_and_blame_gauges(tmp_path, monkeypatch):
    monkeypatch.setenv("PADDLE_TRAINER_ID", "3")
    for mod in (TF, JF):
        rec = mod.FlightRecorder(ring=4)
        for i in range(6):
            rec.event("dispatch", i=i)
        assert [e["i"] for e in rec.events()] == [2, 3, 4, 5]
        assert rec.summary() == {"dispatch": 4}
    TF.event("step_begin", step=1)
    seq = TF.collective_enter("allreduce_grads", 8)
    assert seq == 1 and TF.collective_enter("x") == 2
    before = default_registry().snapshot().get(
        "paddle_flight_dump_total", {}).get("series", [])
    path = TF.dump("hang", dir_path=str(tmp_path))
    assert os.path.basename(path).startswith("flight.dump.hang.rank3.")
    with open(path) as f:
        doc = json.load(f)
    assert doc["ev"] == "meta" and doc["rank"] == 3 and doc["cause"] == "hang"
    assert [e["ev"] for e in doc["events"]] == ["step_begin", "coll_enter",
                                                "coll_enter"]
    after = default_registry().snapshot()["paddle_flight_dump_total"]
    n0 = sum(s["value"] for s in before if s["labels"][0] == "hang")
    assert sum(s["value"] for s in after["series"]
               if s["labels"][0] == "hang") == n0 + 1
    assert TF.dump("hang") is None or os.environ.get(TF.ENV_DIR)
    TF.note_blame(1, skew_ms=12.5)
    assert _gauge("paddle_blamed_rank") == 1
    assert _gauge("paddle_step_skew_ms") == 12.5
    TF.note_blame(None)
    assert _gauge("paddle_blamed_rank") == -1
    TF.set_flight_enabled(False)
    assert TF.collective_enter("y") == 0
    assert TF.stamp_collective("psum", "float32", 4, 2) == 0


def test_launch_blame_pass_writes_the_report(tmp_path):
    """The supervisor's blame pass (``launch._assemble_blame``) over the
    reference's dead-rank files: the report beside them, the gauges set."""
    from paddle_tpu_torch.parallel import launch as L

    r0 = REF._steps_through(2) + [
        {"ev": "coll_enter", "t_ns": 21 * MS, "seq": 3,
         "name": "allreduce_grads", "bytes": 1024}]
    REF._write_rank(tmp_path, 0, r0)
    REF._write_rank(tmp_path, 1, REF._steps_through(2))
    v = L._assemble_blame(str(tmp_path), attempt=0)
    assert v["blamed_ranks"] == [1] and v["missed_seq"] == 3
    with open(tmp_path / "blame.attempt0.json") as f:
        assert json.load(f)["verdict"] == v
    assert _gauge("paddle_blamed_rank") == 1
    assert FA.main([str(tmp_path), "--require-blame"]) == 0
    assert FA.main([str(tmp_path / "empty")]) == 2
