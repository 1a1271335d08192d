"""The port's fault-injection harness on the CPU
(``python -m paddle_tpu_torch.tools.fault_bench --smoke --device cpu``):
GPT_TINY at dp 2 over gloo, every job supervised by the port's launcher.
Each scenario must recover unattended and, at equal dp, end on params
bit-exact with the uninterrupted baseline, as ``tests/test_elastic.py::
test_fault_bench_smoke`` holds the JAX harness; a second uninterrupted run
(``aa``) must equal the first bitwise, the divergence guard must roll
back once and recover, and the supervisor must flag the straggling rank
alone. The SIGKILL's GOODPUT.json charges the restart to
``restart_downtime``, the hang's bundle holds the flight ring, and the
SIGSTOPped rank of ``sigstop_blame`` is named by the blame pass with the
collective seq it missed, as ``tests/test_flight_blame.py`` holds the JAX
harness's. The harness runs once, in its own session, and is killed whole
if it outlives its timeout."""
import json
import os
import signal
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMOKE = ("baseline", "aa", "sigkill_midstep", "sigterm_preempt",
         "corrupt_shard", "dp_reshard", "hang", "sigstop_blame",
         "poison_batch", "divergence_rollback", "straggler")


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("fb") / "fault_bench.json")
    proc = subprocess.Popen(
        [sys.executable, "-m", "paddle_tpu_torch.tools.fault_bench",
         "--smoke", "--device", "cpu", "--out", out], cwd=REPO, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, start_new_session=True)
    try:
        # ~2 min on an idle host; a loaded one (the tier-1 run's other
        # workers) slows every worker's start several times over
        _, err = proc.communicate(timeout=900)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        _, err = proc.communicate()
    assert os.path.exists(out), err[-4000:]
    with open(out) as f:
        return proc.returncode, json.load(f), err


def test_fault_bench_smoke_passes(bench):
    rc, data, err = bench
    assert rc == 0 and data["pass"] is True, err[-4000:]
    assert data["mode"] == "smoke" and tuple(data["scenarios"]) == SMOKE


@pytest.mark.parametrize("name", SMOKE)
def test_fault_bench_scenario(bench, name):
    _, data, err = bench
    s = data["scenarios"][name]
    assert s["pass"] is True, (name, s, err[-3000:])
    if name in ("aa", "sigkill_midstep", "sigterm_preempt", "corrupt_shard",
                "hang"):
        assert s["match_baseline"] == "bit_exact" and s["params_match"]
    if name == "sigkill_midstep":
        assert [r["cause"] for r in s["restarts"]] == ["crash"]
        assert s["restored_from"] == [s["expected_restore"]]
        assert s["recovery"]["restart_downtime_s"] > 0
        # the supervisor's GOODPUT.json: the restart charged to
        # restart_downtime, as long as restart_history()'s window
        gp = s["goodput"]
        assert gp["restarts"] == 1 and gp["rank_reports"] >= 2
        assert gp["categories"]["restart_downtime"] > 0
        assert 0 < s["gang_goodput_fraction"] <= 1
        assert abs(s["goodput_downtime_s"] - s["history_downtime_s"]) <= 1
    if name == "sigterm_preempt":
        assert s["rc_preempted"] == 0 and s["preempted_clean_exit"]
        assert s["exits"] == ["preempt", "complete"]
    if name == "corrupt_shard":
        assert s["no_partial_selected"]
        assert s["restored_from"] == s["steps_before"][-2]
    if name == "dp_reshard":
        assert s["reshard"] == {"params": True, "moments": True}
    if name == "hang":
        assert [r["cause"] for r in s["restarts"]] == ["hang"]
        assert s["stack_dumps"] >= 1 and s["site"] == "train_step"
        assert s["flight_dumps"] >= 1
        assert s["deadline_s"] < s["last_progress_age_s"]
        assert s["detection_s"] > 0
    if name == "sigstop_blame":
        assert s["blamed_ranks"] == [1] and s["blame_mode"] == \
            "never_entered"
        assert s["missed_seq"] == s["expected_missed_seq"] == 3
        assert s["missed_name"] == "allreduce_grads"
        assert s["seq_gaps_total"] == 0 and s["paddle_blamed_rank"] == 1
    if name == "poison_batch":
        assert s["all_ranks_skipped_identically"]
        assert s["weights_bit_exact_vs_no_poison"]
    if name == "divergence_rollback":
        assert s["rollbacks"] == 1 and s["skipped"] == 2
        assert s["rollback_restored_from"] == s["expected_rollback_target"]
        assert s["recovered"]
    if name == "straggler":
        assert s["flagged_ranks"] == [1] and s["rank1_detections"] >= 1
        assert s["rank0_detections"] == 0


def test_card_is_the_default_and_smoke_is_the_cpu_lane():
    """Without arguments the harness takes the card and raises without one;
    ``--smoke`` and ``--device cpu`` go together or not at all."""
    import torch

    from paddle_tpu_torch.tools import fault_bench

    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            fault_bench.main([])
    for argv in (["--smoke"], ["--device", "cpu"],
                 ["--smoke", "--device", "cuda"]):
        with pytest.raises(SystemExit) as e:
            fault_bench.main(argv)
        assert e.value.code == 2
