"""The port's launcher (``paddle_tpu_torch/parallel/launch.py``): the
PADDLE_* env each worker sees (the same as the JAX package's launcher
exports), the first failing exit code passed on, and a failing worker
stopping the gang within its grace period."""
import importlib
import json
import os
import subprocess
import sys
import textwrap
import time

import pytest

from paddle_tpu_torch.parallel import launch as L

# the module (``paddle_tpu.parallel`` exports a function of that name)
JL = importlib.import_module("paddle_tpu.parallel.launch")

ENV_KEYS = ("PADDLE_TRAINER_ID", "PADDLE_TRAINERS_NUM",
            "PADDLE_TRAINER_ENDPOINTS", "PADDLE_CURRENT_ENDPOINT")


def _script(tmp_path, body: str) -> str:
    path = tmp_path / "worker.py"
    path.write_text(textwrap.dedent(body))
    return str(path)


def test_workers_see_the_paddle_env(tmp_path):
    script = _script(tmp_path, """
        import json, os, sys
        out = sys.argv[1]
        keys = [k for k in os.environ if k.startswith("PADDLE_")
                or k == "LOCAL_RANK"]
        with open(os.path.join(out, os.environ["PADDLE_TRAINER_ID"]),
                  "w") as f:
            json.dump({k: os.environ[k] for k in keys}, f)
    """)
    for name, run in (("port", lambda out: L.launch(
            script, [out], nproc_per_node=3, started_port=7100,
            backend="gloo")),
            ("jax", lambda out: JL.launch(
                script, [out], nproc_per_node=3, started_port=7100,
                perf_flags=False))):
        out = tmp_path / name
        out.mkdir()
        assert run(str(out)) == 0
    eps = ",".join(f"127.0.0.1:{7100 + i}" for i in range(3))
    for r in range(3):
        port = json.loads((tmp_path / "port" / str(r)).read_text())
        ref = json.loads((tmp_path / "jax" / str(r)).read_text())
        assert {k: port[k] for k in ENV_KEYS} == {k: ref[k] for k in ENV_KEYS}
        assert port["PADDLE_TRAINER_ENDPOINTS"] == eps
        assert port["PADDLE_CURRENT_ENDPOINT"] == f"127.0.0.1:{7100 + r}"
        assert port["LOCAL_RANK"] == str(r)
        assert port["PADDLE_DIST_BACKEND"] == "gloo"


@pytest.mark.parametrize("how,code", [("exit", 7), ("kill", 128 + 9)])
def test_first_failing_exit_code_is_passed_on(tmp_path, how, code):
    """Rank 1 fails first (exit 7, or SIGKILL -> 137); rank 2 fails later
    with another code, which is not the one passed on."""
    script = _script(tmp_path, f"""
        import os, signal, sys, time
        rank = int(os.environ["PADDLE_TRAINER_ID"])
        if rank == 1:
            if "{how}" == "kill":
                os.kill(os.getpid(), signal.SIGKILL)
            sys.exit(7)
        if rank == 2:
            time.sleep(3)
            sys.exit(5)
    """)
    t0 = time.monotonic()
    assert L.launch(script, nproc_per_node=3, grace_period_s=5) == code
    assert time.monotonic() - t0 < 20


def test_failing_worker_stops_the_gang_within_grace(tmp_path):
    """Rank 0 exits 3 at once; rank 1 would sleep 300 s and rank 2 ignores
    SIGTERM: the gang is down (rank 2 by SIGKILL) within the 1 s grace
    period plus polling, and no worker outlives the launcher."""
    pids = tmp_path / "pids"
    pids.mkdir()
    script = _script(tmp_path, f"""
        import os, signal, sys, time
        rank = int(os.environ["PADDLE_TRAINER_ID"])
        open(os.path.join({str(pids)!r}, str(os.getpid())), "w").close()
        if rank == 0:
            time.sleep(1)
            sys.exit(3)
        if rank == 2:
            signal.signal(signal.SIGTERM, signal.SIG_IGN)
        time.sleep(300)
    """)
    t0 = time.monotonic()
    assert L.launch(script, nproc_per_node=3, grace_period_s=1.0) == 3
    assert time.monotonic() - t0 < 15
    for pid in os.listdir(pids):
        with pytest.raises(ProcessLookupError):
            os.kill(int(pid), 0)


def test_cli_module_mode_and_refusals(tmp_path):
    """``python -m paddle_tpu_torch.parallel.launch -m module`` runs the
    workers as modules and exits with their code (``--max_restarts`` on
    the CLI restarts the gang, which fails again); ``--goodput_dir`` gets
    the gang's GOODPUT.json with the restart's downtime charged to every
    rank, and ``--flight_dir`` is the flight dir the workers are told."""
    pkg = tmp_path / "wmod.py"
    pkg.write_text("import os, sys\n"
                   "assert os.environ['PADDLE_FLIGHT_DIR'] == sys.argv[1]\n"
                   "sys.exit(int(os.environ['PADDLE_TRAINERS_NUM']) + 40\n"
                   "         + int(os.environ['PADDLE_RESTART_ATTEMPT']))\n")
    gp, fl = tmp_path / "goodput", tmp_path / "flight"
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(tmp_path), os.getcwd()] + sys.path))
    res = subprocess.run(
        [sys.executable, "-m", "paddle_tpu_torch.parallel.launch",
         "--nproc_per_node", "2", "--grace_period", "1", "--max_restarts",
         "1", "--restart_backoff", "0.1", "--goodput_dir", str(gp),
         "--flight_dir", str(fl), "-m", "wmod", str(fl)],
        env=env, capture_output=True, timeout=120)
    assert res.returncode == 43, res.stderr.decode()
    assert "cause hang" in res.stderr.decode()
    with open(gp / "GOODPUT.json") as f:
        gang = json.load(f)
    assert gang["exit_code"] == 43 and gang["restarts"] == 1
    assert gang["nranks"] == 2 and gang["rank_reports"] == 0
    assert gang["restart_downtime_s"] > 0
    assert gang["categories"]["restart_downtime"] == pytest.approx(
        2 * gang["restart_downtime_s"], abs=1e-5)


@pytest.mark.parametrize("spec", [
    "dp=2", "dp=2,grad_reduce=reduce_scatter", "tp=2",
    "pp=2,microbatches=2"])
def test_train_bench_parallel_lane_rehearsal(tmp_path, spec):
    """``launch`` of ``train_bench``'s parallel lane on 2 gloo ranks on
    the CPU at the rehearsal widths (``--tiny``): each layout's 11p run
    (3 steps at lr 1e-2 against the world-1 run, ``parity_ok``) passes,
    and its timed steps give finite losses and count wire bytes. One gang
    a layout, so that each case's limit covers one layout under a loaded
    host."""
    import numpy as np

    from paddle_tpu_torch.tools import train_bench as TB
    from paddle_tpu_torch.tools.fault_bench import _reserve_port

    # a port below the ephemeral range, never one released by this
    # process that another could take before the gang's store binds it
    port = _reserve_port()
    cmd = [sys.executable, "-m", "paddle_tpu_torch.parallel.launch",
           "--nproc_per_node", "2", "--backend", "gloo", "--started_port",
           str(port), "--grace_period", "5", "-m",
           "paddle_tpu_torch.tools.train_bench", "--device", "cpu",
           "--tiny", "--fused-ln", "--ce-vchunk", "1024", "--batch", "2",
           "--steps", "1", "--warmup", "1", "--out-dir", str(tmp_path),
           "--parity", "--layout", spec]
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run(cmd, cwd=root, capture_output=True, text=True,
                          timeout=150)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    for r in range(2):
        rec = json.loads((tmp_path / f"layout0.rank{r}.json").read_text())
        assert TB.parity_ok(rec["parity"]), (spec, r, rec["parity"])
        assert np.isfinite(rec["losses"]).all()
        assert sum(rec["wire_bytes_per_step"].values()) > 0
