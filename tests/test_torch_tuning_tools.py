"""The tools that feed the autotuner (``tools/peak_probe.py``,
``mfu_sweep.py``, ``comm_bench.py``), the appliers of the serving and
training lanes, and the overlap measure of the gloo lane — on the CPU,
where they check mechanisms, not device numbers."""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from paddle_tpu_torch.parallel import comm_opt as C
from paddle_tpu_torch.tools import comm_bench, mfu_sweep, peak_probe
from paddle_tpu_torch.tuning import tuned as TT

REPO = Path(__file__).resolve().parents[1]
ROOT_TUNED = str(REPO / "TUNED.json")     # the JAX package's CPU tune


def test_peak_probe_tiny_shapes_on_the_cpu(capsys):
    assert peak_probe.main(["--device", "cpu", "--iters", "2", "--shapes",
                            "64,32,32;96,48,48"]) == 0
    doc = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert doc["device"] == "cpu"
    assert [(r["m"], r["n"], r["k"], r["dtype"]) for r in doc["results"]] \
        == [(64, 32, 32, "bfloat16"), (96, 48, 48, "bfloat16")]
    assert doc["best_tflops"] == max(r["tflops"] for r in doc["results"])


def test_mfu_sweep_one_config_in_its_subprocess():
    spec = "d=32,L=1,nh=2,ff=64,T=16,b=2,steps=2,flash=0,remat=dots"
    row = mfu_sweep.run_one(spec, device="cpu", timeout=300)
    assert row["spec"] == spec and "error" not in row, row
    assert row["tokens_per_s"] > 0 and row["ms_per_step"] > 0
    assert row["device"] == "cpu" and row["degraded"] is True
    assert row["mfu"] >= 0
    # the CLI prints the row and the ranked table
    proc = subprocess.run(
        [sys.executable, "-m", "paddle_tpu_torch.tools.mfu_sweep", "--one",
         spec + ",vchunk=1024,fused=1", "--device", "cpu"], cwd=str(REPO),
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    row = json.loads(proc.stdout.splitlines()[0])
    assert row["tokens_per_s"] > 0 and row["mfu"] >= 0


@pytest.mark.parametrize("key", ["bq", "bk", "scan"])
def test_mfu_sweep_unported_key_names_itself(key):
    spec = f"d=32,L=1,T=16,b=2,steps=1,{key}=256"
    with pytest.raises(NotImplementedError, match=repr(key)):
        mfu_sweep.parse_spec(spec)
    row = mfu_sweep.run_one(spec, device="cpu")
    assert row["error"].startswith("NotImplementedError") and key in \
        row["error"]
    with pytest.raises(ValueError, match="unknown spec key"):
        mfu_sweep.parse_spec("d=32,zz=1")


@pytest.mark.parametrize("argv", [
    ["--base", "d=64,L=2,b=8,steps=2,flash=0,dp=2", "--grad-reduce",
     "psum,reduce_scatter", "--comm-dtype", "f32,bf16"],
    ["--base", "d=64,L=2,b=8,steps=2", "--grad-reduce", "--bucket-mb",
     "8,32"],
    ["--base", "d=64,L=2,b=8,steps=2,dp=2", "--sharding", "none,fsdp"],
    ["--base", "d=64,L=2,b=4,steps=2,flash=0", "--ce-chunk", "0,64"],
    ["--one", "b=4,remat=dots"]])
def test_mfu_sweep_spec_grid_matches_reference(argv, monkeypatch):
    """The comm, sharding and memory-lever grids are the reference's
    (``tools/mfu_sweep.py`` ``build_specs``, loaded by path)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "ref_mfu_sweep", REPO / "tools" / "mfu_sweep.py")
    ref = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ref)
    monkeypatch.setattr(sys, "argv", ["mfu_sweep.py"] + argv)
    assert mfu_sweep.build_specs(argv) == ref.build_specs()
    for s in mfu_sweep.build_specs(argv):
        cmd = mfu_sweep.worker_cmd(s, "cpu")
        dp = int(mfu_sweep.parse_spec(s).get("dp", 1))
        assert ("--nproc_per_node" in cmd) == (dp > 1)


def test_comm_bench_two_gloo_ranks(tmp_path):
    """The comm-lever A/B on 2 gloo ranks at the rehearsal widths: the
    reduce-scatter path halves the gradient wire bytes and bf16 halves
    them again, f32 reduce-scatter is bit-identical to psum, and each
    config's overlap is the staged collectives' own (0 <= f <= 1)."""
    out = tmp_path / "COMM_BENCH.json"
    proc = subprocess.run(
        [sys.executable, "-m", "paddle_tpu_torch.tools.comm_bench",
         "--tiny", "--device", "cpu", "--dp", "2", "--batch", "4",
         "--steps", "3", "--out", str(out), "--timeout", "240"],
        cwd=str(REPO), capture_output=True, text=True, timeout=300,
        env=dict(os.environ, OMP_NUM_THREADS="1"))   # tiny ranks
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    doc = json.loads(out.read_text())
    s = doc["summary"]
    assert s["rs_f32_grad_bytes_reduction_x"] == 2.0
    assert s["rs_bf16_vs_rs_f32_grad_bytes_reduction_x"] == 2.0
    assert s["bit_identical_rs_f32"] is True
    assert [r["config"] for r in doc["configs"]] == [
        n for n, _ in comm_bench.CONFIGS]
    for row in doc["configs"]:
        assert row["overlap_source"] == "gloo_staged"
        assert 0.0 <= row["overlap_fraction"] <= 1.0
        assert len(row["losses"]) == 3
    assert doc["degraded"] is True and doc["mesh"]["dp"] == 2


# ---------------------------------------------------------------------------
# the gloo lane's overlap: a staged range's own time only
# ---------------------------------------------------------------------------

def _ev(name, cat, ts, dur, pid, tid, **args):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
            "pid": pid, "tid": tid, "args": args}


def _trace(tmp_path, with_other_thread: bool):
    """The trace ``mesh._staged`` gives of one staged all-reduce: two
    kernels launched before it (2-5, 5-8 us) end at the device
    synchronise (4-9 us), after which the host range opens (10-110 us);
    inside it the staging's own copies (13-18, 100-105); a kernel
    launched after it; optionally a kernel launched from another host
    thread during the range (90-95 us), which does overlap the
    collective."""
    ev = [
        _ev("cudaLaunchKernel", "cuda_runtime", 0, 1, 1, 1, correlation=1),
        _ev("cudaLaunchKernel", "cuda_runtime", 3, 1, 1, 1, correlation=2),
        _ev("cudaDeviceSynchronize", "cuda_runtime", 4, 5, 1, 1,
            correlation=7),
        _ev("paddle_collective/psum", "user_annotation", 10, 100, 1, 1),
        _ev("cudaMemcpyAsync", "cuda_runtime", 12, 1, 1, 1, correlation=3),
        _ev("cudaMemcpyAsync", "cuda_runtime", 99, 1, 1, 1, correlation=4),
        _ev("cudaLaunchKernel", "cuda_runtime", 120, 1, 1, 1,
            correlation=5),
        _ev("gemm_a", "kernel", 2, 3, 0, 7, device=0, stream=7,
            correlation=1),
        _ev("gemm_b", "kernel", 5, 3, 0, 7, device=0, stream=7,
            correlation=2),
        _ev("Memcpy DtoH", "gpu_memcpy", 13, 5, 0, 7, device=0, stream=7,
            correlation=3),
        _ev("Memcpy HtoD", "gpu_memcpy", 100, 5, 0, 7, device=0, stream=7,
            correlation=4),
        _ev("gemm_c", "kernel", 121, 19, 0, 7, device=0, stream=7,
            correlation=5),
    ]
    if with_other_thread:
        ev += [_ev("cudaLaunchKernel", "cuda_runtime", 50, 1, 1, 2,
                   correlation=6),
               _ev("other", "kernel", 90, 5, 0, 8, device=0, stream=8,
                   correlation=6)]
    d = tmp_path / ("other" if with_other_thread else "alone")
    d.mkdir()
    (d / "t.pt.trace.json").write_text(json.dumps({"traceEvents": ev}))
    return str(d)


def test_staged_range_counts_its_own_time_only(tmp_path):
    """The kernels queued before a staged range ended at its synchronise
    and do not overlap it, and the staging's own copies inside it are the
    collective's, not compute: the overlap is 0 over the range's 100 us.
    A kernel another thread launched during the range does overlap: 5 of
    100 us."""
    got = C.measure_overlap_fraction(_trace(tmp_path, False))
    assert got["source"] == "gloo_staged"
    assert got["overlap_fraction"] == 0.0
    assert got["collective_ms"] == pytest.approx(0.100)
    assert got["exposed_ms"] == pytest.approx(0.100)
    # the kernels launched outside the range are compute
    assert got["compute_ms"] == pytest.approx((3 + 3 + 19) / 1e3)
    got = C.measure_overlap_fraction(_trace(tmp_path, True))
    assert got["overlap_fraction"] == pytest.approx(5 / 100)
    assert got["collective_ms"] == pytest.approx(0.100)


def test_staged_range_opens_after_its_synchronise(monkeypatch):
    """``mesh._staged`` synchronises the device before it opens the
    ``paddle_collective/<op>`` range, so the range holds the collective's
    own time: the order of the calls on a tensor that reports itself on
    the card, with the synchronise and the range recorded."""
    import contextlib

    import torch

    from paddle_tpu_torch.parallel import mesh

    order = []

    class OnCard(torch.Tensor):
        @property
        def is_cuda(self):
            return True

    @contextlib.contextmanager
    def rng(name):
        order.append(("open", name))
        yield
        order.append(("close", name))

    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda dev=None: order.append(("sync",)))
    monkeypatch.setattr(torch.profiler, "record_function", rng)

    class Line:
        stage, size = True, 2

    @mesh._staged("psum")
    def psum(self, t):
        order.append(("call",))
        return t

    t = torch.zeros(2).as_subclass(OnCard)
    assert psum(Line(), t) is t
    assert order == [("sync",), ("open", "paddle_collective/psum"),
                     ("call",), ("close", "paddle_collective/psum")]


# ---------------------------------------------------------------------------
# the lanes' --tuned
# ---------------------------------------------------------------------------

def test_serve_bench_tuned_applies_the_serve_winner(capsys, tmp_path):
    """``serve_bench --tuned``: the CPU-tuned root document applies its
    ``max_batch`` and buckets where the flags were not given and is
    stamped into the JSON; a foreign document is REFUSED."""
    from paddle_tpu_torch.tools import serve_bench

    rc = serve_bench.main(["--disagg", "--tiny", "--device", "cpu",
                           "--disagg-requests", "4", "--disagg-max-new",
                           "4", "--tuned", ROOT_TUNED])
    lines = capsys.readouterr().out.strip().splitlines()
    assert rc == 0
    assert f"[serve_bench] tuned config applied from {ROOT_TUNED}" in lines
    out = json.loads(lines[-1])
    doc = TT.load(ROOT_TUNED)
    cfg = doc["spaces"]["serve"]["config"]
    assert out["engine"]["max_batch"] == cfg["max_batch"]
    assert out["engine"]["prefill_buckets"] == cfg["buckets"]
    assert out["tuned"]["tuned_from"]["path"] == ROOT_TUNED
    foreign = tmp_path / "foreign.json"
    foreign.write_text(json.dumps(dict(doc, hw=dict(doc["hw"],
                                                    n_devices=4))))
    with pytest.warns(RuntimeWarning, match="fingerprint mismatch"):
        rc = serve_bench.main(["--disagg", "--tiny", "--device", "cpu",
                               "--disagg-requests", "2",
                               "--disagg-max-new", "2", "--max-batch", "3",
                               "--tuned", str(foreign)])
    lines = capsys.readouterr().out.strip().splitlines()
    assert rc == 0 and any("REFUSED" in x for x in lines)
    out = json.loads(lines[-1])
    assert out["engine"]["max_batch"] == 3 and "tuned" not in out


def test_train_bench_tuned_config_keeps_explicit_flags():
    from paddle_tpu_torch.tools import train_bench as TB

    doc = TT.load(ROOT_TUNED)
    ap = TB._parser()
    cfg = TB.bench_config("full", False, 0)
    got = TB.tuned_config(cfg, doc, ap.parse_args([]))
    assert got.remat_policy == "dots" and got.fused_ln is False
    explicit = TB.tuned_config(TB.bench_config("full", False, 512), doc,
                               ap.parse_args(["--remat", "full",
                                              "--ce-vchunk", "512"]))
    assert explicit.remat_policy == "full"
    assert explicit.ce_vocab_chunk == 512
    with pytest.raises(SystemExit):
        TB.main(["--model", "ernie", "--tuned", ROOT_TUNED])
    env = dict(os.environ, PADDLE_TRAINERS_NUM="2")
    proc = subprocess.run(
        [sys.executable, "-m", "paddle_tpu_torch.tools.train_bench",
         "--tuned", ROOT_TUNED], cwd=str(REPO), env=env,
        capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and "one-card GPT lane" in proc.stderr
