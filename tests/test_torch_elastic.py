"""The port's elastic layer (``paddle_tpu_torch/parallel/checkpoint.py``,
the restart and preemption half of ``launch.py``) beside the JAX
package's: twins of ``tests/test_elastic.py`` (commit markers, corrupt
shards named, retention, the async snapshot of an in-place step, the
launcher's codes, restarts and SIGTERM forwarding, the collective-init
retry), ``reshard_flat`` bitwise against JAX's on the same layouts, a
dp-2 reduce-scatter save restored at dp 1 bitwise on the moment leaves,
and checkpoints crossing the packages both ways — JAX's
``ElasticCheckpointer`` writing ``PZ.init_sharded`` state that the port
restores into gloo ranks, the port's gang save that JAX restores, every
leaf bitwise by crc32 — after which the port takes one step and matches
the JAX per-rank loss oracle of ``tests/test_torch_parallel.py``
(rtol 2e-4, the reference's).

Every spawned gang and launcher job here has its own timeout, so a hang
fails one test."""
import importlib
import json
import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.models import gpt as JG
from paddle_tpu.parallel import checkpoint as JC
from paddle_tpu.parallel import comm_opt as JCO
from paddle_tpu.parallel import parallelize as JPZ

from paddle_tpu_torch.parallel import checkpoint as C
from paddle_tpu_torch.parallel import comm_opt as CO
from paddle_tpu_torch.parallel import launch as L

import torch_dist_worker as W
from test_torch_parallel import CFG_KW, T, jax_oracle

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _small_state(seed=0):
    rng = np.random.default_rng(seed)
    return {"params": {"w": torch.from_numpy(
                rng.standard_normal((8, 4)).astype(np.float32)),
                       "b": torch.from_numpy(
                rng.standard_normal((4,)).astype(np.float32))},
            "opt": {"step": torch.tensor(3, dtype=torch.int32),
                    "m": torch.from_numpy(rng.standard_normal(6).astype(
                        np.float32)).to(torch.bfloat16)}}


def _tree_equal(a, b):
    fa, fb = C.flatten_with_keys(a), C.flatten_with_keys(b)
    assert [k for k, _ in fa] == [k for k, _ in fb]
    for (_, x), (_, y) in zip(fa, fb):
        assert x.dtype == y.dtype and torch.equal(x, y)


# ---------------------------------------------------------------------------
# Store semantics: commit markers, corruption, retention
# ---------------------------------------------------------------------------

def test_midsave_kill_never_selected(tmp_path):
    ck = C.ElasticCheckpointer(tmp_path / "ckpt", use_async=False)
    ck.save(1, _small_state())
    partial = tmp_path / "ckpt" / "step_00000005" / "leaves"
    partial.mkdir(parents=True)
    (partial / "leaf_0.bin").write_bytes(b"\x00" * 64)
    assert ck.all_steps() == [1]
    assert ck.latest_step() == 1
    assert ck.latest_valid_step() == 1
    state, man = ck.restore()
    assert man["step"] == 1 and man["format"] == "paddle_tpu.elastic.v1"
    _tree_equal(state, _small_state())
    removed = ck.gc()
    assert any("step_00000005" in p for p in removed)
    assert not (tmp_path / "ckpt" / "step_00000005").exists()


def test_corrupt_shard_detected_with_clear_message(tmp_path):
    ck = C.ElasticCheckpointer(tmp_path / "ckpt", use_async=False)
    ck.save(1, _small_state(0))
    ck.save(2, _small_state(1))
    shard = tmp_path / "ckpt" / "step_00000002" / "leaves" / "leaf_0.bin"
    shard.write_bytes(shard.read_bytes()[:2])
    problems = ck.verify(2)
    assert problems and "truncated" in problems[0]
    with pytest.raises(C.CheckpointCorruptError) as ei:
        ck.restore(2)
    assert "leaf_0.bin" in str(ei.value) and "step 2" in str(ei.value)
    shard2 = tmp_path / "ckpt" / "step_00000001" / "leaves" / "leaf_1.bin"
    data = bytearray(shard2.read_bytes())
    data[0] ^= 0xFF
    shard2.write_bytes(bytes(data))
    assert any("checksum mismatch" in p for p in ck.verify(1))
    ck.save(3, _small_state(2))
    assert ck.latest_valid_step() == 3
    # the same messages as the JAX store gives on the same files
    assert JC.ElasticCheckpointer(tmp_path / "ckpt").verify(2) == \
        ck.verify(2)


def test_keep_last_retention_and_async_snapshot(tmp_path):
    """A save followed at once by an in-place update of the saved tensors
    writes the pre-update bytes: the snapshot happens inside ``save``."""
    ck = C.ElasticCheckpointer(tmp_path / "ckpt", use_async=True,
                               keep_last=2)
    state = _small_state()
    w = state["params"]["w"]
    for step in range(1, 5):
        ck.save(step, state)
        w.add_(1.0)                         # the next step, in place
        state["opt"]["m"].mul_(2.0)
    ck.wait()
    assert ck.all_steps() == [3, 4]
    raw, _ = ck.restore(4)
    expect = _small_state()
    for _ in range(3):
        expect["params"]["w"] += 1.0
        expect["opt"]["m"].mul_(2.0)
    assert torch.equal(raw["params"]["w"], expect["params"]["w"])
    assert torch.equal(raw["opt"]["m"], expect["opt"]["m"])
    assert [h["step"] for h in ck.history] == [1, 2, 3, 4]
    assert all(h["bytes"] > 0 and h["write_ms"] >= 0 for h in ck.history)
    ck.close()


def test_keys_dtypes_and_metrics_match_the_jax_store(tmp_path):
    """One state saved by both stores: the same keys in the same order,
    the same dtype names (bfloat16 included), bytes and crc32s; both save
    metric families count."""
    from paddle_tpu_torch.observability import default_registry

    state = _small_state(4)
    state["extra"] = [torch.arange(3, dtype=torch.int32),
                      {"z": torch.ones(2)}]
    jstate = jax.tree_util.tree_map(
        lambda t: jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
        if t.dtype == torch.bfloat16 else jnp.asarray(t.numpy()),
        {"params": state["params"], "opt": state["opt"],
         "extra": [state["extra"][0], state["extra"][1]]})

    def counts():
        snap = default_registry().snapshot()
        b = snap["paddle_checkpoint_bytes_total"]["series"]
        h = snap["paddle_checkpoint_save_ms"]["series"]
        return (b[0]["value"] if b else 0, h[0]["count"] if h else 0)

    b0 = counts()
    C.ElasticCheckpointer(tmp_path / "port", use_async=False).save(7, state)
    b1 = counts()
    JC.ElasticCheckpointer(tmp_path / "jax", use_async=False).save(7, jstate)
    pm = C.ElasticCheckpointer(tmp_path / "port").manifest(7)
    jm = JC.ElasticCheckpointer(tmp_path / "jax").manifest(7)
    strip = ("time",)
    for a, b in zip(pm["leaves"], jm["leaves"]):
        assert a == b
    assert {k: v for k, v in pm.items() if k not in strip + ("leaves",)} \
        == {k: v for k, v in jm.items() if k not in strip + ("leaves",)}
    assert b1[0] - b0[0] == pm["total_bytes"] and b1[1] == b0[1] + 1


# ---------------------------------------------------------------------------
# Reshard-on-restore
# ---------------------------------------------------------------------------

SHAPES = [((24,), np.float32), ((8,), np.float32), ((40,), np.float32),
          ((3, 5), np.float32)]


@pytest.mark.parametrize("src,dst,cap_s,cap_d,repl_s,repl_d", [
    (8, 4, 1 << 7, 1 << 20, 2, 1), (4, 8, 1 << 20, 1 << 7, 1, 2),
    (2, 1, 1 << 8, 1 << 8, 1, 1), (1, 3, 1 << 20, 64, 1, 1),
    (3, 3, 64, 1 << 20, 2, 2)])
def test_reshard_flat_bitwise_against_jax(src, dst, cap_s, cap_d, repl_s,
                                          repl_d):
    """The same layouts built by both packages serialize alike, and the
    port's ``reshard_flat`` equals JAX's bit for bit (bf16 and float32
    buffers, as tensors and as numpy)."""
    jl_s = JCO.build_bucket_layout(SHAPES, ranks=src, cap_bytes=cap_s)
    jl_d = JCO.build_bucket_layout(SHAPES, ranks=dst, cap_bytes=cap_d)
    pl_s = CO.build_bucket_layout(SHAPES, ranks=src, cap_bytes=cap_s)
    pl_d = CO.build_bucket_layout(SHAPES, ranks=dst, cap_bytes=cap_d)
    assert C.serialize_layout(pl_s, repl_s) == \
        JC.serialize_layout(jl_s, repl_s)
    assert C.deserialize_layout(JC.serialize_layout(jl_d, repl_d)) == \
        (pl_d, repl_d)
    rng = np.random.default_rng(src * 10 + dst)
    vec = rng.standard_normal(src * repl_s * pl_s.shard_len).astype(
        np.float32)
    want = JC.reshard_flat(vec, jl_s, jl_d, src_repl=repl_s,
                           dst_repl=repl_d)
    got = C.reshard_flat(vec, pl_s, pl_d, src_repl=repl_s, dst_repl=repl_d)
    assert isinstance(got, np.ndarray) and got.tobytes() == want.tobytes()
    bf = torch.from_numpy(vec).to(torch.bfloat16)
    want_bf = JC.reshard_flat(
        np.asarray(jnp.asarray(vec).astype(jnp.bfloat16)), jl_s, jl_d,
        src_repl=repl_s, dst_repl=repl_d)
    got_bf = C.reshard_flat(bf, pl_s, pl_d, src_repl=repl_s,
                            dst_repl=repl_d)
    assert got_bf.view(torch.int16).numpy().tobytes() == \
        np.asarray(want_bf).view(np.int16).tobytes()
    other = CO.build_bucket_layout(SHAPES[:2], ranks=dst, cap_bytes=cap_d)
    with pytest.raises(C.CheckpointError):
        C.reshard_flat(vec, pl_s, other, src_repl=repl_s)


def test_reshard_refused_where_the_format_cannot_hold_it(tmp_path):
    """At pp·tp > 1 the copies of a dp shard differ, so a flat-moment
    restore across layouts there raises the named error; meshes with other
    axis sets raise MeshMismatchError, as the reference does."""
    lay2 = CO.build_bucket_layout(SHAPES, ranks=2, cap_bytes=1 << 20)
    lay1 = CO.build_bucket_layout(SHAPES, ranks=1, cap_bytes=1 << 20)
    n = 2 * 2 * lay2.shard_len
    ck = C.ElasticCheckpointer(tmp_path / "ckpt", use_async=False)
    ck.save(1, {"opt": {"m": torch.zeros(n)}}, layout=lay2, layout_repl=2,
            mesh={"dp": 2, "pp": 1, "tp": 2})
    with pytest.raises(C.LayoutReshardError, match="pp·tp"):
        C.restore_train_state(ck, {}, {"m": torch.zeros(lay1.total_len)},
                              layout=lay1, layout_repl=1,
                              mesh={"dp": 1, "pp": 1, "tp": 2})
    with pytest.raises(C.MeshMismatchError, match="axis sets differ"):
        C.restore_train_state(ck, {}, {"m": torch.zeros(n)}, layout=lay2,
                              layout_repl=2, mesh={"dp": 2, "cp": 2})
    with pytest.raises(C.MeshMismatchError):
        ck.restore(1, mesh={"dp": 4, "pp": 1, "tp": 1})


def _tokens(b, seed=3):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, CFG_KW["vocab_size"], (1, b, T)),
            rng.integers(0, CFG_KW["vocab_size"], (1, b, T)))


def test_dp2_reduce_scatter_save_restores_at_dp1_bitwise(tmp_path):
    """Two gloo ranks take a step and save (bf16 flat moments, each rank
    its dp shard); one rank restores at dp 1 through ``reshard_flat``:
    the moments carried back into the saved layout are the saved bytes,
    the params equal, the step counter kept."""
    tokens, labels = _tokens(4)
    ckpt = str(tmp_path / "ckpt")
    W.spawn(W.elastic_reshard_worker, 2, CFG_KW, 2, ckpt, tokens, labels,
            True, out_dir=str(tmp_path / "w2"), timeout=150)
    saved, man = C.ElasticCheckpointer(ckpt).restore(1)
    assert man["layout"]["ranks"] == 2 and man["mesh"]["dp"] == 2
    res = W.spawn(W.elastic_reshard_worker, 1, CFG_KW, 1, ckpt, tokens,
                  labels, False, out_dir=str(tmp_path / "w1"),
                  timeout=150)[0]
    for k in ("m", "v"):
        assert saved["opt"][k].dtype == torch.bfloat16
        assert res["back"][k].tobytes() == \
            saved["opt"][k].view(torch.int16).numpy().tobytes()
    assert res["step"] == int(saved["opt"]["step"]) == 1
    for (_, want), got in zip(C.flatten_with_keys(saved["params"]),
                              res["params"]):
        assert want.numpy().tobytes() == got.tobytes()


# ---------------------------------------------------------------------------
# Checkpoints across the packages
# ---------------------------------------------------------------------------

def test_checkpoints_cross_the_packages_bitwise(tmp_path):
    """JAX's ``ElasticCheckpointer`` saves ``PZ.init_sharded`` state at dp
    2 (bf16 flat moments, seeded values, step 3); two gloo ranks of the
    port restore it into their reduce-scatter state and save it again
    (rank 0 writes): every leaf's crc32, bytes, shape and dtype equal
    JAX's, and JAX's store restores the port's save to the original bits.
    Then the port's step from the restored state gives the loss of the
    JAX per-rank oracle on the same params (rtol 2e-4)."""
    cfg = JG.GPT_TINY.scaled(**CFG_KW)
    pcfg = JPZ.ParallelConfig(dp=2)
    mesh = JPZ.build_mesh(pcfg)
    params, opt = JPZ.init_sharded(jax.random.PRNGKey(0), cfg, pcfg, mesh,
                                   grad_reduce="reduce_scatter",
                                   moment_dtype=jnp.bfloat16)
    layout, repl = JPZ.rs_param_layout(cfg, pcfg)
    rng = np.random.default_rng(11)
    n = opt["m"].shape[0]
    opt = {"m": jnp.asarray(rng.standard_normal(n) * 1e-3, jnp.bfloat16),
           "v": jnp.asarray(rng.random(n) * 1e-6, jnp.bfloat16),
           "step": jnp.asarray(3, jnp.int32)}
    jdir, pdir = str(tmp_path / "jax"), str(tmp_path / "port")
    jck = JC.ElasticCheckpointer(jdir, use_async=False)
    jck.save(3, {"params": params, "opt": opt},
             mesh={"dp": 2, "pp": 1, "tp": 1}, layout=layout,
             layout_repl=repl)
    tokens, labels = _tokens(4, seed=5)
    ranks = W.spawn(W.elastic_cross_worker, 2, CFG_KW, 2, jdir, pdir,
                    tokens, labels, torch.bfloat16,
                    out_dir=str(tmp_path / "w"), timeout=150)
    for r in ranks:
        assert r["layout"] == r["manifest_layout"]       # the same layout
        assert r["step"] == 4
    jm = jck.manifest(3)
    pm = JC.ElasticCheckpointer(pdir).manifest(3)
    assert [(l["key"], l["shape"], l["dtype"], l["bytes"], l["crc32"])
            for l in pm["leaves"]] == \
        [(l["key"], l["shape"], l["dtype"], l["bytes"], l["crc32"])
         for l in jm["leaves"]]
    assert pm["mesh"] == jm["mesh"] and pm["layout"] == jm["layout"]
    back, _ = JC.ElasticCheckpointer(pdir).restore(
        3, like={"params": params, "opt": opt})
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves({"params": params,
                                               "opt": opt})):
        assert np.asarray(a).tobytes() == np.asarray(b).tobytes()
    loss, _ = jax_oracle(cfg, pcfg, params, tokens.astype(np.int32),
                         labels.astype(np.int32))
    for r in ranks:
        np.testing.assert_allclose(r["loss"], float(loss), rtol=2e-4)


# ---------------------------------------------------------------------------
# Supervised launcher
# ---------------------------------------------------------------------------

def _script(tmp_path, body):
    path = tmp_path / "worker.py"
    path.write_text(body)
    return str(path)


def _restarts():
    from paddle_tpu_torch.observability import default_registry

    snap = default_registry().snapshot()
    return {s["labels"][0]: s["value"] for s in
            snap.get("paddle_restarts_total", {}).get("series", [])}


def test_launch_propagates_first_failing_exit_code(tmp_path):
    assert L.launch(_script(tmp_path, "import sys; sys.exit(7)\n")) == 7


def test_launch_maps_signal_death_to_128_plus_n(tmp_path):
    rc = L.launch(_script(
        tmp_path, "import os, signal; os.kill(os.getpid(), "
                  "signal.SIGKILL)\n"))
    assert rc == 128 + signal.SIGKILL


def test_launch_supervised_restart_with_backoff(tmp_path):
    """The first incarnation fails, the second succeeds: rc 0, the backoff
    slept, one crash restart counted and recorded with its times."""
    marker = tmp_path / "ran_once"
    script = _script(tmp_path, f"""
import os, sys
m = {str(marker)!r}
if not os.path.exists(m):
    open(m, "w").write(os.environ["PADDLE_RESTART_ATTEMPT"])
    sys.exit(3)
sys.exit(0 if os.environ["PADDLE_RESTART_ATTEMPT"] == "1" else 9)
""")
    before, n0 = _restarts(), len(L.restart_history())
    t0 = time.time()
    assert L.launch(script, max_restarts=2, restart_backoff_s=0.2,
                    grace_period_s=2.0) == 0
    assert time.time() - t0 >= 0.2
    assert _restarts().get("crash", 0) == before.get("crash", 0) + 1
    hist = L.restart_history()[n0:]
    assert len(hist) == 1 and hist[0]["cause"] == "crash"
    assert hist[0]["returncode"] == 3 and hist[0]["attempt"] == 1
    assert hist[0]["t_respawn"] - hist[0]["t_fail"] >= 0.2
    assert marker.read_text() == "0"


def test_launch_restarts_exhausted_propagates(tmp_path):
    script = _script(tmp_path, "import sys; sys.exit(5)\n")
    assert L.launch(script, max_restarts=1, restart_backoff_s=0.1,
                    grace_period_s=1.0) == 5


def test_launcher_sigterm_forwards_and_exits_clean(tmp_path):
    """SIGTERM on ``python -m paddle_tpu_torch.parallel.launch`` reaches
    both workers, which checkpoint (here: a marker) and exit 0 in the
    grace period; the launcher exits 0, a clean preemption."""
    ready, marks = tmp_path / "ready", tmp_path / "marks"
    ready.mkdir()
    marks.mkdir()
    worker = _script(tmp_path, f"""
import os, signal, sys, time
r = os.environ["PADDLE_TRAINER_ID"]
def h(sig, frame):
    open(os.path.join({str(marks)!r}, r), "w").write("ok")
    sys.exit(0)
signal.signal(signal.SIGTERM, h)
open(os.path.join({str(ready)!r}, r), "w").write("up")
time.sleep(60)
""")
    proc = subprocess.Popen(
        [sys.executable, "-m", "paddle_tpu_torch.parallel.launch",
         "--nproc_per_node", "2", "--grace_period", "15", worker],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, start_new_session=True)
    try:
        deadline = time.time() + 60
        while len(os.listdir(ready)) < 2:
            assert proc.poll() is None, proc.communicate()[0]
            assert time.time() < deadline, "workers never came up"
            time.sleep(0.1)
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=60)
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
    assert proc.returncode == 0, out
    assert sorted(os.listdir(marks)) == ["0", "1"], out


def test_launch_refuses_what_waits_for_observability(tmp_path, monkeypatch):
    """What still waits refuses by its queue (A5: the restore-broadcast
    program); what this test once found refused, the launcher's goodput
    report and flight recorder (A4), now works: two workers export their
    goodput windows and attach their flight sidecars through the env
    contract, and the supervisor writes GOODPUT.json over both ranks."""
    with pytest.raises(NotImplementedError, match="A5"):
        C.build_restore_broadcast_program([])
    script = tmp_path / "obs_worker.py"
    script.write_text(
        "from paddle_tpu_torch.observability import flight, goodput\n"
        "led = goodput.ledger()\n"
        "led.start_window()\n"
        "assert flight.maybe_attach_from_env()\n"
        "with led.timer('productive_step'):\n"
        "    flight.event('step_begin', step=1)\n"
        "    flight.event('step_end', step=1)\n"
        "assert goodput.maybe_export(led.end_window())\n")
    gp, fl = tmp_path / "goodput", tmp_path / "flight"
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    monkeypatch.setenv("PYTHONPATH", os.pathsep.join(
        [repo] + [p for p in os.environ.get("PYTHONPATH", "").split(
            os.pathsep) if p]))
    rc = L.launch(str(script), nproc_per_node=2, goodput_dir=str(gp),
                  flight_dir=str(fl), grace_period_s=5.0)
    assert rc == 0
    with open(gp / "GOODPUT.json") as f:
        gang = json.load(f)
    assert gang["nranks"] == 2 and gang["rank_reports"] == 2
    assert gang["restarts"] == 0 and gang["exit_code"] == 0
    assert 0 < gang["gang_goodput_fraction"] <= 1
    assert (gp / "gang_metrics.prom").exists()
    sidecars = sorted(p.name for p in fl.glob("flight-rank*.jsonl"))
    assert [n.split("-")[1] for n in sidecars] == ["rank0", "rank1"]
    for name in sidecars:
        with open(fl / name) as f:
            recs = [json.loads(ln) for ln in f]
        assert recs[0]["ev"] == "meta" and recs[0]["attempt"] == 0
        assert [r["ev"] for r in recs[1:]] == ["step_begin", "step_end"]


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_init_collective_with_retry(pkg):
    retry = (L.init_collective_with_retry if pkg == "port" else
             importlib.import_module(
                 "paddle_tpu.parallel.launch").init_collective_with_retry)
    calls = {"n": 0}

    def flaky():
        calls["n"] += 1
        if calls["n"] < 3:
            raise ConnectionRefusedError("peer not up yet")

    retry(flaky, retries=5, backoff_s=0.01)
    assert calls["n"] == 3
    with pytest.raises(ConnectionRefusedError):
        retry(lambda: (_ for _ in ()).throw(ConnectionRefusedError()),
              retries=2, backoff_s=0.01)
