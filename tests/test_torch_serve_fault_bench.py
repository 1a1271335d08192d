"""The port's serving fault harness (``python -m
paddle_tpu_torch.tools.serve_fault_bench``) and the byte count its phased
gang is gated on. The harness's CPU lane (``--smoke --device cpu``: the
reference's tiny model, SIGKILL mid-decode and a poisoned engine with real
engine replicas) is slow-marked, as ``tests/test_serving_resilience.py``
marks the JAX harness's; the mechanics it drives are tier-1 in
``test_torch_gang.py`` (stub replicas) and ``test_torch_gang_engine.py``
(one real-engine gang)."""
import json
import os
import signal
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from paddle_tpu import serving as JS
from paddle_tpu.models import gpt as JG
from paddle_tpu.serving import kv_transfer as JKT
from paddle_tpu.serving import metrics as JM
from paddle_tpu_torch import serving as TS
from paddle_tpu_torch.models import gpt as TG
from paddle_tpu_torch.serving import kv_transfer as TKT
from paddle_tpu_torch.serving import metrics as TM
from paddle_tpu_torch.tools import serve_fault_bench as SFB

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EKW = dict(max_batch=2, max_seq=32, prefill_buckets=(8, 16),
           kv_layout="paged", page_size=8)


def test_card_is_the_default_and_smoke_is_the_cpu_lane():
    """Without arguments the harness takes the card and raises without one;
    ``--smoke`` and ``--device cpu`` go together or not at all; ``--only``
    names known scenarios."""
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            SFB.main([])
    for argv in (["--smoke"], ["--device", "cpu"],
                 ["--smoke", "--device", "cuda"],
                 ["--smoke", "--device", "cpu", "--only", "nope"]):
        with pytest.raises(SystemExit) as e:
            SFB.main(argv)
        assert e.value.code == 2
    assert set(SFB.SMOKE) < set(SFB.SCENARIOS) == set(SFB.GANGS) | {
        "overload_storm"}


def test_socket_handoff_counts_its_bytes_once():
    """A handoff pushed over the KV socket and adopted counts its wire bytes
    once each way: ``out`` at the export, ``in`` at the adoption — the
    phased gang's gate (bytes out of the prefill replica == bytes into the
    decode replica). The JAX package counts ``in`` twice on this path (at
    the server's commit too); its in-process handoff, once, equals the
    port's socket count."""
    cfg_j = JG.GPT_TINY.scaled(num_layers=1, max_seq_len=64)
    cfg_t = TG.GPT_TINY.scaled(num_layers=1, max_seq_len=64)
    jp = JG.init_params(jax.random.PRNGKey(2), cfg_j)
    tp = TG.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                              device="cpu")
    prompt = [2, 7, 1, 8, 2, 8, 1, 8, 2, 8]
    deltas = {}
    for name, pkg, kt, m, mk, socket in (
            ("port_socket", TS, TKT, TM, lambda **k: TS.DecodeEngine(
                tp, cfg_t, TS.EngineConfig(**EKW, **k), device="cpu"), True),
            ("jax_socket", JS, JKT, JM, lambda **k: JS.DecodeEngine(
                jp, cfg_j, JS.EngineConfig(**EKW, **k)), True),
            ("jax_inline", JS, JKT, JM, lambda **k: JS.DecodeEngine(
                jp, cfg_j, JS.EngineConfig(**EKW, **k)), False)):
        src, dst = mk(role="prefill"), mk(role="decode")
        out0 = m.m_kv_transfer_bytes.labels("out").value
        in0 = m.m_kv_transfer_bytes.labels("in").value
        slot, _ = src.start_sequence(prompt)
        handoff = src.export_request_kv(slot, tokens=prompt)
        if socket:
            server = kt.KVTransferServer().start()
            try:
                kt.send_handoff(server.host, server.port, handoff)
                handoff = server.pop(handoff["transfer_id"], timeout_s=30)
            finally:
                server.close()
        dst.free_sequence(dst.adopt_request_kv(handoff))
        src.free_sequence(slot)
        deltas[name] = (m.m_kv_transfer_bytes.labels("out").value - out0,
                        m.m_kv_transfer_bytes.labels("in").value - in0)
    page_bytes = 2 * cfg_t.num_layers * 8 * cfg_t.d_model * 4
    assert deltas["port_socket"] == deltas["jax_inline"] == \
        (2 * page_bytes, 2 * page_bytes)
    assert deltas["jax_socket"] == (2 * page_bytes, 4 * page_bytes)


@pytest.mark.slow
def test_serve_fault_bench_smoke(tmp_path):
    """SIGKILL mid-decode with failover and a poisoned engine recycled,
    with real engine replicas on the CPU (~40 s alone)."""
    out = str(tmp_path / "serve_fault_bench.json")
    proc = subprocess.Popen(
        [sys.executable, "-m", "paddle_tpu_torch.tools.serve_fault_bench",
         "--smoke", "--device", "cpu", "--out", out], cwd=REPO,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        start_new_session=True)
    try:
        _, err = proc.communicate(timeout=600)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        _, err = proc.communicate()
    assert proc.returncode == 0, err[-4000:]
    with open(out) as f:
        data = json.load(f)
    assert data["pass"] is True and tuple(data["scenarios"]) == SFB.SMOKE
    sk = data["scenarios"]["replica_sigkill"]
    assert sk["lost_responses"] == 0 and not sk["non_200"] \
        and not sk["wrong_tokens"]
    assert sk["failovers"] >= 1 and sk["idempotent_retry_ok"]
    assert sk["retry_same_trace"] and sk["killed_trace_stitchable"]
    po = data["scenarios"]["engine_poisoned"]
    assert po["restarts"].get("poisoned", 0) >= 1 and po["ok"]
