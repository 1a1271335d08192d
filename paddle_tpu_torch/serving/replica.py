"""Serving replica worker: one engine incarnation under the gang supervisor —
the port of ``paddle_tpu/serving/replica.py``.

Run as a SCRIPT (``python paddle_tpu_torch/serving/replica.py --config X``)
by :class:`~paddle_tpu_torch.serving.gang.ReplicaGang`, one subprocess a
replica slot. The worker:

- builds the model and a :class:`DecodeEngine` from the JSON config on the
  config's ``"device"`` (default ``"cuda"``, which raises without a card;
  ``"cpu"`` serves on the CPU — there is no fallback between them), with
  the weights of ``init_params(cfg, seed)``, so every replica on one kind
  of device serves the same weights and a failed-over greedy request
  returns the tokens its first replica would have;
- restores the persistent prefix store (``prefix_store_dir``) BEFORE
  warmup, so a recycled replica serves a shared system prompt
  prefill-once from its first request; a store written for another cache
  config is detached and the replica serves cold;
- serves through :class:`FrontDoor` on an ephemeral port, reported back in
  ``ready.json`` (port, pid, KV socket port, restored records, the
  start-up stamps), with a :class:`KVTransferServer` when ``kv_server``
  is set (decode replicas of a phased gang);
- arms the hang watchdog from the ``PADDLE_HEALTH_*`` env the gang exports
  (the engine loop stamps ``serve/tick``; a wedged loop exits
  ``health.HANG_EXIT_CODE`` = 43) after warmup, and writes a heartbeat
  file the supervisor probes — with the process's kernel launches and
  decode ticks since warmup, so a caller can count the launches of a
  replica it cannot see into;
- exits with :data:`POISONED_EXIT_CODE` = 44 when its engine is poisoned
  (the gang recycles with ``cause=poisoned``) rather than answer 500
  forever;
- drains on SIGTERM and exits 0.

``"inject"`` drives the fault harness (``tools/serve_fault_bench.py``):
``hang_after`` / ``poison_after`` / ``die_after`` N finished requests
wedge the loop, poison the engine or exit, and ``step_delay_s`` slows
every scheduler step (a kill then lands mid-decode for sure).

``"env"`` in the config is set in the process's environment before
anything else is imported: on a host with several cards the gang's
``per_replica`` pins each replica to its own with ``CUDA_VISIBLE_DEVICES``.

``{"stub": {...}}`` configs run a stdlib-only protocol stub (no ``torch``
import: it starts in well under a second) with the same HTTP surface
(``/generate``, ``/prefill``, ``/resume``, ``/health``, ``/metrics``) and
deterministic fake tokens; the gang's tests use it to drive failover and
recycling without paying an engine's start-up per test.

The top-level imports are stdlib-only on purpose: the gang imports this
module for the exit-code contract, and the stub must not drag ``torch``
in.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import threading
import time

#: Exit code of a replica whose engine is poisoned (a call failed on the
#: card after writing its caches in place: serving/engine.py). Distinct
#: from health.HANG_EXIT_CODE (43): the gang maps 44 to
#: ``paddle_serve_replica_restarts_total{cause="poisoned"}``.
POISONED_EXIT_CODE = 44

READY_NAME = "ready.json"
HEARTBEAT_NAME = "heartbeat.json"


class ReplicaRole:
    """Phase role of a replica in a phased gang: plain strings, as the gang
    writes them into each replica's JSON config."""

    PREFILL = "prefill"      # serves /prefill, ships KV handoffs out
    DECODE = "decode"        # serves /resume, adopts KV handoffs
    COLOCATED = "colocated"  # serves /generate end to end (default)
    ALL = (PREFILL, DECODE, COLOCATED)


def _atomic_json(path: str, obj: dict) -> None:
    tmp = f"{path}.tmp.{os.getpid()}"
    try:
        with open(tmp, "w") as f:
            json.dump(obj, f)
        os.replace(tmp, path)
    except OSError:
        pass  # liveness files are advisory, never fatal


def _heartbeat_loop(run_dir: str, status_fn, stop: threading.Event,
                    interval_s: float = 0.5, extra_fn=None) -> None:
    path = os.path.join(run_dir, HEARTBEAT_NAME)
    # the first beat lands at once: staleness needs a baseline even when
    # the worker wedges right after coming up
    _atomic_json(path, {"ts": time.time(), "pid": os.getpid(),
                        "status": "starting"})
    while not stop.wait(interval_s):
        rec = {"pid": os.getpid()}
        try:
            rec["status"] = status_fn()
            if extra_fn is not None:
                rec.update(extra_fn())
        except Exception as e:
            rec["status"] = f"error: {e}"
        rec["ts"] = time.time()
        _atomic_json(path, rec)


# ---------------------------------------------------------------------------
# Stub worker: the protocol without an engine (the gang's tests)
# ---------------------------------------------------------------------------

def _stub_tokens(prompt, n):
    return [(sum(prompt) * 31 + i * 7) % 97 for i in range(n)]


_stub_span_lock = threading.Lock()
_stub_span_n = [0]


def _stub_span_append(path: str, name: str, start_ns: int, dur_ns: int,
                      trace: int, parent, attrs: dict) -> None:
    """Append ONE span record (the JSONL of observability/spans.py, which
    tools/trace_assemble.py stitches) with a write and flush a record, so a
    SIGKILLed stub's finished spans survive. Stdlib-only: the stub must not
    import the observability package."""
    with _stub_span_lock:
        _stub_span_n[0] += 1
        span_id = ((os.getpid() & 0xFFFF) << 40) | _stub_span_n[0]
        rec = {"name": name, "trace": int(trace), "span": span_id,
               "parent": None if parent is None else int(parent),
               "start_ns": int(start_ns), "dur_ns": int(dur_ns),
               "tid": threading.get_ident(),
               "thread": threading.current_thread().name,
               "attrs": attrs}
        try:
            with open(path, "a") as f:
                f.write(json.dumps(rec) + "\n")
                f.flush()
        except OSError:
            pass


def run_stub(cfg: dict) -> int:
    import signal
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    stub = cfg.get("stub") or {}
    run_dir = cfg["run_dir"]
    os.makedirs(run_dir, exist_ok=True)
    role = cfg.get("role", ReplicaRole.COLOCATED)
    state = {"served": 0, "hung": False}
    hb_frozen = threading.Event()
    span_path = None
    if cfg.get("trace_dir"):
        # the per-process sink name of spans.process_sink_path
        os.makedirs(cfg["trace_dir"], exist_ok=True)
        span_path = os.path.join(
            cfg["trace_dir"], f"spans-{role}-{os.getpid()}.jsonl")

    def status():
        if stub.get("poison_after") and \
                state["served"] >= stub["poison_after"]:
            return "poisoned"
        return "ok"

    class H(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):
            pass

        def _json(self, code, obj):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            try:
                self.wfile.write(body)
            except (BrokenPipeError, ConnectionResetError):
                pass

        def do_GET(self):
            if self.path == "/health":
                return self._json(200, {
                    "status": status(), "loop_alive": not state["hung"],
                    "stub": True, "served": state["served"],
                    "role": role})
            if self.path == "/metrics":
                text = (f"paddle_serve_prefill_tokens_total "
                        f"{state['served']}\n").encode()
                self.send_response(200)
                self.send_header("Content-Type",
                                 "text/plain; version=0.0.4")
                self.send_header("Content-Length", str(len(text)))
                self.end_headers()
                self.wfile.write(text)
                return
            self._json(404, {"error": "unknown path"})

        def do_POST(self):
            if self.path not in ("/generate", "/prefill", "/resume"):
                return self._json(404, {"error": "unknown path"})
            n = int(self.headers.get("Content-Length", 0))
            body = json.loads(self.rfile.read(n).decode() or "{}")
            # join the router's trace: one span a handled request, flushed
            # at record, so a killed stub's finished spans survive
            wire = body.get("trace")
            t0 = time.perf_counter_ns()
            try:
                self._post_inner(body)
            finally:
                if span_path and isinstance(wire, dict) \
                        and "trace_id" in wire:
                    _stub_span_append(
                        span_path, "stub" + self.path, t0,
                        time.perf_counter_ns() - t0,
                        trace=wire["trace_id"],
                        parent=wire.get("parent_span"),
                        attrs={"pid": os.getpid(), "role": role})

        def _post_inner(self, body):
            if self.path == "/resume" and stub.get("die_on_resume"):
                # the decode replica dies with the migrated request in
                # its hands
                os._exit(int(stub.get("die_code", 1)))
            if stub.get("hang_after") is not None and \
                    state["served"] >= stub["hang_after"]:
                state["hung"] = True
                hb_frozen.set()           # the heartbeat goes stale too
                time.sleep(600)
            if stub.get("die_after") is not None and \
                    state["served"] >= stub["die_after"]:
                os._exit(int(stub.get("die_code", 1)))
            delay = float(body.get("stub_delay_s",
                                   stub.get("delay_s", 0.0)))
            if delay:
                time.sleep(delay)
            if status() == "poisoned":
                return self._json(503, {"error": "engine poisoned (stub)"})
            if self.path == "/prefill":
                prompt = body.get("prompt") or []
                if not prompt:
                    return self._json(400, {"error": "empty prompt"})
                state["served"] += 1
                # an inline fake handoff: its checksum lets /resume check
                # that it crossed router -> decode whole
                return self._json(200, {
                    "first_token": _stub_tokens(prompt, 1)[0],
                    "ttft_ms": delay * 1e3,
                    "transfer_id": body.get("transfer_id") or "stub",
                    "kv": {"stub": True, "checksum": sum(prompt),
                           "prompt_len": len(prompt),
                           "tokens": list(prompt)},
                    "pid": os.getpid()})
            if self.path == "/resume":
                kv = body.get("kv") or {}
                prompt = kv.get("tokens") or body.get("prompt") or []
                if not prompt or kv.get("checksum") != sum(prompt):
                    return self._json(400, {
                        "error": "stub handoff checksum mismatch"})
                toks = _stub_tokens(prompt,
                                    int(body.get("max_new_tokens", 4)))
                if int(body.get("first_token", toks[0])) != toks[0]:
                    return self._json(400, {
                        "error": "stub first-token mismatch"})
                state["served"] += 1
                return self._json(200, {
                    "tokens": toks, "num_tokens": len(toks),
                    "tpot_ms": 0.0, "pid": os.getpid()})
            prompt = body.get("prompt") or []
            toks = _stub_tokens(prompt,
                                int(body.get("max_new_tokens", 4)))
            state["served"] += 1
            self._json(200, {"tokens": toks, "num_tokens": len(toks),
                             "ttft_ms": delay * 1e3, "tpot_ms": 0.0,
                             "pid": os.getpid()})

    httpd = ThreadingHTTPServer(("127.0.0.1", 0), H)
    httpd.daemon_threads = True
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    stop_hb = threading.Event()

    def hb_status():
        if hb_frozen.is_set():
            time.sleep(600)               # frozen: the supervisor sees stale
        return status()

    threading.Thread(target=_heartbeat_loop,
                     args=(run_dir, hb_status, stop_hb, 0.2),
                     daemon=True).start()
    _atomic_json(os.path.join(run_dir, READY_NAME),
                 {"port": httpd.server_address[1], "pid": os.getpid(),
                  "stub": True, "role": role,
                  "restored_prefix_records": 0,
                  "env": {k: os.environ.get(k)
                          for k in (cfg.get("env") or {})}})
    done = threading.Event()
    signal.signal(signal.SIGTERM, lambda *_: done.set())
    done.wait()
    httpd.shutdown()
    return 0


# ---------------------------------------------------------------------------
# Real worker: DecodeEngine + FrontDoor + the prefix store's warm restart
# ---------------------------------------------------------------------------

def run_engine(cfg: dict) -> int:
    stamps = {"t_main": time.time()}
    import torch

    from paddle_tpu_torch import serving
    from paddle_tpu_torch.device import resolve_device
    from paddle_tpu_torch.models import gpt
    from paddle_tpu_torch.ops import cuda_kernels as CK
    from paddle_tpu_torch.parallel import health

    stamps["t_import"] = time.time()
    run_dir = cfg["run_dir"]
    os.makedirs(run_dir, exist_ok=True)
    role = cfg.get("role", ReplicaRole.COLOCATED)
    if cfg.get("trace_dir"):
        # every span of this replica appends to spans-<role>-<pid>.jsonl
        # under the gang's trace dir, flushed a record (a SIGKILL loses at
        # most the open span); tools/trace_assemble stitches the fleet's
        from paddle_tpu_torch.observability import spans as ospans

        ospans.attach_process_sink(cfg["trace_dir"], role)
    device = resolve_device(cfg.get("device", "cuda"))
    m = cfg["model"]
    mcfg = gpt.GPTConfig(
        vocab_size=int(m["vocab_size"]),
        max_seq_len=int(m.get("max_seq_len", 64)),
        num_layers=int(m["num_layers"]), num_heads=int(m["num_heads"]),
        d_model=int(m["d_model"]), d_ff=int(m["d_ff"]),
        dtype=getattr(torch, m.get("dtype", "bfloat16")), remat=False)
    params = gpt.init_params(mcfg, seed=int(m.get("seed", 0)),
                             device=device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    stamps["t_weights"] = time.time()
    ekw = dict(cfg.get("engine") or {})
    if "prefill_buckets" in ekw:
        ekw["prefill_buckets"] = tuple(int(b)
                                       for b in ekw["prefill_buckets"])
    engine = serving.DecodeEngine(params, mcfg, serving.EngineConfig(**ekw),
                                  device=device)
    del params
    engine.drop_reference_params()      # only the serving weights stay
    stamps["t_engine"] = time.time()
    restored = 0
    store = None
    if cfg.get("prefix_store_dir"):
        from paddle_tpu_torch.serving.prefix_store import PrefixStore

        store = PrefixStore(cfg["prefix_store_dir"])
        try:
            restored = engine.attach_prefix_store(store)
        except serving.CacheConfigMismatch as e:
            # a mismatched store must not crash-loop the replica under the
            # supervisor: serve cold, and detach the store so this
            # incarnation neither trusts nor overwrites records shaped for
            # another config
            sys.stderr.write(f"[replica] prefix store rejected — "
                             f"serving cold: {e}\n")
            sys.stderr.flush()
            engine.prefix_store = None
            store.close()
            store = None
    stamps["t_restore"] = time.time()
    engine.warmup()
    stamps["t_warmup"] = time.time()
    # the launches and ticks the heartbeat reports are the serving ones
    CK.reset_launches()
    ticks0 = engine.decode_ticks
    kv_server = None
    if cfg.get("kv_server"):
        kv_server = serving.KVTransferServer().start()
    skw = dict(cfg.get("scheduler") or {})
    sched = serving.Scheduler(engine, serving.SchedulerConfig(**skw),
                              device=device)

    inject = cfg.get("inject") or {}
    if inject:
        orig_step = sched.step

        def step():
            done = sched.completed
            if inject.get("hang_after") is not None \
                    and done >= inject["hang_after"]:
                # wedge the loop: the progress stamps stop, and the
                # watchdog (armed from the gang's env) exits 43
                sys.stderr.write("[replica] injected hang\n")
                sys.stderr.flush()
                time.sleep(3600)
            if inject.get("poison_after") is not None and \
                    done >= inject["poison_after"] and \
                    engine.poisoned is None:
                # a stand-in for a call failing on the card after writing
                # its caches in place
                engine.poisoned = "injected poison (serve_fault_bench)"
            if inject.get("die_after") is not None \
                    and done >= inject["die_after"]:
                os._exit(int(inject.get("die_code", 1)))
            if inject.get("step_delay_s"):
                # a slow engine: requests stay in flight long enough for a
                # kill to land mid-decode
                time.sleep(float(inject["step_delay_s"]))
            return orig_step()

        sched.step = step

    def on_poison(reason):
        sys.stderr.write(f"[replica] engine poisoned ({reason}) — "
                         f"exiting {POISONED_EXIT_CODE} for the gang\n")
        sys.stderr.flush()
        os._exit(POISONED_EXIT_CODE)

    front = serving.FrontDoor(
        scheduler=sched, port=int(cfg.get("port", 0)),
        request_timeout_s=float(cfg.get("request_timeout_s", 30.0)),
        on_poison=on_poison, kv_server=kv_server).start()
    # the gang's env arms the hang watchdog after warmup
    health.maybe_install_from_env()
    front.install_signal_handlers(
        drain_timeout_s=float(cfg.get("drain_timeout_s", 30.0)))

    def beat():
        return {"launches": dict(CK.LAUNCHES),
                "decode_ticks": engine.decode_ticks - ticks0,
                "completed": sched.completed,
                "prefix_publish_ms": list(store.publish_ms[-64:])
                if store is not None else []}

    stop_hb = threading.Event()
    threading.Thread(
        target=_heartbeat_loop,
        args=(run_dir, lambda: front.health()["status"], stop_hb, 0.5,
              beat), daemon=True).start()
    stamps["t_ready"] = time.time()
    _atomic_json(os.path.join(run_dir, READY_NAME), {
        "port": front.port, "pid": os.getpid(), "role": engine.role,
        "kv_port": kv_server.port if kv_server is not None else None,
        "restored_prefix_records": int(restored),
        "device": (torch.cuda.get_device_name(device)
                   if device.type == "cuda" else "cpu"),
        "startup": stamps,
        "env": {k: os.environ.get(k) for k in (cfg.get("env") or {})}})
    sys.stderr.write(f"[replica] ready on port {front.port} role="
                     f"{engine.role} (restored {restored} prefix records)\n")
    sys.stderr.flush()
    try:
        while front._thread is not None and front._thread.is_alive():
            time.sleep(0.2)
    finally:
        stop_hb.set()
        if kv_server is not None:
            kv_server.close()
        if store is not None:
            store.close()
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", required=True,
                    help="path to the replica's JSON config")
    args = ap.parse_args(argv)
    with open(args.config) as f:
        cfg = json.load(f)
    # before any import that reads them (CUDA_VISIBLE_DEVICES)
    os.environ.update({k: str(v) for k, v in (cfg.get("env") or {}).items()})
    if cfg.get("stub") is not None:
        return run_stub(cfg)
    return run_engine(cfg)


if __name__ == "__main__":
    if __package__ in (None, ""):
        # run as a file by the gang: the repository root, not this
        # directory, goes first on the path
        sys.path[0] = os.path.abspath(os.path.join(
            os.path.dirname(os.path.abspath(__file__)), "..", ".."))
    sys.exit(main())
