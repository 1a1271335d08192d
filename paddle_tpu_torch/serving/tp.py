"""Tensor-parallel serving ranks — the port of the reference's tp engine,
``EngineConfig(sharding="tp", tp=N)`` (``paddle_tpu/serving/engine.py``
``_init_tp`` :252-285, ``_shardings_for`` :610-621).

The reference is one controller over an N-chip GSPMD mesh. The port runs
one process a rank:

- **The driver** is rank 0, the process that builds the
  :class:`~.engine.DecodeEngine`. Everything that calls an engine
  (``Scheduler``, ``EngineLoop`` / ``FrontDoor``, ``SpecDecodeEngine``,
  ``DisaggRouter``, a gang replica) keeps calling that one object. Host
  state lives here alone: slot lengths, the page allocator, the prefix
  cache, sampling, the tokens window.
- **Followers**, ranks 1 .. N-1, are processes the engine spawns itself
  (``multiprocessing``'s ``spawn`` start method). Each holds its weight
  shard and its KV shard and runs the driver's forward on them.
- **Rendezvous**: the driver serves a TCP store on a free local port;
  every rank joins a private group through ``parallel/env.
  init_private_group`` — gloo where ranks share a card or run on the CPU,
  NCCL where each rank has a card of its own — and builds a ``("tp", N)``
  mesh with ``parallel/mesh.build_mesh``. The group is private, not the
  process's default one, because one process may hold several tp engines.
  ``timeout_s`` bounds the rendezvous, every collective and every wait
  for a follower's answer: a missing peer raises instead of hanging.
- **One command a call**: each engine entry point sends every follower one
  message over its pipe — prefill, decode tick, verify window, a canonical
  cache read or write, warmup, stats, close — carrying the tokens,
  positions, lanes or page tables and the slot as numpy arrays; the
  follower runs the same engine method and answers with one ack (a cache
  read's carries the rank's head slice). Never a message a layer: on the
  host a call costs one pickled message and one ack a follower over a
  local pipe (tens of microseconds each), beside the forward's 2L
  all-reduces. ``free_sequence`` changes host state only and sends
  nothing.
- **The cut** comes from ``sharding/plan.py``: ``gpt_annotations("tp")``
  completed over the tree by ``complete_pytree_specs``, as the
  reference's ``_init_tp`` derives it (the derivation notes are
  ``engine.tp_derived``), held leaf by leaf to ``models/gpt.param_specs``
  — QKV and fc column-parallel over heads and ffn, proj and out
  row-parallel, everything else replicated — by ``parallelize``'s rules:
  a spec that shards a dim Megatron's split does not is refused naming
  the leaf (suffix inheritance does that where shapes collide: ``wpe``
  ``[max_seq_len, D]`` takes ``w_out``'s ``(tp, None)`` when
  ``max_seq_len == d_ff``), and a leaf the plan keeps whole where Megatron
  splits it is cut to Megatron's block. Each rank cuts its own block with
  ``mesh.local_shard``. A follower receives the tree on the host, in the
  storage dtype and without the final layernorm and LM head it never
  runs, and puts only its block on its device.
- **Collectives**: two all-reduces a layer through ``AxisGroup.
  all_reduce`` — on the attention projection's partial sum before
  ``b_proj`` is added, and on the MLP output's before ``b_out`` — so each
  bias is added once and ``(h + o) + b`` keeps the reference's order;
  each is counted into ``paddle_collective_bytes_total{op="psum"}``
  (``comm_opt.record_collective``). The sum runs in the compute dtype: in
  bf16 each rank's partial product is rounded to bf16 and the partials
  are summed in bf16, one rounding more than the one-card matmul. The
  bf16 tests (``tests/test_torch_tp_serving.py``, ``chip_smoke.py``
  phase 4t) hold a tp engine's logits to at most twice the bf16 one-card
  engine's distance from the float32 engine's, and its prefill's greedy
  tokens to the bf16 one-card engine's. Over
  gloo each all-reduce is staged through host memory
  (``paddle_collective_staged_seconds_total{op="all_reduce"}``).
- **Logits and sampling**: the driver alone runs the final layernorm, the
  LM head and sampling, on the all-reduced hidden state; followers stop
  after the last block. Greedy tokens are bit-exact given the logits; a
  sampled lane draws from the driver's generator.
- **Faults**: a follower that raises answers with the error and exits, so
  its peers' collectives fail at once; the driver's call raises, the
  engine is poisoned (every later entry point refuses) and the followers
  are stopped. A follower exits by itself when the driver dies: EOF on its
  pipe, or its watch thread seeing its parent process change (a SIGKILLed
  gang replica leaves no follower holding the card).
"""
from __future__ import annotations

import multiprocessing
import os
import sys
import threading
import time
import traceback
import weakref
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from ..device import resolve_device
from ..models import gpt as gpt_mod
from ..parallel import env as penv
from ..parallel import mesh as mesh_mod
from ..sharding.plan import _flatten, _unflatten

__all__ = ["TpRanks", "rank_devices", "check_tp", "shard_specs",
           "local_tree", "HEAD_LEAVES", "DEFAULT_TIMEOUT_S"]

DEFAULT_TIMEOUT_S = 120.0
# the leaves only the driver runs (final layernorm and LM head)
HEAD_LEAVES = ("ln_f_scale", "ln_f_bias", "lm_head")
_WATCH_S = 0.25      # how often a follower checks that its driver lives
# the weight tree crosses the pipe in messages of this size: one message
# of the whole tree makes the receiver allocate a buffer of the whole
# message for every read of a socket's worth of it
_CHUNK = 1 << 20


def check_tp(cfg, ecfg, device, tp_devices) -> List[torch.device]:
    """The reference's refusals (``engine.py:262-275``), in its order and
    words, then each rank's device: ``tp_devices`` (one a rank; a card
    named twice is shared over gloo), else every rank on the CPU for
    ``device="cpu"``, else ``cuda:0 .. cuda:N-1``."""
    tp = int(ecfg.tp)
    if tp < 2:
        raise ValueError("sharding='tp' needs tp >= 2")
    if ecfg.weight_dtype == "int8":
        raise ValueError(
            "sharding='tp' cannot head-shard int8's flat chunk layout — "
            "use weight_dtype 'f32' or 'bf16'")
    devs = rank_devices(device, tp_devices, tp)
    if cfg.num_heads % tp or cfg.d_ff % tp:
        raise ValueError(
            f"tp={tp} must divide num_heads {cfg.num_heads} and d_ff "
            f"{cfg.d_ff}")
    return devs


def rank_devices(device, tp_devices, tp: int) -> List[torch.device]:
    if tp_devices is not None:
        devs = [resolve_device(d) for d in tp_devices]
        if len(devs) != tp:
            raise ValueError(f"tp_devices names {len(devs)} devices for "
                             f"tp={tp}")
    elif torch.device(device).type == "cpu":
        devs = [torch.device("cpu")] * tp
    else:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if n < tp:
            raise ValueError(f"tp={tp} needs {tp} devices, have {n}")
        devs = [torch.device("cuda", i) for i in range(tp)]
    if len({d.type for d in devs}) != 1:
        raise ValueError(f"tp ranks on {[str(d) for d in devs]}: all on "
                         "the CPU or all on cards")
    return devs


def _backend(devs: Sequence[torch.device]) -> str:
    """NCCL when each rank has a card of its own, else gloo (the CPU, or
    ranks sharing a card: NCCL refuses two ranks on one card)."""
    if devs[0].type == "cuda" and len(set(devs)) == len(devs):
        return "nccl"
    return "gloo"


def shard_specs(params, cfg, tp: int):
    """The spec each leaf is cut by, and the plan's derivation notes:
    ``gpt_annotations("tp")`` completed by ``complete_pytree_specs`` and
    held to Megatron's split (``models/gpt.param_specs``). Returns
    ``({path: spec}, derived)``; raises ``NotImplementedError`` naming a
    leaf the plan shards where Megatron's split does not."""
    from ..sharding.plan import complete_pytree_specs, gpt_annotations
    from ..sharding.spec import pad_spec, spec_str

    specs, derived = complete_pytree_specs(
        params, gpt_annotations("tp", tp_axis="tp"), {"tp": tp})
    megatron = dict(_flatten(gpt_mod.param_specs(cfg, pp=None, tp="tp")))
    cut = {}
    for path, spec in _flatten(specs):
        meg = pad_spec(megatron[path], len(spec))
        for d, (e, m) in enumerate(zip(spec, meg)):
            if e == "tp" and m != "tp":
                raise NotImplementedError(
                    f"sharding plan 'tp': leaf {path!r} spec "
                    f"{spec_str(spec)}: tp on dim {d}, where the Megatron "
                    f"split {spec_str(meg)} does not shard it; the port "
                    "serves tp only as Megatron's split")
        cut[path] = meg
    return cut, derived


def local_tree(flat: Dict[str, torch.Tensor], cut, mesh) -> Dict[str, Any]:
    """This rank's block of every leaf of ``flat`` ({path: tensor}),
    contiguous, as a nested tree."""
    return _unflatten({p: mesh_mod.local_shard(t, cut[p], mesh).contiguous()
                       for p, t in flat.items()})


# ----------------------------------------------------------------------
# tensors over a pipe: raw element bytes (numpy has no bfloat16)
# ----------------------------------------------------------------------
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def pack_tree(flat: Dict[str, torch.Tensor]):
    """({name: tensor}, one dtype) -> (index, payload): the leaves' bytes
    back to back in one host uint8 array (one copy off the device), and
    each leaf's (name, dtype, shape, offset, nbytes)."""
    index, parts, off = [], [], 0
    for path, t in flat.items():
        t = t.detach().contiguous()
        n = t.numel() * t.element_size()
        index.append((path, str(t.dtype).replace("torch.", ""),
                      tuple(t.shape), off, n))
        parts.append(t.reshape(-1).view(torch.uint8))
        off += n
    payload = torch.cat(parts).cpu().numpy() if parts else b""
    return index, payload


def unpack_tree(index, buf) -> Dict[str, torch.Tensor]:
    """:func:`pack_tree`'s leaves, as views of ``buf`` (writable)."""
    return {path: torch.frombuffer(buf, dtype=_DTYPES[dt], offset=off,
                                   count=n // _DTYPES[dt].itemsize
                                   ).reshape(shape) if n else
            torch.empty(shape, dtype=_DTYPES[dt])
            for path, dt, shape, off, n in index}


# ----------------------------------------------------------------------
# the driver's side
# ----------------------------------------------------------------------
class RankFault(RuntimeError):
    """A tp rank failed, died or went silent in the middle of a call."""


class TpRanks:
    """The driver's handle on its followers: spawn and rendezvous
    (:meth:`start`), one command a call (:meth:`run`), the canonical cache
    read and write (``shard_io`` of the caches: :meth:`read`,
    :meth:`write`), :meth:`close`. ``on_fault(reason)`` is called once
    when a call fails (the engine poisons itself); the followers are then
    stopped."""

    def __init__(self, tp: int, devices: Sequence[torch.device],
                 timeout_s: float = DEFAULT_TIMEOUT_S,
                 on_fault: Optional[Callable[[str], None]] = None):
        self.tp = int(tp)
        self.devices = [torch.device(d) for d in devices]
        self.backend = _backend(self.devices)
        self.timeout_s = float(timeout_s)
        self.on_fault = on_fault
        self.fault: Optional[str] = None
        self.group = None
        self.mesh = None
        self.cache = None            # the driver's cache (read / write)
        self._procs: List[Any] = []
        self._conns: List[Any] = []
        self._store = None
        self._finalizer = None
        # host clock (time.time()) at each step of the start-up: the
        # driver's, then each follower's (rank order)
        self.startup: List[Dict[str, float]] = []

    @property
    def pids(self) -> List[int]:
        return [p.pid for p in self._procs]

    def start(self, init: Dict[str, Any], tree: Dict[str, torch.Tensor]
              ) -> None:
        """Spawn the followers, hand each ``init`` (the engine's config)
        and ``tree`` (the leaves it cuts its block from, sent as one host
        payload in ``_CHUNK`` messages), join the group and build the mesh.
        Their answers are read by :meth:`wait_ready`, once the driver has
        built its own shard."""
        stamps = {"spawn": time.time()}
        self.startup = [stamps]
        ctx = multiprocessing.get_context("spawn")
        self._store = penv.open_store(self.tp, self.timeout_s)
        addr = f"127.0.0.1:{self._store.port}"
        try:
            for r in range(1, self.tp):
                here, there = ctx.Pipe()
                p = ctx.Process(
                    target=_follower_main, name=f"tp-rank-{r}", daemon=True,
                    args=(r, self.tp, addr, self.backend,
                          str(self.devices[r]), self.timeout_s, there,
                          os.getpid()))
                p.start()
                there.close()
                self._procs.append(p)
                self._conns.append(here)
            self._finalizer = weakref.finalize(
                self, _shutdown, list(self._procs), list(self._conns), 5.0)
            index, payload = pack_tree(tree)
            mv = memoryview(payload).cast("B")
            stamps["packed"] = time.time()
            for r, conn in enumerate(self._conns, 1):
                self._answer(r, conn)              # the follower's hello
                stamps[f"hello{r}"] = time.time()
                conn.send(dict(init, tree_index=index, tree_nbytes=len(mv)))
                for i in range(0, len(mv), _CHUNK):
                    conn.send_bytes(mv[i:i + _CHUNK])
            del payload, mv
            stamps["sent"] = time.time()
            dev, self.group = penv.init_private_group(
                self._store, 0, self.tp, self.backend, self.timeout_s,
                self.devices[0])
            self.mesh = mesh_mod.build_mesh([("tp", self.tp)], device=dev,
                                            group=self.group)
            stamps["group"] = time.time()
        except BaseException:
            self.close(timeout_s=1.0)
            raise

    def wait_ready(self) -> None:
        """Read each follower's answer to ``init`` (its start-up stamps)."""
        self.startup[0]["shard"] = time.time()
        try:
            self.startup += [self._answer(r, c)
                             for r, c in enumerate(self._conns, 1)]
            self.startup[0]["ready"] = time.time()
        except BaseException:
            self.close(timeout_s=1.0)
            raise

    def _answer(self, rank: int, conn):
        """A follower's next answer within the timeout; RankFault when it
        died, went silent or failed."""
        if not conn.poll(self.timeout_s):
            raise RankFault(f"tp rank {rank} gave no answer within "
                            f"{self.timeout_s} s")
        try:
            status, payload = conn.recv()
        except (EOFError, OSError):
            p = self._procs[rank - 1]
            p.join(timeout=1.0)
            raise RankFault(f"tp rank {rank} exited (code {p.exitcode})")
        if status != "ok":
            raise RankFault(f"tp rank {rank} failed: {payload}")
        return payload

    def _fail(self, exc: BaseException) -> RankFault:
        """Record the fault (the followers' own errors first), tell the
        engine, stop the followers."""
        why = [f"{type(exc).__name__}: {exc}"]
        for r, conn in enumerate(self._conns, 1):
            try:
                if conn.poll(0.2):
                    status, payload = conn.recv()
                    if status != "ok":
                        why.insert(0, f"tp rank {r}: {payload}")
            except (EOFError, OSError):
                pass
        self.fault = "; ".join(why)
        self.close(timeout_s=1.0)
        if self.on_fault is not None:
            self.on_fault(self.fault)
        return exc if isinstance(exc, RankFault) else RankFault(self.fault)

    def run(self, op: str, args: Tuple = (), local: Callable = None,
            per_rank: Optional[Sequence[Tuple]] = None):
        """Send ``op`` (``args``, or follower r's ``per_rank[r - 1]``) to
        every follower, run ``local()`` on this rank, and read each
        follower's answer. Returns ``(local's result, [answers])``. Any
        failure poisons the engine (``on_fault``) and raises."""
        if self.fault is not None or not self._conns:
            raise RankFault(f"tp ranks down: {self.fault or 'closed'}")
        try:
            for r, conn in enumerate(self._conns, 1):
                conn.send((op, per_rank[r - 1] if per_rank is not None
                           else args))
            out = local() if local is not None else None
            answers = [self._answer(r, c)
                       for r, c in enumerate(self._conns, 1)]
        except Exception as e:
            raise self._fail(e) from e
        except BaseException as e:          # an interrupt mid-call
            self._fail(e)
            raise
        return out, answers

    # -- the caches' shard_io: the all-heads layout ----------------------
    def read(self, method: str, args: Tuple, axis: int):
        """Every rank's ``cache.<method>(*args)`` (a (k, v) pair of its
        heads), merged along the head ``axis`` in rank order."""
        local = getattr(self.cache, method)
        mine, theirs = self.run("cache_read", (method, args),
                                lambda: local(*args))
        parts = [unpack_tree(*a) for a in theirs]
        return (torch.cat([mine[0]] + [p["k"] for p in parts], dim=axis),
                torch.cat([mine[1]] + [p["v"] for p in parts], dim=axis))

    def write(self, method: str, args: Tuple, k, v, axis: int) -> None:
        """Split (k, v) along the head ``axis`` into the ranks' slices and
        ``cache.<method>(*args, k_r, v_r)`` on each."""
        ks = torch.tensor_split(k, self.tp, dim=axis)
        vs = torch.tensor_split(v, self.tp, dim=axis)
        per_rank = [(method, args, pack_tree({"k": ks[r], "v": vs[r]}))
                    for r in range(1, self.tp)]
        local = getattr(self.cache, method)
        self.run("cache_write", local=lambda: local(*args, ks[0], vs[0]),
                 per_rank=per_rank)

    def close(self, timeout_s: float = 10.0) -> None:
        """Stop the followers (a ``close`` command, then SIGTERM and
        SIGKILL past ``timeout_s``) and let the group go. Idempotent."""
        if self._finalizer is not None:
            self._finalizer.detach()
            self._finalizer = None
        _shutdown(self._procs, self._conns, timeout_s)
        self._procs, self._conns = [], []
        self.group = None
        self._store = None


def _shutdown(procs, conns, timeout_s: float) -> None:
    for conn in conns:
        try:
            conn.send(("close", ()))
        except (OSError, ValueError):
            pass
    deadline = time.monotonic() + timeout_s
    for p in procs:
        p.join(timeout=max(deadline - time.monotonic(), 0.0))
    for p in procs:
        if p.is_alive():
            p.terminate()
            p.join(timeout=2.0)
        if p.is_alive():
            p.kill()
            p.join(timeout=2.0)
    for conn in conns:
        conn.close()


# ----------------------------------------------------------------------
# the follower's side
# ----------------------------------------------------------------------
def _watch_parent(parent_pid: int) -> None:
    """Exit when the driver dies (the parent changes): a thread, so it
    fires while the main thread waits in a collective or on the pipe."""
    def watch():
        while True:
            if os.getppid() != parent_pid:
                os._exit(0)
            time.sleep(_WATCH_S)

    threading.Thread(target=watch, daemon=True, name="tp-watch").start()


def _follower_main(rank: int, world: int, store_addr: str, backend: str,
                   device: str, timeout_s: float, conn,
                   parent_pid: int) -> None:
    stamps = {"entry": time.time()}
    _watch_parent(parent_pid)
    _send(conn, ("ok", "hello"))
    init = _recv(conn)
    buf, got = bytearray(init["tree_nbytes"]), 0
    while got < len(buf):
        got += _recv(conn, lambda: conn.recv_bytes_into(buf, got))
    try:
        init["tree"] = unpack_tree(init.pop("tree_index"), buf)
        stamps["init"] = time.time()
        dev, group = penv.init_private_group(store_addr, rank, world,
                                             backend, timeout_s, device)
        mesh = mesh_mod.build_mesh([("tp", world)], device=dev, group=group)
        stamps["group"] = time.time()
        from .engine import DecodeEngine

        eng = DecodeEngine._follower(init, mesh)
        del init, buf
        stamps["ready"] = time.time()
    except Exception:
        _die(conn)
    _send(conn, ("ok", stamps))
    while True:
        op, args = _recv(conn)
        if op == "close":
            sys.stdout.flush()
            sys.stderr.flush()
            os._exit(0)
        try:
            if op == "cache_read":
                method, margs = args
                k, v = getattr(eng.cache, method)(*margs)
                out = pack_tree({"k": k, "v": v})
            elif op == "cache_write":
                method, margs, packed = args
                kv = unpack_tree(*packed)
                out = getattr(eng.cache, method)(*margs, kv["k"], kv["v"])
            else:
                out = getattr(eng, "_cmd_" + op)(*args)
                if isinstance(out, torch.Tensor):
                    out = None           # the driver alone reads logits
        except Exception:
            _die(conn)
        _send(conn, ("ok", out))


def _recv(conn, read=None):
    """The driver's next message (``read()``, else ``conn.recv()``); its
    end of the pipe closed means it is gone: exit."""
    try:
        return read() if read is not None else conn.recv()
    except (EOFError, OSError):
        os._exit(0)


def _send(conn, msg) -> None:
    try:
        conn.send(msg)
    except OSError:
        os._exit(0)


def _die(conn) -> None:
    """Answer with the error and exit: the peers' collectives then fail at
    once instead of waiting out the timeout."""
    msg = traceback.format_exc(limit=8)
    try:
        conn.send(("error", msg))
    except (OSError, ValueError):
        pass
    sys.stderr.write(msg)
    sys.stderr.flush()
    os._exit(1)
