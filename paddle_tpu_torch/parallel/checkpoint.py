"""Crash-safe elastic checkpoints — the port of
``paddle_tpu/parallel/checkpoint.py`` (``ElasticCheckpointer`` and the
train-state restore with dp resharding).

The on-disk format is the reference's, byte for byte, so a checkpoint
written by either package restores in the other:

- a step directory ``step_<8 digits>/`` holds one raw ``leaves/leaf_<i>.bin``
  a leaf, ``manifest.json`` (format ``paddle_tpu.elastic.v1``; per leaf its
  key, shape, dtype name, byte count and crc32; the mesh, the flat-moment
  bucket layout, the data position and ``extra``) and, written last, the
  ``COMMIT`` marker. A directory without its marker is never a restore
  candidate and the next save's GC removes it;
- leaf keys are JAX ``keystr`` paths (``['params']['blocks']['w_qkv']``,
  ``[0]`` for a list index) in ``tree_flatten`` order: dict keys sorted at
  every level;
- bfloat16 leaves are their raw 2-byte words under the dtype name
  ``bfloat16``, as JAX writes them (numpy has no bfloat16; the port never
  passes through it).

What differs from JAX is the process model. JAX saves from one process
that addresses every shard. The port runs one process a rank, so a gang
(``ElasticCheckpointer(mesh=)``) gathers every sharded leaf to full size
(params along their ``param_specs`` axes; the reduce-scatter moments into
JAX's global flat vector, world rank order), rank 0 alone snapshots and
writes, and :meth:`ElasticCheckpointer.wait` ends in a barrier, so no rank
goes on before the commit is visible. The port's step updates params and
moments IN PLACE, so ``save`` finishes its device -> host copy before it
returns (the async writer then holds host bytes the next step cannot
touch), and :func:`restore_train_state` copies into the live tensors
(rebinding them would orphan the flat buffer the fused sweep updates).

Save metrics ride the port's registry: ``paddle_checkpoint_save_ms`` and
``paddle_checkpoint_bytes_total``. Each leaf gathered, written, verified
or read stamps the hang watchdog's progress (``checkpoint/save``,
``/write``, ``/verify``, ``/restore``): a store that moves is not hung,
and one that stops moving is. As in the reference, the spans
``checkpoint/save`` (the snapshot), ``checkpoint/write`` (on the writer,
under the save's span) and ``checkpoint/restore`` time each phase, and
the goodput ledger charges the snapshot to ``checkpoint_save`` and the
restore to ``restore``.

:class:`ShardedCheckpointer` is the counterpart of the reference's orbax
store (``checkpoint.py:727-861``), built on ``torch.distributed.checkpoint``
(DCP): every rank writes only its own shards, each leaf going in as a
``DTensor`` on a ``DeviceMesh`` laid out like the port's row-major mesh,
so a load into another layout reshards. A step is committed once DCP's
``.metadata`` has landed (or the port's ``COMMIT`` marker);
:func:`abstract_like` and :func:`abstract_for_mesh` give the restore
targets (:class:`AbstractLeaf`: global shape, dtype, spec, mesh). It is
held to the reference by behaviour and restored values, not by bytes.
``build_restore_broadcast_program`` comes with the fluid datasets and
raises ``NotImplementedError`` naming its queue.
"""
from __future__ import annotations

import json
import os
import queue
import re
import shutil
import threading
import time
import zlib
import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..observability import goodput as _goodput
from ..observability import metrics as _obs_metrics
from ..observability import spans as _spans
from . import health
from . import mesh as mesh_mod

__all__ = [
    "CheckpointError", "CheckpointCorruptError", "MeshMismatchError",
    "LayoutReshardError", "check_mesh_compatible",
    "ElasticCheckpointer", "ShardedCheckpointer", "AbstractLeaf",
    "abstract_for_mesh", "abstract_like",
    "serialize_layout", "deserialize_layout", "reshard_flat",
    "restore_train_state", "train_state_specs",
    "build_restore_broadcast_program", "flatten_with_keys",
]

MANIFEST_NAME = "manifest.json"
COMMIT_NAME = "COMMIT"
FORMAT = "paddle_tpu.elastic.v1"
_STEP_RX = re.compile(r"^step_(\d+)$")

_REG = _obs_metrics.default_registry()
_m_save_ms = _REG.histogram(
    "paddle_checkpoint_save_ms",
    "Wall time of one checkpoint save (host snapshot + write + commit)")
_m_bytes = _REG.counter(
    "paddle_checkpoint_bytes_total",
    "Bytes of checkpoint leaf data committed to disk")


class CheckpointError(RuntimeError):
    pass


class CheckpointCorruptError(CheckpointError):
    """A committed checkpoint failed integrity verification."""


class MeshMismatchError(CheckpointError):
    """The manifest's mesh contradicts the live mesh and no reshard path
    covers the difference: restoring would place every shard wrong."""


class LayoutReshardError(CheckpointError):
    """A flat-moment reshard across layouts at pp·tp > 1. JAX's format
    stores such a buffer as each dp shard ``repl`` times, but the copies
    are not equal there: each (pp, tp) coordinate holds the moments of its
    own shards of the pp- and tp-sharded leaves. The reshard would keep
    the first copy and lose the rest, so the port refuses it (a limit of
    the reference's format, ROADMAP C)."""


def check_mesh_compatible(saved_mesh: Optional[Dict[str, int]],
                          live_mesh: Optional[Dict[str, int]], *,
                          reshardable: bool = False,
                          where: str = "checkpoint") -> None:
    """Raise :class:`MeshMismatchError` when ``saved_mesh`` (manifest)
    cannot restore onto ``live_mesh``: equal meshes pass, equal axis names
    with other sizes pass only with a reshard path (``reshardable``),
    other axis sets never; ``None`` on either side skips the check."""
    if not saved_mesh or not live_mesh:
        return
    saved = {str(k): int(v) for k, v in dict(saved_mesh).items()}
    live = {str(k): int(v) for k, v in dict(live_mesh).items()}
    if saved == live:
        return
    if set(saved) == set(live) and reshardable:
        return
    detail = ("axis sets differ" if set(saved) != set(live) else
              "axis sizes differ and no reshardable layout was provided")
    raise MeshMismatchError(
        f"{where}: saved mesh {saved} does not match the live mesh "
        f"{live} ({detail}) — restoring would silently misplace shards. "
        "Restore onto the saved topology, or provide the source and target "
        "bucket layouts for the dp reshard path.")


def _atomic_write(path: str, data: bytes) -> None:
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "wb") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


# ---------------------------------------------------------------------------
# Keys and leaves
# ---------------------------------------------------------------------------

def flatten_with_keys(tree, is_leaf=None, prefix: str = ""
                      ) -> List[Tuple[str, Any]]:
    """(JAX ``keystr``, leaf) pairs in ``tree_flatten`` order: dicts by
    sorted key, lists and tuples by index, ``None`` an empty subtree."""
    if is_leaf is not None and is_leaf(tree):
        return [(prefix, tree)]
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out.extend(flatten_with_keys(tree[k], is_leaf,
                                         f"{prefix}[{k!r}]"))
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for i, v in enumerate(tree):
            out.extend(flatten_with_keys(v, is_leaf, f"{prefix}[{i}]"))
        return out
    if tree is None:
        return []
    return [(prefix, tree)]


def _rebuild(like, values: Dict[str, Any], prefix: str = ""):
    """``like``'s structure with each leaf replaced by ``values[key]``."""
    if isinstance(like, dict):
        return {k: _rebuild(like[k], values, f"{prefix}[{k!r}]")
                for k in like}
    if isinstance(like, (list, tuple)):
        return type(like)(_rebuild(v, values, f"{prefix}[{i}]")
                          for i, v in enumerate(like))
    if like is None:
        return None
    return values[prefix]


_KEYSTR_RX = re.compile(r"\['((?:[^'\\]|\\.)*)'\]")


def _unflatten_keystrs(by_key: Dict[str, Any]):
    """{keystr: leaf} -> the nested dicts, when every key is a pure dict
    path; otherwise the flat dict unchanged."""
    parsed = []
    for key, arr in by_key.items():
        segs = _KEYSTR_RX.findall(key)
        if "".join(f"['{s}']" for s in segs) != key:
            return dict(by_key)
        parsed.append((segs, arr))
    out: Dict[str, Any] = {}
    for segs, arr in parsed:
        cur = out
        for s in segs[:-1]:
            cur = cur.setdefault(s, {})
            if not isinstance(cur, dict):
                return dict(by_key)
        cur[segs[-1]] = arr
    return out


_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16, "float64": torch.float64,
           "int8": torch.int8, "int16": torch.int16, "int32": torch.int32,
           "int64": torch.int64, "uint8": torch.uint8, "bool": torch.bool}
_NAMES = {v: k for k, v in _DTYPES.items()}


def _to_host(x) -> torch.Tensor:
    """The snapshot point: a contiguous CPU tensor no later step can
    change (a device tensor is copied down, synchronously; a host one,
    numpy arrays and Python scalars included, is copied)."""
    if isinstance(x, torch.Tensor):
        t = x.detach()
        t = t.to("cpu") if t.device.type != "cpu" else t.clone()
        return t.contiguous()
    arr = np.asarray(x)
    if arr.dtype == object or arr.dtype.name not in _DTYPES:
        raise CheckpointError(f"cannot checkpoint a leaf of dtype "
                              f"{arr.dtype} ({type(x).__name__})")
    return torch.from_numpy(np.array(arr, copy=True))


def _leaf_bytes(t: torch.Tensor) -> memoryview:
    """The leaf's raw bytes, without a copy."""
    return memoryview(t.reshape(-1).view(torch.uint8).numpy())


def _leaf_from_bytes(data: bytes, dtype_name: str, shape) -> torch.Tensor:
    if dtype_name not in _DTYPES:
        raise CheckpointError(f"unknown leaf dtype {dtype_name!r}")
    dt = _DTYPES[dtype_name]
    if not data:
        return torch.empty(tuple(shape), dtype=dt)
    flat = torch.frombuffer(bytearray(data), dtype=torch.uint8)
    return flat.view(dt).reshape(tuple(shape))


# ---------------------------------------------------------------------------
# Bucket-layout (de)serialization + bit-exact flat-moment resharding
# ---------------------------------------------------------------------------

def serialize_layout(layout, repl: int = 1) -> dict:
    """comm_opt.BucketLayout -> its manifest entry; ``repl`` = pp·tp, how
    many times each dp shard appears in the global flat vector."""
    return {
        "ranks": int(layout.ranks),
        "repl": int(repl),
        "total_len": int(layout.total_len),
        "buckets": [
            {"dtype": b.dtype, "size": int(b.size), "pad": int(b.pad),
             "entries": [[int(i), list(map(int, shape)), int(n)]
                         for i, shape, n in b.entries]}
            for b in layout.buckets
        ],
    }


def deserialize_layout(d: dict):
    from .comm_opt import Bucket, BucketLayout

    buckets = tuple(
        Bucket(dtype=b["dtype"],
               entries=tuple((int(i), tuple(shape), int(n))
                             for i, shape, n in b["entries"]),
               size=int(b["size"]), pad=int(b["pad"]))
        for b in d["buckets"])
    return BucketLayout(buckets=buckets, ranks=int(d["ranks"]),
                        total_len=int(d["total_len"])), int(d.get("repl", 1))


def _layout_leaf_numels(layout) -> Dict[int, int]:
    return {idx: numel for b in layout.buckets
            for idx, _shape, numel in b.entries}


def reshard_flat(vec, src_layout, dst_layout, src_repl: int = 1,
                 dst_repl: int = 1):
    """Reshard a flat dp-sharded moment buffer between bucket layouts
    (a dp-2 save -> a dp-1 restore): unpack the source layout to per-leaf
    vectors, repack into the destination's (pad regions zero). Pure data
    movement, bit-exact for any dtype; ``vec`` a 1-D tensor or numpy
    array, returned in kind. Raises when the layouts cover different
    leaves."""
    src_nums = _layout_leaf_numels(src_layout)
    dst_nums = _layout_leaf_numels(dst_layout)
    if src_nums != dst_nums:
        raise CheckpointError(
            "cannot reshard: bucket layouts cover different leaf sets "
            f"(src {len(src_nums)} leaves / {sum(src_nums.values())} elems, "
            f"dst {len(dst_nums)} leaves / {sum(dst_nums.values())} elems)")
    as_numpy = not isinstance(vec, torch.Tensor)
    t = torch.from_numpy(np.asarray(vec)) if as_numpy else vec
    t = t.reshape(-1)
    expect = src_layout.ranks * src_repl * src_layout.shard_len
    if t.numel() != expect:
        raise CheckpointError(
            f"flat buffer length {t.numel()} does not match source layout "
            f"(ranks={src_layout.ranks} repl={src_repl} "
            f"shard_len={src_layout.shard_len}; expected {expect})")
    # strip replication: each dp shard appears src_repl times back to back
    sl = src_layout.shard_len
    flat_src = torch.cat([t[d * src_repl * sl: d * src_repl * sl + sl]
                          for d in range(src_layout.ranks)])
    leaves: Dict[int, torch.Tensor] = {}
    off = 0
    for b in src_layout.buckets:
        for idx, _shape, numel in b.entries:
            leaves[idx] = flat_src[off:off + numel]
            off += numel
        off += b.pad
    parts: List[torch.Tensor] = []
    for b in dst_layout.buckets:
        for idx, _shape, _numel in b.entries:
            parts.append(leaves[idx])
        if b.pad:
            parts.append(t.new_zeros((b.pad,)))
    flat_dst = torch.cat(parts)
    dl = dst_layout.shard_len
    out = torch.cat([flat_dst[d * dl:(d + 1) * dl].repeat(dst_repl)
                     for d in range(dst_layout.ranks)])
    return out.numpy() if as_numpy else out


# ---------------------------------------------------------------------------
# Gathering a gang's shards to full leaves
# ---------------------------------------------------------------------------

def _gather_full(x: torch.Tensor, spec, mesh: "mesh_mod.Mesh"
                 ) -> torch.Tensor:
    """The full array of which every rank holds its ``spec`` block: one
    all-gather over the line of the axes ``spec`` names (a collective:
    every rank calls it), the blocks placed by their ranks' coordinates."""
    used = mesh_mod.spec_axes(spec)
    axes = [a for a in mesh.axis_names if a in used]
    if not axes or all(mesh.sizes[a] == 1 for a in axes):
        return x
    group = mesh.group(*axes)
    parts = group.all_gather(x.detach().contiguous().reshape(1, -1))
    sizes = [mesh.sizes[a] for a in axes]
    full_shape = list(x.shape)
    zero = {a: 0 for a in mesh.axis_names}
    for d, entry in enumerate(spec):
        ways, _ = mesh_mod._dim_split(entry, mesh.sizes, zero)
        full_shape[d] *= ways
    full = torch.empty(full_shape, dtype=x.dtype, device=parts.device)
    for j in range(group.size):
        coords = dict(zero)
        coords.update(zip(axes, (int(c) for c in
                                 np.unravel_index(j, sizes))))
        idx = []
        for d, entry in enumerate(spec):
            _, i = mesh_mod._dim_split(entry, mesh.sizes, coords)
            n = x.shape[d]
            idx.append(slice(i * n, (i + 1) * n))
        full[tuple(idx)] = parts[j].view(x.shape)
    return full


def train_state_specs(cfg, pcfg, opt) -> Dict[str, tuple]:
    """{key: spec} of the sharded leaves of ``{"params": ..., "opt":
    ...}`` as ``parallelize.init_sharded`` lays them out on ``pcfg``'s
    mesh: params by ``param_specs``; per-leaf moments likewise; flat
    moments (and the error-feedback residual) over every mesh axis, which
    is JAX's global flat vector in world rank order. Other leaves are
    replicated."""
    from ..models import gpt as G

    _, pp_ax, tp_ax = pcfg.axis_names
    is_spec = lambda s: isinstance(s, tuple)   # noqa: E731
    pspecs = G.param_specs(cfg, pp=pp_ax, tp=tp_ax)
    out = {f"['params']{k}": s for k, s in flatten_with_keys(pspecs, is_spec)}
    flat = (tuple(pcfg.axis_names),)
    for name in ("m", "v", "ef"):
        if name not in opt:
            continue
        if isinstance(opt[name], dict):
            out.update({f"['opt'][{name!r}]{k}": s for k, s in
                        flatten_with_keys(pspecs, is_spec)})
        else:
            out[f"['opt'][{name!r}]"] = flat
    return out


# ---------------------------------------------------------------------------
# ElasticCheckpointer: crash-safe store of raw leaves
# ---------------------------------------------------------------------------

class ElasticCheckpointer:
    """Crash-safe checkpoint store: raw per-leaf ``.bin`` files + integrity
    manifest + atomic ``COMMIT`` marker.

    ``save`` gathers and snapshots the state to host memory before it
    returns and, with ``use_async``, writes on a background thread that
    overlaps the next steps; ``wait()`` (or the next restore) joins it.
    ``keep_last=N`` keeps the N newest committed steps and removes older
    ones and uncommitted debris.

    ``mesh`` (the port's :class:`~.mesh.Mesh`) makes the store a gang's:
    every rank calls ``save``, ``wait`` and the restores alike; rank 0
    writes; ``wait`` ends in a barrier over the world, and a writer error
    on rank 0 raises on every rank there."""

    def __init__(self, dirname: str, use_async: bool = True,
                 keep_last: Optional[int] = None, mesh=None):
        self.dirname = os.path.abspath(str(dirname))
        self.mesh = mesh
        self.writer = mesh is None or mesh.rank == 0
        if self.writer:
            os.makedirs(self.dirname, exist_ok=True)
        self.keep_last = keep_last
        self._use_async = use_async
        self._queue: "queue.Queue" = queue.Queue()
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self._inflight: set = set()
        self._lock = threading.Lock()
        self._unsynced = False
        #: per save on this process: step, snapshot_ms (gather + device ->
        #: host, the caller's thread), write_ms (bytes, crc32, files and
        #: commit on the writer), bytes
        self.history: List[dict] = []
        #: the last restore's read_ms (read + verify), reshard_ms, place_ms
        self.last_restore: dict = {}

    # -- paths / bookkeeping ------------------------------------------------

    def _path(self, step: int) -> str:
        return os.path.join(self.dirname, f"step_{int(step):08d}")

    def all_steps(self) -> List[int]:
        """Committed steps only: a directory without its COMMIT marker or
        its manifest is never a candidate."""
        if not os.path.isdir(self.dirname):
            return []
        out = []
        for name in os.listdir(self.dirname):
            m = _STEP_RX.match(name)
            if not m:
                continue
            d = os.path.join(self.dirname, name)
            if os.path.exists(os.path.join(d, COMMIT_NAME)) and \
                    os.path.exists(os.path.join(d, MANIFEST_NAME)):
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def latest_valid_step(self) -> Optional[int]:
        """Newest committed step that also passes verification (sizes and
        crc32): the restore target of a supervised restart."""
        self.wait()
        for step in reversed(self.all_steps()):
            if not self.verify(step):
                return step
        return None

    def manifest(self, step: int) -> dict:
        path = os.path.join(self._path(step), MANIFEST_NAME)
        try:
            with open(path) as f:
                return json.load(f)
        except (OSError, ValueError) as e:
            raise CheckpointCorruptError(
                f"checkpoint step {step}: unreadable manifest {path}: {e}")

    @staticmethod
    def _check_leaf(leaf: dict, data: bytes) -> Optional[str]:
        if len(data) != leaf["bytes"]:
            return (f"{leaf['file']}: truncated — {len(data)} bytes on disk "
                    f"vs {leaf['bytes']} in manifest")
        crc = zlib.crc32(data)
        if crc != leaf["crc32"]:
            return (f"{leaf['file']}: checksum mismatch — crc32 {crc} on "
                    f"disk vs {leaf['crc32']} in manifest")
        return None

    def verify(self, step: int) -> List[str]:
        """Integrity-check one committed step; a list of problems (empty
        == valid), each naming its file."""
        problems: List[str] = []
        d = self._path(step)
        try:
            man = self.manifest(step)
        except CheckpointCorruptError as e:
            return [str(e)]
        for leaf in man.get("leaves", []):
            try:
                with open(os.path.join(d, leaf["file"]), "rb") as f:
                    data = f.read()
            except OSError as e:
                problems.append(f"{leaf['file']}: unreadable ({e})")
                continue
            p = self._check_leaf(leaf, data)
            if p:
                problems.append(p)
            health.progress("checkpoint/verify")
        return problems

    # -- save ---------------------------------------------------------------

    def save(self, step: int, state: Any, *, mesh: Optional[dict] = None,
             layout=None, layout_repl: int = 1,
             data_state: Optional[dict] = None,
             extra: Optional[dict] = None,
             keep_last: Optional[int] = None,
             specs: Optional[Dict[str, tuple]] = None) -> str:
        """Snapshot ``state`` (nested dicts / lists of tensors) for
        ``step``. ``mesh`` is the manifest's {axis: size} (a gang store
        defaults to its mesh's sizes), ``layout`` the comm_opt BucketLayout
        of flat dp-sharded moments (``layout_repl`` = pp·tp), ``data_state``
        the dataset position, ``extra`` free JSON. In a gang ``specs``
        ({key: spec}, :func:`train_state_specs`) names the sharded leaves
        to gather. Returns the step directory (the commit may still be in
        flight: ``wait()``)."""
        self._raise_pending()
        if data_state is not None:
            try:
                json.dumps(data_state)
            except (TypeError, ValueError) as e:
                raise CheckpointError(
                    f"data_state for step {step} is not JSON-serializable "
                    f"({e})") from e
        t0 = time.perf_counter_ns()
        leaves = []
        # the synchronous share of a save (gather + device -> host
        # snapshot) is the caller's wall time; the async write overlaps
        # the next steps and is not charged to the ledger
        with _goodput.timer("checkpoint_save"), \
                _spans.span("checkpoint/save", attrs={"step": int(step)}), \
                torch.no_grad():
            for key, x in flatten_with_keys(state):
                if self.mesh is not None and isinstance(x, torch.Tensor):
                    spec = (specs or {}).get(key)
                    if spec:
                        x = _gather_full(x, spec, self.mesh)
                if self.writer:
                    leaves.append((key, _to_host(x)))
                health.progress("checkpoint/save")
            # the writer thread's span parents to this save's
            span_ctx = _spans.current_context()
        snapshot_ms = (time.perf_counter_ns() - t0) / 1e6
        if mesh is None and self.mesh is not None:
            mesh = dict(self.mesh.sizes)
        self._unsynced = self.mesh is not None
        rec = {"step": int(step), "snapshot_ms": snapshot_ms}
        self.history.append(rec)
        if not self.writer:
            return self._path(step)
        man: Dict[str, Any] = {
            "format": FORMAT, "step": int(step),
            "time": time.time(),
            "mesh": dict(mesh) if mesh else None,
            "layout": (serialize_layout(layout, layout_repl)
                       if layout is not None else None),
            "data": dict(data_state) if data_state else None,
            "extra": dict(extra) if extra else None,
        }
        keep = self.keep_last if keep_last is None else keep_last
        with self._lock:
            self._inflight.add(int(step))
        job = (step, leaves, man, keep, t0, rec, span_ctx)
        if self._use_async:
            self._ensure_thread()
            self._queue.put(job)
        else:
            self._write(*job)
        return self._path(step)

    def _ensure_thread(self):
        if self._thread is None or not self._thread.is_alive():
            self._thread = threading.Thread(
                target=self._drain, name="elastic-ckpt-writer", daemon=True)
            self._thread.start()

    def _drain(self):
        while True:
            job = self._queue.get()
            if job is None:
                self._queue.task_done()
                return
            try:
                self._write(*job)
            except BaseException as e:  # surfaced by wait() / next save
                self._error = e
            finally:
                self._queue.task_done()

    def _write(self, step, leaves, man, keep, t0, rec, span_ctx=None):
        with _spans.default_tracer().context(span_ctx), \
                _spans.span("checkpoint/write", attrs={"step": int(step)}):
            self._write_inner(step, leaves, man, keep, t0, rec)

    def _write_inner(self, step, leaves, man, keep, t0, rec):
        t_w = time.perf_counter_ns()
        d = self._path(step)
        # a re-save of the same step replaces any earlier attempt
        if os.path.exists(d):
            shutil.rmtree(d, ignore_errors=True)
        os.makedirs(os.path.join(d, "leaves"), exist_ok=True)
        total = 0
        man_leaves = []
        for i, (key, t) in enumerate(leaves):
            rel = os.path.join("leaves", f"leaf_{i}.bin")
            data = _leaf_bytes(t)
            _atomic_write(os.path.join(d, rel), data)
            man_leaves.append({
                "key": key, "file": rel, "shape": list(t.shape),
                "dtype": _NAMES[t.dtype], "bytes": data.nbytes,
                "crc32": zlib.crc32(data),
            })
            total += data.nbytes
            # a write that moves leaf by leaf is progress, not a hang
            health.progress("checkpoint/write")
        man = dict(man, leaves=man_leaves, total_bytes=total)
        _atomic_write(os.path.join(d, MANIFEST_NAME),
                      json.dumps(man, indent=1).encode())
        # the commit point: everything before it is invisible to restore
        _atomic_write(os.path.join(d, COMMIT_NAME),
                      json.dumps({"step": int(step),
                                  "time": time.time()}).encode())
        with self._lock:
            self._inflight.discard(int(step))
        now = time.perf_counter_ns()
        rec.update(write_ms=(now - t_w) / 1e6, bytes=total)
        _m_bytes.inc(total)
        _m_save_ms.observe((now - t0) / 1e6)
        if keep is not None:
            self.gc(keep_last=keep)

    def wait(self) -> None:
        """Join every in-flight async save and re-raise the first writer
        error; in a gang, then a barrier (after which every rank sees the
        commit), and rank 0's error raises on every rank."""
        err = None
        if self.writer:
            if self._use_async and self._thread is not None:
                self._queue.join()
            err, self._error = self._error, None
        if self._unsynced:
            self._unsynced = False
            world = self.mesh.group(*self.mesh.axis_names)
            flag = torch.tensor([1.0 if err is not None else 0.0],
                                device=self.mesh.device)
            if float(world.all_reduce(flag)[0]) and err is None:
                raise CheckpointError("async checkpoint save failed on "
                                      "rank 0 (its log has the error)")
        if err is not None:
            raise CheckpointError(f"async checkpoint save failed: {err!r}") \
                from err

    def _raise_pending(self):
        if self._error is not None:
            err, self._error = self._error, None
            raise CheckpointError(f"async checkpoint save failed: {err!r}") \
                from err

    # -- gc -----------------------------------------------------------------

    def gc(self, keep_last: Optional[int] = None) -> List[str]:
        """Remove uncommitted step directories (not being written) and,
        with ``keep_last``, committed steps beyond the N newest; the
        removed paths. A gang's rank 0 alone removes."""
        removed: List[str] = []
        if not self.writer or not os.path.isdir(self.dirname):
            return removed
        with self._lock:
            inflight = set(self._inflight)
        committed = self.all_steps()
        drop_committed = set()
        if keep_last is not None and keep_last >= 0:
            drop_committed = set(committed[:max(0, len(committed) - keep_last)])
        for name in sorted(os.listdir(self.dirname)):
            m = _STEP_RX.match(name)
            if not m:
                continue
            step = int(m.group(1))
            if step in inflight:
                continue
            d = os.path.join(self.dirname, name)
            committed_dir = os.path.exists(os.path.join(d, COMMIT_NAME)) \
                and os.path.exists(os.path.join(d, MANIFEST_NAME))
            if (not committed_dir) or step in drop_committed:
                shutil.rmtree(d, ignore_errors=True)
                removed.append(d)
        return removed

    # -- restore ------------------------------------------------------------

    def _restore_flat(self, step: Optional[int] = None, verify: bool = True
                      ) -> Tuple[Dict[str, torch.Tensor], dict]:
        """One committed step as {key: CPU tensor}, each leaf read once
        and, with ``verify``, checked as it is read."""
        with _goodput.timer("restore"), _spans.span("checkpoint/restore"):
            return self._restore_flat_inner(step, verify)

    def _restore_flat_inner(self, step: Optional[int], verify: bool
                            ) -> Tuple[Dict[str, torch.Tensor], dict]:
        self.wait()
        t0 = time.perf_counter_ns()
        if step is None:
            step = self.latest_step()
            if step is None:
                raise CheckpointError(
                    f"no committed checkpoint under {self.dirname}")
        man = self.manifest(step)
        d = self._path(step)
        by_key: Dict[str, torch.Tensor] = {}
        problems: List[str] = []
        for leaf in man["leaves"]:
            try:
                with open(os.path.join(d, leaf["file"]), "rb") as f:
                    data = f.read()
            except OSError as e:
                problems.append(f"{leaf['file']}: unreadable ({e})")
                continue
            p = self._check_leaf(leaf, data) if verify else None
            if p:
                problems.append(p)
                continue
            by_key[leaf["key"]] = _leaf_from_bytes(data, leaf["dtype"],
                                                   leaf["shape"])
            health.progress("checkpoint/restore")
        if problems:
            raise CheckpointCorruptError(
                f"checkpoint step {step} under {self.dirname} is "
                "corrupt:\n  " + "\n  ".join(problems) +
                "\n(restore from an older committed step, or delete "
                "this directory)")
        self.last_restore = {"step": int(step),
                             "read_ms": (time.perf_counter_ns() - t0) / 1e6}
        return by_key, man

    def restore(self, step: Optional[int] = None, like: Any = None,
                verify: bool = True,
                mesh: Optional[Dict[str, int]] = None) -> Tuple[Any, dict]:
        """Load one committed step (the latest with ``step=None``);
        ``(state, manifest)`` with CPU tensors as leaves. ``verify`` checks
        every leaf and raises :class:`CheckpointCorruptError` naming the
        bad file. With ``like`` (the saved structure) leaves are matched
        by key and returned in it; otherwise the nested dicts are rebuilt
        from the keys. ``mesh`` ({axis: size}) must equal the saved one
        (this restore has no reshard path)."""
        by_key, man = self._restore_flat(step, verify=verify)
        check_mesh_compatible(man.get("mesh"), mesh, reshardable=False,
                              where=f"restore step {man['step']}")
        if like is None:
            return _unflatten_keystrs(by_key), man
        for key, _x in flatten_with_keys(like):
            if key not in by_key:
                raise CheckpointError(
                    f"checkpoint step {man['step']} has no leaf {key!r} "
                    f"(saved leaves: {sorted(by_key)[:8]}...)")
        return _rebuild(like, by_key), man

    def close(self):
        if self._use_async and self._thread is not None \
                and self._thread.is_alive():
            self._queue.join()
            self._queue.put(None)
            self._thread.join(timeout=5)
        self._raise_pending()


# ---------------------------------------------------------------------------
# Train-state restore with reshard (the dp-2 -> dp-1 path)
# ---------------------------------------------------------------------------

_FLAT_OPT_KEYS = ("m", "v", "ef")


def restore_train_state(ckpt: ElasticCheckpointer, params, opt, *,
                        layout=None, layout_repl: int = 1,
                        step: Optional[int] = None, mesh=None,
                        specs: Optional[Dict[str, tuple]] = None):
    """Restore a ``(params, opt)`` train state saved by
    :meth:`ElasticCheckpointer.save` onto the CURRENT topology, IN PLACE:
    every live tensor of ``params`` and ``opt`` is ``copy_``-ed from its
    saved leaf (so views into a flat buffer stay views).

    ``layout`` is the live comm_opt BucketLayout of dp-sharded flat
    moments (``layout_repl`` = pp·tp); the saved one comes from the
    manifest and :func:`reshard_flat` moves the moments between the two,
    bit-exactly (at pp·tp > 1 that raises :class:`LayoutReshardError`).
    ``mesh`` is the port's Mesh (its sizes are checked against the saved
    mesh and each rank takes its block of every leaf ``specs`` names:
    :func:`train_state_specs`) or a plain {axis: size} for the check
    alone. Returns ``(params, opt, manifest)``."""
    raw, man = ckpt._restore_flat(step)
    t0 = time.perf_counter_ns()
    src = man.get("layout")
    src_layout = src_repl = None
    if src is not None:
        src_layout, src_repl = deserialize_layout(src)
    is_mesh = isinstance(mesh, mesh_mod.Mesh)
    live = dict(mesh.sizes) if is_mesh else mesh
    check_mesh_compatible(
        man.get("mesh"), live,
        reshardable=(src_layout is not None and layout is not None),
        where=f"restore_train_state step {man['step']}")
    reshard_ns = 0
    cuda = False
    state = {"params": params, "opt": opt}
    with torch.no_grad():
        for key, target in flatten_with_keys(state):
            if key not in raw:
                raise CheckpointError(
                    f"checkpoint step {man['step']} has no leaf {key!r}")
            arr = raw[key]
            flat_opt = any(key == f"['opt']['{k}']" for k in _FLAT_OPT_KEYS)
            if flat_opt and src_layout is not None and layout is not None \
                    and serialize_layout(src_layout, src_repl) \
                    != serialize_layout(layout, layout_repl):
                if src_repl > 1 or layout_repl > 1:
                    raise LayoutReshardError(
                        f"leaf {key!r}: cannot reshard flat moments saved "
                        f"at pp·tp = {src_repl} onto pp·tp = {layout_repl}: "
                        "the (pp, tp) copies of a dp shard hold different "
                        "leaves, which the format stores as equal")
                t_r = time.perf_counter_ns()
                arr = reshard_flat(arr, src_layout, layout,
                                   src_repl=src_repl, dst_repl=layout_repl)
                reshard_ns += time.perf_counter_ns() - t_r
            if is_mesh and specs and key in specs:
                arr = mesh_mod.local_shard(arr, specs[key], mesh)
            if not isinstance(target, torch.Tensor):
                raise CheckpointError(f"leaf {key!r}: the live state holds "
                                      f"a {type(target).__name__}, not a "
                                      "tensor to restore into")
            if tuple(arr.shape) != tuple(target.shape):
                raise CheckpointError(
                    f"leaf {key!r}: saved shape {tuple(arr.shape)} does not "
                    f"match target {tuple(target.shape)} (mesh change "
                    "without a reshardable layout?)")
            target.copy_(arr.to(target.dtype))
            cuda = cuda or target.is_cuda
    if cuda:
        torch.cuda.synchronize()
    ckpt.last_restore.update(
        reshard_ms=reshard_ns / 1e6,
        place_ms=(time.perf_counter_ns() - t0 - reshard_ns) / 1e6)
    return params, opt, man


# ---------------------------------------------------------------------------
# ShardedCheckpointer: every rank writes its shards (DCP)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class AbstractLeaf:
    """A restore target: the leaf's global shape and dtype, its spec over
    ``mesh`` (None: the whole leaf on one process) and the device its
    local shard lands on."""
    shape: Tuple[int, ...]
    dtype: torch.dtype
    spec: tuple = ()
    mesh: Any = None
    device: Any = "cpu"

    def local_shape(self) -> Tuple[int, ...]:
        if self.mesh is None:
            return tuple(self.shape)
        return mesh_mod.local_shape(self.shape, self.spec, self.mesh.sizes)


def _ways(spec, mesh, rank: int) -> List[int]:
    """How many ways each of ``rank`` dims is split by ``spec``."""
    out = [1] * rank
    for d, e in enumerate(spec):
        for a in (e if isinstance(e, (tuple, list)) else (e,)):
            if a is not None:
                out[d] *= mesh.sizes[a]
    return out


def _placements(spec, mesh, path: str):
    """The DTensor placements (one a mesh axis, in mesh order) of a spec.
    A dim over several axes must list them in mesh order (DTensor splits
    a dim by its mesh dims left to right, as the port's row-major mesh
    lays out the shards)."""
    from torch.distributed.tensor import Replicate, Shard

    out = [Replicate()] * len(mesh.axis_names)
    for d, e in enumerate(spec):
        axes = [a for a in (e if isinstance(e, (tuple, list)) else (e,))
                if a is not None]
        idx = [mesh.axis_names.index(a) for a in axes]
        if idx != sorted(idx):
            raise NotImplementedError(
                f"leaf {path!r}: spec {spec} splits dim {d} over axes out "
                f"of the mesh's order {mesh.axis_names}")
        for i in idx:
            out[i] = Shard(d)
    return out


def _contiguous_stride(shape) -> Tuple[int, ...]:
    stride, acc = [], 1
    for n in reversed(shape):
        stride.append(acc)
        acc *= int(n)
    return tuple(reversed(stride))


class ShardedCheckpointer:
    """Save and restore a training state (a tree of tensors) with
    ``torch.distributed.checkpoint``: every rank writes only its shards.

    ``mesh`` (the port's :class:`~.mesh.Mesh`) is the layout ``save``
    describes its leaves on, with ``specs`` (a tree like the state's;
    missing or None = replicated); without a mesh the state is whole on
    this process, and ``save`` raises in a world of several ranks (each
    would write the same files: pass the mesh, whose replicated leaves
    DCP writes once). ``save`` is asynchronous with ``use_async`` (DCP's
    ``async_save``: the shards are copied to host memory before it
    returns, the write overlaps the next steps; ``wait`` or the next
    save joins it); ``keep_last=N`` keeps the N newest committed steps.
    ``restore`` takes the TARGET layout as :class:`AbstractLeaf` records
    (:func:`abstract_like`, :func:`abstract_for_mesh`) and returns each
    rank's local shards, so a (dp 2, tp 2) save restores at (dp 4, tp 1).
    Step selection skips uncommitted directories (no ``.metadata``, no
    ``COMMIT``). In a world of several ranks ``save``, ``wait`` and a
    restore onto a mesh are collective; DCP's own collectives run on a
    gloo group of the checkpointer's (a background write must not share
    a group with the training step's collectives); rank 0 removes
    directories."""

    METADATA = ".metadata"

    def __init__(self, dirname: str, use_async: bool = True, mesh=None):
        self.dirname = os.path.abspath(str(dirname))
        os.makedirs(self.dirname, exist_ok=True)
        self.use_async = use_async
        self.mesh = mesh
        self._pending = None
        self._pg = None
        self._device_meshes: Dict[Tuple, Any] = {}

    # -- the world ----------------------------------------------------------

    @staticmethod
    def _dist() -> bool:
        import torch.distributed as dist

        return dist.is_available() and dist.is_initialized() \
            and dist.get_world_size() > 1

    def _group(self):
        """The checkpointer's gloo group over the world (made at its first
        collective use; every rank makes it in the same call)."""
        import torch.distributed as dist

        if self._pg is None:
            self._pg = dist.new_group(backend="gloo")
        return self._pg

    def _coordinator(self) -> bool:
        import torch.distributed as dist

        return not self._dist() or dist.get_rank() == 0

    def _barrier(self) -> None:
        import torch.distributed as dist

        if self._dist():
            dist.barrier(group=self._group())

    def _device_mesh(self, mesh):
        """A CPU ``DeviceMesh`` laid out like ``mesh`` (row-major ranks,
        its axis names): the shards are host copies, so DCP's collectives
        never touch the card."""
        from torch.distributed.device_mesh import DeviceMesh

        key = (mesh.axis_names, mesh.shape)
        if key not in self._device_meshes:
            self._device_meshes[key] = DeviceMesh(
                "cpu", torch.arange(mesh.size).reshape(mesh.shape),
                mesh_dim_names=mesh.axis_names)
        return self._device_meshes[key]

    def _dtensor(self, local: torch.Tensor, shape, spec, mesh, path):
        from torch.distributed.tensor import DTensor

        return DTensor.from_local(
            local, self._device_mesh(mesh), _placements(spec, mesh, path),
            run_check=False, shape=torch.Size(shape),
            stride=_contiguous_stride(shape))

    # -- paths / bookkeeping ------------------------------------------------

    def _path(self, step: int) -> str:
        return os.path.join(self.dirname, f"step_{int(step):08d}")

    def _is_committed(self, name: str) -> Optional[int]:
        """The step number iff ``name`` is a committed step directory."""
        m = _STEP_RX.match(name)
        if not m:
            return None
        d = os.path.join(self.dirname, name)
        if not os.path.isdir(d):
            return None
        if os.path.exists(os.path.join(d, self.METADATA)) or \
                os.path.exists(os.path.join(d, COMMIT_NAME)):
            return int(m.group(1))
        return None

    def all_steps(self) -> List[int]:
        if not os.path.isdir(self.dirname):
            return []
        return sorted(s for s in map(self._is_committed,
                                     os.listdir(self.dirname))
                      if s is not None)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def gc(self, keep_last: Optional[int] = None) -> List[str]:
        """Remove uncommitted step directories (a save killed midway) and,
        with ``keep_last``, committed steps past the N newest; rank 0
        removes, the others return []."""
        removed: List[str] = []
        if not self._coordinator() or not os.path.isdir(self.dirname):
            return removed
        committed = self.all_steps()
        drop = set()
        if keep_last is not None and keep_last >= 0:
            drop = set(committed[:max(0, len(committed) - keep_last)])
        for name in sorted(os.listdir(self.dirname)):
            full = os.path.join(self.dirname, name)
            if not (os.path.isdir(full) and _STEP_RX.match(name)):
                continue
            step = self._is_committed(name)
            if step is None or step in drop:
                shutil.rmtree(full, ignore_errors=True)
                removed.append(full)
        return removed

    # -- save ---------------------------------------------------------------

    def _state_dict(self, state, specs) -> Dict[str, Any]:
        """{keystr: host copy of the leaf}, each leaf a DTensor of its
        global shape on the checkpointer's mesh (whole tensors without
        one)."""
        spec_of = dict(flatten_with_keys(specs, is_leaf=lambda x: isinstance(
            x, tuple))) if specs is not None else {}
        out = {}
        for key, leaf in flatten_with_keys(state):
            local = _to_host(leaf)
            if self.mesh is None:
                out[key] = local
                continue
            spec = tuple(spec_of.get(key) or ())
            shape = [n * w for n, w in zip(
                local.shape, _ways(spec, self.mesh, local.dim()))]
            out[key] = self._dtensor(local, shape, spec, self.mesh, key)
        return out

    def save(self, step: int, state: Any, force: bool = False,
             keep_last: Optional[int] = None, specs: Any = None) -> str:
        """Write ``state`` (this rank's shards by ``specs`` on the
        checkpointer's mesh) as step ``step``. A committed step is kept
        unless ``force``; an uncommitted one is debris and is replaced."""
        import torch.distributed.checkpoint as dcp

        if self.mesh is None and self._dist():
            raise CheckpointError(
                f"save of step {step} under {self.dirname}: a checkpointer "
                "without a mesh in a world of several ranks would have every "
                "rank write the same files; pass mesh= (replicated specs are "
                "written once)")
        self.wait()
        path = self._path(step)
        if self._is_committed(os.path.basename(path)) is not None \
                and not force:
            raise CheckpointError(f"step {step} under {self.dirname} is "
                                  "already committed (force=True replaces "
                                  "it)")
        if self._coordinator() and os.path.isdir(path):
            shutil.rmtree(path)
        self._barrier()
        sd = self._state_dict(state, specs)
        kw = dict(checkpoint_id=path)
        if self.mesh is not None and self._dist():
            kw["process_group"] = self._group()
        else:
            kw["no_dist"] = True
        if self.use_async:
            self._pending = dcp.async_save(sd, **kw)
        else:
            dcp.save(sd, **kw)
        if keep_last is not None:
            # join the write first: a GC during it could remove the step
            self.wait()
            self.gc(keep_last=keep_last)
        return path

    def wait(self) -> None:
        """Join the asynchronous save in flight, if any (its error raises
        here)."""
        pending, self._pending = self._pending, None
        if pending is None:
            return
        done = getattr(pending, "upload_completion", pending)
        done.result()

    # -- restore ------------------------------------------------------------

    def restore(self, step: int, abstract_state: Any) -> Any:
        """The state of step ``step`` in the TARGET layout of
        ``abstract_state`` (a tree of :class:`AbstractLeaf`): each leaf
        this rank's shard on its record's device. Targets on a mesh load
        collectively (every rank calls), others on this process alone."""
        import torch.distributed.checkpoint as dcp

        self.wait()
        if self._is_committed(f"step_{int(step):08d}") is None:
            raise CheckpointError(
                f"step {step} under {self.dirname} is missing or "
                "uncommitted (killed mid-save?) — pick one of "
                f"{self.all_steps()}")
        leaves = flatten_with_keys(abstract_state, is_leaf=lambda x:
                                   isinstance(x, AbstractLeaf))
        sd, on_mesh = {}, False
        for key, a in leaves:
            local = torch.empty(a.local_shape(), dtype=a.dtype)
            if a.mesh is None:
                sd[key] = local
            else:
                on_mesh = True
                sd[key] = self._dtensor(local, a.shape, a.spec, a.mesh, key)
        kw = dict(checkpoint_id=self._path(step))
        if on_mesh and self._dist():
            kw["process_group"] = self._group()
        else:
            kw["no_dist"] = True
        dcp.load(sd, **kw)
        out = {}
        for key, a in leaves:
            t = sd[key]
            t = t.to_local() if a.mesh is not None else t
            out[key] = t.to(a.device)
        return _rebuild(abstract_state, out)

    def close(self) -> None:
        self.wait()


def abstract_like(tree: Any, specs: Any = None, mesh=None) -> Any:
    """Live leaves (this rank's shards by ``specs`` on ``mesh``; whole
    tensors without a mesh) -> their :class:`AbstractLeaf` records: the
    restore target of the same layout."""
    spec_of = dict(flatten_with_keys(specs, is_leaf=lambda x: isinstance(
        x, tuple))) if specs is not None else {}
    out = {}
    for key, x in flatten_with_keys(tree):
        t = x if isinstance(x, torch.Tensor) else torch.as_tensor(x)
        spec = tuple(spec_of.get(key) or ())
        shape = tuple(t.shape)
        if mesh is not None:
            shape = tuple(n * w for n, w in zip(
                shape, _ways(spec, mesh, t.dim())))
        out[key] = AbstractLeaf(shape, t.dtype, spec, mesh, t.device)
    return _rebuild(tree, out)


def abstract_for_mesh(tree: Any, specs: Any, mesh) -> Any:
    """Restore targets on ``mesh`` by ``specs``: ``tree``'s leaves give the
    GLOBAL shape and dtype (:class:`AbstractLeaf` records, e.g. from
    :func:`abstract_like`, or whole tensors), the shards land on the
    mesh's device. The cross-topology restore: pass the NEW mesh."""
    spec_of = dict(flatten_with_keys(specs, is_leaf=lambda x: isinstance(
        x, tuple)))
    out = {key: AbstractLeaf(tuple(x.shape), x.dtype,
                             tuple(spec_of.get(key) or ()), mesh,
                             mesh.device)
           for key, x in flatten_with_keys(
               tree, is_leaf=lambda x: isinstance(x, AbstractLeaf))}
    return _rebuild(tree, out)


def build_restore_broadcast_program(var_specs, ring_id: int = 0,
                                    axis: str = "dp",
                                    cond_name: str = "found_checkpoint"):
    raise NotImplementedError(
        "build_restore_broadcast_program (a fluid program of c_broadcast "
        "ops) is still to be ported with the fluid datasets (ROADMAP A5)")
