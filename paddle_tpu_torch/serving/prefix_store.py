"""Persistent prefix-cache store: published pages survive engine restarts —
the port of ``paddle_tpu/serving/prefix_store.py``.

The paged engine's :class:`~.paged_kv.PrefixCache` prefills a shared
system prompt once per engine incarnation. A crash or a gang recycle
(``serving/gang.py``) would throw the warmed pages away; this store keeps
them. At publish time the engine hands it the page-aligned prefix (token
stream and page table row) and the store reads the pages' K/V contents off
the pool — one device -> host copy a record — and persists them through an
:class:`~..parallel.checkpoint.ElasticCheckpointer` (per-leaf crc32
manifests, an atomic COMMIT marker, async writes, ``keep_last`` GC), so a
kill in the middle of a save never leaves a record a restore would trust.
The records are the JAX package's on disk: either package restores the
other's. On boot :meth:`restore_into` replays the committed records: it
claims pages from the pool, writes their contents back onto the pool's
device (one host -> device copy a record) and registers every nested
page-boundary prefix in the prefix cache.

Records carry the writing pool's geometry fingerprint
(``kv_transfer.cache_fingerprint``: layout, layers, heads, head_dim,
dtype, page_size). Restoring into a differently configured engine raises
:class:`~.kv_transfer.CacheConfigMismatch` naming every differing field;
legacy records without a fingerprint are skipped on a shape change.

Counted in ``paddle_serve_prefix_store_total{op=save|restore|
restore_skipped}``.
"""
from __future__ import annotations

import hashlib
import time
from typing import List

import numpy as np
import torch

from ..parallel.checkpoint import CheckpointError, ElasticCheckpointer
from . import metrics as smetrics
from .kv_transfer import (CacheConfigMismatch, cache_fingerprint,
                          fingerprint_mismatch)

__all__ = ["PrefixStore"]


class PrefixStore:
    """One store directory per replica slot. Records are numbered
    ``step_<N>`` in publish order; ``max_records`` bounds the store with
    the checkpointer's ``keep_last`` GC (the oldest published go first).
    ``publish_ms`` keeps each save's time on the caller's thread (the
    engine loop): the page gather, its one copy to the host and the
    checkpointer's snapshot."""

    def __init__(self, dirname: str, max_records: int = 64,
                 use_async: bool = True):
        self.dirname = str(dirname)
        self.max_records = int(max_records)
        self._ck = ElasticCheckpointer(self.dirname, use_async=use_async,
                                       keep_last=self.max_records)
        self.saved = 0
        self.restored = 0
        self.restore_skipped = 0
        self.publish_ms: List[float] = []
        # token-hash index of the records on disk (loaded lazily, extended
        # on publish): a re-published prefix is not saved again
        self._keys = None
        self._next_step = None

    @staticmethod
    def _key(tokens) -> str:
        return hashlib.sha1(
            np.asarray(tokens, np.int64).tobytes()).hexdigest()

    def _load_index(self) -> None:
        if self._keys is not None:
            return
        self._keys = set()
        steps = self._ck.all_steps()
        self._next_step = (steps[-1] + 1) if steps else 0
        for step in steps:
            try:
                man = self._ck.manifest(step)
            except CheckpointError:
                continue
            key = (man.get("extra") or {}).get("token_hash")
            if key:
                self._keys.add(key)

    def _skip(self) -> None:
        self.restore_skipped += 1
        smetrics.m_prefix_store.labels("restore_skipped").inc()

    # ------------------------------------------------------------------
    def maybe_publish(self, tokens, table_row: np.ndarray, pool) -> bool:
        """Persist the longest page-aligned prefix of ``tokens`` (its
        nested sub-prefixes restore with it). A no-op when no page is full,
        a page is unmapped, or the prefix is stored already. Returns True
        when a record was written (async; committed atomically)."""
        self._load_index()
        ps = pool.page_size
        full = len(tokens) // ps
        if full < 1:
            return False
        prefix = [int(t) for t in tokens[:full * ps]]
        pages = [int(p) for p in table_row[:full]]
        if any(p == 0 for p in pages):
            return False
        key = self._key(prefix)
        if key in self._keys:
            return False
        t0 = time.perf_counter_ns()
        idx = torch.as_tensor(pages, dtype=torch.long, device=pool.k.device)
        # K and V of the record in one gather and one copy to the host
        kv = torch.stack((pool.k[:, idx], pool.v[:, idx])).cpu()
        step = self._next_step
        self._ck.save(step, {
            "tokens": np.asarray(prefix, np.int64),
            "k": kv[0],
            "v": kv[1],
        }, extra={"token_hash": key, "n_pages": len(pages),
                  "page_size": ps,
                  "fingerprint": cache_fingerprint(pool)})
        self.publish_ms.append((time.perf_counter_ns() - t0) / 1e6)
        self._keys.add(key)
        self._next_step = step + 1
        self.saved += 1
        smetrics.m_prefix_store.labels("save").inc()
        return True

    def restore_into(self, engine) -> int:
        """Replay every committed record into ``engine``'s pool and prefix
        cache (at boot, before ``warmup``). A record that no longer fits —
        its prefix already live, or too few free pages (one is left for
        live traffic) — is skipped, never half-applied. Returns how many
        records were restored.

        A record whose fingerprint differs from the receiving pool's raises
        :class:`CacheConfigMismatch` naming every differing field; a legacy
        record without one is skipped when its shape differs."""
        if engine.prefix is None:
            raise ValueError("prefix store needs a paged engine with "
                             "prefix_cache enabled")
        pool, cache = engine.cache, engine.prefix
        fp_local = cache_fingerprint(pool)
        expect = (pool.num_layers, pool.page_size, pool.num_heads,
                  pool.head_dim)
        n = 0
        for step in self._ck.all_steps():
            try:
                rec, man = self._ck.restore(step)
            except CheckpointError:
                self._skip()
                continue
            fp_rec = (man.get("extra") or {}).get("fingerprint")
            if fp_rec is not None:
                diffs = fingerprint_mismatch(fp_local, fp_rec)
                if diffs:
                    raise CacheConfigMismatch(
                        f"prefix store {self.dirname!r} step_{step} was "
                        f"written for a different cache config — "
                        + "; ".join(diffs)
                        + " (point the replica at a store written by a "
                          "matching engine, or clear the store)")
            tokens = [int(t) for t in rec["tokens"].tolist()]
            k_pages, v_pages = rec["k"], rec["v"]
            shape_tail = (k_pages.shape[0],) + tuple(k_pages.shape[2:])
            n_pages = k_pages.shape[1]
            if (shape_tail != expect or k_pages.shape != v_pages.shape
                    or n_pages * pool.page_size != len(tokens)
                    or cache._key(tokens) in cache._entries
                    or pool.free_page_count() <= n_pages):
                self._skip()
                continue
            pages = pool.claim_pages(n_pages)
            # one copy onto the pool's device for K and V together
            kv = torch.stack((k_pages, v_pages)).to(pool.k.device)
            pool.write_pages(pages, kv[0], kv[1])
            cache.adopt_nested(tokens, pages)
            n += 1
            self.restored += 1
            smetrics.m_prefix_store.labels("restore").inc()
        return n

    def record_count(self) -> int:
        return len(self._ck.all_steps())

    def wait(self) -> None:
        """Join the in-flight async publishes."""
        self._ck.wait()

    def close(self) -> None:
        self._ck.close()
