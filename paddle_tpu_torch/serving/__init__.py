"""Serving on the card — the port of ``paddle_tpu.serving`` (slab and paged
KV layouts): the decode engine with its Hopper kernels (f32, bf16 or int8
weights), the page pool and prefix cache, speculative decoding, the
continuous-batching scheduler, the HTTP front door, phase-disaggregated
serving (the KV handoff, the in-process prefill -> decode router and the
shared prefix index), the subprocess replica gang with its persistent
prefix store, and tensor-parallel engines (``EngineConfig(sharding="tp",
tp=N)``: follower rank processes, ``serving/tp.py``)."""
from .engine import (DecodeEngine, EngineConfig, PromptTooLongError,
                     default_bucket_ladder)
from .kv_cache import CacheFullError, KVCache
from .paged_kv import PagedKVCache, PagePoolFullError, PrefixCache
from .sampling import GREEDY, SamplingParams
from .scheduler import QueueFullError, Request, Scheduler, SchedulerConfig
from .server import EngineLoop, FrontDoor, shed_decision
from .spec_decode import SpecDecodeEngine, SpecStats
from .kv_transfer import (CacheConfigMismatch, KVTransferServer,
                          adopt_into_engine, cache_fingerprint, export_slot)
from .disagg import DisaggRouter, LocalReplica, SharedPrefixIndex
from .prefix_store import PrefixStore
from .replica import POISONED_EXIT_CODE, ReplicaRole
from .gang import GangConfig, GangFrontDoor, ReplicaGang

__all__ = ["DecodeEngine", "EngineConfig", "PromptTooLongError",
           "default_bucket_ladder", "CacheFullError", "KVCache",
           "PagedKVCache", "PagePoolFullError", "PrefixCache", "GREEDY",
           "SamplingParams", "QueueFullError", "Request", "Scheduler",
           "SchedulerConfig", "EngineLoop", "FrontDoor", "shed_decision",
           "SpecDecodeEngine", "SpecStats", "CacheConfigMismatch",
           "KVTransferServer", "cache_fingerprint", "export_slot",
           "adopt_into_engine", "DisaggRouter", "LocalReplica",
           "SharedPrefixIndex", "PrefixStore", "POISONED_EXIT_CODE",
           "ReplicaRole", "ReplicaGang", "GangConfig", "GangFrontDoor"]
