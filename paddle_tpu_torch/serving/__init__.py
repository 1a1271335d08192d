"""Serving on the card — the port of ``paddle_tpu.serving`` (slab KV
layout): the decode engine with its three Hopper kernels, the
continuous-batching scheduler and the HTTP front door."""
from .engine import (DecodeEngine, EngineConfig, PromptTooLongError,
                     default_bucket_ladder)
from .kv_cache import CacheFullError, KVCache
from .sampling import GREEDY, SamplingParams
from .scheduler import QueueFullError, Request, Scheduler, SchedulerConfig
from .server import EngineLoop, FrontDoor

__all__ = ["DecodeEngine", "EngineConfig", "PromptTooLongError",
           "default_bucket_ladder", "CacheFullError", "KVCache", "GREEDY",
           "SamplingParams", "QueueFullError", "Request", "Scheduler",
           "SchedulerConfig", "EngineLoop", "FrontDoor"]
