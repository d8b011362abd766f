"""KV cache, lockstep generation (greedy or sampled, flat or ring caches,
speculative) and the continuous-batching serving stack (flat, ring or paged
pools; a draft model). The sampled lockstep decode is
``serve.generate.generate`` (the name ``generate`` here is its module)."""

from .engine import Request, ServeEngine, load_engine_state, save_engine_state
from .generate import chunked_prefill, forward_cached, greedy_generate, prefill
from .kvcache import KVCache, init_cache
from .ring import RingCaches, init_ring_caches, make_ring_engine_fns, ring_generate
from .sampling import SamplingConfig, filtered_logits, sample, sample_per_row
from .server import ServingServer
from .speculative import SpecStats, speculative_generate

__all__ = [
    "chunked_prefill",
    "forward_cached",
    "greedy_generate",
    "prefill",
    "KVCache",
    "init_cache",
    "RingCaches",
    "init_ring_caches",
    "make_ring_engine_fns",
    "ring_generate",
    "SamplingConfig",
    "filtered_logits",
    "sample",
    "sample_per_row",
    "Request",
    "ServeEngine",
    "ServingServer",
    "SpecStats",
    "speculative_generate",
    "save_engine_state",
    "load_engine_state",
]
