"""KV cache, greedy generation and the continuous-batching serving stack."""

from .engine import Request, ServeEngine, load_engine_state, save_engine_state
from .generate import chunked_prefill, forward_cached, greedy_generate, prefill
from .kvcache import KVCache, init_cache
from .sampling import SamplingConfig, filtered_logits, sample_per_row
from .server import ServingServer

__all__ = [
    "chunked_prefill",
    "forward_cached",
    "greedy_generate",
    "prefill",
    "KVCache",
    "init_cache",
    "SamplingConfig",
    "filtered_logits",
    "sample_per_row",
    "Request",
    "ServeEngine",
    "ServingServer",
    "save_engine_state",
    "load_engine_state",
]
