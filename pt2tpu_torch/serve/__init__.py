"""KV cache and greedy generation."""
