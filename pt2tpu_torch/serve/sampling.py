"""Token sampling (counterpart of ``pt2tpu.serve.sampling``): temperature,
top-k and top-p, with one configuration for a lockstep batch
(:func:`sample`, the lockstep ``generate``'s) or parameters per row
(:func:`sample_per_row`, the serving engine's); greedy takes the exact
argmax.

:func:`sample` draws from an explicit ``torch.Generator`` (JAX's from a
threefry key): the same filtered distribution, other draws.

JAX keys a sampled row by ``fold_in(fold_in(seed, uid), position)``
(threefry). Here the row's noise comes from a ``torch.Generator`` seeded
from the same triple (seed, request uid, position of the input token), so a
row's token depends on nothing else: not on the batch it shares, the order
of admission, or the decode quantum. The generators differ, so sampled
streams differ from JAX's; greedy rows are identical. Positions are known
on the host, so seeding needs no device sync.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch

__all__ = ["SamplingConfig", "filtered_logits", "sample", "sample_per_row", "row_seed"]

_MASK64 = (1 << 64) - 1


@dataclasses.dataclass(frozen=True)
class SamplingConfig:
    temperature: float = 0.0  # 0 => greedy
    top_k: int = 0  # 0 => disabled
    top_p: float = 1.0  # 1.0 => disabled

    @property
    def greedy(self) -> bool:
        return self.temperature <= 0.0


def _mix64(x: int) -> int:
    """splitmix64's finaliser: a bijective mix of a 64-bit integer."""
    x = (x + 0x9E3779B97F4A7C15) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return x ^ (x >> 31)


def row_seed(seed: int, uid: int, position: int) -> int:
    """The generator seed of one sampled token: a mix of (seed, uid,
    position) folded in that order, as JAX folds its key."""
    return _mix64(_mix64(_mix64(seed & _MASK64) ^ (uid & _MASK64)) ^ (position & _MASK64)) >> 1


def filtered_logits(
    logits: torch.Tensor,  # (B, V)
    temps: torch.Tensor,  # (B,) f32
    top_ks: torch.Tensor,  # (B,) int; 0 => disabled
    top_ps: torch.Tensor,  # (B,) f32; >= 1 => disabled
) -> torch.Tensor:
    """The per-row logits that :func:`sample_per_row` samples from:
    temperature scaling, then top-k and top-p masks (-inf outside)."""
    B, V = logits.shape
    lt = logits.float() / temps.float().clamp_min(1e-6)[:, None]
    desc = torch.sort(lt, dim=-1, descending=True).values
    kidx = (top_ks.long() - 1).clamp(0, V - 1)
    kth = desc.gather(1, kidx[:, None])
    lt = torch.where((top_ks[:, None] > 0) & (lt < kth), float("-inf"), lt)

    desc2 = torch.sort(lt, dim=-1, descending=True).values
    cum = torch.cumsum(torch.softmax(desc2, dim=-1), dim=-1)
    cutoff_idx = (cum < top_ps.float()[:, None]).sum(dim=-1).clamp(0, V - 1)
    cutoff_val = desc2.gather(1, cutoff_idx[:, None])
    return torch.where((top_ps[:, None] < 1.0) & (lt < cutoff_val), float("-inf"), lt)


def _gumbel(u: torch.Tensor) -> torch.Tensor:
    """Gumbel noise from uniforms in [0, 1) (floored at the smallest normal
    f32): argmax(logits + noise) is a draw from softmax(logits)."""
    return -torch.log(-torch.log(u.clamp_min(torch.finfo(torch.float32).tiny)))


def sample(
    logits: torch.Tensor,  # (B, V)
    generator: Optional[torch.Generator] = None,
    cfg: SamplingConfig = SamplingConfig(),
) -> torch.Tensor:
    """(B,) int32 token ids, as ``pt2tpu.serve.sampling.sample``: the argmax
    for a greedy ``cfg``; else one draw per row from the softmax of
    :func:`filtered_logits` (temperature, then top-k, then top-p, one
    configuration for every row), with the noise from ``generator``, which
    must lie on the logits' device. A non-greedy ``cfg`` without a generator
    raises, as JAX's does without a key."""
    if cfg.greedy:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    if generator is None:
        raise ValueError("non-greedy sampling requires a torch.Generator")
    B, V = logits.shape
    dev = logits.device
    lt = filtered_logits(
        logits,
        torch.full((B,), cfg.temperature, dtype=torch.float32, device=dev),
        torch.full((B,), cfg.top_k, dtype=torch.int64, device=dev),
        torch.full((B,), cfg.top_p, dtype=torch.float32, device=dev),
    )
    noise = _gumbel(torch.rand((B, V), generator=generator, device=dev))
    return torch.argmax(lt + noise, dim=-1).to(torch.int32)


def sample_per_row(
    logits: torch.Tensor,  # (B, V)
    seed: int,
    uids: Sequence[int],  # (B,) request ids
    positions: Sequence[int],  # (B,) positions of the input tokens
    temps: Sequence[float],  # (B,); <= 0 => greedy row
    top_ks: Sequence[int],
    top_ps: Sequence[float],
) -> torch.Tensor:
    """(B,) int64 token ids on the logits' device. The per-row parameters
    are host values. A sampled row adds Gumbel noise from its own generator
    to its filtered logits and takes the argmax (a draw from their
    softmax); a greedy row takes the argmax of its logits."""
    B, V = logits.shape
    dev = logits.device
    greedy = torch.argmax(logits.float(), dim=-1)
    sampled_rows = [b for b in range(B) if temps[b] > 0.0]
    if not sampled_rows:
        return greedy
    lt = filtered_logits(
        logits,
        torch.tensor(list(temps), dtype=torch.float32, device=dev),
        torch.tensor(list(top_ks), dtype=torch.int64, device=dev),
        torch.tensor(list(top_ps), dtype=torch.float32, device=dev),
    )
    noise = torch.zeros((B, V), dtype=torch.float32, device=dev)
    for b in sampled_rows:
        g = torch.Generator(device=dev)
        g.manual_seed(row_seed(int(seed), int(uids[b]), int(positions[b])))
        noise[b] = _gumbel(torch.rand(V, generator=g, device=dev))
    sampled = torch.argmax(lt + noise, dim=-1)
    is_sampled = torch.tensor([t > 0.0 for t in temps], device=dev)
    return torch.where(is_sampled, sampled, greedy)
