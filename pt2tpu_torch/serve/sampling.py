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

Speculative sampling (:func:`spec_accept_per_row`, the speculative engine's
Leviathan / Chen rejection) keys its draws as JAX's ``_spec_keys`` does: the
triple (seed, uid, position) with a salt mixed in last, 1 for the drafts, 2
for the accept draws, 3 for the final draw (:func:`spec_seed`).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch

__all__ = ["SamplingConfig", "filtered_logits", "sample", "sample_per_row", "row_seed",
           "spec_seed", "spec_draw", "spec_accept_per_row"]

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


def spec_seed(seed: int, uid: int, position: int, salt: int) -> int:
    """The generator seed of one speculative draw: (seed, uid, position)
    folded as :func:`row_seed` folds them, then ``salt`` (JAX's
    ``_spec_keys``: 1 draft, 2 accept, 3 final)."""
    m = lambda v: v & _MASK64  # noqa: E731
    return _mix64(_mix64(_mix64(_mix64(m(seed)) ^ m(uid)) ^ m(position)) ^ m(salt)) >> 1


def _spec_generator(seed, uid, position, salt, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(spec_seed(int(seed), int(uid), int(position), salt))
    return g


def spec_draw(probs: torch.Tensor, seed: int, uids: Sequence[int], positions: Sequence[int],
              salt: int, rows: Optional[Sequence[int]] = None) -> torch.Tensor:
    """(B,) one draw per row from the distributions ``probs`` (B, V): the
    argmax of log(p + 1e-20) plus Gumbel noise from the row's generator
    (:func:`spec_seed` of its uid and position); rows not in ``rows``
    (default: all) take the argmax of log(p + 1e-20)."""
    B, V = probs.shape
    dev = probs.device
    noise = torch.zeros((B, V), dtype=torch.float32, device=dev)
    for b in range(B) if rows is None else rows:
        g = _spec_generator(seed, uids[b], positions[b], salt, dev)
        noise[b] = _gumbel(torch.rand(V, generator=g, device=dev))
    return torch.argmax(torch.log(probs.float() + 1e-20) + noise, dim=-1)


def spec_accept_per_row(
    seed: int,
    uids: Sequence[int],  # (B,) request ids
    positions: Sequence[int],  # (B,) draft-window start positions
    drafts: torch.Tensor,  # (B, k) tokens drawn from pd
    pd: torch.Tensor,  # (B, k, V) draft probabilities (filtered, normalised)
    pt: torch.Tensor,  # (B, k + 1, V) target probabilities (filtered, normalised)
):
    """Speculative sampling's acceptance (Leviathan / Chen), per row, as
    ``pt2tpu.serve.sampling.spec_accept_per_row``: draft i is accepted with
    probability min(1, pt_i[d_i] / pd_i[d_i]) (a uniform draw, salt 2, at
    position + i); at the first rejection the final token is drawn from
    normalize(max(pt_i - pd_i, 0)) (pt_i where that is empty), and when all
    k are accepted from pt_k (salt 3, at position + n_acc). The emitted
    tokens are distributed as target-only sampling. Returns (tokens
    (B, k + 1), n_acc (B,)) on the device: row b emits ``tokens[b, :n_acc[b]
    + 1]``. The final draw's noise is made for every n_acc a row could have
    (k + 1 generators a row), so nothing is read back to the host."""
    B, k = drafts.shape
    V = pd.shape[-1]
    dev = pd.device
    eps = 1e-20
    u = torch.empty((B, k), dtype=torch.float32)
    for b in range(B):
        for i in range(k):
            g = _spec_generator(seed, uids[b], positions[b] + i, 2, "cpu")
            u[b, i] = torch.rand(1, generator=g)[0]
    u = u.to(dev)
    d = drafts.long()[..., None]
    pd_d = pd.float().gather(-1, d)[..., 0]
    pt_d = pt[:, :k].float().gather(-1, d)[..., 0]
    accept = u < pt_d / pd_d.clamp_min(eps)
    n_acc = torch.cumprod(accept.long(), dim=1).sum(dim=1)  # first reject; k if all accepted

    r = n_acc.clamp(0, k - 1)[:, None, None].expand(B, 1, V)
    pt_r = pt.float().gather(1, r)[:, 0]
    pd_r = pd.float().gather(1, r)[:, 0]
    resid = (pt_r - pd_r).clamp_min(0.0)
    rs = resid.sum(dim=-1, keepdim=True)
    dist_rej = torch.where(rs > eps, resid / rs.clamp_min(eps), pt_r)
    dist = torch.where((n_acc == k)[:, None], pt[:, k].float(), dist_rej)
    noise = torch.empty((k + 1, B, V), dtype=torch.float32, device=dev)
    for j in range(k + 1):
        for b in range(B):
            g = _spec_generator(seed, uids[b], positions[b] + j, 3, dev)
            noise[j, b] = _gumbel(torch.rand(V, generator=g, device=dev))
    picked = noise.gather(0, n_acc[None, :, None].expand(1, B, V))[0]
    final = torch.argmax(torch.log(dist + eps) + picked, dim=-1)

    idx = torch.arange(k + 1, device=dev)[None, :]
    drafts_pad = torch.cat([drafts.long(), torch.zeros((B, 1), dtype=torch.long, device=dev)], 1)
    tokens = torch.where(idx < n_acc[:, None], drafts_pad, torch.zeros_like(drafts_pad))
    tokens = torch.where(idx == n_acc[:, None], final[:, None], tokens)
    return tokens, n_acc
