"""The decode floor on a GPU: the same greedy decode under impl "auto"
(exact bf16), "a8" (W2A8) and "floor8" (W2A8 with the 2-bit unpack skipped
in K1, K3 and K6: the raw packed bytes dotted, the same bytes, grids and
launches), so a8 - floor8 is the unpack's share of a decode step. The
port of scripts/floor_ab.py.

llama-2-7b at full width (``--layers`` cuts its depth), ``perm_mode="ssr"``
random ternary weights, ``greedy_generate`` at ``--batch`` rows of
``--prompt`` ids. A step's time is a slope: for each impl a short and a long
run (``--new`` / 4 and ``--new`` new tokens), interleaved in one process
for ``--rounds`` rounds, the best of each; (long - short) / (new tokens
between them). floor8's tokens are wrong by design; it is timed, not read.

Prints ms/step and tok/s per impl, a8 - floor8 and floor8 / a8, with the
card's name and power limit; the last line is one JSON object.

Usage: python scripts/torch_floor_ab.py [--layers 32] [--rounds 3]
           [--prompt 32] [--new 64] [--batch 1]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
IMPLS = ("auto", "a8", "floor8")


def smi() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=30).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "nvidia-smi unavailable"


def floor_ab(cfg, params, prompt, new: int, rounds: int, impls=IMPLS) -> dict:
    """Per impl the slope ms/step of ``greedy_generate`` on ``prompt``
    between ``new`` // 4 (at least 8) and ``new`` new tokens: short and long
    runs interleaved over ``rounds`` rounds after one warm run each, the
    best time of each kept. Returns {impl: {"ms_step", "tok_s"}} and the
    a8 - floor8 difference where both ran."""
    import torch

    from pt2tpu_torch.serve.generate import greedy_generate

    B, Lp = prompt.shape
    short = max(8, new // 4)
    M = -(-(Lp + new + 8) // 128) * 128

    def run(impl, n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        greedy_generate(cfg, params, prompt, n, max_len=M, impl=impl)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    best = {}
    for impl in impls:
        for n in (short, new):
            run(impl, n)  # warm: scratch, counters, allocator
            best[(impl, n)] = float("inf")
    for _ in range(rounds):
        for impl in impls:
            for n in (short, new):
                best[(impl, n)] = min(best[(impl, n)], run(impl, n))
    res = {}
    for impl in impls:
        per = (best[(impl, new)] - best[(impl, short)]) / (new - short)
        res[impl] = {"ms_step": per * 1e3, "tok_s": B / per}
    if "a8" in res and "floor8" in res:
        res["unpack_ms_step"] = res["a8"]["ms_step"] - res["floor8"]["ms_step"]
        res["floor8_over_a8"] = res["floor8"]["ms_step"] / res["a8"]["ms_step"]
    return res


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--layers", type=int, default=32, help="depth (llama-2-7b has 32)")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--prompt", type=int, default=32)
    ap.add_argument("--new", type=int, default=64)
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA GPU: the floor probe is a kernel mode")
    sys.path.insert(0, ROOT)
    from pt2tpu_torch.models.registry import get_config
    from pt2tpu_torch.utils.randmodel import random_ternary_params

    card = smi()
    cfg = get_config("llama-2-7b").with_(n_layers=args.layers)
    params = random_ternary_params(cfg, seed=args.seed, perm_mode="ssr", device="cuda")
    g = torch.Generator(device="cuda").manual_seed(args.seed)
    prompt = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt), generator=g,
                           device="cuda")
    res = floor_ab(cfg, params, prompt, args.new, args.rounds)
    for impl in IMPLS:
        print(f"{impl:7s}: {res[impl]['ms_step']:8.3f} ms/step {res[impl]['tok_s']:8.1f} tok/s "
              f"(llama-2-7b ssr, {args.layers} layers, B {args.batch}) on {card}")
    print(f"a8 - floor8 (the unpack's share): {res['unpack_ms_step']:.3f} ms/step; floor8 / a8 "
          f"{100 * res['floor8_over_a8']:.1f} % on {card}")
    print(json.dumps({"card": card, "layers": args.layers, "batch": args.batch,
                      "prompt": args.prompt, "new": args.new, "rounds": args.rounds, **res}))


if __name__ == "__main__":
    main()
