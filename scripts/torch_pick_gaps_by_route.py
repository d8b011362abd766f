"""Worst pick gaps of the bf16 lockstep or engine route, by route, on a GPU.

A model at full width and depth in the "down" layout, random weights made
from --model-seed as ``chip_smoke.py`` makes them (gemma-2b: seed 13;
llama-3-8b: seed 5). Lockstep (the default): for each of --seeds prompt sets
(4 x 128 ids from torch.Generator seeds 0, 1, ...), greedy_generate decodes
32 tokens on three routes that differ only in the decode steps' MLP:

  fused      the default: K2 (the whole MLP in one launch; gate and up stay
             in f32, mid is rounded to bf16 once);
  fused_pv   the same route with K2 swapped for its plain version
             (``ternary_mlp_plain``, the same arithmetic in PyTorch);
  two_call   FUSED_MLP off: gateup through K1, its output rounded to bf16,
             act and product in bf16, then down through K1 (the schedule of
             the plain route, impl "plain").

With --engine: for each of --seeds request sets (16 prompts of 64-512 ids,
max_new 32-64, drawn from generators seeded 0, 1, ...), the ServeEngine (8
slots, max_len 2048, bf16 KV, quantum 1) answers them on the routes "fused",
"two_call" and "k7_off" (DECODE_ATTN_KERNEL off: the plain attention in K7's
place).

Each run's worst pick gap is measured as ``chip_smoke.py``'s answer gates
measure it: under the teacher-forced plain forward (impl "plain") of prompt +
answer, max over picks of (max logit - picked logit) / max|logit|. Nothing
is held: the script reports.

Prints one JSON object per run and a summary per route; writes the runs to
``chiprun_out/pick_gaps_by_route.jsonl``.

Usage: python scripts/torch_pick_gaps_by_route.py [--model gemma-2b]
       [--model-seed 13] [--seeds 6] [--engine]
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--model", default="gemma-2b")
    ap.add_argument("--model-seed", type=int, default=13)
    ap.add_argument("--seeds", type=int, default=6)
    ap.add_argument("--engine", action="store_true")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        sys.exit("needs a GPU")
    sys.path.insert(0, ROOT)
    import pt2tpu_torch.models.common as tcommon
    import pt2tpu_torch.ops.ternary_matmul as ttm
    from pt2tpu_torch.models import decoder as tdec
    from pt2tpu_torch.models.registry import get_config
    from pt2tpu_torch.ops.kernels import ternary as k1
    from pt2tpu_torch.serve.engine import ServeEngine
    from pt2tpu_torch.serve.generate import greedy_generate
    from pt2tpu_torch.utils.randmodel import random_ternary_params

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip().splitlines()[0]
    print(f"card: {smi}")
    cfg = get_config(args.model)
    params = random_ternary_params(cfg, seed=args.model_seed, perm_mode="down", device=dev)

    @contextlib.contextmanager
    def route(name):
        saved = ttm.FUSED_MLP, ttm.ternary_mlp, tcommon.DECODE_ATTN_KERNEL
        if name == "two_call":
            ttm.FUSED_MLP = False
        elif name == "fused_pv":
            ttm.ternary_mlp = k1.ternary_mlp_plain
        elif name == "k7_off":
            tcommon.DECODE_ATTN_KERNEL = False
        try:
            yield
        finally:
            ttm.FUSED_MLP, ttm.ternary_mlp, tcommon.DECODE_ATTN_KERNEL = saved

    def worst_gap(prompts, toks):
        worst = 0.0
        for p, ids in zip(prompts, toks):
            seq = torch.as_tensor(p + ids[:-1], device=dev)[None]
            with torch.inference_mode():
                lf = tdec.forward(cfg, params, seq, impl="plain")[0, len(p) - 1:].float()
            picked = lf.gather(1, torch.as_tensor(ids, device=dev)[:, None])[:, 0]
            top = lf.abs().max(dim=1).values
            worst = max(worst, ((lf.max(dim=1).values - picked) / top).max().item())
        return worst

    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    out_path = os.path.join(ROOT, "chiprun_out", "pick_gaps_by_route.jsonl")
    names = ("fused", "two_call", "k7_off") if args.engine else ("fused", "fused_pv", "two_call")
    gaps = {name: [] for name in names}

    def answers(seed):
        """(prompts, answers) of one set on the current route."""
        gen = torch.Generator(device=dev).manual_seed(seed)
        if not args.engine:
            prompts = torch.randint(0, cfg.vocab_size, (4, 128), generator=gen, device=dev)
            toks = greedy_generate(cfg, params, prompts, 32)
            return prompts.tolist(), toks.tolist()
        host = torch.Generator().manual_seed(seed)
        lens = torch.randint(64, 513, (16,), generator=host).tolist()
        news = torch.randint(32, 65, (16,), generator=host).tolist()
        prompts = [torch.randint(0, cfg.vocab_size, (n,), generator=gen, device=dev).tolist()
                   for n in lens]
        eng = ServeEngine(cfg, params, max_batch=8, max_len=2048)
        reqs = [eng.submit(p, m) for p, m in zip(prompts, news)]
        eng.run()
        return prompts, [r.out for r in reqs]

    with open(out_path, "a") as f:
        for seed in range(args.seeds):
            streams = {}
            for name in gaps:
                c0 = k1.ternary_mlp.launches
                with route(name):
                    prompts, toks = answers(seed)
                torch.cuda.synchronize()
                k2 = k1.ternary_mlp.launches - c0
                gap = worst_gap(prompts, toks)
                gaps[name].append(gap)
                streams[name] = toks
                rec = {"model": args.model, "engine": args.engine, "seed": seed, "route": name,
                       "worst_pick_gap": gap, "k2_launches": k2, "card": smi}
                if name != "fused":
                    rec["streams_equal_to_fused"] = sum(
                        a == b for a, b in zip(streams[name], streams["fused"]))
                print(json.dumps(rec), flush=True)
                f.write(json.dumps(rec) + "\n")
    for name, v in gaps.items():
        over = sum(x > 2e-2 for x in v)
        path = "engine" if args.engine else "lockstep"
        print(f"{args.model} {path} {name}: worst pick gaps {', '.join(f'{x:.3e}' for x in v)}; "
              f"max {max(v):.3e}; {over} of {len(v)} above 2e-2 on {smi}")


if __name__ == "__main__":
    main()
