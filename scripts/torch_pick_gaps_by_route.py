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
"two_call" and "k7_off" (DECODE_ATTN_KERNEL and INT8_DECODE_ATTN_KERNEL off:
the plain attention in K7's place).

With --engine --kv-int8 the engine keeps an int8 KV cache and each answer's
reference is the teacher-forced plain forward through an int8 cache, as
``chip_smoke.py``'s int8 gates take it. --scales picks the cache's scales
max|x| / 127, in the engine and the reference alike: "exact",
``kvcache.quantize_i8`` as it is (the correctly rounded quotient,
``utils.device.quotient_f32``: JAX's bytes), or "reciprocal", the division
by the Python scalar 127 (on CUDA a product with the f32 reciprocal of 127,
an ulp off JAX's scale for some vectors). Before any run the script
checks on a witness vector that the scales it set are the ones asked for.
--routes picks routes by name.

Each run's worst pick gap is measured as ``chip_smoke.py``'s answer gates
measure it: under the teacher-forced plain forward (impl "plain") of prompt +
answer, max over picks of (max logit - picked logit) / max|logit|, also
printed in bf16 steps of the largest logit. Nothing is held: the script
reports.

Prints one JSON object per run and a summary per route; writes the runs to
``chiprun_out/pick_gaps_by_route.jsonl``.

Usage: python scripts/torch_pick_gaps_by_route.py [--model gemma-2b]
       [--model-seed 13] [--seeds 6] [--engine [--kv-int8 [--scales reciprocal]]]
       [--routes fused,k7_off]
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
    ap.add_argument("--kv-int8", action="store_true", help="with --engine: an int8 KV cache")
    ap.add_argument("--scales", choices=("exact", "reciprocal"), default="exact")
    ap.add_argument("--routes", default=None, help="comma-separated route names")
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
    from pt2tpu_torch.serve import kvcache as tkv
    from pt2tpu_torch.serve.engine import ServeEngine
    from pt2tpu_torch.serve.generate import greedy_generate
    from pt2tpu_torch.utils.randmodel import random_ternary_params

    if args.scales == "reciprocal":
        def quantize_i8_reciprocal(x):
            x32 = x.float()
            scale = (x32.abs().amax(dim=-1, keepdim=True) / 127.0).clamp_min(1e-8)
            return torch.round(x32 / scale).clamp(-127, 127).to(torch.int8), scale

        tkv.quantize_i8 = quantize_i8_reciprocal  # read by KVCache._put at each write
    # a witness: max|x| 1.048, whose product with fl(1 / 127) is an ulp off
    # the quotient; the scale set above must be the one asked for
    witness = torch.tensor([[1.048, -0.5]], dtype=torch.float32)
    exact_scale = witness[:, :1] / 127.0  # the CPU's division is exact
    got = tkv.quantize_i8(witness.cuda())[1].cpu()
    if torch.equal(got, exact_scale) != (args.scales == "exact"):
        sys.exit(f"--scales {args.scales}: the witness's scale on the card is {got.item()!r}, "
                 f"the exact quotient {exact_scale.item()!r}")

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip().splitlines()[0]
    print(f"card: {smi}")
    cfg = get_config(args.model)
    params = random_ternary_params(cfg, seed=args.model_seed, perm_mode="down", device=dev)

    @contextlib.contextmanager
    def route(name):
        saved = (ttm.FUSED_MLP, ttm.ternary_mlp, tcommon.DECODE_ATTN_KERNEL,
                 tcommon.INT8_DECODE_ATTN_KERNEL)
        if name == "two_call":
            ttm.FUSED_MLP = False
        elif name == "fused_pv":
            ttm.ternary_mlp = k1.ternary_mlp_plain
        elif name == "k7_off":
            tcommon.DECODE_ATTN_KERNEL = tcommon.INT8_DECODE_ATTN_KERNEL = False
        try:
            yield
        finally:
            (ttm.FUSED_MLP, ttm.ternary_mlp, tcommon.DECODE_ATTN_KERNEL,
             tcommon.INT8_DECODE_ATTN_KERNEL) = saved

    def reference(seq):
        """f32 logits of the teacher-forced plain forward (through an int8
        cache with --kv-int8)."""
        with torch.inference_mode():
            if not args.kv_int8:
                return tdec.forward(cfg, params, seq, impl="plain")[0].float()
            T = seq.shape[1]
            cache = tkv.init_cache(cfg, 1, T, quantized=True, device=dev)
            h = tdec.embed_tokens(cfg, params, seq)
            cos, sin, _, _ = tdec.pos_tables(cfg, T, device=dev)
            mask = tcommon.causal_mask(T, T, device=dev)
            for li in range(cfg.n_layers):
                h = tdec.layer_forward(cfg, tdec.layer_view(params["layers"], li), h, cos, sin,
                                       mask, cache=cache, cache_pos=0, impl="plain", layer_idx=li)
            return tdec.unembed(cfg, params, h)[0].float()

    def worst_gap(prompts, toks):
        """(worst gap over max|logit|, the same in bf16 steps of max|logit|)."""
        worst, steps = 0.0, 0.0
        for p, ids in zip(prompts, toks):
            seq = torch.as_tensor(p + ids[:-1], device=dev)[None]
            lf = reference(seq)[len(p) - 1:]
            picked = lf.gather(1, torch.as_tensor(ids, device=dev)[:, None])[:, 0]
            top = lf.abs().max(dim=1).values
            gap = (lf.max(dim=1).values - picked) / top
            i = int(gap.argmax())
            if gap[i].item() > worst:
                ulp = 2.0 ** (torch.floor(torch.log2(top[i])).item() - 7)  # bf16 step at max|logit|
                worst, steps = gap[i].item(), (gap[i] * top[i]).item() / ulp
        return worst, steps

    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    out_path = os.path.join(ROOT, "chiprun_out", "pick_gaps_by_route.jsonl")
    names = ("fused", "two_call", "k7_off") if args.engine else ("fused", "fused_pv", "two_call")
    if args.routes:
        names = tuple(args.routes.split(","))
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
        eng = ServeEngine(cfg, params, max_batch=8, max_len=2048, kv_quant=args.kv_int8)
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
                gap, steps = worst_gap(prompts, toks)
                gaps[name].append(gap)
                streams[name] = toks
                rec = {"model": args.model, "engine": args.engine, "kv_int8": args.kv_int8,
                       "scales": args.scales, "seed": seed, "route": name, "worst_pick_gap": gap,
                       "worst_pick_gap_bf16_steps": steps, "k2_launches": k2, "card": smi}
                if name != "fused" and "fused" in streams:
                    rec["streams_equal_to_fused"] = sum(
                        a == b for a, b in zip(streams[name], streams["fused"]))
                print(json.dumps(rec), flush=True)
                f.write(json.dumps(rec) + "\n")
    for name, v in gaps.items():
        over = sum(x > 2e-2 for x in v)
        path = ("engine" + (f" int8 KV, {args.scales} scales" if args.kv_int8 else "")
                if args.engine else "lockstep")
        print(f"{args.model} {path} {name}: worst pick gaps {', '.join(f'{x:.3e}' for x in v)}; "
              f"max {max(v):.3e}; {over} of {len(v)} above 2e-2 on {smi}")


if __name__ == "__main__":
    main()
