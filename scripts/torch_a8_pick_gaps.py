"""Worst pick gaps of the 32-layer W2A8 lockstep route on a GPU, over prompt seeds.

llama-3-8b in the "ssr" layout, random weights made from --model-seed as
``chip_smoke.py`` makes them (seed 4). For each of --seeds prompt sets
(4 x 128 ids from torch.Generator seeds 0, 1, ...) and each routing (the
default flags, and P2: GATHER_KERNEL "packed", IGATHER_FUSED off,
FUSED_GATHER on), the W2A8 route decodes 32 greedy tokens twice: K1's decode
rows on its decode kernel (``csrc/ternary_matmul_dec.cu``) and on the CUDA-core
kernel (``K1_DEC_MAX_ROWS`` = 0). Each run's worst pick gap is measured as
``chip_smoke.py``'s answer gates measure it: under the teacher-forced W2A8
route with every kernel swapped for its plain version, max over picks of
(max logit - picked logit) / max|logit|. Nothing is held: the script reports.

Prints one JSON object per run and a summary; writes the runs to
``chiprun_out/a8_pick_gaps.jsonl``.

Usage: python scripts/torch_a8_pick_gaps.py [--seeds 6] [--model-seed 4]
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
    ap.add_argument("--seeds", type=int, default=6)
    ap.add_argument("--model-seed", type=int, default=4)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        sys.exit("needs a GPU")
    sys.path.insert(0, ROOT)
    import pt2tpu_torch.models.common as tcommon
    import pt2tpu_torch.ops.gather as tgather
    import pt2tpu_torch.ops.ternary_matmul as ttm
    from pt2tpu_torch.models import decoder as tdec
    from pt2tpu_torch.models.registry import get_config
    from pt2tpu_torch.ops.kernels import attention as k7
    from pt2tpu_torch.ops.kernels import gather as k4
    from pt2tpu_torch.ops.kernels import ternary as k1
    from pt2tpu_torch.serve.generate import greedy_generate
    from pt2tpu_torch.utils.randmodel import random_ternary_params

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip().splitlines()[0]
    print(f"card: {smi}")

    def k1_plain(x, p, a, m, bs=128, a8=False):
        return (k1.ternary_matmul_plain_a8 if a8 else k1.ternary_matmul_plain)(x, p, a, m, bs)

    plains = {"ternary_matmul": (ttm, k1_plain),
              "ternary_matmul_igathered": (ttm, k1.ternary_matmul_igathered_plain),
              "ternary_mlp": (ttm, k1.ternary_mlp_plain),
              "onehot_gather": (tgather, k4.onehot_gather_plain),
              "decode_attention": (tcommon, k7.decode_attention_plain),
              "onehot_matmul": (tgather, k4.onehot_matmul_plain),
              "ternary_matmul_gathered": (ttm, k1.ternary_matmul_gathered_plain)}

    @contextlib.contextmanager
    def plain_versions():
        saved = {name: getattr(mod, name) for name, (mod, _) in plains.items()}
        for name, (mod, plain) in plains.items():
            setattr(mod, name, plain)
        try:
            yield
        finally:
            for name, (mod, _) in plains.items():
                setattr(mod, name, saved[name])

    @contextlib.contextmanager
    def routing(flags, dec_on):
        saved = (tgather.GATHER_KERNEL, ttm.IGATHER_FUSED, ttm.FUSED_GATHER, k1.K1_DEC_MAX_ROWS)
        tgather.GATHER_KERNEL, ttm.IGATHER_FUSED, ttm.FUSED_GATHER = flags
        k1.K1_DEC_MAX_ROWS = saved[3] if dec_on else 0
        try:
            yield
        finally:
            tgather.GATHER_KERNEL, ttm.IGATHER_FUSED, ttm.FUSED_GATHER, k1.K1_DEC_MAX_ROWS = saved

    cfg = get_config("llama-3-8b")
    params = random_ternary_params(cfg, seed=args.model_seed, perm_mode="ssr", device=dev)
    default = (tgather.GATHER_KERNEL, ttm.IGATHER_FUSED, ttm.FUSED_GATHER)
    flag_sets = {"default": default, "P2": ("packed", False, True)}
    B, Lp, new = 4, 128, 32

    def worst_gap(prompts, toks):
        worst = 0.0
        for p, ids in zip(prompts.tolist(), toks.tolist()):
            seq = torch.as_tensor(p + ids[:-1], device=dev)[None]
            with torch.inference_mode(), plain_versions():
                lf = tdec.forward(cfg, params, seq, impl="a8")[0, len(p) - 1:].float()
            top = lf.abs().max(dim=1).values
            picked = lf.gather(1, torch.as_tensor(ids, device=dev)[:, None])[:, 0]
            worst = max(worst, ((lf.max(dim=1).values - picked) / top).max().item())
        return worst

    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    rows = []
    for seed in range(args.seeds):
        gen = torch.Generator(device=dev).manual_seed(seed)
        prompts = torch.randint(0, cfg.vocab_size, (B, Lp), generator=gen, device=dev)
        for fname, flags in flag_sets.items():
            for dec_on in (True, False):
                with routing(flags, dec_on):
                    toks = greedy_generate(cfg, params, prompts, new, impl="a8")
                gap = worst_gap(prompts, toks)
                row = {"seed": seed, "flags": fname,
                       "k1_decode_rows": "decode kernel" if dec_on else "CUDA cores",
                       "worst_pick_gap": gap, "card": smi}
                rows.append(row)
                print(json.dumps(row), flush=True)
    with open(os.path.join(ROOT, "chiprun_out", "a8_pick_gaps.jsonl"), "w") as f:
        for row in rows:
            f.write(json.dumps(row) + "\n")
    for fname in flag_sets:
        for route in ("decode kernel", "CUDA cores"):
            gaps = [r["worst_pick_gap"] for r in rows
                    if r["flags"] == fname and r["k1_decode_rows"] == route]
            over = sum(x > 2e-2 for x in gaps)
            print(f"{fname}, K1 decode rows on the {route}: worst pick gaps "
                  f"{', '.join(f'{x:.3e}' for x in gaps)}; {over} of {len(gaps)} above 2e-2")


if __name__ == "__main__":
    main()
