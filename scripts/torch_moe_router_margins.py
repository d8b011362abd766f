"""Routing margins of the 2-layer mixtral-8x7b "ssr" W2A8 lockstep on a GPU.

``chip_smoke.py`` phase 23d holds this route's answer (128 ids, 16 new
greedy tokens, ``impl="a8"``) to 5e-2 of max|logit| against its
teacher-forced reference: the W2A8 route with every kernel swapped for its
plain version. Once that answer trailed by 1.145e-1, when earlier draws of
phase 23's generator had moved its prompt. This script asks whether such a
trail is a routing flip. It runs the route and its reference with every
router call recorded, and reports per layer and position whether the two
routes' top-k experts differ, the reference's top-k margin there (its k-th
less its (k+1)-th routing probability), and the answer's worst pick gap.

The model is ``chip_smoke.py``'s (random weights, seed 24). The prompt is
drawn by replaying phase 23's generator (seed 23) as the smoke draws it
before 23d's prompt, and its host generator for the engine's lengths:
``--prompt 23d`` replays the draws of the smoke as it stands, ``--prompt
shared`` also the per-call holds of phase 23a that drew from that generator
before they got their own (the draws of the run whose answer trailed). The
replay follows the smoke's draw order: a change to phases 23a-23c changes
what ``23d`` replays. Nothing is held: the script reports.

Prints the card and one JSON object per prompt; writes them to
``chiprun_out/moe_router_margins.jsonl``.

Usage: python scripts/torch_moe_router_margins.py [--prompt 23d shared]
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# phase 23a's expert shapes held per call (out, in, perm layout), in its order
MOE_SHAPES = [(28672, 4096, "identity"), (4096, 14336, "folded"), (28672, 4096, "ssr"),
              (1536, 2048, "identity"), (2048, 768, "folded")]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--prompt", nargs="+", choices=("23d", "shared"), default=["23d", "shared"])
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
    from pt2tpu_torch.utils.randmodel import random_expert_stack, random_ternary_params

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
              "ternary_matmul_gathered": (ttm, k1.ternary_matmul_gathered_plain),
              "ternary_matmul_idx": (ttm, k1.ternary_matmul_idx_plain),
              "ternary_matmul_igathered_idx": (ttm, k1.ternary_matmul_igathered_idx_plain),
              "ternary_matmul_gathered_idx": (ttm, k1.ternary_matmul_gathered_idx_plain),
              "onehot_gather_idx": (tgather, k4.onehot_gather_idx_plain),
              "onehot_matmul_idx": (tgather, k4.onehot_matmul_idx_plain)}

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

    # the smoke's draws, as its helpers make them
    def rand_layer(K, n, gen):
        torch.randint(-1, 2, (n, K), generator=gen, device=dev, dtype=torch.int8)
        torch.rand((K // 128, n), generator=gen, device=dev)
        torch.randn((K // 128, n), generator=gen, device=dev)

    def rand_perm(m, gen):
        torch.randperm(m, generator=gen, device=dev)

    def replayed_prompt(cfg, shared_holds):
        G = torch.Generator(device=dev).manual_seed(23)
        gh = torch.Generator().manual_seed(23)
        for n_out, n_in, mode in MOE_SHAPES:  # 23a: K1s / K3s per call
            random_expert_stack(G, 2, 4, n_out, n_in, mode, device=dev)
            for _ in range(3):
                torch.randn((1, n_in), generator=G, device=dev)
        if shared_holds:  # 23a's K4s / K5s / K6s and ungated-K2 holds
            for n_out, n_in in ((28672, 4096), (1440, 2048)):
                random_expert_stack(G, 2, 4, n_out, n_in, "ssr", device=dev)
                for B in (1, 4):
                    torch.randn((B, n_in), generator=G, device=dev)
                for _ in range(9):
                    torch.randn((1, n_in), generator=G, device=dev)
            for D, I, n in ((2048, 8192, 2048), (1024, 4096, 1024)):
                rand_layer(D, I, G)
                rand_layer(I, n, G)
                rand_perm(D, G)
                for _ in range(2 * len(k1.MLP_ACTS)):
                    for B in (1, 8, 16, 64, 1, 16):
                        torch.randn((B, D), generator=G, device=dev)
        torch.randn((1, 1, cfg.dim), generator=G, device=dev)  # 23b
        torch.randint(0, cfg.vocab_size, (1, 128), generator=G, device=dev)
        for n in torch.randint(64, 513, (8,), generator=gh).tolist():  # 23c's engine prompts
            torch.randint(0, cfg.vocab_size, (n,), generator=G, device=dev)
        return torch.randint(0, cfg.vocab_size, (1, 128), generator=G, device=dev)

    def pick_gap(lf, ids):
        picked = lf.gather(1, torch.as_tensor(ids, device=dev)[:, None])[:, 0]
        return ((lf.max(dim=1).values - picked) / lf.abs().max(dim=1).values).max().item()

    def router_margins(cfg, params, prompt):
        k, L = cfg.experts_per_token, cfg.n_layers
        logs = []
        orig = tdec.moe_router_weights

        def recorder(cfg_, router, h):
            logs.append(torch.softmax(h.float() @ router.w.t().float(), dim=-1)
                        .reshape(-1, cfg_.n_experts))
            return orig(cfg_, router, h)

        tdec.moe_router_weights = recorder
        try:
            toks = greedy_generate(cfg, params, prompt, 16, impl="a8")
            run_log = list(logs)
            logs.clear()
            full = torch.cat([prompt[0], toks[0, :-1].long()])[None]
            with plain_versions(), torch.inference_mode():
                lf = tdec.forward(cfg, params, full, impl="a8")[0, prompt.shape[1] - 1:]
            ref_log = list(logs)
        finally:
            tdec.moe_router_weights = orig
        res = {"worst_pick_gap": pick_gap(lf.float(), toks[0].tolist()), "layers": []}
        for li in range(L):
            p_run, p_ref = torch.cat(run_log[li::L]), ref_log[li]
            srt, order = p_ref.sort(dim=-1, descending=True, stable=True)
            top_ref = order[:, :k].sort(dim=-1).values
            top_run = p_run.sort(dim=-1, descending=True, stable=True)[1][:, :k].sort(dim=-1).values
            margin = srt[:, k - 1] - srt[:, k]
            pos = torch.nonzero((top_run != top_ref).any(dim=-1)).flatten().tolist()
            res["layers"].append({
                "positions": len(p_ref), "flips": len(pos), "flip_positions": pos,
                "flip_margins": [float(margin[p]) for p in pos],
                "min_margin": float(margin.min()), "min_margin_position": int(margin.argmin()),
                "max_prob_diff": float((p_run - p_ref).abs().max())})
        return res

    cfg = get_config("mixtral-8x7b").with_(n_layers=2)
    params = random_ternary_params(cfg, seed=24, perm_mode="ssr", device=dev)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "moe_router_margins.jsonl"), "w") as f:
        for which in args.prompt:
            rec = {"prompt": which, "card": smi,
                   **router_margins(cfg, params, replayed_prompt(cfg, which == "shared"))}
            print(json.dumps(rec))
            f.write(json.dumps(rec) + "\n")
            torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
