"""K4's rows path under each plan its C entry takes, on a GPU: the A/B that
chose the default plan of ``pt2tpu_torch/csrc/onehot_gather_rows.cu``.

At llama-3-8b's 4096 -> 4096 bf16 gather and each row count of --rows, the
plans (``pt2_onehot_gather_rows_plan``: rows per stage R, chunk CTAs gx; one
CTA row per stage) are
  * "R<r>": each CTA loops over every 2048-lane chunk, so each row of x
    crosses L2 once;
  * "R<r>-split": the chunks split over CTAs (x read from L2 once per
    chunk);
copies overlapping gathers across the CTAs resident on an SM; beside the
default entry (``pt2_onehot_gather_rows``), K4's first kernel
and ``torch.index_select``. Each plan is first held bit for bit against
``onehot_gather_plain``; then each is timed as calls replayed from a CUDA
graph (operands rotated over more than the 50 MB L2; the card's time per
call, launch gaps included), in turns, the order reversed every other turn.
The ptxas lines of the rows kernel's instances are printed from the build
log.

Prints one JSON object; writes it to ``chiprun_out/k4_rows_ab.json``.

Usage: python scripts/torch_k4_rows_ab.py [--turns 4] [--rows 16,64,128,256,512]
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COLD_BYTES = 150e6
ROWS = (16, 64, 128, 256, 512)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--turns", type=int, default=4, help="timing turns, in alternating order")
    ap.add_argument("--rows", default=",".join(map(str, ROWS)), help="row counts to time")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        sys.exit("needs a CUDA GPU")
    sys.path.insert(0, ROOT)
    from pt2tpu_torch.ops.kernels import _build
    from pt2tpu_torch.ops.kernels import gather as k4

    dev = torch.device("cuda")
    dix = dev.index or 0
    rows_lib, old_lib = k4._gather_rows_kernel_lib(), k4._kernel_lib()
    with open(_build.build("onehot_gather_rows") + ".log") as f:
        ptxas = [ln.strip() for ln in f if "registers" in ln or "spill" in ln]
    smi = os.popen("nvidia-smi --query-gpu=name,power.limit --format=csv,noheader").read().strip()
    print(f"card: {smi}")
    for ln in ptxas:
        print("  ptxas", ln)
    cur = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731 (a capture's own)

    def graph_ms(fn, calls):
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for i in range(calls):
                fn(i)
        graph.replay()
        torch.cuda.synchronize()
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        for _ in range(4):
            graph.replay()
        e.record()
        torch.cuda.synchronize()
        return s.elapsed_time(e) / (4 * calls)

    g = torch.Generator(device=dev).manual_seed(0)
    m = K = 4096
    nch = -(-K // 2048)
    perms = [torch.randperm(m, generator=g, device=dev).to(torch.int32) for _ in range(4)]
    lperm = [p.long() for p in perms]
    record = {"card": smi, "ptxas": ptxas, "rows": {}}
    for B in [int(r) for r in args.rows.split(",")]:
        plans = {}
        for R in (1, 2, 4):
            plans[f"R{R}"] = (R, 1)
            plans[f"R{R}-split"] = (R, nch)
        per_call = 2 * B * m + 4 * K + 2 * B * K
        copies = max(4, math.ceil(COLD_BYTES / per_call))
        calls = max(50, copies)
        xs = [torch.randn((B, m), generator=g, device=dev).bfloat16() for _ in range(copies)]
        outs = [torch.empty((B, K), dtype=torch.bfloat16, device=dev) for _ in range(copies)]

        def ok(rc, what):
            if rc:
                sys.exit(f"{what} at {B} rows: launch failed ({rc})")

        def planned(plan):
            def kern(i):
                c = i % copies
                ok(rows_lib.pt2_onehot_gather_rows_plan(
                    xs[c].data_ptr(), perms[i % 4].data_ptr(), outs[c].data_ptr(), B, m, K, 2,
                    *plan, dix, cur()), f"plan {plan}")
            return kern

        def default(i):
            c = i % copies
            ok(rows_lib.pt2_onehot_gather_rows(xs[c].data_ptr(), perms[i % 4].data_ptr(),
                                               outs[c].data_ptr(), B, m, K, 2, dix, cur()),
               "default plan")

        def first(i):
            c = i % copies
            ok(old_lib.pt2_onehot_gather(xs[c].data_ptr(), perms[i % 4].data_ptr(),
                                         outs[c].data_ptr(), B, m, K, 2, dix, cur()),
               "first kernel")

        kerns = {name: planned(p) for name, p in plans.items()}
        kerns["default"] = default
        kerns["first kernel"] = first
        kerns["index_select"] = lambda i: torch.index_select(xs[i % copies], 1, lperm[i % 4])
        want = k4.onehot_gather_plain(xs[0], perms[0])
        for name, fn in kerns.items():  # bits, and every library built / attribute set
            if name == "index_select":
                continue
            outs[0].fill_(float("nan"))
            fn(0)
            torch.cuda.synchronize()
            if not torch.equal(outs[0], want):
                sys.exit(f"{name} at {B} rows: not bit-exact to onehot_gather_plain")
        times = {name: [] for name in kerns}
        names = list(kerns)
        for t in range(args.turns):
            for name in (names if t % 2 == 0 else names[::-1]):
                times[name].append(graph_ms(kerns[name], calls))
        bound_us = per_call / 3.35e12 * 1e6
        best = {name: min(v) * 1e3 for name, v in times.items()}
        record["rows"][B] = {"plans": plans, "us": {n: [x * 1e3 for x in v] for n, v in times.items()},
                             "best_us": best, "bound_us": bound_us}
        print(f"{B} rows (bound {bound_us:.2f} us; best of {args.turns} turns, us a call from a "
              f"CUDA graph, {calls} calls over {copies} operand copies):")
        for name, us in sorted(best.items(), key=lambda kv: kv[1]):
            print(f"  {name:14s} {us:7.2f}  {plans.get(name, '')}  turns "
                  + " / ".join(f"{x * 1e3:.2f}" for x in times[name]))
        del xs, outs
        torch.cuda.empty_cache()
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "k4_rows_ab.json"), "w") as f:
        json.dump(record, f, indent=1)
    print(json.dumps({"best_us": {B: r["best_us"] for B, r in record["rows"].items()}}))


if __name__ == "__main__":
    main()
