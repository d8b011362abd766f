"""K5's rows path from this tree against other versions of it, on a GPU.

Builds ``pt2tpu_torch/csrc/onehot_matmul_rows.cu`` and each source given
with --old (an earlier or edited copy of it; ``#include "planes_gather.cuh"``
resolves to this tree's header) into libraries of their own (nvcc for
sm_90a with ``-Xptxas -v``), prints the ptxas lines of each library's
lane-map and rows kernels, holds each C entry ``pt2_onehot_matmul_rows``
bit for bit against ``onehot_matmul_rows_plain`` (rows 65 and 512, m 4096
and 300, bf16 and f32; --no-check skips this for probes that are wrong on
purpose), then times them at llama-3-8b's 4096 -> 4096 gather in bf16, the
planes and x rotated over more than the 50 MB L2, in turns (the olds then
this tree's, then the reverse, ...): CUDA events over back-to-back launches
of the C entry (both launches; at a few µs a call this measures the host's
launch rate as much as the card), the same calls replayed from a CUDA graph
(the card's time per call, launch gaps included), and the device time per
launch of each of its two kernels under torch.profiler (a kernel launched
as a programmatic dependant counts from its early start).

Prints one JSON object; writes it to ``chiprun_out/k5_rows_ab.json``
(``--out`` names another file there).

Usage: python scripts/torch_k5_rows_ab.py --old <onehot_matmul_rows.cu> [--old ...]
           [--turns 4] [--rows 16,64,128,256,512] [--no-check] [--out k5_rows_ab.json]
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(ROOT, "pt2tpu_torch", "csrc")
COLD_BYTES = 150e6
ROWS = (16, 64, 128, 256, 512)


def build(src: str, tag: str):
    """A library built from ``src``; returns (library, ptxas lines of its
    K5 kernels)."""
    from pt2tpu_torch.ops.kernels import _build

    out_dir = os.path.join(ROOT, "build", "k5_rows_ab")
    os.makedirs(out_dir, exist_ok=True)
    so = os.path.join(out_dir, f"{tag}.so")
    cmd = [_build._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
           "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-I", CSRC, "-o", so,
           os.path.abspath(src)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        sys.exit(f"nvcc failed for {src}:\n{res.stderr}")
    lines, entry = [], None
    for line in (res.stdout + res.stderr).splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            entry = m.group(1)
        elif entry and "onehot_rows" in entry and ("registers" in line or "spill" in line):
            lines.append(f"{entry[-48:]}: {line.strip()}")
    lib = ctypes.CDLL(so)
    fn = lib.pt2_onehot_matmul_rows
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib, lines


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--old", action="append", required=True, help="another onehot_matmul_rows.cu")
    ap.add_argument("--turns", type=int, default=4, help="timing turns, in alternating order")
    ap.add_argument("--rows", default=",".join(map(str, ROWS)), help="row counts to time")
    ap.add_argument("--no-check", action="store_true", help="skip the bit-for-bit check")
    ap.add_argument("--out", default="k5_rows_ab.json", help="file name under chiprun_out/")
    args = ap.parse_args()

    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        sys.exit("needs a CUDA GPU")
    sys.path.insert(0, ROOT)
    from pt2tpu_torch.ops.gather import make_packed_gather
    from pt2tpu_torch.ops.kernels import gather as tkg

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    libs = {}
    sources = [(f"old{j}", s) for j, s in enumerate(args.old)]
    sources.append(("new", os.path.join(CSRC, "onehot_matmul_rows.cu")))
    for tag, src in sources:
        libs[tag], lines = build(src, tag)
        for line in lines:
            print(f"ptxas {tag}: {line}")
    dev = torch.device("cuda")
    dix = dev.index or 0
    g = torch.Generator(device=dev).manual_seed(16)
    lmap = torch.empty((1 + tkg.K5_MAP_FIELDS) * 4096, dtype=torch.int32, device=dev)

    def launch(lib, x, gp, out):
        """One call of a library's C entry; returns its CUDA error (0: launched)."""
        return lib.pt2_onehot_matmul_rows(x.data_ptr(), gp.data_ptr(), lmap.data_ptr(),
                                          out.data_ptr(), x.shape[0], x.shape[1], gp.shape[0],
                                          gp.shape[1], x.element_size(), dix,
                                          torch.cuda.current_stream().cuda_stream)

    refused = {}  # a library that fails a launch or a check is reported and not timed

    for m, K in (() if args.no_check else ((4096, 4096), (300, 512))):  # every library
        perm = torch.cat([torch.randperm(m, generator=g, device=dev),
                          torch.full((K - m,), m, device=dev)])
        perm = perm[torch.randperm(K, generator=g, device=dev)].to(torch.int32)
        gp = make_packed_gather(perm, m).packed
        for B in (65, 512):
            for dt in (torch.bfloat16, torch.float32):
                x = torch.randn((B, m), generator=g, device=dev).to(dt)
                want = tkg.onehot_matmul_rows_plain(x, gp)
                for tag, lib in libs.items():
                    if tag in refused:
                        continue
                    out = torch.full((B, K), float("nan"), dtype=dt, device=dev)
                    rc = launch(lib, x, gp, out)
                    torch.cuda.synchronize()
                    if rc or not torch.equal(out, want):
                        refused[tag] = (f"m={m} K={K} rows={B} {dt}: " + (
                            f"launch failed, cudaError {rc}" if rc else
                            "differs from onehot_matmul_rows_plain"))
                        print(f"{tag} refused: {refused[tag]}")
    for tag in refused:
        del libs[tag]
    m = K = 4096
    ev = lambda: torch.cuda.Event(enable_timing=True)  # noqa: E731
    record = {"smi": smi, "sources": dict(sources), "refused": refused, "rows": []}
    for B in (int(r) for r in args.rows.split(",")):
        per_call = m * K // 4 + 2 * B * m + 2 * B * K
        copies = max(4, math.ceil(COLD_BYTES / per_call))
        gps = [make_packed_gather(torch.randperm(m, generator=g, device=dev).to(torch.int32),
                                  m).packed for _ in range(copies)]
        xs = [torch.randn((B, m), generator=g, device=dev).bfloat16() for _ in range(copies)]
        outs = [torch.empty((B, K), dtype=torch.bfloat16, device=dev) for _ in range(copies)]
        turns = {tag: [] for tag in libs}
        for t in range(args.turns):
            for tag in (list(libs) if t % 2 == 0 else list(libs)[::-1]):
                lib = libs[tag]

                def run(n, lib=lib, tag=tag):
                    for i in range(n):
                        if launch(lib, xs[i % copies], gps[i % copies], outs[i % copies]):
                            sys.exit(f"{tag}: launch failed at {B} rows")

                run(5)
                torch.cuda.synchronize()
                s, e = ev(), ev()
                s.record()
                run(100)
                e.record()
                torch.cuda.synchronize()
                events_us = s.elapsed_time(e) / 100 * 1e3
                # the same calls replayed from a CUDA graph: no host time between them
                graph = torch.cuda.CUDAGraph()
                with torch.cuda.graph(graph):
                    run(50)
                graph.replay()
                torch.cuda.synchronize()
                s.record()
                for _ in range(4):
                    graph.replay()
                e.record()
                torch.cuda.synchronize()
                graph_us = s.elapsed_time(e) / 200 * 1e3
                del graph
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    run(40)
                    torch.cuda.synchronize()
                dev_us = {}
                for key in ("lane_map_kernel", "rows_kernel"):
                    hit = [h for h in prof.key_averages() if f"onehot_rows::{key}" in h.key]
                    dt = sum(getattr(h, "self_device_time_total", 0)
                             or getattr(h, "self_cuda_time_total", 0) for h in hit)
                    dev_us[key] = dt / max(1, sum(h.count for h in hit))
                turns[tag].append({"events_us": events_us, "graph_us": graph_us,
                                   "lane_map_device_us":
                                   dev_us["lane_map_kernel"],
                                   "rows_device_us": dev_us["rows_kernel"]})
        row = {"B": B, "bytes": per_call, "bound_us": per_call / 3.35e12 * 1e6, "turns": turns}
        record["rows"].append(row)
        each = lambda key: " | ".join(  # noqa: E731
            f"{tag} " + " / ".join(f"{t[key]:.2f}" for t in turns[tag]) for tag in turns)
        print(f"K5 rows path, {B:3d} rows: CUDA events us {each('events_us')}; from a CUDA "
              f"graph us {each('graph_us')}; device us: lane "
              f"map {each('lane_map_device_us')}; rows {each('rows_device_us')}; bytes bound "
              f"{row['bound_us']:.2f} us on {smi}")
        del gps, xs, outs
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", args.out), "w") as f:
        json.dump(record, f, indent=1)
    print(json.dumps(record))


if __name__ == "__main__":
    main()
