"""The plane gather of K6's decode and tensor-core paths from this tree against other versions of it, on a GPU.

Builds ``pt2tpu_torch/csrc/planes_gather.cuh`` and each header given with
--old (an earlier or edited copy of it) into libraries of their own (a
one-line source that includes the header, nvcc for sm_90a with ``-Xptxas
-v``), prints the ptxas lines of each library's gather instances, holds each
C entry ``pt2_planes_gather`` bit for bit against ``planes_gather_plain``
(lane order at 1 / 4 / 8 rows, K3's fragment order with the block sums at 16
/ 32 / 64 rows, bf16 and W2A8; --no-check skips this for probes that are
wrong on purpose), then times them at llama-3-8b's 4096 -> 4096 planes, the
planes rotated over more than the 50 MB L2, in turns (the olds then this
tree's, then the reverse, ...): CUDA events over back-to-back launches of
the C entry, and the device time per launch under torch.profiler (the
events over ~µs launches measure the host's launch rate as much as the
kernel). --rows limits the row counts (a header without clusters must not
run fragment order, whose cluster barrier and distributed shared memory it
would lack).

Prints one JSON object; writes it to ``chiprun_out/k6_gather_ab.json``
(``--out`` names another file there).

Usage: python scripts/torch_k6_gather_ab.py --old <planes_gather.cuh> [--old ...]
           [--turns 4] [--rows 1,4,8] [--no-check] [--out k6_gather_ab.json]
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
COLD_BYTES = 150e6
ROWS = (1, 4, 8, 16, 32, 64)  # lane order up to 8 rows, fragment order from 16


def build(header: str, tag: str):
    """A library holding ``header``'s C entry; returns (library, ptxas lines
    of its gather instances)."""
    from pt2tpu_torch.ops.kernels import _build

    out_dir = os.path.join(ROOT, "build", "k6_gather_ab")
    os.makedirs(out_dir, exist_ok=True)
    src = os.path.join(out_dir, f"{tag}.cu")
    with open(src, "w") as f:
        f.write(f'#include "{os.path.abspath(header)}"\n')
    so = os.path.join(out_dir, f"{tag}.so")
    cmd = [_build._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
           "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o", so, src]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        sys.exit(f"nvcc failed for {header}:\n{res.stderr}")
    lines, entry = [], None
    for line in (res.stdout + res.stderr).splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            entry = m.group(1)
        elif entry and "planes_gather_kernel" in entry and ("registers" in line or "spill" in line):
            lines.append(f"{entry[-40:]}: {line.strip()}")
    lib = ctypes.CDLL(so)
    fn = lib.pt2_planes_gather
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib, lines


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--old", action="append", required=True, help="another planes_gather.cuh")
    ap.add_argument("--turns", type=int, default=4, help="timing turns, in alternating order")
    ap.add_argument("--rows", default=",".join(map(str, ROWS)), help="row counts to time")
    ap.add_argument("--no-check", action="store_true", help="skip the bit-for-bit check")
    ap.add_argument("--out", default="k6_gather_ab.json", help="file name under chiprun_out/")
    args = ap.parse_args()

    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        sys.exit("needs a CUDA GPU")
    sys.path.insert(0, ROOT)
    from pt2tpu_torch.ops.gather import make_packed_gather
    from pt2tpu_torch.ops.kernels import ternary as tk

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    libs = {}
    headers = [(f"old{j}", h) for j, h in enumerate(args.old)]
    headers.append(("new", os.path.join(ROOT, "pt2tpu_torch", "csrc", "planes_gather.cuh")))
    for tag, header in headers:
        libs[tag], lines = build(header, tag)
        for line in lines:
            print(f"ptxas {tag}: {line}")
    dev = torch.device("cuda")
    dix = dev.index or 0
    stream = torch.cuda.current_stream().cuda_stream
    g = torch.Generator(device=dev).manual_seed(15)
    m = K = 4096
    copies = max(2, math.ceil(COLD_BYTES / (m * K // 4)))
    planes = [make_packed_gather(torch.randperm(m, generator=g, device=dev).to(torch.int32),
                                 m).packed for _ in range(copies)]
    D4 = planes[0].shape[0]
    ev = lambda: torch.cuda.Event(enable_timing=True)  # noqa: E731
    record = {"smi": smi, "headers": dict(headers), "rows": []}
    for B in (int(r) for r in args.rows.split(",")):
        frag = B > 8
        rows_out = tk.igtc_rows_pad(B) if frag else B
        x = torch.randn((B, m), generator=g, device=dev).bfloat16()
        xg = torch.empty((rows_out, K), dtype=torch.bfloat16, device=dev)
        S = torch.empty((K // 128, rows_out), dtype=torch.float32, device=dev)

        def launch(lib, i, xk=x, a8=False):
            rc = lib.pt2_planes_gather(xk.data_ptr(), planes[i % copies].data_ptr(), xg.data_ptr(),
                                       S.data_ptr(), B, rows_out, m, D4, K, int(frag), int(a8),
                                       dix, stream)
            if rc:
                sys.exit(f"pt2_planes_gather failed: {rc}")

        for a8 in (() if args.no_check else (False, True)):  # bit for bit, every library
            xk = tk.normalize_rows_a8(x)[0].contiguous() if a8 else x
            want = tk.planes_gather_plain(xk, planes[1], 128, a8, "fragments" if frag else "lanes")
            for tag, lib in libs.items():
                xg.fill_(float("nan"))
                S.fill_(float("nan"))
                launch(lib, 1, xk, a8)
                torch.cuda.synchronize()
                same = (torch.equal(xg, want[0]) and torch.equal(S, want[1]) if frag
                        else torch.equal(xg, want))
                if not same:
                    sys.exit(f"{tag}: the gather at {B} rows a8={a8} differs from "
                             f"planes_gather_plain")
        turns = {tag: [] for tag in libs}
        for t in range(args.turns):
            for tag in (list(libs) if t % 2 == 0 else list(libs)[::-1]):
                lib = libs[tag]
                for i in range(5):
                    launch(lib, i)
                torch.cuda.synchronize()
                s, e = ev(), ev()
                s.record()
                for i in range(200):
                    launch(lib, i)
                e.record()
                torch.cuda.synchronize()
                events_us = s.elapsed_time(e) / 200 * 1e3
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    for i in range(50):
                        launch(lib, i)
                    torch.cuda.synchronize()
                hit = [ev_ for ev_ in prof.key_averages() if "planes_gather_kernel" in ev_.key]
                dt = sum(getattr(h, "self_device_time_total", 0) or getattr(h, "self_cuda_time_total", 0)
                         for h in hit)
                count = sum(h.count for h in hit)
                turns[tag].append({"events_us": events_us, "device_us": dt / max(1, count)})
        nbytes = D4 * K + 2 * B * m + 2 * rows_out * K + (4 * rows_out * K // 128 if frag else 0)
        row = {"B": B, "order": "fragments" if frag else "lanes", "bytes": nbytes,
               "bound_us": nbytes / 3.35e12 * 1e6, "turns": turns}
        record["rows"].append(row)
        each = lambda key: " | ".join(  # noqa: E731
            f"{tag} " + " / ".join(f"{t[key]:.2f}" for t in turns[tag]) for tag in turns)
        print(f"plane gather, {B:2d} rows ({row['order']}): device us {each('device_us')}; CUDA "
              f"events us {each('events_us')}; bytes bound {row['bound_us']:.2f} us on {smi}")
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", args.out), "w") as f:
        json.dump(record, f, indent=1)
    print(json.dumps(record))


if __name__ == "__main__":
    main()
