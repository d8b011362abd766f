"""K2's silu instance from this tree's source against another source of it, on a GPU.

Builds ``pt2tpu_torch/csrc/ternary_mlp.cu`` and the source given with --old
(an earlier version of the same file, e.g. from ``git archive`` of the parent
commit) with nvcc for sm_90a and ``-Xptxas -v``, prints the ptxas lines of
each library's silu kernels (registers, spills), holds both against
``ternary_mlp_plain`` (act "silu") at K2's tolerance, then times both C
entries at the llama-3-8b MLP (4096 -> 2 x 14336 -> 4096) without a gather
(the "down" layout) and with one ("ssr"), at 1 and 8 rows, weights rotated
over more than the 50 MB L2, CUDA events over back-to-back launches, in
turns old, new, new, old, ... Either source's C entry may take the
activation code or not (the older one did not).

Prints one JSON object; writes it to ``chiprun_out/k2_silu_ab.json``.

Usage: python scripts/torch_k2_silu_ab.py --old <path to ternary_mlp.cu> [--turns 4]
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
MLP_TOL = 1e-3  # chip_smoke.py's K2 tolerance
COLD_BYTES = 150e6


def build(src: str, name: str):
    """nvcc ``src`` into build/k2_ab/<name>.so; returns (library, ptxas lines
    of its silu kernels, takes_act)."""
    from pt2tpu_torch.ops.kernels import _build

    out_dir = os.path.join(ROOT, "build", "k2_ab")
    os.makedirs(out_dir, exist_ok=True)
    so = os.path.join(out_dir, f"{name}.so")
    cmd = [_build._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
           "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o", so, src]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        sys.exit(f"nvcc failed for {src}:\n{res.stderr}")
    text = open(src).read()
    takes_act = re.search(r"int\s+act\s*,", text) is not None
    lines, fn = [], None
    for line in (res.stdout + res.stderr).splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            fn = m.group(1)
        # the silu instances: ternary_mlp_kernel<TB, GATHER> (no activation
        # code) or ternary_mlp_kernel<TB, GATHER, 0> (mangled ...Lb?ELi0EE)
        silu = fn is not None and "ternary_mlp_kernel" in fn and (
            not takes_act or re.search(r"Lb[01]ELi0EE", fn) is not None)
        if silu and ("registers" in line or "spill" in line):
            lines.append(f"{fn}: {line.strip()}")
    lib = ctypes.CDLL(so)
    fn_ = lib.pt2_ternary_mlp
    fn_.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * (9 if takes_act else 8) + [
        ctypes.c_void_p]
    fn_.restype = ctypes.c_int
    return lib, lines, takes_act


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--old", required=True, help="the other source of ternary_mlp.cu")
    ap.add_argument("--turns", type=int, default=4)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        sys.exit("needs a GPU")
    sys.path.insert(0, ROOT)
    from pt2tpu_torch.core.packing import pack_ternary
    from pt2tpu_torch.ops.kernels import ternary as k1

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip().splitlines()[0]
    print(f"card: {smi}")
    new_src = os.path.join(ROOT, "pt2tpu_torch", "csrc", "ternary_mlp.cu")
    libs = {"old": build(args.old, "old"), "new": build(new_src, "new")}
    for side, (_, lines, takes_act) in libs.items():
        print(f"ptxas {side} ({'takes' if takes_act else 'no'} activation code):")
        for line in lines:
            print("  " + line)

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    D, I, n = 4096, 14336, 4096
    Kd = -(-(I // 128) // 16) * 16 * 128

    def rand_layer(K, cols):
        codes = torch.randint(-1, 2, (cols, K), generator=g, device=dev, dtype=torch.int8)
        alpha = ((0.8 + 0.4 * torch.rand((K // 128, cols), generator=g, device=dev))
                 / math.sqrt(K)).bfloat16()
        mu = (0.02 / math.sqrt(K) * torch.randn((K // 128, cols), generator=g, device=dev)
              ).bfloat16()
        return pack_ternary(codes), alpha, mu

    wbytes = D * 2 * I // 4 + 4 * (D // 128) * 2 * I + Kd * n // 4 + 4 * (Kd // 128) * n
    copies = max(1, math.ceil(COLD_BYTES / wbytes))
    layers = [rand_layer(D, 2 * I) + rand_layer(Kd, n) for _ in range(copies)]
    perm = torch.randperm(D, generator=g, device=dev).to(torch.int32)
    stream = torch.cuda.current_stream().cuda_stream
    dix = dev.index or 0

    def call(side, x, pm, lay, partial, out):
        lib, _, takes_act = libs[side]
        gp, ga, gm, dp, da, dm = lay
        B = x.shape[0]
        extra = (0,) if takes_act else ()
        rc = lib.pt2_ternary_mlp(
            x.data_ptr(), None if pm is None else pm.data_ptr(), gp.data_ptr(), ga.data_ptr(),
            gm.data_ptr(), dp.data_ptr(), da.data_ptr(), dm.data_ptr(), partial.data_ptr(),
            out.data_ptr(), B, D, D, 2 * I, I, Kd, n, *extra, dix, stream)
        if rc:
            sys.exit(f"{side} launch failed: {rc}")

    def time_ms(fn, iters=50):
        for i in range(3):
            fn(i)
        torch.cuda.synchronize()
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        for i in range(iters):
            fn(i)
        e.record()
        torch.cuda.synchronize()
        return s.elapsed_time(e) / iters

    record = {"card": smi, "old": args.old, "ptxas": {k: v[1] for k, v in libs.items()},
              "checks": {}, "us": {}}
    for gather in (False, True):
        pm = perm if gather else None
        for B in (1, 8):
            key = f"{'ssr' if gather else 'down'} B={B}"
            x = torch.randn((B, D), generator=g, device=dev).bfloat16()
            partial = torch.empty((I // 128, B, n), dtype=torch.float32, device=dev)
            out = torch.empty((B, n), dtype=torch.float32, device=dev)
            want = k1.ternary_mlp_plain(x, pm, *layers[0], I)
            for side in libs:
                call(side, x, pm, layers[0], partial, out)
                torch.cuda.synchronize()
                err = (out - want).abs().max().item() / want.abs().max().item()
                if not err <= MLP_TOL:
                    sys.exit(f"{side} {key}: max|err| {err:.3e} of max|ref| > {MLP_TOL}")
                record["checks"][f"{side} {key}"] = err
            times = {"old": [], "new": []}
            order = ["old", "new", "new", "old"] * -(-args.turns // 4)
            for side in order[: args.turns]:
                times[side].append(1e3 * time_ms(
                    lambda i, s=side: call(s, x, pm, layers[i % copies], partial, out)))
            record["us"][key] = times
            print(f"K2 silu {key}: old {' / '.join(f'{t:.1f}' for t in times['old'])} us, "
                  f"new {' / '.join(f'{t:.1f}' for t in times['new'])} us (turns "
                  f"{' '.join(order[:args.turns])}) on {smi}")
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "k2_silu_ab.json"), "w") as f:
        json.dump(record, f, indent=1)
    print(json.dumps(record))


if __name__ == "__main__":
    main()
