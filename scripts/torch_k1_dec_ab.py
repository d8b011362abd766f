"""K1's decode-kernel instances from this tree's source against another source of them, on a GPU.

Builds ``pt2tpu_torch/csrc/ternary_matmul_dec.cu`` and the source given with
--old (an earlier version of the same file, e.g. from ``git archive`` of the
parent commit) with nvcc for sm_90a and ``-Xptxas -v``, prints the ptxas lines
of each library's K1 instances (registers, spills; in a source that also
holds K3's gather instances, those are printed apart), compares the two
libraries' K1 instances instruction by instruction (cuobjdump -sass, with
addresses, encodings and constant-bank operands masked; then with register
numbers masked too; then as a multiset of opcodes), holds both C entries
``pt2_ternary_matmul_dec`` against ``ternary_matmul_plain`` (bf16) and
``ternary_matmul_plain_a8`` (W2A8 on the normalised rows) at K1's tolerance,
then times both at the four llama-2-7b projections (qkv 4096 -> 12288, o,
gateup 4096 -> 22528, down 12288 -> 4096) at 1 and 8 rows, bf16, weights
rotated over more than the 50 MB L2, CUDA events over back-to-back launches,
in turns old, new, new, old, ... Where both sources hold K3's decode rows
(C entry ``pt2_ternary_matmul_dec_igathered``), the same for them against
``ternary_matmul_igathered_plain`` at llama-3-8b qkv (4096 -> 6144) and o
(4096 -> 4096) through a random perm, at 1 and 8 rows (a probe of K3's
gather staging: --old names an edited copy of this tree's source).

Prints one JSON object; writes it to ``chiprun_out/k1_dec_ab.json``.

Usage: python scripts/torch_k1_dec_ab.py --old <path to ternary_matmul_dec.cu> [--turns 4]
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
KERNEL_TOL = 1e-4  # chip_smoke.py's K1 tolerance
COLD_BYTES = 150e6
SHAPES = [("qkv", 4096, 12288), ("o", 4096, 4096), ("gateup", 4096, 22528),
          ("down", 12288, 4096)]
K3_SHAPES = [("8b qkv", 4096, 6144), ("8b o", 4096, 4096)]


def build(src: str, name: str):
    """nvcc ``src`` into build/k1_dec_ab/<name>.so; returns (library, ptxas
    lines of its K1 instances, ptxas lines of its K3 gather instances; the
    library's K3 entry is bound where it has one)."""
    from pt2tpu_torch.ops.kernels import _build

    out_dir = os.path.join(ROOT, "build", "k1_dec_ab")
    os.makedirs(out_dir, exist_ok=True)
    so = os.path.join(out_dir, f"{name}.so")
    cmd = [_build._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
           "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o", so, src]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        sys.exit(f"nvcc failed for {src}:\n{res.stderr}")
    k1_lines, k3_lines, fn = [], [], None
    for line in (res.stdout + res.stderr).splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            fn = m.group(1)
        if fn is None or "ternary_matmul_dec_kernel" not in fn:
            continue
        if "registers" in line or "spill" in line:
            # ternary_matmul_dec_kernel<A8> (ILb?EE) or <A8, GATHER> (ILb?ELb?EE)
            gather = re.search(r"ILb[01]ELb1EE", fn) is not None
            (k3_lines if gather else k1_lines).append(f"{fn}: {line.strip()}")
    lib = ctypes.CDLL(so)
    fn_ = lib.pt2_ternary_matmul_dec
    fn_.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    fn_.restype = ctypes.c_int
    if hasattr(lib, "pt2_ternary_matmul_dec_igathered"):
        fn_ = lib.pt2_ternary_matmul_dec_igathered
        fn_.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
        fn_.restype = ctypes.c_int
    return lib, k1_lines, k3_lines


def k1_sass(so: str):
    """The SASS of the library's K1 instances (A8 false and true, GATHER
    false), one list of instructions each, with addresses, encodings and
    constant-bank operands (the kernel's parameter offsets) masked; None
    where cuobjdump is missing."""
    from pt2tpu_torch.ops.kernels import _build

    tool = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    if not os.path.exists(tool):
        return None
    text = subprocess.run([tool, "-sass", so], capture_output=True, text=True).stdout
    funcs, cur = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1)
            inst = re.search(r"ternary_matmul_dec_kernelIL(b[01])E(Lb0E)?E", fn)
            cur = funcs.setdefault(inst.group(1), []) if inst else None
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s*(.*?);", line)
        if cur is not None and m:
            cur.append(re.sub(r"c\[0x[0-9a-f]+\]\[0x[0-9a-f]+\]", "c[.][.]", m.group(1)))
    return funcs


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--old", required=True, help="the other source of ternary_matmul_dec.cu")
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
    new_src = os.path.join(ROOT, "pt2tpu_torch", "csrc", "ternary_matmul_dec.cu")
    libs = {"old": build(args.old, "old"), "new": build(new_src, "new")}
    for side, (_, k1_lines, k3_lines) in libs.items():
        print(f"ptxas {side}, K1 instances:")
        for line in k1_lines:
            print("  " + line)
        if k3_lines:
            print(f"ptxas {side}, K3 gather instances:")
            for line in k3_lines:
                print("  " + line)

    sass = {side: k1_sass(os.path.join(ROOT, "build", "k1_dec_ab", f"{side}.so")) for side in libs}
    same_sass = {}
    if all(v is not None for v in sass.values()):
        regs = lambda ins: [re.sub(r"\bU?[RP]\d+\b", "R", i) for i in ins]  # noqa: E731
        differ = lambda a, b: sum(x != y for x, y in zip(a, b)) + abs(len(a) - len(b))  # noqa: E731
        for inst in ("b0", "b1"):
            a, b = sass["old"].get(inst, []), sass["new"].get(inst, [])
            opcode = lambda i: next(t for t in i.split() if not t.startswith("@"))  # noqa: E731
            ops = sorted(map(opcode, a)) == sorted(map(opcode, b))
            same_sass[f"A8={inst[1]}"] = {"old": len(a), "new": len(b), "differ": differ(a, b),
                                          "differ_registers_masked": differ(regs(a), regs(b)),
                                          "same_opcodes": ops}
            print(f"SASS of K1's A8={inst[1]} instance: old {len(a)} / new {len(b)} "
                  f"instructions, {differ(a, b)} differ (constant-bank operands masked), "
                  f"{differ(regs(a), regs(b))} with register numbers masked too; the same "
                  f"opcodes: {ops}")

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    dix = dev.index or 0
    counters = torch.zeros(1024, dtype=torch.int32, device=dev)
    wave = k1.dec_wave(dev)

    def rand_layer(K, n):
        codes = torch.randint(-1, 2, (n, K), generator=g, device=dev, dtype=torch.int8)
        alpha = ((0.8 + 0.4 * torch.rand((K // 128, n), generator=g, device=dev))
                 / math.sqrt(K)).bfloat16()
        mu = (0.02 / math.sqrt(K) * torch.randn((K // 128, n), generator=g, device=dev)
              ).bfloat16()
        return pack_ternary(codes), alpha, mu

    def call(side, x, lay, partial, out, splits, a8=0):
        p, a, m = lay
        B, K = x.shape
        rc = libs[side][0].pt2_ternary_matmul_dec(
            x.data_ptr(), p.data_ptr(), a.data_ptr(), m.data_ptr(), partial.data_ptr(),
            out.data_ptr(), counters.data_ptr(), B, K, p.shape[1], 128, splits, a8, dix, stream)
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

    record = {"card": smi, "old": args.old,
              "ptxas": {k: {"k1": v[1], "k3": v[2]} for k, v in libs.items()},
              "sass": same_sass, "checks": {}, "us": {}}
    order = (["old", "new", "new", "old"] * -(-args.turns // 4))[: args.turns]
    for name, K, n in SHAPES:
        copies = max(1, math.ceil(COLD_BYTES / (K * n // 4 + 4 * (K // 128) * n)))
        layers = [rand_layer(K, n) for _ in range(copies)]
        splits = k1.dec_splits(K, n, 128, wave)
        for B in (1, 8):
            key = f"{name} B={B}"
            x = torch.randn((B, K), generator=g, device=dev).bfloat16()
            xn, sx = k1.normalize_rows_a8(x)
            partial = torch.empty((splits, B, n), dtype=torch.float32, device=dev)
            out = torch.empty((B, n), dtype=torch.float32, device=dev)
            for a8 in (0, 1):
                want = (k1.ternary_matmul_plain_a8 if a8 else k1.ternary_matmul_plain)(
                    x, *layers[0])
                for side in libs:
                    call(side, xn if a8 else x, layers[0], partial, out, splits, a8)
                    torch.cuda.synchronize()
                    got = out * sx if a8 else out
                    err = (got - want).abs().max().item() / want.abs().max().item()
                    if not err <= KERNEL_TOL:
                        sys.exit(f"{side} {key} a8={a8}: max|err| {err:.3e} of max|ref| > "
                                 f"{KERNEL_TOL}")
                    record["checks"][f"{side} {key} a8={a8}"] = err
            times = {"old": [], "new": []}
            for side in order:
                times[side].append(1e3 * time_ms(
                    lambda i, s=side: call(s, x, layers[i % copies], partial, out, splits)))
            record["us"][key] = times
            print(f"K1 decode {key}: old {' / '.join(f'{t:.1f}' for t in times['old'])} us, "
                  f"new {' / '.join(f'{t:.1f}' for t in times['new'])} us (turns "
                  f"{' '.join(order)}) on {smi}")
        del layers
    if all(hasattr(v[0], "pt2_ternary_matmul_dec_igathered") for v in libs.values()):
        for name, K, n in K3_SHAPES:
            copies = max(1, math.ceil(COLD_BYTES / (K * n // 4 + 4 * (K // 128) * n)))
            layers = [rand_layer(K, n) for _ in range(copies)]
            perm = torch.randperm(K, generator=g, device=dev).to(torch.int32)
            splits = k1.dec_splits(K, n, 128, wave)
            for B in (1, 8):
                key = f"K3 {name} B={B}"
                x = torch.randn((B, K), generator=g, device=dev).bfloat16()
                partial = torch.empty((splits, B, n), dtype=torch.float32, device=dev)
                out = torch.empty((B, n), dtype=torch.float32, device=dev)

                def call_k3(side, lay):
                    p, a, m = lay
                    rc = libs[side][0].pt2_ternary_matmul_dec_igathered(
                        x.data_ptr(), perm.data_ptr(), p.data_ptr(), a.data_ptr(), m.data_ptr(),
                        partial.data_ptr(), out.data_ptr(), counters.data_ptr(), B, K, K, n, 128,
                        splits, 0, dix, stream)
                    if rc:
                        sys.exit(f"{side} K3 launch failed: {rc}")

                want = k1.ternary_matmul_igathered_plain(x, perm, *layers[0])
                for side in libs:
                    call_k3(side, layers[0])
                    torch.cuda.synchronize()
                    err = (out - want).abs().max().item() / want.abs().max().item()
                    if not err <= KERNEL_TOL:
                        sys.exit(f"{side} {key}: max|err| {err:.3e} of max|ref| > {KERNEL_TOL}")
                    record["checks"][f"{side} {key}"] = err
                times = {"old": [], "new": []}
                for side in order:
                    times[side].append(1e3 * time_ms(
                        lambda i, s=side: call_k3(s, layers[i % copies])))
                record["us"][key] = times
                print(f"{key}: old {' / '.join(f'{t:.1f}' for t in times['old'])} us, new "
                      f"{' / '.join(f'{t:.1f}' for t in times['new'])} us (turns "
                      f"{' '.join(order)}) on {smi}")
            del layers
    if counters.any():
        sys.exit("a decode launch left a column tile's counter set")
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "k1_dec_ab.json"), "w") as f:
        json.dump(record, f, indent=1)
    print(json.dumps(record))


if __name__ == "__main__":
    main()
