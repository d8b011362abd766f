"""K7's tensor-core kernel from this tree against other versions of it and
against its own split counts, on a GPU.

Builds ``pt2tpu_torch/csrc/decode_attention_tc.cu`` and each source given
with --old (an earlier or edited copy of it with the same C entry,
``pt2_decode_attention_tc``) into libraries of their own (nvcc for sm_90a
with ``-Xptxas -v``) and prints their ptxas lines. Then:

- the clusters of each size (1..16) the card holds at once with the tree's
  kernel (``cudaOccupancyMaxActiveClusters`` through a helper that includes
  the tree's source), the table ``attention.MAX_ACTIVE_CLUSTERS`` copies;
- each library's output against ``decode_attention_split_plain`` on the
  tree's plan (one bf16 step of each value plus 1e-3 of max|ref|), ragged
  lengths, every head layout below, bf16 and int8;
- its time: 20 calls replayed from a CUDA graph (the card's time per call,
  launch gaps included), the cache rotated over more than the 50 MB L2, at
  B 8 and M 2048 with llama-3-8b's heads (32 / 8, hd 128), gemma-2b's (8 /
  1, hd 256) and llama-2-7b's (32 / 32), bf16 and int8 KV, every slot valid,
  512 valid and engine-like lengths (64-576), for each split count of
  --splits around the plan's, the sources in turns (this tree's, the olds,
  the olds, this tree's).

Prints one JSON object; writes it to ``chiprun_out/k7_tc_ab.json``.

Usage: python scripts/torch_k7_tc_ab.py [--old <decode_attention_tc.cu> ...]
           [--splits plan|1,2,3] [--turns 2] [--out k7_tc_ab.json]
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
HEADS = {"llama-3-8b": (32, 8, 128), "gemma-2b": (8, 1, 256), "llama-2-7b": (32, 32, 128)}

OCC_SRC = r'''#include "decode_attention_tc.cu"
template <int HD, bool QUANT> int occ(int M, int splits, int* clusters) {
  using C = k7tc::Cfg<HD, QUANT>;
  const size_t smem = 1024 + C::RING + 4 * (size_t)((M + 31) / 32);
  auto kern = k7tc::decode_attention_tc<HD, QUANT>;
  cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  cudaFuncSetAttribute(kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  cudaFuncSetAttribute(kern, cudaFuncAttributePreferredSharedMemoryCarveout,
                       cudaSharedmemCarveoutMaxShared);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits, attr[0].val.clusterDim.y = 1, attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(splits, 64, 1), cfg.blockDim = dim3(C::THREADS);
  cfg.dynamicSmemBytes = smem, cfg.attrs = attr, cfg.numAttrs = 1;
  return (int)cudaOccupancyMaxActiveClusters(clusters, (void*)kern, &cfg);
}
extern "C" int pt2_k7_occupancy(int hd, int quant, int M, int splits, int* clusters) {
  if (hd == 128) return quant ? occ<128, true>(M, splits, clusters) : occ<128, false>(M, splits, clusters);
  return quant ? occ<256, true>(M, splits, clusters) : occ<256, false>(M, splits, clusters);
}
'''


def nvcc(src: str, so: str):
    """Compile ``src`` into ``so``; returns the ptxas lines of its kernels."""
    from pt2tpu_torch.ops.kernels import _build

    cmd = [_build._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
           "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-I", CSRC, "-o", so, src]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        sys.exit(f"nvcc failed for {src}:\n{res.stderr}")
    lines, entry = [], None
    for line in (res.stdout + res.stderr).splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            entry = re.search(r"decode_attention_tcILi(\d+)ELb(\d)", m.group(1))
        elif entry and ("registers" in line or "spill" in line):
            lines.append(f"hd {entry.group(1)} int8 {entry.group(2)}: {line.strip()}")
    return lines


def load(so: str):
    lib = ctypes.CDLL(so)
    fn = lib.pt2_decode_attention_tc
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_float] + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--old", action="append", default=[])
    ap.add_argument("--splits", default="around", help="'around' the plan, 'plan', or a list")
    ap.add_argument("--turns", type=int, default=2)
    ap.add_argument("--out", default="k7_tc_ab.json")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        sys.exit("needs a CUDA GPU")
    sys.path.insert(0, ROOT)
    from pt2tpu_torch.ops.kernels import attention as k7
    from pt2tpu_torch.serve.kvcache import quantize_i8

    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    rec = {"smi": smi, "device": torch.cuda.get_device_name(0), "ptxas": {}, "timing": []}
    print(f"card: {smi}", flush=True)
    out_dir = os.path.join(ROOT, "build", "k7_tc_ab")
    os.makedirs(out_dir, exist_ok=True)
    srcs = [("tree", os.path.join(CSRC, "decode_attention_tc.cu"))]
    srcs += [(f"old{i}", os.path.abspath(p)) for i, p in enumerate(args.old)]
    fns = {}
    for tag, src in srcs:
        so = os.path.join(out_dir, f"{tag}.so")
        rec["ptxas"][tag] = nvcc(src, so)
        fns[tag] = load(so)
        for line in rec["ptxas"][tag]:
            print(f"  ptxas {tag} {line}")
    occ_cu = os.path.join(out_dir, "occ.cu")
    with open(occ_cu, "w") as f:
        f.write(OCC_SRC)
    nvcc(occ_cu, os.path.join(out_dir, "occ.so"))
    occ = ctypes.CDLL(os.path.join(out_dir, "occ.so"))
    rec["max_active_clusters"] = {}
    for hd in (128, 256):
        for quant in (0, 1):
            row = []
            for s in range(1, k7.MAX_SPLITS + 1):
                c = ctypes.c_int()
                rc = occ.pt2_k7_occupancy(hd, quant, 2048, s, ctypes.byref(c))
                row.append(c.value if rc == 0 else -rc)
            rec["max_active_clusters"][f"hd{hd}_int8{quant}"] = row
            print(f"max active clusters, hd {hd} int8 {quant}, sizes 1..16: {row}", flush=True)

    g = torch.Generator(device=dev).manual_seed(0)

    def inputs(B, M, H, Hkv, hd, quant, lens):
        q = torch.randn((B, 1, H, hd), generator=g, device=dev).bfloat16()
        k = torch.randn((B, M, Hkv, hd), generator=g, device=dev)
        v = torch.randn((B, M, Hkv, hd), generator=g, device=dev)
        valid = torch.arange(M, device=dev)[None] < torch.as_tensor(lens, device=dev).reshape(-1, 1)
        if not quant:
            return q, k.bfloat16(), v.bfloat16(), valid, None, None
        (k8, ks), (v8, vs) = quantize_i8(k), quantize_i8(v)
        return q, k8, v8, valid, ks, vs

    def call(fn, a, scale, splits, out):
        q, k, v, valid, ks, vs = a
        B, _, H, hd = q.shape
        M, Hkv = k.shape[1], k.shape[2]
        ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), valid.data_ptr(), ptr(ks), ptr(vs),
                out.data_ptr(), scale, B, M, H, Hkv, hd, splits, int(ks is not None), dev.index or 0,
                torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            sys.exit(f"launch failed: cudaError {rc}")
        return out

    def graph_us(fn, n=20):
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn(0)
        torch.cuda.current_stream().wait_stream(side)
        torch.cuda.synchronize()
        gr = torch.cuda.CUDAGraph()
        with torch.cuda.graph(gr):
            for i in range(n):
                fn(i)
        gr.replay()
        torch.cuda.synchronize()
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        gr.replay()
        e.record()
        torch.cuda.synchronize()
        return s.elapsed_time(e) / n * 1e3

    # bits: each source on the tree's plan against the split plain version
    rec["checks"] = []
    for name, (H, Hkv, hd) in HEADS.items():
        for quant in (False, True):
            B, M = 8, 2048
            a = inputs(B, M, H, Hkv, hd, quant, torch.randint(1, M + 1, (B,), generator=g, device=dev))
            plan = k7.k7_plan(B, M, Hkv, H // Hkv, hd, quant)
            want = k7.decode_attention_split_plain(*a[:4], 0.09, *a[4:], tile=plan.tile,
                                                   splits=plan.splits).float()
            for tag, fn in fns.items():
                got = call(fn, a, 0.09, plan.splits, torch.empty_like(a[0])).float()
                torch.cuda.synchronize()
                step = torch.maximum(got.abs(), want.abs()) * 2.0 ** -7
                over = ((got - want).abs() - step).max().item() / want.abs().max().item()
                rec["checks"].append({"src": tag, "heads": name, "int8": quant, "over": over})
                print(f"{tag} {name} int8={quant} plan {tuple(plan)}: max(|err| - one bf16 step) = "
                      f"{over:.2e} of max|ref| (tolerance 1e-3)", flush=True)
                if over > 1e-3:
                    sys.exit(f"{tag} disagrees with decode_attention_split_plain")

    for name, (H, Hkv, hd) in HEADS.items():
        for quant in (False, True):
            B, M = 8, 2048
            plan = k7.k7_plan(B, M, Hkv, H // Hkv, hd, quant)
            if args.splits == "plan":
                splits = [plan.splits]
            elif args.splits == "around":
                splits = sorted({max(1, plan.splits // 2), plan.splits,
                                 min(k7.MAX_SPLITS, plan.splits + 1)})
            else:
                splits = [int(x) for x in args.splits.split(",")]
            for label in ("all", "512", "engine"):
                kvb = 2 * B * M * Hkv * hd * (1 if quant else 2)
                copies = max(2, math.ceil(COLD_BYTES / kvb))
                lens = lambda: ([M] * B if label == "all" else [512] * B if label == "512"  # noqa: E731
                                else torch.randint(64, 577, (B,), generator=g, device=dev))
                sets = [inputs(B, M, H, Hkv, hd, quant, lens()) for _ in range(copies)]
                out = torch.empty((B, 1, H, hd), dtype=torch.bfloat16, device=dev)
                order = list(fns) + list(reversed(fns))
                for S in splits:
                    times = {tag: [] for tag in fns}
                    for _ in range(args.turns):
                        for tag in order:
                            times[tag].append(graph_us(
                                lambda i, fn=fns[tag]: call(fn, sets[i % copies], 0.09, S, out)))
                    d = {"heads": name, "int8": quant, "lengths": label, "splits": S,
                         "plan": S == plan.splits, "us": times}
                    rec["timing"].append(d)
                    print(f"{name} int8={quant} lengths {label} splits {S}"
                          f"{' (plan)' if S == plan.splits else ''}: " + "  ".join(
                              f"{tag} " + "/".join(f"{x:.1f}" for x in ts) for tag, ts in times.items())
                          + " us a call (graph)", flush=True)
                del sets
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", args.out), "w") as f:
        json.dump(rec, f, indent=1)
    print(json.dumps({"max_active_clusters": rec["max_active_clusters"]}))


if __name__ == "__main__":
    main()
