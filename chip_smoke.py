"""On-card smoke test of the PyTorch/CUDA port (pt2tpu_torch).

    python3 chip_smoke.py

Needs one NVIDIA GPU (an H100) and the CUDA toolkit; builds every kernel of
the port's main path from pt2tpu_torch/csrc/ and then:

  1. holds K1 (the 2-bit unpack + matmul) against its plain version at the
     four llama-2-7b projection shapes, B in {1, 4, 16, 512}, bf16 and W2A8,
     and on a packed[li] view of a 2-layer stack;
  2. holds a 2-layer llama-2-7b (full width) served through K1 against the
     plain route, and round-trips it through save_model / load_model;
  3. drives the main path: llama-2-7b at full width and depth (32 layers,
     random packed-ternary weights in the "down" layout), 4 prompts of 128
     ids, greedy_generate with max_new 32, in bf16 and in W2A8; K1's launch
     count must rise by exactly 4 * 32 * 32 per run; one decode step is
     then timed and traced with torch.profiler (device busy share);
  4. times K1 at each projection shape at B = 1 and 16 beside its plain
     version, one dense torch.matmul and the memory bound.

Every phase that fails makes the script exit non-zero. The last two lines
are the kernels' JSON record and the device JSON; the whole record is also
written to chiprun_out/chip_smoke.json.
"""

from __future__ import annotations

import json
import math
import os
import shutil
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# llama-2-7b projections on the main path: (name, K, n); down's K is 11008
# padded to 96 scale blocks, gateup's n is 2 x 11264 after pad_gateup_blocks.
SHAPES = [("qkv", 4096, 12288), ("o", 4096, 4096), ("gateup", 4096, 22528), ("down", 12288, 4096)]
KERNEL_TOL = 1e-4  # K1 vs plain, same bf16 inputs: f32 summation order only
LOGITS_REL_L2 = 1e-2  # model through K1 vs plain route: bf16 activations round differently
TOKEN_TOL = 2e-2  # greedy pick must be a max of the plain logits within 2% of max |logit|


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def smi() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if res.returncode != 0:
        fail(f"nvidia-smi failed: {res.stderr.strip()}")
    return res.stdout.strip().splitlines()[0]


def card_peaks(name: str):
    """(memory bytes/s, bf16 dense op/s) from the data sheet."""
    n = name.upper()
    if "H200" in n:
        return 4.8e12, 989e12
    if "H100" in n and "PCIE" in n:
        return 2.0e12, 756e12
    if "H100" in n and "NVL" in n:
        return 3.9e12, 835e12
    if "H100" in n:
        return 3.35e12, 989e12
    fail(f"no data-sheet peaks for {name}")


def profile_decode_step(cfg, params, prompts, Lp, new, dev):
    """Where one bf16 decode step's time goes: its wall time (unprofiled,
    host clock around a synchronised step) against the device time that
    torch.profiler attributes to kernels in a second, profiled step."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from pt2tpu_torch.serve.generate import forward_cached
    from pt2tpu_torch.serve.kvcache import init_cache

    B = prompts.shape[0]
    tok = prompts[:, :1].contiguous()
    with torch.inference_mode():
        cache = init_cache(cfg, B, Lp + new, device=dev)
        forward_cached(cfg, params, prompts, cache, 0, "auto")
        forward_cached(cfg, params, tok, cache, Lp, "auto")  # warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        forward_cached(cfg, params, tok, cache, Lp + 1, "auto")
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            forward_cached(cfg, params, tok, cache, Lp + 2, "auto")
            torch.cuda.synchronize()
    rows = []  # kernels only: CPU ops also carry the device time they launched
    for e in prof.key_averages():
        dt = getattr(e, "self_device_time_total", None)
        if dt is None:
            dt = getattr(e, "self_cuda_time_total", 0)
        if e.device_type == DeviceType.CUDA and dt > 0:
            rows.append((dt / 1e3, e.count, e.key))
    rows.sort(reverse=True)
    device_ms = sum(r[0] for r in rows)
    out = {"wall_ms": wall_ms, "device_ms": device_ms,
           "device_busy": device_ms / wall_ms if wall_ms else 0.0,
           "top": [{"ms": ms, "count": c, "name": k[:90]} for ms, c, k in rows[:8]]}
    print(f"one decode step (B={B}, 32 layers, bf16): wall {wall_ms:.2f} ms, device time "
          f"{device_ms:.2f} ms (busy {100 * out['device_busy']:.1f} %; profiler)")
    for t in out["top"]:
        print(f"  {t['ms']:8.3f} ms  x{t['count']:4d}  {t['name']}")
    if not rows:
        print("  torch.profiler saw no device time")
    return out


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke test needs a GPU")
    sys.path.insert(0, ROOT)
    try:
        from pt2tpu_torch.models.registry import get_config
        from pt2tpu_torch.ops.kernels import _build
        from pt2tpu_torch.ops.kernels import ternary as k1
    except ImportError as e:
        fail(f"the pt2tpu_torch package is not beside this script ({e})")
    from pt2tpu_torch.core.packing import pack_ternary
    from pt2tpu_torch.serve.generate import forward_cached, greedy_generate
    from pt2tpu_torch.serve.kvcache import init_cache
    from pt2tpu_torch.utils import checkpoint as ckpt
    from pt2tpu_torch.utils.randmodel import random_ternary_params

    torch.backends.cuda.matmul.allow_tf32 = False  # plain f32 products in full f32
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    record = {"smi": smi(), "device": torch.cuda.get_device_name(0)}
    print(f"card: {record['smi']} | torch: {record['device']} | torch {torch.__version__} "
          f"cuda {torch.version.cuda}")
    bw, bf16_peak = card_peaks(record["device"])

    # ---- 1. build every kernel of the path (one nvcc per source, in parallel)
    t0 = time.perf_counter()
    sources = ["ternary_matmul"]
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(len(sources)) as ex:
        libs = list(ex.map(_build.build, sources))
    record["build_s"] = time.perf_counter() - t0
    print(f"built {sources} in {record['build_s']:.1f} s")
    for so in libs:
        with open(so + ".log") as f:
            for line in f:
                if "registers" in line or "spill" in line:
                    print("  ptxas:", line.strip())

    # ---- 2. K1 vs its plain version at the main path's shapes
    g = torch.Generator(device=dev).manual_seed(0)

    def rand_layer(K, n, L=None):
        lead = () if L is None else (L,)
        codes = torch.randint(-1, 2, lead + (n, K), generator=g, device=dev, dtype=torch.int8)
        packed = (pack_ternary(codes) if L is None
                  else torch.stack([pack_ternary(c) for c in codes]))
        nb = K // 128
        alpha = ((0.8 + 0.4 * torch.rand(lead + (nb, n), generator=g, device=dev))
                 / math.sqrt(K)).bfloat16()
        mu = (0.02 / math.sqrt(K) * torch.randn(lead + (nb, n), generator=g, device=dev)).bfloat16()
        return packed, alpha, mu

    max_err = 0.0
    checks = 0
    for name, K, n in SHAPES:
        packed, alpha, mu = rand_layer(K, n)
        for B in (1, 4, 16, 512):
            x = torch.randn((B, K), generator=g, device=dev).bfloat16()
            for a8 in (False, True):
                got = k1.ternary_matmul(x, packed, alpha, mu, a8=a8)
                plain = k1.ternary_matmul_plain_a8 if a8 else k1.ternary_matmul_plain
                want = plain(x, packed, alpha, mu)
                torch.cuda.synchronize()
                err = (got - want).abs().max().item()
                scale = want.abs().max().item()
                if not (err <= KERNEL_TOL * scale) or got.shape != want.shape:
                    fail(f"K1 {name} B={B} a8={a8}: max|err| {err:.3e} > "
                         f"{KERNEL_TOL} x max|ref| {scale:.3e}")
                max_err = max(max_err, err)
                checks += 1
    packed, alpha, mu = rand_layer(4096, 4096, L=2)
    x = torch.randn((16, 4096), generator=g, device=dev).bfloat16()
    for li in (0, 1):
        got = k1.ternary_matmul(x, packed[li], alpha[li], mu[li])
        want = k1.ternary_matmul_plain(x, packed[li], alpha[li], mu[li])
        err = (got - want).abs().max().item()
        if not err <= KERNEL_TOL * want.abs().max().item():
            fail(f"K1 on packed[{li}] view: max|err| {err:.3e}")
        max_err = max(max_err, err)
        checks += 1
    record["k1_checks"] = checks
    record["k1_max_abs_err"] = max_err
    print(f"K1 vs plain: {checks} checks (4 shapes x B 1/4/16/512 x bf16/a8 + 2 stacked views) "
          f"within {KERNEL_TOL} x max|ref|; max|err| {max_err:.3e}")
    del packed, alpha, mu, x

    # ---- 3. a 2-layer llama-2-7b through K1 vs the plain route; artifact round trip
    cfg2 = get_config("llama-2-7b").with_(n_layers=2)
    params2 = random_ternary_params(cfg2, seed=1, perm_mode="down", device=dev)
    prompt = torch.randint(0, cfg2.vocab_size, (4, 128), generator=g, device=dev)

    @torch.inference_mode()
    def prefill_logits(params, impl):
        cache = init_cache(cfg2, 4, 160, device=dev)
        logits, _ = forward_cached(cfg2, params, prompt, cache, 0, impl, all_logits=True)
        return logits.float()

    la, lp = prefill_logits(params2, "auto"), prefill_logits(params2, "plain")
    rel = ((la - lp).norm() / lp.norm()).item()
    if not (math.isfinite(rel) and rel <= LOGITS_REL_L2):
        fail(f"2-layer prefill logits auto vs plain: rel L2 {rel:.3e} > {LOGITS_REL_L2}")
    toks = greedy_generate(cfg2, params2, prompt, 16, impl="auto")
    with torch.inference_mode():  # teacher-forced plain route over the same tokens
        cache = init_cache(cfg2, 4, 144, device=dev)
        logits, _ = forward_cached(cfg2, params2, prompt, cache, 0, "plain")
        agree, worst = 0, 0.0
        for s in range(16):
            lf = logits.float()
            picked = lf.gather(1, toks[:, s : s + 1].long())[:, 0]
            gap = (lf.max(dim=1).values - picked).max().item()
            worst = max(worst, gap / lf.abs().max().item())
            agree += int((lf.argmax(dim=1) == toks[:, s]).sum().item())
            if s < 15:
                logits, _ = forward_cached(cfg2, params2, toks[:, s : s + 1].long(), cache,
                                           128 + s, "plain")
    if worst > TOKEN_TOL:
        fail(f"2-layer greedy tokens: a pick trails the plain max by {worst:.3e} of max|logit|")
    art = os.path.join(ROOT, "build", "smoke_artifact")
    ckpt.save_model(art, cfg2, params2)
    cfg_l, params_l = ckpt.load_model(art, device=dev)
    shutil.rmtree(art)
    fa, sa, fb, sb = {}, {}, {}, {}
    ckpt._flatten("", params2, fa, sa)
    ckpt._flatten("", params_l, fb, sb)
    if cfg_l != cfg2 or sa != sb or any(not torch.equal(fa[k], fb[k]) for k in fa):
        fail("save_model/load_model round trip changed the model")
    rt = ((prefill_logits(params_l, "auto") - la).norm() / la.norm()).item()
    if rt > 1e-6:
        fail(f"reloaded model's logits differ: rel L2 {rt:.3e}")
    record["model2"] = {"prefill_rel_l2": rel, "greedy_agree": agree, "greedy_total": 64,
                        "worst_pick_gap": worst, "roundtrip_rel_l2": rt}
    print(f"2-layer llama-2-7b: prefill logits auto vs plain rel L2 {rel:.3e} (<= {LOGITS_REL_L2}); "
          f"16 greedy tokens x 4: {agree}/64 equal to the plain argmax, worst pick gap "
          f"{worst:.2e} of max|logit| (<= {TOKEN_TOL}); save/load round trip exact")
    del params2, params_l, cache, logits, la, lp
    torch.cuda.empty_cache()

    # ---- 4. the main path: full llama-2-7b, 4 prompts x 128 ids, 32 new tokens
    cfg = get_config("llama-2-7b")
    t0 = time.perf_counter()
    params = random_ternary_params(cfg, seed=2, perm_mode="down", device=dev)
    torch.cuda.synchronize()
    record["model_build_s"] = time.perf_counter() - t0
    B, Lp, new = 4, 128, 32
    prompts = torch.randint(0, cfg.vocab_size, (B, Lp), generator=g, device=dev)
    greedy_generate(cfg, params, prompts[:, :16], 2)  # warm-up: allocator, cuBLAS
    torch.cuda.synchronize()
    want_launches = 4 * cfg.n_layers * new
    runs = {}
    k1.ternary_matmul.launches = 0
    for impl in ("auto", "a8"):
        before = k1.ternary_matmul.launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        toks = greedy_generate(cfg, params, prompts, new, impl=impl)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = k1.ternary_matmul.launches - before
        if got != want_launches:
            fail(f"main path {impl}: K1 launched {got} times, want {want_launches}")
        if tuple(toks.shape) != (B, new) or not bool(((toks >= 0) & (toks < cfg.vocab_size)).all()):
            fail(f"main path {impl}: bad tokens {tuple(toks.shape)}")
        runs[impl] = {"wall_s": wall, "launches": got, "first_tokens": toks[:, :4].tolist()}
    main_launches = k1.ternary_matmul.launches
    for impl in ("auto", "a8"):
        with torch.inference_mode():
            cache = init_cache(cfg, B, Lp + new, device=dev)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, _ = forward_cached(cfg, params, prompts, cache, 0, impl)
            torch.cuda.synchronize()
            pre = time.perf_counter() - t0
        if not bool(torch.isfinite(logits.float()).all()) or tuple(logits.shape) != (B, cfg.vocab_size):
            fail(f"main path {impl}: prefill logits not finite or misshapen")
        r = runs[impl]
        r["prefill_s"] = pre
        r["prefill_tok_s"] = B * Lp / pre
        r["decode_s"] = r["wall_s"] - pre
        r["decode_tok_s"] = B * (new - 1) / r["decode_s"]
        print(f"main path llama-2-7b 32L {impl}: {B}x{Lp} prompt, {new} new: K1 launches "
              f"{r['launches']}; prefill {r['prefill_tok_s']:.1f} tok/s, decode "
              f"{r['decode_tok_s']:.1f} tok/s (wall {r['wall_s']:.2f} s) on {record['smi']}")
        del cache, logits
    record["main_path"] = runs
    record["decode_step"] = profile_decode_step(cfg, params, prompts, Lp, new, dev)
    del params
    torch.cuda.empty_cache()

    # ---- 5. K1 timings at the main path's shapes (cold weights: rotate > L2)
    lib = k1._kernel_lib()
    stream = torch.cuda.current_stream().cuda_stream
    ev = lambda: torch.cuda.Event(enable_timing=True)  # noqa: E731

    def time_ms(fn, iters):
        for i in range(3):
            fn(i)
        torch.cuda.synchronize()
        s, e = ev(), ev()
        s.record()
        for i in range(iters):
            fn(i)
        e.record()
        torch.cuda.synchronize()
        return s.elapsed_time(e) / iters

    detail = []
    for name, K, n in SHAPES:
        wbytes = K * n // 4 + 4 * (K // 128) * n
        copies = max(1, math.ceil(150e6 / wbytes))
        layers = [rand_layer(K, n) for _ in range(copies)]
        dense_copies = max(1, math.ceil(150e6 / (2 * K * n)))
        dense = [torch.randn((K, n), generator=g, device=dev).bfloat16() for _ in range(dense_copies)]
        for B in (1, 16):
            x = torch.randn((B, K), generator=g, device=dev).bfloat16()
            out = torch.empty((B, n), dtype=torch.float32, device=dev)

            def kern(i):
                p, a, m = layers[i % copies]
                rc = lib.pt2_ternary_matmul(x.data_ptr(), p.data_ptr(), a.data_ptr(), m.data_ptr(),
                                            out.data_ptr(), B, K, n, 128, 0, dev.index or 0, stream)
                if rc:
                    fail(f"K1 launch failed in timing: {rc}")

            ms = time_ms(kern, 50)
            plain_ms = time_ms(lambda i: k1.ternary_matmul_plain(x, *layers[i % copies]), 5)
            lib_ms = time_ms(lambda i: torch.matmul(x, dense[i % dense_copies]), 50)
            nbytes = K * n / 4 + 4 * (K // 128) * n + 2 * B * K + 4 * B * n
            t_bytes, t_ops = nbytes / bw * 1e3, 2.0 * B * K * n / bf16_peak * 1e3
            detail.append({
                "shape": name, "B": B, "K": K, "n": n, "ms": ms, "plain_ms": plain_ms,
                "library_ms": lib_ms, "bytes": nbytes, "bound_ms": max(t_bytes, t_ops),
                "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                "GBps": nbytes / ms / 1e6,
            })
            d = detail[-1]
            print(f"K1 {name:6s} B={B:2d} K={K} n={n}: {ms * 1e3:8.1f} us | plain "
                  f"{plain_ms * 1e3:8.1f} us | torch.matmul dense bf16 {lib_ms * 1e3:7.1f} us | "
                  f"bound {d['bound_ms'] * 1e3:6.1f} us ({d['bound_by']}) | {d['GBps']:.0f} GB/s")
        del layers, dense
    record["k1_timing"] = detail

    b1 = [d for d in detail if d["B"] == 1]
    kernels = [{
        "name": "ternary_matmul",
        "route": "cuda",
        "source": "pt2tpu_torch/csrc/ternary_matmul.cu",
        "replaces": "pt2tpu/ops/kernels/pallas_ternary.py:1354",
        "launches": main_launches,
        # one decode step's four projections of one layer, B = 1, bf16
        "max_abs_err": max_err,
        "ms": sum(d["ms"] for d in b1),
        "plain_ms": sum(d["plain_ms"] for d in b1),
        "bound_ms": sum(d["bound_ms"] for d in b1),
        "bound_by": "bytes" if all(d["bound_by"] == "bytes" for d in b1) else "operations",
        "library_ms": sum(d["library_ms"] for d in b1),
    }]
    record["kernels"] = kernels
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump(record, f, indent=1)
    print(smi())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
