"""On-card smoke test of the PyTorch/CUDA port (pt2tpu_torch).

    python3 chip_smoke.py

Needs one NVIDIA GPU (an H100) and the CUDA toolkit; builds every kernel of
the port from pt2tpu_torch/csrc/ (one nvcc per source, in parallel) and then:

  1. holds K1 (the 2-bit unpack + matmul) against its plain version at the
     four llama-2-7b and the three other llama-3-8b projection shapes, B in
     {1, 2, 4, 16, 512}, bf16 and W2A8, and on a packed[li] view of a
     2-layer stack;
  2. holds K4 (the SSR gather), K3 (the gather fused into K1) and K2 (the
     whole MLP) against their plain versions at the llama-3-8b shapes (K3 at
     qkv, o and gateup), a ragged shape with pad lanes and an MLP whose down
     has pad blocks, rows 1/2/4/16 (K4 1/4/16/512), bf16 and (K3) W2A8, and
     on stacked views;
  3. holds a 2-layer llama-2-7b ("down" layout) and a 2-layer llama-3-8b
     ("ssr" layout: prefill through K4 + K1, decode through K3 + K2, or in
     W2A8 K3 + K1), both at full width, against their reference routes
     ("plain"; for W2A8 the same route with every kernel swapped for its
     plain version), and round-trips each through save_model / load_model;
  4. drives the llama-2-7b main path of the first slice: 32 layers, "down"
     layout, 4 prompts of 128 ids, greedy_generate with max_new 32, bf16 and
     W2A8; K1's launch count must rise by exactly 4 * 32 * 32 per run; one
     decode step is then timed and traced with torch.profiler;
  5. drives this slice's main path: llama-3-8b, 32 layers, full-SSR layout,
     the same prompts and max_new, in bf16 ("auto") and W2A8; every kernel's
     launch count must rise by exactly what the routing implies; one decode
     step is traced; then the same model in the "down" layout, where K2 runs
     without its gather and K1 falls by 2 launches per layer and step;
  6. times K1 at the llama-2-7b shapes and K4, K3 and K2 at the llama-3-8b
     shapes (B = 1 and 16; K4 also 512 rows) with cold weights, beside their
     plain versions, a PyTorch yardstick and the memory bound.

Every phase that fails makes the script exit non-zero. The last two lines
are the kernels' JSON record and the device JSON; the whole record is also
written to chiprun_out/chip_smoke.json.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import shutil
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# llama-2-7b projections on the first slice's path: (name, K, n); down's K is
# 11008 padded to 96 scale blocks, gateup's n is 2 x 11264 after pad_gateup_blocks.
SHAPES = [("qkv", 4096, 12288), ("o", 4096, 4096), ("gateup", 4096, 22528), ("down", 12288, 4096)]
# K1 on the llama-3-8b paths besides o (prefill, W2A8 down, the "down" layout)
SHAPES_8B_K1 = [("8b qkv", 4096, 6144), ("8b gateup", 4096, 28672), ("8b down", 14336, 4096)]
# llama-3-8b gathered projections (name, m, K, n): K3 runs gateup in W2A8
# decode; only qkv and o are timed. Its MLP (D, I, n).
SHAPES_8B = [("qkv", 4096, 4096, 6144), ("o", 4096, 4096, 4096)]
GATEUP_8B = ("gateup", 4096, 4096, 28672)
MLP_8B = (4096, 14336, 4096)
KERNEL_TOL = 1e-4  # K1 / K3 vs plain, same bf16 inputs: f32 summation order only
# K2 vs plain: both round mid = silu(gate) * up to bf16, but gate/up differ in
# their last f32 bits, so a few mid values land on the neighbouring bf16.
MLP_TOL = 1e-3
LOGITS_REL_L2 = 1e-2  # model through the kernels vs plain route: bf16 activations round differently
TOKEN_TOL = 2e-2  # greedy pick must be a max of the plain logits within 2% of max |logit|
# W2A8 route vs the same route on plain versions (logits rel L2, pick gap):
# every row is cast to bf16 (a 0.5 grid above 64) and rounded to int8, so an
# f32 summation-order difference upstream moves a value by a whole int8
# step. The kernels themselves are held per call at KERNEL_TOL on the route.
A8_TOLS = (5e-2, 5e-2)
COLD_BYTES = 150e6  # timing operands rotate over more than the 50 MB L2


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


def profile_decode_step(cfg, params, prompts, Lp, new, dev, label):
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
    print(f"one decode step, {label} (B={B}, {cfg.n_layers} layers, bf16): wall {wall_ms:.2f} ms, "
          f"device time {device_ms:.2f} ms (busy {100 * out['device_busy']:.1f} %; profiler)")
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
        from pt2tpu_torch.ops.kernels import gather as k4
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
    t_start = time.perf_counter()

    # launch counters of every kernel wrapper: K1, K3, K2, K4
    wrappers = {"ternary_matmul": k1.ternary_matmul,
                "ternary_matmul_igathered": k1.ternary_matmul_igathered,
                "ternary_mlp": k1.ternary_mlp, "onehot_gather": k4.onehot_gather}

    def zero_counts():
        for w in wrappers.values():
            w.launches = 0

    def counts():
        return {name: w.launches for name, w in wrappers.items()}

    # ---- build every kernel (one nvcc per source, in parallel)
    t0 = time.perf_counter()
    sources = ["ternary_matmul", "ternary_mlp", "onehot_gather"]
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(len(sources)) as ex:
        libs = list(ex.map(_build.build, sources))
    record["build_s"] = time.perf_counter() - t0
    print(f"built {sources} in {record['build_s']:.1f} s")
    for src, so in zip(sources, libs):
        with open(so + ".log") as f:
            for line in f:
                if "registers" in line or "spill" in line:
                    print(f"  ptxas {src}:", line.strip())

    # ---- 1. K1 vs its plain version at the llama-2-7b shapes
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

    def rand_perm(m, K, interleave=False):
        """Visit lanes over m features padded to K lanes with m; with
        ``interleave`` the pad lanes sit among the valid ones."""
        perm = torch.cat([torch.randperm(m, generator=g, device=dev),
                          torch.full((K - m,), m, device=dev)])
        if interleave:
            perm = perm[torch.randperm(K, generator=g, device=dev)]
        return perm.to(torch.int32)

    max_err = 0.0
    checks = 0
    for name, K, n in SHAPES + SHAPES_8B_K1:
        packed, alpha, mu = rand_layer(K, n)
        for B in (1, 2, 4, 16, 512):
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
    print(f"K1 vs plain: {checks} checks (7 shapes x B 1/2/4/16/512 x bf16/a8 + 2 stacked views) "
          f"within {KERNEL_TOL} x max|ref|; max|err| {max_err:.3e}")
    del packed, alpha, mu, x

    # ---- 2. K4, K3 and K2 vs their plain versions
    errs = {"onehot_gather": 0.0, "ternary_matmul_igathered": 0.0, "ternary_mlp": 0.0}
    nchecks = dict.fromkeys(errs, 0)

    def held(kernel, label, got, want, tol):
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        scale = want.float().abs().max().item()
        if got.shape != want.shape or got.dtype != want.dtype:
            fail(f"{label}: {tuple(got.shape)} {got.dtype} vs {tuple(want.shape)} {want.dtype}")
        if tol == 0.0 and not torch.equal(got, want):
            fail(f"{label}: not bit-exact (max|err| {err:.3e})")
        if not err <= tol * scale:
            fail(f"{label}: max|err| {err:.3e} > {tol} x max|ref| {scale:.3e}")
        errs[kernel] = max(errs[kernel], err)
        nchecks[kernel] += 1

    for m, K, inter in ((4096, 4096, False), (200, 256, True)):
        perm = rand_perm(m, K, inter)
        for B in (1, 4, 16, 512):
            x = torch.randn((B, m), generator=g, device=dev).bfloat16()
            held("onehot_gather", f"K4 m={m} K={K} rows={B}", k4.onehot_gather(x, perm),
                 k4.onehot_gather_plain(x, perm), 0.0)
    for name, m, K, n in SHAPES_8B + [GATEUP_8B, ("ragged", 200, 256, 256)]:
        packed, alpha, mu = rand_layer(K, n)
        perm = rand_perm(m, K, name == "ragged")
        for B in (1, 2, 4, 16):
            x = torch.randn((B, m), generator=g, device=dev).bfloat16()
            for a8 in (False, True):
                held("ternary_matmul_igathered", f"K3 {name} B={B} a8={a8}",
                     k1.ternary_matmul_igathered(x, perm, packed, alpha, mu, a8=a8),
                     k1.ternary_matmul_igathered_plain(x, perm, packed, alpha, mu, a8=a8),
                     KERNEL_TOL)
    # MLPs: llama-3-8b, and I = 1408 (11 blocks) with down padded to 16 blocks
    # (verify_fused_mlp's probe); ssr gathers over D features or no gather
    # (x zero-padded to the gateup's 16-block lane count)
    for D, I, n in (MLP_8B, (512, 1408, 512)):
        Kg = -(-D // 2048) * 2048
        gp, ga, gm = rand_layer(Kg, 2 * I)
        dp, da, dm = rand_layer(-(-(I // 128) // 16) * 16 * 128, n)
        for gathered in (True, False):
            perm = rand_perm(D, Kg) if gathered else None
            for B in (1, 2, 4, 16):
                x = torch.randn((B, D), generator=g, device=dev).bfloat16()
                held("ternary_mlp", f"K2 D={D} I={I} gather={gathered} B={B}",
                     k1.ternary_mlp(x, perm, gp, ga, gm, dp, da, dm, I),
                     k1.ternary_mlp_plain(x, perm, gp, ga, gm, dp, da, dm, I), MLP_TOL)
    del gp, ga, gm, dp, da, dm
    # stacked views: layer li of (L, ...) arrays
    D, I, n = 4096, 1024, 4096
    gp, ga, gm = rand_layer(D, 2 * I, L=2)
    dp, da, dm = rand_layer(2048, n, L=2)
    perms = torch.stack([rand_perm(D, D) for _ in range(2)])
    x = torch.randn((4, D), generator=g, device=dev).bfloat16()
    for li in (0, 1):
        held("onehot_gather", f"K4 perm[{li}]", k4.onehot_gather(x, perms[li]),
             k4.onehot_gather_plain(x, perms[li]), 0.0)
        held("ternary_matmul_igathered", f"K3 packed[{li}]",
             k1.ternary_matmul_igathered(x, perms[li], gp[li], ga[li], gm[li]),
             k1.ternary_matmul_igathered_plain(x, perms[li], gp[li], ga[li], gm[li]), KERNEL_TOL)
        held("ternary_mlp", f"K2 layer {li}",
             k1.ternary_mlp(x, perms[li], gp[li], ga[li], gm[li], dp[li], da[li], dm[li], I),
             k1.ternary_mlp_plain(x, perms[li], gp[li], ga[li], gm[li], dp[li], da[li], dm[li], I),
             MLP_TOL)
    del gp, ga, gm, dp, da, dm, x
    record["new_kernel_checks"] = nchecks
    record["new_kernel_max_abs_err"] = errs
    print(f"K4 vs plain: {nchecks['onehot_gather']} checks bit-exact; K3 vs plain: "
          f"{nchecks['ternary_matmul_igathered']} checks within {KERNEL_TOL} x max|ref| (max|err| "
          f"{errs['ternary_matmul_igathered']:.3e}); K2 vs plain: {nchecks['ternary_mlp']} checks "
          f"within {MLP_TOL} x max|ref| (max|err| {errs['ternary_mlp']:.3e})")

    # ---- 3. 2-layer models at full width through the kernels vs their reference
    import pt2tpu_torch.ops.gather as tgather
    import pt2tpu_torch.ops.ternary_matmul as ttm

    def k1_plain(x, p, a, m, bs=128, a8=False):
        return (k1.ternary_matmul_plain_a8 if a8 else k1.ternary_matmul_plain)(x, p, a, m, bs)

    # (wrapper's name in the routing modules, its plain version, tolerance)
    routed = {"ternary_matmul": (ttm, k1_plain, KERNEL_TOL),
              "ternary_matmul_igathered": (ttm, k1.ternary_matmul_igathered_plain, KERNEL_TOL),
              "ternary_mlp": (ttm, k1.ternary_mlp_plain, MLP_TOL),
              "onehot_gather": (tgather, k4.onehot_gather_plain, 0.0)}
    per_call = dict.fromkeys(routed, 0)

    @contextlib.contextmanager
    def swapped(make):
        """Each routed kernel wrapper replaced by make(name, wrapper, plain, tol)."""
        saved = {name: getattr(mod, name) for name, (mod, _, _) in routed.items()}
        for name, (mod, plain, tol) in routed.items():
            setattr(mod, name, make(name, saved[name], plain, tol))
        try:
            yield
        finally:
            for name, (mod, _, _) in routed.items():
                setattr(mod, name, saved[name])

    def each_call_checked(name, kernel, plain, tol):
        """The kernel's result, after holding it against its plain version on
        the same inputs (the route's own activations)."""
        def call(*args, **kw):
            got, want = kernel(*args, **kw), plain(*args, **kw)
            err = (got.float() - want.float()).abs().max().item()
            if (got.shape != want.shape or (tol == 0.0 and not torch.equal(got, want))
                    or not err <= tol * want.float().abs().max().item()):
                fail(f"{name} inside a 2-layer model: max|err| {err:.3e} > {tol} x max|ref|")
            per_call[name] += 1
            return got
        return call

    def plain_versions():
        """The routing unchanged, every kernel swapped for its plain version:
        the reference of the W2A8 route, which has no impl of its own."""
        return swapped(lambda name, kernel, plain, tol: plain)

    def reference(impl):
        """(impl, context) of the route a model run is held against."""
        return ("plain", contextlib.nullcontext()) if impl == "auto" else (impl, plain_versions())

    def two_layer_check(name, layout, seed, impls=("auto",)):
        cfg2 = get_config(name).with_(n_layers=2)
        params2 = random_ternary_params(cfg2, seed=seed, perm_mode=layout, device=dev)
        prompt = torch.randint(0, cfg2.vocab_size, (4, 128), generator=g, device=dev)

        @torch.inference_mode()
        def prefill_logits(params, impl):
            cache = init_cache(cfg2, 4, 160, device=dev)
            logits, _ = forward_cached(cfg2, params, prompt, cache, 0, impl, all_logits=True)
            return logits.float()

        rec = {}
        for impl in impls:
            rel_tol, tok_tol = (LOGITS_REL_L2, TOKEN_TOL) if impl == "auto" else A8_TOLS
            for k in per_call:
                per_call[k] = 0
            with swapped(each_call_checked):  # the kernel route, every call held
                la = prefill_logits(params2, impl)
                toks = greedy_generate(cfg2, params2, prompt, 16, impl=impl)
            checked = {k: v for k, v in per_call.items() if v}
            c0 = counts()
            ref_impl, ctx = reference(impl)
            with ctx:
                lp = prefill_logits(params2, ref_impl)
            rel = ((la - lp).norm() / lp.norm()).item()
            ref_impl, ctx = reference(impl)
            with ctx, torch.inference_mode():  # teacher-forced reference over the same tokens
                cache = init_cache(cfg2, 4, 144, device=dev)
                logits, _ = forward_cached(cfg2, params2, prompt, cache, 0, ref_impl)
                agree, worst = 0, 0.0
                for s in range(16):
                    lf = logits.float()
                    picked = lf.gather(1, toks[:, s : s + 1].long())[:, 0]
                    gap = (lf.max(dim=1).values - picked).max().item()
                    worst = max(worst, gap / lf.abs().max().item())
                    agree += int((lf.argmax(dim=1) == toks[:, s]).sum().item())
                    if s < 15:
                        logits, _ = forward_cached(cfg2, params2, toks[:, s : s + 1].long(),
                                                   cache, 128 + s, ref_impl)
            if counts() != c0:
                fail(f"2-layer {name}: the reference route of {impl} launched a kernel")
            print(f"2-layer {name} ({layout}) {impl}: every kernel call of prefill + 16 decode "
                  f"steps held against its plain version on the same inputs {checked}; prefill "
                  f"logits vs reference ({ref_impl}{'' if impl == 'auto' else ', plain versions'}) "
                  f"rel L2 {rel:.3e} (<= {rel_tol}); 16 greedy tokens x 4: {agree}/64 equal to "
                  f"the reference argmax, worst pick gap {worst:.2e} of max|logit| (<= {tok_tol})")
            if not (math.isfinite(rel) and rel <= rel_tol):
                fail(f"2-layer {name} {impl} prefill logits vs reference: rel L2 {rel:.3e} > "
                     f"{rel_tol}")
            if worst > tok_tol:
                fail(f"2-layer {name} {impl} greedy tokens: a pick trails the reference max by "
                     f"{worst:.3e} of max|logit|")
            rec[impl] = {"calls_checked": checked, "prefill_rel_l2": rel, "greedy_agree": agree,
                         "greedy_total": 64, "worst_pick_gap": worst}
            del cache, logits, lp
        la = prefill_logits(params2, "auto")
        art = os.path.join(ROOT, "build", f"smoke_artifact_{layout}")
        ckpt.save_model(art, cfg2, params2)
        cfg_l, params_l = ckpt.load_model(art, device=dev)
        shutil.rmtree(art)
        fa, sa, fb, sb = {}, {}, {}, {}
        ckpt._flatten("", params2, fa, sa)
        ckpt._flatten("", params_l, fb, sb)
        if cfg_l != cfg2 or sa != sb or any(not torch.equal(fa[k], fb[k]) for k in fa):
            fail(f"{name} save_model/load_model round trip changed the model")
        rt = ((prefill_logits(params_l, "auto") - la).norm() / la.norm()).item()
        if rt > 1e-6:
            fail(f"reloaded {name} model's logits differ: rel L2 {rt:.3e}")
        print(f"2-layer {name} ({layout}): save/load round trip exact ({len(fa)} arrays)")
        rec["roundtrip_rel_l2"] = rt
        del params2, params_l, la
        torch.cuda.empty_cache()
        return rec

    record["model2"] = two_layer_check("llama-2-7b", "down", 1)
    c0 = counts()
    record["model2_8b_ssr"] = two_layer_check("llama-3-8b", "ssr", 3, ("auto", "a8"))
    used = {k: v - c0[k] for k, v in counts().items()}
    if not all(used.values()):
        fail(f"2-layer llama-3-8b ssr did not launch every kernel: {used}")

    # ---- 4./5. the main paths: 4 prompts x 128 ids, 32 new tokens
    B, Lp, new = 4, 128, 32
    steps = new - 1  # decode steps after the prefill

    def drive(cfg, params, label, impls, want_fn, prompts):
        """greedy_generate once per impl, every count set to 0 just before and
        read just after; then the prefill alone, timed. Returns per-impl runs."""
        greedy_generate(cfg, params, prompts[:, :16], 2)  # warm-up: allocator, cuBLAS
        torch.cuda.synchronize()
        runs = {}
        for impl in impls:
            zero_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            toks = greedy_generate(cfg, params, prompts, new, impl=impl)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            got, want = counts(), want_fn(impl)
            if got != want:
                fail(f"main path {label} {impl}: launches {got}, want {want}")
            if tuple(toks.shape) != (B, new) or not bool(((toks >= 0) & (toks < cfg.vocab_size)).all()):
                fail(f"main path {label} {impl}: bad tokens {tuple(toks.shape)}")
            runs[impl] = {"wall_s": wall, "launches": got, "first_tokens": toks[:, :4].tolist()}
        for impl in impls:
            with torch.inference_mode():
                cache = init_cache(cfg, B, Lp + new, device=dev)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                logits, _ = forward_cached(cfg, params, prompts, cache, 0, impl)
                torch.cuda.synchronize()
                pre = time.perf_counter() - t0
            if not bool(torch.isfinite(logits.float()).all()) or tuple(logits.shape) != (B, cfg.vocab_size):
                fail(f"main path {label} {impl}: prefill logits not finite or misshapen")
            r = runs[impl]
            r["prefill_s"] = pre
            r["prefill_tok_s"] = B * Lp / pre
            r["decode_s"] = r["wall_s"] - pre
            r["decode_tok_s"] = B * steps / r["decode_s"]
            print(f"main path {label} {cfg.n_layers}L {impl}: {B}x{Lp} prompt, {new} new: launches "
                  f"{r['launches']}; prefill {r['prefill_tok_s']:.1f} tok/s, decode "
                  f"{r['decode_tok_s']:.1f} tok/s (wall {r['wall_s']:.2f} s) on {record['smi']}")
            del cache, logits
        return runs

    def build(name, layout, seed):
        cfg = get_config(name)
        t0 = time.perf_counter()
        params = random_ternary_params(cfg, seed=seed, perm_mode=layout, device=dev)
        torch.cuda.synchronize()
        return cfg, params, time.perf_counter() - t0

    # 4. llama-2-7b, "down" layout: K1 alone, 4 per layer at prefill and each step
    cfg, params, record["model_build_s"] = build("llama-2-7b", "down", 2)
    prompts = torch.randint(0, cfg.vocab_size, (B, Lp), generator=g, device=dev)
    L = cfg.n_layers
    none = dict.fromkeys(wrappers, 0)
    runs = drive(cfg, params, "llama-2-7b", ("auto", "a8"),
                 lambda impl: dict(none, ternary_matmul=4 * L * new), prompts)
    record["main_path"] = runs
    main_launches = {"ternary_matmul": sum(r["launches"]["ternary_matmul"] for r in runs.values())}
    record["decode_step"] = profile_decode_step(cfg, params, prompts, Lp, new, dev, "llama-2-7b down")
    del params
    torch.cuda.empty_cache()

    # 5. llama-3-8b, full-SSR layout: prefill K4 x3 + K1 x4 per layer; each
    # decode step K3 x2 (qkv, o) + K2 per layer ("auto"), or K3 x3 (qkv, o,
    # gateup) + K1 (down) per layer (W2A8: the fused MLP takes "auto" only)
    cfg, params, record["model_build_8b_s"] = build("llama-3-8b", "ssr", 4)
    prompts = torch.randint(0, cfg.vocab_size, (B, Lp), generator=g, device=dev)
    L = cfg.n_layers
    want_ssr = {
        "auto": dict(ternary_matmul=4 * L, ternary_matmul_igathered=2 * L * steps,
                     ternary_mlp=L * steps, onehot_gather=3 * L),
        "a8": dict(ternary_matmul=4 * L + L * steps, ternary_matmul_igathered=3 * L * steps,
                   ternary_mlp=0, onehot_gather=3 * L),
    }
    runs = drive(cfg, params, "llama-3-8b ssr", ("auto", "a8"), want_ssr.get, prompts)
    record["main_path_8b_ssr"] = runs
    for k in wrappers:
        if k != "ternary_matmul":
            main_launches[k] = sum(r["launches"][k] for r in runs.values())
    record["decode_step_8b_ssr"] = profile_decode_step(cfg, params, prompts, Lp, new, dev,
                                                       "llama-3-8b ssr")
    del params
    torch.cuda.empty_cache()

    # the same model in the "down" layout: K2 without its gather; K1 runs
    # qkv and o only at each decode step (2 per layer and step fewer)
    cfg, params, _ = build("llama-3-8b", "down", 5)
    want_down = dict(none, ternary_matmul=4 * L + 2 * L * steps, ternary_mlp=L * steps)
    record["main_path_8b_down"] = drive(cfg, params, "llama-3-8b down", ("auto",),
                                        lambda impl: want_down, prompts)
    del params
    torch.cuda.empty_cache()
    record["paths_s"] = time.perf_counter() - t_start

    # ---- 6. timings (cold weights: rotate > L2), CUDA events over back-to-back
    # launches of the C entry points (no Python wrapper in the loop)
    lib = k1._kernel_lib()
    mlp_lib = k1._mlp_kernel_lib()
    gather_lib = k4._kernel_lib()
    stream = torch.cuda.current_stream().cuda_stream
    dix = dev.index or 0
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

    def ok(rc, what):
        if rc:
            fail(f"{what} launch failed in timing: {rc}")

    def bound(nbytes, ops):
        t_bytes, t_ops = nbytes / bw * 1e3, ops / bf16_peak * 1e3
        return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"

    def row(kernel, name, B, ms, plain_ms, lib_ms, nbytes, ops, **shape):
        b_ms, b_by = bound(nbytes, ops)
        d = {"kernel": kernel, "shape": name, "B": B, **shape, "ms": ms, "plain_ms": plain_ms,
             "library_ms": lib_ms, "bytes": nbytes, "bound_ms": b_ms, "bound_by": b_by,
             "GBps": nbytes / ms / 1e6}
        print(f"{kernel} {name:7s} B={B:3d} {shape}: {ms * 1e3:8.1f} us | plain {plain_ms * 1e3:9.1f} us"
              f" | library {lib_ms * 1e3:7.1f} us | bound {b_ms * 1e3:6.2f} us ({b_by}) | "
              f"{d['GBps']:.0f} GB/s | {100 * b_ms / ms:.1f} % of bound")
        return d

    def dense(K, n):
        copies = max(1, math.ceil(COLD_BYTES / (2 * K * n)))
        return [torch.randn((K, n), generator=g, device=dev).bfloat16() for _ in range(copies)]

    detail = []
    for name, K, n in SHAPES:
        wbytes = K * n // 4 + 4 * (K // 128) * n
        copies = max(1, math.ceil(COLD_BYTES / wbytes))
        layers = [rand_layer(K, n) for _ in range(copies)]
        dn = dense(K, n)
        for B in (1, 16):
            x = torch.randn((B, K), generator=g, device=dev).bfloat16()
            out = torch.empty((B, n), dtype=torch.float32, device=dev)

            def kern(i):
                p, a, m = layers[i % copies]
                ok(lib.pt2_ternary_matmul(x.data_ptr(), p.data_ptr(), a.data_ptr(), m.data_ptr(),
                                          out.data_ptr(), B, K, n, 128, 0, dix, stream), "K1")

            ms = time_ms(kern, 50)
            plain_ms = time_ms(lambda i: k1.ternary_matmul_plain(x, *layers[i % copies]), 5)
            lib_ms = time_ms(lambda i: torch.matmul(x, dn[i % len(dn)]), 50)
            detail.append(row("K1", name, B, ms, plain_ms, lib_ms,
                              K * n / 4 + 4 * (K // 128) * n + 2 * B * K + 4 * B * n,
                              2.0 * B * K * n, K=K, n=n))
        del layers, dn
    record["k1_timing"] = detail

    # K3 at llama-3-8b qkv / o; library: one dense bf16 matmul on pre-gathered x
    k3_detail = []
    for name, m, K, n in SHAPES_8B:
        wbytes = K * n // 4 + 4 * (K // 128) * n
        copies = max(1, math.ceil(COLD_BYTES / wbytes))
        layers = [rand_layer(K, n) + (rand_perm(m, K),) for _ in range(copies)]
        dn = dense(K, n)
        for B in (1, 16):
            x = torch.randn((B, m), generator=g, device=dev).bfloat16()
            out = torch.empty((B, n), dtype=torch.float32, device=dev)

            def kern(i):
                p, a, mu_, pm = layers[i % copies]
                ok(lib.pt2_ternary_matmul_igathered(
                    x.data_ptr(), pm.data_ptr(), p.data_ptr(), a.data_ptr(), mu_.data_ptr(),
                    out.data_ptr(), B, m, K, n, 128, 0, dix, stream), "K3")

            ms = time_ms(kern, 50)
            plain_ms = time_ms(lambda i: k1.ternary_matmul_igathered_plain(
                x, layers[i % copies][3], *layers[i % copies][:3]), 5)
            xg = k4.onehot_gather_plain(x, layers[0][3])
            lib_ms = time_ms(lambda i: torch.matmul(xg, dn[i % len(dn)]), 50)
            k3_detail.append(row("K3", name, B, ms, plain_ms, lib_ms,
                                 K * n / 4 + 4 * (K // 128) * n + 2 * B * m + 4 * K + 4 * B * n,
                                 2.0 * B * K * n, m=m, K=K, n=n))
        del layers, dn
    record["k3_timing"] = k3_detail

    # K2 at llama-3-8b (gather over 4096 lanes); library: the two dense bf16
    # matmuls x @ W_gateup and mid @ W_down (a yardstick: no single call exists)
    D, I, n = MLP_8B
    Kd = -(-(I // 128) // 16) * 16 * 128
    wbytes = D * 2 * I // 4 + 4 * (D // 128) * 2 * I + Kd * n // 4 + 4 * (Kd // 128) * n
    copies = max(1, math.ceil(COLD_BYTES / wbytes))
    layers = [rand_layer(D, 2 * I) + rand_layer(Kd, n) + (rand_perm(D, D),) for _ in range(copies)]
    w_gu = torch.randn((D, 2 * I), generator=g, device=dev).bfloat16()
    w_dn = torch.randn((I, n), generator=g, device=dev).bfloat16()
    k2_detail = []
    for B in (1, 16):
        x = torch.randn((B, D), generator=g, device=dev).bfloat16()
        mid = torch.randn((B, I), generator=g, device=dev).bfloat16()
        partial = torch.empty((I // 128, B, n), dtype=torch.float32, device=dev)
        out = torch.empty((B, n), dtype=torch.float32, device=dev)

        def kern(i):
            gp, ga, gm, dp, da, dm, pm = layers[i % copies]
            ok(mlp_lib.pt2_ternary_mlp(
                x.data_ptr(), pm.data_ptr(), gp.data_ptr(), ga.data_ptr(), gm.data_ptr(),
                dp.data_ptr(), da.data_ptr(), dm.data_ptr(), partial.data_ptr(), out.data_ptr(),
                B, D, D, 2 * I, I, Kd, n, dix, stream), "K2")

        ms = time_ms(kern, 50)
        plain_ms = time_ms(lambda i: k1.ternary_mlp_plain(
            x, layers[i % copies][6], *layers[i % copies][:6], I), 3)
        lib_ms = time_ms(lambda i: (torch.matmul(x, w_gu), torch.matmul(mid, w_dn)), 20)
        nbytes = (D * 2 * I / 4 + 4 * (D // 128) * 2 * I + I * n / 4 + 4 * (I // 128) * n
                  + 2 * B * D + 4 * D + 4 * B * n)
        k2_detail.append(row("K2", "mlp", B, ms, plain_ms, lib_ms, nbytes,
                             2.0 * B * (D * 2 * I + I * n), D=D, I=I, n=n))
    del layers, w_gu, w_dn
    record["k2_timing"] = k2_detail

    # K4 at llama-3-8b's 4096 lanes (no pad lanes); library: torch.index_select
    k4_detail = []
    m = K = 4096
    perms = [rand_perm(m, K) for _ in range(4)]
    for B in (1, 16, 512):
        per_call = 2 * B * m + 4 * K + 2 * B * K
        copies = max(1, math.ceil(COLD_BYTES / per_call))
        xs = [torch.randn((B, m), generator=g, device=dev).bfloat16() for _ in range(copies)]
        outs = [torch.empty((B, K), dtype=torch.bfloat16, device=dev) for _ in range(copies)]
        lperm = [p.long() for p in perms]

        def kern(i):
            c = i % copies
            ok(gather_lib.pt2_onehot_gather(xs[c].data_ptr(), perms[i % 4].data_ptr(),
                                            outs[c].data_ptr(), B, m, K, 2, dix, stream), "K4")

        ms = time_ms(kern, 50)
        plain_ms = time_ms(lambda i: k4.onehot_gather_plain(xs[i % copies], perms[i % 4]), 20)
        lib_ms = time_ms(lambda i: torch.index_select(xs[i % copies], 1, lperm[i % 4]), 50)
        k4_detail.append(row("K4", "gather", B, ms, plain_ms, lib_ms, per_call, 0.0, m=m, K=K))
        del xs, outs
    record["k4_timing"] = k4_detail

    # ---- the record: per kernel, one layer of one step of its main path
    # (K1 / K3 / K2 at B = 1 decode; K4 at the 512-row prefill, 3 gathers)
    def entry(name, source, replaces, rows, err, mult=1):
        return {
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": main_launches[name], "max_abs_err": err,
            "ms": mult * sum(d["ms"] for d in rows),
            "plain_ms": mult * sum(d["plain_ms"] for d in rows),
            "bound_ms": mult * sum(d["bound_ms"] for d in rows),
            "bound_by": "bytes" if all(d["bound_by"] == "bytes" for d in rows) else "operations",
            "library_ms": mult * sum(d["library_ms"] for d in rows),
        }

    b1 = lambda rows: [d for d in rows if d["B"] == 1]  # noqa: E731
    kernels = [
        entry("ternary_matmul", "pt2tpu_torch/csrc/ternary_matmul.cu",
              "pt2tpu/ops/kernels/pallas_ternary.py:1354", b1(detail), max_err),
        entry("ternary_mlp", "pt2tpu_torch/csrc/ternary_mlp.cu",
              "pt2tpu/ops/kernels/pallas_ternary.py:1106", b1(k2_detail), errs["ternary_mlp"]),
        entry("ternary_matmul_igathered", "pt2tpu_torch/csrc/ternary_matmul.cu",
              "pt2tpu/ops/kernels/pallas_ternary.py:735", b1(k3_detail),
              errs["ternary_matmul_igathered"]),
        entry("onehot_gather", "pt2tpu_torch/csrc/onehot_gather.cu",
              "pt2tpu/ops/kernels/pallas_gather.py:239",
              [d for d in k4_detail if d["B"] == 512], errs["onehot_gather"], mult=3),
    ]
    record["kernels"] = kernels
    record["total_s"] = time.perf_counter() - t_start
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump(record, f, indent=1)
    print(f"chip_smoke: all phases passed in {record['total_s']:.1f} s after start-up")
    print(smi())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
