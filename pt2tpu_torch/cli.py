"""Command line: ``python -m pt2tpu_torch.cli quantize|eval|generate|serve|info``.

  quantize — a local HuggingFace checkpoint directory, or a registry config
             with random dense weights (from ``--seed``), calibrated on a
             token stream and ternarized; writes a packed artifact (the JAX
             package's format) with the per-layer journal and
             ``quantize_metrics.jsonl`` in ``--output``, and resumes from
             that journal. The JAX package's flags.
  eval     — perplexity of an artifact, an HF directory or a registry
             config's random dense model on a token stream.
  generate — greedy decode from token ids (or ``--prompt`` text with a local
             tokenizer) with any of those models; prints the ids
             comma-separated, as ``python -m pt2tpu.cli generate`` does, or
             the text; ``--draft`` decodes speculatively under a draft
             model (greedy only), ``--ring-kv`` on ring caches.
  serve    — the HTTP front end over the continuous-batching engine
             (POST /generate, GET /health); ``--paged`` over a paged KV pool,
             ``--draft`` with speculative decoding in the batcher.
  info     — print an artifact's manifest without its structure, or an HF
             directory's config.

Runs on the card unless ``--device cpu`` is given. Dense weights are f32 on
the CPU and bf16 on the card (the JAX package's rule). An HF checkpoint of
more than 4 GiB loads host-resident when the run is on the card, and
``quantize`` then streams it to the card one layer at a time (the JAX
package's rule, :func:`host_resident`). A tokenizer is used only where one
is present locally (``--tokenizer``; ``quantize`` also tries the HF
directory's own, as the JAX CLI does); otherwise the CLI works on token
ids.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


HOST_RESIDENT_BYTES = 4 << 30  # larger checkpoints stay on the host when running on the card


def checkpoint_bytes(model_dir: str) -> int:
    """The bytes of a checkpoint directory's weight files."""
    return sum(os.path.getsize(os.path.join(model_dir, f)) for f in os.listdir(model_dir)
               if f.endswith((".safetensors", ".bin")))


def host_resident(nbytes: int, device) -> bool:
    """The JAX package's residency rule: a checkpoint of more than 4 GiB
    loads on the host when the run is not on the CPU."""
    return nbytes > HOST_RESIDENT_BYTES and device.type != "cpu"


def _resolve_model(name_or_path: str, device, seed: int = 0):
    """A local HF directory -> (cfg, its weights, "hf"); a registry name ->
    (cfg, random dense params, "random-init"). f32 on the CPU and bf16 on
    the card; an HF checkpoint that :func:`host_resident` picks stays on the
    host."""
    import torch

    from .models import decoder as dec
    from .models.registry import get_config

    dtype = torch.float32 if device.type == "cpu" else torch.bfloat16
    if os.path.isdir(name_or_path):
        from .models.hf_loader import load_hf_model

        host = host_resident(checkpoint_bytes(name_or_path), device)
        return load_hf_model(name_or_path, dtype=dtype,
                             device="cpu" if host else device) + ("hf",)
    cfg = get_config(name_or_path)
    gen = torch.Generator(device=device).manual_seed(seed)
    return cfg, dec.init_params(cfg, gen, dtype=dtype, device=device), "random-init"


def _load(args):
    """An artifact directory, else an HF directory or a registry config's
    random dense model; a host-resident HF model moves to the device whole
    (only ``quantize`` streams)."""
    from .models.decoder import _map
    from .utils.checkpoint import load_model
    from .utils.device import resolve_device

    dev = resolve_device(args.device)
    if os.path.exists(os.path.join(args.model, "manifest.json")):
        return load_model(args.model, device=dev)
    cfg, params, _ = _resolve_model(args.model, dev, getattr(args, "seed", 42))
    if params["embed"].device.type != dev.type:
        params = _map(lambda t: t.to(dev), params)
    return cfg, params


def _load_draft(args):
    """The draft model of ``--draft``: an artifact, an HF directory or a
    registry config (random weights from ``--seed``), on the target's device."""
    return _load(argparse.Namespace(model=args.draft, device=args.device, seed=args.seed))


def _load_tokenizer(path_or_none):
    if not path_or_none:
        return None
    try:
        from transformers import AutoTokenizer

        return AutoTokenizer.from_pretrained(path_or_none, local_files_only=True)
    except Exception as e:
        print(f"tokenizer unavailable ({e}); token-id IO only", file=sys.stderr)
        return None


def cmd_quantize(args):
    from .data import get_calibration_data
    from .quant.pipeline import QuantConfig, quantize_model
    from .utils.checkpoint import save_model
    from .utils.device import resolve_device
    from .utils.metrics import MetricsLogger, model_bits_per_weight

    dev = resolve_device(args.device)
    cfg, params, provenance = _resolve_model(args.model, dev, args.seed)
    print(f"model: {args.model} [{provenance}] {cfg.n_layers}L dim={cfg.dim}")
    tok = _load_tokenizer(args.tokenizer or (args.model if provenance == "hf" else None))
    calib, calib_prov = get_calibration_data(
        args.calib, cfg.vocab_size, num_samples=args.num_samples,
        seq_len=min(args.seq_len, cfg.max_seq_len), seed=args.seed, tokenizer=tok,
    )
    print(f"calibration: {calib_prov} {calib.shape}")
    qcfg = QuantConfig(
        block_size=args.block_size,
        percdamp=args.percdamp,
        use_ssr=not args.no_ssr,
        use_aga=args.aga != "off",
        aga_mode=args.aga if args.aga != "off" else "exact",
        batch_size=args.batch_size,
        fuse_projections=not args.no_fuse,
        fold_perms=not args.no_fold,
        ssr_skip=tuple(s for s in args.ssr_skip.split(",") if s),
        ssr_scope=args.ssr_scope,
        quantize_lm_head=args.quantize_lm_head,
    )
    log = MetricsLogger(os.path.join(args.output, "quantize_metrics.jsonl"), verbose=True)
    t0 = time.time()
    qparams, report = quantize_model(cfg, params, calib, qcfg, log=log, journal_dir=args.output,
                                     device=dev)
    elapsed = time.time() - t0
    print(f"quantized in {elapsed:.1f}s; bits/weight {model_bits_per_weight(qparams):.3f}")
    report["provenance"] = {"model": provenance, "calibration": calib_prov}
    report["elapsed_s"] = elapsed
    save_model(args.output, cfg, qparams, quant_config=qcfg, report=report)
    print(f"artifact saved to {args.output}")
    if args.eval:
        _eval_params(cfg, qparams, args, tok)


def _eval_params(cfg, params, args, tok):
    from .data import evaluate_perplexity, get_token_stream

    stream, prov = get_token_stream(args.eval_dataset, cfg.vocab_size, split="test",
                                    tokenizer=tok, seed=args.seed)
    impl = "a8" if getattr(args, "a8", False) else "auto"
    res = evaluate_perplexity(cfg, params, stream, seq_len=min(args.seq_len, cfg.max_seq_len),
                              max_windows=args.max_windows, impl=impl)
    tag = " (a8)" if impl == "a8" else ""
    print(f"perplexity{tag} [{prov}]: {res['ppl']:.4f} over {res['tokens']} tokens")
    return res


def cmd_eval(args):
    cfg, params = _load(args)
    _eval_params(cfg, params, args, _load_tokenizer(args.tokenizer))


def cmd_generate(args):
    import torch

    from .serve.generate import generate
    from .serve.sampling import SamplingConfig

    tok = _load_tokenizer(args.tokenizer)
    if args.prompt_ids:
        ids = [int(x) for x in args.prompt_ids.split(",")]
    elif args.prompt and tok:
        ids = tok(args.prompt)["input_ids"]
    else:
        raise SystemExit("need --prompt-ids, or --prompt with a local tokenizer")
    if args.draft and args.temperature > 0:  # JAX's refusals, before anything is loaded
        raise SystemExit("--draft (speculative) is greedy-only")
    if args.ring_kv and not args.draft:
        if args.temperature > 0:
            raise SystemExit("--ring-kv is greedy-only for now")
        if args.kv_int8:
            raise SystemExit(
                "--ring-kv caches are bf16; combine with --kv-int8 is not "
                "supported (drop one of the flags)"
            )
    cfg, params = _load(args)
    max_len = min(cfg.max_seq_len, len(ids) + args.max_new)
    impl = "a8" if args.a8 else "auto"
    if args.draft:  # JAX's order: speculative decoding before the ring caches
        from .serve.speculative import speculative_generate

        cfg_d, params_d = _load_draft(args)
        out, stats = speculative_generate(cfg, params, cfg_d, params_d, [ids],
                                          max_new=args.max_new, k=args.spec_k, impl=impl,
                                          kv_quant=args.kv_int8)
        print(f"speculative: {stats}", file=sys.stderr)
    elif args.ring_kv:
        from .serve.ring import ring_generate

        out = ring_generate(cfg, params, [ids], max_new=args.max_new, max_len=max_len,
                            impl=impl)
    else:
        gen = torch.Generator(device=params["embed"].device)
        gen.manual_seed(args.seed)
        out = generate(
            cfg, params, [ids], max_new=args.max_new, max_len=max_len, impl=impl,
            kv_quant=args.kv_int8,
            sampling=SamplingConfig(temperature=args.temperature, top_k=args.top_k,
                                    top_p=args.top_p),
            generator=gen,
        )
    ids_out = out[0].tolist()
    print(tok.decode(ids_out) if tok else ",".join(map(str, ids_out)))


def cmd_serve(args):
    from .serve.server import ServingServer

    if args.tp != 1:
        raise NotImplementedError("--tp needs tensor parallelism (parallel/tp.py): not ported")
    cfg, params = _load(args)
    engine = None
    if args.paged:  # JAX's order: the paged pool before speculative decoding
        from .serve.paged import PagedServeEngine

        engine = PagedServeEngine(
            cfg, params, max_batch=args.max_batch, max_len=args.max_len,
            page_size=args.page_size, kv_pages=args.kv_pages, kv_quant=args.kv_int8,
            decode_quantum=args.quantum, seed=args.seed,
        )
    elif args.draft:
        from .serve.engine import ServeEngine

        engine = ServeEngine(cfg, params, max_batch=args.max_batch, max_len=args.max_len,
                             draft=_load_draft(args), spec_k=args.spec_k, seed=args.seed)
    srv = ServingServer(
        cfg, params, host=args.host, port=args.port, max_batch=args.max_batch,
        max_len=args.max_len, kv_quant=args.kv_int8, decode_quantum=args.quantum,
        seed=args.seed, engine=engine,
    ).start()
    print(f"serving on http://{args.host}:{srv.port} (POST /generate, GET /health); "
          "ctrl-c to stop", flush=True)
    try:
        while srv.error is None:
            time.sleep(1)
    except KeyboardInterrupt:
        pass
    finally:
        srv.stop()
    if srv.error is not None:
        raise SystemExit(f"the engine failed: {srv.error}")


def cmd_info(args):
    if not os.path.exists(os.path.join(args.model, "manifest.json")) and os.path.exists(
            os.path.join(args.model, "config.json")):
        import dataclasses

        from .models.hf_loader import config_from_hf

        cfg = config_from_hf(args.model)
        print(json.dumps({"hf_checkpoint": args.model, "model_config": dataclasses.asdict(cfg),
                          "checkpoint_bytes": checkpoint_bytes(args.model)}, indent=2))
        return
    with open(os.path.join(args.model, "manifest.json")) as f:
        manifest = json.load(f)
    manifest.pop("structure", None)
    print(json.dumps(manifest, indent=2))


def build_parser():
    ap = argparse.ArgumentParser(
        prog="pt2tpu_torch", description="ternary LLM serving on PyTorch/CUDA"
    )
    sub = ap.add_subparsers(dest="cmd", required=True)
    q = sub.add_parser("quantize", help="ternarize a model")
    q.add_argument("--model", required=True,
                   help="local HF checkpoint directory, or registry config name (random init)")
    q.add_argument("--output", default="./quantized_model")
    q.add_argument("--block_size", type=int, default=128)
    q.add_argument("--num_samples", type=int, default=128)
    q.add_argument("--seq_len", type=int, default=2048)
    q.add_argument("--no_ssr", action="store_true")
    q.add_argument("--no_fold", action="store_true",
                   help="keep run-time gathers instead of folding SSR perms into the layout")
    q.add_argument("--ssr_skip", default="",
                   help="comma-separated quant groups to quantize without SSR")
    q.add_argument("--ssr_scope", default="auto", choices=["auto", "all", "down"],
                   help="which groups SSR covers: all, down (its perm folds for free), "
                   "auto (all below dim 640, down from 640)")
    q.add_argument("--quantize_lm_head", action="store_true", help="also ternarize the lm_head")
    q.add_argument("--percdamp", type=float, default=0.01)
    q.add_argument("--aga", choices=["exact", "reference", "off"], default="exact")
    q.add_argument("--no_fuse", action="store_true",
                   help="quantize q/k/v and gate/up separately")
    q.add_argument("--calib", default="wikitext", help="wikitext|c4|ptb|synthetic|<file>")
    q.add_argument("--batch_size", type=int, default=8)
    q.add_argument("--eval", action="store_true")
    q.add_argument("--eval_dataset", default="wikitext")
    q.add_argument("--max_windows", type=int, default=None)
    q.add_argument("--seed", type=int, default=42)
    q.add_argument("--tokenizer", default=None)
    q.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    q.set_defaults(fn=cmd_quantize)
    e = sub.add_parser("eval", help="perplexity of an artifact or a registry config")
    e.add_argument("--model", required=True)
    e.add_argument("--eval_dataset", default="wikitext")
    e.add_argument("--seq_len", type=int, default=2048)
    e.add_argument("--max_windows", type=int, default=None)
    e.add_argument("--seed", type=int, default=42)
    e.add_argument("--tokenizer", default=None)
    e.add_argument("--a8", action="store_true", help="through K1's W2A8 mode")
    e.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    e.set_defaults(fn=cmd_eval)
    g = sub.add_parser("generate", help="decode, greedy or sampled")
    g.add_argument("--model", required=True, help="artifact, HF checkpoint directory or registry config")
    g.add_argument("--seed", type=int, default=42,
                   help="a registry config's random weights, and the sampler's generator")
    g.add_argument("--prompt", default=None, help="text, with a local tokenizer")
    g.add_argument("--prompt-ids", default=None)
    g.add_argument("--tokenizer", default=None)
    g.add_argument("--max-new", type=int, default=64)
    g.add_argument("--a8", action="store_true",
                   help="W2A8: int8 activations in the K1 kernel")
    g.add_argument("--kv-int8", action="store_true", help="int8 KV cache")
    g.add_argument("--ring-kv", action="store_true",
                   help="window-sized ring KV caches on sliding layers "
                        "(gemma2/3; greedy only, exact)")
    g.add_argument("--temperature", type=float, default=0.0)
    g.add_argument("--top_k", type=int, default=0)
    g.add_argument("--top_p", type=float, default=1.0)
    g.add_argument("--draft", default=None,
                   help="draft model (artifact, HF directory or registry config) for "
                        "speculative decoding (greedy only; exact vs plain greedy)")
    g.add_argument("--spec-k", type=int, default=4, help="draft tokens per speculative round")
    g.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    g.set_defaults(fn=cmd_generate)
    sv = sub.add_parser("serve", help="HTTP serving front end")
    sv.add_argument("--model", required=True, help="artifact, HF checkpoint directory or registry config")
    sv.add_argument("--host", default="127.0.0.1")
    sv.add_argument("--port", type=int, default=8471)
    sv.add_argument("--max-batch", type=int, default=8)
    sv.add_argument("--max-len", type=int, default=2048)
    sv.add_argument("--kv-int8", action="store_true", help="int8 KV cache")
    sv.add_argument("--quantum", type=int, default=1,
                    help="decode steps per host fetch (token-identical)")
    sv.add_argument("--seed", type=int, default=42, help="keys sampled requests")
    sv.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    sv.add_argument("--paged", action="store_true", help="pooled paged KV cache (serve/paged.py)")
    sv.add_argument("--page-size", type=int, default=64)
    sv.add_argument("--kv-pages", type=int, default=None,
                    help="total pages in the pool (default: the flat pool's positions)")
    sv.add_argument("--draft", default=None,
                    help="draft model: per-row speculative decoding inside the batcher")
    sv.add_argument("--spec-k", type=int, default=4)
    sv.add_argument("--tp", type=int, default=1, help="not ported")
    sv.set_defaults(fn=cmd_serve)
    i = sub.add_parser("info", help="inspect an artifact or an HF checkpoint directory")
    i.add_argument("--model", required=True)
    i.set_defaults(fn=cmd_info)
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
