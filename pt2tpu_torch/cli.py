"""Command line: ``python -m pt2tpu_torch.cli generate|serve|info``.

  generate — greedy decode from token ids with a packed artifact (the
             JAX package's format); prints the ids comma-separated, as
             ``python -m pt2tpu.cli generate`` does.
  serve    — the HTTP front end over the continuous-batching engine
             (POST /generate, GET /health).
  info     — print an artifact's manifest without its structure.

Runs on the card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import json
import os
import time


def _load(args):
    from .utils.checkpoint import load_model
    from .utils.device import resolve_device

    if not os.path.exists(os.path.join(args.model, "manifest.json")):
        raise NotImplementedError(
            f"{args.model} is not an artifact directory: random init of a "
            "registry config is not ported, pass a packed artifact"
        )
    return load_model(args.model, device=resolve_device(args.device))


def cmd_generate(args):
    from .serve.generate import greedy_generate

    if not args.prompt_ids:
        raise SystemExit("need --prompt-ids (tokenizers are not ported)")
    cfg, params = _load(args)
    ids = [int(x) for x in args.prompt_ids.split(",")]
    out = greedy_generate(
        cfg, params, [ids], max_new=args.max_new,
        max_len=min(cfg.max_seq_len, len(ids) + args.max_new),
        impl="a8" if args.a8 else "auto",
        kv_quant=args.kv_int8,
    )
    print(",".join(map(str, out[0].tolist())))


def cmd_serve(args):
    from .serve.server import ServingServer

    for flag, what in (("paged", "the paged KV pool (serve/paged.py)"),
                       ("draft", "speculative decoding (serve/speculative.py)"),
                       ("tp", "tensor parallelism (parallel/tp.py)")):
        if getattr(args, flag) not in (None, False, 1):
            raise NotImplementedError(f"--{flag} needs {what}: not ported")
    cfg, params = _load(args)
    srv = ServingServer(
        cfg, params, host=args.host, port=args.port, max_batch=args.max_batch,
        max_len=args.max_len, kv_quant=args.kv_int8, decode_quantum=args.quantum,
        seed=args.seed,
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
    with open(os.path.join(args.model, "manifest.json")) as f:
        manifest = json.load(f)
    manifest.pop("structure", None)
    print(json.dumps(manifest, indent=2))


def build_parser():
    ap = argparse.ArgumentParser(
        prog="pt2tpu_torch", description="ternary LLM serving on PyTorch/CUDA"
    )
    sub = ap.add_subparsers(dest="cmd", required=True)
    g = sub.add_parser("generate", help="greedy decode")
    g.add_argument("--model", required=True, help="artifact directory")
    g.add_argument("--prompt-ids", default=None)
    g.add_argument("--max-new", type=int, default=64)
    g.add_argument("--a8", action="store_true",
                   help="W2A8: int8 activations in the K1 kernel")
    g.add_argument("--kv-int8", action="store_true", help="int8 KV cache")
    g.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    g.set_defaults(fn=cmd_generate)
    sv = sub.add_parser("serve", help="HTTP serving front end")
    sv.add_argument("--model", required=True, help="artifact directory")
    sv.add_argument("--host", default="127.0.0.1")
    sv.add_argument("--port", type=int, default=8471)
    sv.add_argument("--max-batch", type=int, default=8)
    sv.add_argument("--max-len", type=int, default=2048)
    sv.add_argument("--kv-int8", action="store_true", help="int8 KV cache")
    sv.add_argument("--quantum", type=int, default=1,
                    help="decode steps per host fetch (token-identical)")
    sv.add_argument("--seed", type=int, default=42, help="keys sampled requests")
    sv.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    sv.add_argument("--paged", action="store_true", help="not ported")
    sv.add_argument("--draft", default=None, help="not ported")
    sv.add_argument("--tp", type=int, default=1, help="not ported")
    sv.set_defaults(fn=cmd_serve)
    i = sub.add_parser("info", help="inspect an artifact")
    i.add_argument("--model", required=True)
    i.set_defaults(fn=cmd_info)
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
