"""Command line: ``python -m pt2tpu_torch.cli generate|info``.

  generate — greedy decode from token ids with a packed artifact (the
             JAX package's format); prints the ids comma-separated, as
             ``python -m pt2tpu.cli generate`` does.
  info     — print an artifact's manifest without its structure.

Runs on the card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import json
import os


def cmd_generate(args):
    from .serve.generate import greedy_generate
    from .utils.checkpoint import load_model
    from .utils.device import resolve_device

    if not os.path.exists(os.path.join(args.model, "manifest.json")):
        raise NotImplementedError(
            f"{args.model} is not an artifact directory: random init of a "
            "registry config is not ported, pass a packed artifact"
        )
    if not args.prompt_ids:
        raise SystemExit("need --prompt-ids (tokenizers are not ported)")
    dev = resolve_device(args.device)
    cfg, params = load_model(args.model, device=dev)
    ids = [int(x) for x in args.prompt_ids.split(",")]
    out = greedy_generate(
        cfg, params, [ids], max_new=args.max_new,
        max_len=min(cfg.max_seq_len, len(ids) + args.max_new),
        impl="a8" if args.a8 else "auto",
    )
    print(",".join(map(str, out[0].tolist())))


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
    g.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    g.set_defaults(fn=cmd_generate)
    i = sub.add_parser("info", help="inspect an artifact")
    i.add_argument("--model", required=True)
    i.set_defaults(fn=cmd_info)
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
