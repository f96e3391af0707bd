"""Command-line entry of the port.

  python -m recommendation_tpu_torch models
  python -m recommendation_tpu_torch serve --model lightgcn \\
      --checkpoint PARAMS.npz [--device cuda|cpu] [--train T --test T] \\
      [--set graph.compute_dtype=bfloat16] [--host H --port P]

``serve`` restores parameters saved by ``weights.save_params`` and serves
top-k over HTTP. Training is not ported yet, so ``serve`` needs a
checkpoint. Missing dataset paths fall back to the cached synthetic
ML-100K-shaped set, as in the JAX package's CLI.
"""

from __future__ import annotations

import argparse
import ast
import os
import sys


def _parse_value(s: str):
    try:
        return ast.literal_eval(s)
    except (ValueError, SyntaxError):
        return s


def _parse_sets(pairs):
    out = {}
    for p in pairs or []:
        k, _, v = p.partition("=")
        out[k] = _parse_value(v)
    return out


def _load_sets(args):
    from recommendation_tpu_torch.data.io import load_data
    from recommendation_tpu_torch.data.synthetic import load_or_make_dataset

    if args.train and os.path.exists(args.train):
        train = load_data(args.train)
        test = load_data(args.test) if args.test else []
        return train, test
    return load_or_make_dataset()


def build_service(model_name: str, checkpoint: str, config, train, test, device="cuda"):
    """Interaction → DeviceGraph → restored parameters → eval embeddings
    (the layer chain) → RecommenderService: the serving path."""
    from recommendation_tpu_torch.data.interaction import Interaction
    from recommendation_tpu_torch.graph.device import DeviceGraph
    from recommendation_tpu_torch.models import registry
    from recommendation_tpu_torch.serve.service import RecommenderService
    from recommendation_tpu_torch.weights import load_params

    data = Interaction(train, test)
    graph = DeviceGraph(
        data,
        backend=config.get("graph.backend", "auto"),
        compute_dtype=config.get("graph.compute_dtype", "float32"),
        device=device,
    )
    model = registry.build(model_name, config)
    params = load_params(checkpoint, model_name, device=graph.device)
    user_emb, item_emb = model.eval_embeddings(params, {}, graph)
    return RecommenderService(user_emb, item_emb, data, graph)


def main(argv=None):
    ap = argparse.ArgumentParser(prog="recommendation_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)
    sub.add_parser("models")
    p = sub.add_parser("serve", help="serve top-k over HTTP from saved parameters")
    p.add_argument("--model", required=True)
    p.add_argument("--train")
    p.add_argument("--test")
    p.add_argument("--set", action="append", help="config override key=value")
    p.add_argument("--checkpoint", help="parameters saved by weights.save_params (.npz)")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8080)
    args = ap.parse_args(argv)

    if args.cmd == "models":
        from recommendation_tpu_torch.models import registry

        print("\n".join(registry.available()))
        return 0

    if not args.checkpoint:
        print("error: serve needs --checkpoint PARAMS.npz: training is not ported yet "
              "(it comes in the next slice of the port)", file=sys.stderr)
        return 2
    if not os.path.exists(args.checkpoint):
        print(f"error: checkpoint not found: {args.checkpoint}", file=sys.stderr)
        return 2
    from recommendation_tpu_torch.config import default_config
    from recommendation_tpu_torch.serve.http import serve_http

    config = default_config(**_parse_sets(args.set))
    train, test = _load_sets(args)
    service = build_service(args.model, args.checkpoint, config, train, test, device=args.device)
    print(f"serving on http://{args.host}:{args.port}  (GET /recommend?user=<id>&k=10)")
    serve_http(service, host=args.host, port=args.port)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
