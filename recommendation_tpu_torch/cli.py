"""Command-line entry of the port.

  python -m recommendation_tpu_torch models
  python -m recommendation_tpu_torch train --model MODEL [--train T --test T] \\
      [--set key=value ...] [--out RESULT.json] [--device cuda|cpu]
  python -m recommendation_tpu_torch serve --model MODEL \\
      [--checkpoint PARAMS.npz | CHECKPOINT_DIR] [--device cuda|cpu] \\
      [--train T --test T] [--set graph.compute_dtype=bfloat16] [--host H --port P]

``models`` lists the ported models: ``lightgcn``, ``ncl``, ``directau``,
``selfcf``, ``buir``, ``ssl4rec``, ``gcl`` (alias ``grace_rec``),
``grace``, ``gbt`` and ``bgrl`` (alias ``bgrl_g2l``). Each trains and
serves on the dense and the bucketed backend (``--set
graph.backend=bucketed``, or ``auto`` past the dense threshold), except
GRACE and G-BT, whose self-loop adjacency waits for the segment backend
there (ROADMAP item 10).
``train`` runs ``GraphRecommender.execute`` and prints the test metrics as
one JSON line (last on stdout), as the JAX package's CLI does. ``serve``
serves top-k over HTTP from parameters saved by ``weights.save_params``
(``.npz``), from the newest checkpoint in a directory written by
``train.checkpoint.CheckpointManager`` (``--set checkpoint.dir=DIR``
while training), or, without ``--checkpoint``, after training first.
Serving needs the parameters only: no model's eval embeddings read model
state (NCL's clusters serve training alone). Missing dataset
paths fall back to the cached synthetic ML-100K-shaped set, as in the JAX
package's CLI.
"""

from __future__ import annotations

import argparse
import ast
import json
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


def train_recommender(model_name: str, config, train, test, device="cuda"):
    """Interaction → DeviceGraph → GraphRecommender, built and trained:
    the training path."""
    from recommendation_tpu_torch.data.interaction import Interaction
    from recommendation_tpu_torch.models import registry
    from recommendation_tpu_torch.train.recommender import GraphRecommender

    rec = GraphRecommender(registry.build(model_name, config), Interaction(train, test), config,
                           device=device)
    rec.print_model_info()
    rec.build()
    rec.train()
    return rec


def build_service(model_name: str, checkpoint, config, train, test, device="cuda"):
    """Interaction → DeviceGraph → parameters → eval embeddings (the layer
    chain) → RecommenderService: the serving path. The parameters come from
    ``checkpoint``: an ``.npz`` of ``weights.save_params``, a directory of
    ``CheckpointManager`` checkpoints (its newest), or, when it is None,
    training first."""
    from recommendation_tpu_torch.data.interaction import Interaction
    from recommendation_tpu_torch.graph.device import DeviceGraph
    from recommendation_tpu_torch.models import registry
    from recommendation_tpu_torch.serve.service import RecommenderService
    from recommendation_tpu_torch.weights import load_params

    if checkpoint is None:
        return RecommenderService.from_recommender(
            train_recommender(model_name, config, train, test, device=device))
    if os.path.isdir(checkpoint):
        from recommendation_tpu_torch.train.recommender import GraphRecommender

        # restore-only start-up: no training pass
        config = config.with_overrides(**{"checkpoint.dir": checkpoint,
                                          "checkpoint.resume": True, "max.epoch": 0})
        rec = GraphRecommender(registry.build(model_name, config), Interaction(train, test),
                               config, device=device)
        rec.build()
        if rec.start_epoch == 0:
            raise FileNotFoundError(f"no checkpoint found in {checkpoint}")
        return RecommenderService.from_recommender(rec)
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
    t = sub.add_parser("train", help="train a model and print its test metrics")
    s = sub.add_parser("serve", help="serve top-k over HTTP (trains first without --checkpoint)")
    for p in (t, s):
        p.add_argument("--model", required=True, help="a name that `models` lists")
        p.add_argument("--train")
        p.add_argument("--test")
        p.add_argument("--set", action="append", help="config override key=value")
        p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    t.add_argument("--out", help="write the config and metrics as JSON here")
    s.add_argument("--checkpoint",
                   help="parameters saved by weights.save_params (.npz) or a checkpoint directory")
    s.add_argument("--host", default="127.0.0.1")
    s.add_argument("--port", type=int, default=8080)
    args = ap.parse_args(argv)

    if args.cmd == "models":
        from recommendation_tpu_torch.models import registry

        print("\n".join(registry.available()))
        return 0

    from recommendation_tpu_torch.config import default_config

    config = default_config(**_parse_sets(args.set))
    train, test = _load_sets(args)

    if args.cmd == "train":
        rec = train_recommender(args.model, config, train, test, device=args.device)
        metrics = rec.evaluate()
        print(json.dumps(metrics))
        if args.out:
            from recommendation_tpu_torch.utils.logging import save_json

            save_json(args.out, {"config": config.as_dict(), "metrics": metrics})
        return 0

    if args.checkpoint and not os.path.exists(args.checkpoint):
        print(f"error: checkpoint not found: {args.checkpoint}", file=sys.stderr)
        return 2
    from recommendation_tpu_torch.serve.http import serve_http

    try:
        service = build_service(args.model, args.checkpoint, config, train, test,
                                device=args.device)
    except FileNotFoundError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    print(f"serving on http://{args.host}:{args.port}  (GET /recommend?user=<id>&k=10)")
    serve_http(service, host=args.host, port=args.port)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
