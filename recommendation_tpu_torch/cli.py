"""Command-line entry of the port.

  python -m recommendation_tpu_torch models
  python -m recommendation_tpu_torch train --model MODEL [--train T --test T] \\
      [--social S] [--set key=value ...] [--out RESULT.json] [--device cuda|cpu]
  python -m recommendation_tpu_torch serve --model MODEL \\
      [--checkpoint PARAMS.npz | CHECKPOINT_DIR] [--device cuda|cpu] \\
      [--train T --test T] [--social S] [--set graph.compute_dtype=bfloat16] \\
      [--host H --port P]
  python -m recommendation_tpu_torch synthesize-social --train T [--out S] \\
      [--threshold 0.35] [--top-k 10]
  python -m recommendation_tpu_torch tune --model MODEL [--mode grid|univariate] \\
      [--grid key=v1,v2 ...] [--preset] [--resume] [--out R.json] [--csv R.csv] \\
      [--train T --test T] [--social S] [--set key=value ...] [--device cuda|cpu]

``models`` lists the ported models: ``lightgcn``, ``ncl``, ``directau``,
``selfcf``, ``buir``, ``ssl4rec``, ``gcl`` (alias ``grace_rec``),
``grace``, ``gbt``, ``bgrl`` (alias ``bgrl_g2l``), ``graphsage``, ``gat``
and the social models ``diffnet``, ``sept`` (alias ``sept_social``),
``sept_basic``, ``mhcn`` and ``esrf``. Each trains and serves on the dense, the bucketed (``--set
graph.backend=bucketed``, or ``auto`` past the dense threshold) and the
segment backend (``--set graph.backend=segment``; ``pallas`` runs the
segment path, as in the JAX package). GRACE and G-BT propagate over their
self-loop adjacency on the segment backend where the graph is bucketed;
GraphSAGE and GAT sum over the edges with the segment kernels on every
backend (GAT on the bucketed one over its bucket tables).
``train`` runs ``GraphRecommender.execute`` and prints the test metrics as
one JSON line (last on stdout), as the JAX package's CLI does. ``serve``
serves top-k over HTTP from parameters saved by ``weights.save_params``
(``.npz``), from the newest checkpoint in a directory written by
``train.checkpoint.CheckpointManager`` (``--set checkpoint.dir=DIR``
while training), or, without ``--checkpoint``, after training first.
Serving needs the parameters only: no model's eval embeddings read model
state (NCL's clusters serve training alone). Missing dataset
paths fall back to the cached synthetic ML-100K-shaped set, as in the JAX
package's CLI. The social models but ``sept_basic`` read their trust
triples (``trustor trustee [weight]`` lines) from ``--social``, else from
``social.txt`` beside the train file, else synthesize them
(``data.social.synthesize_social``, the test.ipynb protocol), and run on a
``SocialDeviceGraph``; ``synthesize-social`` writes such a file.
``tune`` runs a sweep (``tune/tuner.py``): a full grid over ``--grid``
entries, or one key at a time against defaults (``--mode univariate``);
``--preset`` takes the model's reference-script sweep (``tune/presets.py``),
explicit ``--grid`` entries overriding its keys; each configuration trains
and evaluates on one shared graph, a failing one is recorded with its
error and the sweep goes on; ``--out`` writes the results JSON, which
``--resume`` reads back to skip what it recorded; ``--csv`` appends them
as CSV; the summary (best configuration per metric) closes the output.
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


def _parse_grid(entries):
    grid = {}
    for e in entries or []:
        k, _, vs = e.partition("=")
        grid[k] = [_parse_value(v) for v in vs.split(",")]
    return grid


def _load_sets(args):
    from recommendation_tpu_torch.data.io import load_data
    from recommendation_tpu_torch.data.synthetic import load_or_make_dataset

    if args.train and os.path.exists(args.train):
        train = load_data(args.train)
        test = load_data(args.test) if args.test else []
        return train, test, args.train
    train, test = load_or_make_dataset()
    return train, test, "dataset/synthetic_ml100k/train.txt"


# the models that need trust triples (a SocialDeviceGraph); sept_basic does not
SOCIAL_MODELS = ("sept", "sept_social", "mhcn", "diffnet", "esrf")


def _maybe_social(args, model_name, train, test, train_path):
    """The trust triples of a social model (None for the others): from
    ``--social``, else ``social.txt`` beside the train file, else
    synthesized from the interactions."""
    if model_name.lower() not in SOCIAL_MODELS:
        return None
    from recommendation_tpu_torch.data.io import load_data

    if args.social and os.path.exists(args.social):
        return load_data(args.social)
    default = os.path.join(os.path.dirname(train_path), "social.txt")
    if os.path.exists(default):
        return load_data(default)
    from recommendation_tpu_torch.data.interaction import Interaction
    from recommendation_tpu_torch.data.social import synthesize_social

    print("no social.txt found — synthesizing (test.ipynb protocol)", file=sys.stderr)
    return synthesize_social(Interaction(train, test))


def make_graph(data, config, device="cuda", social=None):
    """The graph a model trains and serves on: a ``SocialDeviceGraph`` over
    the trust triples ``social``, else a ``DeviceGraph``, on the configured
    backend and compute dtype."""
    kw = dict(backend=config.get("graph.backend", "auto"),
              compute_dtype=config.get("graph.compute_dtype", "float32"), device=device)
    if social is None:
        from recommendation_tpu_torch.graph.device import DeviceGraph

        return DeviceGraph(data, **kw)
    from recommendation_tpu_torch.graph.social_device import SocialDeviceGraph

    return SocialDeviceGraph(data, social, **kw)


def train_recommender(model_name: str, config, train, test, device="cuda", social=None):
    """Interaction → DeviceGraph (a SocialDeviceGraph with trust triples
    ``social``) → GraphRecommender, built and trained: the training path."""
    from recommendation_tpu_torch.data.interaction import Interaction
    from recommendation_tpu_torch.models import registry
    from recommendation_tpu_torch.train.recommender import GraphRecommender

    data = Interaction(train, test)
    rec = GraphRecommender(registry.build(model_name, config), data, config,
                           graph=make_graph(data, config, device, social), device=device)
    rec.print_model_info()
    rec.build()
    rec.train()
    return rec


def build_service(model_name: str, checkpoint, config, train, test, device="cuda",
                  social=None):
    """Interaction → DeviceGraph (a SocialDeviceGraph with trust triples
    ``social``) → parameters → eval embeddings (the layer chain) →
    RecommenderService: the serving path. The parameters come from
    ``checkpoint``: an ``.npz`` of ``weights.save_params``, a directory of
    ``CheckpointManager`` checkpoints (its newest), or, when it is None,
    training first."""
    from recommendation_tpu_torch.data.interaction import Interaction
    from recommendation_tpu_torch.models import registry
    from recommendation_tpu_torch.serve.service import RecommenderService
    from recommendation_tpu_torch.weights import load_params

    if checkpoint is None:
        return RecommenderService.from_recommender(
            train_recommender(model_name, config, train, test, device=device, social=social))
    data = Interaction(train, test)
    graph = make_graph(data, config, device, social)
    if os.path.isdir(checkpoint):
        from recommendation_tpu_torch.train.recommender import GraphRecommender

        # restore-only start-up: no training pass
        config = config.with_overrides(**{"checkpoint.dir": checkpoint,
                                          "checkpoint.resume": True, "max.epoch": 0})
        rec = GraphRecommender(registry.build(model_name, config), data, config, graph=graph,
                               device=device)
        rec.build()
        if rec.start_epoch == 0:
            raise FileNotFoundError(f"no checkpoint found in {checkpoint}")
        return RecommenderService.from_recommender(rec)
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
        p.add_argument("--social", help="trust triples `trustor trustee [weight]` (social "
                                        "models; default: social.txt beside --train)")
        p.add_argument("--set", action="append", help="config override key=value")
        p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    t.add_argument("--out", help="write the config and metrics as JSON here")
    s.add_argument("--checkpoint",
                   help="parameters saved by weights.save_params (.npz) or a checkpoint directory")
    s.add_argument("--host", default="127.0.0.1")
    s.add_argument("--port", type=int, default=8080)
    u = sub.add_parser("tune", help="a hyperparameter sweep: a grid or one key at a time")
    u.add_argument("--model", required=True, help="a name that `models` lists")
    u.add_argument("--train")
    u.add_argument("--test")
    u.add_argument("--social", help="trust triples (social models)")
    u.add_argument("--set", action="append", help="config override key=value")
    u.add_argument("--out", help="results JSON path")
    u.add_argument("--mode", choices=["grid", "univariate"], default="grid")
    u.add_argument("--grid", action="append", help="key=v1,v2,...")
    u.add_argument("--preset", action="store_true",
                   help="use the model's reference-script sweep preset")
    u.add_argument("--resume", action="store_true",
                   help="skip configurations already recorded in --out")
    u.add_argument("--csv", help="also append results to CSV")
    u.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    y = sub.add_parser("synthesize-social",
                       help="build social.txt from train interactions (test.ipynb protocol)")
    y.add_argument("--train", required=True)
    y.add_argument("--out", help="default: social.txt next to the train file")
    y.add_argument("--threshold", type=float, default=0.35)
    y.add_argument("--top-k", type=int, default=10)
    args = ap.parse_args(argv)

    if args.cmd == "models":
        from recommendation_tpu_torch.models import registry

        print("\n".join(registry.available()))
        return 0

    if args.cmd == "synthesize-social":
        return _synthesize_social(args)

    from recommendation_tpu_torch.config import default_config

    config = default_config(**_parse_sets(args.set))
    train, test, train_path = _load_sets(args)
    social = _maybe_social(args, args.model, train, test, train_path)

    if args.cmd == "tune":
        return _tune(args, config, train, test, social)

    if args.cmd == "train":
        rec = train_recommender(args.model, config, train, test, device=args.device,
                                social=social)
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
                                device=args.device, social=social)
    except FileNotFoundError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    print(f"serving on http://{args.host}:{args.port}  (GET /recommend?user=<id>&k=10)")
    serve_http(service, host=args.host, port=args.port)
    return 0


def _tune(args, config, train, test, social) -> int:
    """``tune``: the sweep (``--preset``'s, its grid overridden key by key
    by ``--grid``), its summary, and the results JSON and CSV."""
    from recommendation_tpu_torch.tune import GridTuner, UnivariateTuner, print_summary

    grid = _parse_grid(args.grid)
    mode, defaults = args.mode, {}
    if args.preset:
        from recommendation_tpu_torch.tune.presets import get_preset

        preset = get_preset(args.model)
        mode = preset["mode"]
        defaults = dict(preset.get("defaults", {}))
        grid = {**preset["grid"], **grid}  # an explicit --grid overrides the preset
    kw = dict(base_config=config, social_triples=social, device=args.device)
    if mode == "grid":
        tuner = GridTuner(args.model, train, test, grid, **kw)
    else:
        tuner = UnivariateTuner(args.model, train, test, grid, defaults=defaults, **kw)
    tuner.run(resume_path=args.out if args.resume else None)
    print_summary(tuner.results, Ns=config.get("item.ranking.topN", [10, 20, 30, 50]))
    if args.out:
        tuner.save_json(args.out)
    if args.csv:
        tuner.save_csv(args.csv)
    return 0


def _synthesize_social(args) -> int:
    """``synthesize-social``: trust triples from the train file's user-user
    cosine similarity, one ``u v w`` line each (the JAX command's file)."""
    from recommendation_tpu_torch.data.interaction import Interaction
    from recommendation_tpu_torch.data.io import load_data
    from recommendation_tpu_torch.data.social import synthesize_social

    if not os.path.exists(args.train):
        print(f"error: train file not found: {args.train}", file=sys.stderr)
        return 2
    data = Interaction(load_data(args.train), [])
    triples = synthesize_social(data, threshold=args.threshold, top_k=args.top_k)
    out = args.out or os.path.join(os.path.dirname(args.train), "social.txt")
    with open(out, "w") as f:
        for u, v, w in triples:
            f.write(f"{u} {v} {w}\n")
    print(f"wrote {len(triples)} trust edges to {out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
