"""Minimal end-to-end example on the PyTorch/CUDA port: train LightGCN-BPR
and print ranking metrics (the port's counterpart of
``examples/train_lightgcn.py``).

Run: python examples/torch_train_lightgcn.py [--device cpu] [--set key=value ...]
         [path/to/train.txt path/to/test.txt]
Without files it uses the cached synthetic ML-100K-shaped dataset. The
epochs run as CUDA graphs on the card; ``--device cpu`` runs them eagerly.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from recommendation_tpu_torch.cli import _parse_sets
from recommendation_tpu_torch.config import default_config
from recommendation_tpu_torch.data.interaction import Interaction
from recommendation_tpu_torch.data.io import load_data
from recommendation_tpu_torch.data.synthetic import load_or_make_dataset
from recommendation_tpu_torch.models import build
from recommendation_tpu_torch.train.recommender import GraphRecommender


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("files", nargs="*", help="train.txt test.txt")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--set", action="append", default=[], help="config key=value")
    args = ap.parse_args(argv)
    if len(args.files) >= 2:
        data = Interaction(load_data(args.files[0]), load_data(args.files[1]))
    else:
        data = Interaction(*load_or_make_dataset())
    config = default_config(**{
        "max.epoch": 20,
        "embedding.size": 64,
        "batch.size": 2048,
        "LightGCN.n_layers": 3,
        "eval.interval": 5,
        "early.stopping.patience": 3,
        **_parse_sets(args.set),
    })
    rec = GraphRecommender(build("lightgcn", config), data, config, device=args.device)
    metrics = rec.execute()
    print(metrics)
    return metrics


if __name__ == "__main__":
    main()
