"""Hyperparameter sweep example on the PyTorch/CUDA port: a DirectAU grid
with result artifacts (the port's counterpart of
``examples/tune_directau.py``).

Run: python examples/torch_tune_directau.py [--device cpu] [--set key=value ...]
         [--train train.txt --test test.txt] [--out results/directau_tune.json]
Without files it uses the cached synthetic ML-100K-shaped dataset.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from recommendation_tpu_torch.cli import _parse_sets
from recommendation_tpu_torch.config import default_config
from recommendation_tpu_torch.data.io import load_data
from recommendation_tpu_torch.data.synthetic import load_or_make_dataset
from recommendation_tpu_torch.tune import GridTuner, print_summary


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--train", default=None)
    ap.add_argument("--test", default=None)
    ap.add_argument("--out", default="results/directau_tune.json")
    ap.add_argument("--set", action="append", default=[], help="base config key=value")
    args = ap.parse_args(argv)
    if args.train:
        train, test = load_data(args.train), load_data(args.test)
    else:
        train, test = load_or_make_dataset()
    tuner = GridTuner(
        "directau",
        train,
        test,
        grid={
            "DirectAU.gamma": [0.5, 1.0, 3.0],
            "learning.rate": [1e-3, 5e-3],
        },
        base_config=default_config(**{
            "max.epoch": 3,
            "embedding.size": 64,
            "item.ranking.topN": [10, 20],
            "eval.interval": 3,
            **_parse_sets(args.set),
        }),
        device=args.device,
    )
    tuner.run()
    print_summary(tuner.results, Ns=[20])
    tuner.save_json(args.out)
    return tuner.results


if __name__ == "__main__":
    main()
