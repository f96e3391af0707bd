"""Social model + sharded training example on the PyTorch/CUDA port: MHCN on
a (data, model) mesh (the port's counterpart of
``examples/train_social_multichip.py``).

One process a rank. On cards, one rank a card over NCCL (each epoch a
CUDA graph with its collectives inside; run on one card at (1, 1), where
``chip_smoke.py`` holds MHCN's captured epochs to its eager ones; the
layouts over several cards are written for but not yet run on cards):
  torchrun --nproc-per-node=4 examples/torch_train_social_multichip.py
On the CPU, over gloo:
  torchrun --nproc-per-node=2 examples/torch_train_social_multichip.py --device cpu
``--mesh DATAxMODEL`` picks the layout (default: ``default_mesh_shape`` of
the world); ``--set key=value`` overrides the configuration; ``--train``
and ``--test`` read files in place of the cached synthetic ML-100K-shaped
dataset. Every rank prints the metrics.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch.distributed as dist

from recommendation_tpu_torch.cli import _parse_sets
from recommendation_tpu_torch.config import default_config
from recommendation_tpu_torch.data.interaction import Interaction
from recommendation_tpu_torch.data.io import load_data
from recommendation_tpu_torch.data.social import synthesize_social
from recommendation_tpu_torch.data.synthetic import load_or_make_dataset
from recommendation_tpu_torch.graph.social_device import SocialDeviceGraph
from recommendation_tpu_torch.models import build
from recommendation_tpu_torch.parallel.distributed import initialize
from recommendation_tpu_torch.parallel.mesh import MeshSpec, make_mesh
from recommendation_tpu_torch.parallel.trainer import ShardedGraphRecommender


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--mesh", default=None, help="DATAxMODEL (default: the world's shape)")
    ap.add_argument("--train", default=None)
    ap.add_argument("--test", default=None)
    ap.add_argument("--set", action="append", default=[], help="config key=value")
    args = ap.parse_args(argv)
    device = initialize("gloo" if args.device == "cpu" else "nccl", args.device)
    try:
        if args.train:
            data = Interaction(load_data(args.train), load_data(args.test))
        else:
            data = Interaction(*load_or_make_dataset())
        social = synthesize_social(data)  # test.ipynb protocol (θ=0.35 ∪ top-10)
        config = default_config(**{
            "max.epoch": 5,
            "embedding.size": 64,
            "MHCN.n_layer": 2,
            "eval.interval": 5,
            **_parse_sets(args.set),
        })
        graph = SocialDeviceGraph(data, social, backend=config.get("graph.backend", "auto"),
                                  device=device)
        spec = MeshSpec(*(int(v) for v in args.mesh.split("x"))) if args.mesh else None
        rec = ShardedGraphRecommender(build("mhcn", config), data, config, graph=graph,
                                      mesh=make_mesh(spec, device.type), device=device)
        metrics = rec.execute()  # collective: every rank trains and evaluates
        print(f"rank {dist.get_rank()}: epochs {rec.epoch_report()['epochs']} "
              f"({rec.epoch_report()['why']}); {metrics}")
        return metrics
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
