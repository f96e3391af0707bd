"""Recall@20 by epoch of the dense-path zoo and the neighbour models
(GraphSAGE, GAT) on the hard set, in the port and in the JAX package, on
the CPU, at ``chip_smoke.py``'s zoo settings (d=64, B=2048, Adam 1e-3, f32,
each model at its defaults): how ``chip_smoke.ZOO_EPOCHS``, ``ZOO_GATES``,
``NEIGHBOR_EPOCHS`` and ``NEIGHBOR_GATES`` were chosen.

    JAX_PLATFORMS=cpu python tools/zoo_gate_calibration.py [--models selfcf,gat] [--epochs N]

Prints one JSON line per model and package: the untrained tables' Recall@20,
then the reading after each epoch and the epoch losses (the port's), for
the model's epochs in ``chip_smoke.py`` (or ``--epochs``). The two packages
draw different masks and initial tables, so their readings agree in tier,
not in digits.
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def port_run(name, epochs, data):
    from recommendation_tpu_torch.config import default_config
    from recommendation_tpu_torch.models import build
    from recommendation_tpu_torch.train.recommender import GraphRecommender
    from recommendation_tpu_torch.utils.logging import Log

    cfg = default_config(**{"embedding.size": 64, "batch.size": 2048, "learning.rate": 1e-3,
                            "optimizer": "adam", "max.epoch": epochs, "eval.interval": 1,
                            "item.ranking.topN": [20]})
    rec = GraphRecommender(build(name, cfg), data, cfg, log=Log(echo=False), device="cpu")
    rec.build()
    untrained = rec.test().metrics["Recall@20"]
    rec.train()
    return {"untrained": untrained, "recall@20_by_epoch": [h["Recall@20"] for h in rec.history],
            "epoch_losses": [e["loss"] for e in rec.epoch_stats]}


def jax_run(name, epochs, train, test):
    import jax

    jax.config.update("jax_platforms", "cpu")
    from recommendation_tpu.config import default_config
    from recommendation_tpu.data.interaction import Interaction
    from recommendation_tpu.models import get_model
    from recommendation_tpu.train.recommender import GraphRecommender
    from recommendation_tpu.utils.logging import Log

    cfg = default_config(**{"embedding.size": 64, "batch.size": 2048, "learning.rate": 1e-3,
                            "optimizer": "adam", "max.epoch": epochs, "eval.interval": 1,
                            "item.ranking.topN": [20]})
    rec = GraphRecommender(get_model(name, cfg), Interaction(train, test), cfg,
                           log=Log(echo=False))
    rec.build()
    untrained = rec.test().metrics["Recall@20"]
    rec.train()
    return {"untrained": untrained, "recall@20_by_epoch": [h["Recall@20"] for h in rec.history]}


def main():
    from chip_smoke import NEIGHBOR_EPOCHS, NEIGHBOR_GATES, ZOO_EPOCHS, ZOO_GATES, ZOO_MODELS
    from recommendation_tpu_torch.data.interaction import Interaction
    from recommendation_tpu_torch.data.synthetic import make_hard_dataset

    ap = argparse.ArgumentParser()
    ap.add_argument("--models", default=",".join(ZOO_MODELS))
    ap.add_argument("--packages", default="port,jax")
    ap.add_argument("--epochs", type=int, help="epochs of every run (default: chip_smoke's)")
    args = ap.parse_args()
    epochs_of, gates = {**ZOO_EPOCHS, **NEIGHBOR_EPOCHS}, {**ZOO_GATES, **NEIGHBOR_GATES}
    train, test = make_hard_dataset()
    data = Interaction(train, test)
    for name in args.models.split(","):
        epochs = args.epochs or epochs_of[name]
        for package in args.packages.split(","):
            run = (port_run(name, epochs, data) if package == "port"
                   else jax_run(name, epochs, train, test))
            print(json.dumps({"model": name, "package": package, "epochs": epochs,
                              "gate": gates[name], **run}), flush=True)


if __name__ == "__main__":
    main()
