"""Recall@20 by epoch of the dense-path zoo, the neighbour models
(GraphSAGE, GAT) and the social models on the hard set, in the port and in
the JAX package, on the CPU, at ``chip_smoke.py``'s zoo settings (d=64,
B=2048, Adam 1e-3, f32, each model at its defaults): how
``chip_smoke.ZOO_EPOCHS``, ``ZOO_GATES``, ``NEIGHBOR_EPOCHS``,
``NEIGHBOR_GATES``, ``SOCIAL_EPOCHS`` and ``SOCIAL_GATES`` were chosen.

    JAX_PLATFORMS=cpu python tools/zoo_gate_calibration.py [--models selfcf,gat] [--epochs N]
    JAX_PLATFORMS=cpu python tools/zoo_gate_calibration.py --social [--models diffnet,esrf]

``--social`` runs the social models (default: all six names) on a
``SocialDeviceGraph`` in each package over the same trust triples
(``synthesize_social`` of the hard set, the port's copy).

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


def port_run(name, epochs, data, social=None):
    from recommendation_tpu_torch.config import default_config
    from recommendation_tpu_torch.models import build
    from recommendation_tpu_torch.train.recommender import GraphRecommender
    from recommendation_tpu_torch.utils.logging import Log

    cfg = default_config(**{"embedding.size": 64, "batch.size": 2048, "learning.rate": 1e-3,
                            "optimizer": "adam", "max.epoch": epochs, "eval.interval": 1,
                            "item.ranking.topN": [20]})
    graph = None
    if social is not None:
        from recommendation_tpu_torch.graph.social_device import SocialDeviceGraph

        graph = SocialDeviceGraph(data, social, device="cpu")
    rec = GraphRecommender(build(name, cfg), data, cfg, graph=graph, log=Log(echo=False),
                           device="cpu")
    rec.build()
    untrained = rec.test().metrics["Recall@20"]
    rec.train()
    return {"untrained": untrained, "recall@20_by_epoch": [h["Recall@20"] for h in rec.history],
            "epoch_losses": [e["loss"] for e in rec.epoch_stats]}


def jax_run(name, epochs, train, test, social=None):
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
    data = Interaction(train, test)
    graph = None
    if social is not None:
        from recommendation_tpu.graph.social_device import SocialDeviceGraph

        graph = SocialDeviceGraph(data, social)
    rec = GraphRecommender(get_model(name, cfg), data, cfg, graph=graph, log=Log(echo=False))
    rec.build()
    untrained = rec.test().metrics["Recall@20"]
    rec.train()
    return {"untrained": untrained, "recall@20_by_epoch": [h["Recall@20"] for h in rec.history]}


def main():
    from chip_smoke import (
        NEIGHBOR_EPOCHS,
        NEIGHBOR_GATES,
        SOCIAL_EPOCHS,
        SOCIAL_GATES,
        SOCIAL_MODELS,
        ZOO_EPOCHS,
        ZOO_GATES,
        ZOO_MODELS,
    )
    from recommendation_tpu_torch.data.interaction import Interaction
    from recommendation_tpu_torch.data.social import synthesize_social
    from recommendation_tpu_torch.data.synthetic import make_hard_dataset

    ap = argparse.ArgumentParser()
    ap.add_argument("--models")
    ap.add_argument("--packages", default="port,jax")
    ap.add_argument("--epochs", type=int, help="epochs of every run (default: chip_smoke's)")
    ap.add_argument("--social", action="store_true",
                    help="the social models, on a SocialDeviceGraph in each package")
    args = ap.parse_args()
    epochs_of = {**ZOO_EPOCHS, **NEIGHBOR_EPOCHS, **SOCIAL_EPOCHS}
    gates = {**ZOO_GATES, **NEIGHBOR_GATES, **SOCIAL_GATES}
    models = args.models or ",".join(SOCIAL_MODELS if args.social else ZOO_MODELS)
    train, test = make_hard_dataset()
    data = Interaction(train, test)
    social = synthesize_social(data) if args.social else None
    for name in models.split(","):
        epochs = args.epochs or epochs_of[name]
        for package in args.packages.split(","):
            run = (port_run(name, epochs, data, social) if package == "port"
                   else jax_run(name, epochs, train, test, social))
            print(json.dumps({"model": name, "package": package, "epochs": epochs,
                              "gate": gates[name], **run}), flush=True)


if __name__ == "__main__":
    main()
