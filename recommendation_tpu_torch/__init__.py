"""recommendation_tpu_torch — the PyTorch/CUDA port of ``recommendation_tpu``.

A second package beside the JAX one, which stays as the reference. Module
paths mirror the JAX package's, so each counterpart is found under the same
name. The port imports torch and never JAX or the JAX package: host-side
modules it needs are copied here.

Ported so far (serving LightGCN on the dense backend):
  config.py, data/        config, triple I/O, Interaction, synthetic data
  graph/device.py         DeviceGraph, serving subset (positives, R̂)
  models/                 Model, registry, LightGCN (eval path)
  ops/prop.py             the dense layer chain: CUDA kernel + plain version
  ops/topk.py             masked full-catalog top-k
  evalx/                  ranking metrics and evaluation
  serve/                  RecommenderService, MicroBatcher, HTTP front end
  weights.py              parameter import from the JAX package, .npz I/O
  cli.py                  python -m recommendation_tpu_torch models|serve
"""

__version__ = "0.1.0"
