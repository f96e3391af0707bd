"""recommendation_tpu_torch — the PyTorch/CUDA port of ``recommendation_tpu``.

A second package beside the JAX one, which stays as the reference. Module
paths mirror the JAX package's, so each counterpart is found under the same
name. The port imports torch and never JAX or the JAX package: host-side
modules it needs are copied here.

Ported so far (serving and training LightGCN on the dense backend):
  config.py, data/        config, triple I/O, Interaction, synthetic data
  graph/device.py         DeviceGraph: positives, R̂, sampler tables
  models/                 Model, registry, LightGCN (loss and eval paths)
  ops/prop.py             the dense layer chain: CUDA kernels K1 (forward)
                          and K2 (backward), plain versions, ChainMean
  ops/rows.py, losses.py  batch row gathers, BPR/BCE/pointwise/L2 losses
  sampling.py             epoch permutation and negative sampling
  train/                  step loop, optimizers, bold driver, checkpoints,
                          GraphRecommender
  ops/topk.py             masked full-catalog top-k
  evalx/                  ranking metrics and evaluation
  serve/                  RecommenderService, MicroBatcher, HTTP front end
  weights.py              parameter and Adam-state import from the JAX
                          package, .npz I/O
  utils/logging.py        Log
  cli.py                  python -m recommendation_tpu_torch models|train|serve
"""

__version__ = "0.1.0"
