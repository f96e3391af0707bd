"""recommendation_tpu_torch — the PyTorch/CUDA port of ``recommendation_tpu``.

A second package beside the JAX one, which stays as the reference. Module
paths mirror the JAX package's, so each counterpart is found under the same
name. The port imports torch and never JAX or the JAX package: host-side
modules it needs are copied here.

Ported so far (ROADMAP.md lists what comes next):
  config.py, data/        config, triple I/O, Interaction, synthetic data
  graph/device.py         DeviceGraph: positives, R̂, sampler tables, the
                          normalized adjacencies (dense, bucketed, segment),
                          the re-normalized bipartite adjacency under a
                          keep-mask, the bipartite segment views, GAT's slot
                          maps
  graph/bucketed.py       the large-graph backend's pull tables and chain
  graph/augment.py        edge dropout and feature masking on the device
  models/                 Model, registry, LightGCN, NCL, DirectAU, SelfCF,
                          BUIR, SSL4Rec, GCL, GRACE, G-BT, BGRL, GraphSAGE,
                          GAT
  ops/                    the kernels' wrappers (K1-K4 prop.py, K5/K6
                          lse.py, K7/P1 gather.py, S1-S3 segment.py),
                          adj_matmul and the segment reductions, k-means,
                          row gathers, masked top-k
  losses.py               the models' losses
  sampling.py             epoch permutation and negative sampling
  train/                  step loop, optimizers, bold driver, checkpoints,
                          GraphRecommender
  evalx/                  ranking metrics and evaluation
  serve/                  RecommenderService, MicroBatcher, HTTP front end
  weights.py              parameter, state and Adam-state import from the
                          JAX package (nested trees as dotted names), .npz I/O
  utils/logging.py        Log
  cli.py                  python -m recommendation_tpu_torch models|train|serve
"""

__version__ = "0.1.0"
