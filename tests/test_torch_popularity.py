"""The popularity bars of chip_smoke.py's quality gates against the JAX
package's popularity baseline, on the hard set (``make_hard_dataset()``,
the split the chip run's hard phase trains on).

The JAX reading ranks items by ``popularity_baseline_topk`` on the JAX
``DeviceGraph`` and scores them with the JAX ``ranking_metrics``: the same
list for every user, or, masked, each test user's first 20 items of that
order that are not train positives (as ``tests/test_lightgcn.py`` scores
it). The port's is ``chip_smoke.popularity_recall`` on the port's graph.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest

from recommendation_tpu.data.interaction import Interaction as JaxInteraction
from recommendation_tpu.data.synthetic import make_hard_dataset as jax_make_hard
from recommendation_tpu.evalx.metrics import ranking_metrics as jax_ranking_metrics
from recommendation_tpu.graph.device import DeviceGraph as JaxDeviceGraph
from recommendation_tpu.sampling import popularity_baseline_topk as jax_popularity_topk
from recommendation_tpu_torch.data.interaction import Interaction
from recommendation_tpu_torch.data.synthetic import make_hard_dataset
from recommendation_tpu_torch.graph.device import DeviceGraph

ROOT = Path(__file__).resolve().parents[1]

# Recall@20 of the hard set's popularity list, masked and not (numpy 2.0.2;
# the chip run's hard phase prints its own numpy version beside the same
# two bars)
HARD_POPULARITY = {True: 0.41560736278123006, False: 0.27945346180770386}


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _jax_popularity_recall(data, graph, masked, n=20):
    uids = data.test_user_ids()
    order = jax_popularity_topk(graph, graph.n_items if masked else n)
    pos = np.asarray(graph.user_positives)
    rows = []
    for u in uids:
        seen = set(pos[u][pos[u] >= 0].tolist()) if masked else set()
        rows.append(np.array([i for i in order if i not in seen][:n]))
    test_items = [np.array([data.item[i] for i in data.test_set[data.id2user[int(u)]]])
                  for u in uids]
    return jax_ranking_metrics(np.stack(rows), test_items, Ns=[n])[f"Recall@{n}"]


@pytest.mark.parametrize("masked", [True, False], ids=["masked", "unmasked"])
def test_hard_set_popularity_bar_matches_jax(masked):
    """The hard phase's bar: the port's reading equals the JAX package's on
    the same split, and both equal the pinned value."""
    train, test = make_hard_dataset()
    assert (train, test) == jax_make_hard()
    jax_data = JaxInteraction(train, test)
    want = _jax_popularity_recall(jax_data, JaxDeviceGraph(jax_data), masked)
    data = Interaction(train, test)
    got = _chip_smoke().popularity_recall(data, DeviceGraph(data, device="cpu"), 20,
                                          masked=masked)
    assert got == pytest.approx(want, rel=1e-12, abs=0)
    assert want == pytest.approx(HARD_POPULARITY[masked], rel=1e-12, abs=0)
