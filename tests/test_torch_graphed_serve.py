"""The score block as CUDA graphs (``ops.topk.ScoreBlock``) on the CPU,
where its bodies run eagerly: the padding that fixes a graph's shape is
the JAX package's (``recommendation_tpu/ops/topk.py::_pow2_bucket``, the
service's wave rule in ``recommendation_tpu/serve/service.py``), and the
padded service answers what the JAX ``RecommenderService`` answers on the
same tables, on both of its branches (the graph's positives table, the
host CSR with a power-of-two width), with and without exclusions, at wave
sizes on both sides of each cut. The graphs themselves (a replay against
the eager block, bit for bit) need the card: ``tests/test_torch_card.py``.

Scores agree within 1e-6 (the same f32 tables, an f32 dot product over
d = 64 in another order); ids are compared wherever scores are separated
(``topk_agree``).
"""

import copy

import jax
import numpy as np
import pytest
import torch

from recommendation_tpu.config import default_config as jax_default_config
from recommendation_tpu.graph.device import DeviceGraph as JaxDeviceGraph
from recommendation_tpu.models.lightgcn import LightGCN as JaxLightGCN
from recommendation_tpu.ops.topk import _pow2_bucket as jax_pow2_bucket
from recommendation_tpu.serve.service import RecommenderService as JaxRecommenderService
from recommendation_tpu_torch.data.interaction import Interaction
from recommendation_tpu_torch.evalx.ranking import evaluate_ranking
from recommendation_tpu_torch.graph.device import DeviceGraph
from recommendation_tpu_torch.ops.topk import ScoreBlock, pow2_bucket, topk_agree, wave_rows
from recommendation_tpu_torch.serve.service import RecommenderService

SIZES = (1, 2, 3, 16, 17, 1023, 1024, 1025, 2100)
SCORE_TOL = 1e-6
K = 10


def _without_table(graph):
    """A shallow copy of ``graph`` that serves as a graph without the
    positives table (the host-CSR branch of both services)."""
    out = copy.copy(graph)
    out.has_pos_table = False
    return out


@pytest.fixture(scope="module")
def services(tiny_data):
    """The JAX services (positives table, host CSR) on LightGCN's tables
    and the port's on the same tables, and each JAX answer: a wave of
    random users at each of SIZES, with and without exclusions."""
    jax_graph = JaxDeviceGraph(tiny_data, backend="dense")
    model = JaxLightGCN(jax_default_config())
    params, state = model.init(jax.random.PRNGKey(0), jax_graph)
    ju, ji = (np.asarray(t) for t in model.eval_embeddings(params, state, jax_graph))
    data = Interaction(tiny_data.training_data, tiny_data.test_data)
    graph = DeviceGraph(data, device="cpu")
    u, i = torch.from_numpy(ju.copy()), torch.from_numpy(ji.copy())
    pairs = {"table": (JaxRecommenderService(ju, ji, tiny_data, jax_graph),
                       RecommenderService(u, i, data, graph)),
             "host_csr": (JaxRecommenderService(ju, ji, tiny_data, _without_table(jax_graph)),
                          RecommenderService(u, i, data, _without_table(graph)))}
    rng = np.random.default_rng(5)
    waves = {b: rng.integers(0, data.user_num, b).tolist() for b in SIZES}
    answers = {}
    for branch, (jax_service, _) in pairs.items():
        for exclude in (True, False):
            for b, uids in waves.items():
                s, ids = jax_service._recommend_ids_device(uids, K, exclude)
                answers[branch, exclude, b] = (np.asarray(s), np.asarray(ids))
    return {"pairs": pairs, "waves": waves, "answers": answers, "data": data, "graph": graph,
            "tables": (u, i)}


@pytest.mark.parametrize("b", SIZES)
def test_block_and_wave_rows_are_the_jax_packages(b):
    """The rows of a padded wave (user 0 repeated) and of a padded block
    are the JAX service's and ``_pow2_bucket``'s."""
    assert wave_rows(b) == jax_pow2_bucket(max(b, 1), max(1024, b))
    assert pow2_bucket(b, 1024) == jax_pow2_bucket(b, 1024)
    assert pow2_bucket(b, 2 ** 20) == jax_pow2_bucket(b, 2 ** 20)


@pytest.mark.parametrize("branch", ["table", "host_csr"])
@pytest.mark.parametrize("exclude", [True, False], ids=["exclude_seen", "all_items"])
def test_padded_service_is_the_jax_service(services, branch, exclude):
    """At every size the port's padded wave answers the JAX service's
    padded wave: the same scores within SCORE_TOL, the same ids where the
    scores are separated; every block went through the service's
    ``ScoreBlock`` at a padded shape (host positives at a power-of-two
    width)."""
    _, ours = services["pairs"][branch]
    for b, uids in services["waves"].items():
        s, ids = ours._recommend_ids_device(uids, K, exclude)
        want_s, want_ids = services["answers"][branch, exclude, b]
        assert s.shape == (b, K) and ids.shape == (b, K) and ids.dtype == np.int32
        assert s.dtype == np.float32 and np.isfinite(s).all()
        assert topk_agree(s, ids, want_s, want_ids, SCORE_TOL), (branch, exclude, b)
    want_width = {"none": 1, "table": services["graph"].user_positives.shape[1]}
    for source, rows, width, k, positives in ours.block.keys:
        assert source == "ids" and rows == pow2_bucket(rows, 1024) and k == K
        if positives == "host":
            assert width == pow2_bucket(width, services["data"].item_num)
        else:
            assert width == want_width[positives]
    mode = "none" if not exclude else "table" if branch == "table" else "host"
    assert mode in {key[4] for key in ours.block.keys}


def test_random_waves_make_at_most_eleven_graphs(services):
    """200 random wave sizes up to 1,024 meet at most log2(1024) + 1 = 11
    padded shapes for each (k, positives width): each a graph on the card,
    as the JAX package's jit cache holds at most 11 programs."""
    u, i = services["tables"]
    for graph in (services["graph"], _without_table(services["graph"])):
        service = RecommenderService(u, i, services["data"], graph)
        rng = np.random.default_rng(1)
        for b in rng.integers(1, 1025, 200):
            k = int(rng.choice([5, 10]))
            service._recommend_ids_device(rng.integers(0, u.shape[0], b).tolist(), k,
                                          bool(rng.integers(0, 2)))
        by_shape = {}
        for key in service.block.keys:
            by_shape.setdefault((key[3], key[2]), set()).add(key[1])
        assert by_shape and all(len(rows) <= 11 for rows in by_shape.values())
        stats = service.block.stats
        assert stats["replays"] == 0 and stats["eager"] >= 200 and not service.block.captures


def test_evaluation_blocks_are_padded_to_the_jax_shapes(services):
    """The evaluator's blocks of ``batch_size`` users, the tail padded to a
    power of two (the JAX ``topk_with_exclusions``'), through the graph's
    one ``ScoreBlock``; an explicit eager block gives the same result."""
    u, i = services["tables"]
    data, graph = services["data"], services["graph"]
    n_test = len(data.test_user_ids())
    block = ScoreBlock(i)
    got = evaluate_ranking(u, i, data, graph, Ns=(10,), batch_size=16, block=block)
    assert {key[1] for key in block.keys} == {16, jax_pow2_bucket(n_test % 16 or 16, 16)}
    eager = evaluate_ranking(u, i, data, graph, Ns=(10,), batch_size=16,
                             block=ScoreBlock(i, graphs=False))
    assert got.metrics == eager.metrics
    np.testing.assert_array_equal(got.top_ids, eager.top_ids)
    np.testing.assert_array_equal(got.top_scores, eager.top_scores)
