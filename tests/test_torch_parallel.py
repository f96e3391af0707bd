"""The port's parallel layer (``recommendation_tpu_torch/parallel``) in a
gloo world of four CPU processes against the JAX package's
``recommendation_tpu/parallel`` on the 8-device CPU mesh.

One world is spawned for the file (``world``, module scope): each rank
runs this file as a script on a (data 2, model 2) mesh, computes every
case from seed-made numpy inputs (``_inputs``), and rank 0 writes them to
an ``.npz``. While the world runs, the parent computes the JAX side on
``make_mesh(MeshSpec(2, 2), jax.devices()[:4])``. The cases:
  * ``default_mesh_shape`` for 1-16 devices, equal to the JAX function's;
  * ``sharded_embedding_lookup`` bit for bit;
  * ``sharded_topk``: scores within rtol 1e-5 / atol 1e-6, ids by
    ``topk_agree`` (the padded item table's zero rows included);
  * ``sharded_batch_softmax_denominator`` and ``sharded_uniformity`` within
    rtol 1e-5 (f32 sums in another order);
  * ``mask_seen_post_merge`` and ``train_edge_keys`` bit for bit;
  * the ``_worker_train`` counterpart over (2, 2), from the JAX model's
    ``init(PRNGKey(0))`` carried through ``weights.py``, on the same 8 numpy
    batches: its user table and 8 losses against JAX
    ``distributed._worker_train`` run in this process (a (4, 2) mesh), at
    rtol 1e-5 / atol 1e-6;
  * the ``_worker_serve`` counterpart (a (1, 4) mesh, from per-rank
    checkpoints of the padded item shards), from the JAX model's
    ``init(PRNGKey(7))``: its ids equal to the JAX service's on a (1, 4)
    mesh, with and without exclusions; and a wave of PAD_WAVE users, which
    both services pad to a power of two with user 0 (the candidate count
    rounded up to 64), the same ids.
Workers run one thread each; the world has a hard timeout that kills its
processes and fails the fixture.
"""

import os
import pathlib
import sys

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
TIGHT = dict(rtol=1e-5, atol=1e-6)
WORLD_TIMEOUT_S = 240
PAD_WAVE = 13  # a wave the services pad to 16 users


def _inputs():
    """The collective cases' inputs, from one numpy seed."""
    rng = np.random.default_rng(0)
    return {
        "table": rng.normal(size=(64, 16)).astype(np.float32),
        "ids": rng.integers(0, 64, size=37).astype(np.int32),
        "users": rng.normal(size=(9, 8)).astype(np.float32),
        "items": rng.normal(size=(41, 8)).astype(np.float32),  # padded to 42
        "lse_users": rng.normal(size=(7, 8)).astype(np.float32),
        "lse_items": rng.normal(size=(64, 8)).astype(np.float32),
        "x": rng.normal(size=(64, 8)).astype(np.float32),
    }


# -- the worker: one rank of the world ------------------------------------------


def _worker(out_dir):
    torch.set_num_threads(1)
    import torch.distributed as dist

    from recommendation_tpu_torch.parallel import distributed as pd
    from recommendation_tpu_torch.parallel.collectives import (
        sharded_batch_softmax_denominator,
        sharded_topk,
        sharded_uniformity,
    )
    from recommendation_tpu_torch.parallel.embedding import pad_rows_to, sharded_embedding_lookup
    from recommendation_tpu_torch.parallel.mesh import MeshSpec, make_mesh

    pd.initialize("gloo", "cpu")
    mesh = make_mesh(MeshSpec(2, 2), "cpu")
    inp = {k: torch.from_numpy(v) for k, v in _inputs().items()}

    def local(x):
        return pd.put_global(x.numpy(), mesh, "cpu")

    out = {"lookup": sharded_embedding_lookup(local(inp["table"]), inp["ids"], mesh)}
    out["topk_scores"], out["topk_ids"] = sharded_topk(
        inp["users"], local(pad_rows_to(inp["items"], 2)), 5, mesh)
    out["lse"] = sharded_batch_softmax_denominator(inp["lse_users"], local(inp["lse_items"]),
                                                   0.2, mesh)
    out["uniformity"] = sharded_uniformity(local(inp["x"]), mesh)
    out["coords"] = torch.tensor([mesh.get_local_rank("data"), mesh.get_local_rank("model")])
    gathered = {k: pd.all_gather_cat(v[None], None) for k, v in out.items()}
    pd._worker_train(os.path.join(out_dir, "train.npz"), os.path.join(out_dir, "ckpt_train"),
                     "cpu", os.path.join(out_dir, "init_train.npz"))
    pd._worker_serve(os.path.join(out_dir, "serve.npz"), os.path.join(out_dir, "ckpt_serve"),
                     "cpu", os.path.join(out_dir, "init_serve.npz"))
    _padded_wave(os.path.join(out_dir, "serve_pad.npz"), os.path.join(out_dir, "init_serve.npz"))
    if dist.get_rank() == 0:
        np.savez(os.path.join(out_dir, "cases.npz"),
                 **{k: v.numpy() for k, v in gathered.items()})
    dist.barrier()
    dist.destroy_process_group()


def _padded_wave(out_path, init_path):
    """The serving worker's tables over a (1, 4) mesh, a wave of PAD_WAVE
    users of ``np.random.default_rng(12)``, with and without exclusions
    (rank 0 writes the answers)."""
    import torch.distributed as dist

    from recommendation_tpu_torch.config import default_config
    from recommendation_tpu_torch.models.lightgcn import LightGCN
    from recommendation_tpu_torch.parallel import distributed as pd
    from recommendation_tpu_torch.parallel.mesh import MeshSpec, make_mesh
    from recommendation_tpu_torch.serve.service import RecommenderService
    from recommendation_tpu_torch.weights import load_params

    data, graph = pd._dryrun_graph("cpu")
    model = LightGCN(default_config(**{"embedding.size": 32}))
    user_emb, item_emb = model.eval_embeddings(load_params(init_path, "lightgcn", device="cpu"),
                                               {}, graph)
    service = RecommenderService(user_emb, item_emb, data, graph,
                                 mesh=make_mesh(MeshSpec(1, 4), "cpu"))
    uids = np.random.default_rng(12).integers(0, data.user_num, PAD_WAVE).tolist()
    out = {}
    for exclude, tag in ((True, ""), (False, "_raw")):
        out[f"scores{tag}"], out[f"ids{tag}"] = service.recommend_ids(uids, k=10,
                                                                      exclude_seen=exclude)
    out["keys"] = np.asarray(sorted("/".join(map(str, k)) for k in service.block.keys))
    if dist.get_rank() == 0:
        np.savez(out_path, **out)


# -- the JAX side ---------------------------------------------------------------


def _jax_graph():
    from recommendation_tpu.data.interaction import Interaction
    from recommendation_tpu.data.synthetic import make_synthetic_dataset
    from recommendation_tpu.graph.device import DeviceGraph

    train, test = make_synthetic_dataset(n_users=64, n_items=128, n_interactions=3000, seed=0)
    data = Interaction(train, test)
    return data, DeviceGraph(data, backend="segment")


def _jax_side(out_dir):
    """The JAX package's values for every case (run while the world runs)."""
    import jax
    import jax.numpy as jnp

    from recommendation_tpu.config import default_config
    from recommendation_tpu.models.lightgcn import LightGCN
    from recommendation_tpu.parallel import distributed as jd
    from recommendation_tpu.parallel.collectives import (
        sharded_batch_softmax_denominator,
        sharded_topk,
        sharded_uniformity,
    )
    from recommendation_tpu.parallel.embedding import pad_rows_to, sharded_embedding_lookup
    from recommendation_tpu.parallel.mesh import MeshSpec, make_mesh, table_sharding
    from recommendation_tpu.serve.service import RecommenderService

    inp = _inputs()
    mesh = make_mesh(MeshSpec(2, 2), jax.devices()[:4])

    def sharded(x):
        return jax.device_put(jnp.asarray(x), table_sharding(mesh))

    ref = {"lookup": sharded_embedding_lookup(sharded(inp["table"]), jnp.asarray(inp["ids"]),
                                              mesh)}
    ref["topk_scores"], ref["topk_ids"] = sharded_topk(
        jnp.asarray(inp["users"]), sharded(pad_rows_to(jnp.asarray(inp["items"]), 2)), 5, mesh)
    ref["lse"] = sharded_batch_softmax_denominator(jnp.asarray(inp["lse_users"]),
                                                   sharded(inp["lse_items"]), 0.2, mesh)
    ref["uniformity"] = sharded_uniformity(sharded(inp["x"]), mesh)
    jd._worker_train(os.path.join(out_dir, "jax_train.npz"))
    ref = {k: np.asarray(v) for k, v in ref.items()}

    # the serving worker's steps on a (1, 4) mesh, from PRNGKey(7)
    data, graph = _jax_graph()
    model = LightGCN(default_config(**{"embedding.size": 32}))
    params, state = model.init(jax.random.PRNGKey(7), graph)
    user_emb, item_emb = model.eval_embeddings(params, state, graph)
    service = RecommenderService(np.asarray(user_emb), np.asarray(item_emb), data, graph,
                                 mesh=make_mesh(MeshSpec(1, 4), jax.devices()[:4]))
    uids = np.random.default_rng(11).integers(0, data.user_num, 16).tolist()
    ref["serve_scores"], ref["serve_ids"] = service.recommend_ids(uids, k=10, exclude_seen=True)
    ref["serve_scores_raw"], ref["serve_ids_raw"] = service.recommend_ids(uids, k=10,
                                                                          exclude_seen=False)
    uids = np.random.default_rng(12).integers(0, data.user_num, PAD_WAVE).tolist()
    ref["pad_scores"], ref["pad_ids"] = service.recommend_ids(uids, k=10, exclude_seen=True)
    ref["pad_scores_raw"], ref["pad_ids_raw"] = service.recommend_ids(uids, k=10,
                                                                      exclude_seen=False)
    return ref


def _jax_params(out_dir):
    """The JAX model's init(PRNGKey(0)) and init(PRNGKey(7)), saved for the
    workers (``weights.load_params`` reads them)."""
    import jax

    from recommendation_tpu.config import default_config
    from recommendation_tpu.models.lightgcn import LightGCN

    _, graph = _jax_graph()
    for seed, name in ((0, "init_train.npz"), (7, "init_serve.npz")):
        model = LightGCN(default_config(**{"embedding.size": 32}))
        params, _ = model.init(jax.random.PRNGKey(seed), graph)
        np.savez(os.path.join(out_dir, name), **{k: np.asarray(v) for k, v in params.items()})


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    from recommendation_tpu_torch.parallel.distributed import spawn_world

    out = tmp_path_factory.mktemp("parallel")
    _jax_params(str(out))
    ref = {}
    spawn_world([sys.executable, __file__, str(out)], 4, WORLD_TIMEOUT_S, str(out / "logs"),
                env={"PYTHONPATH": str(ROOT)},
                while_running=lambda: ref.update(_jax_side(str(out))))
    cases = np.load(out / "cases.npz")
    return {k: cases[k] for k in cases.files}, ref, out


def test_default_mesh_shape_matches_jax():
    from recommendation_tpu.parallel.mesh import default_mesh_shape as jax_shape
    from recommendation_tpu_torch.parallel.mesh import default_mesh_shape

    for n in range(1, 17):
        got, want = default_mesh_shape(n), jax_shape(n)
        assert (got.data, got.model) == (want.data, want.model), n


def test_ranks_sit_row_major_on_the_mesh(world):
    cases, _, _ = world
    assert cases["coords"].tolist() == [[0, 0], [0, 1], [1, 0], [1, 1]]


def test_sharded_embedding_lookup_is_jax_bit_for_bit(world):
    cases, ref, _ = world
    inp = _inputs()
    for rank_value in cases["lookup"]:  # the same on every rank
        assert np.array_equal(rank_value, ref["lookup"])
    assert np.array_equal(ref["lookup"], inp["table"][inp["ids"]])


def test_sharded_topk_matches_jax(world):
    from recommendation_tpu_torch.ops.topk import topk_agree

    cases, ref, _ = world
    for scores, ids in zip(cases["topk_scores"], cases["topk_ids"]):
        np.testing.assert_allclose(scores, ref["topk_scores"], **TIGHT)
        assert topk_agree(scores, ids, ref["topk_scores"], ref["topk_ids"], 1e-5)
    inp = _inputs()
    dense = inp["users"] @ np.concatenate([inp["items"], np.zeros((1, 8), np.float32)]).T
    for b in range(9):  # and the dense oracle's ids, as the JAX package's test holds
        assert set(cases["topk_ids"][0][b].tolist()) == set(np.argsort(-dense[b])[:5].tolist())


def test_sharded_softmax_denominator_matches_jax(world):
    cases, ref, _ = world
    for value in cases["lse"]:
        np.testing.assert_allclose(value, ref["lse"], rtol=1e-5)


def test_sharded_uniformity_matches_jax(world):
    cases, ref, _ = world
    for value in cases["uniformity"]:
        np.testing.assert_allclose(value, ref["uniformity"], rtol=1e-5)


def test_mask_seen_post_merge_and_train_edge_keys_are_jax_bit_for_bit():
    import scipy.sparse as sp

    from recommendation_tpu.ops.topk import mask_seen_post_merge as jax_mask
    from recommendation_tpu.ops.topk import train_edge_keys as jax_keys
    from recommendation_tpu_torch.ops.topk import mask_seen_post_merge, train_edge_keys

    rng = np.random.default_rng(5)
    n_users, n_items = 40, 70
    rows, cols = rng.integers(0, n_users, 600), rng.integers(0, n_items, 600)
    mat = sp.csr_matrix((np.ones(600, np.float32), (rows, cols)), shape=(n_users, n_items))
    keys = train_edge_keys(mat, n_items)
    assert keys.dtype == np.int64 and np.array_equal(keys, jax_keys(mat, n_items))
    uids = rng.integers(0, n_users, 25)
    ids = rng.integers(0, n_items + 6, (25, 30))  # ids past n_items: padding rows
    scores = rng.normal(size=(25, 30)).astype(np.float32)
    got = mask_seen_post_merge(scores, ids, uids, keys, n_items)  # train_edge_keys: sorted
    want = jax_mask(scores, ids, uids, keys, n_items)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    shuffled = rng.permutation(keys)  # keys in another order: sorted once by the caller
    assert np.array_equal(mask_seen_post_merge(scores, ids, uids, np.sort(shuffled), n_items),
                          jax_mask(scores, ids, uids, shuffled, n_items))
    assert (got == -1e8).sum() > (ids >= n_items).sum()  # positives masked, padding too


def test_worker_train_matches_jax_from_carried_weights(world):
    _, _, out = world
    got, want = np.load(out / "train.npz"), np.load(out / "jax_train.npz")
    assert got["losses"].shape == (8,) and np.all(np.isfinite(got["losses"]))
    np.testing.assert_allclose(got["losses"], want["losses"], **TIGHT)
    np.testing.assert_allclose(got["user_emb"], want["user_emb"], **TIGHT)


def test_worker_serve_ids_match_jax_service(world):
    _, ref, out = world
    got = np.load(out / "serve.npz")
    assert np.array_equal(got["ids"], ref["serve_ids"])
    assert np.array_equal(got["ids_raw"], ref["serve_ids_raw"])
    np.testing.assert_allclose(got["scores"], ref["serve_scores"], **TIGHT)
    np.testing.assert_allclose(got["scores_raw"], ref["serve_scores_raw"], **TIGHT)



def test_padded_mesh_wave_ids_match_jax_service(world):
    """A wave of PAD_WAVE users, which both services pad to 16 with user 0
    and over-fetch by a count rounded up to 64: the same ids as the JAX
    service's, with and without exclusions, through the port's padded
    shapes."""
    _, ref, out = world
    got = np.load(out / "serve_pad.npz")
    for tag in ("", "_raw"):
        assert got[f"ids{tag}"].shape == (PAD_WAVE, 10)
        assert np.array_equal(got[f"ids{tag}"], ref[f"pad_ids{tag}"]), tag
        np.testing.assert_allclose(got[f"scores{tag}"], ref[f"pad_scores{tag}"], **TIGHT)
    assert all(k.startswith("merged_ids/16/") for k in got["keys"]) and len(got["keys"])


if __name__ == "__main__":
    _worker(sys.argv[1])
