"""The port's host data modules against the JAX package's: same triples,
same id maps, same matrices."""

import numpy as np
import pytest

from recommendation_tpu.data.io import load_data as jax_load_data
from recommendation_tpu.data.synthetic import load_or_make_dataset as jax_load_or_make
from recommendation_tpu.data.synthetic import make_synthetic_dataset as jax_make
from recommendation_tpu.config import default_config as jax_default_config
from recommendation_tpu_torch.config import default_config
from recommendation_tpu_torch.data.interaction import Interaction
from recommendation_tpu_torch.data.io import load_data
from recommendation_tpu_torch.data.synthetic import load_or_make_dataset, make_synthetic_dataset

TINY = dict(n_users=60, n_items=100, n_interactions=2500, seed=3)


@pytest.mark.parametrize("kwargs", [TINY, dict(n_users=120, n_items=90, n_interactions=4000, seed=11)])
def test_synthetic_triples_identical(kwargs):
    assert make_synthetic_dataset(**kwargs) == jax_make(**kwargs)


def _sparse_equal(a, b):
    a, b = a.tocsr(), b.tocsr()
    a.sort_indices()
    b.sort_indices()
    return (
        a.shape == b.shape
        and np.array_equal(a.indptr, b.indptr)
        and np.array_equal(a.indices, b.indices)
        and np.array_equal(a.data, b.data)
        and a.dtype == b.dtype
    )


def test_interaction_matches_jax(tiny_data):
    train, test = make_synthetic_dataset(**TINY)
    ours = Interaction(train, test)
    ref = tiny_data
    assert ours.user == ref.user and ours.item == ref.item
    assert ours.id2user == ref.id2user and ours.id2item == ref.id2item
    assert (ours.user_num, ours.item_num) == (ref.user_num, ref.item_num)
    for name in ("edge_users", "edge_items", "edge_weights"):
        a, b = getattr(ours, name), getattr(ref, name)
        assert a.dtype == b.dtype and np.array_equal(a, b), name
    assert _sparse_equal(ours.interaction_mat, ref.interaction_mat)
    assert _sparse_equal(ours.ui_adj, ref.ui_adj)
    assert _sparse_equal(ours.norm_adj, ref.norm_adj)
    assert dict(ours.test_set) == dict(ref.test_set)
    assert np.array_equal(ours.test_user_ids(), ref.test_user_ids())
    for a, b in zip(ours.test_items_by_user(), ref.test_items_by_user()):
        assert np.array_equal(a, b)
    assert ours.training_size() == ref.training_size()
    assert ours.test_size() == ref.test_size()


def test_load_data_matches_jax(tmp_path):
    path = tmp_path / "triples.txt"
    path.write_text("u1 i1 4.0\n\nu2 i3\nu1 i2 bad\n  u3   i1   2.5  \nlonely\n")
    assert load_data(str(path)) == jax_load_data(str(path))
    assert load_data(str(path), with_weight=False) == jax_load_data(str(path), with_weight=False)
    assert load_data(str(tmp_path / "missing.txt")) == [] == jax_load_data(str(tmp_path / "x"))


def test_load_or_make_dataset_matches_jax(tmp_path):
    kw = dict(n_users=30, n_items=40, n_interactions=600, seed=5)
    ours = load_or_make_dataset(str(tmp_path / "ours"), **kw)
    ref = jax_load_or_make(str(tmp_path / "ref"), **kw)
    assert ours == ref
    # second call reads the cached files
    assert load_or_make_dataset(str(tmp_path / "ours")) == ours


def test_default_config_matches_jax():
    ours = default_config(**{"embedding.size": 32, "LightGCN": {"n_layers": 2}})
    ref = jax_default_config(**{"embedding.size": 32, "LightGCN": {"n_layers": 2}})
    assert ours.as_dict() == ref.as_dict()
    assert ours["LightGCN"] == {"n_layers": 2}
    with pytest.raises(KeyError):
        ours["missing.key"]
