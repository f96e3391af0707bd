"""The port's sampler (``recommendation_tpu_torch/sampling.py``) against the
JAX package's, fed the same raw 32-bit words: every output must be equal
bit for bit. The words come from ``jax.random.bits``/``split`` on the keys
the JAX function would use, repeating its own splits. With the port's own
generator: no train positive is ever drawn as a negative, and the epoch
permutation is a bijection."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import recommendation_tpu.sampling as js
from recommendation_tpu_torch import sampling as ts
from recommendation_tpu_torch.data.interaction import Interaction
from recommendation_tpu_torch.graph.device import DeviceGraph

K = 5  # n_redraws + 1 candidates, the samplers' default


def _words(bits) -> torch.Tensor:
    """JAX's uint32 bits as the port's int64 words."""
    return torch.from_numpy(np.asarray(bits).astype(np.int64))


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


def _same(got: torch.Tensor, want) -> bool:
    want = np.asarray(want)
    return got.dtype == torch.int32 and np.array_equal(got.numpy(), want)


def _perm_words(key, n):
    """The words ``js.keyed_permutation(key, n)`` draws, in its order."""
    k1, k2 = jax.random.split(key)
    rounds = ts.permutation_rounds(n)
    ks = js.uniform_ints(k1, (rounds,), n)
    salts = jax.random.bits(k2, (rounds,), jnp.uint32)
    return _t(ks), _words(salts)


@pytest.fixture(scope="module")
def graphs(tiny_data, tiny_graph):
    """(port graph, JAX graph) on the same triples, CPU."""
    ours = DeviceGraph(Interaction(tiny_data.training_data, tiny_data.test_data), device="cpu")
    return ours, tiny_graph


def _with_flags(ours, ref, **flags):
    ours, ref = copy.copy(ours), copy.copy(ref)
    for name, value in flags.items():
        setattr(ours, name, value)
        setattr(ref, name, value)
    return ours, ref


PATHS = {
    "bitmap": {},
    "table": {"has_pos_bitmap": False},
    "mask": {"has_pos_bitmap": False, "has_pos_table": False},
    "csr": {"has_pos_bitmap": False, "has_pos_table": False, "has_pos_mask": False},
}


@pytest.mark.parametrize("n", [1, 7, 100, 1675, 79_999, (1 << 24) - 1])
def test_bits_to_ints_bit_exact(n):
    bits = jax.random.bits(jax.random.PRNGKey(n), (4096,), jnp.uint32)
    bits = jnp.concatenate([bits, jnp.array([0, 255, 256, 2**32 - 1, 2**31], jnp.uint32)])
    assert _same(ts.bits_to_ints(_words(bits), n), js.bits_to_ints(bits, n))


@pytest.mark.parametrize("n", [1, 2, 17, 1840, 79_999])
def test_keyed_permutation_bit_exact(n):
    key = jax.random.PRNGKey(n + 3)
    ks, salts = _perm_words(key, n)
    assert _same(ts.keyed_permutation(ks, salts, n), js.keyed_permutation(key, n))


@pytest.mark.parametrize("path", sorted(PATHS))
def test_sample_negatives_bit_exact(graphs, path):
    ours, ref = _with_flags(*graphs, **PATHS[path])
    rng = np.random.default_rng(0)
    users = rng.integers(0, ours.n_users, size=300).astype(np.int32)
    for seed in range(3):
        key = jax.random.PRNGKey(seed)
        words = _words(jax.random.bits(key, (K + 1, 300), jnp.uint32))
        got = ts.sample_negatives(words, ours, _t(users))
        assert _same(got, js.sample_negatives(key, ref, jnp.asarray(users)))


def test_sample_negatives_epoch_edges_bit_exact(graphs):
    ours, ref = graphs
    assert ours.has_edge_bitmap_fb and ref.has_edge_bitmap_fb
    key = jax.random.PRNGKey(4)
    words = _words(jax.random.bits(key, (K + 1, ref.edge_bitmap_fb.shape[0]), jnp.uint32))
    assert _same(ts.sample_negatives_epoch_edges(words, ours),
                 js.sample_negatives_epoch_edges(key, ref))


@pytest.mark.parametrize("batch_size", [64, 256, 5000])
def test_shuffled_epoch_fused_bit_exact(graphs, batch_size):
    ours, ref = graphs
    key, nkey = jax.random.split(jax.random.PRNGKey(batch_size))
    negs_e = js.sample_negatives_epoch_edges(nkey, ref)
    got = ts.shuffled_epoch_fused(ts.keyed_permutation(*_perm_words(key, ref.n_edges),
                                                       ref.n_edges), ours, batch_size, _t(negs_e))
    want = js.shuffled_epoch_fused(key, ref, batch_size, negs_e)
    for g, w in zip(got[:3], want[:3]):
        assert _same(g, w)
    assert torch.equal(got[3], _t(want[3]))
    assert got[4] == want[4]


@pytest.mark.parametrize("path", ["edges", "bitmap", "per_batch"])
def test_epoch_batches_bit_exact(graphs, path):
    """All three routes of ``epoch_batches``: edge-order negatives, the
    per-position fused-row sampler, and per-batch ``sample_negatives``
    (the JAX package's vmap over split keys)."""
    flags = {"edges": {}, "bitmap": {"has_edge_bitmap_fb": False},
             "per_batch": {"has_edge_bitmap_fb": False, "has_pos_bitmap": False}}[path]
    ours, ref = _with_flags(*graphs, **flags)
    batch_size = 128
    shuffle_key, neg_key = jax.random.split(jax.random.PRNGKey(7))
    nb = -(-ref.n_edges // batch_size)
    if path == "edges":
        neg = jax.random.bits(neg_key, (K + 1, ref.edge_ui.shape[0]), jnp.uint32)
    elif path == "bitmap":
        neg = jax.random.bits(neg_key, (K + 1, nb * batch_size), jnp.uint32)
        neg = neg.reshape(K + 1, nb, batch_size)
    else:
        keys = jax.random.split(neg_key, nb)
        neg = jnp.stack([jax.random.bits(k, (K + 1, batch_size), jnp.uint32) for k in keys],
                        axis=1)
    words = ts.EpochWords(*_perm_words(shuffle_key, ref.n_edges), _words(neg))
    got = ts.epoch_batches(words, ours, batch_size)
    want = js.epoch_batches(shuffle_key, neg_key, ref, batch_size)
    for g, w in zip(got[:3], want[:3]):
        assert _same(g, w)
    assert got[4] == want[4] == nb


def test_popularity_baseline_matches(graphs):
    ours, ref = graphs
    assert np.array_equal(ts.popularity_baseline_topk(ours, 37),
                          js.popularity_baseline_topk(ref, 37))


# -- the port's own generator -------------------------------------------------


def _positives(data):
    mat = data.interaction_mat.tocsr()
    return {(u, int(i)) for u in range(data.user_num)
            for i in mat.indices[mat.indptr[u]:mat.indptr[u + 1]]}


@pytest.mark.parametrize("path", sorted(PATHS))
def test_own_generator_never_draws_a_positive(tiny_data, graphs, path):
    """The fixture is dense (near-saturated users), so the fallback fires."""
    ours, _ = _with_flags(*graphs, **PATHS[path])
    pos = _positives(tiny_data)
    gen = torch.Generator().manual_seed(1)
    users = ours.edge_users[: ours.n_edges]
    for _ in range(3):
        negs = ts.sample_negatives(ts.draw_words(gen, (K + 1, users.shape[0]), "cpu"), ours, users)
        assert not any((int(u), int(i)) in pos for u, i in zip(users, negs))
    users, items, negs, weights, nb = ts.epoch_batches(ts.epoch_words(gen, ours, 100), ours, 100)
    assert users.shape == items.shape == negs.shape == weights.shape == (nb, 100)
    assert not any((int(u), int(i)) in pos for u, i in zip(users.flatten(), negs.flatten()))
    assert all((int(u), int(i)) in pos for u, i in zip(users.flatten(), items.flatten()))


@pytest.mark.parametrize("n", [1, 2, 3, 1000, 1840, 65_537])
def test_own_generator_permutation_is_a_bijection(n):
    gen = torch.Generator().manual_seed(n)
    for _ in range(2):
        perm = ts.keyed_permutation(*ts.permutation_words(gen, n, "cpu"), n)
        assert perm.dtype == torch.int32
        assert torch.equal(torch.sort(perm).values, torch.arange(n, dtype=torch.int32))


def test_epoch_covers_every_edge_once(graphs):
    ours, _ = graphs
    gen = torch.Generator().manual_seed(2)
    users, items, _, _, nb = ts.epoch_batches(ts.epoch_words(gen, ours, 100), ours, 100)
    e = ours.n_edges
    seen = users.flatten()[:e].long() * ours.n_items + items.flatten()[:e].long()
    edges = ours.edge_users[:e].long() * ours.n_items + ours.edge_items[:e].long()
    assert torch.equal(torch.sort(seen).values, torch.sort(edges).values)


def test_pointwise_contract(tiny_data, graphs):
    ours, _ = graphs
    pos = _positives(tiny_data)
    gen = torch.Generator().manual_seed(3)
    users, items = ours.edge_users[:64], ours.edge_items[:64]
    w = torch.ones(64)
    w[-4:] = 0.0
    pw = ts.sample_pointwise(ts.negative_words(gen, 3, 64, "cpu"), ours, users, items, n_negs=3,
                             weight=w)
    assert pw.users.shape == pw.items.shape == pw.labels.shape == pw.weight.shape == (256,)
    assert torch.equal(pw.labels, torch.cat([torch.ones(64), torch.zeros(192)]))
    assert torch.equal(pw.weight, w.repeat(4))
    assert torch.equal(pw.items[:64], items)
    assert not any((int(u), int(i)) in pos for u, i in zip(pw.users[64:], pw.items[64:]))


def test_uniform_ints_range():
    gen = torch.Generator().manual_seed(0)
    x = ts.uniform_ints(gen, (20_000,), 10, "cpu")
    assert x.dtype == torch.int32 and int(x.min()) == 0 and int(x.max()) == 9
    counts = torch.bincount(x.long(), minlength=10).float()
    assert (counts / counts.mean() - 1).abs().max() < 0.1


def test_bits_to_ints_rejects_wide_catalogs():
    with pytest.raises(ValueError, match="2\\^24"):
        ts.bits_to_ints(torch.zeros(4, dtype=torch.int64), 1 << 24)


def test_words_are_checked(graphs):
    ours, _ = graphs
    with pytest.raises(ValueError, match="shape"):
        ts.sample_negatives(torch.zeros((K, 8), dtype=torch.int64), ours,
                            torch.zeros(8, dtype=torch.int32))
