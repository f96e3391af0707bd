"""The port's masked top-k against ``recommendation_tpu.ops.topk`` on the
same scores, embeddings and positives, ties and −1 padding included.

``lax.top_k`` and ``torch.topk`` may order tied scores differently, so the
full-catalog comparisons go through ``topk_agree``: scores within 1e-6 (two
f32 products of the same embeddings), ids equal wherever the scores are
separated."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recommendation_tpu.ops import topk as jax_topk
from recommendation_tpu_torch.ops.topk import (
    MASK_VALUE,
    mask_trained,
    masked_topk,
    topk_agree,
    topk_with_exclusions,
)

SCORE_TOL = 1e-6


def _positives(rng, b, n_items, width):
    """[b, width] positives, −1 padded, rows of varying degree (some empty)."""
    pos = np.full((b, width), -1, dtype=np.int32)
    for row in range(b):
        deg = rng.integers(0, width + 1)
        pos[row, :deg] = rng.choice(n_items, size=deg, replace=False)
    return pos


def test_mask_trained_matches_jax():
    rng = np.random.default_rng(0)
    scores = rng.normal(size=(9, 40)).astype(np.float32)
    pos = _positives(rng, 9, 40, 12)
    pos[0, :] = -1  # a user with no positives: nothing masked
    got = mask_trained(torch.from_numpy(scores), torch.from_numpy(pos)).numpy()
    want = np.asarray(jax_topk.mask_trained(jnp.asarray(scores), jnp.asarray(pos)))
    assert np.array_equal(got, want)
    assert np.array_equal(got[0], scores[0])
    assert (got == MASK_VALUE).sum() == (pos >= 0).sum()


def test_masked_topk_matches_jax():
    rng = np.random.default_rng(1)
    scores = rng.normal(size=(6, 50)).astype(np.float32)  # distinct: no ties
    pos = _positives(rng, 6, 50, 10)
    s, i = masked_topk(torch.from_numpy(scores), torch.from_numpy(pos), 7)
    s_ref, i_ref = jax_topk.masked_topk(jnp.asarray(scores), jnp.asarray(pos), 7)
    assert np.array_equal(s.numpy(), np.asarray(s_ref))
    assert np.array_equal(i.numpy(), np.asarray(i_ref))


@pytest.mark.parametrize("batch_size", [1024, 7])
def test_topk_with_exclusions_matches_jax(batch_size):
    rng = np.random.default_rng(2)
    u = rng.normal(size=(23, 16)).astype(np.float32)
    items = rng.normal(size=(64, 16)).astype(np.float32)
    pos = _positives(rng, 23, 64, 9)
    s, i = topk_with_exclusions(torch.from_numpy(u), torch.from_numpy(items),
                                torch.from_numpy(pos), 10, batch_size=batch_size)
    s_ref, i_ref = jax_topk.topk_with_exclusions(
        jnp.asarray(u), jnp.asarray(items), jnp.asarray(pos), 10, batch_size=batch_size
    )
    assert s.shape == (23, 10) and i.shape == (23, 10)
    assert topk_agree(s.numpy(), i.numpy(), np.asarray(s_ref), np.asarray(i_ref), SCORE_TOL)
    # no train positive is ever returned
    for row in range(23):
        assert not set(i[row].tolist()) & set(pos[row][pos[row] >= 0].tolist())


def test_tied_scores_agree_up_to_order():
    """Items 3, 4 and 5 share one embedding, so their scores tie exactly;
    both sides must return the tied group at the same ranks."""
    rng = np.random.default_rng(3)
    u = rng.normal(size=(4, 8)).astype(np.float32)
    items = rng.normal(size=(12, 8)).astype(np.float32) * 0.01
    items[3:6] = u[0] / np.linalg.norm(u[0])  # the best match for user 0, three times over
    pos = np.full((4, 2), -1, dtype=np.int32)
    s, i = topk_with_exclusions(torch.from_numpy(u), torch.from_numpy(items),
                                torch.from_numpy(pos), 5)
    s_ref, i_ref = jax_topk.topk_with_exclusions(
        jnp.asarray(u), jnp.asarray(items), jnp.asarray(pos), 5
    )
    assert topk_agree(s.numpy(), i.numpy(), np.asarray(s_ref), np.asarray(i_ref), SCORE_TOL)
    assert set(i[0, :3].tolist()) == {3, 4, 5} == set(np.asarray(i_ref)[0, :3].tolist())
    assert s[0, 0] == s[0, 1] == s[0, 2]


def test_topk_agree_catches_a_real_difference():
    s = np.array([[0.9, 0.5, 0.1, 0.0]])
    ids = np.array([[1, 2, 3, 4]])
    assert topk_agree(s, ids, s, ids, 1e-6)
    assert not topk_agree(s, np.array([[2, 1, 3, 4]]), s, ids, 1e-6)  # separated: must match
    assert not topk_agree(s + 1e-3, ids, s, ids, 1e-6)  # scores off
    tied = np.array([[0.9, 0.5, 0.5, 0.0]])
    assert topk_agree(tied, np.array([[1, 3, 2, 4]]), tied, ids, 1e-6)  # tie: either order
    assert topk_agree(s, np.array([[1, 2, 3, 9]]), s, ids, 1e-6)  # last rank not compared
    assert not topk_agree(s[:, :3], ids[:, :3], s, ids, 1e-6)  # shapes differ
