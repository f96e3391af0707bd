"""Social relation store and motif algebra: a copy of
``recommendation_tpu/data/social.py``, so the same trust triples give the
same CSR matrices bit for bit.

Covers the reference's `Relation` twins (`univariate/mhcn.py:91-171`,
`univariate/sept_social.py:108-188`) and the one-shot host-side motif
preprocessing used by the social model families:

  * MHCN triangular-motif hypergraph channels A1-A10 → [H_s, H_j, H_p]
    (`univariate/mhcn.py:340-368`);
  * SEPT friend/sharing views S²∘S+I and R·Rᵀ∘S+I
    (`univariate/sept_social.py:361-368`);
  * ESRF summed motif adjacency with A10 common-purchase threshold >5
    (`univariate/esrf.py:1067-1096`);
  * the `test.ipynb` social-graph synthesizer (cosine similarity, threshold
    0.35 ∪ top-10 union → trust triples).

All of this is scipy/numpy at graph-build time (one shot, outside the training
loop); the outputs are CSR matrices that ``graph.social_device.SocialDeviceGraph``
uploads for propagation on the device. ``synthesize_social`` builds a dense
float64 U × U similarity: about 7 MB at 943 users, 20 GB at 50,000.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Sequence

import numpy as np
import scipy.sparse as sp

from recommendation_tpu_torch.data.interaction import Interaction, normalize_graph_mat


class Relation:
    """User-user trust store over an ``Interaction``'s user id space."""

    def __init__(self, relation: Sequence[Sequence], user_map: Dict):
        self.user = user_map
        # Drop relations with users unseen in training (`mhcn.py:103-107`).
        self.relation = [list(r) for r in relation if r[0] in user_map and r[1] in user_map]
        self.followees: Dict = defaultdict(dict)
        self.followers: Dict = defaultdict(dict)
        for u1, u2, *w in self.relation:
            weight = w[0] if w else 1.0
            self.followees[u1][u2] = weight
            self.followers[u2][u1] = weight

    def size(self):
        return len(self.followers), len(self.relation)

    def weight(self, u1, u2):
        return self.followees.get(u1, {}).get(u2, 0)

    def get_followers(self, u):
        return self.followers.get(u, {})

    def get_followees(self, u):
        return self.followees.get(u, {})

    def has_followee(self, u1, u2):
        return u2 in self.followees.get(u1, {})

    def has_follower(self, u1, u2):
        return u1 in self.followers.get(u2, {}) or u2 in self.followers.get(u1, {})

    def get_social_mat(self) -> sp.csr_matrix:
        n = len(self.user)
        rows = [self.user[r[0]] for r in self.relation]
        cols = [self.user[r[1]] for r in self.relation]
        vals = np.ones(len(rows), dtype=np.float32)
        return sp.csr_matrix((vals, (rows, cols)), shape=(n, n))

    def get_bidirectional_social_mat(self) -> sp.csr_matrix:
        """S ∘ Sᵀ — mutual-follow edges (`sept_social.py:141-144`).

        (The reference's ``S.multiply(S)`` is a no-op for 0/1 matrices and its
        published intent is S∘Sᵀ; we implement the published semantics.)
        """
        s = self.get_social_mat()
        return s.multiply(s.T).tocsr()

    def normalize(self, adj: sp.spmatrix) -> sp.csr_matrix:
        return normalize_graph_mat(adj)


# -- motif algebra ------------------------------------------------------------


def row_normalize(mat: sp.spmatrix) -> sp.csr_matrix:
    mat = sp.csr_matrix(mat, dtype=np.float32)
    rowsum = np.asarray(mat.sum(axis=1)).flatten()
    inv = np.divide(1.0, rowsum, out=np.zeros_like(rowsum), where=rowsum > 0)
    return (sp.diags(inv) @ mat).tocsr()


def triangular_motif_matrices(S: sp.spmatrix, Y: sp.spmatrix) -> List[sp.csr_matrix]:
    """MHCN motifs A1..A10 over social matrix S and interaction matrix Y.

    Returns the 10 symmetric motif adjacencies of `univariate/mhcn.py:340-360`
    (M1-M10 of the MHCN paper): B = mutual edges, U = one-way edges; A1-A7 are
    the seven triangle types over B/U; A8/A9 weight social edges by common
    purchases; A10 is the pure co-purchase graph minus A8/A9.
    """
    S = sp.csr_matrix(S, dtype=np.float32)
    Y = sp.csr_matrix(Y, dtype=np.float32)
    B = S.multiply(S.T)
    U = S - B
    C1 = (U @ U).multiply(U.T)
    A1 = C1 + C1.T
    C2 = (B @ U).multiply(U.T) + (U @ B).multiply(U.T) + (U @ U).multiply(B)
    A2 = C2 + C2.T
    C3 = (B @ B).multiply(U) + (B @ U).multiply(B) + (U @ B).multiply(B)
    A3 = C3 + C3.T
    A4 = (B @ B).multiply(B)
    C5 = (U @ U).multiply(U) + (U @ U.T).multiply(U) + (U.T @ U).multiply(U)
    A5 = C5 + C5.T
    A6 = (U @ B).multiply(U) + (B @ U.T).multiply(U.T) + (U.T @ U).multiply(B)
    A7 = (U.T @ B).multiply(U.T) + (B @ U).multiply(U) + (U @ U.T).multiply(B)
    YY = Y @ Y.T
    A8 = YY.multiply(B)
    A9 = YY.multiply(U)
    A9 = A9 + A9.T
    A10 = YY - A8 - A9
    return [sp.csr_matrix(a) for a in (A1, A2, A3, A4, A5, A6, A7, A8, A9, A10)]


def mhcn_hypergraph_channels(
    S: sp.spmatrix, Y: sp.spmatrix, purchase_threshold: int = 3
) -> List[sp.csr_matrix]:
    """[H_s, H_j, H_p] row-normalized channel adjacencies
    (`univariate/mhcn.py:361-368`): H_s = ΣA1..A7, H_j = A8+A9,
    H_p = A10 thresholded at > purchase_threshold common purchases."""
    A = triangular_motif_matrices(S, Y)
    H_s = row_normalize(sum(A[:7]))
    H_j = row_normalize(A[7] + A[8])
    H_p = A[9]
    H_p = H_p.multiply(H_p > purchase_threshold)
    H_p = row_normalize(H_p)
    return [H_s, H_j, H_p]


def esrf_motif_adjacency(S: sp.spmatrix, Y: sp.spmatrix, threshold: int = 5) -> sp.csr_matrix:
    """Row-normalized summed motif adjacency S + ΣA1..A10 with zeroed A10
    diagonal and common-purchase threshold > ``threshold``
    (`univariate/esrf.py:1067-1096`)."""
    A = triangular_motif_matrices(S, Y)
    A10 = A[9].tolil()
    A10.setdiag(0)
    A10 = sp.csr_matrix(A10)
    A10 = A10.multiply(A10 > threshold)
    total = sp.csr_matrix(S, dtype=np.float32) + sum(A[:9]) + A10
    return row_normalize(total)


def sept_social_views(S: sp.spmatrix, Y: sp.spmatrix) -> List[sp.csr_matrix]:
    """[friend_view, sharing_view], both sym-normalized
    (`univariate/sept_social.py:361-368`): friend = (S·S)∘S + I,
    sharing = (Y·Yᵀ)∘S + I."""
    S = sp.csr_matrix(S, dtype=np.float32)
    Y = sp.csr_matrix(Y, dtype=np.float32)
    n = S.shape[0]
    friend = (S @ S).multiply(S) + sp.eye(n, dtype=np.float32)
    sharing = (Y @ Y.T).multiply(S) + sp.eye(n, dtype=np.float32)
    return [normalize_graph_mat(friend), normalize_graph_mat(sharing)]


# -- social-data synthesizer (test.ipynb equivalent) --------------------------


def synthesize_social(
    data: Interaction, threshold: float = 0.35, top_k: int = 10
) -> List[list]:
    """Build trust triples from user-user cosine similarity of the train
    matrix: edge u→v iff sim(u,v) ≥ threshold OR v ∈ top-k(u), excluding
    self-edges. Mirrors `test.ipynb` cells 2-6 (similarity → threshold 0.35 ∪
    top-10 union → `trustor trustee weight` triples)."""
    R = data.interaction_mat.astype(np.float64)
    norms = np.sqrt(np.asarray(R.multiply(R).sum(axis=1)).flatten())
    norms[norms == 0] = 1.0
    sim = np.asarray((R @ R.T).todense()) / np.outer(norms, norms)
    np.fill_diagonal(sim, -np.inf)

    n = data.user_num
    k = min(top_k, n - 1)
    triples = []
    topk_idx = np.argpartition(-sim, kth=k - 1, axis=1)[:, :k] if k > 0 else np.zeros((n, 0), int)
    for u in range(n):
        chosen = set(np.nonzero(sim[u] >= threshold)[0].tolist())
        chosen.update(int(v) for v in topk_idx[u] if np.isfinite(sim[u, v]))
        chosen.discard(u)
        uid = data.id2user[u]
        for v in sorted(chosen):
            triples.append([uid, data.id2user[int(v)], float(max(sim[u, v], 0.0))])
    return triples
