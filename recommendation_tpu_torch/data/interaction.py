"""Interaction store (layer L2): id maps, positive sets, CSR matrices.

A copy of ``recommendation_tpu/data/interaction.py`` without ``from_files``
(its native C++ path): the port loads files with ``data.io.load_data``.

Built once, replacing the 13 drifting ``Interaction`` copies in the reference
(fullest copy: `selfcf.py:258-327`; lighter clones `ncl.py:46-88`,
`ssl4rec.py:59-91`, `directau.py:102-144`).

Contract decisions (documented where the reference copies drift, SURVEY.md
§2.3):
  * id assignment: **insertion order over the training data** — the behavior
    of every top-level script (`selfcf.py:279-290`, `ncl.py:60-63`).
  * test entries are filtered to users/items seen in training
    (`selfcf.py:292-295`, `ssl4rec.py:76-78`; some clones skip this filter —
    we keep it, since unseen ids cannot be scored by any embedding model).
  * bipartite adjacency ``A = [[0, R], [R^T, 0]]`` over ``n_users + n_items``
    nodes (`selfcf.py:297-306`), symmetric normalization ``D^-1/2 A D^-1/2``
    (`selfcf.py:240-255`).

Everything here is host-side numpy/scipy and runs ONCE at graph build; the
training loop only ever touches the device arrays produced by
``graph.device.DeviceGraph``.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Sequence

import numpy as np
import scipy.sparse as sp


def normalize_graph_mat(adj: sp.spmatrix) -> sp.csr_matrix:
    """Degree normalization.

    Square matrices get symmetric ``D^-1/2 A D^-1/2`` (`selfcf.py:240-255`);
    rectangular matrices get one-sided row ``D^-1 A`` (`ncl.py:39-43`).
    """
    adj = sp.csr_matrix(adj, dtype=np.float32)
    shape = adj.shape
    rowsum = np.asarray(adj.sum(axis=1)).flatten()
    if shape[0] == shape[1]:
        d_inv_sqrt = np.power(rowsum, -0.5, where=rowsum > 0)
        d_inv_sqrt[rowsum == 0] = 0.0
        d_mat = sp.diags(d_inv_sqrt)
        return (d_mat @ adj @ d_mat).tocsr()
    d_inv = np.power(rowsum, -1.0, where=rowsum > 0)
    d_inv[rowsum == 0] = 0.0
    return (sp.diags(d_inv) @ adj).tocsr()


class Interaction:
    """User-item interaction store with id remapping and graph matrices."""

    def __init__(self, training_data: Sequence[Sequence], test_data: Sequence[Sequence] = ()):
        self.training_data = [list(t) for t in training_data]
        self.user: Dict = {}
        self.item: Dict = {}
        self.id2user: Dict[int, object] = {}
        self.id2item: Dict[int, object] = {}
        self.training_set_u: Dict = defaultdict(dict)
        self.training_set_i: Dict = defaultdict(dict)
        self.test_set: Dict = defaultdict(dict)
        self.test_set_item = set()

        for row in self.training_data:
            user, item = row[0], row[1]
            rating = row[2] if len(row) > 2 else 1.0
            if user not in self.user:
                uid = len(self.user)
                self.user[user] = uid
                self.id2user[uid] = user
            if item not in self.item:
                iid = len(self.item)
                self.item[item] = iid
                self.id2item[iid] = item
            self.training_set_u[user][item] = rating
            self.training_set_i[item][user] = rating

        self.test_data = []
        for row in test_data:
            user, item = row[0], row[1]
            rating = row[2] if len(row) > 2 else 1.0
            if user in self.user and item in self.item:
                self.test_set[user][item] = rating
                self.test_set_item.add(item)
                self.test_data.append([user, item, rating])

        self.user_num = len(self.user)
        self.item_num = len(self.item)

        # Integer edge arrays (the device-facing representation).
        self.edge_users = np.fromiter(
            (self.user[r[0]] for r in self.training_data), dtype=np.int32, count=len(self.training_data)
        )
        self.edge_items = np.fromiter(
            (self.item[r[1]] for r in self.training_data), dtype=np.int32, count=len(self.training_data)
        )
        self.edge_weights = np.fromiter(
            ((r[2] if len(r) > 2 else 1.0) for r in self.training_data),
            dtype=np.float32,
            count=len(self.training_data),
        )

        self.interaction_mat = sp.csr_matrix(
            (np.ones(len(self.edge_users), dtype=np.float32), (self.edge_users, self.edge_items)),
            shape=(self.user_num, self.item_num),
        )
        self.ui_adj = self._bipartite_adjacency()
        self.norm_adj = normalize_graph_mat(self.ui_adj)

    # -- adjacency builders ---------------------------------------------------

    def _bipartite_adjacency(self, self_connection: bool = False) -> sp.csr_matrix:
        n = self.user_num + self.item_num
        rows = self.edge_users
        cols = self.edge_items + self.user_num
        vals = np.ones(len(rows), dtype=np.float32)
        upper = sp.csr_matrix((vals, (rows, cols)), shape=(n, n))
        adj = upper + upper.T
        if self_connection:
            adj = adj + sp.eye(n, dtype=np.float32)
        return adj.tocsr()

    # -- reference-compatible accessors --------------------------------------

    def get_user_id(self, u):
        return self.user.get(u)

    def get_item_id(self, i):
        return self.item.get(i)

    def training_size(self):
        return self.user_num, self.item_num, len(self.training_data)

    def test_size(self):
        return len(self.test_set), len(self.test_set_item), len(self.test_data)

    def user_rated(self, u):
        return list(self.training_set_u[u].keys()), list(self.training_set_u[u].values())

    # -- vectorized views used by the device pipeline -------------------------

    def test_matrix(self) -> sp.csr_matrix:
        """CSR of test interactions over internal ids (users × items)."""
        rows, cols = [], []
        for u, items in self.test_set.items():
            uid = self.user[u]
            for i in items:
                rows.append(uid)
                cols.append(self.item[i])
        return sp.csr_matrix(
            (np.ones(len(rows), dtype=np.float32), (rows, cols)),
            shape=(self.user_num, self.item_num),
        )

    def test_user_ids(self) -> np.ndarray:
        """Internal ids of users with ≥1 test interaction, ascending."""
        return np.array(sorted(self.user[u] for u in self.test_set), dtype=np.int32)

    def test_items_by_user(self) -> List[np.ndarray]:
        """Internal test-item id arrays aligned with ``test_user_ids()``,
        computed once and cached — ``evaluate_ranking`` reads this every
        eval epoch, and rebuilding it per call was a per-user Python wall at
        web-scale user counts. Cached lazily via getattr."""
        cache = getattr(self, "_test_items_cache", None)
        if cache is None:
            cache = [
                np.array(
                    [self.item[i] for i in self.test_set[self.id2user[int(u)]]],
                    dtype=np.int64,
                )
                for u in self.test_user_ids()
            ]
            self._test_items_cache = cache
        return cache

    def user_positive_lists(self) -> List[np.ndarray]:
        mat = self.interaction_mat
        return [mat.indices[mat.indptr[u]:mat.indptr[u + 1]] for u in range(self.user_num)]
