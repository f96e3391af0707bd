"""Device-resident social graph state (counterpart of
``recommendation_tpu/graph/social_device.py``).

``SocialDeviceGraph`` extends ``DeviceGraph`` with the social-side matrices
the social models consume, all built once on the host with the motif
algebra of ``data/social.py`` and uploaded with ``from_scipy`` on the
graph's backend (dense: the COO, its matrix built at the first product;
bucketed: the pull tables of A and Aᵀ, kernels P1 and K7 each way; segment
and pallas: the two row-sorted views, P1 each way):

  * ``social_adj`` — the row-normalized trust matrix S (DiffNet's
    follower-count normalization `univariate/diffnet.py:1070-1077` equals
    row normalization of the 0/1 S);
  * ``mhcn_hs``, ``mhcn_hj``, ``mhcn_hp`` — MHCN's hypergraph channels
    (`univariate/mhcn.py:340-368`);
  * ``sept_friend``, ``sept_sharing`` — SEPT's views over the mutual edges
    (`univariate/sept_social.py:361-368`);
  * ``esrf_motif`` — ESRF's summed motif adjacency
    (`univariate/esrf.py:1067-1096`);
  * ``interaction_norm`` — the one-sided row-normalized R, [U, I]
    (MHCN's R, DiffNet's A); its ``transpose()`` is MHCN's item
    convolution (on the bucketed backend the same tables swapped).
"""

from __future__ import annotations

from typing import Sequence

from recommendation_tpu_torch.data.interaction import normalize_graph_mat
from recommendation_tpu_torch.data.social import (
    Relation,
    esrf_motif_adjacency,
    mhcn_hypergraph_channels,
    row_normalize,
    sept_social_views,
)
from recommendation_tpu_torch.graph.device import DeviceAdj, DeviceGraph, from_scipy

# the social matrices, in the order they are uploaded
SOCIAL_MATRICES = ("social_adj", "mhcn_hs", "mhcn_hj", "mhcn_hp", "sept_friend", "sept_sharing",
                   "esrf_motif", "interaction_norm")


class SocialDeviceGraph(DeviceGraph):
    """``DeviceGraph`` of ``data`` plus the social matrices of
    ``social_triples`` (``trustor trustee [weight]``; relations with a user
    unseen in training are dropped), on ``device``. ``relation`` keeps the
    ``Relation``; ``social_nnz`` each matrix's stored entries."""

    def __init__(self, data, social_triples: Sequence[Sequence], backend: str = "auto",
                 compute_dtype: str = "float32", device="cuda",
                 mhcn_purchase_threshold: int = 3, esrf_purchase_threshold: int = 5):
        super().__init__(data, backend=backend, compute_dtype=compute_dtype, device=device)
        self.relation = Relation(social_triples, data.user)
        S = self.relation.get_social_mat()
        Y = data.interaction_mat
        hs, hj, hp = mhcn_hypergraph_channels(S, Y, mhcn_purchase_threshold)
        friend, sharing = sept_social_views(self.relation.get_bidirectional_social_mat(), Y)
        host = {
            # DiffNet's S entries are 1/|followees(trustor)| (`diffnet.py:1075`),
            # the row normalization of the 0/1 trust matrix
            "social_adj": row_normalize(S),
            "mhcn_hs": hs, "mhcn_hj": hj, "mhcn_hp": hp,
            "sept_friend": friend, "sept_sharing": sharing,
            "esrf_motif": esrf_motif_adjacency(S, Y, esrf_purchase_threshold),
            "interaction_norm": normalize_graph_mat(Y),
        }
        self.social_nnz = {name: int(host[name].nnz) for name in SOCIAL_MATRICES}
        for name in SOCIAL_MATRICES:
            setattr(self, name, self._upload(host[name]))

    def _upload(self, mat) -> DeviceAdj:
        return from_scipy(mat, backend=self.backend, compute_dtype=self.compute_dtype,
                          device=self.device)
