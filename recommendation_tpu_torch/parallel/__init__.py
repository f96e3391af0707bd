"""The parallel layer on ``torch.distributed`` (counterpart of
``recommendation_tpu/parallel``): the ``(data, model)`` mesh and placement
(``mesh``), the collectives (``collectives``), the row-sharded lookup
(``embedding``), the multi-process entry points (``distributed``) and the
sharded trainer (``trainer``)."""

from recommendation_tpu_torch.parallel.collectives import sharded_topk  # noqa: F401
from recommendation_tpu_torch.parallel.embedding import sharded_embedding_lookup  # noqa: F401
from recommendation_tpu_torch.parallel.mesh import (  # noqa: F401
    MeshSpec,
    batch_rows,
    make_mesh,
    shard_params,
    table_rows,
)
