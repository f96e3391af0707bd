"""Mesh and placement (counterpart of ``recommendation_tpu/parallel/mesh.py``).

A ``(data, model)`` mesh over the ranks of the default process group, one
rank a process and a device:

  * ``data``: the batch dimension; each data rank takes ``B / data`` rows
    of every batch, and the gradients are summed over the data group;
  * ``model``: table rows; each model rank holds ``rows / model`` rows of
    the embedding tables, and lookups and top-k merges ride collectives
    over the model group (``parallel/embedding.py``, ``collectives.py``).

The mesh is a ``torch.distributed.device_mesh.DeviceMesh`` whose rank
``r`` sits at ``(r // model, r % model)``, the row-major order of the JAX
package's ``reshape(data, model)``. Where GSPMD places arrays by their
sharding, a rank of the port holds only its own rows: ``table_rows`` and
``batch_rows`` say which, and ``shard_params`` cuts a full parameter dict
to them. A table is row-sharded only where its rows divide by ``model``;
otherwise every model rank holds all of it (JAX ``trainer.py:71-77``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

DATA_AXIS = "data"
MODEL_AXIS = "model"
# the parameters a model rank holds a row shard of (JAX ``trainer.py:38``);
# a flattened nested name matches on its last part ("d.user_emb")
TABLE_KEYS = ("user_emb", "item_emb", "t_user_emb", "t_item_emb", "relation_emb")


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    data: int
    model: int

    @property
    def n_devices(self) -> int:
        return self.data * self.model


def default_mesh_shape(n_devices: int) -> MeshSpec:
    """Split devices ~evenly: model axis gets the largest power-of-two
    ≤ √n, data gets the rest. 8 devices → (data=4, model=2). (A copy of
    the JAX package's function.)"""
    model = 1
    while model * 2 <= max(1, int(np.sqrt(n_devices))) and n_devices % (model * 2) == 0:
        model *= 2
    return MeshSpec(data=n_devices // model, model=model)


def make_mesh(spec: Optional[MeshSpec] = None, device_type: str = "cuda") -> DeviceMesh:
    """The ``(data, model)`` mesh over every rank of the default group
    (``parallel.distributed.initialize`` opens it). ``spec`` defaults to
    ``default_mesh_shape(world size)``; it must cover the world."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs the default process group: call "
                           "parallel.distributed.initialize first")
    world = dist.get_world_size()
    spec = spec if spec is not None else default_mesh_shape(world)
    if spec.n_devices != world:
        raise ValueError(f"mesh {spec} needs {spec.n_devices} ranks; the world has {world}")
    layout = torch.arange(world).reshape(spec.data, spec.model)
    return DeviceMesh(device_type, layout, mesh_dim_names=(DATA_AXIS, MODEL_AXIS))


def axis_size(mesh: DeviceMesh, axis: str) -> int:
    return int(mesh.shape[mesh.mesh_dim_names.index(axis)])


def axis_rank(mesh: DeviceMesh, axis: str) -> int:
    """This rank's coordinate along ``axis``."""
    return int(mesh.get_local_rank(axis))


def axis_group(mesh: DeviceMesh, axis: str):
    return mesh.get_group(axis)


def mesh_spec(mesh: DeviceMesh) -> MeshSpec:
    return MeshSpec(axis_size(mesh, DATA_AXIS), axis_size(mesh, MODEL_AXIS))


def table_rows(n_rows: int, mesh: DeviceMesh) -> Optional[tuple[int, int]]:
    """The row range ``[lo, hi)`` of an ``n_rows`` table that this model
    rank holds, or None where the rows do not divide by ``model`` (the
    table is replicated)."""
    n_model = axis_size(mesh, MODEL_AXIS)
    if n_rows % n_model:
        return None
    per = n_rows // n_model
    lo = axis_rank(mesh, MODEL_AXIS) * per
    return lo, lo + per


def batch_rows(batch_size: int, mesh: DeviceMesh) -> tuple[int, int]:
    """The rows ``[lo, hi)`` of every batch that this data rank takes."""
    n_data = axis_size(mesh, DATA_AXIS)
    if batch_size % n_data:
        raise ValueError(f"batch.size {batch_size} does not divide by the data axis {n_data}")
    per = batch_size // n_data
    lo = axis_rank(mesh, DATA_AXIS) * per
    return lo, lo + per


def shard_params(params: Dict[str, torch.Tensor], mesh: DeviceMesh,
                 table_keys=TABLE_KEYS) -> tuple[Dict[str, torch.Tensor], set]:
    """A full parameter dict cut to this rank, and the names it holds as
    row shards: each 2-D table in ``table_keys`` (by the last part of its
    name) whose rows divide by ``model`` becomes a copy of this model
    rank's rows; every other tensor stays whole (replicated)."""
    out, sharded = {}, set()
    for name, x in params.items():
        rows = (table_rows(x.shape[0], mesh)
                if name.split(".")[-1] in table_keys and x.ndim == 2 else None)
        if rows is None:
            out[name] = x
        else:
            out[name] = x[rows[0]:rows[1]].clone()
            sharded.add(name)
    return out, sharded
