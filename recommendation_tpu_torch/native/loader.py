"""ctypes bindings for the native loader (``src/loader.cpp``), a copy of
``recommendation_tpu/native/loader.py``."""

from __future__ import annotations

import ctypes
from typing import List, Optional

import numpy as np


def _configure(lib: ctypes.CDLL) -> ctypes.CDLL:
    lib.rt_open.restype = ctypes.c_void_p
    lib.rt_open.argtypes = [ctypes.c_char_p, ctypes.c_int]
    for fn in (lib.rt_num_edges, lib.rt_num_users, lib.rt_num_items):
        fn.restype = ctypes.c_long
        fn.argtypes = [ctypes.c_void_p]
    lib.rt_copy_edges.argtypes = [
        ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_float),
    ]
    lib.rt_ids_blob_size.restype = ctypes.c_long
    lib.rt_ids_blob_size.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.rt_copy_ids_blob.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_char_p]
    lib.rt_close.argtypes = [ctypes.c_void_p]
    return lib


class IndexedTriples:
    """Edges as int32 arrays + external ids in insertion order — the exact
    ``Interaction.__generate_set`` id contract, computed natively."""

    def __init__(self, users, items, weights, user_ids, item_ids):
        self.users: np.ndarray = users
        self.items: np.ndarray = items
        self.weights: np.ndarray = weights
        self.user_ids: List[str] = user_ids
        self.item_ids: List[str] = item_ids


def load_indexed(lib: ctypes.CDLL, path: str, with_weight: bool = True) -> Optional[IndexedTriples]:
    lib = _configure(lib)
    handle = lib.rt_open(path.encode(), int(with_weight))
    if not handle:
        return None
    try:
        e = lib.rt_num_edges(handle)
        users = np.empty(e, dtype=np.int32)
        items = np.empty(e, dtype=np.int32)
        weights = np.empty(e, dtype=np.float32)
        if e:
            lib.rt_copy_edges(
                handle,
                users.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                items.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                weights.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            )

        def ids(which: int) -> List[str]:
            size = lib.rt_ids_blob_size(handle, which)
            buf = ctypes.create_string_buffer(size)
            lib.rt_copy_ids_blob(handle, which, buf)
            blob = buf.raw.decode()
            return blob.split("\n")[:-1] if blob else []

        return IndexedTriples(users, items, weights, ids(0), ids(1))
    finally:
        lib.rt_close(handle)


def parse_triples(lib: ctypes.CDLL, path: str, with_weight: bool = True) -> Optional[List[list]]:
    """List-of-triples compat view over the indexed arrays (io.load_data)."""
    idx = load_indexed(lib, path, with_weight)
    if idx is None:
        return None
    u_ids, i_ids = idx.user_ids, idx.item_ids
    return [
        [u_ids[u], i_ids[i], float(w)]
        for u, i, w in zip(idx.users, idx.items, idx.weights)
    ]
