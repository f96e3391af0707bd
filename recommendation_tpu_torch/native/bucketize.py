"""ctypes bindings for the native bucket-table builder (``src/bucketize.cpp``),
a copy of ``recommendation_tpu/native/bucketize.py``.

Returns plain numpy arrays in the exact layout of the numpy builder in
``graph/bucketed.py::build_bucketed`` (tested element for element); the
caller flattens them into a ``BucketedCSR``.
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Tuple

import numpy as np

_CONFIGURED = set()


def _configure(lib: ctypes.CDLL) -> ctypes.CDLL:
    if id(lib) in _CONFIGURED:
        return lib
    i32p = ctypes.POINTER(ctypes.c_int32)
    f32p = ctypes.POINTER(ctypes.c_float)
    i64p = ctypes.POINTER(ctypes.c_int64)
    lib.bb_build.restype = ctypes.c_void_p
    lib.bb_build.argtypes = [i32p, i32p, f32p, i32p,
                             ctypes.c_int64, ctypes.c_int64, ctypes.c_int64]
    lib.bb_num_buckets.restype = ctypes.c_int64
    lib.bb_num_buckets.argtypes = [ctypes.c_void_p]
    lib.bb_total_rows.restype = ctypes.c_int64
    lib.bb_total_rows.argtypes = [ctypes.c_void_p]
    lib.bb_bucket_info.argtypes = [ctypes.c_void_p, ctypes.c_int64, i64p, i64p]
    lib.bb_copy_bucket.argtypes = [ctypes.c_void_p, ctypes.c_int64, i32p, f32p, i32p]
    lib.bb_copy_rowmaps.argtypes = [ctypes.c_void_p, i32p, i32p]
    lib.bb_close.argtypes = [ctypes.c_void_p]
    _CONFIGURED.add(id(lib))
    return lib


def _i32p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def _f32p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def build_tables_native(
    lib: ctypes.CDLL,
    rows: np.ndarray,
    cols: np.ndarray,
    vals: Optional[np.ndarray],
    edge_ids: Optional[np.ndarray],
    n_rows: int,
    min_cap: int,
) -> Tuple[List[Tuple[int, np.ndarray, np.ndarray, np.ndarray]], np.ndarray, np.ndarray]:
    """(buckets as (cap, idx, val, edge) tuples, gather_pos, node_of_row)."""
    lib = _configure(lib)
    rows = np.ascontiguousarray(rows, dtype=np.int32)
    cols = np.ascontiguousarray(cols, dtype=np.int32)
    e = len(rows)
    v = None if vals is None else np.ascontiguousarray(vals, dtype=np.float32)
    eid = None if edge_ids is None else np.ascontiguousarray(edge_ids, dtype=np.int32)
    h = lib.bb_build(
        _i32p(rows), _i32p(cols),
        None if v is None else _f32p(v),
        None if eid is None else _i32p(eid),
        e, n_rows, min_cap,
    )
    if not h:
        raise RuntimeError("bb_build returned no tables")
    try:
        buckets = []
        for i in range(lib.bb_num_buckets(h)):
            cap = ctypes.c_int64()
            nb = ctypes.c_int64()
            lib.bb_bucket_info(h, i, ctypes.byref(cap), ctypes.byref(nb))
            cap, nb = int(cap.value), int(nb.value)
            idx = np.empty((nb, cap), dtype=np.int32)
            val = np.empty((nb, cap), dtype=np.float32)
            edge = np.empty((nb, cap), dtype=np.int32)
            lib.bb_copy_bucket(h, i, _i32p(idx), _f32p(val), _i32p(edge))
            buckets.append((cap, idx, val, edge))
        total = lib.bb_total_rows(h)
        gather_pos = np.empty(n_rows, dtype=np.int32)
        node_of_row = np.empty(total + 1, dtype=np.int32)
        lib.bb_copy_rowmaps(h, _i32p(gather_pos), _i32p(node_of_row))
        return buckets, gather_pos, node_of_row
    finally:
        lib.bb_close(h)
