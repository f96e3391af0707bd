"""The port's native host runtime (``recommendation_tpu_torch/native/``)
against its plain versions and the JAX package's: the C++ bucket builder's
tables bit for bit against the port's numpy builder and the JAX package's
numpy builder, on sorted and shuffled COO input; the C++ parser and
indexer against ``load_data`` and ``Interaction``; ``Interaction.from_files``
against ``Interaction(load_data(...))``, and a missing file. The numpy
paths are reached by hiding the library, as ``tests/test_native.py``
does. Skips only where ``g++`` is absent."""

import os
import shutil

import numpy as np
import pytest
import scipy.sparse as sp

import recommendation_tpu.native as jax_native
import recommendation_tpu_torch.native as native
from recommendation_tpu.data.interaction import Interaction as JaxInteraction
from recommendation_tpu.data.io import load_data as jax_load_data
from recommendation_tpu.graph import bucketed as jb
from recommendation_tpu_torch.data.interaction import Interaction
from recommendation_tpu_torch.data.io import FileIO, load_data
from recommendation_tpu_torch.data.synthetic import make_synthetic_dataset, write_dataset
from recommendation_tpu_torch.graph import bucketed as tb


@pytest.fixture(scope="module")
def lib():
    if shutil.which("g++") is None:
        pytest.skip("g++ unavailable: the native library cannot be built")
    return native.get_lib()


class _hidden:
    """Hide a native package's library (its numpy / Python paths run)."""

    def __init__(self, mod):
        self.mod = mod

    def __enter__(self):
        self.saved = self.mod._LIB, self.mod._LIB_TRIED
        self.mod._LIB, self.mod._LIB_TRIED = None, True

    def __exit__(self, *exc):
        self.mod._LIB, self.mod._LIB_TRIED = self.saved


@pytest.fixture(scope="module")
def dataset_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("native_ds")
    train, test = make_synthetic_dataset(n_users=50, n_items=80, n_interactions=1500, seed=11)
    write_dataset(str(d), train, test)
    return os.path.join(d, "train.txt"), os.path.join(d, "test.txt")


def _coo(seed=0, n_rows=301, n_cols=211, e=4000):
    rng = np.random.default_rng(seed)
    rows = (rng.pareto(0.7, size=e) % n_rows).astype(np.int64)
    cols = rng.integers(0, n_cols, e).astype(np.int64)
    mat = sp.coo_matrix((rng.normal(size=e).astype(np.float32), (rows, cols)),
                        shape=(n_rows, n_cols))
    mat.sum_duplicates()
    return mat.tocoo()


def _tables(csr):
    return {name: getattr(csr, name).cpu().numpy()
            for name in ("idx", "val", "edge", "ridx", "row_ptr", "gather_pos", "node_of_row",
                         "sep_dst", "sep_src_row", "work", "work_start")
            if getattr(csr, name) is not None}


def _jax_flat(csr):
    """The JAX package's tables, flattened as the port keeps them."""
    out = {}
    for name in ("idx", "val", "edge", "ridx"):
        parts = [np.asarray(getattr(b, name)).reshape(-1) for b in csr.buckets
                 if getattr(b, name) is not None]
        if parts:
            out[name] = np.concatenate(parts)
    for name in ("gather_pos", "node_of_row", "sep_dst", "sep_src_row"):
        if getattr(csr, name) is not None:
            out[name] = np.asarray(getattr(csr, name))
    return out


@pytest.mark.parametrize("square", [False, True], ids=["rect", "square"])
@pytest.mark.parametrize("order", ["sorted", "shuffled"])
def test_native_tables_equal_both_numpy_builders(lib, order, square):
    """The C++ builder's tables equal the port's numpy builder's and the JAX
    package's numpy builder's bit for bit (caps, slot order, row maps, the
    row-space indices and separable scales of a square pattern)."""
    if square:  # a normalized bipartite adjacency: row-space tables, separable values
        train, test = make_synthetic_dataset(n_users=60, n_items=100, n_interactions=2500, seed=3)
        coo = JaxInteraction(train, test).norm_adj.tocoo()
    else:
        coo = _coo(seed=1)
    r, c, v = coo.row.copy(), coo.col.copy(), coo.data.copy()
    if order == "shuffled":
        perm = np.random.default_rng(2).permutation(len(r))
        r, c, v = r[perm], c[perm], v[perm]
    fast = tb.build_bucketed(r, c, v, *coo.shape, device="cpu")
    assert (fast.ridx is not None) == (fast.sep_dst is not None) == square
    with _hidden(native):
        plain = tb.build_bucketed(r, c, v, *coo.shape, device="cpu")
    with _hidden(jax_native):
        ref = jb.build_bucketed(r, c, v, *coo.shape)
    assert fast.caps == plain.caps and fast.counts == plain.counts
    got, want = _tables(fast), _tables(plain)
    assert got.keys() == want.keys()
    for name in want:
        assert got[name].dtype == want[name].dtype and np.array_equal(got[name], want[name]), name
    assert fast.caps == tuple(b.cap for b in ref.buckets)
    for name, w in _jax_flat(ref).items():
        assert np.array_equal(got[name], w), name
    # the template (no values) too
    tpl = tb.build_bucketed(r, c, None, *coo.shape, device="cpu")
    with _hidden(native):
        tpl_plain = tb.build_bucketed(r, c, None, *coo.shape, device="cpu")
    for name, w in _tables(tpl_plain).items():
        assert np.array_equal(_tables(tpl)[name], w), name


def test_native_parse_matches_python(lib, dataset_files):
    from recommendation_tpu_torch.native.loader import parse_triples

    train_path, _ = dataset_files
    assert parse_triples(lib, train_path) == load_data(train_path) == jax_load_data(train_path)
    assert native.parse_triples_native(train_path) == load_data(train_path)


def test_native_indexing_matches_interaction(lib, dataset_files):
    from recommendation_tpu_torch.native.loader import load_indexed

    train_path, _ = dataset_files
    idx = load_indexed(lib, train_path)
    oracle = JaxInteraction(jax_load_data(train_path), [])
    assert idx.user_ids == [oracle.id2user[i] for i in range(oracle.user_num)]
    assert idx.item_ids == [oracle.id2item[i] for i in range(oracle.item_num)]
    assert np.array_equal(idx.users, oracle.edge_users)
    assert np.array_equal(idx.items, oracle.edge_items)
    assert np.array_equal(idx.weights, oracle.edge_weights.astype(np.float32))


def test_from_files_equivalent(lib, dataset_files):
    train_path, test_path = dataset_files
    fast = Interaction.from_files(train_path, test_path)
    oracle = Interaction(load_data(train_path), load_data(test_path))
    ref = JaxInteraction.from_files(train_path, test_path)
    for other in (oracle, ref):
        assert fast.user == other.user and fast.item == other.item
        assert fast.id2user == other.id2user and fast.id2item == other.id2item
        assert fast.test_set == other.test_set and fast.test_data == other.test_data
        assert fast.training_set_u == other.training_set_u
        assert fast.training_set_i == other.training_set_i
        assert fast.training_data == other.training_data
        assert (fast.norm_adj != other.norm_adj).nnz == 0
        assert np.array_equal(fast.edge_users, other.edge_users)
    with _hidden(native):
        slow = Interaction.from_files(train_path, test_path)
    assert slow.user == fast.user and (slow.norm_adj != fast.norm_adj).nnz == 0


def test_missing_file_handling(lib, tmp_path):
    from recommendation_tpu_torch.native.loader import load_indexed

    missing = str(tmp_path / "nonexistent.txt")
    assert load_indexed(lib, missing) is None
    assert native.parse_triples_native(missing) is None
    data = Interaction.from_files(missing)
    assert data.user_num == 0 and data.item_num == 0
    assert load_data(missing) == [] == FileIO.load_data_set(missing)


def test_file_io_writes(tmp_path):
    FileIO.write_file(str(tmp_path / "out"), "a.txt", "u1 i1 1\n")
    FileIO.write_file(str(tmp_path / "out"), "b.txt", ["u1 i2 1\n", "u2 i1 2\n"])
    assert FileIO.load_data_set(str(tmp_path / "out" / "b.txt")) == [["u1", "i2", 1.0],
                                                                     ["u2", "i1", 2.0]]
    assert (tmp_path / "out" / "a.txt").read_text() == "u1 i1 1\n"


def test_library_is_built_from_the_sources(lib):
    """The library is named by a hash of its sources and flags, written by
    rename (no partial file is ever at that name), and loads once."""
    from recommendation_tpu_torch.native import build

    path = build.library_path()
    assert os.path.exists(path) and lib._name == path
    assert build.build() == path and native.get_lib() is lib
    with open(os.path.join(build.HERE, "src", "bucketize.cpp")) as f:
        assert "bb_build" in f.read()
