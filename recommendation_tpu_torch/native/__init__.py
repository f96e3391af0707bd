"""Native (C++) host-runtime components: a copy of
``recommendation_tpu/native/``.

The host runtime pieces that stay off the card (text ingestion, bucket
table assembly) have first-party C++ implementations in ``src/``, loaded
with ctypes: ``loader.cpp`` (the triple parser and id indexer behind
``Interaction.from_files``) and ``bucketize.cpp`` (the bucket tables of
``graph/bucketed.py::build_bucketed``, bit for bit the numpy builder's).

The library is built with ``g++`` at first use into
``recommendation_tpu_torch/_build/`` (``build.py``), under a name that
hashes the sources, so an edited source is rebuilt. A failed build raises
with g++'s output: there is no quiet fallback. The numpy builder and the
Python parser stay as the plain versions the tests compare against; a test
reaches them by hiding the library (``_LIB = None`` with ``_LIB_TRIED``
set), which makes ``get_lib`` return None.
"""

from __future__ import annotations

import ctypes
from typing import List, Optional

_LIB: Optional[ctypes.CDLL] = None
_LIB_TRIED = False


def get_lib() -> Optional[ctypes.CDLL]:
    """The loaded native library, built on first use (raises if g++
    fails); None only where a caller has hidden it."""
    global _LIB, _LIB_TRIED
    if not _LIB_TRIED:
        from recommendation_tpu_torch.native.build import build

        _LIB = ctypes.CDLL(build())
        _LIB_TRIED = True
    return _LIB


def parse_triples_native(path: str, with_weight: bool = True) -> Optional[List[list]]:
    """The C++ triple parser's ``load_data`` view; None where the library
    is hidden or the file cannot be read."""
    lib = get_lib()
    if lib is None:
        return None
    from recommendation_tpu_torch.native.loader import parse_triples

    return parse_triples(lib, path, with_weight)
