"""Build the native runtime: ``python -m recommendation_tpu_torch.native.build``.

``g++`` compiles ``src/loader.cpp`` and ``src/bucketize.cpp`` into
``recommendation_tpu_torch/_build/librec_native-<hash>.so``, the hash over
both sources (an edited source is rebuilt). The library is written under a
temporary name and renamed into place, so a process that loads it while
another builds it (several test workers at once) sees all of it or none.
No ``-march=native``: the library may be loaded on another host than the
one that built it.
"""

from __future__ import annotations

import hashlib
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
SRCS = [os.path.join(HERE, "src", "loader.cpp"), os.path.join(HERE, "src", "bucketize.cpp")]
BUILD_DIR = os.path.join(os.path.dirname(HERE), "_build")
FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")


def library_path() -> str:
    h = hashlib.sha256()
    for src in SRCS:
        with open(src, "rb") as f:
            h.update(f.read())
    h.update(" ".join(FLAGS).encode())
    return os.path.join(BUILD_DIR, f"librec_native-{h.hexdigest()[:12]}.so")


def build() -> str:
    """The library's path, compiled first where it is missing. Raises with
    g++'s output if the compiler fails or is absent."""
    out = library_path()
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = ["g++", *FLAGS, *SRCS, "-o", tmp]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except FileNotFoundError as e:
        raise RuntimeError(f"the native library needs g++: {e}") from e
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed (rc {proc.returncode}): {' '.join(cmd)}\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
    return out


if __name__ == "__main__":
    try:
        print(f"built {build()}")
    except RuntimeError as e:
        print(f"native build failed: {e}", file=sys.stderr)
        sys.exit(1)
