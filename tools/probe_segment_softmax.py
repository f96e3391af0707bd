"""Time S2 (GAT's segment softmax, ``csrc/segment.cu``) in the current
build and in variants of it, on the card, at GAT's shapes: the clustered
graph's bucket rows (H = 4 and 1) and the hard set's bidirectional edges
(H = 4).

For each build it times the fused forward (``attention_softmax``: the
logits gathered, the softmax; with and without the dropout's scale), the
fused backward (``attention_softmax_bwd``: with and without it), and the
same kernels on given logits (``segment_softmax_rows`` and its backward),
and holds every output to the current build's, bit for bit (a variant
changes how the work is spread, not the order of any sum). Times are
chip_smoke.py's ``time_ms``: medians of cold-L2 runs behind a spin kernel.

A variant replaces lines of the current source before it is compiled
(``VARIANTS`` below: the items of a tile, whose slots one block's threads
load at once). Run from the repository's root on a machine with the card:

    PYTHONPATH=. python3 tools/probe_segment_softmax.py

It prints one line per build and shape and writes them all to ``--json``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

sys.path.insert(0, os.getcwd())
import chip_smoke as cs  # noqa: E402
from recommendation_tpu_torch.data.interaction import Interaction  # noqa: E402
from recommendation_tpu_torch.data.synthetic import make_hard_dataset  # noqa: E402
from recommendation_tpu_torch.graph.device import DeviceGraph  # noqa: E402
from recommendation_tpu_torch.models.gat import attention_structure  # noqa: E402
from recommendation_tpu_torch.ops import build  # noqa: E402
from recommendation_tpu_torch.ops import segment as seg  # noqa: E402

ITEMS = "constexpr int S2_ITEMS = 16;"
# name: the replacements made in a copy of the current source
VARIANTS = {
    "items8": [(ITEMS, "constexpr int S2_ITEMS = 8;")],
    "items32": [(ITEMS, "constexpr int S2_ITEMS = 32;")],
}


def compile_lib(name, text, out):
    """Build one source text into ``out/lib<name>.so``; print the S2
    kernels' registers and spills from ptxas."""
    src = os.path.join(out, f"{name}.cu")
    with open(src, "w") as f:
        f.write(text)
    path = os.path.join(out, f"lib{name}.so")
    r = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-I", build.CSRC, "-o", path, src],
                       capture_output=True, text=True)
    if r.returncode:
        raise SystemExit(f"nvcc {name} failed:\n{r.stdout}\n{r.stderr}")
    fn = ""
    for line in (r.stdout + r.stderr).splitlines():
        if "Compiling entry function" in line:
            fn = line.split("'")[1] if "'" in line else line
        elif "softmax" in fn and ("registers" in line or "spill" in line):
            print(name, fn[fn.find("softmax"):][:48], line.strip()[-60:])
    return path


def build_all(out):
    with open(os.path.join(build.CSRC, "segment.cu")) as f:
        current = f.read()
    texts = {"current": current}
    for name, subs in VARIANTS.items():
        text = current
        for old, new in subs:
            if old not in text:
                raise SystemExit(f"variant {name}: '{old}' is not in segment.cu")
            text = text.replace(old, new)
        texts[name] = text
    with ThreadPoolExecutor(len(texts)) as ex:
        futs = {k: ex.submit(compile_lib, k, t, out) for k, t in texts.items()}
        return {k: f.result() for k, f in futs.items()}


def shape(paths, label, st, n_nodes, heads):
    """Every build's times at one structure and head count."""
    rng = np.random.default_rng(heads)

    def rand(*size, scale=1.0):
        return torch.from_numpy((rng.normal(size=size) * scale).astype(np.float32)).cuda()

    n_slots = st.idx.numel()
    a_src, a_dst = rand(n_nodes, heads, scale=2.0), rand(n_nodes, heads, scale=2.0)
    e, datt = rand(n_slots, heads, scale=2.0), rand(n_slots, heads)
    keep = torch.from_numpy(((rng.random((n_slots, heads)) > 0.2) / 0.8).astype(
        np.float32)).cuda()
    args = (a_src, a_dst, st.idx, st.dst, st.row_ptr, st.live, 0.2, st.schedule)
    rows, first = [], None
    for name, path in paths.items():
        build._loaded["segment"] = ctypes.CDLL(path)  # the wrappers type it at first use
        att, w = seg.attention_softmax(*args, keep)
        outs = [att, w, seg.attention_softmax_bwd(att, datt, *args, keep),
                seg.segment_softmax_rows(e, st.row_ptr, st.live, st.schedule),
                seg.segment_softmax_rows_bwd(att, datt, st.row_ptr, st.schedule)]
        first = first or outs
        row = {"build": name, "shape": label, "heads": heads,
               "same_bits": all(torch.equal(a, b) for a, b in zip(outs, first)),
               "fwd_ms": cs.time_ms(lambda: seg.attention_softmax(*args)),
               "fwd_keep_ms": cs.time_ms(lambda: seg.attention_softmax(*args, keep)),
               "bwd_keep_ms": cs.time_ms(lambda: seg.attention_softmax_bwd(att, datt, *args,
                                                                           keep)),
               "bwd_ms": cs.time_ms(lambda: seg.attention_softmax_bwd(att, datt, *args)),
               "softmax_only_fwd_ms": cs.time_ms(lambda: seg.segment_softmax_rows(
                   e, st.row_ptr, st.live, st.schedule)),
               "softmax_only_bwd_ms": cs.time_ms(lambda: seg.segment_softmax_rows_bwd(
                   att, datt, st.row_ptr, st.schedule))}
        print(json.dumps(row), flush=True)
        rows.append(row)
    build._loaded.pop("segment", None)
    return rows


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default="_chip/probe_s2", help="build directory (gitignored)")
    ap.add_argument("--json", default="chiprun_out/probe_segment_softmax.json")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("probe_segment_softmax: no CUDA device")
    os.makedirs(args.out, exist_ok=True)
    print(cs.card_line())
    paths = build_all(args.out)
    rows = []
    _, graph, _ = cs.clustered_build()
    st = attention_structure(graph)
    for heads in (4, 1):
        rows += shape(paths, "clustered bucket rows", st, graph.n_nodes, heads)
    del graph, st
    torch.cuda.empty_cache()
    train, test = make_hard_dataset()
    hard = DeviceGraph(Interaction(train, test), device="cuda")
    rows += shape(paths, "hard set edges", attention_structure(hard), hard.n_nodes, 4)
    os.makedirs(os.path.dirname(args.json) or ".", exist_ok=True)
    with open(args.json, "w") as f:
        json.dump({"card": cs.card_line(), "rows": rows}, f)
    if not all(r["same_bits"] for r in rows):
        raise SystemExit("a variant's outputs differ from the current build's")


if __name__ == "__main__":
    main()
