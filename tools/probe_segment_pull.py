"""Time S1 (the multi-head weighted pull) and its fused transpose variant
against an earlier build of ``csrc/segment.cu`` and against variants of the
current one, on the card, at GAT's shapes: the hard set's bidirectional
edges and the clustered graph's bucket rows, H = 4 and 1, d = 64.

Each build is compiled with the port's nvcc flags into ``--out`` and loaded
with ctypes. The earlier build (``--parent``, a copy of an older
``segment.cu`` with the stand-alone S3 kernel ``segment_dot``) is timed for
S1, for S1 over the transpose view with its weights gathered beforehand,
and for S3; the current build and each variant for S1 and the fused call
(``segment_pull_dot``). Outputs are compared with the first build's: S1
and the transpose pull bit for bit, the dot by its largest difference
(where the dot's lane order differs), and the forward slots no live slot
reaches must be 0. At the clustered rows, H = 4, S1 is also timed with
every index taken modulo 4096 (every gathered row an L2 hit). Times are
chip_smoke.py's ``time_ms``: medians of cold-L2 runs behind a spin kernel.

A variant replaces lines of the current source before it is compiled
(``VARIANTS`` below: the rows in flight, the register cap, the items a
tile gives a group). Run from the repository's root on a machine with the
card:

    git show <rev>:recommendation_tpu_torch/csrc/segment.cu > _chip/segment_parent.cu
    PYTHONPATH=. python3 tools/probe_segment_pull.py --parent _chip/segment_parent.cu

It prints one JSON line per shape and writes them all to ``--json``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
import time
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

# name: the replacements made in a copy of the current source
VARIANTS = {
    "floats32": [("FLOATS_IN_FLIGHT = 16;", "FLOATS_IN_FLIGHT = 32;"),
                 ("MIN_BLOCKS = 3;", "MIN_BLOCKS = 1;")],
    "floats64": [("FLOATS_IN_FLIGHT = 16;", "FLOATS_IN_FLIGHT = 64;"),
                 ("MIN_BLOCKS = 3;", "MIN_BLOCKS = 1;")],
    "two_items": [("static constexpr int ITEMS = GROUPS;",
                   "static constexpr int ITEMS = GROUPS * 2;")],
}
P, I32, I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


def compile_lib(src_text, name, out):
    """Build one source text into ``out/lib<name>.so``; print the S1
    kernels' registers and spills from ptxas."""
    src = os.path.join(out, f"{name}.cu")
    with open(src, "w") as f:
        f.write(src_text)
    path = os.path.join(out, f"lib{name}.so")
    r = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-I", build.CSRC, "-o", path, src],
                       capture_output=True, text=True)
    if r.returncode:
        raise SystemExit(f"nvcc {name} failed:\n{r.stdout}\n{r.stderr}")
    fn = ""
    for line in (r.stdout + r.stderr).splitlines():
        if "Compiling entry function" in line:
            fn = line.split("'")[1] if "'" in line else line
        elif "weighted_pull_kernel" in fn and ("registers" in line or "spill" in line):
            print(name, fn[fn.find("weighted_pull_kernel") + 20:][:30], line.strip()[-70:])
    lib = ctypes.CDLL(path)
    pull = [P] * 5 + [I32] * 3 + [P] * 2 + [I32] + [P]
    lib.segment_pull.argtypes, lib.segment_pull.restype = pull + [P], I32
    if hasattr(lib, "segment_pull_dot"):
        lib.segment_pull_dot.argtypes, lib.segment_pull_dot.restype = pull + [P] * 4 + [I64, P], I32
    if hasattr(lib, "segment_dot"):
        lib.segment_dot.argtypes, lib.segment_dot.restype = [P] * 4 + [I64, I32, I32] + [P] * 2, I32
    return lib


def build_all(parent, out):
    with open(os.path.join(build.CSRC, "segment.cu")) as f:
        current = f.read()
    texts = {"parent": open(parent).read(), "current": current}
    for name, subs in VARIANTS.items():
        text = current
        for old, new in subs:
            if old not in text:
                raise SystemExit(f"variant {name}: '{old}' is not in segment.cu")
            text = text.replace(old, new)
        texts[name] = text
    with ThreadPoolExecutor(len(texts)) as ex:
        futs = {k: ex.submit(compile_lib, t, k, out) for k, t in texts.items()}
        return {k: f.result() for k, f in futs.items()}


def _ptr(t):
    return None if t is None else t.data_ptr()


def _scratch(sched, width):
    n_p = sched[2]
    if not n_p:
        return None, None, 0
    return (torch.empty((n_p, width), device="cuda"),
            torch.empty(n_p, dtype=torch.int32, device="cuda"), n_p)


def pull(lib, x, w, idx, row_ptr, sched):
    heads, width = w.shape[1], x.shape[1]
    out = torch.empty((row_ptr.numel() - 1, width), device="cuda")
    part, cnt, n_p = _scratch(sched, width)
    rc = lib.segment_pull(x.data_ptr(), w.data_ptr(), idx.data_ptr(), sched[0].data_ptr(),
                          sched[1].data_ptr(), sched[0].shape[0], heads, width // heads,
                          _ptr(part), _ptr(cnt), n_p, out.data_ptr(),
                          torch.cuda.current_stream().cuda_stream)
    assert rc == 0, rc
    return out


def pull_dot(lib, g, w, idx, row_ptr, fpos, hsrc, node, sched):
    heads, width = w.shape[1], g.shape[1]
    out = torch.empty((row_ptr.numel() - 1, width), device="cuda")
    dot = torch.empty(w.shape, device="cuda")
    part, cnt, n_p = _scratch(sched, width)
    rc = lib.segment_pull_dot(g.data_ptr(), w.data_ptr(), idx.data_ptr(), sched[0].data_ptr(),
                              sched[1].data_ptr(), sched[0].shape[0], heads, width // heads,
                              _ptr(part), _ptr(cnt), n_p, out.data_ptr(), fpos.data_ptr(),
                              hsrc.data_ptr(), _ptr(node), dot.data_ptr(), w.shape[0],
                              torch.cuda.current_stream().cuda_stream)
    assert rc == 0, rc
    return out, dot


def segment_dot(lib, a, ia, b, ib, heads):
    out = torch.empty((ia.numel(), heads), device="cuda")
    rc = lib.segment_dot(a.data_ptr(), ia.data_ptr(), b.data_ptr(), ib.data_ptr(), ia.numel(),
                         heads, a.shape[1] // heads, out.data_ptr(),
                         torch.cuda.current_stream().cuda_stream)
    assert rc == 0, rc
    return out


def shape(libs, st, n_nodes, heads, l2_probe):
    rng = np.random.default_rng(heads)
    width = heads * cs.EMB
    x, gy = (torch.from_numpy(rng.normal(size=(n_nodes, width)).astype(np.float32)).cuda()
             for _ in range(2))
    e = torch.from_numpy((rng.normal(size=(st.idx.numel(), heads)) * 2).astype(np.float32))
    att = cs.segment_softmax_rows_plain(e.cuda(), st.row_ptr, st.live)
    fpos = st.t_fpos
    wt = torch.where((fpos >= 0)[:, None], att[fpos.long().clamp(min=0)],
                     torch.zeros((), device="cuda")).contiguous()
    parent, rest = libs["parent"], [k for k in libs if k != "parent"]
    ref = pull(parent, x, att, st.idx, st.row_ptr, st.schedule)
    ref_t = pull(parent, gy, wt, st.t_idx, st.t_row_ptr, st.t_schedule)
    ref_dot = segment_dot(parent, gy, st.dst, x, st.idx, heads)
    res = {}
    for name in rest:
        lib = libs[name]
        got = pull(lib, x, att, st.idx, st.row_ptr, st.schedule)
        dh, dot = pull_dot(lib, gy, att, st.t_idx, st.t_row_ptr, fpos, x, st.t_node,
                           st.t_schedule)
        torch.cuda.synchronize()
        res[f"{name}_vs_parent"] = {
            "s1_equal": bool(torch.equal(got, ref)), "dh_equal": bool(torch.equal(dh, ref_t)),
            "dot_max_abs_diff": float((dot[st.live] - ref_dot[st.live]).abs().max()),
            "dead_dot_zero": bool(not dot[~st.live].any())}
    for name in ["parent"] + rest + ["parent"]:  # the parent first and last: drift
        lib = libs[name]
        res.setdefault(f"s1_{name}", []).append(
            cs.time_ms(lambda: pull(lib, x, att, st.idx, st.row_ptr, st.schedule)))
        if name == "parent":
            res.setdefault("s1_transpose_parent", []).append(cs.time_ms(
                lambda: pull(lib, gy, wt, st.t_idx, st.t_row_ptr, st.t_schedule)))
            res.setdefault("s3_parent", []).append(
                cs.time_ms(lambda: segment_dot(lib, gy, st.dst, x, st.idx, heads)))
        else:
            res[f"fused_{name}"] = cs.time_ms(lambda: pull_dot(
                lib, gy, att, st.t_idx, st.t_row_ptr, fpos, x, st.t_node, st.t_schedule))
    if l2_probe:  # every gathered row an L2 hit
        idx_l2 = (st.idx % 4096).contiguous()
        for name in ("parent", "current"):
            res[f"l2_probe_s1_{name}"] = cs.time_ms(
                lambda: pull(libs[name], x, att, idx_l2, st.row_ptr, st.schedule))
    return res


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", required=True, help="an earlier csrc/segment.cu")
    ap.add_argument("--out", default="_chip/probe_build")
    ap.add_argument("--json", default="chiprun_out/probe_segment_pull.json")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("probe_segment_pull: no CUDA device")
    os.makedirs(args.out, exist_ok=True)
    t0 = time.time()
    libs = build_all(args.parent, args.out)
    out = {"card": cs.card_line(), "build_s": time.time() - t0}
    print(out, flush=True)
    hard = DeviceGraph(Interaction(*make_hard_dataset()), compute_dtype="float32", device="cuda")
    st = attention_structure(hard)
    for h in (4, 1):
        out[f"hard_h{h}"] = shape(libs, st, hard.n_nodes, h, False)
        print(json.dumps({f"hard_h{h}": out[f"hard_h{h}"]}), flush=True)
    _, graph, _ = cs.clustered_build()
    st = attention_structure(graph)
    for h in (4, 1):
        out[f"clustered_h{h}"] = shape(libs, st, graph.n_nodes, h, h == 4)
        print(json.dumps({f"clustered_h{h}": out[f"clustered_h{h}"]}), flush=True)
    os.makedirs(os.path.dirname(args.json) or ".", exist_ok=True)
    with open(args.json, "w") as f:
        json.dump(out, f, indent=1)


if __name__ == "__main__":
    main()
