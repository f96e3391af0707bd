"""Time P2 (``csrc/segment_sum.cu``, the pull over a row-sorted view)
against an earlier build of P1 (``csrc/gather.cu``) over the same view, on
the card, at the clustered graph's segment view (the segment backend's
LightGCN layer: 150,000 rows, 1.8M slots, d = 64 f32, the values in slot
order).

Each build is compiled with the port's nvcc flags into ``--out`` and loaded
with ctypes: the earlier ``gather.cu`` (``--parent``), the current
``segment_sum.cu`` and variants of it (``VARIANTS`` below: lines of the
source replaced before it is compiled). Each is timed on three inputs that
take the view apart:

  * ``view``: the view as the segment backend holds it;
  * ``l2``: every slot index taken modulo 4096, so every gathered row is an
    L2 hit: what is left is the kernel's own issue and latency;
  * ``sorted``: the same rows in order of length, longest first (slots and
    values moved with their rows), so neighbouring rows are of one length:
    what a kernel loses to rows of mixed length drops out.

Every build's output is held to the parent P1's bit for bit on each input.
Times are ``chip_smoke.py``'s ``time_ms`` (medians of cold-L2 runs behind a
spin kernel); the parent is timed first and last on each input (drift),
``torch.sparse.mm`` and the bytes bound on the view beside them. The
kernels' registers and spills come from ptxas, and the shared memory a
block of the d = 64 launch from a function appended to each source. Run
from the repository's root on a machine with the card:

    git show <rev>:recommendation_tpu_torch/csrc/gather.cu > _chip/gather_parent.cu
    PYTHONPATH=. python3 tools/probe_segment_view_pull.py --parent _chip/gather_parent.cu

It prints one JSON line per input and, with ``--json``, writes them all
to that file.
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
from recommendation_tpu_torch.data.synthetic import (  # noqa: E402
    ArrayInteraction,
    make_clustered_interactions,
)
from recommendation_tpu_torch.graph.device import DeviceGraph  # noqa: E402
from recommendation_tpu_torch.ops import build  # noqa: E402
from recommendation_tpu_torch.ops.gather import pull_schedule  # noqa: E402
from recommendation_tpu_torch.ops.segment import sum_schedule  # noqa: E402

# name: the replacements made in a copy of the current segment_sum.cu
U16, MB2 = "constexpr int U = 16;", "MIN_BLOCKS = 2;"
VARIANTS = {
    "u8_mb3": [(U16, "constexpr int U = 8;"), (MB2, "MIN_BLOCKS = 3;")],
    "no_gather": [("load_row<VEC>(src_col + static_cast<size_t>(st.slot[j + u].x) * a.d, v[u]);",
                   "for (int q = 0; q < VEC; ++q) v[u][q] = __int_as_float(st.slot[j + u].x);")],
}
L2_ROWS = 4096
P, I32 = ctypes.c_void_p, ctypes.c_int
# appended to each source it compiles: the dynamic shared memory a block of
# the d = 64 f32 launch with values (16 lanes an item), which ptxas does
# not report
SMEM_REPORT = {
    "gather_sum_kernel": 'extern "C" long long probe_smem_bytes() '
                         '{ return STAGES * sizeof(Tile<16, true>); }\n',
    "segment_sum_kernel": 'extern "C" long long probe_smem_bytes() '
                          '{ return 2 * (WARPS * 32 / 16) * sizeof(Stage); }\n',
}


def ptxas_report(log, kernel):
    """ptxas's lines (registers, spills) for each entry
    function whose name holds ``kernel``."""
    out, fn = [], ""
    for line in log.splitlines():
        if "Compiling entry function" in line:
            fn = line.split("'")[1] if "'" in line else line
        elif kernel in fn and ("registers" in line or "spill" in line):
            out.append(f"{fn[:60]}: {line.strip()}")
    return out


def compile_lib(src_text, name, out, kernel):
    """Build one source text into ``out/lib<name>.so``; its ptxas lines."""
    src = os.path.join(out, f"{name}.cu")
    with open(src, "w") as f:
        f.write(src_text + "\n" + SMEM_REPORT[kernel])
    path = os.path.join(out, f"lib{name}.so")
    r = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-I", build.CSRC, "-o", path, src],
                       capture_output=True, text=True)
    if r.returncode:
        raise SystemExit(f"nvcc {name} failed:\n{r.stdout}\n{r.stderr}")
    lib = ctypes.CDLL(path)
    lib.probe_smem_bytes.restype = ctypes.c_longlong
    if kernel == "gather_sum_kernel":
        lib.gather_sum.argtypes = ([P, I32] + [P] * 4 + [I32] + [P] * 4 + [I32, I32, P, P, I32]
                                   + [P] * 3)
        lib.gather_sum.restype = I32
    else:
        lib.segment_sum.argtypes = [P] * 5 + [I32] + [P] * 2 + [I32] + [P] * 2 + [I32] + [P] * 2
        lib.segment_sum.restype = I32
    return lib, ptxas_report(r.stdout + r.stderr, kernel)


def build_all(parent, out):
    with open(os.path.join(build.CSRC, "segment_sum.cu")) as f:
        current = f.read()
    texts = {"p1_parent": (open(parent).read(), "gather_sum_kernel"),
             "p2": (current, "segment_sum_kernel")}
    for name, subs in VARIANTS.items():
        text = current
        for old, new in subs:
            if old not in text:
                raise SystemExit(f"variant {name}: '{old}' is not in segment_sum.cu")
            text = text.replace(old, new)
        texts[f"p2_{name}"] = (text, "segment_sum_kernel")
    with ThreadPoolExecutor(len(texts)) as ex:
        futs = {k: ex.submit(compile_lib, t, k, out, kern) for k, (t, kern) in texts.items()}
        return {k: f.result() for k, f in futs.items()}


def _ptr(t):
    return None if t is None else t.data_ptr()


def _scratch(n_partials, d):
    if not n_partials:
        return None, None
    return (torch.empty((n_partials, d), device="cuda"),
            torch.empty(n_partials, dtype=torch.int32, device="cuda"))


def p1(lib, x, case):
    """The parent's P1 over the case's rows (its pull_schedule)."""
    work, start, n_p = case["p1_schedule"]
    out = torch.empty((case["row_ptr"].numel() - 1, x.shape[1]), device="cuda")
    part, cnt = _scratch(n_p, x.shape[1])
    rc = lib.gather_sum(x.data_ptr(), 0, None, case["idx"].data_ptr(), work.data_ptr(),
                        start.data_ptr(), work.shape[0], case["val"].data_ptr(), None, None, None,
                        x.shape[1], -1, _ptr(part), _ptr(cnt), n_p, out.data_ptr(), None,
                        torch.cuda.current_stream().cuda_stream)
    assert rc == 0, rc
    return out


def p2(lib, x, case):
    """P2 over the case's rows (its sum_schedule)."""
    work, start, n_p = case["p2_schedule"]
    out = torch.empty((case["row_ptr"].numel() - 1, x.shape[1]), device="cuda")
    part, cnt = _scratch(n_p, x.shape[1])
    rc = lib.segment_sum(x.data_ptr(), case["idx"].data_ptr(), case["row_ptr"].data_ptr(),
                         work.data_ptr(), start.data_ptr(), work.shape[0],
                         case["val"].data_ptr(), None, x.shape[1], _ptr(part), _ptr(cnt), n_p,
                         out.data_ptr(), torch.cuda.current_stream().cuda_stream)
    assert rc == 0, rc
    return out


def make_case(row_ptr, idx, val):
    return {"row_ptr": row_ptr, "idx": idx.contiguous(), "val": val.contiguous(),
            "p1_schedule": pull_schedule(row_ptr), "p2_schedule": sum_schedule(row_ptr)}


def sorted_case(row_ptr, idx, val):
    """The rows in order of length, longest first, each with its slots."""
    lens = torch.diff(row_ptr)
    order = torch.argsort(lens, descending=True, stable=True)
    new_lens = lens[order]
    ptr = torch.cat([row_ptr.new_zeros(1), torch.cumsum(new_lens, 0)])
    first = torch.repeat_interleave(row_ptr[:-1][order], new_lens)
    within = torch.arange(int(ptr[-1]), device=row_ptr.device) - torch.repeat_interleave(
        ptr[:-1], new_lens)
    slots = first + within
    return make_case(ptr, idx[slots], val[slots])


def row_stats(row_ptr, case):
    lens = torch.diff(row_ptr).cpu().numpy()
    slots = int(lens.sum())
    p2_items = case["p2_schedule"][1].cpu().numpy()
    return {"rows": int(len(lens)), "slots": slots, "median_row": float(np.median(lens)),
            "rows_le_8": float((lens <= 8).mean()),
            "slots_in_rows_le_8": float(lens[lens <= 8].sum() / slots),
            "rows_over_128": int((lens > 128).sum()),
            "slots_in_rows_over_128": float(lens[lens > 128].sum() / slots),
            "longest_row": int(lens.max()), "p1_items": int(case["p1_schedule"][0].shape[0]),
            "p2_items": int(case["p2_schedule"][0].shape[0]),
            "p2_mean_item_slots": float(np.diff(p2_items).mean())}


def run_case(libs, x, case):
    parent = libs["p1_parent"][0]
    ref = p1(parent, x, case)
    res = {}
    for name, (lib, _) in libs.items():
        if name == "p1_parent":
            continue
        got, again = p2(lib, x, case), p2(lib, x, case)
        torch.cuda.synchronize()
        res[f"{name}_equals_p1"] = bool(torch.equal(got, ref))
        res[f"{name}_repeats"] = bool(torch.equal(got, again))
    for name in ["p1_parent"] + [k for k in libs if k != "p1_parent"] + ["p1_parent"]:
        lib = libs[name][0]
        fn = p1 if name == "p1_parent" else p2
        res.setdefault(f"{name}_ms", []).append(cs.time_ms(lambda: fn(lib, x, case)))
    return res


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", required=True, help="an earlier csrc/gather.cu (P1)")
    ap.add_argument("--out", default="_chip/probe_p2")
    ap.add_argument("--json", help="write every line's results to this file too")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("probe_segment_view_pull: no CUDA device")
    os.makedirs(args.out, exist_ok=True)
    t0 = time.time()
    libs = build_all(args.parent, args.out)
    out = {"card": cs.card_line(), "build_s": time.time() - t0,
           "smem_bytes_a_block": {k: v[0].probe_smem_bytes() for k, v in libs.items()},
           "ptxas": {k: v[1] for k, v in libs.items()}}
    print(json.dumps(out), flush=True)
    shape = cs.CLUSTERED_SHAPE
    pairs = make_clustered_interactions(**shape)
    data = ArrayInteraction(pairs, shape["n_users"], shape["n_items"], test_fraction=0.1)
    graph = DeviceGraph(data, backend="segment", compute_dtype="float32", device="cuda")
    adj = graph.norm_adj
    seg = adj.seg
    val = adj.vals[seg.perm]
    x = torch.from_numpy(np.random.default_rng(4).normal(size=(adj.n_cols, cs.EMB)).astype(
        np.float32)).cuda()
    cases = {"view": make_case(seg.row_ptr, seg.idx, val),
             "l2": make_case(seg.row_ptr, seg.idx % L2_ROWS, val),
             "sorted": sorted_case(seg.row_ptr, seg.idx, val)}
    out["rows"] = {k: row_stats(c["row_ptr"], c) for k, c in cases.items() if k != "l2"}
    print(json.dumps({"rows": out["rows"]}), flush=True)
    for name, case in cases.items():
        out[name] = run_case(libs, x, case)
        print(json.dumps({name: out[name]}), flush=True)
    a_csr = torch.sparse_csr_tensor(seg.row_ptr, seg.idx.long(), val, size=adj.shape)
    live = seg.idx[val != 0]
    out["view"]["library_ms"] = cs.time_ms(lambda: torch.sparse.mm(a_csr, x))
    out["view"]["bound_ms"], out["view"]["bound_by"] = cs.bytes_bound(
        seg.n_slots * 8 + seg.row_ptr.numel() * 8 + torch.unique(live).numel() * cs.EMB * 4
        + adj.n_rows * cs.EMB * 4)
    print(json.dumps({"view": out["view"]}), flush=True)
    # the variants that leave work out (no_*) measure what it costs, not a sum
    bad = [f"{c}: {k}" for c in cases for k, v in out[c].items()
           if v is False and "_no_" not in k]
    if args.json:
        os.makedirs(os.path.dirname(args.json) or ".", exist_ok=True)
        with open(args.json, "w") as f:
            json.dump(out, f, indent=1)
    if bad:
        raise SystemExit(f"probe_segment_view_pull: P2 differs from P1 or from itself: {bad}")


if __name__ == "__main__":
    main()
