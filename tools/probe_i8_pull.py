"""Time P1 with an int8 source and the int8 chain's fused layer against an
earlier build of ``csrc/gather.cu`` and against variants of the current
one, on the card, at the clustered graph's bucket tables (chip_smoke.py's
CLUSTERED_SHAPE), separable row space, d = 256 and 250.

Each build is compiled with the port's nvcc flags into ``--out`` and loaded
with ctypes; ptxas's registers and spills of each int8 kernel are printed
(its mangled template arguments: LANES, HAS_VAL, WIDE, REQUANT). The earlier build
(``--parent``: a ``gather.cu`` whose ``gather_sum`` takes the int8 source
as ``src_kind`` 2, with no epilogue) is timed for the pull alone; the
current build and each variant for the pull, and for the fused layer
(first: codes, no running sum; middle: both; last: the running sum alone)
beside the three launches it replaces (the pull, Q1, a torch add). Outputs
are compared with the parent's pull and with the three launches, bit for
bit. The pull is also timed with every index taken modulo 4096 (every
gathered code row an L2 hit). Times are chip_smoke.py's ``time_ms``:
medians of cold-L2 runs behind a spin kernel, the parent timed first and
last (drift).

A variant replaces lines of the current source before it is compiled
(``VARIANTS`` below): the conversion by I2F, the rows in flight, the
register cap, the running sum through L2 as normal data; and ablations whose sums are wrong (the scale
loads left out, a ceiling on staging them; the output stores, the
dequantization left out; an FMA a code). ``--extra`` builds other
sources whole. Run from
the repository's root on a machine with the card:

    git show <rev>:recommendation_tpu_torch/csrc/gather.cu > _chip/gather_parent.cu
    PYTHONPATH=. python3 tools/probe_i8_pull.py --parent _chip/gather_parent.cu

It prints one JSON line per width and writes them to ``--json``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys
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
from recommendation_tpu_torch.ops import gather as g  # noqa: E402

# name: the replacements made in a copy of the current source
VARIANTS = {
    "i2f": [("return __fsub_rn(__uint_as_float(__byte_perm(flipped, 0x4B000000u, 0x7650u | j)), "
             "8388736.0f);",
             "return static_cast<float>(static_cast<signed char>((flipped ^ 0x80808080u) >> "
             "(8 * j)));")],
    "unroll4": [("I8_UNROLL = 8;", "I8_UNROLL = 4;")],
    "unroll16": [("I8_UNROLL = 8;", "I8_UNROLL = 16;")],
    "min_blocks3": [("I8_MIN_BLOCKS = 2;", "I8_MIN_BLOCKS = 3;")],
    "min_blocks4_unroll4": [("I8_MIN_BLOCKS = 2;", "I8_MIN_BLOCKS = 4;"),
                            ("I8_UNROLL = 8;", "I8_UNROLL = 4;")],
    "cached_acc": [("        load_stream<16>(p, v);", "        load_row<16>(p, v);"),
                   ("        if (STREAM) store_stream<16>(o, v);",
                    "        if (STREAM) store_row<16>(o, v);")],
    "no_scale": [("sc[u] = __ldg(c.scale + s);", "sc[u] = 1.f;")],
    # ablations: the output stores left out (kept live), the dequantization
    # and scaling left out, one FMA a code in place of the product and sum
    "no_store": [("        store_cols<WIDE, false>(a.out + off, n, y);",
                  "        if (y[0] == 1234.5f) store_cols<WIDE, false>(a.out + off, n, y);")],
    "no_dequant": [("for (int k = 0; k < 16; ++k) v[k] = __fmul_rn(widen_code(w[k / 4], k % 4), s);",
                    "for (int k = 0; k < 16; ++k) v[k] = __uint_as_float(w[k / 4] + k);")],
    "fma": [("for (int k = 0; k < 16; ++k) v[k] = __fmul_rn(widen_code(w[k / 4], k % 4), s);",
             "for (int k = 0; k < 16; ++k) v[k] = widen_code(w[k / 4], k % 4);"),
            ("acc[q] = __fadd_rn(acc[q], HAS_VAL ? __fmul_rn(wt[u], v[q]) : v[q]);",
             "acc[q] = __fmaf_rn(v[q], HAS_VAL ? sc[u] * wt[u] : sc[u], acc[q]);")],
}
WRONG_SUMS = ("no_scale", "no_store", "no_dequant", "fma")  # not the pull's results
P, I32 = ctypes.c_void_p, ctypes.c_int


def compile_lib(src_text, name, out):
    """Build one source text into ``out/lib<name>.so``; return the library
    and its int8 kernels' ptxas lines."""
    src = os.path.join(out, f"{name}.cu")
    with open(src, "w") as f:
        f.write(src_text)
    path = os.path.join(out, f"lib{name}.so")
    r = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-I", build.CSRC, "-o", path, src],
                       capture_output=True, text=True)
    if r.returncode:
        raise SystemExit(f"nvcc {name} failed:\n{r.stdout}\n{r.stderr}")
    regs, fn = {}, ""
    for line in (r.stdout + r.stderr).splitlines():
        if "Compiling entry function" in line:
            fn = line.split("'")[1] if "'" in line else line
        elif "gather_sum_i8_kernel" in fn and ("registers" in line or "spill" in line):
            args = re.search(r"gather_sum_i8_kernelI(\w+?)EEv", fn)
            key = args.group(1) if args else fn[-40:]
            regs[key] = regs.get(key, "") + line.strip()[-60:] + "; "
    lib = ctypes.CDLL(path)
    if not hasattr(lib, "gather_sum_i8"):  # the parent: P1's int8 source as src_kind 2
        lib.gather_sum.argtypes = ([P, I32, P, I32] + [P] * 4 + [I32] + [P] * 4
                                   + [I32, I32, P, I32, P, I32] + [P] * 3)
        lib.gather_sum.restype = I32
    return lib, regs


def build_all(parent, out, names, extra=()):
    with open(os.path.join(build.CSRC, "gather.cu")) as f:
        current = f.read()
    texts = {"parent": open(parent).read(), "current": current}
    for item in extra:  # name=path: another source whole
        name, path = item.split("=", 1)
        texts[name] = open(path).read()
    for name in names:
        subs = VARIANTS[name]
        text = current
        for old, new in subs:
            if old not in text:
                raise SystemExit(f"variant {name}: '{old}' is not in gather.cu")
            text = text.replace(old, new)
        texts[name] = text
    with ThreadPoolExecutor(len(texts)) as ex:
        futs = {k: ex.submit(compile_lib, t, k, out) for k, t in texts.items()}
        built = {k: f.result() for k, f in futs.items()}
    for name, (_, regs) in built.items():
        for key, line in sorted(regs.items()):
            print(f"{name} i8<{key}>: {line}")
    return {k: v[0] for k, v in built.items()}


def parent_pull(lib, codes, scale, csr, idx):
    """The parent's P1 with an int8 source (no epilogue): y."""
    r, d, sd = csr.total_rows, codes.shape[1], codes.stride(0)
    work, work_start, n_p = csr.schedule
    out = torch.empty((r + 1, d), device="cuda")
    part = torch.empty((max(n_p, 1), sd), device="cuda")
    cnt = torch.empty(max(n_p, 1), dtype=torch.int32, device="cuda")
    rc = lib.gather_sum(codes.data_ptr(), 2, scale.data_ptr(), sd, None, idx.data_ptr(),
                        work.data_ptr(), work_start.data_ptr(), work.shape[0], None,
                        csr.sep_dst.data_ptr(), None, None, d, r, part.data_ptr(), sd,
                        cnt.data_ptr(), n_p, out.data_ptr(), None,
                        torch.cuda.current_stream().cuda_stream)
    assert rc == 0, rc
    return out


def use(lib):
    """Route the port's gather wrappers to ``lib`` (typed at first use)."""
    build._loaded["gather"] = lib


def pull(csr, codes, scale, idx=None, **kw):
    return g.gather_sum(codes, csr.ridx if idx is None else idx, csr.row_ptr, post=csr.sep_dst,
                        skip=csr.total_rows, schedule=csr.schedule, scale=scale, **kw)


def three_launches(csr, codes, scale, acc, requant):
    """The layer as P1, Q1 and a torch add."""
    y = pull(csr, codes, scale)
    total = y if acc is None else acc + y
    return (total, *g.quantize_rows(y, csr.sep_src_row)) if requant else total


def width(libs, csr, d):
    r = csr.total_rows
    rng = np.random.default_rng(d)
    x, acc = (torch.from_numpy(rng.normal(size=(r + 1, d)).astype(np.float32) * 0.05).cuda()
              for _ in range(2))
    x[r] = 0.0
    pre = csr.sep_src_row
    use(libs["current"])
    codes, scale = g.quantize_rows(x, pre)
    idx_l2 = torch.where(csr.ridx == r, csr.ridx, csr.ridx % 4096).contiguous()
    ref = parent_pull(libs["parent"], codes, scale, csr, csr.ridx)
    res = {"d": d, "rows": r + 1, "slots": csr.n_slots, "equal": {}, "pull_ms": {},
           "fused_ms": {}, "three_launches_ms": {}}
    layers = {"first": (None, True), "middle": (acc, True), "last": (acc, False)}
    rest = [k for k in libs if k != "parent"]
    for name in rest:
        use(libs[name])
        got = pull(csr, codes, scale)
        torch.cuda.synchronize()
        if name in WRONG_SUMS:
            continue
        res["equal"][f"{name}_pull_vs_parent"] = bool(torch.equal(got, ref))
        for layer, (a, rq) in layers.items():
            fused = pull(csr, codes, scale, acc=a, requant=rq, pre=pre if rq else None)
            three = three_launches(csr, codes, scale, a, rq)
            torch.cuda.synchronize()
            fused, three = ((t,) if isinstance(t, torch.Tensor) else t for t in (fused, three))
            res["equal"][f"{name}_{layer}_vs_three"] = all(
                torch.equal(p, q) for p, q in zip(fused, three))
    for name in ["parent"] + rest + ["parent"]:
        lib = libs[name]
        if name == "parent":
            res["pull_ms"].setdefault("parent", []).append(
                cs.time_ms(lambda: parent_pull(lib, codes, scale, csr, csr.ridx)))
            continue
        use(lib)
        res["pull_ms"][name] = cs.time_ms(lambda: pull(csr, codes, scale))
        res["fused_ms"][name] = {
            layer: cs.time_ms(lambda a=a, rq=rq: pull(csr, codes, scale, acc=a, requant=rq,
                                                      pre=pre if rq else None))
            for layer, (a, rq) in layers.items()}
    use(libs["current"])
    res["three_launches_ms"] = {
        layer: cs.time_ms(lambda a=a, rq=rq: three_launches(csr, codes, scale, a, rq))
        for layer, (a, rq) in layers.items()}
    res["q1_ms"] = cs.time_ms(lambda: g.quantize_rows(x, pre))
    res["add_ms"] = cs.time_ms(lambda: acc + x)
    res["l2_probe_ms"] = {
        "parent": cs.time_ms(lambda: parent_pull(libs["parent"], codes, scale, csr, idx_l2)),
        "current": cs.time_ms(lambda: pull(csr, codes, scale, idx=idx_l2))}
    res["bound_ms"] = {"pull": cs.pull_bound(csr, d, 1, row_bytes=g.padded_width(d) + 4)[0],
                       **{layer: cs.fused_bound(csr, d, a is not None, rq)[0]
                          for layer, (a, rq) in layers.items()}}
    return res


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", required=True, help="an earlier csrc/gather.cu")
    ap.add_argument("--out", default="_chip/probe_i8")
    ap.add_argument("--json", default="chiprun_out/probe_i8_pull.json")
    ap.add_argument("--variants", default=",".join(VARIANTS),
                    help="comma-separated names of VARIANTS to build beside the current source")
    ap.add_argument("--extra", action="append", default=[],
                    help="name=path: another gather.cu to build and time beside the current")
    ap.add_argument("--sass", default="", help="write cuobjdump -sass of the current build here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("probe_i8_pull: no CUDA device")
    os.makedirs(args.out, exist_ok=True)
    os.makedirs(os.path.dirname(args.json) or ".", exist_ok=True)
    card = cs.card_line()
    print(card)
    libs = build_all(args.parent, args.out, [v for v in args.variants.split(",") if v],
                     args.extra)
    if args.sass:
        cuobjdump = os.path.join(os.path.dirname(build._nvcc()), "cuobjdump")
        with open(args.sass, "w") as f:
            subprocess.run([cuobjdump, "-sass", os.path.join(args.out, "libcurrent.so")],
                           stdout=f, check=True)
    shape = cs.CLUSTERED_SHAPE
    pairs = make_clustered_interactions(**shape)
    data = ArrayInteraction(pairs, shape["n_users"], shape["n_items"], test_fraction=0.1)
    csr = DeviceGraph(data, backend="bucketed", device="cuda").norm_adj.pull
    lines = []
    for d in (cs.INT8_D, cs.INT8_PAD_D):
        line = {"card": card, **width(libs, csr, d)}
        print(json.dumps(line))
        lines.append(line)
    with open(args.json, "w") as f:
        json.dump(lines, f, indent=1)


if __name__ == "__main__":
    main()
