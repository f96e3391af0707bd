// Row gather (K7) and bucket pull (P1) of the bucketed large-graph backend,
// on Hopper (sm_90a).
//
// K7 replaces tools/probe_gather_ceiling.py::kernel (:130, pl.pallas_call at
// :162), the per-row DMA gather that measures the operation bounding the JAX
// package's bucketed backend:
//
//     out[i, :] = x[idx[i], :]        x [N, d] f32 or bf16, idx i32 [S]
//
// In the port it is the chain's node->row and row->node reorders
// (recommendation_tpu/graph/bucketed.py:644, :664, :676, :693) and the last
// step of `pull` (:486). What bounds it on an H100: it moves bytes only
// (4 S of indices, S d itemsize read and as many written), 0.5 ms per GB of
// rows at 3.35 TB/s. The TPU kernel keeps 8 row DMAs in flight from one core;
// here a row is split into 16-byte units (8, 4 or 2 bytes where the width or
// the pointers do not allow 16), the lanes of a warp copy consecutive units of
// a row (coalesced), a warp takes 32 / units-per-row rows at once, and every
// warp of the card has its rows in flight at the same time. Offsets are 64
// bit: idx * d passes 2^31 at the larger graphs. A copy is exact, so the
// result equals x[idx] bit for bit. Indices are not checked here: the bucket
// tables are validated once when they are built.
//
// P1 replaces no TPU kernel. It is the bucket pull that the JAX package
// leaves to XLA (`pull` :461-486, `pull_rowspace` :563-607,
// `_gather_sum_rowspace` :610-616): per bucket a [rows, cap, d] gather and a
// sum over cap. Here every bucket is one flat table of slot indices, and one
// launch computes, for every row r < n_out,
//
//     y[r, :] = post[r] * sum_{s in row r's slots} val[s] * (src[idx[s], :] + add[idx[s], :])
//     total[r, :] = (acc[r, :] + y[r, :]) * final[r]
//
// in f32, with `val`, `post`, `add`, `acc` and `final` optional (y alone
// when neither acc nor final is given, else total, and y beside it where
// the caller asks) and `src` f32 or bf16 (widened exactly). The epilogue is the separable
// chain's running sum and last scaling (recommendation_tpu/graph/
// bucketed.py:654-655, :687-688), each product and sum rounded once (no
// FMA), as the plain version's elementwise operations are. Slots whose index
// equals `skip` are left out: the caller passes the row that is zero in
// `src` and `add` (the row-space zero row), so leaving them out changes no
// sum.
//
// What bounds it: bytes. A layer of the bench's large graph (144,871 rows,
// 2.55M slots, 1.8M live, d = 64 f32) reads 10 MB of slot indices and writes
// 37 MB, and gathers 1.8M source rows of 256 bytes, 461 MB, from a 37 MB
// table: from device memory at 3.35 TB/s that is 0.15 ms, but the table
// fits the 50 MB L2, which serves a row's later gathers. The design:
//   * A work list (ops/gather.py::pull_schedule) of items with their slot
//     ranges: a row, or a CHUNK-slot piece of a longer row (a power-law
//     graph's hub rows hold 10^4 slots). Consecutive items cover consecutive
//     slots, so a run of them is one contiguous range of indices.
//   * Tiles: a block sums a tile of items, two per group of lanes, after
//     copying the tile's descriptors and slot indices (and values) into
//     shared memory with cp.async. Blocks are persistent and walk the tiles
//     with the grid's stride, the next STAGES - 1 tiles' copies in flight
//     while one sums, so no item waits a round trip to memory for its
//     indices before its gathers start. The walk, the row loads and the
//     split rows' counter are csrc/pull_tiles.cuh's, shared with S1
//     (csrc/segment.cu).
//   * A group of lanes per item: as many lanes as a row needs for 16-byte
//     loads, 16 at d = 64 in f32, so a warp carries two items (neighbours
//     in a bucket, so of one length) and walks them in step. A group keeps
//     UNROLL source rows in flight.
//   * The running sum is read and written as streaming data (evict-first
//     loads and stores): each of its rows is touched once a layer.
//   * A split row's pieces write their partial sums to scratch; the group
//     that finishes the row's last piece (a counter per row, zeroed on the
//     stream ahead of each call, after a memory fence) adds them in piece
//     order and runs the epilogue. Every float sum has a fixed order
//     whichever group finishes last, so a call repeats bit for bit; the
//     only atomic is the integer counter.
//
// P1 also takes an int8 source (the bucketed backend's int8 propagation,
// recommendation_tpu/graph/bucketed.py:507-527, :545-560): codes int8
// [N, d] in rows of sd bytes (sd a multiple of 16, the padding codes 0)
// beside a scale f32 [N], a slot adding (float(q) * scale[s]) * val[s], each
// product rounded once, as the plain version dequantizes and weighs. A
// lane loads 16 codes with one 16-byte load and each slot's scale once;
// the work list, the tiles and the split-row counter are the f32 path's.
// It is a kernel of its own (gather_sum_i8_kernel) beside the float one,
// whose code stays as it was: one body for both (a column chunk that may
// pass d, a source stride apart from d) ran the f32 layer slower on the
// H100 at the same registers (PERF.md §6).
// What bounds it: bytes, each distinct source row d_pad + 4 bytes once, the
// slot indices (and values) and the f32 output; the code table (39 MB at
// the clustered graph, d = 256) fits the 50 MB L2. On the H100 it runs at
// about a quarter of that bound, and tools/probe_i8_pull.py takes it apart
// (PERF.md §6): with every gather an L2 hit it is as slow, and leaving out
// the scale loads, the output stores or the dequantization saves 1, 14 and
// 16% of it, so no one resource holds it; most rows hold at most 8 slots,
// and a group waits out a gather's round trip for each of its items
// between the tile's barriers. A code is widened by a byte permute into
// the mantissa of 2^23 and one exact subtraction (dequant16), not by I2F,
// which Hopper issues at a quarter of the FP32 rate (the conversions took
// 12% of the pull's time), so every sum is the same to the bit. The lane's state takes 128 registers,
// two blocks an SM: a lower cap spills and runs slower, as do 4 or 16
// rows in flight and a warp an item with 8-code chunks.
//
// The int8 chain's layer is one launch of this kernel (the fused epilogue,
// recommendation_tpu/graph/bucketed.py:658-661): per row r,
//
//     y = post[r] * sum_slots (float(q) * scale[s]) * val[s]
//     total[r] = acc[r] + y                      (acc absent on layer 1)
//     codes[r], qscale[r] = Q1(y * pre[r])       (not on the last layer)
//
// with y itself not written. total is streamed (evict-first), so the
// layer's 300 MB of f32 rows do not evict the code table from L2; the
// codes, which the next layer gathers, are written normally. The row's
// absmax is a shuffle of fmaxf over the group of lanes that holds it (one
// 16-code chunk a lane up to d = 512); past that a lane sums several
// chunks in turn, writes y * pre to a scratch row and reads it back for
// the codes. The codes and scale are Q1's to the bit (below), and the sums
// keep the pull's slot order, so a fused layer equals P1, Q1 and an add in
// three launches bit for bit. The int8 source runs the forward pulls only:
// no `add` or `final` (the backward is f32).
//
// Q1 (`quantize_rows`) replaces no TPU kernel either: it is XLA's
// _pack_int8_rows (graph/bucketed.py:507-519), with the separable pull's
// source scaling `xp * sep_src_row` (:591) as its optional `pre`: per row,
//
//     xs = x * pre
//     scale = max(max|xs|, 1e-12) * f32(1/127)
//     q = clip(rint(xs / scale), -127, 127)
//
// with the scale a product by the f32 reciprocal (what XLA makes of the
// division under jit) and each code a true division, rounded half to even,
// so the codes and scales equal the jitted JAX function's bit for bit. One
// warp a row: its absmax by a butterfly of fmaxf (exact in any order), then
// the codes, four to a 32-bit store. What bounds it: bytes (the row read
// once, d_pad + 4 bytes written). In the int8 chain it quantizes layer 0's
// source only; the later layers' codes come from the fused epilogue.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "pull_tiles.cuh"

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int WARPS = 8;   // warps per block
constexpr int UNROLL = 8;  // source rows in flight per item
constexpr int STAGES = 3;  // tiles in shared memory: the one summed, two in flight
constexpr int CHUNK = 128; // slots per work item of a split row (ops/gather.py::CHUNK)
constexpr int I8_UNROLL = 8;      // source rows in flight per item, int8 source
constexpr int I8_MIN_BLOCKS = 2;  // int8 blocks an SM holds at once (caps the registers)

using ::load_row;  // the f32 rows' (pull_tiles.cuh), beside the bf16 overload below

// bf16 is carried as its 16 bits; widening is a shift into the high half
template <int VEC>
__device__ __forceinline__ void load_row(const uint16_t* p, float (&v)[VEC]) {
    if constexpr (VEC % 8 == 0) {
#pragma unroll
        for (int k = 0; k < VEC; k += 8) {
            const uint4 t = __ldg(reinterpret_cast<const uint4*>(p + k));
            const uint32_t w[4] = {t.x, t.y, t.z, t.w};
#pragma unroll
            for (int q = 0; q < 4; ++q) {
                v[k + 2 * q] = __uint_as_float(w[q] << 16);
                v[k + 2 * q + 1] = __uint_as_float(w[q] & 0xffff0000u);
            }
        }
    } else {
#pragma unroll
        for (int k = 0; k < VEC; ++k) v[k] = __uint_as_float(static_cast<uint32_t>(__ldg(p + k)) << 16);
    }
}

// VEC f32 of a row read once (the running sum): marked to be evicted first
template <int VEC>
__device__ __forceinline__ void load_stream(const float* p, float (&v)[VEC]) {
    if constexpr (VEC % 4 == 0) {
#pragma unroll
        for (int k = 0; k < VEC; k += 4) {
            const float4 t = __ldcs(reinterpret_cast<const float4*>(p + k));
            v[k] = t.x; v[k + 1] = t.y; v[k + 2] = t.z; v[k + 3] = t.w;
        }
    } else {
#pragma unroll
        for (int k = 0; k < VEC; ++k) v[k] = __ldcs(p + k);
    }
}

template <int VEC>
__device__ __forceinline__ void store_stream(float* o, const float (&v)[VEC]) {
    if constexpr (VEC % 4 == 0) {
#pragma unroll
        for (int k = 0; k < VEC; k += 4)
            __stcs(reinterpret_cast<float4*>(o + k), make_float4(v[k], v[k + 1], v[k + 2], v[k + 3]));
    } else {
#pragma unroll
        for (int k = 0; k < VEC; ++k) __stcs(o + k, v[k]);
    }
}

struct Sum {  // one P1 call's operands (add, val, post, acc, final, partial, count, out, total may be null)
    const void* src;
    const float* add;
    const int* idx;
    const int4* work;              // [n_work] (row, piece, the row's first partial, the row's pieces)
    const long long* work_start;   // [n_work + 1] each item's first slot
    int n_work;
    const float* val;
    const float* post;
    const float* acc;
    const float* final_;
    int d;
    int skip;
    float* partial;
    int* count;
    float* out;    // y
    float* total;  // (acc + y) * final
};

// An int8 source beside its Sum (whose src holds the codes; out receives y,
// or total receives acc + y, acc optional), and the fused epilogue's next
// layer (qcodes null: none)
struct Codes {
    const float* scale;  // [N] the rows' scales
    int sd;              // the code rows' stride in bytes (a multiple of 16); partial's and xs's in floats
    signed char* qcodes; // [n_out, qsd] the codes of y * pre
    float* qscale;       // [n_out] their scales
    const float* pre;    // [n_out] (null: 1)
    float* xs;           // [n_out, sd] y * pre of rows that take several passes (null where one does)
    int qsd;             // the new code rows' stride: d rounded up to 16
};

// The epilogue of row r at columns col .. col + VEC: y = post * sum, then
// total = (acc + y) * final, each rounded once
template <int VEC>
__device__ __forceinline__ void finish(const Sum& a, int r, size_t col, const float (&sum)[VEC],
                                       float post, float fin) {
    const size_t off = static_cast<size_t>(r) * a.d + col;
    float y[VEC];
#pragma unroll
    for (int k = 0; k < VEC; ++k) y[k] = __fmul_rn(sum[k], post);
    if (a.out != nullptr) store_row<VEC>(a.out + off, y);
    if (a.total == nullptr) return;
    if (a.acc != nullptr) {
        float in[VEC];
        load_stream<VEC>(a.acc + off, in);
#pragma unroll
        for (int k = 0; k < VEC; ++k) y[k] = __fadd_rn(in[k], y[k]);
    }
    if (a.final_ != nullptr) {
#pragma unroll
        for (int k = 0; k < VEC; ++k) y[k] = __fmul_rn(y[k], fin);
    }
    store_stream<VEC>(a.total + off, y);
}

// Code j (0..3) of a word of codes whose sign bits were flipped (so byte j
// holds q + 128), as a float, exactly: that byte under 2^23's exponent is
// 2^23 + q + 128, and the subtraction is exact. A permute and an add at the
// full issue rate, where a conversion (I2F) issues at a quarter of it.
__device__ __forceinline__ float widen_code(unsigned flipped, int j) {
    return __fsub_rn(__uint_as_float(__byte_perm(flipped, 0x4B000000u, 0x7650u | j)), 8388736.0f);
}

// 16 int8 codes of a gathered row, widened exactly and scaled by the row's
// scale, each product rounded once
__device__ __forceinline__ void dequant16(const int4 raw, float s, float (&v)[16]) {
    const unsigned w[4] = {static_cast<unsigned>(raw.x) ^ 0x80808080u, static_cast<unsigned>(raw.y) ^ 0x80808080u,
                           static_cast<unsigned>(raw.z) ^ 0x80808080u, static_cast<unsigned>(raw.w) ^ 0x80808080u};
#pragma unroll
    for (int k = 0; k < 16; ++k) v[k] = __fmul_rn(widen_code(w[k / 4], k % 4), s);
}

constexpr float kInv127 = 1.0f / 127.0f;  // rounded once, at compile time

// Q1's code of xs at scale s, in the low byte: clip(rint(xs / s), -127,
// 127) with a true division, rounded half to even. Clipping first changes
// nothing (the bounds are integers, and fmaxf sends NaN to -127 either
// way); adding 1.5 * 2^23 rounds to an integer in the same mode and leaves
// it in the low byte in two's complement, with no conversion.
__device__ __forceinline__ unsigned code_byte(float xs, float s) {
    const float q = fminf(fmaxf(__fdiv_rn(xs, s), -127.f), 127.f);
    return __float_as_uint(__fadd_rn(q, 12582912.0f));
}

// four code bytes (the low byte of each) in one word, the first lowest
__device__ __forceinline__ unsigned pack4(unsigned b0, unsigned b1, unsigned b2, unsigned b3) {
    return __byte_perm(__byte_perm(b0, b1, 0x0040u), __byte_perm(b2, b3, 0x0040u), 0x5410u);
}

// VEC f32 of the int8 source's epilogue at a chunk's columns below d: by
// 16-byte accesses where the whole chunk is below d and WIDE allows them,
// else one at a time; streamed (evict-first) or not
template <bool WIDE>
__device__ __forceinline__ void load_cols(const float* p, int n, float (&v)[16]) {
    if (WIDE && n >= 16) {
        load_stream<16>(p, v);
    } else {
#pragma unroll
        for (int k = 0; k < 16; ++k) v[k] = k < n ? __ldcs(p + k) : 0.f;
    }
}

template <bool WIDE, bool STREAM>
__device__ __forceinline__ void store_cols(float* o, int n, const float (&v)[16]) {
    if (WIDE && n >= 16) {
        if (STREAM) store_stream<16>(o, v);
        else store_row<16>(o, v);
    } else {
#pragma unroll
        for (int k = 0; k < 16; ++k) {
            if (k >= n) continue;
            if (STREAM) __stcs(o + k, v[k]);
            else o[k] = v[k];
        }
    }
}

// The int8 source's epilogue at columns col .. col + 16 of row r (a chunk
// may pass d: the code rows are padded to 16): y = post * sum, then y to
// `out`, or acc + y (acc optional) streamed to `total`. With REQUANT, xs
// takes y * pre (0 past d) and m the largest |xs| so far; `keep` writes
// xs to the scratch row, for a row that takes several passes.
template <bool WIDE, bool REQUANT>
__device__ __forceinline__ void finish_i8(const Sum& a, const Codes& c, int r, int col,
                                          const float (&sum)[16], float post, float pre,
                                          float& m, float (&xs)[16], bool keep) {
    const size_t off = static_cast<size_t>(r) * a.d + col;
    const int n = a.d - col;  // the chunk's columns below d
    float y[16];
#pragma unroll
    for (int k = 0; k < 16; ++k) y[k] = __fmul_rn(sum[k], post);
    if (a.total == nullptr) {
        store_cols<WIDE, false>(a.out + off, n, y);
    } else {
        float t[16];
        if (a.acc != nullptr) {
            load_cols<WIDE>(a.acc + off, n, t);
#pragma unroll
            for (int k = 0; k < 16; ++k) t[k] = __fadd_rn(t[k], y[k]);
        } else {
#pragma unroll
            for (int k = 0; k < 16; ++k) t[k] = y[k];
        }
        store_cols<WIDE, true>(a.total + off, n, t);
    }
    if constexpr (REQUANT) {
#pragma unroll
        for (int k = 0; k < 16; ++k) {
            xs[k] = k < n ? (c.pre != nullptr ? __fmul_rn(y[k], pre) : y[k]) : 0.f;
            m = fmaxf(m, fabsf(xs[k]));
        }
        if (keep) store_row<16>(c.xs + static_cast<size_t>(r) * c.sd + col, xs);
    }
}

// The fused epilogue's codes and scale of row r, as Q1 computes them, from
// the group's largest |xs| (m in each lane): the butterfly of fmaxf, exact
// in any order, then the lane's chunks of codes, from registers (xs) where
// the row took one pass, else from the scratch row this lane wrote
template <int LANES>
__device__ __forceinline__ void requant_row(const Codes& c, int r, int l, unsigned gmask,
                                            bool one_pass, float m, const float (&xs)[16]) {
#pragma unroll
    for (int o = LANES / 2; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(gmask, m, o));
    const float s = __fmul_rn(fmaxf(m, 1e-12f), kInv127);
    if (l == 0) c.qscale[r] = s;
    for (int cv = l; cv < c.qsd / 16; cv += LANES) {
        float v[16];
        if (one_pass) {
#pragma unroll
            for (int k = 0; k < 16; ++k) v[k] = xs[k];
        } else {
            load_partial<16>(c.xs + static_cast<size_t>(r) * c.sd + cv * 16, v);
        }
        unsigned w[4];
#pragma unroll
        for (int q = 0; q < 4; ++q)
            w[q] = pack4(code_byte(v[4 * q], s), code_byte(v[4 * q + 1], s),
                         code_byte(v[4 * q + 2], s), code_byte(v[4 * q + 3], s));
        *reinterpret_cast<int4*>(c.qcodes + static_cast<size_t>(r) * c.qsd + cv * 16) =
            make_int4(static_cast<int>(w[0]), static_cast<int>(w[1]), static_cast<int>(w[2]),
                      static_cast<int>(w[3]));
    }
}

// A tile: the work items that one block sums between two barriers, two per
// group of lanes, with its slot indices (and values) and its rows' scales
// staged in shared memory
template <int LANES, bool HAS_VAL>
struct Tile {
    static constexpr int GROUPS = WARPS * 32 / LANES;
    static constexpr int ITEMS = 2 * GROUPS;
    static constexpr int SLOTS = ITEMS * CHUNK;  // an item holds at most CHUNK slots
    int4 work[ITEMS];
    long long start[ITEMS + 1];
    float post[ITEMS];  // the rows of a tile are consecutive, at most one an item
    float final_[ITEMS];
    int idx[SLOTS];
    float val[HAS_VAL ? SLOTS : 1];
};

// Stage a tile into shared memory: its descriptors, its rows' scales and
// its slots, one 4-byte copy a slot
template <int LANES, bool HAS_VAL>
__device__ __forceinline__ void stage_tile(const Sum& a, int t, const TileRange& rg,
                                           Tile<LANES, HAS_VAL>& buf) {
    using T = Tile<LANES, HAS_VAL>;
    const int first = t * T::ITEMS, count = min(T::ITEMS, a.n_work - first);
    const int rows = rg.r1 - rg.r0 + 1;
    for (int e = threadIdx.x; e <= count; e += WARPS * 32) {
        if (e < count) cp_async16(&buf.work[e], a.work + first + e, 16);
        cp_async8(&buf.start[e], a.work_start + first + e, 8);
        if (e < rows && a.post != nullptr) cp_async4(&buf.post[e], a.post + rg.r0 + e, 4);
        if (e < rows && a.final_ != nullptr) cp_async4(&buf.final_[e], a.final_ + rg.r0 + e, 4);
    }
    const int n = static_cast<int>(rg.hi - rg.lo);
    for (int e = threadIdx.x; e < n; e += WARPS * 32) {
        cp_async4(&buf.idx[e], a.idx + rg.lo + e, 4);
        if constexpr (HAS_VAL) cp_async4(&buf.val[e], a.val + rg.lo + e, 4);
    }
}

// LANES lanes per item (16 or 32). Persistent blocks walk the tiles with
// the grid's stride (pull_tiles.cuh::walk_tiles); the next STAGES - 1
// tiles' copies are in flight while one sums.
template <typename T, int VEC, int LANES, bool HAS_VAL, bool HAS_ADD>
__global__ void __launch_bounds__(WARPS * 32)
gather_sum_kernel(const Sum a) {
    using TileT = Tile<LANES, HAS_VAL>;
    extern __shared__ __align__(16) unsigned char tile_smem[];
    TileT* bufs = reinterpret_cast<TileT*>(tile_smem);  // STAGES of them
    const int lane = threadIdx.x & 31, l = lane % LANES;
    const int g = threadIdx.x / LANES;  // group of the block
    const unsigned gmask = LANES == 32 ? FULL : ((1u << LANES) - 1) << (lane / LANES * LANES);
    const int nvec = a.d / VEC;
    const T* src = static_cast<const T*>(a.src);
    const int n_tiles = (a.n_work + TileT::ITEMS - 1) / TileT::ITEMS;
    auto range = [&](int t) { return tile_range(a.work, a.work_start, a.n_work, TileT::ITEMS, t); };
    auto stage = [&](int t, const TileRange& rg, int b) { stage_tile(a, t, rg, bufs[b]); };
    auto body = [&](int t, int b) {
        const TileT& buf = bufs[b];
        const int count = min(TileT::ITEMS, a.n_work - t * TileT::ITEMS);
        for (int k = 0; k < 2; ++k) {
            const int i = g + k * TileT::GROUPS;
            const bool valid = i < count;
            const int4 wk = valid ? buf.work[i] : make_int4(0, 0, 0, 1);
            const int r = wk.x, piece = wk.y, part = wk.z, pieces = wk.w;
            const int off = valid ? static_cast<int>(buf.start[i] - buf.start[0]) : 0;
            const int n = valid ? static_cast<int>(buf.start[i + 1] - buf.start[i]) : 0;
            const int row = r - buf.work[0].x;  // the tile's rows are staged from its first
            const float post = valid && a.post != nullptr ? buf.post[row] : 1.f;
            const float fin = valid && a.final_ != nullptr ? buf.final_[row] : 1.f;
            int n_max = n;  // the warp's longest item: its groups walk in step
#pragma unroll
            for (int o = LANES; o < 32; o <<= 1) n_max = max(n_max, __shfl_xor_sync(FULL, n_max, o));

            for (int c0 = 0; c0 < nvec; c0 += LANES) {
                const int cv = c0 + l;
                const bool col_ok = cv < nvec;
                const size_t col = static_cast<size_t>(cv) * VEC;
                float acc[VEC];
#pragma unroll
                for (int q = 0; q < VEC; ++q) acc[q] = 0.f;
                for (int j = 0; j < n_max; j += UNROLL) {
                    float v[UNROLL][VEC];
                    float wt[UNROLL];
                    bool ok[UNROLL];
#pragma unroll
                    for (int u = 0; u < UNROLL; ++u) {
                        const int jj = j + u;
                        const bool in = jj < n;
                        const int s = in ? buf.idx[off + jj] : a.skip;
                        wt[u] = HAS_VAL && in ? buf.val[off + jj] : 1.f;
                        ok[u] = in && s != a.skip && col_ok;
                        if (ok[u]) {
                            const size_t offs = static_cast<size_t>(s) * a.d + col;
                            load_row<VEC>(src + offs, v[u]);
                            if constexpr (HAS_ADD) {
                                float ad[VEC];
                                load_row<VEC>(a.add + offs, ad);
#pragma unroll
                                for (int q = 0; q < VEC; ++q) v[u][q] = __fadd_rn(v[u][q], ad[q]);
                            }
                        }
                    }
#pragma unroll
                    for (int u = 0; u < UNROLL; ++u) {
                        if (!ok[u]) continue;
#pragma unroll
                        for (int q = 0; q < VEC; ++q)
                            acc[q] = __fadd_rn(acc[q], HAS_VAL ? __fmul_rn(wt[u], v[u][q]) : v[u][q]);
                    }
                }
                if (valid && col_ok) {
                    if (pieces == 1)
                        finish<VEC>(a, r, col, acc, post, fin);
                    else
                        store_row<VEC>(a.partial + static_cast<size_t>(part + piece) * a.d + col, acc);
                }
            }

            // a split row: the group that finishes its last piece adds the
            // pieces' partial sums in piece order and runs the epilogue
            if (valid && pieces > 1 && last_piece(a.count, part, pieces, gmask, l, lane / LANES * LANES)) {
                for (int c0 = 0; c0 < nvec; c0 += LANES) {
                    const int cv = c0 + l;
                    if (cv >= nvec) break;
                    const size_t col = static_cast<size_t>(cv) * VEC;
                    float acc[VEC], p[VEC];
                    load_partial<VEC>(a.partial + static_cast<size_t>(part) * a.d + col, acc);
                    for (int c = 1; c < pieces; ++c) {
                        load_partial<VEC>(a.partial + static_cast<size_t>(part + c) * a.d + col, p);
#pragma unroll
                        for (int q = 0; q < VEC; ++q) acc[q] = __fadd_rn(acc[q], p[q]);
                    }
                    finish<VEC>(a, r, col, acc, post, fin);
                }
            }
            __syncwarp();  // the groups meet again before the next item's shuffle
        }
    };
    walk_tiles<STAGES>(n_tiles, range, stage, body);
}

// P1 with an int8 source: the float kernel's tiles, items and split rows,
// each lane summing 16 columns of (float(q) * scale[s]) * val[s] a slot
// from one 16-byte load of codes and the slot's scale (module comment),
// then the epilogue (finish_i8; with REQUANT, the next layer's codes). A
// row of at most LANES chunks takes one pass: its sums stay in registers
// to the epilogue, which runs after the row's last piece. The float
// kernel's Sum is kept as it was; the codes' fields come beside it
template <int LANES, bool HAS_VAL, bool WIDE, bool REQUANT>
__global__ void __launch_bounds__(WARPS * 32, I8_MIN_BLOCKS)
gather_sum_i8_kernel(const Sum a, const Codes c) {
    using TileT = Tile<LANES, HAS_VAL>;
    extern __shared__ __align__(16) unsigned char tile_smem[];
    TileT* bufs = reinterpret_cast<TileT*>(tile_smem);  // STAGES of them
    const int lane = threadIdx.x & 31, l = lane % LANES;
    const int g = threadIdx.x / LANES;  // group of the block
    const unsigned gmask = LANES == 32 ? FULL : ((1u << LANES) - 1) << (lane / LANES * LANES);
    const int nvec = c.sd / 16;  // 16-code chunks of a padded row
    const bool one_pass = nvec <= LANES;
    const int8_t* src = static_cast<const int8_t*>(a.src);
    const int n_tiles = (a.n_work + TileT::ITEMS - 1) / TileT::ITEMS;
    auto range = [&](int t) { return tile_range(a.work, a.work_start, a.n_work, TileT::ITEMS, t); };
    auto stage = [&](int t, const TileRange& rg, int b) { stage_tile(a, t, rg, bufs[b]); };
    auto body = [&](int t, int b) {
        const TileT& buf = bufs[b];
        const int count = min(TileT::ITEMS, a.n_work - t * TileT::ITEMS);
        for (int k = 0; k < 2; ++k) {
            const int i = g + k * TileT::GROUPS;
            const bool valid = i < count;
            const int4 wk = valid ? buf.work[i] : make_int4(0, 0, 0, 1);
            const int r = wk.x, piece = wk.y, part = wk.z, pieces = wk.w;
            const int off = valid ? static_cast<int>(buf.start[i] - buf.start[0]) : 0;
            const int n = valid ? static_cast<int>(buf.start[i + 1] - buf.start[i]) : 0;
            const int row = r - buf.work[0].x;  // the tile's rows are staged from its first
            const float post = valid && a.post != nullptr ? buf.post[row] : 1.f;
            const float pre = REQUANT && valid && c.pre != nullptr ? __ldg(c.pre + r) : 1.f;
            int n_max = n;  // the warp's longest item: its groups walk in step
#pragma unroll
            for (int o = LANES; o < 32; o <<= 1) n_max = max(n_max, __shfl_xor_sync(FULL, n_max, o));

            float acc[16];  // the pass's sums; a one-pass row's stay here to the epilogue
            float m = 0.f, xs[16];  // REQUANT: the row's largest |y * pre|, a one-pass chunk of it
            for (int c0 = 0; c0 < nvec; c0 += LANES) {
                const int cv = c0 + l;
                const bool col_ok = cv < nvec;
                const int col = cv * 16;
#pragma unroll
                for (int q = 0; q < 16; ++q) acc[q] = 0.f;
                for (int j = 0; j < n_max; j += I8_UNROLL) {
                    int4 raw[I8_UNROLL];
                    float sc[I8_UNROLL], wt[I8_UNROLL];
                    bool ok[I8_UNROLL];
#pragma unroll
                    for (int u = 0; u < I8_UNROLL; ++u) {
                        const int jj = j + u;
                        const bool in = jj < n;
                        const int s = in ? buf.idx[off + jj] : a.skip;
                        wt[u] = HAS_VAL && in ? buf.val[off + jj] : 1.f;
                        ok[u] = in && s != a.skip && col_ok;
                        if (ok[u]) {
                            raw[u] = __ldg(reinterpret_cast<const int4*>(
                                src + static_cast<size_t>(s) * c.sd + col));
                            sc[u] = __ldg(c.scale + s);
                        }
                    }
#pragma unroll
                    for (int u = 0; u < I8_UNROLL; ++u) {
                        if (!ok[u]) continue;
                        float v[16];
                        dequant16(raw[u], sc[u], v);
#pragma unroll
                        for (int q = 0; q < 16; ++q)
                            acc[q] = __fadd_rn(acc[q], HAS_VAL ? __fmul_rn(wt[u], v[q]) : v[q]);
                    }
                }
                if (valid && col_ok) {
                    if (pieces > 1)
                        store_row<16>(a.partial + static_cast<size_t>(part + piece) * c.sd + col, acc);
                    else if (!one_pass)
                        finish_i8<WIDE, REQUANT>(a, c, r, col, acc, post, pre, m, xs, true);
                }
            }

            // a split row: the group that finishes its last piece adds the
            // pieces' partial sums in piece order and runs the epilogue
            bool done = valid && pieces == 1;
            if (valid && pieces > 1 && last_piece(a.count, part, pieces, gmask, l, lane / LANES * LANES)) {
                done = true;
                for (int c0 = 0; c0 < nvec; c0 += LANES) {
                    const int cv = c0 + l;
                    if (cv >= nvec) break;
                    const int col = cv * 16;
                    float p[16];
                    load_partial<16>(a.partial + static_cast<size_t>(part) * c.sd + col, acc);
                    for (int k2 = 1; k2 < pieces; ++k2) {
                        load_partial<16>(a.partial + static_cast<size_t>(part + k2) * c.sd + col, p);
#pragma unroll
                        for (int q = 0; q < 16; ++q) acc[q] = __fadd_rn(acc[q], p[q]);
                    }
                    if (!one_pass) finish_i8<WIDE, REQUANT>(a, c, r, col, acc, post, pre, m, xs, true);
                }
            }
            if (done && one_pass && l < nvec)
                finish_i8<WIDE, REQUANT>(a, c, r, l * 16, acc, post, pre, m, xs, false);
            if constexpr (REQUANT) {
                if (done) requant_row<LANES>(c, r, l, gmask, one_pass, m, xs);
            }
            __syncwarp();  // the groups meet again before the next item's shuffle
        }
    };
    walk_tiles<STAGES>(n_tiles, range, stage, body);
}

bool aligned16(const void* p) { return p == nullptr || (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

// Blocks of one instantiation that the card holds at once
template <typename Kernel>
int resident_blocks(Kernel kernel, size_t smem) {
    int dev = 0, per_sm = 0, sms = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, WARPS * 32, smem) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
        return 0;
    return per_sm * sms;
}

// One launch of a tile-walking P1 kernel on `args`: persistent blocks, as
// many as the card holds at once (asked once per device, cached in
// `resident`), at most one a tile
template <typename Kernel, typename... Args>
int launch_walk(Kernel kernel, size_t smem, int items, int (&resident)[64], int n_work,
                cudaStream_t stream, const Args&... args) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess || dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
    if (resident[dev] == 0) {
        if (cudaError_t err = cudaFuncSetAttribute(
                kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem)))
            return static_cast<int>(err);
        resident[dev] = resident_blocks(kernel, smem);
    }
    if (resident[dev] <= 0) return static_cast<int>(cudaErrorLaunchOutOfResources);
    const int tiles = (n_work + items - 1) / items;
    kernel<<<tiles < resident[dev] ? tiles : resident[dev], WARPS * 32, smem, stream>>>(args...);
    return static_cast<int>(cudaGetLastError());
}

template <typename T, int VEC, int LANES, bool HAS_VAL, bool HAS_ADD>
int launch_sum(const Sum& a, cudaStream_t stream) {
    static int resident[64] = {};  // per device ordinal, 0 until asked
    return launch_walk(gather_sum_kernel<T, VEC, LANES, HAS_VAL, HAS_ADD>,
                       STAGES * sizeof(Tile<LANES, HAS_VAL>), Tile<LANES, HAS_VAL>::ITEMS,
                       resident, a.n_work, stream, a);
}

template <int LANES, bool HAS_VAL, bool WIDE, bool REQUANT>
int launch_i8(const Sum& a, const Codes& c, cudaStream_t stream) {
    static int resident[64] = {};
    return launch_walk(gather_sum_i8_kernel<LANES, HAS_VAL, WIDE, REQUANT>,
                       STAGES * sizeof(Tile<LANES, HAS_VAL>), Tile<LANES, HAS_VAL>::ITEMS,
                       resident, a.n_work, stream, a, c);
}

// the int8 source: 16 lanes where a padded row is at most 16 chunks of 16
// codes (d <= 256), else a warp
template <bool WIDE, bool REQUANT>
int dispatch_i8(const Sum& a, const Codes& c, cudaStream_t stream) {
    if (c.sd / 16 <= 16)
        return a.val != nullptr ? launch_i8<16, true, WIDE, REQUANT>(a, c, stream)
                                : launch_i8<16, false, WIDE, REQUANT>(a, c, stream);
    return a.val != nullptr ? launch_i8<32, true, WIDE, REQUANT>(a, c, stream)
                            : launch_i8<32, false, WIDE, REQUANT>(a, c, stream);
}

template <typename T, int VEC, int LANES>
int dispatch_flags(const Sum& a, cudaStream_t stream) {
    if constexpr (std::is_same<T, float>::value) {  // a second source is f32-only
        if (a.add != nullptr) {
            return a.val != nullptr ? launch_sum<T, VEC, LANES, true, true>(a, stream)
                                    : launch_sum<T, VEC, LANES, false, true>(a, stream);
        }
    }
    return a.val != nullptr ? launch_sum<T, VEC, LANES, true, false>(a, stream)
                            : launch_sum<T, VEC, LANES, false, false>(a, stream);
}

// lanes per item: 16 where a row is at most 16 loads wide (d = 64 in f32,
// 128 in bf16, and every narrower row), else a warp
template <typename T, int VEC>
int dispatch_sum(const Sum& a, cudaStream_t stream) {
    return a.d / VEC <= 16 ? dispatch_flags<T, VEC, 16>(a, stream)
                           : dispatch_flags<T, VEC, 32>(a, stream);
}

// Q1: one warp a row (module comment). VEC4: the row's floats by 16-byte
// loads (d a multiple of 4, x aligned)

template <bool VEC4>
__device__ __forceinline__ void load4(const float* xr, int c, int d, float (&v)[4]) {
    if (VEC4 && c + 4 <= d) {
        const float4 t = __ldg(reinterpret_cast<const float4*>(xr + c));
        v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
    } else {
#pragma unroll
        for (int k = 0; k < 4; ++k) v[k] = c + k < d ? __ldg(xr + c + k) : 0.f;
    }
}

template <bool VEC4>
__global__ void __launch_bounds__(256)
quantize_rows_kernel(const float* __restrict__ x, const float* __restrict__ pre, long long n,
                     int d, int d_pad, signed char* __restrict__ codes, float* __restrict__ scale) {
    const int lane = threadIdx.x & 31;
    const long long warp = (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
    const long long n_warps = (static_cast<long long>(gridDim.x) * blockDim.x) >> 5;
    for (long long row = warp; row < n; row += n_warps) {
        const float* xr = x + row * d;
        const bool has_pre = pre != nullptr;
        const float p = has_pre ? __ldg(pre + row) : 1.f;
        float m = 0.f;
        for (int c = 4 * lane; c < d; c += 128) {
            float v[4];
            load4<VEC4>(xr, c, d, v);
#pragma unroll
            for (int k = 0; k < 4; ++k) m = fmaxf(m, fabsf(has_pre ? __fmul_rn(v[k], p) : v[k]));
        }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(FULL, m, o));
        const float s = __fmul_rn(fmaxf(m, 1e-12f), kInv127);
        if (lane == 0) scale[row] = s;
        for (int c = 4 * lane; c < d_pad; c += 128) {  // past d: zeros, so codes 0
            float v[4];
            load4<VEC4>(xr, c, d, v);
            unsigned word = 0;
#pragma unroll
            for (int k = 0; k < 4; ++k) {
                const float xs = has_pre ? __fmul_rn(v[k], p) : v[k];
                const float q = fminf(fmaxf(rintf(__fdiv_rn(xs, s)), -127.f), 127.f);
                word |= (static_cast<unsigned>(static_cast<int>(q)) & 0xffu) << (8 * k);
            }
            *reinterpret_cast<unsigned*>(codes + row * d_pad + c) = word;
        }
    }
}

// lanes across a row for K7: the smallest power of two that covers its
// units, at most 32
int lanes_for(int units) {
    int lanes = 1;
    while (lanes < units && lanes < 32) lanes <<= 1;
    return lanes;
}

template <typename U>
__global__ void __launch_bounds__(256)
gather_rows_kernel(const U* __restrict__ x, const int* __restrict__ idx, long long n_idx,
                   int units, int per_row, U* __restrict__ out) {
    const int lane = threadIdx.x & 31;
    const int rows_per_warp = 32 / per_row;
    const int sub = lane / per_row, t = lane % per_row;
    const long long warp = (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
    const long long n_warps = (static_cast<long long>(gridDim.x) * blockDim.x) >> 5;
    for (long long row = warp * rows_per_warp + sub; row < n_idx; row += n_warps * rows_per_warp) {
        const long long from = static_cast<long long>(__ldg(idx + row)) * units;
        const long long to = row * units;
        for (int u = t; u < units; u += per_row) out[to + u] = __ldg(x + from + u);
    }
}

template <typename U>
int launch_rows(const void* x, const int* idx, long long n_idx, long long row_bytes, void* out,
                cudaStream_t stream) {
    const int units = static_cast<int>(row_bytes / sizeof(U));
    const int per_row = lanes_for(units);
    const long long rows_per_block = 8LL * (32 / per_row);
    long long blocks = (n_idx + rows_per_block - 1) / rows_per_block;
    if (blocks > (1LL << 20)) blocks = 1LL << 20;  // the rest by the grid-stride loop
    gather_rows_kernel<U><<<static_cast<unsigned>(blocks), 256, 0, stream>>>(
        static_cast<const U*>(x), idx, n_idx, units, per_row, static_cast<U*>(out));
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C interface for ctypes. Each call is one launch on the given stream
// and returns the CUDA error code (0 on success). The wrappers check
// devices, types, shapes and contiguity; sizes are at least 1.

// K7: out[i] = x[idx[i]] for rows of row_bytes bytes (f32 or bf16 rows).
extern "C" int gather_rows(const void* x, const int* idx, long long n_idx, long long row_bytes,
                           void* out, void* stream) {
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    const uintptr_t a = reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(out);
    if (row_bytes % 16 == 0 && (a & 15u) == 0) return launch_rows<uint4>(x, idx, n_idx, row_bytes, out, s);
    if (row_bytes % 8 == 0 && (a & 7u) == 0) return launch_rows<uint2>(x, idx, n_idx, row_bytes, out, s);
    if (row_bytes % 4 == 0 && (a & 3u) == 0) return launch_rows<unsigned>(x, idx, n_idx, row_bytes, out, s);
    return launch_rows<unsigned short>(x, idx, n_idx, row_bytes, out, s);
}

// P1: a memset of the row counters, then one launch. work is i32
// [n_work, 4] and work_start i64 [n_work + 1] (ops/gather.py::pull_schedule);
// partial is f32 [n_partials, d] scratch and count i32 [n_partials], both
// null when no row is split (n_partials 0); add (f32 source only), val,
// post, acc, final, out and total may be null (out or total is not). bf16:
// src holds bf16 bits, else f32.
extern "C" int gather_sum(const void* src, int bf16, const float* add, const int* idx,
                          const int* work, const long long* work_start, int n_work,
                          const float* val, const float* post, const float* acc,
                          const float* final_, int d, int skip, float* partial, int* count,
                          int n_partials, float* out, float* total, void* stream) {
    const Sum a{src, add, idx, reinterpret_cast<const int4*>(work), work_start, n_work, val, post,
                acc, final_, d, skip, partial, count, out, total};
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (n_partials > 0) {
        if (cudaError_t err = cudaMemsetAsync(count, 0, sizeof(int) * n_partials, s))
            return static_cast<int>(err);
    }
    const bool rows16 = aligned16(src) && aligned16(add) && aligned16(acc) && aligned16(partial) &&
                        aligned16(out) && aligned16(total);
    if (bf16) {
        return d % 8 == 0 && rows16 ? dispatch_sum<uint16_t, 8>(a, s) : dispatch_sum<uint16_t, 1>(a, s);
    }
    return d % 4 == 0 && rows16 ? dispatch_sum<float, 4>(a, s) : dispatch_sum<float, 1>(a, s);
}

// P1 with an int8 source, and the int8 chain's fused layer: a memset of the
// row counters, then one launch. codes int8 in rows of sd bytes (a multiple
// of 16, 16-byte aligned) with their row scales `scale`; partial f32
// [n_partials, sd]; y goes to out, or acc + y (acc may be null) to total
// (exactly one of them). qcodes (null: none) and qscale receive the codes
// of y * pre (pre may be null) in rows of d rounded up to 16 bytes
// (16-byte aligned), with total; xs is f32 [n_out, sd] scratch, needed
// where a row is more than 32 chunks of 16 codes.
extern "C" int gather_sum_i8(const void* codes, const float* scale, int sd, const int* idx,
                             const int* work, const long long* work_start, int n_work,
                             const float* val, const float* post, const float* acc, int d,
                             int skip, float* partial, int* count, int n_partials, float* out,
                             float* total, signed char* qcodes, float* qscale, const float* pre,
                             float* xs, void* stream) {
    const Sum a{codes, nullptr, idx, reinterpret_cast<const int4*>(work), work_start, n_work, val,
                post, acc, nullptr, d, skip, partial, count, out, total};
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (!aligned16(codes) || !aligned16(partial) || sd % 16 != 0 || sd < d ||
        (out == nullptr) == (total == nullptr) || (acc != nullptr && total == nullptr))
        return static_cast<int>(cudaErrorInvalidValue);
    if (qcodes != nullptr && (total == nullptr || qscale == nullptr || !aligned16(qcodes) ||
                              (sd / 16 > 32 && (xs == nullptr || !aligned16(xs)))))
        return static_cast<int>(cudaErrorInvalidValue);
    if (n_partials > 0) {
        if (cudaError_t err = cudaMemsetAsync(count, 0, sizeof(int) * n_partials, s))
            return static_cast<int>(err);
    }
    const Codes c{scale, sd, qcodes, qscale, pre, xs, (d + 15) / 16 * 16};
    const bool wide = d % 4 == 0 && aligned16(out) && aligned16(total) && aligned16(acc);
    if (qcodes != nullptr)
        return wide ? dispatch_i8<true, true>(a, c, s) : dispatch_i8<false, true>(a, c, s);
    return wide ? dispatch_i8<true, false>(a, c, s) : dispatch_i8<false, false>(a, c, s);
}

// Q1: codes int8 [n, d_pad] (d_pad a multiple of 16, the columns past d
// written 0) and scale f32 [n] of x f32 [n, d], each row scaled by pre
// (f32 [n], may be null) first. One launch.
extern "C" int quantize_rows(const float* x, const float* pre, long long n, int d, int d_pad,
                             signed char* codes, float* scale, void* stream) {
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (d_pad % 16 != 0 || d_pad < d || !aligned16(codes)) return static_cast<int>(cudaErrorInvalidValue);
    long long blocks = (n + 7) / 8;  // 8 warps a block, a warp a row
    if (blocks > (1LL << 16)) blocks = 1LL << 16;  // the rest by the grid-stride loop
    if (d % 4 == 0 && aligned16(x))
        quantize_rows_kernel<true><<<static_cast<unsigned>(blocks), 256, 0, s>>>(x, pre, n, d, d_pad, codes, scale);
    else
        quantize_rows_kernel<false><<<static_cast<unsigned>(blocks), 256, 0, s>>>(x, pre, n, d, d_pad, codes, scale);
    return static_cast<int>(cudaGetLastError());
}

extern "C" const char* gather_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}
