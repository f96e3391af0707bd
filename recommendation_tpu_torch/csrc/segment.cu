// Segment kernels of the neighbour models (GAT's attention, on the segment
// and the bucketed path), on Hopper (sm_90a).
//
// None replaces a TPU kernel: the JAX package leaves these sums to XLA's
// segment_sum / segment_max (recommendation_tpu/models/gat.py:35-60 on the
// segment path, :63-235 on the bucketed one, recommendation_tpu/ops/
// spmm.py:78-99). The port writes them so that every sum has a fixed order
// (no float atomics: each call repeats bit for bit) and so that the [E, d]
// gathered messages are never built in memory. Each works on a CSR segment
// table: row r owns the slots [row_ptr[r], row_ptr[r+1]), which is a
// destination's in-edges sorted by a stable sort (ops/segment.py) or a
// bucket row of graph/bucketed.py's flat tables.
//
// S1, the multi-head weighted pull (ops/segment.py::weighted_pull):
//
//     y[r, h, :] = sum_{s in row r} w[s, h] * x[idx[s], h, :]      f32
//
// x [N, H, D] and y [R, H, D] are rows of width H*D; w [S, H]. What bounds
// it: bytes, the distinct source rows gathered, the slots' indices and
// weights and y written; but every slot gathers its row (1 KB at GAT's
// first layer, H*D = 256), so at the clustered graph's 2.4M slots the
// gathers move 2.5 GB through L2 from a 150 MB table that L2 holds a third
// of. On the H100 the same call with every index taken modulo 4096 (every
// gather an L2 hit) still takes 0.31 ms against 0.47 (tools/
// probe_segment_pull.py): moving the gathered rows through L2 is the
// floor, not the index waits. The design is P1's pipeline
// (csrc/pull_tiles.cuh, csrc/gather.cu):
//   * P1's work list (ops/gather.py::pull_schedule): one item per row and
//     one per CHUNK-slot piece of a longer row, so the hub rows of a
//     power-law graph do not hold the launch up.
//   * Tiles of one item a group, their descriptors, slot indices and (up
//     to 16 KB a tile) per-head weights copied into shared memory by
//     cp.async, STAGES deep, by persistent blocks walking the tiles with
//     the grid's stride: a gather never waits on its index.
//   * A group of lanes per item, one pass over its slots for the whole
//     row: 16 lanes with one 16-byte load each where the row is at most 64
//     f32 (GAT's second layer), else a warp with NV = 1, 2 or 4 of them
//     (two at H*D = 256); lane l holds the units l, l + LANES, .. of the
//     row, so each load instruction of a group reads consecutive bytes.
//     Rows wider than 512 f32 take more passes.
//   * Occupancy over depth: 16 gathered f32 in flight a lane (UNROLL 2
//     rows at H*D = 256, 4 at 64) and registers capped for 3 blocks an SM.
//     On the H100 (tools/probe_segment_pull.py, the clustered rows, H = 4)
//     32 and 64 f32 a lane without the cap took 0.78 and 0.68 ms against
//     0.47: registers cost resident warps. Two items a group a tile took
//     0.50, and 0.034 ms against 0.021 on the hard set's view at H = 1,
//     which has fewer tiles than the card has SMs.
//   * A split row's pieces write partial sums that the group finishing the
//     row's last piece adds in piece order (an integer counter per row,
//     zeroed on the stream ahead of the launch, is the only atomic).
//
// S1 with the head dot (ops/segment.py::weighted_pull_dot), the same pull
// over GAT's transpose view in the attention's backward, with S3 folded in:
//
//     dh[r, h, :] = sum_{t in row r} w[fpos[t], h] * g[idx[t], h, :]   (fpos[t] >= 0)
//     dot[fpos[t], h] = sum_k g[idx[t], h, k] * hsrc[node(r), h, k]    (fpos[t] >= 0)
//
// fpos is each transpose slot's forward slot, -1 where the slot is dead
// (its weight is then 0 and it writes no dot); every other entry of dot is
// 0 (zeroed on the stream ahead of the launch). The live slots of the two
// views map one to one, so each forward slot is written at most once. The
// slots of row r are the edges out of one source node(r) (node null: the
// row is the node), so its hsrc row is loaded into registers once an item,
// and each gathered g row is dotted with it as it arrives: the dot moves
// the hsrc rows once and the [S, H] result, no row a slot. Where a head
// holds a whole number of a lane's units, the lane's units are consecutive
// (one head a lane: 8 lanes a head at H*D = 256, d = 64) and the dot is
// the lane's products in order, then a fixed xor tree over the head's
// lanes; else the units stay strided, with a tree a unit (or, where a
// head's lanes are not a power of two, a shared-memory sum in order). One
// lane a head writes. A split row merges dh only: a slot's dot is written
// by the piece that holds it.
//
// S2, the segment softmax, forward and backward
// (ops/segment.py::segment_softmax_rows, segment_softmax_rows_bwd):
//
//     m = max over live slots of e[s, h] (0 where no slot is live)
//     att[s, h] = live[s] ? exp(e[s, h] - m) / (sum_live exp(e - m) + 1e-16) : 0
//     de[s, h] = att[s, h] * (g[s, h] - sum_{s' in row} att[s', h] g[s', h])
//
// A warp per row: its lanes take consecutive elements of the row's [slots,
// H] block, so with H dividing 32 a lane always holds one head, and the
// per-head max and sums are xor-shuffle trees over the lanes of that head:
// a fixed order. Bound: bytes, the [S, H] inputs read once (three passes
// over a row; the later ones hit L1/L2) and the output written once.
//
// Every product and sum is rounded once (no FMA contraction), as the plain
// versions' separate operations are.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "pull_tiles.cuh"

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int THREADS = 256;
constexpr int STAGES = 3;   // tiles in shared memory: the one summed, two in flight
constexpr int CHUNK = 128;  // slots per work item of a split row (ops/gather.py::CHUNK)
constexpr int W_STAGED = 4096;  // at most this many weights a tile are staged (16 KB)
// S1's occupancy against depth (measured on the H100: see the note above)
constexpr int FLOATS_IN_FLIGHT = 16;  // gathered f32 in flight per lane
constexpr int MIN_BLOCKS = 3;         // blocks an SM holds: registers capped at 85

// rows in flight per group: FLOATS_IN_FLIGHT f32 a lane, 2 to 16 rows
__host__ __device__ constexpr int unroll_for(int floats) {
    return FLOATS_IN_FLIGHT / floats < 2 ? 2
           : FLOATS_IN_FLIGHT / floats > 16 ? 16 : FLOATS_IN_FLIGHT / floats;
}

// A block's groups and its tile: LANES lanes a group, one item a group a
// tile
template <int LANES>
struct Geo {
    static constexpr int GROUPS = THREADS / LANES;
    static constexpr int ITEMS = GROUPS;
    static constexpr int SLOTS = ITEMS * CHUNK;  // an item holds at most CHUNK slots
};

// Byte offsets within one stage buffer: the items' descriptors (int4), the
// staged weights [slots, heads] (16-byte aligned), the items' first slots
// (i64), the slot indices, and for the fused variant the rows' nodes and
// the slots' forward positions
struct Layout {
    int w, start, idx, node, fpos, bytes;
};

__host__ __device__ inline Layout stage_layout(int items, int slots, int heads, bool fused,
                                               bool stage_w) {
    Layout s;
    int o = items * 16;
    s.w = o;
    o += stage_w ? slots * heads * 4 : 0;
    s.start = o;
    o += (items + 1) * 8;
    s.idx = o;
    o += slots * 4;
    s.node = o;
    o += fused ? items * 4 : 0;
    s.fpos = o;
    o += fused ? slots * 4 : 0;
    s.bytes = (o + 15) / 16 * 16;
    return s;
}

struct Pull {  // one call's operands (partial and count null when no row is split)
    const float* x;               // gathered rows [N, heads * d_head] (the fused variant's g)
    const float* w;               // [S, heads] (the fused variant's: forward slots)
    const int* idx;               // [S]
    const int4* work;             // [n_work] (row, piece, the row's first partial, the row's pieces)
    const long long* work_start;  // [n_work + 1] each item's first slot
    int n_work;
    int heads;
    int d_head;
    int pass_units;  // units (U f32) of a column pass
    float* partial;
    int* count;
    float* out;
    const int* fpos;    // fused: [S] forward slot, -1 dead
    const float* hsrc;  // fused: [*, heads * d_head]
    const int* node;    // fused: [rows] each row's node, or null (the row itself)
    float* dot;         // fused: [forward slots, heads], zeroed
};

__host__ __device__ inline bool aligned16(const void* p) {
    return p == nullptr || (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

// U f32 a unit (4: 16-byte loads; 1), LANES lanes a group, NV units a lane
// a pass. FUSED: the transpose pull with the head dot; STAGE_W: the
// weights come through shared memory.
template <int U, int LANES, int NV, bool FUSED, bool STAGE_W>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
weighted_pull_kernel(const Pull a) {
    using G = Geo<LANES>;
    constexpr int UNROLL = unroll_for(NV * U);
    extern __shared__ __align__(16) unsigned char tile_smem[];
    __shared__ float red[FUSED ? THREADS * NV : 1];  // the dot's sums where the xor tree does not fit
    const Layout lay = stage_layout(G::ITEMS, G::SLOTS, a.heads, FUSED, STAGE_W);
    const int lane = threadIdx.x & 31, l = lane % LANES;
    const int g = threadIdx.x / LANES;  // group of the block
    const unsigned gmask = LANES == 32 ? FULL : ((1u << LANES) - 1) << (lane / LANES * LANES);
    const int heads = a.heads, width = heads * a.d_head, units = width / U;
    const int uph = a.d_head / U;  // units a head
    // the fused variant's lanes of a head: a lane's NV units consecutive
    // and in one head where they fit (one xor tree a slot), else strided
    const bool contig = FUSED && NV > 1 && uph % NV == 0 &&
                        ((uph / NV) & (uph / NV - 1)) == 0 && uph / NV <= LANES;
    const int lph = contig ? uph / NV : uph;  // lanes a head
    const bool xor_dot = contig || ((uph & (uph - 1)) == 0 && uph <= LANES);
    const bool w16 = STAGE_W && heads % 4 == 0 && aligned16(a.w);
    const int n_tiles = (a.n_work + G::ITEMS - 1) / G::ITEMS;

    auto range = [&](int t) { return tile_range(a.work, a.work_start, a.n_work, G::ITEMS, t); };
    auto stage = [&](int t, const TileRange& rg, int b) {
        unsigned char* s = tile_smem + static_cast<size_t>(b) * lay.bytes;
        int4* work = reinterpret_cast<int4*>(s);
        long long* start = reinterpret_cast<long long*>(s + lay.start);
        const int first = t * G::ITEMS, count = min(G::ITEMS, a.n_work - first);
        const int rows = rg.r1 - rg.r0 + 1;
        for (int e = threadIdx.x; e <= count; e += THREADS) {
            if (e < count) cp_async16(work + e, a.work + first + e, 16);
            cp_async8(start + e, a.work_start + first + e, 8);
            if (FUSED && a.node != nullptr && e < rows)
                cp_async4(reinterpret_cast<int*>(s + lay.node) + e, a.node + rg.r0 + e, 4);
        }
        const int n = static_cast<int>(rg.hi - rg.lo);
        int* idx = reinterpret_cast<int*>(s + lay.idx);
        for (int e = threadIdx.x; e < n; e += THREADS) {
            cp_async4(idx + e, a.idx + rg.lo + e, 4);
            if constexpr (FUSED)
                cp_async4(reinterpret_cast<int*>(s + lay.fpos) + e, a.fpos + rg.lo + e, 4);
        }
        if constexpr (STAGE_W) {
            float* w = reinterpret_cast<float*>(s + lay.w);
            const float* from = a.w + rg.lo * heads;
            if (w16) {
                for (int e = threadIdx.x; e < n * heads / 4; e += THREADS)
                    cp_async16(w + 4 * e, from + 4 * e, 16);
            } else {
                for (int e = threadIdx.x; e < n * heads; e += THREADS) cp_async4(w + e, from + e, 4);
            }
        }
    };
    auto body = [&](int t, int b) {
        const unsigned char* s = tile_smem + static_cast<size_t>(b) * lay.bytes;
        const int4* work = reinterpret_cast<const int4*>(s);
        const long long* start = reinterpret_cast<const long long*>(s + lay.start);
        const int* idx = reinterpret_cast<const int*>(s + lay.idx);
        const int* fpos = reinterpret_cast<const int*>(s + lay.fpos);
        const float* w_s = reinterpret_cast<const float*>(s + lay.w);
        const int count = min(G::ITEMS, a.n_work - t * G::ITEMS);
        for (int k = 0; k < G::ITEMS / G::GROUPS; ++k) {
            const int i = g + k * G::GROUPS;
            const bool valid = i < count;
            const int4 wk = valid ? work[i] : make_int4(0, 0, 0, 1);
            const int r = wk.x, piece = wk.y, part = wk.z, pieces = wk.w;
            const long long s_first = valid ? start[i] : 0;
            const int off = static_cast<int>(s_first - start[0]);
            const int n = valid ? static_cast<int>(start[i + 1] - s_first) : 0;
            int n_max = n;  // the warp's longest item: its groups walk in step
#pragma unroll
            for (int o = LANES; o < 32; o <<= 1) n_max = max(n_max, __shfl_xor_sync(FULL, n_max, o));
            int nd = 0;
            if constexpr (FUSED) {
                if (valid)  // the tile's rows are staged from its first
                    nd = a.node == nullptr ? r
                                           : reinterpret_cast<const int*>(s + lay.node)[r - work[0].x];
            }
            float* dst = pieces == 1 ? a.out + static_cast<size_t>(r) * width
                                     : a.partial + static_cast<size_t>(part + piece) * width;

            for (int ub = 0; ub < units; ub += a.pass_units) {  // one pass up to 512 f32
                const int ue = min(units, ub + a.pass_units);
                int col[NV], hh[NV];
                bool ok[NV];
#pragma unroll
                for (int j = 0; j < NV; ++j) {
                    const int v = contig ? ub + l * NV + j : ub + l + LANES * j;
                    ok[j] = v < ue;
                    col[j] = v * U;
                    hh[j] = ok[j] ? col[j] / a.d_head : 0;
                }
                float hs[NV][U];
                if constexpr (FUSED) {
#pragma unroll
                    for (int j = 0; j < NV; ++j) {
                        if (valid && ok[j]) {
                            load_row<U>(a.hsrc + static_cast<size_t>(nd) * width + col[j], hs[j]);
                        } else {
#pragma unroll
                            for (int q = 0; q < U; ++q) hs[j][q] = 0.f;
                        }
                    }
                }
                float acc[NV][U];
#pragma unroll
                for (int j = 0; j < NV; ++j)
#pragma unroll
                    for (int q = 0; q < U; ++q) acc[j][q] = 0.f;
                for (int jj = 0; jj < n_max; jj += UNROLL) {
                    float v[UNROLL][NV][U];
                    float wt[UNROLL][NV];
                    bool in[UNROLL];
                    int fp[UNROLL];
#pragma unroll
                    for (int u = 0; u < UNROLL; ++u) {
                        const int e = jj + u;
                        in[u] = e < n;
                        const int src = in[u] ? idx[off + e] : 0;
                        fp[u] = FUSED && in[u] ? fpos[off + e] : -1;
#pragma unroll
                        for (int j = 0; j < NV; ++j) {
                            wt[u][j] = 0.f;
                            if (!(in[u] && ok[j])) continue;
                            if constexpr (FUSED) {
                                if (fp[u] >= 0) wt[u][j] = __ldg(a.w + static_cast<size_t>(fp[u]) * heads + hh[j]);
                            } else if constexpr (STAGE_W) {
                                wt[u][j] = w_s[(off + e) * heads + hh[j]];
                            } else {
                                wt[u][j] = __ldg(a.w + static_cast<size_t>(s_first + e) * heads + hh[j]);
                            }
                            load_row<U>(a.x + static_cast<size_t>(src) * width + col[j], v[u][j]);
                        }
                    }
#pragma unroll
                    for (int u = 0; u < UNROLL; ++u) {
#pragma unroll
                        for (int j = 0; j < NV; ++j) {
                            if (!(in[u] && ok[j])) continue;
#pragma unroll
                            for (int q = 0; q < U; ++q)
                                acc[j][q] = __fadd_rn(acc[j][q], __fmul_rn(wt[u][j], v[u][j][q]));
                        }
                    }
                    if constexpr (FUSED) {
                        // each slot's dot with the row's hsrc, per head: the
                        // lane's products in order, then the xor tree, the
                        // round's slots side by side
                        float pd[UNROLL][NV];
#pragma unroll
                        for (int u = 0; u < UNROLL; ++u) {
#pragma unroll
                            for (int j = 0; j < NV; ++j) {
                                pd[u][j] = 0.f;
                                if (in[u] && ok[j]) {
#pragma unroll
                                    for (int q = 0; q < U; ++q)
                                        pd[u][j] = __fadd_rn(pd[u][j], __fmul_rn(v[u][j][q], hs[j][q]));
                                }
                            }
                        }
                        if (contig) {  // one head a lane: its units' dots added in order
#pragma unroll
                            for (int u = 0; u < UNROLL; ++u)
#pragma unroll
                                for (int j = 1; j < NV; ++j) pd[u][0] = __fadd_rn(pd[u][0], pd[u][j]);
                            for (int o = lph >> 1; o > 0; o >>= 1) {
#pragma unroll
                                for (int u = 0; u < UNROLL; ++u)
                                    pd[u][0] = __fadd_rn(pd[u][0], __shfl_xor_sync(FULL, pd[u][0], o));
                            }
                            if (l % lph == 0) {
#pragma unroll
                                for (int u = 0; u < UNROLL; ++u)
                                    if (fp[u] >= 0 && ok[0])
                                        a.dot[static_cast<size_t>(fp[u]) * heads + hh[0]] = pd[u][0];
                            }
                        } else if (xor_dot) {
                            for (int o = uph >> 1; o > 0; o >>= 1) {
#pragma unroll
                                for (int u = 0; u < UNROLL; ++u)
#pragma unroll
                                    for (int j = 0; j < NV; ++j)
                                        pd[u][j] = __fadd_rn(pd[u][j], __shfl_xor_sync(FULL, pd[u][j], o));
                            }
                            if (l % uph == 0) {
#pragma unroll
                                for (int u = 0; u < UNROLL; ++u)
#pragma unroll
                                    for (int j = 0; j < NV; ++j)
                                        if (fp[u] >= 0 && ok[j])
                                            a.dot[static_cast<size_t>(fp[u]) * heads + hh[j]] = pd[u][j];
                            }
                        } else {
                            float* rg = red + g * LANES * NV;
#pragma unroll
                            for (int u = 0; u < UNROLL; ++u) {
#pragma unroll
                                for (int j = 0; j < NV; ++j) rg[l + LANES * j] = pd[u][j];
                                __syncwarp();
                                if (fp[u] >= 0) {
                                    for (int hl = l; hl < (ue - ub) / uph; hl += LANES) {
                                        float sum = 0.f;
                                        for (int q = 0; q < uph; ++q) sum = __fadd_rn(sum, rg[hl * uph + q]);
                                        a.dot[static_cast<size_t>(fp[u]) * heads + ub / uph + hl] = sum;
                                    }
                                }
                                __syncwarp();
                            }
                        }
                    }
                }
                if (valid) {
#pragma unroll
                    for (int j = 0; j < NV; ++j)
                        if (ok[j]) store_row<U>(dst + col[j], acc[j]);
                }
            }

            // a split row: the group that finishes its last piece adds the
            // pieces' partial sums in piece order
            if (valid && pieces > 1 && last_piece(a.count, part, pieces, gmask, l, lane / LANES * LANES)) {
                for (int c = l; c < units; c += LANES) {
                    const size_t cc = static_cast<size_t>(c) * U;
                    float sum[U], p[U];
                    load_partial<U>(a.partial + static_cast<size_t>(part) * width + cc, sum);
                    for (int q = 1; q < pieces; ++q) {
                        load_partial<U>(a.partial + static_cast<size_t>(part + q) * width + cc, p);
#pragma unroll
                        for (int z = 0; z < U; ++z) sum[z] = __fadd_rn(sum[z], p[z]);
                    }
                    store_row<U>(a.out + static_cast<size_t>(r) * width + cc, sum);
                }
            }
            __syncwarp();  // the groups meet again before the next item's shuffle
        }
    };
    walk_tiles<STAGES>(n_tiles, range, stage, body);
}

__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }

// reduce over the lanes that hold the same head (lane % heads): xor
// offsets 16, 8, .., heads
__device__ __forceinline__ float head_max(float v, int heads) {
    for (int o = 16; o >= heads; o >>= 1) v = fmaxf(v, __shfl_xor_sync(FULL, v, o));
    return v;
}

__device__ __forceinline__ float head_sum(float v, int heads) {
    for (int o = 16; o >= heads; o >>= 1) v = __fadd_rn(v, __shfl_xor_sync(FULL, v, o));
    return v;
}

__global__ void __launch_bounds__(THREADS)
softmax_fwd_kernel(const float* __restrict__ e, const unsigned char* __restrict__ live,
                   const long long* __restrict__ row_ptr, long long n_rows, int heads,
                   float* __restrict__ att) {
    const int lane = threadIdx.x & 31;
    const long long n_warps = (static_cast<long long>(gridDim.x) * THREADS) >> 5;
    for (long long r = (static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x) >> 5;
         r < n_rows; r += n_warps) {
        const long long q0 = row_ptr[r] * heads, q1 = row_ptr[r + 1] * heads;
        float m = neg_inf();
        for (long long q = q0 + lane; q < q1; q += 32)
            if (live == nullptr || live[q / heads]) m = fmaxf(m, e[q]);
        m = head_max(m, heads);
        if (!isfinite(m)) m = 0.f;  // no live slot: the row's weights are all 0
        float s = 0.f;
        for (long long q = q0 + lane; q < q1; q += 32)
            if (live == nullptr || live[q / heads]) s = __fadd_rn(s, expf(__fsub_rn(e[q], m)));
        const float denom = __fadd_rn(head_sum(s, heads), 1e-16f);
        for (long long q = q0 + lane; q < q1; q += 32)
            att[q] = live == nullptr || live[q / heads] ? __fdiv_rn(expf(__fsub_rn(e[q], m)), denom)
                                                        : 0.f;
    }
}

__global__ void __launch_bounds__(THREADS)
softmax_bwd_kernel(const float* __restrict__ att, const float* __restrict__ g,
                   const long long* __restrict__ row_ptr, long long n_rows, int heads,
                   float* __restrict__ de) {
    const int lane = threadIdx.x & 31;
    const long long n_warps = (static_cast<long long>(gridDim.x) * THREADS) >> 5;
    for (long long r = (static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x) >> 5;
         r < n_rows; r += n_warps) {
        const long long q0 = row_ptr[r] * heads, q1 = row_ptr[r + 1] * heads;
        float dot = 0.f;
        for (long long q = q0 + lane; q < q1; q += 32) dot = __fadd_rn(dot, __fmul_rn(att[q], g[q]));
        dot = head_sum(dot, heads);
        for (long long q = q0 + lane; q < q1; q += 32)
            de[q] = __fmul_rn(att[q], __fsub_rn(g[q], dot));
    }
}



unsigned blocks_for(long long units, long long per_block) {
    long long blocks = (units + per_block - 1) / per_block;
    if (blocks > (1LL << 20)) blocks = 1LL << 20;  // the rest by the grid-stride loops
    return static_cast<unsigned>(blocks < 1 ? 1 : blocks);
}

// Blocks of one instantiation that the card holds at once
template <typename Kernel>
int resident_blocks(Kernel kernel, size_t smem) {
    int dev = 0, per_sm = 0, sms = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, smem) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
        return 0;
    return per_sm * sms;
}

template <int U, int LANES, int NV, bool FUSED, bool STAGE_W>
int launch_pull(const Pull& a, cudaStream_t stream) {
    using G = Geo<LANES>;
    auto kernel = weighted_pull_kernel<U, LANES, NV, FUSED, STAGE_W>;
    const int smem = STAGES * stage_layout(G::ITEMS, G::SLOTS, a.heads, FUSED, STAGE_W).bytes;
    // per device ordinal: the shared memory the attribute allows, and the
    // resident blocks at the last size asked
    static int allowed[64] = {}, asked[64] = {}, resident[64] = {};
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess || dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
    if (smem > allowed[dev]) {
        if (cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem))
            return static_cast<int>(err);
        allowed[dev] = smem;
    }
    if (asked[dev] != smem || resident[dev] <= 0) {
        resident[dev] = resident_blocks(kernel, smem);
        asked[dev] = smem;
    }
    if (resident[dev] <= 0) return static_cast<int>(cudaErrorLaunchOutOfResources);
    const int tiles = (a.n_work + G::ITEMS - 1) / G::ITEMS;
    kernel<<<tiles < resident[dev] ? tiles : resident[dev], THREADS, smem, stream>>>(a);
    return static_cast<int>(cudaGetLastError());
}

template <int U, int LANES, int NV>
int launch_variant(const Pull& a, bool fused, cudaStream_t stream) {
    if (fused) return launch_pull<U, LANES, NV, true, false>(a, stream);
    return Geo<LANES>::SLOTS * a.heads <= W_STAGED
               ? launch_pull<U, LANES, NV, false, true>(a, stream)
               : launch_pull<U, LANES, NV, false, false>(a, stream);
}

// The group for the row width: 16 lanes where it is at most 16 units, else
// a warp with 1, 2 or 4 units a lane a pass. The fused variant's passes
// hold whole heads.
template <int U>
int dispatch_pull(Pull a, bool fused, cudaStream_t stream) {
    const int units = a.heads * a.d_head / U;
    const int lanes = units <= 16 ? 16 : 32;
    const int nv = lanes == 16 || units <= 32 ? 1 : units <= 64 ? 2 : 4;
    a.pass_units = lanes * nv;
    if (fused) {
        const int uph = a.d_head / U;
        a.pass_units = a.pass_units / uph * uph;
        if (a.pass_units == 0) return static_cast<int>(cudaErrorInvalidValue);  // a head past a pass
    }
    if (lanes == 16) return launch_variant<U, 16, 1>(a, fused, stream);
    if (nv == 1) return launch_variant<U, 32, 1>(a, fused, stream);
    if (nv == 2) return launch_variant<U, 32, 2>(a, fused, stream);
    return launch_variant<U, 32, 4>(a, fused, stream);
}

int run_pull(const Pull& a, bool fused, int n_partials, cudaStream_t s) {
    if (n_partials > 0) {
        if (cudaError_t err = cudaMemsetAsync(a.count, 0, sizeof(int) * n_partials, s))
            return static_cast<int>(err);
    }
    const bool vec4 = a.d_head % 4 == 0 && aligned16(a.x) && aligned16(a.partial) &&
                      aligned16(a.out) && aligned16(a.hsrc);
    return vec4 ? dispatch_pull<4>(a, fused, s) : dispatch_pull<1>(a, fused, s);
}

}  // namespace

// Plain C interface for ctypes. Each call launches on the given stream and
// returns the CUDA error code (0 on success). The wrappers check devices,
// types, shapes and contiguity; sizes are at least 1, and heads divides 32
// for S2.

// S1: a memset of the split rows' counters, then one launch. work is i32
// [n_work, 4] and work_start i64 [n_work + 1]; partial f32 [n_partials,
// heads * d_head] and count i32 [n_partials] are null when no row is split.
extern "C" int segment_pull(const float* x, const float* w, const int* idx, const int* work,
                            const long long* work_start, int n_work, int heads, int d_head,
                            float* partial, int* count, int n_partials, float* out, void* stream) {
    const Pull a{x, w, idx, reinterpret_cast<const int4*>(work), work_start, n_work, heads, d_head,
                 0, partial, count, out, nullptr, nullptr, nullptr, nullptr};
    return run_pull(a, false, n_partials, static_cast<cudaStream_t>(stream));
}

// S1 over a transpose view with the head dot: memsets of dot (f32
// [n_dot, heads]) and of the counters, then one launch. g is the gathered
// rows, w the forward weights [n_dot, heads], fpos i32 [S] each slot's
// forward slot or -1, hsrc f32 rows of heads * d_head, node i32 [rows] or
// null; the rest as segment_pull.
extern "C" int segment_pull_dot(const float* g, const float* w, const int* idx, const int* work,
                                const long long* work_start, int n_work, int heads, int d_head,
                                float* partial, int* count, int n_partials, float* out,
                                const int* fpos, const float* hsrc, const int* node, float* dot,
                                long long n_dot, void* stream) {
    const Pull a{g, w, idx, reinterpret_cast<const int4*>(work), work_start, n_work, heads, d_head,
                 0, partial, count, out, fpos, hsrc, node, dot};
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (cudaError_t err = cudaMemsetAsync(dot, 0, sizeof(float) * n_dot * heads, s))
        return static_cast<int>(err);
    return run_pull(a, true, n_partials, s);
}

// S2 forward: att [S, heads] from e [S, heads]; live u8 [S] or null (all live).
extern "C" int segment_softmax_fwd(const float* e, const unsigned char* live,
                                   const long long* row_ptr, long long n_rows, int heads,
                                   float* att, void* stream) {
    softmax_fwd_kernel<<<blocks_for(n_rows, THREADS / 32), THREADS, 0,
                         static_cast<cudaStream_t>(stream)>>>(e, live, row_ptr, n_rows, heads, att);
    return static_cast<int>(cudaGetLastError());
}

// S2 backward: de [S, heads] from att and its cotangent g.
extern "C" int segment_softmax_bwd(const float* att, const float* g, const long long* row_ptr,
                                   long long n_rows, int heads, float* de, void* stream) {
    softmax_bwd_kernel<<<blocks_for(n_rows, THREADS / 32), THREADS, 0,
                         static_cast<cudaStream_t>(stream)>>>(att, g, row_ptr, n_rows, heads, de);
    return static_cast<int>(cudaGetLastError());
}

extern "C" const char* segment_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}
