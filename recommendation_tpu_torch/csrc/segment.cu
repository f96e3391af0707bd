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
// lane a head writes. A head wider than one column pass (512 f32, or 128
// one f32 at a time) spans passes that each lie inside it: the pass's dot
// is the lane's products in order and a full-warp xor tree, and the lane
// that writes a slot's dot in the head's first pass adds each later pass's
// into it, in pass order (the group walks the same slots in every pass).
// A split row merges dh only: a slot's dot is written by the piece that
// holds it.
//
// S2, the segment softmax, forward and backward
// (ops/segment.py::attention_softmax, attention_softmax_bwd, and without
// the logits segment_softmax_rows, segment_softmax_rows_bwd):
//
//     z[s, h] = a_src[idx[s], h] + a_dst[dst[s], h];  e = LeakyReLU(z, slope)
//     m = max over live slots of e[s, h] (0 where no slot is live)
//     att[s, h] = live[s] ? exp(e[s, h] - m) / (sum_live exp(e - m) + 1e-16) : 0
//     de[s, h] = att[s, h] * (g[s, h] - sum_{s' in row} att[s', h] g[s', h])
//     dz[s, h] = live[s] ? de[s, h] * (z[s, h] >= 0 ? 1 : slope) : 0
//
// where the forward may also write w = att * keep and the backward takes
// g = datt * keep (the attention dropout). What bounds it: bytes, the
// slots' idx, dst and live, att written (the backward: att and datt read,
// dz written, keep where given) and the distinct [N, H] logit rows once:
// at the clustered bucket rows, H = 4, about 25 bytes a slot forward. The
// design takes S1's tile walk (csrc/pull_tiles.cuh):
//   * P1's work list: one item per row of up to CHUNK slots, and one per
//     CHUNK-slot piece of a longer row, so a hub row of 10^4 slots is
//     spread over the card. Persistent blocks walk tiles of 16 items, their
//     descriptors and first slots staged by cp.async, STAGES deep.
//   * A tile in three steps, a barrier apart, for each pass over up to
//     HP = 4 heads (more heads take more passes): every thread a slot,
//     holding all the pass's heads of it (a float4 at H = 4, coalesced),
//     its values into shared memory, so all the tile's loads and gathers
//     are in flight at once; a warp an item (two a warp), the row's per-head max and
//     sums from shared memory: a lane's slots in order, then a fixed xor
//     tree over the warp, for any H; every thread a slot again, its
//     outputs. Most rows are short (16.5 slots on average at the clustered
//     bucket rows), so a warp that walked a row alone, loads, trees and
//     stores one after another, left the card waiting on memory.
//   * The logits are gathered in the kernel (a_src and a_dst are [N, H],
//     L2-resident) and the LeakyReLU applied there; the backward recomputes
//     z's sign from them in its epilogue with the mask. Neither e nor z is
//     written to device memory.
//   * A row of one item finishes in its tile: one read of its inputs from
//     device memory (the backward reads att and g again, from L1 or L2,
//     for its outputs), one write of its outputs. A split row's pieces write their per-head
//     statistics (the forward's (max, sum) rescaled to the piece's own max,
//     the backward's sum); the warp finishing the row's last piece (an
//     integer counter per row, zeroed on the stream) merges them in piece
//     order, as K5 merges its splits. A second launch over the split rows'
//     pieces then writes their outputs from the row's statistics: blocks
//     need no grid-wide barrier, and pieces need not be resident at once.
//   * live is read per slot (no division by the head count).
// Without the logits (softmax-only: e given, or the backward without the
// slope and mask) the same kernels read e, or leave the epilogue out:
// torch.sparse.softmax and its backward compute that function, the
// library yardstick.
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
    // a head wider than a column pass: each pass lies inside one head, and
    // its partial dots are added into the dot in pass order
    const bool wide = FUSED && uph > a.pass_units;
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

            for (int ub = 0, ue = 0; ub < units; ub = ue) {  // one pass up to 512 f32
                ue = min(units, ub + a.pass_units);
                if (wide) ue = min(ue, (ub / uph + 1) * uph);  // up to its head's end
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
                        if (wide) {  // the pass's units of one head: the lane's in order, then the warp's tree
#pragma unroll
                            for (int u = 0; u < UNROLL; ++u)
#pragma unroll
                                for (int j = 1; j < NV; ++j) pd[u][0] = __fadd_rn(pd[u][0], pd[u][j]);
#pragma unroll
                            for (int o = LANES >> 1; o > 0; o >>= 1) {
#pragma unroll
                                for (int u = 0; u < UNROLL; ++u)
                                    pd[u][0] = __fadd_rn(pd[u][0], __shfl_xor_sync(FULL, pd[u][0], o));
                            }
                            if (l == 0) {  // the same lane writes a slot's dot in every pass
#pragma unroll
                                for (int u = 0; u < UNROLL; ++u) {
                                    if (fp[u] < 0) continue;
                                    float* at = a.dot + static_cast<size_t>(fp[u]) * heads + hh[0];
                                    *at = ub % uph == 0 ? pd[u][0] : __fadd_rn(*at, pd[u][0]);
                                }
                            }
                        } else if (contig) {  // one head a lane: its units' dots added in order
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
// hold whole heads where a head fits one; a wider head spans passes.
template <int U>
int dispatch_pull(Pull a, bool fused, cudaStream_t stream) {
    const int units = a.heads * a.d_head / U;
    const int lanes = units <= 16 ? 16 : 32;
    const int nv = lanes == 16 || units <= 32 ? 1 : units <= 64 ? 2 : 4;
    a.pass_units = lanes * nv;
    const int uph = a.d_head / U;
    if (fused && uph <= a.pass_units) a.pass_units = a.pass_units / uph * uph;
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

// -- S2: the segment softmax on P1's work list ---------------------------------

__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }

constexpr int S2_ITEMS = 16;  // a tile's items: two a warp in the reductions
constexpr int S2_SLOTS = S2_ITEMS * CHUNK;

// One S2 call's operands. Forward: the logits, LeakyReLU(a_src[idx] +
// a_dst[dst], slope) where LOGITS, else e; writes att and, where keep is
// given, w = att * keep. Backward: att and the cotangent g (times keep
// where given); writes de, or where LOGITS dz = live ? de * (z >= 0 ? 1 :
// slope) : 0 with z recomputed from a_src and a_dst.
struct Soft {
    const int4* work;             // the work list (ops/gather.py::pull_schedule)
    const long long* work_start;  // [n_work + 1]
    int n_work;
    int heads;
    int vec;  // heads % 4 == 0 and every [*, heads] operand 16-byte aligned
    const float* e;
    const float* a_src;         // [N, heads]
    const float* a_dst;         // [N, heads]
    const int* idx;             // [S]
    const int* dst;             // [S]
    const unsigned char* live;  // [S], null: every slot live
    float slope;
    const float* att;
    const float* g;
    const float* keep;  // [S, heads] or null
    float* out;         // att, de or dz [S, heads]
    float* w;           // att * keep, or null
    float* stat;        // split rows: a piece's (max, sum) [2 heads] forward, sum [heads] backward
    int* count;         // [n_partials], zeroed on the stream
    int* piece_item;    // [n_partials] each piece's work item
};

// One stage buffer: the tile's items' descriptors (int4), then their first
// slots (i64)
constexpr int SOFT_START = S2_ITEMS * 16;
constexpr int SOFT_STAGE = (SOFT_START + (S2_ITEMS + 1) * 8 + 15) / 16 * 16;

// nh <= HP heads of a [*, heads] row from p (the rest 0): 16-byte loads where vec
template <int HP>
__device__ __forceinline__ void load_heads(const float* p, int nh, bool vec, float (&v)[HP]) {
    if constexpr (HP % 4 == 0) {
        if (vec) {
#pragma unroll
            for (int j = 0; j < HP; j += 4) {
                const float4 t = j < nh ? __ldg(reinterpret_cast<const float4*>(p + j))
                                        : make_float4(0.f, 0.f, 0.f, 0.f);
                v[j] = t.x; v[j + 1] = t.y; v[j + 2] = t.z; v[j + 3] = t.w;
            }
            return;
        }
    }
#pragma unroll
    for (int j = 0; j < HP; ++j) v[j] = j < nh ? __ldg(p + j) : 0.f;
}

template <int HP>
__device__ __forceinline__ void store_heads(float* p, int nh, bool vec, const float (&v)[HP]) {
    if constexpr (HP % 4 == 0) {
        if (vec) {
#pragma unroll
            for (int j = 0; j < HP; j += 4)
                if (j < nh) *reinterpret_cast<float4*>(p + j) = make_float4(v[j], v[j + 1], v[j + 2], v[j + 3]);
            return;
        }
    }
#pragma unroll
    for (int j = 0; j < HP; ++j)
        if (j < nh) p[j] = v[j];
}

// What a warp does with one work item: a whole row; one piece of a split
// row, its statistics for the merge; or that piece's outputs once the
// row's statistics are merged
// z = a_src[src] + a_dst[dn] at heads hb .. hb + nh
template <int HP>
__device__ __forceinline__ void logit_sums(const Soft& a, int src, int dn, int hb, int nh, bool vec,
                                           float (&z)[HP]) {
    float b[HP];
    load_heads<HP>(a.a_src + static_cast<size_t>(src) * a.heads + hb, nh, vec, z);
    load_heads<HP>(a.a_dst + static_cast<size_t>(dn) * a.heads + hb, nh, vec, b);
#pragma unroll
    for (int j = 0; j < HP; ++j) z[j] = __fadd_rn(z[j], b[j]);
}

// The forward's logits of one slot at heads hb ..: LeakyReLU(z) from the
// gathered sums where LOGITS, else e
template <bool LOGITS, int HP>
__device__ __forceinline__ void slot_logits(const Soft& a, long long s, int src, int dn, int hb,
                                            int nh, bool vec, float (&v)[HP]) {
    if constexpr (LOGITS) {
        logit_sums<HP>(a, src, dn, hb, nh, vec, v);
#pragma unroll
        for (int j = 0; j < HP; ++j) v[j] = v[j] > 0.f ? v[j] : __fmul_rn(v[j], a.slope);
    } else {
        load_heads<HP>(a.e + static_cast<size_t>(s) * a.heads + hb, nh, vec, v);
    }
}

// The backward's cotangent of one slot, gg = g (· keep), with att
template <int HP>
__device__ __forceinline__ void slot_grads(const Soft& a, size_t at, int nh, bool vec, float (&att)[HP],
                                           float (&gg)[HP]) {
    load_heads<HP>(a.att + at, nh, vec, att);
    load_heads<HP>(a.g + at, nh, vec, gg);
    if (a.keep != nullptr) {
        float k[HP];
        load_heads<HP>(a.keep + at, nh, vec, k);
#pragma unroll
        for (int j = 0; j < HP; ++j) gg[j] = __fmul_rn(gg[j], k[j]);
    }
}

// The backward's output of one slot: de = att · (gg − dot), and where
// LOGITS the slope at z (>= 0: 1) and 0 at a dead slot
template <bool LOGITS, int HP>
__device__ __forceinline__ void slot_dz(const Soft& a, size_t at, int src, int dn, bool lv, int hb,
                                        int nh, bool vec, const float (&dot)[HP]) {
    float att[HP], gg[HP], de[HP];
    slot_grads<HP>(a, at, nh, vec, att, gg);
    float z[HP];
    if constexpr (LOGITS) logit_sums<HP>(a, src, dn, hb, nh, vec, z);
#pragma unroll
    for (int j = 0; j < HP; ++j) {
        de[j] = __fmul_rn(att[j], __fsub_rn(gg[j], dot[j]));
        if constexpr (LOGITS) de[j] = lv ? __fmul_rn(de[j], z[j] >= 0.f ? 1.f : a.slope) : 0.f;
    }
    store_heads<HP>(a.out + at, nh, vec, de);
}

// The forward's output of one slot from its exp(e − max) and the row's
// denominator: att, and w = att · keep where keep is given
template <int HP>
__device__ __forceinline__ void slot_att(const Soft& a, size_t at, int nh, bool vec, float (&v)[HP],
                                         const float (&den)[HP]) {
#pragma unroll
    for (int j = 0; j < HP; ++j) v[j] = __fdiv_rn(v[j], den[j]);
    store_heads<HP>(a.out + at, nh, vec, v);
    if (a.w != nullptr) {
        float k[HP];
        load_heads<HP>(a.keep + at, nh, vec, k);
#pragma unroll
        for (int j = 0; j < HP; ++j) k[j] = __fmul_rn(v[j], k[j]);
        store_heads<HP>(a.w + at, nh, vec, k);
    }
}

// A split row's pieces merged in piece order by the warp that finished the
// last one, a lane a head: forward, each piece's (max, sum) rescaled to the
// running max as K5 merges its splits (a piece with no live slot adds
// nothing; the max is 0 where the row has none); backward, the pieces'
// sums added. The row's result goes in its first piece's entry.
template <bool BWD>
__device__ __forceinline__ void merge_pieces(const Soft& a, int part, int pieces, int lane) {
    const int heads = a.heads;
    for (int h = lane; h < heads; h += 32) {
        if constexpr (BWD) {
            float* st = a.stat + static_cast<size_t>(part) * heads + h;
            float sum = __ldcg(st);
            for (int p = 1; p < pieces; ++p)
                sum = __fadd_rn(sum, __ldcg(st + static_cast<size_t>(p) * heads));
            *st = sum;
        } else {
            float* st = a.stat + static_cast<size_t>(part) * 2 * heads + h;
            float m = __ldcg(st), s = __ldcg(st + heads);
            for (int p = 1; p < pieces; ++p) {
                const float* o = st + static_cast<size_t>(p) * 2 * heads;
                const float om = __ldcg(o), os = __ldcg(o + heads);
                if (om == neg_inf()) continue;
                if (m == neg_inf()) {
                    m = om, s = os;
                    continue;
                }
                const float nm = fmaxf(m, om);
                s = __fadd_rn(__fmul_rn(s, expf(__fsub_rn(m, nm))),
                              __fmul_rn(os, expf(__fsub_rn(om, nm))));
                m = nm;
            }
            if (!isfinite(m)) m = 0.f;
            st[0] = m;
            st[heads] = s;
        }
    }
}

// The reductions' work area after the stage buffers: each slot's values
// at the pass's heads (the logits, then exp(e − max); the backward's att ·
// gg) [S2_SLOTS][HP], each slot's live flag, and each item's row result
// (the forward's denominator, the backward's sum) [S2_ITEMS][HP]
template <int HP>
__host__ __device__ constexpr int soft_work_bytes() {
    return S2_SLOTS * HP * 4 + S2_SLOTS + S2_ITEMS * HP * 4;
}

// S2's first launch: persistent blocks walk the work list's tiles of
// S2_ITEMS items, their descriptors and first slots staged by cp.async.
// For each pass over HP heads a tile takes
// three steps, a barrier apart: every thread a slot, its values into
// shared memory (all the tile's gathers in flight at once); a warp an
// item, its row's max and sum (the backward's sum of att · gg): a lane's
// slots in order, then the xor tree; every thread a slot again, its
// outputs. A split row's piece writes its statistics instead, the warp
// finishing the row's last piece merges them, and its slots are left to
// the second launch.
template <bool BWD, bool LOGITS, int HP>
__global__ void __launch_bounds__(THREADS) softmax_kernel(const Soft a) {
    extern __shared__ __align__(16) unsigned char soft_smem[];
    unsigned char* work_area = soft_smem + STAGES * SOFT_STAGE;
    float* vals = reinterpret_cast<float*>(work_area);                         // [S2_SLOTS][HP]
    unsigned char* lives = work_area + S2_SLOTS * HP * 4;                        // [S2_SLOTS]
    float* rows = reinterpret_cast<float*>(lives + S2_SLOTS);                    // [S2_ITEMS][HP]
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int heads = a.heads;
    const bool vec = a.vec != 0;
    const int n_tiles = (a.n_work + S2_ITEMS - 1) / S2_ITEMS;

    auto range = [&](int t) { return tile_range(a.work, a.work_start, a.n_work, S2_ITEMS, t); };
    auto stage = [&](int t, const TileRange&, int b) {
        unsigned char* s = soft_smem + static_cast<size_t>(b) * SOFT_STAGE;
        int4* work = reinterpret_cast<int4*>(s);
        long long* start = reinterpret_cast<long long*>(s + SOFT_START);
        const int first = t * S2_ITEMS, count = min(S2_ITEMS, a.n_work - first);
        for (int e = threadIdx.x; e <= count; e += THREADS) {
            if (e < count) cp_async16(work + e, a.work + first + e, 16);
            cp_async8(start + e, a.work_start + first + e, 8);
        }
    };
    auto body = [&](int t, int b) {
        const unsigned char* s = soft_smem + static_cast<size_t>(b) * SOFT_STAGE;
        const int4* work = reinterpret_cast<const int4*>(s);
        const long long* start = reinterpret_cast<const long long*>(s + SOFT_START);
        const int count = min(S2_ITEMS, a.n_work - t * S2_ITEMS);
        const long long lo = start[0];
        const int n_t = static_cast<int>(start[count] - lo);
        // slot k's source and destination node
        auto src_of = [&](int k) { return LOGITS ? __ldg(a.idx + lo + k) : 0; };
        auto dst_of = [&](int k) { return LOGITS ? __ldg(a.dst + lo + k) : 0; };
        for (int hb = 0; hb < heads; hb += HP) {  // heads past HP take another pass
            const int nh = min(HP, heads - hb);
            // 1. every thread a slot: its values
            for (int k = threadIdx.x; k < n_t; k += THREADS) {
                const long long sl = lo + k;
                float v[HP];
                if constexpr (BWD) {
                    float gg[HP];
                    slot_grads<HP>(a, static_cast<size_t>(sl) * heads + hb, nh, vec, v, gg);
#pragma unroll
                    for (int j = 0; j < HP; ++j) v[j] = __fmul_rn(v[j], gg[j]);
                } else {
                    slot_logits<LOGITS, HP>(a, sl, src_of(k), dst_of(k), hb, nh, vec, v);
                }
#pragma unroll
                for (int j = 0; j < HP; ++j) vals[k * HP + j] = v[j];
                lives[k] = a.live == nullptr || __ldg(a.live + sl) != 0;
            }
            __syncthreads();
            // 2. a warp an item: the row's statistics
            for (int it = warp; it < count; it += THREADS / 32) {
                const int4 wk = work[it];  // (row, piece, the row's first partial, the row's pieces)
                const int off = static_cast<int>(start[it] - lo);
                const int n = static_cast<int>(start[it + 1] - start[it]);
                float* v = vals + off * HP;
                const unsigned char* lv = lives + off;
                float m[HP], sum[HP];
#pragma unroll
                for (int j = 0; j < HP; ++j) m[j] = neg_inf(), sum[j] = 0.f;
                if constexpr (!BWD) {
                    for (int k = lane; k < n; k += 32)
                        if (lv[k]) {
#pragma unroll
                            for (int j = 0; j < HP; ++j) m[j] = fmaxf(m[j], v[k * HP + j]);
                        }
#pragma unroll
                    for (int o = 16; o > 0; o >>= 1)
#pragma unroll
                        for (int j = 0; j < HP; ++j) m[j] = fmaxf(m[j], __shfl_xor_sync(FULL, m[j], o));
                    if (wk.w == 1) {
#pragma unroll
                        for (int j = 0; j < HP; ++j)
                            if (!isfinite(m[j])) m[j] = 0.f;  // no live slot: every weight is 0
                    }
                    for (int k = lane; k < n; k += 32) {
#pragma unroll
                        for (int j = 0; j < HP; ++j) {
                            const float ex = lv[k] ? expf(__fsub_rn(v[k * HP + j], m[j])) : 0.f;
                            v[k * HP + j] = ex;
                            sum[j] = __fadd_rn(sum[j], ex);
                        }
                    }
                } else {
                    for (int k = lane; k < n; k += 32) {
#pragma unroll
                        for (int j = 0; j < HP; ++j) sum[j] = __fadd_rn(sum[j], v[k * HP + j]);
                    }
                }
#pragma unroll
                for (int o = 16; o > 0; o >>= 1)
#pragma unroll
                    for (int j = 0; j < HP; ++j) sum[j] = __fadd_rn(sum[j], __shfl_xor_sync(FULL, sum[j], o));
                if (wk.w == 1) {
                    if (lane == 0) {
#pragma unroll
                        for (int j = 0; j < HP; ++j)
                            rows[it * HP + j] = BWD ? sum[j] : __fadd_rn(sum[j], 1e-16f);
                    }
                } else {
                    const int stride = BWD ? heads : 2 * heads;
                    if (lane == 0) {
                        float* st = a.stat + static_cast<size_t>(wk.z + wk.y) * stride + hb;
#pragma unroll
                        for (int j = 0; j < HP; ++j) {
                            if (j >= nh) continue;
                            if constexpr (BWD) {
                                st[j] = sum[j];
                            } else {
                                st[j] = m[j];
                                st[heads + j] = sum[j];
                            }
                        }
                    }
                    if (hb + HP >= heads) {  // the piece's every head is written
                        if (lane == 0) a.piece_item[wk.z + wk.y] = t * S2_ITEMS + it;
                        if (last_piece(a.count, wk.z, wk.w, FULL, lane, 0))
                            merge_pieces<BWD>(a, wk.z, wk.w, lane);
                    }
                }
            }
            __syncthreads();
            // 3. every thread a slot of a row of one item: its outputs
            for (int k = threadIdx.x; k < n_t; k += THREADS) {
                int i = count - 1;
                while (start[i] - lo > k) --i;
                if (work[i].w != 1) continue;  // a split row's piece: the second launch
                const size_t at = static_cast<size_t>(lo + k) * heads + hb;
                float r[HP];
#pragma unroll
                for (int j = 0; j < HP; ++j) r[j] = rows[i * HP + j];
                if constexpr (BWD) {
                    slot_dz<LOGITS, HP>(a, at, src_of(k), dst_of(k), lives[k] != 0, hb, nh, vec, r);
                } else {
                    float v[HP];
#pragma unroll
                    for (int j = 0; j < HP; ++j) v[j] = vals[k * HP + j];
                    slot_att<HP>(a, at, nh, vec, v, r);
                }
            }
            __syncthreads();  // the work area is free for the next pass
        }
    };
    walk_tiles<STAGES>(n_tiles, range, stage, body);
}

// S2's second launch, where rows are split: a warp a piece writes its
// slots' outputs from the row's merged statistics.
template <bool BWD, bool LOGITS, int HP>
__global__ void __launch_bounds__(THREADS) softmax_pieces_kernel(const Soft a, int n_partials) {
    const int lane = threadIdx.x & 31;
    const int p = blockIdx.x * (THREADS / 32) + (threadIdx.x >> 5);
    if (p >= n_partials) return;
    const int item = a.piece_item[p];
    const int part = a.work[item].z, heads = a.heads;
    const long long s_first = a.work_start[item];
    const int n = static_cast<int>(a.work_start[item + 1] - s_first);
    const bool vec = a.vec != 0;
    for (int hb = 0; hb < heads; hb += HP) {
        const int nh = min(HP, heads - hb);
        const float* st = a.stat + static_cast<size_t>(part) * (BWD ? heads : 2 * heads) + hb;
        float m[HP], r[HP];
#pragma unroll
        for (int j = 0; j < HP; ++j) {
            m[j] = BWD || j >= nh ? 0.f : st[j];
            r[j] = j >= nh ? 1.f : BWD ? st[j] : __fadd_rn(st[heads + j], 1e-16f);
        }
        for (int k = lane; k < n; k += 32) {
            const long long sl = s_first + k;
            const size_t at = static_cast<size_t>(sl) * heads + hb;
            const bool lv = a.live == nullptr || __ldg(a.live + sl) != 0;
            const int src = LOGITS ? __ldg(a.idx + sl) : 0, dn = LOGITS ? __ldg(a.dst + sl) : 0;
            if constexpr (BWD) {
                slot_dz<LOGITS, HP>(a, at, src, dn, lv, hb, nh, vec, r);
            } else {
                float v[HP];
                slot_logits<LOGITS, HP>(a, sl, src, dn, hb, nh, vec, v);
#pragma unroll
                for (int j = 0; j < HP; ++j) v[j] = lv ? expf(__fsub_rn(v[j], m[j])) : 0.f;
                slot_att<HP>(a, at, nh, vec, v, r);
            }
        }
    }
}

// S2 with the head pass HP for the head count: a memset of the split rows'
// counters, the walk, then the split rows' pieces
template <bool BWD, bool LOGITS, int HP>
int launch_soft(const Soft& a, int n_partials, cudaStream_t stream) {
    auto kernel = softmax_kernel<BWD, LOGITS, HP>;
    const int smem = STAGES * SOFT_STAGE + soft_work_bytes<HP>();
    static int resident[64] = {};
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess || dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
    if (resident[dev] <= 0) {
        if (cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem))
            return static_cast<int>(err);
        resident[dev] = resident_blocks(kernel, smem);
    }
    if (resident[dev] <= 0) return static_cast<int>(cudaErrorLaunchOutOfResources);
    if (n_partials > 0) {
        if (cudaError_t err = cudaMemsetAsync(a.count, 0, sizeof(int) * n_partials, stream))
            return static_cast<int>(err);
    }
    const int tiles = (a.n_work + S2_ITEMS - 1) / S2_ITEMS;
    kernel<<<tiles < resident[dev] ? tiles : resident[dev], THREADS, smem, stream>>>(a);
    if (cudaError_t err = cudaGetLastError()) return static_cast<int>(err);
    if (n_partials == 0) return 0;
    softmax_pieces_kernel<BWD, LOGITS, HP>
        <<<(n_partials + THREADS / 32 - 1) / (THREADS / 32), THREADS, 0, stream>>>(a, n_partials);
    return static_cast<int>(cudaGetLastError());
}

template <bool BWD, bool LOGITS>
int dispatch_soft(Soft a, int n_partials, cudaStream_t stream) {
    const float* ops[] = {a.e, a.a_src, a.a_dst, a.att, a.g, a.keep, a.out, a.w};
    bool vec = a.heads % 4 == 0;
    for (const float* p : ops) vec = vec && aligned16(p);
    a.vec = vec ? 1 : 0;
    if (a.heads == 1) return launch_soft<BWD, LOGITS, 1>(a, n_partials, stream);
    if (a.heads == 2) return launch_soft<BWD, LOGITS, 2>(a, n_partials, stream);
    return launch_soft<BWD, LOGITS, 4>(a, n_partials, stream);
}

}  // namespace

// Plain C interface for ctypes. Each call launches on the given stream and
// returns the CUDA error code (0 on success). The wrappers check devices,
// types, shapes and contiguity; sizes are at least 1.

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

// S2 forward, on the work list: a memset of the split rows' counters, one
// launch, and a second over the split rows' pieces where n_partials > 0.
// With a_src (and a_dst, idx, dst) the logits LeakyReLU(a_src[idx] +
// a_dst[dst], slope) [S, heads]; without, e. live u8 [S] or null (all
// live); keep [S, heads] or null, w = att * keep where given. stat f32
// [n_partials, 2 heads], count and piece_item i32 [n_partials], null when
// no row is split.
extern "C" int segment_softmax_fwd(const int* work, const long long* work_start, int n_work,
                                   int heads, const float* e, const float* a_src,
                                   const float* a_dst, const int* idx, const int* dst,
                                   const unsigned char* live, float slope, const float* keep,
                                   float* att, float* w, float* stat, int* count, int* piece_item,
                                   int n_partials, void* stream) {
    const Soft a{reinterpret_cast<const int4*>(work), work_start, n_work, heads, 0, e, a_src, a_dst,
                 idx, dst, live, slope, nullptr, nullptr, keep, att, w, stat, count, piece_item};
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    return a_src != nullptr ? dispatch_soft<false, true>(a, n_partials, s)
                            : dispatch_soft<false, false>(a, n_partials, s);
}

// S2 backward, launched as the forward: from att and its cotangent g
// (times keep [S, heads] where given), de = att * (g - sum_row att * g);
// with a_src (and a_dst, idx, dst, live, slope), dz = live ? de * (z >= 0
// ? 1 : slope) : 0, z = a_src[idx] + a_dst[dst]. stat f32 [n_partials,
// heads].
extern "C" int segment_softmax_bwd(const int* work, const long long* work_start, int n_work,
                                   int heads, const float* att, const float* g, const float* keep,
                                   const float* a_src, const float* a_dst, const int* idx,
                                   const int* dst, const unsigned char* live, float slope,
                                   float* out, float* stat, int* count, int* piece_item,
                                   int n_partials, void* stream) {
    const Soft a{reinterpret_cast<const int4*>(work), work_start, n_work, heads, 0, nullptr, a_src,
                 a_dst, idx, dst, live, slope, att, g, keep, out, nullptr, stat, count, piece_item};
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    return a_src != nullptr ? dispatch_soft<true, true>(a, n_partials, s)
                            : dispatch_soft<true, false>(a, n_partials, s);
}

extern "C" const char* segment_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}
