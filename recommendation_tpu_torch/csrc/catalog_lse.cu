// Streaming full-catalog logsumexp, forward (K5) and backward (K6), on
// Hopper (sm_90a).
//
// K5 replaces recommendation_tpu/ops/pallas_losses.py::_lse_fwd_kernel
// (:45-96, reached through catalog_logsumexp :160):
//
//     lse[b] = logsumexp_n(q[b] . x[n] / tau)      q [B, d], x [N, d] f32 -> [B] f32
//
// K6 replaces _lse_bwd_kernel (:102-153): with p[b, n] = exp(q[b].x[n]/tau
// - lse[b]) * g[b],
//
//     dq = p . x / tau    [B, d]          dx = p^T . q / tau    [N, d]
//
// The TPU kernels walk the item blocks in order and carry (max, sum) and dq
// in scratch from one grid step to the next. Blocks on the H100 run in no
// order, and the [B, N] scores never reach device memory. Both kernels take
// their scores from one piece of arithmetic: a block's 64 x 64 tile of
// (query rows, item rows), staged into shared memory by cp.async
// (stage_rows) and multiplied in 4 x 4 register micro-tiles (tile_scores).
//   * K5 (lse_fwd_kernel): a block owns one 64-row query tile and one split
//     of w consecutive item tiles. It keeps its query tile in shared memory
//     (d <= 64; above, the d-slices of both operands stream), copies the
//     next item tile in while it computes the current one, and keeps each
//     query row's running (max, sum) in registers. A thread folds its 4
//     columns of each tile into its 4 rows' (max, sum); the 16 threads of a
//     row merge theirs by a fixed butterfly and a fixed pair at the end, and
//     the block writes one (max, sum) per row and split. A second launch
//     (lse_fwd_combine_kernel) merges the splits in split order into
//     m + log(s). Ragged B, N and d are masked: a column past N adds nothing,
//     as exp(-1e30 - m) = 0 would.
//   * K6 (lse_bwd_kernel): two sides in one launch. A query-side block
//     owns one 64-row query tile and walks one split of item tiles,
//     adding p . x into its partial dq; an item-side block owns one item
//     tile and walks one split of query tiles, adding p^T . q into its
//     partial dx. Each side recomputes the tile's scores (the same bits:
//     an FFMA's product does not depend on its operands' order), so a call
//     is four products where the TPU's is three. A second launch
//     (lse_bwd_combine_kernel) adds the splits' partials in split order.
// The scores are f32 FFMA products (no TF32) divided by tau, then
// exp(s - lse) * g; the sums are divided by tau at the end, as the JAX
// kernel does.
//
// What bounds K5 on an H100: at NCL's step shape (B = 2048, N = 943 and
// 1675, d = 64) a call is 2BNd = 0.25 and 0.44 GFLOP of f32 FFMA, 3.7 and
// 6.5 us at 67 TFLOP/s, against under 1 MB of inputs: the operations bound
// it. What the design does about it:
//   * One wave of busy blocks: the split size w is the fewest item tiles
//     that keep ceil(B/64) x ceil(N/(64 w)) blocks within what the card
//     holds at once (the wrapper's plan, from the occupancy the runtime
//     reports: lse_fwd_blocks_per_sm). At NCL's shapes that is 32 x 8 and
//     32 x 7 blocks of 256 threads (w = 2 and 4); at a 100,000-item
//     catalog 32 x 8 (w = 196), and the partials stay S x B x 2 floats.
//   * Register micro-tiles: 8 float4 shared loads feed 64 FFMA, a warp is
//     8 x 4 threads so that each load is one shared-memory wavefront (K6's
//     tile, see below).
//   * Asynchronous staging: the next item tile is in flight while the
//     current one is multiplied, so only a split's first tile waits on
//     memory.
//   * A fixed-order merge: the butterfly, the pair of warps and the splits
//     merge in one order whichever block finishes first, so a call repeats
//     bit for bit. No atomics, no counters kept between calls. Two launches
//     a call.
//
// What bounds K6 on an H100: at NCL's step shape (B = 2048 against N = 943
// and 1675, d = 64) a call is 4 x 2BNd = 1.0 and 1.8 GFLOP of f32 FFMA
// (the function's own work is three of those products), 15 and 26 us at
// 67 TFLOP/s, against about 1.5 MB of inputs and outputs: the operations
// bound it. At B = 8192 against 100,000 items it is 420 GFLOP. What the
// design does about it:
//   * A workspace that does not grow with B x N. The TPU kernel keeps dq in
//     VMEM across its sequential item blocks; here each side keeps its
//     output tile in shared memory across the tiles it walks, and only a
//     split's partial reaches device memory: sq x B x d floats for dq and
//     sx x N x d for dx. The wrapper's plan (lse_bwd_plan) sizes the
//     splits so that both sides together fill one wave of the card
//     (lse_bwd_blocks_per_sm): at NCL's shapes 4 x 32 + 8 x 15 = 248 and
//     4 x 32 + 5 x 27 = 263 blocks, 4.0 and 4.2 MB of partials; at 8192 x
//     100,000 the item side's 1563 tiles already pass a wave (sx = 1) and
//     the query side takes sq = 2: 29.8 MB, where one partial per tile
//     pair took 6.55 GB.
//   * Register micro-tiles: each thread owns 4 x 4 scores (owned rows
//     ty + 16 i, walked rows tx + 16 j) and then 4 x 4 of the product
//     (rows ty + 16 i, columns 4 tx .. 4 tx + 3 of each 64-column slice),
//     which it loads from and stores back to its own entries of the
//     shared accumulator. Every shared load is a float4 that feeds 4 FFMA
//     for each of 4 rows: 8 loads per 64 FFMA, and a warp is 8 x 4
//     threads so that each load is one shared-memory wavefront.
//   * Asynchronous staging: the owned tile is staged once (d <= 64) and
//     the next walked tile is in flight while the current one is
//     multiplied. Above d = 64, slices of both stream through two stages
//     for the scores, and the walked slices once more for the product.
//     Shared memory: 5 x 64 x 68 floats and the accumulator, 87,040 bytes
//     at d <= 64 (two blocks an SM) and up to 219,136 at d = 512.
//   * Any d: the output columns are cut into slabs of at most SLAB slices
//     (512 columns), a grid dimension. A slab's block recomputes its tile's
//     scores over all of d and accumulates its own columns only, so the
//     accumulator, and the shared memory, stop growing at d = 512; past it
//     each extra slab repeats the score product (at d = 1024 a call is
//     4 + 2 = 6 products of 2BNd where d <= 512 takes 4). The plan
//     (ops/lse.py::lse_bwd_plan) sizes the splits to one wave of all the
//     slabs' blocks; a partial's columns are written by their slab alone.
//   * A fixed-order combine: the splits' partials are added in split
//     order by a second launch spread over the card, then divided by tau.
//     No float atomics: a call repeats bit for bit. Two launches a call.

#include <cuda_runtime.h>
#include <stdint.h>

#include "cp_async.cuh"

namespace {

// The score tile K5 and K6 share
constexpr int BT = 64;          // query rows and item rows of a block's tile
constexpr int BK = 64;          // columns of d per staged slice
constexpr int BLD = BK + 4;     // padded row: rows tx .. tx + 7 start 4 banks apart
constexpr int BTHREADS = 256;   // 16 x 16, a 4 x 4 micro-tile each
constexpr int SLAB = 8;         // K6: d-slices of output columns a block accumulates
constexpr float NEG_INF = -1e30f;

// Stage rows row0 .. row0 + BT, columns col0 .. col0 + BK of src [n_rows, d]
// into dst [BT][BLD]; outside n_rows x d reads as 0.
__device__ __forceinline__ void stage_rows(float* dst, const float* src, int n_rows, int row0,
                                           int col0, int d, bool vec) {
    if (vec) {
        for (int e = threadIdx.x; e < BT * (BK / 4); e += BTHREADS) {
            const int r = e / (BK / 4), c = (e % (BK / 4)) * 4;
            const int row = row0 + r, col = col0 + c;
            const bool ok = row < n_rows && col < d;  // d % 4 == 0: a copy is all in or out
            cp_async16(dst + r * BLD + c, ok ? src + (size_t)row * d + col : src, ok ? 16 : 0);
        }
    } else {
        for (int e = threadIdx.x; e < BT * BK; e += BTHREADS) {
            const int r = e / BK, c = e % BK;
            const int row = row0 + r, col = col0 + c;
            const bool ok = row < n_rows && col < d;
            cp_async4(dst + r * BLD + c, ok ? src + (size_t)row * d + col : src, ok ? 4 : 0);
        }
    }
}

// acc[i][j] += q[ty + 16 i] . x[tx + 16 j] over the slice's kmax columns
// (columns past d are staged as 0): the scores' one piece of arithmetic,
// k in order, one FFMA each.
__device__ __forceinline__ void tile_scores(const float* Q, const float* X, int kmax, int tx,
                                            int ty, float (&acc)[4][4]) {
    for (int k = 0; k < kmax; k += 4) {
        float4 qa[4], xb[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) qa[i] = *reinterpret_cast<const float4*>(Q + (ty + 16 * i) * BLD + k);
#pragma unroll
        for (int j = 0; j < 4; ++j) xb[j] = *reinterpret_cast<const float4*>(X + (tx + 16 * j) * BLD + k);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                acc[i][j] = fmaf(qa[i].x, xb[j].x, acc[i][j]);
                acc[i][j] = fmaf(qa[i].y, xb[j].y, acc[i][j]);
                acc[i][j] = fmaf(qa[i].z, xb[j].z, acc[i][j]);
                acc[i][j] = fmaf(qa[i].w, xb[j].w, acc[i][j]);
            }
    }
}

// A thread's place in a 64 x 64 tile: a warp is 8 x 4 threads, so that a
// float4 load of either operand is one shared-memory wavefront; the 16
// threads of a row (one ty) are lanes ty % 4 * 8 .. + 7 of warps 2 (ty / 4)
// and 2 (ty / 4) + 1.
__device__ __forceinline__ void tile_place(int& tx, int& ty) {
    const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
    tx = lane % 8 + 8 * (warp % 2);
    ty = lane / 8 + 4 * (warp / 2);
}

// -- K5 -----------------------------------------------------------------------

struct Fwd {
    const float* q;
    const float* x;
    int b, n, d;
    float tau;
    int w;        // item tiles per split
    int splits;   // ceil(ceil(N / BT) / w)
    float* part;  // [splits][B] (max, sum) pairs
    float* lse;
    int vec;      // d % 4 == 0 and q, x 16-byte aligned
};

// shared memory: d <= BK keeps the query tile and two item stages; above,
// two stages of (query slice, item slice)
size_t fwd_smem_bytes(int d) { return static_cast<size_t>(d > BK ? 4 : 3) * BT * BLD * sizeof(float); }

// (m, s) <- the logsumexp pair of (m, s) and (om, os): max, then the sums
// rescaled to it (a column that was never seen has m = -1e30 and s = 0)
__device__ __forceinline__ void merge(float& m, float& s, float om, float os) {
    const float nm = fmaxf(m, om);
    s = s * expf(m - nm) + os * expf(om - nm);
    m = nm;
}

__global__ void __launch_bounds__(BTHREADS, 2) lse_fwd_kernel(const Fwd a) {
    extern __shared__ __align__(16) float fwd_smem[];
    const int ns = (a.d + BK - 1) / BK;  // d slices
    const int split = blockIdx.x, qt = blockIdx.y;
    const int nx = (a.n + BT - 1) / BT;
    const int t0 = split * a.w, t1 = min(t0 + a.w, nx);
    const int q0 = qt * BT;
    int tx, ty;
    tile_place(tx, ty);
    const bool vec = a.vec != 0;
    // d <= BK: the query tile at 0, item stages at 1, 2; above: stage buf
    // holds its query slice at 2 buf and its item slice at 2 buf + 1
    auto qs = [&](int buf) { return fwd_smem + (ns == 1 ? 0 : 2 * buf * BT * BLD); };
    auto xs = [&](int buf) { return fwd_smem + (ns == 1 ? 1 + buf : 2 * buf + 1) * BT * BLD; };
    const int stages = (t1 - t0) * ns;  // (item tile, d slice) in order
    auto issue = [&](int k) {
        const int t = t0 + k / ns, s = k % ns, buf = k & 1;
        if (ns > 1 || k == 0) stage_rows(qs(buf), a.q, a.b, q0, s * BK, a.d, vec);
        stage_rows(xs(buf), a.x, a.n, t * BT, s * BK, a.d, vec);
        cp_async_commit();
    };

    float m[4], sum[4];  // rows ty + 16 i over this thread's columns so far
#pragma unroll
    for (int i = 0; i < 4; ++i) m[i] = NEG_INF, sum[i] = 0.f;
    float acc[4][4];
    issue(0);
    for (int k = 0; k < stages; ++k) {
        if (k + 1 < stages) {
            issue(k + 1);
            cp_async_wait<1>();
        } else {
            cp_async_wait<0>();
        }
        __syncthreads();  // stage k is in
        const int t = t0 + k / ns, s = k % ns;
        if (s == 0) {
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
        }
        tile_scores(qs(k & 1), xs(k & 1), min(BK, a.d - s * BK), tx, ty, acc);
        __syncthreads();  // stage k's readers are done before it is refilled
        if (s != ns - 1) continue;
        // fold the tile's columns tx + 16 j into the running pairs
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            float sc[4];
            float tile_max = NEG_INF;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const bool valid = t * BT + tx + 16 * j < a.n;
                sc[j] = valid ? acc[i][j] / a.tau : NEG_INF;
                tile_max = fmaxf(tile_max, sc[j]);
            }
            const float new_m = fmaxf(m[i], tile_max);
            float add = 0.f;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                if (t * BT + tx + 16 * j < a.n) add += expf(sc[j] - new_m);
            }
            sum[i] = sum[i] * expf(m[i] - new_m) + add;
            m[i] = new_m;
        }
    }

    // the 16 threads of a row: a butterfly over the 8 lanes of each warp
    // (both partners compute the same merge, so every lane agrees), then
    // the odd warp's pair into the even warp's, through shared memory
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int off = 1; off < 8; off <<= 1) {
            const float om = __shfl_xor_sync(0xffffffffu, m[i], off);
            const float os = __shfl_xor_sync(0xffffffffu, sum[i], off);
            merge(m[i], sum[i], om, os);
        }
    }
    float* pair = fwd_smem;  // [BT][2]: the odd warps' pairs (every stage is read)
    const int warp = threadIdx.x / 32;
    const bool lead = threadIdx.x % 8 == 0;
    if (lead && warp % 2 == 1) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            pair[2 * (ty + 16 * i)] = m[i];
            pair[2 * (ty + 16 * i) + 1] = sum[i];
        }
    }
    __syncthreads();
    if (!lead || warp % 2 == 1) return;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int row = q0 + ty + 16 * i;
        merge(m[i], sum[i], pair[2 * (ty + 16 * i)], pair[2 * (ty + 16 * i) + 1]);
        if (row < a.b)
            reinterpret_cast<float2*>(a.part)[(size_t)split * a.b + row] = make_float2(m[i], sum[i]);
    }
}

// K5's second launch: lse[row] = m + log(s) of the row's split pairs merged
// in split order. One thread per query row.
__global__ void __launch_bounds__(BTHREADS) lse_fwd_combine_kernel(const Fwd a) {
    const int row = blockIdx.x * BTHREADS + threadIdx.x;
    if (row >= a.b) return;
    const float2* p = reinterpret_cast<const float2*>(a.part) + row;
    float2 first = __ldcg(p);
    float m = first.x, s = first.y;
    for (int t = 1; t < a.splits; ++t) {
        const float2 v = __ldcg(p + (size_t)t * a.b);
        merge(m, s, v.x, v.y);
    }
    a.lse[row] = m + logf(s);
}

// -- K6 -----------------------------------------------------------------------

// K6's column slabs: SLAB d-slices of output columns each
int bwd_slabs(int d) { return ((d + BK - 1) / BK + SLAB - 1) / SLAB; }

// Shared memory: d <= BK keeps the owned tile, two walked stages, p and the
// output accumulator ([BT][BLD] each); above, two stages of (owned slice,
// walked slice), p, and the slab's accumulator [BT][nso BK + 4], nso <= SLAB
// its slices.
size_t bwd_smem_bytes(int d) {
    const int ns = (d + BK - 1) / BK, nso = ns < SLAB ? ns : SLAB;
    const size_t tiles = ns == 1 ? 4 : 5;
    return (tiles * BT * BLD + static_cast<size_t>(BT) * (ns == 1 ? BLD : nso * BK + 4)) *
           sizeof(float);
}

struct Bwd {
    const float* q;
    const float* x;
    const float* lse;
    const float* g;
    int b, n, d;
    float tau;
    int wq, sq;      // query side: item tiles a block walks, and the splits of them
    int wx, sx;      // item side: query tiles a block walks, and the splits of them
    float* dq;
    float* dx;
    float* dq_part;  // [sq][B][d]
    float* dx_part;  // [sx][N][d]
    int vec;         // d % 4 == 0 and every pointer 16-byte aligned
};

// o[i][c] += sum_j p[ty + 16 i][j] * v[j][4 tx + c] for j < jmax (p is 0
// past the tile's valid columns), j in order, one FFMA each.
__device__ __forceinline__ void tile_product(const float* p, const float* v, int jmax, int tx,
                                             int ty, float (&o)[4][4]) {
    for (int j = 0; j < jmax; j += 4) {
        float4 pa[4], vb[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) pa[i] = *reinterpret_cast<const float4*>(p + (ty + 16 * i) * BLD + j);
#pragma unroll
        for (int t = 0; t < 4; ++t) vb[t] = *reinterpret_cast<const float4*>(v + (j + t) * BLD + 4 * tx);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const float w[4] = {pa[i].x, pa[i].y, pa[i].z, pa[i].w};
#pragma unroll
            for (int t = 0; t < 4; ++t) {
                o[i][0] = fmaf(w[t], vb[t].x, o[i][0]);
                o[i][1] = fmaf(w[t], vb[t].y, o[i][1]);
                o[i][2] = fmaf(w[t], vb[t].z, o[i][2]);
                o[i][3] = fmaf(w[t], vb[t].w, o[i][3]);
            }
        }
    }
}

// A block owns one 64-row tile of one side and walks one split of the other
// side's tiles: on the query side it owns query rows and walks item tiles
// (its partial dq), on the item side the reverse (its partial dx). For each
// walked tile it forms the 64 x 64 scores, p = exp(s / tau - lse) * g, and
// adds p . walked into its accumulator of the slab's columns (blockIdx.y),
// which it writes once at the end into its split's partial.
__global__ void __launch_bounds__(BTHREADS, 2) lse_bwd_kernel(const Bwd a) {
    extern __shared__ __align__(16) float bwd_smem[];
    const int ns = (a.d + BK - 1) / BK;  // d slices
    const int s0 = blockIdx.y * SLAB, nso = min(SLAB, ns - s0);  // the slab's output slices
    const int nq = (a.b + BT - 1) / BT, nx = (a.n + BT - 1) / BT;
    int bid = blockIdx.x;
    const bool qside = bid < nq * a.sq;
    if (!qside) bid -= nq * a.sq;
    const int n_own_tiles = qside ? nq : nx;
    const int own0 = (bid % n_own_tiles) * BT, split = bid / n_own_tiles;
    const float* own = qside ? a.q : a.x;
    const float* walk = qside ? a.x : a.q;
    const int n_own = qside ? a.b : a.n, n_walk = qside ? a.n : a.b;
    const int w = qside ? a.wq : a.wx;
    const int t0 = split * w, t1 = min(t0 + w, qside ? nx : nq);
    int tx, ty;
    tile_place(tx, ty);
    const bool vec = a.vec != 0;

    // d <= BK: the owned tile at 0, walked stages at 1, 2; above: stage buf
    // holds its owned slice at 2 buf and its walked slice at 2 buf + 1
    auto owns = [&](int buf) { return bwd_smem + (ns == 1 ? 0 : 2 * buf * BT * BLD); };
    auto walks = [&](int buf) { return bwd_smem + (ns == 1 ? 1 + buf : 2 * buf + 1) * BT * BLD; };
    float* ps = bwd_smem + (ns == 1 ? 3 : 4) * BT * BLD;  // p [owned][walked]
    float* out = ps + BT * BLD;                          // the accumulator
    const int old = ns == 1 ? BLD : nso * BK + 4;

    // a walked tile is one stage at d <= BK (scores and product share it);
    // above, ns scoring stages (both slices) then nso product stages (the
    // walked slice of the slab's columns again)
    const int per_tile = ns == 1 ? 1 : ns + nso;
    const int stages = (t1 - t0) * per_tile;
    auto issue = [&](int k) {
        const int t = t0 + k / per_tile, j = k % per_tile, buf = k & 1;
        const int s = j < ns ? j : s0 + j - ns;
        if (ns > 1 ? j < ns : k == 0) stage_rows(owns(buf), own, n_own, own0, s * BK, a.d, vec);
        stage_rows(walks(buf), walk, n_walk, t * BT, s * BK, a.d, vec);
        cp_async_commit();
    };

    // this thread's accumulator entries: rows ty + 16 i, columns
    // s BK + 4 tx .. + 3 of each of the slab's slices; no other thread
    // touches them
    for (int s = 0; s < nso; ++s)
#pragma unroll
        for (int i = 0; i < 4; ++i)
            *reinterpret_cast<float4*>(out + (ty + 16 * i) * old + s * BK + 4 * tx) =
                make_float4(0.f, 0.f, 0.f, 0.f);
    float own_l[4], own_g[4];  // the query side's rows' lse and g
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int row = own0 + ty + 16 * i;
        own_l[i] = qside && row < a.b ? a.lse[row] : 0.f;
        own_g[i] = qside && row < a.b ? a.g[row] : 0.f;
    }

    float acc[4][4];
    issue(0);
    for (int k = 0; k < stages; ++k) {
        if (k + 1 < stages) {
            issue(k + 1);
            cp_async_wait<1>();
        } else {
            cp_async_wait<0>();
        }
        __syncthreads();  // stage k is in
        const int t = t0 + k / per_tile, j = k % per_tile, buf = k & 1;
        const int walk0 = t * BT;
        if (j < ns) {
            if (j == 0) {
#pragma unroll
                for (int i = 0; i < 4; ++i)
#pragma unroll
                    for (int c = 0; c < 4; ++c) acc[i][c] = 0.f;
            }
            tile_scores(owns(buf), walks(buf), min(BK, a.d - j * BK), tx, ty, acc);
            if (j == ns - 1) {
                // p = exp(s / tau - lse) * g of the query row, 0 outside B x N
#pragma unroll
                for (int i = 0; i < 4; ++i) {
                    const bool row_ok = own0 + ty + 16 * i < n_own;
#pragma unroll
                    for (int c = 0; c < 4; ++c) {
                        const int col = walk0 + tx + 16 * c;
                        float v = 0.f;
                        if (row_ok && col < n_walk) {
                            const float l = qside ? own_l[i] : a.lse[col];
                            const float gg = qside ? own_g[i] : a.g[col];
                            v = expf(acc[i][c] / a.tau - l) * gg;
                        }
                        ps[(ty + 16 * i) * BLD + tx + 16 * c] = v;
                    }
                }
                __syncthreads();  // p is whole
            }
        }
        if (ns == 1 || j >= ns) {
            const int s = ns == 1 ? 0 : j - ns;  // the slab's slice
            float o[4][4];
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                const float4 v =
                    *reinterpret_cast<const float4*>(out + (ty + 16 * i) * old + s * BK + 4 * tx);
                o[i][0] = v.x, o[i][1] = v.y, o[i][2] = v.z, o[i][3] = v.w;
            }
            tile_product(ps, walks(buf), min(BT, n_walk - walk0), tx, ty, o);
#pragma unroll
            for (int i = 0; i < 4; ++i)
                *reinterpret_cast<float4*>(out + (ty + 16 * i) * old + s * BK + 4 * tx) =
                    make_float4(o[i][0], o[i][1], o[i][2], o[i][3]);
        }
        __syncthreads();  // stage k's readers (and p's) are done before either is refilled
    }

    // the split's partial: this thread's entries, rows below n_own, the
    // slab's columns below d
    float* part = (qside ? a.dq_part : a.dx_part) + (size_t)split * n_own * a.d;
    for (int s = 0; s < nso; ++s) {
        const int col = (s0 + s) * BK + 4 * tx;
        if (col >= a.d) continue;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const int row = own0 + ty + 16 * i;
            if (row >= n_own) continue;
            const float4 v =
                *reinterpret_cast<const float4*>(out + (ty + 16 * i) * old + s * BK + 4 * tx);
            float* dst = part + (size_t)row * a.d + col;
            if (vec) {
                *reinterpret_cast<float4*>(dst) = v;
            } else {
                const float e[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
                for (int c = 0; c < 4; ++c)
                    if (col + c < a.d) dst[c] = e[c];
            }
        }
    }
}

// The fixed-order combine, K6's second launch: dq[row] = (sum of the row's
// partials over the query side's splits, in split order) / tau, and dx
// likewise over the item side's. One thread per 4 outputs (per output
// where d % 4 != 0).
__global__ void __launch_bounds__(BTHREADS) lse_bwd_combine_kernel(const Bwd a) {
    const int w = a.vec ? 4 : 1;
    const long long per_row = a.d / w;
    const long long n_dq = (long long)a.b * per_row, n_all = n_dq + (long long)a.n * per_row;
    const long long e = (long long)blockIdx.x * BTHREADS + threadIdx.x;
    if (e >= n_all) return;
    const bool is_dq = e < n_dq;
    const long long off = (is_dq ? e : e - n_dq) * w;  // row * d + col
    const int n_parts = is_dq ? a.sq : a.sx;
    const float* p = (is_dq ? a.dq_part : a.dx_part) + off;
    const size_t stride = (size_t)(is_dq ? a.b : a.n) * a.d;
    float* out = (is_dq ? a.dq : a.dx) + off;
    if (w == 4) {
        float4 s = __ldcg(reinterpret_cast<const float4*>(p));
#pragma unroll 4
        for (int t = 1; t < n_parts; ++t) {
            const float4 v = __ldcg(reinterpret_cast<const float4*>(p + t * stride));
            s.x += v.x; s.y += v.y; s.z += v.z; s.w += v.w;
        }
        *reinterpret_cast<float4*>(out) = make_float4(s.x / a.tau, s.y / a.tau, s.z / a.tau,
                                                      s.w / a.tau);
    } else {
        float s = __ldcg(p);
#pragma unroll 4
        for (int t = 1; t < n_parts; ++t) s += __ldcg(p + t * stride);
        *out = s / a.tau;
    }
}

template <typename Kernel>
int prepare(Kernel kernel, size_t smem) {
    if (smem <= 48 * 1024) return 0;
    return static_cast<int>(cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem)));
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

}  // namespace

// Plain C interface for ctypes. Each call is one launch on the given stream;
// it returns the CUDA error code (0 on success). Sizes are at least 1; the
// wrapper checks them.

// The tile (BT rows of q and of x): the wrappers size K5's and K6's splits
// with it.
extern "C" int lse_tile() { return BT; }

// K6's column slabs at width d: its grid's second dimension.
extern "C" int lse_bwd_slabs(int d) { return bwd_slabs(d); }

// K5's blocks that one SM holds at once (0 if the runtime cannot say): the
// wrapper's plan fits one wave of lse_fwd_kernel from it.
extern "C" int lse_fwd_blocks_per_sm(int d) {
    const size_t smem = fwd_smem_bytes(d);
    int blocks = 0;
    if (prepare(lse_fwd_kernel, smem) != 0 ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, lse_fwd_kernel, BTHREADS, smem) !=
            cudaSuccess)
        return 0;
    return blocks;
}

// K5: lse [B], two launches: the (query tile, split) blocks, then the
// combine. part holds splits x B x 2 floats; splits = ceil(ceil(N / BT) / w).
extern "C" int lse_fwd_f32(const float* q, const float* x, int b, int n, int d, float tau, int w,
                           int splits, float* part, float* lse, void* stream) {
    const size_t smem = fwd_smem_bytes(d);
    if (int err = prepare(lse_fwd_kernel, smem)) return err;
    const bool vec = d % 4 == 0 && aligned16(q) && aligned16(x);
    const Fwd a{q, x, b, n, d, tau, w, splits, part, lse, vec ? 1 : 0};
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    lse_fwd_kernel<<<dim3(splits, (b + BT - 1) / BT), BTHREADS, smem, s>>>(a);
    if (cudaError_t err = cudaGetLastError()) return static_cast<int>(err);
    lse_fwd_combine_kernel<<<(b + BTHREADS - 1) / BTHREADS, BTHREADS, 0, s>>>(a);
    return static_cast<int>(cudaGetLastError());
}

// K6's blocks that one SM holds at once (0 if the runtime cannot say): the
// wrapper's plan sizes the splits to one wave from it. The shared memory is
// the slab's, the same at every d past SLAB slices.
extern "C" int lse_bwd_blocks_per_sm(int d) {
    const size_t smem = bwd_smem_bytes(d);
    int blocks = 0;
    if (prepare(lse_bwd_kernel, smem) != 0 ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, lse_bwd_kernel, BTHREADS, smem) !=
            cudaSuccess)
        return 0;
    return blocks;
}

// K6: dq [B, d] and dx [N, d], two launches: the two sides' split blocks
// (times the column slabs), then the combine. The query side's blocks walk
// wq item tiles in each of sq splits, the item side's wx query tiles in
// each of sx splits; dq_part holds sq x B x d floats and dx_part sx x N x d.
extern "C" int lse_bwd_f32(const float* q, const float* x, const float* lse, const float* g,
                           int b, int n, int d, float tau, int wq, int sq, int wx, int sx,
                           float* dq, float* dx, float* dq_part, float* dx_part, void* stream) {
    const size_t smem = bwd_smem_bytes(d);
    if (int err = prepare(lse_bwd_kernel, smem)) return err;
    const bool vec = d % 4 == 0 && aligned16(q) && aligned16(x) && aligned16(dq) &&
                     aligned16(dx) && aligned16(dq_part) && aligned16(dx_part);
    const Bwd a{q, x, lse, g, b, n, d, tau, wq, sq, wx, sx, dq, dx, dq_part, dx_part,
                vec ? 1 : 0};
    const int nq = (b + BT - 1) / BT, nx = (n + BT - 1) / BT;
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    lse_bwd_kernel<<<dim3(nq * sq + nx * sx, bwd_slabs(d)), BTHREADS, smem, s>>>(a);
    if (cudaError_t err = cudaGetLastError()) return static_cast<int>(err);
    const long long outs = (long long)(b + n) * (vec ? d / 4 : d);
    lse_bwd_combine_kernel<<<static_cast<unsigned>((outs + BTHREADS - 1) / BTHREADS), BTHREADS, 0,
                             s>>>(a);
    return static_cast<int>(cudaGetLastError());
}

extern "C" const char* lse_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}
