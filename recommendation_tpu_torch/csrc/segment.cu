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
// x [N, H, D] and y [R, H, D] are rows of width H*D; w [S, H]. It is P1's
// pull (csrc/gather.cu) with a weight per head: P1's work list
// (ops/gather.py::pull_schedule) gives one item per row and one per
// CHUNK-slot piece of a longer row, so the hub rows of a power-law graph
// do not hold the launch up. A group of lanes (16 where the row is at most
// 16 16-byte loads wide, else a warp) walks an item's slots in order, each
// lane summing its VEC columns; a split row's pieces write partial sums
// that the group finishing the row's last piece adds in piece order (an
// integer counter per row, zeroed on the stream ahead of the launch, is the
// only atomic). Bound: bytes, the distinct source rows gathered (L2 serves
// a row's later gathers) and y written.
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
// S3, the per-slot head dot (ops/segment.py::segment_dot), S1's weight
// gradient, a gather and a dot with no scatter:
//
//     out[s, h] = sum_k a[ia[s], h, k] * b[ib[s], h, k]
//
// 16 lanes per (slot, head) pair, VEC columns each, then an xor tree.
// Bound: bytes, the distinct rows of a and b read and out written.
//
// Every product and sum is rounded once (no FMA contraction), as the plain
// versions' separate operations are.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int THREADS = 256;
constexpr int UNROLL = 4;  // source rows in flight per group

template <int VEC>
__device__ __forceinline__ void load_row(const float* p, float (&v)[VEC]) {
    if constexpr (VEC % 4 == 0) {
#pragma unroll
        for (int k = 0; k < VEC; k += 4) {
            const float4 t = __ldg(reinterpret_cast<const float4*>(p + k));
            v[k] = t.x; v[k + 1] = t.y; v[k + 2] = t.z; v[k + 3] = t.w;
        }
    } else {
#pragma unroll
        for (int k = 0; k < VEC; ++k) v[k] = __ldg(p + k);
    }
}

// partial sums written by other warps: through L2, past L1
template <int VEC>
__device__ __forceinline__ void load_partial(const float* p, float (&v)[VEC]) {
    if constexpr (VEC % 4 == 0) {
#pragma unroll
        for (int k = 0; k < VEC; k += 4) {
            const float4 t = __ldcg(reinterpret_cast<const float4*>(p + k));
            v[k] = t.x; v[k + 1] = t.y; v[k + 2] = t.z; v[k + 3] = t.w;
        }
    } else {
#pragma unroll
        for (int k = 0; k < VEC; ++k) v[k] = __ldcg(p + k);
    }
}

template <int VEC>
__device__ __forceinline__ void store_row(float* o, const float (&v)[VEC]) {
    if constexpr (VEC % 4 == 0) {
#pragma unroll
        for (int k = 0; k < VEC; k += 4)
            *reinterpret_cast<float4*>(o + k) = make_float4(v[k], v[k + 1], v[k + 2], v[k + 3]);
    } else {
#pragma unroll
        for (int k = 0; k < VEC; ++k) o[k] = v[k];
    }
}

struct Pull {  // one S1 call's operands (partial and count null when no row is split)
    const float* x;
    const float* w;
    const int* idx;
    const int4* work;             // [n_work] (row, piece, the row's first partial, the row's pieces)
    const long long* work_start;  // [n_work + 1] each item's first slot
    int n_work;
    int heads;
    int d_head;
    float* partial;
    int* count;
    float* out;
};

template <int VEC, int LANES>
__global__ void __launch_bounds__(THREADS)
weighted_pull_kernel(const Pull a) {
    const int lane = threadIdx.x & 31, l = lane % LANES;
    const unsigned gmask = LANES == 32 ? FULL : ((1u << LANES) - 1) << (lane / LANES * LANES);
    constexpr int GROUPS = THREADS / LANES;
    const int width = a.heads * a.d_head;
    const int nvec = width / VEC;
    const long long n_groups = static_cast<long long>(gridDim.x) * GROUPS;
    for (long long item = static_cast<long long>(blockIdx.x) * GROUPS + threadIdx.x / LANES;
         item < a.n_work; item += n_groups) {
        const int4 wk = a.work[item];
        const int r = wk.x, piece = wk.y, part = wk.z, pieces = wk.w;
        const long long s0 = a.work_start[item], s1 = a.work_start[item + 1];
        for (int c0 = 0; c0 < nvec; c0 += LANES) {
            const int cv = c0 + l;
            if (cv >= nvec) break;
            const int col = cv * VEC;
            const int h = col / a.d_head;  // VEC divides d_head: a lane's columns share a head
            float acc[VEC];
#pragma unroll
            for (int q = 0; q < VEC; ++q) acc[q] = 0.f;
            for (long long s = s0; s < s1; s += UNROLL) {
                float v[UNROLL][VEC];
                float wt[UNROLL];
#pragma unroll
                for (int u = 0; u < UNROLL; ++u) {
                    const long long ss = s + u;
                    wt[u] = 0.f;
                    if (ss < s1) {
                        const int src = __ldg(a.idx + ss);
                        wt[u] = __ldg(a.w + ss * a.heads + h);
                        load_row<VEC>(a.x + static_cast<size_t>(src) * width + col, v[u]);
                    }
                }
#pragma unroll
                for (int u = 0; u < UNROLL; ++u) {
                    if (s + u >= s1) break;
#pragma unroll
                    for (int q = 0; q < VEC; ++q) acc[q] = __fadd_rn(acc[q], __fmul_rn(wt[u], v[u][q]));
                }
            }
            float* dst = pieces == 1 ? a.out + static_cast<size_t>(r) * width
                                     : a.partial + static_cast<size_t>(part + piece) * width;
            store_row<VEC>(dst + col, acc);
        }
        if (pieces > 1) {
            // a split row: the group that finishes its last piece adds the
            // pieces' partial sums in piece order; every lane's partial is
            // fenced before the count moves
            __threadfence();
            __syncwarp(gmask);
            int done = 0;
            if (l == 0) done = atomicAdd(a.count + part, 1);
            done = __shfl_sync(gmask, done, lane / LANES * LANES);
            if (done == pieces - 1) {
                __threadfence();
                for (int c0 = 0; c0 < nvec; c0 += LANES) {
                    const int cv = c0 + l;
                    if (cv >= nvec) break;
                    const int col = cv * VEC;
                    float acc[VEC], p[VEC];
                    load_partial<VEC>(a.partial + static_cast<size_t>(part) * width + col, acc);
                    for (int c = 1; c < pieces; ++c) {
                        load_partial<VEC>(a.partial + static_cast<size_t>(part + c) * width + col, p);
#pragma unroll
                        for (int q = 0; q < VEC; ++q) acc[q] = __fadd_rn(acc[q], p[q]);
                    }
                    store_row<VEC>(a.out + static_cast<size_t>(r) * width + col, acc);
                }
            }
            __syncwarp(gmask);
        }
    }
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

template <int VEC>
__global__ void __launch_bounds__(THREADS)
segment_dot_kernel(const float* __restrict__ a, const int* __restrict__ ia,
                   const float* __restrict__ b, const int* __restrict__ ib, long long n_slots,
                   int heads, int d_head, float* __restrict__ out) {
    constexpr int LANES = 16;
    const int lane = threadIdx.x & 31, l = lane % LANES;
    const long long n_pairs = n_slots * heads;
    const long long warp = (static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x) >> 5;
    const long long n_warps = (static_cast<long long>(gridDim.x) * THREADS) >> 5;
    // the loop runs per warp, so both halves reach every shuffle
    for (long long base = warp * 2; base < n_pairs; base += n_warps * 2) {
        const long long pair = base + lane / LANES;
        float acc = 0.f;
        if (pair < n_pairs) {
            const long long s = pair / heads;
            const int h = static_cast<int>(pair - s * heads);
            const float* pa = a + (static_cast<size_t>(__ldg(ia + s)) * heads + h) * d_head;
            const float* pb = b + (static_cast<size_t>(__ldg(ib + s)) * heads + h) * d_head;
            for (int k = l * VEC; k < d_head; k += LANES * VEC) {
                float va[VEC], vb[VEC];
                load_row<VEC>(pa + k, va);
                load_row<VEC>(pb + k, vb);
#pragma unroll
                for (int q = 0; q < VEC; ++q) acc = __fadd_rn(acc, __fmul_rn(va[q], vb[q]));
            }
        }
#pragma unroll
        for (int o = LANES / 2; o >= 1; o >>= 1) acc = __fadd_rn(acc, __shfl_xor_sync(FULL, acc, o));
        if (pair < n_pairs && l == 0) out[pair] = acc;
    }
}

bool aligned16(const void* p) { return p == nullptr || (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

unsigned blocks_for(long long units, long long per_block) {
    long long blocks = (units + per_block - 1) / per_block;
    if (blocks > (1LL << 20)) blocks = 1LL << 20;  // the rest by the grid-stride loops
    return static_cast<unsigned>(blocks < 1 ? 1 : blocks);
}

template <int VEC, int LANES>
int launch_pull(const Pull& a, cudaStream_t stream) {
    weighted_pull_kernel<VEC, LANES><<<blocks_for(a.n_work, THREADS / LANES), THREADS, 0, stream>>>(a);
    return static_cast<int>(cudaGetLastError());
}

template <int VEC>
int dispatch_pull(const Pull& a, cudaStream_t stream) {
    return a.heads * a.d_head / VEC <= 16 ? launch_pull<VEC, 16>(a, stream)
                                          : launch_pull<VEC, 32>(a, stream);
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
                 partial, count, out};
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (n_partials > 0) {
        if (cudaError_t err = cudaMemsetAsync(count, 0, sizeof(int) * n_partials, s))
            return static_cast<int>(err);
    }
    const bool vec4 = d_head % 4 == 0 && aligned16(x) && aligned16(partial) && aligned16(out);
    return vec4 ? dispatch_pull<4>(a, s) : dispatch_pull<1>(a, s);
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

// S3: out [n_slots, heads] from a [*, heads, d_head] rows ia and b rows ib.
extern "C" int segment_dot(const float* a, const int* ia, const float* b, const int* ib,
                           long long n_slots, int heads, int d_head, float* out, void* stream) {
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    const unsigned blocks = blocks_for(n_slots * heads, THREADS / 16);
    if (d_head % 4 == 0 && aligned16(a) && aligned16(b))
        segment_dot_kernel<4><<<blocks, THREADS, 0, s>>>(a, ia, b, ib, n_slots, heads, d_head, out);
    else
        segment_dot_kernel<1><<<blocks, THREADS, 0, s>>>(a, ia, b, ib, n_slots, heads, d_head, out);
    return static_cast<int>(cudaGetLastError());
}

extern "C" const char* segment_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}
