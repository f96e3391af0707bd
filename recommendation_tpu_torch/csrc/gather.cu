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
// sum over cap. Here every bucket is one flat table of slot indices with a
// row pointer, and one launch computes
//
//     out[r, :] = post[r] * sum_{s in [row_ptr[r], row_ptr[r+1])} val[s] * (src[idx[s], :] + add[idx[s], :])
//
// for every row r < n_out, in f32, with `val`, `post` and `add` optional and
// `src` f32 or bf16 (widened exactly). Slots whose index equals `skip` are
// left out: the caller passes the row that is zero in `src` and `add` (the
// row-space zero row), so leaving them out changes no sum. What bounds it:
// bytes again, per slot its index (and value) and its source row, plus the
// [n_out, d] output. Design: a warp per work item, and a work item is a row
// or, for a row of more than CHUNK slots, a CHUNK-slot piece of it (a
// power-law graph's hub rows hold 10^4 slots, and a warp per row left the
// launch waiting on them: 1.2 ms for a layer whose bytes take 0.15 ms on an
// H100). The warp reads 32 slot indices (and values) at once, coalesced, and
// broadcasts them with shuffles; lanes run across d with 16-byte loads, and
// where a row needs fewer than 32 lanes (d = 64 in f32 needs 16) the warp
// splits into groups that take alternate slots, four slots a group in
// flight; partial sums stay in registers and the groups combine by shuffles.
// A split row's pieces write their partial sums to scratch; the warp that
// finishes the row's last piece (a counter per row, after a memory fence)
// adds them in piece order. Every float sum has a fixed order whichever warp
// finishes last, so a call repeats bit for bit; the only atomic is the
// integer counter. The products and sums are rounded separately (no FMA),
// as the plain version's gather, multiply and sum are.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int WARPS = 8;   // warps per block
constexpr int UNROLL = 4;  // slots in flight per group of lanes
constexpr int CHUNK = 128; // slots per work item of a split row (ops/gather.py::CHUNK)

// VEC consecutive elements of a row, widened to f32: 16-byte loads where
// VEC fills them, else one element at a time
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

// VEC f32 partial sums written by other warps: through L2, past L1
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
__device__ __forceinline__ void store_row(float* o, const float (&acc)[VEC], float scale) {
    if constexpr (VEC % 4 == 0) {
#pragma unroll
        for (int k = 0; k < VEC; k += 4)
            *reinterpret_cast<float4*>(o + k) =
                make_float4(__fmul_rn(acc[k], scale), __fmul_rn(acc[k + 1], scale),
                            __fmul_rn(acc[k + 2], scale), __fmul_rn(acc[k + 3], scale));
    } else {
#pragma unroll
        for (int k = 0; k < VEC; ++k) o[k] = __fmul_rn(acc[k], scale);
    }
}

template <typename T, int VEC, bool HAS_VAL, bool HAS_ADD>
__global__ void __launch_bounds__(WARPS * 32)
gather_sum_kernel(const T* __restrict__ src, const float* __restrict__ add,
                  const int* __restrict__ idx, const long long* __restrict__ row_ptr,
                  const int4* __restrict__ work, int n_work, const float* __restrict__ val,
                  const float* __restrict__ post, int d, int lanes, int skip,
                  float* __restrict__ partial, int* __restrict__ count, float* __restrict__ out) {
    const int lane = threadIdx.x & 31;
    const int w = blockIdx.x * WARPS + (threadIdx.x >> 5);
    if (w >= n_work) return;  // the whole warp
    // row, piece, the row's first partial (split rows), the row's pieces
    const int4 wk = work[w];
    const int r = wk.x, piece = wk.y, part = wk.z, pieces = wk.w;
    const int groups = 32 / lanes;
    const int g = lane / lanes, l = lane % lanes;
    const long long start = row_ptr[r] + static_cast<long long>(piece) * CHUNK;
    const long long end = pieces == 1 ? row_ptr[r + 1]
                                      : min(start + CHUNK, static_cast<long long>(row_ptr[r + 1]));
    const int nvec = d / VEC;
    const float scale = post != nullptr ? post[r] : 1.f;

    for (int c0 = 0; c0 < nvec; c0 += lanes) {
        const int cv = c0 + l;
        const bool col_ok = cv < nvec;
        const size_t col = static_cast<size_t>(cv) * VEC;
        float acc[VEC];
#pragma unroll
        for (int k = 0; k < VEC; ++k) acc[k] = 0.f;

        for (long long base = start; base < end; base += 32) {
            const int n = static_cast<int>(end - base < 32 ? end - base : 32);
            const int my_idx = lane < n ? idx[base + lane] : skip;
            const float my_val = HAS_VAL && lane < n ? val[base + lane] : 0.f;
            for (int j = 0; j < n; j += groups * UNROLL) {
                float v[UNROLL][VEC];
                float wt[UNROLL];
                bool ok[UNROLL];
#pragma unroll
                for (int u = 0; u < UNROLL; ++u) {
                    const int jj = j + u * groups + g;
                    const int s = __shfl_sync(FULL, my_idx, jj & 31);
                    wt[u] = HAS_VAL ? __shfl_sync(FULL, my_val, jj & 31) : 1.f;
                    ok[u] = jj < n && s != skip && col_ok;
                    if (ok[u]) {
                        const size_t off = static_cast<size_t>(s) * d + col;
                        load_row<VEC>(src + off, v[u]);
                        if constexpr (HAS_ADD) {
                            float a[VEC];
                            load_row<VEC>(add + off, a);
#pragma unroll
                            for (int k = 0; k < VEC; ++k) v[u][k] = __fadd_rn(v[u][k], a[k]);
                        }
                    }
                }
#pragma unroll
                for (int u = 0; u < UNROLL; ++u) {
                    if (!ok[u]) continue;
#pragma unroll
                    for (int k = 0; k < VEC; ++k)
                        acc[k] = __fadd_rn(acc[k], HAS_VAL ? __fmul_rn(wt[u], v[u][k]) : v[u][k]);
                }
            }
        }
        // combine the groups: a fixed butterfly, so the order is the same every call
        for (int off = lanes; off < 32; off <<= 1) {
#pragma unroll
            for (int k = 0; k < VEC; ++k) acc[k] = __fadd_rn(acc[k], __shfl_xor_sync(FULL, acc[k], off));
        }
        if (g == 0 && col_ok) {
            if (pieces == 1)
                store_row<VEC>(out + static_cast<size_t>(r) * d + col, acc, scale);
            else
                store_row<VEC>(partial + static_cast<size_t>(part + piece) * d + col, acc, 1.f);
        }
    }
    if (pieces == 1) return;

    // a split row: the warp that finishes its last piece adds the pieces'
    // partial sums in piece order; every lane's partial is fenced before the
    // count moves
    __threadfence();
    __syncwarp();
    int done = 0;
    if (lane == 0) done = atomicAdd(count + part, 1);
    done = __shfl_sync(FULL, done, 0);
    if (done != pieces - 1) return;
    __threadfence();
    if (g != 0) return;
    for (int c0 = 0; c0 < nvec; c0 += lanes) {
        const int cv = c0 + l;
        if (cv >= nvec) break;
        const size_t col = static_cast<size_t>(cv) * VEC;
        float acc[VEC], p[VEC];
        load_partial<VEC>(partial + static_cast<size_t>(part) * d + col, acc);
        for (int c = 1; c < pieces; ++c) {
            load_partial<VEC>(partial + static_cast<size_t>(part + c) * d + col, p);
#pragma unroll
            for (int k = 0; k < VEC; ++k) acc[k] = __fadd_rn(acc[k], p[k]);
        }
        store_row<VEC>(out + static_cast<size_t>(r) * d + col, acc, scale);
    }
}

// lanes across d: the smallest power of two that covers d / VEC, at most 32
int lanes_for(int nvec) {
    int lanes = 1;
    while (lanes < nvec && lanes < 32) lanes <<= 1;
    return lanes;
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

struct Sum {  // one P1 call's operands (add, val, post, partial, count may be null)
    const float* add;
    const int* idx;
    const long long* row_ptr;
    const int4* work;
    int n_work;
    const float* val;
    const float* post;
    int d;
    int skip;
    float* partial;
    int* count;
    float* out;
};

template <typename T, int VEC, bool HAS_VAL, bool HAS_ADD>
int launch_sum(const T* src, const Sum& a, cudaStream_t stream) {
    const int blocks = (a.n_work + WARPS - 1) / WARPS;
    gather_sum_kernel<T, VEC, HAS_VAL, HAS_ADD><<<blocks, WARPS * 32, 0, stream>>>(
        src, a.add, a.idx, a.row_ptr, a.work, a.n_work, a.val, a.post, a.d, lanes_for(a.d / VEC),
        a.skip, a.partial, a.count, a.out);
    return static_cast<int>(cudaGetLastError());
}

template <typename T, int VEC>
int dispatch_sum(const T* src, const Sum& a, cudaStream_t stream) {
    if constexpr (std::is_same<T, float>::value) {  // a second source is f32-only
        if (a.add != nullptr) {
            return a.val != nullptr ? launch_sum<T, VEC, true, true>(src, a, stream)
                                    : launch_sum<T, VEC, false, true>(src, a, stream);
        }
    }
    return a.val != nullptr ? launch_sum<T, VEC, true, false>(src, a, stream)
                            : launch_sum<T, VEC, false, false>(src, a, stream);
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

// P1 with an f32 source. work is i32 [n_work, 4] (ops/gather.py::pull_schedule);
// partial is f32 [n_partials, d] scratch and count i32 [n_partials] zeros,
// both null when no row is split; add, val and post may be null.
extern "C" int gather_sum_f32(const float* src, const float* add, const int* idx,
                              const long long* row_ptr, const int* work, int n_work,
                              const float* val, const float* post, int d, int skip,
                              float* partial, int* count, float* out, void* stream) {
    const Sum a{add, idx, row_ptr, reinterpret_cast<const int4*>(work), n_work, val, post, d,
                skip, partial, count, out};
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    const bool vec = d % 4 == 0 && aligned16(src) && aligned16(out) &&
                     (add == nullptr || aligned16(add)) && (partial == nullptr || aligned16(partial));
    return vec ? dispatch_sum<float, 4>(src, a, s) : dispatch_sum<float, 1>(src, a, s);
}

// P1 with a bf16 source (its bits as uint16); the rest as gather_sum_f32, no add.
extern "C" int gather_sum_bf16(const uint16_t* src, const int* idx, const long long* row_ptr,
                               const int* work, int n_work, const float* val, const float* post,
                               int d, int skip, float* partial, int* count, float* out,
                               void* stream) {
    const Sum a{nullptr, idx, row_ptr, reinterpret_cast<const int4*>(work), n_work, val, post, d,
                skip, partial, count, out};
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    const bool vec = d % 8 == 0 && aligned16(src) && aligned16(out) &&
                     (partial == nullptr || aligned16(partial));
    return vec ? dispatch_sum<uint16_t, 8>(src, a, s) : dispatch_sum<uint16_t, 1>(src, a, s);
}

extern "C" const char* gather_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}
