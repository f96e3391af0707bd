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
// order, so each block owns a tile of rows and loops over the other side
// itself, and the [B, N] scores never reach device memory:
//   * K5 (lse_fwd_kernel): a block owns TO query rows, stages them in
//     shared memory once, and loops over item tiles of TS rows staged
//     through shared memory. Each thread keeps the running (max, sum) of its
//     own 4 columns for its 2 rows in registers; warp shuffles combine the 16
//     threads of a row at the end into m + log(s).
//   * K6 is split as FlashAttention-2 splits its backward: one launch for dq
//     (lse_bwd_dq_kernel: a block owns TO query rows and loops over item
//     tiles) and one for dx (lse_bwd_dx_kernel: a block owns TO item rows
//     and loops over query tiles). Both recompute the scores. No atomics, so
//     every run gives the same result. A call of K6 is these two launches.
// The scores are f32 FFMA products (no TF32) divided by tau, as the JAX
// kernel divides. Ragged B, N and d are masked: a column past N adds
// exp(-1e30 - m) = 0 to the sum, i.e. it is skipped.
//
// What bounds them on an H100: at NCL's step shape (B = 2048, N = 943 or
// 1675, d = 64) K5 is 2BNd = 0.25 to 0.44 GFLOP of f32 FFMA, 4 to 7 us at
// 67 TFLOP/s, against under 1 MB of inputs (0.3 us at 3.35 TB/s): the
// operations bound it. K6 is three such products. This first version stages
// with plain loads and computes from shared memory with scalar FFMA (about
// six shared loads per eight FFMA in the score loop), so it is bound by
// shared-memory traffic and latency, far from the FFMA bound; tensor-core
// products (at TF32's precision cost) and double buffering are later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TO = 16;        // owned rows per block
constexpr int TS = 64;        // streamed rows per tile
constexpr int THREADS = 128;  // 16 column threads x 8 row pairs
constexpr float NEG_INF = -1e30f;

enum Mode { LSE = 0, DQ = 1, DX = 2 };

// Row stride of a staged [rows][d] tile: a multiple of 32 plus one, so
// that threads reading the same k of 16 consecutive rows hit 16 banks.
__host__ __device__ inline int padded_ld(int d) { return ((d + 31) / 32) * 32 + 1; }

size_t smem_bytes(int mode, int d) {
    const int ld = padded_ld(d);
    size_t n = (size_t)(TS + TO) * ld;  // streamed tile + owned tile
    if (mode != LSE) n += (size_t)TO * (TS + 1) + (size_t)TO * d;  // weights + accumulator
    return n * sizeof(float);
}

// LSE: own = q [n_own = B], str = x [n_str = N]; out = lse [B].
// DQ:  own = q, str = x; lse, g indexed by the owned row; out = dq [B, d].
// DX:  own = x, str = q; lse, g indexed by the streamed row; out = dx [N, d].
template <int MODE>
__device__ __forceinline__ void lse_body(const float* __restrict__ own,
                                         const float* __restrict__ str, int n_own, int n_str,
                                         int d, float tau, const float* __restrict__ lse,
                                         const float* __restrict__ g, float* __restrict__ out) {
    extern __shared__ float smem[];
    const int ld = padded_ld(d);
    float* ss = smem;                       // [TS][ld] streamed tile
    float* os = ss + TS * ld;               // [TO][ld] owned tile
    float* ps = os + TO * ld;               // [TO][TS + 1] p of this tile (DQ, DX)
    float* acc_s = ps + TO * (TS + 1);      // [TO][d] dq or dx of the owned rows (DQ, DX)

    const int tid = threadIdx.x;
    const int tx = tid % 16;  // streamed columns tx + 16 j, j = 0 .. 3
    const int ty = tid / 16;  // owned rows ty and ty + 8
    const int own0 = blockIdx.x * TO;

    for (int e = tid; e < TO * d; e += THREADS) {
        const int r = e / d, c = e % d, row = own0 + r;
        os[r * ld + c] = row < n_own ? own[(size_t)row * d + c] : 0.f;
        if (MODE != LSE) acc_s[e] = 0.f;
    }
    float m[2] = {NEG_INF, NEG_INF}, s[2] = {0.f, 0.f};
    float own_lse[2] = {0.f, 0.f}, own_g[2] = {0.f, 0.f};
    if (MODE == DQ) {
#pragma unroll
        for (int p = 0; p < 2; ++p) {
            const int row = own0 + ty + 8 * p;
            if (row < n_own) {
                own_lse[p] = lse[row];
                own_g[p] = g[row];
            }
        }
    }

    for (int s0 = 0; s0 < n_str; s0 += TS) {
        __syncthreads();  // the last tile's readers are done (and os is staged)
        for (int e = tid; e < TS * d; e += THREADS) {
            const int r = e / d, c = e % d, row = s0 + r;
            ss[r * ld + c] = row < n_str ? str[(size_t)row * d + c] : 0.f;
        }
        __syncthreads();

        float acc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
        for (int k = 0; k < d; ++k) {
            const float a0 = os[ty * ld + k];
            const float a1 = os[(ty + 8) * ld + k];
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const float b = ss[(tx + 16 * j) * ld + k];
                acc[0][j] = fmaf(a0, b, acc[0][j]);
                acc[1][j] = fmaf(a1, b, acc[1][j]);
            }
        }

        if (MODE == LSE) {
#pragma unroll
            for (int p = 0; p < 2; ++p) {
                float sc[4];
                float tile_max = NEG_INF;
#pragma unroll
                for (int j = 0; j < 4; ++j) {
                    const bool valid = s0 + tx + 16 * j < n_str;
                    sc[j] = valid ? acc[p][j] / tau : NEG_INF;
                    tile_max = fmaxf(tile_max, sc[j]);
                }
                const float new_m = fmaxf(m[p], tile_max);
                float add = 0.f;
#pragma unroll
                for (int j = 0; j < 4; ++j) {
                    if (s0 + tx + 16 * j < n_str) add += expf(sc[j] - new_m);
                }
                s[p] = s[p] * expf(m[p] - new_m) + add;
                m[p] = new_m;
            }
        } else {
#pragma unroll
            for (int p = 0; p < 2; ++p) {
                const int r_loc = ty + 8 * p;
#pragma unroll
                for (int j = 0; j < 4; ++j) {
                    const int c_loc = tx + 16 * j;
                    const int col = s0 + c_loc;
                    float w = 0.f;
                    if (col < n_str && own0 + r_loc < n_own) {
                        const float l = MODE == DQ ? own_lse[p] : lse[col];
                        const float gg = MODE == DQ ? own_g[p] : g[col];
                        w = expf(acc[p][j] / tau - l) * gg;
                    }
                    ps[r_loc * (TS + 1) + c_loc] = w;
                }
            }
            __syncthreads();
            // out[r][c] += sum_j p[r][j] * str[j][c]; each entry has one owner
            for (int e = tid; e < TO * d; e += THREADS) {
                const int r = e / d, c = e % d;
                float a = 0.f;
                for (int j = 0; j < TS; ++j) a = fmaf(ps[r * (TS + 1) + j], ss[j * ld + c], a);
                acc_s[e] += a;
            }
        }
    }

    if (MODE == LSE) {
#pragma unroll
        for (int p = 0; p < 2; ++p) {
            float mm = m[p], sum = s[p];
            // the 16 threads of a row are one half warp
#pragma unroll
            for (int off = 8; off > 0; off >>= 1) {
                const float om = __shfl_xor_sync(0xffffffffu, mm, off);
                const float os_ = __shfl_xor_sync(0xffffffffu, sum, off);
                const float nm = fmaxf(mm, om);
                sum = sum * expf(mm - nm) + os_ * expf(om - nm);
                mm = nm;
            }
            const int row = own0 + ty + 8 * p;
            if (tx == 0 && row < n_own) out[row] = mm + logf(sum);
        }
    } else {
        for (int e = tid; e < TO * d; e += THREADS) {
            const int row = own0 + e / d;
            if (row < n_own) out[(size_t)row * d + e % d] = acc_s[e] / tau;
        }
    }
}

__global__ void __launch_bounds__(THREADS)
lse_fwd_kernel(const float* __restrict__ q, const float* __restrict__ x, int b, int n, int d,
               float tau, float* __restrict__ lse) {
    lse_body<LSE>(q, x, b, n, d, tau, nullptr, nullptr, lse);
}

__global__ void __launch_bounds__(THREADS)
lse_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ x,
                  const float* __restrict__ lse, const float* __restrict__ g, int b, int n,
                  int d, float tau, float* __restrict__ dq) {
    lse_body<DQ>(q, x, b, n, d, tau, lse, g, dq);
}

__global__ void __launch_bounds__(THREADS)
lse_bwd_dx_kernel(const float* __restrict__ q, const float* __restrict__ x,
                  const float* __restrict__ lse, const float* __restrict__ g, int b, int n,
                  int d, float tau, float* __restrict__ dx) {
    lse_body<DX>(x, q, n, b, d, tau, lse, g, dx);
}

template <typename Kernel>
int prepare(Kernel kernel, size_t smem) {
    if (smem <= 48 * 1024) return 0;
    return static_cast<int>(cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem)));
}

}  // namespace

// Plain C interface for ctypes. Each call is one launch on the given stream;
// it returns the CUDA error code (0 on success). Sizes are at least 1 and d
// at most lse_max_d(); the wrapper checks both.
extern "C" int lse_max_d() { return 512; }

extern "C" int lse_fwd_f32(const float* q, const float* x, int b, int n, int d, float tau,
                           float* lse, void* stream) {
    const size_t smem = smem_bytes(LSE, d);
    if (int err = prepare(lse_fwd_kernel, smem)) return err;
    lse_fwd_kernel<<<(b + TO - 1) / TO, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
        q, x, b, n, d, tau, lse);
    return static_cast<int>(cudaGetLastError());
}

extern "C" int lse_bwd_dq_f32(const float* q, const float* x, const float* lse,
                              const float* g, int b, int n, int d, float tau, float* dq,
                              void* stream) {
    const size_t smem = smem_bytes(DQ, d);
    if (int err = prepare(lse_bwd_dq_kernel, smem)) return err;
    lse_bwd_dq_kernel<<<(b + TO - 1) / TO, THREADS, smem,
                        static_cast<cudaStream_t>(stream)>>>(q, x, lse, g, b, n, d, tau, dq);
    return static_cast<int>(cudaGetLastError());
}

extern "C" int lse_bwd_dx_f32(const float* q, const float* x, const float* lse,
                              const float* g, int b, int n, int d, float tau, float* dx,
                              void* stream) {
    const size_t smem = smem_bytes(DX, d);
    if (int err = prepare(lse_bwd_dx_kernel, smem)) return err;
    lse_bwd_dx_kernel<<<(n + TO - 1) / TO, THREADS, smem,
                        static_cast<cudaStream_t>(stream)>>>(q, x, lse, g, b, n, d, tau, dx);
    return static_cast<int>(cudaGetLastError());
}

extern "C" const char* lse_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}
