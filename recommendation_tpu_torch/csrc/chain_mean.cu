// One layer of the dense bipartite LightGCN chain, forward (K1) and
// backward (K2), and the same with a layer snapshot (K3) and a layer-k
// cotangent injection (K4), on Hopper (sm_90a).
//
// K1 replaces the forward of the Pallas kernel
// recommendation_tpu/ops/pallas_prop.py::_chain_kernel (forward=True), which
// computes, with R̂ resident in VMEM for the whole chain,
//
//     u_{k+1} = R̂ · i_k ;  i_{k+1} = R̂ᵀ · u_k          (k = 0 .. L-1)
//     out     = mean(layers 0 .. L)
//
// with f32 accumulation and, when R̂ is bf16, the running table rounded to
// bf16 right before each product.
//
// K2 replaces the same Pallas kernel's backward (forward=False, reached
// through _chain_bwd, pallas_prop.py:178-189): with the cotangents
// prescaled by the wrapper to su = gu/(L+1), si = gi/(L+1), L rounds of the
// Horner chain
//
//     au' = su + R̂ · cast(ai) ;  ai' = si + R̂ᵀ · cast(au)   (au = su, ai = si)
//
// both from the OLD au, ai. It is the same two products per round as K1,
// so it shares K1's templated body and differs in the epilogue only:
// dst = seed + acc, written to a fresh buffer (never in place: au' needs
// the old ai and ai' the old au).
//
// What bounds them on an H100: at the serving shape (943 x 1676, d = 64,
// L = 3) the chain is 1.21 GFLOP. In bf16 it reads R̂ (3.16 MB) and the
// tables (about 1.3 MB) once: about 1.3 us at 3.35 TB/s, so the bytes
// bound it. In f32 it is about 18 us of FFMA at 67 TFLOP/s, so the
// operations bound it. K2 does the same work as K1.
//
// What this design does about it: R̂ (at most a few MB on the dense backend)
// does not fit one SM's shared memory, but it does fit the 50 MB L2, so each
// layer is one launch that reads R̂ through L2 instead of keeping it on chip.
// One launch computes both halves of a layer: blocks [0, nbu) tile the U
// rows of u_new = R̂·i, blocks [nbu, nbu + nbi) tile the I rows of
// i_new = R̂ᵀ·u. Both halves read the OLD tables and write new buffers, so
// the order of updates does not matter. A block stages a 32-deep slice of R̂
// and of the source table in shared memory per step; R̂ is always loaded
// along its rows (coalesced), and the R̂ᵀ side reads the staged tile across.
// Products are FFMA in f32 (a bf16 x bf16 product is exact in f32, so this
// equals preferred_element_type=f32; no TF32). K1's epilogue folds the
// layer-mean readout: acc_out = (acc_in + new) * scale, where scale is 1 on
// all but the last layer and 1/(L+1) on the last, the same operations in the
// same order as the plain chain. Ragged edges are masked; nothing is padded.
// wgmma, TMA and a persistent chain are later work, for K1 and K2 together.
//
// K3 replaces pallas_prop.py::_chain_layer_fwd_kernel (:203-237, NCL's
// forward): K1's chain that also returns layer k's tables (1 <= k <= L).
// A layer is one launch here, so layer k writes its new tables straight into
// the snapshot buffers uk/ik (which the next layer then reads); that includes
// k = L, where K1 skips the write. K3 is K1's body under its own kernel name
// (chain_layer_snap_kernel) and its own C entry points.
//
// K4 replaces pallas_prop.py::_chain_layer_bwd_kernel (:240-272, wrapper
// _chain_layer_bwd :317-329): K2's rounds j = L-1 .. 0 with layer k's
// cotangent added after round j == k. It is K2's body with one more
// epilogue operand: dst = seed + acc + inj, summed in that order (as the JAX
// kernel's (gu + mm) + gku), with inj null on every round but j == k. The
// k = L injection and the 1/(L+1) prescale of the mean's cotangent happen in
// the wrapper, before the first round. K3 and K4 do K1's and K2's work plus
// one more [U+I, d] table written (K3) or read (K4).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TM = 16;       // output rows per block
constexpr int TK = 32;       // reduction depth staged per step
constexpr int TD = 64;       // output columns per block (gridDim.y covers d)
constexpr int THREADS = 128; // 16 column groups of 4 x 8 row pairs

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

// The running table as the product sees it: rounded to R̂'s type
// (round to nearest even, as jnp.astype) and widened back for the FFMA.
__device__ __forceinline__ float as_operand(float x, float) { return x; }
__device__ __forceinline__ float as_operand(float x, __nv_bfloat16) {
    return __bfloat162float(__float2bfloat16_rn(x));
}

// BWD selects the epilogue: false is K1's (and K3's) readout, true is K2's
// dst = seed + acc (seed passed as acc_in; acc_out, scale, write_next unused).
// INJ adds K4's operand: dst = seed + acc + inj wherever inj is not null.
template <typename T, bool BWD, bool INJ>
__device__ __forceinline__ void
chain_layer_body(const T* __restrict__ r, const float* __restrict__ src_u,
                 const float* __restrict__ src_i, float* __restrict__ dst_u,
                 float* __restrict__ dst_i, const float* acc_in_u,
                 const float* acc_in_i, float* acc_out_u, float* acc_out_i,
                 const float* inj_u, const float* inj_i,
                 int n_users, int n_items, int d, float scale, int write_next) {
    // As[kk][row]: R̂ slice, always indexed (reduction step, output row).
    __shared__ float As[TK][TM + 1];
    __shared__ __align__(16) float Bs[TK][TD];

    const int nbu = (n_users + TM - 1) / TM;
    const bool user_side = blockIdx.x < nbu;
    // user side: out = R̂ · src_i over U rows, reduction over I
    // item side: out = R̂ᵀ · src_u over I rows, reduction over U
    const int row0 = (user_side ? blockIdx.x : blockIdx.x - nbu) * TM;
    const int n_out = user_side ? n_users : n_items;
    const int n_red = user_side ? n_items : n_users;
    const float* src = user_side ? src_i : src_u;
    float* dst = user_side ? dst_u : dst_i;
    const float* acc_in = user_side ? acc_in_u : acc_in_i;
    float* acc_out = user_side ? acc_out_u : acc_out_i;
    const float* inj = user_side ? inj_u : inj_i;

    const int col0 = blockIdx.y * TD;
    const int tid = threadIdx.x;
    const int tx = tid % 16;  // columns col0 + 4*tx .. +3
    const int ty = tid / 16;  // rows row0 + ty and row0 + ty + 8

    float acc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};

    for (int k0 = 0; k0 < n_red; k0 += TK) {
        if (user_side) {
            // R̂[row0 + a][k0 + b]: 32 consecutive k per warp
            const int b = tid % TK;
            for (int a = tid / TK; a < TM; a += THREADS / TK) {
                const int m = row0 + a, k = k0 + b;
                As[b][a] = (m < n_users && k < n_items)
                    ? to_float(r[(size_t)m * n_items + k]) : 0.f;
            }
        } else {
            // R̂[k0 + a][row0 + b]: 16 consecutive item columns per half warp
            const int b = tid % TM;
            for (int a = tid / TM; a < TK; a += THREADS / TM) {
                const int m = k0 + a, n = row0 + b;
                As[a][b] = (m < n_users && n < n_items)
                    ? to_float(r[(size_t)m * n_items + n]) : 0.f;
            }
        }
        {
            const int c = tid % TD;
            for (int a = tid / TD; a < TK; a += THREADS / TD) {
                const int k = k0 + a, col = col0 + c;
                Bs[a][c] = (k < n_red && col < d)
                    ? as_operand(src[(size_t)k * d + col], T()) : 0.f;
            }
        }
        __syncthreads();
#pragma unroll 8
        for (int kk = 0; kk < TK; ++kk) {
            const float a0 = As[kk][ty];
            const float a1 = As[kk][ty + 8];
            const float4 b = *reinterpret_cast<const float4*>(&Bs[kk][4 * tx]);
            acc[0][0] = fmaf(a0, b.x, acc[0][0]);
            acc[0][1] = fmaf(a0, b.y, acc[0][1]);
            acc[0][2] = fmaf(a0, b.z, acc[0][2]);
            acc[0][3] = fmaf(a0, b.w, acc[0][3]);
            acc[1][0] = fmaf(a1, b.x, acc[1][0]);
            acc[1][1] = fmaf(a1, b.y, acc[1][1]);
            acc[1][2] = fmaf(a1, b.z, acc[1][2]);
            acc[1][3] = fmaf(a1, b.w, acc[1][3]);
        }
        __syncthreads();
    }

#pragma unroll
    for (int p = 0; p < 2; ++p) {
        const int row = row0 + ty + 8 * p;
        if (row >= n_out) continue;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
            const int col = col0 + 4 * tx + q;
            if (col >= d) continue;
            const size_t off = (size_t)row * d + col;
            const float v = acc[p][q];
            if constexpr (BWD && INJ) {
                const float s = acc_in[off] + v;
                dst[off] = inj != nullptr ? s + inj[off] : s;
            } else if constexpr (BWD) {
                dst[off] = acc_in[off] + v;
            } else {
                if (write_next) dst[off] = v;
                acc_out[off] = (acc_in[off] + v) * scale;
            }
        }
    }
}

// K1 (BWD false) and K2 (BWD true).
template <typename T, bool BWD>
__global__ void __launch_bounds__(THREADS)
chain_layer_kernel(const T* __restrict__ r, const float* __restrict__ src_u,
                   const float* __restrict__ src_i, float* __restrict__ dst_u,
                   float* __restrict__ dst_i, const float* acc_in_u,
                   const float* acc_in_i, float* acc_out_u, float* acc_out_i,
                   int n_users, int n_items, int d, float scale, int write_next) {
    chain_layer_body<T, BWD, false>(r, src_u, src_i, dst_u, dst_i, acc_in_u, acc_in_i,
                                    acc_out_u, acc_out_i, nullptr, nullptr, n_users,
                                    n_items, d, scale, write_next);
}

// K3: one forward layer of the chain with a layer snapshot.
template <typename T>
__global__ void __launch_bounds__(THREADS)
chain_layer_snap_kernel(const T* __restrict__ r, const float* __restrict__ src_u,
                        const float* __restrict__ src_i, float* __restrict__ dst_u,
                        float* __restrict__ dst_i, const float* acc_in_u,
                        const float* acc_in_i, float* acc_out_u, float* acc_out_i,
                        int n_users, int n_items, int d, float scale, int write_next) {
    chain_layer_body<T, false, false>(r, src_u, src_i, dst_u, dst_i, acc_in_u, acc_in_i,
                                      acc_out_u, acc_out_i, nullptr, nullptr, n_users,
                                      n_items, d, scale, write_next);
}

// K4: one backward round with the layer-k cotangent injected.
template <typename T>
__global__ void __launch_bounds__(THREADS)
chain_layer_inject_kernel(const T* __restrict__ r, const float* __restrict__ src_u,
                          const float* __restrict__ src_i, const float* seed_u,
                          const float* seed_i, const float* inj_u, const float* inj_i,
                          float* __restrict__ dst_u, float* __restrict__ dst_i,
                          int n_users, int n_items, int d) {
    chain_layer_body<T, true, true>(r, src_u, src_i, dst_u, dst_i, seed_u, seed_i, nullptr,
                                    nullptr, inj_u, inj_i, n_users, n_items, d, 1.f, 1);
}

dim3 layer_grid(int n_users, int n_items, int d) {
    const int nbu = (n_users + TM - 1) / TM;
    const int nbi = (n_items + TM - 1) / TM;
    return dim3(nbu + nbi, (d + TD - 1) / TD);
}

template <typename T, bool BWD>
int launch(const void* r, const float* src_u, const float* src_i, float* dst_u,
           float* dst_i, const float* acc_in_u, const float* acc_in_i,
           float* acc_out_u, float* acc_out_i, int n_users, int n_items, int d,
           float scale, int write_next, void* stream) {
    chain_layer_kernel<T, BWD><<<layer_grid(n_users, n_items, d), THREADS, 0,
                                 static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(r), src_u, src_i, dst_u, dst_i, acc_in_u, acc_in_i,
        acc_out_u, acc_out_i, n_users, n_items, d, scale, write_next);
    return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_snap(const void* r, const float* src_u, const float* src_i, float* dst_u,
                float* dst_i, const float* acc_in_u, const float* acc_in_i,
                float* acc_out_u, float* acc_out_i, int n_users, int n_items, int d,
                float scale, int write_next, void* stream) {
    chain_layer_snap_kernel<T><<<layer_grid(n_users, n_items, d), THREADS, 0,
                                 static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(r), src_u, src_i, dst_u, dst_i, acc_in_u, acc_in_i,
        acc_out_u, acc_out_i, n_users, n_items, d, scale, write_next);
    return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_inject(const void* r, const float* src_u, const float* src_i,
                  const float* seed_u, const float* seed_i, const float* inj_u,
                  const float* inj_i, float* dst_u, float* dst_i, int n_users,
                  int n_items, int d, void* stream) {
    chain_layer_inject_kernel<T><<<layer_grid(n_users, n_items, d), THREADS, 0,
                                   static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(r), src_u, src_i, seed_u, seed_i, inj_u, inj_i, dst_u, dst_i,
        n_users, n_items, d);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C interface for ctypes. Each call is one launch of one layer on the
// given stream; it returns cudaGetLastError() (0 on success).
extern "C" int chain_layer_f32(const void* r, const float* src_u, const float* src_i,
                               float* dst_u, float* dst_i, const float* acc_in_u,
                               const float* acc_in_i, float* acc_out_u,
                               float* acc_out_i, int n_users, int n_items, int d,
                               float scale, int write_next, void* stream) {
    return launch<float, false>(r, src_u, src_i, dst_u, dst_i, acc_in_u, acc_in_i, acc_out_u,
                         acc_out_i, n_users, n_items, d, scale, write_next, stream);
}

extern "C" int chain_layer_bf16(const void* r, const float* src_u, const float* src_i,
                                float* dst_u, float* dst_i, const float* acc_in_u,
                                const float* acc_in_i, float* acc_out_u,
                                float* acc_out_i, int n_users, int n_items, int d,
                                float scale, int write_next, void* stream) {
    return launch<__nv_bfloat16, false>(r, src_u, src_i, dst_u, dst_i, acc_in_u, acc_in_i,
                                 acc_out_u, acc_out_i, n_users, n_items, d, scale,
                                 write_next, stream);
}

// K2: one round of the backward Horner chain, dst = seed + R̂-product of
// the old (src) tables, both halves in one launch.
extern "C" int chain_layer_bwd_f32(const void* r, const float* src_u, const float* src_i,
                                   const float* seed_u, const float* seed_i, float* dst_u,
                                   float* dst_i, int n_users, int n_items, int d,
                                   void* stream) {
    return launch<float, true>(r, src_u, src_i, dst_u, dst_i, seed_u, seed_i, nullptr,
                               nullptr, n_users, n_items, d, 1.f, 1, stream);
}

extern "C" int chain_layer_bwd_bf16(const void* r, const float* src_u, const float* src_i,
                                    const float* seed_u, const float* seed_i, float* dst_u,
                                    float* dst_i, int n_users, int n_items, int d,
                                    void* stream) {
    return launch<__nv_bfloat16, true>(r, src_u, src_i, dst_u, dst_i, seed_u, seed_i,
                                       nullptr, nullptr, n_users, n_items, d, 1.f, 1,
                                       stream);
}

// K3: one forward layer (K1's arguments); the wrapper points dst at the
// snapshot buffers on layer k.
extern "C" int chain_layer_snap_f32(const void* r, const float* src_u, const float* src_i,
                                    float* dst_u, float* dst_i, const float* acc_in_u,
                                    const float* acc_in_i, float* acc_out_u,
                                    float* acc_out_i, int n_users, int n_items, int d,
                                    float scale, int write_next, void* stream) {
    return launch_snap<float>(r, src_u, src_i, dst_u, dst_i, acc_in_u, acc_in_i, acc_out_u,
                              acc_out_i, n_users, n_items, d, scale, write_next, stream);
}

extern "C" int chain_layer_snap_bf16(const void* r, const float* src_u, const float* src_i,
                                     float* dst_u, float* dst_i, const float* acc_in_u,
                                     const float* acc_in_i, float* acc_out_u,
                                     float* acc_out_i, int n_users, int n_items, int d,
                                     float scale, int write_next, void* stream) {
    return launch_snap<__nv_bfloat16>(r, src_u, src_i, dst_u, dst_i, acc_in_u, acc_in_i,
                                      acc_out_u, acc_out_i, n_users, n_items, d, scale,
                                      write_next, stream);
}

// K4: one backward round, dst = seed + R̂-product of the old (src) tables
// + inj (inj_u/inj_i null on the rounds without an injection).
extern "C" int chain_layer_inject_f32(const void* r, const float* src_u, const float* src_i,
                                      const float* seed_u, const float* seed_i,
                                      const float* inj_u, const float* inj_i, float* dst_u,
                                      float* dst_i, int n_users, int n_items, int d,
                                      void* stream) {
    return launch_inject<float>(r, src_u, src_i, seed_u, seed_i, inj_u, inj_i, dst_u, dst_i,
                                n_users, n_items, d, stream);
}

extern "C" int chain_layer_inject_bf16(const void* r, const float* src_u, const float* src_i,
                                       const float* seed_u, const float* seed_i,
                                       const float* inj_u, const float* inj_i, float* dst_u,
                                       float* dst_i, int n_users, int n_items, int d,
                                       void* stream) {
    return launch_inject<__nv_bfloat16>(r, src_u, src_i, seed_u, seed_i, inj_u, inj_i, dst_u,
                                        dst_i, n_users, n_items, d, stream);
}

extern "C" const char* chain_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}
