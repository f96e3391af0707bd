// One layer of the dense bipartite LightGCN chain, forward (K1) and
// backward (K2), and the same with a layer snapshot (K3) and a layer-k
// cotangent injection (K4), on Hopper (sm_90a). The four are one body with
// four epilogues.
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
// both from the OLD au, ai: the same two products per round as K1, with the
// epilogue dst = seed + acc, written to a fresh buffer.
//
// K3 replaces pallas_prop.py::_chain_layer_fwd_kernel (:203-237, NCL's
// forward): K1's layer under its own kernel name; the wrapper points layer
// k's dst at the snapshot buffers. K4 replaces _chain_layer_bwd_kernel
// (:240-272): K2's round with one more operand, dst = (seed + acc) + inj,
// inj null on every round but j == k.
//
// What bounds a layer on an H100: at the bench shape (U = 943, I = 1675,
// d = 64) a layer is 2 x 2UId = 404 MFLOP. In f32 that is 6 us of FFMA at
// 67 TFLOP/s against 6.3 MB of R̂ read twice through L2: the operations
// bound it. In bf16 R̂ is 3.2 MB, and the bytes (about 0.5 us a layer at
// 3.35 TB/s) would bound it only on the tensor cores; with FFMA (this
// version) the operations bound it as in f32. At this size a layer is
// short enough that latencies set its time as much as the FFMA rate: the
// first tile's arrival, the partial sums' round trip, the epilogue's.
//
// What the design does about it:
//   * One wave of enough blocks. A block owns a TM x TN = 64 x 64 output
//     tile of one half (blocks of the user side compute u' = R̂ · src_i,
//     blocks of the item side i' = R̂ᵀ · src_u) and one slice of its
//     reduction. The wrapper (ops/prop.py::chain_plan) takes the shortest
//     slice, in TK-deep tiles, whose blocks the card still holds at once
//     (chain_blocks_per_sm x SMs): at the bench shape on an H100, 4 blocks
//     an SM, 128-deep slices, 14 on the user side and 8 on the item side,
//     426 blocks of 128 threads. A second wave would add a whole block's
//     time to the layer.
//   * A fixed-order combine. A block with one slice of several writes its
//     partial tile to the wrapper's workspace, fences, and counts itself in
//     the tile's integer counter; the block that counts last adds the
//     slices' partials in slice order (8 slices' loads in flight at once),
//     runs the epilogue once on that sum and sets the counter back to 0, so
//     the next launch finds it zero. No float atomics, so a call repeats
//     bit for bit. A tile with one slice runs the epilogue straight from
//     its registers.
//   * 16-byte loads along R̂'s rows on both sides, 8 bf16 or 4 f32 a
//     thread. The user side stages R̂[rows, k-slice] as it lies; the item
//     side stages R̂[k-slice, columns] as it lies too, and reads it across
//     (4 consecutive output rows in one load). No global read is strided.
//     This needs 16-byte aligned rows: the dense DeviceGraph pads R̂'s row
//     stride to a multiple of 8 elements (`ld`); an unaligned R̂ takes
//     element loads (the tests' odd shapes).
//   * Asynchronous staging. R̂ and source-table tiles go through cp.async
//     into NST = 2 shared-memory stages: the next TK-deep tile is in flight
//     while the current one is multiplied; one barrier a tile. In bf16 each
//     thread rounds the source values it copied, once, before the barrier
//     (as_operand), and R̂ stays bf16 in shared memory (half the bytes),
//     widened as it is read.
//   * Register micro-tiles of 4 rows x 8 columns a thread; a warp is 8
//     column groups x 4 row groups, so that every float4 load of either
//     operand is one shared-memory wavefront. On the user side one 16-byte
//     load of R̂ feeds 4 (f32) or 8 (bf16) k of 8 FFMA each and two float4
//     of the source table 32 FFMA; on the item side one load of 4 R̂ values
//     and two float4 feed 32 FFMA.
//   * The epilogue loads all its operands before its first store (acc_out
//     may be acc_in), so its loads overlap.
//   * Programmatic dependent launch between a call's layers: a layer lets
//     the next one launch at once (griddepcontrol.launch_dependents), and
//     the next one fetches its first R̂ tiles, which no layer writes, while
//     the previous layer's last blocks combine and store; then it waits
//     (griddepcontrol.wait) before touching anything else. This hides a
//     launch and a first-tile fetch per layer after the first.
// Products are FFMA in f32 (a bf16 x bf16 product is exact in f32, so this
// equals preferred_element_type=f32; no TF32), summed in k order within a
// slice and then in slice order. K1's epilogue folds the layer-mean
// readout: acc_out = (acc_in + new) * scale, scale 1 on all but the last
// layer and 1/(L+1) on the last, the same operations in the same order as
// the plain chain. Ragged edges are zero-filled by the copies and masked
// in the epilogue; nothing is padded.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "cp_async.cuh"

namespace {

constexpr int TM = 64;        // output rows per block
constexpr int TN = 64;        // output columns per block
constexpr int TK = 32;        // reduction depth per stage
constexpr int THREADS = 128;  // 8 column groups of 8 x 16 row groups of 4
constexpr int NST = 2;        // cp.async stages
constexpr int MIN_BLOCKS = 4;  // per SM: at most 128 registers a thread

enum Epilogue { FWD = 0, BWD = 1, INJ = 2 };

// One layer's operands. BWD and INJ take the seeds as acc_in; only INJ
// reads inj (null on its rounds without an injection); only FWD writes
// acc_out and reads scale and write_next.
struct Layer {
    const void* r;
    long long ld;  // R̂'s row stride, in elements
    const float* src_u;
    const float* src_i;
    float* dst_u;
    float* dst_i;
    const float* acc_in_u;
    const float* acc_in_i;
    float* acc_out_u;
    float* acc_out_i;
    const float* inj_u;
    const float* inj_i;
    int n_users, n_items, d;
    float scale;
    int write_next;
    int slice_tiles;  // TK-deep tiles per reduction slice
    int chained;      // the previous launch on the stream is this chain's previous layer
    float* partial;   // [tiles x slices][TM][TN]; null when every tile has one slice
    int* count;       // per output tile, zero before the launch
};

__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }

// The running table as the product sees it in bf16: rounded to bf16
// (round to nearest even, as jnp.astype) and widened back for the FFMA.
__device__ __forceinline__ float as_operand(float x, __nv_bfloat16) {
    return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float bf16_lo(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }

// 4 (f32) or 8 (bf16) consecutive values of R̂ in shared memory, as f32
__device__ __forceinline__ void load_r(const float* p, float (&v)[4]) {
    const float4 a = *reinterpret_cast<const float4*>(p);
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
}
__device__ __forceinline__ void load_r(const __nv_bfloat16* p, float (&v)[8]) {
    const uint4 a = *reinterpret_cast<const uint4*>(p);
    v[0] = bf16_lo(a.x); v[1] = bf16_hi(a.x); v[2] = bf16_lo(a.y); v[3] = bf16_hi(a.y);
    v[4] = bf16_lo(a.z); v[5] = bf16_hi(a.z); v[6] = bf16_lo(a.w); v[7] = bf16_hi(a.w);
}
__device__ __forceinline__ void load_r4(const float* p, float (&v)[4]) { load_r(p, v); }
__device__ __forceinline__ void load_r4(const __nv_bfloat16* p, float (&v)[4]) {
    const uint2 a = *reinterpret_cast<const uint2*>(p);
    v[0] = bf16_lo(a.x); v[1] = bf16_hi(a.x); v[2] = bf16_lo(a.y); v[3] = bf16_hi(a.y);
}

// Shared memory of one block: NST stages, each an R̂ tile (as it lies in
// R̂, in its own type: [TM][TK] on the user side, [TK][TM] on the item
// side) and a source-table tile [TK][TN] in f32.
template <typename T>
struct Smem {
    static constexpr int VEC = 16 / sizeof(T);  // elements of R̂ in 16 bytes
    static constexpr int PU = TK + VEC;         // user-side row: rows i, i + 1 start 4 banks apart
    static constexpr int PI = TM + VEC;         // item-side row
    static constexpr size_t R_BYTES = sizeof(T) * (TM * PU > TK * PI ? TM * PU : TK * PI);
    static constexpr size_t SRC_BYTES = sizeof(float) * TK * TN;
    static constexpr size_t STAGE = R_BYTES + SRC_BYTES;
    static constexpr size_t BYTES = NST * STAGE;

    unsigned char* base;
    __device__ T* r(int s) { return reinterpret_cast<T*>(base + s * STAGE); }
    __device__ float (*src(int s))[TN] {
        return reinterpret_cast<float (*)[TN]>(base + s * STAGE + R_BYTES);
    }
};

// Stage R̂[row0 .. row0 + rows, col0 .. col0 + cols) (outside U x I reads
// as 0) into a with row pitch `pitch`: 16 bytes a copy where R̂'s rows are
// aligned, else element by element.
template <typename T, int ROWS, int COLS>
__device__ __forceinline__ void stage_r(T* a, int pitch, const T* r, long long ld, int row0,
                                        int col0, int n_rows, int n_cols, bool vec) {
    constexpr int VEC = Smem<T>::VEC;
    if (vec) {
        constexpr int PER_ROW = COLS / VEC;
        for (int e = threadIdx.x; e < ROWS * PER_ROW; e += THREADS) {
            const int i = e / PER_ROW, j = (e % PER_ROW) * VEC;
            const int row = row0 + i, col = col0 + j;
            const int n = row < n_rows ? max(0, min(VEC, n_cols - col)) : 0;
            cp_async16(a + i * pitch + j, n > 0 ? r + row * ld + col : r,
                       n * static_cast<int>(sizeof(T)));
        }
    } else {
        for (int e = threadIdx.x; e < ROWS * COLS; e += THREADS) {
            const int i = e / COLS, j = e % COLS;
            const int row = row0 + i, col = col0 + j;
            a[i * pitch + j] = (row < n_rows && col < n_cols) ? r[row * ld + col] : T(0.f);
        }
    }
}

// Stage src[k0 .. k0+TK, col0 .. col0+TN) (outside n_red x d reads as 0).
__device__ __forceinline__ void stage_src(float (*b)[TN], const float* src, int k0, int n_red,
                                          int col0, int d, bool vec) {
    if (vec) {
        for (int e = threadIdx.x; e < TK * (TN / 4); e += THREADS) {
            const int i = e / (TN / 4), j = (e % (TN / 4)) * 4;
            const int row = k0 + i, col = col0 + j;
            const int n = row < n_red ? max(0, min(4, d - col)) : 0;
            cp_async16(&b[i][j], n > 0 ? src + static_cast<size_t>(row) * d + col : src, 4 * n);
        }
    } else {
        for (int e = threadIdx.x; e < TK * TN; e += THREADS) {
            const int i = e / TN, j = e % TN;
            const int row = k0 + i, col = col0 + j;
            const bool ok = row < n_red && col < d;
            cp_async4(&b[i][j], ok ? src + static_cast<size_t>(row) * d + col : src, ok ? 4 : 0);
        }
    }
}

// In bf16: round the source values this thread copied (the copies of
// stage_src with the same arguments), after its wait and before the barrier.
template <typename T>
__device__ __forceinline__ void round_src(float (*b)[TN], bool vec) {
    if constexpr (sizeof(T) == 2) {
        if (vec) {
            for (int e = threadIdx.x; e < TK * (TN / 4); e += THREADS) {
                float* p = &b[e / (TN / 4)][(e % (TN / 4)) * 4];
#pragma unroll
                for (int c = 0; c < 4; ++c) p[c] = as_operand(p[c], T());
            }
        } else {
            for (int e = threadIdx.x; e < TK * TN; e += THREADS) {
                float* p = &b[e / TN][e % TN];
                *p = as_operand(*p, T());
            }
        }
    }
}

// acc[i][0..3] += a[i] * b0, acc[i][4..7] += a[i] * b1
__device__ __forceinline__ void fma_row(float (&acc)[8], float a, const float4& b0,
                                        const float4& b1) {
    acc[0] = fmaf(a, b0.x, acc[0]); acc[1] = fmaf(a, b0.y, acc[1]);
    acc[2] = fmaf(a, b0.z, acc[2]); acc[3] = fmaf(a, b0.w, acc[3]);
    acc[4] = fmaf(a, b1.x, acc[4]); acc[5] = fmaf(a, b1.y, acc[5]);
    acc[6] = fmaf(a, b1.z, acc[6]); acc[7] = fmaf(a, b1.w, acc[7]);
}

template <typename T, int EPI>
__device__ __forceinline__ void chain_layer_body(const Layer& L) {
    extern __shared__ __align__(16) unsigned char chain_smem[];
    __shared__ int last;
    using S = Smem<T>;
    S s{chain_smem};
    constexpr int VEC = S::VEC;

    const int nbu = cdiv(L.n_users, TM), nbi = cdiv(L.n_items, TM), ndt = cdiv(L.d, TN);
    const int su = cdiv(cdiv(L.n_items, TK), L.slice_tiles);
    const int si = cdiv(cdiv(L.n_users, TK), L.slice_tiles);
    const int user_blocks = nbu * ndt * su;
    int blk = blockIdx.x;
    const bool user_side = blk < user_blocks;
    // user side: out = R̂ · src_i over U rows, reduction over I
    // item side: out = R̂ᵀ · src_u over I rows, reduction over U
    int n_slices, slice, t, part0;
    if (user_side) {
        n_slices = su;
        slice = blk % su;
        t = blk / su;
        part0 = t * su;
    } else {
        blk -= user_blocks;
        n_slices = si;
        slice = blk % si;
        t = blk / si;
        part0 = nbu * ndt * su + t * si;
    }
    const int tile = user_side ? t : nbu * ndt + t;
    const int row0 = (t / ndt) * TM, col0 = (t % ndt) * TN;
    const int n_out = user_side ? L.n_users : L.n_items;
    const int n_red = user_side ? L.n_items : L.n_users;
    const float* src = user_side ? L.src_i : L.src_u;
    const int k_begin = slice * L.slice_tiles * TK;
    const int n_tiles = cdiv(min(n_red, k_begin + L.slice_tiles * TK) - k_begin, TK);

    const T* r = static_cast<const T*>(L.r);
    const bool vec_r = (L.ld * static_cast<long long>(sizeof(T))) % 16 == 0 &&
                       (reinterpret_cast<uintptr_t>(r) & 15u) == 0;
    const bool vec_b = L.d % 4 == 0 && (reinterpret_cast<uintptr_t>(src) & 15u) == 0;

    // a warp is 8 column groups x 4 row groups, so that a float4 load of
    // either operand is one shared-memory wavefront
    const int tid = threadIdx.x, lane = tid % 32;
    const int tx = lane % 8;               // columns col0 + 4 tx .. + 3 and col0 + 32 + 4 tx .. + 3
    const int ty = lane / 8 + 4 * (tid / 32);  // rows: user side ty + 16 i, item side 4 ty + i

    auto issue_r = [&](int kt) {
        const int k0 = k_begin + kt * TK, st = kt % NST;
        if (user_side)
            stage_r<T, TM, TK>(s.r(st), S::PU, r, L.ld, row0, k0, L.n_users, L.n_items, vec_r);
        else
            stage_r<T, TK, TM>(s.r(st), S::PI, r, L.ld, k0, row0, L.n_users, L.n_items, vec_r);
    };
    auto issue_src = [&](int kt) {
        stage_src(s.src(kt % NST), src, k_begin + kt * TK, n_red, col0, L.d, vec_b);
    };

    // The next layer may launch now (programmatic dependent launch): its
    // blocks start as this layer's leave the SMs. A layer launched so
    // (L.chained) fetches its first R̂ tiles, which no layer writes, before
    // it waits for the previous layer to finish; it reads and writes
    // nothing else before that wait.
    asm volatile("griddepcontrol.launch_dependents;");
    if (L.chained)
        for (int p = 0; p < NST - 1 && p < n_tiles; ++p) issue_r(p);
    asm volatile("griddepcontrol.wait;" ::: "memory");

    // NST stages: tiles kt + 1 .. kt + NST - 1 are in flight while tile kt
    // is multiplied; one barrier a tile
    float acc[4][8] = {};
    for (int p = 0; p < NST - 1; ++p) {
        if (p < n_tiles) {
            if (!L.chained) issue_r(p);
            issue_src(p);
        }
        cp_async_commit();
    }
    for (int kt = 0; kt < n_tiles; ++kt) {
        const int st = kt % NST;
        cp_async_wait<NST - 2>();
        round_src<T>(s.src(st), vec_b);
        __syncthreads();  // tile kt is staged; every thread is done with tile kt - 1
        if (kt + NST - 1 < n_tiles) {  // into tile kt - 1's stage
            issue_r(kt + NST - 1);
            issue_src(kt + NST - 1);
        }
        cp_async_commit();
        const T* a = s.r(st);
        const float(*b)[TN] = s.src(st);
        if (user_side) {
#pragma unroll
            for (int kv = 0; kv < TK; kv += VEC) {
                float av[4][VEC];
#pragma unroll
                for (int i = 0; i < 4; ++i) load_r(a + (ty + 16 * i) * S::PU + kv, av[i]);
#pragma unroll
                for (int kk = 0; kk < VEC; ++kk) {
                    const float4 b0 = *reinterpret_cast<const float4*>(&b[kv + kk][4 * tx]);
                    const float4 b1 = *reinterpret_cast<const float4*>(&b[kv + kk][32 + 4 * tx]);
#pragma unroll
                    for (int i = 0; i < 4; ++i) fma_row(acc[i], av[i][kk], b0, b1);
                }
            }
        } else {
#pragma unroll 8
            for (int k = 0; k < TK; ++k) {
                float av[4];
                load_r4(a + k * S::PI + 4 * ty, av);
                const float4 b0 = *reinterpret_cast<const float4*>(&b[k][4 * tx]);
                const float4 b1 = *reinterpret_cast<const float4*>(&b[k][32 + 4 * tx]);
#pragma unroll
                for (int i = 0; i < 4; ++i) fma_row(acc[i], av[i], b0, b1);
            }
        }
    }

    auto local_row = [&](int i) { return user_side ? ty + 16 * i : 4 * ty + i; };
    if (n_slices > 1) {
        float* mine = L.partial + static_cast<size_t>(part0 + slice) * TM * TN;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            float* row = mine + local_row(i) * TN;
            *reinterpret_cast<float4*>(row + 4 * tx) =
                make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
            *reinterpret_cast<float4*>(row + 32 + 4 * tx) =
                make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
        }
        __threadfence();
        __syncthreads();
        if (tid == 0) last = atomicAdd(L.count + tile, 1) == n_slices - 1;
        __syncthreads();
        if (!last) return;
        __threadfence();
        // the last block adds the slices in slice order, whichever finished last
        const float* parts = L.partial + static_cast<size_t>(part0) * TM * TN;
#pragma unroll 8
        for (int sl = 0; sl < n_slices; ++sl) {
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                const float* row = parts + static_cast<size_t>(sl) * TM * TN + local_row(i) * TN;
                const float4 p0 = __ldcg(reinterpret_cast<const float4*>(row + 4 * tx));
                const float4 p1 = __ldcg(reinterpret_cast<const float4*>(row + 32 + 4 * tx));
                const float p[8] = {p0.x, p0.y, p0.z, p0.w, p1.x, p1.y, p1.z, p1.w};
#pragma unroll
                for (int c = 0; c < 8; ++c) acc[i][c] = sl == 0 ? p[c] : acc[i][c] + p[c];
            }
        }
        if (tid == 0) L.count[tile] = 0;  // ready for the next layer
    }

    float* dst = user_side ? L.dst_u : L.dst_i;
    const float* acc_in = user_side ? L.acc_in_u : L.acc_in_i;
    float* acc_out = user_side ? L.acc_out_u : L.acc_out_i;
    const float* inj = user_side ? L.inj_u : L.inj_i;
    // every operand is loaded before the first store (acc_out may be
    // acc_in), so the loads overlap instead of waiting on the stores
    float in[4][8], add[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int row = row0 + local_row(i);
#pragma unroll
        for (int c = 0; c < 8; ++c) {
            const int col = col0 + (c < 4 ? 4 * tx + c : 32 + 4 * tx + c - 4);
            const bool ok = row < n_out && col < L.d;
            const size_t off = static_cast<size_t>(row) * L.d + col;
            in[i][c] = ok ? acc_in[off] : 0.f;
            add[i][c] = (EPI == INJ && ok && inj != nullptr) ? inj[off] : 0.f;
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int row = row0 + local_row(i);
        if (row >= n_out) continue;
#pragma unroll
        for (int c = 0; c < 8; ++c) {
            const int col = col0 + (c < 4 ? 4 * tx + c : 32 + 4 * tx + c - 4);
            if (col >= L.d) continue;
            const size_t off = static_cast<size_t>(row) * L.d + col;
            const float v = acc[i][c];
            if constexpr (EPI == INJ) {
                const float sum = in[i][c] + v;
                dst[off] = inj != nullptr ? sum + add[i][c] : sum;
            } else if constexpr (EPI == BWD) {
                dst[off] = in[i][c] + v;
            } else {
                if (L.write_next) dst[off] = v;
                acc_out[off] = (in[i][c] + v) * L.scale;
            }
        }
    }
}

// K1 (FWD) and K2 (BWD).
template <typename T, int EPI>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS) chain_layer_kernel(const Layer L) {
    chain_layer_body<T, EPI>(L);
}

// K3: one forward layer of the chain, layer k written into the snapshot.
template <typename T>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS) chain_layer_snap_kernel(const Layer L) {
    chain_layer_body<T, FWD>(L);
}

// K4: one backward round with the layer-k cotangent injected.
template <typename T>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS) chain_layer_inject_kernel(const Layer L) {
    chain_layer_body<T, INJ>(L);
}

int layer_blocks(int n_users, int n_items, int d, int slice_tiles) {
    const int ndt = cdiv(d, TN);
    return ndt * (cdiv(n_users, TM) * cdiv(cdiv(n_items, TK), slice_tiles) +
                  cdiv(n_items, TM) * cdiv(cdiv(n_users, TK), slice_tiles));
}

template <typename Kernel>
int prepare(Kernel kernel, size_t smem) {
    if (smem <= 48 * 1024) return 0;
    return static_cast<int>(cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem)));
}

template <typename T, typename Kernel>
int launch_one(Kernel kernel, const Layer& L, cudaStream_t stream) {
    constexpr size_t smem = Smem<T>::BYTES;
    if (int err = prepare(kernel, smem)) return err;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(layer_blocks(L.n_users, L.n_items, L.d, L.slice_tiles));
    cfg.blockDim = dim3(THREADS);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
    attr[0].val.programmaticStreamSerializationAllowed = L.chained ? 1 : 0;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    if (cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, L)) return static_cast<int>(err);
    return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(int kernel, const Layer& L, cudaStream_t stream) {
    switch (kernel) {
        case 1: return launch_one<T>(chain_layer_kernel<T, FWD>, L, stream);
        case 2: return launch_one<T>(chain_layer_kernel<T, BWD>, L, stream);
        case 3: return launch_one<T>(chain_layer_snap_kernel<T>, L, stream);
        case 4: return launch_one<T>(chain_layer_inject_kernel<T>, L, stream);
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
}

template <typename T, typename Kernel>
int resident(Kernel kernel) {
    constexpr size_t smem = Smem<T>::BYTES;
    int n = 0;
    if (prepare(kernel, smem) != 0 ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, THREADS, smem) != cudaSuccess)
        return 0;
    return n;
}

// the fewest blocks of any of the four kernels that fit on one SM at once
template <typename T>
int blocks_per_sm() {
    const int n[4] = {resident<T>(chain_layer_kernel<T, FWD>),
                      resident<T>(chain_layer_kernel<T, BWD>),
                      resident<T>(chain_layer_snap_kernel<T>),
                      resident<T>(chain_layer_inject_kernel<T>)};
    int least = n[0];
    for (int i = 1; i < 4; ++i) least = n[i] < least ? n[i] : least;
    return least;
}

}  // namespace

// Plain C interface for ctypes. One call is one launch of one layer (both
// halves) on the given stream; it returns cudaGetLastError() (0 on
// success). `kernel` is 1 (K1), 2 (K2), 3 (K3) or 4 (K4); K2 and K4 take
// the seeds as acc_in and ignore acc_out, scale and write_next; K1 and K3
// ignore inj. R̂ is [n_users, n_items] with row stride ld; the tables are
// contiguous [n, d] f32. slice_tiles, partial and count come from the
// wrapper's plan (ops/prop.py::chain_plan); count is zero before the first
// layer of a call and the kernel leaves it zero. chained is 1 where the
// previous launch on the stream is the same call's previous layer: the
// launch may then overlap that layer's tail (programmatic dependent
// launch) and prefetch R̂ before it waits for it.
extern "C" int chain_layer(int kernel, int bf16, const void* r, long long ld,
                           const float* src_u, const float* src_i, float* dst_u, float* dst_i,
                           const float* acc_in_u, const float* acc_in_i, float* acc_out_u,
                           float* acc_out_i, const float* inj_u, const float* inj_i,
                           int n_users, int n_items, int d, float scale, int write_next,
                           int slice_tiles, int chained, float* partial, int* count,
                           void* stream) {
    const Layer L{r, ld, src_u, src_i, dst_u, dst_i, acc_in_u, acc_in_i, acc_out_u, acc_out_i,
                  inj_u, inj_i, n_users, n_items, d, scale, write_next, slice_tiles, chained,
                  partial, count};
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    return bf16 ? launch<__nv_bfloat16>(kernel, L, s) : launch<float>(kernel, L, s);
}

// How many blocks of a layer launch one SM holds at once (the wrapper plans
// one wave with it); 0 if the runtime cannot say.
extern "C" int chain_blocks_per_sm(int bf16) {
    return bf16 ? blocks_per_sm<__nv_bfloat16>() : blocks_per_sm<float>();
}

// The tile shape (TM, TK, TN) the wrapper plans with: which = 0, 1, 2.
extern "C" int chain_tile(int which) { return which == 0 ? TM : which == 1 ? TK : TN; }

extern "C" const char* chain_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}
