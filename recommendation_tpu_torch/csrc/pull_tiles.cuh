// The pipeline that P1 (csrc/gather.cu) and S1 (csrc/segment.cu) share: row
// loads and stores of VEC f32, the tiles of a pull_schedule work list
// (ops/gather.py) walked by persistent blocks with the next tiles' copies
// in flight, and the counter that tells the group finishing a split row's
// last piece to merge the pieces.
#pragma once

#include <cuda_runtime.h>

#include "cp_async.cuh"

// VEC consecutive f32 of a gathered row: 16-byte loads where VEC fills them
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

// Where tile t's copies come from: its slot range [lo, hi) and its rows
// [r0, r1] (consecutive: every row has an item), read a stage ahead of
// the copy
struct TileRange {
    long long lo = 0, hi = 0;
    int r0 = 0, r1 = 0;
};

// tile t of a work list cut into tiles of `items` items (empty past the end)
__device__ __forceinline__ TileRange tile_range(const int4* work, const long long* work_start,
                                                int n_work, int items, int t) {
    TileRange rg;
    const int first = t * items;
    if (first < n_work) {
        const int last = min(first + items, n_work) - 1;
        rg.lo = work_start[first];
        rg.hi = work_start[last + 1];
        rg.r0 = work[first].x;
        rg.r1 = work[last].x;
    }
    return rg;
}

// Persistent blocks walk the tiles with the grid's stride. Tile t's copies
// go into stage buffer (round % STAGES), issued STAGES - 1 rounds ahead,
// so no item waits a round trip to memory for its indices. `range(t)`
// reads tile t's range, `stage(t, range, buffer)` issues its cp.async
// copies, `body(t, buffer)` sums it once every thread's copies are in.
template <int STAGES, typename Range, typename Stage, typename Body>
__device__ __forceinline__ void walk_tiles(int n_tiles, Range range, Stage stage, Body body) {
    int t = blockIdx.x;
    if (t >= n_tiles) return;
    const int step = gridDim.x;
#pragma unroll
    for (int k = 0; k < STAGES - 1; ++k) {
        const int tk = t + k * step;
        if (tk < n_tiles) stage(tk, range(tk), k);
        cp_async_commit();
    }
    TileRange next = range(t + (STAGES - 1) * step);
    for (int it = 0; t < n_tiles; t += step, ++it) {
        const int tn = t + (STAGES - 1) * step;
        if (tn < n_tiles) stage(tn, next, (it + STAGES - 1) % STAGES);
        cp_async_commit();
        next = range(tn + step);  // read now, staged next round
        cp_async_wait<STAGES - 1>();
        __syncthreads();  // tile t is in
        body(t, it % STAGES);
        __syncthreads();  // tile t's stage is read before it is refilled
    }
}

// A group of lanes (mask gmask, leader lane `leader`, its lane l) wrote its
// piece of a split row: true, in every lane of the group, for the group
// that finished the row's last piece, which then adds the pieces' partial
// sums in piece order. Every lane's partial is fenced before the count
// moves, and the reads after a true are fenced too.
__device__ __forceinline__ bool last_piece(int* count, int part, int pieces, unsigned gmask,
                                           int l, int leader) {
    __threadfence();
    __syncwarp(gmask);
    int done = 0;
    if (l == 0) done = atomicAdd(count + part, 1);
    done = __shfl_sync(gmask, done, leader);
    if (done != pieces - 1) return false;
    __threadfence();
    return true;
}
