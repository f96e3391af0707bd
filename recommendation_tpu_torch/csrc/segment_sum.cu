// P2, the pull over a row-sorted view (ops/segment.py::segment_sum), on
// Hopper (sm_90a).
//
// P2 replaces no TPU kernel. It is the single-head sum that the JAX package
// leaves to XLA's segment_sum (recommendation_tpu/ops/spmm.py:34-50, the
// segment backend's product; models/graphsage.py:36-40; the per-row sums of
// GAT's custom VJP, models/gat.py:194-196), written over a row-sorted view:
// row r owns the slots [row_ptr[r], row_ptr[r+1]) in the COO's order. For
// every row r,
//
//     y[r, :] = post[r] * sum_{s in row r, in slot order} val[s] * src[idx[s], :]
//
// in f32, with `val` and `post` optional, each product and sum rounded once
// (__fmul_rn, __fadd_rn). P1 (csrc/gather.cu) computes the same function for
// the bucket rows; P2 computes it over a view bit for bit as P1 does: a
// row's sum starts at 0 and adds its slots in order, a row longer than CHUNK
// slots is cut into CHUNK-slot pieces counted from its own first slot, and
// the pieces' partial sums are added in piece order by the group that
// finishes the row's last piece (P1's counter, csrc/pull_tiles.cuh). How
// rows are grouped into work never changes a row's order, so a row sums
// alike in a whole view and in a cut of it (ops/segment.py::row_range_view,
// rows_transpose_view), and every call repeats bit for bit: the only
// atomic is the integer counter.
//
// What bounds it: bytes. At the clustered graph's view (150,000 rows, 1.8M
// slots, d = 64 f32) it reads 14 MB of slot indices and values and writes
// 38 MB, and its gathers move 461 MB out of a 38 MB source table that the
// 50 MB L2 holds: the distinct rows come from device memory once, the
// rest from L2. A view's rows are the graph's nodes in node order, so their
// lengths mix: the median row holds 7 slots, a few hundred more than 128.
// P1's tiles (32 items a block between barriers, two items a warp walked in
// step, 100 KB of shared memory a block sized for 32 x 128 slots) wait on
// the longest row of each tile. On the H100 (tools/probe_segment_view_pull.py)
// P1 over the view took 0.209 ms, 0.153 over the same rows sorted by length
// and 0.177 with every gather an L2 hit; a first P2 that loaded each item's
// header, row ends and indices when it reached the item took 0.161, and
// 0.081 with no gather at all: the round trips to those operands, one
// after another in each group, held it. The design:
//   * A work list of items of even size in slots (ops/segment.py::
//     sum_schedule): a run of consecutive rows, empty ones included, of at
//     most CHUNK slots and MAX_ROWS rows together; or one CHUNK-slot piece
//     of a longer row. Built once on the host with the view.
//   * Persistent groups of lanes and no block barrier: each group takes
//     the items g, g + G, .. on its own. A group is as many lanes as a row
//     needs for 16-byte loads: 16 at d = 64 in f32 (two groups a warp),
//     else a warp, with more column passes past 128 f32.
//   * Two stages of shared memory a group (1.4 KB each): while the group
//     sums an item, cp.async brings the next item's slot indices and
//     values, row pointers and row scales into the other stage, and the
//     header of the item after that into registers, so no operand but the
//     gathered rows is waited for.
//   * An item's slots as one stream: the group issues U gathers, one row
//     of the source each, before it adds any, and writes a row's sum at its
//     last slot, the sum starting again at 0; so several short rows'
//     gathers are in flight at once. U = 16 at 2 blocks an SM beat U = 8
//     at 3 and 4 blocks (4 spill) and U = 32 at 1; refilling each row's
//     registers as soon as they were added (a rolling window) ran slower,
//     with fewer rows in flight.
//   * The item's rows' ends and scales are read from the stage, two rows
//     a lane (one with a warp a group), and handed out by shuffle; its
//     empty rows are written 0 * post first.
//   * A split row's last piece adds the pieces' partial sums one at a
//     time, in piece order, in a loop kept rolled: as the compiler
//     unrolled it the view took 0.112 ms and the rows sorted by length
//     0.134, rolled 0.107 and 0.100; loading four partials at once took
//     0.127 on the view.

#include <cuda_runtime.h>
#include <stdint.h>

#include "pull_tiles.cuh"

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int WARPS = 8;       // warps per block
constexpr int CHUNK = 128;     // slots per piece of a split row, and at most per item (ops/gather.py::CHUNK)
constexpr int MAX_ROWS = 32;   // rows an item holds at most (ops/segment.py::SUM_ROWS)
constexpr int U = 16;          // slots a group gathers at once
constexpr int MIN_BLOCKS = 2;  // blocks an SM holds at once (caps the registers)

struct ViewSum {  // one P2 call's operands (val, post, partial, count may be null)
    const float* src;
    const int* idx;
    const int4* work;             // [n_work] (first row, rows or piece, the split row's first partial or -1, its pieces)
    const long long* work_start;  // [n_work + 1] each item's first slot
    int n_work;
    const long long* row_ptr;
    const float* val;
    const float* post;
    int d;
    float* partial;
    int* count;
    float* out;
};

// A group of LANES lanes: its lane l, its first lane's number in the warp and
// its mask
template <int LANES>
struct Group {
    int l, leader;
    unsigned mask;
    __device__ __forceinline__ Group() {
        const int lane = threadIdx.x & 31;
        l = lane % LANES;
        leader = lane / LANES * LANES;
        mask = LANES == 32 ? FULL : ((1u << LANES) - 1) << leader;
    }
};

// An item's work list entry and slot range
struct Item {
    int4 wk = make_int4(0, 0, -1, 0);
    long long s0 = 0;
    int n = 0;
};

__device__ __forceinline__ Item load_item(const ViewSum& a, int w) {
    Item it;
    if (w < a.n_work) {
        it.wk = __ldg(a.work + w);
        it.s0 = __ldg(a.work_start + w);
        it.n = static_cast<int>(__ldg(a.work_start + w + 1) - it.s0);
    }
    return it;
}

// One item's operands in shared memory: each slot's (index, value bits),
// and for a run of rows their pointers and scales
struct Stage {
    int2 slot[CHUNK];
    long long ptr[MAX_ROWS + 1];
    float post[MAX_ROWS];
};

// Copy item `it`'s operands into `st` (cp.async, 4 and 8 bytes; nothing
// past its slots and rows), lane l every LANES-th of them
template <int LANES, bool HAS_VAL>
__device__ __forceinline__ void stage_item(const ViewSum& a, const Item& it, Stage& st, int l) {
    for (int e = l; e < it.n; e += LANES) {
        cp_async4(&st.slot[e].x, a.idx + it.s0 + e, 4);
        if constexpr (HAS_VAL) cp_async4(&st.slot[e].y, a.val + it.s0 + e, 4);
    }
    if (it.wk.z >= 0) return;  // a piece: its row's scale is read where the row is finished
    const int r0 = it.wk.x, nr = it.wk.y;
    for (int k = l; k <= nr; k += LANES) {
        cp_async8(&st.ptr[k], a.row_ptr + r0 + k, 8);
        if (k < nr && a.post != nullptr) cp_async4(&st.post[k], a.post + r0 + k, 4);
    }
}

// Sums the item's slots [0, n) in order into acc, U at a time, restarting
// from 0 after each slot t for which at_end(t, acc) is true (at_end writes
// the finished sum): the group issues U rows' gathers before it adds any.
// Every lane of the group takes part; the lanes whose columns lie past the
// row (col_ok false) load and add nothing.
template <int VEC, bool HAS_VAL, typename AtEnd>
__device__ __forceinline__ void stream(const ViewSum& a, const Stage& st, int n, bool col_ok,
                                       const float* src_col, AtEnd at_end) {
    float acc[VEC];
#pragma unroll
    for (int q = 0; q < VEC; ++q) acc[q] = 0.f;
    for (int j = 0; j < n; j += U) {
        float v[U][VEC];
#pragma unroll
        for (int u = 0; u < U; ++u) {
            if (j + u < n && col_ok)
                load_row<VEC>(src_col + static_cast<size_t>(st.slot[j + u].x) * a.d, v[u]);
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
            if (j + u >= n) break;  // alike in the whole group
            if (col_ok) {
                const float w = HAS_VAL ? __int_as_float(st.slot[j + u].y) : 1.f;
#pragma unroll
                for (int q = 0; q < VEC; ++q)
                    acc[q] = __fadd_rn(acc[q], HAS_VAL ? __fmul_rn(w, v[u][q]) : v[u][q]);
            }
            if (at_end(j + u, acc)) {
#pragma unroll
                for (int q = 0; q < VEC; ++q) acc[q] = 0.f;
            }
        }
    }
}

// y = post * sum at row r's columns col .. col + VEC, each product rounded once
template <int VEC>
__device__ __forceinline__ void finish(const ViewSum& a, int r, size_t col, const float (&sum)[VEC], float post) {
    float y[VEC];
#pragma unroll
    for (int q = 0; q < VEC; ++q) y[q] = __fmul_rn(sum[q], post);
    store_row<VEC>(a.out + static_cast<size_t>(r) * a.d + col, y);
}

// An item of rows [r0, r0 + nr), nr <= MAX_ROWS, slots [s0, s0 + n), n <=
// CHUNK, staged in st. Lane l holds rows k = l + LANES * i: its end
// (relative to s0) and scale, read by shuffle where the group needs them.
template <int VEC, int LANES, bool HAS_VAL>
__device__ __forceinline__ void sum_rows(const ViewSum& a, const Item& it, const Stage& st,
                                         const Group<LANES>& g) {
    constexpr int RPL = MAX_ROWS / LANES;  // rows a lane holds
    constexpr unsigned LANE_BITS = LANES == 32 ? FULL : (1u << LANES) - 1;
    const int r0 = it.wk.x, nr = it.wk.y;
    int end[RPL];
    float post[RPL];
    unsigned live = 0;  // bit k: row r0 + k holds a slot
#pragma unroll
    for (int i = 0; i < RPL; ++i) {
        const int k = g.l + LANES * i;
        const bool in = k < nr;
        const int e = in ? static_cast<int>(st.ptr[k + 1] - it.s0) : 0;
        const int b = in ? static_cast<int>(st.ptr[k] - it.s0) : 0;
        end[i] = e;
        post[i] = in && a.post != nullptr ? st.post[k] : 1.f;
        live |= ((__ballot_sync(g.mask, e > b) >> g.leader) & LANE_BITS) << (LANES * i);
    }
    // row k's end and scale, from the lane that holds them (k alike in the group)
    auto end_of = [&](int k) {
        return __shfl_sync(g.mask, RPL == 1 || k < LANES ? end[0] : end[RPL - 1], g.leader + k % LANES);
    };
    auto post_of = [&](int k) {
        return __shfl_sync(g.mask, RPL == 1 || k < LANES ? post[0] : post[RPL - 1], g.leader + k % LANES);
    };
    const int nvec = a.d / VEC;
    const unsigned rows = nr == 32 ? FULL : (1u << nr) - 1;
    for (unsigned empty = rows & ~live; empty != 0; empty &= empty - 1) {
        const int k = __ffs(empty) - 1;
        const float p = post_of(k);
        const float zero[VEC] = {};
        for (int cv = g.l; cv < nvec; cv += LANES) finish<VEC>(a, r0 + k, static_cast<size_t>(cv) * VEC, zero, p);
    }
    if (live == 0) return;
    for (int c0 = 0; c0 < nvec; c0 += LANES) {
        const int cv = c0 + g.l;
        const bool col_ok = cv < nvec;
        const size_t col = static_cast<size_t>(cv) * VEC;
        int k = __ffs(live) - 1;
        int e = end_of(k);
        float p = post_of(k);
        stream<VEC, HAS_VAL>(a, st, it.n, col_ok, a.src + col, [&](int t, const float (&acc)[VEC]) {
            if (t + 1 != e) return false;
            if (col_ok) finish<VEC>(a, r0 + k, col, acc, p);
            const unsigned rest = live & ~((2u << k) - 1);  // the live rows after k (none past row 31)
            if (rest != 0) {
                k = __ffs(rest) - 1;
                e = end_of(k);
                p = post_of(k);
            }
            return true;
        });
    }
}

// An item that is piece `piece` of split row r (its first partial `part`,
// its `pieces`), staged in st: the piece's sum to its partial row; the
// group that finishes the row's last piece adds the pieces' sums in piece
// order and writes y, as P1 does
template <int VEC, int LANES, bool HAS_VAL>
__device__ __forceinline__ void sum_piece(const ViewSum& a, const Item& it, const Stage& st,
                                          const Group<LANES>& g) {
    const int r = it.wk.x, piece = it.wk.y, part = it.wk.z, pieces = it.wk.w;
    const int nvec = a.d / VEC;
    for (int c0 = 0; c0 < nvec; c0 += LANES) {
        const int cv = c0 + g.l;
        const bool col_ok = cv < nvec;
        const size_t col = static_cast<size_t>(cv) * VEC;
        stream<VEC, HAS_VAL>(a, st, it.n, col_ok, a.src + col, [&](int t, const float (&acc)[VEC]) {
            if (t + 1 != it.n) return false;
            if (col_ok) store_row<VEC>(a.partial + static_cast<size_t>(part + piece) * a.d + col, acc);
            return true;
        });
    }
    if (!last_piece(a.count, part, pieces, g.mask, g.l, g.leader)) return;
    const float p = a.post != nullptr ? __ldg(a.post + r) : 1.f;
    for (int cv = g.l; cv < nvec; cv += LANES) {
        const size_t col = static_cast<size_t>(cv) * VEC;
        float acc[VEC], q[VEC];
        load_partial<VEC>(a.partial + static_cast<size_t>(part) * a.d + col, acc);
#pragma unroll 1  // kept rolled: the compiler's unrolling of it slowed the whole kernel
        for (int c = 1; c < pieces; ++c) {
            load_partial<VEC>(a.partial + static_cast<size_t>(part + c) * a.d + col, q);
#pragma unroll
            for (int i = 0; i < VEC; ++i) acc[i] = __fadd_rn(acc[i], q[i]);
        }
        finish<VEC>(a, r, col, acc, p);
    }
}

// LANES lanes per item (16 or 32). Persistent groups, each taking the
// items g, g + G, .. (G the grid's groups) on its own: while it sums one
// item, the next one's operands are on their way into its other stage
// and the header of the one after that into registers.
template <int VEC, int LANES, bool HAS_VAL>
__global__ void __launch_bounds__(WARPS * 32, MIN_BLOCKS)
segment_sum_kernel(const ViewSum a) {
    extern __shared__ __align__(16) unsigned char stage_smem[];
    const Group<LANES> g;
    constexpr int PER_BLOCK = WARPS * 32 / LANES;
    Stage* stages = reinterpret_cast<Stage*>(stage_smem) + 2 * (threadIdx.x / LANES);
    const int step = gridDim.x * PER_BLOCK;
    int w = blockIdx.x * PER_BLOCK + static_cast<int>(threadIdx.x) / LANES;
    if (w >= a.n_work) return;
    Item cur = load_item(a, w);
    stage_item<LANES, HAS_VAL>(a, cur, stages[0], g.l);
    cp_async_commit();
    Item next = load_item(a, w + step);
    for (int i = 0; w < a.n_work; w += step, ++i) {
        if (w + step < a.n_work) stage_item<LANES, HAS_VAL>(a, next, stages[(i + 1) & 1], g.l);
        cp_async_commit();
        const Item after = load_item(a, w + 2 * step);
        cp_async_wait<1>();
        __syncwarp(g.mask);  // the group's copies of this item are in
        const Stage& st = stages[i & 1];
        if (cur.wk.z < 0)
            sum_rows<VEC, LANES, HAS_VAL>(a, cur, st, g);
        else
            sum_piece<VEC, LANES, HAS_VAL>(a, cur, st, g);
        __syncwarp(g.mask);  // this stage is read before it is refilled
        cur = next;
        next = after;
    }
}

bool aligned16(const void* p) { return p == nullptr || (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

// One launch: persistent blocks, as many as the card holds at once (asked
// once per device, cached in `resident`), at most one an item group
template <int VEC, int LANES, bool HAS_VAL>
int launch(const ViewSum& a, cudaStream_t stream) {
    static int resident[64] = {};  // per device ordinal, 0 until asked
    constexpr int PER_BLOCK = WARPS * 32 / LANES;
    constexpr size_t SMEM = 2 * PER_BLOCK * sizeof(Stage);
    const auto kernel = segment_sum_kernel<VEC, LANES, HAS_VAL>;
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess || dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
    if (resident[dev] == 0) {
        int per_sm = 0, sms = 0;
        if (cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                   static_cast<int>(SMEM)))
            return static_cast<int>(err);
        if (cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, WARPS * 32, SMEM))
            return static_cast<int>(err);
        if (cudaError_t err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev))
            return static_cast<int>(err);
        resident[dev] = per_sm * sms;
    }
    if (resident[dev] <= 0) return static_cast<int>(cudaErrorLaunchOutOfResources);
    const int blocks = (a.n_work + PER_BLOCK - 1) / PER_BLOCK;
    kernel<<<blocks < resident[dev] ? blocks : resident[dev], WARPS * 32, SMEM, stream>>>(a);
    return static_cast<int>(cudaGetLastError());
}

// lanes per item: 16 where a row is at most 16 loads wide (d = 64 in f32),
// else a warp
template <int VEC>
int dispatch(const ViewSum& a, cudaStream_t stream) {
    if (a.d / VEC <= 16)
        return a.val != nullptr ? launch<VEC, 16, true>(a, stream) : launch<VEC, 16, false>(a, stream);
    return a.val != nullptr ? launch<VEC, 32, true>(a, stream) : launch<VEC, 32, false>(a, stream);
}

}  // namespace

// Plain C interface for ctypes: returns the CUDA error code (0 on success).
// P2: a memset of the split rows' counters, then one launch. src f32 [N, d];
// idx i32 [S]; row_ptr i64 [R + 1]; work i32 [n_work, 4] and work_start i64
// [n_work + 1] (ops/segment.py::sum_schedule); val f32 [S] and post f32 [R]
// may be null; partial f32 [n_partials, d] scratch and count i32
// [n_partials], null where no row is split (n_partials 0); out f32 [R, d].
// The wrapper checks devices, types, shapes and contiguity; n_work >= 1.
extern "C" int segment_sum(const float* src, const int* idx, const long long* row_ptr,
                           const int* work, const long long* work_start, int n_work,
                           const float* val, const float* post, int d, float* partial, int* count,
                           int n_partials, float* out, void* stream) {
    const ViewSum a{src, idx, reinterpret_cast<const int4*>(work), work_start, n_work, row_ptr,
                    val, post, d, partial, count, out};
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (n_partials > 0) {
        if (cudaError_t err = cudaMemsetAsync(count, 0, sizeof(int) * n_partials, s))
            return static_cast<int>(err);
    }
    const bool rows16 = aligned16(src) && aligned16(partial) && aligned16(out);
    return d % 4 == 0 && rows16 ? dispatch<4>(a, s) : dispatch<1>(a, s);
}

extern "C" const char* segment_sum_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}
