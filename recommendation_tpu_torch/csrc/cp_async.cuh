// Asynchronous global -> shared copies (cp.async, sm_80 and later) for the
// port's tiled kernels. Each copy moves `size` bytes (4, 8 or 16) and reads
// only `bytes` of them from global memory, filling the rest of the
// destination with zeros: `bytes` 0 zero-fills the whole copy and reads
// nothing, which is how a tile's ragged edge is masked. A thread sees its
// own copies after cp_async_wait; other threads see them after a
// __syncthreads that follows that wait.
#pragma once

#include <cuda_runtime.h>

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int bytes) {
    const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem),
                 "r"(bytes));
}

__device__ __forceinline__ void cp_async8(void* smem, const void* gmem, int bytes) {
    const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(dst), "l"(gmem),
                 "r"(bytes));
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem, int bytes) {
    const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(gmem),
                 "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

// wait until at most N of this thread's committed groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}
