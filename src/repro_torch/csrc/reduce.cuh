// Shared pieces of the two-stage deterministic reductions (dot, axpydot).
//
// Stage 1 runs a fixed grid of blocks; block b streams the contiguous chunk
// [b*chunk, min(n, (b+1)*chunk)) with 16-byte loads, accumulates in fp32
// per thread, and reduces warp by shuffle, then block through shared
// memory, to one partial. Stage 2 sums the partials in a fixed order: one
// more block, or (last_block) the block that takes the last integer ticket
// of stage 1. The sums take no atomics: the same inputs give byte-identical
// results.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace repro {

constexpr int kThreads = 256;     // threads per block, both stages
constexpr int kVecBytes = 16;     // one vector load per thread and step

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// Sum of `v` over the block, valid in thread 0; fixed reduction tree.
__device__ __forceinline__ float block_sum(float v) {
  __shared__ float warp_sums[kThreads / 32];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_sums[warp] = v;
  __syncthreads();
  v = threadIdx.x < kThreads / 32 ? warp_sums[threadIdx.x] : 0.0f;
  if (warp == 0) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  }
  return v;
}

// Write the block's sum `v` (valid in thread 0) to partials[blockIdx.x]
// and take an integer ticket. True, in every thread, in the one block that
// takes the last ticket: every partial is visible to it (read them with
// __ldcg, past the SM's L1).
__device__ __forceinline__ bool last_block(float v, float* partials,
                                           unsigned* ticket) {
  __shared__ bool last;
  if (threadIdx.x == 0) {
    partials[blockIdx.x] = v;
    __threadfence();
    last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  return last;
}

// Stage 2: out[0] = sum of partials[0:count], in a fixed order.
__global__ void finish_partials(const float* __restrict__ partials,
                                float* __restrict__ out, int count) {
  float acc = 0.0f;
  for (int i = threadIdx.x; i < count; i += kThreads) acc += partials[i];
  acc = block_sum(acc);
  if (threadIdx.x == 0) out[0] = acc;
}

// Elements per block chunk: a multiple of the widest vector (8 bf16).
inline int64_t chunk_elems(int64_t n, int max_blocks) {
  int64_t chunk = (n + max_blocks - 1) / max_blocks;
  return ((chunk + 7) / 8) * 8;
}

}  // namespace repro
