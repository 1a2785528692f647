// dot: r = sum_i x[i] * w[i] in fp32, for x, w of (N,) fp32 or bf16.
//
// Replaces the TPU kernel repro/kernels/dot/kernel.py::dot (an (8, 128)
// VMEM partial-sum tile carried across the sequential grid). Bound on the
// H100 by bytes: it reads 8 B (fp32) or 4 B (bf16) per element once, so
// N = 209,715,200 fp32 needs 1.68 GB, about 0.50 ms at 3.35 TB/s. To keep
// the memory busy the card needs tens of KB in flight on every SM: a fixed
// grid of G blocks sized by the wrapper to the SM count (4 of 256 threads an
// SM) walks the vectors together, thread t of block b taking 16-byte
// vectors b * 256 + t + i * G * 256, so that at any time the grid reads one
// contiguous front of each operand; every thread issues kUnroll independent
// loads per operand (64 B each) before it accumulates them. (The first
// design gave each block one contiguous chunk: 1,056 streams far apart,
// which kept the memory less busy.)
// The cross-block sum is folded into the same launch: each block writes its
// partial and takes an integer ticket, and the block that takes the last
// ticket sums the partials in index order and resets the ticket. The sums
// take no atomics and each thread's terms are fixed, so repeat runs are
// byte-identical. The ragged tail is masked.
#include "reduce.cuh"

namespace {

constexpr int kUnroll = 4;   // 16-byte loads per operand in flight a thread

template <typename T>
__device__ __forceinline__ float vec_dot(const uint4& a, const uint4& b) {
  constexpr int V = repro::kVecBytes / sizeof(T);
  const T* ta = reinterpret_cast<const T*>(&a);
  const T* tb = reinterpret_cast<const T*>(&b);
  float s = 0.0f;
#pragma unroll
  for (int j = 0; j < V; ++j) s += repro::to_f32(ta[j]) * repro::to_f32(tb[j]);
  return s;
}

template <typename T, bool kVec>
__global__ void __launch_bounds__(repro::kThreads)
dot_kernel(const T* __restrict__ x, const T* __restrict__ w,
           float* __restrict__ partials, unsigned* __restrict__ ticket,
           float* __restrict__ out, int64_t n) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * repro::kThreads;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * repro::kThreads +
                        threadIdx.x;
  float acc = 0.0f;
  int64_t i = 0;
  if (kVec) {
    constexpr int V = repro::kVecBytes / sizeof(T);
    const int64_t nvec = n / V;
    const uint4* xv = reinterpret_cast<const uint4*>(x);
    const uint4* wv = reinterpret_cast<const uint4*>(w);
    int64_t k = first;
    for (; k + (kUnroll - 1) * stride < nvec; k += kUnroll * stride) {
      uint4 a[kUnroll], b[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        a[u] = __ldg(xv + k + u * stride);
        b[u] = __ldg(wv + k + u * stride);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) acc += vec_dot<T>(a[u], b[u]);
    }
    for (; k < nvec; k += stride) acc += vec_dot<T>(xv[k], wv[k]);
    i = nvec * V;
  }
  for (int64_t k = i + first; k < n; k += stride)
    acc += repro::to_f32(x[k]) * repro::to_f32(w[k]);
  acc = repro::block_sum(acc);
  if (repro::last_block(acc, partials, ticket)) {
    float s = 0.0f;
    for (int b = threadIdx.x; b < gridDim.x; b += repro::kThreads)
      s += __ldcg(partials + b);
    s = repro::block_sum(s);
    if (threadIdx.x == 0) {
      out[0] = s;
      *ticket = 0u;   // ready for the next launch on this scratch
    }
  }
}

template <typename T>
void launch(const void* x, const void* w, float* partials, unsigned* ticket,
            float* out, int64_t n, int blocks, bool vec, cudaStream_t s) {
  const T* xp = static_cast<const T*>(x);
  const T* wp = static_cast<const T*>(w);
  if (vec)
    dot_kernel<T, true><<<blocks, repro::kThreads, 0, s>>>(xp, wp, partials, ticket, out, n);
  else
    dot_kernel<T, false><<<blocks, repro::kThreads, 0, s>>>(xp, wp, partials, ticket, out, n);
}

}  // namespace

// dtype: 0 = fp32, 1 = bf16. `scratch` holds `blocks` floats of partials
// followed by one unsigned ticket that is 0 between launches; `out` one
// float. One launch of `blocks` blocks; returns cudaGetLastError() after it.
extern "C" int dot_launch(const void* x, const void* w, void* scratch,
                          void* out, int64_t n, int dtype, int blocks,
                          int vec, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* parts = static_cast<float*>(scratch);
  unsigned* ticket = reinterpret_cast<unsigned*>(parts + blocks);
  if (dtype == 0)
    launch<float>(x, w, parts, ticket, static_cast<float*>(out), n, blocks, vec != 0, s);
  else
    launch<__nv_bfloat16>(x, w, parts, ticket, static_cast<float*>(out), n, blocks, vec != 0, s);
  return static_cast<int>(cudaGetLastError());
}
