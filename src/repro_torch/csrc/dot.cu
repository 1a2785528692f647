// dot: r = sum_i x[i] * w[i] in fp32, for x, w of (N,) fp32 or bf16.
//
// Replaces the TPU kernel repro/kernels/dot/kernel.py::dot (an (8, 128)
// VMEM partial-sum tile carried across the sequential grid). Bound on the
// H100 by bytes: it reads 8 B (fp32) or 4 B (bf16) per element once, so
// N = 209,715,200 fp32 needs 1.68 GB, about 0.50 ms at 3.35 TB/s. The
// design keeps every byte one 16-byte load: a fixed grid of blocks each
// streams one contiguous chunk with vector loads, and the cross-block sum
// is a second pass over the partials in a fixed order (no atomics), so
// repeat runs are byte-identical. The ragged tail is masked, not padded.
#include "reduce.cuh"

namespace {

template <typename T, bool kVec>
__global__ void dot_partials(const T* __restrict__ x, const T* __restrict__ w,
                             float* __restrict__ partials, int64_t n,
                             int64_t chunk) {
  const int64_t start = blockIdx.x * chunk;
  const int64_t end = start + chunk < n ? start + chunk : n;
  float acc = 0.0f;
  int64_t i = start;
  if (kVec) {
    constexpr int V = repro::kVecBytes / sizeof(T);
    const int64_t nvec = (end - start) / V;
    const uint4* xv = reinterpret_cast<const uint4*>(x + start);
    const uint4* wv = reinterpret_cast<const uint4*>(w + start);
    for (int64_t k = threadIdx.x; k < nvec; k += repro::kThreads) {
      const uint4 a = xv[k], b = wv[k];
      const T* ta = reinterpret_cast<const T*>(&a);
      const T* tb = reinterpret_cast<const T*>(&b);
#pragma unroll
      for (int j = 0; j < V; ++j) acc += repro::to_f32(ta[j]) * repro::to_f32(tb[j]);
    }
    i = start + nvec * V;
  }
  for (int64_t k = i + threadIdx.x; k < end; k += repro::kThreads)
    acc += repro::to_f32(x[k]) * repro::to_f32(w[k]);
  acc = repro::block_sum(acc);
  if (threadIdx.x == 0) partials[blockIdx.x] = acc;
}

template <typename T>
void launch(const void* x, const void* w, float* partials, int64_t n,
            int64_t chunk, int blocks, bool vec, cudaStream_t s) {
  const T* xp = static_cast<const T*>(x);
  const T* wp = static_cast<const T*>(w);
  if (vec)
    dot_partials<T, true><<<blocks, repro::kThreads, 0, s>>>(xp, wp, partials, n, chunk);
  else
    dot_partials<T, false><<<blocks, repro::kThreads, 0, s>>>(xp, wp, partials, n, chunk);
}

}  // namespace

// dtype: 0 = fp32, 1 = bf16. `partials` holds at least `max_blocks`
// floats; `out` one float. Returns cudaGetLastError() after both launches.
extern "C" int dot_launch(const void* x, const void* w, void* partials,
                          void* out, int64_t n, int dtype, int max_blocks,
                          int vec, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* parts = static_cast<float*>(partials);
  const int64_t chunk = repro::chunk_elems(n, max_blocks);
  const int blocks = n > 0 ? static_cast<int>((n + chunk - 1) / chunk) : 0;
  if (blocks > 0) {
    if (dtype == 0)
      launch<float>(x, w, parts, n, chunk, blocks, vec != 0, s);
    else
      launch<__nv_bfloat16>(x, w, parts, n, chunk, blocks, vec != 0, s);
  }
  repro::finish_partials<<<1, repro::kThreads, 0, s>>>(parts, static_cast<float*>(out), blocks);
  return static_cast<int>(cudaGetLastError());
}
