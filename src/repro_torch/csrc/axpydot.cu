// axpydot: r = sum_i (a * x[i] + y[i]) * w[i] in fp32, for x, y, w of (N,)
// fp32 or bf16 and a scalar a passed by value.
//
// Replaces the TPU kernel repro/kernels/axpydot/kernel.py::axpydot (the
// paper's streaming-composition pipeline: z = a*x + y never leaves VMEM;
// an (8, 128) partial-sum tile carried across the sequential grid). Bound
// on the H100 by bytes: it reads 12 B (fp32) or 6 B (bf16) per element
// once, so N = 209,715,200 fp32 needs 2.52 GB, about 0.75 ms at 3.35 TB/s.
// z lives only in registers. A fixed grid of blocks each streams one
// contiguous chunk with 16-byte loads; the cross-block sum is a second pass
// over the partials in a fixed order (no atomics), so repeat runs are
// byte-identical. The ragged tail is masked, not padded.
#include "reduce.cuh"

namespace {

template <typename T, bool kVec>
__global__ void axpydot_partials(float a, const T* __restrict__ x,
                                 const T* __restrict__ y,
                                 const T* __restrict__ w,
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
    const uint4* yv = reinterpret_cast<const uint4*>(y + start);
    const uint4* wv = reinterpret_cast<const uint4*>(w + start);
    for (int64_t k = threadIdx.x; k < nvec; k += repro::kThreads) {
      const uint4 xa = xv[k], ya = yv[k], wa = wv[k];
      const T* tx = reinterpret_cast<const T*>(&xa);
      const T* ty = reinterpret_cast<const T*>(&ya);
      const T* tw = reinterpret_cast<const T*>(&wa);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float z = a * repro::to_f32(tx[j]) + repro::to_f32(ty[j]);
        acc += z * repro::to_f32(tw[j]);
      }
    }
    i = start + nvec * V;
  }
  for (int64_t k = i + threadIdx.x; k < end; k += repro::kThreads) {
    const float z = a * repro::to_f32(x[k]) + repro::to_f32(y[k]);
    acc += z * repro::to_f32(w[k]);
  }
  acc = repro::block_sum(acc);
  if (threadIdx.x == 0) partials[blockIdx.x] = acc;
}

template <typename T>
void launch(float a, const void* x, const void* y, const void* w,
            float* partials, int64_t n, int64_t chunk, int blocks, bool vec,
            cudaStream_t s) {
  const T* xp = static_cast<const T*>(x);
  const T* yp = static_cast<const T*>(y);
  const T* wp = static_cast<const T*>(w);
  if (vec)
    axpydot_partials<T, true><<<blocks, repro::kThreads, 0, s>>>(a, xp, yp, wp, partials, n, chunk);
  else
    axpydot_partials<T, false><<<blocks, repro::kThreads, 0, s>>>(a, xp, yp, wp, partials, n, chunk);
}

}  // namespace

// dtype: 0 = fp32, 1 = bf16. `partials` holds at least `max_blocks`
// floats; `out` one float. Returns cudaGetLastError() after both launches.
extern "C" int axpydot_launch(float a, const void* x, const void* y,
                              const void* w, void* partials, void* out,
                              int64_t n, int dtype, int max_blocks, int vec,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* parts = static_cast<float*>(partials);
  const int64_t chunk = repro::chunk_elems(n, max_blocks);
  const int blocks = n > 0 ? static_cast<int>((n + chunk - 1) / chunk) : 0;
  if (blocks > 0) {
    if (dtype == 0)
      launch<float>(a, x, y, w, parts, n, chunk, blocks, vec != 0, s);
    else
      launch<__nv_bfloat16>(a, x, y, w, parts, n, chunk, blocks, vec != 0, s);
  }
  repro::finish_partials<<<1, repro::kThreads, 0, s>>>(parts, static_cast<float*>(out), blocks);
  return static_cast<int>(cudaGetLastError());
}
