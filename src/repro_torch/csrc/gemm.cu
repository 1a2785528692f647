// matmul: C = act(A @ B + bias) with fp32 accumulation, for A (M, K) and
// B (K, N) both fp32 or both bf16, bias (N,) fp32 or absent, C (M, N) in
// A's type; act is none, relu, silu or tanh-gelu.
//
// Replaces the TPU kernel repro/kernels/gemm/kernel.py::matmul, a
// (bm, bk, bn) Pallas grid whose innermost K dimension carries an fp32 VMEM
// scratch tile across grid steps and whose ragged edges are zero-padded
// copies of A and B. A CUDA grid has no order and no scratch carried
// between blocks, so each block owns one (BM, BN) output tile and loops
// over K itself, with the fp32 accumulator in registers: BK = 16 slices
// of A and B are staged in shared memory (as fp32), and each thread
// accumulates a TM x TN sub-tile with IEEE fp32 FMAs (no TF32: the
// reference's rtol = atol = 2e-4 is below what TF32 keeps). The ragged
// edges are masked loads and stores; nothing is padded or copied. The
// epilogue applies bias, then the activation, in fp32 before the one store.
//
// Bound on the H100: the paper's LeNet shapes are skinny (N = 6..120,
// K = 25..256), so they are bound by bytes (A is read once per column
// tile, C written once) at 3.35 TB/s; a square 4096^3 product is bound by
// operations (2 M N K at 67 TFLOP/s in fp32 outside the tensor cores, or
// 989 TFLOP/s dense bf16 on them, which this FMA kernel does not use). The
// tile shape follows N so that a narrow output does not leave most of a
// square tile's columns masked: N <= 16 takes 256 x 16 tiles, N <= 64
// 128 x 64, wider 128 x 128 (256 threads each).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int BK = 16;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// the activations of repro/kernels/gemm/kernel.py::_act, in fp32
__device__ __forceinline__ float activate(float x, int act) {
  switch (act) {
    case 1: return fmaxf(x, 0.0f);
    case 2: return x / (1.0f + expf(-x));
    case 3: return 0.5f * x * (1.0f + tanhf(0.7978845608028654f *
                                             (x + 0.044715f * x * x * x)));
    default: return x;
  }
}

template <typename T, int BM, int BN, int TM, int TN>
__global__ void __launch_bounds__(kThreads)
matmul_kernel(const T* __restrict__ A, const T* __restrict__ B,
              const float* __restrict__ bias, T* __restrict__ C, int64_t M,
              int N, int K, int64_t sam, int64_t sak, int64_t sbk,
              int64_t sbn, int act) {
  static_assert((BM / TM) * (BN / TN) == kThreads, "one sub-tile a thread");
  __shared__ float As[BK][BM];
  __shared__ float Bs[BK][BN];
  const int tid = threadIdx.x;
  const int tr = tid / (BN / TN), tc = tid % (BN / TN);
  const int64_t m0 = static_cast<int64_t>(blockIdx.x) * BM;
  const int n0 = blockIdx.y * BN;
  // neighbouring threads load neighbouring addresses of either layout
  const bool a_k_fast = sak == 1 || sam != 1;
  const bool b_n_fast = sbn == 1 || sbk != 1;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    for (int e = tid; e < BM * BK; e += kThreads) {
      const int r = a_k_fast ? e / BK : e % BM;
      const int kk = a_k_fast ? e % BK : e / BM;
      const int64_t m = m0 + r;
      const int k = k0 + kk;
      As[kk][r] = (m < M && k < K) ? to_f32(A[m * sam + k * sak]) : 0.0f;
    }
    for (int e = tid; e < BK * BN; e += kThreads) {
      const int c = b_n_fast ? e % BN : e / BK;
      const int kk = b_n_fast ? e / BN : e % BK;
      const int n = n0 + c;
      const int k = k0 + kk;
      Bs[kk][c] = (n < N && k < K) ? to_f32(B[k * sbk + n * sbn]) : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = As[kk][tr * TM + i];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = Bs[kk][tc * TN + j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int64_t m = m0 + tr * TM + i;
    if (m >= M) break;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = n0 + tc * TN + j;
      if (n >= N) break;
      float v = acc[i][j];
      if (bias != nullptr) v += bias[n];
      store(&C[m * N + n], activate(v, act));
    }
  }
}

template <typename T, int BM, int BN, int TM, int TN>
void launch(const void* a, const void* b, const float* bias, void* c,
            int64_t M, int N, int K, int64_t sam, int64_t sak, int64_t sbk,
            int64_t sbn, int act, cudaStream_t s) {
  const dim3 grid(static_cast<unsigned>((M + BM - 1) / BM), (N + BN - 1) / BN);
  matmul_kernel<T, BM, BN, TM, TN><<<grid, kThreads, 0, s>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), bias,
      static_cast<T*>(c), M, N, K, sam, sak, sbk, sbn, act);
}

template <typename T>
void launch_tiles(int tiles, const void* a, const void* b, const float* bias,
                  void* c, int64_t M, int N, int K, int64_t sam, int64_t sak,
                  int64_t sbk, int64_t sbn, int act, cudaStream_t s) {
  if (tiles == 0)
    launch<T, 256, 16, 4, 4>(a, b, bias, c, M, N, K, sam, sak, sbk, sbn, act, s);
  else if (tiles == 1)
    launch<T, 128, 64, 8, 4>(a, b, bias, c, M, N, K, sam, sak, sbk, sbn, act, s);
  else
    launch<T, 128, 128, 8, 8>(a, b, bias, c, M, N, K, sam, sak, sbk, sbn, act, s);
}

}  // namespace

// dtype: 0 = fp32, 1 = bf16, of A, B and C. `bias` may be null. Strides
// are in elements; C is contiguous. `tiles` picks the tile shape
// (0: 256 x 16, 1: 128 x 64, 2: 128 x 128). Returns cudaGetLastError()
// after the launch.
extern "C" int matmul_launch(const void* a, const void* b, const void* bias,
                             void* c, int64_t M, int N, int K, int64_t sam,
                             int64_t sak, int64_t sbk, int64_t sbn, int dtype,
                             int act, int tiles, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* bp = static_cast<const float*>(bias);
  if (M > 0 && N > 0) {
    if (dtype == 0)
      launch_tiles<float>(tiles, a, b, bp, c, M, N, K, sam, sak, sbk, sbn, act, s);
    else
      launch_tiles<__nv_bfloat16>(tiles, a, b, bp, c, M, N, K, sam, sak, sbk, sbn, act, s);
  }
  return static_cast<int>(cudaGetLastError());
}
