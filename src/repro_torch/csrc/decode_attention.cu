// decode_attention: one-token masked attention over a gathered context.
// q (B, H, Dh), k and v (B, C, H, Dh) already GQA-repeated, both fp32 or
// both bf16; pos (B,) int32; out (B, H, Dh) in q's type:
//
//   s_j   = (q . k_j) / sqrt(Dh)          for j <= pos[b]
//                                         (and j > pos[b] - window),
//   s_j   = -1e30                         otherwise,
//   out   = sum_j softmax(s)_j v_j.
//
// Replaces the TPU kernel repro/kernels/attention/decode.py::
// decode_attention, a (B, H) Pallas grid whose cell holds a (C, Dh) K and
// V slab in VMEM, takes pos as a prefetched scalar, and computes the score
// vector, mask, softmax and p @ V on whole arrays. Here one block of 256
// threads owns one (b, h) row:
//   * q is staged in shared memory as fp32; each warp takes the key
//     positions j = warp, warp + 8, ... and computes the dot product with
//     its lanes striding Dh (coalesced 32-lane reads of one K row), reduced
//     by a fixed shuffle tree. The fp32 scores of all C positions stay in
//     shared memory. A masked position's K row is never read: its score is
//     -1e30, as the reference writes it.
//   * the block max and the sum of exp(s_j - max) are deterministic block
//     reductions (warp shuffles, then one warp over the warp results); the
//     exponentials overwrite the scores.
//   * out: each thread owns one column d of Dh and one of 256 / Dh groups
//     of key positions (j = g, g + groups, ...), summing p_j v_j in fp32 in
//     order; the groups' partial sums are added in group order through
//     shared memory, and the sum is divided by the normalizer once. Rows
//     with p_j == 0 (masked positions, whose exponential underflows) are
//     skipped, so pool garbage past pos is never read.
// No atomics: the same inputs give byte-identical results. The scores take
// 4 C bytes of shared memory; the wrapper refuses a context that does not
// fit the 227 KB a block may use (kernels/attention/kernel.py).
//
// Bound on the H100 by bytes: K and V are read once (2 B C H Dh elements),
// about 2 flops per element each; at the serving shapes (B = 64, C = 48,
// H = 24, Dh = 128, bf16) that is 37.7 MB, 11 us at 3.35 TB/s.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// The block's sum (is_max = false) or max of v, in every thread; `red`
// holds kWarps floats of shared memory. A fixed reduction tree.
__device__ __forceinline__ float block_reduce(float v, float* red, bool is_max) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = is_max ? warp_max(v) : warp_sum(v);
  __syncthreads();  // red may still be read by an earlier reduction
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float r = lane < kWarps ? red[lane] : (is_max ? kNegInf : 0.0f);
  return is_max ? warp_max(r) : warp_sum(r);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
decode_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const int* __restrict__ pos,
                        T* __restrict__ out, int C, int H, int Dh, int window,
                        float scale) {
  extern __shared__ float smem[];
  float* s = smem;                  // C scores, then their exponentials
  float* qs = s + C;                // Dh
  float* red = qs + Dh;             // kWarps
  float* part = red + kWarps;       // kThreads partial column sums
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int p = pos[b];
  const int64_t row = static_cast<int64_t>(H) * Dh;   // one key position
  const int64_t base = static_cast<int64_t>(b) * C * row +
                       static_cast<int64_t>(h) * Dh;

  const T* qr = q + (static_cast<int64_t>(b) * H + h) * Dh;
  for (int d = tid; d < Dh; d += kThreads) qs[d] = to_f32(qr[d]);
  __syncthreads();

  for (int j = warp; j < C; j += kWarps) {
    const bool keep = j <= p && (window <= 0 || j > p - window);
    float acc = 0.0f;
    if (keep) {
      const T* kr = k + base + j * row;
      for (int d = lane; d < Dh; d += 32) acc += qs[d] * to_f32(kr[d]);
      acc = warp_sum(acc);
    }
    if (lane == 0) s[j] = keep ? acc * scale : kNegInf;
  }
  __syncthreads();

  float m = kNegInf;
  for (int j = tid; j < C; j += kThreads) m = fmaxf(m, s[j]);
  m = block_reduce(m, red, true);
  float l = 0.0f;
  for (int j = tid; j < C; j += kThreads) {
    const float e = expf(s[j] - m);
    s[j] = e;
    l += e;
  }
  l = block_reduce(l, red, false);   // its barrier also publishes s[]

  T* orow = out + (static_cast<int64_t>(b) * H + h) * Dh;
  const float inv = 1.0f / l;
  if (Dh <= kThreads) {
    const int groups = kThreads / Dh;
    const int g = tid / Dh, d = tid % Dh;
    float acc = 0.0f;
    if (g < groups) {
      const T* vc = v + base + d;
      for (int j = g; j < C; j += groups) {
        const float pj = s[j];
        if (pj != 0.0f) acc += pj * to_f32(vc[j * row]);
      }
      part[tid] = acc;
    }
    __syncthreads();
    if (g == 0) {
      for (int gg = 1; gg < groups; ++gg) acc += part[gg * Dh + d];
      store(orow + d, acc * inv);
    }
  } else {
    for (int d = tid; d < Dh; d += kThreads) {
      const T* vc = v + base + d;
      float acc = 0.0f;
      for (int j = 0; j < C; ++j) {
        const float pj = s[j];
        if (pj != 0.0f) acc += pj * to_f32(vc[j * row]);
      }
      store(orow + d, acc * inv);
    }
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const int* pos,
           void* out, int B, int C, int H, int Dh, int window, float scale,
           size_t smem, cudaStream_t s) {
  auto kern = decode_attention_kernel<T>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kern<<<B * H, kThreads, smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), pos, static_cast<T*>(out), C, H, Dh, window,
      scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Shared memory one block takes, in bytes (the wrapper checks it against
// the 227 KB limit before launching).
extern "C" int64_t decode_attention_smem(int C, int Dh) {
  return static_cast<int64_t>(sizeof(float)) * (C + Dh + kWarps + kThreads);
}

// dtype: 0 = fp32, 1 = bf16, of q, k, v and out; all contiguous. window
// <= 0 means no sliding window. Returns cudaGetLastError() after the launch.
extern "C" int decode_attention_launch(const void* q, const void* k,
                                       const void* v, const void* pos,
                                       void* out, int B, int C, int H, int Dh,
                                       int window, float scale, int dtype,
                                       void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = static_cast<size_t>(decode_attention_smem(C, Dh));
  if (B <= 0 || H <= 0 || C <= 0 || Dh <= 0) return 0;
  const int* p = static_cast<const int*>(pos);
  if (dtype == 0)
    return launch<float>(q, k, v, p, out, B, C, H, Dh, window, scale, smem, s);
  return launch<__nv_bfloat16>(q, k, v, p, out, B, C, H, Dh, window, scale,
                               smem, s);
}
