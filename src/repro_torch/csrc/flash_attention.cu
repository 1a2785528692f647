// flash_attention: the prefill attention forward pass, causal and/or
// sliding-window, with grouped-query heads. q (B, Sq, Hq, Dh), k and v
// (B, Sk, Hkv, Dh), all fp32 or all bf16, contiguous; out (B, Sq, Hq, Dh)
// in q's type. Query row r sits at position q_pos = q_offset + r, key c at
// position c; q head h reads KV head h / (Hq / Hkv):
//
//   s_rc  = (q_r / sqrt(Dh)) . k_c     if c <= q_pos (causal) and
//                                      c > q_pos - window (a window),
//   s_rc  = -1e30                      otherwise,
//   out_r = sum_c softmax(s_r)_c v_c, by an online softmax with fp32
//           (acc, m, l), divided by max(l, 1e-30) at the end.
//
// Replaces the TPU kernel repro/kernels/attention/kernel.py::
// flash_attention, a (B Hq, Sq/bq, Sk/bk) Pallas grid whose sequential KV
// axis carries (acc, m, l) in VMEM scratch from one step to the next. A
// CUDA grid carries nothing between blocks, so one block of 256 threads
// owns one (b h, 64-row query tile) and a loop inside it walks the 64-key
// tiles in order:
//   * Q of the tile is staged once in shared memory, transposed and
//     scaled; each KV tile is staged as K^T and V, each thread keeping 4
//     float4 loads of K and 4 of V in flight before it stores them (one
//     block fills an SM at Dh = 256, so nothing else hides a load's
//     latency). The (Sq, Sk) score matrix never reaches device memory: a
//     tile's 64 x 64 scores live in registers and, as probabilities, in
//     shared memory (P^T).
//   * thread (ty, tx) of a 16 x 16 layout owns query rows 4 ty .. 4 ty + 3
//     and, in a tile, keys 4 tx .. 4 tx + 3 (one float4 of Q^T and one of
//     K^T a step of Dh, 16 FMAs), and output columns 4 tx + 64 j .. + 3
//     (one float4 of P^T and J of V a key, 16 J FMAs). The row max and sum
//     over a tile are xor-shuffle trees over the 16 threads of a row, which
//     leave the same value in every one of them.
//   * tiles a query tile cannot see (past the causal diagonal, before the
//     window) are skipped. That is exact for a row with at least one
//     admitted key: a tile it sees only masked scores of before its first
//     admitted key is wiped by alpha = exp(-1e30 - m) = 0 anyway. A row
//     with no admitted key at all (q_pos - window >= Sk - 1, or q_pos < 0
//     when causal) scores -1e30 everywhere and gets the mean of V, as in
//     the reference; a block that holds such a row walks every tile.
//   * ragged edges are masked: rows past Sq are computed on zeros and not
//     stored; keys past Sk score -inf, so their probability is exactly 0
//     even in a row with no admitted key. Rows load as 4-element groups:
//     Dh is a multiple of 4 and the operands 16-byte (fp32) or 8-byte
//     (bf16) aligned (the wrapper sees to both).
// Every sum runs in a fixed order, with no atomics: the same inputs give
// byte-identical results.
//
// Bound on the H100 by operations: 4 Dh flops per admitted (q, k) pair, in
// fp32 FMAs outside the tensor cores (67 TFLOP/s); the bytes (q, k, v and
// out once) are some 30 times less at the prefill shapes. Shared memory
// takes 4 (Dh (64 + 4) 2 + 64 Dh + 64 (64 + 4)) bytes, 222,208 at
// Dh = 256; the output tile's registers (16 J floats, J = ceil(Dh / 64))
// bound Dh to 256, and the wrapper refuses wider heads
// (kernels/attention/flash.py).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;           // query rows a block owns
constexpr int kBK = 64;           // keys a tile holds
constexpr int kThreads = 256;     // 16 x 16: 4 rows x 4 keys each
constexpr int kQS = kBQ + 4;      // row stride of Q^T and P^T (float4 rows)
constexpr int kKS = kBK + 4;      // row stride of K^T
constexpr int kLoads = 4;         // float4 loads of K (and V) in flight
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// Elements d .. d + 3 of a row as fp32: one 16-byte load (fp32) or two
// 4-byte loads (bf16).
__device__ __forceinline__ float4 load4(const float* p, int d) {
  return __ldg(reinterpret_cast<const float4*>(p + d));
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p, int d) {
  const __nv_bfloat162* p2 = reinterpret_cast<const __nv_bfloat162*>(p + d);
  const float2 lo = __bfloat1622float2(p2[0]);
  const float2 hi = __bfloat1622float2(p2[1]);
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

// max / sum over the 16 threads of one query row (lanes tx = 0..15 of one
// half-warp); every lane ends with the same value
__device__ __forceinline__ float row_max(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}
__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <typename T, int J>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out, int Sq,
                       int Sk, int Hq, int Hkv, int Dh, int causal,
                       int window, int q_offset, float scale) {
  extern __shared__ __align__(16) float smem[];
  float* qt = smem;                 // Dh x kQS: Q^T of the tile, scaled
  float* kt = qt + Dh * kQS;        // Dh x kKS: K^T of the KV tile
  float* vs = kt + Dh * kKS;        // kBK x Dh: V of the KV tile
  float* pt = vs + kBK * Dh;        // kBK x kQS: P^T of the KV tile

  const int b = blockIdx.x / Hq, h = blockIdx.x % Hq;
  const int hk = h / (Hq / Hkv);
  // the last query tiles see the most keys under a causal mask: start them
  // first
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;
  const int rows = min(kBQ, Sq - q0);
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;

  const int64_t q_row = static_cast<int64_t>(Hq) * Dh;    // one position
  const int64_t k_row = static_cast<int64_t>(Hkv) * Dh;
  const T* qb = q + (static_cast<int64_t>(b) * Sq + q0) * q_row +
                static_cast<int64_t>(h) * Dh;
  const T* kb = k + static_cast<int64_t>(b) * Sk * k_row +
                static_cast<int64_t>(hk) * Dh;
  const T* vb = v + static_cast<int64_t>(b) * Sk * k_row +
                static_cast<int64_t>(hk) * Dh;

  // staging walks float4s of a row: Q and K with the row index fastest
  // (their transposed stores hit 32 banks), V with d fastest
  const int dh4 = Dh / 4;
  for (int i = tid; i < kBQ * dh4; i += kThreads) {
    const int r = i % kBQ, d = 4 * (i / kBQ);
    float4 x = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (r < rows) x = load4(qb + r * q_row, d);
    qt[(d + 0) * kQS + r] = x.x * scale;
    qt[(d + 1) * kQS + r] = x.y * scale;
    qt[(d + 2) * kQS + r] = x.z * scale;
    qt[(d + 3) * kQS + r] = x.w * scale;
  }

  // the KV tiles this query tile sees (every tile when one of its rows
  // sees no key: see the header)
  const int n_tiles = (Sk + kBK - 1) / kBK;
  const int first = q_offset + q0, last = q_offset + q0 + rows - 1;
  const bool empty_row = (causal && first < 0) ||
                         (window > 0 && last - window + 1 > Sk - 1);
  int t_lo = 0, t_hi = n_tiles - 1;
  if (!empty_row) {
    if (window > 0) t_lo = max(0, first - window + 1) / kBK;
    if (causal) t_hi = min(Sk - 1, last) / kBK;
  }

  float m[4], l[4], acc[4][4 * J];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.0f;
#pragma unroll
    for (int jj = 0; jj < 4 * J; ++jj) acc[i][jj] = 0.0f;
  }

  for (int t = t_lo; t <= t_hi; ++t) {
    const int c0 = t * kBK;
    const int cols = min(kBK, Sk - c0);
    __syncthreads();      // Q^T written; the last tile's K^T, V, P^T read
    // kLoads float4s of K and of V in flight a thread before any store
    for (int i0 = tid; i0 < kBK * dh4; i0 += kLoads * kThreads) {
      float4 kx[kLoads], vx[kLoads];
#pragma unroll
      for (int u = 0; u < kLoads; ++u) {
        const int i = i0 + u * kThreads;
        const int kc = i % kBK, kd = 4 * (i / kBK);
        const int vc = i / dh4, vd = 4 * (i - vc * dh4);
        kx[u] = vx[u] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        if (i < kBK * dh4 && kc < cols)
          kx[u] = load4(kb + static_cast<int64_t>(c0 + kc) * k_row, kd);
        if (i < kBK * dh4 && vc < cols)
          vx[u] = load4(vb + static_cast<int64_t>(c0 + vc) * k_row, vd);
      }
#pragma unroll
      for (int u = 0; u < kLoads; ++u) {
        const int i = i0 + u * kThreads;
        if (i >= kBK * dh4) break;
        const int kc = i % kBK, kd = 4 * (i / kBK);
        const int vc = i / dh4, vd = 4 * (i - vc * dh4);
        kt[(kd + 0) * kKS + kc] = kx[u].x;
        kt[(kd + 1) * kKS + kc] = kx[u].y;
        kt[(kd + 2) * kKS + kc] = kx[u].z;
        kt[(kd + 3) * kKS + kc] = kx[u].w;
        *reinterpret_cast<float4*>(vs + vc * Dh + vd) = vx[u];
      }
    }
    __syncthreads();

    // scores of rows 4 ty + i and keys 4 tx + j, summed over d in order
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < Dh; ++d) {
      const float4 a =
          *reinterpret_cast<const float4*>(qt + d * kQS + 4 * ty);
      const float4 c4 =
          *reinterpret_cast<const float4*>(kt + d * kKS + 4 * tx);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float kv[4] = {c4.x, c4.y, c4.z, c4.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(av[i], kv[j], s[i][j]);
    }

    // mask, then the online softmax of each row over this tile
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = q_offset + q0 + 4 * ty + i;
      float mt = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = c0 + 4 * tx + j;
        if (c >= Sk)
          s[i][j] = -INFINITY;
        else if ((causal && c > qp) || (window > 0 && c <= qp - window))
          s[i][j] = kNegInf;
        mt = fmaxf(mt, s[i][j]);
      }
      const float mn = fmaxf(m[i], row_max(mt));
      const float alpha = expf(m[i] - mn);
      float ls = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - mn);
        ls += s[i][j];
      }
      l[i] = l[i] * alpha + row_sum(ls);
      m[i] = mn;
#pragma unroll
      for (int jj = 0; jj < 4 * J; ++jj) acc[i][jj] *= alpha;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(pt + (4 * tx + j) * kQS + 4 * ty) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    __syncthreads();

    // acc += P V over the tile's keys in order (keys past Sk: p = v = 0)
#pragma unroll 2
    for (int c = 0; c < kBK; ++c) {
      const float4 p = *reinterpret_cast<const float4*>(pt + c * kQS + 4 * ty);
      const float pv[4] = {p.x, p.y, p.z, p.w};
#pragma unroll
      for (int jj = 0; jj < J; ++jj) {
        const int d = 4 * tx + 64 * jj;
        if (d < Dh) {
          const float4 x = *reinterpret_cast<const float4*>(vs + c * Dh + d);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            acc[i][4 * jj + 0] = fmaf(pv[i], x.x, acc[i][4 * jj + 0]);
            acc[i][4 * jj + 1] = fmaf(pv[i], x.y, acc[i][4 * jj + 1]);
            acc[i][4 * jj + 2] = fmaf(pv[i], x.z, acc[i][4 * jj + 2]);
            acc[i][4 * jj + 3] = fmaf(pv[i], x.w, acc[i][4 * jj + 3]);
          }
        }
      }
    }
  }

  T* ob = out + (static_cast<int64_t>(b) * Sq + q0) * q_row +
          static_cast<int64_t>(h) * Dh;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = 4 * ty + i;
    if (r >= rows) continue;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int jj = 0; jj < J; ++jj) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int d = 4 * tx + 64 * jj + e;
        if (d < Dh) store(ob + r * q_row + d, acc[i][4 * jj + e] / denom);
      }
    }
  }
}

template <typename T, int J>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int Sq, int Sk, int Hq, int Hkv, int Dh, int causal, int window,
           int q_offset, float scale, size_t smem, cudaStream_t s) {
  auto kern = flash_attention_kernel<T, J>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(B * Hq, (Sq + kBQ - 1) / kBQ);
  kern<<<grid, kThreads, smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), Sq, Sk, Hq, Hkv, Dh,
      causal, window, q_offset, scale);
  return static_cast<int>(cudaGetLastError());
}

// J = ceil(Dh / 64), the output tile's 64-column groups a thread owns
template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* out, int B,
             int Sq, int Sk, int Hq, int Hkv, int Dh, int causal, int window,
             int q_offset, float scale, size_t smem, cudaStream_t s) {
  switch ((Dh + 63) / 64) {
    case 1:
      return launch<T, 1>(q, k, v, out, B, Sq, Sk, Hq, Hkv, Dh, causal,
                          window, q_offset, scale, smem, s);
    case 2:
      return launch<T, 2>(q, k, v, out, B, Sq, Sk, Hq, Hkv, Dh, causal,
                          window, q_offset, scale, smem, s);
    case 3:
      return launch<T, 3>(q, k, v, out, B, Sq, Sk, Hq, Hkv, Dh, causal,
                          window, q_offset, scale, smem, s);
    case 4:
      return launch<T, 4>(q, k, v, out, B, Sq, Sk, Hq, Hkv, Dh, causal,
                          window, q_offset, scale, smem, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Shared memory one block takes, in bytes, at head width Dh.
extern "C" int64_t flash_attention_smem(int Dh) {
  return static_cast<int64_t>(sizeof(float)) *
         (static_cast<int64_t>(Dh) * (kQS + kKS + kBK) + kBK * kQS);
}

// dtype: 0 = fp32, 1 = bf16, of q, k, v and out; all contiguous and
// 16-byte (fp32) or 8-byte (bf16) aligned. causal: 0 or 1; window <= 0
// means no sliding window. Dh a multiple of 4 up to 256 and Hq a multiple
// of Hkv (the wrapper checks all three). Returns cudaGetLastError() after
// the launch.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, int B,
                                      int Sq, int Sk, int Hq, int Hkv,
                                      int Dh, int causal, int window,
                                      int q_offset, float scale, int dtype,
                                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || Sq <= 0 || Sk <= 0 || Hq <= 0 || Hkv <= 0 || Dh <= 0)
    return 0;
  if (Dh > 256 || Dh % 4 != 0 || Hq % Hkv != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(flash_attention_smem(Dh));
  if (dtype == 0)
    return dispatch<float>(q, k, v, out, B, Sq, Sk, Hq, Hkv, Dh, causal,
                           window, q_offset, scale, smem, s);
  return dispatch<__nv_bfloat16>(q, k, v, out, B, Sq, Sk, Hq, Hkv, Dh,
                                 causal, window, q_offset, scale, smem, s);
}
