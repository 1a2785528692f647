// wkv_chunked: the RWKV6 WKV recurrence with data-dependent decay, in
// chunks of 16 positions. r, k, v, w (B, S, H, hd), all fp32 or all bf16
// (widened to fp32); u (H, hd) fp32; state0 (B, H, hd, hd) fp32 or null
// (a zero state); out (B, S, H, hd) in r's type; state_out (B, H, hd, hd)
// fp32, the state after the last position:
//
//   out_t = r_t . (S_{t-1} + u * k_t v_t^T),
//   S_t   = diag(w_t) S_{t-1} + k_t v_t^T.
//
// Within a chunk, with A_t = prod_{s<=t} w_s per key channel:
//
//   out_t  = (r_t A_{t-1}) . S_0 + sum_{j<t} [(r_t A_{t-1} / A_j) . k_j] v_j
//            + (r_t . (u k_t)) v_t,
//   S_next = diag(A_last) S_0 + sum_j (A_last / A_j) k_j v_j^T.
//
// Replaces the TPU kernel repro/kernels/rwkv/kernel.py::wkv_chunked, a
// (B*H, S/16) Pallas grid that keeps the (hd, hd) fp32 state in VMEM
// scratch from one chunk step to the next (zeroed at the first). A CUDA
// grid carries nothing between blocks, so here one block of 256 threads
// owns one (b, h) and walks its chunks in order, the state in shared
// memory (16 KB at hd = 64), loaded from state0 (the model's chunked
// prefill continues a cached state) or zeroed. Per chunk:
//   * the four (16, hd) tiles are loaded once (coalesced rows of hd), w as
//     log(max(w, 1e-8));
//   * the diagonal bonus sum_d r u k, one thread a position, in d order;
//   * the inclusive cumulative log decay, one thread a key channel, in
//     position order, and from it r A_{t-1}, k / A_j, (A_last / A_j) k and
//     A_last — the formulas of the reference's blocks.py::_wkv_chunked;
//   * the 120 strictly causal scores, one thread each, in d order;
//   * each output: the causal scores times v in j order, plus the bonus
//     times v_t, plus (r A_{t-1}) . S_0 in d order;
//   * the state update, one thread an element, the chunk's positions in
//     order.
// Every sum runs in a fixed order and there are no atomics, so the same
// inputs give byte-identical results. The chunk tiles' rows are padded to
// hd + 1 floats so the score loop's 16 key rows fall in distinct banks.
// Shared memory is 4 (hd^2 + 5 * 16 (hd + 1) + 16 * 16 + 16 + 2 hd)
// bytes (38.8 KB at hd = 64); the wrapper refuses an hd whose block does
// not fit the 227 KB a block may use (kernels/rwkv/kernel.py).
//
// What bounds it on the H100: the function reads r, k, v, w once and
// writes out once (20 bytes a position and channel in fp32) and does
// about 4 hd^2 + 35 hd flops a position and head (the state term and the
// state update, 2 hd^2 each; the causal scores and their products with v,
// 15 hd each over the 120 causal pairs of a chunk; the bonus); at the
// forward shape (B = 4, S = 1,024, H = 64, hd = 64, fp32) that is 340 MB
// (0.10 ms at 3.35 TB/s) against 4.9 GFLOP (0.07 ms at 67 TFLOP/s): bytes.
// This first version runs its products on the fp32 cores out of shared
// memory, with one block per (b, h): 256 blocks at that shape.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 16;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
wkv_chunked_kernel(const T* __restrict__ r, const T* __restrict__ k,
                   const T* __restrict__ v, const T* __restrict__ w,
                   const float* __restrict__ u,
                   const float* __restrict__ state0, T* __restrict__ out,
                   float* __restrict__ state_out, int S, int H, int hd) {
  extern __shared__ float smem[];
  const int hp = hd + 1;                  // a padded row of a chunk tile
  const int hh = hd * hd;
  float* st = smem;                       // hd x hd state
  float* rt = st + hh;                    // C x hp: r, then r A_{t-1}
  float* kt = rt + kChunk * hp;           // C x hp: k, then k / A_j
  float* kr = kt + kChunk * hp;           // C x hp: (A_last / A_j) k
  float* vv = kr + kChunk * hp;           // C x hp: v
  float* la = vv + kChunk * hp;           // C x hp: log w, then its cumsum
  float* sc = la + kChunk * hp;           // C x C causal scores
  float* dg = sc + kChunk * kChunk;       // C diagonal bonus terms
  float* al = dg + kChunk;                // hd: A_last
  float* us = al + hd;                    // hd: u of this head

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int tid = threadIdx.x;
  const int64_t row = static_cast<int64_t>(H) * hd;   // one position
  const int64_t base = static_cast<int64_t>(b) * S * row +
                       static_cast<int64_t>(h) * hd;
  const int64_t sbase = static_cast<int64_t>(bh) * hh;

  for (int i = tid; i < hh; i += kThreads)
    st[i] = state0 != nullptr ? state0[sbase + i] : 0.0f;
  for (int d = tid; d < hd; d += kThreads)
    us[d] = u[static_cast<int64_t>(h) * hd + d];

  const int tile = kChunk * hd;
  for (int c = 0; c < S / kChunk; ++c) {
    const int64_t cbase = base + static_cast<int64_t>(c) * kChunk * row;
    __syncthreads();   // the state is loaded or updated; tiles are free
    for (int i = tid; i < tile; i += kThreads) {
      const int t = i / hd, d = i - t * hd;
      const int64_t g = cbase + t * row + d;
      const int s = t * hp + d;
      rt[s] = to_f32(r[g]);
      kt[s] = to_f32(k[g]);
      vv[s] = to_f32(v[g]);
      la[s] = logf(fmaxf(to_f32(w[g]), 1e-8f));
    }
    __syncthreads();

    if (tid < kChunk) {   // (r_t . (u k_t)), before r and k are scaled
      const float* rr = rt + tid * hp;
      const float* kk = kt + tid * hp;
      float acc = 0.0f;
      for (int d = 0; d < hd; ++d) acc += rr[d] * us[d] * kk[d];
      dg[tid] = acc;
    }
    __syncthreads();

    for (int d = tid; d < hd; d += kThreads) {
      float acc = 0.0f;
      for (int t = 0; t < kChunk; ++t) {
        const int s = t * hp + d;
        const float lw = la[s];
        acc += lw;
        la[s] = acc;
        rt[s] *= expf(acc - lw);          // r_t A_{t-1}
      }
      al[d] = expf(acc);                  // A_last
      for (int t = 0; t < kChunk; ++t) {
        const int s = t * hp + d;
        const float kk = kt[s];
        kr[s] = kk * expf(acc - la[s]);   // (A_last / A_j) k_j
        kt[s] = kk * expf(-la[s]);        // k_j / A_j
      }
    }
    __syncthreads();

    for (int i = tid; i < kChunk * kChunk; i += kThreads) {
      const int t = i / kChunk, j = i - t * kChunk;
      float acc = 0.0f;
      if (j < t) {
        const float* rr = rt + t * hp;
        const float* kk = kt + j * hp;
        for (int d = 0; d < hd; ++d) acc += rr[d] * kk[d];
      }
      sc[i] = acc;
    }
    __syncthreads();

    for (int i = tid; i < tile; i += kThreads) {
      const int t = i / hd, e = i - t * hd;
      float intra = 0.0f;
      for (int j = 0; j < t; ++j) intra += sc[t * kChunk + j] * vv[j * hp + e];
      intra += dg[t] * vv[t * hp + e];
      const float* rr = rt + t * hp;
      float inter = 0.0f;
      for (int d = 0; d < hd; ++d) inter += rr[d] * st[d * hd + e];
      store(out + cbase + t * row + e, intra + inter);
    }
    __syncthreads();   // every read of the incoming state is done

    for (int i = tid; i < hh; i += kThreads) {
      const int d = i / hd, e = i - d * hd;
      float acc = 0.0f;
      for (int t = 0; t < kChunk; ++t) acc += kr[t * hp + d] * vv[t * hp + e];
      st[i] = al[d] * st[i] + acc;
    }
  }
  __syncthreads();
  for (int i = tid; i < hh; i += kThreads) state_out[sbase + i] = st[i];
}

template <typename T>
int launch(const void* r, const void* k, const void* v, const void* w,
           const float* u, const float* state0, void* out, float* state_out,
           int B, int S, int H, int hd, size_t smem, cudaStream_t s) {
  auto kern = wkv_chunked_kernel<T>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kern<<<B * H, kThreads, smem, s>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(w), u, state0,
      static_cast<T*>(out), state_out, S, H, hd);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Shared memory one block takes, in bytes (the wrapper checks it against
// the 227 KB limit before launching).
extern "C" int64_t wkv_chunked_smem(int hd) {
  return static_cast<int64_t>(sizeof(float)) *
         (static_cast<int64_t>(hd) * hd + 5 * kChunk * (hd + 1) +
          kChunk * kChunk + kChunk + 2 * hd);
}

// dtype: 0 = fp32, 1 = bf16, of r, k, v, w and out; u, state0 and
// state_out are fp32; state0 may be null (a zero state). All contiguous;
// S a multiple of 16. Returns cudaGetLastError() after the launch.
extern "C" int wkv_chunked_launch(const void* r, const void* k,
                                  const void* v, const void* w,
                                  const void* u, const void* state0,
                                  void* out, void* state_out, int B, int S,
                                  int H, int hd, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = static_cast<size_t>(wkv_chunked_smem(hd));
  if (B <= 0 || H <= 0 || hd <= 0) return 0;
  const float* uf = static_cast<const float*>(u);
  const float* s0 = static_cast<const float*>(state0);
  float* so = static_cast<float*>(state_out);
  if (dtype == 0)
    return launch<float>(r, k, v, w, uf, s0, out, so, B, S, H, hd, smem, s);
  return launch<__nv_bfloat16>(r, k, v, w, uf, s0, out, so, B, S, H, hd,
                               smem, s);
}
