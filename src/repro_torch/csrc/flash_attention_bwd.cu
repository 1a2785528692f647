// flash_attention_bwd: the gradient of flash_attention.cu's forward,
// FlashAttention-2's backward. q, out, dout (B, Sq, Hq, Dh); k, v
// (B, Sk, Hkv, Dh), all fp32 or all bf16, contiguous; lse (B, Hq, Sq)
// fp32, the rows' log-sum-exp m + log(l) that the forward wrote. Query row
// r sits at position p = q_offset + r; key c is admitted iff c <= p
// (causal) and c > p - window (a window); with s = (q . k) / sqrt(Dh):
//
//   P_rc  = exp(s_rc - lse_r)  admitted,  0 otherwise,
//   D_r   = sum_d dout_rd out_rd,
//   dV_c  = sum_r P_rc dout_r,        dP_rc = dout_r . v_c,
//   dS_rc = P_rc (dP_rc - D_r)        admitted, 0 otherwise,
//   dQ_r  = sum_c dS_rc k_c / sqrt(Dh),
//   dK_c  = sum_r dS_rc q_r / sqrt(Dh),
//
// a KV head's dK and dV summed over its Hq / Hkv query heads. A row that
// admits no key (p < 0 when causal, p - window + 1 > Sk - 1) scored -1e30
// everywhere in the forward and got the mean of V: its P is 1 / Sk over
// every key and its dS is 0, as autograd through the plain version gives.
//
// No TPU kernel corresponds: the reference differentiates its jnp
// attention. Four launches, every sum in a fixed order, no atomics:
//   1. bwd_rowdot: D, one warp a row (lanes over d, then xor shuffles).
//   2. bwd_dkdv: a block a (b, query head, 32-key tile) walks the 32-row
//      query tiles that can see its keys (every tile when a tile holds a
//      row that admits no key), recomputes S and P from Q, K and lse, and
//      accumulates the head's dK and dV of its keys in registers; it
//      writes them, fp32, to a scratch (B, Sk, Hq, Dh) each.
//   3. bwd_reduce: dK, dV of a KV head = its query heads' partials summed
//      in head order, cast to the operands' type.
//   4. bwd_dq: a block a (b, query head, 32-row tile) walks the key tiles
//      its rows can see and accumulates dQ in registers.
// (2 and 4 are independent; 3 follows 2.) Products are fp32 FMAs on tiles
// staged in shared memory as fp32 (bf16 widened on load), rows padded to
// Dh + 1 floats so that a warp's column reads fall in distinct banks. A
// simple kernel: the FMA rate, not the tensor cores.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 32;    // query rows of a tile
constexpr int kKeys = 32;    // keys of a tile

__device__ __forceinline__ float load(const float* p) { return *p; }
__device__ __forceinline__ float load(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

__host__ __device__ inline int pad(int dh) { return dh + 1; }

// whether key c is admitted by the row at position p, and whether that row
// admits any key
__device__ __forceinline__ bool admitted(int p, int c, int Sk, int causal,
                                         int window) {
  return c < Sk && (!causal || c <= p) && (window <= 0 || c > p - window);
}
__device__ __forceinline__ bool empty_row(int p, int Sk, int causal,
                                          int window) {
  return (causal && p < 0) || (window > 0 && p - window + 1 > Sk - 1);
}

// whether query rows [pa, pb] (positions) can see keys [c0, c1]: some
// admitted pair, or a row that admits no key (it sees every key at 1/Sk)
__device__ __forceinline__ bool tile_sees(int pa, int pb, int c0, int c1,
                                          int Sk, int causal, int window,
                                          bool with_empty) {
  if (with_empty && (empty_row(pa, Sk, causal, window) ||
                     empty_row(pb, Sk, causal, window)))
    return true;
  if (causal && c0 > pb) return false;
  if (window > 0 && c1 <= pa - window) return false;
  return true;
}

// rows [r0, r0 + n) of a (.., S, H, Dh) tensor's head h -> smem rows of
// pad(Dh) floats; rows past `valid` are zero
template <typename T>
__device__ void stage(float* dst, const T* src, int64_t row, int n,
                      int valid, int Dh) {
  for (int i = threadIdx.x; i < n * Dh; i += kThreads) {
    const int r = i / Dh, d = i - r * Dh;
    dst[r * pad(Dh) + d] = r < valid ? load(src + r * row + d) : 0.0f;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
bwd_rowdot(const T* __restrict__ out, const T* __restrict__ dout,
           float* __restrict__ drow, int64_t rows, int Sq, int Hq, int Dh) {
  const int64_t w = (static_cast<int64_t>(blockIdx.x) * kThreads +
                     threadIdx.x) / 32;
  const int lane = threadIdx.x & 31;
  if (w >= rows) return;
  // w = (b Sq + r) Hq + h: the row's elements are contiguous
  const T* o = out + w * Dh;
  const T* g = dout + w * Dh;
  float acc = 0.0f;
  for (int d = lane; d < Dh; d += 32) acc += load(o + d) * load(g + d);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) {
    const int64_t b = w / (static_cast<int64_t>(Sq) * Hq);
    const int r = static_cast<int>((w / Hq) % Sq), h = static_cast<int>(w % Hq);
    drow[(b * Hq + h) * Sq + r] = acc;
  }
}

// S = Q K^T and dP = dO V^T of a (32-row, 32-key) tile pair, then P and
// dS: thread t takes row t / 8 and keys t % 8 + 8 c, c = 0 .. 3
__device__ __forceinline__ void scores(
    const float* qs, const float* dos, const float* ks, const float* vs,
    const float* lse_s, const float* drow_s, float* ps, float* dss, int Dh,
    float scale, int p, int c0, int Sk, int causal, int window, int rows) {
  const int i = threadIdx.x >> 3, j0 = threadIdx.x & 7;
  const int P = pad(Dh);
  float s[4] = {0, 0, 0, 0}, dp[4] = {0, 0, 0, 0};
  const float* qr = qs + i * P;
  const float* dr = dos + i * P;
  for (int d = 0; d < Dh; ++d) {
    const float qv = qr[d], gv = dr[d];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      s[c] = fmaf(qv, ks[(j0 + 8 * c) * P + d], s[c]);
      dp[c] = fmaf(gv, vs[(j0 + 8 * c) * P + d], dp[c]);
    }
  }
  const bool empty = empty_row(p, Sk, causal, window);
  const float lse = lse_s[i], dr_i = drow_s[i];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const int j = j0 + 8 * c, key = c0 + j;
    float pr = 0.0f, ds = 0.0f;
    if (i < rows && key < Sk) {
      if (empty) {
        pr = 1.0f / static_cast<float>(Sk);
      } else if (admitted(p, key, Sk, causal, window)) {
        pr = expf(s[c] * scale - lse);
        ds = pr * (dp[c] - dr_i);
      }
    }
    ps[i * (kKeys + 1) + j] = pr;
    dss[i * (kKeys + 1) + j] = ds;
  }
}

// NC: the columns a thread accumulates, 8 NC >= Dh (thread t takes columns
// t % 8 + 8 m of key / row t / 8)
template <typename T, int NC>
__global__ void __launch_bounds__(kThreads)
bwd_dkdv(const T* __restrict__ q, const T* __restrict__ k,
         const T* __restrict__ v, const T* __restrict__ dout,
         const float* __restrict__ lse, const float* __restrict__ drow,
         float* __restrict__ dk_part, float* __restrict__ dv_part, int Sq,
         int Sk, int Hq, int Hkv, int Dh, int causal, int window,
         int q_offset, float scale) {
  extern __shared__ float smem[];
  const int P = pad(Dh);
  float* qs = smem;                 // kRows x P
  float* dos = qs + kRows * P;      // kRows x P
  float* ks = dos + kRows * P;      // kKeys x P
  float* vs = ks + kKeys * P;       // kKeys x P
  float* ps = vs + kKeys * P;       // kRows x (kKeys + 1)
  float* dss = ps + kRows * (kKeys + 1);
  float* lse_s = dss + kRows * (kKeys + 1);   // kRows
  float* drow_s = lse_s + kRows;              // kRows

  const int b = blockIdx.x / Hq, h = blockIdx.x % Hq;
  const int hk = h / (Hq / Hkv);
  const int c0 = blockIdx.y * kKeys;   // the first key tiles see the most
  const int nkeys = min(kKeys, Sk - c0);
  const int64_t q_row = static_cast<int64_t>(Hq) * Dh;
  const int64_t k_row = static_cast<int64_t>(Hkv) * Dh;
  stage(ks, k + (static_cast<int64_t>(b) * Sk + c0) * k_row +
                static_cast<int64_t>(hk) * Dh, k_row, kKeys, nkeys, Dh);
  stage(vs, v + (static_cast<int64_t>(b) * Sk + c0) * k_row +
                static_cast<int64_t>(hk) * Dh, k_row, kKeys, nkeys, Dh);

  const int jr = threadIdx.x >> 3, dc = threadIdx.x & 7;
  float dk[NC], dv[NC];
#pragma unroll
  for (int m = 0; m < NC; ++m) dk[m] = dv[m] = 0.0f;

  const int n_tiles = (Sq + kRows - 1) / kRows;
  for (int t = 0; t < n_tiles; ++t) {
    const int r0 = t * kRows, rows = min(kRows, Sq - r0);
    if (!tile_sees(q_offset + r0, q_offset + r0 + rows - 1, c0,
                   c0 + nkeys - 1, Sk, causal, window, true))
      continue;
    __syncthreads();   // the previous tile's reads are done
    const int64_t base = (static_cast<int64_t>(b) * Sq + r0) * q_row +
                         static_cast<int64_t>(h) * Dh;
    stage(qs, q + base, q_row, kRows, rows, Dh);
    stage(dos, dout + base, q_row, kRows, rows, Dh);
    if (threadIdx.x < kRows) {
      const int r = threadIdx.x;
      const int64_t at = (static_cast<int64_t>(b) * Hq + h) * Sq + r0 + r;
      lse_s[r] = r < rows ? lse[at] : 0.0f;
      drow_s[r] = r < rows ? drow[at] : 0.0f;
    }
    __syncthreads();
    scores(qs, dos, ks, vs, lse_s, drow_s, ps, dss, Dh, scale,
           q_offset + r0 + (threadIdx.x >> 3), c0, Sk, causal, window, rows);
    __syncthreads();
    for (int i = 0; i < kRows; ++i) {
      const float pr = ps[i * (kKeys + 1) + jr];
      const float ds = dss[i * (kKeys + 1) + jr];
      const float* dr = dos + i * P;
      const float* qr = qs + i * P;
#pragma unroll
      for (int m = 0; m < NC; ++m) {
        const int d = dc + 8 * m;
        if (d < Dh) {
          dv[m] = fmaf(pr, dr[d], dv[m]);
          dk[m] = fmaf(ds, qr[d], dk[m]);
        }
      }
    }
  }
  if (jr < nkeys) {
    const int64_t at = ((static_cast<int64_t>(b) * Sk + c0 + jr) * Hq + h) *
                       Dh;
#pragma unroll
    for (int m = 0; m < NC; ++m) {
      const int d = dc + 8 * m;
      if (d < Dh) {
        dk_part[at + d] = dk[m] * scale;
        dv_part[at + d] = dv[m];
      }
    }
  }
}

// dK, dV (B, Sk, Hkv, Dh) = the partials (B, Sk, Hq, Dh) summed over each
// KV head's query heads in order
template <typename T>
__global__ void __launch_bounds__(kThreads)
bwd_reduce(const float* __restrict__ dk_part,
           const float* __restrict__ dv_part, T* __restrict__ dk,
           T* __restrict__ dv, int64_t n, int Hkv, int rep, int Dh) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads +
                    threadIdx.x;
  if (i >= n) return;
  // i = ((b Sk + c) Hkv + hk) Dh + d
  const int d = static_cast<int>(i % Dh);
  const int64_t pos = i / Dh / Hkv;
  const int hk = static_cast<int>((i / Dh) % Hkv);
  const int64_t src = (pos * Hkv * rep + static_cast<int64_t>(hk) * rep) *
                      Dh + d;
  float a = 0.0f, c = 0.0f;
  for (int r = 0; r < rep; ++r) {
    a += dk_part[src + static_cast<int64_t>(r) * Dh];
    c += dv_part[src + static_cast<int64_t>(r) * Dh];
  }
  store(dk + i, a);
  store(dv + i, c);
}

template <typename T, int NC>
__global__ void __launch_bounds__(kThreads)
bwd_dq(const T* __restrict__ q, const T* __restrict__ k,
       const T* __restrict__ v, const T* __restrict__ dout,
       const float* __restrict__ lse, const float* __restrict__ drow,
       T* __restrict__ dq, int Sq, int Sk, int Hq, int Hkv, int Dh,
       int causal, int window, int q_offset, float scale) {
  extern __shared__ float smem[];
  const int P = pad(Dh);
  float* qs = smem;
  float* dos = qs + kRows * P;
  float* ks = dos + kRows * P;
  float* vs = ks + kKeys * P;
  float* ps = vs + kKeys * P;
  float* dss = ps + kRows * (kKeys + 1);
  float* lse_s = dss + kRows * (kKeys + 1);
  float* drow_s = lse_s + kRows;

  const int b = blockIdx.x / Hq, h = blockIdx.x % Hq;
  const int hk = h / (Hq / Hkv);
  // the last query tiles see the most keys under a causal mask
  const int r0 = (gridDim.y - 1 - blockIdx.y) * kRows;
  const int rows = min(kRows, Sq - r0);
  const int64_t q_row = static_cast<int64_t>(Hq) * Dh;
  const int64_t k_row = static_cast<int64_t>(Hkv) * Dh;
  const int64_t base = (static_cast<int64_t>(b) * Sq + r0) * q_row +
                       static_cast<int64_t>(h) * Dh;
  stage(qs, q + base, q_row, kRows, rows, Dh);
  stage(dos, dout + base, q_row, kRows, rows, Dh);
  if (threadIdx.x < kRows) {
    const int r = threadIdx.x;
    const int64_t at = (static_cast<int64_t>(b) * Hq + h) * Sq + r0 + r;
    lse_s[r] = r < rows ? lse[at] : 0.0f;
    drow_s[r] = r < rows ? drow[at] : 0.0f;
  }
  const int ir = threadIdx.x >> 3, dc = threadIdx.x & 7;
  float acc[NC];
#pragma unroll
  for (int m = 0; m < NC; ++m) acc[m] = 0.0f;

  const T* kb = k + static_cast<int64_t>(b) * Sk * k_row +
                static_cast<int64_t>(hk) * Dh;
  const T* vb = v + static_cast<int64_t>(b) * Sk * k_row +
                static_cast<int64_t>(hk) * Dh;
  const int n_tiles = (Sk + kKeys - 1) / kKeys;
  for (int t = 0; t < n_tiles; ++t) {
    const int c0 = t * kKeys, nkeys = min(kKeys, Sk - c0);
    // a row that admits no key has dS = 0: only admitted pairs matter
    if (!tile_sees(q_offset + r0, q_offset + r0 + rows - 1, c0,
                   c0 + nkeys - 1, Sk, causal, window, false))
      continue;
    __syncthreads();
    stage(ks, kb + static_cast<int64_t>(c0) * k_row, k_row, kKeys, nkeys,
          Dh);
    stage(vs, vb + static_cast<int64_t>(c0) * k_row, k_row, kKeys, nkeys,
          Dh);
    __syncthreads();
    scores(qs, dos, ks, vs, lse_s, drow_s, ps, dss, Dh, scale,
           q_offset + r0 + (threadIdx.x >> 3), c0, Sk, causal, window, rows);
    __syncthreads();
    for (int j = 0; j < kKeys; ++j) {
      const float ds = dss[ir * (kKeys + 1) + j];
      const float* kr = ks + j * P;
#pragma unroll
      for (int m = 0; m < NC; ++m) {
        const int d = dc + 8 * m;
        if (d < Dh) acc[m] = fmaf(ds, kr[d], acc[m]);
      }
    }
  }
  if (ir < rows) {
    T* o = dq + base + static_cast<int64_t>(ir) * q_row;
#pragma unroll
    for (int m = 0; m < NC; ++m) {
      const int d = dc + 8 * m;
      if (d < Dh) store(o + d, acc[m] * scale);
    }
  }
}

__host__ inline int64_t smem_bytes(int dh) {
  return (static_cast<int64_t>(2 * kRows + 2 * kKeys) * pad(dh) +
          2 * kRows * (kKeys + 1) + 2 * kRows) * 4;
}

// the opt-in above 48 KB, once per device (and instance) for the largest
// size asked, so that a launch inside a CUDA graph capture sets nothing
template <typename Kernel>
int opt_in(Kernel kern, int64_t smem) {
  static int64_t granted[64] = {};
  if (smem <= 48 * 1024) return 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  if (smem <= granted[dev]) return 0;
  err = cudaFuncSetAttribute(kern,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err == cudaSuccess) granted[dev] = smem;
  return static_cast<int>(err);
}

template <typename T, int NC>
int launch(const void* q, const void* k, const void* v, const void* out,
           const void* dout, const float* lse, void* dq, void* dk, void* dv,
           float* drow, float* dk_part, float* dv_part, int B, int Sq,
           int Sk, int Hq, int Hkv, int Dh, int causal, int window,
           int q_offset, float scale, cudaStream_t s) {
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* dot = static_cast<const T*>(dout);
  const int64_t rows = static_cast<int64_t>(B) * Sq * Hq;
  bwd_rowdot<T><<<static_cast<unsigned>((rows * 32 + kThreads - 1) /
                                        kThreads), kThreads, 0, s>>>(
      static_cast<const T*>(out), dot, drow, rows, Sq, Hq, Dh);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const int64_t smem = smem_bytes(Dh);
  int rc = opt_in(bwd_dkdv<T, NC>, smem);
  if (rc) return rc;
  rc = opt_in(bwd_dq<T, NC>, smem);
  if (rc) return rc;
  bwd_dkdv<T, NC><<<dim3(B * Hq, (Sk + kKeys - 1) / kKeys), kThreads, smem,
                    s>>>(qt, kt, vt, dot, lse, drow, dk_part, dv_part, Sq,
                         Sk, Hq, Hkv, Dh, causal, window, q_offset, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t n = static_cast<int64_t>(B) * Sk * Hkv * Dh;
  bwd_reduce<T><<<static_cast<unsigned>((n + kThreads - 1) / kThreads),
                  kThreads, 0, s>>>(dk_part, dv_part, static_cast<T*>(dk),
                                    static_cast<T*>(dv), n, Hkv, Hq / Hkv,
                                    Dh);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  bwd_dq<T, NC><<<dim3(B * Hq, (Sq + kRows - 1) / kRows), kThreads, smem,
                  s>>>(qt, kt, vt, dot, lse, drow, static_cast<T*>(dq), Sq,
                       Sk, Hq, Hkv, Dh, causal, window, q_offset, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, const void* out,
             const void* dout, const float* lse, void* dq, void* dk,
             void* dv, float* drow, float* dk_part, float* dv_part, int B,
             int Sq, int Sk, int Hq, int Hkv, int Dh, int causal, int window,
             int q_offset, float scale, cudaStream_t s) {
#define REPRO_FLASH_BWD(NC)                                                 \
  return launch<T, NC>(q, k, v, out, dout, lse, dq, dk, dv, drow, dk_part,  \
                       dv_part, B, Sq, Sk, Hq, Hkv, Dh, causal, window,     \
                       q_offset, scale, s)
  switch ((Dh + 63) / 64) {
    case 1: REPRO_FLASH_BWD(8);
    case 2: REPRO_FLASH_BWD(16);
    case 3: REPRO_FLASH_BWD(24);
    case 4: REPRO_FLASH_BWD(32);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef REPRO_FLASH_BWD
}

}  // namespace

// Bytes of the fp32 scratch the caller passes: drow (B Hq Sq floats), then
// dk_part and dv_part (B Sk Hq Dh floats each).
extern "C" int64_t flash_attention_bwd_scratch(int B, int Sq, int Sk, int Hq,
                                               int Dh) {
  return (static_cast<int64_t>(B) * Hq * Sq +
          2 * static_cast<int64_t>(B) * Sk * Hq * Dh) * 4;
}

// dtype: 0 = fp32, 1 = bf16, of q, k, v, out, dout, dq, dk, dv; lse and
// the scratch fp32; all contiguous. causal 0 or 1; window <= 0: none. Dh a
// multiple of 4 up to 256, Hq a multiple of Hkv (the wrapper checks).
// Returns the first launch error, or cudaGetLastError() after the last.
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* out,
    const void* dout, const void* lse, void* dq, void* dk, void* dv,
    void* scratch, int B, int Sq, int Sk, int Hq, int Hkv, int Dh,
    int causal, int window, int q_offset, float scale, int dtype,
    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || Sq <= 0 || Sk <= 0 || Hq <= 0 || Hkv <= 0 || Dh <= 0)
    return 0;
  if (Dh > 256 || Dh % 4 != 0 || Hq % Hkv != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  float* drow = static_cast<float*>(scratch);
  float* dk_part = drow + static_cast<int64_t>(B) * Hq * Sq;
  float* dv_part = dk_part + static_cast<int64_t>(B) * Sk * Hq * Dh;
  const float* l = static_cast<const float*>(lse);
  if (dtype == 0)
    return dispatch<float>(q, k, v, out, dout, l, dq, dk, dv, drow, dk_part,
                           dv_part, B, Sq, Sk, Hq, Hkv, Dh, causal, window,
                           q_offset, scale, s);
  return dispatch<__nv_bfloat16>(q, k, v, out, dout, l, dq, dk, dv, drow,
                                 dk_part, dv_part, B, Sq, Sk, Hq, Hkv, Dh,
                                 causal, window, q_offset, scale, s);
}
