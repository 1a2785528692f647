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
// grid carries nothing between blocks, so a block walks its chunks in
// order, from state0 (the model's chunked prefill continues a cached
// state) or from zero.
//
// What bounds it on the H100: the function reads r, k, v, w once and
// writes out once (20 bytes a position and channel in fp32) and does
// about 4 hd^2 + 35 hd flops a position and head; at the forward shape
// (B = 4, S = 1,024, H = 64, hd = 64, fp32) that is 340 MB (0.10 ms at
// 3.35 TB/s) against 4.9 GFLOP (0.07 ms at 67 TFLOP/s). What holds a
// chunk-serial kernel back is the instructions and the latency of each
// chunk's chain, not the peak, so the design cuts both:
//   * out[:, e] and the state column S[:, e] depend only on v[:, e] and
//     the incoming column e, so a (b, h) splits into blocks of kSlice = 64
//     value channels (four warps of 16), the slice index fastest in the
//     grid so that the blocks of one head read its r, k, w rows from L2
//     together; rwkv6-7b's hd = 64 is one block a head. Each block
//     recomputes the decay and the 16 x 16 causal scores, which all slices
//     share (at the path's shapes slices of 16 or 32 channels were slower
//     on the H100: more blocks repeat that work). A last slice that hd
//     leaves short is masked.
//   * The chunk's four products run on the tensor cores as m16n8k8 tf32
//     MMAs, each in three parts (x = hi + lo; hi hi + hi lo + lo hi), which
//     keeps an fp32 product's accuracy: the state term (S^T)(r A)^T, the
//     update S^T diag(A_last) + V^T k_rev, the scores (r A)(k / A)^T and
//     V^T scores^T. A warp's 16 x hd slice of S^T stays in registers as
//     MMA accumulators across chunks, and the same registers are the A
//     operand of the state term (see the kernel), so it never moves.
//   * The chunk's r, k, w tiles and v slice are double-buffered in shared
//     memory and copied with 16-byte cp.async (where every row is 16-byte
//     aligned; plain loads otherwise): chunk c + 1 is in flight while
//     chunk c computes. Three barriers a chunk: the tiles have landed, the
//     decayed tiles are written, the scores are written.
//   * The decay takes a thread a key channel, its 16 positions in order
//     (log2 and exp2, A_t = 2^(sum log2 w)); the diagonal bonus sums
//     quarters of the key channels and then the quarters in a fixed order.
// Every sum runs in a fixed order and there are no atomics, so the same
// inputs give byte-identical results. Shared memory (smem_bytes below):
// the staged tiles twice, four fp32 tiles, the scores, A_last and u:
// 55,552 bytes at hd = 64 in fp32. The largest hd is 256 (32
// accumulator tiles a lane); the wrapper refuses more on every device
// (kernels/rwkv/kernel.py).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kChunk = 16;     // positions a chunk
constexpr int kMaxHead = 256;  // 32 state fragments a lane (128 floats)
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kSlice = 16 * kWarps;   // value channels a block

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// 2^x on the special-function unit (relative error about 2^-22)
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Row stride, in elements, of a staged tile of `size`-byte elements: hd
// rounded up to 16 bytes, plus 16 bytes (rows stay 16-byte aligned).
__host__ __device__ inline int raw_stride(int hd, int size) {
  const int per = 16 / size;
  return (hd + per - 1) / per * per + per;
}
// Row stride of a staged v slice: kSlice plus 32 bytes, so that the 4 rows
// a fragment load reads fall in distinct banks.
__host__ __device__ inline int v_stride(int size) {
  return kSlice + 32 / size;
}
// Row stride of a decayed fp32 tile: hd rounded up to 8 (whole 8-column
// fragments, the padding zero), plus 8 (8 rows of a fragment load fall in
// distinct banks).
__host__ __device__ inline int f32_stride(int hd) {
  return (hd + 7) / 8 * 8 + 8;
}
constexpr int kScoreStride = 20;   // a row of the 16 x 16 scores

__host__ __device__ inline int64_t smem_bytes(int hd, int size) {
  const int64_t rs = raw_stride(hd, size), fs = f32_stride(hd);
  return 2 * 3 * kChunk * rs * size           // r, k, w tiles, twice
         + 2 * kChunk * v_stride(size) * size   // the v slice, twice
         + 4 * kChunk * fs * 4                // r A_{t-1}, k / A_j, k_rev,
                                              // r u k
         + kChunk * kScoreStride * 4          // the scores and the bonus
         + 2 * ((hd + 7) / 8 * 8) * 4;        // A_last, u
}

// x = hi + lo: hi is x rounded to tf32 (10 explicit mantissa bits) by
// its bit pattern, lo the exact fp32 remainder, whose top 19 bits the
// tensor cores read. Three tf32 products (hi hi, hi lo, lo hi) keep an
// fp32 product's accuracy (the rest is below 2^-21 of it). Integer and
// fp32 adds only: cvt.rna.tf32 runs at a quarter of their rate.
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// A B for an A fragment given as (hi, lo) and B as two floats: the large
// product into `big`, the two small ones into `small` (two accumulators,
// so that the chains run side by side; the caller adds them in a fixed
// order)
__device__ __forceinline__ void mma3(float (&big)[4], float (&small)[4],
                                     const uint32_t (&ahi)[4],
                                     const uint32_t (&alo)[4], float b0,
                                     float b1) {
  uint32_t bh0, bl0, bh1, bl1;
  split(b0, bh0, bl0);
  split(b1, bh1, bl1);
  mma_tf32(small, alo, bh0, bh1);
  mma_tf32(small, ahi, bl0, bl1);
  mma_tf32(big, ahi, bh0, bh1);
}

// One block: kSlice value channels of one (b, h), kWarps warps. Warp w holds
// the transposed state slice S^T[e][d] of its 16 value channels e as the
// accumulator fragments of NT m16n8 tiles (8 key channels each, hd <=
// 8 NT): lane (g, q) = (lane / 4, lane % 4) holds S^T[g, g + 8][8 n + 2 q,
// 8 n + 2 q + 1] of tile n. The same registers are the A fragments of
// (S^T)(r A)^T with the k order (d = 8 n + 2 q, 8 n + 2 q + 1) for (k = q,
// q + 4), which the B fragments follow, so the state never changes layout.
template <typename T, int NT>
__global__ void __launch_bounds__(kThreads)
wkv_chunked_kernel(const T* __restrict__ r, const T* __restrict__ k,
                   const T* __restrict__ v, const T* __restrict__ w,
                   const float* __restrict__ u,
                   const float* __restrict__ state0, T* __restrict__ out,
                   float* __restrict__ state_out, int S, int H, int hd,
                   int vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int rs = raw_stride(hd, sizeof(T)), fs = f32_stride(hd);
  const int vs = v_stride(sizeof(T));
  const int hd8 = (hd + 7) / 8 * 8;
  T* raw = reinterpret_cast<T*>(smem);                 // [2][3][C][rs]
  T* vraw = raw + 2 * 3 * kChunk * rs;                 // [2][C][vs]
  float* rt = reinterpret_cast<float*>(vraw + 2 * kChunk * vs);  // [C][fs]
  float* kt = rt + kChunk * fs;                        // [C][fs]
  float* kr = kt + kChunk * fs;                        // [C][fs]
  float* pb = kr + kChunk * fs;                        // [C][fs]: r u k
  float* sc = pb + kChunk * fs;                        // [C][kScoreStride]
  float* al = sc + kChunk * kScoreStride;              // [hd8]
  float* us = al + hd8;                                // [hd8]

  const int nslices = (hd + kSlice - 1) / kSlice;
  const int slice = blockIdx.x % nslices;
  const int bh = blockIdx.x / nslices;
  const int b = bh / H, h = bh % H;
  const int e0 = slice * kSlice, ncols = min(kSlice, hd - e0);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, q = lane & 3;
  const int ew = 16 * warp;        // the warp's value channels in the slice
  const int64_t row = static_cast<int64_t>(H) * hd;   // one position
  const int64_t base = static_cast<int64_t>(b) * S * row +
                       static_cast<int64_t>(h) * hd;
  const int64_t sbase = static_cast<int64_t>(bh) * hd * hd;
  const int n_chunks = S / kChunk;
  // parts of its 16 positions a decay thread takes: 2 or 4 where the
  // block has that many threads for each key channel
  const int parts = kThreads >= 4 * hd ? 4 : kThreads >= 2 * hd ? 2 : 1;

  // Padding (key channels past hd, value channels past the slice) is never
  // written below: zero it once, with A_last, and load u.
  for (int i = tid; i < 4 * kChunk * fs; i += kThreads) rt[i] = 0.0f;
  for (int i = tid; i < hd8; i += kThreads) {
    al[i] = 0.0f;
    us[i] = i < hd ? u[static_cast<int64_t>(h) * hd + i] : 0.0f;
  }
  for (int i = tid; i < 2 * kChunk * vs; i += kThreads) store(vraw + i, 0.0f);
  __syncthreads();   // before the first copies land in the v slice

  // The copies: a tile row holds nv units of `per` elements (16 bytes,
  // or one element without vec), the v slice's row nvv; a thread walks
  // the units tid, tid + kThreads, ... in (row, unit) order, the same walk
  // every chunk, so its start and step are worked out once here.
  const int per = vec ? 16 / static_cast<int>(sizeof(T)) : 1;
  const int nv = hd / per, nvv = ncols / per;
  const int t0 = tid / nv, x0 = tid - t0 * nv;
  const int dt = kThreads / nv, dx = kThreads - dt * nv;
  const int tv0 = tid / nvv, xv0 = tid - tv0 * nvv;
  const int dtv = kThreads / nvv, dxv = kThreads - dtv * nvv;
  auto stage = [&](int c, int slot) {
    const int64_t cb = base + static_cast<int64_t>(c) * kChunk * row;
    T* tiles = raw + slot * 3 * kChunk * rs;
    T* vt = vraw + slot * kChunk * vs;
    for (int t = t0, x = x0; t < kChunk;) {
      const int64_t gi = cb + t * row + x * per;
      T* dst = tiles + t * rs + x * per;
      if (vec) {
        cp_async16(dst, r + gi);
        cp_async16(dst + kChunk * rs, k + gi);
        cp_async16(dst + 2 * kChunk * rs, w + gi);
      } else {
        dst[0] = r[gi];
        dst[kChunk * rs] = k[gi];
        dst[2 * kChunk * rs] = w[gi];
      }
      t += dt;
      x += dx;
      if (x >= nv) { x -= nv; ++t; }
    }
    for (int t = tv0, x = xv0; t < kChunk;) {
      const int64_t gi = cb + t * row + e0 + x * per;
      if (vec) cp_async16(vt + t * vs + x * per, v + gi);
      else vt[t * vs + x] = v[gi];
      t += dtv;
      x += dxv;
      if (x >= nvv) { x -= nvv; ++t; }
    }
    cp_async_commit();
  };

  // the state slice, S^T[e][d] = S[d][e] (zero past hd and the slice)
  const int ea = ew + g, eb = ew + g + 8;
  float st[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int d = 8 * n + 2 * q + (i & 1), e = i < 2 ? ea : eb;
      st[n][i] = (state0 != nullptr && d < hd && e < ncols)
                     ? state0[sbase + static_cast<int64_t>(d) * hd + e0 + e]
                     : 0.0f;
    }
  }

  if (n_chunks > 0) stage(0, 0);
  for (int c = 0; c < n_chunks; ++c) {
    const int slot = c & 1;
    cp_async_wait_all();
    __syncthreads();   // chunk c has landed; chunk c - 1 is done with all
    if (c + 1 < n_chunks) stage(c + 1, slot ^ 1);
    const T* rr = raw + slot * 3 * kChunk * rs;
    const T* kk = rr + kChunk * rs;
    const T* ww = kk + kChunk * rs;
    const T* vv = vraw + slot * kChunk * vs;

    // 1. decay, a thread a key channel and a part of its positions (all
    //    threads busy): la_t = sum_{s<=t} log2 w_s in position order,
    //    A_t = 2^la_t
    for (int i = tid; i < parts * hd; i += kThreads) {
      const int part = i / hd, d = i - part * hd;
      const int lo = part * (kChunk / parts), hi = lo + kChunk / parts;
      float la[kChunk];
      float acc = 0.0f;
#pragma unroll
      for (int t = 0; t < kChunk; ++t) {
        acc += __log2f(fmaxf(to_f32(ww[t * rs + d]), 1e-8f));
        la[t] = acc;
      }
      const float last = la[kChunk - 1], ud = us[d];
      if (hi == kChunk) al[d] = exp2_approx(last);
#pragma unroll
      for (int t = 0; t < kChunk; ++t) {
        if (t >= lo && t < hi) {
          const float rv = to_f32(rr[t * rs + d]);
          const float kv = to_f32(kk[t * rs + d]);
          rt[t * fs + d] = t > 0 ? rv * exp2_approx(la[t - 1]) : rv;
          kt[t * fs + d] = kv * exp2_approx(-la[t]);          // k_j / A_j
          kr[t * fs + d] = kv * exp2_approx(last - la[t]);    // k_rev
          pb[t * fs + d] = rv * ud * kv;
        }
      }
    }
    __syncthreads();   // the decayed tiles, A_last and r u k

    // 2a. the state term O^T[e][t] = S^T (r A)^T, before the update
    float o[2][4] = {}, os[2][4] = {};
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      if (8 * n < hd) {
        uint32_t ahi[4], alo[4];
        split(st[n][0], ahi[0], alo[0]);
        split(st[n][2], ahi[1], alo[1]);
        split(st[n][1], ahi[2], alo[2]);
        split(st[n][3], ahi[3], alo[3]);
#pragma unroll
        for (int tt = 0; tt < 2; ++tt) {
          const float2 x = *reinterpret_cast<const float2*>(
              rt + (8 * tt + g) * fs + 8 * n + 2 * q);
          mma3(o[tt], os[tt], ahi, alo, x.x, x.y);
        }
      }
    }
    // 2b. the update S^T = S^T diag(A_last) + V^T k_rev, V^T[e][t] the A
    //     fragments (also of the intra-chunk product below)
    uint32_t vhi[2][4], vlo[2][4];
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) {
      const T* v0 = vv + (8 * ks + q) * vs;
      const T* v1 = v0 + 4 * vs;
      split(to_f32(v0[ea]), vhi[ks][0], vlo[ks][0]);
      split(to_f32(v0[eb]), vhi[ks][1], vlo[ks][1]);
      split(to_f32(v1[ea]), vhi[ks][2], vlo[ks][2]);
      split(to_f32(v1[eb]), vhi[ks][3], vlo[ks][3]);
    }
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      if (8 * n < hd) {
        const float2 l = *reinterpret_cast<const float2*>(al + 8 * n + 2 * q);
        st[n][0] *= l.x;
        st[n][1] *= l.y;
        st[n][2] *= l.x;
        st[n][3] *= l.y;
        float small[4] = {};
#pragma unroll
        for (int ks = 0; ks < 2; ++ks)
          mma3(st[n], small, vhi[ks], vlo[ks],
               kr[(8 * ks + q) * fs + 8 * n + g],
               kr[(8 * ks + q + 4) * fs + 8 * n + g]);
#pragma unroll
        for (int i = 0; i < 4; ++i) st[n][i] += small[i];
      }
    }
    // 2c. the causal scores (r A)(k / A)^T, one 8-column tile of j for
    //     each of the first two warps, strictly below the diagonal
    if (warp < 2) {
      const int jt = warp;
      float s[4] = {}, ss[4] = {};
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        if (8 * n < hd) {
          uint32_t ahi[4], alo[4];
          const float* r0 = rt + g * fs + 8 * n + q;
          const float* r1 = r0 + 8 * fs;
          split(r0[0], ahi[0], alo[0]);
          split(r1[0], ahi[1], alo[1]);
          split(r0[4], ahi[2], alo[2]);
          split(r1[4], ahi[3], alo[3]);
          const float* k0 = kt + (8 * jt + g) * fs + 8 * n + q;
          mma3(s, ss, ahi, alo, k0[0], k0[4]);
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) s[i] += ss[i];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = g + (i < 2 ? 0 : 8), j = 8 * jt + 2 * q + (i & 1);
        if (j != t) sc[t * kScoreStride + j] = j < t ? s[i] : 0.0f;
      }
    }
    // 2d. the bonus r_t . (u k_t) on the diagonal, on the last two warps
    //     (those that skip the scores): lanes (t, 4 quarters) sum a quarter
    //     of the key channels, then the quarters in order
    static_assert(4 * kChunk == kThreads / 2, "a bonus lane a thread");
    if (warp >= 2) {
      const int i = tid - kThreads / 2, t = i >> 2;
      float bonus = 0.0f;
      for (int d = i & 3; d < hd; d += 4) bonus += pb[t * fs + d];
      bonus += __shfl_xor_sync(0xffffffffu, bonus, 1);
      bonus += __shfl_xor_sync(0xffffffffu, bonus, 2);
      if ((i & 3) == 0) sc[t * kScoreStride + t] = bonus;
    }
    __syncthreads();   // the scores

    // 3. out^T[e][t] += V^T[e][j] scores^T[j][t], then out
#pragma unroll
    for (int tt = 0; tt < 2; ++tt) {
#pragma unroll
      for (int ks = 0; ks < 2; ++ks) {
        const float* s0 = sc + (8 * tt + g) * kScoreStride + 8 * ks + q;
        mma3(o[tt], os[tt], vhi[ks], vlo[ks], s0[0], s0[4]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) o[tt][i] += os[tt][i];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = 8 * tt + 2 * q + (i & 1), e = i < 2 ? ea : eb;
        if (e < ncols)
          store(out + base + (static_cast<int64_t>(c) * kChunk + t) * row +
                    e0 + e,
                o[tt][i]);
      }
    }
  }
#pragma unroll
  for (int n = 0; n < NT; ++n) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int d = 8 * n + 2 * q + (i & 1), e = i < 2 ? ea : eb;
      if (d < hd && e < ncols)
        state_out[sbase + static_cast<int64_t>(d) * hd + e0 + e] = st[n][i];
    }
  }
}

template <typename T, int NT>
int launch(const void* r, const void* k, const void* v, const void* w,
           const float* u, const float* state0, void* out, float* state_out,
           int B, int S, int H, int hd, int vec, cudaStream_t s) {
  auto kern = wkv_chunked_kernel<T, NT>;
  const int64_t smem = smem_bytes(hd, sizeof(T));
  // the opt-in above 48 KB, once per device for the largest size asked
  static int64_t granted[64] = {};
  if (smem > 48 * 1024) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev >= 64) return cudaErrorInvalidDevice;
    if (smem > granted[dev]) {
      err = cudaFuncSetAttribute(
          kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(smem));
      if (err != cudaSuccess) return static_cast<int>(err);
      granted[dev] = smem;
    }
  }
  const int64_t blocks =
      static_cast<int64_t>(B) * H * ((hd + kSlice - 1) / kSlice);
  if (blocks >= (int64_t(1) << 31)) return cudaErrorInvalidValue;
  kern<<<static_cast<unsigned>(blocks), kThreads, smem, s>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(w), u, state0,
      static_cast<T*>(out), state_out, S, H, hd, vec);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* r, const void* k, const void* v, const void* w,
             const float* u, const float* state0, void* out, float* so,
             int B, int S, int H, int hd, int vec, cudaStream_t s) {
  if (hd <= 16)
    return launch<T, 2>(r, k, v, w, u, state0, out, so, B, S, H, hd, vec, s);
  if (hd <= 32)
    return launch<T, 4>(r, k, v, w, u, state0, out, so, B, S, H, hd, vec, s);
  if (hd <= 64)
    return launch<T, 8>(r, k, v, w, u, state0, out, so, B, S, H, hd, vec, s);
  if (hd <= 128)
    return launch<T, 16>(r, k, v, w, u, state0, out, so, B, S, H, hd, vec, s);
  return launch<T, 32>(r, k, v, w, u, state0, out, so, B, S, H, hd, vec, s);
}

}  // namespace

// dtype: 0 = fp32, 1 = bf16, of r, k, v, w and out; u, state0 and
// state_out are fp32; state0 may be null (a zero state). All contiguous;
// S a multiple of 16; 1 <= hd <= 256. vec: every row of r, k, v, w starts
// 16-byte aligned (hd * size a multiple of 16, aligned bases), so the
// tiles are copied with cp.async. Returns cudaGetLastError() after the
// launch (cudaErrorInvalidValue for what the kernel does not take).
extern "C" int wkv_chunked_launch(const void* r, const void* k,
                                  const void* v, const void* w,
                                  const void* u, const void* state0,
                                  void* out, void* state_out, int B, int S,
                                  int H, int hd, int dtype, int vec,
                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (hd < 1 || hd > kMaxHead || S % kChunk != 0) return cudaErrorInvalidValue;
  if (B <= 0 || H <= 0) return 0;
  const float* uf = static_cast<const float*>(u);
  const float* s0 = static_cast<const float*>(state0);
  float* so = static_cast<float*>(state_out);
  if (dtype == 0)
    return dispatch<float>(r, k, v, w, uf, s0, out, so, B, S, H, hd, vec, s);
  return dispatch<__nv_bfloat16>(r, k, v, w, uf, s0, out, so, B, S, H, hd,
                                 vec, s);
}
