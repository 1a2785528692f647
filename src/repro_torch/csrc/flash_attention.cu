// flash_attention: the prefill attention forward pass, causal and/or
// sliding-window, with grouped-query heads. q (B, Sq, Hq, Dh), k and v
// (B, Sk, Hkv, Dh), all fp32 or all bf16, contiguous; out (B, Sq, Hq, Dh)
// in q's type. Query row r sits at position q_pos = q_offset + r, key c at
// position c; q head h reads KV head h / (Hq / Hkv):
//
//   s_rc  = (q_r . k_c) / sqrt(Dh)     if c <= q_pos (causal) and
//                                      c > q_pos - window (a window),
//   s_rc  = -1e30                      otherwise,
//   out_r = sum_c softmax(s_r)_c v_c, by an online softmax with fp32
//           (acc, m, l), divided by max(l, 1e-30) at the end.
//
// Replaces the TPU kernel repro/kernels/attention/kernel.py::
// flash_attention, a (B Hq, Sq/bq, Sk/bk) Pallas grid whose sequential KV
// axis carries (acc, m, l) in VMEM scratch from one step to the next. A
// CUDA grid carries nothing between blocks, so one block of eight warps
// owns one (b h, 128-row query tile) and a loop inside it walks the 32-key
// tiles in order; warp w owns query rows 16 w .. 16 w + 15.
//
// Bound on the H100 by operations: 4 Dh flops per admitted (q, k) pair.
// Both products run on the tf32 tensor cores (495 TFLOP/s dense) as
// mma.sync m16n8k8 (mma_tf32.cuh):
//   * fp32: each product is three tf32 products (hi hi + hi lo + lo hi of
//     x = hi + lo, split by integer ops), which keeps an fp32 product's
//     accuracy, so the bound is 495 / 3 = 165 TFLOP/s (the fp32 FMAs
//     outside the tensor cores give 67);
//   * bf16: q, k and v are exact in tf32, so Q K^T is one tf32 product
//     and P V two (P, fp32, split into hi + lo; V exact).
// The bytes (q, k, v and out once) are some 10 times less at the prefill
// shapes. On the card the kernel's time moves with its count of MMAs, in
// fp32 and bf16 alike, at well under the tensor cores' rate; wgmma, the
// path to the full rate, takes tf32 B operands only K-major, so V would
// have to be transposed in shared memory.
//   * S = Q K^T: the warp's 16 x 32 scores are the accumulators of four
//     m16n8 tiles (16 floats a lane), summed over d in chunks of 16
//     columns, two k-steps of 8: lane (g, q) reads columns 4 q .. 4 q + 3
//     of a chunk (Q's rows g and g + 8, K's key g) in one 16-byte load, and
//     k-step s takes columns 4 q + 2 s and 4 q + 2 s + 1 as its k = q and
//     q + 4, the same order for Q and K. In fp32 each kFresh chunks' three
//     products go into fresh accumulators that are then added to S in
//     fp32: the tensor cores' own additions round toward zero, and a chain
//     of 3 Dh / 8 of them made the largest error 7x the plain version's at
//     gemma3-4b's shapes (3-5x with the fresh sums; O's own sum over the
//     key tiles stays on the tensor cores).
//   * the mask, scale and online softmax run on those accumulators in
//     fp32: a lane holds two columns of rows g and g + 8 in each tile, so
//     a row's max is its lane's 8 values and two xor shuffles over the
//     four lanes of a quad; each lane keeps its own part of the row sum l
//     (rescaled with the row's common alpha) and the quad adds the four
//     parts at the end. exp is expf, as accurate as the plain version's.
//   * O += P V: the probabilities stay in registers. The C fragment of a
//     score tile is an A fragment of P with the k order permuted (k = q
//     takes key 2 q, k = q + 4 key 2 q + 1), and V's B fragments follow
//     that order. Output tile 4 m + e, MMA column c, is head column
//     32 m + 4 c + e, so lane (g, q) reads the B values of four tiles in
//     one load of V's columns 32 m + 4 g .. + 3, and writes columns
//     32 m + 8 q .. + 7 of its rows as two 4-element stores.
//   * Registers at Dh = 256: the output's 16 x 256 a warp is 32 m16n8
//     tiles, 128 fp32 accumulators a lane; the scores 16, their fresh sums
//     16; Q stays in shared memory (its hi/lo fragments would take another
//     256 a lane) and is split as it is read; the B values of four tiles
//     are split together and their small products issued before the large
//     ones, so that four independent chains run side by side. ptxas -v
//     gives the Dh = 256 instances 252 (fp32) and 235 (bf16) registers a
//     lane, under the 255 that the launch bound of one 256-thread block an
//     SM allows, with no spills; no MMA is predicated (predicated MMAs made
//     ptxas spill 1.6 KB a lane).
//   * Loads ahead of use: Q (128 rows), a K tile and a V tile (32 keys
//     each) are staged in shared memory by cp.async (16 bytes a copy; 8 for
//     bf16 rows that are not 16-byte aligned), one buffer each, interleaved
//     as in FlashAttention-2: K(t + 1) is in flight while the softmax and
//     P V(t) run, V(t + 1) while the scores of t + 1 run. Rows past Sq or Sk
//     are zero-filled by the copies themselves, columns Dh .. (Dh rounded up
//     to 64) once at the start.
//   * Shared memory: Q and K rows of Dh rounded up to 64, plus 16 values;
//     V rows plus 4 (fp32) or 8 (bf16): the groups of a fragment load fall
//     in distinct banks. 207,360 bytes at Dh = 256 in fp32 (one block an
//     SM), 103,936 in bf16. (64-row blocks of four warps with 64-key tiles
//     were 1.3-1.5x slower on the card: one warp a scheduler hid nothing.)
//   * tiles a query tile cannot see (past the causal diagonal, before the
//     window) are skipped. That is exact for a row with at least one
//     admitted key: a tile it sees only masked scores of before its first
//     admitted key is wiped by alpha = exp(-1e30 - m) = 0 anyway. A row
//     with no admitted key at all (q_pos - window >= Sk - 1, or q_pos < 0
//     when causal) scores -1e30 everywhere and gets the mean of V, as in
//     the reference; a block that holds such a row walks every tile.
//   * ragged edges are masked: rows past Sq are computed on zeros and not
//     stored; keys past Sk score -inf, so their probability is exactly 0
//     even in a row with no admitted key.
//   * with a log-sum-exp pointer (the training forward, kLse), a row's
//     m + log(l) is written to lse (B, Hq, Sq) fp32 for the backward
//     (flash_attention_bwd.cu); inference launches pass none and run the
//     instance without that store.
// Every sum runs in a fixed order, with no atomics: the same inputs give
// byte-identical results. The output's accumulators bound Dh to 256, and
// the wrapper refuses wider heads (kernels/attention/flash.py).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_tf32.cuh"

namespace {

using repro::cp_async16;
using repro::cp_async8;
using repro::cp_async_commit;
using repro::cp_async_wait;
using repro::mma_tf32;
using repro::mma_tf32_new;
using repro::split;

constexpr int kWarps = 8;         // 16 query rows each
constexpr int kThreads = 32 * kWarps;
constexpr int kBQ = 16 * kWarps;  // query rows a block owns
constexpr int kBK = 32;           // keys a tile holds
constexpr int kKeyTiles = kBK / 8;   // m16n8 score tiles a warp
constexpr int kFresh = 2;         // 16-column chunks a fresh fp32 sum of
                                  // Q K^T takes
constexpr float kNegInf = -1e30f;

// The output columns a warp holds (its m16n8 tiles, 8 NT = 64 ceil(Dh /
// 64)) and the row strides of the staged tiles, in elements: Q and K rows
// are read as 16-byte (fp32) or 8-byte (bf16) groups of 4, rows g = 0 .. 7
// of a tile together, V rows 2 q, q = 0 .. 3, together; the padding puts
// the groups of one request in distinct banks.
__host__ __device__ inline int out_cols(int dh) { return (dh + 63) / 64 * 64; }
__host__ __device__ inline int qk_stride(int dh) { return out_cols(dh) + 16; }
__host__ __device__ inline int v_stride(int dh, int size) {
  return out_cols(dh) + (size == 4 ? 4 : 8);
}
__host__ __device__ inline int64_t smem_bytes(int dh, int size) {
  return (static_cast<int64_t>(kBQ + kBK) * qk_stride(dh) +
          static_cast<int64_t>(kBK) * v_stride(dh, size)) * size;
}

__device__ __forceinline__ void store4(float* p, float a, float b, float c,
                                       float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float a, float b,
                                       float c, float d) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(a, b);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(c, d);
  uint2 w;
  w.x = *reinterpret_cast<const uint32_t*>(&lo);
  w.y = *reinterpret_cast<const uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = w;
}
__device__ __forceinline__ void zero(float* p) { *p = 0.0f; }
__device__ __forceinline__ void zero(__nv_bfloat16* p) {
  *p = __float2bfloat16(0.0f);
}

// MMA operands read from a staged tile four elements at a time: fp32 is
// split into hi + lo; a bf16 value is exact in tf32 (its fp32 bits), its
// lo 0.
template <typename T>
struct Operand;
template <>
struct Operand<float> {
  static constexpr bool kExact = false;
  using B = float;
  __device__ static void load4(const float* p, float (&x)[4]) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    x[0] = v.x;
    x[1] = v.y;
    x[2] = v.z;
    x[3] = v.w;
  }
  __device__ static float b(float x) { return x; }
  __device__ static void a(float x, uint32_t& hi, uint32_t& lo) {
    split(x, hi, lo);
  }
};
template <>
struct Operand<__nv_bfloat16> {
  static constexpr bool kExact = true;
  using B = uint32_t;
  __device__ static void load4(const __nv_bfloat16* p, float (&x)[4]) {
    const uint2 v = *reinterpret_cast<const uint2*>(p);
    x[0] = __uint_as_float(v.x << 16);
    x[1] = __uint_as_float(v.x & 0xffff0000u);
    x[2] = __uint_as_float(v.y << 16);
    x[3] = __uint_as_float(v.y & 0xffff0000u);
  }
  __device__ static uint32_t b(float x) { return __float_as_uint(x); }
  __device__ static void a(float x, uint32_t& hi, uint32_t& lo) {
    hi = __float_as_uint(x);
    lo = 0u;
  }
};

// c[c0 + i] += A B_i for the four tiles i: A = (ah, al), exact when
// kAExact; B_i = (b[i][0], b[i][1]), fp32 to be split or tf32 bits. The
// small products of the four first, then the large ones, so that the four
// chains run side by side; `fresh` writes c with the first product (C = 0).
// (No MMA is predicated: predicated MMAs on accumulators held across the
// tile loop made ptxas spill them.)
template <bool kAExact, int N>
__device__ __forceinline__ void mma_group(float (&c)[N][4], int c0,
                                          const uint32_t (&ah)[4],
                                          const uint32_t (&al)[4],
                                          const float (&b)[4][2],
                                          bool fresh = false) {
  static_assert(!kAExact, "an exact A takes the tf32-bits B");
  uint32_t bh[4][2], bl[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    split(b[i][0], bh[i][0], bl[i][0]);
    split(b[i][1], bh[i][1], bl[i][1]);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (fresh) mma_tf32_new(c[c0 + i], al, bh[i][0], bh[i][1]);
    else mma_tf32(c[c0 + i], al, bh[i][0], bh[i][1]);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) mma_tf32(c[c0 + i], ah, bl[i][0], bl[i][1]);
#pragma unroll
  for (int i = 0; i < 4; ++i) mma_tf32(c[c0 + i], ah, bh[i][0], bh[i][1]);
}
template <bool kAExact, int N>
__device__ __forceinline__ void mma_group(float (&c)[N][4], int c0,
                                          const uint32_t (&ah)[4],
                                          const uint32_t (&al)[4],
                                          const uint32_t (&b)[4][2]) {
  if (!kAExact) {
#pragma unroll
    for (int i = 0; i < 4; ++i) mma_tf32(c[c0 + i], al, b[i][0], b[i][1]);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) mma_tf32(c[c0 + i], ah, b[i][0], b[i][1]);
}

// NT: the output's m16n8 tiles a warp holds, 8 ceil(Dh / 64); kLse: also
// write each row's log-sum-exp
template <typename T, int NT, bool kLse>
__global__ void __launch_bounds__(kThreads, 1)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out,
                       float* __restrict__ lse, int Sq, int Sk, int Hq,
                       int Hkv, int Dh, int causal, int window, int q_offset,
                       float scale, int vec) {
  using Op = Operand<T>;
  static_assert(kKeyTiles == 4 && NT % 4 == 0, "groups of four tiles");
  extern __shared__ __align__(16) unsigned char smem[];
  const int DQ = qk_stride(Dh), DV = v_stride(Dh, sizeof(T));
  T* qs = reinterpret_cast<T*>(smem);   // kBQ x DQ: Q of the tile
  T* ks = qs + kBQ * DQ;                // kBK x DQ: K of the KV tile
  T* vs = ks + kBK * DQ;                // kBK x DV: V of the KV tile

  const int b = blockIdx.x / Hq, h = blockIdx.x % Hq;
  const int hk = h / (Hq / Hkv);
  // the last query tiles see the most keys under a causal mask: start them
  // first
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;
  const int rows = min(kBQ, Sq - q0);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, qd = lane & 3;

  const int64_t q_row = static_cast<int64_t>(Hq) * Dh;    // one position
  const int64_t k_row = static_cast<int64_t>(Hkv) * Dh;
  const T* qb = q + (static_cast<int64_t>(b) * Sq + q0) * q_row +
                static_cast<int64_t>(h) * Dh;
  const T* kb = k + static_cast<int64_t>(b) * Sk * k_row +
                static_cast<int64_t>(hk) * Dh;
  const T* vb = v + static_cast<int64_t>(b) * Sk * k_row +
                static_cast<int64_t>(hk) * Dh;

  // columns Dh .. 8 NT - 1 are never copied: the last chunk of the scores
  // and the last output tiles read them as zeros
  const int pad = 8 * NT - Dh;
  for (int i = tid; i < (kBQ + kBK) * pad; i += kThreads)
    zero(qs + (i / pad) * DQ + Dh + i % pad);
  for (int i = tid; i < kBK * pad; i += kThreads)
    zero(vs + (i / pad) * DV + Dh + i % pad);

  // The copies: a row is nu units of `per` elements (16 bytes, or 8 where
  // a bf16 row is not 16-byte aligned); a thread walks the units tid,
  // tid + kThreads, ... of a tile in (row, unit) order, the same walk for
  // every tile.
  const int per = (vec ? 16 : 8) / static_cast<int>(sizeof(T));
  const int nu = Dh / per;
  const int r0 = tid / nu, u0 = tid - r0 * nu;
  const int dr = kThreads / nu, du = kThreads - dr * nu;
  auto stage = [&](T* dst, int stride, const T* src, int64_t row,
                   int n_rows, int valid) {
    for (int r = r0, u = u0; r < n_rows;) {
      const bool ok = r < valid;
      const T* from = ok ? src + r * row + u * per : src;
      if (vec) cp_async16(dst + r * stride + u * per, from, ok);
      else cp_async8(dst + r * stride + u * per, from, ok);
      r += dr;
      u += du;
      if (u >= nu) { u -= nu; ++r; }
    }
    cp_async_commit();
  };

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

  stage(qs, DQ, qb, q_row, kBQ, rows);
  stage(ks, DQ, kb + static_cast<int64_t>(t_lo) * kBK * k_row, k_row, kBK,
        Sk - t_lo * kBK);
  stage(vs, DV, vb + static_cast<int64_t>(t_lo) * kBK * k_row, k_row, kBK,
        Sk - t_lo * kBK);

  float o[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) o[n][i] = 0.0f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.0f, 0.0f};
  // Q K^T sums over d in chunks of 16 columns, two k-steps of 8: lane
  // (g, q) reads columns 4 q .. 4 q + 3 of the chunk (of Q's rows g, g + 8
  // and K's key g) in one load, and k-step s takes columns 4 q + 2 s and
  // 4 q + 2 s + 1 as its k = q and q + 4, the same order for Q and K
  const T* qa = qs + (16 * warp + g) * DQ + 4 * qd;
  const T* kr = ks + g * DQ + 4 * qd;
  const int d_end = (Dh + 16 * kFresh - 1) / (16 * kFresh) * (16 * kFresh);

  for (int t = t_lo; t <= t_hi; ++t) {
    const int c0 = t * kBK;
    cp_async_wait<1>();   // Q and K(t) have landed (V(t) may not have)
    __syncthreads();

    // S = Q K^T. In fp32 the three products of kFresh chunks go into a
    // fresh accumulator that is then added to S: the tensor cores' own
    // additions round toward zero, and a running sum of 3 Dh / 8 of them
    // would drift.
    float s[kKeyTiles][4];
#pragma unroll
    for (int j = 0; j < kKeyTiles; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[j][i] = 0.0f;
#pragma unroll 1
    for (int d0 = 0; d0 < d_end; d0 += 16 * kFresh) {
      float f[kKeyTiles][4];
#pragma unroll
      for (int ch = 0; ch < kFresh; ++ch) {
        const int d = d0 + 16 * ch;
        float x[4], y[4], kv[kKeyTiles][4];
        Op::load4(qa + d, x);
        Op::load4(qa + 8 * DQ + d, y);
#pragma unroll
        for (int j = 0; j < kKeyTiles; ++j)
          Op::load4(kr + 8 * j * DQ + d, kv[j]);
#pragma unroll
        for (int st = 0; st < 2; ++st) {
          uint32_t ah[4], al[4];
          Op::a(x[2 * st], ah[0], al[0]);
          Op::a(y[2 * st], ah[1], al[1]);
          Op::a(x[2 * st + 1], ah[2], al[2]);
          Op::a(y[2 * st + 1], ah[3], al[3]);
          typename Op::B bf[kKeyTiles][2];
#pragma unroll
          for (int j = 0; j < kKeyTiles; ++j) {
            bf[j][0] = Op::b(kv[j][2 * st]);
            bf[j][1] = Op::b(kv[j][2 * st + 1]);
          }
          if constexpr (Op::kExact)
            mma_group<true>(s, 0, ah, al, bf);
          else
            mma_group<false>(f, 0, ah, al, bf, ch == 0 && st == 0);
        }
      }
      if constexpr (!Op::kExact) {
#pragma unroll
        for (int j = 0; j < kKeyTiles; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[j][e] += f[j][e];
      }
    }
    __syncthreads();      // every warp is done with K(t)
    if (t < t_hi)
      stage(ks, DQ, kb + static_cast<int64_t>(c0 + kBK) * k_row, k_row, kBK,
            Sk - c0 - kBK);
    else
      cp_async_commit();  // an empty group keeps the count of groups

    // scale, mask, then the online softmax of rows g (r = 0) and g + 8
    // (r = 1) over this tile
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qp = q_offset + q0 + 16 * warp + g + 8 * r;
      float mt = -INFINITY;
#pragma unroll
      for (int j = 0; j < kKeyTiles; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = c0 + 8 * j + 2 * qd + e;
          float x = s[j][2 * r + e] * scale;
          if (c >= Sk)
            x = -INFINITY;
          else if ((causal && c > qp) || (window > 0 && c <= qp - window))
            x = kNegInf;
          s[j][2 * r + e] = x;
          mt = fmaxf(mt, x);
        }
      }
      mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 1));
      mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 2));
      const float mn = fmaxf(m[r], mt);
      const float alpha = expf(m[r] - mn);
      float ls = 0.0f;
#pragma unroll
      for (int j = 0; j < kKeyTiles; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float p = expf(s[j][2 * r + e] - mn);
          s[j][2 * r + e] = p;
          ls += p;
        }
      }
      l[r] = l[r] * alpha + ls;
      m[r] = mn;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        o[n][2 * r] *= alpha;
        o[n][2 * r + 1] *= alpha;
      }
    }

    cp_async_wait<1>();   // V(t) has landed (K(t + 1) may not have)
    __syncthreads();
    // O += P V over the tile's keys in order (keys past Sk: p = v = 0).
    // Output tile 4 m + e, column c of the MMA, is column 32 m + 4 c + e
    // of the head: lane (g, q) reads V columns 32 m + 4 g .. + 3 of keys
    // 2 q and 2 q + 1 in two loads for four tiles.
#pragma unroll
    for (int kk = 0; kk < kKeyTiles; ++kk) {
      uint32_t ph[4], pl[4];
      split(s[kk][0], ph[0], pl[0]);
      split(s[kk][2], ph[1], pl[1]);
      split(s[kk][1], ph[2], pl[2]);
      split(s[kk][3], ph[3], pl[3]);
      const T* vr = vs + (8 * kk + 2 * qd) * DV + 4 * g;
#pragma unroll
      for (int n0 = 0; n0 < NT; n0 += 4) {
        float v0[4], v1[4];
        Op::load4(vr + 8 * n0, v0);
        Op::load4(vr + DV + 8 * n0, v1);
        typename Op::B bf[4][2];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          bf[e][0] = Op::b(v0[e]);
          bf[e][1] = Op::b(v1[e]);
        }
        mma_group<false>(o, n0, ph, pl, bf);
      }
    }
    __syncthreads();      // every warp is done with V(t)
    if (t < t_hi)
      stage(vs, DV, vb + static_cast<int64_t>(c0 + kBK) * k_row, k_row, kBK,
            Sk - c0 - kBK);
    else
      cp_async_commit();
  }

  T* ob = out + (static_cast<int64_t>(b) * Sq + q0) * q_row +
          static_cast<int64_t>(h) * Dh;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float lr = l[r];
    lr += __shfl_xor_sync(0xffffffffu, lr, 1);
    lr += __shfl_xor_sync(0xffffffffu, lr, 2);
    const float denom = fmaxf(lr, 1e-30f);
    const int row = 16 * warp + g + 8 * r;
    if (row >= rows) continue;
    if constexpr (kLse) {
      if (qd == 0)
        lse[(static_cast<int64_t>(b) * Hq + h) * Sq + q0 + row] =
            m[r] + logf(lr);
    }
#pragma unroll
    for (int n0 = 0; n0 < NT; n0 += 4) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int d = 8 * n0 + 8 * qd + 4 * half, i = 2 * r + half;
        if (d < Dh)
          store4(ob + row * q_row + d, o[n0][i] / denom,
                 o[n0 + 1][i] / denom, o[n0 + 2][i] / denom,
                 o[n0 + 3][i] / denom);
      }
    }
  }
}

template <typename T, int NT, bool kLse>
int launch(const void* q, const void* k, const void* v, void* out,
           float* lse, int B, int Sq, int Sk, int Hq, int Hkv, int Dh,
           int causal, int window, int q_offset, float scale, int vec,
           cudaStream_t s) {
  auto kern = flash_attention_kernel<T, NT, kLse>;
  const int64_t smem = smem_bytes(Dh, sizeof(T));
  // the opt-in above 48 KB, once per device (and instance) for the largest
  // size asked
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
  const dim3 grid(B * Hq, (Sq + kBQ - 1) / kBQ);
  kern<<<grid, kThreads, smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), lse, Sq, Sk, Hq, Hkv,
      Dh, causal, window, q_offset, scale, vec);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool kLse>
int dispatch_nt(const void* q, const void* k, const void* v, void* out,
                float* lse, int B, int Sq, int Sk, int Hq, int Hkv, int Dh,
                int causal, int window, int q_offset, float scale, int vec,
                cudaStream_t s) {
#define REPRO_FLASH_FWD(NT)                                                \
  return launch<T, NT, kLse>(q, k, v, out, lse, B, Sq, Sk, Hq, Hkv, Dh,    \
                             causal, window, q_offset, scale, vec, s)
  switch ((Dh + 63) / 64) {
    case 1: REPRO_FLASH_FWD(8);
    case 2: REPRO_FLASH_FWD(16);
    case 3: REPRO_FLASH_FWD(24);
    case 4: REPRO_FLASH_FWD(32);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef REPRO_FLASH_FWD
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* out,
             float* lse, int B, int Sq, int Sk, int Hq, int Hkv, int Dh,
             int causal, int window, int q_offset, float scale, int vec,
             cudaStream_t s) {
  if (lse != nullptr)
    return dispatch_nt<T, true>(q, k, v, out, lse, B, Sq, Sk, Hq, Hkv, Dh,
                                causal, window, q_offset, scale, vec, s);
  return dispatch_nt<T, false>(q, k, v, out, lse, B, Sq, Sk, Hq, Hkv, Dh,
                               causal, window, q_offset, scale, vec, s);
}

}  // namespace

// dtype: 0 = fp32, 1 = bf16, of q, k, v and out; all contiguous and
// 16-byte (fp32) or 8-byte (bf16) aligned. vec: every row of q, k and v
// starts 16-byte aligned (always so for fp32; for bf16 Dh a multiple of 8
// and 16-byte aligned bases), so the tiles are copied 16 bytes at a time.
// causal: 0 or 1; window <= 0 means no sliding window. Dh a multiple of 4
// up to 256 and Hq a multiple of Hkv (the wrapper checks all three).
// lse: null, or (B, Hq, Sq) fp32 for each row's log-sum-exp m + log(l).
// Returns cudaGetLastError() after the launch.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, void* lse,
                                      int B, int Sq, int Sk, int Hq, int Hkv,
                                      int Dh, int causal, int window,
                                      int q_offset, float scale, int dtype,
                                      int vec, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || Sq <= 0 || Sk <= 0 || Hq <= 0 || Hkv <= 0 || Dh <= 0)
    return 0;
  if (Dh > 256 || Dh % 4 != 0 || Hq % Hkv != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  float* l = static_cast<float*>(lse);
  if (dtype == 0)
    return dispatch<float>(q, k, v, out, l, B, Sq, Sk, Hq, Hkv, Dh, causal,
                           window, q_offset, scale, 1, s);
  return dispatch<__nv_bfloat16>(q, k, v, out, l, B, Sq, Sk, Hq, Hkv, Dh,
                                 causal, window, q_offset, scale, vec, s);
}
