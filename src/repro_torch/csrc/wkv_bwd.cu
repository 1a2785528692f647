// wkv_chunked_bwd: the gradient of wkv.cu's chunked RWKV6 WKV. r, k, v, w,
// dout (B, S, H, hd), all fp32 or all bf16 (widened to fp32); u (H, hd)
// fp32; state0 (B, H, hd, hd) fp32 or null (zero); dstate (B, H, hd, hd)
// fp32 or null (zero), the gradient of the final state. Out: dr, dk, dv,
// dw (B, S, H, hd) in r's type, du (H, hd) fp32, dstate0 (B, H, hd, hd)
// fp32.
//
// No TPU kernel corresponds: the reference differentiates its jnp
// _wkv_chunked (repro/models/blocks.py), the chunked form of the TPU
// kernel repro/kernels/rwkv/kernel.py::wkv_chunked. The chunked form is
// exact for any chunk length, so the gradient is taken over spans of L
// positions, each L / 16 chunks of 16: L = 32 up to hd 128 (at rwkv6-7b's
// hd 64 spans of 32 ran faster on the H100 than spans of 64 or 16), 16
// above, so that a span's rows fit a block. With la the inclusive sum of log w
// from the span's start, lae = la - log w, A = exp(la), S the state
// entering the span, G the gradient of the state leaving it, for j < t in
// the span D_tj = A_{t-1} / A_j (per key channel, <= 1), P_tj = r_t .
// (D_tj k_j), b_t = r_t . (u k_t), dov_tj = dout_t . v_j, Kr_j =
// (A_last / A_j) k_j:
//
//   dv_j  = sum_{t>j} P_tj dout_t + b_j dout_j + G^T Kr_j
//   dr_t  = A_{t-1} S dout_t + sum_{j<t} dov_tj D_tj k_j + dov_tt u k_t
//   dk_j  = sum_{t>j} dov_tj D_tj r_t + (A_last / A_j) G v_j + dov_jj u r_j
//   du    = sum_{b,t} dov_tt r_t k_t
//   d lae_t = r_t (dr_t - dov_tt u k_t),  d la_j = -k_j (dk_j - dov_jj u r_j)
//             plus, at the span's last position, sum_j Kr_j (G v_j) +
//             A_last rowsum(S o G)
//   d lw_s  = sum_{t>=s} d la_t + sum_{t>s} d lae_t,  dw = d lw / w
//
// (dw is 0 where w < 1e-8, as the forward's log(max(w, 1e-8)) gives), and
// the states carried from span to span: S_next = diag(A_last) S + U,
// U = sum_j Kr_j v_j^T; G_before = diag(A_last) G + W, W = sum_t Q_t
// dout_t^T, Q_t = A_{t-1} r_t; dstate0 = G before the first span.
//
// Bound on the H100 by bytes: r, k, v, w and dout read once, dr, dk, dv,
// dw written once, 36 bytes a position and channel in fp32 (at rwkv6-7b's
// layer, B 1 x S 4,096 x H 64 x hd 64: 604 MB, 0.18 ms at 3.35 TB/s),
// against some 2 (5 + 3/16) hd^2 flops a position and head (0.08 ms on
// the 3xTF32 tensor cores). Five launches; the only walk along the
// sequence is S / L steps of one FMA a state element:
//   1. wkv_bwd_spans: a block a (b, h, span) writes the span's U and W
//      (hd x hd each, fp32) and A_last to the scratch. The decays come
//      from the span's start and end as plain sums of log2 w (no
//      differences of long sums): every factor is <= 1.
//   2. wkv_bwd_scan: a thread four elements of a state row walks the spans
//      forward, replacing each U by the state entering its span, then
//      backward, replacing each W by the gradient of the state leaving its
//      span, and writes dstate0. Its loads run kAhead spans ahead of the
//      chain.
//   3. wkv_bwd_keys: a block a (b, h, span) computes dr, dk, d lw (into
//      the scratch), its span's part of du and the bonus b_t. Two warps
//      take a chunk's rows (four at one chunk a span), each a share of a
//      slab's columns. dov of its rows against the chunks
//      before (and of the chunks after against its rows) stays in
//      registers as MMA accumulators and feeds the next products as A
//      fragments (their k order follows the accumulator's columns). The
//      products with the states (dout S^T, v G^T) take slabs of rows of S
//      and G staged by cp.async, the first with the span's rows; dr and dk
//      leave through shared memory a row at a time.
//   4. wkv_bwd_values: a block a (b, h, span) computes dv, and dw from d lw
//      and w: a warp takes P^T of its chunk's rows (the bonus on the
//      diagonal), then, for slabs of columns of G, P^T dout + Kr G.
//   5. wkv_bwd_du: du, the spans' parts summed over b and spans in order.
//   Within a span, a pair of chunks (a, b <= a) takes D_tj as A_{t-1} / A_c
//   times A_c / A_j for the first position c of chunk a: factors of one
//   chunk's decay with the chunks between (<= 1), apart from the diagonal
//   pair, whose k_j / A_j over 16 positions is the reference's own form.
//   Every product runs on the tensor cores as three tf32 m16n8k8 MMAs
//   (mma_tf32.cuh's split: x = hi + lo; hi hi + hi lo + lo hi keep an fp32
//   product's accuracy; a bf16 operand is exact in tf32, so the products
//   of its lo, which is 0, are left out), summed over at most kGroup k
//   steps in fresh accumulators and then added in fp32. The logs are
//   log2f, the powers ex2.approx, as in wkv.cu.
// Every sum runs in a fixed order and there are no atomics: the same
// inputs give byte-identical results. The launch bounds (two blocks an SM
// for the scan, four for the keys and values: a cap on registers) ran
// faster on the H100 than none. Scratch (fp32, wkv_chunked_bwd_scratch
// below): the S and G slots (B H S/L hd hd8 each), A_last (B H S/L hd8),
// du's parts (B S/L H hd), the bonus (B H S) and d lw (B S H hd), hd8 =
// hd rounded up to 8: 341 MB at rwkv6-7b's layer. The largest hd is 256;
// the wrapper refuses more on every device (kernels/rwkv/kernel.py).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_tf32.cuh"

namespace {

using repro::cp_async16;
using repro::cp_async_commit;
using repro::cp_async_wait_all;
using repro::mma_tf32;
using repro::split;

constexpr int kChunk = 16;      // positions a chunk
constexpr int kMaxHead = 256;
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kGroup = 4;       // k steps of 8 a fresh sum takes
constexpr int kAhead = 16;      // spans the scan loads ahead of its chain
constexpr int kScanThreads = 256;
constexpr int kCols = 32;       // state rows (keys) or columns (values) a slab
constexpr int kColsP = kCols + 4;   // a row of a span x kCols tile (2-way
                                    // banks for fragment-ordered writes)

// The tiling at a head of hd channels with sizeof(T)-byte operands, in
// elements and bytes (a struct of constants, so that the CPU tests read
// it from this text).
template <typename T>
struct Plan {
  static constexpr int kSize = static_cast<int>(sizeof(T));
  // chunks a span
  __host__ __device__ static constexpr int chunks(int hd) {
    return hd <= 128 ? 2 : 1;
  }
  __host__ __device__ static constexpr int span(int hd) {
    return kChunk * chunks(hd);
  }
  __host__ __device__ static constexpr int hd8(int hd) {
    return (hd + 7) / 8 * 8;
  }
  // a row tile read as fragments of 8 rows x 4 columns, or of rows 2q and
  // 2q + 1 x 8 columns: rows of 32-byte multiples plus 16 bytes
  __host__ __device__ static constexpr int row_stride(int hd) {
    return (hd + 32 / kSize - 1) / (32 / kSize) * (32 / kSize) + 16 / kSize;
  }
  // a k-major tile (spans): fragments of 4 rows x 8 columns
  __host__ __device__ static constexpr int kmajor_stride(int hd) {
    return kSize == 4 ? (hd + 31) / 32 * 32 + 8 : (hd + 15) / 16 * 16 + 8;
  }
  // fp32 tiles: the keys' and values' rows and S and G slabs, and the
  // spans' k-major Q and Kr
  __host__ __device__ static constexpr int f32_stride(int hd) {
    return hd8(hd) + 4;
  }
  __host__ __device__ static constexpr int f32_kmajor(int hd) {
    return (hd + 31) / 32 * 32 + 8;
  }
  // the values' G slab: kCols columns plus 8 (4 rows x 8 columns)
  static constexpr int kGStride = kCols + 8;
  // spans: v, dout (T, k-major); Q and Kr (fp32, k-major)
  __host__ __device__ static constexpr int64_t spans_bytes(int hd) {
    return 2LL * span(hd) * kmajor_stride(hd) * kSize +
           2LL * span(hd) * f32_kmajor(hd) * 4;
  }
  // keys: the slabs of S and G, or five span x kCols tiles (dr, dk, the
  // reverse sums' two and Kr gv)
  __host__ __device__ static constexpr int64_t region_floats(int hd) {
    return 2LL * kCols * f32_stride(hd) > 5LL * span(hd) * kColsP
               ? 2LL * kCols * f32_stride(hd)
               : 5LL * span(hd) * kColsP;
  }
  // keys: r, k, v, dout (T); la (fp32); the region; the chunks' decay,
  // u, dov's diagonal, the slab's tail terms, the reverse sums' parts
  __host__ __device__ static constexpr int64_t keys_bytes(int hd) {
    return 4LL * span(hd) * row_stride(hd) * kSize +
           (1LL * span(hd) * f32_stride(hd) + region_floats(hd) +
            1LL * chunks(hd) * hd8(hd) + hd8(hd) + span(hd) + kCols +
            2LL * chunks(hd) * kCols) * 4;
  }
  // values: G's columns, or later the span's dv columns
  __host__ __device__ static constexpr int64_t slab_floats(int hd) {
    return 1LL * hd8(hd) * kGStride > 1LL * span(hd) * kColsP
               ? 1LL * hd8(hd) * kGStride
               : 1LL * span(hd) * kColsP;
  }
  // values: dout (T); Q and K^ (fp32); the G slab; the chunks' decay, the
  // pairs' factors, the tails' factors, the bonus
  __host__ __device__ static constexpr int64_t values_bytes(int hd) {
    return 1LL * span(hd) * row_stride(hd) * kSize +
           (2LL * span(hd) * f32_stride(hd) + slab_floats(hd) +
            1LL * chunks(hd) * hd8(hd) +
            1LL * chunks(hd) * chunks(hd) * hd8(hd) +
            1LL * chunks(hd) * hd8(hd) + span(hd)) * 4;
  }
};

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
// log2 of a decay as the forward clamps it
__device__ __forceinline__ float log2_decay(float w) {
  return log2f(fmaxf(w, 1e-8f));
}

// The shapes every kernel shares.
struct Geo {
  int B, S, H, hd, hd8, N;   // N spans
  int64_t row;               // H hd: one position
};

// One span's block: (b, h, n), the span's first element and its valid rows.
struct Span {
  int b, h, n, valid;
  int64_t base;
  __device__ Span(const Geo& g, int L) {
    n = blockIdx.x % g.N;
    const int bh = blockIdx.x / g.N;
    b = bh / g.H;
    h = bh % g.H;
    valid = min(L, g.S - n * L);
    base = (static_cast<int64_t>(b) * g.S + static_cast<int64_t>(n) * L) *
               g.row + static_cast<int64_t>(h) * g.hd;
  }
};

// Rows [0, L) of a span of x into a tile of row stride st: 16-byte
// cp.async where every row is 16-byte aligned (vec), plain loads
// otherwise; columns hd .. hd8 and rows past the valid ones zero.
template <typename T>
__device__ void stage_rows(T* tile, int st, const T* __restrict__ x,
                           int64_t base, int64_t row, int L, int valid,
                           int hd, int hd8, int vec) {
  const int tid = threadIdx.x;
  if (vec) {
    constexpr int per = 16 / static_cast<int>(sizeof(T));
    const int nu = hd / per;
    for (int i = tid; i < valid * nu; i += kThreads) {
      const int t = i / nu, c = (i - t * nu) * per;
      cp_async16(tile + t * st + c, x + base + t * row + c);
    }
  } else {
    for (int i = tid; i < valid * hd; i += kThreads) {
      const int t = i / hd, c = i - t * hd;
      tile[t * st + c] = x[base + t * row + c];
    }
  }
  const int pad = hd8 - hd;
  for (int i = tid; i < valid * pad; i += kThreads) {
    const int t = i / pad;
    store(tile + t * st + hd + (i - t * pad), 0.0f);
  }
  for (int i = tid; i < (L - valid) * hd8; i += kThreads) {
    const int t = i / hd8;
    store(tile + (valid + t) * st + (i - t * hd8), 0.0f);
  }
}

// A B as mma_tf32.cuh's mma3 takes it (three tf32 products: hi hi into
// big, hi lo and lo hi into small), without the product of an operand's lo
// where that operand is exact in tf32 (kExactA, kExactB: widened bf16,
// whose lo is 0)
template <bool kExactA = false, bool kExactB = false>
__device__ __forceinline__ void mma3e(float (&big)[4], float (&small)[4],
                                      const uint32_t (&ahi)[4],
                                      const uint32_t (&alo)[4], float b0,
                                      float b1) {
  uint32_t bh0, bl0, bh1, bl1;
  split(b0, bh0, bl0);
  split(b1, bh1, bl1);
  if (!kExactA) mma_tf32(small, alo, bh0, bh1);
  if (!kExactB) mma_tf32(small, ahi, bl0, bl1);
  mma_tf32(big, ahi, bh0, bh1);
}

// big + small of a fresh sum into acc
template <int M>
__device__ __forceinline__ void add_fresh(float (&acc)[M][4],
                                          float (&big)[M][4],
                                          float (&small)[M][4]) {
#pragma unroll
  for (int m = 0; m < M; ++m)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      acc[m][i] += big[m][i] + small[m][i];
      big[m][i] = 0.0f;
      small[m][i] = 0.0f;
    }
}

// The A fragment of the 16 x 8 tile at (row, col) of an fp32 or T tile of
// stride st
template <typename S>
__device__ __forceinline__ void a_frag(const S* tile, int st, int row,
                                       int col, uint32_t (&hi)[4],
                                       uint32_t (&lo)[4]) {
  const int g = (threadIdx.x & 31) >> 2, q = threadIdx.x & 3;
  const S* p = tile + (row + g) * st + col + q;
  split(to_f32(p[0]), hi[0], lo[0]);
  split(to_f32(p[8 * st]), hi[1], lo[1]);
  split(to_f32(p[4]), hi[2], lo[2]);
  split(to_f32(p[8 * st + 4]), hi[3], lo[3]);
}

// The A fragment of an accumulator tile (16 x 8, C layout) read with the
// k order (2q, 2q + 1) for (q, q + 4): B's rows must follow that order.
__device__ __forceinline__ void acc_frag(const float (&c)[4],
                                         uint32_t (&hi)[4],
                                         uint32_t (&lo)[4]) {
  split(c[0], hi[0], lo[0]);
  split(c[2], hi[1], lo[1]);
  split(c[1], hi[2], lo[2]);
  split(c[3], hi[3], lo[3]);
}

// ---------------------------------------------------------------------
// 1. The spans' sums: U = Kr^T v into the S slot, W = Q^T dout into the G
//    slot, A_last.
template <typename T, int NC>
__global__ void __launch_bounds__(kThreads, 3)
wkv_bwd_spans(const T* __restrict__ r, const T* __restrict__ k,
              const T* __restrict__ v, const T* __restrict__ w,
              const T* __restrict__ dout, float* __restrict__ ss,
              float* __restrict__ gg, float* __restrict__ aa, Geo geo,
              int vec) {
  constexpr int L = kChunk * NC;
  constexpr bool kBf16 = sizeof(T) == 2;
  using P = Plan<T>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int hd = geo.hd, hd8 = geo.hd8;
  const int sv = P::kmajor_stride(hd), sx = P::f32_kmajor(hd);
  T* vs = reinterpret_cast<T*>(smem);             // [L][sv]
  T* ds = vs + L * sv;                            // [L][sv]
  float* qs = reinterpret_cast<float*>(ds + L * sv);   // [L][sx]: Q
  float* kr = qs + L * sx;                        // [L][sx]: Kr
  const Span sp(geo, L);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, q = lane & 3;
  const int64_t bh = static_cast<int64_t>(sp.b) * geo.H + sp.h;
  const int64_t hh = static_cast<int64_t>(hd) * hd8;
  float* uslot = ss + (bh * geo.N + sp.n) * hh;
  float* wslot = gg + (bh * geo.N + sp.n) * hh;

  stage_rows(vs, sv, v, sp.base, geo.row, L, sp.valid, hd, hd8, vec);
  stage_rows(ds, sv, dout, sp.base, geo.row, L, sp.valid, hd, hd8, vec);
  cp_async_commit();
  // a thread's elements (t, d) of w, r and k, every load in flight at once:
  // element tid + kThreads m, m < kPer (L hd8 is at most kThreads kPer);
  // past the span or the head w = 1, r = k = 0
  constexpr int kPer = 32;
  const int n = L * hd8;
  float wv[kPer], rv[kPer], kv[kPer];
#pragma unroll
  for (int m = 0; m < kPer; ++m) {
    const int i = tid + m * kThreads, t = i / hd8, d = i - t * hd8;
    const bool in = i < n && t < sp.valid && d < hd;
    const int64_t x = sp.base + t * geo.row + d;
    wv[m] = in ? to_f32(w[x]) : 1.0f;
    rv[m] = in ? to_f32(r[x]) : 0.0f;
    kv[m] = in ? to_f32(k[x]) : 0.0f;
  }
#pragma unroll
  for (int m = 0; m < kPer; ++m) {
    const int i = tid + m * kThreads, t = i / hd8, d = i - t * hd8;
    if (i < n) kr[t * sx + d] = log2_decay(wv[m]);
  }
  __syncthreads();
  // a thread a key channel: the sums of log2 w before t (into qs) and
  // after t (kr), each in position order from its end of the span
  for (int d = tid; d < hd8; d += kThreads) {
    float acc = 0.0f;
    for (int t = 0; t < L; ++t) {
      const float l = kr[t * sx + d];
      qs[t * sx + d] = acc;
      acc += l;
    }
    aa[(bh * geo.N + sp.n) * hd8 + d] = exp2_approx(acc);
    acc = 0.0f;
    for (int t = L - 1; t >= 0; --t) {
      const float l = kr[t * sx + d];
      kr[t * sx + d] = acc;
      acc += l;
    }
  }
  __syncthreads();
#pragma unroll
  for (int m = 0; m < kPer; ++m) {
    const int i = tid + m * kThreads, t = i / hd8, d = i - t * hd8;
    if (i < n) {
      qs[t * sx + d] = rv[m] * exp2_approx(qs[t * sx + d]);
      kr[t * sx + d] = kv[m] * exp2_approx(kr[t * sx + d]);
    }
  }
  cp_async_wait_all();
  __syncthreads();

  // items: (product, 16 rows of d, 64 columns of e), a warp each in turn
  const int MT = (hd + 15) / 16, NG = (hd8 + 63) / 64;
  for (int item = warp; item < 2 * MT * NG; item += kWarps) {
    const int which = item / (MT * NG), rest = item - which * MT * NG;
    const int m0 = 16 * (rest / NG), n00 = 64 * (rest % NG);
    const float* A = which ? qs : kr;
    const T* Bm = which ? ds : vs;
    float* out = which ? wslot : uslot;
    float acc[8][4] = {}, big[8][4] = {}, small[8][4] = {};
#pragma unroll
    for (int k0 = 0; k0 < L; k0 += 8) {
      // A[m = d][k = j] = A_tile[j][d]
      uint32_t ahi[4], alo[4];
      const float* a0 = A + (k0 + q) * sx + m0 + g;
      split(a0[0], ahi[0], alo[0]);
      split(a0[8], ahi[1], alo[1]);
      split(a0[4 * sx], ahi[2], alo[2]);
      split(a0[4 * sx + 8], ahi[3], alo[3]);
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const int n0 = n00 + 8 * nt;
        if (n0 < hd8) {
          const T* b0 = Bm + (k0 + q) * sv + n0 + g;
          mma3e<false, kBf16>(big[nt], small[nt], ahi, alo, to_f32(b0[0]),
                              to_f32(b0[4 * sv]));
        }
      }
      if ((k0 / 8) % kGroup == kGroup - 1 || k0 + 8 == L)
        add_fresh(acc, big, small);
    }
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const int e = n00 + 8 * nt + 2 * q;
      if (e < hd8) {
        const int d0 = m0 + g, d1 = d0 + 8;
        if (d0 < hd)
          *reinterpret_cast<float2*>(out + d0 * hd8 + e) =
              make_float2(acc[nt][0], acc[nt][1]);
        if (d1 < hd)
          *reinterpret_cast<float2*>(out + d1 * hd8 + e) =
              make_float2(acc[nt][2], acc[nt][3]);
      }
    }
  }
}

// a diag(A) x + u step of four elements
__device__ __forceinline__ float4 carry(float a, float4 x, float4 u) {
  return make_float4(fmaf(a, x.x, u.x), fmaf(a, x.y, u.y), fmaf(a, x.z, u.z),
                     fmaf(a, x.w, u.w));
}
// the first n (at most four) elements of a row of state0 or dstate
__device__ __forceinline__ void initial(float4* x, const float* p, int n) {
  if (n > 0) x->x = p[0];
  if (n > 1) x->y = p[1];
  if (n > 2) x->z = p[2];
  if (n > 3) x->w = p[3];
}

// ---------------------------------------------------------------------
// 2. The scans: S forward (U's slot becomes the state entering its span),
//    G backward (W's slot becomes the gradient of the state leaving its
//    span), dstate0.
__global__ void __launch_bounds__(kScanThreads, 2)
wkv_bwd_scan(float* __restrict__ ss, float* __restrict__ gg,
             const float* __restrict__ aa, const float* __restrict__ state0,
             const float* __restrict__ dstate, float* __restrict__ dstate0,
             Geo geo) {
  // a thread four neighbouring elements of a state row (hd8 is a multiple
  // of 8), 16-byte loads and stores
  const int hd = geo.hd, hd8 = geo.hd8, N = geo.N;
  const int64_t hh = static_cast<int64_t>(hd) * hd8;
  const int64_t i = (static_cast<int64_t>(blockIdx.x) * kScanThreads +
                     threadIdx.x) * 4;
  if (i >= static_cast<int64_t>(geo.B) * geo.H * hh) return;
  const int64_t bh = i / hh;
  const int rem = static_cast<int>(i - bh * hh);
  const int d = rem / hd8, e = rem - d * hd8;
  const int64_t at = (bh * hd + d) * hd + e;
  const float* al = aa + bh * N * hd8 + d;
  float4 s = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  float4 gs = s;
  if (state0 != nullptr) initial(&s, state0 + at, hd - e);
  if (dstate != nullptr) initial(&gs, dstate + at, hd - e);

  float4* sl = reinterpret_cast<float4*>(ss + bh * N * hh + rem);
  const int64_t step = hh / 4;
  for (int n0 = 0; n0 < N; n0 += kAhead) {
    float4 x[kAhead];
    float a[kAhead];
#pragma unroll
    for (int j = 0; j < kAhead; ++j)
      if (n0 + j < N) {
        x[j] = sl[(n0 + j) * step];
        a[j] = al[(n0 + j) * hd8];
      }
#pragma unroll
    for (int j = 0; j < kAhead; ++j)
      if (n0 + j < N) {
        sl[(n0 + j) * step] = s;
        s = carry(a[j], s, x[j]);   // S <- diag(A) S + U
      }
  }

  float4* gl = reinterpret_cast<float4*>(gg + bh * N * hh + rem);
  for (int n1 = N - 1; n1 >= 0; n1 -= kAhead) {
    float4 x[kAhead];
    float a[kAhead];
#pragma unroll
    for (int j = 0; j < kAhead; ++j)
      if (n1 - j >= 0) {
        x[j] = gl[(n1 - j) * step];
        a[j] = al[(n1 - j) * hd8];
      }
#pragma unroll
    for (int j = 0; j < kAhead; ++j)
      if (n1 - j >= 0) {
        gl[(n1 - j) * step] = gs;
        gs = carry(a[j], gs, x[j]);   // G <- diag(A) G + W
      }
  }
  const float out[4] = {gs.x, gs.y, gs.z, gs.w};
  for (int c = 0; c < 4 && e + c < hd; ++c) dstate0[at + c] = out[c];
}

// ---------------------------------------------------------------------
// x[j] = the j-th position of chunk c of a span of x at channel d (0 past
// the valid rows and hd), the loads all in flight together
template <typename T>
__device__ __forceinline__ void load_chunk(float (&x)[kChunk],
                                           const T* __restrict__ p,
                                           const Span& sp, const Geo& geo,
                                           int c, int d) {
#pragma unroll
  for (int j = 0; j < kChunk; ++j) {
    const int t = kChunk * c + j;
    x[j] = t < sp.valid && d < geo.hd ? to_f32(p[sp.base + t * geo.row + d])
                                      : 0.0f;
  }
}

// The chunks' decays of a span: la (inclusive, from each chunk's start)
// into lam, each chunk's total into tc; zero past hd and past the valid
// rows (w = 1).
template <typename T, int NC>
__device__ void chunk_decays(const T* __restrict__ w, const Span& sp,
                             const Geo& geo, float* lam, int sl,
                             float* tc) {
  for (int i = threadIdx.x; i < NC * geo.hd8; i += kThreads) {
    const int c = i / geo.hd8, d = i - c * geo.hd8;
    float x[kChunk];
    load_chunk(x, w, sp, geo, c, d);
    float acc = 0.0f;
#pragma unroll
    for (int j = 0; j < kChunk; ++j) {
      const int t = kChunk * c + j;
      acc += t < sp.valid && d < geo.hd ? log2_decay(x[j]) : 0.0f;
      lam[t * sl + d] = acc;
    }
    tc[c * geo.hd8 + d] = acc;
  }
}

// sum_{c = lo}^{hi - 1} tc[c][d]
template <int NC>
__device__ __forceinline__ float chunk_sum(const float* tc, int hd8, int d,
                                           int lo, int hi) {
  float s = 0.0f;
#pragma unroll
  for (int c = 0; c < NC; ++c)
    if (c >= lo && c < hi) s += tc[c * hd8 + d];
  return s;
}

// 3. dr, dk, d lw (dw's numerator), du's part and the bonus of a span.
template <typename T, int NC>
__global__ void __launch_bounds__(kThreads, 4)
wkv_bwd_keys(const T* __restrict__ r, const T* __restrict__ k,
             const T* __restrict__ v, const T* __restrict__ w,
             const float* __restrict__ u, const T* __restrict__ dout,
             const float* __restrict__ ss, const float* __restrict__ gg,
             T* __restrict__ dr, T* __restrict__ dk,
             float* __restrict__ dlw_out, float* __restrict__ du_part,
             float* __restrict__ bonus_out,
             Geo geo, int vec) {
  constexpr int L = kChunk * NC;
  constexpr bool kBf16 = sizeof(T) == 2;
  constexpr int P = kWarps / NC;     // warps a chunk: column parts
  constexpr int C = kCols;           // the slab's rows
  constexpr int NTW = C / (8 * P);   // 8-column tiles a warp takes a slab
  using Pl = Plan<T>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int hd = geo.hd, hd8 = geo.hd8;
  const int st = Pl::row_stride(hd), sf = Pl::f32_stride(hd);
  T* rs = reinterpret_cast<T*>(smem);        // [L][st]
  T* ks = rs + L * st;
  T* vs = ks + L * st;
  T* ds = vs + L * st;
  float* lam = reinterpret_cast<float*>(ds + L * st);   // [L][sf]
  float* region = lam + L * sf;
  float* s_sl = region;                      // [C][sf]: S rows
  float* g_sl = region + C * sf;             // [C][sf]: G rows
  constexpr int CP = kColsP;
  float* xs = region;                        // [L][CP]: d la + d lae
  float* ys = xs + L * CP;                   // [L][CP]: d lae
  float* rs_out = ys + L * CP;               // [L][CP]: dr
  float* ks_out = rs_out + L * CP;           // [L][CP]: dk
  float* zs = ks_out + L * CP;               // [L][CP]: Kr_j gv_j
  float* tc = region + Pl::region_floats(hd);   // [NC][hd8]
  float* us = tc + NC * hd8;                 // [hd8]
  float* diag = us + hd8;                    // [L]: dov_tt
  float* tail = diag + L;                    // [C]: A_last rowsum(S o G)
  float* part = tail + C;                    // [2][NC][C]

  const Span sp(geo, L);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, q = lane & 3;
  const int a = warp % NC, cpart = warp / NC;
  const int64_t bh = static_cast<int64_t>(sp.b) * geo.H + sp.h;
  const int64_t hh = static_cast<int64_t>(hd) * hd8;
  const float* sslot = ss + (bh * geo.N + sp.n) * hh;
  const float* gslot = gg + (bh * geo.N + sp.n) * hh;

  stage_rows(rs, st, r, sp.base, geo.row, L, sp.valid, hd, hd8, vec);
  stage_rows(ks, st, k, sp.base, geo.row, L, sp.valid, hd, hd8, vec);
  stage_rows(vs, st, v, sp.base, geo.row, L, sp.valid, hd, hd8, vec);
  stage_rows(ds, st, dout, sp.base, geo.row, L, sp.valid, hd, hd8, vec);
  cp_async_commit();
  // rows db .. db + C of S and G (zero past hd)
  auto stage_slabs = [&](int db) {
    const int nu = hd8 / 4;
    for (int i = tid; i < C * nu; i += kThreads) {
      const int rr = i / nu, c = (i - rr * nu) * 4, d = db + rr;
      const bool ok = d < hd;
      const int64_t off = static_cast<int64_t>(ok ? d : 0) * hd8 + c;
      cp_async16(s_sl + rr * sf + c, sslot + off, ok);
      cp_async16(g_sl + rr * sf + c, gslot + off, ok);
    }
    cp_async_commit();
  };
  stage_slabs(0);
  chunk_decays<T, NC>(w, sp, geo, lam, sf, tc);
  for (int d = tid; d < hd8; d += kThreads)
    us[d] = d < hd ? u[static_cast<int64_t>(sp.h) * hd + d] : 0.0f;
  cp_async_wait_all();
  __syncthreads();
  // dov's diagonal and the bonus r_t . (u k_t) (for the values' launch):
  // PT threads a position, each every PT-th channel, then xor shuffles
  {
    constexpr int PT = kThreads / L;
    const int t = tid / PT, p = tid - t * PT;
    float acc = 0.0f, bon = 0.0f;
    for (int e = p; e < hd8; e += PT) {
      acc = fmaf(to_f32(ds[t * st + e]), to_f32(vs[t * st + e]), acc);
      bon = fmaf(to_f32(rs[t * st + e]) * us[e], to_f32(ks[t * st + e]), bon);
    }
#pragma unroll
    for (int o = 1; o < PT; o <<= 1) {
      acc += __shfl_xor_sync(0xffffffffu, acc, o);
      bon += __shfl_xor_sync(0xffffffffu, bon, o);
    }
    if (p == 0) {
      diag[t] = acc;
      bonus_out[(bh * geo.N + sp.n) * L + t] = bon;
    }
  }
  __syncthreads();
  for (int d = tid; d < hd; d += kThreads) {
    float acc = 0.0f;
    for (int t = 0; t < L; ++t)
      acc = fmaf(diag[t] * to_f32(rs[t * st + d]), to_f32(ks[t * st + d]),
                 acc);
    du_part[(static_cast<int64_t>(sp.b) * geo.N + sp.n) * geo.H * hd +
            static_cast<int64_t>(sp.h) * hd + d] = acc;
  }

  // dov blocks of chunk a, as accumulators (two 8-column tiles): slot s
  // <= a holds rows t of chunk a against columns j of chunk s (j < t on
  // the diagonal); slot s > a rows j of chunk a against columns t of chunk
  // s - 1 (t > j on the diagonal)
  float dov[NC + 1][2][4];
#pragma unroll
  for (int s = 0; s <= NC; ++s) {
    const bool rows_t = s <= a;
    const int c = rows_t ? s : s - 1;
    const T* Am = rows_t ? ds : vs;
    const T* Bm = rows_t ? vs : ds;
    float acc[2][4] = {}, big[2][4] = {}, small[2][4] = {};
    for (int k0 = 0; k0 < hd8; k0 += 8) {
      uint32_t ahi[4], alo[4];
      a_frag(Am, st, kChunk * a, k0, ahi, alo);
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const T* b0 = Bm + (kChunk * c + 8 * nt + g) * st + k0 + q;
        mma3e<kBf16, kBf16>(big[nt], small[nt], ahi, alo, to_f32(b0[0]),
                            to_f32(b0[4]));
      }
      if ((k0 / 8) % kGroup == kGroup - 1 || k0 + 8 >= hd8)
        add_fresh(acc, big, small);
    }
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = g + (i >= 2 ? 8 : 0), col = 8 * nt + 2 * q + (i & 1);
        const bool keep = c != a || (rows_t ? col < row : col > row);
        dov[s][nt][i] = keep ? acc[nt][i] : 0.0f;
      }
  }

  for (int db = 0; db < hd8; db += C) {
    if (db > 0) {
      __syncthreads();   // the region is free
      stage_slabs(db);
      cp_async_wait_all();
      __syncthreads();
    }
    // A_last rowsum(S o G) of the slab's rows: with sum_j Kr_j gv_j, the
    // last position's d la
    for (int rr = warp; rr < C; rr += kWarps) {
      const int d = db + rr;
      float acc = 0.0f;
      if (d < hd)
        for (int e = lane; e < hd8; e += 32)
          acc = fmaf(s_sl[rr * sf + e], g_sl[rr * sf + e], acc);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        acc += __shfl_xor_sync(0xffffffffu, acc, o);
      if (lane == 0)
        tail[rr] = d < hd ? exp2_approx(chunk_sum<NC>(tc, hd8, d, 0, NC)) *
                                acc
                          : 0.0f;
    }

    // the warp's tiles: columns db + 8 nt + (0..7), nt = cpart + P i
    int dcol[NTW];
    bool on[NTW];
#pragma unroll
    for (int i = 0; i < NTW; ++i) {
      dcol[i] = 8 * (cpart + P * i);
      on[i] = db + dcol[i] < hd8;
    }
    float aq[NTW][4] = {}, ak[NTW][4] = {}, gv[NTW][4];
    {
      float big[NTW][4] = {}, small[NTW][4] = {};
      // dQ: dout_a S^T, S's rows times A at chunk a's start ...
      float f[NTW];
#pragma unroll
      for (int i = 0; i < NTW; ++i)
        f[i] = on[i] ? exp2_approx(chunk_sum<NC>(tc, hd8, db + dcol[i] + g,
                                                 0, a))
                     : 0.0f;
      for (int k0 = 0; k0 < hd8; k0 += 8) {
        uint32_t ahi[4], alo[4];
        a_frag(ds, st, kChunk * a, k0, ahi, alo);
#pragma unroll
        for (int i = 0; i < NTW; ++i)
          if (on[i]) {
            const float* b0 = s_sl + (dcol[i] + g) * sf + k0 + q;
            mma3e<kBf16>(big[i], small[i], ahi, alo, b0[0] * f[i],
                         b0[4] * f[i]);
          }
        if ((k0 / 8) % kGroup == kGroup - 1 || k0 + 8 >= hd8)
          add_fresh(aq, big, small);
      }
      // ... and dov_ab (k_j A_c / A_j) over the chunks b <= a, c = a's
      // first position
#pragma unroll
      for (int b = 0; b < NC; ++b)
        if (b <= a) {
#pragma unroll
          for (int i = 0; i < NTW; ++i)
            f[i] = on[i] ? chunk_sum<NC>(tc, hd8, db + dcol[i] + g, b, a)
                         : 0.0f;
#pragma unroll
          for (int ks2 = 0; ks2 < 2; ++ks2) {
            uint32_t ahi[4], alo[4];
            acc_frag(dov[b][ks2], ahi, alo);
            const int j = kChunk * b + 8 * ks2 + 2 * q;
#pragma unroll
            for (int i = 0; i < NTW; ++i)
              if (on[i]) {
                const int d = db + dcol[i] + g;
                mma3e(big[i], small[i], ahi, alo,
                      to_f32(ks[j * st + d]) *
                          exp2_approx(f[i] - lam[j * sf + d]),
                      to_f32(ks[(j + 1) * st + d]) *
                          exp2_approx(f[i] - lam[(j + 1) * sf + d]));
              }
          }
          add_fresh(aq, big, small);
        }
      // dK: v_a G^T, G's rows times A_last / A at chunk a's end ...
#pragma unroll
      for (int i = 0; i < NTW; ++i)
        f[i] = on[i] ? exp2_approx(chunk_sum<NC>(tc, hd8, db + dcol[i] + g,
                                                 a + 1, NC))
                     : 0.0f;
      for (int k0 = 0; k0 < hd8; k0 += 8) {
        uint32_t ahi[4], alo[4];
        a_frag(vs, st, kChunk * a, k0, ahi, alo);
#pragma unroll
        for (int i = 0; i < NTW; ++i)
          if (on[i]) {
            const float* b0 = g_sl + (dcol[i] + g) * sf + k0 + q;
            mma3e<kBf16>(big[i], small[i], ahi, alo, b0[0] * f[i],
                         b0[4] * f[i]);
          }
        if ((k0 / 8) % kGroup == kGroup - 1 || k0 + 8 >= hd8)
          add_fresh(ak, big, small);
      }
      // (this part alone, times k^_j, is Kr_j gv_j: d la's tail)
#pragma unroll
      for (int i = 0; i < NTW; ++i)
#pragma unroll
        for (int x = 0; x < 4; ++x) gv[i][x] = ak[i][x];
      // ... and dov_{a'a}^T (r_t A_{t-1} / A_e) over the chunks a' >= a,
      // e = a's last position
#pragma unroll
      for (int s = 1; s <= NC; ++s)
        if (s > a) {
          const int a2 = s - 1;
#pragma unroll
          for (int i = 0; i < NTW; ++i) {
            const int d = db + dcol[i] + g;
            f[i] = !on[i] ? 0.0f
                   : a2 > a ? chunk_sum<NC>(tc, hd8, d, a + 1, a2)
                            : -tc[a * hd8 + d];
          }
#pragma unroll
          for (int ks2 = 0; ks2 < 2; ++ks2) {
            uint32_t ahi[4], alo[4];
            acc_frag(dov[s][ks2], ahi, alo);
            const int t = kChunk * a2 + 8 * ks2 + 2 * q;
#pragma unroll
            for (int i = 0; i < NTW; ++i)
              if (on[i]) {
                const int d = db + dcol[i] + g;
                const float lp = 8 * ks2 + 2 * q == 0
                                     ? 0.0f : lam[(t - 1) * sf + d];
                mma3e(big[i], small[i], ahi, alo,
                      to_f32(rs[t * st + d]) * exp2_approx(lp + f[i]),
                      to_f32(rs[(t + 1) * st + d]) *
                          exp2_approx(lam[t * sf + d] + f[i]));
              }
          }
          add_fresh(ak, big, small);
        }
    }
    __syncthreads();   // the slabs are read: the region takes d la, d lae

    // dr, dk, d la + d lae, d lae and Kr gv into the region
#pragma unroll
    for (int i = 0; i < NTW; ++i)
      if (on[i]) {
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          const int t = kChunk * a + g + (x >= 2 ? 8 : 0);
          const int dl = dcol[i] + 2 * q + (x & 1), d = db + dl;
          const float rv = to_f32(rs[t * st + d]), kv = to_f32(ks[t * st + d]);
          const float eq = t % kChunk == 0 ? 1.0f
                                           : exp2_approx(lam[(t - 1) * sf + d]);
          const float ek = exp2_approx(tc[a * hd8 + d] - lam[t * sf + d]);
          const float dq = eq * aq[i][x], kk = ek * ak[i][x];
          const float bonus = diag[t] * us[d];
          rs_out[t * CP + dl] = fmaf(bonus, kv, dq);
          ks_out[t * CP + dl] = fmaf(bonus, rv, kk);
          const float dlae = rv * dq;
          xs[t * CP + dl] = dlae - kv * kk;
          ys[t * CP + dl] = dlae;
          zs[t * CP + dl] = kv * ek * gv[i][x];
        }
      }
    __syncthreads();
    // dr and dk, the block's rows of C columns at a time
    for (int i = tid; i < L * C; i += kThreads) {
      const int t = i / C, col = i - t * C, d = db + col;
      if (t < sp.valid && d < hd) {
        const int64_t o = sp.base + t * geo.row + d;
        store(dr + o, rs_out[t * CP + col]);
        store(dk + o, ks_out[t * CP + col]);
      }
    }
    // d lw_s = sum_{t >= s} (d la + d lae)_t - d lae_s, d la's tail at the
    // span's last position (so in every sum): a thread a (column, chunk)
    // sums its chunk, then walks it back from the tail and the later
    // chunks' sums
    const int dl = tid % C, c = tid / C;
    if (c < NC) {
      float s = 0.0f, z = 0.0f;
      for (int t = kChunk * c; t < kChunk * (c + 1); ++t) {
        s += xs[t * CP + dl];
        z += zs[t * CP + dl];
      }
      part[c * C + dl] = s;
      part[(NC + c) * C + dl] = z;
    }
    __syncthreads();
    if (c < NC && db + dl < hd) {
      const int d = db + dl;
      float acc = tail[dl];
      for (int c2 = 0; c2 < NC; ++c2) acc += part[(NC + c2) * C + dl];
      for (int c2 = NC - 1; c2 > c; --c2) acc += part[c2 * C + dl];
#pragma unroll
      for (int j = kChunk - 1; j >= 0; --j) {
        const int t = kChunk * c + j;
        acc += xs[t * CP + dl];
        if (t < sp.valid)
          dlw_out[sp.base + t * geo.row + d] = acc - ys[t * CP + dl];
      }
    }
  }
}

// ---------------------------------------------------------------------
// 4. dv and dw of a span.
template <typename T, int NC>
__global__ void __launch_bounds__(kThreads, 4)
wkv_bwd_values(const T* __restrict__ r, const T* __restrict__ k,
               const T* __restrict__ w, const T* __restrict__ dout,
               const float* __restrict__ gg, const float* __restrict__ bonus_in,
               const float* __restrict__ dlw, T* __restrict__ dv,
               T* __restrict__ dw, Geo geo, int vec) {
  constexpr int L = kChunk * NC;
  constexpr bool kBf16 = sizeof(T) == 2;
  constexpr int P = kWarps / NC;
  constexpr int C = kCols;           // the slab's columns
  constexpr int NTW = C / (8 * P);
  using Pl = Plan<T>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int hd = geo.hd, hd8 = geo.hd8;
  const int st = Pl::row_stride(hd), sf = Pl::f32_stride(hd);
  constexpr int sg = Pl::kGStride;
  T* ds = reinterpret_cast<T*>(smem);                   // [L][st]
  float* qt = reinterpret_cast<float*>(ds + L * st);    // [L][sf]: Q
  float* kh = qt + L * sf;                   // [L][sf]: k A_e / A_j
  float* g_sl = kh + L * sf;                 // [hd8][sg]: G columns
  float* tc = g_sl + Pl::slab_floats(hd);    // [NC][hd8]
  float* fac = tc + NC * hd8;                // [NC][NC][hd8]: pair factors
  float* ee = fac + NC * NC * hd8;           // [NC][hd8]: A_last / A_e
  float* bonus = ee + NC * hd8;              // [L]

  const Span sp(geo, L);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, q = lane & 3;
  const int b = warp % NC, cpart = warp / NC;
  const int64_t bh = static_cast<int64_t>(sp.b) * geo.H + sp.h;
  const float* gslot = gg + (bh * geo.N + sp.n) * static_cast<int64_t>(hd) *
                                hd8;

  stage_rows(ds, st, dout, sp.base, geo.row, L, sp.valid, hd, hd8, vec);
  cp_async_commit();
  // columns eb .. eb + C of G (zero past hd)
  auto stage_slab = [&](int eb) {
    for (int i = tid; i < hd8 * (C / 4); i += kThreads) {
      const int d = i / (C / 4), c = (i - d * (C / 4)) * 4;
      const bool ok = d < hd && eb + c < hd8;
      cp_async16(g_sl + d * sg + c,
                 gslot + (ok ? static_cast<int64_t>(d) * hd8 + eb + c : 0),
                 ok);
    }
    cp_async_commit();
  };
  stage_slab(0);
  // a thread a (chunk, key channel): la in registers, then Q_t = r_t
  // A_{t-1} and K^_j = k_j A_e / A_j from the chunk's own start and end
  for (int i = tid; i < NC * hd8; i += kThreads) {
    const int c = i / hd8, d = i - c * hd8;
    float wv[kChunk], rv[kChunk], kv[kChunk], lv[kChunk], la[kChunk];
    load_chunk(wv, w, sp, geo, c, d);
    load_chunk(rv, r, sp, geo, c, d);
    load_chunk(kv, k, sp, geo, c, d);
    load_chunk(lv, dlw, sp, geo, c, d);
    float acc = 0.0f;
#pragma unroll
    for (int j = 0; j < kChunk; ++j) {
      acc += kChunk * c + j < sp.valid && d < hd ? log2_decay(wv[j]) : 0.0f;
      la[j] = acc;
    }
    tc[c * hd8 + d] = acc;
    float before = 0.0f;   // la_{t-1}: 0 at the chunk's start
#pragma unroll
    for (int j = 0; j < kChunk; ++j) {
      const int t = kChunk * c + j;
      qt[t * sf + d] = j == 0 ? rv[j] : rv[j] * exp2_approx(before);
      kh[t * sf + d] = kv[j] * exp2_approx(acc - la[j]);
      before = la[j];
      // dw = d lw / w (the keys' launch wrote d lw), 0 under the clamp
      if (t < sp.valid && d < hd)
        store(dw + sp.base + t * geo.row + d,
              wv[j] >= 1e-8f ? lv[j] / wv[j] : 0.0f);
    }
  }
  // the bonus r_t . (u k_t), which the keys' launch wrote
  for (int t = tid; t < L; t += kThreads)
    bonus[t] = bonus_in[(bh * geo.N + sp.n) * L + t];
  __syncthreads();
  // the pair factors A_c / A_e (c = a's first, e = b's last position, b <
  // a; 1 / A_e on the diagonal) and A_last / A_e
  for (int i = tid; i < NC * NC * hd8; i += kThreads) {
    const int a = i / (NC * hd8), bb = (i / hd8) % NC, d = i % hd8;
    if (bb <= a)
      fac[i] = exp2_approx(bb < a ? chunk_sum<NC>(tc, hd8, d, bb + 1, a)
                                  : -tc[a * hd8 + d]);
  }
  for (int i = tid; i < NC * hd8; i += kThreads) {
    const int bb = i / hd8, d = i - bb * hd8;
    ee[i] = exp2_approx(chunk_sum<NC>(tc, hd8, d, bb + 1, NC));
  }
  cp_async_wait_all();
  __syncthreads();

  // P^T of chunk b's rows j against chunk a's columns t >= j (a >= b),
  // the bonus on the diagonal, as accumulators
  float pt[NC][2][4];
#pragma unroll
  for (int a = 0; a < NC; ++a) {
    float acc[2][4] = {}, big[2][4] = {}, small[2][4] = {};
    if (a >= b) {
      const float* fa = fac + (a * NC + b) * hd8;
      for (int k0 = 0; k0 < hd8; k0 += 8) {
        uint32_t ahi[4], alo[4];
        const float* p0 = kh + (kChunk * b + g) * sf + k0 + q;
        const float f0 = fa[k0 + q], f1 = fa[k0 + q + 4];
        split(p0[0] * f0, ahi[0], alo[0]);
        split(p0[8 * sf] * f0, ahi[1], alo[1]);
        split(p0[4] * f1, ahi[2], alo[2]);
        split(p0[8 * sf + 4] * f1, ahi[3], alo[3]);
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          const float* b0 = qt + (kChunk * a + 8 * nt + g) * sf + k0 + q;
          mma3e(big[nt], small[nt], ahi, alo, b0[0], b0[4]);
        }
        if ((k0 / 8) % kGroup == kGroup - 1 || k0 + 8 >= hd8)
          add_fresh(acc, big, small);
      }
    }
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = g + (i >= 2 ? 8 : 0), col = 8 * nt + 2 * q + (i & 1);
        pt[a][nt][i] = a != b || col > row ? acc[nt][i]
                       : col == row        ? bonus[kChunk * b + row]
                                           : 0.0f;
      }
  }

  for (int eb = 0; eb < hd8; eb += C) {
    if (eb > 0) {
      __syncthreads();   // the slab is free
      stage_slab(eb);
      cp_async_wait_all();
      __syncthreads();
    }

    int ecol[NTW];
    bool on[NTW];
#pragma unroll
    for (int i = 0; i < NTW; ++i) {
      ecol[i] = 8 * (cpart + P * i);
      on[i] = eb + ecol[i] < hd8;
    }
    float acc[NTW][4] = {}, big[NTW][4] = {}, small[NTW][4] = {};
    // P^T dout over the chunks a >= b ...
#pragma unroll
    for (int a = 0; a < NC; ++a)
      if (a >= b) {
#pragma unroll
        for (int ks2 = 0; ks2 < 2; ++ks2) {
          uint32_t ahi[4], alo[4];
          acc_frag(pt[a][ks2], ahi, alo);
          const int t = kChunk * a + 8 * ks2 + 2 * q;
#pragma unroll
          for (int i = 0; i < NTW; ++i)
            if (on[i]) {
              const int e = eb + ecol[i] + g;
              mma3e<false, kBf16>(big[i], small[i], ahi, alo,
                                  to_f32(ds[t * st + e]),
                                  to_f32(ds[(t + 1) * st + e]));
            }
        }
        add_fresh(acc, big, small);
      }
    // ... and Kr G, Kr = K^ A_last / A_e
    const float* eb_f = ee + b * hd8;
    for (int k0 = 0; k0 < hd8; k0 += 8) {
      uint32_t ahi[4], alo[4];
      const float* p0 = kh + (kChunk * b + g) * sf + k0 + q;
      const float f0 = eb_f[k0 + q], f1 = eb_f[k0 + q + 4];
      split(p0[0] * f0, ahi[0], alo[0]);
      split(p0[8 * sf] * f0, ahi[1], alo[1]);
      split(p0[4] * f1, ahi[2], alo[2]);
      split(p0[8 * sf + 4] * f1, ahi[3], alo[3]);
#pragma unroll
      for (int i = 0; i < NTW; ++i)
        if (on[i]) {
          const float* b0 = g_sl + (k0 + q) * sg + ecol[i] + g;
          mma3e(big[i], small[i], ahi, alo, b0[0], b0[4 * sg]);
        }
      if ((k0 / 8) % kGroup == kGroup - 1 || k0 + 8 >= hd8)
        add_fresh(acc, big, small);
    }
    __syncthreads();   // the slab is read: it takes dv's rows
#pragma unroll
    for (int i = 0; i < NTW; ++i)
      if (on[i]) {
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          const int j = kChunk * b + g + (x >= 2 ? 8 : 0);
          g_sl[j * kColsP + ecol[i] + 2 * q + (x & 1)] = acc[i][x];
        }
      }
    __syncthreads();
    for (int i = tid; i < L * C; i += kThreads) {
      const int j = i / C, col = i - j * C, e = eb + col;
      if (j < sp.valid && e < hd)
        store(dv + sp.base + j * geo.row + e, g_sl[j * kColsP + col]);
    }
  }
}

// ---------------------------------------------------------------------
// 5. du: the spans' parts summed over b, then spans, in order.
__global__ void __launch_bounds__(kThreads)
wkv_bwd_du(const float* __restrict__ du_part, float* __restrict__ du,
           Geo geo) {
  const int j = blockIdx.x * kThreads + threadIdx.x;
  const int n_hd = geo.H * geo.hd;
  if (j >= n_hd) return;
  float acc = 0.0f;
  for (int bb = 0; bb < geo.B; ++bb)
    for (int n = 0; n < geo.N; ++n)
      acc += du_part[(static_cast<int64_t>(bb) * geo.N + n) * n_hd + j];
  du[j] = acc;
}

// the opt-in above 48 KB, once per device and kernel instance (instances
// share no state) for the largest size asked, so that a launch inside a
// CUDA graph capture sets nothing
template <auto kern>
int opt_in(int64_t smem) {
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

// the scratch's parts, in floats
struct Scratch {
  float *ss, *gg, *aa, *du, *bonus, *dlw;
  Scratch(float* base, const Geo& g) {
    const int64_t bh = static_cast<int64_t>(g.B) * g.H;
    const int64_t hh = static_cast<int64_t>(g.hd) * g.hd8;
    ss = base;
    gg = ss + bh * g.N * hh;
    aa = gg + bh * g.N * hh;
    du = aa + bh * g.N * g.hd8;
    bonus = du + bh * g.N * g.hd;
    dlw = bonus + bh * g.N * (kChunk * Plan<float>::chunks(g.hd));
  }
  static int64_t floats(const Geo& g) {
    const int64_t bh = static_cast<int64_t>(g.B) * g.H;
    const int64_t hh = static_cast<int64_t>(g.hd) * g.hd8;
    const int L = kChunk * Plan<float>::chunks(g.hd);
    return 2 * bh * g.N * hh + bh * g.N * g.hd8 +
           bh * g.N * g.hd + bh * g.N * L + bh * g.S * g.hd;
  }
};

inline Geo geometry(int B, int S, int H, int hd) {
  const int L = kChunk * Plan<float>::chunks(hd);
  return Geo{B, S, H, hd, Plan<float>::hd8(hd), (S + L - 1) / L,
             static_cast<int64_t>(H) * hd};
}

template <typename T, int NC>
int run(const T* r, const T* k, const T* v, const T* w, const float* u,
        const float* state0, const T* dout, const float* dstate, T* dr,
        T* dk, T* dv, T* dw, float* du, float* dstate0, float* scratch,
        const Geo& geo, cudaStream_t s) {
  using Pl = Plan<T>;
  const Scratch sc(scratch, geo);
  auto aligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  const int vec = geo.hd * static_cast<int>(sizeof(T)) % 16 == 0 &&
                  aligned(r) && aligned(k) && aligned(v) && aligned(dout);
  const int64_t spans = static_cast<int64_t>(geo.B) * geo.H * geo.N;
  if (spans >= (int64_t(1) << 31)) return cudaErrorInvalidValue;
  const int64_t a_bytes = Pl::spans_bytes(geo.hd);
  const int64_t k_bytes = Pl::keys_bytes(geo.hd);
  const int64_t v_bytes = Pl::values_bytes(geo.hd);
  int err = opt_in<wkv_bwd_spans<T, NC>>(a_bytes);
  if (err == 0) err = opt_in<wkv_bwd_keys<T, NC>>(k_bytes);
  if (err == 0) err = opt_in<wkv_bwd_values<T, NC>>(v_bytes);
  if (err != 0) return err;
  const unsigned blocks = static_cast<unsigned>(spans);
  wkv_bwd_spans<T, NC><<<blocks, kThreads, a_bytes, s>>>(
      r, k, v, w, dout, sc.ss, sc.gg, sc.aa, geo, vec);
  err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  const int64_t cells = static_cast<int64_t>(geo.B) * geo.H * geo.hd *
                        geo.hd8;
  wkv_bwd_scan<<<static_cast<unsigned>((cells / 4 + kScanThreads - 1) /
                                       kScanThreads),
                 kScanThreads, 0, s>>>(sc.ss, sc.gg, sc.aa, state0, dstate,
                                       dstate0, geo);
  err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  wkv_bwd_keys<T, NC><<<blocks, kThreads, k_bytes, s>>>(
      r, k, v, w, u, dout, sc.ss, sc.gg, dr, dk, sc.dlw, sc.du, sc.bonus,
      geo, vec);
  err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  wkv_bwd_values<T, NC><<<blocks, kThreads, v_bytes, s>>>(
      r, k, w, dout, sc.gg, sc.bonus, sc.dlw, dv, dw, geo, vec);
  err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  wkv_bwd_du<<<(geo.H * geo.hd + kThreads - 1) / kThreads, kThreads, 0, s>>>(
      sc.du, du, geo);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* r, const void* k, const void* v, const void* w,
             const float* u, const float* state0, const void* dout,
             const float* dstate, void* dr, void* dk, void* dv, void* dw,
             float* du, float* dstate0, float* scratch, const Geo& geo,
             cudaStream_t s) {
  const T *r_ = static_cast<const T*>(r), *k_ = static_cast<const T*>(k),
          *v_ = static_cast<const T*>(v), *w_ = static_cast<const T*>(w),
          *do_ = static_cast<const T*>(dout);
  T *dr_ = static_cast<T*>(dr), *dk_ = static_cast<T*>(dk),
    *dv_ = static_cast<T*>(dv), *dw_ = static_cast<T*>(dw);
  switch (Plan<T>::chunks(geo.hd)) {
    case 2:
      return run<T, 2>(r_, k_, v_, w_, u, state0, do_, dstate, dr_, dk_, dv_,
                       dw_, du, dstate0, scratch, geo, s);
    default:
      return run<T, 1>(r_, k_, v_, w_, u, state0, do_, dstate, dr_, dk_, dv_,
                       dw_, du, dstate0, scratch, geo, s);
  }
}

}  // namespace

// Bytes of the fp32 scratch the caller passes (see the header): the S and
// G slots, A_last and du's parts.
extern "C" int64_t wkv_chunked_bwd_scratch(int B, int S, int H, int hd) {
  if (hd < 1 || hd > kMaxHead) return 0;
  return Scratch::floats(geometry(B, S, H, hd)) * 4;
}

// dtype: 0 = fp32, 1 = bf16, of r, k, v, w, dout, dr, dk, dv, dw; u, du,
// state0, dstate, dstate0 and the scratch fp32; all contiguous, the
// scratch 16-byte aligned. state0 and dstate may be null (zero). Returns
// the first launch error, or cudaGetLastError() after the last launch.
extern "C" int wkv_chunked_bwd_launch(
    const void* r, const void* k, const void* v, const void* w,
    const void* u, const void* state0, const void* dout, const void* dstate,
    void* dr, void* dk, void* dv, void* dw, void* du, void* dstate0,
    void* scratch, int B, int S, int H, int hd, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (hd < 1 || hd > kMaxHead || S % kChunk != 0) return cudaErrorInvalidValue;
  if (B <= 0 || H <= 0 || S <= 0) return 0;
  const Geo geo = geometry(B, S, H, hd);
  const float* uf = static_cast<const float*>(u);
  const float* s0 = static_cast<const float*>(state0);
  const float* dsf = static_cast<const float*>(dstate);
  float* duf = static_cast<float*>(du);
  float* d0 = static_cast<float*>(dstate0);
  float* sc = static_cast<float*>(scratch);
  if (dtype == 0)
    return dispatch<float>(r, k, v, w, uf, s0, dout, dsf, dr, dk, dv, dw,
                           duf, d0, sc, geo, s);
  return dispatch<__nv_bfloat16>(r, k, v, w, uf, s0, dout, dsf, dr, dk, dv,
                                 dw, duf, d0, sc, geo, s);
}
