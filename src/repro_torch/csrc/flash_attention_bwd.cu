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
//   1. flash_bwd_rowdot: D, one warp a row (lanes over d, xor shuffles).
//   2. flash_bwd_dkdv: a block a (b, query head, 64-key tile) walks the
//      query tiles that can see its keys (every tile that holds a row that
//      admits no key), recomputes S and P from Q, K and lse, and
//      accumulates the head's dK and dV of its keys in registers; it
//      writes them, fp32, to a scratch (B, Sk, Hq, Dh) each.
//   3. flash_bwd_reduce: dK, dV of a KV head = its query heads' partials
//      summed in head order, cast to the operands' type.
//   4. flash_bwd_dq: a block a (b, query head, 64-row tile) walks the key
//      tiles its rows can see and accumulates dQ in registers.
// (2 and 4 are independent; 3 follows 2.) Pass 2 takes four products
// (S, dP, dV, dK) and pass 4 three (S, dP, dQ): 14 Dh flops a pair where
// the function needs 10 (in bf16 20, each gradient product taking two
// MMAs, see below).
//
// Bound on the H100 by operations: 10 Dh flops an admitted (q, k) pair and
// query head. Every product runs on the tensor cores as mma.sync, eight
// warps a block:
//   * bf16: m16n8k16 bf16 MMAs with fp32 accumulators (989 TFLOP/s dense).
//     Operand fragments come from shared memory by ldmatrix, and by
//     ldmatrix.trans where the operand is stored the other way round
//     (P^T and dS^T for dV and dK, dO and Q for dV and dK, K for dQ). P and
//     dS go to shared memory as two bf16 planes, hi = bf16(x) and lo =
//     bf16(x - hi), and each gradient product takes both (two MMAs), so
//     that they keep 16 of their 24 bits: rounded once to bf16, as in
//     FlashAttention-2, dS put dQ outside the limit against the plain
//     version (chip_smoke.py's bwd_within) on starcoder2-3b's trained
//     activations, where a row's few large terms cancel.
//   * fp32: 3xTF32 m16n8k8 MMAs (mma_tf32.cuh: x = hi + lo, the products
//     hi hi + hi lo + lo hi, which keep an fp32 product's accuracy; 495 / 3
//     = 165 TFLOP/s). Row-major fragments come by ldmatrix too (an 8 x 8
//     b16 matrix is an 8 x 4 fp32 one in the tf32 fragment's layout); tf32
//     has no ldmatrix.trans, so the transposed ones (P^T, dS^T, dO, Q, K)
//     are read element by element. The tensor cores' own additions
//     truncate: each product sums into fresh accumulators over at most 32
//     columns (S, dP) or one tile (dV, dK, dQ) and adds that to its fp32
//     sum in registers, as row 12's forward does for S.
//   * Tiles: a block keeps its resident tile (64 keys of K and V in pass 2,
//     64 rows of Q, dO, lse and D in pass 4) in shared memory and streams
//     the other operand's tiles (64 rows or keys in bf16, 32 in fp32 for
//     Dh > 64) through cp.async copies, one tile ahead where two buffers
//     fit. Up to Dh 128 two blocks share an SM in bf16, and in fp32's
//     pass 4, each held to 128 registers a thread: while one block
//     computes P and dS, the other's MMAs run; otherwise one block an
//     SM, up to 255 registers. ``Plan`` sets tiles, blocks and
//     buffers so that they fit the SM's 228 KB
//     (its static_assert proves it for every instance). Rows are padded by
//     16 bytes (bf16, fp32 row tiles) or 32 (fp32 P and dS in pass 2), so
//     that the eight rows of a fragment load fall in distinct banks; Dh is
//     padded with zeros to a multiple of 64 (DP).
//   * S and dP of a (row tile, key tile) pair: warp w takes 16 rows and
//     BN / (8 / (BM / 16)) keys, skipping its MMAs where its rows see none
//     of its keys; the mask (none where the warp's pairs are all
//     admitted), P and dS are computed on the accumulators and stored to
//     shared memory (P only in pass 2). The gradient products:
//     warp w takes 16 keys (pass 2) or rows (pass 4) and half the head's
//     columns, DP / 16 m16n8 tiles of each sum (128 fp32 registers a lane
//     for dK and dV at Dh 256).
//   * Skipped: query tiles that see none of a key tile (past the causal
//     diagonal, outside the window) and the converse.
//   * ragged edges: rows past Sq and keys past Sk are zero-filled by the
//     copies and masked; their P and dS are 0.
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
using bf16 = __nv_bfloat16;

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kR = 64;   // rows or keys of a block's resident tile

// An SM's shared memory (228 KB); a block uses up to 227 KB of it, and
// the system reserves 1 KB a block.
constexpr int64_t kSmemSM = 233472;

// The tiles of one instance: T the operands' type, DP the head's columns
// rounded up to 64. kS: rows (pass 2) or keys (pass 4) of a streamed tile;
// kLD: the row stride of every Q, dO, K and V tile; kBlocks2 / kBlocks4:
// blocks an SM in pass 2 / 4 (two up to DP 128 in bf16, and in fp32's
// pass 4; each then held to 128 registers a thread, so that one block's
// products run while the other computes P and dS); kStages2 / kStages4:
// the streamed tile's buffers, two where those blocks still fit the SM's
// shared memory.
template <typename T, int DP>
struct Plan {
  static constexpr bool kBf16 = sizeof(T) == 2;
  static constexpr int64_t kSize = static_cast<int64_t>(sizeof(T));
  static constexpr int kS = kBf16 || DP <= 64 ? 64 : 32;
  static constexpr int kLD = DP + 16 / static_cast<int>(sizeof(T));
  static constexpr int kBlocks2 = kBf16 && DP <= 128 ? 2 : 1;
  static constexpr int kBlocks4 = DP <= 128 ? 2 : 1;
  // P and dS rows: pass 2 reads them transposed (fp32: element by element,
  // 8 words of padding); pass 4 row-major (16 bytes of padding); bf16
  // keeps them as hi and lo planes
  static constexpr int kLP2 = kR + 8;
  static constexpr int kLP4 = kS + 16 / static_cast<int>(sizeof(T));
  static constexpr int kPlanes = kBf16 ? 2 : 1;
  static constexpr int64_t dkdv_bytes(int stages) {
    return (2LL * kR * kLD + 2LL * stages * kS * kLD +
            2LL * kPlanes * kS * kLP2) * kSize + 2LL * stages * kS * 4;
  }
  static constexpr int64_t dq_bytes(int stages) {
    return (2LL * kR * kLD + 2LL * stages * kS * kLD +
            1LL * kPlanes * kR * kLP4) * kSize + 2LL * kR * 4;
  }
  static constexpr bool fits(int64_t bytes, int blocks) {
    return (bytes + 1024) * blocks <= kSmemSM;
  }
  static constexpr int kStages2 = fits(dkdv_bytes(2), kBlocks2) ? 2 : 1;
  static constexpr int kStages4 = fits(dq_bytes(2), kBlocks4) ? 2 : 1;
  static constexpr int64_t kSmemDkdv = dkdv_bytes(kStages2);
  static constexpr int64_t kSmemDq = dq_bytes(kStages4);
  static_assert(fits(kSmemDkdv, kBlocks2) && fits(kSmemDq, kBlocks4),
                "a block's tiles");
};

__device__ __forceinline__ float load(const float* p) { return *p; }
__device__ __forceinline__ float load(const bf16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
// (a, b) as bf16 hi and lo planes: hi = bf16(x), lo = bf16(x - hi)
__device__ __forceinline__ void store2_split(bf16* hi, bf16* lo, float a,
                                             float b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  *reinterpret_cast<__nv_bfloat162*>(hi) = h;
  *reinterpret_cast<__nv_bfloat162*>(lo) =
      __floats2bfloat162_rn(a - hf.x, b - hf.y);
}
__device__ __forceinline__ void zero(float* p) { *p = 0.0f; }
__device__ __forceinline__ void zero(bf16* p) { *p = __float2bfloat16(0.0f); }

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(valid ? 4 : 0));
}

// ldmatrix: four 8 x 8 b16 matrices (8 rows of 16 bytes each, the row
// addresses from lanes 8 i .. 8 i + 7 for matrix i); lane (g, q) = (lane /
// 4, lane % 4) gets row g, 32-bit word q of each, or with .trans the
// transposed matrix's row g, words q (b16 only)
__device__ __forceinline__ void ldsm(uint32_t (&r)[4], const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}
__device__ __forceinline__ void ldsm_t(uint32_t (&r)[4], const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

// c += A B, one m16n8k16 bf16 product with fp32 accumulators. Fragments,
// lane (g, q): a = {A[g][2q..], A[g+8][2q..], A[g][2q+8..], A[g+8][2q+8..]}
// (pairs of bf16), b = {B[2q..][g], B[2q+8..][g]}, c as for tf32
// (mma_tf32.cuh).
__device__ __forceinline__ void mma_bf16(float (&c)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Lane addresses of the ldmatrix loads; E = the elements of 16 bytes.
// An A operand stored row-major (m, then k): 16 rows from m0, 2 E columns
// from k0 -> {a0, a1, a2, a3} of a bf16 m16n8k16 or a tf32 m16n8k8 tile.
template <typename T>
__device__ __forceinline__ const T* a_rows(const T* base, int ld, int m0,
                                           int k0, int lane) {
  constexpr int E = 16 / sizeof(T);
  return base + (m0 + (lane & 15)) * ld + k0 + (lane >> 4) * E;
}
// A B operand stored n-major (n, then k): two n-tiles from n0, 2 E of k
// from k0 -> {b0, b1} of tile n0, {b0, b1} of tile n0 + 8.
template <typename T>
__device__ __forceinline__ const T* b_rows(const T* base, int ld, int n0,
                                           int k0, int lane) {
  constexpr int E = 16 / sizeof(T);
  const int i = lane >> 3;
  return base + (n0 + (lane & 7) + ((i >> 1) << 3)) * ld + k0 + (i & 1) * E;
}
// bf16, .trans: an A operand stored k-major (k, then m): 16 of m from m0,
// 16 of k from k0.
__device__ __forceinline__ const bf16* a_cols(const bf16* base, int ld,
                                              int m0, int k0, int lane) {
  const int i = lane >> 3;
  return base + (k0 + (lane & 7) + ((i >> 1) << 3)) * ld + m0 +
         ((i & 1) << 3);
}
// bf16, .trans: a B operand stored k-major (k, then n): 16 of k from k0,
// two n-tiles from n0.
__device__ __forceinline__ const bf16* b_cols(const bf16* base, int ld,
                                              int k0, int n0, int lane) {
  const int i = lane >> 3;
  return base + (k0 + (lane & 7) + ((i & 1) << 3)) * ld + n0 +
         ((i >> 1) << 3);
}

__device__ __forceinline__ void split4(const uint32_t (&x)[4],
                                       uint32_t (&hi)[4], uint32_t (&lo)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) split(__uint_as_float(x[i]), hi[i], lo[i]);
}

// s[NT] = A B^T over DP columns: A's 16 rows from m0 (row-major), B's NT
// n-tiles from n0 (row-major, so n-major). fp32: fresh accumulators over
// each 32 columns, added to s in fp32.
template <int NT, int DP, int LD>
__device__ __forceinline__ void scores(float (&s)[NT][4], const bf16* A,
                                       const bf16* B, int m0, int n0,
                                       int lane) {
  static_assert(NT % 2 == 0, "n-tiles in pairs");
  const bf16* pa = a_rows(A, LD, m0, 0, lane);
  const bf16* pb = b_rows(B, LD, n0, 0, lane);
#pragma unroll
  for (int kk = 0; kk < DP; kk += 16) {
    uint32_t a[4];
    ldsm(a, pa + kk);
#pragma unroll
    for (int j = 0; j < NT; j += 2) {
      uint32_t b[4];
      ldsm(b, pb + 8 * j * LD + kk);
      mma_bf16(s[j], a, b[0], b[1]);
      mma_bf16(s[j + 1], a, b[2], b[3]);
    }
  }
}
template <int NT, int DP, int LD>
__device__ __forceinline__ void scores(float (&s)[NT][4], const float* A,
                                       const float* B, int m0, int n0,
                                       int lane) {
  static_assert(NT % 2 == 0, "n-tiles in pairs");
  const float* pa = a_rows(A, LD, m0, 0, lane);
  const float* pb = b_rows(B, LD, n0, 0, lane);
#pragma unroll 1
  for (int d0 = 0; d0 < DP; d0 += 32) {
    float f[NT][4];
#pragma unroll
    for (int kk = 0; kk < 32; kk += 8) {
      uint32_t a[4], ah[4], al[4];
      ldsm(a, pa + d0 + kk);
      split4(a, ah, al);
      uint32_t bh[NT][2], bl[NT][2];
#pragma unroll
      for (int j = 0; j < NT; j += 2) {
        uint32_t b[4], h[4], l[4];
        ldsm(b, pb + 8 * j * LD + d0 + kk);
        split4(b, h, l);
        bh[j][0] = h[0], bh[j][1] = h[1], bh[j + 1][0] = h[2],
        bh[j + 1][1] = h[3];
        bl[j][0] = l[0], bl[j][1] = l[1], bl[j + 1][0] = l[2],
        bl[j + 1][1] = l[3];
      }
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        if (kk == 0) mma_tf32_new(f[j], al, bh[j][0], bh[j][1]);
        else mma_tf32(f[j], al, bh[j][0], bh[j][1]);
      }
#pragma unroll
      for (int j = 0; j < NT; ++j) mma_tf32(f[j], ah, bl[j][0], bl[j][1]);
#pragma unroll
      for (int j = 0; j < NT; ++j) mma_tf32(f[j], ah, bh[j][0], bh[j][1]);
    }
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] += f[j][e];
  }
}

// acc[NTW] += A X over KD of k: A's 16 rows from m0, stored k-major (kAT:
// P or dS of pass 2, read transposed) or row-major (dS of pass 4), row
// stride LP; X stored k-major (dO, Q or K rows), columns from c0, stride
// LD. bf16: A is its hi plane, its lo plane PLANE elements on, one MMA
// each. fp32: fresh accumulators over the tile, added to acc in fp32.
template <bool kAT, int NTW, int KD, int LD, int LP, int PLANE>
__device__ __forceinline__ void grads(float (&acc)[NTW][4], const bf16* A,
                                      const bf16* X, int m0, int c0,
                                      int lane) {
  static_assert(NTW % 2 == 0, "n-tiles in pairs");
  const bf16* pa = kAT ? a_cols(A, LP, m0, 0, lane)
                       : a_rows(A, LP, m0, 0, lane);
  const bf16* px = b_cols(X, LD, 0, c0, lane);
#pragma unroll
  for (int kk = 0; kk < KD; kk += 16) {
    uint32_t ah[4], al[4];
    if (kAT) {
      ldsm_t(ah, pa + kk * LP);
      ldsm_t(al, pa + PLANE + kk * LP);
    } else {
      ldsm(ah, pa + kk);
      ldsm(al, pa + PLANE + kk);
    }
#pragma unroll
    for (int j = 0; j < NTW; j += 2) {
      uint32_t b[4];
      ldsm_t(b, px + kk * LD + 8 * j);
      mma_bf16(acc[j], al, b[0], b[1]);
      mma_bf16(acc[j + 1], al, b[2], b[3]);
      mma_bf16(acc[j], ah, b[0], b[1]);
      mma_bf16(acc[j + 1], ah, b[2], b[3]);
    }
  }
}
template <bool kAT, int NTW, int KD, int LD, int LP, int PLANE>
__device__ __forceinline__ void grads(float (&acc)[NTW][4], const float* A,
                                      const float* X, int m0, int c0,
                                      int lane) {
  static_assert(NTW % 4 == 0, "n-tiles in fours");
  const int g = lane >> 2, q = lane & 3;
#pragma unroll
  for (int j0 = 0; j0 < NTW; j0 += 4) {
    float f[4][4];
#pragma unroll
    for (int kk = 0; kk < KD; kk += 8) {
      uint32_t ah[4], al[4];
      if (kAT) {
        // A[m][k] = stored[k][m]: {(g, q), (g + 8, q), (g, q + 4),
        // (g + 8, q + 4)}
        const float* p = A + (kk + q) * LP + m0 + g;
        split(p[0], ah[0], al[0]);
        split(p[8], ah[1], al[1]);
        split(p[4 * LP], ah[2], al[2]);
        split(p[4 * LP + 8], ah[3], al[3]);
      } else {
        uint32_t a[4];
        ldsm(a, a_rows(A, LP, m0, kk, lane));
        split4(a, ah, al);
      }
      // B[k][n] = X[k][c0 + 8 j + n]: b0 = (q, g), b1 = (q + 4, g)
      uint32_t bh[4][2], bl[4][2];
      const float* x = X + (kk + q) * LD + c0 + 8 * j0 + g;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        split(x[8 * i], bh[i][0], bl[i][0]);
        split(x[4 * LD + 8 * i], bh[i][1], bl[i][1]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (kk == 0) mma_tf32_new(f[i], al, bh[i][0], bh[i][1]);
        else mma_tf32(f[i], al, bh[i][0], bh[i][1]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) mma_tf32(f[i], ah, bl[i][0], bl[i][1]);
#pragma unroll
      for (int i = 0; i < 4; ++i) mma_tf32(f[i], ah, bh[i][0], bh[i][1]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j0 + i][e] += f[i][e];
  }
}

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
// admitted pair, or (with_empty) a row that admits no key, which sees
// every key at 1 / Sk. Empty rows lie at the ends of the rows, so the
// first and the last row tell.
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

// rows [0, n_rows) of a (.., S, H, Dh) head starting at src (row stride
// `row`) -> shared rows of stride LD by cp.async, 16-byte copies (8 where
// a bf16 row is not 16-byte aligned); rows past `valid` are zero-filled
template <typename T, int LD>
__device__ __forceinline__ void stage(T* dst, const T* src, int64_t row,
                                      int n_rows, int valid, int Dh,
                                      int vec) {
  const int per = (vec ? 16 : 8) / static_cast<int>(sizeof(T));
  const int nu = Dh / per;
  for (int i = threadIdx.x; i < n_rows * nu; i += kThreads) {
    const int r = i / nu, u = i - r * nu;
    const bool ok = r < valid;
    const T* from = ok ? src + r * row + u * per : src;
    if (vec) cp_async16(dst + r * LD + u * per, from, ok);
    else cp_async8(dst + r * LD + u * per, from, ok);
  }
}

// n values of lse and D from `at` on (rows past `valid` zero)
__device__ __forceinline__ void stage_rows(float* lse_s, float* d_s,
                                           const float* lse,
                                           const float* drow, int64_t at,
                                           int n, int valid) {
  for (int r = threadIdx.x; r < n; r += kThreads) {
    const bool ok = r < valid;
    cp_async4(lse_s + r, ok ? lse + at + r : lse, ok);
    cp_async4(d_s + r, ok ? drow + at + r : drow, ok);
  }
}

// columns Dh .. DP - 1 of n rows: the copies never write them, the
// products read them as zeros
template <typename T, int DP, int LD>
__device__ __forceinline__ void zero_pad(T* rows, int n, int Dh) {
  const int pad = DP - Dh;
  if (pad == 0) return;
  for (int i = threadIdx.x; i < n * pad; i += kThreads)
    zero(rows + (i / pad) * LD + Dh + i % pad);
}

// P = exp(s scale - lse). fp32: expf, as accurate as the plain version's;
// bf16: one FMA and the SFU's ex2.approx, lse given times log2(e). The
// error budget there: P and dS go to the products as bf16 hi and lo
// planes, which keep about 16 bits (2^-16 of each value); ex2.approx errs
// about 2^-22 of its result (two fp32 ulps), 64x below that, and the
// FMA's rounding of the exponent costs what expf's argument costs.
constexpr float kLog2e = 1.4426950408889634f;
template <typename T>
__device__ __forceinline__ float prob(float s, float scale, float l) {
  if constexpr (sizeof(T) == 2) {
    float y;
    asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y)
        : "f"(fmaf(s, scale * kLog2e, -l)));
    return y;
  } else {
    return expf(s * scale - l);
  }
}

// S and dP of warp w's 16 rows (from m0) and NT n-tiles of keys (from n0)
// of a (BM-row, BN-key) tile pair, then P and dS into shared memory (P
// only when ps is not null; bf16 as hi and lo planes, PLANE elements
// apart): rows r0 + m0 .. of the query tile, keys c0 + n0 .. of the key
// tile.
struct Mask {
  int Sq, Sk, causal, window, q_offset;
  float scale;
};
template <typename T, int NT, int DP, int LD, int LP, int PLANE>
__device__ __forceinline__ void probabilities(
    const T* qs, const T* dos, const T* ks, const T* vs, const float* lse_s,
    const float* d_s, T* ps, T* dss, int r0, int c0, int m0, int n0,
    bool with_empty, const Mask& mk, int lane) {
  float s[NT][4], dp[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.0f;
  const int wr = r0 + m0, wk = c0 + n0;
  // a warp whose rows see none of its keys takes no MMAs
  if (wr < mk.Sq && wk < mk.Sk &&
      tile_sees(mk.q_offset + wr, mk.q_offset + min(wr + 15, mk.Sq - 1), wk,
                min(wk + 8 * NT - 1, mk.Sk - 1), mk.Sk, mk.causal, mk.window,
                with_empty)) {
    scores<NT, DP, LD>(s, qs, ks, m0, n0, lane);
    scores<NT, DP, LD>(dp, dos, vs, m0, n0, lane);
  }
  // every pair of the warp's rows and keys admitted (rows and keys in
  // range, no row that admits no key): no mask to test
  const int wp = mk.q_offset + wr, wk1 = wk + 8 * NT - 1;
  const bool full = wr + 15 < mk.Sq && wk1 < mk.Sk &&
                    !empty_row(wp, mk.Sk, mk.causal, mk.window) &&
                    !empty_row(wp + 15, mk.Sk, mk.causal, mk.window) &&
                    (!mk.causal || wk1 <= wp) &&
                    (mk.window <= 0 || wk > wp + 15 - mk.window);
  const int g = lane >> 2, q = lane & 3;
  const float inv_sk = 1.0f / static_cast<float>(mk.Sk);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = m0 + g + 8 * h;
    const int gr = r0 + row, p = mk.q_offset + gr;
    const bool in = gr < mk.Sq;
    const bool empty = empty_row(p, mk.Sk, mk.causal, mk.window);
    // bf16: the row's log-sum-exp in log2 units (see prob)
    const float l = sizeof(T) == 2 ? lse_s[row] * kLog2e : lse_s[row];
    const float dd = d_s[row];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int key = n0 + 8 * j + 2 * q;
      float pr[2], ds[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int gk = c0 + key + e;
        pr[e] = 0.0f;
        ds[e] = 0.0f;
        if (full) {
          pr[e] = prob<T>(s[j][2 * h + e], mk.scale, l);
          ds[e] = pr[e] * (dp[j][2 * h + e] - dd);
        } else if (in && gk < mk.Sk) {
          if (empty) {
            pr[e] = inv_sk;
          } else if (admitted(p, gk, mk.Sk, mk.causal, mk.window)) {
            pr[e] = prob<T>(s[j][2 * h + e], mk.scale, l);
            ds[e] = pr[e] * (dp[j][2 * h + e] - dd);
          }
        }
      }
      const int at = row * LP + key;
      if constexpr (sizeof(T) == 2) {
        if (ps != nullptr)
          store2_split(ps + at, ps + PLANE + at, pr[0], pr[1]);
        store2_split(dss + at, dss + PLANE + at, ds[0], ds[1]);
      } else {
        if (ps != nullptr) store2(ps + at, pr[0], pr[1]);
        store2(dss + at, ds[0], ds[1]);
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_bwd_rowdot(const T* __restrict__ out, const T* __restrict__ dout,
                 float* __restrict__ drow, int64_t rows, int Sq, int Hq,
                 int Dh) {
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

// Pass 2: a block a (b, query head h, key tile blockIdx.y); the first key
// tiles see the most rows under a causal mask and start first.
template <typename T, int DP>
__global__ void __launch_bounds__(kThreads, (Plan<T, DP>::kBlocks2))
flash_bwd_dkdv(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, const T* __restrict__ dout,
               const float* __restrict__ lse, const float* __restrict__ drow,
               float* __restrict__ dk_part, float* __restrict__ dv_part,
               int Sq, int Sk, int Hq, int Hkv, int Dh, int causal,
               int window, int q_offset, float scale, int vec) {
  using Pl = Plan<T, DP>;
  constexpr int BN = kR, BM = Pl::kS, ST = Pl::kStages2, LD = Pl::kLD,
                LP = Pl::kLP2, PLANE = BM * LP;
  // S and dP: warps (BM / 16) x WN over the tile; dK and dV: 4 x 2 over
  // (64 keys, DP columns)
  constexpr int WM = BM / 16, WN = kWarps / WM, NT = BN / WN / 8,
                NTW = DP / 16;
  extern __shared__ __align__(16) unsigned char smem[];
  T* ks = reinterpret_cast<T*>(smem);   // BN x LD
  T* vs = ks + BN * LD;                 // BN x LD
  T* qs = vs + BN * LD;                 // ST x BM x LD
  T* dos = qs + ST * BM * LD;           // ST x BM x LD
  T* ps = dos + ST * BM * LD;           // kPlanes x BM x LP
  T* dss = ps + Pl::kPlanes * PLANE;    // kPlanes x BM x LP
  float* lse_s = reinterpret_cast<float*>(dss + Pl::kPlanes * PLANE);
                                        // ST x BM
  float* d_s = lse_s + ST * BM;                             // ST x BM

  const int b = blockIdx.x / Hq, h = blockIdx.x % Hq;
  const int hk = h / (Hq / Hkv);
  const int c0 = blockIdx.y * BN, nkeys = min(BN, Sk - c0);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const Mask mk{Sq, Sk, causal, window, q_offset, scale};
  const int64_t q_row = static_cast<int64_t>(Hq) * Dh;
  const int64_t k_row = static_cast<int64_t>(Hkv) * Dh;
  const T* qb = q + static_cast<int64_t>(b) * Sq * q_row +
                static_cast<int64_t>(h) * Dh;
  const T* dob = dout + static_cast<int64_t>(b) * Sq * q_row +
                 static_cast<int64_t>(h) * Dh;
  const int64_t lse_at = (static_cast<int64_t>(b) * Hq + h) * Sq;

  zero_pad<T, DP, LD>(ks, 2 * BN + 2 * ST * BM, Dh);
  const int64_t kv = (static_cast<int64_t>(b) * Sk + c0) * k_row +
                     static_cast<int64_t>(hk) * Dh;
  stage<T, LD>(ks, k + kv, k_row, BN, nkeys, Dh, vec);
  stage<T, LD>(vs, v + kv, k_row, BN, nkeys, Dh, vec);

  const int n_tiles = (Sq + BM - 1) / BM;
  auto next = [&](int i) {
    for (; i < n_tiles; ++i) {
      const int r0 = i * BM, rows = min(BM, Sq - r0);
      if (tile_sees(q_offset + r0, q_offset + r0 + rows - 1, c0,
                    c0 + nkeys - 1, Sk, causal, window, true))
        break;
    }
    return i;
  };
  auto stage_q = [&](int i, int buf) {
    const int r0 = i * BM, rows = min(BM, Sq - r0);
    stage<T, LD>(qs + buf * BM * LD, qb + r0 * q_row, q_row, BM, rows, Dh,
                 vec);
    stage<T, LD>(dos + buf * BM * LD, dob + r0 * q_row, q_row, BM, rows, Dh,
                 vec);
    stage_rows(lse_s + buf * BM, d_s + buf * BM, lse, drow, lse_at + r0, BM,
               rows);
  };
  int i = next(0);
  if (i < n_tiles) stage_q(i, 0);
  cp_async_commit();

  float dk[NTW][4], dv[NTW][4];
#pragma unroll
  for (int j = 0; j < NTW; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[j][e] = dv[j][e] = 0.0f;
  const int m0 = 16 * (warp % WM), n0 = 8 * NT * (warp / WM);
  const int m2 = 16 * (warp & 3), c2 = (DP / 2) * (warp >> 2);

  for (int buf = 0; i < n_tiles; buf = ST == 2 ? buf ^ 1 : 0) {
    cp_async_wait<0>();   // this tile (and K, V) have landed
    __syncthreads();      // ... for every thread; the last tile is done
    const int nxt = next(i + 1);
    if constexpr (ST == 2) {
      if (nxt < n_tiles) stage_q(nxt, buf ^ 1);
      cp_async_commit();
    }
    const T* qt = qs + buf * BM * LD;
    const T* dot = dos + buf * BM * LD;
    probabilities<T, NT, DP, LD, LP, PLANE>(
        qt, dot, ks, vs, lse_s + buf * BM, d_s + buf * BM, ps, dss, i * BM,
        c0, m0, n0, true, mk, lane);
    __syncthreads();
    grads<true, NTW, BM, LD, LP, PLANE>(dv, ps, dot, m2, c2, lane);
    grads<true, NTW, BM, LD, LP, PLANE>(dk, dss, qt, m2, c2, lane);
    if constexpr (ST == 1) {
      __syncthreads();    // every warp is done with the one buffer
      if (nxt < n_tiles) stage_q(nxt, 0);
      cp_async_commit();
    }
    i = nxt;
  }
  cp_async_wait<0>();   // K and V, where no tile saw them

  const int g = lane >> 2, qd = lane & 3;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int key = c0 + m2 + g + 8 * hh;
    if (key >= Sk) continue;
    const int64_t at = ((static_cast<int64_t>(b) * Sk + key) * Hq + h) * Dh;
#pragma unroll
    for (int j = 0; j < NTW; ++j) {
      const int d = c2 + 8 * j + 2 * qd;
      if (d < Dh) {
        store2(dk_part + at + d, dk[j][2 * hh] * scale,
               dk[j][2 * hh + 1] * scale);
        store2(dv_part + at + d, dv[j][2 * hh], dv[j][2 * hh + 1]);
      }
    }
  }
}

// dK, dV (B, Sk, Hkv, Dh) = the partials (B, Sk, Hq, Dh) summed over each
// KV head's query heads in order, four columns a thread
template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_bwd_reduce(const float* __restrict__ dk_part,
                 const float* __restrict__ dv_part, T* __restrict__ dk,
                 T* __restrict__ dv, int64_t n4, int Hkv, int rep, int Dh) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads +
                    threadIdx.x;
  if (i >= n4) return;
  // 4 i = ((b Sk + c) Hkv + hk) Dh + d
  const int64_t e = 4 * i;
  const int d = static_cast<int>(e % Dh);
  const int64_t pos = e / Dh / Hkv;
  const int hk = static_cast<int>((e / Dh) % Hkv);
  const int64_t src = (pos * Hkv * rep + static_cast<int64_t>(hk) * rep) *
                      Dh + d;
  float4 a = make_float4(0.0f, 0.0f, 0.0f, 0.0f), c = a;
  for (int r = 0; r < rep; ++r) {
    const float4 x = *reinterpret_cast<const float4*>(
        dk_part + src + static_cast<int64_t>(r) * Dh);
    const float4 y = *reinterpret_cast<const float4*>(
        dv_part + src + static_cast<int64_t>(r) * Dh);
    a.x += x.x, a.y += x.y, a.z += x.z, a.w += x.w;
    c.x += y.x, c.y += y.y, c.z += y.z, c.w += y.w;
  }
  store2(dk + e, a.x, a.y);
  store2(dk + e + 2, a.z, a.w);
  store2(dv + e, c.x, c.y);
  store2(dv + e + 2, c.z, c.w);
}

// Pass 4: a block a (b, query head h, row tile); the last row tiles see
// the most keys under a causal mask and start first.
template <typename T, int DP>
__global__ void __launch_bounds__(kThreads, (Plan<T, DP>::kBlocks4))
flash_bwd_dq(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, const T* __restrict__ dout,
             const float* __restrict__ lse, const float* __restrict__ drow,
             T* __restrict__ dq, int Sq, int Sk, int Hq, int Hkv, int Dh,
             int causal, int window, int q_offset, float scale, int vec) {
  using Pl = Plan<T, DP>;
  constexpr int BM = kR, BN = Pl::kS, ST = Pl::kStages4, LD = Pl::kLD,
                LP = Pl::kLP4, PLANE = BM * LP;
  constexpr int WM = BM / 16, WN = kWarps / WM, NT = BN / WN / 8,
                NTW = DP / 16;
  extern __shared__ __align__(16) unsigned char smem[];
  T* qs = reinterpret_cast<T*>(smem);   // BM x LD
  T* dos = qs + BM * LD;                // BM x LD
  T* ks = dos + BM * LD;                // ST x BN x LD
  T* vs = ks + ST * BN * LD;            // ST x BN x LD
  T* dss = vs + ST * BN * LD;           // kPlanes x BM x LP
  float* lse_s = reinterpret_cast<float*>(dss + Pl::kPlanes * PLANE);
                                                            // BM
  float* d_s = lse_s + BM;                                  // BM

  const int b = blockIdx.x / Hq, h = blockIdx.x % Hq;
  const int hk = h / (Hq / Hkv);
  const int r0 = (gridDim.y - 1 - blockIdx.y) * BM;
  const int rows = min(BM, Sq - r0);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const Mask mk{Sq, Sk, causal, window, q_offset, scale};
  const int64_t q_row = static_cast<int64_t>(Hq) * Dh;
  const int64_t k_row = static_cast<int64_t>(Hkv) * Dh;
  const int64_t base = (static_cast<int64_t>(b) * Sq + r0) * q_row +
                       static_cast<int64_t>(h) * Dh;
  const T* kb = k + static_cast<int64_t>(b) * Sk * k_row +
                static_cast<int64_t>(hk) * Dh;
  const T* vb = v + static_cast<int64_t>(b) * Sk * k_row +
                static_cast<int64_t>(hk) * Dh;

  zero_pad<T, DP, LD>(qs, 2 * BM + 2 * ST * BN, Dh);
  stage<T, LD>(qs, q + base, q_row, BM, rows, Dh, vec);
  stage<T, LD>(dos, dout + base, q_row, BM, rows, Dh, vec);
  stage_rows(lse_s, d_s, lse, drow, (static_cast<int64_t>(b) * Hq + h) * Sq +
             r0, BM, rows);

  // a row that admits no key has dS = 0: only admitted pairs matter
  const int n_tiles = (Sk + BN - 1) / BN;
  auto next = [&](int j) {
    for (; j < n_tiles; ++j) {
      const int c0 = j * BN;
      if (tile_sees(q_offset + r0, q_offset + r0 + rows - 1, c0,
                    min(c0 + BN, Sk) - 1, Sk, causal, window, false))
        break;
    }
    return j;
  };
  auto stage_kv = [&](int j, int buf) {
    const int c0 = j * BN;
    stage<T, LD>(ks + buf * BN * LD, kb + c0 * k_row, k_row, BN, Sk - c0,
                 Dh, vec);
    stage<T, LD>(vs + buf * BN * LD, vb + c0 * k_row, k_row, BN, Sk - c0,
                 Dh, vec);
  };
  int j = next(0);
  if (j < n_tiles) stage_kv(j, 0);
  cp_async_commit();

  float acc[NTW][4];
#pragma unroll
  for (int t = 0; t < NTW; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[t][e] = 0.0f;
  const int m0 = 16 * (warp % WM), n0 = 8 * NT * (warp / WM);
  const int m2 = 16 * (warp & 3), c2 = (DP / 2) * (warp >> 2);

  for (int buf = 0; j < n_tiles; buf = ST == 2 ? buf ^ 1 : 0) {
    cp_async_wait<0>();
    __syncthreads();
    const int nxt = next(j + 1);
    if constexpr (ST == 2) {
      if (nxt < n_tiles) stage_kv(nxt, buf ^ 1);
      cp_async_commit();
    }
    const T* kt = ks + buf * BN * LD;
    const T* vt = vs + buf * BN * LD;
    probabilities<T, NT, DP, LD, LP, PLANE>(
        qs, dos, kt, vt, lse_s, d_s, nullptr, dss, r0, j * BN, m0, n0, false,
        mk, lane);
    __syncthreads();
    grads<false, NTW, BN, LD, LP, PLANE>(acc, dss, kt, m2, c2, lane);
    if constexpr (ST == 1) {
      __syncthreads();
      if (nxt < n_tiles) stage_kv(nxt, 0);
      cp_async_commit();
    }
    j = nxt;
  }
  cp_async_wait<0>();   // Q and dO, where no tile was seen

  const int g = lane >> 2, qd = lane & 3;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = m2 + g + 8 * hh;
    if (row >= rows) continue;
    T* o = dq + base + static_cast<int64_t>(row) * q_row;
#pragma unroll
    for (int t = 0; t < NTW; ++t) {
      const int d = c2 + 8 * t + 2 * qd;
      if (d < Dh)
        store2(o + d, acc[t][2 * hh] * scale, acc[t][2 * hh + 1] * scale);
    }
  }
}

// the opt-in above 48 KB, once per device and kernel instance (instances
// of one signature share no state) for the largest size asked, so that a
// launch inside a CUDA graph capture sets nothing
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

// the fp32 scratch: drow (B Hq Sq floats, rounded up to 4 so that the
// partials start 16-byte aligned), then dk_part and dv_part (B Sk Hq Dh
// floats each)
inline int64_t drow_floats(int B, int Sq, int Hq) {
  return (static_cast<int64_t>(B) * Hq * Sq + 3) / 4 * 4;
}

template <typename T, int DP>
int launch(const void* q, const void* k, const void* v, const void* out,
           const void* dout, const float* lse, void* dq, void* dk, void* dv,
           float* drow, float* dk_part, float* dv_part, int B, int Sq,
           int Sk, int Hq, int Hkv, int Dh, int causal, int window,
           int q_offset, float scale, int vec, cudaStream_t s) {
  using Pl = Plan<T, DP>;
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* dot = static_cast<const T*>(dout);
  const int64_t rows = static_cast<int64_t>(B) * Sq * Hq;
  flash_bwd_rowdot<T><<<static_cast<unsigned>((rows * 32 + kThreads - 1) /
                                              kThreads), kThreads, 0, s>>>(
      static_cast<const T*>(out), dot, drow, rows, Sq, Hq, Dh);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  int rc = opt_in<flash_bwd_dkdv<T, DP>>(Pl::kSmemDkdv);
  if (rc) return rc;
  rc = opt_in<flash_bwd_dq<T, DP>>(Pl::kSmemDq);
  if (rc) return rc;
  flash_bwd_dkdv<T, DP><<<dim3(B * Hq, (Sk + kR - 1) / kR), kThreads,
                          Pl::kSmemDkdv, s>>>(
      qt, kt, vt, dot, lse, drow, dk_part, dv_part, Sq, Sk, Hq, Hkv, Dh,
      causal, window, q_offset, scale, vec);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t n4 = static_cast<int64_t>(B) * Sk * Hkv * Dh / 4;
  flash_bwd_reduce<T><<<static_cast<unsigned>((n4 + kThreads - 1) /
                                              kThreads), kThreads, 0, s>>>(
      dk_part, dv_part, static_cast<T*>(dk), static_cast<T*>(dv), n4, Hkv,
      Hq / Hkv, Dh);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_bwd_dq<T, DP><<<dim3(B * Hq, (Sq + kR - 1) / kR), kThreads,
                        Pl::kSmemDq, s>>>(
      qt, kt, vt, dot, lse, drow, static_cast<T*>(dq), Sq, Sk, Hq, Hkv, Dh,
      causal, window, q_offset, scale, vec);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, const void* out,
             const void* dout, const float* lse, void* dq, void* dk,
             void* dv, float* drow, float* dk_part, float* dv_part, int B,
             int Sq, int Sk, int Hq, int Hkv, int Dh, int causal, int window,
             int q_offset, float scale, int vec, cudaStream_t s) {
#define REPRO_FLASH_BWD(DP)                                                 \
  return launch<T, DP>(q, k, v, out, dout, lse, dq, dk, dv, drow, dk_part,  \
                       dv_part, B, Sq, Sk, Hq, Hkv, Dh, causal, window,     \
                       q_offset, scale, vec, s)
  switch ((Dh + 63) / 64) {
    case 1: REPRO_FLASH_BWD(64);
    case 2: REPRO_FLASH_BWD(128);
    case 3: REPRO_FLASH_BWD(192);
    case 4: REPRO_FLASH_BWD(256);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef REPRO_FLASH_BWD
}

}  // namespace

// Bytes of the fp32 scratch the caller passes: drow (B Hq Sq floats,
// rounded up to 4), then dk_part and dv_part (B Sk Hq Dh floats each).
extern "C" int64_t flash_attention_bwd_scratch(int B, int Sq, int Sk, int Hq,
                                               int Dh) {
  return (drow_floats(B, Sq, Hq) +
          2 * static_cast<int64_t>(B) * Sk * Hq * Dh) * 4;
}

// dtype: 0 = fp32, 1 = bf16, of q, k, v, out, dout, dq, dk, dv; lse and
// the scratch fp32; all contiguous, q, k and v 16-byte (fp32) or 8-byte
// (bf16) aligned. vec: every row of q, k, v and dout starts 16-byte
// aligned (always so for fp32), so the tiles are copied 16 bytes at a
// time. causal 0 or 1; window <= 0: none. Dh a multiple of 4 up to 256,
// Hq a multiple of Hkv (the wrapper checks). Returns the first launch
// error, or cudaGetLastError() after the last.
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* out,
    const void* dout, const void* lse, void* dq, void* dk, void* dv,
    void* scratch, int B, int Sq, int Sk, int Hq, int Hkv, int Dh,
    int causal, int window, int q_offset, float scale, int dtype, int vec,
    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || Sq <= 0 || Sk <= 0 || Hq <= 0 || Hkv <= 0 || Dh <= 0)
    return 0;
  if (Dh > 256 || Dh % 4 != 0 || Hq % Hkv != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  float* drow = static_cast<float*>(scratch);
  float* dk_part = drow + drow_floats(B, Sq, Hq);
  float* dv_part = dk_part + static_cast<int64_t>(B) * Sk * Hq * Dh;
  const float* l = static_cast<const float*>(lse);
  if (dtype == 0)
    return dispatch<float>(q, k, v, out, dout, l, dq, dk, dv, drow, dk_part,
                           dv_part, B, Sq, Sk, Hq, Hkv, Dh, causal, window,
                           q_offset, scale, 1, s);
  return dispatch<bf16>(q, k, v, out, dout, l, dq, dk, dv, drow, dk_part,
                        dv_part, B, Sq, Sk, Hq, Hkv, Dh, causal, window,
                        q_offset, scale, vec, s);
}
