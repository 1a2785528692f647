// matmul: C = act(A @ B + bias) with fp32 accumulation, for A (M, K) and
// B (K, N) both fp32 or both bf16, bias (N,) fp32 or absent, C (M, N) in
// A's type; act is none, relu, silu or tanh-gelu.
//
// Replaces the TPU kernel repro/kernels/gemm/kernel.py::matmul, a
// (bm, bk, bn) Pallas grid whose innermost K dimension carries an fp32 VMEM
// scratch tile across grid steps and whose ragged edges are zero-padded
// copies of A and B. A CUDA grid has no order and no scratch carried
// between blocks, so each block owns one output tile and loops over K
// itself, with the fp32 accumulator in registers. Nothing is padded or
// copied: the ragged edges are masked loads (or TMA's zero fill) and
// masked stores. The epilogue applies bias, then the activation, in fp32
// before the one store. Two routes, chosen by the wrapper before the
// launch from dtype, strides and alignment alone
// (kernels/gemm/kernel.py::route):
//
// * wgmma (bf16 A and B that TMA can read: one unit stride each, the other
//   a multiple of 8 elements, 16-byte aligned bases; A K-major, B K-major
//   (the W.T view Linear and Conv2d pass) or N-major (a contiguous (K, N)
//   B)). A 128 x 128 output tile a block, BK = 64: a ring of kStages
//   32 KB stages in dynamic shared memory, each filled by TMA loads with
//   128-byte swizzle (out-of-bounds elements read as zero, so ragged M, N
//   and K need no padding) and guarded by a full and an empty mbarrier.
//   One thread of a producer warpgroup (registers lowered by setmaxnreg)
//   issues the loads; two consumer warpgroups each issue
//   wgmma.mma_async.m64n128k16.f32.bf16.bf16 on their 64 rows, fp32
//   accumulators in registers. An N-major B is read through the
//   descriptor's transpose bit, not copied. Bound by operations: 2 M N K
//   at 989 TFLOP/s dense bf16 on the tensor cores.
// * fma (every fp32 product, and bf16 products TMA cannot take, such as
//   K = 25): IEEE fp32 FMAs, no TF32 (the reference's rtol = atol = 2e-4
//   is below what TF32 keeps). K slices of BK = 8 are staged in shared
//   memory as fp32, transposed (k-major rows of the tile's M or N extent,
//   padded by 4 floats, so that the transposing stores are conflict-free),
//   in two buffers: the next slice's global loads are in flight in
//   registers while the FMAs run on the current one. A thread owns a
//   4 SM x 4 SN grid of 4 x 4 sub-tiles, so every shared-memory read is a
//   conflict-free 16-byte load. Global loads move 4 elements (16 bytes in
//   fp32, 8 in bf16) where the operand's unit-stride dimension, its other
//   stride and its base allow; elsewhere the same groups load masked
//   scalars. The tile follows N so that a narrow output does not leave
//   most of a square tile's columns masked: N <= 16 takes 256 x 16 tiles,
//   N <= 64 128 x 64, wider 128 x 128 (256 threads each); a wider product
//   whose grid of those would leave SMs idle (LeNet's fc layers at M =
//   1,000) takes 64 x 64 tiles, four times the blocks. A contiguous A
//   whose rows are no multiple of 4 elements long, with K <= kFlatK and
//   N <= 16 (LeNet's conv1, K = 25), loads a 256-row tile as the one
//   contiguous run it is (25.6 KB in fp32) with 16-byte loads. Bound on
//   the H100: LeNet's skinny shapes (N = 6..120, K = 25..256) by bytes (A
//   read once per column tile, C written once) at 3.35 TB/s; a square
//   4096^3 product by operations, 2 M N K at 67 TFLOP/s outside the
//   tensor cores.
#include <cuda.h>   // CUtensorMap and its enums; the driver's encoder is
                    // fetched at run time (cudaGetDriverEntryPoint)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

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

// ===========================================================================
// the fma route
// ===========================================================================
constexpr int kThreads = 256;
constexpr int BK = 8;
constexpr int kPad = 4;
constexpr int kFlatK = 32;

// 4 consecutive elements at p (16-byte aligned in fp32, 8-byte in bf16)
__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&v)[4]) {
  const uint2 x = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&x.x);
  const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&x.y);
  v[0] = __low2float(lo); v[1] = __high2float(lo);
  v[2] = __low2float(hi); v[3] = __high2float(hi);
}

// the V = 16 / sizeof(T) elements of a 16-byte chunk, as fp32 at dst
template <typename T>
__device__ __forceinline__ void widen16(float* dst, const uint4& raw) {
  if constexpr (sizeof(T) == 4) {
    *reinterpret_cast<uint4*>(dst) = raw;
  } else {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float2 lo = __bfloat1622float2(h[2 * i]);
      const float2 hi = __bfloat1622float2(h[2 * i + 1]);
      *reinterpret_cast<float4*>(dst + 4 * i) =
          make_float4(lo.x, lo.y, hi.x, hi.y);
    }
  }
}

// One operand's K slices, as the (R x BK) tile of its rows (A's M or B's
// N) from the block's first and columns k0 .. k0 + BK - 1, moved in groups
// of 4 elements: group g = tid + i kThreads is, along K (kc), row g / (BK/4)
// and columns (g % (BK/4)) 4 .. + 3, else (along the rows) column
// g / (R/4) and rows (g % (R/4)) 4 .. + 3 (compile-time powers of two:
// shifts and masks, once a group). Element (row, k) is p[row s_r + k s_k];
// rows past `rows` and columns past K read as zero. It lands in S[k][row].
template <typename T, int R>
struct Operand {
  static constexpr int kGroups = R * BK / 4;
  static constexpr int kPer = (kGroups + kThreads - 1) / kThreads;
  const T* p;
  int64_t s_r, s_k;
  int rows, K;
  bool kc, vec;
  float v[kPer][4];

  __device__ __forceinline__ void fetch(int k0, int tid) {
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int g = tid + i * kThreads;
      if (kGroups % kThreads != 0 && g >= kGroups) break;
      const int r = kc ? g / (BK / 4) : (g % (R / 4)) * 4;
      const int k = k0 + (kc ? (g % (BK / 4)) * 4 : g / (R / 4));
      const T* q = p + r * s_r + k * s_k;
      if (vec) {
        // the group lies wholly inside or wholly outside: fma_route sets
        // vec only where the extent along the unit stride is a multiple
        // of 4
        if (r < rows && k < K) {
          load4(q, v[i]);
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j) v[i][j] = 0.0f;
        }
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const bool in = kc ? (r < rows && k + j < K)
                             : (r + j < rows && k < K);
          v[i][j] = in ? to_f32(q[kc ? j * s_k : j * s_r]) : 0.0f;
        }
      }
    }
  }

  __device__ __forceinline__ void put(float (*S)[R + kPad], int tid) const {
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int g = tid + i * kThreads;
      if (kGroups % kThreads != 0 && g >= kGroups) break;
      if (kc) {
        const int r = g / (BK / 4), k = (g % (BK / 4)) * 4;
#pragma unroll
        for (int j = 0; j < 4; ++j) S[k + j][r] = v[i][j];
      } else {
        *reinterpret_cast<float4*>(&S[g / (R / 4)][(g % (R / 4)) * 4]) =
            make_float4(v[i][0], v[i][1], v[i][2], v[i][3]);
      }
    }
  }
};

// bias, activation and the masked store of a thread's TM x TN outputs at
// rows row[i] and columns col[s] .. col[s] + 3
template <typename T, int TM, int TN>
__device__ __forceinline__ void epilogue(const float (&acc)[TM][TN],
                                         const int64_t (&row)[TM],
                                         const int (&col)[TN / 4],
                                         const float* __restrict__ bias,
                                         T* __restrict__ C, int64_t M, int N,
                                         int act) {
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    if (row[i] >= M) continue;
    T* out = C + row[i] * N;
#pragma unroll
    for (int s = 0; s < TN / 4; ++s) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = col[s] + j;
        if (n >= N) break;
        float x = acc[i][4 * s + j];
        if (bias != nullptr) x += bias[n];
        store(out + n, activate(x, act));
      }
    }
  }
}

template <typename T, int BM, int BN, int SM, int SN>
__global__ void __launch_bounds__(kThreads)
fma_kernel(const T* __restrict__ A, const T* __restrict__ B,
           const float* __restrict__ bias, T* __restrict__ C, int64_t M,
           int N, int K, int64_t sam, int64_t sak, int64_t sbk, int64_t sbn,
           int a_kc, int a_vec, int b_kc, int b_vec, int act) {
  constexpr int TM = 4 * SM, TN = 4 * SN;
  constexpr int TX = BN / TN, TY = BM / TM;
  static_assert(TX * TY == kThreads, "one sub-tile grid a thread");
  __shared__ __align__(16) float As[2][BK][BM + kPad];
  __shared__ __align__(16) float Bs[2][BK][BN + kPad];
  const int tid = threadIdx.x;
  const int tx = tid % TX, ty = tid / TX;
  const int64_t m0 = static_cast<int64_t>(blockIdx.x) * BM;
  const int n0 = blockIdx.y * BN;

  Operand<T, BM> a{A + m0 * sam, sam, sak,
                   static_cast<int>(M - m0 < BM ? M - m0 : BM), K,
                   a_kc != 0, a_vec != 0};
  Operand<T, BN> b{B + n0 * sbn, sbn, sbk, N - n0 < BN ? N - n0 : BN, K,
                   b_kc != 0, b_vec != 0};

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;

  const int KT = (K + BK - 1) / BK;
  if (KT > 0) {
    a.fetch(0, tid);
    b.fetch(0, tid);
    a.put(As[0], tid);
    b.put(Bs[0], tid);
  }
  __syncthreads();
  for (int kt = 0; kt < KT; ++kt) {
    const int cur = kt & 1;
    const bool more = kt + 1 < KT;
    if (more) {   // the next slice's loads fly while the FMAs run
      a.fetch((kt + 1) * BK, tid);
      b.fetch((kt + 1) * BK, tid);
    }
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float av[TM], bv[TN];
#pragma unroll
      for (int s = 0; s < SM; ++s) {
        const float4 x = *reinterpret_cast<const float4*>(
            &As[cur][kk][s * (BM / SM) + ty * 4]);
        av[4 * s] = x.x; av[4 * s + 1] = x.y;
        av[4 * s + 2] = x.z; av[4 * s + 3] = x.w;
      }
#pragma unroll
      for (int s = 0; s < SN; ++s) {
        const float4 x = *reinterpret_cast<const float4*>(
            &Bs[cur][kk][s * (BN / SN) + tx * 4]);
        bv[4 * s] = x.x; bv[4 * s + 1] = x.y;
        bv[4 * s + 2] = x.z; bv[4 * s + 3] = x.w;
      }
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    if (more) {
      a.put(As[cur ^ 1], tid);
      b.put(Bs[cur ^ 1], tid);
    }
    __syncthreads();
  }

  int64_t row[TM];
  int col[SN];
#pragma unroll
  for (int s = 0; s < SM; ++s)
#pragma unroll
    for (int i = 0; i < 4; ++i) row[4 * s + i] = m0 + s * (BM / SM) + ty * 4 + i;
#pragma unroll
  for (int s = 0; s < SN; ++s) col[s] = n0 + s * (BN / SN) + tx * 4;
  epilogue<T, TM, TN>(acc, row, col, bias, C, M, N, act);
}

// A contiguous (rows of K elements, K <= kFlatK, K not a multiple of 4),
// N <= 16: a 256-row tile of A is one contiguous run of 256 K elements,
// loaded whole with 16-byte loads into (dynamic) shared memory as fp32,
// 256 K floats, with all of B's 16 columns. Thread (ty, tx) owns rows
// ty + 64 i (a warp's 8 rows then sit K words apart, in 8 banks, for K not
// a multiple of 8) and columns 4 tx .. + 3.
template <typename T>
__global__ void __launch_bounds__(kThreads)
fma_flat_kernel(const T* __restrict__ A, const T* __restrict__ B,
                const float* __restrict__ bias, T* __restrict__ C, int64_t M,
                int N, int K, int64_t sbk, int64_t sbn, int act) {
  constexpr int BM = 256, BN = 16, V = 16 / sizeof(T);
  extern __shared__ float4 flat_smem[];
  float* Af = reinterpret_cast<float*>(flat_smem);
  __shared__ __align__(16) float Bs[kFlatK][BN];
  const int tid = threadIdx.x;
  const int tx = tid % 4, ty = tid / 4;
  const int64_t m0 = static_cast<int64_t>(blockIdx.x) * BM;
  const int n0 = blockIdx.y * BN;
  const int64_t first = m0 * K, left = M * K - first;
  const int count = static_cast<int>(left < BM * K ? left : BM * K);
  const T* src = A + first;
  // every 16-byte chunk of the run in flight at once, then widened into
  // shared memory; the run's last partial chunk, if any, element by element
  constexpr int kChunks = BM * kFlatK / V / kThreads;
  uint4 raw[kChunks];
#pragma unroll
  for (int h = 0; h < kChunks; ++h) {
    const int e = (tid + h * kThreads) * V;
    if (e + V <= count) raw[h] = *reinterpret_cast<const uint4*>(src + e);
  }
#pragma unroll
  for (int h = 0; h < kChunks; ++h) {
    const int e = (tid + h * kThreads) * V;
    if (e + V <= count) {
      widen16<T>(Af + e, raw[h]);
    } else {
      for (int j = 0; e + j < count; ++j) Af[e + j] = to_f32(src[e + j]);
    }
  }
  for (int e = tid; e < K * BN; e += kThreads) {
    const int k = e / BN, c = e % BN;
    Bs[k][c] = n0 + c < N ? to_f32(B[k * sbk + (n0 + c) * sbn]) : 0.0f;
  }
  __syncthreads();

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
  // rows past M hold whatever the buffer held: computed, never stored
  for (int k = 0; k < K; ++k) {
    const float4 x = *reinterpret_cast<const float4*>(&Bs[k][tx * 4]);
    const float bv[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float av = Af[(ty + 64 * i) * K + k];
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av, bv[j], acc[i][j]);
    }
  }
  int64_t row[4];
  int col[1] = {n0 + tx * 4};
#pragma unroll
  for (int i = 0; i < 4; ++i) row[i] = m0 + ty + 64 * i;
  epilogue<T, 4, 4>(acc, row, col, bias, C, M, N, act);
}

template <typename T, int BM, int BN, int SM, int SN>
void fma_launch(const void* a, const void* b, const float* bias, void* c,
                int64_t M, int N, int K, int64_t sam, int64_t sak,
                int64_t sbk, int64_t sbn, int a_kc, int a_vec, int b_kc,
                int b_vec, int act, cudaStream_t s) {
  const dim3 grid(static_cast<unsigned>((M + BM - 1) / BM), (N + BN - 1) / BN);
  fma_kernel<T, BM, BN, SM, SN><<<grid, kThreads, 0, s>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), bias,
      static_cast<T*>(c), M, N, K, sam, sak, sbk, sbn, a_kc, a_vec, b_kc,
      b_vec, act);
}

bool aligned(const void* p, int bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

template <typename T>
void fma_route(int tiles, const void* a, const void* b, const float* bias,
               void* c, int64_t M, int N, int K, int64_t sam, int64_t sak,
               int64_t sbk, int64_t sbn, int act, cudaStream_t s) {
  const int vb = 4 * static_cast<int>(sizeof(T));   // bytes of 4 elements
  if (tiles == 0 && sak == 1 && sam == K && K <= kFlatK && K % 4 != 0 &&
      aligned(a, 16)) {
    const dim3 grid(static_cast<unsigned>((M + 255) / 256), (N + 15) / 16);
    fma_flat_kernel<T><<<grid, kThreads, 256 * K * sizeof(float), s>>>(
        static_cast<const T*>(a), static_cast<const T*>(b), bias,
        static_cast<T*>(c), M, N, K, sbk, sbn, act);
    return;
  }
  // the mapping follows the unit stride; 4-element loads where the
  // extent along it and the other stride are multiples of 4 and the base
  // is aligned to 4 elements
  const int a_kc = sak == 1 || sam != 1;
  const int b_kc = !(sbn == 1 || sbk != 1);
  const int a_vec = a_kc ? (sak == 1 && sam % 4 == 0 && K % 4 == 0)
                         : (sam == 1 && sak % 4 == 0 && M % 4 == 0);
  const int b_vec = b_kc ? (sbk == 1 && sbn % 4 == 0 && K % 4 == 0)
                         : (sbn == 1 && sbk % 4 == 0 && N % 4 == 0);
  const int av = a_vec && aligned(a, vb), bv = b_vec && aligned(b, vb);
  if (tiles == 0)
    fma_launch<T, 256, 16, 1, 1>(a, b, bias, c, M, N, K, sam, sak, sbk, sbn,
                                 a_kc, av, b_kc, bv, act, s);
  else if (tiles == 3)
    fma_launch<T, 64, 64, 1, 1>(a, b, bias, c, M, N, K, sam, sak, sbk, sbn,
                                a_kc, av, b_kc, bv, act, s);
  else if (tiles == 1)
    fma_launch<T, 128, 64, 2, 1>(a, b, bias, c, M, N, K, sam, sak, sbk, sbn,
                                 a_kc, av, b_kc, bv, act, s);
  else
    fma_launch<T, 128, 128, 2, 2>(a, b, bias, c, M, N, K, sam, sak, sbk,
                                  sbn, a_kc, av, b_kc, bv, act, s);
}

// ===========================================================================
// the wgmma route (bf16)
// ===========================================================================
constexpr int kWgBM = 128, kWgBN = 128, kWgBK = 64;
constexpr int kStages = 4;
constexpr int kConsumers = 2;                      // warpgroups of wgmma
constexpr int kWgThreads = 128 * (kConsumers + 1); // + the producer's
constexpr int kTileBytes = kWgBM * kWgBK * 2;      // A's 16 KB; B's too
constexpr int kStageBytes = 2 * kTileBytes;
// the ring, 1 KB of slack to align it to the 128-byte swizzle's 1 KB
// period, and the stages' full and empty barriers
constexpr int kWgSmem = kStages * kStageBytes + 1024 + 2 * kStages * 8;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// spin until the phase of the given parity has completed; a phase that
// never completes (a lost arrival or transaction) traps after 10 s, so the
// launch fails instead of hanging the card
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint64_t start = 0;
  for (uint32_t n = 1;; ++n) {
    uint32_t done;
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (n % 1024 == 0) {
      uint64_t now;
      asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(now));
      if (start == 0) start = now;
      else if (now - start > 10000000000ull) __trap();
    }
  }
}

// a 2-D TMA load of the box at (c0 inner, c1 outer) into dst, completing
// on bar's transaction count
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         int c0, int c1, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

// a wgmma shared-memory descriptor for a 128-byte-swizzled tile: start
// address, leading and stride byte offsets (in 16-byte units), swizzle
// mode 1 (128 B)
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

// keeps the compiler from moving accumulator reads or writes across the
// asynchronous wgmma
__device__ __forceinline__ void fence_acc(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x 128, fp32) += A (64 x 16, K-major) B (16 x 128; K-major, or
// N-major when kTransB), both bf16 in shared memory
template <int kTransB>
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da,
                                                 uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, %67;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1), "n"(kTransB));
}

// Warpgroups 0 and 1 consume (rows 0-63 and 64-127 of the block's tile),
// warpgroup 2 produces. Stage s holds A's 128 x 64 box (K-major, 128-byte
// rows) and B's 64 x 128: K-major, 128 rows of 128 bytes (one box), or
// N-major, two 64-column boxes of 64 rows of 128 bytes, 8 KB apart.
template <int kTransB>
__global__ void __launch_bounds__(kWgThreads, 1)
wgmma_kernel(const __grid_constant__ CUtensorMap ta,
             const __grid_constant__ CUtensorMap tb,
             const float* __restrict__ bias, __nv_bfloat16* __restrict__ C,
             int M, int N, int K, int act) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t ring = (raw + 1023) & ~1023u;
  const uint32_t full = ring + kStages * kStageBytes;
  const uint32_t empty = full + kStages * 8;
  const int wg = threadIdx.x / 128;
  const int m0 = blockIdx.x * kWgBM, n0 = blockIdx.y * kWgBN;
  const int KT = (K + kWgBK - 1) / kWgBK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, kConsumers * 4);   // each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == kConsumers) {
    // ---- producer: one thread keeps the ring's TMA loads in flight ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == kConsumers * 128) {
      for (int kt = 0; kt < KT; ++kt) {
        const int s = kt % kStages;
        if (kt >= kStages)   // wait for the consumers to free the stage
          mbar_wait(empty + 8 * s, ((kt / kStages) - 1) & 1);
        const uint32_t sa = ring + s * kStageBytes, sb = sa + kTileBytes;
        const uint32_t bar = full + 8 * s;
        mbar_expect_tx(bar, kStageBytes);
        tma_load(sa, &ta, kt * kWgBK, m0, bar);
        if (kTransB) {
          tma_load(sb, &tb, n0, kt * kWgBK, bar);
          tma_load(sb + kTileBytes / 2, &tb, n0 + 64, kt * kWgBK, bar);
        } else {
          tma_load(sb, &tb, kt * kWgBK, n0, bar);
        }
      }
    }
  } else {
    // ---- consumers: wgmma on the stages as they arrive ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    float acc[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.0f;
    const int lane = threadIdx.x % 32;
    for (int kt = 0; kt < KT; ++kt) {
      const int s = kt % kStages;
      mbar_wait(full + 8 * s, (kt / kStages) & 1);
      const uint32_t sa = ring + s * kStageBytes + wg * (kTileBytes / 2);
      const uint32_t sb = ring + s * kStageBytes + kTileBytes;
      fence_acc(acc);
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int k = 0; k < kWgBK / 16; ++k) {
        // a K step of 16 is 32 bytes along a K-major 128-byte row, or 16
        // rows (2 KB) of an N-major box
        const uint64_t da = smem_desc(sa + 32 * k, 16, 1024);
        const uint64_t db = kTransB ? smem_desc(sb + 2048 * k, 8192, 1024)
                                    : smem_desc(sb + 32 * k, 16, 1024);
        wgmma_m64n128k16<kTransB>(acc, da, db);
      }
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      // the previous stage's products are done: free it
      asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
      fence_acc(acc);
      if (kt > 0 && lane == 0) mbar_arrive(empty + 8 * ((kt - 1) % kStages));
    }
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    fence_acc(acc);

    // acc[i] of thread (warp w, lane l) is row 16 w + l / 4 + 8 ((i / 2) % 2)
    // and column 8 (i / 4) + 2 (l % 4) + i % 2 of the warpgroup's 64 x 128
    const int w = (threadIdx.x % 128) / 32;
    const int r0 = m0 + wg * 64 + 16 * w + lane / 4;
    const bool pairs = N % 2 == 0;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int n = n0 + 8 * j + 2 * (lane % 4);
      if (n >= N) continue;
      const bool two = n + 1 < N;
      const float b0 = bias != nullptr ? bias[n] : 0.0f;
      const float b1 = bias != nullptr && two ? bias[n + 1] : 0.0f;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = r0 + 8 * h;
        if (r >= M) continue;
        const float x0 = activate(acc[4 * j + 2 * h] + b0, act);
        const float x1 = activate(acc[4 * j + 2 * h + 1] + b1, act);
        __nv_bfloat16* out = C + static_cast<int64_t>(r) * N + n;
        if (two && pairs) {
          *reinterpret_cast<__nv_bfloat162*>(out) =
              __floats2bfloat162_rn(x0, x1);
        } else {
          out[0] = __float2bfloat16_rn(x0);
          if (two) out[1] = __float2bfloat16_rn(x1);
        }
      }
    }
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// the driver's cuTensorMapEncodeTiled, without linking libcuda
EncodeTiled encoder() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                     cudaEnableDefault, &q);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                            &q);
#endif
    return q == cudaDriverEntryPointSuccess ? reinterpret_cast<EncodeTiled>(p)
                                            : nullptr;
  }();
  return fn;
}

// the map of a bf16 matrix with `inner` unit-stride elements a row, `outer`
// rows `stride` elements apart, read in (box_inner x box_outer) boxes with
// 128-byte swizzle; out-of-bounds elements read as zero
bool encode(EncodeTiled enc, CUtensorMap* map, const void* p, int64_t inner,
            int64_t outer, int64_t stride, uint32_t box_inner,
            uint32_t box_outer) {
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(inner),
                              static_cast<cuuint64_t>(outer)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(stride) * 2};
  const cuuint32_t box[2] = {box_inner, box_outer};
  const cuuint32_t unit[2] = {1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(p),
             dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int kTransB>
int wgmma_launch(const CUtensorMap& ta, const CUtensorMap& tb,
                 const float* bias, void* c, int M, int N, int K, int act,
                 cudaStream_t s) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      wgmma_kernel<kTransB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kWgSmem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid((M + kWgBM - 1) / kWgBM, (N + kWgBN - 1) / kWgBN);
  wgmma_kernel<kTransB><<<grid, kWgThreads, kWgSmem, s>>>(
      ta, tb, bias, static_cast<__nv_bfloat16*>(c), M, N, K, act);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The fma route. dtype: 0 = fp32, 1 = bf16, of A, B and C. `bias` may be
// null. Strides are in elements; C is contiguous. `tiles` picks the tile
// shape (0: 256 x 16, 1: 128 x 64, 2: 128 x 128, 3: 64 x 64). Returns
// cudaGetLastError() after the launch.
extern "C" int matmul_launch(const void* a, const void* b, const void* bias,
                             void* c, int64_t M, int N, int K, int64_t sam,
                             int64_t sak, int64_t sbk, int64_t sbn, int dtype,
                             int act, int tiles, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* bp = static_cast<const float*>(bias);
  if (M > 0 && N > 0) {
    if (dtype == 0)
      fma_route<float>(tiles, a, b, bp, c, M, N, K, sam, sak, sbk, sbn, act, s);
    else
      fma_route<__nv_bfloat16>(tiles, a, b, bp, c, M, N, K, sam, sak, sbk,
                               sbn, act, s);
  }
  return static_cast<int>(cudaGetLastError());
}

// The wgmma route: bf16 A (M, K) with unit stride along K and row stride
// sam, B (K, N) with sbk == 1 (K-major) or sbn == 1 (N-major) and the
// other stride a multiple of 8, 16-byte aligned bases (the wrapper's
// route() sees to all of it; anything else is refused). Builds the two
// tensor maps and launches. Returns cudaGetLastError() after the launch,
// or the error that kept it from launching.
extern "C" int matmul_wgmma_launch(const void* a, const void* b,
                                   const void* bias, void* c, int M, int N,
                                   int K, int64_t sam, int64_t sbk,
                                   int64_t sbn, int act, void* stream) {
  if (M <= 0 || N <= 0) return 0;
  const bool trans_b = sbn == 1;
  if (K <= 0 || sam % 8 != 0 || (trans_b ? sbk % 8 != 0
                                         : (sbk != 1 || sbn % 8 != 0)) ||
      reinterpret_cast<uintptr_t>(a) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(b) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return static_cast<int>(cudaErrorNotSupported);
  CUtensorMap ta, tb;
  if (!encode(enc, &ta, a, K, M, sam, kWgBK, kWgBM) ||
      !(trans_b ? encode(enc, &tb, b, N, K, sbk, 64, kWgBK)
                : encode(enc, &tb, b, K, N, sbn, kWgBK, kWgBN)))
    return static_cast<int>(cudaErrorInvalidValue);
  const float* bp = static_cast<const float*>(bias);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return trans_b ? wgmma_launch<1>(ta, tb, bp, c, M, N, K, act, s)
                 : wgmma_launch<0>(ta, tb, bp, c, M, N, K, act, s);
}
