// stencil2d and stencil2d_chain: out[p] = sum_k c_k * a[p + off_k] over an
// (H, W) fp32 field with a constant-0 boundary, one stage or a chain of up
// to kMaxStages stages fused into one kernel.
//
// Replaces the TPU kernels repro/kernels/stencil/kernel.py::stencil2d and
// ::stencil2d_chain. Those read a jnp.pad-ed copy of the field (another
// field's worth of bytes; 2 GiB at the paper's 131,072 x 4,096 domain) in
// row slabs whose height must divide H, and take their offsets as static
// arguments. Here nothing is padded or copied, any H and W take full
// tiles, and the offsets travel as a tap table passed by value (TapTable,
// at most kMaxTaps taps in all, concatenated in stage order as the
// reference concatenates its coefficients) beside the coefficients'
// device vector of the same order.
//
// Bound on the H100 by bytes: the field is read once and the result
// written once (8 B a point in fp32; 4.3 GB at the paper's domain, about
// 1.28 ms at 3.35 TB/s), whatever the number of stages. The design:
//   * Persistent blocks of 32 x 8 threads walk the tiles in row-major order
//     (adjacent blocks on adjacent tiles, so the halo re-reads hit L2).
//     A block owns a th x tw output tile (Geometry, from the wrapper's
//     plan) and holds the halo'd slab of a tile in shared memory: rows
//     [i0 - y0, i0 - y0 + rows), columns [j0 - x0, j0 - x0 + pitch) of the
//     field, y0 = R (the summed radius), x0 = R rounded up to 4.
//   * Two slabs: the next tile's loads run while this tile computes (a
//     halo too wide for two slabs at the smallest tile takes one, loaded
//     after the tile's stages). Two load routes of the same kernel, chosen
//     by the shape:
//     kTma (W a multiple of 4 floats, 16-byte aligned base): one 2-D TMA
//     box load (cp.async.bulk.tensor.2d, completing on an mbarrier), whose
//     out-of-bounds zero fill is the constant-0 boundary, box coordinates
//     negative at the field's edges; otherwise 4-byte cp.async copies with
//     a zero fill (src-size 0) outside the field, by 2-D loops over the
//     thread block (no division).
//   * Each thread computes a strip of 8 rows x 4 columns of a stage's
//     outputs in registers. A stage of radius r <= 2 whose offsets are
//     distinct takes a dense (2r+1)^2 weight window in registers and a
//     fully unrolled loop: each slab row is read once a strip as three
//     16-byte shared-memory loads (conflict-free: strips start on a
//     16-byte column) and feeds every output row it reaches. The window
//     skips the positions no tap names (a block-uniform bit mask), so a
//     non-finite value there does not reach the output, as in the plain
//     version. Other stages loop over their taps (offsets from the
//     table in the param bank, coefficients by __ldg). No integer
//     division on the hot path: one a block for its first tile.
//   * A chain's stages run on the slab in shared memory: stage s computes
//     the tile plus the halo the later stages read, writing a work buffer
//     (the slab and the work buffer alternate), every position outside the
//     field set to 0 (the reference's inter-stage mask, which is the next
//     stage's constant-0 boundary). Intermediates never reach device
//     memory. The last stage stores to the field, 16 bytes a row of a
//     strip on the kTma route, with ragged edges masked.
//   * Every output is its taps' fp32 fused multiply-adds in a fixed order
//     (raster order of the dense window, table order otherwise), written
//     by one thread, so two runs give the same bytes.
//
// Shared memory a block: 256 B (alignment and the two mbarriers) plus, for
// each buffer (n_slabs slabs, and a work buffer for a chain), a 128-byte
// guard and pitch x (rows + 8) floats rounded up to 32 floats; pitch =
// x0 + tw + R + 3 rounded up to 4, rows = th + 2R. At the paper's
// domain and diffusion taps: one stage, tile 64 x 128, pitch 136, rows 66:
// 81,152 B; the two-stage chain, tile 60 x 120, pitch 132, rows 64:
// 114,688 B. Two blocks an SM either way (kernel.py's plan keeps a chain's
// block within TWO_BLOCKS where half the grid's rows allow). One slab
// takes a single stage's halo up to 112 and a chain's summed halo up to
// 76 (230,784 and 226,304 B at the smallest tile, 4 x 16).
#include <cuda.h>   // CUtensorMap and its enums; the encoder is reached
                    // through the runtime (no -lcuda)
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTX = 32;          // threads along a row: 4 columns each
constexpr int kTY = 8;           // threads along the columns: kRS rows each
constexpr int kThreads = kTX * kTY;
constexpr int kRS = 8;           // rows of a thread's strip
constexpr int kMaxTaps = 128;
constexpr int kMaxStages = 6;
constexpr int kDense = 25;       // the 5 x 5 window of a radius-2 stage
constexpr int kGuard = 32;       // floats before each buffer

}  // namespace

// The offsets of every tap, stage after stage; the layout ctypes mirrors.
// kind[s]: 1 + r for a dense stage of radius r <= 2 (dense[s][(di + r)
// (2r + 1) + dj + r] is the tap at (di, dj), or -1), 0 for a tap loop.
struct TapTable {
  int n_stages;
  int stage_end[kMaxStages];  // taps [stage_end[s-1], stage_end[s]) are stage s's
  int radius[kMaxStages];
  int kind[kMaxStages];
  int di[kMaxTaps];
  int dj[kMaxTaps];
  int dense[kMaxStages][kDense];
};

// The block's tile and slab, from the wrapper's plan (kernel.py).
struct Geometry {
  int th, tw;          // output tile
  int x0, y0;          // slab column / row of the tile's first point
  int pitch, rows;     // floats a slab row, rows loaded
  int buf_floats;      // floats a buffer (slack rows included)
  int n_slabs;         // 2 (the next tile's in flight) or 1
  int64_t tiles_h, tiles_w;
};

namespace {

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

// spin until the phase of the given parity has completed; a phase that
// never completes traps after 10 s, so the launch fails instead of hanging
// the card
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

__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         int c0, int c1, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

// 4 bytes from src, or 0 when `bytes` is 0 (src is then not read)
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

// The halo'd slab of tile (ti, tj) into `dst`: kTma, one thread starts the
// box; else every thread copies its part and commits a group.
template <bool kTma>
__device__ __forceinline__ void load_slab(const CUtensorMap* map,
                                          const float* __restrict__ a,
                                          int64_t H, int64_t W,
                                          const Geometry& g, int64_t ti,
                                          int64_t tj, float* dst,
                                          uint32_t bar) {
  const int64_t r0 = ti * g.th - g.y0, c0 = tj * g.tw - g.x0;
  if (kTma) {
    if (threadIdx.x == 0 && threadIdx.y == 0) {
      // the buffer was last read (and, in a chain, written) by the
      // generic proxy: order those accesses before the async copy
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      mbar_expect_tx(bar, static_cast<uint32_t>(g.pitch * g.rows * 4));
      tma_load(smem_u32(dst), map, static_cast<int>(c0),
               static_cast<int>(r0), bar);
    }
  } else {
    for (int u = threadIdx.y; u < g.rows; u += kTY) {
      const int64_t gi = r0 + u;
      const bool row_in = gi >= 0 && gi < H;
      const float* src = a + (row_in ? gi : 0) * W;
      float* d = dst + u * g.pitch;
      for (int v = threadIdx.x; v < g.pitch; v += kTX) {
        const int64_t gj = c0 + v;
        const bool in = row_in && gj >= 0 && gj < W;
        cp_async4(d + v, in ? src + gj : a, in ? 4 : 0);
      }
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  }
}

// The strip's outputs of a dense stage of radius r: acc[i][c] is the
// output at slab (u0 + i, c0 + c); w is the (2r+1)^2 window, raster order,
// and the positions whose bit in `named` is clear are skipped.
template <int r>
__device__ __forceinline__ void dense_strip(const float* src, int pitch,
                                            int u0, int c0, const float* w,
                                            uint32_t named,
                                            float (&acc)[kRS][4]) {
  constexpr int n = 2 * r + 1;
#pragma unroll
  for (int i = 0; i < kRS; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[i][c] = 0.0f;
#pragma unroll
  for (int s = 0; s < kRS + 2 * r; ++s) {
    // columns c0 - 4 .. c0 + 7 of slab row u0 - r + s
    const float* row = src + (u0 - r + s) * pitch + c0;
    float x[12];
    const float4 mid = *reinterpret_cast<const float4*>(row);
    x[4] = mid.x, x[5] = mid.y, x[6] = mid.z, x[7] = mid.w;
    if (r > 0) {
      const float4 lo = *reinterpret_cast<const float4*>(row - 4);
      const float4 hi = *reinterpret_cast<const float4*>(row + 4);
      x[0] = lo.x, x[1] = lo.y, x[2] = lo.z, x[3] = lo.w;
      x[8] = hi.x, x[9] = hi.y, x[10] = hi.z, x[11] = hi.w;
    }
#pragma unroll
    for (int i = 0; i < kRS; ++i) {
      const int di = s - i;
      if (di < 0 || di >= n) continue;
#pragma unroll
      for (int dj = 0; dj < n; ++dj) {
        if (!((named >> (di * n + dj)) & 1u)) continue;
#pragma unroll
        for (int c = 0; c < 4; ++c)
          acc[i][c] = fmaf(w[di * n + dj], x[4 - r + c + dj], acc[i][c]);
      }
    }
  }
}

// The strip's outputs of a stage as a loop over its taps [k0, k1).
__device__ __forceinline__ void tap_strip(const float* src, int pitch, int u0,
                                          int c0, const float* __restrict__ co,
                                          const TapTable& t, int k0, int k1,
                                          float (&acc)[kRS][4]) {
#pragma unroll
  for (int i = 0; i < kRS; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[i][c] = 0.0f;
  for (int k = k0; k < k1; ++k) {
    const float ck = __ldg(co + k);
    const float* p = src + (u0 + t.di[k]) * pitch + c0 + t.dj[k];
#pragma unroll
    for (int i = 0; i < kRS; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        acc[i][c] = fmaf(ck, p[i * pitch + c], acc[i][c]);
  }
}

// Stage s of tile (i0, j0): its outputs at slab rows [y0 - h, y0 + th + h)
// and columns from x0 - h rounded down to 4 (h the halo the later stages
// read), from `src` into `dst` (masked to the field) or, for the last
// stage, into `out`.
template <bool kVec, int kKind>
__device__ __forceinline__ void run_stage(
    const float* src, float* dst, float* __restrict__ out,
    const float* __restrict__ co, const TapTable& t, const Geometry& g,
    int s, int k0, int h, bool last, int64_t i0, int64_t j0, int64_t H,
    int64_t W) {
  constexpr int r = kKind > 0 ? kKind - 1 : 0;
  float w[(2 * r + 1) * (2 * r + 1)];
  uint32_t named = 0;
  if (kKind > 0) {
#pragma unroll
    for (int p = 0; p < (2 * r + 1) * (2 * r + 1); ++p) {
      const int k = t.dense[s][p];
      w[p] = k >= 0 ? __ldg(co + k) : 0.0f;
      named |= static_cast<uint32_t>(k >= 0) << p;
    }
  }
  const int h4 = (h + 3) & ~3;
  const int ur = g.y0 - h, cr = g.x0 - h4;
  const int nsy = (g.th + 2 * h + kRS - 1) / kRS;
  const int nsx = (g.tw + h + h4 + 3) / 4;
  for (int sy = threadIdx.y; sy < nsy; sy += kTY) {
    const int u0 = ur + sy * kRS;
    for (int sx = threadIdx.x; sx < nsx; sx += kTX) {
      const int c0 = cr + 4 * sx;
      float acc[kRS][4];
      if (kKind > 0)
        dense_strip<r>(src, g.pitch, u0, c0, w, named, acc);
      else
        tap_strip(src, g.pitch, u0, c0, co, t, k0, t.stage_end[s], acc);
      // field coordinates of the strip's first output
      const int64_t gi0 = i0 - g.y0 + u0, gj0 = j0 - g.x0 + c0;
      if (last) {
        const int lc = c0 - g.x0;   // 4 sx: the last stage has h = 0
#pragma unroll
        for (int i = 0; i < kRS; ++i) {
          const int64_t gi = gi0 + i;
          if (u0 - g.y0 + i >= g.th || gi >= H) continue;
          float* o = out + gi * W + gj0;
          if (kVec && lc + 3 < g.tw && gj0 + 3 < W) {
            *reinterpret_cast<float4*>(o) =
                make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
          } else {
#pragma unroll
            for (int c = 0; c < 4; ++c)
              if (lc + c < g.tw && gj0 + c < W) o[c] = acc[i][c];
          }
        }
      } else {
        bool col_in[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) col_in[c] = gj0 + c >= 0 && gj0 + c < W;
#pragma unroll
        for (int i = 0; i < kRS; ++i) {
          const int64_t gi = gi0 + i;
          const bool row_in = gi >= 0 && gi < H;
          float v[4];
#pragma unroll
          for (int c = 0; c < 4; ++c)
            v[c] = row_in && col_in[c] ? acc[i][c] : 0.0f;
          *reinterpret_cast<float4*>(dst + (u0 + i) * g.pitch + c0) =
              make_float4(v[0], v[1], v[2], v[3]);
        }
      }
    }
  }
}

template <bool kTma>
__global__ void __launch_bounds__(kThreads)
stencil_chain_kernel(const __grid_constant__ CUtensorMap map,
                     const float* __restrict__ a,
                     const float* __restrict__ coeffs,
                     float* __restrict__ out, int64_t H, int64_t W,
                     const Geometry g, const TapTable t) {
  extern __shared__ uint8_t smem_raw[];
  const bool two = g.n_slabs == 2;
  const uint32_t raw = smem_u32(smem_raw);
  uint8_t* base = smem_raw + (((raw + 127) & ~127u) - raw);
  const uint32_t bars = smem_u32(base);   // two mbarriers
  // buffer b (the slabs, then the work buffer) at slab0 + b * stride
  float* const slab0 = reinterpret_cast<float*>(base + 128) + kGuard;
  const int stride = kGuard + g.buf_floats;

  int R = 0;
  for (int s = 0; s < t.n_stages; ++s) R += t.radius[s];
  // this block's first tile, and the step to its next one, without a
  // division in the loop
  const int64_t G = gridDim.x;
  int64_t ti = blockIdx.x / g.tiles_w, tj = blockIdx.x % g.tiles_w;
  const int64_t dq = G / g.tiles_w, dr = G % g.tiles_w;

  if (kTma && threadIdx.x == 0 && threadIdx.y == 0) {
    mbar_init(bars, 1);
    mbar_init(bars + 8, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (ti < g.tiles_h)
    load_slab<kTma>(&map, a, H, W, g, ti, tj, slab0, bars);
  for (int k = 0; ti < g.tiles_h; ++k) {
    const int b = two ? k & 1 : 0;
    int64_t ni = ti + dq, nj = tj + dr;
    if (nj >= g.tiles_w) {
      nj -= g.tiles_w;
      ++ni;
    }
    const bool more = ni < g.tiles_h;
    if (more && two)
      load_slab<kTma>(&map, a, H, W, g, ni, nj, slab0 + (b ^ 1) * stride,
                      bars + 8 * (b ^ 1));
    if (kTma) {
      mbar_wait(bars + 8 * b, two ? (k >> 1) & 1 : k & 1);
    } else {
      if (more && two) asm volatile("cp.async.wait_group 1;\n" ::: "memory");
      else asm volatile("cp.async.wait_group 0;\n" ::: "memory");
      __syncthreads();
    }
    const int64_t i0 = ti * g.th, j0 = tj * g.tw;
    float* src = slab0 + b * stride;
    float* dst = slab0 + g.n_slabs * stride;
    int h = R, k0 = 0;
    for (int s = 0; s < t.n_stages; ++s) {
      h -= t.radius[s];
      const bool last = s == t.n_stages - 1;
      switch (t.kind[s]) {
        case 1:
          run_stage<kTma, 1>(src, dst, out, coeffs, t, g, s, k0, h, last, i0,
                             j0, H, W);
          break;
        case 2:
          run_stage<kTma, 2>(src, dst, out, coeffs, t, g, s, k0, h, last, i0,
                             j0, H, W);
          break;
        case 3:
          run_stage<kTma, 3>(src, dst, out, coeffs, t, g, s, k0, h, last, i0,
                             j0, H, W);
          break;
        default:
          run_stage<kTma, 0>(src, dst, out, coeffs, t, g, s, k0, h, last, i0,
                             j0, H, W);
      }
      __syncthreads();
      float* tmp = src;
      src = dst;
      dst = tmp;
      k0 = t.stage_end[s];
    }
    // one slab: the next tile's loads once every stage has read this one
    if (more && !two) load_slab<kTma>(&map, a, H, W, g, ni, nj, slab0, bars);
    ti = ni;
    tj = nj;
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, through the runtime's entry-point query, without
// linking libcuda
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

template <bool kTma>
int launch(const CUtensorMap& map, const float* a, const float* coeffs,
           float* out, int64_t H, int64_t W, const Geometry& g,
           const TapTable& table, int smem_bytes, cudaStream_t s) {
  auto kernel = stencil_chain_kernel<kTma>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  int device = 0, sms = 0, per_sm = 0;
  err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kThreads, smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int64_t tiles = g.tiles_h * g.tiles_w;
  const int64_t blocks = tiles < int64_t(per_sm) * sms
                             ? tiles : int64_t(per_sm) * sms;
  kernel<<<static_cast<unsigned>(blocks), dim3(kTX, kTY), smem_bytes, s>>>(
      map, a, coeffs, out, H, W, g, table);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// `coeffs` holds the taps' coefficients in table order (fp32, on the
// device); `g` and `smem_bytes` are the wrapper's plan for the table;
// `tma` nonzero takes the TMA route (W a multiple of 4, `a` 16-byte
// aligned), else the cp.async route. Returns cudaGetLastError() after the
// launch, or the error that stopped it.
extern "C" int stencil_launch(const float* a, const float* coeffs,
                              float* out, int64_t H, int64_t W, Geometry g,
                              TapTable table, int smem_bytes, int tma,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (H <= 0 || W <= 0) return 0;
  CUtensorMap map = {};
  if (!tma)
    return launch<false>(map, a, coeffs, out, H, W, g, table, smem_bytes, s);
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(W),
                              static_cast<cuuint64_t>(H)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(W) * 4};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(g.pitch),
                             static_cast<cuuint32_t>(g.rows)};
  const cuuint32_t unit[2] = {1, 1};
  if (enc(&map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<float*>(a),
          dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
          CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
          CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return static_cast<int>(cudaErrorInvalidValue);
  return launch<true>(map, a, coeffs, out, H, W, g, table, smem_bytes, s);
}
