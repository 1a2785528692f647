// diffusion2d, jacobi3d and diffusion3d: the star stencils of the paper's
// Fig. 19 over fp32 fields with a constant-0 boundary.
//
//   diffusion2d  out = c0 a[i,j] + c1 a[i-1,j] + c2 a[i+1,j]
//                      + c3 a[i,j-1] + c4 a[i,j+1]            over (H, W)
//   jacobi3d     out = (1/7) (a[d,h,w] + its 6 neighbours)    over (D, H, W)
//   diffusion3d  out = a[d,h,w] + alpha (sum of the 6 neighbours
//                      - 6 a[d,h,w])                          over (D, H, W)
//
// Replaces the TPU kernels repro/kernels/stencil/kernel.py::diffusion2d,
// ::jacobi3d and ::diffusion3d. Those read a jnp.pad-ed copy of the field
// (another field's worth of bytes) in slabs whose height must divide the
// slowest axis (_pick_tile), one (bh+2, W+2) or (bd+2, H+2, W+2) slab a grid
// step. Here nothing is padded or copied: every load is predicated, a
// position outside the field reads 0, and ragged edges are masked, so any
// H, W and D >= 1 take full tiles.
//
//   * diffusion2d: a 32 x 8 thread block owns a kTileH x kTileW output tile
//     and loads the (kTileH+2) x (kTileW+2) slab into shared memory with
//     2-D loops over threadIdx.y / threadIdx.x; the five coefficients come
//     by value. No tap table and no integer division per element (what
//     cost stencil2d two thirds of its bound, csrc/stencil.cu).
//   * jacobi3d and diffusion3d: one templated 2.5-D kernel. A block owns a
//     k3TY x k3TX tile of (H, W) and marches along D over a chunk of k3BD
//     planes. Each thread keeps its column's planes d-1, d and d+1 in
//     registers; the current plane, with a 1-element H/W halo, sits in
//     shared memory for the four in-plane neighbours. A chunk's first and
//     last planes read their neighbour from the next chunk (or 0 at the
//     field's edge), so chunks are independent and run in any order.
//
// Every sum runs in the reference's order (stencil/kernel.py:157-159,
// 189-192, 220-224) with __fmul_rn/__fadd_rn, so no multiply-add is
// contracted and each output is the plain version's fp32 arithmetic.
// Offsets are int64; no atomics.
//
// Bound on the H100 by bytes: the field is read once and the result written
// once, 8 B a point (4.3 GB at the paper's 2^17 x 4,096 and 2^15 x 128 x 128
// domains, about 1.28 ms at 3.35 TB/s), against at most 13 flops a point;
// the halo re-reads mostly hit L2. TMA and vector loads are later work.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// diffusion2d: block of k2TX x k2TY threads, output tile kTileH x kTileW
constexpr int k2TX = 32;
constexpr int k2TY = 8;
constexpr int kTileH = 32;
constexpr int kTileW = 128;

// jacobi3d / diffusion3d: block of k3TX x k3TY threads, one output column
// each, marching over k3BD planes of D
constexpr int k3TX = 32;
constexpr int k3TY = 8;
constexpr int k3BD = 64;
constexpr int kHalo3 = 2 * k3TX + 2 * k3TY;

constexpr int64_t kMaxBlocks = 2147483647;

__global__ void __launch_bounds__(k2TX * k2TY)
diffusion2d_kernel(const float* __restrict__ a, float* __restrict__ out,
                   int64_t H, int64_t W, int64_t tiles_w, float c0, float c1,
                   float c2, float c3, float c4) {
  __shared__ float slab[kTileH + 2][kTileW + 2];
  const int64_t tile = blockIdx.x;
  const int64_t i0 = (tile / tiles_w) * kTileH;
  const int64_t j0 = (tile % tiles_w) * kTileW;
  // slab[u][v] holds field (i0 - 1 + u, j0 - 1 + v), 0 outside the field
  for (int u = threadIdx.y; u < kTileH + 2; u += k2TY) {
    const int64_t gi = i0 - 1 + u;
    const bool row_in = gi >= 0 && gi < H;
    for (int v = threadIdx.x; v < kTileW + 2; v += k2TX) {
      const int64_t gj = j0 - 1 + v;
      slab[u][v] = (row_in && gj >= 0 && gj < W) ? a[gi * W + gj] : 0.0f;
    }
  }
  __syncthreads();
  for (int u = threadIdx.y; u < kTileH && i0 + u < H; u += k2TY) {
    const int64_t row = (i0 + u) * W;
    for (int v = threadIdx.x; v < kTileW && j0 + v < W; v += k2TX) {
      const int su = u + 1, sv = v + 1;
      float acc = __fmul_rn(c0, slab[su][sv]);
      acc = __fadd_rn(acc, __fmul_rn(c1, slab[su - 1][sv]));
      acc = __fadd_rn(acc, __fmul_rn(c2, slab[su + 1][sv]));
      acc = __fadd_rn(acc, __fmul_rn(c3, slab[su][sv - 1]));
      acc = __fadd_rn(acc, __fmul_rn(c4, slab[su][sv + 1]));
      out[row + j0 + v] = acc;
    }
  }
}

template <bool kDiffusion>
__global__ void __launch_bounds__(k3TX * k3TY)
star3d_kernel(const float* __restrict__ a, float* __restrict__ out, int64_t D,
              int64_t H, int64_t W, int64_t tiles_w, int64_t tiles_h,
              float alpha) {
  __shared__ float plane[k3TY + 2][k3TX + 2];
  const int64_t b = blockIdx.x;
  const int64_t h0 = ((b / tiles_w) % tiles_h) * k3TY;
  const int64_t w0 = (b % tiles_w) * k3TX;
  const int64_t d0 = (b / (tiles_w * tiles_h)) * k3BD;
  const int64_t d1 = d0 + k3BD < D ? d0 + k3BD : D;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int64_t h = h0 + ty, w = w0 + tx;
  const bool inside = h < H && w < W;
  const int64_t ps = H * W;        // elements of one plane
  const int64_t col = h * W + w;   // this thread's column within a plane

  // the halo cell this thread loads into plane[hu][hv] each step, if any:
  // the rows above and below the tile, then its left and right columns
  const int t = ty * k3TX + tx;
  int hu = 0, hv = 0;
  int64_t hh = -1, hw = -1;
  if (t < k3TX) {
    hu = 0;
    hv = t + 1;
    hh = h0 - 1;
    hw = w0 + t;
  } else if (t < 2 * k3TX) {
    hu = k3TY + 1;
    hv = t - k3TX + 1;
    hh = h0 + k3TY;
    hw = w0 + t - k3TX;
  } else if (t < 2 * k3TX + k3TY) {
    hu = t - 2 * k3TX + 1;
    hv = 0;
    hh = h0 + t - 2 * k3TX;
    hw = w0 - 1;
  } else if (t < kHalo3) {
    hu = t - 2 * k3TX - k3TY + 1;
    hv = k3TX + 1;
    hh = h0 + t - 2 * k3TX - k3TY;
    hw = w0 + k3TX;
  }
  const bool has_halo = t < kHalo3;
  const bool halo_in = has_halo && hh >= 0 && hh < H && hw >= 0 && hw < W;
  const int64_t halo_col = hh * W + hw;

  float prev = (inside && d0 > 0) ? a[(d0 - 1) * ps + col] : 0.0f;
  float cur = inside ? a[d0 * ps + col] : 0.0f;
  for (int64_t d = d0; d < d1; ++d) {
    const float next = (inside && d + 1 < D) ? a[(d + 1) * ps + col] : 0.0f;
    const float halo = halo_in ? a[d * ps + halo_col] : 0.0f;
    __syncthreads();  // every thread has read the previous plane
    plane[ty + 1][tx + 1] = cur;
    if (has_halo) plane[hu][hv] = halo;
    __syncthreads();
    if (inside) {
      const float hm = plane[ty][tx + 1], hp = plane[ty + 2][tx + 1];
      const float wm = plane[ty + 1][tx], wp = plane[ty + 1][tx + 2];
      float r;
      if (kDiffusion) {
        float lap = __fadd_rn(prev, next);
        lap = __fadd_rn(lap, hm);
        lap = __fadd_rn(lap, hp);
        lap = __fadd_rn(lap, wm);
        lap = __fadd_rn(lap, wp);
        lap = __fsub_rn(lap, __fmul_rn(6.0f, cur));
        r = __fadd_rn(cur, __fmul_rn(alpha, lap));
      } else {
        float s = __fadd_rn(cur, prev);
        s = __fadd_rn(s, next);
        s = __fadd_rn(s, hm);
        s = __fadd_rn(s, hp);
        s = __fadd_rn(s, wm);
        s = __fadd_rn(s, wp);
        r = __fmul_rn(static_cast<float>(1.0 / 7.0), s);
      }
      out[d * ps + col] = r;
    }
    prev = cur;
    cur = next;
  }
}

}  // namespace

// An (H, W) fp32 field, contiguous. Returns cudaGetLastError() after the
// launch (cudaErrorInvalidConfiguration for a grid over 2^31 - 1 blocks).
extern "C" int diffusion2d_launch(const float* a, float* out, int64_t H,
                                  int64_t W, float c0, float c1, float c2,
                                  float c3, float c4, void* stream) {
  if (H <= 0 || W <= 0) return 0;
  const int64_t tiles_w = (W + kTileW - 1) / kTileW;
  const int64_t blocks = ((H + kTileH - 1) / kTileH) * tiles_w;
  if (blocks > kMaxBlocks) return static_cast<int>(cudaErrorInvalidConfiguration);
  diffusion2d_kernel<<<static_cast<unsigned>(blocks), dim3(k2TX, k2TY), 0,
                       static_cast<cudaStream_t>(stream)>>>(
      a, out, H, W, tiles_w, c0, c1, c2, c3, c4);
  return static_cast<int>(cudaGetLastError());
}

// A (D, H, W) fp32 field, contiguous; `diffusion` nonzero for diffusion3d
// (alpha used), zero for jacobi3d.
extern "C" int star3d_launch(const float* a, float* out, int64_t D, int64_t H,
                             int64_t W, int diffusion, float alpha,
                             void* stream) {
  if (D <= 0 || H <= 0 || W <= 0) return 0;
  const int64_t tiles_w = (W + k3TX - 1) / k3TX;
  const int64_t tiles_h = (H + k3TY - 1) / k3TY;
  const int64_t blocks = tiles_w * tiles_h * ((D + k3BD - 1) / k3BD);
  if (blocks > kMaxBlocks) return static_cast<int>(cudaErrorInvalidConfiguration);
  const dim3 grid(static_cast<unsigned>(blocks)), block(k3TX, k3TY);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (diffusion) {
    star3d_kernel<true><<<grid, block, 0, s>>>(a, out, D, H, W, tiles_w,
                                               tiles_h, alpha);
  } else {
    star3d_kernel<false><<<grid, block, 0, s>>>(a, out, D, H, W, tiles_w,
                                                tiles_h, alpha);
  }
  return static_cast<int>(cudaGetLastError());
}
