// stencil2d and stencil2d_chain: out[p] = sum_k c_k * a[p + off_k] over an
// (H, W) fp32 field with a constant-0 boundary, one stage or a chain of up
// to kMaxStages stages fused into one kernel.
//
// Replaces the TPU kernels repro/kernels/stencil/kernel.py::stencil2d and
// ::stencil2d_chain. Those read a jnp.pad-ed copy of the field (another
// field's worth of bytes; 2 GiB at the paper's 131,072 x 4,096 domain) in
// row slabs whose height must divide H (_pick_tile's divisor search turns
// a prime H into 1-row tiles), and take their offsets as static arguments.
// Here:
//   * each block owns a 2-D output tile (th x tw, chosen by the wrapper)
//     and loads the tile plus a halo of R = sum of the stages' radii into
//     shared memory with predicated loads: positions outside the field
//     read as 0, so nothing is padded or copied, and ragged edges are
//     masked, so any H and W take full tiles;
//   * the sources are compiled ahead of time, so the offsets travel as a
//     tap table passed by value (TapTable, at most kMaxTaps taps in all,
//     concatenated in stage order as the reference concatenates its
//     coefficients) and the coefficients as a device vector of the same
//     order; neither is baked into the code;
//   * every stage of a chain runs on the block's slab in shared memory,
//     its halo shrinking by the stage's radius; intermediates never touch
//     device memory. Before the next stage, every position outside the
//     global field is set to 0 (the reference's inter-stage mask), which
//     is that stage's constant-0 boundary.
// Bound on the H100 by bytes: the field is read once and the result
// written once (8 B a point in fp32; 4.3 GB at the paper's domain, about
// 1.28 ms at 3.35 TB/s), whatever the number of stages; the halo re-reads
// mostly hit L2.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxTaps = 128;
constexpr int kMaxStages = 6;

}  // namespace

// The offsets of every tap, stage after stage; the layout ctypes mirrors.
struct TapTable {
  int n_stages;
  int stage_end[kMaxStages];  // taps [stage_end[s-1], stage_end[s]) are stage s's
  int radius[kMaxStages];
  int di[kMaxTaps];
  int dj[kMaxTaps];
};

namespace {

__global__ void __launch_bounds__(kThreads)
stencil_chain_kernel(const float* __restrict__ a,
                     const float* __restrict__ coeffs,
                     float* __restrict__ out, int64_t H, int64_t W, int th,
                     int tw, const TapTable t) {
  extern __shared__ float smem[];
  int R = 0;
  for (int s = 0; s < t.n_stages; ++s) R += t.radius[s];
  const int SH = th + 2 * R, SW = tw + 2 * R;
  float* c = smem;                                   // kMaxTaps coefficients
  int* doff = reinterpret_cast<int*>(smem + kMaxTaps);  // kMaxTaps offsets
  float* buf[2] = {smem + 2 * kMaxTaps, smem + 2 * kMaxTaps + SH * SW};
  const int ntaps = t.stage_end[t.n_stages - 1];
  for (int k = threadIdx.x; k < ntaps; k += kThreads) {
    c[k] = coeffs[k];
    doff[k] = t.di[k] * SW + t.dj[k];
  }
  // slab coordinate (u, v) is global (i0 - R + u, j0 - R + v)
  const int64_t i0 = static_cast<int64_t>(blockIdx.x) * th;
  const int64_t j0 = static_cast<int64_t>(blockIdx.y) * tw;
  for (int e = threadIdx.x; e < SH * SW; e += kThreads) {
    const int u = e / SW, v = e % SW;
    const int64_t gi = i0 - R + u, gj = j0 - R + v;
    buf[0][e] = (gi >= 0 && gi < H && gj >= 0 && gj < W) ? a[gi * W + gj]
                                                         : 0.0f;
  }
  __syncthreads();

  int h = R, k0 = 0, cur = 0;
  for (int s = 0; s < t.n_stages; ++s) {
    const int hn = h - t.radius[s], k1 = t.stage_end[s];
    const bool last = s == t.n_stages - 1;
    // this stage's outputs: the tile plus the halo the later stages read
    const int RU = th + 2 * hn, RV = tw + 2 * hn, first = R - hn;
    const float* src = buf[cur];
    float* dst = buf[cur ^ 1];
    for (int e = threadIdx.x; e < RU * RV; e += kThreads) {
      const int u = first + e / RV, v = first + e % RV;
      const int64_t gi = i0 - R + u, gj = j0 - R + v;
      const bool inside = gi >= 0 && gi < H && gj >= 0 && gj < W;
      float acc = 0.0f;
      if (inside) {
        const int base = u * SW + v;
        for (int k = k0; k < k1; ++k) acc += c[k] * src[base + doff[k]];
      }
      if (last) {
        if (inside) out[gi * W + gj] = acc;
      } else {
        dst[u * SW + v] = acc;  // 0 outside the field: the next boundary
      }
    }
    __syncthreads();
    cur ^= 1;
    h = hn;
    k0 = k1;
  }
}

}  // namespace

// `coeffs` holds the taps' coefficients in table order (fp32, on the
// device); `smem_bytes` is what the wrapper computed for (th, tw) and the
// table. Returns cudaGetLastError() after the launch.
extern "C" int stencil_launch(const float* a, const float* coeffs,
                              float* out, int64_t H, int64_t W, int th,
                              int tw, TapTable table, int smem_bytes,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (H <= 0 || W <= 0) return 0;
  cudaError_t err = cudaFuncSetAttribute(
      stencil_chain_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>((H + th - 1) / th),
                  static_cast<unsigned>((W + tw - 1) / tw));
  stencil_chain_kernel<<<grid, kThreads, smem_bytes, s>>>(a, coeffs, out, H,
                                                          W, th, tw, table);
  return static_cast<int>(cudaGetLastError());
}
