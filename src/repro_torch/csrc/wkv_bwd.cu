// wkv_chunked_bwd: the gradient of wkv.cu's chunked RWKV6 WKV. r, k, v, w,
// dout (B, S, H, hd), all fp32 or all bf16 (widened to fp32); u (H, hd)
// fp32; state0 (B, H, hd, hd) fp32 or null (zero); dstate (B, H, hd, hd)
// fp32 or null (zero), the gradient of the final state. Out: dr, dk, dv,
// dw (B, S, H, hd) in r's type, du (H, hd) fp32, dstate0 (B, H, hd, hd)
// fp32. With A_t = prod_{s<=t} w_s within a chunk (per key channel), S_0
// the state entering it and G the gradient of the state leaving it,
// Q_t = r_t A_{t-1}, K_j = k_j / A_j, Kr_j = (A_last / A_j) k_j,
// P_tj = Q_t . K_j (j < t), b_t = r_t . (u k_t), dov_tj = dout_t . v_j:
//
//   dv_j  = sum_{t>j} P_tj dout_t + b_j dout_j + G^T Kr_j
//   dQ_t  = S_0 dout_t + sum_{j<t} dov_tj K_j,  dr_t = A_{t-1} dQ_t
//           + dov_tt u k_t
//   dK_j  = sum_{t>j} dov_tj Q_t,  gv_j = G v_j,
//   dk_j  = dK_j / A_j + (A_last / A_j) gv_j + dov_jj u r_j
//   du    = sum_{b,t} dov_tt r_t k_t
//   G    <- diag(A_last) G + sum_t Q_t dout_t^T   (into the chunk before)
//
// and the decay through its log: d la_j = -K_j dK_j - Kr_j gv_j (plus, at
// the chunk's last position, sum_j Kr_j gv_j + A_last rowsum(S_0 o G)),
// d lae_t = Q_t dQ_t, d lw_s = sum_{t>=s} d la_t + sum_{t>s} d lae_t, and
// dw = d lw / w where w >= 1e-8, 0 below (the forward's log(max(w, 1e-8))).
//
// No TPU kernel corresponds: the reference differentiates its jnp
// _wkv_chunked. Design (a simple kernel, fp32 FMAs):
//   * A block takes one (b, h) and a slice of kSlice value channels (32, or
//     16 for hd > 128): the state's and G's columns e depend only on v's and
//     dout's column e. It first walks the chunks forward to recompute the
//     states entering each chunk (the forward keeps none) into an fp32
//     scratch (B, H, S/16, hd, hd), then walks them in reverse carrying
//     its slice of G (hd x kSlice fp32) in shared memory.
//   * dv and dstate0 are the slice's own. dr, dk, d lw and du sum over the
//     value channels: each slice writes its part to scratch, and
//     wkv_bwd_finish sums the slices in order (du also over b), then
//     divides d lw by w. No atomics: the same inputs give byte-identical
//     results.
//   * The chunk's r, k, v, dout rows, its decays and the products above sit
//     in shared memory as fp32, rows padded by one float.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kChunk = 16;
constexpr int kMaxHead = 256;
constexpr int kThreads = 256;

__device__ __forceinline__ float load(const float* p) { return *p; }
__device__ __forceinline__ float load(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

__host__ __device__ inline int slice_of(int hd) { return hd > 128 ? 16 : 32; }

// shared floats of one block: ten (kChunk, hd + 1) tiles (r, k, la, lae,
// Q, K, Kr, dQ, dK, gv), v and dout (kChunk, ev + 1), the state and G
// (hd, ev + 1), the scores and dov (kChunk, kChunk + 1), the bonus,
// A_last, u and the row sums of S_0 o G: 65,728 bytes at hd = 64
__host__ __device__ inline int64_t smem_floats(int hd) {
  const int ev = slice_of(hd);
  return 10LL * kChunk * (hd + 1) + 2LL * kChunk * (ev + 1) +
         2LL * hd * (ev + 1) + 2LL * kChunk * (kChunk + 1) + kChunk +
         3LL * hd;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
wkv_bwd_kernel(const T* __restrict__ r, const T* __restrict__ k,
               const T* __restrict__ v, const T* __restrict__ w,
               const float* __restrict__ u, const float* __restrict__ state0,
               const T* __restrict__ dout, const float* __restrict__ dstate,
               T* __restrict__ dv, float* __restrict__ dstate0,
               float* __restrict__ states, float* __restrict__ part_dr,
               float* __restrict__ part_dk, float* __restrict__ part_dlw,
               float* __restrict__ part_du, int B, int S, int H, int hd) {
  extern __shared__ float sm[];
  const int ev = slice_of(hd), nsl = (hd + ev - 1) / ev;
  const int HP = hd + 1, EP = ev + 1, CP = kChunk + 1;
  float* rs = sm;                    // r
  float* ks = rs + kChunk * HP;      // k
  float* la = ks + kChunk * HP;      // inclusive log decay
  float* lae = la + kChunk * HP;     // exclusive log decay
  float* qt = lae + kChunk * HP;     // Q = r A_{t-1}
  float* kt = qt + kChunk * HP;      // K = k / A_j
  float* kr = kt + kChunk * HP;      // Kr = (A_last / A_j) k
  float* dq = kr + kChunk * HP;      // dQ
  float* dkk = dq + kChunk * HP;     // dK
  float* gv = dkk + kChunk * HP;     // G v_j
  float* vs = gv + kChunk * HP;      // v slice
  float* ds = vs + kChunk * EP;      // dout slice
  float* st = ds + kChunk * EP;      // the state entering the chunk
  float* g = st + hd * EP;           // G
  float* sc = g + hd * EP;           // P_tj (j < t)
  float* dov = sc + kChunk * CP;     // dout_t . v_j over the slice
  float* bonus = dov + kChunk * CP;  // b_t
  float* alast = bonus + kChunk;     // A_last
  float* us = alast + hd;            // u
  float* sg = us + hd;               // rowsum(S_0 o G)

  const int sl = blockIdx.x % nsl;
  const int bh = blockIdx.x / nsl;
  const int b = bh / H, h = bh % H;
  const int e0 = sl * ev, nev = min(ev, hd - e0);
  const int tid = threadIdx.x;
  const int N = S / kChunk;
  const int64_t row = static_cast<int64_t>(H) * hd;     // one position
  const int64_t base = static_cast<int64_t>(b) * S * row +
                       static_cast<int64_t>(h) * hd;
  const int64_t hh = static_cast<int64_t>(hd) * hd;
  float* states_bh = states + (static_cast<int64_t>(b) * H + h) * N * hh;
  const int64_t sbase = (static_cast<int64_t>(b) * H + h) * hh;

  for (int d = tid; d < hd; d += kThreads) us[d] = u[h * hd + d];
  // the state entering chunk 0 (zero without state0); columns past hd: 0
  for (int i = tid; i < hd * ev; i += kThreads) {
    const int d = i / ev, e = i % ev;
    st[d * EP + e] = (state0 != nullptr && e < nev)
                         ? state0[sbase + d * hd + e0 + e] : 0.0f;
  }

  // the chunk's rows: a position's hd values of r, k (and w into la as
  // log max(w, 1e-8)); v and dout over the slice
  auto stage = [&](int n, bool with_r, bool with_dout) {
    const int64_t at = base + static_cast<int64_t>(n) * kChunk * row;
    for (int i = tid; i < kChunk * hd; i += kThreads) {
      const int t = i / hd, d = i % hd;
      const int64_t x = at + t * row + d;
      if (with_r) rs[t * HP + d] = load(r + x);
      ks[t * HP + d] = load(k + x);
      lae[t * HP + d] = logf(fmaxf(load(w + x), 1e-8f));
    }
    for (int i = tid; i < kChunk * ev; i += kThreads) {
      const int t = i / ev, e = i % ev;
      const int64_t x = at + t * row + e0 + e;
      vs[t * EP + e] = e < nev ? load(v + x) : 0.0f;
      if (with_dout) ds[t * EP + e] = e < nev ? load(dout + x) : 0.0f;
    }
  };
  // the decays of a key channel, its positions in order: la (inclusive),
  // lae (exclusive: la - log w), A_last, and Kr (with Q and K when asked)
  auto decays = [&](bool all) {
    for (int d = tid; d < hd; d += kThreads) {
      float acc = 0.0f;
      for (int t = 0; t < kChunk; ++t) {
        const float lw = lae[t * HP + d];
        lae[t * HP + d] = acc;
        acc += lw;
        la[t * HP + d] = acc;
      }
      alast[d] = expf(acc);
      for (int t = 0; t < kChunk; ++t) {
        const float kv = ks[t * HP + d];
        kr[t * HP + d] = kv * expf(acc - la[t * HP + d]);
        if (all) {
          qt[t * HP + d] = rs[t * HP + d] * expf(lae[t * HP + d]);
          kt[t * HP + d] = kv * expf(-la[t * HP + d]);
        }
      }
    }
  };

  // pass 1: the states entering each chunk, S <- diag(A_last) S + Kr^T v
  for (int n = 0; n < N; ++n) {
    __syncthreads();
    float* out = states_bh + static_cast<int64_t>(n) * hh;
    for (int i = tid; i < hd * nev; i += kThreads) {
      const int d = i / nev, e = i % nev;
      out[d * hd + e0 + e] = st[d * EP + e];
    }
    stage(n, false, false);
    __syncthreads();
    decays(false);
    __syncthreads();
    for (int i = tid; i < hd * ev; i += kThreads) {
      const int d = i / ev, e = i % ev;
      float acc = alast[d] * st[d * EP + e];
      for (int j = 0; j < kChunk; ++j)
        acc = fmaf(kr[j * HP + d], vs[j * EP + e], acc);
      st[d * EP + e] = acc;
    }
  }

  // pass 2: the chunks in reverse, G from dstate (or zero)
  for (int i = tid; i < hd * ev; i += kThreads) {
    const int d = i / ev, e = i % ev;
    g[d * EP + e] = (dstate != nullptr && e < nev)
                        ? dstate[sbase + d * hd + e0 + e] : 0.0f;
  }
  float du = 0.0f;   // thread d < hd: its channel's du over the slice
  const int64_t pbase = static_cast<int64_t>(sl) * B * S * row;
  for (int n = N - 1; n >= 0; --n) {
    __syncthreads();
    const float* in = states_bh + static_cast<int64_t>(n) * hh;
    for (int i = tid; i < hd * ev; i += kThreads) {
      const int d = i / ev, e = i % ev;
      st[d * EP + e] = e < nev ? in[d * hd + e0 + e] : 0.0f;
    }
    stage(n, true, true);
    __syncthreads();
    decays(true);
    __syncthreads();
    // the 16 x 16 scores, dov and the bonus
    {
      const int t = tid / kChunk, j = tid % kChunk;
      float p = 0.0f, o = 0.0f;
      if (j < t)
        for (int d = 0; d < hd; ++d)
          p = fmaf(qt[t * HP + d], kt[j * HP + d], p);
      for (int e = 0; e < ev; ++e) o = fmaf(ds[t * EP + e], vs[j * EP + e], o);
      sc[t * CP + j] = p;
      dov[t * CP + j] = o;
      if (tid < kChunk) {
        float bb = 0.0f;
        for (int d = 0; d < hd; ++d)
          bb = fmaf(rs[tid * HP + d] * us[d], ks[tid * HP + d], bb);
        bonus[tid] = bb;
      }
    }
    __syncthreads();
    // dv (the slice's own), dQ, dK, gv and rowsum(S_0 o G)
    for (int i = tid; i < kChunk * nev; i += kThreads) {
      const int j = i / nev, e = i % nev;
      float acc = bonus[j] * ds[j * EP + e];
      for (int t = j + 1; t < kChunk; ++t)
        acc = fmaf(sc[t * CP + j], ds[t * EP + e], acc);
      for (int d = 0; d < hd; ++d)
        acc = fmaf(kr[j * HP + d], g[d * EP + e], acc);
      store(dv + base + (static_cast<int64_t>(n) * kChunk + j) * row + e0 +
                e, acc);
    }
    for (int i = tid; i < kChunk * hd; i += kThreads) {
      const int t = i / hd, d = i % hd;
      float a = 0.0f, c = 0.0f, gg = 0.0f;
      for (int e = 0; e < ev; ++e) {
        a = fmaf(st[d * EP + e], ds[t * EP + e], a);
        gg = fmaf(g[d * EP + e], vs[t * EP + e], gg);
      }
      for (int j = 0; j < t; ++j) a = fmaf(dov[t * CP + j], kt[j * HP + d], a);
      for (int s2 = t + 1; s2 < kChunk; ++s2)
        c = fmaf(dov[s2 * CP + t], qt[s2 * HP + d], c);
      dq[t * HP + d] = a;
      dkk[t * HP + d] = c;
      gv[t * HP + d] = gg;
    }
    for (int d = tid; d < hd; d += kThreads) {
      float a = 0.0f;
      for (int e = 0; e < ev; ++e) a = fmaf(st[d * EP + e], g[d * EP + e], a);
      sg[d] = a;
    }
    __syncthreads();
    // the slice's parts of dr, dk and d lw; du; then G into the chunk before
    for (int d = tid; d < hd; d += kThreads) {
      float tail = alast[d] * sg[d];
      for (int t = 0; t < kChunk; ++t) tail += kr[t * HP + d] * gv[t * HP + d];
      float acc_la = 0.0f, acc_lae = 0.0f;
      for (int t = kChunk - 1; t >= 0; --t) {
        const int x = t * HP + d;
        const float dii = dov[t * CP + t];
        const float dqv = dq[x], dkv = dkk[x], gvv = gv[x];
        const float drv = expf(lae[x]) * dqv + dii * us[d] * ks[x];
        const float dk_t = expf(-la[x]) * dkv +
                           expf(la[(kChunk - 1) * HP + d] - la[x]) * gvv +
                           dii * us[d] * rs[x];
        float dla = -kt[x] * dkv - kr[x] * gvv;
        if (t == kChunk - 1) dla += tail;
        acc_la += dla;
        const float dlw = acc_la + acc_lae;
        acc_lae += qt[x] * dqv;
        du = fmaf(dii * rs[x], ks[x], du);
        const int64_t o = pbase + base +
                          (static_cast<int64_t>(n) * kChunk + t) * row + d;
        part_dr[o] = drv;
        part_dk[o] = dk_t;
        part_dlw[o] = dlw;
      }
    }
    __syncthreads();
    for (int i = tid; i < hd * ev; i += kThreads) {
      const int d = i / ev, e = i % ev;
      float acc = alast[d] * g[d * EP + e];
      for (int t = 0; t < kChunk; ++t)
        acc = fmaf(qt[t * HP + d], ds[t * EP + e], acc);
      g[d * EP + e] = acc;
    }
  }
  __syncthreads();
  for (int i = tid; i < hd * nev; i += kThreads) {
    const int d = i / nev, e = i % nev;
    dstate0[sbase + d * hd + e0 + e] = g[d * EP + e];
  }
  for (int d = tid; d < hd; d += kThreads)
    part_du[((static_cast<int64_t>(sl) * B + b) * H + h) * hd + d] = du;
}

// dr, dk, dw: the slices' parts summed in order (dw = d lw / w where
// w >= 1e-8, else 0); du: the parts over b, then slices, in order
template <typename T>
__global__ void __launch_bounds__(kThreads)
wkv_bwd_finish(const T* __restrict__ w, const float* __restrict__ part_dr,
               const float* __restrict__ part_dk,
               const float* __restrict__ part_dlw,
               const float* __restrict__ part_du, T* __restrict__ dr,
               T* __restrict__ dk, T* __restrict__ dw, float* __restrict__ du,
               int64_t n, int nsl, int B, int H, int hd) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads +
                    threadIdx.x;
  if (i < n) {
    float a = 0.0f, c = 0.0f, l = 0.0f;
    for (int s = 0; s < nsl; ++s) {
      a += part_dr[s * n + i];
      c += part_dk[s * n + i];
      l += part_dlw[s * n + i];
    }
    const float wv = load(w + i);
    store(dr + i, a);
    store(dk + i, c);
    store(dw + i, wv >= 1e-8f ? l / wv : 0.0f);
  }
  if (blockIdx.x == 0) {
    for (int j = threadIdx.x; j < H * hd; j += kThreads) {
      float acc = 0.0f;
      for (int s = 0; s < nsl; ++s)
        for (int bb = 0; bb < B; ++bb)
          acc += part_du[(static_cast<int64_t>(s) * B + bb) * H * hd + j];
      du[j] = acc;
    }
  }
}

template <typename T>
int run(const void* r, const void* k, const void* v, const void* w,
        const float* u, const float* state0, const void* dout,
        const float* dstate, void* dr, void* dk, void* dv, void* dw,
        float* du, float* dstate0, float* scratch, int B, int S, int H,
        int hd, cudaStream_t s) {
  const int ev = slice_of(hd), nsl = (hd + ev - 1) / ev;
  const int64_t n = static_cast<int64_t>(B) * S * H * hd;
  float* states = scratch;
  float* part_dr = states + static_cast<int64_t>(B) * H * (S / kChunk) * hd *
                                hd;
  float* part_dk = part_dr + nsl * n;
  float* part_dlw = part_dk + nsl * n;
  float* part_du = part_dlw + nsl * n;
  const int64_t smem = smem_floats(hd) * 4;
  // the opt-in above 48 KB, once per device for the largest size asked, so
  // that a launch inside a CUDA graph capture sets nothing
  static int64_t granted[64] = {};
  if (smem > 48 * 1024) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
    if (smem > granted[dev]) {
      err = cudaFuncSetAttribute(wkv_bwd_kernel<T>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(smem));
      if (err != cudaSuccess) return static_cast<int>(err);
      granted[dev] = smem;
    }
  }
  wkv_bwd_kernel<T><<<B * H * nsl, kThreads, smem, s>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(w), u, state0,
      static_cast<const T*>(dout), dstate, static_cast<T*>(dv), dstate0,
      states, part_dr, part_dk, part_dlw, part_du, B, S, H, hd);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  wkv_bwd_finish<T><<<static_cast<unsigned>((n + kThreads - 1) / kThreads),
                      kThreads, 0, s>>>(
      static_cast<const T*>(w), part_dr, part_dk, part_dlw, part_du,
      static_cast<T*>(dr), static_cast<T*>(dk), static_cast<T*>(dw), du, n,
      nsl, B, H, hd);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Bytes of the fp32 scratch the caller passes: the chunk-start states
// (B H S/16 hd^2 floats), the slices' parts of dr, dk and d lw (3 nsl
// B S H hd) and of du (nsl B H hd), nsl = ceil(hd / slice).
extern "C" int64_t wkv_chunked_bwd_scratch(int B, int S, int H, int hd) {
  const int64_t nsl = (hd + slice_of(hd) - 1) / slice_of(hd);
  return (static_cast<int64_t>(B) * H * (S / kChunk) * hd * hd +
          3 * nsl * static_cast<int64_t>(B) * S * H * hd +
          nsl * static_cast<int64_t>(B) * H * hd) * 4;
}

// dtype: 0 = fp32, 1 = bf16, of r, k, v, w, dout, dr, dk, dv, dw; u, du,
// state0, dstate, dstate0 and the scratch fp32; all contiguous. state0 and
// dstate may be null (zero). Returns the first launch error, or
// cudaGetLastError() after the last launch.
extern "C" int wkv_chunked_bwd_launch(
    const void* r, const void* k, const void* v, const void* w,
    const void* u, const void* state0, const void* dout, const void* dstate,
    void* dr, void* dk, void* dv, void* dw, void* du, void* dstate0,
    void* scratch, int B, int S, int H, int hd, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (hd < 1 || hd > kMaxHead || S % kChunk != 0) return cudaErrorInvalidValue;
  if (B <= 0 || H <= 0 || S <= 0) return 0;
  const float* uf = static_cast<const float*>(u);
  const float* s0 = static_cast<const float*>(state0);
  const float* dsf = static_cast<const float*>(dstate);
  float* duf = static_cast<float*>(du);
  float* d0 = static_cast<float*>(dstate0);
  float* sc = static_cast<float*>(scratch);
  if (dtype == 0)
    return run<float>(r, k, v, w, uf, s0, dout, dsf, dr, dk, dv, dw, duf, d0,
                      sc, B, S, H, hd, s);
  return run<__nv_bfloat16>(r, k, v, w, uf, s0, dout, dsf, dr, dk, dv, dw,
                            duf, d0, sc, B, S, H, hd, s);
}
