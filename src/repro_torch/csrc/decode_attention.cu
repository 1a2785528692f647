// decode_attention: one-token masked attention over a gathered context.
// q (B, H, Dh), k and v (B, C, H, Dh) already GQA-repeated, both fp32 or
// both bf16; pos (B,) int32; out (B, H, Dh) in q's type:
//
//   s_j   = (q . k_j) / sqrt(Dh)          for j <= pos[b]
//                                         (and j > pos[b] - window),
//   s_j   = -1e30                         otherwise,
//   out   = sum_j softmax(s)_j v_j.
//
// Replaces the TPU kernel repro/kernels/attention/decode.py::
// decode_attention, a (B, H) Pallas grid whose cell holds a (C, Dh) K and
// V slab in VMEM, takes pos as a prefetched scalar, and computes the score
// vector, mask, softmax and p @ V on whole arrays.
//
// Bound on the H100 by bytes: each admitted K and V row is read once (2 Dh
// elements), for about 4 flops an element pair. At the serving shapes
// (B = 64, C = 64, H = 24, Dh = 128, bf16, pos = 38) that is 30.7 MB, 9.2
// us at 3.35 TB/s; a long context (B = 8, C = 4,096) reads 403 MB. So the
// design keeps as many bytes in flight as the card needs, and reads none
// it does not need:
//   * only the admitted range. A (b, h) row admits
//     [lo, hi] = [max(0, pos - window + 1), min(C - 1, pos)], worked out
//     once from the loaded pos; no K or V row outside it is read. An empty
//     range (pos < 0, or a window wholly past the context) is what the
//     reference's all -1e30 scores give, a uniform softmax: that branch
//     walks all C rows at one weight (V only), i.e. the mean of V.
//   * one pass, online softmax: a stream of rows keeps a running (m, l,
//     o[Dh]) in fp32 registers and rescales o by exp(m_old - m_new) once a
//     step of rows; K and V of the same rows are loaded together; no
//     C-long score array; one division at the end.
//   * wide loads, many rows in flight: one warp a work item, so that the
//     serving step's 1,536 (b, h) rows are 1,536 warps resident at once (a
//     block of four warps for each (b, h) ran them in three waves, and took
//     longer). A row of Dh elements is read as vectors V of E = sizeof(V) /
//     sizeof(T) elements: 16 bytes where they divide the row and the
//     operands' alignment, else 8, 4 or 2 (kernel.py::route), so every Dh
//     and every alignment runs. kLanes lanes share a row (16 lanes x 8 bf16
//     cover Dh = 128, 32 lanes x 4 fp32 the same in fp32; two vectors a
//     lane past 32 lanes), so a warp reads 32 / kLanes rows an instruction,
//     one for each of its streams, and each stream keeps two steps of
//     4 / kVecs rows in flight: the next step's loads go out before this
//     step's rows are used. A row's score is reduced by xor shuffles within
//     its kLanes lanes; the warp's streams are merged by xor shuffles too.
//     No shared memory, no barrier.
//   * a row of more than 64 vectors (Dh over 512 in bf16, 256 in fp32) is
//     cut into slices of 64 columns, one item each; every slice scores the
//     whole row (the same sums in the same order, so the same m and l) and
//     keeps the running sums of its own columns.
//   * split contexts. When the B H rows are too few to fill the card, the
//     wrapper's plan (kernels/attention/kernel.py::plan) cuts the range
//     into at most `chunks` chunks of at least `rows` rows, one item each
//     (chunk_range). An item writes its (m, l, o) to a workspace and takes
//     an integer ticket; the item that takes the last ticket of its (b, h)
//     merges the chunks in chunk order and resets the ticket. Items of
//     chunks past the range exit at once.
// No floating-point atomics, and every sum has a fixed order: the same
// inputs give byte-identical results whichever item merges.
//
// Shared memory: none. The first design kept every score of the context,
// so it needed 4 (C + Dh + 264) bytes; the wrapper still refuses the
// contexts that measure refused (DecodeAttentionLimitError).
#include "reduce.cuh"

#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

using repro::to_f32;

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr float kMasked = -1e30f;     // the reference's masked score
constexpr unsigned kAll = 0xffffffffu;

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// Chunk c of row b's admitted range: [clo, chi], and the number of chunks
// the range takes (n_used); false when chunk c lies past the range. A
// chunk is `rows` rows, or more where the range would take more than
// `chunks` of them: an empty range takes all C rows (`empty`: every score
// is the masked one), which the plan may have sized over a window.
__device__ __forceinline__ bool chunk_range(int p, int C, int window,
                                            int rows, int chunks, int c,
                                            int& clo, int& chi, int& n_used,
                                            bool& empty) {
  const int64_t last = static_cast<int64_t>(C) - 1;
  const int64_t first = static_cast<int64_t>(p) - window + 1;
  int64_t lo = window > 0 && first > 0 ? first : 0;
  int64_t hi = p < last ? p : last;
  empty = lo > hi;
  if (empty) {
    lo = 0;
    hi = C - 1;
  }
  const int n = static_cast<int>(hi - lo + 1);
  // unsplit (the plan's rows >= C): no division before the first loads
  const int len = chunks == 1 ? n : max(rows, (n + chunks - 1) / chunks);
  n_used = chunks == 1 ? 1 : (n + len - 1) / len;
  clo = static_cast<int>(lo) + c * len;
  chi = min(static_cast<int>(hi), clo + len - 1);
  return c < n_used;
}

// Publish the warp's partial (written before the call) and take its (b,
// h)'s ticket; true, in every lane, in the warp that takes the last of
// `arrivals`.
__device__ __forceinline__ bool last_arrival(unsigned* ticket,
                                             unsigned arrivals, int lane) {
  __threadfence();
  __syncwarp();
  unsigned taken = 0u;
  if (lane == 0) taken = atomicAdd(ticket, 1u);   // the one atomic: an integer
  taken = __shfl_sync(kAll, taken, 0);
  if (taken != arrivals - 1) return false;
  __threadfence();
  return true;
}

// Floats of a chunk's workspace slot: its Dh sums, then m and l, padded
// to a multiple of four so that every slot starts on 16 bytes
// (kernels/attention/kernel.py::slot_floats).
__device__ __forceinline__ int64_t slot_floats(int Dh) {
  return (static_cast<int64_t>(Dh) + 2 + 3) / 4 * 4;
}

// The merge of a (b, h)'s n_used <= 32 chunks in chunk order, by one warp:
// lane i reads chunk i's m and l, the max and the normalizer are
// xor-butterfly reductions (the same bits in every lane), and the columns
// go four a lane as 16-byte loads (the last four may reach into the slot's
// m, l and padding, which are not stored), kBatch chunks' loads in flight
// together, the first batch's beside m and l; every read goes past this
// SM's L1. Leaves the ticket at 0 for the next launch.
template <typename T>
__device__ __forceinline__ void merge_chunks(const float* first, int n_used,
                                             int Dh, T* orow,
                                             unsigned* ticket, int lane) {
  constexpr int kBatch = 16;
  const int64_t slot = slot_floats(Dh);
  const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  const float mi = lane < n_used ? __ldcg(first + lane * slot + Dh)
                                 : -INFINITY;
  const float li = lane < n_used ? __ldcg(first + lane * slot + Dh + 1)
                                 : 0.0f;
  float w = 0.0f, L = 0.0f;
  bool weighed = false;
  for (int d0 = 0; d0 < Dh; d0 += 128) {
    const int d = d0 + 4 * lane;
    const bool in = d < Dh;
    float acc[4] = {};
    for (int j0 = 0; j0 < n_used; j0 += kBatch) {
      float4 x[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u)
        x[u] = in && j0 + u < n_used
                   ? __ldcg(reinterpret_cast<const float4*>(
                         first + (j0 + u) * slot + d))
                   : zero;
      if (!weighed) {   // the chunks' weights, once
        float M = mi;
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          M = fmaxf(M, __shfl_xor_sync(kAll, M, off));
        w = lane < n_used ? expf(mi - M) : 0.0f;
        L = li * w;
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          L += __shfl_xor_sync(kAll, L, off);
        weighed = true;
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const float wj = __shfl_sync(kAll, w, (j0 + u) & 31);
        acc[0] += x[u].x * wj;
        acc[1] += x[u].y * wj;
        acc[2] += x[u].z * wj;
        acc[3] += x[u].w * wj;
      }
    }
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (d + e < Dh) store(orow + d + e, acc[e] / L);
  }
  if (lane == 0) *ticket = 0u;
}

// One step of a stream: load kUnroll rows of K and V, r0 + slot + u kSlots
// (kSlots streams a warp), the vectors col0 + sub + i kLanes of each; a
// row past chi is not read, nor K where load_k is false. Each row is read
// once, so the loads are streaming ones (evict first), a little faster on
// the card than __ldg.
template <typename T, typename V, int kLanes, int kVecs, int kUnroll>
__device__ __forceinline__ void load_rows(V (&kx)[kUnroll][kVecs],
                                          V (&vx)[kUnroll][kVecs],
                                          const T* k, const T* v,
                                          int64_t base, int64_t pitch,
                                          int r0, int chi, int sub, int slot,
                                          int col0, int nv, bool load_k) {
  constexpr int kSlots = 32 / kLanes;
  const V zero{};
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const int r = r0 + slot + u * kSlots;
    const int64_t off = base + static_cast<int64_t>(r) * pitch;
#pragma unroll
    for (int i = 0; i < kVecs; ++i) {
      const int vi = col0 + sub + i * kLanes;
      const bool in = r <= chi && vi < nv;
      const V* kp = reinterpret_cast<const V*>(k + off) + vi;
      const V* vp = reinterpret_cast<const V*>(v + off) + vi;
      kx[u][i] = in && load_k ? __ldcs(kp) : zero;
      vx[u][i] = in ? __ldcs(vp) : zero;
    }
  }
}

// A lane's part of q . k_r over the whole row, its vectors sub, sub +
// kLanes, ...: the score of a sliced row.
template <typename T, typename V, int kLanes>
__device__ __forceinline__ float row_dot(const T* qr, const T* kr, int nv,
                                         int sub) {
  constexpr int kElems = sizeof(V) / sizeof(T);
  float dot = 0.0f;
  for (int j = sub; j < nv; j += kLanes) {
    const V x = __ldg(reinterpret_cast<const V*>(kr) + j);
    const T* kt = reinterpret_cast<const T*>(&x);
#pragma unroll
    for (int e = 0; e < kElems; ++e)
      dot += to_f32(qr[j * kElems + e]) * to_f32(kt[e]);
  }
  return dot;
}

// The loaded rows into the stream's running (m, l, o): scores reduced over
// the row's kLanes lanes, one rescale a step. `whole` (a sliced row): the
// row's K from k + base, which load_rows did not load, scored by row_dot.
template <typename T, typename V, int kLanes, int kVecs, int kUnroll>
__device__ __forceinline__ void take_rows(
    const V (&kx)[kUnroll][kVecs], const V (&vx)[kUnroll][kVecs],
    const float (&qf)[kVecs][sizeof(V) / sizeof(T)],
    float (&o)[kVecs][sizeof(V) / sizeof(T)], float& m, float& l, int r0,
    int chi, int slot, bool empty, float scale, const T* whole,
    const T* qr, int64_t pitch, int nv, int sub) {
  constexpr int kElems = sizeof(V) / sizeof(T);
  constexpr int kSlots = 32 / kLanes;
  float s[kUnroll];
  float gm = m;
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const int r = r0 + slot + u * kSlots;
    float dot = 0.0f;
    if (whole == nullptr) {
#pragma unroll
      for (int i = 0; i < kVecs; ++i) {
        const T* kt = reinterpret_cast<const T*>(&kx[u][i]);
#pragma unroll
        for (int e = 0; e < kElems; ++e) dot += qf[i][e] * to_f32(kt[e]);
      }
    } else if (r <= chi) {
      dot = row_dot<T, V, kLanes>(qr, whole + r * pitch, nv, sub);
    }
#pragma unroll
    for (int off = kLanes / 2; off > 0; off >>= 1)
      dot += __shfl_xor_sync(kAll, dot, off);
    s[u] = empty ? kMasked : dot * scale;
    if (r <= chi) gm = fmaxf(gm, s[u]);
  }
  const float alpha = gm == m ? 1.0f : expf(m - gm);   // m = -inf: 0
  l *= alpha;
#pragma unroll
  for (int i = 0; i < kVecs; ++i)
#pragma unroll
    for (int e = 0; e < kElems; ++e) o[i][e] *= alpha;
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const float p = r0 + slot + u * kSlots <= chi ? expf(s[u] - gm) : 0.0f;
    l += p;
#pragma unroll
    for (int i = 0; i < kVecs; ++i) {
      const T* vt = reinterpret_cast<const T*>(&vx[u][i]);
#pragma unroll
      for (int e = 0; e < kElems; ++e) o[i][e] += p * to_f32(vt[e]);
    }
  }
  m = gm;
}

// One warp a (bh, chunk, slice): kLanes lanes share a row, kVecs vectors V
// a lane (route in kernels/attention/kernel.py), so the warp's 32 / kLanes
// slots are streams of rows clo + slot, clo + slot + 32 / kLanes, ...;
// each stream keeps two steps of kUnroll rows in flight (loads of the next
// step issued before the rows of this one are used). The streams are
// merged by xor shuffles, a fixed butterfly. No shared memory, no barrier.
template <typename T, typename V, int kLanes, int kVecs>
__global__ void __launch_bounds__(kThreads, 4)
decode(const T* __restrict__ q, const T* __restrict__ k,
       const T* __restrict__ v, const int* __restrict__ pos,
       T* __restrict__ out, float* __restrict__ part,
       unsigned* __restrict__ ticket, int B, int C, int H, int Dh,
       int window, float scale, int rows, int chunks) {
  constexpr int kElems = sizeof(V) / sizeof(T);  // elements of a vector
  constexpr int kSlots = 32 / kLanes;            // streams of a warp
  constexpr int kUnroll = 4 / kVecs;             // rows a stream's step
  constexpr int kStep = kUnroll * kSlots;        // rows a warp's step
  constexpr int kSlice = kLanes * kVecs;         // vectors of an item
  const int lane = threadIdx.x & 31;
  const int nv = Dh / kElems;
  // only a two-vector instance takes a row of more than kSlice vectors
  // (the launch checks it); the items are fewer than 2^31 (also checked)
  const int slices = kVecs == 2 ? (nv + kSlice - 1) / kSlice : 1;
  const int per = chunks * slices;
  const int item = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (item >= B * H * per) return;
  const int bh = item / per;
  const int c = (item - bh * per) / slices;
  const int col0 = (item - bh * per - c * slices) * kSlice;
  const int b = bh / H, h = bh % H;
  const int sub = lane % kLanes, slot = lane / kLanes;
  // q is loaded beside pos, not after it: the first K/V loads wait for one
  // round trip to memory, not two
  float qf[kVecs][kElems], o[kVecs][kElems];
  const T* qr = q + static_cast<int64_t>(bh) * Dh;
#pragma unroll
  for (int i = 0; i < kVecs; ++i) {
    const int vi = col0 + sub + i * kLanes;
#pragma unroll
    for (int e = 0; e < kElems; ++e) {
      qf[i][e] = vi < nv ? to_f32(qr[vi * kElems + e]) : 0.0f;
      o[i][e] = 0.0f;
    }
  }
  int clo, chi, n_used;
  bool empty;
  if (!chunk_range(pos[b], C, window, rows, chunks, c, clo, chi, n_used,
                   empty))
    return;
  const int64_t pitch = static_cast<int64_t>(H) * Dh;
  const int64_t base = static_cast<int64_t>(b) * C * pitch +
                       static_cast<int64_t>(h) * Dh;
  const T* whole = kVecs == 2 && slices > 1 && !empty ? k + base : nullptr;
  const bool load_k = !empty && whole == nullptr;
  float m = -INFINITY, l = 0.0f;
  V ka[kUnroll][kVecs], va[kUnroll][kVecs];
  V kb[kUnroll][kVecs], vb[kUnroll][kVecs];
  // the loop bounds are warp-uniform, so every lane takes part in the
  // shuffles; a row past chi weighs 0
  int r0 = clo;
  load_rows<T, V, kLanes>(ka, va, k, v, base, pitch, r0, chi, sub, slot,
                          col0, nv, load_k);
  while (true) {
    load_rows<T, V, kLanes>(kb, vb, k, v, base, pitch, r0 + kStep, chi, sub,
                            slot, col0, nv, load_k);
    take_rows<T, V, kLanes>(ka, va, qf, o, m, l, r0, chi, slot, empty, scale,
                            whole, qr, pitch, nv, sub);
    r0 += kStep;
    if (r0 > chi) break;
    load_rows<T, V, kLanes>(ka, va, k, v, base, pitch, r0 + kStep, chi, sub,
                            slot, col0, nv, load_k);
    take_rows<T, V, kLanes>(kb, vb, qf, o, m, l, r0, chi, slot, empty, scale,
                            whole, qr, pitch, nv, sub);
    r0 += kStep;
    if (r0 > chi) break;
  }
  // merge the streams: after the step of xor distance `off` both lanes hold
  // the same sums (a + b in one, b + a in the other); a stream that saw no
  // row has m = -inf and weighs 0, and slot 0 holds row clo
#pragma unroll
  for (int off = kLanes; off < 32; off <<= 1) {
    const float mo = __shfl_xor_sync(kAll, m, off);
    const float mn = fmaxf(m, mo);
    const float a = mn == -INFINITY ? 0.0f : expf(m - mn);
    const float w = mn == -INFINITY ? 0.0f : expf(mo - mn);
    l = l * a + __shfl_xor_sync(kAll, l, off) * w;
#pragma unroll
    for (int i = 0; i < kVecs; ++i)
#pragma unroll
      for (int e = 0; e < kElems; ++e)
        o[i][e] = o[i][e] * a + __shfl_xor_sync(kAll, o[i][e], off) * w;
    m = mn;
  }
  // one chunk: the item's columns straight to out; else to the chunk's
  // slot, and the last item of the (b, h) to arrive merges the slots
  T* orow = out + static_cast<int64_t>(bh) * Dh;
  float* mine = nullptr;
  if (n_used > 1)
    mine = part + (static_cast<int64_t>(bh) * chunks + c) * slot_floats(Dh);
  if (slot == 0)
#pragma unroll
    for (int i = 0; i < kVecs; ++i) {
      const int vi = col0 + sub + i * kLanes;
      if (vi < nv)
#pragma unroll
        for (int e = 0; e < kElems; ++e) {
          if (mine == nullptr)
            store(orow + vi * kElems + e, o[i][e] / l);
          else
            mine[vi * kElems + e] = o[i][e];
        }
    }
  if (mine == nullptr) return;
  if (lane == 0 && col0 == 0) {
    mine[Dh] = m;
    mine[Dh + 1] = l;
  }
  if (last_arrival(ticket + bh, static_cast<unsigned>(n_used * slices), lane))
    merge_chunks<T>(mine - c * slot_floats(Dh), n_used, Dh, orow,
                    ticket + bh, lane);
}

template <typename T, typename V>
const void* pick_lanes(int lanes, int vecs) {
  if (vecs == 1) {
    switch (lanes) {
      case 4: return reinterpret_cast<const void*>(&decode<T, V, 4, 1>);
      case 8: return reinterpret_cast<const void*>(&decode<T, V, 8, 1>);
      case 16: return reinterpret_cast<const void*>(&decode<T, V, 16, 1>);
      case 32: return reinterpret_cast<const void*>(&decode<T, V, 32, 1>);
    }
  }
  if (lanes == 32 && vecs == 2)
    return reinterpret_cast<const void*>(&decode<T, V, 32, 2>);
  return nullptr;
}

template <typename T>
const void* pick(int vec_bytes, int lanes, int vecs) {
  switch (vec_bytes) {
    case 16: return pick_lanes<T, uint4>(lanes, vecs);
    case 8: return pick_lanes<T, uint2>(lanes, vecs);
    case 4: return pick_lanes<T, unsigned>(lanes, vecs);
    case 2:
      if constexpr (sizeof(T) == 2)
        return pick_lanes<T, unsigned short>(lanes, vecs);
  }
  return nullptr;
}

}  // namespace

// dtype: 0 = fp32, 1 = bf16, of q, k, v and out; all contiguous.
// vec_bytes, lanes, vecs: the kernel's sizeof(V), kLanes and kVecs
// (kernel.py::route; vec_bytes divides Dh's bytes and k's and v's
// alignment). rows, chunks: the split (chunks == 1: none; else at most
// 32, partials holds B H chunks slot_floats(Dh) floats, 16-byte aligned,
// and tickets B H unsigneds that are 0 between launches). window <= 0
// means no sliding window. Returns cudaGetLastError() after the launch.
extern "C" int decode_attention_launch(
    const void* q, const void* k, const void* v, const void* pos, void* out,
    void* partials, void* tickets, int B, int C, int H, int Dh, int window,
    float scale, int dtype, int vec_bytes, int lanes, int vecs, int rows,
    int chunks, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || H <= 0 || C <= 0 || Dh <= 0) return 0;
  const void* kern = dtype == 0 ? pick<float>(vec_bytes, lanes, vecs)
                                : pick<__nv_bfloat16>(vec_bytes, lanes, vecs);
  const int elem = dtype == 0 ? 4 : 2;
  if (kern == nullptr || (Dh * elem) % vec_bytes || rows <= 0 ||
      chunks <= 0 || chunks > 32)
    return static_cast<int>(cudaErrorInvalidValue);
  // a warp an item (bh, chunk, slice); a one-vector instance takes no
  // slices
  const int64_t nv = Dh * elem / vec_bytes, slice = lanes * vecs;
  const int64_t items = static_cast<int64_t>(B) * H * chunks *
                        ((nv + slice - 1) / slice);
  if ((vecs == 1 && nv > lanes) || items > INT_MAX - kWarps)
    return static_cast<int>(cudaErrorInvalidValue);
  // the kernels' parameters, in order (the pointers' bits are their T's)
  void* args[] = {&q, &k, &v, &pos, &out, &partials, &tickets, &B, &C,
                  &H, &Dh, &window, &scale, &rows, &chunks};
  const unsigned blocks = static_cast<unsigned>((items + kWarps - 1) / kWarps);
  cudaLaunchKernel(kern, dim3(blocks), dim3(kThreads), args, 0, s);
  return static_cast<int>(cudaGetLastError());
}
