// GQA decode attention for Hopper (sm_90a): one query token per sequence
// against a KV cache, online softmax in float32.
//
// Replaces the Pallas TPU kernel src/repro/kernels/decode_attention/
// kernel.py (_decode_attn_kernel, launched by decode_attention_grouped).
// The TPU version walks the cache's S blocks in order on one core, carrying
// (m, l, acc) in VMEM scratch, and pads G to 8 sublanes and D to 128 lanes
// for the MXU.  On Hopper the S axis is split across blocks instead (a
// split-S pass and a combine pass), and nothing is padded:
//
//   pass 1, grid (B * KvH, ceil(G / GC), nsplit), 4 warps a block: a block
//     serves one (b, kv head), up to GC query heads of its group, and one
//     contiguous range of cache rows.  The GC query heads share every K/V
//     row the block loads.  Warp w takes rows w, w + 4, ...; a lane holds
//     head-dim elements lane + 32 i (coalesced loads) and the warp sums the
//     dot product by shuffles.  Rows outside [len - window, len) (and past
//     S) are never loaded: the loop runs over the valid range only.  The
//     four warps' (m, l, acc) are merged in shared memory and written, not
//     yet normalised, to float32 scratch.
//   pass 2, grid B * H: merges the splits, out = acc / max(l, 1e-30), cast
//     to q's dtype.  A row with no valid position has l = 0 and returns 0,
//     as the reference's max(l, 1e-30) does.
//
// Types: q float32 or bf16, cache float32 or bf16 (independently: the
// serving engine keeps a float32 cache under bf16 activations), float32
// arithmetic throughout.  D <= 256, any G = H / KvH.
//
// Bound on an H100: it reads each valid K and V row once (2 * len * KvH * D
// elements per sequence) and does 4 * G flops per element read, far below
// the ~295 flops a byte at which the tensor cores would bound it, so it is
// bound by bytes (3.35 TB/s).  The design's answer is to read only valid
// rows, share each row across the G query heads, and split S so that enough
// blocks are in flight to keep the memory system busy at batch 8.  It uses
// no tensor cores, TMA or cp.async yet.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int DPL = 8;          // head-dim elements per lane: D <= 256
constexpr float NEG = -1e30f;   // the reference kernel's masked score

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);   // round to nearest even, as torch's cast
}

template <int GC, typename TQ, typename TK>
__global__ void __launch_bounds__(THREADS) decode_split_kernel(
    const TQ* __restrict__ q, const TK* __restrict__ k,
    const TK* __restrict__ v, const int* __restrict__ lengths,
    float* __restrict__ part_ml, float* __restrict__ part_acc, int H,
    int KvH, int S, int D, int window, float scale, int nsplit,
    int split_len) {
  __shared__ float sm_ml[WARPS][GC][2];
  __shared__ float sm_acc[WARPS][GC][DPL * 32];

  const int b = blockIdx.x / KvH;
  const int kvh = blockIdx.x % KvH;
  const int G = H / KvH;
  const int g0 = blockIdx.y * GC;
  const int split = blockIdx.z;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  const int len = lengths[b];
  int lo = 0;
  if (window > 0) lo = max(lo, len - window);
  const int hi = min(len, S);
  const int s_begin = max(lo, split * split_len);
  const int s_end = min(hi, (split + 1) * split_len);

  float qr[GC][DPL];
#pragma unroll
  for (int g = 0; g < GC; ++g) {
    const int h = kvh * G + g0 + g;
#pragma unroll
    for (int i = 0; i < DPL; ++i) {
      const int d = lane + 32 * i;
      qr[g][i] = (g0 + g < G && d < D)
                     ? to_f(q[(static_cast<int64_t>(b) * H + h) * D + d])
                     : 0.f;
    }
  }
  float m[GC], l[GC], acc[GC][DPL];
#pragma unroll
  for (int g = 0; g < GC; ++g) {
    m[g] = NEG;
    l[g] = 0.f;
#pragma unroll
    for (int i = 0; i < DPL; ++i) acc[g][i] = 0.f;
  }

  for (int s = s_begin + warp; s < s_end; s += WARPS) {
    const int64_t row = ((static_cast<int64_t>(b) * S + s) * KvH + kvh) * D;
    float kr[DPL], vr[DPL];
#pragma unroll
    for (int i = 0; i < DPL; ++i) {
      const int d = lane + 32 * i;
      kr[i] = d < D ? to_f(k[row + d]) : 0.f;
      vr[i] = d < D ? to_f(v[row + d]) : 0.f;
    }
#pragma unroll
    for (int g = 0; g < GC; ++g) {
      float part = 0.f;
#pragma unroll
      for (int i = 0; i < DPL; ++i) part += qr[g][i] * kr[i];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        part += __shfl_xor_sync(0xffffffffu, part, off);
      const float sc = part * scale;
      const float m_new = fmaxf(m[g], sc);
      const float alpha = expf(m[g] - m_new);
      const float p = expf(sc - m_new);
      l[g] = l[g] * alpha + p;
#pragma unroll
      for (int i = 0; i < DPL; ++i) acc[g][i] = acc[g][i] * alpha + p * vr[i];
      m[g] = m_new;
    }
  }

#pragma unroll
  for (int g = 0; g < GC; ++g) {
    if (lane == 0) {
      sm_ml[warp][g][0] = m[g];
      sm_ml[warp][g][1] = l[g];
    }
#pragma unroll
    for (int i = 0; i < DPL; ++i) sm_acc[warp][g][lane + 32 * i] = acc[g][i];
  }
  __syncthreads();

  for (int idx = threadIdx.x; idx < GC * D; idx += THREADS) {
    const int g = idx / D;
    const int d = idx - g * D;
    if (g0 + g >= G) break;
    float mx = NEG;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) mx = fmaxf(mx, sm_ml[w][g][0]);
    float lsum = 0.f, asum = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const float c = expf(sm_ml[w][g][0] - mx);
      lsum += sm_ml[w][g][1] * c;
      asum += sm_acc[w][g][d] * c;
    }
    const int64_t slot =
        (static_cast<int64_t>(b) * H + kvh * G + g0 + g) * nsplit + split;
    part_acc[slot * D + d] = asum;
    if (d == 0) {
      part_ml[slot * 2] = mx;
      part_ml[slot * 2 + 1] = lsum;
    }
  }
}

template <typename TQ>
__global__ void __launch_bounds__(THREADS) decode_combine_kernel(
    const float* __restrict__ part_ml, const float* __restrict__ part_acc,
    TQ* __restrict__ out, int D, int nsplit) {
  const int64_t bh = blockIdx.x;
  const float* ml = part_ml + bh * nsplit * 2;
  float mx = NEG;
  for (int j = 0; j < nsplit; ++j) mx = fmaxf(mx, ml[2 * j]);
  float lsum = 0.f;
  for (int j = 0; j < nsplit; ++j) lsum += ml[2 * j + 1] * expf(ml[2 * j] - mx);
  const float denom = fmaxf(lsum, 1e-30f);
  for (int d = threadIdx.x; d < D; d += THREADS) {
    float a = 0.f;
    for (int j = 0; j < nsplit; ++j)
      a += part_acc[(bh * nsplit + j) * D + d] * expf(ml[2 * j] - mx);
    out[bh * D + d] = from_f<TQ>(a / denom);
  }
}

template <int GC, typename TQ, typename TK>
int launch(const void* q, const void* k, const void* v, const int* lengths,
           void* out, float* part_ml, float* part_acc, int B, int H, int KvH,
           int S, int D, int window, float scale, int nsplit,
           cudaStream_t stream) {
  const int G = H / KvH;
  const int split_len = (S + nsplit - 1) / nsplit;
  dim3 grid(B * KvH, (G + GC - 1) / GC, nsplit);
  decode_split_kernel<GC, TQ, TK><<<grid, THREADS, 0, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TK*>(k),
      static_cast<const TK*>(v), lengths, part_ml, part_acc, H, KvH, S, D,
      window, scale, nsplit, split_len);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  decode_combine_kernel<TQ><<<B * H, THREADS, 0, stream>>>(
      part_ml, part_acc, static_cast<TQ*>(out), D, nsplit);
  return static_cast<int>(cudaGetLastError());
}

template <typename TQ, typename TK>
int dispatch_g(int gc, const void* q, const void* k, const void* v,
               const int* lengths, void* out, float* part_ml,
               float* part_acc, int B, int H, int KvH, int S, int D,
               int window, float scale, int nsplit, cudaStream_t stream) {
#define DA_CASE(N)                                                          \
  case N:                                                                   \
    return launch<N, TQ, TK>(q, k, v, lengths, out, part_ml, part_acc, B, H, \
                             KvH, S, D, window, scale, nsplit, stream);
  switch (gc) {
    DA_CASE(1)
    DA_CASE(2)
    DA_CASE(4)
    DA_CASE(8)
  }
#undef DA_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Plain C entry point (loaded with ctypes).  Launches both passes on
// `stream`, does not synchronise, allocates nothing: `part_ml`
// ([B, H, nsplit, 2] float32) and `part_acc` ([B, H, nsplit, D] float32)
// are the caller's scratch.  `gc` (1, 2, 4 or 8) is the number of query
// heads a block serves.  Returns the first non-zero cudaGetLastError() of
// the two launches, or cudaErrorInvalidValue for an unsupported shape.
extern "C" int decode_attention_launch(int q_bf16, int kv_bf16, int gc,
                                       const void* q, const void* k,
                                       const void* v, const int* lengths,
                                       void* out, float* part_ml,
                                       float* part_acc, int B, int H, int KvH,
                                       int S, int D, int window, float scale,
                                       int nsplit, void* stream) {
  if (B <= 0 || H <= 0) return 0;
  if (KvH <= 0 || H % KvH != 0 || D <= 0 || D > DPL * 32 || S <= 0 ||
      nsplit <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (q_bf16) {
    if (kv_bf16)
      return dispatch_g<__nv_bfloat16, __nv_bfloat16>(
          gc, q, k, v, lengths, out, part_ml, part_acc, B, H, KvH, S, D,
          window, scale, nsplit, st);
    return dispatch_g<__nv_bfloat16, float>(gc, q, k, v, lengths, out,
                                            part_ml, part_acc, B, H, KvH, S,
                                            D, window, scale, nsplit, st);
  }
  if (kv_bf16)
    return dispatch_g<float, __nv_bfloat16>(gc, q, k, v, lengths, out,
                                            part_ml, part_acc, B, H, KvH, S,
                                            D, window, scale, nsplit, st);
  return dispatch_g<float, float>(gc, q, k, v, lengths, out, part_ml,
                                  part_acc, B, H, KvH, S, D, window, scale,
                                  nsplit, st);
}
