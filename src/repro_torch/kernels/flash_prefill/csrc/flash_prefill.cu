// Causal GQA flash attention forward (prefill) for Hopper (sm_90a), with
// sliding-window and chunked-local masks.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_prefill/kernel.py
// (_flash_kernel, launched by flash_prefill_flat).  The TPU version runs a
// grid (B * H, Sq / BQ, Sk / BK) whose KV axis is walked in order on one
// core with (m, l, acc) in VMEM scratch, after its wrapper has repeated
// every KV head G times (ops.py:45-48) and padded D to 128.  Here:
//
//   grid (ceil(Sq / 64), H, B), 256 threads: a block owns 64 query rows of
//   one head and loops over 32-row K/V tiles itself.  The KV head is
//   indexed as h / G, so nothing is repeated or padded.  Q, K and V tiles
//   are held in shared memory as float32 (rows padded by one element
//   against bank conflicts; about 137 KB at D = 256, so one block an SM).
//   Thread (ty, tx) = (tid / 8, tid % 8) owns query rows 2 ty and 2 ty + 1:
//   it computes their scores against keys tx + 8 j (j < 4), and their
//   output columns tx + 8 i, so the row's running max and sum rescale only
//   its own registers; the 8 threads of a row reduce by warp shuffles.
//   Only the KV tiles that some query of the block can reach under the
//   causal, window and chunk masks are visited (the range is computed
//   once), and the element mask is applied only on tiles that cross a mask
//   boundary or the end of the sequence.
//
// Types: q, k, v float32 or bf16; float32 accumulation; output in q's
// dtype.  D <= 256.  Query i sits at position i and key j at position j,
// as in the reference; a row with no reachable key returns 0.
//
// Bound on an H100: 4 * D flops for each reachable (query, key) pair per
// head against one read of Q, K, V and one write of O, so at the model's
// sequence lengths it is bound by operations.  This first version does
// them in float32 on the CUDA cores (67 TFLOP/s peak), not on the tensor
// cores (989 TFLOP/s bf16) that the bound counts: wgmma, TMA and warp
// specialisation are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;          // query rows a block
constexpr int BK = 32;          // keys a tile
constexpr int THREADS = 256;
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
  return __float2bfloat16(x);
}

__host__ __device__ constexpr int smem_floats(int D) {
  return BQ * (D + 1) + BK * (D + 1) + BK * D + BQ * (BK + 1);
}

// DPT: output columns a thread owns, ceil(D / 8) rounded up to 8, 16 or 32
template <int DPT, typename TQ, typename TK>
__global__ void __launch_bounds__(THREADS) flash_prefill_kernel(
    const TQ* __restrict__ q, const TK* __restrict__ k,
    const TK* __restrict__ v, TQ* __restrict__ out, int Sq, int Sk, int H,
    int KvH, int D, int window, int chunk, int causal, float scale) {
  extern __shared__ float smem[];
  const int ldq = D + 1;
  float* Qs = smem;                 // [BQ][D + 1]
  float* Ks = Qs + BQ * ldq;        // [BK][D + 1]
  float* Vs = Ks + BK * ldq;        // [BK][D]
  float* Ps = Vs + BK * D;          // [BQ][BK + 1]

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KvH);
  const int tid = threadIdx.x;
  const int tx = tid & 7;
  const int r0 = 2 * (tid >> 3);

  for (int idx = tid; idx < BQ * D; idx += THREADS) {
    const int r = idx / D;
    const int d = idx - r * D;
    const int qi = q0 + r;
    Qs[r * ldq + d] =
        qi < Sq ? to_f(q[((static_cast<int64_t>(b) * Sq + qi) * H + h) * D + d])
                : 0.f;
  }

  // keys some query of this block can reach: [k_lo, k_hi)
  const int q_last = min(q0 + BQ, Sq) - 1;
  int k_lo = 0, k_hi = Sk;
  if (causal) {
    k_hi = min(k_hi, q_last + 1);
    if (window > 0) k_lo = max(k_lo, q0 - window + 1);
    if (chunk > 0) {
      k_lo = max(k_lo, (q0 / chunk) * chunk);
      k_hi = min(k_hi, (q_last / chunk + 1) * chunk);
    }
  }

  float m[2] = {NEG, NEG}, l[2] = {0.f, 0.f};
  float acc[2][DPT];
#pragma unroll
  for (int i = 0; i < DPT; ++i) acc[0][i] = acc[1][i] = 0.f;

  for (int k0 = (k_lo / BK) * BK; k0 < k_hi; k0 += BK) {
    __syncthreads();   // the previous tile's K, V and P are no longer read
    for (int idx = tid; idx < BK * D; idx += THREADS) {
      const int c = idx / D;
      const int d = idx - c * D;
      const int kj = k0 + c;
      const int64_t off =
          ((static_cast<int64_t>(b) * Sk + kj) * KvH + kvh) * D + d;
      Ks[c * ldq + d] = kj < Sk ? to_f(k[off]) : 0.f;
      Vs[c * D + d] = kj < Sk ? to_f(v[off]) : 0.f;
    }
    __syncthreads();

    float s[2][4];
#pragma unroll
    for (int j = 0; j < 4; ++j) s[0][j] = s[1][j] = 0.f;
    for (int d = 0; d < D; ++d) {
      const float a0 = Qs[r0 * ldq + d];
      const float a1 = Qs[(r0 + 1) * ldq + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float kk = Ks[(tx + 8 * j) * ldq + d];
        s[0][j] += a0 * kk;
        s[1][j] += a1 * kk;
      }
    }

    // a tile strictly inside every mask needs no element mask
    bool inside = k0 + BK <= Sk;
    if (causal) {
      inside = inside && k0 + BK - 1 <= q0;
      if (window > 0) inside = inside && q_last - k0 < window;
      if (chunk > 0)
        inside = inside && k0 / chunk == q_last / chunk &&
                 (k0 + BK - 1) / chunk == q0 / chunk;
    }
    bool ok[2][4];
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int qi = q0 + r0 + rr;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kj = k0 + tx + 8 * j;
        bool valid = true;
        if (!inside) {
          valid = kj < Sk;
          if (causal) {
            valid = valid && kj <= qi;
            if (window > 0) valid = valid && qi - kj < window;
            if (chunk > 0) valid = valid && qi / chunk == kj / chunk;
          }
        }
        ok[rr][j] = valid;
        s[rr][j] = valid ? s[rr][j] * scale : NEG;
      }
    }

#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      float mx = fmaxf(fmaxf(s[rr][0], s[rr][1]), fmaxf(s[rr][2], s[rr][3]));
#pragma unroll
      for (int off = 1; off < 8; off <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[rr], mx);
      const float alpha = expf(m[rr] - m_new);
      float rowsum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = ok[rr][j] ? expf(s[rr][j] - m_new) : 0.f;
        Ps[(r0 + rr) * (BK + 1) + tx + 8 * j] = p;
        rowsum += p;
      }
#pragma unroll
      for (int off = 1; off < 8; off <<= 1)
        rowsum += __shfl_xor_sync(0xffffffffu, rowsum, off);
      l[rr] = l[rr] * alpha + rowsum;
      m[rr] = m_new;
#pragma unroll
      for (int i = 0; i < DPT; ++i) acc[rr][i] *= alpha;
    }
    __syncthreads();

    for (int c = 0; c < BK; ++c) {
      const float p0 = Ps[r0 * (BK + 1) + c];
      const float p1 = Ps[(r0 + 1) * (BK + 1) + c];
#pragma unroll
      for (int i = 0; i < DPT; ++i) {
        const int d = tx + 8 * i;
        if (d < D) {
          const float vv = Vs[c * D + d];
          acc[0][i] += p0 * vv;
          acc[1][i] += p1 * vv;
        }
      }
    }
  }

#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int qi = q0 + r0 + rr;
    if (qi >= Sq) continue;
    const float denom = fmaxf(l[rr], 1e-30f);
    TQ* orow = out + ((static_cast<int64_t>(b) * Sq + qi) * H + h) * D;
#pragma unroll
    for (int i = 0; i < DPT; ++i) {
      const int d = tx + 8 * i;
      if (d < D) orow[d] = from_f<TQ>(acc[rr][i] / denom);
    }
  }
}

template <int DPT, typename TQ, typename TK>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int Sq, int Sk, int H, int KvH, int D, int window, int chunk,
           int causal, float scale, cudaStream_t stream) {
  auto kern = flash_prefill_kernel<DPT, TQ, TK>;
  const int bytes = smem_floats(D) * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((Sq + BQ - 1) / BQ, H, B);
  kern<<<grid, THREADS, bytes, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TK*>(k),
      static_cast<const TK*>(v), static_cast<TQ*>(out), Sq, Sk, H, KvH, D,
      window, chunk, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename TQ, typename TK>
int dispatch_d(const void* q, const void* k, const void* v, void* out, int B,
               int Sq, int Sk, int H, int KvH, int D, int window, int chunk,
               int causal, float scale, cudaStream_t st) {
  if (D <= 64)
    return launch<8, TQ, TK>(q, k, v, out, B, Sq, Sk, H, KvH, D, window,
                             chunk, causal, scale, st);
  if (D <= 128)
    return launch<16, TQ, TK>(q, k, v, out, B, Sq, Sk, H, KvH, D, window,
                              chunk, causal, scale, st);
  return launch<32, TQ, TK>(q, k, v, out, B, Sq, Sk, H, KvH, D, window,
                            chunk, causal, scale, st);
}

}  // namespace

// Plain C entry point (loaded with ctypes).  q [B, Sq, H, D], k / v
// [B, Sk, KvH, D], out [B, Sq, H, D] (q's dtype), all contiguous.  Launches
// on `stream`, does not synchronise, allocates nothing.  Returns
// cudaGetLastError() of the launch (or of the shared-memory attribute), or
// cudaErrorInvalidValue for an unsupported shape.
extern "C" int flash_prefill_launch(int q_bf16, int kv_bf16, const void* q,
                                    const void* k, const void* v, void* out,
                                    int B, int Sq, int Sk, int H, int KvH,
                                    int D, int window, int chunk, int causal,
                                    float scale, void* stream) {
  if (B <= 0 || Sq <= 0 || H <= 0) return 0;
  if (KvH <= 0 || H % KvH != 0 || D <= 0 || D > 256 || Sk < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (q_bf16) {
    if (kv_bf16)
      return dispatch_d<__nv_bfloat16, __nv_bfloat16>(
          q, k, v, out, B, Sq, Sk, H, KvH, D, window, chunk, causal, scale,
          st);
    return dispatch_d<__nv_bfloat16, float>(q, k, v, out, B, Sq, Sk, H, KvH,
                                            D, window, chunk, causal, scale,
                                            st);
  }
  if (kv_bf16)
    return dispatch_d<float, __nv_bfloat16>(q, k, v, out, B, Sq, Sk, H, KvH,
                                            D, window, chunk, causal, scale,
                                            st);
  return dispatch_d<float, float>(q, k, v, out, B, Sq, Sk, H, KvH, D, window,
                                  chunk, causal, scale, st);
}
