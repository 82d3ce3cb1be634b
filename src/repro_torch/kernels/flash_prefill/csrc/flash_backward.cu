// Gradient of GQA flash attention (flash_prefill.cu's function) for Hopper
// (sm_90a): dQ, dK and dV from (q, k, v, o, lse, dO) under the causal,
// sliding-window, chunked-local or no mask.
//
// Replaces no Pallas kernel: the TPU kernel src/repro/kernels/flash_prefill/
// kernel.py (_flash_kernel) has no backward, and the JAX package trains
// through XLA's autodiff of the jnp online-softmax flash_attention
// (src/repro/models/layers.py:70).  The port runs attention through its
// hand-written forward kernel, whose output autograd cannot see into, so
// training needs this gradient as a kernel of its own.
//
// The math, with s = scale q.k and P = exp(s - lse) recomputed from the
// forward's natural log-sum-exp (lse [B, H, Sq] float32, -inf for a row
// that reached no key, whose gradient is then 0):
//   Di = rowsum(dO * O),  dP = dO V^T,  dS = P (dP - Di),
//   dV = P^T dO,  dK = scale dS^T Q,  dQ = scale dS K.
//
// Bound on an H100: 10 D flops for each reachable (query, key) pair and
// query head (S = Q K^T, dP = dO V^T, dV, dK, dQ; 2 D each) against one read
// of q, k, v, o, dO and lse and one write of dq, dk, dv.  At starcoder2-3b's
// 4096 tokens (24 / 2 heads of 128) that is about 900 flops a byte: the
// products bound it, at the bf16 tensor-core peak (989 TFLOP/s; the float32
// CUDA cores' 67 are 15 times below).
//
// Two families, chosen by the wrapper (ops.backward_path):
//
// * bf16 operands, D <= 256 (the models' path): the tensor-core kernels,
//   three launches a call, no atomics, the same result run to run:
//   1. flash_backward_dq_tc_kernel<D16>: a CTA owns 64 query rows of one
//      head per consumer warpgroup (two consumers at D <= 128, one at 256),
//      latest query blocks first (the causal triangle's heaviest).  It
//      computes Di = rowsum(dO O) and the LSE in log2 units for its rows
//      (8 threads a row, shuffles in a fixed order) and writes both, padded
//      to whole 64-row tiles (+inf and 0 on the pad, so a padded query
//      contributes P = 0), for launch 2.  Q and dO arrive once by TMA; the
//      K and V tiles its rows reach stream through a TMA ring.  S = Q K^T
//      and dP = dO V^T are recomputed with wgmma m64n64k16 (both operands
//      K-major in shared memory), P and dS = P (dP - Di) formed in
//      registers, and dQ += dS K runs with dS from registers (bf16, the
//      accumulator's layout is the A-operand layout) and K as the
//      transposed (MN-major) operand.  dQ stays in float32 registers: 64 x
//      256 a warpgroup at D 256, as the forward's O accumulator.
//   2. flash_backward_dkdv_tc_kernel<D16>: a CTA owns 64 keys per consumer
//      warpgroup (128 at D <= 128) of one KV head and a slice of its G
//      query heads (`splits` slices, chosen by ops.dkdv_splits so the
//      heaviest CTA is no longer than an SM's mean share of the work); at
//      D 256 also one half of the 256 output columns.  K and V arrive once
//      by TMA.  The producer streams, for each head of the slice and each
//      query tile that reaches the block, the Q and dO tiles and their LSE
//      and Di rows into the ring.  A consumer computes S^T = K Q^T and
//      dP^T = V dO^T with wgmma, forms P^T and dS^T in registers (the
//      element mask only on tiles that cross a mask boundary), rounds both
//      to bf16 A operands and accumulates dV += P^T dO and dK += dS^T Q with
//      wgmma (dO, Q transposed), only its own columns at D 256 (S^T and
//      dP^T are recomputed over the whole head by both halves).  Key blocks
//      are launched lowest first, the causal triangle's heaviest.  Each
//      slice writes float32 partial sums [2, splits, B, Sk, KvH, D].
//   3. flash_backward_dkdv_reduce_kernel: adds the slices' partials in
//      slice order and writes bf16 dK and dV (no atomics: two runs agree
//      bit for bit).
//   Every tensor-core CTA is one producer warpgroup, whose one thread keeps
//   TMA loads in flight into 2 (D 256) or 3 stages of 128-byte-swizzled
//   panels with full and empty mbarriers and gives its registers to the
//   consumers (setmaxnreg 24 / 240 with two consumers), and the consumer
//   warpgroups.  D is padded with zero columns (TMA's out-of-bounds fill)
//   to the next of 64, 80, 128 and 256; the wrapper pads it to a multiple
//   of 8 and aligns the pointers to 16 bytes.
// * float32 operands (the reduced configs' training): the CUDA-core pair
//   flash_backward_{dq,dkdv}_kernel, two launches a call, float32 products
//   from shared memory:
//   - flash_backward_dq_kernel, grid (ceil(Sq / 64), H, B), 256 threads:
//     a block owns 64 query rows of one head.  It loads Q and dO as
//     float32 into shared memory, computes Di for its rows (written to `di`
//     for the second launch), then walks the 32-key K / V tiles its rows
//     reach, recomputes S and dP, and accumulates dQ in registers.  Thread
//     (ty, tx) = (tid / 8, tid % 8) owns query rows 2 ty and 2 ty + 1, score
//     columns tx + 8 j and output columns tx + 8 i; the 8 threads of a row
//     reduce by warp shuffles.
//   - flash_backward_dkdv_kernel, grid (ceil(Sk / 32), KvH, B), 256
//     threads: a block owns 32 keys of one KV head and accumulates their dK
//     and dV in registers over the G query heads of that KV head and over
//     every 64-row query tile that reaches its keys (so the sum over the
//     group needs no atomics).  S, dP and dS are computed in the same
//     layout as above and staged in shared memory; thread (kr, tx) =
//     (tid / 8, tid % 8) then owns key row kr and columns tx + 8 i of dK
//     and dV.
//
// Every sum is float32; gradients are written in the operands' type.
// What held a first, warp-level (mma.sync) design, and the answer here:
// one dK / dV wave of CTAs each walking all G heads over a causal tail
// (now head slices, several waves, heaviest first); loads that waited for
// products (now a TMA ring); mma.sync (now wgmma); D 256 on the CUDA
// cores (now column halves on the tensor cores).  What remains
// (PERF.md): the dQ launch recomputes S and dP (14 D flops a pair against
// the bound's 10 D); inside a warpgroup the products and the elementwise
// work between them run one after the other (only the second warpgroup of
// a CTA overlaps them); CTAs are not persistent; the partial sums make a
// round trip through device memory.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <initializer_list>

#include "hopper_ptx.cuh"
#include "tma_map.cuh"

namespace {

constexpr int BQ = 64;          // query rows a tile
constexpr int BK = 32;          // keys a tile
constexpr int THREADS = 256;

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

struct Mask {
  int Sq, Sk, window, chunk, causal;
  // whether query position i reaches key position j
  __device__ __forceinline__ bool ok(int i, int j) const {
    if (i >= Sq || j >= Sk) return false;
    if (!causal) return true;
    if (j > i) return false;
    if (window > 0 && i - j >= window) return false;
    if (chunk > 0 && i / chunk != j / chunk) return false;
    return true;
  }
};

// rows [r0, r0 + n) of a [*, D] tile of head h into shared memory as
// float32 with row stride D + 1; zeros past `rows`
template <typename T>
__device__ __forceinline__ void load_rows(float* dst, const T* __restrict__ src,
                                          int b, int r0, int rows, int heads,
                                          int h, int D, int n) {
  const int ld = D + 1;
  for (int idx = threadIdx.x; idx < n * D; idx += THREADS) {
    const int r = idx / D;
    const int d = idx - r * D;
    const int row = r0 + r;
    dst[r * ld + d] =
        row < rows
            ? to_f(src[((static_cast<int64_t>(b) * rows + row) * heads + h) *
                           D + d])
            : 0.f;
  }
}

__host__ __device__ constexpr int dq_smem_floats(int D) {
  return 2 * BQ * (D + 1) + 2 * BK * (D + 1) + BQ * (BK + 1);
}

__host__ __device__ constexpr int dkdv_smem_floats(int D) {
  return 2 * BK * (D + 1) + 2 * BQ * (D + 1) + 2 * BQ * (BK + 1) + 2 * BQ;
}

// DPT: output columns a thread owns, ceil(D / 8) rounded up to 8, 16 or 32
template <int DPT, typename T>
__global__ void __launch_bounds__(THREADS) flash_backward_dq_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ o, const float* __restrict__ lse,
    const T* __restrict__ dout, T* __restrict__ dq, float* __restrict__ di,
    int H, int KvH, int D, Mask mk, float scale) {
  extern __shared__ float smem[];
  const int ld = D + 1;
  float* Qs = smem;                 // [BQ][D + 1]
  float* dOs = Qs + BQ * ld;        // [BQ][D + 1]
  float* Ks = dOs + BQ * ld;        // [BK][D + 1]
  float* Vs = Ks + BK * ld;         // [BK][D + 1]
  float* dSs = Vs + BK * ld;        // [BQ][BK + 1]

  const int Sq = mk.Sq, Sk = mk.Sk;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KvH);
  const int tid = threadIdx.x;
  const int tx = tid & 7;
  const int r0 = 2 * (tid >> 3);

  load_rows(Qs, q, b, q0, Sq, H, h, D, BQ);
  load_rows(dOs, dout, b, q0, Sq, H, h, D, BQ);
  __syncthreads();

  // Di = rowsum(dO * O) and the LSE of this thread's two rows
  float di_r[2], lse_r[2];
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int qi = q0 + r0 + rr;
    float part = 0.f;
    if (qi < Sq) {
      const T* orow = o + ((static_cast<int64_t>(b) * Sq + qi) * H + h) * D;
#pragma unroll
      for (int i = 0; i < DPT; ++i) {
        const int d = tx + 8 * i;
        if (d < D) part += dOs[(r0 + rr) * ld + d] * to_f(orow[d]);
      }
    }
#pragma unroll
    for (int off = 1; off < 8; off <<= 1)
      part += __shfl_xor_sync(0xffffffffu, part, off);
    di_r[rr] = part;
    const int64_t row = (static_cast<int64_t>(b) * H + h) * Sq + qi;
    lse_r[rr] = qi < Sq ? lse[row] : -INFINITY;
    if (qi < Sq && tx == 0) di[row] = part;
  }

  // keys some query of this block can reach: [k_lo, k_hi)
  const int q_last = min(q0 + BQ, Sq) - 1;
  int k_lo = 0, k_hi = Sk;
  if (mk.causal) {
    k_hi = min(k_hi, q_last + 1);
    if (mk.window > 0) k_lo = max(k_lo, q0 - mk.window + 1);
    if (mk.chunk > 0) {
      k_lo = max(k_lo, (q0 / mk.chunk) * mk.chunk);
      k_hi = min(k_hi, (q_last / mk.chunk + 1) * mk.chunk);
    }
  }

  float acc[2][DPT];
#pragma unroll
  for (int i = 0; i < DPT; ++i) acc[0][i] = acc[1][i] = 0.f;

  for (int k0 = (k_lo / BK) * BK; k0 < k_hi; k0 += BK) {
    __syncthreads();   // the previous tile's K, V and dS are no longer read
    load_rows(Ks, k, b, k0, Sk, KvH, kvh, D, BK);
    load_rows(Vs, v, b, k0, Sk, KvH, kvh, D, BK);
    __syncthreads();

    float s[2][4], dp[2][4];
#pragma unroll
    for (int j = 0; j < 4; ++j) s[0][j] = s[1][j] = dp[0][j] = dp[1][j] = 0.f;
    for (int d = 0; d < D; ++d) {
      const float a0 = Qs[r0 * ld + d];
      const float a1 = Qs[(r0 + 1) * ld + d];
      const float g0 = dOs[r0 * ld + d];
      const float g1 = dOs[(r0 + 1) * ld + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float kk = Ks[(tx + 8 * j) * ld + d];
        const float vv = Vs[(tx + 8 * j) * ld + d];
        s[0][j] += a0 * kk;
        s[1][j] += a1 * kk;
        dp[0][j] += g0 * vv;
        dp[1][j] += g1 * vv;
      }
    }
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int qi = q0 + r0 + rr;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 8 * j;
        const bool valid = mk.ok(qi, k0 + c) && lse_r[rr] > -INFINITY;
        const float p = valid ? expf(s[rr][j] * scale - lse_r[rr]) : 0.f;
        dSs[(r0 + rr) * (BK + 1) + c] = p * (dp[rr][j] - di_r[rr]) * scale;
      }
    }
    __syncthreads();

    for (int c = 0; c < BK; ++c) {
      const float d0 = dSs[r0 * (BK + 1) + c];
      const float d1 = dSs[(r0 + 1) * (BK + 1) + c];
#pragma unroll
      for (int i = 0; i < DPT; ++i) {
        const int d = tx + 8 * i;
        if (d < D) {
          const float kk = Ks[c * ld + d];
          acc[0][i] += d0 * kk;
          acc[1][i] += d1 * kk;
        }
      }
    }
  }

#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int qi = q0 + r0 + rr;
    if (qi >= Sq) continue;
    T* row = dq + ((static_cast<int64_t>(b) * Sq + qi) * H + h) * D;
#pragma unroll
    for (int i = 0; i < DPT; ++i) {
      const int d = tx + 8 * i;
      if (d < D) row[d] = from_f<T>(acc[rr][i]);
    }
  }
}

template <int DPT, typename T>
__global__ void __launch_bounds__(THREADS) flash_backward_dkdv_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const float* __restrict__ lse, const T* __restrict__ dout,
    const float* __restrict__ di, T* __restrict__ dk, T* __restrict__ dv,
    int H, int KvH, int D, Mask mk, float scale) {
  extern __shared__ float smem[];
  const int ld = D + 1;
  float* Ks = smem;                 // [BK][D + 1]
  float* Vs = Ks + BK * ld;         // [BK][D + 1]
  float* Qs = Vs + BK * ld;         // [BQ][D + 1]
  float* dOs = Qs + BQ * ld;        // [BQ][D + 1]
  float* Ps = dOs + BQ * ld;        // [BQ][BK + 1]
  float* dSs = Ps + BQ * (BK + 1);  // [BQ][BK + 1]
  float* lse_s = dSs + BQ * (BK + 1);  // [BQ]
  float* di_s = lse_s + BQ;            // [BQ]

  const int Sq = mk.Sq, Sk = mk.Sk;
  const int G = H / KvH;
  const int k0 = blockIdx.x * BK;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int tx = tid & 7;
  const int r0 = 2 * (tid >> 3);     // score rows of this thread
  const int kr = tid >> 3;           // dK / dV row of this thread

  load_rows(Ks, k, b, k0, Sk, KvH, kvh, D, BK);
  load_rows(Vs, v, b, k0, Sk, KvH, kvh, D, BK);

  // queries that reach some key of this block: [q_lo, q_hi)
  const int k_last = min(k0 + BK, Sk) - 1;
  int q_lo = 0, q_hi = Sq;
  if (mk.causal) {
    q_lo = k0;
    if (mk.window > 0) q_hi = min(q_hi, k_last + mk.window);
    if (mk.chunk > 0) {
      q_lo = max(q_lo, (k0 / mk.chunk) * mk.chunk);
      q_hi = min(q_hi, (k_last / mk.chunk + 1) * mk.chunk);
    }
  }

  float acc_k[DPT], acc_v[DPT];
#pragma unroll
  for (int i = 0; i < DPT; ++i) acc_k[i] = acc_v[i] = 0.f;

  for (int g = 0; g < G; ++g) {
    const int h = kvh * G + g;
    for (int q0 = (q_lo / BQ) * BQ; q0 < q_hi; q0 += BQ) {
      __syncthreads();   // the previous tile's Q, dO, P and dS are read
      load_rows(Qs, q, b, q0, Sq, H, h, D, BQ);
      load_rows(dOs, dout, b, q0, Sq, H, h, D, BQ);
      if (tid < BQ) {
        const int qi = q0 + tid;
        const int64_t row = (static_cast<int64_t>(b) * H + h) * Sq + qi;
        lse_s[tid] = qi < Sq ? lse[row] : -INFINITY;
        di_s[tid] = qi < Sq ? di[row] : 0.f;
      }
      __syncthreads();

      float s[2][4], dp[2][4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        s[0][j] = s[1][j] = dp[0][j] = dp[1][j] = 0.f;
      for (int d = 0; d < D; ++d) {
        const float a0 = Qs[r0 * ld + d];
        const float a1 = Qs[(r0 + 1) * ld + d];
        const float g0 = dOs[r0 * ld + d];
        const float g1 = dOs[(r0 + 1) * ld + d];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float kk = Ks[(tx + 8 * j) * ld + d];
          const float vv = Vs[(tx + 8 * j) * ld + d];
          s[0][j] += a0 * kk;
          s[1][j] += a1 * kk;
          dp[0][j] += g0 * vv;
          dp[1][j] += g1 * vv;
        }
      }
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int r = r0 + rr;
        const float l = lse_s[r];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = tx + 8 * j;
          const bool valid = mk.ok(q0 + r, k0 + c) && l > -INFINITY;
          const float p = valid ? expf(s[rr][j] * scale - l) : 0.f;
          Ps[r * (BK + 1) + c] = p;
          dSs[r * (BK + 1) + c] = p * (dp[rr][j] - di_s[r]) * scale;
        }
      }
      __syncthreads();

      for (int r = 0; r < BQ; ++r) {
        const float p = Ps[r * (BK + 1) + kr];
        const float ds = dSs[r * (BK + 1) + kr];
#pragma unroll
        for (int i = 0; i < DPT; ++i) {
          const int d = tx + 8 * i;
          if (d < D) {
            acc_v[i] += p * dOs[r * ld + d];
            acc_k[i] += ds * Qs[r * ld + d];
          }
        }
      }
    }
  }

  const int kj = k0 + kr;
  if (kj < Sk) {
    const int64_t off = ((static_cast<int64_t>(b) * Sk + kj) * KvH + kvh) * D;
#pragma unroll
    for (int i = 0; i < DPT; ++i) {
      const int d = tx + 8 * i;
      if (d < D) {
        dk[off + d] = from_f<T>(acc_k[i]);
        dv[off + d] = from_f<T>(acc_v[i]);
      }
    }
  }
}

template <int DPT, typename T>
int launch(const void* q, const void* k, const void* v, const void* o,
           const float* lse, const void* dout, void* dq, void* dk, void* dv,
           float* di, int B, int H, int KvH, int D, Mask mk, float scale,
           cudaStream_t st) {
  auto kq = flash_backward_dq_kernel<DPT, T>;
  auto kkv = flash_backward_dkdv_kernel<DPT, T>;
  const int bytes_q = dq_smem_floats(D) * static_cast<int>(sizeof(float));
  const int bytes_kv = dkdv_smem_floats(D) * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      kq, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes_q);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        kkv, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes_kv);
  if (err != cudaSuccess) return static_cast<int>(err);
  const T* tq = static_cast<const T*>(q);
  const T* tk = static_cast<const T*>(k);
  const T* tv = static_cast<const T*>(v);
  const T* tdo = static_cast<const T*>(dout);
  // dQ (and Di) first: the dK / dV launch reads Di
  kq<<<dim3((mk.Sq + BQ - 1) / BQ, H, B), THREADS, bytes_q, st>>>(
      tq, tk, tv, static_cast<const T*>(o), lse, tdo, static_cast<T*>(dq),
      di, H, KvH, D, mk, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess || mk.Sk == 0) return static_cast<int>(err);
  kkv<<<dim3((mk.Sk + BK - 1) / BK, KvH, B), THREADS, bytes_kv, st>>>(
      tq, tk, tv, lse, tdo, di, static_cast<T*>(dk), static_cast<T*>(dv), H,
      KvH, D, mk, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_d(const void* q, const void* k, const void* v, const void* o,
               const float* lse, const void* dout, void* dq, void* dk,
               void* dv, float* di, int B, int H, int KvH, int D, Mask mk,
               float scale, cudaStream_t st) {
  if (D <= 64)
    return launch<8, T>(q, k, v, o, lse, dout, dq, dk, dv, di, B, H, KvH, D,
                        mk, scale, st);
  if (D <= 128)
    return launch<16, T>(q, k, v, o, lse, dout, dq, dk, dv, di, B, H, KvH, D,
                         mk, scale, st);
  return launch<32, T>(q, k, v, o, lse, dout, dq, dk, dv, di, B, H, KvH, D,
                       mk, scale, st);
}

// ---------------------------------------------------------------------------
// Tensor-core kernels (bf16 operands, D <= 256): TMA ring, wgmma
// ---------------------------------------------------------------------------

constexpr int TC_TILE = hopper::TILE_ROWS;     // query rows / keys a tile
constexpr int TC_PANEL = TC_TILE * 128;        // 64 rows x 128 bytes
constexpr int TC_AUX = 2 * TC_TILE * 4;        // a tile's LSE and Di rows
constexpr int TC_PRODUCER_REGS = 24;
constexpr int TC_CONSUMER_REGS = 240;
constexpr float LOG2E = 1.4426950408889634f;

// consumer warpgroups, 64-column panels and ring stages of both kernels at
// the padded head dim D16
__host__ __device__ constexpr int tc_consumers(int D16) {
  return D16 > 128 ? 1 : 2;
}
__host__ __device__ constexpr int tc_panels(int D16) { return (D16 + 63) / 64; }
__host__ __device__ constexpr int tc_stages(int D16) {
  return D16 > 128 ? 2 : 3;
}
// resident tiles of two operands a consumer, a ring of two operands' tiles,
// LSE / Di rows a consumer and a stage, barriers, 1024 bytes of alignment
__host__ __device__ constexpr int tc_smem_bytes(int D16) {
  return TC_PANEL * tc_panels(D16) * 2 *
             (tc_consumers(D16) + tc_stages(D16)) +
         TC_AUX * (tc_consumers(D16) + tc_stages(D16)) +
         8 * (2 * tc_stages(D16) + 1) + 1024;
}

struct TcParams {
  const __nv_bfloat16* o;     // [B, Sq, H, D]
  const __nv_bfloat16* dout;  // [B, Sq, H, D]
  const float* lse;           // [B, H, Sq]: the forward's natural LSE
  float* lse2;    // [B, H, Sq_pad]: the LSE in log2 units, +inf for a row
                  // that reaches no key and on the pad
  float* di;      // [B, H, Sq_pad]: Di = rowsum(dO O), 0 on the pad
  __nv_bfloat16* dq;          // [B, Sq, H, D]
  float* part;    // [2, splits, B, Sk, KvH, D]: dK's, then dV's partials
  int B, Sq, Sk, H, KvH, G, D, Sq_pad;
  int window, chunk, causal, splits;
  float scale, scale_log2;    // D^-0.5 and D^-0.5 log2(e)
};

// Keys that query position i reaches: [key_lo(i), key_hi(i)); queries that
// reach key j < Sk: [query_lo(j), query_hi(j)).  All four non-decreasing.
__device__ __forceinline__ int key_lo(const TcParams& p, int i) {
  int lo = 0;
  if (p.causal) {
    if (p.window > 0) lo = max(lo, i - p.window + 1);
    if (p.chunk > 0) lo = max(lo, (i / p.chunk) * p.chunk);
  }
  return lo;
}
__device__ __forceinline__ int key_hi(const TcParams& p, int i) {
  int hi = p.Sk;
  if (p.causal) {
    hi = min(hi, i + 1);
    if (p.chunk > 0) hi = min(hi, (i / p.chunk + 1) * p.chunk);
  }
  return hi;
}
__device__ __forceinline__ int query_lo(const TcParams& p, int j) {
  return p.causal ? j : 0;
}
__device__ __forceinline__ int query_hi(const TcParams& p, int j) {
  int hi = p.Sq;
  if (p.causal) {
    if (p.window > 0) hi = min(hi, j + p.window);
    if (p.chunk > 0) hi = min(hi, (j / p.chunk + 1) * p.chunk);
  }
  return hi;
}

// sum of the products of 8 bf16 pairs, in order
__device__ __forceinline__ float dot8(const uint4& a, const uint4& b) {
  const uint32_t* x = reinterpret_cast<const uint32_t*>(&a);
  const uint32_t* y = reinterpret_cast<const uint32_t*>(&b);
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 fx = hopper::unpack_bf16(x[i]);
    const float2 fy = hopper::unpack_bf16(y[i]);
    s = fmaf(fx.x, fy.x, s);
    s = fmaf(fx.y, fy.y, s);
  }
  return s;
}

// acc[64 x D] = A[64 x D16] B[64 x D16]^T over the whole head: both
// operands' NP panels K-major at a and b (scale_d 0 on the first k-step)
template <int D16>
__device__ __forceinline__ void tc_scores(float (&acc)[32], uint32_t a,
                                          uint32_t b) {
#pragma unroll
  for (int ks = 0; ks < D16 / 16; ++ks) {
    const uint32_t off = (ks / 4) * TC_PANEL + (ks % 4) * 32;
    hopper::wgmma_ss_m64n64k16(acc, hopper::make_desc(a + off, 16, 1024),
                               hopper::make_desc(b + off, 16, 1024), ks > 0);
  }
}

// acc[NO panels] += A[64 x 64] B[64 x cols]: A as four k-steps of bf16
// fragments, B the 64-row tile at b read from panel p0 on, MN-major; the
// last panel LAST columns wide
template <int NO, int LAST>
__device__ __forceinline__ void tc_accumulate(float (&acc)[NO][32],
                                              const uint32_t (&a)[4][4],
                                              uint32_t b, int p0) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
    for (int pp = 0; pp < NO - 1; ++pp)
      hopper::wgmma_rs<64>(
          acc[pp], a[kk],
          hopper::make_desc(b + (p0 + pp) * TC_PANEL + kk * 2048, TC_PANEL,
                            1024));
    hopper::wgmma_rs<LAST>(
        acc[NO - 1], a[kk],
        hopper::make_desc(b + (p0 + NO - 1) * TC_PANEL + kk * 2048, TC_PANEL,
                          1024));
  }
}

template <int N>
__device__ __forceinline__ void fence_all(float (&acc)[N][32]) {
#pragma unroll
  for (int pp = 0; pp < N; ++pp) hopper::fence_regs(acc[pp]);
}

// accumulator values of rows {a, b} x columns {2c, 2c + 1} of each 8-column
// group as bf16 A fragments of four 16-deep k-steps
__device__ __forceinline__ void to_fragments(const float (&v)[32],
                                             uint32_t (&f)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int j = 2 * kk + hh;
      f[kk][2 * hh] = hopper::pack_bf16(v[4 * j], v[4 * j + 1]);
      f[kk][2 * hh + 1] = hopper::pack_bf16(v[4 * j + 2], v[4 * j + 3]);
    }
}

// dS = P (dP - Di) for the pair group (kk, hh) of the fragments: P from
// its bf16 fragments pf, dP in the accumulator's layout; Di for row a's and
// row b's two columns (per row in dQ, per column in dK / dV)
__device__ __forceinline__ void ds_pair(const uint32_t (&pf)[4][4],
                                        const float (&dp)[32], int kk, int hh,
                                        float da0, float da1, float db0,
                                        float db1, uint32_t (&ds)[4][4]) {
  const int j = 2 * kk + hh;
  const float2 pa = hopper::unpack_bf16(pf[kk][2 * hh]);
  const float2 pb = hopper::unpack_bf16(pf[kk][2 * hh + 1]);
  ds[kk][2 * hh] = hopper::pack_bf16(pa.x * (dp[4 * j] - da0),
                                     pa.y * (dp[4 * j + 1] - da1));
  ds[kk][2 * hh + 1] = hopper::pack_bf16(pb.x * (dp[4 * j + 2] - db0),
                                         pb.y * (dp[4 * j + 3] - db1));
}

__device__ __forceinline__ void ds_fragments(const uint32_t (&pf)[4][4],
                                             const float (&dp)[32], float da0,
                                             float da1, float db0, float db1,
                                             uint32_t (&ds)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
      ds_pair(pf, dp, kk, hh, da0, da1, db0, db1, ds);
}

template <int D16>
__global__ void __launch_bounds__(128 * (tc_consumers(D16) + 1), 1)
    flash_backward_dq_tc_kernel(const __grid_constant__ CUtensorMap tm_q,
                                const __grid_constant__ CUtensorMap tm_do,
                                const __grid_constant__ CUtensorMap tm_k,
                                const __grid_constant__ CUtensorMap tm_v,
                                const TcParams p) {
  constexpr int NC = tc_consumers(D16);
  constexpr int NP = tc_panels(D16);
  constexpr int STAGES = tc_stages(D16);
  constexpr int LAST = D16 - 64 * (NP - 1);
  constexpr int ROWS = TC_TILE * NC;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = hopper::smem_addr(smem_raw);
  const uint32_t base = raw + ((1024u - (raw & 1023u)) & 1023u);
  const uint32_t s_q = base;                          // [NC][NP] panels
  const uint32_t s_do = s_q + TC_PANEL * NP * NC;     // [NC][NP]
  const uint32_t s_k = s_do + TC_PANEL * NP * NC;     // [STAGES][NP]
  const uint32_t s_v = s_k + TC_PANEL * NP * STAGES;  // [STAGES][NP]
  const uint32_t s_aux = s_v + TC_PANEL * NP * STAGES;
  const uint32_t s_bar = s_aux + TC_AUX * (NC + STAGES);
  auto full = [&](int s) { return s_bar + 8 * s; };
  auto empty = [&](int s) { return s_bar + 8 * (STAGES + s); };
  const uint32_t q_full = s_bar + 8 * 2 * STAGES;

  // heaviest (latest) query blocks first
  const int per = p.H * p.B;
  const int n_qb = (p.Sq + ROWS - 1) / ROWS;
  const int qblk = n_qb - 1 - static_cast<int>(blockIdx.x) / per;
  const int rem = static_cast<int>(blockIdx.x) % per;
  const int h = rem % p.H;
  const int b = rem / p.H;
  const int kvh = h / p.G;
  const int q0 = qblk * ROWS;
  const int q_last = min(q0 + ROWS, p.Sq) - 1;
  // keys some query of this CTA reaches, in whole tiles from k_start
  const int k_lo = key_lo(p, q0);
  const int k_hi = key_hi(p, q_last);
  const int k_start = (k_lo / TC_TILE) * TC_TILE;
  const int n_tiles =
      k_hi > k_lo ? (k_hi - k_start + TC_TILE - 1) / TC_TILE : 0;
  // consumers with rows below Sq (the others only release the ring)
  const int n_act = min(NC, (p.Sq - q0 + TC_TILE - 1) / TC_TILE);

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      hopper::mbar_init(full(s), 1);
      hopper::mbar_init(empty(s), NC * 4);   // one a warp
    }
    hopper::mbar_init(q_full, 1);
    hopper::fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == NC) {
    // ---- producer: one thread issues every TMA load ----------------------
    if constexpr (NC > 1) hopper::setmaxnreg_dec<TC_PRODUCER_REGS>();
    if (threadIdx.x == NC * 128) {
      hopper::tma_prefetch(&tm_q);
      hopper::tma_prefetch(&tm_do);
      hopper::tma_prefetch(&tm_k);
      hopper::tma_prefetch(&tm_v);
      hopper::mbar_expect_tx(q_full, 2 * TC_PANEL * NP * n_act);
      for (int c = 0; c < n_act; ++c)
#pragma unroll
        for (int pp = 0; pp < NP; ++pp) {
          hopper::tma_load_4d(s_q + (c * NP + pp) * TC_PANEL, &tm_q, q_full,
                              64 * pp, h, q0 + TC_TILE * c, b);
          hopper::tma_load_4d(s_do + (c * NP + pp) * TC_PANEL, &tm_do, q_full,
                              64 * pp, h, q0 + TC_TILE * c, b);
        }
      for (int n = 0; n < n_tiles; ++n) {
        const int s = n % STAGES;
        hopper::mbar_wait(empty(s), ((n / STAGES) & 1) ^ 1);
        const int k0 = k_start + n * TC_TILE;
        hopper::mbar_expect_tx(full(s), 2 * TC_PANEL * NP);
#pragma unroll
        for (int pp = 0; pp < NP; ++pp) {
          hopper::tma_load_4d(s_k + (s * NP + pp) * TC_PANEL, &tm_k, full(s),
                              64 * pp, kvh, k0, b);
          hopper::tma_load_4d(s_v + (s * NP + pp) * TC_PANEL, &tm_v, full(s),
                              64 * pp, kvh, k0, b);
        }
      }
    }
  } else {
    // ---- consumer: 64 query rows -----------------------------------------
    if constexpr (NC > 1) hopper::setmaxnreg_inc<TC_CONSUMER_REGS>();
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32;
    const int lane = tid % 32;
    const int wq0 = q0 + wg * TC_TILE;
    const bool active = wq0 < p.Sq;
    float* lse_w = reinterpret_cast<float*>(smem_raw + (s_aux - raw)) +
                   wg * 2 * TC_TILE;
    float* di_w = lse_w + TC_TILE;
    const int64_t head_row = static_cast<int64_t>(b) * p.H + h;

    // Di and the LSE in log2 units of this warpgroup's rows: 8 threads a
    // row, 16-byte loads of dO and O, shuffles in a fixed order; kept for
    // this warpgroup and written, pad rows included, for the dK / dV launch
    if (active) {
      const int sub = tid % 8;
      for (int r = tid / 8; r < TC_TILE; r += 16) {
        const int qi = wq0 + r;
        float part = 0.f;
        if (qi < p.Sq) {
          const int64_t off =
              ((static_cast<int64_t>(b) * p.Sq + qi) * p.H + h) * p.D;
          for (int c = sub; c < p.D / 8; c += 8)
            part += dot8(*reinterpret_cast<const uint4*>(p.dout + off + 8 * c),
                         *reinterpret_cast<const uint4*>(p.o + off + 8 * c));
        }
#pragma unroll
        for (int off = 1; off < 8; off <<= 1)
          part += __shfl_xor_sync(0xffffffffu, part, off);
        if (sub == 0) {
          float l2 = INFINITY;
          if (qi < p.Sq) {
            const float l = p.lse[head_row * p.Sq + qi];
            if (l != -INFINITY) l2 = l * LOG2E;
          }
          const float d = qi < p.Sq ? part : 0.f;
          lse_w[r] = l2;
          di_w[r] = d;
          if (qi < p.Sq_pad) {
            p.lse2[head_row * p.Sq_pad + qi] = l2;
            p.di[head_row * p.Sq_pad + qi] = d;
          }
        }
      }
    }
    hopper::named_barrier_sync(1 + wg, 128);

    // this thread's two rows: r_a = 16 warp + lane / 4 and r_a + 8
    const int ra = warp * 16 + lane / 4;
    const int c2 = 2 * (lane % 4);
    const int qa = wq0 + ra, qb = qa + 8;
    const float lse_a = lse_w[ra], lse_b = lse_w[ra + 8];
    const float di_a = di_w[ra], di_b = di_w[ra + 8];
    const int lo_a = key_lo(p, qa), hi_a = key_hi(p, qa);
    const int lo_b = key_lo(p, qb), hi_b = key_hi(p, qb);
    // keys this warpgroup reaches; a tile inside [lo_last, hi_first) needs
    // no element mask
    const int w_last = min(wq0 + TC_TILE, p.Sq) - 1;
    const int wk_lo = active ? key_lo(p, wq0) : 0;
    const int wk_hi = active ? key_hi(p, w_last) : 0;
    const int lo_last = key_lo(p, w_last), hi_first = key_hi(p, wq0);
    const uint32_t s_qw = s_q + wg * NP * TC_PANEL;
    const uint32_t s_dow = s_do + wg * NP * TC_PANEL;

    float acc[NP][32];
#pragma unroll
    for (int pp = 0; pp < NP; ++pp)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[pp][i] = 0.f;

    // every load is waited for before the CTA ends
    hopper::mbar_wait(q_full, 0);
    for (int n = 0; n < n_tiles; ++n) {
      const int s = n % STAGES;
      const int k0 = k_start + n * TC_TILE;
      hopper::mbar_wait(full(s), (n / STAGES) & 1);
      if (k0 >= wk_hi || k0 + TC_TILE <= wk_lo) {
        if (lane == 0) hopper::mbar_arrive(empty(s));
        continue;
      }
      const uint32_t k_st = s_k + s * NP * TC_PANEL;
      const uint32_t v_st = s_v + s * NP * TC_PANEL;

      // S = Q K^T and dP = dO V^T, two groups; P while dP runs
      float sc[32], dp[32];
      hopper::fence_regs(sc);
      hopper::fence_regs(dp);
      hopper::wgmma_fence();
      tc_scores<D16>(sc, s_qw, k_st);
      hopper::wgmma_commit();
      tc_scores<D16>(dp, s_dow, v_st);
      hopper::wgmma_commit();
      hopper::wgmma_wait<1>();
      hopper::fence_regs(sc);

      const bool inside = k0 >= lo_last && k0 + TC_TILE <= hi_first;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int kj = k0 + 8 * j + c2 + e;
          float pa = exp2f(sc[4 * j + e] * p.scale_log2 - lse_a);
          float pb = exp2f(sc[4 * j + 2 + e] * p.scale_log2 - lse_b);
          if (!inside) {
            if (kj < lo_a || kj >= hi_a) pa = 0.f;
            if (kj < lo_b || kj >= hi_b) pb = 0.f;
          }
          sc[4 * j + e] = pa;
          sc[4 * j + 2 + e] = pb;
        }
      // P kept as bf16 pairs from here (the float32 values die)
      uint32_t pf[4][4];
      to_fragments(sc, pf);
      hopper::wgmma_wait<0>();
      hopper::fence_regs(dp);
      uint32_t ds[4][4];
      ds_fragments(pf, dp, di_a, di_a, di_b, di_b, ds);

      // dQ += dS K: K [64 keys x D] as the transposed operand
      fence_all(acc);
      hopper::wgmma_fence();
      tc_accumulate<NP, LAST>(acc, ds, k_st, 0);
      hopper::wgmma_commit();
      hopper::wgmma_wait0();
      fence_all(acc);
      if (lane == 0) hopper::mbar_arrive(empty(s));
    }

    // epilogue: scale dQ, bf16, rows past Sq and columns past D dropped
    if (active) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int qi = half ? qb : qa;
        if (qi >= p.Sq) continue;
        __nv_bfloat16* row =
            p.dq + ((static_cast<int64_t>(b) * p.Sq + qi) * p.H + h) * p.D;
#pragma unroll
        for (int pp = 0; pp < NP; ++pp)
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int col = 64 * pp + 8 * j + c2;
            if (col < p.D)
              *reinterpret_cast<uint32_t*>(row + col) = hopper::pack_bf16(
                  acc[pp][4 * j + 2 * half] * p.scale,
                  acc[pp][4 * j + 2 * half + 1] * p.scale);
          }
      }
    }
  }
}

template <int D16>
__global__ void __launch_bounds__(128 * (tc_consumers(D16) + 1), 1)
    flash_backward_dkdv_tc_kernel(const __grid_constant__ CUtensorMap tm_q,
                                  const __grid_constant__ CUtensorMap tm_do,
                                  const __grid_constant__ CUtensorMap tm_k,
                                  const __grid_constant__ CUtensorMap tm_v,
                                  const TcParams p) {
  constexpr int NC = tc_consumers(D16);
  constexpr int NP = tc_panels(D16);
  constexpr int STAGES = tc_stages(D16);
  constexpr int LAST = D16 - 64 * (NP - 1);
  // at D 256 a CTA accumulates one half of the columns
  constexpr bool HALF = D16 > 128;
  constexpr int NO = HALF ? NP / 2 : NP;       // panels of dK and of dV
  constexpr int KEYS = TC_TILE * NC;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = hopper::smem_addr(smem_raw);
  const uint32_t base = raw + ((1024u - (raw & 1023u)) & 1023u);
  const uint32_t s_k = base;                          // [NC][NP] panels
  const uint32_t s_v = s_k + TC_PANEL * NP * NC;      // [NC][NP]
  const uint32_t s_q = s_v + TC_PANEL * NP * NC;      // [STAGES][NP]
  const uint32_t s_do = s_q + TC_PANEL * NP * STAGES; // [STAGES][NP]
  const uint32_t s_aux = s_do + TC_PANEL * NP * STAGES;  // [STAGES]
  const uint32_t s_bar = s_aux + TC_AUX * (NC + STAGES);
  const float* aux = reinterpret_cast<const float*>(smem_raw + (s_aux - raw));
  auto full = [&](int s) { return s_bar + 8 * s; };
  auto empty = [&](int s) { return s_bar + 8 * (STAGES + s); };
  const uint32_t kv_full = s_bar + 8 * 2 * STAGES;

  // heaviest (lowest) key blocks first; then KV head, head slice, batch
  constexpr int HALVES = HALF ? 2 : 1;
  const int per = p.KvH * p.splits * p.B * HALVES;
  const int kblk = static_cast<int>(blockIdx.x) / per;
  int rem = static_cast<int>(blockIdx.x) % per;
  const int half = rem % HALVES;
  rem /= HALVES;
  const int kvh = rem % p.KvH;
  rem /= p.KvH;
  const int split = rem % p.splits;
  const int b = rem / p.splits;
  const int k0 = kblk * KEYS;
  // this slice's query heads of the KV head (ops.head_splits)
  const int g0 = split * p.G / p.splits;
  const int g1 = (split + 1) * p.G / p.splits;
  // queries some key of this CTA reaches, in whole tiles from q_start
  const int k_last = min(k0 + KEYS, p.Sk) - 1;
  const int q_lo = query_lo(p, k0);
  const int q_hi = query_hi(p, k_last);
  const int q_start = (q_lo / TC_TILE) * TC_TILE;
  const int n_qt = q_hi > q_lo ? (q_hi - q_start + TC_TILE - 1) / TC_TILE : 0;
  const int n_iter = n_qt * (g1 - g0);
  // consumers with keys below Sk (the others only release the ring)
  const int n_act = min(NC, (p.Sk - k0 + TC_TILE - 1) / TC_TILE);

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      hopper::mbar_init(full(s), 1);
      hopper::mbar_init(empty(s), NC * 4);   // one a warp
    }
    hopper::mbar_init(kv_full, 1);
    hopper::fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == NC) {
    // ---- producer: one thread issues every load --------------------------
    if constexpr (NC > 1) hopper::setmaxnreg_dec<TC_PRODUCER_REGS>();
    if (threadIdx.x == NC * 128) {
      hopper::tma_prefetch(&tm_q);
      hopper::tma_prefetch(&tm_do);
      hopper::tma_prefetch(&tm_k);
      hopper::tma_prefetch(&tm_v);
      hopper::mbar_expect_tx(kv_full, 2 * TC_PANEL * NP * n_act);
      for (int c = 0; c < n_act; ++c)
#pragma unroll
        for (int pp = 0; pp < NP; ++pp) {
          hopper::tma_load_4d(s_k + (c * NP + pp) * TC_PANEL, &tm_k, kv_full,
                              64 * pp, kvh, k0 + TC_TILE * c, b);
          hopper::tma_load_4d(s_v + (c * NP + pp) * TC_PANEL, &tm_v, kv_full,
                              64 * pp, kvh, k0 + TC_TILE * c, b);
        }
      for (int n = 0; n < n_iter; ++n) {
        const int s = n % STAGES;
        const int h = kvh * p.G + g0 + n / n_qt;
        const int q0 = q_start + (n % n_qt) * TC_TILE;
        hopper::mbar_wait(empty(s), ((n / STAGES) & 1) ^ 1);
        hopper::mbar_expect_tx(full(s), 2 * TC_PANEL * NP + TC_AUX);
#pragma unroll
        for (int pp = 0; pp < NP; ++pp) {
          hopper::tma_load_4d(s_q + (s * NP + pp) * TC_PANEL, &tm_q, full(s),
                              64 * pp, h, q0, b);
          hopper::tma_load_4d(s_do + (s * NP + pp) * TC_PANEL, &tm_do,
                              full(s), 64 * pp, h, q0, b);
        }
        const int64_t row =
            (static_cast<int64_t>(b) * p.H + h) * p.Sq_pad + q0;
        hopper::bulk_load(s_aux + s * TC_AUX, p.lse2 + row, TC_TILE * 4,
                          full(s));
        hopper::bulk_load(s_aux + s * TC_AUX + TC_TILE * 4, p.di + row,
                          TC_TILE * 4, full(s));
      }
    }
  } else {
    // ---- consumer: 64 keys -----------------------------------------------
    if constexpr (NC > 1) hopper::setmaxnreg_inc<TC_CONSUMER_REGS>();
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32;
    const int lane = tid % 32;
    const int wk0 = k0 + wg * TC_TILE;
    const bool active = wk0 < p.Sk;
    // this thread's two keys: r_a = 16 warp + lane / 4 and r_a + 8
    const int ra = warp * 16 + lane / 4;
    const int c2 = 2 * (lane % 4);
    const int ka = wk0 + ra, kb = ka + 8;
    const int qlo_a = query_lo(p, ka), qhi_a = query_hi(p, ka);
    const int qlo_b = query_lo(p, kb), qhi_b = query_hi(p, kb);
    // queries this warpgroup's keys reach; a tile inside [qlo_last,
    // qhi_first) needs no element mask (keys past Sk give rows that are
    // never written)
    const int wq_lo = active ? query_lo(p, wk0) : 0;
    const int wq_hi = active ? query_hi(p, min(wk0 + TC_TILE, p.Sk) - 1) : 0;
    const int qlo_last = query_lo(p, wk0 + TC_TILE - 1);
    const int qhi_first = query_hi(p, wk0);
    const uint32_t s_kw = s_k + wg * NP * TC_PANEL;
    const uint32_t s_vw = s_v + wg * NP * TC_PANEL;
    const int p0 = half * NO;                   // first panel of dK and dV

    float dk[NO][32], dv[NO][32];
#pragma unroll
    for (int pp = 0; pp < NO; ++pp)
#pragma unroll
      for (int i = 0; i < 32; ++i) dk[pp][i] = dv[pp][i] = 0.f;

    // every load is waited for before the CTA ends
    hopper::mbar_wait(kv_full, 0);
    for (int n = 0; n < n_iter; ++n) {
      const int s = n % STAGES;
      const int q0 = q_start + (n % n_qt) * TC_TILE;
      hopper::mbar_wait(full(s), (n / STAGES) & 1);
      if (q0 >= wq_hi || q0 + TC_TILE <= wq_lo) {
        if (lane == 0) hopper::mbar_arrive(empty(s));
        continue;
      }
      const uint32_t q_st = s_q + s * NP * TC_PANEL;
      const uint32_t do_st = s_do + s * NP * TC_PANEL;
      const float* lse_t = aux + s * 2 * TC_TILE;
      const float* di_t = lse_t + TC_TILE;

      // S^T = K Q^T and dP^T = V dO^T (keys x queries), two groups
      float sc[32], dp[32];
      hopper::fence_regs(sc);
      hopper::fence_regs(dp);
      hopper::wgmma_fence();
      tc_scores<D16>(sc, s_kw, q_st);
      hopper::wgmma_commit();
      tc_scores<D16>(dp, s_vw, do_st);
      hopper::wgmma_commit();
      hopper::wgmma_wait<1>();
      hopper::fence_regs(sc);

      // P^T = exp2(S^T scale log2(e) - lse2[query]) on reachable pairs
      const bool inside = q0 >= qlo_last && q0 + TC_TILE <= qhi_first;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 l =
            *reinterpret_cast<const float2*>(lse_t + 8 * j + c2);
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int qi = q0 + 8 * j + c2 + e;
          const float le = e ? l.y : l.x;
          float va = exp2f(sc[4 * j + e] * p.scale_log2 - le);
          float vb = exp2f(sc[4 * j + 2 + e] * p.scale_log2 - le);
          if (!inside) {
            if (qi < qlo_a || qi >= qhi_a) va = 0.f;
            if (qi < qlo_b || qi >= qhi_b) vb = 0.f;
          }
          sc[4 * j + e] = va;
          sc[4 * j + 2 + e] = vb;
        }
      }
      uint32_t pf[4][4];
      to_fragments(sc, pf);

      // dV += P^T dO while dP^T finishes
      fence_all(dv);
      hopper::wgmma_fence();
      tc_accumulate<NO, HALF ? 64 : LAST>(dv, pf, do_st, p0);
      hopper::wgmma_commit();
      hopper::wgmma_wait<1>();
      hopper::fence_regs(dp);

      // dS^T = P^T (dP^T - Di[query]); dK += dS^T Q (scaled at the end)
      uint32_t sf[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int j = 2 * kk + hh;
          const float2 d =
              *reinterpret_cast<const float2*>(di_t + 8 * j + c2);
          ds_pair(pf, dp, kk, hh, d.x, d.y, d.x, d.y, sf);
        }
      fence_all(dk);
      hopper::wgmma_fence();
      tc_accumulate<NO, HALF ? 64 : LAST>(dk, sf, q_st, p0);
      hopper::wgmma_commit();
      hopper::wgmma_wait0();
      fence_all(dv);
      fence_all(dk);
      if (lane == 0) hopper::mbar_arrive(empty(s));
    }

    // epilogue: this slice's float32 partial sums, rows past Sk and
    // columns past D dropped
    if (active) {
      const int64_t n_elem =
          static_cast<int64_t>(p.B) * p.Sk * p.KvH * p.D;
      float* pk = p.part + static_cast<int64_t>(split) * n_elem;
      float* pv = p.part + static_cast<int64_t>(p.splits + split) * n_elem;
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int kj = hr ? kb : ka;
        if (kj >= p.Sk) continue;
        const int64_t off =
            ((static_cast<int64_t>(b) * p.Sk + kj) * p.KvH + kvh) * p.D;
#pragma unroll
        for (int pp = 0; pp < NO; ++pp)
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int col = 64 * (p0 + pp) + 8 * j + c2;
            if (col < p.D) {
              *reinterpret_cast<float2*>(pk + off + col) =
                  make_float2(dk[pp][4 * j + 2 * hr] * p.scale,
                              dk[pp][4 * j + 2 * hr + 1] * p.scale);
              *reinterpret_cast<float2*>(pv + off + col) = make_float2(
                  dv[pp][4 * j + 2 * hr], dv[pp][4 * j + 2 * hr + 1]);
            }
          }
      }
    }
  }
}

// dK and dV from the slices' partials [2, splits, n]: summed in slice
// order, written as bf16; 4 elements a thread and step (n % 4 == 0)
__global__ void __launch_bounds__(256) flash_backward_dkdv_reduce_kernel(
    const float* __restrict__ part, __nv_bfloat16* __restrict__ dk,
    __nv_bfloat16* __restrict__ dv, int64_t n, int splits) {
  const int64_t step = static_cast<int64_t>(gridDim.x) * blockDim.x * 4;
  for (int64_t i =
           (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) * 4;
       i < 2 * n; i += step) {
    const bool is_v = i >= n;
    const int64_t e = is_v ? i - n : i;
    const float* src = part + (is_v ? static_cast<int64_t>(splits) * n : 0) + e;
    float4 acc = *reinterpret_cast<const float4*>(src);
    for (int s = 1; s < splits; ++s) {
      const float4 x = *reinterpret_cast<const float4*>(src + s * n);
      acc.x += x.x;
      acc.y += x.y;
      acc.z += x.z;
      acc.w += x.w;
    }
    const uint2 out = make_uint2(hopper::pack_bf16(acc.x, acc.y),
                                 hopper::pack_bf16(acc.z, acc.w));
    *reinterpret_cast<uint2*>((is_v ? dv : dk) + e) = out;
  }
}

template <int D16>
int launch_tc(const CUtensorMap (&maps)[4], const TcParams& p,
              __nv_bfloat16* dk, __nv_bfloat16* dv, cudaStream_t st) {
  auto kq = flash_backward_dq_tc_kernel<D16>;
  auto kkv = flash_backward_dkdv_tc_kernel<D16>;
  constexpr int bytes = tc_smem_bytes(D16);
  constexpr int NC = tc_consumers(D16);
  constexpr int threads = 128 * (NC + 1);
  static const cudaError_t attr_q = cudaFuncSetAttribute(
      kq, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  static const cudaError_t attr_kv = cudaFuncSetAttribute(
      kkv, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (attr_q != cudaSuccess) return static_cast<int>(attr_q);
  if (attr_kv != cudaSuccess) return static_cast<int>(attr_kv);
  // 1. dQ, with Di and the LSE in log2 units for launch 2
  const int n_qb = (p.Sq + TC_TILE * NC - 1) / (TC_TILE * NC);
  kq<<<n_qb * p.H * p.B, threads, bytes, st>>>(maps[0], maps[1], maps[2],
                                                maps[3], p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || p.Sk == 0) return static_cast<int>(err);
  // 2. dK and dV partials of each head slice (and column half)
  const int n_kb = (p.Sk + TC_TILE * NC - 1) / (TC_TILE * NC);
  kkv<<<n_kb * p.KvH * p.splits * p.B * (D16 > 128 ? 2 : 1), threads, bytes,
        st>>>(maps[0], maps[1], maps[2], maps[3], p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  // 3. the slices summed in order, bf16
  const int64_t n = static_cast<int64_t>(p.B) * p.Sk * p.KvH * p.D;
  const int64_t blocks = (2 * n / 4 + 255) / 256;
  flash_backward_dkdv_reduce_kernel<<<
      static_cast<int>(blocks < 132 * 16 ? blocks : 132 * 16), 256, 0, st>>>(
      p.part, dk, dv, n, p.splits);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace


// Plain C entry point (loaded with ctypes).  q, o, dout, dq [B, Sq, H, D];
// k, v, dk, dv [B, Sk, KvH, D], all contiguous, all float32 (bf16 = 0) or
// all bf16 (bf16 = 1); lse (the forward's) and di (scratch for Di) [B, H,
// Sq] float32.  Two launches on `stream` (dQ with Di, then dK and dV); does
// not synchronise, allocates nothing.  Returns cudaGetLastError() of the
// launches (or of the shared-memory attributes), or cudaErrorInvalidValue
// for an unsupported shape.
extern "C" int flash_backward_launch(int bf16, const void* q, const void* k,
                                     const void* v, const void* o,
                                     const float* lse, const void* dout,
                                     void* dq, void* dk, void* dv, float* di,
                                     int B, int Sq, int Sk, int H, int KvH,
                                     int D, int window, int chunk, int causal,
                                     float scale, void* stream) {
  if (B <= 0 || Sq <= 0 || H <= 0) return 0;
  if (KvH <= 0 || H % KvH != 0 || D <= 0 || D > 256 || Sk < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Mask mk{Sq, Sk, window, chunk, causal};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16)
    return dispatch_d<__nv_bfloat16>(q, k, v, o, lse, dout, dq, dk, dv, di, B,
                                     H, KvH, D, mk, scale, st);
  return dispatch_d<float>(q, k, v, o, lse, dout, dq, dk, dv, di, B, H, KvH,
                           D, mk, scale, st);
}

// Plain C entry point of the tensor-core kernels (loaded with ctypes).  q,
// o, dout, dq [B, Sq, H, D]; k, v, dk, dv [B, Sk, KvH, D], all contiguous
// bf16, 16-byte aligned, D % 8 == 0, D <= 256; lse [B, H, Sq] float32 (the
// forward's); scratch: part [2, splits, B, Sk, KvH, D] float32 (16-byte
// aligned), lse2 and di [B, H, Sq_pad] float32, Sq_pad = Sq rounded up to
// 64; 1 <= splits <= H / KvH (ops.dkdv_splits).  Three launches on
// `stream` (dQ with Di; dK / dV partials; their sum); does not synchronise,
// allocates nothing.  Returns cudaGetLastError() of the launches, the
// error of the tensor maps or of the shared-memory attributes, or
// cudaErrorInvalidValue for an unsupported shape or alignment.
extern "C" int flash_backward_tc_launch(
    const void* q, const void* k, const void* v, const void* o,
    const float* lse, const void* dout, void* dq, void* dk, void* dv,
    float* part, float* lse2, float* di, int B, int Sq, int Sk, int H,
    int KvH, int D, int window, int chunk, int causal, float scale,
    int splits, void* stream) {
  if (B <= 0 || Sq <= 0 || H <= 0) return 0;
  if (KvH <= 0 || H % KvH != 0 || D <= 0 || D > 256 || D % 8 != 0 ||
      Sk < 0 || splits < 1 || splits > H / KvH)
    return static_cast<int>(cudaErrorInvalidValue);
  for (const void* ptr : {q, k, v, o, dout, static_cast<const void*>(dq),
                          static_cast<const void*>(dk),
                          static_cast<const void*>(dv),
                          static_cast<const void*>(part)})
    if (reinterpret_cast<uintptr_t>(ptr) % 16 != 0)
      return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap maps[4];
  int err = hopper::tile_map(q, B, Sq, H, D, &maps[0]);
  if (err == 0) err = hopper::tile_map(dout, B, Sq, H, D, &maps[1]);
  if (err == 0) err = hopper::tile_map(k, B, Sk, KvH, D, &maps[2]);
  if (err == 0) err = hopper::tile_map(v, B, Sk, KvH, D, &maps[3]);
  if (err != 0) return err;
  TcParams p;
  p.o = static_cast<const __nv_bfloat16*>(o);
  p.dout = static_cast<const __nv_bfloat16*>(dout);
  p.lse = lse;
  p.lse2 = lse2;
  p.di = di;
  p.dq = static_cast<__nv_bfloat16*>(dq);
  p.part = part;
  p.B = B;
  p.Sq = Sq;
  p.Sk = Sk;
  p.H = H;
  p.KvH = KvH;
  p.G = H / KvH;
  p.D = D;
  p.Sq_pad = (Sq + TC_TILE - 1) / TC_TILE * TC_TILE;
  p.window = window;
  p.chunk = chunk;
  p.causal = causal;
  p.splits = splits;
  p.scale = scale;
  p.scale_log2 = scale * LOG2E;
  auto* tdk = static_cast<__nv_bfloat16*>(dk);
  auto* tdv = static_cast<__nv_bfloat16*>(dv);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // D padded to the next instantiated width (zero columns change no score
  // and no gradient column below D; four instantiations keep the build
  // short)
  if (D <= 64) return launch_tc<64>(maps, p, tdk, tdv, st);
  if (D <= 80) return launch_tc<80>(maps, p, tdk, tdv, st);
  if (D <= 128) return launch_tc<128>(maps, p, tdk, tdv, st);
  return launch_tc<256>(maps, p, tdk, tdv, st);
}
