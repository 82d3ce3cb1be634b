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
// products bound it, at the bf16 tensor-core peak.  These first kernels
// are simple and right rather than fast: no TMA, no wgmma, no pipelining of
// loads with products, and 14 D flops a pair (the dQ launch recomputes S
// and dP).
//
// Two pairs of kernels, two launches a call each, no atomics, chosen by the
// wrapper (ops.backward_path): bf16 operands with D <= 128 (the models'
// path) take the tensor-core pair (flash_backward_{dq,dkdv}_tc_kernel,
// warp-level mma.sync, described below); float32 operands and wider heads
// (gemma3's 256) take the CUDA-core pair, float32 products from shared
// memory (the float32 scalar peak is 67 TFLOP/s, 15 times below the tensor
// cores'):
//
// * flash_backward_dq_kernel, grid (ceil(Sq / 64), H, B), 256 threads: a
//   block owns 64 query rows of one head.  It loads Q and dO as float32
//   into shared memory, computes Di for its rows (written to `di` for the
//   second launch), then walks the 32-key K / V tiles its rows reach,
//   recomputes S and dP, and accumulates dQ in registers.  Thread
//   (ty, tx) = (tid / 8, tid % 8) owns query rows 2 ty and 2 ty + 1, score
//   columns tx + 8 j and output columns tx + 8 i; the 8 threads of a row
//   reduce by warp shuffles.
// * flash_backward_dkdv_kernel, grid (ceil(Sk / 32), KvH, B), 256 threads:
//   a block owns 32 keys of one KV head and accumulates their dK and dV in
//   registers over the G query heads of that KV head and over every 64-row
//   query tile that reaches its keys (so the sum over the group needs no
//   atomics).  S, dP and dS are computed in the same layout as above and
//   staged in shared memory; thread (kr, tx) = (tid / 8, tid % 8) then owns
//   key row kr and columns tx + 8 i of dK and dV.
//
// Operands are all float32 or all bf16; every sum is float32; gradients
// are written in the operands' type.  D <= 256.  Each block visits only the
// tiles its rows or keys can reach and applies the element mask
// everywhere.  What remains (PERF.md): the dK / dV grid is about one block
// a SM with a causal load imbalance (the first keys' blocks walk every
// query tile), loads do not overlap products, and D 256 runs on the CUDA
// cores.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <initializer_list>

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
// Tensor-core kernels (bf16 operands, D <= 128): warp-level mma.sync
// m16n8k16 (bf16 in, float32 sums), the same two passes.  Tiles of 64 query
// rows and 64 keys live in shared memory as bf16 rows of D16 + 8 values (the
// pad keeps the fragment loads free of bank conflicts), loaded with 16-byte
// vector loads and zeros past D, Sq and Sk.  Warps own 16 rows each: four
// warps own a block's 64 query rows in the dQ pass; in the dK / dV pass two
// groups of four warps each own the block's 64 keys, one group walking the
// even query heads of the KV head and the other the odd ones, and the two
// partial sums are added in shared memory at the end (one block still sums
// the whole group of heads: no atomics; two groups keep eight warps busy on
// an SM, where the grid of Sk / 64 x KvH blocks is about one a SM).  A product
// whose B operand runs along its reduction dimension in memory (K^T in
// S = Q K^T) reads 32-bit pairs; one whose B runs across it (K in dQ = dS K)
// reads through ldmatrix.trans.  P and dS are rounded to bf16 as A operands
// of the second products (from the accumulators' registers, whose layout is
// the A layout), as FlashAttention-2 does.
// ---------------------------------------------------------------------------

constexpr int TC_ROWS = 64;        // query rows / keys a tile
constexpr int TC_THREADS = 128;    // 4 warps of 16 rows

__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// B fragment of m16n8k16 from a [k][n] row-major bf16 tile: lane l < 16
// points at row k0 + l, column n0
__device__ __forceinline__ void ldsm_x2_trans(uint32_t& b0, uint32_t& b1,
                                              const __nv_bfloat16* p) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(b0), "=r"(b1)
      : "r"(addr));
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// rows [r0, r0 + 64) of head h of a [B, rows, heads, D] bf16 tensor into a
// [64][LDS] tile, by the `nthreads` threads numbered `tid`; zeros past
// `rows` and past D (up to D16)
template <int D16>
__device__ __forceinline__ void tc_load(__nv_bfloat16* dst,
                                        const __nv_bfloat16* __restrict__ src,
                                        int b, int r0, int rows, int heads,
                                        int h, int D, int tid = threadIdx.x,
                                        int nthreads = TC_THREADS) {
  constexpr int LDS = D16 + 8;
  constexpr int CH = D16 / 8;                  // 16-byte chunks a row
  for (int idx = tid; idx < TC_ROWS * CH; idx += nthreads) {
    const int r = idx / CH;
    const int c = idx - r * CH;
    const int row = r0 + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row < rows && 8 * c < D)
      val = *reinterpret_cast<const uint4*>(
          src + ((static_cast<int64_t>(b) * rows + row) * heads + h) * D +
          8 * c);
    *reinterpret_cast<uint4*>(dst + r * LDS + 8 * c) = val;
  }
}

__host__ __device__ constexpr int tc_smem_bytes(int D16) {
  return 4 * TC_ROWS * (D16 + 8) * 2 + 2 * TC_ROWS * 4;
}

// the dK / dV kernel: two groups of four warps, each walking half of the
// query heads; K and V shared, a Q / dO tile, LSE and Di for each group;
// the groups' partial sums meet in the Q / dO tiles' space at the end
constexpr int TC_KV_GROUPS = 2;
__host__ __device__ constexpr int tc_kv_smem_bytes(int D16) {
  return (2 + 2 * TC_KV_GROUPS) * TC_ROWS * (D16 + 8) * 2 +
         2 * TC_KV_GROUPS * TC_ROWS * 4;
}

template <int D16>
__global__ void __launch_bounds__(TC_THREADS) flash_backward_dq_tc_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ o,
    const float* __restrict__ lse, const __nv_bfloat16* __restrict__ dout,
    __nv_bfloat16* __restrict__ dq, float* __restrict__ di, int H, int KvH,
    int D, Mask mk, float scale) {
  constexpr int LDS = D16 + 8;
  constexpr int NT = D16 / 8;                  // n-tiles of dQ's columns
  extern __shared__ __align__(16) uint8_t smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* dOs = Qs + TC_ROWS * LDS;
  __nv_bfloat16* Ks = dOs + TC_ROWS * LDS;
  __nv_bfloat16* Vs = Ks + TC_ROWS * LDS;
  float* lse_s = reinterpret_cast<float*>(Vs + TC_ROWS * LDS);
  float* di_s = lse_s + TC_ROWS;

  const int Sq = mk.Sq, Sk = mk.Sk;
  const int q0 = blockIdx.x * TC_ROWS;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KvH);
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;

  tc_load<D16>(Qs, q, b, q0, Sq, H, h, D);
  tc_load<D16>(dOs, dout, b, q0, Sq, H, h, D);
  __syncthreads();
  {
    // Di = rowsum(dO * O): two threads a row
    const int r = tid / 2, qi = q0 + r;
    float part = 0.f;
    if (qi < Sq) {
      const __nv_bfloat16* orow =
          o + ((static_cast<int64_t>(b) * Sq + qi) * H + h) * D;
      for (int d = tid % 2; d < D; d += 2)
        part += __bfloat162float(dOs[r * LDS + d]) * __bfloat162float(orow[d]);
    }
    part += __shfl_xor_sync(0xffffffffu, part, 1);
    const int64_t row = (static_cast<int64_t>(b) * H + h) * Sq + qi;
    if (tid % 2 == 0) {
      di_s[r] = part;
      lse_s[r] = qi < Sq ? lse[row] : -INFINITY;
      if (qi < Sq) di[row] = part;
    }
  }
  __syncthreads();

  const int rw = warp * 16;                    // this warp's first row
  const int qa = q0 + rw + g, qb = qa + 8;     // this thread's two rows
  const float lse_a = lse_s[rw + g], lse_b = lse_s[rw + g + 8];
  const float di_a = di_s[rw + g], di_b = di_s[rw + g + 8];

  const int q_last = min(q0 + TC_ROWS, Sq) - 1;
  int k_lo = 0, k_hi = Sk;
  if (mk.causal) {
    k_hi = min(k_hi, q_last + 1);
    if (mk.window > 0) k_lo = max(k_lo, q0 - mk.window + 1);
    if (mk.chunk > 0) {
      k_lo = max(k_lo, (q0 / mk.chunk) * mk.chunk);
      k_hi = min(k_hi, (q_last / mk.chunk + 1) * mk.chunk);
    }
  }

  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int k0 = (k_lo / TC_ROWS) * TC_ROWS; k0 < k_hi; k0 += TC_ROWS) {
    __syncthreads();   // the previous tile's K and V are no longer read
    tc_load<D16>(Ks, k, b, k0, Sk, KvH, kvh, D);
    tc_load<D16>(Vs, v, b, k0, Sk, KvH, kvh, D);
    __syncthreads();

    // S = Q K^T and dP = dO V^T for 16 rows x 64 keys
    float s[8][4], dp[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < D16 / 16; ++ks) {
      const int c = ks * 16 + 2 * t;
      uint32_t aq[4] = {ld32(Qs + (rw + g) * LDS + c),
                        ld32(Qs + (rw + g + 8) * LDS + c),
                        ld32(Qs + (rw + g) * LDS + c + 8),
                        ld32(Qs + (rw + g + 8) * LDS + c + 8)};
      uint32_t ag[4] = {ld32(dOs + (rw + g) * LDS + c),
                        ld32(dOs + (rw + g + 8) * LDS + c),
                        ld32(dOs + (rw + g) * LDS + c + 8),
                        ld32(dOs + (rw + g + 8) * LDS + c + 8)};
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const __nv_bfloat16* kr = Ks + (n * 8 + g) * LDS + c;
        const __nv_bfloat16* vr = Vs + (n * 8 + g) * LDS + c;
        mma16816(s[n], aq, ld32(kr), ld32(kr + 8));
        mma16816(dp[n], ag, ld32(vr), ld32(vr + 8));
      }
    }
    // dS = P (dP - Di) scale, P = exp(s scale - lse) on reachable keys
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool lo = e < 2;
        const int qi = lo ? qa : qb;
        const float l = lo ? lse_a : lse_b;
        const int kj = k0 + n * 8 + 2 * t + (e & 1);
        const float p = mk.ok(qi, kj) && l > -INFINITY
                            ? expf(s[n][e] * scale - l)
                            : 0.f;
        s[n][e] = p * (dp[n][e] - (lo ? di_a : di_b)) * scale;
      }
    // dQ += dS K: dS as A (bf16) from the accumulators, K through
    // ldmatrix.trans
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t a[4] = {pack2(s[2 * kk][0], s[2 * kk][1]),
                       pack2(s[2 * kk][2], s[2 * kk][3]),
                       pack2(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                       pack2(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        uint32_t b0, b1;
        ldsm_x2_trans(b0, b1, Ks + (kk * 16 + (lane & 15)) * LDS + n * 8);
        mma16816(acc[n], a, b0, b1);
      }
    }
  }

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int qi = half ? qb : qa;
    if (qi >= Sq) continue;
    __nv_bfloat16* row = dq + ((static_cast<int64_t>(b) * Sq + qi) * H + h) * D;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const int d = n * 8 + 2 * t;
      if (d < D)
        *reinterpret_cast<uint32_t*>(row + d) =
            pack2(acc[n][2 * half], acc[n][2 * half + 1]);
    }
  }
}

template <int D16>
__global__ void __launch_bounds__(TC_THREADS * TC_KV_GROUPS)
    flash_backward_dkdv_tc_kernel(
        const __nv_bfloat16* __restrict__ q,
        const __nv_bfloat16* __restrict__ k,
        const __nv_bfloat16* __restrict__ v, const float* __restrict__ lse,
        const __nv_bfloat16* __restrict__ dout, const float* __restrict__ di,
        __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
        int H, int KvH, int D, Mask mk, float scale) {
  constexpr int LDS = D16 + 8;
  constexpr int NT = D16 / 8;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  const int grp = threadIdx.x / TC_THREADS;   // which half of the heads
  const int tid = threadIdx.x % TC_THREADS;   // thread within the group
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Vs = Ks + TC_ROWS * LDS;
  __nv_bfloat16* tiles = Vs + TC_ROWS * LDS;  // each group's Q, dO tiles
  __nv_bfloat16* Qs = tiles + 2 * grp * TC_ROWS * LDS;
  __nv_bfloat16* dOs = Qs + TC_ROWS * LDS;
  float* lse_s = reinterpret_cast<float*>(tiles + 2 * TC_KV_GROUPS *
                                                      TC_ROWS * LDS) +
                 2 * grp * TC_ROWS;
  float* di_s = lse_s + TC_ROWS;

  const int Sq = mk.Sq, Sk = mk.Sk;
  const int G = H / KvH;
  const int k0 = blockIdx.x * TC_ROWS;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int rw = warp * 16;                    // this warp's first key
  const int ka = k0 + rw + g, kb = ka + 8;     // this thread's two keys
  // a group's own barrier (ids 1 and 2; 0 is __syncthreads)
  auto group_sync = [&] {
    asm volatile("bar.sync %0, %1;\n" ::"r"(1 + grp), "r"(TC_THREADS));
  };

  tc_load<D16>(Ks, k, b, k0, Sk, KvH, kvh, D, threadIdx.x,
               TC_THREADS * TC_KV_GROUPS);
  tc_load<D16>(Vs, v, b, k0, Sk, KvH, kvh, D, threadIdx.x,
               TC_THREADS * TC_KV_GROUPS);
  __syncthreads();

  const int k_last = min(k0 + TC_ROWS, Sk) - 1;
  int q_lo = 0, q_hi = Sq;
  if (mk.causal) {
    q_lo = k0;
    if (mk.window > 0) q_hi = min(q_hi, k_last + mk.window);
    if (mk.chunk > 0) {
      q_lo = max(q_lo, (k0 / mk.chunk) * mk.chunk);
      q_hi = min(q_hi, (k_last / mk.chunk + 1) * mk.chunk);
    }
  }

  float acc_k[NT][4], acc_v[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_k[n][e] = acc_v[n][e] = 0.f;

  for (int gi = grp; gi < G; gi += TC_KV_GROUPS) {
    const int h = kvh * G + gi;
    for (int q0 = (q_lo / TC_ROWS) * TC_ROWS; q0 < q_hi; q0 += TC_ROWS) {
      group_sync();   // the previous tile's Q, dO, LSE and Di are read
      tc_load<D16>(Qs, q, b, q0, Sq, H, h, D, tid);
      tc_load<D16>(dOs, dout, b, q0, Sq, H, h, D, tid);
      if (tid < TC_ROWS) {
        const int qi = q0 + tid;
        const int64_t row = (static_cast<int64_t>(b) * H + h) * Sq + qi;
        lse_s[tid] = qi < Sq ? lse[row] : -INFINITY;
        di_s[tid] = qi < Sq ? di[row] : 0.f;
      }
      group_sync();

#pragma unroll
      for (int qh = 0; qh < 2; ++qh) {         // 32 query rows at a time
        const int qr = qh * 32;
        // S^T = K Q^T and dP^T = V dO^T for 16 keys x 32 queries
        float s[4][4], dp[4][4];
#pragma unroll
        for (int n = 0; n < 4; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
        for (int ks = 0; ks < D16 / 16; ++ks) {
          const int c = ks * 16 + 2 * t;
          uint32_t ak[4] = {ld32(Ks + (rw + g) * LDS + c),
                            ld32(Ks + (rw + g + 8) * LDS + c),
                            ld32(Ks + (rw + g) * LDS + c + 8),
                            ld32(Ks + (rw + g + 8) * LDS + c + 8)};
          uint32_t av[4] = {ld32(Vs + (rw + g) * LDS + c),
                            ld32(Vs + (rw + g + 8) * LDS + c),
                            ld32(Vs + (rw + g) * LDS + c + 8),
                            ld32(Vs + (rw + g + 8) * LDS + c + 8)};
#pragma unroll
          for (int n = 0; n < 4; ++n) {
            const __nv_bfloat16* qr_ = Qs + (qr + n * 8 + g) * LDS + c;
            const __nv_bfloat16* gr_ = dOs + (qr + n * 8 + g) * LDS + c;
            mma16816(s[n], ak, ld32(qr_), ld32(qr_ + 8));
            mma16816(dp[n], av, ld32(gr_), ld32(gr_ + 8));
          }
        }
        // P^T and dS^T (scaled) on reachable (query, key) pairs
#pragma unroll
        for (int n = 0; n < 4; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int kj = e < 2 ? ka : kb;
            const int ql = qr + n * 8 + 2 * t + (e & 1);
            const float l = lse_s[ql];
            const float p = mk.ok(q0 + ql, kj) && l > -INFINITY
                                ? expf(s[n][e] * scale - l)
                                : 0.f;
            s[n][e] = p;
            dp[n][e] = p * (dp[n][e] - di_s[ql]) * scale;
          }
        // dV += P^T dO and dK += dS^T Q: P^T, dS^T as A (bf16); dO and Q
        // through ldmatrix.trans
#pragma unroll
        for (int kk = 0; kk < 2; ++kk) {
          uint32_t ap[4] = {pack2(s[2 * kk][0], s[2 * kk][1]),
                            pack2(s[2 * kk][2], s[2 * kk][3]),
                            pack2(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                            pack2(s[2 * kk + 1][2], s[2 * kk + 1][3])};
          uint32_t ad[4] = {pack2(dp[2 * kk][0], dp[2 * kk][1]),
                            pack2(dp[2 * kk][2], dp[2 * kk][3]),
                            pack2(dp[2 * kk + 1][0], dp[2 * kk + 1][1]),
                            pack2(dp[2 * kk + 1][2], dp[2 * kk + 1][3])};
          const int row = qr + kk * 16 + (lane & 15);
#pragma unroll
          for (int n = 0; n < NT; ++n) {
            uint32_t b0, b1;
            ldsm_x2_trans(b0, b1, dOs + row * LDS + n * 8);
            mma16816(acc_v[n], ap, b0, b1);
            ldsm_x2_trans(b0, b1, Qs + row * LDS + n * 8);
            mma16816(acc_k[n], ad, b0, b1);
          }
        }
      }
    }
  }

  // the second group's partial sums to the first through shared memory
  // (the tiles' space: 2 x 128 threads x NT x 4 floats fits in it), the
  // same fragment position thread for thread
  __syncthreads();
  float* part = reinterpret_cast<float*>(tiles);
  if (grp == 1) {
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        part[((0 * TC_THREADS + tid) * NT + n) * 4 + e] = acc_k[n][e];
        part[((1 * TC_THREADS + tid) * NT + n) * 4 + e] = acc_v[n][e];
      }
  }
  __syncthreads();
  if (grp == 1) return;
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      acc_k[n][e] += part[((0 * TC_THREADS + tid) * NT + n) * 4 + e];
      acc_v[n][e] += part[((1 * TC_THREADS + tid) * NT + n) * 4 + e];
    }
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int kj = half ? kb : ka;
    if (kj >= Sk) continue;
    const int64_t off = ((static_cast<int64_t>(b) * Sk + kj) * KvH + kvh) * D;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const int d = n * 8 + 2 * t;
      if (d < D) {
        *reinterpret_cast<uint32_t*>(dk + off + d) =
            pack2(acc_k[n][2 * half], acc_k[n][2 * half + 1]);
        *reinterpret_cast<uint32_t*>(dv + off + d) =
            pack2(acc_v[n][2 * half], acc_v[n][2 * half + 1]);
      }
    }
  }
}

template <int D16>
int launch_tc(const void* q, const void* k, const void* v, const void* o,
              const float* lse, const void* dout, void* dq, void* dk,
              void* dv, float* di, int B, int H, int KvH, int D, Mask mk,
              float scale, cudaStream_t st) {
  auto kq = flash_backward_dq_tc_kernel<D16>;
  auto kkv = flash_backward_dkdv_tc_kernel<D16>;
  constexpr int bytes = tc_smem_bytes(D16);
  constexpr int bytes_kv = tc_kv_smem_bytes(D16);
  cudaError_t err = cudaFuncSetAttribute(
      kq, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        kkv, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes_kv);
  if (err != cudaSuccess) return static_cast<int>(err);
  using bf = __nv_bfloat16;
  kq<<<dim3((mk.Sq + TC_ROWS - 1) / TC_ROWS, H, B), TC_THREADS, bytes, st>>>(
      static_cast<const bf*>(q), static_cast<const bf*>(k),
      static_cast<const bf*>(v), static_cast<const bf*>(o), lse,
      static_cast<const bf*>(dout), static_cast<bf*>(dq), di, H, KvH, D, mk,
      scale);
  err = cudaGetLastError();
  if (err != cudaSuccess || mk.Sk == 0) return static_cast<int>(err);
  kkv<<<dim3((mk.Sk + TC_ROWS - 1) / TC_ROWS, KvH, B),
        TC_THREADS * TC_KV_GROUPS, bytes_kv, st>>>(static_cast<const bf*>(q), static_cast<const bf*>(k),
              static_cast<const bf*>(v), lse, static_cast<const bf*>(dout),
              di, static_cast<bf*>(dk), static_cast<bf*>(dv), H, KvH, D, mk,
              scale);
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

// Plain C entry point of the tensor-core kernels (loaded with ctypes): the
// same arguments as flash_backward_launch, all bf16, D % 8 == 0, D <= 128,
// every pointer 16-byte aligned.  Returns cudaErrorInvalidValue for an
// unsupported shape or alignment.
extern "C" int flash_backward_tc_launch(const void* q, const void* k,
                                        const void* v, const void* o,
                                        const float* lse, const void* dout,
                                        void* dq, void* dk, void* dv,
                                        float* di, int B, int Sq, int Sk,
                                        int H, int KvH, int D, int window,
                                        int chunk, int causal, float scale,
                                        void* stream) {
  if (B <= 0 || Sq <= 0 || H <= 0) return 0;
  if (KvH <= 0 || H % KvH != 0 || D <= 0 || D > 128 || D % 8 != 0 || Sk < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  for (const void* ptr : {q, k, v, o, dout, static_cast<const void*>(dq),
                          static_cast<const void*>(dk),
                          static_cast<const void*>(dv)})
    if (reinterpret_cast<uintptr_t>(ptr) % 16 != 0)
      return static_cast<int>(cudaErrorInvalidValue);
  const Mask mk{Sq, Sk, window, chunk, causal};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D <= 64)
    return launch_tc<64>(q, k, v, o, lse, dout, dq, dk, dv, di, B, H, KvH, D,
                         mk, scale, st);
  return launch_tc<128>(q, k, v, o, lse, dout, dq, dk, dv, di, B, H, KvH, D,
                        mk, scale, st);
}
