// Causal GQA flash attention forward (prefill) for Hopper (sm_90a), with
// sliding-window and chunked-local masks.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_prefill/kernel.py
// (_flash_kernel, launched by flash_prefill_flat).  The TPU version runs a
// grid (B * H, Sq / BQ, Sk / BK) whose KV axis is walked in order on one
// core with (m, l, acc) in VMEM scratch, after its wrapper has repeated
// every KV head G times (ops.py:45-48) and padded D to 128.
//
// Bound on an H100: 4 * D flops for each reachable (query, key) pair per
// query head against one read of Q, K, V and one write of O.  At the
// model's prompt lengths (gemma3-12b: D = 256, G = 2, S up to 1536) that is
// about 100 to 250 flops a byte, near or past the 295 at which the bf16
// tensor cores (989 TFLOP/s) and not HBM (3.35 TB/s) set the limit; the
// scalar float32 rate (67 TFLOP/s) is 15 times lower.  So the products have
// to run on the tensor cores, fed from shared memory as fast as they eat.
//
// Two kernels, chosen by operand type (ops.py):
//
// * flash_prefill_tc_kernel (bf16 q, k, v): the tensor-core kernel.  A CTA
//   owns 128 "packed rows" (query position i, head g of the group) of one
//   KV head, row p = i * G + g, so every K/V tile it loads serves all G
//   query heads of that KV head, whatever G (1, 2, 5, 12, ...).  Three
//   warpgroups: two consumers of 64 packed rows each and one producer.
//   The producer's one thread keeps TMA loads of 64-key K and V tiles in
//   flight into a ring of 2 (D > 192) or 3 stages, each with a full barrier
//   for K, one for V and an empty barrier (mbarriers); it gives its
//   registers to the consumers (setmaxnreg 40 / 232).  A consumer computes
//   S = Q K^T with wgmma m64n64k16 (Q and K from shared memory), masks only
//   the tiles that cross a mask boundary or Sk, keeps the online softmax
//   (m, l) in float32 registers, rounds P to bf16 and computes O += P V
//   with P from registers (the accumulator layout is the A-operand layout)
//   and V from shared memory (transposed operand), O in float32 registers
//   (64 x D a warpgroup).  Tiles are 128-byte-swizzled panels of 64
//   columns; D is padded with zero columns (TMA's out-of-bounds fill) to
//   the next of 64, 80, 128 and 256, the widths the kernel is instantiated
//   on.  Q is read once per CTA by the consumers themselves with
//   asynchronous copies (packed rows are not one TMA box for every G).
//   Query tiles are launched heaviest (latest) first, so the causal
//   triangle leaves no tail wave.  Needs D % 8 == 0 and 16-byte aligned
//   pointers (the wrapper pads and copies otherwise).
//
// * flash_prefill_kernel (float32 or mixed operands): float32 products on
//   the CUDA cores, for callers that asked for float32.  grid (ceil(Sq /
//   64), H, B), 256 threads: a block owns 64 query rows of one head and
//   loops over 32-row K/V tiles held in shared memory as float32 (rows
//   padded by one element against bank conflicts).  Thread (ty, tx) =
//   (tid / 8, tid % 8) owns query rows 2 ty and 2 ty + 1 and output columns
//   tx + 8 i; the 8 threads of a row reduce by warp shuffles.
//
// Both visit only the KV tiles that some query of the block can reach under
// the causal, window and chunk masks (the range is computed once), and
// apply the element mask only on tiles that cross a mask boundary or the
// end of the sequence.  Query i sits at position i and key j at position
// j, as in the reference; a row with no reachable key returns 0; output in
// q's dtype.  D <= 256.  Given a non-null `lse` [B, H, Sq] float32, both
// also write each row's natural log-sum-exp of its scaled scores (-inf for
// a row with no reachable key), from which training's backward
// (flash_backward.cu) recomputes P; serving passes null.
//
// What remains (PERF.md): at 1536 tokens the kernel reaches about 0.3 of
// its bound.  A consumer still waits for S = Q K^T, then runs its softmax,
// then O += P V, one after the other (no overlap of one tile's softmax
// with the next tile's products inside a warpgroup); CTAs are not
// persistent; the output is stored from registers rather than by TMA; fp8
// operands are not taken.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper_ptx.cuh"
#include "tma_map.cuh"

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
    const TK* __restrict__ v, TQ* __restrict__ out, float* __restrict__ lse,
    int Sq, int Sk, int H, int KvH, int D, int window, int chunk, int causal,
    float scale) {
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
    // natural log-sum-exp of the row's scaled scores (training's backward
    // recomputes P from it); -inf for a row that reached no key
    if (lse != nullptr && tx == 0)
      lse[(static_cast<int64_t>(b) * H + h) * Sq + qi] =
          l[rr] > 0.f ? m[rr] + logf(l[rr]) : -INFINITY;
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
int launch(const void* q, const void* k, const void* v, void* out, float* lse,
           int B, int Sq, int Sk, int H, int KvH, int D, int window,
           int chunk, int causal, float scale, cudaStream_t stream) {
  auto kern = flash_prefill_kernel<DPT, TQ, TK>;
  const int bytes = smem_floats(D) * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((Sq + BQ - 1) / BQ, H, B);
  kern<<<grid, THREADS, bytes, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TK*>(k),
      static_cast<const TK*>(v), static_cast<TQ*>(out), lse, Sq, Sk, H, KvH,
      D, window, chunk, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename TQ, typename TK>
int dispatch_d(const void* q, const void* k, const void* v, void* out,
               float* lse, int B, int Sq, int Sk, int H, int KvH, int D,
               int window, int chunk, int causal, float scale,
               cudaStream_t st) {
  if (D <= 64)
    return launch<8, TQ, TK>(q, k, v, out, lse, B, Sq, Sk, H, KvH, D, window,
                             chunk, causal, scale, st);
  if (D <= 128)
    return launch<16, TQ, TK>(q, k, v, out, lse, B, Sq, Sk, H, KvH, D,
                              window, chunk, causal, scale, st);
  return launch<32, TQ, TK>(q, k, v, out, lse, B, Sq, Sk, H, KvH, D, window,
                            chunk, causal, scale, st);
}

// ---------------------------------------------------------------------------
// Tensor-core kernel (bf16 q, k, v)
// ---------------------------------------------------------------------------

constexpr int TC_WG_ROWS = 64;                 // packed rows a consumer
constexpr int TC_CONSUMERS = 2;                // consumer warpgroups
constexpr int TC_ROWS = TC_WG_ROWS * TC_CONSUMERS;
constexpr int TC_BK = hopper::TILE_ROWS;       // keys a tile
constexpr int TC_THREADS = 128 * (TC_CONSUMERS + 1);
constexpr int TC_PANEL = 64 * 128;             // 64 rows x 128 bytes
constexpr int TC_PRODUCER_REGS = 40;
constexpr int TC_CONSUMER_REGS = 232;

__host__ __device__ constexpr int tc_stages(int NP) { return NP >= 4 ? 2 : 3; }
__host__ __device__ constexpr int tc_smem_bytes(int NP) {
  // Q panels, K and V rings, 3 barriers a stage, 1024 bytes of alignment
  return TC_PANEL * NP * (TC_CONSUMERS + 2 * tc_stages(NP)) +
         8 * 3 * tc_stages(NP) + 1024;
}

struct TcParams {
  const __nv_bfloat16* q;
  __nv_bfloat16* out;
  float* lse;       // [B, H, Sq] natural log-sum-exp, or null (serving)
  int B, Sq, Sk, H, KvH, G, D;
  int window, chunk, causal;
  float scale_log2; // D^-0.5 * log2(e)
  int n_qtiles;     // ceil(Sq * G / TC_ROWS)
};

// Keys that query position i reaches: [key_lo(i), key_hi(i)), both
// non-decreasing in i.
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

// D16: D padded with zero columns to a multiple of 16 (64, 80, 128 or 256
// are instantiated); NP 64-column panels, the last LAST columns wide
template <int D16>
__global__ void __launch_bounds__(TC_THREADS, 1) flash_prefill_tc_kernel(
    const __grid_constant__ CUtensorMap tm_k,
    const __grid_constant__ CUtensorMap tm_v, const TcParams p) {
  constexpr int NP = (D16 + 63) / 64;
  constexpr int LAST = D16 - 64 * (NP - 1);
  constexpr int STAGES = tc_stages(NP);
  extern __shared__ uint8_t smem_raw[];
  uint32_t base = hopper::smem_addr(smem_raw);
  base += (1024u - (base & 1023u)) & 1023u;     // 128-byte swizzle atoms
  const uint32_t s_q = base;
  const uint32_t s_k = s_q + TC_PANEL * NP * TC_CONSUMERS;
  const uint32_t s_v = s_k + TC_PANEL * NP * STAGES;
  const uint32_t s_bar = s_v + TC_PANEL * NP * STAGES;
  auto full_k = [&](int s) { return s_bar + 8 * s; };
  auto full_v = [&](int s) { return s_bar + 8 * (STAGES + s); };
  auto empty = [&](int s) { return s_bar + 8 * (2 * STAGES + s); };

  // heaviest (latest) query tiles first
  const int per_tile = p.KvH * p.B;
  const int qt = p.n_qtiles - 1 - static_cast<int>(blockIdx.x) / per_tile;
  const int rem = static_cast<int>(blockIdx.x) % per_tile;
  const int kvh = rem % p.KvH;
  const int b = rem / p.KvH;
  const int rows_total = p.Sq * p.G;
  const int row0 = qt * TC_ROWS;

  // keys some query of this CTA reaches, in whole tiles from k_start
  const int i_first = row0 / p.G;
  const int i_last = min((row0 + TC_ROWS - 1) / p.G, p.Sq - 1);
  const int k_lo = key_lo(p, i_first);
  const int k_hi = key_hi(p, i_last);
  const int k_start = (k_lo / TC_BK) * TC_BK;
  const int n_tiles = k_hi > k_lo ? (k_hi - k_start + TC_BK - 1) / TC_BK : 0;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      hopper::mbar_init(full_k(s), 1);
      hopper::mbar_init(full_v(s), 1);
      hopper::mbar_init(empty(s), TC_CONSUMERS * 4);   // one a warp
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == TC_CONSUMERS) {
    // ---- producer: one thread issues every TMA load ----------------------
    hopper::setmaxnreg_dec<TC_PRODUCER_REGS>();
    if (threadIdx.x == TC_CONSUMERS * 128) {
      hopper::tma_prefetch(&tm_k);
      hopper::tma_prefetch(&tm_v);
      for (int n = 0; n < n_tiles; ++n) {
        const int s = n % STAGES;
        hopper::mbar_wait(empty(s), ((n / STAGES) & 1) ^ 1);
        const int k0 = k_start + n * TC_BK;
        hopper::mbar_expect_tx(full_k(s), TC_PANEL * NP);
#pragma unroll
        for (int pp = 0; pp < NP; ++pp)
          hopper::tma_load_4d(s_k + (s * NP + pp) * TC_PANEL, &tm_k,
                              full_k(s), 64 * pp, kvh, k0, b);
        hopper::mbar_expect_tx(full_v(s), TC_PANEL * NP);
#pragma unroll
        for (int pp = 0; pp < NP; ++pp)
          hopper::tma_load_4d(s_v + (s * NP + pp) * TC_PANEL, &tm_v,
                              full_v(s), 64 * pp, kvh, k0, b);
      }
    }
  } else {
    // ---- consumer: 64 packed rows ----------------------------------------
    hopper::setmaxnreg_inc<TC_CONSUMER_REGS>();
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32;
    const int lane = tid % 32;
    const int wrow0 = row0 + wg * TC_WG_ROWS;
    const uint32_t s_qw = s_q + wg * NP * TC_PANEL;

    // Q rows (packed) into 128-byte-swizzled panels by asynchronous 16-byte
    // copies, all in flight at once; zeros past D and Sq
    {
      constexpr int CH = D16 / 8;                // 16-byte chunks a row
      const int d_chunks = p.D / 8;
#pragma unroll 4
      for (int idx = tid; idx < TC_WG_ROWS * CH; idx += 128) {
        const int r = idx / CH;
        const int c = idx - r * CH;
        const int prow = wrow0 + r;
        const bool valid = prow < rows_total && c < d_chunks;
        const __nv_bfloat16* src = p.q;
        if (valid) {
          const int i = prow / p.G;
          const int g = prow - i * p.G;
          src += ((static_cast<int64_t>(b) * p.Sq + i) * p.H + kvh * p.G +
                  g) * p.D + 8 * c;
        }
        hopper::cp_async_16(s_qw + (c / 8) * TC_PANEL + r * 128 +
                                (((c % 8) ^ (r % 8)) * 16),
                            src, valid);
      }
      hopper::cp_async_wait_all();
      hopper::fence_proxy_async();
      hopper::named_barrier_sync(1 + wg, 128);
    }

    // this thread's two rows: r_a = 16 warp + lane / 4 and r_a + 8
    const int ra = warp * 16 + lane / 4;
    const int pos_a = (wrow0 + ra) / p.G;
    const int pos_b = (wrow0 + ra + 8) / p.G;
    const int lo_a = key_lo(p, pos_a), hi_a = key_hi(p, pos_a);
    const int lo_b = key_lo(p, pos_b), hi_b = key_hi(p, pos_b);
    // keys this warpgroup reaches; a tile inside [lo_last, hi_first) needs
    // no element mask
    const bool active = wrow0 < rows_total;
    const int wi_first = wrow0 / p.G;
    const int wi_last = min((wrow0 + TC_WG_ROWS - 1) / p.G, p.Sq - 1);
    const int wk_lo = active ? key_lo(p, wi_first) : 0;
    const int wk_hi = active ? key_hi(p, wi_last) : 0;
    const int lo_last = key_lo(p, wi_last);
    const int hi_first = key_hi(p, wi_first);
    const int c2 = 2 * (lane % 4);

    float o[NP][32];
#pragma unroll
    for (int pp = 0; pp < NP; ++pp)
#pragma unroll
      for (int i = 0; i < 32; ++i) o[pp][i] = 0.f;
    float m_a = -INFINITY, m_b = -INFINITY, l_a = 0.f, l_b = 0.f;

    for (int n = 0; n < n_tiles; ++n) {
      const int s = n % STAGES;
      const uint32_t parity = (n / STAGES) & 1;
      const int k0 = k_start + n * TC_BK;
      // waiting for the tile before releasing it keeps this warpgroup from
      // counting an arrival towards an earlier round of the empty barrier
      hopper::mbar_wait(full_k(s), parity);
      if (k0 >= wk_hi || k0 + TC_BK <= wk_lo) {
        if (lane == 0) hopper::mbar_arrive(empty(s));
        continue;
      }

      // S = Q K^T: 64 x 64, float32
      float sc[32];
      const uint32_t k_st = s_k + s * NP * TC_PANEL;
      hopper::fence_regs(sc);
      hopper::wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < D16 / 16; ++ks) {
        const uint32_t off = (ks / 4) * TC_PANEL + (ks % 4) * 32;
        hopper::wgmma_ss_m64n64k16(sc, hopper::make_desc(s_qw + off, 16, 1024),
                                   hopper::make_desc(k_st + off, 16, 1024),
                                   ks > 0);
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait0();
      hopper::fence_regs(sc);

      // mask, online softmax in log2 units
      const bool inside = k0 >= lo_last && k0 + TC_BK <= hi_first;
      float mx_a = -INFINITY, mx_b = -INFINITY;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int kj = k0 + 8 * j + c2 + e;
          float va = sc[4 * j + e] * p.scale_log2;
          float vb = sc[4 * j + 2 + e] * p.scale_log2;
          if (!inside) {
            if (kj < lo_a || kj >= hi_a) va = -INFINITY;
            if (kj < lo_b || kj >= hi_b) vb = -INFINITY;
          }
          sc[4 * j + e] = va;
          sc[4 * j + 2 + e] = vb;
          mx_a = fmaxf(mx_a, va);
          mx_b = fmaxf(mx_b, vb);
        }
      }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, off));
        mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, off));
      }
      const float mn_a = fmaxf(m_a, mx_a), mn_b = fmaxf(m_b, mx_b);
      // a row that has reached no key yet keeps m = -inf; subtract 0 then
      const float mu_a = mn_a == -INFINITY ? 0.f : mn_a;
      const float mu_b = mn_b == -INFINITY ? 0.f : mn_b;
      const float al_a = exp2f(m_a - mu_a), al_b = exp2f(m_b - mu_b);
      m_a = mn_a;
      m_b = mn_b;

      // P rounded to bf16 in the A-operand layout of m64nNk16: for keys
      // 16 kk .. 16 kk + 15, {row a, row b} x {cols 2c, 8 + 2c}; l sums
      // the rounded values, so O / l weighs V by weights that sum to 1
      uint32_t pa[4][4];
      float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int j = 2 * kk + h;
          const uint32_t ua = hopper::pack_bf16(exp2f(sc[4 * j] - mu_a),
                                                exp2f(sc[4 * j + 1] - mu_a));
          const uint32_t ub = hopper::pack_bf16(exp2f(sc[4 * j + 2] - mu_b),
                                                exp2f(sc[4 * j + 3] - mu_b));
          const float2 fa = hopper::unpack_bf16(ua);
          const float2 fb = hopper::unpack_bf16(ub);
          sum_a += fa.x + fa.y;
          sum_b += fb.x + fb.y;
          pa[kk][2 * h] = ua;
          pa[kk][2 * h + 1] = ub;
        }
      }
      l_a = l_a * al_a + sum_a;
      l_b = l_b * al_b + sum_b;
#pragma unroll
      for (int pp = 0; pp < NP; ++pp)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          o[pp][4 * j] *= al_a;
          o[pp][4 * j + 1] *= al_a;
          o[pp][4 * j + 2] *= al_b;
          o[pp][4 * j + 3] *= al_b;
        }

      // O += P V: V [64 keys x D] MN-major, panels 64 columns apart
      hopper::mbar_wait(full_v(s), parity);
      const uint32_t v_st = s_v + s * NP * TC_PANEL;
#pragma unroll
      for (int pp = 0; pp < NP; ++pp) hopper::fence_regs(o[pp]);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
        for (int pp = 0; pp < NP - 1; ++pp)
          hopper::wgmma_rs<64>(
              o[pp], pa[kk],
              hopper::make_desc(v_st + pp * TC_PANEL + kk * 2048, TC_PANEL,
                                1024));
        hopper::wgmma_rs<LAST>(
            o[NP - 1], pa[kk],
            hopper::make_desc(v_st + (NP - 1) * TC_PANEL + kk * 2048,
                              TC_PANEL, 1024));
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait0();
#pragma unroll
      for (int pp = 0; pp < NP; ++pp) hopper::fence_regs(o[pp]);
      if (lane == 0) hopper::mbar_arrive(empty(s));
    }

    // epilogue: O / l in bf16, rows past Sq and columns past D dropped
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      l_a += __shfl_xor_sync(0xffffffffu, l_a, off);
      l_b += __shfl_xor_sync(0xffffffffu, l_b, off);
    }
    const float inv_a = l_a > 0.f ? 1.f / l_a : 0.f;
    const float inv_b = l_b > 0.f ? 1.f / l_b : 0.f;
    // the row's natural log-sum-exp for training's backward: m is in log2
    // units of the scaled score and l sums the bf16-rounded exp2(s - m);
    // -inf for a row that reached no key.  One thread of each quad writes.
    if (p.lse != nullptr && (lane & 3) == 0) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int prow = wrow0 + ra + 8 * half;
        if (prow >= rows_total) continue;
        const int i = prow / p.G;
        const int g = prow - i * p.G;
        const float l = half ? l_b : l_a;
        const float m = half ? m_b : m_a;
        p.lse[(static_cast<int64_t>(b) * p.H + kvh * p.G + g) * p.Sq + i] =
            l > 0.f ? (m + log2f(l)) * 0.6931471805599453f : -INFINITY;
      }
    }
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int prow = wrow0 + ra + 8 * half;
      if (prow >= rows_total) continue;
      const int i = prow / p.G;
      const int g = prow - i * p.G;
      __nv_bfloat16* orow =
          p.out +
          ((static_cast<int64_t>(b) * p.Sq + i) * p.H + kvh * p.G + g) * p.D;
      const float inv = half ? inv_b : inv_a;
#pragma unroll
      for (int pp = 0; pp < NP; ++pp)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int col = 64 * pp + 8 * j + c2;
          if (col < p.D)
            *reinterpret_cast<uint32_t*>(orow + col) = hopper::pack_bf16(
                o[pp][4 * j + 2 * half] * inv,
                o[pp][4 * j + 2 * half + 1] * inv);
        }
    }
  }
}

template <int D16>
int launch_tc(const CUtensorMap& mk, const CUtensorMap& mv, const TcParams& p,
              cudaStream_t stream) {
  auto kern = flash_prefill_tc_kernel<D16>;
  constexpr int bytes = tc_smem_bytes((D16 + 63) / 64);
  static const cudaError_t attr = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const int grid = p.n_qtiles * p.KvH * p.B;
  kern<<<grid, TC_THREADS, bytes, stream>>>(mk, mv, p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point (loaded with ctypes).  q [B, Sq, H, D], k / v
// [B, Sk, KvH, D], out [B, Sq, H, D] (q's dtype), all contiguous; lse
// [B, H, Sq] float32 or null (then the kernel writes no LSE).  Launches
// on `stream`, does not synchronise, allocates nothing.  Returns
// cudaGetLastError() of the launch (or of the shared-memory attribute), or
// cudaErrorInvalidValue for an unsupported shape.
extern "C" int flash_prefill_launch(int q_bf16, int kv_bf16, const void* q,
                                    const void* k, const void* v, void* out,
                                    float* lse, int B, int Sq, int Sk, int H,
                                    int KvH, int D, int window, int chunk,
                                    int causal, float scale, void* stream) {
  if (B <= 0 || Sq <= 0 || H <= 0) return 0;
  if (KvH <= 0 || H % KvH != 0 || D <= 0 || D > 256 || Sk < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (q_bf16) {
    if (kv_bf16)
      return dispatch_d<__nv_bfloat16, __nv_bfloat16>(
          q, k, v, out, lse, B, Sq, Sk, H, KvH, D, window, chunk, causal,
          scale, st);
    return dispatch_d<__nv_bfloat16, float>(q, k, v, out, lse, B, Sq, Sk, H,
                                            KvH, D, window, chunk, causal,
                                            scale, st);
  }
  if (kv_bf16)
    return dispatch_d<float, __nv_bfloat16>(q, k, v, out, lse, B, Sq, Sk, H,
                                            KvH, D, window, chunk, causal,
                                            scale, st);
  return dispatch_d<float, float>(q, k, v, out, lse, B, Sq, Sk, H, KvH, D,
                                  window, chunk, causal, scale, st);
}

// Plain C entry point of the tensor-core kernel (loaded with ctypes).  q
// [B, Sq, H, D], k / v [B, Sk, KvH, D], out [B, Sq, H, D], all contiguous
// bf16, 16-byte aligned, D % 8 == 0; lse [B, H, Sq] float32 or null.
// Launches on `stream`, does not synchronise, allocates nothing.  Returns
// cudaGetLastError() of the launch, the error of the tensor maps or of the
// shared-memory attribute, or cudaErrorInvalidValue for an unsupported
// shape or alignment.
extern "C" int flash_prefill_tc_launch(const void* q, const void* k,
                                       const void* v, void* out, float* lse,
                                       int B, int Sq, int Sk, int H, int KvH,
                                       int D, int window, int chunk,
                                       int causal, float scale,
                                       void* stream) {
  if (B <= 0 || Sq <= 0 || H <= 0) return 0;
  if (KvH <= 0 || H % KvH != 0 || D <= 0 || D > 256 || D % 8 != 0 ||
      Sk < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  for (const void* ptr : {q, k, v, static_cast<const void*>(out)})
    if (reinterpret_cast<uintptr_t>(ptr) % 16 != 0)
      return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap mk, mv;
  int err = hopper::tile_map(k, B, Sk, KvH, D, &mk);
  if (err == 0) err = hopper::tile_map(v, B, Sk, KvH, D, &mv);
  if (err != 0) return err;
  TcParams p;
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.out = static_cast<__nv_bfloat16*>(out);
  p.lse = lse;
  p.B = B;
  p.Sq = Sq;
  p.Sk = Sk;
  p.H = H;
  p.KvH = KvH;
  p.G = H / KvH;
  p.D = D;
  p.window = window;
  p.chunk = chunk;
  p.causal = causal;
  p.scale_log2 = scale * 1.4426950408889634f;
  p.n_qtiles = (Sq * p.G + TC_ROWS - 1) / TC_ROWS;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // D padded to the next instantiated width (zero columns change no score;
  // four instantiations keep the build short)
  if (D <= 64) return launch_tc<64>(mk, mv, p, st);
  if (D <= 80) return launch_tc<80>(mk, mv, p, st);
  if (D <= 128) return launch_tc<128>(mk, mv, p, st);
  return launch_tc<256>(mk, mv, p, st);
}
