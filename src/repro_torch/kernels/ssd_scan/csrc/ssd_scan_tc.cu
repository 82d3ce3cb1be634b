// Mamba2 SSD (state-space duality) chunked scan on Hopper's tensor cores
// (sm_90a), for bf16 x, B and C.
//
// Replaces the Pallas TPU kernel src/repro/kernels/ssd_scan/kernel.py:27
// (_ssd_kernel, launched by ssd_scan_headmajor), whose grid walks the
// chunks of one (batch, head) in order on one core with the [P, N] state in
// VMEM.  Here the chunks run in parallel, with the SSD paper's chunked
// decomposition (arXiv:2405.21060, section 6), in three launches on one
// stream.  With Q = 128 tokens a chunk (the reference's chunk) and ca the
// inclusive prefix sum of log(max(a, 1e-37)) over the chunk, in double:
//
//   1. ssd_chunk_kernel, grid (chunks, head blocks x P tiles + G, Bsz), one
//      warpgroup a CTA.  A head-block CTA walks HB heads of one group and
//      one 64-column tile of P; for each it writes ca (in log2 units, as a
//      (hi, lo) float pair), the decay factors below, exp(ca_last) and the
//      chunk's own state S_c = (x o w)^T B with w_j = exp(ca_last - ca_j):
//      a [64 x N] product, wgmma m64n64k16 with A = (x o w)^T built in
//      registers from the x tile and B the chunk's B tile in shared memory.
//      The last G CTAs of each chunk compute C B^T once per (batch, group,
//      chunk): 128 x 128 in float32 (the three 64 x 64 blocks on and below
//      the diagonal, wgmma with both operands in shared memory), read by
//      all H / G heads of the group.
//   2. ssd_state_pass_kernel, one thread a 4-wide column of [P, N] per
//      (batch, head): walks the chunks in order with the carried state in
//      float32 registers, S <- exp(ca_last) S + S_c, writes the state
//      entering each chunk c > 0 in bf16 (S_prev, the operand of step 3)
//      and the final state in float32.  16 steps of scale-and-add at 2000
//      tokens; nothing else is sequential.  With one chunk (L <= 128) step
//      1 writes the final state itself and this launch is skipped.
//   3. ssd_output_kernel, grid (chunks, head blocks x P tiles, Bsz), two
//      warpgroups a CTA, each 64 of the chunk's rows.  C B^T is read once
//      into registers (in the accumulator's layout); per head
//        y = exp(ca_i) C S_prev^T  +  M x,
//        M[i][j] = (C B^T)[i][j] exp(ca_i - ca_j) for j <= i, else 0:
//      C S_prev^T is issued (wgmma, K-major C and S_prev in shared memory)
//      and runs while the warpgroup builds M in registers (only the 16-
//      column steps at or below its diagonal: 4 for rows 0-63, 8 for
//      64-127), its rows are scaled by exp(ca_i), then M x (M from
//      registers: the accumulator layout is the A-operand layout; x
//      MN-major in shared memory).  y goes out through shared memory as
//      whole 128-byte rows.
//
// Staging.  Tiles are 128-byte-swizzled panels of 64 bf16 columns
// (hopper_ptx.cuh), loaded with 16-byte cp.async and zero fill (when P and
// N are multiples of 8 and the pointers 16-byte aligned; otherwise by plain
// loads), padding P to 64 and N to a multiple of 64 in shared memory.  A CTA
// that walks heads keeps a ring of three (two at N = 256) heads' tiles in
// flight, one cp.async group a head.  The last chunk is masked, not padded
// in memory: a = 1 and x = B = C = 0 past L, so the final state is the
// state after exactly L tokens.  HB is chosen per shape (heads_per_cta) to
// fill the 132 SMs in whole waves.  wgmma (not mma.sync) because every
// product has a 64-row tile: 64 state rows p, 64 chunk rows i a warpgroup.
//
// Numerics.  Every product accumulates in float32; the carried and final
// states stay float32.  x, B and C are bf16 inputs, which the tensor cores
// take exactly; the three computed operands are rounded to bf16 once:
// x o w (the state product), M (after the float32 product of C B^T and the
// decay) and S_prev.  ca is a double prefix sum, since float32 differences
// ca_i - ca_j lose ~4e-6 over strong decay (ssd_scan.cu says why); step 3
// takes the decay in log2 units from the (hi, lo) pairs, (hi_i - hi_j) +
// (lo_i - lo_j), as exact as the double difference rounded to float, and
// 2^x by MUFU.EX2 (about 2 ulp).  Where a chunk's decay spans at most 2^120
// (every realistic mamba2 chunk), M = (C B^T e_i) f_j with e = 2^(ca - mid)
// and f = 2^(mid - ca) about the middle of the range, every factor within
// 2^+-60 (no overflow, no denormal); a stronger decay takes the per-entry
// 2^(ca_i - ca_j).  j > i is never evaluated (no inf * 0).  Against the
// sequential float32 scan this is about 7e-3 of y's max-abs at mamba2's
// shapes, the order of y's own bf16 rounding; ref.ssd_scan_chunked mirrors
// these steps on the CPU.
//
// Bound on an H100 at mamba2-780m's 2000-token prefill (H = 48, P = 64,
// G = 1, N = 128): 27.6 MB of inputs and outputs, 8.2 us at 3.35 TB/s,
// against 4.8 GFLOP of bf16 products at the reference's chunk of 128 (C B^T
// once per group), 4.8 us at 989 TFLOP/s: bytes.  The chunk states add
// 25 MB written in float32 and read once, and S_prev 12.6 MB written in
// bf16 and read once, mostly in the 50 MB L2.  Measured (PERF.md): about
// 0.05 ms of device time a call, 6x the bound: step 1 18.6 us, step 2
// 12.2 us, step 3 20.8 us; the tiles' cp.async issue and the chain from
// building M to the last product bound steps 1 and 3, not bytes.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper_ptx.cuh"

namespace {

constexpr int Q = 128;              // tokens a chunk
constexpr int PT = 64;              // state rows (columns p of x) a tile
constexpr int ROW = 128;            // bytes a swizzled panel row
constexpr int CHUNK_PANEL = Q * ROW;   // one 64-column panel of Q rows
constexpr int PT_PANEL = PT * ROW;     // one 64-column panel of PT rows

struct Params {
  const __nv_bfloat16* x;   // [Bsz, L, H, P]
  const float* a;           // [Bsz, L, H]
  const __nv_bfloat16* B;   // [Bsz, L, G, N]
  const __nv_bfloat16* C;   // [Bsz, L, G, N]
  __nv_bfloat16* y;         // [Bsz, L, H, P]
  float* state;             // [Bsz, H, P, N] final
  float* cb;                // [Bsz, nc, G, Q, Q] C B^T
  float2* ca;               // [Bsz, nc, H, 2Q] ca / ln 2 as (hi, lo)
                            // floats, then the decay factors (e, f)
  float* dA;                // [Bsz, nc, H] exp(ca_last)
  float* sc;                // [Bsz, nc, H, P, N] chunk states
  __nv_bfloat16* sp;        // [Bsz, nc, H, P, N] state entering the chunk
  int Bsz, L, H, P, G, N;
  int nc, ptiles, hb1, hb3;  // chunks, P tiles, heads a CTA (steps 1, 3)
};

// Byte offset of 16-byte chunk c of row r in panels of R rows.
__device__ __forceinline__ uint32_t swz(int R, int r, int c) {
  return (c >> 3) * R * ROW + r * ROW + (((c & 7) ^ (r & 7)) << 4);
}

// A [R x 64 NPAN] bf16 tile into NPAN swizzled panels at `dst`: row r from
// src + r * stride, rows < rows and columns < cols valid, zeros elsewhere;
// NT threads share the copy.  VEC: 16-byte asynchronous copies (cols % 8 == 0, 16-byte aligned rows;
// the caller commits and waits); else plain loads and stores.
template <bool VEC, int R, int NPAN, int NT>
__device__ __forceinline__ void load_tile(uint32_t dst,
                                          const __nv_bfloat16* src,
                                          int64_t stride, int rows, int cols,
                                          int tid) {
  constexpr int CPR = NPAN * 8;   // 16-byte chunks a row
#pragma unroll
  for (int idx = tid; idx < R * CPR; idx += NT) {
    const int r = idx / CPR;
    const int c = idx - r * CPR;
    const uint32_t d = dst + swz(R, r, c);
    if (VEC) {
      const bool valid = r < rows && 8 * c < cols;
      hopper::cp_async_16(d, valid ? src + r * stride + 8 * c : src, valid);
    } else {
      const uint16_t* s = reinterpret_cast<const uint16_t*>(src) +
                          r * stride + 8 * c;
      uint32_t v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 8 * c + 2 * e;
        const uint32_t lo = (r < rows && col < cols) ? s[2 * e] : 0u;
        const uint32_t hi = (r < rows && col + 1 < cols) ? s[2 * e + 1] : 0u;
        v[e] = lo | (hi << 16);
      }
      asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(d),
                   "r"(v[0]), "r"(v[1]), "r"(v[2]), "r"(v[3])
                   : "memory");
    }
  }
}

// 2^x (MUFU.EX2: about 2 ulp; results below 2^-126 flush to 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// x[j][p] of a swizzled x tile (one panel of Q rows) at `tile`
__device__ __forceinline__ float x_at(const uint8_t* tile, int j, int p) {
  return __bfloat162float(*reinterpret_cast<const __nv_bfloat16*>(
      tile + j * ROW + (((p >> 3) ^ (j & 7)) << 4) + (p & 7) * 2));
}

// ---------------------------------------------------------------------------
// step 1: chunk states, ca and exp(ca_last); C B^T once per group

constexpr int STAGES = 3;           // tiles in flight a CTA (ring slots)

__host__ __device__ constexpr int chunk_rest_bytes(int NP) {
  return NP > STAGES ? NP * CHUNK_PANEL : STAGES * CHUNK_PANEL;
}
__host__ __device__ constexpr int chunk_smem_bytes(int NP) {
  // B tile, then either the ring of x tiles or the C tile; w [Q] floats,
  // warp sums
  return NP * CHUNK_PANEL + chunk_rest_bytes(NP) + Q * 4 + 5 * 8 + 1024;
}

template <int NP, bool VEC>
__global__ void __launch_bounds__(128) ssd_chunk_kernel(const Params p) {
  extern __shared__ uint8_t smem_raw[];
  uint32_t base = hopper::smem_addr(smem_raw);
  const uint32_t pad = (1024u - (base & 1023u)) & 1023u;
  base += pad;
  const uint32_t s_b = base;
  const uint32_t s_rest = s_b + NP * CHUNK_PANEL;   // x tiles or C tile
  float* ws = reinterpret_cast<float*>(smem_raw + pad + NP * CHUNK_PANEL +
                                       chunk_rest_bytes(NP));
  double* wsum = reinterpret_cast<double*>(ws + Q);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int ra = warp * 16 + (lane >> 2);
  const int c2 = 2 * (lane & 3);
  const int c = blockIdx.x;
  const int b = blockIdx.z;
  const int t0 = c * Q;
  const int rows = min(Q, p.L - t0);
  const int hpg = p.H / p.G;
  const int n_state = (p.H / p.hb1) * p.ptiles;
  const int64_t tok0 = static_cast<int64_t>(b) * p.L + t0;

  if (static_cast<int>(blockIdx.y) >= n_state) {
    // ---- C B^T of group g: blocks (i, j) = (0, 0), (1, 0), (1, 1) of 64
    const int g = blockIdx.y - n_state;
    const int64_t off = tok0 * p.G * p.N + static_cast<int64_t>(g) * p.N;
    load_tile<VEC, Q, NP, 128>(s_b, p.B + off,
                               static_cast<int64_t>(p.G) * p.N, rows, p.N,
                               tid);
    load_tile<VEC, Q, NP, 128>(s_rest, p.C + off,
                               static_cast<int64_t>(p.G) * p.N, rows, p.N,
                               tid);
    hopper::cp_async_commit();
    hopper::cp_async_wait<0>();
    hopper::fence_proxy_async();
    __syncthreads();
    const int nks = (p.N + 15) / 16;
    float* cbo = p.cb + ((static_cast<int64_t>(b) * p.nc + c) * p.G + g) *
                            Q * Q;
#pragma unroll 1
    for (int blk = 0; blk < 3; ++blk) {
      const int ih = blk > 0;
      const int jh = blk > 1;
      float acc[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[i] = 0.f;
      hopper::fence_regs(acc);
      hopper::wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < 4 * NP; ++ks) {
        if (ks >= nks) break;
        const uint32_t k_off = (ks >> 2) * CHUNK_PANEL + (ks & 3) * 32;
        hopper::wgmma_ss_m64n64k16(
            acc, hopper::make_desc(s_rest + k_off + ih * 64 * ROW, 16, 1024),
            hopper::make_desc(s_b + k_off + jh * 64 * ROW, 16, 1024), 1);
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait0();
      hopper::fence_regs(acc);
#pragma unroll
      for (int n8 = 0; n8 < 8; ++n8) {
        const int j = 64 * jh + 8 * n8 + c2;
        const int i = 64 * ih + ra;
        *reinterpret_cast<float2*>(cbo + i * Q + j) =
            make_float2(acc[4 * n8], acc[4 * n8 + 1]);
        *reinterpret_cast<float2*>(cbo + (i + 8) * Q + j) =
            make_float2(acc[4 * n8 + 2], acc[4 * n8 + 3]);
      }
    }
    return;
  }

  // ---- chunk states of heads h0 .. h0 + hb1 - 1, rows p of tile pt
  const int hblk = blockIdx.y / p.ptiles;
  const int pt = blockIdx.y - hblk * p.ptiles;
  const int h0 = hblk * p.hb1;
  const int g = h0 / hpg;
  const int p0 = pt * PT;
  const int pcols = min(PT, p.P - p0);
  const int64_t x_stride = static_cast<int64_t>(p.H) * p.P;
  auto x_src = [&](int h) {
    return p.x + tok0 * x_stride + static_cast<int64_t>(h) * p.P + p0;
  };
  load_tile<VEC, Q, NP, 128>(
      s_b, p.B + tok0 * p.G * p.N + static_cast<int64_t>(g) * p.N,
      static_cast<int64_t>(p.G) * p.N, rows, p.N, tid);
  // ring: head k's x tile in slot k % STAGES, one cp.async group a head
  // (empty past the last head), STAGES - 1 heads ahead
  load_tile<VEC, Q, 1, 128>(s_rest, x_src(h0), x_stride, rows, pcols, tid);
  hopper::cp_async_commit();
#pragma unroll
  for (int k = 1; k < STAGES - 1; ++k) {
    if (k < p.hb1)
      load_tile<VEC, Q, 1, 128>(s_rest + k * CHUNK_PANEL, x_src(h0 + k),
                                x_stride, rows, pcols, tid);
    hopper::cp_async_commit();
  }

  // this thread's token's decay, one head ahead
  float av_next = tid < rows ? p.a[(tok0 + tid) * p.H + h0] : 1.f;
  for (int k = 0; k < p.hb1; ++k) {
    const int h = h0 + k;
    const uint8_t* x_tile = smem_raw + pad + NP * CHUNK_PANEL +
                            (k % STAGES) * CHUNK_PANEL;
    const float av = av_next;
    if (k + 1 < p.hb1 && tid < rows)
      av_next = p.a[(tok0 + tid) * p.H + h + 1];
    const int kn = k + STAGES - 1;
    if (kn < p.hb1)
      load_tile<VEC, Q, 1, 128>(s_rest + (kn % STAGES) * CHUNK_PANEL,
                                x_src(h0 + kn), x_stride, rows, pcols, tid);
    hopper::cp_async_commit();
    hopper::cp_async_wait<STAGES - 1>();
    // ca: inclusive prefix sum over the chunk, one token a thread
    double v = tid < rows ? log(static_cast<double>(fmaxf(av, 1e-37f))) : 0.0;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const double u = __shfl_up_sync(0xffffffffu, v, off);
      if (lane >= off) v += u;
    }
    if (lane == 31) wsum[warp] = v;
    if (tid == 0) wsum[4] = v;   // ca_0
    hopper::fence_proxy_async();
    __syncthreads();
    double total = 0.0;
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      if (w < warp) v += wsum[w];
      total += wsum[w];
    }
    ws[tid] = static_cast<float>(exp(total - v));
    const int64_t bch = (static_cast<int64_t>(b) * p.nc + c) * p.H + h;
    if (pt == 0) {
      // ca in log2 units as a (hi, lo) float pair, and the decay factors
      // e = 2^(ca - mid), f = 2^(mid - ca) about the middle of the chunk's
      // range (step 3 uses them when the range is at most 2^120)
      constexpr double LOG2E = 1.4426950408889634;
      const double v2 = v * LOG2E;
      const float hi = static_cast<float>(v2);
      const float lo = static_cast<float>(v2 - hi);
      const float mid = 0.5f * (static_cast<float>(wsum[4] * LOG2E) +
                                static_cast<float>(total * LOG2E));
      float2* cad = p.ca + bch * 2 * Q;
      cad[tid] = make_float2(hi, lo);
      cad[Q + tid] = make_float2(ex2((hi - mid) + lo), ex2((mid - hi) - lo));
      if (tid == 0) p.dA[bch] = static_cast<float>(exp(total));
    }
    __syncthreads();

    // A = (x o w)^T in the A-operand layout: rows p (ra, ra + 8), columns
    // j = 16 kk + {c2, c2 + 1, c2 + 8, c2 + 9}
    uint32_t pa[8][4];
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int j = 16 * kk + 8 * hh + c2;
        const float w0 = ws[j], w1 = ws[j + 1];
        pa[kk][2 * hh] = hopper::pack_bf16(x_at(x_tile, j, ra) * w0,
                                           x_at(x_tile, j + 1, ra) * w1);
        pa[kk][2 * hh + 1] = hopper::pack_bf16(
            x_at(x_tile, j, ra + 8) * w0, x_at(x_tile, j + 1, ra + 8) * w1);
      }
    }
    float acc[NP][32];
#pragma unroll
    for (int np = 0; np < NP; ++np)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[np][i] = 0.f;
#pragma unroll
    for (int np = 0; np < NP; ++np) hopper::fence_regs(acc[np]);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 8; ++kk)
#pragma unroll
      for (int np = 0; np < NP; ++np)
        hopper::wgmma_rs<64>(
            acc[np], pa[kk],
            hopper::make_desc(s_b + np * CHUNK_PANEL + kk * 16 * ROW,
                              CHUNK_PANEL, 1024));
    hopper::wgmma_commit();
    hopper::wgmma_wait0();
#pragma unroll
    for (int np = 0; np < NP; ++np) hopper::fence_regs(acc[np]);

    // one chunk: its state is the final state (no state pass)
    float* sco = p.nc == 1
                     ? p.state + (static_cast<int64_t>(b) * p.H + h) * p.P * p.N
                     : p.sc + bch * p.P * p.N;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int pr = p0 + ra + 8 * half;
      if (pr >= p.P) continue;
#pragma unroll
      for (int np = 0; np < NP; ++np)
#pragma unroll
        for (int n8 = 0; n8 < 8; ++n8) {
          const int n = 64 * np + 8 * n8 + c2;
          if (n < p.N)
            *reinterpret_cast<float2*>(sco + static_cast<int64_t>(pr) * p.N +
                                       n) =
                make_float2(acc[np][4 * n8 + 2 * half],
                            acc[np][4 * n8 + 2 * half + 1]);
        }
    }
    __syncthreads();   // x tile k and ws are read: slot free for k + 3
  }
}

// ---------------------------------------------------------------------------
// step 2: the state pass

__global__ void __launch_bounds__(256) ssd_state_pass_kernel(const Params p) {
  const int64_t pn4 = static_cast<int64_t>(p.P) * p.N / 4;
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (idx >= static_cast<int64_t>(p.Bsz) * p.H * pn4) return;
  const int64_t bh = idx / pn4;
  const int64_t e = (idx - bh * pn4) * 4;
  const int b = static_cast<int>(bh / p.H);
  const int h = static_cast<int>(bh - static_cast<int64_t>(b) * p.H);
  const int64_t pn = pn4 * 4;
  float4 S = make_float4(0.f, 0.f, 0.f, 0.f);
  const int64_t bc0 = static_cast<int64_t>(b) * p.nc;
  float4 nxt = p.nc > 0 ? __ldg(reinterpret_cast<const float4*>(
                              p.sc + (bc0 * p.H + h) * pn + e))
                        : S;
  for (int c = 0; c < p.nc; ++c) {
    const int64_t bch = (bc0 + c) * p.H + h;
    const float4 cur = nxt;
    const float d = __ldg(p.dA + bch);
    if (c + 1 < p.nc)
      nxt = __ldg(reinterpret_cast<const float4*>(p.sc + (bch + p.H) * pn +
                                                  e));
    if (c > 0) {
      uint2 v;
      v.x = hopper::pack_bf16(S.x, S.y);
      v.y = hopper::pack_bf16(S.z, S.w);
      *reinterpret_cast<uint2*>(p.sp + bch * pn + e) = v;
    }
    S.x = fmaf(d, S.x, cur.x);
    S.y = fmaf(d, S.y, cur.y);
    S.z = fmaf(d, S.z, cur.z);
    S.w = fmaf(d, S.w, cur.w);
  }
  *reinterpret_cast<float4*>(p.state + bh * pn + e) = S;
}

// ---------------------------------------------------------------------------
// step 3: the outputs

__host__ __device__ constexpr int output_buf_bytes(int NP) {
  // one ring slot: x tile, S_prev tile, ca pairs and decay factors [Q]
  return CHUNK_PANEL + NP * PT_PANEL + Q * 16;
}
__host__ __device__ constexpr int output_stages(int NP) {
  return NP >= 4 ? 2 : STAGES;   // N = 256: two slots fit beside the rest
}
__host__ __device__ constexpr int output_smem_bytes(int NP) {
  // C tile, the ring, y staging (128 rows of 128 bytes)
  return NP * CHUNK_PANEL + output_stages(NP) * output_buf_bytes(NP) +
         CHUNK_PANEL + 1024;
}

template <int V>
struct Int {
  static constexpr int value = V;
};

template <int NP, bool VEC>
__global__ void __launch_bounds__(256, 1) ssd_output_kernel(const Params p) {
  extern __shared__ uint8_t smem_raw[];
  uint32_t base = hopper::smem_addr(smem_raw);
  const uint32_t pad = (1024u - (base & 1023u)) & 1023u;
  base += pad;
  constexpr int BUF = output_buf_bytes(NP);
  constexpr int NS = output_stages(NP);
  const uint32_t s_c = base;
  auto s_x = [&](int k) {
    return s_c + NP * CHUNK_PANEL + (k % NS) * BUF;
  };
  auto s_sp = [&](int k) { return s_x(k) + CHUNK_PANEL; };
  auto s_ca = [&](int k) { return s_sp(k) + NP * PT_PANEL; };
  const uint32_t s_y = s_c + NP * CHUNK_PANEL + NS * BUF;   // y staging

  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int wtid = tid & 127;
  const int warp = wtid >> 5;
  const int lane = tid & 31;
  const int ra = warp * 16 + (lane >> 2);
  const int c2 = 2 * (lane & 3);
  const int c = blockIdx.x;
  const int b = blockIdx.z;
  const int t0 = c * Q;
  const int rows = min(Q, p.L - t0);
  const int hblk = blockIdx.y / p.ptiles;
  const int pt = blockIdx.y - hblk * p.ptiles;
  const int h0 = hblk * p.hb3;
  const int g = h0 / (p.H / p.G);
  const int p0 = pt * PT;
  const int pcols = min(PT, p.P - p0);
  const int64_t tok0 = static_cast<int64_t>(b) * p.L + t0;
  const int64_t x_stride = static_cast<int64_t>(p.H) * p.P;
  const int64_t bc = static_cast<int64_t>(b) * p.nc + c;

  // ring: head k's x, S_prev and ca tiles in slot k % NS, one cp.async
  // group a head (empty past the last head), NS - 1 heads ahead
  auto stage = [&](int k) {
    if (k < p.hb3) {
      const int h = h0 + k;
      load_tile<VEC, Q, 1, 256>(
          s_x(k), p.x + tok0 * x_stride + static_cast<int64_t>(h) * p.P + p0,
          x_stride, rows, pcols, tid);
      const int64_t bch = bc * p.H + h;
      if (c > 0)
        load_tile<VEC, PT, NP, 256>(s_sp(k), p.sp + (bch * p.P + p0) * p.N,
                                    p.N, pcols, p.N, tid);
      if (tid < Q)
        hopper::cp_async_16(s_ca(k) + 16 * tid, p.ca + bch * 2 * Q + 2 * tid,
                            true);
    }
    hopper::cp_async_commit();
  };
  load_tile<VEC, Q, NP, 256>(
      s_c, p.C + tok0 * p.G * p.N + static_cast<int64_t>(g) * p.N,
      static_cast<int64_t>(p.G) * p.N, rows, p.N, tid);
#pragma unroll
  for (int k = 0; k < NS - 1; ++k) stage(k);

  // this warpgroup's rows of C B^T, in the accumulator layout (columns
  // j < 64 (wg + 1) only: the rest is above the diagonal)
  const int ia = 64 * wg + ra;
  const int ib = ia + 8;
  float cbr[16][4];
  {
    const float* cbp = p.cb + (bc * p.G + g) * Q * Q;
#pragma unroll
    for (int n8 = 0; n8 < 16; ++n8) {
      if (n8 < 8 * (wg + 1)) {
        const float2 u = __ldg(reinterpret_cast<const float2*>(
            cbp + ia * Q + 8 * n8 + c2));
        const float2 w = __ldg(reinterpret_cast<const float2*>(
            cbp + ib * Q + 8 * n8 + c2));
        cbr[n8][0] = u.x;
        cbr[n8][1] = u.y;
        cbr[n8][2] = w.x;
        cbr[n8][3] = w.y;
      } else {
        cbr[n8][0] = cbr[n8][1] = cbr[n8][2] = cbr[n8][3] = 0.f;
      }
    }
  }
  const bool active = 64 * wg < rows;

  // one head for this warpgroup's 64 rows; KK 16-column steps of M (4 for
  // rows 0..63, 8 for 64..127: the rest is above the diagonal)
  auto head = [&](int k, auto kk_steps) {
    constexpr int KK = decltype(kk_steps)::value;
    const int h = h0 + k;
    const float2* cap = reinterpret_cast<const float2*>(
        smem_raw + pad + (s_ca(k) - base));
    const float2* efp = cap + Q;   // (e, f) decay factors
    const float2 ca_a = cap[ia];
    const float2 ca_b = cap[ib];
    float acc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = 0.f;
    // C S_prev^T, asynchronously while M is built
    if (c > 0) {
      hopper::fence_regs(acc);
      hopper::wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < 4 * NP; ++ks)
        hopper::wgmma_ss_m64n64k16(
            acc,
            hopper::make_desc(s_c + (ks >> 2) * CHUNK_PANEL + wg * 64 * ROW +
                                  (ks & 3) * 32,
                              16, 1024),
            hopper::make_desc(s_sp(k) + (ks >> 2) * PT_PANEL + (ks & 3) * 32,
                              16, 1024),
            1);
      hopper::wgmma_commit();
    }
    // M in bf16, the A-operand layout: rows ia, ib; columns 16 kk + ...
    // Where the chunk's decay spans at most 2^120 (every factor within
    // 2^+-60), M = (C B^T e_i) f_j; else each 2^(ca_i - ca_j), in log2
    // units from the (hi, lo) pairs, as exact as the double difference
    // rounded to float.  j > i is never evaluated: 0.
    uint32_t pa[KK][4];
    auto build = [&](auto factored) {
      const float e_a = efp[ia].x, e_b = efp[ib].x;
#pragma unroll
      for (int kk = 0; kk < KK; ++kk) {
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int n8 = 2 * kk + hh;
          const int j = 8 * n8 + c2;
          float m[4];
          if (decltype(factored)::value) {
            const float f0 = efp[j].y, f1 = efp[j + 1].y;
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int jj = j + (e & 1);
              const int ii = e < 2 ? ia : ib;
              m[e] = jj <= ii ? (cbr[n8][e] * (e < 2 ? e_a : e_b)) *
                                    ((e & 1) ? f1 : f0)
                              : 0.f;
            }
          } else {
            const float2 cj0 = cap[j];
            const float2 cj1 = cap[j + 1];
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int jj = j + (e & 1);
              const int ii = e < 2 ? ia : ib;
              const float2 ci = e < 2 ? ca_a : ca_b;
              const float2 cj = (e & 1) ? cj1 : cj0;
              m[e] = jj <= ii ? cbr[n8][e] *
                                    ex2((ci.x - cj.x) + (ci.y - cj.y))
                              : 0.f;
            }
          }
          pa[kk][2 * hh] = hopper::pack_bf16(m[0], m[1]);
          pa[kk][2 * hh + 1] = hopper::pack_bf16(m[2], m[3]);
        }
      }
    };
    if (cap[0].x - cap[Q - 1].x <= 120.f)
      build(Int<1>{});
    else
      build(Int<0>{});
    if (c > 0) {
      hopper::wgmma_wait0();
      hopper::fence_regs(acc);
      const float ea = static_cast<float>(
          exp2(static_cast<double>(ca_a.x) + ca_a.y));
      const float eb = static_cast<float>(
          exp2(static_cast<double>(ca_b.x) + ca_b.y));
#pragma unroll
      for (int n8 = 0; n8 < 8; ++n8) {
        acc[4 * n8] *= ea;
        acc[4 * n8 + 1] *= ea;
        acc[4 * n8 + 2] *= eb;
        acc[4 * n8 + 3] *= eb;
      }
    }
    // + M x
    hopper::fence_regs(acc);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KK; ++kk)
      hopper::wgmma_rs<64>(
          acc, pa[kk],
          hopper::make_desc(s_x(k) + kk * 16 * ROW, CHUNK_PANEL, 1024));
    hopper::wgmma_commit();
    hopper::wgmma_wait0();
    hopper::fence_regs(acc);

    __nv_bfloat16* yb = p.y + tok0 * x_stride +
                        static_cast<int64_t>(h) * p.P + p0;
    if (VEC) {
      // through this warpgroup's staging rows, then 16-byte stores of
      // whole 128-byte rows
      const uint32_t sy = s_y + wg * 64 * ROW;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = ra + 8 * half;
#pragma unroll
        for (int n8 = 0; n8 < 8; ++n8)
          asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(
                           sy + r * ROW + ((n8 ^ (r & 7)) << 4) + 2 * c2),
                       "r"(hopper::pack_bf16(acc[4 * n8 + 2 * half],
                                             acc[4 * n8 + 2 * half + 1]))
                       : "memory");
      }
      hopper::named_barrier_sync(1 + wg, 128);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int idx = wtid + 128 * q;
        const int r = idx >> 3;
        const int cc = idx & 7;
        uint32_t v[4];
        asm volatile("ld.shared.v4.b32 {%0, %1, %2, %3}, [%4];\n"
                     : "=r"(v[0]), "=r"(v[1]), "=r"(v[2]), "=r"(v[3])
                     : "r"(sy + r * ROW + ((cc ^ (r & 7)) << 4))
                     : "memory");
        if (64 * wg + r < rows && 8 * cc < pcols)
          *reinterpret_cast<uint4*>(yb + (64 * wg + r) * x_stride + 8 * cc) =
              make_uint4(v[0], v[1], v[2], v[3]);
      }
    } else {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int i = half ? ib : ia;
        if (i >= rows) continue;
        __nv_bfloat16* yr = yb + i * x_stride;
#pragma unroll
        for (int n8 = 0; n8 < 8; ++n8) {
          const int col = 8 * n8 + c2;
          if (col < pcols)
            yr[col] = __float2bfloat16(acc[4 * n8 + 2 * half]);
          if (col + 1 < pcols)
            yr[col + 1] = __float2bfloat16(acc[4 * n8 + 2 * half + 1]);
        }
      }
    }
  };

  for (int k = 0; k < p.hb3; ++k) {
    stage(k + NS - 1);
    hopper::cp_async_wait<NS - 1>();
    hopper::fence_proxy_async();
    __syncthreads();
    if (active) {
      if (wg == 0)
        head(k, Int<4>{});
      else
        head(k, Int<8>{});
    }
    __syncthreads();   // slot k and the staging rows are read
  }
}


// ---------------------------------------------------------------------------
// host side

int num_sms() {
  static const int n = [] {
    int dev = 0, v = 132;
    if (cudaGetDevice(&dev) == cudaSuccess)
      cudaDeviceGetAttribute(&v, cudaDevAttrMultiProcessorCount, dev);
    return v;
  }();
  return n;
}

// Heads a CTA walks: the divisor d <= 8 of H / G that minimises the heads
// an SM walks in turn, ceil(CTAs / (SMs x CTAs an SM)) x d; on a tie the
// larger d (fewer CTAs, each reloading the shared tiles less often).
int heads_per_cta(const Params& p, int per_sm) {
  const int hpg = p.H / p.G;
  const int64_t slots = static_cast<int64_t>(num_sms()) * per_sm;
  int best = 1;
  int64_t best_cost = -1;
  for (int d = 1; d <= 8 && d <= hpg; ++d) {
    if (hpg % d) continue;
    const int64_t ctas =
        static_cast<int64_t>(p.nc) * p.Bsz * p.ptiles * (p.H / d);
    const int64_t cost = (ctas + slots - 1) / slots * d;
    if (best_cost < 0 || cost <= best_cost) {
      best = d;
      best_cost = cost;
    }
  }
  return best;
}

template <int NP, bool VEC>
int launch_np(const Params& p, cudaStream_t st) {
  auto k1 = ssd_chunk_kernel<NP, VEC>;
  auto k3 = ssd_output_kernel<NP, VEC>;
  constexpr int b1 = chunk_smem_bytes(NP);
  constexpr int b3 = output_smem_bytes(NP);
  static const cudaError_t attr = [&] {
    cudaError_t e = cudaFuncSetAttribute(
        k1, cudaFuncAttributeMaxDynamicSharedMemorySize, b1);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(
          k3, cudaFuncAttributeMaxDynamicSharedMemorySize, b3);
    return e;
  }();
  if (attr != cudaSuccess) return static_cast<int>(attr);
  if (p.nc > 0) {
    dim3 g1(p.nc, (p.H / p.hb1) * p.ptiles + p.G, p.Bsz);
    k1<<<g1, 128, b1, st>>>(p);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  if (p.nc != 1) {   // one chunk: step 1 wrote the final state
    const int64_t n4 = static_cast<int64_t>(p.Bsz) * p.H * p.P * p.N / 4;
    ssd_state_pass_kernel<<<static_cast<unsigned>((n4 + 255) / 256), 256, 0,
                            st>>>(p);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess || p.nc == 0) return static_cast<int>(e);
  }
  dim3 g3(p.nc, (p.H / p.hb3) * p.ptiles, p.Bsz);
  k3<<<g3, 256, b3, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <bool VEC>
int launch_vec(const Params& p, cudaStream_t st) {
  switch ((p.N + 63) / 64) {
    case 1: return launch_np<1, VEC>(p, st);
    case 2: return launch_np<2, VEC>(p, st);
    case 3: return launch_np<3, VEC>(p, st);
    default: return launch_np<4, VEC>(p, st);
  }
}

size_t align256(size_t n) { return (n + 255) & ~static_cast<size_t>(255); }

// Offsets of the scratch arrays in the workspace; returns its size.
size_t carve(int Bsz, int L, int H, int P, int G, int N, size_t off[5]) {
  const size_t nc = (static_cast<size_t>(L) + Q - 1) / Q;
  const size_t bc = static_cast<size_t>(Bsz) * nc;
  const size_t sizes[5] = {bc * G * Q * Q * 4, bc * H * Q * 16, bc * H * 4,
                           bc * H * P * N * 4, bc * H * P * N * 2};
  size_t at = 0;
  for (int i = 0; i < 5; ++i) {
    off[i] = at;
    at += align256(sizes[i]);
  }
  return at;
}

}  // namespace

// Bytes of scratch ssd_scan_tc_launch needs: C B^T per (batch, chunk,
// group), ca, exp(ca_last), the chunk states (float32) and the state
// entering each chunk (bf16).
extern "C" long long ssd_scan_tc_workspace_bytes(int Bsz, int L, int H, int P,
                                                 int G, int N) {
  size_t off[5];
  return static_cast<long long>(carve(Bsz, L, H, P, G, N, off));
}

// Plain C entry point (loaded with ctypes).  x [Bsz, L, H, P], B / C
// [Bsz, L, G, N] bf16, a [Bsz, L, H] float32, y [Bsz, L, H, P] bf16, state
// [Bsz, H, P, N] float32, all contiguous; `work` 256-byte aligned, of
// ssd_scan_tc_workspace_bytes; sprev null, or (training) a bf16 [Bsz,
// ceil(L / 128), H, P, N] buffer that step 2 writes S_prev into instead of
// the workspace (chunk 0's left unwritten), which the backward kernels
// read.  Launches three kernels (two for one chunk) on `stream`, does not
// synchronise, allocates nothing.  Returns
// cudaGetLastError() of the launches (or of the shared-memory attribute),
// or cudaErrorInvalidValue for an unsupported shape.
extern "C" int ssd_scan_tc_launch(const void* x, const void* a, const void* B,
                                  const void* C, void* y, void* state,
                                  void* work, void* sprev, int Bsz, int L,
                                  int H, int P, int G, int N, void* stream) {
  if (Bsz <= 0 || H <= 0 || P <= 0) return 0;
  if (L < 0 || G <= 0 || H % G != 0 || N <= 0 || N > 256 || N % 4 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (reinterpret_cast<uintptr_t>(work) % 256 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  size_t off[5];
  carve(Bsz, L, H, P, G, N, off);
  uint8_t* w = static_cast<uint8_t*>(work);
  Params p;
  p.x = static_cast<const __nv_bfloat16*>(x);
  p.a = static_cast<const float*>(a);
  p.B = static_cast<const __nv_bfloat16*>(B);
  p.C = static_cast<const __nv_bfloat16*>(C);
  p.y = static_cast<__nv_bfloat16*>(y);
  p.state = static_cast<float*>(state);
  p.cb = reinterpret_cast<float*>(w + off[0]);
  p.ca = reinterpret_cast<float2*>(w + off[1]);
  p.dA = reinterpret_cast<float*>(w + off[2]);
  p.sc = reinterpret_cast<float*>(w + off[3]);
  p.sp = sprev ? static_cast<__nv_bfloat16*>(sprev)
              : reinterpret_cast<__nv_bfloat16*>(w + off[4]);
  p.Bsz = Bsz;
  p.L = L;
  p.H = H;
  p.P = P;
  p.G = G;
  p.N = N;
  p.nc = (L + Q - 1) / Q;
  p.ptiles = (P + PT - 1) / PT;
  p.hb1 = heads_per_cta(p, 2);   // 128 threads: two CTAs an SM
  p.hb3 = heads_per_cta(p, 1);   // 256 threads at up to 255 registers
  bool vec = P % 8 == 0 && N % 8 == 0;
  for (const void* ptr : {x, B, C, static_cast<const void*>(y)})
    vec = vec && reinterpret_cast<uintptr_t>(ptr) % 16 == 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return vec ? launch_vec<true>(p, st) : launch_vec<false>(p, st);
}
