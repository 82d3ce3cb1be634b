// Gradient of the Mamba2 SSD chunked scan on Hopper's tensor cores
// (sm_90a), for bf16 x, B and C: the training path of mamba2-780m.
//
// The reference has no Pallas backward: its training step differentiates
// the sequential oracle src/repro/kernels/ssd_scan/ref.py:21-42 with XLA's
// autodiff.  This is the gradient of ssd_scan_tc.cu's chunked forward (the
// SSD paper's decomposition, arXiv:2405.21060, section 6), laid out like
// it: chunks of Q = 128 in parallel, a short reverse pass over the chunks,
// then per chunk the products on the tensor cores (bf16 wgmma, float32
// sums), and a fixed-order sum over each group's heads.  It reads the
// bf16 state entering each chunk, S_prev, that the forward wrote for it.
// With ca the prefix sum of log(max(a, 1e-37)) in double over a chunk,
// e_i = exp(ca_i), w_j = exp(ca_last - ca_j), D_ij = exp(ca_i - ca_j) for
// j <= i (never evaluated above the diagonal) and dS the gradient at a
// chunk's end, five launches on one stream:
//
//   1. tcb_chunk_kernel, grid (chunks, H, Bsz), one warpgroup: ca, e, w,
//      exp(ca_last), and the chunk-local state gradient (e o dy)^T C
//      [P, N], A = (e o dy)^T built in registers, B the C tile.
//   2. tcb_state_pass_kernel: the chunks in reverse, dS[c] =
//      exp(ca_last[c + 1]) dS[c + 1] + (local gradient)[c + 1] carried in
//      float32, seeded by dS_fin, each dS written in bf16.
//   3. tcb_head_kernel, grid (chunks, H, Bsz), two warpgroups (64 rows j
//      each): C S_prev^T and B dS^T (both operands in shared memory),
//      staged in shared memory for the d log a terms e_i dy_i . (C
//      S_prev^T)_i and w_j x_j . (B dS^T)_j (a thread a row), the latter
//      also dx's state term; B C^T; M^T built in registers from it,
//      dx += M^T dy (dy MN-major); x dy^T, from which (dy x^T) o D goes
//      to the workspace and (dy x^T) o M to shared memory for d log a,
//      summed directly as in ssd_scan_bwd.cu (a prefix sum over j of each
//      row, then down each column: no pair of terms cancels, so d log a
//      keeps its relative accuracy where a is small).
//   4. tcb_dcb_sum_kernel: sum_h (dy x^T) o D over each group's heads in
//      ascending order (no atomics: two calls give the same bits).
//   5. tcb_group_kernel, grid (chunks, G x 2 x ceil(N / 64) x 2, Bsz), one
//      warpgroup a 64 x 64 tile of dC or of dB: the group sum of
//      (dy x^T) o D times B (or its transpose times C), then over the
//      group's heads in ascending order (e o dy) S_prev (or (w o x) dS),
//      the A operands built in registers from global memory, the B tiles
//      in a ring of three in shared memory.
//
// Numerics: x, dy, B, C and S_prev are bf16 inputs, which the tensor cores
// take exactly; the operands computed for them are rounded to bf16 once:
// e o dy, dS, M^T, the group sum of (dy x^T) o D and w o x.  Every product
// accumulates in float32; the reverse pass carries float32; d log a's terms
// take M in float32.  ref.ssd_scan_chunked_backward(..., tensor_core=True)
// mirrors these steps on the CPU.
//
// Limits: P <= 64 (one 64-column panel), N <= 128 (the head kernel holds
// B, C, dS and S_prev tiles beside a Q x Q float tile); other shapes and
// float32 operands take ssd_scan_bwd.cu.  Bound at mamba2-780m's training
// shape [1, 4096, 48, 64], G 1, N 128: about 108 MB of inputs and outputs
// (0.032 ms at 3.35 TB/s) against 23 GFLOP of products (0.023 ms at the
// bf16 peak): bytes.  Measured (PERF.md): about 0.55 device ms a call,
// 0.06 of the bound, the head kernel 0.33 of it: one head a CTA, its tiles
// loaded before any product (no ring), one CTA an SM.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper_ptx.cuh"

namespace {

typedef __nv_bfloat16 bf;
constexpr int Q = 128;              // tokens a chunk (the forward's)
constexpr int PT = 64;              // state rows p a tile
constexpr int ROW = 128;            // bytes a swizzled panel row
constexpr int CHUNK_PANEL = Q * ROW;   // one 64-column panel of Q rows
constexpr int PT_PANEL = PT * ROW;     // one 64-column panel of PT rows
constexpr int LDQ = Q + 1;          // row stride of the Q x Q float tile
constexpr int GSTAGES = 3;          // head tiles in flight (group kernel)

struct Params {
  const bf* x;          // [Bsz, L, H, P]
  const float* a;       // [Bsz, L, H]
  const bf* B;          // [Bsz, L, G, N]
  const bf* C;          // [Bsz, L, G, N]
  const bf* dy;         // [Bsz, L, H, P]
  const float* dsf;     // [Bsz, H, P, N] or null
  const bf* sp;         // [Bsz, nc, H, P, N] (chunk 0 unread)
  bf* dx;               // [Bsz, L, H, P]
  float* da;            // [Bsz, L, H]
  bf* dB;               // [Bsz, L, G, N]
  bf* dC;               // [Bsz, L, G, N]
  double* ca;           // [Bsz, nc, H, Q]
  float* ew;            // [Bsz, nc, H, 2, Q]: e, then w
  float* dA;            // [Bsz, nc, H] exp(ca_last)
  float* dsc;           // [Bsz, nc, H, P, N] chunk-local state gradients
  bf* dsb;              // [Bsz, nc, H, P, N] dS at each chunk's end
  float* dcbh;          // [Bsz, nc, H, Q, Q] (dy x^T) o D, as [j][i]
  float* dcb;           // [Bsz, nc, G, Q, Q] their group sums, as [j][i]
  int Bsz, L, H, P, G, N, nc;
};

// Byte offset of 16-byte chunk c of row r in panels of R rows.
__device__ __forceinline__ uint32_t swz(int R, int r, int c) {
  return (c >> 3) * R * ROW + r * ROW + (((c & 7) ^ (r & 7)) << 4);
}

// A [R x 64 NPAN] bf16 tile into NPAN swizzled panels at `dst`: row r from
// src + r * stride, rows < rows and columns < cols valid, zeros elsewhere;
// NT threads share the copy.  VEC: 16-byte asynchronous copies (cols % 8
// == 0, 16-byte aligned rows; the caller commits and waits); else plain
// loads and stores.  (ssd_scan_tc.cu's.)
template <bool VEC, int R, int NPAN, int NT>
__device__ __forceinline__ void load_tile(uint32_t dst, const bf* src,
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

// element (r, c) of a swizzled tile of R-row panels at `tile`, as float
template <int R>
__device__ __forceinline__ float tile_at(const uint8_t* tile, int r, int c) {
  return __bfloat162float(*reinterpret_cast<const bf*>(
      tile + (c >> 6) * R * ROW + r * ROW +
      ((((c & 63) >> 3) ^ (r & 7)) << 4) + (c & 7) * 2));
}

// a bf16 value of global memory as float (0 where not `valid`)
__device__ __forceinline__ float ld_bf(const bf* p, bool valid) {
  return valid ? __bfloat162float(*p) : 0.f;
}

template <int V>
struct Int {
  static constexpr int value = V;
};

// ---------------------------------------------------------------------------
// 1. ca, e, w, exp(ca_last) and the chunk-local state gradient

__host__ __device__ constexpr int chunk_smem_bytes(int NP) {
  // C tile (NP panels), dy tile, e [Q] floats, warp sums
  return NP * CHUNK_PANEL + CHUNK_PANEL + Q * 4 + 4 * 8 + 1024;
}

template <int NP, bool VEC>
__global__ void __launch_bounds__(128) tcb_chunk_kernel(const Params p) {
  extern __shared__ uint8_t smem_raw[];
  uint32_t base = hopper::smem_addr(smem_raw);
  const uint32_t pad = (1024u - (base & 1023u)) & 1023u;
  base += pad;
  const uint32_t s_c = base;
  const uint32_t s_dy = s_c + NP * CHUNK_PANEL;
  const uint8_t* dy_tile = smem_raw + pad + NP * CHUNK_PANEL;
  float* es = reinterpret_cast<float*>(smem_raw + pad + (NP + 1) *
                                       CHUNK_PANEL);
  double* wsum = reinterpret_cast<double*>(es + Q);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int ra = warp * 16 + (lane >> 2);
  const int c2 = 2 * (lane & 3);
  const int c = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int g = h / (p.H / p.G);
  const int t0 = c * Q;
  const int rows = min(Q, p.L - t0);
  const int64_t tok0 = static_cast<int64_t>(b) * p.L + t0;
  const int64_t bch = (static_cast<int64_t>(b) * p.nc + c) * p.H + h;
  const int64_t xs = static_cast<int64_t>(p.H) * p.P;

  load_tile<VEC, Q, NP, 128>(s_c, p.C + tok0 * p.G * p.N +
                                      static_cast<int64_t>(g) * p.N,
                             static_cast<int64_t>(p.G) * p.N, rows, p.N, tid);
  load_tile<VEC, Q, 1, 128>(s_dy, p.dy + tok0 * xs +
                                      static_cast<int64_t>(h) * p.P,
                            xs, rows, p.P, tid);
  hopper::cp_async_commit();
  // ca: inclusive prefix sum over the chunk, one token a thread
  double v = tid < rows ? log(static_cast<double>(fmaxf(
                              p.a[(tok0 + tid) * p.H + h], 1e-37f)))
                        : 0.0;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const double u = __shfl_up_sync(0xffffffffu, v, off);
    if (lane >= off) v += u;
  }
  if (lane == 31) wsum[warp] = v;
  __syncthreads();
  double total = 0.0;
#pragma unroll
  for (int w = 0; w < 4; ++w) {
    if (w < warp) v += wsum[w];
    total += wsum[w];
  }
  const float e_i = static_cast<float>(exp(v));
  p.ca[bch * Q + tid] = v;
  p.ew[bch * 2 * Q + tid] = e_i;
  p.ew[bch * 2 * Q + Q + tid] = static_cast<float>(exp(total - v));
  if (tid == 0) p.dA[bch] = static_cast<float>(exp(total));
  es[tid] = e_i;
  hopper::cp_async_wait<0>();
  hopper::fence_proxy_async();
  __syncthreads();

  // A = (e o dy)^T: rows p (ra, ra + 8), columns i = 16 kk + {c2, c2 + 1,
  // c2 + 8, c2 + 9}
  uint32_t pa[8][4];
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int i = 16 * kk + 8 * hh + c2;
      const float e0 = es[i], e1 = es[i + 1];
      pa[kk][2 * hh] = hopper::pack_bf16(tile_at<Q>(dy_tile, i, ra) * e0,
                                         tile_at<Q>(dy_tile, i + 1, ra) * e1);
      pa[kk][2 * hh + 1] =
          hopper::pack_bf16(tile_at<Q>(dy_tile, i, ra + 8) * e0,
                            tile_at<Q>(dy_tile, i + 1, ra + 8) * e1);
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
          hopper::make_desc(s_c + np * CHUNK_PANEL + kk * 16 * ROW,
                            CHUNK_PANEL, 1024));
  hopper::wgmma_commit();
  hopper::wgmma_wait0();
#pragma unroll
  for (int np = 0; np < NP; ++np) hopper::fence_regs(acc[np]);
  float* dso = p.dsc + bch * p.P * p.N;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int pr = ra + 8 * half;
    if (pr >= p.P) continue;
#pragma unroll
    for (int np = 0; np < NP; ++np)
#pragma unroll
      for (int n8 = 0; n8 < 8; ++n8) {
        const int n = 64 * np + 8 * n8 + c2;
        if (n < p.N)
          *reinterpret_cast<float2*>(dso + static_cast<int64_t>(pr) * p.N +
                                     n) =
              make_float2(acc[np][4 * n8 + 2 * half],
                          acc[np][4 * n8 + 2 * half + 1]);
      }
  }
}

// ---------------------------------------------------------------------------
// 2. the reverse pass: dS at each chunk's end, in bf16

__global__ void __launch_bounds__(256) tcb_state_pass_kernel(const Params p) {
  const int64_t pn4 = static_cast<int64_t>(p.P) * p.N / 4;
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (idx >= static_cast<int64_t>(p.Bsz) * p.H * pn4) return;
  const int64_t bh = idx / pn4;
  const int64_t e = (idx - bh * pn4) * 4;
  const int b = static_cast<int>(bh / p.H);
  const int h = static_cast<int>(bh - static_cast<int64_t>(b) * p.H);
  const int64_t pn = pn4 * 4;
  float4 D = p.dsf ? *reinterpret_cast<const float4*>(p.dsf + bh * pn + e)
                   : make_float4(0.f, 0.f, 0.f, 0.f);
  for (int c = p.nc - 1; c >= 0; --c) {
    const int64_t bch = (static_cast<int64_t>(b) * p.nc + c) * p.H + h;
    const float4 cur = *reinterpret_cast<const float4*>(p.dsc + bch * pn + e);
    const float d = p.dA[bch];
    uint2 v;
    v.x = hopper::pack_bf16(D.x, D.y);
    v.y = hopper::pack_bf16(D.z, D.w);
    *reinterpret_cast<uint2*>(p.dsb + bch * pn + e) = v;
    D.x = fmaf(d, D.x, cur.x);
    D.y = fmaf(d, D.y, cur.y);
    D.z = fmaf(d, D.z, cur.z);
    D.w = fmaf(d, D.w, cur.w);
  }
}

// ---------------------------------------------------------------------------
// 3. per head: dx, (dy x^T) o D, da

__host__ __device__ constexpr int head_smem_bytes(int NP) {
  // B and C tiles (NP panels each), x and dy tiles, dS and S_prev tiles
  // (NP panels of PT rows each); the Q x Q float tile; ca [Q] double; e,
  // w, u, v, U, V [Q] and a reduction row [256] in float
  return 2 * NP * CHUNK_PANEL + 2 * CHUNK_PANEL + 2 * NP * PT_PANEL +
         Q * LDQ * 4 + Q * 8 + (6 * Q + 256) * 4 + 1024;
}

template <int NP, bool VEC>
__global__ void __launch_bounds__(256, 1) tcb_head_kernel(const Params p) {
  extern __shared__ uint8_t smem_raw[];
  uint32_t base = hopper::smem_addr(smem_raw);
  const uint32_t pad = (1024u - (base & 1023u)) & 1023u;
  base += pad;
  uint8_t* gen = smem_raw + pad;   // generic pointer to `base`
  const uint32_t s_b = base;
  const uint32_t s_c = s_b + NP * CHUNK_PANEL;
  const uint32_t s_x = s_c + NP * CHUNK_PANEL;
  const uint32_t s_dy = s_x + CHUNK_PANEL;
  const uint32_t s_ds = s_dy + CHUNK_PANEL;
  const uint32_t s_sp = s_ds + NP * PT_PANEL;
  const uint32_t s_g = s_sp + NP * PT_PANEL;
  const uint8_t* x_tile = gen + (s_x - base);
  const uint8_t* dy_tile = gen + (s_dy - base);
  const uint8_t* ds_tile = gen + (s_ds - base);
  const uint8_t* sp_tile = gen + (s_sp - base);
  float* sG = reinterpret_cast<float*>(gen + (s_g - base));   // [Q][LDQ]
  double* cad = reinterpret_cast<double*>(sG + Q * LDQ);
  float* es = reinterpret_cast<float*>(cad + Q);
  float* wsv = es + Q;
  float* us = wsv + Q;
  float* vs = us + Q;
  float* Us = vs + Q;
  float* Vs = Us + Q;
  float* red = Vs + Q;               // [256]

  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int wtid = tid & 127;
  const int warp = wtid >> 5;
  const int lane = tid & 31;
  const int ra = warp * 16 + (lane >> 2);
  const int c2 = 2 * (lane & 3);
  const int c = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int g = h / (p.H / p.G);
  const int t0 = c * Q;
  const int rows = min(Q, p.L - t0);
  const int64_t tok0 = static_cast<int64_t>(b) * p.L + t0;
  const int64_t bch = (static_cast<int64_t>(b) * p.nc + c) * p.H + h;
  const int64_t xs = static_cast<int64_t>(p.H) * p.P;
  const int64_t bcs = static_cast<int64_t>(p.G) * p.N;
  const bool has_prev = c > 0;

  {
    const int64_t boff = tok0 * bcs + static_cast<int64_t>(g) * p.N;
    load_tile<VEC, Q, NP, 256>(s_b, p.B + boff, bcs, rows, p.N, tid);
    load_tile<VEC, Q, NP, 256>(s_c, p.C + boff, bcs, rows, p.N, tid);
    const int64_t xoff = tok0 * xs + static_cast<int64_t>(h) * p.P;
    load_tile<VEC, Q, 1, 256>(s_x, p.x + xoff, xs, rows, p.P, tid);
    load_tile<VEC, Q, 1, 256>(s_dy, p.dy + xoff, xs, rows, p.P, tid);
    load_tile<VEC, PT, NP, 256>(s_ds, p.dsb + bch * p.P * p.N, p.N, p.P, p.N,
                                tid);
    load_tile<VEC, PT, NP, 256>(s_sp, p.sp + bch * p.P * p.N, p.N,
                                has_prev ? p.P : 0, p.N, tid);
    hopper::cp_async_commit();
  }
  if (tid < Q) {
    cad[tid] = p.ca[bch * Q + tid];
    es[tid] = p.ew[bch * 2 * Q + tid];
    wsv[tid] = p.ew[bch * 2 * Q + Q + tid];
  }
  hopper::cp_async_wait<0>();
  hopper::fence_proxy_async();
  __syncthreads();

  // <dS, S_prev> over the bf16 tiles
  {
    float z = 0.f;
    if (has_prev)
      for (int idx = tid; idx < PT * 64 * NP; idx += 256) {
        const int r = idx / (64 * NP);
        const int n = idx - r * 64 * NP;
        z = fmaf(tile_at<PT>(ds_tile, r, n), tile_at<PT>(sp_tile, r, n), z);
      }
    red[tid] = z;
  }

  const int ja = 64 * wg + ra;   // this thread's rows j (and i in 1.)
  const int jb = ja + 8;
  // the k-steps of 16 over N of an [rows x N] by [64 x N]^T product
  constexpr int NKS = 4 * NP;
  auto ss_n = [&](float(&acc)[32], uint32_t sa, uint32_t sbm) {
    hopper::fence_regs(acc);
    hopper::wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < NKS; ++ks)
      hopper::wgmma_ss_m64n64k16(
          acc,
          hopper::make_desc(sa + (ks >> 2) * CHUNK_PANEL + wg * 64 * ROW +
                                (ks & 3) * 32,
                            16, 1024),
          hopper::make_desc(sbm + (ks >> 2) * PT_PANEL + (ks & 3) * 32, 16,
                            1024),
          1);
    hopper::wgmma_commit();
    hopper::wgmma_wait0();
    hopper::fence_regs(acc);
  };

  // ---- 1. C S_prev^T and B dS^T ([Q][P] each, rows i and j, K = N) into
  //      the Q x Q tile's room, rotated a column a row; dx starts as
  //      w o (B dS^T)
  float* s_cs = sG;                  // [Q][64]
  float* s_bds = sG + Q * 64;        // [Q][64]
  auto put = [&](float* dst, const float(&acc)[32]) {
#pragma unroll
    for (int n8 = 0; n8 < 8; ++n8)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e < 2 ? ja : jb;
        dst[r * 64 + ((8 * n8 + c2 + (e & 1) + r) & 63)] = acc[4 * n8 + e];
      }
  };
  {
    float acc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = 0.f;
    if (has_prev) ss_n(acc, s_c, s_sp);
    put(s_cs, acc);
  }
  float dxa[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) dxa[i] = 0.f;
  ss_n(dxa, s_b, s_ds);
  put(s_bds, dxa);
  {
    const float wa = wsv[ja], wb = wsv[jb];
#pragma unroll
    for (int n8 = 0; n8 < 8; ++n8) {
      dxa[4 * n8] *= wa;
      dxa[4 * n8 + 1] *= wa;
      dxa[4 * n8 + 2] *= wb;
      dxa[4 * n8 + 3] *= wb;
    }
  }
  __syncthreads();
  // ---- 2. u_i = e_i dy_i . (C S_prev^T)_i (thread i), v_j = w_j x_j .
  //      (B dS^T)_j (thread Q + j)
  {
    const int r = tid & (Q - 1);
    const float* src = tid < Q ? s_cs : s_bds;
    const uint8_t* tile = tid < Q ? dy_tile : x_tile;
    float acc = 0.f;
    for (int q = 0; q < 64; ++q)
      acc = fmaf(tile_at<Q>(tile, r, q), src[r * 64 + ((q + r) & 63)], acc);
    if (tid < Q)
      us[r] = es[r] * acc;
    else
      vs[r] = wsv[r] * acc;
  }
  __syncthreads();   // the Q x Q tile's room is free again

  // ---- 3. B C^T: rows j, columns i in 64-column tiles t (t = 1 only for
  //      rows 64..127: the rest is below i >= j)
  float cbt[2][32];
#pragma unroll
  for (int t = 0; t < 2; ++t)
#pragma unroll
    for (int i = 0; i < 32; ++i) cbt[t][i] = 0.f;
#pragma unroll
  for (int t = 0; t < 2; ++t) {
    if (t < wg) continue;
    hopper::fence_regs(cbt[t]);
    hopper::wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < NKS; ++ks)
      hopper::wgmma_ss_m64n64k16(
          cbt[t],
          hopper::make_desc(s_b + (ks >> 2) * CHUNK_PANEL + wg * 64 * ROW +
                                (ks & 3) * 32,
                            16, 1024),
          hopper::make_desc(s_c + (ks >> 2) * CHUNK_PANEL + t * 64 * ROW +
                                (ks & 3) * 32,
                            16, 1024),
          1);
    hopper::wgmma_commit();
    hopper::wgmma_wait0();
    hopper::fence_regs(cbt[t]);
  }
  const double ca_ja = cad[ja], ca_jb = cad[jb];
  // D_ij for this thread's element e of column group n8 of tile t
  auto decay = [&](int t, int n8, int e) {
    const int i = 64 * t + 8 * n8 + c2 + (e & 1);
    const int j = e < 2 ? ja : jb;
    return i >= j ? expf(static_cast<float>(cad[i] - (e < 2 ? ca_ja : ca_jb)))
                  : 0.f;
  };

  // ---- 4. dx += M^T dy, M^T in bf16 from registers (k-steps over i: all 8
  //      for rows 0..63, the last 4 for rows 64..127)
  auto mty = [&](auto k0) {
    constexpr int K0 = decltype(k0)::value;
    uint32_t pa[8 - K0][4];
#pragma unroll
    for (int kk = K0; kk < 8; ++kk) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int t = kk >> 2;
        const int n8 = (2 * kk + hh) & 7;
        float m[4];
#pragma unroll
        for (int e = 0; e < 4; ++e)
          m[e] = cbt[t][4 * n8 + e] * decay(t, n8, e);
        pa[kk - K0][2 * hh] = hopper::pack_bf16(m[0], m[1]);
        pa[kk - K0][2 * hh + 1] = hopper::pack_bf16(m[2], m[3]);
      }
    }
    hopper::fence_regs(dxa);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = K0; kk < 8; ++kk)
      hopper::wgmma_rs<64>(
          dxa, pa[kk - K0],
          hopper::make_desc(s_dy + kk * 16 * ROW, CHUNK_PANEL, 1024));
    hopper::wgmma_commit();
    hopper::wgmma_wait0();
    hopper::fence_regs(dxa);
  };
  if (wg == 0)
    mty(Int<0>{});
  else
    mty(Int<4>{});
  {
    bf* dxp = p.dx + tok0 * xs + static_cast<int64_t>(h) * p.P;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int j = half ? jb : ja;
      if (j >= rows) continue;
#pragma unroll
      for (int n8 = 0; n8 < 8; ++n8) {
        const int pc = 8 * n8 + c2;
        if (pc < p.P)
          dxp[j * xs + pc] = __float2bfloat16(dxa[4 * n8 + 2 * half]);
        if (pc + 1 < p.P)
          dxp[j * xs + pc + 1] = __float2bfloat16(dxa[4 * n8 + 2 * half + 1]);
      }
    }
  }

  // ---- 5. x dy^T: rows j, columns i; G = (dy x^T) o M into shared memory
  //      (as [i][j]), (dy x^T) o D to the workspace (as [j][i])
  {
    float* dco = p.dcbh + bch * Q * Q;
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      if (t < wg) {
        // columns i < 64 <= j: zero
#pragma unroll
        for (int half = 0; half < 2; ++half)
#pragma unroll
          for (int n8 = 0; n8 < 8; ++n8)
            *reinterpret_cast<float2*>(
                dco + (half ? jb : ja) * Q + 64 * t + 8 * n8 + c2) =
                make_float2(0.f, 0.f);
        continue;
      }
      float acc[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[i] = 0.f;
      hopper::fence_regs(acc);
      hopper::wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < 4; ++ks)
        hopper::wgmma_ss_m64n64k16(
            acc,
            hopper::make_desc(s_x + wg * 64 * ROW + ks * 32, 16, 1024),
            hopper::make_desc(s_dy + t * 64 * ROW + ks * 32, 16, 1024), 1);
      hopper::wgmma_commit();
      hopper::wgmma_wait0();
      hopper::fence_regs(acc);
#pragma unroll
      for (int n8 = 0; n8 < 8; ++n8) {
        float gv[4], dv[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float d = decay(t, n8, e);
          gv[e] = acc[4 * n8 + e] * (cbt[t][4 * n8 + e] * d);
          dv[e] = acc[4 * n8 + e] * d;
        }
        const int i = 64 * t + 8 * n8 + c2;
        sG[i * LDQ + ja] = gv[0];
        sG[(i + 1) * LDQ + ja] = gv[1];
        sG[i * LDQ + jb] = gv[2];
        sG[(i + 1) * LDQ + jb] = gv[3];
        *reinterpret_cast<float2*>(dco + ja * Q + i) =
            make_float2(dv[0], dv[1]);
        *reinterpret_cast<float2*>(dco + jb * Q + i) =
            make_float2(dv[2], dv[3]);
      }
    }
  }
  __syncthreads();

  // ---- 6. d log a: row i's exclusive prefix sums of G (thread i), then
  //      R_t = sum_{i >= t} of column t (thread t); the suffix sums of u
  //      and prefix sums of v; z = exp(ca_last) <dS, S_prev>
  if (tid < Q) {
    float s = 0.f;
    for (int t = 0; t <= tid; ++t) {
      const float gv = sG[tid * LDQ + t];
      sG[tid * LDQ + t] = s;
      s += gv;
    }
  } else if (tid == Q) {
    float s = 0.f;
    for (int t = Q - 1; t >= 0; --t) {
      s += us[t];
      Us[t] = s;
    }
  } else if (tid == Q + 1) {
    float s = 0.f;
    for (int t = 0; t < Q; ++t) {
      Vs[t] = s;
      s += vs[t];
    }
  } else if (tid == Q + 2) {
    float s = 0.f;
    for (int k = 0; k < 256; ++k) s += red[k];
    red[0] = s;
  }
  __syncthreads();
  if (tid < rows) {
    float R = 0.f;
    for (int i = tid; i < Q; ++i) R += sG[i * LDQ + tid];
    const float z = p.dA[bch] * red[0];
    const float dla = ((R + Us[tid]) + Vs[tid]) + z;
    const float av = p.a[(tok0 + tid) * p.H + h];
    p.da[(tok0 + tid) * p.H + h] = av >= 1e-37f ? dla / av : 0.f;
  }
}

// ---------------------------------------------------------------------------
// 4. the group sums of (dy x^T) o D, heads in ascending order

__global__ void __launch_bounds__(256) tcb_dcb_sum_kernel(const Params p) {
  const int64_t per = Q * Q / 4;
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  const int64_t n = static_cast<int64_t>(p.Bsz) * p.nc * p.G * per;
  if (idx >= n) return;
  const int64_t bcg = idx / per;
  const int64_t e = (idx - bcg * per) * 4;
  const int64_t bc = bcg / p.G;
  const int g = static_cast<int>(bcg - bc * p.G);
  const int hpg = p.H / p.G;
  float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int k = 0; k < hpg; ++k) {
    const float4 v = *reinterpret_cast<const float4*>(
        p.dcbh + (bc * p.H + g * hpg + k) * Q * Q + e);
    s.x += v.x;
    s.y += v.y;
    s.z += v.z;
    s.w += v.w;
  }
  *reinterpret_cast<float4*>(p.dcb + bcg * Q * Q + e) = s;
}

// ---------------------------------------------------------------------------
// 5. dC or dB: a 64-row, 64-column tile a CTA

__host__ __device__ constexpr int group_smem_bytes() {
  // the B or C tile's 64 columns (one panel of Q rows), a ring of head
  // tiles (one panel of PT rows each)
  return CHUNK_PANEL + GSTAGES * PT_PANEL + 1024;
}

template <bool VEC>
__global__ void __launch_bounds__(128) tcb_group_kernel(const Params p) {
  extern __shared__ uint8_t smem_raw[];
  uint32_t base = hopper::smem_addr(smem_raw);
  const uint32_t pad = (1024u - (base & 1023u)) & 1023u;
  base += pad;
  const uint32_t s_op = base;
  auto s_ring = [&](int k) {
    return s_op + CHUNK_PANEL + (k % GSTAGES) * PT_PANEL;
  };

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int ra = warp * 16 + (lane >> 2);
  const int c2 = 2 * (lane & 3);
  const int c = blockIdx.x;
  const int b = blockIdx.z;
  const int n_nt = (p.N + 63) / 64;
  int y = blockIdx.y;
  const int which = y & 1;             // 0: dC, 1: dB
  y >>= 1;
  const int nt = y % n_nt;
  y /= n_nt;
  const int rt = y & 1;
  const int g = y >> 1;
  const int r0 = 64 * rt;
  const int n0 = 64 * nt;
  const int ncols = min(64, p.N - n0);
  const int t0 = c * Q;
  const int rows = min(Q, p.L - t0);
  const int64_t tok0 = static_cast<int64_t>(b) * p.L + t0;
  const int64_t bc = static_cast<int64_t>(b) * p.nc + c;
  const int64_t bcs = static_cast<int64_t>(p.G) * p.N;
  const int64_t xs = static_cast<int64_t>(p.H) * p.P;
  const int hpg = p.H / p.G;
  const bool heads = which == 1 || c > 0;   // chunk 0: S_prev = 0
  const bf* ring_src = which ? p.dsb : p.sp;

  auto stage = [&](int k) {
    if (heads && k < hpg) {
      const int64_t bch = bc * p.H + g * hpg + k;
      load_tile<VEC, PT, 1, 128>(s_ring(k), ring_src + bch * p.P * p.N + n0,
                                 p.N, p.P, ncols, tid);
    }
    hopper::cp_async_commit();
  };
  // dC: the B tile (rows j); dB: the C tile (rows i); columns n0..n0+63
  load_tile<VEC, Q, 1, 128>(
      s_op, (which ? p.C : p.B) + tok0 * bcs + static_cast<int64_t>(g) * p.N +
                n0,
      bcs, rows, ncols, tid);
  hopper::cp_async_commit();
#pragma unroll
  for (int k = 0; k < GSTAGES - 1; ++k) stage(k);

  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
  const int ia = r0 + ra;
  const int ib = ia + 8;

  // ---- the group sum of (dy x^T) o D, stored [j][i]: dC's A is its
  //      transpose (rows i, k over j <= i), dB's A as stored (rows j, k over
  //      i >= j); bf16 from float32 global loads
  {
    const float* dT = p.dcb + (bc * p.G + g) * Q * Q;
    uint32_t pa[8][4];
    const int k_lo = which ? 4 * rt : 0;
    const int k_hi = which ? 8 : 4 * (rt + 1);
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      if (kk < k_lo || kk >= k_hi) continue;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int k = 16 * kk + 8 * hh + c2;
        float m[4];
        if (which) {
          m[0] = dT[ia * Q + k];
          m[1] = dT[ia * Q + k + 1];
          m[2] = dT[ib * Q + k];
          m[3] = dT[ib * Q + k + 1];
        } else {
          m[0] = dT[k * Q + ia];
          m[1] = dT[(k + 1) * Q + ia];
          m[2] = dT[k * Q + ib];
          m[3] = dT[(k + 1) * Q + ib];
        }
        pa[kk][2 * hh] = hopper::pack_bf16(m[0], m[1]);
        pa[kk][2 * hh + 1] = hopper::pack_bf16(m[2], m[3]);
      }
    }
    hopper::cp_async_wait<GSTAGES - 1>();   // the operand tile is in
    hopper::fence_proxy_async();
    __syncthreads();
    hopper::fence_regs(acc);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      if (kk < k_lo || kk >= k_hi) continue;
      hopper::wgmma_rs<64>(
          acc, pa[kk],
          hopper::make_desc(s_op + kk * 16 * ROW, CHUNK_PANEL, 1024));
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait0();
    hopper::fence_regs(acc);
  }

  // ---- + sum_h (e o dy) S_prev (dC) or (w o x) dS (dB), heads ascending
  if (heads) {
    const bf* src = which ? p.x : p.dy;
    for (int k = 0; k < hpg; ++k) {
      const int h = g * hpg + k;
      const int64_t bch = bc * p.H + h;
      const float* sc = p.ew + bch * 2 * Q + (which ? Q : 0);
      const float sa = ia < rows ? sc[ia] : 0.f;
      const float sb = ib < rows ? sc[ib] : 0.f;
      const bf* ra_p = src + (tok0 + ia) * xs + static_cast<int64_t>(h) * p.P;
      const bf* rb_p = src + (tok0 + ib) * xs + static_cast<int64_t>(h) * p.P;
      uint32_t pa[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int q = 16 * kk + 8 * hh + c2;
          const bool q0 = q < p.P, q1 = q + 1 < p.P;
          pa[kk][2 * hh] = hopper::pack_bf16(
              sa * ld_bf(ra_p + q, ia < rows && q0),
              sa * ld_bf(ra_p + q + 1, ia < rows && q1));
          pa[kk][2 * hh + 1] = hopper::pack_bf16(
              sb * ld_bf(rb_p + q, ib < rows && q0),
              sb * ld_bf(rb_p + q + 1, ib < rows && q1));
        }
      }
      stage(k + GSTAGES - 1);
      hopper::cp_async_wait<GSTAGES - 1>();
      hopper::fence_proxy_async();
      __syncthreads();
      hopper::fence_regs(acc);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        hopper::wgmma_rs<64>(
            acc, pa[kk],
            hopper::make_desc(s_ring(k) + kk * 16 * ROW, PT_PANEL, 1024));
      hopper::wgmma_commit();
      hopper::wgmma_wait0();
      hopper::fence_regs(acc);
      __syncthreads();   // slot k is read: free for k + GSTAGES
    }
  }

  bf* out = (which ? p.dB : p.dC) + tok0 * bcs + static_cast<int64_t>(g) * p.N;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = half ? ib : ia;
    if (r >= rows) continue;
#pragma unroll
    for (int n8 = 0; n8 < 8; ++n8) {
      const int n = n0 + 8 * n8 + c2;
      if (n < p.N) out[r * bcs + n] = __float2bfloat16(acc[4 * n8 + 2 * half]);
      if (n + 1 < p.N)
        out[r * bcs + n + 1] = __float2bfloat16(acc[4 * n8 + 2 * half + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// host side

size_t align256(size_t n) { return (n + 255) & ~static_cast<size_t>(255); }

// Offsets of the scratch arrays in the workspace; returns its size.
size_t carve(int Bsz, int L, int H, int P, int G, int N, size_t off[7]) {
  const size_t nc = (static_cast<size_t>(L) + Q - 1) / Q;
  const size_t bc = static_cast<size_t>(Bsz) * nc;
  const size_t sizes[7] = {bc * H * Q * 8,     bc * H * 2 * Q * 4,
                           bc * H * 4,         bc * H * P * N * 4,
                           bc * H * P * N * 2, bc * H * Q * Q * 4,
                           bc * G * Q * Q * 4};
  size_t at = 0;
  for (int i = 0; i < 7; ++i) {
    off[i] = at;
    at += align256(sizes[i]);
  }
  return at;
}

template <int NP, bool VEC>
int launch(const Params& p, cudaStream_t st) {
  auto k1 = tcb_chunk_kernel<NP, VEC>;
  auto k3 = tcb_head_kernel<NP, VEC>;
  auto k5 = tcb_group_kernel<VEC>;
  constexpr int b1 = chunk_smem_bytes(NP);
  constexpr int b3 = head_smem_bytes(NP);
  constexpr int b5 = group_smem_bytes();
  static const cudaError_t attr = [&] {
    cudaError_t e = cudaFuncSetAttribute(
        k1, cudaFuncAttributeMaxDynamicSharedMemorySize, b1);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(k3, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               b3);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(k5, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               b5);
    return e;
  }();
  if (attr != cudaSuccess) return static_cast<int>(attr);
  cudaError_t e;
  k1<<<dim3(p.nc, p.H, p.Bsz), 128, b1, st>>>(p);
  if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
  const int64_t n4 = static_cast<int64_t>(p.Bsz) * p.H * p.P * p.N / 4;
  tcb_state_pass_kernel<<<static_cast<unsigned>((n4 + 255) / 256), 256, 0,
                          st>>>(p);
  if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
  k3<<<dim3(p.nc, p.H, p.Bsz), 256, b3, st>>>(p);
  if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
  const int64_t m4 = static_cast<int64_t>(p.Bsz) * p.nc * p.G * Q * Q / 4;
  tcb_dcb_sum_kernel<<<static_cast<unsigned>((m4 + 255) / 256), 256, 0, st>>>(
      p);
  if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
  k5<<<dim3(p.nc, p.G * 2 * ((p.N + 63) / 64) * 2, p.Bsz), 128, b5, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Bytes of scratch ssd_scan_tc_bwd_launch needs.
extern "C" long long ssd_scan_tc_bwd_workspace_bytes(int Bsz, int L, int H,
                                                     int P, int G, int N) {
  size_t off[7];
  return static_cast<long long>(carve(Bsz, L, H, P, G, N, off));
}

// Plain C entry point (loaded with ctypes).  x, dy, dx [Bsz, L, H, P], B,
// C, dB, dC [Bsz, L, G, N], s_prev [Bsz, nc, H, P, N] bf16; a, da [Bsz, L,
// H] float32; d_state [Bsz, H, P, N] float32 or null; all contiguous;
// `work` 256-byte aligned, of ssd_scan_tc_bwd_workspace_bytes.  Launches
// five kernels on `stream`, does not synchronise, allocates nothing.
// Returns cudaGetLastError() of the launches (or of the shared-memory
// attribute), or cudaErrorInvalidValue for an unsupported shape (P > 64,
// N > 128, N % 4 != 0).
extern "C" int ssd_scan_tc_bwd_launch(const void* x, const void* a,
                                      const void* B, const void* C,
                                      const void* dy, const void* d_state,
                                      const void* s_prev, void* dx, void* da,
                                      void* dB, void* dC, void* work, int Bsz,
                                      int L, int H, int P, int G, int N,
                                      void* stream) {
  if (Bsz <= 0 || H <= 0 || P <= 0 || L <= 0) return 0;
  if (G <= 0 || H % G != 0 || N <= 0 || N > 128 || N % 4 != 0 || P > PT)
    return static_cast<int>(cudaErrorInvalidValue);
  if (reinterpret_cast<uintptr_t>(work) % 256 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  size_t off[7];
  carve(Bsz, L, H, P, G, N, off);
  uint8_t* w = static_cast<uint8_t*>(work);
  Params p;
  p.x = static_cast<const bf*>(x);
  p.a = static_cast<const float*>(a);
  p.B = static_cast<const bf*>(B);
  p.C = static_cast<const bf*>(C);
  p.dy = static_cast<const bf*>(dy);
  p.dsf = static_cast<const float*>(d_state);
  p.sp = static_cast<const bf*>(s_prev);
  p.dx = static_cast<bf*>(dx);
  p.da = static_cast<float*>(da);
  p.dB = static_cast<bf*>(dB);
  p.dC = static_cast<bf*>(dC);
  p.ca = reinterpret_cast<double*>(w + off[0]);
  p.ew = reinterpret_cast<float*>(w + off[1]);
  p.dA = reinterpret_cast<float*>(w + off[2]);
  p.dsc = reinterpret_cast<float*>(w + off[3]);
  p.dsb = reinterpret_cast<bf*>(w + off[4]);
  p.dcbh = reinterpret_cast<float*>(w + off[5]);
  p.dcb = reinterpret_cast<float*>(w + off[6]);
  p.Bsz = Bsz;
  p.L = L;
  p.H = H;
  p.P = P;
  p.G = G;
  p.N = N;
  p.nc = (L + Q - 1) / Q;
  bool vec = P % 8 == 0 && N % 8 == 0;
  for (const void* ptr : {x, B, C, dy, s_prev})
    vec = vec && reinterpret_cast<uintptr_t>(ptr) % 16 == 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (N <= 64)
    return vec ? launch<1, true>(p, st) : launch<1, false>(p, st);
  return vec ? launch<2, true>(p, st) : launch<2, false>(p, st);
}
