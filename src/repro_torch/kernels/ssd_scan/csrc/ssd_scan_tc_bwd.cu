// Gradient of the Mamba2 SSD chunked scan on Hopper's tensor cores
// (sm_90a), for bf16 x, B and C: the training path of mamba2-780m.
//
// The reference has no Pallas backward: its training step differentiates
// the sequential oracle src/repro/kernels/ssd_scan/ref.py:21-42 with XLA's
// autodiff.  This is the gradient of ssd_scan_tc.cu's chunked forward (the
// SSD paper's decomposition, arXiv:2405.21060, section 6), laid out like
// it: chunks of Q = 128 in parallel, a short reverse pass over the chunks,
// then per chunk the products on the tensor cores (bf16 wgmma, float32
// sums).  It reads the bf16 state entering each chunk, S_prev, that the
// forward wrote for it.  With ca the prefix sum of log(max(a, 1e-37)) in
// double over a chunk, e_i = exp(ca_i), w_j = exp(ca_last - ca_j), D_ij =
// exp(ca_i - ca_j) for j <= i (never evaluated above the diagonal), M =
// (C B^T) o D and dS the gradient at a chunk's end, four launches on one
// stream:
//
//   1. tcb_chunk_kernel, grid (chunks, H, Bsz), one warpgroup: ca (kept in
//      log2 units), e, w, exp(ca_last), the decay factored about the
//      middle of the chunk's range where every ca is within 2^60 of it
//      (2^(ca - mid) and 2^(mid - ca), as the forward), and the chunk-local
//      state gradient (e o dy)^T C [P, N], A = (e o dy)^T built in
//      registers, B the C tile.
//   2. tcb_state_pass_kernel: the chunks in reverse, dS[c] =
//      exp(ca_last[c + 1]) dS[c + 1] + (local gradient)[c + 1] carried in
//      float32, seeded by dS_fin, each dS written in bf16.
//   3. tcb_head_slice_kernel, grid (chunks, G x slices, Bsz), two
//      warpgroups: a CTA takes a run of consecutive heads of one group
//      (slice s of `slices`, ops.backward_slices: the fewest that fill the
//      card, by waves times heads a CTA), in ascending order.  The B and C
//      tiles arrive once by TMA and stay; B C^T is recomputed each head on
//      the tensor cores (kept across heads it held 48 more registers a
//      thread, and ptxas spilled).  Each head's x, dy, dS and S_prev tiles
//      (and its ca and `ew` rows, by bulk copy) arrive by TMA into a ring of
//      two stages: one thread issues head k + 2's loads as soon as head k's
//      last reads are done, while the warpgroups compute head k + 1.  Per
//      head: C S_prev^T, then x dy^T and B C^T, as two wgmma groups; u_i =
//      e_i dy_i . (C S_prev^T)_i; in one pass D (the factored pair's
//      product, or one 2^x an entry), G = (dy x^T) o M, the slice's sum of
//      (dy x^T) o D in registers and M^T in bf16 registers; B dS^T while
//      d log a's sums of G are taken; v_j = w_j x_j . (B dS^T)_j and dx =
//      w o (B dS^T) + M^T dy, stored as 16-byte pieces of rows after a
//      transpose within each quad of lanes.  The triangle below the
//      diagonal is shared evenly: warpgroup w owns the diagonal 64 x 64
//      tile of rows and columns 64w.. and the 32-column half 64 + 32w.. of
//      the tile above it (rows j < 64, columns i >= 64), so both do 40
//      m64n64k16 steps a head; the second warpgroup's share of dx's first
//      rows passes through shared memory.  d log a is summed directly (no
//      pair of terms cancels, so it keeps its relative accuracy where a is
//      small): on each diagonal tile, row suffix sums of G over i (quad
//      shuffles, then the 8-column groups right to left) summed down each
//      column over rows j < t; of the half above the diagonal, whose rows
//      all lie below and columns above any t it reaches, only its row
//      totals (a prefix over j < t for t < 64) and column totals (a suffix
//      over i >= t for t >= 64); u and v by warp scans.  The second
//      warpgroup finishes each head's d log a in the next head's wgmma
//      shadow.  At the end the CTA writes its float32 partial sum_h
//      (dy x^T) o D once, [Q, Q] as [j][i].
//   4. tcb_group_kernel, grid (chunks, G x ceil(N / 64) x 2, Bsz), a
//      Q x 64 tile of dC or of dB a CTA, one warpgroup each 64 rows: the
//      slices' partials summed in slice order and rounded to bf16 as its A
//      operand, times B (or its transpose times C), then over the group's
//      heads in ascending order (e o dy) S_prev (or (w o x) dS).  The dy
//      or x tile and the S_prev or dS tile of each head arrive by TMA in a
//      ring of four stages (the second shared by both warpgroups); each
//      warpgroup rounds its 64 rows of the first, times e or w, to bf16 in
//      place, fences them for the tensor cores and multiplies them by the
//      second from shared memory, one wgmma group in flight behind the
//      next head's.
//
// Shared memory written by the generic proxy and read by a wgmma is
// fenced (fence.proxy.async) and passed through a barrier first; a ring
// slot is refilled only after every wgmma that read it has waited, and
// every thread waits on a slot's mbarrier before reading it.

// Numerics: x, dy, B, C and S_prev are bf16 inputs, which the tensor cores
// take exactly; the operands computed for them are rounded to bf16 once:
// e o dy, dS, M^T, the group sum of (dy x^T) o D (float32 within each
// slice, heads ascending, then the slices in order) and w o x.  Every
// product accumulates in float32; the reverse pass carries float32; d log
// a's terms take M in float32.  ref.ssd_scan_chunked_backward(...,
// tensor_core=True, slices=) mirrors these steps on the CPU.  No atomics:
// two calls give the same bits.
//
// Shared memory of the head-slice kernel at N = 128 (two 64-column
// panels): B and C 64 KB; two stages of x, dy (16 KB each), dS, S_prev
// (16 KB each), ca (1 KB) and the `ew` row (2 KB): 134 KB; dx's exchange
// tile 18 KB; column partials 4 KB; u (two heads'), v, the totals above
// the diagonal and z partials 3.1 KB: 223.1 KB of the 227.  The ring has
// no room for a third stage.
//
// Limits: P <= 64 (one 64-column panel), N <= 128, P and N multiples of 8
// and 16-byte aligned operands (TMA's rows; ops.py pads the odd shapes);
// other shapes and float32 operands take ssd_scan_bwd.cu.  Bound at
// mamba2-780m's training shape [1, 4096, 48, 64], G 1, N 128: about 108 MB
// of inputs and outputs (0.032 ms at 3.35 TB/s) against 23 GFLOP of
// products (0.023 ms at the bf16 peak): bytes.  Measured: PERF.md.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <initializer_list>

#include "hopper_ptx.cuh"
#include "tma_map.cuh"

namespace {

typedef __nv_bfloat16 bf;
constexpr int Q = 128;              // tokens a chunk (the forward's)
constexpr int PT = 64;              // state rows p a tile
constexpr int ROW = 128;            // bytes a swizzled panel row
constexpr int CHUNK_PANEL = Q * ROW;   // one 64-column panel of Q rows
constexpr int PT_PANEL = PT * ROW;     // one 64-column panel of PT rows
constexpr int BOX = 64 * ROW;          // one TMA box: 64 rows of 64 values
constexpr int LDX = 72;             // row stride of dx's exchange tile
constexpr int GSTAGES = 4;          // head tiles in flight (group kernel)
// floats of a head's row in `ew`: e [Q], w [Q], then (where the chunk's
// decay spans little enough) the factored decay 2^(ca - mid) [Q] and
// 2^(mid - ca) [Q], then exp(ca_last), the factored flag and two pads
constexpr int EW = 4 * Q + 4;
// bytes of a stage's small rows (ca [Q] double, the head's `ew` row)
constexpr int SMALL = Q * 8 + EW * 4;
constexpr double LOG2E = 1.4426950408889634;
constexpr unsigned FULL = 0xffffffffu;

struct Params {
  const float* a;       // [Bsz, L, H]
  const bf* C;          // [Bsz, L, G, N]
  const bf* dy;         // [Bsz, L, H, P]
  const float* dsf;     // [Bsz, H, P, N] or null
  bf* dx;               // [Bsz, L, H, P]
  float* da;            // [Bsz, L, H]
  bf* dB;               // [Bsz, L, G, N]
  bf* dC;               // [Bsz, L, G, N]
  double* ca;           // [Bsz, nc, H, Q] in log2 units
  float* ew;            // [Bsz, nc, H, EW]
  float* dsc;           // [Bsz, nc, H, P, N] chunk-local state gradients
  bf* dsb;              // [Bsz, nc, H, P, N] dS at each chunk's end
  float* dcbh;          // [Bsz, nc, G, slices, Q, Q] slice partials [j][i]
  int Bsz, L, H, P, G, N, nc, slices;
};

// TMA maps: x, dy [Bsz, L, H, P]; B, C [Bsz, L, G, N]; dS and S_prev
// [Bsz nc H, P, 1, N]; boxes of 64 rows x 64 columns
struct Maps {
  CUtensorMap x, dy, b, c, ds, sp;
};

// Byte offset of 16-byte chunk c of row r in panels of R rows.
__device__ __forceinline__ uint32_t swz(int R, int r, int c) {
  return (c >> 3) * R * ROW + r * ROW + (((c & 7) ^ (r & 7)) << 4);
}

// A [R x 64 NPAN] bf16 tile into NPAN swizzled panels at `dst` by 16-byte
// asynchronous copies: row r from src + r * stride, rows < rows and
// columns < cols valid, zeros elsewhere; NT threads share the copy; the
// caller commits and waits.
template <int R, int NPAN, int NT>
__device__ __forceinline__ void load_tile(uint32_t dst, const bf* src,
                                          int64_t stride, int rows, int cols,
                                          int tid) {
  constexpr int CPR = NPAN * 8;   // 16-byte chunks a row
#pragma unroll
  for (int idx = tid; idx < R * CPR; idx += NT) {
    const int r = idx / CPR;
    const int c = idx - r * CPR;
    const bool valid = r < rows && 8 * c < cols;
    hopper::cp_async_16(dst + swz(R, r, c),
                        valid ? src + r * stride + 8 * c : src, valid);
  }
}

// element (r, c) of a swizzled tile of R-row panels at `tile`, as float
template <int R>
__device__ __forceinline__ float tile_at(const uint8_t* tile, int r, int c) {
  return __bfloat162float(*reinterpret_cast<const bf*>(
      tile + (c >> 6) * R * ROW + r * ROW +
      ((((c & 63) >> 3) ^ (r & 7)) << 4) + (c & 7) * 2));
}

// elements (r, c) and (r, c + 1) (c even) of a one-panel swizzled tile
__device__ __forceinline__ float2 pair_at(const uint8_t* tile, int r, int c) {
  return hopper::unpack_bf16(*reinterpret_cast<const uint32_t*>(
      tile + r * ROW + (((c >> 3) ^ (r & 7)) << 4) + (c & 7) * 2));
}

// d[64 x 32] (+)= A[64 x 16] B[16 x 32]: both operands K-major in shared
// memory.
__device__ __forceinline__ void wgmma_ss_m64n32k16(float (&d)[16],
                                                   uint64_t da, uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "l"(da), "l"(db), "r"(1));
}

// Named barrier 1 of 256 threads: one warpgroup arrives (no wait), the
// other waits for it.
__device__ __forceinline__ void bar_arrive_1() {
  asm volatile("bar.arrive 1, 256;\n" ::: "memory");
}

// a[i] of lane q of each quad becomes a[q] of its lane i (two exchanges:
// the off-diagonal 2 x 2 blocks, then within them)
__device__ __forceinline__ void quad_transpose(uint32_t (&a)[4], int q) {
#pragma unroll
  for (int bit = 2; bit >= 1; bit >>= 1) {
    const bool up = q & bit;
    const int lo0 = 0, lo1 = bit == 2 ? 1 : 2;   // the pairs' low ends
    const int hi0 = lo0 + bit, hi1 = lo1 + bit;
    const uint32_t r0 =
        __shfl_xor_sync(FULL, up ? a[lo0] : a[hi0], bit);
    const uint32_t r1 =
        __shfl_xor_sync(FULL, up ? a[lo1] : a[hi1], bit);
    if (up) {
      a[lo0] = r0;
      a[lo1] = r1;
    } else {
      a[hi0] = r0;
      a[hi1] = r1;
    }
  }
}

// d[64 x 64] (+)= A[64 x 16] B[16 x 64]: A K-major, B MN-major (transposed),
// both in shared memory.
__device__ __forceinline__ void wgmma_ss_m64n64k16_tb(float (&d)[32],
                                                      uint64_t da,
                                                      uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, %32, %33, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

// Register A operands of an in-flight wgmma stay live and unmoved until
// the wait that retires it.
template <int K>
__device__ __forceinline__ void fence_frags(uint32_t (&a)[K][4]) {
#pragma unroll
  for (int k = 0; k < K; ++k)
#pragma unroll
    for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(a[k][i])::"memory");
}

template <bool V>
struct Bool {
  static constexpr bool value = V;
};

// ---------------------------------------------------------------------------
// 1. ca, e, w, exp(ca_last) and the chunk-local state gradient

__host__ __device__ constexpr int chunk_smem_bytes(int NP) {
  // C tile (NP panels), dy tile, e [Q] floats, warp sums and maxima
  return NP * CHUNK_PANEL + CHUNK_PANEL + Q * 4 + 8 * 8 + 1024;
}

template <int NP>
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

  load_tile<Q, NP, 128>(s_c, p.C + tok0 * p.G * p.N +
                                 static_cast<int64_t>(g) * p.N,
                        static_cast<int64_t>(p.G) * p.N, rows, p.N, tid);
  load_tile<Q, 1, 128>(s_dy, p.dy + tok0 * xs + static_cast<int64_t>(h) * p.P,
                       xs, rows, p.P, tid);
  hopper::cp_async_commit();
  // ca: inclusive prefix sum over the chunk, one token a thread
  double v = tid < rows ? log(static_cast<double>(fmaxf(
                              p.a[(tok0 + tid) * p.H + h], 1e-37f)))
                        : 0.0;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const double u = __shfl_up_sync(FULL, v, off);
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
  const double v2 = v * LOG2E;
  float* ewo = p.ew + bch * EW;
  p.ca[bch * Q + tid] = v2;
  ewo[tid] = e_i;
  ewo[Q + tid] = static_cast<float>(exp(total - v));
  if (tid == 0) {
    ewo[4 * Q] = static_cast<float>(exp(total));
    wsum[4] = v2;
  }
  es[tid] = e_i;
  hopper::cp_async_wait<0>();
  hopper::fence_proxy_async();
  __syncthreads();
  // the decay factored about the middle of the chunk's range (log2 units),
  // as the forward: where every ca is within 60 of it, exp(ca_i - ca_j) =
  // 2^(ca_i - mid) 2^(mid - ca_j), each factor within 2^+-60
  {
    const double mid = 0.5 * (wsum[4] + total * LOG2E);
    float dev = static_cast<float>(fabs(v2 - mid));
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      dev = fmaxf(dev, __shfl_xor_sync(FULL, dev, off));
    float* wmax = reinterpret_cast<float*>(wsum + 5);
    if (lane == 0) wmax[warp] = dev;
    ewo[2 * Q + tid] = exp2f(static_cast<float>(v2 - mid));
    ewo[3 * Q + tid] = exp2f(static_cast<float>(mid - v2));
    __syncthreads();
    if (tid == 0)
      ewo[4 * Q + 1] =
          fmaxf(fmaxf(wmax[0], wmax[1]), fmaxf(wmax[2], wmax[3])) <= 60.f
              ? 1.f
              : 0.f;
  }

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
  fence_frags(pa);
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
    const float d = p.ew[bch * EW + 4 * Q];
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
// 3. a slice of a group's heads: dx, da and the slice's (dy x^T) o D

// the panels of one stage of the ring: x and dy tiles, dS and S_prev
// tiles (NP panels of PT rows each); its small rows (SMALL) lie after both
// stages' panels
__host__ __device__ constexpr int stage_bytes(int NP) {
  return 2 * CHUNK_PANEL + 2 * NP * PT_PANEL;
}

__host__ __device__ constexpr int head_smem_bytes(int NP) {
  // B and C tiles, two stages, dx's exchange tile [64][LDX], column
  // partials [8][Q], u [2][Q] and v [Q], the row and column totals above
  // the diagonal [2][64] and [4][64], z partials [2][8], three mbarriers
  return 2 * NP * CHUNK_PANEL + 2 * (stage_bytes(NP) + SMALL) + 64 * LDX * 4 +
         8 * Q * 4 + 3 * Q * 4 + 6 * 64 * 4 + 16 * 4 + 3 * 8 + 1024;
}

// In-place suffix sums along the rows of a tile a warpgroup holds in the
// accumulator layout (NG groups of 8 columns): element (r, col) becomes
// the sum of the row's elements at columns >= col.  Pairs, then the quad
// (four lanes hold a row's 8-column group), then the groups right to left:
// only additions of the terms themselves.
template <int NG>
__device__ __forceinline__ void row_suffix(float (&g)[4 * NG], int q) {
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    float cur = 0.f;
#pragma unroll
    for (int n8 = NG - 1; n8 >= 0; --n8) {
      const float v0 = g[4 * n8 + 2 * hr], v1 = g[4 * n8 + 2 * hr + 1];
      float x = v0 + v1;
      float y = __shfl_down_sync(FULL, x, 1, 4);
      if (q < 3) x += y;
      y = __shfl_down_sync(FULL, x, 2, 4);
      if (q < 2) x += y;
      const float quad = __shfl_sync(FULL, x, 0, 4);
      float after = __shfl_down_sync(FULL, x, 1, 4);
      if (q == 3) after = 0.f;
      after += cur;
      g[4 * n8 + 2 * hr + 1] = v1 + after;
      g[4 * n8 + 2 * hr] = v0 + g[4 * n8 + 2 * hr + 1];
      cur = quad + cur;
    }
  }
}

// Sum of v over the eight row groups of a warp (lanes 4 apart).
__device__ __forceinline__ float col_sum(float v) {
  v += __shfl_xor_sync(FULL, v, 4);
  v += __shfl_xor_sync(FULL, v, 8);
  v += __shfl_xor_sync(FULL, v, 16);
  return v;
}

template <int NP>
__global__ void __launch_bounds__(256, 1)
    tcb_head_slice_kernel(const __grid_constant__ Maps m, const Params p) {
  constexpr int STAGE = stage_bytes(NP);
  constexpr int NKS = 4 * NP;   // k-steps of 16 over N
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = hopper::smem_addr(smem_raw);
  const uint32_t base = raw + ((1024u - (raw & 1023u)) & 1023u);
  uint8_t* gen = smem_raw + (base - raw);   // generic pointer to `base`
  const uint32_t s_b = base;
  const uint32_t s_c = s_b + NP * CHUNK_PANEL;
  const uint32_t s_ring = s_c + NP * CHUNK_PANEL;
  auto s_x = [&](int s) { return s_ring + s * STAGE; };
  auto s_dy = [&](int s) { return s_x(s) + CHUNK_PANEL; };
  auto s_ds = [&](int s) { return s_x(s) + 2 * CHUNK_PANEL; };
  auto s_sp = [&](int s) { return s_ds(s) + NP * PT_PANEL; };
  auto s_ca = [&](int s) { return s_ring + 2 * STAGE + s * SMALL; };
  auto s_ew = [&](int s) { return s_ca(s) + Q * 8; };
  float* xch =
      reinterpret_cast<float*>(gen + (s_ring + 2 * (STAGE + SMALL) - base));
  float* red = xch + 64 * LDX;       // [8 warps][Q]
  float* us = red + 8 * Q;           // [2][Q], by head parity
  float* vs = us + 2 * Q;            // [Q]
  float* rO = vs + Q;                // [2][64] row totals above the diagonal
  float* cOr = rO + 2 * 64;          // [4 warps][64] their column totals
  float* zred = cOr + 4 * 64;        // [2][8]
  const uint32_t s_bar = hopper::smem_addr(zred + 16);
  auto full = [&](int s) { return s_bar + 8 * s; };
  const uint32_t bc_full = s_bar + 16;

  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int wtid = tid & 127;
  const int warp = wtid >> 5;
  const int gw = tid >> 5;
  const int lane = tid & 31;
  const int q = lane & 3;
  const int ra = warp * 16 + (lane >> 2);
  const int c2 = 2 * q;
  const int c = blockIdx.x;
  const int g = blockIdx.y / p.slices;
  const int sl = blockIdx.y - g * p.slices;
  const int b = blockIdx.z;
  const int hpg = p.H / p.G;
  const int h0 = g * hpg + sl * hpg / p.slices;
  const int nh = g * hpg + (sl + 1) * hpg / p.slices - h0;
  const int t0 = c * Q;
  const int rows = min(Q, p.L - t0);
  const int64_t tok0 = static_cast<int64_t>(b) * p.L + t0;
  const int64_t xs = static_cast<int64_t>(p.H) * p.P;
  const bool has_prev = c > 0;
  auto bch_of = [&](int h) {
    return (static_cast<int64_t>(b) * p.nc + c) * p.H + h;
  };

  // head h0 + k into stage k & 1 (one thread)
  auto issue = [&](int k) {
    const int s = k & 1;
    const int h = h0 + k;
    const int64_t bch = bch_of(h);
    const uint32_t bar = full(s);
    hopper::mbar_expect_tx(bar, 4 * BOX + (has_prev ? 2 : 1) * NP * PT_PANEL +
                                    SMALL);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      hopper::tma_load_4d(s_x(s) + r * BOX, &m.x, bar, 0, h, t0 + 64 * r, b);
      hopper::tma_load_4d(s_dy(s) + r * BOX, &m.dy, bar, 0, h, t0 + 64 * r,
                          b);
    }
#pragma unroll
    for (int np = 0; np < NP; ++np) {
      hopper::tma_load_4d(s_ds(s) + np * PT_PANEL, &m.ds, bar, 64 * np, 0, 0,
                          static_cast<int>(bch));
      if (has_prev)
        hopper::tma_load_4d(s_sp(s) + np * PT_PANEL, &m.sp, bar, 64 * np, 0,
                            0, static_cast<int>(bch));
    }
    hopper::bulk_load(s_ca(s), p.ca + bch * Q, Q * 8, bar);
    hopper::bulk_load(s_ew(s), p.ew + bch * EW, EW * 4, bar);
  };

  if (tid == 0) {
    hopper::mbar_init(full(0), 1);
    hopper::mbar_init(full(1), 1);
    hopper::mbar_init(bc_full, 1);
    hopper::fence_barrier_init();
  }
  __syncthreads();
  if (tid == 0) {
    hopper::tma_prefetch(&m.x);
    hopper::tma_prefetch(&m.dy);
    hopper::tma_prefetch(&m.ds);
    hopper::tma_prefetch(&m.sp);
    hopper::mbar_expect_tx(bc_full, 2 * NP * CHUNK_PANEL);
#pragma unroll
    for (int np = 0; np < NP; ++np)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        hopper::tma_load_4d(s_b + np * CHUNK_PANEL + r * BOX, &m.b, bc_full,
                            64 * np, g, t0 + 64 * r, b);
        hopper::tma_load_4d(s_c + np * CHUNK_PANEL + r * BOX, &m.c, bc_full,
                            64 * np, g, t0 + 64 * r, b);
      }
    issue(0);
    if (nh > 1) issue(1);
  }

  // this warpgroup's tiles of the [j][i] plane: the diagonal one (rows and
  // columns 64 wg..), and the half above the diagonal (rows 0..63, columns
  // io0..io0 + 31); this thread's rows ra and ra + 8 of each, columns
  // 8 n8 + c2 + {0, 1}
  const int d0 = 64 * wg;
  const int io0 = 64 + 32 * wg;

  hopper::mbar_wait(bc_full, 0);

  // the slice's sum of (dy x^T) o D on this warpgroup's tiles
  float dcd[32], dco[16];
#pragma unroll
  for (int i = 0; i < 32; ++i) dcd[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 16; ++i) dco[i] = 0.f;

  // d log a_t = R_t + sum_{i >= t} u_i + sum_{j < t} v_j + exp(ca_last)
  // <dS, S_prev> of head h (the k-th), thread t of warpgroup 1: run in the
  // next head's wgmma shadow (its u and z rows are the other buffers;
  // warpgroup 0 writes the column partials, the totals above the diagonal
  // and v again only after barrier 1, which this warpgroup arrives at after
  // it)
  auto dlog_a = [&](int k, int h, float dAh, float avh) {
    const int t = wtid;
    const float* uk = us + Q * (k & 1);
    float R = 0.f;
#pragma unroll
    for (int w = 0; w < 4; ++w) R += red[(t < 64 ? w : 4 + w) * Q + t];
    // Four scans a warp, interleaved: the half above the diagonal, two of
    // its 64 rows and columns a lane (for t < 64 its rows j < t: an
    // exclusive prefix of the row totals; for t >= 64 its columns i >= t:
    // an inclusive suffix of the column totals, each the sum of the four
    // warps' partials), and u and v, four of the Q values a lane
    const float2 r0 = reinterpret_cast<const float2*>(rO)[lane];
    const float2 r1 = reinterpret_cast<const float2*>(rO + 64)[lane];
    const float ra0 = r0.x + r1.x, ra1 = r0.y + r1.y;
    float c0 = 0.f, c1 = 0.f;
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      const float2 cw = reinterpret_cast<const float2*>(cOr + 64 * w)[lane];
      c0 += cw.x;
      c1 += cw.y;
    }
    const float4 u4 = reinterpret_cast<const float4*>(uk)[lane];
    const float4 v4 = reinterpret_cast<const float4*>(vs)[lane];
    float pr = ra0 + ra1, sc = c0 + c1;
    float su = u4.x + (u4.y + (u4.z + u4.w));
    float pv = ((v4.x + v4.y) + v4.z) + v4.w;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float a_pr = __shfl_up_sync(FULL, pr, off);
      const float a_sc = __shfl_down_sync(FULL, sc, off);
      const float a_su = __shfl_down_sync(FULL, su, off);
      const float a_pv = __shfl_up_sync(FULL, pv, off);
      if (lane >= off) {
        pr = a_pr + pr;
        pv = a_pv + pv;
      }
      if (lane + off < 32) {
        sc = sc + a_sc;
        su = su + a_su;
      }
    }
    // exclusive: what lies before (prefix) or after (suffix) a lane's share
    float epr = __shfl_up_sync(FULL, pr, 1), ev = __shfl_up_sync(FULL, pv, 1);
    float esc = __shfl_down_sync(FULL, sc, 1);
    float eu = __shfl_down_sync(FULL, su, 1);
    if (lane == 0) epr = ev = 0.f;
    if (lane == 31) esc = eu = 0.f;
    const int l2 = (t & 63) >> 1;
    const float e_pr = __shfl_sync(FULL, epr, l2);
    const float e_sc = __shfl_sync(FULL, esc, l2);
    const float a0 = __shfl_sync(FULL, ra0, l2);
    const float c0t = __shfl_sync(FULL, c0, l2);
    const float c1t = __shfl_sync(FULL, c1, l2);
    R += t < 64 ? ((t & 1) ? e_pr + a0 : e_pr)
                : ((t & 1) ? c1t + e_sc : c0t + (c1t + e_sc));
    // u over i >= t and v over j < t: the lane holding t's four, then the
    // rest of t's four in order
    const int grp = t >> 2, kq = t & 3;
    float U = __shfl_sync(FULL, eu, grp);
    float V = __shfl_sync(FULL, ev, grp);
    const float4 g4 = reinterpret_cast<const float4*>(uk)[grp];
    const float4 w4 = reinterpret_cast<const float4*>(vs)[grp];
    U = g4.w + U;
    if (kq <= 2) U = g4.z + U;
    if (kq <= 1) U = g4.y + U;
    if (kq == 0) U = g4.x + U;
    if (kq >= 1) V = V + w4.x;
    if (kq >= 2) V = V + w4.y;
    if (kq >= 3) V = V + w4.z;
    float zs = 0.f;
#pragma unroll
    for (int w = 0; w < 8; ++w) zs += zred[8 * (k & 1) + w];
    const float dla = ((R + U) + V) + dAh * zs;
    if (t < rows)
      p.da[(tok0 + t) * p.H + h] = avh >= 1e-37f ? dla / avh : 0.f;
  };
  float dA_prev = 0.f, av_prev = 1.f;

  for (int k = 0; k < nh; ++k) {
    const int s = k & 1;
    const int h = h0 + k;
    const uint32_t sx = s_x(s), sdy = s_dy(s), sds = s_ds(s), ssp = s_sp(s);
    const uint8_t* x_tile = gen + (sx - base);
    const uint8_t* dy_tile = gen + (sdy - base);
    const double* ca2 = reinterpret_cast<const double*>(gen + (s_ca(s) - base));
    const float* es = reinterpret_cast<const float*>(gen + (s_ew(s) - base));
    const float* wsv = es + Q;
    // a_t for d log a (thread t of warpgroup 1), read long before its use
    const float av = wg == 1 && wtid < rows ? p.a[(tok0 + wtid) * p.H + h]
                                            : 1.f;
    hopper::mbar_wait(full(s), (k >> 1) & 1);
    // exp(ca_last): the stage is refilled after this head's last barrier
    const float dA = es[4 * Q];

    // ---- 1. C S_prev^T (rows i = d0.., K = N) and x dy^T (rows j,
    //      columns i: the diagonal tile and the half above it)
    float cs[32], gd[32], go[16], cbd[32], cbo[16];
#pragma unroll
    for (int i = 0; i < 32; ++i) cs[i] = gd[i] = cbd[i] = 0.f;
#pragma unroll
    for (int i = 0; i < 16; ++i) go[i] = cbo[i] = 0.f;
    hopper::fence_regs(cs);
    hopper::fence_regs(gd);
    hopper::fence_regs(go);
    hopper::fence_regs(cbd);
    hopper::fence_regs(cbo);
    hopper::wgmma_fence();
    // (chunk 0 has no S_prev tile: the product runs on whatever the slot
    // holds and is not read, so no wgmma sits in a branch)
#pragma unroll
    for (int ks = 0; ks < NKS; ++ks)
      hopper::wgmma_ss_m64n64k16(
          cs,
          hopper::make_desc(s_c + (ks >> 2) * CHUNK_PANEL + d0 * ROW +
                                (ks & 3) * 32,
                            16, 1024),
          hopper::make_desc(ssp + (ks >> 2) * PT_PANEL + (ks & 3) * 32, 16,
                            1024),
          1);
    hopper::wgmma_commit();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      hopper::wgmma_ss_m64n64k16(
          gd, hopper::make_desc(sx + d0 * ROW + ks * 32, 16, 1024),
          hopper::make_desc(sdy + d0 * ROW + ks * 32, 16, 1024), 1);
      wgmma_ss_m64n32k16(go, hopper::make_desc(sx + ks * 32, 16, 1024),
                         hopper::make_desc(sdy + io0 * ROW + ks * 32, 16,
                                           1024));
    }
    // B C^T (rows j of B, columns i of C, K = N) on the same tiles, again
    // each head: kept across heads it would hold 48 registers a thread,
    // which the rest of the head needs
#pragma unroll
    for (int ks = 0; ks < NKS; ++ks) {
      const uint32_t k_off = (ks >> 2) * CHUNK_PANEL + (ks & 3) * 32;
      hopper::wgmma_ss_m64n64k16(
          cbd, hopper::make_desc(s_b + k_off + d0 * ROW, 16, 1024),
          hopper::make_desc(s_c + k_off + d0 * ROW, 16, 1024), 1);
      wgmma_ss_m64n32k16(cbo, hopper::make_desc(s_b + k_off, 16, 1024),
                         hopper::make_desc(s_c + k_off + io0 * ROW, 16, 1024));
    }
    hopper::wgmma_commit();

    // z = <dS, S_prev> (this head's partial a warp) while they run: the
    // two tiles share one layout, so any matching chunks pair up
    {
      float z = 0.f;
      if (has_prev) {
        const uint4* d4 = reinterpret_cast<const uint4*>(gen + (sds - base));
        const uint4* s4 = reinterpret_cast<const uint4*>(gen + (ssp - base));
        for (int idx = tid; idx < NP * PT_PANEL / 16; idx += 256) {
          const uint4 u = d4[idx], v = s4[idx];
          const uint32_t uu[4] = {u.x, u.y, u.z, u.w};
          const uint32_t vv[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float2 a2 = hopper::unpack_bf16(uu[e]);
            const float2 b2 = hopper::unpack_bf16(vv[e]);
            z = fmaf(a2.x, b2.x, z);
            z = fmaf(a2.y, b2.y, z);
          }
        }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        z += __shfl_xor_sync(FULL, z, off);
      if (lane == 0) zred[8 * s + gw] = z;
    }

    // ---- 2. u_i = e_i dy_i . (C S_prev^T)_i (rows i = d0 + ra, + 8)
    hopper::wgmma_wait<1>();
    hopper::fence_regs(cs);
    {
      float ua = 0.f, ub = 0.f;
      if (has_prev) {
#pragma unroll
        for (int n8 = 0; n8 < 8; ++n8) {
          const float2 ya = pair_at(dy_tile, d0 + ra, 8 * n8 + c2);
          const float2 yb = pair_at(dy_tile, d0 + ra + 8, 8 * n8 + c2);
          ua = fmaf(ya.x, cs[4 * n8], ua);
          ua = fmaf(ya.y, cs[4 * n8 + 1], ua);
          ub = fmaf(yb.x, cs[4 * n8 + 2], ub);
          ub = fmaf(yb.y, cs[4 * n8 + 3], ub);
        }
        ua += __shfl_xor_sync(FULL, ua, 1);
        ua += __shfl_xor_sync(FULL, ua, 2);
        ub += __shfl_xor_sync(FULL, ub, 1);
        ub += __shfl_xor_sync(FULL, ub, 2);
      }
      if (q == 0) {
        us[Q * s + d0 + ra] = es[d0 + ra] * ua;
        us[Q * s + d0 + ra + 8] = es[d0 + ra + 8] * ub;
      }
    }

    // the previous head's d log a while x dy^T runs; then warpgroup 0 may
    // write the buffers it read (barrier 1, below)
    if (wg == 1) {
      if (k > 0) dlog_a(k - 1, h - 1, dA_prev, av_prev);
      bar_arrive_1();
    }
    dA_prev = dA;
    av_prev = av;

    // ---- 3. D; G = (dy x^T) o M, the slice's (dy x^T) o D and M^T in
    //      bf16 registers
    hopper::wgmma_wait0();
    hopper::fence_regs(gd);
    hopper::fence_regs(go);
    hopper::fence_regs(cbd);
    hopper::fence_regs(cbo);
    // D_ij = 2^(ca_i - ca_j) for this thread's elements, 8 columns at a
    // time: fd(n8, d) on the diagonal tile (0 below the diagonal), fo(n8,
    // d) on the half above.  The factored pair's product where the chunk
    // kernel found the span small enough, else one 2^x an entry (the form
    // is chosen once a head, outside the unrolled loops)
    auto decays = [&](auto factored, auto fd, auto fo) {
      constexpr bool FAC = decltype(factored)::value;
      const float* Es = es + 2 * Q;
      const float* Fs = es + 3 * Q;
      const double cda = ca2[d0 + ra], cdb = ca2[d0 + ra + 8];
      const double coa = ca2[ra], cob = ca2[ra + 8];
      const float fda = Fs[d0 + ra], fdb = Fs[d0 + ra + 8];
      const float foa = Fs[ra], fob = Fs[ra + 8];
      auto decay = [&](int i, double cj, float fj) {
        if constexpr (FAC)
          return Es[i] * fj;
        else
          return exp2f(static_cast<float>(ca2[i] - cj));
      };
#pragma unroll
      for (int n8 = 0; n8 < 8; ++n8) {
        float d[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 8 * n8 + c2 + (e & 1);   // columns d0 + i
          const int j = ra + 8 * (e >> 1);       // rows d0 + j
          d[e] = i >= j ? decay(d0 + i, e < 2 ? cda : cdb, e < 2 ? fda : fdb)
                        : 0.f;
        }
        fd(n8, d);
      }
#pragma unroll
      for (int n8 = 0; n8 < 4; ++n8) {
        float d[4];
#pragma unroll
        for (int e = 0; e < 4; ++e)
          d[e] = decay(io0 + 8 * n8 + c2 + (e & 1), e < 2 ? coa : cob,
                       e < 2 ? foa : fob);
        fo(n8, d);
      }
    };
    const bool fac = es[4 * Q + 1] != 0.f;
    auto with_decays = [&](auto fd, auto fo) {
      if (fac)
        decays(Bool<true>{}, fd, fo);
      else
        decays(Bool<false>{}, fd, fo);
    };
    uint32_t mtd[4][4], mto[2][4];
    with_decays(
        [&](int n8, const float(&d)[4]) {
          float mv[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int x = 4 * n8 + e;
            mv[e] = cbd[x] * d[e];
            dcd[x] += gd[x] * d[e];
            gd[x] *= mv[e];
          }
          mtd[n8 >> 1][2 * (n8 & 1)] = hopper::pack_bf16(mv[0], mv[1]);
          mtd[n8 >> 1][2 * (n8 & 1) + 1] = hopper::pack_bf16(mv[2], mv[3]);
        },
        [&](int n8, const float(&d)[4]) {
          float mv[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int x = 4 * n8 + e;
            mv[e] = cbo[x] * d[e];
            dco[x] += go[x] * d[e];
            go[x] *= mv[e];
          }
          mto[n8 >> 1][2 * (n8 & 1)] = hopper::pack_bf16(mv[0], mv[1]);
          mto[n8 >> 1][2 * (n8 & 1) + 1] = hopper::pack_bf16(mv[2], mv[3]);
        });

    // ---- 4. B dS^T (rows j = d0.., K = N) runs while d log a's sums of
    //      G are taken
    float dxa[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) dxa[i] = 0.f;
    hopper::fence_regs(dxa);
    hopper::wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < NKS; ++ks)
      hopper::wgmma_ss_m64n64k16(
          dxa,
          hopper::make_desc(s_b + (ks >> 2) * CHUNK_PANEL + d0 * ROW +
                                (ks & 3) * 32,
                            16, 1024),
          hopper::make_desc(sds + (ks >> 2) * PT_PANEL + (ks & 3) * 32, 16,
                            1024),
          1);
    hopper::wgmma_commit();

    // R_t = sum_{j < t <= i} G_ji.  On the diagonal tile: row suffix
    // sums over i, then sums down each column over rows j < t.  The half
    // above the diagonal has every row below and every column above each t
    // it reaches: its row totals (summed over j < t for t < 64) and column
    // totals (over i >= t for t >= 64) suffice, added at d log a
    {
      if (wg == 0) hopper::named_barrier_sync(1, 256);
      row_suffix<8>(gd, q);
      float v[16];
#pragma unroll
      for (int n8 = 0; n8 < 8; ++n8)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = 8 * n8 + c2 + e;
          v[2 * n8 + e] = (ra < i ? gd[4 * n8 + e] : 0.f) +
                          (ra + 8 < i ? gd[4 * n8 + 2 + e] : 0.f);
        }
      // down the columns (a halving exchange instead, tried, put these 16
      // values in local memory and was slower)
#pragma unroll
      for (int i = 0; i < 16; ++i) v[i] = col_sum(v[i]);
      if (lane < 4) {
#pragma unroll
        for (int n8 = 0; n8 < 8; ++n8)
          *reinterpret_cast<float2*>(red + gw * Q + d0 + 8 * n8 + c2) =
              make_float2(v[2 * n8], v[2 * n8 + 1]);
      }
      float ta = 0.f, tb = 0.f;
#pragma unroll
      for (int n8 = 0; n8 < 4; ++n8)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          ta += go[4 * n8 + e];
          tb += go[4 * n8 + 2 + e];
        }
      ta += __shfl_xor_sync(FULL, ta, 1);
      ta += __shfl_xor_sync(FULL, ta, 2);
      tb += __shfl_xor_sync(FULL, tb, 1);
      tb += __shfl_xor_sync(FULL, tb, 2);
      if (q == 0) {
        rO[64 * wg + ra] = ta;
        rO[64 * wg + ra + 8] = tb;
      }
#pragma unroll
      for (int n8 = 0; n8 < 4; ++n8)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float cv = col_sum(go[4 * n8 + e] + go[4 * n8 + 2 + e]);
          if (lane < 4) cOr[warp * 64 + 32 * wg + 8 * n8 + c2 + e] = cv;
        }
    }

    // ---- 5. v_j = w_j x_j . (B dS^T)_j; dx = w o (B dS^T) + M^T dy
    hopper::wgmma_wait0();
    hopper::fence_regs(dxa);
    {
      float va = 0.f, vb = 0.f;
#pragma unroll
      for (int n8 = 0; n8 < 8; ++n8) {
        const float2 xa = pair_at(x_tile, d0 + ra, 8 * n8 + c2);
        const float2 xb = pair_at(x_tile, d0 + ra + 8, 8 * n8 + c2);
        va = fmaf(xa.x, dxa[4 * n8], va);
        va = fmaf(xa.y, dxa[4 * n8 + 1], va);
        vb = fmaf(xb.x, dxa[4 * n8 + 2], vb);
        vb = fmaf(xb.y, dxa[4 * n8 + 3], vb);
      }
      va += __shfl_xor_sync(FULL, va, 1);
      va += __shfl_xor_sync(FULL, va, 2);
      vb += __shfl_xor_sync(FULL, vb, 1);
      vb += __shfl_xor_sync(FULL, vb, 2);
      const float wa = wsv[d0 + ra], wb = wsv[d0 + ra + 8];
      if (q == 0) {
        vs[d0 + ra] = wa * va;
        vs[d0 + ra + 8] = wb * vb;
      }
#pragma unroll
      for (int n8 = 0; n8 < 8; ++n8) {
        dxa[4 * n8] *= wa;
        dxa[4 * n8 + 1] *= wa;
        dxa[4 * n8 + 2] *= wb;
        dxa[4 * n8 + 3] *= wb;
      }
    }
    // K = i: the diagonal tile's 64 columns into dxa; the half above's 32
    // into xo, the first rows' share (added to dxa by warpgroup 0, through
    // xch by 1; the same products in both, so no wgmma sits in a branch)
    float xo[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) xo[i] = 0.f;
    hopper::fence_regs(dxa);
    hopper::fence_regs(xo);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      hopper::wgmma_rs<64>(
          dxa, mtd[kk],
          hopper::make_desc(sdy + (d0 + 16 * kk) * ROW, CHUNK_PANEL, 1024));
#pragma unroll
    for (int kk = 0; kk < 2; ++kk)
      hopper::wgmma_rs<64>(
          xo, mto[kk],
          hopper::make_desc(sdy + (io0 + 16 * kk) * ROW, CHUNK_PANEL, 1024));
    hopper::wgmma_commit();
    hopper::wgmma_wait0();
    fence_frags(mtd);
    fence_frags(mto);
    hopper::fence_regs(dxa);
    hopper::fence_regs(xo);
    if (wg == 0) {
#pragma unroll
      for (int i = 0; i < 32; ++i) dxa[i] += xo[i];
    } else {
#pragma unroll
      for (int n8 = 0; n8 < 8; ++n8) {
        *reinterpret_cast<float2*>(xch + ra * LDX + 8 * n8 + c2) =
            make_float2(xo[4 * n8], xo[4 * n8 + 1]);
        *reinterpret_cast<float2*>(xch + (ra + 8) * LDX + 8 * n8 + c2) =
            make_float2(xo[4 * n8 + 2], xo[4 * n8 + 3]);
      }
    }
    __syncthreads();   // xch, red, u, v ready; stage s read out
    if (tid == 0 && k + 2 < nh) issue(k + 2);

    if (wg == 0) {
#pragma unroll
      for (int n8 = 0; n8 < 8; ++n8) {
        const float2 ta = *reinterpret_cast<const float2*>(
            xch + ra * LDX + 8 * n8 + c2);
        const float2 tb = *reinterpret_cast<const float2*>(
            xch + (ra + 8) * LDX + 8 * n8 + c2);
        dxa[4 * n8] += ta.x;
        dxa[4 * n8 + 1] += ta.y;
        dxa[4 * n8 + 2] += tb.x;
        dxa[4 * n8 + 3] += tb.y;
      }
    }
    // dx in bf16: a 4 x 4 transpose of column pairs within each quad, so
    // each lane holds 8 consecutive columns of a row, then 16-byte stores
    {
      bf* dxp = p.dx + tok0 * xs + static_cast<int64_t>(h) * p.P;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int j = d0 + ra + 8 * half;
#pragma unroll
        for (int grp = 0; grp < 2; ++grp) {
          uint32_t a4[4];
#pragma unroll
          for (int i = 0; i < 4; ++i)
            a4[i] = hopper::pack_bf16(dxa[4 * (4 * grp + i) + 2 * half],
                                      dxa[4 * (4 * grp + i) + 2 * half + 1]);
          quad_transpose(a4, q);
          const int col = 8 * (4 * grp + q);
          if (j < rows && col < p.P)
            *reinterpret_cast<uint4*>(dxp + j * xs + col) =
                make_uint4(a4[0], a4[1], a4[2], a4[3]);
        }
      }
    }
  }
  if (wg == 1) dlog_a(nh - 1, h0 + nh - 1, dA_prev, av_prev);

  // the slice's partial sum, [j][i]
  float* dco_out =
      p.dcbh + ((static_cast<int64_t>(b) * p.nc + c) * gridDim.y + blockIdx.y) *
                   Q * Q;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int j = ra + 8 * half;
#pragma unroll
    for (int n8 = 0; n8 < 8; ++n8)
      *reinterpret_cast<float2*>(dco_out + (d0 + j) * Q + d0 + 8 * n8 + c2) =
          make_float2(dcd[4 * n8 + 2 * half], dcd[4 * n8 + 2 * half + 1]);
#pragma unroll
    for (int n8 = 0; n8 < 4; ++n8)
      *reinterpret_cast<float2*>(dco_out + j * Q + io0 + 8 * n8 + c2) =
          make_float2(dco[4 * n8 + 2 * half], dco[4 * n8 + 2 * half + 1]);
  }
}

// ---------------------------------------------------------------------------
// 4. dC or dB: all Q rows (a warpgroup each half), 64 columns, a CTA

__host__ __device__ constexpr int group_smem_bytes() {
  // the B or C tile's 64 columns (one panel of Q rows); a ring of A tiles
  // (dy or x, Q rows) and of B tiles (S_prev or dS, one panel of PT rows);
  // the ring's e or w rows; mbarriers
  return CHUNK_PANEL + GSTAGES * (CHUNK_PANEL + PT_PANEL) + GSTAGES * Q * 4 +
         (2 * GSTAGES + 1) * 8 + 1024;
}

__global__ void __launch_bounds__(256, 1)
    tcb_group_kernel(const __grid_constant__ Maps m, const Params p) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = hopper::smem_addr(smem_raw);
  const uint32_t base = raw + ((1024u - (raw & 1023u)) & 1023u);
  uint8_t* gen = smem_raw + (base - raw);
  const uint32_t s_op = base;
  const uint32_t s_ra = s_op + CHUNK_PANEL;              // [GSTAGES] A tiles
  const uint32_t s_rb = s_ra + GSTAGES * CHUNK_PANEL;    // [GSTAGES] B tiles
  const uint32_t s_sc = s_rb + GSTAGES * PT_PANEL;       // [GSTAGES][Q]
  const uint32_t s_bar = s_sc + GSTAGES * Q * 4;
  auto full = [&](int s) { return s_bar + 8 * s; };
  auto empty = [&](int s) { return s_bar + 8 * (GSTAGES + s); };
  const uint32_t op_full = s_bar + 8 * 2 * GSTAGES;

  const int tid = threadIdx.x;
  const int wg = tid >> 7;             // rows 64 wg.. of the tile
  const int warp = (tid & 127) >> 5;
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
  const int g = y / n_nt;
  const int r0 = 64 * wg;
  const int n0 = 64 * nt;
  const int t0 = c * Q;
  const int rows = min(Q, p.L - t0);
  const int64_t tok0 = static_cast<int64_t>(b) * p.L + t0;
  const int64_t bc = static_cast<int64_t>(b) * p.nc + c;
  const int64_t bcs = static_cast<int64_t>(p.G) * p.N;
  const int hpg = p.H / p.G;
  const int nk = (which == 1 || c > 0) ? hpg : 0;   // chunk 0: S_prev = 0

  // head k of the group into stage k % GSTAGES (one thread)
  auto issue = [&](int k) {
    const int s = k % GSTAGES;
    const int h = g * hpg + k;
    const int64_t bch = bc * p.H + h;
    hopper::mbar_expect_tx(full(s), CHUNK_PANEL + PT_PANEL + Q * 4);
#pragma unroll
    for (int r = 0; r < 2; ++r)
      hopper::tma_load_4d(s_ra + s * CHUNK_PANEL + r * BOX,
                          which ? &m.x : &m.dy, full(s), 0, h, t0 + 64 * r,
                          b);
    hopper::tma_load_4d(s_rb + s * PT_PANEL, which ? &m.ds : &m.sp, full(s),
                        n0, 0, 0, static_cast<int>(bch));
    hopper::bulk_load(s_sc + s * Q * 4, p.ew + bch * EW + which * Q, Q * 4,
                      full(s));
  };
  if (tid == 0) {
    for (int s = 0; s < GSTAGES; ++s) {
      hopper::mbar_init(full(s), 1);
      hopper::mbar_init(empty(s), 8);   // one a warp
    }
    hopper::mbar_init(op_full, 1);
    hopper::fence_barrier_init();
  }
  __syncthreads();
  if (tid == 0) {
    // dC: the B tile (rows j); dB: the C tile (rows i); columns n0..n0+63
    hopper::mbar_expect_tx(op_full, CHUNK_PANEL);
    for (int r = 0; r < 2; ++r)
      hopper::tma_load_4d(s_op + r * BOX, which ? &m.c : &m.b, op_full, n0, g,
                          t0 + 64 * r, b);
    for (int k = 0; k < min(GSTAGES, nk); ++k) issue(k);
  }

  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
  const int ia = r0 + ra;
  const int ib = ia + 8;

  // ---- the group sum of (dy x^T) o D, stored [j][i] per slice: dC's A is
  //      its transpose (rows i, k over j <= i), dB's A as stored (rows j, k
  //      over i >= j); the slices added in order, then rounded to bf16
  uint32_t pa[8][4];
  {
    const float* dT = p.dcbh + (bc * p.G + g) * p.slices * Q * Q;
    const int k_lo = which ? 4 * wg : 0;
    const int k_hi = which ? 8 : 4 * (wg + 1);
    // (zeros outside this warpgroup's k-range, which the slices never
    // wrote: both warpgroups then issue the same products)
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      const bool used = kk >= k_lo && kk < k_hi;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int k = 16 * kk + 8 * hh + c2;
        float m4[4] = {0.f, 0.f, 0.f, 0.f};
        for (int s = 0; used && s < p.slices; ++s) {
          const float* d = dT + static_cast<int64_t>(s) * Q * Q;
          if (which) {
            const float2 va = *reinterpret_cast<const float2*>(d + ia * Q + k);
            const float2 vb = *reinterpret_cast<const float2*>(d + ib * Q + k);
            m4[0] += va.x;
            m4[1] += va.y;
            m4[2] += vb.x;
            m4[3] += vb.y;
          } else {
            m4[0] += d[k * Q + ia];
            m4[1] += d[(k + 1) * Q + ia];
            m4[2] += d[k * Q + ib];
            m4[3] += d[(k + 1) * Q + ib];
          }
        }
        pa[kk][2 * hh] = hopper::pack_bf16(m4[0], m4[1]);
        pa[kk][2 * hh + 1] = hopper::pack_bf16(m4[2], m4[3]);
      }
    }
    hopper::mbar_wait(op_full, 0);
    fence_frags(pa);
    hopper::fence_regs(acc);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 8; ++kk)
      hopper::wgmma_rs<64>(
          acc, pa[kk],
          hopper::make_desc(s_op + kk * 16 * ROW, CHUNK_PANEL, 1024));
    hopper::wgmma_commit();
  }

  // ---- + sum_h (e o dy) S_prev (dC) or (w o x) dS (dB), heads ascending:
  //      each warpgroup rounds its 64 rows of the head's tile, times e or
  //      w, to bf16 in place (then fences them for the tensor cores), and
  //      multiplies them by the S_prev or dS tile from shared memory, one
  //      product in flight behind the next head's
  for (int k = 0; k < nk; ++k) {
    const int s = k % GSTAGES;
    hopper::mbar_wait(full(s), (k / GSTAGES) & 1);
    const uint32_t sa = s_ra + s * CHUNK_PANEL;
    {
      uint8_t* at = gen + (sa - base);
      const float* sc =
          reinterpret_cast<const float*>(gen + (s_sc - base)) + s * Q;
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const int idx = (tid & 127) + 128 * m;
        const int r = r0 + (idx >> 3);
        uint4* ptr = reinterpret_cast<uint4*>(at + swz(Q, r, idx & 7));
        uint4 v = *ptr;
        const float f = sc[r];
        uint32_t* w = reinterpret_cast<uint32_t*>(&v);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 u = hopper::unpack_bf16(w[e]);
          w[e] = hopper::pack_bf16(f * u.x, f * u.y);
        }
        *ptr = v;
      }
    }
    hopper::fence_proxy_async();
    hopper::named_barrier_sync(1 + wg, 128);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_ss_m64n64k16_tb(
          acc, hopper::make_desc(sa + r0 * ROW + kk * 32, 16, 1024),
          hopper::make_desc(s_rb + s * PT_PANEL + kk * 16 * ROW, PT_PANEL,
                            1024));
    hopper::wgmma_commit();
    hopper::wgmma_wait<1>();   // head k - 1's product (or the group sum's)
    if (k == 0) fence_frags(pa);
    if (k >= 1) {
      const int sp = (k - 1) % GSTAGES;
      if (lane == 0) hopper::mbar_arrive(empty(sp));
      if (tid == 0 && k - 1 + GSTAGES < nk) {
        hopper::mbar_wait(empty(sp), ((k - 1) / GSTAGES) & 1);
        issue(k - 1 + GSTAGES);
      }
    }
  }
  hopper::wgmma_wait0();
  fence_frags(pa);
  hopper::fence_regs(acc);

  bf* out = (which ? p.dB : p.dC) + tok0 * bcs + static_cast<int64_t>(g) * p.N;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = half ? ib : ia;
    if (r >= rows) continue;
#pragma unroll
    for (int n8 = 0; n8 < 8; ++n8) {
      const int n = n0 + 8 * n8 + c2;
      if (n < p.N)
        *reinterpret_cast<uint32_t*>(out + r * bcs + n) = hopper::pack_bf16(
            acc[4 * n8 + 2 * half], acc[4 * n8 + 2 * half + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// host side

size_t align256(size_t n) { return (n + 255) & ~static_cast<size_t>(255); }

// Offsets of the scratch arrays in the workspace; returns its size.
size_t carve(int Bsz, int L, int H, int P, int G, int N, int slices,
             size_t off[5]) {
  const size_t nc = (static_cast<size_t>(L) + Q - 1) / Q;
  const size_t bc = static_cast<size_t>(Bsz) * nc;
  const size_t sizes[5] = {bc * H * Q * 8, bc * H * EW * 4,
                           bc * H * P * N * 4, bc * H * P * N * 2,
                           bc * G * slices * Q * Q * 4};
  size_t at = 0;
  for (int i = 0; i < 5; ++i) {
    off[i] = at;
    at += align256(sizes[i]);
  }
  return at;
}

template <int NP>
int launch(const Maps& m, const Params& p, cudaStream_t st) {
  auto k1 = tcb_chunk_kernel<NP>;
  auto k3 = tcb_head_slice_kernel<NP>;
  auto k4 = tcb_group_kernel;
  constexpr int b1 = chunk_smem_bytes(NP);
  constexpr int b3 = head_smem_bytes(NP);
  constexpr int b4 = group_smem_bytes();
  static const cudaError_t attr = [&] {
    cudaError_t e = cudaFuncSetAttribute(
        k1, cudaFuncAttributeMaxDynamicSharedMemorySize, b1);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(k3, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               b3);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(k4, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               b4);
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
  k3<<<dim3(p.nc, p.G * p.slices, p.Bsz), 256, b3, st>>>(m, p);
  if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
  k4<<<dim3(p.nc, p.G * ((p.N + 63) / 64) * 2, p.Bsz), 256, b4, st>>>(m, p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Bytes of scratch ssd_scan_tc_bwd_launch needs.
extern "C" long long ssd_scan_tc_bwd_workspace_bytes(int Bsz, int L, int H,
                                                     int P, int G, int N,
                                                     int slices) {
  size_t off[5];
  return static_cast<long long>(carve(Bsz, L, H, P, G, N, slices, off));
}

// Plain C entry point (loaded with ctypes).  x, dy, dx [Bsz, L, H, P], B,
// C, dB, dC [Bsz, L, G, N], s_prev [Bsz, nc, H, P, N] bf16; a, da [Bsz, L,
// H] float32; d_state [Bsz, H, P, N] float32 or null; all contiguous,
// the bf16 ones 16-byte aligned; `work` 256-byte aligned, of
// ssd_scan_tc_bwd_workspace_bytes with the same `slices` (1 <= slices <=
// H / G: the head-slice kernel's slices of each group).  Launches four
// kernels on `stream`, does not synchronise, allocates nothing.  Returns
// cudaGetLastError() of the launches (or of the shared-memory attribute or
// a tensor map), or cudaErrorInvalidValue for an unsupported shape (P > 64,
// N > 128, P or N not a multiple of 8, misaligned pointers).
extern "C" int ssd_scan_tc_bwd_launch(const void* x, const void* a,
                                      const void* B, const void* C,
                                      const void* dy, const void* d_state,
                                      const void* s_prev, void* dx, void* da,
                                      void* dB, void* dC, void* work, int Bsz,
                                      int L, int H, int P, int G, int N,
                                      int slices, void* stream) {
  if (Bsz <= 0 || H <= 0 || P <= 0 || L <= 0) return 0;
  if (G <= 0 || H % G != 0 || N <= 0 || N > 128 || N % 8 != 0 || P > PT ||
      P % 8 != 0 || slices < 1 || slices > H / G)
    return static_cast<int>(cudaErrorInvalidValue);
  if (reinterpret_cast<uintptr_t>(work) % 256 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  for (const void* ptr : {x, B, C, dy, s_prev, static_cast<const void*>(dx),
                          static_cast<const void*>(dB),
                          static_cast<const void*>(dC)})
    if (reinterpret_cast<uintptr_t>(ptr) % 16 != 0)
      return static_cast<int>(cudaErrorInvalidValue);
  size_t off[5];
  carve(Bsz, L, H, P, G, N, slices, off);
  uint8_t* w = static_cast<uint8_t*>(work);
  Params p;
  p.a = static_cast<const float*>(a);
  p.C = static_cast<const bf*>(C);
  p.dy = static_cast<const bf*>(dy);
  p.dsf = static_cast<const float*>(d_state);
  p.dx = static_cast<bf*>(dx);
  p.da = static_cast<float*>(da);
  p.dB = static_cast<bf*>(dB);
  p.dC = static_cast<bf*>(dC);
  p.ca = reinterpret_cast<double*>(w + off[0]);
  p.ew = reinterpret_cast<float*>(w + off[1]);
  p.dsc = reinterpret_cast<float*>(w + off[2]);
  p.dsb = reinterpret_cast<bf*>(w + off[3]);
  p.dcbh = reinterpret_cast<float*>(w + off[4]);
  p.Bsz = Bsz;
  p.L = L;
  p.H = H;
  p.P = P;
  p.G = G;
  p.N = N;
  p.nc = (L + Q - 1) / Q;
  p.slices = slices;
  const int bnh = Bsz * p.nc * H;
  Maps m;
  int err = hopper::tile_map(x, Bsz, L, H, P, &m.x);
  if (err == 0) err = hopper::tile_map(dy, Bsz, L, H, P, &m.dy);
  if (err == 0) err = hopper::tile_map(B, Bsz, L, G, N, &m.b);
  if (err == 0) err = hopper::tile_map(C, Bsz, L, G, N, &m.c);
  if (err == 0) err = hopper::tile_map(p.dsb, bnh, P, 1, N, &m.ds);
  if (err == 0) err = hopper::tile_map(s_prev, bnh, P, 1, N, &m.sp);
  if (err != 0) return err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return N <= 64 ? launch<1>(m, p, st) : launch<2>(m, p, st);
}
