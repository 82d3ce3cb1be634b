// Gradient of the Mamba2 SSD chunked scan on Hopper's CUDA cores (sm_90a).
//
// The reference has no Pallas backward: its training step differentiates
// the sequential oracle src/repro/kernels/ssd_scan/ref.py:21-42 with XLA's
// autodiff.  This is the gradient of the forward kernels of this directory
// (ssd_scan.cu, ssd_scan_tc.cu) as kernels of its own, in float32
// arithmetic for every operand type.  Inputs: x [Bsz, L, H, P], a [Bsz, L,
// H] float32, B / C [Bsz, L, G, N], the cotangents dy [Bsz, L, H, P] (x's
// type) and dS_fin [Bsz, H, P, N] float32 (nullable: zero), and the state
// entering each chunk of Q = 128 tokens, S_prev [Bsz, nc, H, P, N], as the
// forward stored it (bf16 from the tensor-core kernel, float32 from the
// CUDA-core one; chunk 0's is zero and never read).  Outputs dx, da, dB, dC
// in their inputs' types.
//
// Per chunk, with ca the prefix sum of log(max(a, 1e-37)) in double,
// e_i = exp(ca_i), w_j = exp(ca_last - ca_j), D_ij = exp(ca_i - ca_j) for
// j <= i (else 0, never evaluated), M = (C B^T) o D and dS the gradient at
// the chunk's end, five launches on one stream:
//
//   1. bwd_chunk_kernel, grid (chunks, H + G, Bsz): a head CTA writes ca,
//      e, w, exp(ca_last) and the chunk-local state gradient
//      sum_i e_i dy_i (outer) C_i [P, N]; a group CTA writes C B^T [Q, Q].
//   2. bwd_state_pass_kernel: the chunks in reverse, in place,
//      dS[c] = exp(ca_last[c + 1]) dS[c + 1] + (local gradient)[c + 1],
//      seeded by dS_fin.
//   3. bwd_head_kernel, grid (chunks, H, Bsz), one CTA a head:
//      dx = M^T dy + w o (B dS^T); (dy x^T) o D per head to the workspace;
//      d log a_t directly as the sum of the terms that carry a_t,
//        sum_{i >= t > j} (dy_i . x_j) M_ij  (a prefix sum over j of each
//          row, then a sum down each column, in shared memory)
//        + sum_{i >= t} e_i dy_i . (S_prev C_i) + sum_{j < t} w_j x_j .
//          (dS B_j) + exp(ca_last) <dS, S_prev>,
//      so no pair of terms cancels and d log a keeps its relative accuracy
//      where a is small (a reverse cumulative sum of d ca would cancel the
//      terms after t); da = d log a / a where a >= 1e-37, 0 below the
//      forward's clamp (the forward is constant in a there).
//   4. bwd_dcb_sum_kernel: sum_h (dy x^T) o D over each group's heads in
//      ascending order (no atomics: two calls give the same bits).
//   5. bwd_group_kernel, grid (chunks, G x 2 x ceil(N / 64), Bsz), a
//      64 x 64 tile of dC and of dB a CTA:
//        dC = (sum_h (dy x^T) o D) B + sum_h (e o dy) S_prev,
//        dB = (sum_h (dy x^T) o D)^T C + sum_h (w o x) dS,
//      heads in ascending order.
//
// The decay is exp of the float-rounded double difference, one exponential
// an entry, for every chunk: as exact as either decay form of the forward
// kernels (ssd_scan.cu's expf of the same difference; ssd_scan_tc.cu's
// factored 2^(ca - mid) 2^(mid - ca) within a 2^120 span, else one 2^x an
// entry), which agree with it to float rounding.  ref.py's
// ssd_scan_chunked_backward is this arithmetic on the CPU.
//
// It serves float32 and mixed operands (the reduced configs, the training
// launcher's dev mode) and bf16 ones with N > 128; bf16 x, B and C with
// N <= 128 (the models') take the tensor-core kernel, ssd_scan_tc_bwd.cu,
// which this kernel's result on the same bf16 inputs checks on the card.
// Measured (PERF.md): about 1.9 device ms a call at mamba2-780m's training
// shape, bwd_head and bwd_group about 0.8 each (float32 FMAs from shared
// memory, 23 GFLOP against the 67 TFLOP/s float32 rate: 0.34 ms).
//
// Limits: P <= 64 (one head's x and dy tiles beside two Q x Q float tiles
// fill the shared memory), N <= 256 and a multiple of 4.  Workspace
// (ssd_scan_bwd_workspace_bytes): ca, e / w, exp(ca_last), C B^T, the state
// gradients [Bsz, nc, H, P, N] float32, the per-head (dy x^T) o D
// [Bsz, nc, H, Q, Q] float32 and their group sums.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int Q = 128;          // tokens a chunk (the forward's)
constexpr int THREADS = 256;    // a 16 x 16 grid of (ty, tx)
constexpr int PMAX = 64;        // head dim
constexpr int LDP = PMAX + 4;   // row stride of the x / dy tiles (floats)
constexpr int LDQ = Q + 1;      // row stride of the Q x Q tiles
constexpr int NT = 32;          // N columns a streamed tile (step 3)

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

struct Params {
  const void* x;        // [Bsz, L, H, P] TX
  const float* a;       // [Bsz, L, H]
  const void* B;        // [Bsz, L, G, N] TB
  const void* C;        // [Bsz, L, G, N] TB
  const void* dy;       // [Bsz, L, H, P] TX
  const float* dsf;     // [Bsz, H, P, N] or null
  const void* sp;       // [Bsz, nc, H, P, N] TS (chunk 0 unread)
  void* dx;             // [Bsz, L, H, P] TX
  float* da;            // [Bsz, L, H]
  void* dB;             // [Bsz, L, G, N] TB
  void* dC;             // [Bsz, L, G, N] TB
  double* ca;           // [Bsz, nc, H, Q]
  float* ew;            // [Bsz, nc, H, 2, Q]: e, then w
  float* dA;            // [Bsz, nc, H] exp(ca_last)
  float* cb;            // [Bsz, nc, G, Q, Q]
  float* ds;            // [Bsz, nc, H, P, N]
  float* dcbh;          // [Bsz, nc, H, Q, Q]
  float* dcb;           // [Bsz, nc, G, Q, Q]
  int Bsz, L, H, P, G, N, nc;
};

// ---------------------------------------------------------------------------
// 1. ca, e, w, exp(ca_last), the chunk-local state gradient; C B^T

__host__ __device__ constexpr int chunk_smem_bytes() {
  // head CTA: e o dy [Q][PMAX] and a C tile [Q][64]; group CTA: C and B
  // tiles [Q][NT + 1]; then four warp totals in double and e [Q]
  return (2 * Q * 64 > 2 * Q * (NT + 1) ? 2 * Q * 64 : 2 * Q * (NT + 1)) * 4 +
         4 * 8 + Q * 4;
}

template <typename TX, typename TB>
__global__ void __launch_bounds__(THREADS) bwd_chunk_kernel(const Params p) {
  extern __shared__ __align__(16) float smem[];
  const int c = blockIdx.x;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int ty = tid >> 4;
  const int tx = tid & 15;
  const int t0 = c * Q;
  const int rows = min(Q, p.L - t0);
  const int64_t tok0 = static_cast<int64_t>(b) * p.L + t0;
  const TB* Bm = static_cast<const TB*>(p.B);
  const TB* Cm = static_cast<const TB*>(p.C);

  if (static_cast<int>(blockIdx.y) >= p.H) {
    // ---- C B^T of group g, over N in tiles of NT
    const int g = blockIdx.y - p.H;
    float* Cs = smem;                  // [Q][NT + 1]
    float* Bs = Cs + Q * (NT + 1);     // [Q][NT + 1]
    float acc[8][8];
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int cc = 0; cc < 8; ++cc) acc[r][cc] = 0.f;
    for (int n0 = 0; n0 < p.N; n0 += NT) {
      __syncthreads();
      for (int idx = tid; idx < Q * NT; idx += THREADS) {
        const int r = idx / NT;
        const int n = idx - r * NT;
        const bool in = r < rows && n0 + n < p.N;
        const int64_t off = (tok0 + r) * p.G * p.N +
                            static_cast<int64_t>(g) * p.N + n0 + n;
        Cs[r * (NT + 1) + n] = in ? to_f(Cm[off]) : 0.f;
        Bs[r * (NT + 1) + n] = in ? to_f(Bm[off]) : 0.f;
      }
      __syncthreads();
#pragma unroll 4
      for (int n = 0; n < NT; ++n) {
        float cv[8], bv[8];
#pragma unroll
        for (int r = 0; r < 8; ++r) cv[r] = Cs[(ty + 16 * r) * (NT + 1) + n];
#pragma unroll
        for (int cc = 0; cc < 8; ++cc)
          bv[cc] = Bs[(tx + 16 * cc) * (NT + 1) + n];
#pragma unroll
        for (int r = 0; r < 8; ++r)
#pragma unroll
          for (int cc = 0; cc < 8; ++cc)
            acc[r][cc] = fmaf(cv[r], bv[cc], acc[r][cc]);
      }
    }
    float* cbo = p.cb + ((static_cast<int64_t>(b) * p.nc + c) * p.G + g) *
                            Q * Q;
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int cc = 0; cc < 8; ++cc)
        cbo[(ty + 16 * r) * Q + tx + 16 * cc] = acc[r][cc];
    return;
  }

  // ---- head h
  const int h = blockIdx.y;
  const int g = h / (p.H / p.G);
  float* eys = smem;                  // [Q][64] e_i dy_i
  float* Ct = eys + Q * 64;           // [Q][64] a C tile
  double* wsum = reinterpret_cast<double*>(Ct + Q * 64);
  float* es = reinterpret_cast<float*>(wsum + 4);   // [Q]
  const int64_t bch = (static_cast<int64_t>(b) * p.nc + c) * p.H + h;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  double v = 0.0;
  if (tid < Q) {
    if (tid < rows)
      v = log(static_cast<double>(
          fmaxf(p.a[(tok0 + tid) * p.H + h], 1e-37f)));
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const double u = __shfl_up_sync(0xffffffffu, v, off);
      if (lane >= off) v += u;
    }
    if (lane == 31) wsum[warp] = v;
  }
  __syncthreads();
  if (tid < Q) {
    double total = 0.0;
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      if (w < warp) v += wsum[w];
      total += wsum[w];
    }
    p.ca[bch * Q + tid] = v;
    const float e_i = static_cast<float>(exp(v));
    es[tid] = e_i;
    p.ew[bch * 2 * Q + tid] = e_i;
    p.ew[bch * 2 * Q + Q + tid] = static_cast<float>(exp(total - v));
    if (tid == 0) p.dA[bch] = static_cast<float>(exp(total));
  }
  __syncthreads();
  // e o dy, rows past L and columns past P zero
  const TX* dyp = static_cast<const TX*>(p.dy);
  const int64_t xs = static_cast<int64_t>(p.H) * p.P;
  for (int idx = tid; idx < Q * 64; idx += THREADS) {
    const int r = idx >> 6;
    const int pp = idx & 63;
    eys[idx] = (r < rows && pp < p.P)
                   ? es[r] * to_f(dyp[(tok0 + r) * xs +
                                      static_cast<int64_t>(h) * p.P + pp])
                   : 0.f;
  }
  float* dso = p.ds + bch * p.P * p.N;
  for (int n0 = 0; n0 < p.N; n0 += 64) {
    __syncthreads();
    for (int idx = tid; idx < Q * 64; idx += THREADS) {
      const int r = idx >> 6;
      const int n = idx & 63;
      Ct[idx] = (r < rows && n0 + n < p.N)
                    ? to_f(Cm[(tok0 + r) * p.G * p.N +
                              static_cast<int64_t>(g) * p.N + n0 + n])
                    : 0.f;
    }
    __syncthreads();
    // [P][64] = sum_i eys[i][p] Ct[i][n]: rows p = ty + 16 r, cols tx + 16 c
    float acc[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) acc[r][cc] = 0.f;
#pragma unroll 4
    for (int i = 0; i < Q; ++i) {
      float ev[4], cv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) ev[r] = eys[i * 64 + ty + 16 * r];
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) cv[cc] = Ct[i * 64 + tx + 16 * cc];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int cc = 0; cc < 4; ++cc)
          acc[r][cc] = fmaf(ev[r], cv[cc], acc[r][cc]);
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int pp = ty + 16 * r;
      if (pp >= p.P) continue;
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        const int n = n0 + tx + 16 * cc;
        if (n < p.N) dso[static_cast<int64_t>(pp) * p.N + n] = acc[r][cc];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// 2. the reverse pass over the chunks, in place: local gradients -> dS

__global__ void __launch_bounds__(256) bwd_state_pass_kernel(const Params p) {
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
    float4* slot = reinterpret_cast<float4*>(p.ds + bch * pn + e);
    const float4 cur = *slot;
    const float d = p.dA[bch];
    *slot = D;
    D.x = fmaf(d, D.x, cur.x);
    D.y = fmaf(d, D.y, cur.y);
    D.z = fmaf(d, D.z, cur.z);
    D.w = fmaf(d, D.w, cur.w);
  }
}

// ---------------------------------------------------------------------------
// 3. per head: dx, (dy x^T) o D, da

__host__ __device__ constexpr int head_smem_bytes() {
  // x and dy tiles [Q][LDP], M and G [Q][LDQ] (the streamed tiles of the
  // N products live in M's and G's room first); ca [Q] double; e, w, u,
  // v, R, U, V [Q] and a reduction row [THREADS] in float
  return (2 * Q * LDP + 2 * Q * LDQ) * 4 + Q * 8 + (7 * Q + THREADS) * 4;
}

template <typename TX, typename TB, typename TS>
__global__ void __launch_bounds__(THREADS, 1) bwd_head_kernel(const Params p) {
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;                  // [Q][LDP]
  float* dys = xs + Q * LDP;         // [Q][LDP]
  float* sM = dys + Q * LDP;         // [Q][LDQ]
  float* sG = sM + Q * LDQ;          // [Q][LDQ]
  double* cad = reinterpret_cast<double*>(sG + Q * LDQ);   // [Q]
  float* es = reinterpret_cast<float*>(cad + Q);
  float* wsv = es + Q;
  float* us = wsv + Q;
  float* vs = us + Q;
  float* Rs = vs + Q;
  float* Us = Rs + Q;
  float* Vs = Us + Q;
  float* red = Vs + Q;               // [THREADS]
  // streamed tiles of step A, in sM's and sG's room
  float* Bt = sM;                    // [Q][NT + 1]
  float* Ct = Bt + Q * (NT + 1);     // [Q][NT + 1]
  float* dSt = Ct + Q * (NT + 1);    // [PMAX][NT + 1]
  float* Spt = dSt + PMAX * (NT + 1);   // [PMAX][NT + 1]

  const int c = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int g = h / (p.H / p.G);
  const int tid = threadIdx.x;
  const int ty = tid >> 4;
  const int tx = tid & 15;
  const int t0 = c * Q;
  const int rows = min(Q, p.L - t0);
  const int64_t tok0 = static_cast<int64_t>(b) * p.L + t0;
  const int64_t xstr = static_cast<int64_t>(p.H) * p.P;
  const int64_t bch = (static_cast<int64_t>(b) * p.nc + c) * p.H + h;
  const TX* xp = static_cast<const TX*>(p.x);
  const TX* dyp = static_cast<const TX*>(p.dy);
  const TB* Bm = static_cast<const TB*>(p.B);
  const TB* Cm = static_cast<const TB*>(p.C);
  const TS* spp = static_cast<const TS*>(p.sp);
  const bool has_prev = c > 0;

  // ---- load x, dy (zero past L and P), ca, e, w
  for (int idx = tid; idx < Q * LDP; idx += THREADS) {
    const int r = idx / LDP;
    const int pp = idx - r * LDP;
    const bool in = r < rows && pp < p.P;
    const int64_t off = (tok0 + r) * xstr + static_cast<int64_t>(h) * p.P + pp;
    xs[idx] = in ? to_f(xp[off]) : 0.f;
    dys[idx] = in ? to_f(dyp[off]) : 0.f;
  }
  if (tid < Q) {
    cad[tid] = p.ca[bch * Q + tid];
    es[tid] = p.ew[bch * 2 * Q + tid];
    wsv[tid] = p.ew[bch * 2 * Q + Q + tid];
  }

  // ---- A. B dS^T and C S_prev^T [Q][P] over N in tiles of NT; <dS, S_prev>
  //      rows j = ty + 16 r, columns p = tx + 16 q
  float bds[8][4], cs[8][4];
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int q = 0; q < 4; ++q) bds[r][q] = cs[r][q] = 0.f;
  float zpart = 0.f;
  const float* dsh = p.ds + bch * p.P * p.N;
  const TS* sph = spp + bch * p.P * p.N;
  for (int n0 = 0; n0 < p.N; n0 += NT) {
    __syncthreads();
    for (int idx = tid; idx < Q * NT; idx += THREADS) {
      const int r = idx / NT;
      const int n = idx - r * NT;
      const bool in = r < rows && n0 + n < p.N;
      const int64_t off = (tok0 + r) * p.G * p.N +
                          static_cast<int64_t>(g) * p.N + n0 + n;
      Bt[r * (NT + 1) + n] = in ? to_f(Bm[off]) : 0.f;
      Ct[r * (NT + 1) + n] = in ? to_f(Cm[off]) : 0.f;
    }
    for (int idx = tid; idx < PMAX * NT; idx += THREADS) {
      const int r = idx / NT;
      const int n = idx - r * NT;
      const bool in = r < p.P && n0 + n < p.N;
      const int64_t off = static_cast<int64_t>(r) * p.N + n0 + n;
      const float dv = in ? dsh[off] : 0.f;
      const float sv = (in && has_prev) ? to_f(sph[off]) : 0.f;
      dSt[r * (NT + 1) + n] = dv;
      Spt[r * (NT + 1) + n] = sv;
      zpart = fmaf(dv, sv, zpart);
    }
    __syncthreads();
#pragma unroll 2
    for (int n = 0; n < NT; ++n) {
      float dv[4], sv[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        dv[q] = dSt[(tx + 16 * q) * (NT + 1) + n];
        sv[q] = Spt[(tx + 16 * q) * (NT + 1) + n];
      }
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const float bv = Bt[(ty + 16 * r) * (NT + 1) + n];
        const float cv = Ct[(ty + 16 * r) * (NT + 1) + n];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          bds[r][q] = fmaf(bv, dv[q], bds[r][q]);
          cs[r][q] = fmaf(cv, sv[q], cs[r][q]);
        }
      }
    }
  }
  // u_i = e_i dy_i . (C S_prev^T)_i, v_j = w_j x_j . (B dS^T)_j: partial
  // sums over the thread's columns, then over the 16 tx lanes
  float dxa[8][4];
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int i = ty + 16 * r;
    float uu = 0.f, vv = 0.f;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int pp = tx + 16 * q;
      uu = fmaf(dys[i * LDP + pp], cs[r][q], uu);
      vv = fmaf(xs[i * LDP + pp], bds[r][q], vv);
      dxa[r][q] = wsv[i] * bds[r][q];
    }
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) {
      uu += __shfl_xor_sync(0xffffffffu, uu, off);
      vv += __shfl_xor_sync(0xffffffffu, vv, off);
    }
    if (tx == 0) {
      us[i] = es[i] * uu;
      vs[i] = wsv[i] * vv;
    }
  }
  red[tid] = zpart;
  __syncthreads();   // the streamed tiles are read: M's and G's room free

  // ---- B. M and G = (dy x^T) o M in shared memory, (dy x^T) o D out:
  //      rows i = ty + 16 r, columns j = tx + 16 q (blocks q <= r only:
  //      the rest is above the diagonal)
  {
    float acc[8][8];
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int q = 0; q < 8; ++q) acc[r][q] = 0.f;
    for (int pp = 0; pp < PMAX; pp += 4) {
      float4 dv[8], xv[8];
#pragma unroll
      for (int r = 0; r < 8; ++r)
        dv[r] = *reinterpret_cast<const float4*>(
            &dys[(ty + 16 * r) * LDP + pp]);
#pragma unroll
      for (int q = 0; q < 8; ++q)
        xv[q] = *reinterpret_cast<const float4*>(
            &xs[(tx + 16 * q) * LDP + pp]);
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          if (q > r) continue;
          acc[r][q] = fmaf(dv[r].x, xv[q].x, acc[r][q]);
          acc[r][q] = fmaf(dv[r].y, xv[q].y, acc[r][q]);
          acc[r][q] = fmaf(dv[r].z, xv[q].z, acc[r][q]);
          acc[r][q] = fmaf(dv[r].w, xv[q].w, acc[r][q]);
        }
    }
    const float* cbp = p.cb + ((static_cast<int64_t>(b) * p.nc + c) * p.G +
                               g) * Q * Q;
    float* dco = p.dcbh + bch * Q * Q;
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int i = ty + 16 * r;
      const double ci = cad[i];
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const int j = tx + 16 * q;
        float m = 0.f, gg = 0.f, dd = 0.f;
        if (q <= r && j <= i) {
          const float d = expf(static_cast<float>(ci - cad[j]));
          m = cbp[i * Q + j] * d;
          gg = acc[r][q] * m;
          dd = acc[r][q] * d;
        }
        sM[i * LDQ + j] = m;
        sG[i * LDQ + j] = gg;
        dco[i * Q + j] = dd;
      }
    }
  }
  __syncthreads();

  // ---- C. dx = w o (B dS^T) + M^T dy: rows j = ty + 16 r, columns p
  {
#pragma unroll 2
    for (int i = ty; i < Q; ++i) {
      float dv[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) dv[q] = dys[i * LDP + tx + 16 * q];
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const float m = sM[i * LDQ + ty + 16 * r];
#pragma unroll
        for (int q = 0; q < 4; ++q) dxa[r][q] = fmaf(m, dv[q], dxa[r][q]);
      }
    }
    TX* dxp = static_cast<TX*>(p.dx);
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int j = ty + 16 * r;
      if (j >= rows) continue;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int pp = tx + 16 * q;
        if (pp < p.P)
          dxp[(tok0 + j) * xstr + static_cast<int64_t>(h) * p.P + pp] =
              from_f<TX>(dxa[r][q]);
      }
    }
  }

  // ---- D. d log a: row i's exclusive prefix sums of G (thread i), then
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
    for (int k = 0; k < THREADS; ++k) s += red[k];
    red[0] = s;   // read after the barrier below; no thread reads red[k > 0]
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

__global__ void __launch_bounds__(256) bwd_dcb_sum_kernel(const Params p) {
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
// 5. dC and dB: a 64-row, 64-column tile of each a CTA

constexpr int RT = 64;   // rows a tile
constexpr int KT = 32;   // chunk rows a streamed tile

__host__ __device__ constexpr int group_smem_bytes() {
  // step A: dcb rows [RT][KT + 1], B tile [KT][64], dcb columns [KT][RT],
  // C tile [KT][64]; step B (same room): e o dy [RT][PMAX + 1], S_prev
  // [PMAX][64], w o x [RT][PMAX + 1], dS [PMAX][64]
  return (2 * RT * (PMAX + 1) + 2 * PMAX * 64) * 4;
}

template <typename TX, typename TB, typename TS>
__global__ void __launch_bounds__(THREADS) bwd_group_kernel(const Params p) {
  extern __shared__ __align__(16) float smem[];
  const int c = blockIdx.x;
  const int b = blockIdx.z;
  const int n_nt = (p.N + 63) / 64;
  const int g = blockIdx.y / (2 * n_nt);
  const int rest = blockIdx.y - g * 2 * n_nt;
  const int r0 = (rest / n_nt) * RT;
  const int n0 = (rest % n_nt) * 64;
  const int tid = threadIdx.x;
  const int ty = tid >> 4;
  const int tx = tid & 15;
  const int t0 = c * Q;
  const int rows = min(Q, p.L - t0);
  const int64_t tok0 = static_cast<int64_t>(b) * p.L + t0;
  const int64_t bc = static_cast<int64_t>(b) * p.nc + c;
  const int hpg = p.H / p.G;
  const TB* Bm = static_cast<const TB*>(p.B);
  const TB* Cm = static_cast<const TB*>(p.C);
  const TX* xp = static_cast<const TX*>(p.x);
  const TX* dyp = static_cast<const TX*>(p.dy);
  const TS* spp = static_cast<const TS*>(p.sp);
  const float* dcbp = p.dcb + (bc * p.G + g) * Q * Q;
  const int64_t bstr = static_cast<int64_t>(p.G) * p.N;
  const int64_t xstr = static_cast<int64_t>(p.H) * p.P;

  // rows r0 + ty + 16 r, columns n0 + tx + 16 q
  float dc[4][4], db[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int q = 0; q < 4; ++q) dc[r][q] = db[r][q] = 0.f;

  // ---- A. (sum_h (dy x^T) o D) B and its transpose times C, over the
  //      chunk's rows in tiles of KT
  {
    float* sDc = smem;                 // [RT][KT + 1]: dcb[r0 + i][k0 + k]
    float* sB = sDc + RT * (KT + 1);   // [KT][64]
    float* sDb = sB + KT * 64;         // [KT][RT]: dcb[k0 + k][r0 + j]
    float* sC = sDb + KT * RT;         // [KT][64]
    for (int k0 = 0; k0 < Q; k0 += KT) {
      __syncthreads();
      for (int idx = tid; idx < RT * KT; idx += THREADS) {
        const int i = idx / KT;
        const int k = idx - i * KT;
        sDc[i * (KT + 1) + k] = dcbp[(r0 + i) * Q + k0 + k];
        const int kk = idx / RT;
        const int j = idx - kk * RT;
        sDb[kk * RT + j] = dcbp[(k0 + kk) * Q + r0 + j];
      }
      for (int idx = tid; idx < KT * 64; idx += THREADS) {
        const int k = idx >> 6;
        const int n = idx & 63;
        const bool in = k0 + k < rows && n0 + n < p.N;
        const int64_t off = (tok0 + k0 + k) * bstr +
                            static_cast<int64_t>(g) * p.N + n0 + n;
        sB[idx] = in ? to_f(Bm[off]) : 0.f;
        sC[idx] = in ? to_f(Cm[off]) : 0.f;
      }
      __syncthreads();
#pragma unroll 4
      for (int k = 0; k < KT; ++k) {
        float bv[4], cv[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          bv[q] = sB[k * 64 + tx + 16 * q];
          cv[q] = sC[k * 64 + tx + 16 * q];
        }
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float m = sDc[(ty + 16 * r) * (KT + 1) + k];
          const float mt = sDb[k * RT + ty + 16 * r];
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            dc[r][q] = fmaf(m, bv[q], dc[r][q]);
            db[r][q] = fmaf(mt, cv[q], db[r][q]);
          }
        }
      }
    }
  }

  // ---- B. + sum_h (e o dy) S_prev and (w o x) dS, heads in ascending order
  {
    constexpr int LD = PMAX + 1;
    float* sEy = smem;                 // [RT][LD]
    float* sSp = sEy + RT * LD;        // [PMAX][64]
    float* sWx = sSp + PMAX * 64;      // [RT][LD]
    float* sDs = sWx + RT * LD;        // [PMAX][64]
    for (int k = 0; k < hpg; ++k) {
      const int h = g * hpg + k;
      const int64_t bch = bc * p.H + h;
      const float* ew = p.ew + bch * 2 * Q;
      __syncthreads();
      for (int idx = tid; idx < RT * PMAX; idx += THREADS) {
        const int i = idx / PMAX;
        const int pp = idx - i * PMAX;
        const int r = r0 + i;
        const bool in = r < rows && pp < p.P;
        const int64_t off = (tok0 + r) * xstr + static_cast<int64_t>(h) * p.P +
                            pp;
        sEy[i * LD + pp] = in ? ew[r] * to_f(dyp[off]) : 0.f;
        sWx[i * LD + pp] = in ? ew[Q + r] * to_f(xp[off]) : 0.f;
      }
      for (int idx = tid; idx < PMAX * 64; idx += THREADS) {
        const int pp = idx >> 6;
        const int n = idx & 63;
        const bool in = pp < p.P && n0 + n < p.N;
        const int64_t off = (bch * p.P + pp) * p.N + n0 + n;
        sSp[idx] = (in && c > 0) ? to_f(spp[off]) : 0.f;
        sDs[idx] = in ? p.ds[off] : 0.f;
      }
      __syncthreads();
#pragma unroll 4
      for (int pp = 0; pp < PMAX; ++pp) {
        float sv[4], dv[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          sv[q] = sSp[pp * 64 + tx + 16 * q];
          dv[q] = sDs[pp * 64 + tx + 16 * q];
        }
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float ey = sEy[(ty + 16 * r) * LD + pp];
          const float wx = sWx[(ty + 16 * r) * LD + pp];
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            dc[r][q] = fmaf(ey, sv[q], dc[r][q]);
            db[r][q] = fmaf(wx, dv[q], db[r][q]);
          }
        }
      }
    }
  }

  TB* dBp = static_cast<TB*>(p.dB);
  TB* dCp = static_cast<TB*>(p.dC);
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = r0 + ty + 16 * r;
    if (i >= rows) continue;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int n = n0 + tx + 16 * q;
      if (n >= p.N) continue;
      const int64_t off =
          (tok0 + i) * bstr + static_cast<int64_t>(g) * p.N + n;
      dCp[off] = from_f<TB>(dc[r][q]);
      dBp[off] = from_f<TB>(db[r][q]);
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
  const size_t sizes[7] = {bc * H * Q * 8,      bc * H * 2 * Q * 4,
                           bc * H * 4,          bc * G * Q * Q * 4,
                           bc * H * P * N * 4,  bc * H * Q * Q * 4,
                           bc * G * Q * Q * 4};
  size_t at = 0;
  for (int i = 0; i < 7; ++i) {
    off[i] = at;
    at += align256(sizes[i]);
  }
  return at;
}

template <typename TX, typename TB, typename TS>
int launch(const Params& p, cudaStream_t st) {
  auto k1 = bwd_chunk_kernel<TX, TB>;
  auto k3 = bwd_head_kernel<TX, TB, TS>;
  auto k5 = bwd_group_kernel<TX, TB, TS>;
  static const cudaError_t attr = [&] {
    cudaError_t e = cudaFuncSetAttribute(
        k1, cudaFuncAttributeMaxDynamicSharedMemorySize, chunk_smem_bytes());
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(k3, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               head_smem_bytes());
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(k5, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               group_smem_bytes());
    return e;
  }();
  if (attr != cudaSuccess) return static_cast<int>(attr);
  cudaError_t e;
  k1<<<dim3(p.nc, p.H + p.G, p.Bsz), THREADS, chunk_smem_bytes(), st>>>(p);
  if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
  const int64_t n4 = static_cast<int64_t>(p.Bsz) * p.H * p.P * p.N / 4;
  bwd_state_pass_kernel<<<static_cast<unsigned>((n4 + 255) / 256), 256, 0,
                          st>>>(p);
  if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
  k3<<<dim3(p.nc, p.H, p.Bsz), THREADS, head_smem_bytes(), st>>>(p);
  if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
  const int64_t m4 = static_cast<int64_t>(p.Bsz) * p.nc * p.G * Q * Q / 4;
  bwd_dcb_sum_kernel<<<static_cast<unsigned>((m4 + 255) / 256), 256, 0, st>>>(
      p);
  if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
  k5<<<dim3(p.nc, p.G * 2 * ((p.N + 63) / 64), p.Bsz), THREADS,
       group_smem_bytes(), st>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Bytes of scratch ssd_scan_bwd_launch needs.
extern "C" long long ssd_scan_bwd_workspace_bytes(int Bsz, int L, int H, int P,
                                                  int G, int N) {
  size_t off[7];
  return static_cast<long long>(carve(Bsz, L, H, P, G, N, off));
}

// Plain C entry point (loaded with ctypes).  x, dy, dx [Bsz, L, H, P] (x's
// type), a, da [Bsz, L, H] float32, B, C, dB, dC [Bsz, L, G, N] (one type),
// d_state [Bsz, H, P, N] float32 or null, s_prev [Bsz, nc, H, P, N]
// (bf16 when sp_bf16, else float32), all contiguous; `work` 256-byte
// aligned, of ssd_scan_bwd_workspace_bytes.  Launches five kernels on
// `stream`, does not synchronise, allocates nothing.  Returns
// cudaGetLastError() of the launches (or of the shared-memory attribute),
// or cudaErrorInvalidValue for an unsupported shape or type combination.
extern "C" int ssd_scan_bwd_launch(int x_bf16, int bc_bf16, int sp_bf16,
                                   const void* x, const void* a, const void* B,
                                   const void* C, const void* dy,
                                   const void* d_state, const void* s_prev,
                                   void* dx, void* da, void* dB, void* dC,
                                   void* work, int Bsz, int L, int H, int P,
                                   int G, int N, void* stream) {
  if (Bsz <= 0 || H <= 0 || P <= 0 || L <= 0) return 0;
  if (G <= 0 || H % G != 0 || N <= 0 || N > 256 || N % 4 != 0 || P > PMAX)
    return static_cast<int>(cudaErrorInvalidValue);
  if (reinterpret_cast<uintptr_t>(work) % 256 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  size_t off[7];
  carve(Bsz, L, H, P, G, N, off);
  uint8_t* w = static_cast<uint8_t*>(work);
  Params p;
  p.x = x;
  p.a = static_cast<const float*>(a);
  p.B = B;
  p.C = C;
  p.dy = dy;
  p.dsf = static_cast<const float*>(d_state);
  p.sp = s_prev;
  p.dx = dx;
  p.da = static_cast<float*>(da);
  p.dB = dB;
  p.dC = dC;
  p.ca = reinterpret_cast<double*>(w + off[0]);
  p.ew = reinterpret_cast<float*>(w + off[1]);
  p.dA = reinterpret_cast<float*>(w + off[2]);
  p.cb = reinterpret_cast<float*>(w + off[3]);
  p.ds = reinterpret_cast<float*>(w + off[4]);
  p.dcbh = reinterpret_cast<float*>(w + off[5]);
  p.dcb = reinterpret_cast<float*>(w + off[6]);
  p.Bsz = Bsz;
  p.L = L;
  p.H = H;
  p.P = P;
  p.G = G;
  p.N = N;
  p.nc = (L + Q - 1) / Q;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  typedef __nv_bfloat16 bf;
  if (sp_bf16) {
    if (!x_bf16 || !bc_bf16) return static_cast<int>(cudaErrorInvalidValue);
    return launch<bf, bf, bf>(p, st);
  }
  if (x_bf16 && bc_bf16) return launch<bf, bf, float>(p, st);
  if (x_bf16) return launch<bf, float, float>(p, st);
  if (bc_bf16) return launch<float, bf, float>(p, st);
  return launch<float, float, float>(p, st);
}
