// Mamba2 SSD (state-space duality) chunked scan for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/ssd_scan/kernel.py
// (_ssd_kernel, launched by ssd_scan_headmajor).  The TPU version walks a
// grid (batch, head, chunk) whose chunk axis runs in order on one core and
// carries the [P, N] state in VMEM scratch, after its wrapper has
// broadcast the G groups of B and C to H heads and padded L to a chunk
// multiple (ops.py:20-33).  Blocks on a GPU run in no order, so here:
//
//   grid (ceil(P / PB), H, Bsz), 256 threads: a block owns PB = 16 columns
//   p of one (batch, head) and loops over the chunks of LC = 64 tokens
//   itself, keeping its [PB, N] slice of the state in registers (and a
//   copy in shared memory for the C . S product).  Rows p of the state and
//   columns p of y depend on column p of x only, so the P split needs no
//   communication; each block recomputes the chunk's C B^T.  At B = 1 a
//   mamba2 prefill (H = 48, P = 64) has 192 blocks for 132 SMs.
//   Head h reads group h / (H / G) of B and C in place: nothing is
//   broadcast or padded in memory.  The last chunk is masked instead
//   (a = 1, x = B = C = 0 past L, the reference's neutral padding), so the
//   final state is the state after exactly L tokens.
//
// Per chunk, with ca the inclusive prefix sum (a warp scan) of
// log(max(a, 1e-37)), kept in double:
//   M[i][j] = (C_i . B_j) exp(ca_i - ca_j)         for j <= i, else 0
//   y[i]    = sum_j M[i][j] x_j + exp(ca_i) (C_i . S)
//   S       = exp(ca_last) S + sum_j exp(ca_last - ca_j) x_j (outer) B_j
// The exponential of ca_i - ca_j is evaluated only for j <= i, where it is
// at most 1 (a <= 1): for j > i it could overflow, and a masked product
// inf * 0 would give NaN.  exp(ca) may underflow to 0 over a chunk of
// strong decay, which is the right value.  ca is a double: over a chunk of
// strong decay it reaches tens, and a float32 difference ca_i - ca_j
// would then carry an error of ulp(ca) ~ 4e-6 even for neighbouring tokens,
// whose terms dominate y, where the sequential recurrence is exact to
// about 1e-7; in double each difference is as exact as its own segment.
//
// Types: x, B and C float32 or bf16 (B and C of one type), a float32;
// converted to float32 on load, float32 accumulation, y written in x's
// dtype, the state in float32.  N <= 256 and a multiple of 4.
//
// Bound on an H100: per head and chunk four products of about
// 2 LC P N flops (C B^T, M x, C S^T, the state update), about 5.6 GFLOP
// for a 2000-token mamba2 prefill, against about 28 MB moved (x and y,
// B and C once, the state): 0.084 ms at the 67 TFLOP/s float32 rate, 0.006
// ms at the bf16 tensor-core rate, 0.008 ms at 3.35 TB/s.  This kernel
// does float32 FMAs on the CUDA cores from shared memory (register tiles
// of 4 x 4 for C B^T, 128-bit shared loads); the redundant C B^T of the P
// split is about half its work.  It serves float32 and mixed operands;
// bf16 x, B and C (the models') go to the tensor-core kernel,
// ssd_scan_tc.cu.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int LC = 64;          // tokens a chunk
constexpr int SQ = 128;         // tokens a chunk of the saved states
constexpr int PB = 16;          // state rows (head columns p) a block
constexpr int THREADS = 256;    // a 16 x 16 grid of (ty, tx)

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

// shared memory: ca [LC] and two warp totals in double, then floats: B and
// C tiles [LC][N + 4], the state copy [PB][N + 4], scores [LC][LC + 1],
// x tile [LC][PB], exp(ca) and exp(ca_last - ca) [LC] each
__host__ __device__ constexpr int smem_bytes(int N) {
  return static_cast<int>(sizeof(double)) * (LC + 2) +
         static_cast<int>(sizeof(float)) *
             (2 * LC * (N + 4) + PB * (N + 4) + LC * (LC + 1) + LC * PB +
              2 * LC);
}

// SPT: state entries a thread owns, PB * N / THREADS rounded up (8 or 16)
template <int SPT, typename TX, typename TB>
__global__ void __launch_bounds__(THREADS) ssd_scan_kernel(
    const TX* __restrict__ x, const float* __restrict__ a,
    const TB* __restrict__ Bm, const TB* __restrict__ Cm, TX* __restrict__ y,
    float* __restrict__ state, float* __restrict__ sprev, int L, int H,
    int P, int G, int N) {
  extern __shared__ __align__(16) double smem_d[];
  double* ca = smem_d;              // [LC]
  double* wsum = ca + LC;           // [2]
  const int ld = N + 4;
  float* Bs = reinterpret_cast<float*>(wsum + 2);   // [LC][ld]
  float* Cs = Bs + LC * ld;         // [LC][ld]
  float* Ss = Cs + LC * ld;         // [PB][ld]
  float* Ms = Ss + PB * ld;         // [LC][LC + 1]
  float* xs = Ms + LC * (LC + 1);   // [LC][PB]
  float* eca = xs + LC * PB;        // [LC] exp(ca_i)
  float* dl = eca + LC;             // [LC] exp(ca_last - ca_j)

  const int p0 = blockIdx.x * PB;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int g = h / (H / G);
  const int tid = threadIdx.x;
  const int ty = tid >> 4;
  const int tx = tid & 15;
  const int lane = tid & 31;

  // this thread's state entries: flat index tid + THREADS k of [PB][N],
  // row s_row[k] (-1: none) and column s_col[k]
  float s_reg[SPT];
  int s_row[SPT], s_col[SPT];
#pragma unroll
  for (int k = 0; k < SPT; ++k) {
    const int idx = tid + THREADS * k;
    s_reg[k] = 0.f;
    s_row[k] = idx < PB * N ? idx / N : -1;
    s_col[k] = idx - (idx / N) * N;
  }
  for (int idx = tid; idx < PB * ld; idx += THREADS) Ss[idx] = 0.f;

  const int64_t row_x = static_cast<int64_t>(H) * P;   // x, y: per token
  const int64_t row_bc = static_cast<int64_t>(G) * N;  // B, C: per token
  const TX* xb = x + static_cast<int64_t>(b) * L * row_x + h * P;
  TX* yb = y + static_cast<int64_t>(b) * L * row_x + h * P;
  const TB* Bb = Bm + static_cast<int64_t>(b) * L * row_bc + g * N;
  const TB* Cb = Cm + static_cast<int64_t>(b) * L * row_bc + g * N;
  const float* ab = a + static_cast<int64_t>(b) * L * H + h;

  for (int t0 = 0; t0 < L; t0 += LC) {
    const int rows = min(LC, L - t0);
    if (sprev != nullptr && t0 > 0 && t0 % SQ == 0) {
      // training: the state entering each chunk of SQ tokens (after t0)
      const int nc = (L + SQ - 1) / SQ;
      float* o = sprev + ((static_cast<int64_t>(b) * nc + t0 / SQ) * H + h) *
                             P * N;
#pragma unroll
      for (int k = 0; k < SPT; ++k) {
        const int p = p0 + s_row[k];
        if (s_row[k] >= 0 && p < P)
          o[static_cast<int64_t>(p) * N + s_col[k]] = s_reg[k];
      }
    }
    __syncthreads();   // the previous chunk's tiles are no longer read

    // ---- load the chunk (rows past L: the neutral a = 1, x = B = C = 0)
    for (int idx = tid; idx < LC * N; idx += THREADS) {
      const int r = idx / N;
      const int n = idx - r * N;
      const bool in = r < rows;
      const int64_t off = (t0 + r) * row_bc + n;
      Bs[r * ld + n] = in ? to_f(Bb[off]) : 0.f;
      Cs[r * ld + n] = in ? to_f(Cb[off]) : 0.f;
    }
    for (int idx = tid; idx < LC * PB; idx += THREADS) {
      const int r = idx / PB;
      const int c = idx - r * PB;
      const int p = p0 + c;
      xs[idx] = (r < rows && p < P) ? to_f(xb[(t0 + r) * row_x + p]) : 0.f;
    }
    double v = 0.0;    // log decay of row tid (tid < LC)
    if (tid < LC && tid < rows)
      v = log(static_cast<double>(
          fmaxf(ab[static_cast<int64_t>(t0 + tid) * H], 1e-37f)));

    // ---- ca: inclusive prefix sum over the chunk (warps 0 and 1)
    if (tid < LC) {
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const double u = __shfl_up_sync(0xffffffffu, v, off);
        if (lane >= off) v += u;
      }
      if (lane == 31) wsum[tid >> 5] = v;
    }
    __syncthreads();
    if (tid < LC) {
      if (tid >= 32) v += wsum[0];
      ca[tid] = v;
    }
    __syncthreads();
    if (tid < LC) {
      eca[tid] = static_cast<float>(exp(v));
      dl[tid] = static_cast<float>(exp(ca[LC - 1] - v));
    }

    // ---- M = mask(C B^T o exp(ca_i - ca_j)): rows ty + 16 r, cols tx + 16 c
    {
      float acc[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;
      for (int n = 0; n < N; n += 4) {
        float4 cv[4], bv[4];
#pragma unroll
        for (int r = 0; r < 4; ++r)
          cv[r] = *reinterpret_cast<const float4*>(
              &Cs[(ty + 16 * r) * ld + n]);
#pragma unroll
        for (int c = 0; c < 4; ++c)
          bv[c] = *reinterpret_cast<const float4*>(
              &Bs[(tx + 16 * c) * ld + n]);
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            acc[r][c] = fmaf(cv[r].x, bv[c].x, acc[r][c]);
            acc[r][c] = fmaf(cv[r].y, bv[c].y, acc[r][c]);
            acc[r][c] = fmaf(cv[r].z, bv[c].z, acc[r][c]);
            acc[r][c] = fmaf(cv[r].w, bv[c].w, acc[r][c]);
          }
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = ty + 16 * r;
        const double ci = ca[i];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int j = tx + 16 * c;
          const float arg = static_cast<float>(ci - ca[j]);
          Ms[i * (LC + 1) + j] = j <= i ? acc[r][c] * expf(arg) : 0.f;
        }
      }
    }
    __syncthreads();

    // ---- y[i][p] = sum_j M[i][j] x[j][p] + exp(ca_i) C_i . S_p:
    //      rows ty + 16 r, column p = tx
    {
      float yi[4] = {0.f, 0.f, 0.f, 0.f};
      const int i_last = ty + 48;   // the thread's last row
      for (int j = 0; j <= i_last; ++j) {
        const float xv = xs[j * PB + tx];
#pragma unroll
        for (int r = 0; r < 4; ++r)
          yi[r] = fmaf(Ms[(ty + 16 * r) * (LC + 1) + j], xv, yi[r]);
      }
      float ys[4] = {0.f, 0.f, 0.f, 0.f};
      for (int n = 0; n < N; n += 4) {
        const float4 sv = *reinterpret_cast<const float4*>(&Ss[tx * ld + n]);
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float4 cv =
              *reinterpret_cast<const float4*>(&Cs[(ty + 16 * r) * ld + n]);
          ys[r] = fmaf(cv.x, sv.x, ys[r]);
          ys[r] = fmaf(cv.y, sv.y, ys[r]);
          ys[r] = fmaf(cv.z, sv.z, ys[r]);
          ys[r] = fmaf(cv.w, sv.w, ys[r]);
        }
      }
      const int p = p0 + tx;
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = ty + 16 * r;
        if (i < rows && p < P)
          yb[(t0 + i) * row_x + p] = from_f<TX>(fmaf(eca[i], ys[r], yi[r]));
      }
    }
    __syncthreads();   // every read of the old state copy is done

    // ---- S = exp(ca_last) S + sum_j exp(ca_last - ca_j) x_j (outer) B_j
    {
      const float e_last = eca[LC - 1];
#pragma unroll
      for (int k = 0; k < SPT; ++k) s_reg[k] *= e_last;
      for (int j = 0; j < rows; ++j) {
        const float dj = dl[j];
#pragma unroll
        for (int k = 0; k < SPT; ++k)
          if (s_row[k] >= 0)
            s_reg[k] = fmaf(dj * Bs[j * ld + s_col[k]], xs[j * PB + s_row[k]],
                            s_reg[k]);
      }
#pragma unroll
      for (int k = 0; k < SPT; ++k)
        if (s_row[k] >= 0) Ss[s_row[k] * ld + s_col[k]] = s_reg[k];
    }
  }

  // ---- the final state [Bsz, H, P, N]
  float* sb = state + (static_cast<int64_t>(b) * H + h) * P * N;
#pragma unroll
  for (int k = 0; k < SPT; ++k) {
    const int p = p0 + s_row[k];
    if (s_row[k] >= 0 && p < P)
      sb[static_cast<int64_t>(p) * N + s_col[k]] = s_reg[k];
  }
}

template <int SPT, typename TX, typename TB>
int launch(const void* x, const float* a, const void* B, const void* C,
           void* y, float* state, float* sprev, int Bsz, int L, int H, int P,
           int G, int N, cudaStream_t stream) {
  auto kern = ssd_scan_kernel<SPT, TX, TB>;
  const int bytes = smem_bytes(N);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((P + PB - 1) / PB, H, Bsz);
  kern<<<grid, THREADS, bytes, stream>>>(
      static_cast<const TX*>(x), a, static_cast<const TB*>(B),
      static_cast<const TB*>(C), static_cast<TX*>(y), state, sprev, L, H, P,
      G, N);
  return static_cast<int>(cudaGetLastError());
}

template <typename TX, typename TB>
int dispatch_n(const void* x, const float* a, const void* B, const void* C,
               void* y, float* state, float* sprev, int Bsz, int L, int H,
               int P, int G, int N, cudaStream_t st) {
  if (N <= 128)
    return launch<8, TX, TB>(x, a, B, C, y, state, sprev, Bsz, L, H, P, G, N,
                             st);
  return launch<16, TX, TB>(x, a, B, C, y, state, sprev, Bsz, L, H, P, G, N,
                            st);
}

}  // namespace

// Plain C entry point (loaded with ctypes).  x [Bsz, L, H, P] (float32 or
// bf16), a [Bsz, L, H] float32, B / C [Bsz, L, G, N] (float32 or bf16),
// y [Bsz, L, H, P] in x's dtype, state [Bsz, H, P, N] float32, all
// contiguous; sprev null, or (training) [Bsz, ceil(L / 128), H, P, N]
// float32 for the state entering each chunk of 128 tokens (chunk 0's
// left unwritten), which ssd_scan_bwd.cu reads.  Launches on `stream`,
// does not synchronise, allocates nothing.  Returns cudaGetLastError() of
// the launch (or of the shared-memory attribute), or
// cudaErrorInvalidValue for an unsupported shape.
extern "C" int ssd_scan_launch(int x_bf16, int bc_bf16, const void* x,
                               const void* a, const void* B, const void* C,
                               void* y, void* state, void* sprev, int Bsz,
                               int L, int H, int P, int G, int N,
                               void* stream) {
  if (Bsz <= 0 || H <= 0 || P <= 0) return 0;
  if (L < 0 || G <= 0 || H % G != 0 || N <= 0 || N > 256 || N % 4 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* af = static_cast<const float*>(a);
  float* sf = static_cast<float*>(state);
  float* spf = static_cast<float*>(sprev);
  typedef __nv_bfloat16 bf;
  if (x_bf16) {
    if (bc_bf16)
      return dispatch_n<bf, bf>(x, af, B, C, y, sf, spf, Bsz, L, H, P, G, N,
                                st);
    return dispatch_n<bf, float>(x, af, B, C, y, sf, spf, Bsz, L, H, P, G, N,
                                 st);
  }
  if (bc_bf16)
    return dispatch_n<float, bf>(x, af, B, C, y, sf, spf, Bsz, L, H, P, G, N,
                                 st);
  return dispatch_n<float, float>(x, af, B, C, y, sf, spf, Bsz, L, H, P, G, N,
                                  st);
}
