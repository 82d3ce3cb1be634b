// Token-bucket shaper step for Hopper (sm_90a): refill, then admission.
//
// Replaces the Pallas TPU kernel src/repro/kernels/token_bucket/kernel.py
// (_tb_kernel, launched by token_bucket_step_2d).  The TPU version tiles
// flows into (8, 128) int32 VMEM blocks and reads the elapsed cycles from
// SMEM; here the work is one flat elementwise pass, one thread per flow,
// over any number of flows, with a per-flow elapsed count (software
// shaping defers refills per lane) or a broadcast one (stride 0).
//
// Per flow, in int32 exactly as jnp computes it:
//   total = cyc + E;  k = total // interval;  cyc' = total % interval
//   k = min(k, bkt // max(refill, 1) + 1)
//   tokens' = min(tokens + k * refill, bkt)
//   admission (when want != null): cost = mode == GBPS ? cost : 1;
//   ok = want & tokens' >= cost; an admitted flow pays the cost.
// `//` and `%` are floor division and modulo (C++ truncates toward zero),
// and every add and multiply wraps in two's complement: it is done in
// uint32 and cast back, because the unshaped profiling registers
// (refill = bkt = 2^30, interval 1) overflow on their first refill, which
// is undefined behaviour in signed int.
//
// Bound on an H100: at most 33 B read and 9 B written per flow (eight
// int32 inputs incl. a per-flow elapsed count and the cost, a bool want;
// tokens, cyc and a bool admit out) against a dozen integer operations, so
// it is bound by bytes at large N.
// At the slice's shapes (N = 2..3 flows, launched 1 + k_grant times per
// simulated tick) it is bound by launch latency, several microseconds
// against nanoseconds of work.  The design does nothing about that yet:
// fusing the tick, or capturing it in a CUDA graph, is later work.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ int wrap_add(int a, int b) {
  return static_cast<int>(static_cast<uint32_t>(a) + static_cast<uint32_t>(b));
}

__device__ __forceinline__ int wrap_mul(int a, int b) {
  return static_cast<int>(static_cast<uint32_t>(a) * static_cast<uint32_t>(b));
}

// floor division / modulo for b > 0 or b < 0 (never 0 here: both divisors
// are floored at 1), matching jnp's `//` and `%` on int32
__device__ __forceinline__ int floor_div(int a, int b) {
  int q = a / b;
  int r = a % b;
  return (r != 0 && ((r < 0) != (b < 0))) ? q - 1 : q;
}

__device__ __forceinline__ int floor_mod(int a, int b) {
  int r = a % b;
  return (r != 0 && ((r < 0) != (b < 0))) ? r + b : r;
}

__global__ void tb_step_kernel(int n, const int* __restrict__ tokens,
                               const int* __restrict__ cyc,
                               const int* __restrict__ refill,
                               const int* __restrict__ bkt,
                               const int* __restrict__ interval,
                               const int* __restrict__ mode,
                               const int* __restrict__ elapsed, int e_stride,
                               const int* __restrict__ cost,
                               const bool* __restrict__ want,
                               int* tokens_out, int* cyc_out,
                               bool* admit_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int iv = max(interval[i], 1);
  const int b = bkt[i];
  const int r = refill[i];
  const int total = wrap_add(cyc[i], elapsed[static_cast<int64_t>(i) * e_stride]);
  int k = floor_div(total, iv);
  const int new_cyc = floor_mod(total, iv);
  k = min(k, wrap_add(floor_div(b, max(r, 1)), 1));
  int tok = min(wrap_add(tokens[i], wrap_mul(k, r)), b);
  bool ok = false;
  if (want != nullptr && want[i]) {
    const int c = (mode[i] == 0) ? cost[i] : 1;
    ok = tok >= c;
    if (ok) tok = wrap_add(tok, -c);
  }
  tokens_out[i] = tok;
  cyc_out[i] = new_cyc;
  if (admit_out != nullptr) admit_out[i] = ok;
}

}  // namespace

// Plain C entry point (loaded with ctypes).  Launches on `stream`, does not
// synchronise, allocates nothing; returns cudaGetLastError() of the launch.
// `want` and `cost` may be null (refill only); `admit_out` may be null.
// Outputs may alias the tokens / cyc inputs (each thread reads its element
// before it writes it).
extern "C" int tb_step_launch(int n, const int* tokens, const int* cyc,
                              const int* refill, const int* bkt,
                              const int* interval, const int* mode,
                              const int* elapsed, int e_stride,
                              const int* cost, const bool* want,
                              int* tokens_out, int* cyc_out, bool* admit_out,
                              void* stream) {
  if (n <= 0) return 0;
  const int threads = 128;
  const int blocks = (n + threads - 1) / threads;
  tb_step_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      n, tokens, cyc, refill, bkt, interval, mode, elapsed, e_stride, cost,
      want, tokens_out, cyc_out, admit_out);
  return static_cast<int>(cudaGetLastError());
}
