// Token-bucket shaper for Hopper (sm_90a): two kernels.
//
// Both replace the Pallas TPU kernel src/repro/kernels/token_bucket/kernel.py
// (_tb_kernel, launched by token_bucket_step_2d), which refills every flow's
// bucket and decides every flow's admission in one launch.  The TPU version
// tiles flows into (8, 128) int32 VMEM blocks and reads the elapsed cycles
// from SMEM.
//
// 1. tb_step_kernel (tb_step_launch): that function as one flat elementwise
//    pass, one thread per flow, over any number of flows, with a per-flow
//    elapsed count (software shaping defers refills per lane) or a broadcast
//    one (stride 0).  The serving scheduler calls it once per round.
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
// it is bound by bytes at large N and by launch latency at a handful of
// flows.
//
// 2. tb_grant_tick_kernel (tb_grant_tick_launch): the dataplane tick's
//    stage 1 (every flow's token-bucket timers, the refill above, with the
//    software-shaping deferral and stall rule) and stage 4 (k_grant
//    sequential shaper + arbiter grants) in ONE launch a tick, where the
//    engine made 1 + k_grant launches and some hundred eager ops around
//    them.  Each grant iteration: every flow's eligibility and arbiter key,
//    a block-wide argmin, then the grant (tokens, queue pop, link budget,
//    credits, extra resource axes, accelerator-queue push, arbiter state,
//    admission counters).  Bitwise the plain version, ops.grant_tick_plain.
//
//    Resource axes (the link's R = 1..MAX_RES extra axes: device memory
//    bandwidth, host DMA, ...; engine._resource_tables): a flow is eligible
//    only while every axis it demands in either direction has a positive
//    budget, and a grant charges its ingress demand w_in[r, g] * size on
//    every axis as one fused multiply-add, as the compiled reference
//    contracts it.  Each thread holds its flows' demands and the R budgets
//    in registers (the budgets replicated, like the link's); the winner's
//    demands travel with its size through the argmin's shuffle or shared
//    slots.  R = 0 launches an instantiation with none of this compiled in.
//
// Design.  One CTA a batch element (one server's dataplane): the batched
// engine (run_window_batch, the reference's jax.vmap) launches a grid of B
// CTAs, each on its element's rows of every array, with the element's own
// shaping mode, arbiter, credits, overhead, active-flow mask and stall row;
// the serial engine launches the same kernel with B = 1.  Thread i owns flows
// i, i + T, ... (T threads, FPT <= 8 flows a thread, N <= 8192) and holds
// their state in registers for the whole tick: the bucket, queue head and
// count, vft, weight, priority, accelerator and ingress direction, its
// accelerator queue's head / count / bytes, the admission counters, and
// the next KPF queue entries from its head, so no grant waits on a
// dependent global load (a winner's next entry is loaded KPF - 1 grants
// before it can be needed).  The tick-wide scalars (the two link budgets,
// credits used, the RR pointer) are replicated in every thread's
// registers: every thread applies the same update from the broadcast
// winner.  The argmin is (key, index) lexicographic, so the lowest index
// wins a tie and, with no flow eligible, index 0 wins with ok = false,
// as torch.argmin gives: warp shuffles, then (more than one warp) one
// __syncthreads over double-buffered per-warp slots.  State goes back to
// global memory once, at the end.  Every float32 operation the plain
// version rounds separately is an explicit _rn intrinsic (no contraction
// into fma), and the arbiter key's fused multiply-add is __fmaf_rn, as
// the compiled reference fuses it (engine.arb_key).
//
// Bound: the tick reads each flow's state and KPF queue entries once and
// writes its state once (tens of bytes a flow), so at a handful of flows
// its bound is nanoseconds, and what it costs is the launch plus k_grant
// dependent block reductions: latency, which no bandwidth removes.  Up to
// 132 elements (one CTA an SM) run side by side in that latency.
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

// ---------------------------------------------------------------------------
// The grant tick
// ---------------------------------------------------------------------------

// The argument block, field for field as ops.GrantTickArgs (a ctypes
// Structure; tests/test_torch_token_bucket.py parses this declaration):
// pointers into the batched carry and the window's tables, then the
// window's shapes.  Every per-element array has a leading batch axis of B
// elements (B = 1 for the serial engine); element b's rows start at b
// times the array's per-element size.  The carry's tensors are read and
// written in place; the tick's index is read through a pointer, so one
// argument block serves every tick of a window (the launch a CUDA graph
// holds).
struct GrantTickArgs {
  int* tokens;                // [B, N] bucket state (tokens, cyc read/written)
  int* cyc;
  const int* refill;          // [B, N] registers
  const int* bkt;
  const int* interval;
  const int* mode;
  int* sw_pend;               // [B, N] deferred refill cycles (software shaping)
  int* q_head;                // [B, N] flow queues
  int* q_cnt;
  const int* q_sz;            // [B, N, qlen]
  const int* q_at;
  float* vft;                 // [B, N] virtual finish times
  const float* fl_w;          // [B, N] weights (>= 1e-3)
  const float* fl_prio;       // [B, N] priorities
  const long long* fl_accel;  // [B, N] accelerator of each flow
  const int* fl_in_dir;       // [B, N] ingress direction (0 h2d, 1 d2h, 2 off)
  const bool* fl_mask;        // [B, N] active lanes (padding and holes false)
  int* rr_ptr;                // [B] last granted flow
  int* credits_used;          // [B] root-complex credits in use
  float* budget;              // [B, 2] this tick's link budgets (bytes)
  const int* aq_head;         // [B, A] accelerator queues
  int* aq_cnt;
  int* aq_bytes;
  int* aq_sz;                 // [B, A, aq_len]
  int* aq_fl;
  int* aq_at;
  int* c_adm_msgs;            // [B, N] admission counters (bytes as hi:lo20)
  int* c_adm_b_lo;
  int* c_adm_b_hi;
  const int* shaping;         // [B] shaping mode words
  const int* arbiter;         // [B] arbiter words
  const int* credits;         // [B] root-complex credits
  const float* ovh;           // [B] per-message fabric overhead (bytes)
  const bool* stall;          // [B or 1, n_ticks] the window's stall masks
  const int* t_idx;           // [1] the tick's index in the window, read
                              // on the card (a CUDA graph replays the
                              // launch; the engine advances the counter)
  float* res_bud;             // [B, R] this tick's extra resource-axis
                              // budgets (bytes); null when R = 0
  const float* res_w_in;      // [B, R, N] bytes charged on axis r per
                              // ingress byte granted to flow f
  const bool* res_any;        // [B, R, N] flow f demands axis r (ingress
                              // or egress): it stalls while r is in debt
  int n;                      // N, flows an element (padded)
  int n_accel;                // A, accelerators an element (padded)
  int qlen;
  int aq_len;
  int aq_byte_cap;
  int k_grant;
  int tick_cycles;
  int stall_stride;           // n_ticks, or 0: one mask for every element
  int n_res;                  // R, extra resource axes (0..MAX_RES)
};

namespace {

constexpr int SHAPING_NONE = 0;
constexpr int SHAPING_SW = 2;
constexpr int ARB_RR = 0;
constexpr int ARB_WRR = 1;
constexpr int ARB_PRIORITY = 2;
constexpr int ARB_WFQ = 3;
constexpr float BIG = 3e38f;          // the key of an ineligible flow
constexpr int MAX_THREADS = 1024;
constexpr int KPF = 4;                // queue entries held ahead of a head
constexpr int MAX_RES = 4;            // extra resource axes a launch holds

// (key, index) lexicographic order: the lower key, then the lower index
__device__ __forceinline__ bool before(float k1, int i1, float k0, int i0) {
  return k1 < k0 || (k1 == k0 && i1 < i0);
}

// the (key, index) minimum over a warp; every lane receives it
__device__ __forceinline__ void warp_argmin(float& key, int& idx) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float k2 = __shfl_xor_sync(0xffffffffu, key, off);
    const int i2 = __shfl_xor_sync(0xffffffffu, idx, off);
    if (before(k2, i2, key, idx)) {
      key = k2;
      idx = i2;
    }
  }
}

// RMAX: 0 (no resource axes: none of their code is compiled in) or
// MAX_RES (a.n_res axes, 1..MAX_RES, read at run time)
template <int FPT, int RMAX>
__global__ void __launch_bounds__(MAX_THREADS)
tb_grant_tick_kernel(const GrantTickArgs a) {
  // per-warp best of a grant iteration, double-buffered so that one
  // barrier an iteration suffices: (key, index, head size, info, ingress
  // demand on each resource axis), where
  // info = accel << 3 | ingress dir << 1 | eligible
  __shared__ float s_key[2][32];
  __shared__ int s_idx[2][32];
  __shared__ int s_sz[2][32];
  __shared__ int s_info[2][32];
  __shared__ float s_w[2][RMAX > 0 ? RMAX : 1][32];

  const int T = blockDim.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n = a.n;
  // this CTA's batch element: its rows of every per-element array
  const int b = blockIdx.x;
  const int64_t fo = static_cast<int64_t>(b) * n;             // [B, N]
  const int64_t ao = static_cast<int64_t>(b) * a.n_accel;     // [B, A]
  const int64_t qo = fo * a.qlen;                             // [B, N, qlen]
  const int64_t aqo = ao * a.aq_len;                          // [B, A, aq_len]
  const int shaping = a.shaping[b];
  const int arbiter = a.arbiter[b];
  const int credits = a.credits[b];
  const float ovh = a.ovh[b];
  const bool sw = shaping == SHAPING_SW;
  const bool shaped = shaping != SHAPING_NONE;
  // loaded whatever the mode (the engine's mask covers every tick), so
  // that the load does not wait for the mode word's
  const bool stall_bit =
      a.stall[static_cast<int64_t>(b) * a.stall_stride + *a.t_idx];
  const bool stall = sw && stall_bit;
  const bool by_vft = arbiter == ARB_WRR || arbiter == ARB_WFQ;

  // per-flow registers (flow f = tid + k * T)
  int tok[FPT], qh[FPT], qc[FPT], info[FPT], aqh[FPT], aqc[FPT], aqb[FPT];
  int msgs[FPT], lo[FPT], hi[FPT];
  float vft[FPT], w[FPT], prio[FPT];
  bool act[FPT];
  int psz[FPT][KPF], pat[FPT][KPF];
  // resource axes: each flow's ingress demand per axis and the axes it
  // demands in either direction (bit r); every thread holds the R budgets
  const int nr = RMAX > 0 ? a.n_res : 0;
  float win[FPT][RMAX > 0 ? RMAX : 1];
  int rmask[FPT];
  float rb[RMAX > 0 ? RMAX : 1];
#pragma unroll
  for (int r = 0; r < RMAX; ++r)
    rb[r] = r < nr ? a.res_bud[static_cast<int64_t>(b) * nr + r] : 0.0f;

  // -- stage 1: token-bucket timers, and the loads of the tick ------------
#pragma unroll
  for (int k = 0; k < FPT; ++k) {
    const int f = tid + k * T;
    tok[k] = qh[k] = qc[k] = info[k] = aqh[k] = aqc[k] = aqb[k] = 0;
    msgs[k] = lo[k] = hi[k] = 0;
    vft[k] = w[k] = prio[k] = 0.0f;
    act[k] = f < n && a.fl_mask[fo + f];
#pragma unroll
    for (int j = 0; j < KPF; ++j) psz[k][j] = pat[k][j] = 0;
    rmask[k] = 0;
#pragma unroll
    for (int r = 0; r < RMAX; ++r) {
      win[k][r] = 0.0f;
      if (r < nr && f < n) {
        const int64_t o = (static_cast<int64_t>(b) * nr + r) * n + f;
        win[k][r] = a.res_w_in[o];
        rmask[k] |= a.res_any[o] ? (1 << r) : 0;
      }
    }
    if (f >= n) continue;
    const int64_t g = fo + f;
    // software shaping: a descheduled host defers refills and catches up
    // on wakeup; hardware shaping and unshaped systems tick every cycle
    int e = a.tick_cycles;
    int pend_out = 0;
    if (sw) {
      const int pend = wrap_add(a.sw_pend[g], a.tick_cycles);
      e = stall ? 0 : pend;
      pend_out = stall ? pend : 0;
    }
    a.sw_pend[g] = pend_out;
    const int iv = max(a.interval[g], 1);
    const int bk = a.bkt[g];
    const int r = a.refill[g];
    const int total = wrap_add(a.cyc[g], e);
    int kk = floor_div(total, iv);
    a.cyc[g] = floor_mod(total, iv);
    kk = min(kk, wrap_add(floor_div(bk, max(r, 1)), 1));
    tok[k] = min(wrap_add(a.tokens[g], wrap_mul(kk, r)), bk);
    const int acc = static_cast<int>(a.fl_accel[g]);
    info[k] = (acc << 3) | (a.fl_in_dir[g] << 1) | (a.mode[g] == 0 ? 1 : 0);
    qh[k] = a.q_head[g];
    qc[k] = a.q_cnt[g];
    vft[k] = a.vft[g];
    w[k] = a.fl_w[g];
    prio[k] = a.fl_prio[g];
    aqh[k] = a.aq_head[ao + acc];
    aqc[k] = a.aq_cnt[ao + acc];
    aqb[k] = a.aq_bytes[ao + acc];
    msgs[k] = a.c_adm_msgs[g];
    lo[k] = a.c_adm_b_lo[g];
    hi[k] = a.c_adm_b_hi[g];
    const int64_t row = qo + static_cast<int64_t>(f) * a.qlen;
#pragma unroll
    for (int j = 0; j < KPF; ++j) {
      const int s = floor_mod(qh[k] + j, a.qlen);
      psz[k][j] = a.q_sz[row + s];
      pat[k][j] = a.q_at[row + s];
    }
  }
  // round robin cycles lanes modulo N (so a mid-table hole keeps every
  // active lane's place); the other arbiters' tie-break term counts
  // modulo the element's active flows, as an unpadded element's does (the
  // arbiter word is the CTA's, so the barriers are uniform)
  int n_key = n;
  if (arbiter != ARB_RR) {
    int n_act = 0;
#pragma unroll
    for (int k = 0; k < FPT; ++k) n_act += __syncthreads_count(act[k]);
    n_key = max(n_act, 1);
  }
  float b0 = a.budget[2 * b], b1 = a.budget[2 * b + 1];
  int cred = a.credits_used[b];
  int rr = a.rr_ptr[b];

  // -- stage 4: k_grant sequential grants ---------------------------------
  for (int it = 0; it < a.k_grant; ++it) {
    // this thread's best flow: (key, index) and what a grant needs of it
    float bk = __int_as_float(0x7f800000);       // +inf: no flow
    int bi = 0x7fffffff, bsz = 0, binfo = 0;
    float bw[RMAX > 0 ? RMAX : 1];
#pragma unroll
    for (int r = 0; r < RMAX; ++r) bw[r] = 0.0f;
#pragma unroll
    for (int k = 0; k < FPT; ++k) {
      const int f = tid + k * T;
      if (f >= n) continue;
      const int hs = psz[k][0];
      const int dir = (info[k] >> 1) & 3;
      bool e = qc[k] > 0 && aqc[k] < a.aq_len &&
               wrap_add(aqb[k], hs) <= a.aq_byte_cap && cred < credits;
      if (shaped) e = e && tok[k] >= ((info[k] & 1) ? hs : 1);
      // a message may start whenever its link has any budget left
      const float bf = dir == 2 ? BIG : (dir == 0 ? b0 : b1);
      e = e && bf > 0.0f && act[k] && !stall;
      // every axis the flow demands must have budget left
#pragma unroll
      for (int r = 0; r < RMAX; ++r)
        if (r < nr && ((rmask[k] >> r) & 1)) e = e && rb[r] > 0.0f;
      float key;
      if (arbiter == ARB_RR) {
        key = __int2float_rn(floor_mod(f - rr - 1, n));
      } else {
        const float rk = __int2float_rn(floor_mod(f - rr - 1, n_key));
        key = arbiter == ARB_PRIORITY ? __fmaf_rn(-prio[k], 1e6f, rk)
                                      : __fmaf_rn(1e-6f, rk, vft[k]);
      }
      if (!e) key = BIG;
      if (key < bk) {                 // flows ascend: a tie keeps the lower
        bk = key;
        bi = f;
        bsz = hs;
        binfo = (info[k] & ~1) | (e ? 1 : 0);
#pragma unroll
        for (int r = 0; r < RMAX; ++r) bw[r] = win[k][r];
      }
    }
    float wk = bk;
    int g = bi;
    warp_argmin(wk, g);
    int gsz, ginfo;
    float gw[RMAX > 0 ? RMAX : 1];
    if (T == 32) {
      const int owner = g % T;        // the lane holding flow g
      gsz = __shfl_sync(0xffffffffu, bsz, owner);
      ginfo = __shfl_sync(0xffffffffu, binfo, owner);
#pragma unroll
      for (int r = 0; r < RMAX; ++r)
        gw[r] = __shfl_sync(0xffffffffu, bw[r], owner);
    } else {
      const int buf = it & 1;
      if (bi == g) {                  // the one lane that holds the warp's best
        s_key[buf][warp] = wk;
        s_idx[buf][warp] = g;
        s_sz[buf][warp] = bsz;
        s_info[buf][warp] = binfo;
#pragma unroll
        for (int r = 0; r < RMAX; ++r) s_w[buf][r][warp] = bw[r];
      }
      __syncthreads();
      const int nwarps = T >> 5;
      float k2 = lane < nwarps ? s_key[buf][lane] : __int_as_float(0x7f800000);
      g = lane < nwarps ? s_idx[buf][lane] : 0x7fffffff;
      warp_argmin(k2, g);
      const int ow = (g % T) >> 5;    // the warp holding flow g
      gsz = s_sz[buf][ow];
      ginfo = s_info[buf][ow];
#pragma unroll
      for (int r = 0; r < RMAX; ++r) gw[r] = s_w[buf][r][ow];
    }
    // the grant, or (ok = false) the same float operations with zeros
    const bool ok = ginfo & 1;
    const int ga = ginfo >> 3;
    const int gdir = (ginfo >> 1) & 3;
    const float szf = __int2float_rn(gsz);
    const float spend = (gdir != 2 && ok) ? __fadd_rn(szf, ovh) : 0.0f;
    b0 = __fsub_rn(b0, gdir == 0 ? spend : 0.0f);
    b1 = __fsub_rn(b1, gdir != 0 ? spend : 0.0f);
    cred += ok ? 1 : 0;
    if (ok) rr = g;
    // the grant's ingress demand on every axis, one fused multiply-add as
    // the compiled reference contracts it
#pragma unroll
    for (int r = 0; r < RMAX; ++r)
      if (ok && r < nr) rb[r] = __fmaf_rn(-gw[r], szf, rb[r]);
#pragma unroll
    for (int k = 0; k < FPT; ++k) {
      const int f = tid + k * T;
      if (f >= n) continue;
      const bool win = ok && f == g;
      float inc = 0.0f;
      if (win) {
        if (shaped) tok[k] = wrap_add(tok[k], -((info[k] & 1) ? gsz : 1));
        // accelerator queue push, at the count before this grant
        const int slot = floor_mod(wrap_add(aqh[k], aqc[k]), a.aq_len);
        const int64_t o = aqo + static_cast<int64_t>(ga) * a.aq_len + slot;
        a.aq_sz[o] = gsz;
        a.aq_fl[o] = g;
        a.aq_at[o] = pat[k][0];
        // pop the flow queue; the entry KPF - 1 past the new head is loaded
        // now and needed no sooner than KPF - 1 grants of this flow later
        qh[k] = floor_mod(qh[k] + 1, a.qlen);
        qc[k] -= 1;
#pragma unroll
        for (int j = 0; j + 1 < KPF; ++j) {
          psz[k][j] = psz[k][j + 1];
          pat[k][j] = pat[k][j + 1];
        }
        const int64_t s = qo + static_cast<int64_t>(f) * a.qlen +
                          floor_mod(qh[k] + KPF - 1, a.qlen);
        psz[k][KPF - 1] = a.q_sz[s];
        pat[k][KPF - 1] = a.q_at[s];
        msgs[k] += 1;
        const int l = wrap_add(lo[k], gsz);
        hi[k] = wrap_add(hi[k], l >> 20);
        lo[k] = l & 0xFFFFF;
        // WRR is message-granular, the other arbiters byte-granular
        inc = arbiter == ARB_WRR ? __fdiv_rn(1.0f, w[k])
                                 : __fdiv_rn(szf, w[k]);
      }
      vft[k] = __fadd_rn(vft[k], inc);
      if (ok && (info[k] >> 3) == ga) {
        aqc[k] += 1;
        aqb[k] = wrap_add(aqb[k], gsz);
      }
    }
  }

  // -- write the tick's state back once -----------------------------------
#pragma unroll
  for (int k = 0; k < FPT; ++k) {
    const int f = tid + k * T;
    if (f >= n) continue;
    const int64_t g = fo + f;
    a.tokens[g] = tok[k];
    a.q_head[g] = qh[k];
    a.q_cnt[g] = qc[k];
    a.vft[g] = vft[k];
    a.c_adm_msgs[g] = msgs[k];
    a.c_adm_b_lo[g] = lo[k];
    a.c_adm_b_hi[g] = hi[k];
    // every flow of an accelerator holds the same count: equal stores
    const int acc = info[k] >> 3;
    a.aq_cnt[ao + acc] = aqc[k];
    a.aq_bytes[ao + acc] = aqb[k];
  }
  if (tid == 0) {
    a.budget[2 * b] = b0;
    a.budget[2 * b + 1] = b1;
    a.credits_used[b] = cred;
    a.rr_ptr[b] = rr;
#pragma unroll
    for (int r = 0; r < RMAX; ++r)
      if (r < nr) a.res_bud[static_cast<int64_t>(b) * nr + r] = rb[r];
  }
}

template <int FPT>
cudaError_t launch_grant_tick(const GrantTickArgs& a, int batch, int threads,
                              cudaStream_t stream) {
  if (a.n_res > 0)
    tb_grant_tick_kernel<FPT, MAX_RES><<<batch, threads, 0, stream>>>(a);
  else
    tb_grant_tick_kernel<FPT, 0><<<batch, threads, 0, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point (loaded with ctypes): one launch of the grant tick on
// `stream` for `batch` elements of a->n flows (1..8192) each, one CTA an
// element, no sync, no allocation; returns cudaGetLastError() of the
// launch.  A CTA has T = 32 * ceil(n / FPT / 32) threads for the least FPT
// in {1, 2, 4, 8} with n <= 1024 * FPT.  The grid may exceed the card's
// resident CTAs (132 SMs): the rest run in later waves.
extern "C" int tb_grant_tick_launch(const GrantTickArgs* a, int batch,
                                    void* stream) {
  const int n = a->n;
  if (n <= 0 || n > 8 * MAX_THREADS || batch <= 0 || batch > 65535 ||
      a->n_res < 0 || a->n_res > MAX_RES ||
      (a->n_res > 0 && (a->res_bud == nullptr || a->res_w_in == nullptr ||
                        a->res_any == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  int fpt = 1;
  while (n > fpt * MAX_THREADS) fpt *= 2;
  const int threads = (((n + fpt - 1) / fpt) + 31) / 32 * 32;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (fpt) {
    case 1: err = launch_grant_tick<1>(*a, batch, threads, s); break;
    case 2: err = launch_grant_tick<2>(*a, batch, threads, s); break;
    case 4: err = launch_grant_tick<4>(*a, batch, threads, s); break;
    default: err = launch_grant_tick<8>(*a, batch, threads, s); break;
  }
  return static_cast<int>(err);
}
