// GQA decode attention for Hopper (sm_90a): one query token per sequence
// against a KV cache, online softmax in float32, in one launch.
//
// Replaces the Pallas TPU kernel src/repro/kernels/decode_attention/
// kernel.py (_decode_attn_kernel, launched by decode_attention_grouped).
// The TPU version walks the cache's S blocks in order on one core, carrying
// (m, l, acc) in VMEM scratch, and pads G to 8 sublanes and D to 128 lanes
// for the MXU.  On Hopper the valid rows are spread over a thread-block
// cluster instead, and nothing is padded:
//
//   grid (B * KvH, ceil(G / GC), C), clusters of (1, 1, C), C <= 8: the C
//     CTAs of a cluster serve one (b, kv head) and up to GC query heads of
//     its group.  Each CTA reads lengths[b] on the device and takes its
//     share of the valid range [lo, hi) (lo = max(lengths[b] - window, 0)
//     with a window, hi = min(lengths[b], S)): tiles rank, rank + C, ...,
//     so a short sequence spreads its few rows over the cluster.  Without
//     a window the first tile is issued before lengths[b] arrives.
//   In a CTA, a producer warp streams the K and V rows of its share with
//     1-D bulk copies (one a row: D * elt contiguous bytes) into a
//     STAGES-deep ring of row tiles under full / empty mbarriers.  Four
//     consumer warps read rows from shared memory, RB at a time (their
//     dot products, shuffle sums and exponentials interleave: one row at a
//     time left a warp waiting on that chain), share each row across their
//     GC query heads, and keep (m, l, acc) in registers; a lane holds
//     16-byte chunks of the head dim.
//   The cluster merges its C x 4 warps' partial (m, l, acc) through
//     distributed shared memory: CTA o finishes head dims [o W, o W + W),
//     W = ceil(D / C), so every warp stores its (m, l) into each peer and
//     its acc for those dims into their owner (stores need no round trip).
//     One cluster barrier later each CTA merges what it received and
//     writes out = acc / max(l, 1e-30) (a row with no valid position has
//     l = 0 and returns 0, as the reference's max(l, 1e-30) does), cast to
//     q's dtype.  A CTA with no rows pushes (NEG, 0, 0) and takes part in
//     the barrier; after it no CTA touches a peer's shared memory, so each
//     may exit alone.  No global scratch, no second launch.
//   Optionally (a non-null `ml`, float32 [B, H, 2]) the cluster's CTA 0
//     also writes each of its heads' merged (m, l): the running max of the
//     scaled scores and the sum of exp(score - m) over the valid rows,
//     (NEG, 0) for a head with no valid row.  With (out, m, l) a caller
//     combines partials over slices of a sequence (the sequence-sharded
//     decode: repro_torch/distributed/collectives.py).  A null `ml` skips
//     the store and leaves the kernel as it was.
//
// Types: q float32 or bf16, cache float32 or bf16 (independently: the
// serving engine keeps a float32 cache under bf16 activations), float32
// arithmetic throughout.  D <= 256 with D * elt a multiple of 16 bytes (the
// bulk copies' unit), any G = H / KvH.
//
// Bound on an H100: it reads each valid K and V row once (2 * len * KvH * D
// elements per sequence) and does 4 * G flops per element read, far below
// the ~295 flops a byte at which the tensor cores would bound it, so it is
// bound by bytes (3.35 TB/s) and uses no tensor cores.  The design's answer
// is to read only valid rows, share each row across the G query heads,
// keep rows in flight ahead of the math with bulk copies, spread the valid
// rows over enough CTAs to keep the memory system busy at batch 8, and
// merge the partial sums on chip in the same launch.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper_ptx.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int CONSUMERS = 4;                     // consumer warps
constexpr int THREADS = (CONSUMERS + 1) * 32;    // and one producer warp
constexpr int STAGES = 4;                        // row tiles in flight
constexpr int RB = 2;                            // rows a warp takes at once
constexpr int DPL = 8;                           // head-dim elements a lane
constexpr int MAX_CLUSTER = 8;                   // portable cluster size
constexpr float NEG = -1e30f;                    // the reference's masked
                                                 // score
// CTAs an SM should hold: the registers of GC query heads' q and acc
constexpr int min_blocks(int gc) { return gc <= 2 ? 3 : gc == 4 ? 2 : 1; }

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const int* lengths;
  void* out;
  float* ml;                // [B, H, 2] merged (m, l), or null
  int H, KvH, S, D, window, tile_rows;
  float scale;
};

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
  return __float2bfloat16(x);   // round to nearest even, as torch's cast
}

// one 16-byte chunk of a row in shared memory, as floats
__device__ __forceinline__ void load_chunk(const float* p, float* x) {
  const float4 c = *reinterpret_cast<const float4*>(p);
  x[0] = c.x;
  x[1] = c.y;
  x[2] = c.z;
  x[3] = c.w;
}
__device__ __forceinline__ void load_chunk(const __nv_bfloat16* p, float* x) {
  const uint4 c = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = hopper::unpack_bf16(w[i]);
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}

// the mbarriers (2 STAGES), then the final merge's factors coef[GC][C * 4]
// and denominators denom[GC]
template <int GC>
__host__ __device__ constexpr int head_bytes() {
  return (8 * 2 * STAGES + 4 * GC * (MAX_CLUSTER * CONSUMERS + 1) + 127) /
         128 * 128;
}

// what a CTA receives from its cluster: (m, l) [C * 4][GC][2] and acc
// [C * 4][GC][ceil(D / C)]
template <int GC>
__host__ __device__ constexpr int recv_bytes(int D, int C) {
  return ((C * CONSUMERS * GC * (2 + (D + C - 1) / C)) * 4 + 127) / 128 *
         128;
}

template <int GC, typename TK>
size_t smem_bytes(int D, int tile_rows, int C) {
  return head_bytes<GC>() + recv_bytes<GC>(D, C) +
         static_cast<size_t>(STAGES) * 2 * tile_rows * D * sizeof(TK);
}

template <int GC, typename TQ, typename TK>
__global__ void __launch_bounds__(THREADS, min_blocks(GC))
    decode_attention_cluster_kernel(const Params p) {
  constexpr int VEC = 16 / sizeof(TK);     // elements a 16-byte chunk
  constexpr int NCH = DPL / VEC;           // chunks a lane
  extern __shared__ __align__(128) uint8_t smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());

  const int b = blockIdx.x / p.KvH;
  const int kvh = blockIdx.x % p.KvH;
  const int G = p.H / p.KvH;
  const int g0 = blockIdx.y * GC;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int D = p.D;
  const int TR = p.tile_rows;
  const uint32_t row_bytes = D * sizeof(TK);
  const uint32_t tile_bytes = 2 * TR * row_bytes;      // K rows, V rows

  const uint32_t s_bar = hopper::smem_addr(smem);
  auto full = [&](int s) { return s_bar + 8 * s; };
  auto empty = [&](int s) { return s_bar + 8 * (STAGES + s); };
  uint8_t* ring = smem + head_bytes<GC>() + recv_bytes<GC>(D, C);
  const uint32_t s_ring = hopper::smem_addr(ring);

  const int len = __ldg(p.lengths + b);     // used only once it is needed
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      hopper::mbar_init(full(s), 1);
      hopper::mbar_init(empty(s), CONSUMERS);     // one arrival a warp
    }
    hopper::fence_barrier_init();
  }
  hopper::cluster_arrive_relaxed();   // waited for before the first push
  __syncthreads();

  // The CTA's share of the valid rows [lo, hi): tiles rank, rank + C, ...
  // of TR rows from lo.  Without a window lo = 0, so the first tile's rows
  // are known before lengths[b] arrives: the producer issues that tile at
  // once (rows past hi are read and ignored) and the CTA always consumes
  // it, which keeps a read of lengths off the copies' critical path.
  const bool early = p.window <= 0;
  const int first = rank * TR;              // rows before its first tile
  const int tile_stride = C * TR;
  const TK* kb = static_cast<const TK*>(p.k);
  const TK* vb = static_cast<const TK*>(p.v);
  // issue `rows` rows of K and V from row r0 into stage s, one lane a row
  // (issuing bulk copies one after another from one thread held a tile's
  // first rows back)
  auto issue = [&](int s, int r0, int rows) {
    if (lane == 0) hopper::mbar_expect_tx(full(s), 2 * rows * row_bytes);
    __syncwarp();                   // the expected bytes before any copy
    const uint32_t dk = s_ring + s * tile_bytes;
    const uint32_t dv = dk + TR * row_bytes;
    for (int r = lane; r < rows; r += 32) {
      const int64_t off =
          ((static_cast<int64_t>(b) * p.S + r0 + r) * p.KvH + kvh) * D;
      hopper::bulk_load(dk + r * row_bytes, kb + off, row_bytes, full(s));
      hopper::bulk_load(dv + r * row_bytes, vb + off, row_bytes, full(s));
    }
  };
  if (warp == CONSUMERS && early)
    issue(0, first, max(0, min(TR, p.S - first)));

  const int hi = min(len, p.S);
  const int lo = early ? 0 : max(len - p.window, 0);
  const int n = max(hi - lo, 0);
  const int n_tiles = n > first ? (n - first + tile_stride - 1) / tile_stride
                                : 0;
  const int n_loop = early ? max(n_tiles, 1) : n_tiles;
  // valid rows of tile t (0 for an early tile past hi)
  auto valid_rows = [&](int t) {
    return max(0, min(TR, hi - (lo + first + t * tile_stride)));
  };

  float m[GC], l[GC], acc[GC][DPL];
#pragma unroll
  for (int g = 0; g < GC; ++g) {
    m[g] = NEG;
    l[g] = 0.f;
#pragma unroll
    for (int i = 0; i < DPL; ++i) acc[g][i] = 0.f;
  }

  if (warp == CONSUMERS) {
    // ---- producer warp -------------------------------------------------
    for (int t = early ? 1 : 0; t < n_tiles; ++t) {
      const int s = t % STAGES;
      hopper::mbar_wait(empty(s), ((t / STAGES) & 1) ^ 1);
      issue(s, lo + first + t * tile_stride, valid_rows(t));
    }
  } else {
    // ---- consumers -------------------------------------------------------
    // lane element e = VEC i + j is head dim (32 i + lane) VEC + j
    const TQ* qb = static_cast<const TQ*>(p.q);
    float qr[GC][DPL];
#pragma unroll
    for (int g = 0; g < GC; ++g) {
      const int64_t qrow =
          (static_cast<int64_t>(b) * p.H + kvh * G + g0 + g) * D;
#pragma unroll
      for (int i = 0; i < NCH; ++i) {
        const int d0 = (32 * i + lane) * VEC;
#pragma unroll
        for (int j = 0; j < VEC; ++j)
          qr[g][VEC * i + j] = (g0 + g < G && d0 < D)
                                   ? to_f(qb[qrow + d0 + j])
                                   : 0.f;
      }
    }
    for (int t = 0; t < n_loop; ++t) {
      const int s = t % STAGES;
      hopper::mbar_wait(full(s), (t / STAGES) & 1);
      const int rows = valid_rows(t);
      const uint8_t* tk = ring + s * tile_bytes;
      const uint8_t* tv = tk + TR * row_bytes;
      // warp w takes rows RB w .. RB w + RB - 1, then RB CONSUMERS further
      for (int r0 = RB * warp; r0 < rows; r0 += RB * CONSUMERS) {
        float kx[RB][DPL], vx[RB][DPL];
#pragma unroll
        for (int rb = 0; rb < RB; ++rb) {
          const TK* kr = reinterpret_cast<const TK*>(tk + (r0 + rb) *
                                                     row_bytes);
          const TK* vr = reinterpret_cast<const TK*>(tv + (r0 + rb) *
                                                     row_bytes);
#pragma unroll
          for (int i = 0; i < NCH; ++i) {
            const int d0 = (32 * i + lane) * VEC;
            if (r0 + rb < rows && d0 < D) {
              load_chunk(kr + d0, kx[rb] + VEC * i);
              load_chunk(vr + d0, vx[rb] + VEC * i);
            } else {
#pragma unroll
              for (int j = 0; j < VEC; ++j)
                kx[rb][VEC * i + j] = vx[rb][VEC * i + j] = 0.f;
            }
          }
        }
        float sc[RB][GC];
#pragma unroll
        for (int rb = 0; rb < RB; ++rb)
#pragma unroll
          for (int g = 0; g < GC; ++g) {
            float part = 0.f;
#pragma unroll
            for (int e = 0; e < DPL; ++e) part += qr[g][e] * kx[rb][e];
            sc[rb][g] = part;
          }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
#pragma unroll
          for (int rb = 0; rb < RB; ++rb)
#pragma unroll
            for (int g = 0; g < GC; ++g)
              sc[rb][g] += __shfl_xor_sync(0xffffffffu, sc[rb][g], off);
        // one online-softmax step for the RB rows (rows past the tile's
        // end weigh 0)
#pragma unroll
        for (int g = 0; g < GC; ++g) {
          float m_new = m[g];
#pragma unroll
          for (int rb = 0; rb < RB; ++rb) {
            sc[rb][g] *= p.scale;
            if (r0 + rb < rows) m_new = fmaxf(m_new, sc[rb][g]);
          }
          const float alpha = expf(m[g] - m_new);
          float pr[RB];
          float psum = 0.f;
#pragma unroll
          for (int rb = 0; rb < RB; ++rb) {
            pr[rb] = r0 + rb < rows ? expf(sc[rb][g] - m_new) : 0.f;
            psum += pr[rb];
          }
          l[g] = l[g] * alpha + psum;
#pragma unroll
          for (int e = 0; e < DPL; ++e) {
            float a = acc[g][e] * alpha;
#pragma unroll
            for (int rb = 0; rb < RB; ++rb) a += pr[rb] * vx[rb][e];
            acc[g][e] = a;
          }
          m[g] = m_new;
        }
      }
      __syncwarp();
      if (lane == 0) hopper::mbar_arrive(empty(s));
    }
  }

  // ---- push each warp's partials to the CTAs that finish its head dims --
  // CTA o of the cluster finishes head dims [o W, o W + W); it receives
  // (m, l) of every warp of the cluster and that warp's acc for its dims
  const int W = (D + C - 1) / C;
  float* recv_ml = reinterpret_cast<float*>(smem + head_bytes<GC>());
  float* recv_acc = recv_ml + C * CONSUMERS * GC * 2;
  hopper::cluster_wait();             // every peer has started
  if (warp < CONSUMERS) {
    const int src = rank * CONSUMERS + warp;
#pragma unroll
    for (int g = 0; g < GC; ++g) {
      if (lane < C) {
        float* ml = cluster.map_shared_rank(recv_ml, lane);
        ml[(src * GC + g) * 2] = m[g];
        ml[(src * GC + g) * 2 + 1] = l[g];
      }
#pragma unroll
      for (int i = 0; i < NCH; ++i) {
        const int d0 = (32 * i + lane) * VEC;
        if (d0 < D && W % 4 == 0) {     // 16-byte stores, one owner each
#pragma unroll
          for (int j = 0; j < VEC; j += 4) {
            const int o = (d0 + j) / W;
            float* dst = cluster.map_shared_rank(recv_acc, o) +
                         (src * GC + g) * W + d0 + j - o * W;
            *reinterpret_cast<float4*>(dst) =
                make_float4(acc[g][VEC * i + j], acc[g][VEC * i + j + 1],
                            acc[g][VEC * i + j + 2], acc[g][VEC * i + j + 3]);
          }
        } else if (d0 < D) {
#pragma unroll
          for (int j = 0; j < VEC; ++j) {
            const int o = (d0 + j) / W;
            cluster.map_shared_rank(recv_acc, o)[(src * GC + g) * W + d0 +
                                                 j - o * W] =
                acc[g][VEC * i + j];
          }
        }
      }
    }
  }
  // every push lands before any CTA passes; nothing reads or writes a
  // peer's shared memory after it, so each CTA may finish and exit alone
  cluster.sync();

  // ---- finish this CTA's head dims ---------------------------------------
  const int nsrc = C * CONSUMERS;
  float* coef = reinterpret_cast<float*>(smem + 8 * 2 * STAGES);  // [GC][nsrc]
  float* denom = coef + GC * MAX_CLUSTER * CONSUMERS;             // [GC]
  // warp g % 5 takes head g, a lane each source warp (nsrc <= 32)
  for (int g = warp; g < GC; g += CONSUMERS + 1) {
    const float mj = lane < nsrc ? recv_ml[(lane * GC + g) * 2] : NEG;
    const float lj = lane < nsrc ? recv_ml[(lane * GC + g) * 2 + 1] : 0.f;
    float mx = mj;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    const float c = expf(mj - mx);
    float lsum = lj * c;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      lsum += __shfl_xor_sync(0xffffffffu, lsum, off);
    if (lane < nsrc) coef[g * nsrc + lane] = c;
    if (lane == 0) denom[g] = fmaxf(lsum, 1e-30f);
    // the head's merged (m, l), written once: by the cluster's CTA 0
    if (p.ml != nullptr && rank == 0 && lane == 0 && g0 + g < G) {
      float* dst =
          p.ml + (static_cast<int64_t>(b) * p.H + kvh * G + g0 + g) * 2;
      dst[0] = mx;
      dst[1] = lsum;
    }
  }
  __syncthreads();
  const int d_lo = rank * W;
  const int width = min(W, D - d_lo);
  TQ* ob = static_cast<TQ*>(p.out);
  for (int idx = threadIdx.x; idx < GC * width; idx += THREADS) {
    const int g = idx / width;
    const int dd = idx - g * width;
    if (g0 + g >= G) continue;
    float a = 0.f;
#pragma unroll 8
    for (int j = 0; j < nsrc; ++j)
      a += recv_acc[(j * GC + g) * W + dd] * coef[g * nsrc + j];
    ob[(static_cast<int64_t>(b) * p.H + kvh * G + g0 + g) * D + d_lo + dd] =
        from_f<TQ>(a / denom[g]);
  }
}

// Raise the kernel's dynamic shared-memory limit to `bytes` if it is lower.
template <int GC, typename TQ, typename TK>
cudaError_t allow_smem(size_t bytes) {
  static size_t allowed = 48 * 1024;      // the default dynamic limit
  if (bytes <= allowed) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      decode_attention_cluster_kernel<GC, TQ, TK>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err == cudaSuccess) allowed = bytes;
  return err;
}

template <int GC, typename TQ, typename TK>
int launch(const Params& p, int B, int C, cudaStream_t stream) {
  auto kern = decode_attention_cluster_kernel<GC, TQ, TK>;
  const size_t bytes = smem_bytes<GC, TK>(p.D, p.tile_rows, C);
  const cudaError_t lim = allow_smem<GC, TQ, TK>(bytes);
  if (lim != cudaSuccess) return static_cast<int>(lim);
  const int G = p.H / p.KvH;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B * p.KvH, (G + GC - 1) / GC, C);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = C;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kern, p);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// CTAs of the kernel an SM holds and clusters of C the card holds at once
template <int GC, typename TQ, typename TK>
int occupancy(int C, int D, int tile_rows, int* blocks, int* clusters) {
  auto kern = decode_attention_cluster_kernel<GC, TQ, TK>;
  const size_t bytes = smem_bytes<GC, TK>(D, tile_rows, C);
  cudaError_t err = allow_smem<GC, TQ, TK>(bytes);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kern,
                                                        THREADS, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(1, 1, C);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = bytes;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = C;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return static_cast<int>(
      cudaOccupancyMaxActiveClusters(clusters, kern, &cfg));
}

template <typename TQ, typename TK>
int dispatch_g(int gc, const Params& p, int B, int C, cudaStream_t stream) {
  switch (gc) {
    case 1: return launch<1, TQ, TK>(p, B, C, stream);
    case 2: return launch<2, TQ, TK>(p, B, C, stream);
    case 4: return launch<4, TQ, TK>(p, B, C, stream);
    case 8: return launch<8, TQ, TK>(p, B, C, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Plain C entry point (loaded with ctypes).  q [B, H, D], k / v
// [B, S, KvH, D], lengths [B] int32, out [B, H, D] (q's dtype), all
// contiguous, k and v 16-byte aligned; ml [B, H, 2] float32 or null.  One
// launch on `stream` of a grid of clusters of `cluster` CTAs (1..8); `gc`
// (1, 2, 4 or 8) query heads a CTA; `tile_rows` cache rows a ring tile.
// Does not synchronise and allocates nothing.  Returns cudaGetLastError()
// of the launch (or the error of the launch or of the shared-memory
// attribute), or cudaErrorInvalidValue for an unsupported shape.
extern "C" int decode_attention_launch(int q_bf16, int kv_bf16, int gc,
                                       int cluster, int tile_rows,
                                       const void* q, const void* k,
                                       const void* v, const int* lengths,
                                       void* out, float* ml, int B, int H,
                                       int KvH, int S, int D, int window,
                                       float scale, void* stream) {
  if (B <= 0 || H <= 0) return 0;
  const int elt = kv_bf16 ? 2 : 4;
  if (KvH <= 0 || H % KvH != 0 || D <= 0 || D > DPL * 32 || S <= 0 ||
      (D * elt) % 16 != 0 || cluster < 1 || cluster > MAX_CLUSTER ||
      tile_rows < 1 || reinterpret_cast<uintptr_t>(k) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(v) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Params p{q, k, v, lengths, out, ml, H, KvH, S, D, window,
                 tile_rows, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (q_bf16) {
    if (kv_bf16)
      return dispatch_g<__nv_bfloat16, __nv_bfloat16>(gc, p, B, cluster, st);
    return dispatch_g<__nv_bfloat16, float>(gc, p, B, cluster, st);
  }
  if (kv_bf16) return dispatch_g<float, __nv_bfloat16>(gc, p, B, cluster, st);
  return dispatch_g<float, float>(gc, p, B, cluster, st);
}

// The occupancy of a launch plan (see decode_attention_launch): CTAs an SM
// holds and clusters the card holds at once, into *blocks and *clusters.
extern "C" int decode_attention_occupancy(int q_bf16, int kv_bf16, int gc,
                                          int cluster, int tile_rows, int D,
                                          int* blocks, int* clusters) {
#define DA_OCC(TQ, TK)                                                    \
  switch (gc) {                                                           \
    case 1: return occupancy<1, TQ, TK>(cluster, D, tile_rows, blocks,    \
                                        clusters);                        \
    case 2: return occupancy<2, TQ, TK>(cluster, D, tile_rows, blocks,    \
                                        clusters);                        \
    case 4: return occupancy<4, TQ, TK>(cluster, D, tile_rows, blocks,    \
                                        clusters);                        \
    case 8: return occupancy<8, TQ, TK>(cluster, D, tile_rows, blocks,    \
                                        clusters);                        \
  }                                                                       \
  return static_cast<int>(cudaErrorInvalidValue);
  if (q_bf16) {
    if (kv_bf16) { DA_OCC(__nv_bfloat16, __nv_bfloat16) }
    DA_OCC(__nv_bfloat16, float)
  }
  if (kv_bf16) { DA_OCC(float, __nv_bfloat16) }
  DA_OCC(float, float)
#undef DA_OCC
}
