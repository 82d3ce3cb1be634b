// Tensor maps for TMA tile loads of [B, rows, heads, D] bf16 tensors, shared
// by flash_prefill.cu (K and V) and flash_backward.cu (Q, dO, K and V).
// Host code only; each kernel library that includes it keeps its own cache.
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <mutex>

namespace hopper {

// cuTensorMapEncodeTiled from libcuda, found through the runtime (so the
// library needs no -lcuda)
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_tiled() {
  static const EncodeTiledFn fn = [] {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess)
      ptr = nullptr;
    return reinterpret_cast<EncodeTiledFn>(ptr);
  }();
  return fn;
}

// Rows of a tile box (keys or query rows): one wgmma's M.
constexpr int TILE_ROWS = 64;

// Tensor map of a [B, rows, heads, D] bf16 tensor: boxes of 64 columns x
// TILE_ROWS rows of one (batch, head), 128-byte swizzle, zeros out of
// bounds (past D: the kernels' padded head dim; past `rows`).  Cached by
// (pointer, shape): encoding is pure, so a hit is always valid.  Returns 0
// or a cudaError_t.
inline int tile_map(const void* ptr, int B, int rows, int heads, int D,
                    CUtensorMap* out) {
  struct Entry {
    const void* ptr;
    int B, rows, heads, D;
    CUtensorMap map;
  };
  constexpr int CACHE = 16;
  static Entry cache[CACHE];
  static int used = 0, next = 0;
  static std::mutex mu;
  std::lock_guard<std::mutex> lock(mu);
  for (int i = 0; i < used; ++i) {
    const Entry& e = cache[i];
    if (e.ptr == ptr && e.B == B && e.rows == rows && e.heads == heads &&
        e.D == D) {
      *out = e.map;
      return 0;
    }
  }
  const EncodeTiledFn enc = encode_tiled();
  if (enc == nullptr) return static_cast<int>(cudaErrorSymbolNotFound);
  // a sequence of no rows still gets a valid map; no tile is loaded
  const cuuint64_t n_rows = static_cast<cuuint64_t>(std::max(rows, 1));
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(heads), n_rows,
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {
      static_cast<cuuint64_t>(D) * 2, static_cast<cuuint64_t>(heads) * D * 2,
      n_rows * heads * D * 2};
  const cuuint32_t box[4] = {64, 1, TILE_ROWS, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  Entry e{ptr, B, rows, heads, D, {}};
  const CUresult r = enc(
      &e.map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
      dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return static_cast<int>(cudaErrorInvalidValue);
  cache[next] = e;
  next = (next + 1) % CACHE;
  used = std::min(used + 1, CACHE);
  *out = e.map;
  return 0;
}

}  // namespace hopper
