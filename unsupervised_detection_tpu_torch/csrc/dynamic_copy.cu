// Tile copy at a device-held offset, for sm_90a.
//
// Replaces the Pallas TPU kernel of tools/repro_mosaic_dynamic_dma.py
// (`build`, :34; `pl.pallas_call` at :59), a compiler repro on no path of
// the system: it DMAs a 128x256 float32 tile out of a (1024, 256)
// (sublane case, axis 0) or (128, 1024) (lane case, axis 1) buffer at the
// offset offs[0] * step along `axis`, offs being a scalar in device memory
// (step 8 along axis 0, 256 along axis 1).
//
//   out[i, j] = src[i + s*(axis == 0), j + s*(axis == 1)],
//   s = offs[0] * step (+ src.shape[axis] if negative), clamped to
//       [0, src.shape[axis] - tile.shape[axis]]
//
// (lax.dynamic_slice's start; the repro's offsets are in range).
//
// Bound on the H100: memory, 2 * 128 * 256 * 4 bytes; at that size the
// launch itself dominates.
//
// Design: Hopper's counterpart of `pltpu.make_async_copy` is the bulk
// asynchronous copy (`cp.async.bulk` global -> shared, completion counted
// in bytes on an mbarrier; no tensor map). Each block copies kRows rows of
// the tile: thread 0 reads the offset, arms the block's mbarrier with the
// byte count and issues one bulk copy per row (a 1 KB contiguous run in
// both cases); every thread waits on the barrier's phase 0 and then writes
// the rows out with 16-byte stores.
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kTileRows = 128;
constexpr int kTileCols = 256;
constexpr int kRows = 16;                     // tile rows per block
constexpr int kThreads = 256;
constexpr int kRowBytes = kTileCols * 4;

__global__ void __launch_bounds__(kThreads)
dynamic_copy_kernel(const float* __restrict__ src, const int* __restrict__ offs,
                    float* __restrict__ out, int src_rows, int src_cols, int axis, int step) {
  __shared__ __align__(128) float tile[kRows * kTileCols];
  __shared__ __align__(8) uint64_t bar;
  const uint32_t bar_addr = static_cast<uint32_t>(__cvta_generic_to_shared(&bar));
  const int r0 = blockIdx.x * kRows;

  if (threadIdx.x == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar_addr) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    const int n = axis == 0 ? src_rows : src_cols;
    int s = offs[0] * step;
    if (s < 0) s += n;
    s = min(max(s, 0), n - (axis == 0 ? kTileRows : kTileCols));
    const int row0 = axis == 0 ? s : 0;
    const int col0 = axis == 0 ? 0 : s;
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar_addr),
                 "r"(kRows * kRowBytes) : "memory");
    for (int r = 0; r < kRows; ++r) {
      const float* g = src + static_cast<long long>(row0 + r0 + r) * src_cols + col0;
      const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(tile + r * kTileCols));
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
          ::"r"(d), "l"(g), "r"(kRowBytes), "r"(bar_addr) : "memory");
    }
  }
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar_addr) : "memory");
  }
  const float4* s4 = reinterpret_cast<const float4*>(tile);
  float4* o4 = reinterpret_cast<float4*>(out + static_cast<long long>(r0) * kTileCols);
  for (int i = threadIdx.x; i < kRows * kTileCols / 4; i += kThreads) o4[i] = s4[i];
}

}  // namespace

// src: (src_rows, src_cols) float32 contiguous, 16-byte aligned; offs: one
// int32 in device memory; out: (128, 256) float32. The dimension other than
// `axis` must equal the tile's, the one along `axis` be at least the
// tile's, src_cols a multiple of 4 and step * 4 bytes a multiple of 16
// along axis 1 (bulk copies move 16-byte-aligned runs).
// Returns the cudaError_t of the launch (0 on success).
extern "C" int udt_dynamic_copy(const void* src, const void* offs, void* out, int src_rows,
                                int src_cols, int axis, int step, void* stream) {
  const bool shape_ok = axis == 0 ? (src_cols == kTileCols && src_rows >= kTileRows)
                                  : (src_rows == kTileRows && src_cols >= kTileCols);
  if (!shape_ok || (axis != 0 && axis != 1) || src_cols % 4 != 0 || (axis == 1 && step % 4 != 0) ||
      (reinterpret_cast<uintptr_t>(src) & 15) || (reinterpret_cast<uintptr_t>(out) & 15))
    return cudaErrorInvalidValue;
  dynamic_copy_kernel<<<kTileRows / kRows, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(src), static_cast<const int*>(offs), static_cast<float*>(out),
      src_rows, src_cols, axis, step);
  return cudaGetLastError();
}
