// Shared helpers of the port's CUDA kernels: float <-> storage conversions,
// and the asynchronous staging of NHWC rows into shared memory that the
// cost volume's forward and backward kernels share.
#pragma once

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace udt {

// dtype codes passed from Python (ops/_build.py DTYPE_CODES)
enum DType : int { kFloat32 = 0, kBFloat16 = 1 };

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// One staging copy of 2^vb_log2 bytes global -> shared; zero-filled when
// !valid (src then only has to be a valid address, it is not read).
__device__ __forceinline__ void stage_copy(unsigned char* dst, const unsigned char* src,
                                           bool valid, int vb_log2) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  switch (vb_log2) {
    case 4:
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
                   "r"(valid ? 16 : 0) : "memory");
      break;
    case 3:
      asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(d), "l"(src),
                   "r"(valid ? 8 : 0) : "memory");
      break;
    case 2:
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
                   "r"(valid ? 4 : 0) : "memory");
      break;
    default:
      *reinterpret_cast<uint16_t*>(dst) =
          valid ? *reinterpret_cast<const uint16_t*>(src) : uint16_t(0);
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_prior() {   // all groups but the newest
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Four channels from shared memory, widened to float32.
template <typename T> __device__ __forceinline__ float4 load_quad(const unsigned char* p);
template <> __device__ __forceinline__ float4 load_quad<float>(const unsigned char* p) {
  return *reinterpret_cast<const float4*>(p);
}
template <> __device__ __forceinline__ float4 load_quad<__nv_bfloat16>(const unsigned char* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(u.x << 16), __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16), __uint_as_float(u.y & 0xffff0000u));
}

// Shape of the (B, H, W, C) image rows are staged from, and the staging's
// chunk (2^sb_log2 bytes of each pixel) and copy (2^vb_log2 bytes) sizes.
struct Staging {
  int H, W, C;
  int sb_log2;
  int vb_log2;
};

// Stage `rows` rows of `cols` pixels, bytes [cb0, cb0 + 2^sb_log2) of each,
// from image rows y_first.. and columns x_first.. into `s` (row stride
// `srow`, pixel stride 2^sb_log2); out-of-image pixels and bytes past the
// pixel's channels are zero-filled.
template <typename T>
__device__ __forceinline__ void stage_rows(const T* __restrict__ img, unsigned char* s,
                                           const Staging& st, long long b, int y_first,
                                           int x_first, int rows, int cols, int srow,
                                           int cb0) {
  const int per_row_log2 = st.sb_log2 - st.vb_log2;   // copies per pixel, log2
  const int per_row = cols << per_row_log2;
  const long long pix_bytes = static_cast<long long>(st.C) * sizeof(T);
  const unsigned char* base = reinterpret_cast<const unsigned char*>(img);
  for (int row = 0; row < rows; ++row) {
    const int yy = y_first + row;
    const bool row_ok = yy >= 0 && yy < st.H;
    const unsigned char* src_row = base + (b * st.H + (row_ok ? yy : 0)) * st.W * pix_bytes;
    unsigned char* dst_row = s + row * srow;
    for (int i = threadIdx.x; i < per_row; i += blockDim.x) {
      const int col = i >> per_row_log2;
      const int cb = cb0 + ((i - (col << per_row_log2)) << st.vb_log2);
      const int xx = x_first + col;
      const bool valid = row_ok && xx >= 0 && xx < st.W && cb < pix_bytes;
      stage_copy(dst_row + (i << st.vb_log2), valid ? src_row + xx * pix_bytes + cb : base,
                 valid, st.vb_log2);
    }
  }
}

// Widest staging copy (log2 bytes, 4 down to 1) that the pixel stride and
// both pointers are aligned to; -1 if not even 2 bytes.
inline int copy_log2(const void* a, const void* b, long long pix_bytes) {
  const uintptr_t align = reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b) |
                          static_cast<uintptr_t>(pix_bytes);
  int vb_log2 = 4;
  while (vb_log2 > 1 && (align & ((1u << vb_log2) - 1))) --vb_log2;
  return (align & ((1u << vb_log2) - 1)) ? -1 : vb_log2;
}

inline int ceil_div(int a, int b) { return (a + b - 1) / b; }

}  // namespace udt
