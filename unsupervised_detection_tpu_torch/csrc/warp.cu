// Backward bilinear warp, forward, for sm_90a.
//
// Replaces the Pallas TPU kernel `warp_window_pallas`
// (unsupervised_detection_tpu/ops/pallas/warp_kernel.py:219, body `_kernel`
// :158-206, dispatched by ops/warp.py:110-156 `_warp_window`) and computes
// the function of `_warp_quad` (ops/warp.py:28-101):
//
//   out[b,y,x,c] = bilinear image[b, y - flow[b,y,x,0], x - flow[b,y,x,1], c]
//
// Coordinates in float32; floors clamped to [0,H-2] x [0,W-2], weights to
// [0,1] (`_tap_coords`, ops/warp.py:28-44); the lerp runs in TF order, x
// first then y (`_lerp`, :47-51). The TPU kernel's K-row window, one-hot
// MXU resample and overflow guard exist only because Mosaic cannot gather;
// the card gathers, so this is a direct 4-tap gather with no window
// contract.
//
// Bound on the H100: memory. The function reads the image and the flow once
// and writes the output once: (2*B*H*W*C + B*H*W*2) * itemsize bytes (the
// flow has the image's dtype), for ~10 operations per output element.
//
// Design: one thread per pixel and vector of kVec=8 channels. The thread
// reads its pixel's flow and computes the floors and weights once for the
// vector, not once per channel, then gathers each of
// the four taps as 16-byte loads (one in bfloat16, two in float32), lerps
// two channels at a time (in bfloat16 one packed convert rounds both,
// halving the float32 -> bfloat16 conversions) and writes the
// vector with 16-byte stores. Threads run along the vectors of
// a pixel, so the lanes of one pixel read one contiguous run of each tap
// row. Where C % 8 != 0 or a pointer is not 16-byte aligned the thread
// walks its (up to 8) channels with scalar loads: C=1 masks take this
// path. The lerp uses explicitly rounded intrinsics (__fmul_rn/__fadd_rn,
// never contracted to an FMA) and, in bfloat16, rounds after every
// operation as PyTorch's elementwise ops do, so the kernel is bit-equal to
// the plain PyTorch version.
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 8;   // channels per thread

// Rounds a float32 result to the precision of storage type T.
template <typename T> struct Round {
  __device__ __forceinline__ static float f(float v) { return v; }
};
template <> struct Round<__nv_bfloat16> {
  __device__ __forceinline__ static float f(float v) {
    return __bfloat162float(__float2bfloat16(v));
  }
};

// a*(hi-lo)+lo, each operation rounded to T's precision
template <typename T>
__device__ __forceinline__ float mix(float a, float lo, float hi) {
  const float d = Round<T>::f(__fsub_rn(hi, lo));
  const float m = Round<T>::f(__fmul_rn(a, d));
  return Round<T>::f(__fadd_rn(m, lo));
}

// Rounds two float32 results to the precision of storage type T; bfloat16
// rounds both with one packed convert (same round-to-nearest-even as one
// __float2bfloat16 each).
template <typename T> struct Round2 {
  __device__ __forceinline__ static float2 f(float2 v) { return v; }
};
template <> struct Round2<__nv_bfloat16> {
  __device__ __forceinline__ static float2 f(float2 v) {
    return __bfloat1622float2(__float22bfloat162_rn(v));
  }
};

// mix() on two channels at once
template <typename T>
__device__ __forceinline__ float2 mix2(float a, float2 lo, float2 hi) {
  const float2 d = Round2<T>::f(make_float2(__fsub_rn(hi.x, lo.x), __fsub_rn(hi.y, lo.y)));
  const float2 m = Round2<T>::f(make_float2(__fmul_rn(a, d.x), __fmul_rn(a, d.y)));
  return Round2<T>::f(make_float2(__fadd_rn(m.x, lo.x), __fadd_rn(m.y, lo.y)));
}

// kVec elements of T held as 16-byte words (one in bfloat16, two in
// float32), moved with 16-byte loads and stores.
template <typename T> struct Vec {
  static constexpr int kWords = sizeof(T) * kVec / 16;
  uint4 u[kWords];
  __device__ __forceinline__ void load(const T* p) {
#pragma unroll
    for (int w = 0; w < kWords; ++w) u[w] = reinterpret_cast<const uint4*>(p)[w];
  }
  __device__ __forceinline__ void store(T* p) const {
#pragma unroll
    for (int w = 0; w < kWords; ++w) reinterpret_cast<uint4*>(p)[w] = u[w];
  }
  __device__ __forceinline__ float2 get2(int i) const {   // elements i, i+1
    const T* e = reinterpret_cast<const T*>(u);
    return make_float2(udt::to_f(e[i]), udt::to_f(e[i + 1]));
  }
  // elements i, i+1 from values already rounded to T's precision (so
  // bfloat16 keeps the high half of each float32, exactly)
  __device__ __forceinline__ void set2(int i, float2 v) {
    if constexpr (sizeof(T) == 2) {
      reinterpret_cast<uint32_t*>(u)[i / 2] =
          (__float_as_uint(v.x) >> 16) | (__float_as_uint(v.y) & 0xffff0000u);
    } else {
      reinterpret_cast<float*>(u)[i] = v.x;
      reinterpret_cast<float*>(u)[i + 1] = v.y;
    }
  }
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
warp_kernel(const T* __restrict__ image, const T* __restrict__ flow,
            T* __restrict__ out, int H, int W, int C, int groups, bool vec, long long total) {
  const long long idx = blockIdx.x * static_cast<long long>(kThreads) + threadIdx.x;
  if (idx >= total) return;
  const int g = static_cast<int>(idx % groups);
  const long long pix = idx / groups;
  const int x = static_cast<int>(pix % W);
  const int y = static_cast<int>((pix / W) % H);
  const long long b = pix / (static_cast<long long>(H) * W);

  const float qy = __fsub_rn(static_cast<float>(y), udt::to_f(flow[pix * 2]));
  const float qx = __fsub_rn(static_cast<float>(x), udt::to_f(flow[pix * 2 + 1]));
  const float fy = fminf(fmaxf(floorf(qy), 0.f), static_cast<float>(H - 2));
  const float fx = fminf(fmaxf(floorf(qx), 0.f), static_cast<float>(W - 2));
  const float ay = Round<T>::f(fminf(fmaxf(__fsub_rn(qy, fy), 0.f), 1.f));
  const float ax = Round<T>::f(fminf(fmaxf(__fsub_rn(qx, fx), 0.f), 1.f));

  const int c0 = g * kVec;
  const T* tap = image + ((b * H + static_cast<int>(fy)) * W + static_cast<int>(fx)) * C + c0;
  const long long row = static_cast<long long>(W) * C;
  T* dst = out + pix * C + c0;
  if (vec) {
    Vec<T> tl, tr, bl, br, o;
    tl.load(tap);
    tr.load(tap + C);
    bl.load(tap + row);
    br.load(tap + row + C);
#pragma unroll
    for (int i = 0; i < kVec; i += 2) {
      const float2 top = mix2<T>(ax, tl.get2(i), tr.get2(i));
      const float2 bottom = mix2<T>(ax, bl.get2(i), br.get2(i));
      o.set2(i, mix2<T>(ay, top, bottom));
    }
    o.store(dst);
  } else {
    const int n = min(kVec, C - c0);
    for (int i = 0; i < n; ++i) {
      const float top = mix<T>(ax, udt::to_f(tap[i]), udt::to_f(tap[C + i]));
      const float bottom = mix<T>(ax, udt::to_f(tap[row + i]), udt::to_f(tap[row + C + i]));
      dst[i] = udt::from_f<T>(mix<T>(ay, top, bottom));
    }
  }
}

template <typename T>
cudaError_t launch(const void* image, const void* flow, void* out, int B, int H,
                   int W, int C, cudaStream_t stream) {
  const int groups = (C + kVec - 1) / kVec;
  const bool vec = C % kVec == 0 &&
                   ((reinterpret_cast<uintptr_t>(image) | reinterpret_cast<uintptr_t>(out)) &
                    15) == 0;
  const long long total = static_cast<long long>(B) * H * W * groups;
  const long long blocks = (total + kThreads - 1) / kThreads;
  warp_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      static_cast<const T*>(image), static_cast<const T*>(flow), static_cast<T*>(out),
      H, W, C, groups, vec, total);
  return cudaGetLastError();
}

}  // namespace

// image: (B,H,W,C) contiguous, dtype code `dtype`; flow: (B,H,W,2)
// contiguous, same dtype; out: like image. H, W >= 2.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int udt_warp(const void* image, const void* flow, void* out, int B, int H,
                        int W, int C, int dtype, void* stream) {
  if (B <= 0 || H < 2 || W < 2 || C <= 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == udt::kFloat32) return launch<float>(image, flow, out, B, H, W, C, s);
  if (dtype == udt::kBFloat16)
    return launch<__nv_bfloat16>(image, flow, out, B, H, W, C, s);
  return cudaErrorInvalidValue;
}

// Message of a cudaError_t returned by the launchers above.
extern "C" const char* udt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
