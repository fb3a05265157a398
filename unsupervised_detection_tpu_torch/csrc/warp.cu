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
// Design: one thread per output element, threads running along C, so the
// 32 lanes of a warp read 32 neighbouring channels of one tap row (128
// bytes in float32) and write 32 neighbouring outputs. Each thread
// recomputes its pixel's coordinates from the flow (two loads shared by the
// lanes of the pixel, served by L1). The lerp uses explicitly rounded
// intrinsics (__fmul_rn/__fadd_rn, never contracted to an FMA) and, in
// bfloat16, rounds after every operation as PyTorch's elementwise ops do, so
// the kernel is bit-equal to the plain PyTorch version.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

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

template <typename T>
__global__ void __launch_bounds__(kThreads)
warp_kernel(const T* __restrict__ image, const T* __restrict__ flow,
            T* __restrict__ out, int H, int W, int C, long long total) {
  const long long idx = blockIdx.x * static_cast<long long>(kThreads) + threadIdx.x;
  if (idx >= total) return;
  const int c = static_cast<int>(idx % C);
  const long long pix = idx / C;
  const int x = static_cast<int>(pix % W);
  const int y = static_cast<int>((pix / W) % H);
  const long long b = pix / (static_cast<long long>(H) * W);

  const float qy = __fsub_rn(static_cast<float>(y), udt::to_f(flow[pix * 2]));
  const float qx = __fsub_rn(static_cast<float>(x), udt::to_f(flow[pix * 2 + 1]));
  const float fy = fminf(fmaxf(floorf(qy), 0.f), static_cast<float>(H - 2));
  const float fx = fminf(fmaxf(floorf(qx), 0.f), static_cast<float>(W - 2));
  const float ay = Round<T>::f(fminf(fmaxf(__fsub_rn(qy, fy), 0.f), 1.f));
  const float ax = Round<T>::f(fminf(fmaxf(__fsub_rn(qx, fx), 0.f), 1.f));

  const T* tap = image + ((b * H + static_cast<int>(fy)) * W + static_cast<int>(fx)) * C + c;
  const long long row = static_cast<long long>(W) * C;
  const float top = mix<T>(ax, udt::to_f(tap[0]), udt::to_f(tap[C]));
  const float bottom = mix<T>(ax, udt::to_f(tap[row]), udt::to_f(tap[row + C]));
  out[idx] = udt::from_f<T>(mix<T>(ay, top, bottom));
}

template <typename T>
cudaError_t launch(const void* image, const void* flow, void* out, int B, int H,
                   int W, int C, cudaStream_t stream) {
  const long long total = static_cast<long long>(B) * H * W * C;
  const long long blocks = (total + kThreads - 1) / kThreads;
  warp_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      static_cast<const T*>(image), static_cast<const T*>(flow), static_cast<T*>(out),
      H, W, C, total);
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
