// Backward bilinear warp, backward (the gradient), for sm_90a.
//
// No TPU kernel has this job: the JAX package's warp is a `custom_vjp`
// whose backward is XLA's VJP of the quad gather (`_warp_window_bwd`,
// unsupervised_detection_tpu/ops/warp.py:150-154: `jax.vjp(_warp_quad)`;
// `_tap_coords` :28-43, `_lerp` :47-51). PWC pretraining back-propagates
// through the warp, so the port computes that VJP on the card. With the
// forward's floors f (clamped to [0,H-2] x [0,W-2]), raw fractions
// r = q - f, weights a = clip(r, 0, 1) and taps tl, tr, bl, br:
//
//   top = ax*(tr-tl)+tl,  bottom = ax*(br-bl)+bl
//   g_image[tl] += g*(1-ay)*(1-ax)   g_image[tr] += g*(1-ay)*ax
//   g_image[bl] += g*ay*(1-ax)       g_image[br] += g*ay*ax
//   g_flow[...,0] = -clip'(ry) * sum_c g*(bottom-top)
//   g_flow[...,1] = -clip'(rx) * sum_c (g*(1-ay)*(tr-tl) + g*ay*(br-bl))
//
// clip' is jnp.clip's derivative as JAX takes it: 1 inside (0, 1), 0
// outside, and 0.5 at exactly 0 or 1 (a tie of jnp.maximum / jnp.minimum);
// a zero flow puts every fraction at 0. The floors carry no gradient.
//
// Bound on the H100: memory. The function reads the image, the flow and g
// once and writes g_image and g_flow once: (3*C + 4) * B*H*W * itemsize
// bytes, ~20 operations per element.
//
// Design: correct and simple first. g_flow is a reduction over channels
// and g_image a scatter. A group of G lanes (the power of two >= C, at most
// 32) takes one pixel: each lane walks channels c, c+G, ..., gathers the
// four taps, accumulates its share of both flow sums, and adds its four
// image contributions with float32 atomicAdd into a zeroed float32 buffer
// (the wrapper allocates it, and casts it for bfloat16); the group then
// sums the flow partials with shuffles and its first lane writes g_flow.
// Atomics add in no fixed order, so g_image differs from run to run in the
// last bits of a sum. Coordinates and weights repeat the forward's
// arithmetic (weights rounded to the storage type, as the forward does).
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

template <typename T> struct Round {
  __device__ __forceinline__ static float f(float v) { return v; }
};
template <> struct Round<__nv_bfloat16> {
  __device__ __forceinline__ static float f(float v) {
    return __bfloat162float(__float2bfloat16(v));
  }
};

// d clip(r, 0, 1) / dr as JAX's jnp.clip gives it
__device__ __forceinline__ float clip_grad(float r) {
  if (r > 0.f && r < 1.f) return 1.f;
  return (r == 0.f || r == 1.f) ? 0.5f : 0.f;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
warp_backward_kernel(const T* __restrict__ image, const T* __restrict__ flow,
                     const T* __restrict__ g, float* __restrict__ g_image,
                     T* __restrict__ g_flow, int H, int W, int C, int group_log2,
                     long long pixels) {
  const long long tid = blockIdx.x * static_cast<long long>(kThreads) + threadIdx.x;
  const int group = 1 << group_log2;
  const int lane = static_cast<int>(tid & (group - 1));
  const long long pix = tid >> group_log2;
  const bool valid = pix < pixels;
  float s_ay = 0.f, s_ax = 0.f, cy = 0.f, cx = 0.f;
  if (valid) {
    const int x = static_cast<int>(pix % W);
    const int y = static_cast<int>((pix / W) % H);
    const long long b = pix / (static_cast<long long>(H) * W);
    const float qy = __fsub_rn(static_cast<float>(y), udt::to_f(flow[pix * 2]));
    const float qx = __fsub_rn(static_cast<float>(x), udt::to_f(flow[pix * 2 + 1]));
    const float fy = fminf(fmaxf(floorf(qy), 0.f), static_cast<float>(H - 2));
    const float fx = fminf(fmaxf(floorf(qx), 0.f), static_cast<float>(W - 2));
    const float ry = __fsub_rn(qy, fy);
    const float rx = __fsub_rn(qx, fx);
    const float ay = Round<T>::f(fminf(fmaxf(ry, 0.f), 1.f));
    const float ax = Round<T>::f(fminf(fmaxf(rx, 0.f), 1.f));
    cy = clip_grad(ry);
    cx = clip_grad(rx);
    const long long t0 = (b * H + static_cast<int>(fy)) * W + static_cast<int>(fx);
    const T* tap = image + t0 * C;
    float* gtap = g_image + t0 * C;
    const long long row = static_cast<long long>(W) * C;
    const T* gp = g + pix * C;
    for (int c = lane; c < C; c += group) {
      const float gg = udt::to_f(gp[c]);
      const float tl = udt::to_f(tap[c]), tr = udt::to_f(tap[C + c]);
      const float bl = udt::to_f(tap[row + c]), br = udt::to_f(tap[row + C + c]);
      const float ct_top = gg * (1.f - ay);
      const float ct_bottom = gg * ay;
      const float top = ax * (tr - tl) + tl;
      const float bottom = ax * (br - bl) + bl;
      s_ay += gg * (bottom - top);
      s_ax += ct_top * (tr - tl) + ct_bottom * (br - bl);
      atomicAdd(gtap + c, ct_top * (1.f - ax));
      atomicAdd(gtap + C + c, ct_top * ax);
      atomicAdd(gtap + row + c, ct_bottom * (1.f - ax));
      atomicAdd(gtap + row + C + c, ct_bottom * ax);
    }
  }
  // every lane of the warp takes part (blocks are whole warps and groups
  // never straddle one), so the full mask is exact
  for (int off = group >> 1; off > 0; off >>= 1) {
    s_ay += __shfl_xor_sync(0xffffffffu, s_ay, off);
    s_ax += __shfl_xor_sync(0xffffffffu, s_ax, off);
  }
  if (valid && lane == 0) {
    g_flow[pix * 2] = udt::from_f<T>(-s_ay * cy);
    g_flow[pix * 2 + 1] = udt::from_f<T>(-s_ax * cx);
  }
}

template <typename T>
cudaError_t launch(const void* image, const void* flow, const void* g, void* g_image,
                   void* g_flow, int B, int H, int W, int C, cudaStream_t stream) {
  int group_log2 = 0;
  while ((1 << group_log2) < C && group_log2 < 5) ++group_log2;
  const long long pixels = static_cast<long long>(B) * H * W;
  const long long threads = pixels << group_log2;
  const long long blocks = (threads + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  warp_backward_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      static_cast<const T*>(image), static_cast<const T*>(flow), static_cast<const T*>(g),
      static_cast<float*>(g_image), static_cast<T*>(g_flow), H, W, C, group_log2, pixels);
  return cudaGetLastError();
}

}  // namespace

// image, g: (B,H,W,C) contiguous; flow: (B,H,W,2) contiguous; all of dtype
// code `dtype`. g_image: (B,H,W,C) float32, zeroed by the caller (the
// kernel adds into it); g_flow: like flow. H, W >= 2. Returns the
// cudaError_t of the launch (0 on success).
extern "C" int udt_warp_backward(const void* image, const void* flow, const void* g,
                                 void* g_image, void* g_flow, int B, int H, int W, int C,
                                 int dtype, void* stream) {
  if (B <= 0 || H < 2 || W < 2 || C <= 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == udt::kFloat32)
    return launch<float>(image, flow, g, g_image, g_flow, B, H, W, C, s);
  if (dtype == udt::kBFloat16)
    return launch<__nv_bfloat16>(image, flow, g, g_image, g_flow, B, H, W, C, s);
  return cudaErrorInvalidValue;
}
