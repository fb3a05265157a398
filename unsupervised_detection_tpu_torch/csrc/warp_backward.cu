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
// Design: g_flow is a reduction over channels and g_image a scatter. A
// group of G lanes takes one pixel (G the power of two >= the pixel's
// quads, at most 32), computes its coordinates once, and each lane walks
// 4-channel quads q, q+G, ...: it loads g and the four taps as one vector
// each (16 bytes in float32, 8 in bfloat16), accumulates its share of both
// flow sums, and adds its four image contributions to the four taps with
// one 16-byte float32 reduction each (`atomicAdd(float4*)`, sm_90): the
// atomics bound this kernel, and one vector reduction does the work of four
// scalar ones. The group then sums the flow partials with shuffles and its
// first lane writes g_flow. Where C % 4 != 0 (C=1 masks) or a pointer is
// not aligned for vectors, the lanes walk single channels with scalar
// atomics. The image gradient accumulates in a float32 buffer that the
// wrapper zeroes (and casts for bfloat16): float32 sums, as bfloat16
// atomics would round every add. Atomics add in no fixed order, so g_image
// differs from run to run in the last bits of a sum. Coordinates and
// weights repeat the forward's arithmetic (weights rounded to the storage
// type, as the forward does).
//
// Not done: pre-reducing each block's taps in a float32 window of shared
// memory (the tile grown by 3 pixels, 96 KB) and flushing it with one
// reduction per non-zero quad. Measured on an H100 at a PWC pretraining
// step's shapes (batch 16, r=4) it took 0.41 / 0.40 ms (float32 /
// bfloat16) against this design's 0.121 / 0.105, slower at every level:
// few blocks, serial passes over the tile and shared-memory atomics cost
// more than the global reductions they save (PERF.md §6).
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

// Four channels at p (16-byte aligned in float32, 8 in bfloat16), in float32.
template <typename T> __device__ __forceinline__ float4 quad(const T* p) {
  return udt::load_quad<T>(reinterpret_cast<const unsigned char*>(p));
}

// d clip(r, 0, 1) / dr as JAX's jnp.clip gives it
__device__ __forceinline__ float clip_grad(float r) {
  if (r > 0.f && r < 1.f) return 1.f;
  return (r == 0.f || r == 1.f) ? 0.5f : 0.f;
}

// One channel with output gradient gg and taps tl, tr, bl, br: adds its
// shares of both flow sums, and gives the image gradient of each tap.
__device__ __forceinline__ void channel(float gg, float tl, float tr, float bl, float br,
                                        float ay, float ax, float& s_ay, float& s_ax,
                                        float& w_tl, float& w_tr, float& w_bl, float& w_br) {
  const float ct_top = gg * (1.f - ay);
  const float ct_bottom = gg * ay;
  const float top = ax * (tr - tl) + tl;
  const float bottom = ax * (br - bl) + bl;
  s_ay += gg * (bottom - top);
  s_ax += ct_top * (tr - tl) + ct_bottom * (br - bl);
  w_tl = ct_top * (1.f - ax);
  w_tr = ct_top * ax;
  w_bl = ct_bottom * (1.f - ax);
  w_br = ct_bottom * ax;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
warp_backward_kernel(const T* __restrict__ image, const T* __restrict__ flow,
                     const T* __restrict__ g, float* __restrict__ g_image,
                     T* __restrict__ g_flow, int H, int W, int C, int group_log2, bool vec,
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
    if (vec) {
      for (int c = lane * 4; c < C; c += group * 4) {
        const float4 gg = quad<T>(gp + c);
        const float4 tl = quad<T>(tap + c), tr = quad<T>(tap + C + c);
        const float4 bl = quad<T>(tap + row + c), br = quad<T>(tap + row + C + c);
        float4 w_tl, w_tr, w_bl, w_br;
        channel(gg.x, tl.x, tr.x, bl.x, br.x, ay, ax, s_ay, s_ax, w_tl.x, w_tr.x, w_bl.x, w_br.x);
        channel(gg.y, tl.y, tr.y, bl.y, br.y, ay, ax, s_ay, s_ax, w_tl.y, w_tr.y, w_bl.y, w_br.y);
        channel(gg.z, tl.z, tr.z, bl.z, br.z, ay, ax, s_ay, s_ax, w_tl.z, w_tr.z, w_bl.z, w_br.z);
        channel(gg.w, tl.w, tr.w, bl.w, br.w, ay, ax, s_ay, s_ax, w_tl.w, w_tr.w, w_bl.w, w_br.w);
        atomicAdd(reinterpret_cast<float4*>(gtap + c), w_tl);
        atomicAdd(reinterpret_cast<float4*>(gtap + C + c), w_tr);
        atomicAdd(reinterpret_cast<float4*>(gtap + row + c), w_bl);
        atomicAdd(reinterpret_cast<float4*>(gtap + row + C + c), w_br);
      }
    } else {
      for (int c = lane; c < C; c += group) {
        float w_tl, w_tr, w_bl, w_br;
        channel(udt::to_f(gp[c]), udt::to_f(tap[c]), udt::to_f(tap[C + c]),
                udt::to_f(tap[row + c]), udt::to_f(tap[row + C + c]), ay, ax, s_ay, s_ax, w_tl,
                w_tr, w_bl, w_br);
        atomicAdd(gtap + c, w_tl);
        atomicAdd(gtap + C + c, w_tr);
        atomicAdd(gtap + row + c, w_bl);
        atomicAdd(gtap + row + C + c, w_br);
      }
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
  // quads where C and every pointer allow 4-channel vectors
  const uintptr_t align = reinterpret_cast<uintptr_t>(image) | reinterpret_cast<uintptr_t>(g);
  const bool vec = C % 4 == 0 && (align & (4 * sizeof(T) - 1)) == 0 &&
                   (reinterpret_cast<uintptr_t>(g_image) & 15) == 0;
  const int items = vec ? C / 4 : C;   // a lane's units of work per pixel
  int group_log2 = 0;
  while ((1 << group_log2) < items && group_log2 < 5) ++group_log2;
  const long long pixels = static_cast<long long>(B) * H * W;
  const long long threads = pixels << group_log2;
  const long long blocks = (threads + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  warp_backward_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      static_cast<const T*>(image), static_cast<const T*>(flow), static_cast<const T*>(g),
      static_cast<float*>(g_image), static_cast<T*>(g_flow), H, W, C, group_log2, vec, pixels);
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
