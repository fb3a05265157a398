// PWC cost volume, backward, for sm_90a.
//
// No TPU kernel has this job: the JAX package differentiates the cost
// volume with XLA (the VJP of `_cost_volume_xla`,
// unsupervised_detection_tpu/ops/cost_volume.py:57-86; the Pallas forward
// `cost_volume_pallas` has no VJP). PWC pretraining back-propagates through
// it, so the port computes that VJP on the card:
//
//   g'[b,y,x,k]      = g[b,y,x,k] * (out[b,y,x,k] >= 0 ? 1 : 0.1)
//   g_c1[b,y,x,c]    = (1/C) sum_k g'[b,y,x,k] * warp[b, y+dy-r, x+dx-r, c]
//   g_warp[b,y,x,c]  = (1/C) sum_k g'[b, y-dy+r, x-dx+r, k] * c1[b, y-dy+r, x-dx+r, c]
//
// with k = dy*(2r+1) + dx and zero padding. The slope comes from the
// forward's output (JAX's leaky_relu has slope 1 at 0), not from a second
// forward. float32 accumulation, outputs in the input dtype.
//
// Bound on the H100: memory. The function reads c1, warp, out and g once
// and writes both gradients once: (4*C + 2*K) * B*H*W * itemsize bytes,
// for 4*B*H*W*C*K operations (one FMA per pair and gradient): at most
// 16.8 operations per byte at PWC's shapes in float32 (level 6, C=196,
// r=4; 33.6 in bfloat16), under the card's 20 (float32) and 295
// (bfloat16) operations per byte.
//
// Design: correct and simple first. Both gradients are gathers, so no
// atomics: one thread per output element (pixel, channel), channels
// fastest, computes g_c1 and g_warp of that element over the K window
// positions. The lanes of one warp share a pixel (C >= 32 at every PWC
// level), so their reads of g and out are broadcasts and their reads of c1
// and warp one contiguous run. Scalar loads take every C and alignment
// (C=196 in bfloat16 included). The window's reuse is left to the caches:
// each input element is read K times from L1/L2, which is what keeps this
// kernel from its byte bound.
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

template <typename T>
__device__ __forceinline__ float slope_times(T g, T out) {
  const float gf = udt::to_f(g);
  return udt::to_f(out) >= 0.f ? gf : gf * 0.1f;
}

template <typename T, int R>
__global__ void __launch_bounds__(kThreads)
cost_volume_backward_kernel(const T* __restrict__ c1, const T* __restrict__ warp,
                            const T* __restrict__ out, const T* __restrict__ g,
                            T* __restrict__ g_c1, T* __restrict__ g_warp, int H, int W, int C,
                            float inv_c, long long total) {
  constexpr int D = 2 * R + 1;
  constexpr int K = D * D;
  const long long idx = blockIdx.x * static_cast<long long>(kThreads) + threadIdx.x;
  if (idx >= total) return;
  const int c = static_cast<int>(idx % C);
  const long long pix = idx / C;
  const int x = static_cast<int>(pix % W);
  const int y = static_cast<int>((pix / W) % H);
  const long long img = (pix / (static_cast<long long>(H) * W)) * H * W;   // pixel (b, 0, 0)

  float s_c1 = 0.f, s_warp = 0.f;
#pragma unroll
  for (int dy = 0; dy < D; ++dy) {
    const int yw = y + dy - R;   // warp row read for g_c1
    const int ys = y - dy + R;   // output row whose cost k reads this pixel of warp
#pragma unroll
    for (int dx = 0; dx < D; ++dx) {
      const int k = dy * D + dx;
      const int xw = x + dx - R;
      if (yw >= 0 && yw < H && xw >= 0 && xw < W) {
        const long long q = img + static_cast<long long>(yw) * W + xw;
        s_c1 = fmaf(slope_times(g[pix * K + k], out[pix * K + k]), udt::to_f(warp[q * C + c]),
                    s_c1);
      }
      const int xs = x - dx + R;
      if (ys >= 0 && ys < H && xs >= 0 && xs < W) {
        const long long q = img + static_cast<long long>(ys) * W + xs;
        s_warp = fmaf(slope_times(g[q * K + k], out[q * K + k]), udt::to_f(c1[q * C + c]),
                      s_warp);
      }
    }
  }
  g_c1[idx] = udt::from_f<T>(s_c1 * inv_c);
  g_warp[idx] = udt::from_f<T>(s_warp * inv_c);
}

template <typename T, int R>
cudaError_t launch(const void* c1, const void* warp, const void* out, const void* g, void* g_c1,
                   void* g_warp, int B, int H, int W, int C, cudaStream_t stream) {
  const long long total = static_cast<long long>(B) * H * W * C;
  const long long blocks = (total + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  cost_volume_backward_kernel<T, R><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      static_cast<const T*>(c1), static_cast<const T*>(warp), static_cast<const T*>(out),
      static_cast<const T*>(g), static_cast<T*>(g_c1), static_cast<T*>(g_warp), H, W, C,
      static_cast<float>(1.0 / static_cast<double>(C)), total);
  return cudaGetLastError();
}

}  // namespace

// c1, warp, g_c1, g_warp: (B,H,W,C) contiguous; out (the forward's output)
// and g (its gradient): (B,H,W,(2r+1)^2) contiguous; all of dtype code
// `dtype`. Returns the cudaError_t of the launch (0 on success).
extern "C" int udt_cost_volume_backward(const void* c1, const void* warp, const void* out,
                                        const void* g, void* g_c1, void* g_warp, int B, int H,
                                        int W, int C, int r, int dtype, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == udt::kFloat32 && r == 4)
    return launch<float, 4>(c1, warp, out, g, g_c1, g_warp, B, H, W, C, s);
  if (dtype == udt::kFloat32 && r == 2)
    return launch<float, 2>(c1, warp, out, g, g_c1, g_warp, B, H, W, C, s);
  if (dtype == udt::kBFloat16 && r == 4)
    return launch<__nv_bfloat16, 4>(c1, warp, out, g, g_c1, g_warp, B, H, W, C, s);
  if (dtype == udt::kBFloat16 && r == 2)
    return launch<__nv_bfloat16, 2>(c1, warp, out, g, g_c1, g_warp, B, H, W, C, s);
  return cudaErrorInvalidValue;
}
