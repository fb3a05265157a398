// PWC cost volume, forward, for sm_90a.
//
// Replaces the Pallas TPU kernel `cost_volume_pallas`
// (unsupervised_detection_tpu/ops/pallas/cost_volume_kernel.py:57, body
// `_kernel` :33-47) and computes the same function as `_cost_volume_xla`
// (unsupervised_detection_tpu/ops/cost_volume.py:57-86):
//
//   out[b,y,x,dy*(2r+1)+dx] =
//       LeakyReLU_0.1( (1/C) * sum_c c1[b,y,x,c] * warp[b,y+dy-r,x+dx-r,c] )
//
// with warp zero outside the image. NHWC in, (B,H,W,(2r+1)^2) out, in the
// input dtype (float32 or bfloat16), float32 accumulation.
//
// Bound on the H100: memory. Reading c1 and warp once and writing the
// volume once moves (2*B*H*W*C + B*H*W*(2r+1)^2) * itemsize bytes for
// 2*B*H*W*C*(2r+1)^2 operations. At PWC's shapes that is at most 16.8
// operations per byte (level 6, C=196, r=4, float32; 33.6 in bfloat16),
// under the card's 20 float32 (295 bfloat16) operations per byte.
//
// Design: one 256-thread block per (b, y, tile of TX=16 pixels along x).
// The block walks C in chunks of CC=32 channels: it stages the tile's c1
// vectors and the (2r+1)-row, (TX+2r)-column halo of `warp` in shared
// memory (float32, channel stride CC+1 so neighbouring offsets fall in
// different banks; out-of-image taps and channels past C are staged as 0,
// so zero padding is index masking and no padded copy goes to device
// memory). Each thread owns up to ceil(TX*K/256) outputs o = p*K + k of the
// tile and accumulates them in registers across chunks. The tile's outputs
// are one contiguous run of (B,H,W,K) memory, so the fused LeakyReLU
// epilogue writes it fully coalesced, channels-last, as the estimator's
// concat consumes it.
#include "common.cuh"

namespace {

constexpr int kTileX = 16;    // output pixels per block along x
constexpr int kChunk = 32;    // channels staged per pass
constexpr int kThreads = 256;

template <typename T, int R>
__global__ void __launch_bounds__(kThreads)
cost_volume_kernel(const T* __restrict__ c1, const T* __restrict__ warp,
                   T* __restrict__ out, int H, int W, int C, float inv_c) {
  constexpr int D = 2 * R + 1;
  constexpr int K = D * D;
  constexpr int HALO = kTileX + 2 * R;
  constexpr int LD = kChunk + 1;
  constexpr int PER_THREAD = (kTileX * K + kThreads - 1) / kThreads;
  __shared__ float s_c1[kTileX * LD];
  __shared__ float s_w[D * HALO * LD];

  const int tiles_x = (W + kTileX - 1) / kTileX;
  const int x0 = (blockIdx.x % tiles_x) * kTileX;
  const int y = (blockIdx.x / tiles_x) % H;
  const long long b = blockIdx.x / (tiles_x * H);

  float acc[PER_THREAD];
  int c1_off[PER_THREAD];
  int w_off[PER_THREAD];
#pragma unroll
  for (int i = 0; i < PER_THREAD; ++i) {
    const int o = threadIdx.x + i * kThreads;
    const int p = o / K;
    const int k = o - p * K;
    acc[i] = 0.f;
    c1_off[i] = p * LD;
    w_off[i] = ((k / D) * HALO + p + k % D) * LD;
  }

  for (int c0 = 0; c0 < C; c0 += kChunk) {
    __syncthreads();
    for (int i = threadIdx.x; i < kTileX * kChunk; i += kThreads) {
      const int c = i % kChunk;
      const int p = i / kChunk;
      const int x = x0 + p;
      float v = 0.f;
      if (x < W && c0 + c < C) v = udt::to_f(c1[((b * H + y) * W + x) * C + c0 + c]);
      s_c1[p * LD + c] = v;
    }
    for (int i = threadIdx.x; i < D * HALO * kChunk; i += kThreads) {
      const int c = i % kChunk;
      const int col = (i / kChunk) % HALO;
      const int row = i / (kChunk * HALO);
      const int yy = y + row - R;
      const int xx = x0 + col - R;
      float v = 0.f;
      if (yy >= 0 && yy < H && xx >= 0 && xx < W && c0 + c < C)
        v = udt::to_f(warp[((b * H + yy) * W + xx) * C + c0 + c]);
      s_w[(row * HALO + col) * LD + c] = v;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < PER_THREAD; ++i) {
      if (threadIdx.x + i * kThreads < kTileX * K) {
        const float* a = s_c1 + c1_off[i];
        const float* w = s_w + w_off[i];
        float s = acc[i];
#pragma unroll
        for (int c = 0; c < kChunk; ++c) s = fmaf(a[c], w[c], s);
        acc[i] = s;
      }
    }
  }

  T* dst = out + ((b * H + y) * W + x0) * K;
  const int valid = min(kTileX, W - x0) * K;
#pragma unroll
  for (int i = 0; i < PER_THREAD; ++i) {
    const int o = threadIdx.x + i * kThreads;
    if (o < valid) {
      const float v = acc[i] * inv_c;
      dst[o] = udt::from_f<T>(v >= 0.f ? v : 0.1f * v);
    }
  }
}

template <typename T, int R>
cudaError_t launch(const void* c1, const void* warp, void* out, int B, int H,
                   int W, int C, cudaStream_t stream) {
  const int tiles_x = (W + kTileX - 1) / kTileX;
  const float inv_c = static_cast<float>(1.0 / static_cast<double>(C));
  cost_volume_kernel<T, R><<<B * H * tiles_x, kThreads, 0, stream>>>(
      static_cast<const T*>(c1), static_cast<const T*>(warp), static_cast<T*>(out),
      H, W, C, inv_c);
  return cudaGetLastError();
}

}  // namespace

// c1, warp: (B,H,W,C) contiguous, dtype code `dtype`; out: (B,H,W,(2r+1)^2).
// Returns the cudaError_t of the launch (0 on success).
extern "C" int udt_cost_volume(const void* c1, const void* warp, void* out, int B,
                               int H, int W, int C, int r, int dtype, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == udt::kFloat32 && r == 4) return launch<float, 4>(c1, warp, out, B, H, W, C, s);
  if (dtype == udt::kFloat32 && r == 2) return launch<float, 2>(c1, warp, out, B, H, W, C, s);
  if (dtype == udt::kBFloat16 && r == 4)
    return launch<__nv_bfloat16, 4>(c1, warp, out, B, H, W, C, s);
  if (dtype == udt::kBFloat16 && r == 2)
    return launch<__nv_bfloat16, 2>(c1, warp, out, B, H, W, C, s);
  return cudaErrorInvalidValue;
}
