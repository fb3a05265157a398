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
// A launch may cover a range [d0, d1) of the 2r+1 displacement rows dy: it
// writes the channels dy*(2r+1)+dx of those rows and leaves the others as
// they are. The ranks of a model group split the rows this way and sum
// their zero-filled volumes (parallel/mesh.py); the full range [0, 2r+1)
// is the whole volume.
//
// Bound on the H100: memory. Reading c1 and warp once and writing the
// volume once moves (2*B*H*W*C + B*H*W*(2r+1)^2) * itemsize bytes for
// 2*B*H*W*C*(2r+1)^2 operations. At PWC's shapes that is at most 16.8
// operations per byte (level 6, C=196, r=4, float32; 33.6 in bfloat16),
// under the card's 20 float32 (295 bfloat16) operations per byte, so
// CUDA-core FMAs keep up with memory if each staged value feeds several.
//
// Design: register tiling over x with asynchronous staging.
// * A thread owns P consecutive output pixels of one output row for one dy
//   and the whole dx band: P*(2r+1) float32 accumulators. Per 4-channel quad
//   it loads P quads of c1 and P+2r quads of warp from shared memory (one
//   16-byte load each in float32, 8 bytes in bfloat16) and issues
//   4*P*(2r+1) FMAs: at P=8, r=4, 24 loads for 288 FMAs.
// * A block covers TY output rows x TX = P*NXG pixels and DYB of the 2r+1
//   dy rows, so one staged halo of TY+DYB-1 warp rows serves TY output rows.
//   The launcher balances TY and NXG to the level and, where the grid would
//   not reach one block per SM (levels 6 to 4), splits the launch's dy rows
//   across blocks and then the channel quads across neighbouring lanes
//   (summed by shuffles). A narrower dy range narrows the grid; the inner
//   loop is the same.
// * The block walks C in chunks of SB bytes per pixel (a power of two from
//   64 to 1024: the largest that keeps a block's shared memory near 100 KB,
//   so two blocks share an SM and the small levels with long C run few
//   chunks), double-buffered with cp.async when there is more than one:
//   chunk k+1 is copied while chunk k is consumed. Taps outside the image
//   and channels past C use cp.async's zero-fill (source size 0), so zero
//   padding costs no branch in the inner loop and no padded copy in device
//   memory. Copies are 16 bytes where the pixel stride and pointers allow,
//   else 8 or 4 (bfloat16 at C=196: a 392-byte stride), else 2
//   (synchronous, odd C in bfloat16). bfloat16 stays bfloat16 in shared
//   memory and is widened to float32 as it is loaded into registers.
// * Shared rows are padded by 16 bytes so that threads of one warp reading
//   neighbouring dy rows hit different banks.
// * Epilogue, 1/C and LeakyReLU(0.1) fused, channels-last: where a block
//   holds all 2r+1 dy rows, its outputs go through shared memory and each output
//   row's contiguous run is written by consecutive threads at consecutive
//   addresses (16-byte stores would need 16-byte-aligned rows, which
//   W*(2r+1)^2 elements do not give). Where dy is split (small levels, or
//   a range short of 2r+1), each thread writes its runs of 2r+1 values
//   straight from registers.
#include <algorithm>
#include <cstdint>
#include <utility>

#include "common.cuh"

namespace {

using udt::ceil_div;
using udt::cp_async_commit;
using udt::cp_async_wait_prior;
using udt::load_quad;

constexpr int kRowPad = 16;              // bytes after each staged row (banks)
constexpr int kMaxThreads = 256;
constexpr int kSmemTarget = 100 * 1024;  // per block: two blocks per SM

// Runtime shape of one launch (see `make_plan`).
struct Tile {
  int H, W, C;
  int ty;        // output rows per block
  int nxg;       // groups of P pixels per block row
  int dyb;       // dy rows per block
  int nd;        // dy groups (blocks along dy)
  int d0, d1;    // the launch's dy rows [d0, d1)
  int qs;        // lanes sharing one (pixel group, dy) over channel quads
  int sb_log2;   // log2 of the bytes of each pixel staged per chunk
  int vb_log2;   // log2 of the staging copy size in bytes (1..4)
  float inv_c;
};

__device__ __forceinline__ float dot4(const float4& a, const float4& w, float s) {
  s = fmaf(a.x, w.x, s);
  s = fmaf(a.y, w.y, s);
  s = fmaf(a.z, w.z, s);
  return fmaf(a.w, w.w, s);
}

// Blocks per SM the compiler must leave registers for: two for the float32
// P=8 kernel. Left alone, ptxas gives it so many registers that one block
// of 180 threads fills an SM's register file; capped at 128 it spills a
// few bytes and still runs levels 3 and 2 faster. bfloat16's P=8 kernel
// needs fewer, which already lets two blocks share an SM.
template <typename T, int P> constexpr int min_blocks() {
  return sizeof(T) == 4 && P == 8 ? 2 : 1;
}

template <typename T, int R, int P>
__global__ void __launch_bounds__(kMaxThreads, min_blocks<T, P>())
cost_volume_kernel(const T* __restrict__ c1, const T* __restrict__ warp, T* __restrict__ out,
                   Tile t) {
  constexpr int D = 2 * R + 1;
  constexpr int K = D * D;
  constexpr int QB = 4 * sizeof(T);            // bytes of a 4-channel quad
  extern __shared__ __align__(16) unsigned char smem[];

  const int sb = 1 << t.sb_log2;
  const int quads = sb / QB;                   // quads per chunk
  const int tx = P * t.nxg;
  const int hx = tx + 2 * R;
  const int hy = t.ty + t.dyb - 1;
  const int wrow = hx * sb + kRowPad;
  const int crow = tx * sb + kRowPad;
  const int stage_bytes = hy * wrow + t.ty * crow;

  const int x0 = blockIdx.x * tx;
  const int y0 = (blockIdx.y / t.nd) * t.ty;
  const int dy0 = t.d0 + (blockIdx.y % t.nd) * t.dyb;
  const long long b = blockIdx.z;

  // thread -> (quad phase, dy, output row, pixel group); quads innermost so
  // the lanes that share a pixel group are neighbours in one warp
  const int qi = threadIdx.x % t.qs;
  int rest = threadIdx.x / t.qs;
  const int dyl = rest % t.dyb;
  rest /= t.dyb;
  const int ty = rest % t.ty;
  const int xg = rest / t.ty;
  const bool active = dy0 + dyl < t.d1;

  float acc[P][D];
#pragma unroll
  for (int p = 0; p < P; ++p)
#pragma unroll
    for (int d = 0; d < D; ++d) acc[p][d] = 0.f;

  const int nchunks = static_cast<int>(
      (static_cast<long long>(t.C) * sizeof(T) + sb - 1) >> t.sb_log2);
  const udt::Staging st{t.H, t.W, t.C, t.sb_log2, t.vb_log2};
  auto stage = [&](int chunk, unsigned char* s) {
    udt::stage_rows<T>(warp, s, st, b, y0 + dy0 - R, x0 - R, hy, hx, wrow, chunk * sb);
    udt::stage_rows<T>(c1, s + hy * wrow, st, b, y0, x0, t.ty, tx, crow, chunk * sb);
  };
  stage(0, smem);
  cp_async_commit();
  for (int k = 0; k < nchunks; ++k) {
    if (k + 1 < nchunks) stage(k + 1, smem + ((k + 1) & 1) * stage_bytes);
    cp_async_commit();              // possibly empty: keeps the wait count uniform
    cp_async_wait_prior();          // chunk k has landed (this thread's copies)
    __syncthreads();                // ... and every thread's
    if (active) {
      const unsigned char* s = smem + (k & 1) * stage_bytes;
      const unsigned char* sw = s + (ty + dyl) * wrow + xg * P * sb;
      const unsigned char* sc = s + hy * wrow + ty * crow + xg * P * sb;
#pragma unroll 1
      for (int q = qi; q < quads; q += t.qs) {
        float4 a[P];
#pragma unroll
        for (int p = 0; p < P; ++p) a[p] = load_quad<T>(sc + p * sb + q * QB);
#pragma unroll
        for (int j = 0; j < P + 2 * R; ++j) {
          const float4 w = load_quad<T>(sw + j * sb + q * QB);
#pragma unroll
          for (int p = 0; p < P; ++p) {
            const int dx = j - p;
            if (dx >= 0 && dx < D) acc[p][dx] = dot4(a[p], w, acc[p][dx]);
          }
        }
      }
    }
    if (k + 1 < nchunks) __syncthreads();   // buffer k&1 is refilled next iteration
  }

  // lanes that split the quads of one (pixel group, dy) sum their partials
  if (t.qs > 1) {
    const int first = threadIdx.x & ~31;
    const int lanes = min(32, static_cast<int>(blockDim.x) - first);
    const unsigned mask = lanes == 32 ? 0xffffffffu : (1u << lanes) - 1u;
    for (int off = t.qs >> 1; off > 0; off >>= 1)
#pragma unroll
      for (int p = 0; p < P; ++p)
#pragma unroll
        for (int dx = 0; dx < D; ++dx) acc[p][dx] += __shfl_xor_sync(mask, acc[p][dx], off);
  }
  if (t.nd == 1 && t.dyb == D) {
    // the block holds every dy, so each of its output rows is one contiguous
    // run of (valid pixels) * K values: stage them in shared memory and
    // write them with consecutive threads at consecutive addresses
    float* so = reinterpret_cast<float*>(smem);
    __syncthreads();                 // every thread is done with the stages
    if (qi == 0) {
#pragma unroll
      for (int p = 0; p < P; ++p)
#pragma unroll
        for (int dx = 0; dx < D; ++dx) so[(ty * tx + xg * P + p) * K + dyl * D + dx] = acc[p][dx];
    }
    __syncthreads();
    const int run = min(tx, t.W - x0) * K;
    for (int row = 0; row < t.ty && y0 + row < t.H; ++row) {
      const float* src = so + row * tx * K;
      T* dst = out + ((b * t.H + y0 + row) * t.W + x0) * K;
      for (int i = threadIdx.x; i < run; i += blockDim.x) {
        const float v = src[i] * t.inv_c;
        dst[i] = udt::from_f<T>(v >= 0.f ? v : 0.1f * v);
      }
    }
    return;
  }
  // dy split across blocks (small levels) or a partial dy range: each
  // thread writes its runs of 2r+1 values straight from registers
  const int y = y0 + ty;
  if (!active || qi != 0 || y >= t.H) return;
  T* dst = out + ((b * t.H + y) * t.W + x0 + xg * P) * K + (dy0 + dyl) * D;
#pragma unroll
  for (int p = 0; p < P; ++p) {
    if (x0 + xg * P + p < t.W) {
#pragma unroll
      for (int dx = 0; dx < D; ++dx) {
        const float v = acc[p][dx] * t.inv_c;
        dst[p * K + dx] = udt::from_f<T>(v >= 0.f ? v : 0.1f * v);
      }
    }
  }
}

struct Plan {
  Tile t;
  int p;           // pixels per thread (template P)
  dim3 grid;
  int threads;
  size_t smem;
};

int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess || n <= 0)
      n = 132;
  }
  return n;
}

// Tile shape for one level: balanced row and pixel-group tiles; the dy rows
// split, while the grid is under one block per SM; the chunk size; then the
// quad split while a block has fewer than four warps. The quad split fixes
// the order of each output's sums, so a range [d0, d1) short of the 2r+1
// rows keeps the whole volume's split (and its bits) and only narrows the
// grid; its blocks hold no more dy rows than the whole volume's.
Plan make_plan(int B, int H, int W, int C, int R, int d0, int d1, int itemsize, int vb_log2) {
  const int D = 2 * R + 1;
  Plan pl;
  pl.p = W >= 64 ? 8 : 4;
  const int groups = ceil_div(W, pl.p);
  int xt = ceil_div(groups, 5);
  const int nxg = ceil_div(groups, xt);
  xt = ceil_div(groups, nxg);
  const int ty_max = R == 4 ? 4 : 8;
  int yt = ceil_div(H, ty_max);
  const int ty = ceil_div(H, yt);
  yt = ceil_div(H, ty);
  const long long base = static_cast<long long>(B) * xt * yt;
  // (dy rows per block, dy groups) for `rows` rows, at most `most` per block
  auto split = [&](int rows, int most) {
    int dyb = std::min(rows, most);
    while (dyb > 1 && base * ceil_div(rows, dyb) < sm_count()) --dyb;
    const int nd = ceil_div(rows, dyb);
    return std::make_pair(ceil_div(rows, nd), nd);   // balance the dy groups
  };

  const int tx = pl.p * nxg;
  const int pix_bytes = C * itemsize;
  auto smem_for = [&](int sb, int dyb) {
    const size_t stage = static_cast<size_t>(ty + dyb - 1) * ((tx + 2 * R) * sb + kRowPad) +
                         static_cast<size_t>(ty) * (tx * sb + kRowPad);
    return (pix_bytes > sb ? 2 : 1) * stage;
  };
  auto chunk_log2 = [&](int dyb) {
    int sb_log2 = 6;
    while (sb_log2 < 10 && (1 << sb_log2) < pix_bytes &&
           smem_for(2 << sb_log2, dyb) <= kSmemTarget)
      ++sb_log2;
    return sb_log2;
  };

  // the whole volume's plan fixes the quad split
  const auto all = split(D, D);
  const int dyb_all = all.first;
  const int quads = (1 << chunk_log2(dyb_all)) / (4 * itemsize);
  const int threads_all = dyb_all * ty * nxg;
  int qs = 1;
  while (qs < quads && qs < 32 && threads_all * qs < 128 && threads_all * qs * 2 <= kMaxThreads)
    qs *= 2;

  const auto [dyb, nd] = d1 - d0 == D ? all : split(d1 - d0, dyb_all);
  const int sb_log2 = chunk_log2(dyb);
  pl.t = Tile{H, W, C, ty, nxg, dyb, nd, d0, d1, qs, sb_log2, vb_log2,
              static_cast<float>(1.0 / static_cast<double>(C))};
  pl.grid = dim3(xt, yt * nd, B);
  pl.threads = qs * dyb * ty * nxg;
  const size_t epilogue =
      nd == 1 && dyb == D ? static_cast<size_t>(ty) * tx * D * D * sizeof(float) : 0;
  pl.smem = std::max(smem_for(1 << sb_log2, dyb), epilogue);
  return pl;
}

template <typename T, int R, int P>
cudaError_t launch_p(const Plan& pl, const void* c1, const void* warp, void* out,
                     cudaStream_t stream) {
  static size_t smem_set = 0;   // 0: attributes not set yet
  if (pl.threads > kMaxThreads || pl.grid.y > 65535) return cudaErrorInvalidConfiguration;
  if (smem_set == 0) {
    // the whole of L1 as shared memory, so two blocks of ~100 KB share an SM
    const cudaError_t e = cudaFuncSetAttribute(cost_volume_kernel<T, R, P>,
                                               cudaFuncAttributePreferredSharedMemoryCarveout,
                                               cudaSharedmemCarveoutMaxShared);
    if (e != cudaSuccess) return e;
    smem_set = 48 * 1024;   // the default limit of dynamic shared memory
  }
  if (pl.smem > smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        cost_volume_kernel<T, R, P>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(pl.smem));
    if (e != cudaSuccess) return e;
    smem_set = pl.smem;
  }
  cost_volume_kernel<T, R, P><<<pl.grid, pl.threads, pl.smem, stream>>>(
      static_cast<const T*>(c1), static_cast<const T*>(warp), static_cast<T*>(out), pl.t);
  return cudaGetLastError();
}

template <typename T, int R>
cudaError_t launch(const void* c1, const void* warp, void* out, int B, int H, int W, int C,
                   int d0, int d1, cudaStream_t stream) {
  // widest copy that the pixel stride and both pointers are aligned to
  const int vb_log2 = udt::copy_log2(c1, warp, static_cast<long long>(C) * sizeof(T));
  if (vb_log2 < 0) return cudaErrorMisalignedAddress;
  const Plan pl = make_plan(B, H, W, C, R, d0, d1, sizeof(T), vb_log2);
  if (pl.p == 8) return launch_p<T, R, 8>(pl, c1, warp, out, stream);
  return launch_p<T, R, 4>(pl, c1, warp, out, stream);
}

}  // namespace

// c1, warp: (B,H,W,C) contiguous, dtype code `dtype`; out: (B,H,W,(2r+1)^2),
// of which the launch writes the channels of the dy rows [d0, d1),
// 0 <= d0 < d1 <= 2r+1. Returns the cudaError_t of the launch (0 on success).
extern "C" int udt_cost_volume(const void* c1, const void* warp, void* out, int B,
                               int H, int W, int C, int r, int d0, int d1, int dtype,
                               void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0 || B > 65535) return cudaErrorInvalidValue;
  if (d0 < 0 || d1 <= d0 || d1 > 2 * r + 1) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == udt::kFloat32 && r == 4)
    return launch<float, 4>(c1, warp, out, B, H, W, C, d0, d1, s);
  if (dtype == udt::kFloat32 && r == 2)
    return launch<float, 2>(c1, warp, out, B, H, W, C, d0, d1, s);
  if (dtype == udt::kBFloat16 && r == 4)
    return launch<__nv_bfloat16, 4>(c1, warp, out, B, H, W, C, d0, d1, s);
  if (dtype == udt::kBFloat16 && r == 2)
    return launch<__nv_bfloat16, 2>(c1, warp, out, B, H, W, C, d0, d1, s);
  return cudaErrorInvalidValue;
}
