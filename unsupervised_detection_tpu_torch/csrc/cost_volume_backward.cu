// PWC cost volume, backward, for sm_90a.
//
// No TPU kernel has this job: the JAX package differentiates the cost
// volume with XLA (the VJP of `_cost_volume_xla`,
// unsupervised_detection_tpu/ops/cost_volume.py:57-86; the Pallas forward
// `cost_volume_pallas` has no VJP). PWC pretraining back-propagates through
// it, so the port computes that VJP on the card:
//
//   g'[b,y,x,k]      = g[b,y,x,k] * (out[b,y,x,k] >= 0 ? 1 : 0.1) / C
//   g_c1[b,y,x,c]    = sum_k g'[b,y,x,k] * warp[b, y+dy-r, x+dx-r, c]
//   g_warp[b,y,x,c]  = sum_k g'[b, y-dy+r, x-dx+r, k] * c1[b, y-dy+r, x-dx+r, c]
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
// (bfloat16) operations per byte. Without tensor cores the FMAs alone take
// a PWC pretraining step's 4.52 GFLOP 0.068 ms at 67 TFLOP/s, above
// bfloat16's byte bound.
//
// Design: the forward's family (csrc/cost_volume.cu): register tiles over x
// and rows staged in shared memory with cp.async.
// * Both gradients are gathers summed over k, not over c, so channels are
//   independent: a block takes one chunk of NQ channel quads (NQ a power of
//   two up to 8; the chunks of C go to different blocks along grid z, with
//   no reduction between blocks) for TY output rows x TX = P*NXG pixels.
// * A thread owns P consecutive pixels of one row and one 4-channel quad,
//   with 2*P float4 accumulators (g_c1 and g_warp). It walks dy; for each
//   dy it loads P+2r quads of the warp row y+dy-r and P+2r quads of the c1
//   row y-dy+r from shared memory (one 16-byte load each in float32, 8
//   bytes in bfloat16) and g' of its P pixels for both gradients (float4
//   loads, 2r+1 values padded to a multiple of 4), and issues 8*P*(2r+1)
//   FMAs: at P=8, r=4, 80 loads for 576 FMAs.
// * g' is computed once per (pixel, k) and gradient at staging: the slope
//   and 1/C are applied when g and out are read, not once per channel. For
//   each dy the block stages g'[y, x, dy, 0..2r] for its own pixels (g_c1)
//   and g'[y-dy+r, x-dx+r, dy, dx] for each dx (g_warp: gathered at
//   staging, so the inner loop reads both gradients' g' the same way).
//   Lanes run along the 2r+1 contiguous values of a pixel's dy row, so the
//   reads of g and out coalesce (one lane per pixel instead made each warp
//   load touch 32 sectors 324 bytes apart: PERF.md §6). Pixel groups' g'
//   are 16 bytes apart in the banks, so the four groups that a warp's
//   quarters read are served at once.
// * Staging of c1 and warp. For one dy the block reads TY rows of each
//   (warp rows y0+dy-r.., c1 rows y0-dy+r..); from dy to dy+1 the warp
//   window moves down one row and the c1 window up one. Chosen layout,
//   "ring": TY+1 row slots per input; each dy copies the one row that
//   enters each window into the slot that the row leaving it frees, with
//   cp.async (16-byte copies where the pixel stride and pointers allow,
//   else 8 or 4, else synchronous 2-byte ones: bfloat16 at C=196 and odd C;
//   zero-fill outside the image and past C), in flight while the block
//   stages g'. Each row of c1 and warp then comes from L2 once per block
//   ((TY+2r)/TY times per element), where re-staging the TY rows per dy
//   (2*TY slots, double-buffered) reads it (2r+1) times: measured on an
//   H100 at a PWC pretraining step's shapes (batch 16, r=4), the ring took
//   0.633 ms (float32) and 0.566 ms (bfloat16) per step, re-staging 1.057
//   and 0.690, slower at every level (PERF.md §6). Staging the whole
//   (TY+2r)-row halo once per chunk reads as little as the ring but holds
//   2r-1 more rows, and with g' for the whole halo at all K values it would
//   not fit (TY=8, TX=32, r=4: 207 KB).
// * Tile plan per level: (P, NXG) minimising the staged columns per output
//   pixel; TY up to 4 rows, as tall as 128 threads and ~72 KB of shared
//   memory allow, so three blocks share an SM.
// * Sums in a fixed order, no atomics: the same bits on every run.
#include <algorithm>
#include <cstdint>

#include "common.cuh"

namespace {

using udt::ceil_div;
using udt::cp_async_commit;
using udt::cp_async_wait_prior;
using udt::load_quad;

constexpr int kRowPad = 16;             // bytes after each staged row (banks)
constexpr int kMaxThreads = 128;
constexpr int kSmemTarget = 72 * 1024;  // per block: three blocks per SM
constexpr int kMaxQuads = 8;            // channel quads per block
constexpr int kRows = 4;                // output rows per block, at most
constexpr int kCols = 6;                // g' column entries a thread loads at once

// Runtime shape of one launch (see `make_plan`).
struct Tile {
  int H, W, C;
  int ty;        // output rows per block
  int nxg;       // groups of P pixels per block row
  int nq_log2;   // log2 of the channel quads per block (lanes per pixel group)
  int nchunks;   // channel chunks (blocks along z per image)
  int cb_log2;   // log2 of the bytes of each pixel staged (NQ quads)
  int vb_log2;   // log2 of the staging copy size in bytes (1..4)
  int vec_out;   // 1: quad stores (C % 4 == 0, aligned outputs)
  float inv_c;
};

__device__ __forceinline__ float4 fma4(float a, const float4& w, float4 s) {
  s.x = fmaf(a, w.x, s.x);
  s.y = fmaf(a, w.y, s.y);
  s.z = fmaf(a, w.z, s.z);
  s.w = fmaf(a, w.w, s.w);
  return s;
}

// The first n (1..4) channels of a quad, at dst.
template <typename T>
__device__ __forceinline__ void store_quad(T* dst, const float4& v, int n, bool vec) {
  if (vec) {
    if constexpr (sizeof(T) == 4) {
      *reinterpret_cast<float4*>(dst) = v;
    } else {
      const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
      const __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
      *reinterpret_cast<uint2*>(dst) = make_uint2(*reinterpret_cast<const uint32_t*>(&lo),
                                                  *reinterpret_cast<const uint32_t*>(&hi));
    }
    return;
  }
  const float e[4] = {v.x, v.y, v.z, v.w};
  for (int i = 0; i < n && i < 4; ++i) dst[i] = udt::from_f<T>(e[i]);
}

// g' values per pixel: the 2R+1 of one dy row, padded to float4s
template <int R> __host__ __device__ constexpr int padded_d() { return (2 * R + 1 + 3) & ~3; }
// floats of g' per pixel group: P pixels of padded_d values, plus 4 so
// that neighbouring groups start 16 bytes apart in the banks
template <int R, int P> __host__ __device__ constexpr int group_floats() {
  return P * padded_d<R>() + 4;
}

// One gradient's products for one step: P+2R quads of a staged row (one
// quad of columns x-R .. x+P-1+R) and the g' of P pixels (padded_d values
// each). Tap dx of pixel p reads column p+dx (g_c1) or p-dx+2R (g_warp).
template <typename T, int R, int P, bool kWarp>
__device__ __forceinline__ void band(const unsigned char* row, int cb, const float* gp,
                                     float4 (&acc)[P]) {
  constexpr int DP = padded_d<R>();
  float4 q[P + 2 * R];
#pragma unroll
  for (int j = 0; j < P + 2 * R; ++j) q[j] = load_quad<T>(row + j * cb);
#pragma unroll
  for (int p = 0; p < P; ++p) {
    float v[DP];
#pragma unroll
    for (int j = 0; j < DP; j += 4) {
      const float4 f = *reinterpret_cast<const float4*>(gp + p * DP + j);
      v[j] = f.x, v[j + 1] = f.y, v[j + 2] = f.z, v[j + 3] = f.w;
    }
#pragma unroll
    for (int dx = 0; dx <= 2 * R; ++dx)
      acc[p] = fma4(v[dx], q[kWarp ? p - dx + 2 * R : p + dx], acc[p]);
  }
}

template <typename T, int R, int P>
__global__ void __launch_bounds__(kMaxThreads, 3)
cost_volume_backward_kernel(const T* __restrict__ c1, const T* __restrict__ warp,
                            const T* __restrict__ out, const T* __restrict__ g,
                            T* __restrict__ g_c1, T* __restrict__ g_warp, Tile t) {
  constexpr int D = 2 * R + 1;
  constexpr int K = D * D;
  constexpr int DP = padded_d<R>();
  constexpr int GS = group_floats<R, P>();
  constexpr int QB = 4 * sizeof(T);            // bytes of a 4-channel quad
  extern __shared__ __align__(16) unsigned char smem[];

  const int cb = 1 << t.cb_log2;
  const int tx = P * t.nxg;
  const int hx = tx + 2 * R;
  const int srow = hx * cb + kRowPad;
  const int slots = t.ty + 1;
  unsigned char* ring_w = smem;
  unsigned char* ring_c = smem + slots * srow;
  float* gs_c1 = reinterpret_cast<float*>(smem + 2 * slots * srow);
  float* gs_w = gs_c1 + t.ty * t.nxg * GS;

  const int x0 = blockIdx.x * tx;
  const int y0 = blockIdx.y * t.ty;
  const int chunk = blockIdx.z % t.nchunks;
  const long long b = blockIdx.z / t.nchunks;
  const int cb0 = chunk * cb;

  // thread -> (quad, pixel group, row); quads innermost so the lanes that
  // share a pixel group (and its g') are neighbours in one warp
  const int nq = 1 << t.nq_log2;
  const int qi = threadIdx.x & (nq - 1);
  const int rest = threadIdx.x >> t.nq_log2;
  const int xg = rest % t.nxg;
  const int ty = rest / t.nxg;

  // Window row i is warp row y0-R+i and c1 row y0+R+TY-1-i, in slot
  // i % (TY+1); the rows of step dy are i in [dy, dy+TY).
  const udt::Staging st{t.H, t.W, t.C, t.cb_log2, t.vb_log2};
  auto stage_row = [&](int i) {
    const int s = i % (t.ty + 1);
    udt::stage_rows<T>(warp, ring_w + s * srow, st, b, y0 - R + i, x0 - R, 1, hx, srow, cb0);
    udt::stage_rows<T>(c1, ring_c + s * srow, st, b, y0 + R + t.ty - 1 - i, x0 - R, 1, hx,
                       srow, cb0);
  };
  // g' of step dy for both gradients. Column entry j = (gradient, column
  // s, dx), dx fastest: g_c1 takes column s of the tile (its own pixels),
  // g_warp column s of the halo (x0-R+s), whose value at dx feeds tile
  // column s+dx-2R. Consecutive lanes thus read consecutive values of g and
  // out (the 2R+1 of one dy row of a pixel are contiguous). A thread takes
  // column entries j = tid, tid+blockDim, ..., each for the TY (<= kRows)
  // rows, and issues the loads of kCols of them (2*kCols*kRows values)
  // before it converts any: one round trip to memory per step at PWC's
  // shapes.
  const int n_c1 = tx * D;
  const int n_all = n_c1 + hx * D;
  const int row_step = t.W * K;
  const T* g_img = g + b * t.H * row_step;
  const T* out_img = out + b * t.H * row_step;
  auto stage_g = [&](int dy) {
    for (int j0 = threadIdx.x; j0 < n_all; j0 += kCols * blockDim.x) {
      float gv[kCols][kRows], ov[kCols][kRows];
      int dst[kCols];
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const int j = j0 + c * blockDim.x;
        const bool for_warp = j >= n_c1;
        const int jj = for_warp ? j - n_c1 : j;
        const int s = jj / D;
        const int dx = jj - s * D;
        const int x = for_warp ? s + dx - 2 * R : s;   // tile column fed
        const int sx = x0 + s - (for_warp ? R : 0);
        const int sy0 = y0 + (for_warp ? R - dy : 0);
        const bool used = j < n_all && x >= 0 && x < tx;   // feeds a tile column
        const bool col_ok = used && sx >= 0 && sx < t.W;
        dst[c] = used ? (for_warp ? t.ty * t.nxg * GS : 0) + (x / P) * GS + (x % P) * DP + dx
                      : -1;
        const int e0 = (sy0 * t.W + sx) * K + dy * D + dx;
#pragma unroll
        for (int u = 0; u < kRows; ++u) {
          const int sy = sy0 + u;
          const bool ok = col_ok && u < t.ty && sy >= 0 && sy < t.H;
          gv[c][u] = ok ? udt::to_f(g_img[e0 + u * row_step]) : 0.f;
          ov[c][u] = ok ? udt::to_f(out_img[e0 + u * row_step]) : 0.f;
        }
      }
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        if (dst[c] < 0) continue;
#pragma unroll
        for (int u = 0; u < kRows; ++u)
          if (u < t.ty)
            gs_c1[dst[c] + u * t.nxg * GS] =
                (ov[c][u] >= 0.f ? gv[c][u] : gv[c][u] * 0.1f) * t.inv_c;
      }
    }
  };

  float4 acc_c[P], acc_w[P];
#pragma unroll
  for (int p = 0; p < P; ++p) {
    acc_c[p] = make_float4(0.f, 0.f, 0.f, 0.f);
    acc_w[p] = make_float4(0.f, 0.f, 0.f, 0.f);
  }

  for (int i = 0; i < t.ty; ++i) stage_row(i);
  cp_async_commit();
#pragma unroll 1
  for (int dy = 0; dy < D; ++dy) {
    if (dy + 1 < D) stage_row(dy + t.ty);   // the row step dy+1 adds
    cp_async_commit();              // possibly empty: keeps the wait count uniform
    stage_g(dy);                    // synchronous, while the copies fly
    cp_async_wait_prior();          // the rows of step dy have landed (this thread's)
    __syncthreads();                // ... and every thread's, and g'

    // g_c1 from warp row y+dy-R, g_warp from c1 row y-dy+R; columns x-R ..
    // x+P-1+R of each
    const int off = xg * P * cb + qi * QB;
    const int group = (ty * t.nxg + xg) * GS;
    band<T, R, P, false>(ring_w + (dy + ty) % (t.ty + 1) * srow + off, cb, gs_c1 + group,
                         acc_c);
    band<T, R, P, true>(ring_c + (t.ty - 1 + dy - ty) % (t.ty + 1) * srow + off, cb,
                        gs_w + group, acc_w);
    __syncthreads();                // slots and g' are refilled next step
  }

  const int y = y0 + ty;
  const int c = (chunk << t.nq_log2 | qi) * 4;   // first channel of the quad
  if (y >= t.H || c >= t.C) return;
  const long long row = (b * t.H + y) * t.W;
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const int x = x0 + xg * P + p;
    if (x < t.W) {
      const long long e = (row + x) * t.C + c;
      store_quad<T>(g_c1 + e, acc_c[p], t.C - c, t.vec_out);
      store_quad<T>(g_warp + e, acc_w[p], t.C - c, t.vec_out);
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

template <int R, int P>
size_t smem_bytes(int ty, int nxg, int cb) {
  const size_t srow = static_cast<size_t>(P * nxg + 2 * R) * cb + kRowPad;
  return 2 * (ty + 1) * srow + 2 * static_cast<size_t>(ty) * nxg * group_floats<R, P>() * 4;
}

template <int R>
size_t smem_for(int p, int ty, int nxg, int cb) {
  return p == 8 ? smem_bytes<R, 8>(ty, nxg, cb) : smem_bytes<R, 4>(ty, nxg, cb);
}

// Tile shape for one level: (P, NXG) with the fewest staged columns per
// output pixel (covered width over W times (TX+2R)/TX; ties keep the wider
// tile); the channel quads per block; then TY as tall as the thread and
// shared-memory budgets allow, balanced over H.
template <int R>
Plan make_plan(int B, int H, int W, int C, int itemsize, int vb_log2) {
  Plan pl;
  double best = 1e30;
  int nxg = 1;
  pl.p = 4;
  for (int p : {8, 4}) {
    for (int n = 4; n >= 1; --n) {
      const int tx = p * n;
      const double cost = static_cast<double>(ceil_div(W, tx) * tx) / W * (tx + 2 * R) / tx;
      if (cost < best - 1e-9) best = cost, pl.p = p, nxg = n;
    }
  }
  const int quads = ceil_div(C, 4);
  int nq_log2 = 0;
  while ((1 << nq_log2) < quads && (1 << nq_log2) < kMaxQuads) ++nq_log2;
  const int cb = (4 * itemsize) << nq_log2;
  int cb_log2 = 0;
  while ((1 << cb_log2) < cb) ++cb_log2;
  vb_log2 = std::min(vb_log2, cb_log2);

  int ty = std::min(H, kRows);
  while (ty > 1 && ((ty * nxg << nq_log2) > kMaxThreads ||
                    smem_for<R>(pl.p, ty, nxg, cb) > kSmemTarget))
    --ty;
  int yt = ceil_div(H, ty);
  ty = ceil_div(H, yt);
  yt = ceil_div(H, ty);
  const int tx = pl.p * nxg;
  const int nchunks = ceil_div(quads, 1 << nq_log2);
  pl.t = Tile{H, W, C, ty, nxg, nq_log2, nchunks, cb_log2, vb_log2, 0,
              static_cast<float>(1.0 / static_cast<double>(C))};
  pl.grid = dim3(ceil_div(W, tx), yt, B * nchunks);
  pl.threads = ty * nxg << nq_log2;
  pl.smem = smem_for<R>(pl.p, ty, nxg, cb);
  return pl;
}

template <typename T, int R, int P>
cudaError_t launch_p(const Plan& pl, const void* c1, const void* warp, const void* out,
                     const void* g, void* g_c1, void* g_warp, cudaStream_t stream) {
  static size_t smem_set = 0;   // 0: attributes not set yet
  // offsets into one image of g and out are 32-bit
  if (pl.threads > kMaxThreads || pl.grid.y > 65535 || pl.grid.z > 65535 ||
      static_cast<long long>(pl.t.H) * pl.t.W * (2 * R + 1) * (2 * R + 1) > 0x7fffffffLL)
    return cudaErrorInvalidConfiguration;
  if (smem_set == 0) {
    // the whole of L1 as shared memory, so three blocks of ~70 KB share an SM
    const cudaError_t e = cudaFuncSetAttribute(cost_volume_backward_kernel<T, R, P>,
                                               cudaFuncAttributePreferredSharedMemoryCarveout,
                                               cudaSharedmemCarveoutMaxShared);
    if (e != cudaSuccess) return e;
    smem_set = 48 * 1024;   // the default limit of dynamic shared memory
  }
  if (pl.smem > smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        cost_volume_backward_kernel<T, R, P>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(pl.smem));
    if (e != cudaSuccess) return e;
    smem_set = pl.smem;
  }
  cost_volume_backward_kernel<T, R, P><<<pl.grid, pl.threads, pl.smem, stream>>>(
      static_cast<const T*>(c1), static_cast<const T*>(warp), static_cast<const T*>(out),
      static_cast<const T*>(g), static_cast<T*>(g_c1), static_cast<T*>(g_warp), pl.t);
  return cudaGetLastError();
}

template <typename T, int R>
cudaError_t launch(const void* c1, const void* warp, const void* out, const void* g, void* g_c1,
                   void* g_warp, int B, int H, int W, int C, cudaStream_t stream) {
  const long long pix_bytes = static_cast<long long>(C) * sizeof(T);
  const int vb_log2 = udt::copy_log2(c1, warp, pix_bytes);
  if (vb_log2 < 0) return cudaErrorMisalignedAddress;
  Plan pl = make_plan<R>(B, H, W, C, sizeof(T), vb_log2);
  const uintptr_t outs = reinterpret_cast<uintptr_t>(g_c1) | reinterpret_cast<uintptr_t>(g_warp);
  pl.t.vec_out = C % 4 == 0 && (outs & (4 * sizeof(T) - 1)) == 0;
  if (pl.p == 8) return launch_p<T, R, 8>(pl, c1, warp, out, g, g_c1, g_warp, stream);
  return launch_p<T, R, 4>(pl, c1, warp, out, g, g_c1, g_warp, stream);
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
