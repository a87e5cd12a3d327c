// The dense shifted-tap matcher (mast3r_slam_torch/ops/match_taps.py).
//
// Replaces no Pallas kernel: the JAX package leaves this loop to XLA
// (mast3r_slam_tpu/ops/dense_match.py `match_dense_window`). The port's plain
// loop (ops/dense_match.py `_match_dense_loop`) issues ~17 PyTorch kernels a
// tap: at radius 3 over dilations (2, 1), 89 taps, ~1,560 kernels a frame,
// each tap writing and reducing a [B, H, W, 24] f32 product. It is bound by
// those launches and that traffic, ~8 ms a frame at 512x384, so this kernel
// does the whole tap loop, the occlusion gate, the payload and the hit mask in
// one launch.
//
// What bounds it on the card: the work is ~89 taps x 27 channels a pixel,
// ~1.1 G f32 operations at 512x384 (plus the conversions of the bf16 tile to
// f32), ~20-40 us of the card's 67 TFLOP/s and its issue rate; the taps read
// ~1.0 GB of shared memory (56 bytes a tap a pixel), ~35 us at 128 bytes a
// clock an SM. Device memory is read and written once, ~50 MB, ~15 us at
// 3.35 TB/s. So the instruction issue and the shared-memory reads bound it,
// not the bytes.
//
// Design (grid: 32 x 8 pixel tiles x streams B; 256 threads, one view-2 pixel
// each):
//   * the block stages view 1's tile and its halo (the lattice's reach on
//     every side, outside the image the plain loop's padding: rays BIG in
//     bf16, descriptors 0) in shared memory as bf16: rays [px][4] (8 bytes)
//     and descriptors [px][3][8] (three 16-byte chunks, zeros beyond the
//     descriptor's channels: 48 bytes a pixel, so the eight lanes of a 16-byte
//     load phase hit eight distinct bank quads). The rays come from the wrapper's bf16 streams
//     (normalize_rays then .to(bfloat16), so they are bit for bit the loop's);
//     the descriptors are rounded here (__float2bfloat16_rn, the same
//     round-to-nearest-even as .to(bfloat16));
//   * each thread keeps its view-2 pixel's rays and descriptor in f32
//     registers and walks the taps in `window_taps` order, from a table in
//     the kernel's parameters (the shared-tile offset of each tap). The
//     arithmetic is the loop's, in f32 without contraction: the ray
//     difference, its square and its 3-term sum (__fsub_rn, __fmul_rn,
//     __fadd_rn), the 24-term product sum (fmaf: a product of two bf16 values
//     is exact in f32, so fmaf(a, b, s) rounds once, as __fadd_rn(__fmul_rn(a,
//     b), s) does), then cost - desc_weight * sum. Only the order of the two
//     sums differs from the loop's. A tap replaces the best only on a
//     strictly lower cost, so the first tap wins ties; the best starts at
//     BIG, so a cost that is NaN or >= BIG (any tap outside the image) never
//     wins;
//   * the epilogue writes idx (the clamped v * W + u; a pixel that took no
//     tap keeps its own index), valid (|X11[idx] - X21| < dist_thresh on the
//     unrounded f32 points, and a tap taken), the payload at the winning tap
//     rounded to bf16 (zeros where none was taken) and, for a valid match,
//     a 1 into the zeroed hit mask at idx: every writer stores the same byte,
//     so no atomics are needed and every run gives the same bits.
// No host read and no allocation: the wrapper allocates the outputs, so a
// call captures into a CUDA graph.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <stdlib.h>

namespace {

constexpr int kTileW = 32;       // ops/match_taps.py TILE_W
constexpr int kTileH = 8;        // TILE_H
constexpr int kThreads = kTileW * kTileH;
constexpr int kMaxTaps = 512;    // MAX_TAPS
constexpr int kChunks = 3;       // CHUNKS: 16-byte chunks of 8 bf16, up to 24 channels
constexpr int kMaxShared = 232448;  // SHARED_LIMIT: 227 KB, what a block may use on an H100
constexpr int kViews = 7;        // X11, X21, D11, D21, payload, rays 1, rays 2
constexpr float kBig = 1e30f;    // ops/dense_match.py BIG

struct View {  // a [B, H, W, C] tensor through element strides
  const void* p;
  long long sb, sy, sx, sc;
};

struct Params {
  View X1, X2, D1, D2, pay, r1, r2;
  long long* idx;
  unsigned char* valid;
  __nv_bfloat16* pay_g;
  unsigned char* hit;
  int H, W, D, P, reach, ntaps;
  float desc_weight, dist_thresh;
  int off[kMaxTaps];  // shared-tile offset of each tap: dv * (kTileW + 2 reach) + du
  signed char du[kMaxTaps], dv[kMaxTaps];
};
static_assert(sizeof(Params) <= 4096, "kernel parameters are limited to 4 KB");

__device__ __forceinline__ float lo(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float hi(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }

__device__ __forceinline__ uint32_t bf16_bits(float v) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}

__device__ __forceinline__ uint32_t pack(float a, float b) {  // a in the low half
  return bf16_bits(a) | (bf16_bits(b) << 16);
}

__device__ __forceinline__ long long at(const View& v, int b, int y, int x, int c) {
  return b * v.sb + y * v.sy + x * v.sx + c * v.sc;
}

__device__ __forceinline__ float ldf(const View& v, int b, int y, int x, int c) {
  return __ldg(static_cast<const float*>(v.p) + at(v, b, y, x, c));
}

__device__ __forceinline__ uint32_t ldh(const View& v, int b, int y, int x, int c) {
  return __ldg(static_cast<const unsigned short*>(v.p) + at(v, b, y, x, c));
}

template <int KC>  // descriptor chunks a pixel: kChunks, or 0 where the rays alone set the cost
__global__ void __launch_bounds__(kThreads, 2) match_taps_kernel(const __grid_constant__ Params p) {
  extern __shared__ uint4 smem[];
  const int R = p.reach, SW = kTileW + 2 * R, npix = SW * (kTileH + 2 * R);
  uint4* desc_s = smem;                                        // [npix][KC]
  uint2* ray_s = reinterpret_cast<uint2*>(smem + npix * KC);   // [npix]
  const int b = blockIdx.z, tid = threadIdx.x;
  const int x0 = blockIdx.x * kTileW - R, y0 = blockIdx.y * kTileH - R;  // the halo's corner

  const uint32_t big = bf16_bits(kBig);
  for (int i = tid; i < npix; i += kThreads) {
    const int gy = y0 + i / SW, gx = x0 + i % SW;
    uint2 r = make_uint2(big | (big << 16), big);
    if (gy >= 0 && gy < p.H && gx >= 0 && gx < p.W) {
      r.x = ldh(p.r1, b, gy, gx, 0) | (ldh(p.r1, b, gy, gx, 1) << 16);
      r.y = ldh(p.r1, b, gy, gx, 2);
    }
    ray_s[i] = r;
  }
  if (KC > 0) {
    constexpr int kc = KC > 0 ? KC : 1;  // no division by zero where KC is 0
    for (int i = tid; i < npix * kc; i += kThreads) {
      const int px = i / kc, c0 = (i - px * kc) * 8;
      const int gy = y0 + px / SW, gx = x0 + px % SW;
      const bool in = gy >= 0 && gy < p.H && gx >= 0 && gx < p.W;
      float v[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) v[j] = in && c0 + j < p.D ? ldf(p.D1, b, gy, gx, c0 + j) : 0.0f;
      desc_s[i] =
          make_uint4(pack(v[0], v[1]), pack(v[2], v[3]), pack(v[4], v[5]), pack(v[6], v[7]));
    }
  }

  // This thread's view-2 pixel, rounded to bf16 once and held in f32.
  const int lx = tid % kTileW, ly = tid / kTileW;
  const int x = x0 + R + lx, y = y0 + R + ly;
  const bool live = x < p.W && y < p.H;
  float r2[3] = {0.0f, 0.0f, 0.0f};
  float d2[KC > 0 ? 8 * KC : 1];
#pragma unroll
  for (int c = 0; c < (KC > 0 ? 8 * KC : 1); ++c) d2[c] = 0.0f;
  if (live) {
#pragma unroll
    for (int c = 0; c < 3; ++c) r2[c] = __uint_as_float(ldh(p.r2, b, y, x, c) << 16);
#pragma unroll
    for (int c = 0; c < 8 * KC; ++c)
      if (c < p.D) d2[c] = lo(bf16_bits(ldf(p.D2, b, y, x, c)));
  }
  __syncthreads();
  if (!live) return;

  const int centre = (ly + R) * SW + lx + R;
  float best = kBig;
  int best_t = -1;
#pragma unroll 2
  for (int t = 0; t < p.ntaps; ++t) {
    const int q = centre + p.off[t];
    const uint2 r = ray_s[q];
    const float ex = __fsub_rn(lo(r.x), r2[0]);
    const float ey = __fsub_rn(hi(r.x), r2[1]);
    const float ez = __fsub_rn(lo(r.y), r2[2]);
    float cost = __fadd_rn(__fadd_rn(__fmul_rn(ex, ex), __fmul_rn(ey, ey)), __fmul_rn(ez, ez));
    if (KC > 0) {
      float s = 0.0f;
#pragma unroll
      for (int k = 0; k < KC; ++k) {
        const uint4 w = desc_s[q * KC + k];
        const uint32_t ws[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s = fmaf(lo(ws[j]), d2[8 * k + 2 * j], s);
          s = fmaf(hi(ws[j]), d2[8 * k + 2 * j + 1], s);
        }
      }
      cost = __fsub_rn(cost, __fmul_rn(p.desc_weight, s));
    }
    if (cost < best) {
      best = cost;
      best_t = t;
    }
  }

  const bool taken = best_t >= 0;
  const int u = min(max(x + (taken ? p.du[best_t] : 0), 0), p.W - 1);
  const int v = min(max(y + (taken ? p.dv[best_t] : 0), 0), p.H - 1);
  const long long plane = static_cast<long long>(b) * p.H * p.W;
  const long long row = plane + static_cast<long long>(y) * p.W + x;
  const long long m = static_cast<long long>(v) * p.W + u;
  float g[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) g[c] = __fsub_rn(ldf(p.X1, b, v, u, c), ldf(p.X2, b, y, x, c));
  const float dist =
      __fsqrt_rn(__fadd_rn(__fadd_rn(__fmul_rn(g[0], g[0]), __fmul_rn(g[1], g[1])),
                           __fmul_rn(g[2], g[2])));
  const bool ok = taken && dist < p.dist_thresh;
  p.idx[row] = m;
  p.valid[row] = ok;
  if (p.pay_g != nullptr) {
    for (int c = 0; c < p.P; ++c)
      p.pay_g[row * p.P + c] = __float2bfloat16_rn(taken ? ldf(p.pay, b, v, u, c) : 0.0f);
  }
  if (p.hit != nullptr && ok) p.hit[plane + m] = 1;
}

View view(const void* ptr, const long long* s) { return View{ptr, s[0], s[1], s[2], s[3]}; }

}  // namespace

// Match B view-2 images to view-1 images of H x W pixels over `ntaps` taps
// (du, dv), in order. `ptrs` holds 7 device pointers, `strides` 7 x 4 element
// strides (batch, row, column, channel), in this order: X11, X21 [B, H, W, 3]
// f32, D11, D21 [B, H, W, D] f32, the payload [B, H, W, P] f32 (null when P is
// 0), the rays of view 1 and of view 2 [B, H, W, 3] bf16. `chunks` is 3
// (D at most 24, the chunks zero-padded beyond it), or 0 when desc_weight is
// not positive (the costs come from the rays alone). Outputs: idx [B, H*W]
// int64, valid [B, H*W] bool, pay_g [B, H*W, P] bf16 (null when P is 0), hit
// [B, H*W] bool zeroed by the caller (null: not wanted). Returns a
// cudaError_t.
extern "C" int match_taps(void* stream, int B, int H, int W, int D, int P, int chunks,
                          int ntaps, const signed char* du, const signed char* dv,
                          float desc_weight, float dist_thresh, const void* const* ptrs,
                          const long long* strides, void* idx, void* valid, void* pay_g,
                          void* hit) {
  if (ntaps < 1 || ntaps > kMaxTaps || (chunks != 0 && chunks != kChunks) || D > 8 * kChunks) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p;
  View* views[kViews] = {&p.X1, &p.X2, &p.D1, &p.D2, &p.pay, &p.r1, &p.r2};
  for (int i = 0; i < kViews; ++i) *views[i] = view(ptrs[i], strides + 4 * i);
  p.idx = static_cast<long long*>(idx);
  p.valid = static_cast<unsigned char*>(valid);
  p.pay_g = static_cast<__nv_bfloat16*>(pay_g);
  p.hit = static_cast<unsigned char*>(hit);
  p.H = H;
  p.W = W;
  p.D = D;
  p.P = P;
  p.ntaps = ntaps;
  p.desc_weight = desc_weight;
  p.dist_thresh = dist_thresh;
  int reach = 0;
  for (int t = 0; t < ntaps; ++t) {
    reach = abs(du[t]) > reach ? abs(du[t]) : reach;
    reach = abs(dv[t]) > reach ? abs(dv[t]) : reach;
  }
  p.reach = reach;
  for (int t = 0; t < ntaps; ++t) {
    p.off[t] = dv[t] * (kTileW + 2 * reach) + du[t];
    p.du[t] = du[t];
    p.dv[t] = dv[t];
  }
  const long long smem =
      static_cast<long long>(kTileW + 2 * reach) * (kTileH + 2 * reach) * (16 * chunks + 8);
  if (smem > kMaxShared) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || H == 0 || W == 0) return 0;
  void (*kernel)(const Params) = chunks == 0 ? match_taps_kernel<0> : match_taps_kernel<kChunks>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((W + kTileW - 1) / kTileW, (H + kTileH - 1) / kTileH, B);
  kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
