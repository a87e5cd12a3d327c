// LayerNorm over the last dimension (mast3r_slam_torch/ops/layer_norm.py).
//
// Replaces no Pallas kernel: the JAX package leaves its LayerNorms to XLA
// (flax nn.LayerNorm in f32, mast3r_slam_tpu/models/vit.py), which fuses the
// casts on either side into the norm. The port's plain version
// (ops/layer_norm.py layer_norm_reference) is three eager kernels: the bf16 ->
// f32 copy of the tokens, PyTorch's f32 layer norm, and the cast of its f32
// output to the bf16 of the Linear that reads it (two such casts where two
// projections read one norm). A tracked ViT-L frame runs 147 norms. This
// kernel reads x once in its own dtype and writes the norm rounded once to
// the dtype its reader computes in.
//
// What it computes: bit for bit the plain version. PyTorch's f32 layer norm
// on the card (vectorized_layer_norm_kernel) takes a row's statistics with a
// block of 128 threads: thread t runs Welford's online update over the
// groups of 4 elements t, t + 128, ... in order; the 32 lanes of each of the
// 4 warps are combined by a shuffle-down tree (cuWelfordCombine), then the
// warps by a tree in shared memory (warp 0 with 2 and 1 with 3, then 0 with
// 1); the variance is M2 / C, rstd = rsqrtf(var + eps), and
// y = w * (rstd * (x - mean)) + b. Here one warp does a row: lane l stands
// for threads l, l + 32, l + 64 and l + 96 and keeps their four Welford
// states in registers, so each update, each shuffle-down step and each
// combine is the same f32 operation on the same operands, written as the
// same expressions (so nvcc contracts the same multiply-adds), and the warp
// tree becomes three combines in registers. The output is rounded once to
// bf16 (__float2bfloat16_rn, the cast PyTorch's kernels use) or stored as f32.
// tests/test_torch_layer_norm_cuda.py holds the output bit-equal to the plain
// version at the port's shapes; it relies on PyTorch's layout above (checked
// against torch 2.11 on an H100).
//
// What bounds it on the card: latency. A norm at batch 1 reads 0.66-1.5 MB
// and writes as much (0.4-0.9 us at 3.35 TB/s); a lane's loads are one round
// trip, then the combine tree, eight dependent levels over four states, takes
// about 1 us of a launch's 3.1-3.5 (H100): the price of PyTorch's bits, over
// a plain two-pass sum (PERF.md, kernel table row 13).
//
// Design (grid: kWarps rows a block; block: one warp a row):
//   * lane l holds the groups of 4 of its four threads (up to kGroups each,
//     C / 4 groups in all) in registers, with their weight and bias, all
//     loaded before any arithmetic so the latencies overlap; a warp's loads
//     of one (thread, group) slot are contiguous (8 bytes a lane in bf16, 16
//     in f32);
//   * every lane ends with the row's mean and rstd (a broadcast from lane 0),
//     so no shared memory or barrier is needed;
//   * each lane writes its groups to the contiguous output.
// Where the caller asks (a call that records a gradient), lane 0 also writes
// the row's f32 mean and rstd: PyTorch's own values, so its layer norm
// backward takes them as autograd's would. No host read and no allocation:
// the wrapper allocates the outputs, so a call captures into a CUDA graph.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;    // rows a block
constexpr int kThreads = 4;  // PyTorch's threads a lane stands for (its block: 32 x 4)
constexpr int kGroups = 2;   // groups of 4 a thread: C up to 4 * 128 * kGroups
constexpr int kMaxC = 4 * 32 * kThreads * kGroups;  // ops/layer_norm.py MAX_WIDTH

static_assert(kMaxC == 1024, "ops/layer_norm.py MAX_WIDTH");

struct Params {
  const void* x;
  const float* w;
  const float* b;
  void* out;
  float* mean;  // [rows] f32, or null: not written
  float* rstd;  // [rows] f32, or null
  long long rows;
  int C;
  float eps;
};

struct Welford {
  float mean, sigma2, count;
};

// PyTorch's cuWelfordOnlineSum for a thread's n-th element (n = count + 1, a
// constant after unrolling, so 1.f / n is folded, correctly rounded, as the
// division PyTorch makes)
__device__ __forceinline__ Welford online(float val, const Welford& curr_sum, int n) {
  float delta = val - curr_sum.mean;
  float new_count = curr_sum.count + 1.f;
  float new_mean = curr_sum.mean + delta * (1.f / static_cast<float>(n));
  return {new_mean, curr_sum.sigma2 + delta * (val - new_mean), new_count};
}

// 1.f / c, correctly rounded, for a count c: the hardware's approximate
// reciprocal and one Newton step, which gives the IEEE division's result for
// every integer c from 1 to 65,536 (checked exhaustively on an H100), with no
// branch to the division's slow path (a combine's count is at most kMaxC).
__device__ __forceinline__ float reciprocal(float c) {
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(c));
  return __fmaf_rn(r, __fmaf_rn(-c, r, 1.f), r);
}

// PyTorch's cuWelfordCombine(dataB, dataA), called as (own state, the other).
// Its `if (count > 0)` becomes a select and its `1.f / count` `reciprocal`, so
// a combine has no branch and the four threads' combines interleave.
__device__ __forceinline__ Welford combine(const Welford& dataB, const Welford& dataA) {
  float delta = dataB.mean - dataA.mean;
  float count = dataA.count + dataB.count;
  float coef = reciprocal(count);
  float nA = dataA.count * coef;
  float nB = dataB.count * coef;
  float mean = nA * dataA.mean + nB * dataB.mean;
  float sigma2 = dataA.sigma2 + dataB.sigma2 + delta * delta * dataA.count * nB;
  const bool any = count > 0.f;
  return {any ? mean : 0.f, any ? sigma2 : 0.f, count};
}

__device__ __forceinline__ float lo(uint32_t v) { return __uint_as_float(v << 16); }
__device__ __forceinline__ float hi(uint32_t v) { return __uint_as_float(v & 0xffff0000u); }

__device__ __forceinline__ uint32_t pack(float a, float b) {  // a in the low half
  return static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(a))) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(b))) << 16);
}

__device__ __forceinline__ void load4(const __nv_bfloat16* p, float* f) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  f[0] = lo(v.x);
  f[1] = hi(v.x);
  f[2] = lo(v.y);
  f[3] = hi(v.y);
}

__device__ __forceinline__ void load4(const float* p, float* f) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  f[0] = v.x;
  f[1] = v.y;
  f[2] = v.z;
  f[3] = v.w;
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, const float* f) {
  *reinterpret_cast<uint2*>(p) = make_uint2(pack(f[0], f[1]), pack(f[2], f[3]));
}

__device__ __forceinline__ void store4(float* p, const float* f) {
  *reinterpret_cast<float4*>(p) = make_float4(f[0], f[1], f[2], f[3]);
}

__device__ __forceinline__ Welford shfl_down(const Welford& s, int offset) {
  return {__shfl_down_sync(0xffffffffu, s.mean, offset),
          __shfl_down_sync(0xffffffffu, s.sigma2, offset),
          __shfl_down_sync(0xffffffffu, s.count, offset)};
}

template <typename TIn, typename TOut>
__global__ void __launch_bounds__(32 * kWarps) layer_norm_kernel(const __grid_constant__ Params p) {
  const int lane = threadIdx.x & 31;
  const long long row = static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (row >= p.rows) return;  // the whole warp
  const TIn* x = static_cast<const TIn*>(p.x) + row * p.C;
  const int groups = p.C >> 2;

  // slot (y, k): thread lane + 32 y, its group g = lane + 32 y + 128 k
  float v[kThreads][kGroups][4], w[kThreads][kGroups][4], b[kThreads][kGroups][4];
#pragma unroll
  for (int y = 0; y < kThreads; ++y)
#pragma unroll
    for (int k = 0; k < kGroups; ++k) {
      const int g = lane + 32 * y + 32 * kThreads * k;
      if (g < groups) {
        load4(x + 4 * g, v[y][k]);
        load4(p.w + 4 * g, w[y][k]);
        load4(p.b + 4 * g, b[y][k]);
      }
    }

  Welford s[kThreads];
#pragma unroll
  for (int y = 0; y < kThreads; ++y) {
    s[y] = {0.f, 0.f, 0.f};
#pragma unroll
    for (int k = 0; k < kGroups; ++k)
      if (lane + 32 * y + 32 * kThreads * k < groups)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[y] = online(v[y][k][e], s[y], 4 * k + e + 1);
  }
#pragma unroll
  for (int offset = 16; offset > 0; offset >>= 1)
#pragma unroll
    for (int y = 0; y < kThreads; ++y) s[y] = combine(s[y], shfl_down(s[y], offset));
  s[0] = combine(s[0], s[2]);  // PyTorch's shared-memory tree over its 4 warps
  s[1] = combine(s[1], s[3]);
  s[0] = combine(s[0], s[1]);
  const float mean = __shfl_sync(0xffffffffu, s[0].mean, 0);
  const float var = __shfl_sync(0xffffffffu, s[0].sigma2, 0) / static_cast<float>(p.C);
  const float rstd = rsqrtf(var + p.eps);
  if (p.mean != nullptr && lane == 0) {
    p.mean[row] = mean;
    p.rstd[row] = rstd;
  }

  TOut* out = static_cast<TOut*>(p.out) + row * p.C;
#pragma unroll
  for (int y = 0; y < kThreads; ++y)
#pragma unroll
    for (int k = 0; k < kGroups; ++k) {
      const int g = lane + 32 * y + 32 * kThreads * k;
      if (g < groups) {
        float o[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) o[e] = w[y][k][e] * (rstd * (v[y][k][e] - mean)) + b[y][k][e];
        store4(out + 4 * g, o);
      }
    }
}

template <typename TIn, typename TOut>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  const long long blocks = (p.rows + kWarps - 1) / kWarps;
  layer_norm_kernel<TIn, TOut>
      <<<dim3(static_cast<unsigned>(blocks)), dim3(32 * kWarps), 0, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// Normalise the rows of x, contiguous [rows, C] (bf16 if in_bf16, else f32),
// with f32 weight and bias [C] into out, contiguous [rows, C] (bf16 if
// out_bf16, else f32), and, where mean and rstd are not null, each row's f32
// mean and rstd into them ([rows] each). C is a multiple of 8 up to kMaxC;
// every pointer is 16-byte aligned (the wrapper checks). Returns a
// cudaError_t.
extern "C" int layer_norm_rows(void* stream, const void* x, const void* weight, const void* bias,
                               void* out, void* mean, void* rstd, long long rows, int C,
                               float eps, int in_bf16, int out_bf16) {
  if (C <= 0 || C % 8 || C > kMaxC || rows < 0 || (mean == nullptr) != (rstd == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 0) return 0;
  if ((rows + kWarps - 1) / kWarps > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const Params p = {x,    static_cast<const float*>(weight), static_cast<const float*>(bias), out,
                    static_cast<float*>(mean), static_cast<float*>(rstd), rows, C, eps};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (in_bf16)
    err = out_bf16 ? launch<__nv_bfloat16, __nv_bfloat16>(p, s) : launch<__nv_bfloat16, float>(p, s);
  else
    err = out_bf16 ? launch<float, __nv_bfloat16>(p, s) : launch<float, float>(p, s);
  return static_cast<int>(err);
}
