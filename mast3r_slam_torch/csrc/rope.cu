// The 2D RoPE rotation of attention's q and k (mast3r_slam_torch/ops/rope.py).
//
// Replaces no Pallas kernel: the JAX package leaves the rotation to XLA
// (mast3r_slam_tpu/models/vit.py apply_rope), which fuses it into its
// neighbours. The port's plain version (ops/rope.py apply_rope, then the cast
// to bf16) issues 8 PyTorch kernels for each of q and k: the f32 copy, two
// negations, a cat, two broadcast multiplies, an add and the bf16 cast, each
// moving an f32 copy of [B, H, S, 64]. Every attention call of the model
// rotates both, so a frame of the tracking window ran ~1,000 of them (2.4 ms of
// device time at 768 tokens). This kernel rotates q and k in one launch.
//
// What it computes, bit for bit the plain version's: for each element the
// bf16 value widened to f32, x * cos + rot(x) * sin, where rot is the quarter
// swap [-y2, y1, -x2, x1] of the head's four 16-wide quarters, the two
// products and the sum each rounded once in f32 (__fmul_rn, __fadd_rn: no
// contraction into an FMA, as the plain version's separate kernels), then
// rounded once to bf16 (__float2bfloat16_rn, round to nearest even, the cast
// PyTorch's kernels use on the card). The tables are the plain version's f32
// cos / sin, [B or 1, S, 64].
//
// What bounds it on the card: bytes. Each call reads q and k (bf16) and the
// tables once and writes q and k once: ~6.7 MB at (1, 16, 768, 64), 2.0 us at
// 3.35 TB/s; there are 3 f32 operations an element.
//
// Design (grid: row tiles of kRows positions x batch x the tensors; block:
// one warp a head, up to kMaxHeadsBlock heads, a loop beyond):
//   * a warp covers kRows positions of one head: four threads a 64-wide row,
//     each a group of 8 elements in both quarters of one half (the element and
//     its rotation partner), read and written as 16-byte vectors; a warp's
//     stores are kRows consecutive rows of the contiguous [B, H, S, 64]
//     output;
//   * the first warp loads the tiles' table rows (cos and sin, 16-byte loads)
//     into shared memory beside its own q/k loads, so each table row is read
//     once a block, for all its heads; every warp issues its q/k loads before
//     the barrier, so the table's and the tensor's latencies overlap;
//   * q and k are read in place through their strides (the self-attention
//     views of one qkv projection, or two projections), so nothing is copied
//     first. The wrapper checks the alignment the 16-byte accesses need.
// No host read and no allocation: the wrapper allocates the outputs, so a call
// captures into a CUDA graph.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kHeadDim = 64;        // ops/rope.py HEAD_DIM
constexpr int kRows = 8;            // positions a warp covers
constexpr int kMaxHeadsBlock = 16;  // warps a block, one a head
constexpr int kMaxPairs = 2;        // q and k
constexpr int kDims = 10;           // ops/rope.py DIMS: B, H, S, x (b, h, s), cos (b, s), sin (b, s)

static_assert(kRows * 4 == 32, "a warp is four threads a row");

struct Pair {  // one tensor to rotate, its tables and its output
  const uint4* x;
  const float4* cos;
  const float4* sin;
  uint4* out;
  long long xb, xh, xs;  // x's strides in 16-byte vectors (8 bf16)
  long long cb, cs, sb, ss;  // the tables' strides in 16-byte vectors (4 f32)
  int B, H, S;
};

struct Params {
  Pair t[kMaxPairs];
};

__device__ __forceinline__ float lo(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float hi(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }

__device__ __forceinline__ uint32_t pack(float a, float b) {  // a in the low half
  return static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(a))) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(b))) << 16);
}

__device__ __forceinline__ void unpack(const uint4& v, float* f) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = lo(w[i]);
    f[2 * i + 1] = hi(w[i]);
  }
}

__device__ __forceinline__ void split(const float4& v, float* f) {
  f[0] = v.x;
  f[1] = v.y;
  f[2] = v.z;
  f[3] = v.w;
}

// x * cos + r * sin, each product and the sum rounded once in f32.
__device__ __forceinline__ float rotate(float x, float c, float r, float s) {
  return __fadd_rn(__fmul_rn(x, c), __fmul_rn(r, s));
}

// A thread reads its table values from shared memory as it uses them, so it
// holds few registers: two blocks fit an SM with no cap in the launch bounds
// and no spill, and the encoder's 16-head blocks at 768 positions (192 of
// them) run in one wave (PERF.md row 12 gives ptxas's count).
__global__ void __launch_bounds__(32 * kMaxHeadsBlock) rope_kernel(const __grid_constant__ Params p) {
  // [vector][lane]: lane l's 8 table vectors (cos of its two groups, then sin), so a
  // warp's 16-byte reads of one vector hit consecutive addresses.
  __shared__ float4 table[8][32];
  const Pair& t = p.t[blockIdx.z];
  const int b = blockIdx.y;
  if (b >= t.B) return;  // the whole block: the other tensor's batch is larger
  const int lane = threadIdx.x, part = lane & 3;
  const int s = blockIdx.x * kRows + (lane >> 2);
  const bool live = s < t.S;
  // this thread's vectors of a row: the group of 8 in the half's first quarter
  // (vector `v0`) and its partner 16 elements on (v0 + 2)
  const int v0 = (part >> 1) * 4 + (part & 1);

  int h = threadIdx.y;
  uint4 a = make_uint4(0, 0, 0, 0), c = a;
  if (live && h < t.H) {
    const uint4* row = t.x + b * t.xb + h * t.xh + s * t.xs;
    a = row[v0];
    c = row[v0 + 2];
  }
  if (threadIdx.y == 0 && live) {
    const float4* cr = t.cos + b * t.cb + s * t.cs;
    const float4* sr = t.sin + b * t.sb + s * t.ss;
    // table vectors (4 f32) of elements 8 v0 .. 8 v0 + 8 and 16 on
    table[0][lane] = cr[2 * v0];
    table[1][lane] = cr[2 * v0 + 1];
    table[2][lane] = cr[2 * v0 + 4];
    table[3][lane] = cr[2 * v0 + 5];
    table[4][lane] = sr[2 * v0];
    table[5][lane] = sr[2 * v0 + 1];
    table[6][lane] = sr[2 * v0 + 4];
    table[7][lane] = sr[2 * v0 + 5];
  }
  __syncthreads();
  if (!live) return;

  for (; h < t.H; h += blockDim.y) {
    if (h != threadIdx.y) {
      const uint4* row = t.x + b * t.xb + h * t.xh + s * t.xs;
      a = row[v0];
      c = row[v0 + 2];
    }
    float xa[8], xc[8], cs[8], sn[8];
    unpack(a, xa);
    unpack(c, xc);
    split(table[0][lane], cs);  // the first group's cos and sin
    split(table[1][lane], cs + 4);
    split(table[4][lane], sn);
    split(table[5][lane], sn + 4);
    uint32_t ya[4], yc[4];
#pragma unroll
    for (int j = 0; j < 8; j += 2)  // first quarter: rot = -partner
      ya[j / 2] = pack(rotate(xa[j], cs[j], -xc[j], sn[j]),
                       rotate(xa[j + 1], cs[j + 1], -xc[j + 1], sn[j + 1]));
    split(table[2][lane], cs);  // its partner's
    split(table[3][lane], cs + 4);
    split(table[6][lane], sn);
    split(table[7][lane], sn + 4);
#pragma unroll
    for (int j = 0; j < 8; j += 2)  // second quarter: rot = +partner
      yc[j / 2] = pack(rotate(xc[j], cs[j], xa[j], sn[j]),
                       rotate(xc[j + 1], cs[j + 1], xa[j + 1], sn[j + 1]));
    uint4* out = t.out + ((static_cast<long long>(b) * t.H + h) * t.S + s) * (kHeadDim / 8);
    out[v0] = make_uint4(ya[0], ya[1], ya[2], ya[3]);
    out[v0 + 2] = make_uint4(yc[0], yc[1], yc[2], yc[3]);
  }
}

}  // namespace

// Rotate `n` (1 or 2) bf16 tensors [B, H, S, 64] by their f32 tables. `ptrs`
// holds 4 device pointers a tensor: x, cos, sin, out; `dims` 10 numbers a
// tensor: B, H, S, x's element strides (batch, head, position), cos's
// (batch, position), sin's (batch, position). x's strides are multiples of 8
// and the tables' of 4, every pointer 16-byte aligned, the last stride 1
// (the wrapper checks); out is contiguous [B, H, S, 64]. Returns a
// cudaError_t.
extern "C" int rope_qk(void* stream, int n, const void* const* ptrs, const long long* dims) {
  if (n < 1 || n > kMaxPairs) return static_cast<int>(cudaErrorInvalidValue);
  Params p = {};
  int rows = 0, batch = 0, heads = 0;
  for (int i = 0; i < n; ++i) {
    const long long* d = dims + kDims * i;
    Pair& t = p.t[i];
    t.x = static_cast<const uint4*>(ptrs[4 * i]);
    t.cos = static_cast<const float4*>(ptrs[4 * i + 1]);
    t.sin = static_cast<const float4*>(ptrs[4 * i + 2]);
    t.out = static_cast<uint4*>(const_cast<void*>(ptrs[4 * i + 3]));
    t.B = static_cast<int>(d[0]);
    t.H = static_cast<int>(d[1]);
    t.S = static_cast<int>(d[2]);
    t.xb = d[3] / 8;
    t.xh = d[4] / 8;
    t.xs = d[5] / 8;
    t.cb = d[6] / 4;
    t.cs = d[7] / 4;
    t.sb = d[8] / 4;
    t.ss = d[9] / 4;
    rows = t.S > rows ? t.S : rows;
    batch = t.B > batch ? t.B : batch;
    heads = t.H > heads ? t.H : heads;
  }
  if (rows == 0 || batch == 0 || heads == 0) return 0;
  if (batch > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((rows + kRows - 1) / kRows, batch, n);
  const dim3 block(32, heads < kMaxHeadsBlock ? heads : kMaxHeadsBlock);
  rope_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
