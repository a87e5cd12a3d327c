// Flash attention forward for Hopper (sm_90a): bf16 q/k/v/o, f32 accumulation.
//
// Replaces: mast3r_slam_tpu/ops/attention.py `_flash_kernel` (the Pallas
// kernel behind `flash_attention`). It computes the same function: scores
// scaled by D^-0.5, a running max, running sum and f32 accumulator over K/V
// tiles, key columns >= Skv scored -inf, and the output acc / max(l, 1e-30).
// It is not a block-by-block copy: the TPU kernel pads D to 128 lanes and
// walks the q tiles as a sequential grid; here D stays 64 and every
// (batch*head, 64-row q tile) pair is an independent thread block.
//
// What bounds it on the card. At the main-path shapes (B=1, S=768, D=64,
// H=16 encoder / 12 decoder) one call moves 4*B*H*S*D*2 bytes (~6.3 MB for the
// encoder) and does 4*B*H*Sq*Skv*D flops (~2.4 GFLOP): ~1.9 us of HBM time
// against ~2.4 us of tensor-core time, so neither wall is close and the call
// is bound by latency and occupancy: only 192 (encoder) or 144 (decoder)
// blocks of 4 warps for 132 SMs.
//
// What the design does about it. Tensor cores through mma.sync m16n8k16 (bf16
// in, f32 accumulate); S and P never leave registers (the S accumulator
// fragments are re-packed in place as the A operand of the PV product); K/V
// tiles are double-buffered in shared memory with cp.async so the next
// tile's load overlaps this tile's math; the padded shared-memory row stride
// (72 bf16) makes every fragment load bank-conflict free. wgmma/TMA and a
// persistent schedule are later work.
//
// Numerics: P is rounded to bf16 before the PV product (as FlashAttention-2
// and the JAX package's `attention_xla` do); the running sum l uses the f32
// P. Softmax uses exp2 with log2(e) folded into the scale.
//
// Layout: q/k/v/o are [B, H, S, 64] with arbitrary B/H/S strides (in
// elements; multiples of 8) and a contiguous last dim, so the head split of
// a fused qkv projection needs no copy. Rows of the ragged last q tile are
// computed on zero-filled inputs and not stored.
//
// C interface (bound with ctypes): returns cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kD = 64;              // head dim
constexpr int kBlockQ = 64;         // q rows per block, 16 per warp
constexpr int kBlockK = 64;         // kv rows per tile
constexpr int kLd = kD + 8;         // shared-memory row stride in bf16 (144 B)
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;

using bf16 = __nv_bfloat16;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool pred) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  int n = pred ? 16 : 0;  // src-size 0 zero-fills the 16 bytes
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Stage rows [row0, row0 + 64) of a [rows, 64] bf16 matrix into shared memory;
// rows >= nrows are zero-filled. 512 16-byte chunks, 4 per thread.
__device__ __forceinline__ void load_tile(bf16* sm, const bf16* base, long long row_stride,
                                          int row0, int nrows) {
#pragma unroll
  for (int i = 0; i < (kBlockK * kD / 8) / kThreads; ++i) {
    const int c = threadIdx.x + i * kThreads;
    const int r = c >> 3, ch = c & 7;
    const int row = row0 + r;
    const bool ok = row < nrows;
    const bf16* src = base + (ok ? static_cast<long long>(row) * row_stride : 0) + ch * 8;
    cp_async16(sm + r * kLd + ch * 8, src, ok);
  }
}

__device__ __forceinline__ uint32_t ld_b32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

// D += A * B for one m16n8k16 tile (A row-major 16x16, B col-major 16x8).
__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                          uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, bf16* __restrict__ o, int H, int Sq, int Skv,
                 long long qsb, long long qsh, long long qss, long long ksb, long long ksh,
                 long long kss, long long vsb, long long vsh, long long vss, long long osb,
                 long long osh, long long oss, float scale_log2) {
  __shared__ __align__(16) bf16 Qs[kBlockQ * kLd];
  __shared__ __align__(16) bf16 Ks[2][kBlockK * kLd];
  __shared__ __align__(16) bf16 Vs[2][kBlockK * kLd];

  const int q0 = blockIdx.x * kBlockQ;
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const bf16* qb = q + b * qsb + h * qsh;
  const bf16* kb = k + b * ksb + h * ksh;
  const bf16* vb = v + b * vsb + h * vsh;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2;  // fragment row group
  const int t = lane & 3;   // thread in group

  const int nkv = (Skv + kBlockK - 1) / kBlockK;
  load_tile(Qs, qb, qss, q0, Sq);
  load_tile(Ks[0], kb, kss, 0, Skv);
  load_tile(Vs[0], vb, vss, 0, Skv);
  cp_async_commit();

  uint32_t qf[4][4];  // this warp's 16 q rows as A fragments, 4 k-steps over D
  float acc[8][4];    // O accumulator: 16 rows x 64 cols as 8 n-tiles
#pragma unroll
  for (int j = 0; j < 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY};  // rows g and g+8 (log2 domain)
  float l_run[2] = {0.f, 0.f};              // this thread's partial row sums

  for (int it = 0; it < nkv; ++it) {
    const int buf = it & 1;
    if (it + 1 < nkv) {
      load_tile(Ks[buf ^ 1], kb, kss, (it + 1) * kBlockK, Skv);
      load_tile(Vs[buf ^ 1], vb, vss, (it + 1) * kBlockK, Skv);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    if (it == 0) {
      const bf16* qw = Qs + warp * 16 * kLd;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        qf[kk][0] = ld_b32(qw + g * kLd + kk * 16 + 2 * t);
        qf[kk][1] = ld_b32(qw + (g + 8) * kLd + kk * 16 + 2 * t);
        qf[kk][2] = ld_b32(qw + g * kLd + kk * 16 + 2 * t + 8);
        qf[kk][3] = ld_b32(qw + (g + 8) * kLd + kk * 16 + 2 * t + 8);
      }
    }

    // S = Q K^T for 16 q rows x 64 kv columns.
    const bf16* ks = Ks[buf];
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
      const bf16* krow = ks + (8 * j + g) * kLd + 2 * t;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        mma_16816(s[j], qf[kk], ld_b32(krow + kk * 16), ld_b32(krow + kk * 16 + 8));
      }
    }

    // Scale, mask key columns >= Skv, tile row max.
    const int kv0 = it * kBlockK;
    float mx[2] = {m_run[0], m_run[1]};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = kv0 + 8 * j + 2 * t + (e & 1);
        const float x = col < Skv ? s[j][e] * scale_log2 : -INFINITY;
        s[j][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float msub = mx[r] == -INFINITY ? 0.f : mx[r];  // row fully masked so far
      alpha[r] = exp2f(m_run[r] - msub);
      m_run[r] = mx[r];
      mx[r] = msub;
    }

    // P = exp2(S - m); re-pack the accumulator fragments as PV's A operand.
    uint32_t pf[4][4];
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float p0 = exp2f(s[j][0] - mx[0]);
      const float p1 = exp2f(s[j][1] - mx[0]);
      const float p2 = exp2f(s[j][2] - mx[1]);
      const float p3 = exp2f(s[j][3] - mx[1]);
      rs[0] += p0 + p1;
      rs[1] += p2 + p3;
      pf[j >> 1][(j & 1) * 2 + 0] = pack_bf16(p0, p1);
      pf[j >> 1][(j & 1) * 2 + 1] = pack_bf16(p2, p3);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l_run[r] = l_run[r] * alpha[r] + rs[r];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      acc[j][0] *= alpha[0];
      acc[j][1] *= alpha[0];
      acc[j][2] *= alpha[1];
      acc[j][3] *= alpha[1];
    }

    // O += P V: B fragments gathered from row-major V (two rows per register).
    const uint16_t* vs = reinterpret_cast<const uint16_t*>(Vs[buf]);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const int r0 = kk * 16 + 2 * t;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int n = 8 * j + g;
        const uint32_t b0 = static_cast<uint32_t>(vs[r0 * kLd + n]) |
                            (static_cast<uint32_t>(vs[(r0 + 1) * kLd + n]) << 16);
        const uint32_t b1 = static_cast<uint32_t>(vs[(r0 + 8) * kLd + n]) |
                            (static_cast<uint32_t>(vs[(r0 + 9) * kLd + n]) << 16);
        mma_16816(acc[j], pf[kk], b0, b1);
      }
    }
    __syncthreads();  // this buffer is refilled by the next iteration's loads
  }
  cp_async_wait<0>();

  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_run[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    inv[r] = 1.f / fmaxf(l, 1e-30f);
  }
  const int row0 = q0 + warp * 16 + g;
  bf16* ob = o + b * osb + h * osh;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= Sq) continue;
    bf16* orow = ob + static_cast<long long>(row) * oss + 2 * t;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      *reinterpret_cast<uint32_t*>(orow + 8 * j) =
          pack_bf16(acc[j][2 * r] * inv[r], acc[j][2 * r + 1] * inv[r]);
    }
  }
}

}  // namespace

extern "C" int flash_attention_fwd_bf16(const void* q, const void* k, const void* v, void* o,
                                        int B, int H, int Sq, int Skv, long long qsb,
                                        long long qsh, long long qss, long long ksb,
                                        long long ksh, long long kss, long long vsb,
                                        long long vsh, long long vss, long long osb,
                                        long long osh, long long oss, float scale,
                                        void* stream) {
  const float kLog2e = 1.4426950408889634f;
  dim3 grid((Sq + kBlockQ - 1) / kBlockQ, B * H);
  flash_fwd_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), H, Sq, Skv, qsb, qsh, qss, ksb, ksh, kss, vsb, vsh, vss, osb, osh,
      oss, scale * kLog2e);
  return static_cast<int>(cudaGetLastError());
}
