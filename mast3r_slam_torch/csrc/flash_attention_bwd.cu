// Flash attention backward for Hopper (sm_90a): dq, dk, dv of
// o = softmax(q kᵀ · scale) v for bf16 q/k/v/o/dO [B, H, S, 64], f32 accumulation.
//
// Replaces: the gradient of mast3r_slam_tpu/ops/attention.py's attention,
// which JAX training takes as XLA's VJP of `attention_xla` (the Pallas
// `_flash_kernel` has no VJP, and the ViT's key length is below
// `FLASH_MIN_KV`). It computes the function of the port's plain version,
// ops/attention.py `attention_backward`:
//   P  = exp(S · scale − lse), S = q kᵀ, lse from the forward kernel (f32,
//        natural log; computed here as exp2(S · scale · log2 e − lse · log2 e));
//   dv = Pᵀ dO with P rounded to bf16, as the forward rounds it before PV;
//   dP = dO vᵀ, rounded to bf16 as XLA's VJP rounds the cotangent of P;
//   δ  = rowsum(dO ∘ o) in f32;
//   dS = P ∘ (dP − δ) · scale, rounded to bf16 for the tensor cores;
//   dq = dS k, dk = dSᵀ q; each gradient rounded once to bf16.
//
// What bounds it on the card. At training's shapes ((2, 16 | 12, 768, 768,
// 64)) a backward does 2.5x the forward's flops (dv, dP, dq, dk and S; 12.1
// GFLOP at 16 heads: 12.2 us at the bf16 tensor-core peak) and must move q,
// k, v, o, dO, lse, dq, dk, dv once (25.4 MB: 7.6 us at 3.35 TB/s), so the tensor
// cores set the bound. The plain version instead streams four f32 [B, H, S,
// S] tensors (75.5 MB each) through device memory several times. What the
// design does about it:
//  * No [S, S] tensor leaves the SM: S and P are recomputed per 64 x 64 tile
//    from q, k and lse (FlashAttention-2's backward), in two passes, each
//    gradient written once by one CTA, so no atomics and a repeated backward
//    is bit-equal:
//    (b) the dq kernel, launched first: one CTA per (b·h, 64-row q tile)
//        keeps Q and dO in registers, computes δ for its rows from dO and o
//        and writes it (f32 [B·H, Sq]) for (a), then walks the key tiles:
//        S = Q Kᵀ, P, dP = dO Vᵀ, dS, dQ += dS K;
//    (a) the dk/dv kernel: one CTA per (b·h, 64-key tile) keeps K and V in
//        registers and dK, dV in f32 accumulators, and walks the q tiles:
//        Sᵀ = K Qᵀ, Pᵀ, dV += Pᵀ dO, dPᵀ = V dOᵀ, dSᵀ, dK += dSᵀ Q. Computing
//        Sᵀ rather than S puts the keys on the rows of every accumulator, so
//        Pᵀ and dSᵀ go from accumulator registers straight into the A operand
//        of the next product (FlashAttention-2's register reuse).
//  * Tensor cores through mma.sync m16n8k16 (bf16 in, f32 accumulate): four
//    warps per CTA, 16 rows each. Operands read from shared memory with
//    ldmatrix (.trans where the product needs the tile transposed: dO and Q
//    in (a), K in (b)); tiles of 64 rows x 128 bytes stored with 16-byte
//    chunk c of row r at c ^ (r % 8), so the eight rows of an ldmatrix hit
//    eight bank groups.
//  * The walked tiles are double-buffered: cp.async (16-byte, zero-filled
//    past S) fills the next tile while the current one is computed.
//  * Ragged edges: rows past Sq read lse as +inf (P = 0), keys past Skv are
//    masked in the dq kernel; neither is stored.
//  * 128 threads and 32-33 KB of shared memory per CTA; ptxas gives the
//    dk/dv kernel 226 registers (two CTAs per SM) and the dq kernel 168
//    (three), without spills.
// Left for later work: wgmma, TMA rings, FA3-style overlap, more warps per CTA.
//
// Layout: every tensor is a [B, H, S, 64] view with arbitrary B/H/S strides
// (in elements, multiples of 8, nonzero) and a contiguous last dim, 16-byte
// aligned; lse and δ are f32 [B·H, Sq] with stride `lss` between (b, h) rows.
//
// C interface (bound with ctypes in ops/attention.py): each entry returns
// cudaGetLastError() after its launch, or cudaErrorInvalidValue for a shape
// the kernels do not take.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kD = 64;         // head dim
constexpr int kBlock = 64;     // q rows and key rows per tile
constexpr int kThreads = 128;  // four warps, 16 rows of the CTA's tile each
constexpr int kTileBytes = kBlock * kD * 2;  // 8 KB
constexpr float kLog2e = 1.4426950408889634f;

using bf16 = __nv_bfloat16;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Byte offset of 16-byte chunk c (8 bf16) of row r in a swizzled 64 x 64 tile.
__device__ __forceinline__ uint32_t swz(int r, int c) {
  return static_cast<uint32_t>(r * 128 + ((c ^ (r & 7)) << 4));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Rows [row0, row0 + 64) of a [.., S, 64] view (row stride ss) into a
// swizzled tile, rows >= S zero-filled; all 128 threads issue 4 copies each.
__device__ __forceinline__ void load_tile(uint32_t tile, const bf16* base, long long ss, int row0,
                                          int S) {
#pragma unroll
  for (int j = 0; j < kBlock * 8 / kThreads; ++j) {
    const int i = threadIdx.x + j * kThreads, r = i >> 3, c = i & 7;
    const bool ok = row0 + r < S;
    const bf16* src = ok ? base + static_cast<long long>(row0 + r) * ss + c * 8 : base;
    cp_async16(tile + swz(r, c), src, ok);
  }
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// d (16 x 8 f32) += a (16 x 16 bf16, row) * b (16 x 8 bf16, col).
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Fragments. A warp's accumulator acc[8][4] is a 16 x 64 f32 tile: lane
// (g = lane / 4, t = lane % 4) holds acc[n][0..1] at row g, columns
// 8n + 2t + {0, 1}, and acc[n][2..3] at row g + 8. An A operand a[4][4] is a
// 16 x 64 bf16 tile in four k-steps of 16 (mma's row-major A fragments).

// A fragments of rows [m0, m0 + 16) of a tile stored [m][k].
__device__ __forceinline__ void load_a(uint32_t (&a)[4][4], uint32_t tile, int m0) {
  const int l = threadIdx.x & 31;
  const int r = m0 + (l & 7) + 8 * ((l >> 3) & 1);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) ldsm_x4(a[kk], tile + swz(r, 2 * kk + (l >> 4)));
}

// acc += a · B with B[k][n] stored transposed, as a tile [n][k] (Kᵀ, Qᵀ,
// Vᵀ, dOᵀ of tiles stored by rows).
__device__ __forceinline__ void mma_bt(float (&acc)[8][4], const uint32_t (&a)[4][4],
                                       uint32_t tile) {
  const int l = threadIdx.x & 31;
#pragma unroll
  for (int np = 0; np < 4; ++np) {
    const int r = 16 * np + (l & 7) + 8 * (l >> 4);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t b[4];
      ldsm_x4(b, tile + swz(r, 2 * kk + ((l >> 3) & 1)));
      mma(acc[2 * np], a[kk], b[0], b[1]);
      mma(acc[2 * np + 1], a[kk], b[2], b[3]);
    }
  }
}

// acc += a · B with B[k][n] stored as it is, a tile [k][n] (dO, Q, K).
__device__ __forceinline__ void mma_b(float (&acc)[8][4], const uint32_t (&a)[4][4],
                                      uint32_t tile) {
  const int l = threadIdx.x & 31;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const int r = 16 * kk + (l & 7) + 8 * ((l >> 3) & 1);
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      uint32_t b[4];
      ldsm_x4_t(b, tile + swz(r, 2 * np + (l >> 4)));
      mma(acc[2 * np], a[kk], b[0], b[1]);
      mma(acc[2 * np + 1], a[kk], b[2], b[3]);
    }
  }
}

// An accumulator as the A operand of the next product, rounded to bf16.
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4][4], const float (&acc)[8][4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    a[j][0] = pack_bf16(acc[2 * j][0], acc[2 * j][1]);
    a[j][1] = pack_bf16(acc[2 * j][2], acc[2 * j][3]);
    a[j][2] = pack_bf16(acc[2 * j + 1][0], acc[2 * j + 1][1]);
    a[j][3] = pack_bf16(acc[2 * j + 1][2], acc[2 * j + 1][3]);
  }
}

__device__ __forceinline__ void zero(float (&acc)[8][4]) {
#pragma unroll
  for (int n = 0; n < 8; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  }
}

// Store a warp's 16 x 64 accumulator as bf16 rows row0 + {g, g + 8} (< S).
__device__ __forceinline__ void store_rows(bf16* base, long long ss, int row0, int S,
                                           const float (&acc)[8][4]) {
  const int l = threadIdx.x & 31, g = l >> 2, t = l & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + g + 8 * h;
    if (row >= S) continue;
    bf16* dst = base + static_cast<long long>(row) * ss + 2 * t;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      *reinterpret_cast<uint32_t*>(dst + 8 * n) = pack_bf16(acc[n][2 * h], acc[n][2 * h + 1]);
    }
  }
}

struct View {  // a [B, H, S, 64] tensor: base and B/H/S strides in elements
  const bf16* p;
  long long sb, sh, ss;
  __device__ __forceinline__ const bf16* at(int b, int h) const { return p + b * sb + h * sh; }
};

// (b) dq and δ. Grid (q tiles, B * H); 128 threads.
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(View q, View k, View v, View o, View dout, const float* __restrict__ lse,
                    float* __restrict__ delta, bf16* __restrict__ dq, long long dqsb,
                    long long dqsh, long long dqss, int H, int Sq, int Skv, long long lss,
                    float scale) {
  __shared__ __align__(128) uint8_t smem[4 * kTileBytes];  // K, V double-buffered
  const uint32_t base = smem_u32(smem);
  auto k_tile = [&](int buf) { return base + kTileBytes * (2 * buf); };
  auto v_tile = [&](int buf) { return base + kTileBytes * (2 * buf + 1); };

  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int q0 = blockIdx.x * kBlock;
  const int warp = threadIdx.x >> 5, l = threadIdx.x & 31, g = l >> 2, t = l & 3;
  const float scale_log2 = scale * kLog2e;

  // Q, dO and o of the q tile, through the shared memory of the K/V buffers.
  load_tile(k_tile(1), q.at(b, h), q.ss, q0, Sq);
  load_tile(v_tile(1), dout.at(b, h), dout.ss, q0, Sq);
  load_tile(v_tile(0), o.at(b, h), o.ss, q0, Sq);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  uint32_t qa[4][4], da[4][4];
  load_a(qa, k_tile(1), 16 * warp);
  load_a(da, v_tile(1), 16 * warp);
  float dl[2] = {0.f, 0.f};  // δ of rows g and g + 8
  {
    uint32_t oa[4][4];
    load_a(oa, v_tile(0), 16 * warp);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 x = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&da[kk][j]));
        const float2 y = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&oa[kk][j]));
        dl[j & 1] += x.x * y.x + x.y * y.y;
      }
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    dl[r] += __shfl_xor_sync(0xffffffffu, dl[r], 1);
    dl[r] += __shfl_xor_sync(0xffffffffu, dl[r], 2);
  }
  const long long stat0 = blockIdx.y * lss;
  float lse2[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + 16 * warp + g + 8 * r;
    lse2[r] = row < Sq ? lse[stat0 + row] * kLog2e : INFINITY;
    if (t == 0 && row < Sq) delta[stat0 + row] = dl[r];
  }
  __syncthreads();  // every warp has its fragments: the buffers go to K and V

  float acc[8][4];
  zero(acc);
  const int nkv = (Skv + kBlock - 1) / kBlock;
  load_tile(k_tile(0), k.at(b, h), k.ss, 0, Skv);
  load_tile(v_tile(0), v.at(b, h), v.ss, 0, Skv);
  cp_async_commit();
  for (int it = 0; it < nkv; ++it) {
    const int cur = it & 1;
    if (it + 1 < nkv) {
      load_tile(k_tile(cur ^ 1), k.at(b, h), k.ss, (it + 1) * kBlock, Skv);
      load_tile(v_tile(cur ^ 1), v.at(b, h), v.ss, (it + 1) * kBlock, Skv);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    float s[8][4], dp[8][4];
    zero(s);
    mma_bt(s, qa, k_tile(cur));  // S = Q Kᵀ
    zero(dp);
    mma_bt(dp, da, v_tile(cur));  // dP = dO Vᵀ
    const int kv0 = it * kBlock;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = kv0 + 8 * n + 2 * t + (e & 1);
        const float p = col < Skv ? ex2(fmaf(s[n][e], scale_log2, -lse2[e >> 1])) : 0.f;
        s[n][e] = p * (round_bf16(dp[n][e]) - dl[e >> 1]) * scale;  // dS
      }
    }
    uint32_t sa[4][4];
    acc_to_a(sa, s);
    mma_b(acc, sa, k_tile(cur));  // dQ += dS K
    __syncthreads();  // the buffer is refilled by the next iteration's copies
  }
  store_rows(dq + b * dqsb + h * dqsh, dqss, q0 + 16 * warp, Sq, acc);
}

// (a) dk and dv. Grid (key tiles, B * H); 128 threads.
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv_kernel(View q, View k, View v, View dout, const float* __restrict__ lse,
                      const float* __restrict__ delta, bf16* __restrict__ dk, long long dksb,
                      long long dksh, long long dkss, bf16* __restrict__ dv, long long dvsb,
                      long long dvsh, long long dvss, int H, int Sq, int Skv, long long lss,
                      float scale) {
  __shared__ __align__(128) uint8_t smem[4 * kTileBytes];  // Q, dO double-buffered
  __shared__ float stats[2][2][kBlock];                    // [buffer][lse·log2 e, δ][row]
  const uint32_t base = smem_u32(smem);
  auto q_tile = [&](int buf) { return base + kTileBytes * (2 * buf); };
  auto d_tile = [&](int buf) { return base + kTileBytes * (2 * buf + 1); };

  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int k0 = blockIdx.x * kBlock;
  const int warp = threadIdx.x >> 5, l = threadIdx.x & 31, t = l & 3;
  const float scale_log2 = scale * kLog2e;
  const long long stat0 = blockIdx.y * lss;
  const int nq = (Sq + kBlock - 1) / kBlock;

  // K and V of the key tile, through the shared memory of buffer 1.
  load_tile(q_tile(1), k.at(b, h), k.ss, k0, Skv);
  load_tile(d_tile(1), v.at(b, h), v.ss, k0, Skv);
  cp_async_commit();
  auto load_q = [&](int it, int buf) {
    const int row0 = it * kBlock;
    load_tile(q_tile(buf), q.at(b, h), q.ss, row0, Sq);
    load_tile(d_tile(buf), dout.at(b, h), dout.ss, row0, Sq);
    cp_async_commit();
    const int i = threadIdx.x & (kBlock - 1), row = row0 + i;
    if (threadIdx.x < kBlock) {
      stats[buf][0][i] = row < Sq ? lse[stat0 + row] * kLog2e : INFINITY;
    } else {
      stats[buf][1][i] = row < Sq ? delta[stat0 + row] : 0.f;
    }
  };
  if (nq > 0) load_q(0, 0);
  cp_async_wait<0>();
  __syncthreads();
  uint32_t ka[4][4], va[4][4];
  load_a(ka, q_tile(1), 16 * warp);
  load_a(va, d_tile(1), 16 * warp);
  __syncthreads();  // every warp has its fragments: buffer 1 goes to Q and dO

  float dk_acc[8][4], dv_acc[8][4];
  zero(dk_acc);
  zero(dv_acc);
  for (int it = 0; it < nq; ++it) {
    const int cur = it & 1;
    if (it + 1 < nq) {
      load_q(it + 1, cur ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    float s[8][4];
    zero(s);
    mma_bt(s, ka, q_tile(cur));  // Sᵀ = K Qᵀ: rows keys, columns q rows
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 8 * n + 2 * t + (e & 1);
        s[n][e] = ex2(fmaf(s[n][e], scale_log2, -stats[cur][0][col]));  // Pᵀ
      }
    }
    {
      uint32_t pa[4][4];
      acc_to_a(pa, s);
      mma_b(dv_acc, pa, d_tile(cur));  // dV += Pᵀ dO
    }
    float dp[8][4];
    zero(dp);
    mma_bt(dp, va, d_tile(cur));  // dPᵀ = V dOᵀ
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 8 * n + 2 * t + (e & 1);
        dp[n][e] = s[n][e] * (round_bf16(dp[n][e]) - stats[cur][1][col]) * scale;  // dSᵀ
      }
    }
    {
      uint32_t sa[4][4];
      acc_to_a(sa, dp);
      mma_b(dk_acc, sa, q_tile(cur));  // dK += dSᵀ Q
    }
    __syncthreads();  // the buffer is refilled by the next iteration's copies
  }
  store_rows(dk + b * dksb + h * dksh, dkss, k0 + 16 * warp, Skv, dk_acc);
  store_rows(dv + b * dvsb + h * dvsh, dvss, k0 + 16 * warp, Skv, dv_acc);
}

bool valid_shape(int B, int H, int Sq, int Skv) {
  return B >= 0 && H >= 0 && Sq >= 0 && Skv >= 1 && static_cast<long long>(B) * H <= 65535;
}

}  // namespace

// δ and dq for every q row. Launch before the dk/dv entry, on the same
// stream: it reads the δ written here.
extern "C" int flash_attention_bwd_dq_bf16(
    const void* q, const void* k, const void* v, const void* o, const void* dout, const void* lse,
    void* delta, void* dq, int B, int H, int Sq, int Skv, long long qsb, long long qsh,
    long long qss, long long ksb, long long ksh, long long kss, long long vsb, long long vsh,
    long long vss, long long osb, long long osh, long long oss, long long dosb, long long dosh,
    long long doss, long long dqsb, long long dqsh, long long dqss, long long lss, float scale,
    void* stream) {
  if (!valid_shape(B, H, Sq, Skv)) return static_cast<int>(cudaErrorInvalidValue);
  if (B * H == 0 || Sq == 0) return 0;
  const auto view = [](const void* p, long long sb, long long sh, long long ss) {
    return View{static_cast<const bf16*>(p), sb, sh, ss};
  };
  flash_bwd_dq_kernel<<<dim3((Sq + kBlock - 1) / kBlock, B * H), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      view(q, qsb, qsh, qss), view(k, ksb, ksh, kss), view(v, vsb, vsh, vss),
      view(o, osb, osh, oss), view(dout, dosb, dosh, doss), static_cast<const float*>(lse),
      static_cast<float*>(delta), static_cast<bf16*>(dq), dqsb, dqsh, dqss, H, Sq, Skv, lss,
      scale);
  return static_cast<int>(cudaGetLastError());
}

// dk and dv, from the δ of flash_attention_bwd_dq_bf16.
extern "C" int flash_attention_bwd_dkdv_bf16(
    const void* q, const void* k, const void* v, const void* dout, const void* lse,
    const void* delta, void* dk, void* dv, int B, int H, int Sq, int Skv, long long qsb,
    long long qsh, long long qss, long long ksb, long long ksh, long long kss, long long vsb,
    long long vsh, long long vss, long long dosb, long long dosh, long long doss, long long dksb,
    long long dksh, long long dkss, long long dvsb, long long dvsh, long long dvss, long long lss,
    float scale, void* stream) {
  if (!valid_shape(B, H, Sq, Skv)) return static_cast<int>(cudaErrorInvalidValue);
  if (B * H == 0) return 0;
  const auto view = [](const void* p, long long sb, long long sh, long long ss) {
    return View{static_cast<const bf16*>(p), sb, sh, ss};
  };
  flash_bwd_dkdv_kernel<<<dim3((Skv + kBlock - 1) / kBlock, B * H), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      view(q, qsb, qsh, qss), view(k, ksb, ksh, kss), view(v, vsb, vsh, vss),
      view(dout, dosb, dosh, doss), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<bf16*>(dk), dksb, dksh, dkss,
      static_cast<bf16*>(dv), dvsb, dvsh, dvss, H, Sq, Skv, lss, scale);
  return static_cast<int>(cudaGetLastError());
}
