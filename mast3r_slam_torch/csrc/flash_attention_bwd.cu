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
// k, v, o, dO, lse, dq, dk, dv once (25.4 MB: 7.6 us at 3.35 TB/s), so the
// tensor cores set the bound. Two passes recompute S and dP, so the kernels
// issue 7 products of 64 x 64 x 64 per (q tile, key tile) pair (16.9 GFLOP
// at 16 heads), and each pass also costs every pair 4096 exp2 on the SM's
// 16 MUFU lanes (256 cycles, against 384 of tensor-core time for the dq
// kernel's three products and 512 for the dk/dv kernel's four) and ~7
// instructions an element of P and dS. Measured on the H100 (PERF.md), the
// elementwise instructions, not the products' operand reads, set the pace:
// cutting them (the masked tail only on the last key tile, dS as one FMA
// and a multiply from δ · scale, bf16 rounding a pair at a time) took the
// backward from 46.6 to 43.0 us at (2, 16), while reading the dq kernel's Q
// and dO from registers instead of shared memory (half its operand reads)
// changed nothing. What the design does about it:
//  * No [S, S] tensor leaves the SM: S and P are recomputed per 64 x 64 tile
//    from q, k and lse (FlashAttention-2's backward), in two passes, each
//    gradient written once by one CTA, so no atomics and a repeated backward
//    is bit-equal:
//    (b) the dq kernel, launched first: one CTA per (b·h, 64-row q tile)
//        computes δ for its rows from dO and o, writes lse · log2 e (+inf
//        past Sq) and δ · scale (0 past Sq) for (a), then walks the key
//        tiles: S = Q Kᵀ, P, dP = dO Vᵀ, dS, dQ += dS K;
//    (a) the dk/dv kernel: one CTA per (b·h, 64-key tile) walks the q
//        tiles: Sᵀ = K Qᵀ, dPᵀ = V dOᵀ, Pᵀ, dSᵀ, dV += Pᵀ dO, dK += dSᵀ Q.
//        Sᵀ rather than S puts the keys on the rows of every accumulator, so
//        Pᵀ and dSᵀ go from accumulator registers straight into the A
//        operand of the next product.
//  * Every product on wgmma.mma_async m64n64k16 (bf16 in, f32 accumulate),
//    issued by the CTA's one warpgroup. The products with both operands
//    tiles (S, dP and their transposes) read K-major descriptors; Pᵀ, dSᵀ
//    and dS are re-packed to bf16 in registers and are the A operand of dV,
//    dK and dQ, whose B (dO, Q, K) is read through an MN-major descriptor
//    over the same 128-byte-swizzled tile: each tile is stored once and read
//    both ways, with no ldmatrix and no transpose by hand (csrc/hopper.cuh).
//  * The walked tiles come through a ring of 3 stages filled by TMA: Q, dO
//    and the 64 rows' statistics (one 512-byte bulk copy from the dq
//    kernel's padded [B·H, q tiles, 2, 64]) in the dk/dv kernel; K and V in
//    the dq kernel (4-D tensor maps over the strided views, rows past S
//    zero-filled). One `full` mbarrier a stage completes by bytes. The
//    resident tiles (K, V or Q, dO) come once on a barrier of their own.
//  * Overlap. In the dq kernel the next tile's S is issued while this
//    tile's dQ product runs, exp2 of P runs while dP is on the tensor cores,
//    and dQ stays in flight into the next tile. In the dk/dv kernel dV and
//    dK stay in flight through the stage refill and the next ring wait; the
//    next Sᵀ and dPᵀ are issued only once they are done (with them in
//    flight too, their accumulators and A fragments would not fit the 168
//    registers beside the rest: ptxas serialised every product, C7512, and
//    the kernel ran 5% slower). Across warpgroups: three CTAs per SM, so one
//    CTA's elementwise work runs beside another's products. ptxas reports
//    no serialisation for either kernel: no instruction but a wgmma writes
//    an accumulator while a product is in flight (C7515; the sums begin
//    with a product that does not accumulate instead of zeroed registers),
//    nor reads one that a pending product writes (C7514).
//  * One wave at training's shapes: a CTA is one warpgroup of 128 threads,
//    so three fit an SM (396 on the card) and the 384 CTAs of (2, 16, 768,
//    768) or 288 of (2, 12) all start at once (ops/attention.py
//    `backward_schedule`, which tests/test_torch_backward_schedule.py
//    covers). At (2, 12) that leaves 108 SMs with two CTAs and 24 with
//    three, which set the time: (2, 12) takes nearly what (2, 16) takes.
//    No producer warp: at three CTAs of 160 threads an SM allows 136
//    registers a thread, and the dk/dv warpgroup holds 64 accumulators (dK,
//    dV) besides two 32-register products and their bf16 A fragments. The
//    warpgroup's thread 0 refills a stage as soon as the products that read
//    it completed (every warp past a CTA barrier), so a stage is reloaded two
//    tiles ahead of its use. setmaxnreg would need a whole producer
//    warpgroup, which costs more registers than it moves.
//  * Per SM: three CTAs of 128 threads, each with 66.5 KB (dk/dv) or 65 KB
//    (dq) of dynamic shared memory. ptxas (sm_90a, the card's toolkit): dq
//    kernel 122 registers, dk/dv kernel 154 registers, no spills.
//  * Ragged edges: rows past Sq carry lse = +inf (P = 0) and δ = 0; keys past
//    Skv are masked in the dq kernel; neither is stored.
//
// Layout: every tensor is a [B, H, S, 64] view with arbitrary B/H/S strides
// (in elements, multiples of 8, nonzero) and a contiguous last dim, 16-byte
// aligned; lse is f32 [B·H, Sq] with stride `lss` between (b, h) rows; the
// row statistics the dq kernel writes are f32 [B·H, q tiles, 2, 64].
//
// C interface (bound with ctypes in ops/attention.py): each entry returns
// cudaGetLastError() after its launch, or cudaErrorInvalidValue for a shape
// the kernels do not take, a ring depth other than the compiled one, or a
// view no tensor map can describe.

#include "hopper.cuh"  // mbarriers, TMA, wgmma, tensor maps

namespace {

constexpr int kD = 64;          // head dim
constexpr int kBlock = 64;      // q rows and key rows per tile
constexpr int kThreads = 128;   // one warpgroup
constexpr int kMinBlocks = 3;   // CTAs per SM: one wave at training's shapes
constexpr int kStages = 3;      // ring depth of the walked tiles
constexpr int kTileBytes = kBlock * kD * 2;  // 8 KB, 64 rows of 128 B
constexpr int kStatFloats = 2 * kBlock;      // a q tile's lse · log2 e, then δ · scale
constexpr int kStatBytes = kStatFloats * 4;  // 512
constexpr float kLog2e = 1.4426950408889634f;

// Dynamic shared memory: two resident tiles, a ring of two tiles a stage
// (in the dk/dv kernel with the stage's row statistics), and slack for
// aligning the tiles to 1024 bytes.
constexpr int dkdv_smem_bytes(int stages) {
  return kTileBytes * (2 + 2 * stages) + kStatBytes * stages + 1024;
}
constexpr int dq_smem_bytes(int stages) { return kTileBytes * (2 + 2 * stages) + 1024; }

// (x, y) rounded to bf16 and back, one conversion for the pair.
__device__ __forceinline__ float2 round_bf16x2(float x, float y) {
  return __bfloat1622float2(__floats2bfloat162_rn(x, y));
}

// The accumulator element i of a thread (as in every m64nN wgmma) is row
// 16 w + g + 8 ((i >> 1) & 1) and column 8 (i >> 2) + 2 t + (i & 1) of the
// 64 x 64 tile (w = warp, g = lane / 4, t = lane % 4).

// An accumulator-shaped tile rounded to bf16 as the A operand of the next
// product: four k-steps of 16 columns, in the m64nNk16 register fragment
// order. The f32 values are never written back into an accumulator: ptxas
// serialises the wgmma pipeline (C7515) where a non-wgmma instruction
// defines an accumulator register while a product is in flight.
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4][4], const float (&d)[32]) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    a[j >> 1][(j & 1) * 2 + 0] = pack_bf16(d[4 * j + 0], d[4 * j + 1]);
    a[j >> 1][(j & 1) * 2 + 1] = pack_bf16(d[4 * j + 2], d[4 * j + 3]);
  }
}

// D = A Bᵀ for two tiles stored by rows (A [m][k], B [n][k], both K-major):
// four k-steps of 16 along the head dim, 32 bytes apart in a row. The first
// only writes D, so D's old values are dead before the product.
__device__ __forceinline__ void issue_abt(float (&d)[32], uint32_t a_tile, uint32_t b_tile) {
  wgmma_ss_first(d, sw128_desc(a_tile, 16, 1024), sw128_desc(b_tile, 16, 1024));
#pragma unroll
  for (int kk = 1; kk < 4; ++kk) {
    wgmma_ss(d, sw128_desc(a_tile + 32 * kk, 16, 1024), sw128_desc(b_tile + 32 * kk, 16, 1024), 1);
  }
}

// D [+]= A B for A in registers and a tile B stored [k][n] (MN-major): a
// k-step is 16 rows of the tile, 2 KB. `accumulate` = 0 starts the sum (the
// first tile of a walk), so D is never zeroed by other instructions.
__device__ __forceinline__ void issue_ab(float (&d)[32], const uint32_t (&a)[4][4],
                                         uint32_t b_tile, int accumulate) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    wgmma_rs(d, a[kk], sw128_desc(b_tile + 2048 * kk, 8192, 1024), kk > 0 || accumulate);
  }
}

// A thread's accumulator rows, rounded to bf16, into rows row0 + {its rows}
// (< S) of a [S, 64] view with row stride ss.
__device__ __forceinline__ void store_rows(bf16* base, long long ss, int row0, int S,
                                           const float (&d)[32]) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 16 * warp + g + 8 * r;
    if (row >= S) continue;
    bf16* dst = base + static_cast<long long>(row) * ss + 2 * t;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      *reinterpret_cast<uint32_t*>(dst + 8 * j) = pack_bf16(d[4 * j + 2 * r], d[4 * j + 2 * r + 1]);
    }
  }
}

// acc + the dot product of eight bf16 pairs (16 bytes of each row), in f32.
__device__ __forceinline__ float dot_bf16x8(uint4 x, uint4 y, float acc) {
  const __nv_bfloat162* a = reinterpret_cast<const __nv_bfloat162*>(&x);
  const __nv_bfloat162* b = reinterpret_cast<const __nv_bfloat162*>(&y);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 u = __bfloat1622float2(a[i]), v = __bfloat1622float2(b[i]);
    acc = fmaf(u.x, v.x, acc);
    acc = fmaf(u.y, v.y, acc);
  }
  return acc;
}

// (b) δ, the row statistics and dq. Grid (q tiles, B * H); 128 threads.
template <int S>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap q_map,
                    const __grid_constant__ CUtensorMap k_map,
                    const __grid_constant__ CUtensorMap v_map,
                    const __grid_constant__ CUtensorMap do_map, const bf16* __restrict__ o,
                    long long osb, long long osh, long long oss, const bf16* __restrict__ dout,
                    long long dosb, long long dosh, long long doss, const float* __restrict__ lse,
                    long long lss, float* __restrict__ stats, bf16* __restrict__ dq,
                    long long dqsb, long long dqsh, long long dqss, int H, int Sq, int Skv,
                    float scale) {
  __shared__ __align__(8) uint64_t full_bar[S];
  __shared__ __align__(8) uint64_t qd_bar;
  __shared__ float row_stats[2][kBlock];  // lse · log2 e and δ · scale of the CTA's rows
  extern __shared__ __align__(16) uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = raw + ((1024u - (raw & 1023u)) & 1023u);
  const uint32_t q_tile = base, do_tile = base + kTileBytes;
  auto k_tile = [&](int stage) { return base + kTileBytes * (2 + 2 * stage); };
  auto v_tile = [&](int stage) { return base + kTileBytes * (3 + 2 * stage); };

  const int qt = blockIdx.x, q0 = qt * kBlock;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int nq = (Sq + kBlock - 1) / kBlock, nkv = (Skv + kBlock - 1) / kBlock;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const float scale_log2 = scale * kLog2e;

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < S; ++s) mbar_init(smem_u32(&full_bar[s]), 1);
    mbar_init(smem_u32(&qd_bar), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  auto load_kv = [&](int tile, int stage) {
    const uint32_t bar = smem_u32(&full_bar[stage]);
    mbar_arrive_expect_tx(bar, 2 * kTileBytes);
    tma_load_tile(k_tile(stage), &k_map, bar, tile * kBlock, h, b);
    tma_load_tile(v_tile(stage), &v_map, bar, tile * kBlock, h, b);
  };
  if (tid == 0) {
    tma_prefetch_map(&k_map);
    tma_prefetch_map(&v_map);
    const uint32_t bar = smem_u32(&qd_bar);
    mbar_arrive_expect_tx(bar, 2 * kTileBytes);
    tma_load_tile(q_tile, &q_map, bar, q0, h, b);
    tma_load_tile(do_tile, &do_map, bar, q0, h, b);
    for (int s = 0; s < S && s < nkv; ++s) load_kv(s, s);
  }

  // δ = rowsum(dO ∘ o) of the 64 rows while the tiles arrive: thread 2r + e
  // sums elements [32 e, 32 e + 32) of row r, the pair adds its halves.
  {
    const int r = tid >> 1, e = tid & 1, row = q0 + r;
    float acc = 0.f;
    if (row < Sq) {
      const uint4* po = reinterpret_cast<const uint4*>(
          o + b * osb + h * osh + static_cast<long long>(row) * oss + 32 * e);
      const uint4* pd = reinterpret_cast<const uint4*>(
          dout + b * dosb + h * dosh + static_cast<long long>(row) * doss + 32 * e);
#pragma unroll
      for (int i = 0; i < 4; ++i) acc = dot_bf16x8(pd[i], po[i], acc);
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    if (e == 0) {
      const float l2 = row < Sq ? lse[bh * lss + row] * kLog2e : INFINITY;
      const float dl = row < Sq ? acc * scale : 0.f;
      row_stats[0][r] = l2;
      row_stats[1][r] = dl;
      float* st = stats + (static_cast<long long>(bh) * nq + qt) * kStatFloats;
      st[r] = l2;
      st[kBlock + r] = dl;
    }
  }
  __syncthreads();
  float lse2[2], dl[2];  // rows g and g + 8 of the warp's 16: lse · log2 e, δ · scale
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    lse2[r] = row_stats[0][16 * warp + g + 8 * r];
    dl[r] = row_stats[1][16 * warp + g + 8 * r];
  }

  float acc[32], s_acc[32], dp[32], p[32], ds[32];  // acc: dQ, begun by tile 0's product
  uint32_t ds_a[4][4];
  mbar_wait(smem_u32(&qd_bar), 0);
  for (int it = 0; it < nkv; ++it) {
    const int stage = it % S;
    mbar_wait(smem_u32(&full_bar[stage]), (it / S) & 1);
    wgmma_fence();
    issue_abt(s_acc, q_tile, k_tile(stage));  // S = Q Kᵀ
    wgmma_commit();
    wgmma_wait<1>();  // dQ of tile it - 1 done (S may run)
    fence_regs(acc);
    __syncthreads();  // every warp is done with tile it - 1's stage
    if (tid == 0 && it > 0 && it - 1 + S < nkv) {
      fence_proxy_async();
      load_kv(it - 1 + S, (it - 1) % S);
    }
    wgmma_fence();
    issue_abt(dp, do_tile, v_tile(stage));  // dP = dO Vᵀ
    wgmma_commit();
    wgmma_wait<1>();  // S (dP runs under exp2)
    fence_regs(s_acc);

    // P = exp2(S · scale · log2 e − lse · log2 e), keys >= Skv masked (the
    // ragged last tile only).
#pragma unroll
    for (int i = 0; i < 32; ++i) p[i] = ex2(fmaf(s_acc[i], scale_log2, -lse2[(i >> 1) & 1]));
    const int kv0 = it * kBlock;
    if (kv0 + kBlock > Skv) {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        if (kv0 + 8 * (i >> 2) + 2 * t + (i & 1) >= Skv) p[i] = 0.f;
      }
    }
    wgmma_wait<0>();  // dP
    fence_regs(dp);
    // dS = P (bf16(dP) − δ) scale, as P (bf16(dP) · scale − δ · scale)
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const float2 r = round_bf16x2(dp[i], dp[i + 1]);
      ds[i] = p[i] * fmaf(r.x, scale, -dl[(i >> 1) & 1]);
      ds[i + 1] = p[i + 1] * fmaf(r.y, scale, -dl[(i >> 1) & 1]);
    }
    acc_to_a(ds_a, ds);
    wgmma_fence();
    issue_ab(acc, ds_a, k_tile(stage), it > 0);  // dQ += dS K, in flight into the next tile
    wgmma_commit();
  }
  wgmma_wait<0>();
  fence_regs(acc);
  store_rows(dq + b * dqsb + h * dqsh, dqss, q0, Sq, acc);
}

// (a) dk and dv. Grid (key tiles, B * H); 128 threads.
template <int S>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
flash_bwd_dkdv_kernel(const __grid_constant__ CUtensorMap q_map,
                      const __grid_constant__ CUtensorMap k_map,
                      const __grid_constant__ CUtensorMap v_map,
                      const __grid_constant__ CUtensorMap do_map,
                      const float* __restrict__ stats, bf16* __restrict__ dk, long long dksb,
                      long long dksh, long long dkss, bf16* __restrict__ dv, long long dvsb,
                      long long dvsh, long long dvss, int H, int Sq, int Skv, float scale) {
  __shared__ __align__(8) uint64_t full_bar[S];
  __shared__ __align__(8) uint64_t kv_bar;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = raw + ((1024u - (raw & 1023u)) & 1023u);
  const uint32_t k_tile = base, v_tile = base + kTileBytes;
  auto q_tile = [&](int stage) { return base + kTileBytes * (2 + 2 * stage); };
  auto do_tile = [&](int stage) { return base + kTileBytes * (3 + 2 * stage); };
  auto stat_addr = [&](int stage) { return base + kTileBytes * (2 + 2 * S) + kStatBytes * stage; };

  const int k0 = blockIdx.x * kBlock;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int nq = (Sq + kBlock - 1) / kBlock;
  const int tid = threadIdx.x, t = tid & 3;
  const float scale_log2 = scale * kLog2e;
  const float* stat_src = stats + static_cast<long long>(bh) * nq * kStatFloats;

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < S; ++s) mbar_init(smem_u32(&full_bar[s]), 1);
    mbar_init(smem_u32(&kv_bar), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  auto load_q = [&](int tile, int stage) {
    const uint32_t bar = smem_u32(&full_bar[stage]);
    mbar_arrive_expect_tx(bar, 2 * kTileBytes + kStatBytes);
    tma_load_tile(q_tile(stage), &q_map, bar, tile * kBlock, h, b);
    tma_load_tile(do_tile(stage), &do_map, bar, tile * kBlock, h, b);
    bulk_load(stat_addr(stage), stat_src + tile * kStatFloats, kStatBytes, bar);
  };
  if (tid == 0) {
    tma_prefetch_map(&q_map);
    tma_prefetch_map(&do_map);
    const uint32_t bar = smem_u32(&kv_bar);
    mbar_arrive_expect_tx(bar, 2 * kTileBytes);
    tma_load_tile(k_tile, &k_map, bar, k0, h, b);
    tma_load_tile(v_tile, &v_map, bar, k0, h, b);
    for (int s = 0; s < S && s < nq; ++s) load_q(s, s);
  }

  float dk_acc[32], dv_acc[32], s_acc[32], dp[32], p[32], ds[32];  // dK, dV: begun by tile 0
  uint32_t p_a[4][4], ds_a[4][4];
  mbar_wait(smem_u32(&kv_bar), 0);
  for (int it = 0; it < nq; ++it) {
    const int stage = it % S;
    // dV and dK of tile it - 1 done before this tile's products are issued:
    // with them in flight too, their 160 accumulator and fragment registers
    // would not fit beside the rest, and ptxas serialises the pipeline (C7512).
    wgmma_wait<0>();
    fence_regs(dk_acc);
    fence_regs(dv_acc);
    __syncthreads();  // every warp is done with tile it - 1's stage
    if (tid == 0 && it > 0 && it - 1 + S < nq) {
      fence_proxy_async();
      load_q(it - 1 + S, (it - 1) % S);
    }
    mbar_wait(smem_u32(&full_bar[stage]), (it / S) & 1);
    wgmma_fence();
    issue_abt(s_acc, k_tile, q_tile(stage));  // Sᵀ = K Qᵀ
    issue_abt(dp, v_tile, do_tile(stage));    // dPᵀ = V dOᵀ
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s_acc);
    fence_regs(dp);

    // Pᵀ: column c is q row c of the tile, with its lse · log2 e (+inf past
    // Sq) from the stage's statistics.
    const float* st = reinterpret_cast<const float*>(smem_raw + (stat_addr(stage) - raw));
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 l = *reinterpret_cast<const float2*>(st + 8 * j + 2 * t);
      p[4 * j + 0] = ex2(fmaf(s_acc[4 * j + 0], scale_log2, -l.x));
      p[4 * j + 1] = ex2(fmaf(s_acc[4 * j + 1], scale_log2, -l.y));
      p[4 * j + 2] = ex2(fmaf(s_acc[4 * j + 2], scale_log2, -l.x));
      p[4 * j + 3] = ex2(fmaf(s_acc[4 * j + 3], scale_log2, -l.y));
    }
    acc_to_a(p_a, p);
    // dSᵀ = Pᵀ (bf16(dPᵀ) · scale − δ · scale), δ · scale of the column's q row
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 d = *reinterpret_cast<const float2*>(st + kBlock + 8 * j + 2 * t);
      const float2 r0 = round_bf16x2(dp[4 * j + 0], dp[4 * j + 1]);
      const float2 r1 = round_bf16x2(dp[4 * j + 2], dp[4 * j + 3]);
      ds[4 * j + 0] = p[4 * j + 0] * fmaf(r0.x, scale, -d.x);
      ds[4 * j + 1] = p[4 * j + 1] * fmaf(r0.y, scale, -d.y);
      ds[4 * j + 2] = p[4 * j + 2] * fmaf(r1.x, scale, -d.x);
      ds[4 * j + 3] = p[4 * j + 3] * fmaf(r1.y, scale, -d.y);
    }
    acc_to_a(ds_a, ds);
    wgmma_fence();
    issue_ab(dv_acc, p_a, do_tile(stage), it > 0);   // dV += Pᵀ dO
    issue_ab(dk_acc, ds_a, q_tile(stage), it > 0);  // dK += dSᵀ Q, in flight into the next tile
    wgmma_commit();
  }
  wgmma_wait<0>();
  fence_regs(dk_acc);
  fence_regs(dv_acc);
  store_rows(dk + b * dksb + h * dksh, dkss, k0, Skv, dk_acc);
  store_rows(dv + b * dvsb + h * dvsh, dvss, k0, Skv, dv_acc);
}

bool valid_shape(int B, int H, int Sq, int Skv) {
  return B >= 0 && H >= 0 && Sq >= 0 && Skv >= 1 && static_cast<long long>(B) * H <= 65535;
}

// Raise each kernel's dynamic shared-memory limit, once per device.
cudaError_t allow_smem() {
  static bool done[64] = {};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev >= 0 && dev < 64 && done[dev]) return cudaSuccess;
  cudaError_t e = cudaFuncSetAttribute(flash_bwd_dq_kernel<kStages>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       dq_smem_bytes(kStages));
  if (e == cudaSuccess) {
    e = cudaFuncSetAttribute(flash_bwd_dkdv_kernel<kStages>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, dkdv_smem_bytes(kStages));
  }
  if (e == cudaSuccess && dev >= 0 && dev < 64) done[dev] = true;
  return e;
}

}  // namespace

// δ, the row statistics (`stats`, f32 [B·H, q tiles, 2, 64]) and dq for
// every q row. Launch before the dk/dv entry, on the same stream: it reads
// `stats`. stages: the K/V ring depth, ops/attention.py `backward_schedule`'s.
extern "C" int flash_attention_bwd_dq_bf16(
    const void* q, const void* k, const void* v, const void* o, const void* dout, const void* lse,
    void* stats, void* dq, int B, int H, int Sq, int Skv, long long qsb, long long qsh,
    long long qss, long long ksb, long long ksh, long long kss, long long vsb, long long vsh,
    long long vss, long long osb, long long osh, long long oss, long long dosb, long long dosh,
    long long doss, long long dqsb, long long dqsh, long long dqss, long long lss, float scale,
    int stages, void* stream) {
  if (!valid_shape(B, H, Sq, Skv) || stages != kStages) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (B * H == 0 || Sq == 0) return 0;
  CUtensorMap q_map, k_map, v_map, do_map;
  if (!encode_map(&q_map, q, B, H, Sq, qsb, qsh, qss) ||
      !encode_map(&k_map, k, B, H, Skv, ksb, ksh, kss) ||
      !encode_map(&v_map, v, B, H, Skv, vsb, vsh, vss) ||
      !encode_map(&do_map, dout, B, H, Sq, dosb, dosh, doss)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaError_t e = allow_smem();
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((Sq + kBlock - 1) / kBlock, B * H);
  flash_bwd_dq_kernel<kStages><<<grid, kThreads, dq_smem_bytes(kStages),
                                 static_cast<cudaStream_t>(stream)>>>(
      q_map, k_map, v_map, do_map, static_cast<const bf16*>(o), osb, osh, oss,
      static_cast<const bf16*>(dout), dosb, dosh, doss, static_cast<const float*>(lse), lss,
      static_cast<float*>(stats), static_cast<bf16*>(dq), dqsb, dqsh, dqss, H, Sq, Skv, scale);
  return static_cast<int>(cudaGetLastError());
}

// dk and dv, from the row statistics of flash_attention_bwd_dq_bf16.
// stages: the Q/dO ring depth, `backward_schedule`'s.
extern "C" int flash_attention_bwd_dkdv_bf16(
    const void* q, const void* k, const void* v, const void* dout, const void* stats, void* dk,
    void* dv, int B, int H, int Sq, int Skv, long long qsb, long long qsh, long long qss,
    long long ksb, long long ksh, long long kss, long long vsb, long long vsh, long long vss,
    long long dosb, long long dosh, long long doss, long long dksb, long long dksh,
    long long dkss, long long dvsb, long long dvsh, long long dvss, float scale, int stages,
    void* stream) {
  if (!valid_shape(B, H, Sq, Skv) || Sq < 1 || stages != kStages) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (B * H == 0) return 0;
  CUtensorMap q_map, k_map, v_map, do_map;
  if (!encode_map(&q_map, q, B, H, Sq, qsb, qsh, qss) ||
      !encode_map(&k_map, k, B, H, Skv, ksb, ksh, kss) ||
      !encode_map(&v_map, v, B, H, Skv, vsb, vsh, vss) ||
      !encode_map(&do_map, dout, B, H, Sq, dosb, dosh, doss)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaError_t e = allow_smem();
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((Skv + kBlock - 1) / kBlock, B * H);
  flash_bwd_dkdv_kernel<kStages><<<grid, kThreads, dkdv_smem_bytes(kStages),
                                   static_cast<cudaStream_t>(stream)>>>(
      q_map, k_map, v_map, do_map, static_cast<const float*>(stats), static_cast<bf16*>(dk), dksb,
      dksh, dkss, static_cast<bf16*>(dv), dvsb, dvsh, dvss, H, Sq, Skv, scale);
  return static_cast<int>(cudaGetLastError());
}

// CTAs of each kernel resident on one SM at once, as the runtime computes it
// from their registers and shared memory (`dq`, `dkdv`); returns the error of
// the first query that failed.
extern "C" int flash_attention_bwd_occupancy(int* dq, int* dkdv) {
  cudaError_t e = allow_smem();
  if (e != cudaSuccess) return static_cast<int>(e);
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      dq, flash_bwd_dq_kernel<kStages>, kThreads, dq_smem_bytes(kStages));
  if (e == cudaSuccess) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(dkdv, flash_bwd_dkdv_kernel<kStages>,
                                                      kThreads, dkdv_smem_bytes(kStages));
  }
  return static_cast<int>(e);
}
