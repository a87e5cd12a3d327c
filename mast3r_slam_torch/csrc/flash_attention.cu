// Flash attention forward for Hopper (sm_90a): bf16 q/k/v/o, f32 accumulation.
//
// Replaces: mast3r_slam_tpu/ops/attention.py `_flash_kernel` (the Pallas
// kernel behind `flash_attention`). It computes the same function: scores
// scaled by D^-0.5 (exp2 with log2 e folded into the scale), key columns
// >= Skv scored -inf, and the output acc / max(l, 1e-30). P is rounded to
// bf16 before the PV product and l is summed from the f32 P, as the JAX
// package's `attention_xla` does. It is not a block-by-block copy: the TPU
// kernel pads D to 128 lanes and walks the q tiles as a sequential grid; here
// D stays 64 and the q tiles (and parts of their key range) run in parallel.
//
// What bounds it on the card. At the main-path shapes (S=768, D=64; B=1 with
// H=16 encoder / 12 decoder, B=6 H=12 in the backend) one call moves
// 4*B*H*S*D*2 bytes (6.3 MB for the encoder) and does 4*B*H*Sq*Skv*D flops
// (2.4 GFLOP): 1.9 us of HBM time against 2.4 us of tensor-core time, so the
// tensor cores set the bound. Reaching it takes (a) wgmma, the only way to
// the full tensor-core rate, (b) loads that run ahead of the math, and (c)
// enough independent tiles on every one of the 132 SMs: at B=1 there are only
// 144 or 192 tiles of 64 q rows, and the exp2 of the softmax (4096 per
// 64x64 tile on 16 MUFU lanes per SM) costs as much as the tile's products.
//
// What the design does about it.
//  * Both products on wgmma.mma_async m64n64k16 (bf16 in, f32 accumulate),
//    issued by one consumer warpgroup per 64 q rows. S = Q K^T reads Q and K
//    from shared memory through K-major descriptors; P is converted to bf16
//    in registers (the S accumulator fragments re-packed in place) and is the
//    register A operand of O += P V; V is read through an MN-major
//    (transposed) descriptor, so no fragment is gathered by hand.
//  * Every tile is stored in the 128-byte-swizzled layout: a 64-element bf16
//    row is exactly 128 bytes, one swizzle atom wide, 16-byte chunk c of row
//    r stored at chunk c ^ (r % 8). No padding; the same layout serves the
//    K-major (Q, K) and MN-major (V) descriptors.
//  * A ring of K/V stages filled asynchronously by a producer warp: one lane
//    issues TMA copies (cp.async.bulk.tensor, 4-D tensor maps over the
//    strided [B, H, S, 64] views, 64 x 64 boxes, 128-byte swizzle, rows past
//    S zero-filled) into each stage as soon as the consumers release it.
//    Two mbarriers per stage: `full` (the producer's expect-tx arrival; the
//    copies complete it by bytes) and `empty` (4 consumer-warp arrivals once
//    the products that read the stage completed). TMA rather than cp.async
//    from the producer warp: the copies cost the producer one instruction a
//    tile, run in the async proxy that wgmma reads through (no proxy fence),
//    and signal completion themselves, so the ring stays full. The host cost
//    is three cuTensorMapEncodeTiled calls per launch (host arithmetic only,
//    no device round trip; the encoder is reached through
//    cudaGetDriverEntryPointByVersion, so the library needs no -lcuda).
//  * Consumer order per key tile: issue S = Q K^T, wait for the previous
//    tile's PV (released to the producer at once), wait for S, softmax, issue
//    PV and leave it in flight over the next tile's S.
//  * The schedule fills 132 SMs in one launch (ops/attention.py
//    `attention_schedule`, which the tests cover): while the q tiles leave
//    SMs idle (B=1: 144 or 192 tiles), a q tile's key range is split over a
//    thread-block cluster of `splits` CTAs (2 at B=1 and 768 tokens), as
//    many as stay resident at once while each keeps at least 6 key tiles
//    (below that the merge costs more than the idle SMs give: 640 and 432
//    tokens run unsplit). Each CTA runs its part of the key tiles to a partial
//    (m, l, O); the CTAs of ranks >= 1 write theirs into rank 0's shared
//    memory (distributed shared memory, st.shared::cluster) and rank 0
//    merges them in rank order and stores the output: a fixed order, so a
//    repeated call is bit-equal. When the q tiles alone fill the card (B=6:
//    864), no split and a 2-stage ring: 4 CTAs per SM instead of 3 shorten
//    the last wave (that variant has no merge). 160 threads per CTA; 74 KB
//    of shared memory (4-stage ring, 3 CTAs per SM, 106 registers) or 42 KB
//    (2-stage, 4 per SM, 92 registers under a cap of 102; ptxas serialises
//    its wgmmas for lack of registers, C7512, and it is still the faster
//    variant at B=6).
//
// Row statistics for the backward (training). With a non-null `lse` the
// kernel also writes, for every stored row, lse = ln Σ_j exp(scale · q·k_j),
// f32 [B * H, Sq] (row stride 1, stride `lss` between (b, h) rows), in
// natural-log units: the kernel keeps m (the row's largest scaled score) and
// l = Σ exp2(S · scale · log2 e − m) in the log2 domain, and stores (m +
// log2 l) · ln 2. Under a cluster split, rank 0 writes it from the merged (m,
// l) after its rank-ordered merge; unsplit (either ring), every CTA writes
// its own rows. Whether lse is written is a template parameter of the
// kernel, so a launch with a null `lse` (every inference call) runs the code
// it ran before. `lse` and its stride are the kernel's last parameters, so
// the others keep their offsets: with them placed after `o`, the same SASS
// (up to parameter offsets) took 1.0-1.7% longer at 768 tokens, batch 1, in
// a same-process A/B against the previous build on the H100.
//
// Layout: q/k/v are [B, H, S, 64] with arbitrary B/H/S strides (in elements;
// multiples of 8) and a contiguous last dim, so the head split of a fused
// qkv projection needs no copy. The output is written through its own
// strides (the wrapper lays it out [B, Sq, H, D]). Rows of the ragged last q
// tile are computed on zero-filled inputs and not stored.
//
// C interface (bound with ctypes): returns cudaGetLastError() after the launch,
// or cudaErrorInvalidValue for a launch `attention_schedule` never makes (a
// ring depth other than 4 with 1-4 splits or 2 with one, or more splits than
// key tiles) or a view no tensor map can describe.

#include "hopper.cuh"  // mbarriers, TMA, wgmma, clusters, tensor maps

namespace {

constexpr int kD = 64;                      // head dim
constexpr int kBlockQ = 64;                 // q rows per CTA (one consumer warpgroup)
constexpr int kBlockK = 64;                 // kv rows per tile
constexpr int kMaxSplits = 4;               // CTAs of a cluster sharing one q tile
constexpr int kConsumers = 128;             // one warpgroup
constexpr int kThreads = kConsumers + 32;   // + one producer warp
constexpr int kTileBytes = kBlockK * kD * 2;                  // 8 KB, 64 rows of 128 B
constexpr int kSlotBytes = (32 + 4) * kConsumers * 4;         // a partial: O fragments, m, l

// Shared memory of a CTA with a ring of `stages` K/V stages: Q, the ring, and
// slack for aligning it to 1024 bytes. Only the 4-stage ring splits a key
// range; its partials are merged in the same bytes, so `splits - 1` of them
// must fit in Q + ring.
constexpr int ring_bytes(int stages) { return kTileBytes * (1 + 2 * stages); }
constexpr int smem_bytes(int stages) { return ring_bytes(stages) + 1024; }
static_assert((kMaxSplits - 1) * kSlotBytes <= ring_bytes(4), "partials overflow the ring");

// Grid: x = q tile * splits + split (a cluster of `splits` CTAs along x, so
// `split` is the CTA's rank in its cluster), y = b * H + h. Split r takes the
// key tiles [r * nkv / splits, (r + 1) * nkv / splits). Each thread of the
// consumer warpgroup owns, as in every m64nN wgmma accumulator, rows 16 w + g
// and 16 w + g + 8 (w = warp, g = lane / 4) and columns 8 j + 2 (lane % 4) +
// {0, 1}, j = 0..7.
template <int kStages, int kMinBlocks, bool kLse>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
flash_fwd_kernel(const __grid_constant__ CUtensorMap q_map,
                 const __grid_constant__ CUtensorMap k_map,
                 const __grid_constant__ CUtensorMap v_map, bf16* __restrict__ o, int H, int Sq,
                 int Skv, long long osb, long long osh, long long oss, float scale_log2,
                 int splits, float* __restrict__ lse, long long lss) {
  __shared__ __align__(8) uint64_t full_bar[kStages];
  __shared__ __align__(8) uint64_t empty_bar[kStages];
  extern __shared__ __align__(16) uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t ring = raw + ((1024u - (raw & 1023u)) & 1023u);  // 1024-B aligned
  uint8_t* ring_ptr = smem_raw + (ring - raw);
  const uint32_t q_tile = ring;
  auto k_tile = [&](int stage) { return ring + kTileBytes * (1 + 2 * stage); };
  auto v_tile = [&](int stage) { return ring + kTileBytes * (2 + 2 * stage); };

  const int split = static_cast<int>(blockIdx.x) % splits;
  const int q0 = (static_cast<int>(blockIdx.x) / splits) * kBlockQ;
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int nkv = (Skv + kBlockK - 1) / kBlockK;
  const int t_begin = split * nkv / splits;
  const int n_local = (split + 1) * nkv / splits - t_begin;  // >= 1: splits <= nkv

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(smem_u32(&full_bar[s]), 1);
      mbar_init(smem_u32(&empty_bar[s]), kConsumers / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  float acc[32];  // O accumulator (consumers)
  float m_run[2] = {-INFINITY, -INFINITY};  // rows g and g+8, log2 domain
  float l_run[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;

  if (warp == kConsumers / 32) {
    // Producer warp: one lane issues Q with the first K/V tile, then a K/V
    // tile into each stage as soon as the consumers release it. The copies
    // run in the async proxy (as wgmma reads) and complete on `full` by bytes.
    if (lane == 0) {
      tma_prefetch_map(&k_map);
      tma_prefetch_map(&v_map);
      for (int it = 0; it < n_local; ++it) {
        const int stage = it % kStages;
        if (it >= kStages) mbar_wait(smem_u32(&empty_bar[stage]), ((it / kStages) - 1) & 1);
        const uint32_t bar = smem_u32(&full_bar[stage]);
        mbar_arrive_expect_tx(bar, (it == 0 ? 3 : 2) * kTileBytes);
        if (it == 0) tma_load_tile(q_tile, &q_map, bar, q0, h, b);
        const int kv0 = (t_begin + it) * kBlockK;
        tma_load_tile(k_tile(stage), &k_map, bar, kv0, h, b);
        tma_load_tile(v_tile(stage), &v_map, bar, kv0, h, b);
      }
    }
  } else {
    // Consumer warpgroup.
    const int tq = lane & 3;
    float s_acc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s_acc[i] = 0.f;
    for (int it = 0; it < n_local; ++it) {
      const int stage = it % kStages;
      mbar_wait(smem_u32(&full_bar[stage]), (it / kStages) & 1);
      const uint32_t kt = k_tile(stage), vt = v_tile(stage);

      // S = Q K^T: four k-steps of 16 along D, 32 bytes apart in the row.
      wgmma_fence();
      fence_regs(s_acc);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        wgmma_ss(s_acc, sw128_desc(q_tile + 32 * kk, 16, 1024),
                 sw128_desc(kt + 32 * kk, 16, 1024), kk);
      }
      wgmma_commit();
      if (it > 0) {
        wgmma_wait<1>();  // the previous tile's PV: its stage goes back to the producer
        if (lane == 0) mbar_arrive(smem_u32(&empty_bar[(it - 1) % kStages]));
      }
      wgmma_wait<0>();
      fence_regs(s_acc);
      fence_regs(acc);

      // Mask key columns >= Skv (the ragged last tile only); the row max of
      // the raw scores, scaled once (scale > 0), in the log2 domain.
      const int kv0 = (t_begin + it) * kBlockK;
      if (kv0 + kBlockK > Skv) {
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int col = kv0 + 8 * (i >> 2) + 2 * tq + (i & 1);
          s_acc[i] = col < Skv ? s_acc[i] : -INFINITY;
        }
      }
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int i = 0; i < 32; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s_acc[i]);
      float alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        mx[r] = fmaxf(m_run[r], mx[r] * scale_log2);
        const float msub = mx[r] == -INFINITY ? 0.f : mx[r];  // row fully masked so far
        alpha[r] = ex2(m_run[r] - msub);
        m_run[r] = mx[r];
        mx[r] = -msub;
      }

      // P = exp2(S * scale - m) in f32 for l; bf16 pairs as PV's A fragments.
      uint32_t pf[4][4];
      float rs[2] = {0.f, 0.f};
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float p0 = ex2(fmaf(s_acc[4 * j + 0], scale_log2, mx[0]));
        const float p1 = ex2(fmaf(s_acc[4 * j + 1], scale_log2, mx[0]));
        const float p2 = ex2(fmaf(s_acc[4 * j + 2], scale_log2, mx[1]));
        const float p3 = ex2(fmaf(s_acc[4 * j + 3], scale_log2, mx[1]));
        rs[0] += p0 + p1;
        rs[1] += p2 + p3;
        pf[j >> 1][(j & 1) * 2 + 0] = pack_bf16(p0, p1);
        pf[j >> 1][(j & 1) * 2 + 1] = pack_bf16(p2, p3);
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) l_run[r] = l_run[r] * alpha[r] + rs[r];
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[i] *= alpha[(i >> 1) & 1];

      // O += P V: V is [kv][d] (MN-major B); a k-step is 16 kv rows = 2 KB.
      wgmma_fence();
      fence_regs(acc);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wgmma_rs(acc, pf[kk], sw128_desc(vt + 2048 * kk, 8192, 1024));
      wgmma_commit();
    }
    wgmma_wait<0>();
    fence_regs(acc);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
      l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
    }
  }

  // Merge the partials of a split key range in rank 0 (all 160 threads of
  // every CTA of the cluster take part in both cluster barriers).
  const int tid = threadIdx.x;
  float m_fin[2] = {m_run[0], m_run[1]};  // the rows' largest scaled scores (for lse)
  if (kStages == 4 && splits > 1) {
    cluster_sync();  // every CTA's loop done: rank 0's ring is free for the partials
    if (warp < kConsumers / 32 && split != 0) {
      const uint32_t slot = map_to_rank(ring + (split - 1) * kSlotBytes, 0);
#pragma unroll
      for (int i4 = 0; i4 < 8; ++i4) {
        st_cluster_v4(slot + (i4 * kConsumers + tid) * 16, acc[4 * i4], acc[4 * i4 + 1],
                      acc[4 * i4 + 2], acc[4 * i4 + 3]);
      }
      st_cluster_v4(slot + 32 * kConsumers * 4 + tid * 16, m_run[0], m_run[1], l_run[0],
                    l_run[1]);
    }
    cluster_sync();  // partials written
    if (split != 0) return;
    if (warp < kConsumers / 32) {
      float mm[2] = {m_run[0], m_run[1]};
      for (int p = 1; p < splits; ++p) {
        const float4 ml = *reinterpret_cast<const float4*>(
            ring_ptr + (p - 1) * kSlotBytes + 32 * kConsumers * 4 + tid * 16);
        mm[0] = fmaxf(mm[0], ml.x);
        mm[1] = fmaxf(mm[1], ml.y);
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float msub = mm[r] == -INFINITY ? 0.f : mm[r];
        const float f = ex2(m_run[r] - msub);
        l_run[r] *= f;
        m_run[r] = f;  // own factor
        mm[r] = msub;
        m_fin[r] = msub;
      }
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[i] *= m_run[(i >> 1) & 1];
      for (int p = 1; p < splits; ++p) {
        const uint8_t* slot = ring_ptr + (p - 1) * kSlotBytes;
        const float4 ml = *reinterpret_cast<const float4*>(slot + 32 * kConsumers * 4 + tid * 16);
        const float f0 = ex2(ml.x - mm[0]), f1 = ex2(ml.y - mm[1]);
        l_run[0] += f0 * ml.z;
        l_run[1] += f1 * ml.w;
#pragma unroll
        for (int i4 = 0; i4 < 8; ++i4) {
          const float4 part =
              *reinterpret_cast<const float4*>(slot + (i4 * kConsumers + tid) * 16);
          acc[4 * i4 + 0] += f0 * part.x;
          acc[4 * i4 + 1] += f0 * part.y;
          acc[4 * i4 + 2] += f1 * part.z;
          acc[4 * i4 + 3] += f1 * part.w;
        }
      }
    }
  }
  if (warp >= kConsumers / 32) return;

  const int g = lane >> 2, tq = lane & 3;
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) inv[r] = 1.f / fmaxf(l_run[r], 1e-30f);
  const int row0 = q0 + warp * 16 + g;
  bf16* ob = o + b * osb + h * osh;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= Sq) continue;
    bf16* orow = ob + static_cast<long long>(row) * oss + 2 * tq;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      *reinterpret_cast<uint32_t*>(orow + 8 * j) =
          pack_bf16(acc[4 * j + 2 * r] * inv[r], acc[4 * j + 2 * r + 1] * inv[r]);
    }
  }
  if constexpr (kLse) {
    const float kLn2 = 0.6931471805599453f;
    if (tq == 0) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = row0 + 8 * r;
        if (row < Sq) lse[blockIdx.y * lss + row] = (m_fin[r] + log2f(l_run[r])) * kLn2;
      }
    }
  }
}

}  // namespace

// splits: CTAs per q tile (a cluster along x), 1 <= splits <= min(4, key tiles);
// stages: the K/V ring depth, 4 (3 CTAs per SM) or 2 (4 CTAs per SM, one
// split); ops/attention.py `attention_schedule` chooses both. Strides in elements,
// multiples of 8 and nonzero; q/k/v 16-byte aligned. lse: null, or f32 rows of
// Sq with stride lss (elements) between (b, h) rows.
extern "C" int flash_attention_fwd_bf16(const void* q, const void* k, const void* v, void* o,
                                        void* lse, int B, int H, int Sq, int Skv,
                                        long long qsb, long long qsh, long long qss,
                                        long long ksb, long long ksh, long long kss,
                                        long long vsb, long long vsh, long long vss,
                                        long long osb, long long osh, long long oss,
                                        long long lss, float scale, int splits, int stages,
                                        void* stream) {
  const int nkv = (Skv + kBlockK - 1) / kBlockK;
  if ((stages != 2 && stages != 4) || splits < 1 || splits > (stages == 4 ? kMaxSplits : 1) ||
      splits > nkv) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (B * H == 0 || Sq == 0) return 0;
  CUtensorMap q_map, k_map, v_map;
  if (!encode_map(&q_map, q, B, H, Sq, qsb, qsh, qss) ||
      !encode_map(&k_map, k, B, H, Skv, ksb, ksh, kss) ||
      !encode_map(&v_map, v, B, H, Skv, vsb, vsh, vss)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool with_lse = lse != nullptr;
  auto kernel = stages == 4 ? (with_lse ? flash_fwd_kernel<4, 3, true> : flash_fwd_kernel<4, 3, false>)
                            : (with_lse ? flash_fwd_kernel<2, 4, true> : flash_fwd_kernel<2, 4, false>);
  const int smem = smem_bytes(stages);
  static bool smem_set[4][64] = {};
  int dev = 0;
  cudaGetDevice(&dev);
  bool* set = dev >= 0 && dev < 64 ? &smem_set[2 * (stages == 4) + with_lse][dev] : nullptr;
  if (set == nullptr || !*set) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (set != nullptr) *set = true;
  }
  const float kLog2e = 1.4426950408889634f;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(((Sq + kBlockQ - 1) / kBlockQ) * splits, B * H, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaLaunchKernelEx(&cfg, kernel, q_map, k_map, v_map, static_cast<bf16*>(o), H, Sq, Skv, osb,
                     osh, oss, scale * kLog2e, splits, static_cast<float*>(lse), lss);
  return static_cast<int>(cudaGetLastError());
}
