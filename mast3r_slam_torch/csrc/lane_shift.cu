// Lane-shift kernels for the probe entry point (mast3r_slam_torch/probe_shift.py).
//
// They replace the seven Pallas kernels of scripts/probe_mosaic_rotate.py:
//   * roll_last_axis<T> (T = float, __nv_bfloat16) replaces the five roll cases
//     (case_dyn_rot_2d_f32 :38, case_dyn_rot_2d_bf16 :54, case_dyn_rot_3d_f32 :70,
//     case_dyn_rot_3d_bf16_aligned :86, case_static_rot_bf16 :117), i.e.
//     pltpu.roll(x, s, axis=-1) with s read from SMEM (dynamic) or a Python int
//     (static);
//   * offset_slice_sum replaces case_static_unaligned_slice_bf16 (:102): a sum of
//     static, unaligned column-offset slices of a bf16 tile, accumulated in f32;
//   * the C launchers below, called through one Python helper
//     (ops/lane_shift.py `_launch`), replace the generic `_mk` wrapper (:34).
//
// roll_last_axis views x as [R, C] (R = product of the leading dims) and computes
//     out[r, c] = x[r, (c - s) mod C],   0 <= s < C,
// which is pltpu.roll's (and np.roll's) definition for a non-negative shift. The
// dynamic variant reads s from device memory (the counterpart of the SMEM
// scalar: the shift never travels to the host) and reduces it mod C; the
// static variant takes s as a kernel argument, and the Python wrapper refuses a
// static s outside [0, C).
//
// offset_slice_sum computes, for bf16 x [R, C] (row-major, contiguous),
//     out[i, j] = sum_k f32(x[row0 + i, off_k + j]),  i < rows, j < width,
// over at most 8 offsets passed by value, summed in the order given (starting
// from 0.0f), so the result is bit-equal to the plain version's running sum.
//
// What bounds them: both are pure data movement (a permutation copy and a
// 3-tap gather-add). Their least time is the bytes moved over 3.35 TB/s. At a
// matcher plane's size ((16, 384, 512) bf16, 12.6 MB in and out) that is
// 3.8 us, so the roll has to stream at HBM rate: 16-byte accesses, enough of
// them in flight on every SM, no per-element integer division. At the probe
// shapes (<= 12 KB) the bytes take ~5 ns and the chain of dependent memory
// accesses sets the time, so a dynamic shift must not sit in front of the data
// loads.
//
// roll_last_axis's design: two kernels, one launch, chosen by the wrapper
// (ops/lane_shift.py `roll_geometry`, which computes the launch geometry and
// passes it in).
//  * `roll_warp_kernel`, for rows of at most 64 whole 16-byte vectors of a
//    16-byte aligned x (every probe shape and the matcher plane): a warp per
//    row; each lane loads two vectors of the row with aligned 16-byte loads
//    that do not depend on the shift, which is loaded beside them; an output
//    vector is cut with a funnel shift from the two source vectors that hold
//    its 16 bytes, handed over by warp shuffles (wrapping at C). No shared
//    memory and no barrier: the dependent chain is one load and one store,
//    as in torch.roll.
//  * `roll_direct_kernel`, for the rest (rows that do not start on 16-byte
//    boundaries, longer rows, C up to 2^31 - 1, e.g. 65,537): grid and block
//    y over rows, x over a row's items (16-byte output vectors, single
//    elements before the first and after the last 16-byte boundary of a
//    row), the gathered values read straight from x through L1 after the
//    shift. A third kernel that staged whole rows in shared memory (loads
//    independent of the shift, then a barrier) was measured and dropped: it
//    was slower than the warp kernel at every shape timed (PERF.md).
// No per-element division in either.
//
// offset_slice_sum's design: two kernels, one launch, chosen by the wrapper
// (ops/lane_shift.py `slice_sum_geometry`, which passes the geometry in). At a
// plane's size ((6152, 520) bf16 -> (6144, 512) f32: 6.4 MB read, 12.6 MB
// written) the bytes set the bound, 5.67 us, so the output is written with
// 16-byte stores and the input read with aligned 16-byte loads.
//  * `slice_sum_vec_kernel<N>`, for a 16-byte aligned x and a width that is a
//    multiple of 4: block (32, 8), a warp per output row (block y, then grid
//    y, looping), grid x over segments of 256 columns; lane l takes the 8
//    columns from col = 8 (32 blockIdx.x + l) (4 at the end of a width that
//    is 4 mod 8). For offset k its 8 source elements start at flat index
//    e = (row0 + i) C + off_k + col, inside the aligned vector e / 8 and,
//    unless e % 8 is 0, the next one; both are loaded (the second only when
//    it holds a needed element, so no load leaves x's 16-byte blocks) and
//    the 8 elements cut out with a funnel shift (`window16`). e % 8 is the
//    same on every lane of the warp, so the cut is uniform. N, the number of
//    offsets, is a template parameter: every offset's loads are issued
//    before the first add, and the sum runs in the order given, from 0.0f.
//    The loads of the N offsets overlap in L1; device memory sees each line
//    of the span once.
//  * `slice_sum_direct_kernel`, for the rest (a base off 16 bytes, a width
//    not a multiple of 4): grid and block x over columns, y over rows, one
//    output element a thread, its N source elements read straight from x.
// No per-element integer division in either: rows come from the block and
// warp index, columns from the lane.
//
// `launch_floor_kernel` does nothing in one CTA: its time in a chain of
// launches is the floor under every launch-bound kernel here.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // threads of a direct slice-sum block (lane_shift.py SLICE_THREADS)
constexpr int kMaxOffsets = 8;
constexpr int kRollThreads = 256;
constexpr int kSliceLaneCols = 8;  // output columns of a lane of the vector slice sum
constexpr int kSliceRows = 8;      // warps (output rows) of a vector slice-sum block

struct Offsets {
  int n;
  int v[kMaxOffsets];
};

// 16 bytes of raw bits: the roll moves bits, so bf16 is handled as uint16_t
// and f32 as uint32_t.
template <typename U>
union Vec16 {
  uint4 v;
  U e[16 / sizeof(U)];
};

// Output item t of a row whose first element has flat index `ob` (the output
// is 16-byte aligned): the row's first h elements up to a 16-byte boundary,
// n_vec aligned vectors of kVec elements, and `tail` elements after them.
// Items 0 .. n_vec-1 are the vectors (column h + t kVec); items n_vec ..
// n_vec+h+tail-1 are single elements (the h head columns, then the tail).
template <int kVec>
struct RowItems {
  int h, n_vec, tail;
  __device__ __forceinline__ RowItems(long long ob, int C) {
    h = static_cast<int>((kVec - (ob & (kVec - 1))) & (kVec - 1));
    h = h < C ? h : C;
    n_vec = (C - h) / kVec;
    tail = C - h - n_vec * kVec;
  }
  __device__ __forceinline__ int count() const { return n_vec + h + tail; }
  __device__ __forceinline__ int scalar_col(int t) const {
    const int u = t - n_vec;
    return u < h ? u : h + n_vec * kVec + (u - h);
  }
};

__device__ __forceinline__ int wrap(int i, int C) { return i >= C ? i - C : i; }

// Any row: threads y (grid y, then block y) walk the rows, threads x (grid
// x, then block x) a row's items; a vector's elements are read straight from
// x through L1 (their addresses depend on the shift, which is read first).
template <typename U, bool kDynamic>
__global__ void __launch_bounds__(kRollThreads)
roll_direct_kernel(const U* __restrict__ x, U* __restrict__ out, long long R, int C,
                   const int* __restrict__ shift_dev, int shift) {
  constexpr int kVec = 16 / sizeof(U);
  int s = kDynamic ? __ldg(shift_dev) : shift;
  if (kDynamic) {
    s %= C;
    if (s < 0) s += C;
  }
  for (long long r = static_cast<long long>(blockIdx.y) * blockDim.y + threadIdx.y; r < R;
       r += static_cast<long long>(gridDim.y) * blockDim.y) {
    const long long ob = r * C;
    const U* row = x + ob;
    const RowItems<kVec> it(ob, C);
    const int n = it.count();
    for (int t = blockIdx.x * blockDim.x + threadIdx.x; t < n; t += gridDim.x * blockDim.x) {
      if (t < it.n_vec) {
        const int c = it.h + t * kVec;
        const int src = c - s < 0 ? c - s + C : c - s;
        Vec16<U> val;
#pragma unroll
        for (int k = 0; k < kVec; ++k) val.e[k] = __ldg(row + wrap(src + k, C));
        *reinterpret_cast<uint4*>(out + ob + c) = val.v;
      } else {
        const int c = it.scalar_col(t);
        out[ob + c] = __ldg(row + (c - s < 0 ? c - s + C : c - s));
      }
    }
  }
}

// The 16 bytes that start `o` elements into vector a, continuing into b.
template <typename U>
__device__ __forceinline__ uint4 window16(const uint4& a, const uint4& b, int o) {
  const uint32_t w[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
  const int q = sizeof(U) == 2 ? o >> 1 : o;  // whole 32-bit words
  uint32_t sel[5];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
    sel[i] = q == 0 ? w[i] : q == 1 ? w[i + 1] : q == 2 ? w[i + 2] : w[i + 3];
  }
  uint32_t r[4];
  const bool half = sizeof(U) == 2 && (o & 1);  // bf16: a half-word more
#pragma unroll
  for (int j = 0; j < 4; ++j) r[j] = half ? __funnelshift_r(sel[j], sel[j + 1], 16) : sel[j];
  return make_uint4(r[0], r[1], r[2], r[3]);
}

__device__ __forceinline__ uint4 shfl16(const uint4& v, int lane) {
  return make_uint4(__shfl_sync(0xffffffffu, v.x, lane), __shfl_sync(0xffffffffu, v.y, lane),
                    __shfl_sync(0xffffffffu, v.z, lane), __shfl_sync(0xffffffffu, v.w, lane));
}

// Rows of at most 64 16-byte vectors (C a multiple of the vector, x 16-byte
// aligned): one warp per row, threads y over rows. Lane l loads vectors l and
// l + 32 of the row with aligned 16-byte loads that do not depend on the
// shift (a dynamic shift is loaded beside them); output vector v starts at
// element e = (v * kVec - s) mod C, inside vectors e / kVec and the one after
// it (wrapping to 0), which the warp hands over with shuffles; the 16 bytes
// are cut out of the pair with a funnel shift. No shared memory, no barrier:
// the chain of dependent memory accesses is a load and a store, as in
// torch.roll.
template <typename U, bool kDynamic>
__global__ void __launch_bounds__(kRollThreads)
roll_warp_kernel(const U* __restrict__ x, U* __restrict__ out, long long R, int C,
                 const int* __restrict__ shift_dev, int shift) {
  constexpr int kVec = 16 / sizeof(U);
  const long long r = static_cast<long long>(blockIdx.x) * blockDim.y + threadIdx.y;
  if (r >= R) return;  // a whole warp: r is the same on its lanes
  int s = kDynamic ? __ldg(shift_dev) : shift;
  const int lane = threadIdx.x;
  const int nv = C / kVec;
  const uint4* xr = reinterpret_cast<const uint4*>(x + r * C);
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  const uint4 v0 = lane < nv ? __ldg(xr + lane) : zero;
  const uint4 v1 = lane + 32 < nv ? __ldg(xr + lane + 32) : zero;
  if (kDynamic) {
    s %= C;
    if (s < 0) s += C;
  }
  uint4* orow = reinterpret_cast<uint4*>(out + r * C);
  for (int k = 0; k < (nv > 32 ? 2 : 1); ++k) {
    const int v = lane + 32 * k;
    int e = v * kVec - s;
    if (e < 0) e += C;
    const int a = e / kVec, o = e & (kVec - 1);
    const int b = a + 1 >= nv ? a + 1 - nv : a + 1;
    uint4 wa = shfl16(v0, a & 31), wb = shfl16(v0, b & 31);
    if (nv > 32) {  // the second half of the row is in each lane's v1
      const uint4 wa1 = shfl16(v1, a & 31), wb1 = shfl16(v1, b & 31);
      if (a >= 32) wa = wa1;
      if (b >= 32) wb = wb1;
    }
    if (v < nv) orow[v] = window16<U>(wa, wb, o);
  }
}

// A bf16 in the low or high half of a 32-bit word, as f32 (exact).
__device__ __forceinline__ float bf16_lo(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }

// A 16-byte aligned x, width % 4 == 0: see the note at the top. N offsets.
template <int N>
__global__ void __launch_bounds__(32 * kSliceRows)
slice_sum_vec_kernel(const uint16_t* __restrict__ x, float* __restrict__ out, int C, int row0,
                     int rows, int width, Offsets offs) {
  const int col = kSliceLaneCols * (blockIdx.x * 32 + threadIdx.x);
  if (col >= width) return;
  const int cnt = width - col < kSliceLaneCols ? width - col : kSliceLaneCols;  // 8, or 4
  const uint4* xv = reinterpret_cast<const uint4*>(x);
  for (int i = blockIdx.y * kSliceRows + threadIdx.y; i < rows; i += gridDim.y * kSliceRows) {
    const long long src = static_cast<long long>(row0 + i) * C + col;
    uint4 lo[N], hi[N];
    int o[N];
#pragma unroll
    for (int k = 0; k < N; ++k) {
      const long long e = src + offs.v[k];
      o[k] = static_cast<int>(e & 7);
      lo[k] = __ldg(xv + (e >> 3));
      hi[k] = o[k] + cnt > 8 ? __ldg(xv + (e >> 3) + 1) : lo[k];
    }
    float acc[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[j] = 0.0f;
#pragma unroll
    for (int k = 0; k < N; ++k) {
      const uint4 w = window16<uint16_t>(lo[k], hi[k], o[k]);
      const uint32_t ws[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        acc[2 * j] += bf16_lo(ws[j]);
        acc[2 * j + 1] += bf16_hi(ws[j]);
      }
    }
    float4* orow = reinterpret_cast<float4*>(out + static_cast<long long>(i) * width + col);
    orow[0] = make_float4(acc[0], acc[1], acc[2], acc[3]);
    if (cnt == 8) orow[1] = make_float4(acc[4], acc[5], acc[6], acc[7]);
  }
}

// Any x and width: thread x a column, threads y (block y, then grid y) the rows.
__global__ void __launch_bounds__(kThreads)
slice_sum_direct_kernel(const __nv_bfloat16* __restrict__ x, float* __restrict__ out, int C,
                        int row0, int rows, int width, Offsets offs) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= width) return;
  for (int i = blockIdx.y * blockDim.y + threadIdx.y; i < rows; i += gridDim.y * blockDim.y) {
    const __nv_bfloat16* src = x + static_cast<long long>(row0 + i) * C + j;
    float acc = 0.0f;
#pragma unroll
    for (int k = 0; k < kMaxOffsets; ++k) {  // unrolled: offs.v stays in the parameter space
      if (k < offs.n) acc += __bfloat162float(__ldg(src + offs.v[k]));
    }
    out[static_cast<long long>(i) * width + j] = acc;
  }
}

__global__ void launch_floor_kernel() {}

template <int N>
void launch_slice_vec(const void* x, float* out, int C, int row0, int rows, int width,
                      const Offsets& offs, dim3 grid, dim3 block, cudaStream_t st) {
  slice_sum_vec_kernel<N><<<grid, block, 0, st>>>(static_cast<const uint16_t*>(x), out, C, row0,
                                                  rows, width, offs);
}

// Launch geometry from the wrapper (ops/lane_shift.py `roll_geometry`):
// kind 0 is the direct kernel (grid (gx, gy), block (bx, by)), 1 the warp one
// (grid gx, block (32, by)).
template <typename U>
int launch_roll(const void* x, void* out, long long R, int C, const void* shift_dev, int shift,
                int kind, int gx, int gy, int bx, int by, void* stream) {
  if (R * C == 0) return 0;
  auto st = static_cast<cudaStream_t>(stream);
  const U* xp = static_cast<const U*>(x);
  U* op = static_cast<U*>(out);
  const int* sp = static_cast<const int*>(shift_dev);
  const bool dyn = sp != nullptr;
  const dim3 block(bx, by);
  if (kind == 1) {
    if (dyn) {
      roll_warp_kernel<U, true><<<gx, block, 0, st>>>(xp, op, R, C, sp, 0);
    } else {
      roll_warp_kernel<U, false><<<gx, block, 0, st>>>(xp, op, R, C, nullptr, shift);
    }
  } else if (kind == 0) {
    const dim3 grid(gx, gy);
    if (dyn) {
      roll_direct_kernel<U, true><<<grid, block, 0, st>>>(xp, op, R, C, sp, 0);
    } else {
      roll_direct_kernel<U, false><<<grid, block, 0, st>>>(xp, op, R, C, nullptr, shift);
    }
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// shift_dev: a device pointer to one int32 (dynamic variant), or null to use
// `shift` (static variant, 0 <= shift < C); then the launch geometry of
// `launch_roll`. Returns cudaGetLastError().
extern "C" int roll_last_axis_f32(const void* x, void* out, long long R, int C,
                                  const void* shift_dev, int shift, int kind, int gx, int gy,
                                  int bx, int by, void* stream) {
  return launch_roll<uint32_t>(x, out, R, C, shift_dev, shift, kind, gx, gy, bx, by, stream);
}

extern "C" int roll_last_axis_bf16(const void* x, void* out, long long R, int C,
                                   const void* shift_dev, int shift, int kind, int gx, int gy,
                                   int bx, int by, void* stream) {
  return launch_roll<uint16_t>(x, out, R, C, shift_dev, shift, kind, gx, gy, bx, by, stream);
}

// offsets: a host array of n_offsets (1..8) column offsets, copied into the
// kernel's arguments; then the launch geometry from the wrapper
// (ops/lane_shift.py `slice_sum_geometry`): kind 1 is the vector kernel (grid
// (gx, gy), block (32, 8)), 0 the direct one (grid (gx, gy), block (bx, by)).
// Returns cudaGetLastError(), or cudaErrorInvalidValue for a bad count or kind.
extern "C" int offset_slice_sum_bf16(const void* x, void* out, int C, int row0, int rows,
                                     int width, const int* offsets, int n_offsets, int kind,
                                     int gx, int gy, int bx, int by, void* stream) {
  if (n_offsets < 1 || n_offsets > kMaxOffsets) return static_cast<int>(cudaErrorInvalidValue);
  Offsets offs;
  offs.n = n_offsets;
  for (int k = 0; k < kMaxOffsets; ++k) offs.v[k] = k < n_offsets ? offsets[k] : 0;
  if (static_cast<long long>(rows) * width == 0) return 0;
  auto st = static_cast<cudaStream_t>(stream);
  float* op = static_cast<float*>(out);
  const dim3 grid(gx, gy), block(bx, by);
  if (kind == 1) {
    switch (n_offsets) {
      case 1: launch_slice_vec<1>(x, op, C, row0, rows, width, offs, grid, block, st); break;
      case 2: launch_slice_vec<2>(x, op, C, row0, rows, width, offs, grid, block, st); break;
      case 3: launch_slice_vec<3>(x, op, C, row0, rows, width, offs, grid, block, st); break;
      case 4: launch_slice_vec<4>(x, op, C, row0, rows, width, offs, grid, block, st); break;
      case 5: launch_slice_vec<5>(x, op, C, row0, rows, width, offs, grid, block, st); break;
      case 6: launch_slice_vec<6>(x, op, C, row0, rows, width, offs, grid, block, st); break;
      case 7: launch_slice_vec<7>(x, op, C, row0, rows, width, offs, grid, block, st); break;
      default: launch_slice_vec<8>(x, op, C, row0, rows, width, offs, grid, block, st); break;
    }
  } else if (kind == 0) {
    slice_sum_direct_kernel<<<grid, block, 0, st>>>(static_cast<const __nv_bfloat16*>(x), op, C,
                                                    row0, rows, width, offs);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// The launch floor: one CTA of one warp that does nothing (x and out unused,
// so that it launches through the same helper as the kernels above).
extern "C" int launch_floor(const void* x, void* out, void* stream) {
  launch_floor_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
