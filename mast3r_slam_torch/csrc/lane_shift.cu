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
// dynamic variant reads s from device memory once per block (the counterpart of
// the SMEM scalar: the shift never travels to the host) and reduces it mod C; the
// static variant takes s as a kernel argument, and the Python wrapper refuses a
// static s outside [0, C).
//
// offset_slice_sum computes, for bf16 x [R, C] (row-major, contiguous),
//     out[i, j] = sum_k f32(x[row0 + i, off_k + j]),  i < rows, j < width,
// over at most 8 offsets passed by value, summed in the order given (starting
// from 0.0f), so the result is bit-equal to the plain version's running sum.
//
// What bounds them: both are pure data movement (a permutation copy and a
// 3-tap gather-add). Their least time is the bytes moved over 3.35 TB/s; at the
// probe shapes (<= 20 KB) that is ~5 ns, far under one launch, so launch latency
// sets the measured time. The design therefore stays simple: one thread per
// output element in a grid-stride loop, neighbouring threads on neighbouring
// output columns (coalesced stores; the shifted loads stay coalesced except at
// the one wrap-around point of each row).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 4096;
constexpr int kMaxOffsets = 8;

struct Offsets {
  int n;
  int v[kMaxOffsets];
};

template <typename T, bool kDynamic>
__global__ void roll_last_axis_kernel(const T* __restrict__ x, T* __restrict__ out,
                                      long long total, int C, const int* __restrict__ shift_dev,
                                      int shift) {
  int s = shift;
  if (kDynamic) {
    __shared__ int s_shared;
    if (threadIdx.x == 0) {
      int v = *shift_dev % C;
      s_shared = v < 0 ? v + C : v;
    }
    __syncthreads();
    s = s_shared;
  }
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < total;
       i += stride) {
    const long long row = i / C;
    const int c = static_cast<int>(i - row * C);
    int src = c - s;
    if (src < 0) src += C;
    out[i] = x[row * C + src];
  }
}

__global__ void offset_slice_sum_kernel(const __nv_bfloat16* __restrict__ x,
                                        float* __restrict__ out, int C, int row0, int rows,
                                        int width, Offsets offs) {
  const long long total = static_cast<long long>(rows) * width;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < total;
       i += stride) {
    const int r = static_cast<int>(i / width);
    const int j = static_cast<int>(i - static_cast<long long>(r) * width);
    const __nv_bfloat16* src = x + static_cast<long long>(row0 + r) * C + j;
    float acc = 0.0f;
    for (int k = 0; k < offs.n; ++k) acc += __bfloat162float(src[offs.v[k]]);
    out[i] = acc;
  }
}

int grid_for(long long total) {
  long long blocks = (total + kThreads - 1) / kThreads;
  if (blocks < 1) blocks = 1;
  return static_cast<int>(blocks < kMaxBlocks ? blocks : kMaxBlocks);
}

template <typename T>
int launch_roll(const void* x, void* out, long long R, int C, const void* shift_dev, int shift,
                void* stream) {
  const long long total = R * C;
  if (total == 0) return 0;
  auto st = static_cast<cudaStream_t>(stream);
  const T* xp = static_cast<const T*>(x);
  T* op = static_cast<T*>(out);
  if (shift_dev != nullptr) {
    roll_last_axis_kernel<T, true><<<grid_for(total), kThreads, 0, st>>>(
        xp, op, total, C, static_cast<const int*>(shift_dev), 0);
  } else {
    roll_last_axis_kernel<T, false><<<grid_for(total), kThreads, 0, st>>>(
        xp, op, total, C, nullptr, shift);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// shift_dev: a device pointer to one int32 (dynamic variant), or null to use
// `shift` (static variant, 0 <= shift < C). Returns cudaGetLastError().
extern "C" int roll_last_axis_f32(const void* x, void* out, long long R, int C,
                                  const void* shift_dev, int shift, void* stream) {
  return launch_roll<float>(x, out, R, C, shift_dev, shift, stream);
}

extern "C" int roll_last_axis_bf16(const void* x, void* out, long long R, int C,
                                   const void* shift_dev, int shift, void* stream) {
  return launch_roll<__nv_bfloat16>(x, out, R, C, shift_dev, shift, stream);
}

// offsets: a host array of n_offsets (<= 8) column offsets, copied into the
// kernel's arguments. Returns cudaGetLastError(), or cudaErrorInvalidValue for
// more than 8 offsets.
extern "C" int offset_slice_sum_bf16(const void* x, void* out, int C, int row0, int rows,
                                     int width, const int* offsets, int n_offsets,
                                     void* stream) {
  if (n_offsets < 0 || n_offsets > kMaxOffsets) return static_cast<int>(cudaErrorInvalidValue);
  Offsets offs;
  offs.n = n_offsets;
  for (int k = 0; k < kMaxOffsets; ++k) offs.v[k] = k < n_offsets ? offsets[k] : 0;
  const long long total = static_cast<long long>(rows) * width;
  if (total == 0) return 0;
  offset_slice_sum_kernel<<<grid_for(total), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<float*>(out), C, row0, rows, width, offs);
  return static_cast<int>(cudaGetLastError());
}
