// Device stamps for the port's tracer (mast3r_slam_torch/utils/profiling.py).
//
// Replaces no TPU kernel: the JAX package's window program has no device
// clock marks. It was added so that a tracking window captured as one CUDA
// graph can say where its device time goes by stage. A stamp is a one-thread
// kernel that reads %globaltimer (ns) and writes it into one slot of one row
// of the tracer's store. Launched under stream capture it becomes a kernel
// node, so it fires, in stream order, on every replay:
//
//   * the window's first stamp (begin = 1) takes the next row from a device
//     counter (state[0]) and leaves it in state[1]; every later stamp of the
//     window writes slot `slot` of that row, so one static graph fills a new
//     row per replay;
//   * the store lies in pinned host memory mapped into the card's address
//     space (trace_device_pointer), so no copy is queued and the host reads
//     the rows after a wait it makes anyway; a row beyond `rows` is dropped
//     (the host counts those);
//   * trace_clock writes one globaltimer read for the tracer's calibration
//     pairs, which map globaltimer onto the host's clock.
//
// What bounds it: a launch. One thread, one 8-byte store; in a graph a kernel
// node costs the device about a microsecond, against a window of ~85,000
// kernels. globaltimer ticks in ns but may advance in steps of up to ~1 us.

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ unsigned long long globaltimer() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__global__ void stamp_kernel(unsigned long long* store, int* state, int slot, int width,
                             int rows, int begin) {
  unsigned long long t = globaltimer();
  int row;
  if (begin) {
    row = state[0];
    state[0] = row + 1;
    state[1] = row;
  } else {
    row = state[1];
  }
  if (row < rows) store[static_cast<long long>(row) * width + slot] = t;
}

__global__ void clock_kernel(unsigned long long* out) { *out = globaltimer(); }

}  // namespace

// One stamp on `stream` into `store` (rows x width, device-visible pointer),
// slot `slot`; `begin` starts a row. Returns a cudaError_t.
extern "C" int trace_stamp(void* stream, void* store, void* state, int slot, int width, int rows,
                           int begin) {
  stamp_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<unsigned long long*>(store), static_cast<int*>(state), slot, width, rows, begin);
  return cudaGetLastError();
}

// globaltimer into *out (device-visible pointer), on `stream`.
extern "C" int trace_clock(void* stream, void* out) {
  clock_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<unsigned long long*>(out));
  return cudaGetLastError();
}

// The card's pointer to pinned host memory at `host`, or null.
extern "C" void* trace_device_pointer(void* host) {
  void* dev = nullptr;
  if (cudaHostGetDevicePointer(&dev, host, 0) != cudaSuccess) return nullptr;
  return dev;
}
