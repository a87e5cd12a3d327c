// The ray-distance Sim(3) pose Gauss-Newton (mast3r_slam_torch/ops/pose_gn.py).
//
// Replaces no Pallas kernel: the JAX package leaves this loop to XLA
// (mast3r_slam_tpu/ops/gauss_newton.py `gauss_newton_pose_rays`,
// `_pose_gn_loop_rays_soa`, inside a lax.while_loop). The port's plain loop
// (ops/gauss_newton.py `_pose_gn_loop_rays_soa` + `_pose_gn_iterate`) issues
// ~650 PyTorch kernels an iteration: the residuals, the robust weights, the 28
// Jacobian products, a [7, 4N] concatenation, a small-tile f32 GEMM for H and
// g, cholesky_ex and two triangular solves, the retraction and the loop's
// torch.where state. It is bound by those launches (the same ~10 ms a frame
// at 196,608 points as at 84,672), so this kernel does one iteration in one
// launch.
//
// What bounds it on the card: an iteration reads Xf (3 floats), rd_k (4) and
// sqrt_info (4) of every point once, 8.65 MB at 196,608 points (2.6 us at
// 3.35 TB/s, less from the 50 MB L2 that holds them after the first pass),
// against a launch floor of ~1 us in a graph; the per-point arithmetic (~250
// f32 operations) is a few us of the card's 67 TFLOP/s. What follows the
// pass is serial: one block sums the partials and one thread solves the 7x7
// system and retracts.
//
// Design (grid: blocks over N per stream x streams B; 256 threads):
//   * pose_gn_init (one launch a solve): state <- T_init, old / new cost and
//     step norm <- inf, done, iterations and the stream's ticket <- 0.
//   * pose_gn_iterate (one launch an iteration, the same launch every time):
//       - a stream whose device `done` flag is set returns at once, so a
//         finished stream costs later iterations a launch, not a pass (JAX's
//         while_loop exit, on the device);
//       - each thread walks points n = blockIdx.x * 256 + tid, stepping by
//         the grid, reading the inputs through the strides the wrapper
//         passes (Xf is a [N, 3] view of row stride 5 into the matcher's
//         payload, read in place), and accumulates the 28 upper entries of
//         H, the 7 of g and the cost in f32 registers: the residual, robust
//         weight and folded Jacobian rows of `_pose_gn_loop_rays_soa`;
//       - warp shuffles and shared memory reduce the block to 36 sums, stored
//         to partials [B, blocks, 36];
//       - a threadfence and a per-stream ticket pick the stream's last block,
//         which sums the partials in a fixed order (no float atomics, so two
//         identical solves are bit-equal), resets the ticket, and in one
//         thread adds reg * I, factors the 7x7 system (Cholesky in
//         registers), solves, gives the stream a zero step on a non-positive
//         pivot or a non-finite step (cholesky_solve's NaN and the
//         finiteness guard), retracts on the left (lie.sim3_retract), and
//         updates T, the costs, the step norm and the iteration count in
//         `_pose_gn_iterate`'s order. The convergence test that
//         `_pose_gn_iterate` makes before iteration i + 1 is made here, right
//         after iteration i's update, from the same values, and sets `done`.
// Everything is f32, as in the plain loop; only the order of the sums differs.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;  // ops/pose_gn.py THREADS
constexpr int kWarps = kThreads / 32;
constexpr int kSums = 36;      // 28 upper entries of H, 7 of g, the cost
constexpr int kState = 12;     // floats a stream: T[8], old cost, new cost, step norm, pad
constexpr int kIState = 4;     // ints a stream: done, iterations, ticket, pad
constexpr int kOld = 8, kNew = 9, kDelta = 10;
constexpr int kDone = 0, kIters = 1, kTicket = 2;

struct Inputs {
  const float* X;
  long long xb, xn, xc;
  const float* rd;
  long long rb, rn, rc;
  const float* w;
  long long wb, wn, wc;
  int n;
};

struct Knobs {
  float k;  // huber_k or tukey_t
  float reg;
  float rel_error;
  float delta_thresh;
};

template <int kRobust>
__device__ __forceinline__ float robust_weight(float r, float k) {
  const float a = fabsf(r);
  if (kRobust == 0) {  // Huber: 1 inside the k-tube, k / |r| outside (|r| clamped at 1e-12)
    return a < k ? 1.0f : k / (a < 1e-12f ? 1e-12f : a);
  }
  const float q = r / k;  // Tukey: (1 - (r/t)^2)^2 inside the t-tube, 0 outside
  const float tmp = 1.0f - q * q;
  return a < k ? tmp * tmp : 0.0f;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ constexpr int upper(int a, int c) {  // (a <= c) -> 0..27
  return a * 7 - a * (a - 1) / 2 + (c - a);
}

// so(3) -> unit quaternion [x, y, z, w], Taylor branch below theta^2 = 1e-6
// (lie.so3_exp).
__device__ void so3_exp(const float phi[3], float q[4]) {
  const float th2 = phi[0] * phi[0] + phi[1] * phi[1] + phi[2] * phi[2];
  const float th = sqrtf(th2 + 1e-8f);
  const bool small = th2 < 1e-6f;
  const float imag = small ? 0.5f - th2 / 48.0f : sinf(0.5f * th) / th;
  const float real = small ? 1.0f - th2 / 8.0f : cosf(0.5f * th);
  q[0] = imag * phi[0];
  q[1] = imag * phi[1];
  q[2] = imag * phi[2];
  q[3] = real;
}

__device__ void quat_to_matrix(const float q[4], float R[3][3]) {
  const float x = q[0], y = q[1], z = q[2], w = q[3];
  const float xx = x * x, yy = y * y, zz = z * z, xy = x * y, xz = x * z, yz = y * z;
  const float wx = w * x, wy = w * y, wz = w * z;
  R[0][0] = 1 - 2 * (yy + zz); R[0][1] = 2 * (xy - wz); R[0][2] = 2 * (xz + wy);
  R[1][0] = 2 * (xy + wz); R[1][1] = 1 - 2 * (xx + zz); R[1][2] = 2 * (yz - wx);
  R[2][0] = 2 * (xz - wy); R[2][1] = 2 * (yz + wx); R[2][2] = 1 - 2 * (xx + yy);
}

__device__ void matmul3(const float A[3][3], const float B[3][3], float C[3][3]) {
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) C[i][j] = A[i][0] * B[0][j] + A[i][1] * B[1][j] + A[i][2] * B[2][j];
}

__device__ void cross(const float a[3], const float b[3], float c[3]) {
  c[0] = a[1] * b[2] - a[2] * b[1];
  c[1] = a[2] * b[0] - a[0] * b[2];
  c[2] = a[0] * b[1] - a[1] * b[0];
}

// v + qw (2 qv x v) + qv x (2 qv x v) (lie.quat_rotate)
__device__ void quat_rotate(const float q[4], const float v[3], float out[3]) {
  float uv[3], c[3];
  cross(q, v, uv);
  uv[0] *= 2.0f; uv[1] *= 2.0f; uv[2] *= 2.0f;
  cross(q, uv, c);
#pragma unroll
  for (int i = 0; i < 3; ++i) out[i] = v[i] + q[3] * uv[i] + c[i];
}

// T <- exp(xi) * T (lie.sim3_retract: sim3_exp with _sim3_W's scaling and six
// doublings, then sim3_mul).
__device__ void sim3_retract(float T[8], const float xi[7]) {
  const float v[3] = {xi[0], xi[1], xi[2]};
  const float om[3] = {xi[3], xi[4], xi[5]};
  const float sigma = xi[6];
  float qe[4];
  so3_exp(om, qe);
  const float se = expf(sigma);

  const float scale = 1.0f / 64.0f;  // 0.5 ** _W_DOUBLINGS
  const float K[3][3] = {{0.0f, -om[2], om[1]}, {om[2], 0.0f, -om[0]}, {-om[1], om[0], 0.0f}};
  float M[3][3], W[3][3], MW[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      M[i][j] = sigma * (i == j ? 1.0f : 0.0f) * scale + K[i][j] * scale;
      W[i][j] = (i == j ? 1.0f : 0.0f) + M[i][j] / 6.0f;
    }
  const float den[4] = {5.0f, 4.0f, 3.0f, 2.0f};
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    matmul3(M, W, MW);
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j) W[i][j] = (i == j ? 1.0f : 0.0f) + MW[i][j] / den[s];
  }
  for (int d = 0; d < 6; ++d) {
    const float es = ldexpf(1.0f, d - 6);  // 0.5 ** (6 - d)
    const float oms[3] = {om[0] * es, om[1] * es, om[2] * es};
    float q[4], R[3][3], IE[3][3];
    so3_exp(oms, q);
    quat_to_matrix(q, R);
    const float e = expf(sigma * es);
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j) IE[i][j] = (i == j ? 1.0f : 0.0f) + e * R[i][j];
    matmul3(IE, W, MW);
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j) W[i][j] = 0.5f * MW[i][j];
  }
  float te[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) te[i] = W[i][0] * v[0] + W[i][1] * v[1] + W[i][2] * v[2];

  // sim3_mul((te, qe, se), T)
  const float tb[3] = {T[0], T[1], T[2]};
  const float qb[4] = {T[3], T[4], T[5], T[6]};
  float rt[3];
  quat_rotate(qe, tb, rt);
  T[0] = se * rt[0] + te[0];
  T[1] = se * rt[1] + te[1];
  T[2] = se * rt[2] + te[2];
  const float x1 = qe[0], y1 = qe[1], z1 = qe[2], w1 = qe[3];
  const float x2 = qb[0], y2 = qb[1], z2 = qb[2], w2 = qb[3];
  T[3] = w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2;
  T[4] = w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2;
  T[5] = w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2;
  T[6] = w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2;
  T[7] = se * T[7];
}

// One Gauss-Newton step of one stream from its summed system, and the state
// update of `_pose_gn_iterate` (one thread).
__device__ void solve_and_update(float* st, int* ist, const float* tot, const Knobs kn) {
  float A[7][7];
#pragma unroll
  for (int a = 0; a < 7; ++a)
#pragma unroll
    for (int c = a; c < 7; ++c) A[a][c] = A[c][a] = tot[upper(a, c)];
#pragma unroll
  for (int a = 0; a < 7; ++a) A[a][a] += kn.reg;
  const float cost = 0.5f * tot[35];

  float L[7][7];
  bool ok = true;
#pragma unroll
  for (int j = 0; j < 7; ++j) {
    float s = A[j][j];
#pragma unroll
    for (int q = 0; q < j; ++q) s -= L[j][q] * L[j][q];
    ok = ok && s > 0.0f;  // a non-positive (or NaN) pivot: not positive definite
    const float d = sqrtf(s);
    L[j][j] = d;
#pragma unroll
    for (int i = j + 1; i < 7; ++i) {
      float v = A[i][j];
#pragma unroll
      for (int q = 0; q < j; ++q) v -= L[i][q] * L[j][q];
      L[i][j] = v / d;
    }
  }
  float y[7], tau[7];
#pragma unroll
  for (int i = 0; i < 7; ++i) {  // L y = -g
    float v = -tot[28 + i];
#pragma unroll
    for (int q = 0; q < i; ++q) v -= L[i][q] * y[q];
    y[i] = v / L[i][i];
  }
#pragma unroll
  for (int i = 6; i >= 0; --i) {  // L^T tau = y
    float v = y[i];
#pragma unroll
    for (int q = i + 1; q < 7; ++q) v -= L[q][i] * tau[q];
    tau[i] = v / L[i][i];
  }
#pragma unroll
  for (int i = 0; i < 7; ++i) ok = ok && isfinite(tau[i]);
  float dn2 = 0.0f;
#pragma unroll
  for (int i = 0; i < 7; ++i) {
    if (!ok) tau[i] = 0.0f;  // this stream alone takes a zero step
    dn2 += tau[i] * tau[i];
  }
  float T[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) T[i] = st[i];
  sim3_retract(T, tau);
#pragma unroll
  for (int i = 0; i < 8; ++i) st[i] = T[i];
  const float old_cost = st[kNew];
  const float delta = sqrtf(dn2);
  st[kOld] = old_cost;
  st[kNew] = cost;
  st[kDelta] = delta;
  ist[kIters] += 1;
  // the test _pose_gn_iterate makes before the next iteration
  if (fabsf(old_cost - cost) / (old_cost + 1e-10f) < kn.rel_error || delta < kn.delta_thresh)
    ist[kDone] = 1;
}

__global__ void init_kernel(const float* T0, long long tb, long long tc, int B, float* st,
                            int* ist) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
#pragma unroll
  for (int c = 0; c < 8; ++c) st[b * kState + c] = T0[b * tb + c * tc];
  st[b * kState + kOld] = INFINITY;
  st[b * kState + kNew] = INFINITY;
  st[b * kState + kDelta] = INFINITY;
#pragma unroll
  for (int c = 0; c < kIState; ++c) ist[b * kIState + c] = 0;
}

template <int kRobust>
__global__ void __launch_bounds__(kThreads)
    iterate_kernel(const Inputs in, float* state, int* istate, float* partials, const Knobs kn) {
  const int b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nblk = gridDim.x;
  float* st = state + b * kState;
  int* ist = istate + b * kIState;
  if (ist[kDone]) return;  // the stream has converged: its loop has exited

  float T[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) T[i] = st[i];
  const float qv[3] = {T[3], T[4], T[5]};
  const float qw = T[6], s = T[7];

  float acc[kSums];
#pragma unroll
  for (int i = 0; i < kSums; ++i) acc[i] = 0.0f;

  const float* X = in.X + b * in.xb;
  const float* rd = in.rd + b * in.rb;
  const float* w = in.w + b * in.wb;
  for (int n = blockIdx.x * kThreads + tid; n < in.n; n += nblk * kThreads) {
    const float x[3] = {__ldg(X + n * in.xn), __ldg(X + n * in.xn + in.xc),
                        __ldg(X + n * in.xn + 2 * in.xc)};
    float rk[4], wt[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      rk[r] = __ldg(rd + n * in.rn + r * in.rc);
      wt[r] = __ldg(w + n * in.wn + r * in.wc);
    }
    // P = s (X + qw uv + qv x uv) + t, uv = 2 qv x X
    float uv[3], c[3];
    cross(qv, x, uv);
    uv[0] *= 2.0f; uv[1] *= 2.0f; uv[2] *= 2.0f;
    cross(qv, uv, c);
    float P[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) P[i] = s * (x[i] + qw * uv[i] + c[i]) + T[i];
    const float d = sqrtf(P[0] * P[0] + P[1] * P[1] + P[2] * P[2] + 1e-10f);
    const float dinv = 1.0f / d;
    const float r0 = P[0] * dinv, r1 = P[1] * dinv, r2 = P[2] * dinv;
    const float res[4] = {rk[0] - r0, rk[1] - r1, rk[2] - r2, rk[3] - d};
    // [ d^-1 (I - r r^T) | -[r]x | 0 ]
    // [        r^T       |   0   | d ]
    const float J[4][7] = {
        {dinv * (1.0f - r0 * r0), -dinv * r0 * r1, -dinv * r0 * r2, 0.0f, r2, -r1, 0.0f},
        {-dinv * r1 * r0, dinv * (1.0f - r1 * r1), -dinv * r1 * r2, -r2, 0.0f, r0, 0.0f},
        {-dinv * r2 * r0, -dinv * r2 * r1, dinv * (1.0f - r2 * r2), r1, -r0, 0.0f, 0.0f},
        {r0, r1, r2, 0.0f, 0.0f, 0.0f, d}};
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float rb = wt[r] * sqrtf(robust_weight<kRobust>(wt[r] * res[r], kn.k));
      const float bv = rb * res[r];
      float bm[7];
#pragma unroll
      for (int a = 0; a < 7; ++a) bm[a] = -rb * J[r][a];
#pragma unroll
      for (int a = 0; a < 7; ++a) {
#pragma unroll
        for (int cc = a; cc < 7; ++cc) acc[upper(a, cc)] += bm[a] * bm[cc];
        acc[28 + a] += bm[a] * bv;
      }
      acc[35] += bv * bv;
    }
  }

  __shared__ float red[kWarps][kSums];
  __shared__ float tot[kSums];
  __shared__ int last;
#pragma unroll
  for (int i = 0; i < kSums; ++i) {
    const float v = warp_sum(acc[i]);
    if (lane == 0) red[warp][i] = v;
  }
  __syncthreads();
  float* part = partials + (static_cast<long long>(b) * nblk + blockIdx.x) * kSums;
  if (tid < kSums) {
    float v = red[0][tid];
#pragma unroll
    for (int k = 1; k < kWarps; ++k) v += red[k][tid];
    part[tid] = v;
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) last = atomicAdd(ist + kTicket, 1) == nblk - 1;
  __syncthreads();
  if (!last) return;

  // The stream's last block: its system, summed in a fixed order.
  __threadfence();
  const float* base = partials + static_cast<long long>(b) * nblk * kSums;
  for (int i = warp; i < kSums; i += kWarps) {
    float v = 0.0f;
    for (int j = lane; j < nblk; j += 32) v += __ldcg(base + j * kSums + i);
    v = warp_sum(v);
    if (lane == 0) tot[i] = v;
  }
  __syncthreads();
  if (tid == 0) {
    ist[kTicket] = 0;
    solve_and_update(st, ist, tot, kn);
  }
}

}  // namespace

// state [B, 12] f32 and istate [B, 4] int32 (device pointers) set for a new
// solve from T_init [B, 8] (element strides tb, tc). Returns a cudaError_t.
extern "C" int pose_gn_init(void* stream, const void* T0, long long tb, long long tc, int B,
                            void* state, void* istate) {
  const int threads = 128;
  init_kernel<<<(B + threads - 1) / threads, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(T0), tb, tc, B, static_cast<float*>(state),
      static_cast<int*>(istate));
  return cudaGetLastError();
}

// One Gauss-Newton iteration of B streams of n points each: Xf [B, n, 3], rd_k
// and sqrt_info [B, n, 4] f32 through element strides (batch, point, component);
// `blocks` blocks a stream; partials [B, blocks, 36] f32 scratch. robust 0 is
// Huber (k = huber_k), 1 Tukey (k = tukey_t). Returns a cudaError_t.
extern "C" int pose_gn_iterate(void* stream, int robust, const void* X, long long xb,
                               long long xn, long long xc, const void* rd, long long rb,
                               long long rn, long long rc, const void* w, long long wb,
                               long long wn, long long wc, int n, int B, int blocks, void* state,
                               void* istate, void* partials, float k, float reg, float rel_error,
                               float delta_thresh) {
  const Inputs in{static_cast<const float*>(X), xb, xn, xc, static_cast<const float*>(rd), rb, rn,
                  rc, static_cast<const float*>(w), wb, wn, wc, n};
  const Knobs kn{k, reg, rel_error, delta_thresh};
  const dim3 grid(blocks, B);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* st = static_cast<float*>(state);
  int* ist = static_cast<int*>(istate);
  float* part = static_cast<float*>(partials);
  if (robust == 0)
    iterate_kernel<0><<<grid, kThreads, 0, s>>>(in, st, ist, part, kn);
  else if (robust == 1)
    iterate_kernel<1><<<grid, kThreads, 0, s>>>(in, st, ist, part, kn);
  else
    return cudaErrorInvalidValue;
  return cudaGetLastError();
}
