// Batched dense solve M x = b for Hopper (sm_90a): LU with partial pivoting,
// one small system per warp.
//
// Semantics (those of `torch.linalg.solve_ex(M, b, check_errors=False)[0]` and
// of the reference's `jnp.linalg.solve`, LAPACK's getrf then getrs): M (B,n,n)
// and b (B,n), float32, row-major, contiguous; x (B,n). Column k's pivot is the
// first row at or below k of the largest |M[r][k]| (LAPACK's isamax); rows are
// swapped, the multipliers are M[r][k] * (1 / M[k][k]) and the trailing rows
// and b are updated in column order (getf2's rank-1 updates, which is also the
// order of getrs's forward substitution); then x comes from U by columns, last
// first (trsv's column-oriented back substitution). A singular M gives inf or
// NaN and no error, as with `check_errors=False`: nothing is read back.
//
// It replaces no TPU kernel: the reference solves with `jnp.linalg.solve`,
// which XLA compiles (e.g. mava_tpu/envs/pointcloud3d.py:58, mahopper.py:192).
// It exists because the articulated envs' step is captured as one CUDA graph
// (`envs/_dynamics.py`), and PyTorch's own batched solve on the card takes a
// route that cannot be captured for MaHumanoid's 23 x 23 systems once the
// batch exceeds 16 (a synchronising library path; measured on an H100).
//
// What bounds it on an H100: neither bytes nor operations. A 23 x 23 system
// is 2.1 KB and ~9,000 FLOP; a step of 16 envs holds 16 of them. The n pivot
// steps depend on each other, so a call costs about n times the latency of one
// step (a warp's argmax, a row swap and the rank-1 update), and the design
// keeps that step short: one warp per system, lane r owns row r of [M | b] in
// shared memory (rows padded to 33 floats, so a column read by 32 lanes hits
// 32 banks), the pivot search is 5 shuffles, and the only barriers are warp
// barriers. Four systems share a block.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kMaxN = 32;        // one lane per row
constexpr int kPitch = kMaxN + 1;  // padded row: conflict-free column reads
constexpr int kSystemsPerBlock = 4;

__global__ void __launch_bounds__(32 * kSystemsPerBlock)
batched_solve_kernel(const float* __restrict__ m, const float* __restrict__ rhs,
                     float* __restrict__ x, int batch, int n) {
  __shared__ float s_m[kSystemsPerBlock][kMaxN][kPitch];
  __shared__ float s_b[kSystemsPerBlock][kMaxN];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int system = blockIdx.x * kSystemsPerBlock + warp;
  if (system >= batch) return;  // whole warps leave; no block barrier below
  float (*a)[kPitch] = s_m[warp];
  float* b = s_b[warp];
  const float* mi = m + (size_t)system * n * n;
  for (int e = lane; e < n * n; e += 32) a[e / n][e % n] = mi[e];
  if (lane < n) b[lane] = rhs[(size_t)system * n + lane];
  __syncwarp();

  for (int k = 0; k < n; ++k) {
    // The pivot: the largest |a[r][k]| for r >= k, the first such row on ties.
    float best = lane >= k && lane < n ? fabsf(a[lane][k]) : -1.0f;
    int row = lane;
    for (int off = 16; off > 0; off >>= 1) {
      const float other = __shfl_xor_sync(0xffffffffu, best, off);
      const int other_row = __shfl_xor_sync(0xffffffffu, row, off);
      if (other > best || (other == best && other_row < row)) {
        best = other;
        row = other_row;
      }
    }
    row = __shfl_sync(0xffffffffu, row, 0);  // one row for the warp, NaNs or not
    if (row != k) {
      for (int c = lane; c < n; c += 32) {
        const float t = a[k][c];
        a[k][c] = a[row][c];
        a[row][c] = t;
      }
      if (lane == 0) {
        const float t = b[k];
        b[k] = b[row];
        b[row] = t;
      }
    }
    __syncwarp();
    if (lane > k && lane < n) {
      const float l = a[lane][k] * (1.0f / a[k][k]);
      a[lane][k] = l;
      for (int c = k + 1; c < n; ++c) a[lane][c] -= l * a[k][c];
      b[lane] -= l * b[k];
    }
    __syncwarp();
  }

  // Back substitution by columns, last first: x_i = b_i / u_ii, then every
  // row above takes u_ri * x_i off its b.
  for (int i = n - 1; i >= 0; --i) {
    const float xi = b[i] / a[i][i];
    __syncwarp();
    if (lane == i) b[i] = xi;
    if (lane < i) b[lane] -= xi * a[lane][i];
    __syncwarp();
  }
  if (lane < n) x[(size_t)system * n + lane] = b[lane];
}

}  // namespace

extern "C" {

// x = M^-1 b for `batch` systems of size n <= 32 on `stream`; returns the
// launch's error code (0 = success) and never synchronises.
int batched_solve(const float* m, const float* rhs, float* x, int batch, int n, void* stream) {
  if (n < 1 || n > kMaxN || batch < 1) return (int)cudaErrorInvalidValue;
  const int blocks = (batch + kSystemsPerBlock - 1) / kSystemsPerBlock;
  batched_solve_kernel<<<blocks, 32 * kSystemsPerBlock, 0, (cudaStream_t)stream>>>(
      m, rhs, x, batch, n);
  return (int)cudaGetLastError();
}

// The most rows a system may have.
int batched_solve_max_n() { return kMaxN; }

}  // extern "C"
