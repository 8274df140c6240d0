// GRU recurrence over a whole sequence, forward and backward, for Hopper (sm_90a).
//
// Semantics (identical to mava_tpu/ops/pallas_gru.py, per step t):
//     h_t  = keep_t * h_{t-1}                         keep = 1 - reset
//     r, z = sigmoid(x{r,z}_t + (h_t @ Wh){r,z})
//     n    = tanh(xn_t + r * ((h_t @ Wh)n + b_hn))
//     h'_t = (1 - z) * n + z * h_t                    emitted as hs[t]
// Shapes: gates_i (T,B,3H) = x @ Wi + bi, keep (T,B,H), h0 (B,H), Wh (H,3H),
// b_hn (H), hs (T,B,H). All float32, row-major, contiguous. No TF32: every
// product is an fp32 FMA.
//
// Three kernels, bound by a plain C interface (ctypes) at the bottom of the file:
//
// K1 gru_fwd_kernel replaces `_fwd_kernel` (mava_tpu/ops/pallas_gru.py:69-85,
//    launched by `_fwd_call` at :190). The TPU grid (row_blocks, T) runs in
//    order on one core and carries h in a VMEM scratch. Here one thread block
//    owns a tile of kRows batch rows and loops over T itself; its carry stays
//    in shared memory for the whole sequence, and there is one launch per call.
//    Wh is read from global memory each step (192 KiB at H = 128: it stays
//    resident in the 50 MB L2).
//
// K2a gru_bwd_recurrence_kernel and K2b gru_bwd_reduce_kernel together replace
//    `_bwd_kernel` (:88-145, launched by `_gru_bwd` at :230). The TPU kernel
//    accumulates dWh and db_hn in constant-index output blocks across its
//    sequential grid; Hopper blocks run in parallel and in no order, so the
//    work is split in two:
//    K2a walks time in reverse per row tile (the layout of K1), recomputes the
//        gates from hprev = [h0, hs[:-1]] (no activations are saved), writes
//        dgates_i and dh0, and writes the recurrent-side cotangent
//        dgh = [dar, daz, dan*r] (T,B,3H) to a scratch buffer.
//    K2b reduces dWh = sum_{t,b} (hprev*keep)^T dgh and db_hn = sum dgh_n. Each
//        block owns one 32x32 tile of dWh (with one extra row of ones for
//        db_hn) and walks all T*B rows in a fixed order, with no atomics: the
//        result is bitwise the same from run to run.
//
// What bounds them on an H100: at the slice's batch (B <= 32 rows, H = 128)
// K1 and K2a are latency-bound by the serial T loop. ceil(B/8) blocks run on
// a few of the 132 SMs, each doing an 8 x 128 x 384 product per step from
// L2-resident Wh plus three block barriers. K2b is small and parallel
// (60 blocks at H = 128).
//
// Left for later: split the three gate blocks of Wh over a 3-CTA cluster
// (each CTA keeps a 64 KiB block in shared memory or registers and the CTAs
// exchange h through distributed shared memory), feed the per-step product to
// wgmma with TMA-staged tiles, and spread rows over more SMs.

#include <cuda_runtime.h>

namespace {

constexpr int kRows = 8;         // batch rows per block in K1 and K2a
constexpr int kMaxThreads = 512; // threads per block in K1 and K2a
constexpr int kTile = 32;        // K2b: dWh tile edge
constexpr int kChunk = 32;       // K2b: rows staged in shared memory per pass
constexpr int kReduceThreads = 256;

__device__ __forceinline__ float sigmoid_f(float x) { return 1.0f / (1.0f + expf(-x)); }

// gh[r][j] = sum_k h[r][k] * Wh[k][j] for the block's kRows rows, j over 3H.
__device__ __forceinline__ void tile_times_wh(const float* __restrict__ h_s,
                                              const float* __restrict__ w_h,
                                              float* __restrict__ gh_s, int H) {
  const int H3 = 3 * H;
  for (int j = threadIdx.x; j < H3; j += blockDim.x) {
    float acc[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) acc[r] = 0.0f;
    for (int k = 0; k < H; ++k) {
      const float w = __ldg(w_h + (size_t)k * H3 + j);
#pragma unroll
      for (int r = 0; r < kRows; ++r) acc[r] = fmaf(h_s[r * H + k], w, acc[r]);
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) gh_s[r * H3 + j] = acc[r];
  }
}

// K1. Grid: ceil(B / kRows) blocks. Shared memory: kRows * 4H floats.
__global__ void __launch_bounds__(kMaxThreads)
gru_fwd_kernel(const float* __restrict__ gates_i, const float* __restrict__ keep,
               const float* __restrict__ h0, const float* __restrict__ w_h,
               const float* __restrict__ b_hn, float* __restrict__ hs, int T, int B,
               int H) {
  extern __shared__ float smem[];
  float* h_s = smem;            // (kRows, H): the carry, then carry * keep
  float* gh_s = smem + kRows * H; // (kRows, 3H): h @ Wh
  const int H3 = 3 * H;
  const int row0 = blockIdx.x * kRows;
  const int nrows = min(kRows, B - row0);

  // Rows past B stay zero throughout (ragged last tile).
  for (int i = threadIdx.x; i < kRows * H; i += blockDim.x) {
    const int r = i / H, c = i % H;
    h_s[i] = r < nrows ? h0[(size_t)(row0 + r) * H + c] : 0.0f;
  }
  for (int t = 0; t < T; ++t) {
    const size_t base = (size_t)t * B;
    // Phase 1: reset the carry. Each thread touches only its own slots, as in
    // phase 3, so no barrier is needed before it.
    for (int i = threadIdx.x; i < nrows * H; i += blockDim.x) {
      const int r = i / H, c = i % H;
      h_s[i] *= keep[(base + row0 + r) * H + c];
    }
    __syncthreads();
    tile_times_wh(h_s, w_h, gh_s, H);  // Phase 2
    __syncthreads();
    // Phase 3: gates and the new carry. gh_s is rewritten only after the next
    // step's first barrier, which every thread reaches after this phase.
    for (int i = threadIdx.x; i < nrows * H; i += blockDim.x) {
      const int r = i / H, c = i % H;
      const float* g = gates_i + (base + row0 + r) * H3;
      const float* gh = gh_s + r * H3;
      const float rg = sigmoid_f(g[c] + gh[c]);
      const float z = sigmoid_f(g[H + c] + gh[H + c]);
      const float n = tanhf(g[2 * H + c] + rg * (gh[2 * H + c] + b_hn[c]));
      const float h_new = (1.0f - z) * n + z * h_s[i];
      hs[(base + row0 + r) * H + c] = h_new;
      h_s[i] = h_new;
    }
  }
}

// K2a. Grid: ceil(B / kRows) blocks. Shared memory: kRows * 5H floats.
__global__ void __launch_bounds__(kMaxThreads)
gru_bwd_recurrence_kernel(const float* __restrict__ gates_i,
                          const float* __restrict__ keep, const float* __restrict__ h0,
                          const float* __restrict__ w_h, const float* __restrict__ w_h_t,
                          const float* __restrict__ b_hn, const float* __restrict__ hs,
                          const float* __restrict__ g_hs, float* __restrict__ dgates,
                          float* __restrict__ dgh, float* __restrict__ dh0, int T, int B,
                          int H) {
  extern __shared__ float smem[];
  float* hk_s = smem;              // (kRows, H): hprev * keep
  float* dh_s = smem + kRows * H;  // (kRows, H): dL/dh carried back in time
  float* g_s = smem + 2 * kRows * H; // (kRows, 3H): h @ Wh, then dgh
  const int H3 = 3 * H;
  const int row0 = blockIdx.x * kRows;
  const int nrows = min(kRows, B - row0);

  for (int i = threadIdx.x; i < kRows * H; i += blockDim.x) {
    dh_s[i] = 0.0f;
    hk_s[i] = 0.0f;
  }
  __syncthreads();
  for (int t = T - 1; t >= 0; --t) {
    const size_t base = (size_t)t * B;
    const float* hprev = t == 0 ? h0 : hs + (size_t)(t - 1) * B * H;
    // Phase 1: recompute the reset carry.
    for (int i = threadIdx.x; i < nrows * H; i += blockDim.x) {
      const int r = i / H, c = i % H;
      hk_s[i] = hprev[(size_t)(row0 + r) * H + c] * keep[(base + row0 + r) * H + c];
    }
    __syncthreads();
    tile_times_wh(hk_s, w_h, g_s, H);  // Phase 2: recompute h @ Wh
    __syncthreads();
    // Phase 3: gate cotangents; each thread owns slots c, H+c, 2H+c of its row.
    for (int i = threadIdx.x; i < nrows * H; i += blockDim.x) {
      const int r = i / H, c = i % H;
      const size_t row = base + row0 + r;
      const float* g = gates_i + row * H3;
      float* gh = g_s + r * H3;
      const float rg = sigmoid_f(g[c] + gh[c]);
      const float z = sigmoid_f(g[H + c] + gh[H + c]);
      const float hnb = gh[2 * H + c] + b_hn[c];
      const float n = tanhf(g[2 * H + c] + rg * hnb);
      const float d = g_hs[row * H + c] + dh_s[i];
      const float dn = d * (1.0f - z);
      const float dz = d * (hk_s[i] - n);
      const float dan = dn * (1.0f - n * n);
      const float dar = dan * hnb * rg * (1.0f - rg);
      const float daz = dz * z * (1.0f - z);
      dgates[row * H3 + c] = dar;
      dgates[row * H3 + H + c] = daz;
      dgates[row * H3 + 2 * H + c] = dan;
      dgh[row * H3 + c] = dar;
      dgh[row * H3 + H + c] = daz;
      dgh[row * H3 + 2 * H + c] = dan * rg;
      gh[c] = dar;
      gh[H + c] = daz;
      gh[2 * H + c] = dan * rg;
      dh_s[i] = d * z;
    }
    __syncthreads();
    // Phase 4: dh = (d*z + dgh @ Wh^T) * keep, through the reset into h_{t-1}.
    for (int k = threadIdx.x; k < H; k += blockDim.x) {
      float acc[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) acc[r] = 0.0f;
      // Unrolled by 8 to keep 8 independent L2 loads in flight. On an H100
      // (700 W) at T=128, B=16, H=128, unrolling this loop and tile_times_wh's
      // cut K2 from 6.2 to 4.3 ms but slowed K1 from 1.56 to 1.76 ms, so
      // tile_times_wh keeps the plain loop.
#pragma unroll 8
      for (int j = 0; j < H3; ++j) {
        const float w = __ldg(w_h_t + (size_t)j * H + k);
#pragma unroll
        for (int r = 0; r < kRows; ++r) acc[r] = fmaf(g_s[r * H3 + j], w, acc[r]);
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        if (r < nrows) {
          dh_s[r * H + k] = (dh_s[r * H + k] + acc[r]) * keep[(base + row0 + r) * H + k];
        }
      }
    }
    __syncthreads();
  }
  for (int i = threadIdx.x; i < nrows * H; i += blockDim.x) {
    dh0[(size_t)row0 * H + i] = dh_s[i];
  }
}

// K2b. Grid: (ceil(3H / kTile), ceil((H + 1) / kTile)). Row k == H of the
// extended product multiplies by ones and yields db_hn from dgh's n block.
__global__ void __launch_bounds__(kReduceThreads)
gru_bwd_reduce_kernel(const float* __restrict__ keep, const float* __restrict__ h0,
                      const float* __restrict__ hs, const float* __restrict__ dgh,
                      float* __restrict__ dwh, float* __restrict__ dbhn, int T, int B,
                      int H) {
  __shared__ float a_s[kChunk][kTile + 1];  // (hprev * keep)[n][k0 + cc]
  __shared__ float b_s[kChunk][kTile + 1];  // dgh[n][j0 + cc]
  constexpr int kPerThread = kTile * kTile / kReduceThreads;  // 4
  constexpr int kRowStep = kReduceThreads / kTile;            // 8
  const int H3 = 3 * H;
  const int N = T * B;
  const int j0 = blockIdx.x * kTile, k0 = blockIdx.y * kTile;
  const int tx = threadIdx.x % kTile, ty = threadIdx.x / kTile;

  float acc[kPerThread];
#pragma unroll
  for (int q = 0; q < kPerThread; ++q) acc[q] = 0.0f;

  for (int n0 = 0; n0 < N; n0 += kChunk) {
    for (int i = threadIdx.x; i < kChunk * kTile; i += kReduceThreads) {
      const int rr = i / kTile, cc = i % kTile;
      const int n = n0 + rr;
      float a = 0.0f, b = 0.0f;
      if (n < N) {
        const int k = k0 + cc, j = j0 + cc;
        if (k < H) {
          const int t = n / B, row = n % B;
          const float hp = t == 0 ? h0[(size_t)row * H + k]
                                  : hs[((size_t)(t - 1) * B + row) * H + k];
          a = hp * keep[(size_t)n * H + k];
        } else if (k == H) {
          a = 1.0f;
        }
        if (j < H3) b = dgh[(size_t)n * H3 + j];
      }
      a_s[rr][cc] = a;
      b_s[rr][cc] = b;
    }
    __syncthreads();
    for (int rr = 0; rr < kChunk; ++rr) {
      const float b = b_s[rr][tx];
#pragma unroll
      for (int q = 0; q < kPerThread; ++q) acc[q] = fmaf(a_s[rr][ty + q * kRowStep], b, acc[q]);
    }
    __syncthreads();
  }
  const int j = j0 + tx;
#pragma unroll
  for (int q = 0; q < kPerThread; ++q) {
    const int k = k0 + ty + q * kRowStep;
    if (j >= H3) continue;
    if (k < H) {
      dwh[(size_t)k * H3 + j] = acc[q];
    } else if (k == H && j >= 2 * H) {
      dbhn[j - 2 * H] = acc[q];
    }
  }
}

int block_threads(int H) {
  const int want = (3 * H + 31) / 32 * 32;
  return want < kMaxThreads ? want : kMaxThreads;
}

cudaError_t set_smem(const void* kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

}  // namespace

extern "C" {

// Each entry returns cudaGetLastError() after its launches (0 = success).

int gru_sequence_fwd(const float* gates_i, const float* keep, const float* h0,
                     const float* w_h, const float* b_hn, float* hs, int T, int B, int H,
                     void* stream) {
  const size_t smem = sizeof(float) * kRows * 4 * H;
  cudaError_t err = set_smem((const void*)gru_fwd_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((B + kRows - 1) / kRows);
  gru_fwd_kernel<<<grid, block_threads(H), smem, (cudaStream_t)stream>>>(
      gates_i, keep, h0, w_h, b_hn, hs, T, B, H);
  return (int)cudaGetLastError();
}

int gru_sequence_bwd(const float* gates_i, const float* keep, const float* h0,
                     const float* w_h, const float* w_h_t, const float* b_hn,
                     const float* hs, const float* g_hs, float* dgates, float* dgh,
                     float* dh0, float* dwh, float* dbhn, int T, int B, int H,
                     void* stream) {
  const size_t smem = sizeof(float) * kRows * 5 * H;
  cudaError_t err = set_smem((const void*)gru_bwd_recurrence_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid_a((B + kRows - 1) / kRows);
  gru_bwd_recurrence_kernel<<<grid_a, block_threads(H), smem, (cudaStream_t)stream>>>(
      gates_i, keep, h0, w_h, w_h_t, b_hn, hs, g_hs, dgates, dgh, dh0, T, B, H);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 grid_b((3 * H + kTile - 1) / kTile, (H + 1 + kTile - 1) / kTile);
  gru_bwd_reduce_kernel<<<grid_b, kReduceThreads, 0, (cudaStream_t)stream>>>(
      keep, h0, hs, dgh, dwh, dbhn, T, B, H);
  return (int)cudaGetLastError();
}

}  // extern "C"
