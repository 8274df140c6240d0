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
// Two hand-written routes, chosen by shape in `ops/gru.py` (`kernel_route`), bound
// by a plain C interface (ctypes) at the bottom of the file.
//
// What bounds the recurrence on an H100: at the batch sizes of the training
// path (B <= 32 rows, H = 128) neither bytes nor FLOPs. The T steps depend on
// each other, so a call costs T times the latency of one step, and the design's
// job is to make that step short.
//
// Resident route (H a multiple of 64, H <= 256): a cluster of 8 thread blocks
// owns 16 batch rows. Block c owns hidden units [c*H/8, (c+1)*H/8) and with them
// the r, z and n columns of Wh for those units. Its slice of Wh is loaded once,
// into registers, and stays for the whole sequence; the blocks exchange their
// pieces of the carry through distributed shared memory: bulk copies that count
// their bytes on the receiver's mbarrier, so that no fence and no cluster
// barrier sits on the chain. Further groups of 16 rows go to further clusters.
//
// K1 gru_fwd_resident_kernel replaces `_fwd_kernel`
//    (mava_tpu/ops/pallas_gru.py:69-85, launched by `_fwd_call` at :190). The TPU
//    grid (row_blocks, T) runs in order on one core and carries h in a VMEM
//    scratch. Here a thread owns one hidden unit and one sixteenth of the
//    product's depth: 3H/16 elements of Wh in registers. Per step it forms
//    partial sums for all 16 rows from the carry in shared memory, a fixed-order
//    butterfly over 16 lanes leaves lane s with the full sums of row s, the lane
//    applies the gates for (row s, its unit) and puts the new carry, already
//    multiplied by keep[t+1], into the block's piece of the other buffer, which
//    one bulk copy per peer carries to the other 7 blocks. gates_i and keep of
//    step t+1 are loaded into registers before step t's product.
//
// `_bwd_kernel` (:88-145, launched by `_gru_bwd` at :230) accumulates dWh and
//    db_hn in constant-index output blocks across its sequential grid and
//    recomputes the gates inside the reverse loop. Hopper blocks run in parallel
//    and in no order, and the recompute does not depend on the reverse carry, so
//    the work is split in three:
// K2p gru_bwd_gates_kernel recomputes r, z, n and hnb = (hk @ Wh)n + b_hn from
//    hprev = [h0, hs[:-1]] for all T*B rows at once into a (T,B,H,4) scratch: a
//    tiled fp32 product over all SMs with the gate math as its epilogue. By the
//    roofline it is bound by operations (2 * T*B * H * 3H FLOP). Its first
//    version (32x32 tiles, 7 shared-memory reads for 12 FMAs, nothing in flight
//    while it multiplied) took 7.6x that bound at T=128, B=16, H=128 on an H100.
//    Now a thread owns 4 rows x 2 units x 3 gates and reads 4 values for 24
//    FMAs, and the next slab of the depth is in registers while this one
//    multiplies: 4.3x the bound. What is left is the launch and a product that
//    shared-memory reads, not FMAs, still bound (see K2b).
// K2a gru_bwd_recurrence_resident_kernel walks time in reverse with the cluster
//    layout of K1. A thread owns one k of dh = dgh @ Wh^T and keeps Wh[k, own
//    columns] in registers: the same slice of Wh as in K1, so no transposed copy
//    exists. Each block forms the partial sum over its own columns for every k,
//    copies it into the shared memory of the block that owns unit k, and that
//    block adds the 8 partials in block order. Two block barriers and one
//    mbarrier wait per step. It writes dgates_i, dh0 and the recurrent-side
//    cotangent dgh = [dar, daz, dan*r] (T,B,3H) to a scratch buffer.
// K2b gru_bwd_reduce_kernel + gru_bwd_reduce_sum_kernel reduce
//    dWh = sum_{t,b} (hprev*keep)^T dgh and db_hn = sum dgh_n. By bytes and by
//    operations the work is 3 us at T=128, B=16, H=128 on an H100. What bounded
//    the first version (63x that) was latency: 60 blocks, each walking all T*B
//    rows alone with nothing in flight. Now the rows are split into S slices
//    (chosen by the wrapper, `reduce_split`, so that tiles x S is a few waves of
//    the card's SMs), a block owns one 64x64 tile of dWh for one slice, a thread
//    4x4 of it, the next 32 rows are in registers while these multiply, and
//    db_hn falls out of the dgh tiles that pass through shared memory anyway.
//    Each block writes its partial tile to a scratch (S, H*3H + H); the second
//    kernel adds the S partials in slice order. Together 4.3x the bound and
//    level with one cuBLAS product on a left operand formed beforehand. The
//    second kernel is a quarter of that; the first is bound by its reads of
//    shared memory (2 LDS.128 for 16 FMAs a row: with the FMAs taken out it
//    takes the same time, see PROBE), not by FMAs or global loads.
//    K2p and K2b share the loader of hprev*keep and the register-tile product.
// No atomics anywhere: every output is bitwise the same from run to run.
//
// The stacked forward (rec-IQL's fused double-DQN target pass, which the JAX
// package gets from `jax.vmap` of `gru_sequence` over two parameter stacks,
// mava_tpu/systems/q_learning/rec_iql.py:173-192) is K1 with the stack index as
// the grid's y dimension on both routes: entry s has its own gates_i, h0, Wh,
// b_hn and hs, offset by s, and shares keep. The weights differ per entry, so
// the stack cannot be folded into B. On the resident route a cluster stays 8
// blocks along x and each loads its own entry's slice of Wh into registers.
//
// Streaming route (every other H up to 1024, where a slice of Wh does not fit
// a block's registers): gru_fwd_kernel and gru_bwd_recurrence_kernel. One block
// owns 8 rows, loops over T with its carry in shared memory and reads Wh from
// L2 each step (the backward also a transposed copy made by the wrapper, and it
// recomputes the gates in the loop); K2b follows as above, for any H.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kRows = 8;         // streaming route: batch rows per block
constexpr int kMaxThreads = 512; // streaming route: threads per block
constexpr int kCluster = 8;      // resident route: blocks per cluster
constexpr int kClusterRows = 16; // resident route: batch rows per cluster
constexpr int kTileThreads = 256; // K2p, K2b: threads per block, as 16 x 16
constexpr int kReduceTile = 64;  // K2b: edge of a block's tile of dWh
constexpr int kReduceChunk = 32; // K2b: rows staged in shared memory per pass
constexpr int kGateRows = 64;    // K2p: rows of a block's tile
constexpr int kGateUnits = 32;   // K2p: hidden units of a block's tile (x 3 gates)
constexpr int kGateDepth = 32;   // K2p: depth of the product staged per pass

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

// K1, streaming route. Grid: ceil(B / kRows) x S blocks (y: the stack entry).
// Shared memory: kRows * 4H floats.
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
  const size_t entry = blockIdx.y;  // stack entry: its own inputs and weights, keep shared
  gates_i += entry * T * B * H3;
  h0 += entry * B * H;
  w_h += entry * H * H3;
  b_hn += entry * H;
  hs += entry * T * B * H;

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

// K2a, streaming route. Grid: ceil(B / kRows) blocks. Shared memory: kRows * 5H
// floats.
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

// ------------------------------------------------------------ resident route
// Built with -DGRU_STEP_CLOCKS, thread 0 of block 0 of K1 and K2a sums the SM
// clock cycles it spends in each phase of a step, and `gru_sequence_step_clocks`
// reads the sums back. The compiler moves instructions across the marks, so
// neighbouring phases blur; their sum is the step. Without the flag the marks
// are empty.
#ifdef GRU_STEP_CLOCKS
__device__ long long g_step_clocks[2][8];
#define STEP_CLOCKS_BEGIN                             \
  long long clocks_[8] = {0, 0, 0, 0, 0, 0, 0, 0};    \
  long long last_clock_ = clock64();
#define STEP_CLOCK(phase)                     \
  {                                           \
    const long long now_ = clock64();         \
    clocks_[phase] += now_ - last_clock_;     \
    last_clock_ = now_;                       \
  }
#define STEP_CLOCKS_END(kernel)                                      \
  if (threadIdx.x == 0 && blockIdx.x == 0 && blockIdx.y == 0) {     \
    for (int i_ = 0; i_ < 8; ++i_) g_step_clocks[kernel][i_] = clocks_[i_]; \
  }
#else
#define STEP_CLOCKS_BEGIN
#define STEP_CLOCK(phase)
#define STEP_CLOCKS_END(kernel)
#endif

// The blocks of a cluster hand each other data with bulk copies from their own
// shared memory into a peer's: one copy per peer and step, which on landing
// counts its bytes on an mbarrier in that peer's shared memory. The receiver
// arms the barrier with the bytes it expects and polls it. No fence at cluster
// scope and no cluster barrier sits on the chain.
__device__ __forceinline__ unsigned shared_address(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}
// Address, in the cluster's shared window, of `local` in the block of rank `rank`.
__device__ __forceinline__ unsigned peer_address(const void* local, unsigned rank) {
  unsigned remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(remote)
               : "r"(shared_address(local)), "r"(rank));
  return remote;
}
// Copy `bytes` (a multiple of 16) from this block's shared memory to `address`
// in a peer's, counting them on the peer's `barrier`. The source was written by
// ordinary stores: `publish_to_copies` + a block barrier come first.
__device__ __forceinline__ void copy_to_peer(unsigned address, const void* source,
                                             unsigned bytes, unsigned barrier) {
  asm volatile(
      "cp.async.bulk.shared::cluster.shared::cta.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      :
      : "r"(address), "r"(shared_address(source)), "r"(bytes), "r"(barrier)
      : "memory");
}
__device__ __forceinline__ void publish_to_copies() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}
// Thread 0 of each block sets up its barriers (one arrival each: its own
// `barrier_expect`) before the cluster-wide start barrier.
__device__ __forceinline__ void barrier_init(unsigned long long* bars, int n) {
  for (int i = 0; i < n; ++i) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
                 :
                 : "r"(shared_address(bars + i)), "r"(1)
                 : "memory");
  }
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}
__device__ __forceinline__ void barrier_expect(unsigned long long* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :
               : "r"(shared_address(bar)), "r"(bytes)
               : "memory");
}
// Wait for the completion of the barrier's phase of parity `parity`: the data
// sent under it is then visible. A wait that outlasts any real step (a peer
// that died) traps, so that the launch fails instead of hanging the card.
__device__ __forceinline__ void barrier_wait(unsigned long long* bar, unsigned parity) {
  const unsigned address = shared_address(bar);
  for (unsigned spins = 0;; ++spins) {
    unsigned done;
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}"
        : "=r"(done)
        : "r"(address), "r"(parity)
        : "memory");
    if (done) return;
    if (spins > (1u << 26)) __trap();
  }
}

// One stage of the butterfly over the 16 lanes that share a hidden unit. Before
// it acc[0 .. 2*HALF) holds partial sums of 2*HALF rows; a lane keeps the half
// its bit HALF selects, sends the other half to lane ^ HALF and adds what it
// gets. After the stages 8, 4, 2, 1 lane s holds in acc[0] the sum over all 16
// lanes for row s. The order of the additions is fixed.
template <int HALF>
__device__ __forceinline__ void butterfly_stage(float (&acc)[kClusterRows][3], int s) {
  const bool upper = (s & HALF) != 0;
#pragma unroll
  for (int i = 0; i < HALF; ++i) {
#pragma unroll
    for (int g = 0; g < 3; ++g) {
      const float send = upper ? acc[i][g] : acc[i + HALF][g];
      const float mine = upper ? acc[i + HALF][g] : acc[i][g];
      acc[i][g] = mine + __shfl_xor_sync(0xffffffffu, send, HALF);
    }
  }
}

// Shared memory of the resident kernels, in floats, for U = H / kCluster units a
// block. K1: the carry (2 buffers of 8 pieces), the step's inputs (2 buffers of
// 16 rows of [gr, gz, gn, next keep]) and its output rows (2 buffers). K2a: dgh
// for the product, the step's outputs, partials in and out (2 buffers each) and
// the step's inputs (2 buffers of 16 rows of [4 gates x U, g_hs, keep, hprev]).
// Rows are padded by 4 floats so that the 16 rows do not share a bank.
__host__ __device__ constexpr int fwd_piece_stride(int U) { return kClusterRows * U + 16; }
__host__ __device__ constexpr int fwd_in_stride(int U) { return 4 * U + 4; }
__host__ __device__ constexpr int fwd_out_stride(int U) { return U + 4; }
__host__ __device__ constexpr int fwd_resident_floats(int U) {
  return 2 * kCluster * fwd_piece_stride(U) + 2 * kClusterRows * fwd_in_stride(U) +
         2 * kClusterRows * fwd_out_stride(U);
}
__host__ __device__ constexpr int bwd_in_stride(int U) { return 7 * U + 4; }
__host__ __device__ constexpr int bwd_out_stride(int U) { return 4 * U + 4; }
__host__ __device__ constexpr int bwd_resident_floats(int U) {
  return 3 * U * kClusterRows + kClusterRows * bwd_out_stride(U) +
         4 * kCluster * U * kClusterRows + 2 * kClusterRows * bwd_in_stride(U);
}

// K1, resident route. Grid: kCluster * ceil(B / 16) x S blocks in clusters of
// kCluster along x (y: the stack entry); 16 * H / kCluster threads. Thread (s, ul) = (tid % 16, tid / 16)
// holds Wh[k, {r,z,n} of unit u] for the H/16 values k = 64 j + 4 s + i, and
// does the gate math of (row s, unit u). (Two units a thread, with half the
// threads, halve the product's reads of the carry from shared memory; at
// T=128, H=128 on an H100 that came out slightly slower and was not kept.) The
// carry buffers hold h * keep, i.e. the reset is applied by the thread that
// produces h', with its own keep[t+1].
// The carry is laid out by owner: piece c holds (16 rows, units of block c), so
// that a block's output is one contiguous piece, copied to each of its 7 peers.
// A peer can only be one step ahead, and what it writes then is the buffer this
// block reads two steps from now: it got there on this block's output, which
// is sent after every thread's last read (the block barrier before the copies).
// Global memory is touched only in runs of 64 bytes and more: each thread
// loads one float4 of step t+1's gates_i and keep into registers before step
// t's product and puts it into a shared tile after it, and hs[t] leaves through
// a staging tile. (With each thread loading and storing its own element, a warp
// touched 16 cache lines per instruction, and those instructions held up the
// product's shared-memory reads behind them; `cp.async` in place of the
// register hop stalled its warp at issue for far longer than a plain load.)
template <int H>
__global__ void __launch_bounds__(kClusterRows * (H / kCluster), 1)
gru_fwd_resident_kernel(const float* __restrict__ gates_i, const float* __restrict__ keep,
                        const float* __restrict__ h0, const float* __restrict__ w_h,
                        const float* __restrict__ b_hn, float* __restrict__ hs, int T, int B) {
  constexpr int U = H / kCluster;  // hidden units per block
  constexpr int KPT = H / 16;      // depth of the product per thread
  constexpr int PIECE = kClusterRows * U;  // floats in one block's piece of the carry
  constexpr int PSTRIDE = fwd_piece_stride(U);  // pieces 16 banks apart: the product's
                                                // float4 reads take two wavefronts
  constexpr int IN = fwd_in_stride(U), OUT = fwd_out_stride(U);
  constexpr int H3 = 3 * H;
  static_assert(H % 64 == 0 && U % 4 == 0, "resident route needs H % 64 == 0");
  extern __shared__ __align__(16) float smem[];
  float* h_s = smem;                                // [2][kCluster][PSTRIDE]
  float* in_s = h_s + 2 * kCluster * PSTRIDE;       // [2][16][IN]
  float* out_s = in_s + 2 * kClusterRows * IN;      // [2][16][OUT]
  __shared__ __align__(8) unsigned long long full[2];  // full[b]: carry buffer b has landed

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int row0 = (blockIdx.x / kCluster) * kClusterRows;
  const int nrows = min(kClusterRows, B - row0);
  const int s = threadIdx.x % 16;
  const int ul = threadIdx.x / 16;
  const int u = rank * U + ul;
  const bool valid = s < nrows;
  const size_t entry = blockIdx.y;  // stack entry: its own inputs and weights, keep shared
  gates_i += entry * T * B * H3;
  h0 += entry * B * H;
  w_h += entry * H * H3;
  b_hn += entry * H;
  hs += entry * T * B * H;

  float w[KPT][3];
#pragma unroll
  for (int j = 0; j < KPT / 4; ++j) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int k = 64 * j + 4 * s + i;
#pragma unroll
      for (int g = 0; g < 3; ++g) w[4 * j + i][g] = w_h[(size_t)k * H3 + g * H + u];
    }
  }
  const float bh = b_hn[u];
  // Where the product's float4 reads start in a carry buffer, for row 0.
  int h_at[KPT / 4];
#pragma unroll
  for (int j = 0; j < KPT / 4; ++j) {
    const int k = 64 * j + 4 * s;
    h_at[j] = (k / U) * PSTRIDE + k % U;
  }

  // One float4 of a step's inputs per thread: row p_r, segment p_seg of
  // [gr, gz, gn, keep of the step after], float4 number p_q of the block's
  // units. Rows past B, and the keep after the last step, read as zeros.
  const int p_r = threadIdx.x / U, p_seg = (threadIdx.x % U) / (U / 4);
  const int p_q = threadIdx.x % (U / 4);
  const float* p_from =
      p_seg < 3 ? gates_i + ((size_t)row0 + p_r) * H3 + p_seg * H + rank * U + 4 * p_q
                : keep + ((size_t)B + row0 + p_r) * H + rank * U + 4 * p_q;
  const size_t p_stride = (size_t)B * (p_seg < 3 ? H3 : H);
  const int p_steps = p_r < nrows ? (p_seg < 3 ? T : T - 1) : 0;
  float* p_to = in_s + p_r * IN + p_seg * U + 4 * p_q;
  auto fetch = [&](int step) {
    return step < p_steps ? __ldg(reinterpret_cast<const float4*>(p_from + step * p_stride))
                          : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  };
  auto stash = [&](int step, float4 v) {
    *reinterpret_cast<float4*>(p_to + (step & 1) * kClusterRows * IN) = v;
  };

  // Every block fills its own copy of the first carry, h0 * keep[0]. Rows past
  // B stay zero throughout (ragged last cluster).
  for (int i = threadIdx.x; i < kClusterRows * H; i += blockDim.x) {
    const int r = i / H, c = i % H;
    const size_t at = (size_t)(row0 + r) * H + c;
    h_s[(c / U) * PSTRIDE + r * U + c % U] = r < nrows ? h0[at] * keep[at] : 0.0f;
  }
  stash(0, fetch(0));
  if (threadIdx.x == 0) barrier_init(full, 2);
  // All blocks of the cluster have started, filled their carry and set up
  // their barriers.
  cluster.sync();

  STEP_CLOCKS_BEGIN
  for (int t = 0; t < T; ++t) {
    const int cur = t & 1;
    if (threadIdx.x == 0) {
      barrier_expect(&full[cur ^ 1], sizeof(float) * (kCluster - 1) * PIECE);
    }
    const float4 next_in = fetch(t + 1);  // off the chain

    const float* h_cur = h_s + cur * kCluster * PSTRIDE;
    float acc[kClusterRows][3];
#pragma unroll
    for (int r = 0; r < kClusterRows; ++r) {
      acc[r][0] = acc[r][1] = acc[r][2] = 0.0f;
#pragma unroll
      for (int j = 0; j < KPT / 4; ++j) {
        const float4 hv = *reinterpret_cast<const float4*>(h_cur + h_at[j] + r * U);
#pragma unroll
        for (int g = 0; g < 3; ++g) {
          acc[r][g] = fmaf(hv.x, w[4 * j + 0][g], acc[r][g]);
          acc[r][g] = fmaf(hv.y, w[4 * j + 1][g], acc[r][g]);
          acc[r][g] = fmaf(hv.z, w[4 * j + 2][g], acc[r][g]);
          acc[r][g] = fmaf(hv.w, w[4 * j + 3][g], acc[r][g]);
        }
      }
    }
    STEP_CLOCK(0)  // fetch + product
    butterfly_stage<8>(acc, s);
    butterfly_stage<4>(acc, s);
    butterfly_stage<2>(acc, s);
    butterfly_stage<1>(acc, s);
    STEP_CLOCK(1)  // butterfly

    const float* in = in_s + (cur * kClusterRows + s) * IN + ul;
    const float hk = h_cur[rank * PSTRIDE + s * U + ul];
    const float rg = sigmoid_f(in[0] + acc[0][0]);
    const float z = sigmoid_f(in[U] + acc[0][1]);
    const float n = tanhf(in[2 * U] + rg * (acc[0][2] + bh));
    const float h_new = (1.0f - z) * n + z * hk;
    STEP_CLOCK(2)  // gates
    float* piece = h_s + ((cur ^ 1) * kCluster + rank) * PSTRIDE;
    piece[s * U + ul] = valid ? h_new * in[3 * U] : 0.0f;
    float* out = out_s + cur * kClusterRows * OUT;
    out[s * OUT + ul] = h_new;
    stash(t + 1, next_in);
    STEP_CLOCK(3)  // stage
    publish_to_copies();
    __syncthreads();
    if (threadIdx.x < kCluster && threadIdx.x != rank) {
      copy_to_peer(peer_address(piece, threadIdx.x), piece, sizeof(float) * PIECE,
                   peer_address(&full[cur ^ 1], threadIdx.x));
    }
    if (threadIdx.x < 4 * U) {
      const int r = threadIdx.x / (U / 4), q = threadIdx.x % (U / 4);
      if (r < nrows) {
        *reinterpret_cast<float4*>(hs + ((size_t)t * B + row0 + r) * H + rank * U + 4 * q) =
            *reinterpret_cast<const float4*>(out + r * OUT + 4 * q);
      }
    }
    STEP_CLOCK(4)  // fence + block barrier + copies + hs store
    // The whole new carry has landed here. The buffer's barrier is used every
    // second step.
    barrier_wait(&full[cur ^ 1], (t >> 1) & 1);
    STEP_CLOCK(5)  // wait for the peers' pieces
  }
  STEP_CLOCKS_END(0)
  // No block leaves while a copy out of its shared memory may still be read:
  // every peer gets here only after its last wait, i.e. with all copies landed.
  cluster.sync();
}

// ------------------------------------------------- the tile product of K2p and K2b
// Both are fp32 products with hprev * keep on the left: K2p over the depth H
// (rows x units), K2b over the rows (units x columns of dgh). They share the
// loader of that operand and the product of a register tile.

// Four floats row[col .. col + 3], zeros from column `limit` on. `vec` says that
// rows start on 16 bytes and that limit and col are multiples of 4 (H % 4 == 0):
// one 16-byte load. Otherwise four guarded loads.
__device__ __forceinline__ float4 load4(const float* __restrict__ row, int col, int limit,
                                        bool vec) {
  if (vec) {
    return col < limit ? __ldg(reinterpret_cast<const float4*>(row + col))
                       : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
  float4 v;
  v.x = col < limit ? __ldg(row + col) : 0.0f;
  v.y = col + 1 < limit ? __ldg(row + col + 1) : 0.0f;
  v.z = col + 2 < limit ? __ldg(row + col + 2) : 0.0f;
  v.w = col + 3 < limit ? __ldg(row + col + 3) : 0.0f;
  return v;
}

__device__ __forceinline__ void store4(float* __restrict__ row, int col, int limit, bool vec,
                                       float4 v) {
  if (vec) {
    if (col < limit) *reinterpret_cast<float4*>(row + col) = v;
    return;
  }
  if (col < limit) row[col] = v.x;
  if (col + 1 < limit) row[col + 1] = v.y;
  if (col + 2 < limit) row[col + 2] = v.z;
  if (col + 3 < limit) row[col + 3] = v.w;
}

// Four neighbouring elements of hprev and of keep, as loaded: they are
// multiplied only where they go to shared memory, so that the loads stay in
// flight while the tile before them multiplies.
struct HkPiece {
  float4 h, keep;
};

// Row n = t * B + b of hprev = [h0, hs[:-1]] is h0[n] for the first B rows and
// hs[n - B] after them: one branch a row and no division. Rows from `n_end` on
// read as zeros.
__device__ __forceinline__ HkPiece fetch_hk(const float* __restrict__ hs,
                                            const float* __restrict__ h0,
                                            const float* __restrict__ keep, int n, int k,
                                            int n_end, int B, int H, bool vec) {
  HkPiece p;
  if (n < n_end) {
    const float* hprev = n < B ? h0 + (size_t)n * H : hs + (size_t)(n - B) * H;
    p.h = load4(hprev, k, H, vec);
    p.keep = load4(keep + (size_t)n * H, k, H, vec);
  } else {
    p.h = p.keep = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
  return p;
}

__device__ __forceinline__ float4 hk_value(const HkPiece& p) {
  return make_float4(p.h.x * p.keep.x, p.h.y * p.keep.y, p.h.z * p.keep.z, p.h.w * p.keep.w);
}

// acc[i][j] += a[i] * b[j]: M + N values from shared memory feed M * N FMAs.
template <int M, int N>
__device__ __forceinline__ void tile_fma(const float (&a)[M], const float (&b)[N],
                                         float (&acc)[M][N]) {
#pragma unroll
  for (int i = 0; i < M; ++i) {
#pragma unroll
    for (int j = 0; j < N; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

// K2p. Grid: (ceil(T*B / 64), ceil(H / 32)), 256 threads. Thread (tx, ty) =
// (tid % 16, tid / 16) owns rows n0 + 4 ty + {0..3} and units u0 + 2 tx + {0, 1}
// with the three gates' sums: 24 accumulators, and per step of the depth one
// float4 of the left operand and three float2 of Wh from shared memory. The
// depth goes by in slabs of 32, double-buffered: slab i + 1 is loaded into
// registers before slab i multiplies and goes to the other buffer after it, one
// block barrier a slab. The left operand arrives row-major (a float4 runs along
// the depth) and is needed depth-major (a float4 runs along the rows), so it is
// stored transposed; column n of depth row kk goes to n ^ (4 * (kk / 4 % 8)),
// which spreads a warp's 32 scalar stores over the 32 banks and leaves every
// float4 of four rows in one piece.
__global__ void __launch_bounds__(kTileThreads)
gru_bwd_gates_kernel(const float* __restrict__ gates_i, const float* __restrict__ keep,
                     const float* __restrict__ h0, const float* __restrict__ w_h,
                     const float* __restrict__ b_hn, const float* __restrict__ hs,
                     float* __restrict__ gates, int T, int B, int H) {
  __shared__ __align__(16) float a_s[2][kGateDepth][kGateRows];       // (hprev * keep)^T
  __shared__ __align__(16) float b_s[2][kGateDepth][3 * kGateUnits];  // Wh[k][gate][unit]
  static_assert(kGateRows * kGateDepth / 4 == 2 * kTileThreads, "two pieces of A a thread");
  static_assert(kGateDepth * kGateUnits / 4 == kTileThreads, "one piece of Wh a gate and thread");
  const int H3 = 3 * H;
  const int N = T * B;
  const bool vec = H % 4 == 0;
  const int n0 = blockIdx.x * kGateRows, u0 = blockIdx.y * kGateUnits;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  // Loader: piece (row a_row + 32 i, depth 4 a_q ..) of A, piece (depth b_kk,
  // gate g, units 4 a_q ..) of Wh. A warp loads 4 whole rows of 128 bytes.
  const int a_q = threadIdx.x % 8, a_row = threadIdx.x / 8;
  const int b_kk = a_row;

  HkPiece a_next[2];
  float4 b_next[3];
  auto fetch = [&](int kc) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      a_next[i] = fetch_hk(hs, h0, keep, n0 + a_row + 32 * i, kc + 4 * a_q, N, B, H, vec);
    }
    const int k = kc + b_kk;
#pragma unroll
    for (int g = 0; g < 3; ++g) {
      b_next[g] = k < H ? load4(w_h + (size_t)k * H3 + g * H, u0 + 4 * a_q, H, vec)
                        : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
  };
  auto stash = [&](int buf) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float4 v = hk_value(a_next[i]);
      const int col = (a_row + 32 * i) ^ (a_q << 2);
      a_s[buf][4 * a_q + 0][col] = v.x;
      a_s[buf][4 * a_q + 1][col] = v.y;
      a_s[buf][4 * a_q + 2][col] = v.z;
      a_s[buf][4 * a_q + 3][col] = v.w;
    }
#pragma unroll
    for (int g = 0; g < 3; ++g) {
      *reinterpret_cast<float4*>(&b_s[buf][b_kk][g * kGateUnits + 4 * a_q]) = b_next[g];
    }
  };

  float acc[4][6];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 6; ++j) acc[i][j] = 0.0f;
  }
  fetch(0);
  int buf = 0;
  for (int kc = 0; kc < H; kc += kGateDepth, buf ^= 1) {
    stash(buf);
    // Every thread is past its products on the other buffer, which the next
    // pass's stash rewrites, once it gets here.
    __syncthreads();
    if (kc + kGateDepth < H) fetch(kc + kGateDepth);
#pragma unroll
    for (int kk = 0; kk < kGateDepth; ++kk) {
      const float4 a4 =
          *reinterpret_cast<const float4*>(&a_s[buf][kk][(4 * ty) ^ (((kk >> 2) & 7) << 2)]);
      const float a[4] = {a4.x, a4.y, a4.z, a4.w};
      float b[6];
#pragma unroll
      for (int g = 0; g < 3; ++g) {
        const float2 b2 =
            *reinterpret_cast<const float2*>(&b_s[buf][kk][g * kGateUnits + 2 * tx]);
        b[2 * g] = b2.x;
        b[2 * g + 1] = b2.y;
      }
      tile_fma(a, b, acc);
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int n = n0 + 4 * ty + i;
    if (n >= N) continue;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int u = u0 + 2 * tx + j;
      if (u >= H) continue;
      const float* g = gates_i + (size_t)n * H3 + u;
      const float rg = sigmoid_f(g[0] + acc[i][j]);
      const float z = sigmoid_f(g[H] + acc[i][2 + j]);
      const float hnb = acc[i][4 + j] + b_hn[u];
      *reinterpret_cast<float4*>(gates + ((size_t)n * H + u) * 4) =
          make_float4(rg, z, tanhf(g[2 * H] + rg * hnb), hnb);
    }
  }
}

// K2b, first kernel. Grid: (ceil(3H / 64), ceil(H / 64), S), 256 threads. The
// block owns the tile (units k0 .., columns j0 ..) of dWh for the rows of slice
// blockIdx.z, [z * rows_per_slice, (z + 1) * rows_per_slice); thread (tx, ty) =
// (tid % 16, tid / 16) owns units k0 + 4 ty + {0..3} x columns j0 + 4 tx + {0..3}.
// Rows go by in chunks of 32, double-buffered as in K2p; both operands arrive
// row-major, which is how the product reads them, so a piece goes to shared
// memory as the float4 it came as. The blocks of the first tile row also add up
// the columns of dgh that belong to db_hn, from the values their threads of
// ty == 0 read for the product anyway. The partial tile goes to slice z of
// `partial` (S, H*3H + H): dWh row-major, then db_hn.
// PROBE is 0 in the kernel the port runs. The build with -DGRU_STEP_CLOCKS also
// has two variants that compute nothing of use and tell what bounds the kernel:
// 1 keeps every load and every shared-memory read and puts 8 adds in the place
// of a row's 16 FMAs; 2 keeps the product and loads only a slice's first chunk.
template <int PROBE>
__global__ void __launch_bounds__(kTileThreads)
gru_bwd_reduce_kernel(const float* __restrict__ keep, const float* __restrict__ h0,
                      const float* __restrict__ hs, const float* __restrict__ dgh,
                      float* __restrict__ partial, int T, int B, int H, int rows_per_slice) {
  __shared__ __align__(16) float a_s[2][kReduceChunk][kReduceTile];  // (hprev * keep)[n][k0 ..]
  __shared__ __align__(16) float b_s[2][kReduceChunk][kReduceTile];  // dgh[n][j0 ..]
  static_assert(kReduceChunk * kReduceTile / 4 == 2 * kTileThreads, "two pieces a thread");
  const int H3 = 3 * H;
  const int N = T * B;
  const bool vec = H % 4 == 0;
  const int j0 = blockIdx.x * kReduceTile, k0 = blockIdx.y * kReduceTile;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const long long first = (long long)blockIdx.z * rows_per_slice;
  const int n_begin = (int)(first < N ? first : N);
  const int n_end = (int)(first + rows_per_slice < N ? first + rows_per_slice : N);
  // Loader: pieces (row ty + 16 i, columns 4 tx ..) of both operands; half a
  // warp loads 256 contiguous bytes.
  HkPiece a_next[2];
  float4 b_next[2];
  auto fetch = [&](int nc) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int n = nc + ty + 16 * i;
      a_next[i] = fetch_hk(hs, h0, keep, n, k0 + 4 * tx, n_end, B, H, vec);
      b_next[i] = n < n_end ? load4(dgh + (size_t)n * H3, j0 + 4 * tx, H3, vec)
                            : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
  };
  auto stash = [&](int buf) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      *reinterpret_cast<float4*>(&a_s[buf][ty + 16 * i][4 * tx]) = hk_value(a_next[i]);
      *reinterpret_cast<float4*>(&b_s[buf][ty + 16 * i][4 * tx]) = b_next[i];
    }
  };

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.0f;
  float b_sum[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  const bool sums_b = blockIdx.y == 0 && ty == 0 && j0 + kReduceTile > 2 * H;
  if (n_begin < n_end) fetch(n_begin);
  int buf = 0;
  for (int nc = n_begin; nc < n_end; nc += kReduceChunk, buf ^= 1) {
    stash(buf);
    __syncthreads();  // as in K2p: one barrier a chunk
    if (PROBE != 2 && nc + kReduceChunk < n_end) fetch(nc + kReduceChunk);
    // db_hn is summed chunk by chunk and the chunks' sums are added up: a long
    // slice then loses fewer digits than one running sum over all its rows.
    float b_chunk[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll 8
    for (int r = 0; r < kReduceChunk; ++r) {
      const float4 a4 = *reinterpret_cast<const float4*>(&a_s[buf][r][4 * ty]);
      const float4 b4 = *reinterpret_cast<const float4*>(&b_s[buf][r][4 * tx]);
      const float a[4] = {a4.x, a4.y, a4.z, a4.w};
      const float b[4] = {b4.x, b4.y, b4.z, b4.w};
      if (PROBE == 1) {
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][i] += a[i] + b[i];
      } else {
        tile_fma(a, b, acc);
      }
      if (sums_b) {
#pragma unroll
        for (int j = 0; j < 4; ++j) b_chunk[j] += b[j];
      }
    }
    if (sums_b) {
#pragma unroll
      for (int j = 0; j < 4; ++j) b_sum[j] += b_chunk[j];
    }
  }
  float* out = partial + (size_t)blockIdx.z * ((size_t)H * H3 + H);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int k = k0 + 4 * ty + i;
    if (k < H) {
      store4(out + (size_t)k * H3, j0 + 4 * tx, H3, vec,
             make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]));
    }
  }
  if (sums_b) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = j0 + 4 * tx + j;
      if (col >= 2 * H && col < H3) out[(size_t)H * H3 + col - 2 * H] = b_sum[j];
    }
  }
}

// K2b, second kernel. One thread an element of [dWh, db_hn]: the S partials are
// added in slice order, so the sum does not depend on which block ran when.
__global__ void __launch_bounds__(kTileThreads)
gru_bwd_reduce_sum_kernel(const float* __restrict__ partial, float* __restrict__ dwh,
                          float* __restrict__ dbhn, int H, int S) {
  const int W = H * 3 * H;
  const int M = W + H;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= M) return;
  float sum = partial[i];
#pragma unroll 8
  for (int s = 1; s < S; ++s) sum += partial[(size_t)s * M + i];
  if (i < W) {
    dwh[i] = sum;
  } else {
    dbhn[i - W] = sum;
  }
}

// K2a, resident route. Grid as K1; H * RH threads. In the product thread
// (k, rh) = (tid % H, tid / H) owns dh[rows of half rh][k] and keeps
// Wh[k, own 3U columns] in registers. The product is bound by its reads of dgh
// from shared memory: each lane gets its own copy of a value the whole warp
// shares. (Two k a lane, with half the threads, halved those reads and came out
// no faster to speak of at T=128, H=128 on an H100: not kept.) In the
// elementwise phases thread slots (s, ul) = (slot % 16, slot / 16) own
// (row s, unit ul), SPT slots a thread.
// As in K1, global memory is touched in runs of 64 bytes and more: step t-1's
// gates, g_hs, keep and hprev come in as float4s, through registers, while step
// t computes, and dgates_i and dgh leave through a staging tile.
template <int H, int RH>
__global__ void __launch_bounds__(H * RH, 1)
gru_bwd_recurrence_resident_kernel(const float* __restrict__ gates,
                                   const float* __restrict__ keep,
                                   const float* __restrict__ h0,
                                   const float* __restrict__ w_h,
                                   const float* __restrict__ hs,
                                   const float* __restrict__ g_hs, float* __restrict__ dgates,
                                   float* __restrict__ dgh, float* __restrict__ dh0, int T,
                                   int B) {
  constexpr int U = H / kCluster;
  constexpr int C3 = 3 * U;                      // this block's columns of Wh
  constexpr int NT = H * RH;                     // threads
  constexpr int RPT = kClusterRows / RH;         // rows per thread in the product
  constexpr int SPT = kClusterRows * U / NT;     // (row, unit) slots per thread
  constexpr int H3 = 3 * H;
  constexpr int PIECE = U * kClusterRows;
  constexpr int IN = bwd_in_stride(U), OUT = bwd_out_stride(U);
  static_assert(kClusterRows * U % NT == 0 && RPT % 4 == 0 && U % 4 == 0, "thread layout");
  extern __shared__ __align__(16) float smem[];
  float* dgh_s = smem;                             // [C3][16]: own columns of dgh
  float* od_s = dgh_s + C3 * kClusterRows;         // [16][OUT]: dar, daz, dan, dan*r to store
  float* part_s = od_s + kClusterRows * OUT;       // [2][source block][U][16]: partials in
  float* out_s = part_s + 2 * kCluster * PIECE;    // [2][H][16]: partials out, piece c to block c
  float* in_s = out_s + 2 * kCluster * PIECE;      // [2][16][IN]: the step's inputs
  __shared__ __align__(8) unsigned long long full[2];  // full[b]: part_s[b] has landed

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int row0 = (blockIdx.x / kCluster) * kClusterRows;
  const int nrows = min(kClusterRows, B - row0);
  const int k = threadIdx.x % H;
  const int rh = threadIdx.x / H;

  float w[C3];
#pragma unroll
  for (int g = 0; g < 3; ++g) {
#pragma unroll
    for (int i = 0; i < U; ++i) w[g * U + i] = w_h[(size_t)k * H3 + g * H + rank * U + i];
  }

  // A step's inputs, a float4 a piece: per row [r,z,n,hnb of each unit | g_hs |
  // keep | hprev], all independent of the reverse carry. Piece c = tid + i NT
  // is float4 number c % CH of row c / CH. Rows past B read as zeros, which
  // makes every cotangent of theirs zero.
  constexpr int CH = 7 * U / 4;                               // pieces per row
  constexpr int CPT = (kClusterRows * CH + NT - 1) / NT;      // pieces per thread
  const float* p_from[CPT];  // the piece's place in its array at step 0
  size_t p_stride[CPT];      // and how far it moves per step
  int p_to[CPT];             // its place in a shared tile, -1 for no piece
  bool p_on[CPT], p_hprev[CPT];
#pragma unroll
  for (int i = 0; i < CPT; ++i) {
    const int c = threadIdx.x + i * NT;
    const int r = c / CH, o = 4 * (c % CH);
    const size_t row = (size_t)row0 + r;
    p_to[i] = c < kClusterRows * CH ? r * IN + o : -1;
    p_on[i] = c < kClusterRows * CH && r < nrows;
    p_hprev[i] = o >= 6 * U;
    p_stride[i] = (size_t)B * (o < 4 * U ? 4 * H : H);
    if (o < 4 * U) {
      p_from[i] = gates + row * 4 * H + rank * 4 * U + o;
    } else if (o < 5 * U) {
      p_from[i] = g_hs + row * H + rank * U + (o - 4 * U);
    } else if (o < 6 * U) {
      p_from[i] = keep + row * H + rank * U + (o - 5 * U);
    } else {
      p_from[i] = h0 + row * H + rank * U + (o - 6 * U);  // step 0; later hs[step - 1]
    }
  }
  auto fetch = [&](int step, float4 (&v)[CPT]) {
#pragma unroll
    for (int i = 0; i < CPT; ++i) {
      const float* from = p_from[i] + step * p_stride[i];
      if (p_hprev[i] && step > 0) from = hs + (from - h0) - p_stride[i];
      v[i] = p_on[i] && step >= 0 ? __ldg(reinterpret_cast<const float4*>(from))
                                  : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
  };
  auto stash = [&](int step, const float4 (&v)[CPT]) {
#pragma unroll
    for (int i = 0; i < CPT; ++i) {
      if (p_to[i] >= 0) {
        *reinterpret_cast<float4*>(in_s + (step & 1) * kClusterRows * IN + p_to[i]) = v[i];
      }
    }
  };

  float4 next_in[CPT];
  fetch(T - 1, next_in);
  stash(T - 1, next_in);
  float dh[SPT];
#pragma unroll
  for (int i = 0; i < SPT; ++i) dh[i] = 0.0f;
  if (threadIdx.x == 0) barrier_init(full, 2);
  // All blocks of the cluster have started and set up their barriers before
  // the first copy.
  cluster.sync();

  STEP_CLOCKS_BEGIN
  for (int t = T - 1; t >= 0; --t) {
    const int buf = t & 1;
    if (threadIdx.x == 0) {
      barrier_expect(&full[buf], sizeof(float) * kCluster * PIECE);
    }
    fetch(t - 1, next_in);  // off the chain
    STEP_CLOCK(0)  // fetch

    // Gate cotangents of this thread's slots.
    float dz_direct[SPT], keep_t[SPT];
#pragma unroll
    for (int i = 0; i < SPT; ++i) {
      const int slot = threadIdx.x + i * NT;
      const int s = slot % 16, ul = slot / 16;
      const float* in = in_s + (buf * kClusterRows + s) * IN;
      const float4 q = *reinterpret_cast<const float4*>(in + 4 * ul);
      const float rg = q.x, z = q.y, n = q.z, hnb = q.w;
      keep_t[i] = in[5 * U + ul];
      const float hk = in[6 * U + ul] * keep_t[i];
      const float d = in[4 * U + ul] + dh[i];
      const float dn = d * (1.0f - z);
      const float dz = d * (hk - n);
      const float dan = dn * (1.0f - n * n);
      const float dar = dan * hnb * rg * (1.0f - rg);
      const float daz = dz * z * (1.0f - z);
      const float dgn = dan * rg;
      float* mine = dgh_s + ul * kClusterRows + s;
      mine[0] = dar;
      mine[PIECE] = daz;
      mine[2 * PIECE] = dgn;
      float* od = od_s + s * OUT + ul;
      od[0] = dar;
      od[U] = daz;
      od[2 * U] = dan;
      od[3 * U] = dgn;
      dz_direct[i] = d * z;
    }
    STEP_CLOCK(1)  // gate cotangents
    __syncthreads();
    STEP_CLOCK(2)  // block barrier

    // dgates_i = [dar, daz, dan] and dgh = [dar, daz, dan*r] of this block's units.
    for (int c = threadIdx.x; c < kClusterRows * 6 * (U / 4); c += NT) {
      const int r = c / (6 * (U / 4)), a = (c % (6 * (U / 4))) / (U / 4), q = c % (U / 4);
      if (r >= nrows) continue;
      const int seg = a < 3 ? a : (a == 5 ? 3 : a - 3);
      float* to = (a < 3 ? dgates : dgh) + ((size_t)t * B + row0 + r) * H3 + (a % 3) * H +
                  rank * U + 4 * q;
      *reinterpret_cast<float4*>(to) =
          *reinterpret_cast<const float4*>(od_s + r * OUT + seg * U + 4 * q);
    }

    // Partial dgh @ Wh^T over this block's columns, for k and RPT rows.
    float acc[RPT];
#pragma unroll
    for (int r = 0; r < RPT; ++r) acc[r] = 0.0f;
    const float* dgh_rows = dgh_s + rh * RPT;
#pragma unroll
    for (int j = 0; j < C3; ++j) {
#pragma unroll
      for (int r4 = 0; r4 < RPT / 4; ++r4) {
        const float4 v =
            *reinterpret_cast<const float4*>(dgh_rows + j * kClusterRows + 4 * r4);
        acc[4 * r4 + 0] = fmaf(v.x, w[j], acc[4 * r4 + 0]);
        acc[4 * r4 + 1] = fmaf(v.y, w[j], acc[4 * r4 + 1]);
        acc[4 * r4 + 2] = fmaf(v.z, w[j], acc[4 * r4 + 2]);
        acc[4 * r4 + 3] = fmaf(v.w, w[j], acc[4 * r4 + 3]);
      }
    }
    STEP_CLOCK(3)  // stores + product
    float* out = out_s + buf * kCluster * PIECE;
#pragma unroll
    for (int r4 = 0; r4 < RPT / 4; ++r4) {
      *reinterpret_cast<float4*>(out + k * kClusterRows + rh * RPT + 4 * r4) =
          make_float4(acc[4 * r4], acc[4 * r4 + 1], acc[4 * r4 + 2], acc[4 * r4 + 3]);
    }
    stash(t - 1, next_in);
    publish_to_copies();
    // Also orders this step's reads of dgh_s, od_s and in_s before the next
    // step's writes to them.
    __syncthreads();
    float* part = part_s + buf * kCluster * PIECE;
    if (threadIdx.x < kCluster) {
      // The partials for the units of block `threadIdx.x`, into its slot for this block.
      copy_to_peer(peer_address(part + rank * PIECE, threadIdx.x), out + threadIdx.x * PIECE,
                   sizeof(float) * PIECE, peer_address(&full[buf], threadIdx.x));
    }
    STEP_CLOCK(4)  // stage + fence + block barrier + copies
    // All 8 partials for this block's units have landed. A peer can only be one
    // step ahead and writes the other buffer; it reaches this one again on this
    // block's next output, sent after the sums below are read.
    barrier_wait(&full[buf], ((T - 1 - t) >> 1) & 1);
    STEP_CLOCK(5)  // wait for the peers' partials

    // dh = (d*z + dgh @ Wh^T) * keep, through the reset into h_{t-1}; the
    // partials are added in block order.
#pragma unroll
    for (int i = 0; i < SPT; ++i) {
      const int slot = threadIdx.x + i * NT;
      const int s = slot % 16, ul = slot / 16;
      const float* mine = part + ul * kClusterRows + s;
      float sum = mine[0];
#pragma unroll
      for (int c = 1; c < kCluster; ++c) sum += mine[c * PIECE];
      dh[i] = (dz_direct[i] + sum) * keep_t[i];
    }
    STEP_CLOCK(6)  // sum of the partials
  }
#pragma unroll
  for (int i = 0; i < SPT; ++i) {
    const int slot = threadIdx.x + i * NT;
    const int s = slot % 16, ul = slot / 16;
    if (s < nrows) dh0[(size_t)(row0 + s) * H + rank * U + ul] = dh[i];
  }
  STEP_CLOCKS_END(1)
  // As in K1: all copies out of this block's shared memory have landed.
  cluster.sync();
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

// The launch of a resident kernel: kCluster * ceil(B / 16) x S blocks in
// clusters of kCluster along x. `attribute` must outlive `config`.
cudaLaunchConfig_t cluster_config(cudaLaunchAttribute* attribute, int B, int S, int threads,
                                  size_t smem, cudaStream_t stream) {
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(kCluster * ((B + kClusterRows - 1) / kClusterRows), S);
  config.blockDim = dim3(threads);
  config.dynamicSmemBytes = smem;
  config.stream = stream;
  attribute[0].id = cudaLaunchAttributeClusterDimension;
  attribute[0].val.clusterDim.x = kCluster;
  attribute[0].val.clusterDim.y = 1;
  attribute[0].val.clusterDim.z = 1;
  config.attrs = attribute;
  config.numAttrs = 1;
  return config;
}

// Launch `kernel` in clusters of kCluster blocks on `stream`. `checked` caches,
// per kernel, that the card can co-schedule one such cluster.
template <typename... Params, typename... Args>
cudaError_t launch_clusters(void (*kernel)(Params...), bool& checked, int B, int S, int threads,
                            size_t smem, cudaStream_t stream, Args... args) {
  cudaLaunchAttribute attribute[1];
  cudaLaunchConfig_t config = cluster_config(attribute, B, S, threads, smem, stream);
  if (!checked) {
    cudaError_t err = set_smem((const void*)kernel, smem);
    if (err != cudaSuccess) return err;
    int clusters = 0;
    err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &config);
    if (err != cudaSuccess) return err;
    if (clusters < 1) return cudaErrorLaunchOutOfResources;
    checked = true;
  }
  return cudaLaunchKernelEx(&config, kernel, args...);
}

constexpr int bwd_row_halves(int H) { return H <= 128 ? 2 : 1; }

// How many clusters of the resident K1 (kernel 0) or K2a (kernel 1) for H the
// card holds at once, for a launch over B rows and S stack entries.
template <int H>
cudaError_t resident_max_active_clusters(int kernel, int B, int S, int* clusters) {
  constexpr int U = H / kCluster, RH = bwd_row_halves(H);
  cudaLaunchAttribute attribute[1];
  const void* fn = kernel == 0 ? (const void*)gru_fwd_resident_kernel<H>
                               : (const void*)gru_bwd_recurrence_resident_kernel<H, RH>;
  const size_t smem = sizeof(float) * (kernel == 0 ? fwd_resident_floats(U) : bwd_resident_floats(U));
  cudaLaunchConfig_t config =
      cluster_config(attribute, B, S, kernel == 0 ? kClusterRows * U : H * RH, smem, 0);
  cudaError_t err = set_smem(fn, smem);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveClusters(clusters, fn, &config);
}

template <int H>
cudaError_t launch_fwd_resident(const float* gates_i, const float* keep, const float* h0,
                                const float* w_h, const float* b_hn, float* hs, int T, int B,
                                int S, cudaStream_t stream) {
  static bool checked = false;
  return launch_clusters(gru_fwd_resident_kernel<H>, checked, B, S,
                         kClusterRows * (H / kCluster),
                         sizeof(float) * fwd_resident_floats(H / kCluster), stream, gates_i,
                         keep, h0, w_h, b_hn, hs, T, B);
}

template <int H>
cudaError_t launch_bwd_resident(const float* gates, const float* keep, const float* h0,
                                const float* w_h, const float* hs, const float* g_hs,
                                float* dgates, float* dgh, float* dh0, int T, int B,
                                cudaStream_t stream) {
  static bool checked = false;
  constexpr int RH = bwd_row_halves(H);
  return launch_clusters(gru_bwd_recurrence_resident_kernel<H, RH>, checked, B, 1, H * RH,
                         sizeof(float) * bwd_resident_floats(H / kCluster), stream, gates, keep,
                         h0, w_h, hs, g_hs, dgates, dgh, dh0, T, B);
}

}  // namespace

extern "C" {

// Each entry returns the launch's error code (0 = success) and never
// synchronises. `cluster` is 0 for the streaming route and kCluster for the
// resident one; the caller chooses by shape.

// Shared memory and threads of the resident kernels for H, as
// {cluster, K1 threads, K1 bytes, K2a threads, K2a bytes}; returns 1 where the
// resident route does not take H.
int gru_sequence_resident_config(int H, int* out) {
  if (H < 64 || H > 256 || H % 64 != 0) return 1;
  const int U = H / kCluster, RH = bwd_row_halves(H);
  out[0] = kCluster;
  out[1] = kClusterRows * U;
  out[2] = (int)sizeof(float) * fwd_resident_floats(U) + 16;
  out[3] = H * RH;
  out[4] = (int)sizeof(float) * bwd_resident_floats(U) + 16;
  return 0;
}

// How many clusters of the resident K1 (kernel 0) or K2a (kernel 1) for H the
// card holds at once, for a launch over B rows and S stack entries, into
// `out`; returns the error, or cudaErrorInvalidValue where the resident route
// does not take H.
int gru_sequence_max_active_clusters(int H, int kernel, int B, int S, int* out) {
  if ((kernel != 0 && kernel != 1) || B < 1 || S < 1) return (int)cudaErrorInvalidValue;
  switch (H) {
    case 64: return (int)resident_max_active_clusters<64>(kernel, B, S, out);
    case 128: return (int)resident_max_active_clusters<128>(kernel, B, S, out);
    case 192: return (int)resident_max_active_clusters<192>(kernel, B, S, out);
    case 256: return (int)resident_max_active_clusters<256>(kernel, B, S, out);
    default: return (int)cudaErrorInvalidValue;
  }
}

// K1 over S stack entries (S = 1: the plain sequence): gates_i (S,T,B,3H),
// h0 (S,B,H), Wh (S,H,3H), b_hn (S,H) -> hs (S,T,B,H), keep (T,B,H) shared.
int gru_sequence_fwd(const float* gates_i, const float* keep, const float* h0,
                     const float* w_h, const float* b_hn, float* hs, int T, int B, int H,
                     int S, int cluster, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (S < 1 || S > 65535) return (int)cudaErrorInvalidValue;
  if (cluster == kCluster) {
    switch (H) {
      case 64: return (int)launch_fwd_resident<64>(gates_i, keep, h0, w_h, b_hn, hs, T, B, S, st);
      case 128:
        return (int)launch_fwd_resident<128>(gates_i, keep, h0, w_h, b_hn, hs, T, B, S, st);
      case 192:
        return (int)launch_fwd_resident<192>(gates_i, keep, h0, w_h, b_hn, hs, T, B, S, st);
      case 256:
        return (int)launch_fwd_resident<256>(gates_i, keep, h0, w_h, b_hn, hs, T, B, S, st);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  if (cluster != 0) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * kRows * 4 * H;
  cudaError_t err = set_smem((const void*)gru_fwd_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((B + kRows - 1) / kRows, S);
  gru_fwd_kernel<<<grid, block_threads(H), smem, st>>>(gates_i, keep, h0, w_h, b_hn, hs, T, B,
                                                       H);
  return (int)cudaGetLastError();
}

// K2p: gates (T,B,H,4) = r, z, n, hnb of each unit, recomputed from hprev = [h0, hs[:-1]].
int gru_sequence_bwd_gates(const float* gates_i, const float* keep, const float* h0,
                           const float* w_h, const float* b_hn, const float* hs, float* gates,
                           int T, int B, int H, void* stream) {
  const dim3 grid((T * B + kGateRows - 1) / kGateRows, (H + kGateUnits - 1) / kGateUnits);
  gru_bwd_gates_kernel<<<grid, kTileThreads, 0, (cudaStream_t)stream>>>(
      gates_i, keep, h0, w_h, b_hn, hs, gates, T, B, H);
  return (int)cudaGetLastError();
}

// K2a. The resident route reads `gates` (K2p's output); the streaming route
// reads gates_i, b_hn and the transposed copy w_h_t and recomputes in its loop.
int gru_sequence_bwd_recurrence(const float* gates_i, const float* keep, const float* h0,
                                const float* w_h, const float* w_h_t, const float* b_hn,
                                const float* hs, const float* g_hs, const float* gates,
                                float* dgates, float* dgh, float* dh0, int T, int B, int H,
                                int cluster, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (cluster == kCluster) {
    switch (H) {
      case 64:
        return (int)launch_bwd_resident<64>(gates, keep, h0, w_h, hs, g_hs, dgates, dgh, dh0, T,
                                            B, st);
      case 128:
        return (int)launch_bwd_resident<128>(gates, keep, h0, w_h, hs, g_hs, dgates, dgh, dh0,
                                             T, B, st);
      case 192:
        return (int)launch_bwd_resident<192>(gates, keep, h0, w_h, hs, g_hs, dgates, dgh, dh0,
                                             T, B, st);
      case 256:
        return (int)launch_bwd_resident<256>(gates, keep, h0, w_h, hs, g_hs, dgates, dgh, dh0,
                                             T, B, st);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  if (cluster != 0) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * kRows * 5 * H;
  cudaError_t err = set_smem((const void*)gru_bwd_recurrence_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((B + kRows - 1) / kRows);
  gru_bwd_recurrence_kernel<<<grid, block_threads(H), smem, st>>>(
      gates_i, keep, h0, w_h, w_h_t, b_hn, hs, g_hs, dgates, dgh, dh0, T, B, H);
  return (int)cudaGetLastError();
}

// K2b, first kernel: partial (slices, H*3H + H), slice s being the sums over rows
// [s * rows_per_slice, (s + 1) * rows_per_slice) of dWh, then of db_hn.
int gru_sequence_bwd_reduce(const float* keep, const float* h0, const float* hs,
                            const float* dgh, float* partial, int T, int B, int H, int slices,
                            int rows_per_slice, void* stream) {
  if (slices < 1 || slices > 65535 || rows_per_slice < 1 ||
      (long long)slices * rows_per_slice < (long long)T * B) {
    return (int)cudaErrorInvalidValue;
  }
  const dim3 grid((3 * H + kReduceTile - 1) / kReduceTile, (H + kReduceTile - 1) / kReduceTile,
                  slices);
  gru_bwd_reduce_kernel<0><<<grid, kTileThreads, 0, (cudaStream_t)stream>>>(
      keep, h0, hs, dgh, partial, T, B, H, rows_per_slice);
  return (int)cudaGetLastError();
}

// K2b, second kernel: dWh and db_hn as the sum of the partials in slice order.
int gru_sequence_bwd_reduce_sum(const float* partial, float* dwh, float* dbhn, int H, int slices,
                                void* stream) {
  if (slices < 1) return (int)cudaErrorInvalidValue;
  const int M = H * 3 * H + H;
  gru_bwd_reduce_sum_kernel<<<(M + kTileThreads - 1) / kTileThreads, kTileThreads, 0,
                              (cudaStream_t)stream>>>(partial, dwh, dbhn, H, slices);
  return (int)cudaGetLastError();
}

// The tile sizes that the wrapper's choice of slices rests on, as
// {K2b tile edge, K2b rows per pass}.
int gru_sequence_reduce_config(int* out) {
  out[0] = kReduceTile;
  out[1] = kReduceChunk;
  return 0;
}

#ifdef GRU_STEP_CLOCKS
// K2b's first kernel in its variant `probe` (1 or 2, see the kernel): the same
// grid and loads, a result of no use.
int gru_sequence_bwd_reduce_probe(const float* keep, const float* h0, const float* hs,
                                  const float* dgh, float* partial, int T, int B, int H,
                                  int slices, int rows_per_slice, int probe, void* stream) {
  if (slices < 1 || slices > 65535 || (probe != 1 && probe != 2)) return (int)cudaErrorInvalidValue;
  const dim3 grid((3 * H + kReduceTile - 1) / kReduceTile, (H + kReduceTile - 1) / kReduceTile,
                  slices);
  cudaStream_t st = (cudaStream_t)stream;
  if (probe == 1) {
    gru_bwd_reduce_kernel<1><<<grid, kTileThreads, 0, st>>>(keep, h0, hs, dgh, partial, T, B, H,
                                                            rows_per_slice);
  } else {
    gru_bwd_reduce_kernel<2><<<grid, kTileThreads, 0, st>>>(keep, h0, hs, dgh, partial, T, B, H,
                                                            rows_per_slice);
  }
  return (int)cudaGetLastError();
}

// Cycles per phase, summed over the steps of the last K1 ([0..8)) and K2a
// ([8..16)) launches. Synchronises.
int gru_sequence_step_clocks(long long* out) {
  return (int)cudaMemcpyFromSymbol(out, g_step_clocks, sizeof(long long) * 16);
}
#endif

}  // extern "C"
