// LSTM scan over time for Hopper (sm_90a), forward (K6) and backward (K7),
// bound to Python with ctypes.
//
// Replaces the TPU kernels of neuralnetworklibrary_tpu/ops/pallas_lstm.py:
// `_make_fwd_kernel` (forward scan with w_hh resident) and
// `_make_bwd_kernel` (per-step gate gradients with w_hh^T resident).  The
// numerics are the Pallas kernels': every step multiplies bf16(h) (or
// bf16(dgates)) by the bf16 weights with f32 accumulation (here on the
// tensor cores, mma.sync m16n8k16), the (h, c) carry stays f32, and ys, cs
// and the post-activation gates are stored in bf16; dgates are stored in
// f32.  The backward reads only the bf16 residuals.
//
// What bounds it.  Every step is a (B, H) x (H, 4H) product that depends on
// the step before, so the scan is T dependent steps, each ended by a grid
// barrier; inside a step the work is 2*B*H*4H flops over a weight matrix
// that one SM cannot hold (4.6 MB at H 1150 in bf16; an SM has 227 KB).  At
// B 64, T 75, H 1150 the flops (50.8 G) bound a call at ~0.05 ms and the
// bytes at ~0.04 ms; what sets its pace is the chain of latencies in each
// step: the grid barrier (the barrier-only build takes ~2 us a step), the
// L2 round trip for the operand that every block needs (bf16 h, or bf16
// dgates) right after it, the product (shared-memory bound: ldmatrix feeds
// mma.sync), the exchange of partials inside the cluster and the cell.
// chip_smoke.py --tile-sweep times the cluster sizes, ablations and a
// trace build of these phases.
//
// Design.  A persistent grid of thread-block clusters of C blocks (C 1, 2,
// 4 or 8), all resident at once (the launch checks it with the occupancy
// calculator; a grid that does not fit fails with
// cudaErrorCooperativeLaunchTooLarge), with a grid barrier per step (an
// arrival counter, release/acquire, that each barrier leaves as it found
// it), split into arrive and wait so that the step's other stores run
// while it completes.  The layout (the plan) is computed on the host by
// ops/lstm_scan.py `make_plan` and passed in as the `Plan` fields below.
// - Cluster i owns C*u hidden units, block c of it the units
//   [(i*C + c)*u, +u) for the cell.  The step product of the cluster's
//   columns is split over the contraction index: block c keeps the
//   weights of all the cluster's columns over its c-th share of k in
//   shared memory for the whole sequence (K6: w[k-share, 4 gate columns of
//   each of the cluster's units]; K7: w[cluster's units, k-share of the 4H
//   gate columns]), so each block stages only 1/C of the broadcast operand.
// - The operand is bf16(h_{t-1}) (K6) or bf16(dgates_{t+1}) (K7), written
//   by every block in the step before into a two-slot scratch (2, B, ld),
//   ld a multiple of 8 so its rows are 16-byte aligned.  It streams
//   through a cp.async ring of 64-column tiles of up to 64 batch rows;
//   warps multiply each tile as it lands (mma.sync from ldmatrix
//   fragments), split over m-tiles, column tiles and, where the columns
//   are few, the 16-column k steps (k-groups).
// - Each block writes its f32 partials to shared memory by the block that
//   owns their columns, and sends each block its slice with one bulk copy
//   into that block's shared memory (cp.async.bulk shared::cluster,
//   completing on its mbarrier); each block then sums the partials of its
//   own units in a fixed order (block 0 first, then k-groups in order) and
//   applies the cell (or its backward).  No float atomics: two calls give
//   the same bits.
// - Batches over 64 rows run in chunks of up to 64 rows per step.  Ragged
//   H, k shares and batch rows are zero-filled (cp.async with no source
//   bytes, zero weights).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace nnl_hopper;

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kKTile = 64;              // k columns per ring tile
constexpr int kRingPitch = kKTile + 8;  // elements per ring row (odd x 16 B)
constexpr int kMaxRows = 64;            // batch rows per chunk
// 8-column tiles one warp holds (512 threads have 128 registers each)
constexpr int kMaxNTiles = 8;
// 0 ships.  Timing builds of chip_smoke.py --tile-sweep: 1 drops the
// multiply, 2 the staging, 3 everything but the grid barriers.
constexpr int kAblate = 0;
// a barrier that waits longer than this has lost a block: trap
constexpr unsigned long long kBarrierTimeoutNs = 10000000000ull;
// 0 ships.  The trace build of chip_smoke.py --tile-sweep sets 1: thread 0
// of block 0 stamps clock64 at each edge of a step's phases into g_trace,
// read back by nnl_lstm_trace.
constexpr int kTrace = 0;
constexpr int kTraceSlots = 4096;
// the edges, in this order (chip_smoke.py LSTM_TRACE_EDGES)
enum TraceEdge {
  edge_step,        // the grid barrier let the step start
  edge_tile,        // a ring tile landed (every thread's piece)
  edge_multiplied,  // this warp's mma over the share are issued
  edge_partials,    // this thread's partials are in shared memory
  edge_exchanged,   // the sums of the block's own columns are here
  edge_reduced,     // K7: dh of the block's units is summed
  edge_cell,        // the cells are computed, the operand written
  edge_arrived,     // the block arrived at the grid barrier
  edge_stored       // the other outputs are stored
};

// The layout of a call, in this order (ops/lstm_scan.py PLAN_FIELDS).
enum PlanField {
  plan_cluster,          // C, blocks per cluster
  plan_units_per_block,  // u
  plan_clusters,         // clusters in the grid
  plan_ld,               // row pitch of the operand scratch (elements)
  plan_k_share,          // k columns of one block (multiple of 16)
  plan_k_tiles,          // ring tiles of a share
  plan_k_pitch,          // row pitch of the resident weights (elements)
  plan_cols,             // product columns of a cluster (multiple of 8)
  plan_batch_chunk,      // batch rows per chunk (multiple of 16)
  plan_k_groups,         // warps splitting a tile's 16-column steps
  plan_n_split,          // warps splitting the column tiles
  plan_stages,           // ring depth
  plan_off_ring,         // shared memory offsets (bytes): the ring,
  plan_off_part,         // this block's partials by owner,
  plan_off_recv,         // the partials of its own columns by sender,
  plan_off_carry,        // the carry,
  plan_off_bar,          // the exchange's mbarrier
  plan_smem_bytes,       // dynamic shared memory
  plan_fields
};

struct Plan {
  int v[plan_fields];
};

typedef __nv_bfloat16 bf16;

__device__ long long g_trace[kTraceSlots];
__device__ int g_trace_n;

__device__ __forceinline__ void trace(TraceEdge edge) {
  if (kTrace && blockIdx.x == 0 && threadIdx.x == 0 &&
      g_trace_n < kTraceSlots)
    g_trace[g_trace_n++] = clock64() * 16 + edge;
}

__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float sigmoid(float x) {
  return 1.f / (1.f + expf(-x));
}

// Loads a thread keeps in flight while filling the weights.
constexpr int kBatch = 8;
// cell inputs a thread loads before they are needed, for its first kPre
// cell items: residuals in K7 before the step's product, x-projections in
// K6 during the barrier before the step (with one chunk; else before the
// chunk's product)
constexpr int kPre = 2;

// for i < n: v = load(i), then store(i, v), kBatch loads of a thread at a time
template <typename Load, typename Store>
__device__ __forceinline__ void batched(int n, Load load, Store store) {
  for (int i0 = threadIdx.x; i0 < n; i0 += kThreads * kBatch) {
    decltype(load(0)) v[kBatch];
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const int i = i0 + j * kThreads;
      if (i < n) v[j] = load(i);
    }
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const int i = i0 + j * kThreads;
      if (i < n) store(i, v[j]);
    }
  }
}

// A wait that has lasted this long has lost a block: trap rather than hang.
__device__ __forceinline__ void check_timeout(unsigned long long t0,
                                              int& polls) {
  if (++polls == 4096) {
    polls = 0;
    if (globaltimer_ns() - t0 > kBarrierTimeoutNs) __trap();
  }
}

// A grid barrier in two halves, so that work that nothing waits for runs
// between them: grid_arrive, then grid_wait(the arrive's result).  Writes
// before a block's arrive are visible to reads of any block after its wait.
// The blocks' arrivals add up to 2^31, so each barrier flips the counter's
// top bit and leaves its low bits as they were (zero from the first launch
// on).
__device__ unsigned int grid_arrive(unsigned int* counter) {
  __syncthreads();
  unsigned int old = 0;
  if (threadIdx.x == 0) {
    const unsigned int n = gridDim.x;
    const unsigned int add = blockIdx.x == 0 ? 0x80000000u - (n - 1) : 1u;
    __threadfence();
    old = atomicAdd(counter, add);
  }
  return old;
}

__device__ void grid_wait(unsigned int* counter, unsigned int old) {
  if (threadIdx.x == 0) {
    const unsigned long long t0 = globaltimer_ns();
    int polls = 0;
    while (((ld_acquire_gpu(counter) ^ old) & 0x80000000u) == 0)
      check_timeout(t0, polls);
    __threadfence();
  }
  __syncthreads();
}

// The block's partials of one chunk of the step product, written to
// part[owner][kg][r][oc] (f32, shared): for each block `owner` of the
// cluster, its ocols columns of the product, over this block's k share,
// k-group kg (the share's 16-column steps s with s % k_groups == kg).  A
// holds rows b0 .. b0 + nb of the bf16 operand src (row pitch ld) at
// columns kb + k; rows past nb, and columns past ld or the share, are
// zeros.  Product column j belongs to owner j / ocols; columns past
// C * ocols are padding and dropped.  Each active warp holds NN column
// tiles (the plan pads the columns to n_split * NN tiles).
template <int NN>
__device__ void step_product(const bf16* src, int b0, int nb, int kb,
                             int ocols, const Plan& p, unsigned char* smem) {
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int rows = p.v[plan_batch_chunk];
  const int ld = p.v[plan_ld];
  const int share = p.v[plan_k_share];
  const int nkt = p.v[plan_k_tiles];
  const int kpitch = p.v[plan_k_pitch];
  const int KG = p.v[plan_k_groups];
  const int NS = p.v[plan_n_split];
  const int S = p.v[plan_stages];
  bf16* ring = reinterpret_cast<bf16*>(smem + p.v[plan_off_ring]);
  const uint32_t slot_bytes = rows * kRingPitch * 2;

  // this thread's 16-byte piece of every tile: row lr, columns 8 * piece
  const int lr = tid >> 3, piece = tid & 7;
  const bool loader = lr < rows, row_ok = lr < nb;
  const bf16* g = src + (size_t)(b0 + (row_ok ? lr : 0)) * ld + kb + piece * 8;
  bf16* dst = ring + lr * kRingPitch + piece * 8;
  auto load_tile = [&](int kt) {
    if (kAblate == 2 || kAblate == 3 || !loader) return;
    const int k = kt * kKTile + piece * 8;
    const bool ok = row_ok && k < share && kb + k < ld;
    cp_async16(dst + (kt % S) * (slot_bytes / 2), ok ? g + kt * kKTile : src,
               ok ? 16 : 0);
  };

  // this warp's work: m-tile mi, k-group kg, column tiles ns, ns + NS, ...
  const int MT = rows >> 4;
  const bool active = warp < MT * KG * NS;
  const int mi = warp % MT;
  const int kg = (warp / MT) & (KG - 1);
  const int ns = warp / (MT * KG);
  const uint32_t a_off =
      smem_addr(ring) +
      ((mi * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * kRingPitch +
       (lane >> 4) * 8) * 2;
  const uint32_t b_base =
      smem_addr(smem) +
      ((ns * 8 + (lane & 7)) * kpitch + ((lane >> 3) & 1) * 8) * 2;
  const uint32_t b_step = NS * 8 * kpitch * 2;
  float acc[NN][4];
#pragma unroll
  for (int j = 0; j < NN; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  for (int i = 0; i < S - 1; ++i) {
    if (i < nkt) load_tile(i);
    cp_async_commit();
  }
  for (int kt = 0; kt < nkt; ++kt) {
    cp_async_wait(S - 2);  // tile kt has landed (this thread's piece)
    __syncthreads();       // ... everyone's, and tile kt - 1 is consumed
    trace(edge_tile);
    if (kt + S - 1 < nkt) load_tile(kt + S - 1);
    cp_async_commit();
    if (kAblate == 1 || kAblate == 3 || !active) continue;
    const uint32_t a_tile = a_off + (kt % S) * slot_bytes;
    const int steps = min(kKTile / 16, (share - kt * kKTile) >> 4);
    // the tile's 16-column steps of this warp's k-group (KG a power of 2)
    for (int q = (kg - kt * (kKTile / 16)) & (KG - 1); q < steps; q += KG) {
      uint32_t a[4];
      ldmatrix_x4(a, a_tile + q * 32);
      const uint32_t bk = b_base + (kt * kKTile + q * 16) * 2;
      uint32_t b[NN][2];
#pragma unroll
      for (int j = 0; j < NN; ++j) ldmatrix_x2(b[j], bk + j * b_step);
#pragma unroll
      for (int j = 0; j < NN; ++j) mma_bf16_16816(acc[j], a, b[j]);
    }
  }
  trace(edge_multiplied);
  if (!active) return;
  const int r0 = mi * 16 + (lane >> 2);
  const int valid = p.v[plan_cluster] * ocols;
  // owner = col / ocols, exact in f32: col + 0.5 is at least 0.5 from a
  // multiple of ocols, and col < 2^16
  const float inv = 1.f / ocols;
  float* part = reinterpret_cast<float*>(smem + p.v[plan_off_part]);
#pragma unroll
  for (int j = 0; j < NN; ++j) {
    const int c0 = (ns + j * NS) * 8 + 2 * (lane & 3);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int col = c0 + h;
      if (col < valid) {
        const int owner = __float2int_rz((col + 0.5f) * inv);
        float* o = part + ((owner * KG + kg) * rows + r0) * ocols + col -
                   owner * ocols;
        o[0] = acc[j][h];
        o[8 * ocols] = acc[j][2 + h];
      }
    }
  }
  trace(edge_partials);
}

// step_product<NN> for the plan's column tiles per warp, NN = cols / 8 /
// n_split (1 to kMaxNTiles).
template <int NN = 1>
__device__ void block_product(const bf16* src, int b0, int nb, int kb,
                              int ocols, const Plan& p,
                              unsigned char* smem) {
  if constexpr (NN < kMaxNTiles) {
    if (p.v[plan_cols] / 8 != NN * p.v[plan_n_split]) {
      block_product<NN + 1>(src, b0, nb, kb, ocols, p, smem);
      return;
    }
  }
  step_product<NN>(src, b0, nb, kb, ocols, p, smem);
}

// After step_product: every block of the cluster sends each block its
// slice of the partials (one bulk copy into that block's recv[rank]), and
// waits for the slices of its own columns.  `phase` is the parity of this
// block's mbarrier, flipped on each use.  Returns the partials to sum:
// sums()[((src * KG + kg) * rows + r) * ocols + oc].
__device__ const float* exchange(int ocols, int rank, uint32_t& phase,
                                 const Plan& p, unsigned char* smem) {
  const int C = p.v[plan_cluster];
  const float* part = reinterpret_cast<const float*>(smem + p.v[plan_off_part]);
  if (C == 1) {
    __syncthreads();
    return part;
  }
  const uint32_t slice = (uint32_t)p.v[plan_k_groups] *
                         p.v[plan_batch_chunk] * ocols * 4;
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + p.v[plan_off_bar]);
  fence_proxy_async();  // the partials' generic writes, before the copies
  __syncthreads();
  if (threadIdx.x == 0) {
    mbar_expect_tx(bar, C * slice);
    const uint32_t recv = smem_addr(smem + p.v[plan_off_recv]) + rank * slice;
    for (int c = 0; c < C; ++c)
      bulk_copy_cluster(map_cluster(recv, c),
                        reinterpret_cast<const unsigned char*>(part) +
                            c * slice,
                        slice, map_cluster(smem_addr(bar), c));
  }
  const unsigned long long t0 = globaltimer_ns();
  int polls = 0;
  while (!mbar_try_wait(bar, phase)) check_timeout(t0, polls);
  phase ^= 1u;
  return reinterpret_cast<const float*>(smem + p.v[plan_off_recv]);
}

// The sum over the blocks of the cluster (rank order) and the k-groups (in
// order) of the partials of row r, column oc.
__device__ __forceinline__ float partial_sum(const float* sums, int r, int oc,
                                             int ocols, const Plan& p) {
  const int n = p.v[plan_cluster] * p.v[plan_k_groups];
  const int rows = p.v[plan_batch_chunk];
  float acc = 0.f;
#pragma unroll 8
  for (int i = 0; i < n; ++i) acc += sums[((size_t)i * rows + r) * ocols + oc];
  return acc;
}

// The same for the four gate columns 4 nl .. 4 nl + 3 of K6.
__device__ __forceinline__ float4 partial_sum4(const float* sums, int r,
                                               int nl, int ocols,
                                               const Plan& p) {
  const int n = p.v[plan_cluster] * p.v[plan_k_groups];
  const int rows = p.v[plan_batch_chunk];
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 8
  for (int i = 0; i < n; ++i) {
    const float4 v = *reinterpret_cast<const float4*>(
        sums + ((size_t)i * rows + r) * ocols + 4 * nl);
    acc.x += v.x;
    acc.y += v.y;
    acc.z += v.z;
    acc.w += v.w;
  }
  return acc;
}

// Set up this block's mbarrier; every block of the cluster passes the
// cluster barrier after it, before any copy can target it.
__device__ void init_exchange(const Plan& p, unsigned char* smem) {
  if (threadIdx.x == 0) {
    mbar_init(reinterpret_cast<uint64_t*>(smem + p.v[plan_off_bar]), 1);
    fence_barrier_init();
  }
  cluster_sync();
}

__global__ void __launch_bounds__(kThreads, 1) lstm_fwd_tc_kernel(
    const bf16* __restrict__ xp,   // (T, B, 4H)
    const bf16* __restrict__ w,    // (H, 4H)
    const float* __restrict__ h0,  // (B, H)
    const float* __restrict__ c0,  // (B, H)
    bf16* __restrict__ ys,         // (T, B, H)
    bf16* __restrict__ cs,         // (T, B, H)
    bf16* __restrict__ gates,      // (T, B, 4H)
    float* __restrict__ hT,        // (B, H)
    float* __restrict__ cT,        // (B, H)
    bf16* scratch,                 // (2, B, ld): bf16(h), by step parity
    unsigned int* counter,         // grid barrier
    int T, int B, int H, Plan p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x;
  const int C = p.v[plan_cluster];
  const int u = p.v[plan_units_per_block];
  const int ld = p.v[plan_ld];
  const int share = p.v[plan_k_share];
  const int kpitch = p.v[plan_k_pitch];
  const int cols = p.v[plan_cols];
  const int bc = p.v[plan_batch_chunk];
  const int ocols = 4 * u;
  const int rank = (int)cluster_rank();
  const int cbase = (blockIdx.x - rank) * u;  // the cluster's first unit
  const int n0 = cbase + rank * u;            // this block's first unit
  const int nu = max(0, min(u, H - n0));
  const int kb = rank * share;
  const int G = 4 * H;
  bf16* W_s = reinterpret_cast<bf16*>(smem);
  float* c_s = reinterpret_cast<float*>(smem + p.v[plan_off_carry]);
  const size_t slot = (size_t)B * ld;
  uint32_t phase = 0;

  // W_s[4 jj + g][k] = w[kb + k][g H + cbase + jj]; zero past H, the
  // cluster's units and the share.  jj runs fastest: coalesced reads.
  const int cu = C * u;
  batched(
      kpitch * 4 * cu,
      [&](int i) {
        const int k = i / (4 * cu);
        const int r = i - k * 4 * cu;
        const int g = r / cu, jj = r - g * cu;
        return (k < share && kb + k < H && cbase + jj < H)
                   ? w[(size_t)(kb + k) * G + g * H + cbase + jj]
                   : __float2bfloat16(0.f);
      },
      [&](int i, bf16 v) {
        const int k = i / (4 * cu);
        const int r = i - k * 4 * cu;
        const int g = r / cu, jj = r - g * cu;
        W_s[(size_t)(4 * jj + g) * kpitch + k] = v;
      });
  for (int i = tid; i < (cols - 4 * cu) * kpitch; i += kThreads)
    W_s[(size_t)4 * cu * kpitch + i] = __float2bfloat16(0.f);
  // the carry, bf16(h0) into the slot step 0 reads, and zero pad columns
  for (int i = tid; i < B * nu; i += kThreads) {
    const int b = i / nu, nl = i - b * nu;
    c_s[b * u + nl] = c0[(size_t)b * H + n0 + nl];
    scratch[slot + (size_t)b * ld + n0 + nl] =
        __float2bfloat16(h0[(size_t)b * H + n0 + nl]);
  }
  if (blockIdx.x == 0)
    for (int i = tid; i < 2 * B * (ld - H); i += kThreads) {
      const int row = i / (ld - H);
      scratch[(size_t)row * ld + H + i - row * (ld - H)] =
          __float2bfloat16(0.f);
    }
  init_exchange(p, smem);
  unsigned int arrival = grid_arrive(counter);

  // a cell's outputs that only the caller reads, stored after the arrive
  struct Out {
    float h, c, g[4];
  };
  // this thread's cell items' x-projections, in flight during the product
  // (with one chunk, during the barrier before it)
  float xr[kPre][4];
  auto prefetch = [&](int t, int b0, int items) {
#pragma unroll
    for (int q = 0; q < kPre; ++q) {
      const int i = tid + q * kThreads;
      if (i < items) {
        const int r = i / nu;
        const size_t at = ((size_t)t * B + b0 + r) * G + n0 + i - r * nu;
#pragma unroll
        for (int g = 0; g < 4; ++g) xr[q][g] = to_f32(xp[at + g * H]);
      }
    }
  };
  const bool single = bc >= B;
  if (single && B * nu <= kPre * kThreads) prefetch(0, 0, B * nu);
  for (int t = 0; t < T; ++t) {
    const bf16* src = scratch + ((t + 1) & 1) * slot;  // bf16(h_{t-1})
    bf16* dst = scratch + (t & 1) * slot;
    grid_wait(counter, arrival);  // h_{t-1} of every unit is visible
    trace(edge_step);
    for (int b0 = 0; b0 < B; b0 += bc) {
      const int nb = min(bc, B - b0);
      const bool last = b0 + bc >= B;
      const int items = nb * nu;
      const bool pre = items <= kPre * kThreads;
      if (pre && !single) prefetch(t, b0, items);
      if (kAblate == 3) {
        if (last) arrival = grid_arrive(counter);
        continue;
      }
      block_product(src, b0, nb, kb, ocols, p, smem);
      const float* sums = exchange(ocols, rank, phase, p, smem);
      trace(edge_exchanged);
      // the cell of item i; bf16(h) goes to the scratch the next step reads
      auto cell = [&](int i, const float* x4) {
        const int r = i / nu;
        const int nl = i - r * nu;
        const int b = b0 + r;
        const float4 prod = partial_sum4(sums, r, nl, ocols, p);
        Out o;
        o.g[0] = sigmoid(x4[0] + prod.x);
        o.g[1] = sigmoid(x4[1] + prod.y);
        o.g[2] = tanhf(x4[2] + prod.z);
        o.g[3] = sigmoid(x4[3] + prod.w);
        o.c = o.g[1] * c_s[b * u + nl] + o.g[0] * o.g[2];
        o.h = o.g[3] * tanhf(o.c);
        c_s[b * u + nl] = o.c;
        dst[(size_t)b * ld + n0 + nl] = __float2bfloat16(o.h);
        return o;
      };
      auto store = [&](int i, const Out& o) {
        const int r = i / nu;
        const int b = b0 + r;
        const int n = n0 + i - r * nu;
        const size_t row = (size_t)t * B + b;
        ys[row * H + n] = __float2bfloat16(o.h);
        cs[row * H + n] = __float2bfloat16(o.c);
#pragma unroll
        for (int g = 0; g < 4; ++g)
          gates[row * G + g * H + n] = __float2bfloat16(o.g[g]);
        if (t == T - 1) {
          hT[(size_t)b * H + n] = o.h;
          cT[(size_t)b * H + n] = o.c;
        }
      };
      if (pre) {
        Out o[kPre];
#pragma unroll
        for (int q = 0; q < kPre; ++q)
          if (tid + q * kThreads < items) o[q] = cell(tid + q * kThreads, xr[q]);
        trace(edge_cell);
        // the sums are read: the next chunk may send.  After the last
        // chunk the grid barrier orders the next step's sends.
        if (last)
          arrival = grid_arrive(counter);
        else
          cluster_sync();
        trace(edge_arrived);
#pragma unroll
        for (int q = 0; q < kPre; ++q)
          if (tid + q * kThreads < items) store(tid + q * kThreads, o[q]);
        trace(edge_stored);
        if (single && t + 1 < T) prefetch(t + 1, 0, items);
      } else {
        for (int i = tid; i < items; i += kThreads) {
          const int r = i / nu;
          const size_t at = ((size_t)t * B + b0 + r) * G + n0 + i - r * nu;
          float x4[4];
#pragma unroll
          for (int g = 0; g < 4; ++g) x4[g] = to_f32(xp[at + g * H]);
          store(i, cell(i, x4));
        }
        if (last)
          arrival = grid_arrive(counter);
        else
          cluster_sync();
      }
    }
  }
}

// dst[b][nl] (row stride ldd) = sum_k bf16(dgates)[b][k] * w[n0 + nl][k]
// for every batch row and own unit, from the operand slot src (B, ld)
__device__ void dh_product(const bf16* src, float* dst, int ldd, int B,
                           int nu, int kb, int rank, uint32_t& phase,
                           const Plan& p, unsigned char* smem) {
  const int u = p.v[plan_units_per_block];
  const int bc = p.v[plan_batch_chunk];
  for (int b0 = 0; b0 < B; b0 += bc) {
    const int nb = min(bc, B - b0);
    if (kAblate != 3) {
      block_product(src, b0, nb, kb, u, p, smem);
      const float* sums = exchange(u, rank, phase, p, smem);
      trace(edge_exchanged);
      for (int i = threadIdx.x; i < nb * nu; i += kThreads) {
        const int r = i / nu;
        const int nl = i - r * nu;
        dst[(size_t)(b0 + r) * ldd + nl] = partial_sum(sums, r, nl, u, p);
      }
      trace(edge_reduced);
      // the sums are read: the next chunk may send.  After the last chunk
      // the grid barrier that follows orders the next step's sends.
      if (b0 + bc < B)
        cluster_sync();
      else
        __syncthreads();
    }
  }
}

__global__ void __launch_bounds__(kThreads, 1) lstm_bwd_tc_kernel(
    const bf16* __restrict__ wT,     // (4H, H)
    const bf16* __restrict__ gates,  // (T, B, 4H) post-activation
    const bf16* __restrict__ cs,     // (T, B, H)
    const bf16* __restrict__ cprev,  // (T, B, H): [c0, cs[:-1]]
    const float* __restrict__ dys,   // (T, B, H)
    const float* __restrict__ dhT,   // (B, H)
    const float* __restrict__ dcT,   // (B, H)
    float* __restrict__ dgates,      // (T, B, 4H)
    float* __restrict__ dh0,         // (B, H)
    float* __restrict__ dc0,         // (B, H)
    bf16* scratch,                   // (2, B, ld): bf16(dgates), by parity
    unsigned int* counter,           // grid barrier
    int T, int B, int H, Plan p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x;
  const int C = p.v[plan_cluster];
  const int u = p.v[plan_units_per_block];
  const int ld = p.v[plan_ld];
  const int share = p.v[plan_k_share];
  const int kpitch = p.v[plan_k_pitch];
  const int cols = p.v[plan_cols];
  const int rank = (int)cluster_rank();
  const int cbase = (blockIdx.x - rank) * u;
  const int n0 = cbase + rank * u;
  const int nu = max(0, min(u, H - n0));
  const int kb = rank * share;
  const int G = 4 * H;
  bf16* W_s = reinterpret_cast<bf16*>(smem);
  float* dh_s = reinterpret_cast<float*>(smem + p.v[plan_off_carry]);
  float* dc_s = dh_s + (size_t)B * u;
  const size_t slot = (size_t)B * ld;
  uint32_t phase = 0;

  // W_s[jj][k] = w[cbase + jj][kb + k] = wT[kb + k][cbase + jj]; zero past
  // H, the cluster's units and the share
  const int cu = C * u;
  batched(
      kpitch * cols,
      [&](int i) {
        const int k = i / cols;
        const int jj = i - k * cols;
        return (jj < cu && k < share && kb + k < G && cbase + jj < H)
                   ? wT[(size_t)(kb + k) * H + cbase + jj]
                   : __float2bfloat16(0.f);
      },
      [&](int i, bf16 v) {
        const int k = i / cols;
        W_s[(size_t)(i - k * cols) * kpitch + k] = v;
      });
  for (int i = tid; i < B * nu; i += kThreads) {
    const int b = i / nu, nl = i - b * nu;
    dh_s[b * u + nl] = dhT[(size_t)b * H + n0 + nl];
    dc_s[b * u + nl] = dcT[(size_t)b * H + n0 + nl];
  }
  if (blockIdx.x == 0)  // pad columns, first read after a grid barrier
    for (int i = tid; i < 2 * B * (ld - G); i += kThreads) {
      const int row = i / (ld - G);
      scratch[(size_t)row * ld + G + i - row * (ld - G)] =
          __float2bfloat16(0.f);
    }
  init_exchange(p, smem);

  const int items = B * nu;
  const bool pre = items <= kPre * kThreads;
  // a cell item's residuals: i, f, g, o, c_t, c_{t-1} and dys
  auto fetch = [&](int t, int i, float* v) {
    const int b = i / nu;
    const int n = n0 + i - b * nu;
    const size_t row = (size_t)t * B + b;
    const bf16* gr = gates + row * G + n;
#pragma unroll
    for (int g = 0; g < 4; ++g) v[g] = to_f32(gr[g * H]);
    v[4] = to_f32(cs[row * H + n]);
    v[5] = to_f32(cprev[row * H + n]);
    v[6] = dys[row * H + n];
  };
  // the cell's backward for item i: bf16(dgates) goes to the scratch the
  // step before reads; d (f32 dgates) and dc are stored after the arrive
  auto cell = [&](int t, int i, const float* v, float* d) {
    const int b = i / nu;
    const int nl = i - b * nu;
    const float ig = v[0], fg = v[1], gg = v[2], og = v[3];
    const float tc = tanhf(v[4]);
    const float dh = v[6] + dh_s[b * u + nl];
    const float d_o = dh * tc;
    float dc = dc_s[b * u + nl] + dh * og * (1.f - tc * tc);
    d[0] = dc * gg * ig * (1.f - ig);
    d[1] = dc * v[5] * fg * (1.f - fg);
    d[2] = dc * ig * (1.f - gg * gg);
    d[3] = d_o * og * (1.f - og);
    bf16* out_bf = scratch + (t & 1) * slot + (size_t)b * ld + n0 + nl;
#pragma unroll
    for (int g = 0; g < 4; ++g) out_bf[g * H] = __float2bfloat16(d[g]);
    dc *= fg;
    dc_s[b * u + nl] = dc;
    d[4] = dc;
  };
  auto store = [&](int t, int i, const float* d) {
    const int b = i / nu;
    const int n = n0 + i - b * nu;
    float* out = dgates + ((size_t)t * B + b) * G + n;
#pragma unroll
    for (int g = 0; g < 4; ++g) out[g * H] = d[g];
    if (t == 0) dc0[(size_t)b * H + n] = d[4];
  };

  unsigned int arrival = 0;
  for (int t = T - 1; t >= 0; --t) {
    float res[kPre][7];
    if (pre) {
#pragma unroll
      for (int q = 0; q < kPre; ++q)
        if (tid + q * kThreads < items) fetch(t, tid + q * kThreads, res[q]);
    }
    if (t < T - 1) {  // dh carry = bf16(dgates[t + 1]) @ w^T, own units
      grid_wait(counter, arrival);
      trace(edge_step);
      dh_product(scratch + ((t + 1) & 1) * slot, dh_s, u, B, nu, kb, rank,
                 phase, p, smem);
    }
    if (kAblate == 3) {
      arrival = grid_arrive(counter);
      continue;
    }
    if (pre) {
      float d[kPre][5];
#pragma unroll
      for (int q = 0; q < kPre; ++q)
        if (tid + q * kThreads < items) cell(t, tid + q * kThreads, res[q], d[q]);
      trace(edge_cell);
      arrival = grid_arrive(counter);
      trace(edge_arrived);
#pragma unroll
      for (int q = 0; q < kPre; ++q)
        if (tid + q * kThreads < items) store(t, tid + q * kThreads, d[q]);
      trace(edge_stored);
    } else {
      for (int i = tid; i < items; i += kThreads) {
        float v[7], d[5];
        fetch(t, i, v);
        cell(t, i, v, d);
        store(t, i, d);
      }
      arrival = grid_arrive(counter);
    }
  }
  // dh0 = bf16(dgates[0]) @ w^T
  grid_wait(counter, arrival);
  dh_product(scratch, dh0 + n0, H, B, nu, kb, rank, phase, p, smem);
}

// Whether the plan is one the kernels can run (the host computes it; this
// guards the kernels' own assumptions).
bool plan_ok(const Plan& p, int B, int H, int kdim) {
  const int C = p.v[plan_cluster];
  const int rows = p.v[plan_batch_chunk];
  const int nt = p.v[plan_cols] / 8;
  const int ns = p.v[plan_n_split];
  return (C == 1 || C == 2 || C == 4 || C == 8) &&
         p.v[plan_units_per_block] >= 1 && p.v[plan_clusters] >= 1 &&
         (long long)p.v[plan_clusters] * C * p.v[plan_units_per_block] >= H &&
         p.v[plan_ld] % 8 == 0 && p.v[plan_ld] >= kdim &&
         p.v[plan_k_share] % 16 == 0 &&
         (long long)p.v[plan_k_share] * C >= p.v[plan_ld] &&
         p.v[plan_k_tiles] * kKTile >= p.v[plan_k_share] &&
         p.v[plan_k_pitch] >= p.v[plan_k_tiles] * kKTile &&
         p.v[plan_k_pitch] % 8 == 0 && p.v[plan_cols] % 8 == 0 &&
         rows % 16 == 0 && rows >= 16 && rows <= kMaxRows &&
         p.v[plan_k_groups] >= 1 && ns >= 1 && ns <= nt &&
         (rows / 16) * p.v[plan_k_groups] * ns <= kWarps &&
         nt % ns == 0 && nt / ns <= kMaxNTiles && p.v[plan_stages] >= 2 &&
         p.v[plan_stages] <= 8 && p.v[plan_off_ring] % 128 == 0 &&
         p.v[plan_off_part] % 128 == 0 && p.v[plan_off_recv] % 128 == 0 &&
         p.v[plan_off_carry] % 16 == 0 && p.v[plan_off_bar] % 16 == 0 &&
         (p.v[plan_k_groups] & (p.v[plan_k_groups] - 1)) == 0 && B >= 1 &&
         H >= 1;
}

template <typename Kernel>
cudaLaunchConfig_t config(Kernel kernel, int clusters, int C, int smem,
                          cudaStream_t stream, cudaLaunchAttribute* attr,
                          cudaError_t* e) {
  *e = cudaFuncSetAttribute(kernel,
                            cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(clusters * C);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// Launches with the plan's grid of clusters, or returns
// cudaErrorCooperativeLaunchTooLarge when the card cannot hold them all
// at once (the grid barrier needs every block resident).
template <typename... Params, typename... Args>
int launch(void (*kernel)(Params...), const Plan& p, cudaStream_t stream,
           Args... args) {
  cudaLaunchAttribute attr[1];
  cudaError_t e;
  cudaLaunchConfig_t cfg =
      config(kernel, p.v[plan_clusters], p.v[plan_cluster],
             p.v[plan_smem_bytes], stream, attr, &e);
  if (e != cudaSuccess) return static_cast<int>(e);
  int most = 0;
  e = cudaOccupancyMaxActiveClusters(&most, kernel, &cfg);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (most < p.v[plan_clusters])
    return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  e = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

Plan read_plan(const void* plan) {
  Plan p;
  const int* v = static_cast<const int*>(plan);
  for (int i = 0; i < plan_fields; ++i) p.v[i] = v[i];
  return p;
}

}  // namespace

extern "C" {

// K6.  plan: int[plan_fields] on the host; scratch: (2, B, ld) bf16;
// counter: one uint32, zero before the first launch on its stream.
// Returns the cudaError_t of the launch (0 on success).
int nnl_lstm_fwd(const void* xp, const void* w, const void* h0,
                 const void* c0, void* ys, void* cs, void* gates, void* hT,
                 void* cT, void* scratch, void* counter, const void* plan,
                 int T, int B, int H, void* stream) {
  const Plan p = read_plan(plan);
  if (T < 1 || !plan_ok(p, B, H, H))
    return static_cast<int>(cudaErrorInvalidValue);
  return launch(lstm_fwd_tc_kernel, p, static_cast<cudaStream_t>(stream),
                static_cast<const bf16*>(xp), static_cast<const bf16*>(w),
                static_cast<const float*>(h0), static_cast<const float*>(c0),
                static_cast<bf16*>(ys), static_cast<bf16*>(cs),
                static_cast<bf16*>(gates), static_cast<float*>(hT),
                static_cast<float*>(cT), static_cast<bf16*>(scratch),
                static_cast<unsigned int*>(counter), T, B, H, p);
}

// K7.  As K6; scratch (2, B, ld) bf16 holds bf16(dgates) by step parity.
int nnl_lstm_bwd(const void* wT, const void* gates, const void* cs,
                 const void* cprev, const void* dys, const void* dhT,
                 const void* dcT, void* dgates, void* dh0, void* dc0,
                 void* scratch, void* counter, const void* plan, int T, int B,
                 int H, void* stream) {
  const Plan p = read_plan(plan);
  if (T < 1 || !plan_ok(p, B, H, 4 * H))
    return static_cast<int>(cudaErrorInvalidValue);
  return launch(lstm_bwd_tc_kernel, p, static_cast<cudaStream_t>(stream),
                static_cast<const bf16*>(wT), static_cast<const bf16*>(gates),
                static_cast<const bf16*>(cs), static_cast<const bf16*>(cprev),
                static_cast<const float*>(dys),
                static_cast<const float*>(dhT),
                static_cast<const float*>(dcT), static_cast<float*>(dgates),
                static_cast<float*>(dh0), static_cast<float*>(dc0),
                static_cast<bf16*>(scratch),
                static_cast<unsigned int*>(counter), T, B, H, p);
}

// How many clusters of `cluster` blocks, each with `smem` bytes of dynamic
// shared memory, the card holds at once (kind 0 = K6, 1 = K7) into *out.
// Returns 0 or a cudaError_t.
int nnl_lstm_max_clusters(int kind, int cluster, int smem, int* out) {
  cudaLaunchAttribute attr[1];
  cudaError_t e;
  if (kind == 0) {
    cudaLaunchConfig_t cfg =
        config(lstm_fwd_tc_kernel, 1, cluster, smem, 0, attr, &e);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveClusters(out, lstm_fwd_tc_kernel, &cfg);
  } else {
    cudaLaunchConfig_t cfg =
        config(lstm_bwd_tc_kernel, 1, cluster, smem, 0, attr, &e);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveClusters(out, lstm_bwd_tc_kernel, &cfg);
  }
  return static_cast<int>(e);
}

// The trace build's stamps since the last call (clock64 * 16 + edge, up to
// kTraceSlots) into out and their count into *n; none in the shipped
// build.  Returns 0 or a cudaError_t.
int nnl_lstm_trace(long long* out, int* n) {
  cudaError_t e = cudaMemcpyFromSymbol(n, g_trace_n, sizeof(int));
  if (e == cudaSuccess && *n > 0)
    e = cudaMemcpyFromSymbol(out, g_trace, *n * sizeof(long long));
  const int zero = 0;
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(g_trace_n, &zero, sizeof(int));
  return static_cast<int>(e);
}

const char* nnl_lstm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
