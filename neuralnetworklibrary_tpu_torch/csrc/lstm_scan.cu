// LSTM scan over time for Hopper (sm_90a), forward (K6) and backward (K7),
// bound to Python with ctypes.
//
// Replaces the TPU kernels of neuralnetworklibrary_tpu/ops/pallas_lstm.py:
// `_make_fwd_kernel` (forward scan with w_hh resident) and
// `_make_bwd_kernel` (per-step gate gradients with w_hh^T resident).  The
// numerics are the Pallas kernels': every step multiplies bf16(h) (or
// bf16(dgates)) by the bf16 weights with f32 accumulation (bf16 x bf16
// products are exact in f32, so an f32 FMA on bf16 values is the same
// product), the (h, c) carry stays f32, and ys, cs and the post-activation
// gates are stored in bf16.  The backward reads only those bf16 residuals.
//
// What bounds it.  Every step is a (B, H) x (H, 4H) product that depends on
// the step before, so the scan has a floor of T dependent steps; inside a
// step the work is 2*B*H*4H flops over a weight matrix that one SM cannot
// hold (4.6 MB at H 1150 in bf16; an SM has 227 KB).  At B 64, T 75,
// H 1150 the flops (50.8 G) bound a call at ~0.05 ms on the tensor cores,
// the bytes at ~0.04 ms; this first version multiplies in f32 on the CUDA
// cores, so the f32 rate (67 TFLOP/s, ~0.76 ms) and the per-step grid
// barrier bound it.
//
// Design.  A persistent cooperative grid (cudaLaunchCooperativeKernel):
// block j owns hidden units [j*u, (j+1)*u), u = ceil(H / SMs), and keeps
// its slice of the weights in shared memory for the whole sequence.  The
// TPU walked T on a sequential grid; here a loop over T inside every block
// takes its place, with a grid barrier between steps.
// - K6: the slice is the 4 gate columns of each own unit, (4u, H) bf16
//   (82.8 KB at H 1150).  Each step the block stages bf16(h_{t-1}) of all
//   units -- read back from ys[t-1], written by every block in the step
//   before, so no extra buffer -- for a chunk of batch rows, multiplies,
//   applies the cell to its own units and writes ys[t], cs[t], gates[t].
//   Its c carry stays in shared memory in f32.
// - K7: the slice is the rows of w_hh of the own units, (u, 4H) bf16.  Each
//   step (in reverse) the block forms dh for its units from bf16(dgates of
//   the step after), applies the cell's backward to its units and writes
//   dgates[t] (f32) and a bf16 copy into a two-slot scratch that the next
//   step reads after the grid barrier.
// - The block's product: warps take (row tile, column tile, k-split) work
//   items; lanes walk pairs of k (8-byte shared-memory loads, no bank
//   conflicts), reduce with shuffles, and the k-splits are summed in a fixed
//   order, so results do not change from run to run.
// - H need not be a multiple of anything: the last block owns fewer units
//   and the ragged edge is masked (the TPU's pad to 128 lanes is not kept).
//
// Later work: tensor cores (mma.sync / wgmma) for the step product, TMA
// staging of h, and keeping K7's dgates in bf16 only.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
// K6 tiles: 4 batch rows x the 4 gate columns of one unit
constexpr int kRB6 = 4, kCB6 = 4;
// K7 tiles: 8 batch rows x 2 units
constexpr int kRB7 = 8, kCB7 = 2;

typedef __nv_bfloat16 bf16;

__host__ __device__ inline int ceil_div(int a, int b) { return (a + b - 1) / b; }
__host__ __device__ inline int round_up(int a, int b) { return ceil_div(a, b) * b; }
__host__ __device__ inline size_t align16(size_t n) { return (n + 15) & ~size_t(15); }

__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16(x));
}
__device__ __forceinline__ float sigmoid(float x) {
  return 1.f / (1.f + expf(-x));
}
// a bf16 written by another block in this launch: read past the L1
__device__ __forceinline__ float load_cg(const bf16* p) {
  return __bfloat162float(__ushort_as_bfloat16(
      __ldcg(reinterpret_cast<const unsigned short*>(p))));
}

__device__ __forceinline__ float2 pair(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 pair(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// part[s][r][c] = sum over the k pairs of split s of A[r][k] * W[c][k], for
// A (rows, Kp) and W (cols, Kp) in shared memory; Kp even, rows % RB == 0,
// cols % CB == 0.  Each work item is one warp's; lanes walk pairs of k.
template <int RB, int CB, typename TA>
__device__ void block_matmul(const TA* A, const bf16* W, int rows, int cols,
                             int Kp, int S, float* part) {
  static_assert(RB * CB <= 32, "one lane writes each output of a tile");
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int ncg = cols / CB;
  const int items = (rows / RB) * ncg * S;
  const int kh = Kp / 2;
  for (int it = warp; it < items; it += kWarps) {
    const int s = it % S;
    const int tile = it / S;
    const int rg = tile / ncg;
    const int cgi = tile - rg * ncg;
    const int k0 = (int)((long long)kh * s / S);
    const int k1 = (int)((long long)kh * (s + 1) / S);
    float acc[RB][CB];
#pragma unroll
    for (int i = 0; i < RB; ++i)
#pragma unroll
      for (int j = 0; j < CB; ++j) acc[i][j] = 0.f;
    const TA* a = A + (size_t)rg * RB * Kp;
    const bf16* w = W + (size_t)cgi * CB * Kp;
    for (int kp = k0 + lane; kp < k1; kp += 32) {
      const int k = 2 * kp;
      float2 wv[CB];
#pragma unroll
      for (int j = 0; j < CB; ++j) wv[j] = pair(w + (size_t)j * Kp + k);
#pragma unroll
      for (int i = 0; i < RB; ++i) {
        const float2 av = pair(a + (size_t)i * Kp + k);
#pragma unroll
        for (int j = 0; j < CB; ++j)
          acc[i][j] = fmaf(av.y, wv[j].y, fmaf(av.x, wv[j].x, acc[i][j]));
      }
    }
#pragma unroll
    for (int i = 0; i < RB; ++i)
#pragma unroll
      for (int j = 0; j < CB; ++j)
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
          acc[i][j] += __shfl_xor_sync(0xffffffffu, acc[i][j], o);
#pragma unroll
    for (int i = 0; i < RB; ++i)
#pragma unroll
      for (int j = 0; j < CB; ++j)
        if (lane == i * CB + j)
          part[((size_t)s * rows + rg * RB + i) * cols + cgi * CB + j] =
              acc[i][j];
  }
}

// How a call is laid out over the card; the host computes it, the kernels
// read it from their arguments.
struct Plan {
  int u;       // hidden units per block
  int blocks;  // ceil(H / u)
  int bc;      // batch rows staged per chunk (multiple of the row tile)
  int splits;  // k-splits of the block product
  size_t smem; // dynamic shared memory bytes
};

// K6 shared memory: W (4u, Kp) bf16 | A (bc, Kp) f32 | part (S, bc, 4u) f32
// | c carry (B, u) f32
size_t fwd_smem(int B, int H, int u, int bc, int S) {
  const int Kp = round_up(H, 2), cols = 4 * u;
  return align16((size_t)cols * Kp * 2) + align16((size_t)bc * Kp * 4) +
         align16((size_t)S * bc * cols * 4) + align16((size_t)B * u * 4);
}

// K7 shared memory: W (up, 4H) bf16 | A (bc, 4H) bf16 | part (S, bc, up) f32
// | dh, dc carries (B, u) f32 each
size_t bwd_smem(int B, int H, int u, int bc, int S) {
  const int G = 4 * H, up = round_up(u, kCB7);
  return align16((size_t)up * G * 2) + align16((size_t)bc * G * 2) +
         align16((size_t)S * bc * up * 4) + 2 * align16((size_t)B * u * 4);
}

int splits_for(int bc, int rb, int ncols_tiles, int kp) {
  const int tiles = (bc / rb) * ncols_tiles;
  int s = kWarps / (tiles > 0 ? tiles : 1);
  const int most = kp / 2 / 32;  // keep at least a warp's width of pairs
  if (s > most) s = most;
  return s < 1 ? 1 : s;
}

// kind 0 = K6, 1 = K7.  Returns 0, or a cudaError_t when no plan fits.
int make_plan(int kind, int B, int H, Plan* p) {
  int dev = 0, nsm = 0, max_smem = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&nsm, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&max_smem,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (B < 1 || H < 1) return static_cast<int>(cudaErrorInvalidValue);
  p->u = ceil_div(H, nsm);
  p->blocks = ceil_div(H, p->u);
  const int rb = kind == 0 ? kRB6 : kRB7;
  const int col_tiles = kind == 0 ? p->u : round_up(p->u, kCB7) / kCB7;
  const int kp = kind == 0 ? round_up(H, 2) : 4 * H;
  // the largest chunk that fits, then evened out over the chunks it needs
  for (int bc = round_up(B, rb); bc >= rb; bc -= rb) {
    const int S = splits_for(bc, rb, col_tiles, kp);
    const size_t smem = kind == 0 ? fwd_smem(B, H, p->u, bc, S)
                                  : bwd_smem(B, H, p->u, bc, S);
    if (smem <= (size_t)max_smem) {
      const int chunks = ceil_div(B, bc);
      p->bc = round_up(ceil_div(B, chunks), rb);
      p->splits = splits_for(p->bc, rb, col_tiles, kp);
      p->smem = kind == 0 ? fwd_smem(B, H, p->u, p->bc, p->splits)
                          : bwd_smem(B, H, p->u, p->bc, p->splits);
      return 0;
    }
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// Loads a thread keeps in flight while staging: a step's staging reads data
// that other blocks wrote, from L2, so one load at a time would leave each
// thread waiting out the L2 latency once per element.
constexpr int kBatch = 8;
// cell inputs a thread prefetches before the step's product, for its first
// kPre cell items (x-projections in K6, residuals in K7)
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

__device__ __forceinline__ float2 unpack2(unsigned int v) {
  __nv_bfloat162 h;
  memcpy(&h, &v, sizeof(v));
  return __bfloat1622float2(h);
}

__global__ void __launch_bounds__(kThreads) lstm_fwd_kernel(
    const bf16* __restrict__ xp,   // (T, B, 4H)
    const bf16* __restrict__ w,    // (H, 4H)
    const float* __restrict__ h0,  // (B, H)
    const float* __restrict__ c0,  // (B, H)
    bf16* ys,                      // (T, B, H), read back across blocks
    bf16* __restrict__ cs,         // (T, B, H)
    bf16* __restrict__ gates,      // (T, B, 4H)
    float* __restrict__ hT,        // (B, H)
    float* __restrict__ cT,        // (B, H)
    int T, int B, int H, int u, int bc, int S) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::grid_group grid = cg::this_grid();
  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * u;
  const int nu = min(u, H - n0);
  const int G = 4 * H;
  const int Kp = round_up(H, 2);
  const int cols = 4 * u;
  bf16* W_s = reinterpret_cast<bf16*>(smem);
  float* A_s = reinterpret_cast<float*>(smem + align16((size_t)cols * Kp * 2));
  float* part = A_s + align16((size_t)bc * Kp * 4) / 4;
  float* c_s = part + align16((size_t)S * bc * cols * 4) / 4;

  // W_s[4*nl + g][k] = w[k][g*H + n0 + nl]; zero past H and past own units
  batched(
      cols * Kp,
      [&](int i) {
        const int k = i / cols;
        const int c = i - k * cols;
        const int nl = c >> 2, g = c & 3;
        return (nl < nu && k < H) ? w[(size_t)k * G + g * H + n0 + nl]
                                  : __float2bfloat16(0.f);
      },
      [&](int i, bf16 v) {
        const int k = i / cols;
        W_s[(size_t)(i - k * cols) * Kp + k] = v;
      });
  for (int i = tid; i < B * nu; i += kThreads) {
    const int b = i / nu, nl = i - (i / nu) * nu;
    c_s[b * u + nl] = c0[(size_t)b * H + n0 + nl];
  }
  __syncthreads();

  for (int t = 0; t < T; ++t) {
    for (int b0 = 0; b0 < B; b0 += bc) {
      const int nb = min(bc, B - b0);
      const int rows = round_up(nb, kRB6);
      const int items = nb * nu;
      const bool pre = items <= kPre * kThreads;
      // this thread's cell items' x-projections, in flight during the product
      float xr[kPre][4];
      if (pre) {
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
      }
      // stage bf16(h_{t-1}) of every unit for rows b0 .. b0 + nb
      if (t > 0 && H % 2 == 0) {
        // rows of ys[t-1] are contiguous and Kp == H: copy pairs flat
        const unsigned int* src = reinterpret_cast<const unsigned int*>(
            ys + ((size_t)(t - 1) * B + b0) * H);
        float2* dst = reinterpret_cast<float2*>(A_s);
        batched(
            nb * H / 2, [&](int i) { return __ldcg(src + i); },
            [&](int i, unsigned int v) { dst[i] = unpack2(v); });
        for (int i = nb * Kp + tid; i < rows * Kp; i += kThreads) A_s[i] = 0.f;
      } else {
        batched(
            rows * Kp,
            [&](int i) {
              const int r = i / Kp;
              const int k = i - r * Kp;
              if (r >= nb || k >= H) return 0.f;
              const size_t at = (size_t)(b0 + r) * H + k;
              return t == 0 ? round_bf16(h0[at])
                            : load_cg(ys + (size_t)(t - 1) * B * H + at);
            },
            [&](int i, float v) { A_s[i] = v; });
      }
      __syncthreads();
      block_matmul<kRB6, kCB6>(A_s, W_s, rows, cols, Kp, S, part);
      __syncthreads();
      auto cell = [&](int i, const float* x4) {
        const int r = i / nu;
        const int nl = i - r * nu;
        const int b = b0 + r;
        const int n = n0 + nl;
        const size_t row = (size_t)t * B + b;
        float pre_act[4];
#pragma unroll
        for (int g = 0; g < 4; ++g) {
          float acc = 0.f;
          for (int s = 0; s < S; ++s)
            acc += part[((size_t)s * rows + r) * cols + 4 * nl + g];
          pre_act[g] = x4[g] + acc;
        }
        const float ig = sigmoid(pre_act[0]);
        const float fg = sigmoid(pre_act[1]);
        const float gg = tanhf(pre_act[2]);
        const float og = sigmoid(pre_act[3]);
        const float c = fg * c_s[b * u + nl] + ig * gg;
        const float h = og * tanhf(c);
        c_s[b * u + nl] = c;
        ys[row * H + n] = __float2bfloat16(h);
        cs[row * H + n] = __float2bfloat16(c);
        bf16* gr = gates + row * G + n;
        gr[0] = __float2bfloat16(ig);
        gr[H] = __float2bfloat16(fg);
        gr[2 * H] = __float2bfloat16(gg);
        gr[3 * H] = __float2bfloat16(og);
        if (t == T - 1) {
          hT[(size_t)b * H + n] = h;
          cT[(size_t)b * H + n] = c;
        }
      };
      if (pre) {
#pragma unroll
        for (int q = 0; q < kPre; ++q)
          if (tid + q * kThreads < items) cell(tid + q * kThreads, xr[q]);
      } else {
        for (int i = tid; i < items; i += kThreads) {
          const int r = i / nu;
          const size_t at = ((size_t)t * B + b0 + r) * G + n0 + i - r * nu;
          float x4[4];
#pragma unroll
          for (int g = 0; g < 4; ++g) x4[g] = to_f32(xp[at + g * H]);
          cell(i, x4);
        }
      }
      __syncthreads();
    }
    grid.sync();  // ys[t] of every unit is visible to every block
  }
}

// dst[b][nl] (row stride ldd) = sum_k bf16(dgates)[b][k] * w[n0 + nl][k]
// for every batch row, from the bf16 scratch slot src (B, 4H)
__device__ void dh_from_dgates(const bf16* src, const bf16* W_s, bf16* A_s,
                               float* part, float* dst, int ldd, int B,
                               int H, int u, int nu, int bc, int S) {
  const int tid = threadIdx.x;
  const int G = 4 * H;
  const int up = round_up(u, kCB7);
  for (int b0 = 0; b0 < B; b0 += bc) {
    const int nb = min(bc, B - b0);
    const int rows = round_up(nb, kRB7);
    // stage rows b0 .. b0 + nb: 16 bytes per load where aligned, else 4
    // (G is even); zero the rows past nb
    const bf16* s = src + (size_t)b0 * G;
    if ((reinterpret_cast<uintptr_t>(s) & 15) == 0 && (nb * G) % 8 == 0) {
      const uint4* s4 = reinterpret_cast<const uint4*>(s);
      uint4* d4 = reinterpret_cast<uint4*>(A_s);
      batched(
          nb * G / 8, [&](int i) { return __ldcg(s4 + i); },
          [&](int i, uint4 v) { d4[i] = v; });
    } else {
      const unsigned int* s2 = reinterpret_cast<const unsigned int*>(s);
      unsigned int* d2 = reinterpret_cast<unsigned int*>(A_s);
      batched(
          nb * G / 2, [&](int i) { return __ldcg(s2 + i); },
          [&](int i, unsigned int v) { d2[i] = v; });
    }
    unsigned int* A2 = reinterpret_cast<unsigned int*>(A_s);
    for (int i = nb * G / 2 + tid; i < rows * G / 2; i += kThreads) A2[i] = 0u;
    __syncthreads();
    block_matmul<kRB7, kCB7>(A_s, W_s, rows, up, G, S, part);
    __syncthreads();
    for (int i = tid; i < nb * nu; i += kThreads) {
      const int r = i / nu;
      const int nl = i - r * nu;
      float acc = 0.f;
      for (int s = 0; s < S; ++s)
        acc += part[((size_t)s * rows + r) * up + nl];
      dst[(size_t)(b0 + r) * ldd + nl] = acc;
    }
    __syncthreads();
  }
}

__global__ void __launch_bounds__(kThreads) lstm_bwd_kernel(
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
    bf16* scratch,                   // (2, B, 4H): bf16(dgates), by step parity
    int T, int B, int H, int u, int bc, int S) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::grid_group grid = cg::this_grid();
  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * u;
  const int nu = min(u, H - n0);
  const int G = 4 * H;
  const int up = round_up(u, kCB7);
  bf16* W_s = reinterpret_cast<bf16*>(smem);
  bf16* A_s = reinterpret_cast<bf16*>(smem + align16((size_t)up * G * 2));
  float* part = reinterpret_cast<float*>(
      reinterpret_cast<unsigned char*>(A_s) + align16((size_t)bc * G * 2));
  float* dh_s = part + align16((size_t)S * bc * up * 4) / 4;
  float* dc_s = dh_s + align16((size_t)B * u * 4) / 4;

  // W_s[nl][k] = w[n0 + nl][k] = wT[k][n0 + nl]; zero rows past own units
  batched(
      up * G,
      [&](int i) {
        const int k = i / up;
        const int nl = i - k * up;
        return nl < nu ? wT[(size_t)k * H + n0 + nl] : __float2bfloat16(0.f);
      },
      [&](int i, bf16 v) {
        const int k = i / up;
        W_s[(size_t)(i - k * up) * G + k] = v;
      });
  for (int i = tid; i < B * nu; i += kThreads) {
    const int b = i / nu, nl = i - (i / nu) * nu;
    dh_s[b * u + nl] = dhT[(size_t)b * H + n0 + nl];
    dc_s[b * u + nl] = dcT[(size_t)b * H + n0 + nl];
  }
  __syncthreads();

  const size_t slot = (size_t)B * G;
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
  auto cell = [&](int t, int i, const float* v) {
    const int b = i / nu;
    const int nl = i - b * nu;
    const int n = n0 + nl;
    const float ig = v[0], fg = v[1], gg = v[2], og = v[3];
    const float tc = tanhf(v[4]);
    const float dh = v[6] + dh_s[b * u + nl];
    const float d_o = dh * tc;
    float dc = dc_s[b * u + nl] + dh * og * (1.f - tc * tc);
    const float di = dc * gg;
    const float dg = dc * ig;
    const float df = dc * v[5];
    const float d[4] = {di * ig * (1.f - ig), df * fg * (1.f - fg),
                        dg * (1.f - gg * gg), d_o * og * (1.f - og)};
    float* out = dgates + ((size_t)t * B + b) * G + n;
    bf16* out_bf = scratch + (t & 1) * slot + (size_t)b * G + n;
#pragma unroll
    for (int g = 0; g < 4; ++g) {
      out[g * H] = d[g];
      out_bf[g * H] = __float2bfloat16(d[g]);
    }
    dc *= fg;
    dc_s[b * u + nl] = dc;
    if (t == 0) dc0[(size_t)b * H + n] = dc;
  };

  for (int t = T - 1; t >= 0; --t) {
    float res[kPre][7];
    if (pre) {
#pragma unroll
      for (int q = 0; q < kPre; ++q)
        if (tid + q * kThreads < items) fetch(t, tid + q * kThreads, res[q]);
    }
    if (t < T - 1)  // dh carry = bf16(dgates[t + 1]) @ w^T, own units
      dh_from_dgates(scratch + ((t + 1) & 1) * slot, W_s, A_s, part, dh_s,
                     u, B, H, u, nu, bc, S);
    if (pre) {
#pragma unroll
      for (int q = 0; q < kPre; ++q)
        if (tid + q * kThreads < items) cell(t, tid + q * kThreads, res[q]);
    } else {
      for (int i = tid; i < items; i += kThreads) {
        float v[7];
        fetch(t, i, v);
        cell(t, i, v);
      }
    }
    grid.sync();  // bf16(dgates[t]) of every unit is visible to every block
  }
  // dh0 = bf16(dgates[0]) @ w^T
  dh_from_dgates(scratch, W_s, A_s, part, dh0 + n0, H, B, H, u, nu, bc, S);
}

template <typename Kernel>
int launch(Kernel kernel, const Plan& p, void** args, cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)p.smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  int dev = 0, nsm = 0, per_sm = 0;
  e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&nsm, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kThreads, p.smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  // a cooperative grid must be resident all at once
  if (per_sm * nsm < p.blocks)
    return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  e = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel),
                                  dim3(p.blocks), dim3(kThreads), args,
                                  p.smem, stream);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// K6.  Returns the cudaError_t of the launch (0 on success).
int nnl_lstm_fwd(const void* xp, const void* w, const void* h0,
                 const void* c0, void* ys, void* cs, void* gates, void* hT,
                 void* cT, int T, int B, int H, void* stream) {
  Plan p;
  const int err = make_plan(0, B, H, &p);
  if (err != 0) return err;
  if (T < 1) return static_cast<int>(cudaErrorInvalidValue);
  const bf16* a_xp = static_cast<const bf16*>(xp);
  const bf16* a_w = static_cast<const bf16*>(w);
  const float* a_h0 = static_cast<const float*>(h0);
  const float* a_c0 = static_cast<const float*>(c0);
  bf16* a_ys = static_cast<bf16*>(ys);
  bf16* a_cs = static_cast<bf16*>(cs);
  bf16* a_gates = static_cast<bf16*>(gates);
  float* a_hT = static_cast<float*>(hT);
  float* a_cT = static_cast<float*>(cT);
  void* args[] = {&a_xp, &a_w, &a_h0, &a_c0, &a_ys, &a_cs, &a_gates,
                  &a_hT, &a_cT, &T, &B, &H, &p.u, &p.bc, &p.splits};
  return launch(lstm_fwd_kernel, p, args, static_cast<cudaStream_t>(stream));
}

// K7.  scratch: (2, B, 4H) bf16.  Returns the cudaError_t of the launch.
int nnl_lstm_bwd(const void* wT, const void* gates, const void* cs,
                 const void* cprev, const void* dys, const void* dhT,
                 const void* dcT, void* dgates, void* dh0, void* dc0,
                 void* scratch, int T, int B, int H, void* stream) {
  Plan p;
  const int err = make_plan(1, B, H, &p);
  if (err != 0) return err;
  if (T < 1) return static_cast<int>(cudaErrorInvalidValue);
  const bf16* a_wT = static_cast<const bf16*>(wT);
  const bf16* a_gates = static_cast<const bf16*>(gates);
  const bf16* a_cs = static_cast<const bf16*>(cs);
  const bf16* a_cprev = static_cast<const bf16*>(cprev);
  const float* a_dys = static_cast<const float*>(dys);
  const float* a_dhT = static_cast<const float*>(dhT);
  const float* a_dcT = static_cast<const float*>(dcT);
  float* a_dgates = static_cast<float*>(dgates);
  float* a_dh0 = static_cast<float*>(dh0);
  float* a_dc0 = static_cast<float*>(dc0);
  bf16* a_scratch = static_cast<bf16*>(scratch);
  void* args[] = {&a_wT, &a_gates, &a_cs, &a_cprev, &a_dys, &a_dhT,
                  &a_dcT, &a_dgates, &a_dh0, &a_dc0, &a_scratch, &T, &B,
                  &H, &p.u, &p.bc, &p.splits};
  return launch(lstm_bwd_kernel, p, args, static_cast<cudaStream_t>(stream));
}

// The layout of a call: out = {u, blocks, bc, splits, smem bytes}.
// kind 0 = K6, 1 = K7.  Returns 0 or a cudaError_t.
int nnl_lstm_plan(int kind, int B, int H, int* out) {
  Plan p;
  const int err = make_plan(kind, B, H, &p);
  if (err != 0) return err;
  out[0] = p.u;
  out[1] = p.blocks;
  out[2] = p.bc;
  out[3] = p.splits;
  out[4] = static_cast<int>(p.smem);
  return 0;
}

const char* nnl_lstm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
