// Flash attention, forward and backward, for Hopper (sm_90a), bound to
// Python with ctypes.
//
// Replaces the four TPU kernels of
// neuralnetworklibrary_tpu/ops/flash_attention.py (Pallas):
//   K1 <- _fwd_kernel (:119): o and the row logsumexp
//        bf16: flash_fwd_tc_kernel (tensor cores); float32: flash_fwd_kernel
//   K2 <- _bwd_dq_kernel (:275): dq by a loop over key tiles
//        bf16: flash_bwd_dq_tc_kernel; float32: flash_bwd_dq_kernel
//   K3 <- _bwd_dkv_kernel (:338): dk, dv by a loop over query tiles
//        bf16: flash_bwd_dkv_tc_kernel; float32: flash_bwd_dkv_kernel
//   K4 <- _bwd_dbias_kernel (:419): dbias = sum over the batch of dS
//        bf16: folded into flash_bwd_dkv_tc_kernel's pass (dS per batch
//        row into a scratch) and flash_dbias_reduce_kernel (the sum over
//        the batch); float32: flash_bwd_dbias_kernel
// The (T, T) score matrix is never written: each block holds a tile of its
// own side and streams tiles of the other side through shared memory,
// with the online softmax (m, l) in the forward and p = exp(s - lse)
// recomputed from the saved logsumexp in the backward.  delta = rowsum(dO
// * O) is computed outside, as the JAX package does.
//
// Options, as in the Pallas kernels: causal or bidirectional (causal = 0:
// every key tile of every row); a causal window; a batch-shared float32
// logit bias (H, T, T) added to the scaled score (T5's relative
// positions); a key mask entered ADDITIVELY as a (B, T) float32 row of
// 0 / -1e30, so a row whose keys are all masked attends uniformly over the
// keys its position sees, as the JAX package's rule is; in-kernel dropout;
// packed rows, as a (B, T) int32 document start per query (q_start, causal
// only): query qp sees key kp only if kp >= its start, one more compare in
// the position test (the bf16 kernels test it on EDGE tiles only); K1/K2
// (bf16) skip the key tiles that lie wholly before the smallest start of a
// block's rows; a per-head float32 sink logit (K1 only) that joins each
// row's softmax normalizer at the end: m' = max(m, sink), l' = l e^(m - m') + e^(sink - m'), lse = m' + log l',
// so the backward's p = exp(s - lse) needs no change.
//
// Layout: q, k, v, o, do, dq, dk, dv are (B, T, H, hd) row-major, so a row
// of one head is hd contiguous elements and rows are H*hd apart; lse and
// delta are (B*H, T) float32; bias and dbias (H, T, T) float32; the key
// mask (B, T) float32.  The flat index bh = b*H + h is the JAX kernels'
// program_id(0), and the dropout hash takes it as its batch index.
//
// What bounds them: at the GPT-2 training shape (B 8, H 12, T 1024, hd 64,
// causal) K1 does 12.9 GFLOP against 50 MB (0.013 ms of bf16 tensor-core
// work, 0.015 ms of HBM), K2 19.3 GFLOP against 64 MB (0.020 / 0.019 ms),
// K3 25.8 GFLOP: far above the card's ~300 flops per byte, so the tensor
// cores bound them.  At the T5 encoder's (B 16, T 512, bidirectional, key
// mask, f32 bias) the bias read makes K1-K4 byte-bound (0.019-0.027 ms).
// K4 does 4*hd flops per pair per batch row against the (H, T, T) bias
// read and dbias write.
//
// Two designs:
// - K1, K2, K3 (with K4) on bf16 (the training paths' type): tensor cores
//   (wgmma) fed by TMA through an mbarrier ring, warp-specialised, below
//   ("K1, K2 on tensor cores" and "K3 on tensor cores").
// - K1-K4 on float32: the first, simple design,
//   float32 on the CUDA cores, so shared-memory loads bound it.  One block
//   of 256 threads per (tile of 64 rows, bh); thread (ty, tx) of a 16 x 16
//   grid owns rows ty*4 .. ty*4+3 and columns tx, tx+16, ..., so every
//   tile product is the same register-blocked loop (mma_tile); tiles sit
//   in shared memory as float32 [row][d] with a row stride of hd+1 (and 65
//   for the 64 x 64 probability tiles), 1 mod 32, so the products' reads
//   are free of bank conflicts.  K4 runs one block per (key tile, query
//   tile, head) and loops over the batch inside the block, summing one
//   64 x 64 float32 tile in registers and writing it once: no atomics and
//   no zeroing pass; a tile the causal band skips is written as 0.
// Common to both:
// - causal tiles above the diagonal are skipped by the loop bounds, and a
//   window starts (K1, K2) or ends (K3) the loop at its band, as first_j
//   and n_q do in the Pallas kernels; rows at or past T are masked, so T
//   needs no padding;
// - a row whose every key is masked saves lse = -1e30 (m + log l rounds to
//   m in float32), so the backward cannot take p = exp(s - lse) there: it
//   gives such a row its forward's uniform p = 1/n over its n attended
//   keys, and dS = 0 on masked keys, which is what the gradient of the
//   plain version (masked scores replaced, not offset) is;
// - dropout regenerates the keep mask from the same murmur3 hash as the
//   Pallas `_drop_keep`, in uint32 arithmetic (the TPU's int32 wraps the
//   same way, and its shift_right_logical is a logical shift).  The forward
//   normalizer l sums the undropped probabilities; only the value
//   accumulation sees the mask, scaled by 1/(1 - rate).
//
// Later work: a persistent grid; fp8; native GQA (read the Hkv heads
// through the tensor maps); head dims other than 64 and 128; in K3, the
// query tiles of other documents skipped (it visits the whole causal
// range: a consumer-side skip measured 17% faster at the Qwen3 shape but
// spilled at hd 128) and a q_start-only instantiation (packed rows run the
// options' path).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>
#include <string.h>

#include "hopper.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 64;               // rows of every tile
constexpr int kPs = kTile + 1;          // row stride of a 64 x 64 tile
constexpr float kNegInf = -1e30f;
constexpr size_t kMaxSmem = 232448;     // 227 KB, the most a block may use

__device__ __forceinline__ float to_f32(float x) { return x; }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}

// The dropout hash of _drop_keep (flash_attention.py:84) in two parts: the
// part of one (seed, bh, query position) row, then the keep decision for
// key position k, u >= rate for u = (x & 0xFFFFFF) / 2**24, taken as the
// exact integer test (x & 0xFFFFFF) >= ceil(rate * 2**24) (drop_thresh).
__device__ __forceinline__ uint32_t drop_row(uint32_t seed, uint32_t bh,
                                             uint32_t q) {
  return (q * 2654435769u) ^ (bh * 97531u) ^ seed;
}
__device__ __forceinline__ uint32_t drop_thresh(float rate) {
  return static_cast<uint32_t>(ceilf(rate * 16777216.0f));
}
__device__ __forceinline__ bool drop_keep_at(uint32_t row, uint32_t k,
                                             uint32_t thresh) {
  uint32_t x = row ^ (k * 40503u);
  x ^= x >> 16;
  x *= 2246822507u;  // int32 -2048144789
  x ^= x >> 13;
  x *= 3266489909u;  // int32 -1028477387
  x ^= x >> 16;
  return (x & 0xFFFFFFu) >= thresh;
}

// The keep decision for one (seed, bh, query position, key position).
__device__ __forceinline__ bool drop_keep(uint32_t seed, uint32_t bh,
                                          uint32_t q, uint32_t k,
                                          float rate) {
  return drop_keep_at(drop_row(seed, bh, q), k, drop_thresh(rate));
}

// Sum / max over the 16 lanes that share a row (tx = lane & 15).
__device__ __forceinline__ float row_sum(float v) {
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}
__device__ __forceinline__ float row_max(float v) {
  for (int o = 8; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// acc[i][j] += sum_k A(a_i, k) * B(k, b_j) for a_i = ty*4 + i and
// b_j = tx + 16*j, with A(a, k) = A[a*ASA + k*ASK], B(k, b) = B[k*BSK + b*BSB].
template <int K, int NB, int ASA, int ASK, int BSK, int BSB>
__device__ __forceinline__ void mma_tile(float (&acc)[4][NB],
                                         const float* __restrict__ A,
                                         const float* __restrict__ B, int ty,
                                         int tx) {
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    float a[4], b[NB];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = A[(ty * 4 + i) * ASA + k * ASK];
#pragma unroll
    for (int j = 0; j < NB; ++j) b[j] = B[k * BSK + (tx + 16 * j) * BSB];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < NB; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

// Rows row0 .. row0+63 of one head into dst[r*(HD+1) + d] as float32
// (times scale), zero past T.  src points at (b, 0, h, 0).
template <typename T, int HD>
__device__ __forceinline__ void load_tile(float* __restrict__ dst,
                                          const T* __restrict__ src,
                                          int row0, int Tn, size_t rs,
                                          float scale = 1.f) {
  for (int i = threadIdx.x; i < kTile * HD; i += kThreads) {
    const int r = i / HD;
    const int d = i - r * HD;
    const int t = row0 + r;
    dst[r * (HD + 1) + d] =
        t < Tn ? to_f32(src[(size_t)t * rs + d]) * scale : 0.f;
  }
}

// Rows row0 .. row0+63 of a (B*H, T) float32 vector, zero past T.
__device__ __forceinline__ void load_rows(float* __restrict__ dst,
                                          const float* __restrict__ src,
                                          int row0, int Tn) {
  for (int r = threadIdx.x; r < kTile; r += kThreads)
    dst[r] = row0 + r < Tn ? src[row0 + r] : 0.f;
}

// Whether query qp sees key kp by position alone (the key mask is added to
// the score instead).  window > 0 and qs (the query's document start; 0 or
// INT_MIN without packing) only with causal.
__device__ __forceinline__ bool attends(int qp, int kp, int Tn, int causal,
                                        int window, int qs = INT_MIN) {
  if (qp >= Tn || kp >= Tn) return false;
  return !causal ||
         (kp <= qp && kp >= qs && (window <= 0 || qp - kp < window));
}

// The number of keys query qp sees by position (n of a fully masked row).
__device__ __forceinline__ float n_attended(int qp, int Tn, int causal,
                                            int window, int qs = 0) {
  if (!causal) return static_cast<float>(Tn);
  const int lo = max(window > 0 ? qp - window + 1 : 0, max(qs, 0));
  return static_cast<float>(qp - lo + 1);
}

// The document start of query qp in a batch row's (T) q_start, or 0.
__device__ __forceinline__ int row_start(const int* __restrict__ qs_b, int qp,
                                         int Tn) {
  return qs_b && qp < Tn ? qs_b[qp] : 0;
}

// A row whose every key is masked: its saved lse is -1e30 (see above).
__device__ __forceinline__ bool fully_masked(float lse) {
  return lse <= -1e29f;
}

// bias[h][qp][kp] + kvm[b][kp] for an attended pair (either may be absent).
__device__ __forceinline__ float logit_add(const float* __restrict__ bias_h,
                                           const float* __restrict__ kvm_b,
                                           int qp, int kp, int Tn) {
  float a = 0.f;
  if (bias_h) a += bias_h[(size_t)qp * Tn + kp];
  if (kvm_b) a += kvm_b[kp];
  return a;
}

// The key tiles [*j_begin, *j_end] that query tile q0 visits (K1, K2, K4).
__device__ __forceinline__ void key_tiles(int q0, int Tn, int causal,
                                          int window, int* j_begin,
                                          int* j_end) {
  const int n_tiles = (Tn + kTile - 1) / kTile;
  *j_begin = 0;
  *j_end = n_tiles - 1;
  if (causal) {
    *j_end = min(Tn - 1, q0 + kTile - 1) / kTile;
    if (window > 0) *j_begin = max(0, q0 - window + 1) / kTile;
  }
}

// p and dS of one attended-or-not pair in the backward (K2, K3, K4), from
// the scaled score s (bias and key mask already added), the row's lse and
// delta, and the dropout-scaled dP g.  kv_ok is false on a masked key.
struct PairGrad {
  float p;   // the forward's softmax probability (undropped)
  float ds;  // P * (dP - delta), zero on a masked key
};
template <bool OPT>
__device__ __forceinline__ PairGrad pair_grad(bool keep, bool kv_ok, float s,
                                              float lse, float inv_n, float g,
                                              float dl) {
  PairGrad r{0.f, 0.f};
  if (keep) {
    r.p = OPT && fully_masked(lse) ? inv_n : expf(s - lse);
    if (kv_ok) r.ds = r.p * (g - dl);
  }
  return r;
}

template <int HD>
constexpr size_t fwd_smem() {
  return sizeof(float) * (3 * kTile * (HD + 1) + kTile * kPs);
}
template <int HD>
constexpr size_t dq_smem() {
  return sizeof(float) * (4 * kTile * (HD + 1) + kTile * kPs + 2 * kTile);
}
template <int HD>
constexpr size_t dkv_smem() {
  return sizeof(float) * (4 * kTile * (HD + 1) + 2 * kTile * kPs + 2 * kTile);
}
template <int HD>
constexpr size_t dbias_smem() {
  return sizeof(float) * (4 * kTile * (HD + 1) + 2 * kTile);
}

// The options every kernel takes, as one argument.  K1-K3 are compiled
// twice: OPT = false when there is no bias, key mask, q_start or sink, so
// the plain causal path (GPT-2 training) keeps its registers and
// arithmetic.
struct Opts {
  const float* bias;  // (H, T, T) or null
  const float* kvm;   // (B, T) additive key mask or null
  const int* qs;      // (B, T) int32 document starts of packed rows or null
  const float* sink;  // (H) float32 sink logits (K1) or null
  float sm_scale;
  int causal;
  int window;
  float rate;  // dropout rate, 0 = none
  uint32_t seed;
};

// ---------------------------------------------------------------- K1

template <typename T, int HD, bool OPT>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ o, float* __restrict__ lse, int Tn, int H, Opts op) {
  constexpr int S = HD + 1;
  constexpr int NB = HD / 16;
  extern __shared__ float smem[];
  float* q_s = smem;
  float* k_s = q_s + kTile * S;
  float* v_s = k_s + kTile * S;
  float* p_s = v_s + kTile * S;

  const int n_tiles = (Tn + kTile - 1) / kTile;
  const int i = n_tiles - 1 - blockIdx.x;  // longest rows first
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const size_t rs = (size_t)H * HD;
  const size_t base = (size_t)b * Tn * rs + (size_t)h * HD;
  const int q0 = i * kTile;
  const float inv_keep = op.rate > 0.f ? 1.f / (1.f - op.rate) : 1.f;
  const float* bias_h =
      OPT && op.bias ? op.bias + (size_t)h * Tn * Tn : nullptr;
  const float* kvm_b = OPT && op.kvm ? op.kvm + (size_t)b * Tn : nullptr;
  const int* qs_b = OPT && op.qs ? op.qs + (size_t)b * Tn : nullptr;

  load_tile<T, HD>(q_s, q + base, q0, Tn, rs, op.sm_scale);
  float acc[4][NB];
  float m[4], l[4];
  int qsr[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
    qsr[r] = row_start(qs_b, q0 + ty * 4 + r, Tn);
#pragma unroll
    for (int j = 0; j < NB; ++j) acc[r][j] = 0.f;
  }
  int j_begin, j_end;
  key_tiles(q0, Tn, op.causal, op.window, &j_begin, &j_end);
  for (int j = j_begin; j <= j_end; ++j) {
    const int k0 = j * kTile;
    __syncthreads();  // the last tile's products are done with k_s, v_s, p_s
    load_tile<T, HD>(k_s, k + base, k0, Tn, rs);
    load_tile<T, HD>(v_s, v + base, k0, Tn, rs);
    __syncthreads();
    float s[4][4] = {};
    mma_tile<HD, 4, S, 1, 1, S>(s, q_s, k_s, ty, tx);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int qp = q0 + ty * 4 + r;
      bool keep[4];
      float mx = kNegInf;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int kp = k0 + tx + 16 * c;
        keep[c] = attends(qp, kp, Tn, op.causal, op.window, qsr[r]);
        if (keep[c]) {
          s[r][c] += logit_add(bias_h, kvm_b, qp, kp, Tn);
          mx = fmaxf(mx, s[r][c]);
        }
      }
      const float m_new = fmaxf(m[r], row_max(mx));
      const float alpha = expf(m[r] - m_new);
      float psum = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int kp = k0 + tx + 16 * c;
        float p = keep[c] ? expf(s[r][c] - m_new) : 0.f;
        psum += p;
        if (op.rate > 0.f)
          p *= drop_keep(op.seed, bh, qp, kp, op.rate) ? inv_keep : 0.f;
        p_s[(ty * 4 + r) * kPs + tx + 16 * c] = p;
      }
      l[r] = alpha * l[r] + row_sum(psum);
      m[r] = m_new;
#pragma unroll
      for (int d = 0; d < NB; ++d) acc[r][d] *= alpha;
    }
    __syncthreads();
    mma_tile<kTile, NB, kPs, 1, S, 1>(acc, p_s, v_s, ty, tx);
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int qp = q0 + ty * 4 + r;
    if (qp >= Tn) continue;
    float mr = m[r], lr = l[r], sc = 1.f;
    if (OPT && op.sink) {  // the sink joins the normalizer only
      const float sk = op.sink[h];
      const float mt = fmaxf(mr, sk);
      sc = expf(mr - mt);
      lr = lr * sc + expf(sk - mt);
      mr = mt;
    }
    const float inv_l = lr > 0.f ? sc / lr : 0.f;
    T* orow = o + base + (size_t)qp * rs;
#pragma unroll
    for (int d = 0; d < NB; ++d)
      orow[tx + 16 * d] = from_f32<T>(acc[r][d] * inv_l);
    if (tx == 0) lse[(size_t)bh * Tn + qp] = mr + logf(lr);
  }
}

// ---------------------------------------------------------------- K2

template <typename T, int HD, bool OPT>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, T* __restrict__ dq, int Tn, int H,
    Opts op) {
  constexpr int S = HD + 1;
  constexpr int NB = HD / 16;
  extern __shared__ float smem[];
  float* q_s = smem;
  float* do_s = q_s + kTile * S;
  float* k_s = do_s + kTile * S;
  float* v_s = k_s + kTile * S;
  float* ds_s = v_s + kTile * S;
  float* lse_s = ds_s + kTile * kPs;
  float* dl_s = lse_s + kTile;

  const int n_tiles = (Tn + kTile - 1) / kTile;
  const int i = n_tiles - 1 - blockIdx.x;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const size_t rs = (size_t)H * HD;
  const size_t base = (size_t)b * Tn * rs + (size_t)h * HD;
  const int q0 = i * kTile;
  const float inv_keep = op.rate > 0.f ? 1.f / (1.f - op.rate) : 1.f;
  const float* bias_h =
      OPT && op.bias ? op.bias + (size_t)h * Tn * Tn : nullptr;
  const float* kvm_b = OPT && op.kvm ? op.kvm + (size_t)b * Tn : nullptr;
  const int* qs_b = OPT && op.qs ? op.qs + (size_t)b * Tn : nullptr;

  load_tile<T, HD>(q_s, q + base, q0, Tn, rs);
  load_tile<T, HD>(do_s, dout + base, q0, Tn, rs);
  load_rows(lse_s, lse + (size_t)bh * Tn, q0, Tn);
  load_rows(dl_s, delta + (size_t)bh * Tn, q0, Tn);
  float acc[4][NB] = {};
  int qsr[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) qsr[r] = row_start(qs_b, q0 + ty * 4 + r, Tn);
  int j_begin, j_end;
  key_tiles(q0, Tn, op.causal, op.window, &j_begin, &j_end);
  for (int j = j_begin; j <= j_end; ++j) {
    const int k0 = j * kTile;
    __syncthreads();
    load_tile<T, HD>(k_s, k + base, k0, Tn, rs);
    load_tile<T, HD>(v_s, v + base, k0, Tn, rs);
    __syncthreads();
    float s[4][4] = {};
    float dp[4][4] = {};
    mma_tile<HD, 4, S, 1, 1, S>(s, q_s, k_s, ty, tx);
    mma_tile<HD, 4, S, 1, 1, S>(dp, do_s, v_s, ty, tx);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = ty * 4 + r;
      const int qp = q0 + row;
      const float inv_n =
          OPT ? 1.f / n_attended(qp, Tn, op.causal, op.window, qsr[r]) : 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int kp = k0 + tx + 16 * c;
        const bool keep = attends(qp, kp, Tn, op.causal, op.window, qsr[r]);
        const float sc = keep ? s[r][c] * op.sm_scale
                                    + logit_add(bias_h, kvm_b, qp, kp, Tn)
                              : 0.f;
        const bool kv_ok = !kvm_b || !keep || kvm_b[kp] == 0.f;
        float g = dp[r][c];
        if (op.rate > 0.f)
          g *= drop_keep(op.seed, bh, qp, kp, op.rate) ? inv_keep : 0.f;
        ds_s[row * kPs + tx + 16 * c] =
            pair_grad<OPT>(keep, kv_ok, sc, lse_s[row], inv_n, g,
                           dl_s[row]).ds;
      }
    }
    __syncthreads();
    mma_tile<kTile, NB, kPs, 1, S, 1>(acc, ds_s, k_s, ty, tx);
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int qp = q0 + ty * 4 + r;
    if (qp >= Tn) continue;
    T* row = dq + base + (size_t)qp * rs;
#pragma unroll
    for (int d = 0; d < NB; ++d)
      row[tx + 16 * d] = from_f32<T>(acc[r][d] * op.sm_scale);
  }
}

// ---------------------------------------------------------------- K3

template <typename T, int HD, bool OPT>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkv_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
    int Tn, int H, Opts op) {
  constexpr int S = HD + 1;
  constexpr int NB = HD / 16;
  extern __shared__ float smem[];
  float* k_s = smem;
  float* v_s = k_s + kTile * S;
  float* q_s = v_s + kTile * S;
  float* do_s = q_s + kTile * S;
  float* p_s = do_s + kTile * S;
  float* ds_s = p_s + kTile * kPs;
  float* lse_s = ds_s + kTile * kPs;
  float* dl_s = lse_s + kTile;

  const int n_tiles = (Tn + kTile - 1) / kTile;
  const int j = blockIdx.x;  // key tile; low tiles have the most rows
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const size_t rs = (size_t)H * HD;
  const size_t base = (size_t)b * Tn * rs + (size_t)h * HD;
  const int k0 = j * kTile;
  const float inv_keep = op.rate > 0.f ? 1.f / (1.f - op.rate) : 1.f;
  const float* bias_h =
      OPT && op.bias ? op.bias + (size_t)h * Tn * Tn : nullptr;
  const float* kvm_b = OPT && op.kvm ? op.kvm + (size_t)b * Tn : nullptr;
  const int* qs_b = OPT && op.qs ? op.qs + (size_t)b * Tn : nullptr;

  load_tile<T, HD>(k_s, k + base, k0, Tn, rs);
  load_tile<T, HD>(v_s, v + base, k0, Tn, rs);
  float dk_acc[4][NB] = {};
  float dv_acc[4][NB] = {};
  int i_begin = 0, i_end = n_tiles;  // exclusive
  if (op.causal) {
    i_begin = j;
    if (op.window > 0)
      i_end = min(i_end, (k0 + kTile - 1 + op.window - 1) / kTile + 1);
  }
  for (int i = i_begin; i < i_end; ++i) {
    const int q0 = i * kTile;
    __syncthreads();
    load_tile<T, HD>(q_s, q + base, q0, Tn, rs);
    load_tile<T, HD>(do_s, dout + base, q0, Tn, rs);
    load_rows(lse_s, lse + (size_t)bh * Tn, q0, Tn);
    load_rows(dl_s, delta + (size_t)bh * Tn, q0, Tn);
    __syncthreads();
    float s[4][4] = {};
    float dp[4][4] = {};
    mma_tile<HD, 4, S, 1, 1, S>(s, q_s, k_s, ty, tx);
    mma_tile<HD, 4, S, 1, 1, S>(dp, do_s, v_s, ty, tx);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = ty * 4 + r;
      const int qp = q0 + row;
      const int qsv = row_start(qs_b, qp, Tn);
      const float inv_n =
          OPT ? 1.f / n_attended(qp, Tn, op.causal, op.window, qsv) : 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int kp = k0 + tx + 16 * c;
        const bool keep = attends(qp, kp, Tn, op.causal, op.window, qsv);
        const float sc = keep ? s[r][c] * op.sm_scale
                                    + logit_add(bias_h, kvm_b, qp, kp, Tn)
                              : 0.f;
        const bool kv_ok = !kvm_b || !keep || kvm_b[kp] == 0.f;
        float dm = 1.f;
        if (op.rate > 0.f)
          dm = drop_keep(op.seed, bh, qp, kp, op.rate) ? inv_keep : 0.f;
        const PairGrad pg = pair_grad<OPT>(keep, kv_ok, sc, lse_s[row],
                                           inv_n, dp[r][c] * dm, dl_s[row]);
        p_s[row * kPs + tx + 16 * c] = pg.p * dm;  // dV sees the dropped P
        ds_s[row * kPs + tx + 16 * c] = pg.ds;
      }
    }
    __syncthreads();
    // dV[c][d] += sum_r P[r][c] dO[r][d];  dK[c][d] += sum_r dS[r][c] Q[r][d]
    mma_tile<kTile, NB, 1, kPs, S, 1>(dv_acc, p_s, do_s, ty, tx);
    mma_tile<kTile, NB, 1, kPs, S, 1>(dk_acc, ds_s, q_s, ty, tx);
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int kp = k0 + ty * 4 + r;
    if (kp >= Tn) continue;
    T* krow = dk + base + (size_t)kp * rs;
    T* vrow = dv + base + (size_t)kp * rs;
#pragma unroll
    for (int d = 0; d < NB; ++d) {
      krow[tx + 16 * d] = from_f32<T>(dk_acc[r][d] * op.sm_scale);
      vrow[tx + 16 * d] = from_f32<T>(dv_acc[r][d]);
    }
  }
}

// ---------------------------------------------------------------- K4

// dbias[h, q tile, k tile] = sum_b dS_bh over that tile.  Block (x, y, z) =
// (key tile, query tile, head); thread (ty, tx) owns the same 4 x 4 pairs
// as in K2.  Per batch row it stages q, dO, k, v and the rows' lse, delta.
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads) flash_bwd_dbias_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, float* __restrict__ dbias, int B, int Tn,
    int H, Opts op) {
  constexpr int S = HD + 1;
  extern __shared__ float smem[];
  float* q_s = smem;
  float* do_s = q_s + kTile * S;
  float* k_s = do_s + kTile * S;
  float* v_s = k_s + kTile * S;
  float* lse_s = v_s + kTile * S;
  float* dl_s = lse_s + kTile;

  const int k0 = blockIdx.x * kTile;
  const int q0 = blockIdx.y * kTile;
  const int h = blockIdx.z;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const size_t rs = (size_t)H * HD;
  const float inv_keep = op.rate > 0.f ? 1.f / (1.f - op.rate) : 1.f;
  const float* bias_h = op.bias + (size_t)h * Tn * Tn;

  // the tile is live when the causal band reaches it (K1's key_tiles)
  int j_begin, j_end;
  key_tiles(q0, Tn, op.causal, op.window, &j_begin, &j_end);
  const bool live = (int)blockIdx.x >= j_begin && (int)blockIdx.x <= j_end;

  float acc[4][4] = {};
  float bias_r[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int qp = q0 + ty * 4 + r;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int kp = k0 + tx + 16 * c;
      bias_r[r][c] = attends(qp, kp, Tn, op.causal, op.window)
                         ? bias_h[(size_t)qp * Tn + kp]
                         : 0.f;
    }
  }
  for (int b = 0; live && b < B; ++b) {
    const int bh = b * H + h;
    const size_t base = (size_t)b * Tn * rs + (size_t)h * HD;
    const float* kvm_b = op.kvm ? op.kvm + (size_t)b * Tn : nullptr;
    const int* qs_b = op.qs ? op.qs + (size_t)b * Tn : nullptr;
    __syncthreads();  // the last batch row's products are done
    load_tile<T, HD>(q_s, q + base, q0, Tn, rs);
    load_tile<T, HD>(do_s, dout + base, q0, Tn, rs);
    load_tile<T, HD>(k_s, k + base, k0, Tn, rs);
    load_tile<T, HD>(v_s, v + base, k0, Tn, rs);
    load_rows(lse_s, lse + (size_t)bh * Tn, q0, Tn);
    load_rows(dl_s, delta + (size_t)bh * Tn, q0, Tn);
    __syncthreads();
    float s[4][4] = {};
    float dp[4][4] = {};
    mma_tile<HD, 4, S, 1, 1, S>(s, q_s, k_s, ty, tx);
    mma_tile<HD, 4, S, 1, 1, S>(dp, do_s, v_s, ty, tx);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = ty * 4 + r;
      const int qp = q0 + row;
      const int qsv = row_start(qs_b, qp, Tn);
      const float inv_n =
          1.f / n_attended(qp, Tn, op.causal, op.window, qsv);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int kp = k0 + tx + 16 * c;
        const bool keep = attends(qp, kp, Tn, op.causal, op.window, qsv);
        float sc = s[r][c] * op.sm_scale + bias_r[r][c];
        bool kv_ok = true;
        if (kvm_b && keep) {
          sc += kvm_b[kp];
          kv_ok = kvm_b[kp] == 0.f;
        }
        float g = dp[r][c];
        if (op.rate > 0.f)
          g *= drop_keep(op.seed, bh, qp, kp, op.rate) ? inv_keep : 0.f;
        acc[r][c] += pair_grad<true>(keep, kv_ok, sc, lse_s[row], inv_n, g,
                                     dl_s[row]).ds;
      }
    }
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int qp = q0 + ty * 4 + r;
    if (qp >= Tn) continue;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int kp = k0 + tx + 16 * c;
      if (kp < Tn) dbias[((size_t)h * Tn + qp) * Tn + kp] = acc[r][c];
    }
  }
}

// The hash alone, over a (seed, bh, q, k) grid, for checking it against
// the plain version bit for bit.
__global__ void drop_keep_kernel(const int32_t* __restrict__ seeds,
                                 int n_seeds, int n_bh, int n_q, int n_k,
                                 int q0, int k0, float rate,
                                 uint8_t* __restrict__ out) {
  const size_t n = (size_t)n_seeds * n_bh * n_q * n_k;
  for (size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x; idx < n;
       idx += (size_t)gridDim.x * blockDim.x) {
    size_t rest = idx;
    const int kk = rest % n_k;
    rest /= n_k;
    const int qq = rest % n_q;
    rest /= n_q;
    const int bh = rest % n_bh;
    const int s = rest / n_bh;
    out[idx] = drop_keep(static_cast<uint32_t>(seeds[s]), bh, q0 + qq,
                         k0 + kk, rate);
  }
}

// ================================================= K1, K2 on tensor cores
//
// bf16 only (K3, below, mirrors this design on the key side).  One block of three warpgroups per (128 query rows, bh):
// warpgroup 0 is the producer (its registers given to the others with
// setmaxnreg; one thread issues every TMA load), warpgroups 1 and 2 are
// consumers of 64 query rows each.  The query side (q; q and dO in K2)
// is loaded once by TMA; key tiles of BK rows (k and v) stream through a
// ring of STAGES stages guarded by full/empty mbarriers.  Both products
// of a key tile are wgmma: S = Q K^T (and dP = dO V^T in K2) with both
// operands in shared memory, then O += P V (dQ += dS K) with P (dS) packed
// to bf16 in registers as the A operand and the key tile, MN-major, as B.
// Everything between the products (masks, bias, key mask, dropout, the
// online softmax or the gradient of one pair) works on the f32
// accumulator registers, each at its (row, column) of the accumulator
// layout (hopper.cuh).  The arithmetic of one pair is the SIMT kernels':
// the score is scaled in f32 after the product, then the bias and the
// additive key mask are added; p is rounded to bf16 only as the operand
// of the second product, after dropout, as the JAX kernel does.
//
// Each kernel is built twice: OPT = false for no bias, no key mask, no
// q_start, no sink and no dropout (GPT-2 training), true otherwise.  Per
// key tile, a consumer takes the EDGE path (the position test on every
// pair) only where its rows and the tile cross the causal diagonal, the
// window's edge or T, or where a row's document starts after the tile's
// first key (qs_bounds: a document boundary may fall inside a tile that
// the causal rule alone calls interior).

using namespace nnl_hopper;

constexpr int kRowsTC = 128;           // query rows of a block
constexpr int kThreadsTC = 384;        // producer + two consumer warpgroups
constexpr int kHalfRow = 128;          // bytes of 64 bf16 columns
constexpr float kLog2e = 1.4426950408889634f;

// Key-tile width and ring depths (chosen by measurement at hd 64 and 128,
// PERF.md).  K1 overlaps the softmax of tile j with O += P V of tile
// j - 1, so it holds two stages at once and a third loads ahead; K2 holds
// tile j - 1 until its dQ product, issued last, has read it.
constexpr int kKeyTile = 64;
constexpr int kFwdStages = 3;
constexpr int kDqStages = 3;

// Shared memory of a kernel with NQ stationary ROWS-row tensors and a ring
// of STAGES BK-row tiles of two streamed tensors (k and v in K1/K2, q and
// dO in K3): byte offsets, tiles 1024-aligned.
template <int HD, int BK, int NQ, int STAGES, int ROWS = kRowsTC>
struct TcSmem {
  static constexpr int kNH = HD / 64;                  // 64-column halves
  static constexpr int kQ = kNH * ROWS * kHalfRow;     // one stationary
  static constexpr int kKV = kNH * BK * kHalfRow;      // one key tile
  static constexpr int kRing = NQ * kQ;
  static constexpr int kBars = kRing + STAGES * 2 * kKV;
  // q_full, full[STAGES], empty[STAGES]; 1024 of slack to align the base
  static constexpr size_t kBytes = kBars + 8 * (1 + 2 * STAGES) + 1024;
};

__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  return reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(p) + 1023) & ~static_cast<uintptr_t>(1023));
}

// The key tiles [*j_begin, *j_end] (width BK) that query rows q0 ..
// q0 + rows - 1 visit (key_tiles for any tile widths).
template <int BK>
__device__ __forceinline__ void key_range(int q0, int rows, int Tn,
                                          int causal, int window,
                                          int* j_begin, int* j_end) {
  *j_begin = 0;
  *j_end = (Tn - 1) / BK;
  if (causal) {
    *j_end = min(Tn - 1, q0 + rows - 1) / BK;
    if (window > 0) *j_begin = max(0, q0 - window + 1) / BK;
  }
}

// Whether every pair of query rows qc0 .. qc0 + BQ - 1 and key rows k0 ..
// k0 + BK - 1 is attended by causal position and window (q_start is
// tested beside it, see above).
template <int BK, int BQ = 64>
__device__ __forceinline__ bool interior(int qc0, int k0, int Tn,
                                        int causal, int window) {
  if (k0 + BK > Tn || qc0 + BQ > Tn) return false;
  return !causal || (k0 + BK - 1 <= qc0 &&
                     (window <= 0 || qc0 + BQ - 1 - k0 < window));
}

// The smallest and the largest document start (q_start, each clamped to
// its own row) among the query rows of each consumer half, q0 .. q0 + 63
// and q0 + 64 .. q0 + 127, into lo[c] and hi[c] (INT_MAX and INT_MIN for a
// half past T): key tiles that end before lo are skipped, and a tile is
// EDGE (the per-pair test) only where it starts before hi.  q_start need
// not be sorted.  All threads of the block call it.
__device__ __forceinline__ void qs_bounds(const int* __restrict__ qs_b,
                                          int q0, int Tn, int (&lo)[2],
                                          int (&hi)[2]) {
  __shared__ int bounds[4];
  if (threadIdx.x < 4) bounds[threadIdx.x] = threadIdx.x < 2 ? INT_MAX
                                                             : INT_MIN;
  __syncthreads();
  const int t = q0 + threadIdx.x;
  if (threadIdx.x < 128 && t < Tn) {
    const int s = min(qs_b[t], t);
    atomicMin(&bounds[threadIdx.x / 64], s);
    atomicMax(&bounds[2 + threadIdx.x / 64], s);
  }
  __syncthreads();
  lo[0] = bounds[0];
  lo[1] = bounds[1];
  hi[0] = bounds[2];
  hi[1] = bounds[3];
}

// q_full, then full[s] (the TMA thread's expect_tx, plus n_full - 1 other
// producer arrivals) and empty[s] (one arrival per consumer warp).
template <int STAGES>
__device__ __forceinline__ void tc_init_barriers(uint64_t* bars,
                                                 int n_full = 1,
                                                 int n_empty = 8) {
  if (threadIdx.x == 0) {
    mbar_init(bars, 1);  // q_full: the producer's expect_tx
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bars + 1 + s, n_full);
      mbar_init(bars + 1 + STAGES + s, n_empty);
    }
    fence_barrier_init();
  }
  __syncthreads();
}

// What the producer loads into a stage besides the two streamed tiles:
// nothing (K1, K2), or K3's bias tile.
struct NoExtra {
  __device__ __forceinline__ uint32_t bytes() const { return 0; }
  __device__ __forceinline__ void load(int, int, uint64_t*) const {}
};

// The producer thread: the stationary tensors' ROWS rows at q0 (NQ maps),
// then tiles j_begin .. j_end (BK rows each) of the two streamed tensors
// (tm_k, tm_v) into the ring, with extra.load(stage, j, its barrier).  A
// stage is refilled once the consumers have released its last tile (the
// empty barrier's phase before this pass) or, given `free` barriers, once
// this pass's phase of its `free` barrier completes (K3's stagers arrive
// there after copying the last tile's dS out).
template <int HD, int BK, int NQ, int STAGES, int ROWS = kRowsTC,
          class Extra = NoExtra>
__device__ __forceinline__ void tc_produce(
    uint8_t* sm, uint64_t* bars, const CUtensorMap* const (&stat)[NQ],
    const CUtensorMap* tm_k, const CUtensorMap* tm_v, int q0, int j_begin,
    int j_end, int h, int b, const Extra& extra = Extra(),
    uint64_t* free = nullptr) {
  using L = TcSmem<HD, BK, NQ, STAGES, ROWS>;
  uint64_t* full = bars + 1;
  uint64_t* empty = free ? free : bars + 1 + STAGES;
#pragma unroll
  for (int n = 0; n < NQ; ++n) prefetch_map(stat[n]);
  prefetch_map(tm_k);
  prefetch_map(tm_v);
  mbar_expect_tx(bars, NQ * L::kQ);
#pragma unroll
  for (int n = 0; n < NQ; ++n)
#pragma unroll
    for (int hh = 0; hh < L::kNH; ++hh)
      tma_load_4d(sm + n * L::kQ + hh * ROWS * kHalfRow, stat[n], bars,
                  hh * 64, h, q0, b);
  for (int j = j_begin, it = 0; j <= j_end; ++j, ++it) {
    const int st = it % STAGES;
    mbar_wait(&empty[st], ((it / STAGES) & 1) ^ (free ? 0 : 1));
    mbar_expect_tx(&full[st], 2 * L::kKV + extra.bytes());
    uint8_t* kt = sm + L::kRing + st * 2 * L::kKV;
#pragma unroll
    for (int hh = 0; hh < L::kNH; ++hh) {
      tma_load_4d(kt + hh * BK * kHalfRow, tm_k, &full[st], hh * 64, h,
                  j * BK, b);
      tma_load_4d(kt + L::kKV + hh * BK * kHalfRow, tm_v, &full[st], hh * 64,
                  h, j * BK, b);
    }
    extra.load(st, j, &full[st]);
  }
}

// A consumer's view of the ring: stage it % STAGES and its phase.
template <int STAGES>
struct Ring {
  uint64_t* full;
  uint64_t* empty;
  __device__ __forceinline__ void wait(int it) const {
    mbar_wait(&full[it % STAGES], (it / STAGES) & 1);
  }
  // One arrival per consumer warp: this warp is done with stage it.
  __device__ __forceinline__ void release(int it) const {
    __syncwarp();
    if ((threadIdx.x & 31) == 0) mbar_arrive(&empty[it % STAGES]);
  }
};

// acc (64 x BK) = A (64 x HD) B^T for a stationary A at a_base (an
// AROWS-row tile, this consumer's 64 rows in it) and the streamed tile at
// b_base, both K-major halves.  Issued, not waited for.
template <int HD, int BK, int AROWS = kRowsTC>
__device__ __forceinline__ void tc_scores(float (&acc)[BK / 2],
                                          uint32_t a_base, uint32_t b_base) {
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const uint32_t off = (kk & 3) * 32;
    wgmma_ss<BK>(acc,
                 desc_sw128(a_base + (kk >> 2) * AROWS * kHalfRow + off, 0,
                            1024),
                 desc_sw128(b_base + (kk >> 2) * BK * kHalfRow + off, 0,
                            1024),
                 kk > 0);
  }
}

// acc (64 x HD) += A (64 x BK, bf16 registers) B for the key tile at
// b_base read MN-major (its hd columns contiguous).  Issued, not waited.
template <int HD, int BK>
__device__ __forceinline__ void tc_accumulate(float (&acc)[HD / 64][32],
                                              const uint32_t (&a)[BK / 16][4],
                                              uint32_t b_base) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
    for (int hh = 0; hh < HD / 64; ++hh)
      wgmma_rs_tb<64>(acc[hh], a[kk],
                      desc_sw128(b_base + hh * BK * kHalfRow + kk * 2048,
                                 BK * kHalfRow, 1024),
                      1);
}

template <int HD>
__device__ __forceinline__ void fence_acc(float (&acc)[HD / 64][32]) {
#pragma unroll
  for (int hh = 0; hh < HD / 64; ++hh) fence_regs(acc[hh]);
}

template <int N>
__device__ __forceinline__ void fence_operand(uint32_t (&a)[N][4]) {
#pragma unroll
  for (int k = 0; k < N; ++k)
#pragma unroll
    for (int r = 0; r < 4; ++r) asm volatile("" : "+r"(a[k][r])::"memory");
}

// Packs the f32 accumulator x (64 x BK) into BK / 16 bf16 A operands.
template <int BK>
__device__ __forceinline__ void pack_operand(const float (&x)[BK / 2],
                                             uint32_t (&a)[BK / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      a[kk][r] = pack_bf16(x[8 * kk + 2 * r], x[8 * kk + 2 * r + 1]);
}

// Sum / max over the 4 lanes that share an accumulator row.
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

// What a consumer thread needs to place its accumulator entries: entry
// i = 4 j + 2 r + e sits at query position ra + 8 r and key position
// k0 + 8 j + cl + e of a tile starting at key k0.
struct Pairs {
  int ra, cl, Tn, causal, window;
  int qs[2];            // the document start of each row (OPT only)
  float sm_scale;
  const float* bias_h;  // this head's (T, T) bias, or null
  const float* kvm_b;   // this batch row's (T) key mask, or null
  bool bias_pairs;      // bias rows start 8-byte aligned (T even)
  uint32_t drow[2];     // the dropout hash of each row (drop_row)
  uint32_t thresh;      // drop_thresh(rate)
  float inv_keep;
  float rate;
};

template <bool OPT>
__device__ __forceinline__ Pairs make_pairs(const Opts& op, int ra, int cl,
                                            int Tn, int bh, int b, int h) {
  Pairs px;
  px.ra = ra;
  px.cl = cl;
  px.Tn = Tn;
  px.causal = op.causal;
  px.window = op.window;
  const int* qs_b = OPT && op.qs ? op.qs + (size_t)b * Tn : nullptr;
  px.qs[0] = row_start(qs_b, ra, Tn);
  px.qs[1] = row_start(qs_b, ra + 8, Tn);
  px.sm_scale = op.sm_scale;
  px.bias_h = op.bias ? op.bias + (size_t)h * Tn * Tn : nullptr;
  px.kvm_b = op.kvm ? op.kvm + (size_t)b * Tn : nullptr;
  px.bias_pairs = (Tn & 1) == 0;
  px.drow[0] = drop_row(op.seed, bh, ra);
  px.drow[1] = drop_row(op.seed, bh, ra + 8);
  px.thresh = drop_thresh(op.rate);
  px.inv_keep = op.rate > 0.f ? 1.f / (1.f - op.rate) : 1.f;
  px.rate = op.rate;
  return px;
}

// The bias and key mask of the two pairs (qp, kp), (qp, kp + 1) inside
// the tile interior (both keys < T): *a0, *a1.
__device__ __forceinline__ void logit_pair(const Pairs& px, int qp, int kp,
                                           float kv0, float kv1, float* a0,
                                           float* a1) {
  float b0 = 0.f, b1 = 0.f;
  if (px.bias_h) {
    const float* row = px.bias_h + (size_t)qp * px.Tn + kp;
    if (px.bias_pairs) {
      const float2 bb = *reinterpret_cast<const float2*>(row);
      b0 = bb.x;
      b1 = bb.y;
    } else {
      b0 = row[0];
      b1 = row[1];
    }
  }
  *a0 = b0 + kv0;
  *a1 = b1 + kv1;
}

// K1, one tile: s (64 x BK scores) becomes the scaled logits (bias and key
// mask added, -inf where the position or the document start is not
// attended); mx gets each row's max.
template <int BK, bool OPT, bool EDGE>
__device__ __forceinline__ void fwd_logits(float (&s)[BK / 2],
                                           float (&mx)[2], int k0,
                                           const Pairs& px) {
  const float ninf = __int_as_float(0xff800000);
#pragma unroll
  for (int j = 0; j < BK / 8; ++j) {
    const int kp = k0 + 8 * j + px.cl;
    float kv0 = 0.f, kv1 = 0.f;
    if (OPT && !EDGE && px.kvm_b) {
      kv0 = px.kvm_b[kp];
      kv1 = px.kvm_b[kp + 1];
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qp = px.ra + 8 * r;
      const int i = 4 * j + 2 * r;
      // a literal without the options, so the test folds away
      const int qs = OPT ? px.qs[r] : INT_MIN;
      float x0 = s[i] * px.sm_scale, x1 = s[i + 1] * px.sm_scale;
      if (EDGE) {
        x0 = !attends(qp, kp, px.Tn, px.causal, px.window, qs) ? ninf
             : OPT ? x0 + logit_add(px.bias_h, px.kvm_b, qp, kp, px.Tn)
                   : x0;
        x1 = !attends(qp, kp + 1, px.Tn, px.causal, px.window, qs) ? ninf
             : OPT ? x1 + logit_add(px.bias_h, px.kvm_b, qp, kp + 1, px.Tn)
                   : x1;
      } else if (OPT) {
        float a0, a1;
        logit_pair(px, qp, kp, kv0, kv1, &a0, &a1);
        x0 += a0;
        x1 += a1;
      }
      s[i] = x0;
      s[i + 1] = x1;
      mx[r] = fmaxf(mx[r], fmaxf(x0, x1));
    }
  }
}

// K1, one tile: logits s become p = exp(s - m) for the rows' new maxima
// m, summed (undropped) into psum; then the dropout keep mask scaled by
// 1 / (1 - rate) when DROP.
template <int BK, bool DROP>
__device__ __forceinline__ void fwd_probs(float (&s)[BK / 2],
                                          const float (&m)[2],
                                          float (&psum)[2], int k0,
                                          const Pairs& px) {
#pragma unroll
  for (int j = 0; j < BK / 8; ++j) {
    const int kp = k0 + 8 * j + px.cl;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int i = 4 * j + 2 * r + e;
        float p = exp2f((s[i] - m[r]) * kLog2e);
        psum[r] += p;
        if (DROP)
          p = drop_keep_at(px.drow[r], kp + e, px.thresh) ? p * px.inv_keep
                                                          : 0.f;
        s[i] = p;
      }
    }
  }
}

// K1, one tile's softmax step on s: logits, the rows' new maxima, the
// rescale alpha of the old sums, and p (dropped) in s; l updated.
template <int BK, bool OPT>
__device__ __forceinline__ void fwd_softmax(float (&s)[BK / 2], float (&m)[2],
                                            float (&l)[2], float (&alpha)[2],
                                            int k0, bool edge,
                                            const Pairs& px) {
  float mx[2] = {kNegInf, kNegInf};
  if (edge)
    fwd_logits<BK, OPT, true>(s, mx, k0, px);
  else
    fwd_logits<BK, OPT, false>(s, mx, k0, px);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float m_new = fmaxf(m[r], quad_max(mx[r]));
    alpha[r] = exp2f((m[r] - m_new) * kLog2e);
    m[r] = m_new;
  }
  float psum[2] = {0.f, 0.f};
  if (OPT && px.rate > 0.f)
    fwd_probs<BK, true>(s, m, psum, k0, px);
  else
    fwd_probs<BK, false>(s, m, psum, k0, px);
#pragma unroll
  for (int r = 0; r < 2; ++r) l[r] = alpha[r] * l[r] + quad_sum(psum[r]);
}

// K2, one tile: s (scores) and dp (dO V^T) become dS = P (dP m - delta)
// in s, m the dropout keep factor (1 / (1 - rate) or 0), and dS = 0 where
// the pair is not attended or its key is masked; P is the forward's
// probability (exp(s - lse), or 1/n for a fully masked row).
template <int BK, bool OPT, bool EDGE, bool DROP>
__device__ __forceinline__ void dq_grads(float (&s)[BK / 2],
                                         const float (&dp)[BK / 2], int k0,
                                         const Pairs& px,
                                         const float (&lse)[2],
                                         const float (&dl)[2],
                                         const float (&inv_n)[2]) {
#pragma unroll
  for (int j = 0; j < BK / 8; ++j) {
    const int kp = k0 + 8 * j + px.cl;
    float kv0 = 0.f, kv1 = 0.f;
    if (OPT && !EDGE && px.kvm_b) {
      kv0 = px.kvm_b[kp];
      kv1 = px.kvm_b[kp + 1];
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qp = px.ra + 8 * r;
      const int i = 4 * j + 2 * r;
      float add[2] = {0.f, 0.f};
      float kv[2] = {kv0, kv1};
      if (OPT && !EDGE) logit_pair(px, qp, kp, kv0, kv1, &add[0], &add[1]);
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float ds = 0.f;
        if (!EDGE || attends(qp, kp + e, px.Tn, px.causal, px.window,
                             OPT ? px.qs[r] : INT_MIN)) {
          if (OPT && EDGE) {
            add[e] = logit_add(px.bias_h, px.kvm_b, qp, kp + e, px.Tn);
            kv[e] = px.kvm_b ? px.kvm_b[kp + e] : 0.f;
          }
          // s * scale + add - lse in one rounding, so the options' path
          // gives the plain path's bits where add is 0 (a q_start of one
          // document)
          const float t = __fmaf_rn(s[i + e], px.sm_scale,
                                    (OPT ? add[e] : 0.f) - lse[r]);
          float g = dp[i + e];
          if (DROP)
            g = drop_keep_at(px.drow[r], kp + e, px.thresh) ? g * px.inv_keep
                                                            : 0.f;
          const float p = OPT && fully_masked(lse[r]) ? inv_n[r]
                                                      : exp2f(t * kLog2e);
          if (!OPT || kv[e] == 0.f) ds = p * (g - dl[r]);
        }
        s[i + e] = ds;
      }
    }
  }
}

template <int BK, bool OPT>
__device__ __forceinline__ void dq_grads_any(float (&s)[BK / 2],
                                             const float (&dp)[BK / 2],
                                             int k0, bool edge,
                                             const Pairs& px,
                                             const float (&lse)[2],
                                             const float (&dl)[2],
                                             const float (&inv_n)[2]) {
  if (OPT && px.rate > 0.f) {
    if (edge)
      dq_grads<BK, OPT, true, true>(s, dp, k0, px, lse, dl, inv_n);
    else
      dq_grads<BK, OPT, false, true>(s, dp, k0, px, lse, dl, inv_n);
  } else {
    if (edge)
      dq_grads<BK, OPT, true, false>(s, dp, k0, px, lse, dl, inv_n);
    else
      dq_grads<BK, OPT, false, false>(s, dp, k0, px, lse, dl, inv_n);
  }
}

// Rows of a 64 x HD f32 accumulator (times scale per row) as bf16 at
// out + (row position) * rs, rows at or past T skipped.  Row ra + 8 r.
template <int HD>
__device__ __forceinline__ void store_rows(const float (&acc)[HD / 64][32],
                                           const float (&scale)[2],
                                           __nv_bfloat16* out, size_t rs,
                                           int ra, int cl, int Tn) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qp = ra + 8 * r;
    if (qp >= Tn) continue;
    __nv_bfloat16* row = out + (size_t)qp * rs;
#pragma unroll
    for (int hh = 0; hh < HD / 64; ++hh)
#pragma unroll
      for (int jj = 0; jj < 8; ++jj)
        *reinterpret_cast<uint32_t*>(row + hh * 64 + 8 * jj + cl) =
            pack_bf16(acc[hh][4 * jj + 2 * r] * scale[r],
                      acc[hh][4 * jj + 2 * r + 1] * scale[r]);
  }
}

// ---------------------------------------------------------------- K1
//
// Replaces _fwd_kernel (neuralnetworklibrary_tpu/ops/flash_attention.py
// :119) for bf16.  Bound at the GPT-2 training shape (B 8, H 12, T 1024,
// hd 64, causal): 12.9 GFLOP of tensor-core work (0.013 ms at 989 TFLOP/s)
// against 50 MB moved (0.015 ms at 3.35 TB/s); at the T5 encoder's (B 16,
// H 12, T 512, bidirectional, bias, key mask) the f32 bias read makes it
// 0.019 ms of bytes.  Both products run on the tensor cores; the TMA ring
// loads ahead; each consumer issues tile j's S = Q K^T together with tile
// j - 1's O += P V and runs tile j's softmax while P V is on the tensor
// cores (the two consumers overlap each other besides); the batch-shared
// bias is read from L2.
template <int HD, int BK, int STAGES, bool OPT>
__global__ void __launch_bounds__(kThreadsTC, 1) flash_fwd_tc_kernel(
    const __grid_constant__ CUtensorMap tm_q,
    const __grid_constant__ CUtensorMap tm_k,
    const __grid_constant__ CUtensorMap tm_v, __nv_bfloat16* __restrict__ o,
    float* __restrict__ lse, int Tn, int H, Opts op) {
  using L = TcSmem<HD, BK, 1, STAGES>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = align1024(smem_raw);
  uint64_t* bars = reinterpret_cast<uint64_t*>(sm + L::kBars);

  const int n_blk = (Tn + kRowsTC - 1) / kRowsTC;
  const int q0 = (n_blk - 1 - (int)blockIdx.x) * kRowsTC;  // longest first
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  int j_begin, j_end;
  key_range<BK>(q0, kRowsTC, Tn, op.causal, op.window, &j_begin, &j_end);
  int qlo[2] = {0, 0}, qhi[2] = {INT_MIN, INT_MIN};
  if (OPT && op.qs) {
    qs_bounds(op.qs + (size_t)b * Tn, q0, Tn, qlo, qhi);
    j_begin = max(j_begin, min(qlo[0], qlo[1]) / BK);
  }
  tc_init_barriers<STAGES>(bars);

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    regs_dealloc<24>();
    if (threadIdx.x == 0) {
      const CUtensorMap* const stat[1] = {&tm_q};
      tc_produce<HD, BK, 1, STAGES>(sm, bars, stat, &tm_k, &tm_v, q0,
                                    j_begin, j_end, h, b);
    }
  } else {
    regs_alloc<240>();
    const int c = wg - 1;
    const int lane = threadIdx.x & 31;
    const int qc0 = q0 + 64 * c;
    const int ra = qc0 + 16 * ((threadIdx.x & 127) >> 5) + (lane >> 2);
    const int cl = 2 * (lane & 3);
    const Pairs px = make_pairs<OPT>(op, ra, cl, Tn, bh, b, h);
    const Ring<STAGES> ring{bars + 1, bars + 1 + STAGES};
    const uint32_t q_base = smem_addr(sm) + c * 64 * kHalfRow;
    const uint32_t kv0 = smem_addr(sm + L::kRing);
    // this consumer's tiles: a contiguous part of the block's (none past T)
    int jc_begin, jc_end;
    key_range<BK>(qc0, 64, Tn, op.causal, op.window, &jc_begin, &jc_end);
    jc_begin = max(jc_begin, qlo[c] / BK);
    if (qc0 >= Tn) jc_begin = j_end + 1;
    const int qhi_c = qhi[c];  // tiles starting before it are EDGE
    const int it_begin = jc_begin - j_begin;
    const int it_end = min(jc_end, j_end) - j_begin;  // inclusive
    const int n_it = j_end - j_begin + 1;
    for (int it = 0; it < min(it_begin, n_it); ++it) {
      ring.wait(it);
      ring.release(it);
    }

    float acc[HD / 64][32];
#pragma unroll
    for (int hh = 0; hh < HD / 64; ++hh)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[hh][i] = 0.f;
    float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
    if (it_begin <= it_end) {
      mbar_wait(bars, 0);
      float s[BK / 2], alpha[2];
      uint32_t pa[BK / 16][4];
      // tile it_begin: S, softmax, P
      ring.wait(it_begin);
      wgmma_fence();
      tc_scores<HD, BK>(s, q_base, kv0 + (it_begin % STAGES) * 2 * L::kKV);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);
      int k0 = (j_begin + it_begin) * BK;
      fwd_softmax<BK, OPT>(
          s, m, l, alpha, k0,
          !interior<BK>(qc0, k0, Tn, op.causal, op.window) || k0 < qhi_c,
          px);
      pack_operand<BK>(s, pa);
      for (int it = it_begin + 1; it <= it_end; ++it) {
        // S of tile it and P V of tile it - 1 on the tensor cores, then
        // the softmax of tile it beside the second
        const uint32_t prev = kv0 + ((it - 1) % STAGES) * 2 * L::kKV;
        ring.wait(it);
        wgmma_fence();
        tc_scores<HD, BK>(s, q_base, kv0 + (it % STAGES) * 2 * L::kKV);
        wgmma_commit();
        tc_accumulate<HD, BK>(acc, pa, prev + L::kKV);
        wgmma_commit();
        wgmma_wait<1>();
        fence_regs(s);
        k0 = (j_begin + it) * BK;
        fwd_softmax<BK, OPT>(
            s, m, l, alpha, k0,
            !interior<BK>(qc0, k0, Tn, op.causal, op.window) || k0 < qhi_c,
            px);
        wgmma_wait<0>();
        fence_acc<HD>(acc);
        fence_operand(pa);
        ring.release(it - 1);
#pragma unroll
        for (int hh = 0; hh < HD / 64; ++hh)
#pragma unroll
          for (int i = 0; i < 32; ++i) acc[hh][i] *= alpha[(i >> 1) & 1];
        pack_operand<BK>(s, pa);
      }
      wgmma_fence();
      tc_accumulate<HD, BK>(acc, pa,
                            kv0 + (it_end % STAGES) * 2 * L::kKV + L::kKV);
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc<HD>(acc);
      ring.release(it_end);
    }
    for (int it = max(it_end + 1, it_begin); it < n_it; ++it) {
      ring.wait(it);
      ring.release(it);
    }
    if (qc0 < Tn) {
      const size_t rs = (size_t)H * HD;
      float inv_l[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float sc = 1.f;
        if (OPT && op.sink) {  // the sink joins the normalizer only
          const float sk = op.sink[h];
          const float mt = fmaxf(m[r], sk);
          sc = expf(m[r] - mt);
          l[r] = l[r] * sc + expf(sk - mt);
          m[r] = mt;
        }
        inv_l[r] = l[r] > 0.f ? sc / l[r] : 0.f;
      }
      store_rows<HD>(acc, inv_l, o + (size_t)b * Tn * rs + (size_t)h * HD,
                     rs, ra, cl, Tn);
      if ((lane & 3) == 0) {
#pragma unroll
        for (int r = 0; r < 2; ++r)
          if (ra + 8 * r < Tn)
            lse[(size_t)bh * Tn + ra + 8 * r] = m[r] + logf(l[r]);
      }
    }
  }
}

// ---------------------------------------------------------------- K2
//
// Replaces _bwd_dq_kernel (flash_attention.py:275) for bf16.  Bound at the
// GPT-2 shape: 19.3 GFLOP (0.020 ms at 989 TFLOP/s; three products per
// pair) against 64 MB (0.019 ms); at the T5 encoder's 0.023 ms of bytes
// (the bias).  The same block and ring as K1: q and dO stay in shared
// memory, the rows' lse and delta in registers; per key tile S and dP are
// two shared-memory wgmmas, dS = P (dP - delta) is formed on their
// registers and goes to
// bf16 as the A operand of dQ += dS K (as the JAX kernel's
// ds.astype(k.dtype)).  dq is its own kernel (no atomics), so it is
// deterministic.
template <int HD, int BK, int STAGES, bool OPT>
__global__ void __launch_bounds__(kThreadsTC, 1) flash_bwd_dq_tc_kernel(
    const __grid_constant__ CUtensorMap tm_q,
    const __grid_constant__ CUtensorMap tm_do,
    const __grid_constant__ CUtensorMap tm_k,
    const __grid_constant__ CUtensorMap tm_v, const float* __restrict__ lse,
    const float* __restrict__ delta, __nv_bfloat16* __restrict__ dq, int Tn,
    int H, Opts op) {
  using L = TcSmem<HD, BK, 2, STAGES>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = align1024(smem_raw);
  uint64_t* bars = reinterpret_cast<uint64_t*>(sm + L::kBars);

  const int n_blk = (Tn + kRowsTC - 1) / kRowsTC;
  const int q0 = (n_blk - 1 - (int)blockIdx.x) * kRowsTC;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  int j_begin, j_end;
  key_range<BK>(q0, kRowsTC, Tn, op.causal, op.window, &j_begin, &j_end);
  int qlo[2] = {0, 0}, qhi[2] = {INT_MIN, INT_MIN};
  if (OPT && op.qs) {
    qs_bounds(op.qs + (size_t)b * Tn, q0, Tn, qlo, qhi);
    j_begin = max(j_begin, min(qlo[0], qlo[1]) / BK);
  }
  tc_init_barriers<STAGES>(bars);

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    regs_dealloc<24>();
    if (threadIdx.x == 0) {
      const CUtensorMap* const stat[2] = {&tm_q, &tm_do};
      tc_produce<HD, BK, 2, STAGES>(sm, bars, stat, &tm_k, &tm_v, q0,
                                    j_begin, j_end, h, b);
    }
  } else {
    regs_alloc<240>();
    const int c = wg - 1;
    const int lane = threadIdx.x & 31;
    const int qc0 = q0 + 64 * c;
    const int ra = qc0 + 16 * ((threadIdx.x & 127) >> 5) + (lane >> 2);
    const int cl = 2 * (lane & 3);
    const Pairs px = make_pairs<OPT>(op, ra, cl, Tn, bh, b, h);
    const Ring<STAGES> ring{bars + 1, bars + 1 + STAGES};
    const uint32_t q_base = smem_addr(sm) + c * 64 * kHalfRow;
    const uint32_t do_base = q_base + L::kQ;
    const uint32_t kv0 = smem_addr(sm + L::kRing);
    int jc_begin, jc_end;
    key_range<BK>(qc0, 64, Tn, op.causal, op.window, &jc_begin, &jc_end);
    jc_begin = max(jc_begin, qlo[c] / BK);
    if (qc0 >= Tn) jc_begin = j_end + 1;
    const int qhi_c = qhi[c];  // tiles starting before it are EDGE
    const int it_begin = jc_begin - j_begin;
    const int it_end = min(jc_end, j_end) - j_begin;  // inclusive
    const int n_it = j_end - j_begin + 1;
    for (int it = 0; it < min(it_begin, n_it); ++it) {
      ring.wait(it);
      ring.release(it);
    }

    float lse_r[2], dl_r[2], inv_n[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qp = ra + 8 * r;
      lse_r[r] = qp < Tn ? lse[(size_t)bh * Tn + qp] : 0.f;
      dl_r[r] = qp < Tn ? delta[(size_t)bh * Tn + qp] : 0.f;
      inv_n[r] = OPT ? 1.f / n_attended(qp, Tn, op.causal, op.window,
                                        px.qs[r])
                     : 0.f;
    }
    float acc[HD / 64][32];
#pragma unroll
    for (int hh = 0; hh < HD / 64; ++hh)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[hh][i] = 0.f;

    if (it_begin <= it_end) {
      mbar_wait(bars, 0);
      uint32_t da[BK / 16][4];
      for (int it = it_begin; it <= it_end; ++it) {
        // S and dP of tile it go to the tensor cores behind dQ of tile
        // it - 1, which is waited for only here
        const uint32_t k_base = kv0 + (it % STAGES) * 2 * L::kKV;
        const int k0 = (j_begin + it) * BK;
        float s[BK / 2], dp[BK / 2];
        ring.wait(it);
        wgmma_fence();
        tc_scores<HD, BK>(s, q_base, k_base);
        tc_scores<HD, BK>(dp, do_base, k_base + L::kKV);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(s);
        fence_regs(dp);
        if (it > it_begin) {
          fence_acc<HD>(acc);
          fence_operand(da);
          ring.release(it - 1);
        }
        dq_grads_any<BK, OPT>(
            s, dp, k0,
            !interior<BK>(qc0, k0, Tn, op.causal, op.window) || k0 < qhi_c,
            px, lse_r, dl_r, inv_n);
        pack_operand<BK>(s, da);
        wgmma_fence();
        tc_accumulate<HD, BK>(acc, da, k_base);
        wgmma_commit();
      }
      wgmma_wait<0>();
      fence_acc<HD>(acc);
      ring.release(it_end);
    }
    for (int it = max(it_end + 1, it_begin); it < n_it; ++it) {
      ring.wait(it);
      ring.release(it);
    }
    if (qc0 < Tn) {
      const float scale[2] = {op.sm_scale, op.sm_scale};
      const size_t rs = (size_t)H * HD;
      store_rows<HD>(acc, scale, dq + (size_t)b * Tn * rs + (size_t)h * HD,
                     rs, ra, cl, Tn);
    }
  }
}

// ---------------------------------------------------------------- K3
//
// Replaces _bwd_dkv_kernel (flash_attention.py:338) for bf16, and with it
// _bwd_dbias_kernel (:419): the pass that forms dS for dK also writes it
// out for dbias.  Bound at the GPT-2 shape: 25.8 GFLOP (four products per
// pair, 0.026 ms at 989 TFLOP/s) against 64 MB; at the T5 encoder's the
// bias read (and the dbias write) make it bytes, 0.027 ms (0.031 with
// dbias).  One block per (NC * 64 key rows, bh): the key side (k and v)
// is loaded once by TMA and stays; query tiles of BQ rows (q and dO)
// stream through the ring, which the producer fills: thread 0 by TMA,
// with the tile's float32 bias [query][key] as boxes of 32 keys
// (128-byte swizzled, so the consumers read it without bank conflicts),
// and 96 other threads with the tile's lse and delta (and the bias where
// TMA cannot read it: T no multiple of 4, rows along the key axis so the
// loads coalesce).  Each consumer warpgroup owns 64 key rows, so the
// scores are transposed, keys as the wgmma M dimension: S^T = K Q^T and
// dP^T = V dO^T with both operands in shared memory, then dV += P^T dO
// and dK += dS^T Q with P and dS packed to bf16 in registers as the A
// operand and the query tile, MN-major, as B (as K1's O += P V).  S^T and
// dP^T of tile i go to the tensor cores behind dV, dK of tile i - 1.  A
// thread's accumulator columns are queries, so the per-query values
// (lse, delta, the dropout row hash, 1 / n of a fully masked row) are
// per column, and the key mask per row, loaded once.  dK is scaled by
// sm_scale once, at the store.  The arithmetic of one pair is K2's.
//
// dbias (design (a), PERF.md): the consumers write each batch row's dS
// (float32, before its bf16 rounding) over the bias tile in place; once
// they release the stage, the producer's stagers store the tile row by row
// (16-byte stores along the key axis) into a (B*H, Tp, Tp) float32
// scratch, Tp = T rounded up to 64, before TMA may refill it;
// flash_dbias_reduce_kernel then sums the B rows in a fixed order.  No
// atomics: two runs give the same bits.

// K3's query-tile width (the wgmma N of S^T and dP^T), consumer
// warpgroups (64 key rows each) and ring depth, at hd 64 and hd 128
// (chosen by measurement, PERF.md).
constexpr int kDkvQTile64 = 64;
constexpr int kDkvGroups64 = 2;
constexpr int kDkvStages64 = 2;
constexpr int kDkvQTile128 = 32;
constexpr int kDkvGroups128 = 2;
constexpr int kDkvStages128 = 3;

// The registers the producer warpgroup keeps when K3 has two consumer
// warpgroups, at hd 64 and 128 (setmaxnreg; the consumers then take what
// it gives back), or 0 for no setmaxnreg and 168 each.  ptxas allocates
// each side within its count, so too few spill in the producer's code
// and too many in the consumers' (chosen by measurement, PERF.md).
constexpr int kDkvProducerRegs64 = 88;
constexpr int kDkvProducerRegs128 = 72;

// The producer threads that stage each query tile's lse and delta (and a
// bias TMA cannot read): warps 1-3 of the producer warpgroup (thread 0
// issues the TMA loads).
constexpr int kStagers = 96;

// K3's shared memory: k and v stationary (ROWS rows), the ring of q and dO
// tiles, then per stage, with the options, its float32 bias tile (see
// bias_at), and per stage the tile's lse, delta and document starts (BQ
// floats each, the starts as int32 bits).
template <int HD, int BQ, int ROWS, int STAGES, bool OPT>
struct DkvSmem {
  using Tc = TcSmem<HD, BQ, 2, STAGES, ROWS>;
  static constexpr int kBias = Tc::kBars;
  static constexpr int kBiasStage = OPT ? BQ * ROWS * 4 : 0;
  static constexpr int kRows = kBias + STAGES * kBiasStage;
  static constexpr int kBars = kRows + STAGES * 3 * BQ * 4;
  // q_full, full, empty (tc_init_barriers), then copied[STAGES]
  static constexpr size_t kBytes = kBars + 8 * (1 + 3 * STAGES) + 1024;
};

// The float offset of (query row r, key column c) in a K3 bias tile of BQ
// query rows: boxes of 32 key columns, BQ rows of 128 bytes each, 128-byte
// swizzled as TMA writes them (htt_f32_map), so a warp's reads along its
// accumulator's columns, and its 16-byte reads along a row, hit 32
// distinct banks.
template <int BQ>
__device__ __forceinline__ int bias_at(int r, int c) {
  return ((c >> 5) * BQ + r) * 32 + ((((c & 31) >> 2) ^ (r & 7)) << 2) +
         (c & 3);
}

// K3's producer extra: the bias tile bias[h, q0 .. q0 + BQ, kb0 .. kb0 +
// ROWS) by TMA, ROWS / 32 boxes (when the stagers do not load it).
template <int BQ, int ROWS>
struct BiasTiles {
  const CUtensorMap* map;  // null: nothing to load here
  uint8_t* base;           // stage 0's tile
  int stage_bytes, kb0, h;
  __device__ __forceinline__ uint32_t bytes() const {
    return map ? BQ * ROWS * 4 : 0;
  }
  __device__ __forceinline__ void load(int st, int i, uint64_t* bar) const {
    if (!map) return;
#pragma unroll
    for (int x = 0; x < ROWS / 32; ++x)
      tma_load_3d(base + st * stage_bytes + x * BQ * 128, map, bar,
                  kb0 + 32 * x, i * BQ, h);
  }
};

// The query tiles [*i_begin, *i_end] (width BQ) that see key rows k0 ..
// k0 + rows - 1 (key_range mirrored): under causal from the tile of k0,
// and with a window up to the tile of the last key's last query.
template <int BQ>
__device__ __forceinline__ void query_range(int k0, int rows, int Tn,
                                            int causal, int window,
                                            int* i_begin, int* i_end) {
  *i_begin = 0;
  *i_end = (Tn - 1) / BQ;
  if (causal) {
    *i_begin = k0 / BQ;
    if (window > 0)
      *i_end = min(*i_end, (k0 + rows - 1 + window - 1) / BQ);
  }
}

// The producer's stagers.  Per query tile: once the consumers have
// released the stage (empty), the dS they left in its bias tile (tile it -
// STAGES, when part_bh is given) goes to the scratch row by row, 16-byte
// stores along the key axis, and the stage is marked copied (TMA may
// refill its bias tile); then the tile's lse, delta and document starts
// (qs_b, or 0; 0 past T) and,
// given bias_h (a bias TMA cannot read: T no multiple of 4), its bias
// tile (0 past T) in bias_at's layout, and each thread arrives on the
// stage's full barrier.
template <int HD, int BQ, int ROWS, int STAGES, bool OPT>
__device__ __forceinline__ void dkv_stage(uint8_t* sm, uint64_t* bars,
                                          const float* __restrict__ lse_bh,
                                          const float* __restrict__ dl_bh,
                                          const float* __restrict__ bias_h,
                                          const int* __restrict__ qs_b,
                                          float* __restrict__ part_bh,
                                          int kb0, int i_begin, int i_end,
                                          int Tn, int Tp) {
  using L = DkvSmem<HD, BQ, ROWS, STAGES, OPT>;
  uint64_t* full = bars + 1;
  uint64_t* empty = bars + 1 + STAGES;
  uint64_t* copied = bars + 1 + 2 * STAGES;
  const int t = threadIdx.x - 32;
  const int n_it = i_end - i_begin + 1;
  // 16-byte columns of the block's keys inside a scratch row
  const int n_col4 = min(ROWS, Tp - kb0) / 4;
  for (int it = 0; it < n_it + STAGES; ++it) {
    const int st = it % STAGES;
    mbar_wait(&empty[st], ((it / STAGES) & 1) ^ 1);
    if (OPT && part_bh && it >= STAGES) {
      const int q0 = (i_begin + it - STAGES) * BQ;
      const float* bt =
          reinterpret_cast<const float*>(sm + L::kBias + st * L::kBiasStage);
      for (int x = t; x < BQ * ROWS / 4; x += kStagers) {
        const int r = x / (ROWS / 4);
        const int c4 = x - r * (ROWS / 4);
        if (q0 + r < Tn && c4 < n_col4)
          *reinterpret_cast<float4*>(part_bh + (size_t)(q0 + r) * Tp + kb0 +
                                     4 * c4) =
              *reinterpret_cast<const float4*>(bt + bias_at<BQ>(r, 4 * c4));
      }
    }
    if (it >= n_it) continue;
    mbar_arrive(&copied[st]);
    const int q0 = (i_begin + it) * BQ;
    float* rows = reinterpret_cast<float*>(sm + L::kRows) + st * 3 * BQ;
    for (int r = t; r < BQ; r += kStagers) {
      const bool in = q0 + r < Tn;
      rows[r] = in ? lse_bh[q0 + r] : 0.f;
      rows[BQ + r] = in ? dl_bh[q0 + r] : 0.f;
      rows[2 * BQ + r] = __int_as_float(row_start(qs_b, q0 + r, Tn));
    }
    if (OPT && bias_h) {
      // every stager has copied the tile's last dS out before any
      // overwrites it
      mbar_wait(&copied[st], (it / STAGES) & 1);
      float* bt = reinterpret_cast<float*>(sm + L::kBias + st * L::kBiasStage);
      for (int x = t; x < BQ * ROWS; x += kStagers) {
        const int r = x / ROWS;
        const int c = x - r * ROWS;
        const int qp = q0 + r;
        const int kp = kb0 + c;
        bt[bias_at<BQ>(r, c)] =
            qp < Tn && kp < Tn ? bias_h[(size_t)qp * Tn + kp] : 0.f;
      }
    }
    mbar_arrive(&full[st]);
  }
}

// What a K3 consumer thread needs to place its accumulator entries:
// entry i = 4 j + 2 r + e sits at key position ka + 8 r and query
// position q0 + 8 j + cl + e of a tile starting at query q0.
struct DkvPairs {
  int ka;        // key position of the thread's first row
  int kl;        // that row's column in the block's bias tile
  int cl;        // 2 (lane % 4)
  int Tn, causal, window, bh;
  float sm_scale;
  float kv[2];   // the key mask of its two rows (0 or -1e30)
  uint32_t seed;
  uint32_t thresh;  // drop_thresh(rate)
  float inv_keep;
  bool drop;
};

// K3, one query tile: s (S^T, key rows x query columns) and dp (dP^T)
// become P m in s (dV's operand: the dropped probability) and dS = P (dP m
// - delta) in dp (dK's), m the dropout keep factor (1 / (1 - rate) or 0);
// both are 0 where the pair is not attended, dS also on a masked key.  P
// is exp2((s - lse) log2 e) of the scaled score plus bias and key mask,
// or 1/n on a fully masked row.  lse, delta and the query's document start
// (tested on EDGE tiles only) come from the stage's rows,
// the bias from its tile bt (with the options); when ds_out, dS (float32,
// before its bf16 rounding) goes back into the bias tile in its place.
// The dropout hash takes (query, key), in that order.
template <int BQ, bool OPT, bool EDGE, bool DROP>
__device__ __forceinline__ void dkv_grads(float (&s)[BQ / 2],
                                          float (&dp)[BQ / 2], int q0,
                                          const DkvPairs& px,
                                          const float* __restrict__ rows,
                                          float* bt, bool ds_out) {
#pragma unroll
  for (int j = 0; j < BQ / 8; ++j) {
    const int qc = 8 * j + px.cl;
    const float2 ls = *reinterpret_cast<const float2*>(rows + qc);
    const float2 dl = *reinterpret_cast<const float2*>(rows + BQ + qc);
    const int2 qq = *reinterpret_cast<const int2*>(rows + 2 * BQ + qc);
    const float lse[2] = {ls.x, ls.y};
    const float dlt[2] = {dl.x, dl.y};
    const int qsv[2] = {OPT ? qq.x : INT_MIN, OPT ? qq.y : INT_MIN};
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int qp = q0 + qc + e;
      const uint32_t drow = DROP ? drop_row(px.seed, px.bh, qp) : 0u;
      const float inv_n =
          OPT ? 1.f / n_attended(qp, px.Tn, px.causal, px.window, qsv[e])
              : 0.f;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int i = 4 * j + 2 * r + e;
        const int kp = px.ka + 8 * r;
        float* at =
            OPT && bt ? bt + bias_at<BQ>(qc + e, px.kl + 8 * r) : nullptr;
        float p = 0.f, ds = 0.f;
        if (!EDGE || attends(qp, kp, px.Tn, px.causal, px.window, qsv[e])) {
          // s * scale + add - lse in one rounding (see dq_grads)
          const float t = __fmaf_rn(
              s[i], px.sm_scale,
              (OPT ? (at ? *at : 0.f) + px.kv[r] : 0.f) - lse[e]);
          float m = 1.f;
          if (DROP) m = drop_keep_at(drow, kp, px.thresh) ? px.inv_keep : 0.f;
          p = OPT && fully_masked(lse[e]) ? inv_n : exp2f(t * kLog2e);
          if (!OPT || px.kv[r] == 0.f) ds = p * (dp[i] * m - dlt[e]);
          p *= m;
        }
        s[i] = p;
        dp[i] = ds;
        if (OPT && ds_out) *at = ds;
      }
    }
  }
}

template <int BQ, bool OPT>
__device__ __forceinline__ void dkv_grads_any(float (&s)[BQ / 2],
                                              float (&dp)[BQ / 2], int q0,
                                              bool edge, const DkvPairs& px,
                                              const float* rows, float* bt,
                                              bool ds_out) {
  if (OPT && px.drop) {
    if (edge)
      dkv_grads<BQ, OPT, true, true>(s, dp, q0, px, rows, bt, ds_out);
    else
      dkv_grads<BQ, OPT, false, true>(s, dp, q0, px, rows, bt, ds_out);
  } else {
    if (edge)
      dkv_grads<BQ, OPT, true, false>(s, dp, q0, px, rows, bt, ds_out);
    else
      dkv_grads<BQ, OPT, false, false>(s, dp, q0, px, rows, bt, ds_out);
  }
}

// part (B*H, Tp, Tp), when given (with a bias), receives dS of every pair
// of the query tiles each consumer visits; bf16 dk, dv as K2's dq.
template <int HD, int BQ, int NC, int STAGES, bool OPT>
__global__ void __launch_bounds__(128 * (NC + 1), 1) flash_bwd_dkv_tc_kernel(
    const __grid_constant__ CUtensorMap tm_q,
    const __grid_constant__ CUtensorMap tm_do,
    const __grid_constant__ CUtensorMap tm_k,
    const __grid_constant__ CUtensorMap tm_v,
    const __grid_constant__ CUtensorMap tm_bias, int bias_tma,
    const float* __restrict__ lse, const float* __restrict__ delta,
    __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
    float* __restrict__ part, int Tn, int Tp, int H, Opts op) {
  constexpr int ROWS = 64 * NC;
  constexpr int kPRegs = HD == 64 ? kDkvProducerRegs64 : kDkvProducerRegs128;
  // each thread's registers at launch, and a consumer's after the
  // producer gives back 128 * (launch - kPRegs): setmaxnreg.inc waits for
  // registers the block does not own otherwise
  constexpr int kLaunchRegs = 65536 / (128 * (NC + 1)) / 8 * 8;
  constexpr int kCRegs = ((NC + 1) * kLaunchRegs - kPRegs) / NC / 8 * 8;
  using L = DkvSmem<HD, BQ, ROWS, STAGES, OPT>;
  using Tc = typename L::Tc;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = align1024(smem_raw);
  uint64_t* bars = reinterpret_cast<uint64_t*>(sm + L::kBars);

  const int kb0 = blockIdx.x * ROWS;  // low key blocks have the most rows
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  int i_begin, i_end;
  query_range<BQ>(kb0, ROWS, Tn, op.causal, op.window, &i_begin, &i_end);
  uint64_t* copied = bars + 1 + 2 * STAGES;
  if (threadIdx.x == 0)
    for (int st = 0; st < STAGES; ++st) mbar_init(copied + st, kStagers);
  tc_init_barriers<STAGES>(bars, 1 + kStagers, 4 * NC);

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    if constexpr (NC > 1 && kPRegs > 0) regs_dealloc<kPRegs>();
    const bool tma_bias = OPT && op.bias && bias_tma;
    if (threadIdx.x == 0) {
      const CUtensorMap* const stat[2] = {&tm_k, &tm_v};
      const BiasTiles<BQ, ROWS> bias{tma_bias ? &tm_bias : nullptr,
                                     sm + L::kBias, L::kBiasStage, kb0, h};
      tc_produce<HD, BQ, 2, STAGES, ROWS>(sm, bars, stat, &tm_q, &tm_do, kb0,
                                          i_begin, i_end, h, b, bias, copied);
    } else if (threadIdx.x >= 32) {
      dkv_stage<HD, BQ, ROWS, STAGES, OPT>(
          sm, bars, lse + (size_t)bh * Tn, delta + (size_t)bh * Tn,
          OPT && op.bias && !tma_bias ? op.bias + (size_t)h * Tn * Tn
                                      : nullptr,
          OPT && op.qs ? op.qs + (size_t)b * Tn : nullptr,
          OPT && op.bias && part ? part + (size_t)bh * Tp * Tp : nullptr, kb0,
          i_begin, i_end, Tn, Tp);
    }
  } else {
    if constexpr (NC > 1 && kPRegs > 0) regs_alloc<kCRegs>();
    const int c = wg - 1;
    const int lane = threadIdx.x & 31;
    const int k0 = kb0 + 64 * c;
    DkvPairs px;
    px.ka = k0 + 16 * ((threadIdx.x & 127) >> 5) + (lane >> 2);
    px.kl = px.ka - kb0;
    px.cl = 2 * (lane & 3);
    px.Tn = Tn;
    px.causal = op.causal;
    px.window = op.window;
    px.bh = bh;
    px.sm_scale = op.sm_scale;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int kp = px.ka + 8 * r;
      px.kv[r] = OPT && op.kvm && kp < Tn ? op.kvm[(size_t)b * Tn + kp] : 0.f;
    }
    px.seed = op.seed;
    px.thresh = drop_thresh(op.rate);
    px.inv_keep = op.rate > 0.f ? 1.f / (1.f - op.rate) : 1.f;
    px.drop = op.rate > 0.f;
    const bool ds_out = OPT && part != nullptr;
    const Ring<STAGES> ring{bars + 1, bars + 1 + STAGES};
    const uint32_t k_base = smem_addr(sm) + c * 64 * kHalfRow;
    const uint32_t v_base = k_base + Tc::kQ;
    const uint32_t ring0 = smem_addr(sm + Tc::kRing);
    // this consumer's tiles: a contiguous part of the block's (none when
    // its keys start at or past T)
    int ic_begin, ic_end;
    query_range<BQ>(k0, 64, Tn, op.causal, op.window, &ic_begin, &ic_end);
    if (k0 >= Tn) ic_begin = i_end + 1;
    const int it_begin = ic_begin - i_begin;
    const int it_end = min(ic_end, i_end) - i_begin;  // inclusive
    const int n_it = i_end - i_begin + 1;
    for (int it = 0; it < min(it_begin, n_it); ++it) {
      ring.wait(it);
      ring.release(it);
    }

    float dk_acc[HD / 64][32], dv_acc[HD / 64][32];
#pragma unroll
    for (int hh = 0; hh < HD / 64; ++hh)
#pragma unroll
      for (int i = 0; i < 32; ++i) dk_acc[hh][i] = dv_acc[hh][i] = 0.f;

    if (it_begin <= it_end) {
      mbar_wait(bars, 0);
      uint32_t pa[BQ / 16][4], da[BQ / 16][4];
      for (int it = it_begin; it <= it_end; ++it) {
        const int st = it % STAGES;
        const uint32_t q_tile = ring0 + st * 2 * Tc::kKV;
        const uint32_t do_tile = q_tile + Tc::kKV;
        const int q0 = (i_begin + it) * BQ;
        float s[BQ / 2], dp[BQ / 2];
        ring.wait(it);
        wgmma_fence();
        tc_scores<HD, BQ, ROWS>(s, k_base, q_tile);
        tc_scores<HD, BQ, ROWS>(dp, v_base, do_tile);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(s);
        fence_regs(dp);
        if (it > it_begin) {
          fence_acc<HD>(dk_acc);
          fence_acc<HD>(dv_acc);
          fence_operand(pa);
          fence_operand(da);
          ring.release(it - 1);
        }
        const float* rows =
            reinterpret_cast<const float*>(sm + L::kRows) + st * 3 * BQ;
        float* bt = OPT && op.bias ? reinterpret_cast<float*>(
                                         sm + L::kBias + st * L::kBiasStage)
                                   : nullptr;
        bool edge = !interior<64, BQ>(q0, k0, Tn, op.causal, op.window);
        if (OPT && op.qs && !edge) {
          // a tile interior by position is EDGE too where a query's
          // document starts after this consumer's first key
          const int* qsr = reinterpret_cast<const int*>(rows + 2 * BQ);
          int mx = qsr[lane % BQ];
          if (BQ > 32) mx = max(mx, qsr[(lane + 32) % BQ]);
          edge = __reduce_max_sync(0xffffffffu, mx) > k0;
        }
        dkv_grads_any<BQ, OPT>(s, dp, q0, edge, px, rows, bt, ds_out);
        // dS (written into the bias tile) goes out through the stagers,
        // after this stage is released; TMA refills the tile after that
        if (ds_out) fence_proxy_async();
        pack_operand<BQ>(s, pa);
        pack_operand<BQ>(dp, da);
        wgmma_fence();
        tc_accumulate<HD, BQ>(dv_acc, pa, do_tile);
        tc_accumulate<HD, BQ>(dk_acc, da, q_tile);
        wgmma_commit();
      }
      wgmma_wait<0>();
      fence_acc<HD>(dk_acc);
      fence_acc<HD>(dv_acc);
      ring.release(it_end);
    }
    for (int it = max(it_end + 1, it_begin); it < n_it; ++it) {
      ring.wait(it);
      ring.release(it);
    }
    if (k0 < Tn) {
      const size_t rs = (size_t)H * HD;
      const size_t base = (size_t)b * Tn * rs + (size_t)h * HD;
      const float sk[2] = {op.sm_scale, op.sm_scale};
      const float sv[2] = {1.f, 1.f};
      store_rows<HD>(dk_acc, sk, dk + base, rs, px.ka, px.cl, Tn);
      store_rows<HD>(dv_acc, sv, dv + base, rs, px.ka, px.cl, Tn);
    }
  }
}

// dbias[h, q, k] = sum over b of part[b*H + h, q, k] for the pairs
// attended by position, else 0, in the order b = 0, 1, ...  One thread
// per 4 keys of one (h, q) row, 16-byte loads.  Bound by the scratch
// read: B*H*Tp*Tp*4 bytes.
__global__ void __launch_bounds__(128) flash_dbias_reduce_kernel(
    const float* __restrict__ part, float* __restrict__ dbias, int B, int Tn,
    int Tp, int H, int causal, int window) {
  const int k4 = 4 * (blockIdx.x * 128 + threadIdx.x);
  const int qp = blockIdx.y;
  const int h = blockIdx.z;
  if (k4 >= Tn) return;
  bool any = false;
#pragma unroll
  for (int e = 0; e < 4; ++e) any |= attends(qp, k4 + e, Tn, causal, window);
  float a[4] = {0.f, 0.f, 0.f, 0.f};
  if (any) {
    const float* src = part + ((size_t)h * Tp + qp) * Tp + k4;
    const size_t step = (size_t)H * Tp * Tp;
#pragma unroll 4
    for (int b = 0; b < B; ++b) {
      const float4 x = *reinterpret_cast<const float4*>(src + b * step);
      a[0] += x.x;
      a[1] += x.y;
      a[2] += x.z;
      a[3] += x.w;
    }
  }
  float* dst = dbias + ((size_t)h * Tn + qp) * Tn;
#pragma unroll
  for (int e = 0; e < 4; ++e)
    if (k4 + e < Tn)
      dst[k4 + e] = attends(qp, k4 + e, Tn, causal, window) ? a[e] : 0.f;
}

template <typename Kern>
int prepare(Kern kern, size_t smem) {
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  return 0;
}

dim3 grid_of(int B, int Tn, int H) {
  return dim3((Tn + kTile - 1) / kTile, B * H);
}

dim3 grid_tc(int B, int Tn, int H) {
  return dim3((Tn + kRowsTC - 1) / kRowsTC, B * H);
}

// TMA reads 16-byte aligned rows only.
bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

template <int HD>
int fwd_simt(const void* q, const void* k, const void* v, void* o, void* lse,
             int B, int Tn, int H, Opts op, cudaStream_t stream) {
  auto kern = op.bias || op.kvm || op.qs || op.sink
                  ? flash_fwd_kernel<float, HD, true>
                  : flash_fwd_kernel<float, HD, false>;
  const size_t smem = fwd_smem<HD>();
  if (int e = prepare(kern, smem)) return e;
  kern<<<grid_of(B, Tn, H), kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o),
      static_cast<float*>(lse), Tn, H, op);
  return static_cast<int>(cudaGetLastError());
}

template <int HD, int BK, int STAGES>
int fwd_tc(const void* q, const void* k, const void* v, void* o, void* lse,
           int B, int Tn, int H, Opts op, cudaStream_t stream) {
  if (!aligned16(q) || !aligned16(k) || !aligned16(v))
    return static_cast<int>(cudaErrorMisalignedAddress);
  CUtensorMap mq, mk, mv;
  if (int e = bthd_map(&mq, q, B, Tn, H, HD, kRowsTC)) return e;
  if (int e = bthd_map(&mk, k, B, Tn, H, HD, BK)) return e;
  if (int e = bthd_map(&mv, v, B, Tn, H, HD, BK)) return e;
  auto kern = op.bias || op.kvm || op.qs || op.sink || op.rate > 0.f
                  ? flash_fwd_tc_kernel<HD, BK, STAGES, true>
                  : flash_fwd_tc_kernel<HD, BK, STAGES, false>;
  const size_t smem = TcSmem<HD, BK, 1, STAGES>::kBytes;
  if (int e = prepare(kern, smem)) return e;
  kern<<<grid_tc(B, Tn, H), kThreadsTC, smem, stream>>>(
      mq, mk, mv, static_cast<__nv_bfloat16*>(o), static_cast<float*>(lse),
      Tn, H, op);
  return static_cast<int>(cudaGetLastError());
}

template <int HD>
int bwd_dq_simt(const void* q, const void* k, const void* v,
                const void* dout, const void* lse, const void* delta,
                void* dq, int B, int Tn, int H, Opts op,
                cudaStream_t stream) {
  auto kern = op.bias || op.kvm || op.qs
                  ? flash_bwd_dq_kernel<float, HD, true>
                  : flash_bwd_dq_kernel<float, HD, false>;
  const size_t smem = dq_smem<HD>();
  if (int e = prepare(kern, smem)) return e;
  kern<<<grid_of(B, Tn, H), kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<float*>(dq), Tn, H, op);
  return static_cast<int>(cudaGetLastError());
}

template <int HD, int BK, int STAGES>
int bwd_dq_tc(const void* q, const void* k, const void* v, const void* dout,
              const void* lse, const void* delta, void* dq, int B, int Tn,
              int H, Opts op, cudaStream_t stream) {
  if (!aligned16(q) || !aligned16(k) || !aligned16(v) || !aligned16(dout))
    return static_cast<int>(cudaErrorMisalignedAddress);
  CUtensorMap mq, mdo, mk, mv;
  if (int e = bthd_map(&mq, q, B, Tn, H, HD, kRowsTC)) return e;
  if (int e = bthd_map(&mdo, dout, B, Tn, H, HD, kRowsTC)) return e;
  if (int e = bthd_map(&mk, k, B, Tn, H, HD, BK)) return e;
  if (int e = bthd_map(&mv, v, B, Tn, H, HD, BK)) return e;
  auto kern = op.bias || op.kvm || op.qs || op.rate > 0.f
                  ? flash_bwd_dq_tc_kernel<HD, BK, STAGES, true>
                  : flash_bwd_dq_tc_kernel<HD, BK, STAGES, false>;
  const size_t smem = TcSmem<HD, BK, 2, STAGES>::kBytes;
  if (int e = prepare(kern, smem)) return e;
  kern<<<grid_tc(B, Tn, H), kThreadsTC, smem, stream>>>(
      mq, mdo, mk, mv, static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<__nv_bfloat16*>(dq), Tn,
      H, op);
  return static_cast<int>(cudaGetLastError());
}

template <int HD>
int fwd_bf16(const void* q, const void* k, const void* v, void* o, void* lse,
             int B, int Tn, int H, Opts op, cudaStream_t stream) {
  return fwd_tc<HD, kKeyTile, kFwdStages>(q, k, v, o, lse, B, Tn, H, op,
                                          stream);
}

template <int HD>
int bwd_dq_bf16(const void* q, const void* k, const void* v,
                const void* dout, const void* lse, const void* delta,
                void* dq, int B, int Tn, int H, Opts op,
                cudaStream_t stream) {
  return bwd_dq_tc<HD, kKeyTile, kDqStages>(q, k, v, dout, lse, delta, dq, B,
                                            Tn, H, op, stream);
}

template <int HD>
int bwd_dkv_simt(const void* q, const void* k, const void* v,
                 const void* dout, const void* lse, const void* delta,
                 void* dk, void* dv, int B, int Tn, int H, Opts op,
                 cudaStream_t stream) {
  auto kern = op.bias || op.kvm || op.qs
                  ? flash_bwd_dkv_kernel<float, HD, true>
                  : flash_bwd_dkv_kernel<float, HD, false>;
  const size_t smem = dkv_smem<HD>();
  if (int e = prepare(kern, smem)) return e;
  kern<<<grid_of(B, Tn, H), kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<float*>(dk), static_cast<float*>(dv), Tn, H, op);
  return static_cast<int>(cudaGetLastError());
}

template <int HD>
int bwd_dbias_simt(const void* q, const void* k, const void* v,
                   const void* dout, const void* lse, const void* delta,
                   void* dbias, int B, int Tn, int H, Opts op,
                   cudaStream_t stream) {
  auto kern = flash_bwd_dbias_kernel<float, HD>;
  const size_t smem = dbias_smem<HD>();
  if (int e = prepare(kern, smem)) return e;
  const int n = (Tn + kTile - 1) / kTile;
  kern<<<dim3(n, n, H), kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<float*>(dbias), B, Tn, H, op);
  return static_cast<int>(cudaGetLastError());
}

// The rows of K3's dS scratch: T rounded up to K3's 64-row key tiles.
int dbias_rows(int Tn) { return (Tn + 63) / 64 * 64; }

template <int HD, int BQ, int NC, int STAGES>
int bwd_dkv_tc(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* delta, void* dk, void* dv,
               void* part, int B, int Tn, int H, Opts op,
               cudaStream_t stream) {
  if (!aligned16(q) || !aligned16(k) || !aligned16(v) || !aligned16(dout))
    return static_cast<int>(cudaErrorMisalignedAddress);
  CUtensorMap mq, mdo, mk, mv;
  if (int e = bthd_map(&mq, q, B, Tn, H, HD, BQ)) return e;
  if (int e = bthd_map(&mdo, dout, B, Tn, H, HD, BQ)) return e;
  if (int e = bthd_map(&mk, k, B, Tn, H, HD, 64 * NC)) return e;
  if (int e = bthd_map(&mv, v, B, Tn, H, HD, 64 * NC)) return e;
  // the bias tile by TMA where its rows start 16-byte aligned, else by
  // the producer's stagers
  CUtensorMap mb;
  memset(&mb, 0, sizeof(mb));
  const int bias_tma = op.bias && Tn % 4 == 0 && aligned16(op.bias);
  if (bias_tma)
    if (int e = htt_f32_map(&mb, op.bias, H, Tn, BQ)) return e;
  const bool opt = op.bias || op.kvm || op.qs || op.rate > 0.f;
  auto kern = opt ? flash_bwd_dkv_tc_kernel<HD, BQ, NC, STAGES, true>
                  : flash_bwd_dkv_tc_kernel<HD, BQ, NC, STAGES, false>;
  const size_t smem =
      opt ? DkvSmem<HD, BQ, 64 * NC, STAGES, true>::kBytes
          : DkvSmem<HD, BQ, 64 * NC, STAGES, false>::kBytes;
  if (int e = prepare(kern, smem)) return e;
  kern<<<dim3((Tn + 64 * NC - 1) / (64 * NC), B * H), 128 * (NC + 1), smem,
         stream>>>(mq, mdo, mk, mv, mb, bias_tma,
                   static_cast<const float*>(lse),
                   static_cast<const float*>(delta),
                   static_cast<__nv_bfloat16*>(dk),
                   static_cast<__nv_bfloat16*>(dv), static_cast<float*>(part),
                   Tn, dbias_rows(Tn), H, op);
  return static_cast<int>(cudaGetLastError());
}

template <int HD>
int bwd_dkv_bf16(const void* q, const void* k, const void* v,
                 const void* dout, const void* lse, const void* delta,
                 void* dk, void* dv, void* part, int B, int Tn, int H,
                 Opts op, cudaStream_t stream) {
  constexpr bool k64 = HD == 64;
  return bwd_dkv_tc<HD, k64 ? kDkvQTile64 : kDkvQTile128,
                    k64 ? kDkvGroups64 : kDkvGroups128,
                    k64 ? kDkvStages64 : kDkvStages128>(
      q, k, v, dout, lse, delta, dk, dv, part, B, Tn, H, op, stream);
}

int dbias_reduce(const void* part, void* dbias, int B, int Tn, int H,
                 const Opts& op, cudaStream_t stream) {
  const dim3 grid(((Tn + 3) / 4 + 127) / 128, Tn, H);
  flash_dbias_reduce_kernel<<<grid, 128, 0, stream>>>(
      static_cast<const float*>(part), static_cast<float*>(dbias), B, Tn,
      dbias_rows(Tn), H, op.causal, op.window);
  return static_cast<int>(cudaGetLastError());
}

// bf16: K3 writing dS into part, then the batch sum.
template <int HD>
int bwd_dkv_dbias_bf16(const void* q, const void* k, const void* v,
                       const void* dout, const void* lse, const void* delta,
                       void* dk, void* dv, void* dbias, void* part, int B,
                       int Tn, int H, Opts op, cudaStream_t stream) {
  if (int e = bwd_dkv_bf16<HD>(q, k, v, dout, lse, delta, dk, dv, part, B,
                               Tn, H, op, stream))
    return e;
  return dbias_reduce(part, dbias, B, Tn, H, op, stream);
}

// float32: the SIMT K3, then the SIMT K4.
template <int HD>
int bwd_dkv_dbias_simt(const void* q, const void* k, const void* v,
                       const void* dout, const void* lse, const void* delta,
                       void* dk, void* dv, void* dbias, void* part, int B,
                       int Tn, int H, Opts op, cudaStream_t stream) {
  if (int e = bwd_dkv_simt<HD>(q, k, v, dout, lse, delta, dk, dv, B, Tn, H,
                               op, stream))
    return e;
  return bwd_dbias_simt<HD>(q, k, v, dout, lse, delta, dbias, B, Tn, H, op,
                            stream);
}

Opts opts_of(const void* bias, const void* kvm, const void* qs,
             const void* sink, float sm_scale, int causal, int window,
             float rate, int seed) {
  return Opts{static_cast<const float*>(bias), static_cast<const float*>(kvm),
              static_cast<const int*>(qs), static_cast<const float*>(sink),
              sm_scale, causal, window, rate, static_cast<uint32_t>(seed)};
}

// Calls F<HD>(args...) for hd 64 / 128; anything else is
// cudaErrorInvalidValue.
#define NNL_FLASH_HD(F, hd, ...)                    \
  if (hd == 64) return F<64>(__VA_ARGS__);          \
  if (hd == 128) return F<128>(__VA_ARGS__);        \
  return static_cast<int>(cudaErrorInvalidValue)

}  // namespace

extern "C" {

// dtype codes: 0 = float32, 1 = bfloat16; hd 64 or 128.  bias is the
// (H, T, T) float32 logit bias or null, kvm the (B, T) float32 additive key
// mask (0 or -1e30) or null, qs the (B, T) int32 document starts of packed
// rows (causal only) or null, sink the (H) float32 sink logits (forward
// only) or null; causal 0 or 1; window > 0 only when causal.
// seed is the int32 dropout seed (its bits), rate the dropout rate (0 =
// none).  Each returns the cudaError_t of its launch (0 on success).
// K1, K2 and K3 run the tensor-core kernels on bfloat16 (whose q, k, v, do
// must be 16-byte aligned) and the SIMT kernels on float32.
int nnl_flash_fwd(const void* q, const void* k, const void* v,
                  const void* bias, const void* kvm, const void* qs,
                  const void* sink, void* o, void* lse, int B, int Tn, int H,
                  int hd, float sm_scale, int causal, int window, float rate,
                  int seed, int dtype, void* stream) {
  const Opts op =
      opts_of(bias, kvm, qs, sink, sm_scale, causal, window, rate, seed);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    NNL_FLASH_HD(fwd_bf16, hd, q, k, v, o, lse, B, Tn, H, op, st);
  }
  if (dtype == 0) {
    NNL_FLASH_HD(fwd_simt, hd, q, k, v, o, lse, B, Tn, H, op, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

int nnl_flash_bwd_dq(const void* q, const void* k, const void* v,
                     const void* dout, const void* lse, const void* delta,
                     const void* bias, const void* kvm, const void* qs,
                     void* dq, int B, int Tn, int H, int hd, float sm_scale,
                     int causal, int window, float rate, int seed, int dtype,
                     void* stream) {
  const Opts op =
      opts_of(bias, kvm, qs, nullptr, sm_scale, causal, window, rate, seed);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    NNL_FLASH_HD(bwd_dq_bf16, hd, q, k, v, dout, lse, delta, dq, B, Tn, H, op,
                 st);
  }
  if (dtype == 0) {
    NNL_FLASH_HD(bwd_dq_simt, hd, q, k, v, dout, lse, delta, dq, B, Tn, H, op,
                 st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

int nnl_flash_bwd_dkv(const void* q, const void* k, const void* v,
                      const void* dout, const void* lse, const void* delta,
                      const void* bias, const void* kvm, const void* qs,
                      void* dk, void* dv, int B, int Tn, int H, int hd,
                      float sm_scale, int causal, int window, float rate,
                      int seed, int dtype, void* stream) {
  const Opts op =
      opts_of(bias, kvm, qs, nullptr, sm_scale, causal, window, rate, seed);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    NNL_FLASH_HD(bwd_dkv_bf16, hd, q, k, v, dout, lse, delta, dk, dv,
                 nullptr, B, Tn, H, op, st);
  }
  if (dtype == 0) {
    NNL_FLASH_HD(bwd_dkv_simt, hd, q, k, v, dout, lse, delta, dk, dv, B, Tn,
                 H, op, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// K3 and K4 in one call: dk, dv and dbias (H, T, T) float32 = the sum over
// the batch of dS; bias must be given.  bfloat16: K3's pass writes dS into
// part, float32 scratch of B*H*Tp*Tp with Tp = T rounded up to 64, and
// a second kernel sums it over the batch.  float32: the SIMT K3 and K4
// (part unused, may be null).
int nnl_flash_bwd_dkv_dbias(const void* q, const void* k, const void* v,
                            const void* dout, const void* lse,
                            const void* delta, const void* bias,
                            const void* kvm, const void* qs, void* dk,
                            void* dv, void* dbias, void* part, int B, int Tn,
                            int H, int hd, float sm_scale, int causal,
                            int window, float rate, int seed, int dtype,
                            void* stream) {
  if (bias == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const Opts op =
      opts_of(bias, kvm, qs, nullptr, sm_scale, causal, window, rate, seed);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    if (part == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    NNL_FLASH_HD(bwd_dkv_dbias_bf16, hd, q, k, v, dout, lse, delta, dk, dv,
                 dbias, part, B, Tn, H, op, st);
  }
  if (dtype == 0) {
    NNL_FLASH_HD(bwd_dkv_dbias_simt, hd, q, k, v, dout, lse, delta, dk, dv,
                 dbias, part, B, Tn, H, op, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// out[s, bh, i, j] = keep(seeds[s], bh, q0 + i, k0 + j) as 0/1 bytes.
int nnl_flash_drop_keep(const void* seeds, int n_seeds, int n_bh, int n_q,
                        int n_k, int q0, int k0, float rate, void* out,
                        void* stream) {
  const size_t n = (size_t)n_seeds * n_bh * n_q * n_k;
  const int blocks = static_cast<int>(n / 256 + 1 < 4096 ? n / 256 + 1 : 4096);
  drop_keep_kernel<<<blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(seeds), n_seeds, n_bh, n_q, n_k, q0, k0,
      rate, static_cast<uint8_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

const char* nnl_flash_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
