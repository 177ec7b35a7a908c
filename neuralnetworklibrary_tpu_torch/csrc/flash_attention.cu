// Flash attention, forward and backward, for Hopper (sm_90a), bound to
// Python with ctypes.
//
// Replaces the four TPU kernels of
// neuralnetworklibrary_tpu/ops/flash_attention.py (Pallas):
//   flash_fwd_kernel       <- _fwd_kernel       (K1): o and the row logsumexp
//   flash_bwd_dq_kernel    <- _bwd_dq_kernel    (K2): dq by a loop over key
//                                                     tiles
//   flash_bwd_dkv_kernel   <- _bwd_dkv_kernel   (K3): dk, dv by a loop over
//                                                     query tiles
//   flash_bwd_dbias_kernel <- _bwd_dbias_kernel (K4): dbias = sum over the
//                                                     batch of dS
// The (T, T) score matrix is never written: each block holds one 64-row
// tile of its own side and streams 64-row tiles of the other side through
// shared memory, with the online softmax (m, l) in the forward and
// p = exp(s - lse) recomputed from the saved logsumexp in the backward.
// delta = rowsum(dO * O) is computed outside, as the JAX package does.
//
// Options, as in the Pallas kernels: causal or bidirectional (causal = 0:
// every key tile of every row); a causal window; a batch-shared float32
// logit bias (H, T, T) added to the scaled score (T5's relative
// positions); a key mask entered ADDITIVELY as a (B, T) float32 row of
// 0 / -1e30, so a row whose keys are all masked attends uniformly over the
// keys its position sees, as the JAX package's rule is; in-kernel dropout.
//
// Layout: q, k, v, o, do, dq, dk, dv are (B, T, H, hd) row-major, so a row
// of one head is hd contiguous elements and rows are H*hd apart; lse and
// delta are (B*H, T) float32; bias and dbias (H, T, T) float32; the key
// mask (B, T) float32.  The flat index bh = b*H + h is the JAX kernels'
// program_id(0), and the dropout hash takes it as its batch index.
//
// What bounds it: at the training shape (T 1024, hd 64) the causal work is
// about 4*T*T/2*hd flops per head against (4 or 8)*T*hd elements moved, far
// above the card's ~300 flops per byte, so the tensor cores' rate bounds it.
// This first version does not reach them: it multiplies in float32 on the
// CUDA cores from shared memory, so shared-memory loads bound it instead.
// K4 does 4*hd flops per (query, key) pair per batch row against the bias
// read and the dbias write, (H, T, T) float32 each: tensor-core bound too.
//
// Design (simple first version):
// - one block of 256 threads per (tile of 64 rows, bh).  Thread (ty, tx) of
//   a 16 x 16 grid owns rows ty*4 .. ty*4+3 and columns tx, tx+16, ...,
//   so every tile product is the same register-blocked loop (mma_tile);
// - tiles sit in shared memory as float32 [row][d] with a row stride of
//   hd+1 (and 65 for the 64 x 64 probability tiles).  That stride is 1 mod
//   32, so every read of the products below is free of bank conflicts;
// - causal tiles above the diagonal are skipped by the loop bounds, and a
//   window starts (K1, K2) or ends (K3) the loop at its band, as first_j and
//   n_q do in the Pallas kernels; rows at or past T are masked, so T needs
//   no padding;
// - K4 runs one block per (key tile, query tile, head) and loops over the
//   batch inside the block, summing one 64 x 64 float32 tile in registers
//   and writing it once: no atomics (the result is deterministic) and no
//   zeroing pass.  A tile the causal band skips is written as 0.  The TPU
//   kernel instead accumulates across a sequential batch grid axis, which
//   blocks that run in no order cannot do;
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
// Later work: bf16 tiles into wgmma (or mma.sync) with TMA staging, which
// is what the tensor-core bound asks for; native GQA (read Hkv heads);
// q_start and sink.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 64;               // rows of every tile
constexpr int kPs = kTile + 1;          // row stride of a 64 x 64 tile
constexpr float kNegInf = -1e30f;
constexpr size_t kMaxSmem = 232448;     // 227 KB, the most a block may use

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// The keep decision of _drop_keep (flash_attention.py:84) for one
// (seed, bh, query position, key position).
__device__ __forceinline__ bool drop_keep(uint32_t seed, uint32_t bh,
                                          uint32_t q, uint32_t k,
                                          float rate) {
  uint32_t x = (q * 2654435769u) ^ (k * 40503u) ^ (bh * 97531u) ^ seed;
  x ^= x >> 16;
  x *= 2246822507u;  // int32 -2048144789
  x ^= x >> 13;
  x *= 3266489909u;  // int32 -1028477387
  x ^= x >> 16;
  const float u = static_cast<float>(x & 0xFFFFFFu) * (1.0f / 16777216.0f);
  return u >= rate;
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
// the score instead).  window > 0 only with causal.
__device__ __forceinline__ bool attends(int qp, int kp, int Tn, int causal,
                                        int window) {
  if (qp >= Tn || kp >= Tn) return false;
  return !causal || (kp <= qp && (window <= 0 || qp - kp < window));
}

// The number of keys query qp sees by position (n of a fully masked row).
__device__ __forceinline__ float n_attended(int qp, int Tn, int causal,
                                            int window) {
  if (!causal) return static_cast<float>(Tn);
  return static_cast<float>(window > 0 ? min(qp + 1, window) : qp + 1);
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
// twice: OPT = false when there is neither a bias nor a key mask, so the
// plain causal path (GPT-2 training) keeps its registers and arithmetic.
struct Opts {
  const float* bias;  // (H, T, T) or null
  const float* kvm;   // (B, T) additive key mask or null
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

  load_tile<T, HD>(q_s, q + base, q0, Tn, rs, op.sm_scale);
  float acc[4][NB];
  float m[4], l[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
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
        keep[c] = attends(qp, kp, Tn, op.causal, op.window);
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
    const float inv_l = l[r] > 0.f ? 1.f / l[r] : 0.f;
    T* orow = o + base + (size_t)qp * rs;
#pragma unroll
    for (int d = 0; d < NB; ++d)
      orow[tx + 16 * d] = from_f32<T>(acc[r][d] * inv_l);
    if (tx == 0) lse[(size_t)bh * Tn + qp] = m[r] + logf(l[r]);
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

  load_tile<T, HD>(q_s, q + base, q0, Tn, rs);
  load_tile<T, HD>(do_s, dout + base, q0, Tn, rs);
  load_rows(lse_s, lse + (size_t)bh * Tn, q0, Tn);
  load_rows(dl_s, delta + (size_t)bh * Tn, q0, Tn);
  float acc[4][NB] = {};
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
          OPT ? 1.f / n_attended(qp, Tn, op.causal, op.window) : 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int kp = k0 + tx + 16 * c;
        const bool keep = attends(qp, kp, Tn, op.causal, op.window);
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
      const float inv_n =
          OPT ? 1.f / n_attended(qp, Tn, op.causal, op.window) : 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int kp = k0 + tx + 16 * c;
        const bool keep = attends(qp, kp, Tn, op.causal, op.window);
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
  float inv_n[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int qp = q0 + ty * 4 + r;
    inv_n[r] = 1.f / n_attended(qp, Tn, op.causal, op.window);
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
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int kp = k0 + tx + 16 * c;
        const bool keep = attends(qp, kp, Tn, op.causal, op.window);
        float sc = s[r][c] * op.sm_scale + bias_r[r][c];
        bool kv_ok = true;
        if (kvm_b && keep) {
          sc += kvm_b[kp];
          kv_ok = kvm_b[kp] == 0.f;
        }
        float g = dp[r][c];
        if (op.rate > 0.f)
          g *= drop_keep(op.seed, bh, qp, kp, op.rate) ? inv_keep : 0.f;
        acc[r][c] += pair_grad<true>(keep, kv_ok, sc, lse_s[row], inv_n[r],
                                     g, dl_s[row]).ds;
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

template <typename T, int HD>
int fwd(const void* q, const void* k, const void* v, void* o, void* lse,
        int B, int Tn, int H, Opts op, cudaStream_t stream) {
  auto kern = op.bias || op.kvm ? flash_fwd_kernel<T, HD, true>
                                 : flash_fwd_kernel<T, HD, false>;
  const size_t smem = fwd_smem<HD>();
  if (int e = prepare(kern, smem)) return e;
  kern<<<grid_of(B, Tn, H), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), static_cast<float*>(lse),
      Tn, H, op);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int HD>
int bwd_dq(const void* q, const void* k, const void* v, const void* dout,
           const void* lse, const void* delta, void* dq, int B, int Tn,
           int H, Opts op, cudaStream_t stream) {
  auto kern = op.bias || op.kvm ? flash_bwd_dq_kernel<T, HD, true>
                                 : flash_bwd_dq_kernel<T, HD, false>;
  const size_t smem = dq_smem<HD>();
  if (int e = prepare(kern, smem)) return e;
  kern<<<grid_of(B, Tn, H), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dq), Tn, H, op);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int HD>
int bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
            const void* lse, const void* delta, void* dk, void* dv, int B,
            int Tn, int H, Opts op, cudaStream_t stream) {
  auto kern = op.bias || op.kvm ? flash_bwd_dkv_kernel<T, HD, true>
                                 : flash_bwd_dkv_kernel<T, HD, false>;
  const size_t smem = dkv_smem<HD>();
  if (int e = prepare(kern, smem)) return e;
  kern<<<grid_of(B, Tn, H), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dk), static_cast<T*>(dv), Tn, H, op);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int HD>
int bwd_dbias(const void* q, const void* k, const void* v, const void* dout,
              const void* lse, const void* delta, void* dbias, int B, int Tn,
              int H, Opts op, cudaStream_t stream) {
  if (op.bias == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  auto kern = flash_bwd_dbias_kernel<T, HD>;
  const size_t smem = dbias_smem<HD>();
  if (int e = prepare(kern, smem)) return e;
  const int n = (Tn + kTile - 1) / kTile;
  kern<<<dim3(n, n, H), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<float*>(dbias), B, Tn, H, op);
  return static_cast<int>(cudaGetLastError());
}

Opts opts_of(const void* bias, const void* kvm, float sm_scale, int causal,
             int window, float rate, int seed) {
  return Opts{static_cast<const float*>(bias), static_cast<const float*>(kvm),
              sm_scale, causal, window, rate, static_cast<uint32_t>(seed)};
}

// Calls F<T, HD>(args...) for dtype code 0 (float32) / 1 (bfloat16) and
// hd 64 / 128; anything else is cudaErrorInvalidValue.
#define NNL_FLASH_DISPATCH(F, dtype, hd, ...)                        \
  if (dtype == 0 && hd == 64) return F<float, 64>(__VA_ARGS__);      \
  if (dtype == 0 && hd == 128) return F<float, 128>(__VA_ARGS__);    \
  if (dtype == 1 && hd == 64) return F<__nv_bfloat16, 64>(__VA_ARGS__); \
  if (dtype == 1 && hd == 128)                                       \
    return F<__nv_bfloat16, 128>(__VA_ARGS__);                       \
  return static_cast<int>(cudaErrorInvalidValue)

}  // namespace

extern "C" {

// dtype codes: 0 = float32, 1 = bfloat16; hd 64 or 128.  bias is the
// (H, T, T) float32 logit bias or null, kvm the (B, T) float32 additive key
// mask (0 or -1e30) or null; causal 0 or 1; window > 0 only when causal.
// seed is the int32 dropout seed (its bits), rate the dropout rate (0 =
// none).  Each returns the cudaError_t of its launch (0 on success).
int nnl_flash_fwd(const void* q, const void* k, const void* v,
                  const void* bias, const void* kvm, void* o, void* lse,
                  int B, int Tn, int H, int hd, float sm_scale, int causal,
                  int window, float rate, int seed, int dtype, void* stream) {
  const Opts op = opts_of(bias, kvm, sm_scale, causal, window, rate, seed);
  NNL_FLASH_DISPATCH(fwd, dtype, hd, q, k, v, o, lse, B, Tn, H, op,
                     static_cast<cudaStream_t>(stream));
}

int nnl_flash_bwd_dq(const void* q, const void* k, const void* v,
                     const void* dout, const void* lse, const void* delta,
                     const void* bias, const void* kvm, void* dq, int B,
                     int Tn, int H, int hd, float sm_scale, int causal,
                     int window, float rate, int seed, int dtype,
                     void* stream) {
  const Opts op = opts_of(bias, kvm, sm_scale, causal, window, rate, seed);
  NNL_FLASH_DISPATCH(bwd_dq, dtype, hd, q, k, v, dout, lse, delta, dq, B, Tn,
                     H, op, static_cast<cudaStream_t>(stream));
}

int nnl_flash_bwd_dkv(const void* q, const void* k, const void* v,
                      const void* dout, const void* lse, const void* delta,
                      const void* bias, const void* kvm, void* dk, void* dv,
                      int B, int Tn, int H, int hd, float sm_scale,
                      int causal, int window, float rate, int seed,
                      int dtype, void* stream) {
  const Opts op = opts_of(bias, kvm, sm_scale, causal, window, rate, seed);
  NNL_FLASH_DISPATCH(bwd_dkv, dtype, hd, q, k, v, dout, lse, delta, dk, dv,
                     B, Tn, H, op, static_cast<cudaStream_t>(stream));
}

// dbias (H, T, T) float32; bias must be given.
int nnl_flash_bwd_dbias(const void* q, const void* k, const void* v,
                        const void* dout, const void* lse, const void* delta,
                        const void* bias, const void* kvm, void* dbias, int B,
                        int Tn, int H, int hd, float sm_scale, int causal,
                        int window, float rate, int seed, int dtype,
                        void* stream) {
  const Opts op = opts_of(bias, kvm, sm_scale, causal, window, rate, seed);
  NNL_FLASH_DISPATCH(bwd_dbias, dtype, hd, q, k, v, dout, lse, delta, dbias,
                     B, Tn, H, op, static_cast<cudaStream_t>(stream));
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
