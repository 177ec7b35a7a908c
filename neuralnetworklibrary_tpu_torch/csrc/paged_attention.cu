// Paged decode attention for Hopper (sm_90a), bound to Python with ctypes.
//
// Replaces the TPU kernel neuralnetworklibrary_tpu/ops/paged_attention.py
// `_kernel` (Pallas).  One decode token per slot attends to positions
// 0..off of its sequence, whose K/V rows live in a shared paged pool
// (N, bs, Hkv, hd) and are found through the slot's block table (B, MB).
// The gathered (MB*bs, Hkv, hd) strip that the plain formulation builds is
// never written: each K/V row goes from the pool straight into shared
// memory.
//
// What bounds it: HBM bytes.  A slot reads (off+1)*Hkv*hd K and V elements
// and does about 4*H*hd flops per position, far under the card's ~300
// flops per byte, so the least time is the K/V bytes over 3.35 TB/s.
//
// Design (simple first version):
// - one thread block per (kv head g, slot b).  It serves the G = H/Hkv query
//   heads of that kv head, so each K/V row is read once for all of them;
// - an in-block loop walks positions start..off in chunks of 32 (one per
//   lane in the softmax), so blocks past off // bs are never read and a
//   window starts the walk at off-window+1.  This takes the place of the
//   TPU's sequential (B, MB) grid and its repeated-index DMA skip;
// - the online softmax state (m, l) and the accumulator live in shared
//   memory in f32; K/V are converted to f32 as they are staged.
// Semantics follow the Pallas kernel: q is scaled by sm_scale before the
// dot; int8 k-scales multiply the scores, v-scales multiply p before the PV
// product while l sums the unscaled p; a sink joins only the normalizer,
// folded into the max; the output is acc / max(l, 1e-30) in q's dtype.
// Table entries and offsets are clamped into range, as XLA clamps the
// gather of the TPU version.
//
// Later work: split-K over blocks (flash-decoding) to fill 132 SMs at small
// batch, cp.async/TMA staging, vectorized loads and a tuned block size.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kChunk = 32;  // positions staged per step: one per lane
constexpr float kNegInf = -1e30f;
constexpr size_t kMaxSmem = 232448;  // 227 KB, the most a block may use

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(int8_t x) {
  return static_cast<float>(x);
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

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

size_t smem_bytes(int G, int hd) {
  // q, acc: G*hd; K: kChunk*(hd+1) (padded: the score loop reads columns);
  // V: kChunk*hd; p: G*kChunk; k/v scales: 2*kChunk; m, l, alpha: 3*G
  return sizeof(float) * (2 * (size_t)G * hd + (size_t)kChunk * (hd + 1) +
                          (size_t)kChunk * hd + (size_t)G * kChunk +
                          2 * kChunk + 3 * (size_t)G);
}

template <typename TQ, typename TKV>
__global__ void __launch_bounds__(kThreads) paged_attention_kernel(
    const TQ* __restrict__ q,            // (B, H, hd)
    const TKV* __restrict__ pool_k,      // (N, bs, Hkv, hd)
    const TKV* __restrict__ pool_v,      // (N, bs, Hkv, hd)
    const float* __restrict__ k_scale,   // (N, bs, Hkv) or null
    const float* __restrict__ v_scale,   // (N, bs, Hkv) or null
    const float* __restrict__ sink,      // (H,) or null
    const int32_t* __restrict__ table,   // (B, MB)
    const int32_t* __restrict__ offsets, // (B,)
    TQ* __restrict__ out,                // (B, H, hd)
    int H, int Hkv, int hd, int N, int bs, int MB, float sm_scale,
    int window) {
  extern __shared__ float smem[];
  const int g = blockIdx.x;
  const int b = blockIdx.y;
  const int G = H / Hkv;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  constexpr int nwarps = kThreads / 32;
  const int kst = hd + 1;

  float* q_s = smem;
  float* acc = q_s + G * hd;
  float* k_s = acc + G * hd;
  float* v_s = k_s + kChunk * kst;
  float* p_s = v_s + kChunk * hd;
  float* ksc = p_s + G * kChunk;
  float* vsc = ksc + kChunk;
  float* m_s = vsc + kChunk;
  float* l_s = m_s + G;
  float* a_s = l_s + G;

  const int max_pos = MB * bs - 1;
  int off = offsets[b];
  off = off < 0 ? 0 : (off > max_pos ? max_pos : off);
  const int start = window > 0 ? max(0, off - window + 1) : 0;
  const int32_t* trow = table + (size_t)b * MB;
  const bool quant = k_scale != nullptr;

  for (int i = tid; i < G * hd; i += kThreads) {
    const int gi = i / hd;
    const int d = i - gi * hd;
    q_s[i] = to_f32(q[((size_t)b * H + g * G + gi) * hd + d]) * sm_scale;
    acc[i] = 0.f;
  }
  for (int i = tid; i < G; i += kThreads) {
    m_s[i] = kNegInf;
    l_s[i] = 0.f;
  }

  for (int p0 = start; p0 <= off; p0 += kChunk) {
    const int n = min(kChunk, off - p0 + 1);
    // stage the chunk's K and V rows; neighbouring threads read
    // neighbouring elements of one row
    for (int i = tid; i < n * hd; i += kThreads) {
      const int t = i / hd;
      const int d = i - t * hd;
      const int pos = p0 + t;
      int row = trow[pos / bs];
      row = row < 0 ? 0 : (row >= N ? N - 1 : row);
      const size_t at = (((size_t)row * bs + pos % bs) * Hkv + g) * hd + d;
      k_s[t * kst + d] = to_f32(pool_k[at]);
      v_s[t * hd + d] = to_f32(pool_v[at]);
    }
    if (quant) {
      for (int t = tid; t < n; t += kThreads) {
        const int pos = p0 + t;
        int row = trow[pos / bs];
        row = row < 0 ? 0 : (row >= N ? N - 1 : row);
        const size_t at = ((size_t)row * bs + pos % bs) * Hkv + g;
        ksc[t] = k_scale[at];
        vsc[t] = v_scale[at];
      }
    }
    __syncthreads();
    // scores: one (head, position) pair per thread
    for (int i = tid; i < G * kChunk; i += kThreads) {
      const int gi = i / kChunk;
      const int t = i - gi * kChunk;
      float s = kNegInf;
      if (t < n) {
        const float* qr = q_s + gi * hd;
        const float* kr = k_s + t * kst;
        float dot = 0.f;
        for (int d = 0; d < hd; ++d) dot = fmaf(qr[d], kr[d], dot);
        s = quant ? dot * ksc[t] : dot;
      }
      p_s[i] = s;
    }
    __syncthreads();
    // online softmax: one warp per head, one lane per position
    for (int gi = warp; gi < G; gi += nwarps) {
      const bool valid = lane < n;
      const float s = p_s[gi * kChunk + lane];
      const float m_old = m_s[gi];
      const float m_new = fmaxf(m_old, warp_max(valid ? s : kNegInf));
      const float p = valid ? expf(s - m_new) : 0.f;
      const float alpha = expf(m_old - m_new);
      const float psum = warp_sum(p);
      p_s[gi * kChunk + lane] = (valid && quant) ? p * vsc[lane] : p;
      __syncwarp();
      if (lane == 0) {
        m_s[gi] = m_new;
        l_s[gi] = alpha * l_s[gi] + psum;
        a_s[gi] = alpha;
      }
    }
    __syncthreads();
    // acc = acc * alpha + p @ V
    for (int i = tid; i < G * hd; i += kThreads) {
      const int gi = i / hd;
      const int d = i - gi * hd;
      const float* pr = p_s + gi * kChunk;
      float a = acc[i] * a_s[gi];
      for (int t = 0; t < n; ++t) a = fmaf(pr[t], v_s[t * hd + d], a);
      acc[i] = a;
    }
    __syncthreads();
  }

  for (int i = tid; i < G * hd; i += kThreads) {
    const int gi = i / hd;
    const int d = i - gi * hd;
    float a = acc[i];
    float l = l_s[gi];
    if (sink != nullptr) {
      const float m = m_s[gi];
      const float sk = sink[g * G + gi];
      const float mt = fmaxf(m, sk);
      const float sc = expf(m - mt);
      l = l * sc + expf(sk - mt);
      a *= sc;
    }
    out[((size_t)b * H + g * G + gi) * hd + d] =
        from_f32<TQ>(a / fmaxf(l, 1e-30f));
  }
}

template <typename TQ, typename TKV>
int launch(const void* q, const void* pool_k, const void* pool_v,
           const void* k_scale, const void* v_scale, const void* sink,
           const void* table, const void* offsets, void* out, int B, int H,
           int Hkv, int hd, int N, int bs, int MB, float sm_scale,
           int window, cudaStream_t stream) {
  const size_t smem = smem_bytes(H / Hkv, hd);
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  auto kern = paged_attention_kernel<TQ, TKV>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kern<<<dim3(Hkv, B), kThreads, smem, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(pool_k),
      static_cast<const TKV*>(pool_v), static_cast<const float*>(k_scale),
      static_cast<const float*>(v_scale), static_cast<const float*>(sink),
      static_cast<const int32_t*>(table),
      static_cast<const int32_t*>(offsets), static_cast<TQ*>(out), H, Hkv,
      hd, N, bs, MB, sm_scale, window);
  return static_cast<int>(cudaGetLastError());
}

template <typename TQ>
int launch_kv(int kv_dtype, const void* q, const void* pool_k,
              const void* pool_v, const void* k_scale, const void* v_scale,
              const void* sink, const void* table, const void* offsets,
              void* out, int B, int H, int Hkv, int hd, int N, int bs,
              int MB, float sm_scale, int window, cudaStream_t stream) {
  switch (kv_dtype) {
    case 0:
      return launch<TQ, float>(q, pool_k, pool_v, k_scale, v_scale, sink,
                               table, offsets, out, B, H, Hkv, hd, N, bs, MB,
                               sm_scale, window, stream);
    case 1:
      return launch<TQ, __nv_bfloat16>(q, pool_k, pool_v, k_scale, v_scale,
                                       sink, table, offsets, out, B, H, Hkv,
                                       hd, N, bs, MB, sm_scale, window,
                                       stream);
    case 2:
      return launch<TQ, int8_t>(q, pool_k, pool_v, k_scale, v_scale, sink,
                                table, offsets, out, B, H, Hkv, hd, N, bs,
                                MB, sm_scale, window, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// dtype codes: 0 = float32, 1 = bfloat16, 2 = int8 (pools only).
// Returns the cudaError_t of the launch (0 on success).
int nnl_paged_attention(const void* q, const void* pool_k,
                        const void* pool_v, const void* k_scale,
                        const void* v_scale, const void* sink,
                        const void* table, const void* offsets, void* out,
                        int B, int H, int Hkv, int hd, int N, int bs, int MB,
                        float sm_scale, int window, int q_dtype,
                        int kv_dtype, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (q_dtype == 0)
    return launch_kv<float>(kv_dtype, q, pool_k, pool_v, k_scale, v_scale,
                            sink, table, offsets, out, B, H, Hkv, hd, N, bs,
                            MB, sm_scale, window, s);
  if (q_dtype == 1)
    return launch_kv<__nv_bfloat16>(kv_dtype, q, pool_k, pool_v, k_scale,
                                    v_scale, sink, table, offsets, out, B, H,
                                    Hkv, hd, N, bs, MB, sm_scale, window, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Dynamic shared memory one block needs for G query heads per kv head.
size_t nnl_paged_attention_smem_bytes(int G, int hd) {
  return smem_bytes(G, hd);
}

const char* nnl_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
