// The cross-entropy of each row of a logit matrix, and its gradient, bound
// to Python with ctypes (ops/cross_entropy.py).
//
// Replaces no TPU kernel: the JAX package leaves its loss to XLA, which
// fuses the log-softmax, the gather of the target and their backward into
// passes over the logits.  The port's PyTorch chain took about ten float32
// passes over an LM's (N, V) logits (a float32 copy, the log-softmax and
// its saved output, a zero-filled gather gradient, the softmax backward,
// the cast back) and held two or three float32 (N, V) tensors at once.
//
// For a row x of V logits (float32 or bf16, read in float32) and target t:
//   forward:   lse = max + log(sum_c exp(x_c - max));  nll = lse - x_t
//   backward:  dx_c = exp(x_c - lse) * d - [c == t] * d,  d = dnll[row]
// written once in the logits' dtype (rounded to nearest even), in the
// float32 arithmetic of PyTorch's log-softmax and its backward.  d is the
// upstream gradient of the row's nll, read from device memory, so the
// weighting of the loss that calls it (a row mask, pad targets, the mean's
// divisor) costs nothing here and needs no value on the host.  A target
// outside [0, V) gives a NaN nll.
//
// What bounds it: HBM bytes.  The forward reads each logit once; the
// backward reads it again and writes its gradient once: 3 N V element
// sizes in all, with ~10 instructions an element, far under the card's
// ridge, so the least time is those bytes over 3.35 TB/s.
//
// Design:
// - one block of 256 threads a row (the LM cells have 16,384-65,536 rows
//   of 24,576-151,936 logits, so many waves of blocks); rows are ld
//   elements apart, so a view of padded rows (ops/padded_head.py) is read
//   in place, and the gradient is written with its own row stride.
// - threads read 16-byte vectors (8 bf16, 4 float32), neighbouring
//   threads on neighbouring vectors, four vectors in flight a thread, with
//   cache-streaming loads and stores (the row is not read again soon);
//   a row's first elements up to a 16-byte boundary and its ragged end
//   (odd V, such as GPT-2's 50,257) go element by element.
// - the forward keeps each thread's running max and sum of exponentials
//   (rescaled when the max grows, once a vector), then merges the threads'
//   pairs by warp shuffles and one exchange through shared memory.  The
//   order of every sum is fixed by the row's length and alignment, so the
//   loss and the gradient are deterministic.
// - expf and logf as nvcc compiles them by default (no fast math).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;          // vectors in flight a thread

// 16 bytes of logits as float32, and back, for each dtype
struct F32 {
  using T = float;
  static constexpr int kVec = 4;
  __device__ static float get(const T* p) { return *p; }
  __device__ static void put(T* p, float v) { *p = v; }
  __device__ static void unpack(const uint4& r, float (&x)[kVec]) {
    x[0] = __uint_as_float(r.x);
    x[1] = __uint_as_float(r.y);
    x[2] = __uint_as_float(r.z);
    x[3] = __uint_as_float(r.w);
  }
  __device__ static uint4 pack(const float (&x)[kVec]) {
    return make_uint4(__float_as_uint(x[0]), __float_as_uint(x[1]),
                      __float_as_uint(x[2]), __float_as_uint(x[3]));
  }
};

struct Bf16 {
  using T = __nv_bfloat16;
  static constexpr int kVec = 8;
  __device__ static float get(const T* p) { return __bfloat162float(*p); }
  __device__ static void put(T* p, float v) { *p = __float2bfloat16_rn(v); }
  // a bf16 is the high half of its float32
  __device__ static void unpack(const uint4& r, float (&x)[kVec]) {
    const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      x[2 * i] = __uint_as_float(w[i] << 16);
      x[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
  __device__ static uint4 pack(const float (&x)[kVec]) {
    union {
      __nv_bfloat162 b;
      uint32_t u;
    } w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      w[i].b = __floats2bfloat162_rn(x[2 * i], x[2 * i + 1]);
    return make_uint4(w[0].u, w[1].u, w[2].u, w[3].u);
  }
};

// a thread's running max and sum of exp(x - max) over its logits
struct Run {
  float m, s;
};

template <int K>
__device__ __forceinline__ void add(Run& r, const float (&x)[K]) {
  float vm = x[0];
#pragma unroll
  for (int k = 1; k < K; ++k) vm = fmaxf(vm, x[k]);
  if (vm == -INFINITY) return;      // all -inf: nothing to add
  if (vm > r.m) {
    r.s *= expf(r.m - vm);          // 0 while r.m is -inf
    r.m = vm;
  }
#pragma unroll
  for (int k = 0; k < K; ++k) r.s += expf(x[k] - r.m);
}

__device__ __forceinline__ Run merge(const Run& a, const Run& b) {
  const float m = fmaxf(a.m, b.m);
  if (m == -INFINITY) return a;     // both empty
  return {m, a.s * expf(a.m - m) + b.s * expf(b.m - m)};
}

// elements before the row's first 16-byte boundary (at most V)
template <class L>
__device__ __forceinline__ int head_of(const typename L::T* row, int V) {
  const int h = static_cast<int>(
      ((16 - (reinterpret_cast<uintptr_t>(row) & 15)) & 15) /
      sizeof(typename L::T));
  return h < V ? h : V;
}

template <class L>
__global__ void __launch_bounds__(kThreads)
    ce_fwd_kernel(const typename L::T* __restrict__ x, int V, int64_t ld,
                  const int64_t* __restrict__ target,
                  float* __restrict__ lse, float* __restrict__ nll) {
  using T = typename L::T;
  constexpr int kVec = L::kVec;
  const int64_t row = blockIdx.x;
  const T* xr = x + row * ld;
  // the target's logit, fetched first so its load overlaps the row's
  float xt = 0.f;
  if (threadIdx.x == 0) {
    const int64_t t = target[row];
    xt = (t >= 0 && t < V) ? L::get(xr + t) : NAN;
  }
  Run run{-INFINITY, 0.f};
  const int head = head_of<L>(xr, V);
  const int nvec = (V - head) / kVec;
  for (int j = threadIdx.x; j < head; j += kThreads) {
    const float v[1] = {L::get(xr + j)};
    add(run, v);
  }
  const uint4* xv = reinterpret_cast<const uint4*>(xr + head);
  int i = threadIdx.x;
  for (; i + (kUnroll - 1) * kThreads < nvec; i += kUnroll * kThreads) {
    uint4 r[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) r[u] = __ldcs(xv + i + u * kThreads);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      float v[kVec];
      L::unpack(r[u], v);
      add(run, v);
    }
  }
  for (; i < nvec; i += kThreads) {
    float v[kVec];
    L::unpack(__ldcs(xv + i), v);
    add(run, v);
  }
  for (int j = head + nvec * kVec + threadIdx.x; j < V; j += kThreads) {
    const float v[1] = {L::get(xr + j)};
    add(run, v);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const Run other{__shfl_xor_sync(0xffffffffu, run.m, o),
                    __shfl_xor_sync(0xffffffffu, run.s, o)};
    run = merge(run, other);
  }
  __shared__ Run part[kWarps];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) part[warp] = run;
  __syncthreads();
  if (threadIdx.x == 0) {
    Run all = part[0];
    for (int w = 1; w < kWarps; ++w) all = merge(all, part[w]);
    const float l = all.m + logf(all.s);
    lse[row] = l;
    nll[row] = l - xt;
  }
}

template <class L>
__global__ void __launch_bounds__(kThreads)
    ce_bwd_kernel(const typename L::T* __restrict__ x, int V, int64_t ld,
                  const int64_t* __restrict__ target,
                  const float* __restrict__ lse,
                  const float* __restrict__ dnll,
                  typename L::T* __restrict__ dx, int64_t ldd) {
  using T = typename L::T;
  constexpr int kVec = L::kVec;
  const int64_t row = blockIdx.x;
  const T* xr = x + row * ld;
  T* dr = dx + row * ldd;
  const float d = dnll[row];
  const float l = lse[row];
  const int64_t t64 = target[row];
  const int t = (t64 >= 0 && t64 < V) ? static_cast<int>(t64) : -1;
  // dx_c of logit v at column c
  auto grad = [&](float v, int c) {
    return expf(v - l) * d - (c == t ? d : 0.f);
  };
  // the vectors line up only where both rows sit alike to 16 bytes
  const bool vec = ((reinterpret_cast<uintptr_t>(xr) ^
                     reinterpret_cast<uintptr_t>(dr)) & 15) == 0;
  const int head = vec ? head_of<L>(xr, V) : V;
  const int nvec = (V - head) / kVec;
  for (int j = threadIdx.x; j < head; j += kThreads)
    L::put(dr + j, grad(L::get(xr + j), j));
  const uint4* xv = reinterpret_cast<const uint4*>(xr + head);
  uint4* dv = reinterpret_cast<uint4*>(dr + head);
  int i = threadIdx.x;
  for (; i + (kUnroll - 1) * kThreads < nvec; i += kUnroll * kThreads) {
    uint4 r[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) r[u] = __ldcs(xv + i + u * kThreads);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      float v[kVec];
      L::unpack(r[u], v);
      const int c0 = head + (i + u * kThreads) * kVec;
#pragma unroll
      for (int k = 0; k < kVec; ++k) v[k] = grad(v[k], c0 + k);
      __stcs(dv + i + u * kThreads, L::pack(v));
    }
  }
  for (; i < nvec; i += kThreads) {
    float v[kVec];
    L::unpack(__ldcs(xv + i), v);
    const int c0 = head + i * kVec;
#pragma unroll
    for (int k = 0; k < kVec; ++k) v[k] = grad(v[k], c0 + k);
    __stcs(dv + i, L::pack(v));
  }
  for (int j = head + nvec * kVec + threadIdx.x; j < V; j += kThreads)
    L::put(dr + j, grad(L::get(xr + j), j));
}

constexpr int kF32 = 0, kBf16 = 1;  // ops/cross_entropy.py DTYPES

int check(int dtype, int n, int v, int ld) {
  if ((dtype != kF32 && dtype != kBf16) || n < 0 || v < 1 || ld < v)
    return static_cast<int>(cudaErrorInvalidValue);
  return 0;
}

}  // namespace

extern "C" {

// lse and nll (float32, n each) of the n rows of v logits, ld elements
// apart, at x (dtype 0: float32, 1: bf16), against int64 targets; on
// `stream`, the current device's.  Returns the cudaError_t of the launch
// (0 on success).
int nnl_cross_entropy_fwd(const void* x, int dtype, int n, int v, int ld,
                          const void* target, void* lse, void* nll,
                          void* stream) {
  const int err = check(dtype, n, v, ld);
  if (err != 0 || n == 0) return err;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* t = static_cast<const int64_t*>(target);
  auto* l = static_cast<float*>(lse);
  auto* o = static_cast<float*>(nll);
  if (dtype == kBf16)
    ce_fwd_kernel<Bf16><<<n, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), v, ld, t, l, o);
  else
    ce_fwd_kernel<F32><<<n, kThreads, 0, s>>>(
        static_cast<const float*>(x), v, ld, t, l, o);
  return static_cast<int>(cudaGetLastError());
}

// dx (x's dtype; rows ldd elements apart, their first v written) of the
// rows' nll from the forward's lse and the upstream float32 dnll.
int nnl_cross_entropy_bwd(const void* x, int dtype, int n, int v, int ld,
                          const void* target, const void* lse,
                          const void* dnll, void* dx, int ldd,
                          void* stream) {
  int err = check(dtype, n, v, ld);
  if (err == 0 && ldd < v) err = static_cast<int>(cudaErrorInvalidValue);
  if (err != 0 || n == 0) return err;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* t = static_cast<const int64_t*>(target);
  const auto* l = static_cast<const float*>(lse);
  const auto* d = static_cast<const float*>(dnll);
  if (dtype == kBf16)
    ce_bwd_kernel<Bf16><<<n, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), v, ld, t, l, d,
        static_cast<__nv_bfloat16*>(dx), ldd);
  else
    ce_bwd_kernel<F32><<<n, kThreads, 0, s>>>(
        static_cast<const float*>(x), v, ld, t, l, d,
        static_cast<float*>(dx), ldd);
  return static_cast<int>(cudaGetLastError());
}

const char* nnl_cross_entropy_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
