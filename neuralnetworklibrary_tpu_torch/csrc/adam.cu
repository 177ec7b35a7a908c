// One Adam step over a list of float32 tensors, bound to Python with ctypes.
//
// Replaces no TPU kernel: the JAX package leaves its optimizer to XLA,
// which fuses each leaf's update into one pass.  The port's foreach chain
// (core/optim.py) runs ten passes over the state and allocates two
// temporaries the size of the trained elements; this kernel is the one
// pass XLA makes, written by hand.
//
// Per element, in the order and float32 arithmetic of the foreach chain
// and of the JAX optimizer (decoupled decay, then the clip, then the step):
//   p <- p * decay;  g' = g * scale;
//   m <- b1 m + (1 - b1) g';  v <- b2 v + (1 - b2) g'^2;
//   p <- p - lr (m / bc1) / (sqrt(v / bc2) + eps).
// Every scalar comes from the host in float32, as the foreach chain takes
// it (bc1, bc2 from the step count); scale is a device scalar (the global
// norm clip's, read once by each block) or null for no clipping; decay is
// per tensor (1 where a leaf takes no weight decay).  The gradient is read
// and not written.
//
// What bounds it: HBM bytes.  p, m and v are read and written, g is read:
// 28 bytes an element for ~50 instructions, far under the card's ridge, so
// the least time is those bytes over 3.35 TB/s.
//
// Design (apex's multi_tensor_apply, with 64-bit offsets):
// - the launch's tensors travel by value in the kernel's parameter space
//   (Table, under its 4 KB): four pointers, the element count, the first
//   work unit and the decay of each tensor.  No host-to-device copy, no
//   synchronize.  The host cuts longer lists into several launches
//   (ops/adam.py plan).
// - a work unit is kChunk elements of one tensor (a tensor's last one is
//   shorter); units are numbered through the tensors in order, and a block
//   finds a unit's tensor by a binary search of the first units.  Element
//   offsets are 64-bit, so one tensor may pass 2^31 elements.
// - a grid of one full wave of blocks (the occupancy calculator's) walks
//   the units with a stride of the grid, so the card stays full to the end
//   of a list of any shape.
// - threads read and write 16-byte vectors where all four pointers of a
//   tensor are 16-byte aligned (kChunk is a multiple of 4, so every unit of
//   such a tensor starts aligned), two vectors of each array in flight per
//   thread; a tensor's ragged end and any unaligned tensor go element by
//   element.
// - IEEE division and square root (nvcc's defaults), as PyTorch computes
//   them, so the result follows the foreach chain to float32 rounding.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 8192;        // elements per work unit
constexpr int kMaxTensors = 80;     // tensors a launch's table holds
static_assert(kChunk % (4 * kThreads) == 0, "units of whole vectors");

struct Table {
  float* p[kMaxTensors];
  const float* g[kMaxTensors];
  float* m[kMaxTensors];
  float* v[kMaxTensors];
  int64_t numel[kMaxTensors];
  int first[kMaxTensors + 1];       // first unit of each; first[n] = units
  float decay[kMaxTensors];
  int n;
};

struct Scalars {
  float lr, b1, omb1, b2, omb2, bc1, bc2, eps;
  const float* scale;               // the clip's, or null
};

// the kernel's parameters stay under the 4 KB every toolkit takes
static_assert(sizeof(Table) + sizeof(Scalars) <= 4096, "parameter space");

__device__ __forceinline__ void update(float& p, float g, float& m, float& v,
                                       float decay, float s,
                                       const Scalars& k) {
  p = p * decay;
  g = g * s;
  m = m * k.b1 + k.omb1 * g;
  v = v * k.b2 + k.omb2 * g * g;
  const float d = sqrtf(v / k.bc2) + k.eps;
  p = p - k.lr * ((m / k.bc1) / d);
}

__device__ __forceinline__ void update4(float4& p, const float4& g,
                                        float4& m, float4& v, float decay,
                                        float s, const Scalars& k) {
  update(p.x, g.x, m.x, v.x, decay, s, k);
  update(p.y, g.y, m.y, v.y, decay, s, k);
  update(p.z, g.z, m.z, v.z, decay, s, k);
  update(p.w, g.w, m.w, v.w, decay, s, k);
}

__global__ void __launch_bounds__(kThreads)
    adam_kernel(const Table t, const Scalars k) {
  const float s = k.scale != nullptr ? *k.scale : 1.f;
  const int units = t.first[t.n];
  for (int c = blockIdx.x; c < units; c += gridDim.x) {
    // the tensor of unit c: the last i with first[i] <= c
    int lo = 0, hi = t.n - 1;
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if (t.first[mid] <= c) lo = mid; else hi = mid - 1;
    }
    const int64_t start = static_cast<int64_t>(c - t.first[lo]) * kChunk;
    const int64_t rest = t.numel[lo] - start;
    const int len = rest < kChunk ? static_cast<int>(rest) : kChunk;
    float* p = t.p[lo] + start;
    const float* g = t.g[lo] + start;
    float* m = t.m[lo] + start;
    float* v = t.v[lo] + start;
    const float decay = t.decay[lo];
    int done = 0;
    const uintptr_t bases =
        reinterpret_cast<uintptr_t>(t.p[lo]) |
        reinterpret_cast<uintptr_t>(t.g[lo]) |
        reinterpret_cast<uintptr_t>(t.m[lo]) |
        reinterpret_cast<uintptr_t>(t.v[lo]);
    if ((bases & 15) == 0) {
      float4* p4 = reinterpret_cast<float4*>(p);
      const float4* g4 = reinterpret_cast<const float4*>(g);
      float4* m4 = reinterpret_cast<float4*>(m);
      float4* v4 = reinterpret_cast<float4*>(v);
      const int n4 = len >> 2;
      for (int j = threadIdx.x; j < n4; j += 2 * kThreads) {
        const int j2 = j + kThreads;
        const bool two = j2 < n4;
        float4 pa = p4[j], ga = g4[j], ma = m4[j], va = v4[j];
        float4 pb, gb, mb, vb;
        if (two) {
          pb = p4[j2];
          gb = g4[j2];
          mb = m4[j2];
          vb = v4[j2];
        }
        update4(pa, ga, ma, va, decay, s, k);
        p4[j] = pa;
        m4[j] = ma;
        v4[j] = va;
        if (two) {
          update4(pb, gb, mb, vb, decay, s, k);
          p4[j2] = pb;
          m4[j2] = mb;
          v4[j2] = vb;
        }
      }
      done = n4 << 2;
    }
    for (int j = done + threadIdx.x; j < len; j += kThreads) {
      float pj = p[j], mj = m[j], vj = v[j];
      update(pj, g[j], mj, vj, decay, s, k);
      p[j] = pj;
      m[j] = mj;
      v[j] = vj;
    }
  }
}

}  // namespace

extern "C" {

// One launch over the table's tensors on `stream`, the current device's.
// Returns the cudaError_t of the launch (0 on success).
int nnl_adam(const void* table, float lr, float b1, float omb1, float b2,
             float omb2, float bc1, float bc2, float eps, const void* scale,
             void* stream) {
  const Table& t = *static_cast<const Table*>(table);
  if (t.n < 1 || t.n > kMaxTensors || t.first[0] != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int units = t.first[t.n];
  if (units < 1) return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  // one full wave of blocks, by the occupancy calculator, per device
  static int wave_dev = -1, wave = 0;
  if (dev != wave_dev) {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, adam_kernel, kThreads, 0);
    if (err != cudaSuccess) return static_cast<int>(err);
    wave = sms * (per_sm > 0 ? per_sm : 1);
    wave_dev = dev;
  }
  const Scalars k{lr, b1, omb1, b2, omb2, bc1, bc2, eps,
                  static_cast<const float*>(scale)};
  adam_kernel<<<units < wave ? units : wave, kThreads, 0,
                static_cast<cudaStream_t>(stream)>>>(t, k);
  return static_cast<int>(cudaGetLastError());
}

// The layout the host must build: (tensors a table holds, elements a work
// unit holds, bytes of the table).
void nnl_adam_layout(int* out) {
  out[0] = kMaxTensors;
  out[1] = kChunk;
  out[2] = static_cast<int>(sizeof(Table));
}

const char* nnl_adam_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
