// Paged decode attention for Hopper (sm_90a), bound to Python with ctypes.
//
// Replaces the TPU kernel neuralnetworklibrary_tpu/ops/paged_attention.py
// `_kernel` (Pallas).  One decode token per slot attends to positions
// 0..off (or off-window+1..off) of its sequence, whose K/V rows live in a
// shared paged pool (N, bs, Hkv, hd) and are found through the slot's block
// table (B, MB).  The gathered (MB*bs, Hkv, hd) strip that the plain
// formulation builds is never written: each K/V row goes from the pool
// straight into shared memory.
//
// What bounds it: HBM bytes.  A slot reads (off+1)*Hkv*hd K and V elements
// once and does 4*G operations on each (G = H/Hkv query heads per kv head),
// far under the card's ~20 operations per byte on the CUDA cores for
// G <= 4, so the least time is the live K/V bytes over 3.35 TB/s.  To reach
// it the card needs enough bytes in flight: a few tens of KB on each SM.
//
// Design (split-sequence, "flash-decoding"):
// - grid (Hkv * groups, B, S).  A block serves up to GT = 8 query heads of
//   one kv head (G > 8 takes several head groups), so each K/V row is read
//   once for all G heads of its kv head when G <= 8.  Each block reads its
//   slot's offset from the device, takes the live range [start, off] and
//   cuts it into chunks of kChunk positions at multiples of kChunk; split s
//   takes the s-th of S equal shares of those chunks.  S is chosen on the
//   host from the blocks one share takes (nnl_paged_attention_tickets), the
//   table's length and how many blocks an SM holds (never from the
//   offsets): one full wave of blocks, so short and long slots both spread
//   over the SMs.
// - inside a block, chunks stream through a ring of up to kMaxStages stages
//   in shared memory by cp.async (16-byte pieces, 8 for int8 rows that are
//   no multiple of 16 bytes; neighbouring threads on neighbouring bytes of
//   one row; positions that are not live zero-filled), with stages - 1
//   chunks in flight while one is computed.  Warp 0 reads the block-table
//   entries of the chunk `stages` ahead while the current one computes, so
//   staging never waits on the table.
// - each of the block's 4 warps (8 for blocks of 4-8 heads) takes its
//   share of a chunk's rows.  R lanes (hd / 8 rounded up to a power of two,
//   at most 32) cover one row, 8 elements each (one 16-byte bf16 vector,
//   two float32 ones, 8 bytes of int8), so a warp covers 32 / R rows per
//   pass.  The dot for all heads of the block comes from the same
//   registers; the R partial sums meet by warp shuffles.  The online
//   softmax (m, l) and the accumulator live in registers in f32, per warp;
//   the warps merge in a fixed order at the end of the split.
// - S == 1: the block finishes the output itself.  S > 1: each split writes
//   its (m, l, acc) in f32 to a scratch of (B, H, S) rows; the last of the S
//   blocks of a (slot, head group) to finish, found by an integer ticket,
//   merges them in split order in the same launch.  No float atomics: two
//   calls give the same bits.
// - scores carry log2(e) in q's scale, so p = exp2(s - m) (one MUFU op).
// Semantics follow the Pallas kernel: q is scaled by sm_scale before the
// dot; int8 k-scales multiply the scores, v-scales multiply p before the PV
// product while l sums the unscaled p; a sink joins only the normalizer,
// folded into the max; the output is acc / max(l, 1e-30) in q's dtype.
// Table entries and offsets are clamped into range, as XLA clamps the
// gather of the TPU version.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;                // warps per block of 1-2 heads
constexpr int kWarpsGqa = 8;             // warps per block of 4-8 heads
constexpr int kChunk = 32;               // positions per ring stage
static_assert(kChunk == 32, "a lane of warp 0 looks up each position");
constexpr int kMaxStages = 4;
constexpr int kRingBudget = 96 * 1024;   // bytes the ring may take
constexpr int kMaxHeads = 8;             // query heads per block (GT)
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr size_t kMaxSmem = 232448;      // 227 KB, the most a block may use

struct Params {
  const void* q;            // (B, H, hd)
  const void* pool_k;       // (N, bs, Hkv, hd)
  const void* pool_v;       // (N, bs, Hkv, hd)
  const float* k_scale;     // (N, bs, Hkv) or null
  const float* v_scale;     // (N, bs, Hkv) or null
  const float* sink;        // (H,) or null
  const int32_t* table;     // (B, MB)
  const int32_t* offsets;   // (B,)
  void* out;                // (B, H, hd)
  float* part_acc;          // (B, H, S, hd), S > 1 only
  float* part_ml;           // (B, H, S, 2), S > 1 only
  int* tickets;             // (B, gridDim.x) zeros, S > 1 only
  int B, H, Hkv, hd, N, bs, MB, window, splits;
  int G, groups, stages;
  float sm_scale;
};

// ------------------------------------------------------------ element types

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

// One lane's vector of a K/V row in shared memory, widened to f32.
template <typename T>
struct Vec;
template <>
struct Vec<float> {
  static constexpr int kElems = 4, kBytes = 16, kMaxVecs = 2;
  __device__ __forceinline__ static void load(const unsigned char* p,
                                              float* x) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    x[0] = v.x;
    x[1] = v.y;
    x[2] = v.z;
    x[3] = v.w;
  }
};
template <>
struct Vec<__nv_bfloat16> {
  static constexpr int kElems = 8, kBytes = 16, kMaxVecs = 1;
  __device__ __forceinline__ static void load(const unsigned char* p,
                                              float* x) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      x[2 * i] = __uint_as_float(w[i] << 16);
      x[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
};
template <>
struct Vec<int8_t> {
  static constexpr int kElems = 8, kBytes = 8, kMaxVecs = 1;
  __device__ __forceinline__ static void load(const unsigned char* p,
                                              float* x) {
    const uint2 v = *reinterpret_cast<const uint2*>(p);
    const uint32_t w[2] = {v.x, v.y};
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int k = 0; k < 4; ++k)
        x[4 * i + k] = static_cast<float>(
            static_cast<int32_t>(w[i] << (24 - 8 * k)) >> 24);
  }
};

// ------------------------------------------------------------ cp.async

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Copy `bytes` (16, 8 or 4) from global to shared; src_bytes 0 zero-fills.
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         int bytes, int src_bytes) {
  const uint32_t d = smem_addr(dst);
  if (bytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
                 "l"(src), "r"(src_bytes)
                 : "memory");
  else if (bytes == 8)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(d),
                 "l"(src), "r"(src_bytes)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
                 "l"(src), "r"(src_bytes)
                 : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most n (0, 1 or 2) of this thread's groups are pending.
__device__ __forceinline__ void cp_async_wait(int n) {
  if (n >= 2)
    asm volatile("cp.async.wait_group 2;\n" ::: "memory");
  else if (n == 1)
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
  else
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// ------------------------------------------------------------ layout

__host__ __device__ inline int heads_per_block(int G) {
  return G <= 1 ? 1 : G == 2 ? 2 : G <= 4 ? 4 : kMaxHeads;
}

// Warps of a block of GT heads: blocks of 4-8 heads do 4-8 times the
// arithmetic on each byte, and take more warps to hide its latency.
__host__ __device__ constexpr int warps_for(int GT) {
  return GT >= 4 ? kWarpsGqa : kWarps;
}

// Bytes of one ring stage: kChunk K rows, kChunk V rows, and the int8
// pools' k and v scales.
__host__ __device__ inline int stage_bytes(int hd, int kv_size, bool quant) {
  return 2 * kChunk * hd * kv_size + (quant ? 2 * kChunk * 4 : 0);
}

__host__ inline int ring_stages(int hd, int kv_size, bool quant) {
  int st = kMaxStages;
  while (st > 2 && st * stage_bytes(hd, kv_size, quant) > kRingBudget) --st;
  return st;
}

// Dynamic shared memory of a split block: the ring, each warp's scores for
// its rows of a chunk, and each stage's pool rows; the epilogue reuses it
// for the warps' (m, l, acc).
__host__ inline size_t split_smem_bytes(int hd, int kv_size, bool quant,
                                        int GT, int stages) {
  const size_t ring = static_cast<size_t>(stages) *
                          (stage_bytes(hd, kv_size, quant) +
                           sizeof(long long) * kChunk) +
                      sizeof(float) * kChunk * GT;
  const size_t epi = sizeof(float) * warps_for(GT) * GT * (hd + 2);
  return ring > epi ? ring : epi;
}

// The output from the merged (M, L, A), M in log2 units: the sink joins
// the normalizer, folded into the max.
__device__ __forceinline__ float finish(float M, float L, float A,
                                        const float* sink, int h) {
  if (sink != nullptr) {
    const float sk = sink[h] * kLog2e;
    const float mt = fmaxf(M, sk);
    const float sc = exp2f(M - mt);
    L = L * sc + exp2f(sk - mt);
    A *= sc;
  }
  return A / fmaxf(L, 1e-30f);
}

// ------------------------------------------------------------ kernels

template <typename TQ, typename TKV, int GT>
__global__ void __launch_bounds__(32 * warps_for(GT))
    paged_split_kernel(const Params p) {
  using V = Vec<TKV>;
  constexpr int VE = V::kElems;
  constexpr int NV = V::kMaxVecs;
  constexpr int NW = warps_for(GT);
  constexpr int kThreads = 32 * NW;
  constexpr int kRowsPerWarp = kChunk / NW;
  extern __shared__ __align__(16) unsigned char smem[];

  const int g = blockIdx.x / p.groups;
  const int h0 = g * p.G + (blockIdx.x - g * p.groups) * GT;
  const int nh = min(GT, (g + 1) * p.G - h0);  // live heads of this block
  const int b = blockIdx.y;
  const int s = blockIdx.z;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int hd = p.hd;
  const int nvec = hd / VE;
  int R = 1;  // lanes per row: NV vectors each, at most 32
  while (R * NV < nvec) R <<= 1;
  const int rpp = 32 / R;  // rows per pass of a warp
  const int sub = lane & (R - 1);
  const int grp = lane / R;
  const int rowbytes = hd * static_cast<int>(sizeof(TKV));
  const int piece = rowbytes % 16 == 0 ? 16 : 8;
  const bool quant = p.k_scale != nullptr;
  const int sbytes = stage_bytes(hd, sizeof(TKV), quant);

  // the live range and this split's share of its chunks
  const int max_pos = p.MB * p.bs - 1;
  int off = p.offsets[b];
  off = off < 0 ? 0 : (off > max_pos ? max_pos : off);
  const int start = p.window > 0 ? max(0, off - p.window + 1) : 0;
  const int cf = start / kChunk;
  const int n = off / kChunk - cf + 1;
  const int c0 = cf + static_cast<int>((static_cast<long long>(s) * n) /
                                       p.splits);
  const int c1 = cf + static_cast<int>((static_cast<long long>(s + 1) * n) /
                                       p.splits);
  const int32_t* trow = p.table + static_cast<size_t>(b) * p.MB;
  const unsigned char* k_bytes = static_cast<const unsigned char*>(p.pool_k);
  const unsigned char* v_bytes = static_cast<const unsigned char*>(p.pool_v);
  const int nch = c1 - c0;

  // Shared memory: the ring of stages, each warp's scores, and for each
  // stage the pool row of each of its chunk's positions ((row * bs + pos %
  // bs) * Hkv + g, or -1 where the position is not live).  Warp 0 reads the
  // table entries of chunk j + stages while chunk j computes, so staging a
  // chunk never waits on the table.
  float* sbuf = reinterpret_cast<float*>(
                    smem + static_cast<size_t>(p.stages) * sbytes) +
                warp * kRowsPerWarp * GT;
  long long* rowoff = reinterpret_cast<long long*>(
      smem + static_cast<size_t>(p.stages) * sbytes +
      sizeof(float) * kChunk * GT);
  // lane's position of local chunk j, and its raw table entry (0 if dead)
  auto table_entry = [&](int j, int& pos) {
    pos = (c0 + j) * kChunk + lane;
    return (pos >= start && pos <= off) ? trow[pos / p.bs] : 0;
  };
  auto row_offset = [&](int pos, int entry) -> long long {
    if (pos < start || pos > off) return -1;
    const int row = entry < 0 ? 0 : (entry >= p.N ? p.N - 1 : entry);
    return (static_cast<long long>(row) * p.bs + pos % p.bs) * p.Hkv + g;
  };

  // stage local chunk j into its ring slot: K rows, V rows, then the
  // scales; the rows of positions that are not live are zero-filled.
  auto stage_chunk = [&](int j) {
    const int st = j % p.stages;
    unsigned char* base = smem + static_cast<size_t>(st) * sbytes;
    const long long* rows = rowoff + st * kChunk;
    const int per_row = rowbytes / piece;
    for (int i = tid; i < kChunk * per_row; i += kThreads) {
      const int t = i / per_row;
      const long long r = rows[t];
      const size_t at = r < 0 ? 0
                              : static_cast<size_t>(r) * rowbytes +
                                    static_cast<size_t>(i - t * per_row) *
                                        piece;
      const int n = r < 0 ? 0 : piece;
      unsigned char* dst = base + i * piece;
      cp_async(dst, k_bytes + at, piece, n);
      cp_async(dst + kChunk * rowbytes, v_bytes + at, piece, n);
    }
    if (quant) {
      float* sc = reinterpret_cast<float*>(base + 2 * kChunk * rowbytes);
      for (int i = tid; i < 2 * kChunk; i += kThreads) {
        const int kv = i >= kChunk;
        const long long r = rows[i - kv * kChunk];
        cp_async(sc + i, (kv ? p.v_scale : p.k_scale) + (r < 0 ? 0 : r), 4,
                 r < 0 ? 0 : 4);
      }
    }
  };

  // q of the block's heads, scaled by sm_scale * log2(e): the scores, m
  // and the partials are in log2 units, and p = exp2(s - m)
  const TQ* q = static_cast<const TQ*>(p.q);
  const float qscale = p.sm_scale * kLog2e;
  float qr[GT][NV][VE];
  float acc[GT][NV][VE];
  float m[GT], l[GT];
#pragma unroll
  for (int h = 0; h < GT; ++h) {
    m[h] = kNegInf;
    l[h] = 0.f;
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int v = j * R + sub;
#pragma unroll
      for (int e = 0; e < VE; ++e) {
        acc[h][j][e] = 0.f;
        qr[h][j][e] =
            (h < nh && v < nvec)
                ? to_f32(q[(static_cast<size_t>(b) * p.H + h0 + h) * hd +
                           v * VE + e]) *
                      qscale
                : 0.f;
      }
    }
  }

  const int row0 = warp * kRowsPerWarp;
  const int npass = (kRowsPerWarp + rpp - 1) / rpp;

  if (warp == 0) {
    int pos[kMaxStages], entry[kMaxStages];
#pragma unroll
    for (int j = 0; j < kMaxStages; ++j)  // the loads in flight together
      if (j < p.stages && j < nch) entry[j] = table_entry(j, pos[j]);
#pragma unroll
    for (int j = 0; j < kMaxStages; ++j)
      if (j < p.stages && j < nch)
        rowoff[j * kChunk + lane] = row_offset(pos[j], entry[j]);
  }
  __syncthreads();
  for (int j = 0; j < p.stages - 1; ++j) {
    if (j < nch) stage_chunk(j);
    cp_async_commit();
  }
  for (int i = 0; i < nch; ++i) {
    cp_async_wait(p.stages - 2);  // chunk i has landed (this thread's part)
    __syncthreads();              // everyone's part; stage i-1 is free
    if (i + p.stages - 1 < nch) stage_chunk(i + p.stages - 1);
    cp_async_commit();
    // the table entries of chunk i + stages, in flight while i computes
    const bool ahead = warp == 0 && i + p.stages < nch;
    int ahead_pos = 0, ahead_entry = 0;
    if (ahead) ahead_entry = table_entry(i + p.stages, ahead_pos);

    const int c = c0 + i;
    const unsigned char* kb =
        smem + static_cast<size_t>(i % p.stages) * sbytes;
    const unsigned char* vb = kb + kChunk * rowbytes;
    const float* ksc = reinterpret_cast<const float*>(kb + 2 * kChunk *
                                                      rowbytes);
    const float* vsc = ksc + kChunk;

    // scores of the warp's rows, and their max
    float mloc[GT];
#pragma unroll
    for (int h = 0; h < GT; ++h) mloc[h] = kNegInf;
#pragma unroll
    for (int ps = 0; ps < kRowsPerWarp; ++ps) {
      if (ps >= npass) break;
      const int rw = ps * rpp + grp;
      const int t = row0 + rw;
      const int pos = c * kChunk + t;
      const bool has_row = rw < kRowsPerWarp;
      const bool valid = has_row && pos >= start && pos <= off;
      float dot[GT];
#pragma unroll
      for (int h = 0; h < GT; ++h) dot[h] = 0.f;
      if (has_row) {
#pragma unroll
        for (int j = 0; j < NV; ++j) {
          const int v = j * R + sub;
          if (v < nvec) {
            float x[VE];
            V::load(kb + t * rowbytes + v * V::kBytes, x);
#pragma unroll
            for (int h = 0; h < GT; ++h)
#pragma unroll
              for (int e = 0; e < VE; ++e)
                dot[h] = fmaf(qr[h][j][e], x[e], dot[h]);
          }
        }
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        if (o < R)
#pragma unroll
          for (int h = 0; h < GT; ++h)
            dot[h] += __shfl_xor_sync(0xffffffffu, dot[h], o);
      const float ks = (quant && has_row) ? ksc[t] : 1.f;
#pragma unroll
      for (int h = 0; h < GT; ++h) {
        const float sc = valid ? dot[h] * ks : kNegInf;
        mloc[h] = fmaxf(mloc[h], sc);
        if (has_row && sub == 0) sbuf[rw * GT + h] = sc;
      }
    }
    // one rescale per chunk, where the warp's max moved
#pragma unroll
    for (int h = 0; h < GT; ++h) {
      float mx = mloc[h];
#pragma unroll
      for (int o = 1; o < 32; o <<= 1)
        if (o >= R) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float mn = fmaxf(m[h], mx);
      if (mn != m[h]) {
        const float a = exp2f(m[h] - mn);
        l[h] *= a;
#pragma unroll
        for (int j = 0; j < NV; ++j)
#pragma unroll
          for (int e = 0; e < VE; ++e) acc[h][j][e] *= a;
        m[h] = mn;
      }
    }
    __syncwarp();
    // p = exp(s - m); l sums p, acc takes p (times the v-scale) V
#pragma unroll
    for (int ps = 0; ps < kRowsPerWarp; ++ps) {
      if (ps >= npass) break;
      const int rw = ps * rpp + grp;
      const int t = row0 + rw;
      const int pos = c * kChunk + t;
      const bool valid = rw < kRowsPerWarp && pos >= start && pos <= off;
      if (!valid) continue;
      const float vs = quant ? vsc[t] : 1.f;
      float pr[GT];
#pragma unroll
      for (int h = 0; h < GT; ++h) {
        const float e = exp2f(sbuf[rw * GT + h] - m[h]);
        l[h] += e;
        pr[h] = e * vs;
      }
#pragma unroll
      for (int j = 0; j < NV; ++j) {
        const int v = j * R + sub;
        if (v < nvec) {
          float x[VE];
          V::load(vb + t * rowbytes + v * V::kBytes, x);
#pragma unroll
          for (int h = 0; h < GT; ++h)
#pragma unroll
            for (int e = 0; e < VE; ++e)
              acc[h][j][e] = fmaf(pr[h], x[e], acc[h][j][e]);
        }
      }
    }
    // the slot of chunk i + stages is chunk i's, whose rows were used when
    // it was staged
    if (ahead)
      rowoff[(i % p.stages) * kChunk + lane] =
          row_offset(ahead_pos, ahead_entry);
    __syncwarp();  // sbuf is rewritten by the next chunk
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();  // the ring is free for the epilogue

  // the warp's row groups share m: sum l and acc over them
  for (int o = R; o < 32; o <<= 1) {
#pragma unroll
    for (int h = 0; h < GT; ++h) {
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], o);
#pragma unroll
      for (int j = 0; j < NV; ++j)
#pragma unroll
        for (int e = 0; e < VE; ++e)
          acc[h][j][e] += __shfl_xor_sync(0xffffffffu, acc[h][j][e], o);
    }
  }
  float* wm = reinterpret_cast<float*>(smem);  // [NW][GT]
  float* wl = wm + NW * GT;                     // [NW][GT]
  float* wacc = wl + NW * GT;                   // [NW][GT][hd]
  if (lane == 0) {
#pragma unroll
    for (int h = 0; h < GT; ++h) {
      wm[warp * GT + h] = m[h];
      wl[warp * GT + h] = l[h];
    }
  }
  if (grp == 0) {
#pragma unroll
    for (int h = 0; h < GT; ++h)
#pragma unroll
      for (int j = 0; j < NV; ++j) {
        const int v = j * R + sub;
        if (v < nvec)
#pragma unroll
          for (int e = 0; e < VE; ++e)
            wacc[(warp * GT + h) * hd + v * VE + e] = acc[h][j][e];
      }
  }
  __syncthreads();
  // the warps merge in order; then finish (S == 1) or write the partial
  for (int i = tid; i < nh * hd; i += kThreads) {
    const int h = i / hd;
    const int d = i - h * hd;
    float M = kNegInf;
    for (int w = 0; w < NW; ++w) M = fmaxf(M, wm[w * GT + h]);
    float L = 0.f, A = 0.f;
    for (int w = 0; w < NW; ++w) {
      const float sc = exp2f(wm[w * GT + h] - M);
      L += wl[w * GT + h] * sc;
      A += wacc[(w * GT + h) * hd + d] * sc;
    }
    const size_t bh = static_cast<size_t>(b) * p.H + h0 + h;
    if (p.splits == 1) {
      static_cast<TQ*>(p.out)[bh * hd + d] =
          from_f32<TQ>(finish(M, L, A, p.sink, h0 + h));
    } else {
      const size_t at = bh * p.splits + s;
      p.part_acc[at * hd + d] = A;
      if (d == 0) {
        p.part_ml[2 * at] = M;
        p.part_ml[2 * at + 1] = L;
      }
    }
  }
  if (p.splits == 1) return;

  // S > 1: the last of the S blocks of this (slot, head group) to finish,
  // found by an integer ticket, merges the partials in split order and
  // sets the ticket back to 0 for the next call.
  __shared__ int last;
  int* ticket = p.tickets + static_cast<size_t>(b) * gridDim.x + blockIdx.x;
  __threadfence();
  __syncthreads();
  if (tid == 0) last = atomicAdd(ticket, 1) == p.splits - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  for (int i = tid; i < nh * hd; i += kThreads) {
    const int h = i / hd;
    const int d = i - h * hd;
    const size_t at = (static_cast<size_t>(b) * p.H + h0 + h) * p.splits;
    float M = kNegInf;
#pragma unroll 8
    for (int j = 0; j < p.splits; ++j)
      M = fmaxf(M, __ldcg(p.part_ml + 2 * (at + j)));
    float L = 0.f, A = 0.f;
#pragma unroll 8
    for (int j = 0; j < p.splits; ++j) {
      const float sc = exp2f(__ldcg(p.part_ml + 2 * (at + j)) - M);
      L += __ldcg(p.part_ml + 2 * (at + j) + 1) * sc;
      A += __ldcg(p.part_acc + (at + j) * hd + d) * sc;
    }
    static_cast<TQ*>(p.out)[(at / p.splits) * hd + d] =
        from_f32<TQ>(finish(M, L, A, p.sink, h0 + h));
  }
  if (tid == 0) *ticket = 0;
}

// ------------------------------------------------------------ launch

template <typename TQ, typename TKV, int GT>
int launch(Params p, cudaStream_t stream) {
  const bool quant = p.k_scale != nullptr;
  p.groups = (p.G + GT - 1) / GT;
  p.stages = ring_stages(p.hd, sizeof(TKV), quant);
  const size_t smem =
      split_smem_bytes(p.hd, sizeof(TKV), quant, GT, p.stages);
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  auto kern = paged_split_kernel<TQ, TKV, GT>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kern<<<dim3(p.Hkv * p.groups, p.B, p.splits), 32 * warps_for(GT), smem,
         stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// Blocks of this instantiation one SM holds at once (0 on an error).
template <typename TQ, typename TKV, int GT>
int occupancy(int hd, bool quant) {
  const size_t smem = split_smem_bytes(hd, sizeof(TKV), quant, GT,
                                       ring_stages(hd, sizeof(TKV), quant));
  if (smem > kMaxSmem) return 0;
  auto kern = paged_split_kernel<TQ, TKV, GT>;
  if (smem > 48 * 1024 &&
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem)) != cudaSuccess)
    return 0;
  int n = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &n, kern, 32 * warps_for(GT), smem) != cudaSuccess)
    return 0;
  return n;
}

template <typename TQ, typename TKV>
int occupancy_heads(int G, int hd, bool quant) {
  switch (heads_per_block(G)) {
    case 1:
      return occupancy<TQ, TKV, 1>(hd, quant);
    case 2:
      return occupancy<TQ, TKV, 2>(hd, quant);
    case 4:
      return occupancy<TQ, TKV, 4>(hd, quant);
    default:
      return occupancy<TQ, TKV, kMaxHeads>(hd, quant);
  }
}

template <typename TQ>
int occupancy_kv(int kv_dtype, int G, int hd) {
  switch (kv_dtype) {
    case 0:
      return occupancy_heads<TQ, float>(G, hd, false);
    case 1:
      return occupancy_heads<TQ, __nv_bfloat16>(G, hd, false);
    case 2:
      return occupancy_heads<TQ, int8_t>(G, hd, true);
    default:
      return 0;
  }
}

template <typename TQ, typename TKV>
int launch_heads(const Params& p, cudaStream_t stream) {
  switch (heads_per_block(p.G)) {
    case 1:
      return launch<TQ, TKV, 1>(p, stream);
    case 2:
      return launch<TQ, TKV, 2>(p, stream);
    case 4:
      return launch<TQ, TKV, 4>(p, stream);
    default:
      return launch<TQ, TKV, kMaxHeads>(p, stream);
  }
}

template <typename TQ>
int launch_kv(int kv_dtype, const Params& p, cudaStream_t stream) {
  switch (kv_dtype) {
    case 0:
      return launch_heads<TQ, float>(p, stream);
    case 1:
      return launch_heads<TQ, __nv_bfloat16>(p, stream);
    case 2:
      return launch_heads<TQ, int8_t>(p, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// dtype codes: 0 = float32, 1 = bfloat16, 2 = int8 (pools only).  splits
// is S, the number of shares of each slot's live range (>= 1); for S > 1,
// part_acc (B, H, S, hd) and part_ml (B, H, S, 2) are float32 scratch and
// tickets holds nnl_paged_attention_tickets(B, H, Hkv) int32 zeros, which
// the launch leaves at zero (so calls that share it must not overlap).
// Returns the cudaError_t of the launch (0 on success).
int nnl_paged_attention(const void* q, const void* pool_k,
                        const void* pool_v, const void* k_scale,
                        const void* v_scale, const void* sink,
                        const void* table, const void* offsets, void* out,
                        void* part_acc, void* part_ml, void* tickets, int B,
                        int H, int Hkv, int hd, int N, int bs, int MB,
                        float sm_scale, int window, int splits, int q_dtype,
                        int kv_dtype, void* stream) {
  if (Hkv <= 0 || H % Hkv || hd % 8 || hd <= 0 || hd > 256 || splits < 1 ||
      (kv_dtype == 2) != (k_scale != nullptr) ||
      (splits > 1 &&
       (part_acc == nullptr || part_ml == nullptr || tickets == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{};
  p.q = q;
  p.pool_k = pool_k;
  p.pool_v = pool_v;
  p.k_scale = static_cast<const float*>(k_scale);
  p.v_scale = static_cast<const float*>(v_scale);
  p.sink = static_cast<const float*>(sink);
  p.table = static_cast<const int32_t*>(table);
  p.offsets = static_cast<const int32_t*>(offsets);
  p.out = out;
  p.part_acc = static_cast<float*>(part_acc);
  p.part_ml = static_cast<float*>(part_ml);
  p.tickets = static_cast<int*>(tickets);
  p.B = B;
  p.H = H;
  p.Hkv = Hkv;
  p.hd = hd;
  p.N = N;
  p.bs = bs;
  p.MB = MB;
  p.window = window;
  p.splits = splits;
  p.G = H / Hkv;
  p.sm_scale = sm_scale;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (q_dtype == 0) return launch_kv<float>(kv_dtype, p, s);
  if (q_dtype == 1) return launch_kv<__nv_bfloat16>(kv_dtype, p, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Blocks of the kernel for these heads and types one SM holds at once, by
// the CUDA runtime's occupancy calculator (0 on an error); the host picks S
// from it.
int nnl_paged_attention_blocks_per_sm(int H, int Hkv, int hd, int q_dtype,
                                      int kv_dtype) {
  if (Hkv <= 0 || H % Hkv || hd % 8 || hd <= 0 || hd > 256) return 0;
  if (q_dtype == 0) return occupancy_kv<float>(kv_dtype, H / Hkv, hd);
  if (q_dtype == 1) return occupancy_kv<__nv_bfloat16>(kv_dtype, H / Hkv, hd);
  return 0;
}

// Tickets a launch with S > 1 needs: one per (slot, block of heads).
int nnl_paged_attention_tickets(int B, int H, int Hkv) {
  const int G = H / Hkv;
  const int GT = heads_per_block(G);
  return B * Hkv * ((G + GT - 1) / GT);
}

const char* nnl_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
