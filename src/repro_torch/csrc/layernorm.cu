// Row LayerNorm / RMSNorm for Hopper.
//
// Replaces the TPU kernel layernorm_p (src/repro/kernels/layernorm.py,
// body _norm_kernel, math rownorm): fp32 statistics over D by the
// two-pass formula (mean = sum(x) / D, then var = sum((x - mean)^2) / D),
// then (x - mean) * rsqrt(var + eps) * gamma + beta, optional beta.
//
// Bound: bytes. A call reads each row once and writes it once (gamma and
// beta are shared by every row), a few operations per byte. So each
// design reads its row from device memory once, with 16-byte loads (4
// fp32 or 8 bf16 a "slot"), keeps it in registers for both sums and the
// output, and writes with 16-byte stores. Two designs behind rk_layernorm,
// picked by the wrapper (kernels/layernorm.py::pick_design):
//
// * cta (few rows: a decode step's M = 4 on 132 SMs): one CTA per row,
//   up to 1024 threads, each holding one to four slots, so a row of 2560
//   fp32 is 640 threads of one slot; the sums go through warp shuffles
//   and one shared-memory step. Rows past the registers (more than 16 K
//   elements) are staged in shared memory (up to 227 KB), wider ones
//   re-read from L2 for the later passes (layernorm_kernel_cta_wide).
// * rows (many rows: prefill, Swin-T): a group of G lanes per row, G the
//   power of two that leaves each lane at most four slots (D=96 fp32: 8
//   lanes of 3; D=2560: 256 lanes in fp32, 128 in bf16), CTAs of
//   max(128, G) threads holding several rows. A call of few rows spreads
//   each over more lanes, down to one or two slots a lane, so that
//   enough lanes are in flight.
// A thread of at most two slots loads its gamma and beta with its x, so
// that one memory round trip serves both; one of more loads them slot by
// slot at the output.
//
// Unaligned operands run in the same kernels: a row (or gamma, beta)
// whose start is not 16-byte aligned, and the ragged last slot of a D
// that is not a multiple of the slot, are read and written one element
// at a time. The sums are taken in a fixed order, so outputs repeat
// bitwise. The matmul's norm prologue keeps its own rk::row_stats.
#include <cstdint>

#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;

// rk_layernorm's flags
constexpr int KIND_MASK = 3;   // rk::NORM_LAYER or rk::NORM_RMS
constexpr int F_BF16 = 4;      // x and out in bf16, else fp32
constexpr int F_GAMMA_F32 = 8;  // gamma stored in fp32, else bf16
constexpr int F_BETA_F32 = 16;
constexpr int F_ROWS = 32;     // the rows design, else cta

constexpr int MAX_THREADS = 1024;
// the rows design: at most four slots a lane, at most 256 lanes a row,
// CTAs of max(128, G) threads; a call of fewer than ROWS_SPREAD lanes in
// all spreads each row over more lanes (down to one or two slots each)
constexpr int ROWS_SLOTS = 4;
constexpr int ROWS_MAX_LANES = 256;
constexpr int ROWS_MIN_THREADS = 128;
constexpr long long ROWS_SPREAD = 65536;
// elements a thread of the cta design holds in registers
constexpr int CTA_ELEMS = 16;
// dynamic shared memory a CTA may stage a row in (227 KB, less room for
// the static reduction buffer)
constexpr int STAGE_BYTES = 227 * 1024 - 1024;

struct Params {
  const void* x;
  long long ldx;
  const void* gamma;
  const void* beta;
  void* out;
  int m, d, kind;
  bool gamma_f32, beta_f32;
  float eps;
};

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

__device__ __forceinline__ void unpack(uint32_t u, float& lo, float& hi) {
  lo = __uint_as_float(u << 16);
  hi = __uint_as_float(u & 0xffff0000u);
}

__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16(lo))) |
         static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16(hi)))
             << 16;
}

// A slot of x as it lies in memory, 16 bytes: 4 fp32 or 8 bf16. Rows
// are held raw and widened where they are used, so that a load in flight
// stalls nothing until its row is reached. `fresh` hides a slot's value
// from the compiler (an empty asm), so that it neither widens a row it
// has only begun to load nor keeps a widened copy alive across the sums.
__device__ __forceinline__ uint4 fresh(uint4 r) {
  asm volatile("" : "+r"(r.x), "+r"(r.y), "+r"(r.z), "+r"(r.w));
  return r;
}
__device__ __forceinline__ void widen(const uint4& r, float (&f)[4]) {
  f[0] = __uint_as_float(r.x), f[1] = __uint_as_float(r.y);
  f[2] = __uint_as_float(r.z), f[3] = __uint_as_float(r.w);
}
__device__ __forceinline__ void widen(const uint4& r, float (&f)[8]) {
  unpack(r.x, f[0], f[1]);
  unpack(r.y, f[2], f[3]);
  unpack(r.z, f[4], f[5]);
  unpack(r.w, f[6], f[7]);
}
__device__ __forceinline__ void put(uint32_t (&w)[4], int e, float v) {
  w[e] = __float_as_uint(v);
}
__device__ __forceinline__ void put(uint32_t (&w)[4], int e, bf16 v) {
  w[e >> 1] |= static_cast<uint32_t>(__bfloat16_as_ushort(v))
               << (16 * (e & 1));
}

// The slot at column c0 of a row of n valid elements: one 16-byte load
// where the row start is aligned (vec) and the slot whole, else element
// by element, the columns at or past n read as 0.
template <typename T>
__device__ __forceinline__ uint4 load_raw(const T* row, int c0, int n,
                                          bool vec) {
  constexpr int V = 16 / sizeof(T);
  if (c0 >= n) return make_uint4(0, 0, 0, 0);
  if (vec && c0 + V <= n) return *reinterpret_cast<const uint4*>(row + c0);
  uint32_t w[4] = {0, 0, 0, 0};
#pragma unroll
  for (int e = 0; e < V; ++e)
    if (c0 + e < n) put(w, e, row[c0 + e]);
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// gamma and beta slots of either dtype, as fp32: 16 bytes where the
// slot's dtype matches x's, 8 or 32 where it does not.
__device__ __forceinline__ void load_vec(const float* p, float (&f)[4]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  f[0] = a.x, f[1] = a.y, f[2] = a.z, f[3] = a.w;
}
__device__ __forceinline__ void load_vec(const float* p, float (&f)[8]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  f[0] = a.x, f[1] = a.y, f[2] = a.z, f[3] = a.w;
  f[4] = b.x, f[5] = b.y, f[6] = b.z, f[7] = b.w;
}
__device__ __forceinline__ void load_vec(const bf16* p, float (&f)[8]) {
  widen(*reinterpret_cast<const uint4*>(p), f);
}
__device__ __forceinline__ void load_vec(const bf16* p, float (&f)[4]) {
  const uint2 a = *reinterpret_cast<const uint2*>(p);
  unpack(a.x, f[0], f[1]);
  unpack(a.y, f[2], f[3]);
}

template <int V, typename S>
__device__ __forceinline__ void load_slot(const S* v, int c0, int n,
                                          bool vec, float (&f)[V]) {
  if (c0 >= n) {
#pragma unroll
    for (int e = 0; e < V; ++e) f[e] = 0.f;
  } else if (vec && c0 + V <= n) {
    load_vec(v + c0, f);
  } else {
#pragma unroll
    for (int e = 0; e < V; ++e)
      f[e] = c0 + e < n ? rk::to_f32(v[c0 + e]) : 0.f;
  }
}

// gamma or beta as stored: one branch on its dtype a slot.
template <int V>
__device__ __forceinline__ void load_param(const void* p, bool f32, int c0,
                                           int n, float (&f)[V]) {
  if (f32)
    load_slot<V>(static_cast<const float*>(p), c0, n, aligned16(p), f);
  else
    load_slot<V>(static_cast<const bf16*>(p), c0, n, aligned16(p), f);
}

__device__ __forceinline__ void store_vec(float* p, const float (&f)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(f[0], f[1], f[2], f[3]);
}
__device__ __forceinline__ void store_vec(bf16* p, const float (&f)[8]) {
  *reinterpret_cast<uint4*>(p) = make_uint4(
      pack(f[0], f[1]), pack(f[2], f[3]), pack(f[4], f[5]),
      pack(f[6], f[7]));
}

template <int V, typename T>
__device__ __forceinline__ void store_slot(T* row, int c0, int n, bool vec,
                                           const float (&f)[V]) {
  if (vec && c0 + V <= n) {
    store_vec(row + c0, f);
  } else {
#pragma unroll
    for (int e = 0; e < V; ++e)
      if (c0 + e < n) row[c0 + e] = rk::from_f32<T>(f[e]);
  }
}

// The sum of v over the g lanes of a row group, the same bits in every
// lane: a butterfly inside the warp (g a power of two up to 32, groups
// aligned in the warp), then for g > 32 (a multiple of 32) the warps'
// sums through part[] in warp order. g is the same in the whole CTA, so
// every thread reaches the barrier.
__device__ __forceinline__ float group_sum(float v, int g, float* part) {
  for (int o = (g < 32 ? g : 32) >> 1; o > 0; o >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, o);
  if (g <= 32) return v;
  const int warp = threadIdx.x >> 5, w = g >> 5, first = warp / w * w;
  if ((threadIdx.x & 31) == 0) part[warp] = v;
  __syncthreads();
  float s = 0.f;
  for (int i = 0; i < w; ++i) s += part[first + i];
  return s;
}

// Lane `lane` of a group of g holds slots lane, lane + g, ... of its row
// (NV of them): neighbouring lanes read neighbouring 16 bytes. A row at
// or past m loads and stores nothing.
template <typename T, int NV>
__device__ __forceinline__ void load_row(const Params& p, int row, int lane,
                                         int g, uint4 (&raw)[NV]) {
  constexpr int V = 16 / sizeof(T);
  const int n = row < p.m ? p.d : 0;
  const T* xr = static_cast<const T*>(p.x) + row * p.ldx;
  const bool vec = aligned16(xr);
#pragma unroll
  for (int k = 0; k < NV; ++k) raw[k] = load_raw(xr, (lane + k * g) * V, n, vec);
}

// gamma and beta slots k of a lane (zeros past n; beta zeros when absent).
template <int V>
__device__ __forceinline__ void load_params(const Params& p, int c0, int n,
                                            float (&gm)[V], float (&bt)[V]) {
  load_param<V>(p.gamma, p.gamma_f32, c0, n, gm);
  if (p.beta) {
    load_param<V>(p.beta, p.beta_f32, c0, n, bt);
  } else {
#pragma unroll
    for (int e = 0; e < V; ++e) bt[e] = 0.f;
  }
}

// Normalize a row held raw in registers (as load_row left it): the mean,
// then the centred mean square, each a group_sum of the lanes' fp32
// partials, then the output. A lane of at most two slots loads its gamma
// and beta before the sums, so that their round trip overlaps x's; one
// of more slots loads them slot by slot at the output, to save registers.
// A row at or past m takes part in the sums and stores nothing. part: 64
// floats of shared memory.
template <typename T, int NV>
__device__ __forceinline__ void norm_row(const Params& p, int row, int lane,
                                         int g, const uint4 (&raw)[NV],
                                         float* part) {
  constexpr int V = 16 / sizeof(T);
  constexpr bool early = NV <= 2;
  const int n = row < p.m ? p.d : 0;
  float gm[NV][V], bt[NV][V];
  if (early) {
#pragma unroll
    for (int k = 0; k < NV; ++k)
      load_params<V>(p, (lane + k * g) * V, n, gm[k], bt[k]);
  }
  float mean = 0.f;
  if (p.kind == rk::NORM_LAYER) {
    float s = 0.f;
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      float f[V];
      widen(fresh(raw[k]), f);
#pragma unroll
      for (int e = 0; e < V; ++e) s += f[e];
    }
    mean = group_sum(s, g, part) / p.d;
  }
  float q = 0.f;
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    const int c0 = (lane + k * g) * V;
    if (c0 >= n) break;
    float f[V];
    widen(fresh(raw[k]), f);
    if (c0 + V <= n) {
#pragma unroll
      for (int e = 0; e < V; ++e) q += (f[e] - mean) * (f[e] - mean);
    } else {
#pragma unroll
      for (int e = 0; e < V; ++e)
        if (c0 + e < n) q += (f[e] - mean) * (f[e] - mean);
    }
  }
  const rk::RowStats st{mean,
                        rsqrtf(group_sum(q, g, part + 32) / p.d + p.eps)};
  T* orow = static_cast<T*>(p.out) + static_cast<long long>(row) * p.d;
  const bool ovec = aligned16(orow);
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    const int c0 = (lane + k * g) * V;
    if (c0 >= n) break;
    if (!early) load_params<V>(p, c0, n, gm[k], bt[k]);
    float f[V];
    widen(fresh(raw[k]), f);
#pragma unroll
    for (int e = 0; e < V; ++e) f[e] = rk::normalize(f[e], st, gm[k][e], bt[k][e]);
    store_slot<V>(orow, c0, n, ovec, f);
  }
}

template <typename T, int NV>
__global__ void __launch_bounds__(MAX_THREADS)
    layernorm_kernel_cta(Params p) {
  __shared__ float part[64];
  uint4 raw[NV];
  load_row<T, NV>(p, blockIdx.x, threadIdx.x, blockDim.x, raw);
  norm_row<T, NV>(p, blockIdx.x, threadIdx.x, blockDim.x, raw, part);
}

template <typename T, int NV>
__global__ void __launch_bounds__(ROWS_MAX_LANES)
    layernorm_kernel_rows(Params p, int g) {
  __shared__ float part[64];
  const int row = blockIdx.x * (blockDim.x / g) + threadIdx.x / g;
  const int lane = threadIdx.x & (g - 1);
  uint4 raw[NV];
  load_row<T, NV>(p, row, lane, g, raw);
  norm_row<T, NV>(p, row, lane, g, raw, part);
}

// A row wider than the registers, one CTA of 1024 threads: the first pass
// reads it from device memory (and, STAGE, keeps it in shared memory);
// the second and third read it again from shared memory, or from L2.
// Each thread reads back only the slots it wrote, so staging needs no
// barrier of its own.
template <typename T, bool STAGE>
__global__ void __launch_bounds__(MAX_THREADS)
    layernorm_kernel_cta_wide(Params p) {
  constexpr int V = 16 / sizeof(T);
  extern __shared__ __align__(16) unsigned char stage_bytes[];
  __shared__ float part[64];
  uint4* stage = reinterpret_cast<uint4*>(stage_bytes);
  const int n = p.d, nvec = (n + V - 1) / V, g = blockDim.x;
  const T* xr = static_cast<const T*>(p.x) + blockIdx.x * p.ldx;
  const bool xvec = aligned16(xr);
  float mean = 0.f;
  if (STAGE || p.kind == rk::NORM_LAYER) {
    float s = 0.f;
#pragma unroll 4
    for (int v = threadIdx.x; v < nvec; v += g) {
      const uint4 r = load_raw(xr, v * V, n, xvec);
      float f[V];
      widen(r, f);
#pragma unroll
      for (int e = 0; e < V; ++e) s += f[e];
      if (STAGE) stage[v] = r;
    }
    if (p.kind == rk::NORM_LAYER) mean = group_sum(s, g, part) / n;
  }
  float q = 0.f;
#pragma unroll 4
  for (int v = threadIdx.x; v < nvec; v += g) {
    float f[V];
    widen(STAGE ? stage[v] : load_raw(xr, v * V, n, xvec), f);
#pragma unroll
    for (int e = 0; e < V; ++e) {
      const float c = v * V + e < n ? f[e] - mean : 0.f;
      q += c * c;
    }
  }
  const rk::RowStats st{mean, rsqrtf(group_sum(q, g, part + 32) / n + p.eps)};
  T* orow = static_cast<T*>(p.out) + static_cast<long long>(blockIdx.x) * n;
  const bool ovec = aligned16(orow);
#pragma unroll 2
  for (int v = threadIdx.x; v < nvec; v += g) {
    float f[V], gm[V], bt[V];
    widen(STAGE ? stage[v] : load_raw(xr, v * V, n, xvec), f);
    load_params<V>(p, v * V, n, gm, bt);
#pragma unroll
    for (int e = 0; e < V; ++e) f[e] = rk::normalize(f[e], st, gm[e], bt[e]);
    store_slot<V>(orow, v * V, n, ovec, f);
  }
}

template <typename T>
cudaError_t launch(const Params& p, bool rows, cudaStream_t s) {
  constexpr int V = 16 / sizeof(T), CTA_SLOTS = CTA_ELEMS / V;
  const int nvec = p.d > 0 ? (p.d + V - 1) / V : 1;
  if (rows) {
    int g = 1;
    while (g * ROWS_SLOTS < nvec) g <<= 1;
    if (g > ROWS_MAX_LANES) return cudaErrorInvalidValue;
    while (2 * g <= nvec && g < ROWS_MAX_LANES &&
           static_cast<long long>(p.m) * g < ROWS_SPREAD)
      g <<= 1;
    const int threads = g > ROWS_MIN_THREADS ? g : ROWS_MIN_THREADS;
    const int ctas = (p.m + threads / g - 1) / (threads / g);
    const int nv = (nvec + g - 1) / g;
    if (nv == 1)
      layernorm_kernel_rows<T, 1><<<ctas, threads, 0, s>>>(p, g);
    else if (nv == 2)
      layernorm_kernel_rows<T, 2><<<ctas, threads, 0, s>>>(p, g);
    else
      layernorm_kernel_rows<T, ROWS_SLOTS><<<ctas, threads, 0, s>>>(p, g);
  } else if (nvec <= CTA_SLOTS * MAX_THREADS) {
    // the fewest slots a thread that fit the row in 1024 threads
    int nv = 1;
    while (nv * MAX_THREADS < nvec) nv <<= 1;
    const int threads = ((nvec + nv - 1) / nv + 31) / 32 * 32;
    if (nv == 1)
      layernorm_kernel_cta<T, 1><<<p.m, threads, 0, s>>>(p);
    else if (nv == 2 || CTA_SLOTS == 2)
      layernorm_kernel_cta<T, 2><<<p.m, threads, 0, s>>>(p);
    else
      layernorm_kernel_cta<T, CTA_SLOTS><<<p.m, threads, 0, s>>>(p);
  } else if (static_cast<long long>(nvec) * 16 <= STAGE_BYTES) {
    const int bytes = nvec * 16;
    if (bytes > 48 * 1024) {
      const cudaError_t err = cudaFuncSetAttribute(
          layernorm_kernel_cta_wide<T, true>,
          cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
      if (err != cudaSuccess) return err;
    }
    layernorm_kernel_cta_wide<T, true><<<p.m, MAX_THREADS, bytes, s>>>(p);
  } else {
    layernorm_kernel_cta_wide<T, false><<<p.m, MAX_THREADS, 0, s>>>(p);
  }
  return cudaGetLastError();
}

}  // namespace

// x (m, d) with row stride ldx (elements), out (m, d) contiguous; gamma
// and beta (d,) read as stored (beta may be null). flags: the norm kind
// (bits 0-1), then F_BF16, F_GAMMA_F32, F_BETA_F32, F_ROWS.
extern "C" int rk_layernorm(const void* x, long long ldx, const void* gamma,
                            const void* beta, void* out, int m, int d,
                            int flags, float eps, void* stream) {
  const Params p{x,    ldx, gamma,
                 beta, out, m,
                 d,    flags & KIND_MASK,
                 (flags & F_GAMMA_F32) != 0,
                 (flags & F_BETA_F32) != 0,
                 eps};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool rows = flags & F_ROWS;
  return static_cast<int>(flags & F_BF16 ? launch<bf16>(p, rows, s)
                                         : launch<float>(p, rows, s));
}

extern "C" const char* rk_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
