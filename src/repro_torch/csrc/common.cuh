// Device code shared by the port's kernels.
//
// rownorm: LayerNorm / RMSNorm of one row with fp32 statistics over the
// true K. It is the counterpart of rownorm in the JAX package
// (src/repro/kernels/layernorm.py), which the TPU shares between the
// standalone norm kernel and the matmul kernel's norm prologue; here too
// both kernels call the same two functions: row_stats (or
// row_stats_rows, several rows at once), then normalize.
//
// activate: the five epilogue activations of the row-wise matmul
// (_ACTIVATIONS in src/repro/kernels/rowwise_matmul.py), GELU in its
// tanh form.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace rk {

enum DType { F32 = 0, BF16 = 1, I8 = 2 };
enum Norm { NORM_NONE = 0, NORM_LAYER = 1, NORM_RMS = 2 };
enum Act { ACT_NONE = 0, ACT_GELU = 1, ACT_SILU = 2, ACT_RELU = 3,
           ACT_RELU2 = 4 };

constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// The value a T operand holds after a cast from fp32.
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f32(from_f32<T>(x));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

struct RowStats {
  float mean;
  float rstd;
};

// Statistics of one row of k values, taken by one whole warp (every lane
// must call it): the mean (0 for RMSNorm), then the mean square of the
// centred row, as the two-pass rownorm does.
template <typename T>
__device__ RowStats row_stats(const T* row, int k, int kind, float eps) {
  const int lane = threadIdx.x & 31;
  float mean = 0.f;
  if (kind == NORM_LAYER) {
    float s = 0.f;
    for (int i = lane; i < k; i += 32) s += to_f32(row[i]);
    mean = warp_sum(s) / k;
  }
  float q = 0.f;
  for (int i = lane; i < k; i += 32) {
    const float c = to_f32(row[i]) - mean;
    q += c * c;
  }
  const float var = warp_sum(q) / k;
  return {mean, rsqrtf(var + eps)};
}

// The statistics of R rows at once, rows row0 .. row0 + R - 1 of x (row
// stride ldx; those at or past m are skipped), by one whole warp: the
// same sums in the same order as row_stats, row by row, but with the R
// rows' loads interleaved so that their latencies overlap. Lane 0 writes
// out[0 .. R-1].
template <int R, typename T>
__device__ void row_stats_rows(const T* x, long long ldx, int row0, int m,
                               int k, int kind, float eps, RowStats* out) {
  const int lane = threadIdx.x & 31;
  float mean[R], q[R];
#pragma unroll
  for (int r = 0; r < R; ++r) mean[r] = q[r] = 0.f;
  if (kind == NORM_LAYER) {
    for (int i = lane; i < k; i += 32)
#pragma unroll
      for (int r = 0; r < R; ++r)
        if (row0 + r < m) mean[r] += to_f32(x[(row0 + r) * ldx + i]);
#pragma unroll
    for (int r = 0; r < R; ++r) mean[r] = warp_sum(mean[r]) / k;
  }
  for (int i = lane; i < k; i += 32)
#pragma unroll
    for (int r = 0; r < R; ++r)
      if (row0 + r < m) {
        const float c = to_f32(x[(row0 + r) * ldx + i]) - mean[r];
        q[r] += c * c;
      }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const float var = warp_sum(q[r]) / k;
    if (lane == 0 && row0 + r < m) out[r] = {mean[r], rsqrtf(var + eps)};
  }
}

// Element i of a vector stored in fp32 (f32 true) or bf16: the kernels
// read biases and norm gains in the dtype the caller keeps them in.
__device__ __forceinline__ float vec_at(const void* v, long long i,
                                        bool f32) {
  return f32 ? static_cast<const float*>(v)[i]
             : __bfloat162float(static_cast<const __nv_bfloat16*>(v)[i]);
}

// One normalized element of a row: (x - mean) * rstd * gamma + beta
// (beta 0 where there is none).
__device__ __forceinline__ float normalize(float x, RowStats s, float gamma,
                                           float beta) {
  return (x - s.mean) * s.rstd * gamma + beta;
}

__device__ __forceinline__ float activate(float x, int act) {
  switch (act) {
    case ACT_GELU: {
      const float c = 0.7978845608028654f;  // sqrt(2 / pi)
      return 0.5f * x * (1.f + tanhf(c * (x + 0.044715f * x * x * x)));
    }
    case ACT_SILU:
      return x / (1.f + expf(-x));
    case ACT_RELU:
      return fmaxf(x, 0.f);
    case ACT_RELU2: {
      const float r = fmaxf(x, 0.f);
      return r * r;
    }
    default:
      return x;
  }
}

}  // namespace rk
