// What the three designs of the row-wise matmul share: the arguments of
// one call, the post-processing unit (the epilogue, in the JAX kernel's
// order), and their launchers, which rk_rowwise_matmul in
// rowwise_matmul.cu picks between.
//
//   skinny  (rowwise_matmul_skinny.cu)  few rows (M <= 16 fp32, <= 4
//           bf16 / int8), bytes-bound: split-K over about one wave of
//           blocks, the last block of a column tile reduces the splits
//           in a fixed order.
//   wgmma   (rowwise_matmul_wgmma.cu)   bf16 and int8 above that: tensor
//           cores fed by a TMA / mbarrier ring, one tile a block; int8,
//           the norm prologue and operands TMA cannot take.
//   persistent (rowwise_matmul_persistent.cu)  the other bf16 calls
//           where the route sends them: a block an SM walking grouped
//           128 x 256 tiles, the epilogue beside the next tile's loads.
//   ffma    (rowwise_matmul.cu)         fp32 above that: exact fp32 FFMA
//           on a register-blocked 64 x 64 tile, double-buffered.
#pragma once

#include "common.cuh"

namespace rk {

// which of the vectors are stored in fp32 (the others are bf16)
enum VecF32 { VEC_BIAS = 1, VEC_BIAS_G = 2, VEC_GAMMA = 4, VEC_BETA = 8 };

struct MatmulArgs {
  const void* x;       // (M, K), row stride ldx
  const void* w;       // (K, N), row stride ldw
  const void* wg;      // gated mode: the second weight, or null
  const void* bias;    // (N,) or null
  const void* bias_g;  // (N,) or null
  const void* res;     // (M, N), row stride ldres, or null
  const void* gamma;   // norm prologue: (K,)
  const void* beta;    // (K,) or null
  const float* x_scale;   // int8: (M, 1)
  const float* w_scale;   // int8: (1, N)
  const float* wg_scale;  // int8 gated: (1, N)
  void* out;           // (M, N), row stride ldout
  void* work;          // skinny: split-K partial sums
  int* counters;       // skinny: arrivals per column tile, left zeroed
  long long ldx, ldw, ldwg, ldres, ldout;
  int m, n, k, norm, act;
  int dtype, res_dt, out_dt;  // DType of x and w, residual, output
  int vec_f32;                // VecF32 bits
  int splits, kc;             // skinny: K splits of kc rows each
  float eps;
};

__device__ __forceinline__ float load_f(const void* p, long long i, int dt) {
  return dt == F32 ? static_cast<const float*>(p)[i]
                   : __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i]);
}

__device__ __forceinline__ void store_f(void* p, long long i, int dt,
                                        float v) {
  if (dt == F32)
    static_cast<float*>(p)[i] = v;
  else
    static_cast<__nv_bfloat16*>(p)[i] = __float2bfloat16(v);
}

// The post-processing unit up to the residual, on the fp32 value of the
// accumulators h (and g, gated) of element (row, col): int8 dequant ->
// bias -> activation, or act(g + bias_g) * (h + bias) -> as
// _apply_epilogue orders it. For int8, h and g are the int32 sums
// converted to fp32 (round to nearest, as astype does).
template <bool GATED, bool INT8>
__device__ __forceinline__ float post(const MatmulArgs& a, float h, float g,
                                      int row, int col) {
  if constexpr (INT8) h = h * a.x_scale[row] * a.w_scale[col];
  if (a.bias) h += vec_at(a.bias, col, a.vec_f32 & VEC_BIAS);
  if constexpr (GATED) {
    if constexpr (INT8) g = g * a.x_scale[row] * a.wg_scale[col];
    if (a.bias_g) g += vec_at(a.bias_g, col, a.vec_f32 & VEC_BIAS_G);
    return activate(g, a.act) * h;
  } else {
    return activate(h, a.act);
  }
}

// The rest of it: the residual in fp32, then the cast and the store.
__device__ __forceinline__ void finish(const MatmulArgs& a, int row, int col,
                                       float h) {
  if (a.res) h += load_f(a.res, row * a.ldres + col, a.res_dt);
  store_f(a.out, row * a.ldout + col, a.out_dt, h);
}

// The norm prologue's gain and shift at column i (shift 0 without beta).
struct Gain {
  float g, b;
};
__device__ __forceinline__ Gain gain(const MatmulArgs& a, int i) {
  return {vec_at(a.gamma, i, a.vec_f32 & VEC_GAMMA),
          a.beta ? vec_at(a.beta, i, a.vec_f32 & VEC_BETA) : 0.f};
}

// A row element normalized with its row's statistics and its column's
// gain, rounded to the streaming type T as the JAX prologue casts the
// normed panel back before the dot.
template <typename T>
__device__ __forceinline__ float norm_elem(float v, RowStats s, Gain g) {
  return round_to<T>(normalize(v, s, g.g, g.b));
}

}  // namespace rk

// The launchers. Errors of a launch are left to cudaGetLastError;
// rk_launch_wgmma and rk_launch_persistent return those of their set-up.
void rk_launch_ffma(const rk::MatmulArgs& a, cudaStream_t stream);
void rk_launch_skinny(const rk::MatmulArgs& a, cudaStream_t stream);
int rk_launch_wgmma(const rk::MatmulArgs& a, cudaStream_t stream);
int rk_launch_persistent(const rk::MatmulArgs& a, cudaStream_t stream);
