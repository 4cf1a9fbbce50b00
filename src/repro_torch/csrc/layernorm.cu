// Row LayerNorm / RMSNorm for Hopper.
//
// Replaces the TPU kernel layernorm_p (src/repro/kernels/layernorm.py,
// body _norm_kernel, math rownorm): one row panel per grid step there,
// one warp per row here, fp32 statistics over D, optional beta.
//
// Bound: bytes. It reads each row and writes it once (plus gamma/beta),
// a few operations per byte. One warp owns a row, so the three sweeps
// over it (mean, centred square, normalize) read it from device memory
// once and from L1 after; a block of 8 warps keeps 8 rows in flight and
// the grid has M / 8 blocks to fill the 132 SMs.
#include "common.cuh"

namespace {

constexpr int ROWS_PER_BLOCK = 8;

template <typename T>
__global__ void __launch_bounds__(32 * ROWS_PER_BLOCK)
    layernorm_kernel(const T* __restrict__ x, long long ldx,
                     const void* __restrict__ gamma, bool gamma_f32,
                     const void* __restrict__ beta, bool beta_f32,
                     T* __restrict__ out, int m, int d, int kind, float eps) {
  const int row = blockIdx.x * ROWS_PER_BLOCK + threadIdx.x / 32;
  if (row >= m) return;  // whole warps leave together
  const int lane = threadIdx.x & 31;
  const T* xr = x + row * ldx;
  const rk::RowStats s = rk::row_stats(xr, d, kind, eps);
  T* orow = out + static_cast<long long>(row) * d;
  for (int i = lane; i < d; i += 32)
    orow[i] = rk::from_f32<T>(rk::normalize(
        rk::to_f32(xr[i]), s, rk::vec_at(gamma, i, gamma_f32),
        beta ? rk::vec_at(beta, i, beta_f32) : 0.f));
}

template <typename T>
void launch(const void* x, long long ldx, const void* gamma, bool gamma_f32,
            const void* beta, bool beta_f32, void* out, int m, int d,
            int kind, float eps, cudaStream_t stream) {
  const dim3 grid((m + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK);
  layernorm_kernel<T><<<grid, 32 * ROWS_PER_BLOCK, 0, stream>>>(
      static_cast<const T*>(x), ldx, gamma, gamma_f32, beta, beta_f32,
      static_cast<T*>(out), m, d, kind, eps);
}

}  // namespace

// gamma and beta are read in their stored dtype: vec_f32 bit 0 (gamma)
// and bit 1 (beta) mark fp32, else bf16.
extern "C" int rk_layernorm(const void* x, long long ldx, const void* gamma,
                            const void* beta, void* out, int m, int d,
                            int kind, float eps, int dtype, int vec_f32,
                            void* stream) {
  const bool gf = vec_f32 & 1, bf = vec_f32 & 2;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == rk::BF16)
    launch<__nv_bfloat16>(x, ldx, gamma, gf, beta, bf, out, m, d, kind, eps,
                          s);
  else
    launch<float>(x, ldx, gamma, gf, beta, bf, out, m, d, kind, eps, s);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* rk_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
