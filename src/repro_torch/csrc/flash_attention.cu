// Flash attention (online softmax) for Hopper.
//
// Replaces the TPU kernel flash_attention_p
// (src/repro/kernels/flash_attention.py, body _attn_kernel): q (B,Hq,Sq,hd),
// k/v (B,Hkv,Skv,hd); causal mask, sliding window, GQA (query head h reads
// kv head h / (Hq/Hkv)), a query offset, keys past Skv masked, and an
// additive fp32 score bias (nb,Hq,Sq,Skv) that batch b reads at row b % nb.
// Masked scores are -1e30, the denominator is floored at 1e-30, and the
// probabilities are rounded to the value dtype before the PV product, as
// on the TPU.
//
// Design: one block holds 64 query rows of one (batch, head) stationary,
// hd / 16 threads per row with 16 dims each in registers (partial dots
// summed by warp shuffles), and streams K/V tiles of 32 keys through
// shared memory. Scores are taken 16 keys at a time into registers; the
// running max and sum are rescaled once per 16 keys. The block loops
// only over the keys its rows can see (the causal diagonal and the
// window bound the range), which is the TPU kernel's block skipping.
// The TPU's head-major grid order kept one bias block resident in VMEM;
// here the bias is read through L1/L2 and needs no reordering.
//
// Bound: at Swin's 49-token windows, operations on the CUDA cores (fp32
// FFMA for the two products) and the per-key exp; the Sq x Skv scores
// never reach device memory. q, k, v and the bias are read with their
// strides, so head views of a fused qkv output need no copy.
#include "common.cuh"

namespace {

constexpr int BQ = 64;   // query rows per block
constexpr int BKV = 32;  // keys per shared-memory tile
constexpr int CH = 16;   // keys per register chunk of scores
constexpr int DPT = 16;  // head dims per thread

struct AttnArgs {
  const void* q;
  const void* k;
  const void* v;
  const float* bias;
  void* out;
  long long B, Hq, Hkv, Sq, Skv, nb;
  long long sqb, sqh, sqs, skb, skh, sks, svb, svh, svs;
  long long sbn, sbh, sbq, sbk;
  float scale;
  int causal, window, q_offset;
};

template <typename T, int HD>
__global__ void __launch_bounds__(BQ * (HD / DPT))
    attention_kernel(const AttnArgs a) {
  constexpr int TPR = HD / DPT;  // threads per query row
  __shared__ __align__(16) float ks[BKV][HD];
  __shared__ __align__(16) float vs[BKV][HD];

  const int bh = blockIdx.x;
  const int b = bh / a.Hq, h = bh % a.Hq;
  const int hk = h / (a.Hq / a.Hkv);
  const int q0 = blockIdx.y * BQ;
  const int row = threadIdx.x / TPR, part = threadIdx.x % TPR;
  const int qi = q0 + row;
  const bool valid = qi < a.Sq;
  const int q_pos = qi + a.q_offset;

  float qv[DPT];
  {
    const T* qp = static_cast<const T*>(a.q) + b * a.sqb + h * a.sqh +
                  static_cast<long long>(qi) * a.sqs + part * DPT;
#pragma unroll
    for (int d = 0; d < DPT; ++d) qv[d] = valid ? rk::to_f32(qp[d]) : 0.f;
  }
  const T* kp = static_cast<const T*>(a.k) + b * a.skb + hk * a.skh;
  const T* vp = static_cast<const T*>(a.v) + b * a.svb + hk * a.svh;
  const float* bp = (a.bias && valid)
                        ? a.bias + (b % a.nb) * a.sbn + h * a.sbh +
                              static_cast<long long>(qi) * a.sbq
                        : nullptr;

  // Keys any row of this block can see.
  int lo = 0, hi = static_cast<int>(a.Skv);
  const int last_pos =
      static_cast<int>(min(static_cast<long long>(q0 + BQ), a.Sq)) - 1 +
      a.q_offset;
  if (a.causal) hi = min(hi, last_pos + 1);
  if (a.window > 0) lo = max(0, q0 + a.q_offset - a.window + 1);

  float m_run = rk::NEG_INF, l_run = 0.f, acc[DPT] = {};
  for (int k0 = lo; k0 < hi; k0 += BKV) {
    const int nk = min(BKV, hi - k0);
    for (int i = threadIdx.x; i < BKV * HD; i += blockDim.x) {
      const int j = i / HD, d = i % HD;
      const bool in = j < nk;
      ks[j][d] = in ? rk::to_f32(kp[(k0 + j) * a.sks + d]) : 0.f;
      vs[j][d] = in ? rk::to_f32(vp[(k0 + j) * a.svs + d]) : 0.f;
    }
    __syncthreads();
    for (int c0 = 0; c0 < nk; c0 += CH) {
      float s[CH];
      unsigned keep_bits = 0u;
      float mx = rk::NEG_INF;
#pragma unroll
      for (int j = 0; j < CH; ++j) {
        const float* kr = &ks[c0 + j][part * DPT];
        float dot = 0.f;
#pragma unroll
        for (int d = 0; d < DPT; ++d) dot = fmaf(qv[d], kr[d], dot);
#pragma unroll
        for (int o = TPR / 2; o > 0; o >>= 1)
          dot += __shfl_xor_sync(0xffffffffu, dot, o);
        const int kj = k0 + c0 + j;
        bool keep = valid && c0 + j < nk;
        if (a.causal) keep = keep && kj <= q_pos;
        if (a.window > 0) keep = keep && kj > q_pos - a.window;
        float sc = dot * a.scale;
        if (keep && bp) sc += bp[kj * a.sbk];
        s[j] = keep ? sc : rk::NEG_INF;
        keep_bits |= keep ? (1u << j) : 0u;
        mx = fmaxf(mx, s[j]);
      }
      const float m_new = fmaxf(m_run, mx);
      const float alpha = expf(m_run - m_new);
      l_run *= alpha;
#pragma unroll
      for (int d = 0; d < DPT; ++d) acc[d] *= alpha;
#pragma unroll
      for (int j = 0; j < CH; ++j) {
        const float p = ((keep_bits >> j) & 1u) ? expf(s[j] - m_new) : 0.f;
        l_run += p;
        const float pr = rk::round_to<T>(p);
        const float* vr = &vs[c0 + j][part * DPT];
#pragma unroll
        for (int d = 0; d < DPT; ++d) acc[d] = fmaf(pr, vr[d], acc[d]);
      }
      m_run = m_new;
    }
    __syncthreads();
  }

  if (valid) {
    const float l = fmaxf(l_run, 1e-30f);
    T* op = static_cast<T*>(a.out) +
            ((static_cast<long long>(bh) * a.Sq + qi) * HD + part * DPT);
#pragma unroll
    for (int d = 0; d < DPT; ++d) op[d] = rk::from_f32<T>(acc[d] / l);
  }
}

template <typename T, int HD>
void launch(const AttnArgs& a, cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>(a.B * a.Hq),
                  static_cast<unsigned>((a.Sq + BQ - 1) / BQ));
  attention_kernel<T, HD><<<grid, BQ * (HD / DPT), 0, stream>>>(a);
}

template <typename T>
bool dispatch(const AttnArgs& a, long long hd, cudaStream_t stream) {
  switch (hd) {
    case 16: launch<T, 16>(a, stream); return true;
    case 32: launch<T, 32>(a, stream); return true;
    case 64: launch<T, 64>(a, stream); return true;
    case 128: launch<T, 128>(a, stream); return true;
    default: return false;
  }
}

}  // namespace

// d: B, Hq, Hkv, Sq, Skv, nb, then the batch/head/row strides of q, k and
// v (3 each), the four bias strides, and hd.
extern "C" int rk_flash_attention(const void* q, const void* k, const void* v,
                                  const void* bias, void* out,
                                  const long long* d, float scale,
                                  int causal, int window, int q_offset,
                                  int dtype, void* stream) {
  AttnArgs a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.bias = static_cast<const float*>(bias);
  a.out = out;
  a.B = d[0];
  a.Hq = d[1];
  a.Hkv = d[2];
  a.Sq = d[3];
  a.Skv = d[4];
  a.nb = d[5] > 0 ? d[5] : 1;
  a.sqb = d[6];
  a.sqh = d[7];
  a.sqs = d[8];
  a.skb = d[9];
  a.skh = d[10];
  a.sks = d[11];
  a.svb = d[12];
  a.svh = d[13];
  a.svs = d[14];
  a.sbn = d[15];
  a.sbh = d[16];
  a.sbq = d[17];
  a.sbk = d[18];
  a.scale = scale;
  a.causal = causal;
  a.window = window;
  a.q_offset = q_offset;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool ok = dtype == rk::BF16 ? dispatch<__nv_bfloat16>(a, d[19], s)
                                    : dispatch<float>(a, d[19], s);
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
