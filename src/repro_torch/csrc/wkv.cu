// Chunked WKV6 recurrence (RWKV6 "Finch" time-mix) for Hopper.
//
// Replaces the TPU kernel wkv_p (src/repro/kernels/wkv.py, body
// _wkv_kernel). Per (batch, head) it walks the sequence in 16-token
// chunks, holding the state S (P x P, fp32) on chip for the whole
// sequence; per chunk, all in fp32:
//   cs    = inclusive cumsum of the log decays lw, cs_prev = cs - lw
//   rd    = r * exp(cs_prev),  kd = k * exp(-cs)
//   A     = rd @ kd^T, strictly lower triangle, plus the bonus diagonal
//           sum_c r[i,c] u[c] k[i,c]
//   y     = A @ v + rd @ S
//   S     = exp(cs_L) * S + (exp(cs_L - cs) * k)^T @ v
// y is written in the input dtype, the final S in fp32; s0 (optional)
// is the starting state.
//
// Bound: bytes. One launch reads r, k, v, lw once and writes y and S
// once; at B=4, S=512, 40 heads of 64 that is ~84 MB in and ~24 MB out
// (~32 us at 3.35 TB/s) against ~1.7 GFLOP (~25 us at 67 TFLOP/s fp32).
//
// Design, against what the TPU kernel relied on:
//  * The TPU grid walked the chunks of one (b, h) in order, innermost,
//    with S in VMEM scratch. Here a loop inside the block walks the
//    chunks and S stays in registers (each thread owns P/16 entries)
//    with a copy in shared memory for the rd @ S product.
//  * B x H blocks would leave most of the 132 SMs idle at B=1 (40
//    heads). Column q of S evolves on its own (y[:, q] reads only
//    S[:, q] and v[:, q]), so a block owns a P x 16 slice of S: P/16
//    blocks per (b, h), each recomputing the chunk's 16 x 16 matrix A
//    (cheap beside the P x 16 products). Neighbouring blocks share
//    their (b, h), so the repeated r/k/lw reads come from L2.
//  * r, k, v, lw are read in place with their (B, S, H, P) strides:
//    the TPU wrapper transposed them to (B*H, S, P) in HBM; no copy
//    here.
//  * The TPU wrapper padded the ragged tail in HBM with lw = 0. Here
//    the loads past S read r = k = v = 0 and lw = 0, which leaves y and
//    the final S exact, and the stores past S are skipped.
//  * The next chunk's operands are loaded into registers while the
//    current chunk computes, so the global load latency hides behind
//    the chunk's arithmetic.
// Tensor cores (mma.sync on the 16 x P x 16 products) and cp.async
// double-buffering are later work. expf, not __expf: exp(-cs) reaches
// exp(56) inside a chunk and must keep fp32 accuracy.
#include "common.cuh"

namespace {

constexpr int L = 16;         // tokens per chunk
constexpr int QT = 16;        // value columns of S per block
constexpr int THREADS = 256;  // = L * L = L * QT

struct WkvArgs {
  const void* r;
  const void* k;
  const void* v;
  const void* lw;
  const float* u;
  const float* s0;
  void* y;
  float* s_fin;
  long long sr[3], sk[3], sv[3], sw[3];  // (B, S, H) strides, in elements
  int b, s, h;
};

template <typename T, int P>
__global__ void __launch_bounds__(THREADS) wkv_kernel(const WkvArgs a) {
  static_assert(P % QT == 0 && THREADS % P == 0, "P in {16, 32, 64}");
  constexpr int NQ = P / QT;           // blocks per (b, h)
  constexpr int G = THREADS / P;       // token groups of the element pass
  constexpr int TPG = L / G;           // tokens per group
  constexpr int SPT = P * QT / THREADS;  // S entries per thread
  constexpr int PAD = P + 1;           // conflict-free columns

  __shared__ float cs_s[G][P];         // group totals of lw
  __shared__ float rd_s[L][PAD], kd_s[L][PAD], tk_s[L][PAD], ruk_s[L][PAD];
  __shared__ float v_s[L][QT];
  __shared__ float a_s[L][L + 1];
  __shared__ float s_s[P][QT];
  __shared__ float dec_s[P];

  const int bh = blockIdx.x / NQ, q0 = (blockIdx.x % NQ) * QT;
  const int b = bh / a.h, hh = bh % a.h;
  const int tid = threadIdx.x;

  // element pass: channel c, tokens g * TPG + j
  const int c = tid % P, g = tid / P;
  // v tile, A entry and y entry: row tid / 16, column tid % 16
  const int ti = tid / QT, tq = tid % QT;

  const T* r = static_cast<const T*>(a.r);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const T* lw = static_cast<const T*>(a.lw);
  const long long r0 = b * a.sr[0] + hh * a.sr[2] + c;
  const long long k0 = b * a.sk[0] + hh * a.sk[2] + c;
  const long long w0 = b * a.sw[0] + hh * a.sw[2] + c;
  const long long v0 = b * a.sv[0] + hh * a.sv[2] + q0 + tq;
  const float uc = a.u[hh * P + c];

  // this thread's S entries: rows sc(m) = tid / QT + m * (THREADS / QT),
  // column tq
  float sreg[SPT];
  const long long sbase = (static_cast<long long>(bh) * P) * P + q0 + tq;
#pragma unroll
  for (int m = 0; m < SPT; ++m) {
    const int sc = ti + m * (THREADS / QT);
    sreg[m] = a.s0 ? a.s0[sbase + static_cast<long long>(sc) * P] : 0.f;
    s_s[sc][tq] = sreg[m];
  }

  float pr[TPG], pk[TPG], pw[TPG], pv;
  auto load = [&](int t0) {
#pragma unroll
    for (int j = 0; j < TPG; ++j) {
      const int t = t0 + g * TPG + j;
      const bool in = t < a.s;
      pr[j] = in ? rk::to_f32(r[r0 + t * a.sr[1]]) : 0.f;
      pk[j] = in ? rk::to_f32(k[k0 + t * a.sk[1]]) : 0.f;
      pw[j] = in ? rk::to_f32(lw[w0 + t * a.sw[1]]) : 0.f;
    }
    const int t = t0 + ti;
    pv = t < a.s ? rk::to_f32(v[v0 + t * a.sv[1]]) : 0.f;
  };

  load(0);
  const int n_chunks = (a.s + L - 1) / L;
  for (int ci = 0; ci < n_chunks; ++ci) {
    const int t0 = ci * L;
    float rr[TPG], kk[TPG], ww[TPG], loc[TPG];
#pragma unroll
    for (int j = 0; j < TPG; ++j) {
      rr[j] = pr[j];
      kk[j] = pk[j];
      ww[j] = pw[j];
      loc[j] = (j ? loc[j - 1] : 0.f) + ww[j];
    }
    v_s[ti][tq] = pv;
    cs_s[g][c] = loc[TPG - 1];
    if (ci + 1 < n_chunks) load(t0 + L);  // in flight during this chunk
    __syncthreads();

    // cumsums from the group totals, then the decayed operands
    float off = 0.f;
    for (int gg = 0; gg < g; ++gg) off += cs_s[gg][c];
    float cl = off;
    for (int gg = g; gg < G; ++gg) cl += cs_s[gg][c];
#pragma unroll
    for (int j = 0; j < TPG; ++j) {
      const int i = g * TPG + j;
      const float cs = off + loc[j];
      const float cs_prev = cs - ww[j];
      rd_s[i][c] = rr[j] * expf(cs_prev);
      kd_s[i][c] = kk[j] * expf(-cs);
      tk_s[i][c] = expf(cl - cs) * kk[j];
      ruk_s[i][c] = rr[j] * uc * kk[j];
    }
    if (g == 0) dec_s[c] = expf(cl);
    __syncthreads();

    // A[i][j]: strictly lower triangle, bonus term on the diagonal
    {
      const int i = ti, j = tq;
      float acc = 0.f;
      if (j < i) {
#pragma unroll 16
        for (int cc = 0; cc < P; ++cc) acc = fmaf(rd_s[i][cc], kd_s[j][cc], acc);
      } else if (j == i) {
#pragma unroll 16
        for (int cc = 0; cc < P; ++cc) acc += ruk_s[i][cc];
      }
      a_s[i][j] = acc;
    }
    __syncthreads();

    // y[i][q] = (A @ v)[i][q] + (rd @ S)[i][q]
    {
      const int i = ti, q = tq;
      float intra = 0.f, inter = 0.f;
      for (int j = 0; j <= i; ++j) intra = fmaf(a_s[i][j], v_s[j][q], intra);
#pragma unroll 16
      for (int cc = 0; cc < P; ++cc) inter = fmaf(rd_s[i][cc], s_s[cc][q], inter);
      const int t = t0 + i;
      if (t < a.s) {
        const long long o =
            ((static_cast<long long>(b) * a.s + t) * a.h + hh) * P + q0 + q;
        static_cast<T*>(a.y)[o] = rk::from_f32<T>(intra + inter);
      }
    }
    __syncthreads();  // every read of the old S is done

    // S[c][q] = exp(cs_L[c]) S[c][q] + sum_j tk[j][c] v[j][q]
#pragma unroll
    for (int m = 0; m < SPT; ++m) {
      const int sc = ti + m * (THREADS / QT);
      float kv = 0.f;
#pragma unroll
      for (int j = 0; j < L; ++j) kv = fmaf(tk_s[j][sc], v_s[j][tq], kv);
      sreg[m] = dec_s[sc] * sreg[m] + kv;
      s_s[sc][tq] = sreg[m];
    }
    __syncthreads();
  }

#pragma unroll
  for (int m = 0; m < SPT; ++m) {
    const int sc = ti + m * (THREADS / QT);
    a.s_fin[sbase + static_cast<long long>(sc) * P] = sreg[m];
  }
}

template <typename T, int P>
void launch(const WkvArgs& a, cudaStream_t stream) {
  const int blocks = a.b * a.h * (P / QT);
  wkv_kernel<T, P><<<blocks, THREADS, 0, stream>>>(a);
}

template <typename T>
int launch_p(const WkvArgs& a, int p, cudaStream_t stream) {
  switch (p) {
    case 16: launch<T, 16>(a, stream); break;
    case 32: launch<T, 32>(a, stream); break;
    case 64: launch<T, 64>(a, stream); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// strides: (B, S, H) strides of r, k, v, lw in turn (12 values); the
// head dim has unit stride. y is written contiguous (B, S, H, P).
extern "C" int rk_wkv(const void* r, const void* k, const void* v,
                      const void* lw, const void* u, const void* s0, void* y,
                      void* s_fin, const long long* strides, int b, int s,
                      int h, int p, int dtype, void* stream) {
  WkvArgs a;
  a.r = r;
  a.k = k;
  a.v = v;
  a.lw = lw;
  a.u = static_cast<const float*>(u);
  a.s0 = static_cast<const float*>(s0);
  a.y = y;
  a.s_fin = static_cast<float*>(s_fin);
  for (int i = 0; i < 3; ++i) {
    a.sr[i] = strides[i];
    a.sk[i] = strides[3 + i];
    a.sv[i] = strides[6 + i];
    a.sw[i] = strides[9 + i];
  }
  a.b = b;
  a.s = s;
  a.h = h;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == rk::BF16) return launch_p<__nv_bfloat16>(a, p, st);
  return launch_p<float>(a, p, st);
}
