// Mamba2's SSD scan (the chunked state-space-duality form) for Hopper, in
// fp32, with the skip term: y = SSD(x, dt, a, B, C; s0) + D x.
//
// Replaces no TPU kernel. The JAX package runs this scan in jnp
// (src/repro/models/mamba2.py::ssd_chunked), and the port ran the same
// chunk loop in torch ops (models/mamba2.py::ssd_chunked, still its plain
// version and the CPU path). It was added because the scan is the largest
// device cost of the Mamba2 layers: the loop built the (B, L, L, H) fp32
// decay-weighted C B^T of every chunk in device memory, several times over,
// and ran its products as fp32 sgemm around them.
//
// Per chunk of L tokens (the last one ragged), per head h with one group
// (B and C shared by the heads), lam_j = dt_j a_h and cs its inclusive sum
// over the chunk:
//   y_i = sum_{j<=i} (C_i . B_j) e^{cs_i - cs_j} dt_j x_j      (intra)
//       + e^{cs_i} C_i S^T                                     (inter)
//       + D_h x_i
//   S'  = e^{cs_L} S + sum_j e^{cs_L - cs_j} dt_j x_j B_j^T    (state)
// x (B, S, H, P), B and C (B, S, N) and dt (B, S, H) are read in place with
// their strides (x, B, C rows 16-byte aligned: the column views of the conv
// output that the mixer holds); y (B, S, H, P) and the final state
// (B, H, P, N) are written contiguous, both fp32.
//
// Bound: operations. Per token, head and layer the scan needs about
// L/2 P (intra, causal) + 2 P N (inter, state) multiply-adds, 24.6 k at
// granite-4.0-h-small's L 256, P 64, N 128, against 1 KB of x and y: some
// 50 FLOP a byte, far above the fp32 FFMA's 20 at 67 TFLOP/s / 3.35 TB/s.
// Everything but x, B, C, dt, y and the states stays on chip. The
// arithmetic is fp32 throughout (expf, fmaf), as in the plain version.
//
// Two launches:
//
// ssd_cb_kernel, per (b, chunk, 64 x 64 tile of the lower triangle):
// CBt[j][i] = B_j . C_i, the part of the intra term that the heads share,
// computed once and not once a head (a head's own would double the layer's
// operations). B^T and C^T tiles sit in shared memory whole (N <= 128).
//
// ssd_scan_kernel, one CTA per (b, h) walking the chunks in order with S on
// chip (S^T in shared memory, so nothing of size states x chunks reaches
// device memory): per chunk,
//   1. dt and cs over the chunk (a scan in shared memory);
//   2. y by 64-row tiles i0 = 0, 64, ..: a product of K-steps of 32 (16
//      at N 16) over the operand pairs
//        (CBt_ij v_j, x_j)      j < i0, v_j = e^{cs_i0 - cs_j} dt_j <= dt_j
//        (e^{cs_i0} C_in, S^T_n)
//      then each row scaled by e^{cs_i - cs_i0} <= 1, then
//        (CBt_ij e^{cs_i - cs_j} dt_j [j <= i], x_j)   i0 <= j < i0 + 64
//      so the blocks above the diagonal are skipped, the off-diagonal blocks
//      take one exp per column rather than one per element, and every factor
//      stays at most 1 (no exp of a positive log decay, which could
//      overflow); then D x added and y written once;
//   3. S' = e^{cs_L} S + x^T W, W_jn = e^{cs_L - cs_j} dt_j B_jn, over K-steps
//      of j; the final state written from registers after the last chunk.
// Both products stage their K-steps through a two-stage ring in shared
// memory, the next step's global loads in flight while the current one
// computes (one barrier a step), with register tiles of 4 x 4 (y, and S: a
// thread's two cells of S at N 128 in turn, as both at once spilled). 84 KB
// of shared memory at P 64, N 128: two CTAs an SM.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int RT = 64;         // rows of a y tile; the C B^T tiles' side
constexpr int LMAX = 256;      // the longest chunk
constexpr int PITCH = RT + 4;  // row pitch of the RT-wide tiles in smem

static_assert(THREADS == LMAX, "a thread per position of the chunk");

struct SsdArgs {
  const float* x;   // (B, S, H, P), unit stride on P
  const float* dt;  // (B, S, H)
  const float* a;   // (H,), negative
  const float* d;   // (H,)
  const float* bm;  // B: (B, S, N), unit stride on N
  const float* cm;  // C: (B, S, N), unit stride on N
  const float* s0;  // (B, H, P, N) contiguous, or null (zeros)
  float* cb;        // (B, nc, lp, lp): the chunks' C B^T, transposed
  float* y;         // (B, S, H, P)
  float* s_fin;     // (B, H, P, N)
  long long sx[3], sdt[3], sb[2], sc[2];  // strides (elements)
  int b, s, h, l, nc;                     // l: the chunk as run
};

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void st4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

__device__ __forceinline__ float at(const float4& v, int q) {
  return q == 0 ? v.x : q == 1 ? v.y : q == 2 ? v.z : v.w;
}

__device__ __forceinline__ float4 scale4(float4 v, float s) {
  return make_float4(v.x * s, v.y * s, v.z * s, v.w * s);
}

__device__ __forceinline__ float4 zero4() {
  return make_float4(0.f, 0.f, 0.f, 0.f);
}

// TR consecutive floats of shared memory, in one vector load where TR is
// 2 or 4 (p aligned to it)
template <int TR>
__device__ __forceinline__ void load_rows(const float* p, float (&v)[TR]) {
  if constexpr (TR == 4) {
    const float4 q = ld4(p);
    v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
  } else if constexpr (TR == 2) {
    const float2 q = *reinterpret_cast<const float2*>(p);
    v[0] = q.x, v[1] = q.y;
  } else {
#pragma unroll
    for (int r = 0; r < TR; ++r) v[r] = p[r];
  }
}

// The padded side of the chunks' C B^T tiles.
__host__ __device__ __forceinline__ int padded(int l) {
  return (l + RT - 1) / RT * RT;
}

template <int N>
constexpr int cb_smem_bytes() {
  return 2 * N * PITCH * static_cast<int>(sizeof(float));
}

// CBt[b][c][j][i] = B_j . C_i over one 64 x 64 tile (tj, ti) of chunk c,
// tj <= ti; positions past the chunk or the sequence read as zero rows.
template <int N>
__global__ void __launch_bounds__(THREADS) ssd_cb_kernel(const SsdArgs a) {
  const int nt = padded(a.l) / RT;
  const int tj = blockIdx.x / nt, ti = blockIdx.x % nt;
  if (tj > ti) return;
  const int c = blockIdx.y, b = blockIdx.z, tid = threadIdx.x;
  const int t0 = c * a.l;
  extern __shared__ float4 smem4[];
  float* bt = reinterpret_cast<float*>(smem4);  // [N][PITCH]: B^T
  float* ct = bt + N * PITCH;                   // [N][PITCH]: C^T
  {
    // thread: row r of both tiles, a quarter of N
    const int r = tid % RT, q = tid / RT;
    const int j = tj * RT + r, i = ti * RT + r;
    const bool vj = j < a.l && t0 + j < a.s, vi = i < a.l && t0 + i < a.s;
    const float* bp = a.bm + b * a.sb[0] + (t0 + j) * a.sb[1];
    const float* cp = a.cm + b * a.sc[0] + (t0 + i) * a.sc[1];
#pragma unroll
    for (int n = q * (N / 4); n < (q + 1) * (N / 4); n += 4) {
      const float4 bv = vj ? ld4(bp + n) : zero4();
      const float4 cv = vi ? ld4(cp + n) : zero4();
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        bt[(n + e) * PITCH + r] = at(bv, e);
        ct[(n + e) * PITCH + r] = at(cv, e);
      }
    }
  }
  __syncthreads();
  const int rg = tid / 16, cg = tid % 16;
  float acc[4][4] = {};
#pragma unroll 8
  for (int n = 0; n < N; ++n) {
    const float4 bv = ld4(bt + n * PITCH + rg * 4);
    const float4 cv = ld4(ct + n * PITCH + cg * 4);
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int q = 0; q < 4; ++q)
        acc[r][q] = fmaf(at(bv, r), at(cv, q), acc[r][q]);
  }
  const int lp = nt * RT;
  float* out = a.cb + ((static_cast<long long>(b) * a.nc + c) * lp +
                       tj * RT + rg * 4) * lp + ti * RT + cg * 4;
#pragma unroll
  for (int r = 0; r < 4; ++r)
    st4(out + r * lp,
        make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]));
}

template <int P, int N>
struct Shape {
  static constexpr int KS = N % 32 == 0 ? 32 : 16;  // the K-step
  static constexpr int TR = P / 16;                 // y rows a thread
  static constexpr int WB = N > PITCH ? N : PITCH;  // an A / W tile's pitch
  static constexpr int FA = KS / 16;                // float4s of an A tile
  static constexpr int XF = KS * P / 4;             // float4s of an x tile
  static constexpr int WF = KS * N / 4;             // float4s of a W tile
  static constexpr int FX = (XF + THREADS - 1) / THREADS;  // ... a thread
  static constexpr int FW = (WF + THREADS - 1) / THREADS;
  static constexpr int NG = N / 4;                  // 4-column groups of S
  // state cells (4 x 4) a thread: 2 at P 64, N 128, else one (or none)
  static constexpr int CPT = P / 4 * NG > THREADS ? P / 4 * NG / THREADS : 1;
  static constexpr int NGT = NG / CPT;              // threads along n
};

template <int P, int N>
struct ScanSmem {
  using G = Shape<P, N>;
  float s[N * P];              // the state, transposed: S^T [n][p]
  float x[2][G::KS * P];       // x tiles [k][p]
  float ab[2][G::KS * G::WB];  // A tiles [k][i] (y), W tiles [k][n] (S)
  float cs[LMAX];              // the chunk's cumulative log decays
  float dt[LMAX];
};

// The K-steps of the y product over a chunk, in order: for each 64-row
// tile, kind 0 (off-diagonal j < i0), kind 1 (the state's n), kind 2 (the
// diagonal block's j); off is the step's first j or n.
struct Cursor {
  int tile, kind, off;

  __device__ bool done(int l) const { return tile * RT >= l; }

  // move past the ranges that hold no step
  __device__ void settle(int l, int n) {
    while (!done(l)) {
      const int i0 = tile * RT;
      const int end = kind == 0 ? i0 : kind == 1 ? n : min(i0 + RT, l);
      if (off < end) return;
      if (kind < 2) {
        ++kind;
        off = kind == 1 ? 0 : i0;
      } else {
        ++tile;
        kind = 0;
        off = 0;
      }
    }
  }

  __device__ void next(int ks, int l, int n) {
    off += ks;
    settle(l, n);
  }
};

template <int P, int N>
__global__ void __launch_bounds__(THREADS, 2) ssd_scan_kernel(const SsdArgs a) {
  using G = Shape<P, N>;
  constexpr int KS = G::KS, TR = G::TR;
  static_assert(P % 16 == 0 && P <= 64 && N % 16 == 0 && N <= 128,
                "P in {16, 32, 64}, N a multiple of 16 up to 128");
  extern __shared__ float4 smem4[];
  ScanSmem<P, N>& sm = *reinterpret_cast<ScanSmem<P, N>*>(smem4);
  const int tid = threadIdx.x;
  const int b = blockIdx.x / a.h, h = blockIdx.x % a.h;
  const int l = a.l, lp = padded(l);
  const float ah = a.a[h], dh = a.d[h];
  const float* xbh = a.x + b * a.sx[0] + h * a.sx[2];
  const float* bb = a.bm + b * a.sb[0];
  const float* cb_b = a.cm + b * a.sc[0];
  float* sfin = a.s_fin + (static_cast<long long>(b) * a.h + h) * P * N;

  for (int e = tid; e < P * N; e += THREADS) {
    const int p = e / N, n = e % N;
    sm.s[n * P + p] =
        a.s0 ? a.s0[(static_cast<long long>(b) * a.h + h) * P * N + e] : 0.f;
  }
  // y: rows rg * TR .., columns cg * 4 ..; S: p from pg * 4, n groups
  // ng0 + c * NGT
  const int cg = tid % (P / 4), rg = tid / (P / 4);
  const int pg = tid / G::NGT, ng0 = tid % G::NGT;
  const bool owns = pg < P / 4;

  for (int c = 0; c < a.nc; ++c) {
    const int t0 = c * l;
    const float* cbc =
        a.cb + (static_cast<long long>(b) * a.nc + c) * lp * lp;
    // x row j of the chunk (j past it or past S: none)
    auto xrow = [&](int j) -> const float* {
      return j < l && t0 + j < a.s ? xbh + (t0 + j) * a.sx[1] : nullptr;
    };

    // 1. dt and the inclusive sums of dt a over the chunk (zeros past it)
    __syncthreads();  // the last chunk is done with cs, dt and s
    {
      float d = 0.f;
      if (tid < l && t0 + tid < a.s)
        d = a.dt[b * a.sdt[0] + (t0 + tid) * a.sdt[1] + h * a.sdt[2]];
      sm.dt[tid] = d;
      sm.cs[tid] = d * ah;
      for (int o = 1; o < LMAX; o <<= 1) {
        __syncthreads();
        const float v = tid >= o ? sm.cs[tid - o] : 0.f;
        __syncthreads();
        sm.cs[tid] += v;
      }
      __syncthreads();
    }

    // 2. y, tile by tile
    {
      float4 ra[G::FA], rx[G::FX];
      float acc[TR][4] = {};
      auto load = [&](const Cursor& q) {
        const int i0 = q.tile * RT;
        if (q.kind == 1) {
          // C^T: a thread takes row i, KS / 4 consecutive n
          const int i = tid % RT, kq = tid / RT;
          const bool ok = i0 + i < l && t0 + i0 + i < a.s;
          const float* p = cb_b + (t0 + i0 + i) * a.sc[1] + q.off +
                           kq * (KS / 4);
#pragma unroll
          for (int f = 0; f < G::FA; ++f) ra[f] = ok ? ld4(p + 4 * f) : zero4();
          return;
        }
#pragma unroll
        for (int f = 0; f < G::FA; ++f) {
          const int e = tid + THREADS * f, k = e / 16, i4 = e % 16 * 4;
          ra[f] = ld4(cbc + static_cast<long long>(q.off + k) * lp + i0 + i4);
        }
#pragma unroll
        for (int f = 0; f < G::FX; ++f) {
          const int e = tid + THREADS * f;
          const float* p = xrow(q.off + e / (P / 4));
          rx[f] = e < G::XF && p ? ld4(p + e % (P / 4) * 4) : zero4();
        }
      };
      auto store = [&](const Cursor& q, int buf) {
        const int i0 = q.tile * RT;
        float* as = sm.ab[buf];
        if (q.kind == 1) {
          const float e0 = expf(sm.cs[i0]);
          const int i = tid % RT, kq = tid / RT;
#pragma unroll
          for (int f = 0; f < G::FA; ++f)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              as[(kq * (KS / 4) + 4 * f + e) * PITCH + i] = at(ra[f], e) * e0;
          return;
        }
#pragma unroll
        for (int f = 0; f < G::FA; ++f) {
          const int e = tid + THREADS * f, k = e / 16, i4 = e % 16 * 4;
          const int j = q.off + k;
          float4 m;
          if (q.kind == 0) {
            m = scale4(ra[f], expf(sm.cs[i0] - sm.cs[j]) * sm.dt[j]);
          } else {
            float v[4];
#pragma unroll
            for (int r = 0; r < 4; ++r) {
              const int i = i0 + i4 + r;
              v[r] = j <= i ? at(ra[f], r) * expf(sm.cs[i] - sm.cs[j]) *
                                  sm.dt[j]
                            : 0.f;
            }
            m = make_float4(v[0], v[1], v[2], v[3]);
          }
          st4(as + k * PITCH + i4, m);
        }
#pragma unroll
        for (int f = 0; f < G::FX; ++f) {
          const int e = tid + THREADS * f;
          if (e < G::XF) st4(sm.x[buf] + e / (P / 4) * P + e % (P / 4) * 4,
                             rx[f]);
        }
      };
      auto epilogue = [&](int tile) {
#pragma unroll
        for (int r = 0; r < TR; ++r) {
          const int i = tile * RT + rg * TR + r;
          const float* xp = xrow(i);
          if (xp) {
            const float4 xv = ld4(xp + cg * 4);
            st4(a.y + ((static_cast<long long>(b) * a.s + t0 + i) * a.h + h) *
                          P + cg * 4,
                make_float4(fmaf(dh, xv.x, acc[r][0]), fmaf(dh, xv.y, acc[r][1]),
                            fmaf(dh, xv.z, acc[r][2]),
                            fmaf(dh, xv.w, acc[r][3])));
          }
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[r][q] = 0.f;
        }
      };

      Cursor cur{0, 0, 0};
      cur.settle(l, N);
      load(cur);
      store(cur, 0);
      __syncthreads();
      for (int buf = 0; !cur.done(l); buf ^= 1) {
        Cursor nx = cur;
        nx.next(KS, l, N);
        const bool more = !nx.done(l);
        if (more) load(nx);
        if (cur.kind == 2 && cur.off == cur.tile * RT) {
          // the first diagonal step: rescale the rows from e^{cs_i0} to
          // e^{cs_i}
          const int i0 = cur.tile * RT;
#pragma unroll
          for (int r = 0; r < TR; ++r) {
            const float u = expf(sm.cs[i0 + rg * TR + r] - sm.cs[i0]);
#pragma unroll
            for (int q = 0; q < 4; ++q) acc[r][q] *= u;
          }
        }
        const float* as = sm.ab[buf];
        const float* bs = cur.kind == 1 ? sm.s + cur.off * P : sm.x[buf];
#pragma unroll 8
        for (int k = 0; k < KS; ++k) {
          float av[TR];
          load_rows<TR>(as + k * PITCH + rg * TR, av);
          const float4 bv = ld4(bs + k * P + cg * 4);
#pragma unroll
          for (int r = 0; r < TR; ++r)
#pragma unroll
            for (int q = 0; q < 4; ++q)
              acc[r][q] = fmaf(av[r], at(bv, q), acc[r][q]);
        }
        if (!more || nx.tile != cur.tile) epilogue(cur.tile);
        if (more) store(nx, buf ^ 1);
        __syncthreads();
        cur = nx;
      }
    }

    // 3. the state: S' = e^{cs_L} S + x^T W, cs_L at the chunk's last
    // position (the sums past it, over zeros, may round otherwise)
    {
      const float last = sm.cs[min(l, a.s - t0) - 1];
      float4 rx[G::FX], rw[G::FW];
      auto load = [&](int j0) {
#pragma unroll
        for (int f = 0; f < G::FX; ++f) {
          const int e = tid + THREADS * f;
          const float* p = xrow(j0 + e / (P / 4));
          rx[f] = e < G::XF && p ? ld4(p + e % (P / 4) * 4) : zero4();
        }
#pragma unroll
        for (int f = 0; f < G::FW; ++f) {
          const int e = tid + THREADS * f, j = j0 + e / (N / 4);
          rw[f] = e < G::WF && j < l && t0 + j < a.s
                      ? ld4(bb + (t0 + j) * a.sb[1] + e % (N / 4) * 4)
                      : zero4();
        }
      };
      auto store = [&](int j0, int buf) {
#pragma unroll
        for (int f = 0; f < G::FX; ++f) {
          const int e = tid + THREADS * f;
          if (e < G::XF) st4(sm.x[buf] + e / (P / 4) * P + e % (P / 4) * 4,
                             rx[f]);
        }
#pragma unroll
        for (int f = 0; f < G::FW; ++f) {
          const int e = tid + THREADS * f, j = j0 + e / (N / 4);
          if (e < G::WF)
            st4(sm.ab[buf] + e / (N / 4) * N + e % (N / 4) * 4,
                scale4(rw[f], expf(last - sm.cs[j]) * sm.dt[j]));
        }
      };
      const int steps = (l + KS - 1) / KS;
      // the thread's cells in turn, each over every K-step
#pragma unroll 1
      for (int cc = 0; cc < G::CPT; ++cc) {
        const int n4 = (ng0 + cc * G::NGT) * 4;
        float acc[4][4];  // [p][n]
        if (owns) {
          const float e = expf(last);
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const float4 sv = ld4(sm.s + (n4 + r) * P + pg * 4);
#pragma unroll
            for (int q = 0; q < 4; ++q) acc[q][r] = e * at(sv, q);
          }
        }
        load(0);
        store(0, 0);
        __syncthreads();
        for (int st = 0; st < steps; ++st) {
          const int buf = st & 1;
          const bool more = st + 1 < steps;
          if (more) load((st + 1) * KS);
          if (owns) {
            const float* xs = sm.x[buf];
            const float* ws = sm.ab[buf];
#pragma unroll 4
            for (int k = 0; k < KS; ++k) {
              const float4 xv = ld4(xs + k * P + pg * 4);
              const float4 wv = ld4(ws + k * N + n4);
#pragma unroll
              for (int q = 0; q < 4; ++q)
#pragma unroll
                for (int r = 0; r < 4; ++r)
                  acc[q][r] = fmaf(at(xv, q), at(wv, r), acc[q][r]);
            }
          }
          if (more) store((st + 1) * KS, buf ^ 1);
          __syncthreads();
        }
        if (owns) {
          // each thread rewrites the cell it alone read above
#pragma unroll
          for (int r = 0; r < 4; ++r)
            st4(sm.s + (n4 + r) * P + pg * 4,
                make_float4(acc[0][r], acc[1][r], acc[2][r], acc[3][r]));
          if (c == a.nc - 1) {
#pragma unroll
            for (int q = 0; q < 4; ++q)
              st4(sfin + (pg * 4 + q) * N + n4,
                  make_float4(acc[q][0], acc[q][1], acc[q][2], acc[q][3]));
          }
        }
      }
    }
  }
}

template <int P, int N>
cudaError_t set_smem() {
  cudaError_t err = cudaFuncSetAttribute(
      ssd_scan_kernel<P, N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(sizeof(ScanSmem<P, N>)));
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(ssd_cb_kernel<N>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              cb_smem_bytes<N>());
}

template <int P, int N>
cudaError_t launch(const SsdArgs& a, cudaStream_t stream) {
  const cudaError_t ready = set_smem<P, N>();
  if (ready != cudaSuccess) return ready;
  const int nt = padded(a.l) / RT;
  ssd_cb_kernel<N><<<dim3(nt * nt, a.nc, a.b), THREADS, cb_smem_bytes<N>(),
                     stream>>>(a);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ssd_scan_kernel<P, N><<<a.b * a.h, THREADS, sizeof(ScanSmem<P, N>),
                          stream>>>(a);
  return cudaGetLastError();
}

template <int P>
cudaError_t launch_n(const SsdArgs& a, int n, cudaStream_t stream) {
  switch (n) {
    case 16: return launch<P, 16>(a, stream);
    case 64: return launch<P, 64>(a, stream);
    case 128: return launch<P, 128>(a, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// strides: (B, S, H) of x, (B, S, H) of dt, (B, S) of B, (B, S) of C (10
// values, in elements); x, B and C have unit stride on their last dim and
// 16-byte aligned rows. cb: scratch of (b, nc, lp, lp) floats, lp the chunk
// rounded up to 64. l: the chunk as run, at most 256; nc = ceil(s / l).
extern "C" int rk_ssd(const void* x, const void* dt, const void* a,
                      const void* d, const void* bm, const void* cm,
                      const void* s0, void* cb, void* y, void* s_fin,
                      const long long* strides, int b, int s, int h, int p,
                      int n, int l, void* stream) {
  SsdArgs g;
  g.x = static_cast<const float*>(x);
  g.dt = static_cast<const float*>(dt);
  g.a = static_cast<const float*>(a);
  g.d = static_cast<const float*>(d);
  g.bm = static_cast<const float*>(bm);
  g.cm = static_cast<const float*>(cm);
  g.s0 = static_cast<const float*>(s0);
  g.cb = static_cast<float*>(cb);
  g.y = static_cast<float*>(y);
  g.s_fin = static_cast<float*>(s_fin);
  for (int i = 0; i < 3; ++i) {
    g.sx[i] = strides[i];
    g.sdt[i] = strides[3 + i];
  }
  for (int i = 0; i < 2; ++i) {
    g.sb[i] = strides[6 + i];
    g.sc[i] = strides[8 + i];
  }
  g.b = b;
  g.s = s;
  g.h = h;
  g.l = l;
  if (l < 1 || l > LMAX) return static_cast<int>(cudaErrorInvalidValue);
  g.nc = (s + l - 1) / l;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (p) {
    case 16: return static_cast<int>(launch_n<16>(g, n, st));
    case 32: return static_cast<int>(launch_n<32>(g, n, st));
    case 64: return static_cast<int>(launch_n<64>(g, n, st));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

namespace {

template <int P, int N>
int query_scan(long long* out) {
  return rk::query_kernel(ssd_scan_kernel<P, N>, THREADS, 2,
                          static_cast<int>(sizeof(ScanSmem<P, N>)), out);
}

}  // namespace

// The kernels and constants of this file, for the shared-memory audit
// (analysis/smem.py): as rk_query_wgmma. Kernels 0-2 the C B^T kernel at
// N = 16, 64, 128; 3-11 the scan at (P, N), P = 16, 32, 64 outer.
extern "C" const char* rk_query_ssd(int i, long long* out, int* err) {
  *err = 0;
  if (i < 0) {
    const long long c[] = {THREADS, RT, LMAX, PITCH};
    return rk::query_constants(c, 4, "THREADS,RT,LMAX,PITCH", out);
  }
  static const char* names[] = {
      "ssd_cb_kernel<16>",        "ssd_cb_kernel<64>",
      "ssd_cb_kernel<128>",       "ssd_scan_kernel<16,16>",
      "ssd_scan_kernel<16,64>",   "ssd_scan_kernel<16,128>",
      "ssd_scan_kernel<32,16>",   "ssd_scan_kernel<32,64>",
      "ssd_scan_kernel<32,128>",  "ssd_scan_kernel<64,16>",
      "ssd_scan_kernel<64,64>",   "ssd_scan_kernel<64,128>"};
  switch (i) {
    case 0: *err = rk::query_kernel(ssd_cb_kernel<16>, THREADS, 1, cb_smem_bytes<16>(), out); break;
    case 1: *err = rk::query_kernel(ssd_cb_kernel<64>, THREADS, 1, cb_smem_bytes<64>(), out); break;
    case 2: *err = rk::query_kernel(ssd_cb_kernel<128>, THREADS, 1, cb_smem_bytes<128>(), out); break;
    case 3: *err = query_scan<16, 16>(out); break;
    case 4: *err = query_scan<16, 64>(out); break;
    case 5: *err = query_scan<16, 128>(out); break;
    case 6: *err = query_scan<32, 16>(out); break;
    case 7: *err = query_scan<32, 64>(out); break;
    case 8: *err = query_scan<32, 128>(out); break;
    case 9: *err = query_scan<64, 16>(out); break;
    case 10: *err = query_scan<64, 64>(out); break;
    case 11: *err = query_scan<64, 128>(out); break;
    default: return nullptr;
  }
  return names[i];
}
