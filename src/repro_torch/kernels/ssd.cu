// Mamba-2 SSD chunked scan for Hopper (sm_90a), plain FP32 FMA arithmetic.
//
// Replaces the Pallas TPU kernel src/repro/kernels/ssd.py (`ssd`, body
// `_ssd_kernel`): the same function — per chunk of Q steps, with
// da = -dt*a and cum its inclusive prefix sum,
//   y     = (C Bᵀ ∘ exp(cum[q] - cum[s]) [s <= q] ∘ dt[s]) x
//         + (C ∘ exp(cum)) stateᵀ
//   state = exp(cum[Q-1]) state + (x ∘ dt exp(cum[Q-1] - cum))ᵀ B
// with the (P, N) state in f32 carried from chunk to chunk, B/C group
// h / (H/G) for head h, y in x's dtype and the final state in f32 — but not
// its blocking.
//
// What bounds it: at the Mamba-2-1.3B prefill shape (B=4, L=1024, H=64,
// P=64, N=128, Q=128, G=1, f32) the work the function needs is the causal
// triangle of C·Bᵀ once per (batch, group, chunk), and per (batch, head,
// chunk) the scores·x triangle, the state update and C·stateᵀ (none in
// the first chunk): 10.3 GFLOP against 148 MB of inputs and outputs, 70
// FLOP per byte, above the ~20 FLOP/byte where the card's FP32
// (non-tensor) rate and its HBM rate cross: it is bound by operations.
// This first version recomputes C·Bᵀ for every head and spends the work on
// plain FMAs (no wgmma, TMA or warp specialization).
//
// Design: one block of 256 threads per (64-column slice of the head dim,
// head, batch), looping over the chunks in order — Hopper blocks run in no
// order, so the loop takes the place of the TPU grid's sequential chunk
// axis, and the state stays in shared memory between chunks.  Per chunk the
// block stages B, C (Q x N), x (Q x 64) and dt in shared memory, zero for
// steps past L (dt = 0 is state-neutral, so a ragged tail needs no second
// path).  The Q x Q score matrix (64 KB at Q=128) does not fit beside them,
// so scores are made and used in tiles of 32 rows; columns past a tile's
// last row are zero by causality and are skipped.  The decay exp(cum[q] -
// cum[s]) is evaluated only where s <= q: above the diagonal the exponent
// is positive and could overflow to inf, and inf*0 would be NaN.  Each
// thread owns a 16-strided micro-tile of every product (8x4 of y, 2x8 of a
// score tile, 4x8 of the state), so a warp reads one or two broadcast rows
// of one operand and 16 consecutive words of the other; shared-memory rows
// have odd strides, which keeps both patterns free of bank conflicts.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int QMAX = 128;   // chunk length, at most
constexpr int NMAX = 128;   // d_state, at most
constexpr int PT = 64;      // head-dim columns per block
constexpr int RT = 32;      // score rows per tile
constexpr int TX = 16;      // thread grid: TX columns x TY rows
constexpr int TY = 16;
constexpr int THREADS = TX * TY;
constexpr int SN = NMAX + 1;  // row strides (odd)
constexpr int SP = PT + 1;
constexpr int SQ = QMAX + 1;
constexpr int SMEM_FLOATS =
    2 * QMAX * SN + QMAX * SP + RT * SQ + PT * SN + 4 * QMAX + 4;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

struct Args {
  const void* x;    // (B, L, H, P), unit stride on P
  const float* dt;  // (B, L, H)
  const float* a;   // (H,) decay rates, contiguous
  const void* b;    // (B, L, G, N), unit stride on N
  const void* c;    // (B, L, G, N), unit stride on N
  void* y;          // (B, L, H, P), contiguous
  float* hT;        // (B, H, P, N), contiguous
  int B, L, H, P, G, N, Q;
  long long sxb, sxl, sxh, sdb, sdl, sdh, sbb, sbl, sbg, scb, scl, scg;
};

template <typename T>
__global__ void __launch_bounds__(THREADS, 1) ssd_chunk_scan(const Args a) {
  extern __shared__ float smem[];
  float* Bs = smem;              // Q x N
  float* Cs = Bs + QMAX * SN;    // Q x N
  float* Xs = Cs + QMAX * SN;    // Q x PT
  float* Ss = Xs + QMAX * SP;    // RT x Q, one tile of scores
  float* St = Ss + RT * SQ;      // PT x N, the carried state
  float* cum = St + PT * SN;     // Q
  float* dtv = cum + QMAX;       // Q
  float* ecum = dtv + QMAX;      // Q: exp(cum)
  float* wq = ecum + QMAX;       // Q: dt * exp(total - cum)
  float* total = wq + QMAX;      // 1

  const int tid = threadIdx.x;
  const int tx = tid % TX, ty = tid / TX;
  const int p0 = blockIdx.x * PT;
  const int h = blockIdx.y;
  const int bi = blockIdx.z;
  const int g = h / (a.H / a.G);
  const int Q = a.Q, N = a.N, L = a.L;
  const int pn = min(PT, a.P - p0);
  const float rate = a.a[h];

  const T* xp = static_cast<const T*>(a.x) + bi * a.sxb + h * a.sxh + p0;
  const float* dtp = a.dt + bi * a.sdb + h * a.sdh;
  const T* bp = static_cast<const T*>(a.b) + bi * a.sbb + g * a.sbg;
  const T* cp = static_cast<const T*>(a.c) + bi * a.scb + g * a.scg;
  T* yp = static_cast<T*>(a.y);

  for (int i = tid; i < PT * SN; i += THREADS) St[i] = 0.f;

  const int nchunks = (L + Q - 1) / Q;
  for (int z = 0; z < nchunks; ++z) {
    const int l0 = z * Q;
    __syncthreads();  // every thread is done with the previous chunk
    for (int i = tid; i < Q * N; i += THREADS) {
      const int q = i / N, n = i - q * N;
      const int l = l0 + q;
      const bool in = l < L;
      Bs[q * SN + n] = in ? to_f32(bp[l * a.sbl + n]) : 0.f;
      Cs[q * SN + n] = in ? to_f32(cp[l * a.scl + n]) : 0.f;
    }
    for (int i = tid; i < Q * PT; i += THREADS) {
      const int q = i / PT, p = i - q * PT;
      const int l = l0 + q;
      Xs[q * SP + p] = (l < L && p < pn) ? to_f32(xp[l * a.sxl + p]) : 0.f;
    }
    for (int q = tid; q < Q; q += THREADS)
      dtv[q] = l0 + q < L ? dtp[(l0 + q) * a.sdl] : 0.f;
    __syncthreads();

    // Inclusive prefix sum of da = -dt*a over the chunk: warp 0, four
    // consecutive steps per lane.
    if (tid < 32) {
      float v[QMAX / 32];
      float run = 0.f;
#pragma unroll
      for (int k = 0; k < QMAX / 32; ++k) {
        const int q = tid * (QMAX / 32) + k;
        run += q < Q ? -dtv[q] * rate : 0.f;
        v[k] = run;
      }
      float incl = run;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float t = __shfl_up_sync(0xffffffffu, incl, off);
        if (tid >= off) incl += t;
      }
      float excl = __shfl_up_sync(0xffffffffu, incl, 1);
      if (tid == 0) excl = 0.f;
      const float tot = __shfl_sync(0xffffffffu, incl, 31);
#pragma unroll
      for (int k = 0; k < QMAX / 32; ++k) {
        const int q = tid * (QMAX / 32) + k;
        if (q < Q) {
          const float cq = excl + v[k];
          cum[q] = cq;
          ecum[q] = expf(cq);
          wq[q] = dtv[q] * expf(tot - cq);
        }
      }
      if (tid == 0) total[0] = tot;
    }
    __syncthreads();

    // y rows ty + 16i, columns tx + 16j.  Inter-chunk term first:
    // exp(cum[q]) * sum_n C[q, n] state[p, n] (zero in the first chunk).
    float acc[QMAX / TY][PT / TX];
#pragma unroll
    for (int i = 0; i < QMAX / TY; ++i)
#pragma unroll
      for (int j = 0; j < PT / TX; ++j) acc[i][j] = 0.f;
    if (z > 0) {
      for (int n = 0; n < N; ++n) {
        float cv[QMAX / TY], sv[PT / TX];
#pragma unroll
        for (int i = 0; i < QMAX / TY; ++i) cv[i] = Cs[(ty + TY * i) * SN + n];
#pragma unroll
        for (int j = 0; j < PT / TX; ++j) sv[j] = St[(tx + TX * j) * SN + n];
#pragma unroll
        for (int i = 0; i < QMAX / TY; ++i)
#pragma unroll
          for (int j = 0; j < PT / TX; ++j)
            acc[i][j] = fmaf(cv[i], sv[j], acc[i][j]);
      }
#pragma unroll
      for (int i = 0; i < QMAX / TY; ++i) {
        const int q = ty + TY * i;
        const float e = q < Q ? ecum[q] : 0.f;
#pragma unroll
        for (int j = 0; j < PT / TX; ++j) acc[i][j] *= e;
      }
    }

    // Intra-chunk term, one tile of RT score rows at a time.
#pragma unroll
    for (int rt = 0; rt < QMAX / RT; ++rt) {
      const int r0 = rt * RT;
      if (r0 < Q) {  // uniform over the block
        const int smax = min(Q, r0 + RT);  // later columns are masked
        float s[RT / TY][QMAX / TX];
#pragma unroll
        for (int ii = 0; ii < RT / TY; ++ii)
#pragma unroll
          for (int j = 0; j < QMAX / TX; ++j) s[ii][j] = 0.f;
        for (int n = 0; n < N; ++n) {
          float cv[RT / TY], bv[QMAX / TX];
#pragma unroll
          for (int ii = 0; ii < RT / TY; ++ii)
            cv[ii] = Cs[(r0 + ty + TY * ii) * SN + n];
#pragma unroll
          for (int j = 0; j < QMAX / TX; ++j)
            bv[j] = TX * j < smax ? Bs[(tx + TX * j) * SN + n] : 0.f;
#pragma unroll
          for (int ii = 0; ii < RT / TY; ++ii)
#pragma unroll
            for (int j = 0; j < QMAX / TX; ++j)
              if (TX * j < smax) s[ii][j] = fmaf(cv[ii], bv[j], s[ii][j]);
        }
#pragma unroll
        for (int ii = 0; ii < RT / TY; ++ii) {
          const int q = r0 + ty + TY * ii;
#pragma unroll
          for (int j = 0; j < QMAX / TX; ++j) {
            const int sc = tx + TX * j;
            if (TX * j < smax) {
              float v = 0.f;
              if (sc <= q && sc < Q && q < Q)
                v = s[ii][j] * expf(cum[q] - cum[sc]) * dtv[sc];
              Ss[(ty + TY * ii) * SQ + sc] = v;
            }
          }
        }
        __syncthreads();
        // rows r0 + ty + 16ii are y rows ty + 16(2rt + ii)
        for (int sc = 0; sc < smax; ++sc) {
          float sv[RT / TY], xv[PT / TX];
#pragma unroll
          for (int ii = 0; ii < RT / TY; ++ii) sv[ii] = Ss[(ty + TY * ii) * SQ + sc];
#pragma unroll
          for (int j = 0; j < PT / TX; ++j) xv[j] = Xs[sc * SP + tx + TX * j];
#pragma unroll
          for (int ii = 0; ii < RT / TY; ++ii)
#pragma unroll
            for (int j = 0; j < PT / TX; ++j)
              acc[rt * (RT / TY) + ii][j] =
                  fmaf(sv[ii], xv[j], acc[rt * (RT / TY) + ii][j]);
        }
        __syncthreads();  // before the next tile overwrites Ss
      }
    }

#pragma unroll
    for (int i = 0; i < QMAX / TY; ++i) {
      const int q = ty + TY * i;
      const int l = l0 + q;
      if (q < Q && l < L) {
        T* row = yp + ((static_cast<long long>(bi) * L + l) * a.H + h) * a.P + p0;
#pragma unroll
        for (int j = 0; j < PT / TX; ++j) {
          const int p = tx + TX * j;
          if (p < pn) store(row + p, acc[i][j]);
        }
      }
    }

    // State update: state[p, n] = exp(total) state[p, n]
    //   + sum_q (dt[q] exp(total - cum[q]) x[q, p]) B[q, n];
    // state rows ty + 16i, columns tx + 16j.  St was last read before the
    // first __syncthreads of the tile loop above.
    float u[PT / TY][NMAX / TX];
#pragma unroll
    for (int i = 0; i < PT / TY; ++i)
#pragma unroll
      for (int j = 0; j < NMAX / TX; ++j) u[i][j] = 0.f;
    for (int q = 0; q < Q; ++q) {
      const float w = wq[q];
      float xv[PT / TY], bv[NMAX / TX];
#pragma unroll
      for (int i = 0; i < PT / TY; ++i) xv[i] = Xs[q * SP + ty + TY * i] * w;
#pragma unroll
      for (int j = 0; j < NMAX / TX; ++j)
        bv[j] = TX * j < N ? Bs[q * SN + tx + TX * j] : 0.f;
#pragma unroll
      for (int i = 0; i < PT / TY; ++i)
#pragma unroll
        for (int j = 0; j < NMAX / TX; ++j)
          if (TX * j < N) u[i][j] = fmaf(xv[i], bv[j], u[i][j]);
    }
    const float et = expf(total[0]);
    const bool last = z == nchunks - 1;
#pragma unroll
    for (int i = 0; i < PT / TY; ++i) {
      const int p = ty + TY * i;
#pragma unroll
      for (int j = 0; j < NMAX / TX; ++j) {
        const int n = tx + TX * j;
        if (TX * j < N) {
          const float v = fmaf(et, St[p * SN + n], u[i][j]);
          St[p * SN + n] = v;
          if (last && p < pn && n < N)
            a.hT[((static_cast<long long>(bi) * a.H + h) * a.P + p0 + p) * N + n] = v;
        }
      }
    }
  }
}

template <typename T>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const int smem = static_cast<int>(sizeof(float) * SMEM_FLOATS);
  cudaError_t e = cudaFuncSetAttribute(
      ssd_chunk_scan<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((a.P + PT - 1) / PT, a.H, a.B);
  ssd_chunk_scan<T><<<grid, THREADS, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// dtype (of x, b, c and y): 0 = float32, 1 = bfloat16.  Returns a
// cudaError_t (0 = launched).  The caller checks shapes, strides and
// devices; nothing here allocates or synchronizes.
extern "C" int ssd_fwd(
    const void* x, const void* dt, const void* a, const void* b,
    const void* c, void* y, void* hT, int dtype, int B, int L, int H, int P,
    int G, int N, int Q, long long sxb, long long sxl, long long sxh,
    long long sdb, long long sdl, long long sdh, long long sbb, long long sbl,
    long long sbg, long long scb, long long scl, long long scg, void* stream) {
  if (B < 1 || L < 1 || H < 1 || P < 1 || G < 1 || H % G != 0 || N < 1 ||
      N > NMAX || Q < 1 || Q > QMAX || H > 65535 || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args args{x,   static_cast<const float*>(dt),
                  static_cast<const float*>(a), b, c, y,
                  static_cast<float*>(hT), B, L, H, P, G, N, Q,
                  sxb, sxl, sxh, sdb, sdl, sdh, sbb, sbl, sbg, scb, scl, scg};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return static_cast<int>(launch<float>(args, s));
  if (dtype == 1) return static_cast<int>(launch<__nv_bfloat16>(args, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* ssd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
