// Mamba-2 SSD chunked scan for Hopper (sm_90a) on the tensor cores.
//
// Replaces the Pallas TPU kernel src/repro/kernels/ssd.py (`ssd`, body
// `_ssd_kernel`): the same function — per chunk of Q steps, with
// da = -dt*a and cum its inclusive prefix sum,
//   y     = (C Bᵀ ∘ exp(cum[q] - cum[s]) [s <= q] ∘ dt[s]) x
//         + (C ∘ exp(cum)) stateᵀ
//   state = exp(cum[Q-1]) state + (x ∘ dt exp(cum[Q-1] - cum))ᵀ B
// with the (P, N) state in f32 carried from chunk to chunk, B/C group
// h / (H/G) for head h, steps past L taken as dt = 0 (state-neutral), y in
// x's dtype and the final state in f32 — but not its blocking.
//
// What bounds it: at the Mamba-2-1.3B prefill shape (B=4, L=1024, H=64,
// P=64, N=128, Q=128, G=1, f32) the work the function needs is the causal
// triangle of C·Bᵀ once per (batch, group, chunk), and per (batch, head,
// chunk) the scores·x triangle, the state update and C·stateᵀ (none in
// the first chunk): 10.3 GFLOP against 148 MB of inputs and outputs.  In
// f32 every product runs as three TF32 products (below), 30.8 GFLOP at the
// card's 495 TFLOP/s TF32 rate, which outlasts the bytes at 3.35 TB/s: it
// is bound by operations.
//
// Design: three launches on the caller's stream.
// - Pass 0 (`ssd_cb`): C·Bᵀ on its causal triangle, once per (batch,
//   group, chunk) — not once per head — into an f32 scratch
//   (B, chunks, G, QS, QS), QS = Q rounded up to 8.
// - Pass 1 (`ssd_state`): one block per (64-column P tile, head, batch)
//   walks the chunks in order — the only work that must — with the
//   (64, N) state in the warps' mma accumulators.  At the start of chunk z
//   it writes the state entering z to an f32 scratch h_in (B, chunks - 1,
//   H, P, NP), NP = N rounded up to 8, then adds (x ∘ w)ᵀ·B on the tensor
//   cores.
// - Pass 2 (`ssd_out`): one block per (64-column P tile, chunk, head,
//   batch), all chunks in parallel: y = exp(cum) ∘ (C · h_in[z]ᵀ) + S · x
//   with S = CB ∘ exp(cum[q] - cum[s]) [s <= q] ∘ dt[s] formed in
//   registers as the mma's A fragment from pass 0's CB.  The decay is
//   evaluated only where s <= q (above the diagonal its exponent is
//   positive and could overflow, and inf·0 is NaN); k-steps wholly above
//   a warp's rows are skipped, and each warp takes one row tile from each
//   end of the chunk so that every warp has the same causal work.
// - Every product is `mma.sync.m16n8k8` TF32 with f32 accumulation.  An
//   f32 operand is split as x = big + small (both TF32, rounded toward
//   zero) and a product accumulates small·big + big·small + big·big
//   (3xTF32): one TF32 pass misses the parity limits on each of the four
//   products (tests/test_torch_ssd.py emulates both).  A bf16 input is exact in
//   TF32, so its small part is zero and that term is skipped: C·Bᵀ takes
//   one pass in bf16, the other products two.  `mma.sync`, not `wgmma`:
//   tf32 `wgmma` reads B only K-major from shared memory, and two of the
//   four products (S·x and the state update) reduce over the step axis,
//   along which x and B are not contiguous.
// - The reduction axis is streamed through shared memory in slices of 32
//   steps (pass 1) or of 16 steps or state columns (pass 2), through a
//   ring of 4 stages filled by 16-byte `cp.async` copies while the warps
//   compute on earlier slices.  Inputs whose pointers, strides or widths
//   are not multiples of 16 bytes, and bf16 inputs (widened to f32 on the
//   way), are staged by plain loads instead; the scratches always take
//   cp.async.  Operands stored with the reduction axis contiguous (C, CB,
//   h_in and pass 0's B) reach their fragments by `ldmatrix`, the others
//   (x, and B in pass 1) by plain shared loads.  Shared-memory row strides
//   are 4 or 20 (mod 32) words for the former and 8 (mod 32) for the
//   latter, so that no load of a warp has a bank conflict.
// - Each mma operand is split where it is loaded, and each term of a
//   product is issued for all of a warp's accumulators in turn, so that no
//   mma waits on the one before it.  Even so the passes retire products at
//   about half the rate `mma.sync` reaches back to back
//   (kernels/mma_rate.py): the splits, loads and barriers between the
//   products take the rest.  Rows and columns past the shapes are
//   staged as zeros and computed; only the stores are guarded, so the
//   inner loops have no branches but uniform ones.
// - At the prefill shape: pass 0 64 blocks of 128 threads (99 KB of shared
//   memory); pass 1 256 blocks of 128 threads, 2 per SM (105 KB each);
//   pass 2 2048 blocks of 128 threads, 3 per SM (61.5 KB each).
// - No atomics and a fixed order of every sum: two launches on the same
//   inputs give the same bits.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int QMAX = 128;  // chunk length, at most
constexpr int NMAX = 128;  // d_state, at most
constexpr int TILE = 64;   // rows of a pass 0 / pass 2 tile; P columns
constexpr float LOG2E = 1.4426950408889634f;

struct Args {
  const void* x;    // (B, L, H, P), unit stride on P
  const float* dt;  // (B, L, H)
  const float* a;   // (H,) decay rates, contiguous
  const void* b;    // (B, L, G, N), unit stride on N
  const void* c;    // (B, L, G, N), unit stride on N
  void* y;          // (B, L, H, P), contiguous
  float* hT;        // (B, H, P, N), contiguous
  float* cb;        // scratch (B, nch, G, QS, QS)
  float* hin;       // scratch (B, nch - 1, H, P, NP)
  int B, L, H, P, G, N, Q;
  int nch, QS, NP;
  int vec;  // 1: x, b, c rows are 16 B-aligned f32, staged with cp.async
  long long sxb, sxl, sxh, sdb, sdl, sdh, sbb, sbl, sbg, scb, scl, scg;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store2(float* p, float v0, float v1) {
  *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float v0, float v1) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v0, v1);
}
__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// big = x with the 13 bits past tf32's cleared, small = x - big (exact),
// whose own bits past tf32's the tensor cores drop: both rounded toward
// zero, two instructions, about 21 of x's 24 bits kept.  A NaN or inf x
// gives a NaN small, and the products stay NaN.
__device__ __forceinline__ void split(float x, uint32_t& big,
                                      uint32_t& small) {
  big = __float_as_uint(x) & 0xffffe000u;
  small = __float_as_uint(x - __uint_as_float(big));
}

// An mma operand fragment as big and small TF32 parts; EXACT: the values
// are already TF32 (a bf16 input), so small is zero and is not formed.
template <int K, bool EXACT>
struct Frag {
  uint32_t big[K], small[K];
  __device__ __forceinline__ void set(const float (&v)[K]) {
#pragma unroll
    for (int i = 0; i < K; ++i) {
      if constexpr (EXACT)
        big[i] = __float_as_uint(v[i]);
      else
        split(v[i], big[i], small[i]);
    }
  }
};

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c[j] += a·b[j] for every j, as small·big + big·small + big·big, skipping
// the terms whose small part is zero.  Each term is issued for every j in
// turn, so that no mma waits on the one before it.
template <int NJ, bool AX, bool BX>
__device__ __forceinline__ void mma3(float (&c)[NJ][4], const Frag<4, AX>& a,
                                     const Frag<2, BX> (&b)[NJ]) {
  if constexpr (!AX) {
#pragma unroll
    for (int j = 0; j < NJ; ++j) mma_tf32(c[j], a.small, b[j].big[0], b[j].big[1]);
  }
  if constexpr (!BX) {
#pragma unroll
    for (int j = 0; j < NJ; ++j) mma_tf32(c[j], a.big, b[j].small[0], b[j].small[1]);
  }
#pragma unroll
  for (int j = 0; j < NJ; ++j) mma_tf32(c[j], a.big, b[j].big[0], b[j].big[1]);
}

// 2^x, flushing results below 2^-126 to zero.
__device__ __forceinline__ float ex2(float x) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}

// Four 8 x 4 tiles of f32 words from shared memory, one per register: lane
// i gives the address of row i % 8 of tile i / 8 and receives word
// (i / 4, i % 4) of each tile, which is where an mma fragment wants it.
__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], const float* row) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(row));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

// The A fragment of the 16 x 8 tile at p (row-major, row stride str
// floats, rows 16 B-aligned).
__device__ __forceinline__ void lds_a(float (&v)[4], const float* p, int str,
                                      int lane) {
  uint32_t r[4];
  const int m = lane >> 3;
  ldsm4(r, p + ((m & 1) * 8 + (lane & 7)) * str + (m >> 1) * 4);
#pragma unroll
  for (int i = 0; i < 4; ++i) v[i] = __uint_as_float(r[i]);
}

// The B fragments of two n-tiles from the 16 x 8 tile at p, stored n-major
// (row n holds k contiguous, row stride str floats).
__device__ __forceinline__ void lds_b2(float (&v)[2][2], const float* p,
                                       int str, int lane) {
  uint32_t r[4];
  const int m = lane >> 3;
  ldsm4(r, p + ((m >> 1) * 8 + (lane & 7)) * str + (m & 1) * 4);
#pragma unroll
  for (int i = 0; i < 4; ++i) v[i >> 1][i & 1] = __uint_as_float(r[i]);
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// Stage an NR x NC tile into dst (row stride STR floats): element (r, c)
// is src[(r0 + r) * rs + c0 + c], zero unless r0 + r < rmax and
// c0 + c < cmax.  vec (f32 only; c0, cmax, rs and src multiples of 4
// floats): 16-byte cp.async copies, completed by cp_wait; else plain loads,
// widened to f32.  NT threads share the work.
template <typename T, int NR, int NC, int STR, int NT>
__device__ __forceinline__ void stage(float* dst, const T* src, long long rs,
                                      int r0, int rmax, int c0, int cmax,
                                      bool vec) {
  if constexpr (std::is_same<T, float>::value) {
    if (vec) {
      constexpr int CPR = NC / 4;  // copies per row
#pragma unroll
      for (int j = 0; j < (NR * CPR + NT - 1) / NT; ++j) {
        const int i = threadIdx.x + j * NT;
        if (NR * CPR % NT != 0 && i >= NR * CPR) break;
        const int r = i / CPR, c = (i % CPR) * 4;
        const bool in = r0 + r < rmax && c0 + c < cmax;
        const float* s = src + (in ? (long long)(r0 + r) * rs + c0 + c : 0);
        const unsigned d = static_cast<unsigned>(
            __cvta_generic_to_shared(dst + r * STR + c));
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(d),
                     "l"(s), "r"(in ? 16 : 0)
                     : "memory");
      }
      return;
    }
  }
#pragma unroll 8
  for (int i = threadIdx.x; i < NR * NC; i += NT) {
    const int r = i / NC, c = i % NC;
    const bool in = r0 + r < rmax && c0 + c < cmax;
    dst[r * STR + c] =
        in ? to_f32(src[(long long)(r0 + r) * rs + c0 + c]) : 0.f;
  }
}

// Warp-wide over one chunk: v holds dt at steps 4·lane + k (0 at or past
// Q); on return v holds cum, the inclusive prefix sum of -dt·rate, and the
// result is the chunk's total.
__device__ __forceinline__ float chunk_cum(float (&v)[QMAX / 32], float rate,
                                           int lane) {
  float run = 0.f;
#pragma unroll
  for (int k = 0; k < QMAX / 32; ++k) {
    run += -v[k] * rate;
    v[k] = run;
  }
  float incl = run;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float t = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += t;
  }
  float excl = __shfl_up_sync(0xffffffffu, incl, 1);
  if (lane == 0) excl = 0.f;
#pragma unroll
  for (int k = 0; k < QMAX / 32; ++k) v[k] += excl;
  return __shfl_sync(0xffffffffu, incl, 31);
}

// dt at steps 4·lane + k of chunk z (0 at or past Q or L).
__device__ __forceinline__ void load_dt(float (&v)[QMAX / 32],
                                        const float* dtp, const Args& a,
                                        int z, int lane) {
#pragma unroll
  for (int k = 0; k < QMAX / 32; ++k) {
    const int q = lane * (QMAX / 32) + k;
    const int l = z * a.Q + q;
    v[k] = q < a.Q && l < a.L ? dtp[(long long)l * a.sdl] : 0.f;
  }
}

// ---------------------------------------------------------------------------
// Pass 0: CB[q, s] = Σ_n C[q, n] B[s, n] for s <= q, once per (b, g, z).
// 4 warps per 64-row tile, 16 rows each; the whole reduction in shared
// memory (C rows of the tile, B rows up to the tile's last row).
// ---------------------------------------------------------------------------
constexpr int CB_THREADS = 128;
constexpr int CB_STR = NMAX + 4;
constexpr int CB_SMEM = (TILE + QMAX) * CB_STR * 4;

template <typename T>
__global__ void __launch_bounds__(CB_THREADS) ssd_cb(const Args a) {
  constexpr bool X = !std::is_same<T, float>::value;
  extern __shared__ __align__(16) float smem[];
  float* Cs = smem;               // TILE x CB_STR
  float* Bs = Cs + TILE * CB_STR; // QMAX x CB_STR
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int rtiles = (a.QS + TILE - 1) / TILE;
  const int rt = blockIdx.x % rtiles, z = blockIdx.x / rtiles;
  const int grp = blockIdx.y, bi = blockIdx.z;
  const int r0 = rt * TILE, l0 = z * a.Q;
  const int lend = min(a.L, l0 + a.Q);  // steps of this chunk: [l0, lend)
  const T* cp = static_cast<const T*>(a.c) + bi * a.scb + grp * a.scg;
  const T* bp = static_cast<const T*>(a.b) + bi * a.sbb + grp * a.sbg;
  const bool vec = a.vec != 0;

  stage<T, TILE, NMAX, CB_STR, CB_THREADS>(Cs, cp, a.scl, l0 + r0, lend, 0,
                                           a.N, vec);
  stage<T, QMAX, NMAX, CB_STR, CB_THREADS>(
      Bs, bp, a.sbl, l0, min(lend, l0 + r0 + TILE), 0, a.N, vec);
  cp_commit();
  cp_wait<0>();
  __syncthreads();

  const int m0 = r0 + warp * 16;  // this warp's first row
  if (m0 >= a.QS) return;
  // columns past the warp's last row are 0: groups of 4 n-tiles up to it
  const int ngroups = (min(a.QS, m0 + 16) + 31) / 32;
  float acc[QMAX / 32][4][4];
#pragma unroll
  for (int n = 0; n < QMAX / 32; ++n)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[n][j][i] = 0.f;
  const int ksteps = (a.N + 7) / 8;
  for (int ks = 0; ks < ksteps; ++ks) {
    float va[4];
    lds_a(va, Cs + (m0 - r0) * CB_STR + ks * 8, CB_STR, lane);
    Frag<4, X> fa;
    fa.set(va);
#pragma unroll
    for (int n = 0; n < QMAX / 32; ++n) {
      if (n < ngroups) {
        Frag<2, X> fb[4];
#pragma unroll
        for (int jp = 0; jp < 2; ++jp) {
          float vb[2][2];
          lds_b2(vb, Bs + (n * 32 + jp * 16) * CB_STR + ks * 8, CB_STR, lane);
          fb[2 * jp].set(vb[0]);
          fb[2 * jp + 1].set(vb[1]);
        }
        mma3(acc[n], fa, fb);
      }
    }
  }
  float* out = a.cb + ((long long)(bi * a.nch + z) * a.G + grp) * a.QS * a.QS;
  const int q0 = m0 + g, q1 = q0 + 8;
#pragma unroll
  for (int n = 0; n < QMAX / 8; ++n) {
    const int s = n * 8 + 2 * t;
    const float* v = acc[n / 4][n % 4];
    if (n * 8 < a.QS) {
      store2(out + (long long)q0 * a.QS + s, s <= q0 ? v[0] : 0.f,
             s + 1 <= q0 ? v[1] : 0.f);
      if (q1 < a.QS)
        store2(out + (long long)q1 * a.QS + s, s <= q1 ? v[2] : 0.f,
               s + 1 <= q1 ? v[3] : 0.f);
    }
  }
}

// ---------------------------------------------------------------------------
// Pass 1: the state, chunk after chunk.  4 warps own the 64 x 128 state
// tile of a (P tile, head, batch): warp w its rows 32(w & 1) + [0, 32) and
// columns 64(w >> 1) + [0, 64), as 2 x 8 mma accumulators.  Slices of 32
// steps of x and B stream through a 4-stage ring.
// ---------------------------------------------------------------------------
constexpr int ST_THREADS = 128;
constexpr int ST_NST = 4;
constexpr int ST_SL = 32;                       // steps per slice
constexpr int ST_XS = TILE + 8;                 // x slice row stride
constexpr int ST_BS = NMAX + 8;                 // B slice row stride
constexpr int ST_STAGE = ST_SL * ST_XS + ST_SL * ST_BS;
constexpr int ST_SMEM = (ST_NST * ST_STAGE + 2 * QMAX + 2) * 4;

template <typename T>
__global__ void __launch_bounds__(ST_THREADS, 2) ssd_state(const Args a) {
  constexpr bool X = !std::is_same<T, float>::value;
  extern __shared__ __align__(16) float smem[];
  float* wbuf = smem + ST_NST * ST_STAGE;  // 2 x QMAX: dt·exp(total - cum)
  float* etot = wbuf + 2 * QMAX;           // 2: exp(total)
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int p0 = blockIdx.x * TILE, h = blockIdx.y, bi = blockIdx.z;
  const int grp = h / (a.H / a.G);
  const float rate = a.a[h];
  const T* xp = static_cast<const T*>(a.x) + bi * a.sxb + h * a.sxh;
  const T* bp = static_cast<const T*>(a.b) + bi * a.sbb + grp * a.sbg;
  const float* dtp = a.dt + bi * a.sdb + h * a.sdh;
  const bool vec = a.vec != 0;
  const int nsl = (a.Q + ST_SL - 1) / ST_SL;  // slices per chunk
  const int total = a.nch * nsl;

  auto issue = [&](int i) {
    if (i < total) {
      const int z = i / nsl, s0 = z * a.Q + (i - z * nsl) * ST_SL;
      const int lend = min(a.L, z * a.Q + a.Q);
      float* st = smem + (i % ST_NST) * ST_STAGE;
      stage<T, ST_SL, TILE, ST_XS, ST_THREADS>(st, xp, a.sxl, s0, lend, p0, a.P,
                                            vec);
      stage<T, ST_SL, NMAX, ST_BS, ST_THREADS>(st + ST_SL * ST_XS, bp, a.sbl, s0,
                                            lend, 0, a.N, vec);
    }
    cp_commit();
  };
  // warp 0: w and exp(total) of chunk z from its dt, into buffer z & 1
  auto weights = [&](const float (&d)[QMAX / 32], int z) {
    float v[QMAX / 32];
#pragma unroll
    for (int k = 0; k < QMAX / 32; ++k) v[k] = d[k];
    const float tot = chunk_cum(v, rate, lane);
#pragma unroll
    for (int k = 0; k < QMAX / 32; ++k)
      wbuf[(z & 1) * QMAX + lane * (QMAX / 32) + k] = d[k] * expf(tot - v[k]);
    if (lane == 0) etot[z & 1] = expf(tot);
  };

#pragma unroll
  for (int i = 0; i < ST_NST - 1; ++i) issue(i);
  float dnext[QMAX / 32];
  if (warp == 0) {
    load_dt(dnext, dtp, a, 0, lane);
    weights(dnext, 0);
    if (a.nch > 1) load_dt(dnext, dtp, a, 1, lane);
  }

  // rows past P and columns past N are staged as zeros, so every tile is
  // computed and only the stores are guarded
  const int mrow = 32 * (warp & 1), ncol = 64 * (warp >> 1);
  float acc[2][8][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  for (int z = 0; z < a.nch; ++z) {
    for (int k = 0; k < nsl; ++k) {
      const int i = z * nsl + k;
      cp_wait<ST_NST - 2>();
      __syncthreads();
      issue(i + ST_NST - 1);
      if (k == 0) {
        if (z > 0) {  // the state entering chunk z
          float* hp = a.hin +
                      ((long long)(bi * (a.nch - 1) + z - 1) * a.H + h) *
                          a.P * a.NP;
#pragma unroll
          for (int ii = 0; ii < 2; ++ii)
#pragma unroll
            for (int j = 0; j < 8; ++j) {
              const int p = p0 + mrow + 16 * ii + g;
              const int n = ncol + 8 * j + 2 * t;
              if (n < a.NP) {
                if (p < a.P)
                  store2(hp + (long long)p * a.NP + n, acc[ii][j][0],
                         acc[ii][j][1]);
                if (p + 8 < a.P)
                  store2(hp + (long long)(p + 8) * a.NP + n, acc[ii][j][2],
                         acc[ii][j][3]);
              }
            }
        }
        const float e = etot[z & 1];
#pragma unroll
        for (int ii = 0; ii < 2; ++ii)
#pragma unroll
          for (int j = 0; j < 8; ++j)
#pragma unroll
            for (int r = 0; r < 4; ++r) acc[ii][j][r] *= e;
        if (warp == 0 && z + 1 < a.nch) {
          weights(dnext, z + 1);
          if (z + 2 < a.nch) load_dt(dnext, dtp, a, z + 2, lane);
        }
      }
      const float* xs = smem + (i % ST_NST) * ST_STAGE;
      const float* bs = xs + ST_SL * ST_XS;
      const float* w = wbuf + (z & 1) * QMAX + k * ST_SL;
#pragma unroll
      for (int kk = 0; kk < ST_SL / 8; ++kk) {
        const float wa = w[kk * 8 + t], wb = w[kk * 8 + t + 4];
        const float* xr = xs + (kk * 8 + t) * ST_XS + mrow + g;
        Frag<4, false> fa[2];
#pragma unroll
        for (int ii = 0; ii < 2; ++ii) {
          const float* r = xr + 16 * ii;
          fa[ii].set({r[0] * wa, r[8] * wa, r[4 * ST_XS] * wb,
                      r[4 * ST_XS + 8] * wb});
        }
        const float* br = bs + (kk * 8 + t) * ST_BS + ncol + g;
        Frag<2, X> fb[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) fb[j].set({br[8 * j], br[8 * j + 4 * ST_BS]});
#pragma unroll
        for (int ii = 0; ii < 2; ++ii) mma3(acc[ii], fa[ii], fb);
      }
    }
  }

  float* hT = a.hT + ((long long)bi * a.H + h) * a.P * a.N;
#pragma unroll
  for (int ii = 0; ii < 2; ++ii)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int p = p0 + mrow + 16 * ii + g + (r >> 1) * 8;
        const int n = ncol + 8 * j + 2 * t + (r & 1);
        if (p < a.P && n < a.N) hT[(long long)p * a.N + n] = acc[ii][j][r];
      }
}

// ---------------------------------------------------------------------------
// Pass 2: y, every chunk in parallel.  4 warps per (chunk, 64-column P
// tile): warp w owns the 16-row m-tiles w and 7 - w of the chunk, so that
// every warp has the same causal work, as 2 x 8 mma accumulators; each B
// fragment is split once for both.  First (chunks z > 0) C·h_inᵀ over
// state-column slices of 16, scaled by exp(cum) per row; then S·x over
// step slices of 16.  Both kinds of slice fit one stage of a 4-stage ring.
// ---------------------------------------------------------------------------
constexpr int OUT_THREADS = 128;
constexpr int OUT_NST = 4;
constexpr int OUT_SL = 16;          // steps or state columns per slice
constexpr int OUT_AS = OUT_SL + 4;  // C / CB slice row stride (rows: steps)
constexpr int OUT_HS = OUT_SL + 4;  // h_in slice row stride (rows: P)
constexpr int OUT_XS = TILE + 8;    // x slice row stride (rows: steps)
constexpr int OUT_STAGE = QMAX * OUT_AS + TILE * OUT_HS;
static_assert(OUT_SL * OUT_XS <= TILE * OUT_HS, "x slice outgrows its stage");
constexpr int OUT_SMEM = (OUT_NST * OUT_STAGE + 3 * QMAX) * 4;

template <typename T>
__global__ void __launch_bounds__(OUT_THREADS, 3) ssd_out(const Args a) {
  constexpr bool X = !std::is_same<T, float>::value;
  extern __shared__ __align__(16) float smem[];
  float* cum2 = smem + OUT_NST * OUT_STAGE;  // QMAX: cum·log2(e)
  float* ecum = cum2 + QMAX;                 // QMAX: exp(cum)
  float* dtv = ecum + QMAX;                  // QMAX
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int ptiles = (a.P + TILE - 1) / TILE;
  const int pt = blockIdx.x % ptiles, z = blockIdx.x / ptiles;
  const int h = blockIdx.y, bi = blockIdx.z;
  const int grp = h / (a.H / a.G);
  const int p0 = pt * TILE, l0 = z * a.Q;
  const int lend = min(a.L, l0 + a.Q);
  const T* xp = static_cast<const T*>(a.x) + bi * a.sxb + h * a.sxh;
  const T* cp = static_cast<const T*>(a.c) + bi * a.scb + grp * a.scg;
  const float* cbp =
      a.cb + ((long long)(bi * a.nch + z) * a.G + grp) * a.QS * a.QS;
  const float* hp =
      z > 0 ? a.hin + ((long long)(bi * (a.nch - 1) + z - 1) * a.H + h) *
                          a.P * a.NP
            : nullptr;
  const bool vec = a.vec != 0;
  const int na = z > 0 ? (a.NP + OUT_SL - 1) / OUT_SL : 0;  // C·h_inᵀ slices
  const int total = na + (a.Q + OUT_SL - 1) / OUT_SL;       // and S·x slices

  auto issue = [&](int i) {
    if (i < total) {
      float* st = smem + (i % OUT_NST) * OUT_STAGE;
      float* st2 = st + QMAX * OUT_AS;
      if (i < na) {
        stage<T, QMAX, OUT_SL, OUT_AS, OUT_THREADS>(st, cp, a.scl, l0, lend,
                                                i * OUT_SL, a.N, vec);
        stage<float, TILE, OUT_SL, OUT_HS, OUT_THREADS>(st2, hp, a.NP, p0, a.P,
                                                    i * OUT_SL, a.NP, true);
      } else {
        const int s0 = (i - na) * OUT_SL;
        stage<float, QMAX, OUT_SL, OUT_AS, OUT_THREADS>(st, cbp, a.QS, 0, a.QS,
                                                    s0, a.QS, true);
        stage<T, OUT_SL, TILE, OUT_XS, OUT_THREADS>(st2, xp, a.sxl, l0 + s0, lend,
                                                p0, a.P, vec);
      }
    }
    cp_commit();
  };

#pragma unroll
  for (int i = 0; i < OUT_NST - 1; ++i) issue(i);
  if (warp == 0) {
    const float* dtp = a.dt + bi * a.sdb + h * a.sdh;
    float v[QMAX / 32], d[QMAX / 32];
    load_dt(v, dtp, a, z, lane);
#pragma unroll
    for (int k = 0; k < QMAX / 32; ++k) d[k] = v[k];
    chunk_cum(v, a.a[h], lane);
#pragma unroll
    for (int k = 0; k < QMAX / 32; ++k) {
      const int q = lane * (QMAX / 32) + k;
      cum2[q] = v[k] * LOG2E;
      ecum[q] = expf(v[k]);
      dtv[q] = d[k];
    }
  }

  const int mt[2] = {warp, 7 - warp};  // this warp's m-tiles, mt[0] < mt[1]
  bool m_on[2];  // P columns past P are staged as zeros and computed
#pragma unroll
  for (int ii = 0; ii < 2; ++ii) m_on[ii] = 16 * mt[ii] < a.Q;
  float acc[2][TILE / 8][4];
#pragma unroll
  for (int ii = 0; ii < 2; ++ii)
#pragma unroll
    for (int j = 0; j < TILE / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[ii][j][e] = 0.f;

  for (int i = 0; i < total; ++i) {
    cp_wait<OUT_NST - 2>();
    __syncthreads();
    issue(i + OUT_NST - 1);
    if (!m_on[0]) continue;  // no rows of the chunk (warp-uniform)
    const float* sa = smem + (i % OUT_NST) * OUT_STAGE;
    const float* sb = sa + QMAX * OUT_AS;
    if (i < na) {  // acc += C · h_inᵀ over this slice's state columns
#pragma unroll
      for (int kk = 0; kk < OUT_SL / 8; ++kk) {
        Frag<2, false> fb[TILE / 8];
#pragma unroll
        for (int jp = 0; jp < TILE / 16; ++jp) {
          float vb[2][2];
          lds_b2(vb, sb + 16 * jp * OUT_HS + kk * 8, OUT_HS, lane);
          fb[2 * jp].set(vb[0]);
          fb[2 * jp + 1].set(vb[1]);
        }
#pragma unroll
        for (int ii = 0; ii < 2; ++ii) {
          if (!m_on[ii]) continue;
          float va[4];
          lds_a(va, sa + 16 * mt[ii] * OUT_AS + kk * 8, OUT_AS, lane);
          Frag<4, X> fa;
          fa.set(va);
          mma3(acc[ii], fa, fb);
        }
      }
      continue;
    }
    if (i == na && na > 0) {  // the inter-chunk term decays from the start
#pragma unroll
      for (int ii = 0; ii < 2; ++ii) {
        const float e0 = ecum[16 * mt[ii] + g], e1 = ecum[16 * mt[ii] + g + 8];
#pragma unroll
        for (int j = 0; j < TILE / 8; ++j) {
          acc[ii][j][0] *= e0;
          acc[ii][j][1] *= e0;
          acc[ii][j][2] *= e1;
          acc[ii][j][3] *= e1;
        }
      }
    }
    // acc += S · x over this slice's steps
    const int s0 = (i - na) * OUT_SL;
    float cq[2][2];
#pragma unroll
    for (int ii = 0; ii < 2; ++ii) {
      cq[ii][0] = cum2[16 * mt[ii] + g];
      cq[ii][1] = cum2[16 * mt[ii] + g + 8];
    }
#pragma unroll
    for (int kk = 0; kk < OUT_SL / 8; ++kk) {
      const int sk = s0 + kk * 8;  // this k-step's first step
      bool need[2];                // a row of the m-tile reaches sk
#pragma unroll
      for (int ii = 0; ii < 2; ++ii)
        need[ii] = m_on[ii] && sk <= 16 * mt[ii] + 15;
      if (!need[0] && !need[1]) break;  // and every later k-step
      const int s = sk + t;  // and s + 4
      const float cs = cum2[s], cs4 = cum2[s + 4];
      const float ds = dtv[s], ds4 = dtv[s + 4];
      const float* xr = sb + (kk * 8 + t) * OUT_XS + g;
      Frag<2, X> fb[TILE / 8];
#pragma unroll
      for (int j = 0; j < TILE / 8; ++j)
        fb[j].set({xr[8 * j], xr[8 * j + 4 * OUT_XS]});
#pragma unroll
      for (int ii = 0; ii < 2; ++ii) {
        if (!need[ii]) continue;
        const int q0 = 16 * mt[ii] + g, q1 = q0 + 8;
        float r[4];  // CB at (q0, s), (q1, s), (q0, s + 4), (q1, s + 4)
        lds_a(r, sa + 16 * mt[ii] * OUT_AS + kk * 8, OUT_AS, lane);
        // exp(cum[q] - cum[s]) only where s <= q: the exponent is <= 0
        // there; elsewhere it is clamped and the value dropped
        const float v[4] = {r[0] * ex2(fminf(cq[ii][0] - cs, 0.f)) * ds,
                            r[1] * ex2(fminf(cq[ii][1] - cs, 0.f)) * ds,
                            r[2] * ex2(fminf(cq[ii][0] - cs4, 0.f)) * ds4,
                            r[3] * ex2(fminf(cq[ii][1] - cs4, 0.f)) * ds4};
        Frag<4, false> fa;
        fa.set({s <= q0 ? v[0] : 0.f, s <= q1 ? v[1] : 0.f,
                s + 4 <= q0 ? v[2] : 0.f, s + 4 <= q1 ? v[3] : 0.f});
        mma3(acc[ii], fa, fb);
      }
    }
  }
  if (!m_on[0]) return;

  T* yp = static_cast<T*>(a.y);
  const bool pairs = a.P % 2 == 0;
#pragma unroll
  for (int ii = 0; ii < 2; ++ii)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int q = 16 * mt[ii] + g + 8 * half;
      const int l = l0 + q;
      if (!m_on[ii] || q >= a.Q || l >= a.L) continue;
      T* row = yp + (((long long)bi * a.L + l) * a.H + h) * a.P;
#pragma unroll
      for (int j = 0; j < TILE / 8; ++j) {
        const int p = p0 + 8 * j + 2 * t;
        const float v0 = acc[ii][j][2 * half], v1 = acc[ii][j][2 * half + 1];
        if (pairs && p + 1 < a.P) {
          store2(row + p, v0, v1);
        } else {
          if (p < a.P) store1(row + p, v0);
          if (p + 1 < a.P) store1(row + p + 1, v1);
        }
      }
    }
}

template <typename K>
cudaError_t prepare(K kernel, int smem) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

template <typename T>
cudaError_t launch(const Args& a, cudaStream_t s) {
  cudaError_t e;
  if ((e = prepare(ssd_cb<T>, CB_SMEM)) != cudaSuccess) return e;
  if ((e = prepare(ssd_state<T>, ST_SMEM)) != cudaSuccess) return e;
  if ((e = prepare(ssd_out<T>, OUT_SMEM)) != cudaSuccess) return e;
  const int ptiles = (a.P + TILE - 1) / TILE;
  ssd_cb<T><<<dim3((a.QS + TILE - 1) / TILE * a.nch, a.G, a.B), CB_THREADS,
              CB_SMEM, s>>>(a);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  ssd_state<T><<<dim3(ptiles, a.H, a.B), ST_THREADS, ST_SMEM, s>>>(a);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  ssd_out<T><<<dim3(ptiles * a.nch, a.H, a.B), OUT_THREADS, OUT_SMEM, s>>>(
      a);
  return cudaGetLastError();
}

}  // namespace

// dtype (of x, b, c and y): 0 = float32, 1 = bfloat16.  vec: 1 when x, b
// and c are float32 with pointers, strides and widths (P, N) multiples of
// 16 bytes.  cb and hin: f32 scratch of (B, ceil(L/Q), G, QS, QS) and
// (B, ceil(L/Q) - 1, H, P, NP) elements, QS and NP being Q and N rounded up
// to 8, 16 B-aligned.  Returns a cudaError_t (0 = launched).  The caller
// checks shapes, strides, devices and `vec`; nothing here allocates or
// synchronizes.
extern "C" int ssd_fwd(
    const void* x, const void* dt, const void* a, const void* b,
    const void* c, void* y, void* hT, void* cb, void* hin, int dtype, int vec,
    int B, int L, int H, int P, int G, int N, int Q, long long sxb,
    long long sxl, long long sxh, long long sdb, long long sdl, long long sdh,
    long long sbb, long long sbl, long long sbg, long long scb, long long scl,
    long long scg, void* stream) {
  if (B < 1 || L < 1 || H < 1 || P < 1 || G < 1 || H % G != 0 || N < 1 ||
      N > NMAX || Q < 1 || Q > QMAX || H > 65535 || B > 65535 || G > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const int nch = (L + Q - 1) / Q;
  const long long blocks = (long long)((P + TILE - 1) / TILE) * nch;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const Args args{x, static_cast<const float*>(dt),
                  static_cast<const float*>(a), b, c, y,
                  static_cast<float*>(hT), static_cast<float*>(cb),
                  static_cast<float*>(hin), B, L, H, P, G, N, Q, nch,
                  (Q + 7) / 8 * 8, (N + 7) / 8 * 8, vec,
                  sxb, sxl, sxh, sdb, sdl, sdh, sbb, sbl, sbg, scb, scl, scg};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return static_cast<int>(launch<float>(args, s));
  if (dtype == 1) return static_cast<int>(launch<__nv_bfloat16>(args, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* ssd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
