// Flash attention forward for Hopper (sm_90a) on the tensor cores: attn_fwd
// for head dims up to 128, attn_fwd_wide (below) for 129..256.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py
// (`flash_attention`, body `_attn_kernel`): the same function — online
// softmax with an fp32 accumulator and fp32 running max and sum, masks for
// padded keys, causal and sliding window, Gemma-2 softcap cap*tanh(s/cap),
// GQA head h -> kv head h / (H/KV), fully masked rows give 0, denominator
// max(l, 1e-20) — but not its blocking.
//
// What bounds it: at the DiT-XL/2 shape (B=8, L=256, H=KV=16, D=72, f32)
// the function is 4*B*H*L*L*D = 2.4 GFLOP against 38 MB of q/k/v/o.  In
// f32 each product is computed as three TF32 products (below), 7.2 GFLOP
// at the card's 495 TFLOP/s TF32 rate, which outlasts the bytes at
// 3.35 TB/s: it is bound by operations.
//
// Design:
// - Both products run on the tensor cores with `mma.sync` (m16n8k8 tf32,
//   m16n8k16 bf16), f32 accumulation.  f32 inputs take the 3xTF32 split:
//   x = big + small with big = tf32(x), small = tf32(x - big), both rounded
//   to nearest with ties away, and each product accumulates small*big +
//   big*small + big*big, which keeps about 22 bits of each operand (plain
//   TF32 keeps 11 and misses the 5e-5 parity limit).  An infinite input
//   turns into NaN in every row that reads it (its small part is inf - inf)
//   where plain f32 can give a finite row.  bf16 inputs go to the bf16 MMA
//   as they are.  `mma.sync` and not `wgmma`: tf32 `wgmma` reads B only
//   K-major from shared memory, so V would have to be staged transposed,
//   and its swizzled layouts want rows of 32/64/128 B where DiT-XL/2's are
//   288 B; `mma.sync` takes plain fragment loads from padded rows.
// - One block of 4 warps per (batch*head, 64-row query tile); each warp
//   owns 16 query rows and keeps its Q fragments, scores, probabilities
//   and output accumulator in registers.  The score accumulator of Q·Kᵀ is
//   the A operand of P·V: its (row, key 2t / 2t+1) layout is read as the
//   tf32 A fragment's (row, k t / t+4) by taking V's rows in the same
//   order, so P never goes through shared memory.  Softmax in base 2 with
//   the scale folded into log2(e), a per-row running max and alpha.
// - K/V tiles of 32 keys are double-buffered in shared memory: the next
//   tile's copy is in flight (`cp.async`, 16 B per thread) while the warps
//   compute on this one.  Rows whose address or stride is not a multiple
//   of 16 B (an odd head dim, an offset view) are staged by plain loads
//   instead; the wrapper picks the path from the pointers and strides.
//   Each thread copies a fixed column chunk of every few rows, so no index
//   is divided in the loop.  Tiles that no mask reaches skip the masks.
// - Shared-memory rows hold the head dim padded with zeros to DK, the
//   next instance's head dim (16, 32, 64, 72 in f32 or 80 in bf16, 128:
//   72 and 80 at DiT-XL/2), plus 4 f32 or 8 bf16 words, so that the
//   fragment loads of a warp hit 32 banks.
// - At the DiT-XL/2 shape: 512 blocks of 128 threads, 38.9 KB of shared
//   memory each, 4 blocks per SM (128 registers a thread, some of them
//   spilled to the stack): one wave on 132 SMs.
// - No atomics and a fixed order of every sum: two launches on the same
//   inputs give the same bits.
// - V may have a head dim Dv of its own, Dv <= D (MLA: q and k carry
//   nope + rope = 96 columns, v 64).  V is staged at Dv columns and O
//   written at Dv.  An instance's DV (n-tiles of the output) defaults to
//   its DK; the (96, 64) f32 instance keeps 8 output n-tiles where the
//   (128, 128) one would pad Q.Kt to 128 and run 16, 8 of them on zeros.
//   Any other Dv < D takes the (DK, DK) instance for D, with V's columns
//   Dv..DK-1 zero.  At MiniCPM3's prefill (B 4, L 1024, H 40, causal) the
//   band is 2.7e10 flops, 8.1e10 as 3xTF32, 0.163 ms at 495 TFLOP/s,
//   against 0.063 ms for q/k/v/o's bytes: bound by operations.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int BQ = 64;  // query rows per block, 16 per warp
constexpr int BK = 32;  // keys per K/V tile
constexpr int THREADS = 32 * (BQ / 16);
constexpr float NEG_INF = -2.0e38f;
constexpr float LOG2E = 1.4426950408889634f;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int B, Lq, Lk, H, KV, D;
  int Dv;         // V's and O's head dim, <= D
  long long sqb, sql, sqh, skb, skl, skh, svb, svl, svh, sob, sol, soh;
  float scale;
  int causal;
  int window;     // 0: no sliding window
  float softcap;  // 0: no softcap
  int vec;        // 1: every row is 16 B-aligned, stage with cp.async
};

template <typename T>
__device__ __forceinline__ T zero();
template <>
__device__ __forceinline__ float zero<float>() { return 0.f; }
template <>
__device__ __forceinline__ __nv_bfloat16 zero<__nv_bfloat16>() {
  return __float2bfloat16(0.f);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// f32 -> tf32, rounded to nearest with ties away from zero, in f32 bits.
__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// x = big + small, both tf32.  big is rounded as cvt.rna.tf32.f32 rounds
// any x that is not a NaN (add half a tf32 ulp to the bits, clear the low
// 13), in two integer operations where ptxas lowers the cvt to more, with
// a NaN test.  A NaN x may come out as a zero big, but then small = NaN and
// the products stay NaN.
__device__ __forceinline__ void split(float x, uint32_t& big,
                                      uint32_t& small) {
  big = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  small = tf32(x - __uint_as_float(big));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a*b in 3xTF32: small*big + big*small + big*big, in that order.
__device__ __forceinline__ void mma_3xtf32(float (&c)[4],
                                           const uint32_t (&ab)[4],
                                           const uint32_t (&as)[4],
                                           float b0, float b1) {
  uint32_t bb0, bs0, bb1, bs1;
  split(b0, bb0, bs0);
  split(b1, bb1, bs1);
  mma_tf32(c, as, bb0, bb1);
  mma_tf32(c, ab, bs0, bs1);
  mma_tf32(c, ab, bb0, bb1);
}

__device__ __forceinline__ void mma_bf16(float (&c)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// Rows [row0, row0 + n) of a (rows, D) matrix with row stride rs into dst
// (n rows of STR elements); rows at or past `rows` are staged as zeros.
// Each thread copies one fixed column chunk (16 B with cp.async, one
// element with plain loads) of every `step`-th row.
template <typename T, int STR>
__device__ __forceinline__ void stage(T* dst, const T* src, long long rs,
                                      int row0, int rows, int n, int D,
                                      bool vec) {
  const int e = vec ? 16 / (int)sizeof(T) : 1;  // elements per copy
  const int cpr = D / e;                        // copies per row
  const int step = THREADS / cpr;
  const int r0 = threadIdx.x / cpr;
  const int c = (threadIdx.x - r0 * cpr) * e;
  if (r0 >= step) return;
  for (int r = r0; r < n; r += step) {
    const int row = row0 + r;
    const bool in = row < rows;
    const T* s = src + (in ? row * rs : 0) + c;
    T* d = dst + r * STR + c;
    if (vec) {
      const unsigned sa = static_cast<unsigned>(__cvta_generic_to_shared(d));
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(sa),
                   "l"(s), "r"(in ? 16 : 0)
                   : "memory");
    } else {
      *d = in ? *s : zero<T>();
    }
  }
}

// DK: the head dim rounded up to an instance's (launch_f32, launch_bf16);
// DV: V's, at most DK.
template <typename T, int DK, int MINB, int DV = DK>
__global__ void __launch_bounds__(THREADS, MINB) attn_fwd(const Args a) {
  constexpr bool F32 = std::is_same<T, float>::value;
  constexpr int STR = DK + (F32 ? 4 : 8);     // shared row stride
  constexpr int KS = F32 ? DK / 8 : DK / 16;  // k-steps of Q·Kᵀ
  constexpr int NO = DV / 8;                  // n-tiles of the output
  static_assert(DV <= DK && DV % (F32 ? 8 : 16) == 0, "DV");
  constexpr int NS = BK / 8;                  // n-tiles of a score tile
  constexpr int TILE = 2 * BK * STR;          // one K/V stage
  using QF = typename std::conditional<F32, float, uint32_t>::type;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int b = blockIdx.x / a.H;
  const int h = blockIdx.x % a.H;
  const int hk = h / (a.H / a.KV);
  const int q0 = blockIdx.y * BQ;
  const bool vec = a.vec != 0;
  const T* qp = static_cast<const T*>(a.q) + b * a.sqb + h * a.sqh;
  const T* kp = static_cast<const T*>(a.k) + b * a.skb + hk * a.skh;
  const T* vp = static_cast<const T*>(a.v) + b * a.svb + hk * a.svh;

  // Zero both stages once: the padding columns D..DK-1 (Dv..DK-1 of V)
  // are never written.
  for (int i = threadIdx.x; i < 2 * TILE * (int)sizeof(T) / 16; i += THREADS)
    reinterpret_cast<uint4*>(smem_raw)[i] = make_uint4(0, 0, 0, 0);
  __syncthreads();

  // Key tiles that hold an unmasked key for some row of this query tile.
  int k_begin = 0, k_end = a.Lk;
  if (a.causal) k_end = min(k_end, q0 + BQ);
  if (a.window > 0) k_begin = max(0, q0 - a.window + 1);
  k_begin = (k_begin / BK) * BK;
  const int ntiles = k_end > k_begin ? (k_end - k_begin + BK - 1) / BK : 0;

  // Q goes to stage 0 (its 2*BK = BQ rows), the first K/V tile to stage 1.
  stage<T, STR>(sm, qp, a.sql, q0, a.Lq, BQ, a.D, vec);
  cp_commit();
  if (ntiles > 0) {
    stage<T, STR>(sm + TILE, kp, a.skl, k_begin, a.Lk, BK, a.D, vec);
    stage<T, STR>(sm + TILE + BK * STR, vp, a.svl, k_begin, a.Lk, BK, a.Dv,
                  vec);
  }
  cp_commit();
  cp_wait<1>();
  __syncthreads();

  QF qf[KS][4];
  {
    const T* qs = sm + (warp * 16 + g) * STR;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      if constexpr (F32) {
        const float* r = qs + ks * 8 + t;
        qf[ks][0] = r[0];
        qf[ks][1] = r[8 * STR];
        qf[ks][2] = r[4];
        qf[ks][3] = r[8 * STR + 4];
      } else {
        const T* r = qs + ks * 16 + 2 * t;
        qf[ks][0] = ld32(r);
        qf[ks][1] = ld32(r + 8 * STR);
        qf[ks][2] = ld32(r + 8);
        qf[ks][3] = ld32(r + 8 * STR + 8);
      }
    }
  }
  __syncthreads();  // stage 0 is free for the second tile
  // Q's rows BK..2BK-1 left columns Dv..D-1 of stage 0's V half, which V
  // does not overwrite: clear those that P·V reads.
  {
    const int v_end = min(a.D, DV), w = v_end - a.Dv;
    if (w > 0)
      for (int i = threadIdx.x; i < BK * w; i += THREADS)
        sm[(BK + i / w) * STR + a.Dv + i % w] = zero<T>();
  }

  float o[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) o[n][i] = 0.f;
  // this thread's rows: g (fragment entries 0, 1) and g + 8 (entries 2, 3)
  const int row0 = q0 + warp * 16 + g, row1 = row0 + 8;
  float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;
  const float sl2 = a.scale * LOG2E;

  for (int it = 0; it < ntiles; ++it) {
    const int kt = k_begin + it * BK;
    if (it + 1 < ntiles) {
      T* nxt = sm + (it & 1) * TILE;
      stage<T, STR>(nxt, kp, a.skl, kt + BK, a.Lk, BK, a.D, vec);
      stage<T, STR>(nxt + BK * STR, vp, a.svl, kt + BK, a.Lk, BK, a.Dv,
                    vec);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    const T* ks_ = sm + ((it + 1) & 1) * TILE;
    const T* vs_ = ks_ + BK * STR;

    // S = Q·Kᵀ for this warp's 16 rows and the tile's 32 keys
    float s[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[n][i] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      if constexpr (F32) {
        uint32_t ab[4], as[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) split(qf[ks][i], ab[i], as[i]);
#pragma unroll
        for (int n = 0; n < NS; ++n) {
          const float* kr = ks_ + (n * 8 + g) * STR + ks * 8 + t;
          mma_3xtf32(s[n], ab, as, kr[0], kr[4]);
        }
      } else {
#pragma unroll
        for (int n = 0; n < NS; ++n) {
          const T* kr = ks_ + (n * 8 + g) * STR + ks * 16 + 2 * t;
          mma_bf16(s[n], qf[ks], ld32(kr), ld32(kr + 8));
        }
      }
    }

    // online softmax in base 2; masked entries never reach exp2.  A tile
    // that no mask reaches for any row of the block skips the masks.
    const bool edge = kt + BK > a.Lk || (a.causal && kt + BK - 1 > q0) ||
                      (a.window > 0 && kt <= q0 + BQ - 1 - a.window);
    if (a.softcap > 0.f) {
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          s[n][i] = a.softcap * tanhf(s[n][i] * a.scale / a.softcap) * LOG2E;
    } else {
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) s[n][i] *= sl2;
    }
    unsigned ok = 0xffffu;
    if (edge) {
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int key = kt + n * 8 + 2 * t + (i & 1);
          const int row = i < 2 ? row0 : row1;
          bool in = key < a.Lk;
          if (a.causal) in = in && key <= row;
          if (a.window > 0) in = in && key > row - a.window;
          if (!in) {
            s[n][i] = NEG_INF;
            ok &= ~(1u << (n * 4 + i));
          }
        }
    }
    float mx0 = NEG_INF, mx1 = NEG_INF;
#pragma unroll
    for (int n = 0; n < NS; ++n) {
      mx0 = fmaxf(mx0, fmaxf(s[n][0], s[n][1]));
      mx1 = fmaxf(mx1, fmaxf(s[n][2], s[n][3]));
    }
#pragma unroll
    for (int sh = 1; sh <= 2; sh <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, sh));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, sh));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float al0 = exp2f(m0 - mn0), al1 = exp2f(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float ps0 = 0.f, ps1 = 0.f;  // this thread's part of the row sums
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = (ok >> (n * 4 + i) & 1u)
                            ? exp2f(s[n][i] - (i < 2 ? m0 : m1))
                            : 0.f;
        s[n][i] = p;
        if (i < 2)
          ps0 += p;
        else
          ps1 += p;
      }
    l0 = l0 * al0 + ps0;
    l1 = l1 * al1 + ps1;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      o[n][0] *= al0;
      o[n][1] *= al0;
      o[n][2] *= al1;
      o[n][3] *= al1;
    }

    // O += P·V, P straight from the score registers
    if constexpr (F32) {
#pragma unroll
      for (int kk = 0; kk < NS; ++kk) {
        // A fragment (row, k t / t+4) = scores (row, key 2t / 2t+1)
        uint32_t pb[4], pl[4];
        split(s[kk][0], pb[0], pl[0]);
        split(s[kk][2], pb[1], pl[1]);
        split(s[kk][1], pb[2], pl[2]);
        split(s[kk][3], pb[3], pl[3]);
        const float* vr = vs_ + (kk * 8 + 2 * t) * STR + g;
#pragma unroll
        for (int n = 0; n < NO; ++n)
          mma_3xtf32(o[n], pb, pl, vr[n * 8], vr[n * 8 + STR]);
      }
    } else {
#pragma unroll
      for (int j = 0; j < NS / 2; ++j) {
        const uint32_t pa[4] = {pack_bf16(s[2 * j][0], s[2 * j][1]),
                                pack_bf16(s[2 * j][2], s[2 * j][3]),
                                pack_bf16(s[2 * j + 1][0], s[2 * j + 1][1]),
                                pack_bf16(s[2 * j + 1][2], s[2 * j + 1][3])};
        const unsigned short* vr =
            reinterpret_cast<const unsigned short*>(vs_) +
            (j * 16 + 2 * t) * STR + g;
#pragma unroll
        for (int n = 0; n < NO; ++n) {
          const unsigned short* c = vr + n * 8;
          mma_bf16(o[n], pa, c[0] | (uint32_t)c[STR] << 16,
                   c[8 * STR] | (uint32_t)c[9 * STR] << 16);
        }
      }
    }
    __syncthreads();  // every warp is done with this stage
  }

#pragma unroll
  for (int sh = 1; sh <= 2; sh <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, sh);
    l1 += __shfl_xor_sync(0xffffffffu, l1, sh);
  }
  const float d0 = fmaxf(l0, 1e-20f), d1 = fmaxf(l1, 1e-20f);
  T* ob = static_cast<T*>(a.o) + b * a.sob + h * a.soh;
#pragma unroll
  for (int n = 0; n < NO; ++n) {
    const int c = n * 8 + 2 * t;
    if (row0 < a.Lq) {
      T* p = ob + row0 * a.sol + c;
      if (c < a.Dv) store(p, o[n][0] / d0);
      if (c + 1 < a.Dv) store(p + 1, o[n][1] / d0);
    }
    if (row1 < a.Lq) {
      T* p = ob + row1 * a.sol + c;
      if (c < a.Dv) store(p, o[n][2] / d1);
      if (c + 1 < a.Dv) store(p + 1, o[n][3] / d1);
    }
  }
}

template <typename T, int DK, int DV = DK>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  constexpr bool F32 = std::is_same<T, float>::value;
  // blocks per SM the registers must allow: 4 puts the DiT-XL/2 grid in
  // one wave
  constexpr int MINB = F32 ? (DK <= 72 ? 4 : 2) : (DK <= 80 ? 4 : 3);
  constexpr int STR = DK + (F32 ? 4 : 8);
  const int smem = (int)(2 * 2 * BK * STR * sizeof(T));
  const auto kernel = attn_fwd<T, DK, MINB, DV>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(kernel,
                           cudaFuncAttributePreferredSharedMemoryCarveout,
                           cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return e;
  // batch*heads on x (up to 2^31 - 1 blocks: OpenSora's temporal
  // attention has B*S*H = 65536 at 8 requests under CFG), query tiles on y
  const dim3 grid(a.B * a.H, (a.Lq + BQ - 1) / BQ);
  kernel<<<grid, THREADS, smem, stream>>>(a);
  return cudaGetLastError();
}

// One instance per head dim that a caller runs (DiT-XL/2's 72, 80 in bf16,
// and the tests' 16, 32, 64, 128); any other D takes the next one up, whose
// padding columns are zeros.  MLA's (96, 64) has its own f32 instance.
cudaError_t launch_f32(const Args& a, cudaStream_t s) {
  if (a.Dv < a.D && a.D > 72 && a.D <= 96 && a.Dv <= 64)
    return launch<float, 96, 64>(a, s);
  if (a.D <= 16) return launch<float, 16>(a, s);
  if (a.D <= 32) return launch<float, 32>(a, s);
  if (a.D <= 64) return launch<float, 64>(a, s);
  if (a.D <= 72) return launch<float, 72>(a, s);
  return launch<float, 128>(a, s);
}

cudaError_t launch_bf16(const Args& a, cudaStream_t s) {
  using B16 = __nv_bfloat16;
  if (a.D <= 16) return launch<B16, 16>(a, s);
  if (a.D <= 32) return launch<B16, 32>(a, s);
  if (a.D <= 64) return launch<B16, 64>(a, s);
  if (a.D <= 80) return launch<B16, 80>(a, s);
  return launch<B16, 128>(a, s);
}

// ---------------------------------------------------------------------------
// Head dims 129..256 (Gemma-2's 256), f32 and bf16.
//
// What bounds it: at Gemma-2-9B's prefill (B 2, L 4352, 16 query heads over
// 8 KV heads, D 256, causal) the causal band is 3.1e11 flops, 9.3e11 as
// 3xTF32, 1.9 ms at 495 TFLOP/s, against 0.13 ms for q/k/v/o's bytes: bound
// by operations, as at D <= 128.
//
// Why attn_fwd does not stretch to D 256: each of its threads keeps its Q
// fragments (KS * 4 values) and its output accumulator (NO * 4) in
// registers, 128 + 64 at D 128, where it already takes 255 registers.  At
// D 256 that is 256 + 128.  This kernel keeps Q in shared memory for the
// block's whole life and reads one k-step's fragment at a time (4 values,
// split into big and small as attn_fwd splits its register copy), so a
// thread holds the output accumulator (128 registers), one score tile and
// the running max and sum.
// - 8 warps, BQW = 128 query rows (16 a warp), K/V tiles of BKW = 16 keys,
//   double-buffered with the same cp.async / plain-load staging.  Shared
//   memory in f32: Q 128 x 260 x 4 B = 133.1 KB and two stages of K and V,
//   4 x 16 x 260 x 4 B = 66.6 KB: 199.7 KB, one block an SM (8 warps of 255
//   registers fill the SM's 65,536).  bf16: 101.4 KB.
// - Rows hold the head dim padded with zeros to 256, plus 4 f32 or 8 bf16
//   words, so that a warp's fragment loads hit 32 banks.
// - Everything else is attn_fwd's: the 3xTF32 split, the masks and the
//   tiles they skip, the online softmax in base 2, P straight from the
//   score registers, a fixed order of every sum (bitwise repeatable).
// - V may have a head dim Dv of its own, Dv <= D (DeepSeek-V3's MLA: q and
//   k carry nope + rope = 192 columns, v 128).  V is staged at Dv columns
//   (its columns Dv..DKW-1 are cleared once with Q and the stages and
//   never written: K and V keep their halves of each stage) and O written
//   at Dv.  An instance's DVW (n-tiles of the output) defaults to DKW; the
//   f32 instance with DVW 128 takes any Dv <= 128 and keeps 16 output
//   n-tiles where the DKW one would run 32, 16 of them on zeros, and half
//   the output accumulator.  At DeepSeek-V3's prefill (B 4, L 1024, H
//   128, causal) the band is 1.72e11 flops, 5.16e11 as 3xTF32, 1.04 ms
//   at 495 TFLOP/s, against 0.40 ms for q/k/v/o's bytes: bound by
//   operations.
constexpr int BQW = 128;                      // query rows per block
constexpr int BKW = 16;                       // keys per K/V tile
constexpr int THREADS_W = 32 * (BQW / 16);
constexpr int DKW = 256;                      // the padded head dim
static_assert(THREADS_W == DKW, "plain staging gives a thread one column");

// Rows [row0, row0 + n) of a (rows, D) matrix with row stride rs into dst
// (n rows of STR elements); rows at or past `rows` are staged as zeros and
// the columns D..DKW-1 are never written.  With cp.async a thread copies
// one fixed 16 B chunk of every (THREADS_W / CPR)-th row, with plain loads
// one fixed column of every row.
template <typename T, int STR>
__device__ __forceinline__ void stage_wide(T* dst, const T* src, long long rs,
                                           int row0, int rows, int n, int D,
                                           bool vec) {
  if (vec) {
    constexpr int E = 16 / (int)sizeof(T);  // elements per copy
    constexpr int CPR = DKW / E;            // copies per padded row
    const int c = (threadIdx.x % CPR) * E;
    if (c >= D) return;
    for (int r = threadIdx.x / CPR; r < n; r += THREADS_W / CPR) {
      const int row = row0 + r;
      const bool in = row < rows;
      const T* s = src + (in ? row * rs : 0) + c;
      const unsigned sa =
          static_cast<unsigned>(__cvta_generic_to_shared(dst + r * STR + c));
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(sa),
                   "l"(s), "r"(in ? 16 : 0)
                   : "memory");
    }
  } else {
    const int c = threadIdx.x;
    if (c >= D) return;
    for (int r = 0; r < n; ++r) {
      const int row = row0 + r;
      dst[r * STR + c] = row < rows ? src[row * rs + c] : zero<T>();
    }
  }
}

// DVW: the output's n-tiles (DVW / 8), at least V's head dim Dv.
template <typename T, int DVW = DKW>
__global__ void __launch_bounds__(THREADS_W, 1) attn_fwd_wide(const Args a) {
  constexpr bool F32 = std::is_same<T, float>::value;
  constexpr int STR = DKW + (F32 ? 4 : 8);     // shared row stride
  constexpr int KS = F32 ? DKW / 8 : DKW / 16;  // k-steps of Q·Kᵀ
  constexpr int NO = DVW / 8;                   // n-tiles of the output
  static_assert(DVW <= DKW && DVW % (F32 ? 8 : 16) == 0, "DVW");
  constexpr int NS = BKW / 8;                   // n-tiles of a score tile
  constexpr int QSZ = BQW * STR;                // the Q tile
  constexpr int TILE = 2 * BKW * STR;           // one K/V stage

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sq = reinterpret_cast<T*>(smem_raw);
  T* skv = sq + QSZ;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int b = blockIdx.x / a.H;
  const int h = blockIdx.x % a.H;
  const int hk = h / (a.H / a.KV);
  const int q0 = blockIdx.y * BQW;
  const bool vec = a.vec != 0;
  const T* qp = static_cast<const T*>(a.q) + b * a.sqb + h * a.sqh;
  const T* kp = static_cast<const T*>(a.k) + b * a.skb + hk * a.skh;
  const T* vp = static_cast<const T*>(a.v) + b * a.svb + hk * a.svh;

  // Zero Q and both stages once: the padding columns (D..DKW-1 of Q and K,
  // Dv..DKW-1 of V) are never written.
  for (int i = threadIdx.x; i < (QSZ + 2 * TILE) * (int)sizeof(T) / 16;
       i += THREADS_W)
    reinterpret_cast<uint4*>(smem_raw)[i] = make_uint4(0, 0, 0, 0);
  __syncthreads();

  // Key tiles that hold an unmasked key for some row of this query tile.
  int k_begin = 0, k_end = a.Lk;
  if (a.causal) k_end = min(k_end, q0 + BQW);
  if (a.window > 0) k_begin = max(0, q0 - a.window + 1);
  k_begin = (k_begin / BKW) * BKW;
  const int ntiles = k_end > k_begin ? (k_end - k_begin + BKW - 1) / BKW : 0;

  // Q and the first K/V tile (stage 0) in one group; tile `it` lives in
  // stage it & 1.
  stage_wide<T, STR>(sq, qp, a.sql, q0, a.Lq, BQW, a.D, vec);
  if (ntiles > 0) {
    stage_wide<T, STR>(skv, kp, a.skl, k_begin, a.Lk, BKW, a.D, vec);
    stage_wide<T, STR>(skv + BKW * STR, vp, a.svl, k_begin, a.Lk, BKW, a.Dv,
                       vec);
  }
  cp_commit();

  float o[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) o[n][i] = 0.f;
  // this thread's rows: g (fragment entries 0, 1) and g + 8 (entries 2, 3)
  const int row0 = q0 + warp * 16 + g, row1 = row0 + 8;
  float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;
  const float sl2 = a.scale * LOG2E;
  const T* qs = sq + (warp * 16 + g) * STR;

  for (int it = 0; it < ntiles; ++it) {
    const int kt = k_begin + it * BKW;
    if (it + 1 < ntiles) {
      T* nxt = skv + ((it + 1) & 1) * TILE;
      stage_wide<T, STR>(nxt, kp, a.skl, kt + BKW, a.Lk, BKW, a.D, vec);
      stage_wide<T, STR>(nxt + BKW * STR, vp, a.svl, kt + BKW, a.Lk, BKW,
                         a.Dv, vec);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    const T* ks_ = skv + (it & 1) * TILE;
    const T* vs_ = ks_ + BKW * STR;

    // S = Q·Kᵀ for this warp's 16 rows and the tile's 16 keys, Q's
    // fragments read from shared memory one k-step at a time
    float s[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[n][i] = 0.f;
#pragma unroll 4
    for (int ks = 0; ks < KS; ++ks) {
      if constexpr (F32) {
        const float* r = qs + ks * 8 + t;
        uint32_t ab[4], as[4];
        split(r[0], ab[0], as[0]);
        split(r[8 * STR], ab[1], as[1]);
        split(r[4], ab[2], as[2]);
        split(r[8 * STR + 4], ab[3], as[3]);
#pragma unroll
        for (int n = 0; n < NS; ++n) {
          const float* kr = ks_ + (n * 8 + g) * STR + ks * 8 + t;
          mma_3xtf32(s[n], ab, as, kr[0], kr[4]);
        }
      } else {
        const T* r = qs + ks * 16 + 2 * t;
        const uint32_t qa[4] = {ld32(r), ld32(r + 8 * STR), ld32(r + 8),
                                ld32(r + 8 * STR + 8)};
#pragma unroll
        for (int n = 0; n < NS; ++n) {
          const T* kr = ks_ + (n * 8 + g) * STR + ks * 16 + 2 * t;
          mma_bf16(s[n], qa, ld32(kr), ld32(kr + 8));
        }
      }
    }

    // online softmax in base 2; masked entries never reach exp2.  A tile
    // that no mask reaches for any row of the block skips the masks.
    const bool edge = kt + BKW > a.Lk || (a.causal && kt + BKW - 1 > q0) ||
                      (a.window > 0 && kt <= q0 + BQW - 1 - a.window);
    if (a.softcap > 0.f) {
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          s[n][i] = a.softcap * tanhf(s[n][i] * a.scale / a.softcap) * LOG2E;
    } else {
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) s[n][i] *= sl2;
    }
    unsigned ok = (1u << (NS * 4)) - 1u;
    if (edge) {
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int key = kt + n * 8 + 2 * t + (i & 1);
          const int row = i < 2 ? row0 : row1;
          bool in = key < a.Lk;
          if (a.causal) in = in && key <= row;
          if (a.window > 0) in = in && key > row - a.window;
          if (!in) {
            s[n][i] = NEG_INF;
            ok &= ~(1u << (n * 4 + i));
          }
        }
    }
    float mx0 = NEG_INF, mx1 = NEG_INF;
#pragma unroll
    for (int n = 0; n < NS; ++n) {
      mx0 = fmaxf(mx0, fmaxf(s[n][0], s[n][1]));
      mx1 = fmaxf(mx1, fmaxf(s[n][2], s[n][3]));
    }
#pragma unroll
    for (int sh = 1; sh <= 2; sh <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, sh));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, sh));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float al0 = exp2f(m0 - mn0), al1 = exp2f(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float ps0 = 0.f, ps1 = 0.f;  // this thread's part of the row sums
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = (ok >> (n * 4 + i) & 1u)
                            ? exp2f(s[n][i] - (i < 2 ? m0 : m1))
                            : 0.f;
        s[n][i] = p;
        if (i < 2)
          ps0 += p;
        else
          ps1 += p;
      }
    l0 = l0 * al0 + ps0;
    l1 = l1 * al1 + ps1;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      o[n][0] *= al0;
      o[n][1] *= al0;
      o[n][2] *= al1;
      o[n][3] *= al1;
    }

    // O += P·V, P straight from the score registers
    if constexpr (F32) {
#pragma unroll
      for (int kk = 0; kk < NS; ++kk) {
        // A fragment (row, k t / t+4) = scores (row, key 2t / 2t+1)
        uint32_t pb[4], pl[4];
        split(s[kk][0], pb[0], pl[0]);
        split(s[kk][2], pb[1], pl[1]);
        split(s[kk][1], pb[2], pl[2]);
        split(s[kk][3], pb[3], pl[3]);
        const float* vr = vs_ + (kk * 8 + 2 * t) * STR + g;
#pragma unroll
        for (int n = 0; n < NO; ++n)
          mma_3xtf32(o[n], pb, pl, vr[n * 8], vr[n * 8 + STR]);
      }
    } else {
#pragma unroll
      for (int j = 0; j < NS / 2; ++j) {
        const uint32_t pa[4] = {pack_bf16(s[2 * j][0], s[2 * j][1]),
                                pack_bf16(s[2 * j][2], s[2 * j][3]),
                                pack_bf16(s[2 * j + 1][0], s[2 * j + 1][1]),
                                pack_bf16(s[2 * j + 1][2], s[2 * j + 1][3])};
        const unsigned short* vr =
            reinterpret_cast<const unsigned short*>(vs_) +
            (j * 16 + 2 * t) * STR + g;
#pragma unroll
        for (int n = 0; n < NO; ++n) {
          const unsigned short* c = vr + n * 8;
          mma_bf16(o[n], pa, c[0] | (uint32_t)c[STR] << 16,
                   c[8 * STR] | (uint32_t)c[9 * STR] << 16);
        }
      }
    }
    __syncthreads();  // every warp is done with this stage
  }
  cp_wait<0>();  // no tile: Q's group is still in flight

#pragma unroll
  for (int sh = 1; sh <= 2; sh <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, sh);
    l1 += __shfl_xor_sync(0xffffffffu, l1, sh);
  }
  const float d0 = fmaxf(l0, 1e-20f), d1 = fmaxf(l1, 1e-20f);
  T* ob = static_cast<T*>(a.o) + b * a.sob + h * a.soh;
#pragma unroll
  for (int n = 0; n < NO; ++n) {
    const int c = n * 8 + 2 * t;
    if (row0 < a.Lq) {
      T* p = ob + row0 * a.sol + c;
      if (c < a.Dv) store(p, o[n][0] / d0);
      if (c + 1 < a.Dv) store(p + 1, o[n][1] / d0);
    }
    if (row1 < a.Lq) {
      T* p = ob + row1 * a.sol + c;
      if (c < a.Dv) store(p, o[n][2] / d1);
      if (c + 1 < a.Dv) store(p + 1, o[n][3] / d1);
    }
  }
}

template <typename T, int DVW = DKW>
cudaError_t launch_wide(const Args& a, cudaStream_t stream) {
  constexpr int STR = DKW + (std::is_same<T, float>::value ? 4 : 8);
  const int smem = (int)((BQW + 2 * 2 * BKW) * STR * sizeof(T));
  const auto kernel = attn_fwd_wide<T, DVW>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(kernel,
                           cudaFuncAttributePreferredSharedMemoryCarveout,
                           cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return e;
  const dim3 grid(a.B * a.H, (a.Lq + BQW - 1) / BQW);
  kernel<<<grid, THREADS_W, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  vec: 1 when q, k and v's pointers and
// strides are multiples of 16 bytes and D and Dv of 16 / element size, so
// that rows are staged with cp.async; 0 stages them with plain loads.
// Returns a cudaError_t (0 = launched).  The caller checks shapes, strides,
// devices and `vec`; nothing here allocates or synchronizes.
extern "C" int flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, int dtype, int B,
    int Lq, int Lk, int H, int KV, int D, int Dv, long long sqb, long long sql,
    long long sqh, long long skb, long long skl, long long skh, long long svb,
    long long svl, long long svh, long long sob, long long sol, long long soh,
    float scale, int causal, int window, float softcap, int vec,
    void* stream) {
  if (D < 1 || D > DKW || Dv < 1 || Dv > D || KV < 1 || H % KV != 0 ||
      (long long)B * H > 2147483647LL || (Lq + BQ - 1) / BQ > 65535)
    return (int)cudaErrorInvalidValue;
  const Args a{q,   k,   v,   o,   B,   Lq,  Lk,    H,      KV,     D,
               Dv,  sqb, sql, sqh, skb, skl, skh,   svb,    svl,    svh,
               sob, sol, soh, scale, causal, window, softcap, vec};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  // f32 with Dv <= 128 (DeepSeek-V3's MLA: 192, 128) takes the instance
  // whose output has 16 n-tiles; any other Dv < D above 128 the DKW one,
  // with V's columns Dv..DKW-1 zero
  if (D > 128 && dtype == 0 && Dv <= 128)
    return (int)launch_wide<float, 128>(a, s);
  if (D > 128 && dtype == 0) return (int)launch_wide<float>(a, s);
  if (D > 128 && dtype == 1) return (int)launch_wide<__nv_bfloat16>(a, s);
  if (dtype == 0) return (int)launch_f32(a, s);
  if (dtype == 1) return (int)launch_bf16(a, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
