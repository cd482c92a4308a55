// Flash attention forward for Hopper (sm_90a), plain FP32 FMA arithmetic.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py
// (`flash_attention`, body `_attn_kernel`): the same function — online
// softmax with an fp32 accumulator and fp32 running max and sum, masks for
// padded keys, causal and sliding window, Gemma-2 softcap cap*tanh(s/cap),
// GQA head h -> kv head h / (H/KV), fully masked rows give 0, denominator
// max(l, 1e-20) — but not its blocking.
//
// What bounds it: at the DiT-XL/2 shape (B=8, L=256, H=KV=16, D=72) the
// work is 4*B*H*L*L*D = 2.4 GFLOP against 38 MB of q/k/v/o, 64 FLOP per
// byte, above the ~20 FLOP/byte where the card's FP32 (non-tensor) rate
// and its HBM rate cross: it is bound by operations.  This first version
// spends its operations on plain FMAs (no wgmma, TMA or warp
// specialization) and keeps every byte of K/V that a block reads in shared
// memory, so each K/V element comes from device memory once per 64-row
// query tile.
//
// Design: one block of 256 threads per (batch*head, 64-row query tile).
// Four threads share a query row: each scores 16 of the tile's 64 keys and
// accumulates a quarter of the head dimension (dims sub, sub+4, ...).  Rows
// are read in their (B, L, H, D) layout through strides; D is any value up
// to 128 (72 for DiT-XL/2), bounded at run time in the loops, so no padding
// reaches device memory.  Shared-memory rows of q and k use an odd stride
// (D+1) so the 8 rows of a warp fall into 8 different banks.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BQ = 64;           // query rows per block
constexpr int BK = 64;           // keys per shared-memory tile
constexpr int QUAD = 4;          // threads per query row
constexpr int THREADS = BQ * QUAD;
constexpr int KPT = BK / QUAD;   // keys scored per thread per tile
constexpr float NEG_INF = -2.0e38f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int B, Lq, Lk, H, KV, D;
  long long sqb, sql, sqh, skb, skl, skh, svb, svl, svh, sob, sol, soh;
  float scale;
  int causal;
  int window;     // 0: no sliding window
  float softcap;  // 0: no softcap
};

// DP is the head dimension rounded up to a multiple of 32 (the size of the
// per-thread accumulator); the loops stop at the run-time D.
template <typename T, int DP>
__global__ void __launch_bounds__(THREADS)
attn_fwd(const Args a) {
  extern __shared__ float smem[];
  const int D = a.D;
  const int qs = D + 1;
  float* Qs = smem;              // BQ x qs
  float* Ks = Qs + BQ * qs;      // BK x qs
  float* Vs = Ks + BK * qs;      // BK x D
  float* Ps = Vs + BK * D;       // BQ x (BK + 1)

  const int tid = threadIdx.x;
  const int r = tid / QUAD;
  const int sub = tid % QUAD;
  const int b = blockIdx.y / a.H;
  const int h = blockIdx.y % a.H;
  const int hk = h / (a.H / a.KV);
  const int q0 = blockIdx.x * BQ;
  const int qpos = q0 + r;

  const T* qp = static_cast<const T*>(a.q) + b * a.sqb + h * a.sqh;
  const T* kp = static_cast<const T*>(a.k) + b * a.skb + hk * a.skh;
  const T* vp = static_cast<const T*>(a.v) + b * a.svb + hk * a.svh;

  for (int i = tid; i < BQ * D; i += THREADS) {
    const int row = i / D, d = i - row * D;
    const int l = q0 + row;
    Qs[row * qs + d] = l < a.Lq ? to_f32(qp[l * a.sql + d]) : 0.f;
  }

  // Key tiles that hold an unmasked key for some row of this query tile.
  int k_begin = 0, k_end = a.Lk;
  if (a.causal) k_end = min(k_end, q0 + BQ);
  if (a.window > 0) k_begin = max(0, q0 - a.window + 1);
  k_begin = (k_begin / BK) * BK;

  float m = NEG_INF, l = 0.f;
  float acc[DP / QUAD];
#pragma unroll
  for (int c = 0; c < DP / QUAD; ++c) acc[c] = 0.f;

  for (int kt = k_begin; kt < k_end; kt += BK) {
    __syncthreads();  // every thread is done with the previous tile
    for (int i = tid; i < BK * D; i += THREADS) {
      const int row = i / D, d = i - row * D;
      const int j = kt + row;
      const bool in = j < a.Lk;
      Ks[row * qs + d] = in ? to_f32(kp[j * a.skl + d]) : 0.f;
      Vs[row * D + d] = in ? to_f32(vp[j * a.svl + d]) : 0.f;
    }
    __syncthreads();

    float s[KPT];
#pragma unroll
    for (int i = 0; i < KPT; ++i) s[i] = 0.f;
    const float* qrow = Qs + r * qs;
    for (int d = 0; d < D; ++d) {
      const float qd = qrow[d];
#pragma unroll
      for (int i = 0; i < KPT; ++i)
        s[i] = fmaf(qd, Ks[(sub + QUAD * i) * qs + d], s[i]);
    }

    unsigned ok_bits = 0;
    float tmax = NEG_INF;
#pragma unroll
    for (int i = 0; i < KPT; ++i) {
      const int kpos = kt + sub + QUAD * i;
      float x = s[i] * a.scale;
      if (a.softcap > 0.f) x = a.softcap * tanhf(x / a.softcap);
      bool ok = kpos < a.Lk;
      if (a.causal) ok = ok && kpos <= qpos;
      if (a.window > 0) ok = ok && kpos > qpos - a.window;
      s[i] = ok ? x : NEG_INF;
      ok_bits |= (ok ? 1u : 0u) << i;
      tmax = fmaxf(tmax, s[i]);
    }
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 2));
    const float m_new = fmaxf(m, tmax);
    const float alpha = expf(m - m_new);
    float psum = 0.f;
    float* prow = Ps + r * (BK + 1);
#pragma unroll
    for (int i = 0; i < KPT; ++i) {
      // a fully masked row has m_new = NEG_INF and exp(0) = 1: zero it
      const float p = (ok_bits >> i & 1u) ? expf(s[i] - m_new) : 0.f;
      prow[sub + QUAD * i] = p;
      psum += p;
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    psum += __shfl_xor_sync(0xffffffffu, psum, 2);
    l = l * alpha + psum;
    m = m_new;
    __syncwarp();  // a row's probabilities are written and read by its quad

#pragma unroll
    for (int c = 0; c < DP / QUAD; ++c) acc[c] *= alpha;
    const int jn = min(BK, a.Lk - kt);
    for (int j = 0; j < jn; ++j) {
      const float p = prow[j];
      const float* vrow = Vs + j * D + sub;
#pragma unroll
      for (int c = 0; c < DP / QUAD; ++c)
        if (sub + QUAD * c < D) acc[c] = fmaf(p, vrow[QUAD * c], acc[c]);
    }
  }

  if (qpos < a.Lq) {
    const float denom = fmaxf(l, 1e-20f);
    T* op = static_cast<T*>(a.o) + b * a.sob + qpos * a.sol + h * a.soh;
#pragma unroll
    for (int c = 0; c < DP / QUAD; ++c) {
      const int d = sub + QUAD * c;
      if (d < D) store(op + d, acc[c] / denom);
    }
  }
}

template <typename T, int DP>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const size_t smem = sizeof(float) *
      (size_t)(BQ * (a.D + 1) + BK * (a.D + 1) + BK * a.D + BQ * (BK + 1));
  cudaError_t e = cudaFuncSetAttribute(
      attn_fwd<T, DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((a.Lq + BQ - 1) / BQ, a.B * a.H);
  attn_fwd<T, DP><<<grid, THREADS, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dtype(const Args& a, cudaStream_t stream) {
  if (a.D <= 32) return launch<T, 32>(a, stream);
  if (a.D <= 64) return launch<T, 64>(a, stream);
  if (a.D <= 96) return launch<T, 96>(a, stream);
  return launch<T, 128>(a, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Returns a cudaError_t (0 = launched).
// The caller checks shapes, strides and devices; nothing here allocates or
// synchronizes.
extern "C" int flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, int dtype, int B,
    int Lq, int Lk, int H, int KV, int D, long long sqb, long long sql,
    long long sqh, long long skb, long long skl, long long skh, long long svb,
    long long svl, long long svh, long long sob, long long sol, long long soh,
    float scale, int causal, int window, float softcap, void* stream) {
  if (D < 1 || D > 128 || KV < 1 || H % KV != 0 || B * H > 65535)
    return (int)cudaErrorInvalidValue;
  const Args a{q,   k,   v,   o,   B,   Lq,  Lk,  H,     KV,     D,
               sqb, sql, sqh, skb, skl, skh, svb, svl,   svh,    sob,
               sol, soh, scale, causal, window, softcap};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch_dtype<float>(a, s);
  if (dtype == 1) return (int)launch_dtype<__nv_bfloat16>(a, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
