// RG-LRU scan for Hopper (sm_90a): the gated linear recurrence of
// Griffin / RecurrentGemma's recurrent block, fused into one launch.
//
// Replaces no TPU kernel: the JAX package computes this with
// `jax.lax.associative_scan` (src/repro/models/rglru.py, `apply_full`),
// which XLA fuses into the layer on the TPU.  In plain PyTorch on the card
// the same scan is either L sequential steps of a few launches each or a
// log-depth chain of passes over (B, L, W) f32 tensors; this kernel reads
// its inputs once and writes its output once.
//
// Function, per channel (b, w), from h = h0[b, w] (0 without h0):
//   r = sigmoid(ga), i = sigmoid(gx)
//   log_a = -c * softplus(a_param[w]) * r
//   gated = sqrt(max(1 - exp(2 log_a), 1e-12)) * i * xr
//   h = exp(log_a) * h + gated,  y = h * gate
// with softplus(v) = log1p(exp(-|v|)) + max(v, 0) (jnp.logaddexp(v, 0)).
// y (B, L, W) and the last h (B, W) are written; the h of earlier steps is
// not.  With h0 and L = 1 this is the decode step.
//
// What bounds it: at RecurrentGemma-2B's prefill (B 2, L 3072, W 2560, f32)
// the function reads xr, ga, gx and gate and writes y, 5 x 62.9 MB, ~20
// operations a step: bound by bytes (0.094 ms at 3.35 TB/s).  The
// recurrence along L is sequential, so its parallelism is B x W = 5120
// channels.
//
// Design: one thread per (b, w), looping over L; adjacent threads take
// adjacent w, so every step's loads and stores are coalesced along W.  The
// loads of a step do not depend on h: the loop takes UNROLL steps at a
// time and issues the next UNROLL steps' loads (4 per step) before it
// computes the current ones, so a step does not wait one memory latency.
// Only the FMA of h is a chain from step to step.  Inputs are read through
// their (B, L) strides; their W stride is 1.  Rows (b) are independent, so
// a row's bits do not depend on the batch it rides in.  This is the simple
// form: a chunked two-pass scan (chunk products of a, then the carries)
// would put more than B x W threads to work.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 64;
constexpr int UNROLL = 8;

struct Args {
  const float* xr;
  const float* ga;
  const float* gx;
  const float* gate;
  const float* a_param;
  const float* h0;
  float* y;
  float* hT;
  int B, L, W;
  float c;
  long long sxb, sxl, sab, sal, sgb, sgl, sqb, sql, shb;
};

__device__ __forceinline__ float sigmoid_f(float v) {
  return 1.f / (1.f + expf(-v));
}

__device__ __forceinline__ float softplus_f(float v) {
  return log1pf(expf(-fabsf(v))) + fmaxf(v, 0.f);
}

struct Step {
  float x[UNROLL], a[UNROLL], i[UNROLL], g[UNROLL];
};

__device__ __forceinline__ void load(const Args& p, Step& s, long long bx,
                                     long long ba, long long bi, long long bg,
                                     int t0) {
#pragma unroll
  for (int u = 0; u < UNROLL; ++u) {
    const long long t = t0 + u;
    if (t < p.L) {
      s.x[u] = __ldg(p.xr + bx + t * p.sxl);
      s.a[u] = __ldg(p.ga + ba + t * p.sal);
      s.i[u] = __ldg(p.gx + bi + t * p.sgl);
      s.g[u] = __ldg(p.gate + bg + t * p.sql);
    }
  }
}

__global__ void __launch_bounds__(THREADS) rglru_scan_kernel(const Args p) {
  const int w = blockIdx.x * THREADS + threadIdx.x;
  const int b = blockIdx.y;
  if (w >= p.W) return;
  const float neg_c_sp = -p.c * softplus_f(p.a_param[w]);
  float h = p.h0 ? p.h0[b * p.shb + w] : 0.f;
  const long long bx = b * p.sxb + w, ba = b * p.sab + w,
                  bi = b * p.sgb + w, bg = b * p.sqb + w;
  float* py = p.y + (long long)b * p.L * p.W + w;
  Step cur, nxt;
  load(p, cur, bx, ba, bi, bg, 0);
  for (int t0 = 0; t0 < p.L; t0 += UNROLL) {
    if (t0 + UNROLL < p.L) load(p, nxt, bx, ba, bi, bg, t0 + UNROLL);
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const long long t = t0 + u;
      if (t < p.L) {
        const float r = sigmoid_f(cur.a[u]);
        const float i = sigmoid_f(cur.i[u]);
        const float log_a = neg_c_sp * r;
        const float a2 = expf(2.f * log_a);
        const float gated = sqrtf(fmaxf(1.f - a2, 1e-12f)) * i * cur.x[u];
        h = expf(log_a) * h + gated;
        py[t * p.W] = h * cur.g[u];
      }
    }
    cur = nxt;
  }
  p.hT[(long long)b * p.W + w] = h;
}

}  // namespace

extern "C" int rglru_scan_f32(
    const void* xr, const void* ga, const void* gx, const void* gate,
    const void* a_param, const void* h0, void* y, void* hT, int B, int L,
    int W, float c, long long sxb, long long sxl, long long sab,
    long long sal, long long sgb, long long sgl, long long sqb,
    long long sql, long long shb, void* stream) {
  if (B < 1 || B > 65535 || L < 1 || W < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args args{static_cast<const float*>(xr),
                  static_cast<const float*>(ga),
                  static_cast<const float*>(gx),
                  static_cast<const float*>(gate),
                  static_cast<const float*>(a_param),
                  static_cast<const float*>(h0),
                  static_cast<float*>(y),
                  static_cast<float*>(hT),
                  B, L, W, c, sxb, sxl, sab, sal, sgb, sgl, sqb, sql, shb};
  const dim3 grid((W + THREADS - 1) / THREADS, B);
  rglru_scan_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      args);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* rglru_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
