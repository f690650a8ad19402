// Windowed max-log-MAP pass of the LTE 8-state RSC trellis, for Hopper
// (sm_90a).  Replaces the Pallas TPU kernel `turbo_pallas._map_kernel`
// (srsran_tpu/phy/fec/turbo_pallas.py, launched by map_windows_pallas) in
// both of its modes: the static one (dyn=False, one K per launch) and the
// dynamic-K one (dyn=True, the `kq` input; see below).  The plain PyTorch
// version is `srsran_tpu_torch.phy.fec.turbo.map_windows_plain`.
//
// Layout: a lane is one (codeblock, window) pair; every input is
// (rows, bn) float32 with the lane index fastest, so a warp's loads of one
// row are coalesced.  One thread runs one lane:
//   1. fused boundary training: alpha forward over the T positions before
//      the window and beta backward over the T positions after it, both
//      from zero metrics;
//   2. window 0 takes the exact state-0 start, the last window the exact
//      tail beta (b_known);
//   3. fused counter-recursions over the window: alpha runs forward while
//      beta runs backward.  The first lw/2 steps store alpha and beta
//      (scratch, lane fastest); the last lw/2 steps emit two posteriors
//      each, L(t) = max_s(alpha+beta1) - max_s(alpha+beta0), one from the
//      live alpha with a stored beta, one from a stored alpha with the live
//      beta.  An odd lw emits its middle position between the halves.
//   4. dynamic-K mode (template parameter DYN): codeblocks of any size
//      K <= K_max share one launch.  Positions >= K carry zero LLRs
//      (erasures), and each lane gets kq = K - w*lw when that lies in
//      [1, lw], else 0.  Wherever the live backward carry is beta at local
//      position q == kq it is replaced by the lane's b_known (the
//      codeblock's exact tail beta_K) before it is stored or used; q == lw
//      takes the place of b_mask, which is all zero in this mode.
//      Posteriors at positions >= K are garbage by contract.
// Metrics stay in registers (8 alpha + 8 beta per thread).  No
// renormalisation: float32 holds a window's metric growth, and constant
// offsets cancel in the posterior.  -1e30 stands for minus infinity and
// only ever meets finite numbers, so no inf - inf (NaN) can arise.
//
// What bounds it on the card: each lane is a serial dependency chain of
// T + lw trellis steps; at the headline shape (T=32, lw=88,
// bn = 1408 codeblocks x 64 windows = 90112 lanes) about 140 MB of inputs
// and outputs move per pass, plus the metric scratch (lw x 8 floats per
// lane, ~254 MB written and read once).  The arithmetic is ~30 add/max per
// step and lane.  The dynamic-K mode runs one transport block per launch
// (K_max=6144: T=24, lw=96, at most 16 codeblocks x 64 windows = 1024
// lanes, 8 blocks on 132 SMs): its bytes move in under a microsecond and
// its time is the launch plus the serial chain of T + lw = 120 steps.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr float kNegInf = -1e30f;

// One forward step.  State s = r0 + 2 r1 + 4 r2; predecessors of s are s>>1
// (input u0) and (s>>1)+4 (input 1-u0), and the branch metric of the first
// is +-p or +-q with p = x + z, q = x - z (x, z: half-scaled systematic and
// parity LLRs).
__device__ __forceinline__ void alpha_step(float a[8], float x, float z) {
  const float p = x + z, q = x - z;
  const float n0 = fmaxf(a[0] - p, a[4] + p);
  const float n1 = fmaxf(a[0] + p, a[4] - p);
  const float n2 = fmaxf(a[1] - q, a[5] + q);
  const float n3 = fmaxf(a[1] + q, a[5] - q);
  const float n4 = fmaxf(a[2] + q, a[6] - q);
  const float n5 = fmaxf(a[2] - q, a[6] + q);
  const float n6 = fmaxf(a[3] + p, a[7] - p);
  const float n7 = fmaxf(a[3] - p, a[7] + p);
  a[0] = n0; a[1] = n1; a[2] = n2; a[3] = n3;
  a[4] = n4; a[5] = n5; a[6] = n6; a[7] = n7;
}

// Backward branch metrics of one position: b0[s] / b1[s] is beta of the
// successor of s under input 0 / 1 plus that branch's metric.
__device__ __forceinline__ void beta_branches(const float b[8], float x, float z,
                                              float b0[8], float b1[8]) {
  const float p = x + z, q = x - z;
  b0[0] = b[0] - p; b1[0] = b[1] + p;
  b0[1] = b[2] - q; b1[1] = b[3] + q;
  b0[2] = b[5] - q; b1[2] = b[4] + q;
  b0[3] = b[7] - p; b1[3] = b[6] + p;
  b0[4] = b[1] - p; b1[4] = b[0] + p;
  b0[5] = b[3] - q; b1[5] = b[2] + q;
  b0[6] = b[4] - q; b1[6] = b[5] + q;
  b0[7] = b[6] - p; b1[7] = b[7] + p;
}

__device__ __forceinline__ void beta_step(float b[8], float x, float z) {
  float b0[8], b1[8];
  beta_branches(b, x, z, b0, b1);
#pragma unroll
  for (int s = 0; s < 8; ++s) b[s] = fmaxf(b0[s], b1[s]);
}

// Posterior of one position from alpha before it and beta after it.
__device__ __forceinline__ float posterior(const float a[8], const float b[8],
                                           float x, float z) {
  float b0[8], b1[8];
  beta_branches(b, x, z, b0, b1);
  float m0 = a[0] + b0[0], m1 = a[0] + b1[0];
#pragma unroll
  for (int s = 1; s < 8; ++s) {
    m0 = fmaxf(m0, a[s] + b0[s]);
    m1 = fmaxf(m1, a[s] + b1[s]);
  }
  return m1 - m0;
}

__device__ __forceinline__ void store8(float* dst, size_t stride, const float v[8]) {
#pragma unroll
  for (int s = 0; s < 8; ++s) dst[s * stride] = v[s];
}

__device__ __forceinline__ void load8(const float* src, size_t stride, float v[8]) {
#pragma unroll
  for (int s = 0; s < 8; ++s) v[s] = src[s * stride];
}

template <bool DYN>
__global__ void map_window_kernel(
    const float* __restrict__ axt, const float* __restrict__ azt,
    const float* __restrict__ ax, const float* __restrict__ az,
    const float* __restrict__ bxt, const float* __restrict__ bzt,
    const float* __restrict__ amask, const float* __restrict__ bmask,
    const float* __restrict__ bknown, const int* __restrict__ kq,
    float* __restrict__ out, float* __restrict__ scr, int T, int lw, int bn) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= bn) return;
  const size_t n = (size_t)bn;  // row stride
  const int h = lw / 2;
  // scratch: A[i] = alpha at position i, B[i] = beta at position lw-i,
  // for i < h; each (8, bn)
  float* A = scr + lane;
  float* B = scr + (size_t)h * 8 * n + lane;

  float a[8], b[8];
#pragma unroll
  for (int s = 0; s < 8; ++s) { a[s] = 0.0f; b[s] = 0.0f; }
  for (int t = 0; t < T; ++t) {
    alpha_step(a, axt[t * n + lane], azt[t * n + lane]);
    beta_step(b, bxt[(T - 1 - t) * n + lane], bzt[(T - 1 - t) * n + lane]);
  }
  if (amask[lane] > 0.0f) {
    a[0] = 0.0f;
#pragma unroll
    for (int s = 1; s < 8; ++s) a[s] = kNegInf;
  }
  if (bmask[lane] > 0.0f) load8(bknown + lane, n, b);
  const int kqv = DYN ? kq[lane] : 0;  // local position of beta_K, 0 = none

  for (int i = 0; i < h; ++i) {
    const int m = lw - 1 - i;
    if (DYN && kqv == lw - i) load8(bknown + lane, n, b);  // b is beta_{lw-i}
    store8(A + (size_t)i * 8 * n, n, a);
    store8(B + (size_t)i * 8 * n, n, b);
    alpha_step(a, ax[i * n + lane], az[i * n + lane]);
    beta_step(b, ax[m * n + lane], az[m * n + lane]);
  }
  if (lw & 1) {  // middle position h: alpha_h and beta_{h+1} are both live
    const float x = ax[h * n + lane], z = az[h * n + lane];
    if (DYN && kqv == h + 1) load8(bknown + lane, n, b);
    out[h * n + lane] = posterior(a, b, x, z);
    alpha_step(a, x, z);
    beta_step(b, x, z);
  }
  // now a = alpha_{lw-h}, b = beta_h
  for (int i = 0; i < h; ++i) {
    const int j = lw - h + i;  // forward position: live alpha, stored beta_{j+1}
    const int m = h - 1 - i;   // mirrored position: stored alpha, live beta_{m+1}
    const float xj = ax[j * n + lane], zj = az[j * n + lane];
    const float xm = ax[m * n + lane], zm = az[m * n + lane];
    if (DYN && kqv == m + 1) load8(bknown + lane, n, b);
    float st[8];
    load8(B + (size_t)m * 8 * n, n, st);  // B[h-1-i] = beta_{j+1}
    out[j * n + lane] = posterior(a, st, xj, zj);
    load8(A + (size_t)m * 8 * n, n, st);  // A[m] = alpha_m
    out[m * n + lane] = posterior(st, b, xm, zm);
    alpha_step(a, xj, zj);
    beta_step(b, xm, zm);
  }
}

// Launches one mode on `stream`; returns cudaGetLastError() after the
// launch (0 = launched).
template <bool DYN>
int launch(const float* axt, const float* azt, const float* ax, const float* az,
           const float* bxt, const float* bzt, const float* amask,
           const float* bmask, const float* bknown, const int* kq, float* out,
           float* scr, int T, int lw, int bn, void* stream) {
  if (T < 0 || T > lw || lw < 1 || bn < 1) return (int)cudaErrorInvalidValue;
  const int threads = 128;
  const int blocks = (bn + threads - 1) / threads;
  map_window_kernel<DYN><<<blocks, threads, 0, (cudaStream_t)stream>>>(
      axt, azt, ax, az, bxt, bzt, amask, bmask, bknown, kq, out, scr, T, lw, bn);
  return (int)cudaGetLastError();
}

}  // namespace

// The static mode.  `scr` holds 2 * (lw / 2) * 8 * bn floats.
extern "C" int map_window_launch(
    const float* axt, const float* azt, const float* ax, const float* az,
    const float* bxt, const float* bzt, const float* amask, const float* bmask,
    const float* bknown, float* out, float* scr, int T, int lw, int bn,
    void* stream) {
  return launch<false>(axt, azt, ax, az, bxt, bzt, amask, bmask, bknown, nullptr,
                       out, scr, T, lw, bn, stream);
}

// The dynamic-K mode: as above plus `kq` (bn ints, see the header).
extern "C" int map_window_dyn_launch(
    const float* axt, const float* azt, const float* ax, const float* az,
    const float* bxt, const float* bzt, const float* amask, const float* bmask,
    const float* bknown, const int* kq, float* out, float* scr, int T, int lw,
    int bn, void* stream) {
  if (kq == nullptr) return (int)cudaErrorInvalidValue;
  return launch<true>(axt, azt, ax, az, bxt, bzt, amask, bmask, bknown, kq, out,
                      scr, T, lw, bn, stream);
}
