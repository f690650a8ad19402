// The 4x4 MMSE detector of closed-loop spatial multiplexing on 4 ports
// (TM4 at rank 4, TS 36.211 §6.3.4.2.3), for Hopper (sm_90a): per resource
// element (RE), the received y (4 antennas) and the channel estimate h (4
// antennas x 4 ports) in, the equalised layers x (4) and each layer's CSI
// out.  It replaces no TPU kernel: the JAX package leaves this solve to
// XLA (`srsran_tpu/phy/mimo.py predecode_mmse_nl`, `jnp.linalg.solve` and
// `inv`).  The port's form of that, `torch.linalg.solve` and `inv` over
// (B, M, 4, 4), checks its `info` on the host after each call, so no CUDA
// graph can hold it; and no library call computes the fold, the solve and
// the CSI in one pass.  The plain PyTorch version, the same arithmetic as
// elementwise operations over (B, M) planes, is
// `srsran_tpu_torch.phy.mimo_cuda.mmse4_plain`.
//
// What it computes, per RE of subframe b (noise power s2 = noise[b]):
//   1. the effective channel G = H W of the codebook matrix W (4 ports x
//      4 layers), one receive antenna's row at a time;
//   2. A = G^H G + s2 I (Hermitian: its upper triangle, the diagonal real)
//      and c = G^H y, summed over the antennas in order;
//   3. the Cholesky factor A = L L^H (L lower, its diagonal real and
//      positive: A is positive definite for s2 > 0) with d_i = 1 / L_ii;
//   4. x = A^-1 c by the forward (L z = c) and back (L^H x = z)
//      substitutions;
//   5. csi_l = 1 / [A^-1]_ll, with [A^-1]_ll = sum_k |(L^-1)_kl|^2 from the
//      lower-triangular inverse L^-1.
//
// Layout: y (B, 4, M), h (B, 4, 4, M), x (B, 4, M) complex64; csi (B, 4,
// M) float32; w (4, 4) complex64 (port, layer); noise (B,) float32, all
// contiguous.  One thread an RE, the REs of a subframe consecutive, so a
// warp's loads and stores of each plane are coalesced 8- or 4-byte runs.
//
// What bounds it: bytes.  An RE reads 128 B of h and 32 B of y and writes
// 32 B of x and 16 B of csi: 208 B, 181 MB at 128 subframes of 6800 REs,
// 0.054 ms at 3.35 TB/s; its ~1100 floating-point operations take a third
// of that at 67 TFLOP/s.  So the design reads each input once, keeps every
// intermediate (a row of G, A's 10 entries, c, L, z) in registers, and
// writes each output once: about 60 registers a thread, no shared memory.

#include <cuda_runtime.h>

namespace {

struct cf {
  float re, im;
};

__device__ __forceinline__ cf mul(cf a, cf b) {
  return {a.re * b.re - a.im * b.im, a.re * b.im + a.im * b.re};
}

// conj(a) * b
__device__ __forceinline__ cf mulc(cf a, cf b) {
  return {a.re * b.re + a.im * b.im, a.re * b.im - a.im * b.re};
}

// a * conj(b)
__device__ __forceinline__ cf mul_conj(cf a, cf b) {
  return {a.re * b.re + a.im * b.im, a.im * b.re - a.re * b.im};
}

__device__ __forceinline__ cf add(cf a, cf b) { return {a.re + b.re, a.im + b.im}; }
__device__ __forceinline__ cf sub(cf a, cf b) { return {a.re - b.re, a.im - b.im}; }
__device__ __forceinline__ cf scale(cf a, float s) { return {a.re * s, a.im * s}; }
__device__ __forceinline__ cf cconj(cf a) { return {a.re, -a.im}; }
__device__ __forceinline__ float norm2(cf a) { return a.re * a.re + a.im * a.im; }

__device__ __forceinline__ cf load(const float2* p) {
  const float2 v = __ldg(p);
  return {v.x, v.y};
}

__global__ void __launch_bounds__(256) mmse4_kernel(const float2* __restrict__ y,
                                                    const float2* __restrict__ h,
                                                    const float2* __restrict__ w,
                                                    const float* __restrict__ noise,
                                                    float2* __restrict__ x,
                                                    float* __restrict__ csi, int n_sf, int m) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (long long)n_sf * m) return;
  const long long b = t / m;
  const long long k = t - b * m;

  cf wm[4][4];
#pragma unroll
  for (int p = 0; p < 4; ++p) {
#pragma unroll
    for (int l = 0; l < 4; ++l) wm[p][l] = load(w + 4 * p + l);
  }

  // A's upper triangle (a[i][j], j >= i; the diagonal's real part) and c
  float a_d[4];
  cf a_u[4][4];
  cf c[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    cf hr[4];
#pragma unroll
    for (int p = 0; p < 4; ++p) hr[p] = load(h + ((b * 4 + r) * 4 + p) * m + k);
    const cf yr = load(y + (b * 4 + r) * m + k);
    cf g[4];
#pragma unroll
    for (int l = 0; l < 4; ++l) {
      g[l] = mul(hr[0], wm[0][l]);
#pragma unroll
      for (int p = 1; p < 4; ++p) g[l] = add(g[l], mul(hr[p], wm[p][l]));
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float di = norm2(g[i]);
      const cf ci = mulc(g[i], yr);
      a_d[i] = r == 0 ? di : a_d[i] + di;
      c[i] = r == 0 ? ci : add(c[i], ci);
#pragma unroll
      for (int j = i + 1; j < 4; ++j) {
        const cf e = mulc(g[i], g[j]);
        a_u[i][j] = r == 0 ? e : add(a_u[i][j], e);
      }
    }
  }
  const float s2 = __ldg(noise + b);
#pragma unroll
  for (int i = 0; i < 4; ++i) a_d[i] += s2;

  // Cholesky: L_i0 = A_i0 / L_00 with A_i0 = conj(A_0i), and so on
  const float l00 = sqrtf(a_d[0]);
  const float d0 = 1.0f / l00;
  const cf l10 = scale(cconj(a_u[0][1]), d0);
  const cf l20 = scale(cconj(a_u[0][2]), d0);
  const cf l30 = scale(cconj(a_u[0][3]), d0);
  const float l11 = sqrtf(a_d[1] - norm2(l10));
  const float d1 = 1.0f / l11;
  const cf l21 = scale(sub(cconj(a_u[1][2]), mul_conj(l20, l10)), d1);
  const cf l31 = scale(sub(cconj(a_u[1][3]), mul_conj(l30, l10)), d1);
  const float l22 = sqrtf(a_d[2] - norm2(l20) - norm2(l21));
  const float d2 = 1.0f / l22;
  const cf l32 = scale(sub(sub(cconj(a_u[2][3]), mul_conj(l30, l20)), mul_conj(l31, l21)), d2);
  const float l33 = sqrtf(a_d[3] - norm2(l30) - norm2(l31) - norm2(l32));
  const float d3 = 1.0f / l33;

  // L z = c, then L^H x = z
  const cf z0 = scale(c[0], d0);
  const cf z1 = scale(sub(c[1], mul(l10, z0)), d1);
  const cf z2 = scale(sub(sub(c[2], mul(l20, z0)), mul(l21, z1)), d2);
  const cf z3 = scale(sub(sub(sub(c[3], mul(l30, z0)), mul(l31, z1)), mul(l32, z2)), d3);
  const cf x3 = scale(z3, d3);
  const cf x2 = scale(sub(z2, mulc(l32, x3)), d2);
  const cf x1 = scale(sub(sub(z1, mulc(l21, x2)), mulc(l31, x3)), d1);
  const cf x0 = scale(sub(sub(sub(z0, mulc(l10, x1)), mulc(l20, x2)), mulc(l30, x3)), d0);

  // L^-1 (lower; its diagonal d_i), then [A^-1]_ll = sum_k |(L^-1)_kl|^2
  const cf m10 = scale(scale(l10, d0), -d1);
  const cf m20 = scale(add(scale(l20, d0), mul(l21, m10)), -d2);
  const cf m21 = scale(scale(l21, d1), -d2);
  const cf m30 = scale(add(add(scale(l30, d0), mul(l31, m10)), mul(l32, m20)), -d3);
  const cf m31 = scale(add(scale(l31, d1), mul(l32, m21)), -d3);
  const cf m32 = scale(scale(l32, d2), -d3);
  const float inv0 = d0 * d0 + norm2(m10) + norm2(m20) + norm2(m30);
  const float inv1 = d1 * d1 + norm2(m21) + norm2(m31);
  const float inv2 = d2 * d2 + norm2(m32);
  const float inv3 = d3 * d3;

  const cf xs[4] = {x0, x1, x2, x3};
  const float invs[4] = {inv0, inv1, inv2, inv3};
#pragma unroll
  for (int l = 0; l < 4; ++l) {
    x[(b * 4 + l) * m + k] = make_float2(xs[l].re, xs[l].im);
    csi[(b * 4 + l) * m + k] = 1.0f / invs[l];
  }
}

}  // namespace

// One detection over n_sf subframes of m REs each (layouts above).
// Launches on `stream`; returns the CUDA error of the launch (0 = launched).
extern "C" int mmse4_launch(const void* y, const void* h, const void* w, const float* noise,
                            void* x, float* csi, int n_sf, int m, void* stream) {
  if (n_sf < 1 || m < 1) return (int)cudaErrorInvalidValue;
  const long long n = (long long)n_sf * m;
  const int threads = 256;
  const long long blocks = (n + threads - 1) / threads;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  mmse4_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const float2*)y, (const float2*)h, (const float2*)w, noise, (float2*)x, csi, n_sf, m);
  return (int)cudaGetLastError();
}
