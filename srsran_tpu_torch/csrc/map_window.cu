// Windowed max-log-MAP pass of the LTE 8-state RSC trellis, for Hopper
// (sm_90a): (B, K) LLRs in, (B, K) posteriors out.  Replaces the Pallas TPU
// kernel `turbo_pallas._map_kernel` (srsran_tpu/phy/fec/turbo_pallas.py,
// launched by map_windows_pallas) in both of its modes, the static one
// (dyn=False, one K per launch) and the dynamic-K one (dyn=True), together
// with the lane-layout copies that fed it and undid it.  The plain PyTorch
// version is `srsran_tpu_torch.phy.fec.turbo.map_pass_plain`.
//
// What it computes.  A codeblock of K = nw * lw positions is cut into nw
// windows of lw; a lane is one (codeblock, window) pair:
//   1. boundary training: alpha forward over the T positions before the
//      window and beta backward over the T positions after it, both from
//      zero metrics; positions before 0 and at or beyond K are zero;
//   2. window 0 takes the exact state-0 start, the last window the exact
//      tail beta (`beta_k`, one row of 8 per codeblock);
//   3. counter-recursions over the window: alpha runs forward while beta
//      runs backward.  Over the first lw/2 steps both are kept, over the
//      last lw/2 steps each position's posterior,
//      L(t) = max_s(alpha+beta1) - max_s(alpha+beta0), comes from the live
//      alpha with a kept beta (upper half-window) or from a kept alpha with
//      the live beta (lower half).  An odd lw has a middle position, taken
//      from alpha_h and beta_{h+1} between the halves.
//   4. dynamic-K mode (template parameter DYN): codeblocks of any size
//      K_i <= K share one launch.  Positions >= K_i carry zero LLRs
//      (erasures), and the lane whose window holds position K_i, at local
//      position kq = K_i - w*lw in [1, lw], replaces its backward carry by
//      beta_k wherever that carry is beta at local position kq, before it
//      is kept or used; kq == lw takes the place of step 2's tail beta.
//      Posteriors at positions >= K_i are garbage by contract.
// No renormalisation: float32 holds a window's metric growth, and constant
// offsets cancel in the posterior.  -1e30 stands for minus infinity and
// only ever meets finite numbers, so no inf - inf (NaN) can arise.  Every
// value is computed by the same operations on the same operands as in the
// plain version (a rebuilt metric too), so the two agree bit for bit.
//
// Design for the card.
// * A block takes `cpb` consecutive codeblocks (one at the large K, several
//   at the small ones, where a codeblock has few windows) and stages their
//   half-scaled x, z in shared memory once, with coalesced 16-byte loads,
//   eight in flight per thread.  Every window's neighbours are then at hand:
//   the training needs no copies of its own.  Window l of the block starts
//   at l * (lw | 1): the odd stride puts the lanes of a warp on different
//   banks.
// * Two threads run a lane, in different warps: a forward one (alpha) and a
//   backward one (beta).  They meet once, at a __syncthreads in the middle
//   of the window.  That doubles the warps that the shared memory allows
//   (the recursion is a chain of dependent add/max, so an SM needs warps,
//   not wider threads) and halves a lane's chain.
// * Keeping all lw/2 alphas and betas of a lane (lw * 32 B: 2.8 KB at lw=88)
//   does not fit beside the inputs at K=6144.  So each thread keeps its
//   metric only every CKPT-th step of the first half (two float4 per entry,
//   lane fastest: conflict-free), and in the second half each thread
//   rebuilds the *other* direction's metrics, a segment of CKPT at a time,
//   from those checkpoints into registers, by the very steps that made
//   them: the forward thread needs beta_{j+1} beside its live alpha_j, the
//   backward thread alpha_m beside its live beta_{m+1}.  One more trellis
//   step per position, and 2 * ceil(lw/2 / CKPT) * 32 B per lane (384 B at
//   lw=88 or 96).  At K=6144 a block takes 49,664 B of inputs + 24,576 B of
//   checkpoints = 74,240 B: three blocks, twelve warps, on an SM.
// * Posteriors overwrite x in shared memory: after the middle the forward
//   thread reads and writes only the upper half-window, the backward one
//   only the lower, each position is read for the last time before it is
//   written, and all training is over.  They leave with coalesced stores.
//   The only device memory touched is the inputs, read once, and the
//   output, written once; the wrapper allocates no scratch.
//
// What bounds it: the rate at which add/max instructions start, not
// bytes.  A thread runs T + lw/2 + 2 * lw/2 trellis steps and lw/2
// posteriors, about 6,500 instructions at T=32, lw=88; the headline shape (1408 codeblocks of
// K=5632) is 3.56 waves of 396 blocks, ~41 us at one instruction per
// scheduler and cycle (maxima run at half rate on sm_90), against a byte
// bound of 0.028 ms for its 95 MB.  The dynamic-K mode runs one transport
// block per launch (at most 16 codeblocks of K=6144, 16 blocks): its time
// is one thread's chain out of shared memory.
//
// Alternatives tried or weighed: one thread per lane with the rebuilt
// segment in shared memory (102 KB a block, two blocks and four warps per
// SM: about three times the time of this design at the headline shape);
// keeping every metric (does not fit); one thread per state with shuffles
// (eight times the warps, but two shuffles per step and a three-level
// reduction per posterior on a kernel bound by its instruction count).
// Registers (nvcc 12.9 -Xptxas -v, sm_90a): 118 static mode, 121 dynamic-K,
// 0 bytes spilled in both; 128 threads a block at the large K.

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int CKPT = 8;               // steps between two kept metrics
constexpr int kSmemMax = 232448;      // dynamic shared memory a block may ask for

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

// One kept metric vector: entry e of a lane is two float4, lane fastest.
__device__ __forceinline__ void store8(float4* dst, int nl, const float v[8]) {
  dst[0] = make_float4(v[0], v[1], v[2], v[3]);
  dst[nl] = make_float4(v[4], v[5], v[6], v[7]);
}

__device__ __forceinline__ void load8(const float4* src, int nl, float v[8]) {
  const float4 lo = src[0], hi = src[nl];
  v[0] = lo.x; v[1] = lo.y; v[2] = lo.z; v[3] = lo.w;
  v[4] = hi.x; v[5] = hi.y; v[6] = hi.z; v[7] = hi.w;
}

__device__ __forceinline__ void copy8(float dst[8], const float src[8]) {
#pragma unroll
  for (int s = 0; s < 8; ++s) dst[s] = src[s];
}

__host__ __device__ inline int pad4(int n) { return (n + 3) & ~3; }
__host__ __device__ inline int pad32(int n) { return (n + 31) & ~31; }

// Kept metric vectors of a lane and direction: one per segment of the
// first half-window, and for an odd lw one more for the middle position.
__host__ __device__ inline int kept_entries(int lw) {
  return (lw / 2 + CKPT - 1) / CKPT + (lw & 1);
}

// Shared memory of a block of `nl` lanes: x and z (nl windows at stride
// lw | 1, rounded up to 16 bytes each), then per lane and direction
// kept_entries(lw) metric vectors of 32 bytes.
__host__ __device__ inline size_t smem_bytes(int nl, int lw) {
  return (size_t)2 * pad4(nl * (lw | 1)) * 4 + (size_t)nl * 2 * kept_entries(lw) * 32;
}

// What a thread knows of its lane.
struct Lane {
  float* x;          // this lane's window of half-scaled systematic LLRs
  float* z;          // and of parity LLRs, in shared memory
  float4* ck_a;      // kept alphas, entry e at ck_a[e * 2 * nl]
  float4* ck_b;      // kept betas
  int nl, stride, lw, T, nseg;
  bool first, last;  // window 0 / the last window of its codeblock
  int kq;            // dynamic-K: local position of beta_K in [1, lw], 0 = none
  float bk[8];       // the codeblock's exact beta_K
};

// Stages n_elem floats of lx and lz, half-scaled, in the strided shared
// layout.  `vec` moves 16 bytes a thread (lw % 4 == 0, aligned pointers);
// four loads of each array are in flight per thread before the first store.
__device__ __forceinline__ void stage_in(const float* __restrict__ lx,
                                         const float* __restrict__ lz, float* xs,
                                         float* zs, int n_elem, int lw, int stride,
                                         bool vec) {
  constexpr int U = 4;
  if (vec) {
    const int step = 4 * blockDim.x;
    for (int e0 = 4 * threadIdx.x; e0 < n_elem; e0 += U * step) {
      float4 vx[U], vz[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int e = e0 + u * step;
        if (e < n_elem) {
          vx[u] = __ldg(reinterpret_cast<const float4*>(lx + e));
          vz[u] = __ldg(reinterpret_cast<const float4*>(lz + e));
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int e = e0 + u * step;
        if (e < n_elem) {
          const int l = e / lw;
          const int at = l * stride + (e - l * lw);
          xs[at] = 0.5f * vx[u].x; xs[at + 1] = 0.5f * vx[u].y;
          xs[at + 2] = 0.5f * vx[u].z; xs[at + 3] = 0.5f * vx[u].w;
          zs[at] = 0.5f * vz[u].x; zs[at + 1] = 0.5f * vz[u].y;
          zs[at + 2] = 0.5f * vz[u].z; zs[at + 3] = 0.5f * vz[u].w;
        }
      }
    }
  } else {
    for (int e = threadIdx.x; e < n_elem; e += blockDim.x) {
      const int l = e / lw;
      const int at = l * stride + (e - l * lw);
      xs[at] = 0.5f * __ldg(lx + e);
      zs[at] = 0.5f * __ldg(lz + e);
    }
  }
}

// Writes the posteriors, which took x's place in shared memory, to `out`.
__device__ __forceinline__ void stage_out(float* __restrict__ out, const float* xs,
                                          int n_elem, int lw, int stride, bool vec) {
  if (vec) {
    for (int e = 4 * threadIdx.x; e < n_elem; e += 4 * blockDim.x) {
      const int l = e / lw;
      const float* s = xs + l * stride + (e - l * lw);
      *reinterpret_cast<float4*>(out + e) = make_float4(s[0], s[1], s[2], s[3]);
    }
  } else {
    for (int e = threadIdx.x; e < n_elem; e += blockDim.x) {
      const int l = e / lw;
      out[e] = xs[l * stride + (e - l * lw)];
    }
  }
}

// The forward thread of a lane, up to the middle of the window: training
// over the last T positions of the window before (zeros before position 0),
// then alpha over the first half, keeping alpha_i at every CKPT-th i.
// Leaves a = alpha_{lw/2}.
__device__ __forceinline__ void alpha_first_half(const Lane& ln, float a[8]) {
#pragma unroll
  for (int s = 0; s < 8; ++s) a[s] = 0.0f;
  if (ln.first) {
    a[0] = 0.0f;  // the exact state-0 start; its training would be discarded
#pragma unroll
    for (int s = 1; s < 8; ++s) a[s] = kNegInf;
  } else {
    const float* px = ln.x - ln.stride + (ln.lw - ln.T);
    const float* pz = ln.z - ln.stride + (ln.lw - ln.T);
    for (int i = 0; i < ln.T; ++i) alpha_step(a, px[i], pz[i]);
  }
  const int h = ln.lw / 2;
  for (int i = 0; i < h; ++i) {
    if (i % CKPT == 0) store8(ln.ck_a + (size_t)(i / CKPT) * 2 * ln.nl, ln.nl, a);
    alpha_step(a, ln.x[i], ln.z[i]);
  }
}

// The backward thread of a lane, down to the middle: training over the
// first T positions of the window after (zeros at and beyond K), then beta
// over the second half, keeping beta_{lw-i} at every CKPT-th i; an odd lw
// also keeps beta_{h+1} for the middle position h and steps over it.
// Leaves b = beta_h.
template <bool DYN>
__device__ __forceinline__ void beta_first_half(const Lane& ln, float b[8]) {
  const int lw = ln.lw, h = lw / 2;
#pragma unroll
  for (int s = 0; s < 8; ++s) b[s] = 0.0f;
  if (!ln.last) {  // zeros leave zero metrics as they are
    const float* nx = ln.x + ln.stride;
    const float* nz = ln.z + ln.stride;
    for (int i = ln.T - 1; i >= 0; --i) beta_step(b, nx[i], nz[i]);
  } else if (!DYN) {
    copy8(b, ln.bk);
  }
  for (int i = 0; i < h; ++i) {
    if (DYN && ln.kq == lw - i) copy8(b, ln.bk);  // b is beta_{lw-i}
    if (i % CKPT == 0) store8(ln.ck_b + (size_t)(i / CKPT) * 2 * ln.nl, ln.nl, b);
    beta_step(b, ln.x[lw - 1 - i], ln.z[lw - 1 - i]);
  }
  if (lw & 1) {
    if (DYN && ln.kq == h + 1) copy8(b, ln.bk);
    store8(ln.ck_b + (size_t)ln.nseg * 2 * ln.nl, ln.nl, b);
    beta_step(b, ln.x[h], ln.z[h]);
  }
}

// The forward thread over the second half: positions j = lw-h .. lw-1 from
// the live alpha_j and beta_{j+1}, which it rebuilds segment by segment from
// the backward thread's checkpoints exactly as that thread made them.
template <bool DYN>
__device__ __forceinline__ void alpha_second_half(const Lane& ln, float a[8]) {
  const int lw = ln.lw, h = lw / 2;
  float* x = ln.x;
  const float* z = ln.z;
  if (lw & 1) {  // the middle position, from alpha_h and the kept beta_{h+1}
    float st[8];
    load8(ln.ck_b + (size_t)ln.nseg * 2 * ln.nl, ln.nl, st);
    const float xh = x[h], zh = z[h];
    x[h] = posterior(a, st, xh, zh);
    alpha_step(a, xh, zh);
  }
  for (int seg = ln.nseg - 1; seg >= 0; --seg) {
    const int i0 = seg * CKPT;
    const int len = min(CKPT, h - i0);
    float kept[CKPT][8];       // kept[r] = beta_{j+1} at j = lw-1-(i0+r)
    float xr[CKPT], zr[CKPT];  // the segment's LLRs, xr[r] at that j
#pragma unroll
    for (int r = 0; r < CKPT; ++r) {
      if (r < len) { xr[r] = x[lw - 1 - (i0 + r)]; zr[r] = z[lw - 1 - (i0 + r)]; }
    }
    load8(ln.ck_b + (size_t)seg * 2 * ln.nl, ln.nl, kept[0]);
#pragma unroll
    for (int r = 1; r < CKPT; ++r) {
      if (r < len) {
        copy8(kept[r], kept[r - 1]);
        beta_step(kept[r], xr[r - 1], zr[r - 1]);
        if (DYN && ln.kq == lw - (i0 + r)) copy8(kept[r], ln.bk);
      }
    }
#pragma unroll
    for (int r = CKPT - 1; r >= 0; --r) {
      if (r < len) {
        x[lw - 1 - (i0 + r)] = posterior(a, kept[r], xr[r], zr[r]);
        alpha_step(a, xr[r], zr[r]);
      }
    }
  }
}

// The backward thread over the first half: positions m = h-1 .. 0 from the
// live beta_{m+1} and alpha_m, rebuilt from the forward thread's
// checkpoints.
template <bool DYN>
__device__ __forceinline__ void beta_second_half(const Lane& ln, float b[8]) {
  const int h = ln.lw / 2;
  float* x = ln.x;
  const float* z = ln.z;
  for (int seg = ln.nseg - 1; seg >= 0; --seg) {
    const int i0 = seg * CKPT;
    const int len = min(CKPT, h - i0);
    float kept[CKPT][8];       // kept[r] = alpha_m at m = i0+r
    float xr[CKPT], zr[CKPT];  // the segment's LLRs, xr[r] at that m
#pragma unroll
    for (int r = 0; r < CKPT; ++r) {
      if (r < len) { xr[r] = x[i0 + r]; zr[r] = z[i0 + r]; }
    }
    load8(ln.ck_a + (size_t)seg * 2 * ln.nl, ln.nl, kept[0]);
#pragma unroll
    for (int r = 1; r < CKPT; ++r) {
      if (r < len) {
        copy8(kept[r], kept[r - 1]);
        alpha_step(kept[r], xr[r - 1], zr[r - 1]);
      }
    }
#pragma unroll
    for (int r = CKPT - 1; r >= 0; --r) {
      if (r < len) {
        if (DYN && ln.kq == i0 + r + 1) copy8(b, ln.bk);  // b is beta_{m+1}
        x[i0 + r] = posterior(kept[r], b, xr[r], zr[r]);
        beta_step(b, xr[r], zr[r]);
      }
    }
  }
}

template <bool DYN>
__global__ void map_window_kernel(
    const float* __restrict__ lx, const float* __restrict__ lz,
    const float* __restrict__ beta_k, const int* __restrict__ k_vec,
    float* __restrict__ out, int n_cb, int nw, int lw, int T, int cpb, int vec) {
  extern __shared__ float4 smem4[];
  const int nl = cpb * nw;     // lanes of a full block
  const int stride = lw | 1;   // of a window in shared memory
  const int k = nw * lw;
  float* xs = reinterpret_cast<float*>(smem4);
  float* zs = xs + pad4(nl * stride);
  float4* met = reinterpret_cast<float4*>(zs + pad4(nl * stride));

  const int cb0 = blockIdx.x * cpb;
  const int my_cbs = min(cpb, n_cb - cb0);
  const size_t g0 = (size_t)cb0 * k;
  stage_in(lx + g0, lz + g0, xs, zs, my_cbs * k, lw, stride, vec);
  __syncthreads();

  // threads [0, nl) run the lanes forward, threads [pad32(nl), pad32(nl) + nl)
  // run them backward: a warp holds one direction only
  const bool forward = threadIdx.x < pad32(nl);
  const int t = forward ? threadIdx.x : threadIdx.x - pad32(nl);
  const bool active = t < my_cbs * nw;
  Lane ln;
  float m[8];  // the live metrics: alpha in a forward thread, beta in a backward one
  if (active) {
    const int w = t % nw;
    const int cb = cb0 + t / nw;
    ln.x = xs + t * stride;
    ln.z = zs + t * stride;
    ln.nl = nl; ln.stride = stride; ln.lw = lw; ln.T = T;
    ln.nseg = (lw / 2 + CKPT - 1) / CKPT;
    ln.ck_a = met + t;
    ln.ck_b = ln.ck_a + (size_t)kept_entries(lw) * 2 * nl;
    ln.first = w == 0;
    ln.last = w == nw - 1;
    ln.kq = 0;
    if (DYN) {
      const int kl = k_vec[cb] - w * lw;
      ln.kq = (kl >= 1 && kl <= lw) ? kl : 0;
    }
#pragma unroll
    for (int s = 0; s < 8; ++s) ln.bk[s] = beta_k[(size_t)cb * 8 + s];
    if (forward) alpha_first_half(ln, m); else beta_first_half<DYN>(ln, m);
  }
  // every checkpoint is kept and every read of the first halves (the
  // neighbours' training included) is done: x may take the posteriors, the
  // forward threads writing the upper half-windows, the backward the lower
  __syncthreads();
  if (active) {
    if (forward) alpha_second_half<DYN>(ln, m); else beta_second_half<DYN>(ln, m);
  }
  __syncthreads();
  stage_out(out + g0, xs, my_cbs * k, lw, stride, vec);
}

template <bool DYN>
int launch(const float* lx, const float* lz, const float* beta_k, const int* k_vec,
           float* out, int n_cb, int nw, int lw, int T, int cpb, int smem,
           void* stream) {
  if (n_cb < 1 || nw < 1 || lw < 1 || T < 0 || T > lw || cpb < 1) {
    return (int)cudaErrorInvalidValue;
  }
  const int nl = cpb * nw;
  const int threads = pad32(nl) + nl;
  if (threads > 1024 || smem > kSmemMax || (size_t)smem != smem_bytes(nl, lw)) {
    return (int)cudaErrorInvalidValue;
  }
  static bool opted_in[64];  // per device: may take more than 48 KB
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= 64 || !opted_in[dev]) {
    err = cudaFuncSetAttribute(map_window_kernel<DYN>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
    if (err != cudaSuccess) return (int)err;
    if (dev >= 0 && dev < 64) opted_in[dev] = true;
  }
  const uintptr_t ptrs = (uintptr_t)lx | (uintptr_t)lz | (uintptr_t)out;
  const int vec = lw % 4 == 0 && ptrs % 16 == 0;
  const int blocks = (n_cb + cpb - 1) / cpb;
  map_window_kernel<DYN><<<blocks, threads, smem, (cudaStream_t)stream>>>(
      lx, lz, beta_k, k_vec, out, n_cb, nw, lw, T, cpb, vec);
  return (int)cudaGetLastError();
}

}  // namespace

// One pass over n_cb codeblocks of K = nw * lw: lx, lz, out (n_cb, K),
// beta_k (n_cb, 8), float32 contiguous.  `cpb` codeblocks go to a block
// with `smem` bytes of dynamic shared memory, which must be what that block
// needs (see smem_bytes).  Launches on `stream`; returns the CUDA error of
// the launch (0 = launched).
extern "C" int map_pass_launch(const float* lx, const float* lz, const float* beta_k,
                               float* out, int n_cb, int nw, int lw, int T, int cpb,
                               int smem, void* stream) {
  return launch<false>(lx, lz, beta_k, nullptr, out, n_cb, nw, lw, T, cpb, smem, stream);
}

// The dynamic-K mode: as above plus k_vec, the n_cb true sizes (int32).
extern "C" int map_pass_dyn_launch(const float* lx, const float* lz, const float* beta_k,
                                   const int* k_vec, float* out, int n_cb, int nw, int lw,
                                   int T, int cpb, int smem, void* stream) {
  if (k_vec == nullptr) return (int)cudaErrorInvalidValue;
  return launch<true>(lx, lz, beta_k, k_vec, out, n_cb, nw, lw, T, cpb, smem, stream);
}
