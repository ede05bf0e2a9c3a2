// Fused window + sheared-conv kernel of the scan codec, for Hopper (sm_90a).
//
// Replaces the JAX package's Pallas TPU kernel
// pseudocylindrical_convolution_tpu/codec/pallas_fused.py::_fused_kernel.
// One call is one layer-step of the fused profile: it assembles the skew
// window of the layer buffer (B, Sbuf, CC) on chip, with the device code
// of the window kernel (window_common.cuh, so every window element has the
// bits of window_kernel.py::window_plain), and contracts it with the
// layer's sheared 9x5 kernel. For image b, band p, row r < h and output
// channel (s, g, j):
//
//   out[b,p,r,(s,g,j)] = sum over dt < 9, di < 5, ci < CI of
//       win[b,p,r+di, G-1-g+dt, cs0+ci] * K[(s,g), (dt,di,ci), j]
//
// with cs0 = s*CI on a hidden layer (CC = 3*CI, one channel slice per
// subnet) and cs0 = 0 on the input plane (CC = CI, every subnet reads the
// same G channels). K is (3*G, 45*CI, n) in the buffer type, laid out as
// read: each block streams its own contiguous 45*CI*n slice. The output is
// fp32 (B, npart, h, 3*G*n) before bias and PReLU. Only the kept window
// slices of each output group are contracted; the TPU kernel's c-fold
// excess per group chunk was a Mosaic blocking artefact.
//
// Numerics: every product is taken in fp32 from upcast operands (exact for
// bf16 x bf16) and the sums are fp32. The order of the sums is fixed by the
// shapes alone: each thread walks its strided share of the 45*CI terms in
// order, then a butterfly over the warp and an in-order sum over the warps.
// No atomics and no split across blocks, so a launch gives the same bits
// every time, which is what lets an encode and a decode of a fused stream
// agree. The order differs from the plain version's (45 tap matmuls), so
// the two agree within a tolerance (fused_kernel.py).
//
// What bounds it: bytes. At the flagship hidden layer (B=1, npart=16, h=4,
// G=48, CI=144, n=3) K alone is 45*144*432 bf16 = 5.6 MB, the distinct
// buffer rows about 4 MB, the cells 0.1 MB; 0.36 GFLOP is a tenth of the
// byte time at the bf16 tensor rate. The window (6.2 MB if written out)
// never reaches device memory, and the 9x5 taps are never materialised.
// The design: one block per (subnet, group, image, band), 2,304 blocks at
// the flagship, blocks of one (subnet, group) adjacent so they meet their
// K slice in L2. A block stages the (h+4, 9, CI) sub-window its group reads
// (20.7 KB bf16 at CI=144) in shared memory, 16-byte vectors along the
// channels, then each thread reduces its share of the terms for all h*n
// outputs in registers. The 11 hidden layers hold 62 MB of K, more than the
// 50 MB L2, so K streams from device memory on every step.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "window_common.cuh"

namespace {

using pcwin::InteriorRow;
using pcwin::Pack;
using pcwin::PadRow;
using pcwin::to_f;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxH = 8;     // window rows h+4 <= 12
constexpr int kMaxN = 4;     // output channels per (subnet, group)
constexpr int kTaps = 45;    // 9 window positions x 5 rows

// Bytes of the staged sub-window, rounded up to keep what follows aligned.
__host__ __device__ inline size_t window_bytes(int h, int CI, size_t elem) {
  return ((static_cast<size_t>(h + 4) * 9 * CI * elem) + 15) / 16 * 16;
}

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
    fused_kernel(const T* __restrict__ buf, const int* __restrict__ starts,
                 const int* __restrict__ j0, const int* __restrict__ tpos,
                 const T* __restrict__ v6, const int* __restrict__ pstarts,
                 const int* __restrict__ colz, const T* __restrict__ wz,
                 const int* __restrict__ wl, const T* __restrict__ k,
                 float* __restrict__ out, int nimg, int npart, int h, int Tw,
                 int CC, int CI, int n, int Sbuf) {
  typedef Pack<T, VEC> P;
  extern __shared__ __align__(16) unsigned char smem[];
  T* win = reinterpret_cast<T*>(smem);                    // (h+4, 9, CI)
  float* red = reinterpret_cast<float*>(
      smem + window_bytes(h, CI, sizeof(T)));             // (warps, H, N)
  const int G = Tw - 8;
  const int ib = blockIdx.x % nimg;       // image * npart + band
  const int sg = blockIdx.x / nimg;       // subnet * G + group
  const int g = sg % G;
  const int bi = ib / npart;
  const int band = ib - bi * npart;
  const int t0 = G - 1 - g;               // first window slice group g reads
  const int cs0 = CC == CI ? 0 : (sg / G) * CI;
  const T* bufb = buf + static_cast<size_t>(bi) * Sbuf * CC;

  // 1. The sub-window: rows [0, h+4), positions [t0, t0+9), channels
  //    [cs0, cs0+CI), element for element the window kernel's values.
  const int nvec = CI / VEC;
  const int per_row = 9 * nvec;
  for (int rp = 0; rp < h + 4; ++rp) {
    T* wrow = win + static_cast<size_t>(rp) * 9 * CI;
    if (rp >= 2 && rp < h + 2) {
      const InteriorRow<T> row = pcwin::interior_row(
          bufb, starts, j0, tpos, v6, wl, bi, npart, h, band, rp - 2, CC);
      for (int i = threadIdx.x; i < per_row; i += kThreads) {
        const int dt = i / nvec;
        const int c = (i - dt * nvec) * VEC;
        *reinterpret_cast<P*>(wrow + dt * CI + c) =
            pcwin::interior_pack<T, VEC>(row, t0 + dt, cs0 + c, CC);
      }
    } else {
      const PadRow<T> row = pcwin::pad_row(bufb, pstarts, colz, wz, band,
                                           rp < 2 ? rp : rp - h, Tw, CC);
      for (int i = threadIdx.x; i < per_row; i += kThreads) {
        const int dt = i / nvec;
        const int c = (i - dt * nvec) * VEC;
        *reinterpret_cast<P*>(wrow + dt * CI + c) =
            pcwin::pad_pack<T, VEC>(row, t0 + dt, cs0 + c, CC);
      }
    }
  }
  __syncthreads();

  // 2. Each thread: terms q = tid, tid + kThreads, ... of the 45*CI, in
  //    order, for every (r, j) output; q runs over (dt, di, ci) as K's rows.
  const int nq = kTaps * CI;
  const T* kc = k + static_cast<size_t>(sg) * nq * n;
  float acc[kMaxH][kMaxN];
#pragma unroll
  for (int r = 0; r < kMaxH; ++r)
#pragma unroll
    for (int j = 0; j < kMaxN; ++j) acc[r][j] = 0.f;
  for (int q = threadIdx.x; q < nq; q += kThreads) {
    const int tp = q / CI;
    const int ci = q - tp * CI;
    const int dt = tp / 5;
    const int di = tp - dt * 5;
    float kv[kMaxN];
#pragma unroll
    for (int j = 0; j < kMaxN; ++j)
      kv[j] = j < n ? to_f(kc[static_cast<size_t>(q) * n + j]) : 0.f;
    const T* wcol = win + (static_cast<size_t>(di) * 9 + dt) * CI + ci;
#pragma unroll
    for (int r = 0; r < kMaxH; ++r) {
      if (r < h) {
        const float x = to_f(wcol[static_cast<size_t>(r) * 9 * CI]);
#pragma unroll
        for (int j = 0; j < kMaxN; ++j)
          if (j < n) acc[r][j] = fmaf(x, kv[j], acc[r][j]);
      }
    }
  }

  // 3. Fixed-order reduction: a butterfly within each warp, then the warps'
  //    sums added in warp order.
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int r = 0; r < kMaxH; ++r) {
#pragma unroll
    for (int j = 0; j < kMaxN; ++j) {
      if (r < h && j < n) {
        float v = acc[r][j];
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          v += __shfl_xor_sync(0xffffffffu, v, off);
        if (lane == 0) red[(warp * kMaxH + r) * kMaxN + j] = v;
      }
    }
  }
  __syncthreads();
  if (threadIdx.x < h * n) {
    const int r = threadIdx.x / n;
    const int j = threadIdx.x - r * n;
    float v = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) v += red[(w * kMaxH + r) * kMaxN + j];
    out[(static_cast<size_t>(ib * h + r) * 3 * G + sg) * n + j] = v;
  }
}

template <typename T, int VEC>
int run(const void* buf, const void* starts, const void* j0,
        const void* tpos, const void* v6, const void* pstarts,
        const void* colz, const void* wz, const void* wl, const void* k,
        void* out, int B, int npart, int h, int Tw, int CC, int CI, int n,
        int Sbuf, cudaStream_t st) {
  const size_t smem = window_bytes(h, CI, sizeof(T))
      + sizeof(float) * kWarps * kMaxH * kMaxN;
  auto kern = fused_kernel<T, VEC>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid(3 * (Tw - 8) * B * npart);
  kern<<<grid, kThreads, smem, st>>>(
      static_cast<const T*>(buf), static_cast<const int*>(starts),
      static_cast<const int*>(j0), static_cast<const int*>(tpos),
      static_cast<const T*>(v6), static_cast<const int*>(pstarts),
      static_cast<const int*>(colz), static_cast<const T*>(wz),
      static_cast<const int*>(wl), static_cast<const T*>(k),
      static_cast<float*>(out), B * npart, npart, h, Tw, CC, CI, n, Sbuf);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* buf, const void* starts, const void* j0,
           const void* tpos, const void* v6, const void* pstarts,
           const void* colz, const void* wz, const void* wl, const void* k,
           void* out, int B, int npart, int h, int Tw, int CC, int CI, int n,
           int Sbuf, void* stream) {
  if (h < 1 || h > kMaxH || n < 1 || n > kMaxN || Tw < 9 || CI < 1
      || (CC != CI && CC != 3 * CI))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  constexpr int kVec = 16 / sizeof(T);
  const bool aligned = reinterpret_cast<uintptr_t>(buf) % 16 == 0
      && reinterpret_cast<uintptr_t>(v6) % 16 == 0;
  if (aligned && CC % kVec == 0 && CI % kVec == 0)
    return run<T, kVec>(buf, starts, j0, tpos, v6, pstarts, colz, wz, wl, k,
                        out, B, npart, h, Tw, CC, CI, n, Sbuf, st);
  return run<T, 1>(buf, starts, j0, tpos, v6, pstarts, colz, wz, wl, k, out,
                   B, npart, h, Tw, CC, CI, n, Sbuf, st);
}

}  // namespace

extern "C" {

// Returns the cudaError_t of the launch (0 = launched).
int pc_fused_bf16(const void* buf, const void* starts, const void* j0,
                  const void* tpos, const void* v6, const void* pstarts,
                  const void* colz, const void* wz, const void* wl,
                  const void* k, void* out, int B, int npart, int h, int Tw,
                  int CC, int CI, int n, int Sbuf, void* stream) {
  return launch<__nv_bfloat16>(buf, starts, j0, tpos, v6, pstarts, colz, wz,
                               wl, k, out, B, npart, h, Tw, CC, CI, n, Sbuf,
                               stream);
}

int pc_fused_f32(const void* buf, const void* starts, const void* j0,
                 const void* tpos, const void* v6, const void* pstarts,
                 const void* colz, const void* wz, const void* wl,
                 const void* k, void* out, int B, int npart, int h, int Tw,
                 int CC, int CI, int n, int Sbuf, void* stream) {
  return launch<float>(buf, starts, j0, tpos, v6, pstarts, colz, wz, wl, k,
                       out, B, npart, h, Tw, CC, CI, n, Sbuf, stream);
}

}  // extern "C"
