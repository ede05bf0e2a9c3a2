// Skew-window kernel of the scan codec, for Hopper (sm_90a).
//
// Replaces the JAX package's Pallas TPU kernel
// pseudocylindrical_convolution_tpu/codec/pallas_window.py::_window_kernel.
// One call builds one layer-step's window (B, npart, h+4, T, CC) out of the
// layer buffer (B, Sbuf, CC), from per-step tables that
// codec/window_kernel.py::build_window_tables precomputes and audits:
// interior rows (a run of buffer rows, masked to the valid width, with <= 6
// patch values) and vertical-pad rows (two weighted single-row taps). The
// element-wise device code lives in window_common.cuh, shared with the
// fused window+conv kernel (fused.cu); its roundings are exactly those of
// the plain gather version (window_kernel.py::window_plain), so the two
// agree bit for bit.
//
// What bounds it: bytes. The output alone is (h+4)*T*CC*2 B per band in
// bf16, about 6.2 MB per layer-step at the flagship shape (B=1, npart=16,
// h=4, T=56, CC=432), and the reads are of the same order; there are no
// operations to speak of. The design streams: one block per (image, band,
// window row), its threads over (t, CC) in 16-byte vectors along CC, so
// neighbouring threads touch neighbouring addresses in both the read and
// the write. Each block reads its own indices. The TPU kernel held the
// whole buffer in VMEM and realigned runs with one-hot matmuls to satisfy
// Mosaic's tiling; here the ~8.5 MB flagship buffer sits in the 50 MB L2
// and each row is a plain load at any offset, so none of that carries over.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "window_common.cuh"

namespace {

using pcwin::InteriorRow;
using pcwin::Pack;
using pcwin::PadRow;

template <typename T, int VEC>
__global__ void __launch_bounds__(256)
    window_kernel(const T* __restrict__ buf, const int* __restrict__ starts,
                  const int* __restrict__ j0, const int* __restrict__ tpos,
                  const T* __restrict__ v6, const int* __restrict__ pstarts,
                  const int* __restrict__ colz, const T* __restrict__ wz,
                  const int* __restrict__ wl, T* __restrict__ out, int npart,
                  int h, int Tw, int CC, int Sbuf) {
  typedef Pack<T, VEC> P;
  const int rows = h + 4;
  const int blk = blockIdx.x;  // (bi, band, rp) row-major = out row order
  const int rp = blk % rows;
  const int band = (blk / rows) % npart;
  const int bi = blk / (rows * npart);
  const T* bufb = buf + static_cast<size_t>(bi) * Sbuf * CC;
  T* orow = out + static_cast<size_t>(blk) * Tw * CC;
  const int nvec = CC / VEC;
  const int total = Tw * nvec;

  if (rp >= 2 && rp < h + 2) {
    const InteriorRow<T> row = pcwin::interior_row(
        bufb, starts, j0, tpos, v6, wl, bi, npart, h, band, rp - 2, CC);
    for (int i = threadIdx.x; i < total; i += blockDim.x) {
      const int t = i / nvec;
      const int c = (i - t * nvec) * VEC;
      *reinterpret_cast<P*>(orow + static_cast<size_t>(t) * CC + c) =
          pcwin::interior_pack<T, VEC>(row, t, c, CC);
    }
  } else {
    const PadRow<T> row = pcwin::pad_row(bufb, pstarts, colz, wz, band,
                                         rp < 2 ? rp : rp - h, Tw, CC);
    for (int i = threadIdx.x; i < total; i += blockDim.x) {
      const int t = i / nvec;
      const int c = (i - t * nvec) * VEC;
      *reinterpret_cast<P*>(orow + static_cast<size_t>(t) * CC + c) =
          pcwin::pad_pack<T, VEC>(row, t, c, CC);
    }
  }
}

template <typename T>
int launch(const void* buf, const void* starts, const void* j0,
           const void* tpos, const void* v6, const void* pstarts,
           const void* colz, const void* wz, const void* wl, void* out, int B,
           int npart, int h, int Tw, int w, int CC, int Sbuf, void* stream) {
  (void)w;
  const dim3 grid(B * npart * (h + 4));
  const dim3 block(256);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  constexpr int kVec = 16 / sizeof(T);
  if (CC % kVec == 0) {
    window_kernel<T, kVec><<<grid, block, 0, st>>>(
        static_cast<const T*>(buf), static_cast<const int*>(starts),
        static_cast<const int*>(j0), static_cast<const int*>(tpos),
        static_cast<const T*>(v6), static_cast<const int*>(pstarts),
        static_cast<const int*>(colz), static_cast<const T*>(wz),
        static_cast<const int*>(wl), static_cast<T*>(out), npart, h, Tw, CC,
        Sbuf);
  } else {
    window_kernel<T, 1><<<grid, block, 0, st>>>(
        static_cast<const T*>(buf), static_cast<const int*>(starts),
        static_cast<const int*>(j0), static_cast<const int*>(tpos),
        static_cast<const T*>(v6), static_cast<const int*>(pstarts),
        static_cast<const int*>(colz), static_cast<const T*>(wz),
        static_cast<const int*>(wl), static_cast<T*>(out), npart, h, Tw, CC,
        Sbuf);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Returns the cudaError_t of the launch (0 = launched).
int pc_window_bf16(const void* buf, const void* starts, const void* j0,
                   const void* tpos, const void* v6, const void* pstarts,
                   const void* colz, const void* wz, const void* wl,
                   void* out, int B, int npart, int h, int Tw, int w, int CC,
                   int Sbuf, void* stream) {
  return launch<__nv_bfloat16>(buf, starts, j0, tpos, v6, pstarts, colz, wz,
                               wl, out, B, npart, h, Tw, w, CC, Sbuf, stream);
}

int pc_window_f32(const void* buf, const void* starts, const void* j0,
                  const void* tpos, const void* v6, const void* pstarts,
                  const void* colz, const void* wz, const void* wl, void* out,
                  int B, int npart, int h, int Tw, int w, int CC, int Sbuf,
                  void* stream) {
  return launch<float>(buf, starts, j0, tpos, v6, pstarts, colz, wz, wl, out,
                       B, npart, h, Tw, w, CC, Sbuf, stream);
}

}  // extern "C"
