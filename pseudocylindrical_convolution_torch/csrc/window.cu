// Skew-window kernel of the scan codec, for Hopper (sm_90a).
//
// Replaces the JAX package's Pallas TPU kernel
// pseudocylindrical_convolution_tpu/codec/pallas_window.py::_window_kernel.
// One call builds one layer-step's window (B, npart, h+4, T, CC) out of the
// layer buffer (B, Sbuf, CC), from per-step tables that
// codec/window_kernel.py::build_window_tables precomputes and audits:
// interior rows (a run of buffer rows, masked to the valid width, with <= 6
// patch taps read from the buffer through idx6/wgt6) and vertical-pad rows
// (two weighted single-row taps). The element-wise device code lives in
// window_common.cuh, shared with the fused window+conv kernel (fused.cu);
// its roundings are exactly those of the plain gather version
// (window_kernel.py::window_plain), so the two agree bit for bit. A call is
// this one launch: the TPU kernel took its patch values precomputed by XLA
// (Mosaic could not do the scattered reads); here the kernel reads them.
//
// What bounds it: bytes, and at these sizes latency. The output alone is
// (h+4)*T*CC*2 B per band in bf16, about 6.2 MB per layer-step at the
// flagship shape (B=1, npart=16, h=4, T=56, CC=432), and the reads are of
// the same order; there are no operations to speak of. A launch is two
// dependent trips to memory (the tables, then the data they point to), so
// the design keeps as many loads in flight as the card holds in each:
// one block of kThreads threads per (image, band, window row, chunk of
// positions), the chunks sized so that each thread has at most kStage
// 16-byte vectors and every SM at least kBlocksPerSM blocks (1,024 blocks
// at CC=432, 384 at CC=48, one wave). On an H100 (PERF.md §6) the data
// phase runs near the bytes' bound; the launch and the table trip, which
// the data waits for, are what is left.
//  1. One thread per position of the chunk resolves it from the row's
//     tables into a pcwin::Slot in shared memory: each position's source
//     once, not once per vector.
//  2. One flat pass over the chunk's (position, vector) pairs, which are
//     contiguous in the output: each thread loads all its vectors' raw
//     sources, then combines and stores them, neighbouring threads on
//     neighbouring addresses in the write and, along a run, in the read.
//     A block's row is all interior or all pad, so the pass is compiled
//     for each (build_chunk), with no per-element choice of arithmetic.
// Chosen by timing variants on the card (PERF.md §6): 2 or 4 stages, 64
// or 256 threads, one block per SM, a slot per thread without shared
// memory, and patch tables read only where a patch is did no better at
// both widths.
// The TPU kernel held the whole buffer in VMEM and realigned runs with
// one-hot matmuls to satisfy Mosaic's tiling; here the ~8.5 MB flagship
// buffer sits in the 50 MB L2 and each row is a plain load at any offset,
// so none of that carries over.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "window_common.cuh"

namespace {

using pcwin::Pack;
using pcwin::Slot;

constexpr int kThreads = 128;
constexpr int kStage = 3;       // 16-byte vectors per thread in flight
constexpr int kMaxPos = 64;     // positions per block (its slots)
constexpr int kBlocksPerSM = 2; // the least blocks per SM a launch makes

// Step 2 of a chunk of one window row: vector i of the chunk is channels
// [c, c+VEC) of slot si, at dst + i*VEC. A thread's i steps by kThreads,
// so (si, c) step by a constant. Every load of a stage is issued before
// any store. PAD: the row is a vertical-pad row (every slot two taps);
// else an interior row (copies and patch taps, one source each).
template <typename T, int VEC, bool PAD>
__device__ __forceinline__ void build_chunk(const Slot<T>* slots, T* dst,
                                            int np, int nvec) {
  typedef Pack<T, VEC> P;
  typedef typename pcwin::RawOf<sizeof(P)>::type R;
  const int nel = np * nvec;
  const int dsi = kThreads / nvec;
  const int dc = kThreads - dsi * nvec;
  int si = threadIdx.x / nvec;
  int c = threadIdx.x - si * nvec;
  for (int i0 = threadIdx.x; i0 < nel; i0 += kThreads * kStage) {
    R a[kStage], b[kStage];
    int sis[kStage];
#pragma unroll
    for (int u = 0; u < kStage; ++u) {
      sis[u] = si;
      if (i0 + u * kThreads < nel) {
        const Slot<T>& s = slots[si];
        a[u] = pcwin::load_raw<R>(s.src0, c * VEC);
        b[u] = PAD ? pcwin::load_raw<R>(s.src1, c * VEC) : R{};
      }
      si += dsi;
      c += dc;
      if (c >= nvec) {
        c -= nvec;
        ++si;
      }
    }
#pragma unroll
    for (int u = 0; u < kStage; ++u) {
      const int i = i0 + u * kThreads;
      if (i < nel) {
        const Slot<T>& s = slots[sis[u]];
        *reinterpret_cast<P*>(dst + static_cast<size_t>(i) * VEC) =
            pcwin::combine<T, VEC>(PAD ? pcwin::kPad : s.kind,
                                   pcwin::from_raw<P>(a[u]),
                                   pcwin::from_raw<P>(b[u]), s.w0, s.w1);
      }
    }
  }
}

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
    window_kernel(const T* __restrict__ buf, const int* __restrict__ starts,
                  const int* __restrict__ j0, const int* __restrict__ tpos,
                  const int* __restrict__ idx6, const T* __restrict__ wgt6,
                  const int* __restrict__ pstarts,
                  const int* __restrict__ colz, const T* __restrict__ wz,
                  const int* __restrict__ wl, T* __restrict__ out, int npart,
                  int h, int Tw, int CC, int Sbuf, int npos) {
  __shared__ Slot<T> slots[kMaxPos];
  const int nchunk = (Tw + npos - 1) / npos;
  const int row = blockIdx.x / nchunk;  // (bi, band, rp) = out row order
  const int t0 = (blockIdx.x - row * nchunk) * npos;
  const int rows = h + 4;
  const int rp = row % rows;
  const int band = (row / rows) % npart;
  const int bi = row / (rows * npart);
  const T* bufb = buf + static_cast<size_t>(bi) * Sbuf * CC;
  const int np = min(npos, Tw - t0);

  // 1. The chunk's slots, one thread per position.
  if (threadIdx.x < np)
    slots[threadIdx.x] = pcwin::window_slot(
        bufb, starts, j0, tpos, idx6, wgt6, pstarts, colz, wz, wl, h, Tw, CC,
        band, rp, t0 + static_cast<int>(threadIdx.x));
  __syncthreads();

  // 2. Their elements, contiguous in the output.
  T* dst = out + (static_cast<size_t>(row) * Tw + t0) * CC;
  if (rp >= 2 && rp < h + 2)
    build_chunk<T, VEC, false>(slots, dst, np, CC / VEC);
  else
    build_chunk<T, VEC, true>(slots, dst, np, CC / VEC);
}

template <typename T>
int launch(const void* buf, const void* starts, const void* j0,
           const void* tpos, const void* idx6, const void* wgt6,
           const void* pstarts, const void* colz, const void* wz,
           const void* wl, void* out, int B, int npart, int h, int Tw,
           int CC, int Sbuf, void* stream) {
  if (B < 1 || npart < 1 || h < 1 || Tw < 1 || CC < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  constexpr int kVec = 16 / sizeof(T);
  const bool vec = CC % kVec == 0
      && reinterpret_cast<uintptr_t>(buf) % 16 == 0
      && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  // Positions per block: as many as keep each thread within kStage
  // vectors, in chunks enough for kBlocksPerSM blocks on every SM, spread
  // evenly over the row.
  const int rows = B * npart * (h + 4);
  const int nvec = vec ? CC / kVec : CC;
  int npos = kThreads * kStage / nvec;
  npos = npos < 1 ? 1 : npos > kMaxPos ? kMaxPos : npos;
  int nchunk = (Tw + npos - 1) / npos;
  const int fill = (kBlocksPerSM * sms + rows - 1) / rows;
  nchunk = nchunk > fill ? nchunk : fill < Tw ? fill : Tw;
  npos = (Tw + nchunk - 1) / nchunk;
  nchunk = (Tw + npos - 1) / npos;
  const dim3 grid(rows * nchunk);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto kern = vec ? window_kernel<T, kVec> : window_kernel<T, 1>;
  kern<<<grid, kThreads, 0, st>>>(
      static_cast<const T*>(buf), static_cast<const int*>(starts),
      static_cast<const int*>(j0), static_cast<const int*>(tpos),
      static_cast<const int*>(idx6), static_cast<const T*>(wgt6),
      static_cast<const int*>(pstarts), static_cast<const int*>(colz),
      static_cast<const T*>(wz), static_cast<const int*>(wl),
      static_cast<T*>(out), npart, h, Tw, CC, Sbuf, npos);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Returns the cudaError_t of the launch (0 = launched).
int pc_window_bf16(const void* buf, const void* starts, const void* j0,
                   const void* tpos, const void* idx6, const void* wgt6,
                   const void* pstarts, const void* colz, const void* wz,
                   const void* wl, void* out, int B, int npart, int h, int Tw,
                   int CC, int Sbuf, void* stream) {
  return launch<__nv_bfloat16>(buf, starts, j0, tpos, idx6, wgt6, pstarts,
                               colz, wz, wl, out, B, npart, h, Tw, CC, Sbuf,
                               stream);
}

int pc_window_f32(const void* buf, const void* starts, const void* j0,
                  const void* tpos, const void* idx6, const void* wgt6,
                  const void* pstarts, const void* colz, const void* wz,
                  const void* wl, void* out, int B, int npart, int h, int Tw,
                  int CC, int Sbuf, void* stream) {
  return launch<float>(buf, starts, j0, tpos, idx6, wgt6, pstarts, colz, wz,
                       wl, out, B, npart, h, Tw, CC, Sbuf, stream);
}

}  // extern "C"
