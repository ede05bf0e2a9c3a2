// Device code of the scan codec's skew window, shared by the window kernel
// (window.cu) and the fused window+conv kernel (fused.cu).
//
// Both kernels build window elements with these functions, so the fused
// kernel's on-chip window holds the same bits as the window kernel's output
// and as the plain gather version (codec/window_kernel.py::window_plain).
// The window is read from per-step tables that
// codec/window_kernel.py::build_window_tables precomputes and audits:
//
//   interior row (band b, row r = rp - 2): position t copies buffer row
//     starts[b,r] + t while 0 <= j0[b,r] + t < wl[b], is +0.0 outside, and
//     takes patch k where t == tpos[b,r,k] (the causal-left zeros and the
//     circular wraps, <= 6 per row): one tap of buffer row idx6[b,r,k]
//     weighted by wgt6[b,r,k];
//   vertical-pad row k (rp in {0, 1, h+2, h+3}): each tap q reads column
//     colz[b,k,q,t] of the single source row pstarts[b,k,q], times wz; the
//     two taps are added and rounded once more.
// A tap is the product rounded once to the buffer type, +0.0 where its
// weight is 0. A patch element is its one tap as it is: adding a +0.0
// second tap would turn a -0.0 product into +0.0. __fmul_rn and __fadd_rn
// keep the compiler from contracting a tap and the sum into one FMA, which
// would round differently.
//
// Each kernel first resolves every (row, t) it builds into a Slot (its
// sources, weights and kind: interior_slot, pad_slot), then loads the raw
// 16-byte vectors of all its slots' sources (load_raw) before it combines
// any of them (combine), so that a thread's loads are in flight together.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>
#include <cstring>

namespace pcwin {

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

// A VEC-wide pack as raw bits, loaded through the read-only path (neither
// kernel writes the buffer), or zero bits (+0.0) where the source is null.
template <int BYTES>
struct RawOf;
template <>
struct RawOf<16> {
  typedef uint4 type;
};
template <>
struct RawOf<4> {
  typedef unsigned type;
};
template <>
struct RawOf<2> {
  typedef unsigned short type;
};

template <typename R, typename T>
__device__ __forceinline__ R load_raw(const T* src, int c) {
  return src ? __ldg(reinterpret_cast<const R*>(src + c)) : R{};
}

template <typename P, typename R>
__device__ __forceinline__ P from_raw(const R& r) {
  P p;
  memcpy(&p, &r, sizeof(P));
  return p;
}

// One tap: the product rounded once to T, or +0.0 where the weight is 0.
template <typename T>
__device__ __forceinline__ float tap(T x, float wt) {
  return wt == 0.f ? 0.f : to_f(from_f<T>(__fmul_rn(to_f(x), wt)));
}

// What a window position is made of.
enum Kind : int {
  kCopy = 0,  // src0 as it is; +0.0 where src0 is null
  kTap = 1,   // one tap of src0 with weight w0 (an interior patch)
  kPad = 2,   // the taps of src0 and src1 (null where the weight is 0),
              // added and rounded once more
};

// One position t of a window row, resolved from the tables.
template <typename T>
struct Slot {
  const T* src0;
  const T* src1;
  float w0, w1;
  int kind;
};

// The element of a slot from the raw packs of its sources (b is read only
// for kPad).
template <typename T, int VEC>
__device__ __forceinline__ Pack<T, VEC> combine(int kind,
                                                const Pack<T, VEC>& a,
                                                const Pack<T, VEC>& b,
                                                float w0, float w1) {
  if (kind == kCopy) return a;
  Pack<T, VEC> o;
  if (kind == kTap) {
#pragma unroll
    for (int e = 0; e < VEC; ++e) o.v[e] = from_f<T>(tap(a.v[e], w0));
  } else {
#pragma unroll
    for (int e = 0; e < VEC; ++e)
      o.v[e] = from_f<T>(__fadd_rn(tap(a.v[e], w0), tap(b.v[e], w1)));
  }
  return o;
}

// The tables of one interior window row (band, r) at this step, the patch
// sources and weights read at once with the patch positions.
template <typename T>
struct InteriorRow {
  const T* run;     // buffer row starts[b,r]: position t reads run + t*CC
  int tlo, thi;     // t in [tlo, thi) lies inside the valid width
  int tp[6];        // patch positions (-1: no patch)
  int src[6];       // patch source rows (idx6)
  float w[6];       // patch weights (wgt6)
};

template <typename T>
__device__ __forceinline__ InteriorRow<T> interior_row(
    const T* bufb, const int* starts, const int* j0, const int* tpos,
    const int* idx6, const T* wgt6, const int* wl, int h, int band, int r,
    int CC) {
  InteriorRow<T> row;
  const int cell = band * h + r;
  row.run = bufb + static_cast<size_t>(starts[cell]) * CC;
  row.tlo = -j0[cell];             // t >= tlo  <=>  j >= 0
  row.thi = wl[band] - j0[cell];   // t <  thi  <=>  j <  wl
#pragma unroll
  for (int q = 0; q < 6; ++q) {
    row.tp[q] = tpos[cell * 6 + q];
    row.src[q] = idx6[cell * 6 + q];
    row.w[q] = to_f(wgt6[cell * 6 + q]);
  }
  return row;
}

// Interior position t: its patch tap, the run, or +0.0 outside the valid
// width (a patch of weight 0 is +0.0 too).
template <typename T>
__device__ __forceinline__ Slot<T> interior_slot(const T* bufb,
                                                 const InteriorRow<T>& row,
                                                 int t, int CC) {
  int k = -1;
#pragma unroll
  for (int q = 0; q < 6; ++q) k = (row.tp[q] == t) ? q : k;
  if (k >= 0) {
    int src = 0;
    float w = 0.f;
#pragma unroll
    for (int q = 0; q < 6; ++q) {
      src = q == k ? row.src[q] : src;
      w = q == k ? row.w[q] : w;
    }
    if (w != 0.f)
      return Slot<T>{bufb + static_cast<size_t>(src) * CC, nullptr, w, 0.f,
                     kTap};
    return Slot<T>{nullptr, nullptr, 0.f, 0.f, kCopy};
  }
  if (t >= row.tlo && t < row.thi)
    return Slot<T>{row.run + static_cast<size_t>(t) * CC, nullptr, 0.f, 0.f,
                   kCopy};
  return Slot<T>{nullptr, nullptr, 0.f, 0.f, kCopy};
}

// The tables of one vertical-pad window row (band, pad row k) at this step.
template <typename T>
struct PadRow {
  const T* src0;    // the source rows of tap 0 and tap 1
  const T* src1;
  const int* cz0;   // per position: column within the source row
  const int* cz1;
  const T* wz0;     // per position: tap weight
  const T* wz1;
};

template <typename T>
__device__ __forceinline__ PadRow<T> pad_row(const T* bufb,
                                             const int* pstarts,
                                             const int* colz, const T* wz,
                                             int band, int k, int Tw,
                                             int CC) {
  PadRow<T> row;
  const int p0 = (band * 4 + k) * 2;      // tap 0; tap 1 is p0 + 1
  row.src0 = bufb + static_cast<size_t>(pstarts[p0]) * CC;
  row.src1 = bufb + static_cast<size_t>(pstarts[p0 + 1]) * CC;
  row.cz0 = colz + static_cast<size_t>(p0) * Tw;
  row.cz1 = row.cz0 + Tw;
  row.wz0 = wz + static_cast<size_t>(p0) * Tw;
  row.wz1 = row.wz0 + Tw;
  return row;
}

template <typename T>
__device__ __forceinline__ Slot<T> pad_slot(const PadRow<T>& row, int t,
                                            int CC) {
  const float w0 = to_f(row.wz0[t]);
  const float w1 = to_f(row.wz1[t]);
  return Slot<T>{
      w0 != 0.f ? row.src0 + static_cast<size_t>(row.cz0[t]) * CC : nullptr,
      w1 != 0.f ? row.src1 + static_cast<size_t>(row.cz1[t]) * CC : nullptr,
      w0, w1, kPad};
}

// Window row rp (0 <= rp < h+4) of band `band`, position t, resolved.
template <typename T>
__device__ __forceinline__ Slot<T> window_slot(
    const T* bufb, const int* starts, const int* j0, const int* tpos,
    const int* idx6, const T* wgt6, const int* pstarts, const int* colz,
    const T* wz, const int* wl, int h, int Tw, int CC, int band, int rp,
    int t) {
  if (rp >= 2 && rp < h + 2)
    return interior_slot(
        bufb,
        interior_row(bufb, starts, j0, tpos, idx6, wgt6, wl, h, band, rp - 2,
                     CC),
        t, CC);
  return pad_slot(
      pad_row(bufb, pstarts, colz, wz, band, rp < 2 ? rp : rp - h, Tw, CC),
      t, CC);
}

}  // namespace pcwin
