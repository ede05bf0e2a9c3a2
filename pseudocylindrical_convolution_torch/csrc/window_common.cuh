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
//     takes the pre-weighted patch value v6[bi,b,r,k] where t == tpos[b,r,k]
//     (the causal-left zeros and the circular wraps, <= 6 per row);
//   vertical-pad row k (rp in {0, 1, h+2, h+3}): each tap q reads column
//     colz[b,k,q,t] of the single source row pstarts[b,k,q], times wz; a tap
//     is rounded once to the buffer type (+0.0 when its weight is 0), and
//     the two taps are added and rounded once more.
// __fmul_rn and __fadd_rn keep the compiler from contracting a tap and the
// sum into one FMA, which would round differently.
//
// The window kernel reads a row's tables once and builds its elements
// (interior_pack, pad_pack). The fused kernel first resolves each (row, t)
// of its sub-window into a Slot in shared memory (interior_slot,
// pad_slot), then builds the elements from the slots; both go through the
// same source selection (interior_src, pad_slot) and the same pad
// arithmetic (pad_sum).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

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

// One tap: the product rounded once to T, or +0.0 where the weight is 0.
template <typename T>
__device__ __forceinline__ float tap(T x, float wt) {
  return wt == 0.f ? 0.f : to_f(from_f<T>(__fmul_rn(to_f(x), wt)));
}

template <typename T, int VEC>
__device__ __forceinline__ Pack<T, VEC> zero_pack() {
  Pack<T, VEC> p;
#pragma unroll
  for (int e = 0; e < VEC; ++e) p.v[e] = from_f<T>(0.f);
  return p;
}

// VEC channels [c, c+VEC) of a source position, or +0.0 where it has none.
template <typename T, int VEC>
__device__ __forceinline__ Pack<T, VEC> load_or_zero(const T* src, int c) {
  return src ? *reinterpret_cast<const Pack<T, VEC>*>(src + c)
             : zero_pack<T, VEC>();
}

// A pad element: the two taps, each rounded once, added and rounded once
// more.
template <typename T, int VEC>
__device__ __forceinline__ Pack<T, VEC> pad_sum(const Pack<T, VEC>& a,
                                                const Pack<T, VEC>& b,
                                                float w0, float w1) {
  Pack<T, VEC> o;
#pragma unroll
  for (int e = 0; e < VEC; ++e)
    o.v[e] = from_f<T>(__fadd_rn(tap(a.v[e], w0), tap(b.v[e], w1)));
  return o;
}

// The tables of one interior window row (band, r) at this step.
template <typename T>
struct InteriorRow {
  const T* run;     // buffer row starts[b,r]: position t reads run + t*CC
  const T* v6row;   // the row's 6 patch values, each CC wide
  int tlo, thi;     // t in [tlo, thi) lies inside the valid width
  int tp[6];        // patch positions (-1: no patch)
};

template <typename T>
__device__ __forceinline__ InteriorRow<T> interior_row(
    const T* bufb, const int* starts, const int* j0, const int* tpos,
    const T* v6, const int* wl, int bi, int npart, int h, int band, int r,
    int CC) {
  InteriorRow<T> row;
  const int cell = band * h + r;
  row.run = bufb + static_cast<size_t>(starts[cell]) * CC;
  row.v6row = v6 + (static_cast<size_t>(bi) * npart * h + cell) * 6 * CC;
  row.tlo = -j0[cell];             // t >= tlo  <=>  j >= 0
  row.thi = wl[band] - j0[cell];   // t <  thi  <=>  j <  wl
#pragma unroll
  for (int q = 0; q < 6; ++q) row.tp[q] = tpos[cell * 6 + q];
  return row;
}

// The source of interior position t: its patch value, the run, or null
// (+0.0 outside the valid width).
template <typename T>
__device__ __forceinline__ const T* interior_src(const InteriorRow<T>& row,
                                                 int t, int CC) {
  int k = -1;
#pragma unroll
  for (int q = 0; q < 6; ++q) k = (row.tp[q] == t) ? q : k;
  if (k >= 0) return row.v6row + static_cast<size_t>(k) * CC;
  if (t >= row.tlo && t < row.thi)
    return row.run + static_cast<size_t>(t) * CC;
  return nullptr;
}

// VEC channels [c, c+VEC) of interior position t: patch, run or +0.0.
template <typename T, int VEC>
__device__ __forceinline__ Pack<T, VEC> interior_pack(
    const InteriorRow<T>& row, int t, int c, int CC) {
  return load_or_zero<T, VEC>(interior_src(row, t, CC), c);
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

// One position t of a window row, resolved from the tables: an interior
// element copies src0 (null: +0.0); a pad element is pad_sum of the taps
// at src0 and src1 (null where the weight is 0) with weights w0, w1.
template <typename T>
struct Slot {
  const T* src0;
  const T* src1;
  float w0, w1;
  int pad;
};

template <typename T>
__device__ __forceinline__ Slot<T> interior_slot(const InteriorRow<T>& row,
                                                 int t, int CC) {
  return Slot<T>{interior_src(row, t, CC), nullptr, 0.f, 0.f, 0};
}

template <typename T>
__device__ __forceinline__ Slot<T> pad_slot(const PadRow<T>& row, int t,
                                            int CC) {
  const float w0 = to_f(row.wz0[t]);
  const float w1 = to_f(row.wz1[t]);
  return Slot<T>{
      w0 != 0.f ? row.src0 + static_cast<size_t>(row.cz0[t]) * CC : nullptr,
      w1 != 0.f ? row.src1 + static_cast<size_t>(row.cz1[t]) * CC : nullptr,
      w0, w1, 1};
}

// VEC channels [c, c+VEC) of pad position t: the two taps, each rounded
// once, added and rounded once more.
template <typename T, int VEC>
__device__ __forceinline__ Pack<T, VEC> pad_pack(const PadRow<T>& row,
                                                 int t, int c, int CC) {
  const Slot<T> s = pad_slot(row, t, CC);
  return pad_sum<T, VEC>(load_or_zero<T, VEC>(s.src0, c),
                         load_or_zero<T, VEC>(s.src1, c), s.w0, s.w1);
}

}  // namespace pcwin
