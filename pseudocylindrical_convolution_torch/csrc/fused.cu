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
// same G channels). K is (3*G, 45*CI, n) in the buffer type, rows
// (dt, di, ci). The output is fp32 (B, npart, h, 3*G*n) before bias and
// PReLU. Only the kept window slices of each output group are contracted;
// the TPU kernel's c-fold excess per group chunk was a Mosaic blocking
// artefact.
//
// Numerics: every product is taken in fp32 from upcast operands (exact for
// bf16 x bf16) and the sums are fp32. The order of the sums is fixed by the
// shapes alone, and is the same for every cell: kThreads threads, thread t
// adding terms q = t, t + kThreads, ... of the 45*CI in increasing q with
// fmaf into +0, then a butterfly over each warp (xor 16, 8, 4, 2, 1) and
// the warps' sums added in warp order into +0. No atomics and no split of
// a cell across blocks, so a launch gives the same bits every time, which
// is what lets an encode and a decode of a fused stream agree. The plain
// version in this order is fused_kernel.py::fused_ordered (bf16, bit for
// bit); fused_plain (45 tap matmuls) agrees within a tolerance.
//
// What bounds it: at the flagship hidden layer (B=1, npart=16, h=4, G=48,
// CI=144, n=3) the bytes (K 5.6 MB, about 4 MB of distinct buffer rows,
// 0.1 MB of cells) take 2.6 us at 3.35 TB/s; the 179 M fp32 FMAs, in this
// fixed order on the CUDA cores, are about 5 us of FMA issue on 132 SMs.
// Measured, every phase of this kernel is instruction-issue bound: the
// staging (its pad arithmetic above all), the contraction (about two
// instructions per FMA: the bf16 window loads and upcasts, the K loads,
// the term indices) and the reductions add up, with little overlap.
//
// The design: one block per (subnet, chunk of kGroups output groups,
// image, chunk of kNB bands).
//  1. The chunk's sub-windows (kNB, h+4, kPos = 8 + kGroups, CI): the
//     positions its groups read, each staged once for all of them (a
//     block per group would stage each position 9 times), in two flat
//     phases whose loads are all independent: (a) one thread per (band,
//     row, position) reads that row's tables and resolves the position to
//     its sources and weights (pcwin::Slot, in shared memory); (b) one
//     flat loop over (slot, 16-byte vector) builds the elements: interior
//     copies as cp.async, pad elements kStage at a time, their taps loaded
//     raw before any is combined by pcwin::combine.
//  2. For each group in turn, the contraction loops over q outermost: each
//     q's n K values are read once (from global memory, kUnroll trips
//     ahead) and used for all kNB*h rows, accumulating acc[kNB][H][N] in
//     registers. The flagship instantiations (bf16, h=4, n=3, CI=144 or
//     48) fix every shape, so each window read is a constant offset from
//     one base, and cap registers so that kMinBlocks blocks share an SM;
//     a generic instantiation covers the other shapes.
//  3. The fixed-order reduction above, per cell (warp_sums), then the
//     group's cells.
// npart must be a multiple of kNB (the geometry makes it even); G need not
// be a multiple of kGroups: a position before the window is staged as
// +0.0, and cells of a missing group are not written.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "window_common.cuh"

namespace {

using pcwin::Pack;
using pcwin::Slot;
using pcwin::from_raw;
using pcwin::load_raw;
using pcwin::to_f;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// Bands and output groups per block, chosen by timing 1, 2, 4 and 8 bands
// and 1, 2 and 3 groups on the card (PERF.md).
constexpr int kNB = 2;
constexpr int kGroups = 3;
constexpr int kPos = 8 + kGroups;            // window positions they read
// Blocks per SM the flagship instantiations are register-capped for.
constexpr int kMinBlocks = 3;
constexpr int kMaxH = 8;     // window rows h+4 <= 12
constexpr int kMaxN = 4;     // output channels per (subnet, group)
constexpr int kTaps = 45;    // 9 window positions x 5 rows
constexpr int kStage = 4;    // window vectors per thread in flight
constexpr int kUnroll = 4;   // trips per unrolled body; K prefetch depth

__host__ __device__ inline size_t up16(size_t x) { return (x + 15) / 16 * 16; }

// Dynamic shared memory of a block: the (kNB, h+4, kPos, CI) sub-windows,
// then the slots of phase 1, which the warp sums of phase 3 later reuse.
template <typename T>
__host__ __device__ inline size_t window_bytes(int h, int CI) {
  return up16(static_cast<size_t>(kNB) * (h + 4) * kPos * CI * sizeof(T));
}

template <typename T>
__host__ __device__ inline size_t smem_bytes(int h, int CI, int cells) {
  const size_t slots =
      static_cast<size_t>(kNB) * (h + 4) * kPos * sizeof(Slot<T>);
  const size_t red = static_cast<size_t>(kWarps) * cells * sizeof(float);
  return window_bytes<T>(h, CI) + up16(slots > red ? slots : red);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// The warp's butterfly (xor 16, 8, 4, 2, 1; each lane adds its partner's
// value to its own) over each of the M values v[0..M), by recursive
// halving: at a level whose count is even a lane keeps the half its lane
// bit selects and adds the partner's copy of it, so each add is one the
// butterfly makes and every lane's result has the butterfly's bits; a
// level with an odd count is a plain butterfly step. Each sum then lies in
// one lane, which writes it to out[index]. M/2 + M/4 + ... shuffles
// instead of 5*M.
template <int O, int CNT, int M>
__device__ __forceinline__ void halve(float (&v)[M], int lane, int& base,
                                      int& plain) {
  if constexpr (CNT % 2 == 0) {
    constexpr int kHalf = CNT / 2;
    const bool up = (lane & O) != 0;
#pragma unroll
    for (int i = 0; i < kHalf; ++i) {
      const float keep = up ? v[kHalf + i] : v[i];
      const float send = up ? v[i] : v[kHalf + i];
      v[i] = keep + __shfl_xor_sync(0xffffffffu, send, O);
    }
    if (up) base += kHalf;
    if constexpr (O > 1) halve<O / 2, kHalf, M>(v, lane, base, plain);
  } else {
#pragma unroll
    for (int i = 0; i < CNT; ++i)
      v[i] += __shfl_xor_sync(0xffffffffu, v[i], O);
    plain |= O;
    if constexpr (O > 1) halve<O / 2, CNT, M>(v, lane, base, plain);
  }
}

__host__ __device__ constexpr int halved_count(int cnt, int o) {
  return o == 0 ? cnt : halved_count(cnt % 2 == 0 ? cnt / 2 : cnt, o / 2);
}

template <int M>
__device__ __forceinline__ void warp_sums(float (&v)[M], int lane,
                                          float* out) {
  int base = 0;
  int plain = 0;
  halve<16, M, M>(v, lane, base, plain);
  constexpr int kLeft = halved_count(M, 16);
  if ((lane & plain) == 0) {
#pragma unroll
    for (int i = 0; i < kLeft; ++i) out[base + i] = v[i];
  }
}

// CIC > 0: the flagship instantiation, h == H, n == N and CI == CIC, so
// every shared-memory offset of the contraction is a constant.
// CIC == 0: the generic one; H and N bound the runtime h and n.
template <typename T, int VEC, int H, int N, int CIC>
__global__ void __launch_bounds__(kThreads, CIC > 0 ? kMinBlocks : 1)
    fused_kernel(const T* __restrict__ buf, const int* __restrict__ starts,
                 const int* __restrict__ j0, const int* __restrict__ tpos,
                 const int* __restrict__ idx6, const T* __restrict__ wgt6,
                 const int* __restrict__ pstarts,
                 const int* __restrict__ colz, const T* __restrict__ wz,
                 const int* __restrict__ wl, const T* __restrict__ k,
                 float* __restrict__ out, int B, int npart, int h, int Tw,
                 int CC, int CI, int n, int Sbuf) {
  typedef Pack<T, VEC> P;
  typedef typename pcwin::RawOf<sizeof(P)>::type R;
  constexpr bool kExact = CIC > 0;
  constexpr bool kAsync = sizeof(P) == 16;
  constexpr int kCells = kNB * H * N;
  if (kExact) {
    h = H;
    n = N;
    CI = CIC;
  }
  extern __shared__ __align__(16) unsigned char smem[];
  T* win = reinterpret_cast<T*>(smem);
  Slot<T>* slots =
      reinterpret_cast<Slot<T>*>(smem + window_bytes<T>(h, CI));
  float* red = reinterpret_cast<float*>(slots);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int G = Tw - 8;
  const int ngc = (G + kGroups - 1) / kGroups;
  const int hp4 = h + 4;
  const int nq = kTaps * CI;
  const int nchunk = npart / kNB;
  const int ic = blockIdx.x % (B * nchunk);   // image * nchunk + chunk
  const int sgc = blockIdx.x / (B * nchunk);  // subnet * ngc + group chunk
  const int s = sgc / ngc;
  const int g0 = (sgc - s * ngc) * kGroups;   // first group of the block
  const int bi = ic / nchunk;
  const int band0 = (ic - bi * nchunk) * kNB;
  const int tb = G - g0 - kGroups;            // first window slice read
  const int cs0 = CC == CI ? 0 : s * CI;
  const T* bufb = buf + static_cast<size_t>(bi) * Sbuf * CC;

  // 1a. Slots: one thread per (band, row, position) reads that row's
  //     tables and resolves the position to its sources and weights, all
  //     at once; a position before the window is +0.0.
  const int nslot = kNB * hp4 * kPos;
  for (int i = tid; i < nslot; i += kThreads) {
    const int row = i / kPos;
    const int nb = row / hp4;
    const int rp = row - nb * hp4;
    const int t = tb + i - row * kPos;
    const int band = band0 + nb;
    slots[i] = t < 0 ? Slot<T>{nullptr, nullptr, 0.f, 0.f, pcwin::kCopy}
                     : pcwin::window_slot(bufb, starts, j0, tpos, idx6, wgt6,
                                          pstarts, colz, wz, wl, h, Tw, CC,
                                          band, rp, t);
  }
  __syncthreads();

  // 1b. Elements: channels [cs0, cs0+CI) of every slot, element for element
  //     the window kernel's values (the window layout (kNB, h+4, kPos, CI)
  //     is the slot order times CI). Interior copies go by cp.async; a pad
  //     element's two taps are loaded raw for kStage elements before any
  //     is combined, so that all their loads are in flight together.
  const int nvec = CI / VEC;
  const int nel = nslot * nvec;
  for (int i0 = tid; i0 < nel; i0 += kThreads * kStage) {
    R ra[kStage], rb[kStage];
    float w0[kStage], w1[kStage];
    T* dst[kStage];
#pragma unroll
    for (int u = 0; u < kStage; ++u) {
      const int i = i0 + u * kThreads;
      dst[u] = nullptr;
      if (i < nel) {
        const int si = i / nvec;
        const int c = (i - si * nvec) * VEC;
        const Slot<T> sl = slots[si];
        T* d = win + static_cast<size_t>(si) * CI + c;
        if (sl.kind == pcwin::kCopy && kAsync && sl.src0) {
          cp_async16(d, sl.src0 + cs0 + c);
        } else if (sl.kind != pcwin::kPad) {
          // +0.0 or a patch tap, a few per row: built at once
          *reinterpret_cast<P*>(d) = pcwin::combine<T, VEC>(
              sl.kind, from_raw<P>(load_raw<R>(sl.src0, cs0 + c)), P{},
              sl.w0, 0.f);
        } else {
          ra[u] = load_raw<R>(sl.src0, cs0 + c);
          rb[u] = load_raw<R>(sl.src1, cs0 + c);
          w0[u] = sl.w0;
          w1[u] = sl.w1;
          dst[u] = d;
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kStage; ++u)
      if (dst[u])
        *reinterpret_cast<P*>(dst[u]) = pcwin::combine<T, VEC>(
            pcwin::kPad, from_raw<P>(ra[u]), from_raw<P>(rb[u]), w0[u],
            w1[u]);
  }
  cp_async_wait_all();
  __syncthreads();

  // 2-3, for each group of the block: thread tid adds terms q = tid,
  // tid + kThreads, ... in increasing q, each q's K values read once for
  // all the block's rows (q runs over (dt, di, ci) as K's rows); the full
  // trips run unguarded kUnroll to a body, with the K values of the next
  // body already loading; then the fixed-order reduction and the cells.
  const int rs = kPos * CI;                   // window row stride
  const int bs = hp4 * rs;                    // window band stride
  const int dtp = kThreads / CI;              // (tap, ci) step per trip
  const int dci = kThreads - dtp * CI;
  const int nfull = nq / kThreads;
  const int nmain = nfull - nfull % kUnroll;
#pragma unroll 1
  for (int gi = 0; gi < kGroups && g0 + gi < G; ++gi) {
    const int g = g0 + gi;
    const T* kq = k + static_cast<size_t>(s * G + g) * nq * n;
    const T* wg = win + (kGroups - 1 - gi) * CI;   // group's first slice
    float acc[kNB][H][N];
#pragma unroll
    for (int nb = 0; nb < kNB; ++nb)
#pragma unroll
      for (int r = 0; r < H; ++r)
#pragma unroll
        for (int j = 0; j < N; ++j) acc[nb][r][j] = 0.f;
    int tp = tid / CI;
    int ci = tid - tp * CI;
    int q = tid;
    auto kload = [&](int qq, float (&kv)[N]) {
#pragma unroll
      for (int j = 0; j < N; ++j)
        kv[j] = qq < nq && (kExact || j < n)
            ? to_f(kq[static_cast<size_t>(qq) * n + j]) : 0.f;
    };
    auto trip = [&](const float (&kv)[N]) {
      const int dt = tp / 5;
      const T* wq = wg + ((tp - dt * 5) * kPos + dt) * CI + ci;
#pragma unroll
      for (int nb = 0; nb < kNB; ++nb)
#pragma unroll
        for (int r = 0; r < H; ++r) {
          if (kExact || r < h) {
            const float x = to_f(wq[nb * bs + r * rs]);
#pragma unroll
            for (int j = 0; j < N; ++j)
              if (kExact || j < n)
                acc[nb][r][j] = fmaf(x, kv[j], acc[nb][r][j]);
          }
        }
      q += kThreads;
      ci += dci;
      tp += dtp;
      if (ci >= CI) {
        ci -= CI;
        ++tp;
      }
    };
    float kv[kUnroll][N];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) kload(q + u * kThreads, kv[u]);
#pragma unroll 1
    for (int i = 0; i < nmain; i += kUnroll) {
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        trip(kv[u]);
        kload(q + (kUnroll - 1) * kThreads, kv[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (q < nq) trip(kv[u]);

    // Fixed-order reduction: the butterfly within each warp (warp_sums),
    // then the warps' sums added in warp order. The slots' space is free
    // since phase 1b; the previous group's reads of it are behind the
    // barrier that ends its loop trip.
    float v[kCells];
#pragma unroll
    for (int nb = 0; nb < kNB; ++nb)
#pragma unroll
      for (int r = 0; r < H; ++r)
#pragma unroll
        for (int j = 0; j < N; ++j) v[(nb * H + r) * N + j] = acc[nb][r][j];
    warp_sums<kCells>(v, lane, red + warp * kCells);
    __syncthreads();
    for (int c = tid; c < kNB * h * n; c += kThreads) {
      const int nb = c / (h * n);
      const int r = (c - nb * h * n) / n;
      const int j = c - (nb * h + r) * n;
      float sum = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w)
        sum += red[w * kCells + (nb * H + r) * N + j];
      out[((static_cast<size_t>(bi * npart + band0 + nb) * h + r) * 3 * G
           + s * G + g) * n + j] = sum;
    }
    __syncthreads();
  }
}

// The device's shared memory a block may opt in to (queried once).
int smem_optin() {
  static int bytes = 0;
  if (bytes == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess
        || cudaDeviceGetAttribute(&bytes,
                                  cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                  dev) != cudaSuccess)
      bytes = 48 * 1024;
  }
  return bytes;
}

// One instantiation of the kernel, its shared memory at a shape, and a
// launch of it.
template <typename T, int VEC, int H, int N, int CIC>
struct Plan {
  size_t smem = 0;
  bool fits(int h, int CI) {
    smem = smem_bytes<T>(h, CI, kNB * H * N);
    return smem <= static_cast<size_t>(smem_optin());
  }
  static int grid(int B, int npart, int Tw) {
    return 3 * ((Tw - 8 + kGroups - 1) / kGroups) * B * (npart / kNB);
  }
  int run(const void* buf, const void* starts, const void* j0,
          const void* tpos, const void* idx6, const void* wgt6,
          const void* pstarts, const void* colz, const void* wz,
          const void* wl, const void* k, void* out, int B, int npart, int h,
          int Tw, int CC, int CI, int n, int Sbuf, cudaStream_t st) {
    auto kern = fused_kernel<T, VEC, H, N, CIC>;
    static size_t smem_set = 48 * 1024;
    if (smem > smem_set) {
      const cudaError_t err = cudaFuncSetAttribute(
          kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(smem));
      if (err != cudaSuccess) return static_cast<int>(err);
      smem_set = smem;
    }
    kern<<<grid(B, npart, Tw), kThreads, smem, st>>>(
        static_cast<const T*>(buf), static_cast<const int*>(starts),
        static_cast<const int*>(j0), static_cast<const int*>(tpos),
        static_cast<const int*>(idx6), static_cast<const T*>(wgt6),
        static_cast<const int*>(pstarts), static_cast<const int*>(colz),
        static_cast<const T*>(wz), static_cast<const int*>(wl),
        static_cast<const T*>(k),
        static_cast<float*>(out), B, npart, h, Tw, CC, CI, n, Sbuf);
    return static_cast<int>(cudaGetLastError());
  }
  // info: see pc_fused_info.
  int describe(int npart, int Tw, int* info) {
    cudaFuncAttributes attr;
    const cudaError_t err =
        cudaFuncGetAttributes(&attr, fused_kernel<T, VEC, H, N, CIC>);
    if (err != cudaSuccess) return static_cast<int>(err);
    info[0] = kNB;
    info[1] = kGroups;
    info[2] = static_cast<int>(smem);
    info[3] = attr.numRegs;
    info[4] = static_cast<int>(attr.localSizeBytes);
    info[5] = grid(1, npart, Tw);
    return 0;
  }
};

bool valid_shape(int npart, int h, int Tw, int CC, int CI, int n) {
  return npart >= kNB && npart % kNB == 0 && h >= 1 && h <= kMaxH && n >= 1
      && n <= kMaxN && Tw >= 9 && CI >= 1 && (CC == CI || CC == 3 * CI);
}

// Runs f on the plan of the instantiation a launch at this shape takes:
// the flagship ones (bf16, 16-byte vectors, h=4, n=3, CI=144 or 48), else
// the generic one. Returns f's result, or cudaErrorInvalidValue where its
// shared memory does not fit.
template <typename T, typename F>
int with_plan(bool aligned, int h, int CC, int CI, int n, F f) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr bool kBf16 = sizeof(T) == 2;
  const bool vec = aligned && CC % kVec == 0 && CI % kVec == 0;
  if constexpr (kBf16) {
    if (vec && h == 4 && n == 3 && CI == 144) {
      Plan<T, kVec, 4, 3, 144> p;
      if (p.fits(h, CI)) return f(p);
    }
    if (vec && h == 4 && n == 3 && CI == 48) {
      Plan<T, kVec, 4, 3, 48> p;
      if (p.fits(h, CI)) return f(p);
    }
  }
  if (vec) {
    Plan<T, kVec, kMaxH, kMaxN, 0> p;
    if (p.fits(h, CI)) return f(p);
  } else {
    Plan<T, 1, kMaxH, kMaxN, 0> p;
    if (p.fits(h, CI)) return f(p);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T>
int launch(const void* buf, const void* starts, const void* j0,
           const void* tpos, const void* idx6, const void* wgt6,
           const void* pstarts, const void* colz, const void* wz,
           const void* wl, const void* k, void* out, int B, int npart, int h,
           int Tw, int CC, int CI, int n, int Sbuf, void* stream) {
  if (!valid_shape(npart, h, Tw, CC, CI, n) || B < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool aligned = reinterpret_cast<uintptr_t>(buf) % 16 == 0;
  return with_plan<T>(aligned, h, CC, CI, n, [&](auto& p) {
    return p.run(buf, starts, j0, tpos, idx6, wgt6, pstarts, colz, wz, wl, k,
                 out, B, npart, h, Tw, CC, CI, n, Sbuf, st);
  });
}

template <typename T>
int info_of(int npart, int h, int Tw, int CC, int CI, int n, int* info) {
  if (!valid_shape(npart, h, Tw, CC, CI, n))
    return static_cast<int>(cudaErrorInvalidValue);
  return with_plan<T>(true, h, CC, CI, n,
                      [&](auto& p) { return p.describe(npart, Tw, info); });
}

}  // namespace

extern "C" {

// Returns the cudaError_t of the launch (0 = launched).
int pc_fused_bf16(const void* buf, const void* starts, const void* j0,
                  const void* tpos, const void* idx6, const void* wgt6,
                  const void* pstarts, const void* colz, const void* wz,
                  const void* wl, const void* k, void* out, int B, int npart,
                  int h, int Tw, int CC, int CI, int n, int Sbuf,
                  void* stream) {
  return launch<__nv_bfloat16>(buf, starts, j0, tpos, idx6, wgt6, pstarts,
                               colz, wz, wl, k, out, B, npart, h, Tw, CC, CI,
                               n, Sbuf, stream);
}

int pc_fused_f32(const void* buf, const void* starts, const void* j0,
                 const void* tpos, const void* idx6, const void* wgt6,
                 const void* pstarts, const void* colz, const void* wz,
                 const void* wl, const void* k, void* out, int B, int npart,
                 int h, int Tw, int CC, int CI, int n, int Sbuf,
                 void* stream) {
  return launch<float>(buf, starts, j0, tpos, idx6, wgt6, pstarts, colz, wz,
                       wl, k, out, B, npart, h, Tw, CC, CI, n, Sbuf, stream);
}

// What a launch at this shape (B=1, 16-byte aligned operands) runs:
// info[0] bands per block, [1] output groups per block, [2] dynamic shared
// memory per block in bytes, [3] registers per thread, [4] local (spill)
// bytes per thread, [5] blocks. Returns a cudaError_t (0 = filled).
int pc_fused_info(int bf16, int npart, int h, int Tw, int CC, int CI, int n,
                  int* info) {
  return bf16 ? info_of<__nv_bfloat16>(npart, h, Tw, CC, CI, n, info)
              : info_of<float>(npart, h, Tw, CC, CI, n, info);
}

}  // extern "C"
