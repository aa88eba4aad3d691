// The FP32 main loops of the f32 GDN / IGDN kernels, Hopper (sm_90a):
// gdn_fwd_kernel and gdn_fwd_f32_blocked_kernel (csrc/gdn_fwd.cu),
// gdn_bwd_dx_kernel and gdn_bwd_dx_f32_blocked_kernel (csrc/gdn_bwd.cu).
//
// All are bound by FP32 operations: at C = 192 a row costs 2*C^2 FMAs
// for 8*C bytes of x and y, far above the H100's ~20 FP32 operations per
// byte of HBM, and TF32 stays off (the wire graphs must be bit-stable and
// the JAX kernel runs f32 at Precision.HIGHEST). So a loop's job is to
// keep the FP32 pipes fed, and its one product is
//
//   acc[r][c] = sum_j a[r][j] * w[j][c],   j = 0..C-1 in order,
//
// one fmaf chain per output from 0.f: the order the f32 kernels have
// always summed in, on which the wire's bytes depend. Both loops give
// every output that chain, so a launch gives the same bytes on every run,
// whatever the grid.
//
// The whole-width loop (`product`, C <= kWholeWidth = 384):
//  - a CTA takes `rows` rows (32 per warp row) and all C output channels,
//    padded to Cp (a multiple of 32): its warps form a grid of
//    Cp / 32 columns x wrows rows, each warp a 32 x 32 block, each thread an
//    8-row x 4-channel register tile (32 accumulators; lanes 4 row groups x
//    8 channel groups, so a warp's loads of either operand are one
//    128-byte wavefront each);
//  - a (the x^2 of the CTA's rows, or dn) is staged once, transposed
//    ([Cp][rows + 4] floats), so a thread reads its 8 rows of one j as two
//    16-byte loads;
//  - w (gamma^T or gamma, C x C) streams through shared memory in k-slices
//    of kSlice rows across all Cp columns, copied with cp.async into a
//    double buffer: the next slice is in flight while the current one is
//    summed, one barrier per slice, and nothing in the loop goes through
//    __ldg. Per j a thread issues three 16-byte shared loads for 32 FMAs;
//  - a kernel instantiated for one C (the main path's 192 and 128) has
//    every stride and trip count as a constant, so the shared loads take
//    immediate offsets;
//  - ragged C: rows j >= C of both operands are zeros, and they come only
//    after j = C-1, where fmaf(0, 0, acc) == acc; columns past C are summed
//    and dropped. Without 16-byte alignment (C % 4 != 0 or a base that is
//    not 16-byte aligned) w is copied element by element.
// Past 384 channels one CTA's warps cannot cover C, and a whole-depth
// stage of a does not fit: [Cp][rows + 4] floats are 295 KB at C = 2048.
// The blocked loop (`blocked::product`) takes every wider C:
//  - a CTA sums a tile of blocked::kRows = 64 rows x blocked::kCols = 128
//    output columns (a column block; the last one ragged), 8 warps of the
//    same 32 x 32 blocks and 8 x 4 register tiles;
//  - both operands stream in k-slices of blocked::kDepth = 32: the tile's
//    rows of a, row-major ([64][32 + 4] floats), and w's 32 rows of the
//    block's 128 columns, through a double buffer of cp.async copies, one
//    barrier a slice (51 KB of shared memory, so two CTAs share an SM);
//    the forward's x is squared in place by the thread that copied it,
//    once its copy has landed;
//  - a thread's 8 rows are 4 apart (rows g, g + 4, ..., g + 28 of its
//    warp's 32), so for 4 values of j it reads each of its rows of a as one
//    16-byte load, and a warp's 4 row groups, one staged row apart, fall on
//    4 different bank quads; w's 4 rows of j are one 16-byte load each:
//    12 shared loads for 128 FMAs;
//  - ragged C and unaligned bases as in the whole-width loop: zeros past C
//    in both operands (after j = C - 1), element copies without 16-byte
//    alignment.
// No split sums, no atomics, no tensor cores: the same bytes on every run.

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace gdn_f32 {

constexpr int kTileRows = 8;   // a thread's rows
constexpr int kTileCols = 4;   // a thread's channels
constexpr int kWarpRows = 32;  // a warp's block: 4 row groups of 8 ...
constexpr int kWarpCols = 32;  // ... x 8 channel groups of 4
constexpr int kSlice = 16;     // rows of w per k-slice
constexpr int kMaxWarps = 12;  // so C <= 32 * kMaxWarps = 384
constexpr int kMaxThreads = kMaxWarps * 32;
constexpr int kTargetWarps = 8;  // warps a CTA aims at when C is narrow
// The widest C the whole-width loop takes: one warp column per 32
// channels, at most kMaxWarps of them. Wider C runs the blocked loop.
constexpr int kWholeWidth = kWarpCols * kMaxWarps;

// How a CTA of the f32 kernels covers C channels.
struct Shape {
  int Cp;     // C padded to whole warp columns
  int Ck;     // C padded to whole k-slices: the products' depth
  int cols;   // warp columns, Cp / 32
  int wrows;  // warp rows
  int rows;   // rows per CTA, 32 * wrows
  int lda;    // floats per staged channel of a, rows + 4 (16-byte aligned)
  int threads;
};

__host__ __device__ constexpr Shape shape_of(int C) {
  Shape s{};
  s.cols = (C + kWarpCols - 1) / kWarpCols;
  s.Cp = s.cols * kWarpCols;
  s.Ck = (C + kSlice - 1) / kSlice * kSlice;
  s.wrows = s.cols < kTargetWarps ? kTargetWarps / s.cols : 1;
  s.rows = s.wrows * kWarpRows;
  s.lda = s.rows + 4;
  s.threads = s.cols * s.wrows * 32;
  return s;
}

// Shared memory of a CTA, in floats: the staged a ([Cp][lda]), two
// k-slices of w ([kSlice][Cp] each) and `tiles` row blocks ([rows][Cp]).
__host__ __device__ constexpr int smem_floats(const Shape &s, int tiles) {
  return s.Cp * s.lda + 2 * kSlice * s.Cp + tiles * s.rows * s.Cp;
}

// the widest whole-width CTA fits a Hopper CTA's 227 KB with the dx
// kernel's two row blocks of x and g (198 KB at C = 384)
static_assert(shape_of(kWholeWidth).threads <= kMaxThreads &&
                  smem_floats(shape_of(kWholeWidth), 2) * 4 <= 232448,
              "the whole-width loop covers C up to kWholeWidth");

// This thread's tile: rows r0 .. r0+7 of the CTA, channels c0 .. c0+3.
__device__ __forceinline__ void tile_of(const Shape &s, int *r0, int *c0) {
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  *r0 = (warp / s.cols) * kWarpRows + (lane / 8) * kTileRows;
  *c0 = (warp % s.cols) * kWarpCols + (lane % 8) * kTileCols;
}

// 16 bytes, or 4, from global to shared memory, asynchronously; with
// `valid` 0 nothing is read and the destination is zero-filled
__device__ __forceinline__ void cp_async16(float *dst, const float *src,
                                           int valid) {
  const unsigned at = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(at),
               "l"(src), "r"(valid)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float *dst, const float *src,
                                          int valid) {
  const unsigned at = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(at),
               "l"(src), "r"(valid)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Starts copying `rows` rows of p (row-major, C columns) from row0 into
// buf ([rows][Cp]): zeros from row `valid` on and past column C; commits
// the copies as one group.
__device__ __forceinline__ void issue_rows(float *buf,
                                           const float *__restrict__ p,
                                           int64_t row0, int rows, int valid,
                                           int C, const Shape &s, bool vec) {
  if (vec) {
    const int quads = s.Cp / 4;
    for (int e = threadIdx.x; e < rows * quads; e += s.threads) {
      const int r = e / quads;
      const int c = (e - r * quads) * 4;
      const bool live = r < valid && c < C;
      cp_async16(buf + r * s.Cp + c, live ? p + (row0 + r) * C + c : p,
                 live ? 16 : 0);
    }
  } else {
    for (int e = threadIdx.x; e < rows * s.Cp; e += s.threads) {
      const int r = e / s.Cp;
      const int c = e - r * s.Cp;
      const bool live = r < valid && c < C;
      cp_async4(buf + e, live ? p + (row0 + r) * C + c : p, live ? 4 : 0);
    }
  }
  cp_async_commit();
}

// Starts copying k-slice `k` of w (C x C) into buf ([kSlice][Cp]).
__device__ __forceinline__ void issue_slice(float *buf,
                                            const float *__restrict__ w,
                                            int k, int C, const Shape &s,
                                            bool vec) {
  issue_rows(buf, w, k * kSlice, kSlice, C - k * kSlice, C, s, vec);
}

// at[c][r] = x[row0 + r][c]^2 for r < valid rows and c < C, zeros
// elsewhere in the staged [Cp][lda] tile (rows past n and the padding).
// With `vec` the lanes of a warp take 32 consecutive rows of one 4-channel
// group, so the transposed stores are free of bank conflicts, and a
// thread's kBatch 16-byte loads are all in flight before it stores any.
constexpr int kBatch = 8;

__device__ __forceinline__ void stage_squares(float *at,
                                              const float *__restrict__ x,
                                              int64_t row0, int valid, int C,
                                              const Shape &s, bool vec) {
  if (!vec) {
#pragma unroll 4
    for (int i = threadIdx.x; i < s.rows * s.Cp; i += s.threads) {
      const int r = i / s.Cp;
      const int c = i - r * s.Cp;
      float v = 0.f;
      if (r < valid && c < C) {
        v = __ldg(x + (row0 + r) * C + c);
        v = v * v;
      }
      at[c * s.lda + r] = v;
    }
    return;
  }
  const int total = s.rows * (s.Cp / 4);
  for (int base = threadIdx.x; base < total; base += kBatch * s.threads) {
    float4 v[kBatch];
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const int i = base + b * s.threads;
      const int r = i % s.rows;
      const int c = i / s.rows * 4;
      v[b] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (i < total && r < valid && c < C)
        v[b] = __ldg(reinterpret_cast<const float4 *>(x + (row0 + r) * C + c));
    }
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const int i = base + b * s.threads;
      if (i >= total) break;
      float *to = at + (i / s.rows * 4) * s.lda + i % s.rows;
      to[0] = v[b].x * v[b].x;
      to[s.lda] = v[b].y * v[b].y;
      to[2 * s.lda] = v[b].z * v[b].z;
      to[3 * s.lda] = v[b].w * v[b].w;
    }
  }
}

// v[k][q] = p[row + k][c0 + q] of an (n, C) array for k < live rows and
// c0 + q < C, zeros elsewhere; every load is issued before any is used.
template <int N>
__device__ __forceinline__ void load_rows(float (&v)[N][kTileCols],
                                          const float *__restrict__ p,
                                          int64_t row, int live, int c0,
                                          int C, bool vec) {
#pragma unroll
  for (int k = 0; k < N; ++k) {
    const float *src = p + (row + k) * C + c0;
    if (vec && k < live && c0 < C) {  // C % 4 == 0: all 4 channels live
      const float4 t = __ldg(reinterpret_cast<const float4 *>(src));
      v[k][0] = t.x, v[k][1] = t.y, v[k][2] = t.z, v[k][3] = t.w;
    } else {
#pragma unroll
      for (int q = 0; q < kTileCols; ++q)
        v[k][q] = k < live && c0 + q < C ? __ldg(src + q) : 0.f;
    }
  }
}

// p[row + k][c0 + q] = v[k][q] for k < live rows and c0 + q < C
template <int N>
__device__ __forceinline__ void store_rows(float *p,
                                           const float (&v)[N][kTileCols],
                                           int64_t row, int live, int c0,
                                           int C, bool vec) {
#pragma unroll
  for (int k = 0; k < N; ++k) {
    if (k >= live || c0 >= C) break;
    float *dst = p + (row + k) * C + c0;
    if (vec) {
      *reinterpret_cast<float4 *>(dst) =
          make_float4(v[k][0], v[k][1], v[k][2], v[k][3]);
    } else {
#pragma unroll
      for (int q = 0; q < kTileCols; ++q)
        if (c0 + q < C) dst[q] = v[k][q];
    }
  }
}

// acc[k][q] = sum_j at[j][r0 + k] * w[j][c0 + q] over j = 0..Ck-1 in order,
// one fmaf chain each from 0.f. k-slice 0 of w must already be issued
// into wbuf (issue_slice); slice k+1 is copied into the other half while
// slice k is summed. Starts with a barrier, so what the CTA staged into
// `at` before the call is seen; the caller puts a barrier between the
// call's end and any reuse of `at` or wbuf.
__device__ __forceinline__ void product(float (&acc)[kTileRows][kTileCols],
                                        const float *at, float *wbuf,
                                        const float *__restrict__ w, int C,
                                        const Shape &s, int r0, int c0,
                                        bool vec) {
#pragma unroll
  for (int k = 0; k < kTileRows; ++k)
#pragma unroll
    for (int q = 0; q < kTileCols; ++q) acc[k][q] = 0.f;
  const int slices = s.Ck / kSlice;
  for (int k = 0; k < slices; ++k) {
    cp_async_wait_all();  // slice k has landed for this thread ...
    __syncthreads();      // ... and for all; slice k-1 is done with
    if (k + 1 < slices)
      issue_slice(wbuf + ((k + 1) % 2) * kSlice * s.Cp, w, k + 1, C, s, vec);
    const float *ws = wbuf + (k % 2) * kSlice * s.Cp + c0;
    const float *as = at + k * kSlice * s.lda + r0;
#pragma unroll
    for (int jj = 0; jj < kSlice; ++jj) {
      const float4 a0 = *reinterpret_cast<const float4 *>(as + jj * s.lda);
      const float4 a1 =
          *reinterpret_cast<const float4 *>(as + jj * s.lda + 4);
      const float4 b = *reinterpret_cast<const float4 *>(ws + jj * s.Cp);
      const float av[kTileRows] = {a0.x, a0.y, a0.z, a0.w,
                                   a1.x, a1.y, a1.z, a1.w};
      const float bv[kTileCols] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int r = 0; r < kTileRows; ++r)
#pragma unroll
        for (int q = 0; q < kTileCols; ++q)
          acc[r][q] = fmaf(av[r], bv[q], acc[r][q]);
    }
  }
}

// The blocked loop, for C > kWholeWidth (see the top of this file): a CTA
// sums kRows rows x kCols output columns, both operands streamed in
// k-slices of kDepth.
namespace blocked {

constexpr int kRows = 64;  // rows a CTA: 2 warp rows of 32
constexpr int kCols = 128;  // output columns a column block: 4 warp columns
constexpr int kDepth = 32;  // j a k-slice
constexpr int kLda = kDepth + 4;  // floats a staged row of a (16-byte rows)
constexpr int kWarpsAcross = kCols / kWarpCols;
constexpr int kThreads = kRows / kWarpRows * kWarpsAcross * 32;  // 256
constexpr int kAFloats = kRows * kLda;  // a's slice, [kRows][kLda]
constexpr int kWFloats = kDepth * kCols;  // w's slice, [kDepth][kCols]
constexpr int kStageFloats = kAFloats + kWFloats;
constexpr int kSmemBytes = 2 * kStageFloats * 4;  // a double buffer
static_assert(kWarpCols == 32 && kTileRows == 8 && kTileCols == 4,
              "a warp's 32 x 32 block of 8 x 4 tiles, rows 4 apart");
static_assert(kDepth % 4 == 0 && kLda % 4 == 0 && kLda % 32 != 0,
              "16-byte rows of a, consecutive rows on other bank quads");

// This thread's tile in the CTA's kRows x kCols block: rows r0 + 4 k for
// k < 8, columns c0 .. c0 + 3.
__device__ __forceinline__ void tile_of(int *r0, int *c0) {
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  *r0 = (warp / kWarpsAcross) * kWarpRows + lane / 8;
  *c0 = (warp % kWarpsAcross) * kWarpCols + (lane % 8) * kTileCols;
}

// Starts copying k-slice k of a (rows row0 .. row0 + kRows - 1 of an
// (n, C) row-major array, columns j = k kDepth ..) into sa ([kRows][kLda])
// and of w (rows j, columns col0 .. col0 + kCols - 1 of a C x C
// row-major array) into sw ([kDepth][kCols]): zeros from row `valid` of
// a on and past C in either; commits the copies as one group. The
// elements a thread copies of a are the ones `square_own` squares.
__device__ __forceinline__ void issue(float *sa, float *sw,
                                      const float *__restrict__ a,
                                      int64_t row0, int valid,
                                      const float *__restrict__ w, int col0,
                                      int k, int C, bool vec) {
  const int j0 = k * kDepth;
  if (vec) {
    constexpr int kQa = kDepth / 4, kQw = kCols / 4;
    for (int e = threadIdx.x; e < kRows * kQa; e += kThreads) {
      const int r = e / kQa, j = j0 + (e % kQa) * 4;
      const bool live = r < valid && j < C;
      cp_async16(sa + r * kLda + (j - j0), live ? a + (row0 + r) * C + j : a,
                 live ? 16 : 0);
    }
    for (int e = threadIdx.x; e < kDepth * kQw; e += kThreads) {
      const int jj = e / kQw, c = (e % kQw) * 4;
      const bool live = j0 + jj < C && col0 + c < C;
      cp_async16(sw + jj * kCols + c,
                 live ? w + static_cast<int64_t>(j0 + jj) * C + col0 + c : w,
                 live ? 16 : 0);
    }
  } else {
    for (int e = threadIdx.x; e < kRows * kDepth; e += kThreads) {
      const int r = e / kDepth, j = j0 + e % kDepth;
      const bool live = r < valid && j < C;
      cp_async4(sa + r * kLda + (j - j0), live ? a + (row0 + r) * C + j : a,
                live ? 4 : 0);
    }
    for (int e = threadIdx.x; e < kDepth * kCols; e += kThreads) {
      const int jj = e / kCols, c = e % kCols;
      const bool live = j0 + jj < C && col0 + c < C;
      cp_async4(sw + e,
                live ? w + static_cast<int64_t>(j0 + jj) * C + col0 + c : w,
                live ? 4 : 0);
    }
  }
  cp_async_commit();
}

// x^2 in place over the elements of a's slice that this thread copied
// (issue's loops), once its copies have landed: x * x rounded once, as
// stage_squares forms it.
__device__ __forceinline__ void square_own(float *sa, bool vec) {
  if (vec) {
    constexpr int kQa = kDepth / 4;
    for (int e = threadIdx.x; e < kRows * kQa; e += kThreads) {
      float4 *p = reinterpret_cast<float4 *>(sa + (e / kQa) * kLda +
                                             (e % kQa) * 4);
      const float4 v = *p;
      *p = make_float4(v.x * v.x, v.y * v.y, v.z * v.z, v.w * v.w);
    }
  } else {
    for (int e = threadIdx.x; e < kRows * kDepth; e += kThreads) {
      float *p = sa + (e / kDepth) * kLda + e % kDepth;
      *p = *p * *p;
    }
  }
}

// acc[k][q] = sum_j a'[r0 + 4 k][j] * w[j][col0 + c0 + q] over j = 0..C-1
// in order (a' = a^2 with kSquare, else a), one fmaf chain each from 0.f,
// over k-slices of both operands streamed through `smem` (kSmemBytes):
// slice k + 1 is copied into one half while slice k is summed from the
// other. Rows are the CTA's rows row0 .., `valid` of them. Starts with a
// barrier, so the CTA is done with `smem` and sees what it wrote to
// device memory before the call; every thread of the CTA must call it.
template <bool kSquare>
__device__ __forceinline__ void product(float (&acc)[kTileRows][kTileCols],
                                        float *smem,
                                        const float *__restrict__ a,
                                        int64_t row0, int valid,
                                        const float *__restrict__ w,
                                        int col0, int C, int r0, int c0,
                                        bool vec) {
#pragma unroll
  for (int k = 0; k < kTileRows; ++k)
#pragma unroll
    for (int q = 0; q < kTileCols; ++q) acc[k][q] = 0.f;
  const int slices = (C + kDepth - 1) / kDepth;
  __syncthreads();
  issue(smem, smem + kAFloats, a, row0, valid, w, col0, 0, C, vec);
  for (int k = 0; k < slices; ++k) {
    float *sa = smem + (k % 2) * kStageFloats;
    cp_async_wait_all();  // slice k has landed for this thread ...
    if (kSquare) square_own(sa, vec);
    __syncthreads();  // ... and for all; slice k - 1 is done with
    if (k + 1 < slices) {
      float *next = smem + ((k + 1) % 2) * kStageFloats;
      issue(next, next + kAFloats, a, row0, valid, w, col0, k + 1, C, vec);
    }
    const float *as = sa + r0 * kLda;
    const float *ws = sa + kAFloats + c0;
#pragma unroll
    for (int jj = 0; jj < kDepth; jj += 4) {
      float4 av[kTileRows], bv[4];
#pragma unroll
      for (int r = 0; r < kTileRows; ++r)
        av[r] = *reinterpret_cast<const float4 *>(as + 4 * r * kLda + jj);
#pragma unroll
      for (int t = 0; t < 4; ++t)
        bv[t] = *reinterpret_cast<const float4 *>(ws + (jj + t) * kCols);
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const float b[kTileCols] = {bv[t].x, bv[t].y, bv[t].z, bv[t].w};
#pragma unroll
        for (int r = 0; r < kTileRows; ++r) {
          const float x = t == 0   ? av[r].x
                          : t == 1 ? av[r].y
                          : t == 2 ? av[r].z
                                   : av[r].w;
#pragma unroll
          for (int q = 0; q < kTileCols; ++q)
            acc[r][q] = fmaf(x, b[q], acc[r][q]);
        }
      }
    }
  }
}

// v[q] = p[row0 + r][c + q] of an (n, C) row-major array for r < valid
// and c + q < C, zeros elsewhere; with kNc through the read-only path
// (__ldg), for arrays the kernel does not write.
template <bool kNc>
__device__ __forceinline__ void load_row(float (&v)[kTileCols],
                                         const float *p, int64_t row0, int r,
                                         int valid, int c, int C, bool vec) {
  const float *src = p + (row0 + r) * C + c;
  if (vec && r < valid && c < C) {  // C % 4 == 0: all 4 channels live
    const float4 t = kNc ? __ldg(reinterpret_cast<const float4 *>(src))
                         : *reinterpret_cast<const float4 *>(src);
    v[0] = t.x, v[1] = t.y, v[2] = t.z, v[3] = t.w;
  } else {
#pragma unroll
    for (int q = 0; q < kTileCols; ++q)
      v[q] = r < valid && c + q < C ? (kNc ? __ldg(src + q) : src[q]) : 0.f;
  }
}

// p[row0 + r][c + q] = v[q] for r < valid and c + q < C
__device__ __forceinline__ void store_row(float *p,
                                          const float (&v)[kTileCols],
                                          int64_t row0, int r, int valid,
                                          int c, int C, bool vec) {
  if (r >= valid || c >= C) return;
  float *dst = p + (row0 + r) * C + c;
  if (vec) {
    *reinterpret_cast<float4 *>(dst) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int q = 0; q < kTileCols; ++q)
      if (c + q < C) dst[q] = v[q];
  }
}

}  // namespace blocked

}  // namespace gdn_f32
