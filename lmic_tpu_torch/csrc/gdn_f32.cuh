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
// The blocked loop (`blocked::product`) takes every wider C, for Hopper:
//  - a CTA of 8 warps sums tiles of 128 rows x 256 output columns (a
//    column block; the last one ragged), each warp a 32 x 128 block, each
//    thread an 8-row x 16-column register tile (128 accumulators: rows 4
//    apart, columns four quads 32 apart); a blocked::Config names the
//    shape, and the kernels also take 128 x 128 tiles of 8 x 8 and 64 x
//    128 tiles of 8 x 4 (three CTAs an SM, a ring of 3 stages each) where
//    C or n call for them;
//  - the TMA brings both operands in k-slices of blocked::kDepth = 32
//    into a ring of four stages (a full and an empty mbarrier a stage):
//    the tile's rows of a as one 128-row x 32-column box with the 128-byte
//    swizzle, w's 32 rows of the block's columns as plain 128-column
//    boxes. Thread 0 issues every box, refilling a stage as soon as every
//    warp is done with it, four slices ahead of the sums and into the
//    next tile while the last one's epilogue runs; no thread copies and
//    no CTA-wide barrier is in the loop;
//  - per 4 values of j a thread reads each of its 8 rows of a as one
//    16-byte load (the 8 lanes of a quarter warp share a row; the 4
//    quarter warps' rows differ mod 8, so the swizzle puts their units on
//    different bank quads) and, per j, its 4 quads of w (a quarter warp
//    reads 128 consecutive bytes): 24 shared loads for 512 FMAs. An SM's
//    shared memory delivers 128 bytes a clock and its FP32 pipes 128
//    FMAs: an 8 x 8 tile's 16 loads per 256 FMAs would keep both exactly
//    busy, 8 x 16 leaves shared memory a quarter of slack. Two of a
//    slice's eight 4-deep steps are unrolled: the whole slice would not
//    fit the instruction caches;
//  - the forward's x^2 is formed in each stage once it lands, by the
//    warps that share its rows: x * x, rounded once, as stage_squares
//    forms it;
//  - zeros past C come from the TMA's fill past a tensor's rows and
//    columns, and, where C % 4 != 0 or a base is off 16 bytes (the TMA's
//    rule), from zero-padded copies the launchers make in scratch: both
//    only after j = C - 1.
// The tile shape is a Config (blocked::Config); the ring's stages and the
// unrolled steps are constants (chip_probes.py gdn-f32-blocked builds
// variants of both).
// No split sums, no atomics, no tensor cores: the same bytes on every run.

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

#include "gdn_hopper.cuh"

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
// sums tiles of Config::kRows rows x Config::kCols output columns, both
// operands brought by the TMA in k-slices of kDepth through a ring of
// stages that thread 0 refills.
namespace blocked {

namespace hop = gdn_hopper;

constexpr int kDepth = 32;     // j a k-slice: a box row of a is 128 bytes
constexpr int kBoxCols = 128;  // columns of a box of w (512-byte rows)
constexpr int kRowsT = 8;      // a thread's rows, kRowGap apart

// The ring's stages (fewer where a Config's CTAs an SM leave no room for
// them), and the 4-deep steps of j a slice that are unrolled: a slice
// unrolled whole is ~4,300 instructions at kTC = 16, ~70 KB of code,
// which the SM's instruction caches do not hold (the loop ran at half
// speed); a step is ~9 KB. Fewer stages or one step unrolled cost 1-4 %
// (chip_probes.py gdn-f32-blocked patches both).
constexpr int kMaxStages = 4;
constexpr int kUnroll = 2;
// An SM's shared memory, and what the runtime keeps of it for each CTA
constexpr int kSmemPerSm = 233472;
constexpr int kSmemPerCta = 1024;
// A thread's rows lie kRowGap apart: the four row groups of a warp (its
// quarter warps) then read rows with different residues mod 8, whose
// 16-byte units the 128-byte swizzle puts on different bank quads.
constexpr int kRowGap = 4;

// A CTA's shape: a grid of kWR x kWC warps, each 32 rows (4 row groups,
// a thread's 8 rows kRowGap apart) x 8 kTC columns (8 column groups of
// kTC / 4 quads, 32 columns apart), a thread kRowsT x kTC sums, and the
// ring's stages. Eight warps a CTA, and no warp apart to feed them: a
// ninth would put three on one of the SM's four schedulers and cap every
// thread at 168 registers (ptxas allocates the whole kernel within the
// launch's count, setmaxnreg or not), where 8 x 16 sums and their
// operands take ~200. kCtas CTAs share an SM (the kernels'
// __launch_bounds__, which caps their registers to fit), each with the
// deepest ring their shared memory leaves room for, up to kMaxStages.
template <int kWR, int kWC, int kTC_, int kCtas = 1>
struct Config {
  static constexpr int kTC = kTC_;  // a thread's columns
  static constexpr int kCtasPerSm = kCtas;
  static constexpr int kWarpRowsN = kWR, kWarpColsN = kWC;
  static constexpr int kRows = 32 * kWR;       // rows a tile
  static constexpr int kCols = 8 * kTC * kWC;  // columns a block
  static constexpr int kThreads = 32 * kWR * kWC;
  static constexpr int kABytes = kRows * kDepth * 4;  // a's box
  static constexpr int kWBoxBytes = kDepth * kBoxCols * 4;
  static constexpr int kWBoxes = kCols / kBoxCols;
  static constexpr int kStageBytes = kABytes + kWBoxes * kWBoxBytes;
  // stages that fit beside the 1 KB alignment room, the barriers and what
  // the runtime keeps
  static constexpr int kRoom =
      (kSmemPerSm / kCtas - kSmemPerCta - 1024 - 16 * kMaxStages) /
      kStageBytes;
  static constexpr int kStages = kRoom < kMaxStages ? kRoom : kMaxStages;
  // 4-deep steps unrolled: one where three CTAs an SM leave 80 registers
  // a thread (two spilled there)
  static constexpr int kSteps = kCtas > 2 ? 1 : kUnroll;
  // room to align the ring to 1 KB (the swizzle's atoms), the ring
  static constexpr int kSmemBytes = 1024 + kStages * kStageBytes;
  static_assert(kThreads == 256, "eight warps");
  static_assert(kCtas >= 1 && kCtas <= 3, "80 registers a thread or more");
  static_assert(kStages >= 2, "a stage summed while the next one lands");
  static_assert(kTC == 4 || kTC == 8 || kTC == 16, "1, 2 or 4 quads");
  static_assert(kDepth / 4 % kSteps == 0, "whole unrolled steps");
  static_assert(kCols % kBoxCols == 0 && kBoxCols % (8 * kTC) == 0,
                "a warp's columns lie in one box of w");
  static_assert(kABytes % 1024 == 0, "stages on 1 KB boundaries");
  static_assert(kSmemBytes <= hop::kSmemLimit, "fits a CTA");
  static_assert(kWR <= 4, "named barriers 1 .. 4");
};

// Where this thread's tile lies: rows row + kRowGap k (k < 8) of the
// CTA's tile (its warp row row / 32), and the offset of its first column
// in a stage's boxes of w; its columns are col_of() + 32 h + q (q < 4,
// h < kTC / 4) of its block. Only what the loop needs stays in registers.
struct Lane {
  int row, wbox;
};

template <class Cfg>
__device__ __forceinline__ Lane lane_of() {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wr = warp / Cfg::kWarpColsN, wc = warp % Cfg::kWarpColsN;
  const int cw = wc * 8 * Cfg::kTC;  // the warp's first column
  return {wr * 32 + lane / 8, (cw / kBoxCols) * (kDepth * kBoxCols) +
                                  cw % kBoxCols + (lane % 8) * 4};
}

template <class Cfg>
__device__ __forceinline__ int col_of() {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  return warp % Cfg::kWarpColsN * 8 * Cfg::kTC + lane % 8 * 4;
}

// The ring of stages: stage s at ring + s * kStageBytes holds a's box
// ([kRows][kDepth] floats, 128-byte swizzle: row r's 16-byte unit u at
// u ^ r % 8) and then w's boxes ([kDepth][kBoxCols] floats each, plain).
// `full` completes when a stage's bytes have landed, `empty` when every
// warp is done with it. A CTA numbers the k-slices it sums 0, 1, ...
// over all its tiles: slice j lives in stage j % kStages, in that
// stage's phase j / kStages. Thread 0 fills the first kStages stages,
// then refills a stage with slice j + kStages as soon as every warp is
// done with slice j: one thread issues every box, and the loads run
// kStages slices ahead of the sums.
template <class Cfg>
struct Ring {
  unsigned char *base;
  uint64_t *full, *empty;
  __device__ __forceinline__ float *a(int s) const {
    return reinterpret_cast<float *>(base + s * Cfg::kStageBytes);
  }
  __device__ __forceinline__ float *w(int s) const {
    return reinterpret_cast<float *>(base + s * Cfg::kStageBytes +
                                     Cfg::kABytes);
  }
  // thread 0: waits until slice j's stage is free, then announces its
  // bytes; returns the stage
  __device__ __forceinline__ int claim(int j) const {
    const int s = j % Cfg::kStages;
    if (j >= Cfg::kStages)
      hop::mbar_wait(empty + s, (j / Cfg::kStages - 1) & 1);
    hop::mbar_expect(full + s, Cfg::kStageBytes);
    return s;
  }
  // thread 0: w's boxes of k-slice k for the column block at col0
  __device__ __forceinline__ void load_w(int s, const CUtensorMap &map,
                                         int col0, int k) const {
#pragma unroll
    for (int b = 0; b < Cfg::kWBoxes; ++b)
      hop::tma_box(w(s) + b * (kDepth * kBoxCols), map, col0 + b * kBoxCols,
                   k * kDepth, full + s);
  }
  // thread 0: a's box of k-slice k for the rows from row0
  __device__ __forceinline__ void load_a(int s, const CUtensorMap &map,
                                         int row0, int k) const {
    hop::tma_box(a(s), map, k * kDepth, row0, full + s);
  }
};

// Carves the ring out of the dynamic shared memory and initialises its
// barriers (thread 0); the caller puts a barrier of the whole CTA between
// this and any use.
template <class Cfg>
__device__ __forceinline__ Ring<Cfg> make_ring(unsigned char *smem_raw,
                                               uint64_t *full,
                                               uint64_t *empty) {
  Ring<Cfg> ring;
  ring.base = smem_raw + (1024 - hop::smem_at(smem_raw) % 1024) % 1024;
  ring.full = full;
  ring.empty = empty;
  if (threadIdx.x == 0) {
    for (int s = 0; s < Cfg::kStages; ++s) {
      hop::mbar_init(full + s);
      hop::mbar_init(empty + s, Cfg::kThreads / 32);  // an arrival a warp
    }
    hop::fence_mbar_init();
  }
  return ring;
}

__device__ __forceinline__ float part(const float4 &v, int t) {
  return t == 0 ? v.x : t == 1 ? v.y : t == 2 ? v.z : v.w;
}

// acc[k][4 h + q] = sum_j a'[row + kRowGap k][j] * w[j][col + 32 h + q]
// over j = 0 .. slices * kDepth - 1 in order (a' = a^2, rounded once, with
// kSquare, else a), one fmaf chain each from 0.f, over the next `slices`
// stages of the ring from slice *it on; zeros past C in both operands come
// only after j = C - 1 (fmaf(0, w, acc) == acc, and a chain from +0 is
// never -0). With kSquare the warps of a warp row square its 32 rows of
// each stage once it lands, then meet at a named barrier. Per 4 values of
// j a thread issues 8 16-byte loads of a (one per row: the 8 lanes of a
// quarter warp read the same 16 bytes, the 4 quarter warps units on
// different bank quads) and kTC / 4 of w for each j (a quarter warp's 8
// lanes read 128 consecutive bytes): 24 loads for 512 FMAs at kTC = 16.
// Once every warp is done with a slice j, thread 0 calls refill(j +
// kStages), which refills its stage.
template <class Cfg, bool kSquare, class Refill>
__device__ __forceinline__ void product(float (&acc)[kRowsT][Cfg::kTC],
                                        const Ring<Cfg> &ring, int *it,
                                        int slices, const Lane &me,
                                        Refill &&refill) {
  constexpr int kTC = Cfg::kTC;
#pragma unroll
  for (int k = 0; k < kRowsT; ++k)
#pragma unroll
    for (int c = 0; c < kTC; ++c) acc[k][c] = 0.f;
  int j = *it;
  for (const int end = j + slices; j < end; ++j) {
    const int s = j % Cfg::kStages;
    hop::mbar_wait(ring.full + s, (j / Cfg::kStages) & 1);
    float *sa = ring.a(s);
    if (kSquare) {
      // the 32 rows of this warp row, squared by the warps that read them
      constexpr int kShare = 32 * Cfg::kWarpColsN;
      const int wr = me.row / 32;
      float4 *rows = reinterpret_cast<float4 *>(sa + wr * 32 * kDepth);
      const int t = threadIdx.x % kShare;
#pragma unroll
      for (int i = 0; i < 32 * kDepth / 4 / kShare; ++i) {
        const float4 v = rows[t + i * kShare];
        rows[t + i * kShare] =
            make_float4(v.x * v.x, v.y * v.y, v.z * v.z, v.w * v.w);
      }
      hop::named_sync(1 + wr, kShare);
    }
    const float *as = sa + me.row * kDepth;
    const float *ws = ring.w(s) + me.wbox;
#pragma unroll Cfg::kSteps
    for (int u = 0; u < kDepth / 4; ++u) {
      // row r's 16-byte unit u lies at u ^ r % 8 (the swizzle)
      const int uq = u ^ (me.row & 7);
      if constexpr (kTC == 4) {
        // one quad of w a j: the step's 4 rows of w held and a read a row
        // at a time (three CTAs an SM leave 80 registers a thread)
        float4 bv[4];
#pragma unroll
        for (int t = 0; t < 4; ++t)
          bv[t] = *reinterpret_cast<const float4 *>(
              ws + (4 * u + t) * kBoxCols);
#pragma unroll
        for (int k = 0; k < kRowsT; ++k) {
          const float4 a4 = *reinterpret_cast<const float4 *>(
              as + kRowGap * k * kDepth + (uq ^ (kRowGap * k & 7)) * 4);
#pragma unroll
          for (int t = 0; t < 4; ++t) {
            const float x = part(a4, t);
            acc[k][0] = fmaf(x, bv[t].x, acc[k][0]);
            acc[k][1] = fmaf(x, bv[t].y, acc[k][1]);
            acc[k][2] = fmaf(x, bv[t].z, acc[k][2]);
            acc[k][3] = fmaf(x, bv[t].w, acc[k][3]);
          }
        }
      } else {
        float4 av[kRowsT];
#pragma unroll
        for (int k = 0; k < kRowsT; ++k)
          av[k] = *reinterpret_cast<const float4 *>(
              as + kRowGap * k * kDepth + (uq ^ (kRowGap * k & 7)) * 4);
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          float4 bv[kTC / 4];
#pragma unroll
          for (int h = 0; h < kTC / 4; ++h)
            bv[h] = *reinterpret_cast<const float4 *>(
                ws + (4 * u + t) * kBoxCols + 32 * h);
#pragma unroll
          for (int k = 0; k < kRowsT; ++k) {
            const float x = part(av[k], t);
#pragma unroll
            for (int h = 0; h < kTC / 4; ++h) {
              acc[k][4 * h + 0] = fmaf(x, bv[h].x, acc[k][4 * h + 0]);
              acc[k][4 * h + 1] = fmaf(x, bv[h].y, acc[k][4 * h + 1]);
              acc[k][4 * h + 2] = fmaf(x, bv[h].z, acc[k][4 * h + 2]);
              acc[k][4 * h + 3] = fmaf(x, bv[h].w, acc[k][4 * h + 3]);
            }
          }
        }
      }
    }
    // the squares' generic stores come before the TMA's next write there
    if (kSquare) hop::fence_proxy_async();
    __syncwarp();
    if (threadIdx.x % 32 == 0) hop::mbar_arrive(ring.empty + s);
    if (threadIdx.x == 0) refill(j + Cfg::kStages);
  }
  *it = j;
}

// Rows of C elements at src into rows of `width` at dst (16-byte aligned),
// zeros past C in each: the zero-padded copies the TMA can address.
__host__ inline cudaError_t pad_rows(void *dst, const void *src,
                                     int64_t rows, int C, int width,
                                     cudaStream_t stream) {
  const size_t row = 4 * static_cast<size_t>(C);
  const size_t wide = 4 * static_cast<size_t>(width);
  cudaError_t err = cudaSuccess;
  if (wide > row)
    err = cudaMemset2DAsync(static_cast<char *>(dst) + row, wide, 0,
                            wide - row, rows, stream);
  if (err == cudaSuccess)
    err = cudaMemcpy2DAsync(dst, wide, src, row, row, rows,
                            cudaMemcpyDeviceToDevice, stream);
  return err;
}

// Rows of `width` at src (the kernel's padded output) back into rows of C
// at dst.
__host__ inline cudaError_t unpad_rows(void *dst, const void *src,
                                       int64_t rows, int C, int width,
                                       cudaStream_t stream) {
  const size_t row = 4 * static_cast<size_t>(C);
  return cudaMemcpy2DAsync(dst, row, src, 4 * static_cast<size_t>(width),
                           row, rows, cudaMemcpyDeviceToDevice, stream);
}

// A (width, width) zero-padded copy of a (C, C) matrix.
__host__ inline cudaError_t pad_square(void *dst, const void *src, int C,
                                       int width, cudaStream_t stream) {
  cudaError_t err = cudaSuccess;
  if (width > C)
    err = cudaMemsetAsync(dst, 0, 4 * static_cast<size_t>(width) * width,
                          stream);
  return err == cudaSuccess ? pad_rows(dst, src, C, C, width, stream) : err;
}

// The TMA's view of a (rows, width) f32 operand a of the blocked loop
// (width % 4 == 0, 16-byte aligned): boxes of kDepth columns x Cfg::kRows
// rows with the 128-byte swizzle, zeros past rows and width.
template <class Cfg>
__host__ inline cudaError_t a_map(CUtensorMap *map, const void *p,
                                  int64_t rows, int width) {
  return hop::tensor_map(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, p, rows,
                         width, kDepth, Cfg::kRows,
                         CU_TENSOR_MAP_SWIZZLE_128B);
}

// ... and of a (width, width) f32 w: plain boxes of kDepth rows x
// kBoxCols columns, zeros past width both ways.
__host__ inline cudaError_t w_map(CUtensorMap *map, const void *p,
                                  int width) {
  return hop::tensor_map(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, p, width,
                         width, kBoxCols, kDepth, CU_TENSOR_MAP_SWIZZLE_NONE);
}

// The persistent grid of `kernel` (Cfg's threads and shared memory, set
// beforehand) over `tiles` tiles: as many CTAs as the card holds at once,
// no more than there are tiles. The sums' order does not depend on it.
template <class Cfg, class Kernel>
__host__ inline cudaError_t grid_of(Kernel kernel, int64_t tiles,
                                    int *grid) {
  const int sms = hop::sm_count();
  int per_sm = 0;
  if (!sms || cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                  &per_sm, kernel, Cfg::kThreads, Cfg::kSmemBytes) !=
                  cudaSuccess || !per_sm)
    return cudaErrorNoDevice;
  const int64_t most = int64_t{sms} * per_sm;
  *grid = static_cast<int>(tiles < most ? tiles : most);
  return cudaSuccess;
}

// This CTA's rank in its cluster and the cluster's CTAs (1 and 1 when
// launched without clusters).
__device__ __forceinline__ int cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return static_cast<int>(r);
}

__device__ __forceinline__ int cluster_size() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_nctarank;\n" : "=r"(r));
  return static_cast<int>(r);
}

// A barrier of every thread of the cluster: what each wrote before it
// (device memory included) is seen by all after it.
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// v[q] = p[c + q] for c + q < live, zeros past it: one 16-byte load with
// `vec` (p + c 16-byte aligned, all 4 live), else one a value.
__device__ __forceinline__ float4 load4(const float *p, int c, int live,
                                        bool vec) {
  if (vec) return *reinterpret_cast<const float4 *>(p + c);
  float v[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) v[q] = c + q < live ? p[c + q] : 0.f;
  return make_float4(v[0], v[1], v[2], v[3]);
}

// p[c + q] = v[q] for c + q < live, as load4 reads them.
__device__ __forceinline__ void store4(float *p, int c, int live,
                                       const float (&v)[4], bool vec) {
  if (vec) {
    *reinterpret_cast<float4 *>(p + c) = make_float4(v[0], v[1], v[2], v[3]);
    return;
  }
#pragma unroll
  for (int q = 0; q < 4; ++q)
    if (c + q < live) p[c + q] = v[q];
}

// Whether the blocked kernels take 128-column blocks of 8 x 8 sums a
// thread at this width rather than 256-column blocks of 8 x 16: the wider
// tiles' loop is ~10 % faster (chip_probes.py gdn-f32-blocked), but their
// last block may be half empty (C = 640 sums 768 columns in 256-column
// blocks, 640 in 128-column ones). A rule on C alone.
__host__ inline bool narrow_blocks(int width) {
  const int w16 = (width + 255) / 256 * 256, w8 = (width + 127) / 128 * 128;
  return 11 * w8 < 10 * w16;
}

// k-slices of a product of depth `width`
__host__ __device__ constexpr int slices_of(int width) {
  return (width + kDepth - 1) / kDepth;
}

}  // namespace blocked

}  // namespace gdn_f32
