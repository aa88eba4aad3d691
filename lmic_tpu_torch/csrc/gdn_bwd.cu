// GDN / IGDN backward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel lmic_tpu/ops/pallas_gdn.py::_bwd_kernel
// (launched by _gdn_bwd_pallas behind the custom VJP _gdn_bwd). For x and
// the cotangent g of shape (n, C), row-major, it computes
//
//   norm[r, o] = beta[o] + sum_j x[r, j]^2 * gamma[o, j]   (recomputed, f32)
//   GDN:  dn = -g x norm^(-3/2) / 2,   scale = norm^(-1/2)
//   IGDN: dn =  g x norm^(-1/2) / 2,   scale = norm^(1/2)
//   dx[r, i]     = g scale + 2 x[r, i] * sum_o dn[r, o] gamma[o, i]
//   dbeta[o]     = sum_r dn[r, o]
//   dgamma[o, i] = sum_r dn[r, o] x[r, i]^2
//
// What bounds it: three (n x C) . (C x C) products, 6*n*C^2 operations,
// against x and g read and dx written, 3*n*C elements. At C = 192 in f32
// that is 96 operations per byte, far above the H100's ~20 FP32 operations
// per byte of HBM: bound by the FP32 CUDA cores (TF32 is off, as the JAX
// kernel runs f32 at Precision.HIGHEST). In bf16 the products run on the
// tensor cores (58 GFLOP at 262,144 x 192, 0.06 ms at 989 TFLOP/s), and
// it is bound by bytes: x, g and dx (0.09 ms), plus the dn scratch that
// the structure below writes and reads back (bf16, 0.03 ms each way).
//
// The hazard is the reduction over rows. The TPU kernel adds each tile's
// dbeta/dgamma into an output block that every sequential grid step
// revisits; CUDA blocks run in no order. So the design is three launches,
// no atomics, and the same bytes on every run:
//  1. gdn_bwd_dx: a CTA per 64-row tile (the bf16 kernels: persistent
//     CTAs walk tiles). It recomputes the norm (f32: with the forward
//     kernel's sums, csrc/gdn_fwd.cu, the same products added in the same
//     order; bf16: in wgmma's order); forms dn and g*scale elementwise;
//     writes dn to an (n, C) scratch; stages dn rounded to the input type,
//     and forms dx = g*scale + 2x (dn . gamma).
//     float32: bound by the FP32 operations of its two products, 4*n*C^2
//     (577 us at 262,144 x 192 at 67 TFLOP/s). C <= 384 runs
//     gdn_bwd_dx_kernel: both products run the whole-width loop of
//     csrc/gdn_f32.cuh (x^2, then dn, staged transposed once; gamma^T,
//     then gamma, in cp.async k-slices; 8-row x 4-channel register
//     tiles), and a thread owns the same tile in both, so norm, dn and
//     g*scale never leave its registers: dn goes to the f32 scratch and
//     over x^2, g*scale waits for the epilogue. x and g come to shared
//     memory by cp.async with the first slice (101 KB of shared memory at
//     C = 192). C = 192 and 128 run instances compiled for that width.
//     Wider C runs gdn_bwd_dx_f32_blocked_kernel: persistent CTAs take
//     128-row tiles and walk each one's 256-column blocks twice on the
//     blocked loop (x and gamma^T brought by the TMA, then dn, back from
//     the scratch, and gamma), g*scale waiting in dx between the passes.
//     bfloat16: bound by bytes. dn is rounded to bf16 once, for the bf16
//     scratch and for product 2, and the f32 dn's sum over each 64-row
//     tile goes to a (ceil(n / 64), C) f32 buffer of tile sums, in a fixed
//     order (the TPU kernel's per-tile dbeta). Both kernels are fed by the
//     TMA and multiply on wgmma (csrc/gdn_hopper.cuh). C = 128 and 192
//     with 16-byte aligned rows (the zoo's AMP training paths) run
//     gdn_bwd_dx_wide_kernel: persistent CTAs keep gamma in shared memory,
//     x and g arrive one tile ahead, both products run with the norm, dn
//     and g*scale in registers, and dn and dx leave by TMA. Every other
//     shape, any C, runs gdn_bwd_dx_stream_kernel: a producer
//     warp streams 64-column k-slices of x and gamma, then of dn (read
//     back from the scratch) and gamma, two warpgroups sum 128 rows x up
//     to 192 columns a block, and g*scale waits in a per-CTA f32
//     workspace between the products; C not a multiple of 8 and bases off
//     16 bytes run it on explicit, zero-padded copies.
//  2. gdn_bwd_partials: each 1024-row chunk's partial sums of dgamma and
//     dbeta.
//     float32 (gdn_bwd_partials_kernel): one CTA per (chunk, 64x64 block of
//     dgamma); the CTAs of the first column block also sum dbeta from the
//     f32 dn. Bound by the FP32 operations of
//     dn^T . x^2, 2*n*C^2 (288 us at 262,144 x 192 at 67 TFLOP/s). 4 warps,
//     an 8 x 4 register tile a thread; 32-row slices of dn and x stream
//     through a ring of three with cp.async, x squared in place; C = 192
//     and 128 run instances compiled for that width.
//     bfloat16 (gdn_bwd_partials_wide_kernel): bound by the bytes of the
//     bf16 dn and x, each read once: a CTA (or a cluster of them) takes
//     whole-width 64-row slices of its chunk through a TMA-filled ring and
//     keeps the whole 192 x 192 block of dgamma in registers (wgmma, x
//     squared in shared memory); dbeta is the in-order sum of the chunk's
//     16 tile sums.
//  3. gdn_bwd_reduce: bound by the bytes of the partials. A thread sums 4
//     neighbouring elements over the chunks in chunk order, copying them
//     itself with cp.async through a ring in shared memory (64 chunks in
//     flight), and casts to the output type.
// The number of partials is ceil(n / 1024): it depends on n, never on the
// card. Ragged row counts are masked: rows past n are staged as zeros, so
// they add exact zeros to dbeta/dgamma (what the JAX zero-padding relies
// on), and are never stored.
//
// Precision follows _bwd_kernel: x^2 is rounded to the input type; the
// products accumulate in f32; dn is rounded to the input type before both
// the dn . gamma and the dn^T . x^2 products (in bf16 that rounded dn is
// all the scratch keeps), while dbeta sums the f32 dn;
// dx is rounded once at the store, dbeta/dgamma once after the final sum.

#include <cooperative_groups.h>
#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>

#include "gdn_f32.cuh"
#include "gdn_hopper.cuh"

namespace {

// The kernels of this library, in the order lmic_gdn_bwd_kernel_name gives
// them, and each one's launches so far, counted where its launch succeeded
// and nowhere else: a caller reads them around a run to see which kernel
// each launch took (a torch.profiler session can lose records).
enum Kernel {
  kDxF32, kPartialsF32, kDxStream, kDxWide, kPartialsWide, kReduce,
  kDxF32Blocked, kKernels
};
constexpr const char *kKernelNames[kKernels] = {
    "gdn_bwd_dx_kernel",         "gdn_bwd_partials_kernel",
    "gdn_bwd_dx_stream_kernel",  "gdn_bwd_dx_wide_kernel",
    "gdn_bwd_partials_wide_kernel",
    "gdn_bwd_reduce_kernel",     "gdn_bwd_dx_f32_blocked_kernel"};
std::atomic<int64_t> launches[kKernels];

// cudaGetLastError() after a launch of `kernel`, which counts it if 0
cudaError_t counted(Kernel kernel) {
  const cudaError_t err = cudaGetLastError();
  if (err == cudaSuccess) launches[kernel].fetch_add(1);
  return err;
}

constexpr int kChunkRows = 1024;  // rows per partial dbeta/dgamma
constexpr int kTile = 64;         // dgamma block: 64 x 64 per CTA

// the output type of the reduce
template <typename T>
struct Io;

template <>
struct Io<float> {
  static __device__ __forceinline__ float store(float v) { return v; }
};

template <>
struct Io<__nv_bfloat16> {
  static __device__ __forceinline__ __nv_bfloat16 store(float v) {
    return __float2bfloat16(v);
  }
};

namespace f32 = gdn_f32;
namespace hop = gdn_hopper;

// The f32 dx pass: bound by the FP32 operations of its two products. Both
// are the shared main loop (gdn_f32::product: 8 x 4 register tiles fed by
// 16-byte shared loads, the weight in cp.async k-slices), and a thread owns
// the same (rows, channels) tile in both: after product 1 it forms norm,
// dn and g*scale for its tile in registers, writes dn to the f32 scratch,
// stages it over x^2 for product 2 and keeps g*scale for the epilogue.
// The CTA's rows of x and g are copied to shared memory with cp.async at
// the start, so that neither the elementwise pass nor the epilogue waits
// on device memory.
// kWidth > 0 compiles it for C = kWidth; kWidth = 0 takes any C.
template <bool kInverse, int kWidth>
__global__ void __launch_bounds__(f32::kMaxThreads)
    gdn_bwd_dx_kernel(const float *__restrict__ x, const float *__restrict__ g,
                      const float *__restrict__ gamma_t,
                      const float *__restrict__ gamma,
                      const float *__restrict__ beta, float *__restrict__ dx,
                      float *__restrict__ dn, int64_t n, int channels,
                      bool vec) {
  const int C = kWidth ? kWidth : channels;
  extern __shared__ float4 smem4[];
  const f32::Shape s = f32::shape_of(C);
  float *at = reinterpret_cast<float *>(smem4);  // [Cp][lda]: x^2, then dn
  float *wbuf = at + s.Cp * s.lda;  // k-slices of gamma^T, then gamma
  float *xs = wbuf + 2 * f32::kSlice * s.Cp;  // [rows][Cp]: x
  float *gsm = xs + s.rows * s.Cp;             // [rows][Cp]: g

  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * s.rows;
  const int valid = static_cast<int>(
      n - row0 < s.rows ? n - row0 : static_cast<int64_t>(s.rows));
  // x, g and gamma^T's first slice land while x^2 stages; product 1 waits
  // for all of them before its first slice
  f32::issue_rows(xs, x, row0, s.rows, valid, C, s, vec);
  f32::issue_rows(gsm, g, row0, s.rows, valid, C, s, vec);
  f32::issue_slice(wbuf, gamma_t, 0, C, s, vec);
  f32::stage_squares(at, x, row0, valid, C, s, vec);
  int r0, c0;
  f32::tile_of(s, &r0, &c0);
  constexpr int kR = f32::kTileRows, kC = f32::kTileCols;

  // product 1: the norm's sums, as the forward kernel sums them
  float acc[kR][kC];
  f32::product(acc, at, wbuf, gamma_t, C, s, r0, c0, vec);
  __syncthreads();  // every warp is done with x^2 and gamma^T
  f32::issue_slice(wbuf, gamma, 0, C, s, vec);  // lands while dn is formed

  // elementwise, in registers: dn (over acc) and g * scale from the
  // staged x and g; zeros past row n and channel C
  float bo[kC], gs[kR][kC];
#pragma unroll
  for (int q = 0; q < kC; ++q) bo[q] = c0 + q < C ? beta[c0 + q] : 0.f;
#pragma unroll
  for (int k = 0; k < kR; ++k) {
    const float4 x4 =
        *reinterpret_cast<const float4 *>(xs + (r0 + k) * s.Cp + c0);
    const float4 g4 =
        *reinterpret_cast<const float4 *>(gsm + (r0 + k) * s.Cp + c0);
    const float xv[kC] = {x4.x, x4.y, x4.z, x4.w};
    const float gv[kC] = {g4.x, g4.y, g4.z, g4.w};
#pragma unroll
    for (int q = 0; q < kC; ++q) {
      float d = 0.f, sg = 0.f;
      if (r0 + k < valid && c0 + q < C) {
        const float norm = acc[k][q] + bo[q];
        const float rs = rsqrtf(norm);
        if (kInverse) {
          d = 0.5f * gv[q] * xv[q] * rs;
          sg = gv[q] * sqrtf(norm);
        } else {
          d = -0.5f * gv[q] * xv[q] * (rs * rs * rs);
          sg = gv[q] * rs;
        }
      }
      acc[k][q] = d;
      gs[k][q] = sg;
    }
  }
  f32::store_rows(dn, acc, row0 + r0, valid - r0, c0, C, vec);  // f32 dn
  // dn rounded to the input type (f32: as it is) over x^2, transposed
#pragma unroll
  for (int q = 0; q < kC; ++q) {
    float *to = at + (c0 + q) * s.lda + r0;
    *reinterpret_cast<float4 *>(to) =
        make_float4(acc[0][q], acc[1][q], acc[2][q], acc[3][q]);
    *reinterpret_cast<float4 *>(to + 4) =
        make_float4(acc[4][q], acc[5][q], acc[6][q], acc[7][q]);
  }

  // product 2 and the epilogue: dx = g * scale + 2 x (dn . gamma)
  f32::product(acc, at, wbuf, gamma, C, s, r0, c0, vec);
  if (c0 >= C) return;
#pragma unroll
  for (int k = 0; k < kR; ++k) {
    const float4 x4 =
        *reinterpret_cast<const float4 *>(xs + (r0 + k) * s.Cp + c0);
    const float xv[kC] = {x4.x, x4.y, x4.z, x4.w};
#pragma unroll
    for (int q = 0; q < kC; ++q)
      acc[k][q] = gs[k][q] + 2.0f * xv[q] * acc[k][q];
  }
  f32::store_rows(dx, acc, row0 + r0, valid - r0, c0, C, vec);
}

// The f32 dx pass past 384 channels: the dx part of
// lmic_tpu/ops/pallas_gdn.py::_bwd_kernel at every C wider than one CTA's
// warp grid covers (the TPU kernel keeps the whole (C, C) gamma and
// blocks over rows alone). Bound by the FP32 operations of its two
// products like gdn_bwd_dx_kernel (4.13 ms at 262,144 x 512 at 67
// TFLOP/s). Product 2 (dn . gamma) needs dn at every column before any
// column of dx, so a CTA owns a 128-row tile and walks its 256-column
// blocks twice, each block on the blocked loop of csrc/gdn_f32.cuh (8 x
// 16 register tiles, both operands fed by TMA in 32-deep k-slices through
// a ring of four stages, as gdn_fwd_f32_blocked_kernel):
//  - pass 1, block by block: product 1 (x^2 . gamma^T, x squared in the
//    stage, the sums gdn_fwd_f32_blocked_kernel forms), then norm, dn
//    and g*scale in registers from x and g read from L2: dn to the f32
//    scratch the partials read anyway, g*scale into dx;
//  - every thread then fences its dn stores for the async proxy, and
//    after a barrier of the CTA thread 0 issues the tile's first TMA reads
//    of dn (the stages' gamma went ahead: a refill of a pass-2 slice
//    before this point loads gamma alone);
//  - pass 2, block by block: product 2 (dn . gamma) streams the tile's dn
//    back from the scratch (L2), and the epilogue adds 2x (dn . gamma) to
//    the g*scale this thread wrote into dx, as gdn_bwd_dx_kernel writes it.
// Persistent clusters of K CTAs, as many as fit the card and no more than
// there are row tiles, walk tiles c, c + clusters, ..., the CTA of rank r
// summing column blocks r, r + K, ... of each in both passes (K, up to 8,
// evens out the waves of tiles over the card: 1 at 262,144 x 512, 2 at
// 24,576 x 512, 8 at 129 x 2048); a cluster barrier separates the passes.
// The next tile's first stages fill while the last one's epilogue runs. A
// thread holds the same positions in both passes, so dx's g*scale is read
// back by the thread that wrote it. Sums in a fixed order, no atomics:
// the same bytes on every run and as the earlier loop gave. x and dn are
// (n, width),
// gamma^T and gamma (width, width), width % 4 == 0 and 16-byte aligned
// bases (the TMA reads them); other shapes run on zero-padded copies of
// them (launch_dx_blocked). g and dx are (n, C) as they are, read and
// written a quad at a time where their rows are 16-byte aligned (kVecO),
// else a value at a time; the instances are those the route below can
// reach: DxBlocked with kVecO only.
// Where C's last 256-column block would be half empty (narrow_blocks), or
// g's and dx's rows are not 16-byte aligned (their accesses a value at a
// time cost the 8 x 16 tiles ~70 us more at 16,391 x 385 on an NVIDIA
// H100 80GB HBM3: chip_probes.py gdn-f32-blocked), 128 x 128 tiles of 8 x
// 8 (DxBlockedNarrow) take its place.
using DxBlocked = f32::blocked::Config<4, 2, 16>;
using DxBlockedNarrow = f32::blocked::Config<4, 2, 8>;

template <bool kInverse, class Cfg, bool kVecO>
__global__ void __launch_bounds__(Cfg::kThreads, Cfg::kCtasPerSm)
    gdn_bwd_dx_f32_blocked_kernel(
        const __grid_constant__ CUtensorMap x_map,
        const __grid_constant__ CUtensorMap gamma_t_map,
        const __grid_constant__ CUtensorMap dn_map,
        const __grid_constant__ CUtensorMap gamma_map,
        const float *__restrict__ x, const float *__restrict__ g,
        const float *__restrict__ beta, float *dx, float *dn, int n, int C,
        int width) {
  namespace blk = f32::blocked;
  constexpr int kTC = Cfg::kTC;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __shared__ uint64_t full[Cfg::kStages], empty[Cfg::kStages];
  const blk::Ring<Cfg> ring = blk::make_ring<Cfg>(smem_raw, full, empty);
  __syncthreads();

  const int blocks = (width + Cfg::kCols - 1) / Cfg::kCols;
  const int tiles = (n + Cfg::kRows - 1) / Cfg::kRows;
  const int slices = blk::slices_of(width);
  // a cluster of K CTAs takes tiles c, c + clusters, ...; its CTA of rank
  // r sums column blocks r, r + K, ... of each in both passes
  const int K = blk::cluster_size(), rank = blk::cluster_rank();
  const int cluster = blockIdx.x / K, clusters = gridDim.x / K;
  const int mine = (blocks - rank + K - 1) / K;  // this CTA's blocks
  const int per_pass = mine * slices;  // slices a pass of a tile
  // thread 0's state: slices refilled so far, and this CTA's tiles whose
  // dn is in the scratch (dn's boxes of a later tile wait for it)
  int refilled = 0, dn_tiles = 0;
  // the dn box of slice j, a pass-2 slice of this CTA's tile j / (2
  // per_pass), whose stage is claimed
  auto load_dn = [&](int j) {
    const int t = cluster + j / (2 * per_pass) * clusters;
    ring.load_a(j % Cfg::kStages, dn_map, t * Cfg::kRows, j % slices);
  };
  // slice j: k-slice j % slices of this CTA's column block (j / slices)
  // % mine of pass 1 (x^2 . gamma^T) or 2 (dn . gamma) of its tile
  // j / (2 per_pass)
  auto refill = [&](int j) {
    const int i = j / (2 * per_pass), r = j % (2 * per_pass);
    const int t = cluster + i * clusters;
    if (t >= tiles) return;
    const int s = ring.claim(j);
    const int col0 = (rank + r / slices % mine * K) * Cfg::kCols;
    refilled = j + 1;
    if (r < per_pass) {
      ring.load_a(s, x_map, t * Cfg::kRows, j % slices);
      ring.load_w(s, gamma_t_map, col0, j % slices);
    } else {
      ring.load_w(s, gamma_map, col0, j % slices);
      if (i < dn_tiles) load_dn(j);
    }
  };
  if (threadIdx.x == 0)
    for (int j = 0; j < Cfg::kStages; ++j) refill(j);

  const blk::Lane me = blk::lane_of<Cfg>();
  float acc[blk::kRowsT][kTC];
  int it = 0;
  for (int t = cluster; t < tiles; t += clusters) {
    const int row0 = t * Cfg::kRows + me.row;
    // pass 1: the norm, dn and g * scale, a column block at a time
    for (int cb = rank; cb < blocks; cb += K) {
      blk::product<Cfg, true>(acc, ring, &it, slices, me, refill);
      const int col0 = cb * Cfg::kCols + blk::col_of<Cfg>();
      float bo[kTC];
#pragma unroll
      for (int h = 0; h < kTC / 4; ++h)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int c = col0 + 32 * h + q;
          bo[4 * h + q] = c < C ? beta[c] : 1.f;
        }
      // a row at a time: 4 values each of x, g, dn and g * scale a quad
#pragma unroll
      for (int k = 0; k < blk::kRowsT; ++k) {
        const int row = row0 + blk::kRowGap * k;
        if (row >= n) break;
        const int64_t at = static_cast<int64_t>(row) * width;
        const int64_t ao = static_cast<int64_t>(row) * C;
#pragma unroll
        for (int h = 0; h < kTC / 4; ++h) {
          const int c = col0 + 32 * h;
          if (c >= width) continue;
          const float4 x4 = __ldg(reinterpret_cast<const float4 *>(x + at + c));
          const float4 g4 = blk::load4(g + ao, c, C, kVecO);
          const float xv[4] = {x4.x, x4.y, x4.z, x4.w};
          const float gv[4] = {g4.x, g4.y, g4.z, g4.w};
          float d[4], gs[4];
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const float norm = acc[k][4 * h + q] + bo[4 * h + q];
            const float rs = rsqrtf(norm);
            if (kInverse) {
              d[q] = 0.5f * gv[q] * xv[q] * rs;
              // sqrtf's own Newton step, without its slow path's call
              // (norm >= beta > 0: the same bytes)
              gs[q] = gv[q] * hop::sqrt_from_rsqrt(norm, rs);
            } else {
              d[q] = -0.5f * gv[q] * xv[q] * (rs * rs * rs);
              gs[q] = gv[q] * rs;
            }
            if (c + q >= C) d[q] = 0.f;  // padding adds zeros in pass 2
          }
          *reinterpret_cast<float4 *>(dn + at + c) =
              make_float4(d[0], d[1], d[2], d[3]);
          blk::store4(dx + ao, c, C, gs, kVecO);
        }
      }
    }
    // the tile's dn, written by the generic proxy of the cluster's CTAs,
    // is read by the TMA next: the dn boxes of the pass-2 slices already
    // refilled go once every CTA of the cluster is done with pass 1
    hop::fence_proxy_async_global();
    blk::cluster_sync();
    if (threadIdx.x == 0) {
      hop::fence_proxy_async_global();
      const int first = dn_tiles * 2 * per_pass + per_pass;
      const int end = ++dn_tiles * 2 * per_pass;  // the tile's last + 1
      for (int j = first; j < refilled && j < end; ++j) load_dn(j);
    }

    // pass 2: dx = g * scale + 2 x (dn . gamma), a column block at a time
    for (int cb = rank; cb < blocks; cb += K) {
      blk::product<Cfg, false>(acc, ring, &it, slices, me, refill);
      const int col0 = cb * Cfg::kCols + blk::col_of<Cfg>();
#pragma unroll
      for (int k = 0; k < blk::kRowsT; ++k) {
        const int row = row0 + blk::kRowGap * k;
        if (row >= n) break;
        const int64_t at = static_cast<int64_t>(row) * width;
        const int64_t ao = static_cast<int64_t>(row) * C;
#pragma unroll
        for (int h = 0; h < kTC / 4; ++h) {
          const int c = col0 + 32 * h;
          if (c >= C) continue;
          const float4 x4 = __ldg(reinterpret_cast<const float4 *>(x + at + c));
          const float4 s4 = blk::load4(dx + ao, c, C, kVecO);
          const float xv[4] = {x4.x, x4.y, x4.z, x4.w};
          const float gs[4] = {s4.x, s4.y, s4.z, s4.w};
          float out[4];
#pragma unroll
          for (int q = 0; q < 4; ++q)
            out[q] = gs[q] + 2.0f * xv[q] * acc[k][4 * h + q];
          blk::store4(dx + ao, c, C, out, kVecO);
        }
      }
    }
  }
}

// The f32 partials: one CTA per (1024-row chunk, 64 x 64 block of dgamma),
// bound by the FP32 operations of dn^T . x^2 (2*n*C^2). Here the product's
// depth is the chunk's rows and both operands are row-major, so the block
// streams through shared memory in 32-row slices of dn and x ([32][64]
// each), copied with 16-byte cp.async into a ring of kStages slices: two
// slices are in flight while one is summed, one barrier per slice. Each
// thread squares the x it copied itself once its copy has landed. The 4
// warps each own a 32 x 32 quarter of the block, a thread an 8-row (o) x
// 4-column (i) register tile, and for a chunk row r its 8 dn and 4 x^2
// values are contiguous in the slice: two 16-byte shared loads of dn and
// one of x^2 per 32 FMAs, with no transpose. The sums keep the order the
// partials have always had, so their bytes never change: dgamma is one
// fmaf chain from 0.f per element over the chunk's rows in row order, x^2
// rounded before the fmaf, and the zero rows a ragged last slice stages
// come only after the last real row (fmaf(0, 0, acc) == acc: a chain from
// +0 is never -0). dbeta is four interleaved sums: sum h adds the f32 dn
// of rows r with (r - start) % 4 == h in row order from 0.f; a lane of the
// first column block keeps two of them for one column, read from the
// staged dn, and they are added as 0.f + s0 + s1 + s2 + s3.
// kWidth > 0 compiles it for C = kWidth; kWidth = 0 takes any C, with
// element copies when rows are not 16-byte aligned (vec false).
constexpr int kPartialsThreads = 128;
constexpr int kSliceRows = 32;  // rows of dn and x per staged slice
constexpr int kStages = 3;      // slices in the ring
constexpr int kSliceFloats = kSliceRows * kTile;  // one operand's slice

// waits until at most N of this thread's newest cp.async groups are pending
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Starts copying rows row0 .. row0+31 of dn (columns o0 ..) and x (columns
// i0 ..) into buf ([32][64] dn, then [32][64] x): zeros from row `live` on
// and past column C. Commits the copies as one group.
__device__ __forceinline__ void issue_partials_slice(
    float *buf, const float *__restrict__ dn, const float *__restrict__ x,
    int64_t row0, int live, int o0, int i0, int C, bool vec) {
  if (vec) {  // C % 4 == 0: a quad is all live or all padding
    for (int e = threadIdx.x; e < kSliceFloats / 4; e += kPartialsThreads) {
      const int r = e / (kTile / 4);
      const int c = (e % (kTile / 4)) * 4;
      const bool ld = r < live && o0 + c < C;
      const bool lx = r < live && i0 + c < C;
      f32::cp_async16(buf + r * kTile + c,
                      ld ? dn + (row0 + r) * C + o0 + c : dn, ld ? 16 : 0);
      f32::cp_async16(buf + kSliceFloats + r * kTile + c,
                      lx ? x + (row0 + r) * C + i0 + c : x, lx ? 16 : 0);
    }
  } else {
    for (int e = threadIdx.x; e < kSliceFloats; e += kPartialsThreads) {
      const int r = e / kTile;
      const int c = e % kTile;
      const bool ld = r < live && o0 + c < C;
      const bool lx = r < live && i0 + c < C;
      f32::cp_async4(buf + e, ld ? dn + (row0 + r) * C + o0 + c : dn,
                     ld ? 4 : 0);
      f32::cp_async4(buf + kSliceFloats + e,
                     lx ? x + (row0 + r) * C + i0 + c : x, lx ? 4 : 0);
    }
  }
  f32::cp_async_commit();
}

// x^2 over the x this thread copied into xs (the elements of
// issue_partials_slice's loop), once its copies have landed.
__device__ __forceinline__ void square_own(float *xs, bool vec) {
  if (vec) {
#pragma unroll
    for (int e = threadIdx.x; e < kSliceFloats / 4; e += kPartialsThreads) {
      float4 *p = reinterpret_cast<float4 *>(xs) + e;
      float4 v = *p;
      v.x = v.x * v.x, v.y = v.y * v.y, v.z = v.z * v.z, v.w = v.w * v.w;
      *p = v;
    }
  } else {
#pragma unroll 4
    for (int e = threadIdx.x; e < kSliceFloats; e += kPartialsThreads)
      xs[e] = xs[e] * xs[e];
  }
}

template <int kWidth>
__global__ void __launch_bounds__(kPartialsThreads, 4)
    gdn_bwd_partials_kernel(const float *__restrict__ x,
                            const float *__restrict__ dn,
                            float *__restrict__ partials, int64_t n,
                            int channels, bool vec) {
  const int C = kWidth ? kWidth : channels;
  extern __shared__ float4 smem4[];
  float *ring = reinterpret_cast<float *>(smem4);  // kStages x {dn, x}
  __shared__ float dbs[4][kTile];

  const int tiles = (C + kTile - 1) / kTile;
  const int o0 = (blockIdx.x / tiles) * kTile;
  const int i0 = (blockIdx.x % tiles) * kTile;
  const int64_t start = static_cast<int64_t>(blockIdx.y) * kChunkRows;
  const int valid = static_cast<int>(
      n - start < kChunkRows ? n - start : static_cast<int64_t>(kChunkRows));
  const int slices = (valid + kSliceRows - 1) / kSliceRows;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int wo = (warp / 2) * 32;         // the warp's 32 x 32 quarter
  const int ro = wo + (lane / 8) * 8;     // this thread's rows o0 + ro ..
  const int ci = (warp % 2) * 32 + (lane % 8) * 4;  // columns i0 + ci ..
  const int hb = (warp % 2) * 2;  // dbeta: sums hb, hb + 1 of column wo + lane
  const bool beta_block = i0 == 0;

  auto issue = [&](int k) {
    if (k < slices)
      issue_partials_slice(ring + (k % kStages) * 2 * kSliceFloats, dn, x,
                           start + k * kSliceRows, valid - k * kSliceRows, o0,
                           i0, C, vec);
    else
      f32::cp_async_commit();  // an empty group keeps the count
  };
  for (int k = 0; k < kStages - 1; ++k) issue(k);

  float acc[8][4];
#pragma unroll
  for (int p = 0; p < 8; ++p)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[p][q] = 0.f;
  float db0 = 0.f, db1 = 0.f;
  for (int k = 0; k < slices; ++k) {
    float *buf = ring + (k % kStages) * 2 * kSliceFloats;
    cp_async_wait<kStages - 2>();  // this thread's copies of slice k landed
    square_own(buf + kSliceFloats, vec);
    __syncthreads();  // slice k is whole; every warp is done with k - 1
    issue(k + kStages - 1);  // over slice k - 1
    const float *ds = buf + ro;
    const float *xs = buf + kSliceFloats + ci;
#pragma unroll
    for (int r = 0; r < kSliceRows; ++r) {
      const float4 a0 = *reinterpret_cast<const float4 *>(ds + r * kTile);
      const float4 a1 = *reinterpret_cast<const float4 *>(ds + r * kTile + 4);
      const float4 b = *reinterpret_cast<const float4 *>(xs + r * kTile);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int p = 0; p < 8; ++p)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[p][q] = fmaf(av[p], bv[q], acc[p][q]);
    }
    if (beta_block) {
      const float *dc = buf + wo + lane;
#pragma unroll
      for (int r = 0; r < kSliceRows; r += 4) {
        db0 += dc[(r + hb) * kTile];
        db1 += dc[(r + hb + 1) * kTile];
      }
    }
  }

  float *out = partials + static_cast<int64_t>(blockIdx.y) * (C * C + C);
  const int i = i0 + ci;
#pragma unroll
  for (int p = 0; p < 8; ++p) {
    const int o = o0 + ro + p;
    if (o >= C || i >= C) break;
    float *dst = out + o * C + i;
    if (vec) {  // C % 4 == 0: all 4 columns live
      *reinterpret_cast<float4 *>(dst) =
          make_float4(acc[p][0], acc[p][1], acc[p][2], acc[p][3]);
    } else {
#pragma unroll
      for (int q = 0; q < 4; ++q)
        if (i + q < C) dst[q] = acc[p][q];
    }
  }
  if (beta_block) {
    dbs[hb][wo + lane] = db0;
    dbs[hb + 1][wo + lane] = db1;
    __syncthreads();
    const int t = threadIdx.x;
    if (t < kTile && o0 + t < C) {
      float s = 0.f;
      for (int h = 0; h < 4; ++h) s += dbs[h][t];
      out[C * C + o0 + t] = s;
    }
  }
}

// The reduce: bound by the bytes of the partials (chunks x (C*C + C) f32,
// read once), with C*C + C elements to spread over the card and nothing to
// share between them, since each element's sum must run over the chunks in
// order: s = 0.f; s += partials[k] for k = 0 .. chunks-1, then one cast. A
// thread sums kVec neighbouring elements (16-byte copies when C % 4 == 0)
// and copies them itself, chunk after chunk, with cp.async into a ring of
// kReduceStages slices of kReduceChunks chunks in its CTA's shared memory:
// two slices are in flight while it adds the third, so each thread keeps
// up to 64 loads in flight without holding them in registers, and no
// thread reads what another copied, so there is no barrier. The launch
// sizes its CTAs (64 threads at C = 192, 32 at C = 128) to cover the SMs.
constexpr int kReduceChunks = 32;  // chunks per staged slice
constexpr int kReduceStages = 3;
constexpr int kReduceThreads = 64;  // at most; see launch_reduce

template <typename T, int kVec>
__global__ void __launch_bounds__(kReduceThreads)
    gdn_bwd_reduce_kernel(const float *__restrict__ partials,
                          T *__restrict__ dbeta, T *__restrict__ dgamma,
                          int64_t chunks, int C) {
  extern __shared__ float4 smem4[];
  const int64_t cc = static_cast<int64_t>(C) * C;
  const int64_t elems = cc + C;
  const int64_t e =
      (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) * kVec;
  if (e >= elems) return;
  // this thread's column of the ring: [kReduceStages][kReduceChunks]
  // slots of kVec floats, a slot's threads side by side
  float *col = reinterpret_cast<float *>(smem4) + threadIdx.x * kVec;
  const int stride = blockDim.x * kVec;  // floats from one chunk to the next
  const int64_t slices = (chunks + kReduceChunks - 1) / kReduceChunks;
  auto rows_of = [&](int64_t k) {
    const int64_t left = chunks - k * kReduceChunks;
    return static_cast<int>(left < kReduceChunks ? left : kReduceChunks);
  };
  auto issue = [&](int64_t k) {
    if (k < slices) {
      float *buf = col + (k % kReduceStages) * kReduceChunks * stride;
      const float *src = partials + k * kReduceChunks * elems + e;
      const int rows = rows_of(k);
#pragma unroll 8
      for (int r = 0; r < rows; ++r) {
        if constexpr (kVec == 4)
          f32::cp_async16(buf + r * stride, src + r * elems, 16);
        else
          f32::cp_async4(buf + r * stride, src + r * elems, 4);
      }
    }
    f32::cp_async_commit();  // an empty group past the end keeps the count
  };
  for (int k = 0; k < kReduceStages - 1; ++k) issue(k);
  float s[kVec];
#pragma unroll
  for (int j = 0; j < kVec; ++j) s[j] = 0.f;
  for (int64_t k = 0; k < slices; ++k) {
    cp_async_wait<kReduceStages - 2>();  // slice k has landed
    issue(k + kReduceStages - 1);  // over slice k - 1, which it has added
    const float *buf = col + (k % kReduceStages) * kReduceChunks * stride;
    const int rows = rows_of(k);
#pragma unroll 8
    for (int r = 0; r < rows; ++r) {
      if constexpr (kVec == 4) {
        const float4 v = *reinterpret_cast<const float4 *>(buf + r * stride);
        s[0] += v.x, s[1] += v.y, s[2] += v.z, s[3] += v.w;
      } else {
        s[0] += buf[r * stride];
      }
    }
  }
#pragma unroll
  for (int j = 0; j < kVec; ++j) {
    if (e + j < cc)
      dgamma[e + j] = Io<T>::store(s[j]);
    else if (e + j < elems)
      dbeta[e + j - cc] = Io<T>::store(s[j]);
  }
}

// The bf16 dx pass at the widths of the zoo's AMP training paths (C = 128
// and 192), for Hopper: the dx and per-tile dbeta part of
// lmic_tpu/ops/pallas_gdn.py::_bwd_kernel. It computes dx, the bf16 dn
// scratch and each 64-row tile's f32 sum of dn, and is bound by bytes:
// x and g read, dx and dn written
// (8 bytes a row-channel) against the 4*C bf16 tensor-core operations of
// its two products a row-channel, 96 operations a byte at C = 192, 3x
// below the H100's 295. So the design reads each byte once and keeps
// every intermediate on chip:
//  - persistent CTAs, one an SM, walk the tiles b, b + grid, ...; each
//    loads gamma once by TMA (72 KB at C = 192) and keeps it: box (rows o
//    64 rb.., columns 64 cb..) at (cb * boxes + rb) * 8 KB, so for a column
//    block cb the rows o lie 128 bytes apart across the boxes. Product 1
//    reads it K-major (B(k = j, n = o) = gamma[o][j]: row o's 64 values of
//    j in a box row), product 2 MN-major (B(k = o, n = i) = gamma[o][i]:
//    8-row atoms along o, one 64-column box along i), from the same bytes;
//  - a tile's x and g come as 64-row x 64-column boxes by TMA into a ring
//    of two stages, an mbarrier a stage, issued by thread 0 one tile ahead
//    (while the tile's first product runs); rows past n come in as zeros;
//  - one warpgroup per 64-column box of the output (3 at C = 192, 2 at
//    128): each runs both products for its columns on wgmma m64n64k16
//    (f32 sums in 32 registers a thread), so a thread holds the same
//    (row, column) positions in both and g*scale waits in its registers
//    for the epilogue. The 64-wide split keeps product 2's MN-major B on
//    whole swizzle atoms (a 96-wide half would start mid-atom) and needs
//    no setmaxnreg: 64 f32 of state a thread fit 168 registers;
//  - product 1's A is x^2, squared by all threads from the x stage into a
//    tile of its own (same layout); product 2's A is the bf16 dn tile the
//    elementwise pass writes from the accumulators, which the TMA also
//    stores to the scratch. x and g are read at the fragments' (row,
//    column) from the swizzled stage (conflict-free: a warp's 8 rows read
//    8 different 16-byte units of their rows), so the norm never leaves the
//    registers; dx is written over x in the stage (each element read and
//    written by one thread) and stored by TMA from there;
//  - each column's tile sum of the f32 dn: a thread's two rows, then a
//    shuffle butterfly over the 8 lanes that share the column, then the
//    warpgroup's 4 warps in order through shared memory. One CTA computes
//    a tile from its own rows alone, so no byte depends on the grid or the
//    card; there are no atomics.
// The norm sums its bf16 products in wgmma's order, k = 0..C-1 in steps
// of 16, as gdn_fwd_wide_kernel sums the forward's. 225 KB of
// shared memory at C = 192: gamma 72 KB, two stages of x and g 96 KB, x^2
// 24 KB, dn 24 KB, the warps' sums 3 KB.
constexpr int kDxStages = 2;  // this tile's x and g, and the next one's

template <int kWidth>
struct DxWide {
  static constexpr int kBoxes = kWidth / 64;  // and warpgroups
  static constexpr int kThreads = kBoxes * 128;
  static constexpr int kTileBytes = kBoxes * hop::kBox;  // 64 x C bf16
  static constexpr int kGamma = kWidth * kWidth * 2;
  // gamma, the ring, x^2, dn, the warps' sums, and room to align to 1 KB
  static constexpr size_t kSmem = kGamma +
                                  (2 * kDxStages + 2) * kTileBytes +
                                  kBoxes * 4 * 64 * sizeof(float) + 1024;
  static_assert(kWidth % 64 == 0, "whole boxes");
  static_assert(kSmem <= hop::kSmemLimit, "fits a CTA");
  static_assert(kThreads >= kWidth, "a thread a tile sum");
};

template <bool kInverse, int kWidth>
__global__ void __launch_bounds__(DxWide<kWidth>::kThreads, 1)
    gdn_bwd_dx_wide_kernel(const __grid_constant__ CUtensorMap x_map,
                           const __grid_constant__ CUtensorMap g_map,
                           const __grid_constant__ CUtensorMap gamma_map,
                           const __grid_constant__ CUtensorMap dx_map,
                           const __grid_constant__ CUtensorMap dn_map,
                           const __nv_bfloat16 *__restrict__ beta,
                           float *__restrict__ dn_sums, int64_t n) {
  using W = DxWide<kWidth>;
  constexpr int C = kWidth;
  constexpr int kBox = hop::kBox;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char *gam =
      smem_raw + (1024 - hop::smem_at(smem_raw) % 1024) % 1024;
  unsigned char *ring = gam + W::kGamma;  // kDxStages x {x, g}
  unsigned char *x2 = ring + 2 * kDxStages * W::kTileBytes;
  unsigned char *dns = x2 + W::kTileBytes;
  float *wsum = reinterpret_cast<float *>(dns + W::kTileBytes);  // [warp][64]
  __shared__ uint64_t landed[kDxStages];  // a stage's x and g are in
  __shared__ uint64_t gamma_landed;

  const int64_t tiles = (n + 63) / 64;
  // this CTA's tiles: blockIdx.x + j * gridDim.x for j < mine
  const int64_t mine = (tiles - blockIdx.x + gridDim.x - 1) / gridDim.x;
  auto stage = [&](int64_t j) {
    return ring + (j % kDxStages) * 2 * W::kTileBytes;
  };
  auto issue = [&](int64_t j) {  // thread 0
    if (j >= mine) return;
    const int row0 = static_cast<int>((blockIdx.x + j * gridDim.x) * 64);
    uint64_t *bar = landed + j % kDxStages;
    unsigned char *s = stage(j);
    hop::mbar_expect(bar, 2 * W::kTileBytes);
#pragma unroll
    for (int b = 0; b < W::kBoxes; ++b) {
      hop::tma_box(s + b * kBox, x_map, 64 * b, row0, bar);
      hop::tma_box(s + W::kTileBytes + b * kBox, g_map, 64 * b, row0, bar);
    }
  };
  if (threadIdx.x == 0) {
    for (int k = 0; k < kDxStages; ++k) hop::mbar_init(landed + k);
    hop::mbar_init(&gamma_landed);
    hop::fence_mbar_init();
    hop::mbar_expect(&gamma_landed, W::kGamma);
    for (int cb = 0; cb < W::kBoxes; ++cb)
      for (int rb = 0; rb < W::kBoxes; ++rb)
        hop::tma_box(gam + (cb * W::kBoxes + rb) * kBox, gamma_map, 64 * cb,
                     64 * rb, &gamma_landed);
    issue(0);
  }

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int wg = warp / 4;  // this warpgroup's output columns 64 wg ..
  // accumulator 4 t + 2 h + e: row r0 + 8 h, column 64 wg + 8 t + cl + e
  const int r0 = 16 * (warp % 4) + lane / 4;
  const int cl = 2 * (lane % 4);
  // the byte offset in a tile of its pair (t, h), e = 0 and 1: rows r0 and
  // r0 + 8 are both lane / 4 modulo 8
  auto at = [&](int t, int h) {
    return wg * kBox + (r0 + 8 * h) * 128 + ((t ^ (lane / 4)) * 16) + cl * 2;
  };
  float bv[16];
#pragma unroll
  for (int t = 0; t < 8; ++t)
#pragma unroll
    for (int e = 0; e < 2; ++e)
      bv[2 * t + e] = __bfloat162float(beta[64 * wg + 8 * t + cl + e]);
  // product 1's B: gamma's rows 64 wg .. in column block kb at kb * kBoxes;
  // product 2's B: gamma's columns 64 wg .., rows o at o * 128
  const unsigned char *b1 = gam + wg * kBox;
  const unsigned char *b2 = gam + wg * W::kBoxes * kBox;
  __syncthreads();  // the barriers are initialised
  hop::mbar_wait(&gamma_landed, 0);

  for (int64_t j = 0; j < mine; ++j) {
    const int64_t tile = blockIdx.x + j * gridDim.x;
    const int row0 = static_cast<int>(tile * 64);
    const int valid = n - row0 < 64 ? static_cast<int>(n - row0) : 64;
    unsigned char *xt = stage(j);
    const unsigned char *gt = xt + W::kTileBytes;
    hop::mbar_wait(landed + j % kDxStages, (j / kDxStages) & 1);
    // x^2 in the layout of x, an even share a thread
    for (int e = threadIdx.x; e < W::kTileBytes / 16; e += W::kThreads) {
      uint4 v = reinterpret_cast<const uint4 *>(xt)[e];
      v.x = hop::square2(v.x), v.y = hop::square2(v.y),
      v.z = hop::square2(v.z), v.w = hop::square2(v.w);
      reinterpret_cast<uint4 *>(x2)[e] = v;
    }
    hop::fence_proxy_async();
    __syncthreads();  // x^2 is whole; every thread is done with tile j - 1

    // product 1: the norm's sums, k = j over C in steps of 16
    float acc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = 0.f;
    hop::wgmma_fence();
#pragma unroll
    for (int s = 0; s < C / 16; ++s) {
      const int kb = s / 4, ko = (s % 4) * 32;
      hop::wgmma_m64n64k16<0>(
          acc, hop::desc_k(x2 + kb * kBox + ko),
          hop::desc_k(b1 + kb * W::kBoxes * kBox + ko));
    }
    hop::wgmma_commit();
    hop::fence_operands(acc);
    // while it runs: tile j - 1's stores have read the stage that tile
    // j + 1 takes
    if (threadIdx.x == 0) {
      hop::bulk_wait_read<0>();
      issue(j + 1);
    }
    hop::wgmma_wait<0>();
    hop::fence_operands(acc);

    // elementwise: dn over acc, g * scale kept; dn rounded once to bf16
    // into the dn tile; rows past n give zeros
    float gs[32];
#pragma unroll
    for (int t = 0; t < 8; ++t)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int off = at(t, h);
        const unsigned xw = *reinterpret_cast<const unsigned *>(xt + off);
        const unsigned gw = *reinterpret_cast<const unsigned *>(gt + off);
        const bool live = r0 + 8 * h < valid;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          // bf16 -> f32 is exact: the bits shifted into the high half
          const float xv = __uint_as_float(e ? xw & 0xffff0000u : xw << 16);
          const float gv = __uint_as_float(e ? gw & 0xffff0000u : gw << 16);
          const int i = 4 * t + 2 * h + e;
          const float norm = acc[i] + bv[2 * t + e];
          const float rs = rsqrtf(norm);
          float d, sg;
          if (kInverse) {
            d = 0.5f * gv * xv * rs;
            sg = gv * sqrtf(norm);
          } else {
            d = -0.5f * gv * xv * (rs * rs * rs);
            sg = gv * rs;
          }
          acc[i] = live ? d : 0.f;
          gs[i] = live ? sg : 0.f;
        }
        *reinterpret_cast<unsigned *>(dns + off) =
            hop::pack2(acc[4 * t + 2 * h], acc[4 * t + 2 * h + 1]);
      }
    // each column's sum of the f32 dn over the tile: the thread's two
    // rows, the 8 lanes of the column (all get the same bits), the warps
#pragma unroll
    for (int t = 0; t < 8; ++t)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float s = acc[4 * t + e] + acc[4 * t + 2 + e];
        s += __shfl_xor_sync(0xffffffffu, s, 4);
        s += __shfl_xor_sync(0xffffffffu, s, 8);
        s += __shfl_xor_sync(0xffffffffu, s, 16);
        if (lane < 4) wsum[warp * 64 + 8 * t + cl + e] = s;
      }
    hop::fence_proxy_async();
    __syncthreads();  // the dn tile and the warps' sums are whole
    if (threadIdx.x == 0) {
#pragma unroll
      for (int b = 0; b < W::kBoxes; ++b)
        hop::tma_store(dn_map, dns + b * kBox, 64 * b, row0);
      hop::bulk_commit();
    }
    if (threadIdx.x < C) {
      const int c = threadIdx.x;
      const float *w = wsum + (c / 64) * 4 * 64 + c % 64;
      float s = 0.f;
#pragma unroll
      for (int q = 0; q < 4; ++q) s += w[q * 64];
      dn_sums[tile * C + c] = s;
    }

    // product 2: dn . gamma, k = o over C in steps of 16
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = 0.f;
    hop::wgmma_fence();
#pragma unroll
    for (int s = 0; s < C / 16; ++s)
      hop::wgmma_m64n64k16<1>(
          acc, hop::desc_k(dns + (s / 4) * kBox + (s % 4) * 32),
          hop::desc_mn(b2 + s * 2 * hop::kAtom, W::kBoxes * kBox));
    hop::wgmma_commit();
    hop::wgmma_wait<0>();
    hop::fence_operands(acc);

    // dx = g * scale + 2 x (dn . gamma), rounded once, over x in the stage
#pragma unroll
    for (int t = 0; t < 8; ++t)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int off = at(t, h);
        unsigned *p = reinterpret_cast<unsigned *>(xt + off);
        const unsigned xw = *p;
        const int i = 4 * t + 2 * h;
        *p = hop::pack2(
            gs[i] + 2.0f * __uint_as_float(xw << 16) * acc[i],
            gs[i + 1] + 2.0f * __uint_as_float(xw & 0xffff0000u) * acc[i + 1]);
      }
    // the dn store has read the dn tile, which tile j + 1 writes
    if (threadIdx.x == 0) hop::bulk_wait_read<0>();
    hop::fence_proxy_async();
    __syncthreads();  // dx is whole in the stage
    if (threadIdx.x == 0) {
#pragma unroll
      for (int b = 0; b < W::kBoxes; ++b)
        hop::tma_store(dx_map, xt + b * kBox, 64 * b, row0);
      hop::bulk_commit();
    }
  }
  if (threadIdx.x == 0) hop::bulk_wait<0>();  // the stores are done
}

// The bf16 dx pass at every shape gdn_bwd_dx_wide_kernel does not take
// (other widths, any C; bases off 16 bytes): the dx
// and per-tile dbeta part of lmic_tpu/ops/pallas_gdn.py::_bwd_kernel where
// gamma does not fit beside the tiles. It computes what the wide kernel
// computes (dx, the bf16 dn scratch, each 64-row tile's f32 sum of dn)
// with the same precision. Its two products are (n x C) . (C x C) matrix
// products, 4*n*C^2 operations against 8*n*C bytes of x, g, dx and dn, so
// up to C of a few hundred it is bound by bytes (200 us at 262,144 x 320
// at 3.35 TB/s) and past that by the tensor cores. gamma (200 KB at
// C = 320, 2 MB at 1024) does not stay in shared memory: it streams, as in
// gdn_fwd_stream_kernel, whose pieces this kernel is built from.
//  - A CTA takes a tile of kDsRows = 128 rows, a consumer warpgroup of 64
//    rows each (so each warpgroup owns one 64-row tile of dn's sums), in
//    two passes over the column blocks of its output (C's 64-column boxes
//    split as evenly as can be into blocks of at most three,
//    hop::column_block). Persistent CTAs, no more than the card's SMs, walk
//    the row tiles b, b + grid, ...; each output element is summed by one
//    CTA in one order, so every launch gives the same bytes, whatever the
//    grid.
//  - A producer warpgroup keeps the TMA loads ahead of the sums in a ring
//    of kDsStages stages under a "landed" and a "free" mbarrier each; one
//    thread issues every box, and the warpgroup hands its registers to the
//    consumers (setmaxnreg). Pass 1 streams 64-column k-slices of x (the
//    tile's two 64-row boxes) and of gamma's rows o of the block, K-major;
//    pass 2 k-slices of the tile's bf16 dn, read back from the scratch, and
//    of gamma's columns i of the block, MN-major (a box row o holds 64
//    values of i). Rows past n and columns past C come in as zeros and add
//    exact zeros.
//  - Pass 1, the norm, a block at a time: wgmma m64nNk16 over k = 0..C-1
//    in order, A = x^2 from registers (each warp loads its 16 rows of the
//    slice by ldmatrix and squares them: x * x rounded once to bf16), B
//    gamma's rows from the stage. wgmma reads A's registers until the
//    product completes, so a stage is freed once its product is waited
//    for. In the k-slices of the block's own columns each thread keeps the
//    raw x at the positions its sums hold in its warpgroup's x tile, as
//    gdn_fwd_stream_kernel does, and the warpgroup's first thread loads
//    the block's g by TMA into its g tile. The elementwise pass on the
//    accumulators: norm = sums + beta (the block's beta in a 192-float
//    stage of the warpgroup's own, hop::BlockBeta, so no shared memory
//    grows with C), dn and g*scale in f32; dn rounded
//    once to bf16 over g in the g tile and stored by TMA to the scratch;
//    the f32 dn's sum over the warpgroup's 64 rows (a thread's two rows, a
//    shuffle over the 8 lanes of a column, the 4 warps in order through
//    shared memory) to the tile sums; g*scale, which must wait until pass
//    2 reaches the block, to a per-CTA f32 workspace in device memory
//    (kDsRows x 64*boxes floats, 160 KB a CTA at C = 320, which stays in
//    L2; 1 MB at C = 2048, which does not), written and read back by the same thread in 16-byte accesses, a
//    warp's 512 contiguous bytes.
//  - Once both warpgroups' dn stores of the tile have completed (each
//    first thread waits for its bulk groups, fences the async proxy and
//    arrives on an mbarrier), the producer streams dn back (the tile's 80
//    KB at C = 320 is still in L2).
//  - Pass 2, dn . gamma, a block at a time: wgmma with both operands in
//    shared memory (A dn K-major, B gamma's columns MN-major) over
//    k = o = 0..C-1 in order. The warpgroup's first thread loads the
//    block's x by TMA into the x tile, and each thread's loads of its
//    g*scale from the workspace run beside the products (96 registers at
//    three boxes, beside the 96 of the sums); the epilogue takes x from
//    the tile, forms
//    dx = g*scale + 2 x (dn . gamma) in f32, rounds it once to bf16 over x
//    and the first thread stores it by TMA (nothing past n or C written).
//  - HBM: x and g are read, dx and dn written once; the rest comes from
//    L2: x once more per column block, dn once per column block, gamma
//    twice per row tile, the workspace once each way.
//  - The ring's depth and the workspace's place in the pass are timed
//    against this design by chip_probes.py gdn-dx-stream; PERF.md keeps the
//    times of the other design, the norm's product recomputed for each
//    block in pass 2 instead of the workspace.
// The IGDN's sqrt(norm) is one Newton step from norm * rsqrtf(norm)
// (hop::sqrt_from_rsqrt), as the forward kernels take it.
// It follows the TPU kernel's bf16 casts: x^2 rounded to bf16, gamma in
// bf16, f32 sums, beta added in f32, dn rounded to bf16 for the product
// (dbeta's tile sums add the f32 dn), dx rounded once.
//
// The TMA needs 16-byte aligned bases and rows (C % 8 == 0). Other shapes
// run the same kernel on explicit copies in the scratch the caller
// allocates (lmic_gdn_bwd_dx_scratch_bytes, which also holds the
// workspace): x, g and gamma copied into rows of round8(C) elements with
// zeros past C, which add exact zeros, and dx and dn copied back from
// such rows; beta and the tile sums are read and written by plain accesses
// (beta 1 past C).
constexpr int kDsRows = 128;  // rows a tile: two warpgroups of 64
constexpr int kDsMaxBoxes = hop::kBlockBoxes;
constexpr int kDsStages = 3;
constexpr int kDsConsumers = 256;
// + a producer warpgroup, of which one thread issues the loads: its
// registers go to the consumers (setmaxnreg), whose sums and g*scale take
// up to 192 a thread. The launch holds 168 a thread (65,536 / 384, in
// steps of 8), and an increase waits until the pool has the registers:
// 128 x 40 + 256 x 232 = 384 x 168
constexpr int kDsThreads = kDsConsumers + 128;
constexpr int kDsProducerRegs = 40, kDsConsumerRegs = 232;
static_assert(128 * kDsProducerRegs + kDsConsumers * kDsConsumerRegs <=
                  kDsThreads * (65536 / kDsThreads / 8 * 8),
              "setmaxnreg takes no more registers than the launch holds");
// a stage: 2 boxes of x or dn, up to 3 of gamma; the x and the g tiles:
// each warpgroup's 64 rows of up to 3 boxes
constexpr int kDsStage = (2 + kDsMaxBoxes) * hop::kBox;
constexpr int kDsTile = 2 * kDsMaxBoxes * hop::kBox;
// room to align to 1 KB, the ring, the x and g tiles, beta
// beta of a column block, for each consumer warpgroup
constexpr int kDsBeta = 64 * kDsMaxBoxes;
constexpr size_t kDsSmem = 1024 + kDsStages * kDsStage + 2 * kDsTile +
                           2 * kDsBeta * 4;
static_assert(kDsSmem <= hop::kSmemLimit, "fits a CTA");
static_assert(kDsRows == 2 * hop::kTileRows,
              "a warpgroup's rows are one tile of dn's sums");
// rows a launch takes: TMA row coordinates are ints
constexpr int64_t kDsLaunchRows = (int64_t{1} << 31) - kDsRows;

// The workspace floats of a CTA: g*scale of a row tile at every column.
__host__ __device__ inline int64_t ds_work_floats(int C) {
  return static_cast<int64_t>(kDsRows) * 64 * ((C + 63) / 64);
}

// Pass 1's k-loop for one column block of kB boxes, for this consumer
// thread: the norm's sums into acc over the stages from `*it` on. With xt,
// the raw x of the block's own columns is kept there at the positions the
// sums hold.
template <int kB>
__device__ __forceinline__ void ds_norm_loop(float (&acc)[32 * kB],
                                             unsigned char *ring,
                                             uint64_t *landed,
                                             uint64_t *freed, int *it,
                                             int boxes, int box0,
                                             unsigned char *xt) {
  constexpr int kBox = hop::kBox;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int wg = warp / 4;
  const int g = lane / 4, t4 = lane % 4;
  const int rw = 16 * (warp % 4);  // this warp's rows in the warpgroup's 64
  // the row whose 16 bytes this lane gives ldmatrix, and its unit's parity
  const int ra = rw + lane % 16, ka = lane / 16;
#pragma unroll
  for (int i = 0; i < 32 * kB; ++i) acc[i] = 0.f;
  for (int ks = 0; ks < boxes; ++ks, ++*it) {
    const int s = *it % kDsStages;
    unsigned char *st = ring + s * kDsStage;
    hop::mbar_wait(landed + s, (*it / kDsStages) & 1);
    // A: the warp's 16 rows of the slice, a k16 step q in a[q]: a[q][2 e
    // + h] holds row rw + g + 8 h, columns 16 q + 8 e + 2 t4 and + 1
    const unsigned char *xs = st + wg * kBox;
    unsigned a[4][4];
#pragma unroll
    for (int q = 0; q < 4; ++q)
      hop::ldmatrix_x4(a[q],
                       xs + ra * 128 + (((2 * q + ka) ^ (ra % 8)) * 16));
    const int bi = ks - box0;
    if (xt && bi >= 0 && bi < kB) {
      // the block's own columns: keep x where the elementwise pass reads
      // it, box bi, n8 tile 2 q + e of the sums (conflict-free: a warp's 8
      // rows write 8 different 16-byte units)
      unsigned char *ob = xt + bi * kBox;
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int e = 0; e < 2; ++e)
#pragma unroll
          for (int h = 0; h < 2; ++h)
            *reinterpret_cast<unsigned *>(
                ob + (rw + g + 8 * h) * 128 + (((2 * q + e) ^ g) * 16) +
                4 * t4) = a[q][2 * e + h];
    }
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int i = 0; i < 4; ++i) a[q][i] = hop::square2(a[q][i]);
    hop::wgmma_fence();
#pragma unroll
    for (int q = 0; q < 4; ++q)
      hop::wgmma_rs<64 * kB>(acc, a[q],
                             hop::desc_k(st + 2 * kBox + q * 32));
    hop::wgmma_commit();
    // wgmma reads A's registers until the product completes, and the
    // next slice's ldmatrix may take the same registers: wait for it
    // here, then the stage is free
    hop::wgmma_wait<0>();
    if (lane == 0) hop::mbar_arrive(freed + s);
  }
  hop::fence_operands(acc);
}

// Pass 2's k-loop for one column block of kB boxes: dn . gamma into acc
// over the stages from `*it` on, both operands in shared memory.
template <int kB>
__device__ __forceinline__ void ds_dn_loop(float (&acc)[32 * kB],
                                           unsigned char *ring,
                                           uint64_t *landed, uint64_t *freed,
                                           int *it, int boxes) {
  constexpr int kBox = hop::kBox;
  const int lane = threadIdx.x % 32;
  const int wg = threadIdx.x / 128;
#pragma unroll
  for (int i = 0; i < 32 * kB; ++i) acc[i] = 0.f;
  for (int ks = 0; ks < boxes; ++ks, ++*it) {
    const int s = *it % kDsStages;
    unsigned char *st = ring + s * kDsStage;
    hop::mbar_wait(landed + s, (*it / kDsStages) & 1);
    // A: the warpgroup's 64 rows of dn, k = o in 16-column steps (32
    // bytes of a box row); B: gamma's rows o of the slice, 8-row atoms
    // along k, its kB boxes along i one box apart
    hop::wgmma_fence();
#pragma unroll
    for (int q = 0; q < 4; ++q)
      hop::wgmma_ss<64 * kB, 1>(
          acc, hop::desc_k(st + wg * kBox + q * 32),
          hop::desc_mn(st + 2 * kBox + q * 2 * hop::kAtom, kBox));
    hop::wgmma_commit();
    hop::wgmma_wait<0>();
    if (lane == 0) hop::mbar_arrive(freed + s);
  }
  hop::fence_operands(acc);
}

// g * scale and dn from the norm's sum n (+ beta) at one position: GDN
// dn = -g x n^-3/2 / 2, scale = n^-1/2; IGDN dn = g x n^-1/2 / 2,
// scale = n^1/2
template <bool kInverse>
__device__ __forceinline__ void ds_elementwise(float norm, float xv,
                                               float gv, float *d,
                                               float *sg) {
  const float rs = rsqrtf(norm);
  if (kInverse) {
    *d = 0.5f * gv * xv * rs;
    *sg = gv * hop::sqrt_from_rsqrt(norm, rs);
  } else {
    *d = -0.5f * gv * xv * (rs * rs * rs);
    *sg = gv * rs;
  }
}

// This thread's float4 i of a warpgroup's share of a block of the
// workspace: g*scale of its sums 4 i .. 4 i + 3 (a warp's 512 contiguous
// bytes).
__device__ __forceinline__ float4 *ds_work_at(const float *work, int i) {
  return reinterpret_cast<float4 *>(const_cast<float *>(work) +
                                    (i * 128 + threadIdx.x % 128) * 4);
}

// Pass 1 of one column block of kB boxes, for this consumer thread: the
// norm's k-loop (x of the block's own columns kept in xt), the block's
// beta staged from `bb` into bs (barrier `bar`), then, once the
// block's g is in gt (`side` at `parity`), the elementwise pass: dn rounded
// to bf16 over g in gt, g*scale to `work` (this warpgroup's share of the
// block), and, once every thread of the warpgroup
// (barrier `bar`) has read its x from xt, each column's sum of the f32 dn
// over each warp's 16 rows to xt as [warp][64 kB] floats. Rows from
// `valid` on give zeros.
template <bool kInverse, int kB>
__device__ __forceinline__ void ds_norm_block(
    unsigned char *ring, uint64_t *landed, uint64_t *freed, int *it,
    int boxes, int box0, unsigned char *xt, unsigned char *gt,
    uint64_t *side, unsigned parity, const hop::BlockBeta &bb, float *bs,
    float *work, int valid, int bar) {
  constexpr int kBox = hop::kBox;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int rw = 16 * (warp % 4);
  float acc[32 * kB];
  ds_norm_loop<kB>(acc, ring, landed, freed, it, boxes, box0, xt);
  bb.stage(bs, kB, bar);
  hop::mbar_wait(side, parity);

  // sum 4 i + 2 h + e is row rw + g + 8 h, column 8 i + 2 t4 + e of the
  // block
#pragma unroll
  for (int i = 0; i < 8 * kB; ++i) {
    const float2 bo =
        *reinterpret_cast<const float2 *>(bs + 8 * i + 2 * t4);
    float gs[4];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int off = (i / 8) * kBox + (rw + g + 8 * h) * 128 +
                      (((i % 8) ^ g) * 16) + 4 * t4;
      const unsigned xw = *reinterpret_cast<const unsigned *>(xt + off);
      unsigned *gp = reinterpret_cast<unsigned *>(gt + off);
      const unsigned gw = *gp;
      const bool live = rw + g + 8 * h < valid;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        // bf16 -> f32 is exact: the bits shifted into the high half
        const int k = 4 * i + 2 * h + e;
        float d, sg;
        ds_elementwise<kInverse>(
            acc[k] + (e ? bo.y : bo.x),
            __uint_as_float(e ? xw & 0xffff0000u : xw << 16),
            __uint_as_float(e ? gw & 0xffff0000u : gw << 16), &d, &sg);
        acc[k] = live ? d : 0.f;
        gs[2 * h + e] = live ? sg : 0.f;
      }
      *gp = hop::pack2(acc[4 * i + 2 * h], acc[4 * i + 2 * h + 1]);
    }
    *ds_work_at(work, i) = make_float4(gs[0], gs[1], gs[2], gs[3]);
  }
  hop::named_sync(bar, 128);  // every thread has read its x from xt
  // each column's sum over the warp's rows: the thread's two rows, then
  // the 8 lanes of the column (all get the same bits)
  float *wsum = reinterpret_cast<float *>(xt) + (warp % 4) * 64 * kB;
#pragma unroll
  for (int i = 0; i < 8 * kB; ++i) {
    float s[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      s[e] = acc[4 * i + e] + acc[4 * i + 2 + e];
      s[e] += __shfl_xor_sync(0xffffffffu, s[e], 4);
      s[e] += __shfl_xor_sync(0xffffffffu, s[e], 8);
      s[e] += __shfl_xor_sync(0xffffffffu, s[e], 16);
    }
    if (g == 0)
      *reinterpret_cast<float2 *>(wsum + 8 * i + 2 * t4) =
          make_float2(s[0], s[1]);
  }
}

// Pass 2 of one column block of kB boxes, for this consumer thread: g*scale
// read back from `work` (this warpgroup's share of the block) while the
// dn . gamma k-loop runs, then, once the block's x is in xt (`side` at
// `parity`), dx = g*scale + 2 x (dn . gamma), rounded once to bf16 over x
// in xt.
template <int kB>
__device__ __forceinline__ void ds_dx_block(unsigned char *ring,
                                            uint64_t *landed,
                                            uint64_t *freed, int *it,
                                            int boxes, unsigned char *xt,
                                            uint64_t *side, unsigned parity,
                                            const float *work) {
  constexpr int kBox = hop::kBox;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int rw = 16 * (warp % 4);
  // g*scale of sums 4 i .. 4 i + 3 in gs[i]
  float4 gs[8 * kB];
#pragma unroll
  for (int i = 0; i < 8 * kB; ++i) gs[i] = *ds_work_at(work, i);
  float acc[32 * kB];
  ds_dn_loop<kB>(acc, ring, landed, freed, it, boxes);
  hop::mbar_wait(side, parity);
#pragma unroll
  for (int i = 0; i < 8 * kB; ++i) {
    const float4 s = gs[i];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      unsigned *p = reinterpret_cast<unsigned *>(
          xt + (i / 8) * kBox + (rw + g + 8 * h) * 128 +
          (((i % 8) ^ g) * 16) + 4 * t4);
      const unsigned xw = *p;
      const float x0 = __uint_as_float(xw << 16);
      const float x1 = __uint_as_float(xw & 0xffff0000u);
      *p = hop::pack2((h ? s.z : s.x) + 2.0f * x0 * acc[4 * i + 2 * h],
                      (h ? s.w : s.y) + 2.0f * x1 * acc[4 * i + 2 * h + 1]);
    }
  }
}

// x, g, dx, dn: (n, C) bf16 behind their tensor maps (dn is stored, then
// loaded back), gamma (C, C), C a multiple of 8; beta: the first `live` of
// C (1 past them); dn_sums: (ceil(n / 64), live) f32; work: the grid's
// workspaces, ds_work_floats(C) floats a CTA.
template <bool kInverse>
__global__ void __launch_bounds__(kDsThreads, 1)
    gdn_bwd_dx_stream_kernel(const __grid_constant__ CUtensorMap x_map,
                             const __grid_constant__ CUtensorMap g_map,
                             const __grid_constant__ CUtensorMap gamma_map,
                             const __grid_constant__ CUtensorMap dx_map,
                             const __grid_constant__ CUtensorMap dn_map,
                             const __nv_bfloat16 *__restrict__ beta,
                             float *__restrict__ dn_sums,
                             float *__restrict__ work, int n, int C,
                             int live) {
  constexpr int kBox = hop::kBox;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char *ring =
      smem_raw + (1024 - hop::smem_at(smem_raw) % 1024) % 1024;
  unsigned char *xtiles = ring + kDsStages * kDsStage;
  unsigned char *gtiles = xtiles + kDsTile;
  float *betas = reinterpret_cast<float *>(gtiles + kDsTile);
  __shared__ uint64_t landed[kDsStages], freed[kDsStages];
  __shared__ uint64_t side[2];  // a warpgroup's g (pass 1) or x (pass 2)
  __shared__ uint64_t dn_done;  // both warpgroups' dn of a tile is stored

  const int boxes = (C + 63) / 64;
  const int blocks = (boxes + kDsMaxBoxes - 1) / kDsMaxBoxes;
  const int row_tiles = (n + kDsRows - 1) / kDsRows;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kDsStages; ++s) {
      hop::mbar_init(landed + s);
      hop::mbar_init(freed + s, kDsConsumers / 32);  // a consumer warp
    }
    hop::mbar_init(side);
    hop::mbar_init(side + 1);
    hop::mbar_init(&dn_done, 2);  // each warpgroup's first thread
    hop::fence_mbar_init();
  }
  __syncthreads();

  if (threadIdx.x >= kDsConsumers) {  // the producer warpgroup
    hop::setmaxnreg_dec<kDsProducerRegs>();
    if (threadIdx.x == kDsConsumers) {
      int it = 0, done = 0;
      // the stage of slice `it`, once the products of its last use are
      // done, expecting 2 + count boxes
      auto stage = [&](int count) {
        const int s = it % kDsStages;
        if (it >= kDsStages)
          hop::mbar_wait(freed + s, (it / kDsStages - 1) & 1);
        hop::mbar_expect(landed + s, (2 + count) * kBox);
        return ring + s * kDsStage;
      };
      // x's k-slices of tile rows row0.., gamma's rows o of a block
      // (K-major)
      auto norm_slices = [&](int row0, int box0, int count) {
        for (int ks = 0; ks < boxes; ++ks, ++it) {
          unsigned char *st = stage(count);
          uint64_t *bar = landed + it % kDsStages;
          hop::tma_box(st, x_map, 64 * ks, row0, bar);
          hop::tma_box(st + kBox, x_map, 64 * ks, row0 + 64, bar);
          for (int b = 0; b < count; ++b)
            hop::tma_box(st + (2 + b) * kBox, gamma_map, 64 * ks,
                         64 * (box0 + b), bar);
        }
      };
      for (int t = blockIdx.x; t < row_tiles; t += gridDim.x, ++done) {
        const int row0 = t * kDsRows;
        for (int cb = 0; cb < blocks; ++cb) {
          int box0, count;
          hop::column_block(boxes, cb, &box0, &count);
          norm_slices(row0, box0, count);
        }
        // the tile's dn is in the scratch
        hop::mbar_wait(&dn_done, done & 1);
        hop::fence_proxy_async_global();
        for (int cb = 0; cb < blocks; ++cb) {
          int box0, count;
          hop::column_block(boxes, cb, &box0, &count);
          // dn's k-slices, gamma's columns i of the block (MN-major)
          for (int ks = 0; ks < boxes; ++ks, ++it) {
            unsigned char *st = stage(count);
            uint64_t *bar = landed + it % kDsStages;
            hop::tma_box(st, dn_map, 64 * ks, row0, bar);
            hop::tma_box(st + kBox, dn_map, 64 * ks, row0 + 64, bar);
            for (int b = 0; b < count; ++b)
              hop::tma_box(st + (2 + b) * kBox, gamma_map, 64 * (box0 + b),
                           64 * ks, bar);
          }
        }
      }
    }
    return;
  }
  hop::setmaxnreg_inc<kDsConsumerRegs>();

  // each warpgroup loads and stores its own 64 rows (its first thread) and
  // meets the other only in the stages they share and in dn_done
  const int wg = threadIdx.x / 128;
  const bool leader = threadIdx.x % 128 == 0;
  const int bar = 1 + wg;  // this warpgroup's named barrier
  unsigned char *xt = xtiles + wg * kDsMaxBoxes * kBox;
  unsigned char *gt = gtiles + wg * kDsMaxBoxes * kBox;
  float *mine = work + blockIdx.x * ds_work_floats(C);
  float *bs = betas + wg * kDsBeta;  // beta of this warpgroup's block
  int it = 0;
  unsigned uses = 0;  // of `side`
  // this warpgroup's share of block (box0, count) of the workspace
  auto share = [&](int box0, int count) {
    return mine + static_cast<int64_t>(kDsRows) * 64 * box0 +
           wg * 64 * 64 * count;
  };
  for (int t = blockIdx.x; t < row_tiles; t += gridDim.x) {
    const int row0 = t * kDsRows + 64 * wg;
    const int valid = n - row0 < 0 ? 0 : (n - row0 < 64 ? n - row0 : 64);
    for (int cb = 0; cb < blocks; ++cb, ++uses) {
      int box0, count;
      hop::column_block(boxes, cb, &box0, &count);
      hop::BlockBeta bb;  // staged after the norm's k-loop
      bb.load(beta, box0, count, live);
      // the last dn store has read gt, and every thread is done with xt
      // and gt
      if (leader) hop::bulk_wait_read<0>();
      hop::named_sync(bar, 128);
      if (leader) {
        hop::mbar_expect(side + wg, count * kBox);
        for (int b = 0; b < count; ++b)
          hop::tma_box(gt + b * kBox, g_map, 64 * (box0 + b), row0,
                       side + wg);
      }
      float *ws = share(box0, count);
      if (count == 3)
        ds_norm_block<kInverse, 3>(ring, landed, freed, &it, boxes, box0, xt,
                                   gt, side + wg, uses & 1, bb, bs, ws, valid,
                                   bar);
      else if (count == 2)
        ds_norm_block<kInverse, 2>(ring, landed, freed, &it, boxes, box0, xt,
                                   gt, side + wg, uses & 1, bb, bs, ws, valid,
                                   bar);
      else
        ds_norm_block<kInverse, 1>(ring, landed, freed, &it, boxes, box0, xt,
                                   gt, side + wg, uses & 1, bb, bs, ws, valid,
                                   bar);
      hop::fence_proxy_async();
      hop::named_sync(bar, 128);  // dn is whole in gt, the warps' sums in xt
      if (leader && valid > 0) {
        for (int b = 0; b < count; ++b)
          hop::tma_store(dn_map, gt + b * kBox, 64 * (box0 + b), row0);
        hop::bulk_commit();
      }
      // the tile's sum of each column: the 4 warps' sums in order
      const float *wsum = reinterpret_cast<const float *>(xt);
      for (int c = threadIdx.x % 128;
           valid > 0 && c < 64 * count && 64 * box0 + c < live; c += 128) {
        float s = 0.f;
#pragma unroll
        for (int q = 0; q < 4; ++q) s += wsum[q * 64 * count + c];
        dn_sums[static_cast<int64_t>(row0 / 64) * live + 64 * box0 + c] = s;
      }
    }
    // the tile's dn stores are complete before the producer loads it back
    if (leader) {
      hop::bulk_wait<0>();
      hop::fence_proxy_async_global();
      hop::mbar_arrive(&dn_done);
    }
    for (int cb = 0; cb < blocks; ++cb, ++uses) {
      int box0, count;
      hop::column_block(boxes, cb, &box0, &count);
      // the last dx store has read xt; every thread's writes of xt come
      // before the TMA's
      if (leader) hop::bulk_wait_read<0>();
      hop::fence_proxy_async();
      hop::named_sync(bar, 128);
      if (leader) {
        hop::mbar_expect(side + wg, count * kBox);
        for (int b = 0; b < count; ++b)
          hop::tma_box(xt + b * kBox, x_map, 64 * (box0 + b), row0,
                       side + wg);
      }
      const float *ws = share(box0, count);
      if (count == 3)
        ds_dx_block<3>(ring, landed, freed, &it, boxes, xt, side + wg,
                       uses & 1, ws);
      else if (count == 2)
        ds_dx_block<2>(ring, landed, freed, &it, boxes, xt, side + wg,
                       uses & 1, ws);
      else
        ds_dx_block<1>(ring, landed, freed, &it, boxes, xt, side + wg,
                       uses & 1, ws);
      hop::fence_proxy_async();
      hop::named_sync(bar, 128);  // dx is whole in xt
      if (leader && valid > 0) {
        for (int b = 0; b < count; ++b)
          hop::tma_store(dx_map, xt + b * kBox, 64 * (box0 + b), row0);
        hop::bulk_commit();
      }
    }
  }
  if (leader) hop::bulk_wait<0>();  // the stores are done
}

// The bf16 partials: for each 1024-row chunk, dgamma's partial dn^T . x^2
// (bf16 operands, f32 sums on the tensor cores) and dbeta's, the in-order
// sum of the chunk's 16 tile sums that the bf16 dx pass wrote.
//
// It is bound by bytes: 2*n*C^2 operations (51 GFLOP a training step at
// C = 192, 0.05 ms at 989 TFLOP/s) against the bf16 dn scratch and x read
// and the partials written (0.19 ms at 3.35 TB/s). So the design reads
// each byte once, keeps copies in flight, and keeps the product off the
// copies' way:
//  - a CTA takes whole-width 64-row slices of its chunk: dn's columns o0 ..
//    o0+191 and x's i0 .. i0+191 (one CTA covers C <= 192, ceil(C/192)^2
//    blocks otherwise), so every dgamma sum of the block lives in registers
//    of its three warpgroups (64 rows o each, all 192 columns i: 96 f32 a
//    thread);
//  - the slices stream through a ring of kWideStages in shared memory,
//    copied by the Tensor Memory Accelerator: one thread asks for each
//    64-row x 64-column box (128 bytes a row) with the 128-byte swizzle,
//    and an mbarrier a stage counts the bytes in; three slices are in
//    flight while one is multiplied, one barrier a slice. (Copies of 16
//    bytes a thread with cp.async, into the same layout, kept the copies
//    alone far from the card's byte rate; the TMA leaves the threads
//    free.) Then every thread squares an even share of the x slice in
//    place (x * x is exact in f32, so rounding it once is the TPU kernel's
//    bf16 x * x);
//  - the product runs on wgmma (m64n192k16, four a slice per warpgroup),
//    which reads both operands from shared memory at the tensor cores' full
//    rate; mma.sync fed by ldmatrix took about as long a slice as its
//    copies, so the two could not hide each other. A = dn^T and B = x^2 are
//    both MN-major in the slices (a row of the chunk is a k): each box is
//    the canonical 128-byte-swizzled MN-major layout, 8 rows k of 64
//    columns to an atom of 1 KB, atoms kWideAtom apart along k and boxes
//    kWideBox apart along the columns. The product of a slice overlaps the
//    wait for the next slice and its squares;
//  - the small layers of a step have few chunks (64 at 65,536 rows, 16 at
//    16,384), so a chunk's slices are split over a cluster of `split` CTAs
//    (slice s to rank s % split; 4 when the grid has at most 33 blocks, 2
//    at most 66, else 1: a rule on n and C, never on the card). Rank q owns
//    the dgamma rows of the warps w with w % split == q: once every rank is
//    done with its ring, every rank stores its sums of those rows into q's
//    shared memory (distributed shared memory), and q adds them in rank
//    order. No atomics.
// Every sum has a fixed order (k over a slice's 64 rows in the tensor
// cores' order, the slices in order, the ranks in order), so every launch
// gives the same bytes. Rows past n and columns past C come in as zeros
// (the TMA's fill) and add exact zeros. Rows that are not 16-byte aligned
// (C % 8 != 0) take element copies into the same layout, in the same
// kernel.
constexpr int kWideThreads = 384;  // 3 warpgroups: 64 rows o each
constexpr int kWideWarps = kWideThreads / 32;
constexpr int kWideBlock = 192;    // dgamma rows and columns per CTA
constexpr int kWideRows = 64;      // rows per staged slice (a dx tile)
constexpr int kWideStages = 4;
constexpr int kWideAtom = hop::kAtom;  // bytes of 8 rows of a box
constexpr int kWideBox = hop::kBox;    // 64 x 64 bf16
constexpr int kWideSlice = kWideBlock / 64 * kWideBox;   // bytes an operand
constexpr int kWideAcc = 96;       // f32 sums a thread: 64 x 192 / 128
constexpr int kMaxSplit = 4;
constexpr size_t kWideSmem = kWideStages * 2 * kWideSlice;
static_assert(kChunkRows % kWideRows == 0, "whole slices per chunk");
static_assert(kWideRows == hop::kTileRows && kWideRows == hop::kBoxRows,
              "a slice is a dx tile and a row of boxes");
static_assert(3 * 64 == kWideBlock, "the warpgroups tile the block");
// what a rank receives: every rank's sums of the warps it owns
static_assert(kWideWarps * kWideAcc * 32 * 4 <= kWideSmem,
              "the sums a rank receives overlay its ring");
static_assert(kWideWarps % kMaxSplit == 0 && kWideWarps % 2 == 0,
              "every rank owns as many warps");

// Rows row0 .. row0+63 of src's columns c0 .. c0+191 into the slice s in
// the swizzled layout, element by element (squared as they are stored
// when `square`): zeros from row `live` on and past column C.
__device__ __forceinline__ void copy_elements(
    unsigned char *s, const __nv_bfloat16 *__restrict__ src, int64_t row0,
    int live, int c0, int C, bool square) {
  src += row0 * C + c0;
  for (int e = threadIdx.x; e < kWideRows * kWideBlock; e += kWideThreads) {
    const int k = e / kWideBlock;
    const int c = e - k * kWideBlock;
    float v = k < live && c0 + c < C ? __bfloat162float(src[k * C + c]) : 0.f;
    if (square) v *= v;
    *reinterpret_cast<__nv_bfloat16 *>(s + hop::swizzled_at(k, c)) =
        __float2bfloat16(v);
  }
}

__global__ void __launch_bounds__(kWideThreads, 1)
    gdn_bwd_partials_wide_kernel(const __grid_constant__ CUtensorMap x_map,
                                 const __grid_constant__ CUtensorMap dn_map,
                                 const __nv_bfloat16 *__restrict__ x,
                                 const __nv_bfloat16 *__restrict__ dn,
                                 const float *__restrict__ dn_sums,
                                 float *__restrict__ partials, int64_t n,
                                 int C, int split, bool tma) {
  namespace cg = cooperative_groups;
  // kWideStages x {dn, x} from the first 1024-byte boundary, which the
  // swizzle's atoms need (the launch adds 1 KB for it)
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char *smem =
      smem_raw + (1024 - hop::smem_at(smem_raw) % 1024) % 1024;
  __shared__ uint64_t landed[kWideStages];  // a stage's TMA bytes are in

  const int tiles = (C + kWideBlock - 1) / kWideBlock;
  const int rank = static_cast<int>(blockIdx.x) % split;
  const int block = static_cast<int>(blockIdx.x) / split;
  const int o0 = (block / tiles) * kWideBlock;
  const int i0 = (block % tiles) * kWideBlock;
  const int ow = C - o0 < kWideBlock ? C - o0 : kWideBlock;
  const int64_t chunk = blockIdx.y;
  const int64_t start = chunk * kChunkRows;
  const int valid = static_cast<int>(
      n - start < kChunkRows ? n - start : static_cast<int64_t>(kChunkRows));
  const int slices = (valid + kWideRows - 1) / kWideRows;
  // this rank's slices: rank, rank + split, ...
  const int mine = slices > rank ? (slices - rank + split - 1) / split : 0;
  // the boxes that hold columns below C
  const int dn_boxes = (ow + 63) / 64;
  const int x_boxes = ((C - i0 < kWideBlock ? C - i0 : kWideBlock) + 63) / 64;

  auto slot = [&](int j) { return smem + (j % kWideStages) * 2 * kWideSlice; };
  auto issue = [&](int j) {  // TMA: thread 0 alone; element copies: all
    if (j >= mine) return;
    const int s = rank + j * split;
    const int64_t row0 = start + static_cast<int64_t>(s) * kWideRows;
    if (!tma) {
      const int live = valid - s * kWideRows;
      copy_elements(slot(j), dn, row0, live, o0, C, false);
      copy_elements(slot(j) + kWideSlice, x, row0, live, i0, C, true);
    } else if (threadIdx.x == 0) {
      uint64_t *bar = landed + j % kWideStages;
      hop::mbar_expect(bar, (dn_boxes + x_boxes) * kWideBox);
      for (int b = 0; b < dn_boxes; ++b)
        hop::tma_box(slot(j) + b * kWideBox, dn_map, o0 + 64 * b,
                     static_cast<int>(row0), bar);
      for (int b = 0; b < x_boxes; ++b)
        hop::tma_box(slot(j) + kWideSlice + b * kWideBox, x_map, i0 + 64 * b,
                     static_cast<int>(row0), bar);
    }
  };
  if (threadIdx.x == 0) {
    for (int k = 0; k < kWideStages; ++k) hop::mbar_init(landed + k);
    hop::fence_mbar_init();
  }
  __syncthreads();
  for (int j = 0; j < kWideStages - 1; ++j) issue(j);

  float *out = partials + chunk * (static_cast<int64_t>(C) * C + C);
  // dbeta: the chunk's tile sums in tile order, while the slices land
  if (i0 == 0 && rank == 0) {
    const float *ts = dn_sums + chunk * (kChunkRows / kWideRows) * C + o0;
    for (int o = threadIdx.x; o < ow; o += kWideThreads) {
      float s = 0.f;
      for (int k = 0; k < slices; ++k) s += ts[static_cast<int64_t>(k) * C + o];
      out[static_cast<int64_t>(C) * C + o0 + o] = s;
    }
  }

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int wg = warp / 4;  // this warpgroup's dgamma rows o0 + 64 wg ..
  const bool live_rows = wg < dn_boxes;
  float acc[kWideAcc];
#pragma unroll
  for (int i = 0; i < kWideAcc; ++i) acc[i] = 0.f;

  for (int j = 0; j < mine; ++j) {
    if (tma) {
      hop::mbar_wait(landed + j % kWideStages, (j / kWideStages) & 1);
      // x^2 in place, an even share a thread
      uint4 *xs = reinterpret_cast<uint4 *>(slot(j) + kWideSlice);
      for (int e = threadIdx.x; e < x_boxes * kWideBox / 16;
           e += kWideThreads) {
        uint4 v = xs[e];
        v.x = hop::square2(v.x), v.y = hop::square2(v.y),
        v.z = hop::square2(v.z), v.w = hop::square2(v.w);
        xs[e] = v;
      }
    }
    // the squares (and element copies), written through the generic proxy,
    // are seen by wgmma's reads once every thread has passed the barrier
    hop::fence_proxy_async();
    hop::wgmma_wait<0>();
    hop::fence_operands(acc);
    __syncthreads();  // slice j is whole; every product of j - 1 is done
    issue(j + kWideStages - 1);  // over slice j - 1
    if (live_rows) {
      const unsigned char *a = slot(j) + wg * kWideBox;
      const unsigned char *b = slot(j) + kWideSlice;
      hop::wgmma_fence();
#pragma unroll
      for (int k = 0; k < kWideRows; k += 16)
        hop::wgmma_m64n192k16(acc,
                              hop::desc_mn(a + (k / 8) * kWideAtom, kWideBox),
                              hop::desc_mn(b + (k / 8) * kWideAtom, kWideBox));
      hop::wgmma_commit();
      hop::fence_operands(acc);
    }
  }
  hop::wgmma_wait<0>();
  hop::fence_operands(acc);

  // accumulator 4 t + 2 h + (0, 1): row 16 (warp % 4) + lane / 4 + 8 h of
  // the warpgroup's 64, columns 8 t + 2 (lane % 4) + (0, 1)
  const int o_h0 = o0 + 64 * wg + 16 * (warp % 4) + lane / 4;
  const int i_t0 = i0 + 2 * (lane % 4);
  auto store = [&](int t, int h, float v0, float v1) {
    const int o = o_h0 + 8 * h;
    const int i = i_t0 + 8 * t;
    if (o >= C || i >= C) return;
    float *at = out + static_cast<int64_t>(o) * C + i;
    if (tma) {  // C % 8 == 0: columns i and i + 1 both live
      *reinterpret_cast<float2 *>(at) = make_float2(v0, v1);
    } else {
      at[0] = v0;
      if (i + 1 < C) at[1] = v1;
    }
  };
  if (split == 1) {
#pragma unroll
    for (int t = 0; t < kWideBlock / 8; ++t)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        store(t, h, acc[4 * t + 2 * h], acc[4 * t + 2 * h + 1]);
    return;
  }
  // rank q stores the rows of the warps w with w % split == q: every rank
  // (q too) leaves its sums of them in q's shared memory, over the ring,
  // and q adds them in rank order
  cg::cluster_group cluster = cg::this_cluster();
  const int owner = warp % split;
  const int owned = warp / split;  // among the owner's warps
  cluster.sync();  // every rank is done with its ring
  // [owned warp][rank][kWideAcc][lane]
  float *to = cluster.map_shared_rank(reinterpret_cast<float *>(smem), owner) +
              (owned * split + rank) * kWideAcc * 32 + lane;
#pragma unroll
  for (int i = 0; i < kWideAcc; ++i) to[i * 32] = acc[i];
  cluster.sync();  // every rank's sums are in place
  if (owner != rank) return;
  const float *got = reinterpret_cast<const float *>(smem) +
                     owned * split * kWideAcc * 32 + lane;
#pragma unroll 4
  for (int t = 0; t < kWideBlock / 8; ++t)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float v[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float *p = got + (4 * t + 2 * h + e) * 32;
        v[e] = p[0];
#pragma unroll
        for (int r = 1; r < kMaxSplit; ++r)
          if (r < split) v[e] += p[r * kWideAcc * 32];
      }
      store(t, h, v[0], v[1]);
    }
}

template <bool kInverse, int kWidth>
cudaError_t launch_dx_as(const void *x, const void *g, const void *gamma_t,
                         const void *gamma, const void *beta, void *dx,
                         void *dn, int64_t n, int C, cudaStream_t stream) {
  const f32::Shape s = f32::shape_of(C);
  const size_t smem = f32::smem_floats(s, 2) * sizeof(float);
  auto kernel = gdn_bwd_dx_kernel<kInverse, kWidth>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  // 16-byte copies and accesses need whole rows of 4 and aligned bases
  const bool vec = C % 4 == 0 && hop::aligned16(x) &&
                   hop::aligned16(g) && hop::aligned16(gamma_t) &&
                   hop::aligned16(gamma) && hop::aligned16(dx) &&
                   hop::aligned16(dn);
  const int64_t blocks = (n + s.rows - 1) / s.rows;
  kernel<<<static_cast<unsigned>(blocks), s.threads, smem, stream>>>(
      static_cast<const float *>(x), static_cast<const float *>(g),
      static_cast<const float *>(gamma_t), static_cast<const float *>(gamma),
      static_cast<const float *>(beta), static_cast<float *>(dx),
      static_cast<float *>(dn), n, C, vec);
  return counted(kDxF32);
}

// Where gdn_bwd_dx_f32_blocked_kernel reads x, gamma^T and gamma and
// writes dn (the operands the TMA reads): the tensors themselves where it
// can address them (C % 4 == 0, 16-byte aligned bases), else zero-padded
// copies in scratch, in rows of round4(C) floats: x, dn, then gamma^T and
// gamma, each only if it is copied. gamma^T is copied where gamma is (the
// caller builds it; lmic_gdn_bwd_dx requires it 16-byte aligned where
// C % 4 == 0 and gamma is). Sized by n and C alone.
struct DxF32Staging {
  int width;
  bool x, dn, gammas;
  int64_t bytes(int64_t n) const {
    return int64_t{4} * width * ((x + dn) * n + (gammas ? 2 * width : 0));
  }
};

DxF32Staging dx_f32_staging_of(const void *x, const void *gamma,
                               const void *dn, int C) {
  const int width = (C + 3) / 4 * 4;
  const bool pad = width != C;
  return {width, pad || !hop::aligned16(x), pad || !hop::aligned16(dn),
          pad || !hop::aligned16(gamma)};
}

// Runs gdn_bwd_dx_f32_blocked_kernel on its operands as the TMA can
// address them: (n, width) and (width, width), width % 4 == 0, 16-byte
// aligned.
template <bool kInverse, class Cfg, bool kVecO>
cudaError_t run_dx_blocked(const void *x, const void *g, const void *gamma_t,
                           const void *gamma, const void *beta, void *dx,
                           void *dn, int64_t n, int C, int width,
                           cudaStream_t stream) {
  namespace blk = f32::blocked;
  auto kernel = gdn_bwd_dx_f32_blocked_kernel<kInverse, Cfg, kVecO>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Cfg::kSmemBytes);
  CUtensorMap maps[4];  // x, gamma^T, dn, gamma
  if (err != cudaSuccess ||
      (err = blk::a_map<Cfg>(maps, x, n, width)) != cudaSuccess ||
      (err = blk::w_map(maps + 1, gamma_t, width)) != cudaSuccess ||
      (err = blk::a_map<Cfg>(maps + 2, dn, n, width)) != cudaSuccess ||
      (err = blk::w_map(maps + 3, gamma, width)) != cudaSuccess)
    return err;
  // clusters of K CTAs split each tile's column blocks: the K (1, 2, 4
  // or 8, no more than the blocks) whose waves of tiles over the clusters
  // the card holds at once take the least time, each wave 1 / K of a
  // tile's work (the smallest K of equals). A rule on n, C and the card;
  // each output's sum is the same at every K.
  const int sms = hop::sm_count();
  if (!sms) return cudaErrorNoDevice;
  const int64_t tiles = (n + Cfg::kRows - 1) / Cfg::kRows;
  const int blocks = (width + Cfg::kCols - 1) / Cfg::kCols;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t config = {};
  config.blockDim = dim3(Cfg::kThreads);
  config.dynamicSmemBytes = Cfg::kSmemBytes;
  config.stream = stream;
  config.attrs = cluster;
  config.numAttrs = 1;
  // clusters of k the card holds at once, asked of the runtime once per
  // device, instance and k (kept plus one: 0 until asked)
  constexpr int kDevices = 64;
  static std::atomic<int> fits[kDevices][4];
  int device = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return err;
  int K = 0, most = 0;
  double best = 0.0;
  for (int k = 1, e = 0; k <= 8 && k <= blocks; k *= 2, ++e) {
    std::atomic<int> *known =
        device < kDevices ? &fits[device][e] : nullptr;
    int fit = known ? known->load() - 1 : -1;
    if (fit < 0) {
      cluster[0].val.clusterDim.x = k;
      config.gridDim = dim3(k);
      if ((err = cudaOccupancyMaxActiveClusters(&fit, kernel, &config)) !=
          cudaSuccess)
        return err;
      if (known) known->store(fit + 1);
    }
    if (!fit) break;
    const double time = static_cast<double>((tiles + fit - 1) / fit) / k;
    if (!K || time < best) K = k, most = fit, best = time;
  }
  if (!K) return cudaErrorNoDevice;
  cluster[0].val.clusterDim.x = K;
  config.gridDim = dim3(static_cast<unsigned>(tiles < most ? tiles : most) *
                        K);
  err = cudaLaunchKernelEx(
      &config, kernel, maps[0], maps[1], maps[2], maps[3],
      static_cast<const float *>(x), static_cast<const float *>(g),
      static_cast<const float *>(beta), static_cast<float *>(dx),
      static_cast<float *>(dn), static_cast<int>(n), C, width);
  if (err != cudaSuccess) {
    cudaGetLastError();  // reported here, not at the next launch
    return err;
  }
  return counted(kDxF32Blocked);
}

// gdn_bwd_dx_f32_blocked_kernel on its operands where the TMA can address
// them, else on zero-padded copies in scratch (dx_f32_staging_of), dx and
// dn copied back.
template <bool kInverse>
cudaError_t launch_dx_blocked(const void *x, const void *g,
                              const void *gamma_t, const void *gamma,
                              const void *beta, void *dx, void *dn,
                              int64_t n, int C, void *scratch,
                              cudaStream_t stream) {
  namespace blk = f32::blocked;
  // TMA row coordinates are ints (no card holds 2^31 rows of 385 floats)
  if (n > (int64_t{1} << 31) - 256) return cudaErrorInvalidValue;
  const DxF32Staging st = dx_f32_staging_of(x, gamma, dn, C);
  if (st.bytes(n) && (!scratch || !hop::aligned16(scratch)))
    return cudaErrorInvalidValue;
  if (!st.gammas && !hop::aligned16(gamma_t)) return cudaErrorInvalidValue;
  const int width = st.width;
  const int64_t rows_bytes = int64_t{4} * width * n;
  char *at = static_cast<char *>(scratch);
  cudaError_t err = cudaSuccess;
  const void *xs = x;
  if (st.x) {
    err = blk::pad_rows(at, x, n, C, width, stream);
    xs = at;
    at += rows_bytes;
  }
  void *dns = dn;
  if (st.dn) dns = at, at += rows_bytes;
  const void *gts = gamma_t, *gms = gamma;
  if (st.gammas) {
    if (err == cudaSuccess)
      err = blk::pad_square(at, gamma_t, C, width, stream);
    gts = at;
    at += int64_t{4} * width * width;
    if (err == cudaSuccess)
      err = blk::pad_square(at, gamma, C, width, stream);
    gms = at;
  }
  const bool vec_o = C % 4 == 0 && hop::aligned16(g) && hop::aligned16(dx);
  if (err == cudaSuccess)
    err = !vec_o ? run_dx_blocked<kInverse, DxBlockedNarrow, false>(
                       xs, g, gts, gms, beta, dx, dns, n, C, width, stream)
          : blk::narrow_blocks(width)
              ? run_dx_blocked<kInverse, DxBlockedNarrow, true>(
                    xs, g, gts, gms, beta, dx, dns, n, C, width, stream)
              : run_dx_blocked<kInverse, DxBlocked, true>(
                    xs, g, gts, gms, beta, dx, dns, n, C, width, stream);
  if (err == cudaSuccess && st.dn)
    err = blk::unpad_rows(dn, dns, n, C, width, stream);
  return err;
}

// The main path's widths run kernels compiled for them (as the forward's),
// any other C up to 384 the general one, every wider C the blocked one
template <bool kInverse>
cudaError_t launch_dx(const void *x, const void *g, const void *gamma_t,
                      const void *gamma, const void *beta, void *dx,
                      void *dn, int64_t n, int C, void *scratch,
                      cudaStream_t stream) {
  if (C > f32::kWholeWidth)
    return launch_dx_blocked<kInverse>(x, g, gamma_t, gamma, beta, dx, dn,
                                       n, C, scratch, stream);
  if (C == 192)
    return launch_dx_as<kInverse, 192>(x, g, gamma_t, gamma, beta, dx, dn, n,
                                       C, stream);
  if (C == 128)
    return launch_dx_as<kInverse, 128>(x, g, gamma_t, gamma, beta, dx, dn, n,
                                       C, stream);
  return launch_dx_as<kInverse, 0>(x, g, gamma_t, gamma, beta, dx, dn, n, C,
                                   stream);
}

template <int kWidth>
cudaError_t launch_partials_as(const void *x, const void *dn, void *partials,
                               int64_t n, int C, cudaStream_t stream) {
  constexpr int smem = kStages * 2 * kSliceFloats * sizeof(float);
  auto kernel = gdn_bwd_partials_kernel<kWidth>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  // 16-byte copies and stores need whole rows of 4 and aligned bases
  const bool vec = C % 4 == 0 && hop::aligned16(x) &&
                   hop::aligned16(dn) && hop::aligned16(partials);
  const int tiles = (C + kTile - 1) / kTile;
  const dim3 grid(static_cast<unsigned>(tiles * tiles),
                  static_cast<unsigned>((n + kChunkRows - 1) / kChunkRows));
  kernel<<<grid, kPartialsThreads, smem, stream>>>(
      static_cast<const float *>(x), static_cast<const float *>(dn),
      static_cast<float *>(partials), n, C, vec);
  return counted(kPartialsF32);
}

cudaError_t launch_partials(const void *x, const void *dn, void *partials,
                            int64_t n, int C, cudaStream_t stream) {
  if (C == 192) return launch_partials_as<192>(x, dn, partials, n, C, stream);
  if (C == 128) return launch_partials_as<128>(x, dn, partials, n, C, stream);
  return launch_partials_as<0>(x, dn, partials, n, C, stream);
}

template <bool kInverse, int kWidth>
cudaError_t launch_dx_wide_as(const void *x, const void *g, const void *gamma,
                              const void *beta, void *dx, void *dn,
                              void *dn_sums, int64_t n, cudaStream_t stream) {
  using W = DxWide<kWidth>;
  auto kernel = gdn_bwd_dx_wide_kernel<kInverse, kWidth>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(W::kSmem));
  if (err != cudaSuccess) return err;
  // x, g, gamma, dx, dn
  CUtensorMap maps[5];
  const void *bases[5] = {x, g, gamma, dx, dn};
  for (int k = 0; k < 5; ++k)
    if ((err = hop::box_map(maps + k, bases[k], k == 2 ? kWidth : n,
                            kWidth)) != cudaSuccess)
      return err;
  // persistent CTAs, one an SM: each tile's bytes are one CTA's alone, so
  // they do not depend on the grid
  const int sms = hop::sm_count();
  if (!sms) return cudaErrorNoDevice;
  const int64_t tiles = (n + 63) / 64;
  kernel<<<static_cast<unsigned>(tiles < sms ? tiles : sms), W::kThreads,
           W::kSmem, stream>>>(maps[0], maps[1], maps[2], maps[3], maps[4],
                               static_cast<const __nv_bfloat16 *>(beta),
                               static_cast<float *>(dn_sums), n);
  return counted(kDxWide);
}

// Runs gdn_bwd_dx_stream_kernel on its operands as they are (C % 8 == 0,
// 16-byte aligned bases): one launch, or one per kDsLaunchRows rows, on
// `work`, ds_work_bytes(n, C, sms) bytes.
template <bool kInverse>
cudaError_t launch_dx_stream(const void *x, const void *g, const void *gamma,
                             const void *beta, void *dx, void *dn,
                             void *dn_sums, void *work, int64_t n, int C,
                             int live, int sms, cudaStream_t stream) {
  if (n > kDsLaunchRows) {  // the rest from bases further on
    const int64_t at = kDsLaunchRows * C * 2;  // bytes
    cudaError_t err = launch_dx_stream<kInverse>(
        x, g, gamma, beta, dx, dn, dn_sums, work, kDsLaunchRows, C, live,
        sms, stream);
    if (err != cudaSuccess) return err;
    auto on = [&](const void *p) { return static_cast<const char *>(p) + at; };
    return launch_dx_stream<kInverse>(
        on(x), on(g), gamma, beta, const_cast<char *>(on(dx)),
        const_cast<char *>(on(dn)),
        static_cast<float *>(dn_sums) + kDsLaunchRows / 64 * live, work,
        n - kDsLaunchRows, C, live, sms, stream);
  }
  auto kernel = gdn_bwd_dx_stream_kernel<kInverse>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kDsSmem));
  if (err != cudaSuccess) return err;
  CUtensorMap maps[5];  // x, g, gamma, dx, dn
  const void *bases[5] = {x, g, gamma, dx, dn};
  for (int k = 0; k < 5; ++k)
    if ((err = hop::box_map(maps + k, bases[k], k == 2 ? C : n, C)) !=
        cudaSuccess)
      return err;
  // persistent CTAs, one an SM, none without a row tile
  const int64_t row_tiles = (n + kDsRows - 1) / kDsRows;
  kernel<<<static_cast<unsigned>(row_tiles < sms ? row_tiles : sms),
           kDsThreads, kDsSmem, stream>>>(
      maps[0], maps[1], maps[2], maps[3], maps[4],
      static_cast<const __nv_bfloat16 *>(beta), static_cast<float *>(dn_sums),
      static_cast<float *>(work), static_cast<int>(n), C, live);
  return counted(kDxStream);
}

// The bf16 dx route, a rule on shape and alignment alone: the widths of
// the zoo's AMP training paths take gdn_bwd_dx_wide_kernel where the TMA
// can move their rows (16-byte rows and bases, row indices that fit an
// int); every other shape takes gdn_bwd_dx_stream_kernel.
bool dx_wide_route(const void *x, const void *g, const void *gamma,
                   const void *dx, const void *dn, int64_t n, int C) {
  return (C == 128 || C == 192) && hop::aligned16(x) &&
         hop::aligned16(g) && hop::aligned16(gamma) &&
         hop::aligned16(dx) && hop::aligned16(dn) &&
         n < (int64_t{1} << 31);
}

// Where gdn_bwd_dx_stream_kernel reads x, g and gamma and writes dx and
// dn: the tensors themselves where the TMA can address them (C % 8 == 0,
// 16-byte aligned bases), else copies in the scratch, in rows of round8(C)
// elements: x, g, dx, dn, then gamma, each only if it is copied; the
// workspace follows them.
struct DxStaging {
  int width;
  bool x, g, dx, dn, gamma;
  int64_t copies(int64_t n) const {
    return 2 * static_cast<int64_t>(width) *
           ((x + g + dx + dn) * n + (gamma ? width : 0));
  }
};

DxStaging dx_staging_of(const void *x, const void *g, const void *gamma,
                        const void *dx, const void *dn, int C) {
  const int width = (C + 7) / 8 * 8;
  const bool pad = width != C;
  return {width, pad || !hop::aligned16(x), pad || !hop::aligned16(g),
          pad || !hop::aligned16(dx), pad || !hop::aligned16(dn),
          pad || !hop::aligned16(gamma)};
}

// The workspace bytes: one per CTA of the largest launch
int64_t ds_work_bytes(int64_t n, int C, int sms) {
  const int64_t rows = n < kDsLaunchRows ? n : kDsLaunchRows;
  const int64_t tiles = (rows + kDsRows - 1) / kDsRows;
  return (tiles < sms ? tiles : sms) * ds_work_floats(C) * 4;
}

template <bool kInverse>
cudaError_t launch_dx_bf16(const void *x, const void *g, const void *gamma,
                           const void *beta, void *dx, void *dn,
                           void *dn_sums, int64_t n, int C, void *scratch,
                           cudaStream_t stream) {
  const bool tma = dx_wide_route(x, g, gamma, dx, dn, n, C);
  if (tma && C == 192)
    return launch_dx_wide_as<kInverse, 192>(x, g, gamma, beta, dx, dn,
                                            dn_sums, n, stream);
  if (tma && C == 128)
    return launch_dx_wide_as<kInverse, 128>(x, g, gamma, beta, dx, dn,
                                            dn_sums, n, stream);
  const int sms = hop::sm_count();
  if (!sms) return cudaErrorNoDevice;
  const DxStaging st = dx_staging_of(x, g, gamma, dx, dn, C);
  if (!scratch || !hop::aligned16(scratch)) return cudaErrorInvalidValue;
  char *at = static_cast<char *>(scratch);
  const size_t row = 2 * static_cast<size_t>(C);  // bytes of a row of C
  const size_t wide = 2 * static_cast<size_t>(st.width);
  cudaError_t err = cudaSuccess;
  // x and g into rows of width, zeros past C
  auto copy_in = [&](bool copied, const void *src) {
    if (!copied) return src;
    if (wide > row && err == cudaSuccess)
      err = cudaMemset2DAsync(at + row, wide, 0, wide - row, n, stream);
    if (err == cudaSuccess)
      err = cudaMemcpy2DAsync(at, wide, src, row, row, n,
                              cudaMemcpyDeviceToDevice, stream);
    const void *to = at;
    at += wide * n;
    return to;
  };
  const void *xs = copy_in(st.x, x);
  const void *gs = copy_in(st.g, g);
  void *dxs = dx, *dns = dn;
  if (st.dx) dxs = at, at += wide * n;
  if (st.dn) dns = at, at += wide * n;
  const void *gam = gamma;
  if (st.gamma) {  // gamma, zeros past C both ways
    if (err == cudaSuccess)
      err = cudaMemsetAsync(at, 0, wide * st.width, stream);
    if (err == cudaSuccess)
      err = cudaMemcpy2DAsync(at, wide, gamma, row, row, C,
                              cudaMemcpyDeviceToDevice, stream);
    gam = at;
    at += wide * st.width;
  }
  if (err == cudaSuccess)
    err = launch_dx_stream<kInverse>(xs, gs, gam, beta, dxs, dns, dn_sums, at,
                                     n, st.width, C, sms, stream);
  if (err == cudaSuccess && st.dx)
    err = cudaMemcpy2DAsync(dx, row, dxs, wide, row, n,
                            cudaMemcpyDeviceToDevice, stream);
  if (err == cudaSuccess && st.dn)
    err = cudaMemcpy2DAsync(dn, row, dns, wide, row, n,
                            cudaMemcpyDeviceToDevice, stream);
  return err;
}

// The cluster size of the bf16 partials: the most ranks (up to kMaxSplit)
// that keep the grid within 132 CTAs, the H100's SM count. A rule on n and
// C alone, so the sums' order, and with it their bytes, never depends on
// the card.
int partials_split(int64_t n, int C) {
  const int64_t tiles = (C + kWideBlock - 1) / kWideBlock;
  const int64_t blocks = tiles * tiles * ((n + kChunkRows - 1) / kChunkRows);
  int split = 1;
  while (split < kMaxSplit && blocks * split * 2 <= 132) split *= 2;
  return split;
}

cudaError_t launch_partials_wide(const void *x, const void *dn,
                                 const void *dn_sums, void *partials,
                                 int64_t n, int C, cudaStream_t stream) {
  auto kernel = gdn_bwd_partials_wide_kernel;
  const size_t smem = kWideSmem + 1024;  // room to align the ring
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int tiles = (C + kWideBlock - 1) / kWideBlock;
  const int split = partials_split(n, C);
  // the TMA needs 16-byte rows and bases (and a row index that fits int);
  // other shapes take element copies
  const bool tma = C % 8 == 0 && hop::aligned16(x) &&
                   hop::aligned16(dn) && hop::aligned16(partials) &&
                   n < (int64_t{1} << 31);
  CUtensorMap x_map = {}, dn_map = {};
  if (tma) {
    if ((err = hop::box_map(&x_map, x, n, C)) != cudaSuccess) return err;
    if ((err = hop::box_map(&dn_map, dn, n, C)) != cudaSuccess) return err;
  }
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(static_cast<unsigned>(tiles * tiles * split),
                        static_cast<unsigned>((n + kChunkRows - 1) /
                                              kChunkRows));
  config.blockDim = dim3(kWideThreads);
  config.dynamicSmemBytes = smem;
  config.stream = stream;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = static_cast<unsigned>(split);
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = 1;
  config.attrs = cluster;
  config.numAttrs = 1;
  using T = __nv_bfloat16;
  err = cudaLaunchKernelEx(&config, kernel, x_map, dn_map,
                           static_cast<const T *>(x),
                           static_cast<const T *>(dn),
                           static_cast<const float *>(dn_sums),
                           static_cast<float *>(partials), n, C, split, tma);
  if (err != cudaSuccess) return err;
  return counted(kPartialsWide);
}

template <typename T, int kVec>
cudaError_t launch_reduce_as(const void *partials, void *dbeta, void *dgamma,
                             int64_t chunks, int C, cudaStream_t stream) {
  const int64_t threads = (static_cast<int64_t>(C) * C + C + kVec - 1) / kVec;
  // the widest CTAs that still give every SM one (the copies in flight are
  // what bounds the sum, and an idle SM issues none)
  int sms = hop::sm_count();
  if (!sms) sms = 132;
  int block = kReduceThreads;
  while (block > 32 && (threads + block - 1) / block < sms) block /= 2;
  const int64_t blocks = (threads + block - 1) / block;
  auto kernel = gdn_bwd_reduce_kernel<T, kVec>;
  constexpr int most =
      kReduceStages * kReduceChunks * kReduceThreads * kVec * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, most);
  if (err != cudaSuccess) return err;
  const size_t smem = static_cast<size_t>(kReduceStages) * kReduceChunks *
                      block * kVec * sizeof(float);
  kernel<<<static_cast<unsigned>(blocks), block, smem, stream>>>(
      static_cast<const float *>(partials), static_cast<T *>(dbeta),
      static_cast<T *>(dgamma), chunks, C);
  return counted(kReduce);
}

template <typename T>
cudaError_t launch_reduce(const void *partials, void *dbeta, void *dgamma,
                          int64_t chunks, int C, cudaStream_t stream) {
  // 4 neighbouring elements lie in one output when C % 4 == 0
  if (C % 4 == 0 && hop::aligned16(partials))
    return launch_reduce_as<T, 4>(partials, dbeta, dgamma, chunks, C, stream);
  return launch_reduce_as<T, 1>(partials, dbeta, dgamma, chunks, C, stream);
}

}  // namespace

extern "C" {

// Rows per partial sum: gdn_bwd_partials writes ceil(n / this) partials of
// C*C + C floats each.
int lmic_gdn_bwd_chunk_rows() { return kChunkRows; }

// Rows per tile of the bf16 dx pass: it writes ceil(n / this) rows of C
// f32 sums of dn, one per tile, in tile order.
int lmic_gdn_bwd_tile_rows() { return hop::kTileRows; }

// The bytes of scratch that lmic_gdn_bwd_dx needs for these operands on
// the current device: 0 where no kernel needs any (float32 up to 384
// channels, float32 past it with C % 4 == 0 and 16-byte aligned x, gamma
// and dn, bfloat16 on gdn_bwd_dx_wide_kernel's route), else room for the
// zero-padded copies gdn_bwd_dx_f32_blocked_kernel runs on (float32), or
// gdn_bwd_dx_stream_kernel's workspace and room for the copies it runs on
// (bfloat16); -1 if the runtime cannot give the device's SM count.
int64_t lmic_gdn_bwd_dx_scratch_bytes(const void *x, const void *g,
                                      const void *gamma, const void *dx,
                                      const void *dn, int64_t n, int C,
                                      int dtype) {
  if (n <= 0 || C <= 0) return 0;
  if (dtype == 0)
    return C > f32::kWholeWidth ? dx_f32_staging_of(x, gamma, dn, C).bytes(n)
                                : 0;
  if (dtype != 1 || dx_wide_route(x, g, gamma, dx, dn, n, C)) return 0;
  const int sms = hop::sm_count();
  if (!sms) return -1;
  return dx_staging_of(x, g, gamma, dx, dn, C).copies(n) +
         ds_work_bytes(n, C, sms);
}

// x, g, dx: (n, C) contiguous; gamma_t: gamma transposed, (C_in, C_out),
// read for float32 only (bfloat16 may pass any pointer), 16-byte aligned
// past 384 channels where C % 4 == 0 and gamma is;
// gamma: (C_out, C_in); beta: (C,); all of one type (0 = float32,
// 1 = bfloat16). dn: (n, C) scratch, float32 for float32 and bfloat16
// (dn rounded as the products take it) for bfloat16. dn_sums: for
// bfloat16, (ceil(n / lmic_gdn_bwd_tile_rows()), C) float32, each tile's
// sum of the f32 dn over its rows; not read or written for float32 (may be
// null). scratch: 16-byte aligned, at least lmic_gdn_bwd_dx_scratch_bytes
// bytes (null where that is 0). Each entry point launches on `stream`
// without synchronising and returns cudaGetLastError() after the launch
// (0 on success).
int lmic_gdn_bwd_dx(const void *x, const void *g, const void *gamma_t,
                    const void *gamma, const void *beta, void *dx, void *dn,
                    void *dn_sums, int64_t n, int C, int dtype, int inverse,
                    void *scratch, void *stream) {
  if (n <= 0) return 0;
  if (C <= 0 || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) {
    err = inverse ? launch_dx<true>(x, g, gamma_t, gamma, beta, dx, dn, n, C,
                                    scratch, s)
                  : launch_dx<false>(x, g, gamma_t, gamma, beta, dx, dn, n,
                                     C, scratch, s);
  } else {
    err = inverse ? launch_dx_bf16<true>(x, g, gamma, beta, dx, dn, dn_sums,
                                         n, C, scratch, s)
                  : launch_dx_bf16<false>(x, g, gamma, beta, dx, dn, dn_sums,
                                          n, C, scratch, s);
  }
  return static_cast<int>(err);
}

// partials: (ceil(n / lmic_gdn_bwd_chunk_rows()), C*C + C) float32; row k
// holds chunk k's dgamma (C*C, row-major) then its dbeta (C). dn and
// dn_sums as lmic_gdn_bwd_dx wrote them.
int lmic_gdn_bwd_partials(const void *x, const void *dn, const void *dn_sums,
                          void *partials, int64_t n, int C, int dtype,
                          void *stream) {
  if (n <= 0) return 0;
  if (C <= 0) return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_partials(x, dn, partials, n, C, s);
  if (dtype == 1)
    return launch_partials_wide(x, dn, dn_sums, partials, n, C, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// dbeta (C,), dgamma (C, C) of the input type: the sum of `chunks` partials
// in chunk order (zeros when chunks is 0).
int lmic_gdn_bwd_reduce(const void *partials, void *dbeta, void *dgamma,
                        int64_t chunks, int C, int dtype, void *stream) {
  if (C <= 0) return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_reduce<float>(partials, dbeta, dgamma, chunks, C, s);
  if (dtype == 1)
    return launch_reduce<__nv_bfloat16>(partials, dbeta, dgamma, chunks, C,
                                        s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The name of kernel k of this library (null past the last) and its
// launches so far, counted where each launch succeeded.
const char *lmic_gdn_bwd_kernel_name(int k) {
  return k >= 0 && k < kKernels ? kKernelNames[k] : nullptr;
}

int64_t lmic_gdn_bwd_kernel_launches(int k) {
  return k >= 0 && k < kKernels ? launches[k].load() : 0;
}

const char *lmic_gdn_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
