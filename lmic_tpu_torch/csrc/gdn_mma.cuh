// Tensor-core building blocks of the bf16 GDN / IGDN kernels, Hopper
// (sm_90a): the padding and the 16-byte loads and stores of gdn_bwd.cu
// (gdn_fwd.cu takes aligned16, pack2 and kSmemLimit from here), and the
// 64-row CTA products of gdn_bwd_dx_mma_kernel,
// which takes the bf16 dx shapes outside the TMA's route (C other than 128
// and 192, rows that are not 16-byte aligned).
//
// In bf16 the GDN products are bound by bytes, not operations: at
// 262,144 x 192 the backward's three products are 58 GFLOP, 0.06 ms at the
// H100's 989 TFLOP/s, against 0.09 ms to move x, g and dx once. Warp-level
// products (nvcuda::wmma 16x16x16 bf16 fragments with f32 sums, compiled
// to HMMA) on synchronous loads do not reach that byte rate: streaming the
// weight from L2 for every tile and waiting on every load, the mma kernel
// took 1.744 ms of a training step at C = 192 against a 0.318 ms bound
// (an H100 80GB HBM3 at 700 W; PERF.md).
// The main path's widths therefore run gdn_bwd_dx_wide_kernel (TMA and
// wgmma, csrc/gdn_hopper.cuh); this design stays for the other shapes:
//  - a CTA of 8 warps takes kTileRows = 64 rows; x^2 for them is staged once
//    in shared memory as bf16 ([kTileRows][Cp + 8]), squared and rounded while
//    staging, as the TPU kernel rounds x * x in bf16;
//  - the C x C weight (gamma^T for the norm, gamma for dn . gamma) is
//    streamed from L2 in panels of kPanel = 64 output columns
//    ([Cp][72] bf16); every warp takes a 16 x 32 block of the 64 x 64
//    product (4 row strips x 2 column halves) and sums it over k = 0..Cp-1
//    in steps of 16, in that order: the same bytes on every launch;
//  - each panel's f32 sums go through shared memory (store_matrix_sync
//    over the panel, which the warps have finished reading) to an
//    elementwise epilogue that reads and writes 16-byte vectors.
// C that is not a multiple of 16 is zero-padded to Cp in shared memory:
// the padding adds exact zeros. Row strides of an odd number of 16-byte
// units (Cp + 8, 72) keep the fragment loads free of bank conflicts.

#pragma once

#include <cuda_bf16.h>
#include <mma.h>

#include <cstdint>

namespace gdn_mma {

using bf16 = __nv_bfloat16;
namespace wmma = nvcuda::wmma;

constexpr int kTileRows = 64;              // rows per CTA
constexpr int kPanel = 64;             // output columns per panel
constexpr int kMmaThreads = 256;          // 8 warps: 4 row strips x 2 halves
constexpr int kPanelLd = kPanel + 8;   // bf16 per staged panel row
constexpr int kAccLd = kPanel + 4;     // f32 per row of a panel's sums
constexpr int kSmemLimit = 232448;     // bytes a Hopper CTA may use

using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16,
                             wmma::row_major>;
using FragB = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16,
                             wmma::row_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

// C rounded up to the products' depth step
__host__ __device__ constexpr int padded(int C) { return (C + 15) / 16 * 16; }

// bf16 per staged row of a kTileRows x Cp tile
__host__ __device__ constexpr int tile_ld(int Cp) { return Cp + 8; }

// bytes of a panel region: the panel, then the f32 sums it produced
__host__ __device__ constexpr int panel_bytes(int Cp) {
  return Cp * kPanelLd * 2 > kTileRows * kAccLd * 4 ? Cp * kPanelLd * 2
                                                : kTileRows * kAccLd * 4;
}

__host__ inline bool aligned16(const void *p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

__device__ __forceinline__ unsigned pack2(float a, float b) {
  return static_cast<unsigned>(__bfloat16_as_ushort(__float2bfloat16(a))) |
         (static_cast<unsigned>(__bfloat16_as_ushort(__float2bfloat16(b)))
          << 16);
}

// eight floats rounded to bf16, in memory order
__device__ __forceinline__ uint4 pack8(const float (&v)[8]) {
  return make_uint4(pack2(v[0], v[1]), pack2(v[2], v[3]), pack2(v[4], v[5]),
                    pack2(v[6], v[7]));
}

// p[0 .. valid-1] as raw bf16, zeros past `valid`; one 16-byte load when
// `vec` (p 16-byte aligned) and the chunk is whole
__device__ __forceinline__ uint4 load8_raw(const bf16 *__restrict__ p,
                                           int valid, bool vec) {
  if (vec && valid >= 8) return __ldg(reinterpret_cast<const uint4 *>(p));
  unsigned w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int i = 0; i < 8; ++i)
    if (i < valid)
      w[i / 2] |= static_cast<unsigned>(__bfloat16_as_ushort(p[i]))
                  << (16 * (i % 2));
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// bf16 -> f32 is exact: the bits shifted into the high half
__device__ __forceinline__ void load8(const bf16 *__restrict__ p, int valid,
                                      bool vec, float (&v)[8]) {
  const uint4 u = load8_raw(p, valid, vec);
  const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = __uint_as_float(w[i] << 16);
    v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ void load8(const float *__restrict__ p, int valid,
                                      bool vec, float (&v)[8]) {
  if (vec && valid >= 8) {
    const float4 a = __ldg(reinterpret_cast<const float4 *>(p));
    const float4 b = __ldg(reinterpret_cast<const float4 *>(p) + 1);
    v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
    v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
    return;
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) v[i] = i < valid ? p[i] : 0.f;
}

// p[0 .. valid-1] = v rounded to bf16
__device__ __forceinline__ void store8(bf16 *p, int valid, bool vec,
                                       const float (&v)[8]) {
  if (vec && valid >= 8) {
    *reinterpret_cast<uint4 *>(p) = pack8(v);
    return;
  }
#pragma unroll
  for (int i = 0; i < 8; ++i)
    if (i < valid) p[i] = __float2bfloat16(v[i]);
}

__device__ __forceinline__ void store8(float *p, int valid, bool vec,
                                       const float (&v)[8]) {
  if (vec && valid >= 8) {
    reinterpret_cast<float4 *>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
    reinterpret_cast<float4 *>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
    return;
  }
#pragma unroll
  for (int i = 0; i < 8; ++i)
    if (i < valid) p[i] = v[i];
}

// s[r][c] = bf16(x[row0 + r][c]^2) for r < rows and c < C, zeros elsewhere
// in the kTileRows x Cp tile (row stride tile_ld(Cp)). x*x of a bf16 value is
// exact in f32, so rounding it once is the TPU kernel's bf16 product.
__device__ __forceinline__ void stage_squares(bf16 *s,
                                              const bf16 *__restrict__ x,
                                              int64_t row0, int rows, int C,
                                              int Cp, bool vec) {
  const int chunks = Cp / 8;
  const int ld = tile_ld(Cp);
#pragma unroll 4
  for (int e = threadIdx.x; e < kTileRows * chunks; e += kMmaThreads) {
    const int r = e / chunks;
    const int c = (e - r * chunks) * 8;
    float v[8];
    load8(x + (row0 + r) * C + c, r < rows ? C - c : 0, vec, v);
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] *= v[i];
    *reinterpret_cast<uint4 *>(s + r * ld + c) = pack8(v);
  }
}

// p[j][o] = w[j][o0 + o] for j < C and o0 + o < C, zeros elsewhere in the
// Cp x kPanel panel; w is C x C, row-major
__device__ __forceinline__ void stage_panel(bf16 *p,
                                            const bf16 *__restrict__ w,
                                            int o0, int C, int Cp,
                                            bool vec) {
  constexpr int chunks = kPanel / 8;
#pragma unroll 4
  for (int e = threadIdx.x; e < Cp * chunks; e += kMmaThreads) {
    const int j = e / chunks;
    const int o = (e % chunks) * 8;
    *reinterpret_cast<uint4 *>(p + j * kPanelLd + o) = load8_raw(
        w + static_cast<int64_t>(j) * C + o0 + o, j < C ? C - o0 - o : 0,
        vec);
  }
}

// This warp's 16 x 32 block of the kTileRows x kPanel product a . p, in two
// 16 x 16 fragments: a is the kTileRows x Cp tile, p the Cp x kPanel panel.
// k runs 0..Cp-1 in order, so every launch sums in the same order.
__device__ __forceinline__ void panel_product(FragC (&acc)[2], const bf16 *a,
                                              const bf16 *p, int Cp) {
  const int warp = threadIdx.x / 32;
  const int m0 = (warp % 4) * 16;
  const int n0 = (warp / 4) * 32;
  const int ld = tile_ld(Cp);
  wmma::fill_fragment(acc[0], 0.f);
  wmma::fill_fragment(acc[1], 0.f);
  for (int k = 0; k < Cp; k += 16) {
    FragA fa;
    wmma::load_matrix_sync(fa, a + m0 * ld + k, ld);
#pragma unroll
    for (int f = 0; f < 2; ++f) {
      FragB fb;
      wmma::load_matrix_sync(fb, p + k * kPanelLd + n0 + 16 * f, kPanelLd);
      wmma::mma_sync(acc[f], fa, fb, acc[f]);
    }
  }
}

// Stores this warp's block into an f32 tile whose column 0 is the panel's
// column `col0`; columns at or past `cols` are dropped.
__device__ __forceinline__ void store_block(float *t, int ld, int col0,
                                            int cols, const FragC (&acc)[2]) {
  const int warp = threadIdx.x / 32;
  const int m0 = (warp % 4) * 16;
  const int n0 = (warp / 4) * 32;
#pragma unroll
  for (int f = 0; f < 2; ++f)
    if (col0 + n0 + 16 * f < cols)
      wmma::store_matrix_sync(t + m0 * ld + col0 + n0 + 16 * f, acc[f], ld,
                              wmma::mem_row_major);
}

}  // namespace gdn_mma
