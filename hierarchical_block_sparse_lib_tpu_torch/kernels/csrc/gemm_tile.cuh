// The 128x128 output tile shared by the port's GEMM kernels at 128-wide
// and wider leaves (gemm_rows.cu, gemm_stream.cu, gemm_groups.cu).
//
// One 256-thread block owns one 128x128 tile of an output block and keeps
// it in f32 registers, an 8x8 tile per thread.  A leaf product is taken in
// k-slices: each slice of A (transposed, rows padded) and of B is staged
// in shared memory in the precision tier's form, then every thread does
// 64 FFMA per 16 values it reads from shared memory.  The sum over a
// block's products is serial and uses no atomics, so a fixed structure
// gives bitwise-equal results.
//
// Precision tiers (the reference's, kernels/mxu.py):
//   MODE 0 "highest": operands as stored (bf16 widened exactly), FP32 FFMA;
//   MODE 1 "high":    f32 operands split as x = hi + lo with hi = bf16(x),
//                     lo = bf16(x - hi); hi*hi + hi*lo + lo*hi per term;
//   MODE 2 "default": f32 operands rounded to bf16, f32 products and sums.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace hbsm {

constexpr int kTile = 128;  // output tile edge: leaves are multiples of it
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPad = 4;  // row padding of the transposed A slice
constexpr int kSentinel = 0x7fffffff;

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

template <int MODE>
struct Tile {
  // k-slice depth: the split tier keeps hi and lo copies of both slices.
  static constexpr int KS = MODE == 1 ? 16 : 32;
  float a[KS][kTile + kPad];  // A slice, transposed: a[kk][row]
  float b[KS][kTile];         // B slice: b[kk][col]
  float a_lo[MODE == 1 ? KS : 1][kTile + kPad];
  float b_lo[MODE == 1 ? KS : 1][kTile];
};

// Stage value x of a slice at [kk][idx] in the tier's form.
template <int MODE, int W>
__device__ __forceinline__ void put(float (*hi)[W], float (*lo)[W], int kk,
                                    int idx, float x) {
  if (MODE == 1) {
    const float h = bf16_round(x);
    hi[kk][idx] = h;
    lo[kk][idx] = bf16_round(x - h);
  } else {
    hi[kk][idx] = MODE == 2 ? bf16_round(x) : x;
  }
}

__device__ __forceinline__ void load8(float* v, const float* row, int t) {
  const float4 p = *reinterpret_cast<const float4*>(row + t * 4);
  const float4 q = *reinterpret_cast<const float4*>(row + 64 + t * 4);
  v[0] = p.x; v[1] = p.y; v[2] = p.z; v[3] = p.w;
  v[4] = q.x; v[5] = q.y; v[6] = q.z; v[7] = q.w;
}

// Row (or column) of the tile that entry r of a thread's 8x8 tile covers:
// thread (ty, tx) holds rows ty*4 + {0..3} and 64 + ty*4 + {0..3}, and
// the same pattern of columns with tx.
__device__ __forceinline__ int tile_row(int t, int r) {
  return t * 4 + (r >> 2) * 64 + (r & 3);
}

// acc[r][c] += sum_kk A(row_r, kk) B(kk, col_c) over the staged slice.
template <int MODE>
__device__ __forceinline__ void multiply_slice(float (&acc)[8][8],
                                               const Tile<MODE>& s, int ty,
                                               int tx) {
#pragma unroll 4
  for (int kk = 0; kk < Tile<MODE>::KS; ++kk) {
    float a[8], b[8];
    load8(a, s.a[kk], ty);
    load8(b, s.b[kk], tx);
    if (MODE == 1) {
      float al[8], bl[8];
      load8(al, s.a_lo[kk], ty);
      load8(bl, s.b_lo[kk], tx);
#pragma unroll
      for (int r = 0; r < 8; ++r) {
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          acc[r][c] = fmaf(a[r], b[c],
                           fmaf(al[r], b[c], fmaf(a[r], bl[c], acc[r][c])));
        }
      }
    } else {
#pragma unroll
      for (int r = 0; r < 8; ++r) {
#pragma unroll
        for (int c = 0; c < 8; ++c) acc[r][c] = fmaf(a[r], b[c], acc[r][c]);
      }
    }
  }
}

// acc += A_t @ B_t for one leaf product.  `a` points at the first of the
// tile's 128 rows of an A block, `b` at the first of its 128 columns of a B
// block; both blocks are row-major with row stride `ld`, which is also the
// product's depth.  Every thread of the block must call this.
template <typename T, int MODE>
__device__ __forceinline__ void accumulate_product(float (&acc)[8][8],
                                                   Tile<MODE>& s,
                                                   const T* __restrict__ a,
                                                   const T* __restrict__ b,
                                                   int ld, int ty, int tx) {
  constexpr int KS = Tile<MODE>::KS;
  for (int k0 = 0; k0 < ld; k0 += KS) {
    for (int v = threadIdx.x; v < KS * kTile; v += kThreads) {
      const int row = v / KS, kk = v % KS;  // A(row, k0 + kk)
      put<MODE>(s.a, s.a_lo, kk, row,
                widen(a[static_cast<size_t>(row) * ld + k0 + kk]));
      const int kb = v / kTile, col = v % kTile;  // B(k0 + kb, col)
      put<MODE>(s.b, s.b_lo, kb, col,
                widen(b[static_cast<size_t>(k0 + kb) * ld + col]));
    }
    __syncthreads();
    multiply_slice<MODE>(acc, s, ty, tx);
    __syncthreads();
  }
}

// The tile starts as zeros, or as the f32 tile at `src` (row stride ld).
__device__ __forceinline__ void load_tile(float (&acc)[8][8],
                                          const float* src, int ld, int ty,
                                          int tx) {
#pragma unroll
  for (int r = 0; r < 8; ++r) {
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      acc[r][c] = src != nullptr
                      ? src[static_cast<size_t>(tile_row(ty, r)) * ld +
                            tile_row(tx, c)]
                      : 0.f;
    }
  }
}

__device__ __forceinline__ void store_tile(float* dst,
                                           const float (&acc)[8][8], int ld,
                                           int ty, int tx) {
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    float* row = dst + static_cast<size_t>(tile_row(ty, r)) * ld;
    *reinterpret_cast<float4*>(row + tx * 4) =
        make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
    *reinterpret_cast<float4*>(row + 64 + tx * 4) =
        make_float4(acc[r][4], acc[r][5], acc[r][6], acc[r][7]);
  }
}

// First index in [lo, hi) of the sorted `col` that equals j, or -1.
__device__ __forceinline__ int find_sorted(const int* __restrict__ col,
                                           int lo, int hi, int j) {
  const int stop = hi;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (col[mid] < j) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo < stop && col[lo] == j ? lo : -1;
}

// Compact the block's hits (q >= 0) into hit_e/hit_q, keeping thread
// order, and return their number.  Every thread of the block must call it.
__device__ __forceinline__ int compact_hits(int e, int q, int* hit_e,
                                            int* hit_q, int* warp_hits) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const unsigned ball = __ballot_sync(0xffffffffu, q >= 0);
  if (lane == 0) warp_hits[warp] = __popc(ball);
  __syncthreads();
  int offset = 0, n_hits = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const int h = warp_hits[w];
    offset += w < warp ? h : 0;
    n_hits += h;
  }
  if (q >= 0) {
    const int slot = offset + __popc(ball & ((1u << lane) - 1u));
    hit_e[slot] = e;
    hit_q[slot] = q;
  }
  __syncthreads();
  return n_hits;
}

}  // namespace hbsm
