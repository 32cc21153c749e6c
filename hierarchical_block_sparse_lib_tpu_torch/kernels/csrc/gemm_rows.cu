// Row-panel SpGEMM for Hopper (sm_90a) at 128-wide leaves: C(i,j) =
// sum_k A(i,k) B(k,j) into the slots of a sorted output id list.
//
// Replaces hierarchical_block_sparse_lib_tpu/kernels/pallas_gemm_rows.py::
// rows_spgemm.  It computes what that kernel computes (same row tables,
// same clamp of B rows to the bucketed row cap, same output slots, a
// zero-filled tail, the SpAMM skip, the upper-triangle mode and the
// aligned accumulator) and none of its TPU formulation: no VMEM panels,
// DMA chains, pipeline tiers or panel-wide dots.
//
// Layout: canonical row-major 128x128 blocks, f32 or bf16; output f32.
//
// What bounds it: operations.  A 128-wide leaf product is 4.2 MFLOP
// against 128 KB of operands, so at the B3 shapes (4498 products per
// multiply) the floor is the FP32 FFMA rate.  One thread block of 256
// threads owns one output slot.  It finds the slot's products with one
// binary search per A entry of the row (spread over the threads,
// compacted in ascending A-entry order with a warp ballot), then for each
// product stages 32-deep k-slices of A (transposed) and B in shared
// memory and gives every thread an 8x8 tile of the 128x128 sum, kept in
// registers: 64 FFMA per 16 values read from shared memory.  Tensor
// cores (wgmma), TMA staging and panel reuse across a row are left to
// later work.
//
// Determinism: each slot is written once by one block that accumulates
// its products serially in ascending A-entry order, in f32 registers,
// with no atomics, so a fixed structure gives bitwise-equal results.
//
// Precision (the reference's three tiers, kernels/mxu.py):
//   0 "highest": operands as stored (bf16 widened exactly), FP32 FFMA;
//   1 "high":    f32 operands split as x = hi + lo with hi = bf16(x),
//                lo = bf16(x - hi); hi*hi + hi*lo + lo*hi per term;
//   2 "default": f32 operands rounded to bf16, f32 products and sums.

#include "gemm_tile.cuh"

namespace {

using namespace hbsm;

template <typename T, int MODE>
__global__ void __launch_bounds__(kThreads)
    rows_spgemm_kernel(const int* __restrict__ out_ids,
                       const int* __restrict__ a_row_start,
                       const int* __restrict__ a_col,
                       const int* __restrict__ b_row_start,
                       const int* __restrict__ b_col, const T* __restrict__ a,
                       const T* __restrict__ b,
                       const float* __restrict__ acc_data,
                       const float* __restrict__ an2,
                       const float* __restrict__ bn2,
                       const float* __restrict__ tau2_ptr, float tau2_val,
                       float* __restrict__ out, int nbr, int nbc,
                       int b_row_max, int triu) {
  __shared__ __align__(16) Tile<MODE> s;
  __shared__ int hit_e[kThreads];
  __shared__ int hit_q[kThreads];
  __shared__ int warp_hits[kWarps];

  const int ty = threadIdx.x >> 4;
  const int tx = threadIdx.x & 15;
  const size_t slot_off = static_cast<size_t>(blockIdx.x) * kTile * kTile;

  const int id = out_ids[blockIdx.x];
  const int i = id / nbc;
  const bool valid = id != kSentinel && i < nbr;
  float acc[8][8];
  load_tile(acc, valid && acc_data != nullptr ? acc_data + slot_off : nullptr,
            kTile, ty, tx);

  const int j = id - i * nbc;
  // Upper-triangle mode computes only slots with j >= i; the others keep
  // their initial value (zero, or the aligned accumulator).
  if (valid && !(triu && j < i)) {
    const float tau2 = tau2_ptr != nullptr ? *tau2_ptr : tau2_val;
    const int e_end = a_row_start[i + 1];
    for (int e0 = a_row_start[i]; e0 < e_end; e0 += kThreads) {
      // One A entry per thread: find B(k, j) among the first
      // min(count, b_row_max) entries of B's row k (the reference's row
      // cap; the caller flags longer rows).
      const int e = e0 + threadIdx.x;
      int q = -1;
      if (e < e_end) {
        const int k = a_col[e];
        const int start = b_row_start[k];
        q = find_sorted(b_col, start,
                        start + min(b_row_start[k + 1] - start, b_row_max), j);
        // SpAMM skip: the reference kernel's exact f32 test.
        if (q >= 0 && an2 != nullptr && !(an2[e] * bn2[q] > tau2)) q = -1;
      }
      // Products in ascending A-entry order.
      const int n_hits = compact_hits(e, q, hit_e, hit_q, warp_hits);
      for (int h = 0; h < n_hits; ++h) {
        accumulate_product<T, MODE>(
            acc, s, a + static_cast<size_t>(hit_e[h]) * kTile * kTile,
            b + static_cast<size_t>(hit_q[h]) * kTile * kTile, kTile, ty, tx);
      }
    }
  }
  // Every slot is written: SENTINEL tail slots as zeros.
  store_tile(out + slot_off, acc, kTile, ty, tx);
}

template <typename T, int MODE>
int launch(const int* out_ids, const int* a_row_start, const int* a_col,
           const int* b_row_start, const int* b_col, const void* a,
           const void* b, const float* acc_data, const float* an2,
           const float* bn2, const float* tau2_ptr, float tau2_val,
           float* out, int out_cap, int nbr, int nbc, int b_row_max,
           int triu, cudaStream_t stream) {
  rows_spgemm_kernel<T, MODE><<<out_cap, kThreads, 0, stream>>>(
      out_ids, a_row_start, a_col, b_row_start, b_col,
      static_cast<const T*>(a), static_cast<const T*>(b), acc_data, an2, bn2,
      tau2_ptr, tau2_val, out, nbr, nbc, b_row_max, triu);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// Every pointer is device memory: ids and tables int32; `a`/`b` f32
// (is_bf16 == 0) or bf16 [cap, 128, 128]; `out` f32 [out_cap, 128, 128].
// Optional (null when unused): `acc_data` f32 [out_cap, 128, 128], the
// aligned accumulator each valid slot starts from; `an2`/`bn2` f32 block
// norms^2 of the SpAMM skip with tau^2 at `tau2_ptr` (device) or, when
// that is null, `tau2_val`.  precision: 0 highest, 1 high, 2 default (bf16
// data takes 0: its products are exact in f32).
int hbsm_rows_spgemm(const int* out_ids, const int* a_row_start,
                     const int* a_col, const int* b_row_start,
                     const int* b_col, const void* a, const void* b,
                     const float* acc_data, const float* an2,
                     const float* bn2, const float* tau2_ptr, float tau2_val,
                     float* out, int out_cap, int nbr, int nbc, int b_row_max,
                     int triu, int block_size, int is_bf16, int precision,
                     void* stream) {
  if (out_cap == 0) return 0;
  if (block_size != kTile) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    return launch<__nv_bfloat16, 0>(out_ids, a_row_start, a_col, b_row_start,
                                    b_col, a, b, acc_data, an2, bn2, tau2_ptr,
                                    tau2_val, out, out_cap, nbr, nbc,
                                    b_row_max, triu, st);
  }
  switch (precision) {
    case 0:
      return launch<float, 0>(out_ids, a_row_start, a_col, b_row_start,
                              b_col, a, b, acc_data, an2, bn2, tau2_ptr,
                              tau2_val, out, out_cap, nbr, nbc, b_row_max,
                              triu, st);
    case 1:
      return launch<float, 1>(out_ids, a_row_start, a_col, b_row_start,
                              b_col, a, b, acc_data, an2, bn2, tau2_ptr,
                              tau2_val, out, out_cap, nbr, nbc, b_row_max,
                              triu, st);
    case 2:
      return launch<float, 2>(out_ids, a_row_start, a_col, b_row_start,
                              b_col, a, b, acc_data, an2, bn2, tau2_ptr,
                              tau2_val, out, out_cap, nbr, nbc, b_row_max,
                              triu, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* hbsm_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
