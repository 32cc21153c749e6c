// Pair-stream gather-GEMM-accumulate for Hopper (sm_90a): for c-sorted
// block pairs, out[seg[p]] += A[a_idx[p]] @ B[b_idx[p]].
//
// Replaces hierarchical_block_sparse_lib_tpu/kernels/pallas_gemm_stream.py::
// gather_gemm_accumulate_stream, and through the wrapper of
// kernels/pallas_gemm.py also the v1 kernel
// hierarchical_block_sparse_lib_tpu/kernels/pallas_gemm.py::
// gather_gemm_accumulate (its chunked carry-in is `cin`).  It keeps the
// contract (pairs sorted by output slot, `seg == out_cap` for pairs with
// no slot, f32 output) and none of the TPU formulation: no DMA queue,
// alternating accumulators or SMEM pair windows.  It is stricter than the
// TPU kernel in one point: every slot is written, a slot no pair reaches
// as zero (or as its `cin` block), where the TPU leaves it undefined.
//
// Layout: canonical row-major b x b blocks, b a multiple of 128, f32 or
// bf16; output f32.  The wrapper turns the sorted `seg` into per-slot pair
// ranges (`slot_start`, out_cap + 1 entries) on the device.
//
// What bounds it: operations.  A 128-wide leaf product is 4.2 MFLOP
// against 128 KB of operands, so the floor is the FP32 FFMA rate.  One
// 256-thread block owns one 128x128 tile of one output slot (a b-wide
// slot has (b/128)^2 of them, blockIdx.y) and walks the slot's run of
// pairs in order, staging k-slices of both operands in shared memory and
// keeping the tile in registers (gemm_tile.cuh).  Tensor cores (wgmma),
// TMA staging and reuse of an operand across pairs are left to later
// work.
//
// Determinism: a slot's sum is serial in pair order, with no atomics, so
// a repeated call is bitwise equal, and a call split into chunks that
// carry the partial sums in `cin` equals one call.
//
// Precision: "highest" and "high" run MODE 0 (the reference maps "high"
// to HIGHEST here); "default" MODE 2 (operands rounded to bf16 once);
// bf16 storage MODE 0, which is exact.

#include "gemm_tile.cuh"

namespace {

using namespace hbsm;

template <typename T, int MODE>
__global__ void __launch_bounds__(kThreads)
    stream_kernel(const int* __restrict__ slot_start,
                  const int* __restrict__ a_idx, const int* __restrict__ b_idx,
                  const T* __restrict__ a, const T* __restrict__ b,
                  const float* __restrict__ cin, float* __restrict__ out,
                  int cap_a, int cap_b, int ld) {
  __shared__ __align__(16) Tile<MODE> s;
  const int ty = threadIdx.x >> 4;
  const int tx = threadIdx.x & 15;
  const int nt = ld / kTile;
  const size_t block = static_cast<size_t>(ld) * ld;
  const size_t a_off = static_cast<size_t>(blockIdx.y / nt) * kTile * ld;
  const size_t b_off = static_cast<size_t>(blockIdx.y % nt) * kTile;
  const size_t tile_off = blockIdx.x * block + a_off + b_off;

  float acc[8][8];
  load_tile(acc, cin != nullptr ? cin + tile_off : nullptr, ld, ty, tx);
  const int p_end = slot_start[blockIdx.x + 1];
  for (int p = slot_start[blockIdx.x]; p < p_end; ++p) {
    // Indices are clamped into the operands: a bad pair list gives wrong
    // values, never a read out of bounds.
    const int ia = min(max(a_idx[p], 0), cap_a - 1);
    const int ib = min(max(b_idx[p], 0), cap_b - 1);
    accumulate_product<T, MODE>(acc, s, a + ia * block + a_off,
                                b + ib * block + b_off, ld, ty, tx);
  }
  store_tile(out + tile_off, acc, ld, ty, tx);
}

template <typename T, int MODE>
int launch(const int* slot_start, const int* a_idx, const int* b_idx,
           const void* a, const void* b, const float* cin, float* out,
           int out_cap, int cap_a, int cap_b, int ld, cudaStream_t stream) {
  const int nt = ld / kTile;
  stream_kernel<T, MODE><<<dim3(out_cap, nt * nt), kThreads, 0, stream>>>(
      slot_start, a_idx, b_idx, static_cast<const T*>(a),
      static_cast<const T*>(b), cin, out, cap_a, cap_b, ld);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// Every pointer is device memory: `slot_start` int32 [out_cap + 1] (slot
// s takes pairs slot_start[s] .. slot_start[s+1] - 1), `a_idx`/`b_idx`
// int32 per pair; `a`/`b` f32 (is_bf16 == 0) or bf16 [cap, ld, ld];
// `out` f32 [out_cap, ld, ld]; `cin` (null when unused) f32 [out_cap, ld,
// ld], each slot's starting value.  precision: 0 highest, 2 default (the
// wrapper maps "high" to 0; bf16 data takes 0).
int hbsm_stream_gemm(const int* slot_start, const int* a_idx,
                     const int* b_idx, const void* a, const void* b,
                     const float* cin, float* out, int out_cap, int cap_a,
                     int cap_b, int block_size, int is_bf16, int precision,
                     void* stream) {
  if (out_cap == 0) return 0;
  if (block_size <= 0 || block_size % kTile != 0 || cap_a <= 0 || cap_b <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    return launch<__nv_bfloat16, 0>(slot_start, a_idx, b_idx, a, b, cin, out,
                                    out_cap, cap_a, cap_b, block_size, st);
  }
  switch (precision) {
    case 0:
      return launch<float, 0>(slot_start, a_idx, b_idx, a, b, cin, out,
                              out_cap, cap_a, cap_b, block_size, st);
    case 2:
      return launch<float, 2>(slot_start, a_idx, b_idx, a, b, cin, out,
                              out_cap, cap_a, cap_b, block_size, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* hbsm_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
