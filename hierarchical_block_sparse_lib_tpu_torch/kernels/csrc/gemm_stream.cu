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
// What bounds it: operations, and nearly as much the bytes.  A 128-wide
// leaf product is 4.2 MFLOP against 128 KB of operands, so the floor is
// the tensor-core rate of the tier's passes (3xTF32 at "highest": 0.131
// ms at B2-tile128, where FP32 FFMA, the first design's engine, had
// 0.323); the f32 output (289 MB there) and the operands once make 0.102
// ms of bytes.  One 256-thread block owns one 128x64 tile of one output
// slot (a b-wide slot has 2 (b/128)^2 of them, blockIdx.y) and runs the
// slot's pairs, in order, through the ring engine of gemm_tile.cuh: a
// three-stage cp.async ring of 128-byte k-slices, one barrier a slice, the
// next pair's slices in flight under this one's math, wgmma (3xTF32) or
// mma.sync (bf16 passes) fragments in registers, streaming stores.  Two
// blocks share an SM, so one block's ring fill and store run under the
// other's math: at 1.2 pairs a slot that overlap, not the ring, hides a
// tile's latency.  What is left: the operand stream from L2 (each pair's
// A block is read by both halves of its slot; loads and stores alone take
// three quarters of the call) and the passes' issue.
//
// Determinism: a slot's sum is serial in pair order, k ascending within
// a pair, with no atomics, so a repeated call is bitwise equal, and a call
// split into chunks that carry the partial sums in `cin` equals one call.
//
// Precision: "highest" and "high" run MODE 0 (the reference maps "high"
// to HIGHEST here): 3xTF32 on wgmma for f32 data; "default" MODE 2
// (operands rounded to bf16, one bf16 pass); bf16 storage MODE 0, one
// exact bf16 pass (gemm_tile.cuh).

#include "gemm_tile.cuh"

namespace {

using namespace hbsm;

template <typename T, int MODE>
__global__ void __launch_bounds__(kThreads, 2)
    stream_kernel(const int* __restrict__ slot_start,
                  const int* __restrict__ a_idx, const int* __restrict__ b_idx,
                  const T* __restrict__ a, const T* __restrict__ b,
                  const float* __restrict__ cin, float* __restrict__ out,
                  int cap_a, int cap_b, int ld) {
  extern __shared__ __align__(16) unsigned char ring_bytes[];
  T* ring = reinterpret_cast<T*>(ring_bytes);
  // Tile blockIdx.y of a slot: rows 128 * (y / nc) and columns 64 * (y % nc)
  // of the ld x ld block, nc = ld / 64.
  const int nc = ld / kRingCols;
  const size_t block = static_cast<size_t>(ld) * ld;
  const size_t a_off = static_cast<size_t>(blockIdx.y / nc) * kTile * ld;
  const size_t b_off = static_cast<size_t>(blockIdx.y % nc) * kRingCols;
  const size_t tile_off = blockIdx.x * block + a_off + b_off;

  Frags acc;
  load_frags(acc, cin != nullptr ? cin + tile_off : nullptr, ld);
  const int p0 = slot_start[blockIdx.x];
  accumulate_ring<T, MODE>(acc, ring, slot_start[blockIdx.x + 1] - p0,
                           static_cast<size_t>(ld), [&](int h) {
    // Indices are clamped into the operands: a bad pair list gives wrong
    // values, never a read out of bounds.
    const int ia = min(max(a_idx[p0 + h], 0), cap_a - 1);
    const int ib = min(max(b_idx[p0 + h], 0), cap_b - 1);
    return Operands<T>{a + ia * block + a_off, b + ib * block + b_off};
  });
  store_frags(out + tile_off, acc, ld);
}

struct Args {
  const int *slot_start, *a_idx, *b_idx;
  const void *a, *b;
  const float* cin;
  float* out;
  int out_cap, cap_a, cap_b, ld;
};

// Launches, or with `info` only reports the launch (launch_info).
template <typename T, int MODE>
int launch(const Args& r, cudaStream_t stream, int* info) {
  auto kernel = stream_kernel<T, MODE>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Ring<T>::BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (info != nullptr) return launch_info(kernel, Ring<T>::BYTES, info);
  if (r.out_cap == 0) return 0;
  const int tiles = (r.ld / kTile) * (r.ld / kRingCols);
  kernel<<<dim3(r.out_cap, tiles), kThreads, Ring<T>::BYTES, stream>>>(
      r.slot_start, r.a_idx, r.b_idx, static_cast<const T*>(r.a),
      static_cast<const T*>(r.b), r.cin, r.out, r.cap_a, r.cap_b, r.ld);
  return static_cast<int>(cudaGetLastError());
}

int dispatch(const Args& r, int is_bf16, int precision, cudaStream_t stream,
             int* info) {
  if (is_bf16) return launch<__nv_bfloat16, 0>(r, stream, info);
  switch (precision) {
    case 0:
      return launch<float, 0>(r, stream, info);
    case 2:
      return launch<float, 2>(r, stream, info);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
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
  const Args r{slot_start, a_idx, b_idx, a, b, cin, out, out_cap, cap_a, cap_b,
               block_size};
  return dispatch(r, is_bf16, precision, static_cast<cudaStream_t>(stream),
                  nullptr);
}

// The launch `hbsm_stream_gemm` makes for this data type and tier, without
// making it: info[0..4] as hbsm_rows_spgemm_config gives them.  Returns a
// CUDA error code.
int hbsm_stream_gemm_config(int is_bf16, int precision, int* info) {
  return dispatch(Args{}, is_bf16, precision, nullptr, info);
}

const char* hbsm_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
