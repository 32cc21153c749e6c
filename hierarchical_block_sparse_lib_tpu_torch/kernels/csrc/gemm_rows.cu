// Row-panel SpGEMM for Hopper (sm_90a) at leaves that are a multiple of
// 128 wide: C(i,j) = sum_k A(i,k) B(k,j) into the slots of a sorted output
// id list.
//
// Replaces hierarchical_block_sparse_lib_tpu/kernels/pallas_gemm_rows.py::
// rows_spgemm.  It computes what that kernel computes (same row tables,
// same clamp of B rows to the bucketed row cap, same output slots, a
// zero-filled tail, the SpAMM skip, the upper-triangle mode and the
// aligned accumulator) and none of its TPU formulation: no VMEM panels,
// DMA chains, pipeline tiers or panel-wide dots.
//
// Layout: canonical row-major b x b blocks, b % 128 == 0, f32 or bf16;
// output f32.
//
// What bounds it: operations.  A 128-wide leaf product is 4.2 MFLOP
// against 128 KB of operands (a 256-wide one 33.5 MFLOP against 512 KB),
// so at the B3 shapes (4498 products per multiply) the floor is the
// tensor-core rate of the tier's passes (3xTF32 at "highest": 0.114 ms at
// step 2, where FP32 FFMA, the first design's engine, had 0.282).  A slot
// is cut into (b/128)(b/64) tiles of 128 rows x 64 columns, a 256-thread
// block each, the tiles of one slot next to each other in launch order so
// that they find the slot's A and B blocks in L2: at b = 128 two halves,
// 1 288 blocks at B3's 644 slots, 4.9 waves of the 264 that fit at two
// blocks an SM; at b = 256 eight tiles a slot.  Each block finds the
// slot's products with one binary search per A entry of the row (spread
// over the threads, compacted in ascending A-entry order with a warp
// ballot; every tile of a slot repeats it), then runs them through the
// ring engine of gemm_tile.cuh at depth b: their k-slices stream through
// a three-stage cp.async ring, one barrier a slice, the next product's
// first slices in flight under this one's math, into wgmma (3xTF32) or
// mma.sync (bf16 passes) fragments held in registers.  What is left: the
// passes' issue, about as much time again in the operand stream from L2
// (every tile of a slot reads its 128-row band of each A block and its
// 64-column band of each B block), and the hit search's serial start per
// tile.
//
// Determinism: each tile of a slot is written once by one block that
// accumulates its products serially in ascending A-entry order, k
// ascending within a product, in f32 registers, with no atomics, so a
// fixed structure gives bitwise-equal results.
//
// Precision (the reference's three tiers, kernels/mxu.py; the passes are
// gemm_tile.cuh's):
//   0 "highest": f32 data 3xTF32 (wgmma); bf16 data one exact bf16 pass;
//   1 "high":    f32 operands split as x = hi + lo with hi = bf16(x),
//                lo = bf16(x - hi); lo*hi + hi*lo + hi*hi, bf16 passes;
//   2 "default": f32 operands rounded to bf16, one bf16 pass.

#include "gemm_tile.cuh"

namespace {

using namespace hbsm;

template <typename T, int MODE>
__global__ void __launch_bounds__(kThreads, 2)
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
                       int b_row_max, int triu, int ld) {
  extern __shared__ __align__(16) unsigned char ring_bytes[];
  __shared__ int hit_e[kThreads];
  __shared__ int hit_q[kThreads];
  __shared__ int warp_hits[kWarps];
  T* ring = reinterpret_cast<T*>(ring_bytes);
  // Block tiles * slot + t: rows 128 * (t / nc) and columns 64 * (t % nc)
  // of the slot's ld x ld block, nc = ld / 64.  A slot's tiles are
  // neighbours in launch order, so the later ones find its operands in L2.
  // Offsets are 64-bit: at b = 256 an output of 16 384 slots is 4 GiB.
  const int nc = ld / kRingCols;
  const int tiles = ld / kTile * nc;
  const int slot = blockIdx.x / tiles;
  const int t = blockIdx.x % tiles;
  const size_t block = static_cast<size_t>(ld) * ld;
  const size_t a_off = static_cast<size_t>(t / nc) * kTile * ld;
  const size_t b_off = static_cast<size_t>(t % nc) * kRingCols;
  const size_t tile_off = slot * block + a_off + b_off;

  const int id = out_ids[slot];
  const int i = id / nbc;
  const bool valid = id != kSentinel && i < nbr;
  Frags acc;
  load_frags(acc, valid && acc_data != nullptr ? acc_data + tile_off : nullptr,
             ld);

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
      accumulate_ring<T, MODE>(acc, ring, n_hits, static_cast<size_t>(ld),
                               [&](int h) {
        return Operands<T>{a + hit_e[h] * block + a_off,
                           b + hit_q[h] * block + b_off};
      });
    }
  }
  // Every slot is written: SENTINEL tail slots as zeros.
  store_frags(out + tile_off, acc, ld);
}

struct Args {
  const int *out_ids, *a_row_start, *a_col, *b_row_start, *b_col;
  const void *a, *b;
  const float *acc_data, *an2, *bn2, *tau2_ptr;
  float tau2_val;
  float* out;
  int out_cap, nbr, nbc, b_row_max, triu, ld;
};

// Launches, or with `info` only reports the launch (launch_info).
template <typename T, int MODE>
int launch(const Args& r, cudaStream_t stream, int* info) {
  auto kernel = rows_spgemm_kernel<T, MODE>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Ring<T>::BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (info != nullptr) return launch_info(kernel, Ring<T>::BYTES, info);
  if (r.out_cap == 0) return 0;
  const int tiles = (r.ld / kTile) * (r.ld / kRingCols);
  kernel<<<r.out_cap * tiles, kThreads, Ring<T>::BYTES, stream>>>(
      r.out_ids, r.a_row_start, r.a_col, r.b_row_start, r.b_col,
      static_cast<const T*>(r.a), static_cast<const T*>(r.b), r.acc_data, r.an2,
      r.bn2, r.tau2_ptr, r.tau2_val, r.out, r.nbr, r.nbc, r.b_row_max, r.triu,
      r.ld);
  return static_cast<int>(cudaGetLastError());
}

int dispatch(const Args& r, int is_bf16, int precision, cudaStream_t stream,
             int* info) {
  if (is_bf16) return launch<__nv_bfloat16, 0>(r, stream, info);
  switch (precision) {
    case 0:
      return launch<float, 0>(r, stream, info);
    case 1:
      return launch<float, 1>(r, stream, info);
    case 2:
      return launch<float, 2>(r, stream, info);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// Every pointer is device memory: ids and tables int32; `a`/`b` f32
// (is_bf16 == 0) or bf16 [cap, b, b] with b = block_size, a positive
// multiple of 128; `out` f32 [out_cap, b, b].  Optional (null when
// unused): `acc_data` f32 [out_cap, b, b], the
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
  if (block_size <= 0 || block_size % kTile != 0 ||
      static_cast<long long>(out_cap) * (block_size / kTile) *
              (block_size / kRingCols) > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args r{out_ids, a_row_start, a_col, b_row_start, b_col, a, b,
               acc_data, an2, bn2, tau2_ptr, tau2_val, out, out_cap, nbr,
               nbc, b_row_max, triu, block_size};
  return dispatch(r, is_bf16, precision, static_cast<cudaStream_t>(stream),
                  nullptr);
}

// The launch `hbsm_rows_spgemm` makes for this data type and tier, without
// making it: info[0..4] = dynamic shared bytes, resident blocks per SM
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), registers and local
// (spill) bytes per thread, threads per block.  Returns a CUDA error code.
int hbsm_rows_spgemm_config(int is_bf16, int precision, int* info) {
  return dispatch(Args{}, is_bf16, precision, nullptr, info);
}

const char* hbsm_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
