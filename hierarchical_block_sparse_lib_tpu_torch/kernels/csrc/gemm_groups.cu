// Row-group SpGEMM for Hopper (sm_90a): C(i,j) = sum_k A(i,k) B(k,j) into
// the slots of a sorted output id list, with the B blocks of each group
// of G consecutive block rows read from that group's contiguous slab.
//
// Replaces hierarchical_block_sparse_lib_tpu/kernels/pallas_gemm_groups.py::
// groups_spgemm.  It computes what that kernel computes: the rows contract
// (exact slots per `out_ids`, a slot no product reaches is zero, SENTINEL
// tail slots zero) from the group tables the wrapper builds on the device
// (row starts, grp_a_start, slab_lo), with the TPU kernel's clamps to the
// bucketed group caps: an A entry's position in its group is clipped to
// a_grp_max - 1, a B panel's offset in the slab to slab_max - 1 and its
// length to slab_max - offset.  An undersized cap therefore gives wrong
// values that stay in bounds, and spgemm's group check flags it.  None of
// the TPU formulation is kept: no VMEM slabs, pow2 DMA chains, pipeline
// parities or column->slot table.
//
// Layout: canonical row-major b x b blocks, b a multiple of 128, f32 or
// bf16; output f32.
//
// What bounds it: operations.  A 128-wide leaf product is 4.2 MFLOP
// against 128 KB of operands, so the floor is the tensor-core rate of the
// tier's passes (3xTF32 at "highest": 7.07 us at B1's 278 products, where
// FP32 FFMA, the first design's engine, had 17.4).  A slot of a b-wide
// block is split into 2 (b/128)^2 tiles of 128x64, a 256-thread block
// each, the tiles of one slot next to each other in launch order.  Slots
// are sorted by row, so the blocks of one group run together and read
// that group's B slab from L2, which takes the place of the TPU's VMEM
// slab.  Each block finds its slot's products with one binary search per
// A entry of the row (spread over the threads, compacted in ascending
// A-entry order with a warp ballot), then runs them through the ring
// engine of gemm_tile.cuh: their k-slices stream through a three-stage
// cp.async ring, one barrier a slice, the next product's first slices in
// flight under this one's math, into wgmma (3xTF32) or mma.sync (bf16
// passes) fragments held in registers.  Two blocks share an SM.  What is
// left: at B1 308 blocks fill 1.17 waves of the 264 resident, at 1.8
// products a slot, so the ring's fill per slot and the last wave's tail
// weigh as much as the passes.  A slot has its own blocks, so the C group
// cap bounds nothing here (the caller still flags groups above it).
//
// Determinism: each tile is written once by one block that accumulates
// its products serially in ascending A-entry order, k ascending within a
// product, in f32 registers, with no atomics, so a fixed structure gives
// bitwise-equal results.  At b = 128 the tile split, the hit order and the
// slice math are those of gemm_rows.cu and of the pair stream, so the
// three backends give the same bits.
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
    groups_kernel(const int* __restrict__ out_ids,
                  const int* __restrict__ a_row_start,
                  const int* __restrict__ a_col,
                  const int* __restrict__ b_row_start,
                  const int* __restrict__ b_col,
                  const int* __restrict__ grp_a_start,
                  const int* __restrict__ slab_lo, const T* __restrict__ a,
                  const T* __restrict__ b, float* __restrict__ out, int nbr,
                  int nbc, int g_rows, int a_grp_max, int slab_max,
                  int cap_b, int ld) {
  extern __shared__ __align__(16) unsigned char ring_bytes[];
  __shared__ int hit_e[kThreads];
  __shared__ int hit_q[kThreads];
  __shared__ int warp_hits[kWarps];
  T* ring = reinterpret_cast<T*>(ring_bytes);
  // Block tiles * slot + y: rows 128 * (y / nc) and columns 64 * (y % nc)
  // of the slot's ld x ld block, nc = ld / 64.  A slot's tiles are
  // neighbours in launch order, so the later ones find its operands in L2.
  const int nc = ld / kRingCols;
  const int tiles = (ld / kTile) * nc;
  const int slot = blockIdx.x / tiles;
  const int y = blockIdx.x - slot * tiles;
  const int block_elems = ld * ld;
  const T* a_tile = a + static_cast<size_t>(y / nc) * kTile * ld;
  const T* b_tile = b + (y % nc) * kRingCols;
  float* dst = out + static_cast<size_t>(slot) * block_elems +
               static_cast<size_t>(y / nc) * kTile * ld + (y % nc) * kRingCols;

  const int id = out_ids[slot];
  const int i = id / nbc;
  Frags acc;
  load_frags(acc, nullptr, ld);
  if (id != kSentinel && i < nbr) {
    const int j = id - i * nbc;
    const int g = i / g_rows;
    const int a_lo = grp_a_start[g];
    const int s_lo = slab_lo[g];
    const int e_end = a_row_start[i + 1];
    for (int e0 = a_row_start[i]; e0 < e_end; e0 += kThreads) {
      // One A entry per thread; the TPU kernel's clamps decide which A
      // block and which slab blocks it sees.
      const int e = e0 + threadIdx.x;
      int ea = -1, q = -1;
      if (e < e_end) {
        ea = a_lo + min(max(e - a_lo, 0), a_grp_max - 1);
        const int k = a_col[e];
        const int blo = b_row_start[k];
        const int poff = min(max(blo - s_lo, 0), slab_max - 1);
        const int bcnt = min(b_row_start[k + 1] - blo, slab_max - poff);
        const int t = find_sorted(b_col, blo, blo + bcnt, j);
        if (t >= 0) q = min(s_lo + poff + (t - blo), cap_b - 1);
      }
      // Products in ascending A-entry order; operand offsets in 32 bits
      // (the clamps' state held across the ring leaves no registers for
      // 64-bit ones).
      const int n_hits = compact_hits(ea, q, hit_e, hit_q, warp_hits);
      accumulate_ring<T, MODE>(acc, ring, n_hits, ld, [&](int h) {
        return Operands<T>{a_tile + static_cast<size_t>(hit_e[h]) * block_elems,
                           b_tile + static_cast<size_t>(hit_q[h]) * block_elems};
      });
    }
  }
  // Every slot is written: union slots with no product and SENTINEL tail
  // slots as zeros.
  store_frags(dst, acc, ld);
}

struct Args {
  const int *out_ids, *a_row_start, *a_col, *b_row_start, *b_col,
      *grp_a_start, *slab_lo;
  const void *a, *b;
  float* out;
  int out_cap, nbr, nbc, g_rows, a_grp_max, slab_max, cap_b, ld;
};

// Launches, or with `info` only reports the launch (launch_info).
template <typename T, int MODE>
int launch(const Args& r, cudaStream_t stream, int* info) {
  auto kernel = groups_kernel<T, MODE>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Ring<T>::BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (info != nullptr) return launch_info(kernel, Ring<T>::BYTES, info);
  if (r.out_cap == 0) return 0;
  const int tiles = (r.ld / kTile) * (r.ld / kRingCols);
  kernel<<<r.out_cap * tiles, kThreads, Ring<T>::BYTES, stream>>>(
      r.out_ids, r.a_row_start, r.a_col, r.b_row_start, r.b_col,
      r.grp_a_start, r.slab_lo, static_cast<const T*>(r.a),
      static_cast<const T*>(r.b), r.out, r.nbr, r.nbc, r.g_rows, r.a_grp_max,
      r.slab_max, r.cap_b, r.ld);
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
// Every pointer is device memory: ids and tables int32 (`grp_a_start`
// and `slab_lo` per group of `g_rows` block rows); `a`/`b` f32 (is_bf16 ==
// 0) or bf16 [cap, ld, ld]; `out` f32 [out_cap, ld, ld].  a_grp_max and
// slab_max are the bucketed caps.  precision: 0 highest, 1 high, 2
// default (bf16 data takes 0).
int hbsm_groups_spgemm(const int* out_ids, const int* a_row_start,
                       const int* a_col, const int* b_row_start,
                       const int* b_col, const int* grp_a_start,
                       const int* slab_lo, const void* a, const void* b,
                       float* out, int out_cap, int nbr, int nbc, int g_rows,
                       int a_grp_max, int slab_max, int cap_b,
                       int block_size, int is_bf16, int precision,
                       void* stream) {
  if (out_cap == 0) return 0;
  if (block_size <= 0 || block_size % kTile != 0 || g_rows <= 0 ||
      a_grp_max <= 0 || slab_max <= 0 || cap_b <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args r{out_ids, a_row_start, a_col, b_row_start, b_col, grp_a_start,
               slab_lo, a, b, out, out_cap, nbr, nbc, g_rows, a_grp_max,
               slab_max, cap_b, block_size};
  return dispatch(r, is_bf16, precision, static_cast<cudaStream_t>(stream),
                  nullptr);
}

// The launch `hbsm_groups_spgemm` makes for this data type and tier,
// without making it: info[0..4] = dynamic shared bytes, resident blocks per
// SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor), registers and local
// (spill) bytes per thread, threads per block.  Returns a CUDA error code.
int hbsm_groups_spgemm_config(int is_bf16, int precision, int* info) {
  return dispatch(Args{}, is_bf16, precision, nullptr, info);
}

const char* hbsm_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
