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
// What bounds it: operations (4.2 MFLOP per 128-wide product against 128 KB
// of operands).  One 256-thread block owns one 128x128 tile of one output
// slot.  Slots are sorted by row, so blocks are launched in group order
// and the blocks of one group run together: they read that group's B slab
// from L2, which takes the place of the TPU's VMEM slab.  Each block finds
// its products with one binary search per A entry of the row, spread over
// the threads and compacted in ascending A-entry order, then accumulates
// them in registers (gemm_tile.cuh).  A slot has its own block, so the C
// group cap bounds nothing here (the caller still flags groups above it).
//
// Determinism: each tile is written once, its products summed serially in
// ascending A-entry order with no atomics.
//
// Precision: 0 "highest", 1 "high" (the bf16x3 split), 2 "default"; bf16
// storage takes 0, which is exact.

#include "gemm_tile.cuh"

namespace {

using namespace hbsm;

template <typename T, int MODE>
__global__ void __launch_bounds__(kThreads)
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
  __shared__ __align__(16) Tile<MODE> s;
  __shared__ int hit_e[kThreads];
  __shared__ int hit_q[kThreads];
  __shared__ int warp_hits[kWarps];

  const int ty = threadIdx.x >> 4;
  const int tx = threadIdx.x & 15;
  const int nt = ld / kTile;
  const size_t block = static_cast<size_t>(ld) * ld;
  const size_t a_off = static_cast<size_t>(blockIdx.y / nt) * kTile * ld;
  const size_t b_off = static_cast<size_t>(blockIdx.y % nt) * kTile;

  const int id = out_ids[blockIdx.x];
  const int i = id / nbc;
  float acc[8][8];
  load_tile(acc, nullptr, ld, ty, tx);
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
      const int n_hits = compact_hits(ea, q, hit_e, hit_q, warp_hits);
      for (int h = 0; h < n_hits; ++h) {
        accumulate_product<T, MODE>(acc, s, a + hit_e[h] * block + a_off,
                                    b + hit_q[h] * block + b_off, ld, ty, tx);
      }
    }
  }
  // Every slot is written: union slots with no product and SENTINEL tail
  // slots as zeros.
  store_tile(out + blockIdx.x * block + a_off + b_off, acc, ld, ty, tx);
}

template <typename T, int MODE>
int launch(const int* out_ids, const int* a_row_start, const int* a_col,
           const int* b_row_start, const int* b_col, const int* grp_a_start,
           const int* slab_lo, const void* a, const void* b, float* out,
           int out_cap, int nbr, int nbc, int g_rows, int a_grp_max,
           int slab_max, int cap_b, int ld, cudaStream_t stream) {
  const int nt = ld / kTile;
  groups_kernel<T, MODE><<<dim3(out_cap, nt * nt), kThreads, 0, stream>>>(
      out_ids, a_row_start, a_col, b_row_start, b_col, grp_a_start, slab_lo,
      static_cast<const T*>(a), static_cast<const T*>(b), out, nbr, nbc,
      g_rows, a_grp_max, slab_max, cap_b, ld);
  return static_cast<int>(cudaGetLastError());
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
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define HBSM_GROUPS_LAUNCH(T, MODE)                                          \
  launch<T, MODE>(out_ids, a_row_start, a_col, b_row_start, b_col,          \
                  grp_a_start, slab_lo, a, b, out, out_cap, nbr, nbc, g_rows, \
                  a_grp_max, slab_max, cap_b, block_size, st)
  if (is_bf16) return HBSM_GROUPS_LAUNCH(__nv_bfloat16, 0);
  switch (precision) {
    case 0:
      return HBSM_GROUPS_LAUNCH(float, 0);
    case 1:
      return HBSM_GROUPS_LAUNCH(float, 1);
    case 2:
      return HBSM_GROUPS_LAUNCH(float, 2);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef HBSM_GROUPS_LAUNCH
}

const char* hbsm_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
