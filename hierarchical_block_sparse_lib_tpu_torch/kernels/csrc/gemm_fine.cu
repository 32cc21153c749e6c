// Fine-leaf SpGEMM for Hopper (sm_90a): C(i,j) = sum_k A(i,k) B(k,j) into
// the slots of a sorted output id list, at leaf sizes b in {16, 32, 64}.
//
// Replaces hierarchical_block_sparse_lib_tpu/kernels/pallas_gemm_fine.py::
// fine_spgemm.  It computes what that kernel computes (same tables, same
// row caps, same output slots, zero-filled tail) and none of its TPU
// formulation: no block-diagonal MXU identity, no 128-lane tiles, no
// SMEM tables or DMA chains.
//
// Layout: every operand block is stored transposed and row-major (the
// port's transposed-flat convention, ops/fine.py): `at[e]` is
// (alpha*A_e)^T, `bt[q]` is B_q^T, and slot s of `out` receives C_s^T =
// sum over hits of B_q^T (alpha*A_e)^T.
//
// What bounds it: bytes and latency, not FLOPs.  One thread block owns one
// output slot and re-reads every A and B block its products need, so each
// block is read once per output slot that uses it (L2, 50 MB, catches the
// reuse of a row's A blocks); a leaf product is only 2*b^3 FLOPs against
// 2*b^2*4 bytes staged.  The design keeps the bytes it moves coalesced
// (16-byte loads of whole blocks into shared memory, one coalesced store
// per slot), finds hits with one binary search per A entry spread across
// the block's threads, and keeps every sum in registers.  Tensor cores,
// TMA and multi-stage staging are left to later work.
//
// Determinism: each slot is written exactly once by one thread block that
// accumulates its products serially in ascending A-entry order, in f32
// registers, with no atomics.  A fixed plan gives bitwise-equal results.
//
// Precision (the reference's three tiers, kernels/mxu.py):
//   0 "highest": f32 operands, FP32 FFMA;
//   1 "high":    f32 operands split as x = hi + lo with hi = bf16(x),
//                lo = bf16(x - hi); hi*hi + (hi*lo + lo*hi) per product;
//   2 "default": bf16 operands (alpha folded in before rounding), f32
//                products and f32 accumulation.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSentinel = 0x7fffffff;

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// Copy one b x b block (b*b contiguous elements) into shared f32.
template <int B>
__device__ __forceinline__ void stage(float* dst, const float* src) {
  const float4* s = reinterpret_cast<const float4*>(src);
  float4* d = reinterpret_cast<float4*>(dst);
  for (int v = threadIdx.x; v < B * B / 4; v += kThreads) d[v] = s[v];
}

template <int B>
__device__ __forceinline__ void stage(float* dst, const __nv_bfloat16* src) {
  const __nv_bfloat162* s = reinterpret_cast<const __nv_bfloat162*>(src);
  float2* d = reinterpret_cast<float2*>(dst);
  for (int v = threadIdx.x; v < B * B / 2; v += kThreads) {
    d[v] = __bfloat1622float2(s[v]);
  }
}

// acc[u] += sum_m bt(r0 + u*RS, m) * at(m, c): this thread's R outputs of
// one leaf product.  The product is summed on its own first, then added.
template <int B, bool kSplit>
__device__ __forceinline__ void multiply_add(float* acc, const float* sa,
                                             const float* sb, int r0, int c) {
  constexpr int R = B * B / kThreads;
  constexpr int RS = kThreads / B;
  float part[R];
  float cross[R];
#pragma unroll
  for (int u = 0; u < R; ++u) {
    part[u] = 0.f;
    cross[u] = 0.f;
  }
#pragma unroll 2
  for (int m = 0; m < B; m += 4) {
    float a[4], al[4];
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      a[t] = sa[(m + t) * B + c];
      if (kSplit) {  // a[t] becomes hi, al[t] lo; shared by all R rows
        const float hi = bf16_round(a[t]);
        al[t] = bf16_round(a[t] - hi);
        a[t] = hi;
      }
    }
#pragma unroll
    for (int u = 0; u < R; ++u) {
      const float4 bv =
          *reinterpret_cast<const float4*>(&sb[(r0 + u * RS) * B + m]);
      const float b4[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        if (kSplit) {
          const float bh = bf16_round(b4[t]);
          const float bl = bf16_round(b4[t] - bh);
          part[u] = fmaf(bh, a[t], part[u]);
          cross[u] = fmaf(bl, a[t], fmaf(bh, al[t], cross[u]));
        } else {
          part[u] = fmaf(b4[t], a[t], part[u]);
        }
      }
    }
  }
#pragma unroll
  for (int u = 0; u < R; ++u) acc[u] += kSplit ? part[u] + cross[u] : part[u];
}

template <int B, bool kSplit, typename T>
__global__ void __launch_bounds__(kThreads)
    fine_spgemm_kernel(const int* __restrict__ out_ids,
                       const int* __restrict__ a_row_start,
                       const int* __restrict__ a_col,
                       const int* __restrict__ b_row_start,
                       const int* __restrict__ b_col,
                       const T* __restrict__ at, const T* __restrict__ bt,
                       float* __restrict__ out, int nbr, int nbc,
                       int b_row_max) {
  constexpr int R = B * B / kThreads;  // outputs per thread: 1, 4, 16
  constexpr int RS = kThreads / B;     // row stride between them
  __shared__ __align__(16) float sa[B * B];
  __shared__ __align__(16) float sb[B * B];
  __shared__ int hit_e[kThreads];
  __shared__ int hit_q[kThreads];
  __shared__ int warp_hits[kWarps];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int c = threadIdx.x % B;
  const int r0 = threadIdx.x / B;
  float acc[R];
#pragma unroll
  for (int u = 0; u < R; ++u) acc[u] = 0.f;

  // SENTINEL slots (the tail past the last used slot) keep acc == 0.
  const int id = out_ids[blockIdx.x];
  const int i = id / nbc;
  if (id != kSentinel && i < nbr) {
    const int j = id - i * nbc;
    const int e_end = a_row_start[i + 1];
    for (int e0 = a_row_start[i]; e0 < e_end; e0 += kThreads) {
      // One A entry per thread: find B(k, j) in B's row k, whose first
      // min(count, b_row_max) entries are visible (the reference's row
      // cap; the caller flags rows longer than the cap).
      const int e = e0 + threadIdx.x;
      int q = -1;
      if (e < e_end) {
        const int k = a_col[e];
        const int start = b_row_start[k];
        const int stop = start + min(b_row_start[k + 1] - start, b_row_max);
        int lo = start, hi = stop;
        while (lo < hi) {
          const int mid = (lo + hi) >> 1;
          if (b_col[mid] < j) {
            lo = mid + 1;
          } else {
            hi = mid;
          }
        }
        if (lo < stop && b_col[lo] == j) q = lo;
      }
      // Compact the hits, keeping ascending e.
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
      for (int h = 0; h < n_hits; ++h) {
        stage<B>(sa, at + static_cast<size_t>(hit_e[h]) * B * B);
        stage<B>(sb, bt + static_cast<size_t>(hit_q[h]) * B * B);
        __syncthreads();
        multiply_add<B, kSplit>(acc, sa, sb, r0, c);
        __syncthreads();
      }
    }
  }
  float* dst = out + static_cast<size_t>(blockIdx.x) * B * B;
#pragma unroll
  for (int u = 0; u < R; ++u) dst[(r0 + u * RS) * B + c] = acc[u];
}

template <int B, bool kSplit, typename T>
int launch(const int* out_ids, const int* a_row_start, const int* a_col,
           const int* b_row_start, const int* b_col, const void* at,
           const void* bt, float* out, int out_cap, int nbr, int nbc,
           int b_row_max, cudaStream_t stream) {
  fine_spgemm_kernel<B, kSplit, T><<<out_cap, kThreads, 0, stream>>>(
      out_ids, a_row_start, a_col, b_row_start, b_col,
      static_cast<const T*>(at), static_cast<const T*>(bt), out, nbr, nbc,
      b_row_max);
  return static_cast<int>(cudaGetLastError());
}

template <int B>
int dispatch_precision(int precision, const int* out_ids,
                       const int* a_row_start, const int* a_col,
                       const int* b_row_start, const int* b_col,
                       const void* at, const void* bt, float* out,
                       int out_cap, int nbr, int nbc, int b_row_max,
                       cudaStream_t stream) {
  switch (precision) {
    case 0:
      return launch<B, false, float>(out_ids, a_row_start, a_col, b_row_start,
                                     b_col, at, bt, out, out_cap, nbr, nbc,
                                     b_row_max, stream);
    case 1:
      return launch<B, true, float>(out_ids, a_row_start, a_col, b_row_start,
                                    b_col, at, bt, out, out_cap, nbr, nbc,
                                    b_row_max, stream);
    case 2:
      return launch<B, false, __nv_bfloat16>(
          out_ids, a_row_start, a_col, b_row_start, b_col, at, bt, out,
          out_cap, nbr, nbc, b_row_max, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// Every pointer is device memory: ids and tables int32, `at`/`bt` f32
// (precision 0, 1) or bf16 (precision 2) blocks, `out` f32
// [out_cap, b, b].
int hbsm_fine_spgemm(const int* out_ids, const int* a_row_start,
                     const int* a_col, const int* b_row_start,
                     const int* b_col, const void* at, const void* bt,
                     float* out, int out_cap, int nbr, int nbc, int b_row_max,
                     int block_size, int precision, void* stream) {
  if (out_cap == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (block_size) {
    case 16:
      return dispatch_precision<16>(precision, out_ids, a_row_start, a_col,
                                    b_row_start, b_col, at, bt, out, out_cap,
                                    nbr, nbc, b_row_max, st);
    case 32:
      return dispatch_precision<32>(precision, out_ids, a_row_start, a_col,
                                    b_row_start, b_col, at, bt, out, out_cap,
                                    nbr, nbc, b_row_max, st);
    case 64:
      return dispatch_precision<64>(precision, out_ids, a_row_start, a_col,
                                    b_row_start, b_col, at, bt, out, out_cap,
                                    nbr, nbc, b_row_max, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* hbsm_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
