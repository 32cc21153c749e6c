// Micro-benchmark kernels of the fine-leaf SpGEMM for Hopper (sm_90a):
// each times one phase of a fine-leaf multiply alone, at B2's shapes.
//
// Replaces the four TPU micro-kernels that sized the JAX package's fine
// kernel: scripts/micro_fine_kernel.py::micro and
// scripts/micro_fine_kernel2.py::e2, ::e3, ::e12.  Each computes what its
// TPU kernel computes, with none of the TPU formulation (no 128-lane
// tiles, no block-diagonal identity, no VMEM scratch carried across a
// sequential grid).  The wrappers and plain versions are in
// kernels/micro_fine.py.
//
//   micro "wide"/"quad": acc[0:LA, 0:LB] = sum_{i<R} (at * s_i)^T bp with
//     s_i = 1 + f32(i) * 1e-9 in f32, each rep's product summed on its own
//     first and then added, in rep order.  Bound by operations
//     (2*LA*LB*32*R; 11.3 GFLOP at LA = LB = 832, R = 256: 0.169 ms of
//     FP32).  One thread block owns one TxT tile of acc and runs the R reps
//     serially over it: T = 32 for "wide" (676 blocks at 832, enough to
//     fill the card), T = 128 for "quad" (one block per 128x128 quad
//     pair, as the TPU's per-quad dots: 49 blocks at 896, 49 of 132 SMs).
//   micro "flatten": per rep, acc rows 128 + 8(4t+c) + r, lane l += the
//     [8,128] row-major reading of the 32x32 sub-block (t, c) of
//     acc[0:128, 0:128] + s_i.  Bound by latency: 64 KB moved.  One thread
//     per destination element, R serial adds.
//   e2: [32,32] -> [8,128] row-major, by three recipes (a flat copy; a
//     staged [4,8,32] stack read back transposed; four row groups
//     concatenated).  All three are copies and equal bitwise.  One block.
//   e3: acc slot p (an [8,128] block) = v added once for each i < R3 with
//     idx[i] == p, serially.  The wrapper sorts idx into runs per slot
//     (run_start); one thread block owns one slot and adds in registers,
//     so no slot is written twice and no atomics are needed.
//   e12: for each A block e < RA and panel block t < nbrow, slot idx[e *
//     nbrow + t] += X_t L_e, with X_t the panel's block t read as a
//     row-major 32x32 and L_e = a_wide[e][:, 0:32]: 6 656 leaf products of
//     32x32x32 at RA = 256, nbrow = 26 (436 MFLOP, 6.5 us of FP32).  The
//     wrapper sorts the (e, t) entries into runs per slot, stably; one
//     thread block owns one slot, stages each entry's two blocks in shared
//     memory and adds its product in registers, in ascending (e, t) order,
//     as gemm_fine.cu does for an output slot.
//
// Precision.  0 "highest": f32 operands, FP32 FFMA.  2 "default": one
// bf16 pass on the tensor cores (mma.sync m16n8k16, operands rounded to
// bf16 to nearest even, exact products, f32 accumulation).
//
// Determinism: every sum runs serially in a fixed order in registers and
// every output element is written once, so repeated calls are bitwise
// equal.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float rep_scale(int i) {
  // s_i = 1 + f32(i) * 1e-9, rounded as the TPU kernel rounds it (no FMA).
  return __fadd_rn(1.0f, __fmul_rn(static_cast<float>(i), 1e-9f));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// d += A(16x16) B(16x8) on the tensor cores, bf16 operands in the
// m16n8k16 fragment layout, f32 accumulators.
__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// The A fragment of rows m0..m0+15 and depths k0..k0+15 of a matrix whose
// element (m, k) is scale * src[m * sm + k * sk] (f32, shared memory).
__device__ __forceinline__ void load_a(uint32_t* a, const float* src, int sm,
                                       int sk, int m0, int k0, float scale) {
  const int lane = threadIdx.x & 31, g = lane >> 2, c = (lane & 3) * 2;
#pragma unroll
  for (int h = 0; h < 2; ++h) {     // depth k0 + c (+8)
#pragma unroll
    for (int r = 0; r < 2; ++r) {   // row m0 + g (+8)
      const float* p = src + (m0 + g + 8 * r) * sm + (k0 + c + 8 * h) * sk;
      a[2 * h + r] = pack_bf16(__fmul_rn(p[0], scale), __fmul_rn(p[sk], scale));
    }
  }
}

// The B fragment of depths k0..k0+15 and columns n0..n0+7 of a matrix whose
// element (k, n) is src[k * sk + n] (f32, shared memory).
__device__ __forceinline__ void load_b(uint32_t* b, const float* src, int sk,
                                       int k0, int n0) {
  const int lane = threadIdx.x & 31, g = lane >> 2, c = (lane & 3) * 2;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float* p = src + (k0 + c + 8 * h) * sk + n0 + g;
    b[h] = pack_bf16(p[0], p[sk]);
  }
}

// ---- micro "wide" / "quad" ---------------------------------------------

template <int T, bool kMma>
__global__ void __launch_bounds__((T / 4) * (T / 4))
    micro_dot_kernel(const float* __restrict__ at, const float* __restrict__ bp,
                     float* __restrict__ acc, int la, int lb, int acc_cols,
                     int reps) {
  constexpr int kThreads = (T / 4) * (T / 4);
  constexpr int S = T / 4;  // thread grid side; rows/cols stride
  __shared__ __align__(16) float sa[32 * T];  // at[k][m0 + m]
  __shared__ __align__(16) float sb[32 * T];  // bp[k][n0 + n]
  const int m0 = blockIdx.y * T, n0 = blockIdx.x * T;
  for (int v = threadIdx.x; v < 32 * T; v += kThreads) {
    const int k = v / T, j = v % T;
    sa[v] = m0 + j < la ? at[k * la + m0 + j] : 0.f;
    sb[v] = n0 + j < lb ? bp[k * lb + n0 + j] : 0.f;
  }
  __syncthreads();
  if constexpr (!kMma) {
    const int tx = threadIdx.x % S, ty = threadIdx.x / S;
    float sum[4][4] = {};
    for (int i = 0; i < reps; ++i) {
      const float s = rep_scale(i);
      float part[4][4] = {};
#pragma unroll 4
      for (int k = 0; k < 32; ++k) {
        float a[4], b[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          a[u] = __fmul_rn(sa[k * T + ty + u * S], s);
          b[u] = sb[k * T + tx + u * S];
        }
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int w = 0; w < 4; ++w) part[u][w] = fmaf(a[u], b[w], part[u][w]);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int w = 0; w < 4; ++w) sum[u][w] += part[u][w];
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int m = m0 + ty + u * S;
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        const int n = n0 + tx + w * S;
        if (m < la && n < lb) acc[static_cast<size_t>(m) * acc_cols + n] = sum[u][w];
      }
    }
  } else {
    // Each warp owns four 16x8 tiles: rows 16*(warp / (T/32)), columns
    // 8*(4*(warp % (T/32)) + j), j < 4.
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int tm = 16 * (warp / (T / 32)), tn = 32 * (warp % (T / 32));
    float sum[4][4] = {};
    for (int i = 0; i < reps; ++i) {
      const float s = rep_scale(i);
      float part[4][4] = {};
#pragma unroll
      for (int k0 = 0; k0 < 32; k0 += 16) {
        uint32_t a[4];
        load_a(a, sa, 1, T, tm, k0, s);  // A(m, k) = at[k][m] * s
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          uint32_t b[2];
          load_b(b, sb, T, k0, tn + 8 * j);
          mma_bf16(part[j], a, b);
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) sum[j][q] += part[j][q];
    }
    const int g = lane >> 2, c = (lane & 3) * 2;
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int m = m0 + tm + g + 8 * (q >> 1), n = n0 + tn + 8 * j + c + (q & 1);
        if (m < la && n < lb) acc[static_cast<size_t>(m) * acc_cols + n] = sum[j][q];
      }
  }
}

// ---- micro "flatten" ---------------------------------------------------

__global__ void __launch_bounds__(256)
    micro_flatten_kernel(float* __restrict__ acc, int acc_cols, int reps) {
  const int d = blockIdx.x * 256 + threadIdx.x;  // 0 .. 128*128-1
  const int row = d >> 7, l = d & 127;           // destination row - 128, lane
  const int blk = row >> 3, r = row & 7, t = blk >> 2, c = blk & 3;
  const float src = acc[static_cast<size_t>(32 * t + 4 * r + (l >> 5)) * acc_cols +
                        32 * c + (l & 31)];
  float* dst = acc + static_cast<size_t>(128 + row) * acc_cols + l;
  float sum = *dst;
  for (int i = 0; i < reps; ++i) sum = __fadd_rn(sum, __fadd_rn(src, rep_scale(i)));
  *dst = sum;
}

// ---- e2 ----------------------------------------------------------------

__global__ void __launch_bounds__(256)
    e2_kernel(const float* __restrict__ x, float* __restrict__ out, int variant) {
  __shared__ float f[4][8][32];
  const int tid = threadIdx.x;
  if (variant == 0) {  // reshape: the same 1024 values in the same order
    reinterpret_cast<float4*>(out)[tid] = reinterpret_cast<const float4*>(x)[tid];
  } else if (variant == 1) {  // stack: f[q][g][j] = x[4g+q][j], then [g][q][j]
    for (int v = tid; v < 1024; v += 256) {
      const int q = v >> 8, g = (v >> 5) & 7, j = v & 31;
      f[q][g][j] = x[(4 * g + q) * 32 + j];
    }
    __syncthreads();
    for (int v = tid; v < 1024; v += 256) {
      const int g = v >> 7, q = (v >> 5) & 3, j = v & 31;
      out[v] = f[q][g][j];
    }
  } else {  // concat: out[g, 32r + j] = x[4g + r, j]
    for (int v = tid; v < 1024; v += 256) {
      const int g = v >> 7, r = (v >> 5) & 3, j = v & 31;
      out[v] = x[(4 * g + r) * 32 + j];
    }
  }
}

// ---- e3 ----------------------------------------------------------------

__global__ void __launch_bounds__(256)
    e3_kernel(const int* __restrict__ run_start, const float* __restrict__ v,
              float* __restrict__ acc) {
  const int slot = blockIdx.x;
  const int n = run_start[slot + 1] - run_start[slot];
  const float4 x = reinterpret_cast<const float4*>(v)[threadIdx.x];
  float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int j = 0; j < n; ++j) {
    s.x += x.x;
    s.y += x.y;
    s.z += x.z;
    s.w += x.w;
  }
  reinterpret_cast<float4*>(acc + static_cast<size_t>(slot) * 1024)[threadIdx.x] = s;
}

// ---- e12 ---------------------------------------------------------------

template <bool kMma>
__global__ void __launch_bounds__(256)
    e12_kernel(const int* __restrict__ order, const int* __restrict__ run_start,
               const float* __restrict__ a_wide, const float* __restrict__ panel,
               float* __restrict__ acc, int nbrow, int a_lanes) {
  __shared__ __align__(16) float sx[32 * 32];  // X_t, row-major
  __shared__ __align__(16) float sl[32 * 32];  // L_e = a_wide[e][:, 0:32]
  const int slot = blockIdx.x, tid = threadIdx.x;
  const int lo = run_start[slot], hi = run_start[slot + 1];
  const int c = tid & 31, r0 = tid >> 5;  // FFMA: rows r0 + 8u, column c
  const int warp = tid >> 5, lane = tid & 31;
  const int tm = 16 * (warp >> 2), tn = 8 * (warp & 3);  // mma: one 16x8 tile
  float sum[4] = {0.f, 0.f, 0.f, 0.f};
  for (int j = lo; j < hi; ++j) {
    const int q = order[j], e = q / nbrow, t = q - e * nbrow;
    reinterpret_cast<float4*>(sx)[tid] =
        reinterpret_cast<const float4*>(panel + static_cast<size_t>(t) * 1024)[tid];
    {
      const int row = tid >> 3, c4 = tid & 7;
      reinterpret_cast<float4*>(sl)[tid] = reinterpret_cast<const float4*>(
          a_wide + (static_cast<size_t>(e) * 32 + row) * a_lanes)[c4];
    }
    __syncthreads();
    float part[4] = {0.f, 0.f, 0.f, 0.f};
    if constexpr (!kMma) {
#pragma unroll 8
      for (int k = 0; k < 32; ++k) {
        const float l = sl[k * 32 + c];
#pragma unroll
        for (int u = 0; u < 4; ++u) part[u] = fmaf(sx[(r0 + 8 * u) * 32 + k], l, part[u]);
      }
    } else {
#pragma unroll
      for (int k0 = 0; k0 < 32; k0 += 16) {
        uint32_t a[4], b[2];
        load_a(a, sx, 32, 1, tm, k0, 1.0f);
        load_b(b, sl, 32, k0, tn);
        mma_bf16(part, a, b);
      }
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) sum[u] += part[u];
    __syncthreads();
  }
  float* dst = acc + static_cast<size_t>(slot) * 1024;
  if constexpr (!kMma) {
#pragma unroll
    for (int u = 0; u < 4; ++u) dst[(r0 + 8 * u) * 32 + c] = sum[u];
  } else {
    const int g = lane >> 2, cc = (lane & 3) * 2;
#pragma unroll
    for (int u = 0; u < 4; ++u) dst[(tm + g + 8 * (u >> 1)) * 32 + tn + cc + (u & 1)] = sum[u];
  }
}

template <int T, bool kMma>
int launch_dot(const float* at, const float* bp, float* acc, int la, int lb,
               int acc_cols, int reps, cudaStream_t st) {
  const dim3 grid((lb + T - 1) / T, (la + T - 1) / T);
  micro_dot_kernel<T, kMma><<<grid, (T / 4) * (T / 4), 0, st>>>(at, bp, acc, la, lb,
                                                               acc_cols, reps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Every entry launches on `stream` and returns cudaGetLastError() (0 on
// success).  Pointers are device memory, f32 unless named int; `acc` is
// zero on entry and row-major with `acc_cols` columns.

// micro "wide" (quad == 0) or "quad": at [32, la], bp [32, lb].
int hbsm_micro_dot(const float* at, const float* bp, float* acc, int la, int lb,
                   int acc_cols, int reps, int quad, int precision, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (la == 0 || lb == 0) return 0;
  if (precision != 0 && precision != 2) return static_cast<int>(cudaErrorInvalidValue);
  const bool mma = precision == 2;
  if (quad) {
    return mma ? launch_dot<128, true>(at, bp, acc, la, lb, acc_cols, reps, st)
               : launch_dot<128, false>(at, bp, acc, la, lb, acc_cols, reps, st);
  }
  return mma ? launch_dot<32, true>(at, bp, acc, la, lb, acc_cols, reps, st)
             : launch_dot<32, false>(at, bp, acc, la, lb, acc_cols, reps, st);
}

// micro "flatten" on acc [>= 256, acc_cols >= 128].
int hbsm_micro_flatten(float* acc, int acc_cols, int reps, void* stream) {
  micro_flatten_kernel<<<64, 256, 0, static_cast<cudaStream_t>(stream)>>>(acc, acc_cols,
                                                                          reps);
  return static_cast<int>(cudaGetLastError());
}

// e2: x [32, 32] -> out [8, 128]; variant 0 reshape, 1 stack, 2 concat.
int hbsm_e2(const float* x, float* out, int variant, void* stream) {
  if (variant < 0 || variant > 2) return static_cast<int>(cudaErrorInvalidValue);
  e2_kernel<<<1, 256, 0, static_cast<cudaStream_t>(stream)>>>(x, out, variant);
  return static_cast<int>(cudaGetLastError());
}

// e3: run_start int [n_slots + 1], v [8, 128], acc [n_slots, 8, 128].
int hbsm_e3(const int* run_start, const float* v, float* acc, int n_slots,
            void* stream) {
  if (n_slots == 0) return 0;
  e3_kernel<<<n_slots, 256, 0, static_cast<cudaStream_t>(stream)>>>(run_start, v, acc);
  return static_cast<int>(cudaGetLastError());
}

// e12: order int [n_entries] (entry e * nbrow + t, grouped by slot in
// ascending order), run_start int [n_slots + 1], a_wide [RA, 32, a_lanes],
// panel [8 * nbrow, 128], acc [n_slots, 8, 128].
int hbsm_e12(const int* order, const int* run_start, const float* a_wide,
             const float* panel, float* acc, int n_slots, int nbrow, int a_lanes,
             int precision, void* stream) {
  if (n_slots == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (precision == 0) {
    e12_kernel<false><<<n_slots, 256, 0, st>>>(order, run_start, a_wide, panel, acc,
                                               nbrow, a_lanes);
  } else if (precision == 2) {
    e12_kernel<true><<<n_slots, 256, 0, st>>>(order, run_start, a_wide, panel, acc,
                                              nbrow, a_lanes);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* hbsm_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
