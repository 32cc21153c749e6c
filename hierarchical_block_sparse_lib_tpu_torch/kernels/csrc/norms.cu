// Per-block squared Frobenius norms for Hopper (sm_90a), with an optional
// keep mask n2 > tau^2, in one read of the block tensor.
//
// Replaces hierarchical_block_sparse_lib_tpu/kernels/pallas_norms.py::
// block_frob_squared and ::norms_and_keep: one body serves both, the
// compare is done when a keep pointer is given.
//
// What bounds it: bytes.  It reads every element once (2 flops each) and
// writes 5 bytes per block, so the floor is the block tensor over the
// memory rate (42 MB, 12.6 us at 3.35 TB/s for 644 blocks of 128x128
// f32).  The design gives each leaf block one thread block of 256
// threads that streams it with 16-byte loads (f32) or 4-byte loads (bf16),
// keeps four independent partial sums per thread so the loads stay in
// flight, and reduces across the block through warp shuffles and a small
// shared array.  All blocks of a few-hundred-block tensor are resident on
// the card at once.
//
// Determinism: the summation order is fixed by the thread layout, so a
// repeated call gives bitwise-equal norms; it differs from a CPU or TPU
// sum in the last bits, so a norm within rounding of tau^2 may keep or
// drop differently from another implementation.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float partial(const float* x, long long n) {
  const float4* v = reinterpret_cast<const float4*>(x);
  const long long n4 = n / 4;
  float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
#pragma unroll 4
  for (long long i = threadIdx.x; i < n4; i += kThreads) {
    const float4 q = v[i];
    s0 = fmaf(q.x, q.x, s0);
    s1 = fmaf(q.y, q.y, s1);
    s2 = fmaf(q.z, q.z, s2);
    s3 = fmaf(q.w, q.w, s3);
  }
  for (long long i = n4 * 4 + threadIdx.x; i < n; i += kThreads) {
    s0 = fmaf(x[i], x[i], s0);
  }
  return (s0 + s1) + (s2 + s3);
}

__device__ __forceinline__ float partial(const __nv_bfloat16* x, long long n) {
  const __nv_bfloat162* v = reinterpret_cast<const __nv_bfloat162*>(x);
  const long long n2 = n / 2;
  float s0 = 0.f, s1 = 0.f;
#pragma unroll 4
  for (long long i = threadIdx.x; i < n2; i += kThreads) {
    const float2 q = __bfloat1622float2(v[i]);
    s0 = fmaf(q.x, q.x, s0);
    s1 = fmaf(q.y, q.y, s1);
  }
  if ((n & 1) && threadIdx.x == 0) {
    const float q = __bfloat162float(x[n - 1]);
    s0 = fmaf(q, q, s0);
  }
  return s0 + s1;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    block_norms_kernel(const T* __restrict__ data, long long n,
                       float* __restrict__ n2, uint8_t* __restrict__ keep,
                       const float* __restrict__ tau2_ptr, float tau2_val) {
  __shared__ float warp_sums[kWarps];
  float s = partial(data + static_cast<long long>(blockIdx.x) * n, n);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = s;
  __syncthreads();
  if (threadIdx.x == 0) {
    float total = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) total += warp_sums[w];
    n2[blockIdx.x] = total;
    if (keep != nullptr) {
      const float tau2 = tau2_ptr != nullptr ? *tau2_ptr : tau2_val;
      keep[blockIdx.x] = total > tau2 ? 1 : 0;
    }
  }
}

}  // namespace

extern "C" {

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// `data` is [cap, n] f32 (is_bf16 == 0) or bf16, 16-byte aligned; `n2`
// f32[cap]; `keep` uint8[cap] or null (norms only); tau^2 is read from
// `tau2_ptr` (device f32) when it is not null, else taken from `tau2_val`.
int hbsm_block_norms(const void* data, int cap, long long n, int is_bf16,
                     float* n2, uint8_t* keep, const float* tau2_ptr,
                     float tau2_val, void* stream) {
  if (cap == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    block_norms_kernel<__nv_bfloat16><<<cap, kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(data), n, n2, keep, tau2_ptr,
        tau2_val);
  } else {
    block_norms_kernel<float><<<cap, kThreads, 0, st>>>(
        static_cast<const float*>(data), n, n2, keep, tau2_ptr, tau2_val);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* hbsm_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
