// spgemm's fine-branch output for Hopper (sm_90a): D = alpha*C + beta*acc
// in canonical layout, every slot of D written once.
//
// Replaces no TPU kernel.  The JAX package applies alpha and the
// accumulate in XLA after its fine kernel
// (hierarchical_block_sparse_lib_tpu/ops/spgemm.py), which fuses them on
// the TPU.  Run eagerly on the card, the port's fine branch made five
// passes over the union after its kernel: the transpose of the kernel's
// C^T blocks back to canonical layout, the ×alpha `where` pass that
// zeroes the padding, the gather of the accumulator's blocks into the
// union (an int scatter, a gather and a `where`), the ×beta pass and the
// add, each reading and writing every slot.  They are one function of
// the kernel's output, the accumulator, the union's ids and two factors,
// so one pass writes D.
//
// For every slot s < out_cap, with c = C[s] (the fine kernel's C^T block,
// f32, read transposed) and g = acc[src[s]] (+0 where no accumulator block
// lands in the slot), D of type T (f32, bf16 or f64) and K =
// promote_types(T, f32) the type the accumulate is held in:
//   o = T(ids[s] == SENTINEL ? +0 : fl32(alpha * c))
//   D[s] = acc given ? T(fl_K(K(o) + fl_K(beta * K(g)))) : o
// the former passes' own arithmetic and casts, element for element, so D
// has their bits for every alpha and beta: products and sums are
// __fmul_rn/__fadd_rn (__dmul_rn/__dadd_rn in f64; no FMA contraction),
// casts round to nearest.  The accumulator comes in T or in K (the
// wrapper casts another type to K, which commutes with the gather).  A
// SENTINEL slot reads nothing of C.
//
// Up to three device operations a call, on the caller's stream: with an
// accumulator a memset of the slot map `src` to -1 and `fine_src_kernel`,
// which inverts the accumulator's row -> union slot map (pos_acc; SENTINEL
// rows and slots past out_cap drop out); then `fine_epilogue_kernel`.
//
// What bounds it: bytes.  The pass reads C's valid slots and the landing
// accumulator blocks once and writes every slot of D once: at the SP2 step
// of the water cluster (out_cap 262 144 slots of 32x32 f32, ~160 000-
// 185 000 valid, ~26 600 accumulator blocks) ~1.9 GB, 0.57 ms at
// 3.35 TB/s.  The design: one warp takes a unit of 1 024 floats, a 32x32
// tile (one block at b = 32, a quarter of one at b = 64, a whole C tile
// pair transposed into D's) or four 16x16 blocks at b = 16.  Each lane
// issues all eight streaming vector loads of C and of the accumulator (16
// bytes each in f32) before it waits on any, stores C's into the warp's
// padded shared tile (pitch T + 1: no bank conflicts at T = 32), reads it
// back transposed, and writes D with streaming vector stores of four
// elements.  Eight warps a block; the
// warps of the SP2 step's 262 144 units fill the 132 SMs many times over.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int32_t kSentinel = 0x7fffffff;
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kUnit = 1024;              // floats a warp takes
constexpr int kVec = kUnit / 4 / 32;     // vectors of four elements a lane takes

// The accumulate's arithmetic in K (f32 or f64), rounded to nearest.
__device__ __forceinline__ float mul_rn(float f, float x) { return __fmul_rn(f, x); }
__device__ __forceinline__ double mul_rn(double f, double x) { return __dmul_rn(f, x); }
__device__ __forceinline__ float add_rn(float a, float x) { return __fadd_rn(a, x); }
__device__ __forceinline__ double add_rn(double a, double x) { return __dadd_rn(a, x); }

// Casts between an element type and K.
template <typename K> __device__ __forceinline__ K widen(float x) { return x; }
template <typename K> __device__ __forceinline__ K widen(double x) { return x; }
template <typename K> __device__ __forceinline__ K widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T narrow(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 narrow<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
template <typename T> __device__ __forceinline__ T narrow(double x) { return x; }

// Four consecutive elements as K, with a streaming load: 16 bytes of f32,
// 8 of bf16, 32 of f64.
template <typename K> __device__ __forceinline__ void load4(const float* p, K v[4]) {
  const float4 f = __ldcs(reinterpret_cast<const float4*>(p));
  v[0] = f.x; v[1] = f.y; v[2] = f.z; v[3] = f.w;
}
template <typename K> __device__ __forceinline__ void load4(const __nv_bfloat16* p, K v[4]) {
  const uint2 u = __ldcs(reinterpret_cast<const uint2*>(p));
  v[0] = __bfloat162float(__ushort_as_bfloat16(static_cast<unsigned short>(u.x & 0xffffu)));
  v[1] = __bfloat162float(__ushort_as_bfloat16(static_cast<unsigned short>(u.x >> 16)));
  v[2] = __bfloat162float(__ushort_as_bfloat16(static_cast<unsigned short>(u.y & 0xffffu)));
  v[3] = __bfloat162float(__ushort_as_bfloat16(static_cast<unsigned short>(u.y >> 16)));
}
template <typename K> __device__ __forceinline__ void load4(const double* p, K v[4]) {
  const double2 a = __ldcs(reinterpret_cast<const double2*>(p));
  const double2 b = __ldcs(reinterpret_cast<const double2*>(p) + 1);
  v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
}

// Four consecutive elements with a streaming store.
__device__ __forceinline__ void store4(float* p, const float o[4]) {
  __stcs(reinterpret_cast<float4*>(p), make_float4(o[0], o[1], o[2], o[3]));
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const __nv_bfloat16 o[4]) {
  const unsigned lo = __bfloat16_as_ushort(o[0]) | (unsigned(__bfloat16_as_ushort(o[1])) << 16);
  const unsigned hi = __bfloat16_as_ushort(o[2]) | (unsigned(__bfloat16_as_ushort(o[3])) << 16);
  __stcs(reinterpret_cast<uint2*>(p), make_uint2(lo, hi));
}
__device__ __forceinline__ void store4(double* p, const double o[4]) {
  __stcs(reinterpret_cast<double2*>(p), make_double2(o[0], o[1]));
  __stcs(reinterpret_cast<double2*>(p) + 1, make_double2(o[2], o[3]));
}

template <typename T> struct AccumType { using K = float; };
template <> struct AccumType<double> { using K = double; };

__global__ void fine_src_kernel(const int32_t* __restrict__ pos_acc, int n_acc, int out_cap,
                                int32_t* __restrict__ src) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n_acc) return;
  const uint32_t s = static_cast<uint32_t>(pos_acc[r]);
  if (s < static_cast<uint32_t>(out_cap)) src[s] = r;
}

// D of type T, the accumulator of type A (T or K).
template <int B, typename T, typename A>
__global__ void __launch_bounds__(kThreads)
    fine_epilogue_kernel(const float* __restrict__ ct, const int32_t* __restrict__ ids,
                         int out_cap, const A* __restrict__ acc,
                         const int32_t* __restrict__ src, const float* alpha_ptr,
                         float alpha_val, const typename AccumType<T>::K* beta_ptr,
                         typename AccumType<T>::K beta_val, T* __restrict__ d) {
  using K = typename AccumType<T>::K;
  constexpr int T_ = B < 32 ? B : 32;  // tile side
  constexpr int P = T_ + 1;            // shared pitch
  constexpr int TT = T_ * T_;
  constexpr int kTiles = kUnit / TT;   // tiles a unit: 4 at b = 16, else 1
  constexpr int S = B / T_;            // tiles a block side: 2 at b = 64
  constexpr long long BB = static_cast<long long>(B) * B;
  __shared__ float tile[kWarps][kTiles * T_ * P];

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long n_tiles = static_cast<long long>(out_cap) * S * S;
  const long long first = (static_cast<long long>(blockIdx.x) * kWarps + warp) * kTiles;
  if (first >= n_tiles) return;
  const float alpha = alpha_ptr != nullptr ? *alpha_ptr : alpha_val;
  const K beta = beta_ptr != nullptr ? *beta_ptr : beta_val;
  float* sm = tile[warp];

  float4 c[kVec];
  K g[kVec][4];
  bool live[kVec], valid[kVec];
  long long d_off[kVec];
#pragma unroll
  for (int k = 0; k < kVec; ++k) {
    const int e = 4 * (lane + 32 * k);  // the unit's element this vector starts at
    const int q = e / TT, r = (e % TT) / T_, col = e % T_;
    const long long t = first + q;
    live[k] = t < n_tiles;
    const long long s = live[k] ? t / (S * S) : 0;
    const int I = static_cast<int>(t % (S * S)) / S, J = static_cast<int>(t % (S * S)) % S;
    valid[k] = live[k] && ids[s] != kSentinel;
    // C^T's tile (J, I) holds D's tile (I, J) transposed.
    c[k] = valid[k] ? __ldcs(reinterpret_cast<const float4*>(
                          ct + s * BB + static_cast<long long>(T_ * J + r) * B + T_ * I + col))
                    : make_float4(0.f, 0.f, 0.f, 0.f);
    d_off[k] = s * BB + static_cast<long long>(T_ * I + r) * B + T_ * J + col;
    const int j = acc != nullptr && live[k] ? src[s] : -1;
    if (j >= 0) {
      load4<K>(acc + j * BB + (d_off[k] - s * BB), g[k]);
    } else {
#pragma unroll
      for (int m = 0; m < 4; ++m) g[k][m] = K(0);
    }
  }
#pragma unroll
  for (int k = 0; k < kVec; ++k) {
    const int e = 4 * (lane + 32 * k);
    float* row = sm + (e / TT) * T_ * P + ((e % TT) / T_) * P + e % T_;
    row[0] = c[k].x;
    row[1] = c[k].y;
    row[2] = c[k].z;
    row[3] = c[k].w;
  }
  __syncwarp();
#pragma unroll
  for (int k = 0; k < kVec; ++k) {
    if (!live[k]) continue;
    const int e = 4 * (lane + 32 * k);
    const int r = (e % TT) / T_, col = e % T_;
    const float* colp = sm + (e / TT) * T_ * P + col * P + r;
    const float x[4] = {colp[0], colp[P], colp[2 * P], colp[3 * P]};
    T o[4];
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      o[m] = narrow<T>(valid[k] ? __fmul_rn(alpha, x[m]) : 0.f);
      if (acc != nullptr) o[m] = narrow<T>(add_rn(widen<K>(o[m]), mul_rn(beta, g[k][m])));
    }
    store4(d + d_off[k], o);
  }
}

template <int B, typename T, typename A>
void launch_pass(const float* ct, const int32_t* ids, int out_cap, const void* acc,
                 const int32_t* src, const float* alpha_ptr, double alpha_val,
                 const void* beta_ptr, double beta_val, void* d, cudaStream_t st) {
  using K = typename AccumType<T>::K;
  constexpr int T_ = B < 32 ? B : 32;
  constexpr int kTiles = kUnit / (T_ * T_);
  const long long n_tiles = static_cast<long long>(out_cap) * (B / T_) * (B / T_);
  const long long units = (n_tiles + kTiles - 1) / kTiles;
  const long long grid = (units + kWarps - 1) / kWarps;
  fine_epilogue_kernel<B, T, A><<<static_cast<unsigned>(grid), kThreads, 0, st>>>(
      ct, ids, out_cap, static_cast<const A*>(acc), src, alpha_ptr,
      static_cast<float>(alpha_val), static_cast<const K*>(beta_ptr), static_cast<K>(beta_val),
      static_cast<T*>(d));
}

template <typename T, typename A>
void launch_leaf(int b, const float* ct, const int32_t* ids, int out_cap, const void* acc,
                 const int32_t* src, const float* alpha_ptr, double alpha_val,
                 const void* beta_ptr, double beta_val, void* d, cudaStream_t st) {
  if (b == 16) {
    launch_pass<16, T, A>(ct, ids, out_cap, acc, src, alpha_ptr, alpha_val, beta_ptr, beta_val,
                          d, st);
  } else if (b == 32) {
    launch_pass<32, T, A>(ct, ids, out_cap, acc, src, alpha_ptr, alpha_val, beta_ptr, beta_val,
                          d, st);
  } else {
    launch_pass<64, T, A>(ct, ids, out_cap, acc, src, alpha_ptr, alpha_val, beta_ptr, beta_val,
                          d, st);
  }
}

}  // namespace

extern "C" {

// Launches on `stream` and returns cudaGetLastError() (0 on success), or
// cudaErrorInvalidValue for a leaf size other than 16, 32 or 64 or types
// it does not take.  Types: 0 f32, 1 bf16, 2 f64.  `ct` f32 [out_cap, b,
// b], the fine kernel's C^T blocks; `ids` int32 [out_cap], the union's
// ids; `acc` [n_acc, b, b] canonical, of type `acc_type` (`d_type`, or f32
// for bf16 D), or null (no accumulate), `pos_acc` int32[n_acc] its rows'
// union slots and `src` int32[out_cap] scratch; alpha read from
// `alpha_ptr` (a device f32 scalar) when it is not null, else taken from
// `alpha_val`; beta likewise from `beta_ptr`, a device scalar of
// promote_types(D's type, f32).  Writes `d` [out_cap, b, b] of type
// `d_type`, canonical.  Every pointer of blocks 16-byte aligned.
int hbsm_fine_epilogue(const float* ct, const int32_t* ids, int out_cap, int b, const void* acc,
                       int acc_type, const int32_t* pos_acc, int n_acc, const float* alpha_ptr,
                       double alpha_val, const void* beta_ptr, double beta_val, int32_t* src,
                       void* d, int d_type, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (b != 16 && b != 32 && b != 64) return static_cast<int>(cudaErrorInvalidValue);
  if (acc == nullptr) acc_type = d_type;
  const bool ok = (d_type == 0 && acc_type == 0) || (d_type == 1 && (acc_type == 1 || acc_type == 0))
                  || (d_type == 2 && acc_type == 2);
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  if (out_cap <= 0) return static_cast<int>(cudaGetLastError());
  if (acc != nullptr) {
    const cudaError_t err = cudaMemsetAsync(src, 0xff, out_cap * sizeof(int32_t), st);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (n_acc > 0) {
      fine_src_kernel<<<(n_acc + 255) / 256, 256, 0, st>>>(pos_acc, n_acc, out_cap, src);
    }
  }
  if (d_type == 0) {
    launch_leaf<float, float>(b, ct, ids, out_cap, acc, src, alpha_ptr, alpha_val, beta_ptr,
                              beta_val, d, st);
  } else if (d_type == 1 && acc_type == 1) {
    launch_leaf<__nv_bfloat16, __nv_bfloat16>(b, ct, ids, out_cap, acc, src, alpha_ptr,
                                              alpha_val, beta_ptr, beta_val, d, st);
  } else if (d_type == 1) {
    launch_leaf<__nv_bfloat16, float>(b, ct, ids, out_cap, acc, src, alpha_ptr, alpha_val,
                                      beta_ptr, beta_val, d, st);
  } else {
    launch_leaf<double, double>(b, ct, ids, out_cap, acc, src, alpha_ptr, alpha_val, beta_ptr,
                                beta_val, d, st);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* hbsm_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
