// Norm-based leaf truncation for Hopper (sm_90a): each block's squared
// Frobenius norm, its keep decision and a stable compaction of the kept
// blocks, in two passes over the block tensor.
//
// Replaces no TPU kernel.  The JAX package truncates in jnp
// (hierarchical_block_sparse_lib_tpu/ops/truncate.py): a squared copy of
// the blocks, a sum, a cumsum of the keep mask and a gather, which XLA
// fuses on the TPU.  Run eagerly on the card below 128-wide leaves, that
// chain wrote a squared copy of every block, read it back to sum it,
// scanned the mask through int64, inverted the slot map with a scatter and
// gathered the kept blocks with one more `where` over the output: ~24
// device operations and ~1.5 ms at the SP2 step of the water cluster.
//
// Two passes, on the caller's stream:
// 1. `truncate_norms_kernel` (or `truncate_count_kernel` where the caller
//    brings its own keep mask: the subtree mode, and 128-wide f32/bf16
//    leaves, whose norms kernels/csrc/norms.cu computes): for every slot,
//    keep = id != SENTINEL && ||block||_F^2 > tau^2, and one survivor count
//    per tile of slots.  A SENTINEL slot reads no block: padding is zero
//    by invariant and is never kept.
// 2. `truncate_compact_kernel`: each block of threads sums the tile counts
//    before its tile (its output offset) and all of them (the survivor
//    count), ranks its tile's survivors by a scan in slot order, and
//    copies each survivor's id and block to slot offset + rank, dropping
//    those at or past the output capacity; the slots from min(kept, cap)
//    on get SENTINEL and zero blocks, spread over all blocks of threads.
//    One block also writes nnz = min(kept, cap) and kept.  Blocks move as
//    raw 16-byte words, so the pass does not depend on the data type: ids
//    and blocks are the former gather's bits.
//
// The norm: each lane sums the squares of its 16-byte words into four
// partial sums (fused multiply-adds, in K = f32 for f32 and bf16, f64 for
// f64: the former torch.sum's accumulation type), adds them pairwise, and
// the warp adds its lanes by a butterfly.  The order is fixed, so a
// repeated call gives the same bits; it differs from torch.sum in the last
// bits, so a norm within rounding of tau^2 may keep or drop differently
// from the former chain.  tau^2 comes in K, squared by the caller as the
// former chain squared it: read from a device scalar (no host sync) or
// given by the host.
//
// What bounds it: bytes.  The norm pass reads each valid block once; the
// compaction reads each kept block once more and writes every output slot
// once.  At the SP2 step (262 144 slots of 32x32 f32, ~160 000-184 500
// valid, ~20 700-26 600 kept, 65 536 output slots) that is ~1.08 GB,
// 0.32 ms at 3.35 TB/s.  The design: one warp takes one block at a time,
// each lane issuing its 16-byte streaming loads (eight at b = 32 f32)
// before it adds any, eight warps a block of threads, and a tile of 256
// slots a block of threads (1 024 tiles at that step, all resident at
// once); the counts and the scans move a few MB.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int32_t kSentinel = 0x7fffffff;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 8;   // 16-byte words in flight a lane
constexpr int kFill = 64;    // output slots a block of threads pads, at least

// The squares of one 16-byte word of T, added into four partial sums of K.
__device__ __forceinline__ void add_squares(const uint4& w, const float*, float s[4]) {
  s[0] = fmaf(__uint_as_float(w.x), __uint_as_float(w.x), s[0]);
  s[1] = fmaf(__uint_as_float(w.y), __uint_as_float(w.y), s[1]);
  s[2] = fmaf(__uint_as_float(w.z), __uint_as_float(w.z), s[2]);
  s[3] = fmaf(__uint_as_float(w.w), __uint_as_float(w.w), s[3]);
}

__device__ __forceinline__ float bf16_lo(unsigned u) { return __uint_as_float(u << 16); }
__device__ __forceinline__ float bf16_hi(unsigned u) { return __uint_as_float(u & 0xffff0000u); }

__device__ __forceinline__ void add_squares(const uint4& w, const __nv_bfloat16*, float s[4]) {
  const unsigned u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float lo = bf16_lo(u[k]), hi = bf16_hi(u[k]);
    s[k] = fmaf(lo, lo, s[k]);
    s[k] = fmaf(hi, hi, s[k]);
  }
}

__device__ __forceinline__ void add_squares(const uint4& w, const double*, double s[4]) {
  const double a = __hiloint2double(static_cast<int>(w.y), static_cast<int>(w.x));
  const double b = __hiloint2double(static_cast<int>(w.w), static_cast<int>(w.z));
  s[0] = fma(a, a, s[0]);
  s[1] = fma(b, b, s[1]);
}

template <typename T> struct Accum { using K = float; };
template <> struct Accum<double> { using K = double; };

// The sum of one int a thread over the block of threads.
__device__ __forceinline__ int block_sum(int v, int* warp_sums) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  __syncthreads();  // warp_sums may still be read from a previous call
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = v;
  __syncthreads();
  int total = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) total += warp_sums[w];
  return total;
}

// Pass 1: keep[s] = ids[s] != SENTINEL && n2 > tau^2 for the slots of tile
// blockIdx.x, n2[s] the block's squared norm where `n2` is not null, and
// tile_counts[blockIdx.x] the tile's survivors.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    truncate_norms_kernel(const int32_t* __restrict__ ids, const uint4* __restrict__ data,
                          int cap, long long n_words, int tile,
                          const typename Accum<T>::K* tau2_ptr, typename Accum<T>::K tau2_val,
                          typename Accum<T>::K* __restrict__ n2, uint8_t* __restrict__ keep,
                          int32_t* __restrict__ tile_counts) {
  using K = typename Accum<T>::K;
  __shared__ int warp_sums[kWarps];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const K tau2 = tau2_ptr != nullptr ? *tau2_ptr : tau2_val;
  const long long first = static_cast<long long>(blockIdx.x) * tile;
  const long long last = first + tile < cap ? first + tile : cap;
  int kept = 0;
  for (long long s = first + warp; s < last; s += kWarps) {
    K total = K(0);
    if (ids[s] != kSentinel) {
      const uint4* p = data + s * n_words;
      K acc[4] = {K(0), K(0), K(0), K(0)};
      for (long long base = lane; base < n_words; base += 32 * kUnroll) {
        uint4 w[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const long long i = base + 32 * u;
          w[u] = i < n_words ? __ldcs(p + i) : make_uint4(0u, 0u, 0u, 0u);
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) add_squares(w[u], static_cast<const T*>(nullptr), acc);
      }
      total = (acc[0] + acc[1]) + (acc[2] + acc[3]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) total += __shfl_xor_sync(0xffffffffu, total, off);
    }
    const bool k = total > tau2;  // a SENTINEL slot's 0 is never > tau^2 >= 0
    if (lane == 0) {
      keep[s] = k ? 1 : 0;
      if (n2 != nullptr) n2[s] = total;
    }
    kept += k;
  }
  // Each lane of a warp holds the warp's count: take lane 0's.
  kept = lane == 0 ? kept : 0;
  kept = block_sum(kept, warp_sums);
  if (threadIdx.x == 0) tile_counts[blockIdx.x] = kept;
}

// Pass 1 with the caller's keep mask: tile_counts[blockIdx.x] = the slots
// of the tile with keep[s] and a valid id.
__global__ void __launch_bounds__(kThreads)
    truncate_count_kernel(const int32_t* __restrict__ ids, const uint8_t* __restrict__ keep,
                          int cap, int tile, int32_t* __restrict__ tile_counts) {
  __shared__ int warp_sums[kWarps];
  const long long first = static_cast<long long>(blockIdx.x) * tile;
  const long long last = first + tile < cap ? first + tile : cap;
  int kept = 0;
  for (long long s = first + threadIdx.x; s < last; s += kThreads) {
    kept += keep[s] != 0 && ids[s] != kSentinel;
  }
  kept = block_sum(kept, warp_sums);
  if (threadIdx.x == 0) tile_counts[blockIdx.x] = kept;
}

// One block's n_words 16-byte words from `src` to `dst`, by one warp.
__device__ __forceinline__ void copy_block(const uint4* __restrict__ src,
                                           uint4* __restrict__ dst, long long n_words,
                                           int lane) {
  for (long long base = lane; base < n_words; base += 32 * kUnroll) {
    uint4 w[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long i = base + 32 * u;
      if (i < n_words) w[u] = __ldcs(src + i);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long i = base + 32 * u;
      if (i < n_words) __stcs(dst + i, w[u]);
    }
  }
}

// Pass 2: tile blockIdx.x's survivors to their output slots, the padding of
// the output slots [blockIdx.x * fill, +fill) past the survivors, and
// (block 0) counts = {min(kept, out_cap), kept}.
__global__ void __launch_bounds__(kThreads)
    truncate_compact_kernel(const int32_t* __restrict__ ids, const uint4* __restrict__ data,
                            const uint8_t* __restrict__ keep, int cap, long long n_words,
                            int tile, const int32_t* __restrict__ tile_counts, int n_tiles,
                            int out_cap, int fill, int32_t* __restrict__ out_ids,
                            uint4* __restrict__ out_data, int32_t* __restrict__ counts) {
  __shared__ int warp_sums[kWarps];
  __shared__ long long src_slot[kThreads];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int t = blockIdx.x;

  // The survivors before this tile, and all of them.
  int before = 0, total = 0;
  for (int j = threadIdx.x; j < n_tiles; j += kThreads) {
    const int c = tile_counts[j];
    total += c;
    before += j < t ? c : 0;
  }
  before = block_sum(before, warp_sums);
  total = block_sum(total, warp_sums);
  const int nnz = total < out_cap ? total : out_cap;

  // This tile's survivors, a chunk of kThreads slots at a time.
  if (t < n_tiles) {
    const long long first = static_cast<long long>(t) * tile;
    const long long last = first + tile < cap ? first + tile : cap;
    int running = before;
    for (long long chunk = first; chunk < last && running < out_cap; chunk += kThreads) {
      const long long s = chunk + threadIdx.x;
      const int k = s < last && keep[s] != 0 && ids[s] != kSentinel;
      int incl = k;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int up = __shfl_up_sync(0xffffffffu, incl, off);
        if (lane >= off) incl += up;
      }
      __syncthreads();  // warp_sums and src_slot may still be read
      if (lane == 31) warp_sums[warp] = incl;
      __syncthreads();
      int rank = incl - k, chunk_kept = 0;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        rank += w < warp ? warp_sums[w] : 0;
        chunk_kept += warp_sums[w];
      }
      const int dst = running + rank;
      if (k && dst < out_cap) {
        out_ids[dst] = ids[s];
        src_slot[rank] = s;
      }
      __syncthreads();
      const int room = out_cap - running;
      const int n_copy = chunk_kept < room ? chunk_kept : room;
      for (int r = warp; r < n_copy; r += kWarps) {
        copy_block(data + src_slot[r] * n_words,
                   out_data + static_cast<long long>(running + r) * n_words, n_words, lane);
      }
      running += chunk_kept;
    }
  }

  // The padding: SENTINEL ids and zero blocks in this block's share of the
  // output slots past the survivors.
  const long long lo_share = static_cast<long long>(t) * fill;
  const long long hi_share = lo_share + fill < out_cap ? lo_share + fill : out_cap;
  const long long lo = lo_share > nnz ? lo_share : nnz;
  for (long long s = lo + threadIdx.x; s < hi_share; s += kThreads) out_ids[s] = kSentinel;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  for (long long s = lo + warp; s < hi_share; s += kWarps) {
    uint4* p = out_data + s * n_words;
    for (long long i = lane; i < n_words; i += 32) __stcs(p + i, zero);
  }

  if (t == 0 && threadIdx.x == 0) {
    counts[0] = nnz;
    counts[1] = total;
  }
}

int n_tiles_of(int cap, int tile) { return cap > 0 ? (cap + tile - 1) / tile : 0; }

template <typename T>
void launch_norms(const int32_t* ids, const void* data, int cap, long long n_words, int tile,
                  const void* tau2_ptr, double tau2_val, void* n2, uint8_t* keep,
                  int32_t* tile_counts, cudaStream_t st) {
  using K = typename Accum<T>::K;
  truncate_norms_kernel<T><<<n_tiles_of(cap, tile), kThreads, 0, st>>>(
      ids, static_cast<const uint4*>(data), cap, n_words, tile, static_cast<const K*>(tau2_ptr),
      static_cast<K>(tau2_val), static_cast<K*>(n2), keep, tile_counts);
}

}  // namespace

extern "C" {

// Pass 1.  Launches on `stream` and returns cudaGetLastError() (0 on
// success), or cudaErrorInvalidValue for a type it does not take or a tile
// that is not a positive multiple of 256.  `ids` int32[cap]; `data` [cap,
// n_words] 16-byte words of f32 (dtype 0), bf16 (1) or f64 (2), 16-byte
// aligned; tau^2 is read from `tau2_ptr` (a device scalar of K = f32, or
// f64 for f64 data) when it is not null, else taken from `tau2_val`;
// writes keep uint8[cap], tile_counts int32[ceil(cap / tile)] and, when
// `n2` is not null, n2 K[cap].
int hbsm_truncate_norms(const int32_t* ids, const void* data, int cap, long long n_words,
                        int dtype, int tile, const void* tau2_ptr, double tau2_val, void* n2,
                        uint8_t* keep, int32_t* tile_counts, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (tile <= 0 || tile % kThreads != 0 || dtype < 0 || dtype > 2) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (cap > 0) {
    if (dtype == 0) {
      launch_norms<float>(ids, data, cap, n_words, tile, tau2_ptr, tau2_val, n2, keep,
                          tile_counts, st);
    } else if (dtype == 1) {
      launch_norms<__nv_bfloat16>(ids, data, cap, n_words, tile, tau2_ptr, tau2_val, n2, keep,
                                  tile_counts, st);
    } else {
      launch_norms<double>(ids, data, cap, n_words, tile, tau2_ptr, tau2_val, n2, keep,
                           tile_counts, st);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

// Pass 1 with the caller's mask `keep` (uint8 or bool[cap]): writes
// tile_counts int32[ceil(cap / tile)].
int hbsm_truncate_count(const int32_t* ids, const uint8_t* keep, int cap, int tile,
                        int32_t* tile_counts, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (tile <= 0 || tile % kThreads != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (cap > 0) {
    truncate_count_kernel<<<n_tiles_of(cap, tile), kThreads, 0, st>>>(ids, keep, cap, tile,
                                                                     tile_counts);
  }
  return static_cast<int>(cudaGetLastError());
}

// Pass 2, after pass 1 on the same `ids`, `keep`, `cap` and `tile`: writes
// out_ids int32[out_cap], out_data [out_cap, n_words] 16-byte words and
// counts int32[2] = {min(kept, out_cap), kept}.
int hbsm_truncate_compact(const int32_t* ids, const void* data, const uint8_t* keep, int cap,
                          long long n_words, int tile, const int32_t* tile_counts, int out_cap,
                          int32_t* out_ids, void* out_data, int32_t* counts, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (tile <= 0 || tile % kThreads != 0 || out_cap < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int n_tiles = n_tiles_of(cap, tile);
  const int fill_blocks = (out_cap + kFill - 1) / kFill;
  int grid = n_tiles > fill_blocks ? n_tiles : fill_blocks;
  if (grid < 1) grid = 1;
  const int fill = (out_cap + grid - 1) / grid;
  truncate_compact_kernel<<<grid, kThreads, 0, st>>>(
      ids, static_cast<const uint4*>(data), keep, cap, n_words, tile, tile_counts, n_tiles,
      out_cap, fill, out_ids, static_cast<uint4*>(out_data), counts);
  return static_cast<int>(cudaGetLastError());
}

const char* hbsm_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
