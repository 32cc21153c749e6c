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
// What bounds it: memory and the per-product latency around it, then the
// FP32 rate at "highest".  Each product streams its 4 b^2-byte B block
// (each B block is read once per C row that meets it: 1.38 GB at B2
// against 54 MB of B), the 775 MB output is written once, and a 32x32x32
// product is only 64 KFLOP.  The design:
// - Work unit: one thread block per chunk of a C row's slots in one
//   column window (`chunks`, built with the plan: pallas_gemm_fine.py::
//   slot_chunks), so the row's A blocks serve every slot of the chunk and
//   the blocks running at once read one window's share of B, which L2
//   holds.
// - A reuse: the row's A^T blocks are staged once per block into dynamic
//   shared memory (`cp.async`), in k-chunks of up to `kc` entries, with
//   each entry's visible B row (the row cap) as a bitmap over the chunk's
//   columns.  A row longer than a k-chunk takes several; the slots'
//   partial sums pass from one to the next through `out`.
// - Ownership: a team (a warp at b = 16, 32; a warpgroup at b = 64) owns
//   one slot at a time, taken from a per-block counter, and keeps its
//   C^T block in registers.  A slot's hits are one bitmap test per A
//   entry, a lane each, and a `__ballot_sync`: no block barrier inside a
//   k-chunk.
// - B streaming: each team owns a ring of two B^T blocks in shared
//   memory, filled by `cp.async` 16-byte copies; the next product's block
//   is issued before this product's arithmetic, and one team barrier per
//   product (a `__syncwarp` for a warp) both publishes the landed block
//   and frees the stage it refills.  Output stores are streaming and
//   fire-and-forget, so one slot's store overlaps the next slot's loads.
// - The product: "highest" FP32 FFMA from register tiles fed by 16-byte
//   shared loads, at b <= 32 with the depth split between half-warps
//   (8x8 tiles at b = 32) and the halves added once per slot; "high" and
//   "default" bf16 `mma.sync.m16n8k16` (A's fragments by
//   `ldmatrix.trans`), "high" as three passes (hi*hi + hi*lo + lo*hi)
//   with A split into bf16 hi/lo planes once per k-chunk and B once per
//   product as its fragments load.
// wgmma and TMA are not used: a leaf product is at most 64x64x64, below
// the tiles where they pay, and B comes one block per product.
//
// Determinism: each slot is written by the one team that takes it, which
// accumulates its products serially in ascending A-entry order (each
// product summed on its own, then added), in f32 registers, with no
// atomics on data; every team holds a slot in the same thread layout.  A
// fixed plan gives bitwise-equal results.
//
// Precision (the reference's three tiers, kernels/mxu.py):
//   0 "highest": f32 operands, FP32 FFMA;
//   1 "high":    f32 operands split as x = hi + lo with hi = bf16(x),
//                lo = bf16(x - hi); hi*hi + hi*lo + lo*hi per product;
//   2 "default": bf16 operands (alpha folded in before rounding), f32
//                products and f32 accumulation.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

namespace {

constexpr int kSentinel = 0x7fffffff;
constexpr int kMaxKc = 64;             // A entries per k-chunk: two ballots
constexpr int kSpan = 256;             // columns a chunk's slots may span
constexpr int kWords = kSpan / 32;     // bitmap words per A entry
constexpr int kWordStride = kWords + 1;  // odd: lanes' words on distinct banks
constexpr int kStages = 2;             // B^T blocks in a team's ring
                                       // (deeper rings measured slower)
constexpr int kSmemPerSm = 233472;     // 228 KB of shared memory per SM
constexpr int kSmemPerBlock = 232448;  // 227 KB at most per block
constexpr int kSmemReserved = 1024;    // the runtime's share per block

enum Mode { kFfma = 0, kSplit = 1, kBf16 = 2 };

template <int B, int M>
struct Cfg {
  // Threads per slot: a warp (b = 16, 32), a warpgroup (b = 64); each
  // warp of a team holds a band of the slot's rows.
  static constexpr int kTeam = B == 64 ? 128 : 32;
  static constexpr int kThreads = 256;
  static constexpr int kTeams = kThreads / kTeam;
  static constexpr int kRowsPerWarp = B / (kTeam / 32);
  using Elem = typename std::conditional<M == kBf16, __nv_bfloat16, float>::type;
  static constexpr int kEs = sizeof(Elem);
  // A staged B^T row: +4 floats keeps the FFMA tile's two row loads of a
  // quarter warp on distinct banks, +8 elements the mma fragments'.
  static constexpr int kBStride = M == kFfma ? B + 4 : B + 8;
  static constexpr int kStageBytes = B * kBStride * kEs;
  // A entry: (alpha A)^T rows as staged, element (k, n) at k * kAStride +
  // n: f32 for FFMA, bf16 planes for mma (hi and lo at "high"), whose rows
  // `ldmatrix.trans` reads as the mma's B fragments (+8: the 8 rows of one
  // 8x8 matrix on distinct banks).
  static constexpr int kAStride = M == kFfma ? B : B + 8;
  static constexpr int kAPlane = M == kFfma ? B * B * 4 : B * (B + 8) * 2;
  static constexpr int kAEntryBytes = (M == kSplit ? 2 : 1) * kAPlane;
  // FFMA: at b <= 32 a warp splits each product's depth between its two
  // half-warps (kSplitK = 2), each thread summing a kTR x kTC tile of its
  // warp's rows (4x4 at b = 16, 8x8 at b = 32: 16 FMAs per 16-byte shared
  // load); at b = 64 no split, 8x4.
  static constexpr int kSplitK = M == kFfma && B <= 32 ? 2 : 1;
  static constexpr int kTR = B == 16 ? 4 : 8;
  static constexpr int kTC = B == 32 ? 8 : 4;
  static constexpr int kMT = B == 32 ? 2 : 1;  // mma: 16-row tiles per warp
  static constexpr int kNT = B / 8;            // mma: 8-column tiles
  static constexpr int kAcc = B * B * kSplitK / kTeam;  // f32 sums per thread
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Barrier of one slot team: a warp, or warpgroup `team` (named barrier).
template <int T>
__device__ __forceinline__ void team_sync(int team) {
  if constexpr (T == 32) {
    __syncwarp();
  } else {
    asm volatile("bar.sync %0, %1;\n" ::"r"(team + 1), "n"(T) : "memory");
  }
}

// The mma's B fragments (16 rows k, 8 columns n) of a row-major bf16
// matrix in shared memory; lane l < 16 passes the address of row l.
__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t* r, const __nv_bfloat16* row) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(row));
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(a));
}

__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 v) {
  return *reinterpret_cast<const uint32_t*>(&v);
}

// (x, y) -> bf16 pairs hi = bf16(x, y), lo = bf16((x, y) - hi).
__device__ __forceinline__ void split2(float2 v, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(v.x, v.y);
  const float2 hf = __bfloat1622float2(h);
  hi = as_u32(h);
  lo = as_u32(__floats2bfloat162_rn(v.x - hf.x, v.y - hf.y));
}

// d += A(16x16) B(16x8), bf16 operands in the m16n8k16 fragment layout.
__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// One slot's C^T block, spread over a team's registers.  `tt` is the
// thread's rank in its team; every method touches the same elements, so
// which team holds a slot does not change its arithmetic.  Stores are
// streaming (evict first): the output is written once and should not push
// the B blocks out of L2.
template <int B, int M>
struct Tile {
  using C = Cfg<B, M>;
  static constexpr int kSK = C::kSplitK;
  static constexpr int kLanes = 32 / kSK;  // lanes per K-half of a warp
  static constexpr int kNcg = B / C::kTC, kNrg = C::kRowsPerWarp / C::kTR;
  float acc[C::kAcc];

  // FFMA geometry: a thread of K-half h (split-K: lanes 16..31 take the
  // upper half of each product's depth) holds rows row(u), u < kTR, of its
  // warp's band, and columns col .. col + kTC - 1.  Split-K rows
  // interleave so that the two row groups of a quarter warp fall on
  // distinct banks.
  __device__ __forceinline__ static int half(int tt) { return (tt & 31) / kLanes; }
  __device__ __forceinline__ static int row(int tt, int u) {
    const int rg = (tt & 31) % kLanes / kNcg;
    return (tt >> 5) * C::kRowsPerWarp + (kSK == 2 ? rg + kNrg * u : rg * C::kTR + u);
  }
  __device__ __forceinline__ static int col(int tt) { return (tt & 31) % kLanes % kNcg * C::kTC; }
  // mma geometry: the C fragment's float2 number v.
  __device__ __forceinline__ static int frag(int tt, int v) {
    const int lane = tt & 31, g = lane >> 2, t2 = (lane & 3) * 2;
    const int row0 = B == 64 ? 16 * (tt >> 5) : 0;
    const int r8 = v & 1, nt = (v >> 1) % C::kNT, mt = (v >> 1) / C::kNT;
    return (row0 + 16 * mt + g + 8 * r8) * B + 8 * nt + t2;
  }

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int u = 0; u < C::kAcc; ++u) acc[u] = 0.f;
  }

  // Write the slot (split-K: the two halves' sums added, each half
  // storing half of the rows); with kZeros, zeros instead.
  template <bool kZeros = false>
  __device__ __forceinline__ void store(float* dst, int tt) const {
    if constexpr (M == kFfma) {
      // Split-K: half h stores rows [h, h+1) * kTR / 2 of its tile; each
      // shuffle sends the partner the value of a row the partner stores.
      constexpr int kRows = C::kTR / kSK;
      const int h = half(tt), c = col(tt);
#pragma unroll
      for (int u = 0; u < kRows; ++u) {
#pragma unroll
        for (int v = 0; v < C::kTC; v += 4) {
          float x[4];
#pragma unroll
          for (int w = 0; w < 4; ++w) {
            if constexpr (kZeros) {
              x[w] = 0.f;
            } else if constexpr (kSK == 2) {
              const float lo = acc[u * C::kTC + v + w];
              const float hi = acc[(u + kRows) * C::kTC + v + w];
              const float mine = h ? hi : lo, theirs = h ? lo : hi;
              x[w] = mine + __shfl_xor_sync(0xffffffffu, theirs, 16);
            } else {
              x[w] = acc[u * C::kTC + v + w];
            }
          }
          __stcs(reinterpret_cast<float4*>(dst + row(tt, u + h * kRows) * B + c + v),
                 make_float4(x[0], x[1], x[2], x[3]));
        }
      }
    } else {
#pragma unroll
      for (int v = 0; v < C::kAcc / 2; ++v) {
        __stcs(reinterpret_cast<float2*>(dst + frag(tt, v)),
               kZeros ? make_float2(0.f, 0.f) : make_float2(acc[2 * v], acc[2 * v + 1]));
      }
    }
  }

  // The sums of earlier k-chunks (split-K: all in the lower half).
  __device__ __forceinline__ void load(const float* src, int tt) {
    if constexpr (M == kFfma) {
      const bool keep = half(tt) == 0;
      const int c = col(tt);
#pragma unroll
      for (int u = 0; u < C::kTR; ++u) {
#pragma unroll
        for (int v = 0; v < C::kTC; v += 4) {
          const float4 x = *reinterpret_cast<const float4*>(src + row(tt, u) * B + c + v);
          acc[u * C::kTC + v] = keep ? x.x : 0.f;
          acc[u * C::kTC + v + 1] = keep ? x.y : 0.f;
          acc[u * C::kTC + v + 2] = keep ? x.z : 0.f;
          acc[u * C::kTC + v + 3] = keep ? x.w : 0.f;
        }
      }
    } else {
#pragma unroll
      for (int v = 0; v < C::kAcc / 2; ++v) {
        const float2 x = *reinterpret_cast<const float2*>(src + frag(tt, v));
        acc[2 * v] = x.x;
        acc[2 * v + 1] = x.y;
      }
    }
  }

  // acc += B^T (alpha A)^T: `sb` a staged B^T block, `sa` an A entry.
  __device__ __forceinline__ void multiply_add(const unsigned char* sb,
                                               const unsigned char* sa, int tt) {
    if constexpr (M == kFfma) {
      const int m0 = half(tt) * (B / kSK);
      const float* b = reinterpret_cast<const float*>(sb) + m0;
      const float* a = reinterpret_cast<const float*>(sa) + m0 * B + col(tt);
      int boff[C::kTR];
#pragma unroll
      for (int u = 0; u < C::kTR; ++u) boff[u] = row(tt, u) * C::kBStride;
      float part[C::kAcc];  // this product alone, then added: as the plain version
#pragma unroll
      for (int u = 0; u < C::kAcc; ++u) part[u] = 0.f;
#pragma unroll
      for (int m = 0; m < B / kSK; m += 4) {
        float4 bv[C::kTR];
#pragma unroll
        for (int u = 0; u < C::kTR; ++u) {
          bv[u] = *reinterpret_cast<const float4*>(b + boff[u] + m);
        }
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          float av[C::kTC];
#pragma unroll
          for (int v = 0; v < C::kTC; v += 4) {
            *reinterpret_cast<float4*>(av + v) =
                *reinterpret_cast<const float4*>(a + (m + t) * B + v);
          }
#pragma unroll
          for (int u = 0; u < C::kTR; ++u) {
            const float x = t == 0 ? bv[u].x : t == 1 ? bv[u].y : t == 2 ? bv[u].z : bv[u].w;
#pragma unroll
            for (int v = 0; v < C::kTC; ++v) {
              part[u * C::kTC + v] = fmaf(x, av[v], part[u * C::kTC + v]);
            }
          }
        }
      }
#pragma unroll
      for (int u = 0; u < C::kAcc; ++u) acc[u] += part[u];
    } else {
      const int lane = tt & 31, g = lane >> 2, t2 = (lane & 3) * 2;
      const int row0 = B == 64 ? 16 * (tt >> 5) : 0;
      const __nv_bfloat16* ahi = reinterpret_cast<const __nv_bfloat16*>(sa);
      const __nv_bfloat16* alo = ahi + C::kAPlane / 2;
#pragma unroll
      for (int k0 = 0; k0 < B; k0 += 16) {
        uint32_t fh[C::kMT][4], fl[C::kMT][4];  // B^T: the mma's A operand
#pragma unroll
        for (int mt = 0; mt < C::kMT; ++mt) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
#pragma unroll
            for (int r = 0; r < 2; ++r) {
              const int off = (row0 + 16 * mt + g + 8 * r) * C::kBStride + k0 + t2 + 8 * h;
              if constexpr (M == kBf16) {
                fh[mt][2 * h + r] = *reinterpret_cast<const uint32_t*>(
                    reinterpret_cast<const __nv_bfloat16*>(sb) + off);
              } else {
                split2(*reinterpret_cast<const float2*>(
                           reinterpret_cast<const float*>(sb) + off),
                       fh[mt][2 * h + r], fl[mt][2 * h + r]);
              }
            }
          }
        }
#pragma unroll
        for (int nt = 0; nt < C::kNT; ++nt) {
          const int off = (k0 + (lane & 15)) * C::kAStride + 8 * nt;
          uint32_t gh[2], gl[2];  // alpha A: the mma's B operand
          ldmatrix_x2_trans(gh, ahi + off);
          if constexpr (M == kSplit) ldmatrix_x2_trans(gl, alo + off);
#pragma unroll
          for (int mt = 0; mt < C::kMT; ++mt) {
            float* d = acc + 4 * (mt * C::kNT + nt);
            mma_bf16(d, fh[mt], gh);
            if constexpr (M == kSplit) {
              mma_bf16(d, fh[mt], gl);
              mma_bf16(d, fl[mt], gh);
            }
          }
        }
      }
    }
  }
};

// Stage A entries e0 .. e0+nk-1 of `at` into `sa` in the tier's form
// (whole block; FFMA copies are left in flight in one cp.async group).
template <int B, int M>
__device__ __forceinline__ void stage_a(unsigned char* sa,
                                        const typename Cfg<B, M>::Elem* at,
                                        int e0, int nk) {
  using C = Cfg<B, M>;
  const size_t base = static_cast<size_t>(e0) * B * B;
  if constexpr (M == kFfma) {
    const unsigned char* src = reinterpret_cast<const unsigned char*>(at + base);
    for (int c = threadIdx.x; c < nk * B * B / 4; c += C::kThreads) {
      cp_async16(sa + 16 * c, src + 16 * c);
    }
    cp_async_commit();
  } else if constexpr (M == kBf16) {  // padded rows: 16-byte copies
    constexpr int kRowChunks = B * 2 / 16;
    const unsigned char* src = reinterpret_cast<const unsigned char*>(at + base);
    for (int c = threadIdx.x; c < nk * B * kRowChunks; c += C::kThreads) {
      const int row = c / kRowChunks;  // entry row / B, k row % B
      cp_async16(sa + (row / B) * C::kAEntryBytes + (row % B) * C::kAStride * 2 +
                     16 * (c % kRowChunks),
                 src + 16 * c);
    }
    cp_async_commit();
  } else {  // "high": f32 split into bf16 hi and lo planes, four at a time
#pragma unroll 4
    for (int v = threadIdx.x; v < nk * B * B / 4; v += C::kThreads) {
      const int x = 4 * v, e = x / (B * B), k = (x / B) % B, n0 = x % B;
      __nv_bfloat16* hi = reinterpret_cast<__nv_bfloat16*>(sa + e * C::kAEntryBytes) +
                          k * C::kAStride + n0;
      const float4 f = *reinterpret_cast<const float4*>(at + base + x);
      uint32_t h01, l01, h23, l23;
      split2(make_float2(f.x, f.y), h01, l01);
      split2(make_float2(f.z, f.w), h23, l23);
      *reinterpret_cast<uint2*>(hi) = make_uint2(h01, h23);
      *reinterpret_cast<uint2*>(hi + C::kAPlane / 2) = make_uint2(l01, l23);
    }
  }
}

// A team's walk over the products of one k-chunk.  Teams take the
// block's slots one at a time, in slot order, from a shared counter (so a
// team with short slots takes more of them), one slot ahead of the one at
// hand, whose column is then on its way; for each slot, the hits of the
// k-chunk's A entries in ascending order (two ballots of 32 entries).  A
// slot with no hit is written here (zeros) in the first k-chunk.  Which
// team takes a slot does not change its arithmetic: every team holds a
// slot's sums in the same thread layout.
template <int B, int M>
struct Walk {
  using C = Cfg<B, M>;
  const int* ccol;
  const unsigned* bits;  // per A entry: its visible B row's columns, less cbase
  const int* pre;        // per A entry and word: B entry of the word's first bit
  int* counter;          // the block's next slot to take, from s0
  int* team_slot;        // a multi-warp team's slot as taken
  float* out;
  int cbase, nk, s0, s1, team, tt;
  bool first;
  int s, g, qv, j, next_s, next_j, hits;
  unsigned mask;

  __device__ __forceinline__ int take() {
    if constexpr (C::kTeam == 32) {
      int n = 0;
      if (tt == 0) n = atomicAdd(counter, 1);
      return s0 + __shfl_sync(0xffffffffu, n, 0);
    } else {
      if (tt == 0) team_slot[team] = atomicAdd(counter, 1);
      team_sync<C::kTeam>(team);
      const int n = team_slot[team];
      team_sync<C::kTeam>(team);
      return s0 + n;
    }
  }

  __device__ __forceinline__ void start() {
    g = 1 << 20;
    mask = 0u;
    s = -1;
    hits = 1;
    next_s = take();
    next_j = next_s < s1 ? ccol[next_s] : 0;
  }

  // The next product (slot, A entry in the k-chunk, B entry), or false.
  __device__ __forceinline__ bool next(int& slot, int& e, int& q) {
    const int lane = threadIdx.x & 31;
    for (;;) {
      if (mask) {
        const int l = __ffs(mask) - 1;
        mask &= mask - 1u;
        slot = s;
        e = 32 * g + l;
        q = __shfl_sync(0xffffffffu, qv, l);
        ++hits;
        return true;
      }
      if (32 * ++g >= nk) {  // the slot is done: take the next
        if (first && hits == 0) {
          Tile<B, M>().template store<true>(out + static_cast<size_t>(s) * B * B, tt);
        }
        hits = 1;
        if (next_s >= s1) return false;
        g = 0;
        s = next_s;
        j = next_j;
        hits = 0;
        next_s = take();
        next_j = next_s < s1 ? ccol[next_s] : 0;
      }
      // Lane l tests A entry 32g+l's bitmap for column j; a hit's B
      // entry is the word's first plus the bits below j.
      const int el = 32 * g + lane, rel = j - cbase;
      const unsigned bit = 1u << (rel & 31);
      int hit = -1;
      if (el < nk) {
        const unsigned word = bits[el * kWordStride + (rel >> 5)];
        if (word & bit) hit = pre[el * kWordStride + (rel >> 5)] + __popc(word & (bit - 1u));
      }
      mask = __ballot_sync(0xffffffffu, hit >= 0);
      qv = hit;
    }
  }
};

template <int B, int M>
__device__ __forceinline__ void issue_b(unsigned char* stage,
                                        const typename Cfg<B, M>::Elem* bt,
                                        int q, int tt) {
  using C = Cfg<B, M>;
  constexpr int kRowChunks = B * C::kEs / 16;
  const unsigned char* src =
      reinterpret_cast<const unsigned char*>(bt + static_cast<size_t>(q) * B * B);
#pragma unroll
  for (int ch = tt; ch < B * kRowChunks; ch += C::kTeam) {
    cp_async16(stage + (ch / kRowChunks) * C::kBStride * C::kEs + 16 * (ch % kRowChunks),
               src + 16 * ch);
  }
}

template <int B, int M>
__global__ void __launch_bounds__(Cfg<B, M>::kThreads, 1)
    fine_spgemm_kernel(const int* __restrict__ chunks, int n_chunks,
                       const int* __restrict__ out_ids,
                       const int* __restrict__ ccol,
                       const int* __restrict__ a_row_start,
                       const int* __restrict__ a_col,
                       const int* __restrict__ b_row_start,
                       const int* __restrict__ b_col,
                       const typename Cfg<B, M>::Elem* __restrict__ at,
                       const typename Cfg<B, M>::Elem* __restrict__ bt,
                       float* __restrict__ out, int nbc, int brm, int kc) {
  using C = Cfg<B, M>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int s0 = chunks[blockIdx.x], s1 = chunks[n_chunks + blockIdx.x];
  if (s0 >= s1) return;
  const int id0 = out_ids[s0];
  if (id0 == kSentinel) {  // the tail past the last used slot: zeros
    float4* dst = reinterpret_cast<float4*>(out + static_cast<size_t>(s0) * B * B);
    for (int v = threadIdx.x; v < (s1 - s0) * B * B / 4; v += C::kThreads) {
      __stcs(dst + v, make_float4(0.f, 0.f, 0.f, 0.f));
    }
    return;
  }
  const int team = threadIdx.x / C::kTeam, tt = threadIdx.x % C::kTeam;
  const int ea = a_row_start[id0 / nbc];
  const int na = a_row_start[id0 / nbc + 1] - ea;
  const int cbase = ccol[s0];
  if (ccol[s1 - 1] - cbase >= kSpan) __trap();  // the tables' windows are wider
  unsigned char* ring = smem + team * kStages * C::kStageBytes;
  unsigned char* sa = smem + C::kTeams * kStages * C::kStageBytes;
  unsigned* bits = reinterpret_cast<unsigned*>(sa + kc * C::kAEntryBytes);
  int* pre = reinterpret_cast<int*>(bits + kc * kWordStride);
  int* bq = pre + kc * kWordStride;  // first B entry of each A entry's row
  int* bn = bq + kc;                 // visible length of that row
  int* below = bn + kc;              // its visible entries left of cbase
  Walk<B, M> w;
  w.ccol = ccol;
  w.bits = bits;
  w.pre = pre;
  w.counter = below + kc;
  w.team_slot = w.counter + 1;
  w.out = out;
  w.cbase = cbase;
  w.s0 = s0;
  w.s1 = s1;
  w.team = team;
  w.tt = tt;
  Tile<B, M> tile;

  for (int k0 = 0; k0 == 0 || k0 < na; k0 += kc) {
    const bool first = k0 == 0;
    w.first = first;
    w.nk = min(kc, na - k0);
    if (!first) __syncthreads();  // every team is done with the last k-chunk
    stage_a<B, M>(sa, at, ea + k0, w.nk);
    // Each A entry's visible B row (the row cap) as a bitmap of the
    // chunk's column span, and the B entry of each word's first bit.
    for (int t = threadIdx.x; t < w.nk; t += C::kThreads) {
      const int k = a_col[ea + k0 + t];
      bq[t] = b_row_start[k];
      bn[t] = min(b_row_start[k + 1] - bq[t], brm);
      below[t] = 0;
    }
    for (int x = threadIdx.x; x < w.nk * kWordStride; x += C::kThreads) bits[x] = 0u;
    if (threadIdx.x == 0) *w.counter = 0;
    __syncthreads();
#pragma unroll 4
    for (int x = threadIdx.x; x < w.nk * brm; x += C::kThreads) {
      const int t = x / brm, c = x % brm;
      if (c < bn[t]) {
        const int rel = b_col[bq[t] + c] - cbase;
        if (rel < 0) {
          atomicAdd(&below[t], 1);
        } else if (rel < kSpan) {
          atomicOr(&bits[t * kWordStride + (rel >> 5)], 1u << (rel & 31));
        }
      }
    }
    __syncthreads();
    for (int x = threadIdx.x; x < w.nk * kWords; x += C::kThreads) {
      const int t = x / kWords, wd = x % kWords;
      int q = bq[t] + below[t];
      for (int u = 0; u < wd; ++u) q += __popc(bits[t * kWordStride + u]);
      pre[t * kWordStride + wd] = q;
    }
    cp_async_wait_all();
    __syncthreads();

    // The team's products, the next one's B load in flight during each.
    w.start();
    int slot, e, q;
    bool valid = w.next(slot, e, q);
    if (valid) issue_b<B, M>(ring, bt, q, tt);
    cp_async_commit();
    int held = -1;  // the slot whose sums are in registers
    for (int cur = 0; valid; cur ^= 1) {  // cur: the ring stage at hand
      cp_async_wait_all();
      team_sync<C::kTeam>(team);  // its block has landed; the other stage
                                   // is no longer read
      int ns, ne, nq;
      const bool nv = w.next(ns, ne, nq);
      if (nv) issue_b<B, M>(ring + (cur ^ 1) * C::kStageBytes, bt, nq, tt);
      cp_async_commit();
      if (slot != held) {
        if (held >= 0) tile.store(out + static_cast<size_t>(held) * B * B, tt);
        held = slot;
        if (first) {
          tile.zero();
        } else {  // the sums of the earlier k-chunks
          tile.load(out + static_cast<size_t>(held) * B * B, tt);
        }
      }
      tile.multiply_add(ring + cur * C::kStageBytes, sa + e * C::kAEntryBytes, tt);
      slot = ns;
      e = ne;
      q = nq;
      valid = nv;
    }
    if (held >= 0) tile.store(out + static_cast<size_t>(held) * B * B, tt);
  }
}

struct Args {
  const int* chunks;
  int n_chunks;
  const int *out_ids, *ccol, *a_row_start, *a_col, *b_row_start, *b_col;
  const void *at, *bt;
  float* out;
  int nbc, brm;
};

// Launch (info == nullptr) or describe the launch: info[0..5] = k-chunk
// entries, dynamic shared bytes, resident blocks per SM, registers per
// thread, local (spill) bytes per thread, threads per block.
template <int B, int M>
int run(const Args& a, int ctas_per_sm, cudaStream_t stream, int* info) {
  using C = Cfg<B, M>;
  const int ring = C::kTeams * kStages * C::kStageBytes;
  const int per_entry = C::kAEntryBytes + 4 * (2 * kWordStride + 3);
  const int budget =
      std::min(kSmemPerBlock, kSmemPerSm / std::max(ctas_per_sm, 1) - kSmemReserved);
  const int kc = std::min(kMaxKc, (budget - ring - 4 * (1 + C::kTeams)) / per_entry);
  if (kc < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int smem = ring + kc * per_entry + 4 * (1 + C::kTeams);  // + slot counters
  auto kernel = fine_spgemm_kernel<B, M>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (info != nullptr) {
    int blocks = 0;
    cudaFuncAttributes attr;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, C::kThreads, smem);
    if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, kernel);
    if (err != cudaSuccess) return static_cast<int>(err);
    info[0] = kc;
    info[1] = smem;
    info[2] = blocks;
    info[3] = attr.numRegs;
    info[4] = static_cast<int>(attr.localSizeBytes);
    info[5] = C::kThreads;
    return 0;
  }
  using E = typename C::Elem;
  kernel<<<a.n_chunks, C::kThreads, smem, stream>>>(
      a.chunks, a.n_chunks, a.out_ids, a.ccol, a.a_row_start, a.a_col, a.b_row_start,
      a.b_col, static_cast<const E*>(a.at), static_cast<const E*>(a.bt), a.out,
      a.nbc, a.brm, kc);
  return static_cast<int>(cudaGetLastError());
}

template <int B>
int dispatch_precision(int precision, const Args& a, int ctas_per_sm,
                       cudaStream_t stream, int* info) {
  switch (precision) {
    case 0:
      return run<B, kFfma>(a, ctas_per_sm, stream, info);
    case 1:
      return run<B, kSplit>(a, ctas_per_sm, stream, info);
    case 2:
      return run<B, kBf16>(a, ctas_per_sm, stream, info);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

int dispatch(int block_size, int precision, const Args& a, int ctas_per_sm,
             cudaStream_t stream, int* info) {
  switch (block_size) {
    case 16:
      return dispatch_precision<16>(precision, a, ctas_per_sm, stream, info);
    case 32:
      return dispatch_precision<32>(precision, a, ctas_per_sm, stream, info);
    case 64:
      return dispatch_precision<64>(precision, a, ctas_per_sm, stream, info);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// Every pointer is device memory: ids and tables int32 (`chunks` holds
// n_chunks first slots, then n_chunks ends), `at`/`bt` f32 (precision 0, 1) or bf16
// (precision 2) blocks, `out` f32 [out_cap, b, b].  `b_row_max` is the
// bucketed B row cap; `ctas_per_sm` the resident blocks per SM that the
// shared-memory budget is sized for.
int hbsm_fine_spgemm(const int* chunks, int n_chunks, const int* out_ids,
                     const int* ccol, const int* a_row_start, const int* a_col,
                     const int* b_row_start, const int* b_col, const void* at,
                     const void* bt, float* out, int nbc, int b_row_max,
                     int block_size, int precision, int ctas_per_sm, void* stream) {
  if (n_chunks == 0) return 0;
  const Args a{chunks, n_chunks, out_ids, ccol, a_row_start, a_col,
               b_row_start, b_col, at, bt, out, nbc, b_row_max};
  return dispatch(block_size, precision, a, ctas_per_sm,
                  static_cast<cudaStream_t>(stream), nullptr);
}

// The launch `hbsm_fine_spgemm` would make, without making it: info[0..5]
// = k-chunk entries, dynamic shared bytes, resident blocks per SM
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), registers and local
// bytes per thread, threads per block.  Returns a CUDA error code.
int hbsm_fine_spgemm_config(int block_size, int precision, int b_row_max,
                            int ctas_per_sm, int* info) {
  Args a{};
  a.brm = b_row_max;
  return dispatch(block_size, precision, a, ctas_per_sm, nullptr, info);
}

const char* hbsm_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
