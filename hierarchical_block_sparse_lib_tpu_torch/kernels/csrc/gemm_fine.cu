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
// What bounds it: the walk around the products (per block: A's row
// staged, its B rows' bitmaps; per slot: the sums' round trips between
// k-chunks and the store; per product: the B block's latency from L2),
// then the product, at "highest" b = 32 3xTF32 on the tensor cores (165
// TFLOP/s of product work at most; a 32x32x32 product is 96 mma.sync a
// warp).  Each product streams its 4 b^2-byte B block (each B block is
// read once per C row that meets it: 1.38 GB at B2 against 54 MB of B).
// The design:
// - Work unit: one thread block per chunk of a C row's slots in one
//   column window (`chunks`, built with the plan: pallas_gemm_fine.py::
//   slot_chunks), so the row's A blocks serve every slot of the chunk and
//   the blocks running at once read one window's share of B, which L2
//   holds.
// - A reuse: the row's A^T blocks are staged once per block into dynamic
//   shared memory (`cp.async`), in k-chunks of up to `kc` entries, with
//   each entry's visible B row (the row cap) in the chunk's column span
//   found by binary search and marked as a bitmap over the span.  A row
//   longer than a k-chunk takes several; the slots' sums pass from one to
//   the next through `out`, unrounded, kept in L2 until the last.
// - Ownership: a team (a warp at b = 16, 32; a warpgroup at b = 64) owns
//   one slot at a time, taken from a per-block counter, and keeps its
//   C^T block in registers.  A slot's hits are one bitmap test per A
//   entry, a lane each, and a `__ballot_sync`: no block barrier inside a
//   k-chunk.
// - B streaming: each team owns a ring of two B^T blocks in shared
//   memory, filled by `cp.async` 16-byte copies; the next product's block
//   is issued before this product's arithmetic, and one team barrier per
//   product (a `__syncwarp` for a warp) both publishes the landed block
//   and frees the stage it refills.  Output stores are fire-and-forget, so
//   one slot's store overlaps the next slot's loads.
// - The product: "highest" at b = 32 3xTF32 `mma.sync.m16n8k8` (lo*hi +
//   hi*lo + hi*hi each k-step), each operand split into tf32 hi and lo as
//   its fragments load from shared memory (B: one 16-byte load a row and
//   16 of the depth; A: f32 rows, so a k-chunk holds as many entries as
//   FFMA's; both take the same order of k, `k_of`); at b = 16 and 64 FP32
//   FFMA from register tiles fed by 16-byte shared loads (at b = 16 with
//   the depth split between half-warps, the halves added once per slot),
//   where 3xTF32 measured slower; "high" and "default" bf16
//   `mma.sync.m16n8k16` (A's fragments by `ldmatrix.trans`), "high" as
//   three passes with A split into bf16 hi/lo planes once per k-chunk and
//   B once per product.
// - Why 3xTF32 sums each product into zeroed registers and then adds it
//   with one rounded FADD: the tensor cores' accumulator
//   drops low bits at every mma, so a slot's sums fed to it mma by mma
//   would lose about a part in 2^24 of themselves at each one (3xTF32 into
//   the sums directly missed a 1e-5 gate in the ring engine, gemm_tile.cuh).
// - Shapes at b = 32 "highest" (pallas_gemm_fine.py::launch_shape): where
//   a chunk holds 40 output slots or more on average, blocks of 256
//   threads, one an SM, with the largest k-chunk (39 entries), since its
//   eight warps have slots enough and each extra k-chunk costs every slot
//   a round trip of its sums; where it holds fewer, blocks of 128
//   threads, three an SM (at most 170 registers), k-chunks of 10, so that
//   one block's staging and bitmaps run under the others' products.
// wgmma and TMA are not used: a leaf product is at most 64x64x64, below
// the tiles where they pay, and B comes one block per product.
//
// Determinism: each slot is written by the one team that takes it, which
// accumulates its products serially in ascending A-entry order (each
// product summed on its own, then added), in f32 registers, with no
// atomics on data; every team holds a slot in the same thread layout.  A
// fixed plan gives bitwise-equal results; at 3xTF32 and the bf16 tiers the
// launch sizes (shape, k-chunk, chunks, windows) do not change a slot's
// arithmetic either.
//
// Precision (the reference's three tiers, kernels/mxu.py):
//   0 "highest": f32 operands; at b = 32 split as x = hi + lo with hi =
//                tf32(x), lo = tf32(x - hi) (x to about 2^-22), lo*hi +
//                hi*lo + hi*hi per product; at b = 16, 64 FP32 FFMA;
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

// Products: "highest" FP32 FFMA (b = 16, 64) or 3xTF32 (b = 32); "high",
// "default" bf16 mma.sync.
enum Mode { kFfma = 0, kSplit = 1, kBf16 = 2, kTf32x3 = 3 };

template <int B, int M, int T = 256>
struct Cfg {
  // Threads per slot: a warp (b = 16, 32), a warpgroup (b = 64); each
  // warp of a team holds a band of the slot's rows.
  static constexpr int kTeam = B == 64 ? 128 : 32;
  static constexpr int kThreads = T;  // 256, or 128 in the narrow shape
  static constexpr int kTeams = kThreads / kTeam;
  static constexpr int kRowsPerWarp = B / (kTeam / 32);
  // Resident blocks per SM the registers are held to: the narrow shape's
  // three (kernels/pallas_gemm_fine.py::launch_shape).
  static constexpr int kMinBlocks = T == 128 ? 3 : 1;
  using Elem = typename std::conditional<M == kBf16, __nv_bfloat16, float>::type;
  static constexpr int kEs = sizeof(Elem);
  // A staged B^T row: +4 floats keeps the FFMA tile's two row loads of a
  // quarter warp on distinct banks; 3xTF32 rows unpadded (the 16-byte
  // chunks swizzled, `b_chunk`); +8 elements for the bf16 fragments.
  static constexpr int kBStride = M == kFfma ? B + 4 : M == kTf32x3 ? B : B + 8;
  static constexpr int kStageBytes = B * kBStride * kEs;
  // A entry: (alpha A)^T as staged.  FFMA: f32 rows of b; 3xTF32: f32 rows
  // of b, their 16-byte chunks swizzled (`a_chunk`), split as the fragments
  // load; bf16: planes with element (k, n) at k * kAStride + n (hi and lo
  // at "high"), whose rows `ldmatrix.trans` reads (+8: the 8 rows of one
  // 8x8 matrix on distinct banks).
  static constexpr int kAStride = B + 8;
  static constexpr int kAPlane = B * (B + 8) * 2;
  static constexpr int kAEntryBytes =
      M == kFfma || M == kTf32x3 ? B * B * 4 : (M == kBf16 ? 1 : 2) * kAPlane;
  // FFMA (b = 16 and 64): at b = 16 a warp splits each product's depth
  // between its two half-warps (kSplitK = 2), each thread summing a kTR x
  // kTC tile of its warp's rows (4x4: 16 FMAs per 16-byte shared load); at
  // b = 64 no split, 8x4.
  static constexpr int kSplitK = M == kFfma && B == 16 ? 2 : 1;
  static constexpr int kTR = B == 16 ? 4 : 8;
  static constexpr int kTC = 4;
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

// First index in [lo, hi) of the sorted `v` whose value is at least x, or hi.
__device__ __forceinline__ int first_at_least(const int* __restrict__ v, int lo, int hi, int x) {
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (v[mid] < x) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
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

// hi = tf32(x), lo = tf32(x - hi) (round to nearest, ties away): together
// x to about 2^-22 of itself.
__device__ __forceinline__ void tf32_split(float x, uint32_t& hi, uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi) : "f"(x));
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(lo) : "f"(x - __uint_as_float(hi)));
}

// d += A(16x8) B(8x8), tf32 operands in the m16n8k8 fragment layout.
__device__ __forceinline__ void mma_tf32(float* d, const uint32_t* a, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 3xTF32 k order: k-step s of a lane with t = lane % 4 takes k = k_of(t,
// s, 0) and k_of(t, s, 1) (the mma's k = t and t + 4), the same on both
// operands.  So the lane's k over a product are the f32 at 16-byte chunks
// 4h + t of a B^T row (chunk h feeds k-steps 2h, 2h + 1): one shared load
// a chunk, and the 8 k of each k-step distinct.
__device__ __forceinline__ int k_of(int t, int s, int slot) {
  return 16 * (s >> 1) + 4 * t + 2 * (s & 1) + slot;
}

// Where 16-byte chunk c of staged f32 B^T row r lies in its row (3xTF32,
// b = 32): chunks of odd rows swap halves of 8, so that the 8 lanes of a
// quarter warp (rows g, g + 1, chunks 4h + t) read 8 distinct bank groups.
__device__ __forceinline__ int b_chunk(int c, int r) { return c ^ ((r & 1) << 2); }

// Where 16-byte chunk c of staged f32 (alpha A)^T row k lies in its row
// (3xTF32, b = 32).  A k-step's B fragments are 4 rows k = k_of(t, ..)
// (t = 0..3, one group of 4 rows each) by 8 columns (2 chunks): rows swap
// chunks by even steps of their group, so that the 32 lanes read 32 banks.
__device__ __forceinline__ int a_chunk(int c, int k) { return c ^ (2 * ((k >> 2) & 3)); }

// One slot's C^T block, spread over a team's registers.  `tt` is the
// thread's rank in its team; every method touches the same elements, so
// which team holds a slot does not change its arithmetic.  The last
// k-chunk's stores are streaming (evict first): the output is written once
// and should not push the B blocks out of L2.
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

  // The sums are final in the row's last k-chunk (streaming stores);
  // before it the next k-chunk reads them back, so they stay in L2.
  template <typename V>
  __device__ __forceinline__ static void put(V* p, V x, bool last) {
    if (last) {
      __stcs(p, x);
    } else {
      __stcg(p, x);
    }
  }

  // Write the slot (split-K: the two halves' sums added, each half
  // storing half of the rows); with kZeros, zeros instead.
  template <bool kZeros = false>
  __device__ __forceinline__ void store(float* dst, int tt, bool last) const {
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
          put(reinterpret_cast<float4*>(dst + row(tt, u + h * kRows) * B + c + v),
              make_float4(x[0], x[1], x[2], x[3]), last);
        }
      }
    } else {
#pragma unroll
      for (int v = 0; v < C::kAcc / 2; ++v) {
        put(reinterpret_cast<float2*>(dst + frag(tt, v)),
            kZeros ? make_float2(0.f, 0.f) : make_float2(acc[2 * v], acc[2 * v + 1]), last);
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
        for (int q = 0; q < 4; ++q) {
          float av[C::kTC];
#pragma unroll
          for (int v = 0; v < C::kTC; v += 4) {
            *reinterpret_cast<float4*>(av + v) =
                *reinterpret_cast<const float4*>(a + (m + q) * B + v);
          }
#pragma unroll
          for (int u = 0; u < C::kTR; ++u) {
            const float x = q == 0 ? bv[u].x : q == 1 ? bv[u].y : q == 2 ? bv[u].z : bv[u].w;
#pragma unroll
            for (int v = 0; v < C::kTC; ++v) {
              part[u * C::kTC + v] = fmaf(x, av[v], part[u * C::kTC + v]);
            }
          }
        }
      }
#pragma unroll
      for (int u = 0; u < C::kAcc; ++u) acc[u] += part[u];
    } else if constexpr (M == kTf32x3) {
      // The product's three passes (per k-step lo*hi, hi*lo, hi*hi) go into
      // zeroed registers, then one rounded FADD into the sums, since the
      // tensor cores' accumulator drops low bits at every mma.
      static_assert(B == 32, "3xTF32 serves b = 32 alone");
      const int lane = tt & 31, g = lane >> 2, t = lane & 3;
      const float* b = reinterpret_cast<const float*>(sb);
      const float* a = reinterpret_cast<const float*>(sa);
      float part[C::kAcc];
#pragma unroll
      for (int u = 0; u < C::kAcc; ++u) part[u] = 0.f;
#pragma unroll
      for (int h = 0; h < B / 16; ++h) {
        // B^T rows 16 mt + g + 8 r8: chunk 4h + t, split (f: [mt][r8][j],
        // the f32 at k = 16h + 4t + j).
        uint32_t fh[C::kMT][2][4], fl[C::kMT][2][4];
#pragma unroll
        for (int mt = 0; mt < C::kMT; ++mt) {
#pragma unroll
          for (int r8 = 0; r8 < 2; ++r8) {
            const int r = 16 * mt + g + 8 * r8;
            const float4 x =
                *reinterpret_cast<const float4*>(b + r * B + 4 * b_chunk(4 * h + t, r));
            tf32_split(x.x, fh[mt][r8][0], fl[mt][r8][0]);
            tf32_split(x.y, fh[mt][r8][1], fl[mt][r8][1]);
            tf32_split(x.z, fh[mt][r8][2], fl[mt][r8][2]);
            tf32_split(x.w, fh[mt][r8][3], fl[mt][r8][3]);
          }
        }
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int k = k_of(t, 2 * h + e, 0);  // and k + 1, in one group of 4 rows
#pragma unroll
          for (int nt = 0; nt < C::kNT; ++nt) {
            const int off = k * B + 4 * a_chunk(2 * nt + (g >> 2), k) + (g & 3);
            uint32_t gh0, gl0, gh1, gl1;  // alpha A at (k, 8 nt + g), (k + 1, ..)
            tf32_split(a[off], gh0, gl0);
            tf32_split(a[off + B], gh1, gl1);
#pragma unroll
            for (int mt = 0; mt < C::kMT; ++mt) {
              const uint32_t ah[4] = {fh[mt][0][2 * e], fh[mt][1][2 * e],
                                      fh[mt][0][2 * e + 1], fh[mt][1][2 * e + 1]};
              const uint32_t al[4] = {fl[mt][0][2 * e], fl[mt][1][2 * e],
                                      fl[mt][0][2 * e + 1], fl[mt][1][2 * e + 1]};
              float* d = part + 4 * (mt * C::kNT + nt);
              mma_tf32(d, al, gh0, gh1);
              mma_tf32(d, ah, gl0, gl1);
              mma_tf32(d, ah, gh0, gh1);
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
// (whole block; f32 and bf16 copies are left in flight in one cp.async
// group).
template <int B, int M, int T>
__device__ __forceinline__ void stage_a(unsigned char* sa,
                                        const typename Cfg<B, M>::Elem* at,
                                        int e0, int nk) {
  using C = Cfg<B, M, T>;
  const size_t base = static_cast<size_t>(e0) * B * B;
  if constexpr (M == kFfma) {
    const unsigned char* src = reinterpret_cast<const unsigned char*>(at + base);
    for (int c = threadIdx.x; c < nk * B * B / 4; c += C::kThreads) {
      cp_async16(sa + 16 * c, src + 16 * c);
    }
    cp_async_commit();
  } else if constexpr (M == kTf32x3) {  // f32 rows, chunks swizzled: 16-byte copies
    static_assert(B == 32, "3xTF32 serves b = 32 alone");
    constexpr int kRowChunks = B / 4;
    const unsigned char* src = reinterpret_cast<const unsigned char*>(at + base);
    for (int c = threadIdx.x; c < nk * B * kRowChunks; c += C::kThreads) {
      const int row = c / kRowChunks, k = row % B;  // entry row / B, k row % B
      cp_async16(sa + (row / B) * C::kAEntryBytes + k * B * 4 +
                     16 * a_chunk(c % kRowChunks, k),
                 src + 16 * c);
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
  bool first, last;  // the row's first and last k-chunk
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
          Tile<B, M>().template store<true>(out + static_cast<size_t>(s) * B * B, tt, last);
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
    const int r = ch / kRowChunks, c = ch % kRowChunks;
    cp_async16(stage + r * C::kBStride * C::kEs + 16 * (M == kTf32x3 ? b_chunk(c, r) : c),
               src + 16 * ch);
  }
}

template <int B, int M, int T>
__global__ void __launch_bounds__(T, Cfg<B, M, T>::kMinBlocks)
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
  using C = Cfg<B, M, T>;
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
  int* bn = bq + kc;                 // its visible entries left of cbase + kSpan
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
    w.last = k0 + kc >= na;
    w.nk = min(kc, na - k0);
    if (!first) __syncthreads();  // every team is done with the last k-chunk
    stage_a<B, M, T>(sa, at, ea + k0, w.nk);
    // Each A entry's visible B row (the row cap) in the chunk's column span,
    // found by two binary searches of the sorted row (entries outside the
    // span are not read), as a bitmap of the span, and the B entry of each
    // word's first bit.
    for (int t = threadIdx.x; t < w.nk; t += C::kThreads) {
      const int k = a_col[ea + k0 + t];
      const int q0 = b_row_start[k];
      const int n = min(b_row_start[k + 1] - q0, brm);
      const int lo = first_at_least(b_col + q0, 0, n, cbase);
      bq[t] = q0;
      below[t] = lo;
      bn[t] = first_at_least(b_col + q0, lo, n, cbase + kSpan);
    }
    for (int x = threadIdx.x; x < w.nk * kWordStride; x += C::kThreads) bits[x] = 0u;
    if (threadIdx.x == 0) *w.counter = 0;
    __syncthreads();
    for (int t = threadIdx.x >> 5; t < w.nk; t += C::kThreads / 32) {  // a warp an entry
      for (int c = below[t] + (threadIdx.x & 31); c < bn[t]; c += 32) {
        const int rel = b_col[bq[t] + c] - cbase;
        atomicOr(&bits[t * kWordStride + (rel >> 5)], 1u << (rel & 31));
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
        if (held >= 0) tile.store(out + static_cast<size_t>(held) * B * B, tt, w.last);
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
    if (held >= 0) tile.store(out + static_cast<size_t>(held) * B * B, tt, w.last);
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
template <int B, int M, int T>
int run(const Args& a, int ctas_per_sm, cudaStream_t stream, int* info) {
  using C = Cfg<B, M, T>;
  const int ring = C::kTeams * kStages * C::kStageBytes;
  const int per_entry = C::kAEntryBytes + 4 * (2 * kWordStride + 3);
  const int budget =
      std::min(kSmemPerBlock, kSmemPerSm / std::max(ctas_per_sm, 1) - kSmemReserved);
  const int kc = std::min(kMaxKc, (budget - ring - 4 * (1 + C::kTeams)) / per_entry);
  if (kc < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int smem = ring + kc * per_entry + 4 * (1 + C::kTeams);  // + slot counters
  auto kernel = fine_spgemm_kernel<B, M, T>;
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

// "highest" at b = 32 runs 3xTF32 in blocks of 256 threads or of 128 (the
// narrow shape); every other leaf and tier in blocks of 256.
template <int B>
int dispatch_precision(int precision, int threads, const Args& a, int ctas_per_sm,
                       cudaStream_t stream, int* info) {
  if constexpr (B == 32) {
    if (precision == 0 && threads == 128) {
      return run<B, kTf32x3, 128>(a, ctas_per_sm, stream, info);
    }
  }
  if (threads != 256) return static_cast<int>(cudaErrorInvalidValue);
  switch (precision) {
    case 0:
      if constexpr (B == 32) {
        return run<B, kTf32x3, 256>(a, ctas_per_sm, stream, info);
      } else {
        return run<B, kFfma, 256>(a, ctas_per_sm, stream, info);
      }
    case 1:
      return run<B, kSplit, 256>(a, ctas_per_sm, stream, info);
    case 2:
      return run<B, kBf16, 256>(a, ctas_per_sm, stream, info);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

int dispatch(int block_size, int precision, int threads, const Args& a, int ctas_per_sm,
             cudaStream_t stream, int* info) {
  switch (block_size) {
    case 16:
      return dispatch_precision<16>(precision, threads, a, ctas_per_sm, stream, info);
    case 32:
      return dispatch_precision<32>(precision, threads, a, ctas_per_sm, stream, info);
    case 64:
      return dispatch_precision<64>(precision, threads, a, ctas_per_sm, stream, info);
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
// shared-memory budget is sized for; `threads` per block 256, or 128 at b
// = 32 "highest".
int hbsm_fine_spgemm(const int* chunks, int n_chunks, const int* out_ids,
                     const int* ccol, const int* a_row_start, const int* a_col,
                     const int* b_row_start, const int* b_col, const void* at,
                     const void* bt, float* out, int nbc, int b_row_max,
                     int block_size, int precision, int ctas_per_sm, int threads,
                     void* stream) {
  if (n_chunks == 0) return 0;
  const Args a{chunks, n_chunks, out_ids, ccol, a_row_start, a_col,
               b_row_start, b_col, at, bt, out, nbc, b_row_max};
  return dispatch(block_size, precision, threads, a, ctas_per_sm,
                  static_cast<cudaStream_t>(stream), nullptr);
}

// The launch `hbsm_fine_spgemm` would make, without making it: info[0..5]
// = k-chunk entries, dynamic shared bytes, resident blocks per SM
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), registers and local
// bytes per thread, threads per block.  Returns a CUDA error code.
int hbsm_fine_spgemm_config(int block_size, int precision, int b_row_max,
                            int ctas_per_sm, int threads, int* info) {
  Args a{};
  a.brm = b_row_max;
  return dispatch(block_size, precision, threads, a, ctas_per_sm, nullptr, info);
}

const char* hbsm_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
