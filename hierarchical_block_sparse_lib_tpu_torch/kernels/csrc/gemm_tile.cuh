// The output tiles shared by the port's GEMM kernels at 128-wide and wider
// leaves: the ring engine (rows_spgemm in gemm_rows.cu, the pair stream in
// gemm_stream.cu, the row groups in gemm_groups.cu).  One 256-thread block
// owns a 128x64 f32 tile of an output block, kept in registers: warp w holds
// rows 16 w + [0, 16), all 64 columns (32 registers a thread, the accumulator
// layout of mma.sync m16n8 and of wgmma m64n64).  The block's leaf products
// form one sequence of 128-byte-deep k-slices (32 f32 or 64 bf16 values of
// k), staged by 16-byte cp.async into a ring of kStages slices in dynamic
// shared memory: one barrier a slice, the copies of the next two slices, of
// this product and the next, in flight under the math.  A is staged [row][k]
// and B [k][col] as stored, each row padded by 16 or 32 bytes so that every
// fragment load is free of bank conflicts.  Each element's sum is serial
// (products in the caller's order, k ascending), in f32, with no atomics, so
// a fixed structure gives bitwise-equal results.  The tile is stored with
// streaming stores, which keep the operands in L2.
//
// Tensor-core passes per tier (the reference's, kernels/mxu.py):
//   MODE 0 "highest", f32 data: 3xTF32 on wgmma m64n64k8, big =
//          tf32_rna(x), small = tf32_rna(x - big); small*big + big*small +
//          big*big.  A is split in registers (wgmma takes A from them);
//          B, which TF32 wgmma reads K-major from shared memory only, is
//          split once a slice into big and small copies laid out
//          [k / 4][col][4] (8 x 16-byte core matrices, no swizzle);
//   MODE 0, bf16 data: one bf16 mma.sync pass, products exact in f32;
//   MODE 1 "high": f32 split as x = hi + lo, hi = bf16(x), lo = bf16(x -
//          hi); lo*hi + hi*lo + hi*hi, three bf16 mma.sync passes;
//   MODE 2 "default": f32 rounded to bf16, one bf16 mma.sync pass.
// The tensor cores' accumulator drops low bits at every mma, so a sum fed
// to it mma by mma loses about a part in 2^24 of itself at each one:
// 3xTF32 into the tile directly missed phase 3's 1e-5 gate at 7 pairs of
// b = 256 (1.6e-5).  The split tiers therefore sum a slice's passes (12
// wgmma, or 6 mma.sync) into zeroed registers and add those to the tile
// with one rounded FADD an element.  The bf16 passes of f32 data pair k
// values t and t+4 of an 8-deep group in one 32-bit operand, the same
// pairing for A and B: the mma sums the same terms, and both operands load
// in the TF32 fragment pattern.
//
// What bounds the ring engine: at "highest", its wgmma passes (3xTF32 at
// 165 TFLOP/s of product work is the floor) and, about as much, the
// operand stream from L2: a 128x64 tile reads 24 KB a slice for 0.5 MFLOP,
// and the loads and stores alone take three quarters of the B2-tile128
// call (PERF.md, PR 7).  Two blocks share an SM (99 KB of shared memory
// and at most 128 registers each), so one block's ring fill, split pass
// and store run under the other's math.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace hbsm {

constexpr int kTile = 128;  // output tile edge: leaves are multiples of it
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSentinel = 0x7fffffff;

// First index in [lo, hi) of the sorted `col` that equals j, or -1.
__device__ __forceinline__ int find_sorted(const int* __restrict__ col,
                                           int lo, int hi, int j) {
  const int stop = hi;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (col[mid] < j) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo < stop && col[lo] == j ? lo : -1;
}

// Compact the block's hits (q >= 0) into hit_e/hit_q, keeping thread
// order, and return their number.  Every thread of the block must call it.
__device__ __forceinline__ int compact_hits(int e, int q, int* hit_e,
                                            int* hit_q, int* warp_hits) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
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
  return n_hits;
}

constexpr int kRingCols = 64;  // a ring tile is kTile rows x kRingCols columns
constexpr int kStages = 3;     // slices in the ring
// A block of kThreads: warp w holds rows 16 w + [0, 16) of the tile.
static_assert(kThreads / 32 * 16 == kTile, "a warp per 16 rows of the tile");

// Ring geometry for element type T: a slice is 128 bytes of k.  f32 data
// also keeps a slice of B split for 3xTF32 (big, small), K-major.
template <typename T>
struct Ring {
  static constexpr int KS = 128 / sizeof(T);        // k per slice: 32 f32, 64 bf16
  static constexpr int A_LD = KS + 16 / sizeof(T);  // A row: 144 bytes
  static constexpr int B_LD = kRingCols + 8;        // B row: 288 (f32) or 144 bytes
  static constexpr int A_ELEMS = kTile * A_LD;
  static constexpr int STAGE_ELEMS = A_ELEMS + KS * B_LD;
  static constexpr int SPLIT_ELEMS = sizeof(T) == 4 ? KS * kRingCols : 0;
  static constexpr int BYTES =
      (kStages * STAGE_ELEMS + 2 * SPLIT_ELEMS) * static_cast<int>(sizeof(T));
};

// One thread's share of the tile: [n fragment][4], rows 16 w + g (+8),
// columns 8 nt + 2 t (+1) for lane (g, t) = (lane / 4, lane % 4) of warp w:
// the accumulator layout of mma.sync m16n8 and of wgmma m64n64.
typedef float Frags[8][4];

// The operands of one leaf product (see accumulate_ring).
template <typename T>
struct Operands {
  const T* a;
  const T* b;
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// big = tf32(x), small = tf32(x - big): together x to about 2^-22.
__device__ __forceinline__ void tf32_split(float x, uint32_t& big,
                                           uint32_t& small) {
  big = tf32_rna(x);
  small = tf32_rna(x - __uint_as_float(big));
}

// Two f32 values as one bf16x2 operand, `e` in the low half.
__device__ __forceinline__ uint32_t bf16x2(float e, float o) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(e, o);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// hi = bf16x2(e, o), lo = bf16x2 of what hi leaves of (e, o).
__device__ __forceinline__ void bf16x2_split(float e, float o, uint32_t& hi,
                                             uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(e, o);
  const float2 hf = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = bf16x2(e - hf.x, o - hf.y);
}

// d = a @ b + d, or with FIRST a @ b (a zeroed partial sum's first pass).
template <bool FIRST = false>
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  if (FIRST) {
    asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%10,%10,%10,%10};\n"
        : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]),
          "f"(0.f));
  } else {
    asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }
}

// wgmma descriptor of a K-major tf32 operand in shared memory without
// swizzle: core matrices of 8 rows x 16 bytes, `lbo` bytes apart along k
// and `sbo` bytes apart along the rows.
__device__ __forceinline__ uint64_t wgmma_desc(const void* smem, uint32_t lbo,
                                               uint32_t sbo) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32;
}

// The warpgroup's d[64 x 64] += A[64 x 8] @ B[8 x 64], A from registers
// (the mma.sync m16n8k8 fragment of each warp's 16 rows), B by descriptor.
__device__ __forceinline__ void wgmma_tf32(Frags& d, const uint32_t (&a)[4],
                                           uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,"
      "%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31}, "
      "{%32,%33,%34,%35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void add_partial(Frags& acc, const Frags& d) {
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[nt][i] += d[nt][i];
  }
}

// acc += A_slice @ B_slice for one staged slice of f32 data at "highest":
// 3xTF32 on wgmma.  The block splits the slice of B into big and small
// halves, K-major ([k / 4][col][4]: 8 x 16-byte core matrices), while each
// thread splits its A fragments in registers; then each warpgroup runs 12
// m64n64k8 passes (small*big, big*small, big*big a k8 step) into zeroed
// partial sums that one rounded FADD an element adds to the tile.
__device__ __forceinline__ void tf32x3_slice(Frags& acc, const float* sa,
                                             const float* sb, float* split) {
  using R = Ring<float>;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  float* big = split;
  float* small = split + R::SPLIT_ELEMS;
#pragma unroll
  for (int i = 0; i < R::KS / 4 * kRingCols / kThreads; ++i) {
    const int item = threadIdx.x + i * kThreads;
    const int q = item / kRingCols, col = item % kRingCols;
    float4 hi, lo;
    uint32_t bg, sm;
    tf32_split(sb[(4 * q) * R::B_LD + col], bg, sm);
    hi.x = __uint_as_float(bg), lo.x = __uint_as_float(sm);
    tf32_split(sb[(4 * q + 1) * R::B_LD + col], bg, sm);
    hi.y = __uint_as_float(bg), lo.y = __uint_as_float(sm);
    tf32_split(sb[(4 * q + 2) * R::B_LD + col], bg, sm);
    hi.z = __uint_as_float(bg), lo.z = __uint_as_float(sm);
    tf32_split(sb[(4 * q + 3) * R::B_LD + col], bg, sm);
    hi.w = __uint_as_float(bg), lo.w = __uint_as_float(sm);
    *reinterpret_cast<float4*>(big + item * 4) = hi;
    *reinterpret_cast<float4*>(small + item * 4) = lo;
  }
  uint32_t ab[R::KS / 8][4], as[R::KS / 8][4];
  const float* a0 = sa + (16 * warp + g) * R::A_LD + t;
  constexpr int lo = 8 * R::A_LD;  // row g + 8
#pragma unroll
  for (int s = 0; s < R::KS / 8; ++s) {
    tf32_split(a0[8 * s], ab[s][0], as[s][0]);
    tf32_split(a0[lo + 8 * s], ab[s][1], as[s][1]);
    tf32_split(a0[8 * s + 4], ab[s][2], as[s][2]);
    tf32_split(a0[lo + 8 * s + 4], ab[s][3], as[s][3]);
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();  // the split slice of B is in place for both warpgroups
  Frags d;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) d[nt][0] = d[nt][1] = d[nt][2] = d[nt][3] = 0.f;
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
  constexpr uint32_t kLbo = kRingCols * 16, kSbo = 8 * 16;  // bytes
#pragma unroll
  for (int s = 0; s < R::KS / 8; ++s) {
    // k8 step s: quads 2 s and 2 s + 1 of the split slice.
    const uint64_t db = wgmma_desc(big + 2 * s * kRingCols * 4, kLbo, kSbo);
    const uint64_t ds = wgmma_desc(small + 2 * s * kRingCols * 4, kLbo, kSbo);
    wgmma_tf32(d, as[s], db);
    wgmma_tf32(d, ab[s], ds);
    wgmma_tf32(d, ab[s], db);
  }
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  add_partial(acc, d);
}

// acc += A_slice @ B_slice for one staged slice of f32 data in bf16 passes
// ("high": three into zeroed partial sums, "default": one).  Lane (g, t)
// loads rows 16 w + g (+8), columns 8 nt + g and depths t, t + 4 of each
// 8-deep group, paired (t, t + 4) -> logical (2t, 2t + 1), for A and B
// alike: the mma sums the same terms.
template <int MODE>
__device__ __forceinline__ void mma_slice(Frags& acc, const float* sa,
                                          const float* sb) {
  using R = Ring<float>;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const float* a0 = sa + (16 * warp + g) * R::A_LD + t;
  const float* b0 = sb + t * R::B_LD + g;
  constexpr int lo = 8 * R::A_LD;  // row g + 8
  Frags d;
#pragma unroll
  for (int k16 = 0; k16 < R::KS; k16 += 16) {
    const float* ar = a0 + k16;
    uint32_t ah[4], al[4];
    if constexpr (MODE == 1) {
      bf16x2_split(ar[0], ar[4], ah[0], al[0]);
      bf16x2_split(ar[lo], ar[lo + 4], ah[1], al[1]);
      bf16x2_split(ar[8], ar[12], ah[2], al[2]);
      bf16x2_split(ar[lo + 8], ar[lo + 12], ah[3], al[3]);
    } else {
      ah[0] = bf16x2(ar[0], ar[4]);
      ah[1] = bf16x2(ar[lo], ar[lo + 4]);
      ah[2] = bf16x2(ar[8], ar[12]);
      ah[3] = bf16x2(ar[lo + 8], ar[lo + 12]);
    }
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const float* bc = b0 + k16 * R::B_LD + nt * 8;
      uint32_t bh[2], bl[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float e = bc[(8 * h) * R::B_LD], o = bc[(8 * h + 4) * R::B_LD];
        if constexpr (MODE == 1) {
          bf16x2_split(e, o, bh[h], bl[h]);
        } else {
          bh[h] = bf16x2(e, o);
        }
      }
      if constexpr (MODE == 1) {
        if (k16 == 0) {
          mma_bf16<true>(d[nt], al, bh);
        } else {
          mma_bf16(d[nt], al, bh);
        }
        mma_bf16(d[nt], ah, bl);
        mma_bf16(d[nt], ah, bh);
      } else {
        mma_bf16(acc[nt], ah, bh);
      }
    }
  }
  if constexpr (MODE == 1) add_partial(acc, d);
}

// acc += A_slice @ B_slice for one staged slice of bf16 data: one exact
// bf16 pass; A fragments by 32-bit loads, B by ldmatrix.trans.
__device__ __forceinline__ void mma_slice_bf16(Frags& acc,
                                               const __nv_bfloat16* sa,
                                               const __nv_bfloat16* sb) {
  using R = Ring<__nv_bfloat16>;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const __nv_bfloat16* a0 =
      sa + (16 * warp + (lane >> 2)) * R::A_LD + 2 * (lane & 3);
  // ldmatrix: lane l addresses row k = (l / 8 % 2) * 8 + l % 8 of columns
  // (l / 16) * 8 of an n-fragment pair.
  const __nv_bfloat16* b0 =
      sb + (((lane >> 3) & 1) * 8 + (lane & 7)) * R::B_LD + (lane >> 4) * 8;
  constexpr int lo = 8 * R::A_LD;
#pragma unroll
  for (int k16 = 0; k16 < R::KS; k16 += 16) {
    const __nv_bfloat16* ar = a0 + k16;
    const uint32_t a[4] = {*reinterpret_cast<const uint32_t*>(ar),
                           *reinterpret_cast<const uint32_t*>(ar + lo),
                           *reinterpret_cast<const uint32_t*>(ar + 8),
                           *reinterpret_cast<const uint32_t*>(ar + lo + 8)};
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      uint32_t b[2][2];
      const unsigned addr = static_cast<unsigned>(
          __cvta_generic_to_shared(b0 + k16 * R::B_LD + np * 16));
      asm volatile(
          "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
          : "=r"(b[0][0]), "=r"(b[0][1]), "=r"(b[1][0]), "=r"(b[1][1])
          : "r"(addr));
      mma_bf16(acc[2 * np], a, b[0]);
      mma_bf16(acc[2 * np + 1], a, b[1]);
    }
  }
}

// Stage slice k0 of a tile's product into one ring stage: A(0:128, k0 +
// [0, KS)) and B(k0 + [0, KS), 0:64), both row-major with row stride ld.
// Row offsets are computed in ld's type L (see accumulate_ring).
template <typename T, typename L>
__device__ __forceinline__ void stage_slice(T* st, const T* __restrict__ a,
                                            const T* __restrict__ b, L ld,
                                            int k0) {
  using R = Ring<T>;
  constexpr int EPC = 16 / sizeof(T);                // elements per copy
  constexpr int B_CPR = kRingCols * sizeof(T) / 16;  // copies per B row
#pragma unroll
  for (int i = 0; i < kTile * 8 / kThreads; ++i) {
    const int c = threadIdx.x + i * kThreads;
    const int row = c >> 3, ch = c & 7;
    cp_async16(st + row * R::A_LD + ch * EPC, a + (row * ld + k0 + ch * EPC));
  }
  T* sb = st + R::A_ELEMS;
#pragma unroll
  for (int i = 0; i < R::KS * B_CPR / kThreads; ++i) {
    const int c = threadIdx.x + i * kThreads;
    const int row = c / B_CPR, ch = c % B_CPR;
    cp_async16(sb + row * R::B_LD + ch * EPC, b + ((k0 + row) * ld + ch * EPC));
  }
}

// acc += sum over h < n_products of A_h @ B_h, in order of h, where
// operands(h) gives product h's pointers: the first of the tile's 128 rows
// of an A block and the first of its 64 columns of a B block, both
// row-major with row stride `ld`, which is also the depth.  The products'
// slices run through the ring as one sequence.  L is the type the
// operands' row offsets are computed in: size_t, or int (fewer registers,
// for a caller that holds more state across the ring; offsets below 2^31).
// Every thread of the block must call this; it ends with a barrier, so the
// ring and whatever operands() read may be reused at once.
template <typename T, int MODE, typename L, typename F>
__device__ __forceinline__ void accumulate_ring(Frags& acc, T* ring,
                                                int n_products, L ld,
                                                F operands) {
  using R = Ring<T>;
  const int depth = static_cast<int>(ld);
  const int n = n_products * (depth / R::KS);  // slices
  int next_h = 0, next_k0 = 0;  // the slice issue() stages next
  auto issue = [&](int s) {
    if (s < n) {
      const Operands<T> ab = operands(next_h);
      stage_slice<T>(ring + (s % kStages) * R::STAGE_ELEMS, ab.a, ab.b, ld,
                     next_k0);
      next_k0 += R::KS;
      if (next_k0 == depth) next_k0 = 0, ++next_h;
    }
    cp_async_commit();  // an empty group past the end keeps the count
  };
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) issue(s);
  for (int s = 0; s < n; ++s) {
    cp_async_wait<kStages - 2>();  // this thread's copies of slice s landed
    __syncthreads();  // everyone's have, and slice s - 1 is consumed
    issue(s + kStages - 1);
    const T* st = ring + (s % kStages) * R::STAGE_ELEMS;
    if constexpr (sizeof(T) == 2) {
      mma_slice_bf16(acc, st, st + R::A_ELEMS);
    } else if constexpr (MODE == 0) {
      tf32x3_slice(acc, st, st + R::A_ELEMS, ring + kStages * R::STAGE_ELEMS);
    } else {
      mma_slice<MODE>(acc, st, st + R::A_ELEMS);
    }
  }
  cp_async_wait<0>();
  __syncthreads();
}

// Element (nt, i) of a thread's fragments sits at row frag_row(i) and
// column frag_col(nt, i) of the tile.
__device__ __forceinline__ int frag_row(int i) {
  return (threadIdx.x >> 5) * 16 + ((threadIdx.x & 31) >> 2) + (i >> 1) * 8;
}
__device__ __forceinline__ int frag_col(int nt, int i) {
  return nt * 8 + (threadIdx.x & 3) * 2 + (i & 1);
}

// The tile starts as zeros, or as the f32 tile at `src` (row stride ld).
__device__ __forceinline__ void load_frags(Frags& acc, const float* src,
                                           int ld) {
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float2 v = make_float2(0.f, 0.f);
      if (src != nullptr) {
        v = *reinterpret_cast<const float2*>(
            src + static_cast<size_t>(frag_row(2 * h)) * ld + frag_col(nt, 0));
      }
      acc[nt][2 * h] = v.x;
      acc[nt][2 * h + 1] = v.y;
    }
  }
}

// Streaming stores: the kernel does not read its output back, and it
// should not evict the operands from L2.
__device__ __forceinline__ void store_frags(float* dst, const Frags& acc,
                                            int ld) {
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      __stcs(reinterpret_cast<float2*>(
                 dst + static_cast<size_t>(frag_row(2 * h)) * ld + frag_col(nt, 0)),
             make_float2(acc[nt][2 * h], acc[nt][2 * h + 1]));
    }
  }
}

// What a launch of `kernel` with `smem` dynamic shared bytes gets:
// info[0..4] = dynamic shared bytes, resident blocks per SM, registers
// and local (spill) bytes per thread, threads per block.
template <typename K>
int launch_info(K kernel, int smem, int* info) {
  int blocks = 0;
  cudaFuncAttributes attr;
  cudaError_t err =
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, kThreads, smem);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  info[0] = smem;
  info[1] = blocks;
  info[2] = attr.numRegs;
  info[3] = static_cast<int>(attr.localSizeBytes);
  info[4] = kThreads;
  return 0;
}

}  // namespace hbsm
