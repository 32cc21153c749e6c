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
//     s_i = 1 + f32(i) * 1e-9 in f32, each rep's 32-deep product formed on
//     its own and then added, in rep order; the rest of acc is written
//     zero.  "quad" is the same function as "wide" and runs the same
//     kernel on the same tiling.  Bound by operations (2*LA*LB*32*R; 11.3
//     GFLOP at LA = LB = 832, R = 256: 0.169 ms of FP32).  One block owns
//     a BM x BN tile of acc and runs the R reps serially over it, B staged
//     once.  The reps go in steps of G: while the block computes one
//     step's G products from one pair of shared A tiles it writes fl(at *
//     s_i) of the next step into the other, so each scaled value is one
//     FMUL per rep shared by every thread that reads it; one barrier per
//     step.  "highest" (FP32 FFMA): each thread a 4x4 register tile, 16
//     outputs, since 692 224 outputs of 256 serial reps give too few warps
//     for larger tiles (1 352 warps at 832 on 528 schedulers); float4
//     shared loads free of bank conflicts; the 32-deep k loop unrolled
//     with fragments double-buffered in registers.  What bounds it is
//     shared memory: a warp's 16-byte load is served 32 floats a
//     wavefront, so a 4x4 tile asks 4 * (4G + 4) / (16G) wavefronts a cycle
//     of an SM that serves one (2 at G = 1).  G = 2 shares each B fragment
//     between two reps, and B's depths 0-15 held in registers (kr16) cut
//     the demand to 1.25.  "default":
//     one bf16 mma.sync pass; in the mma fragment layout each element of
//     A belongs to one lane, so each lane scales and rounds its own A
//     values (one FMUL per element per rep, no shared memory, no barrier)
//     and B's fragments stay in registers for the whole kernel (staging A
//     through shared memory as the FFMA kernel does measured slower
//     here).  Each tier has one tiling; the C entry sizes the grid.
//   micro "flatten": per rep, acc rows 128 + 8(4t+c) + r, lane l += the
//     [8,128] row-major reading of the 32x32 sub-block (t, c) of
//     acc[0:128, 0:128] + s_i.  Bound by latency: 64 KB moved.  One thread
//     per destination element, R serial adds.
//   e2: [32,32] -> [8,128] row-major, by three recipes (a flat copy; a
//     staged [4,8,32] stack read back transposed; four row groups
//     concatenated).  All three are copies and equal bitwise.  One block.
//   e3: acc slot p (an [8,128] block) = v added once for each i < R3 with
//     idx[i] == p, serially.  Every entry adds the same v, so a slot's
//     value depends only on its count, never on the order of its entries:
//     one launch, no sort.  A block owns kE3Slots slots, counts their
//     entries over idx (integer, exact), then adds v count times in
//     registers, serially in f32, and writes the slots (not count * v: a
//     product rounds differently).  Bound by latency: 16 KB of indices.
//   e12: for each A block e < RA and panel block t < nbrow, slot idx[e *
//     nbrow + t] += X_t L_e, with X_t the panel's block t read as a
//     row-major 32x32 and L_e = a_wide[e][:, 0:32]: 6 656 leaf products of
//     32x32x32 at RA = 256, nbrow = 26 (436 MFLOP, 6.5 us of FP32).  What
//     bounds it is moving operands, not operations: each product reads 8
//     KB from L2 (54 MB in all) and each slot-owning block reads all of
//     idx (13 MB), while a slot's 13 products (26 at most) are serial.
//     One launch, no sort: a block of four warps owns one slot and finds
//     its entries itself, each warp scanning a quarter of a 4 096-entry
//     chunk with coalesced 16-byte loads, all in flight at once, and
//     ranking its hits with a ballot per bit; a barrier adds the warps'
//     counts.  Without the adds slot t's entries are t, t + nbrow, ... and
//     nothing is scanned.  The products stream through a four-stage
//     cp.async ring of (X_t, L_e), one barrier a product, the next three
//     products' operands in flight under this one's math; warp w forms its
//     16x16 quadrant of each product in its own partial on the tensor
//     cores and adds it to the slot's sum, in ascending (e, t) order.
//     Staged rows are padded (X_t to 36 floats, L_e to 40 at "highest" and
//     36 at "default"), so each tier's fragment loads are free of bank
//     conflicts, but for two-way ones on A at "default".
//
// Precision.  micro and e12: 0 "highest" f32-faithful (micro FP32 FFMA;
// e12 3xTF32 on mma.sync m16n8k8, big = tf32(x), small = tf32(x - big),
// small*big + big*small + big*big into a zeroed partial per product, then
// one f32 add).  2 "default": one bf16 pass on the tensor cores
// (mma.sync m16n8k16, operands rounded to bf16 to nearest even, exact
// products, f32 accumulation).
//
// Determinism: every sum runs serially in a fixed order in registers and
// every output element is written once, so repeated calls are bitwise
// equal.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "gemm_tile.cuh"  // cp.async and the tf32 split

namespace {

using hbsm::cp_async16;
using hbsm::cp_async_commit;
using hbsm::cp_async_wait;
using hbsm::tf32_split;

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

// Writes zeros over the block's BM x BN tile of acc (the parts inside
// acc): a tile that holds no output of the product.
template <int BM, int BN, int T>
__device__ __forceinline__ void zero_tile(float* __restrict__ acc, int m0, int n0,
                                          int acc_rows, int acc_cols) {
  for (int v = threadIdx.x; v < BM * BN; v += T) {
    const int m = m0 + v / BN, n = n0 + v % BN;
    if (m < acc_rows && n < acc_cols) acc[static_cast<size_t>(m) * acc_cols + n] = 0.f;
  }
}

// The output (m, n) as the kernel stores it: the sum inside the product,
// zero in acc's padding rows and columns.
__device__ __forceinline__ void store_out(float* __restrict__ acc, int m, int n, float x,
                                          int la, int lb, int acc_rows, int acc_cols) {
  if (m < acc_rows && n < acc_cols)
    acc[static_cast<size_t>(m) * acc_cols + n] = m < la && n < lb ? x : 0.f;
}

// Resident warps per SM the FFMA kernels are compiled for (registers <=
// 65536 / (32 * 12) = 170): at 896 the 1 568 warps of 16 outputs a thread
// fit on 132 SMs in one wave.
constexpr int kDotWarpsPerSM = 12;

// "highest": GN reps' 32-deep products of a thread's TM x TN tile, each
// formed on its own (k in order) from the staged tiles sa[g] = fl(at * s)
// and sb (depths k < KR of B from registers, breg), then added to sum in
// rep order.  Fragments are double-buffered in registers, a depth ahead;
// each B fragment serves GN reps.
template <int TM, int TN, int BY, int BX, int BM, int BN, int GN, int KR>
__device__ __forceinline__ void ffma_reps(const float (*__restrict__ sa)[32][BM],
                                          const float (*__restrict__ sb)[BN],
                                          const float (&breg)[KR > 0 ? KR : 1][TN], int tx,
                                          int ty, float (&sum)[TM][TN]) {
  float part[GN][TM][TN] = {};
  float fa[2][GN][TM], fb[2][TN];
  auto load = [&](int f, int k) {
#pragma unroll
    for (int g = 0; g < GN; ++g)
#pragma unroll
      for (int c = 0; c < TM / 4; ++c) {
        const float4 x = *reinterpret_cast<const float4*>(&sa[g][k][c * 4 * BY + 4 * ty]);
        fa[f][g][4 * c] = x.x, fa[f][g][4 * c + 1] = x.y, fa[f][g][4 * c + 2] = x.z,
                  fa[f][g][4 * c + 3] = x.w;
      }
    if (k < KR) {
#pragma unroll
      for (int w = 0; w < TN; ++w) fb[f][w] = breg[k < KR ? k : 0][w];
      return;
    }
#pragma unroll
    for (int c = 0; c < TN / 4; ++c) {
      const float4 x = *reinterpret_cast<const float4*>(&sb[k][c * 4 * BX + 4 * tx]);
      fb[f][4 * c] = x.x, fb[f][4 * c + 1] = x.y, fb[f][4 * c + 2] = x.z,
                fb[f][4 * c + 3] = x.w;
    }
  };
  load(0, 0);
#pragma unroll
  for (int k = 0; k < 32; ++k) {
    if (k + 1 < 32) load((k + 1) & 1, k + 1);
#pragma unroll
    for (int g = 0; g < GN; ++g)
#pragma unroll
      for (int u = 0; u < TM; ++u)
#pragma unroll
        for (int w = 0; w < TN; ++w)
          part[g][u][w] = fmaf(fa[k & 1][g][u], fb[k & 1][w], part[g][u][w]);
  }
#pragma unroll
  for (int g = 0; g < GN; ++g)
#pragma unroll
    for (int u = 0; u < TM; ++u)
#pragma unroll
      for (int w = 0; w < TN; ++w) sum[u][w] += part[g][u][w];
}

// "highest": BY x BX threads, each a TM x TN register tile; the block tile
// is BM = BY*TM rows by BN = BX*TN columns.  A thread's rows are the float4
// groups c*4*BY + 4*ty + {0..3} (c < TM/4), its columns c*4*BX + 4*tx +
// {0..3}: each fragment is TM/4 + TN/4 16-byte shared loads, and the eight
// threads of a load phase read one contiguous 128 bytes or one broadcast.
// The reps run in steps of G: the block stages the next step's G scaled A
// tiles while it computes the current step's, one barrier per step.  The
// kernel is compiled for kDotWarpsPerSM resident warps per SM.
template <int TM, int TN, int BY, int BX, int G, int KR>
__global__ void __launch_bounds__(BY * BX, kDotWarpsPerSM * 32 / (BY * BX))
    dot_ffma_kernel(const float* __restrict__ at, const float* __restrict__ bp,
                    float* __restrict__ acc, int la, int lb, int acc_rows, int acc_cols,
                    int reps) {
  constexpr int T = BY * BX, BM = BY * TM, BN = BX * TN;
  constexpr int kStage = 8 * BM / T;  // float4s of A each thread scales per rep
  static_assert(TM % 4 == 0 && TN % 4 == 0 && (8 * BM) % T == 0 && kStage >= 1,
                "tile does not split into float4 groups");
  __shared__ __align__(16) float sa[2][G][32][BM];  // fl(at[k][m0 + m] * s_i), two steps
  __shared__ __align__(16) float sb[32][BN];        // bp[k][n0 + n]
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN, tid = threadIdx.x;
  if (m0 >= la || n0 >= lb) {
    zero_tile<BM, BN, T>(acc, m0, n0, acc_rows, acc_cols);
    return;
  }
  const int tx = tid % BX, ty = tid / BX;
  for (int v = tid; v < 32 * BN; v += T) {
    const int k = v / BN, j = v % BN;
    sb[k][j] = n0 + j < lb ? bp[k * lb + n0 + j] : 0.f;
  }
  // Depths k < KR of the thread's B columns, held in registers.
  float breg[KR > 0 ? KR : 1][TN];
#pragma unroll
  for (int k = 0; k < KR; ++k)
#pragma unroll
    for (int w = 0; w < TN; ++w) {
      const int n = n0 + (w / 4) * 4 * BX + 4 * tx + w % 4;
      breg[k][w] = n < lb ? bp[k * lb + n] : 0.f;
    }
  // The A values this thread scales, kept unscaled in registers.
  float4 araw[kStage];
#pragma unroll
  for (int s = 0; s < kStage; ++s) {
    const int v4 = tid + s * T, k = v4 / (BM / 4), m = m0 + 4 * (v4 % (BM / 4));
    const float* p = at + k * la;
    araw[s] = make_float4(m < la ? p[m] : 0.f, m + 1 < la ? p[m + 1] : 0.f,
                          m + 2 < la ? p[m + 2] : 0.f, m + 3 < la ? p[m + 3] : 0.f);
  }
  auto stage = [&](int buf, int first) {  // reps first .. first + G - 1 below reps
#pragma unroll
    for (int g = 0; g < G; ++g) {
      if (first + g >= reps) break;
      const float sc = rep_scale(first + g);
#pragma unroll
      for (int s = 0; s < kStage; ++s) {
        const int v4 = tid + s * T, k = v4 / (BM / 4), m = 4 * (v4 % (BM / 4));
        *reinterpret_cast<float4*>(&sa[buf][g][k][m]) =
            make_float4(__fmul_rn(araw[s].x, sc), __fmul_rn(araw[s].y, sc),
                        __fmul_rn(araw[s].z, sc), __fmul_rn(araw[s].w, sc));
      }
    }
  };
  if (reps > 0) stage(0, 0);
  __syncthreads();
  float sum[TM][TN] = {};
  const int steps = (reps + G - 1) / G;
  for (int st = 0; st < steps; ++st) {
    const int buf = st & 1, first = st * G;
    if (st + 1 < steps) stage(buf ^ 1, first + G);
    if (first + G <= reps) {
      ffma_reps<TM, TN, BY, BX, BM, BN, G, KR>(sa[buf], sb, breg, tx, ty, sum);
    } else {
      for (int g = 0; g < reps - first; ++g)
        ffma_reps<TM, TN, BY, BX, BM, BN, 1, KR>(sa[buf] + g, sb, breg, tx, ty, sum);
    }
    __syncthreads();
  }
#pragma unroll
  for (int u = 0; u < TM; ++u) {
    const int m = m0 + (u / 4) * 4 * BY + 4 * ty + u % 4;
#pragma unroll
    for (int w = 0; w < TN; ++w)
      store_out(acc, m, n0 + (w / 4) * 4 * BX + 4 * tx + w % 4, sum[u][w], la, lb,
                acc_rows, acc_cols);
  }
}

// "default" with no shared memory: WY warps along m, each MT x NT tiles of
// m16n8.  In the mma fragment layout each element of A belongs to one lane,
// so each lane keeps its A values unscaled in registers and scales and
// rounds them itself, one FMUL per element per rep, with no barrier; B's
// fragments stay in registers.
template <int MT, int NT, int WY>
__global__ void __launch_bounds__(32 * WY)
    dot_mma_lane_kernel(const float* __restrict__ at, const float* __restrict__ bp,
                        float* __restrict__ acc, int la, int lb, int acc_rows, int acc_cols,
                        int reps) {
  constexpr int T = 32 * WY, BM = 16 * MT * WY, BN = 8 * NT;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN, tid = threadIdx.x;
  if (m0 >= la || n0 >= lb) {
    zero_tile<BM, BN, T>(acc, m0, n0, acc_rows, acc_cols);
    return;
  }
  const int lane = tid & 31, g8 = lane >> 2, c = (lane & 3) * 2;
  const int wm = (tid >> 5) * 16 * MT;
  uint32_t fb[NT][2][2];
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int n = n0 + 8 * j + g8;
#pragma unroll
    for (int ks = 0; ks < 2; ++ks)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int k = 16 * ks + 8 * h + c;
        fb[j][ks][h] = pack_bf16(n < lb ? bp[k * lb + n] : 0.f,
                                 n < lb ? bp[(k + 1) * lb + n] : 0.f);
      }
  }
  // araw[mt][ks][r][h]: A(m = wm + 16 mt + g8 + 8r, k = 16 ks + 8h + c, c + 1)
  float2 araw[MT][2][2][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int ks = 0; ks < 2; ++ks)
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int m = m0 + wm + 16 * mt + g8 + 8 * r, k = 16 * ks + 8 * h + c;
          araw[mt][ks][r][h] = m < la ? make_float2(at[k * la + m], at[(k + 1) * la + m])
                                      : make_float2(0.f, 0.f);
        }
  float sum[MT][NT][4] = {};
#pragma unroll 2
  for (int i = 0; i < reps; ++i) {
    const float sc = rep_scale(i);
    float part[MT][NT][4] = {};
#pragma unroll
    for (int ks = 0; ks < 2; ++ks)
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        uint32_t fa[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {  // a[2h + r]
          const float2 x = araw[mt][ks][q & 1][q >> 1];
          fa[q] = pack_bf16(__fmul_rn(x.x, sc), __fmul_rn(x.y, sc));
        }
#pragma unroll
        for (int j = 0; j < NT; ++j) mma_bf16(part[mt][j], fa, fb[j][ks]);
      }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) sum[mt][j][q] += part[mt][j][q];
  }
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q)
        store_out(acc, m0 + wm + 16 * mt + g8 + 8 * (q >> 1), n0 + 8 * j + c + (q & 1),
                  sum[mt][j][q], la, lb, acc_rows, acc_cols);
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

constexpr int kE3Slots = 4;  // slots per block: 256 threads, 64 per slot

__global__ void __launch_bounds__(256)
    e3_kernel(const int* __restrict__ idx, int n, const float* __restrict__ v,
              float* __restrict__ acc) {
  __shared__ int warp_counts[8][kE3Slots];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const unsigned slot0 = blockIdx.x * kE3Slots;
  int cnt[kE3Slots] = {};
  // An entry p counts for slot slot0 + d when p - slot0 == d < kE3Slots
  // (unsigned: negative indices and those past the last slot match none).
  auto count = [&](int p) {
    const unsigned d = static_cast<unsigned>(p) - slot0;
#pragma unroll
    for (int k = 0; k < kE3Slots; ++k) cnt[k] += d == static_cast<unsigned>(k);
  };
  const int n4 = n >> 2;
  for (int j = tid; j < n4; j += 256) {
    const int4 q = reinterpret_cast<const int4*>(idx)[j];
    count(q.x);
    count(q.y);
    count(q.z);
    count(q.w);
  }
  for (int j = 4 * n4 + tid; j < n; j += 256) count(idx[j]);
#pragma unroll
  for (int k = 0; k < kE3Slots; ++k) {
    const int s = __reduce_add_sync(0xffffffffu, cnt[k]);
    if (lane == 0) warp_counts[warp][k] = s;
  }
  __syncthreads();
  const int k = tid >> 6, q = tid & 63;  // slot slot0 + k, float4s q + 64u
  int adds = 0;
#pragma unroll
  for (int w = 0; w < 8; ++w) adds += warp_counts[w][k];
  float4 x[4], s[4];
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    x[u] = reinterpret_cast<const float4*>(v)[q + 64 * u];
    s[u] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  for (int j = 0; j < adds; ++j) {
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      s[u].x = __fadd_rn(s[u].x, x[u].x);
      s[u].y = __fadd_rn(s[u].y, x[u].y);
      s[u].z = __fadd_rn(s[u].z, x[u].z);
      s[u].w = __fadd_rn(s[u].w, x[u].w);
    }
  }
  float4* dst = reinterpret_cast<float4*>(acc + static_cast<size_t>(slot0 + k) * 1024);
#pragma unroll
  for (int u = 0; u < 4; ++u) dst[q + 64 * u] = s[u];
}

// ---- e12 ---------------------------------------------------------------

constexpr int kE12Warps = 4;   // a block owns one slot: warp w its 16x16 quadrant
constexpr int kE12Threads = 32 * kE12Warps;
constexpr int kE12Stages = 4;  // products staged in the slot's ring
constexpr int kE12LdX = 36;    // a staged row of X_t: 32 floats + 16 bytes
constexpr int kE12LdL = 40;    // a staged row of L_e: 32 floats + 32 bytes
constexpr int kE12ProductFloats = 32 * (kE12LdX + kE12LdL);
constexpr int kE12Chunk = 4096;  // entries scanned per chunk: the hit list's size
constexpr int kE12WarpSpan = kE12Chunk / kE12Warps;  // a warp's share of a chunk

// d += A(16x8) B(8x8) on the tensor cores, tf32 operands in the m16n8k8
// fragment layout, f32 accumulators.
__device__ __forceinline__ void mma_tf32(float* d, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// The entries of [base, min(base + kE12Chunk, n)) whose slot is this
// block's, as offsets from base in ascending order; returns their number.
// Warp w scans entries kE12WarpSpan w + [0, kE12WarpSpan), lane l four of
// each 128 (coalesced 16-byte loads, lane order entry order); a ballot per
// bit gives each lane its rank in its step, the warps' totals their offsets.
// Every thread must call it.
__device__ __forceinline__ int e12_scan(const int* __restrict__ idx, int n, int base,
                                        unsigned short* hits, int* warp_total) {
  constexpr int kSteps = kE12WarpSpan / 128;
  static_assert(kSteps * 4 <= 32, "a lane's flags fit one word");
  const int slot = blockIdx.x, lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned below = (1u << lane) - 1u;
  const int first = base + kE12WarpSpan * warp + 4 * lane;
  unsigned flags = 0;  // bit 4 s + j: entry first + 128 s + j is this slot's
#pragma unroll
  for (int s = 0; s < kSteps; ++s) {  // all loads in flight at once
    const int q = first + 128 * s;
    int4 w = make_int4(-1, -1, -1, -1);
    if (q + 4 <= n) {
      w = *reinterpret_cast<const int4*>(idx + q);
    } else if (q < n) {
      w.x = idx[q];
      if (q + 1 < n) w.y = idx[q + 1];
      if (q + 2 < n) w.z = idx[q + 2];
    }
    flags |= (static_cast<unsigned>(w.x == slot) | static_cast<unsigned>(w.y == slot) << 1 |
              static_cast<unsigned>(w.z == slot) << 2 | static_cast<unsigned>(w.w == slot) << 3)
             << (4 * s);
  }
  int rank[kSteps], total = 0;  // this lane's first hit in step s; the warp's hits
#pragma unroll
  for (int s = 0; s < kSteps; ++s) {
    rank[s] = total;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const unsigned b = __ballot_sync(0xffffffffu, flags >> (4 * s + j) & 1u);
      rank[s] += __popc(b & below);
      total += __popc(b);
    }
  }
  if (lane == 0) warp_total[warp] = total;
  __syncthreads();
  int off = 0, n_hits = 0;
#pragma unroll
  for (int k = 0; k < kE12Warps; ++k) {
    off += k < warp ? warp_total[k] : 0;
    n_hits += warp_total[k];
  }
#pragma unroll
  for (int s = 0; s < kSteps; ++s) {
    unsigned m = flags >> (4 * s) & 0xfu;
    int at = off + rank[s];
    while (m != 0) {
      const int j = __ffs(m) - 1;
      m &= m - 1;
      hits[at++] = static_cast<unsigned short>(first - base + 128 * s + j);
    }
  }
  __syncthreads();
  return n_hits;
}

// sum += the products of entries entry(0), ..., entry(count - 1), each
// formed in its own partial and added in that order, through the block's
// ring of kE12Stages products: one barrier a product, the next products'
// operands in flight under this one's math.  Warp w forms rows 16 (w / 2)
// and columns 16 (w % 2) + [0, 16) of each product, two 16x8 mma tiles.
// Ends with the ring free.  Every thread must call it.
template <bool kMma, typename F>
__device__ __forceinline__ void e12_products(float (&sum)[2][4], float* ring, int count,
                                             int nbrow, const float* __restrict__ a_wide,
                                             const float* __restrict__ panel, int a_lanes,
                                             F entry) {
  // L_e's row pitch: each tier's fragment loads free of bank conflicts.
  constexpr int kLdL = kMma ? kE12LdX : kE12LdL;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int tm = 16 * (warp >> 1), tn = 16 * (warp & 1);
  auto issue = [&](int h) {
    if (h < count) {
      const int q = entry(h);
      const int e = q / nbrow, t = q - e * nbrow;
      float* sx = ring + (h % kE12Stages) * kE12ProductFloats;
      float* sl = sx + 32 * kE12LdX;
      const float* px = panel + static_cast<size_t>(t) * 1024;
      const float* pl = a_wide + static_cast<size_t>(e) * 32 * a_lanes;
#pragma unroll
      for (int i = 0; i < 256 / kE12Threads; ++i) {  // 32 rows of 8 16-byte chunks
        const int c = tid + kE12Threads * i, row = c >> 3, ch = (c & 7) * 4;
        cp_async16(sx + row * kE12LdX + ch, px + row * 32 + ch);
        cp_async16(sl + row * kLdL + ch, pl + row * a_lanes + ch);
      }
    }
    cp_async_commit();  // an empty group past the end keeps the count
  };
#pragma unroll
  for (int h = 0; h < kE12Stages - 1; ++h) issue(h);
  for (int h = 0; h < count; ++h) {
    cp_async_wait<kE12Stages - 2>();  // this thread's copies of product h landed
    __syncthreads();  // everyone's have, and product h - 1 is consumed
    issue(h + kE12Stages - 1);
    const float* sx = ring + (h % kE12Stages) * kE12ProductFloats;  // X_t [m][k]
    const float* sl = sx + 32 * kE12LdX;                             // L_e [k][n]
    float part[2][4] = {};
    if constexpr (!kMma) {
      // 3xTF32 a k8 step: small*big + big*small + big*big.
#pragma unroll
      for (int k0 = 0; k0 < 32; k0 += 8) {
        const float* xa = sx + (tm + g) * kE12LdX + k0 + t4;
        uint32_t ab[4], as[4];
        tf32_split(xa[0], ab[0], as[0]);
        tf32_split(xa[8 * kE12LdX], ab[1], as[1]);
        tf32_split(xa[4], ab[2], as[2]);
        tf32_split(xa[8 * kE12LdX + 4], ab[3], as[3]);
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          const float* lb = sl + (k0 + t4) * kLdL + tn + 8 * nt + g;
          uint32_t bb[2], bs[2];
          tf32_split(lb[0], bb[0], bs[0]);
          tf32_split(lb[4 * kLdL], bb[1], bs[1]);
          mma_tf32(part[nt], as, bb);
          mma_tf32(part[nt], ab, bs);
          mma_tf32(part[nt], ab, bb);
        }
      }
    } else {
#pragma unroll
      for (int k0 = 0; k0 < 32; k0 += 16) {
        uint32_t fa[4];
        load_a(fa, sx, kE12LdX, 1, tm, k0, 1.0f);
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          uint32_t fb[2];
          load_b(fb, sl, kLdL, k0, tn + 8 * nt);
          mma_bf16(part[nt], fa, fb);
        }
      }
    }
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
      for (int u = 0; u < 4; ++u) sum[nt][u] += part[nt][u];
    }
  }
  cp_async_wait<0>();
  __syncthreads();
}

// Block `slot` owns one [8, 128] slot (a 32x32 block).  idx null: entry q
// goes to slot q % nbrow (the slot's entries are t = slot, e ascending,
// and need no scan).
template <bool kMma>
__global__ void __launch_bounds__(kE12Threads)
    e12_kernel(const int* __restrict__ idx, int n, int nbrow,
               const float* __restrict__ a_wide, const float* __restrict__ panel,
               float* __restrict__ acc, int a_lanes) {
  __shared__ __align__(16) float ring[kE12Stages * kE12ProductFloats];
  __shared__ unsigned short hits[kE12Chunk];  // this slot's entries - base
  __shared__ int warp_total[kE12Warps];
  const int slot = blockIdx.x;
  float sum[2][4] = {};
  if (idx == nullptr) {
    const int count = slot < nbrow && slot < n ? (n - slot + nbrow - 1) / nbrow : 0;
    e12_products<kMma>(sum, ring, count, nbrow, a_wide, panel, a_lanes,
                       [&](int h) { return slot + h * nbrow; });
  } else {
    for (int base = 0; base < n; base += kE12Chunk) {
      const int n_hits = e12_scan(idx, n, base, hits, warp_total);
      e12_products<kMma>(sum, ring, n_hits, nbrow, a_wide, panel, a_lanes,
                         [&](int h) { return base + hits[h]; });
    }
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = 16 * (warp >> 1) + (lane >> 2), col = 16 * (warp & 1) + 2 * (lane & 3);
  float* dst = acc + static_cast<size_t>(slot) * 1024;
#pragma unroll
  for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
    for (int u = 0; u < 4; ++u) dst[(row + 8 * (u >> 1)) * 32 + col + 8 * nt + (u & 1)] = sum[nt][u];
  }
}

using DotKernel = void (*)(const float*, const float*, float*, int, int, int, int, int);

// Launches a dot kernel whose blocks of `threads` threads each own a bm x bn
// tile of acc, on as many tiles as cover acc.
int launch_dot(DotKernel kernel, int bm, int bn, int threads, const float* at,
               const float* bp, float* acc, int la, int lb, int acc_rows, int acc_cols,
               int reps, cudaStream_t stream) {
  const int grid_x = (acc_cols + bn - 1) / bn, grid_y = (acc_rows + bm - 1) / bm;
  if (grid_y > 65535) return static_cast<int>(cudaErrorInvalidValue);
  kernel<<<dim3(grid_x, grid_y), threads, 0, stream>>>(at, bp, acc, la, lb, acc_rows,
                                                        acc_cols, reps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Every entry launches on `stream` and returns cudaGetLastError() (0 on
// success).  Pointers are device memory, f32 unless named int; `acc` is
// row-major with `acc_cols` columns.

// micro "wide" and "quad": at [32, la], bp [32, lb] -> the whole acc
// [acc_rows >= la, acc_cols >= lb], its padding written zero.  Each tier
// has one tiling: "highest" 4x4 FFMA tiles in 16 x 64 blocks of 2 warps,
// two reps a step, B's depths 0-15 in registers; "default" 2 warps of
// 16 x 32 mma tiles in 32 x 32 blocks.
int hbsm_micro_dot(const float* at, const float* bp, float* acc, int la, int lb,
                   int acc_rows, int acc_cols, int reps, int precision, void* stream) {
  if (la > acc_rows || lb > acc_cols) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (precision == 0)
    return launch_dot(dot_ffma_kernel<4, 4, 4, 16, 2, 16>, 16, 64, 64, at, bp, acc, la, lb,
                      acc_rows, acc_cols, reps, st);
  if (precision == 2)
    return launch_dot(dot_mma_lane_kernel<1, 4, 2>, 32, 32, 64, at, bp, acc, la, lb,
                      acc_rows, acc_cols, reps, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// micro "flatten" on acc [>= 256, acc_cols >= 128], zero on entry.
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

// e3: idx int [n] (16-byte aligned), v [8, 128] -> the whole acc [n_slots,
// 8, 128]; n_slots a multiple of kE3Slots.
int hbsm_e3(const int* idx, int n, const float* v, float* acc, int n_slots, void* stream) {
  if (n < 0 || n_slots <= 0 || n_slots % kE3Slots)
    return static_cast<int>(cudaErrorInvalidValue);
  e3_kernel<<<n_slots / kE3Slots, 256, 0, static_cast<cudaStream_t>(stream)>>>(idx, n, v,
                                                                               acc);
  return static_cast<int>(cudaGetLastError());
}

// e12: idx int [n] (16-byte aligned; null: entry q goes to slot q %
// nbrow), n = RA * nbrow entries e * nbrow + t; a_wide [RA, 32, a_lanes]
// (a_lanes a multiple of 4), panel [8 * nbrow, 128] -> the whole acc
// [n_slots, 8, 128].  One launch: each block finds its slot's entries.
int hbsm_e12(const int* idx, const float* a_wide, const float* panel, float* acc, int n,
             int n_slots, int nbrow, int a_lanes, int precision, void* stream) {
  if (n_slots == 0) return 0;
  if (n < 0 || nbrow <= 0 || a_lanes < 32 || a_lanes % 4 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (precision == 0) {
    e12_kernel<false><<<n_slots, kE12Threads, 0, st>>>(idx, n, nbrow, a_wide, panel, acc, a_lanes);
  } else if (precision == 2) {
    e12_kernel<true><<<n_slots, kE12Threads, 0, st>>>(idx, n, nbrow, a_wide, panel, acc, a_lanes);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* hbsm_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
