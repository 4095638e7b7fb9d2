// Pod GEMM for Hopper (sm_90a), in two weight layouts and a grouped form:
//   out[M, N] = act((x[M, K] @ w[K, N]) * scale[N] + bias[N])     (NN)
//   out[M, N] = act((x[M, K] @ w[N, K]^T) * scale[N] + bias[N])   (NT)
//   out[g] = act((x[g] @ w[g]) * scale[g] + bias[g]), g < G        (grouped)
// each cast to out.
//
// NN replaces the TPU kernel repro/kernels/systolic_gemm/systolic_gemm.py::
// systolic_gemm_pallas (_gemm_kernel, _accumulate, _epilogue_math); NT
// replaces systolic_gemm_nt_pallas (_gemm_nt_kernel, _accumulate_nt), the
// tied-embedding LM head that reads the [vocab, d] token table in its
// stored layout; grouped replaces grouped_systolic_gemm_pallas
// (_grouped_gemm_kernel), the MoE expert FFNs: G independent NN GEMMs
// (one per expert) in one launch, x [G, M, K], w [G, K, N], scale and
// bias [G, N], out [G, M, N]. The TPU grid grows a leading group axis
// and reuses one accumulator scratch group after group; here the group
// is blockIdx.z, and a block reads, scales and stores only its group's
// matrices, so a group's rows, ragged edges and epilogue are exactly a
// plain launch's of the same mainloop. A group of zero rows with a zero
// bias (an expert no token reached) comes out exactly 0.
//
// What it computes is the same as on the TPU; how is not carried over
// block by block. The TPU grid walks K as its minor sequential axis and
// carries the accumulator in VMEM scratch from one grid step to the next.
// Here a block walks K in a loop of its own with the accumulator in
// registers, and the epilogue (scale, bias, activation in f32, then one
// rounding to out) runs once per output. Four mainloops; the caller picks
// one by form and shape (systolic_gemm.py::gemm_plan) and passes it in:
//
//   * splitk (bf16 NN and NT, M <= 64: decode and short prefills). Bound
//     by bytes: every weight byte is read once per call (granite-8b's 253
//     GEMMs of a decode step move 16.1 GB, 4.8 ms at 3.35 TB/s), and the
//     tensor cores idle. What held the wmma kernel at 0.3-0.5 TB/s was
//     too few blocks in flight: granite's q projection made 64. Here
//     blocks tile N in strips of 64 or 128 columns AND split K into
//     `splits` ranges, so some 260-800 blocks stream the weights (up to
//     five per SM at once); each streams its [K range, strip] of w
//     through a cp.async ring (16-byte loads into shared memory, L1
//     bypassed; NN 4 stages of 32 k rows of w; NT 3 stages of 64 k along
//     the strip's rows of w [N, K], as stored, a 128-byte line a row)
//     with x's rows beside it, and multiplies on mma.sync m16n8k16 with
//     the rows padded to 16. A split writes its f32 partial
//     [M, strip] to a workspace and bumps the strip's arrival counter
//     after a __threadfence; the last to arrive sums the partials in
//     split order 0..splits-1 (eight loads in flight per thread), runs
//     the epilogue, stores and resets the counter to 0.
//     One launch per GEMM, and the same inputs give the same bits.
//   * wgmma (bf16 NN, NT and grouped, M > 64: prefill). Bound by
//     operations (a 1024-row forward of granite-8b is 16.5 TFLOP, 16.7 ms
//     at 989 TFLOP/s; dbrx's 16 experts at 320 rows each 0.68 TFLOP). The
//     wmma kernel's mma.sync reached about 120 TFLOP/s. Here one block
//     per 128 x 128 output tile: a producer warpgroup, which hands its
//     registers to the consumers (setmaxnreg), keeps a 6-stage ring of
//     [128 x 64] x and [64 x 128] w tiles full from one thread with TMA
//     loads (128-byte swizzle; NN and grouped w as two [64 k x 64 n]
//     boxes, NT w as one [128 n x 64 k] box), each stage signalled by an
//     mbarrier with its byte count; two consumer warpgroups run wgmma
//     m64n128k16 on their 64-row halves (A K-major; B MN-major with the
//     transpose bit for NN and grouped, K-major without it for NT) and
//     give a stage back only after wgmma.wait_group shows its products
//     done. Six stages, not wider tiles, paid off on this card: loads in
//     flight set the pace (128 x 256 tiles with 4 stages ran slower). TMA
//     zero-fills ragged N and K, and M below 128 (a grouped launch's maps
//     are 3-D, so the zeros past M stay inside the group); where M >= 128
//     the last M tile starts at M - 128 instead, overlapping the one
//     before it and storing only its own rows, since a box half past M
//     loaded slower than a whole one (dbrx's expert capacities of 144-399
//     rows). The epilogue runs from the accumulator registers with
//     guarded stores. Blocks walk M fastest,
//     so the tiles of one weight strip run together and the strip is read
//     from memory about once. Not persistent: a tile's epilogue does not
//     overlap the next tile's loads, and there are no clusters or
//     multicast.
//
//   Both sum K in the same order: `splits` ranges (from N and K only, one
//   rule for every form; each an even number of 32-deep steps, so a range
//   starts with a wgmma stage), each range from zero in k16 steps, the
//   ranges added in order; wgmma keeps a range's sum and the running total
//   in two register sets and adds them between stages. The tensor cores
//   round a k16 step alike under mma.sync and wgmma, so a row's result is
//   bit-equal at every M: a decode lane alone or in a batch, a prompt
//   prefilled alone (M = S) or in a bucket (M = 4 x bucket, the other
//   mainloop), and a grouped launch with G = 1 equals the NN launch of the
//   same shape.
//   * wmma (bf16 where TMA cannot go: K or N not a multiple of 8, or x or
//     w not 16-byte aligned; and the grouped form at M <= 64): tensor
//     cores through nvcuda::wmma (mma.sync, 16x16x16), tile BM x 64 (BM =
//     16 for M <= 16, else 64), K in steps of 32 staged through shared
//     memory with the next step's loads in registers during the products
//     (two stages). Ragged edges masked in the kernel. The grouped form
//     keeps it at decode: dbrx-132b's 16 experts at M = 1 row each read
//     16 x 6144 x 10752 bf16 weights (2.11 GB) for 2 GFLOP, bound by bytes
//     (0.631 ms at 3.35 TB/s), and its 2,688 blocks of 16 x 64 keep enough
//     loads in flight to read them at about 2.9 TB/s, within 1.06x of
//     torch.bmm; a grouped splitk would add a workspace per group for
//     little.
//   * simt (f32 x f32 -> f32 and int8 x int8 -> int32): FMA / integer
//     multiply-add on the CUDA cores, 64 x 64 tiles, 4 x 4 outputs per
//     thread. f32 stays full f32 (TF32 would change the numbers); int32
//     accumulation is exact, then the epilogue runs in f32 as on the TPU.
//
// C interface (bound with ctypes): systolic_gemm_launch (NN) and
// systolic_gemm_nt_launch (NT), each with its mainloop, splits, strip
// width and split-K workspace and counters, and
// grouped_systolic_gemm_launch (mainloop, splits, tile width) return
// cudaGetLastError() after the launch, or cudaErrorInvalidValue for
// arguments the kernels do not take (G > 65535, the grid's z limit; a
// mainloop the form, dtype, shape or alignment does not allow; a tensor
// map cuTensorMapEncodeTiled refuses); the caller raises when it is not 0.

#include <cuda.h>  // CUtensorMap and its enums; the encoder comes from the runtime
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

#include "../../csrc/hopper.cuh"  // smem_u32, mbarriers, TMA, wgmma, tensor maps

using namespace nvcuda;

namespace {

enum Act { ACT_NONE = 0, ACT_RELU = 1, ACT_GELU = 2, ACT_SILU = 3, ACT_RELU2 = 4 };
enum InType { IN_F32 = 0, IN_BF16 = 1, IN_INT8 = 2 };
enum OutType { OUT_F32 = 0, OUT_BF16 = 1 };
enum Mainloop { ML_WMMA = 0, ML_SPLITK = 1, ML_WGMMA = 2, ML_SIMT = 3 };

// The TPU kernel's _epilogue_math: dequant scale, bias, activation, in f32.
// gelu is the tanh approximation (jax.nn.gelu's default). silu uses the
// fast exp and divide (a few ulp, inside every tolerance): with expf and
// an IEEE divide the epilogue held granite's gate projection at M = 1024
// about 100 us behind the same GEMM without it.
__device__ __forceinline__ float epilogue(float acc, const float* scale,
                                          const float* bias, int col, int act) {
  if (scale != nullptr) acc = acc * scale[col];
  if (bias != nullptr) acc = acc + bias[col];
  switch (act) {
    case ACT_RELU:
      acc = fmaxf(acc, 0.f);
      break;
    case ACT_GELU: {
      const float u = 0.7978845608028654f * (acc + 0.044715f * acc * acc * acc);
      acc = 0.5f * acc * (1.f + tanhf(u));
      break;
    }
    case ACT_SILU:
      acc = __fdividef(acc, 1.f + __expf(-acc));
      break;
    case ACT_RELU2: {
      const float r = fmaxf(acc, 0.f);
      acc = r * r;
      break;
    }
    default:
      break;
  }
  return acc;
}

// Group g = blockIdx.z of a grouped launch (0 in a plain one): move x,
// w, out, scale and bias to group g's matrices, which lie back to back.
#define GROUP_OFFSETS()                                \
  do {                                                 \
    const size_t g_ = blockIdx.z;                      \
    x += g_ * M * K;                                   \
    w += g_ * K * N;                                   \
    out += g_ * M * N;                                 \
    if (scale != nullptr) scale += g_ * N;             \
    if (bias != nullptr) bias += g_ * N;               \
  } while (0)

__device__ __forceinline__ void store_out(float* o, float v) { *o = v; }
__device__ __forceinline__ void store_out(__nv_bfloat16* o, float v) {
  *o = __float2bfloat16(v);  // round to nearest even, as torch and XLA
}

// Two neighbouring columns (col even, N even: 8- or 4-byte aligned).
__device__ __forceinline__ void store_pair(float* o, float v0, float v1) {
  *reinterpret_cast<float2*>(o) = make_float2(v0, v1);
}
__device__ __forceinline__ void store_pair(__nv_bfloat16* o, float v0, float v1) {
  *reinterpret_cast<__nv_bfloat162*>(o) = __floats2bfloat162_rn(v0, v1);
}

// ---------------------------------------------------------------------------
// bf16: wmma tensor-core path
// ---------------------------------------------------------------------------

constexpr int BN = 64;
constexpr int BK = 32;
constexpr int THREADS = 128;   // 4 warps
constexpr int A_LD = BK + 8;   // 80-byte rows: 16-byte aligned, fewer bank conflicts
constexpr int B_LD = BN + 8;   // 144-byte rows (NN: w tile [BK][BN])
constexpr int BT_LD = BK + 8;  // 80-byte rows (NT: w tile [BN][BK])
constexpr int C_LD = BN + 4;   // 272-byte rows

// 8 consecutive bf16 of row `row` from column `col`, zero outside the matrix.
__device__ __forceinline__ uint4 load8(const __nv_bfloat16* __restrict__ p,
                                       int row, int col, int rows, int cols,
                                       bool vec) {
  uint4 out = make_uint4(0u, 0u, 0u, 0u);
  if (row >= rows || col >= cols) return out;
  const __nv_bfloat16* src = p + (size_t)row * cols + col;
  if (vec && col + 8 <= cols) return *reinterpret_cast<const uint4*>(src);
  unsigned short h[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  const unsigned short* s = reinterpret_cast<const unsigned short*>(src);
  for (int j = 0; j < 8; ++j)
    if (col + j < cols) h[j] = s[j];
  out.x = h[0] | (uint32_t(h[1]) << 16);
  out.y = h[2] | (uint32_t(h[3]) << 16);
  out.z = h[4] | (uint32_t(h[5]) << 16);
  out.w = h[6] | (uint32_t(h[7]) << 16);
  return out;
}

// TW: w is [N, K] (NT) instead of [K, N] (NN).
template <int BM, bool TW, typename OutT>
__global__ void __launch_bounds__(THREADS)
gemm_bf16_wmma(const __nv_bfloat16* __restrict__ x,
               const __nv_bfloat16* __restrict__ w,
               const float* __restrict__ scale, const float* __restrict__ bias,
               OutT* __restrict__ out, int M, int N, int K, int act) {
  constexpr int WM = BM >= 32 ? 2 : 1;  // warps along M
  constexpr int WN = 4 / WM;            // warps along N
  constexpr int TM = BM / WM;           // warp tile
  constexpr int TN = BN / WN;
  constexpr int FM = TM / 16;           // 16x16 fragments per warp tile
  constexpr int FN = TN / 16;
  constexpr int A_VEC = BM * BK / 8;    // 16-byte vectors per A tile
  constexpr int B_VEC = BK * BN / 8;
  constexpr int A_PER = (A_VEC + THREADS - 1) / THREADS;
  constexpr int B_PER = B_VEC / THREADS;
  static_assert(B_VEC % THREADS == 0, "B tile must split evenly");

  __shared__ __align__(128) __nv_bfloat16 As[BM * A_LD];
  __shared__ __align__(128) __nv_bfloat16 Bs[TW ? BN * BT_LD : BK * B_LD];
  __shared__ __align__(128) float Cs[BM * C_LD];

  GROUP_OFFSETS();
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int wm = warp / WN;
  const int wn = warp % WN;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const bool vec_a = (K % 8 == 0) && ((reinterpret_cast<uintptr_t>(x) & 15) == 0);
  const bool vec_b = ((TW ? K : N) % 8 == 0) && ((reinterpret_cast<uintptr_t>(w) & 15) == 0);

  uint4 ra[A_PER];
  uint4 rb[B_PER];
  auto load = [&](int k0) {
#pragma unroll
    for (int i = 0; i < A_PER; ++i) {
      const int v = tid + i * THREADS;
      if (v < A_VEC) {
        const int r = v / (BK / 8), c = (v % (BK / 8)) * 8;
        ra[i] = load8(x, m0 + r, k0 + c, M, K, vec_a);
      }
    }
#pragma unroll
    for (int i = 0; i < B_PER; ++i) {
      const int v = tid + i * THREADS;
      if constexpr (TW) {  // row n of w, 8 consecutive k
        const int r = v / (BK / 8), c = (v % (BK / 8)) * 8;
        rb[i] = load8(w, n0 + r, k0 + c, N, K, vec_b);
      } else {             // row k of w, 8 consecutive n
        const int r = v / (BN / 8), c = (v % (BN / 8)) * 8;
        rb[i] = load8(w, k0 + r, n0 + c, K, N, vec_b);
      }
    }
  };
  auto stage = [&]() {
#pragma unroll
    for (int i = 0; i < A_PER; ++i) {
      const int v = tid + i * THREADS;
      if (v < A_VEC) {
        const int r = v / (BK / 8), c = (v % (BK / 8)) * 8;
        *reinterpret_cast<uint4*>(&As[r * A_LD + c]) = ra[i];
      }
    }
#pragma unroll
    for (int i = 0; i < B_PER; ++i) {
      const int v = tid + i * THREADS;
      if constexpr (TW) {
        const int r = v / (BK / 8), c = (v % (BK / 8)) * 8;
        *reinterpret_cast<uint4*>(&Bs[r * BT_LD + c]) = rb[i];
      } else {
        const int r = v / (BN / 8), c = (v % (BN / 8)) * 8;
        *reinterpret_cast<uint4*>(&Bs[r * B_LD + c]) = rb[i];
      }
    }
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[FM][FN];
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  load(0);
  for (int k0 = 0; k0 < K; k0 += BK) {
    stage();
    __syncthreads();
    if (k0 + BK < K) load(k0 + BK);  // next step's loads fly during the MMAs
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a[FM];
      // NT: the [n][k] tile read as column-major (k, n), no transpose
      using BLayout = std::conditional_t<TW, wmma::col_major, wmma::row_major>;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, BLayout> b[FN];
#pragma unroll
      for (int i = 0; i < FM; ++i)
        wmma::load_matrix_sync(a[i], &As[(wm * TM + i * 16) * A_LD + kk], A_LD);
#pragma unroll
      for (int j = 0; j < FN; ++j) {
        if constexpr (TW)
          wmma::load_matrix_sync(b[j], &Bs[(wn * TN + j * 16) * BT_LD + kk], BT_LD);
        else
          wmma::load_matrix_sync(b[j], &Bs[kk * B_LD + wn * TN + j * 16], B_LD);
      }
#pragma unroll
      for (int i = 0; i < FM; ++i)
#pragma unroll
        for (int j = 0; j < FN; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  // fused epilogue: fragments -> shared tile -> scale/bias/act -> out, once
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j)
      wmma::store_matrix_sync(&Cs[(wm * TM + i * 16) * C_LD + wn * TN + j * 16],
                              acc[i][j], C_LD, wmma::mem_row_major);
  __syncthreads();
  for (int e = tid; e < BM * BN; e += THREADS) {
    const int r = e / BN, c = e % BN;
    const int gr = m0 + r, gc = n0 + c;
    if (gr < M && gc < N)
      store_out(&out[(size_t)gr * N + gc], epilogue(Cs[r * C_LD + c], scale, bias, gc, act));
  }
}

// ---------------------------------------------------------------------------
// f32 and int8: CUDA-core path
// ---------------------------------------------------------------------------

constexpr int S_BM = 64;
constexpr int S_BN = 64;
constexpr int S_BK = 16;
constexpr int S_THREADS = 256;  // 16 x 16 threads, 4 x 4 outputs each

template <bool TW, typename InT, typename AccT, typename OutT>
__global__ void __launch_bounds__(S_THREADS)
gemm_simt(const InT* __restrict__ x, const InT* __restrict__ w,
          const float* __restrict__ scale, const float* __restrict__ bias,
          OutT* __restrict__ out, int M, int N, int K, int act) {
  __shared__ InT As[S_BK][S_BM + 1];  // k-major, so a row of A is a column here
  __shared__ InT Bs[S_BK][S_BN];

  GROUP_OFFSETS();
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * S_BM, n0 = blockIdx.x * S_BN;
  AccT acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = AccT(0);

  for (int k0 = 0; k0 < K; k0 += S_BK) {
    for (int e = tid; e < S_BM * S_BK; e += S_THREADS) {
      const int r = e / S_BK, c = e % S_BK;
      const int gr = m0 + r, gc = k0 + c;
      As[c][r] = (gr < M && gc < K) ? x[(size_t)gr * K + gc] : InT(0);
    }
    for (int e = tid; e < S_BK * S_BN; e += S_THREADS) {
      if constexpr (TW) {  // consecutive threads read consecutive k of row n
        const int c = e / S_BK, r = e % S_BK;
        const int gr = k0 + r, gc = n0 + c;
        Bs[r][c] = (gr < K && gc < N) ? w[(size_t)gc * K + gr] : InT(0);
      } else {
        const int r = e / S_BN, c = e % S_BN;
        const int gr = k0 + r, gc = n0 + c;
        Bs[r][c] = (gr < K && gc < N) ? w[(size_t)gr * N + gc] : InT(0);
      }
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < S_BK; ++k) {
      AccT a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = AccT(As[k][ty + 16 * i]);
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = AccT(Bs[k][tx + 16 * j]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] += a[i] * b[j];
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gr = m0 + ty + 16 * i, gc = n0 + tx + 16 * j;
      if (gr < M && gc < N)
        store_out(&out[(size_t)gr * N + gc],
                  epilogue(static_cast<float>(acc[i][j]), scale, bias, gc, act));
    }
}

// ---------------------------------------------------------------------------
// bf16 NN and NT at M <= 64: split-K over a cp.async ring (decode)
// ---------------------------------------------------------------------------

constexpr int SK_BK = 32;          // k-step of the split ranges (and of NN's stages)
constexpr int SK_STAGES = 4;       // NN's ring depth
constexpr int SK_THREADS = 128;    // 4 warps, each owning BN / 4 columns
// NT's stages: 64 k deep, so each of the strip's rows of w [N, K] arrives as
// one 128-byte line a stage, three stages in flight. 32-deep stages (half a
// line a row) read mamba2's head at decode slower on the H100 than the
// library call; these read it faster.
constexpr int SK_NT_BK = 64;
constexpr int SK_NT_STAGES = 3;

// One ring stage: x [16 MT][BK] and w [BK][BN] (NN) or [BN][BK] (TW: NT,
// w read K-major as stored), rows padded by 16 bytes (ldmatrix without
// bank conflicts).
template <int MT, int BN, bool TW>
struct SplitkTile {
  static constexpr int BK = TW ? SK_NT_BK : SK_BK;  // k per stage
  static constexpr int STAGES = TW ? SK_NT_STAGES : SK_STAGES;
  static constexpr int XLD = BK + 8;
  static constexpr int WLD = TW ? XLD : BN + 8;
  static constexpr int X_ELEMS = MT * 16 * XLD;
  static constexpr int W_ELEMS = (TW ? BN : BK) * WLD;
  static constexpr int STAGE = X_ELEMS + W_ELEMS;    // bf16 elements
  static constexpr int SMEM = STAGES * STAGE * 2;    // bytes
};

// 16 bytes global -> shared through L2 only; zero-filled when !valid.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING) : "memory");
}

// Four 8x8 bf16 matrices from shared memory: lane L gives the address of
// row L % 8 of matrix L / 8; .trans delivers each transposed.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}

// c += a (16x16, row) * b (16x8, col), bf16 in, f32 accumulate.
__device__ __forceinline__ void mma_16816(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                          uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Block (strip, split) = (blockIdx.x, blockIdx.y): columns [strip * BN,
// + BN) over 32-deep k-steps [split * per, min(steps, (split + 1) * per))
// with per = ceil(steps / splits); the launcher makes sure the last range
// is not empty (and, for NT's deeper stages, that ranges but the last are
// whole stages). With one split the block runs the epilogue itself; otherwise
// it writes its f32 partial [M, BN] to ws[strip][split] and the last
// block of the strip to arrive sums ws[strip][0..splits-1] in that order,
// runs the epilogue and resets counters[strip] to 0 for the next launch.
// MT = ceil(M / 16) row tiles; rows past M are zero-filled and not stored.
// TW: w is [N, K] (NT); a stage holds the strip's BN rows of w, SK_BK deep,
// and B fragments come from ldmatrix without .trans. The ring, the
// workspace, the counters and the reduction are the NN form's.
template <int MT, int BN, bool TW, typename OutT>
__global__ void __launch_bounds__(SK_THREADS)
gemm_bf16_splitk(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
                 const float* __restrict__ scale, const float* __restrict__ bias,
                 OutT* __restrict__ out, float* __restrict__ ws, int* __restrict__ counters,
                 int M, int N, int K, int act) {
  using Tile = SplitkTile<MT, BN, TW>;
  constexpr int BK = Tile::BK, STAGES = Tile::STAGES;
  constexpr int WN = BN / 4;           // columns per warp
  constexpr int NT = WN / 8;           // n8 tiles per warp (2 or 4)
  constexpr int XV = MT * 16 * (BK / 8);   // 16-byte vectors per stage
  constexpr int WV = BK * (BN / 8);
  static_assert(WV % SK_THREADS == 0 && NT % 2 == 0, "stage must split evenly");
  extern __shared__ __align__(16) __nv_bfloat16 sk_smem[];
  __shared__ int sk_last;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int strip = blockIdx.x, split = blockIdx.y, splits = gridDim.y;
  const int n0 = strip * BN;
  const int steps = (K + SK_BK - 1) / SK_BK;
  const int per = (steps + splits - 1) / splits;
  const int kbeg = split * per * SK_BK;
  const int nsteps = (min(K, kbeg + per * SK_BK) - kbeg + BK - 1) / BK;

  auto load_stage = [&](int t) {  // stage t of the range into slot t % STAGES
    __nv_bfloat16* xs = sk_smem + (t % STAGES) * Tile::STAGE;
    __nv_bfloat16* wt = xs + Tile::X_ELEMS;
    const int k0 = kbeg + t * BK;
#pragma unroll
    for (int i = 0; i < (XV + SK_THREADS - 1) / SK_THREADS; ++i) {
      const int v = tid + i * SK_THREADS;
      if (v < XV) {
        const int r = v / (BK / 8), c = (v % (BK / 8)) * 8;
        const bool ok = r < M && k0 + c < K;
        cp_async16(&xs[r * Tile::XLD + c], ok ? x + (size_t)r * K + k0 + c : x, ok);
      }
    }
#pragma unroll
    for (int i = 0; i < WV / SK_THREADS; ++i) {
      const int v = tid + i * SK_THREADS;
      if constexpr (TW) {  // row n0 + r of w, 8 consecutive k
        const int r = v / (BK / 8), c = (v % (BK / 8)) * 8;
        const bool ok = n0 + r < N && k0 + c < K;
        cp_async16(&wt[r * Tile::WLD + c], ok ? w + (size_t)(n0 + r) * K + k0 + c : w, ok);
      } else {             // row k0 + r of w, 8 consecutive n
        const int r = v / (BN / 8), c = (v % (BN / 8)) * 8;
        const bool ok = k0 + r < K && n0 + c < N;
        cp_async16(&wt[r * Tile::WLD + c], ok ? w + (size_t)(k0 + r) * N + n0 + c : w, ok);
      }
    }
  };

  float acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

#pragma unroll
  for (int t = 0; t < STAGES - 1; ++t) {  // fill the ring
    if (t < nsteps) load_stage(t);
    cp_async_commit();
  }
  for (int t = 0; t < nsteps; ++t) {
    cp_async_wait<STAGES - 2>();  // stage t has landed (this thread's part)
    __syncthreads();              // everyone's part; slot t - 1 is free
    if (t + STAGES - 1 < nsteps) load_stage(t + STAGES - 1);
    cp_async_commit();
    const __nv_bfloat16* xs = sk_smem + (t % STAGES) * Tile::STAGE;
    const __nv_bfloat16* wt = xs + Tile::X_ELEMS;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t a[MT][4];
#pragma unroll
      for (int i = 0; i < MT; ++i)
        ldmatrix_x4(a[i], &xs[(i * 16 + lane % 16) * Tile::XLD + kk + (lane / 16) * 8]);
#pragma unroll
      for (int j = 0; j < NT; j += 2) {
        // matrices: k 0-7 / 8-15 of n8 tile j, then of tile j + 1
        const int q = lane / 8;
        uint32_t b[4];
        if constexpr (TW)  // [n][k] rows: each 8 x 8 matrix already n-major
          ldmatrix_x4(b, &wt[(warp * WN + (j + (q >> 1)) * 8 + lane % 8) * Tile::WLD + kk +
                             (q & 1) * 8]);
        else
          ldmatrix_x4_trans(b, &wt[(kk + lane % 8 + (q & 1) * 8) * Tile::WLD + warp * WN +
                                   (j + (q >> 1)) * 8]);
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          mma_16816(acc[i][j], a[i], b[0], b[1]);
          mma_16816(acc[i][j + 1], a[i], b[2], b[3]);
        }
      }
    }
  }
  cp_async_wait<0>();

  // accumulator (i, j, e): row 16 i + lane / 4 + 8 (e / 2), column
  // warp * WN + 8 j + 2 (lane % 4) + e % 2 of the strip
  const int r_in = lane / 4, c_in = warp * WN + (lane % 4) * 2;
  if (splits == 1) {
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = i * 16 + r_in + h * 8, col = n0 + c_in + j * 8;
          if (row < M && col < N)
            store_pair(&out[(size_t)row * N + col],
                       epilogue(acc[i][j][2 * h], scale, bias, col, act),
                       epilogue(acc[i][j][2 * h + 1], scale, bias, col + 1, act));
        }
    return;
  }

  float* part = ws + ((size_t)strip * splits + split) * M * BN;
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = i * 16 + r_in + h * 8;
        if (row < M)
          *reinterpret_cast<float2*>(&part[row * BN + c_in + j * 8]) =
              make_float2(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
      }
  __threadfence();  // the partial is visible device-wide before the count
  __syncthreads();
  if (tid == 0) sk_last = atomicAdd(&counters[strip], 1) == splits - 1;
  __syncthreads();
  if (!sk_last) return;
  __threadfence();
  // four columns a thread, the splits' loads 8 at a time in flight, the
  // sums in split order
  const float4* parts = reinterpret_cast<const float4*>(ws + (size_t)strip * splits * M * BN);
  const int quads = M * BN / 4;
  for (int e = tid; e < quads; e += SK_THREADS) {
    float4 s = __ldcg(&parts[e]);
    for (int p0 = 1; p0 < splits; p0 += 8) {
      float4 v[8];
#pragma unroll
      for (int q = 0; q < 8; ++q)
        if (p0 + q < splits) v[q] = __ldcg(&parts[(size_t)(p0 + q) * quads + e]);
#pragma unroll
      for (int q = 0; q < 8; ++q)
        if (p0 + q < splits) {
          s.x += v[q].x;
          s.y += v[q].y;
          s.z += v[q].z;
          s.w += v[q].w;
        }
    }
    const int row = e * 4 / BN, col = n0 + e * 4 % BN;
    if (col < N) {  // N % 8 == 0: all four columns are in
      OutT* o = &out[(size_t)row * N + col];
      store_pair(o, epilogue(s.x, scale, bias, col, act), epilogue(s.y, scale, bias, col + 1, act));
      store_pair(o + 2, epilogue(s.z, scale, bias, col + 2, act),
                 epilogue(s.w, scale, bias, col + 3, act));
    }
  }
  if (tid == 0) counters[strip] = 0;
}

// ---------------------------------------------------------------------------
// bf16 NN, NT and grouped at M > 64: a TMA ring feeding wgmma (prefill)
// ---------------------------------------------------------------------------

enum Form { FORM_NN = 0, FORM_NT = 1, FORM_GROUPED = 2 };

constexpr int WG_BM = 128, WG_BN = 128, WG_BK = 64, WG_STAGES = 6;
constexpr int WG_THREADS = 384;                 // producer + 2 consumer warpgroups
constexpr int WG_A_BYTES = WG_BM * WG_BK * 2;   // one [128 x 64] box of x: 16 KB
// w per stage: two [64 k x 64 n] boxes (NN, grouped) or one [128 n x 64 k]
// box (NT), 16 KB either way
constexpr int WG_B_BOX = WG_BK * 64 * 2;        // 8 KB
constexpr int WG_STAGE_BYTES = WG_A_BYTES + 2 * WG_B_BOX;   // 32 KB
// 6 slots (192 KB: the loads in flight, not the products, set the pace),
// + room to align to 1 KB
constexpr int WG_SMEM = WG_STAGES * WG_STAGE_BYTES + 1024;

// Block (blockIdx.x, blockIdx.y) = output tile [128 m, 128 n]; M tiles
// run fastest; blockIdx.z is the group of a grouped launch (else 0).
// Warpgroup 0 is the producer: it hands its registers to the consumers
// (setmaxnreg), and one thread issues the TMA loads of step kt into slot
// kt % 6 once the consumers have given the slot back. Warpgroups 1 and 2
// multiply rows [0, 64) and [64, 128) of the tile. Shared memory per slot:
// x [128 rows][128 B], then w, each row 128-byte swizzled by TMA: NN and
// grouped two [64 k][128 B] boxes (n 0-63, then 64-127), NT one [128 n][128
// B] box, K-major like x. A grouped launch's maps are 3-D ({K, M, G} and
// {N, K, G}) and each load names the group, so rows past M inside a group
// arrive as zeros and never as the next group's rows.
//
// The sum over K runs in the splitk mainloop's order: K cut into `splits`
// ranges of per = ceil(ceil(K / 32) / splits) 32-deep steps (even, so
// whole stages), each range summed from zero in k16 steps (r), the ranges
// added in order between stages (t), outside the wgmma pipeline. The
// tensor cores round a k16 step alike under mma.sync and wgmma, so a row
// comes out bit-equal whichever mainloop its M picks.
template <int FORM, typename OutT>
__global__ void __launch_bounds__(WG_THREADS, 1)
gemm_bf16_wgmma(const __grid_constant__ CUtensorMap tmap_x,
                const __grid_constant__ CUtensorMap tmap_w, const float* __restrict__ scale,
                const float* __restrict__ bias, OutT* __restrict__ out, int M, int N, int K,
                int act, int splits) {
  constexpr bool KMAJOR_B = FORM == FORM_NT;
  extern __shared__ uint8_t wg_smem_raw[];
  __shared__ __align__(8) uint64_t full[WG_STAGES];
  __shared__ __align__(8) uint64_t empty[WG_STAGES];
  // the swizzle pattern repeats every 1024 bytes: tiles start on one
  uint8_t* smem = wg_smem_raw + ((1024 - (smem_u32(wg_smem_raw) & 1023)) & 1023);
  const int tid = threadIdx.x, wg = tid / 128;
  const int n0 = blockIdx.y * WG_BN, grp = blockIdx.z;
  // The last M tile, where M >= 128, is moved back inside the matrix and
  // stores only the rows from m_lo on: a box that reaches past M (into
  // TMA's zero fill) ran slower than a whole one, and a row's sum is the
  // same wherever its tile starts.
  const int m_lo = blockIdx.x * WG_BM;
  const int m0 = m_lo + WG_BM > M && M >= WG_BM ? M - WG_BM : m_lo;
  const int ksteps = (K + WG_BK - 1) / WG_BK;
  if constexpr (FORM == FORM_GROUPED) {  // the epilogue's operands of group grp
    out += (size_t)grp * M * N;
    if (scale != nullptr) scale += (size_t)grp * N;
    if (bias != nullptr) bias += (size_t)grp * N;
  }

  if (tid == 0) {
    for (int s = 0; s < WG_STAGES; ++s) {
      mbar_init(&full[s], 1);   // the producer's arrive, plus the bytes
      mbar_init(&empty[s], 2);  // one arrive per consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (tid == 0) {
      for (int kt = 0; kt < ksteps; ++kt) {
        const int s = kt % WG_STAGES;
        if (kt >= WG_STAGES) mbar_wait(&empty[s], (kt / WG_STAGES - 1) & 1);
        uint8_t* a = smem + s * WG_STAGE_BYTES;
        mbar_expect_tx(&full[s], WG_STAGE_BYTES);
        if constexpr (FORM == FORM_GROUPED) {
          tma_load_3d(a, &tmap_x, &full[s], kt * WG_BK, m0, grp);
          tma_load_3d(a + WG_A_BYTES, &tmap_w, &full[s], n0, kt * WG_BK, grp);
          tma_load_3d(a + WG_A_BYTES + WG_B_BOX, &tmap_w, &full[s], n0 + 64, kt * WG_BK, grp);
        } else {
          tma_load_2d(a, &tmap_x, &full[s], kt * WG_BK, m0);
          if constexpr (KMAJOR_B) {
            tma_load_2d(a + WG_A_BYTES, &tmap_w, &full[s], kt * WG_BK, n0);
          } else {
            tma_load_2d(a + WG_A_BYTES, &tmap_w, &full[s], n0, kt * WG_BK);
            tma_load_2d(a + WG_A_BYTES + WG_B_BOX, &tmap_w, &full[s], n0 + 64, kt * WG_BK);
          }
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int c = wg - 1;  // this warpgroup's 64-row half of the tile
    // 64-deep steps per split range: whole, as the launcher makes sure
    // (an even number of 32-deep steps), so a range starts with a stage
    const int range = splits == 1 ? ksteps
                                  : (((K + SK_BK - 1) / SK_BK + splits - 1) / splits) / 2;
    float t[64], r[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) t[i] = 0.f;
    for (int k0 = 0; k0 < ksteps; k0 += range) {
      // one range: a pipelined run of stages into r, the first overwriting it
      for (int kt = k0; kt < min(k0 + range, ksteps); ++kt) {
        const int s = kt % WG_STAGES;
        mbar_wait(&full[s], (kt / WG_STAGES) & 1);
        const uint8_t* a = smem + s * WG_STAGE_BYTES + c * (64 * 128);
        const uint8_t* b = smem + s * WG_STAGE_BYTES + WG_A_BYTES;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < WG_BK / 16; ++kk)
          // A (and NT's B): k16 is 32 bytes along the swizzled row, 8-row
          // groups 1024 B apart; MN-major B: k16 is two 8-row groups of
          // 1024 B, columns 64-127 one box (8 KB) on
          wgmma_m64n128k16<KMAJOR_B ? 0 : 1>(
              r, sw128_desc(a + kk * 32, 16, 1024),
              KMAJOR_B ? sw128_desc(b + kk * 32, 16, 1024)
                       : sw128_desc(b + kk * 2048, WG_B_BOX, 1024),
              kk > 0 || kt > k0);
        wgmma_commit();
        wgmma_wait<1>();  // the products of step kt - 1 are done: give its slot back
        if (kt > 0 && tid % 128 == 0) mbar_arrive(&empty[(kt - 1) % WG_STAGES]);
      }
      wgmma_wait<0>();  // t += r (t = r for the first range)
#pragma unroll
      for (int i = 0; i < 64; ++i) t[i] = k0 == 0 ? r[i] : t[i] + r[i];
    }

    // t[4 i + 2 h + e]: row 16 warp + lane / 4 + 8 h, column 8 i + 2 (lane % 4) + e
    const int u = tid % 128;
    const int row0 = m0 + c * 64 + (u / 32) * 16 + (u % 32) / 4;
    const int col0 = n0 + (u % 4) * 2;
#pragma unroll
    for (int i = 0; i < WG_BN / 8; ++i) {
      const int col = col0 + i * 8;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = row0 + h * 8;
        if (row >= m_lo && row < M && col < N)
          store_pair(&out[(size_t)row * N + col],
                     epilogue(t[4 * i + 2 * h], scale, bias, col, act),
                     epilogue(t[4 * i + 2 * h + 1], scale, bias, col + 1, act));
      }
    }
  }
}

template <int MT, int BN, bool TW, typename OutT>
cudaError_t launch_splitk(const __nv_bfloat16* x, const __nv_bfloat16* w, const float* scale,
                          const float* bias, OutT* out, float* ws, int* counters, int M, int N,
                          int K, int act, int splits, cudaStream_t stream) {
  auto kernel = gemm_bf16_splitk<MT, BN, TW, OutT>;
  constexpr int smem = SplitkTile<MT, BN, TW>::SMEM;
  static uint64_t done = 0;
  cudaError_t e = allow_smem(kernel, smem, done);
  if (e != cudaSuccess) return e;
  dim3 grid((N + BN - 1) / BN, splits);
  kernel<<<grid, SK_THREADS, smem, stream>>>(x, w, scale, bias, out, ws, counters, M, N, K, act);
  return cudaGetLastError();
}

template <int BN, bool TW, typename OutT>
cudaError_t splitk_rows(const __nv_bfloat16* x, const __nv_bfloat16* w, const float* scale,
                        const float* bias, OutT* out, float* ws, int* counters, int M, int N,
                        int K, int act, int splits, cudaStream_t s) {
  switch ((M + 15) / 16) {
    case 1:
      return launch_splitk<1, BN, TW>(x, w, scale, bias, out, ws, counters, M, N, K, act, splits,
                                      s);
    case 2:
      return launch_splitk<2, BN, TW>(x, w, scale, bias, out, ws, counters, M, N, K, act, splits,
                                      s);
    case 3:
      return launch_splitk<3, BN, TW>(x, w, scale, bias, out, ws, counters, M, N, K, act, splits,
                                      s);
    default:
      return launch_splitk<4, BN, TW>(x, w, scale, bias, out, ws, counters, M, N, K, act, splits,
                                      s);
  }
}

template <int FORM, typename OutT>
cudaError_t launch_wgmma(const void* x, const void* w, const float* scale, const float* bias,
                         OutT* out, int G, int M, int N, int K, int act, int splits,
                         cudaStream_t stream) {
  CUtensorMap tmap_x, tmap_w;
  const int depth = FORM == FORM_GROUPED ? G : 0;
  const bool ok = make_tmap(&tmap_x, x, depth, M, K, WG_BM, WG_BK) &&
                  (FORM == FORM_NT ? make_tmap(&tmap_w, w, 0, N, K, WG_BN, WG_BK)
                                   : make_tmap(&tmap_w, w, depth, K, N, WG_BK, 64));
  if (!ok) return cudaErrorInvalidValue;
  static uint64_t done = 0;
  cudaError_t e = allow_smem(gemm_bf16_wgmma<FORM, OutT>, WG_SMEM, done);
  if (e != cudaSuccess) return e;
  dim3 grid((M + WG_BM - 1) / WG_BM, (N + WG_BN - 1) / WG_BN, G);
  gemm_bf16_wgmma<FORM, OutT><<<grid, WG_THREADS, WG_SMEM, stream>>>(
      tmap_x, tmap_w, scale, bias, out, M, N, K, act, splits);
  return cudaGetLastError();
}

template <bool TW, typename OutT>
void dispatch(const void* x, const void* w, const float* scale, const float* bias,
              void* out, int G, int M, int N, int K, int in_dtype, int act,
              cudaStream_t stream) {
  OutT* o = static_cast<OutT*>(out);
  if (in_dtype == IN_BF16) {
    const auto* xb = static_cast<const __nv_bfloat16*>(x);
    const auto* wb = static_cast<const __nv_bfloat16*>(w);
    if (M <= 16) {
      dim3 grid((N + BN - 1) / BN, (M + 15) / 16, G);
      gemm_bf16_wmma<16, TW, OutT><<<grid, THREADS, 0, stream>>>(xb, wb, scale, bias, o, M, N, K, act);
    } else {
      dim3 grid((N + BN - 1) / BN, (M + 63) / 64, G);
      gemm_bf16_wmma<64, TW, OutT><<<grid, THREADS, 0, stream>>>(xb, wb, scale, bias, o, M, N, K, act);
    }
    return;
  }
  dim3 grid((N + S_BN - 1) / S_BN, (M + S_BM - 1) / S_BM, G);
  if (in_dtype == IN_F32) {
    gemm_simt<TW, float, float, OutT><<<grid, S_THREADS, 0, stream>>>(
        static_cast<const float*>(x), static_cast<const float*>(w), scale, bias, o, M, N, K, act);
  } else {
    gemm_simt<TW, int8_t, int, OutT><<<grid, S_THREADS, 0, stream>>>(
        static_cast<const int8_t*>(x), static_cast<const int8_t*>(w), scale, bias, o, M, N, K, act);
  }
}

// The wmma and simt mainloops, every form.
template <bool TW>
int launch(const void* x, const void* w, const float* scale, const float* bias, void* out,
           int G, int M, int N, int K, int in_dtype, int out_dtype, int act, void* stream) {
  // grid: x over N tiles, y over M tiles (64 rows each where M > 16), z over
  // groups; y and z stop at 65535
  if (G <= 0 || G > 65535 || M <= 0 || N <= 0 || K <= 0 || (M + 63) / 64 > 65535 ||
      in_dtype < IN_F32 || in_dtype > IN_INT8 || out_dtype < OUT_F32 ||
      out_dtype > OUT_BF16 || act < ACT_NONE || act > ACT_RELU2)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (out_dtype == OUT_F32)
    dispatch<TW, float>(x, w, scale, bias, out, G, M, N, K, in_dtype, act, s);
  else
    dispatch<TW, __nv_bfloat16>(x, w, scale, bias, out, G, M, N, K, in_dtype, act, s);
  return static_cast<int>(cudaGetLastError());
}

template <int FORM, typename OutT>
cudaError_t launch_hopper(const void* x, const void* w, const float* scale, const float* bias,
                          void* out, int G, int M, int N, int K, int act, int mainloop,
                          int splits, int block_n, float* ws, int* counters, cudaStream_t s) {
  OutT* o = static_cast<OutT*>(out);
  if (mainloop == ML_WGMMA)
    return launch_wgmma<FORM, OutT>(x, w, scale, bias, o, G, M, N, K, act, splits, s);
  if constexpr (FORM == FORM_GROUPED) {
    return cudaErrorInvalidValue;  // no grouped splitk: the launcher refuses it first
  } else {
    constexpr bool TW = FORM == FORM_NT;
    const auto* xb = static_cast<const __nv_bfloat16*>(x);
    const auto* wb = static_cast<const __nv_bfloat16*>(w);
    if (block_n == 64)
      return splitk_rows<64, TW>(xb, wb, scale, bias, o, ws, counters, M, N, K, act, splits, s);
    return splitk_rows<128, TW>(xb, wb, scale, bias, o, ws, counters, M, N, K, act, splits, s);
  }
}

// Every form's launch by the plan it is given (systolic_gemm.py::gemm_plan),
// refused when the dtype, shape or alignment does not allow it: wmma and
// simt through launch<TW>; splitk (NN and NT) and wgmma (every form) on
// bf16 with K and N multiples of 8 and x and w 16-byte aligned (TMA and
// cp.async need both), K cut into `splits` non-empty ranges (for wgmma
// with splits > 1, each an even number of 32-deep steps).
template <int FORM>
int launch_planned(const void* x, const void* w, const float* scale, const float* bias,
                   void* out, int G, int M, int N, int K, int in_dtype, int out_dtype, int act,
                   int mainloop, int splits, int block_n, float* ws, int* counters,
                   void* stream) {
  constexpr bool TW = FORM == FORM_NT;
  const bool bf16 = in_dtype == IN_BF16;
  if (mainloop == ML_WMMA || mainloop == ML_SIMT) {
    if (bf16 != (mainloop == ML_WMMA)) return static_cast<int>(cudaErrorInvalidValue);
    return launch<TW>(x, w, scale, bias, out, G, M, N, K, in_dtype, out_dtype, act, stream);
  }
  auto aligned = [](const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; };
  if ((mainloop != ML_SPLITK && mainloop != ML_WGMMA) || !bf16 || G <= 0 || G > 65535 ||
      M <= 0 || N <= 0 || K <= 0 || K % 8 != 0 || N % 8 != 0 || !aligned(x) || !aligned(w) ||
      out_dtype < OUT_F32 || out_dtype > OUT_BF16 || act < ACT_NONE || act > ACT_RELU2)
    return static_cast<int>(cudaErrorInvalidValue);
  const int steps = (K + SK_BK - 1) / SK_BK;  // both sum K in these ranges
  const int per = splits > 0 ? (steps + splits - 1) / splits : 0;
  if (splits <= 0 || splits > 65535 || (splits - 1) * per >= steps)
    return static_cast<int>(cudaErrorInvalidValue);
  if (mainloop == ML_SPLITK) {
    constexpr int stage_steps = SplitkTile<1, 64, TW>::BK / SK_BK;  // 32-deep steps a stage
    if (FORM == FORM_GROUPED || G != 1 || M > 64 || (block_n != 64 && block_n != 128) ||
        (splits > 1 && (ws == nullptr || counters == nullptr || per % stage_steps != 0)))
      return static_cast<int>(cudaErrorInvalidValue);
  } else if ((FORM != FORM_GROUPED && G != 1) || block_n != WG_BN ||
             (N + WG_BN - 1) / WG_BN > 65535 ||
             (splits > 1 && per % 2 != 0)) {  // wgmma: ranges of whole 64-deep stages
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e =
      out_dtype == OUT_F32
          ? launch_hopper<FORM, float>(x, w, scale, bias, out, G, M, N, K, act, mainloop,
                                       splits, block_n, ws, counters, s)
          : launch_hopper<FORM, __nv_bfloat16>(x, w, scale, bias, out, G, M, N, K, act,
                                               mainloop, splits, block_n, ws, counters, s);
  return static_cast<int>(e);
}

}  // namespace

// mainloop: 0 wmma, 1 splitk, 2 wgmma, 3 simt (systolic_gemm.py::gemm_plan).
// splitk and wgmma both sum K in `splits` ranges (wgmma in one block, on
// 128 x block_n = 128 tiles). splitk: strips of `block_n` (64 or 128)
// columns, ws at least ceil(N / block_n) * block_n * splits * M floats and
// counters ceil(N / block_n) ints, zero before the first launch (each
// launch leaves them zero); both unused (may be null) when splits == 1.

// w [K, N]
extern "C" int systolic_gemm_launch(const void* x, const void* w,
                                    const float* scale, const float* bias,
                                    void* out, int M, int N, int K,
                                    int in_dtype, int out_dtype, int act,
                                    int mainloop, int splits, int block_n,
                                    float* ws, int* counters, void* stream) {
  return launch_planned<FORM_NN>(x, w, scale, bias, out, 1, M, N, K, in_dtype, out_dtype, act,
                                 mainloop, splits, block_n, ws, counters, stream);
}

// w [N, K], read in that layout
extern "C" int systolic_gemm_nt_launch(const void* x, const void* w,
                                       const float* scale, const float* bias,
                                       void* out, int M, int N, int K,
                                       int in_dtype, int out_dtype, int act,
                                       int mainloop, int splits, int block_n,
                                       float* ws, int* counters, void* stream) {
  return launch_planned<FORM_NT>(x, w, scale, bias, out, 1, M, N, K, in_dtype, out_dtype, act,
                                 mainloop, splits, block_n, ws, counters, stream);
}

// x [G, M, K], w [G, K, N], scale and bias [G, N] (or null), out [G, M, N];
// wmma, simt or wgmma (no splitk, so no workspace)
extern "C" int grouped_systolic_gemm_launch(const void* x, const void* w,
                                            const float* scale, const float* bias,
                                            void* out, int G, int M, int N, int K,
                                            int in_dtype, int out_dtype, int act,
                                            int mainloop, int splits, int block_n,
                                            void* stream) {
  return launch_planned<FORM_GROUPED>(x, w, scale, bias, out, G, M, N, K, in_dtype, out_dtype,
                                      act, mainloop, splits, block_n, nullptr, nullptr, stream);
}
