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
// is blockIdx.z, each block moves its pointers to its group's matrices
// and then runs the NN kernel unchanged, so a group's rows, ragged edges
// and epilogue are exactly a plain launch's. A group of zero rows with a
// zero bias (an expert no token reached) comes out exactly 0.
//
// NT's w tile is [BN, BK] cut from row-major [N, K], so it is contiguous
// along K: exactly a column-major K x N operand, which the tensor cores
// take as a col_major matrix_b fragment. No transpose copy
// exists in device memory, which is the point of the TPU kernel. What it
// computes is the same; how is not carried over block by block. The TPU
// grid walks K as its minor sequential axis and carries the accumulator in
// VMEM scratch from one grid step to the next. Here each thread block owns
// one output tile, walks K in a loop of its own, keeps the accumulator in
// registers (wmma fragments) and runs the epilogue once at the end, so
// [M, N] is written exactly once.
//
//   * bf16 x bf16 -> f32: tensor cores through nvcuda::wmma (mma.sync,
//     16x16x16). Tile BM x 64 (BM = 16 for decode-sized M, else 64), K in
//     steps of 32 staged through shared memory; the next K step's global
//     loads are issued into registers before the current step's products,
//     so loads and tensor-core work overlap (two-stage pipeline).
//   * f32 x f32 -> f32 and int8 x int8 -> int32: plain FMA / integer
//     multiply-add on the CUDA cores, 64 x 64 tiles, 4 x 4 outputs per
//     thread. f32 stays full f32 (TF32 would change the numbers); int32
//     accumulation is exact, then the epilogue runs in f32 as on the TPU.
//   * Ragged M/N/K edges are masked in the kernel (zero-filled loads,
//     guarded stores), so the wrapper pads nothing.
//
// What bounds it on the H100: at decode (M = 4 lanes) every weight byte is
// read once per step and the GEMM is bound by memory bytes (3.35 TB/s); at
// prefill (M = 1024) the large projections are bound by tensor-core
// operations (989 TFLOP/s bf16 dense). This simple kernel is far from both:
// mma.sync through wmma reaches only part of Hopper's tensor-core rate,
// each block streams its weight strip with ordinary loads, and at decode a
// narrow N leaves SMs idle. Warpgroup MMA (wgmma) fed by TMA through an
// mbarrier ring, persistent blocks and split-K for skinny M are a later
// change's work.
//
// The grouped form at dbrx-132b's served shapes (16 experts, d 6144,
// d_ff 10752): at decode each expert holds M = 1 row, so a launch reads
// 16 x 6144 x 10752 bf16 weights (2.11 GB) for 2 GFLOP and is bound by
// bytes (0.631 ms at 3.35 TB/s); the 16-row tile wastes 15/16 of each
// mma, which costs nothing against that bound. At a 1024-token prefill
// M = 320 rows per expert and the launch is bound by operations
// (6.76e11 FLOP, 0.684 ms at 989 TFLOP/s) about as much as by bytes
// (0.683 ms). The same limits as the NN kernel keep it from both.
//
// C interface (bound with ctypes): systolic_gemm_launch (NN),
// systolic_gemm_nt_launch (NT) and grouped_systolic_gemm_launch return
// cudaGetLastError() after the launch, or cudaErrorInvalidValue for
// arguments the kernels do not take (G > 65535, the grid's z limit); the
// caller raises when it is not 0.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

using namespace nvcuda;

namespace {

enum Act { ACT_NONE = 0, ACT_RELU = 1, ACT_GELU = 2, ACT_SILU = 3, ACT_RELU2 = 4 };
enum InType { IN_F32 = 0, IN_BF16 = 1, IN_INT8 = 2 };
enum OutType { OUT_F32 = 0, OUT_BF16 = 1 };

// The TPU kernel's _epilogue_math: dequant scale, bias, activation, in f32.
// gelu is the tanh approximation (jax.nn.gelu's default).
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
      acc = acc * (1.f / (1.f + expf(-acc)));
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

}  // namespace

// w [K, N]
extern "C" int systolic_gemm_launch(const void* x, const void* w,
                                    const float* scale, const float* bias,
                                    void* out, int M, int N, int K,
                                    int in_dtype, int out_dtype, int act,
                                    void* stream) {
  return launch<false>(x, w, scale, bias, out, 1, M, N, K, in_dtype, out_dtype, act, stream);
}

// w [N, K], read in that layout
extern "C" int systolic_gemm_nt_launch(const void* x, const void* w,
                                       const float* scale, const float* bias,
                                       void* out, int M, int N, int K,
                                       int in_dtype, int out_dtype, int act,
                                       void* stream) {
  return launch<true>(x, w, scale, bias, out, 1, M, N, K, in_dtype, out_dtype, act, stream);
}

// x [G, M, K], w [G, K, N], scale and bias [G, N] (or null), out [G, M, N]
extern "C" int grouped_systolic_gemm_launch(const void* x, const void* w,
                                            const float* scale, const float* bias,
                                            void* out, int G, int M, int N, int K,
                                            int in_dtype, int out_dtype, int act,
                                            void* stream) {
  return launch<false>(x, w, scale, bias, out, G, M, N, K, in_dtype, out_dtype, act, stream);
}
