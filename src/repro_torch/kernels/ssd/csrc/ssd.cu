// Mamba-2 SSD chunk scan for Hopper (sm_90a). Per (batch b, head h), over
// chunks of C tokens, with an f32 state h [P, N] carried across chunks:
//   cum    = cumsum(dt * A)                                     (f32)
//   M[t,s] = (C_t . B_s) * exp(cum_t - cum_s) * dt_s, s <= t    (f32, then
//            rounded to x's dtype)
//   y_t    = (M @ x)_t + exp(cum_t) * (C_t . h_prev^T) + D x_t  (f32, one cast)
//   h      = exp(cum_end) h_prev + sum_s exp(cum_end - cum_s) dt_s x_s^T B_s
// x [b, S, H, P], dt [b, S, H] f32, A and D [H] f32, B and C [b, S, G, N]
// with group g = h / (H / G) read in place (never repeated to H heads).
// S is a chunk multiple (the wrapper pads with dt = 0, which leaves the
// state unchanged). Outputs: y [b, S, H, P] and the final state
// h_final [b, H, P, N], both in x's dtype.
//
// Replaces the TPU kernel repro/kernels/ssd/ssd.py::ssd_pallas
// (_ssd_kernel). What it computes is the same, rounding where it rounds;
// how is not carried over block by block. The TPU grid (b, H, chunks)
// walks the chunks as its minor sequential axis and carries the f32 state
// in VMEM scratch from one grid step to the next. Here one thread block
// owns one (b, h), loops over the chunks itself with the state in shared
// memory, and also writes that state out at the end: the JAX wrapper
// recomputes the final state with the jnp reference instead, which would
// put a plain version on the card's main path.
//
// One chunk in shared memory: x [C, P] and B [C, N] whole, the state, and
// per row block of 64 t (TB): its C rows, its M rows (in x's dtype, as the
// reference rounds M) and its inter-chunk output. At mamba2's C = 256,
// N = 128, P = 64 in bf16 that is 211,200 bytes of the 232,448 a block may
// have; the f32 score tile alone (256 KB) would not fit, so it never
// exists whole. In f32 the same chunk needs 358,656 bytes, so an f32
// launch runs each chunk as sub-chunks (f32_chunk: 128 at mamba2's tiles,
// 221,952 bytes), which in f32 is the same function. Per row block:
//   1. y_inter = exp(cum_t) * (C h_prev^T): f32 on the CUDA cores (FMA);
//   2. M = C B^T masked, scaled: bf16 on the tensor cores (mma.sync
//      m16n8k16, f32 accumulate), f32 on FMA. The mask is applied before
//      exp: above the diagonal cum_t - cum_s is large and positive (about
//      +180 over a 256-token chunk at dt ~ 0.7, A = -1) and exp overflows;
//      exp(seg) * 0 would be NaN. Columns past the row block's diagonal
//      are skipped;
//   3. y = (M @ x + y_inter) + D x: mma.sync (bf16) / FMA (f32), written
//      straight from the accumulators.
// Every row block reads h_prev before the state update overwrites it (a
// block-wide barrier sits between the last row block and the update).
// The update is f32 FMA, as the Pallas kernel's f32 dot.
//
// What bounds it on the H100: operations. At mamba2's [4, 2048] prefill
// (32 heads, P = 64, N = 128, C = 256) the two f32 products (C h^T and
// x^T B, 8.6 GFLOP) at 67 TFLOP/s take 0.128 ms, against 0.013 ms for the
// causal half of the two bf16 products on the tensor cores and 0.022 ms
// for the 74 MB of inputs and outputs. One block per (b, h) is 128 blocks
// on 132 SMs at batch 4, each walking its S / C chunks in sequence: at
// S = 256 one chunk, at S = 2048 eight, with no overlap between the loads
// of one chunk and the products of the last. Splitting P across blocks,
// a cp.async/TMA pipeline over chunks and wgmma are a later change's work.
//
// C interface (bound with ctypes): ssd_launch refuses a shape it does not
// take, or whose tiles need more dynamic shared memory than a block may
// have, with cudaErrorInvalidValue, and otherwise returns
// cudaGetLastError() after the launch; the caller raises when it is not 0.
// ssd_run_chunk says which chunk a launch runs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;       // 8 warps
constexpr int TB = 64;             // rows of a row block, 16 per warp row
constexpr int MAX_SMEM = 232448;   // dynamic shared memory a block may have
enum DType { DT_F32 = 0, DT_BF16 = 1 };

__host__ __device__ __forceinline__ int round_up(int v, int m) { return (v + m - 1) / m * m; }

// Byte offsets of the shared-memory tiles. Each row of a tile in x's
// dtype carries one 16-byte vector of padding (fragment reads without
// bank conflicts); the state's rows are N + 1 floats (odd: conflict-free
// column reads).
struct Layout {
  int CP, NP, PP;                     // chunk, d_state, head_dim rounded up to 16
  int ldx, ldb, ldm, ldy, ldh;        // row strides in elements
  int xs, bs, cs, ms, ys, hs, cum, dtv, wv, total;
};

__host__ __device__ inline Layout make_layout(int chunk, int P, int N, int esize) {
  Layout l;
  l.CP = round_up(chunk, 16);
  l.NP = round_up(N, 16);
  l.PP = round_up(P, 16);
  const int pad = 16 / esize;
  l.ldx = l.PP + pad;
  l.ldb = l.NP + pad;
  l.ldm = l.CP + pad;
  l.ldy = l.PP + 4;
  l.ldh = l.NP + 1;
  int off = 0;
  l.xs = off;  off += l.CP * l.ldx * esize;   // x chunk [CP][PP]
  l.bs = off;  off += l.CP * l.ldb * esize;   // B chunk [CP][NP]
  l.cs = off;  off += TB * l.ldb * esize;     // C rows of a row block [TB][NP]
  l.ms = off;  off += TB * l.ldm * esize;     // M rows of a row block [TB][CP]
  l.ys = off;  off += TB * l.ldy * 4;         // y_inter of a row block [TB][PP] f32
  l.hs = off;  off += l.PP * l.ldh * 4;       // state [PP][NP] f32
  l.cum = off; off += l.CP * 4;
  l.dtv = off; off += l.CP * 4;
  l.wv = off;  off += l.CP * 4;               // exp(cum_end - cum_s) dt_s
  l.total = off;
  return l;
}

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T cvt(float v);
template <> __device__ __forceinline__ float cvt<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 cvt<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as torch and XLA
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// c += a (16x16, row) * b (16x8, col), bf16 in, f32 accumulate.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8x8 bf16 matrices from shared memory, transposed: lane L gives the
// address of row L % 8 of matrix L / 8.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (lo) in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t lds32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// rows x cols tile of a strided global matrix into shared memory, zero
// outside [rows_valid, cols_valid); 16-byte vectors where `vec` allows.
template <typename T>
__device__ __forceinline__ void load_tile(T* dst, int ld, const T* src, size_t stride,
                                          int rows_valid, int rows, int cols_valid, int cols,
                                          bool vec) {
  constexpr int V = 16 / sizeof(T);
  const int cv = cols / V;
  for (int e = threadIdx.x; e < rows * cv; e += THREADS) {
    const int r = e / cv, c = (e % cv) * V;
    T* d = dst + r * ld + c;
    const T* s = src + r * stride + c;
    if (vec && r < rows_valid && c + V <= cols_valid) {
      *reinterpret_cast<uint4*>(d) = *reinterpret_cast<const uint4*>(s);
    } else {
#pragma unroll
      for (int j = 0; j < V; ++j)
        d[j] = (r < rows_valid && c + j < cols_valid) ? s[j] : cvt<T>(0.f);
    }
  }
}

// out(m, n) = sum_k a(m, k) b(k, n) for m < Mr, n < Nr in f32 FMA; each
// thread owns TM rows x TN columns (columns strided by Nr / TN, so that
// neighbouring threads read neighbouring columns); epi(m, n, acc) stores.
template <int TM, int TN, typename FA, typename FB, typename FE>
__device__ __forceinline__ void fma_tiles(int Mr, int Nr, int Kr, FA a, FB b, FE epi) {
  const int ncols = Nr / TN;
  const int tiles = (Mr / TM) * ncols;
  for (int tile = threadIdx.x; tile < tiles; tile += THREADS) {
    const int m0 = (tile / ncols) * TM, nc = tile % ncols;
    float acc[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
    for (int k = 0; k < Kr; ++k) {
      float av[TM], bv[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) av[i] = a(m0 + i, k);
#pragma unroll
      for (int j = 0; j < TN; ++j) bv[j] = b(k, nc + j * ncols);
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) epi(m0 + i, nc + j * ncols, acc[i][j]);
  }
}

// cum[t] = sum_{u <= t} dt[u] * a over t < CP, by one warp: a sequential
// sum per lane over consecutive entries, then a scan of the lane totals.
__device__ __forceinline__ void chunk_cumsum(float* cum, const float* dtv, float a, int CP,
                                             int lane) {
  const int per = (CP + 31) / 32;
  const int beg = min(CP, lane * per), end = min(CP, beg + per);
  float run = 0.f;
  for (int t = beg; t < end; ++t) {
    run += dtv[t] * a;
    cum[t] = run;
  }
  float incl = run;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float v = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += v;
  }
  const float offset = incl - run;
  for (int t = beg; t < end; ++t) cum[t] += offset;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
ssd_fwd(const T* __restrict__ x, const float* __restrict__ dt, const float* __restrict__ A,
        const T* __restrict__ Bm, const T* __restrict__ Cm, const float* __restrict__ D,
        T* __restrict__ y, T* __restrict__ h_final, int S, int H, int P, int G, int N,
        int chunk, int vec_x, int vec_bc) {
  constexpr bool kBf16 = sizeof(T) == 2;
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout L = make_layout(chunk, P, N, sizeof(T));
  T* xs = reinterpret_cast<T*>(smem + L.xs);
  T* bs = reinterpret_cast<T*>(smem + L.bs);
  T* cs = reinterpret_cast<T*>(smem + L.cs);
  T* ms = reinterpret_cast<T*>(smem + L.ms);
  float* ys = reinterpret_cast<float*>(smem + L.ys);
  float* hs = reinterpret_cast<float*>(smem + L.hs);
  float* cum = reinterpret_cast<float*>(smem + L.cum);
  float* dtv = reinterpret_cast<float*>(smem + L.dtv);
  float* wv = reinterpret_cast<float*>(smem + L.wv);
  const int CP = L.CP, NP = L.NP, PP = L.PP;
  const int ldx = L.ldx, ldb = L.ldb, ldm = L.ldm, ldy = L.ldy, ldh = L.ldh;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, t4 = lane & 3;  // mma fragment row group, column pair
  const int mi = warp & 3, nh = warp >> 2;  // warp's 16-row m-tile, column half
  const int h = blockIdx.x, bi = blockIdx.y;
  const int g = h / (H / G);
  const size_t x_row = (size_t)H * P, bc_row = (size_t)G * N;
  const T* xb = x + (size_t)bi * S * x_row + (size_t)h * P;
  T* yb = y + (size_t)bi * S * x_row + (size_t)h * P;
  const float* dtb = dt + (size_t)bi * S * H + h;
  const T* Bb = Bm + (size_t)bi * S * bc_row + (size_t)g * N;
  const T* Cb = Cm + (size_t)bi * S * bc_row + (size_t)g * N;
  const float a = A[h], d = D[h];

  for (int e = tid; e < PP * ldh; e += THREADS) hs[e] = 0.f;

  for (int c0 = 0; c0 < S; c0 += chunk) {
    load_tile(xs, ldx, xb + (size_t)c0 * x_row, x_row, chunk, CP, P, PP, vec_x);
    load_tile(bs, ldb, Bb + (size_t)c0 * bc_row, bc_row, chunk, CP, N, NP, vec_bc);
    for (int t = tid; t < CP; t += THREADS) dtv[t] = t < chunk ? dtb[(size_t)(c0 + t) * H] : 0.f;
    __syncthreads();
    if (warp == 0) chunk_cumsum(cum, dtv, a, CP, lane);
    __syncthreads();
    const float cum_end = cum[CP - 1];
    for (int s = tid; s < CP; s += THREADS) wv[s] = expf(cum_end - cum[s]) * dtv[s];

    // M[t, s] from the f32 score, masked before exp
    auto mval = [&](float score, int t, int s) {
      return s <= t ? score * expf(cum[t] - cum[s]) * dtv[s] : 0.f;
    };

    for (int tb0 = 0; tb0 < CP; tb0 += TB) {
      const int rows = min(TB, CP - tb0);
      const int kend_blk = min(CP, tb0 + rows);  // columns any row here may see
      load_tile(cs, ldb, Cb + (size_t)(c0 + tb0) * bc_row, bc_row,
                max(0, min(rows, chunk - tb0)), rows, N, NP, vec_bc);
      __syncthreads();

      // 1. y_inter = exp(cum_t) * (C_t . h_prev^T), f32
      fma_tiles<4, 4>(
          rows, PP, NP, [&](int t, int n) { return to_f(cs[t * ldb + n]); },
          [&](int n, int p) { return hs[p * ldh + n]; },
          [&](int t, int p, float acc) { ys[t * ldy + p] = expf(cum[tb0 + t]) * acc; });

      // 2. M rows of this block, rounded to x's dtype
      if constexpr (kBf16) {
        const int r0 = mi * 16;
        if (r0 < rows) {
          const int kend = min(CP, tb0 + r0 + 16);
          const __nv_bfloat16* Cw = cs + (r0 + gq) * ldb + 2 * t4;
          for (int s0 = nh * 64; s0 < kend; s0 += 128) {
            float acc[8][4];
#pragma unroll
            for (int j = 0; j < 8; ++j)
#pragma unroll
              for (int i = 0; i < 4; ++i) acc[j][i] = 0.f;
            for (int kc = 0; kc < NP / 16; ++kc) {
              uint32_t af[4];
              af[0] = lds32(Cw + kc * 16);
              af[1] = lds32(Cw + 8 * ldb + kc * 16);
              af[2] = lds32(Cw + kc * 16 + 8);
              af[3] = lds32(Cw + 8 * ldb + kc * 16 + 8);
#pragma unroll
              for (int j = 0; j < 8; ++j) {
                if (s0 + j * 8 < kend) {
                  const __nv_bfloat16* bp = bs + (s0 + j * 8 + gq) * ldb + kc * 16 + 2 * t4;
                  mma_bf16(acc[j], af, lds32(bp), lds32(bp + 8));
                }
              }
            }
#pragma unroll
            for (int j = 0; j < 8; ++j) {
              if (s0 + j * 8 < kend) {
                const int s = s0 + j * 8 + 2 * t4;
#pragma unroll
                for (int r = 0; r < 2; ++r) {
                  const int tl = r0 + gq + r * 8, t = tb0 + tl;
                  *reinterpret_cast<uint32_t*>(&ms[tl * ldm + s]) =
                      pack_bf16(mval(acc[j][2 * r], t, s), mval(acc[j][2 * r + 1], t, s + 1));
                }
              }
            }
          }
        }
      } else {
        fma_tiles<4, 4>(
            rows, kend_blk, NP, [&](int t, int n) { return to_f(cs[t * ldb + n]); },
            [&](int n, int s) { return to_f(bs[s * ldb + n]); },
            [&](int t, int s, float acc) { ms[t * ldm + s] = cvt<T>(mval(acc, tb0 + t, s)); });
      }
      __syncthreads();

      // 3. y = (M @ x + y_inter) + D x, cast once, straight to y
      auto store_y = [&](int tl, int p, float acc) {
        const int t = tb0 + tl;
        if (t < chunk && p < P)
          yb[(size_t)(c0 + t) * x_row + p] =
              cvt<T>((acc + ys[tl * ldy + p]) + d * to_f(xs[t * ldx + p]));
      };
      if constexpr (kBf16) {
        const int r0 = mi * 16;
        if (r0 < rows) {
          const int kend = min(CP, tb0 + r0 + 16);
          const int npairs = PP / 16;  // 16-column pairs of n8 tiles
          float acc[8][4];
#pragma unroll
          for (int j = 0; j < 8; ++j)
#pragma unroll
            for (int i = 0; i < 4; ++i) acc[j][i] = 0.f;
          const __nv_bfloat16* Mw = ms + (r0 + gq) * ldm + 2 * t4;
          for (int kc = 0; kc < kend / 16; ++kc) {
            uint32_t af[4];
            af[0] = lds32(Mw + kc * 16);
            af[1] = lds32(Mw + 8 * ldm + kc * 16);
            af[2] = lds32(Mw + kc * 16 + 8);
            af[3] = lds32(Mw + 8 * ldm + kc * 16 + 8);
            const __nv_bfloat16* xp = xs + (kc * 16 + (lane & 15)) * ldx + (lane >> 4) * 8;
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const int pair = nh + 2 * i;
              if (pair < npairs) {
                uint32_t bv[4];  // B fragments of n8 tiles 2 pair and 2 pair + 1
                ldmatrix_x4_trans(bv, xp + pair * 16);
                mma_bf16(acc[2 * i], af, bv[0], bv[1]);
                mma_bf16(acc[2 * i + 1], af, bv[2], bv[3]);
              }
            }
          }
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int pair = nh + 2 * i;
            if (pair < npairs) {
#pragma unroll
              for (int jj = 0; jj < 2; ++jj) {
                const int p = pair * 16 + jj * 8 + 2 * t4;
#pragma unroll
                for (int r = 0; r < 2; ++r) {
                  const int tl = r0 + gq + r * 8;
                  store_y(tl, p, acc[2 * i + jj][2 * r]);
                  store_y(tl, p + 1, acc[2 * i + jj][2 * r + 1]);
                }
              }
            }
          }
        }
      } else {
        fma_tiles<4, 4>(
            rows, PP, kend_blk, [&](int t, int s) { return to_f(ms[t * ldm + s]); },
            [&](int s, int p) { return to_f(xs[s * ldx + p]); }, store_y);
      }
      __syncthreads();
    }

    // 4. h <- exp(cum_end) h_prev + (x w)^T B, f32; every row block has read
    // h_prev (barrier above)
    const float dec_end = expf(cum_end);
    fma_tiles<4, 8>(
        PP, NP, CP, [&](int p, int s) { return to_f(xs[s * ldx + p]) * wv[s]; },
        [&](int s, int n) { return to_f(bs[s * ldb + n]); },
        [&](int p, int n, float acc) { hs[p * ldh + n] = dec_end * hs[p * ldh + n] + acc; });
    __syncthreads();
  }

  T* hf = h_final + ((size_t)bi * H + h) * P * N;
  for (int e = tid; e < P * N; e += THREADS) hf[e] = cvt<T>(hs[(e / N) * ldh + e % N]);
}

template <typename T>
cudaError_t launch(const void* x, const float* dt, const float* A, const void* B,
                   const void* C, const float* D, void* y, void* h_final, int b, int S, int H,
                   int P, int G, int N, int chunk, cudaStream_t stream) {
  const int smem = make_layout(chunk, P, N, sizeof(T)).total;
  cudaError_t err =
      cudaFuncSetAttribute(ssd_fwd<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  constexpr int V = 16 / sizeof(T);
  auto aligned = [](const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; };
  const int vec_x = P % V == 0 && aligned(x) && aligned(y);
  const int vec_bc = N % V == 0 && aligned(B) && aligned(C);
  dim3 grid(H, b);
  ssd_fwd<T><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(x), dt, A, static_cast<const T*>(B), static_cast<const T*>(C), D,
      static_cast<T*>(y), static_cast<T*>(h_final), S, H, P, G, N, chunk, vec_x, vec_bc);
  return cudaGetLastError();
}

// The chunk an f32 launch runs: `chunk` if its tiles fit, else the largest
// divisor of it that is a multiple of 16 and whose tiles fit (0 if none).
// In f32 the scan gives the same result for any chunking: M is rounded to
// x's dtype, f32 itself, so only the order of f32 sums changes. bf16 keeps
// the chunk it is given, because there M's rounding depends on the chunk.
int f32_chunk(int chunk, int P, int N) {
  if (make_layout(chunk, P, N, 4).total <= MAX_SMEM) return chunk;
  for (int sub = chunk / 16 * 16; sub >= 16; sub -= 16)
    if (chunk % sub == 0 && make_layout(sub, P, N, 4).total <= MAX_SMEM) return sub;
  return 0;
}

}  // namespace

extern "C" int ssd_launch(const void* x, const float* dt, const float* A, const void* B,
                          const void* C, const float* D, void* y, void* h_final, int b, int S,
                          int H, int P, int G, int N, int chunk, int dtype, void* stream) {
  if (b <= 0 || S <= 0 || H <= 0 || P <= 0 || P > 128 || G <= 0 || H % G != 0 || N <= 0 ||
      chunk <= 0 || S % chunk != 0 || (dtype != DT_F32 && dtype != DT_BF16))
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == DT_F32) chunk = f32_chunk(chunk, P, N);  // sub-chunks of the chunk
  if (chunk <= 0 || make_layout(chunk, P, N, dtype == DT_BF16 ? 2 : 4).total > MAX_SMEM)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == DT_BF16)
    err = launch<__nv_bfloat16>(x, dt, A, B, C, D, y, h_final, b, S, H, P, G, N, chunk, s);
  else
    err = launch<float>(x, dt, A, B, C, D, y, h_final, b, S, H, P, G, N, chunk, s);
  return static_cast<int>(err);
}

// The chunk ssd_launch runs for these arguments (0: refused), so that a
// caller can hold the kernel to a plain version of the same chunking.
extern "C" int ssd_run_chunk(int chunk, int P, int N, int dtype) {
  if (chunk <= 0 || P <= 0 || N <= 0 || (dtype != DT_F32 && dtype != DT_BF16)) return 0;
  if (dtype == DT_F32) chunk = f32_chunk(chunk, P, N);
  return chunk > 0 && make_layout(chunk, P, N, dtype == DT_BF16 ? 2 : 4).total <= MAX_SMEM
             ? chunk
             : 0;
}
