// Mamba-2 SSD chunk scan for Hopper (sm_90a). Per (batch b, head h), over
// chunks of C tokens, with an f32 state h [P, N] carried across chunks:
//   cum    = cumsum(dt * A) within the chunk                    (f32)
//   M[t,s] = (C_t . B_s) * exp(cum_t - cum_s) * dt_s, s <= t    (f32, then
//            rounded to x's dtype)
//   y_t    = (M @ x)_t + exp(cum_t) * (C_t . h_prev^T) + D x_t  (f32, one cast)
//   h      = exp(cum_end) h_prev + sum_s exp(cum_end - cum_s) dt_s x_s^T B_s
// x [b, S, H, P], dt [b, S, H] f32, A and D [H] f32, B and C [b, S, G, N]
// with group g = h / (H / G) read in place (never repeated to H heads).
// x, B and C are read by stride: batch and row (token) strides are
// arguments, the head (group) stride is P (N) and the last dim is
// contiguous, so the views the model splits off one projection are read
// without a copy. S is a chunk multiple (the wrapper pads with dt = 0,
// which leaves the state unchanged). Outputs: y [b, S, H, P] and the final
// state h_final [b, H, P, N], both contiguous in x's dtype.
//
// Replaces the TPU kernel repro/kernels/ssd/ssd.py::ssd_pallas
// (_ssd_kernel). What it computes is the same, rounding where it rounds;
// how is not carried over block by block. The TPU grid (b, H, chunks)
// walks the chunks as its minor sequential axis and carries the f32 state
// in VMEM scratch from one grid step to the next. Two mainloops, picked by
// the wrapper's ssd_plan and passed as an int:
//
// chunked (bf16 at P = 64, N = 128, chunk 256: mamba2's tiles). Three
// launches on the caller's stream, no host sync between them:
//   1. ssd_chunk_state, one block per (b, h, chunk): cum, w_s =
//      exp(cum_end - cum_s) dt_s and the chunk's own state s_c = (x w)^T B
//      [P, N], f32 FMA on the CUDA cores (x and B widened from bf16, x w an
//      f32 product), into an f32 workspace [b, H, nc, P, N], with
//      exp(cum_end) beside it. Each thread owns an 8 x 8 register tile of
//      s_c; x w and B arrive in 32-row slabs as f32 in shared memory.
//   2. ssd_state_pass, one thread per 4 state entries of a (b, h): for c =
//      0 .. nc-1 it stores h_prev[c] = h over s_c (in place) and sets
//      h = exp(cum_end_c) * h + s_c, the Pallas kernel's expression, in f32,
//      in the same order (no contraction into an FMA); the last h goes to
//      h_final.
//   3. ssd_chunk_scan, one block per (b, chunk) and 1-8 heads of a group
//      (scan_heads_per_block: as many as keep about one block per SM),
//      8 warps; the heads share one load of C and B. Warp w owns the
//      16-row m-tiles w and 15 - w (equal causal work). Per head: y_inter
//      = exp(cum_t) * (C h_prev^T) is f32 FMA on the CUDA cores into
//      registers laid out as the mma accumulators (4 rows x 16 columns a
//      thread); M = C B^T is bf16 mma.sync m16n8k16 with f32 accumulate,
//      masked before exp (only on the diagonal 64-key block) and scaled
//      in f32, rounded to bf16 in registers and fed as the A operand of
//      M x (mma.sync again, 64 keys a step); y = (M x + y_inter) + D x,
//      cast once. The next head's h_prev loads (cp.async) under this
//      head's M x, its x under its y_inter products. M's decay uses the
//      ex2-based exp (exp_fast): M is rounded to bf16 at once, and the
//      full-precision expf took about as long as M x itself.
// Every sum's order depends on P, N and the chunk only, never on S, b or
// the grid, and a padded step (dt = 0) adds exactly 0 to s_c and leaves h
// as it is: a prompt's rows and state are bit-equal alone and in a bucket.
//
// serial (f32, and every other bf16 shape): one block owns one (b, h),
// loops over the chunks itself with the state in shared memory, and also
// writes that state out at the end. One chunk in shared memory: x [C, P]
// and B [C, N] whole, the state, and per row block of 64 t (TB): its C
// rows, its M rows (in x's dtype, as the reference rounds M) and its
// inter-chunk output. At mamba2's C = 256, N = 128, P = 64 in bf16 that is
// 211,200 bytes of the 232,448 a block may have. In f32 the same chunk
// needs 358,656 bytes, so an f32 launch runs each chunk as sub-chunks
// (f32_chunk: 128 at mamba2's tiles, 221,952 bytes), which in f32 is the
// same function. Per row block: y_inter in f32 FMA; M = C B^T masked,
// scaled (mma.sync in bf16, FMA in f32); y = (M @ x + y_inter) + D x. The
// state update is f32 FMA, as the Pallas kernel's f32 dot.
//
// The mask is applied before exp in both: above the diagonal cum_t - cum_s
// is large and positive (about +180 over a 256-token chunk at dt ~ 0.7,
// A = -1) and exp overflows; exp(seg) * 0 would be NaN.
//
// What bounds it on the H100: operations. At mamba2's [4, 2048] prefill
// (32 heads, P = 64, N = 128, C = 256) the two f32 products (C h^T and
// x^T B, 8.6 GFLOP) at 67 TFLOP/s take 0.128 ms, against 0.013 ms for the
// causal half of the two bf16 products on the tensor cores and 0.022 ms
// for the 74 MB of inputs and outputs. They stay f32 FMA (no TF32, no bf16
// state), as the Pallas kernel computes them: chunked spreads them over
// 1024 (b, h, chunk) units on all 132 SMs with register tiles, where
// serial ran them on one SM per (b, h), chunk after chunk. Each product
// then runs an FFMA in most cycles of every SM's schedulers, with the
// shared-memory loads and bf16 widening beside them; the scan's M x
// (mma.sync, latency-bound on 8 warps) runs after its y_inter, not under
// it, and the state pass is a 64 MB round trip through memory.
//
// C interface (bound with ctypes): ssd_launch refuses a shape or mainloop
// it does not take, or whose tiles need more dynamic shared memory than a
// block may have, with cudaErrorInvalidValue, and otherwise returns
// cudaGetLastError() after the launches; the caller raises when it is not
// 0. ssd_run_chunk says which chunk a serial launch runs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int THREADS = 256;       // 8 warps
constexpr int TB = 64;             // rows of a row block, 16 per warp row
constexpr int MAX_SMEM = 232448;   // dynamic shared memory a block may have
enum DType { DT_F32 = 0, DT_BF16 = 1 };
enum Mainloop { ML_SERIAL = 0, ML_CHUNKED = 1 };

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
// Entries are STRIDE floats apart in cum and dtv.
template <int STRIDE = 1>
__device__ __forceinline__ void chunk_cumsum(float* cum, const float* dtv, float a, int CP,
                                             int lane) {
  const int per = (CP + 31) / 32;
  const int beg = min(CP, lane * per), end = min(CP, beg + per);
  float run = 0.f;
  for (int t = beg; t < end; ++t) {
    run += dtv[t * STRIDE] * a;
    cum[t * STRIDE] = run;
  }
  float incl = run;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float v = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += v;
  }
  const float offset = incl - run;
  for (int t = beg; t < end; ++t) cum[t * STRIDE] += offset;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
ssd_fwd(const T* __restrict__ x, const float* __restrict__ dt, const float* __restrict__ A,
        const T* __restrict__ Bm, const T* __restrict__ Cm, const float* __restrict__ D,
        T* __restrict__ y, T* __restrict__ h_final, int S, int H, int P, int G, int N,
        int chunk, size_t x_bs, size_t x_rs, size_t b_bs, size_t b_rs, size_t c_bs, size_t c_rs,
        int vec_x, int vec_bc) {
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
  const size_t y_row = (size_t)H * P;
  const T* xb = x + bi * x_bs + (size_t)h * P;
  T* yb = y + (size_t)bi * S * y_row + (size_t)h * P;
  const float* dtb = dt + (size_t)bi * S * H + h;
  const T* Bb = Bm + bi * b_bs + (size_t)g * N;
  const T* Cb = Cm + bi * c_bs + (size_t)g * N;
  const float a = A[h], d = D[h];

  for (int e = tid; e < PP * ldh; e += THREADS) hs[e] = 0.f;

  for (int c0 = 0; c0 < S; c0 += chunk) {
    load_tile(xs, ldx, xb + (size_t)c0 * x_rs, x_rs, chunk, CP, P, PP, vec_x);
    load_tile(bs, ldb, Bb + (size_t)c0 * b_rs, b_rs, chunk, CP, N, NP, vec_bc);
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
      load_tile(cs, ldb, Cb + (size_t)(c0 + tb0) * c_rs, c_rs,
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
          yb[(size_t)(c0 + t) * y_row + p] =
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

// ---------------------------------------------------------------------------
// chunked: the three launches (see the header)
// ---------------------------------------------------------------------------

namespace ck {
constexpr int C = 256, P = 64, N = 128;  // the tiles this mainloop takes
// ssd_chunk_state: 128 threads, each an 8 x 8 tile of s_c [P, N]; x w and
// B arrive in slabs of KS rows, as f32 (row strides LDXW, LDBF floats)
constexpr int ST_THREADS = 128, KS = 32, LDXW = P + 4, LDBF = N + 4;
constexpr int ST_SMEM = (KS * LDXW + KS * LDBF + 3 * C) * 4;
// ssd_state_pass: 256 threads, one float4 of a (b, h)'s state each
constexpr int SP_THREADS = 256, PN4 = P * N / 4;
// ssd_chunk_scan: 8 warps, up to SC_HEADS heads a block; the chunk's C,
// B (bf16, LDC) and x (bf16, LDX) whole, h_prev (f32, LDH), and every
// head's (cum, dt) pairs
constexpr int SC_THREADS = 256, SC_HEADS = 8, LDC = N + 8, LDX = P + 8, LDH = N + 4;
constexpr int SC_CS = 0, SC_BS = SC_CS + C * LDC * 2, SC_XS = SC_BS + C * LDC * 2,
              SC_HS = SC_XS + C * LDX * 2, SC_CD = SC_HS + P * LDH * 4,
              SC_SMEM = SC_CD + SC_HEADS * C * 8;
static_assert(SC_SMEM <= MAX_SMEM, "chunk-scan tiles exceed a block's shared memory");
static_assert(C == 256 && P == 64 && N == 128 && SC_THREADS == 256 && SC_HEADS <= 8,
              "ssd_chunk_scan's warp tiling (16 m-tiles on 8 warps, 8 n8 tiles of P) "
              "is written for these tiles");
}  // namespace ck

// bf16 -> f32 of the low (first) and high (second) element of a pair: exact
__device__ __forceinline__ float bf_lo(uint32_t v) { return __uint_as_float(v << 16); }
__device__ __forceinline__ float bf_hi(uint32_t v) { return __uint_as_float(v & 0xffff0000u); }

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING) : "memory");
}

// 1. s_c = (x w)^T B for one (b, h, chunk) into ws_s, exp(cum_end) into ws_de.
__global__ void __launch_bounds__(ck::ST_THREADS)
ssd_chunk_state(const __nv_bfloat16* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ A, const __nv_bfloat16* __restrict__ Bm,
                float* __restrict__ ws_s, float* __restrict__ ws_de, int S, int H, int G,
                size_t x_bs, size_t x_rs, size_t b_bs, size_t b_rs) {
  using namespace ck;
  extern __shared__ __align__(16) unsigned char smem[];
  float* xw = reinterpret_cast<float*>(smem);
  float* bsm = xw + KS * LDXW;
  float* dtv = bsm + KS * LDBF;
  float* cum = dtv + C;
  float* wv = cum + C;
  const int tid = threadIdx.x, h = blockIdx.x, c = blockIdx.y, bi = blockIdx.z;
  const int nc = gridDim.y, g = h / (H / G), c0 = c * C;
  const size_t unit = ((size_t)bi * H + h) * nc + c;

  for (int t = tid; t < C; t += ST_THREADS) dtv[t] = dt[((size_t)bi * S + c0 + t) * H + h];
  __syncthreads();
  if (tid < 32) chunk_cumsum(cum, dtv, A[h], C, tid);
  __syncthreads();
  const float cum_end = cum[C - 1];
  for (int s = tid; s < C; s += ST_THREADS) wv[s] = expf(cum_end - cum[s]) * dtv[s];
  if (tid == 0) ws_de[unit] = expf(cum_end);

  const __nv_bfloat16* xb = x + bi * x_bs + (size_t)c0 * x_rs + (size_t)h * P;
  const __nv_bfloat16* bb = Bm + bi * b_bs + (size_t)c0 * b_rs + (size_t)g * N;
  const int tx = tid & 15, ty = tid >> 4;  // columns tx*4 (+64), rows ty*4 (+32)
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  // slab s0 + KS loads into registers while slab s0's products run
  constexpr int XV = KS * P / 8 / ST_THREADS, BV = KS * N / 8 / ST_THREADS;
  uint4 xv[XV], bv[BV];
  auto load_slab = [&](int s0) {
#pragma unroll
    for (int i = 0; i < XV; ++i) {
      const int e = tid + i * ST_THREADS, r = e / (P / 8), v = e % (P / 8);
      xv[i] = __ldg(reinterpret_cast<const uint4*>(xb + (size_t)(s0 + r) * x_rs + v * 8));
    }
#pragma unroll
    for (int i = 0; i < BV; ++i) {
      const int e = tid + i * ST_THREADS, r = e / (N / 8), v = e % (N / 8);
      bv[i] = __ldg(reinterpret_cast<const uint4*>(bb + (size_t)(s0 + r) * b_rs + v * 8));
    }
  };
  load_slab(0);
  for (int s0 = 0; s0 < C; s0 += KS) {
    __syncthreads();  // wv is written; the last slab's products are done
#pragma unroll
    for (int i = 0; i < XV; ++i) {
      const int e = tid + i * ST_THREADS, r = e / (P / 8), v = e % (P / 8);
      const float w = wv[s0 + r];
      float4* d = reinterpret_cast<float4*>(xw + r * LDXW + v * 8);
      d[0] = make_float4(bf_lo(xv[i].x) * w, bf_hi(xv[i].x) * w, bf_lo(xv[i].y) * w,
                         bf_hi(xv[i].y) * w);
      d[1] = make_float4(bf_lo(xv[i].z) * w, bf_hi(xv[i].z) * w, bf_lo(xv[i].w) * w,
                         bf_hi(xv[i].w) * w);
    }
#pragma unroll
    for (int i = 0; i < BV; ++i) {
      const int e = tid + i * ST_THREADS, r = e / (N / 8), v = e % (N / 8);
      float4* d = reinterpret_cast<float4*>(bsm + r * LDBF + v * 8);
      d[0] = make_float4(bf_lo(bv[i].x), bf_hi(bv[i].x), bf_lo(bv[i].y), bf_hi(bv[i].y));
      d[1] = make_float4(bf_lo(bv[i].z), bf_hi(bv[i].z), bf_lo(bv[i].w), bf_hi(bv[i].w));
    }
    __syncthreads();
    if (s0 + KS < C) load_slab(s0 + KS);
#pragma unroll 8
    for (int k = 0; k < KS; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(xw + k * LDXW + ty * 4);
      const float4 a1 = *reinterpret_cast<const float4*>(xw + k * LDXW + 32 + ty * 4);
      const float4 b0 = *reinterpret_cast<const float4*>(bsm + k * LDBF + tx * 4);
      const float4 b1 = *reinterpret_cast<const float4*>(bsm + k * LDBF + 64 + tx * 4);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bw[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bw[j], acc[i][j]);
    }
  }
  float* out = ws_s + unit * (P * N);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int p = (i < 4 ? 0 : 32) + ty * 4 + (i & 3);
    *reinterpret_cast<float4*>(out + p * N + tx * 4) =
        make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    *reinterpret_cast<float4*>(out + p * N + 64 + tx * 4) =
        make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
  }
}

// 2. The state pass over the chunks of each (b, h), 4 entries a thread:
// h_prev[c] over s_c in place, h = exp(cum_end_c) * h + s_c, h_final.
__device__ __forceinline__ float decay_add(float de, float h, float s) {
  return __fadd_rn(__fmul_rn(de, h), s);  // the reference's order, never an FMA
}

__global__ void __launch_bounds__(ck::SP_THREADS)
ssd_state_pass(float* __restrict__ ws_s, const float* __restrict__ ws_de,
               __nv_bfloat16* __restrict__ h_final, int bh_count, int nc) {
  using namespace ck;
  constexpr int U = 8;  // chunks whose loads are in flight together
  const size_t idx = (size_t)blockIdx.x * SP_THREADS + threadIdx.x;
  if (idx >= (size_t)bh_count * PN4) return;
  const size_t bh = idx / PN4, e = idx % PN4;
  float4* s = reinterpret_cast<float4*>(ws_s) + bh * nc * PN4 + e;
  const float* de = ws_de + bh * nc;
  float4 h = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int c0 = 0; c0 < nc; c0 += U) {
    float4 v[U];
    float d[U];
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (c0 + u < nc) {
        v[u] = s[(size_t)(c0 + u) * PN4];
        d[u] = de[c0 + u];
      }
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (c0 + u < nc) {
        s[(size_t)(c0 + u) * PN4] = h;  // h_prev of chunk c0 + u
        h = make_float4(decay_add(d[u], h.x, v[u].x), decay_add(d[u], h.y, v[u].y),
                        decay_add(d[u], h.z, v[u].z), decay_add(d[u], h.w, v[u].w));
      }
  }
  uint2 out;
  out.x = pack_bf16(h.x, h.y);
  out.y = pack_bf16(h.z, h.w);
  *reinterpret_cast<uint2*>(h_final + bh * (P * N) + e * 4) = out;
}

// exp(x) for M's decay, which M rounds to bf16 at once: ex2 of x log2(e),
// relative error about 2**-21 over the exponents a chunk reaches, against
// bf16's 2**-9; results below 2**-126 flush to 0.
__device__ __forceinline__ float exp_fast(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x * 1.4426950408889634f));
  return y;
}

// 3. y for `hb` heads of one (b, chunk) from h_prev[c] (ws_s after the
// state pass). The heads share their group's C and B, loaded once; each
// head's h_prev loads under the previous head's M x, its x under its own
// y_inter products.
__global__ void __launch_bounds__(ck::SC_THREADS, 1)
ssd_chunk_scan(const __nv_bfloat16* __restrict__ x, const float* __restrict__ dt,
               const float* __restrict__ A, const __nv_bfloat16* __restrict__ Bm,
               const __nv_bfloat16* __restrict__ Cm, const float* __restrict__ D,
               const float* __restrict__ ws_s, __nv_bfloat16* __restrict__ y, int S, int H,
               int G, int hb, size_t x_bs, size_t x_rs, size_t b_bs, size_t b_rs, size_t c_bs,
               size_t c_rs) {
  using namespace ck;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* cs = reinterpret_cast<__nv_bfloat16*>(smem + SC_CS);
  __nv_bfloat16* bs = reinterpret_cast<__nv_bfloat16*>(smem + SC_BS);
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem + SC_XS);
  float* hs = reinterpret_cast<float*>(smem + SC_HS);
  float2* cd_all = reinterpret_cast<float2*>(smem + SC_CD);  // (cum, dt) per head and t
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, t4 = lane & 3;  // mma fragment row group, column pair
  const int h0 = blockIdx.x * hb, c = blockIdx.y, bi = blockIdx.z;
  const int nc = gridDim.y, g = h0 / (H / G), c0 = c * C;
  const __nv_bfloat16* bb = Bm + bi * b_bs + (size_t)c0 * b_rs + (size_t)g * N;
  const __nv_bfloat16* cb = Cm + bi * c_bs + (size_t)c0 * c_rs + (size_t)g * N;
  auto load_h = [&](int h) {
    const float* hp = ws_s + (((size_t)bi * H + h) * nc + c) * (P * N);
    for (int e = tid; e < P * (N / 4); e += SC_THREADS) {
      const int r = e / (N / 4), v = e % (N / 4);
      cp_async16(hs + r * LDH + v * 4, hp + r * N + v * 4);
    }
  };
  auto load_x = [&](int h) {
    const __nv_bfloat16* xb = x + bi * x_bs + (size_t)c0 * x_rs + (size_t)h * P;
    for (int e = tid; e < C * (P / 8); e += SC_THREADS) {
      const int r = e / (P / 8), v = e % (P / 8);
      cp_async16(xs + r * LDX + v * 8, xb + (size_t)r * x_rs + v * 8);
    }
  };

  // group 0: C and the first h_prev (the y_inter products); group 1: B
  // and the first x. Then one group after each head's y_inter (the next
  // h_prev) and one after its M x (the next x), empty past the last head,
  // so that wait_group 1 always waits for the group needed next.
  for (int e = tid; e < C * (N / 8); e += SC_THREADS) {
    const int r = e / (N / 8), v = e % (N / 8);
    cp_async16(cs + r * LDC + v * 8, cb + (size_t)r * c_rs + v * 8);
  }
  load_h(h0);
  cp_async_commit();
  for (int e = tid; e < C * (N / 8); e += SC_THREADS) {
    const int r = e / (N / 8), v = e % (N / 8);
    cp_async16(bs + r * LDC + v * 8, bb + (size_t)r * b_rs + v * 8);
  }
  load_x(h0);
  cp_async_commit();

  // every head's dt column, and its cumsum by warp k
  for (int e = tid; e < hb * C; e += SC_THREADS) {
    const int t = e / hb, k = e % hb;
    cd_all[k * C + t].y = dt[((size_t)bi * S + c0 + t) * H + h0 + k];
  }
  __syncthreads();
  if (warp < hb)
    chunk_cumsum<2>(&cd_all[warp * C].x, &cd_all[warp * C].y, A[h0 + warp], C, lane);

  // The warp's m-tiles w and 15 - w (equal causal work); the thread's rows
  // gq and gq + 8 of each, its columns p = 8 j + 2 t4 + e (j < 8, e < 2):
  // the layout of the mma accumulators.
  const int mt[2] = {warp, 15 - warp};
  int rows[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) rows[r] = 16 * mt[r >> 1] + gq + 8 * (r & 1);

  for (int k = 0; k < hb; ++k) {
    const int h = h0 + k;
    const float2* cd = cd_all + k * C;
    cp_async_wait<1>();  // C and this head's h_prev (every head's cum at k = 0)
    __syncthreads();

    // y_inter[t][p] = exp(cum_t) * sum_n C[t][n] h_prev[p][n], n in order
    float yi[4][16];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int q = 0; q < 16; ++q) yi[r][q] = 0.f;
#pragma unroll 4
    for (int n0 = 0; n0 < N; n0 += 4) {
      float cv[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const uint2 v = *reinterpret_cast<const uint2*>(cs + rows[r] * LDC + n0);
        cv[r][0] = bf_lo(v.x);
        cv[r][1] = bf_hi(v.x);
        cv[r][2] = bf_lo(v.y);
        cv[r][3] = bf_hi(v.y);
      }
#pragma unroll
      for (int q = 0; q < 16; ++q) {
        const int p = 8 * (q >> 1) + 2 * t4 + (q & 1);
        const float4 hv = *reinterpret_cast<const float4*>(hs + p * LDH + n0);
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          float a = yi[r][q];
          a = fmaf(cv[r][0], hv.x, a);
          a = fmaf(cv[r][1], hv.y, a);
          a = fmaf(cv[r][2], hv.z, a);
          a = fmaf(cv[r][3], hv.w, a);
          yi[r][q] = a;
        }
      }
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float e = expf(cd[rows[r]].x);
#pragma unroll
      for (int q = 0; q < 16; ++q) yi[r][q] = e * yi[r][q];
    }
    __syncthreads();  // every warp is done with hs
    if (k + 1 < hb) load_h(h + 1);
    cp_async_commit();
    cp_async_wait<1>();  // B and this head's x
    __syncthreads();

    const float d = D[h];
    __nv_bfloat16* yh = y + ((size_t)bi * S + c0) * H * P + (size_t)h * P;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int t0 = 16 * mt[half], tr[2] = {t0 + gq, t0 + gq + 8};
      const float cum_t[2] = {cd[tr[0]].x, cd[tr[1]].x};
      float mx[8][4];
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) mx[j][i] = 0.f;
      // one s-block of 64 keys from s0: S = C B^T on n8 tiles of keys
      // s <= t0 + 15, M masked before exp, scaled and rounded to bf16, M x.
      // FULL: every key of the block precedes every row (no mask, 8 tiles).
      auto s_block = [&](auto full, int s0) {
        constexpr bool FULL = decltype(full)::value;
        const int ntile = FULL ? 8 : min(8, (t0 + 16 - s0) / 8);
        float sc[8][4];
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int i = 0; i < 4; ++i) sc[j][i] = 0.f;
        const __nv_bfloat16* Cw = cs + tr[0] * LDC + 2 * t4;
#pragma unroll
        for (int kc = 0; kc < N / 16; ++kc) {
          uint32_t af[4];
          af[0] = lds32(Cw + kc * 16);
          af[1] = lds32(Cw + 8 * LDC + kc * 16);
          af[2] = lds32(Cw + kc * 16 + 8);
          af[3] = lds32(Cw + 8 * LDC + kc * 16 + 8);
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            if (FULL || j < ntile) {
              const __nv_bfloat16* bp = bs + (s0 + j * 8 + gq) * LDC + kc * 16 + 2 * t4;
              mma_bf16(sc[j], af, lds32(bp), lds32(bp + 8));
            }
          }
        }
        auto m = [&](float score, int rr, int key, float cum_s, float dt_s) {
          const float v = score * exp_fast(cum_t[rr] - cum_s) * dt_s;
          return FULL || key <= tr[rr] ? v : 0.f;
        };
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          if (FULL || 2 * q < ntile) {
            const int s = s0 + 16 * q + 2 * t4;
            // (cum, dt) at keys s, s + 1 and s + 8, s + 9
            const float4 v0 = *reinterpret_cast<const float4*>(cd + s);
            const float4 v1 = *reinterpret_cast<const float4*>(cd + s + 8);
            uint32_t a[4];
            a[0] = pack_bf16(m(sc[2 * q][0], 0, s, v0.x, v0.y),
                             m(sc[2 * q][1], 0, s + 1, v0.z, v0.w));
            a[1] = pack_bf16(m(sc[2 * q][2], 1, s, v0.x, v0.y),
                             m(sc[2 * q][3], 1, s + 1, v0.z, v0.w));
            a[2] = pack_bf16(m(sc[2 * q + 1][0], 0, s + 8, v1.x, v1.y),
                             m(sc[2 * q + 1][1], 0, s + 9, v1.z, v1.w));
            a[3] = pack_bf16(m(sc[2 * q + 1][2], 1, s + 8, v1.x, v1.y),
                             m(sc[2 * q + 1][3], 1, s + 9, v1.z, v1.w));
            const __nv_bfloat16* xp =
                xs + (s0 + 16 * q + (lane & 15)) * LDX + (lane >> 4) * 8;
#pragma unroll
            for (int pair = 0; pair < 4; ++pair) {
              uint32_t bv[4];  // B fragments of n8 tiles 2 pair and 2 pair + 1
              ldmatrix_x4_trans(bv, xp + pair * 16);
              mma_bf16(mx[2 * pair], a, bv[0], bv[1]);
              mma_bf16(mx[2 * pair + 1], a, bv[2], bv[3]);
            }
          }
        }
      };
      int s0 = 0;
      for (; s0 + 64 <= t0; s0 += 64) s_block(std::true_type{}, s0);
      for (; s0 < t0 + 16; s0 += 64) s_block(std::false_type{}, s0);
      // y = (M x + y_inter) + D x, cast once
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int t = tr[rr];
        __nv_bfloat16* yr = yh + (size_t)t * H * P;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int p = 8 * j + 2 * t4;
          const uint32_t xv = lds32(xs + t * LDX + p);
          const float y0 = (mx[j][2 * rr] + yi[2 * half + rr][2 * j]) + d * bf_lo(xv);
          const float y1 = (mx[j][2 * rr + 1] + yi[2 * half + rr][2 * j + 1]) + d * bf_hi(xv);
          *reinterpret_cast<uint32_t*>(yr + p) = pack_bf16(y0, y1);
        }
      }
    }
    __syncthreads();  // every warp is done with xs
    if (k + 1 < hb) load_x(h + 1);
    cp_async_commit();
  }
}

// Heads per chunk-scan block: the largest power of 2 up to 8 that divides
// H / G while the grid keeps about one block per SM (one block fits an
// SM). The arithmetic of a head does not depend on it.
int scan_heads_per_block(int b, int nc, int H, int G) {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      sms = 132;
  }
  int hb = 1;
  while (hb < ck::SC_HEADS && (H / G) % (2 * hb) == 0 &&
         16L * b * nc * (H / (2 * hb)) >= 15L * sms)
    hb *= 2;
  return hb;
}

cudaError_t launch_chunked(const void* x, const float* dt, const float* A, const void* B,
                           const void* C, const float* D, void* y, void* h_final, float* ws,
                           int b, int S, int H, int G, size_t x_bs, size_t x_rs, size_t b_bs,
                           size_t b_rs, size_t c_bs, size_t c_rs, cudaStream_t stream) {
  using namespace ck;
  cudaError_t err = cudaFuncSetAttribute(ssd_chunk_state,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, ST_SMEM);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(ssd_chunk_scan, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               SC_SMEM);
  if (err != cudaSuccess) return err;
  const int nc = S / ck::C;  // the parameter C is the C matrix
  float* ws_s = ws;
  float* ws_de = ws + (size_t)b * H * nc * P * N;
  const auto* xp = static_cast<const __nv_bfloat16*>(x);
  const auto* bp = static_cast<const __nv_bfloat16*>(B);
  const dim3 grid(H, nc, b);
  ssd_chunk_state<<<grid, ST_THREADS, ST_SMEM, stream>>>(xp, dt, A, bp, ws_s, ws_de, S, H, G,
                                                          x_bs, x_rs, b_bs, b_rs);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const size_t threads = (size_t)b * H * PN4;
  ssd_state_pass<<<(unsigned)((threads + SP_THREADS - 1) / SP_THREADS), SP_THREADS, 0,
                   stream>>>(ws_s, ws_de, static_cast<__nv_bfloat16*>(h_final), b * H, nc);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const int hb = scan_heads_per_block(b, nc, H, G);
  ssd_chunk_scan<<<dim3(H / hb, nc, b), SC_THREADS, SC_SMEM, stream>>>(
      xp, dt, A, bp, static_cast<const __nv_bfloat16*>(C), D, ws_s,
      static_cast<__nv_bfloat16*>(y), S, H, G, hb, x_bs, x_rs, b_bs, b_rs, c_bs, c_rs);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// serial
// ---------------------------------------------------------------------------

template <typename T>
cudaError_t launch_serial(const void* x, const float* dt, const float* A, const void* B,
                          const void* C, const float* D, void* y, void* h_final, int b, int S,
                          int H, int P, int G, int N, int chunk, size_t x_bs, size_t x_rs,
                          size_t b_bs, size_t b_rs, size_t c_bs, size_t c_rs,
                          cudaStream_t stream) {
  const int smem = make_layout(chunk, P, N, sizeof(T)).total;
  cudaError_t err =
      cudaFuncSetAttribute(ssd_fwd<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  constexpr int V = 16 / sizeof(T);
  auto aligned = [](const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; };
  const int vec_x = P % V == 0 && x_bs % V == 0 && x_rs % V == 0 && aligned(x) && aligned(y);
  const int vec_bc = N % V == 0 && b_bs % V == 0 && b_rs % V == 0 && c_bs % V == 0 &&
                     c_rs % V == 0 && aligned(B) && aligned(C);
  dim3 grid(H, b);
  ssd_fwd<T><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(x), dt, A, static_cast<const T*>(B), static_cast<const T*>(C), D,
      static_cast<T*>(y), static_cast<T*>(h_final), S, H, P, G, N, chunk, x_bs, x_rs, b_bs,
      b_rs, c_bs, c_rs, vec_x, vec_bc);
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

// mainloop: 0 serial, 1 chunked (the wrapper's MAINLOOPS). ws: the chunked
// mainloop's f32 workspace, b * H * (S / chunk) * (P * N + 1) floats
// (unused by serial). Strides are in elements.
extern "C" int ssd_launch(const void* x, const float* dt, const float* A, const void* B,
                          const void* C, const float* D, void* y, void* h_final, float* ws,
                          int b, int S, int H, int P, int G, int N, int chunk, long long x_bs,
                          long long x_rs, long long b_bs, long long b_rs, long long c_bs,
                          long long c_rs, int dtype, int mainloop, void* stream) {
  if (b <= 0 || S <= 0 || H <= 0 || P <= 0 || P > 128 || G <= 0 || H % G != 0 || N <= 0 ||
      chunk <= 0 || S % chunk != 0 || (dtype != DT_F32 && dtype != DT_BF16) || x_bs < 0 ||
      x_rs < 0 || b_bs < 0 || b_rs < 0 || c_bs < 0 || c_rs < 0 || b > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mainloop == ML_CHUNKED) {
    auto aligned = [](const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; };
    const bool ok = dtype == DT_BF16 && P == ck::P && N == ck::N && chunk == ck::C &&
                    ws != nullptr && S / chunk <= 65535 && aligned(x) && aligned(B) &&
                    aligned(C) && aligned(y) && aligned(h_final) && aligned(ws) &&
                    x_bs % 8 == 0 && x_rs % 8 == 0 && b_bs % 8 == 0 && b_rs % 8 == 0 &&
                    c_bs % 8 == 0 && c_rs % 8 == 0;
    if (!ok) return static_cast<int>(cudaErrorInvalidValue);
    return static_cast<int>(launch_chunked(x, dt, A, B, C, D, y, h_final, ws, b, S, H, G,
                                           x_bs, x_rs, b_bs, b_rs, c_bs, c_rs, s));
  }
  if (mainloop != ML_SERIAL) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == DT_F32) chunk = f32_chunk(chunk, P, N);  // sub-chunks of the chunk
  if (chunk <= 0 || make_layout(chunk, P, N, dtype == DT_BF16 ? 2 : 4).total > MAX_SMEM)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err;
  if (dtype == DT_BF16)
    err = launch_serial<__nv_bfloat16>(x, dt, A, B, C, D, y, h_final, b, S, H, P, G, N, chunk,
                                       x_bs, x_rs, b_bs, b_rs, c_bs, c_rs, s);
  else
    err = launch_serial<float>(x, dt, A, B, C, D, y, h_final, b, S, H, P, G, N, chunk, x_bs,
                               x_rs, b_bs, b_rs, c_bs, c_rs, s);
  return static_cast<int>(err);
}

// The chunk a serial launch runs for these arguments (0: refused), so that
// a caller can hold the kernel to a plain version of the same chunking.
extern "C" int ssd_run_chunk(int chunk, int P, int N, int dtype) {
  if (chunk <= 0 || P <= 0 || N <= 0 || (dtype != DT_F32 && dtype != DT_BF16)) return 0;
  if (dtype == DT_F32) chunk = f32_chunk(chunk, P, N);
  return chunk > 0 && make_layout(chunk, P, N, dtype == DT_BF16 ? 2 : 4).total <= MAX_SMEM
             ? chunk
             : 0;
}
