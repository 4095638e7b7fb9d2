// Flash attention forward for Hopper (sm_90a): online-softmax GQA attention
// with causal, sliding-window and kv_len-tail masks.
//   s[i, j] = (q[b, i, h, :] * scale) . k[b, j, h / G, :]      (f32)
//   o[b, i, h, :] = sum_j softmax_j(s[i, :]) v[b, j, h / G, :]   (G = Hq / Hkv)
//
// Replaces the TPU kernel repro/kernels/flash_attention/flash_attention.py::
// flash_attention_pallas (_flash_kernel). What it computes is the same; how
// is not carried over block by block. The TPU grid (B, Hq, Sq/bq, Skv/bk)
// walks the KV blocks as its minor sequential axis and carries acc, m and l
// in VMEM scratch from one grid step to the next. Here one thread block owns
// one (64-row q tile, q head, batch) and loops over the KV tiles itself,
// with m and l in registers and the f32 accumulator in mma fragments, and
// writes its output rows once.
//
// Numerics kept from the reference, step for step:
//   * q is multiplied by the scale in q's own dtype (a bf16 rounding for
//     bf16; the wrapper passes the scale already rounded to that dtype);
//   * scores are f32; a masked score is the finite -1e30, and the masks are
//     the reference's comparisons: k_pos < kv_len, causal k_pos <= q_pos
//     (both counted from 0, also when Sq != Skv), window q_pos - k_pos <
//     window;
//   * p = exp(s - m) is cast to v's dtype before PV; l sums the f32 p;
//   * out = acc / max(l, 1e-30), cast to q's dtype;
//   * GQA reads kv head h / G in place; KV heads are never repeated.
// KV tiles that are wholly masked for every row of the q tile (causal,
// window, kv_len) are skipped. The reference visits them, but for a row
// that sees any key their weight is wiped by the rescale exp(-1e30 - m) = 0.
// A row that may attend to no key at all is outside the contract (the
// Pallas kernel and naive_attention already disagree there); the serving
// engine never makes one, since a causal row always sees key 0.
//
//   * bf16: tensor cores through mma.sync.m16n8k16 (bf16 x bf16 -> f32).
//     4 warps x 16 q rows; KV tiles of 64 keys (32 for D > 128). The score
//     tile stays in registers: its accumulator layout is the A-operand
//     layout of PV, so P never touches shared memory. D is zero-filled in
//     shared memory up to the next of 32/64/128/192/256. cp.async brings
//     the next K tile while the softmax and PV of this one run, and the
//     next V tile while the next QK^T runs. Heavy causal q tiles launch
//     first.
//   * f32: one warp per q row on the CUDA cores (FMA, full f32, never
//     TF32), walking exactly the keys its row may see.
//   * Ragged Sq and Skv are masked in the kernel (zero-filled loads,
//     guarded stores), so the wrapper pads nothing.
//
// What bounds it on the H100: at long prompts operations (QK^T and PV are
// 4 D FLOPs per unmasked (q, k) pair: at granite-8b's [4, 2048, 32, 128]
// causal prefill 0.14 ms at 989 TFLOP/s against 0.05 ms of bytes), at short
// ones bytes (at [4, 256, 32, 128], 21 MB of q/k/v/o: 6 us against 2 us of
// operations). The design keeps the q tile in shared memory and the score
// and output tiles in registers for the whole KV loop, so device memory
// sees each q row once and each output row once, and K/V tiles are re-read
// by the Sq/64 x G blocks of their head mostly from L2; it halves causal
// work by skipping masked tiles. mma.sync reaches only part of Hopper's
// tensor-core rate: warpgroup MMA (wgmma) fed by TMA, warp specialisation
// and a persistent schedule are a later change's work.
//
// C interface (bound with ctypes): flash_attention_launch returns
// cudaGetLastError() after the launch; the caller raises when it is not 0.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int THREADS = 128;  // 4 warps
constexpr int BQ = 64;        // q rows per block, 16 per warp
enum DType { DT_F32 = 0, DT_BF16 = 1 };

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte asynchronous copy global -> shared; src_bytes = 0 writes zeros.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
// wait until at most one committed group is still in flight
__device__ __forceinline__ void cp_async_wait_1() { asm volatile("cp.async.wait_group 1;\n" ::); }
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::); }

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

// ---------------------------------------------------------------------------
// bf16: mma.sync tensor-core path
// ---------------------------------------------------------------------------

template <int DP, int BK>
__global__ void __launch_bounds__(THREADS)
flash_fwd_bf16(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
               const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o, int Sq,
               int Skv, int Hq, int Hkv, int D, float scale, int causal, int window,
               int kv_len) {
  constexpr int LD = DP + 8;  // row stride: 16-byte rows, conflict-free fragment reads
  constexpr int CH = DP / 8;  // 16-byte chunks per row
  constexpr int NT = BK / 8;  // 8-key n-tiles of the score tile
  constexpr int DT = DP / 8;  // 8-wide d n-tiles of the output tile
  static_assert(DP % 16 == 0 && BK % 16 == 0 && DT % 2 == 0, "tile shape");

  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem);  // [BQ][LD]
  __nv_bfloat16* Ks = Qs + BQ * LD;                             // [BK][LD]
  __nv_bfloat16* Vs = Ks + BK * LD;                             // [BK][LD]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;  // mma fragment row group, column pair
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;  // heaviest causal tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const size_t q_stride = (size_t)Hq * D, kv_stride = (size_t)Hkv * D;
  const __nv_bfloat16* qb = q + (size_t)b * Sq * q_stride + (size_t)h * D;
  const __nv_bfloat16* kb = k + (size_t)b * Skv * kv_stride + (size_t)hk * D;
  const __nv_bfloat16* vb = v + (size_t)b * Skv * kv_stride + (size_t)hk * D;
  __nv_bfloat16* ob = o + (size_t)b * Sq * q_stride + (size_t)h * D;

  // the keys any row of this tile may see: [kbeg, kend)
  int kend = kv_len;
  if (causal) kend = min(kend, min(q0 + BQ, Sq));
  const int kbeg = window > 0 ? max(0, q0 - window + 1) : 0;
  const int t_first = kbeg / BK;
  const int t_end = kend > kbeg ? (kend + BK - 1) / BK : t_first;

  auto load_kv = [&](__nv_bfloat16* dst, const __nv_bfloat16* src, int tile) {
    const int k0 = tile * BK;
#pragma unroll
    for (int c = tid; c < BK * CH; c += THREADS) {
      const int r = c / CH, col = (c % CH) * 8;
      const bool in = (k0 + r < Skv) && (col < D);
      cp_async16(&dst[r * LD + col], in ? src + (size_t)(k0 + r) * kv_stride + col : src,
                 in ? 16 : 0);
    }
  };
  if (t_first < t_end) load_kv(Ks, kb, t_first);
  cp_async_commit();
  if (t_first < t_end) load_kv(Vs, vb, t_first);
  cp_async_commit();

  // q tile, scaled and rounded to bf16 as the reference's q * scale
  for (int c = tid; c < BQ * CH; c += THREADS) {
    const int r = c / CH, col = (c % CH) * 8;
    uint4 raw = make_uint4(0u, 0u, 0u, 0u);
    if (q0 + r < Sq && col < D)
      raw = *reinterpret_cast<const uint4*>(qb + (size_t)(q0 + r) * q_stride + col);
    __nv_bfloat16* e = reinterpret_cast<__nv_bfloat16*>(&raw);
#pragma unroll
    for (int i = 0; i < 8; ++i) e[i] = __float2bfloat16(__bfloat162float(e[i]) * scale);
    *reinterpret_cast<uint4*>(&Qs[r * LD + col]) = raw;
  }

  float acc[DT][4];
#pragma unroll
  for (int dt = 0; dt < DT; ++dt)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[dt][i] = 0.f;
  float m_run[2] = {NEG_INF, NEG_INF}, l_run[2] = {0.f, 0.f};
  const int qpos0 = q0 + warp * 16 + g;  // this thread's two rows: qpos0, qpos0 + 8
  const __nv_bfloat16* Qw = Qs + (warp * 16 + g) * LD + 2 * t4;

  for (int t = t_first; t < t_end; ++t) {
    cp_async_wait_1();  // K(t) has landed; V(t) may still be in flight
    __syncthreads();    // (the first pass also publishes the q tile)

    float s[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[nt][i] = 0.f;
#pragma unroll
    for (int kc = 0; kc < DP / 16; ++kc) {
      uint32_t a[4];
      a[0] = lds32(Qw + kc * 16);
      a[1] = lds32(Qw + 8 * LD + kc * 16);
      a[2] = lds32(Qw + kc * 16 + 8);
      a[3] = lds32(Qw + 8 * LD + kc * 16 + 8);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const __nv_bfloat16* kp = Ks + (nt * 8 + g) * LD + kc * 16 + 2 * t4;
        mma_bf16(s[nt], a, lds32(kp), lds32(kp + 8));
      }
    }
    __syncthreads();  // every warp is done with K(t)
    if (t + 1 < t_end) load_kv(Ks, kb, t + 1);
    cp_async_commit();

    // masks, then the online softmax of the reference
    const int k0 = t * BK;
    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int kpos = k0 + nt * 8 + 2 * t4 + (i & 1);
        const int qpos = qpos0 + (i >> 1) * 8;
        bool ok = kpos < kv_len;
        if (causal) ok = ok && kpos <= qpos;
        if (window > 0) ok = ok && (qpos - kpos) < window;
        if (!ok) s[nt][i] = NEG_INF;
        mx[i >> 1] = fmaxf(mx[i >> 1], s[nt][i]);
      }
    float corr[2], lsum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m_run[r], mx[r]);
      corr[r] = __expf(m_run[r] - m_new);
      m_run[r] = m_new;
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        s[nt][i] = __expf(s[nt][i] - m_run[i >> 1]);
        lsum[i >> 1] += s[nt][i];
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      lsum[r] += __shfl_xor_sync(0xffffffffu, lsum[r], 1);
      lsum[r] += __shfl_xor_sync(0xffffffffu, lsum[r], 2);
      l_run[r] = l_run[r] * corr[r] + lsum[r];
    }
#pragma unroll
    for (int dt = 0; dt < DT; ++dt) {
      acc[dt][0] *= corr[0];
      acc[dt][1] *= corr[0];
      acc[dt][2] *= corr[1];
      acc[dt][3] *= corr[1];
    }

    cp_async_wait_1();  // V(t) has landed; K(t + 1) may still be in flight
    __syncthreads();
#pragma unroll
    for (int kc = 0; kc < BK / 16; ++kc) {
      // P in v's dtype: the score accumulators of keys [16 kc, 16 kc + 16)
      // are exactly the A fragment of this k-step
      uint32_t a[4];
      a[0] = pack_bf16(s[2 * kc][0], s[2 * kc][1]);
      a[1] = pack_bf16(s[2 * kc][2], s[2 * kc][3]);
      a[2] = pack_bf16(s[2 * kc + 1][0], s[2 * kc + 1][1]);
      a[3] = pack_bf16(s[2 * kc + 1][2], s[2 * kc + 1][3]);
      const __nv_bfloat16* vp = Vs + (kc * 16 + (lane & 15)) * LD + (lane >> 4) * 8;
#pragma unroll
      for (int dt = 0; dt < DT; dt += 2) {
        uint32_t bv[4];  // B fragments of d-tiles dt and dt + 1
        ldmatrix_x4_trans(bv, vp + dt * 8);
        mma_bf16(acc[dt], a, bv[0], bv[1]);
        mma_bf16(acc[dt + 1], a, bv[2], bv[3]);
      }
    }
    __syncthreads();  // every warp is done with V(t)
    if (t + 1 < t_end) load_kv(Vs, vb, t + 1);
    cp_async_commit();
  }
  cp_async_wait_all();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qpos = qpos0 + r * 8;
    if (qpos >= Sq) continue;
    const float l = fmaxf(l_run[r], 1e-30f);
    __nv_bfloat16* orow = ob + (size_t)qpos * q_stride + 2 * t4;
#pragma unroll
    for (int dt = 0; dt < DT; ++dt)
      if (dt * 8 < D)
        *reinterpret_cast<uint32_t*>(orow + dt * 8) =
            pack_bf16(acc[dt][2 * r] / l, acc[dt][2 * r + 1] / l);
  }
}

// ---------------------------------------------------------------------------
// f32: one warp per q row on the CUDA cores
// ---------------------------------------------------------------------------

constexpr int F_WARPS = 4;
constexpr int F_PER_LANE = 8;  // D <= 256 = 32 lanes x 8

__global__ void __launch_bounds__(F_WARPS * 32)
flash_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, float* __restrict__ o, int Sq, int Skv, int Hq,
              int Hkv, int D, float scale, int causal, int window, int kv_len) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * F_WARPS + (threadIdx.x >> 5);
  const int h = blockIdx.y, b = blockIdx.z;
  if (row >= Sq) return;
  const int hk = h / (Hq / Hkv);
  const float* qr = q + (((size_t)b * Sq + row) * Hq + h) * D;
  float qv[F_PER_LANE], acc[F_PER_LANE];
#pragma unroll
  for (int i = 0; i < F_PER_LANE; ++i) {
    const int d = lane + 32 * i;
    qv[i] = d < D ? qr[d] * scale : 0.f;
    acc[i] = 0.f;
  }
  // exactly the keys this row may see
  int kend = kv_len;
  if (causal) kend = min(kend, row + 1);
  const int kbeg = window > 0 ? max(0, row - window + 1) : 0;
  float m = NEG_INF, l = 0.f;
  for (int j = kbeg; j < kend; ++j) {
    const size_t off = (((size_t)b * Skv + j) * Hkv + hk) * D;
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < F_PER_LANE; ++i) {
      const int d = lane + 32 * i;
      if (d < D) s = fmaf(qv[i], k[off + d], s);
    }
#pragma unroll
    for (int w = 16; w > 0; w >>= 1) s += __shfl_xor_sync(0xffffffffu, s, w);
    const float m_new = fmaxf(m, s);
    const float corr = expf(m - m_new), p = expf(s - m_new);
    l = l * corr + p;
#pragma unroll
    for (int i = 0; i < F_PER_LANE; ++i) {
      const int d = lane + 32 * i;
      if (d < D) acc[i] = fmaf(p, v[off + d], acc[i] * corr);
    }
    m = m_new;
  }
  float* orow = o + (((size_t)b * Sq + row) * Hq + h) * D;
  const float lc = fmaxf(l, 1e-30f);
#pragma unroll
  for (int i = 0; i < F_PER_LANE; ++i) {
    const int d = lane + 32 * i;
    if (d < D) orow[d] = acc[i] / lc;
  }
}

template <int DP, int BK>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, void* o, int B, int Sq,
                        int Skv, int Hq, int Hkv, int D, float scale, int causal, int window,
                        int kv_len, cudaStream_t stream) {
  const int smem = (BQ + 2 * BK) * (DP + 8) * (int)sizeof(__nv_bfloat16);
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_bf16<DP, BK>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Sq + BQ - 1) / BQ, Hq, B);
  flash_fwd_bf16<DP, BK><<<grid, THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), Sq, Skv, Hq, Hkv,
      D, scale, causal, window, kv_len);
  return cudaGetLastError();
}

}  // namespace

extern "C" int flash_attention_launch(const void* q, const void* k, const void* v, void* o,
                                      int B, int Sq, int Skv, int Hq, int Hkv, int D,
                                      float scale, int causal, int window, int kv_len,
                                      int dtype, void* stream) {
  if (B <= 0 || Sq <= 0 || Skv <= 0 || Hq <= 0 || Hkv <= 0 || Hq % Hkv != 0 || D < 8 ||
      D > 256 || D % 8 != 0 || kv_len < 1 || kv_len > Skv || window < 0 ||
      (dtype != DT_F32 && dtype != DT_BF16))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == DT_F32) {
    dim3 grid((Sq + F_WARPS - 1) / F_WARPS, Hq, B);
    flash_fwd_f32<<<grid, F_WARPS * 32, 0, s>>>(
        static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
        static_cast<float*>(o), Sq, Skv, Hq, Hkv, D, scale, causal, window, kv_len);
    return static_cast<int>(cudaGetLastError());
  }
  cudaError_t err;
  if (D <= 32)
    err = launch_bf16<32, 64>(q, k, v, o, B, Sq, Skv, Hq, Hkv, D, scale, causal, window, kv_len, s);
  else if (D <= 64)
    err = launch_bf16<64, 64>(q, k, v, o, B, Sq, Skv, Hq, Hkv, D, scale, causal, window, kv_len, s);
  else if (D <= 128)
    err = launch_bf16<128, 64>(q, k, v, o, B, Sq, Skv, Hq, Hkv, D, scale, causal, window, kv_len, s);
  else if (D <= 192)
    err = launch_bf16<192, 32>(q, k, v, o, B, Sq, Skv, Hq, Hkv, D, scale, causal, window, kv_len, s);
  else
    err = launch_bf16<256, 32>(q, k, v, o, B, Sq, Skv, Hq, Hkv, D, scale, causal, window, kv_len, s);
  return static_cast<int>(err);
}
