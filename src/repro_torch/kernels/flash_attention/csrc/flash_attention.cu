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
// one (q tile, q head, batch) and loops over the KV tiles itself, with m and
// l in registers and the f32 accumulator in tensor-core fragments, and
// writes its output rows once.
//
// Numerics kept from the reference, step for step:
//   * q is multiplied by the scale in q's own dtype (a bf16 rounding for
//     bf16; the wrapper passes the scale already rounded to that dtype);
//   * scores are f32; a masked score is the finite -1e30, and the masks are
//     the reference's comparisons: k_pos < kv_len, causal k_pos <= q_pos
//     (both counted from 0, also when Sq != Skv), window q_pos - k_pos <
//     window;
//   * p = exp(s - m) is cast to v's dtype before PV, m being the running
//     max over every key tile seen so far, this one whole; l sums the f32 p
//     (exp is the fast ex2-based one; the wgmma mainloop flushes a p below
//     2**-126 to 0: exp_ftz);
//   * out = acc / max(l, 1e-30), cast to q's dtype;
//   * GQA reads kv head h / G in place; KV heads are never repeated.
// KV tiles that are wholly masked for every row of the q tile (causal,
// window, kv_len) are skipped. The reference visits them, but for a row
// that sees any key their weight is wiped by the rescale exp(-1e30 - m) = 0.
// A row that may attend to no key at all is outside the contract (the
// Pallas kernel and naive_attention already disagree there); the serving
// engine never makes one, since a causal row always sees key 0.
//
// Three mainloops; the caller picks one (flash_attention.py::flash_plan,
// from D and the dtype only) and passes it in with its key tile:
//   * wgmma (bf16, D = 64 and 128: every served head dim). Key tiles of
//     BK = 128, aligned at multiples of 128 from key 0. One block per (128-
//     row q tile, q head, batch), 384 threads. Warpgroup 0 is the
//     producer: it hands its registers to the consumers (setmaxnreg) and
//     one thread issues TMA loads (4-D tensor maps over q, k, v as stored,
//     dims {D, H, S, B}, boxes of {64 d, 1 head, 128 rows, 1 batch}, 128-
//     byte swizzle; a D = 128 tile is two boxes; rows past S arrive as
//     zeros, never as the next batch's) of the q tile once, then of the K
//     and V tiles into rings of two slots each, every slot guarded by a
//     full and an empty mbarrier. Warpgroups 1 and 2 own rows [0, 64) and
//     [64, 128) of the tile: they scale their rows of the q slot in place
//     (bf16 q * scale, element by element; the swizzle does not matter),
//     fence the generic proxy's writes against wgmma's reads and sync on a
//     named barrier, then per key tile:
//       - S = Q K^T by wgmma m64n128k16, A and B both K-major from shared
//         memory; the K slot is given back once wgmma.wait_group shows the
//         product done;
//       - masks only on a tile that crosses the causal diagonal, the window
//         edge or kv_len for this warpgroup's rows; the tile's row max (two
//         shuffles across the 4 threads of a row) before any p; p = exp(s -
//         m) and l in f32, in the score registers;
//       - O = O * corr + P V by wgmma m64n{D}k16 with A = P packed to bf16
//         in registers (the RS form: the accumulator layout of S is the A
//         fragment layout of PV, so P never touches shared memory) and B =
//         the V tile, MN-major; the V slot is given back once the product
//         is done.
//     Tile t + 1's QK^T is issued before tile t's PV, so the tensor cores
//     run PV(t) while the warpgroup computes tile t + 1's softmax (the
//     rescale of O waits for PV(t) to finish); each batch of products is
//     its own wgmma stage (fence, products, commit), and the registers are
//     pinned around the waits, or ptxas serialises the products. Output rows are stored as
//     bf16 straight from the accumulators, guarded at Sq. Blocks walk q
//     heads fastest and q tiles slowest, heaviest causal tiles first, so
//     the G q heads of a KV head run together and share its tiles in L2.
//   * mma (bf16, every other D): mma.sync.m16n8k16, 4 warps x 16 q rows,
//     KV tiles of 64 keys (32 for D > 128), the design of the first port.
//     The score tile stays in registers as above. D is zero-filled in
//     shared memory up to the next of 32/64/128/192/256. cp.async brings
//     the next K tile while the softmax and PV of this one run, and the
//     next V tile while the next QK^T runs.
//   * simt (f32): one warp per q row on the CUDA cores (FMA, full f32,
//     never TF32), walking exactly the keys its row may see.
//   Ragged Sq and Skv are masked in the kernels (zero-filled loads,
//   guarded stores), so the wrapper pads nothing. A row's output depends on
//   its own q row, its keys and the key tile only: the same at any Sq, in
//   any batch lane and any q tile.
//
// What bounds it on the H100: at long prompts operations (QK^T and PV are
// 4 D FLOPs per unmasked (q, k) pair: at granite-8b's [4, 2048, 32, 128]
// causal prefill 0.14 ms at 989 TFLOP/s against 0.05 ms of bytes), at short
// ones bytes (at [4, 256, 32, 128], 21 MB of q/k/v/o: 6 us against 2 us of
// operations). Only wgmma reaches the tensor cores' full rate; the design
// keeps the q tile in shared memory and the score, P and output tiles in
// registers for the whole KV loop, so device memory sees each q row once
// and each output row once, K/V tiles are re-read by the Sq/128 x G blocks
// of their head mostly from L2, and loads run ahead of the products in
// the ring. Causal work is halved by skipping masked tiles. Not persistent,
// no clusters, no ping-pong between the two consumer warpgroups beyond
// what the warp schedulers interleave by themselves.
//
// C interface (bound with ctypes): flash_attention_launch returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue for a plan
// the dtype, head dim or alignment does not allow or a tensor map
// cuTensorMapEncodeTiled refuses; the caller raises when it is not 0.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "../../csrc/hopper.cuh"  // mbarriers, TMA, wgmma, tensor maps

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int THREADS = 128;  // mma: 4 warps
constexpr int BQ = 64;        // mma: q rows per block, 16 per warp
enum DType { DT_F32 = 0, DT_BF16 = 1 };
enum Mainloop { ML_MMA = 0, ML_WGMMA = 1, ML_SIMT = 2 };  // flash_attention.py::MAINLOOPS

// 16-byte asynchronous copy global -> shared; src_bytes = 0 writes zeros.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
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
               : "r"(smem_u32(p)));
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
// bf16 at D = 64 and 128: a TMA ring feeding wgmma
// ---------------------------------------------------------------------------

constexpr int WG_BQ = 128;       // q rows per block: 64 per consumer warpgroup
constexpr int WG_BK = 128;       // keys per tile (flash_attention.py::WGMMA_BLOCK_K)
constexpr int WG_THREADS = 384;  // producer + 2 consumer warpgroups
constexpr int BOX_ROW = 128;     // bytes of one box row: 64 bf16 of d, 128-byte swizzled
// K and V slots each: 2 + 2 tiles in flight. A third slot (225 KB at D =
// 128) and FA3's ping-pong between the consumer warpgroups both ran no
// faster in one-off card probes (PERF.md, PR 18), so neither is built.
constexpr int WG_STAGES = 2;

template <int D>
struct WgTile {
  static_assert(D == 64 || D == 128, "wgmma head dims");
  static constexpr int BOXES = D / 64;                        // 64-wide d boxes a row
  static constexpr int Q_BOX = WG_BQ * BOX_ROW;               // 16 KB
  static constexpr int KV_BOX = WG_BK * BOX_ROW;              // 16 KB
  static constexpr int Q_BYTES = BOXES * Q_BOX;
  static constexpr int KV_BYTES = BOXES * KV_BOX;             // one K or V tile
  // + room to align the tiles to the swizzle's 1024-byte period
  static constexpr int SMEM = Q_BYTES + 2 * WG_STAGES * KV_BYTES + 1024;
};

// exp(x) as __expf computes it (ex2.approx of x * log2 e), with a result
// below 2**-126 flushed to 0. __expf spends an extra compare and two
// predicated multiplies per element only to make such subnormal results,
// and ran slower in a one-off card probe (PERF.md, PR 18). Such a p adds
// under 2**-126 |v| to a row whose l is at least 1 (its max key has p =
// 1), and such a corr scales the old sum by under 2**-126 against the new
// max key's p = 1.
__device__ __forceinline__ float exp_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x * 1.4426950408889634f));
  return y;
}

// Rows g and g + 8 of this thread's 16-row warp slice: the score tile s
// (s[4 i + 2 r + e]: row r's key 8 i + 2 t4 + e of the tile) becomes p =
// exp(s - m_new) in place, masked first where `mask` to the keys [lo[r],
// hi[r]] that row r may see; m, l move on and corr is the rescale
// exp(m_old - m_new) of the rows' accumulators.
__device__ __forceinline__ void softmax_tile(float (&s)[64], float (&m_run)[2],
                                             float (&l_run)[2], float (&corr)[2], bool mask,
                                             int k0, int t4, const int (&lo)[2],
                                             const int (&hi)[2]) {
  if (mask) {
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      const int kpos = k0 + (i / 4) * 8 + 2 * t4 + (i & 1), r = (i >> 1) & 1;
      if (kpos < lo[r] || kpos > hi[r]) s[i] = NEG_INF;
    }
  }
  float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
  for (int i = 0; i < 64; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float m_new = fmaxf(m_run[r], mx[r]);
    corr[r] = exp_ftz(m_run[r] - m_new);
    m_run[r] = m_new;
  }
  float lsum[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    s[i] = exp_ftz(s[i] - m_run[(i >> 1) & 1]);
    lsum[(i >> 1) & 1] += s[i];
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    lsum[r] += __shfl_xor_sync(0xffffffffu, lsum[r], 1);
    lsum[r] += __shfl_xor_sync(0xffffffffu, lsum[r], 2);
    l_run[r] = l_run[r] * corr[r] + lsum[r];
  }
}

template <int D>
__global__ void __launch_bounds__(WG_THREADS, 1)
flash_fwd_bf16_wgmma(const __grid_constant__ CUtensorMap tmap_q,
                     const __grid_constant__ CUtensorMap tmap_k,
                     const __grid_constant__ CUtensorMap tmap_v, __nv_bfloat16* __restrict__ o,
                     int Sq, int Hq, int Hkv, float scale, int causal, int window, int kv_len) {
  using Tile = WgTile<D>;
  constexpr int STAGES = WG_STAGES;
  constexpr int BOXES = Tile::BOXES;
  constexpr int KC = WG_BK / 16;  // k16 steps of PV
  extern __shared__ uint8_t fa_smem_raw[];
  __shared__ __align__(8) uint64_t q_full;
  __shared__ __align__(8) uint64_t k_full[STAGES], k_empty[STAGES];
  __shared__ __align__(8) uint64_t v_full[STAGES], v_empty[STAGES];
  uint8_t* const Qs = fa_smem_raw + ((1024 - (smem_u32(fa_smem_raw) & 1023)) & 1023);
  uint8_t* const Ks = Qs + Tile::Q_BYTES;           // STAGES K tiles
  uint8_t* const Vs = Ks + STAGES * Tile::KV_BYTES;  // STAGES V tiles

  const int tid = threadIdx.x, wg = tid / 128;
  const int head = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * WG_BQ;  // heaviest causal tiles first
  const int hk = head / (Hq / Hkv);

  // the key tiles any row of this q tile may see: [t_first, t_first + n_tiles)
  int kend = kv_len;
  if (causal) kend = min(kend, min(q0 + WG_BQ, Sq));
  const int kbeg = window > 0 ? max(0, q0 - window + 1) : 0;
  const int t_first = kbeg / WG_BK;
  const int n_tiles = kend > kbeg ? (kend + WG_BK - 1) / WG_BK - t_first : 0;

  if (tid == 0) {
    mbar_init(&q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&k_full[s], 1);   // the producer's arrive, plus the bytes
      mbar_init(&v_full[s], 1);
      mbar_init(&k_empty[s], 8);  // one arrive per consumer warp
      mbar_init(&v_empty[s], 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (tid == 0) {
      mbar_expect_tx(&q_full, Tile::Q_BYTES);
      for (int j = 0; j < BOXES; ++j)
        tma_load_4d(Qs + j * Tile::Q_BOX, &tmap_q, &q_full, 64 * j, head, q0, b);
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % STAGES, k0 = (t_first + i) * WG_BK;
        const int parity = (i / STAGES - 1) & 1;  // the slot's previous release
        if (i >= STAGES) mbar_wait(&k_empty[s], parity);
        mbar_expect_tx(&k_full[s], Tile::KV_BYTES);
        for (int j = 0; j < BOXES; ++j)
          tma_load_4d(Ks + s * Tile::KV_BYTES + j * Tile::KV_BOX, &tmap_k, &k_full[s], 64 * j,
                      hk, k0, b);
        if (i >= STAGES) mbar_wait(&v_empty[s], parity);
        mbar_expect_tx(&v_full[s], Tile::KV_BYTES);
        for (int j = 0; j < BOXES; ++j)
          tma_load_4d(Vs + s * Tile::KV_BYTES + j * Tile::KV_BOX, &tmap_v, &v_full[s], 64 * j,
                      hk, k0, b);
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
  const int c = wg - 1;  // this warpgroup's 64-row half of the tile
  const int u = tid % 128, lane = tid % 32;
  const int t4 = lane % 4;
  const int r_lo = q0 + c * 64, r_hi = r_lo + 63;    // its rows
  const int qpos0 = r_lo + (u / 32) * 16 + lane / 4;  // this thread's: qpos0, qpos0 + 8
  // the keys each of the two rows may see: [lo, hi] (the reference's
  // k_pos < kv_len, causal k_pos <= q_pos, window q_pos - k_pos < window)
  int lo[2], hi[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qpos = qpos0 + 8 * r;
    hi[r] = causal ? min(kv_len - 1, qpos) : kv_len - 1;
    lo[r] = window > 0 ? qpos - window + 1 : 0;
  }

  // q * scale rounded to bf16, in place: this warpgroup's 64 rows are 8 KB
  // of each box
  mbar_wait(&q_full, 0);
#pragma unroll
  for (int j = 0; j < BOXES; ++j) {
    uint4* rows = reinterpret_cast<uint4*>(Qs + j * Tile::Q_BOX + c * 64 * BOX_ROW);
#pragma unroll
    for (int x = u; x < 64 * BOX_ROW / 16; x += 128) {
      uint4 raw = rows[x];
      __nv_bfloat16* e = reinterpret_cast<__nv_bfloat16*>(&raw);
#pragma unroll
      for (int n = 0; n < 8; ++n) e[n] = __float2bfloat16(__bfloat162float(e[n]) * scale);
      rows[x] = raw;
    }
  }
  fence_proxy_async_smem();       // the writes above, before wgmma reads them
  named_barrier_sync(1 + c, 128);  // every thread of the warpgroup

  float sacc[64];     // scores, then p, of the current key tile
  float oacc[D / 2];  // the output rows' f32 accumulators (m64nD)
  uint32_t pa[KC][4];  // P of the previous tile in bf16: PV's A fragments
#pragma unroll
  for (int i = 0; i < 64; ++i) sacc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < D / 2; ++i) oacc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < KC; ++i) pa[i][0] = pa[i][1] = pa[i][2] = pa[i][3] = 0u;
  float m_run[2] = {NEG_INF, NEG_INF}, l_run[2] = {0.f, 0.f}, corr[2];
  const uint8_t* const Qc = Qs + c * 64 * BOX_ROW;

  // Each batch of products is its own wgmma pipeline stage: a fence, the
  // products, a commit. fence_regs around it and after each wait keeps
  // every other access to its registers outside the stage, so ptxas need
  // not serialise the products.
  // S = Q K^T of tile i into sacc (issued and committed, not waited)
  auto issue_qk = [&](int i) {
    const uint8_t* k = Ks + (i % STAGES) * Tile::KV_BYTES;
    fence_regs(sacc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      // k16 is 32 bytes along the swizzled row, 8-row groups 1024 B apart
      wgmma_m64n128k16<0>(sacc,
                          sw128_desc(Qc + (kk / 4) * Tile::Q_BOX + (kk % 4) * 32, 16, 1024),
                          sw128_desc(k + (kk / 4) * Tile::KV_BOX + (kk % 4) * 32, 16, 1024),
                          kk > 0);
    wgmma_commit();
    fence_regs(sacc);
  };
  // O += P V of tile i (P in pa; issued and committed, not waited)
  auto issue_pv = [&](int i) {
    const uint8_t* v = Vs + (i % STAGES) * Tile::KV_BYTES;
    fence_regs(oacc);
    fence_regs(pa);
    wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < KC; ++kc) {
      // MN-major V: k16 is 16 key rows (2048 B), the d 64-127 box KV_BOX on
      const uint64_t dv = sw128_desc(v + kc * 16 * BOX_ROW, Tile::KV_BOX, 1024);
      if constexpr (D == 128)
        wgmma_m64n128k16_rs<1>(oacc, pa[kc], dv, 1);
      else
        wgmma_m64n64k16_rs<1>(oacc, pa[kc], dv, 1);
    }
    wgmma_commit();
    fence_regs(oacc);
    fence_regs(pa);
  };
  auto release = [&](uint64_t* bar) {
    if (lane == 0) mbar_arrive(bar);
  };
  auto softmax = [&](int i) {
    const int k0 = (t_first + i) * WG_BK;
    const bool mask = k0 + WG_BK > kv_len || (causal && k0 + WG_BK - 1 > r_lo) ||
                      (window > 0 && r_hi - k0 >= window);
    softmax_tile(sacc, m_run, l_run, corr, mask, k0, t4, lo, hi);
  };
  auto pack_p = [&]() {
#pragma unroll
    for (int kc = 0; kc < KC; ++kc) {
      // keys [16 kc, 16 kc + 16) of rows g and g + 8: n-tiles 2 kc and 2 kc + 1
      pa[kc][0] = pack_bf16(sacc[8 * kc + 0], sacc[8 * kc + 1]);
      pa[kc][1] = pack_bf16(sacc[8 * kc + 2], sacc[8 * kc + 3]);
      pa[kc][2] = pack_bf16(sacc[8 * kc + 4], sacc[8 * kc + 5]);
      pa[kc][3] = pack_bf16(sacc[8 * kc + 6], sacc[8 * kc + 7]);
    }
  };

  auto wait_k = [&](int i) { mbar_wait(&k_full[i % STAGES], (i / STAGES) & 1); };
  auto wait_v = [&](int i) { mbar_wait(&v_full[i % STAGES], (i / STAGES) & 1); };
  if (n_tiles > 0) {
    // tile 0: S, then P (O is still 0: no rescale)
    wait_k(0);
    issue_qk(0);
    wgmma_wait<0>();
    fence_regs(sacc);
    release(&k_empty[0]);
    softmax(0);
    pack_p();
    for (int i = 1; i < n_tiles; ++i) {
      wait_k(i);
      wait_v(i - 1);
      issue_qk(i);
      issue_pv(i - 1);
      wgmma_wait<1>();  // QK^T(i) is done; PV(i - 1) may still run
      fence_regs(sacc);
      release(&k_empty[i % STAGES]);
      softmax(i);
      wgmma_wait<0>();  // PV(i - 1) is done: O may be rescaled, pa rewritten
      fence_regs(oacc);
      fence_regs(pa);
      release(&v_empty[(i - 1) % STAGES]);
#pragma unroll
      for (int n = 0; n < D / 2; ++n) oacc[n] *= corr[(n >> 1) & 1];
      pack_p();
    }
    wait_v(n_tiles - 1);
    issue_pv(n_tiles - 1);
    wgmma_wait<0>();
    fence_regs(oacc);
  }

  // oacc[4 i + 2 r + e]: row qpos0 + 8 r, column 8 i + 2 t4 + e
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qpos = qpos0 + r * 8;
    if (qpos >= Sq) continue;
    const float l = fmaxf(l_run[r], 1e-30f);
    __nv_bfloat16* orow = o + ((size_t)b * Sq + qpos) * Hq * D + (size_t)head * D + 2 * t4;
#pragma unroll
    for (int i = 0; i < D / 8; ++i)
      *reinterpret_cast<uint32_t*>(orow + i * 8) =
          pack_bf16(oacc[4 * i + 2 * r] / l, oacc[4 * i + 2 * r + 1] / l);
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

// Tensor map of a [B, S, H, D] bf16 tensor as stored (dims {D, H, S, B}),
// box {64 d, 1 head, rows, 1 batch}, 128-byte swizzle, zeros out of
// bounds: a box that reaches past S stops at its own batch's end. False if
// refused.
bool make_bshd_tmap(CUtensorMap* map, const void* base, int B, int S, int H, int D, int rows) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return false;
  cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)S, (cuuint64_t)B};
  cuuint64_t strides[3] = {(cuuint64_t)D * 2, (cuuint64_t)H * D * 2, (cuuint64_t)S * H * D * 2};
  cuuint32_t box[4] = {64, 1, (cuuint32_t)rows, 1};
  cuuint32_t elem_strides[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims, strides,
            box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}


template <int D>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v, void* o, int B, int Sq,
                         int Skv, int Hq, int Hkv, float scale, int causal, int window,
                         int kv_len, cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  if (!make_bshd_tmap(&tq, q, B, Sq, Hq, D, WG_BQ) ||
      !make_bshd_tmap(&tk, k, B, Skv, Hkv, D, WG_BK) ||
      !make_bshd_tmap(&tv, v, B, Skv, Hkv, D, WG_BK))
    return cudaErrorInvalidValue;
  auto kernel = flash_fwd_bf16_wgmma<D>;
  static uint64_t done = 0;
  cudaError_t e = allow_smem(kernel, WgTile<D>::SMEM, done);
  if (e != cudaSuccess) return e;
  dim3 grid(Hq, B, (Sq + WG_BQ - 1) / WG_BQ);
  kernel<<<grid, WG_THREADS, WgTile<D>::SMEM, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), Sq, Hq, Hkv, scale, causal, window, kv_len);
  return cudaGetLastError();
}

}  // namespace

// mainloop and block_k: flash_attention.py::flash_plan's, as ints (mainloop
// 0 mma, 1 wgmma, 2 simt); refused unless the dtype, head dim, key tile and
// alignment allow them: simt for f32 (block_k 1, key by key); mma for bf16
// (block_k 64, 32 past D = 128); wgmma for bf16 at D = 64 and 128 (block_k
// 128) with q, k, v 16-byte aligned (TMA needs it).
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v, void* o,
                                      int B, int Sq, int Skv, int Hq, int Hkv, int D,
                                      float scale, int causal, int window, int kv_len,
                                      int dtype, int mainloop, int block_k, void* stream) {
  auto aligned = [](const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; };
  if (B <= 0 || Sq <= 0 || Skv <= 0 || Hq <= 0 || Hkv <= 0 || Hq % Hkv != 0 || D < 8 ||
      D > 256 || D % 8 != 0 || kv_len < 1 || kv_len > Skv || window < 0 || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool plan_ok =
      dtype == DT_F32 ? mainloop == ML_SIMT && block_k == 1
      : dtype != DT_BF16 ? false
      : mainloop == ML_MMA ? block_k == (D <= 128 ? 64 : 32) && Hq <= 65535
      : mainloop == ML_WGMMA ? (D == 64 || D == 128) && block_k == WG_BK && aligned(q) &&
                                   aligned(k) && aligned(v) && (Sq + WG_BQ - 1) / WG_BQ <= 65535
                             : false;
  if (!plan_ok) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == DT_F32) {
    if (Hq > 65535) return static_cast<int>(cudaErrorInvalidValue);
    dim3 grid((Sq + F_WARPS - 1) / F_WARPS, Hq, B);
    flash_fwd_f32<<<grid, F_WARPS * 32, 0, s>>>(
        static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
        static_cast<float*>(o), Sq, Skv, Hq, Hkv, D, scale, causal, window, kv_len);
    return static_cast<int>(cudaGetLastError());
  }
  cudaError_t err;
  if (mainloop == ML_WGMMA)
    err = D == 64 ? launch_wgmma<64>(q, k, v, o, B, Sq, Skv, Hq, Hkv, scale, causal, window,
                                     kv_len, s)
                  : launch_wgmma<128>(q, k, v, o, B, Sq, Skv, Hq, Hkv, scale, causal, window,
                                      kv_len, s);
  else if (D <= 32)
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
