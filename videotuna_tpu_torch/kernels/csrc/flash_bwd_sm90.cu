// Single-pass flash-attention backward for Hopper (sm_90a), bf16, head
// width 64 or 128, non-causal, no key mask: TMA loads, wgmma products, a
// producer warpgroup and two consumer warpgroups.
//
// Replaces, at D = 64, the TPU kernel K7 of the JAX package,
// `_flash_bwd_packed2_fused_kernel` in `_flash_bwd_packed2`
// (videotuna_tpu/kernels/attention.py:1424, :1517), the single-pass d=64
// backward of CogVideoX training, and by mapping its two-kernel baseline
// K10 (`_flash_bwd_packed2_dkv_kernel` + `_flash_bwd_packed2_dq_kernel`,
// :1260, :1343), which computes the same function.  At D = 128 it replaces
// K8, `_flash_bwd_fused_kernel` launched by `flash_attention_bwd` (:1148,
// :1725; `pallas_call` at :1804), unmasked and non-causal, the backward of
// HunyuanVideo's joint attention in LoRA training (B=1, 7,456 tokens, H=24,
// d=128), and by mapping its two-kernel baseline K9
// (`_flash_bwd_dkv_kernel` + `_flash_bwd_dq_kernel`, :1107, :1197).  Like
// the TPU kernels, s, p and ds are computed once for all three gradients
// (5 products, where flash_bwd.cu's dq pass recomputes s and p: 7), and dq
// leaves each key tile as a partial sum that is added up outside the tile:
// here by f32 atomic adds into a scratch that stays in L2, where the TPU
// kernel writes per-key-tile partials that XLA sums.
//
// Function (that of flash_bwd.cu).  With s = (q.k) * sm_scale:
//   p  = exp(s - lse)      (lse clamped at -1e5, as the JAX kernels do)
//   delta_i = sum_d dO[i,d] o[i,d]
//   dv = p^T dO,  ds = p * (dO v^T - delta),
//   dq = sm_scale * ds k,  dk = sm_scale * ds^T q.
// p and ds are rounded to bf16 as operands of the products; delta, lse and
// every accumulator are f32.  The order of the f32 dq sums changes from run
// to run (atomics), so dq is not bit-for-bit reproducible; dk and dv are.
//
// What bounds it.  The 5 products are 10*Sq*Sk*d*B*H FLOP: at CogVideoX-2B's
// training shape (B=1, S=17,776, H=30, d=64) 6.07e12 FLOP, 6.13 ms at
// 989 TF/s, while q, k, v, o, dO, dq, dk, dv move 0.55 GB (0.16 ms at
// 3.35 TB/s); at HunyuanVideo's (B=1, S=7,456, H=24, d=128) 1.71e12 FLOP,
// 1.73 ms, against 0.18 GB (0.05 ms).  Bound by operations, so every
// product is a wgmma.  The exp2 (one a score) take about 2.3 ms of the
// special-function units at the 2B shape, 0.65 ms at HunyuanVideo's.
// Within a tile the five products and the exp2 depend on each other in a
// chain, and the two consumers meet at the dS^T barrier, so this design
// overlaps little: that chain and the dq adds are what stand between it
// and the bound.  The dq reduction adds a key tile's 64 x D f32 partial
// per query tile: 139 key tiles x 4.5 MB a head x 30 heads = 19 GB at the
// 2B shape, 59 x 3.8 MB x 24 = 5.4 GB at HunyuanVideo's; the grid puts the
// key tiles of one head next to each other in launch order, so that the
// blocks in flight walk the same dq rows together in L2.
//
// Kernels.
//   1. `bwd_sm90_prep_kernel<D>`: delta = rowsum(dO o) and
//      lse2 = max(lse, -1e5) * log2e per query row, into (B*H, Sq_pad) f32
//      rows padded to 64 (pad rows: lse2 = +inf, so p = 0, and delta = 0),
//      which the main kernel copies with 1-D bulk copies.
//   2. `flash_bwd_sm90_kernel<D>`: one block per (128-key tile, b*h), 384
//      threads:
//      warpgroup 0, the producer: one thread loads K and V once and walks
//        64-row query tiles (Q, dO, lse2 and delta) through a ring of two
//        stages, each with a full and an empty mbarrier;
//      warpgroups 1 and 2, the consumers, 64 keys each, with dK and dV in
//        f32 registers across the loop (D/2 each a thread).  Per query
//        tile:
//          S^T  = K Q^T and dP^T = V dO^T   (wgmma m64n64k16, shared
//                                            memory, K-major)
//          P^T  = exp2(S^T sm_scale log2e - lse2)
//          dV  += P^T dO                    (P^T from registers, dO through
//                                            the transpose bit, N = D)
//          dS^T = P^T (dP^T - delta)
//          dK  += dS^T Q                    (dS^T from registers, N = D)
//        dS^T is also written to shared memory (bf16, 128-byte swizzled)
//        and, after a barrier of the two consumers, each computes half the
//        columns of dQ_tile = dS K (wgmma m64n{D/2}k16, dS and K both read
//        MN-major) and adds it into the f32 scratch dq_acc (B*H, Sq_pad, D)
//        with vector atomic adds.
//   3. `bwd_sm90_dq_kernel<D>`: dq = sm_scale * dq_acc, as bf16
//      (B, Sq, H, D).
//
// Width 128.  A 128-byte-swizzle box holds 64 bf16 columns, so each K, V,
// Q and dO tile is two boxes, one after the other (sm90.cuh): the
// K-major products S^T and dP^T take their depth steps 0-3 from the first
// box and 4-7 from the second, and the MN-major products dV and dK read
// N = 128 as the two boxes a box apart (the descriptor's LBO).  A
// consumer's registers: dK and dV 64 each, S^T and dP^T 32 each (m64n64),
// P^T and dS^T 16 each as bf16 A fragments: about 210 of the 240 that
// setmaxnreg gives it.  So the dQ product (m64n64, the consumer's half of
// the columns: one box of K) accumulates into S^T's registers, which are
// dead by then, and every shared-memory descriptor is made per tile
// (`opaque`), not hoisted out of the loop into registers.
// Shared memory: K 16 KB + V 16 KB + 2 x (Q 8 KB + dO 8 KB + 512 B) +
// 2 x dS^T 16 KB = 97 KB at D = 64; K 32 KB + V 32 KB + 2 x (Q 16 KB +
// dO 16 KB + 512 B) + 2 x dS^T 16 KB = 161 KB at D = 128.

#include <math.h>

#include "sm90.cuh"

namespace {

using namespace sm90;

constexpr float LOG2E = 1.4426950408889634f;
constexpr int BLOCK_N = 128;  // keys a block owns, 64 per consumer
constexpr int BLOCK_M = 64;   // query rows a loop tile
constexpr int STAGES = 2;
constexpr int THREADS = 384;
constexpr int BAR_DS = 1;     // named barrier: both halves of dS^T stored

constexpr int DS_BYTES = BLOCK_N * 128;   // one dS^T tile (16 KB)
constexpr int STAT_BYTES = BLOCK_M * 4;   // one tile's lse2 or delta

template <int D>
struct Cfg {
  static_assert(D == 64 || D == 128, "head width 64 or 128");
  static constexpr int K_BOX = BLOCK_N * 128;   // a 64-column box of K or V
  static constexpr int Q_BOX = BLOCK_M * 128;   // a 64-column box of Q or dO
  static constexpr int KV_BYTES = D / 64 * K_BOX;  // one K or V tile
  static constexpr int ROW_BYTES = D / 64 * Q_BOX;  // one Q or dO tile
  static constexpr int OFF_K = 0;
  static constexpr int OFF_V = OFF_K + KV_BYTES;
  static constexpr int OFF_Q = OFF_V + KV_BYTES;             // STAGES tiles
  static constexpr int OFF_DO = OFF_Q + STAGES * ROW_BYTES;  // STAGES tiles
  static constexpr int OFF_DS = OFF_DO + STAGES * ROW_BYTES; // 2 tiles
  static constexpr int OFF_L = OFF_DS + 2 * DS_BYTES;        // STAGES rows
  static constexpr int OFF_DL = OFF_L + STAGES * STAT_BYTES; // STAGES rows
  static constexpr int OFF_BAR = OFF_DL + STAGES * STAT_BYTES;
  static constexpr int SMEM = OFF_BAR + 64 + 1024;  // + alignment slack
  // registers after setmaxnreg: the producer's and each consumer's
  static constexpr int PRODUCER_REGS = D == 64 ? 40 : 24;
  static constexpr int CONSUMER_REGS = D == 64 ? 232 : 240;
};

struct Params {
  const __nv_bfloat16* o;
  const __nv_bfloat16* dout;
  const float* lse;  // (B, H, Sq), natural log
  float* lse2;       // (B*H, Sq_pad): max(lse, -1e5) * log2e; +inf past Sq
  float* delta;      // (B*H, Sq_pad); 0 past Sq
  float* dq_acc;     // (B*H, Sq_pad, D), zeroed by the caller
  __nv_bfloat16* dq;
  __nv_bfloat16* dk;
  __nv_bfloat16* dv;
  int B, H, Sq, Sk, Sq_pad;
  long long o_sb, o_ss, o_sh;
  long long do_sb, do_ss, do_sh;
  long long dq_sb, dq_ss, dq_sh;
  long long dk_sb, dk_ss, dk_sh;
  long long dv_sb, dv_ss, dv_sh;
  float sm_scale;
  float scale_log2;  // sm_scale * log2(e)
};

// delta and lse2 of every padded query row; 8 threads a row, 8 columns of
// each 64-column half.
template <int D>
__global__ void bwd_sm90_prep_kernel(const Params p) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long row = t >> 3;
  const int part = threadIdx.x & 7;
  const bool live = row < (long long)p.B * p.H * p.Sq_pad;
  const int bh = live ? static_cast<int>(row / p.Sq_pad) : 0;
  const int i = live ? static_cast<int>(row % p.Sq_pad) : 0;
  float acc = 0.f;
  if (live && i < p.Sq) {
    const int b = bh / p.H;
    const int h = bh - b * p.H;
    #pragma unroll
    for (int half = 0; half < D / 64; ++half) {
      const uint4 ov = *reinterpret_cast<const uint4*>(
          p.o + b * p.o_sb + h * p.o_sh + i * p.o_ss + half * 64 + part * 8);
      const uint4 gv = *reinterpret_cast<const uint4*>(
          p.dout + b * p.do_sb + h * p.do_sh + i * p.do_ss + half * 64 +
          part * 8);
      const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(&ov);
      const __nv_bfloat162* g2 = reinterpret_cast<const __nv_bfloat162*>(&gv);
      #pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 of = __bfloat1622float2(o2[j]);
        const float2 gf = __bfloat1622float2(g2[j]);
        acc += of.x * gf.x + of.y * gf.y;
      }
    }
  }
  acc += __shfl_xor_sync(0xffffffff, acc, 1);
  acc += __shfl_xor_sync(0xffffffff, acc, 2);
  acc += __shfl_xor_sync(0xffffffff, acc, 4);
  if (live && part == 0) {
    p.delta[row] = acc;
    p.lse2[row] = i < p.Sq
                      ? fmaxf(p.lse[(long long)bh * p.Sq + i], -1e5f) * LOG2E
                      : INFINITY;
  }
}

// D (64 x N, f32) += A (64 x 16, bf16 registers) * B (16 x N, shared
// memory, MN-major), N = 64 or 128.
template <int N>
__device__ __forceinline__ void wgmma_rs_mn(float* d, const uint32_t* a,
                                            uint64_t db) {
  if constexpr (N == 128)
    wgmma_rs_n128<1>(d, a, db);
  else
    wgmma_rs_n64<1>(d, a, db);
}

// D (64 x N, f32) (+)= A (64 x 16) * B (16 x N), both in shared memory,
// MN-major, N = 32 or 64.
template <int N>
__device__ __forceinline__ void wgmma_ss_mn(float* d, uint64_t da,
                                            uint64_t db, int scale_d) {
  if constexpr (N == 64)
    wgmma_ss_n64<1, 1>(d, da, db, scale_d);
  else
    wgmma_ss_n32<1, 1>(d, da, db, scale_d);
}

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
    flash_bwd_sm90_kernel(const __grid_constant__ CUtensorMap tq,
               const __grid_constant__ CUtensorMap tk,
               const __grid_constant__ CUtensorMap tv,
               const __grid_constant__ CUtensorMap tdo, const Params p) {
  using C = Cfg<D>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  unsigned char* const base_ptr = smem_raw + (base - smem_u32(smem_raw));
  const uint32_t sK = base + C::OFF_K;
  const uint32_t sV = base + C::OFF_V;
  const uint32_t bars = base + C::OFF_BAR;
  const uint32_t bar_kv = bars;
  auto full = [&](int s) { return bars + 8 + 16 * s; };
  auto empty = [&](int s) { return bars + 16 + 16 * s; };

  const int n0 = blockIdx.x * BLOCK_N;
  const int bh = blockIdx.y;
  const int b = bh / p.H;
  const int h = bh - b * p.H;
  const int n_tiles = p.Sq_pad / BLOCK_M;
  const int wg = threadIdx.x >> 7;

  if (threadIdx.x == 0) {
    mbar_init(bar_kv, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 8);  // lane 0 of each consumer warp
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == 0) {
    // ------------------------------------------------------------ producer
    reg_dealloc<C::PRODUCER_REGS>();
    if (threadIdx.x == 0) {
      mbar_expect_tx(bar_kv, 2 * C::KV_BYTES);
      #pragma unroll
      for (int x = 0; x < D / 64; ++x) {
        tma_load_4d(sK + x * C::K_BOX, &tk, bar_kv, x * 64, h, n0, b);
        tma_load_4d(sV + x * C::K_BOX, &tv, bar_kv, x * 64, h, n0, b);
      }
      const long long stat0 = (long long)bh * p.Sq_pad;
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % STAGES;
        mbar_wait(empty(s), ((t / STAGES) & 1) ^ 1);
        mbar_expect_tx(full(s), 2 * C::ROW_BYTES + 2 * STAT_BYTES);
        #pragma unroll
        for (int x = 0; x < D / 64; ++x) {
          tma_load_4d(base + C::OFF_Q + s * C::ROW_BYTES + x * C::Q_BOX, &tq,
                      full(s), x * 64, h, t * BLOCK_M, b);
          tma_load_4d(base + C::OFF_DO + s * C::ROW_BYTES + x * C::Q_BOX,
                      &tdo, full(s), x * 64, h, t * BLOCK_M, b);
        }
        bulk_load(base + C::OFF_L + s * STAT_BYTES,
                  p.lse2 + stat0 + t * BLOCK_M, STAT_BYTES, full(s));
        bulk_load(base + C::OFF_DL + s * STAT_BYTES,
                  p.delta + stat0 + t * BLOCK_M, STAT_BYTES, full(s));
      }
    }
  } else {
    // ------------------------------------------------------------ consumers
    reg_alloc<C::CONSUMER_REGS>();
    const int c = wg - 1;  // which 64 keys
    const int warp = (threadIdx.x >> 5) & 3;
    const int lane = threadIdx.x & 31;
    const int g = lane >> 2;
    const int tig = lane & 3;
    const int krow = c * 64 + warp * 16 + g;  // key row in the tile; +8
    const bool key_ok[2] = {n0 + krow < p.Sk, n0 + krow + 8 < p.Sk};

    // dQ's accumulator: at D = 128 (m64n64) the registers of S^T, dead
    // once dS^T is packed; at D = 64 (m64n32) 16 of its own, because half
    // of S^T's m64n64 block as an m64n32 accumulator makes ptxas serialise
    // the wgmmas (C7511)
    float dk[D / 2], dv[D / 2], st[32], dpt[32], dq64[D == 64 ? 16 : 1];
    float* const dqa = D == 64 ? dq64 : st;
    #pragma unroll
    for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;
    #pragma unroll
    for (int i = 0; i < (D == 64 ? 16 : 1); ++i) dq64[i] = 0.f;
    uint32_t pa[4][4], dsa[4][4];
    // shared-memory offset of K-major depth step ks (16 columns) in a tile
    // of 64-column boxes `box` bytes apart
    auto step = [](int ks, int box) { return (ks >> 2) * box + (ks & 3) * 32; };

    mbar_wait(bar_kv, 0);
    for (int t = 0; t < n_tiles; ++t) {
      const int s = t % STAGES;
      mbar_wait(full(s), (t / STAGES) & 1);
      const uint32_t q_s = base + C::OFF_Q + s * C::ROW_BYTES;
      const uint32_t do_s = base + C::OFF_DO + s * C::ROW_BYTES;
      const float* lse2 =
          reinterpret_cast<const float*>(base_ptr + C::OFF_L + s * STAT_BYTES);
      const float* dl =
          reinterpret_cast<const float*>(base_ptr + C::OFF_DL + s * STAT_BYTES);

      // S^T = K Q^T, dP^T = V dO^T
      wgmma_fence();
      {
        const uint64_t dk_d = opaque(desc(sK + c * 8192, 16, 1024));
        const uint64_t dq_d = opaque(desc(q_s, 16, 1024));
        #pragma unroll
        for (int ks = 0; ks < D / 16; ++ks)
          wgmma_ss_n64<0, 0>(st, desc_add(dk_d, step(ks, C::K_BOX)),
                             desc_add(dq_d, step(ks, C::Q_BOX)), ks > 0);
      }
      wgmma_commit();
      {
        const uint64_t dv_d = opaque(desc(sV + c * 8192, 16, 1024));
        const uint64_t ddo_d = opaque(desc(do_s, 16, 1024));
        #pragma unroll
        for (int ks = 0; ks < D / 16; ++ks)
          wgmma_ss_n64<0, 0>(dpt, desc_add(dv_d, step(ks, C::K_BOX)),
                             desc_add(ddo_d, step(ks, C::Q_BOX)), ks > 0);
      }
      wgmma_commit();
      wgmma_wait<1>();

      // P^T = exp2(s sm_scale log2e - lse2); keys past Sk give 0
      #pragma unroll
      for (int nb = 0; nb < 8; ++nb)
        #pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int col = nb * 8 + tig * 2 + (i & 1);
          const float e =
              fast_exp2(fmaf(st[nb * 4 + i], p.scale_log2, -lse2[col]));
          st[nb * 4 + i] = key_ok[i >> 1] ? e : 0.f;
        }
      #pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        pa[kk][0] = pack_bf16(st[8 * kk + 0], st[8 * kk + 1]);
        pa[kk][1] = pack_bf16(st[8 * kk + 2], st[8 * kk + 3]);
        pa[kk][2] = pack_bf16(st[8 * kk + 4], st[8 * kk + 5]);
        pa[kk][3] = pack_bf16(st[8 * kk + 6], st[8 * kk + 7]);
      }
      // dV += P^T dO
      wgmma_fence();
      {
        const uint64_t ddo_d = opaque(desc(do_s, C::Q_BOX, 1024));
        #pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_rs_mn<D>(dv, pa[kk], desc_add(ddo_d, kk * 2048));
      }
      wgmma_commit();

      // dS^T = P^T (dP^T - delta)
      wgmma_wait<1>();
      #pragma unroll
      for (int nb = 0; nb < 8; ++nb)
        #pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int col = nb * 8 + tig * 2 + (i & 1);
          dpt[nb * 4 + i] = st[nb * 4 + i] * (dpt[nb * 4 + i] - dl[col]);
        }
      #pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        dsa[kk][0] = pack_bf16(dpt[8 * kk + 0], dpt[8 * kk + 1]);
        dsa[kk][1] = pack_bf16(dpt[8 * kk + 2], dpt[8 * kk + 3]);
        dsa[kk][2] = pack_bf16(dpt[8 * kk + 4], dpt[8 * kk + 5]);
        dsa[kk][3] = pack_bf16(dpt[8 * kk + 6], dpt[8 * kk + 7]);
      }
      // dK += dS^T Q
      wgmma_fence();
      {
        const uint64_t dq_d = opaque(desc(q_s, C::Q_BOX, 1024));
        #pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_rs_mn<D>(dk, dsa[kk], desc_add(dq_d, kk * 2048));
      }
      wgmma_commit();

      // dS^T to shared memory, rows = keys, 128-byte swizzled
      unsigned char* ds = base_ptr + C::OFF_DS + (t & 1) * DS_BYTES;
      #pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        #pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int key = krow + (j & 1) * 8;
          const int q = (2 * kk + (j >> 1)) * 8 + tig * 2;
          *reinterpret_cast<uint32_t*>(
              ds + key * 128 + (((q >> 3) ^ (key & 7)) << 4) + (q & 7) * 2) =
              dsa[kk][j];
        }
      fence_proxy_async();
      named_sync(BAR_DS, 256);

      // dQ_tile[:, (D/2)c : (D/2)(c + 1)] = dS K[:, (D/2)c : (D/2)(c + 1)]
      // (D = 64: 32 columns, half a box of K; D = 128: a box)
      wgmma_fence();
      {
        const uint32_t ds_s = base + C::OFF_DS + (t & 1) * DS_BYTES;
        const uint64_t dds_d = opaque(desc(ds_s, DS_BYTES, 1024));
        const uint64_t dkq_d = opaque(
            desc(sK + c * (D == 64 ? 64 : C::K_BOX), C::K_BOX, 1024));
        #pragma unroll
        for (int kk = 0; kk < BLOCK_N / 16; ++kk)
          wgmma_ss_mn<D / 2>(dqa, desc_add(dds_d, kk * 2048),
                             desc_add(dkq_d, kk * 2048), kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      __syncwarp();
      if (lane == 0) mbar_arrive(empty(s));

      float* acc = p.dq_acc + ((long long)bh * p.Sq_pad + t * BLOCK_M) * D;
      #pragma unroll
      for (int nb = 0; nb < D / 16; ++nb)
        #pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int row = warp * 16 + g + r * 8;
          const int col = c * (D / 2) + nb * 8 + tig * 2;
          atomicAdd(reinterpret_cast<float2*>(acc + row * D + col),
                    make_float2(dqa[nb * 4 + 2 * r], dqa[nb * 4 + 2 * r + 1]));
        }
    }

    #pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int key = n0 + krow + r * 8;
      if (key >= p.Sk) continue;
      __nv_bfloat16* kout = p.dk + b * p.dk_sb + h * p.dk_sh + key * p.dk_ss;
      __nv_bfloat16* vout = p.dv + b * p.dv_sb + h * p.dv_sh + key * p.dv_ss;
      #pragma unroll
      for (int nb = 0; nb < D / 8; ++nb) {
        const int col = nb * 8 + tig * 2;
        *reinterpret_cast<__nv_bfloat162*>(kout + col) =
            __floats2bfloat162_rn(dk[nb * 4 + 2 * r] * p.sm_scale,
                                  dk[nb * 4 + 2 * r + 1] * p.sm_scale);
        *reinterpret_cast<__nv_bfloat162*>(vout + col) =
            __floats2bfloat162_rn(dv[nb * 4 + 2 * r], dv[nb * 4 + 2 * r + 1]);
      }
    }
  }
}

// dq = sm_scale * dq_acc as bf16, 8 columns a thread.
template <int D>
__global__ void bwd_sm90_dq_kernel(const Params p) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (long long)p.B * p.H * p.Sq * (D / 8)) return;
  const int part = static_cast<int>(t % (D / 8));
  const long long row = t / (D / 8);  // (b, h, i)
  const int i = static_cast<int>(row % p.Sq);
  const int bh = static_cast<int>(row / p.Sq);
  const int b = bh / p.H;
  const int h = bh - b * p.H;
  const float4* src = reinterpret_cast<const float4*>(
      p.dq_acc + ((long long)bh * p.Sq_pad + i) * D + part * 8);
  const float4 x = src[0], y = src[1];
  uint4 out;
  out.x = pack_bf16(x.x * p.sm_scale, x.y * p.sm_scale);
  out.y = pack_bf16(x.z * p.sm_scale, x.w * p.sm_scale);
  out.z = pack_bf16(y.x * p.sm_scale, y.y * p.sm_scale);
  out.w = pack_bf16(y.z * p.sm_scale, y.w * p.sm_scale);
  *reinterpret_cast<uint4*>(p.dq + b * p.dq_sb + h * p.dq_sh + i * p.dq_ss +
                            part * 8) = out;
}

// The three launches at head width D: prep, the main kernel, dq.
template <int D>
int launch(const void* q, const void* k, const void* v, const void* dout,
           const Params& p, long long q_sb, long long q_ss, long long q_sh,
           long long k_sb, long long k_ss, long long k_sh, long long v_sb,
           long long v_ss, long long v_sh, cudaStream_t s) {
  CUtensorMap tq, tk, tv, tdo;
  int err = sm90_host::make_map(&tq, q, p.B, p.Sq, p.H, D, q_sb, q_ss, q_sh,
                                BLOCK_M);
  if (err == 0)
    err = sm90_host::make_map(&tk, k, p.B, p.Sk, p.H, D, k_sb, k_ss, k_sh,
                              BLOCK_N);
  if (err == 0)
    err = sm90_host::make_map(&tv, v, p.B, p.Sk, p.H, D, v_sb, v_ss, v_sh,
                              BLOCK_N);
  if (err == 0)
    err = sm90_host::make_map(&tdo, dout, p.B, p.Sq, p.H, D, p.do_sb,
                              p.do_ss, p.do_sh, BLOCK_M);
  if (err != 0) return err;

  const long long prep_threads = (long long)p.B * p.H * p.Sq_pad * 8;
  bwd_sm90_prep_kernel<D>
      <<<static_cast<unsigned>((prep_threads + 255) / 256), 256, 0, s>>>(p);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  auto kernel = flash_bwd_sm90_kernel<D>;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           Cfg<D>::SMEM);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((p.Sk + BLOCK_N - 1) / BLOCK_N, p.B * p.H);
  kernel<<<grid, THREADS, Cfg<D>::SMEM, s>>>(tq, tk, tv, tdo, p);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long dq_threads = (long long)p.B * p.H * p.Sq * (D / 8);
  bwd_sm90_dq_kernel<D>
      <<<static_cast<unsigned>((dq_threads + 255) / 256), 256, 0, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Returns the CUDA error of the launches (0 on success);
// cudaErrorInvalidValue for a head width other than 64 or 128, B*H above
// 65535 or a tensor TMA cannot read in place.  lse2 and delta are f32
// scratch of B*H*Sq_pad values, dq_acc of B*H*Sq_pad*d zeros, Sq_pad = Sq
// rounded up to 64, all allocated by the caller.
extern "C" int flash_bwd_sm90_bf16(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* lse2, void* delta, void* dq_acc,
    void* dq, void* dk, void* dv, int B, int H, int Sq, int Sk, int d,
    long long q_sb, long long q_ss, long long q_sh, long long k_sb,
    long long k_ss, long long k_sh, long long v_sb, long long v_ss,
    long long v_sh, long long o_sb, long long o_ss, long long o_sh,
    long long do_sb, long long do_ss, long long do_sh, long long dq_sb,
    long long dq_ss, long long dq_sh, long long dk_sb, long long dk_ss,
    long long dk_sh, long long dv_sb, long long dv_ss, long long dv_sh,
    float sm_scale, void* stream) {
  if ((d != 64 && d != 128) || B <= 0 || H <= 0 || Sq <= 0 || Sk <= 0 ||
      (long long)B * H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.o = static_cast<const __nv_bfloat16*>(o);
  p.dout = static_cast<const __nv_bfloat16*>(dout);
  p.lse = static_cast<const float*>(lse);
  p.lse2 = static_cast<float*>(lse2);
  p.delta = static_cast<float*>(delta);
  p.dq_acc = static_cast<float*>(dq_acc);
  p.dq = static_cast<__nv_bfloat16*>(dq);
  p.dk = static_cast<__nv_bfloat16*>(dk);
  p.dv = static_cast<__nv_bfloat16*>(dv);
  p.B = B;
  p.H = H;
  p.Sq = Sq;
  p.Sk = Sk;
  p.Sq_pad = (Sq + BLOCK_M - 1) / BLOCK_M * BLOCK_M;
  p.o_sb = o_sb;
  p.o_ss = o_ss;
  p.o_sh = o_sh;
  p.do_sb = do_sb;
  p.do_ss = do_ss;
  p.do_sh = do_sh;
  p.dq_sb = dq_sb;
  p.dq_ss = dq_ss;
  p.dq_sh = dq_sh;
  p.dk_sb = dk_sb;
  p.dk_ss = dk_ss;
  p.dk_sh = dk_sh;
  p.dv_sb = dv_sb;
  p.dv_ss = dv_ss;
  p.dv_sh = dv_sh;
  p.sm_scale = sm_scale;
  p.scale_log2 = sm_scale * LOG2E;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d == 64)
    return launch<64>(q, k, v, dout, p, q_sb, q_ss, q_sh, k_sb, k_ss, k_sh,
                      v_sb, v_ss, v_sh, s);
  return launch<128>(q, k, v, dout, p, q_sb, q_ss, q_sh, k_sb, k_ss, k_sh,
                     v_sb, v_ss, v_sh, s);
}
