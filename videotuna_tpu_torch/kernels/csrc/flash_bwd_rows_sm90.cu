// Single-pass flash-attention backward for Hopper (sm_90a) at the short
// rows of Open-Sora STDiT: bf16, head width 72 or 80, non-causal, with or
// without a key mask.  TMA loads, wgmma products, a producer warpgroup and
// two consumer warpgroups, a persistent grid.
//
// Replaces the TPU kernel K8 of the JAX package, `_flash_bwd_fused_kernel`
// launched by `flash_attention_bwd` (videotuna_tpu/kernels/attention.py
// :1148, :1725; `pallas_call` at :1804), also behind the key-masked
// backward `_fa_masked_bwd` (:2065), and by mapping its two-kernel baseline
// K9 (`_flash_bwd_dkv_kernel` + `_flash_bwd_dq_kernel`, :1107, :1197), at
// the calls STDiT-XL/2's full fine-tune makes: the spatial self-attention
// (B=16, S=256, H=16, d=72) and the cross-attention to the caption (4096
// queries over 120 keys with a per-batch key mask).  Like the TPU kernel at
// these shapes (one 256 x 256 block a spatial head, one key tile a cross
// head), s, p and ds are computed once for all three gradients (5
// products) and dq leaves a head's keys already summed.
//
// Function (that of flash_bwd.cu and flash_bwd_sm90.cu).  With
// s = (q.k) * sm_scale, -inf where the key is masked or past Sk:
//   p  = exp(s - lse)      (lse clamped at -1e5, so a row with no valid key
//                           gets p = 0)
//   delta_i = sum_d dO[i,d] o[i,d]
//   dv = p^T dO,  ds = p * (dO v^T - delta),
//   dq = sm_scale * ds k,  dk = sm_scale * ds^T q.
// A masked key gets dk = dv = 0 exactly, a row with no valid key dq = 0.
// p and ds are rounded to bf16 as operands of the products; delta, lse and
// every accumulator are f32.  Every sum runs in a fixed order: dq, dk and
// dv are bit-for-bit reproducible, except dq in the atomic mode below.
//
// What bounds it.  At the spatial shape q, k, v, o, dO, dq, dk and dv move
// 8 x 9.44 MB = 75.5 MB (22.5 us at 3.35 TB/s) against 1.2e10 FLOP of
// products (12 us at 989 TF/s); the cross shape moves about 38 MB (11 us).
// Bound by bytes and by the latency of each tile's chain of five products,
// so: no scratch and one launch at the spatial shape (at the cross shape
// 10 MB of f32 partials, which stay in L2, and a reduce kernel), each
// tensor read once from device memory (o only for delta, on a head's first
// key tile), delta and the clamped LSE computed in the kernel, and the mask
// read as the bit words that the forward (K4) packed (`pack_mask_kernel`,
// flash_fwd_sm90.cu), two bits a thread.
//
// Layout.  A key tile is 128 keys, 64 per consumer; a query tile 64 rows.
// Columns 0-63 of every tile are a 64-column TMA box with the 128-byte
// swizzle, columns 64-79 a 16-column box with the 32-byte swizzle, zeros
// past d (sm90.cuh).  384 threads:
//   warpgroup 0, the producer (40 registers): one thread loads a key tile's
//     K into a ring of two slots (the next key tile's K lands while this
//     one runs) and its V into one buffer (refilled once the consumers'
//     last dP^T of the key tile has read it), then walks the unit's query
//     tiles (Q, dO) through a ring of two stages with full and empty
//     mbarriers, and where delta is due the query tile's O into a buffer
//     of its own; warps 1 and 2 compute delta and lse2 = max(lse, -1e5)
//     log2e of those 64 rows (a thread a row, the LSE loaded before the
//     tiles land) into shared memory, off the consumers' path, and
//     acknowledge every fill of a stage on a third mbarrier of it;
//   warpgroups 1 and 2, the consumers (232 registers), 64 keys each, dK and
//     dV in f32 registers (40 each: N = 64 + 16) across the query tiles.
//     Per query tile:
//       S^T = K Q^T, dP^T = V dO^T  (wgmma m64n64k16, K-major; the depth's
//                                    fifth step from the 16-column boxes)
//       P^T  = exp2(S^T sm_scale log2e - lse2 + b)  (b = 0, or -inf for a
//                                    masked key or one past Sk)
//       dV  += P^T dO,  dS^T = P^T (dP^T - delta),  dK += dS^T Q
//                                   (A from registers, N = 64 + 16)
//       dS^T to shared memory; after a barrier of both consumers each
//       computes 40 columns of dQ_tile = dS K: columns 32c..32c+31 (N = 32)
//       and 64+8c..64+8c+7 (N = 8), both operands read MN-major.
// Units, and where each sum ends (chosen by the caller, `flash_bwd_rows`):
//   rows mode, a unit is (b*h, a run of query tiles) walking every key tile
//     of the head.  dQ of a query tile is final after the last key tile:
//     over several key tiles (the spatial shape: 2 key tiles, 4 query
//     tiles a unit) it is summed in an f32 accumulator in shared memory,
//     each thread's own elements (80 KB at 4 query tiles), and stored as
//     bf16 after the last; over one key tile (the cross shape) it is stored
//     at once.  dK and dV of a key tile are final when its query loop ends
//     if the unit holds all of the head's queries.  Otherwise (one key
//     tile, a head's queries split into `chunks` units to fill the SMs: 8
//     units of 8 query tiles at the cross shape) each unit stores its f32
//     partial in device memory and `dkv_reduce_kernel` sums them in unit
//     order (at the cross shape 0.037-0.042 ms against 0.067-0.077 for a
//     sum across a thread-block cluster, whose 8 blocks of 216 KB need a
//     second wave; PERF.md);
//   atomic mode (a head longer than 4 query tiles and 1 key tile, off
//     STDiT's path), a unit is (b*h, key tile) over all query tiles, dQ is
//     added into an f32 scratch by atomics (its order changes from run to
//     run) and converted by `dq_convert_kernel`.
// Shared memory: 2 x K 20 KB + V 20 KB + 2 x (Q, dO: 20 KB) + O 10 KB +
// 2 x dS^T 16 KB + lse2 and delta 2 KB + the dQ accumulator 80 KB = 224 KB.

#include <math.h>

#include "sm90.cuh"

namespace {

using namespace sm90;

constexpr float LOG2E = 1.4426950408889634f;
constexpr int BLOCK_N = 128;  // keys a key tile, 64 per consumer
constexpr int BLOCK_M = 64;   // query rows a query tile
constexpr int STAGES = 2;
constexpr int THREADS = 384;
constexpr int HEAD_M_MAX = 4;  // query tiles of a unit with dQ in smem
constexpr int CHUNKS_MAX = 8;  // units of a head
constexpr int BAR_DS = 1;      // named barrier: both halves of dS^T stored

constexpr int BOX_KV = BLOCK_N * 128;             // 64-column box, K or V
constexpr int KV_BYTES = BOX_KV + BLOCK_N * 32;   // + the 16-column box
constexpr int BOX_ROW = BLOCK_M * 128;            // 64-column box, Q/dO/O
constexpr int ROW_BYTES = BOX_ROW + BLOCK_M * 32;  // + the 16-column box
constexpr int STAGE_BYTES = 2 * ROW_BYTES;        // Q, dO
constexpr int DS_BYTES = BLOCK_N * 128;           // dS^T, 128 keys x 64 rows
constexpr int DQ_REGS = 20;                       // dQ a consumer thread
constexpr int KV_REGS = 40;                       // dK or dV a thread
constexpr int STAT_FLOATS = 4 * 2 * BLOCK_M;      // 4 slots of lse2, delta
constexpr int ACC_FLOATS = HEAD_M_MAX * DQ_REGS * 256;
constexpr int PART_FLOATS = 2 * 2 * KV_REGS * 128;  // dK, dV of a unit

constexpr int OFF_K = 0;                              // 2 slots
constexpr int OFF_V = OFF_K + 2 * KV_BYTES;
constexpr int OFF_ST = OFF_V + KV_BYTES;              // STAGES stages
constexpr int OFF_O = OFF_ST + STAGES * STAGE_BYTES;  // one O tile
constexpr int OFF_DS = OFF_O + ROW_BYTES;             // 2 tiles
constexpr int OFF_STAT = OFF_DS + 2 * DS_BYTES;
constexpr int OFF_ACC = OFF_STAT + STAT_FLOATS * 4;
constexpr int OFF_BAR = OFF_ACC + ACC_FLOATS * 4;
constexpr int SMEM = OFF_BAR + 128 + 1024;  // + alignment slack

struct Params {
  const float* lse;         // (B, H, Sq), natural log
  const uint32_t* words;    // (B, 4 n_tiles) key-mask bits (MASK)
  __nv_bfloat16* dq;
  __nv_bfloat16* dk;
  __nv_bfloat16* dv;
  float* scratch;  // atomic: dQ (B*H, m_tiles*64, 80); chunks > 1: partials
  int H, Sq, Sk, d;
  int m_tiles, n_tiles;
  int unit_m;   // query tiles of a unit (rows mode)
  int chunks;   // units of a head (rows mode)
  int n_units;
  long long dq_sb, dq_ss, dq_sh;
  long long dk_sb, dk_ss, dk_sh;
  long long dv_sb, dv_ss, dv_sh;
  float sm_scale;
  float scale_log2;  // sm_scale * log2(e)
};

// A unit's head, query tiles [j0, j1) and key tiles [t0, t1).
struct Unit {
  int bh, j0, j1, t0, t1;
};
template <bool ATOMIC>
__device__ __forceinline__ Unit unit_of(const Params& p, int u) {
  Unit x;
  if (ATOMIC) {
    x.bh = u / p.n_tiles;
    x.t0 = u - x.bh * p.n_tiles;
    x.t1 = x.t0 + 1;
    x.j0 = 0;
    x.j1 = p.m_tiles;
  } else {
    x.bh = u / p.chunks;
    x.j0 = (u - x.bh * p.chunks) * p.unit_m;
    x.j1 = min(x.j0 + p.unit_m, p.m_tiles);
    x.t0 = 0;
    x.t1 = p.n_tiles;
  }
  return x;
}

// Where element i of consumer c's thread `tid` of a dK or dV accumulator
// (N = 64, then N = 16 at i >= 32) lies in the key tile: its key row and
// column.
__device__ __forceinline__ void kv_elem(int c, int i, int tid, int& key,
                                        int& col) {
  const int warp = tid >> 5, g = (tid & 31) >> 2, tig = tid & 3;
  const int j = i < 32 ? i : i - 32;
  key = c * 64 + warp * 16 + g + ((j >> 1) & 1) * 8;
  col = (i < 32 ? 0 : 64) + (j >> 2) * 8 + tig * 2 + (j & 1);
}

// dK (tensor 0, times sm_scale) or dV (tensor 1) at (key, col..col+1) of
// key tile 0 of head bh as bf16; nothing past Sk or d.
__device__ __forceinline__ void store_kv_pair(const Params& p, int bh,
                                              int tensor, int key, int col,
                                              float a, float b) {
  if (key >= p.Sk || col >= p.d) return;
  const int bb = bh / p.H, h = bh - bb * p.H;
  __nv_bfloat16* out =
      tensor == 0 ? p.dk + bb * p.dk_sb + h * p.dk_sh + key * p.dk_ss
                  : p.dv + bb * p.dv_sb + h * p.dv_sh + key * p.dv_ss;
  const float s = tensor == 0 ? p.sm_scale : 1.f;
  *reinterpret_cast<__nv_bfloat162*>(out + col) =
      __floats2bfloat162_rn(a * s, b * s);
}

// The pairs of a unit's partials: (tensor, consumer, even element, thread)
constexpr int PART_PAIRS = PART_FLOATS / 2;
__device__ __forceinline__ int part_index(int pair, int& tensor, int& c,
                                          int& i, int& tid) {
  tid = pair & 127;
  const int rest = pair >> 7;  // (tensor * 2 + c) * 20 + i / 2
  i = (rest % (KV_REGS / 2)) * 2;
  c = (rest / (KV_REGS / 2)) & 1;
  tensor = rest / KV_REGS;
  return ((tensor * 2 + c) * KV_REGS + i) * 128 + tid;
}

template <bool MASK, bool ATOMIC>
__global__ void __launch_bounds__(THREADS, 1)
    flash_bwd_rows_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tq2,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tk2,
                          const __grid_constant__ CUtensorMap tv,
                          const __grid_constant__ CUtensorMap tv2,
                          const __grid_constant__ CUtensorMap to,
                          const __grid_constant__ CUtensorMap to2,
                          const __grid_constant__ CUtensorMap tdo,
                          const __grid_constant__ CUtensorMap tdo2,
                          const Params p) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  unsigned char* const base_ptr = smem_raw + (base - smem_u32(smem_raw));
  const uint32_t sV = base + OFF_V;
  const uint32_t bars = base + OFF_BAR;
  // K slot k; V; O
  auto k_full = [&](int k) { return bars + 16 * k; };
  auto k_empty = [&](int k) { return bars + 8 + 16 * k; };
  const uint32_t v_full = bars + 32, v_empty = bars + 40;
  const uint32_t o_full = bars + 48, o_empty = bars + 56;
  auto full = [&](int s) { return bars + 64 + 24 * s; };
  auto empty = [&](int s) { return bars + 72 + 24 * s; };
  // lse2 and delta of the stage's query tile stored (every fill of it)
  auto stats_full = [&](int s) { return bars + 80 + 24 * s; };
  const int wg = threadIdx.x >> 7;

  if (threadIdx.x == 0) {
    for (int k = 0; k < 2; ++k) {
      mbar_init(k_full(k), 1);
      mbar_init(k_empty(k), 8);  // lane 0 of each consumer warp
    }
    mbar_init(v_full, 1);
    mbar_init(v_empty, 8);
    mbar_init(o_full, 1);
    mbar_init(o_empty, 2);  // lane 0 of warps 1 and 2
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 8);
      mbar_init(stats_full(s), 2);  // lane 0 of warps 1 and 2
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == 0) {
    // ------------------------------------------------------------ producer
    reg_dealloc<40>();
    if (threadIdx.x == 0) {
      // query tiles, key tiles and O tiles loaded so far
      int si = 0, kti = 0, oi = 0;
      for (int u = blockIdx.x; u < p.n_units; u += gridDim.x) {
        const Unit x = unit_of<ATOMIC>(p, u);
        const int b = x.bh / p.H, h = x.bh - b * p.H;
        for (int t = x.t0; t < x.t1; ++t, ++kti) {
          // K into the slot the key tile before last left; V once the
          // consumers' last dP^T of the key tile before has read it
          const int kslot = kti & 1;
          const uint32_t dk = base + OFF_K + kslot * KV_BYTES;
          mbar_wait(k_empty(kslot), ((kti >> 1) & 1) ^ 1);
          mbar_expect_tx(k_full(kslot), KV_BYTES);
          tma_load_4d(dk, &tk, k_full(kslot), 0, h, t * BLOCK_N, b);
          tma_load_4d(dk + BOX_KV, &tk2, k_full(kslot), 64, h, t * BLOCK_N,
                      b);
          mbar_wait(v_empty, (kti & 1) ^ 1);
          mbar_expect_tx(v_full, KV_BYTES);
          tma_load_4d(sV, &tv, v_full, 0, h, t * BLOCK_N, b);
          tma_load_4d(sV + BOX_KV, &tv2, v_full, 64, h, t * BLOCK_N, b);
          // O only where delta is computed: the unit's first key tile
          const bool need_o = t == x.t0;
          for (int j = x.j0; j < x.j1; ++j, ++si) {
            const int s = si % STAGES;
            mbar_wait(empty(s), ((si / STAGES) & 1) ^ 1);
            const uint32_t dst = base + OFF_ST + s * STAGE_BYTES;
            const int m0 = j * BLOCK_M;
            mbar_expect_tx(full(s), STAGE_BYTES);
            tma_load_4d(dst, &tq, full(s), 0, h, m0, b);
            tma_load_4d(dst + BOX_ROW, &tq2, full(s), 64, h, m0, b);
            tma_load_4d(dst + ROW_BYTES, &tdo, full(s), 0, h, m0, b);
            tma_load_4d(dst + ROW_BYTES + BOX_ROW, &tdo2, full(s), 64, h, m0,
                        b);
            if (need_o) {
              mbar_wait(o_empty, (oi & 1) ^ 1);
              ++oi;
              mbar_expect_tx(o_full, ROW_BYTES);
              tma_load_4d(base + OFF_O, &to, o_full, 0, h, m0, b);
              tma_load_4d(base + OFF_O + BOX_ROW, &to2, o_full, 64, h, m0, b);
            }
          }
        }
      }
    } else if (threadIdx.x >= 32 && threadIdx.x < 96) {
      // warps 1 and 2: delta = rowsum(dO o) and lse2 of each stage's query
      // tile, one thread a row, on the unit's first key tile; every fill of
      // a stage is acknowledged on stats_full (its parity is full's), and
      // the consumers wait for that before they release the stage
      const int row = threadIdx.x - 32;
      float* const stats = reinterpret_cast<float*>(base_ptr + OFF_STAT);
      const unsigned char* const o_t = base_ptr + OFF_O;
      int si = 0, oi = 0;
      for (int u = blockIdx.x; u < p.n_units; u += gridDim.x) {
        const Unit x = unit_of<ATOMIC>(p, u);
        for (int t = x.t0; t < x.t1; ++t)
          for (int j = x.j0; j < x.j1; ++j, ++si) {
            const int s = si % STAGES;
            const bool fresh = t == x.t0;
            // the row's LSE, loaded while the stage's tiles land
            const int qi = j * BLOCK_M + row;
            const float lse = fresh && qi < p.Sq
                                  ? __ldg(p.lse + (long long)x.bh * p.Sq + qi)
                                  : 0.f;
            mbar_wait(full(s), (si / STAGES) & 1);
            if (fresh) {
              const unsigned char* do_t =
                  base_ptr + OFF_ST + s * STAGE_BYTES + ROW_BYTES;
              mbar_wait(o_full, oi & 1);
              ++oi;
              float sum = 0.f;
              #pragma unroll 2
              for (int ch = 0; ch < 10; ++ch) {
                // 8 chunks of the 64-column box, 2 of the 16-column box
                const int off =
                    ch < 8 ? row * 128 + ((ch ^ (row & 7)) << 4)
                           : BOX_ROW + row * 32 +
                                 (((ch - 8) ^ ((row >> 2) & 1)) << 4);
                const uint4 ov = *reinterpret_cast<const uint4*>(o_t + off);
                const uint4 gv = *reinterpret_cast<const uint4*>(do_t + off);
                const __nv_bfloat162* o2 =
                    reinterpret_cast<const __nv_bfloat162*>(&ov);
                const __nv_bfloat162* g2 =
                    reinterpret_cast<const __nv_bfloat162*>(&gv);
                #pragma unroll
                for (int e = 0; e < 4; ++e) {
                  const float2 of = __bfloat1622float2(o2[e]);
                  const float2 gf = __bfloat1622float2(g2[e]);
                  sum = fmaf(of.x, gf.x, fmaf(of.y, gf.y, sum));
                }
              }
              float* const lse2 = stats + ((j - x.j0) & 3) * 2 * BLOCK_M;
              lse2[BLOCK_M + row] = sum;
              // rows past Sq: p = 0
              lse2[row] = qi < p.Sq ? fmaxf(lse, -1e5f) * LOG2E : INFINITY;
              __syncwarp();
              if ((threadIdx.x & 31) == 0) mbar_arrive(o_empty);
            }
            __syncwarp();
            if ((threadIdx.x & 31) == 0) mbar_arrive(stats_full(s));
          }
      }
    }
    return;
  }

  // -------------------------------------------------------------- consumers
  reg_alloc<232>();
  const int c = wg - 1;  // which 64 keys
  const int tid = threadIdx.x & 127;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int tig = lane & 3;
  const int krow = c * 64 + warp * 16 + g;  // key row in the tile; +8
  const float* const stats =
      reinterpret_cast<const float*>(base_ptr + OFF_STAT);
  float* const acc = reinterpret_cast<float*>(base_ptr + OFF_ACC);

  float dk[KV_REGS], dv[KV_REGS], st[32], dpt[32], dqa[DQ_REGS];
  uint32_t pa[4][4], dsa[4][4];
  int si = 0, kti = 0;  // query tiles and key tiles consumed so far
  for (int u = blockIdx.x; u < p.n_units; u += gridDim.x) {
    const Unit x = unit_of<ATOMIC>(p, u);
    const int b = x.bh / p.H, h = x.bh - b * p.H;
    for (int t = x.t0; t < x.t1; ++t, ++kti) {
      const int kslot = kti & 1;
      const uint32_t sK = base + OFF_K + kslot * KV_BYTES;
      // 0, or -inf for a masked key or one past Sk, of the thread's 2 keys
      float kb[2];
      #pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int key = t * BLOCK_N + krow + r * 8;
        bool ok = key < p.Sk;
        if constexpr (MASK)  // the words' bits past Sk are 0
          ok = (__ldg(p.words + (long long)b * 4 * p.n_tiles + (key >> 5)) >>
                (key & 31)) & 1u;
        kb[r] = ok ? 0.f : -INFINITY;
      }
      #pragma unroll
      for (int i = 0; i < KV_REGS; ++i) dk[i] = dv[i] = 0.f;
      const bool fresh = t == x.t0;  // the unit's first key tile
      mbar_wait(k_full(kslot), (kti >> 1) & 1);
      mbar_wait(v_full, kti & 1);
      for (int j = x.j0; j < x.j1; ++j, ++si) {
        const int s = si % STAGES;
        mbar_wait(full(s), (si / STAGES) & 1);
        const uint32_t q_s = base + OFF_ST + s * STAGE_BYTES;
        const uint32_t do_s = q_s + ROW_BYTES;
        const float* const lse2 = stats + ((j - x.j0) & 3) * 2 * BLOCK_M;
        const float* const dl = lse2 + BLOCK_M;

        // S^T = K Q^T, dP^T = V dO^T
        wgmma_fence();
        #pragma unroll
        for (int ks = 0; ks < 4; ++ks)
          wgmma_ss_n64<0, 0>(st, desc(sK + c * 8192 + ks * 32, 16, 1024),
                             desc(q_s + ks * 32, 16, 1024), ks > 0);
        wgmma_ss_n64<0, 0>(st, desc_sw32(sK + BOX_KV + c * 2048, 16, 256),
                           desc_sw32(q_s + BOX_ROW, 16, 256), 1);
        wgmma_commit();
        #pragma unroll
        for (int ks = 0; ks < 4; ++ks)
          wgmma_ss_n64<0, 0>(dpt, desc(sV + c * 8192 + ks * 32, 16, 1024),
                             desc(do_s + ks * 32, 16, 1024), ks > 0);
        wgmma_ss_n64<0, 0>(dpt, desc_sw32(sV + BOX_KV + c * 2048, 16, 256),
                           desc_sw32(do_s + BOX_ROW, 16, 256), 1);
        wgmma_commit();

        // every tile, so that warps 1 and 2 are never a phase of full(s)
        // behind: the stage is released only after they acknowledged it
        mbar_wait(stats_full(s), (si / STAGES) & 1);
        wgmma_wait<1>();

        // P^T = exp2(s sm_scale log2e - lse2 + b)
        #pragma unroll
        for (int nb = 0; nb < 8; ++nb)
          #pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int col = nb * 8 + tig * 2 + (i & 1);
            st[nb * 4 + i] = fast_exp2(
                fmaf(st[nb * 4 + i], p.scale_log2, -lse2[col]) + kb[i >> 1]);
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
        #pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          wgmma_rs_n64<1>(dv, pa[kk], desc(do_s + kk * 2048, BOX_ROW, 1024));
          wgmma_rs_n16<1>(dv + 32, pa[kk],
                          desc_sw32(do_s + BOX_ROW + kk * 512, BLOCK_M * 32,
                                    256));
        }
        wgmma_commit();

        // dS^T = P^T (dP^T - delta)
        wgmma_wait<1>();
        if (j == x.j1 - 1) {  // dP^T of the key tile's last query tile done
          __syncwarp();
          if (lane == 0) mbar_arrive(v_empty);
        }
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
        #pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          wgmma_rs_n64<1>(dk, dsa[kk], desc(q_s + kk * 2048, BOX_ROW, 1024));
          wgmma_rs_n16<1>(dk + 32, dsa[kk],
                          desc_sw32(q_s + BOX_ROW + kk * 512, BLOCK_M * 32,
                                    256));
        }
        wgmma_commit();

        // dS^T to shared memory, rows = keys, 128-byte swizzled
        unsigned char* ds = base_ptr + OFF_DS + (si & 1) * DS_BYTES;
        #pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          #pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int key = krow + (e & 1) * 8;
            const int q = (2 * kk + (e >> 1)) * 8 + tig * 2;
            *reinterpret_cast<uint32_t*>(
                ds + key * 128 + (((q >> 3) ^ (key & 7)) << 4) + (q & 7) * 2) =
                dsa[kk][e];
          }
        fence_proxy_async();
        named_sync(BAR_DS, 256);

        // dQ_tile = dS K, columns 32c..32c+31 and 64+8c..64+8c+7
        const uint32_t ds_s = base + OFF_DS + (si & 1) * DS_BYTES;
        wgmma_fence();
        #pragma unroll
        for (int kk = 0; kk < BLOCK_N / 16; ++kk) {
          const uint64_t da = desc(ds_s + kk * 2048, DS_BYTES, 1024);
          wgmma_ss_n32<1, 1>(dqa, da,
                             desc(sK + kk * 2048 + c * 64, BOX_KV, 1024),
                             kk > 0);
          wgmma_ss_n8<1, 1>(
              dqa + 16, da,
              desc_sw32(sK + BOX_KV + kk * 512 + c * 16, BLOCK_N * 32, 256),
              kk > 0);
        }
        wgmma_commit();
        wgmma_wait<0>();
        __syncwarp();
        if (lane == 0) {
          mbar_arrive(empty(s));
          if (j == x.j1 - 1) mbar_arrive(k_empty(kslot));
        }

        // element i: row warp*16 + g (+8 at odd i/2), column as below
        auto dq_col = [&](int i) {
          return i < 16 ? c * 32 + (i >> 2) * 8 + tig * 2 + (i & 1)
                        : 64 + c * 8 + tig * 2 + (i & 1);
        };
        const int row0 = j * BLOCK_M + warp * 16 + g;
        if constexpr (ATOMIC) {
          float* a = p.scratch + ((long long)x.bh * p.m_tiles * BLOCK_M) * 80;
          #pragma unroll
          for (int i = 0; i < DQ_REGS; i += 2) {
            const int row = row0 + ((i >> 1) & 1) * 8;
            atomicAdd(reinterpret_cast<float2*>(a + row * 80 + dq_col(i)),
                      make_float2(dqa[i], dqa[i + 1]));
          }
        } else {
          // summed over the key tiles in the thread's own smem slots, stored
          // after the last
          float* mine = acc + (((j - x.j0) & 3) * DQ_REGS * 256) +
                        c * 128 + tid;
          const bool last = t == x.t1 - 1;
          #pragma unroll
          for (int i = 0; i < DQ_REGS; ++i) {
            const float v = fresh ? dqa[i] : dqa[i] + mine[i * 256];
            if (last)
              dqa[i] = v;
            else
              mine[i * 256] = v;
          }
          if (last) {
            __nv_bfloat16* dq = p.dq + b * p.dq_sb + h * p.dq_sh;
            #pragma unroll
            for (int i = 0; i < DQ_REGS; i += 2) {
              const int row = row0 + ((i >> 1) & 1) * 8;
              const int col = dq_col(i);
              if (row < p.Sq && col < p.d)
                *reinterpret_cast<__nv_bfloat162*>(dq + row * p.dq_ss + col) =
                    __floats2bfloat162_rn(dqa[i] * p.sm_scale,
                                          dqa[i + 1] * p.sm_scale);
            }
          }
        }
      }

      // dK and dV of key tile t: final, or this unit's partial
      if (ATOMIC || p.chunks == 1) {
        #pragma unroll
        for (int i = 0; i < KV_REGS; i += 2) {
          int key, col;
          kv_elem(c, i, tid, key, col);
          key += t * BLOCK_N;
          store_kv_pair(p, x.bh, 0, key, col, dk[i], dk[i + 1]);
          store_kv_pair(p, x.bh, 1, key, col, dv[i], dv[i + 1]);
        }
      } else {
        // one key tile (t = 0): thread-private f32 slots in the unit's
        // slice of the scratch
        float* part = p.scratch + (long long)u * PART_FLOATS;
        #pragma unroll
        for (int i = 0; i < KV_REGS; ++i) {
          part[((0 * 2 + c) * KV_REGS + i) * 128 + tid] = dk[i];
          part[((1 * 2 + c) * KV_REGS + i) * 128 + tid] = dv[i];
        }
      }
    }
  }
}

// dK and dV of one key tile from the f32 partials of a head's `chunks`
// units, summed in unit order; one thread a pair of columns.
__global__ void dkv_reduce_kernel(const Params p) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (long long)p.n_units / p.chunks * PART_PAIRS) return;
  const int bh = static_cast<int>(t / PART_PAIRS);
  int tensor, c, i, tid;
  const int e = part_index(static_cast<int>(t % PART_PAIRS), tensor, c, i,
                           tid);
  const float* src = p.scratch + (long long)bh * p.chunks * PART_FLOATS + e;
  float a = 0.f, b = 0.f;
  for (int r = 0; r < p.chunks; ++r) {
    a += src[(long long)r * PART_FLOATS];
    b += src[(long long)r * PART_FLOATS + 128];
  }
  int key, col;
  kv_elem(c, i, tid, key, col);
  store_kv_pair(p, bh, tensor, key, col, a, b);
}

// dq = sm_scale * the atomic mode's f32 sums, as bf16; 8 columns a thread.
__global__ void dq_convert_kernel(const Params p) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (long long)p.n_units / p.n_tiles * p.Sq * 10) return;
  const int part = static_cast<int>(t % 10);
  const long long row = t / 10;  // (b*h, i)
  const int i = static_cast<int>(row % p.Sq);
  const int bh = static_cast<int>(row / p.Sq);
  if (part * 8 >= p.d) return;
  const int b = bh / p.H, h = bh - b * p.H;
  const float4* src = reinterpret_cast<const float4*>(
      p.scratch + ((long long)bh * p.m_tiles * BLOCK_M + i) * 80 + part * 8);
  const float4 x = src[0], y = src[1];
  const float s = p.sm_scale;
  uint4 out;
  out.x = pack_bf16(x.x * s, x.y * s);
  out.y = pack_bf16(x.z * s, x.w * s);
  out.z = pack_bf16(y.x * s, y.y * s);
  out.w = pack_bf16(y.z * s, y.w * s);
  *reinterpret_cast<uint4*>(p.dq + b * p.dq_sb + h * p.dq_sh + i * p.dq_ss +
                            part * 8) = out;
}

template <bool MASK, bool ATOMIC>
int launch(const CUtensorMap* m, const Params& p, cudaStream_t stream) {
  auto kernel = flash_bwd_rows_kernel<MASK, ATOMIC>;
  // per device, at the kernel's first launch there: its shared-memory limit
  // and the SM count (the grid)
  static int sms_of[64] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess && dev >= 64) e = cudaErrorInvalidDevice;
  if (e == cudaSuccess && sms_of[dev] == 0) {
    int sms = 0;
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess) sms_of[dev] = sms;
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  // persistent: at most one block an SM
  const int grid = p.n_units < sms_of[dev] ? p.n_units : sms_of[dev];
  kernel<<<grid, THREADS, SMEM, stream>>>(m[0], m[1], m[2], m[3], m[4], m[5],
                                          m[6], m[7], m[8], m[9], p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Returns the CUDA error of the launches (0 on success);
// cudaErrorInvalidValue for what the kernel does not take: a head width
// other than 72 or 80, a tensor TMA cannot read in place, or a plan it
// cannot run.  The caller's plan: `atomic` 1 for the atomic mode, whose
// `scratch` is B*H*ceil(Sq/64)*64*80 f32 zeros; else rows mode with units
// of `unit_m` query tiles, which must hold every query tile of a head
// whose keys span several key tiles (at most 4), and over one key tile may
// split it into up to 8 units, whose dK and dV partials are summed
// through `scratch`, chunks*B*H*20480 f32.  `words` is null, or the key
// mask's (B, 4*ceil(Sk/128)) words as pack_mask_kernel writes them.
extern "C" int flash_bwd_rows_sm90_bf16(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, const void* words, void* dq, void* dk,
    void* dv, void* scratch, int B, int H, int Sq, int Sk, int d,
    long long q_sb, long long q_ss, long long q_sh, long long k_sb,
    long long k_ss, long long k_sh, long long v_sb, long long v_ss,
    long long v_sh, long long o_sb, long long o_ss, long long o_sh,
    long long do_sb, long long do_ss, long long do_sh, long long dq_sb,
    long long dq_ss, long long dq_sh, long long dk_sb, long long dk_ss,
    long long dk_sh, long long dv_sb, long long dv_ss, long long dv_sh,
    float sm_scale, int atomic, int unit_m, void* stream) {
  const int invalid = static_cast<int>(cudaErrorInvalidValue);
  if ((d != 72 && d != 80) || B <= 0 || H <= 0 || Sq <= 0 || Sk <= 0)
    return invalid;
  Params p;
  p.lse = static_cast<const float*>(lse);
  p.words = static_cast<const uint32_t*>(words);
  p.dq = static_cast<__nv_bfloat16*>(dq);
  p.dk = static_cast<__nv_bfloat16*>(dk);
  p.dv = static_cast<__nv_bfloat16*>(dv);
  p.scratch = static_cast<float*>(scratch);
  p.H = H;
  p.Sq = Sq;
  p.Sk = Sk;
  p.d = d;
  p.m_tiles = (Sq + BLOCK_M - 1) / BLOCK_M;
  p.n_tiles = (Sk + BLOCK_N - 1) / BLOCK_N;
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
  const long long heads = (long long)B * H;
  long long units;
  if (atomic) {
    if (scratch == nullptr) return invalid;
    p.unit_m = p.m_tiles;
    p.chunks = 1;
    units = heads * p.n_tiles;
  } else {
    if (unit_m <= 0) return invalid;
    p.unit_m = unit_m < p.m_tiles ? unit_m : p.m_tiles;
    p.chunks = (p.m_tiles + p.unit_m - 1) / p.unit_m;
    if (p.n_tiles > 1 && (p.chunks > 1 || p.m_tiles > HEAD_M_MAX))
      return invalid;  // dQ would need the atomic mode
    if (p.chunks > CHUNKS_MAX || (p.chunks > 1 && !scratch))
      return invalid;
    units = heads * p.chunks;
  }
  if (units > 0x7fffffffLL) return invalid;
  p.n_units = static_cast<int>(units);
  cudaStream_t s = static_cast<cudaStream_t>(stream);

  // per tensor: the 64-column box and the 16-column box
  CUtensorMap m[10];
  const void* bases[5] = {q, k, v, o, dout};
  const long long str[5][3] = {{q_sb, q_ss, q_sh},
                               {k_sb, k_ss, k_sh},
                               {v_sb, v_ss, v_sh},
                               {o_sb, o_ss, o_sh},
                               {do_sb, do_ss, do_sh}};
  const int len[5] = {Sq, Sk, Sk, Sq, Sq};
  const int rows[5] = {BLOCK_M, BLOCK_N, BLOCK_N, BLOCK_M, BLOCK_M};
  for (int x = 0; x < 5; ++x)
    for (int box = 0; box < 2; ++box) {
      const int err = sm90_host::make_map(&m[2 * x + box], bases[x], B,
                                          len[x], H, d, str[x][0], str[x][1],
                                          str[x][2], rows[x],
                                          box == 0 ? 64 : 16);
      if (err != 0) return err;
    }
  // kernel arguments: q, q2, k, k2, v, v2, o, o2, dO, dO2
  int err;
  if (words != nullptr)
    err = atomic ? launch<true, true>(m, p, s) : launch<true, false>(m, p, s);
  else
    err = atomic ? launch<false, true>(m, p, s)
                 : launch<false, false>(m, p, s);
  if (err != 0) return err;
  if (atomic) {
    const long long n = heads * Sq * 10;
    dq_convert_kernel<<<static_cast<unsigned>((n + 255) / 256), 256, 0, s>>>(
        p);
  } else if (p.chunks > 1) {
    const long long n = heads * PART_PAIRS;
    dkv_reduce_kernel<<<static_cast<unsigned>((n + 255) / 256), 256, 0, s>>>(
        p);
  }
  return static_cast<int>(cudaGetLastError());
}
