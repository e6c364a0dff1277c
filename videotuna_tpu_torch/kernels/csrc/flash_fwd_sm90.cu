// Flash-attention forward for Hopper (sm_90a), bf16, non-causal: TMA
// loads, wgmma products, a producer warpgroup and two consumer warpgroups
// that take turns on the tensor cores.  Two kernels share that design:
// `flash_fwd_sm90_kernel<D, LSE, ONLINE, MASK>` (built at D = 128, one
// block per query tile: the fixed max, with or without the LSE, K3 and K5
// at d = 128; the online max, K2 at d = 128; the key mask under either
// max, K4 at d = 128; described first) and
// `flash_fwd_sm90_persistent` (d = 64, 72 or 80, online or fixed max,
// optional LSE and key mask, a persistent grid; K1, K2, K4, K5 and K6, and
// K3 at those widths, described below).  K3's kernel keeps its block per
// query tile (238 ms at HunyuanVideo's shape): the persistent walk would
// only add instructions to its long-row loop, and the online max and the
// mask are template flags, compiled out of the fixed-max instantiations.
// At d = 64 the persistent kernel took the fixed max from it
// (kernels/attribution.py K1, variant k3_kernel, times the two).
//
// ------------------------------------------------------------------- K3
// Replaces the TPU kernel K3 of the JAX package, `_flash_kernel_t128`
// launched by `_flash_t128` (videotuna_tpu/kernels/attention.py:581, :648),
// the d <= 128 fixed-max forward of the qk-normed denoisers (HunyuanVideo's
// joint attention), and with the LSE (LSE = true) K5 at d = 128,
// `_flash_fwd_lse_kernel` launched by `_flash_forward_lse` (:867, :933;
// `pallas_call` at :943) under the fixed max, the training forward of that
// attention in HunyuanVideo's LoRA fine-tune (B=1, 7,456 tokens, H=24,
// M = 0).  It computes the function of `flash_fwd` (flash_fwd.cu)
// with use_static=1, not the TPU kernel's blocks: the transposed scores and
// the row sum folded into the PV product answer the TPU's matrix unit and
// are not copied, and keys past Sk score -inf where the TPU kernel removes
// their share of the row sum in closed form (the same function).  With
// ONLINE it also replaces K2 at d = 128, `_flash_kernel` launched by
// `flash_attention` (:78, :812), bf16, non-causal: StepVideo's
// self-attention (B = 2, 12,648 tokens, H = 48), whose flow sets no fixed
// max.  With MASK it replaces K4 at d = 128, `_flash_kernel_dynpad`
// launched by `_flash_dynpad` (:970, :1059): StepVideo's cross-attention
// over the caption (12,648 queries over 397 keys, online) and Mochi's
// joint attention (22,516 tokens, the caption padding masked, M = 0).
//
// Function.  q (B,Sq,H,d), k and v (B,Sk,H,d), read in place through their
// strides by TMA (16-byte aligned start, strides multiples of 16 bytes; the
// wrapper copies a tensor that is not).  With s = (q.k) * sm_scale * log2e
// and the fixed max M:  p = exp2(s - M), l = sum p, o = (p @ v) / l, f32
// statistics and accumulator, p rounded to bf16 for the PV product, o bf16.
// Exact while every s lies in (M - 126, M + 127).  Rows past Sq are never
// stored; only the last key tile tests for keys past Sk.
//
// What bounds it.  HunyuanVideo-13B's joint attention (B=1, S=119,056, H=24,
// d=128) does 4*S^2*d*H = 1.742e14 FLOP: 176 ms at 989 TF/s, while its
// 2.9 GB of q, k, v, o take 0.9 ms at 3.35 TB/s.  Bound by operations, so
// the products run as wgmma (the only way to the full tensor-core rate),
// which flash_fwd's mma.sync cannot reach.  The softmax adds 3.40e11 exp2;
// the special-function units do 16 a clock per SM, about 80-85 ms on 132
// SMs, almost half the product time.  Run one after the other the two add
// up; so the two consumer warpgroups take turns (named barriers 1 and 2):
// each issues its products, hands the tensor cores to the other and
// computes its exp2 while the other's products run.  Under the fixed max
// there is no running max and no rescale: one FMA, one exp2 and the row sum
// a score.
//
// Online max and key mask (compile time, as in the persistent kernel
// below).  ONLINE: a running row max m, a key tile's max reduced over the 4
// threads of an accumulator row, p = exp2(s - m), l rescaled by
// exp2(m_old - m) in the softmax and O once PV(t) has completed (needs
// sm_scale > 0); at d = 128 a score costs 512 FLOP of products, so the max
// and the rescale (a compare a score, 64 multiplies a row a tile) stay
// under the other consumer's products.  MASK: the (B, Sk) key mask as 32-bit
// words, four a key tile (`pack_mask_kernel`, in the same call), loaded by
// each consumer thread as it starts a tile; a masked column of S gets -inf
// before the max and the exp2, and the words' zeros past Sk replace the last
// tile's test (so Sk need not be a multiple of the key tile, and the valid
// keys need not be a prefix).  A row with no valid key gives o = 0.  The
// LSE is instantiated under the fixed max without the mask alone (K5).
//
// Layout.  One block per (128-query tile, b*h), the query tiles of one head
// adjacent in launch order so that co-resident blocks share K and V in L2;
// 384 threads:
//   warpgroup 0, the producer (24 registers after setmaxnreg): one thread
//     loads Q once and walks the 128-key K and V tiles through a ring of
//     two stages, each tile with its own full and empty mbarrier;
//   warpgroups 1 and 2, the consumers (240 registers), 64 query rows each:
//     S = Q K^T as wgmma m64n128k16 with both operands in shared memory,
//     K-major; O += P V with P from registers (the S accumulator's layout is
//     the A-fragment layout, cast to bf16 in place) and V read MN-major
//     (the descriptor's transpose bit), N = d.  One turn issues the S
//     product of tile t+1 and then the PV product of tile t, so that tile
//     t+1's exp2 runs while PV(t) is still on the tensor cores.
// Shared memory at d=128: Q 32 KB + 2 x (K 32 KB + V 32 KB) = 160 KB.  The
// epilogue stores o / l as bf16 pairs straight from the accumulator, rows
// past Sq dropped (0.73 GB at the HunyuanVideo shape, well under 1 ms).
// With LSE it also writes lse = (M + log2 l) * ln 2, f32 (B, H, Sq), the
// layout of the persistent kernel's LSE, from the row sum l it already
// has (summed over the row's quad), by the thread of the row with
// tig = 0: 4 bytes a row, nothing added inside the loop.  A row whose l is
// 0 gets -inf.  The instantiation without the LSE, the online max and the
// mask is K3's kernel as it was.
//
// ------------------------------------------------------ K1, K2, K4-K6
// `flash_fwd_sm90_persistent<D, ONLINE, LSE, MASK, SPLIT>` replaces the TPU
// kernels K1, `_flash_kernel_packed2t` launched by `_flash_packed2t`
// (videotuna_tpu/kernels/attention.py:268, :449; d = 64, fixed max or
// online, optional LSE) and K6, `_flash_kernel_packed2` launched by
// `_flash_packed2` (:163, :525; the same online function in another
// layout), at D = 64; and at head widths 72 and 80 (D = 80) K2,
// `_flash_kernel` launched by `flash_attention` (:78, :812), K5,
// `_flash_fwd_lse_kernel` launched by `_flash_forward_lse` (:867, :943),
// and K4, `_flash_kernel_dynpad` launched by `_flash_dynpad` (:970, :1042;
// the key mask), and the fixed-max route K3 at these widths.  Their callers: CogVideoX's joint attention (17,776
// tokens, heads of d = 64) in sampling (K1, fixed max) and in the LoRA
// training forward (K1 with the LSE); Open-Sora STDiT-XL/2's spatial
// self-attention (256 tokens, 16 heads of d = 72) in sampling (K2) and in
// the training forward (K5), and its cross-attention to the caption (4096
// queries over 120 keys with a per-batch key mask, K4).  It computes the
// function of `flash_fwd` (flash_fwd.cu) without causal, the same scores
// and softmax as above.
//
// Options (compile time).  ONLINE: a running row max m; a key tile's max is
// reduced over the 4 threads that share an accumulator row (two shuffles,
// as the row sum), p = exp2(s - m), and l and the O accumulator are
// rescaled by exp2(m_old - m) once a key tile, O after the tile's PV
// product has completed (needs sm_scale > 0).  Without it, the fixed max M
// as in K3.  LSE: lse = (m + log2 l) * ln 2, f32 (B, H, Sq), the layout the
// backward (flash_bwd.cu, flash_bwd_sm90.cu, flash_bwd_rows_sm90.cu)
// reads, written by the thread of each row with tig = 0; rows past Sq are
// dropped.  MASK (D = 80): a (B, Sk) key mask, packed by
// `pack_mask_kernel` (a warp a word, by ballot) into 32-bit words, four a
// key tile (bit c of word w is key 32 w + c, 0 past Sk): in the same call,
// or for a training forward by an earlier `pack_mask_words`, whose words
// the backward (flash_bwd_rows_sm90.cu) reads too.  A consumer loads the
// four words of a key tile as it starts the tile and gives each masked
// column of the S accumulator -inf before the row max and the exp2 (so
// p = 0 under either softmax; sm_scale > 0); the words' zeros past Sk take
// the place of the last tile's test.  A row with no valid key keeps m = -inf: its exponents are taken
// against 0 instead, as `flash_fwd_plain` counts such a row's max, so l = 0,
// o = 0 and lse = -inf, with no NaN.  The TPU kernel zeroes the masked K
// and V rows outside the kernel and removes their share of l in closed
// form, an answer to the TPU's vector-unit cost that is not copied.
//
// Width 72 on TMA and wgmma.  A 128-byte-swizzle box holds 64 bf16 columns,
// so a tile is two boxes: columns 0-63 with the 128-byte swizzle and 64-79
// with the 32-byte swizzle (sm90.cuh).  The tensor map's inner extent is d,
// so at d = 72 TMA writes zeros into columns 72-79, which add nothing to
// QK^T.  QK^T takes four depth steps from the first box and one from the
// second; PV takes N = 64 from the first box and N = 16 from the second
// into a second accumulator (8 registers).  Columns past d are not stored.
// At D = 64 there is no second box: the tail's loads and products are
// compiled out.
//
// Short rows.  At S = 256 a 128-query block meets two 128-key tiles, so in
// a block per query tile nothing would overlap its Q and first K/V loads,
// and both query tiles of a head would fetch its K and V.  The grid is
// persistent instead: one block per SM walks the work units blockIdx.x,
// + gridDim.x, ...  When the keys fit in two tiles (Sk <= 256) a unit is
// one (b, h) with two adjacent query tiles: its K and V are loaded once and
// stay in the ring for both, which halves the K/V traffic into shared
// memory.  When they fit one tile (K4's 120 caption keys) a unit takes up
// to P_UNIT_M_MAX query tiles: the most that leaves the busiest SM no more
// query tiles than a smaller unit would (8 at STDiT's sampling batch of 2,
// 4 at its training batch of 1, on 132 SMs).  Longer key rows (K1's 17,776) make a unit
// of each query tile and stream their K/V tiles through the ring, the
// query tiles of one head adjacent in the walk so that the blocks that run
// together share K and V in L2.  The producer runs ahead across units: Q
// has 3 stages and the K/V ring 4 (two units' worth at S = 256), so the
// next unit's Q, K and V land while the consumers finish the current one,
// and the consumers' turns on the tensor cores go on from unit to unit.
// Shared memory: Q 3 x 20 KB + 4 x (K 20 KB + V 20 KB) = 220 KB at D = 80,
// Q 3 x 16 KB + 4 x (16 KB + 16 KB) = 176 KB at D = 64.
//
// Key-range split.  Few query tiles over many keys leave the card empty:
// K6's A/B shape (B = 2, 300 queries over 4,322 keys, H = 4) makes 24 units
// of 34 key tiles each for 132 SMs, so 108 SMs idle while each busy one
// walks its 34 tiles in turn.  When the unsplit units cannot fill the SMs
// and each would walk many key tiles, `_fwd_split_plan`
// (kernels/attention.py) cuts every query tile's keys into `splits` ranges
// of near-equal length (K6: 5 ranges of 6-7 tiles, 120 units), and each
// range is a unit of its own: the producer loads only the range's K and V
// tiles, the consumers' turns and softmax are unchanged, and the epilogue
// writes f32 partials (o unnormalised, the row's m and l) in place of o.
// A second launch, the combine of split_combine.cuh, rescales and sums the
// ranges of each row in a fixed order into o and the LSE.  The key mask
// (K4) is never split: its rows are short.  The split is the template
// flag SPLIT, so that the unsplit instantiations (every main path) are
// the kernel as it was; splits = 1 is the unsplit walk.
//
// What bounds it.  At STDiT's sampling shape (B = 32, S = 256, H = 16,
// d = 72) q, k, v and o are 75.5 MB: 22.5 us at 3.35 TB/s, above the 9.7
// GFLOP's 9.8 us at 989 TF/s (10.7 GFLOP at the padded width).  So bytes,
// and the latency of each unit's loads, bound it; the K/V reuse and the
// prefetch across units answer that.  The 3.4e7 exp2 take about 9 us of
// the special function units, hidden while one consumer's exp2 overlaps
// the other's products.  On an H100 (700 W) at STDiT's shapes the kernel
// with its products and softmax taken out keeps 80-90% of its time
// (kernels/attribution.py): the loads, barriers and stores of two to four
// units a block set it, not the math.  K4 (B = 2, 4096 queries over 120
// keys, H = 16, d = 72) is bound by its 37.7 MB of q and o likewise.  K1
// at CogVideoX-5B's shape (B = 2, S = 17,776, H = 48) is bound twice over:
// its 3.03e10 scores cost 7.85 ms of products at 989 TF/s and, at d = 64
// (256 FLOP of products a score against one exp2), as long again of
// exp2 on the special function units (16 a clock per SM).  The turns of
// the two consumers hide one's exp2 under the other's products; what is
// left of the sum is the measure of the overlap.

#include <math.h>

#include "sm90.cuh"
#include "split_combine.cuh"

namespace {

using namespace sm90;

constexpr int BLOCK_M = 128;  // query rows a block owns, 64 per consumer
constexpr int BLOCK_N = 128;  // keys a tile
constexpr int STAGES = 2;
constexpr int THREADS = 384;
constexpr int BAR_TURN0 = 1;  // named barriers of the consumers' turns
constexpr int BAR_TURN1 = 2;

template <int D>
struct Cfg {
  static constexpr int BOXES = D / 64;             // 64-column TMA boxes
  static constexpr int BOX_Q = BLOCK_M * 128;      // bytes of one Q box
  static constexpr int BOX_KV = BLOCK_N * 128;     // bytes of one K/V box
  static constexpr int Q_BYTES = BOXES * BOX_Q;
  static constexpr int KV_BYTES = BOXES * BOX_KV;  // one K or V tile
  static constexpr int TILES = Q_BYTES + 2 * STAGES * KV_BYTES;
  // tiles, then the mbarriers, plus slack to align the base to 1024 bytes
  static constexpr int SMEM = TILES + 256 + 1024;
};

struct Params {
  __nv_bfloat16* o;
  float* lse;        // (B, H, Sq) f32 (LSE), natural log
  const uint4* mask; // (B, key tiles) x 4 words of the key mask (MASK)
  int H, Sq, Sk;
  long long o_sb, o_ss, o_sh;
  float scale_log2;  // sm_scale * log2(e)
  float static_max;  // M, log2 domain
};

template <int D, bool LSE, bool ONLINE, bool MASK>
__global__ void __launch_bounds__(THREADS, 1)
    flash_fwd_sm90_kernel(const __grid_constant__ CUtensorMap tq,
               const __grid_constant__ CUtensorMap tk,
               const __grid_constant__ CUtensorMap tv, const Params p) {
  using C = Cfg<D>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t sQ = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sK = sQ + C::Q_BYTES;             // STAGES tiles
  const uint32_t sV = sK + STAGES * C::KV_BYTES;   // STAGES tiles
  const uint32_t bars = sV + STAGES * C::KV_BYTES;
  const uint32_t bar_q = bars;
  // k_full, k_empty, v_full, v_empty of stage s
  auto k_full = [&](int s) { return bars + 8 + 32 * s; };
  auto k_empty = [&](int s) { return bars + 16 + 32 * s; };
  auto v_full = [&](int s) { return bars + 24 + 32 * s; };
  auto v_empty = [&](int s) { return bars + 32 + 32 * s; };

  const int m0 = blockIdx.x * BLOCK_M;
  const int bh = blockIdx.y;
  const int b = bh / p.H;
  const int h = bh - b * p.H;
  const int n_tiles = (p.Sk + BLOCK_N - 1) / BLOCK_N;
  const int wg = threadIdx.x >> 7;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(v_full(s), 1);
      mbar_init(k_empty(s), 8);  // lane 0 of each consumer warp
      mbar_init(v_empty(s), 8);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == 0) {
    // ------------------------------------------------------------ producer
    reg_dealloc<24>();
    if (threadIdx.x == 0) {
      mbar_expect_tx(bar_q, C::Q_BYTES);
      for (int x = 0; x < C::BOXES; ++x)
        tma_load_4d(sQ + x * C::BOX_Q, &tq, bar_q, x * 64, h, m0, b);
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % STAGES;
        const uint32_t ph = (t / STAGES) & 1;
        mbar_wait(k_empty(s), ph ^ 1);
        mbar_expect_tx(k_full(s), C::KV_BYTES);
        for (int x = 0; x < C::BOXES; ++x)
          tma_load_4d(sK + s * C::KV_BYTES + x * C::BOX_KV, &tk, k_full(s),
                      x * 64, h, t * BLOCK_N, b);
        mbar_wait(v_empty(s), ph ^ 1);
        mbar_expect_tx(v_full(s), C::KV_BYTES);
        for (int x = 0; x < C::BOXES; ++x)
          tma_load_4d(sV + s * C::KV_BYTES + x * C::BOX_KV, &tv, v_full(s),
                      x * 64, h, t * BLOCK_N, b);
      }
    }
  } else {
    // ------------------------------------------------------------ consumers
    reg_alloc<240>();
    const int c = wg - 1;               // which 64 query rows
    const int warp = (threadIdx.x >> 5) & 3;
    const int lane = threadIdx.x & 31;
    const int g = lane >> 2;
    const int tig = lane & 3;
    const int my_turn = c == 0 ? BAR_TURN0 : BAR_TURN1;
    const int their_turn = c == 0 ? BAR_TURN1 : BAR_TURN0;

    float o[D / 2];
    #pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    float sacc[64];
    uint32_t pf[8][4];  // P as A fragments, 8 steps of 16 keys
    float row_l[2] = {0.f, 0.f};
    float row_m[2] = {-INFINITY, -INFINITY};  // ONLINE: the running max
    float alpha[2];     // ONLINE: the factor of the earlier tiles
    uint4 mw = make_uint4(0u, 0u, 0u, 0u);  // the key tile's mask words
    // the mask words of key tile t (MASK)
    auto mask_words = [&](int t) {
      if constexpr (MASK)
        mw = __ldg(p.mask + static_cast<long long>(b) * n_tiles + t);
    };

    // O += P V(t) with V of stage s
    auto pv = [&](int s) {
      const uint64_t dv = opaque(desc(sV + s * C::KV_BYTES, C::BOX_KV, 1024));
      #pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        const uint64_t db = desc_add(dv, kk * 2048);
        if constexpr (D == 128)
          wgmma_rs_n128<1>(o, pf[kk], db);
        else
          wgmma_rs_n64<1>(o, pf[kk], db);
      }
    };

    // S = Q K(t)^T, K of stage s
    auto qk = [&](int s) {
      const uint64_t dq = opaque(desc(sQ + c * 64 * 128, 16, 1024));
      const uint64_t dk = opaque(desc(sK + s * C::KV_BYTES, 16, 1024));
      #pragma unroll
      for (int ks = 0; ks < D / 16; ++ks)
        wgmma_ss_n128<0, 0>(
            sacc, desc_add(dq, (ks >> 2) * C::BOX_Q + (ks & 3) * 32),
            desc_add(dk, (ks >> 2) * C::BOX_KV + (ks & 3) * 32), ks > 0);
    };
    // P = exp2(s * scale - m) of tile t in place, and its row sums, m the
    // running max (ONLINE, alpha the factor of the earlier tiles) or M;
    // masked keys (MASK) and keys past Sk (last tile only) give 0
    auto softmax = [&](int t) {
      const int valid = p.Sk - t * BLOCK_N;
      if constexpr (MASK) {
        // column nb * 8 + tig * 2 + (i & 1) is bit (nb & 3) * 8 + (i & 1)
        // of the word nb / 4 shifted to this thread's columns; masked
        // keys score -inf before the max and the exp2 (sm_scale > 0), the
        // words' zeros past Sk taking the place of the last tile's test
        const uint32_t mk[4] = {mw.x >> (tig * 2), mw.y >> (tig * 2),
                                mw.z >> (tig * 2), mw.w >> (tig * 2)};
        #pragma unroll
        for (int nb = 0; nb < 16; ++nb)
          #pragma unroll
          for (int i = 0; i < 4; ++i)
            if (!((mk[nb >> 2] >> ((nb & 3) * 8 + (i & 1))) & 1u))
              sacc[nb * 4 + i] = -INFINITY;
      }
      if constexpr (ONLINE) {
        if (!MASK && valid < BLOCK_N) {
          #pragma unroll
          for (int nb = 0; nb < 16; ++nb)
            #pragma unroll
            for (int i = 0; i < 4; ++i)
              if (nb * 8 + tig * 2 + (i & 1) >= valid)
                sacc[nb * 4 + i] = -INFINITY;
        }
        float mx[2] = {-INFINITY, -INFINITY};
        #pragma unroll
        for (int i = 0; i < 64; ++i)
          mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sacc[i]);
        float m_exp[2];  // the max the exponents are taken against
        #pragma unroll
        for (int r = 0; r < 2; ++r) {
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffff, mx[r], 1));
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffff, mx[r], 2));
          const float m_new = fmaxf(row_m[r], mx[r] * p.scale_log2);
          // a row with no valid key so far (MASK) counts its max as 0
          m_exp[r] = MASK && m_new == -INFINITY ? 0.f : m_new;
          alpha[r] = fast_exp2(row_m[r] - m_exp[r]);
          row_m[r] = m_new;
          row_l[r] *= alpha[r];
        }
        #pragma unroll
        for (int i = 0; i < 64; ++i) {
          const float e = fast_exp2(
              fmaf(sacc[i], p.scale_log2, -m_exp[(i >> 1) & 1]));
          sacc[i] = e;
          row_l[(i >> 1) & 1] += e;
        }
      } else if (!MASK && valid < BLOCK_N) {
        #pragma unroll
        for (int nb = 0; nb < 16; ++nb)
          #pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int col = nb * 8 + tig * 2 + (i & 1);
            const float e = col < valid
                                ? fast_exp2(fmaf(sacc[nb * 4 + i],
                                                 p.scale_log2, -p.static_max))
                                : 0.f;
            sacc[nb * 4 + i] = e;
            row_l[i >> 1] += e;
          }
      } else {
        #pragma unroll
        for (int i = 0; i < 64; ++i) {
          const float e =
              fast_exp2(fmaf(sacc[i], p.scale_log2, -p.static_max));
          sacc[i] = e;
          row_l[(i >> 1) & 1] += e;
        }
      }
    };
    auto pack = [&]() {
      #pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        pf[kk][0] = pack_bf16(sacc[8 * kk + 0], sacc[8 * kk + 1]);
        pf[kk][1] = pack_bf16(sacc[8 * kk + 2], sacc[8 * kk + 3]);
        pf[kk][2] = pack_bf16(sacc[8 * kk + 4], sacc[8 * kk + 5]);
        pf[kk][3] = pack_bf16(sacc[8 * kk + 6], sacc[8 * kk + 7]);
      }
    };
    auto release = [&](uint32_t bar) {
      __syncwarp();
      if (lane == 0) mbar_arrive(bar);
    };

    if (c == 1) named_arrive(BAR_TURN0, 256);  // warpgroup 1 goes first
    mask_words(0);
    mbar_wait(bar_q, 0);
    mbar_wait(k_full(0), 0);
    named_sync(my_turn, 256);
    wgmma_fence();
    qk(0);
    wgmma_commit();
    named_arrive(their_turn, 256);
    wgmma_wait<0>();
    release(k_empty(0));
    softmax(0);
    pack();
    for (int t = 0; t + 1 < n_tiles; ++t) {
      // one turn: S(t+1), then PV(t); tile t+1's exp2 runs while PV(t)
      // is still on the tensor cores
      const int s = t % STAGES;
      const int s1 = (t + 1) % STAGES;
      mbar_wait(k_full(s1), ((t + 1) / STAGES) & 1);
      mbar_wait(v_full(s), (t / STAGES) & 1);
      named_sync(my_turn, 256);
      wgmma_fence();
      qk(s1);
      wgmma_commit();
      pv(s);
      wgmma_commit();
      named_arrive(their_turn, 256);
      mask_words(t + 1);
      wgmma_wait<1>();
      release(k_empty(s1));
      softmax(t + 1);
      wgmma_wait<0>();
      release(v_empty(s));
      if constexpr (ONLINE) {
        // O of tiles up to t, now complete, onto tile t+1's max
        #pragma unroll
        for (int i = 0; i < D / 2; ++i) o[i] *= alpha[(i >> 1) & 1];
      }
      pack();
    }
    // the last tile's PV product
    const int sl = (n_tiles - 1) % STAGES;
    mbar_wait(v_full(sl), ((n_tiles - 1) / STAGES) & 1);
    named_sync(my_turn, 256);
    wgmma_fence();
    pv(sl);
    wgmma_commit();
    named_arrive(their_turn, 256);
    wgmma_wait<0>();
    release(v_empty(sl));
    // warpgroup 1's last hand-over is to warpgroup 0: take it
    if (c == 0) named_sync(BAR_TURN0, 256);

    #pragma unroll
    for (int r = 0; r < 2; ++r) {
      float l = row_l[r];
      l += __shfl_xor_sync(0xffffffff, l, 1);
      l += __shfl_xor_sync(0xffffffff, l, 2);
      const float inv = l > 0.f ? 1.f / l : 0.f;
      const int row = m0 + c * 64 + warp * 16 + g + r * 8;
      if (row < p.Sq) {
        __nv_bfloat16* orow = p.o + b * p.o_sb + h * p.o_sh + row * p.o_ss;
        #pragma unroll
        for (int db = 0; db < D / 8; ++db)
          *reinterpret_cast<__nv_bfloat162*>(orow + db * 8 + tig * 2) =
              __floats2bfloat162_rn(o[db * 4 + 2 * r] * inv,
                                    o[db * 4 + 2 * r + 1] * inv);
        if constexpr (LSE) {
          if (tig == 0)
            p.lse[(static_cast<long long>(b) * p.H + h) * p.Sq + row] =
                ((ONLINE ? row_m[r] : p.static_max) + log2f(l)) *
                0.69314718055994531f;
        }
      }
    }
  }
}

// ------------------------------------------------------------ persistent
constexpr int P_Q_STAGES = 3;   // Q tiles in flight
constexpr int P_KV_STAGES = 4;  // K/V ring: two units of two key tiles
constexpr int P_UNIT_M_MAX = 8;  // query tiles of a unit of one key tile

template <int D>
struct PCfg {
  static_assert(D == 64 || D == 80, "padded head width 64 or 80");
  static constexpr bool TAIL = D == 80;          // the 16-column box
  static constexpr int BOX_Q = BLOCK_M * 128;    // 64-column box of Q
  static constexpr int BOX_KV = BLOCK_N * 128;   // 64-column box of K or V
  static constexpr int Q_BYTES = BOX_Q + (TAIL ? BLOCK_M * 32 : 0);
  static constexpr int KV_BYTES = BOX_KV + (TAIL ? BLOCK_N * 32 : 0);
  static constexpr int TILES =
      P_Q_STAGES * Q_BYTES + 2 * P_KV_STAGES * KV_BYTES;
  // tiles, then the mbarriers, plus slack to align the base to 1024 bytes
  static constexpr int SMEM = TILES + 256 + 1024;
};

struct PParams {
  __nv_bfloat16* o;
  float* lse;        // (B, H, Sq) f32, or null without the LSE
  const uint4* mask; // (B, key tiles) x 4 words of the key mask (MASK)
  int H, Sq, Sk, d;
  int m_tiles;       // query tiles of a head
  int unit_m;        // query tiles of a unit: 1, or more while K, V stay
  int splits;        // key ranges of a query tile (> 1: unit_m is 1)
  int n_units;
  float* part_o;     // split: (units, BLOCK_M, D) f32 unnormalised o
  float* part_ml;    // split: (units, BLOCK_M, 2) f32 m and l of a row
  long long o_sb, o_ss, o_sh;
  float scale_log2;  // sm_scale * log2(e)
  float static_max;  // M, log2 domain (fixed max only)
};

// Work unit u of the persistent walk: head bh, its first query tile mt0,
// and key tiles [t0, t1).  Units run head by head, a head's query-tile
// chunks in order, a chunk's `splits` key ranges adjacent: range j is
// [j * n_tiles / splits, (j + 1) * n_tiles / splits), as
// `_fwd_split_plan` (kernels/attention.py) cuts it.  With splits = 1 the
// unit walks every key tile; with splits > 1 a chunk is one query tile and
// u is its partial slot.  Without SPLIT, splits is 1 at compile time and
// the walk is the unsplit kernel's own: with splits a runtime value, the
// decode and the epilogue's branch slowed K1 at CogVideoX's shape.
struct Unit {
  int bh, mt0, t0, t1;
};
template <bool SPLIT>
__device__ __forceinline__ Unit unit_of(int u, int chunks, int unit_m,
                                        int splits, int n_tiles) {
  if (!SPLIT) splits = 1;
  const int per_head = chunks * splits;
  Unit x;
  x.bh = u / per_head;
  const int rem = u - x.bh * per_head;
  const int chunk = rem / splits;
  const int j = rem - chunk * splits;
  x.mt0 = chunk * unit_m;
  x.t0 = j * n_tiles / splits;
  x.t1 = (j + 1) * n_tiles / splits;
  return x;
}

template <int D, bool ONLINE, bool LSE, bool MASK, bool SPLIT>
__global__ void __launch_bounds__(THREADS, 1)
    flash_fwd_sm90_persistent(const __grid_constant__ CUtensorMap tq,
                              const __grid_constant__ CUtensorMap tq2,
                              const __grid_constant__ CUtensorMap tk,
                              const __grid_constant__ CUtensorMap tk2,
                              const __grid_constant__ CUtensorMap tv,
                              const __grid_constant__ CUtensorMap tv2,
                              const PParams p) {
  using C = PCfg<D>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t sQ = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sK = sQ + P_Q_STAGES * C::Q_BYTES;   // P_KV_STAGES tiles
  const uint32_t sV = sK + P_KV_STAGES * C::KV_BYTES;  // P_KV_STAGES tiles
  const uint32_t bars = sV + P_KV_STAGES * C::KV_BYTES;
  auto q_full = [&](int s) { return bars + 16 * s; };
  auto q_empty = [&](int s) { return bars + 8 + 16 * s; };
  const uint32_t kv_bars = bars + 16 * P_Q_STAGES;
  auto k_full = [&](int s) { return kv_bars + 32 * s; };
  auto k_empty = [&](int s) { return kv_bars + 8 + 32 * s; };
  auto v_full = [&](int s) { return kv_bars + 16 + 32 * s; };
  auto v_empty = [&](int s) { return kv_bars + 24 + 32 * s; };

  const int n_tiles = (p.Sk + BLOCK_N - 1) / BLOCK_N;
  const int chunks = (p.m_tiles + p.unit_m - 1) / p.unit_m;  // units a head
  const int wg = threadIdx.x >> 7;

  if (threadIdx.x == 0) {
    for (int s = 0; s < P_Q_STAGES; ++s) {
      mbar_init(q_full(s), 1);
      mbar_init(q_empty(s), 8);  // lane 0 of each consumer warp
    }
    for (int s = 0; s < P_KV_STAGES; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(v_full(s), 1);
      mbar_init(k_empty(s), 8);
      mbar_init(v_empty(s), 8);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == 0) {
    // ------------------------------------------------------------ producer
    reg_dealloc<40>();
    if (threadIdx.x == 0) {
      int qi = 0, kvi = 0;  // Q tiles and K/V tiles loaded so far
      for (int u = blockIdx.x; u < p.n_units; u += gridDim.x) {
        const Unit x = unit_of<SPLIT>(u, chunks, p.unit_m, p.splits,
                                      n_tiles);
        const int mts = min(p.unit_m, p.m_tiles - x.mt0);
        const int b = x.bh / p.H;
        const int h = x.bh - b * p.H;
        // the unit's first Q tile, its K and V tiles, then its other Q tile
        for (int j = 0; j < mts; ++j) {
          const int s = qi % P_Q_STAGES;
          mbar_wait(q_empty(s), ((qi / P_Q_STAGES) & 1) ^ 1);
          ++qi;
          const uint32_t dst = sQ + s * C::Q_BYTES;
          const int m0 = (x.mt0 + j) * BLOCK_M;
          mbar_expect_tx(q_full(s), C::Q_BYTES);
          tma_load_4d(dst, &tq, q_full(s), 0, h, m0, b);
          if constexpr (C::TAIL)
            tma_load_4d(dst + C::BOX_Q, &tq2, q_full(s), 64, h, m0, b);
          for (int t = x.t0; j == 0 && t < x.t1; ++t, ++kvi) {
            const int ks = kvi % P_KV_STAGES;
            const uint32_t ph = ((kvi / P_KV_STAGES) & 1) ^ 1;
            const uint32_t dk = sK + ks * C::KV_BYTES;
            const uint32_t dv = sV + ks * C::KV_BYTES;
            mbar_wait(k_empty(ks), ph);
            mbar_expect_tx(k_full(ks), C::KV_BYTES);
            tma_load_4d(dk, &tk, k_full(ks), 0, h, t * BLOCK_N, b);
            if constexpr (C::TAIL)
              tma_load_4d(dk + C::BOX_KV, &tk2, k_full(ks), 64, h,
                          t * BLOCK_N, b);
            mbar_wait(v_empty(ks), ph);
            mbar_expect_tx(v_full(ks), C::KV_BYTES);
            tma_load_4d(dv, &tv, v_full(ks), 0, h, t * BLOCK_N, b);
            if constexpr (C::TAIL)
              tma_load_4d(dv + C::BOX_KV, &tv2, v_full(ks), 64, h,
                          t * BLOCK_N, b);
          }
        }
      }
    }
  } else {
    // ------------------------------------------------------------ consumers
    reg_alloc<232>();
    const int c = wg - 1;               // which 64 query rows
    const int warp = (threadIdx.x >> 5) & 3;
    const int lane = threadIdx.x & 31;
    const int g = lane >> 2;
    const int tig = lane & 3;
    const int my_turn = c == 0 ? BAR_TURN0 : BAR_TURN1;
    const int their_turn = c == 0 ? BAR_TURN1 : BAR_TURN0;

    float o[D / 2];  // columns 0-63 (N = 64), then 64-79 (N = 16)
    #pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    float sacc[64];
    uint32_t pf[8][4];  // P as A fragments, 8 steps of 16 keys
    float row_l[2], row_m[2], alpha[2];
    uint4 mw = make_uint4(0u, 0u, 0u, 0u);  // the key tile's mask words
    // the mask words of key tile t of batch b (MASK)
    auto mask_words = [&](int b, int t) {
      if constexpr (MASK)
        mw = __ldg(p.mask + static_cast<long long>(b) * n_tiles + t);
    };

    // O += P V(t) with V of stage s
    auto pv = [&](int s) {
      const uint32_t va = sV + s * C::KV_BYTES;
      const uint64_t dv = opaque(desc(va, C::BOX_KV, 1024));
      const uint64_t dv2 =
          C::TAIL ? opaque(desc_sw32(va + C::BOX_KV, BLOCK_N * 32, 256)) : 0;
      #pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        wgmma_rs_n64<1>(o, pf[kk], desc_add(dv, kk * 2048));
        if constexpr (C::TAIL)
          wgmma_rs_n16<1>(o + 32, pf[kk], desc_add(dv2, kk * 512));
      }
    };
    // S = Q K(t)^T, Q of stage qs, K of stage s
    auto qk = [&](int qs, int s) {
      const uint32_t qa = sQ + qs * C::Q_BYTES + c * 64 * 128;
      const uint32_t ka = sK + s * C::KV_BYTES;
      const uint64_t dq = opaque(desc(qa, 16, 1024));
      const uint64_t dk = opaque(desc(ka, 16, 1024));
      #pragma unroll
      for (int ks = 0; ks < 4; ++ks)
        wgmma_ss_n128<0, 0>(sacc, desc_add(dq, ks * 32),
                            desc_add(dk, ks * 32), ks > 0);
      if constexpr (C::TAIL)
        wgmma_ss_n128<0, 0>(
            sacc,
            opaque(desc_sw32(sQ + qs * C::Q_BYTES + C::BOX_Q + c * 64 * 32,
                             16, 256)),
            opaque(desc_sw32(ka + C::BOX_KV, 16, 256)), 1);
    };
    // P = exp2(s * scale - m) of tile t in place and its row sums, m the
    // running max (ONLINE, alpha = the factor of the earlier tiles) or M;
    // masked keys (MASK) and keys past Sk (the last tile) give 0
    auto softmax = [&](int t) {
      const int valid = p.Sk - t * BLOCK_N;
      // MASK: the words shifted to this thread's columns; column
      // nb * 8 + tig * 2 + (i & 1) is bit (nb & 3) * 8 + (i & 1) of mk[nb / 4]
      uint32_t mk[4] = {0u, 0u, 0u, 0u};
      if constexpr (MASK) {
        mk[0] = mw.x >> (tig * 2);
        mk[1] = mw.y >> (tig * 2);
        mk[2] = mw.z >> (tig * 2);
        mk[3] = mw.w >> (tig * 2);
      }
      auto keep = [&](int nb, int i) {
        return ((mk[nb >> 2] >> ((nb & 3) * 8 + (i & 1))) & 1u) != 0u;
      };
      // masked keys score -inf: p = 0 under either softmax (sm_scale > 0)
      if constexpr (MASK) {
        #pragma unroll
        for (int nb = 0; nb < 16; ++nb)
          #pragma unroll
          for (int i = 0; i < 4; ++i)
            if (!keep(nb, i)) sacc[nb * 4 + i] = -INFINITY;
      }
      if constexpr (ONLINE) {
        if (!MASK && valid < BLOCK_N) {
          #pragma unroll
          for (int nb = 0; nb < 16; ++nb)
            #pragma unroll
            for (int i = 0; i < 4; ++i)
              if (nb * 8 + tig * 2 + (i & 1) >= valid)
                sacc[nb * 4 + i] = -INFINITY;
        }
        float mx[2] = {-INFINITY, -INFINITY};
        #pragma unroll
        for (int i = 0; i < 64; ++i)
          mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sacc[i]);
        float m_exp[2];  // the max the exponents are taken against
        #pragma unroll
        for (int r = 0; r < 2; ++r) {
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffff, mx[r], 1));
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffff, mx[r], 2));
          const float m_new = fmaxf(row_m[r], mx[r] * p.scale_log2);
          // a row with no valid key so far (MASK) counts its max as 0
          m_exp[r] = MASK && m_new == -INFINITY ? 0.f : m_new;
          alpha[r] = fast_exp2(row_m[r] - m_exp[r]);
          row_m[r] = m_new;
          row_l[r] *= alpha[r];
        }
        #pragma unroll
        for (int i = 0; i < 64; ++i) {
          const float e = fast_exp2(
              fmaf(sacc[i], p.scale_log2, -m_exp[(i >> 1) & 1]));
          sacc[i] = e;
          row_l[(i >> 1) & 1] += e;
        }
      } else if (!MASK && valid < BLOCK_N) {
        #pragma unroll
        for (int nb = 0; nb < 16; ++nb)
          #pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int col = nb * 8 + tig * 2 + (i & 1);
            const float e = col < valid
                                ? fast_exp2(fmaf(sacc[nb * 4 + i],
                                                 p.scale_log2, -p.static_max))
                                : 0.f;
            sacc[nb * 4 + i] = e;
            row_l[i >> 1] += e;
          }
      } else {
        #pragma unroll
        for (int i = 0; i < 64; ++i) {
          const float e =
              fast_exp2(fmaf(sacc[i], p.scale_log2, -p.static_max));
          sacc[i] = e;
          row_l[(i >> 1) & 1] += e;
        }
      }
    };
    auto pack = [&]() {
      #pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        pf[kk][0] = pack_bf16(sacc[8 * kk + 0], sacc[8 * kk + 1]);
        pf[kk][1] = pack_bf16(sacc[8 * kk + 2], sacc[8 * kk + 3]);
        pf[kk][2] = pack_bf16(sacc[8 * kk + 4], sacc[8 * kk + 5]);
        pf[kk][3] = pack_bf16(sacc[8 * kk + 6], sacc[8 * kk + 7]);
      }
    };
    auto release = [&](uint32_t bar) {
      __syncwarp();
      if (lane == 0) mbar_arrive(bar);
    };
    // o / l of the query tile at row m0, columns below d, and the LSE; or,
    // split, the unit's partials (o unnormalised, m, l) in partial slot
    // `slot`; then a zero accumulator for the next tile
    auto store = [&](int b, int h, int m0, int slot) {
      #pragma unroll
      for (int r = 0; r < 2; ++r) {
        float l = row_l[r];
        l += __shfl_xor_sync(0xffffffff, l, 1);
        l += __shfl_xor_sync(0xffffffff, l, 2);
        const float inv = l > 0.f ? 1.f / l : 0.f;
        const int row = m0 + c * 64 + warp * 16 + g + r * 8;
        if (SPLIT && row < p.Sq) {
          const long long pr =
              static_cast<long long>(slot) * BLOCK_M + (row - m0);
          float* po = p.part_o + pr * D;
          #pragma unroll
          for (int db = 0; db < D / 8; ++db)
            if (db * 8 < p.d)
              *reinterpret_cast<float2*>(po + db * 8 + tig * 2) =
                  make_float2(o[db * 4 + 2 * r], o[db * 4 + 2 * r + 1]);
          if (tig == 0) {
            p.part_ml[2 * pr] = ONLINE ? row_m[r] : p.static_max;
            p.part_ml[2 * pr + 1] = l;
          }
        }
        if (!SPLIT && row < p.Sq) {
          __nv_bfloat16* orow = p.o + b * p.o_sb + h * p.o_sh + row * p.o_ss;
          #pragma unroll
          for (int db = 0; db < D / 8; ++db)
            if (db * 8 < p.d)
              *reinterpret_cast<__nv_bfloat162*>(orow + db * 8 + tig * 2) =
                  __floats2bfloat162_rn(o[db * 4 + 2 * r] * inv,
                                        o[db * 4 + 2 * r + 1] * inv);
          if constexpr (LSE) {
            if (tig == 0)
              p.lse[(static_cast<long long>(b) * p.H + h) * p.Sq + row] =
                  ((ONLINE ? row_m[r] : p.static_max) + log2f(l)) *
                  0.69314718055994531f;
          }
        }
      }
      #pragma unroll
      for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    };

    if (c == 1) named_arrive(BAR_TURN0, 256);  // warpgroup 1 goes first
    int qi = 0, kvi = 0;  // Q tiles and K/V tiles consumed so far
    for (int u = blockIdx.x; u < p.n_units; u += gridDim.x) {
      const Unit x = unit_of<SPLIT>(u, chunks, p.unit_m, p.splits, n_tiles);
      const int mts = min(p.unit_m, p.m_tiles - x.mt0);
      const int b = x.bh / p.H;
      const int h = x.bh - b * p.H;
      const int nt = x.t1 - x.t0;  // key tiles of the unit; i counts them
      auto st = [&](int i) { return (kvi + i) % P_KV_STAGES; };
      auto ph = [&](int i) {
        return static_cast<uint32_t>(((kvi + i) / P_KV_STAGES) & 1);
      };
      for (int j = 0; j < mts; ++j) {
        // K and V go back to the producer after the unit's last query tile
        const bool last = j == mts - 1;
        const int qs = qi % P_Q_STAGES;
        const uint32_t qph = (qi / P_Q_STAGES) & 1;
        ++qi;
        row_l[0] = row_l[1] = 0.f;
        row_m[0] = row_m[1] = -INFINITY;
        mask_words(b, x.t0);
        mbar_wait(q_full(qs), qph);
        mbar_wait(k_full(st(0)), ph(0));
        named_sync(my_turn, 256);
        wgmma_fence();
        qk(qs, st(0));
        wgmma_commit();
        named_arrive(their_turn, 256);
        wgmma_wait<0>();
        if (last) release(k_empty(st(0)));
        softmax(x.t0);
        pack();
        for (int i = 0; i + 1 < nt; ++i) {
          // one turn: S(i+1), then PV(i); tile i+1's exp2 runs while PV(i)
          // is still on the tensor cores
          const int s = st(i);
          const int s1 = st(i + 1);
          mbar_wait(k_full(s1), ph(i + 1));
          mbar_wait(v_full(s), ph(i));
          named_sync(my_turn, 256);
          wgmma_fence();
          qk(qs, s1);
          wgmma_commit();
          pv(s);
          wgmma_commit();
          named_arrive(their_turn, 256);
          mask_words(b, x.t0 + i + 1);
          wgmma_wait<1>();
          if (last) release(k_empty(s1));
          softmax(x.t0 + i + 1);
          wgmma_wait<0>();
          if (last) release(v_empty(s));
          if constexpr (ONLINE) {
            #pragma unroll
            for (int i = 0; i < D / 2; ++i) o[i] *= alpha[(i >> 1) & 1];
          }
          pack();
        }
        // the last tile's PV product
        const int sl = st(nt - 1);
        mbar_wait(v_full(sl), ph(nt - 1));
        named_sync(my_turn, 256);
        wgmma_fence();
        pv(sl);
        wgmma_commit();
        named_arrive(their_turn, 256);
        wgmma_wait<0>();
        if (last) release(v_empty(sl));
        release(q_empty(qs));
        store(b, h, (x.mt0 + j) * BLOCK_M, u);
      }
      kvi += nt;
    }
    // warpgroup 1's last hand-over is to warpgroup 0: take it
    if (c == 0) named_sync(BAR_TURN0, 256);
  }
}

template <int D, bool LSE, bool ONLINE, bool MASK>
int launch(const void* q, const void* k, const void* v, const Params& p,
           int B, long long q_sb, long long q_ss, long long q_sh,
           long long k_sb, long long k_ss, long long k_sh, long long v_sb,
           long long v_ss, long long v_sh, cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  int err = sm90_host::make_map(&tq, q, B, p.Sq, p.H, D, q_sb, q_ss, q_sh,
                                BLOCK_M);
  if (err == 0)
    err = sm90_host::make_map(&tk, k, B, p.Sk, p.H, D, k_sb, k_ss, k_sh,
                              BLOCK_N);
  if (err == 0)
    err = sm90_host::make_map(&tv, v, B, p.Sk, p.H, D, v_sb, v_ss, v_sh,
                              BLOCK_N);
  if (err != 0) return err;
  auto kernel = flash_fwd_sm90_kernel<D, LSE, ONLINE, MASK>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Cfg<D>::SMEM);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((p.Sq + BLOCK_M - 1) / BLOCK_M, B * p.H);
  kernel<<<grid, THREADS, Cfg<D>::SMEM, stream>>>(tq, tk, tv, p);
  return static_cast<int>(cudaGetLastError());
}

// Strides (elements) of q, k and v: batch, sequence, head.
struct Strides {
  long long s[3][3];
};

// q, k, v (B, S, H, d) through the persistent kernel of padded width D: d
// = 64 at D = 64, d = 72 or 80 at D = 80
template <int D, bool ONLINE, bool LSE, bool MASK, bool SPLIT>
int launch_persistent(const void* q, const void* k, const void* v,
                      PParams p, int B, const Strides& st,
                      cudaStream_t stream) {
  // per tensor: the 64-column box and, at D = 80, the 16-column box (at
  // D = 64 the kernel reads no second map: the first stands in)
  constexpr int BOXES = PCfg<D>::TAIL ? 2 : 1;
  CUtensorMap m[6];
  const void* base[3] = {q, k, v};
  const int len[3] = {p.Sq, p.Sk, p.Sk};
  const int rows[3] = {BLOCK_M, BLOCK_N, BLOCK_N};
  for (int x = 0; x < 3; ++x) {
    for (int box = 0; box < BOXES; ++box) {
      const int err = sm90_host::make_map(
          &m[2 * x + box], base[x], B, len[x], p.H, p.d, st.s[x][0],
          st.s[x][1], st.s[x][2], rows[x], box == 0 ? 64 : 16);
      if (err != 0) return err;
    }
    if (BOXES == 1) m[2 * x + 1] = m[2 * x];
  }
  auto kernel = flash_fwd_sm90_persistent<D, ONLINE, LSE, MASK, SPLIT>;
  // per device, at the kernel's first launch there: its shared-memory limit
  // and the SM count (the grid); the launches after it skip both calls
  static int sms_of[64] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess && dev >= 64) e = cudaErrorInvalidDevice;
  if (e == cudaSuccess && sms_of[dev] == 0) {
    int sms = 0;
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             PCfg<D>::SMEM);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess) sms_of[dev] = sms;
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  const int sms = sms_of[dev];
  p.m_tiles = (p.Sq + BLOCK_M - 1) / BLOCK_M;
  const int n_tiles = (p.Sk + BLOCK_N - 1) / BLOCK_N;
  const long long heads = static_cast<long long>(B) * p.H;
  auto units_of = [&](int unit_m) {
    return heads * ((p.m_tiles + unit_m - 1) / unit_m);
  };
  p.unit_m = n_tiles <= P_KV_STAGES / 2 ? 2 : 1;
  if (n_tiles == 1) {
    // the largest unit whose busiest SM runs the fewest query tiles
    long long best = -1;
    for (int u = 1; u <= P_UNIT_M_MAX; u *= 2) {
      const long long span = (units_of(u) + sms - 1) / sms * u;
      if (best < 0 || span <= best) {
        best = span;
        p.unit_m = u;
      }
    }
  }
  // a split walks one query tile a unit, at most one range a key tile
  if (SPLIT != (p.splits > 1) || (SPLIT && (MASK || p.unit_m != 1 ||
                                            p.splits > n_tiles || !p.part_o)))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long units = units_of(p.unit_m) * p.splits;
  if (units > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  p.n_units = static_cast<int>(units);
  p.part_ml = SPLIT ? p.part_o + units * BLOCK_M * D : nullptr;
  const int grid = static_cast<int>(units < sms ? units : sms);
  kernel<<<grid, THREADS, PCfg<D>::SMEM, stream>>>(m[0], m[1], m[2], m[3],
                                                   m[4], m[5], p);
  const int err = static_cast<int>(cudaGetLastError());
  if (err != 0 || !SPLIT) return err;
  split::CombineParams cp;
  cp.part_o = p.part_o;
  cp.part_ml = p.part_ml;
  cp.table = nullptr;
  cp.splits = p.splits;
  cp.slots = p.m_tiles * p.splits;
  cp.block_m = BLOCK_M;
  cp.pitch = D;
  cp.d = p.d;
  cp.H = p.H;
  cp.Sq = p.Sq;
  cp.o_sb = p.o_sb;
  cp.o_ss = p.o_ss;
  cp.o_sh = p.o_sh;
  cp.lse = p.lse;
  cp.online = ONLINE;
  return split::combine(cp, p.o, p.m_tiles, static_cast<int>(heads), stream);
}

// the persistent kernel's instantiation for the run-time options
template <int D, bool MASK, bool SPLIT>
int launch_persistent_modes(const void* q, const void* k, const void* v,
                            const PParams& p, int B, const Strides& st,
                            bool online, bool lse, cudaStream_t stream) {
  if (online && lse)
    return launch_persistent<D, true, true, MASK, SPLIT>(q, k, v, p, B, st,
                                                         stream);
  if (online)
    return launch_persistent<D, true, false, MASK, SPLIT>(q, k, v, p, B, st,
                                                          stream);
  if (lse)
    return launch_persistent<D, false, true, MASK, SPLIT>(q, k, v, p, B, st,
                                                          stream);
  return launch_persistent<D, false, false, MASK, SPLIT>(q, k, v, p, B, st,
                                                         stream);
}

// The key mask (B, Sk) bytes (0 = masked), rows `sb` bytes apart, as the
// persistent kernel reads it: one warp a 32-key word, lane c's key bit c,
// 0 past Sk; (B, n_words) words, four a 128-key tile.
__global__ void pack_mask_kernel(const unsigned char* mask, uint32_t* words,
                                 int Sk, long long sb, int n_words) {
  const int b = blockIdx.y;
  const int key = blockIdx.x * 128 + threadIdx.x;
  const bool valid = key < Sk && mask[b * sb + key] != 0;
  const uint32_t w = __ballot_sync(0xffffffffu, valid);
  if ((threadIdx.x & 31) == 0)
    words[static_cast<long long>(b) * n_words + (key >> 5)] = w;
}

int pack_mask(const void* mask, long long mask_sb, void* words, int B,
              int Sk, cudaStream_t s) {
  if (B <= 0 || B > 65535 || Sk <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int n_tiles = (Sk + BLOCK_N - 1) / BLOCK_N;
  pack_mask_kernel<<<dim3(n_tiles, B), BLOCK_N, 0, s>>>(
      static_cast<const unsigned char*>(mask), static_cast<uint32_t*>(words),
      Sk, mask_sb, 4 * n_tiles);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The (B, Sk) key mask as bytes (0 = masked), rows `mask_sb` bytes apart,
// packed into `words` ((B, ceil(Sk / 128) * 4) 32-bit words, 16-byte
// aligned) as the persistent kernel and the short-row backward
// (flash_bwd_rows_sm90.cu) read them.  Returns the CUDA error of the launch.
extern "C" int pack_mask_words(const void* mask, long long mask_sb,
                               void* words, int B, int Sk, void* stream) {
  return pack_mask(mask, mask_sb, words, B, Sk,
                   static_cast<cudaStream_t>(stream));
}

// Returns the CUDA error of the launch (0 on success); cudaErrorInvalidValue
// for what no kernel takes: a head width other than 64, 72, 80 or 128; a
// key mask at d = 64; at 128 (K3's kernel) the LSE with the online softmax
// or a key mask, a split, or B*H above 65535; or a tensor TMA cannot read
// in place.  d = 64, 72 and 80 take the persistent kernel.  `lse` is null
// without the LSE; `online` 0 takes the fixed max `static_max`.  `words`
// is null without a key mask, else the mask's (B, ceil(Sk / 128) * 4)
// 32-bit words (16-byte aligned) that the persistent kernel reads: packed
// by an earlier `pack_mask_words` when `mask` is null, else first packed
// by this call from `mask`, the (B, Sk) key mask as bytes (0 = masked),
// rows `mask_sb` bytes apart.  `splits` > 1 (unmasked, d = 64, 72 or 80, at
// least 3 key tiles, at most one range a key tile) cuts each query tile's
// keys into that many ranges: `part` is then f32 scratch of
// B*H*ceil(Sq/128)*splits*128*(D + 2) floats (D = 64 at d = 64, else 80),
// and a second launch combines the partials into o and the LSE.
extern "C" int flash_fwd_sm90_bf16(
    const void* q, const void* k, const void* v, void* o, void* lse,
    const void* mask, long long mask_sb, void* words, int B, int H, int Sq,
    int Sk, int d, long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh, long long v_sb,
    long long v_ss, long long v_sh, long long o_sb, long long o_ss,
    long long o_sh, float scale_log2, int online, float static_max,
    int splits, void* part, void* stream) {
  if (B <= 0 || H <= 0 || Sq <= 0 || Sk <= 0 || splits < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Strides st = {{{q_sb, q_ss, q_sh}, {k_sb, k_ss, k_sh},
                       {v_sb, v_ss, v_sh}}};
  const bool wide = d == 72 || d == 80;
  if (wide || d == 64) {
    if ((mask || words) && !wide)
      return static_cast<int>(cudaErrorInvalidValue);
    if (mask) {
      if (!words) return static_cast<int>(cudaErrorInvalidValue);
      const int e = pack_mask(mask, mask_sb, words, B, Sk, s);
      if (e != 0) return e;
    }
    PParams p;
    p.o = static_cast<__nv_bfloat16*>(o);
    p.lse = static_cast<float*>(lse);
    p.mask = static_cast<const uint4*>(words);
    p.H = H;
    p.Sq = Sq;
    p.Sk = Sk;
    p.d = d;
    p.o_sb = o_sb;
    p.o_ss = o_ss;
    p.o_sh = o_sh;
    p.scale_log2 = scale_log2;
    p.static_max = static_max;
    p.splits = splits;
    p.part_o = static_cast<float*>(part);
    const bool l = lse != nullptr;
    if (words)
      return splits > 1 ? static_cast<int>(cudaErrorInvalidValue)
                        : launch_persistent_modes<80, true, false>(
                              q, k, v, p, B, st, online, l, s);
    if (!wide)
      return splits > 1 ? launch_persistent_modes<64, false, true>(
                              q, k, v, p, B, st, online, l, s)
                        : launch_persistent_modes<64, false, false>(
                              q, k, v, p, B, st, online, l, s);
    return splits > 1 ? launch_persistent_modes<80, false, true>(
                            q, k, v, p, B, st, online, l, s)
                      : launch_persistent_modes<80, false, false>(
                            q, k, v, p, B, st, online, l, s);
  }
  // K3's kernel: the LSE under the fixed max alone, never split
  if (d != 128 || splits != 1 || (lse && (online || words)) ||
      (long long)B * H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (mask) {
    if (!words) return static_cast<int>(cudaErrorInvalidValue);
    const int e = pack_mask(mask, mask_sb, words, B, Sk, s);
    if (e != 0) return e;
  }
  Params p;
  p.o = static_cast<__nv_bfloat16*>(o);
  p.lse = static_cast<float*>(lse);
  p.mask = static_cast<const uint4*>(words);
  p.H = H;
  p.Sq = Sq;
  p.Sk = Sk;
  p.o_sb = o_sb;
  p.o_ss = o_ss;
  p.o_sh = o_sh;
  p.scale_log2 = scale_log2;
  p.static_max = static_max;
  if (lse)
    return launch<128, true, false, false>(q, k, v, p, B, q_sb, q_ss, q_sh,
                                           k_sb, k_ss, k_sh, v_sb, v_ss,
                                           v_sh, s);
  if (words && online)
    return launch<128, false, true, true>(q, k, v, p, B, q_sb, q_ss, q_sh,
                                          k_sb, k_ss, k_sh, v_sb, v_ss,
                                          v_sh, s);
  if (words)
    return launch<128, false, false, true>(q, k, v, p, B, q_sb, q_ss, q_sh,
                                           k_sb, k_ss, k_sh, v_sb, v_ss,
                                           v_sh, s);
  if (online)
    return launch<128, false, true, false>(q, k, v, p, B, q_sb, q_ss, q_sh,
                                           k_sb, k_ss, k_sh, v_sb, v_ss,
                                           v_sh, s);
  return launch<128, false, false, false>(q, k, v, p, B, q_sb, q_ss, q_sh,
                                          k_sb, k_ss, k_sh, v_sb, v_ss, v_sh,
                                          s);
}
