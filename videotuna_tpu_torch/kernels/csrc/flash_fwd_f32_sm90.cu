// Flash-attention forward for f32 q, k, v at head widths 64, 80 and 128 on
// Hopper (sm_90a): split key ranges, an asynchronous ring of f32 tiles, and
// three bf16 tensor-core products a product.
//
// Replaces, for f32 inputs at d = 64, 80 and 128 without a key mask, the
// TPU kernel K2 of the JAX package, `_flash_kernel` launched by
// `flash_attention` (videotuna_tpu/kernels/attention.py:78, :812;
// `pallas_call` at :812), and the same function on routes K1, K3 and K5
// (at d = 64 with an even head count the dispatch names it K1,
// `_flash_packed2t`, :494).  Its main-path callers: HunyuanVideo's LLaMA
// text encoder (32 layers of causal self-attention over 256 tokens, 32
// heads of d = 128, GQA's kv heads repeated before the call; in the I2V
// prompt encode over 934 tokens), the LLaVA CLIP tower of the I2V prompt
// encode (ViT-L/14 at 336 px: 577 tokens, 16 heads of d = 64), the CLIP
// ViT-H/14 image embedder (256 tokens, 16 heads of d = 80), and the 2D
// VAE's f32 mid attention (one head of d = 128).  The key-masked f32
// forward and other widths stay on flash_fwd.cu, which stays this
// kernel's A/B baseline.
//
// Widths.  One template over D: a tile is 32 keys and 64 query rows at
// every width, the ring two stages; the row pitches are D + 8 (K, Q) and
// D + 4 (V) floats at every width, which keeps the fragment loads free of
// bank conflicts (D + 8 is 8 or 24 mod 32, 2 (D + 4) is 8 mod 32).  At
// D = 80 a V tile is 2.5 chunks a thread, so its loops are guarded.
// Shared memory a block: 69,632 bytes at 128, 45,056 at 80, 36,864 at 64.
//
// Function.  The function of `flash_fwd` (flash_fwd.cu) on f32 inputs:
// s = (q.k) * sm_scale * log2e, -inf above the top-left causal diagonal
// (key j counts for query row i when j <= i) and past Sk; the online
// softmax (a running row max, the accumulator rescaled by exp2(m_old - m))
// or the fixed max M; o = (p @ v) / l in f32; with `lse` the natural-log
// LSE (B, H, Sq), -inf for a row without a valid key.
//
// What bounds it.  At LLaMA's shape (B = 1, S = 256, H = 32, causal) q, k,
// v and o are 16.8 MB of f32: 5.0 us at 3.35 TB/s.  The causal half of the
// scores, 2.2e8 multiply-adds of QK^T and as many of PV, costs 1.6 GFLOP as
// three bf16 products each, 1.6 us at 989 TF/s.  So bytes bound it, and at
// this size the latency of each block's chain (its loads, then its key
// tiles one after the other) more than either.  The old design
// (flash_fwd.cu) gave each 64-row query tile of a head one block of 4
// warps: 128 blocks, one per SM, 4 of its 64 warp slots in use, the last
// query tile walking 8 key tiles of 32 one after another, each tile loaded
// with plain loads that did not overlap the products.
//
// Design.
// - Units.  A unit is a 64-row query tile and a range of 32-key tiles
//   inside the causal triangle, cut by `_fwd_split_plan`
//   (kernels/attention.py) so that the units fill the card, two blocks to
//   an SM: at LLaMA's shape the four query tiles have 2, 4, 6 and 8 key
//   tiles and take 1, 2, 2 and 3 ranges of two or three tiles, 8 units a
//   head, 256 blocks in one wave.  (Three blocks to an SM, 320 units of at
//   most two tiles, left 168 registers a thread and spilled; at two the
//   call took 0.0199 ms against 0.0240 on an H100 at 700 W.)  The plan
//   comes as a table of (query tile, first key tile, end key tile, partial
//   slot) per unit, the same for every head (blockIdx.y is the head).  A query
//   tile of one range writes o and the LSE; the units of a split tile
//   write f32 partials (o unnormalised, the row's m and l), and the
//   combine of split_combine.cuh, launched second, sums them in a fixed
//   order into o and the LSE.  (The last unit of a tile, found by a
//   ticket, combining in place of the second launch was slower: its one
//   block for a whole tile took longer than the launch.)
// - Loads.  K and V tiles (32 keys x 128 f32) go into a two-stage ring in
//   shared memory by 16-byte cp.async, so that tile t+1 lands while tile t
//   is multiplied; keys past Sk are zero-filled.  K rows are 136 floats
//   apart and V rows 132, which makes both fragment loads below free of
//   bank conflicts.  The Q tile comes the same way, into stage 1 before
//   its first K and V; its fragments are read once a unit.  A block takes
//   69.6 KB of shared memory.
// - The split.  Each f32 value x becomes hi = bf16(x) and lo = bf16(x -
//   hi).  A tile is split once, in place, by the threads that copied it
//   (no second copy in shared memory), into the order the fragment loads
//   want: K's hi and lo of a pair of depths side by side (one 8-byte load),
//   V's hi of a pair of keys in one word and their lo in the next row.
//   Split where each warp loads its fragments instead, the same tile is
//   split by all four warps, four times the conversions (which run at 16
//   a clock per SM).  Q is split once a unit as its fragments are read, P
//   in registers.
// - Products.  mma.sync m16n8k16, bf16 in, f32 accumulate; a product is
//   hi.hi + hi.lo + lo.hi (S = Q K^T, and O += P V).
//   Error budget: x - hi - lo is below 2^-17 |x| and the dropped lo.lo
//   below 2^-18 |x y|, so each product carries about 2^-16 of relative
//   error, f32 accumulation adds 2^-24 a term: o agrees with the f32 plain
//   version to about 1e-5 of max|o| and the LSE to about 1e-5, within the
//   gates of 1e-4 of max|o| and 1e-4 (three TF32 products would give 2^-21
//   at half the tensor-core rate; the bf16 split was kept).  Each warp owns
//   16 query rows; the S accumulator becomes P's A fragments in registers.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "split_combine.cuh"

namespace {

constexpr int BLOCK_M = 64;       // query rows of a unit: 4 warps of 16
constexpr int BLOCK_N = 32;       // keys a tile
constexpr int THREADS = 128;
constexpr int NB = BLOCK_N / 8;   // 8-key blocks of S
constexpr int KK = BLOCK_N / 16;  // 16-key steps of PV

template <int D>
struct Tile {
  static constexpr int LDK = D + 8;  // K row pitch in floats
  static constexpr int LDV = D + 4;  // V row pitch in floats
  static constexpr int LDQ = D + 8;  // Q row pitch in floats
  // floats of a stage: one K and V tile, or (stage 1, first) the Q tile
  static constexpr int STAGE = BLOCK_N * (LDK + LDV) > BLOCK_M * LDQ
                                   ? BLOCK_N * (LDK + LDV)
                                   : BLOCK_M * LDQ;
  static constexpr int SMEM = 2 * STAGE * 4;  // two stages, bytes
  static constexpr int KS = D / 16;  // depth steps of QK^T
  static constexpr int DB = D / 8;   // 8-column blocks of O
  // 16-byte chunks a thread: of a K tile (whole), of a V tile's row pairs
  // (rounded up: 2.5 at D = 80) and of the Q tile
  static constexpr int K_CHUNKS = BLOCK_N * D / 4 / THREADS;
  static constexpr int V_PAIRS = BLOCK_N / 2 * (D / 4);
  static constexpr int V_CHUNKS = (V_PAIRS + THREADS - 1) / THREADS;
  static constexpr int Q_CHUNKS = BLOCK_M * D / 4 / THREADS;
  static_assert(D % 16 == 0 && BLOCK_N * D % (4 * THREADS) == 0 &&
                    BLOCK_M * D % (4 * THREADS) == 0,
                "a width whose K and Q tiles split evenly over the threads");
};

struct Params {
  const float* q;
  const float* k;
  const float* v;
  float* o;
  float* lse;      // (B, H, Sq) or null
  float* part_o;   // (B*H*slots, BLOCK_M, D) unnormalised o of split units
  float* part_ml;  // (B*H*slots, BLOCK_M, 2) their m and l
  // per unit: query tile, first key tile, end key tile, partial slot (-1:
  // the tile is not split)
  const int4* units;
  int H, Sq, Sk, slots;
  long long q_sb, q_ss, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long o_sb, o_ss, o_sh;
  float scale_log2;  // sm_scale * log2(e)
  float static_max;  // M, log2 domain (fixed max)
  int causal;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// 16-byte async copy; src_bytes == 0 fills the destination with zeros.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}
// D (16x8 f32) += A (16x16 bf16, row) * B (16x8 bf16, col)
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ float fast_exp2(float x) {  // -inf gives +0
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}
// (x0, x1) -> the packed bf16 pair of hi = bf16(x) and that of lo =
// bf16(x - hi), x0 in the low half
__device__ __forceinline__ void split_pack(float x0, float x1, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 f = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(x0 - f.x, x1 - f.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

template <int D, bool STATIC_MAX>
__global__ void __launch_bounds__(THREADS, 2)
    flash_fwd_f32_sm90_kernel(const Params p) {
  using T = Tile<D>;
  constexpr int LDK = T::LDK, LDV = T::LDV, LDQ = T::LDQ, STAGE = T::STAGE;
  constexpr int KS = T::KS, DB = T::DB;
  extern __shared__ __align__(16) float smem[];
  const int4 unit = p.units[blockIdx.x];
  const int m0 = unit.x * BLOCK_M;
  const int t0 = unit.y;
  const int nt = unit.z - unit.y;
  const int slot = unit.w;  // -1: the query tile is not split
  const int bh = blockIdx.y;
  const int b = bh / p.H;
  const int h = bh - b * p.H;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int tig = lane & 3;
  const int row0 = m0 + warp * 16 + g;  // this thread's rows: row0, row0 + 8
  const float* kb = p.k + b * p.k_sb + h * p.k_sh;
  const float* vb = p.v + b * p.v_sb + h * p.v_sh;

  // K and V of key tile t into stage s; keys past Sk are zeros.  A thread
  // copies 16-byte chunks of K rows and of V row pairs (2j, 2j + 1), which
  // it then splits itself (`split_tile`)
  auto load = [&](int t, int s) {
    float* sk = smem + s * STAGE;
    float* sv = sk + BLOCK_N * LDK;
    const int n0 = t * BLOCK_N;
    #pragma unroll
    for (int i = 0; i < T::K_CHUNKS; ++i) {
      const int c = threadIdx.x + i * THREADS;
      const int r = c / (D / 4);
      const int col = (c - r * (D / 4)) * 4;
      const bool ok = n0 + r < p.Sk;
      const long long key = ok ? n0 + r : 0;
      cp_async16(sk + r * LDK + col, kb + key * p.k_ss + col, ok ? 16 : 0);
    }
    #pragma unroll
    for (int i = 0; i < T::V_CHUNKS; ++i) {
      const int c = threadIdx.x + i * THREADS;
      if (T::V_PAIRS % THREADS != 0 && c >= T::V_PAIRS) break;
      const int r = 2 * (c / (D / 4));
      const int col = (c - (r / 2) * (D / 4)) * 4;
      #pragma unroll
      for (int x = 0; x < 2; ++x) {
        const bool ok = n0 + r + x < p.Sk;
        const long long key = ok ? n0 + r + x : 0;
        cp_async16(sv + (r + x) * LDV + col, vb + key * p.v_ss + col,
                   ok ? 16 : 0);
      }
    }
  };
  // The f32 tiles of stage s, each chunk the thread copied, split in place
  // into bf16 hi and lo: a K chunk (row r, columns c..c+3) becomes the
  // words hi(c, c+1), lo(c, c+1), hi(c+2, c+3), lo(c+2, c+3), so that a B
  // fragment's pair of depths and its lo lie in one 8-byte load; a V chunk
  // pair (rows 2j, 2j+1) becomes, in row 2j, the hi of (V[2j][c+i],
  // V[2j+1][c+i]) for i = 0..3 and in row 2j+1 their lo: a B fragment's
  // pair of keys is one word
  auto split_tile = [&](int s) {
    float* sk = smem + s * STAGE;
    float* sv = sk + BLOCK_N * LDK;
    #pragma unroll
    for (int i = 0; i < T::K_CHUNKS; ++i) {
      const int c = threadIdx.x + i * THREADS;
      const int r = c / (D / 4);
      float* at = sk + r * LDK + (c - r * (D / 4)) * 4;
      const float4 x = *reinterpret_cast<const float4*>(at);
      uint4 w;
      split_pack(x.x, x.y, w.x, w.y);
      split_pack(x.z, x.w, w.z, w.w);
      *reinterpret_cast<uint4*>(at) = w;
    }
    #pragma unroll
    for (int i = 0; i < T::V_CHUNKS; ++i) {
      const int c = threadIdx.x + i * THREADS;
      if (T::V_PAIRS % THREADS != 0 && c >= T::V_PAIRS) break;
      const int r = 2 * (c / (D / 4));
      float* at = sv + r * LDV + (c - (r / 2) * (D / 4)) * 4;
      const float4 x0 = *reinterpret_cast<const float4*>(at);
      const float4 x1 = *reinterpret_cast<const float4*>(at + LDV);
      uint4 hi, lo;
      split_pack(x0.x, x1.x, hi.x, lo.x);
      split_pack(x0.y, x1.y, hi.y, lo.y);
      split_pack(x0.z, x1.z, hi.z, lo.z);
      split_pack(x0.w, x1.w, hi.w, lo.w);
      *reinterpret_cast<uint4*>(at) = hi;
      *reinterpret_cast<uint4*>(at + LDV) = lo;
    }
  };
  // The Q tile into stage 1 and K, V tile t0 into stage 0; rows past Sq
  // are zeros.  Read from global memory straight into the A fragments, Q
  // cost 32 scattered 8-byte loads a thread (a fifth of the call at
  // LLaMA's shape on an H100); copied whole, it lands with tile t0
  {
    float* sq = smem + STAGE;
    const float* qb = p.q + b * p.q_sb + h * p.q_sh;
    #pragma unroll
    for (int i = 0; i < T::Q_CHUNKS; ++i) {
      const int c = threadIdx.x + i * THREADS;
      const int r = c / (D / 4);
      const int col = (c - r * (D / 4)) * 4;
      const bool ok = m0 + r < p.Sq;
      const long long row = ok ? m0 + r : 0;
      cp_async16(sq + r * LDQ + col, qb + row * p.q_ss + col, ok ? 16 : 0);
    }
  }
  cp_async_commit();
  load(t0, 0);
  cp_async_commit();

  // Q of rows row0 and row0 + 8 as A fragments, hi and lo; then stage 1
  // takes tile t0 + 1
  uint32_t qh[KS][4], ql[KS][4];
  cp_async_wait<1>();
  __syncthreads();
  {
    const float* sq = smem + STAGE + (warp * 16 + g) * LDQ + tig * 2;
    #pragma unroll
    for (int ks = 0; ks < KS; ++ks)
      #pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 x = *reinterpret_cast<const float2*>(
            sq + (j & 1) * 8 * LDQ + ks * 16 + (j >> 1) * 8);
        split_pack(x.x, x.y, qh[ks][j], ql[ks][j]);
      }
  }
  __syncthreads();
  if (nt > 1) load(t0 + 1, 1);
  cp_async_commit();

  float acc[DB][4];
  #pragma unroll
  for (int i = 0; i < DB; ++i)
    #pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  float row_m[2] = {-INFINITY, -INFINITY};
  float row_l[2] = {0.f, 0.f};

  for (int i = 0; i < nt; ++i) {
    cp_async_wait<1>();  // tile i has landed; tile i + 1 may be in flight
    split_tile(i & 1);
    __syncthreads();
    const float* sk = smem + (i & 1) * STAGE;
    const uint32_t* sv =
        reinterpret_cast<const uint32_t*>(sk + BLOCK_N * LDK);
    const int n0 = (t0 + i) * BLOCK_N;

    // S = Q K^T, three bf16 products a product
    float s[NB][4];
    #pragma unroll
    for (int nb = 0; nb < NB; ++nb)
      #pragma unroll
      for (int j = 0; j < 4; ++j) s[nb][j] = 0.f;
    #pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      #pragma unroll
      for (int nb = 0; nb < NB; ++nb) {
        // (hi, lo) of depths 2 tig, 2 tig + 1 and of 8 further
        const float* kr = sk + (nb * 8 + g) * LDK + ks * 16 + tig * 2;
        const uint2 b0 = *reinterpret_cast<const uint2*>(kr);
        const uint2 b1 = *reinterpret_cast<const uint2*>(kr + 8);
        mma_bf16(s[nb], qh[ks], b0.x, b1.x);
        mma_bf16(s[nb], qh[ks], b0.y, b1.y);
        mma_bf16(s[nb], ql[ks], b0.x, b1.x);
      }
    }

    // scale; -inf past Sk and above the causal diagonal
    const bool edge = n0 + BLOCK_N > p.Sk ||
                      (p.causal && n0 + BLOCK_N - 1 > m0 + warp * 16);
    #pragma unroll
    for (int nb = 0; nb < NB; ++nb)
      #pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = n0 + nb * 8 + tig * 2 + (j & 1);
        const int row = row0 + (j >> 1) * 8;
        const bool ok =
            !edge || (key < p.Sk && (!p.causal || key <= row));
        s[nb][j] = ok ? s[nb][j] * p.scale_log2 : -INFINITY;
      }

    float m_use[2];
    if (STATIC_MAX) {
      m_use[0] = m_use[1] = p.static_max;
    } else {
      #pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mx = row_m[r];
        #pragma unroll
        for (int nb = 0; nb < NB; ++nb)
          mx = fmaxf(mx, fmaxf(s[nb][2 * r], s[nb][2 * r + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffff, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffff, mx, 2));
        // a row with no valid key so far takes its exponents against 0
        const float mu = mx == -INFINITY ? 0.f : mx;
        const float alpha = fast_exp2(row_m[r] - mu);
        row_l[r] *= alpha;
        #pragma unroll
        for (int db = 0; db < DB; ++db) {
          acc[db][2 * r] *= alpha;
          acc[db][2 * r + 1] *= alpha;
        }
        row_m[r] = mx;
        m_use[r] = mu;
      }
    }
    #pragma unroll
    for (int r = 0; r < 2; ++r) {
      float sum = 0.f;
      #pragma unroll
      for (int nb = 0; nb < NB; ++nb) {
        const float e0 = fast_exp2(s[nb][2 * r] - m_use[r]);
        const float e1 = fast_exp2(s[nb][2 * r + 1] - m_use[r]);
        s[nb][2 * r] = e0;
        s[nb][2 * r + 1] = e1;
        sum += e0 + e1;
      }
      row_l[r] += sum;
    }

    // O += P V: P from the S accumulator, split here
    uint32_t ph[KK][4], pl[KK][4];
    #pragma unroll
    for (int kk = 0; kk < KK; ++kk) {
      split_pack(s[2 * kk][0], s[2 * kk][1], ph[kk][0], pl[kk][0]);
      split_pack(s[2 * kk][2], s[2 * kk][3], ph[kk][1], pl[kk][1]);
      split_pack(s[2 * kk + 1][0], s[2 * kk + 1][1], ph[kk][2], pl[kk][2]);
      split_pack(s[2 * kk + 1][2], s[2 * kk + 1][3], ph[kk][3], pl[kk][3]);
    }
    #pragma unroll
    for (int kk = 0; kk < KK; ++kk) {
      #pragma unroll
      for (int db = 0; db < DB; ++db) {
        // hi and lo of keys 2 tig, 2 tig + 1 and of 8 further, column n
        const uint32_t* vr = sv + (kk * 16 + tig * 2) * LDV + db * 8 + g;
        const uint32_t bh0 = vr[0], bl0 = vr[LDV];
        const uint32_t bh1 = vr[8 * LDV], bl1 = vr[9 * LDV];
        mma_bf16(acc[db], ph[kk], bh0, bh1);
        mma_bf16(acc[db], ph[kk], bl0, bl1);
        mma_bf16(acc[db], pl[kk], bh0, bh1);
      }
    }
    __syncthreads();  // every warp is done with stage i & 1
    if (i + 2 < nt) load(t0 + i + 2, i & 1);
    cp_async_commit();
  }

  #pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = row_l[r];
    l += __shfl_xor_sync(0xffffffff, l, 1);
    l += __shfl_xor_sync(0xffffffff, l, 2);
    const int row = row0 + r * 8;
    if (row >= p.Sq) continue;
    const float m = STATIC_MAX ? p.static_max : row_m[r];
    if (slot < 0) {
      const float inv = l > 0.f ? 1.f / l : 0.f;
      float* orow = p.o + b * p.o_sb + h * p.o_sh + row * p.o_ss;
      #pragma unroll
      for (int db = 0; db < DB; ++db)
        *reinterpret_cast<float2*>(orow + db * 8 + tig * 2) =
            make_float2(acc[db][2 * r] * inv, acc[db][2 * r + 1] * inv);
      if (p.lse != nullptr && tig == 0)
        p.lse[static_cast<long long>(bh) * p.Sq + row] =
            l > 0.f ? (m + log2f(l)) * 0.69314718055994531f : -INFINITY;
    } else {
      const long long pr =
          (static_cast<long long>(bh) * p.slots + slot) * BLOCK_M + row - m0;
      float* po = p.part_o + pr * D;
      #pragma unroll
      for (int db = 0; db < DB; ++db)
        *reinterpret_cast<float2*>(po + db * 8 + tig * 2) =
            make_float2(acc[db][2 * r], acc[db][2 * r + 1]);
      if (tig == 0) {
        p.part_ml[2 * pr] = m;
        p.part_ml[2 * pr + 1] = l;
      }
    }
  }
}

template <int D, bool STATIC_MAX>
int launch(const Params& p, int n_units, int BH, cudaStream_t stream) {
  constexpr int SMEM = Tile<D>::SMEM;
  auto kernel = flash_fwd_f32_sm90_kernel<D, STATIC_MAX>;
  // per device, at the first launch there: the shared-memory limit, and
  // the carve-out that lets three blocks share an SM
  static bool ready[64] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess && dev >= 64) e = cudaErrorInvalidDevice;
  if (e == cudaSuccess && !ready[dev]) {
    e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    ready[dev] = e == cudaSuccess;
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<dim3(n_units, BH), THREADS, SMEM, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// f32 q, k, v (B, S, H, d), d = 64, 80 or 128, rows 16-byte aligned → f32
// o (and the LSE when `lse` is not null).  `units` holds `n_units` int4
// (query tile, first key tile, end key tile, partial slot or -1) of 64
// query rows and 32-key tiles, run for every head; `combine` holds
// `n_combine` int4 (query tile, first slot, ranges, -) of the split query
// tiles, whose `slots` partial slots a head live in `part`,
// B*H*slots*64*(d + 2) f32.  Returns the CUDA
// error of the launches (0 on success); cudaErrorInvalidValue for what
// the kernel does not take.
extern "C" int flash_fwd_f32_sm90(
    const void* q, const void* k, const void* v, void* o, void* lse,
    void* part, const void* units, int n_units, const void* combine,
    int n_combine, int slots, int B, int H, int Sq, int Sk, int d,
    long long q_sb, long long q_ss, long long q_sh, long long k_sb,
    long long k_ss, long long k_sh, long long v_sb, long long v_ss,
    long long v_sh, long long o_sb, long long o_ss, long long o_sh,
    float scale_log2, int causal, int online, float static_max,
    void* stream) {
  if ((d != 64 && d != 80 && d != 128) || B <= 0 || H <= 0 || Sq <= 0 || Sk <= 0 || n_units <= 0 ||
      static_cast<long long>(B) * H > 65535 || units == nullptr ||
      (n_combine > 0) != (part && slots > 0 && combine))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int BH = B * H;
  Params p;
  p.q = static_cast<const float*>(q);
  p.k = static_cast<const float*>(k);
  p.v = static_cast<const float*>(v);
  p.o = static_cast<float*>(o);
  p.lse = static_cast<float*>(lse);
  p.part_o = static_cast<float*>(part);
  p.part_ml = part ? p.part_o + static_cast<long long>(BH) * slots *
                                    BLOCK_M * d
                   : nullptr;
  p.units = static_cast<const int4*>(units);
  p.H = H;
  p.Sq = Sq;
  p.Sk = Sk;
  p.slots = slots;
  p.q_sb = q_sb;
  p.q_ss = q_ss;
  p.q_sh = q_sh;
  p.k_sb = k_sb;
  p.k_ss = k_ss;
  p.k_sh = k_sh;
  p.v_sb = v_sb;
  p.v_ss = v_ss;
  p.v_sh = v_sh;
  p.o_sb = o_sb;
  p.o_ss = o_ss;
  p.o_sh = o_sh;
  p.scale_log2 = scale_log2;
  p.static_max = static_max;
  p.causal = causal;
  int err;
  if (d == 64)
    err = online ? launch<64, false>(p, n_units, BH, s)
                 : launch<64, true>(p, n_units, BH, s);
  else if (d == 80)
    err = online ? launch<80, false>(p, n_units, BH, s)
                 : launch<80, true>(p, n_units, BH, s);
  else
    err = online ? launch<128, false>(p, n_units, BH, s)
                 : launch<128, true>(p, n_units, BH, s);
  if (err != 0 || n_combine == 0) return err;
  split::CombineParams cp;
  cp.part_o = p.part_o;
  cp.part_ml = p.part_ml;
  cp.table = static_cast<const int4*>(combine);
  cp.splits = 0;
  cp.slots = slots;
  cp.block_m = BLOCK_M;
  cp.pitch = d;
  cp.d = d;
  cp.H = H;
  cp.Sq = Sq;
  cp.o_sb = o_sb;
  cp.o_ss = o_ss;
  cp.o_sh = o_sh;
  cp.lse = p.lse;
  cp.online = online;
  return split::combine(cp, p.o, n_combine, BH, s);
}
