// Flash-attention backward, bf16, on Hopper (sm_90a): dq, dk and dv from
// q, k, v, the forward's output o, its gradient dO and the natural-log LSE,
// for head widths up to 256, with the forward's options: causal (top-left)
// and a per-key validity mask.
//
// Replaces the TPU backward kernel of the JAX package (videotuna_tpu/
// kernels/attention.py)
//   K8  `_flash_bwd_fused_kernel` in `flash_attention_bwd` (:1148, :1725),
//       the single-pass generic backward, also behind `_fa_masked_bwd`
//       (:2065), the kv_valid backward;
// and, by mapping, the two-kernel `single_pass=False` baseline
//   K9  `_flash_bwd_dkv_kernel` + `_flash_bwd_dq_kernel` (:1107, :1197).
// The d=64 backward K7 (`_flash_bwd_packed2_fused_kernel`, :1424) and its
// baseline K10 (:1260, :1343) run flash_bwd_sm90.cu.  All of them compute
// one function; this source computes it once.
//
// Function.  With s = (q.k) * sm_scale, masked to -inf above the causal
// diagonal, past Sk and where kv_valid[b, key] == 0:
//   p  = exp(s - lse)                 (lse clamped at -1e5, as the JAX
//                                      kernels do, so a row with no valid
//                                      key, lse = -inf, gives p = 0)
//   delta_i = sum_d dO[i,d] o[i,d]
//   dv = p^T dO
//   ds = p * (dO v^T - delta)
//   dq = sm_scale * ds k,   dk = sm_scale * ds^T q
// A masked key has p = 0 in every row, so its dk and dv are exactly 0, and
// a query row with no valid key gets dq = 0.  The forward (flash_fwd.cu,
// flash_fwd_sm90.cu) masks with -inf and does not zero the masked k and v,
// so this is the gradient of the function it computed; a fixed-max forward
// emits the true LSE, so its backward is the same.
//
// Reduction of dq, and why two kernels.  dk and dv are sums over query
// rows, dq a sum over keys.  The TPU runs its grid in order and carries the
// sums in scratch (`_FUSED_BWD_PARTIAL_CAP`, :1421, bounds the per-key-tile
// dq partials that XLA then adds).  Blocks on the H100 run in no order, so
// one of the two sums needs either atomics or a second pass.  Here:
//   1. `delta_kernel`, a pre-pass: delta for every query row (reads o, dO);
//   2. `dkv_kernel`: one block per (b*h, 64-key tile) keeps dk and dv in
//      registers over a loop across the query tiles;
//   3. `dq_kernel`: one block per (b*h, 64-query tile) keeps dq in
//      registers over a loop across the key tiles, recomputing s and p.
// The second pass costs two extra products (7 instead of 5 per tile
// pair), but the sums are deterministic, no f32 scratch of (B, H, Sq, d) is
// needed (136 MB at the CogVideoX-2B shape), and both loops are the
// forward's own loop with the roles of the operands changed, so every
// fragment layout below is the forward's, already checked on the card.
//
// What bounds it.  The five products of the function are 10*S^2*d*B*H
// FLOP.  CogVideoX-2B training (B=1, S=17,776, H=30, d=64): 6.07e12 FLOP,
// 6.13 ms at 989 TF/s, while q, k, v, o, dO, dq, dk, dv move 0.55 GB,
// 0.16 ms at 3.35 TB/s: bound by operations, so every product runs on the
// tensor cores (mma.sync m16n8k16 bf16 -> f32) and s, p, dp, ds never leave
// registers.  Open-Sora STDiT-XL/2 (d=72 -> 80): spatial (B=16, S=256,
// H=16) moves 8 x 9.44 MB = 75.5 MB, 22.5 us, cross (B=1, 4096 queries x
// 120 keys) about 38 MB, 11.3 us: bound by bytes, so each tensor crosses
// device memory once per kernel (q, k, v, dO twice in all), tiles are staged
// with cp.async into two shared-memory buffers so that the next tile's load
// overlaps this tile's products, and no padded copy is ever written.
// In bf16 the d=64 routes K7 and K10 have their own single-pass wgmma
// kernel (flash_bwd_sm90.cu), and K8 and K9 at d = 72 and 80, non-causal,
// theirs (flash_bwd_rows_sm90.cu); this source serves K8 and K9 at every
// other width and causal, and is the A/B baseline of both.
//
// Layout.  Both kernels: 4 warps, each owning 16 rows of the block's
// 64-row tile (keys in dkv_kernel, queries in dq_kernel); the loop runs over
// tiles of 64 rows at D <= 80 and 32 rows at D >= 128, so that two 16 x D f32
// accumulators and the score tiles fit in registers.  D is the padded width
// (32, 64, 80, 128 or 256; d = 72 -> 80, d = 160 -> 256), zero-filled in
// shared memory only.  At D = 256 two 16 x 256 accumulators would not fit:
// each gradient's columns are split between two blocks (blockIdx.z), each
// owning 128 of them and recomputing s and dp from the full-width tiles in
// shared memory (135.7 KB of it).
// Shared-memory rows are padded by 8 elements so ldmatrix hits distinct
// banks.  p and ds are rounded to bf16 as A operands of the products, as the
// forward rounds p; delta, lse and every accumulator are f32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float LOG2E = 1.4426950408889634f;

struct Params {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  const __nv_bfloat16* o;
  const __nv_bfloat16* dout;
  const float* lse;         // (B, H, Sq), natural log
  float* delta;             // (B, H, Sq), written by delta_kernel
  __nv_bfloat16* dq;
  __nv_bfloat16* dk;
  __nv_bfloat16* dv;
  const uint8_t* kv_valid;  // (B, Sk), 0 = masked key, or nullptr
  int B, H, Sq, Sk, d;
  long long q_sb, q_ss, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long o_sb, o_ss, o_sh;
  long long do_sb, do_ss, do_sh;
  long long dq_sb, dq_ss, dq_sh;
  long long dk_sb, dk_ss, dk_sh;
  long long dv_sb, dv_ss, dv_sh;
  float sm_scale;
  float scale_log2;  // sm_scale * log2(e)
  int causal;
};

template <int D>
struct Cfg {
  static constexpr int BLOCK_M = 64;                 // rows a block owns
  static constexpr int BLOCK_N = D <= 80 ? 64 : 32;  // rows of a loop tile
  static constexpr int THREADS = BLOCK_M / 16 * 32;
  static constexpr int LDS = D + 8;  // padded shared-memory row, in elements
  static constexpr bool ROW_IN_REGS = D <= 64;  // owned operands in registers
  // columns of the gradient a block owns: all of them up to 128; at D = 256
  // two blocks split them (blockIdx.z), each recomputing s and dp
  static constexpr int DC = D <= 128 ? D : 128;
  // two owned tiles, two stages of two loop tiles, two stages of row stats
  static constexpr int SMEM = (2 * BLOCK_M + 4 * BLOCK_N) * LDS * 2 +
                              4 * BLOCK_N * 4;
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
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r,
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
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

// exp2; -inf gives +0
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Stage ROWS rows of the first d elements (row i at src + i*stride) into the
// smem tile `dst` (row pitch D + 8).  Rows at or past `valid` and columns at
// or past d are zero-filled.
template <int ROWS, int D, int THREADS>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src,
                                          long long stride, int valid, int d) {
  constexpr int CH = D / 8;  // 16-byte chunks per padded row
  constexpr int LDS = D + 8;
  for (int c = threadIdx.x; c < ROWS * CH; c += THREADS) {
    const int r = c / CH;
    const int col = (c - r * CH) * 8;
    const bool ok = r < valid && col < d;
    const __nv_bfloat16* g = ok ? src + r * stride + col : src;
    cp_async16(dst + r * LDS + col, g, ok ? 16 : 0);
  }
}

// The score-shaped product of one warp: c (16 x N) += A (16 x D, fragments
// of the warp's rows at a_smem + a_off, or `areg` when held in registers)
// times B^T, B (N x D) rows in smem `b` — the forward's S = Q K^T.
template <int D, int N, bool A_IN_REGS>
__device__ __forceinline__ void mma_abt(float (*c)[4],
                                        const uint32_t (*areg)[4],
                                        const __nv_bfloat16* a_smem,
                                        int a_off,
                                        const __nv_bfloat16* b, int lane) {
  constexpr int LDS = D + 8;
  #pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {
    uint32_t a[4];
    if constexpr (A_IN_REGS) {
      #pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = areg[ks][i];
    } else {
      ldmatrix_x4(a, a_smem + a_off + ks * 16);
    }
    #pragma unroll
    for (int nb = 0; nb < N / 8; nb += 2) {
      uint32_t bf[4];
      const int row = nb * 8 + (lane & 7) + ((lane >> 4) << 3);
      const int col = ks * 16 + ((lane >> 3) & 1) * 8;
      ldmatrix_x4(bf, b + row * LDS + col);
      mma_bf16(c[nb], a, bf[0], bf[1]);
      mma_bf16(c[nb + 1], a, bf[2], bf[3]);
    }
  }
}

// The PV-shaped product of one warp: acc (16 x DC) += P (16 x N, C-fragment
// layout in `p`, rounded to bf16 here) times columns c0 .. c0 + DC of B
// (N x D) rows in smem `b` — the forward's O = P V.
template <int D, int DC, int N>
__device__ __forceinline__ void mma_pb(float (*acc)[4], const float (*p)[4],
                                       const __nv_bfloat16* b, int c0,
                                       int lane) {
  constexpr int LDS = D + 8;
  #pragma unroll
  for (int kk = 0; kk < N / 16; ++kk) {
    uint32_t pf[4];
    pf[0] = pack_bf16(p[2 * kk][0], p[2 * kk][1]);
    pf[1] = pack_bf16(p[2 * kk][2], p[2 * kk][3]);
    pf[2] = pack_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1]);
    pf[3] = pack_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3]);
    #pragma unroll
    for (int db = 0; db < DC / 8; db += 2) {
      uint32_t bf[4];
      const int row = kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
      const int col = c0 + db * 8 + (lane >> 4) * 8;
      ldmatrix_x4_trans(bf, b + row * LDS + col);
      mma_bf16(acc[db], pf, bf[0], bf[1]);
      mma_bf16(acc[db + 1], pf, bf[2], bf[3]);
    }
  }
}

// Store a warp's 16 x DC accumulator, times `scale`, to columns c0 .. c0 +
// DC of rows row0 and row0 + 8 (rows at or past `n` and columns at or past
// d are dropped).
template <int DC>
__device__ __forceinline__ void store_rows(__nv_bfloat16* base,
                                           long long row_stride,
                                           const float (*acc)[4], int row0,
                                           int n, int d, int c0, int tig,
                                           float scale) {
  #pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + r * 8;
    if (row >= n) continue;
    __nv_bfloat16* out = base + row * row_stride;
    #pragma unroll
    for (int db = 0; db < DC / 8; ++db) {
      const int col = c0 + db * 8 + tig * 2;
      if (col < d) {
        *reinterpret_cast<__nv_bfloat162*>(out + col) =
            __floats2bfloat162_rn(acc[db][2 * r] * scale,
                                  acc[db][2 * r + 1] * scale);
      }
    }
  }
}

// delta[b,h,i] = sum_d dO[b,i,h,d] * o[b,i,h,d], one warp per row.
__global__ void delta_kernel(const Params p) {
  const long long row = (long long)blockIdx.x * (blockDim.x / 32) +
                        (threadIdx.x >> 5);
  if (row >= (long long)p.B * p.H * p.Sq) return;
  const int lane = threadIdx.x & 31;
  const int i = static_cast<int>(row % p.Sq);
  const int bh = static_cast<int>(row / p.Sq);
  const int b = bh / p.H;
  const int h = bh - b * p.H;
  const __nv_bfloat16* orow = p.o + b * p.o_sb + h * p.o_sh + i * p.o_ss;
  const __nv_bfloat16* grow =
      p.dout + b * p.do_sb + h * p.do_sh + i * p.do_ss;
  float acc = 0.f;
  for (int c = lane * 8; c < p.d; c += 256) {
    const uint4 ov = *reinterpret_cast<const uint4*>(orow + c);
    const uint4 gv = *reinterpret_cast<const uint4*>(grow + c);
    const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(&ov);
    const __nv_bfloat162* g2 = reinterpret_cast<const __nv_bfloat162*>(&gv);
    #pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 of = __bfloat1622float2(o2[j]);
      const float2 gf = __bfloat1622float2(g2[j]);
      acc += of.x * gf.x + of.y * gf.y;
    }
  }
  #pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffff, acc, off);
  if (lane == 0) p.delta[row] = acc;
}

// dk, dv for one (b*h, 64-key tile): loop over the query tiles.
template <int D>
__global__ void __launch_bounds__(Cfg<D>::THREADS) dkv_kernel(const Params p) {
  using C = Cfg<D>;
  constexpr int BM = C::BLOCK_M;
  constexpr int BN = C::BLOCK_N;
  constexpr int THREADS = C::THREADS;
  constexpr int LDS = C::LDS;
  constexpr int KS = D / 16;
  constexpr int NB = BN / 8;
  constexpr int DC = C::DC;
  constexpr int DB = DC / 8;

  extern __shared__ __align__(128) unsigned char smem_raw[];
  __nv_bfloat16* sK = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sV = sK + BM * LDS;
  __nv_bfloat16* sQ = sV + BM * LDS;     // 2 stages
  __nv_bfloat16* sdO = sQ + 2 * BN * LDS;  // 2 stages
  float* sLse = reinterpret_cast<float*>(sdO + 2 * BN * LDS);  // 2 stages
  float* sDelta = sLse + 2 * BN;                               // 2 stages

  const int bh = blockIdx.x;
  const int b = bh / p.H;
  const int h = bh - b * p.H;
  const int n0 = blockIdx.y * BM;
  const int c0 = blockIdx.z * DC;  // the columns of dk, dv this block owns
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int tig = lane & 3;
  const int key0 = n0 + warp * 16 + g;  // key of c[0..1]; +8: c[2..3]

  const __nv_bfloat16* qb = p.q + b * p.q_sb + h * p.q_sh;
  const __nv_bfloat16* kb = p.k + b * p.k_sb + h * p.k_sh + n0 * p.k_ss;
  const __nv_bfloat16* vb = p.v + b * p.v_sb + h * p.v_sh + n0 * p.v_ss;
  const __nv_bfloat16* dob = p.dout + b * p.do_sb + h * p.do_sh;
  const float* lse_b = p.lse + (long long)bh * p.Sq;
  const float* delta_b = p.delta + (long long)bh * p.Sq;

  // a masked key (or one past Sk) has p = 0 in every row
  bool key_ok[2];
  #pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = key0 + r * 8;
    key_ok[r] = key < p.Sk &&
                (p.kv_valid == nullptr || p.kv_valid[(long long)b * p.Sk + key]);
  }

  const int n_tiles = (p.Sq + BN - 1) / BN;
  // causal: query rows before the tile's first key see none of its keys
  const int t_begin = p.causal ? n0 / BN : 0;

  auto load_stage = [&](int t, int s) {
    const int m0 = t * BN;
    load_tile<BN, D, THREADS>(sQ + s * BN * LDS, qb + m0 * p.q_ss, p.q_ss,
                              p.Sq - m0, p.d);
    load_tile<BN, D, THREADS>(sdO + s * BN * LDS, dob + m0 * p.do_ss,
                              p.do_ss, p.Sq - m0, p.d);
    for (int r = threadIdx.x; r < BN; r += THREADS) {
      const int row = m0 + r;
      // rows past Sq: lse = +inf makes p = 0
      sLse[s * BN + r] =
          row < p.Sq ? fmaxf(lse_b[row], -1e5f) * LOG2E : INFINITY;
      sDelta[s * BN + r] = row < p.Sq ? delta_b[row] : 0.f;
    }
  };

  load_tile<BM, D, THREADS>(sK, kb, p.k_ss, p.Sk - n0, p.d);
  load_tile<BM, D, THREADS>(sV, vb, p.v_ss, p.Sk - n0, p.d);
  if (t_begin < n_tiles) load_stage(t_begin, 0);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();

  const int a_off = (warp * 16 + (lane & 15)) * LDS + (lane >> 4) * 8;
  uint32_t kf[C::ROW_IN_REGS ? KS : 1][4];
  uint32_t vf[C::ROW_IN_REGS ? KS : 1][4];
  if constexpr (C::ROW_IN_REGS) {
    #pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      ldmatrix_x4(kf[ks], sK + a_off + ks * 16);
      ldmatrix_x4(vf[ks], sV + a_off + ks * 16);
    }
  }

  float dk[DB][4];
  float dv[DB][4];
  #pragma unroll
  for (int i = 0; i < DB; ++i)
    #pragma unroll
    for (int j = 0; j < 4; ++j) dk[i][j] = dv[i][j] = 0.f;

  for (int t = t_begin; t < n_tiles; ++t) {
    const int s = (t - t_begin) & 1;
    if (t + 1 < n_tiles) load_stage(t + 1, s ^ 1);
    cp_async_commit();

    const __nv_bfloat16* q_s = sQ + s * BN * LDS;
    const __nv_bfloat16* do_s = sdO + s * BN * LDS;
    const float* lse_s = sLse + s * BN;
    const float* dl_s = sDelta + s * BN;
    const int m0 = t * BN;

    // S^T = K Q^T: 16 keys x BN queries per warp
    float st[NB][4];
    #pragma unroll
    for (int i = 0; i < NB; ++i)
      #pragma unroll
      for (int j = 0; j < 4; ++j) st[i][j] = 0.f;
    mma_abt<D, BN, C::ROW_IN_REGS>(st, kf, sK, a_off, q_s, lane);

    // P^T = exp2(s * sm_scale * log2e - lse * log2e); masked entries 0
    #pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
      #pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = nb * 8 + tig * 2 + (j & 1);
        bool ok = key_ok[j >> 1];
        if (p.causal) ok = ok && key0 + (j >> 1) * 8 <= m0 + c;
        st[nb][j] = ok ? fast_exp2(st[nb][j] * p.scale_log2 - lse_s[c]) : 0.f;
      }
    }

    // dV += P^T dO
    mma_pb<D, DC, BN>(dv, st, do_s, c0, lane);

    // dP^T = V dO^T
    float dpt[NB][4];
    #pragma unroll
    for (int i = 0; i < NB; ++i)
      #pragma unroll
      for (int j = 0; j < 4; ++j) dpt[i][j] = 0.f;
    mma_abt<D, BN, C::ROW_IN_REGS>(dpt, vf, sV, a_off, do_s, lane);

    // dS^T = P^T (dP^T - delta)
    #pragma unroll
    for (int nb = 0; nb < NB; ++nb)
      #pragma unroll
      for (int j = 0; j < 4; ++j)
        dpt[nb][j] = st[nb][j] * (dpt[nb][j] - dl_s[nb * 8 + tig * 2 + (j & 1)]);

    // dK += dS^T Q
    mma_pb<D, DC, BN>(dk, dpt, q_s, c0, lane);

    cp_async_wait_all();
    __syncthreads();  // the next stage landed; every warp is done with this
  }

  const int rows = p.Sk;
  store_rows<DC>(p.dk + b * p.dk_sb + h * p.dk_sh, p.dk_ss, dk, key0, rows,
                 p.d, c0, tig, p.sm_scale);
  store_rows<DC>(p.dv + b * p.dv_sb + h * p.dv_sh, p.dv_ss, dv, key0, rows,
                 p.d, c0, tig, 1.f);
}

// dq for one (b*h, 64-query tile): loop over the key tiles.
template <int D>
__global__ void __launch_bounds__(Cfg<D>::THREADS) dq_kernel(const Params p) {
  using C = Cfg<D>;
  constexpr int BM = C::BLOCK_M;
  constexpr int BN = C::BLOCK_N;
  constexpr int THREADS = C::THREADS;
  constexpr int LDS = C::LDS;
  constexpr int KS = D / 16;
  constexpr int NB = BN / 8;
  constexpr int DC = C::DC;
  constexpr int DB = DC / 8;

  extern __shared__ __align__(128) unsigned char smem_raw[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sdO = sQ + BM * LDS;
  __nv_bfloat16* sK = sdO + BM * LDS;     // 2 stages
  __nv_bfloat16* sV = sK + 2 * BN * LDS;  // 2 stages

  const int bh = blockIdx.x;
  const int b = bh / p.H;
  const int h = bh - b * p.H;
  const int m0 = blockIdx.y * BM;
  const int c0 = blockIdx.z * DC;  // the columns of dq this block owns
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int tig = lane & 3;
  const int row0 = m0 + warp * 16 + g;  // query of c[0..1]; +8: c[2..3]

  const __nv_bfloat16* qb = p.q + b * p.q_sb + h * p.q_sh + m0 * p.q_ss;
  const __nv_bfloat16* dob =
      p.dout + b * p.do_sb + h * p.do_sh + m0 * p.do_ss;
  const __nv_bfloat16* kb = p.k + b * p.k_sb + h * p.k_sh;
  const __nv_bfloat16* vb = p.v + b * p.v_sb + h * p.v_sh;
  const uint8_t* valid =
      p.kv_valid != nullptr ? p.kv_valid + (long long)b * p.Sk : nullptr;

  float lse2[2], dl[2];
  #pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + r * 8;
    const long long at = (long long)bh * p.Sq + row;
    lse2[r] = row < p.Sq ? fmaxf(p.lse[at], -1e5f) * LOG2E : INFINITY;
    dl[r] = row < p.Sq ? p.delta[at] : 0.f;
  }

  int n_tiles = (p.Sk + BN - 1) / BN;
  if (p.causal) {  // keys past the block's last row are all masked
    const int last_row = min(m0 + BM, p.Sq) - 1;
    n_tiles = min(n_tiles, last_row / BN + 1);
  }

  auto load_stage = [&](int t, int s) {
    const int k0 = t * BN;
    load_tile<BN, D, THREADS>(sK + s * BN * LDS, kb + k0 * p.k_ss, p.k_ss,
                              p.Sk - k0, p.d);
    load_tile<BN, D, THREADS>(sV + s * BN * LDS, vb + k0 * p.v_ss, p.v_ss,
                              p.Sk - k0, p.d);
  };

  load_tile<BM, D, THREADS>(sQ, qb, p.q_ss, p.Sq - m0, p.d);
  load_tile<BM, D, THREADS>(sdO, dob, p.do_ss, p.Sq - m0, p.d);
  load_stage(0, 0);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();

  const int a_off = (warp * 16 + (lane & 15)) * LDS + (lane >> 4) * 8;
  uint32_t qf[C::ROW_IN_REGS ? KS : 1][4];
  uint32_t dof[C::ROW_IN_REGS ? KS : 1][4];
  if constexpr (C::ROW_IN_REGS) {
    #pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      ldmatrix_x4(qf[ks], sQ + a_off + ks * 16);
      ldmatrix_x4(dof[ks], sdO + a_off + ks * 16);
    }
  }

  float dq[DB][4];
  #pragma unroll
  for (int i = 0; i < DB; ++i)
    #pragma unroll
    for (int j = 0; j < 4; ++j) dq[i][j] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    const int s = t & 1;
    if (t + 1 < n_tiles) load_stage(t + 1, s ^ 1);
    cp_async_commit();

    const __nv_bfloat16* k_s = sK + s * BN * LDS;
    const __nv_bfloat16* v_s = sV + s * BN * LDS;
    const int k0 = t * BN;

    // S = Q K^T
    float sc[NB][4];
    #pragma unroll
    for (int i = 0; i < NB; ++i)
      #pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
    mma_abt<D, BN, C::ROW_IN_REGS>(sc, qf, sQ, a_off, k_s, lane);

    // P = exp2(s * sm_scale * log2e - lse * log2e); masked keys 0
    #pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
      const int col = k0 + nb * 8 + tig * 2;
      const bool ok0 = col < p.Sk && (valid == nullptr || valid[col]);
      const bool ok1 = col + 1 < p.Sk && (valid == nullptr || valid[col + 1]);
      #pragma unroll
      for (int j = 0; j < 4; ++j) {
        bool ok = (j & 1) ? ok1 : ok0;
        if (p.causal) ok = ok && col + (j & 1) <= row0 + (j >> 1) * 8;
        sc[nb][j] = ok ? fast_exp2(sc[nb][j] * p.scale_log2 - lse2[j >> 1])
                       : 0.f;
      }
    }

    // dP = dO V^T
    float dp[NB][4];
    #pragma unroll
    for (int i = 0; i < NB; ++i)
      #pragma unroll
      for (int j = 0; j < 4; ++j) dp[i][j] = 0.f;
    mma_abt<D, BN, C::ROW_IN_REGS>(dp, dof, sdO, a_off, v_s, lane);

    // dS = P (dP - delta)
    #pragma unroll
    for (int nb = 0; nb < NB; ++nb)
      #pragma unroll
      for (int j = 0; j < 4; ++j)
        dp[nb][j] = sc[nb][j] * (dp[nb][j] - dl[j >> 1]);

    // dQ += dS K
    mma_pb<D, DC, BN>(dq, dp, k_s, c0, lane);

    cp_async_wait_all();
    __syncthreads();
  }

  store_rows<DC>(p.dq + b * p.dq_sb + h * p.dq_sh, p.dq_ss, dq, row0, p.Sq,
                 p.d, c0, tig, p.sm_scale);
}

template <int D>
int launch_width(const Params& p, cudaStream_t stream) {
  using C = Cfg<D>;
  cudaError_t err = cudaFuncSetAttribute(
      dkv_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(
      dq_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid_kv(p.B * p.H, (p.Sk + C::BLOCK_M - 1) / C::BLOCK_M,
                     D / C::DC);
  dkv_kernel<D><<<grid_kv, C::THREADS, C::SMEM, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid_q(p.B * p.H, (p.Sq + C::BLOCK_M - 1) / C::BLOCK_M,
                    D / C::DC);
  dq_kernel<D><<<grid_q, C::THREADS, C::SMEM, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Returns the CUDA error of the launches (0 on success);
// cudaErrorInvalidValue for a head width the kernels do not take.  `delta`
// is f32 scratch of B*H*Sq values that the wrapper allocates.
extern "C" int flash_bwd_bf16(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* delta, void* dq, void* dk,
    void* dv, const void* kv_valid, int B, int H, int Sq, int Sk, int d,
    long long q_sb, long long q_ss, long long q_sh, long long k_sb,
    long long k_ss, long long k_sh, long long v_sb, long long v_ss,
    long long v_sh, long long o_sb, long long o_ss, long long o_sh,
    long long do_sb, long long do_ss, long long do_sh, long long dq_sb,
    long long dq_ss, long long dq_sh, long long dk_sb, long long dk_ss,
    long long dk_sh, long long dv_sb, long long dv_ss, long long dv_sh,
    float sm_scale, int causal, void* stream) {
  Params p;
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const __nv_bfloat16*>(k);
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.o = static_cast<const __nv_bfloat16*>(o);
  p.dout = static_cast<const __nv_bfloat16*>(dout);
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<float*>(delta);
  p.dq = static_cast<__nv_bfloat16*>(dq);
  p.dk = static_cast<__nv_bfloat16*>(dk);
  p.dv = static_cast<__nv_bfloat16*>(dv);
  p.kv_valid = static_cast<const uint8_t*>(kv_valid);
  p.B = B;
  p.H = H;
  p.Sq = Sq;
  p.Sk = Sk;
  p.d = d;
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
  p.causal = causal;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d <= 0 || d % 8 != 0 || d > 256 || B <= 0 || H <= 0 || Sq <= 0 ||
      Sk <= 0)
    return static_cast<int>(cudaErrorInvalidValue);

  const long long rows = (long long)B * H * Sq;
  constexpr int DELTA_WARPS = 8;
  const long long blocks = (rows + DELTA_WARPS - 1) / DELTA_WARPS;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  delta_kernel<<<static_cast<unsigned>(blocks), DELTA_WARPS * 32, 0, s>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  if (d <= 32) return launch_width<32>(p, s);
  if (d <= 64) return launch_width<64>(p, s);
  if (d <= 80) return launch_width<80>(p, s);
  if (d <= 128) return launch_width<128>(p, s);
  return launch_width<256>(p, s);
}
