// Fixed-max flash-attention forward for Hopper (sm_90a), bf16, head width
// 64 or 128, non-causal, no key mask: TMA loads, wgmma products, a producer
// warpgroup and two consumer warpgroups that take turns on the tensor cores.
//
// Replaces the TPU kernel K3 of the JAX package, `_flash_kernel_t128`
// launched by `_flash_t128` (videotuna_tpu/kernels/attention.py:581, :648),
// the d <= 128 fixed-max forward of the qk-normed denoisers (HunyuanVideo's
// joint attention).  It computes the function of `flash_fwd` (flash_fwd.cu)
// with use_static=1, not the TPU kernel's blocks: the transposed scores and
// the row sum folded into the PV product answer the TPU's matrix unit and
// are not copied, and keys past Sk score -inf where the TPU kernel removes
// their share of the row sum in closed form (the same function).
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

#include <math.h>

#include "sm90.cuh"

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
  int H, Sq, Sk;
  long long o_sb, o_ss, o_sh;
  float scale_log2;  // sm_scale * log2(e)
  float static_max;  // M, log2 domain
};

template <int D>
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
    // P = exp2(s * scale - M) of tile t in place, and its row sums; keys
    // past Sk (last tile only) give 0
    auto softmax = [&](int t) {
      const int valid = p.Sk - t * BLOCK_N;
      if (valid < BLOCK_N) {
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
      wgmma_wait<1>();
      release(k_empty(s1));
      softmax(t + 1);
      wgmma_wait<0>();
      release(v_empty(s));
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
      }
    }
  }
}

template <int D>
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
  auto kernel = flash_fwd_sm90_kernel<D>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Cfg<D>::SMEM);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((p.Sq + BLOCK_M - 1) / BLOCK_M, B * p.H);
  kernel<<<grid, THREADS, Cfg<D>::SMEM, stream>>>(tq, tk, tv, p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Returns the CUDA error of the launch (0 on success); cudaErrorInvalidValue
// for a head width other than 64 or 128, for B*H above 65535, or for a
// tensor TMA cannot read in place.
extern "C" int flash_fwd_sm90_bf16(
    const void* q, const void* k, const void* v, void* o, int B, int H,
    int Sq, int Sk, int d, long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh, long long v_sb,
    long long v_ss, long long v_sh, long long o_sb, long long o_ss,
    long long o_sh, float scale_log2, float static_max, void* stream) {
  if (B <= 0 || H <= 0 || Sq <= 0 || Sk <= 0 || (long long)B * H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.o = static_cast<__nv_bfloat16*>(o);
  p.H = H;
  p.Sq = Sq;
  p.Sk = Sk;
  p.o_sb = o_sb;
  p.o_ss = o_ss;
  p.o_sh = o_sh;
  p.scale_log2 = scale_log2;
  p.static_max = static_max;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d == 128)
    return launch<128>(q, k, v, p, B, q_sb, q_ss, q_sh, k_sb, k_ss, k_sh,
                       v_sb, v_ss, v_sh, s);
  if (d == 64)
    return launch<64>(q, k, v, p, B, q_sb, q_ss, q_sh, k_sb, k_ss, k_sh,
                      v_sb, v_ss, v_sh, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
