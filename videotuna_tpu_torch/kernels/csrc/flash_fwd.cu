// Generic flash-attention forward, bf16 (and f32: see the f32 section at
// the end), on Hopper (sm_90a): any head width up to 256, optional causal
// mask, optional per-key validity mask, online or fixed-max softmax,
// optional LSE.
//
// Replaces two TPU kernels of the JAX package (videotuna_tpu/kernels/
// attention.py):
//   K2  `_flash_kernel` launched by `flash_attention` (:78, :812), the
//       generic online-softmax forward (causal, ragged keys, fixed max);
//   K4  `_flash_kernel_dynpad` launched by `_flash_dynpad` (:970, :1059),
//       the `kv_valid`-masked forward with its optional LSE;
// and, by mapping,
//   K3  `_flash_kernel_t128` launched by `_flash_t128` (:581, :648), the
//       fixed-max forward of every d <= 128 (zero-padded to 128 lanes
//       there), which is this kernel with use_static=1;
//   K5  `_flash_fwd_lse_kernel` launched by `_flash_forward_lse` (:867,
//       :933), the training forward, which is K2 writing the LSE;
//   K1, K6  the d=64 forwards (`_flash_packed2t`, `_flash_packed2`) in f32.
// In bf16 the persistent kernel of flash_fwd_sm90.cu takes K1 and K6, and
// K2, K4 and K5 at d = 72 and 80 (non-causal); this kernel stays their
// A/B baseline there.
// It computes the same function, not the same blocks.  What differs on
// purpose:
//   - Ragged and masked keys.  K2 zero-pads keys and removes their share of
//     the row sum in closed form (`kv_pad`); K4 does the same from a
//     per-batch count of zeroed keys.  Here a key past Sk, above the causal
//     diagonal or with kv_valid[b, key] == 0 gets a score of -inf.  It is
//     the same function, and masking stays exact where every valid score
//     lies far below 0, where the closed form cancels badly.  Any mask
//     pattern is allowed, not only a prefix.
//   - A row with no valid key writes zeros (as `_flash_kernel_dynpad` does
//     after its clamp) and an LSE of -inf.
//   - p is rounded to bf16 for the PV product on the tensor cores (K2 keeps
//     it in f32), as K1 does: about 2^-8 of relative error per term.
//
// Function.  q (B,Sq,H,d), k and v (B,Sk,H,d), read in place through their
// strides (the head dim contiguous, d a multiple of 8).  With
// s = (q.k) * sm_scale * log2e:
//   fixed max M (use_static=1):   p = exp2(s - M), l = sum p, o = (p @ v) / l
//   online softmax (use_static=0): the running-max form of the same sum.
// The fixed-max form is exact while every s lies in (M - 126, M + 127).
// Causal is top-left aligned: key j is valid for query row i when j <= i.
// The statistics and the accumulator are f32; o is bf16; with `lse` the
// kernel writes lse[b,h,i] = (m + log2 l) / log2e, f32.
//
// Head width.  The kernel is instantiated for padded widths D = 32, 64, 80,
// 128 and 256, and d rounds up to the next one (d = 72 -> 80: the mma
// k-depth is 16).  The padded columns are zero-filled in shared memory
// only; they are never read from or written to device memory.
//
// What bounds it.  At the Open-Sora STDiT-XL/2 shapes (d = 72 -> 80) the
// sequences are short: spatial self-attention (B=32, S=256, H=16) does
// 9.7 GFLOP over 75.5 MB of q, k, v, o, the T5 cross-attention (B=2,
// Sq=4096, Sk=120, H=16) 4.5 GFLOP over 38.8 MB.  At 989 TF/s and
// 3.35 TB/s both are bound by bytes (about 22.5 and 11.6 us).  So q, k, v
// and o each cross device memory once: no padded copy is written, the scores
// never leave registers, and K/V tiles are staged with cp.async so that the
// next tile's load overlaps this tile's products.  With only 2-4 key tiles a
// row, the pipeline is shallow.  At HunyuanVideo's joint attention (K3: B=1,
// S=119,056, H=24, d=128) the call is bound by operations instead
// (1.74e14 FLOP, 176 ms at 989 TF/s; its 2.9 GB take 0.9 ms), and there the
// mma.sync products and 64-key tiles set the pace; TMA, wgmma and warp
// specialisation are left for a later version.
//
// Layout.  One block per (query tile, b*h), b*h on gridDim.x; each warp owns
// 16 query rows.  D <= 128: 128-row query tiles (8 warps), 64-key tiles, the
// q fragments held in registers.  D = 256: 64-row query tiles (4 warps),
// 32-key tiles, the q fragments read from shared memory at each k-step so
// that the 16x256 f32 accumulator fits in registers without spills.
// Shared-memory rows are padded by 8 elements so ldmatrix hits distinct
// banks.  mma.sync m16n8k16 bf16 -> f32 for both products; the S
// accumulator is reused in registers as P.

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
  __nv_bfloat16* o;
  float* lse;               // (B, H, Sq) or nullptr
  const uint8_t* kv_valid;  // (B, Sk), 0 = masked key, or nullptr
  int B, H, Sq, Sk, d;
  long long q_sb, q_ss, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long o_sb, o_ss, o_sh;
  float scale_log2;  // sm_scale * log2(e)
  float static_max;  // M, log2 domain (used when use_static)
  int causal;
};

template <int D>
struct Cfg {
  static constexpr int BLOCK_M = D <= 128 ? 128 : 64;
  static constexpr int BLOCK_N = D <= 128 ? 64 : 32;
  static constexpr int THREADS = BLOCK_M / 16 * 32;
  static constexpr int LDS = D + 8;  // padded shared-memory row, in elements
  static constexpr bool Q_IN_REGS = D <= 128;
  static constexpr int SMEM = (BLOCK_M + 2 * BLOCK_N) * LDS * 2;
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

template <int D, bool STATIC_MAX>
__global__ void __launch_bounds__(Cfg<D>::THREADS)
    flash_fwd_kernel(const Params p) {
  using C = Cfg<D>;
  constexpr int BLOCK_M = C::BLOCK_M;
  constexpr int BLOCK_N = C::BLOCK_N;
  constexpr int THREADS = C::THREADS;
  constexpr int LDS = C::LDS;
  constexpr int KS = D / 16;       // k-steps of QK^T over the head dim
  constexpr int NB = BLOCK_N / 8;  // 8-key column blocks of S
  constexpr int KK = BLOCK_N / 16; // k-steps of PV over the keys
  constexpr int DB = D / 8;        // 8-wide column blocks of O

  extern __shared__ __align__(128) unsigned char smem_raw[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sK = sQ + BLOCK_M * LDS;
  __nv_bfloat16* sV = sK + BLOCK_N * LDS;

  const int bh = blockIdx.x;
  const int b = bh / p.H;
  const int h = bh - b * p.H;
  const int m0 = blockIdx.y * BLOCK_M;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;   // row within the 8-row group
  const int tig = lane & 3;  // thread in group
  const int row0 = m0 + warp * 16 + g;  // query row of c[0..1]; +8: c[2..3]

  const __nv_bfloat16* qb = p.q + b * p.q_sb + h * p.q_sh + m0 * p.q_ss;
  const __nv_bfloat16* kb = p.k + b * p.k_sb + h * p.k_sh;
  const __nv_bfloat16* vb = p.v + b * p.v_sb + h * p.v_sh;
  const uint8_t* valid =
      p.kv_valid != nullptr ? p.kv_valid + (long long)b * p.Sk : nullptr;
  int n_tiles = (p.Sk + BLOCK_N - 1) / BLOCK_N;
  if (p.causal) {  // keys past the block's last row are all masked
    const int last_row = min(m0 + BLOCK_M, p.Sq) - 1;
    n_tiles = min(n_tiles, last_row / BLOCK_N + 1);
  }

  load_tile<BLOCK_M, D, THREADS>(sQ, qb, p.q_ss, p.Sq - m0, p.d);
  load_tile<BLOCK_N, D, THREADS>(sK, kb, p.k_ss, p.Sk, p.d);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  // A-fragment address of this lane for k-step ks: sQ + q_off + ks * 16
  const int q_off = (warp * 16 + (lane & 15)) * LDS + (lane >> 4) * 8;
  uint32_t qf[C::Q_IN_REGS ? KS : 1][4];
  if constexpr (C::Q_IN_REGS) {
    #pragma unroll
    for (int ks = 0; ks < KS; ++ks) ldmatrix_x4(qf[ks], sQ + q_off + ks * 16);
  }

  float acc[DB][4];
  #pragma unroll
  for (int i = 0; i < DB; ++i)
    #pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  // per-thread stats for rows row0 and row0 + 8
  float row_m[2] = {-INFINITY, -INFINITY};
  float row_l[2] = {0.f, 0.f};

  for (int t = 0; t < n_tiles; ++t) {
    const int n0 = t * BLOCK_N;
    // V(t) load overlaps S = Q K(t)^T.
    load_tile<BLOCK_N, D, THREADS>(sV, vb + n0 * p.v_ss, p.v_ss, p.Sk - n0,
                                   p.d);
    cp_async_commit();

    float s[NB][4];
    #pragma unroll
    for (int i = 0; i < NB; ++i)
      #pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    #pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      uint32_t a[4];
      if constexpr (C::Q_IN_REGS) {
        #pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = qf[ks][i];
      } else {
        ldmatrix_x4(a, sQ + q_off + ks * 16);
      }
      #pragma unroll
      for (int nb = 0; nb < NB; nb += 2) {
        uint32_t bf[4];
        const int key = nb * 8 + (lane & 7) + ((lane >> 4) << 3);
        const int c = ks * 16 + ((lane >> 3) & 1) * 8;
        ldmatrix_x4(bf, sK + key * LDS + c);
        mma_bf16(s[nb], a, bf[0], bf[1]);
        mma_bf16(s[nb + 1], a, bf[2], bf[3]);
      }
    }
    __syncthreads();  // every warp is done with sK
    if (t + 1 < n_tiles) {
      load_tile<BLOCK_N, D, THREADS>(sK, kb + (n0 + BLOCK_N) * p.k_ss,
                                     p.k_ss, p.Sk - n0 - BLOCK_N, p.d);
    }
    cp_async_commit();

    // scale into the log2 domain; -inf for keys past Sk, above the causal
    // diagonal or masked out by kv_valid
    const bool edge = n0 + BLOCK_N > p.Sk ||
                      (p.causal && n0 + BLOCK_N - 1 > m0) || valid != nullptr;
    if (edge) {
      #pragma unroll
      for (int nb = 0; nb < NB; ++nb) {
        const int col = n0 + nb * 8 + tig * 2;
        const bool ok0 = col < p.Sk && (valid == nullptr || valid[col]);
        const bool ok1 =
            col + 1 < p.Sk && (valid == nullptr || valid[col + 1]);
        #pragma unroll
        for (int j = 0; j < 4; ++j) {
          bool ok = (j & 1) ? ok1 : ok0;
          if (p.causal) ok = ok && col + (j & 1) <= row0 + (j >> 1) * 8;
          s[nb][j] = ok ? s[nb][j] * p.scale_log2 : -INFINITY;
        }
      }
    } else {
      #pragma unroll
      for (int nb = 0; nb < NB; ++nb)
        #pragma unroll
        for (int j = 0; j < 4; ++j) s[nb][j] *= p.scale_log2;
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
        // a row with no valid key so far keeps m = -inf; subtract 0 there
        // so that exp2 sees -inf and not NaN
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

    // P = exp2(s - m), rounded to bf16 as A fragments for PV
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
      row_l[r] += sum;  // quad-partial; reduced across the quad at the end
    }
    uint32_t pf[KK][4];
    #pragma unroll
    for (int kk = 0; kk < KK; ++kk) {
      pf[kk][0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      pf[kk][1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      pf[kk][2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pf[kk][3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
    }

    // wait for V(t) (K(t+1) may stay in flight)
    cp_async_wait<1>();
    __syncthreads();
    #pragma unroll
    for (int kk = 0; kk < KK; ++kk) {
      #pragma unroll
      for (int db = 0; db < DB; db += 2) {
        uint32_t bf[4];
        const int key = kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
        const int c = db * 8 + (lane >> 4) * 8;
        ldmatrix_x4_trans(bf, sV + key * LDS + c);
        mma_bf16(acc[db], pf[kk], bf[0], bf[1]);
        mma_bf16(acc[db + 1], pf[kk], bf[2], bf[3]);
      }
    }
    cp_async_wait<0>();
    __syncthreads();  // K(t+1) landed; every warp is done with sV
  }

  // epilogue: reduce l over the quad, normalise, store the first d columns
  #pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = row_l[r];
    l += __shfl_xor_sync(0xffffffff, l, 1);
    l += __shfl_xor_sync(0xffffffff, l, 2);
    const float inv = l > 0.f ? 1.f / l : 0.f;  // no valid key: zeros
    const int row = row0 + r * 8;
    if (row < p.Sq) {
      __nv_bfloat16* orow = p.o + b * p.o_sb + h * p.o_sh + row * p.o_ss;
      #pragma unroll
      for (int db = 0; db < DB; ++db) {
        const int col = db * 8 + tig * 2;
        if (col < p.d) {
          *reinterpret_cast<__nv_bfloat162*>(orow + col) =
              __floats2bfloat162_rn(acc[db][2 * r] * inv,
                                    acc[db][2 * r + 1] * inv);
        }
      }
      if (p.lse != nullptr && tig == 0) {
        const float m = STATIC_MAX ? p.static_max : row_m[r];
        p.lse[(long long)bh * p.Sq + row] =
            l > 0.f ? (m + log2f(l)) / LOG2E : -INFINITY;
      }
    }
  }
}

template <int D, bool STATIC_MAX>
int launch(const Params& p, cudaStream_t stream) {
  using C = Cfg<D>;
  auto kernel = flash_fwd_kernel<D, STATIC_MAX>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(p.B * p.H, (p.Sq + C::BLOCK_M - 1) / C::BLOCK_M);
  kernel<<<grid, C::THREADS, C::SMEM, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_width(const Params& p, int use_static, cudaStream_t stream) {
  return use_static ? launch<D, true>(p, stream) : launch<D, false>(p, stream);
}

// ---------------------------------------------------------------------------
// f32 inputs.  The JAX package runs its Pallas kernels on f32 q, k, v too
// (the 2D VAE's mid attention at ch * ch_mult[-1] <= 256 reaches them), so
// this kernel takes f32 and writes f32.  Each f32 value x is split into
// hi = bf16(x) and lo = bf16(x - hi) in shared memory, and each product runs
// as three bf16 mma.sync products (hi*hi + hi*lo + lo*hi) with f32
// accumulation: about 16 mantissa bits per product against the 8 of one bf16
// product, so the output agrees with the f32 plain version to ~1e-5 of
// max|o|.  p is split the same way for PV.  Loads are plain f32 loads
// converted in registers (cp.async cannot convert), so this path does not
// overlap loads with the products: it is the accurate path, not the fast one.
// 64-row query tiles (4 warps), 32-key tiles, q read from shared memory at
// each k-step: at D = 256 the hi/lo tiles take 135 KB of shared memory.

struct Params32 {
  const float* q;
  const float* k;
  const float* v;
  float* o;
  float* lse;
  const uint8_t* kv_valid;
  int B, H, Sq, Sk, d;
  long long q_sb, q_ss, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long o_sb, o_ss, o_sh;
  float scale_log2;
  float static_max;
  int causal;
};

template <int D>
struct Cfg32 {
  static constexpr int BLOCK_M = 64;
  static constexpr int BLOCK_N = 32;
  static constexpr int THREADS = BLOCK_M / 16 * 32;
  static constexpr int LDS = D + 8;
  // hi and lo copies of the q tile, of one k tile and of one v tile
  static constexpr int SMEM = 2 * (BLOCK_M + 2 * BLOCK_N) * LDS * 2;
};

// Stage ROWS rows of the first d f32 elements (row i at src + i*stride) as
// hi = bf16(x) into `hi` and lo = bf16(x - hi) into `lo` (row pitch D + 8).
// Rows at or past `valid` and columns at or past d are zero.
template <int ROWS, int D, int THREADS>
__device__ __forceinline__ void load_split(__nv_bfloat16* hi,
                                           __nv_bfloat16* lo,
                                           const float* src, long long stride,
                                           int valid, int d) {
  constexpr int CH = D / 4;  // float4 chunks per padded row
  constexpr int LDS = D + 8;
  for (int c = threadIdx.x; c < ROWS * CH; c += THREADS) {
    const int r = c / CH;
    const int col = (c - r * CH) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < valid && col < d)
      x = *reinterpret_cast<const float4*>(src + r * stride + col);
    const __nv_bfloat162 h01 = __floats2bfloat162_rn(x.x, x.y);
    const __nv_bfloat162 h23 = __floats2bfloat162_rn(x.z, x.w);
    const float2 f01 = __bfloat1622float2(h01);
    const float2 f23 = __bfloat1622float2(h23);
    __nv_bfloat162* dh = reinterpret_cast<__nv_bfloat162*>(hi + r * LDS + col);
    __nv_bfloat162* dl = reinterpret_cast<__nv_bfloat162*>(lo + r * LDS + col);
    dh[0] = h01;
    dh[1] = h23;
    dl[0] = __floats2bfloat162_rn(x.x - f01.x, x.y - f01.y);
    dl[1] = __floats2bfloat162_rn(x.z - f23.x, x.w - f23.y);
  }
}

// (x0, x1) → packed bf16 hi pair and the packed bf16 pair of the remainders
__device__ __forceinline__ void split_pack(float x0, float x1, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 f = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(x0 - f.x, x1 - f.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

template <int D, bool STATIC_MAX>
__global__ void __launch_bounds__(Cfg32<D>::THREADS)
    flash_fwd_f32_kernel(const Params32 p) {
  using C = Cfg32<D>;
  constexpr int BLOCK_M = C::BLOCK_M;
  constexpr int BLOCK_N = C::BLOCK_N;
  constexpr int THREADS = C::THREADS;
  constexpr int LDS = C::LDS;
  constexpr int KS = D / 16;
  constexpr int NB = BLOCK_N / 8;
  constexpr int KK = BLOCK_N / 16;
  constexpr int DB = D / 8;

  extern __shared__ __align__(128) unsigned char smem_raw[];
  __nv_bfloat16* sQh = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sQl = sQh + BLOCK_M * LDS;
  __nv_bfloat16* sKh = sQl + BLOCK_M * LDS;
  __nv_bfloat16* sKl = sKh + BLOCK_N * LDS;
  __nv_bfloat16* sVh = sKl + BLOCK_N * LDS;
  __nv_bfloat16* sVl = sVh + BLOCK_N * LDS;

  const int bh = blockIdx.x;
  const int b = bh / p.H;
  const int h = bh - b * p.H;
  const int m0 = blockIdx.y * BLOCK_M;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int tig = lane & 3;
  const int row0 = m0 + warp * 16 + g;

  const float* qb = p.q + b * p.q_sb + h * p.q_sh + m0 * p.q_ss;
  const float* kb = p.k + b * p.k_sb + h * p.k_sh;
  const float* vb = p.v + b * p.v_sb + h * p.v_sh;
  const uint8_t* valid =
      p.kv_valid != nullptr ? p.kv_valid + (long long)b * p.Sk : nullptr;
  int n_tiles = (p.Sk + BLOCK_N - 1) / BLOCK_N;
  if (p.causal) {
    const int last_row = min(m0 + BLOCK_M, p.Sq) - 1;
    n_tiles = min(n_tiles, last_row / BLOCK_N + 1);
  }

  load_split<BLOCK_M, D, THREADS>(sQh, sQl, qb, p.q_ss, p.Sq - m0, p.d);
  const int q_off = (warp * 16 + (lane & 15)) * LDS + (lane >> 4) * 8;

  float acc[DB][4];
  #pragma unroll
  for (int i = 0; i < DB; ++i)
    #pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  float row_m[2] = {-INFINITY, -INFINITY};
  float row_l[2] = {0.f, 0.f};

  for (int t = 0; t < n_tiles; ++t) {
    const int n0 = t * BLOCK_N;
    __syncthreads();  // every warp is done with the previous k, v tiles
    load_split<BLOCK_N, D, THREADS>(sKh, sKl, kb + n0 * p.k_ss, p.k_ss,
                                    p.Sk - n0, p.d);
    load_split<BLOCK_N, D, THREADS>(sVh, sVl, vb + n0 * p.v_ss, p.v_ss,
                                    p.Sk - n0, p.d);
    __syncthreads();

    float s[NB][4];
    #pragma unroll
    for (int i = 0; i < NB; ++i)
      #pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    #pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      uint32_t ah[4], al[4];
      ldmatrix_x4(ah, sQh + q_off + ks * 16);
      ldmatrix_x4(al, sQl + q_off + ks * 16);
      #pragma unroll
      for (int nb = 0; nb < NB; nb += 2) {
        uint32_t bh4[4], bl4[4];
        const int key = nb * 8 + (lane & 7) + ((lane >> 4) << 3);
        const int c = ks * 16 + ((lane >> 3) & 1) * 8;
        ldmatrix_x4(bh4, sKh + key * LDS + c);
        ldmatrix_x4(bl4, sKl + key * LDS + c);
        mma_bf16(s[nb], ah, bh4[0], bh4[1]);
        mma_bf16(s[nb], ah, bl4[0], bl4[1]);
        mma_bf16(s[nb], al, bh4[0], bh4[1]);
        mma_bf16(s[nb + 1], ah, bh4[2], bh4[3]);
        mma_bf16(s[nb + 1], ah, bl4[2], bl4[3]);
        mma_bf16(s[nb + 1], al, bh4[2], bh4[3]);
      }
    }

    const bool edge = n0 + BLOCK_N > p.Sk ||
                      (p.causal && n0 + BLOCK_N - 1 > m0) || valid != nullptr;
    #pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
      const int col = n0 + nb * 8 + tig * 2;
      const bool ok0 =
          !edge || (col < p.Sk && (valid == nullptr || valid[col]));
      const bool ok1 =
          !edge || (col + 1 < p.Sk && (valid == nullptr || valid[col + 1]));
      #pragma unroll
      for (int j = 0; j < 4; ++j) {
        bool ok = (j & 1) ? ok1 : ok0;
        if (edge && p.causal) ok = ok && col + (j & 1) <= row0 + (j >> 1) * 8;
        s[nb][j] = ok ? s[nb][j] * p.scale_log2 : -INFINITY;
      }
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
      for (int db = 0; db < DB; db += 2) {
        uint32_t bh4[4], bl4[4];
        const int key = kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
        const int c = db * 8 + (lane >> 4) * 8;
        ldmatrix_x4_trans(bh4, sVh + key * LDS + c);
        ldmatrix_x4_trans(bl4, sVl + key * LDS + c);
        mma_bf16(acc[db], ph[kk], bh4[0], bh4[1]);
        mma_bf16(acc[db], ph[kk], bl4[0], bl4[1]);
        mma_bf16(acc[db], pl[kk], bh4[0], bh4[1]);
        mma_bf16(acc[db + 1], ph[kk], bh4[2], bh4[3]);
        mma_bf16(acc[db + 1], ph[kk], bl4[2], bl4[3]);
        mma_bf16(acc[db + 1], pl[kk], bh4[2], bh4[3]);
      }
    }
  }

  #pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = row_l[r];
    l += __shfl_xor_sync(0xffffffff, l, 1);
    l += __shfl_xor_sync(0xffffffff, l, 2);
    const float inv = l > 0.f ? 1.f / l : 0.f;
    const int row = row0 + r * 8;
    if (row < p.Sq) {
      float* orow = p.o + b * p.o_sb + h * p.o_sh + row * p.o_ss;
      #pragma unroll
      for (int db = 0; db < DB; ++db) {
        const int col = db * 8 + tig * 2;
        if (col < p.d) {
          *reinterpret_cast<float2*>(orow + col) =
              make_float2(acc[db][2 * r] * inv, acc[db][2 * r + 1] * inv);
        }
      }
      if (p.lse != nullptr && tig == 0) {
        const float m = STATIC_MAX ? p.static_max : row_m[r];
        p.lse[(long long)bh * p.Sq + row] =
            l > 0.f ? (m + log2f(l)) / LOG2E : -INFINITY;
      }
    }
  }
}

template <int D, bool STATIC_MAX>
int launch32(const Params32& p, cudaStream_t stream) {
  using C = Cfg32<D>;
  auto kernel = flash_fwd_f32_kernel<D, STATIC_MAX>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(p.B * p.H, (p.Sq + C::BLOCK_M - 1) / C::BLOCK_M);
  kernel<<<grid, C::THREADS, C::SMEM, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_width32(const Params32& p, int use_static, cudaStream_t stream) {
  return use_static ? launch32<D, true>(p, stream)
                    : launch32<D, false>(p, stream);
}

}  // namespace

// Returns the CUDA error of the launch (0 on success); cudaErrorInvalidValue
// for a head width the kernel does not take.
extern "C" int flash_fwd_bf16(
    const void* q, const void* k, const void* v, void* o, void* lse,
    const void* kv_valid, int B, int H, int Sq, int Sk, int d,
    long long q_sb, long long q_ss, long long q_sh, long long k_sb,
    long long k_ss, long long k_sh, long long v_sb, long long v_ss,
    long long v_sh, long long o_sb, long long o_ss, long long o_sh,
    float scale_log2, int causal, int use_static, float static_max,
    void* stream) {
  Params p;
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const __nv_bfloat16*>(k);
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.o = static_cast<__nv_bfloat16*>(o);
  p.lse = static_cast<float*>(lse);
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
  p.scale_log2 = scale_log2;
  p.static_max = static_max;
  p.causal = causal;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d <= 0 || d % 8 != 0 || B <= 0 || H <= 0 || Sq <= 0 || Sk <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (d <= 32) return launch_width<32>(p, use_static, s);
  if (d <= 64) return launch_width<64>(p, use_static, s);
  if (d <= 80) return launch_width<80>(p, use_static, s);
  if (d <= 128) return launch_width<128>(p, use_static, s);
  if (d <= 256) return launch_width<256>(p, use_static, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// f32 q, k, v → f32 o (and lse): the same arguments as flash_fwd_bf16.
extern "C" int flash_fwd_f32(
    const void* q, const void* k, const void* v, void* o, void* lse,
    const void* kv_valid, int B, int H, int Sq, int Sk, int d,
    long long q_sb, long long q_ss, long long q_sh, long long k_sb,
    long long k_ss, long long k_sh, long long v_sb, long long v_ss,
    long long v_sh, long long o_sb, long long o_ss, long long o_sh,
    float scale_log2, int causal, int use_static, float static_max,
    void* stream) {
  Params32 p;
  p.q = static_cast<const float*>(q);
  p.k = static_cast<const float*>(k);
  p.v = static_cast<const float*>(v);
  p.o = static_cast<float*>(o);
  p.lse = static_cast<float*>(lse);
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
  p.scale_log2 = scale_log2;
  p.static_max = static_max;
  p.causal = causal;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d <= 0 || d % 8 != 0 || B <= 0 || H <= 0 || Sq <= 0 || Sk <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (d <= 32) return launch_width32<32>(p, use_static, s);
  if (d <= 64) return launch_width32<64>(p, use_static, s);
  if (d <= 80) return launch_width32<80>(p, use_static, s);
  if (d <= 128) return launch_width32<128>(p, use_static, s);
  if (d <= 256) return launch_width32<256>(p, use_static, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
