// Non-causal flash-attention forward for head_dim 64, bf16, on Hopper (sm_90a).
//
// Replaces the TPU kernel K1 of the JAX package: `_flash_kernel_packed2t`
// with its epilogue `_finish_packed2t_fused`, launched by `_flash_packed2t`
// (videotuna_tpu/kernels/attention.py:268, :244, :449).  It computes the same
// function, not the same blocks: the TPU packs head pairs into 128 lanes,
// computes transposed scores, folds the row sum into PV with a ones-row and
// zero-pads keys, all to suit the MXU and VPU.  None of that is needed here.
//
// Function.  q (B,Sq,H,64), k and v (B,Sk,H,64), read in place through their
// strides (the last dim must be contiguous).  With s = (q.k) * sm_scale * log2e:
//   fixed max M (use_static=1):  p = exp2(s - M), l = sum p, o = (p @ v) / l
//   online softmax (use_static=0): the running-max form of the same sum.
// p is rounded to bf16 before PV (the reference casts probabilities to
// v.dtype); the sums and the accumulator are f32.  The fixed-max form is exact
// while every s lies in (M - 126, M + 127); CogVideoX LayerNorms q and k per
// head, so |s| <= 8 * log2e ~ 11.5 at d=64 and M = 0 is safe.
// Optionally writes lse[b,h,i] = (m + log2 l) / log2e (natural log), f32.
//
// What bounds it.  At the CogVideoX-5B shape (B=2 with CFG, S=17776, H=48)
// one call does 4*B*H*S^2*d = 7.8e12 FLOP, 7.9 ms at the H100's 989 TF/s
// bf16 peak, while q, k, v and o move 0.44 GB, 0.13 ms at 3.35 TB/s: the
// kernel is bound by tensor-core operations.  So both products run on the
// tensor cores (mma.sync m16n8k16 bf16 -> f32), the scores never leave
// registers, and K/V tiles are staged in shared memory with cp.async so the
// next tile's load overlaps this tile's math.  This is the FA2 layout; wgmma
// and TMA, which the full Hopper rate needs, are left for a later version.
//
// Layout.  One block of 8 warps per (128 query rows, b*h); each warp owns 16
// rows.  K/V tiles of 64 keys, rows padded to 72 elements so ldmatrix reads
// hit distinct banks.  The ragged key edge is masked in the last tile (K/V
// rows past Sk are zero-filled by cp.async and their scores set to -inf); the
// ragged query edge is zero-filled and never stored.  No padded copy of
// q, k or v is ever written.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int D = 64;
constexpr int BLOCK_M = 128;
constexpr int BLOCK_N = 64;
constexpr int WARPS = BLOCK_M / 16;
constexpr int THREADS = WARPS * 32;
constexpr int LDS = D + 8;  // padded shared-memory row, in elements
constexpr float LOG2E = 1.4426950408889634f;

struct Params {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  __nv_bfloat16* o;
  float* lse;  // (B, H, Sq) or nullptr
  int B, H, Sq, Sk;
  long long q_sb, q_ss, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long o_sb, o_ss, o_sh;
  float scale_log2;  // sm_scale * log2(e)
  float static_max;  // M, log2 domain (used when use_static)
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

__device__ __forceinline__ void ldmatrix_x4(uint32_t& r0, uint32_t& r1,
                                            uint32_t& r2, uint32_t& r3,
                                            const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
      : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t& r0, uint32_t& r1,
                                                  uint32_t& r2, uint32_t& r3,
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
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

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Stage `rows` rows of 64 elements (row i at src + i*stride) into smem tile
// `dst` (row pitch LDS); rows at or past `valid` are zero-filled.
template <int ROWS>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src,
                                          long long stride, int valid) {
  constexpr int CHUNKS = ROWS * (D / 8);  // 16-byte chunks
  for (int c = threadIdx.x; c < CHUNKS; c += THREADS) {
    const int r = c >> 3;
    const int col = (c & 7) * 8;
    const bool ok = r < valid;
    const __nv_bfloat16* g = ok ? src + r * stride + col : src;
    cp_async16(dst + r * LDS + col, g, ok ? 16 : 0);
  }
}

template <bool STATIC_MAX>
__global__ void __launch_bounds__(THREADS)
    flash_fwd_d64_kernel(const Params p) {
  __shared__ __align__(128) __nv_bfloat16 sQ[BLOCK_M * LDS];
  __shared__ __align__(128) __nv_bfloat16 sK[BLOCK_N * LDS];
  __shared__ __align__(128) __nv_bfloat16 sV[BLOCK_N * LDS];

  const int bh = blockIdx.y;
  const int b = bh / p.H;
  const int h = bh - b * p.H;
  const int m0 = blockIdx.x * BLOCK_M;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;   // row within the 8-row group
  const int tig = lane & 3;  // thread in group

  const __nv_bfloat16* qb = p.q + b * p.q_sb + h * p.q_sh + m0 * p.q_ss;
  const __nv_bfloat16* kb = p.k + b * p.k_sb + h * p.k_sh;
  const __nv_bfloat16* vb = p.v + b * p.v_sb + h * p.v_sh;
  const int n_tiles = (p.Sk + BLOCK_N - 1) / BLOCK_N;

  load_tile<BLOCK_M>(sQ, qb, p.q_ss, p.Sq - m0);
  load_tile<BLOCK_N>(sK, kb, p.k_ss, p.Sk);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  // Q fragments for this warp's 16 rows, 4 k-steps of 16 over d.
  uint32_t qf[4][4];
  {
    const int r = warp * 16 + (lane & 15);
    #pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      const int c = ks * 16 + (lane >> 4) * 8;
      ldmatrix_x4(qf[ks][0], qf[ks][1], qf[ks][2], qf[ks][3],
                  sQ + r * LDS + c);
    }
  }

  float acc[8][4];  // O: 8 d-blocks of 8 columns
  #pragma unroll
  for (int i = 0; i < 8; ++i)
    #pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  // per-thread stats for rows g and g+8 of the warp's 16
  float row_m[2] = {-INFINITY, -INFINITY};
  float row_l[2] = {0.f, 0.f};

  for (int t = 0; t < n_tiles; ++t) {
    const int n0 = t * BLOCK_N;
    // V(t) load overlaps S = Q K(t)^T.
    load_tile<BLOCK_N>(sV, vb + n0 * p.v_ss, p.v_ss, p.Sk - n0);
    cp_async_commit();

    float s[8][4];  // 8 key-blocks of 8
    #pragma unroll
    for (int i = 0; i < 8; ++i)
      #pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    #pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      #pragma unroll
      for (int nb = 0; nb < 8; nb += 2) {
        uint32_t b0, b1, b2, b3;
        const int key = nb * 8 + (lane & 7) + ((lane >> 4) << 3);
        const int c = ks * 16 + ((lane >> 3) & 1) * 8;
        ldmatrix_x4(b0, b1, b2, b3, sK + key * LDS + c);
        mma_bf16(s[nb], qf[ks], b0, b1);
        mma_bf16(s[nb + 1], qf[ks], b2, b3);
      }
    }
    __syncthreads();  // every warp is done with sK
    if (t + 1 < n_tiles) {
      load_tile<BLOCK_N>(sK, kb + (n0 + BLOCK_N) * p.k_ss, p.k_ss,
                         p.Sk - n0 - BLOCK_N);
    }
    cp_async_commit();

    // scale into the log2 domain; mask keys past Sk
    const int kv_valid = p.Sk - n0;
    #pragma unroll
    for (int nb = 0; nb < 8; ++nb) {
      const int col = nb * 8 + tig * 2;
      #pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool ok = (col + (j & 1)) < kv_valid;
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
        for (int nb = 0; nb < 8; ++nb)
          mx = fmaxf(mx, fmaxf(s[nb][2 * r], s[nb][2 * r + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffff, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffff, mx, 2));
        const float alpha = fast_exp2(row_m[r] - mx);
        row_l[r] *= alpha;
        #pragma unroll
        for (int nb = 0; nb < 8; ++nb) {
          acc[nb][2 * r] *= alpha;
          acc[nb][2 * r + 1] *= alpha;
        }
        row_m[r] = mx;
        m_use[r] = mx;
      }
    }

    // P = exp2(s - m), rounded to bf16 as A fragments for PV
    uint32_t pf[4][4];
    #pragma unroll
    for (int r = 0; r < 2; ++r) {
      float sum = 0.f;
      #pragma unroll
      for (int nb = 0; nb < 8; ++nb) {
        const float e0 = fast_exp2(s[nb][2 * r] - m_use[r]);
        const float e1 = fast_exp2(s[nb][2 * r + 1] - m_use[r]);
        s[nb][2 * r] = e0;
        s[nb][2 * r + 1] = e1;
        sum += e0 + e1;
      }
      row_l[r] += sum;  // quad-partial; reduced across the quad at the end
    }
    #pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      pf[kk][0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      pf[kk][1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      pf[kk][2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pf[kk][3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
    }

    // wait for V(t) (K(t+1) may stay in flight)
    cp_async_wait<1>();
    __syncthreads();
    #pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      #pragma unroll
      for (int db = 0; db < 8; db += 2) {
        uint32_t b0, b1, b2, b3;
        const int key = kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
        const int c = db * 8 + (lane >> 4) * 8;
        ldmatrix_x4_trans(b0, b1, b2, b3, sV + key * LDS + c);
        mma_bf16(acc[db], pf[kk], b0, b1);
        mma_bf16(acc[db + 1], pf[kk], b2, b3);
      }
    }
    cp_async_wait<0>();
    __syncthreads();  // K(t+1) landed; every warp is done with sV
  }

  // epilogue: reduce l over the quad, normalise, store
  #pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = row_l[r];
    l += __shfl_xor_sync(0xffffffff, l, 1);
    l += __shfl_xor_sync(0xffffffff, l, 2);
    l = fmaxf(l, 1e-30f);
    const float inv = 1.f / l;
    const int row = m0 + warp * 16 + g + r * 8;
    if (row < p.Sq) {
      __nv_bfloat16* orow = p.o + b * p.o_sb + h * p.o_sh + row * p.o_ss;
      #pragma unroll
      for (int db = 0; db < 8; ++db) {
        const int col = db * 8 + tig * 2;
        *reinterpret_cast<__nv_bfloat162*>(orow + col) =
            __floats2bfloat162_rn(acc[db][2 * r] * inv,
                                  acc[db][2 * r + 1] * inv);
      }
      if (p.lse != nullptr && tig == 0) {
        const float m = STATIC_MAX ? p.static_max : row_m[r];
        p.lse[(long long)bh * p.Sq + row] = (m + log2f(l)) / LOG2E;
      }
    }
  }
}

}  // namespace

extern "C" int flash_fwd_d64_bf16(
    const void* q, const void* k, const void* v, void* o, void* lse, int B,
    int H, int Sq, int Sk, long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh, long long v_sb,
    long long v_ss, long long v_sh, long long o_sb, long long o_ss,
    long long o_sh, float scale_log2, int use_static, float static_max,
    void* stream) {
  Params p;
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const __nv_bfloat16*>(k);
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.o = static_cast<__nv_bfloat16*>(o);
  p.lse = static_cast<float*>(lse);
  p.B = B;
  p.H = H;
  p.Sq = Sq;
  p.Sk = Sk;
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
  const dim3 grid((Sq + BLOCK_M - 1) / BLOCK_M, B * H);
  const dim3 block(THREADS);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (use_static)
    flash_fwd_d64_kernel<true><<<grid, block, 0, s>>>(p);
  else
    flash_fwd_d64_kernel<false><<<grid, block, 0, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}
