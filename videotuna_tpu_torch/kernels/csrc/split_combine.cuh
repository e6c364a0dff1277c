// The combine of a split-key flash forward, shared by the persistent kernel
// of flash_fwd_sm90.cu (bf16 output) and flash_fwd_f32_sm90.cu (f32
// output).  It replaces no TPU kernel: a TPU core walks a row's key tiles
// in one grid loop, so the Pallas kernels never split a row.  On the H100
// a short query side leaves most of the 132 SMs idle while one block walks
// every key tile, so a query tile's keys may be cut into ranges
// (`_fwd_split_plan` in kernels/attention.py), each a unit of its own that
// writes f32 partials instead of o:
//   o_j  (block_m, pitch) the unnormalised sum of p v over range j,
//   m_j, l_j  per row, the max the exponents were taken against (the
//        fixed max M, or the running max: -inf where the range held no
//        valid key of the row) and the sum of p.
// The combine then gives each row
//   m = max_j m_j,  w_j = exp2(m_j - m) (online; 1 under the fixed max, where
//   every m_j is M),  l = sum_j w_j l_j,  o = sum_j w_j o_j / l,
// the sums taken over j in order, so the output is the same bits on every
// run (no atomics); a row with l = 0 gets o = 0 and lse = -inf, else
// lse = (m + log2 l) ln 2, the natural-log LSE (B, H, Sq) that the
// backward reads.
//
// Layout.  Partial slot s of head bh is row block (bh * slots + s) of
// `part_o` ((B*H*slots, block_m, pitch) f32) and of `part_ml`
// ((B*H*slots, block_m, 2): m, l).  A split query tile's ranges have
// adjacent slots: `table` gives (query tile, first slot, ranges) for each
// split tile, or is null when every query tile is split into `splits`
// ranges at slots qt * splits... (the persistent kernel's uniform split).
// `combine_kernel`, launched second by both kernels, gives a block of 256
// threads 8 rows of a tile and a thread 4 columns of a row (d a multiple
// of 4).  It takes the ranges in one pass, merging each into a running
// max as the online softmax does (the same sums, rescaled as it goes), so
// that its loop, unrolled, sends every range's loads out at once: one
// round trip to L2, where the partials stay between the two launches.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace split {

constexpr int ROWS = 8;       // rows a combine block
constexpr int THREADS = 256;

__device__ __forceinline__ void store4(float* dst, float4 x) {
  reinterpret_cast<float2*>(dst)[0] = make_float2(x.x, x.y);
  reinterpret_cast<float2*>(dst)[1] = make_float2(x.z, x.w);
}
__device__ __forceinline__ void store4(__nv_bfloat16* dst, float4 x) {
  reinterpret_cast<__nv_bfloat162*>(dst)[0] = __floats2bfloat162_rn(x.x, x.y);
  reinterpret_cast<__nv_bfloat162*>(dst)[1] = __floats2bfloat162_rn(x.z, x.w);
}

struct CombineParams {
  const float* part_o;
  const float* part_ml;
  const int4* table;  // (query tile, first slot, ranges, -) or null
  int splits;         // ranges of every query tile when table is null
  int slots;          // partial slots of a head
  int block_m;        // rows of a query tile (a multiple of ROWS)
  int pitch;          // floats of a partial row
  int d, H, Sq;
  long long o_sb, o_ss, o_sh;
  float* lse;         // (B, H, Sq) or null
  int online;
};

template <typename T>
__global__ void __launch_bounds__(THREADS)
    combine_kernel(const CombineParams p, T* o) {
  const int sub = p.block_m / ROWS;
  const int tile = blockIdx.x / sub;
  int qt = tile, slot0 = tile * p.splits, n = p.splits;
  if (p.table != nullptr) {
    const int4 e = p.table[tile];
    qt = e.x;
    slot0 = e.y;
    n = e.z;
  }
  const int bh = blockIdx.y;
  const int b = bh / p.H;
  const int h = bh - b * p.H;
  const long long base = static_cast<long long>(bh) * p.slots + slot0;
  const int quads = p.d / 4;
  const float2* ml = reinterpret_cast<const float2*>(p.part_ml);
  for (int e = threadIdx.x; e < ROWS * quads; e += THREADS) {
    const int r = (blockIdx.x - tile * sub) * ROWS + e / quads;
    const int c = (e - (e / quads) * quads) * 4;
    const int row = qt * p.block_m + r;
    if (row >= p.Sq) continue;
    float m = -INFINITY;
    float l = 0.f;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    #pragma unroll 4
    for (int j = 0; j < n; ++j) {
      const long long pr = (base + j) * p.block_m + r;
      const float2 mlj = ml[pr];
      const float4 x =
          *reinterpret_cast<const float4*>(p.part_o + pr * p.pitch + c);
      float a = 1.f, w = 1.f;  // the factors of the sum so far and of range j
      if (p.online) {
        const float mn = fmaxf(m, mlj.x);
        a = m == -INFINITY ? 0.f : exp2f(m - mn);
        w = mlj.x == -INFINITY ? 0.f : exp2f(mlj.x - mn);
        m = mn;
      } else {
        m = mlj.x;
      }
      l = a * l + w * mlj.y;
      acc.x = a * acc.x + w * x.x;
      acc.y = a * acc.y + w * x.y;
      acc.z = a * acc.z + w * x.z;
      acc.w = a * acc.w + w * x.w;
    }
    const float inv = l > 0.f ? 1.f / l : 0.f;
    store4(o + b * p.o_sb + h * p.o_sh + row * p.o_ss + c,
           make_float4(acc.x * inv, acc.y * inv, acc.z * inv, acc.w * inv));
    if (p.lse != nullptr && c == 0)
      p.lse[static_cast<long long>(bh) * p.Sq + row] =
          l > 0.f ? (m + log2f(l)) * 0.69314718055994531f : -INFINITY;
  }
}

// Launch the combine of `tiles` split query tiles of each of B*H heads;
// returns the launch's CUDA error.
template <typename T>
int combine(const CombineParams& p, T* o, int tiles, int BH,
            cudaStream_t stream) {
  if (tiles <= 0) return 0;
  if (p.d % 4 != 0 || p.d > 128 || p.block_m % ROWS != 0 || BH > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(tiles * (p.block_m / ROWS), BH);
  combine_kernel<T><<<grid, THREADS, 0, stream>>>(p, o);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace split
