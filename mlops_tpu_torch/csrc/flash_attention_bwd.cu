// Flash-attention backward for the H100 (sm_90a): two kernels, dq and
// (dk, dv), that recompute the probabilities p = exp(s - L) from the
// forward's per-row logsumexp L, so the S x S score matrix never reaches
// device memory in the backward either.
//
// Replaces the Pallas TPU kernels `_flash_bwd_dq_kernel`
// (mlops_tpu/ops/attention.py:206) and `_flash_bwd_dkv_kernel` (:247),
// both launched by `_flash_backward` (:302). As there, delta = rowsum(dO *
// O) arrives precomputed ([B*H, S_q] f32, one torch reduction), and the
// split into two kernels stays: dq walks key tiles, dk/dv walk query
// tiles, each block owns its output rows, so there are no atomics and the
// results are the same from run to run. The TPU wrapper folds heads and
// pads S to a block multiple; here both kernels read q, k, v and dO as
// strided [B, S, H, D] views (the head dimension contiguous), write dq,
// dk and dv the same way, and mask the ragged edges themselves: keys past
// S_kv and queries past S_q get p = 0, and lse/delta are never read past
// S_q (the TPU kernel relied on its zero-padded dO and delta instead).
//
// Bound on this card. At the doc model's training shape (B*H = 512,
// S = 508, D = 32, bf16): dq reads q, k, v, dO, lse, delta and writes dq,
// ~85 MB (25 us at 3.35 TB/s); its three products are 6*B*H*S^2*D =
// 25 GFLOP (26 us at 989 TFLOP/s); its B*H*S^2 = 132 M exponentials take
// ~32 us at 16 per SM per clock. dk/dv move ~102 MB (30 us) and do four
// products, 34 GFLOP (34 us), plus the same exponentials. So dq is bound
// by the exponentials, dk/dv by the tensor cores, all three terms within
// 30 % of each other. Design:
//
// - bf16: 4 warps per block, each warp owns 16 rows of its output (64
//   per block) and walks 64-row tiles of the other operands staged in
//   shared memory. Every product is mma.sync.m16n8k16 (bf16 in, f32
//   accumulate). The recomputed score tile and dP = dO V^T stay in
//   registers; p and dS = p (dP - delta) scale are formed there in f32 and
//   re-packed in registers as the bf16 A operand of the next product
//   (dS K for dq; P^T dO and dS^T Q for dk/dv), B fragments coming from
//   ldmatrix.trans. Rounding follows the TPU kernel: dS to k's type for
//   dq (attention.py:237-239), P^T to dO's type for dv (:283-286), dS^T to
//   q's type for dk (:291-294); accumulators f32, stored once in the
//   output's type. Exponentials are ex2.approx on log2-scaled scores.
// - f32: plain one-row-per-thread kernels with f32 FMAs and expf (no
//   TF32), because f32 callers expect f32 accuracy.
//
// A simple kernel that is right: no cp.async / TMA pipeline, no wgmma;
// that is later work (PERF.md).
//
// Plain C interface (ctypes); launches on the caller's stream, allocates
// nothing, and returns cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

struct Strides {
  long long b, s, h;  // in elements; the head dimension is contiguous
};

constexpr float kLog2e = 1.4426950408889634f;

// ------------------------------------------------------------------ bf16
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = kWarps * 16;  // output rows a block owns
constexpr int kTile = 64;           // rows of a shared-memory tile
constexpr int kPad = 8;             // bf16 of row padding: conflict-free
constexpr int kTilesS = kTile / 8;  // n-tiles of a 16 x kTile score tile
constexpr int kStepsP = kTile / 16;  // k-steps of a product over a tile

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// D (16x8, f32) += A (16x16, bf16, row-major) * B (16x8, bf16, col-major).
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two 8x8 b16 matrices from shared memory, transposed into the B-operand
// layout: lanes 0-7 address the rows of the first, lanes 8-15 the second.
__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t& r0, uint32_t& r1,
                                                  const void* smem) {
  uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r0), "=r"(r1)
               : "r"(addr));
}

// A fragments of a warp's 16 rows (from r0) of one head of a [B,S,H,D]
// view; rows at or past n read as 0.
template <int D>
__device__ __forceinline__ void load_a(uint32_t (&a)[D / 16][4],
                                       const __nv_bfloat16* base,
                                       long long row_stride, int r0, int g,
                                       int c, int n) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = r0 + g + (i & 1) * 8;
      const int col = kk * 16 + (i >> 1) * 8 + c * 2;
      a[kk][i] = row < n ? *reinterpret_cast<const uint32_t*>(
                               base + row * row_stride + col)
                         : 0u;
    }
  }
}

// Stage rows [r0, r0 + kTile) of one head of two [B,S,H,D] views into
// shared memory, 16 bytes per thread and step; rows at or past n are 0.
template <int D>
__device__ __forceinline__ void stage_pair(__nv_bfloat16* xs,
                                           __nv_bfloat16* ys,
                                           const __nv_bfloat16* xb,
                                           long long x_stride,
                                           const __nv_bfloat16* yb,
                                           long long y_stride, int r0, int n) {
  constexpr int kRow = D + kPad;
  constexpr int kVec = 8;  // bf16 per 16-byte vector
  for (int i = threadIdx.x; i < kTile * D / kVec; i += kThreads) {
    const int r = i / (D / kVec), col = (i % (D / kVec)) * kVec;
    const int row = r0 + r;
    uint4 xv = make_uint4(0, 0, 0, 0), yv = make_uint4(0, 0, 0, 0);
    if (row < n) {
      xv = *reinterpret_cast<const uint4*>(xb + row * x_stride + col);
      yv = *reinterpret_cast<const uint4*>(yb + row * y_stride + col);
    }
    *reinterpret_cast<uint4*>(xs + r * kRow + col) = xv;
    *reinterpret_cast<uint4*>(ys + r * kRow + col) = yv;
  }
}

// C (16 x kTile) = A (16 x D) * T^T, T the staged tile (kTile x D): the
// tile's rows are the columns of C.
template <int D>
__device__ __forceinline__ void mma_a_tt(float (&cf)[kTilesS][4],
                                         const uint32_t (&a)[D / 16][4],
                                         const __nv_bfloat16* ts, int g,
                                         int c) {
  constexpr int kRow = D + kPad;
#pragma unroll
  for (int j = 0; j < kTilesS; ++j) {
    cf[j][0] = cf[j][1] = cf[j][2] = cf[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const __nv_bfloat16* tp = ts + (j * 8 + g) * kRow + kk * 16 + c * 2;
      mma_bf16(cf[j], a[kk], *reinterpret_cast<const uint32_t*>(tp),
               *reinterpret_cast<const uint32_t*>(tp + 8));
    }
  }
}

// acc (16 x D) += P (16 x kTile, bf16 A fragments) * T (kTile x D), T's B
// fragments through ldmatrix.trans.
template <int D>
__device__ __forceinline__ void mma_p_t(float (&acc)[D / 8][4],
                                        const uint32_t (&pa)[kStepsP][4],
                                        const __nv_bfloat16* ts, int lane) {
  constexpr int kRow = D + kPad;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
#pragma unroll
    for (int kk = 0; kk < kStepsP; ++kk) {
      uint32_t b0, b1;
      ldmatrix_x2_trans(b0, b1, ts + (kk * 16 + lane % 16) * kRow + n * 8);
      mma_bf16(acc[n], pa[kk], b0, b1);
    }
  }
}

// The C fragments of a 16 x kTile f32 tile, rounded to bf16, are the A
// fragments of a product over the tile's columns.
__device__ __forceinline__ void pack_a(uint32_t (&pa)[kStepsP][4],
                                       const float (&x)[kTilesS][4]) {
#pragma unroll
  for (int j = 0; j < kTilesS; ++j) {
    pa[j / 2][(j % 2) * 2] = pack_bf16(x[j][0], x[j][1]);
    pa[j / 2][(j % 2) * 2 + 1] = pack_bf16(x[j][2], x[j][3]);
  }
}

// A warp's 16 x D f32 accumulator as bf16 rows of one head of a [B,S,H,D]
// view; rows at or past n are not stored.
template <int D>
__device__ __forceinline__ void store_rows(__nv_bfloat16* base,
                                           long long row_stride,
                                           const float (&acc)[D / 8][4], int r0,
                                           int g, int c, int n) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + g + r * 8;
    if (row < n) {
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        *reinterpret_cast<uint32_t*>(base + row * row_stride + j * 8 + c * 2) =
            pack_bf16(acc[j][2 * r], acc[j][2 * r + 1]);
      }
    }
  }
}

// dq = scale * sum_j p_ij (dp_ij - delta_i) k_j for 64 query rows of one
// (b, h); grid (B*H, ceil(S_q / 64)).
template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_bf16(const __nv_bfloat16* __restrict__ q,
                      const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v,
                      const __nv_bfloat16* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta,
                      __nv_bfloat16* __restrict__ dq, Strides sq, Strides sk,
                      Strides sv, Strides sdo, Strides sdq, int heads, int s_q,
                      int s_kv, float scale) {
  constexpr int kRow = D + kPad;
  __shared__ __align__(16) __nv_bfloat16 ks[kTile * kRow];
  __shared__ __align__(16) __nv_bfloat16 vs[kTile * kRow];

  const int bh = blockIdx.x;
  const int b = bh / heads, h = bh % heads;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4;  // fragment row (and row + 8)
  const int c = lane % 4;  // fragment column pair
  const int q0 = blockIdx.y * kRows + warp * 16;

  const __nv_bfloat16* kb = k + b * sk.b + h * sk.h;
  const __nv_bfloat16* vb = v + b * sv.b + h * sv.h;
  uint32_t qa[D / 16][4], da[D / 16][4];
  load_a<D>(qa, q + b * sq.b + h * sq.h, sq.s, q0, g, c, s_q);
  load_a<D>(da, dout + b * sdo.b + h * sdo.h, sdo.s, q0, g, c, s_q);

  // Row statistics (lse in log2 units); rows past s_q read none: their q
  // and dO are 0 and they are not stored.
  float lse2[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + g + r * 8;
    const long long at = static_cast<long long>(bh) * s_q + row;
    lse2[r] = row < s_q ? lse[at] * kLog2e : 0.f;
    dl[r] = row < s_q ? delta[at] : 0.f;
  }
  const float scale2 = scale * kLog2e;

  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  for (int k0 = 0; k0 < s_kv; k0 += kTile) {
    __syncthreads();  // every warp is done with the previous tile
    stage_pair<D>(ks, vs, kb, sk.s, vb, sv.s, k0, s_kv);
    __syncthreads();

    float s[kTilesS][4], dp[kTilesS][4];
    mma_a_tt<D>(s, qa, ks, g, c);   // Q K^T
    mma_a_tt<D>(dp, da, vs, g, c);  // dO V^T
#pragma unroll
    for (int j = 0; j < kTilesS; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + j * 8 + c * 2 + (e & 1);
        const int r = e >> 1;
        const float p =
            key < s_kv ? fast_exp2(fmaf(s[j][e], scale2, -lse2[r])) : 0.f;
        s[j][e] = p * (dp[j][e] - dl[r]) * scale;  // dS
      }
    }
    uint32_t pa[kStepsP][4];
    pack_a(pa, s);  // dS rounded to k's type
    mma_p_t<D>(acc, pa, ks, lane);  // dq += dS K
  }
  store_rows<D>(dq + b * sdq.b + h * sdq.h, sdq.s, acc, q0, g, c, s_q);
}

// dv = sum_i p_ij dO_i and dk = scale * sum_i p_ij (dp_ij - delta_i) q_i
// for 64 key rows of one (b, h); grid (B*H, ceil(S_kv / 64)). The loop
// over query tiles stands in for the TPU's sequential q-block grid axis.
template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkv_bf16(const __nv_bfloat16* __restrict__ q,
                       const __nv_bfloat16* __restrict__ k,
                       const __nv_bfloat16* __restrict__ v,
                       const __nv_bfloat16* __restrict__ dout,
                       const float* __restrict__ lse,
                       const float* __restrict__ delta,
                       __nv_bfloat16* __restrict__ dk,
                       __nv_bfloat16* __restrict__ dv, Strides sq, Strides sk,
                       Strides sv, Strides sdo, Strides sdk, Strides sdv,
                       int heads, int s_q, int s_kv, float scale) {
  constexpr int kRow = D + kPad;
  __shared__ __align__(16) __nv_bfloat16 qs[kTile * kRow];
  __shared__ __align__(16) __nv_bfloat16 dos[kTile * kRow];
  __shared__ float ls[kTile];   // lse of the tile's queries, log2 units
  __shared__ float dls[kTile];  // delta of the tile's queries

  const int bh = blockIdx.x;
  const int b = bh / heads, h = bh % heads;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int c = lane % 4;
  const int key0 = blockIdx.y * kRows + warp * 16;

  const __nv_bfloat16* qb = q + b * sq.b + h * sq.h;
  const __nv_bfloat16* dob = dout + b * sdo.b + h * sdo.h;
  uint32_t ka[D / 16][4], va[D / 16][4];
  load_a<D>(ka, k + b * sk.b + h * sk.h, sk.s, key0, g, c, s_kv);
  load_a<D>(va, v + b * sv.b + h * sv.h, sv.s, key0, g, c, s_kv);
  // Key rows past s_kv get p = 0, so their (never stored) dk/dv stay 0.
  const bool live[2] = {key0 + g < s_kv, key0 + g + 8 < s_kv};
  const float scale2 = scale * kLog2e;
  const float* lse_bh = lse + static_cast<long long>(bh) * s_q;
  const float* delta_bh = delta + static_cast<long long>(bh) * s_q;

  float dka[D / 8][4], dva[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    dka[n][0] = dka[n][1] = dka[n][2] = dka[n][3] = 0.f;
    dva[n][0] = dva[n][1] = dva[n][2] = dva[n][3] = 0.f;
  }

  for (int q0 = 0; q0 < s_q; q0 += kTile) {
    __syncthreads();
    stage_pair<D>(qs, dos, qb, sq.s, dob, sdo.s, q0, s_q);
    for (int i = threadIdx.x; i < kTile; i += kThreads) {
      const int row = q0 + i;  // never read lse/delta past s_q
      ls[i] = row < s_q ? lse_bh[row] * kLog2e : 0.f;
      dls[i] = row < s_q ? delta_bh[row] : 0.f;
    }
    __syncthreads();

    float s[kTilesS][4], dp[kTilesS][4];
    mma_a_tt<D>(s, ka, qs, g, c);    // S^T = K Q^T
    mma_a_tt<D>(dp, va, dos, g, c);  // dP^T = V dO^T
#pragma unroll
    for (int j = 0; j < kTilesS; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = j * 8 + c * 2 + (e & 1);
        const bool on = q0 + col < s_q && live[e >> 1];
        const float p = on ? fast_exp2(fmaf(s[j][e], scale2, -ls[col])) : 0.f;
        s[j][e] = p;                                     // P^T
        dp[j][e] = p * (dp[j][e] - dls[col]) * scale;  // dS^T
      }
    }
    uint32_t pa[kStepsP][4];
    pack_a(pa, s);  // P^T rounded to dO's type
    mma_p_t<D>(dva, pa, dos, lane);  // dv += P^T dO
    pack_a(pa, dp);  // dS^T rounded to q's type
    mma_p_t<D>(dka, pa, qs, lane);  // dk += dS^T Q
  }
  store_rows<D>(dk + b * sdk.b + h * sdk.h, sdk.s, dka, key0, g, c, s_kv);
  store_rows<D>(dv + b * sdv.b + h * sdv.h, sdv.s, dva, key0, g, c, s_kv);
}

// ------------------------------------------------------------------- f32
constexpr int kRowsF32 = 128;  // one output row per thread
constexpr int kTileF32 = 16;   // rows of a shared-memory tile

// Stage rows [r0, r0 + kTileF32) of one head of two f32 views.
template <int D>
__device__ __forceinline__ void stage_pair_f32(float* xs, float* ys,
                                               const float* xb,
                                               long long x_stride,
                                               const float* yb,
                                               long long y_stride, int r0,
                                               int n) {
  for (int i = threadIdx.x; i < kTileF32 * D / 4; i += kRowsF32) {
    const int r = i / (D / 4), col = (i % (D / 4)) * 4;
    const int row = r0 + r;
    float4 xv = make_float4(0.f, 0.f, 0.f, 0.f), yv = xv;
    if (row < n) {
      xv = *reinterpret_cast<const float4*>(xb + row * x_stride + col);
      yv = *reinterpret_cast<const float4*>(yb + row * y_stride + col);
    }
    *reinterpret_cast<float4*>(xs + r * D + col) = xv;
    *reinterpret_cast<float4*>(ys + r * D + col) = yv;
  }
}

template <int D>
__global__ void __launch_bounds__(kRowsF32)
    flash_bwd_dq_f32(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v,
                     const float* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, float* __restrict__ dq,
                     Strides sq, Strides sk, Strides sv, Strides sdo,
                     Strides sdq, int heads, int s_q, int s_kv, float scale) {
  __shared__ __align__(16) float ks[kTileF32 * D];
  __shared__ __align__(16) float vs[kTileF32 * D];

  const int bh = blockIdx.x;
  const int b = bh / heads, h = bh % heads;
  const int row = blockIdx.y * kRowsF32 + threadIdx.x;
  const bool on = row < s_q;
  const float* kb = k + b * sk.b + h * sk.h;
  const float* vb = v + b * sv.b + h * sv.h;

  float qr[D], dr[D], acc[D];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    qr[d] = on ? q[b * sq.b + row * sq.s + h * sq.h + d] : 0.f;
    dr[d] = on ? dout[b * sdo.b + row * sdo.s + h * sdo.h + d] : 0.f;
    acc[d] = 0.f;
  }
  const long long at = static_cast<long long>(bh) * s_q + row;
  const float l = on ? lse[at] : 0.f;
  const float dl = on ? delta[at] : 0.f;

  for (int k0 = 0; k0 < s_kv; k0 += kTileF32) {
    __syncthreads();
    stage_pair_f32<D>(ks, vs, kb, sk.s, vb, sv.s, k0, s_kv);
    __syncthreads();
    const int valid = min(kTileF32, s_kv - k0);
    for (int j = 0; j < valid; ++j) {
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d) {
        s = fmaf(qr[d], ks[j * D + d], s);
        dp = fmaf(dr[d], vs[j * D + d], dp);
      }
      const float ds = expf(s * scale - l) * (dp - dl) * scale;
#pragma unroll
      for (int d = 0; d < D; ++d) acc[d] = fmaf(ds, ks[j * D + d], acc[d]);
    }
  }
  if (on) {
    float* out = dq + b * sdq.b + row * sdq.s + h * sdq.h;
#pragma unroll
    for (int d = 0; d < D; ++d) out[d] = acc[d];
  }
}

template <int D>
__global__ void __launch_bounds__(kRowsF32)
    flash_bwd_dkv_f32(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v,
                      const float* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta, float* __restrict__ dk,
                      float* __restrict__ dv, Strides sq, Strides sk,
                      Strides sv, Strides sdo, Strides sdk, Strides sdv,
                      int heads, int s_q, int s_kv, float scale) {
  __shared__ __align__(16) float qs[kTileF32 * D];
  __shared__ __align__(16) float dos[kTileF32 * D];
  __shared__ float ls[kTileF32];
  __shared__ float dls[kTileF32];

  const int bh = blockIdx.x;
  const int b = bh / heads, h = bh % heads;
  const int key = blockIdx.y * kRowsF32 + threadIdx.x;
  const bool on = key < s_kv;
  const float* qb = q + b * sq.b + h * sq.h;
  const float* dob = dout + b * sdo.b + h * sdo.h;
  const float* lse_bh = lse + static_cast<long long>(bh) * s_q;
  const float* delta_bh = delta + static_cast<long long>(bh) * s_q;

  float kr[D], vr[D], dka[D], dva[D];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    kr[d] = on ? k[b * sk.b + key * sk.s + h * sk.h + d] : 0.f;
    vr[d] = on ? v[b * sv.b + key * sv.s + h * sv.h + d] : 0.f;
    dka[d] = dva[d] = 0.f;
  }

  for (int q0 = 0; q0 < s_q; q0 += kTileF32) {
    __syncthreads();
    stage_pair_f32<D>(qs, dos, qb, sq.s, dob, sdo.s, q0, s_q);
    if (threadIdx.x < kTileF32) {
      const int row = q0 + threadIdx.x;  // never read lse/delta past s_q
      ls[threadIdx.x] = row < s_q ? lse_bh[row] : 0.f;
      dls[threadIdx.x] = row < s_q ? delta_bh[row] : 0.f;
    }
    __syncthreads();
    const int valid = min(kTileF32, s_q - q0);
    for (int i = 0; i < valid; ++i) {
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d) {
        s = fmaf(kr[d], qs[i * D + d], s);
        dp = fmaf(vr[d], dos[i * D + d], dp);
      }
      const float p = expf(s * scale - ls[i]);
      const float ds = p * (dp - dls[i]) * scale;
#pragma unroll
      for (int d = 0; d < D; ++d) {
        dva[d] = fmaf(p, dos[i * D + d], dva[d]);
        dka[d] = fmaf(ds, qs[i * D + d], dka[d]);
      }
    }
  }
  if (on) {
    float* dkp = dk + b * sdk.b + key * sdk.s + h * sdk.h;
    float* dvp = dv + b * sdv.b + key * sdv.s + h * sdv.h;
#pragma unroll
    for (int d = 0; d < D; ++d) {
      dkp[d] = dka[d];
      dvp[d] = dva[d];
    }
  }
}

struct Args {
  const void *q, *k, *v, *dout;
  const float *lse, *delta;
  Strides sq, sk, sv, sdo;
  int batch, heads, s_q, s_kv, dtype;
  float scale;
  cudaStream_t stream;
};

template <int D>
cudaError_t launch_dq(const Args& a, void* dq, Strides sdq) {
  const unsigned bh = static_cast<unsigned>(a.batch) * a.heads;
  if (a.dtype == 1) {
    const dim3 grid(bh, (a.s_q + kRows - 1) / kRows);
    flash_bwd_dq_bf16<D><<<grid, kThreads, 0, a.stream>>>(
        static_cast<const __nv_bfloat16*>(a.q),
        static_cast<const __nv_bfloat16*>(a.k),
        static_cast<const __nv_bfloat16*>(a.v),
        static_cast<const __nv_bfloat16*>(a.dout), a.lse, a.delta,
        static_cast<__nv_bfloat16*>(dq), a.sq, a.sk, a.sv, a.sdo, sdq,
        a.heads, a.s_q, a.s_kv, a.scale);
  } else {
    const dim3 grid(bh, (a.s_q + kRowsF32 - 1) / kRowsF32);
    flash_bwd_dq_f32<D><<<grid, kRowsF32, 0, a.stream>>>(
        static_cast<const float*>(a.q), static_cast<const float*>(a.k),
        static_cast<const float*>(a.v), static_cast<const float*>(a.dout),
        a.lse, a.delta, static_cast<float*>(dq), a.sq, a.sk, a.sv, a.sdo, sdq,
        a.heads, a.s_q, a.s_kv, a.scale);
  }
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkv(const Args& a, void* dk, void* dv, Strides sdk,
                       Strides sdv) {
  const unsigned bh = static_cast<unsigned>(a.batch) * a.heads;
  if (a.dtype == 1) {
    const dim3 grid(bh, (a.s_kv + kRows - 1) / kRows);
    flash_bwd_dkv_bf16<D><<<grid, kThreads, 0, a.stream>>>(
        static_cast<const __nv_bfloat16*>(a.q),
        static_cast<const __nv_bfloat16*>(a.k),
        static_cast<const __nv_bfloat16*>(a.v),
        static_cast<const __nv_bfloat16*>(a.dout), a.lse, a.delta,
        static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), a.sq,
        a.sk, a.sv, a.sdo, sdk, sdv, a.heads, a.s_q, a.s_kv, a.scale);
  } else {
    const dim3 grid(bh, (a.s_kv + kRowsF32 - 1) / kRowsF32);
    flash_bwd_dkv_f32<D><<<grid, kRowsF32, 0, a.stream>>>(
        static_cast<const float*>(a.q), static_cast<const float*>(a.k),
        static_cast<const float*>(a.v), static_cast<const float*>(a.dout),
        a.lse, a.delta, static_cast<float*>(dk), static_cast<float*>(dv), a.sq,
        a.sk, a.sv, a.sdo, sdk, sdv, a.heads, a.s_q, a.s_kv, a.scale);
  }
  return cudaGetLastError();
}

bool args_ok(const Args& a) {
  return a.batch >= 1 && a.heads >= 1 && a.s_q >= 1 && a.s_kv >= 1 &&
         (a.dtype == 0 || a.dtype == 1);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Strides are in elements, for the
// batch, sequence and head axes of [B, S, H, D] views whose last axis is
// contiguous; pointers and strides must be 16-byte aligned (the wrapper
// checks). lse and delta are f32 [B*H, S_q], contiguous. dq is
// [B, S_q, H, D] in the input type.
extern "C" int flash_attention_bwd_dq_launch(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, const float* delta, void* dq, long long q_sb,
    long long q_ss, long long q_sh, long long k_sb, long long k_ss,
    long long k_sh, long long v_sb, long long v_ss, long long v_sh,
    long long do_sb, long long do_ss, long long do_sh, long long dq_sb,
    long long dq_ss, long long dq_sh, int batch, int heads, int s_q, int s_kv,
    int head_dim, int dtype, float scale, void* stream) {
  const Args a{q, k, v, dout, lse, delta,
               Strides{q_sb, q_ss, q_sh}, Strides{k_sb, k_ss, k_sh},
               Strides{v_sb, v_ss, v_sh}, Strides{do_sb, do_ss, do_sh},
               batch, heads, s_q, s_kv, dtype, scale,
               static_cast<cudaStream_t>(stream)};
  if (!args_ok(a)) return static_cast<int>(cudaErrorInvalidValue);
  const Strides sdq{dq_sb, dq_ss, dq_sh};
  switch (head_dim) {
    case 16: return static_cast<int>(launch_dq<16>(a, dq, sdq));
    case 32: return static_cast<int>(launch_dq<32>(a, dq, sdq));
    case 64: return static_cast<int>(launch_dq<64>(a, dq, sdq));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// As above; dk and dv are [B, S_kv, H, D] in the input type.
extern "C" int flash_attention_bwd_dkv_launch(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, const float* delta, void* dk, void* dv, long long q_sb,
    long long q_ss, long long q_sh, long long k_sb, long long k_ss,
    long long k_sh, long long v_sb, long long v_ss, long long v_sh,
    long long do_sb, long long do_ss, long long do_sh, long long dk_sb,
    long long dk_ss, long long dk_sh, long long dv_sb, long long dv_ss,
    long long dv_sh, int batch, int heads, int s_q, int s_kv, int head_dim,
    int dtype, float scale, void* stream) {
  const Args a{q, k, v, dout, lse, delta,
               Strides{q_sb, q_ss, q_sh}, Strides{k_sb, k_ss, k_sh},
               Strides{v_sb, v_ss, v_sh}, Strides{do_sb, do_ss, do_sh},
               batch, heads, s_q, s_kv, dtype, scale,
               static_cast<cudaStream_t>(stream)};
  if (!args_ok(a)) return static_cast<int>(cudaErrorInvalidValue);
  const Strides sdk{dk_sb, dk_ss, dk_sh}, sdv{dv_sb, dv_ss, dv_sh};
  switch (head_dim) {
    case 16: return static_cast<int>(launch_dkv<16>(a, dk, dv, sdk, sdv));
    case 32: return static_cast<int>(launch_dkv<32>(a, dk, dv, sdk, sdv));
    case 64: return static_cast<int>(launch_dkv<64>(a, dk, dv, sdk, sdv));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
