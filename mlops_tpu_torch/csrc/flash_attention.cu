// Flash-attention forward for the H100 (sm_90a): non-causal softmax
// attention with an online softmax, plus the per-row logsumexp
// L = m + log(max(l, 1e-30)) that the backward will reuse.
//
// Replaces the Pallas TPU kernel `_flash_kernel`
// (mlops_tpu/ops/attention.py:71, launched by `_flash_forward` :145).
// The TPU wrapper folds heads into [B*H, S, D] and pads S up to a block
// multiple before the call; here the kernel reads the strided [B, S, H, D]
// views of the qkv projection as they are (any batch, sequence and head
// strides, the head dimension contiguous) and masks the ragged key and
// query edges itself, so neither copy is made.
//
// Bound on this card. At the doc model's shape (B*H = 2048, S = 508,
// D = 32, bf16) the kernel moves ~270 MB (81 us at 3.35 TB/s), does
// 4*B*H*S^2*D = 67.6 GFLOP of products (68 us at 989 TFLOP/s) and
// B*H*S^2 = 528 M exponentials (~135 us at 16 per SM per clock). The
// exponentials decide. Design:
//
// - bf16: 4 warps per block, each warp owns 16 query rows (64 per block)
//   and walks 64-key tiles of K and V staged in shared memory. Q K^T and
//   P V run on the tensor cores with mma.sync.m16n8k16 (bf16 in, f32
//   accumulate); the score tile stays in registers and is reused as the
//   A operand of P V, so scores never reach shared or device memory. The
//   running max m, normalizer l and the output accumulator stay in f32
//   registers. P is rounded to bf16 for the P V product, as the TPU
//   kernel casts it to v's type, while l sums it unrounded in f32.
//   Exponentials are ex2.approx on log2-scaled scores: one MUFU op each.
// - f32: a plain one-row-per-thread kernel with f32 FMAs and expf/logf
//   (no TF32), because f32 callers expect f32 accuracy.
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

// ------------------------------------------------------------------ bf16
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kBlockQ = kWarps * 16;  // query rows per block
constexpr int kBlockK = 64;           // keys per shared-memory tile
constexpr int kPad = 8;               // bf16 of row padding: conflict-free

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

template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_bf16(const __nv_bfloat16* __restrict__ q,
                   const __nv_bfloat16* __restrict__ k,
                   const __nv_bfloat16* __restrict__ v,
                   __nv_bfloat16* __restrict__ out, float* __restrict__ lse,
                   Strides sq, Strides sk, Strides sv, Strides so, int heads,
                   int s_q, int s_kv, float scale_log2) {
  constexpr int kSteps = D / 16;     // k-steps of Q K^T
  constexpr int kTilesS = kBlockK / 8;  // n-tiles of a score row
  constexpr int kTilesO = D / 8;     // n-tiles of an output row
  constexpr int kRow = D + kPad;     // shared row of K and V, in bf16
  constexpr int kVec = 8;            // bf16 per 16-byte vector

  __shared__ __align__(16) __nv_bfloat16 ks[kBlockK * kRow];
  __shared__ __align__(16) __nv_bfloat16 vs[kBlockK * kRow];

  const int bh = blockIdx.x;
  const int b = bh / heads, h = bh % heads;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4;  // fragment row (and row + 8)
  const int c = lane % 4;  // fragment column pair
  const int q0 = blockIdx.y * kBlockQ + warp * 16;

  const __nv_bfloat16* qb = q + b * sq.b + h * sq.h;
  const __nv_bfloat16* kb = k + b * sk.b + h * sk.h;
  const __nv_bfloat16* vb = v + b * sv.b + h * sv.h;

  // A fragments of this warp's 16 query rows; rows past s_q read as 0.
  uint32_t qa[kSteps][4];
#pragma unroll
  for (int kk = 0; kk < kSteps; ++kk) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + g + (i & 1) * 8;
      const int col = kk * 16 + (i >> 1) * 8 + c * 2;
      qa[kk][i] = row < s_q
                      ? *reinterpret_cast<const uint32_t*>(qb + row * sq.s + col)
                      : 0u;
    }
  }

  float o[kTilesO][4];
#pragma unroll
  for (int n = 0; n < kTilesO; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};  // running max, log2 units
  float l[2] = {0.f, 0.f};              // this lane's share of the normalizer

  for (int k0 = 0; k0 < s_kv; k0 += kBlockK) {
    __syncthreads();  // every warp is done with the previous tile
    for (int i = threadIdx.x; i < kBlockK * D / kVec; i += kThreads) {
      const int r = i / (D / kVec), col = (i % (D / kVec)) * kVec;
      const int key = k0 + r;
      uint4 kv = make_uint4(0, 0, 0, 0), vv = make_uint4(0, 0, 0, 0);
      if (key < s_kv) {  // keys past s_kv read as 0: p * 0 stays finite
        kv = *reinterpret_cast<const uint4*>(kb + key * sk.s + col);
        vv = *reinterpret_cast<const uint4*>(vb + key * sv.s + col);
      }
      *reinterpret_cast<uint4*>(ks + r * kRow + col) = kv;
      *reinterpret_cast<uint4*>(vs + r * kRow + col) = vv;
    }
    __syncthreads();

    // S = Q K^T on 16 rows x 64 keys, in registers.
    float s[kTilesS][4];
#pragma unroll
    for (int j = 0; j < kTilesS; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kSteps; ++kk) {
        const __nv_bfloat16* kp = ks + (j * 8 + g) * kRow + kk * 16 + c * 2;
        mma_bf16(s[j], qa[kk], *reinterpret_cast<const uint32_t*>(kp),
                 *reinterpret_cast<const uint32_t*>(kp + 8));
      }
    }

    // Scale into log2 units, mask the ragged key edge, take the row max
    // over the four lanes that share a row.
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < kTilesS; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + j * 8 + c * 2 + (e & 1);
        const float x = key < s_kv ? s[j][e] * scale_log2 : -INFINITY;
        s[j][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      // Every tile holds a key below s_kv, so the new max is finite and
      // the first tile's alpha is exp2(-inf) = 0.
      const float m_new = fmaxf(m[r], mx[r]);
      const float alpha = fast_exp2(m[r] - m_new);
      m[r] = m_new;
      l[r] *= alpha;
#pragma unroll
      for (int n = 0; n < kTilesO; ++n) {
        o[n][2 * r] *= alpha;
        o[n][2 * r + 1] *= alpha;
      }
    }

    // P = exp2(S - m): summed into l in f32, packed to bf16 as the A
    // operand of P V (the score tile's C layout is that A layout).
    uint32_t pa[kBlockK / 16][4];
#pragma unroll
    for (int j = 0; j < kTilesS; ++j) {
      const float p0 = fast_exp2(s[j][0] - m[0]);
      const float p1 = fast_exp2(s[j][1] - m[0]);
      const float p2 = fast_exp2(s[j][2] - m[1]);
      const float p3 = fast_exp2(s[j][3] - m[1]);
      l[0] += p0 + p1;
      l[1] += p2 + p3;
      pa[j / 2][(j % 2) * 2] = pack_bf16(p0, p1);
      pa[j / 2][(j % 2) * 2 + 1] = pack_bf16(p2, p3);
    }

    // O += P V, V's B fragments through ldmatrix.trans.
#pragma unroll
    for (int n = 0; n < kTilesO; ++n) {
#pragma unroll
      for (int kk = 0; kk < kBlockK / 16; ++kk) {
        uint32_t b0, b1;
        ldmatrix_x2_trans(b0, b1, vs + (kk * 16 + lane % 16) * kRow + n * 8);
        mma_bf16(o[n], pa[kk], b0, b1);
      }
    }
  }

  const float ln2 = 0.69314718055994531f;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int row = q0 + g + r * 8;
    if (row < s_q) {
      __nv_bfloat16* op = out + b * so.b + row * so.s + h * so.h;
#pragma unroll
      for (int n = 0; n < kTilesO; ++n) {
        *reinterpret_cast<uint32_t*>(op + n * 8 + c * 2) =
            pack_bf16(o[n][2 * r] / l[r], o[n][2 * r + 1] / l[r]);
      }
      if (c == 0) {
        lse[static_cast<long long>(bh) * s_q + row] =
            m[r] * ln2 + logf(fmaxf(l[r], 1e-30f));
      }
    }
  }
}

// ------------------------------------------------------------------- f32
constexpr int kRowsF32 = 128;  // one query row per thread
constexpr int kKeysF32 = 16;   // keys per shared-memory tile

template <int D>
__global__ void __launch_bounds__(kRowsF32)
    flash_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, float* __restrict__ out,
                  float* __restrict__ lse, Strides sq, Strides sk, Strides sv,
                  Strides so, int heads, int s_q, int s_kv, float scale) {
  __shared__ __align__(16) float ks[kKeysF32 * D];
  __shared__ __align__(16) float vs[kKeysF32 * D];

  const int bh = blockIdx.x;
  const int b = bh / heads, h = bh % heads;
  const int row = blockIdx.y * kRowsF32 + threadIdx.x;
  const bool live = row < s_q;
  const float* kb = k + b * sk.b + h * sk.h;
  const float* vb = v + b * sv.b + h * sv.h;

  float qr[D], acc[D];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    qr[d] = live ? q[b * sq.b + row * sq.s + h * sq.h + d] : 0.f;
    acc[d] = 0.f;
  }
  float m = -INFINITY, l = 0.f;

  for (int k0 = 0; k0 < s_kv; k0 += kKeysF32) {
    __syncthreads();
    for (int i = threadIdx.x; i < kKeysF32 * D / 4; i += kRowsF32) {
      const int r = i / (D / 4), col = (i % (D / 4)) * 4;
      const int key = k0 + r;
      float4 kv = make_float4(0.f, 0.f, 0.f, 0.f), vv = kv;
      if (key < s_kv) {
        kv = *reinterpret_cast<const float4*>(kb + key * sk.s + col);
        vv = *reinterpret_cast<const float4*>(vb + key * sv.s + col);
      }
      *reinterpret_cast<float4*>(ks + r * D + col) = kv;
      *reinterpret_cast<float4*>(vs + r * D + col) = vv;
    }
    __syncthreads();

    const int valid = min(kKeysF32, s_kv - k0);
    float sc[kKeysF32];
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < kKeysF32; ++j) {
      float dot = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d) dot = fmaf(qr[d], ks[j * D + d], dot);
      sc[j] = j < valid ? dot * scale : -INFINITY;
      mx = fmaxf(mx, sc[j]);
    }
    const float m_new = fmaxf(m, mx);
    const float alpha = expf(m - m_new);
    l *= alpha;
#pragma unroll
    for (int d = 0; d < D; ++d) acc[d] *= alpha;
#pragma unroll
    for (int j = 0; j < kKeysF32; ++j) {
      const float p = expf(sc[j] - m_new);
      l += p;
#pragma unroll
      for (int d = 0; d < D; ++d) acc[d] = fmaf(p, vs[j * D + d], acc[d]);
    }
    m = m_new;
  }

  if (live) {
    float* op = out + b * so.b + row * so.s + h * so.h;
#pragma unroll
    for (int d = 0; d < D; ++d) op[d] = acc[d] / l;
    lse[static_cast<long long>(bh) * s_q + row] = m + logf(fmaxf(l, 1e-30f));
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   float* lse, Strides sq, Strides sk, Strides sv, Strides so,
                   int batch, int heads, int s_q, int s_kv, int dtype,
                   float scale, cudaStream_t stream) {
  const unsigned bh = static_cast<unsigned>(batch) * heads;
  if (dtype == 1) {
    const dim3 grid(bh, (s_q + kBlockQ - 1) / kBlockQ);
    flash_fwd_bf16<D><<<grid, kThreads, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out),
        lse, sq, sk, sv, so, heads, s_q, s_kv,
        static_cast<float>(scale * 1.4426950408889634));
  } else {
    const dim3 grid(bh, (s_q + kRowsF32 - 1) / kRowsF32);
    flash_fwd_f32<D><<<grid, kRowsF32, 0, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(out), lse, sq, sk,
        sv, so, heads, s_q, s_kv, scale);
  }
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Strides are in elements, for the
// batch, sequence and head axes of [B, S, H, D] views whose last axis is
// contiguous; pointers and strides must be 16-byte aligned (the wrapper
// checks). out is [B, S_q, H, D] in the input type, lse f32 [B*H, S_q].
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* out, float* lse,
    long long q_sb, long long q_ss, long long q_sh, long long k_sb,
    long long k_ss, long long k_sh, long long v_sb, long long v_ss,
    long long v_sh, long long o_sb, long long o_ss, long long o_sh, int batch,
    int heads, int s_q, int s_kv, int head_dim, int dtype, float scale,
    void* stream) {
  if (batch < 1 || heads < 1 || s_q < 1 || s_kv < 1 || (dtype != 0 && dtype != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Strides sq{q_sb, q_ss, q_sh}, sk{k_sb, k_ss, k_sh};
  const Strides sv{v_sb, v_ss, v_sh}, so{o_sb, o_ss, o_sh};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 16:
      return static_cast<int>(launch<16>(q, k, v, out, lse, sq, sk, sv, so, batch,
                                         heads, s_q, s_kv, dtype, scale, st));
    case 32:
      return static_cast<int>(launch<32>(q, k, v, out, lse, sq, sk, sv, so, batch,
                                         heads, s_q, s_kv, dtype, scale, st));
    case 64:
      return static_cast<int>(launch<64>(q, k, v, out, lse, sq, sk, sv, so, batch,
                                         heads, s_q, s_kv, dtype, scale, st));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
