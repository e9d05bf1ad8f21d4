// Flash-attention forward for the H100 (sm_90a): non-causal softmax
// attention with an online softmax, plus the per-row logsumexp
// L = m + log(max(l, 1e-30)) that the backward reuses.
//
// Replaces the Pallas TPU kernel `_flash_kernel`
// (mlops_tpu/ops/attention.py:71, launched by `_flash_forward` :145).
// The TPU wrapper folds heads into [B*H, S, D] and pads S up to a block
// multiple before the call; here the kernel reads the strided [B, S, H, D]
// views of the qkv projection as they are (any batch, sequence and head
// strides, the head dimension contiguous) and masks the ragged key edge
// itself, so neither copy is made.
//
// Bound on this card. At the doc model's shape (B*H = 2048, S = 508,
// D = 32, bf16) the kernel moves ~270 MB (81 us at 3.35 TB/s), does
// 4*B*H*S^2*D = 67.6 GFLOP of products (68 us at 989 TFLOP/s) and
// B*H*S^2 = 528 M exponentials (126 us at 16 per SM per clock). The
// exponentials decide, so the design spends as few issue slots as it can
// on anything else:
//
// - bf16: a block owns 128 query rows of one (b, h): two warpgroups of
//   64 rows. Q is loaded once and 128-key tiles of K and V stream through
//   a three-stage shared-memory ring by TMA (cp.async.bulk.tensor over the
//   strided 4-d views; keys past S_kv arrive zero-filled). Each stage has
//   an mbarrier that counts the bytes landing; the last of the block's
//   eight warps to finish with a stage (a shared counter) issues its
//   refill, so the next tile's copy is in flight while this one computes,
//   the key loop has no __syncthreads, and no warp is set aside for loads
//   (its registers would cost the second block per SM). Rows are swizzled
//   at their own width (32, 64 or 128 bytes for D = 16, 32, 64), the
//   layout both TMA and wgmma read (hopper.cuh `Tile`): D = 8 runs as
//   D = 16 on columns that TMA zero-fills past the view's 8, and D = 128
//   as two 64-column panels (a 256-byte row is wider than the swizzle);
//   its three stages of 128-key K and V tiles and Q take 225 KB of the
//   227 KB a block may hold, and its 64 + 64 f32 accumulators per thread
//   leave one block per SM.
//   S = Q K^T is one wgmma.m64n128k16 per 16 of D with both operands in
//   shared memory; the softmax runs on the f32 accumulator in registers
//   (row max on raw scores, p = ex2(fma(s, scale*log2e, -m*scale*log2e)):
//   one FFMA and one MUFU op per score; the key mask only in the tile that
//   crosses S_kv); l sums the f32 p, as the TPU kernel does, while P is
//   rounded to bf16 and re-packed in registers as the A operand of
//   O += P V, eight wgmma.m64n{D}k16 with V read from shared memory as
//   an MN-major operand. Two blocks share an SM (D <= 32), so one block's
//   exponentials run under the other's tensor-core work and copies.
// - f32: a plain one-row-per-thread kernel with f32 FMAs and expf/logf
//   (no TF32), because f32 callers expect f32 accuracy. At D = 128 a row's
//   q and accumulator would not fit one thread's registers, so four
//   neighbouring lanes share the row, each holding every fourth column,
//   and add their partial scores by two shuffles.
//
// Plain C interface (ctypes); launches on the caller's stream, allocates
// nothing, and returns cudaGetLastError() after the launch. The TMA
// tensor maps are encoded on the host by cuTensorMapEncodeTiled, looked
// up through the runtime, so nothing links libcuda.

#include <math.h>

#include "hopper.cuh"

namespace {

// ------------------------------------------------------------------ bf16
constexpr int kGroups = 2;                     // warpgroups of 64 query rows
constexpr int kBlockQ = 64 * kGroups;          // query rows per block
constexpr int kBlockK = 128;                   // keys per ring stage
constexpr int kStages = 3;
constexpr int kThreads = kGroups * 128;
constexpr int kWarps = kThreads / 32;

// D (64 x 128, f32) (+)= A (64 x 16, shared, K-major) * B (16 x 128, shared,
// K-major); accumulate = 0 overwrites D.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t a,
                                               uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(accumulate));
}

// Shared memory of one block, in bytes from a 1024-aligned base: Q, then
// per stage a K and a V tile, then the mbarriers and the per-stage count
// of warps done with it.
template <int D>
struct FwdSmem {
  static constexpr int kRow = Tile<D>::kRow;         // bytes per panel row
  static constexpr int kTile = Tile<D>::bytes(kBlockK);  // a 128-row tile
  static constexpr int kQPanel = kBlockQ * kRow;     // panel strides
  static constexpr int kKPanel = kBlockK * kRow;
  static constexpr int kQ = 0;
  static constexpr int kK = kTile;                  // + stage * 2 * kTile
  static constexpr int kV = 2 * kTile;              // + stage * 2 * kTile
  static constexpr int kBars = kTile + kStages * 2 * kTile;
  static constexpr int kDone = kBars + 8 * (1 + kStages);
  static constexpr int kBytes = kDone + 4 * kStages + 1024;
  static_assert(kBytes <= 232448, "a block's shared memory");
};

template <int D>
__global__ void __launch_bounds__(kThreads, D <= 32 ? 2 : 1)
    flash_fwd_bf16(const __grid_constant__ CUtensorMap tq,
                   const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv,
                   __nv_bfloat16* __restrict__ out, float* __restrict__ lse,
                   Strides so, int heads, int s_q, int s_kv, float scale_log2) {
  using L = FwdSmem<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + L::kBars);
  uint64_t* full = q_full + 1;  // [kStages]: K and V of a tile landed
  unsigned* done = reinterpret_cast<unsigned*>(smem + L::kDone);  // [kStages]

  const int bh = blockIdx.x;
  const int b = bh / heads, h = bh % heads;
  const int q0 = blockIdx.y * kBlockQ;
  const int n_tiles = (s_kv + kBlockK - 1) / kBlockK;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  // Tile t's K and V land in stage t % kStages. Thread 0 starts Q and the
  // first kStages tiles; after that, the last warp to finish with a stage
  // refills it (no warp waits for the others, and none is spent on
  // loads).
  const CUtensorMap* tkp = &tk;
  const CUtensorMap* tvp = &tv;
  auto load_tile = [=](int t) {
    const int s = t % kStages;
    mbar_arrive_tx(&full[s], 2 * L::kTile);
    tma_tile<D>(smem + L::kK + s * 2 * L::kTile, tkp, &full[s], kBlockK, h,
                t * kBlockK, b);
    tma_tile<D>(smem + L::kV + s * 2 * L::kTile, tvp, &full[s], kBlockK, h,
                t * kBlockK, b);
  };
  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      done[s] = 0;
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    mbar_arrive_tx(q_full, L::kTile);
    tma_tile<D>(smem + L::kQ, &tq, q_full, kBlockQ, h, q0, b);
    for (int t = 0; t < kStages && t < n_tiles; ++t) load_tile(t);
  }
  __syncthreads();

  // A warpgroup owns 64 query rows. Each thread holds rows g and
  // g + 8 of its warp's 16, at columns 8j + 2c and 8j + 2c + 1.
  const int wg = warp / 4;
  const int g = lane / 4, c = lane % 4;
  const uint64_t q_desc =
      smem_desc<L::kRow>(smem + L::kQ + wg * 64 * L::kRow);

  constexpr int N = Tile<D>::kCols;  // columns of O (D = 8: 8 stay zero)
  float o[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) o[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};  // running max of the raw scores
  float l[2] = {0.f, 0.f};              // this lane's share of the normalizer

  mbar_wait(q_full, 0);
  for (int t = 0; t < n_tiles; ++t) {
    const int s = t % kStages;
    mbar_wait(&full[s], (t / kStages) & 1);
    const uint8_t* ks = smem + L::kK + s * 2 * L::kTile;
    const uint8_t* vs = smem + L::kV + s * 2 * L::kTile;

    // S = Q K^T: 64 rows x 128 keys, f32 in registers.
    float sc[kBlockK / 2];
    const uint64_t k_desc = smem_desc<L::kRow>(ks);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < N / 16; ++kk) {
      // 16 more of D is 32 bytes further along each row (or the next panel).
      wgmma_ss_n128(sc, kmajor_step<D>(q_desc, kk, L::kQPanel),
                    kmajor_step<D>(k_desc, kk, L::kKPanel), kk);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(sc);

    // Only the tile that crosses s_kv has keys to mask (they arrived as
    // zero rows and scored 0, not -inf).
    if (t * kBlockK + kBlockK > s_kv) {
#pragma unroll
      for (int i = 0; i < kBlockK / 2; ++i) {
        const int key = t * kBlockK + (i / 4) * 8 + 2 * c + (i & 1);
        if (key >= s_kv) sc[i] = -INFINITY;
      }
    }

    // Row max of the raw scores (the scale is positive), over the four
    // lanes that share a row; rescale l and o once per row.
    float neg_m2[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = m[r];
#pragma unroll
      for (int j = 0; j < kBlockK / 8; ++j) {
        mx = fmaxf(mx, fmaxf(sc[4 * j + 2 * r], sc[4 * j + 2 * r + 1]));
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      // Every tile holds a key below s_kv, so mx is finite, and the first
      // tile's alpha is exp2(-inf) = 0.
      const float alpha = fast_exp2((m[r] - mx) * scale_log2);
      m[r] = mx;
      neg_m2[r] = -mx * scale_log2;
      l[r] *= alpha;
#pragma unroll
      for (int j = 0; j < N / 8; ++j) {
        o[4 * j + 2 * r] *= alpha;
        o[4 * j + 2 * r + 1] *= alpha;
      }
    }

    // P = exp2(s * scale_log2 - m * scale_log2): summed into l in f32,
    // packed to bf16 as the A operand of P V (the accumulator's layout of
    // two 8-key column blocks is the A layout of one 16-key step).
    uint32_t pa[kBlockK / 16][4];
#pragma unroll
    for (int j = 0; j < kBlockK / 8; ++j) {
      const float p0 = fast_exp2(fmaf(sc[4 * j], scale_log2, neg_m2[0]));
      const float p1 = fast_exp2(fmaf(sc[4 * j + 1], scale_log2, neg_m2[0]));
      const float p2 = fast_exp2(fmaf(sc[4 * j + 2], scale_log2, neg_m2[1]));
      const float p3 = fast_exp2(fmaf(sc[4 * j + 3], scale_log2, neg_m2[1]));
      l[0] += p0 + p1;
      l[1] += p2 + p3;
      pa[j / 2][(j % 2) * 2] = pack_bf16(p0, p1);
      pa[j / 2][(j % 2) * 2 + 1] = pack_bf16(p2, p3);
    }

    // O += P V: V's 16-key steps are 16 rows further down the tile.
    fence_regs(o);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBlockK / 16; ++kk) {
      wgmma_rs<N>(o, pa[kk], mnmajor_step<D>(vs, kk, L::kKPanel));
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(o);
    // This warp is done with the stage; the last of the block's warps to
    // be done refills it with tile t + kStages.
    if (t + kStages < n_tiles) {
      __syncwarp();
      if (lane == 0 && stage_done(&done[s]) % kWarps == kWarps - 1) {
        load_tile(t + kStages);
      }
    }
  }

  const float ln2 = 0.69314718055994531f;
  const int row0 = q0 + wg * 64 + (warp % 4) * 16 + g;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int row = row0 + r * 8;
    if (row < s_q) {  // rows past s_q were computed on zero-filled q
      __nv_bfloat16* op = out + b * so.b + row * so.s + h * so.h;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        *reinterpret_cast<uint32_t*>(op + j * 8 + c * 2) =
            pack_bf16(o[4 * j + 2 * r] / l[r], o[4 * j + 2 * r + 1] / l[r]);
      }
      if (c == 0) {
        lse[static_cast<long long>(bh) * s_q + row] =
            m[r] * scale_log2 * ln2 + logf(fmaxf(l[r], 1e-30f));
      }
    }
  }
}

// ------------------------------------------------------------------- f32
constexpr int kRowsF32 = 128;  // one query row per thread
constexpr int kKeysF32 = 16;   // keys per shared-memory tile

// Lanes that share a query row in the f32 kernels: four at D = 128 (each
// holds columns part, part + 4, ...: the lanes' shared loads fall in four
// banks), one below.
template <int D>
constexpr int kLanesPerRow = D > 64 ? 4 : 1;

// The sum of a row's partial value over the lanes that share it.
template <int P>
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int off = 1; off < P; off <<= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <int D>
__global__ void __launch_bounds__(kRowsF32)
    flash_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, float* __restrict__ out,
                  float* __restrict__ lse, Strides sq, Strides sk, Strides sv,
                  Strides so, int heads, int s_q, int s_kv, float scale) {
  constexpr int P = kLanesPerRow<D>, W = D / P;  // lanes, columns per lane
  __shared__ __align__(16) float ks[kKeysF32 * D];
  __shared__ __align__(16) float vs[kKeysF32 * D];

  const int bh = blockIdx.x;
  const int b = bh / heads, h = bh % heads;
  const int part = threadIdx.x % P;
  const int row = blockIdx.y * (kRowsF32 / P) + threadIdx.x / P;
  const bool live = row < s_q;
  const float* kb = k + b * sk.b + h * sk.h;
  const float* vb = v + b * sv.b + h * sv.h;

  float qr[W], acc[W];
#pragma unroll
  for (int d = 0; d < W; ++d) {
    qr[d] = live ? q[b * sq.b + row * sq.s + h * sq.h + d * P + part] : 0.f;
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
      for (int d = 0; d < W; ++d) dot = fmaf(qr[d], ks[j * D + d * P + part], dot);
      dot = row_sum<P>(dot);
      sc[j] = j < valid ? dot * scale : -INFINITY;
      mx = fmaxf(mx, sc[j]);
    }
    const float m_new = fmaxf(m, mx);
    const float alpha = expf(m - m_new);
    l *= alpha;
#pragma unroll
    for (int d = 0; d < W; ++d) acc[d] *= alpha;
#pragma unroll
    for (int j = 0; j < kKeysF32; ++j) {
      const float p = expf(sc[j] - m_new);
      l += p;
#pragma unroll
      for (int d = 0; d < W; ++d) acc[d] = fmaf(p, vs[j * D + d * P + part], acc[d]);
    }
    m = m_new;
  }

  if (live) {
    float* op = out + b * so.b + row * so.s + h * so.h;
#pragma unroll
    for (int d = 0; d < W; ++d) op[d * P + part] = acc[d] / l;
    if (part == 0) {
      lse[static_cast<long long>(bh) * s_q + row] = m + logf(fmaxf(l, 1e-30f));
    }
  }
}

// ------------------------------------------------------------------ host
template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   float* lse, Strides sq, Strides sk, Strides sv, Strides so,
                   int batch, int heads, int s_q, int s_kv, int dtype,
                   float scale, cudaStream_t stream) {
  const unsigned bh = static_cast<unsigned>(batch) * heads;
  if (dtype == 1) {
    CUtensorMap tq, tk, tv;
    if (!tensor_map(&tq, q, sq, batch, s_q, heads, D, kBlockQ) ||
        !tensor_map(&tk, k, sk, batch, s_kv, heads, D, kBlockK) ||
        !tensor_map(&tv, v, sv, batch, s_kv, heads, D, kBlockK)) {
      return cudaErrorInvalidValue;
    }
    constexpr int kSmem = FwdSmem<D>::kBytes;
    static std::atomic<unsigned long long> smem_allowed{0};
    const cudaError_t err = allow_dynamic_smem(flash_fwd_bf16<D>, kSmem, smem_allowed);
    if (err != cudaSuccess) return err;
    const dim3 grid(bh, (s_q + kBlockQ - 1) / kBlockQ);
    flash_fwd_bf16<D><<<grid, kThreads, kSmem, stream>>>(
        tq, tk, tv, static_cast<__nv_bfloat16*>(out), lse, so, heads, s_q, s_kv,
        static_cast<float>(scale * 1.4426950408889634));
  } else {
    constexpr int rows = kRowsF32 / kLanesPerRow<D>;
    const dim3 grid(bh, (s_q + rows - 1) / rows);
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
    case 8:
      return static_cast<int>(launch<8>(q, k, v, out, lse, sq, sk, sv, so, batch,
                                        heads, s_q, s_kv, dtype, scale, st));
    case 16:
      return static_cast<int>(launch<16>(q, k, v, out, lse, sq, sk, sv, so, batch,
                                         heads, s_q, s_kv, dtype, scale, st));
    case 32:
      return static_cast<int>(launch<32>(q, k, v, out, lse, sq, sk, sv, so, batch,
                                         heads, s_q, s_kv, dtype, scale, st));
    case 64:
      return static_cast<int>(launch<64>(q, k, v, out, lse, sq, sk, sv, so, batch,
                                         heads, s_q, s_kv, dtype, scale, st));
    case 128:
      return static_cast<int>(launch<128>(q, k, v, out, lse, sq, sk, sv, so, batch,
                                          heads, s_q, s_kv, dtype, scale, st));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
