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
// dk and dv the same way, and mask the ragged edges themselves: queries
// past S_q get p = 0, and lse/delta are never read past S_q (the TPU
// kernel relied on its zero-padded dO and delta instead).
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
// - dk/dv, bf16: a block owns 128 key rows of one (b, h): two warpgroups
//   of 64 keys. K and V are loaded once by TMA, and 64-query tiles of q
//   and dO stream through a three-stage shared-memory ring
//   (cp.async.bulk.tensor over the strided views, zero-filled past S_q),
//   with the tile's lse (in log2 units, negated) and delta (times -scale)
//   stored beside them by the 32 lanes of the warp that loads the tile; a
//   query past S_q gets lse = +inf, so its p = exp2(-inf) = 0 with no
//   compare in the loop. Each stage has an mbarrier for the bytes and
//   lanes landing; the last of the block's eight warps to finish with a
//   stage (a shared counter) refills it, so the query loop has no
//   __syncthreads and no warp is set aside for loads. All four products are
//   wgmma: S^T = K Q^T and dP^T = V dO^T (m64n64k16, both operands in
//   shared memory, K-major), then dV += P^T dO and dK += dS^T Q
//   (m64n{D}k16, A from registers, q and dO read as MN-major operands).
//   p and dS^T are formed in f32 in registers and re-packed as the A
//   fragments; rounding follows the TPU kernel: P^T to dO's type
//   (attention.py:283-286), dS^T to q's type (:291-294); dk and dv
//   accumulate in f32 and are stored once. Key rows past S_kv (zero rows
//   of K and V) feed only their own, never stored, rows of dk and dv. Two
//   blocks share an SM (D <= 32), so one block's exponentials run under
//   the other's tensor-core work and copies.
// - dq, bf16: the same machinery turned round for query-owned rows. A
//   block owns 128 query rows of one (b, h): two warpgroups of 64. Q and
//   dO are loaded once by TMA (zero-filled past S_q); each thread keeps
//   its two rows' lse (log2 units, negated) and delta (times -scale) in
//   registers, read only for rows below S_q. 64-key tiles of K and V
//   stream through a four-stage TMA ring refilled by the last warp done
//   with a stage, as above. S = Q K^T and dP = dO V^T are wgmma.m64n64k16
//   with both operands in shared memory, K-major, committed as two
//   groups: p = exp2(...) is formed from S while dP's product still runs,
//   then dS = p (dp - delta) scale, all in f32 registers (keys past S_kv
//   masked on the tile that crosses it only: TMA zero-fills K there, which
//   would score 0, not -inf). dS is rounded to k's type (attention.py:237-239)
//   and re-packed as the register A operand of dq += dS K, with K read
//   again as an MN-major operand (the forward's P V form). dq accumulates
//   in f32 and is stored once: no atomics, the same bits every launch.
//   64-key tiles keep S and dP at 32 f32 registers each per thread, so
//   two blocks share an SM (D <= 32) and one block's exponentials run
//   under the other's products.
// - Head dims (hopper.cuh `Tile`): D = 8 runs as D = 16 on columns that
//   TMA zero-fills past the view's 8; D = 128 holds each tile as two
//   64-column panels, with one block per SM (dq: 192 KB of shared memory
//   and 64 f32 accumulators per thread; dk/dv: 165 KB and 128).
// - f32: plain one-row-per-thread kernels with f32 FMAs and expf (no
//   TF32), because f32 callers expect f32 accuracy. At D = 128 a row's
//   vectors would not fit one thread's registers, so four neighbouring
//   lanes share the row, each holding every fourth column, and add their
//   partial dot products by two shuffles.
//
// Plain C interface (ctypes); launches on the caller's stream, allocates
// nothing, and returns cudaGetLastError() after the launch. The TMA
// tensor maps are encoded on the host by cuTensorMapEncodeTiled, looked
// up through the runtime, so nothing links libcuda.

#include <math.h>

#include "hopper.cuh"

namespace {

constexpr float kLog2e = 1.4426950408889634f;

// ------------------------------------------------------------------ bf16
// D (64 x 64, f32) (+)= A (64 x 16, shared, K-major) * B (16 x 64, shared,
// K-major); accumulate = 0 overwrites D.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t a,
                                               uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(accumulate));
}

// dq = scale * sum_j p_ij (dp_ij - delta_i) k_j for 128 query rows of one
// (b, h); grid (B*H, ceil(S_q / 128)). The loop over key tiles stands in
// for the TPU's sequential kv-block grid axis.
constexpr int kDqGroups = 2;                   // warpgroups of 64 queries
constexpr int kDqRows = 64 * kDqGroups;        // query rows per block
constexpr int kDqTile = 64;                    // keys per ring stage
constexpr int kDqStages = 4;
constexpr int kDqThreads = kDqGroups * 128;
constexpr int kDqWarps = kDqThreads / 32;

// Shared memory of one dq block, in bytes from a 1024-aligned base: Q and
// dO (128 rows each), then per stage a K and a V tile (64 rows each),
// then the mbarriers and the per-stage count of warps done with it.
template <int D>
struct DqSmem {
  static constexpr int kRow = Tile<D>::kRow;         // bytes per panel row
  static constexpr int kRows = Tile<D>::bytes(kDqRows);  // Q or dO
  static constexpr int kTile = Tile<D>::bytes(kDqTile);  // a K or V tile
  static constexpr int kRowsPanel = kDqRows * kRow;  // panel strides
  static constexpr int kTilePanel = kDqTile * kRow;
  static constexpr int kQ = 0;
  static constexpr int kDo = kRows;
  static constexpr int kRing = 2 * kRows;
  static constexpr int kStage = 2 * kTile;
  static constexpr int kK = 0;                       // within a stage
  static constexpr int kV = kTile;
  static constexpr int kBars = kRing + kDqStages * kStage;
  static constexpr int kDone = kBars + 8 * (1 + kDqStages);
  static constexpr int kBytes = kDone + 4 * kDqStages + 1024;
  static_assert(kBytes <= 232448, "a block's shared memory");
};

template <int D>
__global__ void __launch_bounds__(kDqThreads, D <= 32 ? 2 : 1)
    flash_bwd_dq_bf16(const __grid_constant__ CUtensorMap tq,
                      const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv,
                      const __grid_constant__ CUtensorMap tdo,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta,
                      __nv_bfloat16* __restrict__ dq, Strides sdq, int heads,
                      int s_q, int s_kv, float scale) {
  using L = DqSmem<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* qdo_full = reinterpret_cast<uint64_t*>(smem + L::kBars);
  uint64_t* full = qdo_full + 1;  // [kDqStages]: K and V of a tile landed
  unsigned* done = reinterpret_cast<unsigned*>(smem + L::kDone);  // [kDqStages]

  const int bh = blockIdx.x;
  const int b = bh / heads, h = bh % heads;
  const int q0 = blockIdx.y * kDqRows;
  const int n_tiles = (s_kv + kDqTile - 1) / kDqTile;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  // Key tile t's K and V land in stage t % kDqStages. Thread 0 starts Q,
  // dO and the first kDqStages tiles; after that the last of the block's
  // warps to finish with a stage refills it, so no warp is set aside for
  // loads.
  const CUtensorMap* tkp = &tk;
  const CUtensorMap* tvp = &tv;
  auto load_tile = [=](int t) {
    const int s = t % kDqStages;
    uint8_t* stage = smem + L::kRing + s * L::kStage;
    mbar_arrive_tx(&full[s], 2 * L::kTile);
    tma_tile<D>(stage + L::kK, tkp, &full[s], kDqTile, h, t * kDqTile, b);
    tma_tile<D>(stage + L::kV, tvp, &full[s], kDqTile, h, t * kDqTile, b);
  };
  if (threadIdx.x == 0) {
    mbar_init(qdo_full, 1);
    for (int s = 0; s < kDqStages; ++s) {
      mbar_init(&full[s], 1);
      done[s] = 0;
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    mbar_arrive_tx(qdo_full, 2 * L::kRows);
    tma_tile<D>(smem + L::kQ, &tq, qdo_full, kDqRows, h, q0, b);
    tma_tile<D>(smem + L::kDo, &tdo, qdo_full, kDqRows, h, q0, b);
    for (int t = 0; t < kDqStages && t < n_tiles; ++t) load_tile(t);
  }
  __syncthreads();

  // A warpgroup owns 64 query rows. Each thread holds rows g and g + 8
  // of its warp's 16, at key columns 8j + 2c and 8j + 2c + 1; their
  // -lse*log2(e) and -delta*scale live in registers (rows past s_q read
  // neither: their q and dO arrive as zeros and they are not stored).
  const int wg = warp / 4;
  const int g = lane / 4, c = lane % 4;
  const int row0 = q0 + wg * 64 + (warp % 4) * 16 + g;
  const uint64_t q_desc = smem_desc<L::kRow>(smem + L::kQ + wg * 64 * L::kRow);
  const uint64_t do_desc = smem_desc<L::kRow>(smem + L::kDo + wg * 64 * L::kRow);
  const float scale2 = scale * kLog2e;
  float nl2[2], ndl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + r * 8;
    const long long at = static_cast<long long>(bh) * s_q + row;
    nl2[r] = row < s_q ? -lse[at] * kLog2e : 0.f;
    ndl[r] = row < s_q ? -delta[at] * scale : 0.f;
  }

  constexpr int N = Tile<D>::kCols;  // columns of dq (D = 8: 8 stay zero)
  float acc[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) acc[i] = 0.f;

  mbar_wait(qdo_full, 0);
  for (int t = 0; t < n_tiles; ++t) {
    const int s = t % kDqStages;
    mbar_wait(&full[s], (t / kDqStages) & 1);
    const uint8_t* stage = smem + L::kRing + s * L::kStage;
    const uint64_t k_desc = smem_desc<L::kRow>(stage + L::kK);
    const uint64_t v_desc = smem_desc<L::kRow>(stage + L::kV);

    // S = Q K^T and dP = dO V^T, 64 queries x 64 keys each, committed as
    // two groups: p is formed from S while dP's product still runs.
    float sc[kDqTile / 2], dp[kDqTile / 2];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < N / 16; ++kk) {
      wgmma_ss_n64(sc, kmajor_step<D>(q_desc, kk, L::kRowsPanel),
                   kmajor_step<D>(k_desc, kk, L::kTilePanel), kk);
    }
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < N / 16; ++kk) {
      wgmma_ss_n64(dp, kmajor_step<D>(do_desc, kk, L::kRowsPanel),
                   kmajor_step<D>(v_desc, kk, L::kTilePanel), kk);
    }
    wgmma_commit();
    wgmma_wait_one();
    fence_regs(sc);

    // Only the tile that crosses s_kv has keys to mask (they arrived as
    // zero rows of K and scored 0, which would give p = exp(-lse)).
    if (t * kDqTile + kDqTile > s_kv) {
#pragma unroll
      for (int i = 0; i < kDqTile / 2; ++i) {
        const int key = t * kDqTile + (i / 4) * 8 + 2 * c + (i & 1);
        if (key >= s_kv) sc[i] = -INFINITY;
      }
    }
    // p = exp2(s * scale * log2e - lse * log2e), in place.
#pragma unroll
    for (int i = 0; i < kDqTile / 2; ++i) {
      sc[i] = fast_exp2(fmaf(sc[i], scale2, nl2[(i / 2) & 1]));
    }
    wgmma_wait_all();
    fence_regs(dp);

    // dS = p (dp - delta) scale, rounded to k's type (attention.py:237-239)
    // and re-packed in registers as the A fragments of the tile's 16-key
    // steps.
    uint32_t da[kDqTile / 16][4];
#pragma unroll
    for (int j = 0; j < kDqTile / 8; ++j) {
      da[j / 2][(j % 2) * 2] = pack_bf16(sc[4 * j] * fmaf(dp[4 * j], scale, ndl[0]),
                                         sc[4 * j + 1] * fmaf(dp[4 * j + 1], scale, ndl[0]));
      da[j / 2][(j % 2) * 2 + 1] =
          pack_bf16(sc[4 * j + 2] * fmaf(dp[4 * j + 2], scale, ndl[1]),
                    sc[4 * j + 3] * fmaf(dp[4 * j + 3], scale, ndl[1]));
    }

    // dq += dS K: K, the K-major operand of S, is read again as the
    // MN-major one; its 16-key steps are 16 rows further down the tile.
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kDqTile / 16; ++kk) {
      wgmma_rs<N>(acc, da[kk], mnmajor_step<D>(stage + L::kK, kk, L::kTilePanel));
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc);
    // This warp is done with the stage; the last of the block's warps to
    // be done refills it with tile t + kDqStages.
    if (t + kDqStages < n_tiles) {
      __syncwarp();
      if (lane == 0 && stage_done(&done[s]) % kDqWarps == kDqWarps - 1) {
        load_tile(t + kDqStages);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + r * 8;
    if (row < s_q) {
      __nv_bfloat16* out = dq + b * sdq.b + row * sdq.s + h * sdq.h;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        *reinterpret_cast<uint32_t*>(out + j * 8 + c * 2) =
            pack_bf16(acc[4 * j + 2 * r], acc[4 * j + 2 * r + 1]);
      }
    }
  }
}

// dv = sum_i p_ij dO_i and dk = scale * sum_i p_ij (dp_ij - delta_i) q_i
// for 128 key rows of one (b, h); grid (B*H, ceil(S_kv / 128)). The loop
// over query tiles stands in for the TPU's sequential q-block grid axis.
constexpr int kDkvGroups = 2;                        // warpgroups of 64 keys
constexpr int kDkvKeys = 64 * kDkvGroups;            // key rows per block
constexpr int kDkvTile = 64;                         // queries per ring stage
constexpr int kDkvStages = 3;
constexpr int kDkvThreads = kDkvGroups * 128;
constexpr int kDkvWarps = kDkvThreads / 32;

// Shared memory of one dk/dv block, in bytes from a 1024-aligned base: K
// and V (128 rows each), then per stage a q and a dO tile (64 rows each)
// and the tile's -lse*log2(e) and -delta*scale (64 f32 each), then the
// mbarriers and the per-stage count of warps done with it. Stages start
// on 1024-byte boundaries (the swizzle repeat).
template <int D>
struct DkvSmem {
  static constexpr int kRow = Tile<D>::kRow;         // bytes per panel row
  static constexpr int kKV = Tile<D>::bytes(kDkvKeys);   // K or V
  static constexpr int kTile = Tile<D>::bytes(kDkvTile); // a q or dO tile
  static constexpr int kKVPanel = kDkvKeys * kRow;   // panel strides
  static constexpr int kTilePanel = kDkvTile * kRow;
  static constexpr int kK = 0;
  static constexpr int kV = kKV;
  static constexpr int kRing = 2 * kKV;
  static constexpr int kStage = (2 * kTile + 2 * kDkvTile * 4 + 1023) / 1024 * 1024;
  static constexpr int kQ = 0;                       // within a stage
  static constexpr int kDo = kTile;
  static constexpr int kLse = 2 * kTile;
  static constexpr int kDelta = 2 * kTile + kDkvTile * 4;
  static constexpr int kBars = kRing + kDkvStages * kStage;
  static constexpr int kDone = kBars + 8 * (1 + kDkvStages);
  static constexpr int kBytes = kDone + 4 * kDkvStages + 1024;
  static_assert(kBytes <= 232448, "a block's shared memory");
};

template <int D>
__global__ void __launch_bounds__(kDkvThreads, D <= 32 ? 2 : 1)
    flash_bwd_dkv_bf16(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv,
                       const __grid_constant__ CUtensorMap tdo,
                       const float* __restrict__ lse,
                       const float* __restrict__ delta,
                       __nv_bfloat16* __restrict__ dk,
                       __nv_bfloat16* __restrict__ dv, Strides sdk, Strides sdv,
                       int heads, int s_q, int s_kv, float scale) {
  using L = DkvSmem<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(smem + L::kBars);
  uint64_t* full = kv_full + 1;  // [kDkvStages]: a tile and its rows landed
  unsigned* done = reinterpret_cast<unsigned*>(smem + L::kDone);  // [kDkvStages]

  const int bh = blockIdx.x;
  const int b = bh / heads, h = bh % heads;
  const int key0 = blockIdx.y * kDkvKeys;
  const int n_tiles = (s_q + kDkvTile - 1) / kDkvTile;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const float* lse_bh = lse + static_cast<long long>(bh) * s_q;
  const float* delta_bh = delta + static_cast<long long>(bh) * s_q;

  // Query tile t lands in stage t % kDkvStages, loaded by one whole warp:
  // its lanes store the tile's lse and delta rows and arrive, lane 0 with
  // the TMA bytes of q and dO. Warp 0 loads the first kDkvStages tiles;
  // after that the last of the block's warps to finish with a stage
  // refills it, so no warp is set aside for loads.
  const CUtensorMap* tqp = &tq;
  const CUtensorMap* tdop = &tdo;
  auto load_tile = [=](int t) {
    const int s = t % kDkvStages;
    uint8_t* stage = smem + L::kRing + s * L::kStage;
    float* nl2 = reinterpret_cast<float*>(stage + L::kLse);
    float* ndl = reinterpret_cast<float*>(stage + L::kDelta);
    for (int i = lane; i < kDkvTile; i += 32) {
      const int row = t * kDkvTile + i;  // never read lse/delta past s_q
      nl2[i] = row < s_q ? -lse_bh[row] * kLog2e : -INFINITY;
      ndl[i] = row < s_q ? -delta_bh[row] * scale : 0.f;
    }
    if (lane == 0) {
      mbar_arrive_tx(&full[s], 2 * L::kTile);
      tma_tile<D>(stage + L::kQ, tqp, &full[s], kDkvTile, h, t * kDkvTile, b);
      tma_tile<D>(stage + L::kDo, tdop, &full[s], kDkvTile, h, t * kDkvTile, b);
    } else {
      mbar_arrive(&full[s]);
    }
  };

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < kDkvStages; ++s) {
      mbar_init(&full[s], 32);  // a warp's lanes (lane 0 with the bytes)
      done[s] = 0;
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    mbar_arrive_tx(kv_full, 2 * L::kKV);
    tma_tile<D>(smem + L::kK, &tk, kv_full, kDkvKeys, h, key0, b);
    tma_tile<D>(smem + L::kV, &tv, kv_full, kDkvKeys, h, key0, b);
  }
  __syncthreads();
  if (warp == 0) {
    for (int t = 0; t < kDkvStages && t < n_tiles; ++t) load_tile(t);
  }

  // A warpgroup owns 64 key rows. Each thread holds rows g and g + 8
  // of its warp's 16, at query columns 8j + 2c and 8j + 2c + 1.
  const int wg = warp / 4;
  const int g = lane / 4, c = lane % 4;
  const uint64_t k_desc = smem_desc<L::kRow>(smem + L::kK + wg * 64 * L::kRow);
  const uint64_t v_desc = smem_desc<L::kRow>(smem + L::kV + wg * 64 * L::kRow);
  const float scale2 = scale * kLog2e;

  constexpr int N = Tile<D>::kCols;  // columns of dk, dv (D = 8: 8 stay zero)
  float dka[N / 2], dva[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) dka[i] = dva[i] = 0.f;

  mbar_wait(kv_full, 0);
  for (int t = 0; t < n_tiles; ++t) {
    const int s = t % kDkvStages;
    mbar_wait(&full[s], (t / kDkvStages) & 1);
    const uint8_t* stage = smem + L::kRing + s * L::kStage;
    const uint64_t q_desc = smem_desc<L::kRow>(stage + L::kQ);
    const uint64_t do_desc = smem_desc<L::kRow>(stage + L::kDo);
    const float* nl2 = reinterpret_cast<const float*>(stage + L::kLse);
    const float* ndl = reinterpret_cast<const float*>(stage + L::kDelta);

    // S^T = K Q^T and dP^T = V dO^T: 64 keys x 64 queries each.
    float st[kDkvTile / 2], dpt[kDkvTile / 2];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < N / 16; ++kk) {
      wgmma_ss_n64(st, kmajor_step<D>(k_desc, kk, L::kKVPanel),
                   kmajor_step<D>(q_desc, kk, L::kTilePanel), kk);
    }
#pragma unroll
    for (int kk = 0; kk < N / 16; ++kk) {
      wgmma_ss_n64(dpt, kmajor_step<D>(v_desc, kk, L::kKVPanel),
                   kmajor_step<D>(do_desc, kk, L::kTilePanel), kk);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(st);
    fence_regs(dpt);

    // p = exp2(s * scale * log2e - lse * log2e) (0 for queries past
    // s_q), dS^T = p (dp - delta) scale; both re-packed in registers as
    // bf16 A fragments of the 16-query steps of the next two products.
    uint32_t pa[kDkvTile / 16][4], da[kDkvTile / 16][4];
#pragma unroll
    for (int j = 0; j < kDkvTile / 8; ++j) {
      const float2 nl = *reinterpret_cast<const float2*>(nl2 + 8 * j + 2 * c);
      const float2 nd = *reinterpret_cast<const float2*>(ndl + 8 * j + 2 * c);
      const float p0 = fast_exp2(fmaf(st[4 * j], scale2, nl.x));
      const float p1 = fast_exp2(fmaf(st[4 * j + 1], scale2, nl.y));
      const float p2 = fast_exp2(fmaf(st[4 * j + 2], scale2, nl.x));
      const float p3 = fast_exp2(fmaf(st[4 * j + 3], scale2, nl.y));
      pa[j / 2][(j % 2) * 2] = pack_bf16(p0, p1);
      pa[j / 2][(j % 2) * 2 + 1] = pack_bf16(p2, p3);
      da[j / 2][(j % 2) * 2] = pack_bf16(p0 * fmaf(dpt[4 * j], scale, nd.x),
                                         p1 * fmaf(dpt[4 * j + 1], scale, nd.y));
      da[j / 2][(j % 2) * 2 + 1] = pack_bf16(p2 * fmaf(dpt[4 * j + 2], scale, nd.x),
                                             p3 * fmaf(dpt[4 * j + 3], scale, nd.y));
    }

    // dV += P^T dO and dK += dS^T Q: the tiles' 16-query steps are 16
    // rows further down.
    fence_regs(dva);
    fence_regs(dka);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kDkvTile / 16; ++kk) {
      wgmma_rs<N>(dva, pa[kk], mnmajor_step<D>(stage + L::kDo, kk, L::kTilePanel));
    }
#pragma unroll
    for (int kk = 0; kk < kDkvTile / 16; ++kk) {
      wgmma_rs<N>(dka, da[kk], mnmajor_step<D>(stage + L::kQ, kk, L::kTilePanel));
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(dva);
    fence_regs(dka);
    // This warp is done with the stage; the last of the block's warps to
    // be done refills it with tile t + kDkvStages.
    if (t + kDkvStages < n_tiles) {
      __syncwarp();  // every lane's loads of lse and delta come first
      unsigned before = 0;
      if (lane == 0) before = stage_done(&done[s]);
      before = __shfl_sync(0xffffffffu, before, 0);
      if (before % kDkvWarps == kDkvWarps - 1) {
        __syncwarp();  // lane 0's acquire before the lanes' stores
        load_tile(t + kDkvStages);
      }
    }
  }

  const int row0 = key0 + wg * 64 + (warp % 4) * 16 + g;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + r * 8;
    if (row < s_kv) {
      __nv_bfloat16* kp = dk + b * sdk.b + row * sdk.s + h * sdk.h;
      __nv_bfloat16* vp = dv + b * sdv.b + row * sdv.s + h * sdv.h;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        *reinterpret_cast<uint32_t*>(kp + j * 8 + c * 2) =
            pack_bf16(dka[4 * j + 2 * r], dka[4 * j + 2 * r + 1]);
        *reinterpret_cast<uint32_t*>(vp + j * 8 + c * 2) =
            pack_bf16(dva[4 * j + 2 * r], dva[4 * j + 2 * r + 1]);
      }
    }
  }
}

// ------------------------------------------------------------------- f32
constexpr int kRowsF32 = 128;  // threads of a block: one output row each
constexpr int kTileF32 = 16;   // rows of a shared-memory tile

// Lanes that share an output row (four at D = 128, each holding columns
// part, part + 4, ...: the lanes' shared loads fall in four banks).
template <int D>
constexpr int kLanesPerRow = D > 64 ? 4 : 1;

// The sum of a row's partial value over the lanes that share it.
template <int P>
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int off = 1; off < P; off <<= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

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
  constexpr int P = kLanesPerRow<D>, W = D / P;  // lanes, columns per lane
  __shared__ __align__(16) float ks[kTileF32 * D];
  __shared__ __align__(16) float vs[kTileF32 * D];

  const int bh = blockIdx.x;
  const int b = bh / heads, h = bh % heads;
  const int part = threadIdx.x % P;
  const int row = blockIdx.y * (kRowsF32 / P) + threadIdx.x / P;
  const bool on = row < s_q;
  const float* kb = k + b * sk.b + h * sk.h;
  const float* vb = v + b * sv.b + h * sv.h;

  float qr[W], dr[W], acc[W];
#pragma unroll
  for (int d = 0; d < W; ++d) {
    const int col = d * P + part;
    qr[d] = on ? q[b * sq.b + row * sq.s + h * sq.h + col] : 0.f;
    dr[d] = on ? dout[b * sdo.b + row * sdo.s + h * sdo.h + col] : 0.f;
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
      for (int d = 0; d < W; ++d) {
        s = fmaf(qr[d], ks[j * D + d * P + part], s);
        dp = fmaf(dr[d], vs[j * D + d * P + part], dp);
      }
      s = row_sum<P>(s);
      dp = row_sum<P>(dp);
      const float ds = expf(s * scale - l) * (dp - dl) * scale;
#pragma unroll
      for (int d = 0; d < W; ++d) acc[d] = fmaf(ds, ks[j * D + d * P + part], acc[d]);
    }
  }
  if (on) {
    float* out = dq + b * sdq.b + row * sdq.s + h * sdq.h;
#pragma unroll
    for (int d = 0; d < W; ++d) out[d * P + part] = acc[d];
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
  constexpr int P = kLanesPerRow<D>, W = D / P;  // lanes, columns per lane
  __shared__ __align__(16) float qs[kTileF32 * D];
  __shared__ __align__(16) float dos[kTileF32 * D];
  __shared__ float ls[kTileF32];
  __shared__ float dls[kTileF32];

  const int bh = blockIdx.x;
  const int b = bh / heads, h = bh % heads;
  const int part = threadIdx.x % P;
  const int key = blockIdx.y * (kRowsF32 / P) + threadIdx.x / P;
  const bool on = key < s_kv;
  const float* qb = q + b * sq.b + h * sq.h;
  const float* dob = dout + b * sdo.b + h * sdo.h;
  const float* lse_bh = lse + static_cast<long long>(bh) * s_q;
  const float* delta_bh = delta + static_cast<long long>(bh) * s_q;

  float kr[W], vr[W], dka[W], dva[W];
#pragma unroll
  for (int d = 0; d < W; ++d) {
    const int col = d * P + part;
    kr[d] = on ? k[b * sk.b + key * sk.s + h * sk.h + col] : 0.f;
    vr[d] = on ? v[b * sv.b + key * sv.s + h * sv.h + col] : 0.f;
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
      for (int d = 0; d < W; ++d) {
        s = fmaf(kr[d], qs[i * D + d * P + part], s);
        dp = fmaf(vr[d], dos[i * D + d * P + part], dp);
      }
      s = row_sum<P>(s);
      dp = row_sum<P>(dp);
      const float p = expf(s * scale - ls[i]);
      const float ds = p * (dp - dls[i]) * scale;
#pragma unroll
      for (int d = 0; d < W; ++d) {
        dva[d] = fmaf(p, dos[i * D + d * P + part], dva[d]);
        dka[d] = fmaf(ds, qs[i * D + d * P + part], dka[d]);
      }
    }
  }
  if (on) {
    float* dkp = dk + b * sdk.b + key * sdk.s + h * sdk.h;
    float* dvp = dv + b * sdv.b + key * sdv.s + h * sdv.h;
#pragma unroll
    for (int d = 0; d < W; ++d) {
      dkp[d * P + part] = dka[d];
      dvp[d * P + part] = dva[d];
    }
  }
}

// ------------------------------------------------------------------ host
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
    CUtensorMap tq, tk, tv, tdo;
    if (!tensor_map(&tq, a.q, a.sq, a.batch, a.s_q, a.heads, D, kDqRows) ||
        !tensor_map(&tk, a.k, a.sk, a.batch, a.s_kv, a.heads, D, kDqTile) ||
        !tensor_map(&tv, a.v, a.sv, a.batch, a.s_kv, a.heads, D, kDqTile) ||
        !tensor_map(&tdo, a.dout, a.sdo, a.batch, a.s_q, a.heads, D, kDqRows)) {
      return cudaErrorInvalidValue;
    }
    constexpr int kSmem = DqSmem<D>::kBytes;
    static std::atomic<unsigned long long> smem_allowed{0};
    const cudaError_t err =
        allow_dynamic_smem(flash_bwd_dq_bf16<D>, kSmem, smem_allowed);
    if (err != cudaSuccess) return err;
    const dim3 grid(bh, (a.s_q + kDqRows - 1) / kDqRows);
    flash_bwd_dq_bf16<D><<<grid, kDqThreads, kSmem, a.stream>>>(
        tq, tk, tv, tdo, a.lse, a.delta, static_cast<__nv_bfloat16*>(dq), sdq,
        a.heads, a.s_q, a.s_kv, a.scale);
  } else {
    constexpr int rows = kRowsF32 / kLanesPerRow<D>;
    const dim3 grid(bh, (a.s_q + rows - 1) / rows);
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
    CUtensorMap tq, tk, tv, tdo;
    if (!tensor_map(&tq, a.q, a.sq, a.batch, a.s_q, a.heads, D, kDkvTile) ||
        !tensor_map(&tk, a.k, a.sk, a.batch, a.s_kv, a.heads, D, kDkvKeys) ||
        !tensor_map(&tv, a.v, a.sv, a.batch, a.s_kv, a.heads, D, kDkvKeys) ||
        !tensor_map(&tdo, a.dout, a.sdo, a.batch, a.s_q, a.heads, D, kDkvTile)) {
      return cudaErrorInvalidValue;
    }
    constexpr int kSmem = DkvSmem<D>::kBytes;
    static std::atomic<unsigned long long> smem_allowed{0};
    const cudaError_t err =
        allow_dynamic_smem(flash_bwd_dkv_bf16<D>, kSmem, smem_allowed);
    if (err != cudaSuccess) return err;
    const dim3 grid(bh, (a.s_kv + kDkvKeys - 1) / kDkvKeys);
    flash_bwd_dkv_bf16<D><<<grid, kDkvThreads, kSmem, a.stream>>>(
        tq, tk, tv, tdo, a.lse, a.delta, static_cast<__nv_bfloat16*>(dk),
        static_cast<__nv_bfloat16*>(dv), sdk, sdv, a.heads, a.s_q, a.s_kv,
        a.scale);
  } else {
    constexpr int rows = kRowsF32 / kLanesPerRow<D>;
    const dim3 grid(bh, (a.s_kv + rows - 1) / rows);
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
    case 8: return static_cast<int>(launch_dq<8>(a, dq, sdq));
    case 16: return static_cast<int>(launch_dq<16>(a, dq, sdq));
    case 32: return static_cast<int>(launch_dq<32>(a, dq, sdq));
    case 64: return static_cast<int>(launch_dq<64>(a, dq, sdq));
    case 128: return static_cast<int>(launch_dq<128>(a, dq, sdq));
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
    case 8: return static_cast<int>(launch_dkv<8>(a, dk, dv, sdk, sdv));
    case 16: return static_cast<int>(launch_dkv<16>(a, dk, dv, sdk, sdv));
    case 32: return static_cast<int>(launch_dkv<32>(a, dk, dv, sdk, sdv));
    case 64: return static_cast<int>(launch_dkv<64>(a, dk, dv, sdk, sdv));
    case 128: return static_cast<int>(launch_dkv<128>(a, dk, dv, sdk, sdv));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
