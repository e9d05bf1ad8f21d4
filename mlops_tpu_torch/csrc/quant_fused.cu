// Fused quant-tier predict body for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel mlops_tpu/ops/quant_kernel.py::_fused_kernel
// (body _fused_core). One launch computes, for S request slots of B padded
// rows each:
//   - the int8/bf16 student forward -> sigmoid(logit / T)        preds  [S, B]
//   - Mahalanobis outlier flags, zeroed on padding rows          flags  [S, B]
//   - masked categorical counts per (feature, category)          counts [S, C, K]
//   - the dense masked K-S statistic per numeric feature         ks     [S, M]
// The chi-squared / Kolmogorov p-values, the drift assembly and the
// accumulator fold stay in plain torch around the launch, as they stay in
// jnp around the TPU kernel.
//
// What bounds it on the H100: nothing the card is short of. One launch at
// B=256 reads ~0.25 MB (mostly the two [M, R] reference planes, 229 KB)
// and does ~1e6 operations; both bounds are under 0.1 us, so the honest
// floor is the launch itself (an empty launch of the same grid, made the
// same way, is timed beside the kernel). What remains above it is the
// longest dependent chain of any block. The design keeps every chain
// short and puts all of it in one launch:
//
//   - Student blocks are row-parallel: a warp per row, lane h owning hidden
//     unit h (H = 32). The row's loads are issued first; then the lane
//     loads its dequantized w1 column (50 values) and, on lanes 0..13, its
//     precision column into registers, while the block stages the bf16
//     embed tables in shared memory (its one barrier). The row's 9 embed
//     rows (ids outside [0, K) give a zero vector, as the one-hot matmul
//     does) and 14 numerics are broadcast through a per-warp buffer: 50
//     FMAs per lane, then one 5-step shuffle reduction of
//     relu(acc + b1) * w2 for the logit and one of the 14 lanes'
//     (x - mu) P (x - mu) terms for the Mahalanobis distance: ~60
//     dependent steps a row, not a thread's ~1,800 for the whole MLP.
//   - K-S blocks walk the sorted batch, not dense comparison planes. A
//     block takes one numeric feature and up to 256 / G slots (G = the
//     batch rounded up to a power of two, 32..256 threads per slot): it
//     reads the feature's two reference planes once into shared memory,
//     then each G-thread group sorts its slot's masked column (padding at
//     +inf; a total order on the float bits puts NaN last, so the counts
//     are those of IEEE <=). Up to 32 rows a key's rank and its count
//     of keys <= it come from one pass over the column; past 32,
//     each warp sorts 32 keys by a bitonic network of
//     shuffles and the runs are ranked against each other by binary
//     search. Each finite batch point is counted in the sorted reference
//     by binary search. Then every thread of the block counts 8
//     reference points in each of the block's slots: by 8 branch-free
//     binary searches whose loads are in flight together, or, for 5..8
//     rows, by comparison with the batch held in registers. The counts
//     are the dense planes' integers, and every division is one
//     correctly rounded f32 division, so the statistic is bit-exact;
//     ref_cdf is read as given (not assumed monotone). Blocks of the
//     first C features also count the slot's categories with
//     shared-memory integer atomics.
//   - Past 256 rows a slot no longer fits that shared-memory layout (the
//     JAX package bounds neither the batch nor the reference). A K-S
//     block then owns one (slot, feature) and sorts the slot's keys
//     through a global workspace that the wrapper allocates (P words, P
//     the batch rounded up to a power of two): a bitonic sort whose steps
//     within 4,096 keys run in shared memory chunk by chunk, the longer
//     ones over the workspace. The counts and divisions are the ones
//     above, so the statistic stays bit-exact. When a feature's two
//     planes (2R floats) do not fit beside the slot's words, K-S blocks
//     read them from global memory instead (at R = 32,768 they are
//     256 KB, which stays in L2). The wrapper picks the route by shape;
//     the served shapes (R = 2048, B <= 256) keep everything in shared
//     memory.
//
// Plain C interface (ctypes); launches on the caller's stream, allocates
// nothing, and returns cudaGetLastError() after the launch.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

// Geometry the kernel is compiled for: the schema's 9 categorical
// features of at most 12 categories and 14 numeric features, and the
// quant student's embed width 4 and hidden width 32. The Python wrapper
// checks every tensor against these before launching.
constexpr int C = 9;
constexpr int K = 12;
constexpr int E = 4;
constexpr int M = 14;
constexpr int H = 32;
constexpr int DIN = C * E + M;
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
// A K-S slot's shared words besides its 3B + 1 (keys, sorted column, ECDF
// table): category counts and the valid-row count.
constexpr int GROUP_EXTRA = K + 1;
constexpr int MAX_GROUPS = THREADS / 32;  // slot groups in a K-S block
constexpr int REF_ILP = 8;  // reference points a thread counts at once
constexpr int SMALL_B = 8;  // the largest batch counted by comparison
constexpr int SORT_CHUNK = 4096;  // keys a large slot's sort steps in shared memory

static_assert(H == 32, "a warp's lanes are the student's hidden units");
static_assert(M <= 32 && C + M <= 32, "a row's inputs are one warp's lanes");

__device__ __forceinline__ float bf16_bits_to_f32(uint16_t bits) {
  return __uint_as_float(static_cast<uint32_t>(bits) << 16);
}

// A key whose unsigned order is the order of IEEE <= on the values: -0
// and +0 share a key, every NaN gets the largest key (it is <= nothing,
// and nothing non-NaN is <= it).
__device__ __forceinline__ uint32_t order_key(float v) {
  if (v != v) return 0xFFFFFFFFu;
  uint32_t u = __float_as_uint(v);
  if (u == 0x80000000u) u = 0u;
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float key_value(uint32_t k) {
  if (k == 0xFFFFFFFFu) return __uint_as_float(0x7FFFFFFFu);
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7FFFFFFFu) : ~k);
}

// Barrier of one K-S group: its own warp, or a named barrier over its
// warps (ids 1..8; 0 is __syncthreads').
__device__ __forceinline__ void group_sync(int group, int size) {
  if (size == 32) {
    __syncwarp();
  } else {
    asm volatile("bar.sync %0, %1;" ::"r"(group + 1), "r"(size) : "memory");
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// One row of the student (a warp per row; a block is WARPS rows).
__device__ void student_row(
    const uint16_t* __restrict__ embed, const int8_t* __restrict__ w1_q,
    const float* __restrict__ w1_s, const float* __restrict__ b1,
    const int8_t* __restrict__ w2_q, const float* __restrict__ w2_s,
    const float* __restrict__ b2, const float* __restrict__ mean,
    const float* __restrict__ precision, const float* __restrict__ threshold,
    const float* __restrict__ temperature, const int32_t* __restrict__ cat_ids,
    const float* __restrict__ numeric, const uint8_t* __restrict__ mask,
    float* __restrict__ preds, float* __restrict__ flags, int row,
    int n_rows) {
  __shared__ __align__(16) float emb[C * K * E];          // the embed tables
  __shared__ __align__(16) float xs_all[WARPS][DIN + 2];  // a row's inputs
  __shared__ float cen_all[WARPS][M];                    // its x - mu
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* xs = xs_all[warp];
  float* cen = cen_all[warp];

  // The row's inputs first, so that their loads are in flight with the
  // weights': lanes 0..C-1 take a category id, lanes C..C+M-1 a numeric.
  const bool live = row < n_rows;
  int id = -1;
  float x = 0.f;
  bool valid = false;
  if (live) {
    if (lane < C) {
      id = cat_ids[static_cast<size_t>(row) * C + lane];
    } else if (lane < C + M) {
      x = numeric[static_cast<size_t>(row) * M + lane - C];
    }
    valid = mask[row] != 0;
  }
  // This lane's hidden unit: its w1 column, bias and head weight; lanes
  // below M also hold column `lane` of the precision matrix.
  float w1c[DIN];
  const float s1 = w1_s[lane];
#pragma unroll
  for (int i = 0; i < DIN; ++i) w1c[i] = static_cast<float>(w1_q[i * H + lane]) * s1;
  const float bias1 = b1[lane];
  const float w2 = static_cast<float>(w2_q[lane]) * w2_s[0];
  float pc[M];
#pragma unroll
  for (int k = 0; k < M; ++k) pc[k] = lane < M ? precision[k * M + lane] : 0.f;
  const float mu = lane >= C && lane < C + M ? mean[lane - C] : 0.f;
  for (int i = threadIdx.x; i < C * K * E; i += THREADS) {
    emb[i] = bf16_bits_to_f32(embed[i]);
  }
  __syncthreads();
  if (!live) return;

  // The row's 50 inputs, broadcast through the warp's buffer: each
  // category's embed row (zero for ids outside [0, K), as the one-hot
  // matmul gives), then the numerics and their centred values.
  if (lane < C) {
    float4 e = make_float4(0.f, 0.f, 0.f, 0.f);
    if (id >= 0 && id < K) e = *reinterpret_cast<const float4*>(emb + (lane * K + id) * E);
    *reinterpret_cast<float4*>(xs + lane * E) = e;
  } else if (lane < C + M) {
    xs[C * E + lane - C] = x;
    cen[lane - C] = x - mu;
  }
  __syncwarp();

  float acc = bias1;
#pragma unroll
  for (int i = 0; i < DIN; ++i) acc = fmaf(xs[i], w1c[i], acc);
  float proj = 0.f;
#pragma unroll
  for (int k = 0; k < M; ++k) proj = fmaf(cen[k], pc[k], proj);
  const float logit = warp_sum(fmaxf(acc, 0.f) * w2) + b2[0];
  const float d2 = warp_sum(lane < M ? proj * cen[lane] : 0.f);
  if (lane == 0) {
    preds[row] = 1.0f / (1.0f + expf(-(logit / temperature[0])));
    flags[row] = (valid && d2 > threshold[0]) ? 1.0f : 0.0f;
  }
}

// How many of xs[0..n) are <= v (kStrict: < v), for N values at once, xs
// ascending in that order (NaNs, if any, last): a walk down the powers of
// two from `top` (the largest one <= n). Every step loads unconditionally
// (the index clamped) and selects, so no branch orders the loads and the
// N searches' shared loads are in flight together.
template <bool kStrict, typename T, int N>
__device__ __forceinline__ void bound(const T* xs, int n, int top, const T (&v)[N],
                                      int (&pos)[N]) {
#pragma unroll
  for (int u = 0; u < N; ++u) pos[u] = 0;
  for (int step = top; step > 0; step >>= 1) {
    T x[N];
#pragma unroll
    for (int u = 0; u < N; ++u) x[u] = xs[min(pos[u] + step, n) - 1];
#pragma unroll
    for (int u = 0; u < N; ++u) {
      const int q = pos[u] + step;
      const bool below = kStrict ? x[u] < v[u] : x[u] <= v[u];
      pos[u] = (q <= n) & below ? q : pos[u];
    }
  }
}

__device__ __forceinline__ int top_power(int n) {
  int top = 1;
  while (top * 2 <= n) top *= 2;
  return top;
}

// A slot's words in a K-S block's shared memory (B rows; see `geometry`).
struct SlotView {
  uint32_t* keys;  // [B] the masked column's order keys
  float* sorted;   // [B] the column in ascending order of <=
  float* ftab;     // [B + 1] min(c, n) / n
  int* cnt;        // [K] category counts
  int* n_rows;     // [1] valid rows

  __device__ SlotView(uint32_t* base, int B)
      : keys(base),
        sorted(reinterpret_cast<float*>(base + B)),
        ftab(reinterpret_cast<float*>(base + 2 * B)),
        cnt(reinterpret_cast<int*>(base + 3 * B + 1)),
        n_rows(reinterpret_cast<int*>(base + 3 * B + 1) + K) {}
};

// The slot's 32 < B <= G keys in ascending order into `sorted`, by the
// group's G threads: each warp sorts its 32 (key, row) pairs by a bitonic
// network of shuffles, and each pair's rank is its place in its warp's run
// plus its lower bound in every other run (the pairs are all distinct, so
// the ranks are a permutation; rows past B carry the largest pairs).
__device__ void sort_runs(const SlotView& v, uint64_t* runs, int B, int G,
                          int group, int gt) {
  const int lane = gt % 32, run = gt / 32;
  uint64_t e = (static_cast<uint64_t>(gt < B ? v.keys[gt] : 0xFFFFFFFFu) << 32) | gt;
#pragma unroll
  for (int k = 2; k <= 32; k <<= 1) {
#pragma unroll
    for (int step = k >> 1; step > 0; step >>= 1) {
      const uint64_t other = __shfl_xor_sync(0xffffffffu, e, step);
      const bool keep_min = ((lane & step) == 0) == ((lane & k) == 0);
      e = keep_min ? (other < e ? other : e) : (other > e ? other : e);
    }
  }
  uint64_t* mine = runs + group * G;
  mine[gt] = e;
  group_sync(group, G);
  int rank = lane;
  for (int r = 0; r < G / 32; ++r) {
    if (r == run) continue;
    const uint64_t key[1] = {e};
    int lt[1];
    bound<true>(mine + r * 32, 32, 32, key, lt);
    rank += lt[0];
  }
  if ((e & 0xFFFFFFFFu) < static_cast<uint64_t>(B)) {
    v.sorted[rank] = key_value(static_cast<uint32_t>(e >> 32));
  }
}

// Feature j's K-S statistic (and, for j < C, its category counts) for the
// slots [slot0, slot0 + 256 / G) of a launch with B rows per slot: a
// G-thread group per slot sorts its column and counts its batch points;
// then every thread of the block counts 8 reference points in every slot
// of the block.
template <bool kPlanesShared>
__device__ void ks_slots(const float* __restrict__ ref_sorted,
                         const float* __restrict__ ref_cdf,
                         const int32_t* __restrict__ cat_ids,
                         const float* __restrict__ numeric,
                         const uint8_t* __restrict__ mask,
                         float* __restrict__ counts, float* __restrict__ ks,
                         int j, int slot0, int S, int B, int R, int G,
                         float* smem) {
  __shared__ float red[MAX_GROUPS][WARPS];  // per slot, each warp's maximum
  __shared__ uint64_t runs[THREADS];        // the sort's sorted warp runs
  // The feature's reference planes [R] each: in shared memory, or where
  // they lie in global memory when they do not fit.
  const float* ref = kPlanesShared ? smem : ref_sorted + static_cast<size_t>(j) * R;
  const float* cdf = kPlanesShared ? smem + R : ref_cdf + static_cast<size_t>(j) * R;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int group = tid / G, gt = tid % G, n_groups = THREADS / G;
  const int stride = 3 * B + 1 + GROUP_EXTRA;  // a slot's words
  uint32_t* slots = reinterpret_cast<uint32_t*>(kPlanesShared ? smem + 2 * R : smem);
  const SlotView view(slots + group * stride, B);

  const int s = slot0 + group;
  const bool live = s < S;
  const size_t base = static_cast<size_t>(s) * B;
  // The slot's first G rows, loaded before the barrier so that their
  // latency overlaps the planes'.
  float x0 = 0.f;
  bool valid0 = false;
  int id0 = -1;
  if (live && gt < B) {
    valid0 = mask[base + gt] != 0;
    x0 = numeric[(base + gt) * M + j];
    if (j < C) id0 = cat_ids[(base + gt) * C + j];
  }
  // The feature's reference planes, once for all of the block's slots.
  if (kPlanesShared) {
    for (int k = tid; k < R; k += THREADS) {
      smem[k] = ref_sorted[static_cast<size_t>(j) * R + k];
      smem[R + k] = ref_cdf[static_cast<size_t>(j) * R + k];
    }
  }
  if (gt < K) view.cnt[gt] = 0;
  if (gt == 0) *view.n_rows = 0;
  __syncthreads();

  float d = 0.0f;  // this thread's share of its slot's statistic
  if (live) {
    // The slot's masked column as order keys (padding +inf), its valid
    // rows counted by ballot, its categories by shared atomics.
    for (int t0 = 0; t0 < B; t0 += G) {
      const int t = t0 + gt;
      bool valid = false;
      if (t < B) {
        float x = x0;
        int id = id0;
        valid = valid0;
        if (t0 > 0) {
          valid = mask[base + t] != 0;
          x = numeric[(base + t) * M + j];
          id = j < C ? cat_ids[(base + t) * C + j] : -1;
        }
        view.keys[t] = order_key(valid ? x : INFINITY);
        if (valid && id >= 0 && id < K) atomicAdd(&view.cnt[id], 1);
      }
      const unsigned ballot = __ballot_sync(0xffffffffu, valid);
      if (lane == 0 && ballot) atomicAdd(view.n_rows, __popc(ballot));
    }
    group_sync(group, G);
    const int n = *view.n_rows;
    const float n_f = fmaxf(static_cast<float>(n), 1.0f);
    if (j < C && gt < K) {
      counts[(static_cast<size_t>(s) * C + j) * K + gt] = static_cast<float>(view.cnt[gt]);
    }
    // ECDF_batch values, min(c, n) / n for every count c the slot can
    // give.
    for (int c = gt; c <= B; c += G) {
      view.ftab[c] = __fdiv_rn(fminf(static_cast<float>(c), n_f), n_f);
    }
    const float r_f = static_cast<float>(R);
    const int top_r = top_power(R);
    if (B <= 32) {
      // Each key's rank (ties by row) and its count of keys <= it by one
      // pass over the column; the ECDFs at the finite batch points.
      for (int t = gt; t < B; t += G) {
        const uint32_t kt = view.keys[t];
        int below = 0, le = 0;
#pragma unroll 8
        for (int l = 0; l < B; ++l) {
          const uint32_t kl = view.keys[l];
          below += static_cast<int>(kl < kt) + static_cast<int>((kl == kt) & (l < t));
          le += static_cast<int>(kl <= kt);
        }
        const float v[1] = {key_value(kt)};
        view.sorted[below] = v[0];
        if (isfinite(v[0])) {
          int c_ref[1];
          bound<false>(ref, R, top_r, v, c_ref);
          const float f_b = __fdiv_rn(fminf(static_cast<float>(le), n_f), n_f);
          d = fmaxf(d, fabsf(__fdiv_rn(static_cast<float>(c_ref[0]), r_f) - f_b));
        }
      }
    } else {
      sort_runs(view, runs, B, G, group, gt);
      group_sync(group, G);
      // The ECDFs at the finite batch points, from each one's counts in
      // the sorted batch and the sorted reference.
      for (int t = gt; t < B; t += G) {
        const float v[1] = {view.sorted[t]};
        if (isfinite(v[0])) {
          int le = t + 1, c_ref[1];  // past t, only equal values are <= v
          while (le < B && view.sorted[le] <= v[0]) ++le;
          bound<false>(ref, R, top_r, v, c_ref);
          d = fmaxf(d, fabsf(__fdiv_rn(static_cast<float>(c_ref[0]), r_f) - view.ftab[le]));
        }
      }
    }
  }
  __syncthreads();  // every live slot's sorted column and table are in place

  // ECDF of the batch at the reference points: 8 points of every slot of
  // the block per thread and pass, their searches in flight together.
  float dr[MAX_GROUPS];
#pragma unroll
  for (int g = 0; g < MAX_GROUPS; ++g) dr[g] = g == group ? d : 0.0f;
  const int top_b = top_power(B);
  for (int k0 = 0; k0 < R; k0 += THREADS * REF_ILP) {
    float rv[REF_ILP], cv[REF_ILP];
#pragma unroll
    for (int u = 0; u < REF_ILP; ++u) {
      const int k = min(k0 + u * THREADS + tid, R - 1);  // a repeat is harmless
      rv[u] = ref[k];
      cv[u] = cdf[k];
    }
#pragma unroll
    for (int g = 0; g < MAX_GROUPS; ++g) {
      if (g < n_groups && slot0 + g < S) {
        const SlotView w(slots + g * stride, B);
        int c[REF_ILP];
        if (B > SMALL_B / 2 && B <= SMALL_B) {
          // 5..8 values, whose search takes 4 dependent steps: count by
          // comparison with the values in registers (NaN, <= nothing,
          // past B), all independent. Smaller batches search in 1-3.
          float sv[SMALL_B];
#pragma unroll
          for (int l = 0; l < SMALL_B; ++l) {
            sv[l] = l < B ? w.sorted[min(l, B - 1)] : __int_as_float(0x7FFFFFFF);
          }
#pragma unroll
          for (int u = 0; u < REF_ILP; ++u) {
            c[u] = 0;
#pragma unroll
            for (int l = 0; l < SMALL_B; ++l) c[u] += static_cast<int>(sv[l] <= rv[u]);
          }
        } else {
          bound<false>(w.sorted, B, top_b, rv, c);
        }
#pragma unroll
        for (int u = 0; u < REF_ILP; ++u) dr[g] = fmaxf(dr[g], fabsf(cv[u] - w.ftab[c[u]]));
      }
    }
  }
  // Each slot's maximum over the block.
#pragma unroll
  for (int g = 0; g < MAX_GROUPS; ++g) {
    float v = dr[g];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
    if (lane == 0) red[g][warp] = v;
  }
  __syncthreads();
  if (tid < n_groups && slot0 + tid < S) {
    float m = 0.0f;
    for (int w = 0; w < WARPS; ++w) m = fmaxf(m, red[tid][w]);
    const SlotView w(slots + tid * stride, B);
    ks[static_cast<size_t>(slot0 + tid) * M + j] = *w.n_rows > 0 ? m : 0.0f;
  }
}

// One bitonic step (merge size k, partner distance jj) over keys[0, n),
// whose first element has index `base` in the whole sort (the step's
// direction follows the whole sort's index); a barrier ends it.
__device__ __forceinline__ void bitonic_step(uint32_t* keys, int n, int base,
                                             int k, int jj) {
  for (int i = threadIdx.x; i < n; i += THREADS) {
    const int ixj = i ^ jj;
    if (ixj > i) {
      const uint32_t a = keys[i], b = keys[ixj];
      const bool up = ((base + i) & k) == 0;
      if ((a > b) == up) {
        keys[i] = b;
        keys[ixj] = a;
      }
    }
  }
  __syncthreads();
}

// keys[0, P) ascending, P a power of two, by the block, `buf` a
// shared-memory chunk of min(P, SORT_CHUNK) words: the runs of a chunk are
// sorted chunk by chunk in shared memory; each longer merge takes its
// steps of a chunk or more over `keys` and the rest chunk by chunk.
__device__ void sort_keys(uint32_t* keys, int P, uint32_t* buf) {
  const int chunk = min(P, SORT_CHUNK);
  for (int c0 = 0; c0 < P; c0 += chunk) {
    for (int i = threadIdx.x; i < chunk; i += THREADS) buf[i] = keys[c0 + i];
    __syncthreads();
    for (int k = 2; k <= chunk; k <<= 1) {
      for (int jj = k >> 1; jj > 0; jj >>= 1) bitonic_step(buf, chunk, c0, k, jj);
    }
    for (int i = threadIdx.x; i < chunk; i += THREADS) keys[c0 + i] = buf[i];
    __syncthreads();
  }
  for (int k = 2 * chunk; k <= P; k <<= 1) {
    for (int jj = k >> 1; jj >= chunk; jj >>= 1) bitonic_step(keys, P, 0, k, jj);
    for (int c0 = 0; c0 < P; c0 += chunk) {
      for (int i = threadIdx.x; i < chunk; i += THREADS) buf[i] = keys[c0 + i];
      __syncthreads();
      for (int jj = chunk >> 1; jj > 0; jj >>= 1) bitonic_step(buf, chunk, c0, k, jj);
      for (int i = threadIdx.x; i < chunk; i += THREADS) keys[c0 + i] = buf[i];
      __syncthreads();
    }
  }
}

// Feature j's K-S statistic (and, for j < C, its category counts) for
// slot s of a launch with B > 256 rows per slot, by the whole block: the
// slot's order keys are sorted in the workspace `work` (P words for this
// slot and feature), then read as the sorted column.
template <bool kPlanesShared>
__device__ void ks_large_slot(const float* __restrict__ ref_sorted,
                              const float* __restrict__ ref_cdf,
                              const int32_t* __restrict__ cat_ids,
                              const float* __restrict__ numeric,
                              const uint8_t* __restrict__ mask,
                              float* __restrict__ counts, float* __restrict__ ks,
                              uint32_t* work, int j, int s, int B, int R, int P,
                              float* smem) {
  __shared__ int cnt[K];
  __shared__ int n_rows;
  __shared__ float red[WARPS];
  const float* ref = kPlanesShared ? smem : ref_sorted + static_cast<size_t>(j) * R;
  const float* cdf = kPlanesShared ? smem + R : ref_cdf + static_cast<size_t>(j) * R;
  uint32_t* buf = reinterpret_cast<uint32_t*>(kPlanesShared ? smem + 2 * R : smem);
  uint32_t* keys = work + (static_cast<size_t>(s) * M + j) * P;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const size_t base = static_cast<size_t>(s) * B;
  if (kPlanesShared) {
    for (int k = tid; k < R; k += THREADS) {
      smem[k] = ref_sorted[static_cast<size_t>(j) * R + k];
      smem[R + k] = ref_cdf[static_cast<size_t>(j) * R + k];
    }
  }
  if (tid < K) cnt[tid] = 0;
  if (tid == 0) n_rows = 0;
  __syncthreads();
  // The masked column as order keys (padding +inf, the keys past B the
  // largest), valid rows by ballot, categories by shared atomics. P is a
  // multiple of the block, so every lane takes part in every ballot.
  for (int t = tid; t < P; t += THREADS) {
    bool valid = false;
    uint32_t key = 0xFFFFFFFFu;
    if (t < B) {
      valid = mask[base + t] != 0;
      const float x = numeric[(base + t) * M + j];
      const int id = j < C ? cat_ids[(base + t) * C + j] : -1;
      key = order_key(valid ? x : INFINITY);
      if (valid && id >= 0 && id < K) atomicAdd(&cnt[id], 1);
    }
    keys[t] = key;
    const unsigned ballot = __ballot_sync(0xffffffffu, valid);
    if (lane == 0 && ballot) atomicAdd(&n_rows, __popc(ballot));
  }
  __syncthreads();
  sort_keys(keys, P, buf);
  const int n = n_rows;
  const float n_f = fmaxf(static_cast<float>(n), 1.0f);
  if (j < C && tid < K) {
    counts[(static_cast<size_t>(s) * C + j) * K + tid] = static_cast<float>(cnt[tid]);
  }
  // The sorted keys as the sorted column, in place.
  float* sorted = reinterpret_cast<float*>(keys);
  for (int t = tid; t < B; t += THREADS) sorted[t] = key_value(keys[t]);
  __syncthreads();

  const float r_f = static_cast<float>(R);
  const int top_r = top_power(R), top_b = top_power(B);
  float d = 0.0f;
  // ECDFs at the finite batch points: counts in the sorted batch and in
  // the sorted reference, both by binary search.
  for (int t = tid; t < B; t += THREADS) {
    const float v[1] = {sorted[t]};
    if (isfinite(v[0])) {
      int le[1], c_ref[1];
      bound<false>(sorted, B, top_b, v, le);
      bound<false>(ref, R, top_r, v, c_ref);
      const float f_b = __fdiv_rn(fminf(static_cast<float>(le[0]), n_f), n_f);
      d = fmaxf(d, fabsf(__fdiv_rn(static_cast<float>(c_ref[0]), r_f) - f_b));
    }
  }
  // ECDF of the batch at the reference points, 8 per thread and pass.
  for (int k0 = 0; k0 < R; k0 += THREADS * REF_ILP) {
    float rv[REF_ILP], cv[REF_ILP];
#pragma unroll
    for (int u = 0; u < REF_ILP; ++u) {
      const int k = min(k0 + u * THREADS + tid, R - 1);  // a repeat is harmless
      rv[u] = ref[k];
      cv[u] = cdf[k];
    }
    int c[REF_ILP];
    bound<false>(sorted, B, top_b, rv, c);
#pragma unroll
    for (int u = 0; u < REF_ILP; ++u) {
      const float f = __fdiv_rn(fminf(static_cast<float>(c[u]), n_f), n_f);
      d = fmaxf(d, fabsf(cv[u] - f));
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) d = fmaxf(d, __shfl_xor_sync(0xffffffffu, d, off));
  if (lane == 0) red[warp] = d;
  __syncthreads();
  if (tid == 0) {
    float m = 0.0f;
    for (int w = 0; w < WARPS; ++w) m = fmaxf(m, red[w]);
    ks[static_cast<size_t>(s) * M + j] = n > 0 ? m : 0.0f;
  }
}

// Blocks [0, n_ks) are K-S blocks (feature j = block % M, slot group
// block / M); the rest run the student, a warp per row. kLarge: more than
// 256 rows per slot, one slot per K-S block sorted through `work`.
template <bool kPlanesShared, bool kLarge>
__global__ void __launch_bounds__(THREADS, 2) quant_fused_kernel(
    const uint16_t* __restrict__ embed, const int8_t* __restrict__ w1_q,
    const float* __restrict__ w1_s, const float* __restrict__ b1,
    const int8_t* __restrict__ w2_q, const float* __restrict__ w2_s,
    const float* __restrict__ b2, const float* __restrict__ ref_sorted,
    const float* __restrict__ ref_cdf, const float* __restrict__ mean,
    const float* __restrict__ precision, const float* __restrict__ threshold,
    const float* __restrict__ temperature, const int32_t* __restrict__ cat_ids,
    const float* __restrict__ numeric, const uint8_t* __restrict__ mask,
    float* __restrict__ preds, float* __restrict__ flags,
    float* __restrict__ counts, float* __restrict__ ks, uint32_t* work, int S,
    int B, int R, int G, int P, int n_ks) {
  extern __shared__ float smem[];
  const int block = blockIdx.x;
  if (block < n_ks) {
    if constexpr (kLarge) {
      ks_large_slot<kPlanesShared>(ref_sorted, ref_cdf, cat_ids, numeric, mask,
                                   counts, ks, work, block % M, block / M, B, R,
                                   P, smem);
    } else {
      ks_slots<kPlanesShared>(ref_sorted, ref_cdf, cat_ids, numeric, mask,
                              counts, ks, block % M,
                              (block / M) * (THREADS / G), S, B, R, G, smem);
    }
  } else {
    student_row(embed, w1_q, w1_s, b1, w2_q, w2_s, b2, mean, precision,
                threshold, temperature, cat_ids, numeric, mask, preds, flags,
                (block - n_ks) * WARPS + threadIdx.x / 32, S * B);
  }
}

__global__ void quant_empty_kernel() {}

// Dynamic shared memory a block may use: the H100's 232,448 bytes less an
// 8 KB reserve for the kernel's static arrays (~6 KB).
constexpr size_t SMEM_LIMIT = 232448 - 8192;

// The launch's geometry: threads per K-S slot group, K-S blocks, student
// blocks (a warp per row), the route (past 256 rows a slot's keys sort in
// the workspace, P words per slot and feature; the planes in shared or
// global memory) and dynamic shared memory. ops/quant_kernel.py's
// `kernel_route` mirrors it; the launch refuses a workspace of another P.
struct Geometry {
  int group, n_ks, n_student, pow2;
  bool large, planes_shared;
  size_t smem;
};

Geometry geometry(int S, int B, int R) {
  Geometry g;
  g.large = B > THREADS;
  g.group = 32;
  while (g.group < B && g.group < THREADS) g.group *= 2;
  g.pow2 = 1;
  while (g.pow2 < B) g.pow2 *= 2;
  const int per_block = THREADS / g.group;
  g.n_ks = M * ((S + per_block - 1) / per_block);
  const long long rows = static_cast<long long>(S) * B;
  g.n_student = static_cast<int>((rows + WARPS - 1) / WARPS);
  const size_t slot_words =
      g.large ? static_cast<size_t>(g.pow2 < SORT_CHUNK ? g.pow2 : SORT_CHUNK)
              : per_block * (3 * static_cast<size_t>(B) + 1 + GROUP_EXTRA);
  g.planes_shared = 4 * (2 * static_cast<size_t>(R) + slot_words) <= SMEM_LIMIT;
  g.smem = 4 * ((g.planes_shared ? 2 * static_cast<size_t>(R) : 0) + slot_words);
  return g;
}

template <bool kPlanesShared, bool kLarge>
cudaError_t launch_route(const Geometry& g, cudaStream_t stream,
                         const void* const* in, void* const* out, void* work,
                         int S, int B, int R) {
  auto kernel = quant_fused_kernel<kPlanesShared, kLarge>;
  if (g.smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(g.smem));
    if (err != cudaSuccess) return err;
  }
  kernel<<<g.n_ks + g.n_student, THREADS, g.smem, stream>>>(
      static_cast<const uint16_t*>(in[0]), static_cast<const int8_t*>(in[1]),
      static_cast<const float*>(in[2]), static_cast<const float*>(in[3]),
      static_cast<const int8_t*>(in[4]), static_cast<const float*>(in[5]),
      static_cast<const float*>(in[6]), static_cast<const float*>(in[7]),
      static_cast<const float*>(in[8]), static_cast<const float*>(in[9]),
      static_cast<const float*>(in[10]), static_cast<const float*>(in[11]),
      static_cast<const float*>(in[12]), static_cast<const int32_t*>(in[13]),
      static_cast<const float*>(in[14]), static_cast<const uint8_t*>(in[15]),
      static_cast<float*>(out[0]), static_cast<float*>(out[1]),
      static_cast<float*>(out[2]), static_cast<float*>(out[3]),
      static_cast<uint32_t*>(work), S, B, R, g.group, g.pow2, g.n_ks);
  return cudaGetLastError();
}

cudaError_t use_device(int device) {
  int current = -1;
  const cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess && current == device) return cudaSuccess;
  return cudaSetDevice(device);
}

}  // namespace

extern "C" {

// Launches one fused predict over S slots of B rows on `stream` and
// returns cudaGetLastError() (0 = launched). Pointers are device pointers
// of contiguous tensors; the caller has checked shapes and dtypes. `work`
// is the workspace of S * M * `work_words` uint32 words when B > 256, else
// unused (may be null); `work_words` must be this geometry's P (the batch
// rounded up to a power of two), or the launch is refused.
int quant_fused_launch(const void* embed, const void* w1_q, const void* w1_s,
                       const void* b1, const void* w2_q, const void* w2_s,
                       const void* b2, const void* ref_sorted,
                       const void* ref_cdf, const void* mean,
                       const void* precision, const void* threshold,
                       const void* temperature, const void* cat_ids,
                       const void* numeric, const void* mask, void* preds,
                       void* flags, void* counts, void* ks, void* work, int S,
                       int B, int R, int work_words, int device, void* stream) {
  const cudaError_t err = use_device(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Geometry g = geometry(S, B, R);
  if (g.smem > SMEM_LIMIT || (g.large && (work == nullptr || work_words != g.pow2))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const void* in[16] = {embed, w1_q, w1_s, b1, w2_q, w2_s, b2, ref_sorted,
                        ref_cdf, mean, precision, threshold, temperature,
                        cat_ids, numeric, mask};
  void* out[4] = {preds, flags, counts, ks};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t r;
  if (g.large) {
    r = g.planes_shared ? launch_route<true, true>(g, st, in, out, work, S, B, R)
                        : launch_route<false, true>(g, st, in, out, work, S, B, R);
  } else {
    r = g.planes_shared ? launch_route<true, false>(g, st, in, out, work, S, B, R)
                        : launch_route<false, false>(g, st, in, out, work, S, B, R);
  }
  return static_cast<int>(r);
}

// An empty kernel launched as quant_fused_launch launches its kernel (the
// same device check, grid, block and shared memory): the floor that
// timings of the real kernel are read against.
int quant_fused_empty_launch(int S, int B, int R, int device, void* stream) {
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Geometry g = geometry(S, B, R);
  if (g.smem > 48 * 1024) {
    err = cudaFuncSetAttribute(quant_empty_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(g.smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  quant_empty_kernel<<<g.n_ks + g.n_student, THREADS, g.smem,
                       static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
