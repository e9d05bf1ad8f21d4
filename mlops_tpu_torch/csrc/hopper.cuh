// Hopper (sm_90a) building blocks of the bf16 flash-attention kernels
// (flash_attention.cu, flash_attention_bwd.cu): mbarriers, TMA loads,
// wgmma descriptors and register-operand products, the stage handshake of
// their shared-memory rings, and the host side that encodes the TMA
// tensor maps and raises a kernel's dynamic shared-memory limit. Each
// source includes it once, inside its own translation unit.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

struct Strides {
  long long b, s, h;  // in elements; the head dimension is contiguous
};

// How a tile of a D-wide bf16 [B, S, H, D] view sits in shared memory, as
// TMA writes it and wgmma reads it. Rows are swizzled at their own width
// (32, 64 or 128 bytes). D = 8 is stored 16 columns wide: the tensor map's
// dim 0 has extent 8 under a 16-wide box, so TMA zero-fills columns 8..15
// and every product runs as at D = 16 (wgmma's bf16 K step is 16). D = 128
// is two 64-column panels, one after the other, because a 256-byte row is
// wider than the 128-byte swizzle span: a panel is `rows` rows of 128
// bytes, K-major steps cross into the second panel by its offset, and an
// MN-major operand reaches it through the descriptor's leading offset.
template <int D>
struct Tile {
  static_assert(D == 8 || D == 16 || D == 32 || D == 64 || D == 128,
                "head_dim 8, 16, 32, 64 or 128");
  static constexpr int kCols = D < 16 ? 16 : D;              // columns held
  static constexpr int kPanelCols = kCols > 64 ? 64 : kCols;  // a TMA box
  static constexpr int kPanels = kCols / kPanelCols;
  static constexpr int kRow = 2 * kPanelCols;  // bytes per panel row
  // Bytes of a tile of `rows` rows, all panels.
  static constexpr int bytes(int rows) { return rows * 2 * kCols; }
};

// --------------------------------------------------------------- device
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

// Arrive once and expect `bytes` more of TMA traffic in this phase.
__device__ __forceinline__ void mbar_arrive_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar))
               : "memory");
}

// Wait until the phase of the given parity has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// One TMA box of a 4-d tensor map into shared memory; completion is
// counted in bytes on `bar`. Coordinates are (d, h, s, b).
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int h, int s, int b,
                                         int d = 0) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(d), "r"(h),
      "r"(s), "r"(b)
      : "memory");
}

// A `rows`-row tile of a D-wide view (`Tile<D>`): one TMA box per panel,
// all counted on `bar` (Tile<D>::bytes(rows) in all).
template <int D>
__device__ __forceinline__ void tma_tile(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int rows, int h, int s,
                                         int b) {
  using T = Tile<D>;
#pragma unroll
  for (int p = 0; p < T::kPanels; ++p) {
    tma_load(static_cast<uint8_t*>(dst) + p * rows * T::kRow, map, bar, h, s, b,
             p * T::kPanelCols);
  }
}

// A wgmma shared-memory descriptor for a tile of rows `kRowBytes` wide,
// swizzled at that width (32, 64 or 128 bytes), eight rows per core
// matrix group: start address, leading offset (16 bytes unless given: a
// K-major operand never reads it, an MN-major one only to step from one
// 64-column panel to the next), stride offset 8 rows, swizzle mode.
template <int kRowBytes>
__device__ __forceinline__ uint64_t smem_desc(const void* p, uint32_t lead = 16) {
  constexpr uint64_t mode = kRowBytes == 128 ? 1 : kRowBytes == 64 ? 2 : 3;
  return static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lead >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((8 * kRowBytes) >> 4) << 32) | (mode << 62);
}

// The K-major descriptor `desc` of a tile (`Tile<D>`, panels `panel`
// bytes apart) moved to its kk-th 16-column step: 32 bytes further along
// the row, or into the next panel.
template <int D>
__device__ __forceinline__ uint64_t kmajor_step(uint64_t desc, int kk, int panel) {
  constexpr int per_panel = Tile<D>::kRow / 32;
  return desc + static_cast<uint64_t>(((kk / per_panel) * panel) >> 4) +
         2 * (kk % per_panel);
}

// The MN-major descriptor of rows [16 kk, 16 kk + 16) of a tile
// (`Tile<D>`, panels `panel` bytes apart): the B operand of a product
// whose output has D columns.
template <int D>
__device__ __forceinline__ uint64_t mnmajor_step(const uint8_t* tile, int kk,
                                                 int panel) {
  using T = Tile<D>;
  return smem_desc<T::kRow>(tile + 16 * kk * T::kRow,
                            T::kPanels > 1 ? static_cast<uint32_t>(panel) : 16u);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}
// Wait until at most one committed group is still running.
__device__ __forceinline__ void wgmma_wait_one() {
  asm volatile("wgmma.wait_group.sync.aligned 1;" ::: "memory");
}

// Keep the compiler from moving reads or writes of wgmma registers across
// the asynchronous issue and wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// This warp is done reading a ring stage (its wgmma reads have completed,
// and __syncwarp has ordered its lanes' shared loads before lane 0): count
// it on the stage's shared counter and return the count before. The
// add is acq_rel, so the warp whose add completes the count, and which
// then refills the stage, sees every other warp's reads finished first.
__device__ __forceinline__ unsigned stage_done(unsigned* counter) {
  unsigned before;
  asm volatile("atom.acq_rel.cta.shared::cta.add.u32 %0, [%1], 1;"
               : "=r"(before)
               : "r"(smem_u32(counter))
               : "memory");
  return before;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// D (64 x 16, f32) += A (64 x 16, bf16 registers) * B (16 x 16, shared,
// MN-major: the transpose bit).
__device__ __forceinline__ void wgmma_rs_n16(float (&d)[8],
                                               const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// D (64 x 32, f32) += A (64 x 16, bf16 registers) * B (16 x 32, shared,
// MN-major: the transpose bit).
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16],
                                               const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// D (64 x 64, f32) += A (64 x 16, bf16 registers) * B (16 x 64, shared,
// MN-major: the transpose bit).
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                               const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// D (64 x 128, f32) += A (64 x 16, bf16 registers) * B (16 x 128, shared,
// MN-major: the transpose bit; two 64-column panels at the descriptor's
// leading offset).
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                                const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// acc (64 x N) += A (64 x 16, registers) B (16 x N, shared, MN-major), N
// the columns a tile holds (Tile<D>::kCols).
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&acc)[N / 2], const uint32_t (&a)[4],
                                         uint64_t b) {
  if constexpr (N == 16) wgmma_rs_n16(acc, a, b);
  if constexpr (N == 32) wgmma_rs_n32(acc, a, b);
  if constexpr (N == 64) wgmma_rs_n64(acc, a, b);
  if constexpr (N == 128) wgmma_rs_n128(acc, a, b);
}

// ----------------------------------------------------------------- host
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up once through the runtime.
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = []() -> EncodeTiled {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess) return nullptr;
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// A TMA map over a strided [B, S, H, D] bf16 view as the 4-d tensor
// (d, h, s, b) with the view's own byte strides, box (a panel's columns,
// `Tile<D>`) x 1 x rows x 1, swizzled at the panel's row width; rows past
// S, and at D = 8 the box's columns past D, read as zeros.
bool tensor_map(CUtensorMap* map, const void* ptr, Strides st, int batch,
                int seq, int heads, int d, int rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  // A dimension of extent 1 is never stepped; a view may leave any stride
  // there, so it gets a legal one.
  auto bytes = [](long long elems, int extent) -> cuuint64_t {
    return extent == 1 ? 16 : static_cast<cuuint64_t>(elems) * 2;
  };
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(d),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(seq),
                              static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[3] = {bytes(st.h, heads), bytes(st.s, seq),
                                 bytes(st.b, batch)};
  const int box_d = d < 16 ? 16 : d > 64 ? 64 : d;
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(box_d), 1,
                             static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUtensorMapSwizzle swizzle = box_d == 16   ? CU_TENSOR_MAP_SWIZZLE_32B
                                     : box_d == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                   : CU_TENSOR_MAP_SWIZZLE_128B;
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
                dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Allow `kernel` `bytes` of dynamic shared memory (past the 48 KB default)
// on the current device. The attribute is per device, so `devices` (one
// static per kernel instance) records where it is set and the call is
// made once per device, not once per launch.
template <typename Kernel>
cudaError_t allow_dynamic_smem(Kernel kernel, int bytes,
                               std::atomic<unsigned long long>& devices) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = device < 64 ? 1ull << device : 0ull;
  if (bit != 0 && (devices.load(std::memory_order_acquire) & bit)) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (err == cudaSuccess) devices.fetch_or(bit, std::memory_order_release);
  return err;
}

}  // namespace
