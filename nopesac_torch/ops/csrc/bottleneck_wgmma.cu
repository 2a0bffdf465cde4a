// Fused 1x1 conv + FrozenBN affine (+ residual) (+ ReLU) of a ResNet
// bottleneck's identity-block tail in bf16, on Hopper's tensor cores.
//
// Replaces the TPU kernel `conv1x1_bn_add_relu` (`ops/bottleneck_pallas.py`
// of the JAX package) for bf16 inputs, the dtype it was written for: a
// bf16 x bf16 product with f32 accumulation, then y = relu(acc * scale +
// shift [+ res]) in f32, rounded once to bf16. Over NCHW maps, per image b:
//   Y_b[Cout, P] = act(W[Cout, Cin] . X_b[Cin, P] * scale + shift [+ R_b])
// with the conv's own [Cout, Cin, 1, 1] weight (no permute around the call).
// The f32 variants stay in `bottleneck.cu`.
//
// What bounds it on the H100: at the main path's shapes each call moves
// 14-177 MB of bf16 maps for 2 * Cin operations per output, under the
// card's 295 operations per byte, so bytes bound every call (3.35 TB/s) but
// res5's conv1, where the 2048-deep product at the dense bf16 rate (989
// TFLOP/s) comes level with them. The FFMA of the masked scalar variant took
// 15x the bound; `wgmma` takes the product off the path, and what is left is
// keeping bytes in flight and the grid full.
//
// Design. A block owns a 64 (Cout) x 128 (pixels) output tile: one consumer
// warpgroup issuing `wgmma.mma_async` m64n128k16, and one producer warp. Cin
// is walked in steps of 64 through a 3-stage ring in shared memory with a
// full and an empty `mbarrier` per stage:
//   - A = W [64][64], K-major, by TMA (`cp.async.bulk.tensor`) with the
//     128-byte swizzle; rows past Cout are zero-filled.
//   - B = X [64][128], pixel-major (`wgmma`'s transpose bit for B), as two
//     64-pixel chunks of [64 Cin rows][128 bytes] in the same swizzle. Where
//     P % 8 == 0 a 3D TMA map [B, Cin, P] loads them per image and zero-fills
//     the ragged last tile (P = 1200, 4800). A bf16 row of P = 300 is 600
//     bytes, which no tensor map can stride, so there the producer warp's 32
//     lanes copy 8-byte pieces by `cp.async` into the swizzled places, over
//     the flattened B * P pixels (a tile may span two images; P % 4 == 0 keeps
//     each piece in one), and arrive on the full barrier two stages late,
//     after `cp.async.wait_group` and a proxy fence.
//   - Accuracy: each stage's four `wgmma`s sum a 64-deep partial in their own
//     registers, which is then added to the f32 accumulators with one
//     rounding. Left in the tensor core's accumulator over the whole of Cin
//     (>= 512), the sums put outputs outside one bf16 ulp of the exact
//     product; promoted, `chip_smoke.py` phase 11 holds every output within
//     it. The second accumulator is why a block has one consumer warpgroup:
//     two blocks of 160 threads fit an SM, where one of 288 would leave no
//     room for a second.
//   - TMA path without a split (every eval shape but res5's): one wave of
//     blocks (the grid `b4_config` passes: 132 SMs x the 2 an SM holds)
//     stays and walks the tiles, Cout tile first, so the producer loads
//     the next tile while the consumers finish this one. The residual tile
//     comes by TMA in the 128-byte swizzle; each consumer thread applies
//     scale, shift, the residual and ReLU to its own fragment (two rows,
//     kept in f32 registers), rounds once to bf16 and writes the result
//     over the residual's place (the swizzle keeps these 4-byte accesses
//     free of bank conflicts); two TMA stores take the tile out and drop
//     what lies past Cout and P, and a barrier lets the producer load the
//     next residual once they have read it.
//   - Otherwise a block has one tile, and its f32 tile is staged in the ring
//     ([64][136] floats, conflict-free float2 stores); every thread of the
//     block then reads 8 (4 at P = 300) columns of a row, adds the residual
//     (from shared memory, or by 8-byte loads at P = 300, four in flight per
//     thread), applies scale, shift and ReLU in f32 and stores 16 (8) bytes
//     of bf16 along P, masked at Cout and P.
//   - Split of Cin where the grid is under one wave of resident blocks
//     (132 SMs x 2): the `split` blocks of a tile form a cluster along z,
//     each stages its partial tile, and block r finishes rows [r, r + 1) *
//     64 / split, summing them over distributed shared memory in rank order
//     0..split-1. No atomics: two runs are bit-equal.
// Chosen per call by `ops/bottleneck.py:b4_config` for bf16 with Cin % 64
// == 0, P % 4 == 0 and 16-byte aligned tensors; the masked scalar variant of
// `bottleneck.cu` takes the rest (P = 63, Cin = 96). Per-shape table of the
// fused-tail eval batch (8 images of 480x640; tiles = Cout tiles x pixel
// tiles; on the TMA path 264 resident blocks walk them):
//   res2 256->64   P 19200 TMA       1 x 1200 tiles              264 blocks
//   res2 64->256   P 19200 TMA       4 x 1200                     264
//   res3 512->128  P 4800  TMA       2 x 304 (38 per image)       264
//   res3 128->512  P 4800  TMA       8 x 304                      264
//   res4 1024->256 P 1200  TMA       4 x 80 (10 per image)        264
//   res4 256->1024 P 1200  TMA      16 x 80                       264
//   res5 2048->512 P 300   cp.async  8 x 19 (flat), split 2       304
//   res5 512->2048 P 300   cp.async 32 x 19                       608
// and the JAX test's shape (B 2, P 300, 64 -> 256): cp.async, 4 x 5 tiles.
#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>

namespace cg = cooperative_groups;

namespace {

constexpr int kBM = 64;                       // Cout rows per tile: one consumer warpgroup
constexpr int kBN = 128;                      // pixels per tile
constexpr int kBK = 64;                       // Cin per stage: one 128-byte swizzle row of bf16
constexpr int kStages = 3;                    // ring depth
constexpr int kThreads = 128 + 32;            // the consumer warpgroup and the producer warp
constexpr int kWBytes = kBM * kBK * 2;        // bytes of a W stage
constexpr int kChunk = 64 * kBK * 2;          // bytes of one 64-pixel chunk of an X stage
constexpr int kStage = kWBytes + 2 * kChunk;  // a multiple of 1024
constexpr int kRing = kStages * kStage;
constexpr int kResBytes = 2 * kBM * 128;      // the residual tile: 2 chunks of [rows][64 pixels]
constexpr int kSmem = kRing + kResBytes + (2 * kStages + 1) * 8 + 1024;  // + barriers, alignment
constexpr int kSRow = kBN + 8;                // floats per row of the staged f32 tile
constexpr int kUnroll = 4;                    // epilogue accesses in flight per thread
constexpr int kLag = kStages - 1;             // cp.async stages in flight before a full arrive
static_assert(kBM * kSRow * 4 <= kRing, "the staged tile reuses the ring");

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count));
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
// until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ void tma_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar, int c0,
                                       int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}
__device__ __forceinline__ void tma_3d(uint32_t dst, const CUtensorMap* map, uint32_t bar, int c0,
                                       int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// shared -> global through a tensor map; what lies past its edges is not
// written
__device__ __forceinline__ void tma_store_3d(const CUtensorMap* map, uint32_t src, int c0, int c1,
                                             int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%2, %3, %4}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async8(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// generic-proxy writes to shared memory before async-proxy (wgmma) reads
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// A shared-memory matrix descriptor for the 128-byte swizzle: start address,
// leading and stride byte offsets, all in 16-byte units.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keeps the compiler from moving accumulator accesses across wgmma's
// asynchronous writes
__device__ __forceinline__ void fence_acc(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d[64 x 128] = A[64 x 16] . B[16 x 128] (+ d where accumulate != 0); A
// K-major, B transposed (pixel-major), bf16 in, f32 accumulators in the
// warpgroup's registers
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da, uint64_t db,
                                                 int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 1;\n"
      "}\n"
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
      : "l"(da), "l"(db), "r"(accumulate));
}

// V bf16 values as one 16- (V = 8) or 8-byte (V = 4) access
template <int V>
struct Pack;
template <>
struct Pack<8> {
  using T = uint4;
};
template <>
struct Pack<4> {
  using T = uint2;
};

template <bool kTma>
__global__ void __launch_bounds__(kThreads, 2)
conv1x1_bn_act_wgmma_kernel(const __grid_constant__ CUtensorMap wmap,  // W [Cout, Cin]
                            const __grid_constant__ CUtensorMap xmap,  // X [B, Cin, P] (TMA path)
                            const __grid_constant__ CUtensorMap rmap,  // R [B, Cout, P] (TMA path)
                            const __grid_constant__ CUtensorMap ymap,  // Y [B, Cout, P] (TMA path)
                            const __nv_bfloat16* __restrict__ x,       // X, for the cp.async path
                            const float* __restrict__ scale,           // [Cout]
                            const float* __restrict__ shift,           // [Cout]
                            const __nv_bfloat16* __restrict__ res,     // [B, Cout, P] or null
                            __nv_bfloat16* __restrict__ y,             // [B, Cout, P]
                            int cin, int cout, int p, int n_cols, int tiles_per_image, int relu,
                            int split) {
  constexpr int kVec = kTma ? 8 : 4;  // output columns per epilogue access
  using VecT = typename Pack<kVec>::T;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* const smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t sbase = smem_u32(smem), res_s = sbase + kRing;
  const uint32_t full0 = res_s + kResBytes, empty0 = full0 + kStages * 8;
  const uint32_t rbar = empty0 + kStages * 8, rfree = rbar + 8;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int part = cin / split;
  const int kbeg = blockIdx.z * part, ksteps = part / kBK;
  // tiles run Cout-tile first over the pixel tiles: per image (TMA) or over
  // the flattened B * P pixels
  const int m_tiles = (cout + kBM - 1) / kBM;
  const int n_tiles = m_tiles * (kTma ? n_cols / p * tiles_per_image : (n_cols + kBN - 1) / kBN);
  auto tile_at = [&](int tile, int& m0, int& img, int& c0) {
    const int ny = tile / m_tiles;
    m0 = (tile - ny * m_tiles) * kBM;
    img = kTma ? ny / tiles_per_image : 0;
    c0 = (kTma ? ny % tiles_per_image : ny) * kBN;
  };
  // On the TMA path without a split the block stays and walks tiles, its
  // producer loading the next tile while the consumers finish this one, and
  // the epilogue runs from the fragments; otherwise a block has one tile.
  const bool direct = kTma && split == 1;
  const int tile0 = direct ? blockIdx.x : blockIdx.x + gridDim.x * blockIdx.y;
  const int stride = direct ? gridDim.x : n_tiles;
  int m0, img, c0;
  tile_at(tile0, m0, img, c0);
  // the rows this block finishes: all, or its rank's slice when Cin is split
  cg::cluster_group cluster = cg::this_cluster();
  const int rows = kBM / split;
  const int r0 = (split > 1 ? static_cast<int>(cluster.block_rank()) : 0) * rows;
  const bool tma_res = kTma && res != nullptr;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full0 + 8 * s, kTma ? 1 : 33);  // the TMA's arrive (+ 32 cp.async lanes)
      mbar_init(empty0 + 8 * s, 128);
    }
    mbar_init(rbar, 1);
    mbar_init(rfree, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 4) {  // the producer warp
    if constexpr (kTma) {
      if (lane == 0) {
        int g = 0;  // steps over all of the block's tiles: the ring's position
        for (int tile = tile0, i = 0; tile < n_tiles; tile += stride, ++i) {
          int tm0, timg, tc0;
          tile_at(tile, tm0, timg, tc0);
          for (int t = 0; t < ksteps; ++t, ++g) {
            const int s = g % kStages, k0 = kbeg + t * kBK;
            if (g >= kStages) mbar_wait(empty0 + 8 * s, ((g / kStages) - 1) & 1);
            const uint32_t full = full0 + 8 * s, st = sbase + s * kStage;
            mbar_expect_tx(full, kStage);
            tma_2d(st, &wmap, full, k0, tm0);
            tma_3d(st + kWBytes, &xmap, full, tc0, k0, timg);
            tma_3d(st + kWBytes + kChunk, &xmap, full, tc0 + 64, k0, timg);
            if (t == min(ksteps, kStages) - 1 && tma_res) {
              // the residual rows, once the previous tile's output has left
              if (i > 0) mbar_wait(rfree, (i - 1) & 1);
              mbar_expect_tx(rbar, 2 * rows * 128);
              tma_3d(res_s, &rmap, rbar, tc0, tm0 + r0, timg);
              tma_3d(res_s + rows * 128, &rmap, rbar, tc0 + 64, tm0 + r0, timg);
            }
          }
        }
      }
    } else {
      // lane l copies pixels c0 + 4l .. 4l + 3 of the stage's 64 rows, into
      // chunk l / 16, 16-byte unit (l % 16) / 2 (swizzled by the row), half l % 2
      const int n = c0 + 4 * lane;
      const bool ok = n < n_cols;
      const int b = ok ? n / p : 0;
      const __nv_bfloat16* const src0 =
          x + (ok ? static_cast<size_t>(b) * cin * p + (n - b * p) : 0);
      const uint32_t unit = (lane % 16) / 2;
      const uint32_t lane_off = (lane / 16) * kChunk + (lane % 2) * 8;
      for (int t = 0; t < ksteps; ++t) {
        if (t >= kLag) {  // step t - kLag has landed: publish it
          cp_async_wait<kLag - 1>();
          fence_proxy_async();
          mbar_arrive(full0 + 8 * ((t - kLag) % kStages));
        }
        const int s = t % kStages, k0 = kbeg + t * kBK;
        if (t >= kStages) mbar_wait(empty0 + 8 * s, ((t / kStages) - 1) & 1);
        const uint32_t full = full0 + 8 * s, st = sbase + s * kStage;
        if (lane == 0) {
          mbar_expect_tx(full, kWBytes);
          tma_2d(st, &wmap, full, k0, m0);
        }
        const uint32_t xs = st + kWBytes + lane_off;
        const __nv_bfloat16* const src = src0 + static_cast<size_t>(k0) * p;
#pragma unroll 8
        for (int r = 0; r < kBK; ++r)
          cp_async8(xs + r * 128 + ((unit ^ (r & 7)) << 4),
                    ok ? src + static_cast<size_t>(r) * p : x, ok ? 8 : 0);
        cp_async_commit();
      }
      cp_async_wait<0>();
      fence_proxy_async();
      for (int t = ksteps > kLag ? ksteps - kLag : 0; t < ksteps; ++t)
        mbar_arrive(full0 + 8 * (t % kStages));
    }
  } else {  // the consumer warpgroup
    const int row = warp * 16 + lane / 4;  // this thread's rows: row and row + 8
    int g = 0;
    for (int tile = tile0, i = 0; tile < n_tiles; tile += stride, ++i) {
      int tm0, timg, tc0;
      tile_at(tile, tm0, timg, tc0);
      float acc[64], part[64];
#pragma unroll
      for (int e = 0; e < 64; ++e) acc[e] = 0.f;
      for (int t = 0; t < ksteps; ++t, ++g) {
        const int s = g % kStages;
        mbar_wait(full0 + 8 * s, (g / kStages) & 1);
        const uint32_t a = sbase + s * kStage, bx = a + kWBytes;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kBK / 16; ++kk)  // A: 32 bytes along a row; B: 16 rows of 128 B
          wgmma_m64n128k16(part, sw128_desc(a + kk * 32, 16, 1024),
                           sw128_desc(bx + kk * 2048, kChunk, 1024), kk);
        wgmma_commit();
        wgmma_wait_all();
        fence_acc(part);
        mbar_arrive(empty0 + 8 * s);
#pragma unroll
        for (int e = 0; e < 64; ++e) acc[e] += part[e];  // each 64-deep partial, rounded once
      }
      if (direct) {
        // the residual's place, [2][64][64] bf16 in the 128-byte swizzle,
        // takes the output, which leaves by two TMA stores
        float sc[2], sh[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int m = min(tm0 + row + 8 * h, cout - 1);
          sc[h] = scale[m];
          sh[h] = shift[m];
        }
        asm volatile("bar.sync 1, 128;\n" ::: "memory");  // the last tile's store has read it
        if (tma_res) mbar_wait(rbar, i & 1);
        unsigned char* const rs = smem + kRing;
#pragma unroll
        for (int j = 0; j < 16; ++j) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int lr = row + 8 * h;
            auto* const at = reinterpret_cast<__nv_bfloat162*>(
                rs + (j / 8) * kBM * 128 + lr * 128 + (((j % 8) ^ (lr & 7)) << 4) + (lane % 4) * 4);
            float v0 = fmaf(acc[4 * j + 2 * h], sc[h], sh[h]);
            float v1 = fmaf(acc[4 * j + 2 * h + 1], sc[h], sh[h]);
            if (res != nullptr) {
              const float2 r = __bfloat1622float2(*at);
              v0 += r.x, v1 += r.y;
            }
            if (relu) v0 = fmaxf(v0, 0.f), v1 = fmaxf(v1, 0.f);
            *at = __floats2bfloat162_rn(v0, v1);
          }
        }
        fence_proxy_async();  // the threads' writes, before the TMA reads them
        asm volatile("bar.sync 1, 128;\n" ::: "memory");
        if (tid == 0) {
          tma_store_3d(&ymap, res_s, tc0, tm0, timg);
          tma_store_3d(&ymap, res_s + kBM * 128, tc0 + 64, tm0, timg);
          asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
          mbar_arrive(rfree);  // the producer may load the next tile's residual
        }
      } else {  // one tile: the ring is free, stage the f32 tile in it
        float* const stg = reinterpret_cast<float*>(smem);
        const int col = 2 * (lane % 4);
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          *reinterpret_cast<float2*>(stg + row * kSRow + 8 * j + col) =
              make_float2(acc[4 * j], acc[4 * j + 1]);
          *reinterpret_cast<float2*>(stg + (row + 8) * kSRow + 8 * j + col) =
              make_float2(acc[4 * j + 2], acc[4 * j + 3]);
        }
      }
    }
  }
  if (direct) return;

  if (split > 1)
    cluster.sync();
  else
    __syncthreads();
  if (tma_res) mbar_wait(rbar, 0);

  // epilogue over rows [r0, r0 + rows) of the tile, kVec columns per access
  const float* const stg = reinterpret_cast<const float*>(smem);
  const unsigned char* const rs = smem + kRing;
  constexpr int kPerRow = kBN / kVec;
  const int total = rows * kPerRow;
  for (int e0 = tid; e0 < total; e0 += kUnroll * kThreads) {
    VecT rv[kUnroll];
    size_t off[kUnroll];
    bool ok[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int e = e0 + u * kThreads;
      const int r = e / kPerRow, c = (e % kPerRow) * kVec;
      const int m = m0 + r0 + r, n = c0 + c;
      if constexpr (kTma) {
        ok[u] = e < total && m < cout && n < p;
        off[u] = (static_cast<size_t>(img) * cout + m) * p + n;
        if (ok[u] && tma_res)  // [2][rows][64] bf16 in the 128-byte swizzle
          rv[u] = *reinterpret_cast<const VecT*>(rs + (c / 64) * rows * 128 + r * 128 +
                                                 ((((c % 64) / 8) ^ (r & 7)) << 4));
      } else {
        ok[u] = e < total && m < cout && n < n_cols;
        const int b = ok[u] ? n / p : 0;
        off[u] = (static_cast<size_t>(b) * cout + m) * p + (n - b * p);
        if (ok[u] && res != nullptr) rv[u] = *reinterpret_cast<const VecT*>(res + off[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (!ok[u]) continue;
      const int e = e0 + u * kThreads;
      const int r = r0 + e / kPerRow, c = (e % kPerRow) * kVec;
      float v[kVec];
#pragma unroll
      for (int i = 0; i < kVec; ++i) v[i] = 0.f;
      for (int q = 0; q < split; ++q) {  // rank order: the same sums on every run
        const float* src = (split > 1 ? cluster.map_shared_rank(stg, q) : stg) + r * kSRow + c;
#pragma unroll
        for (int i = 0; i < kVec; i += 4) {
          const float4 f = *reinterpret_cast<const float4*>(src + i);
          v[i] += f.x, v[i + 1] += f.y, v[i + 2] += f.z, v[i + 3] += f.w;
        }
      }
      const int m = m0 + r;
      const float sc = scale[m], sh = shift[m];
      alignas(16) __nv_bfloat16 rh[kVec], out[kVec];
      if (res != nullptr) *reinterpret_cast<VecT*>(rh) = rv[u];
#pragma unroll
      for (int i = 0; i < kVec; ++i) {
        float f = fmaf(v[i], sc, sh);
        if (res != nullptr) f += __bfloat162float(rh[i]);
        if (relu) f = fmaxf(f, 0.f);
        out[i] = __float2bfloat16_rn(f);
      }
      *reinterpret_cast<VecT*>(y + off[u]) = *reinterpret_cast<const VecT*>(out);
    }
  }
  if (split > 1) cluster.sync();  // keep this block's tile alive until every rank has read it
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver through the runtime, so that the
// library needs no -lcuda
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult q;
    const cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000,
                                                           cudaEnableDefault, &q);
    if (e != cudaSuccess || q != cudaDriverEntryPointSuccess) return nullptr;
    fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// W [Cout, Cin] with a {64, 64} box; where tma_x also X [B, Cin, P] with a
// {64, 64, 1} box and Y (and R, with a residual) [B, Cout, P] with {64, 64 /
// split, 1} boxes; all bf16 in the 128-byte swizzle. Loads past the edges
// are zero-filled, stores there dropped.
int make_maps(CUtensorMap* wmap, CUtensorMap* xmap, CUtensorMap* rmap, CUtensorMap* ymap,
              const void* x, const void* w, const void* res, const void* y, int b, int cin,
              int cout, int p, bool tma_x, int split) {
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint32_t ones[3] = {1, 1, 1};
  auto encode = [&](CUtensorMap* map, cuuint32_t rank, const void* ptr, const cuuint64_t* dim,
                    const cuuint64_t* stride, const cuuint32_t* box, CUtensorMapSwizzle swz) {
    return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, const_cast<void*>(ptr), dim, stride,
               box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE, swz, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
               CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
  };
  std::memset(xmap, 0, sizeof(*xmap));
  std::memset(rmap, 0, sizeof(*rmap));
  std::memset(ymap, 0, sizeof(*ymap));
  const cuuint64_t wdim[2] = {static_cast<cuuint64_t>(cin), static_cast<cuuint64_t>(cout)};
  const cuuint64_t wstride[1] = {static_cast<cuuint64_t>(cin) * 2};
  const cuuint32_t wbox[2] = {kBK, kBM};
  bool ok = encode(wmap, 2, w, wdim, wstride, wbox, CU_TENSOR_MAP_SWIZZLE_128B);
  if (tma_x) {
    const cuuint64_t xdim[3] = {static_cast<cuuint64_t>(p), static_cast<cuuint64_t>(cin),
                                static_cast<cuuint64_t>(b)};
    const cuuint64_t xstride[2] = {static_cast<cuuint64_t>(p) * 2,
                                   static_cast<cuuint64_t>(cin) * p * 2};
    const cuuint32_t xbox[3] = {64, kBK, 1};
    ok = ok && encode(xmap, 3, x, xdim, xstride, xbox, CU_TENSOR_MAP_SWIZZLE_128B);
    const cuuint64_t ydim[3] = {static_cast<cuuint64_t>(p), static_cast<cuuint64_t>(cout),
                                static_cast<cuuint64_t>(b)};
    const cuuint64_t ystride[2] = {static_cast<cuuint64_t>(p) * 2,
                                   static_cast<cuuint64_t>(cout) * p * 2};
    const cuuint32_t ybox[3] = {64, static_cast<cuuint32_t>(kBM / split), 1};
    ok = ok && encode(ymap, 3, y, ydim, ystride, ybox, CU_TENSOR_MAP_SWIZZLE_128B);
    if (res != nullptr)
      ok = ok && encode(rmap, 3, res, ydim, ystride, ybox, CU_TENSOR_MAP_SWIZZLE_128B);
  }
  return ok ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

template <bool kTma>
int launch(const void* x, const void* w, const void* scale, const void* shift, const void* res,
           void* y, int b, int cin, int cout, int p, int relu, int split, int blocks,
           void* stream) {
  auto kern = conv1x1_bn_act_wgmma_kernel<kTma>;
  static bool ready = false;  // the shared-memory opt-in, once per instantiation
  if (!ready) {
    const cudaError_t e =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (e != cudaSuccess) return static_cast<int>(e);
    ready = true;
  }
  CUtensorMap wmap, xmap, rmap, ymap;
  const int err =
      make_maps(&wmap, &xmap, &rmap, &ymap, x, w, res, y, b, cin, cout, p, kTma, split);
  if (err != 0) return err;
  const int n_cols = b * p;
  const int tiles_per_image = (p + kBN - 1) / kBN;
  cudaLaunchConfig_t cfg = {};
  const int m_tiles = (cout + kBM - 1) / kBM;
  const int col_tiles = kTma ? b * tiles_per_image : (n_cols + kBN - 1) / kBN;
  // walking blocks take the caller's grid; otherwise a block per tile and part
  const bool walk = kTma && split == 1;
  if (walk ? blocks < 1 || blocks > m_tiles * col_tiles : blocks != m_tiles * col_tiles * split)
    return static_cast<int>(cudaErrorInvalidValue);
  cfg.gridDim = walk ? dim3(blocks) : dim3(m_tiles, col_tiles, split);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = kSmem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = split;
  cfg.attrs = attr;
  cfg.numAttrs = split > 1 ? 1 : 0;
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, kern, wmap, xmap, rmap, ymap, static_cast<const __nv_bfloat16*>(x),
      static_cast<const float*>(scale), static_cast<const float*>(shift),
      static_cast<const __nv_bfloat16*>(res), static_cast<__nv_bfloat16*>(y), cin, cout, p, n_cols,
      tiles_per_image, relu, split);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

bool config_ok(int cin, int p, int tma_x, int split) {
  if (cin % kBK != 0 || p % (tma_x ? 8 : 4) != 0) return false;
  return (split == 1 || split == 2 || split == 4 || split == 8) && cin % (kBK * split) == 0;
}

}  // namespace

// bf16 x [B, Cin, P], w [Cout, Cin], res (may be null) and y [B, Cout, P];
// f32 scale/shift [Cout]. The caller checks 16-byte aligned pointers.
// Config: tma_x 1 to load X (and the residual) by TMA (P % 8 == 0), 0 to
// load X by cp.async (P % 4 == 0); split 1, 2, 4 or 8 with Cin % (64 *
// split) == 0; blocks the grid: with tma_x and no split the blocks that
// walk the tiles (1 to the tile count), otherwise tiles x split. Returns
// cudaGetLastError() after the launch, or a cudaError_t for a config
// outside these or a tensor map the driver refuses.
extern "C" int nopesac_conv1x1_bn_act_wgmma(const void* x, const void* w, const void* scale,
                                            const void* shift, const void* res, void* y, int b,
                                            int cin, int cout, int p, int relu, int tma_x,
                                            int split, int blocks, void* stream) {
  if (!config_ok(cin, p, tma_x, split)) return static_cast<int>(cudaErrorInvalidValue);
  return tma_x ? launch<true>(x, w, scale, shift, res, y, b, cin, cout, p, relu, split, blocks,
                              stream)
               : launch<false>(x, w, scale, shift, res, y, b, cin, cout, p, relu, split, blocks,
                               stream);
}

// Registers, static and dynamic shared bytes, local (spill) bytes, max
// threads per block and the blocks an SM holds at once of one compiled
// variant, into out[0..5]. Returns a cudaError_t.
extern "C" int nopesac_conv1x1_bn_act_wgmma_attrs(int tma_x, int* out) {
  const void* kern = tma_x ? reinterpret_cast<const void*>(conv1x1_bn_act_wgmma_kernel<true>)
                           : reinterpret_cast<const void*>(conv1x1_bn_act_wgmma_kernel<false>);
  cudaFuncAttributes a;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&a, kern);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[5], kern, kThreads, kSmem);
  if (e != cudaSuccess) return static_cast<int>(e);
  out[0] = a.numRegs;
  out[1] = static_cast<int>(a.sharedSizeBytes);
  out[2] = kSmem;
  out[3] = static_cast<int>(a.localSizeBytes);
  out[4] = a.maxThreadsPerBlock;
  return 0;
}
