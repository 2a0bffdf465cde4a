// Fused 1x1 conv + FrozenBN affine (+ residual) (+ ReLU) of a ResNet
// bottleneck's identity-block tail, over NCHW maps.
//
// Replaces the TPU kernel `conv1x1_bn_add_relu` (`ops/bottleneck_pallas.py`
// of the JAX package), which runs y = relu((x @ W) * scale + shift [+ res])
// over pixels. Here, with P = H * W pixels contiguous per image:
//   Y_b[Cout, P] = act(W[Cout, Cin] . X_b[Cin, P] * scale[Cout] + shift[Cout]
//                      [+ R_b[Cout, P]])
// W is the conv's own [Cout, Cin, 1, 1] weight, so no permute or copy goes
// around the call. x, w, residual and y share one type (f32 or bf16); the
// products accumulate in f32 (FFMA, not TF32: `wgmma` has no full-f32 mode)
// and the epilogue runs in f32 registers before one rounding to the output.
//
// What bounds it on the H100: at the main path's shapes (Cin, Cout >= 64)
// each output takes 2 * Cin operations against a few bytes moved, so f32
// FFMA (67 TFLOP/s) bounds it, except res2's conv3, where the 64-deep product
// sits next to a [256, P] residual read and output write and bytes bound it.
//
// Design. The columns are the flattened B * P pixels, so a tile may span two
// images and the per-image ragged tiles of P = 300 or 1200 go away; each run
// of 4 columns lies in one image because P % 4 == 0 on the fast variant.
//   - A block of 256 threads owns a BM (Cout) x 128 (columns) output tile and
//     walks its part of Cin in steps of 16 through a 3-stage shared-memory
//     ring. X's slice [16][128] arrives by 16-byte `cp.async.cg` (zero-filled
//     past the edges); W's slice is loaded as float4 along Cin into registers
//     during the product of the previous step and stored transposed,
//     [16][BM + 4] (the 4-float pad keeps rows 16-byte aligned and halves the
//     bank conflicts of the transposed store). One __syncthreads per step.
//   - A thread keeps a TM x 8 tile of f32 sums (TM = BM / 16): its rows are
//     groups of 4, 64 apart, its columns two groups of 4, 64 apart, so each
//     inner step reads W and X with LDS.128 only: 4 per 64 FFMA at BM = 128.
//   - Split of Cin where the grid is small: the `split` blocks of one tile form
//     a thread-block cluster along z, each sums its Cin / split part, parks its
//     tile in its own shared memory, and block r of the cluster reduces rows
//     [r, r + 1) * BM / split of every block's tile over distributed shared
//     memory in rank order 0..split-1 before the epilogue. No atomics and no
//     scratch in device memory; two runs give bit-equal results.
//   - Epilogue: float4 residual loads and output stores along P.
// Variants, chosen per call by `ops/bottleneck.py:b4_config`:
//   vec    f32 with P % 4 == 0, Cin % 4 == 0 and 16-byte aligned pointers:
//          cp.async for X, float4 W loads and epilogue, optional Cin split;
//   scalar anything else (P = 63, bf16): the same ring, tile and product, with
//          masked scalar loads widened to f32 in registers, stored to shared
//          memory after the product, a scalar epilogue and no split.
// Per-shape table of the fused-tail eval batch (8 images of 480x640; one
// wave = 132 SMs x 2 resident blocks = 264 blocks; the split doubles while
// the grid is under two waves, 528 blocks, and each part keeps >= 128 of Cin):
//   res2 256->64   BM 64,  1200 blocks          res2 64->256   BM 128, 2400
//   res3 512->128  BM 128, 300 tiles x split 2   res3 128->512  BM 128, 1200
//   res4 1024->256 BM 128, 150 tiles x split 4   res4 256->1024 BM 128, 600
//   res5 2048->512 BM 128, 76 tiles x split 8    res5 512->2048 BM 128, 304 x 2
// BM 64 where Cout <= 64, so res2's conv1 does not compute a half-empty tile.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

namespace cg = cooperative_groups;

namespace {

constexpr int kBN = 128;     // columns (pixels) per block
constexpr int kBK = 16;      // Cin step
constexpr int kStages = 3;   // shared-memory ring depth
constexpr int kThreads = 256;
constexpr int kPad = 4;      // floats of pad per transposed W row and reduction row

template <int BM>
struct Smem {
  static constexpr int kW = kBK * (BM + kPad);                   // floats per W stage
  static constexpr int kX = kBK * kBN;                           // floats per X stage
  static constexpr int kPipe = kStages * (kW + kX) * 4;          // bytes of the ring
  static constexpr int kTile = BM * (kBN + kPad) * 4;            // bytes of a parked tile
  static constexpr int kMax = kPipe > kTile ? kPipe : kTile;
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src, int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ float finish(float acc, float sc, float sh, const float* r, int k,
                                        int relu) {
  float v = fmaf(acc, sc, sh);
  if (r != nullptr) v += r[k];
  return relu ? fmaxf(v, 0.f) : v;
}

// f32 epilogue of 4 consecutive columns of row m, starting at element `off`
// of y (16-byte aligned): float4 residual load and store.
__device__ __forceinline__ void store4(float4 a, float sc, float sh, const float* res, float* y,
                                       size_t off, int relu) {
  float r4[4] = {0.f, 0.f, 0.f, 0.f};
  const float* r = nullptr;
  if (res != nullptr) {
    const float4 rv = *reinterpret_cast<const float4*>(res + off);
    r4[0] = rv.x, r4[1] = rv.y, r4[2] = rv.z, r4[3] = rv.w;
    r = r4;
  }
  const float4 o = make_float4(finish(a.x, sc, sh, r, 0, relu), finish(a.y, sc, sh, r, 1, relu),
                               finish(a.z, sc, sh, r, 2, relu), finish(a.w, sc, sh, r, 3, relu));
  *reinterpret_cast<float4*>(y + off) = o;
}

template <typename T, int BM, bool kVec>
__global__ void __launch_bounds__(kThreads, 2)
conv1x1_bn_act_kernel(const T* __restrict__ x,         // [B, Cin, P]
                      const T* __restrict__ w,         // [Cout, Cin]
                      const float* __restrict__ scale, // [Cout]
                      const float* __restrict__ shift, // [Cout]
                      const T* __restrict__ res,       // [B, Cout, P] or null
                      T* __restrict__ y,               // [B, Cout, P]
                      int cin, int cout, int p, int n_cols, int relu, int split) {
  static_assert(!kVec || std::is_same<T, float>::value, "the vec variant is f32 only");
  constexpr int TM = BM / 16;   // rows per thread, in groups of 4, 64 apart
  constexpr int WCH = BM / 64;  // float4 chunks of W per thread per stage
  constexpr int kWRow = BM + kPad;
  extern __shared__ float4 smem4[];
  float* const smem = reinterpret_cast<float*>(smem4);
  float* const ws = smem;                                // [kStages][kBK][BM + kPad]
  float* const xs = smem + kStages * Smem<BM>::kW;       // [kStages][kBK][kBN]

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * kBN;
  const int part = cin / split;
  const int kbeg = blockIdx.z * part;
  const int kend = kbeg + part;
  const int ksteps = (part + kBK - 1) / kBK;

  // X loads: rows xr0 and xr0 + 8 of a stage, columns n0 + 4 * xc .. + 3
  const int xr0 = tid >> 5, xc = tid & 31;
  constexpr int kXCols = kVec ? 1 : 4;
  size_t xoff[kXCols];
  bool xok[kXCols];
#pragma unroll
  for (int j = 0; j < kXCols; ++j) {
    const int n = n0 + 4 * xc + j;
    xok[j] = n < n_cols;
    const int b = xok[j] ? n / p : 0;
    xoff[j] = xok[j] ? static_cast<size_t>(b) * cin * p + (n - b * p) : 0;
  }
  float4 wr[WCH];
  float xr[kVec ? 1 : 8];

  auto load_w = [&](int t) {
    const int k0 = kbeg + t * kBK;
#pragma unroll
    for (int i = 0; i < WCH; ++i) {
      const int e = tid + i * kThreads;
      const int gm = m0 + (e >> 2), k = k0 + 4 * (e & 3);
      const T* src = w + static_cast<size_t>(gm) * cin + k;
      if constexpr (kVec) {
        wr[i] = (gm < cout && k < kend) ? *reinterpret_cast<const float4*>(src)
                                        : make_float4(0.f, 0.f, 0.f, 0.f);
      } else {
        float v[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) v[j] = (gm < cout && k + j < kend) ? to_f32(src[j]) : 0.f;
        wr[i] = make_float4(v[0], v[1], v[2], v[3]);
      }
    }
  };
  auto store_w = [&](int slot) {
    float* dst = ws + slot * Smem<BM>::kW;
#pragma unroll
    for (int i = 0; i < WCH; ++i) {
      const int e = tid + i * kThreads;
      const int m = e >> 2, c = 4 * (e & 3);
      dst[(c + 0) * kWRow + m] = wr[i].x;
      dst[(c + 1) * kWRow + m] = wr[i].y;
      dst[(c + 2) * kWRow + m] = wr[i].z;
      dst[(c + 3) * kWRow + m] = wr[i].w;
    }
  };
  auto load_x = [&](int t, int slot) {
    const int k0 = kbeg + t * kBK;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = xr0 + 8 * i, k = k0 + r;
      if constexpr (kVec) {
        const bool ok = xok[0] && k < kend;
        const float* src = ok ? x + xoff[0] + static_cast<size_t>(k) * p : x;
        cp_async16(xs + slot * Smem<BM>::kX + r * kBN + 4 * xc, src, ok ? 16 : 0);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          xr[4 * i + j] = (xok[j] && k < kend) ? to_f32(x[xoff[j] + static_cast<size_t>(k) * p])
                                               : 0.f;
      }
    }
  };
  auto store_x = [&](int slot) {
    if constexpr (!kVec) {
#pragma unroll
      for (int i = 0; i < 2; ++i)
        *reinterpret_cast<float4*>(xs + slot * Smem<BM>::kX + (xr0 + 8 * i) * kBN + 4 * xc) =
            make_float4(xr[4 * i], xr[4 * i + 1], xr[4 * i + 2], xr[4 * i + 3]);
    }
  };

  float acc[TM][8];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < ksteps) {
      load_w(s);
      load_x(s, s);
      store_w(s);
      store_x(s);
    }
    cp_async_commit();
  }
  for (int t = 0; t < ksteps; ++t) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // step t has landed; the slot of step t - 1 is free
    const int nt = t + kStages - 1;
    const bool more = nt < ksteps;
    if (more) {
      load_w(nt);
      load_x(nt, nt % kStages);
    }
    cp_async_commit();
    const float* wsl = ws + (t % kStages) * Smem<BM>::kW;
    const float* xsl = xs + (t % kStages) * Smem<BM>::kX;
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      float a[TM], bv[8];
#pragma unroll
      for (int g = 0; g < TM / 4; ++g) {
        const float4 v = *reinterpret_cast<const float4*>(wsl + kk * kWRow + g * 64 + ty * 4);
        a[4 * g] = v.x, a[4 * g + 1] = v.y, a[4 * g + 2] = v.z, a[4 * g + 3] = v.w;
      }
#pragma unroll
      for (int g = 0; g < 2; ++g) {
        const float4 v = *reinterpret_cast<const float4*>(xsl + kk * kBN + g * 64 + tx * 4);
        bv[4 * g] = v.x, bv[4 * g + 1] = v.y, bv[4 * g + 2] = v.z, bv[4 * g + 3] = v.w;
      }
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], bv[j], acc[i][j]);
    }
    if (more) {
      store_w(nt % kStages);
      store_x(nt % kStages);
    }
  }

  if constexpr (kVec) {
    if (split > 1) {
      // park the tile, then reduce a slice of rows over the cluster in rank order
      cp_async_wait<0>();
      __syncthreads();
      float* const ts = smem;  // [BM][kBN + kPad]
      constexpr int kTRow = kBN + kPad;
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const int row = (i >> 2) * 64 + ty * 4 + (i & 3);
#pragma unroll
        for (int g = 0; g < 2; ++g)
          *reinterpret_cast<float4*>(ts + row * kTRow + g * 64 + tx * 4) =
              make_float4(acc[i][4 * g], acc[i][4 * g + 1], acc[i][4 * g + 2], acc[i][4 * g + 3]);
      }
      cg::cluster_group cluster = cg::this_cluster();
      cluster.sync();
      const int rows = BM / split;
      const int r0 = static_cast<int>(cluster.block_rank()) * rows;
      for (int e = tid; e < rows * (kBN / 4); e += kThreads) {
        const int r = r0 + e / (kBN / 4), c4 = e % (kBN / 4);
        float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
        for (int q = 0; q < split; ++q) {
          const float* src = cluster.map_shared_rank(ts, q);
          const float4 v = *reinterpret_cast<const float4*>(src + r * kTRow + 4 * c4);
          s.x += v.x, s.y += v.y, s.z += v.z, s.w += v.w;
        }
        const int m = m0 + r, n = n0 + 4 * c4;
        if (m < cout && n < n_cols) {
          const int b = n / p;
          store4(s, scale[m], shift[m], res, y,
                 (static_cast<size_t>(b) * cout + m) * p + (n - b * p), relu);
        }
      }
      cluster.sync();  // keep this block's tile alive until every rank has read it
      return;
    }
  }

#pragma unroll
  for (int g = 0; g < 2; ++g) {
    const int n = n0 + g * 64 + tx * 4;
    if constexpr (kVec) {
      if (n >= n_cols) continue;
      const int b = n / p;
      const size_t col = static_cast<size_t>(b) * cout * p + (n - b * p);
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const int m = m0 + (i >> 2) * 64 + ty * 4 + (i & 3);
        if (m >= cout) continue;
        store4(make_float4(acc[i][4 * g], acc[i][4 * g + 1], acc[i][4 * g + 2], acc[i][4 * g + 3]),
               scale[m], shift[m], res, y, col + static_cast<size_t>(m) * p, relu);
      }
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int nj = n + j;
        if (nj >= n_cols) continue;
        const int b = nj / p;
        const size_t col = static_cast<size_t>(b) * cout * p + (nj - b * p);
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          const int m = m0 + (i >> 2) * 64 + ty * 4 + (i & 3);
          if (m >= cout) continue;
          const size_t off = col + static_cast<size_t>(m) * p;
          float v = fmaf(acc[i][4 * g + j], scale[m], shift[m]);
          if (res != nullptr) v += to_f32(res[off]);
          if (relu) v = fmaxf(v, 0.f);
          y[off] = from_f32<T>(v);
        }
      }
    }
  }
}

template <typename T, int BM, bool kVec>
int launch(const void* x, const void* w, const void* scale, const void* shift, const void* res,
           void* y, int b, int cin, int cout, int p, int relu, int split, void* stream) {
  auto kern = conv1x1_bn_act_kernel<T, BM, kVec>;
  static bool attr_set = false;  // one instantiation, one attribute
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, Smem<BM>::kMax);
    if (e != cudaSuccess) return static_cast<int>(e);
    attr_set = true;
  }
  const int n_cols = b * p;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((cout + BM - 1) / BM, (n_cols + kBN - 1) / kBN, split);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = split > 1 ? Smem<BM>::kMax : Smem<BM>::kPipe;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = split;
  cfg.attrs = attr;
  cfg.numAttrs = split > 1 ? 1 : 0;
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, kern, static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<const float*>(scale), static_cast<const float*>(shift),
      static_cast<const T*>(res), static_cast<T*>(y), cin, cout, p, n_cols, relu, split);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

template <int BM>
int dispatch(const void* x, const void* w, const void* scale, const void* shift, const void* res,
             void* y, int b, int cin, int cout, int p, int relu, int bf16, int vec, int split,
             void* stream) {
  if (vec)
    return launch<float, BM, true>(x, w, scale, shift, res, y, b, cin, cout, p, relu, split,
                                   stream);
  if (bf16)
    return launch<__nv_bfloat16, BM, false>(x, w, scale, shift, res, y, b, cin, cout, p, relu,
                                            split, stream);
  return launch<float, BM, false>(x, w, scale, shift, res, y, b, cin, cout, p, relu, split,
                                  stream);
}

bool config_ok(int cin, int bm, int bf16, int vec, int split) {
  if (bm != 64 && bm != 128) return false;
  if (vec && (bf16 || cin % 4 != 0)) return false;
  if (split == 1) return true;
  return vec && (split == 2 || split == 4 || split == 8) && cin % (kBK * split) == 0;
}

}  // namespace

// x [B, Cin, P], w [Cout, Cin], res (may be null) and y [B, Cout, P], all of
// one type: bf16 when `bf16` is non-zero, else f32. scale/shift f32 [Cout].
// Config: bm 64 or 128 (Cout rows per block); vec 1 for the f32 cp.async
// variant (P % 4 == 0, Cin % 4 == 0, 16-byte aligned pointers: the caller
// checks), 0 for the scalar one; split 1, or 2/4/8 on the vec variant with
// Cin % (16 * split) == 0. Returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for a config outside these.
extern "C" int nopesac_conv1x1_bn_act(const void* x, const void* w, const void* scale,
                                      const void* shift, const void* res, void* y, int b,
                                      int cin, int cout, int p, int relu, int bf16, int bm,
                                      int vec, int split, void* stream) {
  if (!config_ok(cin, bm, bf16, vec, split)) return static_cast<int>(cudaErrorInvalidValue);
  if (bm == 64)
    return dispatch<64>(x, w, scale, shift, res, y, b, cin, cout, p, relu, bf16, vec, split,
                        stream);
  return dispatch<128>(x, w, scale, shift, res, y, b, cin, cout, p, relu, bf16, vec, split,
                       stream);
}

// Registers, static and dynamic (largest launched) shared bytes, local
// (spill) bytes and max threads per block of one compiled variant, into
// out[0..4]. Returns a cudaError_t.
extern "C" int nopesac_conv1x1_bn_act_attrs(int bf16, int bm, int vec, int* out) {
  if (!config_ok(16, bm, bf16, vec, 1)) return static_cast<int>(cudaErrorInvalidValue);
  cudaFuncAttributes a;
  cudaError_t e;
  int dyn;
  if (bm == 64) {
    dyn = Smem<64>::kMax;
    e = vec ? cudaFuncGetAttributes(&a, conv1x1_bn_act_kernel<float, 64, true>)
        : bf16 ? cudaFuncGetAttributes(&a, conv1x1_bn_act_kernel<__nv_bfloat16, 64, false>)
               : cudaFuncGetAttributes(&a, conv1x1_bn_act_kernel<float, 64, false>);
  } else {
    dyn = Smem<128>::kMax;
    e = vec ? cudaFuncGetAttributes(&a, conv1x1_bn_act_kernel<float, 128, true>)
        : bf16 ? cudaFuncGetAttributes(&a, conv1x1_bn_act_kernel<__nv_bfloat16, 128, false>)
               : cudaFuncGetAttributes(&a, conv1x1_bn_act_kernel<float, 128, false>);
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  out[0] = a.numRegs;
  out[1] = static_cast<int>(a.sharedSizeBytes);
  out[2] = dyn;
  out[3] = static_cast<int>(a.localSizeBytes);
  out[4] = a.maxThreadsPerBlock;
  return 0;
}
