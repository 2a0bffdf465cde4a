// Fused 1x1 conv + FrozenBN affine (+ residual) (+ ReLU) of a ResNet
// bottleneck's identity-block tail, over NCHW maps.
//
// Replaces the TPU kernel `conv1x1_bn_add_relu` (`ops/bottleneck_pallas.py`
// of the JAX package), which runs y = relu((x @ W) * scale + shift [+ res])
// over pixels. Here, per image b, with P = H * W pixels contiguous:
//   Y_b[Cout, P] = act(W[Cout, Cin] . X_b[Cin, P] * scale[Cout] + shift[Cout]
//                      [+ R_b[Cout, P]])
// W is the conv's own [Cout, Cin, 1, 1] weight, so no permute or copy goes
// around the call. x, w, residual and y share one type (f32 or bf16); the
// products accumulate in f32 (FFMA, not TF32) and the epilogue runs in f32
// registers before one rounding to the output type.
//
// What bounds it on the H100: at the main path's shapes (Cin, Cout >= 64)
// each output takes 2 * Cin operations against a few bytes moved, so f32
// operations bound it (67 TFLOP/s), except res2's conv3, where the 64-deep
// product sits next to a [256, P] residual read and output write and bytes
// bound it. The TPU kernel held all of W in VMEM and tiled P only; res5's W
// (2048 x 512 f32, 4 MB) does not fit in shared memory. Design: a block owns
// a 64 (Cout) x 128 (P) output tile and loops over Cin in steps of 16 through
// shared memory (W's slice transposed to [16][64], X's slice as [16][128],
// both held as f32); each of its 128 threads keeps an 8 x 8 register tile of
// f32 sums. A thread's 8 pixels are 16 apart, so the X reads from shared
// memory, and the residual loads and output stores to device memory, run
// along P, coalesced. The ragged edges of P and Cout are masked.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBM = 64;    // Cout rows per block
constexpr int kBN = 128;   // pixels per block
constexpr int kBK = 16;    // Cin step
constexpr int kTM = 8;     // rows per thread
constexpr int kTN = 8;     // pixels per thread
constexpr int kThreads = (kBM / kTM) * (kBN / kTN);  // 128
constexpr int kColThreads = kBN / kTN;                // 16

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

template <typename T>
__global__ void __launch_bounds__(kThreads)
conv1x1_bn_act_kernel(const T* __restrict__ x,         // [B, Cin, P]
                      const T* __restrict__ w,         // [Cout, Cin]
                      const float* __restrict__ scale, // [Cout]
                      const float* __restrict__ shift, // [Cout]
                      const T* __restrict__ res,       // [B, Cout, P] or null
                      T* __restrict__ y,               // [B, Cout, P]
                      int cin, int cout, int p, int relu) {
  // +1 on W's rows: its tile is written with Cin varying fastest across a
  // warp, which would otherwise put 16 writes on one bank
  __shared__ float ws[kBK][kBM + 1];
  __shared__ float xs[kBK][kBN];

  const int tid = threadIdx.x;
  const int tx = tid % kColThreads;  // pixel lane: pixels p0 + tx + 16 * j
  const int ty = tid / kColThreads;  // row group: rows m0 + 8 * ty + i
  const int p0 = blockIdx.x * kBN;
  const int m0 = blockIdx.y * kBM;
  const int b = blockIdx.z;
  const T* xb = x + static_cast<size_t>(b) * cin * p;

  float acc[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < cin; k0 += kBK) {
    // W[m0 + r][k0 + c] -> ws[c][r]: 16 consecutive Cin values per row
#pragma unroll
    for (int s = 0; s < kBM * kBK / kThreads; ++s) {
      const int e = tid + s * kThreads;
      const int r = e / kBK, c = e % kBK;
      const int m = m0 + r, k = k0 + c;
      ws[c][r] = (m < cout && k < cin) ? to_f32(w[static_cast<size_t>(m) * cin + k]) : 0.f;
    }
    // X_b[k0 + r][p0 + c] -> xs[r][c]: a warp reads 32 consecutive pixels
#pragma unroll
    for (int s = 0; s < kBK * kBN / kThreads; ++s) {
      const int e = tid + s * kThreads;
      const int r = e / kBN, c = e % kBN;
      const int k = k0 + r, q = p0 + c;
      xs[r][c] = (k < cin && q < p) ? to_f32(xb[static_cast<size_t>(k) * p + q]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      float a[kTM], bv[kTN];
#pragma unroll
      for (int i = 0; i < kTM; ++i) a[i] = ws[kk][ty * kTM + i];
#pragma unroll
      for (int j = 0; j < kTN; ++j) bv[j] = xs[kk][tx + j * kColThreads];
#pragma unroll
      for (int i = 0; i < kTM; ++i)
#pragma unroll
        for (int j = 0; j < kTN; ++j) acc[i][j] = fmaf(a[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int m = m0 + ty * kTM + i;
    if (m >= cout) continue;
    const float sc = scale[m], sh = shift[m];
    const size_t row = (static_cast<size_t>(b) * cout + m) * p;
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const int q = p0 + tx + j * kColThreads;
      if (q >= p) continue;
      float v = fmaf(acc[i][j], sc, sh);
      if (res != nullptr) v += to_f32(res[row + q]);
      if (relu) v = fmaxf(v, 0.f);
      y[row + q] = from_f32<T>(v);
    }
  }
}

template <typename T>
int launch(const void* x, const void* w, const void* scale, const void* shift, const void* res,
           void* y, int b, int cin, int cout, int p, int relu, void* stream) {
  const dim3 grid((p + kBN - 1) / kBN, (cout + kBM - 1) / kBM, b);
  conv1x1_bn_act_kernel<T><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<const float*>(scale),
      static_cast<const float*>(shift), static_cast<const T*>(res), static_cast<T*>(y), cin,
      cout, p, relu);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x [B, Cin, P], w [Cout, Cin], res (may be null) and y [B, Cout, P], all of
// one type: bf16 when `bf16` is non-zero, else f32. scale/shift f32 [Cout].
// Returns cudaGetLastError() after the launch.
extern "C" int nopesac_conv1x1_bn_act(const void* x, const void* w, const void* scale,
                                      const void* shift, const void* res, void* y, int b,
                                      int cin, int cout, int p, int relu, int bf16,
                                      void* stream) {
  if (bf16) return launch<__nv_bfloat16>(x, w, scale, shift, res, y, b, cin, cout, p, relu, stream);
  return launch<float>(x, w, scale, shift, res, y, b, cin, cout, p, relu, stream);
}
