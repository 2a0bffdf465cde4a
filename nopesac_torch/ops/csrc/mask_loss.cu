// Fused 4x bilinear upsample + sigmoid-focal + dice sums of matched mask
// logits, forward and backward.
//
// Replaces the TPU kernels of `fused_focal_dice` (`ops/mask_loss_pallas.py` of
// the JAX package: `_fwd_kernel` and `_bwd_kernel`). For each (batch, query)
// pair p with a matched GT mask index idx[p] >= 0:
//   z  = 4x bilinear upsample of src[p] [h, w] -> [4h, 4w] (half-pixel
//        centres, taps clamped at the edges)
//   t  = masks[idx[p]] (uint8 0/1)
//   forward:  sum alpha_t * BCE(z, t) * (1 - p_t)^2,  sum sigmoid(z) * t,
//             sum sigmoid(z),  sum t                  -> out [P, 4]
//   backward: dsrc[p] = A_h^T . dz . A_w with dz from the three incoming
//             gradients (sum t has none)              -> dsrc [P, h, w]
// Pairs with idx[p] < 0 (unmatched queries) give exact zeros both ways.
//
// What bounds it on the H100: operations. Each output pixel costs ~39 f32
// operations forward (a 2x2 stencil and the shared-exp focal/dice chain) and
// ~55 backward, against 5 bytes read (one f32 logit per 16 pixels, one uint8
// mask byte). The TPU kernel ran the upsample as two bf16 MXU matmuls with
// dense resize matrices; here the 4x upsample is a 2-tap stencil per
// direction computed in f32 straight from src, so no matrix is read and no
// [P, 4h, 4w] tensor is written.
// Design:
//   forward:  grid (row tiles, P). A block owns 4*kRowsPerTile output rows
//             of one pair; a thread owns one src column (4 output columns,
//             one uchar4 of the mask per output row). Unmatched pairs exit at
//             once. Sums reduce with warp shuffles, then across warps in
//             shared memory in a fixed order, into per-tile partials; a second
//             kernel adds the partials of each pair in tile order. No float
//             atomics: two runs give bit-equal sums.
//   backward: grid (col tiles, row tiles, P). A block owns a kBR x kBC tile
//             of src; it recomputes z and dz over the output pixels that read
//             the tile (its 4x image plus a 2-pixel halo) into shared memory,
//             then gathers the adjoint stencil (taps 1/8, 3/8, 5/8, 7/8 over
//             <= 8 output rows and columns), columns then rows. Every dsrc
//             element is written by exactly one thread; no atomics.
// Numerics: f32 throughout, expf/log1pf without fast-math.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRowsPerTile = 8;          // src rows per forward block
constexpr int kBR = 8, kBC = 32;         // src tile of a backward block
constexpr int kZR = 4 * kBR + 4;         // output rows it recomputes (2-pixel halo)
constexpr int kZC = 4 * kBC + 4;         // output columns it recomputes
constexpr int kBwdThreads = 256;

// Output index i of a 4x upsample of n inputs: the two clamped input taps and
// their weights (source position (i + 0.5) / 4 - 0.5).
__device__ __forceinline__ void taps(int i, int n, int& lo, int& hi, float& wlo, float& whi) {
  const int k = i >> 2, r = i & 3;
  const int l = (r < 2) ? k - 1 : k;
  const float frac = (r == 0) ? 0.625f : (r == 1) ? 0.875f : (r == 2) ? 0.125f : 0.375f;
  lo = max(l, 0);
  hi = min(l + 1, n - 1);
  wlo = 1.f - frac;
  whi = frac;
}

// Weight with which output index i reads input index k.
__device__ __forceinline__ float tap_weight(int i, int k, int n) {
  int lo, hi;
  float wlo, whi;
  taps(i, n, lo, hi, wlo, whi);
  return (lo == k ? wlo : 0.f) + (hi == k ? whi : 0.f);
}

// Columns first within each input row, then rows.
__device__ __forceinline__ float stencil(float a00, float a01, float a10, float a11,
                                         float ax, float bx, float ay, float by) {
  return ay * (ax * a00 + bx * a01) + by * (ax * a10 + bx * a11);
}

struct Terms {
  float prob, ce, pt, at;
};

// One shared exp for the sigmoid and the stable BCE.
__device__ __forceinline__ Terms elem_terms(float z, float t) {
  const float e = expf(-fabsf(z));
  const float r = 1.f / (1.f + e);
  Terms o;
  o.prob = z >= 0.f ? r : e * r;
  o.ce = fmaxf(z, 0.f) - z * t + log1pf(e);
  o.pt = o.prob * t + (1.f - o.prob) * (1.f - t);
  o.at = 0.25f * t + 0.75f * (1.f - t);
  return o;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__global__ void fwd_kernel(const float* __restrict__ src,      // [P, h, w]
                           const uint8_t* __restrict__ masks,  // [G, gh, gw]
                           const int* __restrict__ idx,        // [P]
                           float* __restrict__ partials,       // [P, tiles, 4]
                           int h, int w, int gh, int gw) {
  const int p = blockIdx.y;
  const int g = idx[p];
  if (g < 0) return;
  const float* s = src + static_cast<size_t>(p) * h * w;
  const uint8_t* m = masks + static_cast<size_t>(g) * gh * gw;
  const int i0 = blockIdx.x * 4 * kRowsPerTile;
  const int i1 = min(i0 + 4 * kRowsPerTile, gh);

  float f_sum = 0.f, inter = 0.f, psum = 0.f, tsum = 0.f;
  for (int c = threadIdx.x; c < w; c += blockDim.x) {
    int xl[4], xh[4];
    float ax[4], bx[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) taps(4 * c + r, w, xl[r], xh[r], ax[r], bx[r]);
    for (int i = i0; i < i1; ++i) {
      int yl, yh;
      float ay, by;
      taps(i, h, yl, yh, ay, by);
      const float* r0 = s + static_cast<size_t>(yl) * w;
      const float* r1 = s + static_cast<size_t>(yh) * w;
      const uchar4 t4 = *reinterpret_cast<const uchar4*>(m + static_cast<size_t>(i) * gw + 4 * c);
      const float tv[4] = {static_cast<float>(t4.x), static_cast<float>(t4.y),
                           static_cast<float>(t4.z), static_cast<float>(t4.w)};
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float z = stencil(r0[xl[r]], r0[xh[r]], r1[xl[r]], r1[xh[r]], ax[r], bx[r], ay, by);
        const float t = tv[r];
        const Terms e = elem_terms(z, t);
        const float q = 1.f - e.pt;
        f_sum += e.at * e.ce * q * q;
        inter += e.prob * t;
        psum += e.prob;
        tsum += t;
      }
    }
  }

  __shared__ float red[32][4];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const float v[4] = {warp_sum(f_sum), warp_sum(inter), warp_sum(psum), warp_sum(tsum)};
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < 4; ++k) red[warp][k] = v[k];
  }
  __syncthreads();
  if (threadIdx.x < 4) {
    float acc = 0.f;
    const int nw = (blockDim.x + 31) >> 5;
    for (int k = 0; k < nw; ++k) acc += red[k][threadIdx.x];
    partials[(static_cast<size_t>(p) * gridDim.x + blockIdx.x) * 4 + threadIdx.x] = acc;
  }
}

__global__ void fwd_finish_kernel(const float* __restrict__ partials,  // [P, tiles, 4]
                                  const int* __restrict__ idx,         // [P]
                                  float* __restrict__ out,             // [P, 4]
                                  int n_pairs, int tiles) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n_pairs * 4) return;
  const int p = e >> 2, k = e & 3;
  float acc = 0.f;
  if (idx[p] >= 0) {
    for (int t = 0; t < tiles; ++t) acc += partials[(static_cast<size_t>(p) * tiles + t) * 4 + k];
  }
  out[e] = acc;
}

__global__ void __launch_bounds__(kBwdThreads)
bwd_kernel(const float* __restrict__ src,      // [P, h, w]
           const uint8_t* __restrict__ masks,  // [G, gh, gw]
           const int* __restrict__ idx,        // [P]
           const float* __restrict__ grad,     // [P, 3]: d/d(focal, inter, psum)
           float* __restrict__ dsrc,           // [P, h, w]
           int h, int w, int gh, int gw) {
  const int p = blockIdx.z;
  const int k0 = blockIdx.y * kBR, c0 = blockIdx.x * kBC;
  const int tid = threadIdx.x;
  float* ds = dsrc + static_cast<size_t>(p) * h * w;
  const int g = idx[p];
  if (g < 0) {
    for (int e = tid; e < kBR * kBC; e += blockDim.x) {
      const int k = k0 + e / kBC, c = c0 + e % kBC;
      if (k < h && c < w) ds[static_cast<size_t>(k) * w + c] = 0.f;
    }
    return;
  }
  const float* s = src + static_cast<size_t>(p) * h * w;
  const uint8_t* m = masks + static_cast<size_t>(g) * gh * gw;

  __shared__ float s_src[kBR + 2][kBC + 2];  // src rows k0-1.., cols c0-1.. (clamped)
  __shared__ float s_dz[kZR][kZC];           // dz of output rows 4k0-2.., cols 4c0-2..
  __shared__ float s_col[kZR][kBC];          // dz gathered along the columns

  for (int e = tid; e < (kBR + 2) * (kBC + 2); e += blockDim.x) {
    const int rr = e / (kBC + 2), cc = e % (kBC + 2);
    const int gr = min(max(k0 - 1 + rr, 0), h - 1);
    const int gc = min(max(c0 - 1 + cc, 0), w - 1);
    s_src[rr][cc] = s[static_cast<size_t>(gr) * w + gc];
  }
  __syncthreads();

  const float gf = grad[3 * p], gi = grad[3 * p + 1], gp = grad[3 * p + 2];
  const int i_base = 4 * k0 - 2, j_base = 4 * c0 - 2;
  for (int e = tid; e < kZR * kZC; e += blockDim.x) {
    const int ri = e / kZC, cj = e % kZC;
    const int i = i_base + ri, j = j_base + cj;
    float dz = 0.f;
    if (i >= 0 && i < gh && j >= 0 && j < gw) {
      int yl, yh, xl, xh;
      float ay, by, ax, bx;
      taps(i, h, yl, yh, ay, by);
      taps(j, w, xl, xh, ax, bx);
      yl -= k0 - 1;
      yh -= k0 - 1;
      xl -= c0 - 1;
      xh -= c0 - 1;
      const float z = stencil(s_src[yl][xl], s_src[yl][xh], s_src[yh][xl], s_src[yh][xh],
                              ax, bx, ay, by);
      const float t = static_cast<float>(m[static_cast<size_t>(i) * gw + j]);
      const Terms o = elem_terms(z, t);
      const float q = 1.f - o.pt;
      const float pq = o.prob * (1.f - o.prob);
      const float dfocal = o.at * (q * q * (o.prob - t) - 2.f * q * (2.f * t - 1.f) * pq * o.ce);
      dz = gf * dfocal + (gi * t + gp) * pq;
    }
    s_dz[ri][cj] = dz;
  }
  __syncthreads();

  for (int e = tid; e < kZR * kBC; e += blockDim.x) {
    const int ri = e / kBC, cc = e % kBC;
    const int c = c0 + cc;
    float acc = 0.f;
    if (c < w) {
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const int j = 4 * c - 2 + jj;
        if (j >= 0 && j < gw) acc += tap_weight(j, c, w) * s_dz[ri][4 * cc + jj];
      }
    }
    s_col[ri][cc] = acc;
  }
  __syncthreads();

  for (int e = tid; e < kBR * kBC; e += blockDim.x) {
    const int rr = e / kBC, cc = e % kBC;
    const int k = k0 + rr, c = c0 + cc;
    if (k >= h || c >= w) continue;
    float acc = 0.f;
#pragma unroll
    for (int ii = 0; ii < 8; ++ii) {
      const int i = 4 * k - 2 + ii;
      if (i >= 0 && i < gh) acc += tap_weight(i, k, h) * s_col[4 * rr + ii][cc];
    }
    ds[static_cast<size_t>(k) * w + c] = acc;
  }
}

int fwd_threads(int w) {
  const int t = ((w + 31) / 32) * 32;
  return t < 256 ? t : 256;
}

}  // namespace

// src f32 [P, h, w]; masks u8 [G, 4h, 4w]; idx i32 [P] (mask index or -1);
// partials f32 [P, tiles, 4] scratch with tiles = ceil(4h / (4 * 8));
// out f32 [P, 4]. Returns cudaGetLastError() after the launches.
extern "C" int nopesac_mask_loss_fwd(const void* src, const void* masks, const void* idx,
                                     void* partials, void* out, int n_pairs, int h, int w,
                                     void* stream) {
  const int gh = 4 * h, gw = 4 * w;
  const int tiles = (gh + 4 * kRowsPerTile - 1) / (4 * kRowsPerTile);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  fwd_kernel<<<dim3(tiles, n_pairs), fwd_threads(w), 0, st>>>(
      static_cast<const float*>(src), static_cast<const uint8_t*>(masks),
      static_cast<const int*>(idx), static_cast<float*>(partials), h, w, gh, gw);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n = n_pairs * 4;
  fwd_finish_kernel<<<(n + 255) / 256, 256, 0, st>>>(
      static_cast<const float*>(partials), static_cast<const int*>(idx),
      static_cast<float*>(out), n_pairs, tiles);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int nopesac_mask_loss_tiles(int h) {
  return (4 * h + 4 * kRowsPerTile - 1) / (4 * kRowsPerTile);
}

// grad f32 [P, 3]; dsrc f32 [P, h, w] (every element written).
extern "C" int nopesac_mask_loss_bwd(const void* src, const void* masks, const void* idx,
                                     const void* grad, void* dsrc, int n_pairs, int h, int w,
                                     void* stream) {
  const dim3 grid((w + kBC - 1) / kBC, (h + kBR - 1) / kBR, n_pairs);
  bwd_kernel<<<grid, kBwdThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(src), static_cast<const uint8_t*>(masks),
      static_cast<const int*>(idx), static_cast<const float*>(grad),
      static_cast<float*>(dsrc), h, w, 4 * h, 4 * w);
  return static_cast<int>(cudaGetLastError());
}
