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
// What bounds it on the H100: instruction throughput. Each output pixel of a
// matched pair reads one mask byte and 1/16 of a logit, and costs ~39 f32
// operations forward and ~55 backward as the bound counts them (expf, log1pf
// and the reciprocal one each). Compiled under IEEE math these are several
// instructions each (log1pf the most), and the per-pixel chain is the whole
// cost: 118 M pixels at the train step's shape over the card's ~29.6 T
// lane-instructions/s (132 SMs x 128 lanes x 1.755 GHz) give ~0.4 ms forward
// and ~0.5 ms backward at ~100 and ~125 instructions per pixel.
//
// Upsample geometry. Output row i = 4g - 2 + r (r = 0..3) lies in "gap" g
// between src rows g - 1 and g (clamped to [0, h)) with weights
// (1 - f, f), f = 1/8, 3/8, 5/8, 7/8; gaps 0..h cover the 4h rows. Output
// column 4c + r reads src columns (c - 1, c) for r < 2 and (c, c + 1) for
// r >= 2 with the same weights. The adjoint therefore reads, for src index c,
// outputs 4c-2 .. 4c+5 with the constant weights 1/8, 3/8, 5/8, 7/8, 7/8,
// 5/8, 3/8, 1/8; at c = 0 the two outputs 0, 1 and at c = n-1 the outputs
// 4n-2, 4n-1 carry weight 1 (their clamped tap adds the missing part) and
// the outputs beyond the edge do not exist (`upsample4_adjoint` in
// `ops/mask_loss.py` is the same table in PyTorch).
//
// Design:
//   - A one-block scan compacts idx on the device into the matched pair ids,
//     then the unmatched ones, each in increasing order, and their counts;
//     no host sync.
//   - Both passes run a persistent grid (the blocks of 256 threads that fit
//     on the SMs at once) whose warps walk work units (matched pair, tile of
//     rows) up to the device-side count. A warp owns every src column of its
//     unit, lane l the columns l, l + 32, ..., so the logits are read
//     coalesced and no column is recomputed.
//   - The horizontal 4x interpolation of each src row is computed once per
//     unit, into a per-warp shared-memory row of float4s; two rows roll down
//     the unit, so an output pixel is one vertical lerp of two LDS.128 values.
//     The per-pixel chain sits in a loop over the lane's columns that is not
//     unrolled: unrolled over 4 output rows x 5 columns x 4 pixels (~4000
//     instructions per loop body, beyond the instruction cache) it ran
//     slower than a plain tiled kernel.
//   - Forward: a unit is one gap (4 output rows), so that the units (384 x
//     121 at the train step's shape) spread evenly over the persistent warps
//     (5280 on the H100 at 5 blocks per SM, 8.8 rounds). The mask comes as one
//     uchar4 per lane and output row (a warp reads 128 contiguous bytes; a
//     lane's 4 output columns share one src column). The unit's sums reduce
//     by warp shuffles into per-unit partials; a second kernel adds a pair's
//     partials in unit order. No float atomics: two runs give bit-equal sums.
//   - Backward: a unit is 16 src rows; it recomputes z and dz over the 17
//     gaps that reach them (1/16 = 6% of the rows are recomputed by two
//     units, no column halo). Each output row's dz goes to a per-warp
//     shared row with zero pads at both ends; the column adjoint reads it
//     with three LDS.128 per src column from the constant table, and the row
//     adjoint accumulates into two rolling rows of register accumulators
//     (NC = ceil(w / 32) per lane, a template parameter); each dsrc element
//     is written once, by one lane. The same grid then fills the unmatched
//     pairs' dsrc with zeros (float4 stores).
// Numerics: f32 throughout, IEEE expf/log1pf, and the reciprocal as
// __frcp_rn, which is the correctly rounded 1/x that the IEEE division gives.
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kFwdGaps = 1;    // gaps (4 output rows each) per forward unit
constexpr int kBwdRows = 16;   // src rows per backward unit
constexpr int kMaxNC = 8;      // src columns per lane: w <= 256 (ops/mask_loss.py:MAX_WIDTH)
constexpr int kScanThreads = 1024;

struct Terms {
  float prob, ce, pt, at;
};

// One shared exp for the sigmoid and the stable BCE.
__device__ __forceinline__ Terms elem_terms(float z, float t) {
  const float e = expf(-fabsf(z));
  const float r = __frcp_rn(1.f + e);
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

// The horizontal 4x interpolation of src row `row` into out[c] (output
// columns 4c .. 4c + 3, taps clamped), c = lane, lane + 32, ...
__device__ __forceinline__ void hrow(const float* __restrict__ row, int w, int lane,
                                     float4* __restrict__ out) {
  for (int c = lane; c < w; c += 32) {
    const float v = __ldg(row + c);
    const float l = __ldg(row + max(c - 1, 0));
    const float r = __ldg(row + min(c + 1, w - 1));
    out[c] = make_float4(0.375f * l + 0.625f * v, 0.125f * l + 0.875f * v,
                         0.875f * v + 0.125f * r, 0.625f * v + 0.375f * r);
  }
}

__global__ void __launch_bounds__(kScanThreads)
compact_kernel(const int* __restrict__ idx, int n, int* __restrict__ work) {
  // work [0, n): matched pair ids; [n, 2n): unmatched ids; [2n], [2n + 1]: counts
  __shared__ int tot_m[32], tot_u[32];
  const int tid = threadIdx.x, lane = tid & 31, wid = tid >> 5;
  const int nw = blockDim.x >> 5;
  const unsigned lt = (1u << lane) - 1u;
  int base_m = 0, base_u = 0;
  for (int start = 0; start < n; start += blockDim.x) {
    const int i = start + tid;
    const bool valid = i < n;
    const bool m = valid && idx[i] >= 0;
    const unsigned bm = __ballot_sync(0xffffffffu, m);
    const unsigned bu = __ballot_sync(0xffffffffu, valid && !m);
    if (lane == 0) {
      tot_m[wid] = __popc(bm);
      tot_u[wid] = __popc(bu);
    }
    __syncthreads();
    int off_m = 0, off_u = 0, all_m = 0, all_u = 0;
    for (int k = 0; k < nw; ++k) {
      if (k < wid) off_m += tot_m[k], off_u += tot_u[k];
      all_m += tot_m[k];
      all_u += tot_u[k];
    }
    if (m) work[base_m + off_m + __popc(bm & lt)] = i;
    else if (valid) work[n + base_u + off_u + __popc(bu & lt)] = i;
    base_m += all_m;
    base_u += all_u;
    __syncthreads();
  }
  if (tid == 0) {
    work[2 * n] = base_m;
    work[2 * n + 1] = base_u;
  }
}

// Shared memory of one warp: two H rows of w float4 (forward and backward)
// and, backward, one dz row of 4w floats between 4-float zero pads.
__host__ __device__ constexpr int fwd_warp_floats(int w) { return 8 * w; }
__host__ __device__ constexpr int bwd_warp_floats(int w) { return 8 * w + 4 * w + 8; }

__global__ void __launch_bounds__(kThreads)
fwd_kernel(const float* __restrict__ src,      // [P, h, w]
           const uint8_t* __restrict__ masks,  // [G, gh, gw]
           const int* __restrict__ idx,        // [P]
           const int* __restrict__ work,       // compact_kernel's output
           float* __restrict__ partials,       // [P, tiles, 4]
           int n_pairs, int h, int w, int tiles) {
  extern __shared__ float4 smem4[];
  const int gh = 4 * h, gw = 4 * w;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float4* const hbuf = smem4 + warp * (fwd_warp_floats(w) / 4);  // [2][w]
  const int n_units = work[2 * n_pairs] * tiles;
  for (int unit = blockIdx.x * kWarps + warp; unit < n_units; unit += gridDim.x * kWarps) {
    const int p = work[unit / tiles], tile = unit % tiles;
    const float* s = src + static_cast<size_t>(p) * h * w;
    const uint8_t* m = masks + static_cast<size_t>(idx[p]) * gh * gw;
    const int g0 = tile * kFwdGaps, g1 = min(g0 + kFwdGaps, h + 1);
    int prev = 0;
    __syncwarp();
    hrow(s + static_cast<size_t>(max(g0 - 1, 0)) * w, w, lane, hbuf);
    float f_sum = 0.f, inter = 0.f, psum = 0.f, tsum = 0.f;
    for (int g = g0; g < g1; ++g) {
      const float4* hlo = hbuf + prev * w;
      float4* hhi = hbuf + (prev ^ 1) * w;
      hrow(s + static_cast<size_t>(min(g, h - 1)) * w, w, lane, hhi);
      __syncwarp();
#pragma unroll 1
      for (int r = 0; r < 4; ++r) {
        const int i = 4 * g - 2 + r;
        if (i < 0 || i >= gh) continue;
        const float by = 0.125f + 0.25f * r, ay = 1.f - by;
        const uchar4* mrow = reinterpret_cast<const uchar4*>(m + static_cast<size_t>(i) * gw);
        for (int c = lane; c < w; c += 32) {
          const float4 lo = hlo[c], hi = hhi[c];
          const uchar4 t4 = mrow[c];
          const float zs[4] = {ay * lo.x + by * hi.x, ay * lo.y + by * hi.y,
                               ay * lo.z + by * hi.z, ay * lo.w + by * hi.w};
          const float tv[4] = {static_cast<float>(t4.x), static_cast<float>(t4.y),
                               static_cast<float>(t4.z), static_cast<float>(t4.w)};
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const float t = tv[q];
            const Terms e = elem_terms(zs[q], t);
            const float d = 1.f - e.pt;
            f_sum += e.at * e.ce * d * d;
            inter += e.prob * t;
            psum += e.prob;
            tsum += t;
          }
        }
      }
      __syncwarp();  // the lo row is rewritten by the next gap
      prev ^= 1;
    }
    const float v[4] = {warp_sum(f_sum), warp_sum(inter), warp_sum(psum), warp_sum(tsum)};
    if (lane < 4) partials[(static_cast<size_t>(p) * tiles + tile) * 4 + lane] = v[lane];
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

template <int NC>
__global__ void __launch_bounds__(kThreads)
bwd_kernel(const float* __restrict__ src,      // [P, h, w]
           const uint8_t* __restrict__ masks,  // [G, gh, gw]
           const int* __restrict__ idx,        // [P]
           const int* __restrict__ work,       // compact_kernel's output
           const float* __restrict__ grad,     // [P, 3]: d/d(focal, inter, psum)
           float* __restrict__ dsrc,           // [P, h, w]
           int n_pairs, int h, int w) {
  extern __shared__ float4 smem4[];
  const int gh = 4 * h, gw = 4 * w;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float4* const hbuf = smem4 + warp * (bwd_warp_floats(w) / 4);  // [2][w]
  // dz of output columns -4 .. 4w + 3: dz4[c + 1] holds columns 4c .. 4c + 3,
  // dz4[0] and dz4[w + 1] stay zero
  float4* const dz4 = hbuf + 2 * w;
  if (lane == 0) dz4[0] = dz4[w + 1] = make_float4(0.f, 0.f, 0.f, 0.f);
  const int tiles = (h + kBwdRows - 1) / kBwdRows;
  const int n_units = work[2 * n_pairs] * tiles;
  for (int unit = blockIdx.x * kWarps + warp; unit < n_units; unit += gridDim.x * kWarps) {
    const int p = work[unit / tiles], tile = unit % tiles;
    const float* s = src + static_cast<size_t>(p) * h * w;
    const uint8_t* m = masks + static_cast<size_t>(idx[p]) * gh * gw;
    float* ds = dsrc + static_cast<size_t>(p) * h * w;
    const float gf = grad[3 * p], gi = grad[3 * p + 1], gp = grad[3 * p + 2];
    const int k0 = tile * kBwdRows, k1 = min(k0 + kBwdRows, h);
    int prev = 0;
    __syncwarp();
    hrow(s + static_cast<size_t>(max(k0 - 1, 0)) * w, w, lane, hbuf);
    float acc_lo[NC], acc_hi[NC];  // src rows g - 1 and g of this lane's columns
#pragma unroll
    for (int j = 0; j < NC; ++j) acc_lo[j] = acc_hi[j] = 0.f;
    for (int g = k0; g <= k1; ++g) {
      const float4* hlo = hbuf + prev * w;
      float4* hhi = hbuf + (prev ^ 1) * w;
      hrow(s + static_cast<size_t>(min(g, h - 1)) * w, w, lane, hhi);
      __syncwarp();
#pragma unroll 1
      for (int r = 0; r < 4; ++r) {
        const int i = 4 * g - 2 + r;
        if (i < 0 || i >= gh) continue;
        const float by = 0.125f + 0.25f * r, ay = 1.f - by;
        const uchar4* mrow = reinterpret_cast<const uchar4*>(m + static_cast<size_t>(i) * gw);
        for (int c = lane; c < w; c += 32) {
          const float4 lo = hlo[c], hi = hhi[c];
          const uchar4 t4 = mrow[c];
          const float zs[4] = {ay * lo.x + by * hi.x, ay * lo.y + by * hi.y,
                               ay * lo.z + by * hi.z, ay * lo.w + by * hi.w};
          const float tv[4] = {static_cast<float>(t4.x), static_cast<float>(t4.y),
                               static_cast<float>(t4.z), static_cast<float>(t4.w)};
          float dz[4];
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const float t = tv[q];
            const Terms o = elem_terms(zs[q], t);
            const float d = 1.f - o.pt;
            const float pq = o.prob * (1.f - o.prob);
            const float dfocal =
                o.at * (d * d * (o.prob - t) - 2.f * d * (2.f * t - 1.f) * pq * o.ce);
            dz[q] = gf * dfocal + (gi * t + gp) * pq;
          }
          dz4[c + 1] = make_float4(dz[0], dz[1], dz[2], dz[3]);
        }
        __syncwarp();
        // row weights of this output row onto src rows g - 1 and g; a clamped
        // tap (g = 0 or g = h) puts both on the one row
        float wlo = ay, whi = by;
        if (g == 0) whi += wlo, wlo = 0.f;
        if (g == h) wlo += whi, whi = 0.f;
#pragma unroll
        for (int j = 0; j < NC; ++j) {
          const int c = lane + 32 * j;
          if (c >= w) continue;
          // the constant adjoint table over output columns 4c-2 .. 4c+5 (the
          // zero pads stand for the columns past the edges), with the edge
          // fix-ups of the two columns next to an edge
          const float4 a = dz4[c], d = dz4[c + 1], b = dz4[c + 2];
          const bool first = c == 0, last = c == w - 1;
          const float col = 0.125f * a.z + 0.375f * a.w + (first ? 1.f : 0.625f) * d.x
                            + (first ? 1.f : 0.875f) * d.y + (last ? 1.f : 0.875f) * d.z
                            + (last ? 1.f : 0.625f) * d.w + 0.375f * b.x + 0.125f * b.y;
          acc_lo[j] += wlo * col;
          acc_hi[j] += whi * col;
        }
        __syncwarp();  // the dz row is rewritten by the next output row
      }
      if (g - 1 >= k0) {
        float* row = ds + static_cast<size_t>(g - 1) * w;
#pragma unroll
        for (int j = 0; j < NC; ++j) {
          const int c = lane + 32 * j;
          if (c < w) row[c] = acc_lo[j];
        }
      }
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        acc_lo[j] = acc_hi[j];
        acc_hi[j] = 0.f;
      }
      __syncwarp();  // the lo row is rewritten by the next gap
      prev ^= 1;
    }
  }
  // zeros for the unmatched pairs
  const int n_unmatched = work[2 * n_pairs + 1];
  const int hw = h * w;
  for (int q = blockIdx.x; q < n_unmatched; q += gridDim.x) {
    float* ds = dsrc + static_cast<size_t>(work[n_pairs + q]) * hw;
    if ((hw & 3) == 0) {
      float4* d4 = reinterpret_cast<float4*>(ds);
      for (int e = threadIdx.x; e < hw / 4; e += blockDim.x) d4[e] = make_float4(0.f, 0.f, 0.f, 0.f);
    } else {
      for (int e = threadIdx.x; e < hw; e += blockDim.x) ds[e] = 0.f;
    }
  }
}

// The persistent grid: as many blocks as fit on the SMs at once with `smem`
// bytes of dynamic shared memory each.
template <typename K>
int persistent_blocks(K kern, int smem, int* blocks) {
  int dev, sms, per;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e == cudaSuccess) e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per, kern, kThreads, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  *blocks = sms * (per > 0 ? per : 1);
  return 0;
}

int fwd_tiles(int h) { return (h + 1 + kFwdGaps - 1) / kFwdGaps; }

int run_fwd(const float* src, const uint8_t* masks, const int* idx, int* work, float* partials,
            float* out, int n_pairs, int h, int w, cudaStream_t st) {
  const int smem = kWarps * fwd_warp_floats(w) * 4;
  int blocks;
  int e = persistent_blocks(fwd_kernel, smem, &blocks);
  if (e) return e;
  const int tiles = fwd_tiles(h);
  const int grid = std::min(blocks, (n_pairs * tiles + kWarps - 1) / kWarps);
  compact_kernel<<<1, kScanThreads, 0, st>>>(idx, n_pairs, work);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  fwd_kernel<<<grid, kThreads, smem, st>>>(src, masks, idx, work, partials, n_pairs, h, w, tiles);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n = n_pairs * 4;
  fwd_finish_kernel<<<(n + 255) / 256, 256, 0, st>>>(partials, idx, out, n_pairs, tiles);
  return static_cast<int>(cudaGetLastError());
}

template <int NC>
int run_bwd(const float* src, const uint8_t* masks, const int* idx, int* work, const float* grad,
            float* dsrc, int n_pairs, int h, int w, cudaStream_t st) {
  const int smem = kWarps * bwd_warp_floats(w) * 4;
  int blocks;
  int e = persistent_blocks(bwd_kernel<NC>, smem, &blocks);
  if (e) return e;
  const int tiles = (h + kBwdRows - 1) / kBwdRows;
  const int grid = std::min(blocks, std::max((n_pairs * tiles + kWarps - 1) / kWarps, n_pairs));
  compact_kernel<<<1, kScanThreads, 0, st>>>(idx, n_pairs, work);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  bwd_kernel<NC><<<grid, kThreads, smem, st>>>(src, masks, idx, work, grad, dsrc, n_pairs, h, w);
  return static_cast<int>(cudaGetLastError());
}

int cols_per_lane(int w) { return w <= 32 * kMaxNC ? (w + 31) / 32 : 0; }

}  // namespace

// src f32 [P, h, w]; masks u8 [G, 4h, 4w] (4-byte aligned); idx i32 [P] (mask
// index or -1); work i32 [2P + 2] scratch; partials f32 [P, tiles, 4] scratch
// with tiles = nopesac_mask_loss_tiles(h); out f32 [P, 4]. w <= 256.
// Returns cudaGetLastError() after the launches.
extern "C" int nopesac_mask_loss_fwd(const void* src, const void* masks, const void* idx,
                                     void* work, void* partials, void* out, int n_pairs, int h,
                                     int w, void* stream) {
  if (cols_per_lane(w) == 0) return static_cast<int>(cudaErrorInvalidValue);
  return run_fwd(static_cast<const float*>(src), static_cast<const uint8_t*>(masks),
                 static_cast<const int*>(idx), static_cast<int*>(work),
                 static_cast<float*>(partials), static_cast<float*>(out), n_pairs, h, w,
                 static_cast<cudaStream_t>(stream));
}

extern "C" int nopesac_mask_loss_tiles(int h) { return fwd_tiles(h); }

// grad f32 [P, 3]; work i32 [2P + 2] scratch; dsrc f32 [P, h, w] (every
// element written: zeros for the unmatched pairs). w <= 256.
extern "C" int nopesac_mask_loss_bwd(const void* src, const void* masks, const void* idx,
                                     void* work, const void* grad, void* dsrc, int n_pairs,
                                     int h, int w, void* stream) {
#define NOPESAC_BWD(NC)                                                                         \
  return run_bwd<NC>(static_cast<const float*>(src), static_cast<const uint8_t*>(masks),      \
                     static_cast<const int*>(idx), static_cast<int*>(work),                   \
                     static_cast<const float*>(grad), static_cast<float*>(dsrc), n_pairs, h,  \
                     w, static_cast<cudaStream_t>(stream))
  switch (cols_per_lane(w)) {
    case 1: NOPESAC_BWD(1);
    case 2: NOPESAC_BWD(2);
    case 3: NOPESAC_BWD(3);
    case 4: NOPESAC_BWD(4);
    case 5: NOPESAC_BWD(5);
    case 6: NOPESAC_BWD(6);
    case 7: NOPESAC_BWD(7);
    case 8: NOPESAC_BWD(8);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef NOPESAC_BWD
}

// Registers, static shared bytes, dynamic shared bytes, local (spill) bytes
// and resident blocks per SM of the forward (which 0) or backward (1) kernel
// at width w, into out[0..4]. Returns a cudaError_t.
namespace {
template <typename K>
int attrs(K kern, int smem, int* out) {
  cudaFuncAttributes a;
  int per = 0;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&a, kern);
  if (e == cudaSuccess) e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per, kern, kThreads, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  out[0] = a.numRegs;
  out[1] = static_cast<int>(a.sharedSizeBytes);
  out[2] = smem;
  out[3] = static_cast<int>(a.localSizeBytes);
  out[4] = per;
  return 0;
}
}  // namespace

extern "C" int nopesac_mask_loss_attrs(int which, int w, int* out) {
  if (which == 0) return attrs(fwd_kernel, kWarps * fwd_warp_floats(w) * 4, out);
  const int smem = kWarps * bwd_warp_floats(w) * 4;
  switch (cols_per_lane(w)) {
    case 1: return attrs(bwd_kernel<1>, smem, out);
    case 2: return attrs(bwd_kernel<2>, smem, out);
    case 3: return attrs(bwd_kernel<3>, smem, out);
    case 4: return attrs(bwd_kernel<4>, smem, out);
    case 5: return attrs(bwd_kernel<5>, smem, out);
    case 6: return attrs(bwd_kernel<6>, smem, out);
    case 7: return attrs(bwd_kernel<7>, smem, out);
    case 8: return attrs(bwd_kernel<8>, smem, out);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
