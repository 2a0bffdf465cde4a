// Fused mask upsample + per-pixel argmax + per-query plane statistics.
//
// Replaces the TPU kernel `_fused_select_maps_pallas` (`ops/select_pallas.py`
// of the JAX package). Per view it upsamples the per-query mask probabilities
// [NQ, h, w] (bf16) by 4 with bilinear, half-pixel
// (align_corners=False) taps, scores them (valid: score * prob, invalid: -1),
// and keeps the per-pixel argmax/max over queries plus 7 per-query stats:
//   0 cnt_gate   |{seg==q & max>thr}|     3 cnt_nogate |{seg==q}|
//   1 sumx_gate  sum of x/W over it       4 sumx_nogate
//   2 sumy_gate  sum of y/H over it       5 sumy_nogate
//   6 orig_count |{up(prob_q) >= thr}|
// No [B, NQ, H, W] tensor is ever written.
//
// What bounds it on the H100: arithmetic and bytes about equally. Per output
// pixel and query the function needs one row 2-tap (3 f32 operations), the
// score product (1) and 3/4 of a column 2-tap (2.25: a low-res pixel's column
// taps of its 3 neighbourhood rows serve its 4 output rows), 6.25 in all, so
// at the main-path shape ([8,50,120,160] -> 480x640) ~0.77 GFLOP against
// ~35 MB of traffic: the operation bound is ~10% above the byte bound.
// Design: one thread per low-res pixel owns its SHxSW output pixels and keeps
// their running (max, argmax) in registers while it loops over the queries,
// reading only a 3x3 bf16 neighbourhood per query (neighbours share it
// through L1). The full-resolution per-query maps never leave registers.
// Stats are reduced per block in shared memory (runs of equal labels are
// merged per thread first) and pushed with one 64-bit global atomic per
// non-zero slot; coordinate sums are exact integers, scaled at the end.
//
// Bit-equality with the plain version (F.interpolate + argmax/max): every
// output pixel is computed with ATen's upsample_bilinear2d index, lambda and
// tap order (columns within a row first, then rows), including its edge rule
// (source index clamped at 0, second tap collapsed at the last row/col).
// Products of bf16 inputs with the 4x tap weights (multiples of 1/8) are
// exact in f32, so each column 2-tap sum is the correctly rounded sum.
// The argmax keeps the first index (strict >), the maximum starts at -2 so a
// view whose queries are all invalid gets label 0.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kNStat = 7;
constexpr int kTx = 32;  // low-res columns per block
constexpr int kTy = 8;   // low-res rows per block

struct Taps {
  int s0, s1;   // neighbourhood slot (0: prev, 1: same, 2: next) of the two taps
  float l0, l1; // their weights
};

// ATen upsample_bilinear2d (align_corners=False) for output index `o`:
// src = max(scale * (o + 0.5) - 0.5, 0); i0 = floor(src); i1 = i0 + (i0 < in-1)
__device__ __forceinline__ Taps make_taps(int o, int i, int in_size, float scale) {
  float src = scale * (static_cast<float>(o) + 0.5f) - 0.5f;
  src = src < 0.f ? 0.f : src;
  const int i0 = static_cast<int>(src);
  const int p = (i0 < in_size - 1) ? 1 : 0;
  Taps t;
  t.l1 = src - static_cast<float>(i0);
  t.l0 = 1.f - t.l1;
  t.s0 = i0 - i + 1;
  t.s1 = i0 + p - i + 1;
  return t;
}

__device__ __forceinline__ float pick3(int s, float a, float b, float c) {
  return s == 0 ? a : (s == 1 ? b : c);
}

// per-thread run-length merge of equal labels before the shared atomics
struct Run {
  int q = -1;
  int cg = 0, xg = 0, yg = 0, cn = 0, xn = 0, yn = 0;
  __device__ void flush(int* s_stat, int nq) {
    if (q < 0) return;
    if (cn) {
      atomicAdd(&s_stat[3 * nq + q], cn);
      atomicAdd(&s_stat[4 * nq + q], xn);
      atomicAdd(&s_stat[5 * nq + q], yn);
    }
    if (cg) {
      atomicAdd(&s_stat[0 * nq + q], cg);
      atomicAdd(&s_stat[1 * nq + q], xg);
      atomicAdd(&s_stat[2 * nq + q], yg);
    }
    cg = xg = yg = cn = xn = yn = 0;
  }
};

template <int SH, int SW>
__global__ void __launch_bounds__(kTx * kTy)
select_maps_kernel(const __nv_bfloat16* __restrict__ prob,  // [B, NQ, h, w]
                   const float* __restrict__ score,          // [B, NQ]
                   const uint8_t* __restrict__ valid,        // [B, NQ]
                   int32_t* __restrict__ seg,                // [B, H, W]
                   float* __restrict__ mx_out,               // [B, H, W]
                   unsigned long long* __restrict__ acc,     // [B, 7, NQ]
                   int nq, int h, int w, float thr) {
  extern __shared__ int s_stat[];  // [7, NQ]
  const int out_h = h * SH, out_w = w * SW;
  const int b = blockIdx.z;
  const int j = blockIdx.x * kTx + threadIdx.x;
  const int i = blockIdx.y * kTy + threadIdx.y;
  const int tid = threadIdx.y * kTx + threadIdx.x;
  const bool active = (i < h) && (j < w);

  for (int k = tid; k < kNStat * nq; k += kTx * kTy) s_stat[k] = 0;
  __syncthreads();

  // clamped 3x3 neighbourhood; inactive threads read a valid pixel and
  // contribute nothing (they still take part in the warp reductions)
  const int ic = min(i, h - 1), jc = min(j, w - 1);
  const int rows[3] = {max(ic - 1, 0), ic, min(ic + 1, h - 1)};
  const int cols[3] = {max(jc - 1, 0), jc, min(jc + 1, w - 1)};

  const float rscale = static_cast<float>(h) / static_cast<float>(out_h);
  const float cscale = static_cast<float>(w) / static_cast<float>(out_w);
  Taps rt[SH], ct[SW];
#pragma unroll
  for (int dy = 0; dy < SH; ++dy) rt[dy] = make_taps(ic * SH + dy, ic, h, rscale);
#pragma unroll
  for (int dx = 0; dx < SW; ++dx) ct[dx] = make_taps(jc * SW + dx, jc, w, cscale);

  float best[SH * SW];
  int arg[SH * SW];
#pragma unroll
  for (int k = 0; k < SH * SW; ++k) { best[k] = -2.f; arg[k] = 0; }

  const size_t plane = static_cast<size_t>(h) * w;
  const __nv_bfloat16* pb = prob + static_cast<size_t>(b) * nq * plane;
  const int lane = tid & 31;

  for (int q = 0; q < nq; ++q) {
    const __nv_bfloat16* pq = pb + q * plane;
    float n[3][3];
#pragma unroll
    for (int r = 0; r < 3; ++r)
#pragma unroll
      for (int c = 0; c < 3; ++c)
        n[r][c] = __bfloat162float(pq[rows[r] * w + cols[c]]);

    // column taps of the three rows: exact products, correctly rounded sums
    float colv[3][SW];
#pragma unroll
    for (int r = 0; r < 3; ++r)
#pragma unroll
      for (int dx = 0; dx < SW; ++dx)
        colv[r][dx] = ct[dx].l0 * pick3(ct[dx].s0, n[r][0], n[r][1], n[r][2]) +
                      ct[dx].l1 * pick3(ct[dx].s1, n[r][0], n[r][1], n[r][2]);

    const float s = score[b * nq + q];
    const bool v = valid[b * nq + q] != 0;
    unsigned over = 0;
#pragma unroll
    for (int dy = 0; dy < SH; ++dy) {
#pragma unroll
      for (int dx = 0; dx < SW; ++dx) {
        const float top = pick3(rt[dy].s0, colv[0][dx], colv[1][dx], colv[2][dx]);
        const float bot = pick3(rt[dy].s1, colv[0][dx], colv[1][dx], colv[2][dx]);
        const float up = rt[dy].l0 * top + rt[dy].l1 * bot;
        over += (up >= thr) ? 1u : 0u;
        const float g = v ? up * s : -1.f;
        const int k = dy * SW + dx;
        if (g > best[k]) { best[k] = g; arg[k] = q; }
      }
    }
    over = active ? over : 0u;
    over = __reduce_add_sync(0xffffffffu, over);
    if (lane == 0 && over) atomicAdd(&s_stat[6 * nq + q], static_cast<int>(over));
  }

  if (active) {
    Run run;
#pragma unroll
    for (int dy = 0; dy < SH; ++dy) {
      const int oy = i * SH + dy;
      const size_t row = (static_cast<size_t>(b) * out_h + oy) * out_w + j * SW;
#pragma unroll
      for (int dx = 0; dx < SW; ++dx) {
        const int k = dy * SW + dx;
        seg[row + dx] = arg[k];
        mx_out[row + dx] = best[k];
        if (arg[k] != run.q) { run.flush(s_stat, nq); run.q = arg[k]; }
        const int ox = j * SW + dx;
        run.cn += 1; run.xn += ox; run.yn += oy;
        if (best[k] > thr) { run.cg += 1; run.xg += ox; run.yg += oy; }
      }
    }
    run.flush(s_stat, nq);
  }
  __syncthreads();

  unsigned long long* ab = acc + static_cast<size_t>(b) * kNStat * nq;
  for (int k = tid; k < kNStat * nq; k += kTx * kTy) {
    const int val = s_stat[k];
    if (val) atomicAdd(&ab[k], static_cast<unsigned long long>(val));
  }
}

__global__ void finalize_stats_kernel(const unsigned long long* __restrict__ acc,
                                      float* __restrict__ stats, int n, int nq,
                                      int out_h, int out_w) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= n) return;
  const int s = (k / nq) % kNStat;
  const double v = static_cast<double>(acc[k]);
  double scale = 1.0;
  if (s == 1 || s == 4) scale = static_cast<double>(out_w);
  if (s == 2 || s == 5) scale = static_cast<double>(out_h);
  stats[k] = static_cast<float>(v / scale);
}

template <int SH, int SW>
void launch(const void* prob, const void* score, const void* valid, void* seg, void* mx,
            void* acc, int b, int nq, int h, int w, float thr, cudaStream_t st) {
  dim3 block(kTx, kTy);
  dim3 grid((w + kTx - 1) / kTx, (h + kTy - 1) / kTy, b);
  const size_t smem = sizeof(int) * kNStat * nq;
  select_maps_kernel<SH, SW><<<grid, block, smem, st>>>(
      static_cast<const __nv_bfloat16*>(prob), static_cast<const float*>(score),
      static_cast<const uint8_t*>(valid), static_cast<int32_t*>(seg),
      static_cast<float*>(mx), static_cast<unsigned long long*>(acc), nq, h, w, thr);
}

}  // namespace

// prob bf16 [B,NQ,h,w]; score f32 [B,NQ]; valid u8 [B,NQ]; seg i32 [B,H,W];
// mx f32 [B,H,W]; stats f32 [B,7,NQ]; acc u64 scratch [B,7,NQ].
// Returns cudaGetLastError() after the launches.
extern "C" int nopesac_select_maps(const void* prob, const void* score, const void* valid,
                                   void* seg, void* mx, void* stats, void* acc,
                                   int b, int nq, int h, int w, int out_h, int out_w,
                                   float thr, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int sh = out_h / h, sw = out_w / w;
  const int n = b * kNStat * nq;
  cudaError_t err = cudaMemsetAsync(acc, 0, sizeof(unsigned long long) * n, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  // every config upsamples the 1/4-resolution mask logits by 4
  if (sh != 4 || sw != 4 || out_h != 4 * h || out_w != 4 * w) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  launch<4, 4>(prob, score, valid, seg, mx, acc, b, nq, h, w, thr, st);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  finalize_stats_kernel<<<(n + 255) / 256, 256, 0, st>>>(
      static_cast<const unsigned long long*>(acc), static_cast<float*>(stats), n, nq,
      out_h, out_w);
  return static_cast<int>(cudaGetLastError());
}
