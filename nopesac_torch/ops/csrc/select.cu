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
// What bounds it on the H100: instruction issue. At the main-path shape
// ([8,50,120,160] -> 480x640) it moves ~35 MB (~10 us at 3.35 TB/s), while
// every output pixel and query takes a row 2-tap, a share of the column
// 2-taps and the threshold count, and for a valid query the score product
// and the argmax update: ~8 issued instructions per pixel for an invalid
// query and ~12 for a valid one, over 123 M pixel-queries.
// Design, per block of 8 x 32 low-res pixels of one view (one warp per
// low-res row, one thread per low-res pixel and its 4 x 4 output pixels,
// three blocks per SM):
// - each query's tile and its 1-pixel halo go to shared memory through a
//   3-stage ring of 16-byte `cp.async` copies (columns j0-8 .. j0+40, so
//   every copy is aligned; a scalar staging variant takes w % 8 != 0), one
//   barrier per query; the scan is unrolled over the ring's slots, so a
//   thread reads its clamped 3x3 neighbourhood with 9 shared loads at fixed
//   offsets from addresses computed once;
// - the 4x phases use compile-time taps (those of the Pallas kernel's
//   `_phase_taps`): phases 0, 1 read (i-1, i) with (0.375, 0.625) and
//   (0.125, 0.875), phases 2, 3 read (i, i+1) with (0.875, 0.125) and
//   (0.625, 0.375), the index clamped to the map; column taps first, then
//   row taps, each as fma(l0, lower, l1 * upper); only the blocks of the
//   first block row carry the low-edge code (see below);
// - only the first invalid query can win a pixel among the invalid ones
//   (they all score -1 and the argmax keeps the first index), so the others
//   skip the argmax update;
// - each thread's running (max, argmax) of its 16 pixels stays in registers
//   over the queries and leaves as int4/float4 rows;
// - per-query stats: shared-memory atomics per block (runs of equal labels
//   merged per thread first), int32 partials per block to a scratch buffer,
//   and the last block of each view (an atomic ticket that resets itself)
//   sums them exactly in 64 bits and writes the scaled f32 stats: one
//   launch per call.
//
// Bit-equality with the plain version (F.interpolate + argmax/max): ATen's
// upsample_bilinear2d computes h0*(w0*x00 + w1*x01) + h1*(w0*x10 + w1*x11)
// with the lower index first. Products of bf16 inputs with the tap weights
// (multiples of 1/8) are exact in f32, so each column 2-tap is the correctly
// rounded sum whatever the form, and the edge clamp of the columns (ATen
// takes weights (1, 0) at column 0) gives the same value as the constant
// taps with the neighbour replicated. The row taps act on rounded f32 column
// sums: they are written as ATen's contraction, fma(h0, top, h1 * bottom),
// and at low-res row 0, phases 0 and 1, ATen's clamped taps (rows 0 and 1,
// weights (1, 0)) are kept, since 0.375 c + 0.625 c need not round to c. At
// the last row ATen's collapsed second tap equals the constant taps with the
// row replicated. The argmax keeps the first index (strict >), the maximum
// starts at -2 so a view whose queries are all invalid gets label 0.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kNStat = 7;
constexpr int kTx = 32;                     // low-res columns per block: one warp
constexpr int kTy = 8;                      // low-res rows per block
constexpr int kThreads = kTx * kTy;
constexpr int kStages = 3;                  // cp.async ring over the queries
constexpr int kHalo = 8;                    // staged columns left and right of the tile
constexpr int kSRows = kTy + 2;
constexpr int kSCols = kTx + 2 * kHalo;     // 48 bf16, 96 bytes a staged row
constexpr int kChunks = kSCols / 8;         // 16-byte copies per staged row
constexpr int kStage = kSRows * kSCols;     // bf16 per staged query
static_assert(kSRows * kChunks <= kThreads, "one copy per thread and stage");

struct Args {
  const __nv_bfloat16* prob;  // [B, NQ, h, w]
  const float* score;         // [B, NQ]
  const uint8_t* valid;       // [B, NQ]
  int32_t* seg;               // [B, 4h, 4w]
  float* mx;                  // [B, 4h, 4w]
  int* partials;              // [B, blocks, stride]
  unsigned* tickets;          // [B], zero between calls
  float* stats;               // [B, 7, NQ]
  int nq, h, w;
  float thr;
};

__host__ __device__ inline int stat_stride(int nq) { return (kNStat * nq + 3) / 4 * 4; }

// parts of the last block's sum: a thread per int4 column and part
__host__ __device__ inline int sum_parts(int nq) {
  const int c4 = stat_stride(nq) / 4;
  return c4 >= kThreads ? 1 : kThreads / c4;
}

__host__ __device__ inline size_t sum_bytes(int nq) {
  return sum_parts(nq) > 1 ? sizeof(long long) * sum_parts(nq) * stat_stride(nq) : 0;
}

__host__ __device__ inline size_t smem_bytes(int nq) {
  return sizeof(__nv_bfloat16) * kStages * kStage + sum_bytes(nq) +
         sizeof(int) * stat_stride(nq) + (sizeof(float) + sizeof(int)) * nq;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// a 2-tap, lower index first, in ATen's contraction
__device__ __forceinline__ float tap(float l0, float lo, float l1, float hi) {
  return __fmaf_rn(l0, lo, __fmul_rn(l1, hi));
}

// The 16-byte staging copy of one thread (vec variant): where it comes from
// (element offset in a query's map) and goes to (element offset in a stage).
// Threads past the staged window, or whose chunk lies outside the map, copy
// nothing; what lies outside the map is never read.
struct Copy {
  int src, dst;
  bool on;
};

__device__ __forceinline__ Copy vec_copy(int i0, int j0, int h, int w) {
  const int k = threadIdx.x;
  const int sr = k / kChunks, sc = (k % kChunks) * 8;
  const int r = i0 - 1 + sr, c = j0 - kHalo + sc;
  // w % 8 == 0: a chunk lies wholly inside the row or wholly outside it
  return {r * w + c, sr * kSCols + sc,
          k < kSRows * kChunks && r >= 0 && r < h && c >= 0 && c < w};
}

// one query's staged rows i0-1 .. i0+kTy, columns j0-kHalo .. j0+kTx+kHalo
template <bool kVec>
__device__ __forceinline__ void stage(const __nv_bfloat16* src, __nv_bfloat16* dst,
                                      const Copy& cp, int i0, int j0, int h, int w) {
  if (kVec) {
    if (cp.on) cp_async16(dst + cp.dst, src + cp.src);
  } else {
    for (int k = threadIdx.x; k < kSRows * (kTx + 2); k += kThreads) {
      const int sr = k / (kTx + 2), sc = kHalo - 1 + k % (kTx + 2);
      const int r = i0 - 1 + sr, c = j0 - kHalo + sc;
      if (r >= 0 && r < h && c >= 0 && c < w) dst[sr * kSCols + sc] = src[static_cast<size_t>(r) * w + c];
    }
  }
}

// a staged bf16 at a shared-memory byte address plus kOff, widened to f32
// (volatile: the barriers order it against the copies)
template <int kOff>
__device__ __forceinline__ float lds_bf16(unsigned addr) {
  unsigned v;
  asm volatile("ld.shared.u16 %0, [%1+%2];\n" : "=r"(v) : "r"(addr), "n"(kOff) : "memory");
  return __uint_as_float(v << 16);
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

template <int N>
using Slot = std::integral_constant<int, N>;

// The scan over the queries of one block: per query a barrier, the copy of
// the query two ahead, and each thread's update of its 16 pixels from its
// staged 3x3 neighbourhood (9 shared-memory byte addresses in stage 0,
// `nb`). The ring's slot is a compile-time constant in each of the three
// unrolled steps. kEdge: the block holds low-res row 0.
template <bool kVec, bool kEdge>
__device__ __forceinline__ void scan_queries(const Args& a, const __nv_bfloat16* pb,
                                             __nv_bfloat16* tiles, const Copy& cp, int i0,
                                             int j0, bool edge_row, bool active,
                                             const unsigned (&nb)[9], const float* s_score,
                                             const int* s_valid, int* s_stat,
                                             float (&best)[16], int (&arg)[16]) {
  static_assert(kStages == 3, "the scan unrolls the ring's three slots");
  const int nq = a.nq, h = a.h, w = a.w;
  const size_t plane = static_cast<size_t>(h) * w;
  bool seen_invalid = false;
  auto step = [&](auto slot, int q) {
    constexpr int kSlot = decltype(slot)::value;
    constexpr int kOff = kSlot * kStage * static_cast<int>(sizeof(__nv_bfloat16));
    cp_async_wait<kStages - 2>();
    __syncthreads();  // query q staged by every thread; query q-1's slot free
    if (q + kStages - 1 < nq)
      stage<kVec>(pb + (q + kStages - 1) * plane, tiles + (kSlot + kStages - 1) % kStages * kStage,
                  cp, i0, j0, h, w);
    cp_async_commit();

    float cv[3][4];  // column phases of the rows i-1, i, i+1
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      const float xl = lds_bf16<kOff>(nb[3 * r]);
      const float xc = lds_bf16<kOff>(nb[3 * r + 1]);
      const float xr = lds_bf16<kOff>(nb[3 * r + 2]);
      cv[r][0] = tap(0.375f, xl, 0.625f, xc);
      cv[r][1] = tap(0.125f, xl, 0.875f, xc);
      cv[r][2] = tap(0.875f, xc, 0.125f, xr);
      cv[r][3] = tap(0.625f, xc, 0.375f, xr);
    }
    float up[16];
#pragma unroll
    for (int dx = 0; dx < 4; ++dx) {
      up[0 + dx] = tap(0.375f, cv[0][dx], 0.625f, cv[1][dx]);
      up[4 + dx] = tap(0.125f, cv[0][dx], 0.875f, cv[1][dx]);
      up[8 + dx] = tap(0.875f, cv[1][dx], 0.125f, cv[2][dx]);
      up[12 + dx] = tap(0.625f, cv[1][dx], 0.375f, cv[2][dx]);
    }
    if (kEdge && edge_row) {  // ATen clamps the source row to 0: rows (0, 1), weights (1, 0)
#pragma unroll
      for (int dx = 0; dx < 4; ++dx) up[dx] = up[4 + dx] = tap(1.f, cv[1][dx], 0.f, cv[2][dx]);
    }

    float over = 0.f;
#pragma unroll
    for (int k = 0; k < 16; ++k) over += up[k] >= a.thr ? 1.f : 0.f;
    if (s_valid[q]) {
      const float s = s_score[q];
#pragma unroll
      for (int k = 0; k < 16; ++k) {
        const float g = up[k] * s;
        if (g > best[k]) { best[k] = g; arg[k] = q; }
      }
    } else if (!seen_invalid) {
      seen_invalid = true;
#pragma unroll
      for (int k = 0; k < 16; ++k) {
        if (-1.f > best[k]) { best[k] = -1.f; arg[k] = q; }
      }
    }
    const unsigned n = __reduce_add_sync(0xffffffffu, active ? static_cast<unsigned>(over) : 0u);
    if ((threadIdx.x & 31) == 0 && n) atomicAdd(&s_stat[6 * nq + q], static_cast<int>(n));
  };
  for (int q = 0; q < nq; q += kStages) {
    step(Slot<0>(), q);
    if (q + 1 < nq) step(Slot<1>(), q + 1);
    if (q + 2 < nq) step(Slot<2>(), q + 2);
  }
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads, kVec ? 3 : 2) select_maps_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_last;
  const int nq = a.nq, h = a.h, w = a.w, out_h = 4 * h, out_w = 4 * w;
  const int stride = stat_stride(nq), parts = sum_parts(nq);
  __nv_bfloat16* tiles = reinterpret_cast<__nv_bfloat16*>(smem);
  long long* s_sum = reinterpret_cast<long long*>(tiles + kStages * kStage);  // [parts, stride]
  int* s_stat = reinterpret_cast<int*>(reinterpret_cast<unsigned char*>(s_sum) + sum_bytes(nq));
  float* s_score = reinterpret_cast<float*>(s_stat + stride);
  int* s_valid = reinterpret_cast<int*>(s_score + nq);

  const int tid = threadIdx.x;
  const int j0 = blockIdx.x * kTx, i0 = blockIdx.y * kTy, b = blockIdx.z;
  const int i = i0 + tid / kTx, j = j0 + tid % kTx;
  const bool active = i < h && j < w;
  // the clamped 3x3 neighbourhood in stage 0; inactive threads read a valid
  // pixel and contribute nothing (they still take part in the warp reductions)
  const int ic = min(i, h - 1), jc = min(j, w - 1);
  const int srow[3] = {max(ic - 1, 0) - i0 + 1, ic - i0 + 1, min(ic + 1, h - 1) - i0 + 1};
  const int scol[3] = {max(jc - 1, 0) - j0 + kHalo, jc - j0 + kHalo, min(jc + 1, w - 1) - j0 + kHalo};
  unsigned nb[9];
#pragma unroll
  for (int r = 0; r < 3; ++r)
#pragma unroll
    for (int c = 0; c < 3; ++c)
      nb[3 * r + c] = static_cast<unsigned>(
          __cvta_generic_to_shared(tiles + srow[r] * kSCols + scol[c]));
  const size_t plane = static_cast<size_t>(h) * w;
  const __nv_bfloat16* pb = a.prob + static_cast<size_t>(b) * nq * plane;
  const Copy cp = vec_copy(i0, j0, h, w);

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nq) stage<kVec>(pb + s * plane, tiles + s * kStage, cp, i0, j0, h, w);
    cp_async_commit();
  }
  for (int k = tid; k < stride; k += kThreads) s_stat[k] = 0;
  for (int q = tid; q < nq; q += kThreads) {
    s_score[q] = a.score[b * nq + q];
    s_valid[q] = a.valid[b * nq + q] != 0;
  }

  float best[16];
  int arg[16];
#pragma unroll
  for (int k = 0; k < 16; ++k) { best[k] = -2.f; arg[k] = 0; }
  if (i0 == 0) {
    scan_queries<kVec, true>(a, pb, tiles, cp, i0, j0, ic == 0, active, nb, s_score, s_valid,
                             s_stat, best, arg);
  } else {
    scan_queries<kVec, false>(a, pb, tiles, cp, i0, j0, false, active, nb, s_score, s_valid,
                              s_stat, best, arg);
  }

  if (active) {
    Run run;
#pragma unroll
    for (int dy = 0; dy < 4; ++dy) {
      const int oy = 4 * i + dy;
      const size_t row = (static_cast<size_t>(b) * out_h + oy) * out_w + 4 * j;
      const int* ar = arg + 4 * dy;
      const float* br = best + 4 * dy;
      *reinterpret_cast<int4*>(a.seg + row) = make_int4(ar[0], ar[1], ar[2], ar[3]);
      *reinterpret_cast<float4*>(a.mx + row) = make_float4(br[0], br[1], br[2], br[3]);
#pragma unroll
      for (int dx = 0; dx < 4; ++dx) {
        if (ar[dx] != run.q) { run.flush(s_stat, nq); run.q = ar[dx]; }
        const int ox = 4 * j + dx;
        run.cn += 1; run.xn += ox; run.yn += oy;
        if (br[dx] > a.thr) { run.cg += 1; run.xg += ox; run.yg += oy; }
      }
    }
    run.flush(s_stat, nq);
  }
  __syncthreads();

  // this block's partials, then the ticket of its view
  const int nblk = gridDim.x * gridDim.y, blk = blockIdx.y * gridDim.x + blockIdx.x;
  int* part = a.partials + (static_cast<size_t>(b) * nblk + blk) * stride;
  for (int k = tid; k < stride; k += kThreads) part[k] = s_stat[k];
  __threadfence();
  __syncthreads();
  if (tid == 0) s_last = atomicAdd(&a.tickets[b], 1u) == static_cast<unsigned>(nblk - 1);
  __syncthreads();
  if (!s_last) return;

  // the last block of view b: exact 64-bit sums over its blocks' partials
  __threadfence();
  const int c4 = stride / 4;
  const int4* src = reinterpret_cast<const int4*>(a.partials + static_cast<size_t>(b) * nblk * stride);
  float* st = a.stats + static_cast<size_t>(b) * kNStat * nq;
  auto finish = [&](int k, long long v) {
    if (k >= kNStat * nq) return;
    const int s = k / nq;
    double scale = 1.0;
    if (s == 1 || s == 4) scale = static_cast<double>(out_w);
    if (s == 2 || s == 5) scale = static_cast<double>(out_h);
    st[k] = static_cast<float>(static_cast<double>(v) / scale);
  };
  const int p = parts > 1 ? tid / c4 : 0;
  if (p < parts) {
    for (int col = parts > 1 ? tid % c4 : tid; col < c4; col += parts > 1 ? c4 : kThreads) {
      long long s0 = 0, s1 = 0, s2 = 0, s3 = 0;
#pragma unroll 8
      for (int k = p; k < nblk; k += parts) {
        const int4 v = __ldcg(src + static_cast<size_t>(k) * c4 + col);
        s0 += v.x; s1 += v.y; s2 += v.z; s3 += v.w;
      }
      if (parts > 1) {
        long long* o = s_sum + p * stride + 4 * col;
        o[0] = s0; o[1] = s1; o[2] = s2; o[3] = s3;
      } else {
        finish(4 * col, s0); finish(4 * col + 1, s1); finish(4 * col + 2, s2); finish(4 * col + 3, s3);
      }
    }
  }
  if (parts > 1) {
    __syncthreads();
    for (int k = tid; k < kNStat * nq; k += kThreads) {
      long long v = 0;
      for (int pp = 0; pp < parts; ++pp) v += s_sum[pp * stride + k];
      finish(k, v);
    }
  }
  if (tid == 0) a.tickets[b] = 0u;
}

template <bool kVec>
cudaError_t launch(const Args& a, int b, cudaStream_t st) {
  const dim3 grid((a.w + kTx - 1) / kTx, (a.h + kTy - 1) / kTy, b);
  const size_t smem = smem_bytes(a.nq);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(select_maps_kernel<kVec>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  select_maps_kernel<kVec><<<grid, kThreads, smem, st>>>(a);
  return cudaGetLastError();
}

template <typename K>
int attrs(K kern, int smem, int* out) {
  cudaFuncAttributes fa;
  int per = 0;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&fa, kern);
  if (e == cudaSuccess) e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per, kern, kThreads, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  out[0] = fa.numRegs;
  out[1] = static_cast<int>(fa.sharedSizeBytes);
  out[2] = smem;
  out[3] = static_cast<int>(fa.localSizeBytes);
  out[4] = per;
  return 0;
}

}  // namespace

// int32 entries of the partials scratch per view: blocks x stride.
extern "C" int nopesac_select_maps_partials(int nq, int h, int w) {
  return ((w + kTx - 1) / kTx) * ((h + kTy - 1) / kTy) * stat_stride(nq);
}

// prob bf16 [B,NQ,h,w]; score f32 [B,NQ]; valid u8 [B,NQ]; seg i32 [B,4h,4w];
// mx f32 [B,4h,4w]; stats f32 [B,7,NQ]; partials i32 scratch [B, partials
// per view]; tickets u32 [B], zero between calls (the kernel leaves them at
// zero). vec: w % 8 == 0 and prob 16-byte aligned (cp.async staging).
// Returns cudaGetLastError() after the launch.
extern "C" int nopesac_select_maps(const void* prob, const void* score, const void* valid,
                                   void* seg, void* mx, void* stats, void* partials,
                                   void* tickets, int b, int nq, int h, int w, int out_h,
                                   int out_w, float thr, int vec, void* stream) {
  // every config upsamples the 1/4-resolution mask probabilities by 4
  if (out_h != 4 * h || out_w != 4 * w || nq < 1) return static_cast<int>(cudaErrorInvalidValue);
  const Args a{static_cast<const __nv_bfloat16*>(prob), static_cast<const float*>(score),
               static_cast<const uint8_t*>(valid), static_cast<int32_t*>(seg),
               static_cast<float*>(mx), static_cast<int*>(partials),
               static_cast<unsigned*>(tickets), static_cast<float*>(stats), nq, h, w, thr};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(vec ? launch<true>(a, b, st) : launch<false>(a, b, st));
}

// Registers, static and dynamic shared memory, spill bytes and resident
// blocks per SM of the vec or scalar variant at nq queries, into out[0..4].
// Returns a cudaError_t.
extern "C" int nopesac_select_maps_attrs(int vec, int nq, int* out) {
  const int smem = static_cast<int>(smem_bytes(nq));
  return vec ? attrs(select_maps_kernel<true>, smem, out)
             : attrs(select_maps_kernel<false>, smem, out);
}
