// Batched rectangular linear sum assignment of the DETR matcher (kernel H1).
//
// Replaces the JAX package's on-device matcher `hungarian_device`
// (`losses/hungarian.py`: Jonker-Volgenant shortest augmenting paths,
// `lap_jv_rect`, as XLA while-loops under `vmap`; no Pallas kernel). One
// launch takes the costs [P, NQ, NG] of every supervision level and image as
// the criterion builds them and writes the match [P, NQ] int64 (the GT index
// of each query, or -1). Per problem the warp pads the GT side to n = NQ with
// zero columns, replaces non-finite entries by (|finite max| + 1) * 2 + 1e3
// (the maximum over the whole padded matrix), transposes (rows are the GT
// planes, columns the queries), solves the first num_gt rows and inverts
// col4row into the match. Each step is the plain version's
// (`losses/hungarian.py:lap_jv_rect` of the port): the reduced cost
// ((min_val + cost[i]) - u[i]) - v in f32 additions in that order, argmin's
// rule (NaN first, then the smaller value, then the lower index), the
// `it <= n` bounds of both inner loops, the dual updates with spc[col4row]
// read before the augmentation. The output is integers, so kernel and plain
// version are bit-equal.
//
// What bounds it on the H100: neither bytes (at the main-path shape, 0.96 MB
// of costs) nor operations, but the chain of dependent Dijkstra steps of the
// largest problem: each step is a relaxation of the row's columns, an argmin
// over the unscanned columns and a read of the winner's row, and the next step
// starts from that row. Design: one warp per problem, several warps per
// block; the problem's transposed, sanitised cost in shared memory (10 KB at
// 50 x 50, 64 KB at 128 x 128), columns spread over the lanes (column
// lane + 32 k, k < 4) with their spc, path, v and scanned bits in registers;
// per step one shuffle butterfly on (value, index) pairs, the lower index
// winning ties, so every lane ends with the same winner and no barrier is
// needed. u, col4row, row4col and path sit in shared memory, so that one lane
// walks the augmenting path; __syncwarp orders the lanes' shared writes.
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kMaxN = 128;
constexpr int kPerLane = kMaxN / 32;  // columns (and rows) per lane
constexpr unsigned kFull = 0xffffffffu;
constexpr int kNoIndex = 0x7fffffff;
constexpr int kMaxWarps = 4;           // problems per block
constexpr size_t kMaxSmem = 232448;    // bytes of shared memory a block can use on the H100

// per warp: cost [n, n], u [n], spc [n] (floats), col4row, row4col, path [n]
__host__ __device__ constexpr size_t warp_floats(int n) { return static_cast<size_t>(n) * n + 5 * n; }

// argmin's order: a NaN before any number, then the smaller value, then the
// lower index (torch.argmin and jnp.argmin both return the first minimum)
__device__ __forceinline__ bool wins(float a, int ia, float b, int ib) {
  const bool an = isnan(a), bn = isnan(b);
  if (an != bn) return an;
  if (!an && a != b) return a < b;
  return ia < ib;
}

__global__ void hungarian_kernel(const float* __restrict__ cost,
                                 const int64_t* __restrict__ num_gt, int64_t* __restrict__ match,
                                 int p, int nq, int ng) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int prob = blockIdx.x * (blockDim.x >> 5) + warp;
  if (prob >= p) return;  // the whole warp: no block-wide barrier follows
  const int n = nq;
  float* ct = smem + warp * warp_floats(n);  // ct[g * n + q] = cost[prob, q, g]
  float* u = ct + n * n;
  float* spc_s = u + n;
  int* col4row = reinterpret_cast<int*>(spc_s + n);
  int* row4col = col4row + n;
  int* path_s = row4col + n;

  // stage, transposed and padded with zero GT rows; the finite maximum
  const float* src = cost + static_cast<size_t>(prob) * nq * ng;
  float fmax = -CUDART_INF_F;
  for (int e = lane; e < nq * ng; e += 32) {
    const int q = e / ng, g = e - q * ng;
    const float x = src[e];
    ct[g * n + q] = x;
    if (isfinite(x)) fmax = fmaxf(fmax, x);
  }
  for (int e = ng * n + lane; e < n * n; e += 32) {
    ct[e] = 0.0f;
    fmax = fmaxf(fmax, 0.0f);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) fmax = fmaxf(fmax, __shfl_xor_sync(kFull, fmax, off));
  if (!isfinite(fmax)) fmax = 0.0f;
  const float big = __fadd_rn(__fmul_rn(__fadd_rn(fabsf(fmax), 1.0f), 2.0f), 1e3f);
  __syncwarp();
  for (int e = lane; e < n * n; e += 32) {
    if (!isfinite(ct[e])) ct[e] = big;
  }
  for (int e = lane; e < n; e += 32) {
    u[e] = 0.0f;
    col4row[e] = -1;
    row4col[e] = -1;
  }
  __syncwarp();

  const int64_t rows64 = num_gt[prob];
  const int num_rows = static_cast<int>(rows64 < 0 ? 0 : (rows64 > ng ? ng : rows64));

  float v[kPerLane];
#pragma unroll
  for (int k = 0; k < kPerLane; ++k) v[k] = 0.0f;

  for (int r = 0; r < num_rows; ++r) {
    // Dijkstra from row r over the columns
    float spc[kPerLane];
    int path[kPerLane];
#pragma unroll
    for (int k = 0; k < kPerLane; ++k) {
      spc[k] = CUDART_INF_F;
      path[k] = -1;
    }
    unsigned sc = 0, sr = 0;  // bit k: column (row) lane + 32 k scanned (visited)
    int i = r, sink = -1, it = 0;
    float min_val = 0.0f;
    while (sink < 0 && it <= n) {
      ++it;
      if ((i & 31) == lane) sr |= 1u << (i >> 5);
      const float ui = u[i];
      const float* row = ct + i * n;
      float best = CUDART_INF_F;
      int bi = kNoIndex;
#pragma unroll
      for (int k = 0; k < kPerLane; ++k) {
        const int c = lane + 32 * k;
        if (c < n) {
          const float red = __fsub_rn(__fsub_rn(__fadd_rn(min_val, row[c]), ui), v[k]);
          const bool scanned = (sc >> k) & 1u;
          if (!scanned && red < spc[k]) {
            spc[k] = red;
            path[k] = i;
          }
          const float masked = scanned ? CUDART_INF_F : spc[k];
          if (wins(masked, c, best, bi)) {
            best = masked;
            bi = c;
          }
        }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const float ob = __shfl_xor_sync(kFull, best, off);
        const int oi = __shfl_xor_sync(kFull, bi, off);
        if (wins(ob, oi, best, bi)) {
          best = ob;
          bi = oi;
        }
      }
      const int j = bi;
      min_val = best;
      if ((j & 31) == lane) sc |= 1u << (j >> 5);
      const int r4c = row4col[j];
      if (r4c < 0) sink = j;
      else i = r4c;
    }
    if (sink < 0) {  // the bound tripped: the first free column, 0 if none
      sink = 0;
#pragma unroll
      for (int k = kPerLane - 1; k >= 0; --k) {
        const int c = lane + 32 * k;
        const unsigned free = __ballot_sync(kFull, c < n && row4col[c] < 0);
        if (free) sink = 32 * k + __ffs(free) - 1;
      }
    }

    // dual updates; spc through shared memory for the rows' gather
#pragma unroll
    for (int k = 0; k < kPerLane; ++k) {
      const int c = lane + 32 * k;
      if (c < n) spc_s[c] = spc[k];
    }
    __syncwarp();
#pragma unroll
    for (int k = 0; k < kPerLane; ++k) {
      const int row = lane + 32 * k;
      if (row < n) {
        if (row == r) {
          u[row] = __fadd_rn(u[row], min_val);
        } else if ((sr >> k) & 1u) {
          const int c = col4row[row] < 0 ? 0 : col4row[row];
          u[row] = __fsub_rn(__fadd_rn(u[row], min_val), spc_s[c]);
        }
      }
      if ((sc >> k) & 1u) v[k] = __fsub_rn(v[k], __fsub_rn(min_val, spc[k]));
      const int c = lane + 32 * k;
      if (c < n) path_s[c] = path[k];
    }
    __syncwarp();

    // augment along the alternating path: one lane walks it
    if (lane == 0) {
      int j = sink, steps = 0;
      bool done = false;
      while (!done && steps <= n) {
        const int jc = j < 0 ? 0 : (j > n - 1 ? n - 1 : j);
        const int pj = path_s[jc];
        const int ii = pj >= 0 ? pj : r;
        row4col[jc] = ii;
        const int nxt = col4row[ii];
        col4row[ii] = jc;
        done = ii == r;
        j = nxt;
        ++steps;
      }
    }
    __syncwarp();
  }

  // invert: match[col4row[g]] = g, in shared memory (path_s), then out
  for (int q = lane; q < n; q += 32) path_s[q] = -1;
  __syncwarp();
  for (int g = lane; g < n; g += 32) {
    const int c = col4row[g];
    if (c >= 0) path_s[c] = g;
  }
  __syncwarp();
  int64_t* out = match + static_cast<size_t>(prob) * nq;
  for (int q = lane; q < nq; q += 32) out[q] = path_s[q];
}

}  // namespace

extern "C" int nopesac_hungarian(const void* cost, const void* num_gt, void* match, int p,
                                 int nq, int ng, void* stream) {
  if (p <= 0 || nq <= 0) return 0;
  if (nq > kMaxN || ng > nq) return static_cast<int>(cudaErrorInvalidValue);
  // as many problems per block as fit, at most kMaxWarps: 4 at 50 queries, 3 at 128
  const size_t per_warp = warp_floats(nq) * sizeof(float);
  const size_t fit = kMaxSmem / per_warp;
  const int warps = fit < static_cast<size_t>(kMaxWarps) ? static_cast<int>(fit) : kMaxWarps;
  const size_t smem = warps * per_warp;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        hungarian_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const int blocks = (p + warps - 1) / warps;
  hungarian_kernel<<<blocks, 32 * warps, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(cost), static_cast<const int64_t*>(num_gt),
      static_cast<int64_t*>(match), p, nq, ng);
  return static_cast<int>(cudaGetLastError());
}

// registers, static shared memory, local (spill) bytes and the most threads
// per block of the kernel (cudaFuncGetAttributes)
extern "C" int nopesac_hungarian_attrs(int* out) {
  cudaFuncAttributes a;
  const cudaError_t err = cudaFuncGetAttributes(&a, hungarian_kernel);
  if (err != cudaSuccess) return err;
  out[0] = a.numRegs;
  out[1] = static_cast<int>(a.sharedSizeBytes);
  out[2] = static_cast<int>(a.localSizeBytes);
  out[3] = a.maxThreadsPerBlock;
  return 0;
}
