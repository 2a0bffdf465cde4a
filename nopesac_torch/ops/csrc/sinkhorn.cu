// Masked log-domain Sinkhorn optimal transport, from scores to log coupling.
//
// Replaces the TPU kernel `log_optimal_transport_masked_pallas`
// (`ops/sinkhorn_pallas.py` of the JAX package) together with the prologue
// that runs around its `pallas_call`. Per batch element b the block builds the
// dustbin-padded coupling z [R, C] = [M+1, N+1] from scores [M, N], the bin
// score alpha and the row/column masks (invalid entries at a finite -1e5), the
// log marginals log_mu [R], log_nu [C] and norm = -log(nr + nc) from the
// counts of valid rows and columns, runs `iters` rounds of
//   u = log_mu - logsumexp_c(z + v),   v = log_nu - logsumexp_r(z + u)
// and writes z + u + v - norm once. Each step is the plain version's
// (`core/sinkhorn.py:log_optimal_transport_masked`), in the same operand order;
// logsumexp follows torch.logsumexp: a maximum of +-inf is replaced by 0, so a
// side with no valid row or column gives the plain version's infinities at the
// same entries.
//
// What bounds it on the H100: neither bytes nor operations but the chain of
// 2 * iters dependent reductions (at the main-path shape [4, 51, 51], 200
// iterations: 400 half-iterations on 42 KB), on one SM per batch element.
// Design: one block per batch element, one group of G = 8 lanes for every
// row and, in the column pass, for every column,
// so that all rows (all columns) reduce in the same round: a half-iteration
// is one group reduction of log2(G) shuffle levels for the max and as many
// for the sum, one expf per entry and lane, one logf, and one barrier. Each
// thread keeps its row slice z[g, l + G k] and its column slice
// z[l + G k, g] (k < V, V = ceil(max(R, C) / G)) in registers for all
// iterations; only u and v go through shared memory, and the barrier after
// each pass separates its writes from the next pass's reads. Entries past
// the edge hold -inf, which adds nothing to a sum. At [51, 51] and G = 8 a
// half-iteration issues ~1,700 warp instructions on its SM (IEEE expf is 9
// per entry, logf ~30 per warp) against a chain of ~400 cycles, so issue and
// latency bound it together; 16 lanes per group issued more and ran 16%
// slower on the H100 (PERF.md), and spreading a batch element over a
// thread-block cluster (u and v through distributed shared memory, a
// cluster barrier per pass) ran slower still.
// A general variant of the same file (z in shared memory, one warp per row
// or column in turn) takes the shapes beyond the register variant.
//
// Numerics: IEEE expf/logf, no fast-math intrinsics. The order of each sum
// differs from torch.logsumexp's, so results agree with the plain version to
// ~1e-5 after 200 iterations, not bitwise; a fixed order makes runs
// bit-equal to each other.
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr float kMasked = -1e5f;  // the prologue's finite score of an invalid entry
constexpr int kGroup = 8;      // lanes per row or column of the register variant
constexpr int kMaxValues = 8;  // its most values per lane: rows and columns up to 64
constexpr int kGeneralThreads = 512;
constexpr int kWarps = kGeneralThreads / 32;

struct Problem {
  const float* scores;      // [B, M, N]
  const uint8_t* row_mask;  // [B, M], nonzero = valid; null = all valid
  const uint8_t* col_mask;  // [B, N]; null = all valid
  const float* alpha;       // the bin score, one value
  float* out;               // [B, M+1, N+1]
  int m, n, iters;
};

__device__ __forceinline__ bool row_valid(const Problem& p, int b, int r) {
  return r == p.m || p.row_mask == nullptr || p.row_mask[static_cast<size_t>(b) * p.m + r] != 0;
}

__device__ __forceinline__ bool col_valid(const Problem& p, int b, int c) {
  return c == p.n || p.col_mask == nullptr || p.col_mask[static_cast<size_t>(b) * p.n + c] != 0;
}

// padded[r, c]: the score, alpha on the dustbin row and column, -1e5 where
// the row or the column is invalid
__device__ __forceinline__ float padded(const Problem& p, int b, int r, int c, float alpha) {
  if (!row_valid(p, b, r) || !col_valid(p, b, c)) return kMasked;
  if (r < p.m && c < p.n) return p.scores[(static_cast<size_t>(b) * p.m + r) * p.n + c];
  return alpha;
}

struct Marginals {
  float norm, log_nr, log_nc;
};

// counts of valid rows and columns of batch element b; every thread of the
// block calls it
__device__ Marginals marginals(const Problem& p, int b) {
  int nr = 0, nc = 0;
  for (int base = 0; base < p.m; base += blockDim.x) {
    const int r = base + threadIdx.x;
    nr += __syncthreads_count(r < p.m && row_valid(p, b, r));
  }
  for (int base = 0; base < p.n; base += blockDim.x) {
    const int c = base + threadIdx.x;
    nc += __syncthreads_count(c < p.n && col_valid(p, b, c));
  }
  const float fr = static_cast<float>(nr), fc = static_cast<float>(nc);
  return {-logf(fr + fc), logf(fr), logf(fc)};
}

__device__ __forceinline__ float log_mu(const Problem& p, int b, int r, const Marginals& mg) {
  if (!row_valid(p, b, r)) return kMasked;
  return r < p.m ? mg.norm : mg.log_nc + mg.norm;
}

__device__ __forceinline__ float log_nu(const Problem& p, int b, int c, const Marginals& mg) {
  if (!col_valid(p, b, c)) return kMasked;
  return c < p.n ? mg.norm : mg.log_nr + mg.norm;
}

// torch.logsumexp's treatment of the maximum
__device__ __forceinline__ float finite_max(float m) { return isinf(m) ? 0.f : m; }

template <int G>
__device__ __forceinline__ float group_max(float x) {
#pragma unroll
  for (int o = G / 2; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

template <int G>
__device__ __forceinline__ float group_sum(float x) {
#pragma unroll
  for (int o = G / 2; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// marginal - logsumexp over the V values of each lane of a G-lane group
template <int G, int V>
__device__ __forceinline__ float half_step(const float (&x)[V], float marginal) {
  float m = x[0];
#pragma unroll
  for (int k = 1; k < V; ++k) m = fmaxf(m, x[k]);
  m = finite_max(group_max<G>(m));
  float s = 0.f;
#pragma unroll
  for (int k = 0; k < V; ++k) s += expf(x[k] - m);
  s = group_sum<G>(s);
  return marginal - (logf(s) + m);
}

// Register variant: thread t is lane l = t % G of group g = t / G; group g
// owns row g in the row pass and column g in the column pass.
template <int V>
__global__ void __launch_bounds__(1024) sinkhorn_reg_kernel(Problem p) {
  constexpr int G = kGroup;
  __shared__ float su[G * V], sv[G * V];
  const int b = blockIdx.x;
  const int rows = p.m + 1, cols = p.n + 1;
  const int g = threadIdx.x / G, l = threadIdx.x % G;
  const Marginals mg = marginals(p, b);
  const float alpha = *p.alpha;

  float zr[V], zc[V];
#pragma unroll
  for (int k = 0; k < V; ++k) {
    const int i = l + G * k;
    zr[k] = (g < rows && i < cols) ? padded(p, b, g, i, alpha) : -CUDART_INF_F;
    zc[k] = (g < cols && i < rows) ? padded(p, b, i, g, alpha) : -CUDART_INF_F;
  }
  const float mu = g < rows ? log_mu(p, b, g, mg) : 0.f;
  const float nu = g < cols ? log_nu(p, b, g, mg) : 0.f;
  for (int i = threadIdx.x; i < G * V; i += blockDim.x) su[i] = sv[i] = 0.f;
  __syncthreads();

  float x[V];
  for (int it = 0; it < p.iters; ++it) {
#pragma unroll
    for (int k = 0; k < V; ++k) x[k] = zr[k] + sv[l + G * k];
    const float u = half_step<G, V>(x, mu);
    if (l == 0 && g < rows) su[g] = u;
    __syncthreads();
#pragma unroll
    for (int k = 0; k < V; ++k) x[k] = zc[k] + su[l + G * k];
    const float v = half_step<G, V>(x, nu);
    if (l == 0 && g < cols) sv[g] = v;
    __syncthreads();
  }

  if (g < rows) {
    const float ug = su[g];
    float* ob = p.out + (static_cast<size_t>(b) * rows + g) * cols;
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const int c = l + G * k;
      if (c < cols) ob[c] = ((zr[k] + ug) + sv[c]) - mg.norm;
    }
  }
}

// General variant: z [R, C], u [R] and v [C] in shared memory; each warp
// reduces whole rows, then whole columns, in turn.
__global__ void __launch_bounds__(kGeneralThreads) sinkhorn_general_kernel(Problem p) {
  extern __shared__ float smem[];
  const int rows = p.m + 1, cols = p.n + 1, n = rows * cols;
  float* z = smem;          // [R, C]
  float* u = z + n;         // [R]
  float* v = u + rows;      // [C]
  const int b = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const Marginals mg = marginals(p, b);
  const float alpha = *p.alpha;
  for (int k = threadIdx.x; k < n; k += blockDim.x) z[k] = padded(p, b, k / cols, k % cols, alpha);
  for (int r = threadIdx.x; r < rows; r += blockDim.x) u[r] = 0.f;
  for (int c = threadIdx.x; c < cols; c += blockDim.x) v[c] = 0.f;
  __syncthreads();

  for (int it = 0; it < p.iters; ++it) {
    for (int r = warp; r < rows; r += kWarps) {
      const float* zr = z + r * cols;
      float m = -CUDART_INF_F;
      for (int c = lane; c < cols; c += 32) m = fmaxf(m, zr[c] + v[c]);
      m = finite_max(group_max<32>(m));
      float s = 0.f;
      for (int c = lane; c < cols; c += 32) s += expf((zr[c] + v[c]) - m);
      s = group_sum<32>(s);
      if (lane == 0) u[r] = log_mu(p, b, r, mg) - (logf(s) + m);
    }
    __syncthreads();
    for (int c = warp; c < cols; c += kWarps) {
      float m = -CUDART_INF_F;
      for (int r = lane; r < rows; r += 32) m = fmaxf(m, z[r * cols + c] + u[r]);
      m = finite_max(group_max<32>(m));
      float s = 0.f;
      for (int r = lane; r < rows; r += 32) s += expf((z[r * cols + c] + u[r]) - m);
      s = group_sum<32>(s);
      if (lane == 0) v[c] = log_nu(p, b, c, mg) - (logf(s) + m);
    }
    __syncthreads();
  }

  float* ob = p.out + static_cast<size_t>(b) * n;
  for (int k = threadIdx.x; k < n; k += blockDim.x) {
    const int r = k / cols, c = k - r * cols;
    ob[k] = ((z[k] + u[r]) + v[c]) - mg.norm;
  }
}

template <int V>
cudaError_t launch_reg(const Problem& p, int b, cudaStream_t st) {
  const int n = max(p.m + 1, p.n + 1);
  const int threads = (kGroup * n + 31) / 32 * 32;
  if (threads > 1024 || n > kGroup * V) return cudaErrorInvalidValue;
  sinkhorn_reg_kernel<V><<<b, threads, 0, st>>>(p);
  return cudaGetLastError();
}

// the register variant with `values` values per lane, V = 1 .. kMaxValues
template <int V = 1>
cudaError_t launch_values(const Problem& p, int b, int values, cudaStream_t st) {
  if (values == V) return launch_reg<V>(p, b, st);
  if constexpr (V < kMaxValues) {
    return launch_values<V + 1>(p, b, values, st);
  } else {
    return cudaErrorInvalidValue;
  }
}

cudaError_t launch_general(const Problem& p, int b, cudaStream_t st) {
  const size_t rows = p.m + 1, cols = p.n + 1;
  const size_t smem = sizeof(float) * (rows * cols + rows + cols);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        sinkhorn_general_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  sinkhorn_general_kernel<<<b, kGeneralThreads, smem, st>>>(p);
  return cudaGetLastError();
}

}  // namespace

// scores f32 [B,M,N]; row_mask u8 [B,M] or null; col_mask u8 [B,N] or null;
// alpha f32 [1]; out f32 [B,M+1,N+1]. values 0 takes the general variant,
// 1..8 the register variant with that many values per lane (the table of
// `ops/sinkhorn.py:sinkhorn_config`). Returns cudaGetLastError() after the
// launch, or cudaErrorInvalidValue for a variant not compiled.
extern "C" int nopesac_sinkhorn(const void* scores, const void* row_mask, const void* col_mask,
                                const void* alpha, void* out, int b, int m, int n, int iters,
                                int values, void* stream) {
  const Problem p{static_cast<const float*>(scores), static_cast<const uint8_t*>(row_mask),
                  static_cast<const uint8_t*>(col_mask), static_cast<const float*>(alpha),
                  static_cast<float*>(out), m, n, iters};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(values == 0 ? launch_general(p, b, st)
                                      : launch_values(p, b, values, st));
}
