// Masked log-domain Sinkhorn iterations over a dustbin-padded coupling.
//
// Replaces the TPU kernel `log_optimal_transport_masked_pallas`
// (`_sinkhorn_kernel`, `ops/sinkhorn_pallas.py` of the JAX package). Input is
// the output of the shared prologue (`core/sinkhorn.py:masked_ot_prologue`):
// z [B, R, C] (invalid rows/cols already at -1e5), log_mu [B, R],
// log_nu [B, C], norm [B]. It runs `iters` rounds of
//   u = log_mu - logsumexp_c(z + v),   v = log_nu - logsumexp_r(z + u)
// and writes z + u + v - norm once.
//
// What bounds it on the H100: neither bytes nor operations but latency. At the
// main-path shape ([4, 51, 51], 200 iterations) the whole problem is 42 KB and
// ~12 MFLOP; what costs is 400 dependent reductions. Run as plain PyTorch it
// is ~8 kernel launches per half-iteration, each re-reading z from memory.
// Design: one block per batch element keeps z (10.4 KB at 51x51), u and v in
// shared memory for all iterations. The row pass gives each warp whole rows
// (max, then sum of exp, both with __shfl_xor_sync butterflies); after a
// __syncthreads the column pass does the same over columns (a column read is
// conflict-free because the row stride is odd). One launch for the whole loop.
//
// Numerics: expf/logf (no fast-math intrinsics) and the finite -1e5 masking
// of the prologue (never -inf). The reduction order differs from
// torch.logsumexp, so results agree with the plain loop to ~1e-5, not bitwise.
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kWarps = 16;

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__global__ void __launch_bounds__(32 * kWarps)
sinkhorn_kernel(const float* __restrict__ z_in,    // [B, R, C]
                const float* __restrict__ log_mu,  // [B, R]
                const float* __restrict__ log_nu,  // [B, C]
                const float* __restrict__ norm,    // [B]
                float* __restrict__ out,           // [B, R, C]
                int rows, int cols, int iters) {
  extern __shared__ float smem[];
  float* z = smem;               // [R, C]
  float* u = z + rows * cols;    // [R]
  float* v = u + rows;           // [C]
  const int b = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n = rows * cols;
  const float* zb = z_in + static_cast<size_t>(b) * n;

  for (int k = tid; k < n; k += blockDim.x) z[k] = zb[k];
  for (int r = tid; r < rows; r += blockDim.x) u[r] = 0.f;
  for (int c = tid; c < cols; c += blockDim.x) v[c] = 0.f;
  __syncthreads();

  const float* mu = log_mu + static_cast<size_t>(b) * rows;
  const float* nu = log_nu + static_cast<size_t>(b) * cols;

  for (int it = 0; it < iters; ++it) {
    // u = log_mu - logsumexp over columns of (z + v)
    for (int r = warp; r < rows; r += kWarps) {
      const float* zr = z + r * cols;
      float m = -CUDART_INF_F;
      for (int c = lane; c < cols; c += 32) m = fmaxf(m, zr[c] + v[c]);
      m = warp_max(m);
      float s = 0.f;
      for (int c = lane; c < cols; c += 32) s += expf((zr[c] + v[c]) - m);
      s = warp_sum(s);
      if (lane == 0) u[r] = mu[r] - (logf(s) + m);
    }
    __syncthreads();
    // v = log_nu - logsumexp over rows of (z + u)
    for (int c = warp; c < cols; c += kWarps) {
      float m = -CUDART_INF_F;
      for (int r = lane; r < rows; r += 32) m = fmaxf(m, z[r * cols + c] + u[r]);
      m = warp_max(m);
      float s = 0.f;
      for (int r = lane; r < rows; r += 32) s += expf((z[r * cols + c] + u[r]) - m);
      s = warp_sum(s);
      if (lane == 0) v[c] = nu[c] - (logf(s) + m);
    }
    __syncthreads();
  }

  const float nb = norm[b];
  float* ob = out + static_cast<size_t>(b) * n;
  for (int k = tid; k < n; k += blockDim.x) {
    const int r = k / cols, c = k - r * cols;
    ob[k] = ((z[k] + u[r]) + v[c]) - nb;
  }
}

}  // namespace

// z/out f32 [B,R,C]; log_mu f32 [B,R]; log_nu f32 [B,C]; norm f32 [B].
// Returns cudaGetLastError() after the launch.
extern "C" int nopesac_sinkhorn(const void* z, const void* log_mu, const void* log_nu,
                                const void* norm, void* out, int b, int rows, int cols,
                                int iters, void* stream) {
  const size_t smem = sizeof(float) * (static_cast<size_t>(rows) * cols + rows + cols);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        sinkhorn_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  sinkhorn_kernel<<<b, 32 * kWarps, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(z), static_cast<const float*>(log_mu),
      static_cast<const float*>(log_nu), static_cast<const float*>(norm),
      static_cast<float*>(out), rows, cols, iters);
  return static_cast<int>(cudaGetLastError());
}
