// K3: exclusive running max-by-key along each sun meridian + penumbra
// factor, theta split across thread blocks, two passes.
//
// Replaces the TPU kernel moonrtx_tpu/ops/shadow_prefix.py::
// shadow_factor_tpu (_make_kernel), which runs a Hillis-Steele prefix
// over (256, 512) tiles and carries each meridian's max in VMEM scratch
// across sequential theta grid steps.
//
// Bound on Hopper: memory. The map is read and the factor written (2 x
// 25 MB at accuracy 10); per texel a handful of multiplies and the atan2
// polynomial. A walk down whole columns (one thread per column, the
// first design) leaves the card empty: 4096 threads, every row waiting
// out a global load. Blocks run in no order here, so the carry cannot
// pass from one theta tile to the next as on the TPU. Design: the combine
//   (m1, z1) o (m2, z2) = m2 > m1 ? (m2, z2) : (m1, z1)
// is associative and keeps the earlier element on a tie, so a chunk of T
// rows folds to one aggregate (its first strict maximum), and aggregates
// folded in row order give the same carry at every row as the sequential
// walk: the output is bit-identical to it.
//   pass 1  shadow_chunk_max_kernel, grid (n_phi / 128, chunks - 1):
//           a thread folds the T rows of its column's chunk and writes
//           the aggregate (m, z) to scratch (chunks, n_phi) x 2;
//   pass 2  shadow_factor_kernel, grid (n_phi / 128, chunks): a thread
//           folds the aggregates of the chunks above its own (coalesced,
//           L2-resident loads that do not depend on one another), then
//           walks its T rows writing the factor.
// Both passes start a chunk's T loads before the compare-select chain, so
// a thread has T loads in flight; neighbouring threads own neighbouring
// columns, so every load and store coalesces. The heights are read twice
// (25 MB, the second time mostly from the 50 MB L2). Tie rule as the
// reference: strict > keeps the earlier row; the carry starts at (-1, 0),
// and so does every chunk's fold, which leaves the result unchanged
// because the carry never falls below -1.
#include "common.cuh"
#include "atan2_poly.cuh"

#define COLS 128   // threads of a block: neighbouring columns

template <int T>
__global__ void __launch_bounds__(COLS)
shadow_chunk_max_kernel(const float* __restrict__ hs,
                        const float* __restrict__ st,
                        const float* __restrict__ ct,
                        float* __restrict__ agg_m, float* __restrict__ agg_z,
                        int n_phi, float moon_radius) {
  const int col = blockIdx.x * COLS + threadIdx.x;
  if (col >= n_phi) return;
  // never launched on the last chunk, so all T rows exist
  const int t0 = blockIdx.y * T;
  float h[T];
#pragma unroll
  for (int i = 0; i < T; ++i) h[i] = hs[(long long)(t0 + i) * n_phi + col];
  float cm = -1.0f, cz = 0.0f;
#pragma unroll
  for (int i = 0; i < T; ++i) {
    const float r = __fmul_rn(moon_radius, h[i]);
    const float m = __fmul_rn(r, st[t0 + i]);
    if (m > cm) { cm = m; cz = __fmul_rn(r, ct[t0 + i]); }
  }
  const long long o = (long long)blockIdx.y * n_phi + col;
  agg_m[o] = cm;
  agg_z[o] = cz;
}

template <int T>
__global__ void __launch_bounds__(COLS)
shadow_factor_kernel(const float* __restrict__ hs,
                     const float* __restrict__ st,
                     const float* __restrict__ ct,
                     const float* __restrict__ agg_m,
                     const float* __restrict__ agg_z,
                     float* __restrict__ out, int n_theta, int n_phi,
                     float moon_radius, float sar) {
  const int col = blockIdx.x * COLS + threadIdx.x;
  if (col >= n_phi) return;
  const int chunk = blockIdx.y;
  const int t0 = chunk * T;
  float h[T];
#pragma unroll
  for (int i = 0; i < T; ++i)
    h[i] = t0 + i < n_theta ? hs[(long long)(t0 + i) * n_phi + col] : 0.0f;
  // the carry into this chunk: the chunks above it, in row order
  float cm = -1.0f, cz = 0.0f;
#pragma unroll 8
  for (int c = 0; c < chunk; ++c) {
    const float am = agg_m[(long long)c * n_phi + col];
    const float az = agg_z[(long long)c * n_phi + col];
    if (am > cm) { cm = am; cz = az; }
  }
  const float two_sar = __fmul_rn(2.0f, sar);
#pragma unroll
  for (int i = 0; i < T; ++i) {
    const int t = t0 + i;
    if (t < n_theta) {
      const float r = __fmul_rn(moon_radius, h[i]);
      const float m = __fmul_rn(r, st[t]);
      const float z = __fmul_rn(r, ct[t]);
      const float dz = fmaxf(__fsub_rn(cz, z), 1e-6f);
      const float alpha = mrtx_atan2(__fsub_rn(cm, m), dz);
      float f = __fsub_rn(0.5f, __fdiv_rn(alpha, two_sar));
      f = fminf(fmaxf(f, 0.0f), 1.0f);
      out[(long long)t * n_phi + col] = cm < 0.0f ? 1.0f : f;
      if (m > cm) { cm = m; cz = z; }
    }
  }
}

template <int T>
static int launch(const float* hs, const float* st, const float* ct,
                  float* scratch, float* out, int n_theta, int n_phi,
                  float moon_radius, float sar, cudaStream_t stream) {
  const int chunks = (n_theta + T - 1) / T;
  float* agg_m = scratch;
  float* agg_z = scratch + (long long)chunks * n_phi;
  const dim3 grid((n_phi + COLS - 1) / COLS, chunks);
  if (chunks > 1) {
    shadow_chunk_max_kernel<T>
        <<<dim3(grid.x, chunks - 1), COLS, 0, stream>>>(
            hs, st, ct, agg_m, agg_z, n_phi, moon_radius);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  shadow_factor_kernel<T><<<grid, COLS, 0, stream>>>(
      hs, st, ct, agg_m, agg_z, out, n_theta, n_phi, moon_radius, sar);
  return (int)cudaGetLastError();
}

// scratch: 2 x ceil(n_theta / chunk_rows) x n_phi floats
MRTX_EXPORT int mrtx_shadow_factor(const float* hs, const float* st,
                                   const float* ct, float* scratch,
                                   float* out, int n_theta, int n_phi,
                                   float moon_radius, float sar,
                                   int chunk_rows, cudaStream_t stream) {
  if (n_phi == 0 || n_theta == 0) return 0;
  switch (chunk_rows) {
    case 16: return launch<16>(hs, st, ct, scratch, out, n_theta, n_phi,
                               moon_radius, sar, stream);
    case 32: return launch<32>(hs, st, ct, scratch, out, n_theta, n_phi,
                               moon_radius, sar, stream);
    case 64: return launch<64>(hs, st, ct, scratch, out, n_theta, n_phi,
                               moon_radius, sar, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

MRTX_ERROR_STRING_FN
