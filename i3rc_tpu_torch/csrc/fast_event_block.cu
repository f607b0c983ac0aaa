// Fast event block, the variants without the gas channel, and the C
// interface of the library (see fast_event_block.cuh for the kernel: the
// Hopper port of the Pallas kernel `_build_pallas_block`,
// i3rc_tpu/integrators/fastpath.py:665).

#include "fast_event_block.cuh"

extern "C" {

int i3rc_event_params_size(void) { return (int)sizeof(EventParams); }

int i3rc_cta_threads(void) { return CTA_THREADS; }

// Runs one block of params->K events in place on the given stream, after
// the block's prologue when params->pro.on; with detectors it adds their
// contributions to acc; with a column table (col not null) it runs the
// column variant.  Returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue for an unsupported K, CHAIN, detector count or
// column combination; the Python wrapper checks those first).
int i3rc_fast_event_block(float* f, int* i, double* acc, const float4* col,
                          const EventParams* params, int chain, int absorbing,
                          int track_y, int detectors, int iwabuchi, int gas, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  bool ok;
  if (col != nullptr)
    ok = track_y && !detectors && !gas &&
         launch_block_col(f, i, col, *params, chain, absorbing, st);
  else if (gas)
    ok = launch_block_gas(f, i, acc, *params, chain, absorbing, track_y, detectors,
                          iwabuchi, st);
  else
    ok = launch_block<false>(f, i, acc, *params, chain, absorbing, track_y, detectors,
                             iwabuchi, st);
  if (!ok) return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Test entries: the kernel's Philox stream, exposed for bit-for-bit checks
// against i3rc_tpu_torch/core/rng.py.

__global__ void philox_uniforms_kernel(float* out, uint32_t k0, uint32_t k1,
                                       uint32_t block, uint32_t stream, int n_groups,
                                       int n_lanes) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n_lanes) return;
  for (int g = 0; g < n_groups; ++g) {
    uint32_t w[4];
    philox4x32_10((uint32_t)lane, block, (uint32_t)g, stream, k0, k1, w);
    for (int k = 0; k < 4; ++k) out[(size_t)(4 * g + k) * n_lanes + lane] = to_unit(w[k]);
  }
}

__global__ void philox_bits_kernel(uint32_t* out, uint32_t k0, uint32_t k1, uint32_t c1,
                                   uint32_t c2, uint32_t c3, int n_lanes) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n_lanes) return;
  uint32_t w[4];
  philox4x32_10((uint32_t)lane, c1, c2, c3, k0, k1, w);
  for (int k = 0; k < 4; ++k) out[4 * (size_t)lane + k] = w[k];
}

extern "C" {

// out: (4 * n_groups, n_lanes) float32, the rng.stream_uniforms layout.
int i3rc_philox_uniforms(float* out, unsigned int k0, unsigned int k1, unsigned int block,
                         unsigned int stream_id, int n_groups, int n_lanes, void* stream) {
  const int threads = 256;
  philox_uniforms_kernel<<<(n_lanes + threads - 1) / threads, threads, 0,
                           (cudaStream_t)stream>>>(out, k0, k1, block, stream_id,
                                                   n_groups, n_lanes);
  return (int)cudaGetLastError();
}

// out: (n_lanes, 4) uint32 words of Philox4x32-10 at counter (lane, c1, c2, c3).
int i3rc_philox_bits(unsigned int* out, unsigned int k0, unsigned int k1, unsigned int c1,
                     unsigned int c2, unsigned int c3, int n_lanes, void* stream) {
  const int threads = 256;
  philox_bits_kernel<<<(n_lanes + threads - 1) / threads, threads, 0,
                       (cudaStream_t)stream>>>(out, k0, k1, c1, c2, c3, n_lanes);
  return (int)cudaGetLastError();
}

}  // extern "C"
