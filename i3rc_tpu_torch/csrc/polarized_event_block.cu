// The polarized event block PZ's four instantiations and C interface (see
// polarized_event_block.cuh: K events of Stokes-vector transport per lane,
// the JAX package's XLA `make_polarized_tracer`,
// i3rc_tpu/integrators/polarized.py:455 and :328): flux, radiance detectors
// (DET), a Lambertian surface (LAMB), and both.

#include "polarized_event_block.cuh"

template <bool DET, bool LAMB>
static void launch_pz(float* f, int* i, const PolParams& p, cudaStream_t stream) {
  const int blocks = (p.n_lanes + CTA_THREADS - 1) / CTA_THREADS;
  polarized_event_block_kernel<DET, LAMB><<<blocks, CTA_THREADS, 0, stream>>>(f, i, p);
}

extern "C" {

int i3rc_polarized_params_size(void) { return (int)sizeof(PolParams); }

// Runs one block (params->K events, after the refill) in place on the given
// stream: det and lamb pick the instantiation (params->n_dirs > 0 and
// params->albedo > 0; the Python wrapper passes them so).  Returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue for
// parameters the kernel does not take.
int i3rc_polarized_event_block(float* f, int* i, const PolParams* params, int det, int lamb,
                               void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const PolParams& p = *params;
  if (p.K < 1 || p.n_lanes < 1 || p.n_comp < 1 || p.n_fwd < 2 || p.n_seg < 1
      || (det != 0) != (p.n_dirs > 0) || (lamb != 0) != (p.albedo > 0.0f))
    return (int)cudaErrorInvalidValue;
  if (det) {
    if (lamb) launch_pz<true, true>(f, i, p, st);
    else launch_pz<true, false>(f, i, p, st);
  } else {
    if (lamb) launch_pz<false, true>(f, i, p, st);
    else launch_pz<false, false>(f, i, p, st);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
