// The general event block's flux instantiations and C interface (see
// general_event_block.cuh: K events of the general transport kernel per
// lane, the JAX package's XLA `make_batch_tracer`,
// i3rc_tpu/integrators/wavefront.py:657).  Thirteen instantiations: the
// transport mode (ray tracing, maximum cross-section, Woodcock) x uniform
// single-component or general optics x black or reflecting surface, and the
// weight-1 class (Woodcock, uniform, black).  The thirteen with radiance
// detectors (DET) are in general_event_block_det.cu, compiled beside this
// file by its own nvcc process; this file's C function launches either set.

#include "general_event_block_launch.cuh"

void launch_general_flux(float* f, int* i, const GeneralParams& p, int mode, bool uniform,
                         bool reflecting, bool bernoulli, cudaStream_t stream) {
  launch_set<false>(f, i, p, mode, uniform, reflecting, bernoulli, stream);
}

extern "C" {

int i3rc_general_params_size(void) { return (int)sizeof(GeneralParams); }

// Runs one block (params->K events, after the refill) in place on the given
// stream, with the local estimate of params->n_dirs > 0 detectors.  mode: 0
// ray tracing, 1 maximum cross-section, 2 Woodcock; bernoulli: the weight-1
// class (Woodcock, uniform optics, black surface only).  Returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue for a
// combination that is not built (the Python wrapper's launch_refusal checks
// first).
int i3rc_general_event_block(float* f, int* i, const GeneralParams* params, int mode,
                             int uniform, int reflecting, int bernoulli, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const GeneralParams& p = *params;
  if (p.K < 1 || p.n_draws > GEN_MAX_DRAWS || p.n_params > MAX_BRDF_PARAMS || p.n_dirs < 0
      || (p.n_dirs > 0 && p.n_comp + 1 > GEN_RAY_MAX_SLOT))
    return (int)cudaErrorInvalidValue;
  if (mode < MODE_RT || mode > MODE_WOOD) return (int)cudaErrorInvalidValue;
  if (bernoulli && (mode != MODE_WOOD || !uniform || reflecting))
    return (int)cudaErrorInvalidValue;
  // The instantiations read their draws from the slots the variant's order
  // gives (slot_*); the parameters' slots must be those.
  const int srf = slot_srf(mode, reflecting), extra = slot_extra(mode, uniform, reflecting);
  if (p.d_accept != slot_accept(mode) || p.d_srf_mu != srf
      || p.d_srf_phi != (srf < 0 ? -1 : srf + 1) || p.d_comp != slot_comp(mode, uniform, reflecting)
      || (p.d_extra != -1 && p.d_extra != extra) || p.n_draws != (p.d_extra < 0 ? extra : extra + 1))
    return (int)cudaErrorInvalidValue;
  if (p.n_dirs > 0) launch_general_det(f, i, p, mode, uniform, reflecting, bernoulli, st);
  else launch_general_flux(f, i, p, mode, uniform, reflecting, bernoulli, st);
  return (int)cudaGetLastError();
}

}  // extern "C"
