// The general event block's instantiations and C interface (see
// general_event_block.cuh: K events of the general transport kernel's flux
// path per lane, the JAX package's XLA `make_batch_tracer`,
// i3rc_tpu/integrators/wavefront.py:657).  Thirteen instantiations: the
// transport mode (ray tracing, maximum cross-section, Woodcock) x uniform
// single-component or general optics x black or reflecting surface, and the
// weight-1 class (Woodcock, uniform, black).

#include "general_event_block.cuh"

// One CTA per tile of CTA_THREADS lanes; with T > 1 tiles a CTA the CTAs
// that do not work return after the prologue's density estimate.
template <int MODE, bool UNI, bool REFL, bool BERN>
static void launch_general(float* f, int* i, const GeneralParams& p, cudaStream_t stream) {
  const int blocks = (p.n_lanes + CTA_THREADS - 1) / CTA_THREADS;
  general_event_block_kernel<MODE, UNI, REFL, BERN><<<blocks, CTA_THREADS, 0, stream>>>(f, i, p);
}

template <int MODE>
static void launch_mode(float* f, int* i, const GeneralParams& p, bool uniform, bool reflecting,
                        cudaStream_t stream) {
  if (uniform) {
    if (reflecting) launch_general<MODE, true, true, false>(f, i, p, stream);
    else launch_general<MODE, true, false, false>(f, i, p, stream);
  } else {
    if (reflecting) launch_general<MODE, false, true, false>(f, i, p, stream);
    else launch_general<MODE, false, false, false>(f, i, p, stream);
  }
}

extern "C" {

int i3rc_general_params_size(void) { return (int)sizeof(GeneralParams); }

// Runs one block (params->K events, after the refill) in place on the given
// stream.  mode: 0 ray tracing, 1 maximum cross-section, 2 Woodcock;
// bernoulli: the weight-1 class (Woodcock, uniform optics, black surface
// only).  Returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for a combination that is not built (the Python
// wrapper's launch_refusal checks first).
int i3rc_general_event_block(float* f, int* i, const GeneralParams* params, int mode,
                             int uniform, int reflecting, int bernoulli, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const GeneralParams& p = *params;
  if (p.K < 1 || p.n_draws > GEN_MAX_DRAWS || p.n_params > MAX_BRDF_PARAMS)
    return (int)cudaErrorInvalidValue;
  if (bernoulli) {
    if (mode != MODE_WOOD || !uniform || reflecting) return (int)cudaErrorInvalidValue;
    launch_general<MODE_WOOD, true, false, true>(f, i, p, st);
  } else if (mode == MODE_RT) {
    launch_mode<MODE_RT>(f, i, p, uniform, reflecting, st);
  } else if (mode == MODE_MAX) {
    launch_mode<MODE_MAX>(f, i, p, uniform, reflecting, st);
  } else if (mode == MODE_WOOD) {
    launch_mode<MODE_WOOD>(f, i, p, uniform, reflecting, st);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
