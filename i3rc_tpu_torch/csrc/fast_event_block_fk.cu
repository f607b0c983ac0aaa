// Fast event block, the fused-k variants of the gas channel (FK: every k
// point of a spectral band in one trace, k a per-lane attribute; the XLA
// fastpath's gask_mode, i3rc_tpu/integrators/fastpath.py:966-1057, :1409-1470,
// in the kernel that ports the Pallas kernel `_build_pallas_block`,
// fastpath.py:665; see fast_event_block.cuh).  Chain depth 0: flux and the
// detector variants.  A source of its own so that nvcc builds these
// instantiations in parallel with the others.

#include "fast_event_block.cuh"

bool launch_block_fk(float* f, int* i, double* acc, const EventParams& p, int chain,
                     bool absorbing, bool track_y, bool detectors, bool iwabuchi,
                     cudaStream_t stream) {
  return launch_block<true, false, true>(f, i, acc, p, chain, absorbing, track_y, detectors,
                                         iwabuchi, stream);
}
