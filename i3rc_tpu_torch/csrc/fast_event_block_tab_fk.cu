// Fast event block, the fused-k variants of the table gas channel (TAB and
// FK: a tabulated cloud plus a k-distribution gas with every k point of the
// band in one trace, the JAX package's production broadband class,
// i3rc_tpu/integrators/fastpath.py:527-536, :966-1057; see
// fast_event_block.cuh).  A source of its own so that nvcc builds these
// instantiations in parallel with the others.

#include "fast_event_block.cuh"

bool launch_block_tab_fk(float* f, int* i, double* acc, const EventParams& p, int chain,
                         bool absorbing, bool track_y, bool detectors, bool iwabuchi,
                         cudaStream_t stream) {
  return launch_block<true, true, true>(f, i, acc, p, chain, absorbing, track_y, detectors,
                                        iwabuchi, stream);
}
