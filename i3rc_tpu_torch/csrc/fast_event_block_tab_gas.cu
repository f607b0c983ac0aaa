// Fast event block, the table variants with the gas channel (TAB and GAS: a
// tabulated cloud plus a k-distribution gas, the cubic sampler built from
// the cloud component's table; i3rc_tpu/integrators/fastpath.py:527-553; see
// fast_event_block.cuh).  A source of its own so that nvcc builds these
// instantiations in parallel with the others.

#include "fast_event_block.cuh"

bool launch_block_tab_gas(float* f, int* i, double* acc, const EventParams& p, int chain,
                          bool absorbing, bool track_y, bool detectors, bool iwabuchi,
                          cudaStream_t stream) {
  return launch_block<true, true>(f, i, acc, p, chain, absorbing, track_y, detectors,
                                  iwabuchi, stream);
}
