// Fast event block, the gas-channel variants (gas=True of the Pallas kernel
// `_build_pallas_block`, i3rc_tpu/integrators/fastpath.py:665; see
// fast_event_block.cuh).  A source of its own so that nvcc builds these
// instantiations in parallel with the others.

#include "fast_event_block.cuh"

bool launch_block_gas(float* f, int* i, double* acc, const EventParams& p, int chain,
                      bool absorbing, bool track_y, bool detectors, bool iwabuchi,
                      cudaStream_t stream) {
  return launch_block<true, false>(f, i, acc, p, chain, absorbing, track_y, detectors,
                                   iwabuchi, stream);
}
