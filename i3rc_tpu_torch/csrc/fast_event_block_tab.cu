// Fast event block, the table variants without the gas channel (TAB: the
// cubic inverse-CDF sampler and, with detectors, the forward fit of the phase
// value; the table modes of the XLA fastpath, i3rc_tpu/integrators/
// fastpath.py:1573-1586 and :1508-1520, in the kernel that ports the Pallas
// kernel `_build_pallas_block`, fastpath.py:665; see fast_event_block.cuh).
// A source of its own so that nvcc builds these instantiations in parallel
// with the others.

#include "fast_event_block.cuh"

bool launch_block_tab(float* f, int* i, double* acc, const EventParams& p, int chain,
                      bool absorbing, bool track_y, bool detectors, bool iwabuchi,
                      cudaStream_t stream) {
  return launch_block<false, true>(f, i, acc, p, chain, absorbing, track_y, detectors,
                                   iwabuchi, stream);
}
