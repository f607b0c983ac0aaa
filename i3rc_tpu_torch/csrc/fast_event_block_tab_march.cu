// Fast event block, K3-M's table variant (TAB: the phase value of the
// forward fit) with the marching shadow trace (see fast_event_block_march.cu).
// A source of its own so that nvcc builds these instantiations in parallel
// with the others.

#include "fast_event_block.cuh"

bool launch_block_tab_march(float* f, int* i, double* acc, const EventParams& p,
                            bool absorbing, bool track_y, bool iwabuchi, cudaStream_t stream) {
  return launch_block_marching<true>(f, i, acc, p, absorbing, track_y, iwabuchi, stream);
}
