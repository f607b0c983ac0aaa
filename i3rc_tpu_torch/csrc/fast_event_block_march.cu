// Fast event block, K3-M: the detector variant with the marching shadow
// trace (march_step in fast_event_block.cuh, the trace `shadow_trace` of
// i3rc_tpu/integrators/fastpath.py:1061-1127, XLA in the path of the Pallas
// kernel `_build_pallas_block`, fastpath.py:665), its rays queued a record a
// collision and traced by the CTA after its lanes' events (march_flush), HG.  A source of its own
// so that nvcc builds these instantiations in parallel with the others.

#include "fast_event_block.cuh"

bool launch_block_march(float* f, int* i, double* acc, const EventParams& p, bool absorbing,
                        bool track_y, bool iwabuchi, cudaStream_t stream) {
  return launch_block_marching<false>(f, i, acc, p, absorbing, track_y, iwabuchi, stream);
}
