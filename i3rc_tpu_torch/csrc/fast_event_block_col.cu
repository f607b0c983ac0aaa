// Fast event block, the column-mode variants: flux only, y tracked, the
// column table read once per event (the column event of the XLA fastpath,
// i3rc_tpu/integrators/fastpath.py:1320-1345, in the design of the TPU
// column-read probe `pallas_column_loop`, benchmarks/column_read_probe.py:83;
// see fast_event_block.cuh).  A source of its own so that nvcc builds these
// 32 instantiations (K in {1, 8, 16, 32}, chain depth 0-3, absorbing or not)
// in parallel with the others.  K = 32 is the column plans' default, the JAX
// planner's (i3rc_tpu/integrators/fastpath.py:633-635): a lane that dies
// early in a long block costs its warp nothing once the warp's lanes are all
// dead, and the CTA's compaction drops it from the next launch.

#include "fast_event_block.cuh"

template <int K, int CHAIN>
static void launch_col(float* f, int* i, const float4* col, const EventParams& p,
                       bool absorbing, cudaStream_t stream) {
  if (absorbing)
    launch<K, CHAIN, true, true, false, false, false, true>(f, i, nullptr, p, stream, col);
  else
    launch<K, CHAIN, false, true, false, false, false, true>(f, i, nullptr, p, stream, col);
}

template <int K>
static bool launch_col_chain(float* f, int* i, const float4* col, const EventParams& p,
                             int chain, bool absorbing, cudaStream_t stream) {
  switch (chain) {
    case 0: launch_col<K, 0>(f, i, col, p, absorbing, stream); return true;
    case 1: launch_col<K, 1>(f, i, col, p, absorbing, stream); return true;
    case 2: launch_col<K, 2>(f, i, col, p, absorbing, stream); return true;
    case 3: launch_col<K, 3>(f, i, col, p, absorbing, stream); return true;
    default: return false;
  }
}

bool launch_block_col(float* f, int* i, const float4* col, const EventParams& p, int K,
                      int chain, bool absorbing, cudaStream_t stream) {
  switch (K) {
    case 1: return launch_col_chain<1>(f, i, col, p, chain, absorbing, stream);
    case 8: return launch_col_chain<8>(f, i, col, p, chain, absorbing, stream);
    case 16: return launch_col_chain<16>(f, i, col, p, chain, absorbing, stream);
    case 32: return launch_col_chain<32>(f, i, col, p, chain, absorbing, stream);
    default: return false;
  }
}
