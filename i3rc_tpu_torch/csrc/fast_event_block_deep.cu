// Fast event block, the runtime-depth variants: collision chaining past the
// depths that have instantiations of their own (0-3), at any depth
// EventParams.chain >= 1 (JAX's fastpath_chain, i3rc_tpu/integrators/
// fastpath.py:1283-1286, in the kernel that ports the Pallas kernel
// `_build_pallas_block`, fastpath.py:665; see fast_event_block.cuh).  A
// bonus phase draws its words when the chain reaches it, from the same
// Philox counters (lane, kb, j * G + g, STREAM_EVENT) as the eager variants,
// each group once (the last group drawn is kept for the next phase), so the
// kernel stays bit-equal to the twin at every depth and holds the same few
// draw registers whatever the depth.  Flux only (detectors and fused-k run at
// depth 0): separable, with or without the gas channel, HG or table (16
// instantiations), and the column variants (4).  A source of its own so that
// nvcc builds these in parallel with the others.

#include "fast_event_block.cuh"

template <bool GAS, bool TAB>
static void launch_deep(float* f, int* i, double* acc, const EventParams& p, bool absorbing,
                        bool track_y, cudaStream_t stream) {
  launch_flags<CHAIN_RUNTIME, false, false, GAS, DET_DRAWS_SMALL, TAB>(f, i, acc, p, absorbing,
                                                                       track_y, stream);
}

bool launch_block_deep(float* f, int* i, double* acc, const EventParams& p, int chain, bool gas,
                       bool table, bool absorbing, bool track_y, cudaStream_t stream) {
  if (p.K < 1 || chain < 1 || p.chain != chain) return false;
  if (gas)
    (table ? launch_deep<true, true> : launch_deep<true, false>)(f, i, acc, p, absorbing,
                                                                  track_y, stream);
  else
    (table ? launch_deep<false, true> : launch_deep<false, false>)(f, i, acc, p, absorbing,
                                                                    track_y, stream);
  return true;
}

template <bool TAB>
static void launch_col_deep(float* f, int* i, const float4* col, const EventParams& p,
                            bool absorbing, cudaStream_t stream) {
  constexpr int DS = DET_DRAWS_SMALL;
  if (absorbing)
    launch<CHAIN_RUNTIME, true, true, false, false, false, true, DS, TAB>(f, i, nullptr, p,
                                                                          stream, col);
  else
    launch<CHAIN_RUNTIME, false, true, false, false, false, true, DS, TAB>(f, i, nullptr, p,
                                                                           stream, col);
}

bool launch_block_col_deep(float* f, int* i, const float4* col, const EventParams& p, int chain,
                           bool absorbing, bool table, cudaStream_t stream) {
  if (p.K < 1 || chain < 1 || p.chain != chain) return false;
  (table ? launch_col_deep<true> : launch_col_deep<false>)(f, i, col, p, absorbing, stream);
  return true;
}
