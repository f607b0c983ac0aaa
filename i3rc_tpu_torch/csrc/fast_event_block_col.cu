// Fast event block, the column-mode variants: flux only, y tracked, the
// column table read once per event (the column event of the XLA fastpath,
// i3rc_tpu/integrators/fastpath.py:1320-1345, in the design of the TPU
// column-read probe `pallas_column_loop`, benchmarks/column_read_probe.py:83;
// see fast_event_block.cuh).  A source of its own so that nvcc builds these
// 16 instantiations (chain depth 0-3, absorbing or not, HG or table: a
// single-entry tabulated table, or per-column ssa and table entries) in
// parallel with the others; deeper chains run the runtime-depth ones of
// fast_event_block_deep.cu.  Column plans run K = 32 events per launch by default, the JAX
// planner's K (i3rc_tpu/integrators/fastpath.py:633-635): a lane that dies
// early in a long block costs its warp nothing once the warp's lanes are all
// dead, and the CTA's compaction drops it from the next launch.

#include "fast_event_block.cuh"

template <int CHAIN, bool TAB>
static void launch_col(float* f, int* i, const float4* col, const EventParams& p,
                       bool absorbing, cudaStream_t stream) {
  constexpr int DS = DET_DRAWS_SMALL;
  if (absorbing)
    launch<CHAIN, true, true, false, false, false, true, DS, TAB>(f, i, nullptr, p, stream, col);
  else
    launch<CHAIN, false, true, false, false, false, true, DS, TAB>(f, i, nullptr, p, stream, col);
}

template <bool TAB>
static bool launch_col_chain(float* f, int* i, const float4* col, const EventParams& p,
                             int chain, bool absorbing, cudaStream_t stream) {
  switch (chain) {
    case 0: launch_col<0, TAB>(f, i, col, p, absorbing, stream); return true;
    case 1: launch_col<1, TAB>(f, i, col, p, absorbing, stream); return true;
    case 2: launch_col<2, TAB>(f, i, col, p, absorbing, stream); return true;
    case 3: launch_col<3, TAB>(f, i, col, p, absorbing, stream); return true;
    default: return launch_block_col_deep(f, i, col, p, chain, absorbing, TAB, stream);
  }
}

bool launch_block_col(float* f, int* i, const float4* col, const EventParams& p, int chain,
                      bool absorbing, bool table, cudaStream_t stream) {
  if (p.K < 1) return false;
  return table ? launch_col_chain<true>(f, i, col, p, chain, absorbing, stream)
               : launch_col_chain<false>(f, i, col, p, chain, absorbing, stream);
}
