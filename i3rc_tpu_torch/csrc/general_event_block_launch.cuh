// The launch of the general event block's instantiations, shared by
// general_event_block.cu (the flux set) and general_event_block_det.cu (the
// set with radiance detectors): one set per translation unit, so the two
// compile in parallel.

#pragma once

#include "general_event_block.cuh"

// One CTA per tile of CTA_THREADS lanes; with T > 1 tiles a CTA the CTAs
// that do not work return after the prologue's density estimate.
template <int MODE, bool UNI, bool REFL, bool BERN, bool DET>
static void launch_general(float* f, int* i, const GeneralParams& p, cudaStream_t stream) {
  const int blocks = (p.n_lanes + CTA_THREADS - 1) / CTA_THREADS;
  general_event_block_kernel<MODE, UNI, REFL, BERN, DET>
      <<<blocks, CTA_THREADS, 0, stream>>>(f, i, p);
}

template <int MODE, bool DET>
static void launch_mode(float* f, int* i, const GeneralParams& p, bool uniform, bool reflecting,
                        cudaStream_t stream) {
  if (uniform) {
    if (reflecting) launch_general<MODE, true, true, false, DET>(f, i, p, stream);
    else launch_general<MODE, true, false, false, DET>(f, i, p, stream);
  } else {
    if (reflecting) launch_general<MODE, false, true, false, DET>(f, i, p, stream);
    else launch_general<MODE, false, false, false, DET>(f, i, p, stream);
  }
}

// The 13 instantiations of one DET value, by mode, optics, surface and the
// weight-1 class (checked by i3rc_general_event_block).
template <bool DET>
static void launch_set(float* f, int* i, const GeneralParams& p, int mode, bool uniform,
                       bool reflecting, bool bernoulli, cudaStream_t stream) {
  if (bernoulli) launch_general<MODE_WOOD, true, false, true, DET>(f, i, p, stream);
  else if (mode == MODE_RT) launch_mode<MODE_RT, DET>(f, i, p, uniform, reflecting, stream);
  else if (mode == MODE_MAX) launch_mode<MODE_MAX, DET>(f, i, p, uniform, reflecting, stream);
  else launch_mode<MODE_WOOD, DET>(f, i, p, uniform, reflecting, stream);
}

// launch_set<false> and launch_set<true>, each defined in its own
// translation unit.
void launch_general_flux(float* f, int* i, const GeneralParams& p, int mode, bool uniform,
                         bool reflecting, bool bernoulli, cudaStream_t stream);
void launch_general_det(float* f, int* i, const GeneralParams& p, int mode, bool uniform,
                        bool reflecting, bool bernoulli, cudaStream_t stream);
