// The general event block's thirteen instantiations with radiance
// detectors (DET: the local estimate, general_event_block.cuh's ray queue
// and gen_flush), one per flux instantiation of
// general_event_block.cu, whose C function calls launch_general_det when the
// parameter block has detectors.

#include "general_event_block_launch.cuh"

void launch_general_det(float* f, int* i, const GeneralParams& p, int mode, bool uniform,
                        bool reflecting, bool bernoulli, cudaStream_t stream) {
  launch_set<true>(f, i, p, mode, uniform, reflecting, bernoulli, stream);
}
