// Column-read probe: a K-event loop whose every event reads one row of a
// (n_cols, 4) float32 column table, then applies a toy advance and wrap.
// Hopper (sm_90a) port of the TPU probe `pallas_column_loop`
// (benchmarks/column_read_probe.py:83, pallas_call at :140), the candidate
// design of a column-mode event block on the TPU.  The TPU kernel held the
// table in VMEM, field-major (128, 4 x 128), and read it with two 128-wide
// one-hot contractions per event; here each thread reads its row with one
// 16-byte __ldg, the table staying resident in the 50 MB L2.
//
// Per event (column_read_probe.py:104-132): ix, iy = clip(int(x * 128)),
// clip(int(y * 128)); [v, zb, zt, ss] = table[ix * 128 + iy]; one uniform u;
// x += (v - zb 0.001 + zt 0.001 + ss 0) 0.01 + u 0.001, wrapped to [0, 1);
// y += u 0.002 + v 0.005, wrapped; acc += v.  acc is the sum over this
// launch's K events, as the probe's kernel zeroes it per call.  The uniform
// is draw 0 of event j in the event block's Philox layout (counter (lane,
// kb, j, STREAM_EVENT), word 0) in place of the TPU's hardware PRNG.
//
// What bounds it: latency of the dependent chain load -> update -> next
// index, and the Philox call per event; device memory traffic is 12 B read
// and written per lane per launch plus one pass over the 256 KB table.
//
// Built with --fmad=false, like the event block, so that it agrees bit for
// bit with its PyTorch twin (kernels/column_probe.py).

#include <cuda_runtime.h>
#include <stdint.h>

#include "fast_event_block.cuh"

#define PROBE_N 128
#define PROBE_K 8

__global__ void __launch_bounds__(256)
column_read_probe_kernel(float* __restrict__ x, float* __restrict__ y,
                         float* __restrict__ acc, const float4* __restrict__ table,
                         int n_lanes, uint32_t k0, uint32_t k1, uint32_t kb) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n_lanes) return;
  float xs = x[lane], ys = y[lane], a = 0.0f;
#pragma unroll 1
  for (int j = 0; j < PROBE_K; ++j) {
    const int ix = min(max((int)(xs * 128.0f), 0), PROBE_N - 1);
    const int iy = min(max((int)(ys * 128.0f), 0), PROBE_N - 1);
    const float4 r = __ldg(table + ix * PROBE_N + iy);
    uint32_t w[4];
    philox4x32_10((uint32_t)lane, kb, (uint32_t)j, STREAM_EVENT, k0, k1, w);
    const float u = to_unit(w[0]);
    xs = (xs + (((r.x - r.y * 0.001f) + r.z * 0.001f) + r.w * 0.0f) * 0.01f) + u * 0.001f;
    xs = xs - floorf(xs);
    ys = (ys + u * 0.002f) + r.x * 0.005f;
    ys = ys - floorf(ys);
    a = a + r.x;
  }
  x[lane] = xs;
  y[lane] = ys;
  acc[lane] = a;
}

extern "C" {

// x, y: (L,) float32 updated in place; acc: (L,) float32 written; table:
// (128 * 128, 4) float32.  Returns cudaGetLastError() after the launch.
int i3rc_column_read_probe(float* x, float* y, float* acc, const float4* table, int n_lanes,
                           unsigned int k0, unsigned int k1, unsigned int kb, void* stream) {
  const int threads = 256;
  column_read_probe_kernel<<<(n_lanes + threads - 1) / threads, threads, 0,
                             (cudaStream_t)stream>>>(x, y, acc, table, n_lanes, k0, k1, kb);
  return (int)cudaGetLastError();
}

}  // extern "C"
