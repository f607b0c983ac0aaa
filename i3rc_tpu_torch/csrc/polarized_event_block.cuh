// Polarized event block PZ: K events of Stokes-vector transport per lane,
// state in registers, with radiance detectors each collision's polarized
// local estimate.  Hopper (sm_90a) kernel for what the JAX package runs as
// XLA: the event loop of `make_polarized_tracer`
// (i3rc_tpu/integrators/polarized.py:455-633), a lax.while_loop over single
// events, with a nested while_loop per event for the ratio-tracking rounds
// of every detector ray (`detector_estimates`, :328-453).  It has no TPU
// kernel.  As torch ops an event costs ~150 launches and each ratio-tracking
// round a host sync on any(); here one thread runs one photon lane's events
// and its rays to their end.
//
// A launch is one block of the trace loop (kernels/polarized_block.py):
//  * the prologue (pz_prologue): dead lane l takes photon launched + rank(l),
//    rank its exclusive count of dead lanes over the grid at entry, while
//    that id is below the budget: the FIFO rank of the general kernel's
//    prologue (the last launch leaves each tile's dead count at exit in
//    dead[(kb + 1) & 1]), with the source sample of the general kernel
//    (source_sample: (lane, kb, group, STREAM_REFILL)), its meridian frame,
//    the source's Stokes vector, weight 1, order 0;
//  * K events of 8 draws each (groups 2j and 2j + 1 at (lane, kb, .,
//    STREAM_EVENT), in JAX's u8 order: free path, acceptance, component,
//    theta, chi, roulette, the Lambertian pair):
//      the free path against the global majorant, exits tallied at the
//      column of the boundary point (x/y wrapped); the depolarizing
//      Lambertian bounce (LAMB); the acceptance against the cell's
//      extinction, the component pick by cumulative fractions, the absorbed
//      weight; with detectors (DET) a record of a physical collision or a
//      Lambertian reflection in the CTA's ray queue (pz_push); the chi
//      rotation of the frame and of (Q, U), theta from P11's cubic inverse
//      CDF (one float4 row), the interpolated phase-matrix read (a row of 8
//      floats per endpoint: two float4 loads each), the weight ratio
//      I / a1, the renormalized Stokes vector, the new direction and frame
//      with the re-orthogonalization; the weight roulette at 0.01 and the
//      event budget (bad).
//  Exits and absorption add to the float64 column tallies (up, down,
//  absorbed), the estimates to the (n_cols, D, 4) Stokes tally, each summed
//  first over the lanes of the warp that tally the same bin together
//  (active_red of general_event_block.cuh, then red.global.add.f64): on a
//  scene of one column every lane of the grid adds to the same few bins:
//  with one atomic a lane a mid-flight bench-row block took 0.38 ms, summed
//  first 0.092 (NVIDIA H100 80GB HBM3, 700 W; PERF.md).
//  DET: after the lanes' events the CTA traces its queue's rays (pz_flush),
//    per (record, detector) the rotation of (Q, U) into the scattering plane toward
//    d, the matrix at the photon-to-detector angle, the rotation into d's
//    meridian frame (L(-a): the -s2a sign of polarized.py:383-393), w /
//    (4 pi |mu_d|) or, for a Lambertian reflection, w / pi toward upward
//    detectors, depolarized; times the ratio-tracking transmittance to the
//    boundary against the global majorant (draws of STREAM_INTENSITY at
//    intensity_group(j, d, round / 2), two words a round, roulette at zeta),
//    a ray alive after max_rounds counted bad.  The detector rows (direction,
//    meridian frame, |mu|) are a device array, so D has no cap.
//
// What bounds it.  Memory traffic is the lane state (19 rows) in and out
// per launch, a 4-byte extinction read per event and per ratio-tracking
// round, a 12-byte cell row and the 16-byte cubic row and four 16-byte
// matrix loads per collision (two more per detector ray), and the tallies:
// tables come from L2 through the read-only path.  The work is a lane's
// dependent chain: Philox rounds, logf, acosf, sqrtf and IEEE divisions,
// and the ratio-tracking loop of each detector ray.  Latency, not bytes or
// issue slots.  Thread l runs lane l, one CTA per tile of CTA_THREADS
// lanes: a warp waits for its slowest lane's events, and the drain runs
// sparse warps.  The first design also traced an event's D rays on the
// thread that collided: 313M rays and 559M rounds a Mie step-cloud batch,
// a warp waiting for its slowest lane's sum of rays (ray lane use 11%, the
// census of kernels/general_block.py ray_census).  The ray is now the unit
// of work, as in the general kernel's estimate stage:
//  * a collision or reflection pushes a record of four float4 (the point,
//    the weight, the direction, the frame e1, (q, u, v), the matrix row,
//    event and lane) to the CTA's segment of a device-memory queue, K
//    records a lane, so the queue never fills;
//  * after the lane loop's barrier every thread of the CTA pulls the
//    queue's rays detector by detector, one ratio-tracking round a trip; a
//    warp refills when at most PZ_REFILL_AT of its threads still have a
//    ray, the ended rays tallied together and new ones set up;
//  * the rays, rounds and bad rows reach the lanes by atomics after the
//    lanes stored them.
// A ray's draws are keyed by (lane, kb, event j, detector), so the kernel
// stays bit-equal to the twin.  Per batch against the first design in one
// process (NVIDIA H100 80GB HBM3, 700 W; PERF.md section 6): 0.46x on the
// Mie step cloud, 0.50x on the bench row (2^16 lanes); a warp-level buffer
// in shared memory flushed by the warp ran 0.71x and 0.57x.
//
// Float arithmetic follows the twin (integrators/polarized.py
// polarized_event) operation by operation, built with --fmad=false; where the
// JAX module uses rsqrt the kernel and the twin take 1 / sqrtf.

#pragma once

#include "general_event_block.cuh"

#define PZ_DRAWS 8
#define PZ_DET_COLS 12
#define ROULETTE_W_F 0x1.47ae14p-7f   // float32(0.01)
#define PZ_CTAS_PER_SM 3

// kernels/polarized_block.py _PolParams.
struct PolParams {
  Grid g;
  const float* total_ext;       // (n_cells)
  const float* cells;           // (n_cells, 3 n_comp): cum | ssa | phase index
  const float4* cubic;          // (n_comp * max_entries * n_seg) rows
  const float4* matrix;         // (n_comp * max_entries * n_fwd, 2): 8 floats a row
  const float* det;             // (n_dirs, PZ_DET_COLS): d, m1, m2, |mu|
  double* columns;              // (n_cols, 3) float64: up, down, absorbed
  double* intensity;            // (n_cols * n_dirs * 4) float64
  long long* ctl;               // launched (kb even), launched (kb odd), done, spent
  int* dead;                    // (2, n_tiles) dead lanes per tile at entry of even / odd kb
  SourceParams src;
  long long n_photons;
  int n_comp, max_entries, n_seg, n_fwd, n_dirs, max_events, max_rounds, n_lanes, K;
  float inv_maj, albedo, q0, u0, v0, zeta;
  unsigned int key0, key1, kb;
  unsigned long long* flushes;  // the estimate's flushes, or null
  float4* rays;                 // (n_tiles * CTA_THREADS * K * PZ_RAY_F4) the ray records
};

struct PzLane {
  float x, y, z, ux, uy, uz, e1x, e1y, e1z, q, u, v, w;
  int alive, order, bad, evct, rays, rounds;
};

// The meridian-plane frame vector of a direction (polarized._initial_frame).
__device__ __forceinline__ void pz_frame(float ux, float uy, float uz, float& ex, float& ey,
                                         float& ez) {
  const float px = -uz * ux, py = -uz * uy, pz = 1.0f - uz * uz;
  const float nrm = sqrtf(px * px + py * py + pz * pz);
  const bool pole = nrm < EPS6_F;
  const float inv = pole ? 0.0f : 1.0f / fmaxf(nrm, EPS12_F);
  ex = pole ? 1.0f : px * inv;
  ey = pole ? 0.0f : py * inv;
  ez = pole ? 0.0f : pz * inv;
}

// [M(theta) S] for S = (1, q, u, v) at pos = theta / pi (polarized.
// _matrix_apply): the two endpoint rows, each two float4 loads.
__device__ __forceinline__ void pz_matrix(const PolParams& p, int row, float pos, float q,
                                          float u, float v, float& i2, float& q2, float& u2,
                                          float& v2, float& a1) {
  const float pp = fminf(fmaxf(pos, 0.0f), 1.0f) * (float)(p.n_fwd - 1);
  const int i0 = min(max((int)pp, 0), p.n_fwd - 2);
  const float frac = pp - (float)i0;
  const float g = 1.0f - frac;
  const float4* r = p.matrix + 2 * (size_t)(row + i0);
  const float4 a0 = __ldg(r), b0 = __ldg(r + 1), a1r = __ldg(r + 2), b1r = __ldg(r + 3);
  const float e0 = g * a0.x + frac * a1r.x;
  const float rb1 = g * a0.y + frac * a1r.y;
  const float ra2 = g * a0.z + frac * a1r.z;
  const float ra3 = g * a0.w + frac * a1r.w;
  const float ra4 = g * b0.x + frac * b1r.x;
  const float rb2 = g * b0.y + frac * b1r.y;
  i2 = e0 * (1.0f + rb1 * q);
  q2 = e0 * (rb1 + ra2 * q);
  u2 = e0 * (ra3 * u + rb2 * v);
  v2 = e0 * (-rb2 * u + ra4 * v);
  a1 = e0;
}

// The estimate's ray queue (DET): a CTA's records, one per estimating event
// (a physical collision or a Lambertian reflection), in the order pushed,
// in its own segment of `rays` (device memory, which L2 holds while the
// launch runs): CTA c owns records c * CTA_THREADS * K onwards, room for an
// estimate at every event of each of its lanes.  A record is four float4:
// the point and the weight; the direction and e1x; e1y, e1z, q, u; v, the
// matrix row of the event's (component, phase entry), `meta` (the event j
// and the surface flag) and the lane.
#define PZ_RAY_F4 4

struct PzQueue {
  int n;                        // records pushed
  int next;                     // the next ray the flush deals
};

// The record of one estimating event, its slot taken by a shared atomic;
// the values are the event's own registers, bit for bit.
__device__ __forceinline__ void pz_push(const PolParams& p, PzQueue& q, int lane, int j,
                                        bool surface, const PzLane& s, float w, int row) {
  const int k = atomicAdd(&q.n, 1);
  float4* r = p.rays + PZ_RAY_F4 * ((size_t)blockIdx.x * CTA_THREADS * p.K + k);
  r[0] = make_float4(s.x, s.y, s.z, w);
  r[1] = make_float4(s.ux, s.uy, s.uz, s.e1x);
  r[2] = make_float4(s.e1y, s.e1z, s.q, s.u);
  r[3] = make_float4(s.v, __int_as_float(row), __int_as_float((j << 1) | (surface ? 1 : 0)),
                     __int_as_float(lane));
}

// One detector ray in flight in a flush: its point, direction, the
// transmittance so far, its round and the pair's two words for the odd
// round, the Stokes amplitudes it carries, its lane, event and detector.
struct PzRay {
  float x, y, z, dx, dy, dz, safe, T, amp[4];
  uint32_t w_free, w_kill;
  int round, d, lane, j;
};

// The ray r of the CTA's queue of n records, dealt detector by detector
// (ray r is record r % n toward detector r / n): the
// polarized local estimate toward d (polarized.detector_estimates): the
// virtual scattering toward d (the chi rotation of (Q, U), the matrix at
// the photon-to-detector angle), the rotation into d's meridian frame, w /
// (4 pi |mu_d|); or, for a Lambertian reflection, w / pi toward an upward
// detector, depolarized.
__device__ __forceinline__ void pz_ray_start(const PolParams& p, int r, int n, PzRay& a) {
  const int d = r / n;
  const int k = r - d * n;
  const float4* rec = p.rays + PZ_RAY_F4 * ((size_t)blockIdx.x * CTA_THREADS * p.K + k);
  const float4 r0 = __ldcg(rec), r1 = __ldcg(rec + 1), r3 = __ldcg(rec + 3);
  const float ux = r1.x, uy = r1.y, uz = r1.z;
  const float w_est = r0.w;
  const int meta = __float_as_int(r3.z);
  const float* dr = p.det + (size_t)d * PZ_DET_COLS;
  const float dx = __ldg(dr), dy = __ldg(dr + 1), dz = __ldg(dr + 2);
  a.amp[1] = a.amp[2] = a.amp[3] = 0.0f;
  if (meta & 1) {
    a.amp[0] = dz > 0.0f ? w_est / PI_F : 0.0f;
  } else {
    const float4 r2 = __ldcg(rec + 2);
    const float e1x = r1.w, e1y = r2.x, e1z = r2.y;
    const float q = r2.z, us = r2.w, v = r3.x;
    const float e2x = uy * e1z - uz * e1y;
    const float e2y = uz * e1x - ux * e1z;
    const float e2z = ux * e1y - uy * e1x;
    const float ctd = fminf(fmaxf(ux * dx + uy * dy + uz * dz, -1.0f), 1.0f);
    const float dpar = e1x * dx + e1y * dy + e1z * dz;
    const float dperp = e2x * dx + e2y * dy + e2z * dz;
    const float st2 = fmaxf(dpar * dpar + dperp * dperp, 0.0f);
    const bool deg = st2 < EPS12_F;
    const float inv_st2 = deg ? 0.0f : 1.0f / fmaxf(st2, EPS12_F);
    const float c2 = deg ? 1.0f : (dpar * dpar - dperp * dperp) * inv_st2;
    const float s2 = deg ? 0.0f : 2.0f * dpar * dperp * inv_st2;
    const float qr = c2 * q + s2 * us, ur = -s2 * q + c2 * us;
    float i2, q2, u2, v2, a1;
    pz_matrix(p, __float_as_int(r3.y), acosf(ctd) / PI_F, qr, ur, v, i2, q2, u2, v2, a1);
    const float st = sqrtf(st2);
    const float inv_st = deg ? 0.0f : 1.0f / fmaxf(st, EPS12_F);
    const float e1dx = (dx - ctd * ux) * inv_st;
    const float e1dy = (dy - ctd * uy) * inv_st;
    const float e1dz = (dz - ctd * uz) * inv_st;
    const float e1sx = -st * ux + ctd * e1dx;
    const float e1sy = -st * uy + ctd * e1dy;
    const float e1sz = -st * uz + ctd * e1dz;
    const float ca = e1sx * __ldg(dr + 3) + e1sy * __ldg(dr + 4) + e1sz * __ldg(dr + 5);
    const float sa = e1sx * __ldg(dr + 6) + e1sy * __ldg(dr + 7) + e1sz * __ldg(dr + 8);
    const float c2a = deg ? 1.0f : ca * ca - sa * sa;
    const float s2a = deg ? 0.0f : 2.0f * ca * sa;
    const float pref = w_est / (FOUR_PI_F * __ldg(dr + 9));
    a.amp[0] = pref * i2;
    a.amp[1] = pref * (c2a * q2 + -s2a * u2);
    a.amp[2] = pref * (s2a * q2 + c2a * u2);
    a.amp[3] = pref * v2;
  }
  a.x = r0.x;
  a.y = r0.y;
  a.z = r0.z;
  a.dx = dx;
  a.dy = dy;
  a.dz = dz;
  a.safe = fabsf(dz) < EPS12_F ? EPS12_F : dz;
  a.T = 1.0f;
  a.round = 0;
  a.d = d;
  a.lane = __float_as_int(r3.w);
  a.j = meta >> 1;
}

// One round of a ray's ratio tracking against the global majorant
// (polarized._ratio_track): returns 0 while the ray goes on, 1 when it
// ended (left the domain: `ecol` and `esc` set if through the detector's
// side; or killed), 2 when it is alive after max_rounds rounds (bad).
__device__ __forceinline__ int pz_ray_round(const PolParams& p, PzRay& a, int& ecol, bool& esc) {
  const Grid& g = p.g;
  if (a.round >= p.max_rounds) return 2;
  uint32_t wf = a.w_free, wk = a.w_kill;
  if ((a.round & 1) == 0) {
    uint32_t w4[4];
    philox4x32_10((uint32_t)a.lane, p.kb,
                  (uint32_t)a.j + (uint32_t)p.K * ((uint32_t)a.d + (uint32_t)p.n_dirs * (uint32_t)(a.round >> 1)),
                  STREAM_INTENSITY, p.key0, p.key1, w4);
    wf = w4[0];
    wk = w4[1];
    a.w_free = w4[2];
    a.w_kill = w4[3];
  }
  ++a.round;
  const float step = exponential_deviate(to_unit(wf)) * p.inv_maj;
  float nz = a.z + step * a.dz;
  const bool top = nz >= g.z_max;
  const bool out = top || nz <= g.z0;
  const float tb = out ? ((top ? g.z_max : g.z0) - a.z) / a.safe : step;
  const float nx = wrap_periodic(a.x + tb * a.dx, g.x0, g.x_max, g.wx);
  const float ny = wrap_periodic(a.y + tb * a.dy, g.y0, g.y_max, g.wy);
  const int cx = locate(nx, g.x0, g.dx, g.xe, g.nx, g.xy_regular);
  const int cy = locate(ny, g.y0, g.dy, g.ye, g.ny, g.xy_regular);
  if (out) {
    if (top == (a.dz > 0.0f)) {
      ecol = cx * g.ny + cy;
      esc = true;
    }
    return 1;
  }
  nz = fminf(fmaxf(nz, g.z0), g.z_max);
  const int cz = locate(nz, g.z0, g.dz, g.ze, g.nz, g.z_regular);
  const float ext = __ldg(p.total_ext + (cx * g.ny + cy) * g.nz + cz);
  const float ratio = fminf(fmaxf(1.0f - ext * p.inv_maj, 0.0f), 1.0f);
  a.T = a.T * ratio;
  if (a.T < p.zeta) a.T = (to_unit(wk) >= a.T / p.zeta) ? 0.0f : p.zeta;
  if (!(a.T > 0.0f)) return 1;
  a.x = nx;
  a.y = ny;
  a.z = nz;
  return 0;
}

// The end of a ray (`end` of pz_ray_round): its Stokes contribution, if it
// left through its detector's side, to the tally summed over the threads
// of the warp that tally at the same refill on the same bin (active_red);
// its rounds to its lane's rounds row, D rays a record to the rays row, a
// ray alive after the round budget to the bad row, by integer atomics:
// exact in any order.
__device__ __forceinline__ void pz_ray_end(const PolParams& p, int* __restrict__ iv,
                                           const PzRay& a, int end, int ecol, bool esc) {
  const int D = p.n_dirs;
  const size_t L = (size_t)p.n_lanes;
  const int bin = (ecol * D + a.d) * 4;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float c = a.amp[k] * a.T;
    active_red(p.intensity, esc && c != 0.0f ? bin + k : -1, (double)c);
  }
  atomicAdd(iv + 5 * L + a.lane, a.round);
  if (a.d == 0) atomicAdd(iv + 4 * L + a.lane, D);
  if (end == 2) atomicAdd(iv + 2 * L + a.lane, 1);
}

// Traces the rays (record, detector) of the CTA's queue by all its
// threads, after the lane loop's barrier, in two phases (the general
// kernel's gen_pull).  The refill: the threads whose ray ended tally it,
// every idle thread takes the next ray from q.next and sets it up.  The
// steps: each trip runs one ratio-tracking round of every thread's ray,
// until at most PZ_REFILL_AT threads of the warp have a ray while rays are
// left, or none has.  Not inlined: its registers stay out of
// the event loop's.
#define PZ_REFILL_AT 8
static __device__ __noinline__ void pz_flush(const PolParams& p, int* __restrict__ iv,
                                             PzQueue& q) {
  const int n = q.n;
  if (n > 0 && threadIdx.x == 0 && p.flushes) atomicAdd(p.flushes, 1ull);
  const int nr = n * p.n_dirs;
  PzRay a;
  int end = 0, ecol = 0;
  bool esc = false, act = false, more = true;
#pragma unroll 1
  for (;;) {
    if (end) {
      pz_ray_end(p, iv, a, end, ecol, esc);
      end = 0;
    }
    if (!act && more) {
      const int r = atomicAdd(&q.next, 1);
      more = r < nr;
      if (more) {
        pz_ray_start(p, r, n, a);
        act = true;
        ecol = 0;
        esc = false;
      }
    }
    if (!__any_sync(FULL_MASK, act)) break;
    const bool left = __any_sync(FULL_MASK, more);
#pragma unroll 1
    for (;;) {
      if (act) {
        end = pz_ray_round(p, a, ecol, esc);
        act = end == 0;
      }
      const unsigned am = __ballot_sync(FULL_MASK, act);
      if (am == 0u || (left && __popc(am) <= PZ_REFILL_AT)) break;
    }
  }
}

// One event of a live lane (polarized.polarized_event; JAX polarized.py:
// 492-622): lane and event j key the estimate's draws.
template <bool DET, bool LAMB>
__device__ __forceinline__ void pz_event(const PolParams& p, const float (&u)[PZ_DRAWS],
                                         PzLane& s, int lane, int j, PzQueue* q) {
  const Grid& g = p.g;
  // The free path against the global majorant, exits, horizontal wrap.
  const float step = exponential_deviate(u[0]) * p.inv_maj;
  const float nz = s.z + step * s.uz;
  const bool top = nz >= g.z_max;
  const bool bot = nz <= g.z0;
  const bool out = top || bot;
  const float safe = fabsf(s.uz) < EPS12_F ? EPS12_F : s.uz;
  const float tb = out ? ((top ? g.z_max : g.z0) - s.z) / safe : step;
  s.x = wrap_periodic(s.x + tb * s.ux, g.x0, g.x_max, g.wx);
  s.y = wrap_periodic(s.y + tb * s.uy, g.y0, g.y_max, g.wy);
  s.z = fminf(fmaxf(nz, g.z0), g.z_max);
  const int ix = locate(s.x, g.x0, g.dx, g.xe, g.nx, g.xy_regular);
  const int iy = locate(s.y, g.y0, g.dy, g.ye, g.ny, g.xy_regular);
  const int col = ix * g.ny + iy;
  ++s.evct;
  // One column tally an event: the exit (the weight before a bounce) or a
  // collision's absorbed weight.
  int t_key = out ? col * 3 + (top ? 0 : 1) : -1;
  float t_val = s.w;
  bool refl = false, physical = false;
  int comp = 0, pf = 0;
  float w_scat = s.w;
  if (LAMB && bot) {
    // The depolarizing Lambertian bounce (:511-531).
    s.w = s.w * p.albedo;
    w_scat = s.w;
    const float mu_r = sqrtf(fmaxf(u[6], EPS12_F));
    const float sr = sqrtf(fmaxf(1.0f - mu_r * mu_r, 0.0f));
    float s_chi, c_chi;
    sincos_2pi(u[7], &s_chi, &c_chi);
    s.ux = sr * c_chi;
    s.uy = sr * s_chi;
    s.uz = mu_r;
    pz_frame(s.ux, s.uy, s.uz, s.e1x, s.e1y, s.e1z);
    s.q = s.u = s.v = 0.0f;
    s.z = g.z0;
    refl = true;
  } else if (!out) {
    // The collision (:533-549): the cell's extinction, component, ssa, entry.
    const int iz = locate(s.z, g.z0, g.dz, g.ze, g.nz, g.z_regular);
    const int flat = (ix * g.ny + iy) * g.nz + iz;
    physical = u[1] < __ldg(p.total_ext + flat) * p.inv_maj;
    if (physical) {
      const int n = p.n_comp;
      const float* cell = p.cells + (size_t)flat * 3 * n;
      for (int c = 0; c < n - 1; ++c) comp += u[2] >= __ldg(cell + c) ? 1 : 0;
      const float ssa = __ldg(cell + n + comp);
      pf = (int)__ldg(cell + 2 * n + comp);
      w_scat = s.w * ssa;
      t_val = s.w * (1.0f - ssa);
      t_key = t_val != 0.0f ? col * 3 + 2 : -1;
    }
  }
  active_red(p.columns, t_key, (double)t_val);
  if (out && !refl) {
    s.alive = 0;
    return;
  }
  const int entry = comp * p.max_entries + pf;
  // The local estimate's record, traced by the CTA after its lanes' events.
  if (DET && (physical || refl)) pz_push(p, *q, lane, j, refl, s, w_scat, entry * p.n_fwd);
  if (physical) {
    // The chi rotation of the frame and of (Q, U).
    float s_chi, c_chi;
    sincos_2pi(u[4], &s_chi, &c_chi);
    const float e2x = s.uy * s.e1z - s.uz * s.e1y;
    const float e2y = s.uz * s.e1x - s.ux * s.e1z;
    const float e2z = s.ux * s.e1y - s.uy * s.e1x;
    const float r1x = c_chi * s.e1x + s_chi * e2x;
    const float r1y = c_chi * s.e1y + s_chi * e2y;
    const float r1z = c_chi * s.e1z + s_chi * e2z;
    const float c2 = c_chi * c_chi - s_chi * s_chi;
    const float s2 = 2.0f * s_chi * c_chi;
    const float qr = c2 * s.q + s2 * s.u, ur = -s2 * s.q + c2 * s.u;
    // Theta from the cubic inverse CDF of P11.
    const int S = p.n_seg;
    const float pos = fminf(fmaxf(u[3], 0.0f), 1.0f) * (float)S;
    const int seg = min(max((int)pos, 0), S - 1);
    const float t = pos - (float)seg;
    const float4 cc = __ldg(p.cubic + (entry * S + seg));
    const float mu_s = fminf(fmaxf(((cc.w * t + cc.z) * t + cc.y) * t + cc.x, -1.0f), 1.0f);
    float i2, q2, u2, v2, a1;
    pz_matrix(p, entry * p.n_fwd, acosf(mu_s) / PI_F, qr, ur, s.v, i2, q2, u2, v2, a1);
    const float wmul = a1 > EPS20_F ? i2 / fmaxf(a1, EPS12_F) : 1.0f;
    const float inv_i2 = i2 > EPS20_F ? 1.0f / fmaxf(i2, EPS12_F) : 0.0f;
    const float sin_s = sqrtf(fmaxf(1.0f - mu_s * mu_s, 0.0f));
    float nux = mu_s * s.ux + sin_s * r1x;
    float nuy = mu_s * s.uy + sin_s * r1y;
    float nuz = mu_s * s.uz + sin_s * r1z;
    float n1x = -sin_s * s.ux + mu_s * r1x;
    float n1y = -sin_s * s.uy + mu_s * r1y;
    float n1z = -sin_s * s.uz + mu_s * r1z;
    const float nrm = 1.0f / sqrtf(fmaxf(nux * nux + nuy * nuy + nuz * nuz, EPS12_F));
    nux = nux * nrm;
    nuy = nuy * nrm;
    nuz = nuz * nrm;
    const float dot = n1x * nux + n1y * nuy + n1z * nuz;
    n1x = n1x - dot * nux;
    n1y = n1y - dot * nuy;
    n1z = n1z - dot * nuz;
    const float nrm1 = 1.0f / sqrtf(fmaxf(n1x * n1x + n1y * n1y + n1z * n1z, EPS12_F));
    s.ux = nux;
    s.uy = nuy;
    s.uz = nuz;
    s.e1x = n1x * nrm1;
    s.e1y = n1y * nrm1;
    s.e1z = n1z * nrm1;
    s.q = q2 * inv_i2;
    s.u = u2 * inv_i2;
    s.v = v2 * inv_i2;
    s.w = w_scat * wmul;
  }
  // Weight roulette and the event budget (:614-622).
  bool die = false;
  if (s.w < ROULETTE_W_F) {
    die = u[5] >= 0.5f;
    if (!die) s.w = s.w * 2.0f;
  }
  if (physical) ++s.order;
  const bool over = physical && s.order >= p.max_events;
  s.bad += over ? 1 : 0;
  s.alive = (die || over) ? 0 : 1;
}

// The block's prologue for the calling thread's lane (see the header): the
// loop's control state and, for a dead lane the budget still covers, a
// fresh photon written to the state arrays.  Returns the lane's alive flag
// after the refill.  Every thread of the CTA calls it.  Not inlined: its
// registers stay out of the event loop's.
static __device__ __noinline__ int pz_prologue(const PolParams& p, float* f, int* iv) {
  __shared__ int warp_dead[CTA_WARPS];
  __shared__ int warp_below[CTA_WARPS];
  const int t = threadIdx.x, warp = t >> 5, wl = t & 31;
  const unsigned below_me = (1u << wl) - 1u;
  const size_t L = (size_t)p.n_lanes;
  const int n_tiles = (p.n_lanes + CTA_THREADS - 1) / CTA_THREADS;
  const int tile = blockIdx.x;
  const int lane = tile * CTA_THREADS + t;
  const long long launched = p.ctl[p.kb & 1u];
  const int* dead_in = p.dead + (size_t)(p.kb & 1u) * n_tiles;
  const bool in_range = lane < p.n_lanes;
  const bool alive0 = in_range && iv[lane] != 0;
  const bool dead = in_range && !alive0;
  const unsigned dm = __ballot_sync(FULL_MASK, dead);
  if (wl == 0) warp_dead[warp] = __popc(dm);
  const bool budget = launched < p.n_photons;
  const bool last = tile == n_tiles - 1;
  // The dead lanes in the tiles below (once the budget is spent only the
  // last CTA needs them, for the loop's control state).
  int below = 0;
  if (budget || last) {
    for (int k = t; k < tile; k += CTA_THREADS) below += dead_in[k];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) below += __shfl_xor_sync(FULL_MASK, below, o);
  }
  if (wl == 0) warp_below[warp] = below;
  __syncthreads();
  long long base = launched;
  int rank = 0, tile_dead = 0;
#pragma unroll
  for (int w = 0; w < CTA_WARPS; ++w) {
    base += warp_below[w];
    rank += w < warp ? warp_dead[w] : 0;
    tile_dead += warp_dead[w];
  }
  rank += __popc(dm & below_me);
  int alive = alive0 ? 1 : 0;
  if (dead && budget && base + rank < p.n_photons) {
    float v[6];
    source_sample(p.src, p.kb, p.key0, p.key1, lane, v);
#pragma unroll
    for (int k = 0; k < 6; ++k) f[k * L + lane] = v[k];
    float ex, ey, ez;
    pz_frame(v[3], v[4], v[5], ex, ey, ez);
    f[6 * L + lane] = ex;
    f[7 * L + lane] = ey;
    f[8 * L + lane] = ez;
    f[9 * L + lane] = p.q0;
    f[10 * L + lane] = p.u0;
    f[11 * L + lane] = p.v0;
    f[12 * L + lane] = 1.0f;
    iv[L + lane] = 0;
    iv[lane] = 1;
    alive = 1;
  }
  if (last && t == 0) {
    const long long total_dead = base - launched + tile_dead;
    const long long room = p.n_photons - launched;
    p.ctl[(p.kb + 1u) & 1u] = launched + (budget ? (total_dead < room ? total_dead : room) : 0);
    if (!budget && p.ctl[3] < 0) p.ctl[3] = (long long)p.kb;
    if (!budget && total_dead == (long long)p.n_lanes && p.ctl[2] < 0)
      p.ctl[2] = (long long)p.kb;
  }
  return alive;
}

// State layout (integrators/polarized.py PolarizedState), updated in place:
//   f: (13, L) float32 rows x, y, z, ux, uy, uz, e1x, e1y, e1z, q, u, v, w
//   i: (6, L)  int32   rows alive, order, bad, evct, rays, rounds
// One CTA per tile of CTA_THREADS lanes, thread t on lane tile * CTA_THREADS
// + t; a live lane runs up to K events in registers; the CTA's dead count
// at exit is the next launch's FIFO rank; with detectors the CTA then traces
// its ray queue (pz_flush).  Three CTAs per SM, and the stores' addresses
// formed at the stores: with both no instantiation spills (72 registers
// each); without the bound the flux set kept 64 registers and spilled 8 B,
// without the address fix the first design's detector and Lambertian set
// 32 B (ptxas of the H100 build; chip_smoke.py phase 2 reads them).
template <bool DET, bool LAMB>
__global__ void __launch_bounds__(CTA_THREADS, PZ_CTAS_PER_SM)
polarized_event_block_kernel(float* __restrict__ f, int* __restrict__ iv,
                             const __grid_constant__ PolParams p) {
  __shared__ typename std::conditional<DET, PzQueue, char>::type q;
  PzQueue* qp = nullptr;
  if constexpr (DET) {
    if (threadIdx.x == 0) q.n = q.next = 0;   // seen after the prologue's barrier
    qp = &q;
  }
  const int lane = blockIdx.x * CTA_THREADS + threadIdx.x;
  const size_t L = (size_t)p.n_lanes;
  int survived = 0;
  if (pz_prologue(p, f, iv)) {
    PzLane s;
    s.x = f[lane];
    s.y = f[L + lane];
    s.z = f[2 * L + lane];
    s.ux = f[3 * L + lane];
    s.uy = f[4 * L + lane];
    s.uz = f[5 * L + lane];
    s.e1x = f[6 * L + lane];
    s.e1y = f[7 * L + lane];
    s.e1z = f[8 * L + lane];
    s.q = f[9 * L + lane];
    s.u = f[10 * L + lane];
    s.v = f[11 * L + lane];
    s.w = f[12 * L + lane];
    s.alive = 1;
    s.order = iv[L + lane];
    s.bad = iv[2 * L + lane];
    s.evct = iv[3 * L + lane];
    s.rays = iv[4 * L + lane];
    s.rounds = iv[5 * L + lane];
#pragma unroll 1
    for (int j = 0; j < p.K && s.alive; ++j) {
      float u[PZ_DRAWS];
#pragma unroll
      for (int gi = 0; gi < PZ_DRAWS / 4; ++gi) {
        uint32_t w4[4];
        philox4x32_10((uint32_t)lane, p.kb, (uint32_t)(2 * j + gi), STREAM_EVENT, p.key0,
                      p.key1, w4);
#pragma unroll
        for (int q = 0; q < 4; ++q) u[4 * gi + q] = to_unit(w4[q]);
      }
      pz_event<DET, LAMB>(p, u, s, lane, j, qp);
    }
    // The stores' addresses formed here, from a lane the compiler cannot
    // see through: it would otherwise keep the loads' 19 row addresses over
    // the events (the general kernel's fix, general_event_block.cuh).
    asm volatile("" : "+r"(lane));
    f[lane] = s.x;
    f[L + lane] = s.y;
    f[2 * L + lane] = s.z;
    f[3 * L + lane] = s.ux;
    f[4 * L + lane] = s.uy;
    f[5 * L + lane] = s.uz;
    f[6 * L + lane] = s.e1x;
    f[7 * L + lane] = s.e1y;
    f[8 * L + lane] = s.e1z;
    f[9 * L + lane] = s.q;
    f[10 * L + lane] = s.u;
    f[11 * L + lane] = s.v;
    f[12 * L + lane] = s.w;
    iv[lane] = s.alive;
    iv[L + lane] = s.order;
    iv[2 * L + lane] = s.bad;
    iv[3 * L + lane] = s.evct;
    iv[4 * L + lane] = s.rays;
    iv[5 * L + lane] = s.rounds;
    survived = s.alive;
  }
  const int n_alive = __syncthreads_count(survived);
  // The estimates' rays, traced by every thread of the CTA (dead lanes'
  // threads too); the lanes' rows they add to are stored.
  if constexpr (DET) pz_flush(p, iv, q);
  if (threadIdx.x == 0) {
    const int n_tiles = (p.n_lanes + CTA_THREADS - 1) / CTA_THREADS;
    const int n_here = min(CTA_THREADS, p.n_lanes - (int)blockIdx.x * CTA_THREADS);
    p.dead[(size_t)((p.kb + 1u) & 1u) * n_tiles + blockIdx.x] = n_here - n_alive;
  }
}
