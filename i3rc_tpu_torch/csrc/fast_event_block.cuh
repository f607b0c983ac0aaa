// Fast event block: K complete photon-transport events per lane, state in
// registers.  Hopper (sm_90a) port of the Pallas kernel `_build_pallas_block`
// (i3rc_tpu/integrators/fastpath.py:665, pallas_call at :783), whose body runs
// `fast_event` (fastpath.py:1291-1676), in its variants: flux (n_detectors =
// 0), radiance detectors (n_detectors = D > 0, the closed-form shadow trace,
// HG phase), and the gas channel (gas=True) of either; no column mode and no
// table mode.  This header holds the device code and the kernel template;
// fast_event_block.cu instantiates the variants without the gas channel and
// holds the C interface, fast_event_block_gas.cu the gas variants.  The two
// files compile in parallel.
//
// One thread owns one photon lane.  It loads the lane's state once, runs K
// events (free path, separable where-chain extinction, nearest segment face,
// collision or crossing with the face nudge and periodic x/y wrap, exit
// bookkeeping, Bernoulli absorption, Henyey-Greenstein scattering, up to
// CHAIN bonus collisions inside the segment box, counters) and stores the
// state back.  The state arrays are updated IN PLACE.
//
// Detector variant (DET, chain depth 0 as on the TPU): at every collision
// that survives absorption, for each detector d it evaluates the HG phase
// toward d, the closed-form optical depth to the z boundary (z segments x the
// cumulative integral of the one varying horizontal factor, fastpath.py:
// 1140-1247, plus the gas segments), the exit column, and with IW the
// Iwabuchi roulette, and adds P / (4 pi |mu_d|) exp(-tau) to the (column, d)
// bin.  The TPU kernel wrote K x D (contribution, column) record arrays that
// XLA glue tallied; here each CTA tallies into an (n_cols x D) float64
// histogram in shared memory and flushes it with atomicAdd into the global
// accumulator at its end (global atomics directly when the histogram exceeds
// SMEM_HIST_BYTES).  The sum is the same; its order differs from the twin's
// index_add_.
//
// Gas variant (GAS, fastpath.py:1361-1391, :1469-1470, :1622-1652): each lane
// carries tgas, the gas optical depth left before a gas absorption (state row
// 7).  A step also stops at the faces of the gas chain gz(z), so gz is
// constant along it; the gas absorption competes as a third outcome after the
// collision (s_gas = tgas * 1/gz, a product as in the reference), tgas drops
// by step * gz on every moving lane, and a gas death pends as kind 3 at the
// point where tgas runs out.  Chained collisions stay inside the gas layer
// too and commit only while their gas cost is below tgas.
//
// What bounds it: ALU work.  Each event costs ceil(n_draws/4) Philox4x32-10
// calls (10 rounds of two 32x32 multiplies each) plus the where-chains over
// the segment thresholds; device memory traffic is only 2 x 4 B x 11 arrays
// per lane per K events (one more each for y and tgas), read once and
// written once.  The design keeps every intermediate in registers and reads
// the segment tables from the by-value parameter block (__grid_constant__),
// so the kernel touches device memory only at its start and end.
//
// Differences from the TPU kernel:
//  * RNG: counter-based Philox4x32-10 keyed (seed, batch) with counter
//    (lane, kb, group, stream), the layout of i3rc_tpu_torch/core/rng.py; it
//    replaces the TPU hardware PRNG.  Event j of the block reads group
//    j * G + d / 4, word d % 4 for its draw d, G = ceil(n_draws / 4).
//  * Layout: a 1-D grid over lanes with a masked tail instead of (R, 128)
//    tiles in VMEM.
//  * Segment data arrive in one parameter struct (<= MAX_SEGMENTS thresholds
//    per axis); loops run to the runtime count, so one build serves every
//    domain and every k point of a spectral band.  K, CHAIN, absorbing,
//    track_y, detectors, Iwabuchi and the gas channel are template
//    parameters; the detector count (<= MAX_DETECTORS) and the shadow-trace
//    segments are runtime loops.
//  * Iwabuchi's small-phase case keeps the transmittance: it contributes
//    zeta/pi with probability (pf_pi/zeta) exp(-tau), the law of the
//    reference's trace; the JAX fastpath drops exp(-tau) there.
//
// Float arithmetic follows the JAX reference and the PyTorch twin operation
// by operation; the library is built with --fmad=false so that no multiply-
// add is contracted, and constants are the float32 values written in hex.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define MAX_SEGMENTS 24
#define MAX_DETECTORS 8
#define STREAM_EVENT 0u
#define SMEM_HIST_BYTES (48 * 1024)

struct StepChain {
  int n;                        // number of interior thresholds
  float t[MAX_SEGMENTS];        // ascending thresholds
  float v[MAX_SEGMENTS + 1];    // segment values
  float iv[MAX_SEGMENTS + 1];   // reciprocal values (0 for zero segments)
};

// Radiance detectors and the closed-form shadow trace (i3rc_tpu_torch/kernels/
// event_block.py DetectorSpec).
struct DetParams {
  int n;                          // detectors D
  int n_bins;                     // n_cols * D
  float dx[MAX_DETECTORS], dy[MAX_DETECTORS], dz[MAX_DETECTORS];
  float inv_dz[MAX_DETECTORS];
  float dh[MAX_DETECTORS], inv_dh[MAX_DETECTORS];   // along the varying axis
  float norm[MAX_DETECTORS];      // 1 / (4 pi |mu_d|)
  int mode[MAX_DETECTORS];        // 0 no horizontal factor, 1 constant, 2 FhP
  int n_z;                        // z segments with extinction > 0
  float z_lo[MAX_SEGMENTS + 1], z_hi[MAX_SEGMENTS + 1], z_v[MAX_SEGMENTS + 1];
  int h_axis;                     // 0 x (fx), 1 y (fy), -1 none
  float h_lo, h_tot, h_w, h_inv_w;
  float h_cum[MAX_SEGMENTS];      // FhP at each interior threshold
  float z_top, z_bot;
  float x0, inv_dx, wrap_wx, wrap_inv_x;
  float y0, inv_dy, wrap_wy, wrap_inv_y;
  int n_x, n_y, col_y;
  float zeta, zeta_pi;            // Iwabuchi zeta_min and zeta / pi
  int n_g;                        // gas z segments with extinction > 0
  float g_lo[MAX_SEGMENTS + 1], g_hi[MAX_SEGMENTS + 1], g_v[MAX_SEGMENTS + 1];
};

struct EventParams {
  StepChain fx, fy, fz;
  float x0, y0, z0, x_max, y_max, z_max;
  float wx, wy;                 // periodic widths x_max - x0, y_max - y0
  float nudge_x, nudge_y, nudge_z;
  float g;                      // Henyey-Greenstein asymmetry
  float ssa;                    // uniform single-scattering albedo
  int max_events;
  unsigned int key0, key1;      // Philox key (seed, batch)
  unsigned int kb;              // K-event block index
  int n_lanes;
  DetParams det;                // read by the detector variants only
  StepChain gz;                 // gas chain over z, read by the gas variants only
};

// float32 constants of the JAX reference (fastpath.py _HUGE, rng.TINY,
// wavefront._sincos_2pi and rotate_direction).
#define HUGE_F 0x1.c363ccp+127f
#define TINY_F 0x1p-126f
#define DIR_EPS_F 0x1.4484c0p-99f   // 2e-30
#define EPS12_F 0x1.197998p-40f     // 1e-12
#define EPS6_F 0x1.0c6f7ap-20f      // 1e-6
#define S0 0x1.921f74p+0f
#define S1 -0x1.4ab432p-1f
#define S2 0x1.457cf0p-4f
#define S3 -0x1.1d43d4p-8f
#define C0 0x1.fffffep-1f
#define C1 -0x1.3bd3aep+0f
#define C2 0x1.03bdd4p-2f
#define C3 -0x1.550d82p-6f
#define C4 0x1.c39082p-11f
#define PI_F 0x1.921fb6p+1f

// ---------------------------------------------------------------------------
// Philox4x32-10 (Salmon et al. 2011), four uniforms per call.
__device__ __forceinline__ void philox4x32_10(uint32_t c0, uint32_t c1, uint32_t c2,
                                              uint32_t c3, uint32_t k0, uint32_t k1,
                                              uint32_t out[4]) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k0 += 0x9E3779B9u;
      k1 += 0xBB67AE85u;
    }
    const uint32_t hi0 = __umulhi(0xD2511F53u, c0), lo0 = 0xD2511F53u * c0;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c2), lo1 = 0xCD9E8D57u * c2;
    c0 = hi1 ^ c1 ^ k0;
    c1 = lo1;
    c2 = hi0 ^ c3 ^ k1;
    c3 = lo0;
  }
  out[0] = c0;
  out[1] = c1;
  out[2] = c2;
  out[3] = c3;
}

__device__ __forceinline__ float to_unit(uint32_t bits) {
  return (float)(bits >> 8) * 0x1p-24f;
}

// ---------------------------------------------------------------------------
// Where-chains of fastpath.StepFactor: the comparisons are copied exactly
// (values: pos >= t; face_up: pos < t; face_dn: pos > t).
__device__ __forceinline__ float chain_value(const StepChain& c, const float* vals,
                                             float pos) {
  float v = vals[0];
  for (int k = 0; k < c.n; ++k)
    if (pos >= c.t[k]) v = vals[k + 1];
  return v;
}

__device__ __forceinline__ float face_up(const StepChain& c, float pos, float hi) {
  float face = hi;
  for (int k = c.n - 1; k >= 0; --k)
    if (pos < c.t[k]) face = c.t[k];
  return face;
}

__device__ __forceinline__ float face_dn(const StepChain& c, float pos, float lo) {
  float face = lo;
  for (int k = 0; k < c.n; ++k)
    if (pos > c.t[k]) face = c.t[k];
  return face;
}

__device__ __forceinline__ float wrap_fast(float v, float lo, float hi, float w) {
  return v >= hi ? v - w : (v < lo ? v + w : v);
}

__device__ __forceinline__ float exponential_deviate(float u) {
  return -logf(fmaxf(u, TINY_F));
}

__device__ __forceinline__ float hg_cosine(float g, float u) {
  const float frac = (1.0f - g * g) / (1.0f + g * (2.0f * u - 1.0f));
  const float c = (1.0f + g * g - frac * frac) / (2.0f * g);
  return fminf(fmaxf(c, -1.0f), 1.0f);
}

__device__ __forceinline__ void sincos_2pi(float u, float* sin_out, float* cos_out) {
  const float t = 4.0f * u;
  const float q = floorf(t);
  const float r = t - q;
  const float r2 = r * r;
  const float s = r * (S0 + r2 * (S1 + r2 * (S2 + r2 * S3)));
  const float c = C0 + r2 * (C1 + r2 * (C2 + r2 * (C3 + r2 * C4)));
  const bool swap = (q == 1.0f) || (q == 3.0f);
  const float sq = swap ? c : s;
  const float cq = swap ? s : c;
  *sin_out = (q >= 2.0f ? -1.0f : 1.0f) * sq;
  *cos_out = ((q == 1.0f) || (q == 2.0f) ? -1.0f : 1.0f) * cq;
}

// wavefront.rotate_direction(renormalize=False); the rescale happens once
// per block in the host glue.
__device__ __forceinline__ void rotate_direction(float ux, float uy, float uz,
                                                 float cos_scat, float u_az,
                                                 float* nx, float* ny, float* nz) {
  float sin_chi, cos_chi;
  sincos_2pi(u_az, &sin_chi, &cos_chi);
  const float sin_scat = sqrtf(fmaxf(1.0f - cos_scat * cos_scat, 0.0f));
  const float denom2 = fmaxf(1.0f - uz * uz, 0.0f);
  const float rs = 1.0f / sqrtf(fmaxf(denom2, EPS12_F));
  const float denom = denom2 * rs;
  const bool near_pole = denom < EPS6_F;
  const float inv_denom = near_pole ? 0.0f : rs;
  const float sgn_z = uz >= 0.0f ? 1.0f : -1.0f;
  if (near_pole) {
    *nx = sin_scat * cos_chi;
    *ny = sgn_z * sin_scat * sin_chi;
    *nz = sgn_z * cos_scat;
  } else {
    *nx = sin_scat * (ux * uz * cos_chi - uy * sin_chi) * inv_denom + ux * cos_scat;
    *ny = sin_scat * (uy * uz * cos_chi + ux * sin_chi) * inv_denom + uy * cos_scat;
    *nz = -sin_scat * cos_chi * denom + uz * cos_scat;
  }
}

struct Lane {
  float x, y, z, ux, uy, uz, tau, tgas;
  int alive, orders, pk, bad, evct;
};

// u[i] of a register array with a runtime i, as selects (no local memory).
template <int N>
__device__ __forceinline__ float pick(const float (&u)[N], int i) {
  float r = u[0];
#pragma unroll
  for (int k = 1; k < N; ++k)
    if (i == k) r = u[k];
  return r;
}

// FhP: cumulative integral of the varying horizontal factor, periodically
// extended (fastpath.py:1175-1186).
__device__ __forceinline__ float cum_h(const EventParams& p, float xu) {
  const DetParams& q = p.det;
  const StepChain& c = q.h_axis == 0 ? p.fx : p.fy;
  const float n = floorf((xu - q.h_lo) * q.h_inv_w);
  const float r = xu - n * q.h_w;
  float F = c.v[0] * (r - q.h_lo);
  for (int k = 0; k < c.n; ++k)
    if (r >= c.t[k]) F = q.h_cum[k] + c.v[k + 1] * (r - c.t[k]);
  return n * q.h_tot + F;
}

// Local estimate of detector d from a collision at s (direction before the
// scattering): the contribution and its exit column (fastpath.py:1501-1571
// with shadow_closed, :1194-1247; the gas segments, :1219-1233, are empty
// without a gas channel).
template <bool IW>
__device__ __forceinline__ float detector_contribution(const EventParams& p, int d,
                                                       const Lane& s, float u_iw,
                                                       int* col_out) {
  const DetParams& q = p.det;
  const float proj =
      fminf(fmaxf(s.ux * q.dx[d] + s.uy * q.dy[d] + s.uz * q.dz[d], -1.0f), 1.0f);
  const float r =
      1.0f / sqrtf(fmaxf((1.0f + p.g * p.g) - (p.g + p.g) * proj, EPS12_F));
  const float norm_pf = (1.0f - p.g * p.g) * r * r * r * q.norm[d];

  const float inv_dz = q.inv_dz[d];
  const bool up = q.dz[d] >= 0.0f;
  const float ph = q.h_axis == 0 ? s.x : s.y;
  float tau = 0.0f;
  for (int k = 0; k < q.n_z; ++k) {
    const float a = up ? q.z_lo[k] : q.z_hi[k];
    const float b = up ? q.z_hi[k] : q.z_lo[k];
    const float t_lo = fmaxf((a - s.z) * inv_dz, 0.0f);
    const float t_hi = fmaxf((b - s.z) * inv_dz, 0.0f);
    float seg;
    if (q.mode[d] == 2) {
      seg = (cum_h(p, ph + t_hi * q.dh[d]) - cum_h(p, ph + t_lo * q.dh[d])) * q.inv_dh[d];
    } else if (q.mode[d] == 1) {
      const StepChain& c = q.h_axis == 0 ? p.fx : p.fy;
      seg = chain_value(c, c.v, ph) * (t_hi - t_lo);
    } else {
      seg = t_hi - t_lo;
    }
    tau = tau + q.z_v[k] * fmaxf(seg, 0.0f);
  }
  for (int k = 0; k < q.n_g; ++k) {
    const float a = up ? q.g_lo[k] : q.g_hi[k];
    const float b = up ? q.g_hi[k] : q.g_lo[k];
    const float t_lo = fmaxf((a - s.z) * inv_dz, 0.0f);
    const float t_hi = fmaxf((b - s.z) * inv_dz, 0.0f);
    tau = tau + q.g_v[k] * fmaxf(t_hi - t_lo, 0.0f);
  }

  const float t_ex = ((up ? q.z_top : q.z_bot) - s.z) * inv_dz;
  float xe = s.x + t_ex * q.dx[d];
  xe = xe - q.wrap_wx * floorf((xe - q.x0) * q.wrap_inv_x);
  int col = min(max((int)((xe - q.x0) * q.inv_dx), 0), q.n_x - 1);
  if (q.col_y) {
    float ye = s.y + t_ex * q.dy[d];
    ye = ye - q.wrap_wy * floorf((ye - q.y0) * q.wrap_inv_y);
    col = col * q.n_y + min(max((int)((ye - q.y0) * q.inv_dy), 0), q.n_y - 1);
  }
  *col_out = col;

  if (IW) {
    // Iwabuchi Eq 13/14 on the exact tau; the small-phase case accepts with
    // probability (pf_pi / zeta) exp(-tau) (see the header).
    const float pf_pi = PI_F * norm_pf;
    const float tau_max = -logf(q.zeta / fmaxf(pf_pi, TINY_F));
    if (pf_pi <= q.zeta) return (u_iw * q.zeta <= pf_pi * expf(-tau)) ? q.zeta_pi : 0.0f;
    if (tau <= tau_max) return norm_pf * expf(-tau);
    return (u_iw < expf(tau_max - tau)) ? q.zeta_pi : 0.0f;
  }
  return norm_pf * expf(-tau);
}

// One fast_event (fastpath.py:1291-1676, MARCH = 1).  u holds the event's
// draws: u[0] free path, u[1] scattering cosine, u[2] azimuth, u[3]
// absorption (when ABS), then CHAIN bonus phases of BD draws each, or with
// DET && IW one Iwabuchi draw per detector.  DET adds the collision's
// detector contributions to hist (shared or global, n_bins doubles).
template <int CHAIN, bool ABS, bool TY, bool DET, bool IW, bool GAS, int NU>
__device__ __forceinline__ void fast_event(const EventParams& p, const float (&u)[NU],
                                           Lane& s, double* hist) {
  constexpr int BD = ABS ? 4 : 3;
  const bool alive = s.alive != 0;
  float tau = s.tau > 0.0f ? s.tau : exponential_deviate(u[0]);

  const bool up_x = s.ux >= 0.0f, up_y = s.uy >= 0.0f, up_z = s.uz >= 0.0f;
  const float sign_x = up_x ? p.nudge_x : -p.nudge_x;
  const float sign_y = up_y ? p.nudge_y : -p.nudge_y;
  const float sign_z = up_z ? p.nudge_z : -p.nudge_z;

  float ext = chain_value(p.fx, p.fx.v, s.x) * chain_value(p.fz, p.fz.v, s.z);
  float inv_ext = chain_value(p.fx, p.fx.iv, s.x) * chain_value(p.fz, p.fz.iv, s.z);
  if (TY) {
    ext = ext * chain_value(p.fy, p.fy.v, s.y);
    inv_ext = inv_ext * chain_value(p.fy, p.fy.iv, s.y);
  }
  const float face_x = up_x ? face_up(p.fx, s.x, p.x_max) : face_dn(p.fx, s.x, p.x0);
  float face_z = up_z ? face_up(p.fz, s.z, p.z_max) : face_dn(p.fz, s.z, p.z0);
  float gzv = 0.0f;
  if (GAS) {
    // The step also stops at the gas faces, so gz is constant along it.
    gzv = chain_value(p.gz, p.gz.v, s.z);
    const float face_zg = up_z ? face_up(p.gz, s.z, p.z_max) : face_dn(p.gz, s.z, p.z0);
    face_z = up_z ? fminf(face_z, face_zg) : fmaxf(face_z, face_zg);
  }
  const float sx = fabsf(s.ux) >= DIR_EPS_F ? (face_x - s.x) / s.ux : HUGE_F;
  const float sz = fabsf(s.uz) >= DIR_EPS_F ? (face_z - s.z) / s.uz : HUGE_F;
  float s_bnd = fminf(sx, sz);
  float face_y = 0.0f, sy = HUGE_F;
  if (TY) {
    face_y = up_y ? face_up(p.fy, s.y, p.y_max) : face_dn(p.fy, s.y, p.y0);
    sy = fabsf(s.uy) >= DIR_EPS_F ? (face_y - s.y) / s.uy : HUGE_F;
    s_bnd = fminf(s_bnd, sy);
  }
  s_bnd = fmaxf(s_bnd, 0.0f);
  const float s_col = ext > 0.0f ? tau * inv_ext : HUGE_F;

  bool collide, cross, gas_die = false;
  float adv;
  if (GAS) {
    // Collision, then gas absorption, then crossing; the gas optical depth
    // is consumed along every step.
    const float s_gas = gzv > 0.0f ? s.tgas * chain_value(p.gz, p.gz.iv, s.z) : HUGE_F;
    collide = alive && (s_col <= s_bnd) && (s_col <= s_gas);
    gas_die = alive && !collide && (s_gas <= s_bnd);
    cross = alive && !collide && !gas_die;
    adv = fminf(fminf(s_col, s_bnd), s_gas);
    if (alive) s.tgas = s.tgas - adv * gzv;
  } else {
    collide = alive && (s_col <= s_bnd);
    cross = alive && !collide;
    adv = fminf(s_col, s_bnd);
  }
  float nxp = s.x + s.ux * adv;
  float nzp = s.z + s.uz * adv;
  if (cross && sx <= s_bnd) nxp = face_x + sign_x;
  if (cross && sz <= s_bnd) nzp = face_z + sign_z;
  nxp = wrap_fast(nxp, p.x0, p.x_max, p.wx);
  float nyp = s.y;
  if (TY) {
    nyp = s.y + s.uy * adv;
    if (cross && sy <= s_bnd) nyp = face_y + sign_y;
    nyp = wrap_fast(nyp, p.y0, p.y_max, p.wy);
  }
  const bool exit_top = cross && (nzp >= p.z_max);
  const bool exit_bot = cross && !exit_top && (nzp <= p.z0);
  if (exit_top) s.pk = 1;
  else if (exit_bot) s.pk = 2;
  if (GAS && gas_die) s.pk = 3;
  tau = cross ? tau - s_bnd * ext : (collide ? 0.0f : tau);
  if (alive) {
    s.x = nxp;
    s.z = nzp;
    if (TY) s.y = nyp;
  }

  bool collided = collide;
  if (ABS) {
    const bool die = collided && (u[3] >= p.ssa);
    if (die) s.pk = 3;
    collided = collided && !die;
  }
  if (DET && collided) {
#pragma unroll 1
    for (int d = 0; d < p.det.n; ++d) {
      int col;
      const float c = detector_contribution<IW>(p, d, s, IW ? pick(u, BD + d) : 0.0f, &col);
      if (c != 0.0f) atomicAdd(hist + col * p.det.n + d, (double)c);
    }
  }
  if (collided) {
    float nx, ny, nz;
    rotate_direction(s.ux, s.uy, s.uz, hg_cosine(p.g, u[1]), u[2], &nx, &ny, &nz);
    s.ux = nx;
    s.uy = ny;
    s.uz = nz;
  }
  int n_coll = collided ? 1 : 0;

  if (CHAIN > 0) {
    // Segment box around the collision point: extinction is constant
    // inside it, so a candidate that stays strictly within commits as a
    // physical collision; one that leaves defers its optical depth.
    const float wx_lo = face_dn(p.fx, s.x, p.x0), wx_hi = face_up(p.fx, s.x, p.x_max);
    float wz_lo = face_dn(p.fz, s.z, p.z0), wz_hi = face_up(p.fz, s.z, p.z_max);
    float inv_c = chain_value(p.fx, p.fx.iv, s.x) * chain_value(p.fz, p.fz.iv, s.z);
    float wy_lo = 0.0f, wy_hi = 0.0f;
    if (TY) {
      wy_lo = face_dn(p.fy, s.y, p.y0);
      wy_hi = face_up(p.fy, s.y, p.y_max);
      inv_c = inv_c * chain_value(p.fy, p.fy.iv, s.y);
    }
    float gzv_c = 0.0f;
    if (GAS) {
      // The box ends at the gas faces too; a candidate commits only while
      // its gas cost stays below tgas.
      gzv_c = chain_value(p.gz, p.gz.v, s.z);
      wz_lo = fmaxf(wz_lo, face_dn(p.gz, s.z, p.z0));
      wz_hi = fminf(wz_hi, face_up(p.gz, s.z, p.z_max));
    }
    bool chain = collided;
#pragma unroll
    for (int b = 0; b < CHAIN; ++b) {
      const int i0 = BD + b * BD;
      const float tau_new = exponential_deviate(u[i0]);
      const float s_c = tau_new * inv_c;
      const float cx = s.x + s.ux * s_c;
      const float cz = s.z + s.uz * s_c;
      bool inside = (cx > wx_lo) && (cx < wx_hi) && (cz > wz_lo) && (cz < wz_hi);
      float cy = s.y;
      if (TY) {
        cy = s.y + s.uy * s_c;
        inside = inside && (cy > wy_lo) && (cy < wy_hi);
      }
      float gcost = 0.0f;
      if (GAS) {
        gcost = s_c * gzv_c;
        inside = inside && (gcost < s.tgas);
      }
      bool commit = chain && inside;
      if (chain && !inside) tau = tau_new;
      if (commit) {
        s.x = cx;
        s.z = cz;
        if (TY) s.y = cy;
        if (GAS) s.tgas = s.tgas - gcost;
        n_coll += 1;
      }
      if (ABS) {
        const bool die_c = commit && (u[i0 + 3] >= p.ssa);
        if (die_c) s.pk = 3;
        commit = commit && !die_c;
      }
      if (commit) {
        float nx, ny, nz;
        rotate_direction(s.ux, s.uy, s.uz, hg_cosine(p.g, u[i0 + 1]), u[i0 + 2],
                         &nx, &ny, &nz);
        s.ux = nx;
        s.uy = ny;
        s.uz = nz;
      }
      chain = commit;
    }
  }

  s.tau = tau;
  s.orders += n_coll;
  const bool over = alive && (s.orders >= p.max_events);
  s.bad += over ? 1 : 0;
  s.evct += alive ? 1 : 0;
  s.alive = (alive && s.pk == 0 && !over) ? 1 : 0;
}

// State layout (i3rc_tpu_torch/kernels/event_block.py LaneState):
//   f: (8, L) float32 rows x, y, z, ux, uy, uz, tau, tgas
//   i: (5, L) int32   rows alive, orders, pk, bad, evct
// acc (DET): (n_cols, D) float64 detector accumulator, added to.
template <int K, int CHAIN, bool ABS, bool TY, bool DET, bool IW, bool GAS>
__global__ void __launch_bounds__(256)
fast_event_block_kernel(float* __restrict__ f, int* __restrict__ iv, double* acc,
                        int hist_in_smem, const __grid_constant__ EventParams p) {
  extern __shared__ double smem_hist[];
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  const size_t L = (size_t)p.n_lanes;
  constexpr int BD = ABS ? 4 : 3;
  // Draw slots: with DET && IW the count depends on the runtime D, so the
  // register array is sized for MAX_DETECTORS and only G groups are drawn.
  constexpr int ND_MAX = DET ? (IW ? BD + MAX_DETECTORS : BD) : BD * (1 + CHAIN);
  constexpr int G_MAX = (ND_MAX + 3) / 4;
  const int G = (DET && IW) ? (BD + p.det.n + 3) / 4 : G_MAX;

  double* hist = acc;
  if (DET && hist_in_smem) {
    hist = smem_hist;
    for (int k = threadIdx.x; k < p.det.n_bins; k += blockDim.x) smem_hist[k] = 0.0;
    __syncthreads();
  }

  if (lane < p.n_lanes) {
    Lane s;
    s.x = f[0 * L + lane];
    s.y = TY ? f[1 * L + lane] : 0.0f;
    s.z = f[2 * L + lane];
    s.ux = f[3 * L + lane];
    s.uy = f[4 * L + lane];
    s.uz = f[5 * L + lane];
    s.tau = f[6 * L + lane];
    s.tgas = GAS ? f[7 * L + lane] : 0.0f;
    s.alive = iv[0 * L + lane];
    s.orders = iv[1 * L + lane];
    s.pk = iv[2 * L + lane];
    s.bad = iv[3 * L + lane];
    s.evct = iv[4 * L + lane];

#pragma unroll 1
    for (int j = 0; j < K; ++j) {
      float u[4 * G_MAX];
#pragma unroll
      for (int g = 0; g < G_MAX; ++g) {
        if (g < G) {
          uint32_t w[4];
          philox4x32_10((uint32_t)lane, p.kb, (uint32_t)(j * G + g), STREAM_EVENT,
                        p.key0, p.key1, w);
#pragma unroll
          for (int k = 0; k < 4; ++k) u[4 * g + k] = to_unit(w[k]);
        } else {
#pragma unroll
          for (int k = 0; k < 4; ++k) u[4 * g + k] = 0.0f;
        }
      }
      fast_event<CHAIN, ABS, TY, DET, IW, GAS>(p, u, s, hist);
    }

    f[0 * L + lane] = s.x;
    if (TY) f[1 * L + lane] = s.y;
    f[2 * L + lane] = s.z;
    f[3 * L + lane] = s.ux;
    f[4 * L + lane] = s.uy;
    f[5 * L + lane] = s.uz;
    f[6 * L + lane] = s.tau;
    if (GAS) f[7 * L + lane] = s.tgas;
    iv[0 * L + lane] = s.alive;
    iv[1 * L + lane] = s.orders;
    iv[2 * L + lane] = s.pk;
    iv[3 * L + lane] = s.bad;
    iv[4 * L + lane] = s.evct;
  }

  if (DET && hist_in_smem) {
    __syncthreads();
    for (int k = threadIdx.x; k < p.det.n_bins; k += blockDim.x)
      if (smem_hist[k] != 0.0) atomicAdd(acc + k, smem_hist[k]);
  }
}

template <int K, int CHAIN, bool ABS, bool TY, bool DET, bool IW, bool GAS>
static void launch(float* f, int* i, double* acc, const EventParams& p,
                   cudaStream_t stream) {
  const int threads = 256;
  const int blocks = (p.n_lanes + threads - 1) / threads;
  const size_t hist_bytes = DET ? (size_t)p.det.n_bins * sizeof(double) : 0;
  const int in_smem = hist_bytes <= SMEM_HIST_BYTES;
  fast_event_block_kernel<K, CHAIN, ABS, TY, DET, IW, GAS>
      <<<blocks, threads, in_smem ? hist_bytes : 0, stream>>>(f, i, acc, in_smem, p);
}

template <int K, int CHAIN, bool DET, bool IW, bool GAS>
static void launch_flags(float* f, int* i, double* acc, const EventParams& p,
                         bool absorbing, bool track_y, cudaStream_t stream) {
  if (absorbing) {
    if (track_y) launch<K, CHAIN, true, true, DET, IW, GAS>(f, i, acc, p, stream);
    else launch<K, CHAIN, true, false, DET, IW, GAS>(f, i, acc, p, stream);
  } else {
    if (track_y) launch<K, CHAIN, false, true, DET, IW, GAS>(f, i, acc, p, stream);
    else launch<K, CHAIN, false, false, DET, IW, GAS>(f, i, acc, p, stream);
  }
}

// Only the variants the planner asks for: flux at chain depth 0-3, and the
// detector variant (always chain depth 0) with or without Iwabuchi.
template <int K, bool GAS>
static bool launch_variant(float* f, int* i, double* acc, const EventParams& p,
                           int chain, bool absorbing, bool track_y, bool detectors,
                           bool iwabuchi, cudaStream_t stream) {
  if (detectors) {
    if (chain != 0 || p.det.n < 1 || p.det.n > MAX_DETECTORS || acc == nullptr)
      return false;
    if (iwabuchi) launch_flags<K, 0, true, true, GAS>(f, i, acc, p, absorbing, track_y, stream);
    else launch_flags<K, 0, true, false, GAS>(f, i, acc, p, absorbing, track_y, stream);
    return true;
  }
  switch (chain) {
    case 0: launch_flags<K, 0, false, false, GAS>(f, i, acc, p, absorbing, track_y, stream); break;
    case 1: launch_flags<K, 1, false, false, GAS>(f, i, acc, p, absorbing, track_y, stream); break;
    case 2: launch_flags<K, 2, false, false, GAS>(f, i, acc, p, absorbing, track_y, stream); break;
    case 3: launch_flags<K, 3, false, false, GAS>(f, i, acc, p, absorbing, track_y, stream); break;
    default: return false;
  }
  return true;
}

// One K-event block of the variant the flags name, with the gas channel
// (GAS = true) or without it; false for an unsupported K, chain depth or
// detector count.
template <bool GAS>
static bool launch_block(float* f, int* i, double* acc, const EventParams& p, int K, int chain,
                  bool absorbing, bool track_y, bool detectors, bool iwabuchi,
                  cudaStream_t stream) {
  switch (K) {
    case 1:
      return launch_variant<1, GAS>(f, i, acc, p, chain, absorbing, track_y, detectors,
                                    iwabuchi, stream);
    case 8:
      return launch_variant<8, GAS>(f, i, acc, p, chain, absorbing, track_y, detectors,
                                    iwabuchi, stream);
    case 16:
      return launch_variant<16, GAS>(f, i, acc, p, chain, absorbing, track_y, detectors,
                                     iwabuchi, stream);
    default:
      return false;
  }
}

// The gas variants, instantiated in fast_event_block_gas.cu.
bool launch_block_gas(float* f, int* i, double* acc, const EventParams& p, int K,
                      int chain, bool absorbing, bool track_y, bool detectors,
                      bool iwabuchi, cudaStream_t stream);
