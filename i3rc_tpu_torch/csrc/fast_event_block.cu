// Fast event block: K complete photon-transport events per lane, state in
// registers.  Hopper (sm_90a) port of the flux variant of the Pallas kernel
// `_build_pallas_block` (i3rc_tpu/integrators/fastpath.py:665, pallas_call at
// :783), whose body runs `fast_event` (fastpath.py:1291-1676) with no radiance
// detectors, no gas channel, no column mode and no table mode.
//
// One thread owns one photon lane.  It loads the lane's state once, runs K
// events (free path, separable where-chain extinction, nearest segment face,
// collision or crossing with the face nudge and periodic x/y wrap, exit
// bookkeeping, Bernoulli absorption, Henyey-Greenstein scattering, up to
// CHAIN bonus collisions inside the segment box, counters) and stores the
// state back.  The state arrays are updated IN PLACE.
//
// What bounds it: ALU work.  Each event costs ceil(n_draws/4) Philox4x32-10
// calls (10 rounds of two 32x32 multiplies each) plus the where-chains over
// the segment thresholds; device memory traffic is only 2 x 4 B x 11 arrays
// per lane per K events (12 when y is tracked), read once and written once.
// The design keeps every intermediate in registers and reads the segment
// tables from the by-value parameter block (__grid_constant__), so the kernel
// touches device memory only at its start and end.
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
//    domain.  K, CHAIN, absorbing and track_y are template parameters.
//
// Float arithmetic follows the JAX reference and the PyTorch twin operation
// by operation; the library is built with --fmad=false so that no multiply-
// add is contracted, and constants are the float32 values written in hex.

#include <cuda_runtime.h>
#include <stdint.h>

#define MAX_SEGMENTS 24
#define STREAM_EVENT 0u

struct StepChain {
  int n;                        // number of interior thresholds
  float t[MAX_SEGMENTS];        // ascending thresholds
  float v[MAX_SEGMENTS + 1];    // segment values
  float iv[MAX_SEGMENTS + 1];   // reciprocal values (0 for zero segments)
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
  float x, y, z, ux, uy, uz, tau;
  int alive, orders, pk, bad, evct;
};

// One fast_event (fastpath.py:1291-1676, D = 0, MARCH = 1).  u holds the
// event's draws: u[0] free path, u[1] scattering cosine, u[2] azimuth,
// u[3] absorption (when ABS), then CHAIN bonus phases of BD draws each.
template <int CHAIN, bool ABS, bool TY>
__device__ __forceinline__ void fast_event(const EventParams& p, const float* u, Lane& s) {
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
  const float face_z = up_z ? face_up(p.fz, s.z, p.z_max) : face_dn(p.fz, s.z, p.z0);
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

  const bool collide = alive && (s_col <= s_bnd);
  const bool cross = alive && !collide;
  const float adv = fminf(s_col, s_bnd);
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
    const float wz_lo = face_dn(p.fz, s.z, p.z0), wz_hi = face_up(p.fz, s.z, p.z_max);
    float inv_c = chain_value(p.fx, p.fx.iv, s.x) * chain_value(p.fz, p.fz.iv, s.z);
    float wy_lo = 0.0f, wy_hi = 0.0f;
    if (TY) {
      wy_lo = face_dn(p.fy, s.y, p.y0);
      wy_hi = face_up(p.fy, s.y, p.y_max);
      inv_c = inv_c * chain_value(p.fy, p.fy.iv, s.y);
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
      bool commit = chain && inside;
      if (chain && !inside) tau = tau_new;
      if (commit) {
        s.x = cx;
        s.z = cz;
        if (TY) s.y = cy;
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
//   f: (7, L) float32 rows x, y, z, ux, uy, uz, tau
//   i: (5, L) int32   rows alive, orders, pk, bad, evct
template <int K, int CHAIN, bool ABS, bool TY>
__global__ void __launch_bounds__(256)
fast_event_block_kernel(float* __restrict__ f, int* __restrict__ iv,
                        const __grid_constant__ EventParams p) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= p.n_lanes) return;
  const size_t L = (size_t)p.n_lanes;
  constexpr int BD = ABS ? 4 : 3;
  constexpr int ND = BD * (1 + CHAIN);
  constexpr int G = (ND + 3) / 4;

  Lane s;
  s.x = f[0 * L + lane];
  s.y = TY ? f[1 * L + lane] : 0.0f;
  s.z = f[2 * L + lane];
  s.ux = f[3 * L + lane];
  s.uy = f[4 * L + lane];
  s.uz = f[5 * L + lane];
  s.tau = f[6 * L + lane];
  s.alive = iv[0 * L + lane];
  s.orders = iv[1 * L + lane];
  s.pk = iv[2 * L + lane];
  s.bad = iv[3 * L + lane];
  s.evct = iv[4 * L + lane];

#pragma unroll 1
  for (int j = 0; j < K; ++j) {
    float u[4 * G];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      uint32_t w[4];
      philox4x32_10((uint32_t)lane, p.kb, (uint32_t)(j * G + g), STREAM_EVENT,
                    p.key0, p.key1, w);
#pragma unroll
      for (int k = 0; k < 4; ++k) u[4 * g + k] = to_unit(w[k]);
    }
    fast_event<CHAIN, ABS, TY>(p, u, s);
  }

  f[0 * L + lane] = s.x;
  if (TY) f[1 * L + lane] = s.y;
  f[2 * L + lane] = s.z;
  f[3 * L + lane] = s.ux;
  f[4 * L + lane] = s.uy;
  f[5 * L + lane] = s.uz;
  f[6 * L + lane] = s.tau;
  iv[0 * L + lane] = s.alive;
  iv[1 * L + lane] = s.orders;
  iv[2 * L + lane] = s.pk;
  iv[3 * L + lane] = s.bad;
  iv[4 * L + lane] = s.evct;
}

template <int K, int CHAIN, bool ABS, bool TY>
static void launch(float* f, int* i, const EventParams& p, cudaStream_t stream) {
  const int threads = 256;
  const int blocks = (p.n_lanes + threads - 1) / threads;
  fast_event_block_kernel<K, CHAIN, ABS, TY><<<blocks, threads, 0, stream>>>(f, i, p);
}

template <int K, int CHAIN>
static bool launch_flags(float* f, int* i, const EventParams& p, bool absorbing,
                         bool track_y, cudaStream_t stream) {
  if (absorbing) {
    if (track_y) launch<K, CHAIN, true, true>(f, i, p, stream);
    else launch<K, CHAIN, true, false>(f, i, p, stream);
  } else {
    if (track_y) launch<K, CHAIN, false, true>(f, i, p, stream);
    else launch<K, CHAIN, false, false>(f, i, p, stream);
  }
  return true;
}

template <int K>
static bool launch_chain(float* f, int* i, const EventParams& p, int chain,
                         bool absorbing, bool track_y, cudaStream_t stream) {
  switch (chain) {
    case 0: return launch_flags<K, 0>(f, i, p, absorbing, track_y, stream);
    case 1: return launch_flags<K, 1>(f, i, p, absorbing, track_y, stream);
    case 2: return launch_flags<K, 2>(f, i, p, absorbing, track_y, stream);
    case 3: return launch_flags<K, 3>(f, i, p, absorbing, track_y, stream);
    default: return false;
  }
}

extern "C" {

int i3rc_event_params_size(void) { return (int)sizeof(EventParams); }

// Runs one K-event block in place on the given stream.  Returns
// cudaGetLastError() after the launch (cudaErrorInvalidValue for an
// unsupported K or CHAIN; the Python wrapper checks those first).
int i3rc_fast_event_block(float* f, int* i, const EventParams* params, int K,
                          int chain, int absorbing, int track_y, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  bool ok = false;
  switch (K) {
    case 1: ok = launch_chain<1>(f, i, *params, chain, absorbing, track_y, st); break;
    case 8: ok = launch_chain<8>(f, i, *params, chain, absorbing, track_y, st); break;
    case 16: ok = launch_chain<16>(f, i, *params, chain, absorbing, track_y, st); break;
    default: break;
  }
  if (!ok) return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Test entries: the kernel's Philox stream, exposed for bit-for-bit checks
// against i3rc_tpu_torch/core/rng.py.

__global__ void philox_uniforms_kernel(float* out, uint32_t k0, uint32_t k1,
                                       uint32_t block, uint32_t stream, int n_groups,
                                       int n_lanes) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n_lanes) return;
  for (int g = 0; g < n_groups; ++g) {
    uint32_t w[4];
    philox4x32_10((uint32_t)lane, block, (uint32_t)g, stream, k0, k1, w);
    for (int k = 0; k < 4; ++k) out[(size_t)(4 * g + k) * n_lanes + lane] = to_unit(w[k]);
  }
}

__global__ void philox_bits_kernel(uint32_t* out, uint32_t k0, uint32_t k1, uint32_t c1,
                                   uint32_t c2, uint32_t c3, int n_lanes) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n_lanes) return;
  uint32_t w[4];
  philox4x32_10((uint32_t)lane, c1, c2, c3, k0, k1, w);
  for (int k = 0; k < 4; ++k) out[4 * (size_t)lane + k] = w[k];
}

extern "C" {

// out: (4 * n_groups, n_lanes) float32, the rng.stream_uniforms layout.
int i3rc_philox_uniforms(float* out, unsigned int k0, unsigned int k1, unsigned int block,
                         unsigned int stream_id, int n_groups, int n_lanes, void* stream) {
  const int threads = 256;
  philox_uniforms_kernel<<<(n_lanes + threads - 1) / threads, threads, 0,
                           (cudaStream_t)stream>>>(out, k0, k1, block, stream_id,
                                                   n_groups, n_lanes);
  return (int)cudaGetLastError();
}

// out: (n_lanes, 4) uint32 words of Philox4x32-10 at counter (lane, c1, c2, c3).
int i3rc_philox_bits(unsigned int* out, unsigned int k0, unsigned int k1, unsigned int c1,
                     unsigned int c2, unsigned int c3, int n_lanes, void* stream) {
  const int threads = 256;
  philox_bits_kernel<<<(n_lanes + threads - 1) / threads, threads, 0,
                       (cudaStream_t)stream>>>(out, k0, k1, c1, c2, c3, n_lanes);
  return (int)cudaGetLastError();
}

}  // extern "C"
