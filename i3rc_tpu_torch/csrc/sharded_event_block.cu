// The x-sharded domain tracer's two kernels (kernels/sharded_block.py):
//
//  * SD, sharded_event_block_kernel: K maximum cross-section events of each
//    live photon lane of one rank's x-slab.  It replaces no TPU kernel: the
//    JAX package runs the event as XLA (`event`,
//    i3rc_tpu/parallel/sharded_domain.py:230-363, K of them unrolled in the
//    body of the lax.while_loop at :713).  One thread runs one lane, its
//    state in registers across the K events: the free path (drawn when the
//    carried optical depth is spent), the flight under the global majorant
//    to the first of the tentative collision, the z exit and the slab's x
//    faces (a migrant is put past its face, wrapped at the domain's x edge,
//    tagged +1 / -1 and keeps its remaining optical depth), the y wrap, the
//    local cell read (one row of 1 + 3 C floats: extinction, cumulative
//    fractions, albedos, table rows), the physical-or-null test, the
//    component pick by cumulative extinction, Bernoulli absorption, with
//    detectors the per-detector prefactor w ssa P / (4 pi |mu_d|) of every
//    physical collision from the replicated log-cubic forward fit (the lane
//    then freezes until the glue moves its record into the shadow-ray
//    pool), the cosine from the replicated cubic inverse CDF, the rotation
//    and its renormalization, and the event budget.  A lane stops at the
//    first event that ends its flight in the slab (exit, death, migration,
//    a pending record, the budget) and sits out the rest of the launch.
//  * SR, shadow_advance_kernel: K exact cell-DDA steps of every shadow ray
//    in flight in the rank's pool (sharded_domain.py:464-530, unrolled K
//    times in the same body): the optical depth of the cell crossed, a ray
//    past the slab's x face tagged to migrate (its tau carried), and an
//    escaping ray's w exp(-tau) added to its exit column's float64
//    radiance tallies, total and by component slot.  The lanes of a warp
//    that add to one bin are summed first and one lane adds the sum
//    (warp_red: a bin's lanes crowd when every ray of a detector leaves
//    through few columns; one float64 atomic a lane cost PZ 4x, PERF.md).
//
// Draws (SD): event j of block kb reads Philox4x32-10 groups 2j and 2j + 1
// at counter (lane, kb, group, STREAM_EVENT) under the key (seed, rank):
// u0-u3 the first group's words, u4-u6 the second's (free path,
// acceptance, absorption, cosine, azimuth, -, component), the twin's
// philox_uniforms(key, kb, K, 7, L) layout.  SR draws nothing.
//
// What bounds them.  SD per live lane-event: two Philox calls (~200
// integer operations), a logf where a new free path is drawn, four IEEE
// divisions for the face distances, the 4 + 12 C byte cell row, and per
// collision the 16-byte cubic row, the rotation's square roots and
// division, and per detector acosf, a 16-byte forward row and expf; the
// lane state (7 + D floats and 9 ints) is read and written once a launch.
// Operations, not bytes, bound a mid-flight block; the drain's launches
// read every lane's flags.  SR per ray step: the 4-byte extinction of the
// cell, three divisions and the moves; per escape expf and two float64
// adds.  Both are one thread a lane with no shared memory; a first design
// that is right (no wgmma, TMA or queue).
//
// Float arithmetic follows the twins (sharded_block.sharded_event and
// shadow_step) operation by operation, built with --fmad=false.

#include "fast_event_block.cuh"

// kernels/sharded_block.py: the rows of the lane state and of the pool.
#define SD_X 0
#define SD_Y 1
#define SD_Z 2
#define SD_UX 3
#define SD_UY 4
#define SD_UZ 5
#define SD_TAU 6
#define SD_PEND_PF 7
#define SD_ALIVE 0
#define SD_ORDERS 1
#define SD_PK 2
#define SD_TAG 3
#define SD_BAD 4
#define SD_PEND 5
#define SD_PEND_SRF 6
#define SD_PEND_COMP 7
#define SD_EVCT 8
#define SR_X 0
#define SR_Y 1
#define SR_Z 2
#define SR_TAU 3
#define SR_PF 4
#define SR_ALIVE 0
#define SR_DET 1
#define SR_TAG 2
#define SR_STEPS 3

// kernels/sharded_block.py _ShardParams.
struct ShardParams {
  const float* cells;    // (nx_loc * n_y * n_z, 1 + 3 n_comp): ext | cum_c | ssa_c | row_c
  const float4* cubic;   // inverse-CDF cubic rows: row_c * n_seg + segment
  const float4* fwd;     // log-phase cubic rows: row_c * n_fwd + segment (detectors)
  const float4* det;     // (n_dirs): direction, 1 / (4 pi |mu_d|)
  double* acc_int;       // SR: (nx_loc * n_y * n_dirs) radiance sums
  double* acc_byc;       // SR: (nx_loc * n_y * n_dirs * (n_comp + 1)) by slot
  int n_lanes, K, n_comp, n_seg, n_fwd, n_dirs, nx_loc, n_y, n_z, max_events;
  float x_lo, x_hi, x0, x_max, y0, y_max, z0, z_max, wx, wy, hi_push, lo_push;
  float inv_dx, inv_dy, inv_dz, dx, dy, dz, inv_max_ext, max_ext, nudge, fwd_scale;
  unsigned int key0, key1, kb;
};

__device__ __forceinline__ int sd_row(const ShardParams& p, float x, float y, float z) {
  const int ix = min(max((int)((x - p.x_lo) * p.inv_dx), 0), p.nx_loc - 1);
  const int iy = min(max((int)((y - p.y0) * p.inv_dy), 0), p.n_y - 1);
  const int iz = min(max((int)((z - p.z0) * p.inv_dz), 0), p.n_z - 1);
  return (ix * p.n_y + iy) * p.n_z + iz;
}

__global__ void __launch_bounds__(CTA_THREADS)
sharded_event_block_kernel(float* __restrict__ f, int* __restrict__ iv,
                           const __grid_constant__ ShardParams p) {
  const int lane = blockIdx.x * CTA_THREADS + threadIdx.x;
  if (lane >= p.n_lanes) return;
  const int L = p.n_lanes;
  int alive = iv[SD_ALIVE * L + lane];
  int pend = iv[SD_PEND * L + lane];
  if (!alive || pend) return;
  float x = f[SD_X * L + lane], y = f[SD_Y * L + lane], z = f[SD_Z * L + lane];
  float ux = f[SD_UX * L + lane], uy = f[SD_UY * L + lane], uz = f[SD_UZ * L + lane];
  float tau = f[SD_TAU * L + lane];
  int orders = iv[SD_ORDERS * L + lane], pk = iv[SD_PK * L + lane];
  int tag = iv[SD_TAG * L + lane], bad = iv[SD_BAD * L + lane];
  int pend_srf = iv[SD_PEND_SRF * L + lane], pend_comp = iv[SD_PEND_COMP * L + lane];
  int evct = iv[SD_EVCT * L + lane];
  const int C = p.n_comp;
  const int cols = 1 + 3 * C;
  for (int j = 0; j < p.K && alive && !pend; ++j) {
    uint32_t wa[4], wb[4];
    philox4x32_10((uint32_t)lane, p.kb, 2u * j, STREAM_EVENT, p.key0, p.key1, wa);
    philox4x32_10((uint32_t)lane, p.kb, 2u * j + 1u, STREAM_EVENT, p.key0, p.key1, wb);
    ++evct;
    if (!(tau > 0.0f)) tau = exponential_deviate(to_unit(wa[0]));
    const float s_col = tau * p.inv_max_ext;
    const float s_top = uz >= DIR_EPS_F ? (p.z_max - z) / uz : HUGE_F;
    const float s_bot = uz <= -DIR_EPS_F ? (p.z0 - z) / uz : HUGE_F;
    const float s_xhi = ux >= DIR_EPS_F ? (p.x_hi - x) / ux : HUGE_F;
    const float s_xlo = ux <= -DIR_EPS_F ? (p.x_lo - x) / ux : HUGE_F;
    const float s_mig = fminf(s_xhi, s_xlo);
    const float s_exit = fminf(s_top, s_bot);
    const float adv = fmaxf(fminf(fminf(s_col, s_exit), s_mig), 0.0f);
    const bool collide = s_col <= s_exit && s_col <= s_mig;
    const bool leave = !collide && s_exit <= s_mig;
    const bool migrate = !collide && !leave;
    const bool exit_top = leave && s_top <= s_bot;
    const bool exit_bot = leave && !exit_top;
    float nx = x + ux * adv;
    float ny = y + uy * adv;
    float nz = z + uz * adv;
    if (migrate) nx = s_xhi <= s_xlo ? p.hi_push : p.lo_push;
    x = wrap_fast(nx, p.x0, p.x_max, p.wx);
    y = wrap_fast(ny, p.y0, p.y_max, p.wy);
    z = exit_top ? p.z_max : (exit_bot ? p.z0 : nz);
    tau = collide ? 0.0f : tau - adv * p.max_ext;

    const float* cell = p.cells + (size_t)sd_row(p, x, y, z) * cols;
    const bool physical = collide && to_unit(wa[1]) < __ldg(cell) * p.inv_max_ext;
    int comp = 0;
    if (C > 1) {
      const float u6 = to_unit(wb[2]);
      int n = 0;
      for (int c = 0; c < C; ++c) n += u6 >= __ldg(cell + 1 + c) ? 1 : 0;
      comp = min(n, C - 1);
    }
    const float ssa = __ldg(cell + 1 + C + comp);
    const int rowb = (int)__ldg(cell + 1 + 2 * C + comp);
    const bool died = physical && to_unit(wa[2]) >= ssa;
    const bool scatter = physical && !died;
    if (p.n_dirs > 0 && physical) {
      // The local estimate's record from the incoming direction.
      for (int d = 0; d < p.n_dirs; ++d) {
        const float4 dd = __ldg(p.det + d);
        const float proj = fminf(fmaxf(ux * dd.x + uy * dd.y + uz * dd.z, -1.0f), 1.0f);
        const float pos = acosf(proj) * p.fwd_scale;
        const int seg = min(max((int)pos, 0), p.n_fwd - 1);
        const float t = pos - (float)seg;
        const float4 c = __ldg(p.fwd + rowb * p.n_fwd + seg);
        const float pf = expf(((c.w * t + c.z) * t + c.y) * t + c.x);
        f[(SD_PEND_PF + d) * L + lane] = pf * dd.w * ssa;
      }
      pend_comp = comp;
      pend_srf = 0;
      pend = 1;
    }
    if (exit_top) pk = 1;
    else if (exit_bot) pk = 2;
    else if (died) pk = 3;
    if (migrate) tag = ux >= 0.0f ? 1 : -1;
    if (scatter) {
      const float pos = fminf(fmaxf(to_unit(wa[3]), 0.0f), 1.0f) * (float)p.n_seg;
      const int seg = min(max((int)pos, 0), p.n_seg - 1);
      const float t = pos - (float)seg;
      const float4 c = __ldg(p.cubic + rowb * p.n_seg + seg);
      const float cs = fminf(fmaxf(((c.w * t + c.z) * t + c.y) * t + c.x, -1.0f), 1.0f);
      float nux, nuy, nuz;
      rotate_direction(ux, uy, uz, cs, to_unit(wb[0]), &nux, &nuy, &nuz);
      const float inv = 1.0f / sqrtf(fmaxf(nux * nux + nuy * nuy + nuz * nuz, EPS12_F));
      ux = nux * inv;
      uy = nuy * inv;
      uz = nuz * inv;
    }
    orders += physical ? 1 : 0;
    // The budget ends a lane still in flight (one that left, died or
    // migrated in this event is tallied or sent).
    const bool over = orders >= p.max_events && pk == 0 && tag == 0;
    bad += over ? 1 : 0;
    alive = (pk == 0 && tag == 0 && !over) ? 1 : 0;
  }
  f[SD_X * L + lane] = x;
  f[SD_Y * L + lane] = y;
  f[SD_Z * L + lane] = z;
  f[SD_UX * L + lane] = ux;
  f[SD_UY * L + lane] = uy;
  f[SD_UZ * L + lane] = uz;
  f[SD_TAU * L + lane] = tau;
  iv[SD_ALIVE * L + lane] = alive;
  iv[SD_ORDERS * L + lane] = orders;
  iv[SD_PK * L + lane] = pk;
  iv[SD_TAG * L + lane] = tag;
  iv[SD_BAD * L + lane] = bad;
  iv[SD_PEND * L + lane] = pend;
  iv[SD_PEND_SRF * L + lane] = pend_srf;
  iv[SD_PEND_COMP * L + lane] = pend_comp;
  iv[SD_EVCT * L + lane] = evct;
}

__global__ void __launch_bounds__(CTA_THREADS)
shadow_advance_kernel(float* __restrict__ qf, int* __restrict__ qi,
                      const __grid_constant__ ShardParams p) {
  const int r = blockIdx.x * CTA_THREADS + threadIdx.x;
  const int R = p.n_lanes;
  const bool in = r < R;
  int alive = in ? qi[SR_ALIVE * R + r] : 0;
  int tag = in ? qi[SR_TAG * R + r] : 0;
  bool live = alive && tag == 0;
  // Every thread of a warp with a ray in flight stays to the end: the
  // tallies' warp sums need the whole warp.
  if (!__any_sync(FULL_MASK, live)) return;
  const int D = p.n_dirs, C = p.n_comp;
  const int qdet = in ? qi[SR_DET * R + r] : 0;
  const int d = qdet % D, slot = qdet / D;
  const float4 dd = __ldg(p.det + d);
  float qx = 0.0f, qy = 0.0f, qz = 0.0f, qtau = 0.0f, qpf = 0.0f;
  int steps = 0;
  if (in) {
    qx = qf[SR_X * R + r];
    qy = qf[SR_Y * R + r];
    qz = qf[SR_Z * R + r];
    qtau = qf[SR_TAU * R + r];
    qpf = qf[SR_PF * R + r];
    steps = qi[SR_STEPS * R + r];
  }
  for (int k = 0; k < p.K; ++k) {
    int bin = -1;
    double contrib = 0.0;
    if (live) {
      ++steps;
      const int ix = min(max((int)((qx - p.x_lo) * p.inv_dx), 0), p.nx_loc - 1);
      const int iy = min(max((int)((qy - p.y0) * p.inv_dy), 0), p.n_y - 1);
      const int iz = min(max((int)((qz - p.z0) * p.inv_dz), 0), p.n_z - 1);
      const float ext = __ldg(p.cells + (size_t)((ix * p.n_y + iy) * p.n_z + iz) * (1 + 3 * C));
      const float fx = p.x_lo + ((float)ix + (dd.x >= 0.0f ? 1.0f : 0.0f)) * p.dx;
      const float fy = p.y0 + ((float)iy + (dd.y >= 0.0f ? 1.0f : 0.0f)) * p.dy;
      const float fz = p.z0 + ((float)iz + (dd.z >= 0.0f ? 1.0f : 0.0f)) * p.dz;
      const float s_x = fabsf(dd.x) >= DIR_EPS_F ? (fx - qx) / dd.x : HUGE_F;
      const float s_y = fabsf(dd.y) >= DIR_EPS_F ? (fy - qy) / dd.y : HUGE_F;
      const float s_z = fabsf(dd.z) >= DIR_EPS_F ? (fz - qz) / dd.z : HUGE_F;
      const float s = fmaxf(fminf(fminf(s_x, s_y), s_z), 0.0f);
      qtau = qtau + ext * s;
      const float adv = s + s * EPS6_F + p.nudge;
      float nqx = qx + dd.x * adv;
      const float nqy = wrap_fast(qy + dd.y * adv, p.y0, p.y_max, p.wy);
      const float nqz = qz + dd.z * adv;
      const bool escaped = (dd.z > 0.0f && nqz >= p.z_max) || (dd.z < 0.0f && nqz <= p.z0);
      if (escaped) {
        // The exit column from the crossing point, before the x wrap.
        const int eix = min(max((int)((nqx - p.x_lo) * p.inv_dx), 0), p.nx_loc - 1);
        const int eiy = min(max((int)((nqy - p.y0) * p.inv_dy), 0), p.n_y - 1);
        bin = (eix * p.n_y + eiy) * D + d;
        contrib = (double)(qpf * expf(-qtau));
        alive = 0;
      }
      const bool mig = !escaped && (nqx >= p.x_hi || nqx < p.x_lo);
      nqx = wrap_fast(nqx, p.x0, p.x_max, p.wx);
      if (mig) tag = dd.x >= 0.0f ? 1 : -1;
      qx = nqx;
      qy = nqy;
      qz = nqz;
      live = alive && tag == 0;
    }
    warp_red<false>(p.acc_int, bin, contrib);
    warp_red<false>(p.acc_byc, bin < 0 ? -1 : bin * (C + 1) + slot, contrib);
  }
  if (in) {
    qf[SR_X * R + r] = qx;
    qf[SR_Y * R + r] = qy;
    qf[SR_Z * R + r] = qz;
    qf[SR_TAU * R + r] = qtau;
    qi[SR_ALIVE * R + r] = alive;
    qi[SR_TAG * R + r] = tag;
    qi[SR_STEPS * R + r] = steps;
  }
}

extern "C" {

int i3rc_sharded_params_size(void) { return (int)sizeof(ShardParams); }

// One launch of SD (params->K events of every lane) in place on the given
// stream.  Returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for parameters the kernel does not take.
int i3rc_sharded_event_block(float* f, int* i, const ShardParams* params, void* stream) {
  const ShardParams& p = *params;
  if (p.K < 1 || p.n_lanes < 1 || p.n_comp < 1 || p.n_seg < 1 || p.n_dirs < 0
      || (p.n_dirs > 0 && (p.n_fwd < 1 || p.fwd == nullptr || p.det == nullptr)))
    return (int)cudaErrorInvalidValue;
  const int blocks = (p.n_lanes + CTA_THREADS - 1) / CTA_THREADS;
  sharded_event_block_kernel<<<blocks, CTA_THREADS, 0, (cudaStream_t)stream>>>(f, i, p);
  return (int)cudaGetLastError();
}

// One launch of SR (params->K DDA steps of each of params->n_lanes rays).
int i3rc_shadow_advance(float* qf, int* qi, const ShardParams* params, void* stream) {
  const ShardParams& p = *params;
  if (p.K < 1 || p.n_lanes < 1 || p.n_comp < 1 || p.n_dirs < 1 || p.det == nullptr
      || p.acc_int == nullptr || p.acc_byc == nullptr)
    return (int)cudaErrorInvalidValue;
  const int blocks = (p.n_lanes + CTA_THREADS - 1) / CTA_THREADS;
  shadow_advance_kernel<<<blocks, CTA_THREADS, 0, (cudaStream_t)stream>>>(qf, qi, p);
  return (int)cudaGetLastError();
}

}  // extern "C"
