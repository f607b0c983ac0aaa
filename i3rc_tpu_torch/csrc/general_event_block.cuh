// General event block: K events of the general transport kernel per lane,
// state in registers, with radiance detectors each event's local estimate.  Hopper (sm_90a) kernel for what the JAX
// package runs as XLA: `make_batch_tracer`'s event_step, flux branch
// (i3rc_tpu/integrators/wavefront.py:657, :1144-1540), a masked
// lax.while_loop over events with a nested while_loop for the DDA
// (i3rc_tpu/ops/dda.py:241-275).  It has no TPU kernel: there the loop's
// masks keep every lane in step with the slowest, and a host-side port as
// torch ops would pay a kernel launch per crossing and a host sync per
// crossing loop.  Here one thread runs one photon lane's own loops, the
// live lanes packed onto the working CTAs' warps: a lane waits only for the
// lanes of its warp (see "What bounds it").
//
// A launch is one block of the trace loop (kernels/general_block.py):
//  * the refill: dead lane l takes photon launched + rank(l), rank its
//    exclusive count of dead lanes over the grid, while that id is below the
//    budget (the FIFO rank of fast_event_block.cuh's prologue: each launch
//    leaves the dead counts at exit of its tiles of CTA_THREADS lanes in
//    dead[(kb + 1) & 1], and the CTA that runs tile c in the next sums the
//    entries below c), with the source sample of the
//    fast block (source_sample: (lane, kb, group, STREAM_REFILL)), weight 1,
//    order 0 and, in ray-tracing mode, its cell located.  Refilling per
//    block instead of per event changes which photon a lane carries when,
//    not what a photon does;
//  * K events, each (wavefront.py:1184-1540): the draws of event j (group
//    j * G + d / 4 at (lane, kb, ., STREAM_EVENT), word d % 4, only those the
//    variant consumes), a free path, then
//      MODE_RT   the DDA over the fine grid until the free path's optical
//                depth is spent (a collision) or the lane leaves through the
//                top or the bottom, reading total_ext per crossing;
//      MODE_MAX  the jump of tau / ext_max, exits traced back to the boundary
//                plane and wrapped in x/y, the cell located from the point;
//      MODE_WOOD the same DDA over the block-majorant grid, the fine cell
//                located from the stop position (not the stale indices the
//                reference reuses, wavefront.py:40-43),
//    the Woodcock / maximum cross-section acceptance against the cell's
//    extinction, the surface (albedo or the gridded BRDF of the surface
//    cell: the weight times R, a cosine-weighted direction), the component
//    pick by cumulative fractions and the co-albedo and phase index of the
//    packed cell row, the absorbed weight, Russian roulette, the scattering
//    cosine from the piecewise-cubic inverse CDF (one float4 row) and the
//    rotation (renormalized), and the event and crossing budgets (bad).
//    BERN is the weight-1 class of make_chained_flux_tracer
//    (wavefront.py:264): uniform single-component optics over a black
//    surface, absorption by survival with probability ssa, every exit and
//    death a count.
//  Exits and absorption add their weights to the float64 column tallies
//  (up, down, absorbed) and the volume tally straight away with
//  red.global.add.f64 (tally_add).
//  DET (radiance detectors): after the absorption and before the roulette
//    and the rotation, a physical collision (with the post-absorption
//    weight) and a surface event (an albedo's live reflection with its
//    post-reflection weight, a BRDF's every bottom hit with the pre-
//    reflection weight) make the local estimate (wavefront.py:884-1003,
//    :1487-1497): the lane pushes a record of the event to its CTA's ray
//    queue (gen_push), and after every lane's K events the CTA traces the
//    queue's rays (gen_flush): per (record, detector) the phase value at the
//    photon-to-detector angle from the forward table (the original one for
//    orders <= n_orig under hybrid phases) over 4 pi |mu_d|, or 1/pi, or
//    R(in -> detector)/pi, then the transmittance to the boundary: the DDA
//    on the fine grid to the end (EST_EXACT), Iwabuchi roulette on it
//    (EST_IWABUCHI), or ratio tracking over the block majorants (EST_RATIO;
//    in the weight-1 class the chained tracer's estimator, prefactor ssa P /
//    (4 pi |mu_d|), a bad or over-long ray counted bad).  A ray that leaves
//    through its detector's side adds its contribution (clipped at the cap,
//    the excess kept) to the float64 radiance tallies.  A ray's draws are
//    keyed by (lane, kb, event j, detector), so the thread that traces it
//    changes no number: the kernel is bit-equal to the twin, which traces
//    each event's rays inline.  (The JAX package's persistent ray slots,
//    use_queued_intensity, draw another stream.)
//
// What bounds it.  Device memory traffic is the lane state (15 rows) once
// in and out per launch, one 4-byte extinction read per crossing, one
// packed row and one 16-byte cubic row per collision, and the tallies;
// tables are read through the read-only path (__ldg) from L2 (the step
// cloud's extinction is 4 KB, Landsat's 7.8 MB, the cubic table 4 KB per
// phase entry).  The work is the dependent chain of a lane's events (the
// DDA's per-crossing load of total_ext and IEEE divisions, the Philox
// rounds, logf, the rotation): latency, not bytes or issue slots.  The
// first design ran thread l on lane l, 4096 CTAs at 2^20 lanes.  A warp
// census of the twin's per-event DDA steps (kernels/general_block.py
// warp_census, benchmarks/torch_general_census.py) found two wastes: dead
// lanes (live lanes fill 77% of a step-cloud batch's warp-event trips, 41%
// of a Landsat-general batch's, 10-13% in a tail block) and the slowest
// lane's DDA (17-22% of a warp's DDA lane-steps are live).  On the H100
// (PERF.md, section 6) neither set the time.  Compacting a CTA's 256 lanes left
// a sparse launch as slow as before: its 4096 CTAs still ran in ~8 waves of
// 528 slots (4 CTAs per SM), each CTA as long as its slowest warp's chain
// of 8 events, the rest of the SM idle.  What the design does about it:
//  * One CTA per tile of CTA_THREADS lanes, and each CTA computes T, the
//    tiles a working CTA takes, from the launch's expected density: about
//    CTA_THREADS live lanes after the refill (general_prologue).  Dense
//    blocks keep T = 1 and the hardware's scheduling of 4096 short CTAs; in
//    the drain CTA c runs tiles [c, c + T) when T divides c, the others
//    return at once, so the live lanes fill the working CTAs' warps and the
//    launch is about one wave.  A tail block (11-14% alive) runs in 0.156-
//    0.186 ms against the first design's 0.325-0.344.
//  * The live lanes are compacted, tile by tile in lane order, onto a list;
//    a lane keeps its global id for the Philox counter and the stores, so
//    every lane draws and computes as before, and each tile's dead count
//    at exit (the next launch's FIFO rank) is the first design's.  A dead
//    lane changes nothing in this kernel: no dead-lane contract is needed.
//  * In ray tracing with one tile the list is ordered by the key bucket of
//    the lane's cell (rt_bucket), so a warp holds lanes of like
//    extinction: 3% off a dense step-cloud block.  The same grouping by the
//    coarse block's majorant cost Landsat general 7% per batch and is not
//    built; a Woodcock or maximum cross-section list is in lane order.
//  * The T = 1 path runs thread t on list entry t; with T > 1 warps take
//    chunks of 32 entries from a shared counter.  Two call sites of
//    general_lane keep the loop's registers out of the dense blocks' code.
// Against the first design in one process on the same batches (PERF.md):
// 0.96x per step-cloud batch (ray tracing, 2^24 photons), 0.85x per
// Landsat-general batch (Woodcock, 2^21), 1.05x on a dense Landsat block.
// The slowest lane's DDA is left: a re-sort per event would address it.
//
// The estimate stage (DET).  The first design traced an event's D rays on the
// thread that collided, inside the event loop: a warp waited for its
// slowest lane's sum of D rays while lanes without an estimate idled, and
// the noinline call spilled 516-852 B.  A census of the twin's per-ray DDA
// steps (kernels/general_block.py ray_census, benchmarks/
// torch_ray_census.py) put that design's ray lane use at 18-37% and showed
// that dealing rays 32 at a time, over a warp or a CTA, cannot beat it on
// dense events (an event's largest sum of D rays is at most the sum of the
// D rounds' longest rays): only threads that take the next ray as soon as
// theirs ends can.  So the ray is the unit of work:
//  * the event loop is the flux set's with a push: a record of three
//    float4 to the CTA's segment of a device-memory queue (K a lane, so it
//    never fills; L2 holds it while the launch runs);
//  * after the lane loop's barrier every thread of the CTA, idle and dead
//    lanes' too, pulls the queue's rays detector by detector (like rays:
//    like lengths and bins), one DDA crossing a trip; a warp refills when
//    at most GEN_REFILL_AT of its threads still have a ray, the ended rays
//    tallied together (active_red) and the idle threads set up new ones;
//  * the per-lane integers (int_steps, int_rays, the weight-1 class's bad
//    rays) reach the lanes' rows by atomics after the lanes stored them.
// A warp-level buffer in shared memory, flushed by the warp when an event
// left it more than half full, ran 1.02-1.41x the first design's time per
// radiance batch: its event loop ran in step to flush, and each flush ended
// on its longest ray.  Per batch against the first design in one process
// (NVIDIA H100 80GB HBM3, 700 W; PERF.md section 6): 0.77x on the step
// cloud's exact radiance, 0.69x Iwabuchi, 0.85x Woodcock (bench.py:
// 249-271), 0.48x Landsat's ratio tracking; the DET set spills 0-20 B.  The
// float64 tallies' atomics are 7-20% of a radiance batch (a build without
// them).
//
// Float arithmetic follows the JAX reference and the PyTorch twin
// (wavefront.general_event, ops/dda.py) operation by operation, built with
// --fmad=false; divisions by grid constants are true divisions.

#pragma once

#include <type_traits>

#include "fast_event_block.cuh"

#define MODE_RT 0
#define MODE_MAX 1
#define MODE_WOOD 2
#define EST_EXACT 0
#define EST_IWABUCHI 1
#define EST_RATIO 2
#define STREAM_INTENSITY 6u
#define FOUR_PI_F 0x1.921fb6p+3f    // float32(4 pi)
#define INV_PI_F 0x1.45f306p-2f     // float32(1 / pi)
#define TRACE_TARGET_F 0x1.c363ccp+127f  // 3e38: the exact trace runs to the boundary
#define GEN_MAX_DRAWS 8
#define STATUS_TRACING 0
#define STATUS_SCATTER 1
#define STATUS_EXIT_TOP 2
#define STATUS_EXIT_BOT 3
#define STATUS_BAD 4
#define SPACING_EPS_F 0x1p-23f      // 2^-23
#define EPS20_F 0x1.79ca10p-67f     // 1e-20
#define EXT_EPS_F 0x1.4484c0p-100f  // 1e-30
// A CTA runs up to GEN_MAX_TILES tiles of CTA_THREADS lanes
// (general_prologue); GEN_CTAS_PER_SM CTAs fit on an SM.
#define GEN_MAX_TILES 16
#define GEN_CTAS_PER_SM 4
// Buckets of the ray-tracing lane order's key (kernels/general_block.py
// KEY_BUCKETS).
#define GEN_KEY_BUCKETS 4

// One grid of the DDA (ops/dda.py GridGeometry): regular axes by
// arithmetic, irregular ones from the edge arrays.
struct Grid {
  int nx, ny, nz, xy_regular, z_regular;
  float x0, y0, z0, x_max, y_max, z_max, dx, dy, dz;
  float wx, wy;                 // float32 periodic widths x_max - x0, y_max - y0
  const float* xe;              // (nx + 1) edges
  const float* ye;
  const float* ze;
};

// kernels/general_block.py _GeneralParams.
struct GeneralParams {
  Grid fine, coarse;
  const float* total_ext;       // (n_cells) fine extinction
  const float* cell;            // (n_cells, 1 + 3 n_comp) packed row
  const float* majorant;        // (n_blocks) block majorants (MODE_WOOD)
  const float4* cubic;          // (n_comp * max_entries * n_segments) cubic rows
  int n_comp, n_segments, max_entries, uniform_pf;
  int absorbing;                // BERN: survival draws (ssa < 1)
  int rr;                       // Russian roulette active
  float uniform_coalb, ssa, inv_max_ext, rr_w, rr_half;
  int max_crossings, max_events, n_draws;
  int d_accept, d_srf_mu, d_srf_phi, d_comp, d_extra;   // draw slots, -1 absent
  int srf_kind, n_xs, n_ys, n_params;
  float albedo;
  const float* srf_params;      // (n_xs * n_ys, n_params) BRDF parameters
  const float* srf_xe;          // (n_xs + 1) surface x edges
  const float* srf_ye;
  float srf_x0, srf_wx, srf_y0, srf_wy;
  double* columns;              // (n_cols, 3) float64: up, down, absorbed
  double* vol;                  // (n_cells) float64, or null
  long long n_photons;
  long long* ctl;               // launched (kb even), launched (kb odd), done, spent
  int* dead;                    // (2, n_tiles) dead lanes per tile at entry of even / odd kb
  SourceParams src;
  unsigned int key0, key1, kb;
  int n_lanes, K;
  // Local estimation (DET instantiations; n_dirs = 0 without detectors).
  int n_dirs, est, n_orig, clip, max_int_crossings, ratio_crossings, n_fwd;
  float zeta, zeta_ratio, cap;
  const float* dirs;            // (3, n_dirs) unit directions
  const float* abs_mu;          // (n_dirs)
  const int* exit_status;       // (n_dirs) STATUS_EXIT_TOP / _BOT
  const float* det_phi;         // (n_dirs) atan2(dir_y, dir_x)
  const float* forward;         // (n_comp * max_entries * n_fwd) phase values (hybrid)
  const float* forward_orig;    // the original values
  double* intensity;            // (n_cols * n_dirs) float64
  double* by_comp;              // (n_cols * n_dirs * (n_comp + 1)) float64
  double* excess;               // (n_dirs * (n_comp + 1)) float64
  int* int_steps;               // (n_lanes) the lane's estimate DDA steps
  int* int_rays;                // (n_lanes) the lane's estimate rays
  unsigned long long* flushes;  // the estimate stage's flushes, or null
  float4* rays;                 // (n_tiles * CTA_THREADS * K * GEN_RAY_F4) the ray records
};

struct GLane {
  float x, y, z, ux, uy, uz, w;
  int alive, ix, iy, iz, order, bad, evct, xing;
};

// Cell index of v on one axis (locate_x/y/z): floor of a true division on a
// regular axis, searchsorted(side="right") - 1 on an irregular one; clipped.
__device__ __forceinline__ int locate(float v, float lo, float d, const float* edges, int n,
                                      bool regular) {
  int i;
  if (regular) {
    i = (int)floorf((v - lo) / d);
  } else {
    int a = 0, b = n + 1;       // first edge > v
    while (a < b) {
      const int m = (a + b) >> 1;
      if (__ldg(edges + m) <= v) a = m + 1;
      else b = m;
    }
    i = a - 1;
  }
  return min(max(i, 0), n - 1);
}

// jnp.mod(a, b) for b > 0, as fmod moved into [0, b) (ops/dda.py fmod_positive).
__device__ __forceinline__ float fmod_positive(float a, float b) {
  const float m = fmodf(a, b);
  return (m != 0.0f && m < 0.0f) ? m + b : m;
}

__device__ __forceinline__ float wrap_periodic(float v, float lo, float hi, float w) {
  const float out = lo + fmod_positive(v - lo, w);
  return out >= hi ? lo : out;
}

// The DDA (make_crossing_stepper and trace_extinction): from (x, y, z) in
// cell (ix, iy, iz) along u until `target` optical depth of `ext` is spent
// (STATUS_SCATTER, the point inside the cell), the lane leaves through the
// top or the bottom (STATUS_EXIT_*, z on the boundary, iz clipped), a step is
// not positive, or max_crossings crossings are used (STATUS_BAD).
__device__ __forceinline__ int trace_extinction(const Grid& g, const float* __restrict__ ext,
                                                float& x, float& y, float& z, int& ix,
                                                int& iy, int& iz, float ux, float uy,
                                                float uz, float target, int max_crossings,
                                                int& steps) {
  const int side_x = ux >= 0.0f, side_y = uy >= 0.0f, side_z = uz >= 0.0f;
  const int inc_x = 2 * side_x - 1, inc_y = 2 * side_y - 1, inc_z = 2 * side_z - 1;
  const bool mx = fabsf(ux) >= DIR_EPS_F, my = fabsf(uy) >= DIR_EPS_F,
             mz = fabsf(uz) >= DIR_EPS_F;
  const float inv_ux = mx ? 1.0f / ux : HUGE_F;
  const float inv_uy = my ? 1.0f / uy : HUGE_F;
  const float inv_uz = mz ? 1.0f / uz : HUGE_F;
  const int n_flat = g.nx * g.ny * g.nz;
  float tau = 0.0f;
#pragma unroll 1
  for (int it = 0; it < max_crossings; ++it) {
    ++steps;
    const float ex = g.xy_regular ? g.x0 + (float)(ix + side_x) * g.dx
                                  : __ldg(g.xe + min(max(ix + side_x, 0), g.nx));
    const float ey = g.xy_regular ? g.y0 + (float)(iy + side_y) * g.dy
                                  : __ldg(g.ye + min(max(iy + side_y, 0), g.ny));
    const float ez = g.z_regular ? g.z0 + (float)(iz + side_z) * g.dz
                                 : __ldg(g.ze + min(max(iz + side_z, 0), g.nz));
    const float sx = mx ? (ex - x) * inv_ux : HUGE_F;
    const float sy = my ? (ey - y) * inv_uy : HUGE_F;
    const float sz = mz ? (ez - z) * inv_uz : HUGE_F;
    const float s = fminf(fminf(sx, sy), sz);
    if (s <= 0.0f) return STATUS_BAD;                              // :1711-1714
    const int flat = min(max((ix * g.ny + iy) * g.nz + iz, 0), n_flat - 1);
    const float ce = __ldg(ext + flat);
    if (tau + s * ce > target) {                                   // :1721-1731
      const float partial = ce > 0.0f ? (target - tau) / fmaxf(ce, EXT_EPS_F) : 0.0f;
      x = x + partial * ux;
      y = y + partial * uy;
      z = z + partial * uz;
      return STATUS_SCATTER;
    }
    // A full crossing to the closest face, with the near-corner guard.
    const float nx_ = x + s * ux, ny_ = y + s * uy, nz_ = z + s * uz;
    const bool cx = (sx <= s) || (fabsf(ex - nx_) <= 2.0f * (SPACING_EPS_F * fmaxf(fabsf(nx_), EPS20_F)));
    const bool cy = (sy <= s) || (fabsf(ey - ny_) <= 2.0f * (SPACING_EPS_F * fmaxf(fabsf(ny_), EPS20_F)));
    const bool cz = (sz <= s) || (fabsf(ez - nz_) <= 2.0f * (SPACING_EPS_F * fmaxf(fabsf(nz_), EPS20_F)));
    x = cx ? ex : nx_;
    y = cy ? ey : ny_;
    z = cz ? ez : nz_;
    if (cx) ix += inc_x;
    if (cy) iy += inc_y;
    if (cz) iz += inc_z;
    tau = tau + s * ce;
    // Periodic x/y (:1774-1788): exact edge reassignment.
    if (ix < 0) { ix = g.nx - 1; x = g.x_max; }
    else if (ix >= g.nx) { ix = 0; x = g.x0; }
    if (iy < 0) { iy = g.ny - 1; y = g.y_max; }
    else if (iy >= g.ny) { iy = 0; y = g.y0; }
    // Vertical exits (:1793-1804).
    if (iz >= g.nz) {
      iz = g.nz - 1;
      z = g.z_max;
      return STATUS_EXIT_TOP;
    }
    if (iz < 0) {
      iz = 0;
      z = g.z0;
      return STATUS_EXIT_BOT;
    }
  }
  return STATUS_BAD;            // the crossing budget (grazing trajectories)
}

// A ray's direction as the DDA reads it: the side of each axis it moves
// toward, the cell index step, and the reciprocal of each component that
// is not near 0 (HUGE_F otherwise).
struct DdaDir {
  float ux, uy, uz, inv_ux, inv_uy, inv_uz;
  int side_x, side_y, side_z;
  bool mx, my, mz;
};

__device__ __forceinline__ DdaDir dda_dir(float ux, float uy, float uz) {
  DdaDir d;
  d.ux = ux;
  d.uy = uy;
  d.uz = uz;
  d.side_x = ux >= 0.0f;
  d.side_y = uy >= 0.0f;
  d.side_z = uz >= 0.0f;
  d.mx = fabsf(ux) >= DIR_EPS_F;
  d.my = fabsf(uy) >= DIR_EPS_F;
  d.mz = fabsf(uz) >= DIR_EPS_F;
  d.inv_ux = d.mx ? 1.0f / ux : HUGE_F;
  d.inv_uy = d.my ? 1.0f / uy : HUGE_F;
  d.inv_uz = d.mz ? 1.0f / uz : HUGE_F;
  return d;
}

// One crossing of the DDA (make_crossing_stepper), the body of
// trace_extinction's loop for a ray that a flush advances one crossing a
// trip (the same operations; trace_extinction keeps its own, whose code the
// flux set's registers were fitted to): from (x, y, z) in cell (ix, iy, iz)
// with `tau` optical depth of `ext` spent so far, either the point inside
// the cell where it reaches `target` (STATUS_SCATTER, tau = target), or the
// closest face and the next cell (wrapped in x/y), leaving through the top
// or the bottom (STATUS_EXIT_*, z on the boundary, iz clipped), a step that
// is not positive (STATUS_BAD), or STATUS_TRACING to go on.
__device__ __forceinline__ int dda_crossing(const Grid& g, const float* __restrict__ ext,
                                            const DdaDir& u, float& x, float& y, float& z,
                                            int& ix, int& iy, int& iz, float target,
                                            float& tau) {
  const float ex = g.xy_regular ? g.x0 + (float)(ix + u.side_x) * g.dx
                                : __ldg(g.xe + min(max(ix + u.side_x, 0), g.nx));
  const float ey = g.xy_regular ? g.y0 + (float)(iy + u.side_y) * g.dy
                                : __ldg(g.ye + min(max(iy + u.side_y, 0), g.ny));
  const float ez = g.z_regular ? g.z0 + (float)(iz + u.side_z) * g.dz
                               : __ldg(g.ze + min(max(iz + u.side_z, 0), g.nz));
  const float sx = u.mx ? (ex - x) * u.inv_ux : HUGE_F;
  const float sy = u.my ? (ey - y) * u.inv_uy : HUGE_F;
  const float sz = u.mz ? (ez - z) * u.inv_uz : HUGE_F;
  const float s = fminf(fminf(sx, sy), sz);
  if (s <= 0.0f) return STATUS_BAD;                              // :1711-1714
  const int flat = min(max((ix * g.ny + iy) * g.nz + iz, 0), g.nx * g.ny * g.nz - 1);
  const float ce = __ldg(ext + flat);
  if (tau + s * ce > target) {                                   // :1721-1731
    const float partial = ce > 0.0f ? (target - tau) / fmaxf(ce, EXT_EPS_F) : 0.0f;
    x = x + partial * u.ux;
    y = y + partial * u.uy;
    z = z + partial * u.uz;
    tau = target;
    return STATUS_SCATTER;
  }
  // A full crossing to the closest face, with the near-corner guard.
  const float nx_ = x + s * u.ux, ny_ = y + s * u.uy, nz_ = z + s * u.uz;
  const bool cx = (sx <= s) || (fabsf(ex - nx_) <= 2.0f * (SPACING_EPS_F * fmaxf(fabsf(nx_), EPS20_F)));
  const bool cy = (sy <= s) || (fabsf(ey - ny_) <= 2.0f * (SPACING_EPS_F * fmaxf(fabsf(ny_), EPS20_F)));
  const bool cz = (sz <= s) || (fabsf(ez - nz_) <= 2.0f * (SPACING_EPS_F * fmaxf(fabsf(nz_), EPS20_F)));
  x = cx ? ex : nx_;
  y = cy ? ey : ny_;
  z = cz ? ez : nz_;
  if (cx) ix += 2 * u.side_x - 1;
  if (cy) iy += 2 * u.side_y - 1;
  if (cz) iz += 2 * u.side_z - 1;
  tau = tau + s * ce;
  // Periodic x/y (:1774-1788): exact edge reassignment.
  if (ix < 0) { ix = g.nx - 1; x = g.x_max; }
  else if (ix >= g.nx) { ix = 0; x = g.x0; }
  if (iy < 0) { iy = g.ny - 1; y = g.y_max; }
  else if (iy >= g.ny) { iy = 0; y = g.y0; }
  // Vertical exits (:1793-1804).
  if (iz >= g.nz) {
    iz = g.nz - 1;
    z = g.z_max;
    return STATUS_EXIT_TOP;
  }
  if (iz < 0) {
    iz = 0;
    z = g.z0;
    return STATUS_EXIT_BOT;
  }
  return STATUS_TRACING;
}

// The surface's reflectance at (x, y) for an arrival (mu_in, phi_in) and an
// outgoing (mu_out, phi_out): the albedo, or the BRDF of the surface cell
// holding the periodically wrapped point (wavefront.py:783-796).  Not
// inlined: the BRDFs stay out of the event loop's registers.
static __device__ __noinline__ float surface_reflectance(const GeneralParams& p, float x,
                                                         float y, float mu_in, float mu_out,
                                                         float phi_in, float phi_out) {
  if (p.srf_kind == SURFACE_ALBEDO) return p.albedo;
  const float xp = p.srf_x0 + fmod_positive(x - p.srf_x0, p.srf_wx);
  const float yp = p.srf_y0 + fmod_positive(y - p.srf_y0, p.srf_wy);
  const int ixs = locate(xp, 0.0f, 1.0f, p.srf_xe, p.n_xs, false);
  const int iys = locate(yp, 0.0f, 1.0f, p.srf_ye, p.n_ys, false);
  SurfaceParams sp;
  sp.kind = p.srf_kind;
  const float* a = p.srf_params + (size_t)(ixs * p.n_ys + iys) * p.n_params;
#pragma unroll
  for (int k = 0; k < MAX_BRDF_PARAMS; ++k) sp.params[k] = k < p.n_params ? __ldg(a + k) : 0.0f;
  return brdf_reflectance(sp, mu_in, mu_out, phi_in, phi_out);
}

// The slots of an event's draws in kernels/general_block.py variant's order:
// the free path, the cosine, the azimuth, then the acceptance (MODE_MAX,
// MODE_WOOD), the surface's two (REFL), the component pick (general
// optics), and the extra draw (the weight-1 class's survival or the
// roulette).  -1 where the instantiation has no such draw.
__host__ __device__ constexpr int slot_accept(int mode) { return mode != MODE_RT ? 3 : -1; }
__host__ __device__ constexpr int slot_srf(int mode, bool refl) {
  return refl ? 3 + (mode != MODE_RT) : -1;
}
__host__ __device__ constexpr int slot_comp(int mode, bool uni, bool refl) {
  return uni ? -1 : 3 + (mode != MODE_RT) + 2 * refl;
}
__host__ __device__ constexpr int slot_extra(int mode, bool uni, bool refl) {
  return 3 + (mode != MODE_RT) + 2 * refl + !uni;
}

// Linear interpolation at position in [0, 1] into a table row of n values
// at i / (n - 1) (wavefront.table_lookup).
__device__ __forceinline__ float table_lookup(const float* __restrict__ row, float position,
                                              int n) {
  const float pos = fminf(fmaxf(position, 0.0f), 1.0f) * (float)(n - 1);
  const int i0 = min(max((int)pos, 0), n - 2);
  const float frac = pos - (float)i0;
  return (1.0f - frac) * __ldg(row + i0) + frac * __ldg(row + i0 + 1);
}

// Adds v to base[key] for the lanes of the active mask with key >= 0: the
// lanes of one key grouped by __match_any_sync over __activemask(), summed
// by warp_red's shuffle tree (fast_event_block.cuh), the group's lowest lane
// adding the sum with tally_add.  G's lanes diverge per thread (a lane that
// makes no estimate this event is elsewhere), so the warp-wide warp_red
// (FULL_MASK) cannot run here; the lanes that reached this point together
// can.  Against one red.global.add.f64 a lane: 25% off a dense step-cloud
// block of chip_smoke.py's path (a) (NVIDIA H100 80GB HBM3, 700 W; PERF.md).
__device__ __forceinline__ void active_red(double* base, int key, double v) {
  const unsigned act = __activemask();
  const unsigned peers = __match_any_sync(act, key);
  const int wl = threadIdx.x & 31;
  const unsigned below = (1u << wl) - 1u;
  unsigned higher = peers & ~(below | (1u << wl));
  int rank = __popc(peers & below);
  while (__any_sync(act, higher != 0u)) {
    const int next = __ffs(higher);
    const double t = __shfl_sync(act, v, next ? next - 1 : wl);
    if (next) v += t;
    higher &= ~__ballot_sync(act, rank & 1);
    rank >>= 1;
  }
  if (key >= 0 && (peers & below) == 0u) tally_add(base + key, v);
}

// The estimate stage's ray queue (DET): a CTA's records, one per estimating
// event, in the order pushed, in its own segment of `rays` (device memory,
// which L2 holds while the launch runs): the CTA that runs tiles [c, c + T)
// owns records [c, c + T) * CTA_THREADS * K, room for an estimate at every
// event of every lane it runs, so the queue never fills.  A record is three
// float4: the point and the estimate's weight; the incoming direction and
// the fine column ix * ny + iy; the fine iz, the forward-table row offset,
// `meta` (the event j, the tally slot: 0 the surface, comp + 1; the surface
// flag; whether the order reads the original table under hybrid phases)
// and the lane.
#define GEN_RAY_F4 3
#define GEN_RAY_MAX_SLOT 0xffff    // the tally slot's field (kernels/general_block.py RAY_MAX_SLOT)
#define GEN_RAY_SURFACE (1 << 16)
#define GEN_RAY_ORIG (1 << 17)
#define GEN_RAY_J_SHIFT 18

struct GenQueue {
  int n;                        // records pushed
  int next;                     // the next ray the flush deals
};

// The record of one estimating event (general_event's call site), its slot
// taken by a shared atomic; the values are the event's own registers, bit
// for bit.
__device__ __forceinline__ void gen_push(const GeneralParams& p, GenQueue& q, int lane, int j,
                                         bool surface, float x, float y, float z, int ix,
                                         int iy, int iz, float ux, float uy, float uz,
                                         float weight, int comp, int pf, int order) {
  const int k = atomicAdd(&q.n, 1);
  float4* r = p.rays + GEN_RAY_F4 * ((size_t)blockIdx.x * CTA_THREADS * p.K + k);
  const int meta = (surface ? GEN_RAY_SURFACE : comp + 1)
                   | (p.n_orig > 0 && order <= p.n_orig ? GEN_RAY_ORIG : 0)
                   | (j << GEN_RAY_J_SHIFT);
  r[0] = make_float4(x, y, z, weight);
  r[1] = make_float4(ux, uy, uz, __int_as_float(ix * p.fine.ny + iy));
  r[2] = make_float4(__int_as_float(iz), __int_as_float((comp * p.max_entries + pf) * p.n_fwd),
                     __int_as_float(meta), __int_as_float(lane));
}

// One ray (record, detector) in flight in a flush: what a thread holds
// between the trips of the pull loop.  The DDA's point, cell, depth spent
// and crossings used (per round in ratio tracking, on the block grid), its
// target; the estimate's weight and phase value; Iwabuchi's acceptance
// draw, P pi, tau_max and small-phase flag; ratio tracking's transmittance,
// round, kill draw and the pair's two words for the odd round.
struct GenRay {
  DdaDir u;
  float x, y, z, tau, target, weight, norm_pf, u_accept, pn, tau_max, T, u_kill;
  uint32_t w_free, w_kill;
  int ix, iy, iz, it, steps, round, d, lane, j, slot, exit_d;
  bool small;
};

// The round's draws and the start of its flight on the block grid
// (wavefront.ratio_transmittance): round r reads words 2 (r % 2) and
// 2 (r % 2) + 1 of the Philox call of pair r / 2.
__device__ __forceinline__ void gen_ratio_round(const GeneralParams& p, GenRay& a) {
  const Grid& c = p.coarse;
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
  a.u_kill = to_unit(wk);
  a.target = exponential_deviate(to_unit(wf));
  a.ix = locate(a.x, c.x0, c.dx, c.xe, c.nx, c.xy_regular);
  a.iy = locate(a.y, c.y0, c.dy, c.ye, c.ny, c.xy_regular);
  a.iz = locate(a.z, c.z0, c.dz, c.ze, c.nz, c.z_regular);
  a.tau = 0.0f;
  a.it = 0;
}

// The ray r of the CTA's queue of n records, dealt detector by detector
// (ray r is record r % n toward detector r / n), set up as
// wavefront.intensity_estimate sets up its trace: the phase value at the
// photon-to-detector angle from the forward table (the original one for
// the record's flag) over 4 pi |mu_d|, or 1/pi, or R(in -> detector)/pi;
// then the exact trace to the boundary, Iwabuchi's draws and target, or
// ratio tracking's first round.
template <bool RATIO>
__device__ __forceinline__ void gen_ray_start(const GeneralParams& p, int r, int n, bool bern,
                                              GenRay& a) {
  const int D = p.n_dirs;
  const int d = r / n;
  const int k = r - d * n;
  const float4* rec = p.rays + GEN_RAY_F4 * ((size_t)blockIdx.x * CTA_THREADS * p.K + k);
  const float4 r0 = __ldcg(rec), r1 = __ldcg(rec + 1), r2 = __ldcg(rec + 2);
  const float ux = r1.x, uy = r1.y, uz = r1.z;
  const int meta = __float_as_int(r2.z);
  a.d = d;
  a.lane = __float_as_int(r2.w);
  a.j = meta >> GEN_RAY_J_SHIFT;
  const bool surface = meta & GEN_RAY_SURFACE;
  a.slot = surface ? 0 : meta & GEN_RAY_MAX_SLOT;
  a.weight = r0.w;
  a.x = r0.x;
  a.y = r0.y;
  a.z = r0.z;
  const float* row = ((meta & GEN_RAY_ORIG) ? p.forward_orig : p.forward) + __float_as_int(r2.y);
  const bool brdf = surface && p.srf_kind > SURFACE_ALBEDO;
  const float phi_in = brdf ? atan2f(uy, ux) : 0.0f;
  const float dx = __ldg(p.dirs + d), dy = __ldg(p.dirs + D + d), dz = __ldg(p.dirs + 2 * D + d);
  a.exit_d = __ldg(p.exit_status + d);
  const float proj = fminf(fmaxf(ux * dx + uy * dy + uz * dz, -1.0f), 1.0f);
  const float pfv = table_lookup(row, acosf(proj) / PI_F, p.n_fwd);
  const float amu = __ldg(p.abs_mu + d);
  if (bern) a.norm_pf = pfv * p.ssa / (FOUR_PI_F * amu);   // the weight-1 class's prefactor
  else if (!surface) a.norm_pf = pfv / (FOUR_PI_F * amu);
  else if (brdf)
    a.norm_pf = dz > 0.0f
        ? surface_reflectance(p, a.x, a.y, uz, dz, phi_in, __ldg(p.det_phi + d)) / PI_F : 0.0f;
  else a.norm_pf = INV_PI_F;
  a.u = dda_dir(dx, dy, dz);
  a.steps = 0;
  if (RATIO) {
    a.T = 1.0f;
    a.round = 0;
    gen_ratio_round(p, a);
    return;
  }
  a.target = TRACE_TARGET_F;
  a.small = false;
  if (p.est == EST_IWABUCHI) {
    uint32_t w4[4];
    philox4x32_10((uint32_t)a.lane, p.kb, (uint32_t)a.j + (uint32_t)p.K * (uint32_t)d,
                  STREAM_INTENSITY, p.key0, p.key1, w4);
    const float tau_free = exponential_deviate(to_unit(w4[0]));
    a.u_accept = to_unit(w4[1]);
    a.pn = PI_F * a.norm_pf;
    a.small = a.pn <= p.zeta;
    a.tau_max = -logf(p.zeta / fmaxf(a.pn, TINY_F));
    a.target = a.small ? tau_free : a.tau_max + tau_free;
  }
  const int c = __float_as_int(r1.w);
  a.ix = c / p.fine.ny;
  a.iy = c - a.ix * p.fine.ny;
  a.iz = __float_as_int(r2.x);
  a.tau = 0.0f;
  a.it = 0;
}

// One trip of a ray in flight: one crossing of its DDA (the fine grid, or
// the round's flight on the block grid; STATUS_BAD once the crossing budget
// is used) and, in ratio tracking, the end of a round: the transmittance
// times clip(1 - ext / majorant, 0, 1) at a tentative collision, its
// roulette at zeta_ratio, the next round.  Returns STATUS_TRACING while the
// ray goes on, else its end: for ratio tracking exit_d (left through the
// detector's side; the fine column in ix, iy), STATUS_BAD (a bad flight or
// alive after the round budget) or STATUS_SCATTER (killed, or left through
// the other side).
template <bool RATIO>
__device__ __forceinline__ int gen_ray_trip(const GeneralParams& p, GenRay& a, int rounds) {
  const Grid& g = p.fine;
  const Grid& c = p.coarse;
  if (a.it >= (RATIO ? p.ratio_crossings : p.max_int_crossings)) return STATUS_BAD;
  ++a.it;
  ++a.steps;
  const int status = dda_crossing(RATIO ? c : g, RATIO ? p.majorant : p.total_ext, a.u, a.x,
                                  a.y, a.z, a.ix, a.iy, a.iz, a.target, a.tau);
  if (!RATIO || status == STATUS_TRACING) return status;
  if (status == a.exit_d) {
    a.ix = locate(a.x, g.x0, g.dx, g.xe, g.nx, g.xy_regular);
    a.iy = locate(a.y, g.y0, g.dy, g.ye, g.ny, g.xy_regular);
    return status;
  }
  if (status != STATUS_SCATTER) return status == STATUS_BAD ? STATUS_BAD : STATUS_SCATTER;
  const int fx = locate(a.x, g.x0, g.dx, g.xe, g.nx, g.xy_regular);
  const int fy = locate(a.y, g.y0, g.dy, g.ye, g.ny, g.xy_regular);
  const int fz = locate(a.z, g.z0, g.dz, g.ze, g.nz, g.z_regular);
  const float ext = __ldg(p.total_ext + (fx * g.ny + fy) * g.nz + fz);
  const float maj = __ldg(p.majorant + (a.ix * c.ny + a.iy) * c.nz + a.iz);
  a.T = a.T * fminf(fmaxf(1.0f - ext / fmaxf(maj, EXT_EPS_F), 0.0f), 1.0f);
  if (a.T < p.zeta_ratio) a.T = (a.u_kill >= a.T / p.zeta_ratio) ? 0.0f : p.zeta_ratio;
  if (!(a.T > 0.0f)) return STATUS_SCATTER;
  if (++a.round >= rounds) return STATUS_BAD;
  gen_ratio_round(p, a);
  return STATUS_TRACING;
}

// The end of a ray (its status): the contribution of a ray that left
// through its detector's side, clipped at the cap (the excess kept), to
// the float64 tallies summed over the threads of the warp that tally at the
// same refill on the same bin (active_red); the ray's DDA steps to
// int_steps[lane], D rays an estimate to int_rays[lane] and, in the
// weight-1 class (`bern`), a bad ray to the lane's bad row, by integer
// atomics: exact in any order.
template <bool RATIO>
__device__ __forceinline__ void gen_ray_end(const GeneralParams& p, int* __restrict__ iv,
                                            const GenRay& a, int status, bool bern) {
  const Grid& g = p.fine;
  const int D = p.n_dirs, n1 = p.n_comp + 1;
  float contrib = 0.0f;
  if (status == a.exit_d) {
    if (RATIO) {
      contrib = bern ? a.norm_pf * a.T : a.weight * a.norm_pf * a.T;
    } else if (p.est == EST_IWABUCHI) {
      const float flat = a.weight * p.zeta / PI_F;
      if (a.small) contrib = a.u_accept <= a.pn / p.zeta ? flat : 0.0f;
      else contrib = a.tau <= a.tau_max ? a.weight * a.norm_pf * expf(-a.tau) : flat;
    } else {
      contrib = a.weight * a.norm_pf * expf(-a.tau);
    }
  }
  if (p.clip) {
    const float over = fmaxf(contrib - p.cap, 0.0f);
    contrib = fminf(contrib, p.cap);
    if (over > 0.0f) tally_add(p.excess + a.d * n1 + a.slot, (double)over);
  }
  const int bin = (a.ix * g.ny + a.iy) * D + a.d;
  active_red(p.intensity, contrib != 0.0f ? bin : -1, (double)contrib);
  active_red(p.by_comp, contrib != 0.0f ? bin * n1 + a.slot : -1, (double)contrib);
  if (a.steps) atomicAdd(p.int_steps + a.lane, a.steps);
  if (a.d == 0) atomicAdd(p.int_rays + a.lane, D);
  if (RATIO && bern && status == STATUS_BAD) atomicAdd(iv + 5 * (size_t)p.n_lanes + a.lane, 1);
}

// The pull loop of a flush, in two phases.  The refill: the threads whose
// ray ended tally it (together: their sums over a bin are taken at once),
// and every idle thread takes the next ray from the group's counter and
// sets it up.  The steps: each trip advances every thread's ray by one
// crossing (a thread whose ray ends idles), until at most GEN_REFILL_AT
// threads of the warp have a ray while rays are left, or none has.  A warp
// so waits for its longest ray only at the end of the flush, and pays a
// ray's set-up and tally once a refill, not in every trip of its steps
// (refilling at 8 or 16 of 32 ran 0.90-1.0x the time of refilling at 24
// per radiance batch; PERF.md section 6).
#define GEN_REFILL_AT 8
template <bool RATIO>
__device__ __forceinline__ void gen_pull(const GeneralParams& p, int* __restrict__ iv, int n,
                                         int* next, bool bern) {
  const int nr = n * p.n_dirs;
  const int rounds = bern ? 4 * p.max_int_crossings : p.max_int_crossings;
  GenRay a;
  int status = STATUS_TRACING;
  bool act = false, fin = false, more = true;
#pragma unroll 1
  for (;;) {
    if (fin) {
      gen_ray_end<RATIO>(p, iv, a, status, bern);
      fin = false;
    }
    if (!act && more) {
      const int r = atomicAdd(next, 1);
      more = r < nr;
      if (more) {
        gen_ray_start<RATIO>(p, r, n, bern, a);
        act = true;
      }
    }
    if (!__any_sync(FULL_MASK, act)) break;
    const bool left = __any_sync(FULL_MASK, more);
#pragma unroll 1
    for (;;) {
      if (act) {
        status = gen_ray_trip<RATIO>(p, a, rounds);
        if (status != STATUS_TRACING) {
          act = false;
          fin = true;
        }
      }
      const unsigned am = __ballot_sync(FULL_MASK, act);
      if (am == 0u || (left && __popc(am) <= GEN_REFILL_AT)) break;
    }
  }
}

// Traces the rays (record, detector) of the CTA's queue
// (wavefront.intensity_estimate): its threads pull them from q.next
// (gen_pull).  Every thread of the CTA calls it, after the lane loop's
// barrier.  Not inlined: its registers stay out of the event loop's.
static __device__ __noinline__ void gen_flush(const GeneralParams& p, int* __restrict__ iv,
                                              GenQueue& q, bool bern) {
  const int n = q.n;
  if (n > 0 && threadIdx.x == 0 && p.flushes) atomicAdd(p.flushes, 1ull);
  if (p.est == EST_RATIO) gen_pull<true>(p, iv, n, &q.next, bern);
  else gen_pull<false>(p, iv, n, &q.next, bern);
}

// One event_step (wavefront.py:1144-1540, the inline branch), for a live
// lane: lane and event j of the block key the estimate's draws (DET).
template <int MODE, bool UNI, bool REFL, bool BERN, bool DET>
__device__ __forceinline__ void general_event(const GeneralParams& p, const float (&u)[GEN_MAX_DRAWS],
                                              GLane& s, int lane, int j, GenQueue* q) {
  const Grid& g = p.fine;
  // The draws' slots are constants of the instantiation: a draw it does not
  // read is not held over the DDA, and no select chain picks it.
  constexpr int DA = slot_accept(MODE), DS = slot_srf(MODE, REFL), DC = slot_comp(MODE, UNI, REFL),
                DX = slot_extra(MODE, UNI, REFL);
#define DRAW(k) u[(k) < 0 ? 0 : (k)]
  const float tau = exponential_deviate(u[0]);
  float rx = s.x, ry = s.y, rz = s.z;
  int rix = s.ix, riy = s.iy, riz = s.iz;
  bool exit_top, exit_bot, collide, bad = false;
  float inv_maj = 0.0f;
  if (MODE == MODE_MAX) {
    // Maximum cross-section jump (:492-497); exits placed on the boundary
    // plane from the lane's position for the tally column (:504-527; the
    // jump's end loses x and y when the majorant is near 0).
    const float step = tau * p.inv_max_ext;
    const float px = s.x + s.ux * step, py = s.y + s.uy * step, pz = s.z + s.uz * step;
    exit_top = pz >= g.z_max;
    exit_bot = !exit_top && pz <= g.z0;
    collide = !exit_top && !exit_bot;
    const float safe_uz = fabsf(s.uz) > EXT_EPS_F ? s.uz : 1.0f;
    const float dist = fabsf(exit_top ? (g.z_max - s.z) / safe_uz : (g.z0 - s.z) / safe_uz);
    const bool hit = exit_top || exit_bot;
    rx = wrap_periodic(hit ? s.x + s.ux * dist : px, g.x0, g.x_max, g.wx);
    ry = wrap_periodic(hit ? s.y + s.uy * dist : py, g.y0, g.y_max, g.wy);
    rz = exit_top ? g.z_max : (exit_bot ? g.z0 : pz);
  } else {
    int status;
    if (MODE == MODE_RT) {
      status = trace_extinction(g, p.total_ext, rx, ry, rz, rix, riy, riz, s.ux, s.uy, s.uz,
                                tau, p.max_crossings, s.xing);
    } else {
      const Grid& c = p.coarse;
      int bx = locate(s.x, c.x0, c.dx, c.xe, c.nx, c.xy_regular);
      int by = locate(s.y, c.y0, c.dy, c.ye, c.ny, c.xy_regular);
      int bz = locate(s.z, c.z0, c.dz, c.ze, c.nz, c.z_regular);
      status = trace_extinction(c, p.majorant, rx, ry, rz, bx, by, bz, s.ux, s.uy, s.uz, tau,
                                p.max_crossings, s.xing);
      const float maj = __ldg(p.majorant + (bx * c.ny + by) * c.nz + bz);
      inv_maj = 1.0f / fmaxf(maj, EXT_EPS_F);
    }
    exit_top = status == STATUS_EXIT_TOP;
    exit_bot = status == STATUS_EXIT_BOT;
    collide = status == STATUS_SCATTER;
    bad = status == STATUS_BAD;
  }
  if (MODE != MODE_RT) {
    rix = locate(rx, g.x0, g.dx, g.xe, g.nx, g.xy_regular);
    riy = locate(ry, g.y0, g.dy, g.ye, g.ny, g.xy_regular);
    riz = locate(rz, g.z0, g.dz, g.ze, g.nz, g.z_regular);
  }
  const int flat = (rix * g.ny + riy) * g.nz + riz;
  const int col = rix * g.ny + riy;

  // The cell's optics, read by collisions only: the extinction (and the
  // acceptance), the component pick, co-albedo and phase index.
  bool physical = false;
  int comp = 0, pf = p.uniform_pf;
  float coalb = p.uniform_coalb;
  if (collide) {
    const float* row = p.cell + (size_t)flat * (1 + 3 * p.n_comp);
    const float ce = UNI ? __ldg(p.total_ext + flat) : __ldg(row);
    if (MODE == MODE_RT) physical = true;
    else if (MODE == MODE_WOOD) physical = DRAW(DA) < ce * inv_maj;
    else physical = DRAW(DA) < ce * p.inv_max_ext;
    if (!UNI && physical) {
      const float uc = DRAW(DC);
      for (int k = 0; k < p.n_comp; ++k) comp += uc >= __ldg(row + 1 + k) ? 1 : 0;
      comp = min(max(comp, 0), p.n_comp - 1);
      coalb = __ldg(row + 1 + p.n_comp + comp);
      pf = (int)__ldg(row + 1 + 2 * p.n_comp + comp);
    }
  }

  // The surface (:1315-1330): the weight times R, a cosine-weighted direction.
  bool surf_alive = false;
  float w_srf = 0.0f;
  if (REFL && exit_bot) {
    const float mu_s = fmaxf(sqrtf(DRAW(DS)), EPS6_F);
    const float phi_s = TWO_PI_F * DRAW(DS + 1);
    const float refl = surface_reflectance(p, rx, ry, s.uz, mu_s, atan2f(s.uy, s.ux), phi_s);
    w_srf = s.w * refl;
    surf_alive = w_srf > TINY_F;
  }

  // Absorption and the tallies.
  float w_sc;
  int order_next;
  if (BERN) {
    const bool died = physical && p.absorbing && DRAW(DX) >= p.ssa;
    w_sc = died ? 0.0f : s.w;
    order_next = s.order + (physical ? 1 : 0);
    if (died) tally_add(p.columns + (size_t)col * 3 + 2, 1.0);
  } else {
    const float absorbed = s.w * coalb;
    w_sc = s.w * (1.0f - coalb);
    order_next = s.order + ((physical || exit_bot) ? 1 : 0);
    if (physical && absorbed != 0.0f) {
      tally_add(p.columns + (size_t)col * 3 + 2, (double)absorbed);
      if (p.vol) tally_add(p.vol + flat, (double)absorbed);
    }
  }
  if (exit_top) tally_add(p.columns + (size_t)col * 3 + 0, (double)s.w);
  if (exit_bot) tally_add(p.columns + (size_t)col * 3 + 1, (double)s.w);
  const bool math_move = MODE != MODE_RT && collide && !physical;

  // The local estimate (:1487-1497), before the roulette and the rotation:
  // its record, traced by the CTA after its lanes' events.
  if (DET) {
    const bool brdf = REFL && p.srf_kind > SURFACE_ALBEDO;
    if (physical || (brdf ? exit_bot : surf_alive))
      gen_push(p, *q, lane, j, exit_bot, rx, ry, rz, rix, riy, riz, s.ux, s.uy, s.uz,
               exit_bot ? (brdf ? s.w : w_srf) : w_sc, comp, pf, order_next);
  }

  // Russian roulette (:1499-1505).
  if (!BERN && p.rr && physical && w_sc < p.rr_half)
    w_sc = (DRAW(DX) >= w_sc / p.rr_w) ? 0.0f : p.rr_w;
  const bool scat_alive = physical && w_sc > TINY_F;

  // The scattering angle from the cubic inverse CDF, and the rotation.
  if (scat_alive) {
    const int S = p.n_segments;
    const float pos = fminf(fmaxf(u[1], 0.0f), 1.0f) * (float)S;
    const int seg = min(max((int)pos, 0), S - 1);
    const float t = pos - (float)seg;
    const float4 c = __ldg(p.cubic + ((comp * p.max_entries + pf) * S + seg));
    const float mu = fminf(fmaxf(((c.w * t + c.z) * t + c.y) * t + c.x, -1.0f), 1.0f);
    float nx, ny, nz;
    rotate_direction(s.ux, s.uy, s.uz, mu, u[2], &nx, &ny, &nz);
    const float norm = rsqrtf(fmaxf(nx * nx + ny * ny + nz * nz, EPS12_F));
    s.ux = nx * norm;
    s.uy = ny * norm;
    s.uz = nz * norm;
  } else if (surf_alive) {
    // The reflected direction, from the surface's draws again here: its
    // three values are not held over the estimate and the roulette.
    const float mu_s = fmaxf(sqrtf(DRAW(DS)), EPS6_F);
    const float phi_s = TWO_PI_F * DRAW(DS + 1);
    const float sin_t = sqrtf(fmaxf(1.0f - mu_s * mu_s, 0.0f));
    s.ux = sin_t * cosf(phi_s);
    s.uy = sin_t * sinf(phi_s);
    s.uz = mu_s;
  }
  const bool over = (scat_alive || surf_alive) && order_next >= p.max_events;
  const bool moved = scat_alive || surf_alive || math_move;
  if (moved) {
    s.x = rx;
    s.y = ry;
    s.z = surf_alive ? g.z0 : rz;
    if (MODE == MODE_RT) {
      s.ix = rix;
      s.iy = riy;
      s.iz = surf_alive ? 0 : riz;
    }
  }
  if (physical) s.w = w_sc;
  else if (exit_bot) s.w = w_srf;
  s.order = order_next;
  s.alive = (moved && !over) ? 1 : 0;
  s.bad += (bad || over) ? 1 : 0;
  s.evct += (exit_top || exit_bot || collide) ? 1 : 0;
#undef DRAW
}

// The key bucket of a live lane in ray tracing (kernels/general_block.py
// lane_keys): the extinction e of its cell, r = e * (inv_max_ext * (1 +
// 2^-10)) (the factor lifts the largest e, whose r may round below 1, into
// bucket 0), bucket min(-floor(log2 r), GEN_KEY_BUCKETS - 1) from r's float32
// exponent (r = 0 and subnormals land in the last).  A thick cell's free
// path crosses few cells, a thin one's many.
__device__ __forceinline__ int rt_bucket(const GeneralParams& p, const int* iv, int lane) {
  const size_t L = (size_t)p.n_lanes;
  const Grid& g = p.fine;
  const int flat = (iv[L + lane] * g.ny + iv[2 * L + lane]) * g.nz + iv[3 * L + lane];
  const float e = __ldg(p.total_ext + min(max(flat, 0), g.nx * g.ny * g.nz - 1));
  const float scale = p.inv_max_ext * 0x1.004p+0f;
  const int exponent = (int)((__float_as_uint(e * scale) >> 23) & 0xffu) - 127;
  return min(max(-exponent, 0), GEN_KEY_BUCKETS - 1);
}

// A CTA's work: T consecutive tiles of CTA_THREADS lanes, whose per-tile
// dead counts are the FIFO ranks' unit as before.  Every CTA computes the
// same T from the launch's expected density; CTA c runs the tiles [c, c +
// T) when T divides c and returns at once otherwise.  Shared memory of the
// prologue and the exit count.
struct GenShared {
  int live_ids[GEN_MAX_TILES * CTA_THREADS];   // the CTA's live lanes, in run order
  int dead_cnt[GEN_MAX_TILES][CTA_WARPS];      // dead lanes at entry per (tile, warp)
  int live_cnt[GEN_MAX_TILES][CTA_WARPS];      // live lanes after the refill per (tile, warp)
  int tile_alive[GEN_MAX_TILES];               // lanes alive at exit per tile
  int below[CTA_WARPS];                        // dead lanes in the tiles below the CTA's
  int sample[CTA_WARPS];                       // sampled dead counts
  int bucket_cnt[CTA_WARPS][GEN_KEY_BUCKETS];  // live lanes per (warp, key bucket), T = 1
  int tiles;                                   // T
  int n_live;                                  // live lanes after the refill
  int next_chunk;                              // the next chunk of 32 live lanes to run
};

// The block's prologue for the CTA (see the header).  First T, the same in
// every CTA: about CTA_THREADS live lanes a working CTA after the refill,
// T = n_lanes / n_live clipped to [1, GEN_MAX_TILES], n_live estimated from
// the last launch's dead counts of up to CTA_THREADS tiles spread over the
// grid (each thread reads one) and the refill's share of the budget.  T
// changes which thread runs a lane, never what the lane computes.  Then,
// for a working CTA's tiles [tile0, tile0 + nt): the FIFO rank, the loop's
// control state, a fresh photon in each dead lane that the budget still
// covers, and the compaction: the live lanes' ids, tile by tile and in lane
// order within a tile, onto sh.live_ids[0, sh.n_live); in ray tracing with
// one tile (rt), ordered by the key bucket of the lane's cell
// (rt_bucket) and by lane id within a bucket.  Returns nt, 0 for a CTA
// that does not work.  Every thread of the CTA calls it.  Not inlined: its
// registers stay out of the event loop's.
static __device__ __noinline__ int general_prologue(const GeneralParams& p, float* f, int* iv,
                                                   bool rt, GenShared& sh) {
  const int t = threadIdx.x, warp = t >> 5, wl = t & 31;
  const unsigned below_me = (1u << wl) - 1u;
  const size_t L = (size_t)p.n_lanes;
  const int n_tiles = (p.n_lanes + CTA_THREADS - 1) / CTA_THREADS;
  const int tile0 = blockIdx.x;
  const long long launched = p.ctl[p.kb & 1u];
  const int* dead_in = p.dead + (size_t)(p.kb & 1u) * n_tiles;
  // The first tile's alive flag and the density sample, read together.
  const int lane0 = tile0 * CTA_THREADS + t;
  const int first_alive = lane0 < p.n_lanes ? iv[lane0] : 0;
  const int n_sample = min(n_tiles, CTA_THREADS);
  int d = t < n_sample ? dead_in[(int)(((long long)t * n_tiles) / n_sample)] : 0;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) d += __shfl_xor_sync(FULL_MASK, d, o);
  if (wl == 0) sh.sample[warp] = d;
  __syncthreads();
  if (t == 0) {
    long long sampled = 0;
#pragma unroll
    for (int w = 0; w < CTA_WARPS; ++w) sampled += sh.sample[w];
    const long long dead = sampled * n_tiles / n_sample;
    const long long room = p.n_photons - launched;
    const long long refill = room > 0 ? (dead < room ? dead : room) : 0;
    const long long live = (long long)p.n_lanes - dead + refill;
    const long long tiles = live > 0 ? (long long)p.n_lanes / live : GEN_MAX_TILES;
    sh.tiles = (int)(tiles < 1 ? 1 : (tiles > GEN_MAX_TILES ? GEN_MAX_TILES : tiles));
  }
  __syncthreads();
  if (tile0 % sh.tiles != 0) return 0;
  const int nt = min(sh.tiles, n_tiles - tile0);
  const bool last = tile0 + nt == n_tiles;
  const bool budget = launched < p.n_photons;
  if (t < GEN_MAX_TILES) sh.tile_alive[t] = 0;
  if (t == 0) sh.next_chunk = 0;
  // The alive flags of the thread's slot in each tile, one bit per tile.
  unsigned alive_bits = 0, range_bits = 0;
  for (int j = 0; j < nt; ++j) {
    const int lane = (tile0 + j) * CTA_THREADS + t;
    const bool in_range = lane < p.n_lanes;
    const bool a = in_range && (j == 0 ? first_alive : iv[lane]) != 0;
    alive_bits |= (a ? 1u : 0u) << j;
    range_bits |= (in_range ? 1u : 0u) << j;
    const unsigned dm = __ballot_sync(FULL_MASK, in_range && !a);
    if (wl == 0) sh.dead_cnt[j][warp] = __popc(dm);
  }
  // The dead lanes below the CTA's tiles, from the last launch's counts
  // (once the budget is spent only the last CTA needs them).
  int below = 0;
  if (budget || last) {
    for (int k = t; k < tile0; k += CTA_THREADS) below += dead_in[k];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) below += __shfl_xor_sync(FULL_MASK, below, o);
  }
  if (wl == 0) sh.below[warp] = below;
  __syncthreads();
  // Refill: the dead lane in slot t of tile j takes photon launched + its
  // rank among the grid's dead lanes.
  long long base = launched;
#pragma unroll
  for (int w = 0; w < CTA_WARPS; ++w) base += sh.below[w];
  for (int j = 0; j < nt; ++j) {
    int rank = 0, tile_dead = 0;
#pragma unroll
    for (int w = 0; w < CTA_WARPS; ++w) {
      const int c = sh.dead_cnt[j][w];
      rank += w < warp ? c : 0;
      tile_dead += c;
    }
    const bool dead = ((range_bits & ~alive_bits) >> j) & 1u;
    const unsigned dm = __ballot_sync(FULL_MASK, dead);
    rank += __popc(dm & below_me);
    if (dead && budget && base + rank < p.n_photons) {
      const int lane = (tile0 + j) * CTA_THREADS + t;
      float v[6];
      source_sample(p.src, p.kb, p.key0, p.key1, lane, v);
#pragma unroll
      for (int k = 0; k < 6; ++k) f[k * L + lane] = v[k];
      f[6 * L + lane] = 1.0f;
      iv[4 * L + lane] = 0;
      if (rt) {
        const Grid& g = p.fine;
        iv[1 * L + lane] = locate(v[0], g.x0, g.dx, g.xe, g.nx, g.xy_regular);
        iv[2 * L + lane] = locate(v[1], g.y0, g.dy, g.ye, g.ny, g.xy_regular);
        iv[3 * L + lane] = locate(v[2], g.z0, g.dz, g.ze, g.nz, g.z_regular);
      }
      iv[lane] = 1;
      alive_bits |= 1u << j;
    }
    base += tile_dead;
    const unsigned lm = __ballot_sync(FULL_MASK, (alive_bits >> j) & 1u);
    if (wl == 0) sh.live_cnt[j][warp] = __popc(lm);
  }
  if (last && t == 0) {
    // base - launched: the grid's dead lanes at entry.
    const long long total_dead = base - launched;
    const long long room = p.n_photons - launched;
    p.ctl[(p.kb + 1u) & 1u] = launched + (budget ? (total_dead < room ? total_dead : room) : 0);
    if (!budget && p.ctl[3] < 0) p.ctl[3] = (long long)p.kb;
    if (!budget && total_dead == (long long)p.n_lanes && p.ctl[2] < 0)
      p.ctl[2] = (long long)p.kb;
  }
  __syncthreads();
  if (rt && nt == 1) {
    // One tile in ray tracing: a counting sort of the live lanes by bucket.
    const int lane = tile0 * CTA_THREADS + t;
    const bool live = alive_bits & 1u;
    const int b = live ? rt_bucket(p, iv, lane) : 0;
    int rank = 0;
#pragma unroll
    for (int k = 0; k < GEN_KEY_BUCKETS; ++k) {
      const unsigned m = __ballot_sync(FULL_MASK, live && b == k);
      if (wl == 0) sh.bucket_cnt[warp][k] = __popc(m);
      if (b == k) rank = __popc(m & below_me);
    }
    __syncthreads();
    int n_live = 0;
#pragma unroll
    for (int w = 0; w < CTA_WARPS; ++w) {
#pragma unroll
      for (int k = 0; k < GEN_KEY_BUCKETS; ++k) {
        const int c = sh.bucket_cnt[w][k];
        n_live += c;
        rank += (k < b || (k == b && w < warp)) ? c : 0;
      }
    }
    if (live) sh.live_ids[rank] = lane;
    if (t == 0) sh.n_live = n_live;
    __syncthreads();
    return nt;
  }
  // Compaction: the slot of a live lane among the CTA's live lanes.
  int pos = 0;
  for (int j = 0; j < nt; ++j) {
    int before = 0, in_tile = 0;
#pragma unroll
    for (int w = 0; w < CTA_WARPS; ++w) {
      const int c = sh.live_cnt[j][w];
      before += w < warp ? c : 0;
      in_tile += c;
    }
    const bool live = (alive_bits >> j) & 1u;
    const unsigned lm = __ballot_sync(FULL_MASK, live);
    if (live) sh.live_ids[pos + before + __popc(lm & below_me)] = (tile0 + j) * CTA_THREADS + t;
    pos += in_tile;
  }
  if (t == 0) sh.n_live = pos;
  __syncthreads();
  return nt;
}

// One lane's K events: its state loaded, the events run (with detectors
// each estimate pushed to the CTA's queue), the state stored, and the lane
// counted in its tile's survivors.  Inlined at both of the kernel's call
// sites.
template <int MODE, bool UNI, bool REFL, bool BERN, bool DET>
__device__ __forceinline__ void general_lane(const GeneralParams& p, float* __restrict__ f,
                                             int* __restrict__ iv, int lane, GenShared& sh,
                                             GenQueue* q) {
  const size_t L = (size_t)p.n_lanes;
  GLane s;
  s.x = f[lane];
  s.y = f[L + lane];
  s.z = f[2 * L + lane];
  s.ux = f[3 * L + lane];
  s.uy = f[4 * L + lane];
  s.uz = f[5 * L + lane];
  s.w = f[6 * L + lane];
  s.alive = 1;
  s.ix = iv[L + lane];
  s.iy = iv[2 * L + lane];
  s.iz = iv[3 * L + lane];
  s.order = iv[4 * L + lane];
  s.bad = iv[5 * L + lane];
  s.evct = iv[6 * L + lane];
  s.xing = iv[7 * L + lane];
  const int G = (p.n_draws + 3) / 4;
#pragma unroll 1
  for (int j = 0; j < p.K && s.alive; ++j) {
    float u[GEN_MAX_DRAWS];
#pragma unroll
    for (int g = 0; g < GEN_MAX_DRAWS / 4; ++g) {
      uint32_t w4[4] = {0u, 0u, 0u, 0u};
      if (g < G)
        philox4x32_10((uint32_t)lane, p.kb, (uint32_t)(j * G + g), STREAM_EVENT, p.key0,
                      p.key1, w4);
#pragma unroll
      for (int q = 0; q < 4; ++q) u[4 * g + q] = to_unit(w4[q]);
    }
    general_event<MODE, UNI, REFL, BERN, DET>(p, u, s, lane, j, q);
  }
  // The stores' addresses formed from a lane the compiler cannot see
  // through: it would otherwise keep the loads' 15 row addresses over the
  // events, which under 64 registers spills them (24-72 B, ptxas of the
  // H100 build).
  asm volatile("" : "+r"(lane));
  f[lane] = s.x;
  f[L + lane] = s.y;
  f[2 * L + lane] = s.z;
  f[3 * L + lane] = s.ux;
  f[4 * L + lane] = s.uy;
  f[5 * L + lane] = s.uz;
  f[6 * L + lane] = s.w;
  iv[lane] = s.alive;
  iv[L + lane] = s.ix;
  iv[2 * L + lane] = s.iy;
  iv[3 * L + lane] = s.iz;
  iv[4 * L + lane] = s.order;
  iv[5 * L + lane] = s.bad;
  iv[6 * L + lane] = s.evct;
  iv[7 * L + lane] = s.xing;
  if (s.alive) atomicAdd(&sh.tile_alive[lane / CTA_THREADS - (int)blockIdx.x], 1);
}

// State layout (kernels/general_block.py GeneralState), updated in place:
//   f: (7, L) float32 rows x, y, z, ux, uy, uz, w
//   i: (8, L) int32   rows alive, ix, iy, iz, order, bad, evct, xing (DDA steps)
// One CTA per tile.  After the prologue a working CTA runs its list's live
// lanes through their K events: with one tile (T = 1, at most CTA_THREADS
// live lanes) thread t runs lane t of the list; with more, each warp takes
// the next chunk of 32 live lanes from a shared counter until none is left
// (about one a warp: T is chosen so).  Two call sites of general_lane: the
// loop's registers stay out of the dense blocks' code.  The refill's stores
// of a revived lane reach the thread that runs it through the prologue's
// __syncthreads.  4 CTAs per SM: without the bound the ray-tracing
// instantiations over a reflecting surface take 73-79 registers since the
// lanes are compacted (3 CTAs); with it every one takes <= 64 registers.
// The flux set spills nothing (the draws' slots are constants, the stores'
// addresses are formed at the stores); the DET set 0-20 B, in its flush.
// chip_smoke.py phase 2 reads each from ptxas.  With detectors the CTA
// then traces its ray queue (gen_flush).
template <int MODE, bool UNI, bool REFL, bool BERN, bool DET>
__global__ void __launch_bounds__(CTA_THREADS, GEN_CTAS_PER_SM)
general_event_block_kernel(float* __restrict__ f, int* __restrict__ iv,
                           const __grid_constant__ GeneralParams p) {
  __shared__ GenShared sh;
  __shared__ typename std::conditional<DET, GenQueue, char>::type q;   // the ray queue's counts
  const int t = threadIdx.x, wl = t & 31;
  GenQueue* qp = nullptr;
  if constexpr (DET) {
    if (t == 0) q.n = q.next = 0;        // seen after the prologue's barriers
    qp = &q;
  }
  if (general_prologue(p, f, iv, MODE == MODE_RT, sh) == 0) return;
  // n_live, T and the CTA's tiles are read from shared memory and the
  // parameters where they are used: no register holds them over the events.
  if (sh.tiles == 1) {
    if (t < sh.n_live) general_lane<MODE, UNI, REFL, BERN, DET>(p, f, iv, sh.live_ids[t], sh, qp);
  } else {
#pragma unroll 1
    for (;;) {
      int chunk = 0;
      if (wl == 0) chunk = atomicAdd(&sh.next_chunk, 1);
      chunk = __shfl_sync(FULL_MASK, chunk, 0);
      if (chunk * 32 >= sh.n_live) break;
      const int k = chunk * 32 + wl;
      if (k < sh.n_live)
        general_lane<MODE, UNI, REFL, BERN, DET>(p, f, iv, sh.live_ids[k], sh, qp);
    }
  }
  __syncthreads();
  // The estimates' rays, traced by every thread of the CTA (idle and dead
  // lanes' threads too); the lanes' rows they add to are stored.
  if constexpr (DET) gen_flush(p, iv, q, BERN);
  const int n_tiles = (p.n_lanes + CTA_THREADS - 1) / CTA_THREADS;
  if ((int)threadIdx.x < min(sh.tiles, n_tiles - (int)blockIdx.x)) {
    // Each tile's dead lanes at exit: the next launch's FIFO ranks.
    const int tile = blockIdx.x + threadIdx.x;
    const int n_here = min(CTA_THREADS, p.n_lanes - tile * CTA_THREADS);
    p.dead[(size_t)((p.kb + 1u) & 1u) * n_tiles + tile] = n_here - sh.tile_alive[threadIdx.x];
  }
}
