// Fast event block, the variants without the gas channel, the surface stage
// that follows a block over a reflecting surface, and the C interface of the
// library (see fast_event_block.cuh for the kernel: the Hopper port of the
// Pallas kernel `_build_pallas_block`, i3rc_tpu/integrators/fastpath.py:665).

#include "fast_event_block.cuh"

// The surface stage of a block over a reflecting surface: one launch after
// the event kernel's, on its stream, over the same CTA_THREADS-lane tiles,
// one thread per lane (fastpath.py:1871-1981, and the flush of
// :1735-1778 for this block's exits).  Each thread with a pending exit
// (pk != 0) of its lane:
//  * tallies it at the frozen position with the lane's weight (1 but on a
//    BRDF plan): columns[col, pk - 1], and for a kind-3 death with the
//    volume tally vol[col * n_z + iz];
//  * for a bottom hit (pk == 2) draws group 0 of STREAM_SURFACE at (lane,
//    kb): u0 the revive test, u1 the outgoing cosine mu_r = max(sqrt(u1),
//    1e-6), u2 the azimuth.  The lane is revived when u0 < albedo, or under a
//    BRDF when u0 < min(R, 1), R = max(brdf(uz, mu_r, atan2(uy, ux),
//    2 pi u2), 0).  With detectors (p.srf.acc) each upward detector d gets
//    the surface radiance, from every hit under a BRDF (R(in -> d) / pi times
//    the pre-reflection weight), from the revived lanes of an albedo (1 /
//    pi), times exp(-tau) of the shadow ray from z0 + nudge_z (Iwabuchi as
//    for collisions: word d % 4 of group d / 4 of STREAM_SURFACE_IW).  A
//    revived lane takes the direction (sin_r cos, sin_r sin, mu_r) of
//    azimuth 2 pi u2, z = z0 + nudge_z, orders + 1, its weight times
//    max(R, 1), and is alive; it keeps tau and tgas;
//  * clears pk; a lane that stays dead gets weight 1 for its refill.
// Then the CTA's dead count replaces the one the event kernel left for the
// next launch's FIFO rank: a revived lane counts alive, so `launched` skips
// no photon id, and the loop's end sees it.  (On the TPU the bounce came at
// the next block's flush, after the counts; the law is the same: there too
// a hit lane idled for the rest of its block.)  Every exit of a reflecting
// plan is tallied here, so the next prologue finds none pending.
//
// On a fused-k plan (FK) every tally takes the lane's k weight w_k n_photons /
// quota_k (a CTA holds one k), the surface's shadow rays add the lane's whole
// gas column, Gz(z_max) of its k over dz_d, and a revived lane restarts at
// gcur = 0, Gz of the surface (fastpath.py:1931-1934, :1964-1965, :1979-1983).
//
// What bounds it, and the design (H100 runs, PERF.md section 6).  Split on
// the card (the stage as first written, an empty copy of it and a copy
// whose tallies add nothing): a launch of the 1024 CTAs costs 1.5 us;
// the tallies cost 4 us a launch on the glint row, 12 us on RPV and 30 us
// over an albedo, where each warp added each bin it held with one float64
// atomic to device memory, 8 warps x 1024 CTAs onto the same few
// addresses (the glint scene has one column; the step cloud's 32 columns
// still take a few hundred adds each); the rest is the bounce, the BRDF of
// each hit and, per upward detector, its BRDF and shadow ray.  So each CTA
// now sums its exits and its surface radiance in shared memory first
// (warp_red<true>: the warp's lanes of a bin summed by shuffles, one
// shared-memory add per warp and bin) and adds each nonzero bin to device
// memory once, while the histograms have at most SRF_SMEM_BINS bins
// (Landsat's 32768 flux bins go straight to device memory as before).
// Folding the stage into the event kernel (a second set of 232
// instantiations, the stage run from the registers of the thread that ran
// the lane) measured faster where hits are sparse and slower where nearly
// every lane hits (the glint row 41.9 ms a batch against 37.0, the scan
// 23.2 against 20.7): it raised K1's registers from 48 to 64 (4 CTAs per SM
// for 5), put the bounce's latency on the event kernel's tail, and
// doubled the first-use build.  The launch of its own leaves the event
// kernels as they were.
//
// A plan with the marching shadow trace (MARCH, never FK) takes the stage of
// its own below, S-M (fast_event_block_surface_kernel_march), whose surface
// rays march; the stage above carries no marching loop.
#define SRF_SMEM_BINS 1024

template <bool FK>
__device__ __forceinline__ void surface_stage(float* __restrict__ f, int* __restrict__ iv,
                                              int smem_flags, const EventParams& p) {
  extern __shared__ double srf_hist[];
  __shared__ int n_alive;
  const int t = threadIdx.x, wl = t & 31;
  const int lane = blockIdx.x * CTA_THREADS + t;
  const size_t L = (size_t)p.n_lanes;
  const SurfaceParams& sp = p.srf;
  const DetParams& q = p.det;
  const Prologue& pr = p.pro;
  // The CTA's histograms: the flux columns (smem_flags & 1), then the surface
  // radiance (smem_flags & 2).
  const int n_fbins = pr.n_kinds * p.n_x * (pr.col_y ? p.n_y : 1);
  double* cols = (smem_flags & 1) ? srf_hist : nullptr;
  double* rad = (smem_flags & 2) ? srf_hist + ((smem_flags & 1) ? n_fbins : 0) : nullptr;
  const int n_hist = ((smem_flags & 1) ? n_fbins : 0) + ((smem_flags & 2) ? q.n_bins : 0);
  for (int k = t; k < n_hist; k += CTA_THREADS) srf_hist[k] = 0.0;
  if (t == 0) n_alive = 0;
  __syncthreads();
  const bool in_range = lane < p.n_lanes;
  const int pk = in_range ? iv[2 * L + lane] : 0;
  const bool hit = pk == 2, brdf = sp.kind != SURFACE_ALBEDO;
  float x = 0.0f, y = 0.0f, ux = 0.0f, uy = 0.0f, uz = 0.0f, w = 1.0f;
  float u0 = 1.0f, u1 = 0.0f, u2 = 0.0f;
  int key = -1;
  // FK: the CTA's k, its tally weight and gas column.
  const int k = FK ? p.fk.cta_k[blockIdx.x] : 0;
  const float wk = FK ? p.fk.w[k] : 1.0f;
  if (pk != 0) {
    x = f[lane];
    y = f[L + lane];
    if (sp.w) w = sp.w[lane];
    int c = min(max((int)((x - p.x0) * p.inv_dx), 0), p.n_x - 1);
    if (pr.col_y) c = c * p.n_y + min(max((int)((y - p.y0) * p.inv_dy), 0), p.n_y - 1);
    if (pk <= pr.n_kinds) key = c * pr.n_kinds + pk - 1;
    if (pr.vol_on && pk == 3) {
      const int iz = min(max((int)((f[2 * L + lane] - p.z0) * pr.inv_dz_cell), 0), pr.n_z - 1);
      tally_add(pr.vol + (size_t)c * pr.n_z + iz, FK ? (double)w * (double)wk : (double)w);
    }
  }
  const double wv = FK ? (double)w * (double)wk : (double)w;
  if (cols) warp_red<true>(cols, key, wv);
  else warp_red<false>(pr.columns, key, wv);
  if (hit) {
    ux = f[3 * L + lane];
    uy = f[4 * L + lane];
    uz = f[5 * L + lane];
    uint32_t r[4];
    philox4x32_10((uint32_t)lane, p.kb, 0u, STREAM_SURFACE, p.key0, p.key1, r);
    u0 = to_unit(r[0]);
    u1 = to_unit(r[1]);
    u2 = to_unit(r[2]);
  }
  const float mu_r = fmaxf(sqrtf(u1), EPS6_F);
  const float sin_r = sqrtf(fmaxf(1.0f - u1, 0.0f));
  float phi_in = 0.0f, refl = 0.0f;
  if (brdf && hit) {
    phi_in = atan2f(uy, ux);
    refl = fmaxf(brdf_reflectance(sp, uz, mu_r, phi_in, TWO_PI_F * u2), 0.0f);
  }
  const bool revive = hit && u0 < (brdf ? fminf(refl, 1.0f) : sp.albedo);
  const bool emit = brdf ? hit : revive;
  if (sp.acc != nullptr && __any_sync(FULL_MASK, emit)) {
    const float zs = p.z0 + p.nudge_z;
    uint32_t r[4] = {0u, 0u, 0u, 0u};
    int have = -1;
#pragma unroll 1
    for (int d = 0; d < q.n; ++d) {
      if (!(q.dz[d] > 0.0f)) continue;      // a surface emits upward only
      float c = 0.0f;
      int bin = -1;
      if (emit) {
        int col;
        float tau = shadow_closed(p, d, x, y, zs, &col);
        if (FK) tau = tau + p.fk.gtop[k] * q.inv_dz[d];
        const float npf = brdf
            ? fmaxf(brdf_reflectance(sp, uz, q.dz[d], phi_in, sp.det_phi[d]), 0.0f) * INV_PI_F
            : INV_PI_F;
        if (sp.iw) {
          if ((d >> 2) != have) {
            have = d >> 2;
            philox4x32_10((uint32_t)lane, p.kb, (uint32_t)have, STREAM_SURFACE_IW, p.key0,
                          p.key1, r);
          }
          c = iwabuchi(q, npf, tau, to_unit(r[d & 3]));
        } else {
          c = npf * expf(-tau);
        }
        c = c * w;                           // the pre-reflection weight
        if (FK) c = c * wk;
        bin = col * q.n + d;
      }
      if (rad) warp_red<true>(rad, c != 0.0f ? bin : -1, (double)c);
      else warp_red<false>(sp.acc, c != 0.0f ? bin : -1, (double)c);
    }
  }
  if (revive) {
    float sin_az, cos_az;
    sincos_2pi(u2, &sin_az, &cos_az);
    f[2 * L + lane] = p.z0 + p.nudge_z;
    f[3 * L + lane] = sin_r * cos_az;
    f[4 * L + lane] = sin_r * sin_az;
    f[5 * L + lane] = mu_r;
    iv[L + lane] += 1;
    iv[lane] = 1;
    if (FK) f[8 * L + lane] = 0.0f;
    if (sp.w) sp.w[lane] = w * fmaxf(refl, 1.0f);
  } else if (pk != 0 && sp.w) {
    sp.w[lane] = 1.0f;
  }
  if (pk != 0) iv[2 * L + lane] = 0;
  const int alive = in_range && iv[lane] != 0;
  const int n_warp = __popc(__ballot_sync(FULL_MASK, alive));
  if (wl == 0 && n_warp) atomicAdd(&n_alive, n_warp);
  __syncthreads();
  if (t == 0) {
    const int n_here = min(CTA_THREADS, p.n_lanes - (int)blockIdx.x * CTA_THREADS);
    pr.dead[(size_t)((p.kb + 1u) & 1u) * gridDim.x + blockIdx.x] = n_here - n_alive;
  }
  // One global add per nonzero bin of the CTA's histograms.
  if (cols)
    for (int b = t; b < n_fbins; b += CTA_THREADS)
      if (cols[b] != 0.0) tally_add(pr.columns + b, cols[b]);
  if (rad)
    for (int b = t; b < q.n_bins; b += CTA_THREADS)
      if (rad[b] != 0.0) tally_add(sp.acc + b, rad[b]);
}

template <bool FK>
__global__ void __launch_bounds__(CTA_THREADS)
fast_event_block_surface_kernel(float* __restrict__ f, int* __restrict__ iv, int smem_flags,
                                const __grid_constant__ EventParams p) {
  surface_stage<FK>(f, iv, smem_flags, p);
}

// S-M, the surface stage of a plan with the marching shadow trace (K3-M+S):
// the same law as the stage above (fastpath.py:1871-1981; the shadow ray of
// the surface radiance is the marching trace of fastpath.py:1061-1127,
// march_step), in another design.
//
// What bounded the first design (the stage above with each hit's shadow ray
// marched by its own thread in a __noinline__ loop; H100 runs, PERF.md
// section 6): over RPV, 1% of the lanes hit the bottom in a block, ~2.7 hits
// a 256-lane tile.  Its 4096 CTAs of one tile each ran a serial chain (zero
// the histograms, the exits' tallies, a hit's Philox call and BRDF, then
// detector after detector the hit's marching ray on one thread while its
// warp waited, then the flush and the dead count) in ~7 waves: 4.17 ms a
// batch in 104 launches against a bound of 0.148 ms (bytes: every lane's
// pending-exit flag read once).  So, as K3-M's queue (march_push,
// march_flush) and the sharded SB do:
//  * a CTA takes a run of T tiles (T from the kernel's occupancy and the lane
//    count: one wave of CTAs, at most SM_MAX_TILES tiles a run; no CTA waits
//    on another, so the run is the CTA's index, not a ticket) and reads the
//    run's pending-exit flags at once, one load a tile a thread in flight
//    together; the exits are listed in shared memory;
//  * the CTA's threads take the listed exits, one a thread (a round of
//    CTA_THREADS at a time): each tallies its exit, and a bottom hit draws
//    its STREAM_SURFACE group, takes its revive test and BRDF R and writes
//    its revived lane, as the stage above does; an emitting hit (every hit
//    under a BRDF, a revived one over an albedo) pushes one record to the
//    CTA's queue in shared memory (its point, uz, incoming azimuth, the
//    pre-reflection weight read before the revive rewrites it, and its
//    lane);
//  * then the CTA's threads pull the queue's (record, upward detector) rays,
//    a warp refilling its idle threads when at most MARCH_REFILL_AT still
//    hold a ray (march_flush's loop).  A ray's start computes its BRDF value
//    toward its detector and its Iwabuchi word (word d % 4 of group d / 4 of
//    STREAM_SURFACE_IW at (lane, kb)), so the per-detector BRDFs spread
//    over the threads too; its end tallies into the CTA's radiance
//    histogram (warp_red).  When a round could overflow the queue, the CTA
//    traces it first and goes on;
//  * the dead count of each tile is the event kernel's, which it left for
//    the next launch, less the tile's revived lanes that were dead: the
//    flags of the lanes without an exit are not read again.
// Each contribution repeats the float32 arithmetic of the stage above, so
// the stage is bit-equal to the plain version (resolve_surface) in every
// lane row; only the order of the float64 sums changes.  The ray loop's
// counts go to p.ray_use (SRF_USE_*).  The stage keeps a launch of its own:
// folding S into the event kernel measured 1.11-1.13x slower (PERF.md).
// Measured beside it (a batch over RPV, one call; PERF.md section 6): each
// hit's per-detector BRDF values computed by its thread in the exit round
// (111 registers, 2 CTAs an SM) 1.34x slower; a converged pass over the
// queue's (record, detector) BRDF values before the ray loop, at 80
// registers, 1.23x slower with runs of 8 tiles, 0.98x with runs of 16 but
// 4 bytes spilled.  Held to 64 registers this design ran 7% faster but
// spilled 12-32 bytes around its BRDF call; at 3 CTAs an SM one wave holds
// 396 CTAs, so a run takes up to 16 tiles (11 at 2^20 lanes).
#define SM_MAX_TILES 16         // tiles of CTA_THREADS lanes in a CTA's run, at most
#define SM_QUEUE 512            // emitting-hit records the CTA's queue holds

// The CTA's queue of emitting hits.
struct SrfQueue {
  float x[SM_QUEUE], y[SM_QUEUE], uz[SM_QUEUE], phi[SM_QUEUE], w[SM_QUEUE];
  int lane[SM_QUEUE];
};

// Traces the n = cnt[1] records of the queue toward the cnt[3] upward
// detectors ups[]: ray r is record r % n toward detector ups[r / n], dealt
// with one shared atomic on cnt[2] a warp, each ray stepped to the boundary
// or the budget (march_step), its contribution tallied where the warp meets
// to refill; wuse[0] and wuse[1] (the warp's, in shared memory) count its
// thread-steps and thread slots (32 a trip).  The counts are read from
// shared memory where they are used, so that they do not live across the
// BRDF call.  Called by every thread of the CTA after a barrier.
__device__ __forceinline__ void srf_flush(const EventParams& p, const SrfQueue& qu, int* cnt,
                                          const int* ups, double* rad, unsigned* wuse) {
  const SurfaceParams& sp = p.srf;
  const DetParams& q = p.det;
  const bool brdf = sp.kind != SURFACE_ALBEDO;
  const int wl = threadIdx.x & 31;
  float x = 0.0f, y = 0.0f, z = 0.0f, tau = 0.0f, npf = 0.0f, u_iw = 0.0f, w = 0.0f;
  int d = 0, k = 0, col = 0;
  // fin: the ray ended at the last trip, 2 if it reached the boundary.
  int fin = 0;
  bool act = false, more = cnt[1] * cnt[3] > 0;
#pragma unroll 1
  for (;;) {
    float c = 0.0f;
    if (fin == 2) {
      c = sp.iw ? iwabuchi(q, npf, tau, u_iw) : npf * expf(-tau);
      c = c * w;                             // the pre-reflection weight
    }
    const int bin = c != 0.0f ? col * q.n + d : -1;
    if (rad) warp_red<true>(rad, bin, (double)c);
    else warp_red<false>(sp.acc, bin, (double)c);
    fin = 0;
    const bool want = !act && more;
    const unsigned wm = __ballot_sync(FULL_MASK, want);
    if (wm) {
      const int lead = __ffs(wm) - 1;
      int r0 = 0;
      if (wl == lead) r0 = atomicAdd(cnt + 2, __popc(wm));
      r0 = __shfl_sync(FULL_MASK, r0, lead);
      if (want) {
        const int r = r0 + __popc(wm & ((1u << wl) - 1u));
        more = r < cnt[1] * cnt[3];
        if (more) {
          // The BRDF call first, the ray's registers set after it from r
          // alone, and the warp's counts in shared memory: the fewer values
          // live across the call, the fewer registers the kernel needs.
          if (brdf) {
            const int u = r / cnt[1], e = r - u * cnt[1];
            npf = fmaxf(brdf_reflectance(sp, qu.uz[e], q.dz[ups[u]], qu.phi[e],
                                         sp.det_phi[ups[u]]), 0.0f) * INV_PI_F;
          } else {
            npf = INV_PI_F;
          }
          const int u = r / cnt[1], e = r - u * cnt[1];
          d = ups[u];
          x = qu.x[e];
          y = qu.y[e];
          z = p.z0 + p.nudge_z;
          w = qu.w[e];
          tau = 0.0f;
          k = 0;
          col = 0;
          u_iw = 0.0f;
          if (sp.iw) {
            uint32_t b[4];
            philox4x32_10((uint32_t)qu.lane[e], p.kb, (uint32_t)(d >> 2), STREAM_SURFACE_IW,
                          p.key0, p.key1, b);
            const int m = d & 3;
            u_iw = to_unit(m == 0 ? b[0] : m == 1 ? b[1] : m == 2 ? b[2] : b[3]);
          }
          act = true;
        }
      }
    }
    if (!__any_sync(FULL_MASK, act)) break;
    const bool left = __any_sync(FULL_MASK, more);
#pragma unroll 1
    for (;;) {
      const int busy = __popc(__ballot_sync(FULL_MASK, act));
      if (wl == 0) {
        wuse[0] += busy;
        wuse[1] += 32;
      }
      if (act) {
        if (march_step(p, d, x, y, z, tau, col)) fin = 2;
        else if (++k >= q.march_steps) fin = 1;
        act = fin == 0;
      }
      const unsigned am = __ballot_sync(FULL_MASK, act);
      if (am == 0u || (left && __popc(am) <= MARCH_REFILL_AT)) break;
    }
  }
}

// At most 80 registers (3 CTAs an SM): held to 64 (4 CTAs), ptxas saved
// 12-32 bytes of the ray loop's registers around the BRDF call (spill
// stores; ptxas -v on the H100 machine's nvcc, PERF.md section 6).
__global__ void __launch_bounds__(CTA_THREADS, 3)
fast_event_block_surface_kernel_march(float* __restrict__ f, int* __restrict__ iv,
                                      int smem_flags, const __grid_constant__ EventParams p,
                                      int T) {
  extern __shared__ double srf_hist[];
  __shared__ int exits[SM_MAX_TILES * CTA_THREADS];   // run index | kind << 16
  __shared__ SrfQueue queue;
  __shared__ int revived[SM_MAX_TILES];               // revived lanes that were dead, a tile
  __shared__ int ups[MAX_DETECTORS];
  // Exits listed, records queued, next ray dealt, upward detectors, rays traced.
  __shared__ int cnt[5];
  __shared__ unsigned wuse[CTA_WARPS][2];              // a warp's ray-loop steps and slots
  const int t = threadIdx.x, wl = t & 31;
  const size_t L = (size_t)p.n_lanes;
  const int n_tiles = (p.n_lanes + CTA_THREADS - 1) / CTA_THREADS;
  const int tile0 = blockIdx.x * T;
  const SurfaceParams& sp = p.srf;
  const DetParams& q = p.det;
  const Prologue& pr = p.pro;
  const bool brdf = sp.kind != SURFACE_ALBEDO;
  const int n_fbins = pr.n_kinds * p.n_x * (pr.col_y ? p.n_y : 1);
  double* cols = (smem_flags & 1) ? srf_hist : nullptr;
  double* rad = (smem_flags & 2) ? srf_hist + ((smem_flags & 1) ? n_fbins : 0) : nullptr;
  const int n_hist = ((smem_flags & 1) ? n_fbins : 0) + ((smem_flags & 2) ? q.n_bins : 0);
  for (int k = t; k < n_hist; k += CTA_THREADS) srf_hist[k] = 0.0;
  if (t < SM_MAX_TILES) revived[t] = 0;
  if (t < 5) cnt[t] = 0;
  if (t < 2 * CTA_WARPS) wuse[t >> 1][t & 1] = 0u;
  if (t == 0 && sp.acc != nullptr) {
    int n = 0;
    for (int d = 0; d < q.n; ++d)
      if (q.dz[d] > 0.0f) ups[n++] = d;      // a surface emits upward only
    cnt[3] = n;
  }
  __syncthreads();

  // The run's pending exits: every tile's flags read at once, the exits
  // listed.
  int pk[SM_MAX_TILES];
#pragma unroll
  for (int j = 0; j < SM_MAX_TILES; ++j) {
    const int lane = (tile0 + j) * CTA_THREADS + t;
    pk[j] = (j < T && lane < p.n_lanes) ? iv[2 * L + lane] : 0;
  }
#pragma unroll
  for (int j = 0; j < SM_MAX_TILES; ++j) {
    const unsigned m = __ballot_sync(FULL_MASK, pk[j] != 0);
    if (m) {
      const int lead = __ffs(m) - 1;
      int base = 0;
      if (wl == lead) base = atomicAdd(cnt, __popc(m));
      base = __shfl_sync(FULL_MASK, base, lead);
      if (pk[j] != 0)
        exits[base + __popc(m & ((1u << wl) - 1u))] = (j * CTA_THREADS + t) | (pk[j] << 16);
    }
  }
  __syncthreads();
  const int n_ex = cnt[0], n_up = cnt[3];
  unsigned* own_use = wuse[t >> 5];

  // The exits, one a thread, a round of CTA_THREADS at a time.
  for (int e0 = 0; e0 < n_ex; e0 += CTA_THREADS) {
    const bool has = e0 + t < n_ex;
    const int e = has ? exits[e0 + t] : 0;
    const int kind = e >> 16, j = (e & 0xFFFF) / CTA_THREADS;
    const int lane = (tile0 + j) * CTA_THREADS + (e & (CTA_THREADS - 1));
    const bool hit = kind == 2;
    float x = 0.0f, y = 0.0f, ux = 0.0f, uy = 0.0f, uz = 0.0f, w = 1.0f;
    float u0 = 1.0f, u1 = 0.0f, u2 = 0.0f;
    int key = -1;
    if (has) {
      x = f[lane];
      y = f[L + lane];
      if (sp.w) w = sp.w[lane];
      int c = min(max((int)((x - p.x0) * p.inv_dx), 0), p.n_x - 1);
      if (pr.col_y) c = c * p.n_y + min(max((int)((y - p.y0) * p.inv_dy), 0), p.n_y - 1);
      if (kind <= pr.n_kinds) key = c * pr.n_kinds + kind - 1;
      if (pr.vol_on && kind == 3) {
        const int iz = min(max((int)((f[2 * L + lane] - p.z0) * pr.inv_dz_cell), 0),
                           pr.n_z - 1);
        tally_add(pr.vol + (size_t)c * pr.n_z + iz, (double)w);
      }
    }
    if (cols) warp_red<true>(cols, key, (double)w);
    else warp_red<false>(pr.columns, key, (double)w);
    if (hit) {
      ux = f[3 * L + lane];
      uy = f[4 * L + lane];
      uz = f[5 * L + lane];
      uint32_t r[4];
      philox4x32_10((uint32_t)lane, p.kb, 0u, STREAM_SURFACE, p.key0, p.key1, r);
      u0 = to_unit(r[0]);
      u1 = to_unit(r[1]);
      u2 = to_unit(r[2]);
    }
    const float mu_r = fmaxf(sqrtf(u1), EPS6_F);
    const float sin_r = sqrtf(fmaxf(1.0f - u1, 0.0f));
    float phi_in = 0.0f, refl = 0.0f;
    if (brdf && hit) {
      phi_in = atan2f(uy, ux);
      refl = fmaxf(brdf_reflectance(sp, uz, mu_r, phi_in, TWO_PI_F * u2), 0.0f);
    }
    const bool revive = hit && u0 < (brdf ? fminf(refl, 1.0f) : sp.albedo);
    const bool emit = n_up > 0 && (brdf ? hit : revive);
    const unsigned m = __ballot_sync(FULL_MASK, emit);
    if (m) {
      const int lead = __ffs(m) - 1;
      int base = 0;
      if (wl == lead) base = atomicAdd(cnt + 1, __popc(m));
      base = __shfl_sync(FULL_MASK, base, lead);
      if (emit) {
        const int s = base + __popc(m & ((1u << wl) - 1u));
        queue.x[s] = x;
        queue.y[s] = y;
        queue.uz[s] = uz;
        queue.phi[s] = phi_in;
        queue.w[s] = w;
        queue.lane[s] = lane;
      }
    }
    if (revive) {
      float sin_az, cos_az;
      sincos_2pi(u2, &sin_az, &cos_az);
      f[2 * L + lane] = p.z0 + p.nudge_z;
      f[3 * L + lane] = sin_r * cos_az;
      f[4 * L + lane] = sin_r * sin_az;
      f[5 * L + lane] = mu_r;
      iv[L + lane] += 1;
      if (iv[lane] == 0) atomicAdd(&revived[j], 1);
      iv[lane] = 1;
      if (sp.w) sp.w[lane] = w * fmaxf(refl, 1.0f);
    } else if (has && sp.w) {
      sp.w[lane] = 1.0f;
    }
    if (has) iv[2 * L + lane] = 0;
    __syncthreads();
    if (cnt[1] > SM_QUEUE - CTA_THREADS) {
      // The next round could overflow the queue: trace it first.
      srf_flush(p, queue, cnt, ups, rad, own_use);
      __syncthreads();
      if (t == 0) {
        cnt[4] += cnt[1] * n_up;
        cnt[1] = cnt[2] = 0;
      }
      __syncthreads();
    }
  }
  const int n_rec = cnt[1];
  if (n_rec > 0) srf_flush(p, queue, cnt, ups, rad, own_use);
  __syncthreads();
  // Each tile's dead count for the next launch's FIFO rank: the event
  // kernel's, less the tile's revived lanes that were dead.
  if (t < T && tile0 + t < n_tiles && revived[t])
    pr.dead[(size_t)((p.kb + 1u) & 1u) * n_tiles + tile0 + t] -= revived[t];
  if (t == 0 && p.ray_use) {
    unsigned long long steps = 0, slots = 0;
    for (int w = 0; w < CTA_WARPS; ++w) {
      steps += wuse[w][0];
      slots += wuse[w][1];
    }
    atomicAdd(p.ray_use + SRF_USE_RAYS, (unsigned long long)(cnt[4] + n_rec * n_up));
    atomicAdd(p.ray_use + SRF_USE_STEPS, steps);
    atomicAdd(p.ray_use + SRF_USE_SLOTS, slots);
    atomicAdd(p.ray_use + SRF_USE_RUNS, 1ull);
  }
  // One global add per nonzero bin of the CTA's histograms.
  if (cols)
    for (int b = t; b < n_fbins; b += CTA_THREADS)
      if (cols[b] != 0.0) tally_add(pr.columns + b, cols[b]);
  if (rad)
    for (int b = t; b < q.n_bins; b += CTA_THREADS)
      if (rad[b] != 0.0) tally_add(sp.acc + b, rad[b]);
}

// The stage's CTA histograms in dynamic shared memory while each has at most
// SRF_SMEM_BINS bins: their bytes, and in *flags which of the two (flux
// columns 1, surface radiance 2; n_rbins < 0: no surface radiance).
static size_t surface_smem(int n_fbins, int n_rbins, int* flags) {
  size_t smem = 0;
  *flags = 0;
  if (n_fbins <= SRF_SMEM_BINS) {
    *flags |= 1;
    smem += (size_t)n_fbins * sizeof(double);
  }
  if (n_rbins >= 0 && n_rbins <= SRF_SMEM_BINS) {
    *flags |= 2;
    smem += (size_t)n_rbins * sizeof(double);
  }
  return smem;
}

// S-M's run length T and grid for n_lanes lanes and smem bytes of
// histograms: one wave of CTAs (the kernel's occupancy, once a device and
// size), each a run of at most SM_MAX_TILES tiles; past that, more CTAs.
static cudaError_t surface_march_runs(int n_lanes, size_t smem, int* T, int* runs,
                                      int* wave_out) {
  static int wave_dev = -1, wave = 0;
  static size_t wave_smem = 0;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev != wave_dev || smem != wave_smem) {
    int per_sm = 0, sms = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, fast_event_block_surface_kernel_march, CTA_THREADS, smem);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return e;
    wave = per_sm * sms > 1 ? per_sm * sms : 1;
    wave_dev = dev;
    wave_smem = smem;
  }
  const int n_tiles = (n_lanes + CTA_THREADS - 1) / CTA_THREADS;
  const int fit = (n_tiles + wave - 1) / wave;
  *T = fit < SM_MAX_TILES ? fit : SM_MAX_TILES;
  *runs = (n_tiles + *T - 1) / *T;
  if (wave_out) *wave_out = wave;
  return cudaSuccess;
}

// The surface stage's launch after a block's (see the kernels).
static cudaError_t launch_surface(float* f, int* i, const EventParams& p, bool fk,
                                  cudaStream_t stream) {
  const int blocks = (p.n_lanes + CTA_THREADS - 1) / CTA_THREADS;
  int flags = 0;
  const size_t smem = surface_smem(p.pro.n_kinds * p.n_x * (p.pro.col_y ? p.n_y : 1),
                                   p.srf.acc != nullptr ? p.det.n_bins : -1, &flags);
  if (fk) {
    fast_event_block_surface_kernel<true><<<blocks, CTA_THREADS, smem, stream>>>(f, i, flags, p);
  } else if (p.det.march_steps > 0) {
    int T = 1, runs = blocks;
    const cudaError_t e = surface_march_runs(p.n_lanes, smem, &T, &runs, nullptr);
    if (e != cudaSuccess) return e;
    fast_event_block_surface_kernel_march<<<runs, CTA_THREADS, smem, stream>>>(f, i, flags, p,
                                                                               T);
  } else {
    fast_event_block_surface_kernel<false><<<blocks, CTA_THREADS, smem, stream>>>(f, i, flags, p);
  }
  return cudaSuccess;
}

extern "C" {

int i3rc_event_params_size(void) { return (int)sizeof(EventParams); }

int i3rc_cta_threads(void) { return CTA_THREADS; }

// Runs one block of params->K events in place on the given stream, after
// the block's prologue when params->pro.on; with detectors it adds their
// contributions to acc; with a column table (col not null) it runs the
// column variant; with a cubic table (params->cubic not null) the table
// variant; with fused-k tables (params->fk.tab not null) the fused-k variant
// of the gas one; with detectors and params->det.march_steps > 0 (no gas
// channel, no column table) the marching variant (K3-M); over a reflecting
// surface (params->srf.kind) with the prologue on, the surface stage follows
// on the stream.  Returns
// cudaGetLastError() after the launches (cudaErrorInvalidValue for an
// unsupported K, CHAIN, detector count, column, table or fused-k
// combination; the Python wrapper checks those first).
int i3rc_fast_event_block(float* f, int* i, double* acc, const float4* col,
                          const EventParams* params, int chain, int absorbing,
                          int track_y, int detectors, int iwabuchi, int gas, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const bool tab = params->cubic != nullptr;
  const bool fk = params->fk.tab != nullptr;
  if (tab && (params->n_seg < 1 || (detectors != 0) != (params->fwd != nullptr) ||
              (col != nullptr) != (params->pf_row != nullptr)))
    return (int)cudaErrorInvalidValue;
  bool ok;
  if (col != nullptr)
    ok = track_y && !detectors && !gas && !fk &&
         launch_block_col(f, i, col, *params, chain, absorbing, tab, st);
  else if (fk)
    ok = gas && (tab ? launch_block_tab_fk : launch_block_fk)(f, i, acc, *params, chain,
                                                               absorbing, track_y, detectors,
                                                               iwabuchi, st);
  else if (detectors && params->det.march_steps > 0)
    ok = !gas && chain == 0 &&
         (tab ? launch_block_tab_march : launch_block_march)(f, i, acc, *params, absorbing,
                                                             track_y, iwabuchi, st);
  else if (gas)
    ok = (tab ? launch_block_tab_gas : launch_block_gas)(f, i, acc, *params, chain, absorbing,
                                                         track_y, detectors, iwabuchi, st);
  else if (tab)
    ok = launch_block_tab(f, i, acc, *params, chain, absorbing, track_y, detectors, iwabuchi,
                          st);
  else
    ok = launch_block<false, false>(f, i, acc, *params, chain, absorbing, track_y, detectors,
                                    iwabuchi, st);
  if (!ok) return (int)cudaErrorInvalidValue;
  if (params->pro.on && params->srf.kind != SURFACE_BLACK) {
    const cudaError_t e = launch_surface(f, i, *params, fk, st);
    if (e != cudaSuccess) return (int)e;
  }
  return (int)cudaGetLastError();
}

// The marching surface stage's launch shape on the current device for
// n_lanes lanes, n_fbins flux bins and n_rbins surface-radiance bins (< 0:
// none): out[0] the tiles T of a CTA's run, out[1] the CTAs, out[2] the CTAs
// of one wave.  Returns a CUDA error code.
int i3rc_surface_march_runs(int n_lanes, int n_fbins, int n_rbins, int* out) {
  int flags = 0;
  return (int)surface_march_runs(n_lanes, surface_smem(n_fbins, n_rbins, &flags), out,
                                 out + 1, out + 2);
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Test entries: the kernel's Philox stream and BRDFs, exposed for checks
// against i3rc_tpu_torch/core/rng.py and core/surface.py.

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

__global__ void brdf_reflectance_kernel(float* out, const float* mu_in, const float* mu_out,
                                        const float* phi_in, const float* phi_out, int n,
                                        const SurfaceParams sp) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = brdf_reflectance(sp, mu_in[i], mu_out[i], phi_in[i], phi_out[i]);
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

// out[i] = R of the surface params->kind (a BRDF kind) at the angles of i,
// through the kernel's own brdf_reflectance.
int i3rc_brdf_reflectance(float* out, const float* mu_in, const float* mu_out,
                          const float* phi_in, const float* phi_out, int n,
                          const SurfaceParams* params, void* stream) {
  const int threads = 256;
  brdf_reflectance_kernel<<<(n + threads - 1) / threads, threads, 0, (cudaStream_t)stream>>>(
      out, mu_in, mu_out, phi_in, phi_out, n, *params);
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
