// Fast event block: K complete photon-transport events per lane, state in
// registers.  Hopper (sm_90a) port of the Pallas kernel `_build_pallas_block`
// (i3rc_tpu/integrators/fastpath.py:665, pallas_call at :783), whose body runs
// `fast_event` (fastpath.py:1291-1676), in its variants: flux (n_detectors =
// 0), radiance detectors (n_detectors = D > 0, the closed-form shadow trace,
// HG phase), and the gas channel (gas=True) of either; and the column-mode
// event of the XLA fastpath (fastpath.py:1320-1345, :1377-1379, :1607-1614)
// in the design of the TPU column-read probe `pallas_column_loop`
// (benchmarks/column_read_probe.py:83, pallas_call at :140): a K-event loop
// whose every event reads one row of the (n_cols, M) column table.  Each
// variant also comes as a table variant (TAB, the table modes of the XLA
// fastpath, fastpath.py:1573-1586, :1508-1520, :1330-1336; see the note
// below).  This header holds the device code and the kernel template;
// fast_event_block.cu instantiates the variants without the gas channel and
// holds the C interface, fast_event_block_gas.cu the gas variants,
// fast_event_block_tab.cu and fast_event_block_tab_gas.cu their table
// variants, fast_event_block_fk.cu and fast_event_block_tab_fk.cu the fused-k
// variants of the gas ones (FK, see the note below) and
// fast_event_block_col.cu the column variants of both kinds.  The seven files
// compile in parallel.
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
// XLA glue tallied; here the CTA tallies into float64 histograms in shared
// memory, one private (n_cols x D) slice per warp, and adds their per-bin sum
// to the global accumulator with one atomicAdd per nonzero bin at its end.
// Past 751 bins the warps share one CTA histogram (up to 6144 bins), and
// past that the global accumulator (hist_room).  The sum is the same; its
// order differs from the twin's index_add_.
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
// What bounds it: ALU work on live lanes.  Each event costs ceil(n_draws/4)
// Philox4x32-10 calls (10 rounds of two 32x32 multiplies each) plus the
// where-chains over the segment thresholds; device memory traffic is only
// 2 x 4 B x 11 arrays per lane per K events (one more each for y and tgas),
// read once and written once.  Every intermediate stays in registers and
// the segment tables come from the by-value parameter block
// (__grid_constant__), so the kernel touches device memory only at its start
// and end (and, in the column variant, one row read per event).
//
// Column variant (COL, flux only, y tracked): the extinction is one
// homogeneous layer [z_base, z_top) per (x, y) column.  Each event reads the
// lane's row [v, z_base, z_top, 0] of the column table with one 16-byte
// __ldg (row ix * n_y + iy; ix, iy truncated toward zero and clipped), steps
// to the nearest x/y grid line (floor) or layer bound, and draws the
// collision distance as tau / max(ext, TINY), a division as in the XLA
// column path.  Chained collisions stay inside the x/y cell of the collision
// point and the layer of the row read at the start of the event, with
// 1 / max(v, TINY) as their inverse extinction.  The TPU probe read its table
// from VMEM with two 128-wide one-hot contractions (a random row read costs
// ~10 ns a lane there); on Hopper a row read is one cached load.  The table
// is passed as a pointer, not in the by-value parameter block: the padded
// Landsat table is 16384 x 16 B = 256 KB, above the 4 KB parameter limit.
// It stays resident in the 50 MB L2 as float4 rows.  No shared-memory copy:
// even a 3-field copy (192 KB) would leave room for one CTA per SM, and its
// fill at every launch (~25 MB of L2 reads over 132 CTAs) would cost what
// the row reads it saves.
//
// What bounded each variant before the Hopper redesign, and what the design
// does about it:
//  * Dead lanes cost as much as live ones: every thread loaded its 13 rows,
//    drew every Philox group of every event and ran the whole event under
//    masks.  A per-lane early exit would not help: at the end of a Landsat
//    batch 10% of lanes are alive but 95% of warps hold one.  So each CTA
//    compacts its live lanes.  At entry a thread reads only its lane's alive
//    flag and tau; a dead lane applies the dead-lane contract (below) and
//    leaves; a shared-memory prefix sum packs the live lanes' ids onto the
//    first ceil(n_live / 32) warps, which alone load state, run the K events
//    and store.  Each thread keeps its lane's global id for the Philox
//    counter and the stores.  A warp leaves the event loop once none of its
//    lanes is alive, after the contract of the event that follows.  All
//    variants share this loop.
//  * The dead-lane contract of fast_event: a dead lane's only change is its
//    free path, tau = -log(max(u0, TINY)) from word 0 of the event's group 0,
//    taken when tau <= 0.  After one such draw tau > 0, so a lane dead at
//    entry changes at most at event 0 and a lane that dies at event j at
//    most at event j + 1.
//  * COL drew 3 Philox groups and ran the HG inversion, three rotations and
//    the chain under masks in every event, though on Landsat only 8% of live
//    lane-events collide and 9% read any draw (a crossing carries its tau).
//    Now (LAZY) group g of event j is drawn only when some lane of the warp
//    reads one of its words (__any_sync), at the same counter, so the draws
//    are bit-identical, and the collision work and the chain run under
//    warp-uniform branches.  Against the eager loop on the same states
//    (H100, PERF.md section 6): 0.88x per Landsat batch at chain depth 2,
//    0.89x on its full block; but 1.07-1.08x at chain depth 0, where an
//    event has one group to save, so only column plans with chaining draw
//    lazily.  The other variants stay eager: on the step cloud 80-90% of
//    live lane-events collide, so a warp reads nearly every group.  A
//    prefetch of the next event's row (issued right after the step) was
//    measured too and cost 1-8%, so the row is read at the start of the
//    event.  Column plans run K = 32 events per launch, the JAX planner's K.
//  * K3 added each detector contribution with a float64 atomicAdd into one
//    CTA histogram shared by 256 threads, with only the colliding lanes of
//    a warp active; on sm_90a that atomicAdd is a compare-and-swap loop
//    (ATOMS.CAS in the SASS).  The detector loop now runs warp-convergent,
//    entered when any lane collided, contribution 0 for the others; per
//    detector __match_any_sync groups the lanes by bin, shuffles sum each
//    group, and its lowest lane adds the sum to the warp's private slice
//    with a plain load-add-store (no other warp writes the slice, one lane
//    per bin does).  No shared-memory atomic remains in the event loop of
//    the SLICES instantiations, which every scene up to 751 bins runs (the
//    step cloud's 3 detectors: 96).  Larger histograms keep the aggregation
//    but add each group's sum with an atomicAdd, into one CTA histogram or
//    the global accumulator.  The gas variant with detectors and Iwabuchi's
//    variant share this path.
//  * The TPU design left the block's prologue (renormalize, flush, FIFO
//    refill) to XLA, which fused it around the Pallas call.  Carried over
//    as torch ops it was some dozens of small kernels, a Philox source
//    sample of every lane and a host round trip per block, around an event
//    kernel of 1-3% of the block's time.  It is per-lane work on state the
//    kernel loads anyway, so it is a stage of this kernel (see the note at
//    the kernel): a block of the trace loop is one launch, and the host
//    reads the loop's end from a device flag every few blocks.
//  * What bounds them now (H100 runs of chip_smoke.py): a block whose lanes
//    are nearly all dead is latency-bound, its few live warps spread over
//    every CTA and the CTAs over two waves at 4 CTAs per SM (the register
//    limit); a full block holds 32 warps per SM, too few to hide an event's
//    dependent chains (Philox rounds, IEEE divisions, the row read).
//
// Table variants (TAB: a phase function that is not exactly Henyey-
// Greenstein; the planner's FastPlan.cubic).  The scattering cosine at a
// collision and at each chained one comes from the piecewise-cubic fit of
// the inverse CDF, mu(p) on 256 segments per table entry
// (tables.build_inverse_cubic, the general kernel's sampler): segment
// floor(u * n_seg), one 16-byte __ldg of its row [c0..c3], the cubic at the
// segment's fraction, clipped to [-1, 1]; the draw is the one the HG
// inversion reads.  With detectors the phase value toward detector d is
// exp of the log-space cubic fit on 512 segments of [0, pi]
// (tables.build_forward_cubic) at acos of the projection, one more row read.
// In column media the lane's ssa rides the event's row read (slot 3, the
// padding word of the HG rows) and the row base of its table entry, pf_index * n_seg,
// is read from an int32 array only at a collision, from the column of the
// event's start (the XLA path read both every event; the result is the
// same).  The tables (4-12 KB; 8 KB forward) stay in L1/L2: one read per
// sampled cosine, as the general kernel reads its own.  On the TPU these
// modes never reached Pallas (a random row read is slow there).  TAB is a
// template flag, so that the HG instantiations compile to the code they
// had (a runtime branch raised the general kernel's spills).
//
// Fused-k variants (FK, of the gas variants HG and TAB, chain depth 0: the
// XLA fastpath's gask_mode, fastpath.py:966-1057, :1409-1470, which stayed
// out of Pallas because its per-lane endpoint read of the (n_k * n_z, 2) gas
// table re-created the TPU's one-hot read chains, fastpath.py:1692-1712).
// Every k point of a spectral band runs in one trace: k is a per-lane
// attribute.  The lanes fall into blocks of whole CTAs, one per k point
// (EventParams.fk: cta0, cta_k), so a CTA's k is one load and its lanes'
// tally weight w_k n_photons / quota_k, Gz(z_max) and table row k * n_z are
// CTA-uniform.  A lane carries gcur = Gz(z) of its k (state row 8).  A step
// stops at no gas face: after the step, one 8-byte __ldg of the k table at
// the layer of the step's end gives (gz, Gz at the base), Gz(z_end) is
// linear in the layer, and the step's gas depth is (Gz(z_end) - gcur) / uz
// (gz * step when |uz| < 1e-6).  Where it reaches tgas the lane dies inside
// the step, at the constant-gz fraction tgas / depth, or, with the volume
// tally on (fk.exact_layer), at the height where its cumulative row reaches
// gcur + tgas uz: a binary search of the k's row, only at a gas death.  The
// survivors carry Gz(z_end).  A detector's shadow ray adds max((Gz at its
// exit - gcur) / dz_d, 0) of the lane's own k, and every contribution and
// exit tallies with the lane's weight.  The prologue (block_prologue_fk)
// ranks a dead lane among the dead lanes of its k block only: its CTA's
// count below it plus the dead counts of the block's CTAs below its CTA;
// the block's last CTA writes k's new launched count (ctl[4 + 2k + parity]),
// and a fresh lane starts at gcur = Gz of its own height (the XLA path took
// Gz of the domain top for every source, fastpath.py:2012, :2107-2108).  The
// table is a few KB and stays in L1; what FK adds per lane-event is that
// load and one division.
//
// Differences from the TPU kernel:
//  * RNG: counter-based Philox4x32-10 keyed (seed, batch) with counter
//    (lane, kb, group, stream), the layout of i3rc_tpu_torch/core/rng.py; it
//    replaces the TPU hardware PRNG.  Event j of the block reads group
//    j * G + d / 4, word d % 4 for its draw d, G = ceil(n_draws / 4).
//  * Layout: a 1-D grid over lanes, 256 to a CTA, live lanes compacted,
//    instead of (R, 128) tiles in VMEM.
//  * Segment data arrive in one parameter struct (<= MAX_SEGMENTS thresholds
//    per axis); loops run to the runtime count, so one build serves every
//    domain and every k point of a spectral band.  CHAIN, absorbing,
//    track_y, detectors, Iwabuchi and the gas channel are template
//    parameters; K (any K >= 1: the event loop is not unrolled), the
//    detector count (<= MAX_DETECTORS) and the shadow-trace segments are
//    runtime values.
//  * Iwabuchi's small-phase case keeps the transmittance: it contributes
//    zeta/pi with probability (pf_pi/zeta) exp(-tau), the law of the
//    reference's trace; the JAX fastpath drops exp(-tau) there (for
//    collisions and for surface radiance alike).
//  * A reflecting surface (a Lambertian albedo, or a uniform lambertian,
//    RPV, Cox-Munk or Ross-Li BRDF; fastpath.py:896-924, :1874-1981) was
//    XLA glue at the TPU's flush, one block after the hit.  Here the block
//    ends with a surface stage (fast_event_block_surface_kernel, launched
//    by the same call right after the events) that bounces the block's
//    bottom hits and only then takes the CTA's dead count, so that the next
//    launch's FIFO rank sees a revived lane alive: counted dead at exit and
//    revived at the next prologue, it would skip photon ids.  The kind of
//    surface is a runtime value; the 232 event-kernel instantiations are
//    those of a black surface but for DET's weight (see the note there).
//    Why the stage stays a launch of its own, and what its design does,
//    is in fast_event_block.cu.
//
// Float arithmetic follows the JAX reference and the PyTorch twin operation
// by operation; the library is built with --fmad=false so that no multiply-
// add is contracted, and constants are the float32 values written in hex.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define MAX_SEGMENTS 24
// Detectors a plan may carry.  The Iwabuchi variants hold one draw per
// detector in registers: their instantiations are sized for DET_DRAWS_SMALL
// detectors, and a second set, launched only past that, for MAX_DETECTORS.
#define MAX_DETECTORS 16
#define DET_DRAWS_SMALL 8
// The CHAIN of the runtime-depth variant (fast_event_block_deep.cu): the
// collision-chain depth is EventParams.chain, any depth >= 1; depths 0-3 keep
// instantiations of their own.
#define CHAIN_RUNTIME (-1)
#define STREAM_EVENT 0u
#define STREAM_REFILL 1u
#define STREAM_GAS 3u
#define STREAM_SURFACE 4u
#define STREAM_SURFACE_IW 5u
// First fused-k slot of Prologue.ctl: k's launched count for parity p at
// LAUNCHED_K + 2 k + p (kernels/event_block.py LAUNCHED_K).
#define LAUNCHED_K 4
#define MAX_BRDF_PARAMS 4
// Surface kinds (SurfaceParams.kind; kernels/event_block.py BRDF_KINDS).
#define SURFACE_BLACK 0
#define SURFACE_ALBEDO 1
#define BRDF_LAMBERTIAN 2
#define BRDF_RPV 3
#define BRDF_COX_MUNK 4
#define BRDF_ROSS_LI 5
#define CTA_THREADS 256
#define CTA_WARPS (CTA_THREADS / 32)
#define FULL_MASK 0xffffffffu
// Shared memory of a CTA: the default budget without opting in, the static
// arrays (lane ids, per-warp counts and two CTA sums), and the most that one
// CTA detector histogram may take (see hist_room).
#define SMEM_DEFAULT_BYTES (48 * 1024)
#define SMEM_STATIC_BYTES ((CTA_THREADS + CTA_WARPS + 2) * 4)
#define SMEM_ONE_HIST_BYTES (48 * 1024)

struct StepChain {
  int n;                        // number of interior thresholds
  float t[MAX_SEGMENTS];        // ascending thresholds
  float v[MAX_SEGMENTS + 1];    // segment values
  float iv[MAX_SEGMENTS + 1];   // reciprocal values (0 for zero segments)
};

// Radiance detectors and the closed-form or marching shadow trace
// (i3rc_tpu_torch/kernels/event_block.py DetectorSpec).
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
  // The marching trace (march_steps > 0; never with the gas channel).
  int march_steps;                // segment steps a ray may take
  int march_ty;                   // y tracked: the extinction takes fy
  unsigned int march_xy;          // bit d: detector d steps along x; bit 16 + d: along y
  float inv_dxd[MAX_DETECTORS], inv_dyd[MAX_DETECTORS];   // f32(1 / dx), f32(1 / dy)
};

// The photon source of the refill (i3rc_tpu_torch/core/illumination.py
// PhotonSource.sample and wavefront.make_direction_cosines), every constant
// the float32 value the plain version uses.
struct SourceParams {
  int uniform_xy;               // x, y uniform over the domain (else px, py)
  int mu_mode;                  // 0 constant mu; 1 -sqrt(u); 2 max(sqrt(u), min_mu); 3 its negative
  int phi_random;               // azimuth two_pi * u (else the constant direction dir)
  float px, py, pz;             // normalized position constants
  float delta_x, delta_y;       // finite detector extents (> 0: a second draw group)
  float mu, min_mu, two_pi;
  float dir[3];                 // direction cosines of a constant (mu, phi)
  float x0, wx, y0, wy, z0, wz; // domain scaling: x0 + x * wx
};

// The block's prologue (renormalize, flush, FIFO refill) and the buffers it
// works on.  on = 0: the event loop alone.
struct Prologue {
  int on;
  int n_kinds;                  // columns of the flux tally: up, down (, absorbed)
  int col_y;                    // the exit column bins y too
  int vol_on, n_z;              // volume tally of kind-3 deaths
  float inv_dz_cell;
  long long n_photons;          // the batch's photon budget
  double* columns;              // (n_cols, n_kinds) float64 counts
  double* vol;                  // (n_cols * n_z) float64 counts
  long long* ctl;               // launched (kb even), launched (kb odd), done, spent
  int* dead;                    // (2, n_ctas): dead lanes per CTA at entry of even / odd kb
  SourceParams src;
};

// A reflecting bottom (kernels/event_block.py SurfaceLaw), resolved at the
// end of a launch with the prologue on.  kind SURFACE_BLACK: none.
struct SurfaceParams {
  int kind;
  int iw;                       // Iwabuchi roulette for surface radiance
  float albedo;                 // SURFACE_ALBEDO: the revive probability
  float params[MAX_BRDF_PARAMS];// the BRDF's parameters
  float det_phi[MAX_DETECTORS]; // outgoing azimuth of each detector
  float* w;                     // (L,) lane weight of a BRDF plan, else nullptr
  double* acc;                  // (n_cols, D) surface radiance, or nullptr
};

// Fused-k spectral batching (FK; kernels/event_block.py FusedK): the per-k
// tables, on the device.
struct FusedK {
  const float2* tab;            // (n_k * n_z) [gz, Gz at the layer base], row k * n_z + layer
  const float* w;               // (n_k) tally weight w_k n_photons / quota_k
  const float* gtop;            // (n_k) Gz(z_max)
  const long long* quota;       // (n_k) photon quota
  const int* cta0;              // (n_k + 1) first CTA of each k block
  const int* cta_k;             // (n_ctas) the k of each CTA
  int n_k, n_z;
  float dz, inv_dz;             // the gas layers' height over n_z layers from z0, and 1 / dz
  int exact_layer;              // gas deaths at their exact layer (the volume tally)
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
  int K;                        // events per launch
  DetParams det;                // read by the detector variants only
  StepChain gz;                 // gas chain over z, read by the gas variants only
  int n_x, n_y;                 // column grid: the column variants and the flush
  float inv_dx, inv_dy, dx, dy;
  Prologue pro;
  SurfaceParams srf;
  // Table variants (TAB) only; the HG variants never read these.
  const float4* cubic;          // (entries * n_seg, 4) inverse-CDF cubic rows
  const float4* fwd;            // with detectors: (n_fwd, 4) log-phase cubic rows
  const int* pf_row;            // column media: (n_cols,) row base of each column's entry
  int n_seg, n_fwd;
  float fwd_scale;              // f32(n_fwd / pi)
  FusedK fk;                    // the fused-k variants (FK) only
  // K3-M (MARCH) only: the CTAs' ray queues, MARCH_REC_F4 float4 a record and
  // CTA_THREADS * K records a CTA; and, when not null, the ray loop's counts
  // (MARCH_USE_*).
  float4* rays;
  unsigned long long* ray_use;
  int chain;                    // the collision-chain depth (read by CHAIN_RUNTIME only)
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
#define INV_PI_F 0x1.45f306p-2f     // 1/pi
#define TWO_PI_F 0x1.921fb6p+2f
#define HALF_PI_F 0x1.921fb6p+0f
#define QUARTER_PI_F 0x1.921fb6p-1f
#define SQRT_PI_F 0x1.c5bf8ap+0f    // sqrt(f32(pi)) in float32

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

// The table variants' cosine: the piecewise-cubic inverse CDF at u, in the
// table entry whose rows start at `row` (wavefront.sample_cos_scat).
__device__ __forceinline__ float cubic_cosine(const EventParams& p, int row, float u) {
  const float pos = fminf(fmaxf(u, 0.0f), 1.0f) * (float)p.n_seg;
  const int seg = min(max((int)pos, 0), p.n_seg - 1);
  const float t = pos - (float)seg;
  const float4 c = __ldg(p.cubic + row + seg);
  return fminf(fmaxf(((c.w * t + c.z) * t + c.y) * t + c.x, -1.0f), 1.0f);
}

// The table variants' phase value at the projection `proj` (a cosine):
// exp of the log-space cubic at theta = acos(proj) (fastpath.py:1508-1520).
__device__ __forceinline__ float forward_phase(const EventParams& p, float proj) {
  const float pos = acosf(proj) * p.fwd_scale;
  const int seg = min(max((int)pos, 0), p.n_fwd - 1);
  const float t = pos - (float)seg;
  const float4 c = __ldg(p.fwd + seg);
  return expf(((c.w * t + c.z) * t + c.y) * t + c.x);
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
  float gcur;                   // FK: Gz(z) of the lane's k
};

// (gz, Gz(z)) of the k profile whose rows start at `row`, at z clipped to
// the domain: one 8-byte read of the layer's row, Gz linear inside it
// (fastpath.py:1415-1422).
__device__ __forceinline__ float2 fk_gas_read(const EventParams& p, int row, float z) {
  const float zc = fminf(fmaxf(z, p.z0), p.z_max);
  const int lay = min(max((int)((zc - p.z0) * p.fk.inv_dz), 0), p.fk.n_z - 1);
  const float2 r = __ldg(p.fk.tab + row + lay);
  return make_float2(r.x, r.y + (zc - (p.z0 + (float)lay * p.fk.dz)) * r.x);
}

// A fused-k gas death's exact share of its step (fastpath.py:1432-1460): the
// layer whose base Gz the k's nondecreasing cumulative row reaches at the
// death target g_t (a binary search for the count of bases <= g_t, less
// one), the height where Gz = g_t inside it (the middle where gz is 0), and
// that height's share of the step's rise `denom`, clipped to [0, 1].
__device__ __forceinline__ float fk_death_fraction(const EventParams& p, int row, float g_t,
                                                   float z, float denom) {
  const FusedK& q = p.fk;
  int lo = 0, hi = q.n_z;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (__ldg(&q.tab[row + mid].y) <= g_t) lo = mid + 1;
    else hi = mid;
  }
  const int ld = min(max(lo - 1, 0), q.n_z - 1);
  const float2 r = __ldg(q.tab + row + ld);
  const float z_d = (p.z0 + (float)ld * q.dz) +
                    (r.x > 0.0f ? (g_t - r.y) / fmaxf(r.x, TINY_F) : 0.5f * q.dz);
  return fminf(fmaxf((z_d - z) / (fabsf(denom) > 0.0f ? denom : 1.0f), 0.0f), 1.0f);
}

// A fused-k shadow ray's gas: the lane's k from its gcur to the exit.
__device__ __forceinline__ float fk_shadow_gas(const DetParams& q, int d, float gtop,
                                               float gcur) {
  return fmaxf(((q.dz[d] > 0.0f ? gtop : 0.0f) - gcur) * q.inv_dz[d], 0.0f);
}

// The draws of event j: group g is Philox4x32-10 at counter (lane, kb,
// j * G + g, STREAM_EVENT).  Eager variants draw every group [0, G) before
// the event (start_draws).  The lazy ones (LAZY: the column variant with
// chaining, see the source note) draw a group the first time some lane of its converged warp
// reads one of its words (want), at the same counter, so the words are the
// same.
struct Draws {
  int lane, g0;                   // the lane, and j * G
  unsigned have;                  // groups drawn so far (lazy; warp-uniform)
};

__device__ __forceinline__ void philox_group(const EventParams& p, const Draws& d, int g,
                                             uint32_t w[4]) {
  philox4x32_10((uint32_t)d.lane, p.kb, (uint32_t)(d.g0 + g), STREAM_EVENT, p.key0, p.key1,
                w);
}

template <bool LAZY, int NU>
__device__ __forceinline__ void start_draws(float (&u)[NU], const EventParams& p, Draws& d,
                                            int G) {
#pragma unroll
  for (int g = 0; g < NU / 4; ++g) {
    uint32_t w[4] = {0u, 0u, 0u, 0u};
    if (!LAZY && g < G) philox_group(p, d, g, w);
#pragma unroll
    for (int k = 0; k < 4; ++k) u[4 * g + k] = (!LAZY && g < G) ? to_unit(w[k]) : 0.0f;
  }
  d.have = 0u;
}

// Lazy: group g, if some lane of the warp reads one of its words (pred) and
// it is not drawn yet.  A no-op for eager variants.
template <bool LAZY, int NU>
__device__ __forceinline__ void want(float (&u)[NU], const EventParams& p, Draws& d, int g,
                                     bool pred) {
  if (!LAZY || ((d.have >> g) & 1u) || !__any_sync(FULL_MASK, pred)) return;
  d.have |= 1u << g;
  uint32_t w[4];
  philox_group(p, d, g, w);
#pragma unroll
  for (int k = 0; k < 4; ++k) u[4 * g + k] = to_unit(w[k]);
}

// A branch for the lanes with pred: the lazy variant takes it warp-
// uniformly when any lane of the warp has pred (the others mask their
// results), so that the draws inside stay warp-wide; eager ones per lane.
template <bool LAZY>
__device__ __forceinline__ bool warp_any(bool pred) {
  return LAZY ? __any_sync(FULL_MASK, pred) : pred;
}

// Element w (0-3) of a group's four values, w a runtime index, by selects
// (an index into the register array would put it in local memory).
__device__ __forceinline__ float elem_of(const float (&a)[4], int w) {
  return w == 0 ? a[0] : w == 1 ? a[1] : w == 2 ? a[2] : a[3];
}

// The runtime-depth variant's bonus phase: its BD draws, the words i0,
// i0 + 1, ... of the event, from group i0 / 4 (from word i0 % 4) and, past
// its end, the next group, at the counters the eager variants use, so that
// they equal the twin's.  Phases run in order and a phase's groups follow
// the last one drawn, so the caller keeps that group's values (last, its
// index g_last; group 0 is the event's u) and each group is drawn once, as
// in the eager variants.  Nothing for a lane without pred.  Four draw
// registers and the kept group, whatever the depth.
template <int BD>
__device__ __forceinline__ void phase_draws(const EventParams& p, const Draws& d, int i0,
                                            bool pred, float (&last)[4], int& g_last,
                                            float (&v)[4]) {
  v[0] = v[1] = v[2] = v[3] = 0.0f;
  if (!pred) return;
  const int g = i0 >> 2, k = i0 & 3;
  float a[4], b[4];
  uint32_t w[4];
  if (g != g_last) {
    philox_group(p, d, g, w);
#pragma unroll
    for (int m = 0; m < 4; ++m) last[m] = to_unit(w[m]);
    g_last = g;
  }
#pragma unroll
  for (int m = 0; m < 4; ++m) a[m] = b[m] = last[m];
  if (k + BD > 4) {
    philox_group(p, d, g + 1, w);
#pragma unroll
    for (int m = 0; m < 4; ++m) b[m] = last[m] = to_unit(w[m]);
    g_last = g + 1;
  }
#pragma unroll
  for (int m = 0; m < BD; ++m) v[m] = k + m < 4 ? elem_of(a, k + m) : elem_of(b, k + m - 4);
}

// The dead-lane contract's free path at event j: word 0 of group j * G.
__device__ __forceinline__ float contract_tau(const EventParams& p, int lane, int j, int G) {
  uint32_t w[4];
  philox_group(p, Draws{lane, j * G, 0u}, 0, w);
  return exponential_deviate(to_unit(w[0]));
}

// Adds c to detector bin `bin` of `hist`, from a converged warp: the lanes of
// one bin are grouped by __match_any_sync and summed by a shuffle tree, and
// the group's lowest lane adds the sum, with a plain load-add-store into the
// warp's private slice (PLAIN), or with atomicAdd into a histogram that other
// warps share (the CTA's one in shared memory, or the global accumulator).
template <bool PLAIN>
__device__ __forceinline__ void tally(double* hist, int bin, float c) {
  const int key = c != 0.0f ? bin : -1;
  if (!__any_sync(FULL_MASK, key >= 0)) return;
  const unsigned peers = __match_any_sync(FULL_MASK, key);
  const int wl = threadIdx.x & 31;
  const unsigned below = (1u << wl) - 1u;
  // Lanes without a contribution (key -1) take no part in the sums.
  unsigned higher = key >= 0 ? peers & ~(below | (1u << wl)) : 0u;
  int rank = __popc(peers & below);
  double v = (double)c;
  // Round r: each lane adds the partial sum of its next remaining higher
  // peer; the lanes whose rank has bit r set are then done.
  while (__any_sync(FULL_MASK, higher != 0u)) {
    const int next = __ffs(higher);
    const double t = __shfl_sync(FULL_MASK, v, next ? next - 1 : wl);
    if (next) v += t;
    higher &= ~__ballot_sync(FULL_MASK, rank & 1);
    rank >>= 1;
  }
  if (key >= 0 && (peers & below) == 0u) {
    if (PLAIN) hist[key] += v;
    else atomicAdd(hist + key, v);
  }
  __syncwarp();
}

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

// The closed-form shadow trace of detector d from (x, y, z): the optical
// depth to the z boundary, and the exit column in *col_out (shadow_closed,
// fastpath.py:1194-1247; the gas segments, :1219-1233, are empty without a
// gas channel).
__device__ __forceinline__ float shadow_closed(const EventParams& p, int d, float x, float y,
                                               float z, int* col_out) {
  const DetParams& q = p.det;
  const float inv_dz = q.inv_dz[d];
  const bool up = q.dz[d] >= 0.0f;
  const float ph = q.h_axis == 0 ? x : y;
  float tau = 0.0f;
  for (int k = 0; k < q.n_z; ++k) {
    const float a = up ? q.z_lo[k] : q.z_hi[k];
    const float b = up ? q.z_hi[k] : q.z_lo[k];
    const float t_lo = fmaxf((a - z) * inv_dz, 0.0f);
    const float t_hi = fmaxf((b - z) * inv_dz, 0.0f);
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
    const float t_lo = fmaxf((a - z) * inv_dz, 0.0f);
    const float t_hi = fmaxf((b - z) * inv_dz, 0.0f);
    tau = tau + q.g_v[k] * fmaxf(t_hi - t_lo, 0.0f);
  }

  const float t_ex = ((up ? q.z_top : q.z_bot) - z) * inv_dz;
  float xe = x + t_ex * q.dx[d];
  xe = xe - q.wrap_wx * floorf((xe - q.x0) * q.wrap_inv_x);
  int col = min(max((int)((xe - q.x0) * q.inv_dx), 0), q.n_x - 1);
  if (q.col_y) {
    float ye = y + t_ex * q.dy[d];
    ye = ye - q.wrap_wy * floorf((ye - q.y0) * q.wrap_inv_y);
    col = col * q.n_y + min(max((int)((ye - q.y0) * q.inv_dy), 0), q.n_y - 1);
  }
  *col_out = col;
  return tau;
}

// One segment step of the marching shadow trace of detector d (shadow_march,
// fastpath.py:1061-1127, the trace of a plan whose x and y factors both vary
// or whose detector grazes the horizon): to the nearest face of the z chain
// and of the x and y chains the ray moves along (strict faces), with the face
// nudges and the periodic wrap, the optical depth of the step from the
// factors at its start.  True when the step reaches the z boundary: the exit
// column comes from the stepped position (*col), and the position is left
// where it was.
__device__ __forceinline__ bool march_step(const EventParams& p, int d, float& x, float& y,
                                           float& z, float& tau, int& col) {
  const DetParams& q = p.det;
  const float dx = q.dx[d], dy = q.dy[d], dz = q.dz[d];
  const bool up = dz >= 0.0f;
  const bool use_x = (q.march_xy >> d) & 1u, use_y = (q.march_xy >> (16 + d)) & 1u;
  float ext = chain_value(p.fx, p.fx.v, x) * chain_value(p.fz, p.fz.v, z);
  if (q.march_ty) ext = ext * chain_value(p.fy, p.fy.v, y);
  const float face_z = up ? face_up(p.fz, z, p.z_max) : face_dn(p.fz, z, p.z0);
  const float s_z = (face_z - z) * q.inv_dz[d];
  float s_b = s_z, s_x = 0.0f, s_y = 0.0f, face_x = 0.0f, face_y = 0.0f;
  if (use_x) {
    face_x = dx >= 0.0f ? face_up(p.fx, x, p.x_max) : face_dn(p.fx, x, p.x0);
    s_x = (face_x - x) * q.inv_dxd[d];
    s_b = fminf(s_b, s_x);
  }
  if (use_y) {
    face_y = dy >= 0.0f ? face_up(p.fy, y, p.y_max) : face_dn(p.fy, y, p.y0);
    s_y = (face_y - y) * q.inv_dyd[d];
    s_b = fminf(s_b, s_y);
  }
  s_b = fmaxf(s_b, 0.0f);
  tau = tau + s_b * ext;
  const float nz = s_z <= s_b ? face_z + (up ? p.nudge_z : -p.nudge_z) : z + dz * s_b;
  float nx = x, ny = y;
  if (use_x) {
    nx = s_x <= s_b ? face_x + (dx >= 0.0f ? p.nudge_x : -p.nudge_x) : x + dx * s_b;
    nx = wrap_fast(nx, p.x0, p.x_max, p.wx);
  }
  if (use_y) {
    ny = s_y <= s_b ? face_y + (dy >= 0.0f ? p.nudge_y : -p.nudge_y) : y + dy * s_b;
    ny = wrap_fast(ny, p.y0, p.y_max, p.wy);
  }
  if (up ? nz >= p.z_max : nz <= p.z0) {
    col = min(max((int)((nx - q.x0) * q.inv_dx), 0), q.n_x - 1);
    if (q.col_y) col = col * q.n_y + min(max((int)((ny - q.y0) * q.inv_dy), 0), q.n_y - 1);
    return true;
  }
  x = nx;
  y = ny;
  z = nz;
  return false;
}

// Iwabuchi Eq 13/14 on the exact tau, for a normalized phase value npf;
// the small-phase case accepts with probability (pf_pi / zeta) exp(-tau)
// (see the header).
__device__ __forceinline__ float iwabuchi(const DetParams& q, float npf, float tau,
                                          float u_iw) {
  const float pf_pi = PI_F * npf;
  const float tau_max = -logf(q.zeta / fmaxf(pf_pi, TINY_F));
  if (pf_pi <= q.zeta) return (u_iw * q.zeta <= pf_pi * expf(-tau)) ? q.zeta_pi : 0.0f;
  if (tau <= tau_max) return npf * expf(-tau);
  return (u_iw < expf(tau_max - tau)) ? q.zeta_pi : 0.0f;
}

// Local estimate of detector d from a collision at s (direction before the
// scattering) by the closed-form trace: the contribution and its exit column
// (fastpath.py:1501-1571).  FK adds the lane's own gas to the shadow ray
// (gtop: Gz(z_max) of its k).
template <bool IW, bool FK>
__device__ __forceinline__ float detector_contribution(const EventParams& p, int d,
                                                       const Lane& s, float u_iw, int* col_out,
                                                       float gtop) {
  const DetParams& q = p.det;
  const float proj =
      fminf(fmaxf(s.ux * q.dx[d] + s.uy * q.dy[d] + s.uz * q.dz[d], -1.0f), 1.0f);
  const float r =
      1.0f / sqrtf(fmaxf((1.0f + p.g * p.g) - (p.g + p.g) * proj, EPS12_F));
  const float norm_pf = (1.0f - p.g * p.g) * r * r * r * q.norm[d];
  float tau = shadow_closed(p, d, s.x, s.y, s.z, col_out);
  if (FK) tau = tau + fk_shadow_gas(q, d, gtop, s.gcur);
  if (IW) return iwabuchi(q, norm_pf, tau, u_iw);
  return norm_pf * expf(-tau);
}

// The same with the phase value of the forward fit (TAB).  A function of its
// own, so that the HG variants compile to the code they had.
template <bool IW, bool FK>
__device__ __forceinline__ float detector_contribution_tab(const EventParams& p, int d,
                                                           const Lane& s, float u_iw,
                                                           int* col_out, float gtop) {
  const DetParams& q = p.det;
  const float proj =
      fminf(fmaxf(s.ux * q.dx[d] + s.uy * q.dy[d] + s.uz * q.dz[d], -1.0f), 1.0f);
  const float norm_pf = forward_phase(p, proj) * q.norm[d];
  float tau = shadow_closed(p, d, s.x, s.y, s.z, col_out);
  if (FK) tau = tau + fk_shadow_gas(q, d, gtop, s.gcur);
  if (IW) return iwabuchi(q, norm_pf, tau, u_iw);
  return norm_pf * expf(-tau);
}

// K3-M's ray queue.  The closed-trace instantiations trace an event's D
// rays in the event loop, one lane a thread.  A marching ray takes up to
// march_steps segment steps, so there a warp ran its longest ray, detector
// after detector, at each of the K events, and in the drain a few live lanes
// walked their rays alone while the CTA's other threads idled (0.24 of a
// warp's lanes busy in the ray loop, PERF.md section 6).  So, as G's
// estimate stage does (general_event_block.cuh gen_flush), a lane that
// collides pushes one record to its CTA's segment of the device scratch
// p.rays (room for a record at every event of every lane: the queue never
// fills), and after the lanes' K events the CTA's 256 threads pull the
// queue's (record, detector) rays, a warp refilling as its rays finish.  A
// record is two float4: the point; the direction before the scattering, the
// lane and j * G, the counter base of the event's draws, from which a ray
// redraws its Iwabuchi word (the word pick(u, BD + d) of the event).  A
// ray's phase value, trace, Iwabuchi roulette and lane weight repeat
// detector_contribution's float32 arithmetic, so each contribution is the
// closed-loop design's bit for bit; only the order of the float64 sums
// differs.
#define MARCH_REC_F4 2
// The ray loop's counts (p.ray_use): rays, their segment steps, the warp
// trips' thread slots (32 a trip of a warp with a ray), and flushes.
#define MARCH_USE_RAYS 0
#define MARCH_USE_STEPS 1
#define MARCH_USE_SLOTS 2
#define MARCH_USE_FLUSHES 3
// The same of the marching surface stage's ray loop (S-M,
// fast_event_block.cu): rays, steps, thread slots, and the CTAs' runs.
#define SRF_USE_RAYS 4
#define SRF_USE_STEPS 5
#define SRF_USE_SLOTS 6
#define SRF_USE_RUNS 7
// A warp refills when at most this many of its threads still hold a ray
// (G's GEN_REFILL_AT).
#define MARCH_REFILL_AT 8

// The CTA's queue counts: records pushed, and the next ray dealt (one
// shared array a CTA: a function's __shared__ variable is static).
static __device__ __forceinline__ int* march_q() {
  __shared__ int q[2];
  return q;
}

__device__ __forceinline__ float4* march_record(const EventParams& p, int k) {
  return p.rays + MARCH_REC_F4 * ((size_t)blockIdx.x * CTA_THREADS * p.K + k);
}

// The records of the warp's colliding lanes, one slot range a warp taken by
// one shared atomic.  Called by every thread of a warp together.
__device__ __forceinline__ void march_push(const EventParams& p, const Draws& dr, const Lane& s,
                                           bool collided) {
  const int wl = threadIdx.x & 31;
  const unsigned m = __ballot_sync(FULL_MASK, collided);
  const int lead = __ffs(m) - 1;
  int base = 0;
  if (wl == lead) base = atomicAdd(march_q(), __popc(m));
  base = __shfl_sync(FULL_MASK, base, lead);
  if (collided) {
    float4* r = march_record(p, base + __popc(m & ((1u << wl) - 1u)));
    r[0] = make_float4(s.x, s.y, s.z, s.ux);
    r[1] = make_float4(s.uy, s.uz, __int_as_float(dr.lane), __int_as_float(dr.g0));
  }
}

// A ray of the queue in flight: its point and optical depth, its phase value
// over 4 pi |mu_d| and Iwabuchi draw, detector, lane and steps taken.
struct MarchRayState {
  float x, y, z, tau, npf, u_iw;
  int d, lane, steps;
};

// Ray r of the CTA's n records, dealt detector by detector (record r % n
// toward detector r / n), set up as detector_contribution(_tab) sets up its
// ray.
template <bool IW, bool TAB>
__device__ __forceinline__ void march_ray_start(const EventParams& p, int r, int n, int bd,
                                                MarchRayState& a) {
  const DetParams& q = p.det;
  const int d = r / n;
  const float4* rec = march_record(p, r - d * n);
  const float4 r0 = __ldcg(rec), r1 = __ldcg(rec + 1);
  a.x = r0.x;
  a.y = r0.y;
  a.z = r0.z;
  a.d = d;
  a.lane = __float_as_int(r1.z);
  a.tau = 0.0f;
  a.steps = 0;
  const float proj = fminf(fmaxf(r0.w * q.dx[d] + r1.x * q.dy[d] + r1.y * q.dz[d], -1.0f), 1.0f);
  if constexpr (TAB) {
    a.npf = forward_phase(p, proj) * q.norm[d];
  } else {
    const float rr = 1.0f / sqrtf(fmaxf((1.0f + p.g * p.g) - (p.g + p.g) * proj, EPS12_F));
    a.npf = (1.0f - p.g * p.g) * rr * rr * rr * q.norm[d];
  }
  a.u_iw = 0.0f;
  if (IW) {
    uint32_t w[4];
    philox_group(p, Draws{a.lane, __float_as_int(r1.w), 0u}, (bd + d) >> 2, w);
    const int k = (bd + d) & 3;
    a.u_iw = to_unit(k == 0 ? w[0] : k == 1 ? w[1] : k == 2 ? w[2] : w[3]);
  }
}

// Traces the rays (record, detector) of the CTA's queue: every thread of the
// CTA pulls rays, a warp's idle threads taking the next ones with one shared
// atomic; each trip advances every thread's ray one segment step, until at
// most MARCH_REFILL_AT threads of the warp hold a ray while rays are left,
// or none does.  A finished ray's contribution is tallied when the warp next
// meets at the refill (tally, converged), into the warp's hist.  Called by
// every thread of the CTA after the lanes' events and a barrier.  Inlined:
// after the lanes' loop its values no longer overlap the event loop's, and
// the K3-M instantiations take 40-56 registers and spill nothing; as a
// call (noinline) they took 64 and the table set spilled 14-152 bytes
// (ptxas -v on the H100 machine's nvcc, copies built side by side).
template <bool IW, bool TAB, bool SLICES>
__device__ __forceinline__ void march_flush(const EventParams& p, double* hist, int bd) {
  const int n = march_q()[0], D = p.det.n, nr = n * D;
  const int wl = threadIdx.x & 31;
  unsigned steps = 0, slots = 0;     // this warp's (lane 0's)
  MarchRayState a;
  int col = 0;
  // fin: the ray ended at the last trip, 2 if it reached the boundary.
  int fin = 0;
  bool act = false, more = nr > 0;
#pragma unroll 1
  for (;;) {
    float c = 0.0f;
    if (fin == 2) {
      c = IW ? iwabuchi(p.det, a.npf, a.tau, a.u_iw) : a.npf * expf(-a.tau);
      if (p.srf.w) c = c * p.srf.w[a.lane];
    }
    tally<SLICES>(hist, col * D + a.d, c);
    fin = 0;
    const bool want = !act && more;
    const unsigned wm = __ballot_sync(FULL_MASK, want);
    if (wm) {
      const int lead = __ffs(wm) - 1;
      int r0 = 0;
      if (wl == lead) r0 = atomicAdd(march_q() + 1, __popc(wm));
      r0 = __shfl_sync(FULL_MASK, r0, lead);
      if (want) {
        const int r = r0 + __popc(wm & ((1u << wl) - 1u));
        more = r < nr;
        if (more) {
          march_ray_start<IW, TAB>(p, r, n, bd, a);
          act = true;
        }
      }
    }
    if (!__any_sync(FULL_MASK, act)) break;
    const bool left = __any_sync(FULL_MASK, more);
#pragma unroll 1
    for (;;) {
      steps += __popc(__ballot_sync(FULL_MASK, act));
      slots += 32;
      if (act) {
        if (march_step(p, a.d, a.x, a.y, a.z, a.tau, col)) fin = 2;
        else if (++a.steps >= p.det.march_steps) fin = 1;
        act = fin == 0;
      }
      const unsigned am = __ballot_sync(FULL_MASK, act);
      if (am == 0u || (left && __popc(am) <= MARCH_REFILL_AT)) break;
    }
  }
  if (p.ray_use && wl == 0) {
    atomicAdd(p.ray_use + MARCH_USE_STEPS, (unsigned long long)steps);
    atomicAdd(p.ray_use + MARCH_USE_SLOTS, (unsigned long long)slots);
    if (threadIdx.x == 0 && nr > 0) {
      atomicAdd(p.ray_use + MARCH_USE_RAYS, (unsigned long long)nr);
      atomicAdd(p.ray_use + MARCH_USE_FLUSHES, 1ull);
    }
  }
}

// One fast_event (fastpath.py:1291-1676, MARCH = 1).  u holds the event's
// draws: u[0] free path, u[1] scattering cosine, u[2] azimuth, u[3]
// absorption (when ABS), then CHAIN bonus phases of BD draws each, or with
// DET && IW one Iwabuchi draw per detector; with LAZY they are drawn as
// they are read (want).  DET adds the collision's detector contributions to
// hist (tally: the warp's private slice when SLICES, else a histogram the
// warps share).  TAB samples the cosine from the cubic inverse CDF (in column
// media at the lane's entry, with the lane's ssa in the absorption tests) and
// takes the detectors' phase values from the forward fit.  MARCH (with DET,
// neither GAS nor FK) queues each collision's record for the CTA's marching
// rays (march_push) in place of the detector loop.  FK (with GAS,
// CHAIN 0) takes the fused-k gas step of the lane's k, the k of its CTA
// (see the note at the top; read here, not passed in: an argument of its k
// unused by the other variants, changed their registers).  Called by every
// thread of a warp together.
template <int CHAIN, bool ABS, bool TY, bool DET, bool IW, bool GAS, bool COL, bool SLICES,
          bool LAZY, bool TAB, bool FK, bool MARCH, int NU>
__device__ __forceinline__ void fast_event(const EventParams& p, float (&u)[NU], Draws& dr,
                                           Lane& s, double* hist,
                                           const float4* __restrict__ col) {
  constexpr int BD = ABS ? 4 : 3;
  const int fk_k = FK ? __ldg(p.fk.cta_k + blockIdx.x) : 0;
  const bool alive = s.alive != 0;
  want<LAZY>(u, p, dr, 0, !(s.tau > 0.0f));
  float tau = s.tau > 0.0f ? s.tau : exponential_deviate(u[0]);

  const bool up_x = s.ux >= 0.0f, up_y = s.uy >= 0.0f, up_z = s.uz >= 0.0f;
  const float sign_x = up_x ? p.nudge_x : -p.nudge_x;
  const float sign_y = up_y ? p.nudge_y : -p.nudge_y;
  const float sign_z = up_z ? p.nudge_z : -p.nudge_z;

  float ext, inv_ext = 0.0f, face_x, face_z;
  float vcol = 0.0f, zb = 0.0f, zt = 0.0f;
  // The ssa of the absorption tests: uniform, or (TAB in column media) the
  // column's; ci is the column of the event's start.
  float ssa = 0.0f;
  int ci = 0;
  if (COL) {
    // The lane's column row (fastpath.py:1320-1345): ix, iy truncated
    // toward zero and clipped.
    const int ix = min(max((int)((s.x - p.x0) * p.inv_dx), 0), p.n_x - 1);
    const int iy = min(max((int)((s.y - p.y0) * p.inv_dy), 0), p.n_y - 1);
    ci = ix * p.n_y + iy;
    const float4 row = __ldg(col + ci);
    vcol = row.x;
    zb = row.y;
    zt = row.z;
    if (TAB) ssa = row.w;
    ext = (s.z >= zb && s.z < zt) ? vcol : 0.0f;
    face_x = p.x0 + (floorf((s.x - p.x0) * p.inv_dx) + (up_x ? 1.0f : 0.0f)) * p.dx;
    face_z = up_z ? (s.z < zb ? zb : (s.z < zt ? zt : p.z_max))
                  : (s.z > zt ? zt : (s.z > zb ? zb : p.z0));
  } else {
    ext = chain_value(p.fx, p.fx.v, s.x) * chain_value(p.fz, p.fz.v, s.z);
    inv_ext = chain_value(p.fx, p.fx.iv, s.x) * chain_value(p.fz, p.fz.iv, s.z);
    if (TY) {
      ext = ext * chain_value(p.fy, p.fy.v, s.y);
      inv_ext = inv_ext * chain_value(p.fy, p.fy.iv, s.y);
    }
    face_x = up_x ? face_up(p.fx, s.x, p.x_max) : face_dn(p.fx, s.x, p.x0);
    face_z = up_z ? face_up(p.fz, s.z, p.z_max) : face_dn(p.fz, s.z, p.z0);
  }
  float gzv = 0.0f;
  if (GAS && !FK) {
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
    if (COL)
      face_y = p.y0 + (floorf((s.y - p.y0) * p.inv_dy) + (up_y ? 1.0f : 0.0f)) * p.dy;
    else
      face_y = up_y ? face_up(p.fy, s.y, p.y_max) : face_dn(p.fy, s.y, p.y0);
    sy = fabsf(s.uy) >= DIR_EPS_F ? (face_y - s.y) / s.uy : HUGE_F;
    s_bnd = fminf(s_bnd, sy);
  }
  s_bnd = fmaxf(s_bnd, 0.0f);
  // Column media divide (fastpath.py:1378-1379); separable media multiply by
  // the inverse chain.
  const float s_col = ext > 0.0f ? (COL ? tau / fmaxf(ext, TINY_F) : tau * inv_ext) : HUGE_F;

  bool collide, cross, gas_die = false;
  float adv;
  if (GAS && !FK) {
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
  // FK: the step's gas depth from the endpoint read; a death inside the step
  // lands at (xd, yd, zd).
  float xd = 0.0f, yd = 0.0f, zd = 0.0f;
  if (FK && alive) {
    const float2 g = fk_gas_read(p, fk_k * p.fk.n_z, nzp);
    const bool steep = fabsf(s.uz) >= EPS6_F;
    const float dgas = fmaxf(steep ? (g.y - s.gcur) / s.uz : g.x * adv, 0.0f);
    gas_die = dgas >= s.tgas;
    if (gas_die) {
      float fdie = fminf(fmaxf(s.tgas / fmaxf(dgas, TINY_F), 0.0f), 1.0f);
      if (p.fk.exact_layer && steep)
        fdie = fk_death_fraction(p, fk_k * p.fk.n_z, s.gcur + s.tgas * s.uz, s.z, s.uz * adv);
      xd = wrap_fast(s.x + s.ux * adv * fdie, p.x0, p.x_max, p.wx);
      zd = s.z + s.uz * adv * fdie;
      if (TY) yd = wrap_fast(s.y + s.uy * adv * fdie, p.y0, p.y_max, p.wy);
      collide = false;
      cross = false;
    } else {
      s.tgas = s.tgas - dgas;
      s.gcur = g.y;
    }
  }
  const bool exit_top = cross && (nzp >= p.z_max);
  const bool exit_bot = cross && !exit_top && (nzp <= p.z0);
  if (exit_top) s.pk = 1;
  else if (exit_bot) s.pk = 2;
  if (GAS && gas_die) s.pk = 3;
  tau = cross ? tau - s_bnd * ext : (collide ? 0.0f : tau);
  if (alive) {
    s.x = FK && gas_die ? xd : nxp;
    s.z = FK && gas_die ? zd : nzp;
    if (TY) s.y = FK && gas_die ? yd : nyp;
  }

  bool collided = collide;
  if (ABS) {
    want<LAZY>(u, p, dr, 0, collide);
    const bool die = collided && (u[3] >= (TAB && COL ? ssa : p.ssa));
    if (die) s.pk = 3;
    collided = collided && !die;
  }
  if constexpr (MARCH) {
    if (__any_sync(FULL_MASK, collided)) march_push(p, dr, s, collided);
  } else if (DET && __any_sync(FULL_MASK, collided)) {
    // Warp-convergent: the lanes that did not collide contribute 0.
    const float gtop = FK ? __ldg(p.fk.gtop + fk_k) : 0.0f;
#pragma unroll 1
    for (int d = 0; d < p.det.n; ++d) {
      int bin;
      float c;
      if constexpr (TAB)
        c = detector_contribution_tab<IW, FK>(p, d, s, IW ? pick(u, BD + d) : 0.0f, &bin,
                                              gtop);
      else
        c = detector_contribution<IW, FK>(p, d, s, IW ? pick(u, BD + d) : 0.0f, &bin, gtop);
      if (!collided) c = 0.0f;
      // A BRDF plan's lane weight, read where it scales (constant in the block).
      if (p.srf.w) c = c * p.srf.w[dr.lane];
      if (FK) c = c * __ldg(p.fk.w + fk_k);
      tally<SLICES>(hist, bin * p.det.n + d, c);
    }
  }
  // The row base of the lane's table entry (TAB in column media), read at
  // its collision; a chained collision stays in the same column.
  int prow = 0;
  if (warp_any<LAZY>(collided)) {
    want<LAZY>(u, p, dr, 0, collided);
    if (TAB && COL && collided) prow = __ldg(p.pf_row + ci);
    float nx, ny, nz;
    rotate_direction(s.ux, s.uy, s.uz, TAB ? cubic_cosine(p, prow, u[1]) : hg_cosine(p.g, u[1]),
                     u[2], &nx, &ny, &nz);
    if (collided) {
      s.ux = nx;
      s.uy = ny;
      s.uz = nz;
    }
  }
  int n_coll = collided ? 1 : 0;

  if (CHAIN != 0 && (!LAZY || warp_any<LAZY>(collided))) {
    // Segment box around the collision point: extinction is constant
    // inside it, so a candidate that stays strictly within commits as a
    // physical collision; one that leaves defers its optical depth.  In
    // column media the box is the x/y cell of the collision point and the
    // layer of the row read at the start of the event (fastpath.py:
    // 1607-1614).
    float wx_lo, wx_hi, wz_lo, wz_hi, inv_c, wy_lo = 0.0f, wy_hi = 0.0f;
    if (COL) {
      wx_lo = p.x0 + floorf((s.x - p.x0) * p.inv_dx) * p.dx;
      wx_hi = wx_lo + p.dx;
      wz_lo = zb;
      wz_hi = zt;
      inv_c = 1.0f / fmaxf(vcol, TINY_F);
      wy_lo = p.y0 + floorf((s.y - p.y0) * p.inv_dy) * p.dy;
      wy_hi = wy_lo + p.dy;
    } else {
      wx_lo = face_dn(p.fx, s.x, p.x0);
      wx_hi = face_up(p.fx, s.x, p.x_max);
      wz_lo = face_dn(p.fz, s.z, p.z0);
      wz_hi = face_up(p.fz, s.z, p.z_max);
      inv_c = chain_value(p.fx, p.fx.iv, s.x) * chain_value(p.fz, p.fz.iv, s.z);
      if (TY) {
        wy_lo = face_dn(p.fy, s.y, p.y0);
        wy_hi = face_up(p.fy, s.y, p.y_max);
        inv_c = inv_c * chain_value(p.fy, p.fy.iv, s.y);
      }
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
    if constexpr (CHAIN < 0) {
      // The runtime depth p.chain: each bonus phase draws its own words
      // (phase_draws), so the registers do not grow with the depth; the loop
      // ends once no lane of the warp chains.  A chaining lane collided, so
      // u holds group 0 (drawn eagerly, or in the lazy column variant for
      // its collision).
      float last[4] = {u[0], u[1], u[2], u[3]};
      int g_last = 0;
#pragma unroll 1
      for (int b = 0; b < p.chain; ++b) {
        if (!__any_sync(FULL_MASK, chain)) break;
        float v[4];
        phase_draws<BD>(p, dr, BD + b * BD, chain, last, g_last, v);
        const float tau_new = exponential_deviate(v[0]);
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
          const bool die_c = commit && (v[3] >= (TAB && COL ? ssa : p.ssa));
          if (die_c) s.pk = 3;
          commit = commit && !die_c;
        }
        if (warp_any<LAZY>(commit)) {
          float nx, ny, nz;
          rotate_direction(s.ux, s.uy, s.uz,
                           TAB ? cubic_cosine(p, prow, v[1]) : hg_cosine(p.g, v[1]), v[2],
                           &nx, &ny, &nz);
          if (commit) {
            s.ux = nx;
            s.uy = ny;
            s.uz = nz;
          }
        }
        chain = commit;
      }
    } else {
#pragma unroll
    for (int b = 0; b < CHAIN; ++b) {
      if (LAZY && !warp_any<LAZY>(chain)) break;
      const int i0 = BD + b * BD;
      want<LAZY>(u, p, dr, i0 / 4, chain);
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
        want<LAZY>(u, p, dr, (i0 + 3) / 4, commit);
        const bool die_c = commit && (u[i0 + 3] >= (TAB && COL ? ssa : p.ssa));
        if (die_c) s.pk = 3;
        commit = commit && !die_c;
      }
      if (warp_any<LAZY>(commit)) {
        want<LAZY>(u, p, dr, (i0 + 1) / 4, commit);
        want<LAZY>(u, p, dr, (i0 + 2) / 4, commit);
        float nx, ny, nz;
        rotate_direction(s.ux, s.uy, s.uz,
                         TAB ? cubic_cosine(p, prow, u[i0 + 1]) : hg_cosine(p.g, u[i0 + 1]),
                         u[i0 + 2], &nx, &ny, &nz);
        if (commit) {
          s.ux = nx;
          s.uy = ny;
          s.uz = nz;
        }
      }
      chain = commit;
    }
    }
  }

  s.tau = tau;
  s.orders += n_coll;
  const bool over = alive && (s.orders >= p.max_events);
  s.bad += over ? 1 : 0;
  s.evct += alive ? 1 : 0;
  s.alive = (alive && s.pk == 0 && !over) ? 1 : 0;
}

// One count into a float64 tally in device memory, with no value returned.
// Spelled as the global-space reduction: in the out-of-line prologue the
// tallies' pointers are generic, and a generic atomicAdd(double*) compiles to
// a test for shared memory with a compare-and-swap loop beside the add.
__device__ __forceinline__ void tally_add(double* addr, double v) {
  asm volatile("red.global.add.f64 [%0], %1;" ::"l"(__cvta_generic_to_global(addr)), "d"(v)
               : "memory");
}

// Adds v to base[key] for the lanes with key >= 0, from a converged warp:
// the lanes of one key are grouped by __match_any_sync and summed by a
// shuffle tree (as in tally), and the group's lowest lane adds the sum, with
// tally_add into device memory or (SHARED) with atomicAdd into the CTA's
// histogram in shared memory.  The surface stage's weighted flux counts and
// radiance, whose lanes crowd onto few bins (the glint scene has one column).
template <bool SHARED>
__device__ __forceinline__ void warp_red(double* base, int key, double v) {
  if (!__any_sync(FULL_MASK, key >= 0)) return;
  const unsigned peers = __match_any_sync(FULL_MASK, key);
  const int wl = threadIdx.x & 31;
  const unsigned below = (1u << wl) - 1u;
  unsigned higher = key >= 0 ? peers & ~(below | (1u << wl)) : 0u;
  int rank = __popc(peers & below);
  while (__any_sync(FULL_MASK, higher != 0u)) {
    const int next = __ffs(higher);
    const double t = __shfl_sync(FULL_MASK, v, next ? next - 1 : wl);
    if (next) v += t;
    higher &= ~__ballot_sync(FULL_MASK, rank & 1);
    rank >>= 1;
  }
  if (key >= 0 && (peers & below) == 0u) {
    if (SHARED) atomicAdd(base + key, v);
    else tally_add(base + key, v);
  }
  __syncwarp();
}

// One source sample of the refill for `lane` at block kb under the key
// (k0, k1): position scaled to the domain and direction cosines, out = x, y,
// z, ux, uy, uz (PhotonSource.sample at (lane, kb, group, STREAM_REFILL),
// then launch_state's scaling and make_direction_cosines).  Shared by the
// fast and the general event blocks (general_event_block.cuh).  Not
// inlined: its registers and the stack of sinf/cosf stay out of the event
// loop's budget.
static __device__ __noinline__ void source_sample(const SourceParams& s, uint32_t kb,
                                                  uint32_t k0, uint32_t k1, int lane,
                                                  float out[6]) {
  uint32_t w[4];
  philox4x32_10((uint32_t)lane, kb, 0u, STREAM_REFILL, k0, k1, w);
  float x = s.uniform_xy ? to_unit(w[0]) : s.px;
  float y = s.uniform_xy ? to_unit(w[1]) : s.py;
  const float u_mu = to_unit(w[2]), u_phi = to_unit(w[3]);
  if (s.delta_x > 0.0f || s.delta_y > 0.0f) {
    philox4x32_10((uint32_t)lane, kb, 1u, STREAM_REFILL, k0, k1, w);
    if (s.delta_x > 0.0f) x = x + s.delta_x * (1.0f - 0.5f * to_unit(w[0]));
    if (s.delta_y > 0.0f) y = y + s.delta_y * (1.0f - 0.5f * to_unit(w[1]));
  }
  out[0] = s.x0 + x * s.wx;
  out[1] = s.y0 + y * s.wy;
  out[2] = s.z0 + s.pz * s.wz;
  if (!s.phi_random) {
    out[3] = s.dir[0];
    out[4] = s.dir[1];
    out[5] = s.dir[2];
    return;
  }
  float mu = s.mu;
  if (s.mu_mode == 1) mu = -sqrtf(u_mu);
  else if (s.mu_mode >= 2) mu = fmaxf(sqrtf(u_mu), s.min_mu);
  if (s.mu_mode == 3) mu = -mu;
  const float sin_theta = sqrtf(fmaxf(1.0f - mu * mu, 0.0f));
  const float phi = u_phi * s.two_pi;
  out[3] = sin_theta * cosf(phi);
  out[4] = sin_theta * sinf(phi);
  out[5] = mu;
}

static __device__ __forceinline__ void sample_source(const EventParams& p, int lane,
                                                     float out[6]) {
  source_sample(p.pro.src, p.kb, p.key0, p.key1, lane, out);
}

// The prologue of one block of the trace loop for the calling thread's own
// lane (see the note at the kernel): renormalize, flush, refill; returns the
// lane's alive flag after the refill.  Every thread of the CTA calls it.
// Not inlined, so that its registers do not add to the event loop's (inline
// it cost the column variant a resident CTA: 64 registers for 48).
static __device__ __noinline__ int block_prologue(const EventParams& p, float* f, int* iv,
                                                  bool gas, int* live_ids, int* warp_live,
                                                  int* cta_sum) {
  const int t = threadIdx.x, warp = t >> 5, wl = t & 31;
  const int lane0 = blockIdx.x * CTA_THREADS + t;
  const size_t L = (size_t)p.n_lanes;
  int alive0 = 0;
  const Prologue& q = p.pro;
  const int n_fbins = q.n_kinds * p.n_x * (q.col_y ? p.n_y : 1);
  const bool flush_smem = n_fbins <= CTA_THREADS;
  if (t == 0) cta_sum[0] = cta_sum[1] = 0;
  if (flush_smem) live_ids[t] = 0;
  __syncthreads();
  const bool in_range = lane0 < p.n_lanes;
  if (in_range) {
    alive0 = iv[lane0];
    const int pk = iv[2 * L + lane0];
    const float ux = f[3 * L + lane0], uy = f[4 * L + lane0], uz = f[5 * L + lane0];
    const float scale = rsqrtf(fmaxf(ux * ux + uy * uy + uz * uz, EPS12_F));
    f[3 * L + lane0] = ux * scale;
    f[4 * L + lane0] = uy * scale;
    f[5 * L + lane0] = uz * scale;
    if (pk != 0) {
      int c = min(max((int)((f[lane0] - p.x0) * p.inv_dx), 0), p.n_x - 1);
      if (q.col_y)
        c = c * p.n_y + min(max((int)((f[L + lane0] - p.y0) * p.inv_dy), 0), p.n_y - 1);
      if (pk <= q.n_kinds) {
        if (flush_smem) atomicAdd(&live_ids[c * q.n_kinds + pk - 1], 1);
        else tally_add(q.columns + (size_t)c * q.n_kinds + (pk - 1), 1.0);
      }
      if (q.vol_on && pk == 3) {
        const int iz =
            min(max((int)((f[2 * L + lane0] - p.z0) * q.inv_dz_cell), 0), q.n_z - 1);
        tally_add(q.vol + (size_t)c * q.n_z + iz, 1.0);
      }
      iv[2 * L + lane0] = 0;
    }
  }
  // The FIFO rank: dead lanes below this one in the CTA, and (while the
  // budget lasts, or in the last CTA) in the CTAs below.
  const long long launched = q.ctl[p.kb & 1u];
  const bool budget = launched < q.n_photons;
  const bool last = blockIdx.x == gridDim.x - 1;
  const bool dead = in_range && !alive0;
  const unsigned dead_mask = __ballot_sync(FULL_MASK, dead);
  if (wl == 0) warp_live[warp] = __popc(dead_mask);
  if (budget || last) {
    const int* dead_in = q.dead + (size_t)(p.kb & 1u) * gridDim.x;
    int below = 0;
    for (int k = t; k < (int)blockIdx.x; k += CTA_THREADS) below += dead_in[k];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) below += __shfl_xor_sync(FULL_MASK, below, o);
    if (wl == 0 && below) atomicAdd(&cta_sum[0], below);
  }
  __syncthreads();
  if (flush_smem && t < n_fbins && live_ids[t]) tally_add(q.columns + t, (double)live_ids[t]);
  int rank = __popc(dead_mask & ((1u << wl) - 1u)), cta_dead = 0;
#pragma unroll
  for (int w = 0; w < CTA_WARPS; ++w) {
    const int c = warp_live[w];
    rank += w < warp ? c : 0;
    cta_dead += c;
  }
  const long long base = launched + cta_sum[0];
  if (last && t == 0) {
    const long long total_dead = (long long)cta_sum[0] + cta_dead;
    const long long room = q.n_photons - launched;
    q.ctl[(p.kb + 1u) & 1u] = launched + (budget ? (total_dead < room ? total_dead : room) : 0);
    if (!budget && q.ctl[3] < 0) q.ctl[3] = (long long)p.kb;
    if (!budget && total_dead == (long long)p.n_lanes && q.ctl[2] < 0)
      q.ctl[2] = (long long)p.kb;
  }
  if (dead && budget && base + rank < q.n_photons) {
    float v[6];
    sample_source(p, lane0, v);
    f[lane0] = v[0];
    f[L + lane0] = v[1];
    f[2 * L + lane0] = v[2];
    f[3 * L + lane0] = v[3];
    f[4 * L + lane0] = v[4];
    f[5 * L + lane0] = v[5];
    f[6 * L + lane0] = 0.0f;
    if (gas) {
      uint32_t w[4];
      philox4x32_10((uint32_t)lane0, p.kb, 0u, STREAM_GAS, p.key0, p.key1, w);
      f[7 * L + lane0] = exponential_deviate(to_unit(w[0]));
    }
    iv[L + lane0] = 0;
    iv[lane0] = 1;
    alive0 = 1;
  }
  // The refilled rows are read below by other threads of the CTA, and the
  // shared arrays are used again.
  __syncthreads();
  return alive0;
}

// The prologue of a fused-k block (FK): block_prologue's steps, with two
// differences.  Each exit tallies with its k's weight (a CTA holds one k:
// its shared int32 counts are multiplied by that weight when they are
// added).  A dead lane's FIFO rank counts the dead lanes of its own k block
// only (its CTA's below it and the block's CTAs below its CTA): it takes a
// photon while launched_k + rank is below k's quota, with gcur = Gz of its
// k at its fresh height.  The block's last CTA writes k's new launched
// count; the grid's last CTA records the first kb at whose entry every k
// had launched its quota (ctl[3]) and, no lane alive either, ctl[2].  A
// function of its own: a branch inside block_prologue would change the
// callee that every other variant's registers are sized with.
static __device__ __noinline__ int block_prologue_fk(const EventParams& p, float* f, int* iv,
                                                     int* live_ids, int* warp_live,
                                                     int* cta_sum) {
  const int t = threadIdx.x, warp = t >> 5, wl = t & 31;
  const int lane0 = blockIdx.x * CTA_THREADS + t;
  const size_t L = (size_t)p.n_lanes;
  const Prologue& q = p.pro;
  const FusedK& fk = p.fk;
  const int k = fk.cta_k[blockIdx.x];
  const int c0 = fk.cta0[k];
  const double wk = (double)fk.w[k];
  int alive0 = 0;
  const int n_fbins = q.n_kinds * p.n_x * (q.col_y ? p.n_y : 1);
  const bool flush_smem = n_fbins <= CTA_THREADS;
  if (t == 0) cta_sum[0] = cta_sum[1] = 0;
  if (flush_smem) live_ids[t] = 0;
  __syncthreads();
  const bool in_range = lane0 < p.n_lanes;
  if (in_range) {
    alive0 = iv[lane0];
    const int pk = iv[2 * L + lane0];
    const float ux = f[3 * L + lane0], uy = f[4 * L + lane0], uz = f[5 * L + lane0];
    const float scale = rsqrtf(fmaxf(ux * ux + uy * uy + uz * uz, EPS12_F));
    f[3 * L + lane0] = ux * scale;
    f[4 * L + lane0] = uy * scale;
    f[5 * L + lane0] = uz * scale;
    if (pk != 0) {
      int c = min(max((int)((f[lane0] - p.x0) * p.inv_dx), 0), p.n_x - 1);
      if (q.col_y)
        c = c * p.n_y + min(max((int)((f[L + lane0] - p.y0) * p.inv_dy), 0), p.n_y - 1);
      if (pk <= q.n_kinds) {
        if (flush_smem) atomicAdd(&live_ids[c * q.n_kinds + pk - 1], 1);
        else tally_add(q.columns + (size_t)c * q.n_kinds + (pk - 1), wk);
      }
      if (q.vol_on && pk == 3) {
        const int iz =
            min(max((int)((f[2 * L + lane0] - p.z0) * q.inv_dz_cell), 0), q.n_z - 1);
        tally_add(q.vol + (size_t)c * q.n_z + iz, wk);
      }
      iv[2 * L + lane0] = 0;
    }
  }
  const unsigned par = p.kb & 1u;
  long long* launched_k = q.ctl + LAUNCHED_K;
  const long long launched = launched_k[2 * k + par];
  const long long quota = fk.quota[k];
  const bool budget = launched < quota;
  const bool last_k = (int)blockIdx.x == fk.cta0[k + 1] - 1;
  const bool last = blockIdx.x == gridDim.x - 1;
  const bool dead = in_range && !alive0;
  const unsigned dead_mask = __ballot_sync(FULL_MASK, dead);
  if (wl == 0) warp_live[warp] = __popc(dead_mask);
  const int* dead_in = q.dead + (size_t)par * gridDim.x;
  if (budget || last_k) {
    int below = 0;
    for (int c = c0 + t; c < (int)blockIdx.x; c += CTA_THREADS) below += dead_in[c];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) below += __shfl_xor_sync(FULL_MASK, below, o);
    if (wl == 0 && below) atomicAdd(&cta_sum[0], below);
  }
  // The grid's last CTA: the dead lanes of the CTAs before its block, and
  // whether some k has not launched its quota yet.
  int open = 0;
  if (last) {
    int before = 0;
    for (int c = t; c < c0; c += CTA_THREADS) before += dead_in[c];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) before += __shfl_xor_sync(FULL_MASK, before, o);
    if (wl == 0 && before) atomicAdd(&cta_sum[1], before);
    for (int j = t; j < fk.n_k; j += CTA_THREADS) open |= launched_k[2 * j + par] < fk.quota[j];
  }
  const bool any_open = __syncthreads_or(open) != 0;
  if (flush_smem && t < n_fbins && live_ids[t])
    tally_add(q.columns + t, (double)live_ids[t] * wk);
  int rank = __popc(dead_mask & ((1u << wl) - 1u)), cta_dead = 0;
#pragma unroll
  for (int w = 0; w < CTA_WARPS; ++w) {
    const int c = warp_live[w];
    rank += w < warp ? c : 0;
    cta_dead += c;
  }
  const long long base = launched + cta_sum[0];
  if (last_k && t == 0) {
    const long long total_dead = (long long)cta_sum[0] + cta_dead;
    const long long room = quota - launched;
    launched_k[2 * k + (par ^ 1u)] =
        launched + (budget ? (total_dead < room ? total_dead : room) : 0);
  }
  if (last && t == 0) {
    const long long grid_dead = (long long)cta_sum[1] + cta_sum[0] + cta_dead;
    if (!any_open && q.ctl[3] < 0) q.ctl[3] = (long long)p.kb;
    if (!any_open && grid_dead == (long long)p.n_lanes && q.ctl[2] < 0)
      q.ctl[2] = (long long)p.kb;
    cta_sum[1] = 0;                 // the kernel counts the lanes alive at exit there
  }
  if (dead && budget && base + rank < quota) {
    float v[6];
    sample_source(p, lane0, v);
    f[lane0] = v[0];
    f[L + lane0] = v[1];
    f[2 * L + lane0] = v[2];
    f[3 * L + lane0] = v[3];
    f[4 * L + lane0] = v[4];
    f[5 * L + lane0] = v[5];
    f[6 * L + lane0] = 0.0f;
    uint32_t w[4];
    philox4x32_10((uint32_t)lane0, p.kb, 0u, STREAM_GAS, p.key0, p.key1, w);
    f[7 * L + lane0] = exponential_deviate(to_unit(w[0]));
    f[8 * L + lane0] = fk_gas_read(p, k * fk.n_z, v[2]).y;
    iv[L + lane0] = 0;
    iv[lane0] = 1;
    alive0 = 1;
  }
  // The refilled rows are read below by other threads of the CTA, and the
  // shared arrays are used again.
  __syncthreads();
  return alive0;
}

// The BRDFs of i3rc_tpu_torch/core/surface.py (and of the JAX package's
// core/surface.py), operation by operation in their order: integer powers
// as products ((x*x)*(x*x) for x**4), float powers with powf, Smith's
// Lambda with erfcf, the clamps where the reference puts them.  Returns R
// for an arrival direction of z cosine mu_in and azimuth phi_in and an
// outgoing one (mu_out, phi_out).  Not inlined: called once per bottom hit
// and once per detector, out of the event loop's register budget.
static __device__ __noinline__ float brdf_reflectance(const SurfaceParams& sp, float mu_in,
                                                      float mu_out, float phi_in,
                                                      float phi_out) {
  const float* a = sp.params;
  if (sp.kind == BRDF_RPV) {
    const float rho0 = a[0], k = a[1], theta = a[2];
    const float mu_i = fabsf(mu_in), mu_r = fabsf(mu_out);
    const float sin_i = sqrtf(fmaxf(1.0f - mu_i * mu_i, 0.0f));
    const float sin_r = sqrtf(fmaxf(1.0f - mu_r * mu_r, 0.0f));
    const float cos_dphi = cosf(phi_in - phi_out);
    const float cos_g = mu_i * mu_r + sin_i * sin_r * cos_dphi;
    const float g_hg =
        (1.0f - theta * theta) / powf(1.0f + theta * theta + 2.0f * theta * cos_g, 1.5f);
    const float tan_i = sin_i / fmaxf(mu_i, EPS6_F);
    const float tan_r = sin_r / fmaxf(mu_r, EPS6_F);
    const float big_g =
        sqrtf(fmaxf(tan_i * tan_i + tan_r * tan_r - 2.0f * tan_i * tan_r * cos_dphi, 0.0f));
    const float hot = 1.0f + (1.0f - rho0) / (1.0f + big_g);
    const float m = powf(mu_i * mu_r * (mu_i + mu_r), k - 1.0f);
    return rho0 * m * g_hg * hot;
  }
  if (sp.kind == BRDF_COX_MUNK) {
    const float wind = a[0], n_re = a[1];
    const float mu_i = fmaxf(fabsf(mu_in), 0x1.0624dep-10f);     // 1e-3
    const float mu_r = fmaxf(fabsf(mu_out), 0x1.0624dep-10f);
    const float sin_i = sqrtf(fmaxf(1.0f - mu_i * mu_i, 0.0f));
    const float sin_r = sqrtf(fmaxf(1.0f - mu_r * mu_r, 0.0f));
    const float cos_dphi = cosf(phi_out - phi_in);
    const float dot_ir = sin_i * sin_r * cos_dphi - mu_i * mu_r;
    const float v_norm = sqrtf(fmaxf(2.0f - 2.0f * dot_ir, EPS12_F));
    const float cos_beta = fminf(fmaxf((mu_i + mu_r) / v_norm, 0x1.0624dep-10f), 1.0f);
    const float cos_w = fminf(fmaxf(0.5f * v_norm, EPS6_F), 1.0f);
    const float cb2 = cos_beta * cos_beta;
    const float tan2_beta = (1.0f - cb2) / cb2;
    const float sigma2 = 0x1.89374cp-9f + 0x1.4f8b58p-8f * wind;    // 0.003 + 0.00512 W
    const float slope_pdf = expf(-tan2_beta / sigma2) / (PI_F * sigma2);
    const float sin_w = sqrtf(fmaxf(1.0f - cos_w * cos_w, 0.0f));
    const float sin_t = fminf(fmaxf(sin_w / n_re, 0.0f), 1.0f);
    const float cos_t = sqrtf(fmaxf(1.0f - sin_t * sin_t, 0.0f));
    const float r_s = (cos_w - n_re * cos_t) / (cos_w + n_re * cos_t);
    const float r_p = (n_re * cos_w - cos_t) / (n_re * cos_w + cos_t);
    const float fresnel = 0.5f * (r_s * r_s + r_p * r_p);
    const float f_r = slope_pdf * fresnel / (4.0f * mu_i * mu_r * (cb2 * cb2));
    // Smith's shadowing for the same slopes: Lambda(a), a = cot / sigma.
    const float sigma = sqrtf(sigma2);
    float lam[2];
    const float mus[2] = {mu_i, mu_r};
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const float sin_th = sqrtf(fmaxf(1.0f - mus[k] * mus[k], EPS12_F));
      const float s_a = fmaxf(mus[k] / (sin_th * sigma), 0x1.a36e2ep-14f);   // 1e-4
      lam[k] = 0.5f * (expf(-s_a * s_a) / (s_a * SQRT_PI_F) - erfcf(s_a));
    }
    const float shadow = 1.0f / (1.0f + lam[0] + lam[1]);
    return PI_F * f_r * shadow;
  }
  if (sp.kind == BRDF_ROSS_LI) {
    const float f_iso = a[0], f_vol = a[1], f_geo = a[2];
    const float mu_i = fmaxf(fabsf(mu_in), 0x1.0624dep-10f);
    const float mu_r = fmaxf(fabsf(mu_out), 0x1.0624dep-10f);
    const float sin_i = sqrtf(fmaxf(1.0f - mu_i * mu_i, 0.0f));
    const float sin_r = sqrtf(fmaxf(1.0f - mu_r * mu_r, 0.0f));
    const float cos_rel = -cosf(phi_out - phi_in);
    const float sin_rel = sinf(phi_out - phi_in);
    const float cos_xi = fminf(fmaxf(mu_i * mu_r + sin_i * sin_r * cos_rel, -1.0f), 1.0f);
    const float xi = acosf(cos_xi);
    const float k_vol = ((HALF_PI_F - xi) * cos_xi + sinf(xi)) / (mu_i + mu_r) - QUARTER_PI_F;
    const float tan_i = sin_i / mu_i;
    const float tan_r = sin_r / mu_r;
    const float sec_i = 1.0f / mu_i;
    const float sec_r = 1.0f / mu_r;
    const float d2 =
        fmaxf(tan_i * tan_i + tan_r * tan_r - 2.0f * tan_i * tan_r * cos_rel, 0.0f);
    const float tts = tan_i * tan_r * sin_rel;
    const float cos_t =
        fminf(fmaxf(2.0f * sqrtf(d2 + tts * tts) / (sec_i + sec_r), -1.0f), 1.0f);
    const float t_ov = acosf(cos_t);
    const float overlap = (t_ov - sinf(t_ov) * cos_t) * (sec_i + sec_r) / PI_F;
    const float k_geo = overlap - sec_i - sec_r + 0.5f * (1.0f + cos_xi) * sec_i * sec_r;
    return fmaxf(f_iso + f_vol * k_vol + f_geo * k_geo, 0.0f);
  }
  return a[0];                    // BRDF_LAMBERTIAN
}

// State layout (i3rc_tpu_torch/kernels/event_block.py LaneState):
//   f: (8, L) float32 rows x, y, z, ux, uy, uz, tau, tgas (FK: (9, L), row 8 gcur)
//   i: (5, L) int32   rows alive, orders, pk, bad, evct
// acc (DET): (n_cols, D) float64 detector accumulator, added to.
// col (COL): (n_cols, 4) float32 column table [v, z_base, z_top, 0], with TAB
// [v, z_base, z_top, ssa].
// The detector tally (DET) goes to one of three places, chosen per launch by
// hist_room: with SLICES, CTA_WARPS private slices of n_bins doubles in
// dynamic shared memory; without, one CTA histogram there (hist_in_smem), or
// the global accumulator itself.
//
// With p.pro.on the launch is one whole block of the trace loop: before the
// events each thread, for its own lane and in the loop's order,
//  * rescales the direction to unit length (every lane, dead ones too, as
//    the plain version does);
//  * flushes a pending exit (pk != 0) at the lane's frozen position: one
//    count into columns[col, pk - 1], and into vol[col * n_z + iz] for a
//    kind-3 death when the volume tally is on, then pk = 0.  The counts are
//    float64 ones, so the order of the adds does not show.  Up to
//    CTA_THREADS bins (the step cloud: 64 or 96) the CTA counts in shared
//    int32 first (the lane-id array, not yet in use) and adds its nonzero
//    bins; wider tallies (Landsat: 32768 bins) add straight to device memory;
//  * refills: dead lane l takes photon launched + rank(l), rank its
//    exclusive count of dead lanes over the grid, while that id is below
//    the budget: a source sample at (lane, kb, group, STREAM_REFILL), tau 0,
//    orders 0, alive, and with GAS the gas threshold at (lane, kb, 0,
//    STREAM_GAS).  Only a lane that takes draws.  The rank needs no scan
//    kernel: every launch leaves its CTAs' dead counts at exit in
//    dead[(kb + 1) & 1], and CTA c of the next sums the entries below c.
//    Launch kb reads slot kb & 1 of `dead` and of `launched` and writes the
//    other, so no CTA reads what another has replaced.  The last CTA, whose
//    sum is the grid's, writes the new `launched`; it also records the
//    first kb at whose entry the budget was spent (ctl[3]) and, for the
//    host's loop check, the first at whose entry no lane was alive either
//    (ctl[2]).  Once the budget is spent only the last CTA sums.
// Over a reflecting surface the launch is followed on its stream by
// fast_event_block_surface_kernel (fast_event_block.cu), which rewrites each
// CTA's dead count after the bounce; a BRDF plan's weight (p.srf.w) scales
// DET's contributions.
template <int CHAIN, bool ABS, bool TY, bool DET, bool IW, bool GAS, bool COL, bool SLICES,
          int DCAP, bool TAB, bool FK, bool MARCH>
__device__ __forceinline__ void event_block(float* __restrict__ f, int* __restrict__ iv,
                                            double* acc, const float4* __restrict__ col,
                                            int hist_in_smem, const EventParams& p) {
  extern __shared__ double smem_hist[];
  __shared__ int live_ids[CTA_THREADS];
  __shared__ int warp_live[CTA_WARPS];
  __shared__ int cta_sum[2];      // dead lanes below this CTA; lanes alive at exit
  const int t = threadIdx.x, warp = t >> 5, wl = t & 31;
  const int lane0 = blockIdx.x * CTA_THREADS + t;
  const size_t L = (size_t)p.n_lanes;
  constexpr int BD = ABS ? 4 : 3;
  // Draw slots: with DET && IW the count depends on the runtime D, so the
  // register array is sized for DCAP detectors and only G groups are drawn.
  // The runtime-depth variant (CHAIN < 0) holds the event's first BD draws
  // and draws its bonus phases as it runs them (phase_draws); its groups an
  // event follow the runtime depth.
  constexpr int ND_MAX = DET ? (IW ? BD + DCAP : BD) : BD * (1 + (CHAIN < 0 ? 0 : CHAIN));
  constexpr int G_MAX = (ND_MAX + 3) / 4;
  const int G = (DET && IW) ? (BD + p.det.n + 3) / 4
                : CHAIN < 0 ? (BD * (1 + p.chain) + 3) / 4 : G_MAX;
  const int n_bins = DET ? p.det.n_bins : 0;
  const bool in_smem = DET && (SLICES || hist_in_smem);
  const int n_slices = SLICES ? CTA_WARPS : 1;
  // Draws as read, per warp, in the column variant with chaining only (see
  // the source note).
  constexpr bool LAZY = COL && CHAIN != 0;
  const bool pro = p.pro.on != 0;

  if (in_smem)
    for (int k = t; k < n_slices * n_bins; k += CTA_THREADS) smem_hist[k] = 0.0;
  if constexpr (MARCH) {
    if (t == 0) march_q()[0] = march_q()[1] = 0;
  }

  int alive0 = 0;
  if (pro) {
    if constexpr (FK)
      alive0 = block_prologue_fk(p, f, iv, live_ids, warp_live, cta_sum);
    else
      alive0 = block_prologue(p, f, iv, GAS, live_ids, warp_live, cta_sum);
  } else if (lane0 < p.n_lanes) {
    alive0 = iv[lane0];
  }

  // Entry: a thread needs its lane's alive flag and tau only.  A dead lane's
  // one change in the block is the contract's free-path draw at event 0.
  if (lane0 < p.n_lanes && !alive0 && !(f[6 * L + lane0] > 0.0f))
    f[6 * L + lane0] = contract_tau(p, lane0, 0, G);
  // Compaction: a prefix sum over the CTA's live flags packs the live lanes'
  // ids, in lane order, onto the first threads.
  const unsigned live_mask = __ballot_sync(FULL_MASK, alive0 != 0);
  if (wl == 0) warp_live[warp] = __popc(live_mask);
  __syncthreads();
  int base = 0, n_live = 0;
#pragma unroll
  for (int w = 0; w < CTA_WARPS; ++w) {
    const int c = warp_live[w];
    base += w < warp ? c : 0;
    n_live += c;
  }
  if (alive0) live_ids[base + __popc(live_mask & ((1u << wl) - 1u))] = lane0;
  __syncthreads();

  // The first ceil(n_live / 32) warps run the live lanes; threads past
  // n_live in the last of them idle as dead lanes (alive 0, tau 1).
  if (t < ((n_live + 31) & ~31)) {
    const bool valid = t < n_live;
    const int lane = valid ? live_ids[t] : 0;
    Lane s = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 1.0f, 0.0f, 0, 0, 0, 0, 0};
    if (valid) {
      s.x = f[0 * L + lane];
      s.y = TY ? f[1 * L + lane] : 0.0f;
      s.z = f[2 * L + lane];
      s.ux = f[3 * L + lane];
      s.uy = f[4 * L + lane];
      s.uz = f[5 * L + lane];
      s.tau = f[6 * L + lane];
      s.tgas = GAS ? f[7 * L + lane] : 0.0f;
      if (FK) s.gcur = f[8 * L + lane];
      s.alive = iv[0 * L + lane];
      s.orders = iv[1 * L + lane];
      s.pk = iv[2 * L + lane];
      s.bad = iv[3 * L + lane];
      s.evct = iv[4 * L + lane];
    }
    double* hist = SLICES ? smem_hist + warp * n_bins : (in_smem ? smem_hist : acc);

#pragma unroll 1
    for (int j = 0; j < p.K; ++j) {
      if (!__any_sync(FULL_MASK, s.alive != 0)) {
        // Every lane of the warp is dead: this event's only change is the
        // contract's draw, for the lanes that died with tau <= 0.
        if (!(s.tau > 0.0f)) s.tau = contract_tau(p, lane, j, G);
        break;
      }
      float u[4 * G_MAX];
      Draws dr{lane, j * G, 0u};
      start_draws<LAZY>(u, p, dr, G);
      fast_event<CHAIN, ABS, TY, DET, IW, GAS, COL, SLICES, LAZY, TAB, FK, MARCH>(p, u, dr, s,
                                                                                 hist, col);
    }

    if (valid) {
      f[0 * L + lane] = s.x;
      if (TY) f[1 * L + lane] = s.y;
      f[2 * L + lane] = s.z;
      f[3 * L + lane] = s.ux;
      f[4 * L + lane] = s.uy;
      f[5 * L + lane] = s.uz;
      f[6 * L + lane] = s.tau;
      if (GAS) f[7 * L + lane] = s.tgas;
      if (FK) f[8 * L + lane] = s.gcur;
      iv[0 * L + lane] = s.alive;
      iv[1 * L + lane] = s.orders;
      iv[2 * L + lane] = s.pk;
      iv[3 * L + lane] = s.bad;
      iv[4 * L + lane] = s.evct;
    }
    if (pro) {
      const int n_alive = __popc(__ballot_sync(FULL_MASK, valid && s.alive != 0));
      if (wl == 0 && n_alive) atomicAdd(&cta_sum[1], n_alive);
    }
  }

  if constexpr (MARCH) {
    // The queued rays, traced by every thread of the CTA (march_flush).
    __syncthreads();
    march_flush<IW, TAB, SLICES>(
        p, SLICES ? smem_hist + warp * n_bins : (in_smem ? smem_hist : acc), BD);
  }
  if (in_smem || pro) __syncthreads();
  if (pro && t == 0) {
    // The CTA's dead lanes at exit: the next launch's FIFO ranks.
    const int n_here = min(CTA_THREADS, p.n_lanes - (int)blockIdx.x * CTA_THREADS);
    p.pro.dead[(size_t)((p.kb + 1u) & 1u) * gridDim.x + blockIdx.x] = n_here - cta_sum[1];
  }
  if (in_smem) {
    // One global atomicAdd per nonzero bin: the sum of the CTA's slices.
    for (int k = t; k < n_bins; k += CTA_THREADS) {
      double v = 0.0;
      for (int w = 0; w < n_slices; ++w) v += smem_hist[w * n_bins + k];
      if (v != 0.0) atomicAdd(acc + k, v);
    }
  }
}

template <int CHAIN, bool ABS, bool TY, bool DET, bool IW, bool GAS, bool COL, bool SLICES,
          int DCAP, bool TAB, bool FK>
__global__ void __launch_bounds__(CTA_THREADS)
fast_event_block_kernel(float* __restrict__ f, int* __restrict__ iv, double* acc,
                        const float4* __restrict__ col, int hist_in_smem,
                        const __grid_constant__ EventParams p) {
  event_block<CHAIN, ABS, TY, DET, IW, GAS, COL, SLICES, DCAP, TAB, FK, false>(
      f, iv, acc, col, hist_in_smem, p);
}

// K3-M: the detector block of a plan with the marching shadow trace
// (DET, neither GAS, COL nor FK, CHAIN 0), its rays traced from the CTA's
// queue after the lanes' events (march_flush), instantiated in
// fast_event_block_march.cu (HG) and fast_event_block_tab_march.cu (TAB).
template <int CHAIN, bool ABS, bool TY, bool DET, bool IW, bool GAS, bool COL, bool SLICES,
          int DCAP, bool TAB, bool FK>
__global__ void __launch_bounds__(CTA_THREADS)
fast_event_block_kernel_march(float* __restrict__ f, int* __restrict__ iv, double* acc,
                              const float4* __restrict__ col, int hist_in_smem,
                              const __grid_constant__ EventParams p) {
  static_assert(CHAIN == 0 && DET && !GAS && !COL && !FK, "K3-M is the detector block");
  event_block<CHAIN, ABS, TY, DET, IW, GAS, COL, SLICES, DCAP, TAB, FK, true>(
      f, iv, acc, col, hist_in_smem, p);
}

// Where the detector tally of n_bins goes: CTA_WARPS private slices while
// they fit, beside the static arrays, in the shared memory a CTA gets without
// opting in (<= 751 bins); else one CTA histogram of up to 48 KB (<= 6144
// bins), opting in past the default; else the global accumulator.
enum HistRoom { HIST_GLOBAL, HIST_SHARED, HIST_SLICES };

static HistRoom hist_room(int n_bins) {
  const size_t bytes = (size_t)n_bins * sizeof(double);
  if (CTA_WARPS * bytes + SMEM_STATIC_BYTES <= SMEM_DEFAULT_BYTES) return HIST_SLICES;
  if (bytes <= SMEM_ONE_HIST_BYTES) return HIST_SHARED;
  return HIST_GLOBAL;
}

// The kernel of a variant: fast_event_block_kernel, or with MARCH
// fast_event_block_kernel_march.
template <int CHAIN, bool ABS, bool TY, bool DET, bool IW, bool GAS, bool COL, bool SLICES,
          int DCAP, bool TAB, bool FK, bool MARCH>
static auto block_kernel() {
  if constexpr (MARCH)
    return fast_event_block_kernel_march<CHAIN, ABS, TY, DET, IW, GAS, COL, SLICES, DCAP, TAB,
                                         FK>;
  else
    return fast_event_block_kernel<CHAIN, ABS, TY, DET, IW, GAS, COL, SLICES, DCAP, TAB, FK>;
}

template <int CHAIN, bool ABS, bool TY, bool DET, bool IW, bool GAS, bool COL = false,
          int DCAP = DET_DRAWS_SMALL, bool TAB = false, bool FK = false, bool MARCH = false>
static void launch(float* f, int* i, double* acc, const EventParams& p,
                   cudaStream_t stream, const float4* col = nullptr) {
  const int blocks = (p.n_lanes + CTA_THREADS - 1) / CTA_THREADS;
  const HistRoom room = DET ? hist_room(p.det.n_bins) : HIST_GLOBAL;
  const size_t bytes = DET ? (size_t)p.det.n_bins * sizeof(double) : 0;
  if constexpr (DET) {
    if (room == HIST_SLICES) {
      const auto sliced =
          block_kernel<CHAIN, ABS, TY, DET, IW, GAS, COL, true, DCAP, TAB, FK, MARCH>();
      sliced<<<blocks, CTA_THREADS, CTA_WARPS * bytes, stream>>>(f, i, acc, col, 1, p);
      return;
    }
  }
  const auto kernel =
      block_kernel<CHAIN, ABS, TY, DET, IW, GAS, COL, false, DCAP, TAB, FK, MARCH>();
  const size_t smem = room == HIST_SHARED ? bytes : 0;
  if (smem + SMEM_STATIC_BYTES > SMEM_DEFAULT_BYTES)
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  kernel<<<blocks, CTA_THREADS, smem, stream>>>(f, i, acc, col, room == HIST_SHARED, p);
}

template <int CHAIN, bool DET, bool IW, bool GAS, int DCAP, bool TAB, bool FK = false,
          bool MARCH = false>
static void launch_flags(float* f, int* i, double* acc, const EventParams& p,
                         bool absorbing, bool track_y, cudaStream_t stream) {
  if (absorbing) {
    if (track_y)
      launch<CHAIN, true, true, DET, IW, GAS, false, DCAP, TAB, FK, MARCH>(f, i, acc, p, stream);
    else
      launch<CHAIN, true, false, DET, IW, GAS, false, DCAP, TAB, FK, MARCH>(f, i, acc, p, stream);
  } else {
    if (track_y)
      launch<CHAIN, false, true, DET, IW, GAS, false, DCAP, TAB, FK, MARCH>(f, i, acc, p, stream);
    else
      launch<CHAIN, false, false, DET, IW, GAS, false, DCAP, TAB, FK, MARCH>(f, i, acc, p,
                                                                           stream);
  }
}

// The runtime-depth variants (CHAIN_RUNTIME), instantiated in
// fast_event_block_deep.cu: flux at chain depth p.chain = chain >= 1, with or
// without the gas channel, HG or table; and the column ones.  False for
// another depth.
bool launch_block_deep(float* f, int* i, double* acc, const EventParams& p, int chain, bool gas,
                       bool table, bool absorbing, bool track_y, cudaStream_t stream);
bool launch_block_col_deep(float* f, int* i, const float4* col, const EventParams& p, int chain,
                           bool absorbing, bool table, cudaStream_t stream);

// One block (p.K events, any K >= 1) of the variant the flags name, with the
// gas channel (GAS = true) or without it, HG or table (TAB): flux at chain
// depth 0-3 (deeper: launch_block_deep), or the detector variant (always
// chain depth 0, up to MAX_DETECTORS detectors) with or without Iwabuchi;
// fused-k (FK, with GAS) at chain depth 0 only.  False for a chain depth or a detector count that
// is not built; the Python wrapper refuses those first (launch_refusal).
template <bool GAS, bool TAB, bool FK = false>
static bool launch_block(float* f, int* i, double* acc, const EventParams& p, int chain,
                         bool absorbing, bool track_y, bool detectors, bool iwabuchi,
                         cudaStream_t stream) {
  constexpr int DS = DET_DRAWS_SMALL;
  if (p.K < 1) return false;
  if (detectors) {
    if (chain != 0 || p.det.n < 1 || p.det.n > MAX_DETECTORS || acc == nullptr)
      return false;
    if (!iwabuchi)
      launch_flags<0, true, false, GAS, DS, TAB, FK>(f, i, acc, p, absorbing, track_y, stream);
    else if (p.det.n <= DET_DRAWS_SMALL)
      launch_flags<0, true, true, GAS, DS, TAB, FK>(f, i, acc, p, absorbing, track_y, stream);
    else
      launch_flags<0, true, true, GAS, MAX_DETECTORS, TAB, FK>(f, i, acc, p, absorbing,
                                                               track_y, stream);
    return true;
  }
  if constexpr (FK) {
    if (chain != 0) return false;
    launch_flags<0, false, false, GAS, DS, TAB, FK>(f, i, acc, p, absorbing, track_y, stream);
  } else {
    switch (chain) {
      case 0: launch_flags<0, false, false, GAS, DS, TAB>(f, i, acc, p, absorbing, track_y, stream); break;
      case 1: launch_flags<1, false, false, GAS, DS, TAB>(f, i, acc, p, absorbing, track_y, stream); break;
      case 2: launch_flags<2, false, false, GAS, DS, TAB>(f, i, acc, p, absorbing, track_y, stream); break;
      case 3: launch_flags<3, false, false, GAS, DS, TAB>(f, i, acc, p, absorbing, track_y, stream); break;
      default:
        return launch_block_deep(f, i, acc, p, chain, GAS, TAB, absorbing, track_y, stream);
    }
  }
  return true;
}

// K3-M, the detector block with the marching shadow trace (HG or TAB, with
// or without IW; chain depth 0, no gas channel): false for a detector count
// that is not built.
template <bool TAB>
static bool launch_block_marching(float* f, int* i, double* acc, const EventParams& p,
                                  bool absorbing, bool track_y, bool iwabuchi,
                                  cudaStream_t stream) {
  constexpr int DS = DET_DRAWS_SMALL;
  if (p.K < 1 || p.det.n < 1 || p.det.n > MAX_DETECTORS || acc == nullptr ||
      p.det.march_steps < 1 || p.rays == nullptr)
    return false;
  if (!iwabuchi)
    launch_flags<0, true, false, false, DS, TAB, false, true>(f, i, acc, p, absorbing, track_y,
                                                              stream);
  else if (p.det.n <= DET_DRAWS_SMALL)
    launch_flags<0, true, true, false, DS, TAB, false, true>(f, i, acc, p, absorbing, track_y,
                                                             stream);
  else
    launch_flags<0, true, true, false, MAX_DETECTORS, TAB, false, true>(f, i, acc, p, absorbing,
                                                                        track_y, stream);
  return true;
}

// The gas variants, instantiated in fast_event_block_gas.cu; the table
// variants without and with the gas channel, in fast_event_block_tab.cu and
// fast_event_block_tab_gas.cu.
bool launch_block_gas(float* f, int* i, double* acc, const EventParams& p, int chain,
                      bool absorbing, bool track_y, bool detectors, bool iwabuchi,
                      cudaStream_t stream);
bool launch_block_tab(float* f, int* i, double* acc, const EventParams& p, int chain,
                      bool absorbing, bool track_y, bool detectors, bool iwabuchi,
                      cudaStream_t stream);
bool launch_block_tab_gas(float* f, int* i, double* acc, const EventParams& p, int chain,
                          bool absorbing, bool track_y, bool detectors, bool iwabuchi,
                          cudaStream_t stream);
// The fused-k variants of the gas ones, HG and table, instantiated in
// fast_event_block_fk.cu and fast_event_block_tab_fk.cu.
bool launch_block_fk(float* f, int* i, double* acc, const EventParams& p, int chain,
                     bool absorbing, bool track_y, bool detectors, bool iwabuchi,
                     cudaStream_t stream);
bool launch_block_tab_fk(float* f, int* i, double* acc, const EventParams& p, int chain,
                         bool absorbing, bool track_y, bool detectors, bool iwabuchi,
                         cudaStream_t stream);
// K3-M, HG and table, instantiated in fast_event_block_march.cu and
// fast_event_block_tab_march.cu.
bool launch_block_march(float* f, int* i, double* acc, const EventParams& p, bool absorbing,
                        bool track_y, bool iwabuchi, cudaStream_t stream);
bool launch_block_tab_march(float* f, int* i, double* acc, const EventParams& p,
                            bool absorbing, bool track_y, bool iwabuchi, cudaStream_t stream);

// The column variants (flux, y tracked), HG or table, instantiated in
// fast_event_block_col.cu.
bool launch_block_col(float* f, int* i, const float4* col, const EventParams& p, int chain,
                      bool absorbing, bool table, cudaStream_t stream);
