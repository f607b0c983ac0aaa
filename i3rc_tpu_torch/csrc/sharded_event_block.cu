// The x-sharded domain tracer's kernels (kernels/sharded_block.py):
//
//  * SD, sharded_event_block_kernel: one whole block of the trace loop on
//    one rank's x-slab, in one launch.  It replaces no TPU kernel: the JAX
//    package runs the block as XLA (`event`,
//    i3rc_tpu/parallel/sharded_domain.py:230-363, K of them unrolled in the
//    body of the lax.while_loop at :713, and the glue of that body around
//    them).  One thread a lane, in the order of the plain version
//    (sharded_block_reference):
//     - prologue: the rows the host sent after the last block leave (their
//       tags clear; a sent ray frees its pool slot); the rows that arrive in
//       each direction, +1 before -1 (the inbox's waiting rows, then the
//       received ones), take the pool's free slots in the order of the last
//       pack (rays) and the free lanes in lane order (photons), the rest
//       waiting in the next parity's inbox; the FIFO refill of the next
//       free lanes, keeping RESERVE free, with the source sample at (lane,
//       kb, STREAM_REFILL).  A lane's rank needs the free and tagged lanes
//       of the tiles below it: the last launch left each tile's counts and
//       tag prefixes in `tiles`, so a CTA sums those below it and scans its
//       own (as the fast event block's prologue ranks its refill);
//     - the K maximum cross-section events of each live lane, its state in
//       registers: the free path (drawn when the carried optical depth is
//       spent), the flight under the global majorant to the first of the
//       tentative collision, the z exit and the slab's x faces (a migrant is
//       put past its face, wrapped at the domain's x edge, tagged +1 / -1
//       and keeps its remaining optical depth), the y wrap, the local cell
//       read (one row of 1 + 3 C floats: extinction, cumulative fractions,
//       albedos, table rows), the physical-or-null test, the component pick
//       by cumulative extinction, Bernoulli absorption, with detectors the
//       per-detector prefactor w ssa P / (4 pi |mu_d|) of every physical
//       collision from the replicated log-cubic forward fit (the lane then
//       freezes until the drain moves its record into the shadow-ray
//       pool), the cosine from the replicated cubic inverse CDF, the
//       rotation and its renormalization, and the event budget.  A lane
//       stops at the first event that ends its flight in the slab;
//     - epilogue: the flush of the block's exits and deaths into the float64
//       column (and volume) tallies, a warp's lanes of one bin summed before
//       the add (warp_red); over a reflecting surface each bottom hit's
//       record and its Bernoulli revive at (lane, kb, 0, STREAM_SURFACE); pk
//       cleared; the drain of pending records into the pool's free slots
//       after the placed rays, D slots a record, in lane order; the first
//       CAP tagged photons of each direction, in lane order, into the next
//       parity's send buffer; each tile's counts for the next prologue; and
//       this rank's row of the counts vector (busy lanes, tagged photons,
//       free lanes, and the host's entries), written by the CTA that
//       finishes last.  The lane order of the drain and of the send buffers
//       needs the pending and tagged lanes of the tiles below, from this
//       launch: a CTA takes its tile from a ticket counter in the order the
//       CTAs start, publishes its counts, and looks back over the tiles
//       below (a decoupled look-back, as a single-pass scan does): every
//       tile below is held by a CTA that started first, so none waits on a
//       CTA that has not started.
//  * SR, shadow_advance_kernel: K exact cell-DDA steps of every shadow ray
//    in flight in the rank's pool (sharded_domain.py:464-530, unrolled K
//    times in the same body): the optical depth of the cell crossed, a ray
//    past the slab's x face tagged to migrate (its tau carried), and an
//    escaping ray's w exp(-tau) added to its exit column's float64
//    radiance tallies, total and by component slot.  The lanes of a warp
//    that add to one bin are summed first and one lane adds the sum
//    (warp_red: a bin's lanes crowd when every ray of a detector leaves
//    through few columns; one float64 atomic a lane cost PZ 4x, PERF.md).
//  * SP, shadow_pack_kernel, after SR: the pool's free slots in slot order
//    (the next prologue's and drain's slots), the first CAP tagged rays of
//    each direction in slot order into the send buffer with their slots,
//    and the ray side of this rank's row of the counts vector (the same
//    tickets and look-back).
// So a block is SD, and with detectors SR and SP, and the host reads one
// counts vector a block (all-reduced over the ranks) and exchanges the
// planned prefix of each send buffer.
//
// Draws (SD): event j of block kb reads Philox4x32-10 groups 2j and 2j + 1
// at counter (lane, kb, group, STREAM_EVENT) under the key (seed, rank):
// u0-u3 the first group's words, u4-u6 the second's (free path,
// acceptance, absorption, cosine, azimuth, -, component), the twin's
// philox_uniforms(key, kb, K, 7, L) layout.  SR and SP draw nothing.
//
// What bounds them.  SD per live lane-event: two Philox calls (~200
// integer operations), a logf where a new free path is drawn, four IEEE
// divisions for the face distances, the 4 + 12 C byte cell row, and per
// collision the 16-byte cubic row, the rotation's square roots and
// division, and per detector acosf, a 16-byte forward row and expf; the
// lane state (7 + D floats and 9 ints) is read and written once a launch,
// and the glue reads every lane's flags.  SR per ray step: the 4-byte
// extinction of the cell, three divisions and the moves; per escape expf
// and two float64 adds.  SP reads every slot's two flags.
//
// Float arithmetic follows the twins (sharded_block.sharded_event,
// shadow_step and the block's glue) operation by operation, built with
// --fmad=false.

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

// kernels/sharded_block.py: a migrating row's fields, the counts vector's
// entries and the tiles' rows.
#define PH_FIELDS 8
#define Q_FIELDS 6
#define C_WORK 0
#define C_BUSY_PH 1
#define C_BUSY_Q 2
#define C_SPACE_PH 3
#define C_SPACE_Q 5
#define C_WAIT_PH 7
#define C_WAIT_Q 9
#define C_FREE_PH 11
#define C_FREE_Q 12
#define N_COUNTS 13
#define T_FREE 0
#define T_HI 1
#define T_LO 2
#define T_PRE_HI 3
#define T_PRE_LO 4
#define T_BUSY 5
#define N_TILE_ROWS 6
#define SHARD_STATUS_INTS 16

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
  // The whole block (SD) and the pack (SP): the buffers of
  // kernels/sharded_block.py ShardBuffers, [0] of a direction +1, [1] -1.
  float* pool_f;         // (5, n_rays)
  int* pool_i;           // (4, n_rays)
  float* send_ph;        // (2, 2, cap, PH_FIELDS): [parity, direction]
  float* send_q;         // (2, cap, Q_FIELDS)
  const float* recv_ph;  // (2, cap, PH_FIELDS): this block's received photons
  const float* recv_q;   // (2, cap, Q_FIELDS)
  float* inbox_ph;       // (2, 2, inbox, PH_FIELDS): [parity, direction]
  float* inbox_q;        // (2, 2, inbox, Q_FIELDS)
  int* tag_q;            // (2, cap): the pool slot of each ray in send_q
  int* free_q;           // (n_rays): the pool's free slots in slot order
  int* tiles;            // (2, N_TILE_ROWS, n_tiles): [parity]
  int* status;           // (n_tiles, SHARD_STATUS_INTS): this kernel's look-back
  int* ctl;              // this kernel's ticket counter and finished tiles
  long long* counts;     // (n_ranks, N_COUNTS)
  double* columns;       // (nx_loc * n_y, 3) flux tallies: up, down, absorbed
  double* vol;           // (nx_loc * n_y * n_z) volume tally, with vol_on
  const float* surf_pf;  // (n_dirs) a bottom hit's prefactors, with surface and detectors
  int n_rays, cap, inbox, rank, n_ranks, epoch, vol_on, surface;
  // The host's plan of this block (kernels/sharded_block.py BlockPlan).
  int sent_ph[2], sent_q[2], n_in_ph[2], n_rx_ph[2], placed_ph[2];
  int n_in_q[2], n_rx_q[2], placed_q[2];
  int n_new, drain_cap, work, space_ph[2], space_q[2];
  float albedo;          // f32(albedo): the revive test
  float z_revive;        // f32(z0 + nudge): a revived lane's height
  SourceParams src;      // the refill's source (x scaled to the slab)
};

__device__ __forceinline__ int sd_row(const ShardParams& p, float x, float y, float z) {
  const int ix = min(max((int)((x - p.x_lo) * p.inv_dx), 0), p.nx_loc - 1);
  const int iy = min(max((int)((y - p.y0) * p.inv_dy), 0), p.n_y - 1);
  const int iz = min(max((int)((z - p.z0) * p.inv_dz), 0), p.n_z - 1);
  return (ix * p.n_y + iy) * p.n_z + iz;
}

// The CTA's tile: a ticket in the order the CTAs start (see the note above).
__device__ __forceinline__ int take_tile(int* ctl) {
  __shared__ int tile;
  if (threadIdx.x == 0) tile = atomicAdd(ctl, 1);
  __syncthreads();
  return tile;
}

// The exclusive ranks of N flags over the CTA's threads, and the CTA's
// totals.  Every thread of the CTA calls it.
template <int N>
__device__ __forceinline__ void cta_ranks(const bool (&flag)[N], int (&rank)[N], int (&total)[N]) {
  __shared__ int sw[CTA_WARPS][N];
  const int warp = threadIdx.x >> 5, wl = threadIdx.x & 31;
#pragma unroll
  for (int q = 0; q < N; ++q) {
    const unsigned m = __ballot_sync(FULL_MASK, flag[q]);
    if (wl == 0) sw[warp][q] = __popc(m);
    rank[q] = __popc(m & ((1u << wl) - 1u));
  }
  __syncthreads();
#pragma unroll
  for (int q = 0; q < N; ++q) {
    int tot = 0;
    for (int w = 0; w < CTA_WARPS; ++w) {
      const int c = sw[w][q];
      rank[q] += w < warp ? c : 0;
      tot += c;
    }
    total[q] = tot;
  }
  __syncthreads();
}

// The CTA's sum of v.  Every thread of the CTA calls it.
__device__ __forceinline__ int cta_sum(int v) {
  __shared__ int sw[CTA_WARPS];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL_MASK, v, o);
  if ((threadIdx.x & 31) == 0) sw[threadIdx.x >> 5] = v;
  __syncthreads();
  int tot = 0;
  for (int w = 0; w < CTA_WARPS; ++w) tot += sw[w];
  __syncthreads();
  return tot;
}

// Decoupled look-back over the tiles in ticket order: publishes the tile's
// V counts (agg), then looks at the 32 tiles below it at a time, one a lane
// of warp 0, each lane waiting until its tile has published: the nearest of
// them with its inclusive prefix ends the look-back (its prefix and the
// aggregates of the tiles above it are the sum), else the window's
// aggregates are summed and the next 32 below are read.  Returns the sums
// of the tiles below (excl) and publishes the tile's inclusive prefix.  A
// record is the flag (epoch << 2 | 1 aggregate, | 2 inclusive), the
// aggregates and the inclusive prefixes; the epoch, unique to a launch,
// makes a record of an earlier launch read as not yet written.  Looking
// back one tile at a time (thread 0 alone) made a Landsat launch of 2^20
// lanes 0.37 ms against 0.15 for its events (H100, PERF.md section 6): the
// prefixes crossed the grid a tile a memory round trip.  Every thread of the
// CTA calls it.  A function of its own (noinline), so that its registers
// stay out of SD's event loop (inlined, SD bounded to 64 registers spilled
// 16 bytes).
template <int V>
static __device__ __noinline__ void look_back(int* status, int epoch, int tile,
                                              const int (&agg)[V], int (&excl)[V]) {
  static_assert(1 + 2 * V <= SHARD_STATUS_INTS, "a look-back record holds 2 V + 1 ints");
  __shared__ int sx[V];
  volatile int* me = status + (size_t)tile * SHARD_STATUS_INTS;
  if (threadIdx.x < 32) {
    const int wl = threadIdx.x;
    if (wl == 0 && tile > 0) {
#pragma unroll
      for (int q = 0; q < V; ++q) me[1 + q] = agg[q];
      __threadfence();
      me[0] = (epoch << 2) | 1;
    }
    int acc[V];
#pragma unroll
    for (int q = 0; q < V; ++q) acc[q] = 0;
    for (int top = tile - 1; top >= 0; top -= 32) {
      // Lane wl reads tile top - wl; a lane past tile 0 reads as an
      // inclusive prefix of 0.
      const int k = top - wl;
      volatile int* st = status + (size_t)max(k, 0) * SHARD_STATUS_INTS;
      int fl = 2;
      if (k >= 0) {
        do {
          fl = st[0];
        } while ((fl >> 2) != epoch || (fl & 3) == 0);
      }
      __threadfence();
      const unsigned inclusive = __ballot_sync(FULL_MASK, (fl & 3) == 2);
      const int stop = inclusive ? __ffs(inclusive) - 1 : 32;
      int v[V];
#pragma unroll
      for (int q = 0; q < V; ++q)
        v[q] = k >= 0 && wl <= stop ? st[(wl == stop ? 1 + V : 1) + q] : 0;
#pragma unroll
      for (int q = 0; q < V; ++q) {
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) v[q] += __shfl_xor_sync(FULL_MASK, v[q], o);
        acc[q] += v[q];
      }
      if (inclusive) break;
    }
    if (wl == 0) {
#pragma unroll
      for (int q = 0; q < V; ++q) me[1 + V + q] = acc[q] + agg[q];
      __threadfence();
      me[0] = (epoch << 2) | 2;
#pragma unroll
      for (int q = 0; q < V; ++q) sx[q] = acc[q];
    }
  }
  __syncthreads();
#pragma unroll
  for (int q = 0; q < V; ++q) excl[q] = sx[q];
}

// Row i of the rows arriving in direction k: the inbox's n_in waiting rows
// (parity par), then the received ones.
__device__ __forceinline__ const float* arrived(const float* inbox, const float* recv, int par,
                                                int k, int i, int n_in, int box, int cap,
                                                int fields) {
  return i < n_in ? inbox + (((size_t)par * 2 + k) * box + i) * fields
                  : recv + ((size_t)k * cap + i - n_in) * fields;
}

// The rows of each direction that took no lane or slot wait in the next
// parity's inbox, from its start; grid-strided over the CTAs' threads.
__device__ __forceinline__ void carry(float* inbox, const float* recv, int par, const int* n_in,
                                      const int* n_rx, const int* placed, int box, int cap,
                                      int fields, size_t g0, size_t stride) {
  for (int k = 0; k < 2; ++k) {
    const size_t rem = (size_t)(n_in[k] + n_rx[k] - placed[k]);
    for (size_t g = g0; g < rem; g += stride) {
      const float* src = arrived(inbox, recv, par, k, placed[k] + (int)g, n_in[k], box, cap,
                                 fields);
      float* dst = inbox + (((size_t)(par ^ 1) * 2 + k) * box + g) * fields;
      for (int c = 0; c < fields; ++c) dst[c] = src[c];
    }
  }
}

// The K events of one live lane, its state loaded, run in registers and
// stored back.
__device__ __forceinline__ void sd_events(float* __restrict__ f, int* __restrict__ iv,
                                          const ShardParams& p, int lane) {
  const int L = p.n_lanes;
  int alive = iv[SD_ALIVE * L + lane];
  int pend = iv[SD_PEND * L + lane];
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

// Bounded to 4 CTAs an SM: unbounded, the whole block took 127 registers
// (2 CTAs an SM; the events alone had taken 42); bounded, 64 and no spill
// with the look-back a call of its own (ptxas -v on the H100 machine's
// nvcc, copies built side by side).
__global__ void __launch_bounds__(CTA_THREADS, 4)
sharded_event_block_kernel(float* __restrict__ f, int* __restrict__ iv,
                           const __grid_constant__ ShardParams p) {
  const int tile = take_tile(p.ctl);
  const int t = threadIdx.x;
  const int L = p.n_lanes, R = p.n_rays, D = p.n_dirs;
  const int lane = tile * CTA_THREADS + t;
  const bool in = lane < L;
  const int n_tiles = (L + CTA_THREADS - 1) / CTA_THREADS;
  const int par = p.kb & 1u, npar = par ^ 1;
  const size_t g0 = (size_t)lane, stride = (size_t)n_tiles * CTA_THREADS;
  const int* tl = p.tiles + (size_t)par * N_TILE_ROWS * n_tiles;
  int* tn = p.tiles + (size_t)npar * N_TILE_ROWS * n_tiles;

  // Prologue.  The photons sent after the last block clear their tags.
  int alive = in ? iv[SD_ALIVE * L + lane] : 0;
  int tag = in ? iv[SD_TAG * L + lane] : 0;
  int pend = in ? iv[SD_PEND * L + lane] : 0;
  {
    const bool fl[2] = {tag == 1, tag == -1};
    int rk[2], tot[2];
    cta_ranks<2>(fl, rk, tot);
    if ((tag == 1 && tl[T_PRE_HI * n_tiles + tile] + rk[0] < p.sent_ph[0]) ||
        (tag == -1 && tl[T_PRE_LO * n_tiles + tile] + rk[1] < p.sent_ph[1])) {
      tag = 0;
      iv[SD_TAG * L + lane] = 0;
    }
  }
  // The free lanes' rank: those of the tiles below (free, or tagged and
  // sent), then this tile's.
  int below = 0;
#pragma unroll 4
  for (int k = t; k < tile; k += CTA_THREADS)
    below += tl[T_FREE * n_tiles + k]
             + min(max(p.sent_ph[0] - tl[T_PRE_HI * n_tiles + k], 0), tl[T_HI * n_tiles + k])
             + min(max(p.sent_ph[1] - tl[T_PRE_LO * n_tiles + k], 0), tl[T_LO * n_tiles + k]);
  below = cta_sum(below);
  const bool is_free = in && !alive && !tag && !pend;
  {
    const bool fl[1] = {is_free};
    int rk[1], tot[1];
    cta_ranks<1>(fl, rk, tot);
    const int r = below + rk[0];
    const int p0 = p.placed_ph[0], p1 = p.placed_ph[1];
    if (is_free && r < p0 + p1) {
      const int k = r < p0 ? 0 : 1;
      const float* row = arrived(p.inbox_ph, p.recv_ph, par, k, r - (k ? p0 : 0), p.n_in_ph[k],
                                 p.inbox, p.cap, PH_FIELDS);
      for (int c = 0; c < SD_TAU + 1; ++c) f[c * L + lane] = row[c];
      iv[SD_ORDERS * L + lane] = (int)row[SD_TAU + 1];
      iv[SD_ALIVE * L + lane] = 1;
    } else if (is_free && r - p0 - p1 < p.n_new) {
      float v[6];
      source_sample(p.src, p.kb, p.key0, p.key1, lane, v);
      for (int c = 0; c < 6; ++c) f[c * L + lane] = v[c];
      f[SD_TAU * L + lane] = 0.0f;
      iv[SD_ORDERS * L + lane] = 0;
      iv[SD_ALIVE * L + lane] = 1;
    }
  }
  carry(p.inbox_ph, p.recv_ph, par, p.n_in_ph, p.n_rx_ph, p.placed_ph, p.inbox, p.cap,
        PH_FIELDS, g0, stride);
  if (D > 0) {
    // The rays sent free their slots; the arrived ones take the free slots
    // of the last pack, +1 then -1.
    for (int k = 0; k < 2; ++k)
      for (size_t g = g0; g < (size_t)p.sent_q[k]; g += stride) {
        const int s = p.tag_q[k * p.cap + g];
        p.pool_i[SR_TAG * R + s] = 0;
        p.pool_i[SR_ALIVE * R + s] = 0;
      }
    const int q0 = p.placed_q[0];
    for (size_t g = g0; g < (size_t)(q0 + p.placed_q[1]); g += stride) {
      const int k = (int)g < q0 ? 0 : 1;
      const float* row = arrived(p.inbox_q, p.recv_q, par, k, (int)g - (k ? q0 : 0),
                                 p.n_in_q[k], p.inbox, p.cap, Q_FIELDS);
      const int s = p.free_q[g];
      for (int c = 0; c < 5; ++c) p.pool_f[c * R + s] = row[c];
      p.pool_i[SR_DET * R + s] = (int)row[5];
      p.pool_i[SR_ALIVE * R + s] = 1;
    }
    carry(p.inbox_q, p.recv_q, par, p.n_in_q, p.n_rx_q, p.placed_q, p.inbox, p.cap, Q_FIELDS,
          g0, stride);
  }

  // The K events.
  if (in && iv[SD_ALIVE * L + lane] && !pend) sd_events(f, iv, p, lane);

  // Epilogue.  The flush of the block's exits and deaths.
  int pk = in ? iv[SD_PK * L + lane] : 0;
  {
    int col = 0, iz = 0;
    if (in) {
      const float x = f[SD_X * L + lane], y = f[SD_Y * L + lane], z = f[SD_Z * L + lane];
      const int ix = min(max((int)((x - p.x_lo) * p.inv_dx), 0), p.nx_loc - 1);
      const int iy = min(max((int)((y - p.y0) * p.inv_dy), 0), p.n_y - 1);
      iz = min(max((int)((z - p.z0) * p.inv_dz), 0), p.n_z - 1);
      col = ix * p.n_y + iy;
    }
    warp_red<false>(p.columns, pk != 0 ? col * 3 + pk - 1 : -1, 1.0);
    if (p.vol_on) warp_red<false>(p.vol, pk == 3 ? col * p.n_z + iz : -1, 1.0);
  }
  // A bottom hit: its record (detectors), then the Bernoulli revive.
  if (p.surface && pk == 2) {
    if (D > 0) {
      for (int d = 0; d < D; ++d) f[(SD_PEND_PF + d) * L + lane] = p.surf_pf[d];
      iv[SD_PEND_SRF * L + lane] = 1;
      iv[SD_PEND * L + lane] = 1;
    }
    uint32_t w[4];
    philox4x32_10((uint32_t)lane, p.kb, 0u, STREAM_SURFACE, p.key0, p.key1, w);
    const float u1 = to_unit(w[1]);
    if (to_unit(w[0]) < p.albedo) {
      const float mu = fmaxf(sqrtf(u1), EPS6_F);
      const float sin_t = sqrtf(fmaxf(1.0f - u1, 0.0f));
      float sa, ca;
      sincos_2pi(to_unit(w[2]), &sa, &ca);
      f[SD_UX * L + lane] = sin_t * ca;
      f[SD_UY * L + lane] = sin_t * sa;
      f[SD_UZ * L + lane] = mu;
      f[SD_Z * L + lane] = p.z_revive;
      f[SD_TAU * L + lane] = 0.0f;
      iv[SD_ORDERS * L + lane] += 1;
      iv[SD_ALIVE * L + lane] = 1;
    }
  }
  if (pk != 0) iv[SD_PK * L + lane] = 0;
  // The lane order of the pending records and tagged photons over the grid.
  pend = in ? iv[SD_PEND * L + lane] : 0;
  tag = in ? iv[SD_TAG * L + lane] : 0;
  const bool fl[3] = {pend != 0, tag == 1, tag == -1};
  int rk[3], tot[3], ex[3];
  cta_ranks<3>(fl, rk, tot);
  look_back<3>(p.status, p.epoch, tile, tot, ex);
  if (D > 0 && pend && ex[0] + rk[0] < p.drain_cap) {
    // The drain: record k into D free slots after the placed rays.
    const int base = p.placed_q[0] + p.placed_q[1] + (ex[0] + rk[0]) * D;
    const int srf = iv[SD_PEND_SRF * L + lane], comp = iv[SD_PEND_COMP * L + lane];
    const float x = f[SD_X * L + lane], y = f[SD_Y * L + lane], z = f[SD_Z * L + lane];
    for (int d = 0; d < D; ++d) {
      const int s = p.free_q[base + d];
      p.pool_f[SR_X * R + s] = x;
      p.pool_f[SR_Y * R + s] = y;
      p.pool_f[SR_Z * R + s] = z;
      p.pool_f[SR_TAU * R + s] = 0.0f;
      p.pool_f[SR_PF * R + s] = f[(SD_PEND_PF + d) * L + lane];
      p.pool_i[SR_DET * R + s] = srf ? d : (comp + 1) * D + d;
      p.pool_i[SR_ALIVE * R + s] = 1;
    }
    iv[SD_PEND * L + lane] = 0;
    pend = 0;
  }
  if (tag != 0) {
    // The first CAP tagged photons of each direction into the next send
    // buffer.
    const int k = tag == 1 ? 0 : 1;
    const int g = ex[1 + k] + rk[1 + k];
    if (g < p.cap) {
      float* row = p.send_ph + (((size_t)npar * 2 + k) * p.cap + g) * PH_FIELDS;
      for (int c = 0; c < SD_TAU + 1; ++c) row[c] = f[c * L + lane];
      row[SD_TAU + 1] = (float)iv[SD_ORDERS * L + lane];
    }
  }
  // The tile's counts for the next prologue, and the counts vector.
  const bool busy = in && (iv[SD_ALIVE * L + lane] || tag || pend);
  const int n_busy = cta_sum(busy ? 1 : 0);
  const int n_free = cta_sum(in && !busy ? 1 : 0);
  if (t == 0) {
    tn[T_FREE * n_tiles + tile] = n_free;
    tn[T_HI * n_tiles + tile] = tot[1];
    tn[T_LO * n_tiles + tile] = tot[2];
    tn[T_PRE_HI * n_tiles + tile] = ex[1];
    tn[T_PRE_LO * n_tiles + tile] = ex[2];
    tn[T_BUSY * n_tiles + tile] = n_busy;
  }
  __threadfence();
  __shared__ int last;
  if (t == 0) last = atomicAdd(p.ctl + 1, 1) == n_tiles - 1;
  __syncthreads();
  if (last) {
    // Every tile has written its counts: this CTA finishes the launch.
    __threadfence();
    const volatile int* v = tn;
    int s[4] = {0, 0, 0, 0};
#pragma unroll 4
    for (int k = t; k < n_tiles; k += CTA_THREADS) {
      s[0] += v[T_BUSY * n_tiles + k];
      s[1] += v[T_HI * n_tiles + k];
      s[2] += v[T_LO * n_tiles + k];
      s[3] += v[T_FREE * n_tiles + k];
    }
    for (int q = 0; q < 4; ++q) s[q] = cta_sum(s[q]);
    if (t == 0) {
      for (int i = 0; i < p.n_ranks * N_COUNTS; ++i) p.counts[i] = 0;
      long long* row = p.counts + (size_t)p.rank * N_COUNTS;
      row[C_WORK] = p.work;
      row[C_BUSY_PH] = s[0];
      row[C_SPACE_PH] = p.space_ph[0];
      row[C_SPACE_PH + 1] = p.space_ph[1];
      row[C_SPACE_Q] = p.space_q[0];
      row[C_SPACE_Q + 1] = p.space_q[1];
      row[C_WAIT_PH] = s[1];
      row[C_WAIT_PH + 1] = s[2];
      row[C_FREE_PH] = s[3];
      p.ctl[0] = 0;
      p.ctl[1] = 0;
    }
  }
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

// SP: the pack of the pool after SR (see the note above).  One thread a
// slot, the CTAs' tiles by ticket.
__global__ void __launch_bounds__(CTA_THREADS)
shadow_pack_kernel(const __grid_constant__ ShardParams p) {
  const int tile = take_tile(p.ctl);
  const int R = p.n_rays;
  const int s = tile * CTA_THREADS + threadIdx.x;
  const bool in = s < R;
  const int n_tiles = (R + CTA_THREADS - 1) / CTA_THREADS;
  const int alive = in ? p.pool_i[SR_ALIVE * R + s] : 0;
  const int tag = in ? p.pool_i[SR_TAG * R + s] : 0;
  const bool fl[4] = {in && !alive && !tag, tag == 1, tag == -1, alive || tag};
  int rk[4], tot[4], ex[4];
  cta_ranks<4>(fl, rk, tot);
  look_back<4>(p.status, p.epoch, tile, tot, ex);
  if (fl[0]) p.free_q[ex[0] + rk[0]] = s;
  if (tag != 0) {
    const int k = tag == 1 ? 0 : 1;
    const int g = ex[1 + k] + rk[1 + k];
    if (g < p.cap) {
      float* row = p.send_q + ((size_t)k * p.cap + g) * Q_FIELDS;
      for (int c = 0; c < 5; ++c) row[c] = p.pool_f[c * R + s];
      row[5] = (float)p.pool_i[SR_DET * R + s];
      p.tag_q[k * p.cap + g] = s;
    }
  }
  if (tile == n_tiles - 1 && threadIdx.x == 0) {
    // The last tile's inclusive prefixes are the pool's totals; every
    // ticket is taken.
    long long* row = p.counts + (size_t)p.rank * N_COUNTS;
    row[C_FREE_Q] = ex[0] + tot[0];
    row[C_WAIT_Q] = ex[1] + tot[1];
    row[C_WAIT_Q + 1] = ex[2] + tot[2];
    row[C_BUSY_Q] = ex[3] + tot[3];
    p.ctl[0] = 0;
  }
}

extern "C" {

int i3rc_sharded_params_size(void) { return (int)sizeof(ShardParams); }

// One launch of SD (one whole block, params->K events a lane) in place on
// the given stream.  Returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for parameters the kernel does not take.
int i3rc_sharded_event_block(float* f, int* i, const ShardParams* params, void* stream) {
  const ShardParams& p = *params;
  if (p.K < 1 || p.n_lanes < 1 || p.n_comp < 1 || p.n_seg < 1 || p.n_dirs < 0
      || (p.n_dirs > 0 && (p.n_fwd < 1 || p.fwd == nullptr || p.det == nullptr
                           || p.pool_f == nullptr || p.pool_i == nullptr || p.free_q == nullptr
                           || p.tag_q == nullptr || p.inbox_q == nullptr || p.recv_q == nullptr
                           || p.n_rays < p.n_lanes))
      || p.send_ph == nullptr || p.recv_ph == nullptr || p.inbox_ph == nullptr
      || p.tiles == nullptr || p.status == nullptr || p.ctl == nullptr || p.counts == nullptr
      || p.columns == nullptr || (p.vol_on && p.vol == nullptr)
      || (p.surface && p.n_dirs > 0 && p.surf_pf == nullptr) || p.cap < 1 || p.inbox < 1
      || p.rank < 0 || p.rank >= p.n_ranks || p.epoch < 1 || p.epoch >= (1 << 29))
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

// One launch of SP over params->n_rays pool slots.
int i3rc_shadow_pack(const ShardParams* params, void* stream) {
  const ShardParams& p = *params;
  if (p.n_rays < 1 || p.pool_f == nullptr || p.pool_i == nullptr || p.free_q == nullptr
      || p.tag_q == nullptr || p.send_q == nullptr || p.status == nullptr || p.ctl == nullptr
      || p.counts == nullptr || p.cap < 1 || p.rank < 0 || p.rank >= p.n_ranks
      || p.epoch < 1 || p.epoch >= (1 << 29))
    return (int)cudaErrorInvalidValue;
  const int blocks = (p.n_rays + CTA_THREADS - 1) / CTA_THREADS;
  shadow_pack_kernel<<<blocks, CTA_THREADS, 0, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

}  // extern "C"
