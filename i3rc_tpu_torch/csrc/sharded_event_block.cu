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
//       kb, STREAM_REFILL), or for a source that is not uniform in x the
//       next rows of the rank's source queue (src_q).  A lane's rank needs the free and tagged lanes
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
//  * SB, shadow_block_kernel: the shadow rays of the rank's pool, in one
//    launch: K exact cell-DDA steps of every ray in flight
//    (sharded_domain.py:464-530, unrolled K times in the same body; once
//    SR, a kernel of its own): the optical depth of the cell crossed, a ray past the slab's x
//    face tagged to migrate (its tau carried), an escaping ray's w exp(-tau)
//    added to its exit column's float64 radiance tallies, total and by
//    component slot; then the pool's pack (pack_send, :358 and :531-557;
//    once SP, a second launch): the free slots in slot order (the next prologue's and
//    drain's slots), the first CAP tagged rays of each direction in slot
//    order into the send buffer with their slots, and the ray side of this
//    rank's row of the counts vector.
// So a block is SD, and with detectors SB, and the host reads one counts
// vector a block (all-reduced over the ranks) and exchanges the planned
// prefix of each send buffer.
//
// Draws (SD): event j of block kb reads Philox4x32-10 groups 2j and 2j + 1
// at counter (lane, kb, group, STREAM_EVENT) under the key (seed, rank):
// u0-u3 the first group's words, u4-u6 the second's (free path,
// acceptance, absorption, cosine, azimuth, -, component), the twin's
// philox_uniforms(key, kb, K, 7, L) layout.  SB draws nothing.
//
// What bounds them.  SD per live lane-event: two Philox calls (~200
// integer operations), a logf where a new free path is drawn, four IEEE
// divisions for the face distances, the 4 + 12 C byte cell row, and per
// collision the 16-byte cubic row, the rotation's square roots and
// division, and per detector acosf, a 16-byte forward row and expf; the
// lane state (7 + D floats and 9 ints) is read and written once a launch,
// and the glue reads every lane's flags.  SB: every slot's two flags read
// once; per ray step the 4-byte extinction of the cell, three divisions and
// the moves; per moving ray its state read and written once; per escape
// expf and two float64 adds; per packed row 28 bytes, per free slot 4.
// Its bound is a few microseconds; what held SR and SP at 20-30x it was
// latency and idle lanes (PERF.md section 6): SR ran one thread a
// slot over all 2^20 slots in ~5 waves, each warp with a ray running all K
// steps though a ray on a slab two cells wide ends after ~2.2 (0.13 of its
// thread-steps used), with two warp sums a step onto 64 float64 bins; SP
// was a second grid of 4096 ticketed CTAs that read both flags again and
// looked back over 4096 tiles.  So SB's CTA takes a run of T tiles (T from
// the kernel's occupancy: one wave, 512 runs of 8 tiles at 2^20 slots and
// 4 CTAs an SM), reads the flags of T tiles once, queues their rays in
// flight in shared memory and pulls them, a warp's idle threads refilled
// from the queue (a ray runs to its escape, tag or K-th step, so the
// loop's thread slots follow the rays' steps); sums the escapes in a
// histogram in shared memory and adds its nonzero bins once; and then packs
// its run, looking back over the runs below it 256 at a time, the rows it
// sends copied by all its threads at once.  The rays of a pool crowd its
// low slots (the drain and the arrivals take the free slots in slot order:
// at a tail block all in the first ~500 of 4096 tiles), so the tiles a CTA
// traces are spread over the pool (run, run + n_runs, ...) and its run's
// pack waits for the CTAs that traced them, which a cooperative launch
// makes resident with it; a run's own tiles, traced by itself, left a few
// CTAs with every ray (PERF.md section 6), and are what a pool past one
// wave takes, no CTA then waiting on one that has not started.
//
// Float arithmetic follows the twins (sharded_block.sharded_event,
// shadow_step and the block's glue) operation by operation, built with
// --fmad=false.  Rays do not interact, so SB's queue order leaves the pool
// bit-equal to the plain version's; only the order of the float64 sums
// differs.

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
  double* acc_int;       // SB: (nx_loc * n_y * n_dirs) radiance sums
  double* acc_byc;       // SB: (nx_loc * n_y * n_dirs * (n_comp + 1)) by slot
  int n_lanes, K, n_comp, n_seg, n_fwd, n_dirs, nx_loc, n_y, n_z, max_events;
  float x_lo, x_hi, x0, x_max, y0, y_max, z0, z_max, wx, wy, hi_push, lo_push;
  float inv_dx, inv_dy, inv_dz, dx, dy, dz, inv_max_ext, max_ext, nudge, fwd_scale;
  unsigned int key0, key1, kb;
  // The whole block (SD) and SB: the buffers of
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
  // A source that is not uniform in x: the rank's photons of one batch
  // drawn for every rank, (n, 6) x, y, z, ux, uy, uz in batch order, read by
  // the refill from row q_at on in place of src (null: src).
  const float* src_q;
  long long q_at;
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

// A status int read with acquire and written with release semantics at the
// device's scope: what the writer stored before the release is visible to a
// reader after its acquire.
__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}
__device__ __forceinline__ void st_release(int* p, int v) {
  asm volatile("st.release.gpu.global.b32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

// A look-back record in `status` (SD's a tile, SB's a run): the flag (epoch
// << 2 | 1 aggregate, | 2 inclusive), then the four aggregates and the four
// inclusive prefixes, each an int4 read in one load.
#define LB_FLAG 0
#define LB_AGG 4
#define LB_INC 8

// Decoupled look-back over the CTAs in ticket order (SD's tiles, SB's runs):
// publishes the CTA's counts (agg), then looks at the CTA_THREADS records
// below it at a time, one a thread, each thread waiting until its record
// has published (sleeping between its reads): the nearest record with its
// inclusive prefix ends the look-back (its prefix and the aggregates of the
// records above it are the sum), else the window's aggregates are summed
// and the next window below is read.  Sets excl to the sums of the records
// below (a reference: returned in registers, they spilled 4 bytes of SD's
// epilogue) and publishes the CTA's inclusive prefix.  The epoch, unique to a launch,
// makes a record of an earlier launch read as not yet written.  Looking
// back one tile at a time (thread 0 alone) made a Landsat launch of SD 0.37
// ms against 0.15 for its events (H100, PERF.md section 6): the prefixes
// crossed the grid a tile a memory round trip; a window of 32 records, each
// read an int at a time, made the last of SB's ~500 runs, which finish their
// ray loops together, wait ~16 windows.  Every thread of the CTA calls it.
// A function of its own (noinline), so that its registers stay out of SD's
// event loop (inlined, SD bounded to 64 registers spilled 16 bytes).
static __device__ __noinline__ void look_back(int* status, int epoch, int rec_no, int4 agg,
                                              int4& excl) {
  static_assert(LB_INC + 4 <= SHARD_STATUS_INTS, "a look-back record holds 12 ints");
  __shared__ int sstop[CTA_WARPS];
  __shared__ int4 sred[CTA_WARPS];
  __shared__ int4 sx;
  const int t = threadIdx.x, wl = t & 31, warp = t >> 5;
  int* me = status + (size_t)rec_no * SHARD_STATUS_INTS;
  if (t == 0 && rec_no > 0) {
    *reinterpret_cast<int4*>(me + LB_AGG) = agg;
    st_release(me + LB_FLAG, (epoch << 2) | 1);
  }
  int4 acc = make_int4(0, 0, 0, 0);
  for (int top = rec_no - 1; top >= 0; top -= CTA_THREADS) {
    // Thread t reads record top - t; a thread past record 0 reads as an
    // inclusive prefix of 0.
    const int k = top - t;
    const int* rec = status + (size_t)max(k, 0) * SHARD_STATUS_INTS;
    int fl = 2;
    if (k >= 0) {
      for (;;) {
        fl = ld_acquire(rec + LB_FLAG);
        if ((fl >> 2) == epoch && (fl & 3) != 0) break;
        __nanosleep(64);
      }
    }
    const unsigned inclusive = __ballot_sync(FULL_MASK, (fl & 3) == 2);
    if (wl == 0) sstop[warp] = inclusive ? __ffs(inclusive) - 1 : 32;
    __syncthreads();
    // The nearest record with its inclusive prefix ends the window.
    int stop = CTA_THREADS;
    for (int w = CTA_WARPS - 1; w >= 0; --w)
      if (sstop[w] < 32) stop = w * 32 + sstop[w];
    int4 v = make_int4(0, 0, 0, 0);
    if (k >= 0 && t <= stop)
      v = __ldcg(reinterpret_cast<const int4*>(rec + (t == stop ? LB_INC : LB_AGG)));
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      v.x += __shfl_xor_sync(FULL_MASK, v.x, o);
      v.y += __shfl_xor_sync(FULL_MASK, v.y, o);
      v.z += __shfl_xor_sync(FULL_MASK, v.z, o);
      v.w += __shfl_xor_sync(FULL_MASK, v.w, o);
    }
    if (wl == 0) sred[warp] = v;
    __syncthreads();
    for (int w = 0; w < CTA_WARPS; ++w) {
      acc.x += sred[w].x;
      acc.y += sred[w].y;
      acc.z += sred[w].z;
      acc.w += sred[w].w;
    }
    __syncthreads();
    if (stop < CTA_THREADS) break;
  }
  if (t == 0) {
    *reinterpret_cast<int4*>(me + LB_INC) =
        make_int4(acc.x + agg.x, acc.y + agg.y, acc.z + agg.z, acc.w + agg.w);
    st_release(me + LB_FLAG, (epoch << 2) | 2);
    sx = acc;
  }
  __syncthreads();
  excl = sx;
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
      if (p.src_q != nullptr) {
        const float* q = p.src_q + (size_t)(p.q_at + (r - p0 - p1)) * 6;
        for (int c = 0; c < 6; ++c) v[c] = q[c];
      } else {
        source_sample(p.src, p.kb, p.key0, p.key1, lane, v);
      }
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
  int rk[3], tot[3];
  cta_ranks<3>(fl, rk, tot);
  int4 ex;
  look_back(p.status, p.epoch, tile, make_int4(tot[0], tot[1], tot[2], 0), ex);
  if (D > 0 && pend && ex.x + rk[0] < p.drain_cap) {
    // The drain: record k into D free slots after the placed rays.
    const int base = p.placed_q[0] + p.placed_q[1] + (ex.x + rk[0]) * D;
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
    const int g = (k ? ex.z : ex.y) + rk[1 + k];
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
    tn[T_PRE_HI * n_tiles + tile] = ex.y;
    tn[T_PRE_LO * n_tiles + tile] = ex.z;
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

// SB's design constants (see the note above).
#define SB_MAX_TILES 8          // tiles of CTA_THREADS pool slots in a CTA's run, at most
#define SB_SMEM_BINS 512        // the CTA's radiance histogram: acc_int's bins, then acc_byc's
#define SB_REFILL_AT 8          // a warp refills when at most this many threads hold a ray
// A slot's flag at the pack: free, a ray in flight, tagged +1, tagged -1.
#define SB_FREE 0
#define SB_LIVE 1
#define SB_HI 2
#define SB_LO 3
// The ray loop's counts (the wrapper's shadow_ray_use): rays, their steps,
// the warps' thread-step slots (32 a trip of a warp), and CTAs (runs).
#define SB_USE_RAYS 0
#define SB_USE_STEPS 1
#define SB_USE_SLOTS 2
#define SB_USE_RUNS 3

__device__ __forceinline__ int sb_flag(int alive, int tag) {
  return tag == 1 ? SB_HI : tag == -1 ? SB_LO : alive ? SB_LIVE : SB_FREE;
}

// A tile's int in `status` beside its look-back record: the epoch of the SB
// launch that traced it.
#define SB_DONE 15

// SB: the K steps of every ray in flight and the pool's pack, one launch (see
// the note above).  A CTA takes a run by ticket: T tiles of the pool in slot
// order, which it packs, and T tiles whose rays it traces, the same tiles or,
// with `interleave`, tiles run, run + n_runs, ... spread over the pool (a
// pool's rays crowd its low slots, which the drain and the arrivals fill
// first).  The traced tiles' flags are read once and their rays in flight
// queued in shared memory; the CTA's threads pull the queue's rays, each ray
// run to its escape, its tag or its K-th step, a warp refilling its idle
// threads when at most SB_REFILL_AT still hold a ray (G+E's gen_flush, K3-M's
// march_flush); an escape's w exp(-tau) is summed where the warp meets to
// refill (converged: warp_red), into the CTA's histogram in shared memory
// (smem) or, past SB_SMEM_BINS bins, into device memory.  Each traced tile is
// then marked done (its status int SB_DONE set to the launch's epoch); the
// pack waits for its run's tiles to be done, reads their final flags, ranks
// them in slot order and looks back over the runs below (look_back).
// With `interleave` a CTA may wait on a tile traced by a CTA with a later
// ticket: the host sets it only in a cooperative launch, whose CTAs are all
// resident at once.
__global__ void __launch_bounds__(CTA_THREADS, 4)
shadow_block_kernel(const __grid_constant__ ShardParams p, int T, int smem, int interleave,
                    unsigned long long* ray_use) {
  // The traced tiles' rays (slots); in the pack, the slots of the rows to send.
  __shared__ int queue[SB_MAX_TILES * CTA_THREADS];
  __shared__ int row_at[SB_MAX_TILES * CTA_THREADS];       // the pack: each row's place
  __shared__ unsigned char flag[SB_MAX_TILES * CTA_THREADS];
  __shared__ double hist[SB_SMEM_BINS];
  __shared__ int wcount[4][SB_MAX_TILES * CTA_WARPS];     // flags a warp-tile, then prefixes
  __shared__ int qn[3];                                    // rays queued, next dealt; rows
  __shared__ unsigned long long use[2];
  __shared__ int run_tot[4];
  const int run = take_tile(p.ctl);
  const int t = threadIdx.x, wl = t & 31, warp = t >> 5;
  const int R = p.n_rays, D = p.n_dirs, C = p.n_comp;
  const int n_tiles = (R + CTA_THREADS - 1) / CTA_THREADS;
  const int n_runs = (n_tiles + T - 1) / T;
  const int n_int = p.nx_loc * p.n_y * D;
  const int n_bins = smem ? n_int * (C + 2) : 0;
  float* __restrict__ qf = p.pool_f;
  int* __restrict__ qi = p.pool_i;
  int* __restrict__ status = p.status;
  // Traced tile j of this CTA (past the pool: none).
  auto traced = [&](int j) { return interleave ? run + j * n_runs : run * T + j; };
  for (int k = t; k < n_bins; k += CTA_THREADS) hist[k] = 0.0;
  if (t < 3) qn[t] = 0;
  if (t < 2) use[t] = 0ull;
  __syncthreads();
  {
    // The traced tiles' flags, read once, and their rays in flight queued.
    int alive[SB_MAX_TILES], tag[SB_MAX_TILES];
#pragma unroll
    for (int j = 0; j < SB_MAX_TILES; ++j) {
      const int s = traced(j) * CTA_THREADS + t;
      const bool in = j < T && traced(j) < n_tiles && s < R;
      alive[j] = in ? qi[SR_ALIVE * R + s] : 0;
      tag[j] = in ? qi[SR_TAG * R + s] : 0;
    }
#pragma unroll
    for (int j = 0; j < SB_MAX_TILES; ++j) {
      const bool live = alive[j] && tag[j] == 0;
      const unsigned m = __ballot_sync(FULL_MASK, live);
      if (m) {
        const int lead = __ffs(m) - 1;
        int base = 0;
        if (wl == lead) base = atomicAdd(qn, __popc(m));
        base = __shfl_sync(FULL_MASK, base, lead);
        if (live) queue[base + __popc(m & ((1u << wl) - 1u))] = traced(j) * CTA_THREADS + t;
      }
    }
  }
  __syncthreads();

  // The ray loop.  A ray's arithmetic is shadow_step's.
  const int n = qn[0];
  unsigned steps = 0, slots = 0;     // this warp's (lane 0's)
  float qx = 0.0f, qy = 0.0f, qz = 0.0f, qtau = 0.0f, qpf = 0.0f;
  float4 dd = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  int sl = 0, d = 0, slot = 0, k = 0, nst = 0;
  // bin: the exit bin of the ray that escaped at the last trip, or -1.
  int bin = -1;
  double contrib = 0.0;
  bool act = false, more = n > 0;
#pragma unroll 1
  for (;;) {
    const int bk = bin < 0 ? -1 : bin * (C + 1) + slot;
    if (smem) {
      warp_red<true>(hist, bin, contrib);
      warp_red<true>(hist + n_int, bk, contrib);
    } else {
      warp_red<false>(p.acc_int, bin, contrib);
      warp_red<false>(p.acc_byc, bk, contrib);
    }
    bin = -1;
    const bool want = !act && more;
    const unsigned wm = __ballot_sync(FULL_MASK, want);
    if (wm) {
      const int lead = __ffs(wm) - 1;
      int r0 = 0;
      if (wl == lead) r0 = atomicAdd(qn + 1, __popc(wm));
      r0 = __shfl_sync(FULL_MASK, r0, lead);
      if (want) {
        const int r = r0 + __popc(wm & ((1u << wl) - 1u));
        more = r < n;
        if (more) {
          sl = queue[r];
          qx = qf[SR_X * R + sl];
          qy = qf[SR_Y * R + sl];
          qz = qf[SR_Z * R + sl];
          qtau = qf[SR_TAU * R + sl];
          qpf = qf[SR_PF * R + sl];
          const int qdet = qi[SR_DET * R + sl];
          d = qdet % D;
          slot = qdet / D;
          dd = __ldg(p.det + d);
          nst = qi[SR_STEPS * R + sl];
          k = 0;
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
        ++nst;
        ++k;
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
        }
        const bool mig = !escaped && (nqx >= p.x_hi || nqx < p.x_lo);
        nqx = wrap_fast(nqx, p.x0, p.x_max, p.wx);
        qx = nqx;
        qy = nqy;
        qz = nqz;
        if (escaped || mig || k >= p.K) {
          // The ray's state back to its slot.
          qf[SR_X * R + sl] = qx;
          qf[SR_Y * R + sl] = qy;
          qf[SR_Z * R + sl] = qz;
          qf[SR_TAU * R + sl] = qtau;
          qi[SR_STEPS * R + sl] = nst;
          if (escaped) qi[SR_ALIVE * R + sl] = 0;
          if (mig) qi[SR_TAG * R + sl] = dd.x >= 0.0f ? 1 : -1;
          act = false;
        }
      }
      const unsigned am = __ballot_sync(FULL_MASK, act);
      if (am == 0u || (left && __popc(am) <= SB_REFILL_AT)) break;
    }
  }
  if (wl == 0) {
    atomicAdd(use, (unsigned long long)steps);
    atomicAdd(use + 1, (unsigned long long)slots);
  }
  // The traced tiles done: the CTA's stores made visible with the marks.
  __syncthreads();
  if (t < T && traced(t) < n_tiles)
    st_release(status + (size_t)traced(t) * SHARD_STATUS_INTS + SB_DONE, p.epoch);
  if (t == 0 && ray_use) {
    atomicAdd(ray_use + SB_USE_RAYS, (unsigned long long)n);
    atomicAdd(ray_use + SB_USE_STEPS, use[0]);
    atomicAdd(ray_use + SB_USE_SLOTS, use[1]);
    atomicAdd(ray_use + SB_USE_RUNS, 1ull);
  }
  // The histogram's nonzero bins into the tallies, once a CTA.
  for (int b = t; b < n_bins; b += CTA_THREADS) {
    const double v = hist[b];
    if (v != 0.0) tally_add(b < n_int ? p.acc_int + b : p.acc_byc + (b - n_int), v);
  }

  // The pack of the run's tiles, once each is done: their final flags (read
  // past the L1, other CTAs may have traced them) counted a warp-tile at a
  // time (wcount), scanned in slot order, the runs below looked back over,
  // then each slot's rank.
  const int s0 = run * T * CTA_THREADS;
  if (t < T && run * T + t < n_tiles) {
    const int* done = status + (size_t)(run * T + t) * SHARD_STATUS_INTS + SB_DONE;
    while (ld_acquire(done) != p.epoch) __nanosleep(64);
  }
  __syncthreads();
  {
    int alive[SB_MAX_TILES], tag[SB_MAX_TILES];
#pragma unroll
    for (int j = 0; j < SB_MAX_TILES; ++j) {
      const int s = s0 + j * CTA_THREADS + t;
      const bool in = j < T && s < R;
      alive[j] = in ? __ldcg(qi + SR_ALIVE * R + s) : 0;
      tag[j] = in ? __ldcg(qi + SR_TAG * R + s) : 0;
    }
#pragma unroll
    for (int j = 0; j < SB_MAX_TILES; ++j) {
      if (j >= T) break;
      const bool in = s0 + j * CTA_THREADS + t < R;
      const int fl = sb_flag(alive[j], tag[j]);
      flag[j * CTA_THREADS + t] = (unsigned char)fl;
      const unsigned mf = __ballot_sync(FULL_MASK, in && fl == SB_FREE);
      const unsigned mh = __ballot_sync(FULL_MASK, fl == SB_HI);
      const unsigned ml = __ballot_sync(FULL_MASK, fl == SB_LO);
      const unsigned mb = __ballot_sync(FULL_MASK, in && fl != SB_FREE);
      if (wl < 4)
        wcount[wl][j * CTA_WARPS + warp] = __popc(wl == 0 ? mf : wl == 1 ? mh : wl == 2 ? ml : mb);
    }
  }
  __syncthreads();
  const int nw = T * CTA_WARPS;
  if (warp < 4) {
    // Warp q: the exclusive prefixes of flag q over the run's warp-tiles,
    // two a lane (nw <= 64).
    int* w = wcount[warp];
    const int a = 2 * wl < nw ? w[2 * wl] : 0;
    const int b = 2 * wl + 1 < nw ? w[2 * wl + 1] : 0;
    int inc = a + b;
#pragma unroll
    for (int sh = 1; sh < 32; sh <<= 1) {
      const int v = __shfl_up_sync(FULL_MASK, inc, sh);
      if (wl >= sh) inc += v;
    }
    const int ex = inc - a - b;
    if (2 * wl < nw) w[2 * wl] = ex;
    if (2 * wl + 1 < nw) w[2 * wl + 1] = ex + a;
    if (wl == 31) run_tot[warp] = inc;
  }
  __syncthreads();
  const int4 tot = make_int4(run_tot[0], run_tot[1], run_tot[2], run_tot[3]);
  int4 ex;
  look_back(status, p.epoch, run, tot, ex);
  int* __restrict__ free_q = p.free_q;
  int* __restrict__ tag_q = p.tag_q;
  float* __restrict__ send_q = p.send_q;
#pragma unroll
  for (int j = 0; j < SB_MAX_TILES; ++j) {
    if (j >= T) break;
    const int s = s0 + j * CTA_THREADS + t;
    const bool in = s < R;
    const int fl = flag[j * CTA_THREADS + t];
    const unsigned below = (1u << wl) - 1u;
    const unsigned mf = __ballot_sync(FULL_MASK, in && fl == SB_FREE);
    const unsigned mh = __ballot_sync(FULL_MASK, fl == SB_HI);
    const unsigned ml = __ballot_sync(FULL_MASK, fl == SB_LO);
    const int wt = j * CTA_WARPS + warp;
    if (in && fl == SB_FREE) free_q[ex.x + wcount[0][wt] + __popc(mf & below)] = s;
    // The first CAP tagged rays of each direction: their rows' places listed,
    // the rows copied below by all the CTA's threads at once, so that the
    // loads of the run's rows overlap.
    const int q = fl == SB_HI ? 0 : 1;
    const int g = (q ? ex.z : ex.y) + wcount[1 + q][wt] + __popc((q ? ml : mh) & below);
    const bool send = (fl == SB_HI || fl == SB_LO) && g < p.cap;
    const unsigned ms = __ballot_sync(FULL_MASK, send);
    if (ms) {
      const int lead = __ffs(ms) - 1;
      int base = 0;
      if (wl == lead) base = atomicAdd(qn + 2, __popc(ms));
      base = __shfl_sync(FULL_MASK, base, lead);
      if (send) {
        const int i = base + __popc(ms & below);
        queue[i] = s;
        row_at[i] = q * p.cap + g;
      }
    }
  }
  __syncthreads();
  for (int i = t; i < qn[2]; i += CTA_THREADS) {
    const int s = queue[i], at = row_at[i];
    float v[Q_FIELDS];
#pragma unroll
    for (int c = 0; c < 5; ++c) v[c] = __ldcg(qf + c * R + s);
    v[5] = (float)__ldcg(qi + SR_DET * R + s);
    float* row = send_q + (size_t)at * Q_FIELDS;
#pragma unroll
    for (int c = 0; c < Q_FIELDS; ++c) row[c] = v[c];
    tag_q[at] = s;
  }
  if (run == n_runs - 1 && t == 0) {
    // The last run's inclusive prefixes are the pool's totals; every
    // ticket is taken.
    long long* row = p.counts + (size_t)p.rank * N_COUNTS;
    row[C_FREE_Q] = ex.x + tot.x;
    row[C_WAIT_Q] = ex.y + tot.y;
    row[C_WAIT_Q + 1] = ex.z + tot.z;
    row[C_BUSY_Q] = ex.w + tot.w;
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

// One launch of SB (params->K DDA steps of each ray in flight of the
// params->n_rays pool slots, then the pool's pack): runs of as many tiles of
// CTA_THREADS slots a CTA as make one wave of the kernel's resident CTAs, at
// most SB_MAX_TILES.  Within one wave the traced tiles are spread over the
// pool, so a CTA's pack may wait on a CTA with a later ticket: that launch is
// cooperative, which makes every CTA resident at once or fails
// (cudaErrorCooperativeLaunchTooLarge) instead of hanging.  Past one wave
// each CTA traces its own run's tiles and waits only on CTAs that started
// before it.  ray_use (4 counts, or null) adds the ray loop's counts.
int i3rc_shadow_block(const ShardParams* params, unsigned long long* ray_use, void* stream) {
  const ShardParams& p = *params;
  if (p.K < 1 || p.n_rays < 1 || p.n_comp < 1 || p.n_dirs < 1 || p.det == nullptr
      || p.cells == nullptr || p.acc_int == nullptr || p.acc_byc == nullptr
      || p.pool_f == nullptr || p.pool_i == nullptr || p.free_q == nullptr
      || p.tag_q == nullptr || p.send_q == nullptr || p.status == nullptr || p.ctl == nullptr
      || p.counts == nullptr || p.cap < 1 || p.rank < 0 || p.rank >= p.n_ranks
      || p.epoch < 1 || p.epoch >= (1 << 29))
    return (int)cudaErrorInvalidValue;
  // The CTAs of one wave, once a device.
  static int wave_dev = -1, wave = 0;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev != wave_dev) {
    int per_sm = 0, sms = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, shadow_block_kernel, CTA_THREADS,
                                                      0);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return (int)e;
    wave = per_sm * sms > 1 ? per_sm * sms : 1;
    wave_dev = dev;
  }
  const int n_tiles = (p.n_rays + CTA_THREADS - 1) / CTA_THREADS;
  const int fit = (n_tiles + wave - 1) / wave;
  int T = fit < SB_MAX_TILES ? fit : SB_MAX_TILES;
  const int runs = (n_tiles + T - 1) / T;
  int smem = p.nx_loc * p.n_y * p.n_dirs * (p.n_comp + 2) <= SB_SMEM_BINS;
  int interleave = runs <= wave;
  if (interleave) {
    void* args[] = {const_cast<ShardParams*>(&p), &T, &smem, &interleave, &ray_use};
    return (int)cudaLaunchCooperativeKernel((const void*)shadow_block_kernel, dim3(runs),
                                            dim3(CTA_THREADS), args, 0, (cudaStream_t)stream);
  }
  shadow_block_kernel<<<runs, CTA_THREADS, 0, (cudaStream_t)stream>>>(p, T, smem, interleave,
                                                                         ray_use);
  return (int)cudaGetLastError();
}

}  // extern "C"
