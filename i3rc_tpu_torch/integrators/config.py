# Copy of i3rc_tpu/integrators/config.py: the port keeps its own host layer and imports
# nothing of i3rc_tpu.
"""Integrator configuration.

All 16 optional parameters of the reference's single mutation point
specifyParameters (Integrators/monteCarloRadiativeTransfer.f95:830-1069) map
onto this frozen dataclass plus the Integrator constructor arguments (surface
and intensity directions carry arrays, so they live on the Integrator).
Defaults match the reference's (monteCarloRadiativeTransfer.f95:36-43,
57-66, 118-129).

TPU-specific additions: the event and cell-crossing budgets that bound the
kernel's while_loops (the reference loops unboundedly and can hang on
grazing trajectories; we cap and count them in n_bad), and the wavefront
width (photon lanes stepped together).

On the port, ``general_chain`` and ``general_dda_steps`` are TPU
scheduling, not physics: the port accepts them, and ``general_chain``
(with the JAX package's auto rule) still picks the weight-1 estimator of
the chained tracer (Bernoulli absorption, counts for exits and deaths),
but its general event block (kernels/general_block.py) schedules its own
way: every flight runs to its end in one thread, K events per launch.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

from i3rc_tpu_torch.utils.errors import Status

DEFAULT_MIN_FORWARD_TABLE_SIZE = 9001
DEFAULT_MIN_INVERSE_TABLE_SIZE = 9001
DEFAULT_HYBRID_PHASE_FUN_WIDTH = 7.0
MAX_HYBRID_PHASE_FUN_WIDTH = 30.0
DEFAULT_ZETA_MIN = 0.3
DEFAULT_MAX_INTENSITY_CONTRIBUTION = 3.4028e38


@dataclass(frozen=True)
class IntegratorConfig:
    # Transport algorithm: voxel ray tracing vs Marchuk maximum cross-section
    # (monteCarloRadiativeTransfer.f95:63, :408-412).
    use_ray_tracing: bool = True
    # Russian roulette on photon weight (:65-66, :673-679).
    use_russian_roulette: bool = True
    russian_roulette_w: float = 1.0
    # Iwabuchi (JAS 2006) Russian roulette for intensity traces (:123-124).
    use_russian_roulette_for_intensity: bool = False
    zeta_min: float = DEFAULT_ZETA_MIN
    # Hybrid Gaussian-forward-peak phase functions for local estimation
    # (:118-120, :1925-2039).
    use_hybrid_phase_funs: bool = False
    hybrid_phase_fun_width: float = DEFAULT_HYBRID_PHASE_FUN_WIDTH
    num_orders_orig_phase_fun: int = 0
    # Barker-style local-estimate clipping + excess redistribution (:127-130).
    limit_intensity_contributions: bool = False
    max_intensity_contribution: float = DEFAULT_MAX_INTENSITY_CONTRIBUTION
    # Tabulation resolutions (:36-37).
    min_forward_table_size: int = DEFAULT_MIN_FORWARD_TABLE_SIZE
    min_inverse_table_size: int = DEFAULT_MIN_INVERSE_TABLE_SIZE
    # Tally 3D volume absorption?  The reference always accumulates it; when
    # the outputs aren't requested (reportVolumeAbsorption/-Profile both
    # false) skipping it keys the tallies on columns instead of cells — a
    # large saving for the one-hot tally matmul on TPU.
    compute_volume_absorption: bool = True
    # Super-voxel majorant transport (Woodcock tracking): free paths are
    # sampled against per-block maxima instead of the reference's single
    # global maximum cross-section (:439), removing null collisions in
    # optically thin regions.  Value = block edge length in cells (must
    # divide each grid dimension, clamped per-axis); 0 = auto: reference
    # behavior (one global majorant) on one-hot-read domains, 8 on
    # serial-gather domains (> ops/gather.ONEHOT_MAX_ROWS cells), where a
    # global majorant makes null-collision events — each paying a ~35 ns/lane
    # serialized read — dominate (see Integrator.create).
    # Unbiased: identical expectation, different (better) event count.
    majorant_block_size: int = 0
    # Unbiased stochastic transmittance for local-estimate radiances (ratio
    # tracking over the super-voxel majorant grid, Galtier et al. 2013 style
    # null-collision estimator) instead of the deterministic cell-by-cell
    # optical-depth trace.  Requires majorant_block_size > 0.  Expected cost
    # per contribution drops from O(cells crossed) to O(majorant optical
    # depth), with roulette on the running transmittance (zeta_min) bounding
    # deep paths; adds variance, identical expectation (no reference analog —
    # the reference always traces exactly, :1512-1535).
    use_ratio_tracking_for_intensity: bool = False
    # --- TPU kernel budgets (no reference analog; see module docstring) ----
    max_events: int = 1000          # scattering orders per photon
    max_crossings: int = 0          # 0 -> auto: 8 * (nx + ny + nz)
    max_intensity_crossings: int = 0
    # Fused elementwise fastpath (integrators/fastpath.py): auto-selected for
    # eligible workloads (conservative single-HG-component separable optics,
    # black surface, flux-only, non-ray-tracing); identical expectations,
    # different RNG event stream.  fastpath_unroll = events per tally/refill
    # block (the deferred-tally period K).
    use_fastpath: bool = True
    # None = auto: 8 for separable media (the Mosaic compile-time sweet spot
    # — the unrolled event block compiles in ~2 min; K=16 gains +3% for ~5
    # min of compile), 32 for column media (XLA path, no Mosaic compile
    # cost; the gather-bound event loop amortizes its flush/refill and loop
    # fixed costs over the longer block — measured 1.5 -> 2.1 M photons/s on
    # the full Landsat scene, PERF_NOTES.md round-3 column ledger).
    # Explicit values must be >= 1 (validate() rejects 0 rather than
    # silently re-reading it as auto).
    fastpath_unroll: int | None = None
    # Segment-march depth: crossings consumed per event before/until the
    # collision.  >1 pays only in crossing-dominated media; on the I3RC
    # step cloud collisions dominate (the tau=18 half), so every extra
    # substep is wasted where-lane work — measured slower.  Default 1.
    fastpath_march: int = 1
    # Collision-chaining depth (bonus phases per event): after the main
    # collision + rotation, up to this many further collisions resolve
    # inline while the candidate point stays inside the current segment box
    # (extinction provably constant there — no face logic needed; leaving
    # the box defers the drawn optical depth to the next full event, exact
    # by free-path memorylessness).  Pays in collision-dominated media; a
    # bonus phase costs ~1/3 of a full event's vector work.  Ignored when
    # radiance detectors are active (each collision needs shadow traces).
    # Default -1 = auto: the round-5 bench-chip A/B found the optimum is
    # WORKLOAD-dependent — plain cloud media peak at depth 2 (5.41e8 vs
    # 5.10e8 photons/s at 3; 4.55e8 at 4; 3.97e8 at 1), the baked gas
    # channel at depth 3 (3.21e8 vs 2.43e8 at 2).  Explicit values >= 0
    # override; 0 disables chaining.
    fastpath_chain: int = -1
    # Queued (persistent-ray) local estimation in the general kernel: each
    # lane owns D shadow-ray slots that advance a bounded number of DDA
    # crossings per transport event at full occupancy, instead of tracing
    # every collision's rays to completion inline (where the per-event
    # while_loop runs to the WORST ray's crossing count with most
    # pseudo-lanes idle).  A lane that collides again while its rays are
    # still tracing freezes until the slots drain — exact, lane-aligned (no
    # gathers), and the stall cost is bounded by intensity_ray_steps.
    # Identical expectation to the inline estimator; applies to the
    # deterministic and Iwabuchi estimators (ratio tracking keeps its own
    # inline path).  intensity_ray_steps = crossings advanced per transport
    # event; 0 = auto ((nx+ny+nz)/2 clamped to [8, 64] — the ray service
    # rate must cover a typical boundary trace per collision interval, or
    # photons stall waiting for their slots; a too-small value measured
    # 10x slower than inline on the step cloud).
    use_queued_intensity: bool = True
    intensity_ray_steps: int = 0
    # Chained Woodcock cycles per event-loop iteration in the GENERAL
    # kernel (large-domain flux workloads): each iteration resolves up to
    # this many tentative collisions per lane, amortizing the per-iteration
    # fixed costs (column tally matmul, RNG block, refill, loop plumbing)
    # that dominate once the per-cell read is a single serialized gather.
    # Exits pend in per-lane registers and tally once per iteration (a lane
    # exits at most once per iteration — it only refills at iteration
    # start), so eligibility requires the class where transport neither
    # deposits nor revives: flux-only, black surface, conservative
    # single-component uniform optics, super-voxel majorants on.  0 = auto
    # (6 on serial-gather domains, off on one-hot domains); 1 = off.
    general_chain: int = 0
    # Coarse-DDA crossings advanced per chained cycle (the flight resumes
    # next cycle if unfinished — remaining optical depth is carried, exact).
    # Replaces the lockstep while_loop that runs every lane to the WORST
    # lane's crossing count (measured 19.4 avg iterations/event on Landsat
    # where the mean flight needs ~4).  0 = auto (8).
    general_dda_steps: int = 0
    # Pallas (Mosaic) event-block kernel for the fastpath: runs K = unroll
    # events per HBM round-trip with the whole wavefront state VMEM-resident
    # (ops-level analog of the XLA fastpath; same physics, different RNG
    # stream — the kernel draws from the TPU hardware PRNG seeded per
    # (batch key, block, grid program)).  None = auto (TPU backend only);
    # True forces it (interpret mode off-TPU, for tests); False disables.
    use_pallas_fastpath: bool | None = None

    def validate(self) -> "IntegratorConfig":
        """Range checks with the reference's warning-downgrade semantics."""
        s = Status()
        cfg = self
        if not (0.0 < cfg.hybrid_phase_fun_width < MAX_HYBRID_PHASE_FUN_WIDTH):
            s.warn_if(cfg.use_hybrid_phase_funs,
                      f"hybridPhaseFunWidth out of range (0, {MAX_HYBRID_PHASE_FUN_WIDTH}); "
                      f"using default {DEFAULT_HYBRID_PHASE_FUN_WIDTH}")
            cfg = replace(cfg, hybrid_phase_fun_width=DEFAULT_HYBRID_PHASE_FUN_WIDTH)
        if cfg.num_orders_orig_phase_fun < 0:
            s.warnings.append("numOrdersOrigPhaseFunIntenCalcs < 0; using 0")
            cfg = replace(cfg, num_orders_orig_phase_fun=0)
        if cfg.max_intensity_contribution <= 0.0:
            s.warnings.append("maxIntensityContribution <= 0; ignored")
            cfg = replace(cfg, max_intensity_contribution=DEFAULT_MAX_INTENSITY_CONTRIBUTION)
        if cfg.zeta_min < 0.0:
            s.warnings.append("zetaMin must be >= 0; using default")
            cfg = replace(cfg, zeta_min=DEFAULT_ZETA_MIN)
        s.warn_if(cfg.zeta_min > 1.0, "zetaMin > 1: that's kind of large")
        if cfg.min_forward_table_size < DEFAULT_MIN_FORWARD_TABLE_SIZE:
            s.warnings.append("minForwardTableSize less than default; value ignored")
            cfg = replace(cfg, min_forward_table_size=DEFAULT_MIN_FORWARD_TABLE_SIZE)
        if cfg.min_inverse_table_size < DEFAULT_MIN_INVERSE_TABLE_SIZE:
            s.warnings.append("minInverseTableSize less than default; value ignored")
            cfg = replace(cfg, min_inverse_table_size=DEFAULT_MIN_INVERSE_TABLE_SIZE)
        if cfg.general_chain < 0:
            s.warnings.append("general_chain must be >= 0; using auto")
            cfg = replace(cfg, general_chain=0)
        if cfg.general_dda_steps < 0:
            s.warnings.append("general_dda_steps must be >= 0; using auto")
            cfg = replace(cfg, general_dda_steps=0)
        if cfg.use_ratio_tracking_for_intensity and cfg.majorant_block_size <= 0:
            s.warnings.append("ratio tracking needs majorant_block_size > 0; "
                              "falling back to the deterministic trace")
            cfg = replace(cfg, use_ratio_tracking_for_intensity=False)
        if cfg.fastpath_unroll is not None and cfg.fastpath_unroll < 1:
            s.warnings.append("fastpath_unroll must be >= 1 (None = auto); "
                              "using auto")
            cfg = replace(cfg, fastpath_unroll=None)
        s.fail_if(cfg.russian_roulette_w <= 0.0, "russian_roulette_w must be positive")
        s.fail_if(cfg.max_events < 1, "max_events must be at least 1")
        s.check("IntegratorConfig")
        return cfg
