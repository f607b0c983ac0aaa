"""References of the sharded tracer's CPU tests: JAX ``trace_sharded`` on a
mesh of 4 of the virtual CPU devices (``tests/conftest.py``), and the
port's unsharded ``Integrator`` (maximum cross-section) on the same scenes
of ``tests/sharded_scenes.py``.  Imports JAX: the card's machine never
loads it.
"""

import jax
import numpy as np
from jax.sharding import Mesh

import sharded_scenes as ss

LANES = 1 << 11          # lanes a rank (JAX and port)
PHOTONS = 1 << 13        # photons of a sharded trace


def jax_trace(name: str, n_photons: int = PHOTONS, seed: int = 2, n_dev: int = 4) -> dict:
    """The scene through JAX ``trace_sharded`` on a mesh of ``n_dev`` CPU
    devices, summarized as ``ss.summary`` does."""
    from i3rc_tpu.core.illumination import PhotonSource
    from i3rc_tpu.parallel.sharded_domain import trace_sharded

    sc = ss.scene(name, ss.host("i3rc_tpu"))
    mesh = Mesh(np.array(jax.devices()[:n_dev]), axis_names=("shard",))
    raw = trace_sharded(sc["domain"], PhotonSource.directional(*sc["src"]), n_photons, mesh,
                        n_lanes_per_shard=LANES, max_events=500,
                        seed_key=jax.random.PRNGKey(seed), **sc["kw"])
    a = np.asarray
    return dict(flux_up=a(raw.flux_up), flux_down=a(raw.flux_down),
                flux_absorbed=a(raw.flux_absorbed), volume=a(raw.volume_absorption),
                intensity=a(raw.intensity), by_component=a(raw.intensity_by_component),
                n_photons=int(raw.n_photons), n_bad=int(raw.n_bad),
                migrations=float(raw.n_lane_events))


def _derive(res):
    out = {"fup": res.mean_flux_up, "fdn": res.mean_flux_down, "fabs": res.mean_flux_absorbed,
           "profile": res.volume_absorption.sum(dim=(0, 1))}
    if res.intensity.numel():
        out["intensity"] = res.intensity.mean(dim=(0, 1))
    return out


def unsharded(name: str, n_per_batch: int = 1024, n_batches: int = 8, seed: int = 9,
              **cfg) -> dict:
    """The scene on the port's unsharded ``Integrator`` (maximum cross-
    section, on the CPU): domain means and their standard errors over the
    batches ({key: (mean, stderr)}), and the photons."""
    from i3rc_tpu_torch import Integrator, IntegratorConfig, PhotonSource
    from i3rc_tpu_torch.parallel.mesh import run_batches

    sc = ss.scene(name, ss.host("i3rc_tpu_torch"))
    kw = sc["kw"]
    cfg = dict(dict(use_ray_tracing=False, max_events=500, use_fastpath=False,
                    compute_volume_absorption=kw.get("compute_volume_absorption", False)), **cfg)
    integ = Integrator.create(sc["domain"], IntegratorConfig(**cfg),
                              surface_albedo=kw.get("surface_albedo", 0.0),
                              intensity_mus=kw.get("intensity_mus"),
                              intensity_phis=kw.get("intensity_phis"), device="cpu")
    st = run_batches(integ, PhotonSource.directional(*sc["src"]), n_per_batch, n_batches,
                     seed=seed, derive=_derive)
    d, e = st.mean["derived"], st.stderr["derived"]
    out = {k: (d[k].numpy(), e[k].numpy()) for k in d}
    out["n_photons"] = n_per_batch * st.n_batches
    return out


def flux_sigma(p: float, *ns) -> float:
    """Combined binomial standard error of a flux p over runs of ns photons
    (the per-photon variance floored at 0.05, as tests/test_sharded_domain.py
    floors it)."""
    return float(np.sqrt(max(p * (1 - p), 0.05) * sum(1.0 / n for n in ns)))


def fluxes(r: dict) -> dict:
    n = r["n_photons"]
    return {"fup": r["flux_up"].sum() / n, "fdn": r["flux_down"].sum() / n,
            "fabs": r["flux_absorbed"].sum() / n}


def radiance(r: dict, n_dirs: int) -> np.ndarray:
    """Domain-mean radiance per detector of a sharded trace's raw sums."""
    return r["intensity"].reshape(-1, n_dirs).sum(axis=0) / r["n_photons"]


# The radiance cases' shared fixture and checks (tests/test_torch_sharded_
# radiance.py: the random field's three detectors over an albedo;
# tests/test_torch_sharded_tabulated.py: the two-component C.1 scene).
N_DIRS = {"detectors": 3, "multi_tab": 2}
N_COMP = {"detectors": 1, "multi_tab": 2}


def radiance_runs(name: str, seed: int) -> dict:
    """Gloo worlds of 2 and 4 ranks (started first, run while this process
    traces the references), JAX ``trace_sharded`` and the port's unsharded
    general kernel: 16 batches of 1024, since C.1's forward peak makes the
    per-photon radiance heavy-tailed and 8 batches' standard error can come
    out at half its size."""
    worlds = {n: ss.start_world(n, ss.trace_cases, ([name], PHOTONS, LANES, seed))
              for n in (2, 4)}
    jx = jax_trace(name)
    un = unsharded(name, 1024, 16)
    return {"worlds": {n: ss.join_world(w, timeout=600)[0][name] for n, w in worlds.items()},
            "jax": jx, "unsharded": un}


def check_radiance(runs: dict, name: str, n_dev: int) -> None:
    """Per detector, the domain-mean radiance against the unsharded run and
    against JAX within 5 combined standard errors: the unsharded run's
    batch standard error of the domain mean, scaled to each sharded run's
    photons (a sharded trace has no batches of its own)."""
    D = N_DIRS[name]
    s = runs["worlds"][n_dev]
    got = radiance(s, D)
    jx = radiance(runs["jax"], D)
    mean, se = runs["unsharded"]["intensity"]
    scale = runs["unsharded"]["n_photons"] / s["n_photons"]
    assert np.all(got > 0.0)
    np.testing.assert_array_less(np.abs(got - mean), 5 * se * np.sqrt(1.0 + scale))
    np.testing.assert_array_less(np.abs(got - jx), 5 * se * np.sqrt(2.0 * scale))
    assert s["n_bad"] < 0.001 * s["n_photons"] + 2 and s["migrations"] > 0


def check_split(runs: dict, name: str, n_dev: int) -> None:
    """The radiance split by slot (0 the surface, 1 + c component c) sums
    to the total; the surface feeds upward detectors only; over black no
    surface radiance; each scatterer's slot fills."""
    D, C = N_DIRS[name], N_COMP[name]
    s = runs["worlds"][n_dev]
    byc = s["by_component"].reshape(-1, D, C + 1)
    np.testing.assert_allclose(byc.sum(axis=-1), s["intensity"].reshape(-1, D), rtol=1e-12,
                               atol=1e-12)
    if name == "detectors":
        assert byc[:, 2, 0].sum() == 0.0          # downward detector: no surface
        assert byc[:, 0, 0].sum() > 0.0           # nadir detector sees the surface
    else:
        assert byc[:, :, 0].sum() == 0.0          # black surface
        assert all(byc[:, 0, c].sum() > 0.0 for c in range(1, C + 1))
