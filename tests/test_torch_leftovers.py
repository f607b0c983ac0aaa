"""The last members and modules the port lacked: ``Integrator.with_params``
and ``is_ready`` against the JAX package's (i3rc_tpu/integrators/
integrator.py:301-327), the package's exports against the JAX package's
(``OpticalComponent`` among them), and ``utils/profiling.py``'s table of a
``torch.profiler`` trace (each port kernel's row, the torch glue, a card
trace that recorded no kernel, the host table of a CPU run).
"""

import dataclasses
import json

import numpy as np
import pytest

import i3rc_tpu
import i3rc_tpu_torch
from i3rc_tpu.core.surface import SurfaceDescription as JSurface
from i3rc_tpu.integrators.integrator import Integrator as JIntegrator
from i3rc_tpu.models.step_cloud import make_step_cloud as jax_cloud
from i3rc_tpu_torch import Integrator, OpticalComponent, SurfaceDescription
from i3rc_tpu_torch.models.step_cloud import make_step_cloud
from i3rc_tpu_torch.utils import profiling

UPDATES = {
    "config": dict(max_events=300, fastpath_chain=5, use_ray_tracing=False),
    "albedo": dict(surface_albedo=0.3),
    "detectors": dict(intensity_mus=[0.5, -0.5], intensity_phis=[0.0, 90.0]),
    "surface": dict(surface="rpv"),
}


def _surface(cls):
    return cls.uniform([0.2, 0.8, -0.1], "rpv")


def _state(integ, surface_cls) -> dict:
    """What with_params decides: the config's fields, the surface (albedo,
    BRDF name and parameters), the detectors."""
    cfg = dataclasses.asdict(integ.config)
    srf = integ._surface_arg
    return {"config": cfg, "albedo": float(integ._surface_albedo),
            "brdf": None if srf is None else (srf.brdf_name, np.asarray(srf.parameters).tolist()),
            "mus": None if integ._intensity_mus is None else np.asarray(integ._intensity_mus).tolist(),
            "phis": (None if integ._intensity_phis is None
                     else np.asarray(integ._intensity_phis).tolist())}


@pytest.mark.parametrize("case", sorted(UPDATES))
def test_with_params_agrees_with_the_jax_package(case):
    kw = dict(UPDATES[case])
    jkw, tkw = dict(kw), dict(kw)
    if kw.get("surface") == "rpv":
        jkw["surface"], tkw["surface"] = _surface(JSurface), _surface(SurfaceDescription)
    base = dict(surface_albedo=0.1)
    j = JIntegrator.create(jax_cloud(1.0), **base).with_params(**jkw)
    t = Integrator.create(make_step_cloud(1.0), device="cpu", **base).with_params(**tkw)
    js, ts = _state(j, JSurface), _state(t, SurfaceDescription)
    shared = set(js["config"]) & set(ts["config"])
    assert {k: js["config"][k] for k in shared} == {k: ts["config"][k] for k in shared}
    assert {k: v for k, v in js.items() if k != "config"} == \
        {k: v for k, v in ts.items() if k != "config"}
    assert j.is_ready and t.is_ready
    assert t.device.type == "cpu"
    if case == "config":
        assert t.config.fastpath_chain == 5 and t._fast_plan is not None


def test_with_params_refuses_unknown_names_as_the_jax_package_does():
    j = JIntegrator.create(jax_cloud(1.0))
    t = Integrator.create(make_step_cloud(1.0), device="cpu")
    for integ in (j, t):
        with pytest.raises(TypeError, match="unknown parameters"):
            integ.with_params(max_events=10, no_such_field=1)


def test_the_package_exports_what_the_jax_package_exports():
    assert set(i3rc_tpu.__all__) <= set(i3rc_tpu_torch.__all__)
    comp = make_step_cloud(1.0).components[0]
    assert isinstance(comp, OpticalComponent)
    assert i3rc_tpu_torch.OpticalComponent is OpticalComponent


KERNEL_NAMES = {
    "void fast_event_block_kernel<2, false, false, false, false, false, false, false, 8, "
    "false, false>(float*, int*, double*, float4 const*, int, EventParams)":
        "event block (K1, K2, K3, COL)",
    "void fast_event_block_kernel<-1, true, true, false, false, false, true, false, 8, "
    "false, false>(float*, int*, double*, float4 const*, int, EventParams)":
        "event block (K1, K2, K3, COL)",
    "void fast_event_block_kernel_march<0, false, true, true, true, false, false, true, 8, "
    "false, false>(float*, int*, double*, float4 const*, int, EventParams)":
        "K3-M (event block, marching trace)",
    "void fast_event_block_surface_kernel<false>(float*, int*, int, EventParams)":
        "S (surface stage)",
    "void fast_event_block_surface_kernel_march(float*, int*, int, EventParams)":
        "S-M (marching surface stage)",
    "void general_event_block_kernel<1, false, false, false, false>(float*, int*, "
    "GeneralParams)": "G (general block)",
    "void general_event_block_kernel<0, true, true, false, true>(float*, int*, "
    "GeneralParams)": "G+E (general block, detectors)",
    "void polarized_event_block_kernel<true, false>(PolarizedParams)": "PZ (polarized block)",
    "sharded_event_block_kernel(float*, int*, ShardParams)": "SD (sharded block)",
    "shadow_block_kernel(ShardParams)": "SB (sharded shadow rays)",
    "column_read_probe_kernel(float const*, float4 const*, float*, int, unsigned int)":
        "column-read probe",
    "void at::native::vectorized_elementwise_kernel<4, at::native::FillFunctor<float>>":
        profiling.GLUE,
}


def test_each_kernel_name_has_its_row():
    for name, label in KERNEL_NAMES.items():
        assert profiling.kernel_label(name) == label, name


def _write_trace(path, events, sidecar=None):
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps({"traceEvents": events}))
    if sidecar is not None:
        (path.parent / profiling.SIDECAR).write_text(json.dumps(sidecar))


def test_profile_report_sums_device_time_by_kernel(tmp_path):
    events = [{"cat": "kernel", "name": n, "dur": 10.0 * (k + 1), "ts": k}
              for k, n in enumerate(KERNEL_NAMES)]
    events.append({"cat": "cpu_op", "name": "aten::add", "dur": 5.0, "ts": 0, "pid": 1, "tid": 1})
    trace = tmp_path / "trace-1.json"
    _write_trace(trace, events, {"trace": trace.name, "device": "cuda:0", "taken": 2,
                                 "dropped": 1})
    report = profiling.profile_report(str(tmp_path))
    assert "traces taken 2, dropped 1" in report
    rows = {line[4:44].strip(): line for line in report.splitlines()[1:]}
    assert set(rows) == set(KERNEL_NAMES.values())
    event_row = rows["event block (K1, K2, K3, COL)"]
    assert "x2 " in event_row and "0.030 ms" in event_row      # 10 + 20 us
    total = sum(10.0 * (k + 1) for k in range(len(KERNEL_NAMES))) / 1e3
    assert f"total {total:.3f} ms" in report.splitlines()[0]


def test_profile_report_names_a_card_trace_with_no_kernel(tmp_path):
    trace = tmp_path / "trace-2.json"
    _write_trace(trace, [{"cat": "cpu_op", "name": "aten::add", "dur": 5.0, "ts": 0}],
                 {"trace": trace.name, "device": "cuda:0", "taken": 3, "dropped": 3})
    report = profiling.profile_report(str(tmp_path))
    assert "recorded no device kernel" in report and "dropped 3" in report
    assert "ms  " not in report
    assert "no torch.profiler trace" in profiling.profile_report(str(tmp_path / "none"))


def test_profile_run_on_the_cpu_gives_the_host_table(tmp_path):
    import torch

    out = profiling.profile_run(lambda: (torch.ones(64) * 2).sum().item(), str(tmp_path), "cpu")
    assert out == 128.0
    side = json.loads((tmp_path / profiling.SIDECAR).read_text())
    assert side["taken"] == 1 and side["dropped"] == 0
    report = profiling.profile_report(str(tmp_path))
    assert "a CPU run: no device" in report and "aten::" in report
