"""The harness on the CPU: discovery by name, the last line, no card, no JAX."""

import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

from rtbench import cells, host, run, stats, trace, work

ROOT = cells.ROOT


def test_every_cell_finds_its_parts():
    bench = cells.benchmark()
    for w in bench["workloads"]:
        c = cells.load(w["name"])
        scene = c.config.scene(c.traffic["ssa"])
        assert scene["ext"].ndim == 3 and c.config.REDUCED == []
        assert set(c.cell["limits"]) == {"z_domain", "chi2_blocks", "var_excess",
                                         "batches_repeated"}
        assert {m["name"] for m in c.end_to_end} >= {"photons_per_s", "batch_ms_p95",
                                                      "setup_s"}
        for m in c.per_layer:
            assert callable(cells.metric_reader(m["name"]))
    for cfg in bench["configs"]:
        mod = cells._module(ROOT / cfg["file"])
        assert mod.SOURCE == cfg["source"] and mod.REDUCED == cfg["reduced"]


def test_a_new_config_mix_metric_and_cell_are_found_without_an_edit(tmp_path):
    shutil.copytree(ROOT / "rtbench", tmp_path / "rtbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    here = tmp_path / "rtbench"
    bench = cells.benchmark()
    bench["configs"].append({"name": "slab", "source": "a test", "file": "rtbench/configs/slab.py",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "slab.flux", "config": "slab", "traffic": "tiny",
                               "chips": 1, "why": "a test"})
    bench["per_layer"].append({"name": "photons_per_batch", "unit": "photons", "better":
                               "higher", "source": "program_counter", "layer": "batch loop",
                               "moves": "photons_per_s", "workloads": ["slab.flux"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    (here / "configs" / "slab.py").write_text(
        "import numpy as np\nSOURCE = 'a test'\nREDUCED = []\nSETTINGS = {}\n"
        "COMPARE_BLOCK = (1, 1)\n"
        "def scene(ssa):\n    return {'ext': np.ones((1, 1, 1))}\n")
    (here / "traffic" / "tiny.json").write_text(json.dumps({"photons_per_batch": 8, "ssa": 1.0}))
    (here / "cells" / "slab.flux.json").write_text(json.dumps({"limits": {}}))
    (here / "metrics" / "photons_per_batch.py").write_text(
        "def read(ctx):\n    return ctx.photons_per_batch\n")
    c = cells.load("slab.flux", root=tmp_path, here=here)
    assert c.traffic["photons_per_batch"] == 8 and c.config.scene(1.0)["ext"].shape == (1, 1, 1)
    assert [m["name"] for m in c.per_layer][-1] == "photons_per_batch"
    ctx = trace.Trace(batches=1, batch_ms=[1.0], photons_per_batch=8, device_s={}, busy_s=0.0,
                      window_s=0.0, idle_by_host={}, launches=None)
    assert cells.metric_reader("photons_per_batch", here=here)(ctx) == 8
    # The cells already committed are untouched by the new ones.
    assert cells.load("step_cloud.flux", root=tmp_path, here=here).traffic == \
        cells.load("step_cloud.flux").traffic


def test_the_last_line_has_the_contract_shape(tiny):
    cell = tiny("step_cloud.flux")
    out = run.run_cell(cell, 2**31 + 11, 0.0, False, device="cpu", batches=6)
    assert list(out)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(out)[-1] == "checks"
    assert out["attempted"] == 6 * cell.traffic["photons_per_batch"] and out["failed"] == 0
    assert {k: v["unit"] for k, v in out["metrics"].items()} == \
        {m["name"]: m["unit"] for m in cell.end_to_end}
    assert all(v["value"] > 0 for v in out["metrics"].values())
    assert set(out["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    assert set(out["checks"]) == set(cell.cell["limits"])
    json.loads(json.dumps(out))


def test_a_run_without_a_card_fails_and_prints_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run([sys.executable, "rtbench/run.py", "--workload", "step_cloud.flux",
                        "--seed", "1", "--seconds", "1", "--trace", "0"],
                       cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""
    assert "CUDA device" in p.stderr


def test_in_a_directory_of_the_benchmark_alone_a_run_fails(tmp_path):
    shutil.copytree(ROOT / "rtbench", tmp_path / "rtbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    p = subprocess.run([sys.executable, "rtbench/run.py", "--workload", "step_cloud.flux",
                        "--seed", "1", "--seconds", "1", "--trace", "0"],
                       cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_top_level_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "i3rc_tpu_torch_fake.sub", sys)
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "i3rc_tpu.models", sys)
    assert run.forbidden_modules() == ["i3rc_tpu"]


def test_a_cells_set_up_loads_no_jax():
    code = ("import sys; sys.path.insert(0, '.'); from rtbench import run, port, cells; "
            "c = cells.load('landsat.radiance'); "
            "i, s = port.integrator(c.config.scene(0.99), c.config.SETTINGS, c.traffic, 'cpu'); "
            "port.batch_fn(i, s, dict(c.traffic, photons_per_batch=256, lanes=256))"
            "(port.batch_key(1, 0)); print(run.forbidden_modules())")
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                       timeout=600)
    assert p.returncode == 0, p.stderr[-2000:]
    assert p.stdout.strip().splitlines()[-1] == "[]"


def test_the_trace_reduction_on_a_small_trace():
    ev = [{"cat": "user_annotation", "name": trace.SPAN, "ts": 0, "dur": 100, "tid": 1},
          {"cat": "cpu_op", "name": "aten::item", "ts": 40, "dur": 30, "tid": 1},
          {"cat": "kernel", "name": "void fast_event_block_kernel<1>", "ts": 10, "dur": 20},
          {"cat": "kernel", "name": "at::native::vectorized_elementwise", "ts": 25, "dur": 10},
          {"cat": "gpu_memcpy", "name": "Memcpy DtoH", "ts": 80, "dur": 10}]
    r = trace.reduce(ev)
    assert r["device_s"] == pytest.approx({"event block (K1, K2, K3, COL)": 20e-6,
                                           "torch glue": 20e-6})
    assert r["busy_s"] == pytest.approx(35e-6) and r["window_s"] == pytest.approx(100e-6)
    assert r["idle_by_host"] == pytest.approx({trace.SPAN: 20e-6, "aten::item": 45e-6})
    b = trace.breakdown(r)
    assert b["idle_gaps"][0][0] == "aten::item" and len(b["device_ops"]) == 2


def test_var_excess_reads_photons_that_repeat_others():
    """Batches of n independent Bernoulli photons read under 0; batches of
    n / 2 photons each counted twice keep the mean and read about 1 less
    three standard errors."""
    g = torch.Generator().manual_seed(3)
    n, batches, p = 1 << 12, 400, 0.4
    pieces = stats.layout(1, 1, 0, (1, 1))

    def moments(independent):
        mom = stats.Moments(pieces)
        for _ in range(batches):
            x = (torch.rand(independent, generator=g) < p).to(torch.float64)
            up = x.mean().reshape(1, 1)
            mom.add(stats.fields(up, 1.0 - up, torch.zeros(1, 1), torch.zeros(1, 1, 0),
                                 (1, 1)))
        return mom
    var = {"mean_flux_up": p * (1 - p), "mean_flux_down": p * (1 - p)}
    se = (2 / (batches - 1)) ** 0.5
    assert stats.var_excess(moments(n), n, var) < 0
    assert stats.var_excess(moments(n // 2), n, var) == pytest.approx(1 - 3 * se, abs=4 * se)


def test_the_least_time_takes_the_slowest_pipe():
    # Collisions alone: every instruction is issued, so the issue rate
    # bounds them; the bytes bound a batch with no work.
    t, by = work.least_seconds(0, 1e9, 0, 0, 0, 1)
    assert by == "issue" and t == pytest.approx(sum(work.OPS_PER_COLLISION) * 1e9
                                                / work.ISSUE_PER_S)
    t, by = work.least_seconds(0, 0, 0, 10**9, 0, 2)
    assert by == "bytes" and t == pytest.approx(2e9 / work.HBM_BYTES_PER_S)
    assert work.INT32_PER_S == pytest.approx(work.FP32_PER_S / 2)


def test_the_host_readings_between_two_snapshots():
    a = host.snapshot()
    b = host.snapshot()
    h = host.between(a, b)
    assert h["probe_ms_before"] > 0 and h["probe_ms_after"] > 0 and h["own_cpu_pct"] >= 0
