"""The port never imports jax nor the JAX package: checked in a fresh
interpreter (tests/test_torch_host_layer.py runs the wider guard)."""

import os
import subprocess
import sys
import textwrap

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_port_does_not_import_jax():
    code = textwrap.dedent("""
        import sys
        import torch
        torch.set_num_threads(2)
        from i3rc_tpu_torch import (Integrator, IntegratorConfig, PhotonSource, batch_key,
                                    make_step_cloud)
        import i3rc_tpu_torch.drivers.monte_carlo_driver
        import i3rc_tpu_torch.parallel.mesh
        integ = Integrator.create(make_step_cloud(1.0),
                                  IntegratorConfig(use_ray_tracing=False), device="cpu")
        res = integ.compute(batch_key(1, 0), PhotonSource.directional(0.5, 0.0), 2048)
        assert abs(float(res.mean_flux_up + res.mean_flux_down) - 1.0) < 1e-5
        print(sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "i3rc_tpu")))
    """)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_cuda_device_without_a_card_raises():
    import pytest
    import torch

    from i3rc_tpu_torch import Integrator, make_step_cloud

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Integrator.create(make_step_cloud(1.0), device="cuda")
