"""Test configuration.

Tests run on the CPU with 8 virtual devices, so the multi-device
sharding tests work anywhere, and with x64 enabled, so accuracy oracles
can be checked at reference tolerances (tests/correctness.cpp uses
1e-13).  Tests marked ``gpu`` need an NVIDIA GPU and skip elsewhere
(``chip_smoke.py`` covers the same checks at full size); on a machine
with one, run them with ``JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu
tests/``.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax

jax.config.update("jax_platforms", os.environ.get("JAX_PLATFORMS", "cpu"))
jax.config.update("jax_enable_x64", True)

import pytest


@pytest.fixture(scope="session")
def stokes_plan64():
    """ONE f64 Stokes BEM plan (rec-3 sphere, the reference StokesBEM
    defaults) shared by every module that needs it — the 8-component
    p=10 f64 plan build plus its jit tiers cost ~30 s each and three
    modules used to build it independently (round-3 VERDICT: suite
    wall-clock).  Read-only: tests only call apply/apply_flipped_bc,
    which cache per-variant executables on the plan."""
    from fmm_bem_tpu.bem.panels import make_panels
    from fmm_bem_tpu.bem.triangulation import unit_sphere
    from fmm_bem_tpu.config import FMMConfig
    from fmm_bem_tpu.executor.plan import FmmPlan
    from fmm_bem_tpu.kernels.stokes_bem import StokesBEMKernel

    tris = unit_sphere(3)
    fields = make_panels(tris, K=4)  # ref StokesBEM defaults K=4
    kern = StokesBEMKernel(K=4, fine_K=19, mu=1e-3)
    plan = FmmPlan(
        kern, fields, FMMConfig(ncrit=32, dtype="float64", max_p=10)
    )
    return tris, fields, kern, plan


@pytest.fixture
def gpu():
    """The first GPU device; skips the test where there is none."""
    gpus = [d for d in jax.devices() if d.platform == "gpu"]
    if not gpus:
        pytest.skip("needs an NVIDIA GPU (chip_smoke.py runs this check "
                    "on the card)")
    return gpus[0]
