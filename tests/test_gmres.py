"""GMRES / FGMRES / relaxation tests (solver layer, ref
examples/BEM/GMRES.hpp)."""

import jax.numpy as jnp
import numpy as np
import pytest

from fmm_bem_tpu.config import FMMConfig, SolverConfig, RelaxType
from fmm_bem_tpu.executor.plan import FmmPlan
from fmm_bem_tpu.kernels.laplace import LaplaceKernel
from fmm_bem_tpu.solver.gmres import gmres, fgmres
from fmm_bem_tpu.solver import preconditioners as pc


def test_gmres_dense_matches_numpy():
    rng = np.random.default_rng(0)
    n = 80
    A = rng.standard_normal((n, n)) + n * np.eye(n)
    b = rng.standard_normal(n)
    Aj = jnp.asarray(A)
    x, info = gmres(
        lambda v, p: Aj @ v, b, config=SolverConfig(residual=1e-10)
    )
    assert info.converged
    assert np.allclose(np.asarray(x), np.linalg.solve(A, b), atol=1e-7)


def test_gmres_restart():
    rng = np.random.default_rng(1)
    n = 60
    A = rng.standard_normal((n, n)) + n * np.eye(n)
    b = rng.standard_normal(n)
    Aj = jnp.asarray(A)
    x, info = gmres(
        lambda v, p: Aj @ v,
        b,
        config=SolverConfig(residual=1e-9, restart=10, max_iters=200),
    )
    assert info.converged
    assert np.allclose(np.asarray(x), np.linalg.solve(A, b), atol=1e-6)


@pytest.fixture(scope="module")
def fmm_system():
    """Shifted Laplace potential system (diagonally dominant so GMRES
    converges quickly): A = P + c*I with P the FMM potential matrix.

    Module-scoped: four solver tests share ONE plan (and its per-p jit
    cache) — rebuilding it per test recompiled every relaxation tier
    and dominated the suite wall-clock."""
    n, seed = 900, 2
    rng = np.random.default_rng(seed)
    pts = rng.uniform(0, 1, (n, 3))
    K = LaplaceKernel()
    plan = FmmPlan(K, {"xyz": pts}, FMMConfig(ncrit=32, dtype="float64", max_p=10))
    shift = 50.0

    def matvec(x, p):
        return plan.apply(x, p=p)[:, 0] + shift * x

    # dense oracle
    diff = pts[None] - pts[:, None]
    r = np.sqrt((diff ** 2).sum(-1))
    np.fill_diagonal(r, np.inf)
    A = 1.0 / r + shift * np.eye(n)
    return matvec, A, rng.standard_normal(n)


def test_gmres_fmm_operator_fixed_p(fmm_system):
    matvec, A, b = fmm_system
    x, info = gmres(
        matvec, b, config=SolverConfig(residual=1e-8, max_p=10), p_fixed=10
    )
    assert info.converged
    exact = np.linalg.solve(A, b)
    rel = np.linalg.norm(np.asarray(x) - exact) / np.linalg.norm(exact)
    # solution accuracy is bounded by the FMM matvec accuracy at p=10
    assert rel < 1e-4, rel


def test_gmres_fmm_relaxed_bouras(fmm_system):
    """Variable-p (inexact Krylov) solve still converges to the true
    solution — the paper's central claim (arXiv:1506.05957).  Bouras-
    Fraysse starts at high p and relaxes as the residual drops."""
    matvec, A, b = fmm_system
    cfg = SolverConfig(
        residual=1e-6, max_p=10, p_min=2, variable_p=True,
        relax_type=RelaxType.BOURAS,
    )
    x, info = gmres(matvec, b, config=cfg)
    assert info.converged
    ps = [h[2] for h in info.history]
    # relaxation must actually have lowered p as the solve progressed
    assert min(ps) < max(ps), ps
    assert ps[0] == 10  # first matvecs at full accuracy
    exact = np.linalg.solve(A, b)
    rel = np.linalg.norm(np.asarray(x) - exact) / np.linalg.norm(exact)
    assert rel < 1e-4, rel


def test_gmres_fmm_relaxed_simoncini(fmm_system):
    """SIMONCINI mode mirrors the reference formula p=ceil(-log2(resid))
    (SolverOptions.hpp:34-35): p *grows* as the residual falls.  The
    preconditioned iteration reports convergence; true accuracy is
    limited by the inexact early matvecs — same behaviour as the
    reference (its Stokes solver adds a p_min floor for this reason,
    GMRES_Stokes.hpp:229)."""
    matvec, A, b = fmm_system
    cfg = SolverConfig(
        residual=1e-6, max_p=10, p_min=2, variable_p=True,
        relax_type=RelaxType.SIMONCINI,
    )
    x, info = gmres(matvec, b, config=cfg)
    assert info.converged
    ps = [h[2] for h in info.history]
    assert ps[0] < ps[-1], ps


def test_fgmres_with_diagonal_pc(fmm_system):
    matvec, A, b = fmm_system
    M = pc.diagonal(np.diag(A))
    x, info = fgmres(matvec, b, config=SolverConfig(residual=1e-8), M=M, p_fixed=10)
    assert info.converged
    exact = np.linalg.solve(A, b)
    assert np.linalg.norm(np.asarray(x) - exact) / np.linalg.norm(exact) < 1e-4


def test_predict_p_schedule():
    cfg = SolverConfig(residual=1e-5, max_p=16)
    # large residual -> small p; tiny residual -> capped at max_p
    # Bouras: p relaxes (shrinks) as the residual approaches the target
    assert cfg.predict_p(1.0) >= cfg.predict_p(1e-3) >= cfg.predict_p(1e-4)
    assert cfg.predict_p(1.0) == 16  # -log2(1e-5) = 16.6, capped at max_p
    assert cfg.predict_p(2e-5) <= 2  # nearly converged -> cheapest matvec


# ----------------------------------------------------------------------
# device-resident GMRES (solver.gmres.gmres_device)
# ----------------------------------------------------------------------
from fmm_bem_tpu.solver.gmres import (  # noqa: E402
    DeviceGmresContext,
    fgmres_device,
    gmres_device,
)


def test_gmres_device_dense():
    rng = np.random.default_rng(10)
    n = 80
    A = rng.standard_normal((n, n)) + n * np.eye(n)
    b = rng.standard_normal(n)
    Aj = jnp.asarray(A)
    x, info = gmres_device(
        lambda op, v, p: Aj @ v, b, config=SolverConfig(residual=1e-10)
    )
    assert info.converged
    assert np.allclose(np.asarray(x), np.linalg.solve(A, b), atol=1e-7)


def test_gmres_device_restart_and_context_reuse():
    rng = np.random.default_rng(11)
    n = 60
    A = rng.standard_normal((n, n)) + n * np.eye(n)
    b = rng.standard_normal(n)
    Aj = jnp.asarray(A)
    ctx = DeviceGmresContext()
    cfg = SolverConfig(residual=1e-9, restart=10, max_iters=200)
    x, info = gmres_device(lambda op, v, p: Aj @ v, b, config=cfg, context=ctx)
    assert info.converged
    # second solve reuses the compiled tier executables
    x2, info2 = gmres_device(
        lambda op, v, p: Aj @ v, 2 * b, config=cfg, context=ctx
    )
    assert info2.converged
    assert np.allclose(np.asarray(x2), np.linalg.solve(A, 2 * b), atol=1e-6)


def test_fgmres_device_with_pc():
    rng = np.random.default_rng(12)
    n = 70
    A = rng.standard_normal((n, n)) + n * np.eye(n)
    b = rng.standard_normal(n)
    Aj = jnp.asarray(A)
    dinv = jnp.asarray(1.0 / np.diag(A))
    x, info = fgmres_device(
        lambda op, v, p: Aj @ v,
        b,
        M=lambda r: dinv * r,
        config=SolverConfig(residual=1e-10),
    )
    assert info.converged
    assert np.allclose(np.asarray(x), np.linalg.solve(A, b), atol=1e-6)


def test_gmres_device_matches_host_on_bem_relaxed():
    """Device-resident tiered relaxation must reproduce the host loop:
    identical per-iteration p schedule and the same solution."""
    from fmm_bem_tpu.bem.panels import make_panels
    from fmm_bem_tpu.bem.triangulation import unit_sphere
    from fmm_bem_tpu.kernels.laplace_bem import LaplaceBEMKernel

    tris = unit_sphere(3)
    fields = make_panels(tris, K=3)
    n = len(tris)
    plan = FmmPlan(
        LaplaceBEMKernel(K=3),
        fields,
        FMMConfig(ncrit=32, dtype="float64", max_p=8),
    )
    q = np.ones(n)
    cfg = SolverConfig(residual=1e-5, max_p=8, max_iters=60, restart=60)
    b = np.asarray(plan.apply(q, p=8)[:, 0])
    mv, op4p = plan.solver_ops(flipped=True)
    x_d, info_d = gmres_device(mv, b, operand_for_p=op4p, config=cfg)
    x_h, info_h = gmres(
        lambda v, pp: plan.apply_flipped_bc(v, p=pp)[:, 0], b, config=cfg
    )
    assert info_d.converged and info_h.converged
    assert info_d.iterations == info_h.iterations
    assert [h[2] for h in info_d.history] == [h[2] for h in info_h.history]
    assert np.allclose(np.asarray(x_d), np.asarray(x_h), atol=1e-8)
    # second-kind sphere: solution is phi = 1
    err = np.linalg.norm(np.asarray(x_d) - 1.0) / np.sqrt(n)
    assert err < 0.05, err


# ----------------------------------------------------------------------
# FMGMRES inner-outer preconditioning (ref examples/BEM/fmgmres.hpp)
# ----------------------------------------------------------------------
from fmm_bem_tpu.solver.fmgmres import (  # noqa: E402
    fmgmres,
    fmgmres_device,
    make_inner_pc_device,
)


def test_fmgmres_dense_converges_fewer_outer_iterations():
    rng = np.random.default_rng(20)
    n = 120
    # moderately ill-conditioned SPD-ish system so plain GMRES needs
    # many iterations
    Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    diag = np.logspace(0, 3, n)
    A = Q @ np.diag(diag) @ Q.T
    b = rng.standard_normal(n)
    Aj = jnp.asarray(A)
    mv = lambda v, p: Aj @ v

    cfg = SolverConfig(residual=1e-8, max_iters=200, restart=200)
    x0, info0 = gmres(mv, b, config=cfg, p_fixed=1)
    x1, info1 = fmgmres(mv, b, config=cfg, inner_iters=20, inner_tol=1e-2,
                        p_inner=1)
    assert info1.converged
    assert info1.iterations < info0.iterations / 2, (
        info0.iterations, info1.iterations)
    assert np.allclose(np.asarray(x1), np.linalg.solve(A, b), atol=1e-5)


def test_fmgmres_device_matches_host_quality():
    rng = np.random.default_rng(21)
    n = 100
    Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    A = Q @ np.diag(np.logspace(0, 2.5, n)) @ Q.T
    b = rng.standard_normal(n)
    Aj = jnp.asarray(A)
    mv = lambda op, v, p: Aj @ v

    cfg = SolverConfig(residual=1e-8, max_iters=120, restart=120)
    x, info = fmgmres_device(
        mv, b, operand_for_p=lambda p: None, config=cfg, inner_k=10,
        p_inner=1,
    )
    assert info.converged
    # unpreconditioned device solve for comparison
    from fmm_bem_tpu.solver.gmres import gmres_device

    _, info0 = gmres_device(mv, b, config=cfg, p_fixed=1)
    assert info.iterations < info0.iterations / 2
    assert np.allclose(np.asarray(x), np.linalg.solve(A, b), atol=1e-5)


def test_fmgmres_on_stokes_bem_reduces_outer_iterations(stokes_plan64):
    """The reference workload: inner relaxed GMRES on the same Stokes
    plan preconditioning the outer flexible solve (fmgmres.hpp).
    Shares the session Stokes plan — this test used to rebuild an
    identical plan and dominated the suite at 123 s."""
    tris, fields, kern, plan = stokes_plan64
    n = len(tris)
    b = np.tile(np.array([4 * np.pi, 0.0, 0.0]), (n, 1)).reshape(-1)

    def mv(x, p):
        return plan.apply(x.reshape(n, 3), p=p).reshape(-1)

    cfg = SolverConfig(residual=1e-5, max_p=10, p_min=5)
    x0, info0 = gmres(mv, b, config=cfg)
    x1, info1 = fmgmres(mv, b, config=cfg, inner_iters=10,
                        inner_tol=1e-1, p_inner=5)
    assert info1.converged
    assert info1.iterations < info0.iterations, (
        info0.iterations, info1.iterations)
    # same physics: both give the Stokes drag
    t0 = np.asarray(x0).reshape(n, 3)
    t1 = np.asarray(x1).reshape(n, 3)
    fx0 = float((t0[:, 0] * fields["area"]).sum())
    fx1 = float((t1[:, 0] * fields["area"]).sum())
    assert abs(fx1 - fx0) / abs(fx0) < 1e-3


# ----------------------------------------------------------------------
# Krylov-state checkpoint / resume (SURVEY.md §5.4; no reference
# counterpart)
# ----------------------------------------------------------------------
import dataclasses as _dc
import os as _os


def _ill_system(seed=30, n=90):
    rng = np.random.default_rng(seed)
    Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    A = Q @ np.diag(np.logspace(0, 2, n)) @ Q.T
    return jnp.asarray(A), rng.standard_normal(n)


class _Killed(RuntimeError):
    """Simulated process death mid-solve."""


def test_gmres_host_checkpoint_resume_bit_identical(tmp_path):
    Aj, b = _ill_system()
    path = str(tmp_path / "krylov.npz")
    cfg = SolverConfig(residual=1e-10, max_iters=300, restart=300)

    x_ref, info_ref = gmres(lambda v, p: Aj @ v, b, config=cfg, p_fixed=1,
                            checkpoint_path=path, checkpoint_every=3)
    assert info_ref.converged
    assert not _os.path.exists(path)  # cleaned up on convergence
    assert info_ref.iterations > 12   # enough room to kill mid-solve

    # "kill" the solve mid-cycle: the matvec dies on its 10th call,
    # exactly like a pre-empted process — identical config, so the
    # resumed replay sees identical shapes end to end
    calls = [0]

    def mv_dying(v, p):
        calls[0] += 1
        if calls[0] > 9:
            raise _Killed()
        return Aj @ v

    with pytest.raises(_Killed):
        gmres(mv_dying, b, config=cfg, p_fixed=1,
              checkpoint_path=path, checkpoint_every=3)
    assert _os.path.exists(path)

    x_res, info_res = gmres(lambda v, p: Aj @ v, b, config=cfg, p_fixed=1,
                            checkpoint_path=path, checkpoint_every=3)
    assert info_res.converged
    assert info_res.iterations == info_ref.iterations
    np.testing.assert_array_equal(np.asarray(x_res), np.asarray(x_ref))


def test_gmres_host_checkpoint_resume_across_restart_cycles(tmp_path):
    Aj, b = _ill_system(seed=31)
    path = str(tmp_path / "krylov.npz")
    cfg = SolverConfig(residual=1e-9, max_iters=300, restart=12)

    x_ref, info_ref = gmres(lambda v, p: Aj @ v, b, config=cfg, p_fixed=1,
                            checkpoint_path=path, checkpoint_every=4)
    assert info_ref.converged and info_ref.iterations > 16

    calls = [0]

    def mv_dying(v, p):
        calls[0] += 1
        # die in the second restart cycle (restart=12 + residual evals)
        if calls[0] > 17:
            raise _Killed()
        return Aj @ v

    with pytest.raises(_Killed):
        gmres(mv_dying, b, config=cfg, p_fixed=1,
              checkpoint_path=path, checkpoint_every=4)
    assert _os.path.exists(path)
    x_res, info_res = gmres(lambda v, p: Aj @ v, b, config=cfg, p_fixed=1,
                            checkpoint_path=path, checkpoint_every=4)
    assert info_res.iterations == info_ref.iterations
    np.testing.assert_array_equal(np.asarray(x_res), np.asarray(x_ref))


def test_gmres_device_checkpoint_resume_bit_identical(tmp_path):
    Aj, b = _ill_system(seed=32)
    mv = lambda op, v, p: Aj @ v
    path = str(tmp_path / "krylov_dev.npz")
    cfg = SolverConfig(residual=1e-10, max_iters=300, restart=300)

    x_ref, info_ref = gmres_device(mv, b, config=cfg, p_fixed=1,
                                   checkpoint_path=path,
                                   checkpoint_every=4)
    assert info_ref.converged
    assert not _os.path.exists(path)
    assert info_ref.iterations > 12

    # kill at a tier-block boundary via the per-block operand callback
    calls = [0]

    def op_dying(p):
        calls[0] += 1
        if calls[0] > 3:
            raise _Killed()
        return None

    with pytest.raises(_Killed):
        gmres_device(mv, b, config=cfg, p_fixed=1, operand_for_p=op_dying,
                     checkpoint_path=path, checkpoint_every=4)
    assert _os.path.exists(path)

    x_res, info_res = gmres_device(mv, b, config=cfg, p_fixed=1,
                                   checkpoint_path=path,
                                   checkpoint_every=4)
    assert info_res.converged
    assert info_res.iterations == info_ref.iterations
    np.testing.assert_array_equal(np.asarray(x_res), np.asarray(x_ref))
