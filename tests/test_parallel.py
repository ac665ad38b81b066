"""Multi-device sharded execution tests on the 8-device CPU mesh."""

import jax
import numpy as np
import pytest

from fmm_bem_tpu.bem.panels import make_panels
from fmm_bem_tpu.bem.triangulation import unit_sphere
from fmm_bem_tpu.config import FMMConfig
from fmm_bem_tpu.executor.plan import FmmPlan
from fmm_bem_tpu.kernels.laplace import LaplaceKernel
from fmm_bem_tpu.kernels.laplace_bem import LaplaceBEMKernel
from fmm_bem_tpu.parallel.sharding import make_mesh, sharded_matvec, sharded_solve_step


@pytest.fixture(scope="module")
def point_plan_1536():
    """Shared read-only point plan (tests only call apply/LetPlan)."""
    rng = np.random.default_rng(0)
    pts = rng.uniform(0, 1, (1536, 3))
    return FmmPlan(
        LaplaceKernel(), {"xyz": pts},
        FMMConfig(ncrit=32, dtype="float64", max_p=8),
    )


@pytest.fixture(scope="module")
def bem_plan_r3():
    tris = unit_sphere(3)
    fields = make_panels(tris, K=3)
    return FmmPlan(
        LaplaceBEMKernel(K=3), fields,
        FMMConfig(ncrit=32, dtype="float64", max_p=8),
    ), len(tris)


@pytest.fixture(scope="module")
def bem_plan_r4():
    tris = unit_sphere(4)
    fields = make_panels(tris, K=3)
    return FmmPlan(
        LaplaceBEMKernel(K=3), fields,
        FMMConfig(ncrit=32, dtype="float64", max_p=8),
    ), len(tris)


@pytest.mark.parametrize("ndev", [2, 8])
def test_sharded_point_matvec_matches(ndev, point_plan_1536):
    assert len(jax.devices()) >= ndev
    plan = point_plan_1536
    q = np.random.default_rng(0).standard_normal(1536)
    ref = np.asarray(plan.apply(q, p=6))
    mesh = make_mesh(ndev)
    f = sharded_matvec(plan, 6, mesh)
    out = np.asarray(f(q))
    assert np.allclose(out, ref, rtol=1e-10, atol=1e-12)


def test_sharded_bem_matvec_matches():
    tris = unit_sphere(3)
    fields = make_panels(tris, K=3)
    plan = FmmPlan(
        LaplaceBEMKernel(K=3),
        fields,
        FMMConfig(ncrit=32, dtype="float64", max_p=8),
    )
    q = np.random.default_rng(1).standard_normal(len(tris))
    ref = np.asarray(plan.apply(q, p=8))
    mesh = make_mesh(8)
    f = sharded_matvec(plan, 8, mesh)
    assert np.allclose(np.asarray(f(q)), ref, rtol=1e-10, atol=1e-12)


def test_sharded_solve_step_runs():
    tris = unit_sphere(3)
    fields = make_panels(tris, K=3)
    plan = FmmPlan(
        LaplaceBEMKernel(K=3),
        fields,
        FMMConfig(ncrit=32, dtype="float64", max_p=6),
    )
    n = len(tris)
    mesh = make_mesh(8)
    step = sharded_solve_step(plan, 6, mesh)
    v = np.ones(n) / np.sqrt(n)
    basis = np.zeros((4, n))
    basis[0] = v
    w, coeffs, beta = step(v, basis)
    assert np.isfinite(np.asarray(w)).all()
    assert float(beta) > 0


# ----------------------------------------------------------------------
# LET distribution layer (parallel/let.py): explicit shard_map
# collectives, sharded panels/tiles/expansions
# ----------------------------------------------------------------------
from fmm_bem_tpu.parallel.let import LetPlan  # noqa: E402


@pytest.mark.parametrize("ndev", [2, 8])
def test_let_point_matvec_matches(ndev, point_plan_1536):
    plan = point_plan_1536
    q = np.random.default_rng(0).standard_normal(1536)
    ref = np.asarray(plan.apply(q, p=6))
    out = LetPlan(plan, ndev).apply(q, p=6)
    assert np.abs(out - ref).max() < 1e-10


@pytest.mark.parametrize("ndev", [2, 8])
def test_let_bem_matvec_matches(ndev, bem_plan_r4):
    plan, n = bem_plan_r4
    q = np.random.default_rng(1).standard_normal(n)
    ref = np.asarray(plan.apply(q, p=8))
    out = LetPlan(plan, ndev).apply(q, p=8)
    assert np.abs(out - ref).max() < 1e-10


def test_let_flipped_variant_matches(bem_plan_r3):
    plan, n = bem_plan_r3
    q = np.random.default_rng(2).standard_normal(n)
    ref = np.asarray(plan.apply_flipped_bc(q, p=8))
    out = LetPlan(plan, 8, flipped=True).apply(q, p=8)
    assert np.abs(out - ref).max() < 1e-10


def test_let_flipped_with_m2p_pairs():
    """The BC-flipped operator on a tree with level-skewed (M2P) pairs:
    the M2P pass must see the flipped fields, not the plan's own."""
    tris = unit_sphere(5)
    plan = FmmPlan(
        LaplaceBEMKernel(K=3), make_panels(tris, K=3),
        FMMConfig(ncrit=8, dtype="float64", max_p=5),
    )
    assert len(plan.m2p_src) > 0
    q = np.random.default_rng(5).standard_normal(len(tris))
    ref = np.asarray(plan.apply_flipped_bc(q, p=5))
    out = LetPlan(plan, 4, flipped=True).apply(q, p=5)
    assert np.abs(out - ref).max() < 1e-10 * np.abs(ref).max()


def test_let_operand_blocks_stay_on_their_device(bem_plan_r3):
    """The operand is placed once with the shard_map specs: every device
    holds exactly its own block of the near store and of the body
    tables, and the near store was assembled there."""
    plan, n = bem_plan_r3
    lp = LetPlan(plan, 4)
    _, op4p = lp.solver_ops()
    dd = op4p(5)
    devices = set(jax.devices()[:4])
    for arr in (dd["panels"]["A"], dd["panels"]["pidx"],
                dd["leaf_body_idx"], dd["body_leaf_row"]):
        shards = arr.addressable_shards
        assert {s.device for s in shards} == devices
        assert all(s.data.shape == (1,) + arr.shape[1:] for s in shards)
    q = np.random.default_rng(4).standard_normal(n)
    ref = np.asarray(plan.apply(q, p=5))
    assert np.abs(lp.apply(q, p=5) - ref).max() < 1e-10


def test_let_full_solve_matches_single_device(bem_plan_r4):
    """Distributed second-kind BEM solve == single-device solve: the
    whole Krylov iteration runs on sharded state with the LET matvec."""
    from fmm_bem_tpu.config import SolverConfig
    from fmm_bem_tpu.solver.gmres import gmres_device

    plan, n = bem_plan_r4
    q = np.ones(n)
    b = np.asarray(plan.apply(q, p=5)[:, 0])
    cfg = SolverConfig(residual=1e-6, max_p=5, max_iters=40, restart=40)

    mv, op4p = plan.solver_ops(flipped=True)
    x_ref, info_ref = gmres_device(mv, b, operand_for_p=op4p, config=cfg,
                                   p_fixed=5)

    lp = LetPlan(plan, 8, flipped=True)
    mv_let, op4p_let = lp.solver_ops()
    b_pad = lp.to_padded(b)
    x_pad, info = gmres_device(
        mv_let, b_pad, operand_for_p=op4p_let, config=cfg, p_fixed=5
    )
    x_let = lp.from_padded(np.asarray(x_pad)[:, None])[:, 0]
    assert info.converged and info_ref.converged
    assert abs(info.iterations - info_ref.iterations) <= 1
    assert np.abs(x_let - np.asarray(x_ref)).max() < 1e-5


def _mesh2d(nouter, nsp):
    from jax.sharding import Mesh

    devs = np.array(jax.devices()[: nouter * nsp]).reshape(nouter, nsp)
    return Mesh(devs, ("dp", "sp"))


@pytest.mark.parametrize("shape", [(2, 4), (4, 2)])
def test_let_two_level_mesh_matches(shape):
    """2-D (inter-node x intra-node) mesh: hierarchical halo exchange
    must reproduce the single-device matvec exactly (SURVEY.md §5.8
    two-level LET)."""
    tris = unit_sphere(4)
    fields = make_panels(tris, K=3)
    plan = FmmPlan(
        LaplaceBEMKernel(K=3), fields,
        FMMConfig(ncrit=32, dtype="float64", max_p=8),
    )
    q = np.random.default_rng(3).standard_normal(len(tris))
    ref = np.asarray(plan.apply(q, p=8))
    lp = LetPlan(plan, _mesh2d(*shape))
    assert lp.nouter == shape[0] and lp.nsp == shape[1]
    out = lp.apply(q, p=8)
    assert np.abs(out - ref).max() < 1e-10


def test_let_two_level_flipped_and_point():
    # flipped BEM variant on (2, 4)
    tris = unit_sphere(3)
    fields = make_panels(tris, K=3)
    plan = FmmPlan(
        LaplaceBEMKernel(K=3), fields,
        FMMConfig(ncrit=32, dtype="float64", max_p=8),
    )
    q = np.random.default_rng(4).standard_normal(len(tris))
    ref = np.asarray(plan.apply_flipped_bc(q, p=8))
    out = LetPlan(plan, _mesh2d(2, 4), flipped=True).apply(q, p=8)
    assert np.abs(out - ref).max() < 1e-10
    # point kernel on (2, 4)
    rng = np.random.default_rng(5)
    pts = rng.uniform(0, 1, (1536, 3))
    qp = rng.standard_normal(1536)
    plan2 = FmmPlan(
        LaplaceKernel(), {"xyz": pts},
        FMMConfig(ncrit=32, dtype="float64", max_p=8),
    )
    ref2 = np.asarray(plan2.apply(qp, p=6))
    out2 = LetPlan(plan2, _mesh2d(2, 4)).apply(qp, p=6)
    assert np.abs(out2 - ref2).max() < 1e-10


def test_let_two_level_collectives_per_axis():
    """Per-axis HLO bound: no collective on EITHER axis of the 2-D mesh
    may reach the sharded panel-state scale, and the cross-group
    (inter-node) exports must not exceed the intra-group halo
    volume."""
    tris = unit_sphere(4)
    fields = make_panels(tris, K=3)
    plan = FmmPlan(
        LaplaceBEMKernel(K=3), fields,
        FMMConfig(ncrit=32, dtype="float64", max_p=8),
    )
    lp = LetPlan(plan, _mesh2d(2, 4))
    fn, dd = lp.matvec_fn(5)
    qp = lp.to_padded(np.ones(len(tris)))
    txt = jax.jit(fn).lower(dd, qp).compile().as_text()
    import sys as _sys

    _sys.path.insert(0, __file__.rsplit("/", 2)[0] + "/examples")
    from scaling_multichip import max_collective_bytes_hlo

    panel_bytes = lp.stats()["near_panel_bytes_per_dev"]
    coll, desc = max_collective_bytes_hlo(txt, 8)
    assert coll > 0, "expected explicit collectives in the LET matvec"
    assert coll < panel_bytes, (coll, desc, panel_bytes)
    # the halo split must actually shrink the inter-node payload:
    # inter-group export tables are no larger than the full ones
    assert lp.m_exp_inter.shape[1] <= lp.m_export_rows.shape[1]
    assert lp.q_exp_inter.shape[1] <= lp.q_export_rows.shape[1]


def test_let_no_bulk_collectives():
    """The compiled sharded matvec must not move O(N) panel/tile data:
    every collective operand stays below the halo scale."""
    tris = unit_sphere(4)
    fields = make_panels(tris, K=3)
    plan = FmmPlan(
        LaplaceBEMKernel(K=3), fields,
        FMMConfig(ncrit=32, dtype="float64", max_p=8),
    )
    lp = LetPlan(plan, 8)
    fn, dd = lp.matvec_fn(5)
    qp = lp.to_padded(np.ones(len(tris)))
    txt = jax.jit(fn).lower(dd, qp).compile().as_text()
    import sys as _sys

    _sys.path.insert(0, __file__.rsplit("/", 2)[0] + "/examples")
    from scaling_multichip import max_collective_bytes_hlo

    panel_bytes = lp.stats()["near_panel_bytes_per_dev"]
    coll, desc = max_collective_bytes_hlo(txt, 8)
    assert coll > 0, "expected explicit collectives in the LET matvec"
    # collectives stay well below the sharded panel state
    assert coll < panel_bytes, (coll, desc, panel_bytes)
