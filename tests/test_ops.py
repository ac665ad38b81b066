"""Tests for the executor ops: the leaf-panel near field
(ops/near_panel.py, both the plain XLA contraction and the Pallas
kernel in interpreter mode) and scatter-free gather-sum reductions
(ops/bucket_sum.py)."""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from fmm_bem_tpu.bem.panels import make_panels
from fmm_bem_tpu.bem.triangulation import unit_sphere
from fmm_bem_tpu.config import FMMConfig
from fmm_bem_tpu.executor.plan import FmmPlan
from fmm_bem_tpu.kernels.laplace_bem import LaplaceBEMKernel
from fmm_bem_tpu.kernels.stokes_bem import StokesBEMKernel
from fmm_bem_tpu.ops.bucket_sum import build_bucket_sum, bucket_sum_apply


def test_bucket_sum_matches_segment_sum():
    rng = np.random.default_rng(0)
    for nrows, P in ((7, 40), (100, 1000), (3, 3), (50, 0)):
        targets = rng.integers(0, nrows + 2, P)  # some ids out of range
        x = rng.standard_normal((P, 5))
        plan = build_bucket_sum(targets, P, nrows)
        got = np.asarray(bucket_sum_apply(plan.device(), jnp.asarray(x)))
        ref = np.zeros((nrows, 5))
        for t, row in zip(targets, x):
            if t < nrows:
                ref[t] += row
        assert got.shape == (nrows, 5)
        assert np.allclose(got, ref, atol=1e-12), (nrows, P)


def _panel_plans(kernel_factory, seed=0):
    tris = unit_sphere(3)
    fields = make_panels(tris, K=3)
    n = len(tris)
    cfg_panel = FMMConfig(ncrit=16, dtype="float64", max_p=6)
    cfg_coo = FMMConfig(ncrit=16, dtype="float64", max_p=6, near_panel=False)
    pa = FmmPlan(kernel_factory(), fields, cfg_panel)
    pb = FmmPlan(kernel_factory(), fields, cfg_coo)
    return pa, pb, n


def test_near_panels_match_coo_laplace():
    pa, pb, n = _panel_plans(lambda: LaplaceBEMKernel(K=3))
    q = np.random.default_rng(1).standard_normal(n)
    for p in (3, 5):
        oa = np.asarray(pa.apply(q, p=p))
        ob = np.asarray(pb.apply(q, p=p))
        assert np.allclose(oa, ob, atol=1e-11)
    fa = np.asarray(pa.apply_flipped_bc(q, p=5))
    fb = np.asarray(pb.apply_flipped_bc(q, p=5))
    assert np.allclose(fa, fb, atol=1e-11)


def test_near_panels_match_coo_stokes():
    pa, pb, n = _panel_plans(lambda: StokesBEMKernel(K=4, fine_K=17, mu=1e-3))
    q = np.random.default_rng(2).standard_normal((n, 3))
    oa = np.asarray(pa.apply(q, p=5))
    ob = np.asarray(pb.apply(q, p=5))
    scale = np.abs(ob).max()
    assert np.allclose(oa, ob, atol=1e-9 * scale)


def test_linear_tables_match_runtime_ops():
    """The precomputed P2M/L2P linear tables must reproduce the kernel
    ops exactly (they are just the frozen linear maps)."""
    tris = unit_sphere(3)
    fields = make_panels(tris, K=3)
    n = len(tris)
    q = np.random.default_rng(3).standard_normal(n)
    # max_p=6: the default 16 precomputes f64 tables an order of
    # magnitude larger than the p=5 comparison ever reads (this test
    # was 68 s of pure table build)
    pa = FmmPlan(
        LaplaceBEMKernel(K=3), fields,
        FMMConfig(ncrit=16, dtype="float64", max_p=6),
    )
    kb = LaplaceBEMKernel(K=3)
    kb.linear_p2m = False
    if hasattr(type(kb), "l2p_table"):
        # instance-level shadow so the plan skips the table path
        pb = FmmPlan(
            kb, fields,
            FMMConfig(ncrit=16, dtype="float64", max_p=6,
                      near_panel=False),
        )
        pb_aux = pb.variant_aux(5)
        assert "p2m_tab" not in pb_aux
    oa = np.asarray(pa.apply(q, p=5))
    ob = np.asarray(pb.apply(q, p=5))
    assert np.allclose(oa, ob, atol=1e-11)


def _random_chunks(rng, chunks_per_leaf, n_dummy, nq, KTr, KSc, m0):
    """Leaf-sorted chunk store in the NearPanels layout: leaf l owns
    chunks_per_leaf[l] consecutive chunks, then n_dummy padding chunks
    (target nl_t, source leaves nq)."""
    nl_t = len(chunks_per_leaf)
    Lb = -(-m0 * KSc // 128) * 128
    ct = np.concatenate([
        np.repeat(np.arange(nl_t), chunks_per_leaf), np.full(n_dummy, nl_t)
    ]).astype(np.int32)
    C = len(ct)
    pidx = rng.integers(0, nq + 1, (C, m0)).astype(np.int32)
    pidx[ct == nl_t] = nq
    A = rng.standard_normal((C, KTr, Lb))
    A[:, :, m0 * KSc:] = 0.0
    ql = rng.standard_normal((nq, KSc))
    return A, pidx, ct, ql, nl_t


def _near_reference(A, pidx, ct, ql, nl_t):
    """Dense per-chunk loop: out[t] += A[c] @ [ql[pidx[c, 0]], ...]."""
    C, KTr, _ = A.shape
    m0 = pidx.shape[1]
    xq = np.concatenate([ql, np.zeros((1, ql.shape[1]))])
    out = np.zeros((nl_t, KTr))
    for c in range(C):
        if ct[c] < nl_t:
            x = np.concatenate([xq[j] for j in pidx[c]])
            out[ct[c]] += A[c, :, : m0 * ql.shape[1]] @ x
    return out


NEAR_CASES = {
    # (chunks per target leaf, dummy chunks, source leaves, KTr, KSc, m0)
    "m0_1": ([1, 2, 0, 3], 2, 6, 16, 16, 1),
    "m0_2": ([2, 1, 3], 1, 5, 64, 64, 2),
    "dummies_only_tail": ([1, 1], 7, 3, 8, 8, 4),
    "leaf_spans_many_chunks": ([1, 19, 2], 3, 9, 32, 32, 2),
    "stokes_widths": ([2, 0, 3], 2, 5, 3 * 16, 3 * 16, 2),
}


@pytest.mark.parametrize("case", sorted(NEAR_CASES))
@pytest.mark.parametrize("impl", ["xla", "triton"])
def test_near_contract_matches_dense_loop(case, impl):
    """Both near-field implementations (the Pallas kernel in interpret
    mode) against a dense per-chunk numpy loop."""
    from fmm_bem_tpu.ops import near_panel as npnl

    cpl, ndum, nq, KTr, KSc, m0 = NEAR_CASES[case]
    A, pidx, ct, ql, nl_t = _random_chunks(
        np.random.default_rng(4), cpl, ndum, nq, KTr, KSc, m0
    )
    ref = _near_reference(A, pidx, ct, ql, nl_t)
    args = (jnp.asarray(A), jnp.asarray(pidx), jnp.asarray(ct),
            jnp.asarray(ql), nl_t)
    if impl == "triton":
        got = npnl._contract_triton(*args, interpret=True)
    else:
        got = npnl._contract_xla(*args)
    assert got.shape == (nl_t, KTr)
    assert np.allclose(np.asarray(got), ref, rtol=1e-12, atol=1e-12)


def _plan_near_inputs(plan, seed):
    panels, meta = plan.near_panels()
    nl_s, K = plan.src.leaf_body_mask.shape
    cdim = getattr(plan.kernel, "charge_dim", 1)
    rng = np.random.default_rng(seed)
    ql = rng.standard_normal((nl_s, K, cdim)) * \
        plan.src.leaf_body_mask[..., None]
    return panels, meta, jnp.asarray(ql.reshape(nl_s, K * cdim))


def test_near_kernel_on_plan_panels(stokes_plan64):
    """The kernel (interpret mode) against plain XLA on real panel
    stores: the Laplace sphere and the Stokes (3x3-block) sphere."""
    from fmm_bem_tpu.ops import near_panel as npnl

    tris = unit_sphere(3)
    lap = FmmPlan(LaplaceBEMKernel(K=3), make_panels(tris, K=3),
                  FMMConfig(ncrit=16, dtype="float64", max_p=6))
    for plan in (lap, stokes_plan64[3]):
        panels, meta, ql = _plan_near_inputs(plan, 5)
        args = (panels["A"], panels["pidx"], panels["chunk_tgt"], ql,
                meta.nl_t)
        ref = np.asarray(npnl._contract_xla(*args))
        got = np.asarray(npnl._contract_triton(*args, interpret=True))
        assert np.abs(got - ref).max() <= 1e-12 * np.abs(ref).max()


@pytest.mark.gpu
def test_near_kernel_compiled_matches_xla(gpu):
    """The kernel as compiled for the card against plain XLA on the
    same device (chip_smoke.py repeats this on the 131k-panel store)."""
    from fmm_bem_tpu.ops import near_panel as npnl

    A, pidx, ct, ql, nl_t = _random_chunks(
        np.random.default_rng(7), [3, 0, 19, 2], 3, 9, 64, 64, 2
    )
    args = [jax.device_put(a, gpu) for a in (
        jnp.asarray(A, jnp.float32), jnp.asarray(pidx), jnp.asarray(ct),
        jnp.asarray(ql, jnp.float32),
    )]
    got = jax.jit(npnl._contract_triton, static_argnums=4)(*args, nl_t)
    ref = jax.jit(npnl._contract_xla, static_argnums=4)(*args, nl_t)
    got, ref = np.asarray(got), np.asarray(ref)
    assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()


def test_panel_matvec_kernel_choice():
    """panel_matvec lowers the Pallas kernel for a CUDA device and only
    the plain XLA contraction for the CPU."""
    from fmm_bem_tpu.ops import near_panel as npnl

    A, pidx, ct, ql, nl_t = _random_chunks(
        np.random.default_rng(6), [2, 1], 1, 3, 16, 16, 2
    )
    meta = types.SimpleNamespace(nl_t=nl_t)
    panels = {"A": jnp.asarray(A, jnp.float32),
              "pidx": jnp.asarray(pidx), "chunk_tgt": jnp.asarray(ct)}
    f = jax.jit(lambda pn, q: npnl.panel_matvec(pn, meta, q))
    traced = f.trace(panels, jnp.asarray(ql, jnp.float32))
    cuda = traced.lower(lowering_platforms=("cuda",)).as_text()
    cpu = traced.lower(lowering_platforms=("cpu",)).as_text()
    assert "triton" in cuda
    assert "triton" not in cpu
    got = np.asarray(f(panels, jnp.asarray(ql, jnp.float32)))
    assert np.allclose(got, _near_reference(A, pidx, ct, ql, nl_t),
                       rtol=1e-4, atol=1e-4)


def test_device_near_assembly_chunked_matches_one_shot():
    """The row-chunked device assembly (large-N path: the one-shot
    quadrature-block temp would OOM at 524k panels) must produce
    exactly the same panels as the one-shot path."""
    from fmm_bem_tpu.ops import near_panel as npnl

    tris = unit_sphere(3)
    fields = make_panels(tris, K=3)
    # f32 on CPU so the device-assembly path is exercised
    cfg = FMMConfig(ncrit=16, dtype="float32", max_p=6)
    pa = FmmPlan(LaplaceBEMKernel(K=3), fields, cfg)
    assert getattr(pa, "_device_near", False), "device path not active"
    dev_one, meta_one = pa.near_panels()
    A_one = np.asarray(dev_one["A"])

    old = npnl.ONE_SHOT_LIMIT
    npnl.ONE_SHOT_LIMIT = 1  # force chunked assembly
    try:
        pb = FmmPlan(LaplaceBEMKernel(K=3), fields, cfg)
        dev_ch, meta_ch = pb.near_panels()
    finally:
        npnl.ONE_SHOT_LIMIT = old
    A_ch = np.asarray(dev_ch["A"])
    assert A_one.shape == A_ch.shape
    assert np.array_equal(
        np.asarray(dev_one["pidx"]), np.asarray(dev_ch["pidx"])
    )
    assert np.array_equal(
        np.asarray(dev_one["chunk_tgt"]), np.asarray(dev_ch["chunk_tgt"])
    )
    scale = np.abs(A_one).max()
    assert np.abs(A_one - A_ch).max() <= 1e-6 * scale
