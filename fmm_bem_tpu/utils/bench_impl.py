"""Benchmark implementation: the Laplace BEM sphere on one GPU.

Measures the FMM matvec (effective interactions/s: N^2 source-target
pairs served by the O(N) hierarchical matvec), the second-kind and the
first-kind relaxed GMRES solves, and the per-phase breakdown, all on
the first JAX device.  A host without a GPU fails; there is no CPU
fallback.

Run as a module:  python -m fmm_bem_tpu.utils.bench_impl [recursions]
Prints one JSON line (the record) on stdout, progress on stderr.
"""

from __future__ import annotations

import json
import sys
import time


def _median_s(fn, reps):
    """Median wall time of ``fn()`` (which blocks on its result)."""
    import numpy as np

    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    return float(np.median(times))


def run(recursions=8, p=5, iters=10, chain=50):
    import jax

    from fmm_bem_tpu.utils.compile_cache import enable_compile_cache

    t_start = time.perf_counter()

    def note(msg):
        print(f"[bench +{time.perf_counter() - t_start:6.1f}s] {msg}",
              file=sys.stderr, flush=True)

    device = jax.devices()[0]
    if device.platform != "gpu":
        raise SystemExit(
            f"bench: needs an NVIDIA GPU, JAX found {device.platform!r}"
        )
    enable_compile_cache()
    import jax.numpy as jnp
    import numpy as np

    from fmm_bem_tpu.bem.panels import make_panels
    from fmm_bem_tpu.bem.triangulation import unit_sphere
    from fmm_bem_tpu.config import FMMConfig, SolverConfig
    from fmm_bem_tpu.executor.plan import FmmPlan
    from fmm_bem_tpu.kernels.laplace_bem import LaplaceBEMKernel
    from fmm_bem_tpu.solver.gmres import DeviceGmresContext, gmres_device
    from fmm_bem_tpu.utils.roofline import phase_breakdown

    note(f"start {device.device_kind} rec={recursions}")
    tris = unit_sphere(recursions)
    fields = make_panels(tris, K=3)
    n = len(tris)

    t0 = time.perf_counter()
    plan = FmmPlan(
        LaplaceBEMKernel(K=3),
        fields,
        # max_p 10: the phase record runs at both p=5 and p=10, and the
        # first-kind relaxed solve uses tiers (3, 5, 10).  leaf_pad 64:
        # ncrit bounds leaf occupancy at 64 anyway, and the fixed tile
        # makes the near-field chunk width m0*KS*cdim exactly 128
        FMMConfig(ncrit=64, dtype="float32", max_p=max(p, 10),
                  leaf_pad=64),
    )
    build_s = time.perf_counter() - t0
    note(f"plan built ({build_s:.1f}s)")

    # sustained matvec throughput: `chain` matvecs inside one jit, as
    # the device-resident GMRES consumes them, on the slot-space
    # operator the solver uses (FmmPlan.solver_ops_slots)
    mv, op4p, to_slots, from_slots, _ = plan.solver_ops_slots()
    operand = op4p(p)
    scale = np.float32(1.0 / (4.0 * np.pi))  # keeps the chain bounded

    @jax.jit
    def chained(operand, q):
        def step(carry, _):
            return mv(operand, carry, p) * scale, None

        return jax.lax.scan(step, q, None, length=chain)[0]

    q = to_slots(jnp.ones(n, jnp.float32))
    t0 = time.perf_counter()
    chained(operand, q).block_until_ready()
    compile_s = time.perf_counter() - t0
    note(f"chain compiled ({compile_s:.1f}s)")
    dt = _median_s(
        lambda: chained(operand, q).block_until_ready(), iters
    ) / chain

    qn = np.ones(n, dtype=np.float32)
    plan.apply(qn, p=p).block_until_ready()
    dt_single = _median_s(
        lambda: plan.apply(qn, p=p).block_until_ready(), iters
    )

    # second-kind sphere equation (ref -second_kind mode): system =
    # dGdn operator (flipped BC), RHS = G . (dphi/dn = 1), analytic
    # solution phi = 1, at the reference's default residual
    # (SolverOptions.hpp:23)
    note("second-kind solve")
    b = np.asarray(plan.apply(qn, p=p)[:, 0])
    mvf, op4pf, to_s, from_s, _ = plan.solver_ops_slots(flipped=True)
    b = to_s(b)
    cfg = SolverConfig(residual=1e-5, max_p=p, max_iters=60, restart=60)
    ctx = DeviceGmresContext()
    gmres_device(mvf, b, operand_for_p=op4pf, config=cfg, p_fixed=p,
                 context=ctx)  # compile pass
    t0 = time.perf_counter()
    x, info = gmres_device(
        mvf, b, operand_for_p=op4pf, config=cfg, p_fixed=p, context=ctx
    )
    solve_s = time.perf_counter() - t0
    sol_err = float(
        np.linalg.norm(np.asarray(from_s(x)) - 1.0) / np.sqrt(n)
    )

    # the reference's DEFAULT workload: the FIRST-kind equation
    # (LaplaceBEM.cpp:190) with the paper's relaxed p, quantised to
    # tiers.  System = G operator, RHS = dGdn . phi via the flipped-BC
    # matvec; analytic dphi/dn = 1
    note("first-kind relaxed solve (tiers 3/5/10)")
    bfk = to_slots(
        jnp.asarray(np.asarray(plan.apply_flipped_bc(qn, p=10)[:, 0]))
    )
    cfg_fk = SolverConfig(
        residual=1e-5, max_iters=100, restart=100,
        max_p=10, p_min=1, p_tiers=(3, 5, 10),
    )
    ctx_fk = DeviceGmresContext()
    gmres_device(mv, bfk, operand_for_p=op4p, config=cfg_fk, context=ctx_fk)
    t0 = time.perf_counter()
    xf, infof = gmres_device(
        mv, bfk, operand_for_p=op4p, config=cfg_fk, context=ctx_fk
    )
    fk = {
        "solve_s": time.perf_counter() - t0,
        "iters": infof.iterations,
        "converged": bool(infof.converged),
        "residual": float(infof.residual),
        "err": float(
            np.linalg.norm(np.asarray(from_slots(xf)) - 1.0) / np.sqrt(n)
        ),
        "p_schedule": [int(h[2]) for h in infof.history],
    }

    note("phases")
    phases = phase_breakdown(plan, p, mv_ms_ref=dt * 1e3)
    phases_p10 = phase_breakdown(plan, 10)
    return {
        "device": {
            "platform": device.platform,
            "kind": device.device_kind,
            "count": len(jax.devices()),
        },
        "n_panels": n,
        "p": p,
        "matvec_s": dt,
        "matvec_dispatched_s": dt_single,
        "build_s": build_s,
        "compile_s": compile_s,
        "solve_s": solve_s,
        "solve_iters": info.iterations,
        "solve_converged": bool(info.converged),
        "solution_err": sol_err,
        "solve_first_kind_relaxed": fk,
        "phases": phases,
        "phases_p10": phases_p10,
        "peak_bytes_in_use": device.memory_stats()["peak_bytes_in_use"],
        "value": float(n) * float(n) / dt,
    }


if __name__ == "__main__":
    rec = int(sys.argv[1]) if len(sys.argv) > 1 else 8
    print(json.dumps(run(recursions=rec)))
