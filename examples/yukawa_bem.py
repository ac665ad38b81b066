#!/usr/bin/env python
"""Yukawa (screened-Laplace) BEM driver on the unit sphere.

Counterpart of examples/YukawaBEM.cpp — which is stale/unbuildable in
the reference (SURVEY.md §2.7); this restores the workload: first-kind
screened boundary integral equation solved with relaxed GMRES.

Usage: python examples/yukawa_bem.py -recursions 3 -p 6 -k 3 -kappa 0.125
"""

import argparse
import sys
import time

sys.path.insert(0, __file__.rsplit("/", 2)[0])

import numpy as np


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("-recursions", type=int, default=3)
    ap.add_argument("-p", type=int, default=6)
    ap.add_argument("-k", type=int, default=3)
    ap.add_argument("-kappa", type=float, default=0.125)
    ap.add_argument("-theta", type=float, default=0.5)
    ap.add_argument("-ncrit", type=int, default=64)
    ap.add_argument("-solver_tol", type=float, default=1e-5)
    ap.add_argument("-max_iters", type=int, default=500)
    ap.add_argument("-fixed_p", action="store_true")
    ap.add_argument("-p_tiers", default="auto",
                    help="'auto' = 3,5,max_p tier quantisation of the "
                    "relaxed schedule; 'none' = continuous")
    ap.add_argument("-dtype", default=None,
                    help="default: float32 on accelerators, float64 on CPU")
    ap.add_argument("-cpu", action="store_true", help="force host platform")
    ap.add_argument("-host_solver", action="store_true",
                    help="force the host GMRES loop")
    args = ap.parse_args()

    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    if args.dtype is None:
        args.dtype = (
            "float64" if jax.devices()[0].platform == "cpu" else "float32"
        )
    if args.dtype == "float64":
        # float64 silently truncates to f32 unless x64 is enabled
        jax.config.update("jax_enable_x64", True)
    from fmm_bem_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    from fmm_bem_tpu.bem.panels import make_panels
    from fmm_bem_tpu.bem.triangulation import unit_sphere
    from fmm_bem_tpu.config import FMMConfig, SolverConfig
    from fmm_bem_tpu.executor.plan import FmmPlan
    from fmm_bem_tpu.kernels.yukawa_bem import YukawaBEMKernel

    tris = unit_sphere(args.recursions)
    fields = make_panels(tris, K=args.k)
    n = len(tris)
    print(f"initialised {n} panels, kappa = {args.kappa}")

    kern = YukawaBEMKernel(K=args.k, kappa=args.kappa)
    cfg = FMMConfig(
        theta=args.theta, ncrit=args.ncrit, max_p=max(args.p, 8),
        dtype=args.dtype,
    )
    t0 = time.time()
    plan = FmmPlan(kern, fields, cfg)
    print(f"plan built in {time.time()-t0:.3f}s")

    phi = np.ones(n)
    b = np.asarray(plan.apply_flipped_bc(phi, p=cfg.max_p)[:, 0])

    from fmm_bem_tpu.config import default_p_tiers

    tiers = None
    if not args.fixed_p and args.p_tiers != "none":
        tiers = (
            default_p_tiers(cfg.max_p)
            if args.p_tiers == "auto"
            else tuple(int(t) for t in args.p_tiers.split(","))
        )
    scfg = SolverConfig(
        residual=args.solver_tol,
        max_iters=args.max_iters,
        restart=args.max_iters,
        max_p=cfg.max_p,
        variable_p=not args.fixed_p,
        p_tiers=tiers,
    )
    from fmm_bem_tpu.solver.api import solve_plan

    t0 = time.time()
    x, info, mode = solve_plan(
        plan,
        b,
        scfg,
        p_fixed=args.p if args.fixed_p else None,
        verbose=True,
        prefer_device=False if args.host_solver else None,
    )
    print(f"\nTIMING:\n\tsolve : {time.time()-t0:.4e}s [{mode}] "
          f"({info.iterations} its, residual {info.residual:.3e})")

    # analytic check: with the reference's -2pi Yukawa self-term
    # (SemiAnalytical.hpp:196-201) the equation is the INTERIOR screened
    # problem; for phi = 1 on the unit sphere the interior solution is
    # phi(r) = sinh(kappa r)/(r sinh kappa), so dphi/dn (inward normal
    # orientation of the octahedron mesh) = -(kappa coth kappa - 1).
    x = np.asarray(x)
    exact = -(args.kappa / np.tanh(args.kappa) - 1.0)
    err = abs(x.mean() - exact) / abs(exact)
    print(f"solution mean dphi/dn: {x.mean():.6f}  std {x.std():.2e}")
    print(f"analytic (interior): {exact:.6f}  rel. error: {err:.3e}")


if __name__ == "__main__":
    main()
