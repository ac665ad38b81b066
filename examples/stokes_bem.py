#!/usr/bin/env python
"""Stokes BEM driver: flow past a unit sphere or red blood cells.

JAX counterpart of examples/StokesBEM.cpp (flags :146-207,
workflow :208-412): solve for the surface traction given the boundary
velocity u = (1,0,0); check the RHS against the 4*pi double-layer
identity and the drag force against Stokes law 6*pi*mu.

Usage:
  python examples/stokes_bem.py -recursions 3 -p 8 -k 4 -kfine 19
         -mu 1e-3 [-rbc] [-cells N] [-pmin 5] [-fgmres]
"""

import argparse
import sys
import time

sys.path.insert(0, __file__.rsplit("/", 2)[0])

import numpy as np


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("-recursions", type=int, default=3)
    ap.add_argument("-p", type=int, default=8)
    ap.add_argument("-k", type=int, default=4)
    ap.add_argument("-kfine", type=int, default=19)
    ap.add_argument("-mu", type=float, default=1e-3)
    ap.add_argument("-pmin", type=int, default=5)
    ap.add_argument("-theta", type=float, default=0.5)
    ap.add_argument("-ncrit", type=int, default=64)
    ap.add_argument("-solver_tol", type=float, default=1e-5)
    ap.add_argument("-max_iters", type=int, default=100)
    ap.add_argument("-fixed_p", action="store_true")
    ap.add_argument("-calibrate", action="store_true",
                    help="measure the matvec truncation-error decay on "
                    "this plan and drive the relaxation schedule with "
                    "the fitted eps(p) model instead of 2^-p")
    ap.add_argument("-p_tiers", default="auto",
                    help="comma-separated orders quantising the relaxed "
                    "schedule (every distinct order is a compiled "
                    "solver tier); 'auto' = 3,5,p; 'none' = the "
                    "reference's "
                    "continuous schedule")
    ap.add_argument("-fgmres", action="store_true")
    # inner-outer FMGMRES: inner relaxed GMRES on the same plan as the
    # right preconditioner (ref examples/BEM/fmgmres.hpp)
    ap.add_argument("-fmgmres", action="store_true")
    ap.add_argument("-inner_iters", type=int, default=10)
    ap.add_argument("-rbc", action="store_true", help="red blood cell geometry")
    ap.add_argument("-cells", type=int, default=1)
    ap.add_argument("-vert", default=None, help=".vert mesh file")
    ap.add_argument("-face", default=None, help=".face mesh file")
    ap.add_argument("-bio", action="store_true",
                    help="BioMesh conventions (extra .vert columns, "
                    "v1 v3 v2 face winding)")
    ap.add_argument("-dtype", default=None,
                    help="default: float32 on accelerators (the device "
                    "solver's native precision), float64 on CPU")
    ap.add_argument("-out_prefix", default=None,
                    help="write out.face/out.vert/out.charge dumps")
    ap.add_argument("-cpu", action="store_true", help="force host platform")
    ap.add_argument("-host_solver", action="store_true",
                    help="force the host GMRES loop (default: the "
                    "device-resident fused tier cascade on accelerators)")
    ap.add_argument("-checkpoint", default=None,
                    help="Krylov checkpoint path (resume if present)")
    ap.add_argument("-checkpoint_every", type=int, default=8)
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
    from fmm_bem_tpu.bem.triangulation import (
        load_vert_face,
        multiple_red_blood_cells,
        red_blood_cell,
        save_vert_face,
        unit_sphere,
    )
    from fmm_bem_tpu.config import FMMConfig, SolverConfig
    from fmm_bem_tpu.executor.plan import FmmPlan
    from fmm_bem_tpu.kernels.stokes_bem import StokesBEMKernel

    if args.vert and args.face:
        tris = load_vert_face(args.vert, args.face, bio=args.bio)
    elif args.rbc:
        if args.cells > 1:
            tris = multiple_red_blood_cells(args.cells, args.recursions)
        else:
            tris = red_blood_cell(args.recursions)
    else:
        tris = unit_sphere(args.recursions)
    fields = make_panels(tris, K=args.k)
    n = len(tris)
    print(f"initialised {n} panels")

    kern = StokesBEMKernel(K=args.k, fine_K=args.kfine, mu=args.mu)
    cfg = FMMConfig(
        theta=args.theta, ncrit=args.ncrit, max_p=max(args.p, 10),
        dtype=args.dtype,
    )
    t0 = time.time()
    plan = FmmPlan(kern, fields, cfg)
    print(f"plan built in {time.time()-t0:.3f}s")

    u = np.tile([1.0, 0.0, 0.0], (n, 1))
    b = np.asarray(plan.apply_flipped_bc(u, p=args.p))
    if not args.rbc:
        rhs_err = np.abs(b[:, 0] - 4 * np.pi).mean() / (4 * np.pi)
        print(f"rhs error: {rhs_err:.4e}")
        b = np.tile([4 * np.pi, 0.0, 0.0], (n, 1))  # ref StokesBEM.cpp:276

    from fmm_bem_tpu.config import default_p_tiers

    tiers = None
    if not args.fixed_p and args.p_tiers != "none":
        tiers = (
            default_p_tiers(args.p)
            if args.p_tiers == "auto"
            else tuple(int(t) for t in args.p_tiers.split(","))
        )
    scfg = SolverConfig(
        residual=args.solver_tol,
        max_iters=args.max_iters,
        restart=args.max_iters,
        max_p=args.p,
        p_min=args.pmin,
        variable_p=not args.fixed_p,
        p_tiers=tiers,
    )
    if args.calibrate and not args.fixed_p:
        t0 = time.time()
        scfg = scfg.calibrated(plan)
        print(
            f"calibrated eps(p) = {scfg.eps_c:.3g} * "
            f"{scfg.eps_gamma:.3g}^p in {time.time()-t0:.1f}s"
            if scfg.eps_c is not None
            else "calibration: truncation below noise; 2^-p model kept"
        )
    t0 = time.time()
    if args.fmgmres:
        from fmm_bem_tpu.solver.fmgmres import fmgmres

        def matvec(x, p):
            return plan.apply(x.reshape(n, 3), p=p).reshape(-1)

        x, info = fmgmres(
            matvec, b.reshape(-1), config=scfg,
            inner_iters=args.inner_iters, p_inner=args.pmin,
            verbose=True,
        )
        mode = "host-fmgmres"
    else:
        from fmm_bem_tpu.solver.api import solve_plan

        x, info, mode = solve_plan(
            plan, b.reshape(-1), scfg,
            p_fixed=args.p if args.fixed_p else None,
            flexible=args.fgmres, verbose=True,
            checkpoint_path=args.checkpoint,
            checkpoint_every=args.checkpoint_every,
            prefer_device=False if args.host_solver else None,
        )
    print(f"\nTIMING:\n\tsolve : {time.time()-t0:.4e}s [{mode}] "
          f"({info.iterations} its, residual {info.residual:.3e})")

    t_sol = np.asarray(x).reshape(n, 3)
    area = np.asarray(fields["area"])
    fx, fy, fz = (t_sol * area[:, None]).sum(axis=0)
    if not args.rbc:
        exact = 6 * np.pi * args.mu
        print(f"\nFx: {fx:.5f}, analytical: {exact:.4g}")
        print(f"error on a sphere: {abs(fx-exact)/exact:.5e}")
        print(f"area: {area.sum():.5f} vs {4*np.pi:.5f}")
    else:
        print(f"\ntotal force: ({fx:.5g}, {fy:.5g}, {fz:.5g})")

    if args.out_prefix:
        save_vert_face(tris, f"{args.out_prefix}.vert", f"{args.out_prefix}.face")
        np.savetxt(f"{args.out_prefix}.charge", t_sol)


if __name__ == "__main__":
    main()
