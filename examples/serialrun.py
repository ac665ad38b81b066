#!/usr/bin/env python
"""Point-FMM accuracy driver: random cube of N bodies, FMM vs direct
summation on sampled targets (ref serialrun.cpp:136-208 and
serialrun_stresslet.cpp; the kernel is a flag instead of a #define).

Usage: python examples/serialrun.py -N 10000 -p 8 -kernel laplace
       [-kernel laplace|laplace_cartesian|yukawa|yukawa_spherical|stokes|stresslet|unit]
"""

import argparse
import sys
import time

sys.path.insert(0, __file__.rsplit("/", 2)[0])

import numpy as np


def make_kernel(name, kappa):
    if name == "laplace":
        from fmm_bem_tpu.kernels.laplace import LaplaceKernel

        return LaplaceKernel()
    if name == "laplace_cartesian":
        from fmm_bem_tpu.kernels.cartesian import LaplaceCartesianKernel

        return LaplaceCartesianKernel()
    if name == "yukawa":
        from fmm_bem_tpu.kernels.cartesian import YukawaKernel

        return YukawaKernel(kappa=kappa)
    if name == "yukawa_spherical":
        from fmm_bem_tpu.kernels.spherical_yukawa import (
            YukawaSphericalKernel,
        )

        return YukawaSphericalKernel(kappa=kappa)
    if name == "stokes":
        from fmm_bem_tpu.kernels.stokes import StokesKernel

        return StokesKernel()
    if name == "stresslet":
        from fmm_bem_tpu.kernels.stokes import StressletKernel

        return StressletKernel()
    if name == "unit":
        from fmm_bem_tpu.kernels.unit import UnitKernel

        return UnitKernel()
    raise SystemExit(f"unknown kernel {name}")


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("-N", type=int, default=10000)
    ap.add_argument("-p", type=int, default=8)
    ap.add_argument("-theta", type=float, default=0.5)
    ap.add_argument("-ncrit", type=int, default=64)
    ap.add_argument("-kernel", default="laplace")
    ap.add_argument("-kappa", type=float, default=0.125)
    ap.add_argument("-nsamples", type=int, default=1000)
    ap.add_argument("-treecode", action="store_true")
    ap.add_argument("-dtype", default="float64")
    ap.add_argument("-seed", type=int, default=0)
    ap.add_argument("-cpu", action="store_true", help="force host platform")
    args = ap.parse_args()

    if args.cpu:
        import jax

        jax.config.update("jax_platforms", "cpu")
    if getattr(args, "dtype", None) == "float64":
        # float64 silently truncates to f32 unless x64 is enabled
        import jax

        jax.config.update("jax_enable_x64", True)
    from fmm_bem_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    import jax.numpy as jnp

    from fmm_bem_tpu.config import Evaluator, FMMConfig
    from fmm_bem_tpu.executor.plan import FmmPlan

    kern = make_kernel(args.kernel, args.kappa)
    rng = np.random.default_rng(args.seed)
    pts = rng.uniform(0, 1, (args.N, 3))
    qdim = getattr(kern, "charge_dim", 1)
    q = rng.standard_normal((args.N, qdim)).squeeze()

    cfg = FMMConfig(
        theta=args.theta,
        ncrit=args.ncrit,
        max_p=max(args.p, 8),
        dtype=args.dtype,
        evaluator=Evaluator.TREECODE if args.treecode else Evaluator.FMM,
    )
    t0 = time.time()
    plan = FmmPlan(kern, {"xyz": pts}, cfg)
    print(f"plan build: {time.time()-t0:.3f}s  "
          f"(boxes {plan.tree.num_boxes}, p2p pairs "
          f"{len(plan.lists.p2p_pairs)}, m2l pairs "
          f"{len(plan.lists.m2l_pairs)})")

    t0 = time.time()
    res = plan.apply(q, p=args.p)
    res.block_until_ready()
    print(f"first matvec (incl. compile): {time.time()-t0:.3f}s")
    t0 = time.time()
    res = plan.apply(q, p=args.p)
    res.block_until_ready()
    dt = time.time() - t0
    print(f"matvec: {dt:.4f}s  ({args.N**2/dt:.3e} interactions/s)")

    sample = rng.choice(args.N, min(args.nsamples, args.N), replace=False)
    exact = kern.direct(pts[sample], pts, jnp.asarray(q))
    approx = np.asarray(res)[sample]
    exact = np.asarray(exact)
    if exact.ndim == 2 and exact.shape[1] >= 4:
        ep = np.linalg.norm(approx[:, 0] - exact[:, 0]) / np.linalg.norm(exact[:, 0])
        ef = np.linalg.norm(approx[:, 1:] - exact[:, 1:]) / np.linalg.norm(exact[:, 1:])
        print(f"potential rel. L2 error: {ep:.4e}")
        print(f"force     rel. L2 error: {ef:.4e}")
    else:
        e = np.linalg.norm(approx - exact) / np.linalg.norm(exact)
        print(f"rel. L2 error: {e:.4e}")


if __name__ == "__main__":
    main()
