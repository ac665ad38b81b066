#!/usr/bin/env python
"""FMM vs direct-summation timing (ref tests/scaling.cpp: N=10,000
Laplace, 3-run average, force error) and ncrit tuning sweep (ref
tests/ncrit_search.cpp: ncrit 50..400 step 50).

Usage:
  python examples/scaling.py                 # scaling run
  python examples/scaling.py -ncrit_search   # ncrit sweep
"""

import argparse
import sys
import time

sys.path.insert(0, __file__.rsplit("/", 2)[0])

import numpy as np


def run_once(pts, q, ncrit, p, runs=3):
    import jax.numpy as jnp

    from fmm_bem_tpu.config import FMMConfig
    from fmm_bem_tpu.executor.plan import FmmPlan
    from fmm_bem_tpu.kernels.laplace import LaplaceKernel

    kern = LaplaceKernel()
    plan = FmmPlan(
        kern, {"xyz": pts}, FMMConfig(ncrit=ncrit, max_p=max(p, 8), dtype="float32")
    )
    res = plan.apply(q, p=p)
    res.block_until_ready()  # compile
    t0 = time.time()
    for _ in range(runs):
        res = plan.apply(q, p=p)
    res.block_until_ready()
    return (time.time() - t0) / runs, res


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("-N", type=int, default=10000)
    ap.add_argument("-p", type=int, default=8)
    ap.add_argument("-ncrit", type=int, default=125)  # ref "optimal ncrit"
    ap.add_argument("-ncrit_search", action="store_true")
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

    from fmm_bem_tpu.kernels.laplace import LaplaceKernel

    rng = np.random.default_rng(args.seed)
    pts = rng.uniform(0, 1, (args.N, 3))
    q = rng.standard_normal(args.N)

    if args.ncrit_search:
        print("ncrit  t_fmm[s]   interactions/s")
        for ncrit in range(50, 401, 50):
            dt, _ = run_once(pts, q, ncrit, args.p)
            print(f"{ncrit:5d}  {dt:.5f}  {args.N**2/dt:.3e}")
        return

    dt_fmm, res = run_once(pts, q, args.ncrit, args.p)
    kern = LaplaceKernel()
    nsamp = min(1000, args.N)
    t0 = time.time()
    exact = kern.direct(pts[:nsamp], pts, jnp.asarray(q))
    np.asarray(exact)
    dt_direct = (time.time() - t0) * (args.N / nsamp)
    approx = np.asarray(res)[:nsamp]
    exact = np.asarray(exact)
    ef = np.linalg.norm(approx[:, 1:] - exact[:, 1:]) / np.linalg.norm(exact[:, 1:])
    print(f"N = {args.N}, p = {args.p}, ncrit = {args.ncrit}")
    print(f"FMM time    : {dt_fmm:.4f}s")
    print(f"direct time : {dt_direct:.4f}s (extrapolated)")
    print(f"speedup     : {dt_direct/dt_fmm:.1f}x")
    print(f"force error : {ef:.4e}")


if __name__ == "__main__":
    main()
