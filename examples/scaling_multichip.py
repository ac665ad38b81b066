#!/usr/bin/env python
"""Multi-device scaling harness for the LET-distributed FMM
(fmm_bem_tpu/parallel/let.py).

Produces the BASELINE.md scaling evidence:
  - ``-mode mem``    per-device memory/work at fixed N vs device count
                     (panels, M2L pairs, expansions, halo sizes) plus
                     the largest collective operand from the compiled
                     HLO — proof the panels/tiles are sharded and only
                     halo-sized data moves.
  - ``-mode weak``   matvec wall-clock with N scaled ∝ devices
                     (weak-scaling efficiency).
  - ``-mode strong`` matvec wall-clock at fixed N vs device count.

On a CPU host the 8 virtual devices share the machine's cores, so
wall-clock efficiencies are indicative (collectives + partitioning are
fully exercised; compute parallelism is bounded by the host).  On a
machine with several GPUs the same harness produces the real numbers.

Usage:
  JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
      python examples/scaling_multichip.py -mode mem -recursions 6
      python examples/scaling_multichip.py -mode weak -N 16384
"""

import argparse
import re
import sys
import time

sys.path.insert(0, __file__.rsplit("/", 2)[0])

import numpy as np


def _max_collective_bytes(fn, dd, qp, itemsize):
    """Largest collective RESULT operand in the compiled HLO, in bytes:
    the proof point that only halo/tree-top data crosses the mesh."""
    import jax

    txt = jax.jit(fn).lower(dd, qp).compile().as_text()
    return max_collective_bytes_hlo(txt, itemsize)


def max_collective_bytes_hlo(txt, itemsize):
    worst = (0, "")
    ops = (
        "all-gather(", "all-reduce(", "collective-permute(",
        "reduce-scatter(", "all-to-all(",
    )
    for line in txt.splitlines():
        if not any(op in line for op in ops):
            continue
        lhs = line.split("=", 1)
        if len(lhs) != 2:
            continue
        # result shape(s): every dim group left of the op call
        head = lhs[1].split("(", 1)[0]
        elems = 0
        for g in re.findall(r"\[([0-9,]*)\]", head):
            e = 1
            for v in g.split(","):
                if v:
                    e *= int(v)
            elems += e
        if elems * itemsize > worst[0]:
            opname = next(o[:-1] for o in ops if o in line)
            worst = (elems * itemsize, f"{opname} {head.strip()}")
    return worst


def _bem_plan(recursions, ncrit, dtype, max_p):
    from fmm_bem_tpu.bem.panels import make_panels
    from fmm_bem_tpu.bem.triangulation import unit_sphere
    from fmm_bem_tpu.config import FMMConfig
    from fmm_bem_tpu.executor.plan import FmmPlan
    from fmm_bem_tpu.kernels.laplace_bem import LaplaceBEMKernel

    tris = unit_sphere(recursions)
    fields = make_panels(tris, K=3)
    return FmmPlan(
        LaplaceBEMKernel(K=3),
        fields,
        FMMConfig(ncrit=ncrit, dtype=dtype, max_p=max_p),
    )


def _point_plan(n, ncrit, dtype, max_p, seed=0, leaf_pad=None):
    from fmm_bem_tpu.config import FMMConfig
    from fmm_bem_tpu.executor.plan import FmmPlan
    from fmm_bem_tpu.kernels.laplace import LaplaceKernel

    pts = np.random.default_rng(seed).uniform(0, 1, (n, 3))
    return FmmPlan(
        LaplaceKernel(),
        {"xyz": pts},
        FMMConfig(ncrit=ncrit, dtype=dtype, max_p=max_p,
                  leaf_pad=leaf_pad),
    )


def _time_matvec(lp, q, p, reps=5):
    fn, dd = lp.matvec_fn(p)
    qp = lp.to_padded(q)
    out = np.asarray(fn(dd, qp))  # compile + sync
    t0 = time.time()
    for _ in range(reps):
        out = np.asarray(fn(dd, qp))
    return (time.time() - t0) / reps, out


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("-mode", choices=["mem", "weak", "strong"],
                    default="mem")
    ap.add_argument("-N", type=int, default=16384,
                    help="base body count (weak/strong, point kernel)")
    ap.add_argument("-recursions", type=int, default=6,
                    help="sphere recursions (mem mode, BEM kernel)")
    ap.add_argument("-p", type=int, default=5)
    ap.add_argument("-ncrit", type=int, default=64)
    ap.add_argument("-dtype", default="float32")
    ap.add_argument("-cpu", action="store_true", help="force host platform")
    ap.add_argument("-devs", type=str, default=None,
                    help="comma list of device counts (default 1,2,4,8"
                    " capped at available)")
    ap.add_argument("-pin_leaf_pad", type=int, default=None,
                    help="pin the leaf tile width across the sweep "
                    "(default: ncrit in weak/strong modes) so P2P "
                    "block shapes are constant — tree-shape changes "
                    "otherwise masquerade as scaling effects")
    args = ap.parse_args()

    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    from fmm_bem_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    from fmm_bem_tpu.parallel.let import LetPlan

    ndev_all = len(jax.devices())
    if args.devs:
        counts = [int(c) for c in args.devs.split(",")]
    else:
        counts = [d for d in (1, 2, 4, 8, 16, 32) if d <= ndev_all]
    itemsize = np.dtype(args.dtype).itemsize
    print(f"devices available: {ndev_all} ({jax.devices()[0].platform})")

    if args.mode == "mem":
        plan = _bem_plan(args.recursions, args.ncrit, args.dtype,
                         max(args.p, 8))
        n = plan.tree.num_bodies
        q = np.ones(n, args.dtype)
        print(f"Laplace BEM sphere, {n} panels, p={args.p}")
        print("ndev  panelMB/dev  m2lpairs/dev  expKB/dev  haloKB  "
              "maxcollKB  collective")
        for nd in counts:
            lp = LetPlan(plan, nd)
            st = lp.stats()
            fn, dd = lp.matvec_fn(args.p)
            qp = lp.to_padded(q)
            cb, cdesc = _max_collective_bytes(fn, dd, qp, itemsize)
            halo = st["halo_multipole_bytes"] + st["halo_charge_bytes"]
            print(
                f"{nd:4d}  {st['near_panel_bytes_per_dev']/1e6:10.2f}"
                f"  {st['m2l_pairs_per_dev']:12d}"
                f"  {st['expansion_bytes_per_dev']/1e3:9.1f}"
                f"  {halo/1e3:7.1f}  {cb/1e3:8.1f}  {cdesc}"
            )
        return

    # weak / strong: point Laplace (panel counts quantise by 4x)
    pin = args.pin_leaf_pad if args.pin_leaf_pad else args.ncrit
    base_rate = None
    base_wrate = None
    print(f"Laplace points, p={args.p}, {args.mode} scaling, "
          f"leaf_pad pinned to {pin}")
    print("ndev       N   matvec[ms]    pairs/s    eff(N^2)  eff(work)")
    for nd in counts:
        n = args.N * nd if args.mode == "weak" else args.N
        plan = _point_plan(n, args.ncrit, args.dtype, max(args.p, 6),
                           leaf_pad=pin)
        # measured work of THIS tree (flop proxy): padded P2P blocks +
        # M2L class matmuls.  N^2-normalised "effective" efficiency
        # bakes octree level transitions into the number (work per
        # point jumps whenever N crosses a ncrit*8^L boundary — at
        # N=32768 exactly, for ncrit=64); normalising by the tree's
        # actual work isolates the DISTRIBUTION cost (halos, padding
        # to the max range, collectives), which is what the scaling
        # study is about.
        Wexp = plan.kernel.width(args.p)
        cW = plan.kernel.ncomp * Wexp
        K = plan.src.leaf_pad
        work = (
            20.0 * len(plan.p2p_src_slot) * K * K
            + 2.0 * len(plan.m2l_tile_src) * cW * Wexp
        )
        lp = LetPlan(plan, nd)
        q = np.random.default_rng(1).standard_normal(n).astype(args.dtype)
        dt, _ = _time_matvec(lp, q, args.p)
        rate = n * n / dt
        wrate = work / dt
        if base_rate is None:
            base_rate = (rate / nd, wrate / nd) if args.mode == "weak" \
                else (rate, wrate)
        if args.mode == "weak":
            eff = (rate / nd) / base_rate[0]
            effw = (wrate / nd) / base_rate[1]
        else:
            eff = rate / (base_rate[0] * nd)
            effw = wrate / (base_rate[1] * nd)
        print(f"{nd:4d} {n:8d}   {dt*1e3:9.2f}  {rate:.3e}   "
              f"{eff:8.1%}  {effw:8.1%}")


if __name__ == "__main__":
    main()
