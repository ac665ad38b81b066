#!/usr/bin/env python
"""On-card smoke run of the FMM-BEM solver's main path.

In one process on one NVIDIA GPU, through the calls the example drivers
use (``make_panels``, ``FmmPlan``, ``solve_plan``, ``eval_exterior``):

1. device and card: JAX's device, ``nvidia-smi``'s name and power limit,
   and the native host library built from ``native/fmm_native.cpp``;
2. the Laplace BEM sphere at 131,072 panels (K=3, p=5, max_p=10,
   ncrit=64, leaf_pad=64, float32, cached near field): plan build,
   compile, chained matvecs, near store and peak device memory, and the
   near-field kernel against the plain XLA reference, alone and inside
   the chained matvec;
3. the card's matvec against the host CPU's at 8,192 panels;
4. the second-kind GMRES solve (p=5) against phi = 1;
5. the first-kind relaxed solve (p tiers 3/5/10) against dphi/dn = 1,
   and the exterior potential against 1/r;
6. the on-the-fly near mode against the cached one, and the point
   Laplace FMM at 100,000 points against direct summation.

``--cards 4`` runs only the distributed (LET) second-kind solve on four
cards, reads each card's peak memory, then solves the same system on
one card and compares.  Every phase checks its result; the
first failure ends the run with a non-zero exit.  The last line of
standard output is a JSON record of the device.

Usage: python chip_smoke.py [--cards 4]
"""

import argparse
import functools
import json
import subprocess
import sys
import time

import numpy as np

#: the benchmark sphere, 2 * 4**8 = 131,072 panels
MAIN_RECURSIONS = 8
#: 2 * 4**6 = 8,192 panels for the card-vs-host and OTF-vs-cached checks
SMALL_RECURSIONS = 6
POINTS = 100_000


class SmokeFailure(Exception):
    pass


def check(ok, what):
    if not ok:
        raise SmokeFailure(what)


def say(phase, **kv):
    print(f"[{phase}] " + " ".join(f"{k}={v!r}" for k, v in kv.items()),
          flush=True)


def rel_err(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def card_lines():
    """``nvidia-smi``'s name and power limit for each card."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return [ln.strip() for ln in out.stdout.splitlines() if ln.strip()]


def peak_bytes(device):
    return device.memory_stats()["peak_bytes_in_use"]


def sphere_plan(recursions, **config):
    """The benchmark's Laplace BEM sphere plan at ``recursions``."""
    from fmm_bem_tpu.bem.panels import make_panels
    from fmm_bem_tpu.bem.triangulation import unit_sphere
    from fmm_bem_tpu.config import FMMConfig
    from fmm_bem_tpu.executor.plan import FmmPlan
    from fmm_bem_tpu.kernels.laplace_bem import LaplaceBEMKernel

    fields = make_panels(unit_sphere(recursions), K=3)
    t0 = time.perf_counter()
    plan = FmmPlan(
        LaplaceBEMKernel(K=3), fields,
        FMMConfig(ncrit=64, dtype="float32", max_p=10, leaf_pad=64,
                  **config),
    )
    return plan, fields, time.perf_counter() - t0


def time_calls(fn, *args, reps):
    """Seconds per call of ``fn(*args)`` over ``reps`` queued calls."""
    fn(*args).block_until_ready()
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn(*args)
    out.block_until_ready()
    return (time.perf_counter() - t0) / reps


def chained_ms(matvec, operand, q, p, chain=20, repeats=5):
    """Per-matvec ms of chained slot-space matvecs, as the device solver
    runs them: each takes the previous one's output, dispatched back to
    back and timed to the last result with ``block_until_ready``.
    Returns (median, min) over ``repeats`` chains."""
    import jax.numpy as jnp

    # 1/(4 pi) keeps the chained iterate bounded (G.1 = 4 pi on the
    # unit sphere)
    scale = jnp.float32(1.0 / (4.0 * np.pi))
    times = []
    for _ in range(repeats):
        x = q
        t0 = time.perf_counter()
        for _ in range(chain):
            x = matvec(operand, x, p) * scale
        x.block_until_ready()
        times.append((time.perf_counter() - t0) / chain)
    check(bool(jnp.isfinite(x).all()), "chained matvec not finite")
    return 1e3 * float(np.median(times)), 1e3 * min(times)


def phase_matvec(plan, build_s, matvec, p=5):
    """Operand build, compile and chained matvecs at the main size."""
    import jax
    import jax.numpy as jnp

    n = plan.src.tree.num_bodies
    _, op4p, to_s, _, _ = plan.solver_ops_slots()
    t0 = time.perf_counter()
    operand = jax.block_until_ready(op4p(p))
    operand_s = time.perf_counter() - t0
    q = to_s(jnp.ones(n, jnp.float32))
    t0 = time.perf_counter()
    matvec(operand, q, p).block_until_ready()
    compile_s = time.perf_counter() - t0
    med, low = chained_ms(matvec, operand, q, p)
    A = operand[1]["panels"]["A"]
    say("main", panels=n, plan_build_s=build_s, operand_s=operand_s,
        compile_s=compile_s, matvec_ms_median=med, matvec_ms_min=low,
        near_store_bytes=int(A.nbytes),
        peak_bytes_in_use=peak_bytes(jax.devices()[0]))
    return operand, q


def phase_near_kernel(plan, operand, reps=50):
    """The near-field kernel as compiled for the card against the plain
    XLA contraction on the benchmark's own panel store, with a copy and
    a read-only stream of the same bytes as ceilings."""
    import jax
    import jax.numpy as jnp

    from fmm_bem_tpu.ops.near_panel import panel_matvec

    panels, meta = operand[1]["panels"], plan._near_meta
    nl_s, K = plan.src.leaf_body_mask.shape
    rng = np.random.default_rng(0)
    ql = jnp.asarray(
        rng.standard_normal((nl_s, K)) * plan.src.leaf_body_mask,
        jnp.float32,
    )
    fns = {
        impl: jax.jit(
            lambda pn, q, impl=impl: panel_matvec(pn, meta, q, impl=impl)
        )
        for impl in ("triton", "xla")
    }
    got = np.asarray(fns["triton"](panels, ql))
    ref = np.asarray(fns["xla"](panels, ql))
    err = rel_err(got, ref)
    check(err <= 1e-5, f"near kernel vs XLA reference: rel err {err}")
    A = panels["A"]
    # copy and read-only ceilings of the same bytes
    t_tri = time_calls(fns["triton"], panels, ql, reps=reps)
    t_xla = time_calls(fns["xla"], panels, ql, reps=reps)
    t_copy = time_calls(jax.jit(jnp.negative), A, reps=reps)
    t_read = time_calls(jax.jit(jnp.sum), A, reps=reps)
    gb = A.nbytes / 1e9
    say("near", rel_err=err, max_abs_err=float(np.abs(got - ref).max()),
        triton_ms=1e3 * t_tri, xla_ms=1e3 * t_xla,
        triton_gbs=gb / t_tri, xla_gbs=gb / t_xla,
        copy_gbs=2 * gb / t_copy, read_gbs=gb / t_read)


def phase_near_end_to_end(plan, operand, q, matvec, p=5, rounds=2):
    """The chained matvec with the near-field kernel and with the plain
    XLA contraction in its place, alternated (kernel, XLA, XLA, kernel,
    ...) in this one process."""
    from unittest import mock

    import jax

    from fmm_bem_tpu.ops import near_panel

    # a fresh closure, so jit traces it anew: with the XLA contraction
    # patched in for that one trace
    matvec_xla = jax.jit(plan.solver_ops_slots()[0], static_argnums=2)
    with mock.patch.object(
        near_panel, "panel_matvec",
        functools.partial(near_panel.panel_matvec, impl="xla"),
    ):
        t0 = time.perf_counter()
        ref = matvec_xla(operand, q, p).block_until_ready()
        compile_xla_s = time.perf_counter() - t0
    err = rel_err(matvec(operand, q, p), ref)
    check(err <= 1e-5, f"matvec with kernel vs with XLA: rel err {err}")
    ms = {"triton": [], "xla": []}
    order = ["triton", "xla", "xla", "triton"] * rounds
    for impl in order:
        fn = matvec if impl == "triton" else matvec_xla
        ms[impl].append(chained_ms(fn, operand, q, p)[0])
    say("near_e2e", rel_err=err, compile_xla_s=compile_xla_s,
        order=order, matvec_ms_triton=ms["triton"], matvec_ms_xla=ms["xla"],
        median_triton=float(np.median(ms["triton"])),
        median_xla=float(np.median(ms["xla"])))


def phase_small(p=5):
    """At 8,192 panels: the same slot-space matvec on the card and on
    the host CPU, and the on-the-fly near mode against the cached
    store, on the card."""
    import jax
    import jax.numpy as jnp

    cached, _, _ = sphere_plan(SMALL_RECURSIONS)
    otf, _, _ = sphere_plan(SMALL_RECURSIONS, near_mode="otf")
    n = cached.src.tree.num_bodies
    qn = np.random.default_rng(1).standard_normal(n)
    out = {}
    for name, plan in (("cached", cached), ("otf", otf)):
        mv, op4p, to_s, from_s, _ = plan.solver_ops_slots()
        f = jax.jit(mv, static_argnums=2)
        operand, q = op4p(p), to_s(jnp.asarray(qn, jnp.float32))
        out[name] = np.asarray(from_s(f(operand, q, p)))
        if name == "cached":
            cpu = jax.devices("cpu")[0]
            host = np.asarray(from_s(jax.device_get(f(
                jax.device_put(operand, cpu), jax.device_put(q, cpu), p
            ))))
    card = out["cached"]
    err = rel_err(card, host)
    otf_err = float(np.abs(out["otf"] - card).max() / np.abs(card).max())
    say("small", panels=n, card_vs_cpu_rel_err=err,
        card_vs_cpu_max_err_over_max=float(
            np.abs(card - host).max() / np.abs(host).max()),
        otf_vs_cached_max_err_over_max=otf_err)
    check(err <= 1e-5, f"card vs host CPU matvec: rel err {err}")
    check(otf_err <= 1e-5, f"OTF vs cached near field: {otf_err}")


def slot_apply(plan, matvec, x, p, flipped=False):
    """One slot-space matvec of the plan's (optionally BC-flipped)
    operator on a user-order vector, through the jitted ``matvec``."""
    import jax.numpy as jnp

    _, op4p, to_s, from_s, _ = plan.solver_ops_slots(flipped=flipped)
    return np.asarray(from_s(matvec(op4p(p), to_s(jnp.asarray(x)), p)))


def phase_second_kind(plan, matvec, p=5, cpu_iters=3):
    """Second-kind solve (dGdn system, BC flipped) against phi = 1;
    RHS = G . (dphi/dn = 1)."""
    from fmm_bem_tpu.config import SolverConfig
    from fmm_bem_tpu.solver.api import solve_plan
    from fmm_bem_tpu.solver.gmres import DeviceGmresContext

    n = plan.src.tree.num_bodies
    b = slot_apply(plan, matvec, np.ones(n, np.float32), p)
    cfg = SolverConfig(residual=1e-5, max_p=p, max_iters=60, restart=60)
    ctx = DeviceGmresContext()
    kw = dict(flipped=True, p_fixed=p, context=ctx)
    t0 = time.perf_counter()
    solve_plan(plan, b, cfg, **kw)
    first_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    x, info, mode = solve_plan(plan, b, cfg, **kw)
    solve_s = time.perf_counter() - t0
    err = float(np.linalg.norm(x - 1.0) / np.sqrt(n))
    say("second_kind", mode=mode, iterations=info.iterations,
        residual=float(info.residual), converged=bool(info.converged), error=err,
        first_solve_s=first_s, solve_s=solve_s)
    check(info.converged, "second-kind solve did not converge")
    check(abs(info.iterations - cpu_iters) <= 1,
          f"second-kind iterations {info.iterations} vs {cpu_iters} on CPU")
    check(err <= 2e-3, f"second-kind error {err}")


def phase_first_kind(plan, fields, matvec, exterior_tol):
    """First-kind relaxed solve (G system, p tiers 3/5/10) against
    dphi/dn = 1, RHS = dGdn . (phi = 1); then the exterior potential
    at (3, 3, 3)."""
    from fmm_bem_tpu.config import SolverConfig
    from fmm_bem_tpu.solver.api import solve_plan
    from fmm_bem_tpu.solver.gmres import DeviceGmresContext

    n = plan.src.tree.num_bodies
    ones = np.ones(n, np.float32)
    b = slot_apply(plan, matvec, ones, 10, flipped=True)
    cfg = SolverConfig(residual=1e-5, max_iters=100, restart=100,
                       max_p=10, p_min=1, p_tiers=(3, 5, 10))
    ctx = DeviceGmresContext()
    t0 = time.perf_counter()
    solve_plan(plan, b, cfg, context=ctx)
    first_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    x, info, mode = solve_plan(plan, b, cfg, context=ctx)
    solve_s = time.perf_counter() - t0
    err = float(np.linalg.norm(x - 1.0) / np.sqrt(n))
    pt = np.array([[3.0, 3.0, 3.0]])
    kern = plan.kernel
    phi = (kern.eval_exterior(fields, x, pt, layer="G")
           - kern.eval_exterior(fields, ones, pt, layer="dGdn")) / (4 * np.pi)
    exact = 1.0 / np.linalg.norm(pt)
    ext_err = float(abs(phi[0] - exact) / exact)
    say("first_kind", mode=mode, iterations=info.iterations,
        residual=float(info.residual), converged=bool(info.converged), error=err,
        p_schedule=[int(h[2]) for h in info.history],
        first_solve_s=first_s, solve_s=solve_s,
        exterior_phi=float(phi[0]), exterior_exact=float(exact),
        exterior_err=ext_err)
    check(info.converged, "first-kind relaxed solve did not converge")
    check(err <= 1e-3, f"first-kind error {err}")
    check(ext_err <= exterior_tol, f"exterior potential error {ext_err}")


def phase_points(n_points, p=8, nsamples=1000, tol_pot=2e-4, tol_force=3e-4):
    """Point Laplace FMM (potential + force) against direct summation on
    sampled targets, as ``examples/serialrun.py`` runs it."""
    import jax.numpy as jnp

    from fmm_bem_tpu.config import FMMConfig
    from fmm_bem_tpu.executor.plan import FmmPlan
    from fmm_bem_tpu.kernels.laplace import LaplaceKernel

    rng = np.random.default_rng(3)
    pts = rng.uniform(0, 1, (n_points, 3))
    q = rng.standard_normal(n_points)
    kern = LaplaceKernel()
    t0 = time.perf_counter()
    plan = FmmPlan(kern, {"xyz": pts},
                   FMMConfig(ncrit=64, max_p=p, dtype="float32"))
    build_s = time.perf_counter() - t0
    res = np.asarray(plan.apply(q, p=p))
    sample = rng.choice(n_points, nsamples, replace=False)
    exact = np.asarray(kern.direct(pts[sample], pts, jnp.asarray(q)))
    approx = res[sample]
    e_pot = rel_err(approx[:, 0], exact[:, 0])
    e_force = rel_err(approx[:, 1:], exact[:, 1:])
    say("points", n=n_points, plan_build_s=build_s, pot_err=e_pot,
        force_err=e_force)
    check(e_pot <= tol_pot, f"point FMM potential error {e_pot}")
    check(e_force <= tol_force, f"point FMM force error {e_force}")


def phase_let(plan, cards, p=5):
    """LET second-kind solve on a 1-D mesh of ``cards`` devices, then the
    one-card solve of the same system.  Each card's peak memory is read
    before the one-card reference exists, so it shows the LET state's
    own spread."""
    import jax

    from fmm_bem_tpu.config import SolverConfig
    from fmm_bem_tpu.parallel.let import LetPlan
    from fmm_bem_tpu.solver.api import solve_plan
    from fmm_bem_tpu.solver.gmres import gmres_device

    n = plan.src.tree.num_bodies
    # RHS = G . (dphi/dn = 1), the system and settings of
    # phase_second_kind, with the right-hand side made on the cards
    t0 = time.perf_counter()
    b = LetPlan(plan, cards).apply(np.ones(n, np.float32), p)[:, 0]
    rhs_s = time.perf_counter() - t0
    cfg = SolverConfig(residual=1e-5, max_p=p, max_iters=60, restart=60)
    t0 = time.perf_counter()
    lp = LetPlan(plan, cards, flipped=True)
    let_build_s = time.perf_counter() - t0
    mv, op4p = lp.solver_ops()
    t0 = time.perf_counter()
    x_pad, info = gmres_device(mv, lp.to_padded(b), operand_for_p=op4p,
                               config=cfg, p_fixed=p)
    x = lp.from_padded(np.asarray(x_pad)[:, None])[:, 0]
    let_s = time.perf_counter() - t0
    peaks = [peak_bytes(d) for d in jax.devices()[:cards]]
    del lp, mv, op4p, x_pad
    t0 = time.perf_counter()
    x_ref, info_ref, _ = solve_plan(plan, b, cfg, flipped=True, p_fixed=p)
    one_s = time.perf_counter() - t0
    err = rel_err(x, x_ref)
    say("let", cards=cards, panels=n, rhs_s=rhs_s, let_build_s=let_build_s,
        iterations=info.iterations, iterations_one_card=info_ref.iterations,
        rel_err_vs_one_card=err, error=float(
            np.linalg.norm(x - 1.0) / np.sqrt(n)),
        first_solve_s_let=let_s, first_solve_s_one_card=one_s,
        peak_bytes_in_use_let=peaks,
        peak_bytes_in_use_after_one_card=peak_bytes(jax.devices()[0]))
    check(info.converged and info_ref.converged, "LET solve did not converge")
    check(err <= 1e-5, f"LET vs one-card solution: rel err {err}")
    check(min(peaks) >= 0.1 * max(peaks),
          f"LET state piled onto few cards: peak bytes {peaks}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cards", type=int, choices=(1, 4), default=1,
                    help="4: run only the LET solve across four cards")
    args = ap.parse_args(argv)

    import jax

    from fmm_bem_tpu.utils.compile_cache import enable_compile_cache

    devices = jax.devices()
    platform = devices[0].platform
    if platform != "gpu":
        raise SystemExit(f"chip_smoke: needs an NVIDIA GPU, JAX found "
                         f"{platform!r}")
    if len(devices) < args.cards:
        raise SystemExit(f"chip_smoke: --cards {args.cards} but JAX sees "
                         f"{len(devices)} device(s)")

    from fmm_bem_tpu import native

    cards = card_lines()
    say("device", kind=devices[0].device_kind, count=len(devices),
        compile_cache=enable_compile_cache())
    for line in cards:
        print(f"[card] {line}", flush=True)
    t0 = time.perf_counter()
    native.get_lib(required=True)
    say("native", library=native.library_path(),
        build_and_load_s=time.perf_counter() - t0)

    try:
        plan, fields, build_s = sphere_plan(MAIN_RECURSIONS)
        if args.cards > 1:
            phase_let(plan, args.cards)
        else:
            # one compiled slot-space matvec per order serves the
            # timing and both right-hand sides
            matvec = jax.jit(plan.solver_ops_slots()[0], static_argnums=2)
            operand, q = phase_matvec(plan, build_s, matvec)
            phase_near_kernel(plan, operand)
            phase_near_end_to_end(plan, operand, q, matvec)
            del operand, q
            phase_second_kind(plan, matvec)
            # exterior tolerance: the CPU run gives 6.1e-4 at 8,192
            # panels, and the error falls as the mesh is refined
            phase_first_kind(plan, fields, matvec, exterior_tol=1e-3)
            del plan, matvec
            phase_small()
            phase_points(POINTS)
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr, flush=True)
        return 1
    print(f"[card] {cards[0]}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": platform,
        "kind": devices[0].device_kind,
        "count": len(devices),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
