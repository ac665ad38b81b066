"""Per-phase device timing + roofline accounting for the FMM matvec.

The reference prints a per-matvec P2P/M2L wall-clock split
(EvalInteractionLazy.hpp:137-152).  This module measures each pipeline
phase on the device and scores it against an analytic FLOP/byte model:

- matmul phases (M2M/M2L/L2L) against the float32 rate outside the
  tensor cores, the rate that applies under the package's "highest"
  matmul precision (fmm_bem_tpu/__init__.py);
- streaming phases (P2M/L2P tables, near-field panels) against device
  memory bandwidth — they touch their operand bytes exactly once.

Timing method: phases are measured as *pipeline prefixes* — P2M;
P2M+M2M; ...; the full matvec — each chained inside ONE jitted
lax.scan, and per-phase time is the difference of consecutive prefix
times.  Because the last prefix IS the matvec, the per-phase numbers
telescope to the measured pipeline total by construction;
``total.sum_ratio`` reports that total against an independently timed
production matvec chain.  Isotonic (PAVA) regression on the cumulative
times removes negative differences from timing noise.  Each scan step
feeds a scalar of its output back into the charges, so XLA cannot
dead-code or reorder across steps.  The solo method (each phase in an
isolated scan) survives as an optional ``solo=True`` cross-check
column (``ms_solo``).
"""

from __future__ import annotations

import time
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np


class Peaks(NamedTuple):
    """Published per-card peaks (FLOP/s, FLOP/s, FLOP/s, bytes/s)."""

    f32: float   # float32 outside the tensor cores
    tf32: float  # tensor cores, TF32, dense
    bf16: float  # tensor cores, bf16, dense
    hbm: float   # device memory bandwidth


#: keyed by JAX's ``device_kind``.  Source: NVIDIA H100 Tensor Core GPU
#: data sheet, SXM5 part, dense rates (no sparsity) at the 700 W limit.
CHIP_PEAKS = {
    "NVIDIA H100 80GB HBM3": Peaks(67e12, 495e12, 989e12, 3.35e12),
}


def chip_peaks(device=None):
    """Peaks of ``device`` (default: the first JAX device).

    Returns None on the CPU, which has no roofline here; raises
    ``KeyError`` for an accelerator kind missing from ``CHIP_PEAKS``.
    """
    device = device if device is not None else jax.devices()[0]
    if device.platform == "cpu":
        return None
    if device.device_kind not in CHIP_PEAKS:
        raise KeyError(
            f"no published peaks for device kind {device.device_kind!r}; "
            "add its data-sheet figures to CHIP_PEAKS"
        )
    return CHIP_PEAKS[device.device_kind]


def _flop_byte_model(plan, p):
    """Analytic per-phase FLOPs and HBM bytes for one matvec."""
    kern = plan.kernel
    W = kern.width(p)
    cW = kern.ncomp * W
    it = jnp.dtype(plan.config.dtype).itemsize
    n = plan.src.tree.num_bodies
    nbox = plan.src.tree.num_boxes
    nl = len(plan.src.leaf_ids)
    K = plan.src.leaf_pad
    rdim = getattr(kern, "result_dim", 1)
    cdim = getattr(kern, "charge_dim", 1)

    model = {}
    # P2M table: one stream of the slot-ordered table + the box write
    # (the charge broadcast, tile reduce and scatter fuse — XLA keeps
    # the contribution rows in registers, so they are not re-read)
    model["p2m"] = (
        2.0 * nl * K * cW * cdim,
        (nl * K * cW * cdim + nbox * cW) * it,
    )
    nch = nbox - 1
    # translation matmuls are de-kron'd: [rows*ncomp, W] x [W, W]
    model["m2m"] = (
        2.0 * nch * cW * W,
        (2 * nch * cW + len(plan.src.m2m_mats) * W * W) * it,
    )
    npairs = len(plan.m2l_tile_src)
    ntile = npairs // max(plan.m2l_tile_size, 1) if npairs else 0
    m2l_flops = 2.0 * npairs * cW * W
    # residual tiles: gathered expansions in+out, one W x W matrix per
    # TILE, and the bucket-sum re-read
    m2l_bytes = (3 * npairs * cW + ntile * W * W) * it
    fam = getattr(plan, "m2l_fam", None)
    if fam is not None:
        Fpad = sum(len(a) for a in fam.cls_sp)
        W8 = 8 * W
        m2l_flops += 2.0 * Fpad * kern.ncomp * W8 * W8
        m2l_bytes += (
            2 * fam.nusp * 8 * cW          # sibling stage in+out
            + 3 * Fpad * kern.ncomp * W8   # rows in, out, transpose
            + len(fam.cls_sp) * W8 * W8    # class operator stream
            + 2 * Fpad * 8 * cW            # family bucket in+out
            + plan.tgt.tree.num_boxes * cW  # child broadcast
        ) * it
    model["m2l"] = (m2l_flops, m2l_bytes)
    model["l2l"] = model["m2m"]
    model["l2p"] = (
        2.0 * nl * K * cW * rdim,
        (nl * K * cW * rdim + nl * cW + nl * K * rdim) * it,
    )
    panels, meta = plan.near_panels()
    if panels is not None and "A" in panels:
        pb = int(np.prod(panels["A"].shape)) * it
        model["near"] = (2.0 * pb / it, pb)
    return model


def _pava_nondecreasing(y):
    """Pool-adjacent-violators: least-squares monotone fit of y."""
    pools = []  # [value, weight]
    for v in y:
        pools.append([float(v), 1.0])
        while len(pools) > 1 and pools[-2][0] > pools[-1][0]:
            v1, w1 = pools.pop()
            v0, w0 = pools.pop()
            pools.append([(v0 * w0 + v1 * w1) / (w0 + w1), w0 + w1])
    out = []
    for v, w in pools:
        out.extend([v] * int(round(w)))
    return out


def _phase_fns(plan, p, aux_keys, slot_ops):
    """Ordered matvec phases as (name, fn(d, aux, sf, x), input_tag).

    input_tag: 'q' (consumes the charge vector), 'state' (consumes the
    previous phase's output).  The composition of all phases in order
    reproduces the production matvec pipeline.  Every fn takes the
    device dicts as ARGUMENTS — a closure over them would bake the
    arrays into the compiled program as constants.
    """
    cdim = getattr(plan.kernel, "charge_dim", 1)
    nl = len(plan.src.leaf_ids)
    K = plan.src.leaf_pad
    st = plan.src.tree
    dt = jnp.dtype(plan.config.dtype)
    cW = plan.kernel.ncomp * plan.kernel.width(p)

    def p2m(d, aux, sf, q):
        if slot_ops is not None:
            return plan._p2m_slots(d, aux, q, p)
        return plan._phase_p2m(d, aux, sf, q[d["s_perm"]], p)

    def l2p(d, aux, sf, L):
        if slot_ops is not None:
            return plan._l2p_slots(d, aux, L, p)
        return plan._phase_l2p(d, aux, sf, L, p)

    def near(d, aux, sf, q):
        if slot_ops is not None:
            return plan._near_pass_slots(aux["panels"], q)
        return plan._near_pass(d, aux["panels"], sf, q[d["s_perm"]])

    def p2p(d, aux, sf, q):
        nl_t = len(plan.tgt.leaf_ids)
        K_t = plan.tgt.leaf_pad
        if slot_ops is not None:
            return plan._p2p_pass(
                d, sf, sf, q, nl_t, K_t, slots=True
            )
        return plan._p2p_pass(d, sf, sf, q[d["s_perm"]], nl_t, K_t)

    fns = [
        ("p2m", p2m, "q"),
        ("m2m", lambda d, aux, sf, M: plan._phase_m2m(d, M), "state"),
        ("m2l", lambda d, aux, sf, M: plan._phase_m2l(d, M, p),
         "state"),
        ("l2l", lambda d, aux, sf, L: plan._phase_l2l(d, L), "state"),
        ("l2p", l2p, "state"),
    ]
    if "panels" in aux_keys:
        fns.append(("near", near, "q"))
    elif len(plan.p2p_src_slot):
        # point kernels: the direct P2P leaf pass (no cached panels)
        fns.append(("p2p", p2p, "q"))
    return fns


def _seconds_per_step(run, args, chain, repeats):
    """Median over ``repeats`` timed calls of a ``chain``-step scan,
    per step; the first call (compile) is not timed."""
    jax.block_until_ready(run(*args))
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        jax.block_until_ready(run(*args))
        times.append((time.perf_counter() - t0) / chain)
    return float(np.median(times))


def phase_breakdown(plan, p, q=None, chain=96, repeats=3, solo=False,
                    mv_ms_ref=None):
    """Measure the matvec phases on the current backend.

    Returns {phase: {"ms", "gflops", "gbs", "pct_f32", "pct_hbm"}} plus
    a "total" entry {"ms", "matvec_ms", "sum_ratio"} where sum_ratio =
    (sum of phases) / (independently timed production matvec) — the
    self-consistency check; trust the per-phase numbers only when it is
    within ~15% of 1.  ``mv_ms_ref`` supplies an externally measured
    production-matvec ms for that reference instead of timing one here.
    With ``solo=True`` each phase also carries "ms_solo", its time in
    an isolated scan (an upper bound: it includes launch and carry
    overheads the pipeline amortises).
    """
    dt = jnp.dtype(plan.config.dtype)
    n = plan.src.tree.num_bodies
    if q is None:
        q = np.ones(n, dtype=dt)
    sf = plan.device_fields()
    qm0 = jnp.asarray(q, dt)

    # measure the PRODUCTION layout: slot-space when the plan supports
    # it (the solver path), else the body-order phases
    slot_ops = plan.solver_ops_slots()
    if slot_ops is not None:
        aux = plan.variant_aux_slots(p)
        qm0 = slot_ops[2](qm0)  # to_slots
    else:
        aux = plan.variant_aux(p)
    d = plan.device_data(p)

    fns = _phase_fns(plan, p, set(aux.keys()), slot_ops)
    names = [nm for nm, _, _ in fns]

    def mix(x, out):
        # feed a scalar function of the phase output back into the
        # charges: forces sequential execution, costs ~nothing
        s = out
        while s.ndim > 0:
            s = s.sum(axis=-1) if s.ndim > 1 else s.sum()
        return x * (1.0 + 1e-30 * s)

    def make_prefix(k):
        """Chained scan running phases fns[0..k] per step."""

        def step_body(d_, aux_, sf_, qv):
            state = None
            out = None
            for nm, f, tag in fns[: k + 1]:
                if tag == "q":
                    r = f(d_, aux_, sf_, qv)
                    # far-field chain threads through `state`; the
                    # near field (tag 'q' after l2p) adds to out
                    if state is None:
                        state = r
                        out = r
                    else:
                        out = out + r if out.shape == r.shape else r
                else:
                    state = f(d_, aux_, sf_, state)
                    out = state
            return out

        def run_(d_, aux_, sf_, x):
            def step(x, _):
                return mix(x, step_body(d_, aux_, sf_, x)), None

            y, _ = jax.lax.scan(step, x, None, length=chain)
            return y

        return jax.jit(run_)

    cum = [
        _seconds_per_step(make_prefix(k), (d, aux, sf, qm0), chain, repeats)
        for k in range(len(fns))
    ]
    cum = _pava_nondecreasing(cum)
    per_phase = [cum[0]] + [
        cum[k] - cum[k - 1] for k in range(1, len(cum))
    ]

    # production-matvec reference the phases must sum to: externally
    # supplied when available, else an internal chain measurement
    # (solver_ops mv includes the same phases + final mask)
    if mv_ms_ref is not None:
        mv_t = mv_ms_ref / 1e3
    else:
        if slot_ops is not None:
            mv, op4p = slot_ops[0], slot_ops[1]
        else:
            mv, op4p = plan.solver_ops()

        @jax.jit
        def mv_chain(operand, x):
            def step(x, _):
                return mix(x, mv(operand, x, p)), None

            y, _ = jax.lax.scan(step, x, None, length=chain)
            return y

        mv_t = _seconds_per_step(mv_chain, (op4p(p), qm0), chain, repeats)

    # optional solo cross-check: isolated chained scans on materialised
    # phase inputs
    solo_ms = {}
    if solo:
        mats = {"q": qm0}
        state = qm0
        for nm, f, tag in fns:
            inp = mats["q"] if tag == "q" else state
            g = jax.jit(lambda d_, aux_, sf_, x, f=f: f(d_, aux_, sf_, x))
            outv = g(d, aux, sf, inp)
            if tag != "q" or nm == "p2m":
                state = outv
            mats[nm] = inp

        for nm, f, tag in fns:

            def run_(d_, aux_, sf_, x, f=f):
                def step(x, _):
                    return mix(x, f(d_, aux_, sf_, x)), None

                y, _ = jax.lax.scan(step, x, None, length=chain)
                return y

            solo_ms[nm] = 1e3 * _seconds_per_step(
                jax.jit(run_), (d, aux, sf, mats[nm]), chain, repeats
            )

    model = _flop_byte_model(plan, p)
    peaks = chip_peaks()
    floor = 15e-6  # per chained step: below this the number is noise
    #: prefix differences carry jitter between consecutive prefixes; a
    #: phase shorter than this carries no %-of-peak fields
    phase_floor = 3e-4
    out = {}
    for nm, dt_k in zip(names, per_phase):
        flops, bytes_ = model.get(nm, (0.0, 0.0))
        r = {"ms": dt_k * 1e3}
        if nm in solo_ms:
            r["ms_solo"] = solo_ms[nm]
        if dt_k < floor:
            r["below_timer_floor"] = True
            out[nm] = r
            continue
        if dt_k < phase_floor:
            # the ms is attribution-limited: report it, but no rates
            r["below_attribution_floor"] = True
            out[nm] = r
            continue
        gflops = flops / dt_k / 1e9
        gbs = bytes_ / dt_k / 1e9
        r["gflops"] = gflops
        r["gbs"] = gbs
        if peaks:
            pct_f32 = 100.0 * (flops / dt_k) / peaks.f32
            pct_hbm = 100.0 * (bytes_ / dt_k) / peaks.hbm
            if pct_f32 > 100.0 or pct_hbm > 100.0:
                # a reading past peak is self-refuting — the phase time
                # is under-attributed, not the card over-achieving
                r["unreliable"] = True
                r.pop("gflops")
                r.pop("gbs")
            else:
                r["pct_f32"] = pct_f32
                r["pct_hbm"] = pct_hbm
        out[nm] = r
    sum_ratio = (
        cum[-1] / mv_t if mv_t > floor and cum[-1] > floor else None
    )
    out["total"] = {
        "ms": cum[-1] * 1e3,
        "matvec_ms": mv_t * 1e3,
        # trust per-phase numbers only when the pipeline total agrees
        # with the production matvec; below the timer floor the ratio
        # is noise, not evidence
        "sum_ratio": sum_ratio,
        "suspect": (
            sum_ratio is None or not (0.85 <= sum_ratio <= 1.15)
        ),
    }
    return out
