"""Restarted GMRES / FGMRES with inexact-Krylov p-relaxation.

JAX re-design of examples/BEM/GMRES.hpp (:142-252 GMRES, :276-380
FGMRES): the Arnoldi vectors live on device and all heavy lineal algebra
is jnp; the tiny Hessenberg/Givens updates run on the host, which also
drives the *relaxation schedule* — before every inner matvec the
truncation order is predicted from the current residual
(SolverOptions::predict_p, ref GMRES.hpp:195-196) and passed to
``matvec(x, p)``; the FmmPlan turns each distinct p into a cheaper
compiled specialisation instead of rebuilding kernel tables.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Callable, Optional

import jax.numpy as jnp
import numpy as np

from fmm_bem_tpu.config import RelaxType, SolverConfig


@dataclasses.dataclass
class SolveInfo:
    iterations: int
    residual: float
    converged: bool
    #: (iteration, residual, p) per inner step — mirrors the reference's
    #: "it, res, fmm_req_p" print (GMRES.hpp:225)
    history: list


def _apply_plane_rotations(h, cs, sn, i):
    """Apply accumulated Givens rotations to column h (ref GMRES.hpp:82-116)."""
    for k in range(i):
        t = cs[k] * h[k] + sn[k] * h[k + 1]
        h[k + 1] = -sn[k] * h[k] + cs[k] * h[k + 1]
        h[k] = t
    return h


def _gen_rotation(dx, dy):
    if dy == 0.0:
        return 1.0, 0.0
    if abs(dy) > abs(dx):
        t = dx / dy
        sn = 1.0 / np.sqrt(1.0 + t * t)
        return t * sn, sn
    t = dy / dx
    cs = 1.0 / np.sqrt(1.0 + t * t)
    return cs, t * cs


# ----------------------------------------------------------------------
# Krylov-state checkpointing (SURVEY.md §5.4 — a subsystem the reference
# lacks; it lets long solves on shared accelerators resume).
# The whole Arnoldi state is pure arrays, so a checkpoint is one npz and
# a resumed solve replays the remaining iterations bit-identically: the
# masked Gram-Schmidt sums are exact under extra zero rows and every
# other update depends only on the saved (V, Z, H, cs, sn, s, i, x).
# ----------------------------------------------------------------------


def _save_krylov_ckpt(path, kind, **arrays):
    from fmm_bem_tpu.utils.checkpoint import save_checkpoint

    save_checkpoint(path, kind=np.bytes_(kind), **arrays)


def _load_krylov_ckpt(path, kind, n):
    """Load a Krylov checkpoint; None if absent/mismatched."""
    from fmm_bem_tpu.utils.checkpoint import load_checkpoint

    if path is None:
        return None
    d = load_checkpoint(path)
    if d is None:
        return None
    if bytes(d["kind"]) != kind.encode() or int(d["n"]) != n:
        return None
    return d


def _embed(a, shape):
    """Place ``a`` into the leading corner of zeros(shape).

    Buffer sizes are derived from ``min(restart, max_iters, n)``, so a
    checkpoint written by a run with different limits carries smaller
    (or larger) arrays than the resuming run allocates; the Arnoldi
    trajectory itself is identical — only padding differs, and padded
    zeros contribute exactly 0.0 to every masked reduction, keeping the
    resumed replay bit-identical."""
    a = np.asarray(a)
    out = np.zeros(shape, a.dtype)
    sl = tuple(slice(0, min(sa, st)) for sa, st in zip(a.shape, shape))
    out[sl] = a[sl]
    return out


def gmres(
    matvec: Callable,
    b,
    x0=None,
    config: Optional[SolverConfig] = None,
    M: Optional[Callable] = None,
    p_fixed: Optional[int] = None,
    flexible: bool = False,
    verbose: bool = False,
    checkpoint_path: Optional[str] = None,
    checkpoint_every: int = 8,
):
    """Solve A x = b with right-preconditioned restarted GMRES.

    Parameters
    ----------
    matvec : callable ``(x, p) -> A@x`` evaluated at truncation order p
        (an FmmPlan-backed operator; a dense operator may ignore p).
    M : right preconditioner callable ``(r) -> z`` (default identity).
    flexible : FGMRES — store Z = M(V) columns so a varying/nonlinear
        preconditioner is applied consistently (ref GMRES.hpp:276-380).
    p_fixed : disable relaxation and use this order for every matvec
        (the reference's ``-fixed_p`` flag, LaplaceBEM.cpp:120).
    checkpoint_path : if set, the full Krylov state is saved there every
        ``checkpoint_every`` inner iterations; a matching checkpoint at
        this path is resumed from (and the remaining iterations replay
        bit-identically).  Removed on convergence.
    """
    import jax

    cfg = config or SolverConfig()
    b = jnp.asarray(b)
    n = b.shape[0]
    x = jnp.zeros_like(b) if x0 is None else jnp.asarray(x0)
    if M is None:
        M = lambda r: r

    normb = float(jnp.linalg.norm(b))
    if normb == 0.0:
        normb = 1.0

    history = []
    total_it = 0
    resid = 1.0

    restart = min(cfg.restart, cfg.max_iters, n)

    # relaxation stall guard: inexact matvecs at an over-optimistic
    # order can plateau the Givens residual (observed on anisotropic
    # RBC geometry, results/RBC.md) — when the last STALL_WIN
    # iterations improved the residual by less than 2x, raise the
    # scheduled order.  The boost is sticky within the solve.
    relaxed = p_fixed is None and cfg.variable_p
    p_boost = 0
    STALL_WIN, STALL_FACTOR = 4, 0.5
    r_hist = []

    resume = _load_krylov_ckpt(checkpoint_path, "host", n)
    if resume is not None:
        x = jnp.asarray(resume["x"])
        total_it = int(resume["total_it"])

    def _ckpt_done():
        if checkpoint_path is not None and os.path.exists(checkpoint_path):
            os.unlink(checkpoint_path)

    # One fused device op per Arnoldi step: all modified-Gram-Schmidt
    # projections against the stored basis matrix at once (a [i, n]
    # matvec pair) — the reference's per-column dot loop
    # (GMRES.hpp:203-208) would cost one device round-trip per column.
    # The basis buffer grows by doubling instead of allocating
    # (restart+1) rows upfront: the default restart of 500 would pin
    # 4 GB at n = 1e6 f64 even for a 5-iteration solve.
    @jax.jit
    def _ortho(Vbuf, w, i):
        mask = (jnp.arange(Vbuf.shape[0]) <= i)[:, None]
        Vm = jnp.where(mask, Vbuf, 0.0)
        coeffs = Vm @ w
        w = w - coeffs @ Vm
        # one re-orthogonalisation pass for float32 robustness
        c2 = Vm @ w
        w = w - c2 @ Vm
        beta = jnp.linalg.norm(w)
        return w, coeffs + c2, beta

    while total_it < cfg.max_iters:
        if resume is not None:
            # mid-cycle resume: restore the Arnoldi state (re-padded to
            # this run's buffer shapes — see _embed)
            Vbuf = jnp.asarray(resume["V"])
            Z = (
                [jnp.asarray(zr) for zr in resume["Z"]] if flexible else []
            )
            H = _embed(resume["H"], (restart + 1, restart))
            cs = _embed(resume["cs"], (restart + 1,))
            sn = _embed(resume["sn"], (restart + 1,))
            s = _embed(resume["s"], (restart + 1,))
            i_start = int(resume["i_next"])
            resid = float(resume["resid"])
            resume = None
        else:
            # full-accuracy residual at (re)start (ref GMRES.hpp:175-182)
            r = b - matvec(x, cfg.max_p)
            beta = float(jnp.linalg.norm(r))
            resid = beta / normb
            if resid < cfg.residual:
                _ckpt_done()
                return x, SolveInfo(total_it, resid, True, history)

            cap = min(restart + 1, 33)
            Vbuf = jnp.zeros((cap, n), b.dtype).at[0].set(r / beta)
            Z = []
            H = np.zeros((restart + 1, restart))
            cs = np.zeros(restart + 1)
            sn = np.zeros(restart + 1)
            s = np.zeros(restart + 1)
            s[0] = beta
            i_start = 0

        i = i_start - 1
        for i in range(i_start, restart):
            if total_it >= cfg.max_iters:
                break
            if i + 1 >= Vbuf.shape[0]:  # grow the basis by doubling
                grow = min(Vbuf.shape[0], restart + 1 - Vbuf.shape[0])
                Vbuf = jnp.concatenate(
                    [Vbuf, jnp.zeros((grow, n), b.dtype)]
                )
            # ---- relaxation: predict p from current residual; the
            # stall boost routes through schedule_p so it lands on a
            # configured tier (no unplanned compile mid-solve)
            p = cfg.schedule_p(resid, p_fixed, boost=p_boost)
            z = M(Vbuf[i])
            if flexible:
                Z.append(z)
            w = matvec(z, p)
            w, coeffs, bnorm = _ortho(Vbuf, w, i)
            H[: i + 1, i] = np.asarray(coeffs)[: i + 1]
            H[i + 1, i] = float(bnorm)
            if H[i + 1, i] > 1e-300:
                Vbuf = Vbuf.at[i + 1].set(w / H[i + 1, i])
            else:
                Vbuf = Vbuf.at[i + 1].set(w)

            # Givens update (ref GMRES.hpp:218-220)
            h = _apply_plane_rotations(H[: i + 2, i].copy(), cs, sn, i)
            cs[i], sn[i] = _gen_rotation(h[i], h[i + 1])
            h[i], h[i + 1] = cs[i] * h[i] + sn[i] * h[i + 1], 0.0
            H[: i + 2, i] = h
            s[i + 1] = -sn[i] * s[i]
            s[i] = cs[i] * s[i]
            resid = abs(s[i + 1]) / normb
            total_it += 1
            history.append((total_it, resid, p))
            if relaxed and resid >= cfg.residual:
                r_hist.append(resid)
                if (
                    len(r_hist) > STALL_WIN
                    and resid > STALL_FACTOR * r_hist[-1 - STALL_WIN]
                    and p < cfg.max_p
                ):
                    p_boost += 2
                    r_hist.clear()
            if verbose:
                print(f"it: {total_it:4d}  res: {resid:.3e}  fmm_req_p: {p}")
            if checkpoint_path is not None and (
                total_it % checkpoint_every == 0
            ):
                _save_krylov_ckpt(
                    checkpoint_path,
                    "host",
                    n=n,
                    x=np.asarray(x),
                    V=np.asarray(Vbuf),
                    Z=np.stack([np.asarray(z) for z in Z])
                    if Z
                    else np.zeros((0, n), np.asarray(b).dtype),
                    H=H,
                    cs=cs,
                    sn=sn,
                    s=s,
                    i_next=i + 1,
                    total_it=total_it,
                    resid=resid,
                )
            if resid < cfg.residual:
                break

        # back-substitution and update (ref GMRES.hpp:230-243)
        m = i + 1
        if m > 0:
            y = np.zeros(m)
            for k in range(m - 1, -1, -1):
                y[k] = (s[k] - H[k, k + 1 : m] @ y[k + 1 : m]) / H[k, k]
            if flexible:
                for k in range(m):
                    x = x + y[k] * Z[k]
            else:
                dx = jnp.asarray(y, b.dtype) @ Vbuf[:m]
                x = x + M(dx)
        if resid < cfg.residual:
            _ckpt_done()
            return x, SolveInfo(total_it, resid, True, history)

    return x, SolveInfo(total_it, resid, False, history)


def fgmres(matvec, b, **kw):
    """Flexible GMRES (ref GMRES.hpp:276-380)."""
    return gmres(matvec, b, flexible=True, **kw)


# ----------------------------------------------------------------------
# device-resident GMRES
# ----------------------------------------------------------------------
#
# The host-loop solver above pays several host<->device round trips per
# Arnoldi iteration (matvec dispatch, Gram-Schmidt, a blocking Hessenberg
# transfer), each of which leaves the device idle.  ``gmres_device`` instead
# runs whole blocks of iterations inside ONE jitted lax.while_loop: the
# Givens rotations, Hessenberg update and residual recurrence all live on
# device, exactly the XLA-native reshaping of ref GMRES.hpp:142-252.
#
# Relaxation (the paper's inexact-Krylov schedule) needs a *static* p per
# compiled matvec, so the inner loop is split into p-tiers: the while
# loop at order p keeps iterating until the residual crosses the
# threshold where ``predict_p`` would choose a smaller order (the
# schedule is monotone in the residual), then control returns to the
# host, which starts the next tier continuing the SAME Krylov basis.
# This evaluates the reference's per-iteration ``K.set_p(predict_p(res))``
# (GMRES.hpp:195-196) with one host sync per p *change* instead of per
# iteration.


class DeviceGmresContext:
    """Compiled-executable cache reusable across solves (the array-era
    analogue of the reference's GMRESContext, GMRES.hpp:36-63)."""

    def __init__(self):
        #: compiled tier executables keyed by (p, basis capacity)
        self.tier_fns = {}
        #: compiled back-substitution keyed by basis capacity
        self.finish_fn = {}
        self.resid_fn = None


def _device_predict_p(resid, cfg, boost=0):
    """jnp replica of SolverConfig.schedule_p (SolverOptions.hpp:25-38),
    including the calibrated eps(p) = c * gamma**p model when set.

    Order of operations mirrors the host exactly — floor at p_min,
    add the stall boost, clamp, THEN quantise to p_tiers — so the
    tier-exit condition agrees with the host schedule (a mismatch
    would spin a tier or mint an unplanned tier compile)."""
    import math

    eps = jnp.minimum(resid, 1.0)
    if cfg.relax_type is RelaxType.BOURAS:
        nu = jnp.minimum(cfg.residual / eps, 1.0)
    else:
        nu = eps
    nu = jnp.maximum(nu, 1e-300)
    if cfg.eps_c is not None and cfg.eps_gamma is not None:
        raw = jnp.ceil(
            jnp.log(nu / cfg.eps_c) / math.log(cfg.eps_gamma)
        )
        # never extrapolate the calibrated fit below its probed range
        lo = float(cfg.eps_p_lo or 1)
        p = jnp.maximum(jnp.where(nu >= cfg.eps_c, 1.0, raw), lo)
    else:
        raw = jnp.ceil(-jnp.log2(nu))
        p = jnp.where(nu >= 1.0, 1.0, raw)
    # floor at p_min to mirror SolverConfig.schedule_p (the reference's
    # Stokes relaxation floor, GMRES_Stokes.hpp:229)
    p = jnp.clip(p, max(1, cfg.p_min), cfg.max_p).astype(jnp.int32)
    p = jnp.minimum(p + boost, cfg.max_p)
    if cfg.p_tiers:
        # quantise UP to the configured tiers, matching
        # SolverConfig.quantize_p
        q = jnp.asarray(min(max(cfg.p_tiers), cfg.max_p), jnp.int32)
        for t in sorted(cfg.p_tiers, reverse=True):
            q = jnp.where(p <= t, min(t, cfg.max_p), q)
        p = q
    return p


def gmres_device(
    matvec: Callable,
    b,
    operand_for_p: Optional[Callable] = None,
    x0=None,
    config: Optional[SolverConfig] = None,
    M: Optional[Callable] = None,
    p_fixed: Optional[int] = None,
    flexible: bool = False,
    verbose: bool = False,
    context: Optional[DeviceGmresContext] = None,
    checkpoint_path: Optional[str] = None,
    checkpoint_every: int = 16,
):
    """Device-resident restarted GMRES/FGMRES with p-relaxation.

    Parameters
    ----------
    matvec : pure traceable ``(operand, x, p) -> A@x`` with p static.
    operand_for_p : host callable ``p -> operand`` pytree (plan device
        data is sliced per order); default returns ``None``.
    M : pure traceable right preconditioner ``z = M(r)`` (default
        identity).  Host-loop preconditioners (inner solves) need the
        host ``gmres``.
    checkpoint_path : if set, the Krylov state is pulled to host and
        saved there at tier exits; ``it_left`` per tier call is capped
        at ``checkpoint_every`` so a checkpoint lands at least every
        that many iterations.  A matching checkpoint is resumed from
        (bit-identical replay).  Removed on convergence.
    """
    import jax

    cfg = config or SolverConfig()
    ctx = context if context is not None else DeviceGmresContext()
    b = jnp.asarray(b)
    n = b.shape[0]
    dt = b.dtype
    x = jnp.zeros_like(b) if x0 is None else jnp.asarray(x0, dt)
    if M is None:
        M = lambda r: r
    if operand_for_p is None:
        operand_for_p = lambda p: None

    restart = int(min(cfg.restart, cfg.max_iters, n))
    relaxed = p_fixed is None and cfg.variable_p
    # stall guard (see host gmres): raise the order when a whole tier
    # block improves the residual by less than 2x
    p_boost = 0
    min_idx_h = 0  # fused-cascade floor tier (sticky, like p_boost)
    STALL_WIN, STALL_FACTOR = 4, 0.5
    tiny = jnp.asarray(np.finfo(np.dtype(dt)).tiny * 1e3, dt)
    # fused tier cascade (see make_fused): active tiers, ascending
    fused_tiers = tuple(
        sorted({min(t, cfg.max_p) for t in (cfg.p_tiers or ())})
    )
    use_fused = relaxed and len(fused_tiers) >= 1

    def make_arnoldi(cap):
        """One Arnoldi iteration given the new Krylov vector w: fused
        modified Gram-Schmidt (+ one re-orthogonalisation pass) against
        the cap-row basis, then the Givens update of column i."""

        def arnoldi(w, V, H, cs, sn, s, i, normb):
            mask = (jnp.arange(cap) <= i)[:, None]
            Vm = jnp.where(mask, V, jnp.zeros_like(V))
            c1 = Vm @ w
            w = w - c1 @ Vm
            c2 = Vm @ w
            w = w - c2 @ Vm
            coeffs = c1 + c2
            hn = jnp.linalg.norm(w)
            V2 = jax.lax.dynamic_update_slice_in_dim(
                V, (w / jnp.maximum(hn, tiny))[None], i + 1, 0
            )
            # H column is full-restart length; the cap-row basis
            # contributes its coefficients to the first cap entries
            cfull = jnp.zeros(restart + 1, dt).at[: cap].set(coeffs)
            col = jnp.where(jnp.arange(restart + 1) <= i, cfull, 0.0)
            col = col.at[i + 1].set(hn)

            # apply the accumulated Givens rotations to the new column
            def rot(k, h):
                hk = h[k]
                hk1 = h[k + 1]
                t = cs[k] * hk + sn[k] * hk1
                h = h.at[k + 1].set(-sn[k] * hk + cs[k] * hk1)
                return h.at[k].set(t)

            col = jax.lax.fori_loop(0, i, rot, col)
            dx_, dy_ = col[i], col[i + 1]
            r_ = jnp.sqrt(dx_ * dx_ + dy_ * dy_)
            ci = jnp.where(r_ > 0, dx_ / jnp.maximum(r_, tiny), 1.0)
            si = jnp.where(r_ > 0, dy_ / jnp.maximum(r_, tiny), 0.0)
            col = col.at[i].set(r_).at[i + 1].set(0.0)
            cs2 = cs.at[i].set(ci)
            sn2 = sn.at[i].set(si)
            H2 = jax.lax.dynamic_update_slice(
                H, col[:, None], (jnp.zeros_like(i), i)
            )
            s_i = s[i]
            s2 = s.at[i + 1].set(-si * s_i).at[i].set(ci * s_i)
            resid = jnp.abs(s2[i + 1]) / normb
            return V2, H2, cs2, sn2, s2, resid

        return arnoldi

    def make_fused(cap):
        """The WHOLE relaxed tier cascade in one executable: the inner
        while_loop picks the active tier per iteration with lax.switch
        over per-tier matvecs, runs the Bouras/Simoncini schedule, the
        stall guard and tier demotion fully in-loop, and records the
        per-iteration tier for the (it, res, p) history.

        Rationale: with per-p executables the solver pays one
        host<->device round trip per tier CHANGE.  One fused call per
        restart cycle reduces the relaxed solve to the same dispatch
        count as fixed-p while keeping the paper's inexact schedule
        (ref GMRES.hpp:195-225 + SolverOptions.hpp:25-38).
        """
        nt = len(fused_tiers)
        tiers_arr = jnp.asarray(fused_tiers, jnp.int32)
        raw_cfg = dataclasses.replace(cfg, p_tiers=None)
        stop_tol = cfg.residual
        arnoldi = make_arnoldi(cap)

        def fused(
            operands, V, Z, H, cs, sn, s, i, resid, it_left, normb,
            min_idx0,
        ):
            r_buf0 = jnp.full((STALL_WIN,), jnp.inf, dt)
            hist0 = jnp.full((restart,), -1, jnp.int32)

            def tier_idx(resid, min_idx):
                p_raw = _device_predict_p(resid, raw_cfg, 0)
                idx = jnp.searchsorted(tiers_arr, p_raw, side="left")
                idx = jnp.clip(idx, 0, nt - 1)
                return jnp.maximum(idx, min_idx)

            def cond(st):
                (V, Z, H, cs, sn, s, i, resid, it_left, r_buf, k,
                 min_idx, hist) = st
                return (
                    (i < cap - 1) & (it_left > 0) & (resid >= stop_tol)
                )

            def body(st):
                (V, Z, H, cs, sn, s, i, resid, it_left, r_buf, k,
                 min_idx, hist) = st
                idx = tier_idx(resid, min_idx)
                v = jax.lax.dynamic_slice_in_dim(V, i, 1)[0]
                z = M(v)
                if flexible:
                    Z = jax.lax.dynamic_update_slice_in_dim(
                        Z, z[None], i, 0
                    )
                branches = [
                    (lambda z, j=j: matvec(
                        operands[j], z, fused_tiers[j]
                    ))
                    for j in range(nt)
                ]
                w = jax.lax.switch(idx, branches, z)
                V2, H2, cs2, sn2, s2, resid = arnoldi(
                    w, V, H, cs, sn, s, i, normb
                )
                hist = hist.at[i].set(idx)
                # in-loop stall guard: when the last STALL_WIN
                # iterations improved the residual by less than 2x,
                # demote to the next tier up (sticky) and restart the
                # window
                old = r_buf[k % STALL_WIN]
                stalled = (k >= STALL_WIN) & (
                    resid > STALL_FACTOR * old
                ) & (resid >= stop_tol)
                min_idx = jnp.where(
                    stalled, jnp.minimum(min_idx + 1, nt - 1), min_idx
                )
                r_buf = jnp.where(
                    stalled,
                    jnp.full((STALL_WIN,), jnp.inf, dt),
                    r_buf.at[k % STALL_WIN].set(resid),
                )
                k = jnp.where(stalled, 0, k + 1)
                return (V2, Z, H2, cs2, sn2, s2, i + 1, resid,
                        it_left - 1, r_buf, k, min_idx, hist)

            st = jax.lax.while_loop(
                cond, body,
                (V, Z, H, cs, sn, s, i, resid, it_left, r_buf0,
                 jnp.asarray(0, jnp.int32), min_idx0, hist0),
            )
            return st[:8] + (st[11], st[12])

        return jax.jit(fused)

    def make_tier(p, cap):
        # ``cap`` is the current Krylov-basis capacity (V rows).  The
        # basis grows by doubling exactly like the host loop — the
        # default restart of 500 would otherwise pin a [501, n] basis
        # upfront (~2 GB f32 at n = 1e6) even for a 5-iteration solve.
        # Each (p, cap) pair is a separately compiled executable; the
        # doubling schedule bounds the number of compiles at log2.
        stop_tol = cfg.residual

        def tier(
            operand, V, Z, H, cs, sn, s, i, resid, it_left, normb, boost
        ):
            # the stall guard runs INSIDE the loop: r_buf holds the
            # residuals of the last STALL_WIN iterations, and the loop
            # exits with stalled=True when a window improves by less
            # than 2x.  In-loop detection lets a tier run to its
            # schedule boundary in ONE device call instead of returning
            # to the host every few iterations.
            r_buf0 = jnp.full((STALL_WIN,), jnp.inf, dt)
            k0 = jnp.asarray(0, jnp.int32)
            stalled0 = jnp.asarray(False)

            def cond(st):
                (V, Z, H, cs, sn, s, i, resid, it_left, r_buf, k,
                 stalled) = st
                ok = (i < cap - 1) & (it_left > 0) & (resid >= stop_tol)
                if relaxed:
                    # leave when the schedule (plus any stall boost)
                    # wants a smaller order, or on a detected stall
                    ok = ok & (~stalled) & (
                        _device_predict_p(resid, cfg, boost) >= p
                    )
                return ok

            arnoldi = make_arnoldi(cap)

            def body(st):
                (V, Z, H, cs, sn, s, i, resid, it_left, r_buf, k,
                 stalled) = st
                v = jax.lax.dynamic_slice_in_dim(V, i, 1)[0]
                z = M(v)
                if flexible:
                    Z = jax.lax.dynamic_update_slice_in_dim(
                        Z, z[None], i, 0
                    )
                w = matvec(operand, z, p)
                V2, H2, cs2, sn2, s2, resid = arnoldi(
                    w, V, H, cs, sn, s, i, normb
                )
                if relaxed:
                    old = r_buf[k % STALL_WIN]
                    stalled = (k >= STALL_WIN) & (
                        resid > STALL_FACTOR * old
                    ) & (resid >= stop_tol)
                    r_buf = r_buf.at[k % STALL_WIN].set(resid)
                return (V2, Z, H2, cs2, sn2, s2, i + 1, resid,
                        it_left - 1, r_buf, k + 1, stalled)

            st = jax.lax.while_loop(
                cond, body,
                (V, Z, H, cs, sn, s, i, resid, it_left, r_buf0, k0,
                 stalled0),
            )
            return st[:8] + (st[11],)

        return jax.jit(tier)

    if not isinstance(ctx.finish_fn, dict):
        ctx.finish_fn = {}

    def get_finish(cap):
        if cap not in ctx.finish_fn:

            def finish(V, Z, H, s, m, x):
                ar = jnp.arange(restart)
                rhs = jnp.where(ar < m, s[:restart], 0.0)
                Hm = H[:restart, :restart] + jnp.diag(
                    (ar >= m).astype(dt)
                )
                y = jax.scipy.linalg.solve_triangular(
                    Hm, rhs, lower=False
                )
                # y is zero beyond m and m < cap, so the cap-row basis
                # carries the whole correction
                k = min(cap, restart)
                if flexible:
                    dx = y[: Z.shape[0]] @ Z
                else:
                    dx = M(y[:k] @ V[:k])
                return x + dx

            ctx.finish_fn[cap] = jax.jit(finish)
        return ctx.finish_fn[cap]

    if ctx.resid_fn is None:

        def resid0(operand, x, b):
            r = b - matvec(operand, x, cfg.max_p)
            return r, jnp.linalg.norm(r)

        ctx.resid_fn = jax.jit(resid0)

    normb = float(jnp.linalg.norm(b))
    if normb == 0.0:
        normb = 1.0
    normb_arr = jnp.asarray(normb, dt)

    history = []
    total_it = 0
    resid = 1.0
    full_operand = operand_for_p(cfg.max_p)

    resume = _load_krylov_ckpt(checkpoint_path, "device", n)
    if resume is not None:
        x = jnp.asarray(resume["x"])
        total_it = int(resume["total_it"])

    def _ckpt_done():
        if checkpoint_path is not None and os.path.exists(checkpoint_path):
            os.unlink(checkpoint_path)

    while total_it < cfg.max_iters:
        if resume is not None:
            # resume at the checkpoint's basis capacity (>= i+2 by
            # construction: the state was saved after writing row i+1)
            cap = max(int(np.asarray(resume["V"]).shape[0]),
                      int(resume["i"]) + 2)
            V = jnp.asarray(_embed(resume["V"], (cap, n)))
            Z = jnp.asarray(
                _embed(resume["Z"], (cap if flexible else 1, n))
            )
            H = jnp.asarray(_embed(resume["H"], (restart + 1, restart)))
            cs = jnp.asarray(_embed(resume["cs"], (restart + 1,)))
            sn = jnp.asarray(_embed(resume["sn"], (restart + 1,)))
            s = jnp.asarray(_embed(resume["s"], (restart + 1,)))
            i = jnp.asarray(int(resume["i"]), jnp.int32)
            i_h = int(resume["i"])
            resid = float(resume["resid"])
            resid_dev = jnp.asarray(resid, dt)
            resume = None
        else:
            r, beta_dev = ctx.resid_fn(full_operand, x, b)
            beta = float(beta_dev)
            resid = beta / normb
            if resid < cfg.residual:
                _ckpt_done()
                return x, SolveInfo(total_it, resid, True, history)

            cap = min(restart + 1, 33)
            V = jnp.zeros((cap, n), dt).at[0].set(r / beta)
            Z = jnp.zeros((cap if flexible else 1, n), dt)
            H = jnp.zeros((restart + 1, restart), dt)
            cs = jnp.zeros(restart + 1, dt)
            sn = jnp.zeros(restart + 1, dt)
            s = jnp.zeros(restart + 1, dt).at[0].set(beta)
            i = jnp.asarray(0, jnp.int32)
            i_h = 0
            resid_dev = jnp.asarray(resid, dt)

        while True:
            block = cfg.max_iters - total_it
            if checkpoint_path is not None:
                block = min(block, checkpoint_every)
            it_left = jnp.asarray(block, jnp.int32)
            if use_fused:
                # one call runs the whole tier cascade (see make_fused)
                key = ("fused", cap)
                if key not in ctx.tier_fns:
                    ctx.tier_fns[key] = make_fused(cap)
                if not hasattr(ctx, "_fused_operands"):
                    ctx._fused_operands = tuple(
                        operand_for_p(t) for t in fused_tiers
                    )
                (V, Z, H, cs, sn, s, i_new, resid_dev, min_idx_dev,
                 hist_dev) = ctx.tier_fns[key](
                    ctx._fused_operands, V, Z, H, cs, sn, s, i,
                    resid_dev, it_left, normb_arr,
                    jnp.asarray(min_idx_h, jnp.int32),
                )
                stalled_dev = False  # demotion handled in-loop
                p = None
                # ONE batched device->host transfer for the block's
                # scalars and history: each separate int() or
                # np.asarray() would be its own host sync
                resid_prev = resid
                i_new_h, sn_host, hist_h_full, resid, min_idx_h = (
                    jax.device_get(
                        (i_new, sn, hist_dev, resid_dev, min_idx_dev)
                    )
                )
                i_new_h = int(i_new_h)
                resid = float(resid)
                min_idx_h = int(min_idx_h)
            else:
                p = cfg.schedule_p(resid, p_fixed, boost=p_boost)
                if (p, cap) not in ctx.tier_fns:
                    ctx.tier_fns[(p, cap)] = make_tier(p, cap)
                st = ctx.tier_fns[(p, cap)](
                    operand_for_p(p), V, Z, H, cs, sn, s, i, resid_dev,
                    it_left, normb_arr, jnp.asarray(p_boost, jnp.int32),
                )
                (V, Z, H, cs, sn, s, i_new, resid_dev, stalled_dev) = st
                resid_prev = resid
                i_new_h, sn_host, resid, stalled_dev = jax.device_get(
                    (i_new, sn, resid_dev, stalled_dev)
                )
                i_new_h = int(i_new_h)
                resid = float(resid)
            i_old_h = i_h
            steps = i_new_h - i_old_h
            # per-iteration history from the rotation sines:
            # |s_{k+1}| = |sn_k| * |s_k|, seeded by the residual numerator
            # at tier entry (mirrors the reference's per-iteration print,
            # GMRES.hpp:225)
            sn_h = sn_host[i_old_h:i_new_h]
            if use_fused:
                hist_h = hist_h_full[i_old_h:i_new_h]
                p_of = [
                    fused_tiers[j] if 0 <= j < len(fused_tiers) else -1
                    for j in hist_h
                ]
            run = resid_prev * normb
            for k, snk in enumerate(sn_h):
                run *= abs(snk)
                history.append((
                    total_it + k + 1, run / normb,
                    p_of[k] if use_fused else p,
                ))
            total_it += steps
            i = i_new
            i_h = i_new_h
            if (
                not use_fused
                and relaxed
                and bool(stalled_dev)
                and resid >= cfg.residual
                and p is not None
                and p < cfg.max_p
            ):
                p_boost += 2
            if use_fused and steps:
                p = p_of[-1]
            if verbose and steps:
                print(
                    f"it: {total_it:4d}  res: {resid:.3e}  fmm_req_p: {p}"
                )
            if checkpoint_path is not None and steps:
                _save_krylov_ckpt(
                    checkpoint_path,
                    "device",
                    n=n,
                    x=np.asarray(x),
                    V=np.asarray(V),
                    Z=np.asarray(Z),
                    H=np.asarray(H),
                    cs=np.asarray(cs),
                    sn=np.asarray(sn),
                    s=np.asarray(s),
                    i=i_new_h,
                    total_it=total_it,
                    resid=resid,
                )
            if resid < cfg.residual or total_it >= cfg.max_iters:
                break
            if i_h >= cap - 1:
                if cap >= restart + 1:
                    break
                # grow the basis by doubling and continue the SAME
                # Krylov cycle (host-loop parity, gmres:225-229)
                new_cap = min(2 * cap, restart + 1)
                V = jnp.concatenate(
                    [V, jnp.zeros((new_cap - cap, n), dt)]
                )
                if flexible:
                    Z = jnp.concatenate(
                        [Z, jnp.zeros((new_cap - cap, n), dt)]
                    )
                cap = new_cap
                continue
            if steps == 0:
                break

        x = get_finish(cap)(V, Z, H, s, i, x)
        if resid < cfg.residual:
            # trust-but-verify: true residual at full p on the next
            # outer-loop pass confirms convergence before returning
            r, beta_dev = ctx.resid_fn(full_operand, x, b)
            resid = float(beta_dev) / normb
            if resid < cfg.residual:
                _ckpt_done()
                return x, SolveInfo(total_it, resid, True, history)
            # the Givens estimate passed but the true residual did not:
            # direct evidence the inexact-matvec schedule was too
            # optimistic for this system — raise the order for the
            # restarted cycle (sticky, like the stall boost)
            if relaxed and p_boost < cfg.max_p:
                p_boost += 2
            if use_fused:
                min_idx_h = min(min_idx_h + 1, len(fused_tiers) - 1)

    return x, SolveInfo(total_it, resid, False, history)


def fgmres_device(matvec, b, **kw):
    """Flexible device-resident GMRES."""
    return gmres_device(matvec, b, flexible=True, **kw)
