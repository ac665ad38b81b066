"""Stokes point kernels: stokeslet (single layer) and stresslet
(double layer) velocities.

JAX counterpart of kernel/StokesSpherical.hpp — the Tornberg &
Greengard decomposition: a Stokes velocity field is assembled from FOUR
harmonic (Laplace) expansions, components 0-2 carrying the force/charge
vector and component 3 carrying f.x (ref P2M :123-146).  Evaluation
combines the four scalar potentials and their gradients (ref M2P
:207-291):

    u = scale * ( phi_{0..2} + grad phi_3 - sum_k t_k grad phi_k )

with scale = 1 (stokeslet) or 1/6 (stresslet) and t the *global* target
coordinates.  All gradients come from jax AD of the scalar potential
evaluations — no hand-coded YnmTheta/sph2cart chains.

M2M/M2L/L2L act componentwise with the *same* Laplace translation
matrices (ref :190-196,293-307), so the executor just carries ncomp=4.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from fmm_bem_tpu.kernels import harmonics as hm
from fmm_bem_tpu.kernels.laplace import (
    eval_regular,
    eval_singular,
    im_part,
    re_part,
    to_interleaved_ri,
)


def _phys_potentials(E, yr, yi, w):
    """Re(sum w * E * Y) for each of the 4 components: E [4, W]
    interleaved, (yr, yi) [T] real pair -> [4]."""
    return jnp.sum(w * (re_part(E) * yr - im_part(E) * yi), axis=-1)


def tornberg_velocity(E, d_norm, inv_sigma, t_global, p, singular, scale):
    """Velocity from a 4-component harmonic expansion set at one target.

    E [4, W] interleaved expansions (multipole if ``singular`` else
    local), d_norm normalised offset, t_global the target's global
    coordinates (the formulation's explicit x_target dependence).
    """
    w = jnp.asarray(hm.term_weights(p), dtype=E.dtype)

    def phis(d):
        yr, yi = eval_singular(d, p) if singular else eval_regular(d, p)
        ph = _phys_potentials(E, yr, yi, w)
        return ph * inv_sigma if singular else ph

    ph = phis(d_norm)
    jac = jax.jacfwd(phis)(d_norm) * inv_sigma  # [4, 3] d/d t_global
    u = ph[:3] + jac[3] - (t_global[0] * jac[0] + t_global[1] * jac[1] + t_global[2] * jac[2])
    return scale * u


class StokesKernel:
    """Stokeslet point kernel: u_i = sum_s (r^2 d_ij + dx_i dx_j)/r^3 f_j
    (ref StokesSpherical.hpp operator() :67-84)."""

    name = "stokes"
    ncomp = 4
    charge_dim = 3
    result_dim = 3
    eps2 = 1e-8
    #: overall evaluation scale (1 stokeslet, 1/6 stresslet)
    scale = 1.0

    scale_invariant = True

    # ----- host matrices: componentwise Laplace -----
    def width(self, p):
        return hm.real_width(p)

    def m2m_matrix(self, dr, sigma_src, sigma_tgt, p):
        return hm.m2m_matrix(dr, sigma_src, sigma_tgt, p)

    def m2l_matrix(self, dr, sigma_src, sigma_tgt, p):
        return hm.m2l_matrix(dr, sigma_src, sigma_tgt, p)

    def l2l_matrix(self, dr, sigma_src, sigma_tgt, p):
        return hm.l2l_matrix(dr, sigma_src, sigma_tgt, p)

    def m2l_pair_scale(self, sigma_src):
        return 1.0 / sigma_src

    # ----- device ops -----
    def p2m(self, fields, charges, d_norm, inv_sigma, p):
        """4 harmonic moment sets: f_i and f.x_global (ref :123-146)."""
        del inv_sigma
        yr, yi = eval_regular(d_norm, p)  # [N, T]
        x = fields["xyz"]
        fdotx = jnp.sum(charges * x, axis=-1)
        comps = jnp.stack(
            [charges[:, 0], charges[:, 1], charges[:, 2], fdotx], axis=1
        )  # [N, 4]
        # conj(R): negate the imaginary plane
        return to_interleaved_ri(
            comps[:, :, None] * yr[:, None, :],
            -comps[:, :, None] * yi[:, None, :],
        )

    def l2p(self, fields, L, d_norm, inv_sigma, p):
        t = fields["xyz"]

        def one(Lb, d, isig, tg):
            return tornberg_velocity(Lb, d, isig, tg, p, False, self.scale)

        return jax.vmap(one)(L, d_norm, inv_sigma, t)

    def m2p(self, fields, M, d_norm, inv_sigma, p):
        t = fields["xyz"]

        def one(Mb, d, isig, tg):
            return tornberg_velocity(Mb, d, isig, tg, p, True, self.scale)

        return jax.vmap(one)(M, d_norm, inv_sigma, t)

    def p2p_block(self, tgt_fields, src_fields, charges, src_mask):
        del src_mask
        return self.p2p(tgt_fields["xyz"], src_fields["xyz"], charges)

    def p2p(self, tgt_xyz, src_xyz, charges):
        dist = src_xyz[None, :, :] - tgt_xyz[:, None, :]
        r2 = jnp.sum(dist * dist, axis=-1)
        inv_r2 = jnp.where(r2 < self.eps2, 0.0, 1.0 / jnp.maximum(r2, self.eps2))
        inv_r3 = inv_r2 * jnp.sqrt(inv_r2)
        fdotd = jnp.einsum("tsd,sd->ts", dist, charges)
        u = inv_r3[..., None] * (
            r2[..., None] * charges[None, :, :] + fdotd[..., None] * dist
        )
        return jnp.sum(u, axis=1)

    def direct(self, tgt_xyz, src_xyz, charges, chunk=2048):
        tgt_xyz = jnp.asarray(tgt_xyz)
        outs = []
        for i in range(0, tgt_xyz.shape[0], chunk):
            outs.append(self.p2p(tgt_xyz[i : i + chunk], src_xyz, charges))
        return jnp.concatenate(outs, axis=0)


class StressletKernel(StokesKernel):
    """Stresslet (double-layer) variant: charge = {g, n} 6-vector
    (ref #ifdef STRESSLET, StokesSpherical.hpp:20-26,84-117,147-189)."""

    name = "stresslet"
    charge_dim = 6
    scale = 1.0 / 6.0
    #: P2M mixes g and n components (g_i n_j products) — BILINEAR in
    #: the packed 6-vector, so the executor's unit-charge linear-table
    #: shortcut does not apply
    linear_p2m = False

    def p2m(self, fields, charges, d_norm, inv_sigma, p):
        """Dipole moments: M_i += rdotn g_i + rdotg n_i, M_3 += rdotn
        (x.g) + rdotg (n.x), with rdot* = (grad conj R).v (ref
        :147-189); the 1/sigma chain-rule factor maps normalised
        coordinates to physical gradients."""
        g = charges[:, :3]
        nv = charges[:, 3:]
        x = fields["xyz"]

        _, (dnr, dni) = jax.jvp(
            lambda z: eval_regular(z, p),
            (d_norm,),
            (jnp.broadcast_to(nv, d_norm.shape),),
        )
        _, (dgr, dgi) = jax.jvp(
            lambda z: eval_regular(z, p),
            (d_norm,),
            (jnp.broadcast_to(g, d_norm.shape),),
        )
        # rdot* = (grad conj R).v : conj = negate im plane
        rnr = dnr * inv_sigma[:, None]
        rni = -dni * inv_sigma[:, None]
        rgr = dgr * inv_sigma[:, None]
        rgi = -dgi * inv_sigma[:, None]
        xdotg = jnp.sum(x * g, axis=-1)[:, None]
        ndotx = jnp.sum(nv * x, axis=-1)[:, None]

        coeff_n = jnp.stack([g[:, 0:1], g[:, 1:2], g[:, 2:3], xdotg], axis=1)
        coeff_g = jnp.stack([nv[:, 0:1], nv[:, 1:2], nv[:, 2:3], ndotx], axis=1)
        mr = rnr[:, None, :] * coeff_n + rgr[:, None, :] * coeff_g
        mi = rni[:, None, :] * coeff_n + rgi[:, None, :] * coeff_g
        return to_interleaved_ri(mr, mi)

    def p2p(self, tgt_xyz, src_xyz, charges):
        """u_i = (dx.n)/r^5 * dx_i (dx.g), dx = t - s (ref P2P :86-117)."""
        g = charges[:, :3]
        nv = charges[:, 3:]
        dist = tgt_xyz[:, None, :] - src_xyz[None, :, :]
        r2 = jnp.sum(dist * dist, axis=-1)
        inv_r2 = jnp.where(r2 < self.eps2, 0.0, 1.0 / jnp.maximum(r2, self.eps2))
        H = jnp.sqrt(inv_r2) * inv_r2 * inv_r2  # 1/r^5
        dxdotn = jnp.einsum("tsd,sd->ts", dist, nv)
        dxdotg = jnp.einsum("tsd,sd->ts", dist, g)
        u = (H * dxdotn * dxdotg)[..., None] * dist
        return jnp.sum(u, axis=1)
