"""Laplace point kernel: K(t,s) = 1/|s-t|, force (s-t)/|s-t|^3.

JAX counterpart of kernel/LaplaceSpherical.hpp.  Device-side
operators are batched jnp functions over bodies; translation matrices
come from :mod:`fmm_bem_tpu.kernels.harmonics`.  Forces are obtained by
automatic differentiation of the (scalar) potential accumulated from the
expansion — replacing the reference's hand-derived YnmTheta/sph2cart
machinery (LaplaceSpherical.hpp:340-368,422-450,455-561) with
``jax.grad``, which is both simpler and exactly consistent with the
potential.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from fmm_bem_tpu.kernels import harmonics as hm


def _complex_dtype(dtype):
    return jnp.complex64 if jnp.dtype(dtype) == jnp.float32 else jnp.complex128


def eval_regular(d, p):
    """Regular solid harmonics R_n^m(d), m >= 0, flat (n,m) index.

    Batched over leading dims of ``d`` [..., 3]; returns a REAL pair
    (re [..., T], im [..., T]) — real arrays throughout keep every
    accelerator path and the real translation matrices in one dtype,
    so the Cartesian two-term recurrence (no trig, no
    sin(theta) division — cf. the reference's polar recurrence,
    LaplaceSpherical.hpp:455-488) runs on explicit (re, im) planes.
    """
    x, yc, z = d[..., 0], d[..., 1], d[..., 2]
    rho2 = x * x + yc * yc + z * z
    T = hm.num_terms(p)
    re = [None] * T
    im = [None] * T
    br = jnp.ones_like(x)
    bi = jnp.zeros_like(x)
    for m in range(p):
        if m > 0:
            c = -(2 * m - 1)
            br, bi = c * (br * x - bi * yc), c * (br * yc + bi * x)
        pr2 = pi2 = None
        pr1, pi1 = br, bi
        for n in range(m, p):
            if n > m:
                if pr2 is None:
                    nr = (2 * n - 1) * z * pr1 / (n - m)
                    ni = (2 * n - 1) * z * pi1 / (n - m)
                else:
                    nr = ((2 * n - 1) * z * pr1 - (n + m - 1) * rho2 * pr2) / (n - m)
                    ni = ((2 * n - 1) * z * pi1 - (n + m - 1) * rho2 * pi2) / (n - m)
                pr2, pi2 = pr1, pi1
                pr1, pi1 = nr, ni
            f = float(hm.prefac(n, m))
            idx = n * (n + 1) // 2 + m
            re[idx] = f * pr1
            im[idx] = f * pi1
    return jnp.stack(re, axis=-1), jnp.stack(im, axis=-1)


def eval_singular(d, p, eps=0.0):
    """Singular solid harmonics S_n^m(d), m >= 0, flat (n,m) index —
    real-pair form (see eval_regular)."""
    x, yc, z = d[..., 0], d[..., 1], d[..., 2]
    rho2 = x * x + yc * yc + z * z + eps
    inv_rho2 = 1.0 / rho2
    T = hm.num_terms(p)
    re = [None] * T
    im = [None] * T
    br = jnp.sqrt(inv_rho2)
    bi = jnp.zeros_like(br)
    for m in range(p):
        if m > 0:
            c = -(2 * m - 1)
            br, bi = (
                c * inv_rho2 * (br * x - bi * yc),
                c * inv_rho2 * (br * yc + bi * x),
            )
        pr2 = pi2 = None
        pr1, pi1 = br, bi
        for n in range(m, p):
            if n > m:
                if pr2 is None:
                    nr = (2 * n - 1) * z * pr1 * inv_rho2 / (n - m)
                    ni = (2 * n - 1) * z * pi1 * inv_rho2 / (n - m)
                else:
                    nr = ((2 * n - 1) * z * pr1 - (n + m - 1) * pr2) * inv_rho2 / (n - m)
                    ni = ((2 * n - 1) * z * pi1 - (n + m - 1) * pi2) * inv_rho2 / (n - m)
                pr2, pi2 = pr1, pi1
                pr1, pi1 = nr, ni
            f = float(hm.prefac(n, m))
            idx = n * (n + 1) // 2 + m
            re[idx] = f * pr1
            im[idx] = f * pi1
    return jnp.stack(re, axis=-1), jnp.stack(im, axis=-1)


def to_interleaved_ri(re, im):
    """(re, im) [..., T] pairs -> real [..., 2T] interleaved.

    Coefficients are degree-ordered, so truncating to a lower p is a
    prefix slice — the property the per-p jit tiers rely on.
    """
    return jnp.stack([re, im], axis=-1).reshape(
        re.shape[:-1] + (2 * re.shape[-1],)
    )


def re_part(E):
    """Interleaved real view [..., 2T] -> re [..., T]."""
    return E[..., 0::2]


def im_part(E):
    return E[..., 1::2]


class LaplaceKernel:
    """Point Laplace kernel (ref kernel/LaplaceSpherical.hpp).

    charge: scalar; result: [potential, fx, fy, fz] (Vec<4> in the ref,
    LaplaceSpherical.hpp:66-68).
    """

    name = "laplace"
    ncomp = 1      # expansion components per box
    charge_dim = 1
    result_dim = 4
    #: translation operators depend only on normalised offsets ->
    #: octant/offset classes are shared across levels
    scale_invariant = True
    #: self-interaction exclusion threshold on R^2 (ref :158)
    eps2 = 1e-8

    # ----- expansion layout -----
    def width(self, p):
        """Real slots per expansion component."""
        return hm.real_width(p)

    # ----- host-side translation matrices (numpy, physical args) -----
    def m2m_matrix(self, dr, sigma_src, sigma_tgt, p):
        return hm.m2m_matrix(dr, sigma_src, sigma_tgt, p)

    def m2l_matrix(self, dr, sigma_src, sigma_tgt, p):
        return hm.m2l_matrix(dr, sigma_src, sigma_tgt, p)

    def l2l_matrix(self, dr, sigma_src, sigma_tgt, p):
        return hm.l2l_matrix(dr, sigma_src, sigma_tgt, p)

    def m2l_pair_scale(self, sigma_src):
        """Per-pair factor applied to the class-matrix product (the
        physical 1/r falloff the scale-normalised matrix factors out)."""
        return 1.0 / sigma_src

    # ----- device-side operators (jnp, batched over bodies) -----
    def p2m(self, src, charges, d_norm, inv_sigma, p):
        """Scale-normalised multipole contributions per source.

        M_hat[n,m] = q * conj(R_n^m(d/sigma)) (ref P2M :186-202, with the
        per-box sigma^n normalisation folded into the argument).
        Returns real [B, ncomp, 2, T].
        """
        del src, inv_sigma  # points carry no extra fields
        yr, yi = eval_regular(d_norm, p)
        # conj(R): negate the imaginary plane
        return to_interleaved_ri(
            charges[..., None] * yr, -charges[..., None] * yi
        )[..., None, :]

    def _l2p_potential(self, L, d_norm, p):
        """phi at one normalised offset from an interleaved local expansion."""
        yr, yi = eval_regular(d_norm, p)
        w = jnp.asarray(hm.term_weights(p), dtype=L.dtype)
        return jnp.sum(w * (re_part(L) * yr - im_part(L) * yi))

    def l2p(self, tgt, L, d_norm, inv_sigma, p):
        """Potential + force at targets from their leaf's local expansion.

        Force = grad_t phi computed by AD; the 1/sigma chain-rule factor
        accounts for the normalised coordinates.
        """
        del tgt

        def phi_one(l, d):
            return self._l2p_potential(l[0], d, p)

        phi = jax.vmap(phi_one)(L, d_norm)
        grad = jax.vmap(jax.grad(phi_one, argnums=1))(L, d_norm)
        return jnp.concatenate(
            [phi[:, None], grad * inv_sigma[:, None]], axis=-1
        )

    def _m2p_potential(self, M, d_norm, p):
        sr, si = eval_singular(d_norm, p)
        w = jnp.asarray(hm.term_weights(p), dtype=M.dtype)
        return jnp.sum(w * (re_part(M) * sr - im_part(M) * si))

    def m2p(self, tgt, M, d_norm, inv_sigma, p):
        """Treecode far-field evaluation (ref M2P :340-368): the physical
        potential is (1/sigma) * phi_hat(d/sigma)."""
        del tgt

        def phi_one(m, d, s):
            return self._m2p_potential(m[0], d, p) * s

        phi = jax.vmap(phi_one)(M, d_norm, inv_sigma)
        grad = jax.vmap(jax.grad(phi_one, argnums=1))(M, d_norm, inv_sigma)
        return jnp.concatenate(
            [phi[:, None], grad * inv_sigma[:, None]], axis=-1
        )

    def p2p_block(self, tgt_fields, src_fields, charges, src_mask):
        """P2P tile for the plan executor: padded source slots carry zero
        charge, and the eps2 self-exclusion also kills padded sources
        that alias a target position."""
        del src_mask
        return self.p2p(tgt_fields["xyz"], src_fields["xyz"], charges)

    def p2p(self, tgt_xyz, src_xyz, charges):
        """Direct pairwise block: tgt [Bt,3] x src [Bs,3] -> [Bt, 4].

        Mirrors Direct.hpp's double loop / operator() (ref
        LaplaceSpherical.hpp:153-162) as one broadcast block.

        Layout note: every intermediate is a [Bt, Bs] plane — a
        [Bt, Bs, 3] difference tensor would put the 3-wide coordinate
        axis in the minor dimension, which tiled device layouts pad.
        The force keeps the difference form sum_s w*(s_d - t_d)
        per component (the algebraically equivalent
        (w @ s_d) - t_d*sum(w) cancels two O(|x|) terms and costs ~3
        decimal digits of f64 agreement between differently-partitioned
        sums — it broke the 1e-10 LET parity bar).
        """
        tx = [tgt_xyz[..., d] for d in range(3)]
        sx = [src_xyz[..., d] for d in range(3)]
        dds = [sx[d][None, :] - tx[d][:, None] for d in range(3)]
        r2 = dds[0] * dds[0] + dds[1] * dds[1] + dds[2] * dds[2]
        inv_r2 = jnp.where(
            r2 < self.eps2, 0.0, 1.0 / jnp.maximum(r2, self.eps2)
        )
        inv_r = jnp.sqrt(inv_r2)
        pot = jnp.sum(charges[None, :] * inv_r, axis=1)
        w = charges[None, :] * inv_r * inv_r2  # [Bt, Bs]
        f = [jnp.sum(w * dds[d], axis=1) for d in range(3)]
        return jnp.concatenate(
            [pot[:, None]] + [fd[:, None] for fd in f], axis=-1
        )

    def p2p_matrix(self, tgt_fields, src_fields):
        """Dense potential-entry block K(t,s) (no charge applied) —
        used by block preconditioners and near-field assembly."""
        dist = src_fields["xyz"][None, :, :] - tgt_fields["xyz"][:, None, :]
        r2 = jnp.sum(dist * dist, axis=-1)
        return jnp.where(r2 < self.eps2, 0.0, 1.0 / jnp.sqrt(jnp.maximum(r2, self.eps2)))

    # ----- dense oracle for tests (ref include/Direct.hpp) -----
    def direct(self, tgt_xyz, src_xyz, charges, chunk=2048):
        """O(N^2) direct summation, chunked over targets."""
        tgt_xyz = jnp.asarray(tgt_xyz)
        outs = []
        for i in range(0, tgt_xyz.shape[0], chunk):
            outs.append(self.p2p(tgt_xyz[i : i + chunk], src_xyz, charges))
        return jnp.concatenate(outs, axis=0)
