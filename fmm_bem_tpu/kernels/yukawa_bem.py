"""Yukawa BEM panel kernel (screened-Laplace boundary integrals).

JAX counterpart of kernel/YukawaCartesianBEM.hpp: a two-component
Cartesian-Taylor expansion per box — component 0 from quadrature
monopoles of int G, component 1 from quadrature dipoles of int dG/dn
(ref P2M :240-297) — selected at evaluation by the panel BC exactly like
the Laplace BEM kernel (ref operator() :213-230).  Near-field entries
reuse the semi-analytical/fine/plain quadrature assembly of
fmm_bem_tpu.bem.integrals with kappa > 0 (ref eval_G/eval_dGdn
:145-204 and SemiAnalytical's YUKAWA branch).

Note: the reference's Yukawa BEM driver is stale/unbuildable
(SURVEY.md §2.4) — this implementation restores the capability with a
working FMM (including M2L, which the reference's spherical Yukawa
disabled).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from fmm_bem_tpu.bem.integrals import near_entries_laplace
from fmm_bem_tpu.kernels import cartesian as ct
from fmm_bem_tpu.kernels.cartesian import YukawaKernel


def _seg_sum(x, ids, num):
    return jax.ops.segment_sum(x, ids, num_segments=num)


class YukawaBEMKernel(YukawaKernel):
    """Single/double-layer Yukawa panel kernel (ncomp = 2, scalar)."""

    name = "yukawa_bem"
    ncomp = 2
    charge_dim = 1
    result_dim = 1
    near_sparse = True

    def __init__(self, K=3, fine_K=17, kappa=0.125):
        super().__init__(kappa=kappa)
        self.K = K
        self.fine_K = fine_K

    # ----- device ops -----
    def p2m(self, fields, charges, d_norm, inv_sigma, p):
        qd = fields["qp_off"] * inv_sigma[:, None, None] + d_norm[:, None, :]
        w = (fields["qw"] * fields["area"][:, None]) * charges[:, None]  # [N,K]
        nrm = jnp.broadcast_to(fields["normal"][:, None, :], qd.shape)

        pw, dpw = jax.jvp(lambda z: ct.powers(-z, p), (qd,), (nrm,))
        m0 = jnp.sum(w[..., None] * pw, axis=1)
        # dipole moments: (n . grad_x) of the monomial moments; the
        # jvp direction n with the -z argument carries the sign
        m1 = jnp.sum(w[..., None] * dpw, axis=1) * inv_sigma[:, None]

        bc = fields["bc"]
        m0 = m0 * (1.0 - bc)[:, None]
        m1 = m1 * bc[:, None]
        return jnp.stack([m0, m1], axis=1)  # [N, 2, T]

    def _eval_pair(self, fields, r0, r1):
        bc = fields["bc"]
        return jnp.where(bc == 0.0, r0, -r1)[:, None]

    def l2p(self, fields, L, d_norm, inv_sigma, p):
        del inv_sigma
        pw = ct.powers(d_norm, p)
        r0 = jnp.sum(L[:, 0, :] * pw, axis=-1)
        r1 = jnp.sum(L[:, 1, :] * pw, axis=-1)
        return self._eval_pair(fields, r0, r1)

    def m2p(self, fields, M, d_norm, inv_sigma, p):
        _, deg, _, _, _ = ct.index_set(p)
        fac = jnp.asarray(ct._factorial_prod(p), dtype=M.dtype)
        degs = jnp.asarray(deg, dtype=M.dtype)

        def one(m, d, isig):
            dX = d / isig
            a = ct.eval_coeffs(dX, self.kappa, p)
            sig = (1.0 / isig) ** degs
            r0 = jnp.sum(fac * a * sig * m[0], axis=-1)
            r1 = jnp.sum(fac * a * sig * m[1], axis=-1)
            return r0, r1

        r0, r1 = jax.vmap(one)(M, d_norm, inv_sigma)
        return self._eval_pair(fields, r0, r1)

    # ----- near field -----
    def near_values(self, tgt_fields, src_fields, rows, cols):
        G, dG = near_entries_laplace(
            tgt_fields, src_fields, rows, cols,
            fine_K=self.fine_K, kappa=self.kappa,
        )
        return np.stack([G, dG], axis=1)

    def near_matvec(self, vals, rows, cols, fields, qm, n):
        bc_rows = fields["bc"][rows]
        v = jnp.where(bc_rows == 0.0, vals[:, 0], vals[:, 1])
        return _seg_sum(v * qm[cols], rows, n)[:, None]

    def near_select(self, vals, bc_rows):
        """Host-side BC selection for the leaf-panel near field."""
        return np.where(np.asarray(bc_rows) == 0.0, vals[:, 0], vals[:, 1])

    # device regular-quadrature block builder shared with Laplace BEM
    # (the kappa attribute switches on the screening factors)
    from fmm_bem_tpu.kernels.laplace_bem import (  # noqa: E501
        LaplaceBEMKernel as _LB,
    )
    near_block_device = _LB.near_block_device
    del _LB

    # ----- dense oracle -----
    def dense_matrix(self, fields):
        n = len(fields["xyz"])
        rows = np.repeat(np.arange(n, dtype=np.int64), n)
        cols = np.tile(np.arange(n, dtype=np.int64), n)
        G, dG = near_entries_laplace(
            fields, fields, rows, cols, fine_K=self.fine_K, kappa=self.kappa
        )
        bc = np.asarray(fields["bc"])[rows]
        vals = np.where(bc == 0.0, G, dG)
        return vals.reshape(n, n)
