"""FMM execution plan: tree(s) + interaction lists + batched device matvec.

JAX re-design of the reference execution layer
(include/FMM_plan.hpp + include/executor/ExecutorSingleTree.hpp /
ExecutorDualTree.hpp + EvalInteractionLazy*.hpp): one host-side *plan
build* materialises every charge-independent structure — the octree(s),
the traversal lists, the translation-class grouping, per-body normalised
offsets — and the per-iteration matvec is a single jitted function
replaying them as batched XLA ops:

    P2M   segment-sum of per-source harmonic contributions into leaves
    M2M   octant-class matmuls per level, bottom-up (source tree)
    M2L   one dense [pairs, W] x [W, W] matmul per translation class
          (scale-normalised classes are shared across levels), then one
          segment-sum into target locals
    L2L   octant-class matmuls per level, top-down (target tree)
    L2P   per-target expansion evaluation (forces by autodiff)
    M2P   treecode far-field path / fallback for level-skewed pairs
    P2P   leaf-pair tiles over padded per-leaf body lists, or a
          precomputed sparse near-field matrix (BEM)

Supports separate source and target point sets (the reference's
ExecutorDualTree, exercised by tests/dual_correctness.cpp) by building
two trees in a common bounding cube.

The relaxation hook (`K.set_p(p)` in the reference, GMRES.hpp:195-196)
becomes a *static* argument: ``apply(charges, p)`` jit-compiles one
specialisation per requested order, prefix-slicing all degree-ordered
term dimensions — smaller p genuinely costs less, with no table
rebuilds.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from fmm_bem_tpu.config import Evaluator, FMMConfig
from fmm_bem_tpu.tree.octree import Tree, bounding_cube, build_tree
from fmm_bem_tpu.traversal.lists import (
    InteractionLists,
    build_interaction_lists,
    expand_to_leaves,
)


#: correction-window store budget: beyond it the OTF mode keeps
#: padded-row entry lists instead (see FmmPlan._build_near_otf)
_OTF_WINDOW_LIMIT = 1 << 30


def _seg_sum(x, ids, num):
    return jax.ops.segment_sum(x, ids, num_segments=num)


def m2m_level(M, parents, kids, T, ncomp):
    """One level of the batched M2M on FLAT [rows, ncomp*W] expansions:
    every parent gathers its eight octant children ``kids`` [n, 8] (rows
    past the table read as zero) and ONE matmul with ``T`` [8W, W]
    applies all eight octant operators, contracting over octant and
    term.  The component axis folds into the matmul rows."""
    W = T.shape[1]
    ch = M.at[kids].get(mode="fill", fill_value=0.0)
    rows = (
        ch.reshape(-1, 8, ncomp, W)
        .transpose(0, 2, 1, 3)
        .reshape(-1, 8 * W)
    )
    return M.at[parents].add((rows @ T).reshape(-1, ncomp * W))


def l2l_level(L, parents, kids, U, ncomp):
    """One level of the batched L2L: ONE matmul with ``U`` [W, 8W]
    translates each parent's local expansion to all eight octants, and
    the rows of the children ``kids`` [n, 8] are added in place (rows
    past the table are dropped)."""
    W = U.shape[0]
    out = (
        (L[parents].reshape(-1, W) @ U)
        .reshape(-1, ncomp, 8, W)
        .transpose(0, 2, 1, 3)
        .reshape(-1, ncomp * W)
    )
    return L.at[kids.reshape(-1)].add(out, mode="drop")


def chunked_vmap(f, args, chunk):
    """vmap(f) evaluated in fixed-size chunks via lax.map: bounds the
    transient memory of pair-blocked operators (a P2P block batch of
    60k pairs x [64, 64] values would otherwise materialise ~1 GB and
    thrash the allocator — FMMConfig.p2p_chunk is the knob)."""
    n = jax.tree_util.tree_leaves(args)[0].shape[0]
    if chunk <= 0 or n <= chunk:
        return jax.vmap(f)(*args)
    nch = -(-n // chunk)
    pad = nch * chunk - n

    def pad_arg(a):
        if pad:
            a = jnp.concatenate(
                [a, jnp.zeros((pad,) + a.shape[1:], a.dtype)]
            )
        return a.reshape((nch, chunk) + a.shape[1:])

    argsp = jax.tree_util.tree_map(pad_arg, args)
    out = jax.lax.map(lambda ch: jax.vmap(f)(*ch), argsp)
    out = jax.tree_util.tree_map(
        lambda o: o.reshape((nch * chunk,) + o.shape[2:])[:n], out
    )
    return out


def check_kernel(kernel, config):
    """Validate the kernel's batched-operator protocol for the requested
    evaluation mode BEFORE any device work — the array-era analogue of
    the reference's compile-time capability check (FMM_plan.hpp:115-127,
    check_kernel via ExpansionTraits::is_valid_fmm/treecode).  A
    malformed kernel otherwise fails with an opaque trace error deep
    inside jit.
    """
    missing = []

    def need(attr, why, callable_=True):
        v = getattr(kernel, attr, None)
        if v is None or (callable_ and not callable(v)):
            missing.append(f"  .{attr}  — {why}")

    kname = type(kernel).__name__
    need("width", "expansion width(p) (terms per component)")
    need("ncomp", "expansion components per box", callable_=False)
    need("result_dim", "per-target result vector length", callable_=False)

    near_only = config.local_evaluation or config.block_diagonal
    if not near_only:
        need("p2m", "source -> multipole (ref ExpansionTraits has_P2M)")
        need("m2m_matrix", "child->parent translation (ref has_M2M)")
        if config.evaluator == Evaluator.FMM:
            need("m2l_matrix", "multipole->local translation (ref has_M2L)")
            need("m2l_pair_scale", "per-pair M2L kernel scale")
            need("l2l_matrix", "parent->child translation (ref has_L2L)")
            if not (
                callable(getattr(kernel, "l2p", None))
                or callable(getattr(kernel, "l2p_table", None))
            ):
                missing.append(
                    "  .l2p or .l2p_table  — local evaluation at targets"
                    " (ref has_L2P)"
                )
        # treecode far field and the skew-pair fallback both need M2P
        need("m2p", "multipole evaluation at targets (ref has_M2P)")

    # near field: precomputed sparse values (BEM) or direct P2P tiles
    if getattr(kernel, "near_sparse", False):
        need("near_values", "host assembly of near-field entries")
        need("near_matvec", "sparse near-field product")
    else:
        need("p2p_block", "leaf-pair direct tile (ref KernelTraits"
             " has_eval_op / vector P2P)")

    if missing:
        mode = (
            "near-field-only" if near_only else config.evaluator.value
        )
        raise TypeError(
            f"kernel {kname} does not satisfy the batched operator "
            f"protocol for {mode} evaluation (ref FMM_plan.hpp:115-127 "
            f"check_kernel); missing:\n" + "\n".join(missing)
            + "\nsee fmm_bem_tpu/kernels/skeleton.py for the protocol."
        )


@dataclasses.dataclass
class _ClassedPairs:
    """M2L pairs grouped by translation class.  Classes are keyed by
    (level gap, absolute source level, normalised offset), so the
    kernel's per-pair scale (a function of the source box size only)
    is CONSTANT per class and folded into the class matrix, which
    removes a per-pair scale multiply from every matvec."""

    src: list          # per-class source box ids (source tree)
    tgt: list          # per-class target box ids (target tree)
    mats: np.ndarray   # [ncls, W, W], kernel scale folded in


@dataclasses.dataclass
class _M2LFamilies:
    """Same-level M2L pairs regrouped by (source-parent, target-parent).

    A family's child pairs share ONE dense [8W, 8W] class operator (64
    child-translation blocks, zeroed where the combo is near-field),
    keyed by the quantised parent offset: with the tie-consistent MAC
    (traversal/lists.py) the per-family combo set is exactly
    ``class_union_mask & existing_children`` — verified at build, with
    deviant families demoted to the residual tile path.  Missing source
    children contribute zero rows; missing target children are dropped
    by the output gather.  Motive: the per-pair expansion gather moves
    short rows in class order; family rows are 8x wider and ~16x
    fewer, and the per-class [F_c*ncomp, 8W] x [8W, 8W] matmuls are
    large and dense.
    """

    #: [nusp, 8] child box id per used source parent (-1 = missing)
    src_child: np.ndarray
    #: [nusp] per-pair kernel scale (m2l_pair_scale of the child sigma),
    #: folded into the staging so class operators are level-free for
    #: scale-invariant kernels
    src_scale: np.ndarray
    #: per class: rows into the used-source-parent table [F_c_pad]
    cls_sp: list
    #: per class: target-parent rows [F_c_pad] (dummy = nutp)
    cls_tp: list
    #: [ncls, 8, Wm, 8, Wm] class operators (combo blocks, masked)
    mats: np.ndarray
    #: [num_tgt_boxes] row into the [nutp*8] family-output table
    #: (dummy = nutp*8 for boxes not covered by the family path)
    out_idx: np.ndarray
    #: family -> target-parent reduction plan (class-concatenated order)
    bsum: object
    nusp: int
    nutp: int
    #: diagnostics
    npairs: int


@dataclasses.dataclass
class _TreeSide:
    """Per-tree executor structures (leaf tiles, body offsets, octant
    classes) — one for the source side, one for the target side (same
    object in the single-tree case)."""

    tree: Tree
    fields: dict
    leaf_ids: np.ndarray
    box_to_slot: np.ndarray
    leaf_pad: int
    leaf_body_idx: np.ndarray
    leaf_body_mask: np.ndarray
    body_flat_slot: np.ndarray
    body_dnorm: np.ndarray
    body_inv_sigma: np.ndarray
    body_leaf_box: np.ndarray
    #: per level: (parent_ids [np], kids [np, 8] by octant with dummy
    #: num_boxes, mat_idx [8]) or None — the batched M2M/L2L layout
    level_groups: list
    m2m_mats: np.ndarray
    l2l_mats: np.ndarray


def _build_side(tree, fields, kern, pmax, scale_inv, leaf_pad=None):
    n = tree.num_bodies
    leaves = tree.leaves.astype(np.int32)
    nl = len(leaves)
    box_to_slot = np.full(tree.num_boxes, -1, dtype=np.int32)
    box_to_slot[leaves] = np.arange(nl, dtype=np.int32)
    K = int(tree.box_body_count[leaves].max())
    if leaf_pad is not None:
        # pinned leaf-tile width: keeps P2P/near block shapes constant
        # across problem sizes (scaling sweeps) and across LET shards
        if leaf_pad < K:
            raise ValueError(
                f"config.leaf_pad={leaf_pad} < max leaf occupancy {K}"
            )
        K = int(leaf_pad)
    counts = tree.box_body_count[leaves]
    starts = tree.box_body_start[leaves]
    pos = np.arange(K)[None, :]
    mask = pos < counts[:, None]
    idx = np.where(mask, starts[:, None] + pos, 0).astype(np.int32)
    slot_of_body = box_to_slot[tree.body_leaf]
    pos_of_body = np.arange(n) - tree.box_body_start[tree.body_leaf]
    flat_slot = (slot_of_body * K + pos_of_body).astype(np.int32)

    sigma_b = tree.box_radius[tree.body_leaf]
    dnorm = (tree.points - tree.box_center[tree.body_leaf]) / sigma_b[:, None]

    # octant classes for M2M (this tree as source) and L2L (as target)
    child_boxes = np.arange(1, tree.num_boxes, dtype=np.int32)
    octant = None
    if len(child_boxes):
        par = tree.box_parent[child_boxes]
        off = tree.box_center[child_boxes] - tree.box_center[par]
        octant = (
            (off[:, 0] > 0).astype(np.int32)
            + 2 * (off[:, 1] > 0).astype(np.int32)
            + 4 * (off[:, 2] > 0).astype(np.int32)
        )
    m2m_mats, l2l_mats, level_groups = [], [], []
    mat_key = {}
    for lvl in range(1, tree.num_levels):
        lo, hi = tree.level_offset[lvl], tree.level_offset[lvl + 1]
        ids = child_boxes[(child_boxes >= lo) & (child_boxes < hi)]
        if len(ids) == 0:
            level_groups.append(None)
            continue
        parents, pos = np.unique(tree.box_parent[ids], return_inverse=True)
        oct_ids = octant[ids - 1]
        kids = np.full((len(parents), 8), tree.num_boxes, np.int32)
        kids[pos, oct_ids] = ids
        mat_idx = np.zeros(8, np.int32)
        for c in np.unique(oct_ids):
            key = (None if scale_inv else lvl, int(c))
            if key not in mat_key:
                b = int(ids[oct_ids == c][0])
                pb = int(tree.box_parent[b])
                sig_c = tree.box_radius[b]
                sig_p = tree.box_radius[pb]
                drm = tree.box_center[pb] - tree.box_center[b]
                mat_key[key] = len(m2m_mats)
                m2m_mats.append(kern.m2m_matrix(drm, sig_c, sig_p, pmax))
                l2l_mats.append(kern.l2l_matrix(-drm, sig_p, sig_c, pmax))
            mat_idx[c] = mat_key[key]
        level_groups.append((parents.astype(np.int32), kids, mat_idx))
    W = kern.width(pmax)
    if not m2m_mats:
        m2m_mats = [np.eye(W)]
        l2l_mats = [np.eye(W)]
    return _TreeSide(
        tree=tree,
        fields=fields,
        leaf_ids=leaves,
        box_to_slot=box_to_slot,
        leaf_pad=K,
        leaf_body_idx=idx,
        leaf_body_mask=mask,
        body_flat_slot=flat_slot,
        body_dnorm=dnorm,
        body_inv_sigma=1.0 / sigma_b,
        body_leaf_box=tree.body_leaf.astype(np.int32),
        level_groups=level_groups,
        m2m_mats=np.stack(m2m_mats),
        l2l_mats=np.stack(l2l_mats),
    )


class FmmPlan:
    """FMM/treecode matvec plan for a kernel.

    Parameters
    ----------
    kernel : kernel object following the batched operator protocol
        (p2m / l2p / m2p / p2p_block or near_values + *_matrix builders).
    fields : dict of per-source numpy arrays; must contain "xyz" [N,3].
        Extra arrays (panel normals, areas, BC flags, ...) are permuted
        into Morton order and passed to the kernel's batched operators.
    config : FMMConfig.
    target_fields : optional dict for a distinct target point set
        (dual-tree mode, ref ExecutorDualTree.hpp).  Charges are indexed
        by sources, results by targets.
    """

    def __init__(
        self,
        kernel,
        fields,
        config: Optional[FMMConfig] = None,
        target_fields=None,
    ):
        self.kernel = kernel
        self.config = config or FMMConfig()
        cfg = self.config
        check_kernel(kernel, cfg)
        scale_inv = getattr(kernel, "scale_invariant", True)

        src_xyz = np.asarray(fields["xyz"], dtype=np.float64)
        self.dual = target_fields is not None
        if self.dual:
            tgt_xyz = np.asarray(target_fields["xyz"], dtype=np.float64)
            pmin, side = bounding_cube(np.concatenate([src_xyz, tgt_xyz]))
            stree = build_tree(src_xyz, cfg.ncrit, cfg.max_level, pmin, side)
            ttree = build_tree(tgt_xyz, cfg.ncrit, cfg.max_level, pmin, side)
        else:
            stree = build_tree(src_xyz, cfg.ncrit, cfg.max_level)
            # pad-pathology guard: every leaf tile is padded to the
            # MAXIMUM leaf occupancy, so one full leaf against a low
            # mean multiplies every P2P/near tile by the ratio (e.g.
            # ncrit 125, mean occupancy ~33, one 125-body leaf).  When
            # the ratio
            # blows past 2x, rebuild once with ncrit ~ 2x the mean
            # (the reference ships tests/ncrit_search.cpp for exactly
            # this tuning; here the plan self-tunes).
            if cfg.auto_ncrit and cfg.leaf_pad is None:
                occ = stree.box_body_count[stree.box_is_leaf]
                mean_occ = float(occ.mean())
                if (
                    len(occ)
                    and occ.max() > 2.0 * mean_occ
                    and mean_occ >= 8.0
                ):
                    ncrit2 = max(8, int(np.ceil(2.0 * mean_occ)))
                    if ncrit2 < cfg.ncrit:
                        tree2 = build_tree(src_xyz, ncrit2, cfg.max_level)
                        occ2 = tree2.box_body_count[tree2.box_is_leaf]
                        # keep the retuned tree only if it shrinks the
                        # padded-slot total (a full leaf at max depth
                        # cannot split, and then the rebuild only
                        # churns the rest of the tree)
                        if len(occ2) * occ2.max() < len(occ) * occ.max():
                            import warnings

                            warnings.warn(
                                f"leaf occupancy max {int(occ.max())} "
                                f"vs mean {mean_occ:.1f}: padding "
                                f"would waste >2x; retuned ncrit="
                                f"{ncrit2} (was {cfg.ncrit}).  Pass "
                                f"auto_ncrit=False or an explicit "
                                f"leaf_pad to keep the original.",
                                stacklevel=3,
                            )
                            stree = tree2
            ttree = stree

        treecode = cfg.evaluator == Evaluator.TREECODE
        self.lists: InteractionLists = build_interaction_lists(
            stree,
            cfg.theta,
            tgt_tree=ttree if self.dual else None,
            treecode=treecode,
        )
        sfields = {k: np.asarray(v)[stree.perm] for k, v in fields.items()}
        if self.dual:
            tfields = {
                k: np.asarray(v)[ttree.perm] for k, v in target_fields.items()
            }
        else:
            tfields = sfields

        pmax = cfg.max_p
        from fmm_bem_tpu.utils.metrics import log

        with log.phase("build.sides"):
            self.src = _build_side(
                stree, sfields, kernel, pmax, scale_inv,
                leaf_pad=cfg.leaf_pad,
            )
            self.tgt = (
                _build_side(
                    ttree, tfields, kernel, pmax, scale_inv,
                    leaf_pad=cfg.leaf_pad,
                )
                if self.dual
                else self.src
            )
        with log.phase("build.m2l_classes"):
            self._build_m2l_classes()
        with log.phase("build.near"):
            self._build_near()
        self._apply_cache = {}

    # convenience accessors (single-tree compatibility)
    @property
    def tree(self):
        return self.src.tree

    @property
    def fields(self):
        return self.src.fields

    @property
    def leaf_pad(self):
        return self.src.leaf_pad

    @property
    def leaf_ids(self):
        return self.src.leaf_ids

    # ------------------------------------------------------------------
    # host-side build
    # ------------------------------------------------------------------
    def _build_m2l_classes(self):
        st = self.src.tree
        tt = self.tgt.tree
        kern = self.kernel
        pmax = self.config.max_p
        pairs = self.lists.m2l_pairs
        m2p_extra_s, m2p_extra_t = [], []

        if len(pairs):
            s, tg = pairs[:, 0], pairs[:, 1]
            sig_s = st.box_radius[s]
            sig_t = tt.box_radius[tg]
            # route pairs whose target is much larger than the source to
            # the M2P path: their normalised offsets are unbounded and
            # would explode the class count
            skew = sig_t > 2.0 * sig_s + 1e-12
            if skew.any():
                leaves, rows = expand_to_leaves(tt, tg[skew])
                m2p_extra_s.append(s[skew][rows])
                m2p_extra_t.append(leaves)
                s, tg, sig_s, sig_t = (
                    s[~skew],
                    tg[~skew],
                    sig_s[~skew],
                    sig_t[~skew],
                )
        else:
            s = np.zeros(0, dtype=np.int32)
            tg = s
            sig_s = np.zeros(0)
            sig_t = sig_s

        src_list, tgt_list, mats = [], [], []
        cls_of_pair = []
        if len(s):
            offn = (tt.box_center[tg] - st.box_center[s]) / sig_s[:, None]
            ki = np.round(offn * 64.0).astype(np.int64) + 4096
            # pairs whose normalised offset escapes the class-key range
            # (extreme level skew past the 2-sigma guard above) degrade
            # to the M2P path instead of crashing plan build
            over = ((ki < 0) | (ki >= 8192)).any(axis=1)
            if over.any():
                leaves, rows = expand_to_leaves(tt, tg[over])
                m2p_extra_s.append(s[over][rows])
                m2p_extra_t.append(leaves)
                keep = ~over
                s, tg = s[keep], tg[keep]
                sig_s, sig_t = sig_s[keep], sig_t[keep]
                offn, ki = offn[keep], ki[keep]
        if len(s):
            dlvl = (
                st.box_level[s].astype(np.int64)
                - tt.box_level[tg].astype(np.int64)
                + 8
            )
            # the key includes the ABSOLUTE source level (not just the
            # gap) for every kernel: non-scale-invariant kernels
            # (Yukawa) need per-level matrices anyway, and for the rest
            # it makes the per-pair kernel scale class-constant so it
            # folds into the matrix (see _ClassedPairs)
            lkey = dlvl * 16 + st.box_level[s].astype(np.int64)
            key = ((lkey * 8192 + ki[:, 0]) * 8192 + ki[:, 1]) * 8192 + ki[:, 2]
            uniq, inv = np.unique(key, return_inverse=True)
            order = np.argsort(inv, kind="stable")
            bounds = np.searchsorted(inv[order], np.arange(len(uniq) + 1))
            for ci in range(len(uniq)):
                sel = order[bounds[ci] : bounds[ci + 1]]
                rep = sel[0]
                drm = tt.box_center[tg[rep]] - st.box_center[s[rep]]
                scale_c = float(
                    np.asarray(
                        kern.m2l_pair_scale(sig_s[rep : rep + 1])
                    ).reshape(-1)[0]
                )
                mats.append(
                    scale_c
                    * kern.m2l_matrix(drm, sig_s[rep], sig_t[rep], pmax)
                )
                src_list.append(s[sel].astype(np.int32))
                tgt_list.append(tg[sel].astype(np.int32))
        W = kern.width(pmax)
        mats_arr = np.stack(mats) if mats else np.zeros((0, W, W))
        self.m2l_classes = _ClassedPairs(
            src=src_list, tgt=tgt_list, mats=mats_arr
        )
        # family regrouping (same-level pairs); the LET layer keeps
        # consuming the full m2l_classes above, the single-chip matvec
        # runs family path + residual tiles
        self.m2l_fam = None
        keep_res = None
        if len(s) and self.config.m2l_family:
            keep_res = self._build_m2l_families(s, tg, inv)
        if self.m2l_fam is not None:
            self._build_m2l_tiles(
                subset=(s[keep_res], tg[keep_res], inv[keep_res])
            )
        else:
            self._build_m2l_tiles()

        # ---- M2P list: treecode far field + skew fallback
        mp = self.lists.m2p_pairs
        parts_s = [mp[:, 0]] + m2p_extra_s
        parts_t = [mp[:, 1]] + m2p_extra_t
        ms = np.concatenate(parts_s).astype(np.int32)
        mt = np.concatenate(parts_t).astype(np.int32)
        self.m2p_src = ms
        self.m2p_tgt_slot = self.tgt.box_to_slot[mt].astype(np.int32)
        self.m2p_inv_sigma = (
            1.0 / st.box_radius[ms] if len(ms) else np.zeros(0)
        )

    @staticmethod
    def _octants(tree, boxes):
        """Child octant (0..7, x|y<<1|z<<2 by center offset sign) of
        each box within its parent."""
        par = tree.box_parent[boxes]
        off = tree.box_center[boxes] - tree.box_center[par]
        return (
            (off[:, 0] > 0).astype(np.int64)
            + 2 * (off[:, 1] > 0).astype(np.int64)
            + 4 * (off[:, 2] > 0).astype(np.int64)
        )

    def _build_m2l_families(self, s, tg, cls_of_pair):
        """Group same-level M2L pairs into (source-parent, target-parent)
        families sharing a dense per-offset-class [8W, 8W] operator (see
        _M2LFamilies).  Returns the boolean residual-pair selector for
        the tile path, or None (sets ``self.m2l_fam``)."""
        del cls_of_pair  # families re-key by PARENT offset
        st, tt = self.src.tree, self.tgt.tree
        kern = self.kernel
        pmax = self.config.max_p
        scale_inv = getattr(kern, "scale_invariant", True)

        sl = st.box_level[s]
        tl = tt.box_level[tg]
        sp = st.box_parent[s]
        tp = tt.box_parent[tg]
        cand = (sl == tl) & (sp >= 0) & (tp >= 0)
        if not cand.any():
            return None
        ci_ = np.nonzero(cand)[0]
        o_s = self._octants(st, s[ci_])
        o_t = self._octants(tt, tg[ci_])
        fam_key = sp[ci_].astype(np.int64) * tt.num_boxes + tp[ci_]
        uf, fam_inv = np.unique(fam_key, return_inverse=True)
        combo = (o_s * 8 + o_t).astype(np.uint64)
        fmask = np.zeros(len(uf), dtype=np.uint64)
        np.bitwise_or.at(fmask, fam_inv, np.uint64(1) << combo)

        fam_sp = (uf // tt.num_boxes).astype(np.int64)
        fam_tp = (uf % tt.num_boxes).astype(np.int64)
        rp = st.box_radius[fam_sp]
        dvec = tt.box_center[fam_tp] - st.box_center[fam_sp]
        ki = np.round(dvec / rp[:, None] * 8.0).astype(np.int64) + 2048
        in_range = ((ki >= 0) & (ki < 4096)).all(axis=1)
        # the per-pair kernel scale (m2l_pair_scale of the CHILD sigma)
        # is folded into the Mfam STAGING (one scalar per used source
        # parent), so scale-invariant kernels share one class operator
        # across levels — the [8W, 8W] matrices are the phase's
        # dominant byte stream and this cuts their count ~3x
        lkey = (
            st.box_level[fam_sp].astype(np.int64)
            if not scale_inv
            else np.zeros(len(uf), np.int64)
        )
        ckey = (
            (lkey * 4096 + ki[:, 0]) * 4096 + ki[:, 1]
        ) * 4096 + ki[:, 2]
        ckey = np.where(in_range, ckey, -1)
        ucls, cls_inv = np.unique(ckey, return_inverse=True)
        umask = np.zeros(len(ucls), dtype=np.uint64)
        np.bitwise_or.at(umask, cls_inv, fmask)

        # existing-children bitmasks per parent
        def child_bits(tree):
            ch = np.nonzero(tree.box_parent >= 0)[0]
            oc = self._octants(tree, ch)
            bits = np.zeros(tree.num_boxes, dtype=np.uint64)
            np.bitwise_or.at(
                bits, tree.box_parent[ch], np.uint64(1) << oc.astype(np.uint64)
            )
            return bits

        sbits = child_bits(st)[fam_sp]
        tbits = child_bits(tt)[fam_tp]
        exist = np.zeros(len(uf), dtype=np.uint64)
        for o in range(8):
            have = (sbits >> np.uint64(o)) & np.uint64(1)
            exist |= np.where(have == 1, tbits, np.uint64(0)) << np.uint64(
                8 * o
            )
        # exactness guard: a family joins the path only if its actual
        # combo set equals the class union restricted to its existing
        # children (holds for 100% of families with the tie-consistent
        # MAC; anything else — out-of-range offsets included — demotes
        # to the residual tile path)
        good = in_range & (fmask == (umask[cls_inv] & exist)) & (
            ucls[cls_inv] >= 0
        )
        if not good.any():
            return None

        pair_good = good[fam_inv]
        keep_res = np.ones(len(s), dtype=bool)
        keep_res[ci_[pair_good]] = False

        # compact to good families / their classes
        gsel = np.nonzero(good)[0]
        fam_sp_g = fam_sp[gsel]
        fam_tp_g = fam_tp[gsel]
        gckey = ckey[gsel]
        gucls, gcls_inv = np.unique(gckey, return_inverse=True)
        gumask = np.zeros(len(gucls), dtype=np.uint64)
        np.bitwise_or.at(gumask, gcls_inv, fmask[gsel])

        usp, sp_loc = np.unique(fam_sp_g, return_inverse=True)
        utp, tp_loc = np.unique(fam_tp_g, return_inverse=True)

        # per-used-source-parent child table (octant -> box id, -1 miss)
        src_child = np.full((len(usp), 8), -1, dtype=np.int32)
        src_scale = np.asarray(
            kern.m2l_pair_scale(0.5 * st.box_radius[usp])
        ).reshape(-1)
        ch = np.nonzero(st.box_parent >= 0)[0]
        par = st.box_parent[ch]
        pos = np.searchsorted(usp, par)
        pos = np.minimum(pos, len(usp) - 1)
        hit = usp[pos] == par
        oc = self._octants(st, ch[hit])
        src_child[pos[hit], oc] = ch[hit].astype(np.int32)

        # target-box output map: box -> row of [nutp*8]
        out_idx = np.full(tt.num_boxes, len(utp) * 8, dtype=np.int32)
        cht = np.nonzero(tt.box_parent >= 0)[0]
        part = tt.box_parent[cht]
        post = np.searchsorted(utp, part)
        post = np.minimum(post, len(utp) - 1)
        hitt = utp[post] == part
        oct_t = self._octants(tt, cht[hitt])
        out_idx[cht[hitt]] = (post[hitt] * 8 + oct_t).astype(np.int32)

        # class operators: 64 child-translation blocks, zero where the
        # union mask lacks the combo.  Individual child matrices are
        # cached by normalised offset (scale-invariant kernels share
        # them across levels).
        W = kern.width(pmax)
        sig_oct = np.array(
            [[1.0 if (o >> a) & 1 else -1.0 for a in range(3)]
             for o in range(8)]
        )
        mats = np.zeros((len(gucls), 8, W, 8, W))
        mat_cache = {}
        # one representative family per class
        rep = np.zeros(len(gucls), dtype=np.int64)
        rep[gcls_inv[::-1]] = np.arange(len(gsel))[::-1]
        for ci in range(len(gucls)):
            f = rep[ci]
            rpf = st.box_radius[fam_sp_g[f]]
            rc = 0.5 * rpf
            lvl = int(st.box_level[fam_sp_g[f]])
            dd = tt.box_center[fam_tp_g[f]] - st.box_center[fam_sp_g[f]]
            m = int(gumask[ci])
            for o_s in range(8):
                for o_t in range(8):
                    if not (m >> (o_s * 8 + o_t)) & 1:
                        continue
                    drm = dd + 0.5 * rpf * (sig_oct[o_t] - sig_oct[o_s])
                    ckey_m = (
                        tuple(np.round(drm / rc * 8.0).astype(np.int64)),
                        lvl if not scale_inv else -1,
                    )
                    blk = mat_cache.get(ckey_m)
                    if blk is None:
                        blk = kern.m2l_matrix(drm, rc, rc, pmax)
                        mat_cache[ckey_m] = blk
                    # transposed: the family matmul is rows @ T, the
                    # kernel matrix convention is out = mat @ M; the
                    # per-pair kernel scale is NOT folded here (it is
                    # per-level) — it rides the Mfam staging
                    mats[ci, o_s, :, o_t, :] = blk.T

        # per-class family lists, padded to a multiple of 8; padded
        # rows clamp to source row 0 and scatter to the dummy target
        PAD = 8
        cls_sp, cls_tp = [], []
        order = np.argsort(gcls_inv, kind="stable")
        bounds = np.searchsorted(
            gcls_inv[order], np.arange(len(gucls) + 1)
        )
        for ci in range(len(gucls)):
            sel = order[bounds[ci]: bounds[ci + 1]]
            n = len(sel)
            npad = (-n) % PAD
            spv = np.concatenate(
                [sp_loc[sel], np.zeros(npad, np.int64)]
            ).astype(np.int32)
            tpv = np.concatenate(
                [tp_loc[sel], np.full(npad, len(utp), np.int64)]
            ).astype(np.int32)
            cls_sp.append(spv)
            cls_tp.append(tpv)

        from fmm_bem_tpu.ops.bucket_sum import build_bucket_sum

        all_tp = np.concatenate(cls_tp)
        bsum = build_bucket_sum(all_tp, len(all_tp), len(utp))

        self.m2l_fam = _M2LFamilies(
            src_child=src_child,
            src_scale=src_scale,
            cls_sp=cls_sp,
            cls_tp=cls_tp,
            mats=mats,
            out_idx=out_idx,
            bsum=bsum,
            nusp=len(usp),
            nutp=len(utp),
            npairs=int(pair_good.sum()),
        )
        return keep_res

    def _slice_fam_mats(self, p):
        """Per-order family class operators: prefix-slice every child
        block to width(p) and flatten to [ncls, 8W, 8W]."""
        W = self.kernel.width(p)
        m = self.m2l_fam.mats[:, :, :W, :, :W]
        n = m.shape[0]
        return np.ascontiguousarray(m).reshape(n, 8 * W, 8 * W)

    def _build_m2l_tiles(self, subset=None):
        """Flatten the per-class pair lists into fixed-size tiles so the
        device M2L is ONE scan of batched [tile, W] x [W, W] matmuls
        instead of one op per class: each class's pairs are padded to a
        multiple of ``m2l_tile``; padded pairs carry scale 0 and scatter
        into a dummy box.

        ``subset=(s, t, cls)`` restricts the tiles to the given pairs
        (the family path's residual); class ids keep indexing the full
        ``m2l_classes.mats`` table."""
        TS = max(8, int(self.config.m2l_tile))
        cls = self.m2l_classes
        dummy_tgt = self.tgt.tree.num_boxes  # extra segment, dropped
        if subset is None:
            groups = [
                (ci, cls.src[ci], cls.tgt[ci])
                for ci in range(len(cls.src))
            ]
        else:
            s_arr, t_arr, c_arr = subset
            groups = []
            if len(s_arr):
                order = np.argsort(c_arr, kind="stable")
                so, to, co = s_arr[order], t_arr[order], c_arr[order]
                b = np.searchsorted(co, np.arange(co.max() + 2))
                for ci in range(len(b) - 1):
                    if b[ci + 1] > b[ci]:
                        groups.append(
                            (ci, so[b[ci]: b[ci + 1]], to[b[ci]: b[ci + 1]])
                        )
        srcs, tgts, tile_cls = [], [], []
        for ci, src_c, tgt_c in groups:
            n = len(src_c)
            ntile = -(-n // TS)
            pad = ntile * TS - n
            srcs.append(src_c)
            tgts.append(tgt_c)
            if pad:
                # padded pairs produce finite garbage (M[0] through the
                # class matrix) that the bucket reduction DROPS via the
                # dummy target segment — no per-pair zero scale needed
                srcs.append(np.zeros(pad, np.int32))
                tgts.append(np.full(pad, dummy_tgt, np.int32))
            tile_cls.append(np.full(ntile, ci, np.int32))
        G = 32  # tiles per scan step (batched einsum width)
        if srcs:
            src = np.concatenate(srcs)
            tgt = np.concatenate(tgts)
            cls_arr = np.concatenate(tile_cls)
            # pad the tile count to a multiple of G with dummy tiles
            ntile = len(cls_arr)
            padt = (-ntile) % G
            if padt:
                src = np.concatenate([src, np.zeros(padt * TS, np.int32)])
                tgt = np.concatenate(
                    [tgt, np.full(padt * TS, dummy_tgt, np.int32)]
                )
                cls_arr = np.concatenate([cls_arr, np.zeros(padt, np.int32)])
            self.m2l_tile_src = src
            self.m2l_tile_tgt = tgt
            self.m2l_tile_cls = cls_arr
        else:
            self.m2l_tile_src = np.zeros(0, np.int32)
            self.m2l_tile_tgt = np.zeros(0, np.int32)
            self.m2l_tile_cls = np.zeros(0, np.int32)
        self.m2l_tile_size = TS
        self.m2l_tile_group = G
        # scatter-free pair -> target-box reduction plan
        from fmm_bem_tpu.ops.bucket_sum import build_bucket_sum

        self.m2l_bsum = build_bucket_sum(
            self.m2l_tile_tgt,
            len(self.m2l_tile_src),
            self.tgt.tree.num_boxes,
        )

    def _build_near(self):
        """P2P leaf pairs and, for BEM kernels, the precomputed sparse
        near field (the array form of EvalInteractionLazySparse's CSR:
        entry values are charge-independent, branchy, p-independent)."""
        st, tt = self.src.tree, self.tgt.tree
        pp = self.lists.p2p_pairs
        if self.config.block_diagonal:
            # leaf self-blocks only (ref EvalDiagonalSparse.hpp:34-50)
            pp = pp[pp[:, 0] == pp[:, 1]]
        self.p2p_src_slot = self.src.box_to_slot[pp[:, 0]].astype(np.int32)
        self.p2p_tgt_slot = self.tgt.box_to_slot[pp[:, 1]].astype(np.int32)

        self.near_rows = self.near_cols = self.near_vals = None
        self._otf_near = False
        # on-the-fly near mode (ref EvalInteractionLazy.hpp:239-252):
        # no cached panel store — the regular quadrature is recomputed
        # inside every matvec and only the O(N) near-singular
        # corrections are cached, as DELTAS vs the regular values
        if (
            self.config.near_mode == "otf"
            and self.config.near_panel
            and getattr(self.kernel, "near_sparse", False)
            and hasattr(self.kernel, "near_block_device")
            and hasattr(self.kernel, "near_regular_entries")
            and getattr(self.kernel, "result_dim", 1) == 1
            and getattr(self.kernel, "charge_dim", 1) == 1
            and len(pp) > 0
        ):
            self._build_near_otf(pp)
            return
        # device-near mode: the regular-quadrature bulk of the near
        # field is evaluated on the accelerator directly in panel-block
        # layout; the host only assembles the near-singular CORRECTION
        # entries (branchy semi-analytical integrals) — see
        # ops/near_panel.build_near_panels_on_device
        self._device_near = (
            self.config.near_panel
            and getattr(self.kernel, "near_sparse", False)
            and hasattr(self.kernel, "near_block_device")
            and len(pp) > 0
        )
        if self._device_near:
            rows, cols = self._near_candidate_entries(pp)
            self.near_rows = np.asarray(rows, np.int32)
            self.near_cols = np.asarray(cols, np.int32)
            self.near_vals = self.kernel.near_values(
                self.tgt.fields, self.src.fields,
                self.near_rows, self.near_cols,
            )
            self._near_panel_cache = {}
            self._near_meta = None
            self._use_panels = True
            return
        if getattr(self.kernel, "near_sparse", False):
            from fmm_bem_tpu import native

            nat = native.near_coo(pp, st, tt) if len(pp) else None
            if nat is not None:
                rows, cols = nat
            else:
                rows, cols = [], []
                for s, tg in pp:
                    ts, tc = tt.box_body_start[tg], tt.box_body_count[tg]
                    ss, sc = st.box_body_start[s], st.box_body_count[s]
                    tb = np.arange(ts, ts + tc, dtype=np.int32)
                    sb = np.arange(ss, ss + sc, dtype=np.int32)
                    rows.append(np.repeat(tb, sc))
                    cols.append(np.tile(sb, tc))
                rows = np.concatenate(rows) if rows else np.zeros(0, np.int32)
                cols = np.concatenate(cols) if cols else np.zeros(0, np.int32)
                order = np.argsort(rows, kind="stable")
                rows, cols = rows[order], cols[order]
            self.near_rows = rows
            self.near_cols = cols
            self.near_vals = self.kernel.near_values(
                self.tgt.fields, self.src.fields, rows, cols
            )
            if self.config.droptol > 0.0 and len(self.near_rows):
                # drop-tolerance inexact near field (ref
                # SparseMatrix.hpp:51-74): an entry survives if ANY of
                # its value components exceeds the threshold (BEM
                # kernels store (G, dGdn) pairs per entry)
                v = np.abs(np.asarray(self.near_vals))
                keep = v.reshape(len(self.near_rows), -1).max(axis=1) \
                    > self.config.droptol
                self.near_rows = self.near_rows[keep]
                self.near_cols = self.near_cols[keep]
                self.near_vals = self.near_vals[keep]
        self._near_panel_cache = {}
        self._near_meta = None
        self._use_panels = (
            self.config.near_panel
            and self.near_rows is not None
            and len(self.near_rows) > 0
            and hasattr(self.kernel, "near_select")
        )

    def _near_candidate_entries(self, pp):
        """Near-SINGULAR entry candidates (sqrt(2A)/d >= 0.5, the ref's
        eval_G branch switch) within the near leaf pairs."""
        st, tt = self.src.tree, self.tgt.tree
        from fmm_bem_tpu import native

        st_xyz = self.src.fields["xyz"]
        tt_xyz = self.tgt.fields["xyz"]
        s_area = self.src.fields["area"]
        nat = native.near_candidates(pp, st, tt, tt_xyz, st_xyz, s_area)
        if nat is not None:
            return nat
        rows, cols = [], []
        ta = np.asarray(tt_xyz)
        sa_ = np.asarray(st_xyz)
        ar = np.asarray(s_area)
        for s, tg in pp:
            tsl = slice(
                tt.box_body_start[tg],
                tt.box_body_start[tg] + tt.box_body_count[tg],
            )
            ssl = slice(
                st.box_body_start[s],
                st.box_body_start[s] + st.box_body_count[s],
            )
            tb = np.arange(tsl.start, tsl.stop, dtype=np.int32)
            sb = np.arange(ssl.start, ssl.stop, dtype=np.int32)
            d2 = ((ta[tsl, None, :] - sa_[None, ssl, :]) ** 2).sum(-1)
            near = 2.0 * ar[None, ssl] >= 0.25 * d2
            ti, si = np.nonzero(near)
            rows.append(tb[ti])
            cols.append(sb[si])
        rows = np.concatenate(rows) if rows else np.zeros(0, np.int32)
        cols = np.concatenate(cols) if cols else np.zeros(0, np.int32)
        return rows, cols

    def _build_near_otf(self, pp):
        """On-the-fly near mode (FMMConfig.near_mode="otf"): cache only
        the near-singular corrections as DELTAS vs the regular K-point
        quadrature; the per-iteration device product recomputes the
        regular quadrature for every near pair (see _near_otf_core) —
        the reference's memory-free plain lazy evaluator
        (EvalInteractionLazy.hpp:239-252) as a chunked batched op."""
        st, tt = self.src.tree, self.tgt.tree
        kern = self.kernel
        rows, cols = self._near_candidate_entries(pp)
        rows = np.asarray(rows, np.int32)
        cols = np.asarray(cols, np.int32)
        corr = np.asarray(
            kern.near_values(self.tgt.fields, self.src.fields, rows, cols)
        )
        reg = np.asarray(
            kern.near_regular_entries(
                self.tgt.fields, self.src.fields, rows, cols
            )
        )
        # correction DELTAS in leaf-aligned value windows: a target
        # body's ~25 near-singular corrections cluster in 2-4 source
        # LEAVES, so grouping per (target slot, source leaf) lets the
        # per-iteration product gather whole 256 B charge tiles and
        # dense-reduce instead of a sorted COO's scalar gathers and
        # scatter
        row_slot = self.tgt.body_flat_slot[rows]
        order = np.argsort(row_slot, kind="stable")
        self.near_rows = rows[order]
        self.near_cols = cols[order]
        self.near_vals = (corr - reg)[order]
        self._otf_corr_rows = row_slot[order].astype(np.int32)
        self._otf_corr_cols = self.src.body_flat_slot[
            self.near_cols
        ].astype(np.int32)
        K_s = self.src.leaf_pad
        nl_s = len(self.src.leaf_ids)
        gk = self._otf_corr_rows.astype(np.int64) * (nl_s + 1) + (
            self._otf_corr_cols // K_s
        )
        ug, ginv = np.unique(gk, return_inverse=True)
        G = len(ug)
        self._otf_corr_ginv = ginv.astype(np.int64)
        self._otf_corr_gleaf = (ug % (nl_s + 1)).astype(np.int32)
        grow = (ug // (nl_s + 1)).astype(np.int64)
        # per-target-slot group lists (groups are row-major sorted)
        urow, rinv = np.unique(grow, return_inverse=True)
        R = len(urow)
        fan = np.bincount(rinv)
        Fw = int(max(fan.max(initial=1), 1))
        gidx = np.full((R, Fw), G, np.int32)
        korder = np.argsort(rinv, kind="stable")
        kk = np.concatenate([np.arange(c) for c in fan]) if R else \
            np.zeros(0, np.int64)
        gidx[rinv[korder], kk] = korder.astype(np.int32)
        nslots_t = len(self.tgt.leaf_ids) * self.tgt.leaf_pad
        row_of_slot = np.full(nslots_t, R, np.int32)
        row_of_slot[urow] = np.arange(R, dtype=np.int32)
        self._otf_corr_gidx = gidx
        self._otf_corr_rowof = row_of_slot
        # beyond ~1 GB of (mostly-empty) leaf windows, fall back to
        # padded-row entry lists: slower per iteration (scalar charge
        # gathers) but 4-8x smaller — the 2.1M-panel windows hit
        # 1.7 GB at ~12% density
        self._otf_corr_windowed = (
            G * K_s * np.dtype(self.config.dtype).itemsize
            <= _OTF_WINDOW_LIMIT
        )
        if not self._otf_corr_windowed:
            erow, einv = np.unique(
                self._otf_corr_rows, return_inverse=True
            )
            Re = len(erow)
            fan_e = np.bincount(einv)
            We = int(-(-int(fan_e.max(initial=1)) // 8) * 8)
            colp = np.zeros((Re, We), np.int32)
            eorder = np.argsort(einv, kind="stable")
            ke = np.concatenate([np.arange(c) for c in fan_e])
            colp[einv[eorder], ke] = self._otf_corr_cols[eorder]
            self._otf_corr_colp = colp
            self._otf_corr_eorder = (einv[eorder], ke, eorder)
            rowse = np.full(nslots_t, Re, np.int32)
            rowse[erow] = np.arange(Re, dtype=np.int32)
            self._otf_corr_rowof_e = rowse
        self._otf_near = True
        self._device_near = False
        self._use_panels = True
        self._near_panel_cache = {}
        self._near_meta = None
        # full near-pair slot arrays, target-sorted, chunk-padded
        ss, ts = self.p2p_src_slot, self.p2p_tgt_slot
        order = np.lexsort((ss, ts))
        ch = max(8, int(self.config.near_otf_chunk))
        npp = len(order)
        pad = (-npp) % ch
        self._otf_sslot = np.concatenate(
            [ss[order], np.full(pad, len(self.src.leaf_ids), np.int32)]
        ).astype(np.int32)
        self._otf_tslot = np.concatenate(
            [ts[order], np.full(pad, len(self.tgt.leaf_ids), np.int32)]
        ).astype(np.int32)
        self._otf_chunk = ch
    def near_panels(self, tgt_fields_host=None):
        """Bucketed leaf-panel form of the near field for one BC
        variant (see ops/near_panel.py) — device arrays, cached per
        variant.  Returns (device_dict, meta) or (None, None)."""
        if not self._use_panels:
            return None, None
        from fmm_bem_tpu.ops.near_panel import (
            build_near_panels,
            build_near_panels_on_device,
        )

        tf = tgt_fields_host if tgt_fields_host is not None else \
            self.tgt.fields
        bc = np.asarray(tf.get("bc", np.zeros(0)))
        key = bc.tobytes()
        if key not in self._near_panel_cache:
            vsel = self.kernel.near_select(
                self.near_vals, bc[self.near_rows] if len(bc) else None
            )
            if getattr(self, "_otf_near", False):
                dev = {"otf_tiles": self._otf_tiles(tf)}
                if len(self.near_rows) and self._otf_corr_windowed:
                    K_s = self.src.leaf_pad
                    G = len(self._otf_corr_gleaf)
                    valw = np.zeros((G, K_s), np.dtype(self.config.dtype))
                    valw[
                        self._otf_corr_ginv,
                        self._otf_corr_cols % K_s,
                    ] = vsel
                    dev["corr_valw"] = jnp.asarray(valw)
                    dev["corr_gleaf"] = jnp.asarray(self._otf_corr_gleaf)
                    dev["corr_gidx"] = jnp.asarray(self._otf_corr_gidx)
                    dev["corr_rowof"] = jnp.asarray(self._otf_corr_rowof)
                elif len(self.near_rows):
                    ei, ke, eorder = self._otf_corr_eorder
                    valp = np.zeros(
                        self._otf_corr_colp.shape,
                        np.dtype(self.config.dtype),
                    )
                    valp[ei, ke] = vsel[eorder]
                    dev["corr_colp"] = jnp.asarray(self._otf_corr_colp)
                    dev["corr_valp"] = jnp.asarray(valp)
                    dev["corr_rowof_e"] = jnp.asarray(
                        self._otf_corr_rowof_e
                    )
                self._near_panel_cache[key] = dev
                if len(self._near_panel_cache) > 4:
                    self._near_panel_cache.pop(
                        next(iter(self._near_panel_cache))
                    )
                return self._near_panel_cache[key], self._near_meta
            if getattr(self, "_device_near", False):
                dev, meta = build_near_panels_on_device(
                    self.p2p_src_slot,
                    self.p2p_tgt_slot,
                    self.src,
                    self.tgt,
                    len(self.tgt.leaf_ids),
                    self._near_blocks_fn(tf),
                    corr=(self.near_rows, self.near_cols, vsel),
                    rdim=getattr(self.kernel, "result_dim", 1),
                    cdim=getattr(self.kernel, "charge_dim", 1),
                    dtype=self.config.dtype,
                    jit_cache=self.__dict__.setdefault(
                        "_panel_jit_cache", {}
                    ),
                )
                self._near_meta = meta
                self._near_panel_cache[key] = dev
            else:
                panels = build_near_panels(
                    self.p2p_src_slot,
                    self.p2p_tgt_slot,
                    self.near_rows,
                    self.near_cols,
                    vsel,
                    self.src,
                    self.tgt,
                    len(self.tgt.leaf_ids),
                    dtype=np.dtype(self.config.dtype),
                )
                self._near_meta = panels
                self._near_panel_cache[key] = panels.device(
                    self.config.dtype
                )
            if len(self._near_panel_cache) > 4:
                self._near_panel_cache.pop(
                    next(iter(self._near_panel_cache))
                )
        return self._near_panel_cache[key], self._near_meta

    def _otf_tiles(self, tgt_fields_host):
        """Leaf-tiled panel-field tables for the on-the-fly near
        product, with one appended dummy (zero/masked) leaf row so
        chunk padding indexes safely."""
        dt = jnp.dtype(self.config.dtype)

        def tiles(side, host_fields):
            idx = side.leaf_body_idx  # [nl, K]
            out = {}
            for k, v in host_fields.items():
                if k == "vertices":
                    continue
                a = np.asarray(v)[idx]
                pad = np.zeros((1,) + a.shape[1:], a.dtype)
                out[k] = jnp.asarray(np.concatenate([a, pad]), dt)
            m = np.concatenate(
                [side.leaf_body_mask,
                 np.zeros((1, side.leaf_pad), bool)]
            )
            return out, jnp.asarray(m)

        s_tiles, s_mask = tiles(self.src, self.src.fields)
        t_host = dict(self.tgt.fields)
        t_host["bc"] = tgt_fields_host.get("bc", t_host.get("bc"))
        t_tiles, t_mask = tiles(self.tgt, t_host)
        out = {
            "s_tiles": s_tiles,
            "t_tiles": t_tiles,
            "s_mask": s_mask,
            "t_mask": t_mask,
            "sslot": jnp.asarray(self._otf_sslot),
            "tslot": jnp.asarray(self._otf_tslot),
        }
        return out

    def _near_otf_core(self, dev, ql):
        """On-the-fly near product from leaf-tiled charges: chunked
        regular-quadrature blocks recomputed on device + the cached
        correction-delta panel product.  Returns [nl_t, KT*rdim]."""
        kern = self.kernel
        rdim = kern.result_dim
        KT = self.tgt.leaf_pad
        nl_t = len(self.tgt.leaf_ids)
        ot = dev["otf_tiles"]
        sslot, tslot = ot["sslot"], ot["tslot"]
        ch = self._otf_chunk  # static (baked into the trace)
        nch = sslot.shape[0] // ch
        qlz = jnp.concatenate(
            [ql, jnp.zeros((1, ql.shape[1]), ql.dtype)], axis=0
        )
        s_tiles, t_tiles = ot["s_tiles"], ot["t_tiles"]
        s_mask, t_mask = ot["s_mask"], ot["t_mask"]

        def one(args):
            ssl, tsl = args
            sf = {k: v[ssl] for k, v in s_tiles.items()}
            tf = {k: v[tsl] for k, v in t_tiles.items()}
            blocks = jax.vmap(kern.near_block_device)(
                tf, sf, t_mask[tsl], s_mask[ssl]
            )
            return jnp.einsum("cts,cs->ct", blocks, qlz[ssl])

        outs = jax.lax.map(
            one, (sslot.reshape(nch, ch), tslot.reshape(nch, ch))
        )
        out = outs.reshape(nch * ch, KT * rdim)
        seg = jax.ops.segment_sum(
            out, tslot, num_segments=nl_t + 1,
            indices_are_sorted=True,
        )
        res = seg[:nl_t]
        res = self._near_otf_corr(dev, ql, res, nl_t, KT)
        return res

    def _near_otf_corr(self, dev, ql, res, nl_t, KT):
        """Correction-delta product: leaf-tile charge gathers per
        (target slot, source leaf) group, dense window reduce, then
        two small gathers back to slot rows (scatter-free).  The
        padded-row variant (corr_colp) trades scalar charge gathers
        for a 4-8x smaller store at multi-million-panel sizes."""
        if "corr_valw" in dev:
            qlz = jnp.concatenate(
                [ql, jnp.zeros((1, ql.shape[1]), ql.dtype)], axis=0
            )
            qg = qlz[dev["corr_gleaf"]]        # [G, K] 256 B rows
            s_g = jnp.sum(dev["corr_valw"] * qg, axis=1)
            s_g = jnp.concatenate([s_g, jnp.zeros(1, ql.dtype)])
            rs = jnp.sum(s_g[dev["corr_gidx"]], axis=1)
            rs = jnp.concatenate([rs, jnp.zeros(1, ql.dtype)])
            corr = rs[dev["corr_rowof"]]
            return res + corr.reshape(nl_t, KT)
        if "corr_colp" in dev:
            qlf = ql.reshape(-1)
            rows = jnp.sum(
                dev["corr_valp"] * qlf[dev["corr_colp"]], axis=1
            )
            rows = jnp.concatenate([rows, jnp.zeros(1, ql.dtype)])
            corr = rows[dev["corr_rowof_e"]]
            return res + corr.reshape(nl_t, KT)
        return res

    def _near_blocks_fn(self, tgt_fields_host):
        """Jitted device builder of the regular-quadrature interaction
        blocks for the (sorted) near leaf-pair lists."""
        import jax

        kern = self.kernel
        dt = jnp.dtype(self.config.dtype)
        sfd = {
            k: jnp.asarray(v, dt)
            for k, v in self.src.fields.items()
            if k != "vertices"
        }
        tf = dict(self.tgt.fields)
        tf["bc"] = tgt_fields_host.get("bc", tf.get("bc"))
        tfd = {
            k: jnp.asarray(v, dt)
            for k, v in tf.items()
            if k != "vertices"
        }
        sbi = jnp.asarray(self.src.leaf_body_idx)
        sbm = jnp.asarray(self.src.leaf_body_mask)
        tbi = jnp.asarray(self.tgt.leaf_body_idx)
        tbm = jnp.asarray(self.tgt.leaf_body_mask)

        if not hasattr(self, "_near_blocks_jit"):
            # one compiled executable reused across BC variants
            def build(sfd, tfd, sbi, sbm, tbi, tbm, ss, ts):
                sf_rows = {k: v[sbi[ss]] for k, v in sfd.items()}
                tf_rows = {k: v[tbi[ts]] for k, v in tfd.items()}
                return jax.vmap(kern.near_block_device)(
                    tf_rows, sf_rows, tbm[ts], sbm[ss]
                )

            self._near_blocks_jit = jax.jit(build)

        build = self._near_blocks_jit
        return lambda ss, ts: build(sfd, tfd, sbi, sbm, tbi, tbm, ss, ts)

    # ------------------------------------------------------------------
    # device data per p-tier
    # ------------------------------------------------------------------
    def _slice_mats(self, mats, p):
        """Prefix-truncate translation matrices to width(p) (degree-
        ordered layouts make lower p a prefix slice)."""
        W = self.kernel.width(p)
        return mats[..., :W, :W]

    def _device_data(self, p):
        # p-independent arrays are built ONCE and shared by reference
        # across every per-p dict: the fused tier cascade passes one
        # operand pytree per tier in a single dispatch, and aliased
        # buffers keep both the marshalling cost and device memory at
        # 1x instead of (#tiers)x
        common = getattr(self, "_ddata_common", None)
        if common is None:
            common = self._device_data_common()
            self._ddata_common = common
        d = dict(common)
        cfg = self.config
        dt = jnp.dtype(cfg.dtype)
        d["m2l_mats"] = jnp.asarray(
            self._slice_mats(self.m2l_classes.mats, p), dt
        )
        if getattr(self, "m2l_fam", None) is not None:
            d["fam_mats"] = jnp.asarray(self._slice_fam_mats(p), dt)
        d["m2m_lvl_mats"] = self._level_mats(self.src, "m2m", p)
        d["l2l_lvl_mats"] = self._level_mats(self.tgt, "l2l", p)
        return d

    def _level_mats(self, side, kind, p):
        """Per level, the eight octant operators of the batched M2M/L2L
        as one matmul operand: M2M [8W, W] (contraction over octant and
        term), L2L [W, 8W] (one column block per octant)."""
        W = self.kernel.width(p)
        mats = getattr(side, f"{kind}_mats")[..., :W, :W]
        dt = jnp.dtype(self.config.dtype)
        out = []
        for g in side.level_groups:
            if g is None:
                out.append(None)
                continue
            T = mats[g[2]]  # [8, W(out), W(in)]
            if kind == "m2m":
                out.append(jnp.asarray(
                    T.transpose(0, 2, 1).reshape(8 * W, W), dt
                ))
            else:
                out.append(jnp.asarray(
                    T.transpose(2, 0, 1).reshape(W, 8 * W), dt
                ))
        return out

    def _device_data_common(self):
        cfg = self.config
        dt = jnp.dtype(cfg.dtype)

        def side_data(side, prefix):
            return {
                f"{prefix}xyz": jnp.asarray(side.tree.points, dt),
                f"{prefix}perm": jnp.asarray(side.tree.perm, jnp.int32),
                f"{prefix}inv_perm": jnp.asarray(
                    np.argsort(side.tree.perm).astype(np.int32)
                ),
                f"{prefix}leaf_ids": jnp.asarray(side.leaf_ids),
                f"{prefix}body_dnorm": jnp.asarray(side.body_dnorm, dt),
                f"{prefix}body_inv_sigma": jnp.asarray(side.body_inv_sigma, dt),
                f"{prefix}body_leaf_box": jnp.asarray(side.body_leaf_box),
                f"{prefix}body_flat_slot": jnp.asarray(side.body_flat_slot),
                f"{prefix}leaf_body_idx": jnp.asarray(side.leaf_body_idx),
                f"{prefix}leaf_body_mask": jnp.asarray(side.leaf_body_mask),
                # flat [nl*K] mask for the slot-space matvec
                f"{prefix}slot_mask": jnp.asarray(
                    side.leaf_body_mask.reshape(-1)
                ),
            }

        d = side_data(self.src, "s_")
        d.update(side_data(self.tgt, "t_") if self.dual else
                 {k.replace("s_", "t_", 1): v for k, v in d.items()})
        d.update(
            {
                "m2l_tile_src": jnp.asarray(self.m2l_tile_src),
                "m2l_tile_tgt": jnp.asarray(self.m2l_tile_tgt),
                "m2l_tile_cls": jnp.asarray(self.m2l_tile_cls),
                "m2l_bsum": self.m2l_bsum.device(),
                "p2p_src_slot": jnp.asarray(self.p2p_src_slot),
                "p2p_tgt_slot": jnp.asarray(self.p2p_tgt_slot),
                "m2p_src": jnp.asarray(self.m2p_src),
                "m2p_tgt_slot": jnp.asarray(self.m2p_tgt_slot),
                "m2p_inv_sigma": jnp.asarray(self.m2p_inv_sigma, dt),
                "s_box_center": jnp.asarray(self.src.tree.box_center, dt),
            }
        )
        if getattr(self, "m2l_fam", None) is not None:
            f = self.m2l_fam
            d.update(
                {
                    "fam_src_child": jnp.asarray(
                        np.maximum(f.src_child, 0)
                    ),
                    "fam_src_mask": jnp.asarray(
                        (f.src_child >= 0).astype(np.dtype(cfg.dtype))
                        * f.src_scale[:, None]
                    ),
                    "fam_cls_sp": tuple(
                        jnp.asarray(a) for a in f.cls_sp
                    ),
                    "fam_bsum": f.bsum.device(),
                    "fam_out_idx": jnp.asarray(
                        np.minimum(f.out_idx, max(f.nutp * 8 - 1, 0))
                    ),
                    "fam_out_mask": jnp.asarray(
                        (f.out_idx < f.nutp * 8).astype(
                            np.dtype(cfg.dtype)
                        )
                    ),
                }
            )
        if self.near_rows is not None and not self._use_panels:
            # COO upload only when the panel path is off: the panel
            # arrays replace it entirely
            d["near_rows"] = jnp.asarray(self.near_rows)
            d["near_cols"] = jnp.asarray(self.near_cols)
            d["near_vals"] = jnp.asarray(self.near_vals, dt)

        def level_arrays(side):
            return [
                None if g is None
                else (jnp.asarray(g[0]), jnp.asarray(g[1]))
                for g in side.level_groups
            ]

        d["src_lvl"] = level_arrays(self.src)
        d["tgt_lvl"] = (
            d["src_lvl"] if not self.dual else level_arrays(self.tgt)
        )
        return d

    def device_fields(self, fields=None, side="src"):
        dt = jnp.dtype(self.config.dtype)
        if fields is None:
            # cache the default-field device arrays: uploading them per
            # matvec costs a host->device transfer every call
            cache = getattr(self, "_devfields_cache", {})
            if side not in cache:
                base = (self.src if side == "src" else self.tgt).fields
                cache[side] = {
                    k: jnp.asarray(v, dt)
                    for k, v in base.items()
                    if k != "vertices"
                }
                self._devfields_cache = cache
            return cache[side]
        key = id(fields)
        cache = getattr(self, "_fields_id_cache", {})
        if key not in cache:
            cache[key] = {
                k: jnp.asarray(v, dt)
                for k, v in fields.items()
                if k != "vertices"  # host-only geometry
            }
            # bounded cache (flipped + a few overrides)
            if len(cache) > 8:
                cache.pop(next(iter(cache)))
            self._fields_id_cache = cache
        return cache[key]

    # ------------------------------------------------------------------
    # the matvec
    # ------------------------------------------------------------------
    def variant_aux(self, p, src_host=None, tgt_host=None):
        """Per-(BC-variant, p) device auxiliaries: near panels + the
        precomputed linear P2M / L2P tables.

        P2M and L2P are linear maps (multipole of a charge distribution
        / evaluation of a local expansion), but their harmonic
        recurrences are recomputed per call if left inline — XLA does
        not hoist them out of solver loops.  The tables bake them once:
            P2M:  contrib = q * T_p2m         (unit-charge trick)
            L2P:  res     = sum_cw L * T_l2p  (kernel-provided table)
        Tables depend on the BC flags (component selection), hence the
        per-variant cache keyed like the near panels.
        """
        sfh = src_host if src_host is not None else self.src.fields
        tfh = tgt_host if tgt_host is not None else self.tgt.fields
        bc_s = np.asarray(sfh.get("bc", np.zeros(0)))
        bc_t = np.asarray(tfh.get("bc", np.zeros(0)))
        p = min(int(p), self.config.max_p)
        key = (bc_s.tobytes(), bc_t.tobytes(), p)
        cache = getattr(self, "_aux_cache", {})
        if key in cache:
            return cache[key]

        aux = {}
        panels, _ = self.near_panels(tfh)
        if panels is not None:
            aux["panels"] = panels
        aux.update(self.body_tables(p, src_host, tgt_host))
        cache[key] = aux
        if len(cache) > 8:
            cache.pop(next(iter(cache)))
        self._aux_cache = cache
        return aux

    def body_tables(self, p, src_host=None, tgt_host=None):
        """The linear P2M / L2P tables of ``variant_aux`` alone (no near
        store), for callers that keep their own near field."""
        import jax

        kern = self.kernel
        sfh = src_host if src_host is not None else self.src.fields
        tfh = tgt_host if tgt_host is not None else self.tgt.fields
        bc_s = np.asarray(sfh.get("bc", np.zeros(0)))
        bc_t = np.asarray(tfh.get("bc", np.zeros(0)))
        p = min(int(p), self.config.max_p)
        aux = {}
        dt = jnp.dtype(self.config.dtype)
        pmax = self.config.max_p
        W = kern.width(p)
        cdim = getattr(kern, "charge_dim", 1)
        full_key = (bc_s.tobytes(), bc_t.tobytes(), pmax)
        if getattr(kern, "linear_p2m", True):
            fcache = getattr(self, "_p2m_tab_cache", {})
            if full_key not in fcache:
                sfd = self.device_fields(
                    sfh if src_host is not None else None, "src"
                )
                dn = jnp.asarray(self.src.body_dnorm, dt)
                isig = jnp.asarray(self.src.body_inv_sigma, dt)
                n = self.src.tree.num_bodies

                if not hasattr(self, "_p2m_tab_fn"):
                    # one jitted builder reused across BC variants
                    # (harmonic recurrences compile slowly at max_p)
                    def tab_fn(sfd, dn, isig):
                        if cdim == 1:
                            return kern.p2m(
                                sfd, jnp.ones(n, dt), dn, isig, pmax
                            )
                        cols = []
                        for c in range(cdim):
                            e = jnp.zeros((n, cdim), dt).at[:, c].set(1.0)
                            cols.append(kern.p2m(sfd, e, dn, isig, pmax))
                        return jnp.stack(cols)  # [cdim, n, ncomp, W]

                    self._p2m_tab_fn = jax.jit(tab_fn)
                fcache[full_key] = self._p2m_tab_fn(sfd, dn, isig)
                self._p2m_tab_cache = fcache
                if len(fcache) > 4:
                    fcache.pop(next(iter(fcache)))
            t3 = fcache[full_key][..., :W]  # [(cdim,) n, ncomp, W]
            aux["p2m_tab"] = t3.reshape(t3.shape[:-2] + (-1,))
        if hasattr(kern, "l2p_table"):
            lcache = getattr(self, "_l2p_tab_cache", {})
            if full_key not in lcache:
                tfd = self.device_fields(
                    tfh if tgt_host is not None else None,
                    "tgt" if self.dual else "src",
                )
                dn = jnp.asarray(self.tgt.body_dnorm, dt)
                isig = jnp.asarray(self.tgt.body_inv_sigma, dt)
                if not hasattr(self, "_l2p_tab_fn"):
                    self._l2p_tab_fn = jax.jit(
                        lambda f, dn, isig: kern.l2p_table(f, dn, isig, pmax)
                    )
                lcache[full_key] = self._l2p_tab_fn(tfd, dn, isig)
                self._l2p_tab_cache = lcache
                if len(lcache) > 4:
                    lcache.pop(next(iter(lcache)))
            t4 = lcache[full_key][..., :W, :]  # [n, ncomp, W, rdim]
            aux["l2p_tab"] = t4.reshape(t4.shape[0], -1, t4.shape[-1])
        return aux

    def variant_aux_slots(self, p, src_host=None, tgt_host=None):
        """variant_aux extended with SLOT-layout tables for the
        tile-resident matvec: the per-body P2M/L2P tables (or field
        rows) gathered ONCE into the padded leaf-tile ordering, so the
        per-iteration matvec does no body-index gathers at all.

        Motive: per-matvec charge/result/table gathers between body
        order and leaf-tile order are random short-row moves on every
        iteration; the slot layout removes them.
        """
        sfh = src_host if src_host is not None else self.src.fields
        tfh = tgt_host if tgt_host is not None else self.tgt.fields
        bc_s = np.asarray(sfh.get("bc", np.zeros(0)))
        bc_t = np.asarray(tfh.get("bc", np.zeros(0)))
        p = min(int(p), self.config.max_p)
        key = (bc_s.tobytes(), bc_t.tobytes(), p)
        cache = getattr(self, "_aux_slots_cache", {})
        if key in cache:
            return cache[key]

        aux = dict(self.variant_aux(p, src_host, tgt_host))
        dt = jnp.dtype(self.config.dtype)
        s_idx = jnp.asarray(self.src.leaf_body_idx.reshape(-1))
        s_msk = jnp.asarray(self.src.leaf_body_mask.reshape(-1))
        t_idx = jnp.asarray(self.tgt.leaf_body_idx.reshape(-1))
        t_msk = jnp.asarray(self.tgt.leaf_body_mask.reshape(-1))
        # one jitted call per table instead of eager op-by-op dispatch
        jits = self.__dict__.setdefault("_slot_tab_jits", {})
        nl_s, K_s = len(self.src.leaf_ids), self.src.leaf_pad
        nl_t, K_t = len(self.tgt.leaf_ids), self.tgt.leaf_pad
        if "to2" not in jits:
            # k-major P2M [K, nl, cW] and w-major L2P [rdim, cW, nl, K]
            # layouts: the contraction axis leads, so the phase is a
            # leading-axis tile accumulation instead of the slot-major
            # layouts' minor-axis segment-reduce (over K for P2M, over
            # cW for L2P), which streams poorly at large N.
            jits["to2"] = jax.jit(
                lambda tab, idx, msk: jnp.transpose(
                    jnp.where(msk[:, None], tab[..., idx, :], 0.0)
                    .reshape(nl_s, K_s, -1),
                    (1, 0, 2),
                )
            )
            jits["to3"] = jax.jit(
                lambda tab, idx, msk: jnp.transpose(
                    jnp.where(msk[None, :, None], tab[..., idx, :], 0.0)
                    .reshape(tab.shape[0], nl_s, K_s, -1),
                    (0, 2, 1, 3),
                )
            )
            jits["l2p_t"] = jax.jit(
                lambda tab, idx, msk: jnp.transpose(
                    jnp.where(msk[:, None, None], tab[idx], 0.0)
                    .reshape(nl_t, K_t, tab.shape[1], tab.shape[2]),
                    (3, 2, 0, 1),
                )
            )

        if "p2m_tab" in aux:
            tab = aux["p2m_tab"]  # [n, cW] or [cdim, n, cW]
            aux["p2m_tab_t"] = (
                jits["to2"] if tab.ndim == 2 else jits["to3"]
            )(tab, s_idx, s_msk)
        else:
            sfd = self.device_fields(
                sfh if src_host is not None else None, "src"
            )
            aux["s_fields_t"] = {k: v[s_idx] for k, v in sfd.items()}
            aux["s_dn_t"] = jnp.asarray(self.src.body_dnorm, dt)[s_idx]
            aux["s_isig_t"] = jnp.asarray(
                self.src.body_inv_sigma, dt
            )[s_idx]
        if "l2p_tab" in aux:
            # w-major [rdim, cW, nl, K]: the cW contraction axis leads
            # (see the layout note above), and a trailing rdim=1 axis
            # never reaches the tiled dims
            aux["l2p_tab_t"] = jits["l2p_t"](
                aux["l2p_tab"], t_idx, t_msk
            )
        else:
            tfd = self.device_fields(
                tfh if tgt_host is not None else None,
                "tgt" if self.dual else "src",
            )
            aux["t_fields_t"] = {k: v[t_idx] for k, v in tfd.items()}
            aux["t_dn_t"] = jnp.asarray(self.tgt.body_dnorm, dt)[t_idx]
            aux["t_isig_t"] = jnp.asarray(
                self.tgt.body_inv_sigma, dt
            )[t_idx]
        cache[key] = aux
        if len(cache) > 8:
            cache.pop(next(iter(cache)))
        self._aux_slots_cache = cache
        return aux

    def _near_pass(self, d, panels, tfields, qm):
        """Near field from the leaf panels (ops/near_panel.py):
        leaf-tiled charges -> one dense row-panel contraction per target
        leaf -> body rows.  Replaces a COO gather/scatter replay."""
        from fmm_bem_tpu.ops.near_panel import panel_matvec

        kern = self.kernel
        cdim = getattr(kern, "charge_dim", 1)
        rdim = kern.result_dim
        nl_t = len(self.tgt.leaf_ids)
        K_t = self.tgt.leaf_pad
        qg = qm[d["s_leaf_body_idx"]]
        mask = d["s_leaf_body_mask"]
        if cdim > 1:
            qg = jnp.where(mask[..., None], qg, 0.0)
            ql = qg.reshape(qg.shape[0], qg.shape[1] * cdim)
        else:
            ql = jnp.where(mask, qg, 0.0)
        if isinstance(panels, dict) and "otf_tiles" in panels:
            out_leaf = self._near_otf_core(panels, ql)
        else:
            out_leaf = panel_matvec(panels, self._near_meta, ql)
        return out_leaf.reshape(nl_t * K_t, rdim)[d["t_body_flat_slot"]]

    # ------------------------------------------------------------------
    # matvec phases (split out so utils/roofline.py can time each one
    # and so the LET layer shares the same op shapes)
    # ------------------------------------------------------------------
    def _phase_p2m(self, d, aux, sfields, qm, p):
        """P2M (ref EvalInteractionLazy.hpp:254-260, batched).
        Linear-map table when available (charges x precomputed per-body
        expansion contributions), else the kernel op.  Leaf-tile
        reduction instead of a per-element segment_sum: bodies are
        gathered into [nl, K] leaf tiles and summed densely (no
        per-element scatter-add), then ONE row scatter of nl
        leaf expansions into the box table.  Expansions live FLAT as
        [*, ncomp*W], one wide contiguous row per box (see
        m2m_level)."""
        kern = self.kernel
        st = self.src.tree
        dt = jnp.dtype(self.config.dtype)
        cW = kern.ncomp * kern.width(p)
        if "p2m_tab" in aux:
            tab = aux["p2m_tab"]  # [n, cW] or [cdim, n, cW]
            if qm.ndim == 1:
                contrib = qm[:, None] * tab
            else:
                contrib = jnp.einsum("nc,cnw->nw", qm, tab)
        else:
            contrib = kern.p2m(
                sfields, qm, d["s_body_dnorm"], d["s_body_inv_sigma"], p
            ).reshape(-1, cW)
        ct = contrib[d["s_leaf_body_idx"]]
        ct = jnp.where(d["s_leaf_body_mask"][..., None], ct, 0.0)
        return (
            jnp.zeros((st.num_boxes, cW), dt)
            .at[d["s_leaf_ids"]]
            .set(jnp.sum(ct, axis=1))
        )

    def _phase_m2m(self, d, M):
        """M2M bottom-up, one level at a time (replaces the reference's
        serial child->parent walk): every parent gathers its up-to-8
        children (missing ones read as zero rows) and ONE matmul applies
        all eight octant operators, contracting over octant and term."""
        for lvl in range(self.src.tree.num_levels - 1, 0, -1):
            if d["src_lvl"][lvl - 1] is not None:
                parents, kids = d["src_lvl"][lvl - 1]
                M = m2m_level(M, parents, kids, d["m2m_lvl_mats"][lvl - 1],
                              self.kernel.ncomp)
        return M

    def _matvec(self, d, sfields, tfields, q, p, aux=None):
        kern = self.kernel
        aux = aux or {}
        panels = aux.get("panels")
        st, tt = self.src.tree, self.tgt.tree
        W = kern.width(p)
        dt = jnp.dtype(self.config.dtype)
        nl_t = len(self.tgt.leaf_ids)
        K_t = self.tgt.leaf_pad
        ncomp = kern.ncomp
        cW = ncomp * W

        qm = jnp.asarray(q, dt)[d["s_perm"]]

        M = self._phase_p2m(d, aux, sfields, qm, p)
        M = self._phase_m2m(d, M)

        res_m = jnp.zeros((tt.num_bodies, kern.result_dim), dt)

        if self.config.local_evaluation or self.config.block_diagonal:
            # near-field-only operator (ref EvalLocal(Sparse) /
            # EvalDiagonalSparse): skip the entire far field
            if self.near_rows is not None:
                if panels is not None:
                    res_m = res_m + self._near_pass(d, panels, tfields, qm)
                elif len(self.near_rows):
                    res_m = res_m + kern.near_matvec(
                        d["near_vals"], d["near_rows"], d["near_cols"],
                        tfields, qm, tt.num_bodies,
                    )
            elif len(self.p2p_src_slot):
                res_m = res_m + self._p2p_pass(
                    d, sfields, tfields, qm,
                    len(self.tgt.leaf_ids), self.tgt.leaf_pad,
                )
            return res_m[d["t_inv_perm"]]

        L = self._phase_m2l(d, M, p)

        if self.config.evaluator == Evaluator.FMM:
            L = self._phase_l2l(d, L)
            res_m = res_m + self._phase_l2p(d, aux, tfields, L, p)

        # ---- M2P (treecode far field and/or skew fallback)
        if len(self.m2p_src):
            res_m = res_m + self._m2p_pass(d, tfields, M, p, nl_t, K_t, dt)

        # ---- near field: leaf panels (BEM), precomputed sparse
        # values (fallback), or direct P2P
        if self.near_rows is not None:
            if panels is not None:
                res_m = res_m + self._near_pass(d, panels, tfields, qm)
            elif len(self.near_rows):
                res_m = res_m + kern.near_matvec(
                    d["near_vals"],
                    d["near_rows"],
                    d["near_cols"],
                    tfields,
                    qm,
                    tt.num_bodies,
                )
        elif len(self.p2p_src_slot):
            res_m = res_m + self._p2p_pass(d, sfields, tfields, qm, nl_t, K_t)

        # back to user ordering (inverse-permutation GATHER, not scatter)
        return res_m[d["t_inv_perm"]]

    def _matvec_slots(self, d, aux, sfields, tfields, q_t, p):
        """Tile-resident matvec: charges and results live in the padded
        leaf-slot layout (flattened [nl*K] tiles) end to end.

        The body-order matvec (``_matvec``) gathers charges into leaf
        tiles and scatters results back to body order EVERY iteration
        (random short-row gathers).  Keeping the Krylov
        vectors in slot layout makes them one-time solve-entry/exit
        conversions instead (``solver_ops_slots``):

        - P2M consumes the slot-ordered linear table directly and
          reduces leaf tiles with a dense reshape-sum;
        - the near-field panels and P2P/M2P leaf passes are natively
          tile-shaped (ref EvalInteractionLazySparse.hpp:134-150 role);
        - L2P broadcasts each leaf's local expansion over its tile
          (one [nl]-row gather instead of [n]).

        Padded slots stay exactly zero through every phase, so solver
        dot products and norms need no masking.
        """
        kern = self.kernel
        st, tt = self.src.tree, self.tgt.tree
        dt = jnp.dtype(self.config.dtype)
        cdim = getattr(kern, "charge_dim", 1)
        rdim = kern.result_dim
        nl_s, K_s = len(self.src.leaf_ids), self.src.leaf_pad
        nl_t, K_t = len(self.tgt.leaf_ids), self.tgt.leaf_pad
        cW = kern.ncomp * kern.width(p)

        smask = d["s_slot_mask"]
        if cdim > 1:
            q_t = q_t.reshape(nl_s * K_s, cdim)
            q_t = jnp.where(smask[:, None], q_t, 0.0)
        else:
            q_t = jnp.where(smask, q_t.reshape(nl_s * K_s), 0.0)

        # ---- P2M from slot-ordered tables: no body gathers
        M = self._p2m_slots(d, aux, q_t, p)
        M = self._phase_m2m(d, M)

        res_t = jnp.zeros((nl_t * K_t, rdim), dt)

        if self.config.local_evaluation or self.config.block_diagonal:
            if self._use_panels and "panels" in aux:
                res_t = res_t + self._near_pass_slots(aux["panels"], q_t)
            elif len(self.p2p_src_slot):
                res_t = res_t + self._p2p_pass(
                    d, sfields, tfields, q_t, nl_t, K_t, slots=True
                )
            return res_t

        L = self._phase_m2l(d, M, p)
        if self.config.evaluator == Evaluator.FMM:
            L = self._phase_l2l(d, L)
            res_t = res_t + self._l2p_slots(d, aux, L, p)
        if len(self.m2p_src):
            res_t = res_t + self._m2p_pass(
                d, tfields, M, p, nl_t, K_t, dt, slots=True
            )
        if self.near_rows is not None and "panels" in aux:
            res_t = res_t + self._near_pass_slots(aux["panels"], q_t)
        elif self.near_rows is None and len(self.p2p_src_slot):
            res_t = res_t + self._p2p_pass(
                d, sfields, tfields, q_t, nl_t, K_t, slots=True
            )
        return res_t

    def _p2m_slots(self, d, aux, q_t, p):
        """Slot-space P2M (ref EvalInteractionLazy.hpp:254-260 role):
        k-major table [(cdim,) K, nl, cW] contracted against the
        [K, nl]-transposed charge tile — a leading-axis reduce that
        accumulates [nl, cW] tiles and streams the table once, then
        one nl-row box scatter."""
        kern = self.kernel
        st = self.src.tree
        dt = jnp.dtype(self.config.dtype)
        cdim = getattr(kern, "charge_dim", 1)
        nl_s, K_s = len(self.src.leaf_ids), self.src.leaf_pad
        cW = kern.ncomp * kern.width(p)
        if "p2m_tab_t" in aux:
            tabk = aux["p2m_tab_t"]  # [(cdim,) K, nl, cW]
            if cdim == 1:
                qk = q_t.reshape(nl_s, K_s).T
                contrib = (tabk * qk[:, :, None]).sum(axis=0)
            else:
                qk = q_t.reshape(nl_s, K_s, cdim)
                contrib = jnp.einsum("nkc,cknw->nw", qk, tabk)
        else:
            contrib = kern.p2m(
                aux["s_fields_t"], q_t, aux["s_dn_t"], aux["s_isig_t"], p
            ).reshape(-1, cW)
            contrib = jnp.where(d["s_slot_mask"][:, None], contrib, 0.0)
            contrib = contrib.reshape(nl_s, K_s, cW).sum(axis=1)
        return (
            jnp.zeros((st.num_boxes, cW), dt)
            .at[d["s_leaf_ids"]]
            .set(contrib)
        )

    def _near_pass_slots(self, panels, q_t):
        """Near field with charges already in leaf-tile layout: the
        panel contraction's native shape, zero index moves."""
        from fmm_bem_tpu.ops.near_panel import panel_matvec

        kern = self.kernel
        cdim = getattr(kern, "charge_dim", 1)
        nl_s, K_s = len(self.src.leaf_ids), self.src.leaf_pad
        nl_t, K_t = len(self.tgt.leaf_ids), self.tgt.leaf_pad
        ql = q_t.reshape(nl_s, K_s * cdim)
        if isinstance(panels, dict) and "otf_tiles" in panels:
            out_leaf = self._near_otf_core(panels, ql)
        else:
            out_leaf = panel_matvec(panels, self._near_meta, ql)
        return out_leaf.reshape(nl_t * K_t, kern.result_dim)

    def _l2p_slots(self, d, aux, L, p):
        """L2P in slot layout: each leaf's local expansion broadcasts
        over its tile — a [nl]-row gather instead of one per body."""
        kern = self.kernel
        nl_t, K_t = len(self.tgt.leaf_ids), self.tgt.leaf_pad
        W = kern.width(p)
        cW = kern.ncomp * W
        Ll = L[d["t_leaf_ids"]]  # [nl, cW]
        if "l2p_tab_t" in aux:
            # w-major tab [rdim, cW, nl, K]: contraction axis leads,
            # so the phase is a leading-axis accumulation of [nl, K]
            # tiles (one table stream, no minor-axis reduce)
            tabw = aux["l2p_tab_t"]
            out = (tabw * Ll.T[None, :, :, None]).sum(axis=1)
            return out.reshape(-1, nl_t * K_t).T
        Lb = jnp.broadcast_to(
            Ll[:, None, :], (nl_t, K_t, cW)
        ).reshape(nl_t * K_t, kern.ncomp, W)
        out = kern.l2p(
            aux["t_fields_t"], Lb, aux["t_dn_t"], aux["t_isig_t"], p
        )
        return jnp.where(d["t_slot_mask"][:, None], out, 0.0)

    def _phase_m2l(self, d, M, p):
        """M2L = family path (same-level pairs grouped by parents, one
        dense [8W, 8W] operator per parent-offset class — see
        _M2LFamilies) + residual tile path (cross-level pairs and
        family-demoted stragglers: ONE batched class matmul over pair
        tiles, then a scatter-free bucketed gather-sum,
        ops/bucket_sum.py)."""
        kern = self.kernel
        tt = self.tgt.tree
        dt = jnp.dtype(self.config.dtype)
        cW = kern.ncomp * kern.width(p)
        L = None
        npairs_pad = len(self.m2l_tile_src)
        if npairs_pad:
            from fmm_bem_tpu.ops.bucket_sum import bucket_sum_apply

            TS = self.m2l_tile_size
            W = kern.width(p)
            ntile = npairs_pad // TS
            # fold the component axis into matmul rows (flat layout is
            # component-major): [TS*ncomp, W] x [W, W] per tile, no
            # kron.  Larger tiles grow the class padding, and so the
            # streamed pair bytes, faster than bigger matmuls pay back;
            # the family path handles most pairs by deduplicating the
            # GATHER instead.
            Mg = M[d["m2l_tile_src"]].reshape(ntile, TS * kern.ncomp, W)
            mats = d["m2l_mats"][d["m2l_tile_cls"]]  # [ntile, W, W]
            outp = jnp.einsum("tpw,tvw->tpv", Mg, mats).reshape(
                npairs_pad, cW
            )
            L = bucket_sum_apply(d["m2l_bsum"], outp)
        if getattr(self, "m2l_fam", None) is not None:
            Lf = self._phase_m2l_family(d, M, p)
            L = Lf if L is None else L + Lf
        if L is None:
            L = jnp.zeros((tt.num_boxes, cW), dt)
        return L

    def _phase_m2l_family(self, d, M, p):
        """Family M2L (see _M2LFamilies): stage sibling expansions as
        [nusp, ncomp*8W] family rows ONCE (a single pass over M), then
        per offset class one [F_c*ncomp, 8W] x [8W, 8W] matmul whose
        64 child-translation blocks serve every child pair at once;
        reduce families into target parents (bucketed gather-sum) and
        broadcast parent rows back to child boxes with one gather."""
        kern = self.kernel
        f = self.m2l_fam
        nc = kern.ncomp
        W = kern.width(p)
        dt = jnp.dtype(self.config.dtype)
        from fmm_bem_tpu.ops.bucket_sum import bucket_sum_apply

        # [nusp, 8, cW] sibling stage; missing children -> zero rows
        g = M[d["fam_src_child"]] * d["fam_src_mask"][..., None]
        # component-major family rows [nusp, nc*8W] so each class
        # matmul is [F_c*nc, 8W] x [8W, 8W] with no structural zeros
        Mfam = (
            g.reshape(f.nusp, 8, nc, W)
            .transpose(0, 2, 1, 3)
            .reshape(f.nusp, nc * 8 * W)
        )
        outs = []
        for ci, sp_rows in enumerate(d["fam_cls_sp"]):
            rows = Mfam[sp_rows]  # [F_c_pad, nc*8W]
            Tc = jax.lax.dynamic_index_in_dim(
                d["fam_mats"], ci, keepdims=False
            )
            out_c = rows.reshape(-1, 8 * W) @ Tc  # [F_c_pad*nc, 8W]
            outs.append(out_c.reshape(-1, nc, 8 * W))
        out = jnp.concatenate(outs, axis=0)  # [F_pad, nc, 8W]
        # -> per-family [8, nc*W] rows (octant-major, matching L layout)
        Fp = out.shape[0]
        out = (
            out.reshape(Fp, nc, 8, W)
            .transpose(0, 2, 1, 3)
            .reshape(Fp, 8 * nc * W)
        )
        Lred = bucket_sum_apply(d["fam_bsum"], out)  # [nutp, 8cW]
        rows = Lred.reshape(f.nutp * 8, nc * W)
        return rows[d["fam_out_idx"]] * d["fam_out_mask"][:, None]

    def _phase_l2l(self, d, L):
        """L2L top-down (target tree), one level at a time: ONE matmul
        translates each parent's local expansion to all eight octants,
        and the rows of existing children are added in place."""
        for lvl in range(1, self.tgt.tree.num_levels):
            if d["tgt_lvl"][lvl - 1] is not None:
                parents, kids = d["tgt_lvl"][lvl - 1]
                L = l2l_level(L, parents, kids, d["l2l_lvl_mats"][lvl - 1],
                              self.kernel.ncomp)
        return L

    def _phase_l2p(self, d, aux, tfields, L, p):
        """L2P at target bodies (precomputed linear table when the
        kernel provides one)."""
        kern = self.kernel
        Lb = L[d["t_body_leaf_box"]]
        if "l2p_tab" in aux:
            return jnp.einsum("nw,nwr->nr", Lb, aux["l2p_tab"])
        return kern.l2p(
            tfields,
            Lb.reshape(-1, kern.ncomp, kern.width(p)),
            d["t_body_dnorm"],
            d["t_body_inv_sigma"],
            p,
        )

    def _m2p_pass(self, d, tfields, M, p, nl, K, dt, slots=False):
        kern = self.kernel
        tgt_slots = d["m2p_tgt_slot"]
        src_ids = d["m2p_src"]
        # two-stage gather (see _p2p_pass): leaf tiles once, then
        # per-pair LEAF-slot rows — per-pair body gathers fetch
        # npairs*K random 12-byte rows and dominated the pass
        txyz_lt = d["t_xyz"][d["t_leaf_body_idx"]]  # [nl, K, 3]
        txyz = txyz_lt[tgt_slots]
        centers = d["s_box_center"][src_ids]
        inv_sig = d["m2p_inv_sigma"]
        dn = (txyz - centers[:, None, :]) * inv_sig[:, None, None]
        # flat [*, ncomp*W] expansions -> per-box [ncomp, W] views
        Ms = M[src_ids].reshape(-1, kern.ncomp, kern.width(p))

        def one_pair(m, dnp, isig, fields_rows):
            mb = jnp.broadcast_to(m, (K,) + m.shape)
            return kern.m2p(fields_rows, mb, dnp, jnp.full((K,), isig, dt), p)

        lt_f = {
            k: v[d["t_leaf_body_idx"]] for k, v in tfields.items()
        }
        fields_rows = {k: v[tgt_slots] for k, v in lt_f.items()}
        vals = chunked_vmap(
            one_pair, (Ms, dn, inv_sig, fields_rows),
            self.config.p2p_chunk,
        )
        seg = _seg_sum(vals, tgt_slots, nl)
        out = seg.reshape(nl * K, -1)
        if slots:
            # padded slots hold kernel values at dummy bodies — zero them
            return jnp.where(d["t_slot_mask"][:, None], out, 0.0)
        return out[d["t_body_flat_slot"]]

    def _p2p_pass(self, d, sfields, tfields, qm, nl, K, slots=False):
        """Direct P2P over leaf pairs.  ``qm`` is the charge vector in
        Morton body order, or (slots=True) per-source-leaf charge tiles
        [nl_s, K_s(*cdim)] with padded slots already zeroed."""
        kern = self.kernel
        sslot = d["p2p_src_slot"]
        tslot = d["p2p_tgt_slot"]
        smask = d["s_leaf_body_mask"][sslot]
        # two-stage gather: build [nl, K, ...] leaf tiles ONCE, then
        # index pairs by LEAF slot.  A per-pair body gather would fetch
        # npairs*K random 12-byte xyz rows; leaf-slot rows are K*12
        # bytes and the tile build is only nl*K rows.
        lt_s = {
            k: v[d["s_leaf_body_idx"]] for k, v in sfields.items()
        }
        lt_t = (
            lt_s if tfields is sfields
            else {k: v[d["t_leaf_body_idx"]] for k, v in tfields.items()}
        )
        src_rows = {k: v[sslot] for k, v in lt_s.items()}
        tgt_rows = {k: v[tslot] for k, v in lt_t.items()}
        if slots:
            K_s = self.src.leaf_pad
            cdim = getattr(kern, "charge_dim", 1)
            qt = qm.reshape(len(self.src.leaf_ids), K_s, cdim) \
                if cdim > 1 else qm.reshape(-1, K_s)
            qg = qt[sslot]
        else:
            # charges may be scalar [N] or vector [N, c]; zero padded
            # slots (leaf-tile layout, then per-pair slot gather)
            qlt = qm[d["s_leaf_body_idx"]]
            mask_l = d["s_leaf_body_mask"]
            mask_l = mask_l if qlt.ndim == 2 else mask_l[..., None]
            qlt = jnp.where(mask_l, qlt, 0.0)
            qg = qlt[sslot]

        def one_pair(tf, sf, qrow, mrow):
            return kern.p2p_block(tf, sf, qrow, mrow)

        vals = chunked_vmap(
            one_pair, (tgt_rows, src_rows, qg, smask),
            self.config.p2p_chunk,
        )
        seg = _seg_sum(vals, tslot, nl)
        out = seg.reshape(nl * K, -1)
        if slots:
            return jnp.where(d["t_slot_mask"][:, None], out, 0.0)
        return out[d["t_body_flat_slot"]]

    # ------------------------------------------------------------------
    # public API
    # ------------------------------------------------------------------
    def apply(self, charges, p=None, fields=None, target_fields=None):
        """One FMM matvec at truncation order ``p`` (ref
        FMM_plan::execute, FMM_plan.hpp:75-90 + the set_p relaxation
        hook).  Compiles one specialisation per distinct p.

        ``fields``/``target_fields`` override per-body arrays at call
        time (already in Morton order) — e.g. flipped BC flags to
        evaluate the RHS operator, replacing the reference's full plan
        rebuild (LaplaceBEM.cpp:218-232) with a pure input change.
        """
        p = int(p if p is not None else self.config.max_p)
        # the plan's buffers/matrices are allocated at config.max_p
        p = min(p, self.config.max_p)
        if p not in self._apply_cache:
            # device data is a jit ARGUMENT (not a closure capture):
            # captured arrays would be embedded as compile-time
            # constants, which bloats the module and its compile
            def f(d, aux, sf, tf, q):
                return self._matvec(d, sf, tf, q, p, aux=aux)

            self._apply_cache[p] = (jax.jit(f), self.device_data(p))
        fn, d = self._apply_cache[p]
        host_tgt = (
            target_fields
            if target_fields is not None
            else (fields if fields is not None and not self.dual else None)
        )
        aux = self.variant_aux(p, src_host=fields, tgt_host=host_tgt)
        sf = self.device_fields(fields, "src")
        tf = (
            self.device_fields(target_fields, "tgt")
            if (self.dual or target_fields is not None)
            else sf
        )
        from fmm_bem_tpu.utils.metrics import log

        # dispatch accounting only (no forced sync — timing the device
        # per phase is utils/roofline.phase_breakdown's job)
        with log.phase(f"matvec[p={p}]", work=self.src.tree.num_bodies):
            return fn(d, aux, sf, tf, charges)

    def device_data(self, p):
        """Per-order device arrays (cached): translation matrices are
        prefix-sliced to width(p), lists/indices are shared."""
        cache = getattr(self, "_ddata_cache", {})
        if p not in cache:
            cache[p] = self._device_data(p)
            self._ddata_cache = cache
        return cache[p]

    def solver_ops(self, flipped=False):
        """Pure-function operator form for the device-resident solver
        (solver.gmres.gmres_device): returns ``(matvec, operand_for_p)``
        with ``matvec(operand, x, p)`` traceable at static p.

        ``flipped=True`` applies the BC-flipped operator (the reference's
        switch_BC system matrix, LaplaceBEM.cpp:218-232).  Vector-valued
        kernels (Stokes, result_dim=c) see the solver vector as the
        flattened [n*c] layout (ref GMRES_Stokes.hpp VecToArray/
        ArrayToVec :85-110).
        """
        rdim = getattr(self.kernel, "result_dim", 1)
        cdim = getattr(self.kernel, "charge_dim", 1)
        n = self.src.tree.num_bodies

        if flipped:
            sfh, tfh = self._flipped_fields()
            sf = self.device_fields(sfh)
            tf = self.device_fields(tfh) if self.dual else sf
        else:
            sfh = tfh = None
            sf = self.device_fields(None, "src")
            tf = self.device_fields(None, "tgt") if self.dual else sf

        def operand_for_p(p):
            p = min(int(p), self.config.max_p)
            aux = self.variant_aux(p, src_host=sfh, tgt_host=tfh)
            return (self.device_data(p), aux, sf, tf)

        def matvec(operand, x, p):
            d, aux, sfo, tfo = operand
            q = x if cdim == 1 else x.reshape(-1, cdim)
            out = self._matvec(
                d, sfo, tfo, q, min(int(p), self.config.max_p),
                aux=aux,
            )
            return out[:, 0] if rdim == 1 else out.reshape(-1)

        return matvec, operand_for_p

    def solver_ops_slots(self, flipped=False):
        """Slot-space operator form for the device solver: the Krylov
        vectors live in the padded leaf-tile layout, so the matvec does
        ZERO body-order index gathers per iteration (see
        ``_matvec_slots``).  Returns

            (matvec, operand_for_p, to_slots, from_slots, nslots)

        with ``to_slots(x_user) -> x_slot`` / ``from_slots(r_slot) ->
        r_user`` the one-time solve entry/exit conversions, or ``None``
        when the plan cannot run tile-resident (COO near-field replay,
        dual trees, or non-square charge/result dims).
        """
        kern = self.kernel
        rdim = getattr(kern, "result_dim", 1)
        cdim = getattr(kern, "charge_dim", 1)
        if self.dual or cdim != rdim:
            return None
        if (
            self.near_rows is not None
            and len(self.near_rows)
            and not self._use_panels
        ):
            return None
        nl_s, K_s = len(self.src.leaf_ids), self.src.leaf_pad
        nl_t, K_t = len(self.tgt.leaf_ids), self.tgt.leaf_pad
        n = self.src.tree.num_bodies

        if flipped:
            sfh, tfh = self._flipped_fields()
            sf = self.device_fields(sfh)
            tf = self.device_fields(tfh) if self.dual else sf
        else:
            sfh = tfh = None
            sf = self.device_fields(None, "src")
            tf = self.device_fields(None, "tgt") if self.dual else sf

        def operand_for_p(p):
            p = min(int(p), self.config.max_p)
            aux = self.variant_aux_slots(p, src_host=sfh, tgt_host=tfh)
            return (self.device_data(p), aux, sf, tf)

        def matvec(operand, x, p):
            d, aux, sfo, tfo = operand
            out = self._matvec_slots(
                d, aux, sfo, tfo, x, min(int(p), self.config.max_p)
            )
            return out[:, 0] if rdim == 1 else out.reshape(-1)

        # solve entry/exit index maps (user order <-> slot order)
        slot_user = jnp.asarray(
            self.src.tree.perm[
                self.src.leaf_body_idx.reshape(-1)
            ].astype(np.int32)
        )
        smask = jnp.asarray(self.src.leaf_body_mask.reshape(-1))
        inv_perm_t = np.argsort(self.tgt.tree.perm)
        user_slot = jnp.asarray(
            self.tgt.body_flat_slot[inv_perm_t].astype(np.int32)
        )

        # eager on purpose: these run once per solve, and a jit here
        # would closure-capture the index arrays as embedded constants
        # of the compiled program
        def to_slots(xu):
            xu = jnp.asarray(xu)
            if cdim > 1:
                g = xu.reshape(n, cdim)[slot_user]
                return jnp.where(smask[:, None], g, 0.0).reshape(-1)
            return jnp.where(smask, xu.reshape(n)[slot_user], 0.0)

        def from_slots(rt):
            rr = rt.reshape(nl_t * K_t, rdim)[user_slot]
            return rr[:, 0] if rdim == 1 else rr.reshape(-1)

        return matvec, operand_for_p, to_slots, from_slots, \
            nl_s * K_s * cdim

    def calibrate_eps(self, q=None, ps=None, seed=0):
        """Measure the matvec truncation-error decay eps(p) and fit
        ``eps(p) = c * gamma**p``.

        The reference hardcodes eps ~ 2^-p into its relaxation schedule
        and flags it as Laplace-sphere-specific (SolverOptions.hpp:32
        "predict p for Spherical Laplace kernel -- abstract out").
        Here the model is calibrated per plan: matvecs at a few sample
        orders are compared against the max_p matvec on a random
        probe charge, and the fitted (c, gamma) drive
        SolverConfig.predict_p via ``SolverConfig.calibrated``.

        Returns (c, gamma); the raw samples land in ``self.eps_samples``.
        """
        pmax = self.config.max_p
        if ps is None:
            lo = max(1, pmax // 4)
            mid = max(lo + 1, pmax // 2)
            hi = max(mid + 1, pmax - 1)
            ps = sorted({lo, mid, hi})
        ps = [p for p in ps if p < pmax]
        cdim = getattr(self.kernel, "charge_dim", 1)
        n = self.src.tree.num_bodies
        if q is None:
            rng = np.random.default_rng(seed)
            shape = (n,) if cdim == 1 else (n, cdim)
            q = rng.choice([-1.0, 1.0], size=shape)
        ref = np.asarray(self.apply(q, p=pmax))
        rnorm = float(np.linalg.norm(ref))
        eps = {}
        for p in ps:
            out = np.asarray(self.apply(q, p=p))
            eps[p] = float(np.linalg.norm(out - ref)) / max(rnorm, 1e-300)
        self.eps_samples = eps
        # least-squares fit of log eps = log c + p log gamma, using only
        # samples above the noise floor of the arithmetic in use
        floor = 50 * np.finfo(np.dtype(self.config.dtype)).eps
        pts = [(p, e) for p, e in eps.items() if e > floor]
        if len(pts) >= 2:
            parr = np.array([p for p, _ in pts], dtype=np.float64)
            larr = np.log(np.array([e for _, e in pts]))
            slope, icept = np.polyfit(parr, larr, 1)
            gamma = float(np.exp(slope))
            c = float(np.exp(icept))
        elif len(pts) == 1:
            p0, e0 = pts[0]
            gamma = 0.5
            c = e0 / gamma**p0
        else:
            # truncation indistinguishable from max_p on this plan
            # (e.g. a near-field-dominated small tree): no model —
            # SolverConfig keeps the reference's 2^-p default
            return None, None
        # clamp to a sane contraction so the schedule stays monotone and
        # can always reach max_p
        gamma = min(max(gamma, 1e-4), 0.95)
        c = min(max(c, 1e-12), 1e3)
        return c, gamma

    def _flipped_fields(self):
        """Host field dicts with every panel's BC flag flipped (the
        reference's switch_BC trick) — cached so the derived device
        arrays are reused across calls."""
        if not hasattr(self, "_flipped_host"):
            def flip(side):
                f = dict(side.fields)
                f["bc"] = 1.0 - np.asarray(f["bc"])
                return f

            sf = flip(self.src)
            tf = flip(self.tgt) if self.dual else sf
            self._flipped_host = (sf, tf)
        return self._flipped_host

    def apply_flipped_bc(self, charges, p=None):
        """Matvec with every panel's BC flag flipped (the reference's
        switch_BC RHS trick) — same plan, same compiled executable.
        The flipped device fields are cached like the defaults."""
        sf, tf = self._flipped_fields()
        return self.apply(charges, p=p, fields=sf, target_fields=tf)

    # alias matching the reference naming (FMM_plan::execute)
    execute = apply
