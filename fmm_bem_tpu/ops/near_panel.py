"""Near-field leaf-panel matvec (the array form of the reference's
EvalInteractionLazySparse).

The reference caches the singular/near-singular panel integrals in a CSR
matrix and replays ``results += A @ charges`` every GMRES iteration
(EvalInteractionLazySparse.hpp:112,134-150).  A COO/CSR replay is a
per-entry gather + scatter-add; streaming the same values as dense
blocks touches each byte once, in order.

Layout (uniform chunks): every target leaf's near field is a row of
dense interaction blocks against its m near-field source leaves.  Those
rows are packed into fixed-width CHUNKS of m0 source leaves each —

    A  [C, KT*rdim, m0 * KS*cdim]      (C = sum_l ceil(m_l / m0))

sorted by target leaf, so the whole near field is ONE uniformly-shaped
batched matvec over a bandwidth-bound store.  ``panel_matvec`` runs it
as a Pallas kernel on a GPU (one program per target leaf walks its
chunk range, so each leaf's result is written once) and as plain XLA
(charge gather, batched contraction, sorted segment-sum) elsewhere.

``m0`` is chosen per plan to minimise padded bytes (see choose_m0).

Supports scalar entries (Laplace/Yukawa BEM: rdim = cdim = 1) and
matrix entries (Stokes BEM: 3x3 blocks) by expanding to DOF-level
rows/columns.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

#: candidate chunk widths (source leaves per chunk)
M0_CANDIDATES = (2, 4, 6, 8, 12, 16, 24, 32)

#: device-assembly one-shot limit: above this transient-bytes estimate
#: the quadrature blocks + A gather run in row chunks (tests shrink it
#: to force the chunked path on small meshes)
ONE_SHOT_LIMIT = 2 << 30


def choose_m0(m_per, KSc, candidates=M0_CANDIDATES):
    """Chunk width minimising total padded panel bytes.

    Cost of width m0: sum_l ceil(m_l/m0) chunks, each storing
    roundup(m0*KSc, 128) columns.  Ties prefer the larger width (fewer
    chunks to walk).
    """
    m_per = np.asarray(m_per)
    m_per = m_per[m_per > 0]
    if len(m_per) == 0:
        return candidates[0]
    best, best_cost = None, None
    for m0 in candidates:
        lanes = -(-m0 * KSc // 128) * 128
        cost = int((-(-m_per // m0)).sum()) * lanes
        if best_cost is None or cost < best_cost or (
            cost == best_cost and m0 > best
        ):
            best, best_cost = m0, cost
    return best


def _block_rows(KTr, Lb, target_bytes=2 << 20):
    """Chunk-count granule: the store is padded to a multiple of this
    many chunks (~2 MB of panels).  Only the padding depends on it;
    not yet retuned on the GPU (ROADMAP)."""
    row_bytes = KTr * Lb * 4
    bl = max(1, target_bytes // max(row_bytes, 1))
    # power of two, capped
    bl = 1 << (int(bl).bit_length() - 1)
    return int(min(bl, 256))


@dataclasses.dataclass
class NearPanels:
    """Host-side chunk structure; ``device()`` uploads the arrays."""

    #: [C, KTr, Lb] chunk panels (None when assembled on device)
    A: object
    #: [C, m0] source-leaf slot per chunk column group (dummy = nl_src)
    pidx: np.ndarray
    #: [C] local target-leaf index per chunk (dummy = nl_t)
    chunk_tgt: np.ndarray
    nl_t: int
    m0: int
    npairs: int
    rdim: int
    cdim: int
    KT: int
    KS: int

    def device(self, dtype):
        dt = jnp.dtype(dtype)
        return {
            "A": jnp.asarray(self.A, dt),
            "pidx": jnp.asarray(self.pidx),
            "chunk_tgt": jnp.asarray(self.chunk_tgt),
        }

    @property
    def nbytes(self):
        return 0 if self.A is None else self.A.nbytes


def _sorted_pairs(pair_src_slot, pair_tgt_slot, tgt_slot_local,
                  src_slot_local, nl_t):
    """Sort pairs by (target slot, source slot) and build the per-leaf
    row pointer (target-contiguous panels + strictly increasing pair
    keys for entry searchsorted)."""
    pair_tgt_slot = np.asarray(pair_tgt_slot)
    pair_src_slot = np.asarray(pair_src_slot)
    po = np.lexsort((pair_src_slot, pair_tgt_slot))
    ts = pair_tgt_slot[po]
    ss = pair_src_slot[po]
    # bucket rows by the (local) target index; a monotone local map
    # preserves the sort order above
    ts_b = ts if tgt_slot_local is None else tgt_slot_local[ts]
    ss_l = ss if src_slot_local is None else src_slot_local[ss]
    row_ptr = np.searchsorted(ts_b, np.arange(nl_t + 1))
    return ts, ss, ss_l, row_ptr


def _chunk_layout(row_ptr, m0, npairs, ss_l, nl_src, nl_t, bl):
    """Vectorised chunk bookkeeping.

    Returns (pair_ids [Cpad, m0] with dummy = npairs,
             pidx [Cpad, m0] with dummy = nl_src,
             chunk_tgt [Cpad] with dummy = nl_t).
    """
    m_per = np.diff(row_ptr)
    nchunk = -(-m_per // m0)  # ceil
    C = int(nchunk.sum())
    Cpad = max(-(-max(C, 1) // bl) * bl, bl)
    pair_ids = np.full((Cpad, m0), npairs, np.int32)
    pidx = np.full((Cpad, m0), nl_src, np.int32)
    chunk_tgt = np.full(Cpad, nl_t, np.int32)
    if C:
        l_of_c = np.repeat(np.arange(nl_t), nchunk)
        cum = np.concatenate([[0], np.cumsum(nchunk)])
        j_of_c = np.arange(C) - cum[l_of_c]
        starts = row_ptr[l_of_c] + j_of_c * m0
        counts = np.minimum(row_ptr[l_of_c + 1] - starts, m0)
        k = np.arange(m0)
        pid = starts[:, None] + k[None, :]
        valid = k[None, :] < counts[:, None]
        pair_ids[:C] = np.where(valid, pid, npairs)
        pidx[:C] = np.where(
            valid, ss_l[np.clip(pid, 0, max(npairs - 1, 0))], nl_src
        )
        chunk_tgt[:C] = l_of_c
    return pair_ids, pidx, chunk_tgt


def build_near_panels(
    pair_src_slot,
    pair_tgt_slot,
    rows,
    cols,
    vals,
    src_side,
    tgt_side,
    nl_t,
    m0=None,
    dtype=np.float32,
    tgt_slot_local=None,
    src_slot_local=None,
    nl_src_local=None,
):
    """Assemble uniform chunk panels from COO near-field entries.

    Parameters
    ----------
    pair_src_slot / pair_tgt_slot : leaf-slot ids per near leaf pair.
    rows / cols : Morton body indices per entry (target, source).
    vals : [nnz] scalar or [nnz, rdim, cdim] matrix entry values,
        already BC-selected for the operator variant.
    src_side / tgt_side : plan _TreeSide objects (leaf tiles).
    m0 : chunk width override (multi-device builds pass a global value
        so per-device panels stack to one shape).
    tgt_slot_local / src_slot_local : optional monotone global->local
        slot maps (LET sharding: chunk rows / charge-table columns are
        indexed in a device-local numbering while entry bookkeeping
        stays global).  ``nl_t`` then counts LOCAL target leaves and
        ``nl_src_local`` sizes the local charge table.
    """
    vals = np.asarray(vals)
    if vals.ndim == 1:
        rdim = cdim = 1
        vals3 = vals[:, None, None]
    else:
        rdim, cdim = vals.shape[1], vals.shape[2]
        vals3 = vals
    KT, KS = tgt_side.leaf_pad, src_side.leaf_pad
    KTr, KSc = KT * rdim, KS * cdim

    ts, ss, ss_l, row_ptr = _sorted_pairs(
        pair_src_slot, pair_tgt_slot, tgt_slot_local, src_slot_local,
        nl_t,
    )
    npairs = len(ts)

    # entry -> (pair, in-block position)
    st_leaf = src_side.tree.body_leaf
    tt_leaf = tgt_side.tree.body_leaf
    s_slot = src_side.box_to_slot[st_leaf]
    t_slot = tgt_side.box_to_slot[tt_leaf]
    s_pos = np.arange(src_side.tree.num_bodies) - \
        src_side.tree.box_body_start[st_leaf]
    t_pos = np.arange(tgt_side.tree.num_bodies) - \
        tgt_side.tree.box_body_start[tt_leaf]
    mult = int(len(src_side.leaf_ids)) + 1
    pair_key = ts.astype(np.int64) * mult + ss

    blocks = np.zeros((npairs, KTr, KSc), dtype)
    from fmm_bem_tpu import native

    filled = np.dtype(dtype) == np.float32 and native.panel_fill(
        rows, cols, np.ascontiguousarray(vals3, np.float32),
        t_slot, s_slot, t_pos, s_pos, pair_key, mult,
        rdim, cdim, KT, KS, blocks,
    )
    if not filled:
        # numpy fallback (f64 accuracy runs / missing .so) — the
        # searchsorted + fancy scatter cost ~250s at 1e8 entries, which
        # is why the f32 path is native
        entry_key = t_slot[rows].astype(np.int64) * mult + s_slot[cols]
        pidx_e = np.searchsorted(pair_key, entry_key)
        rr = t_pos[rows] * rdim
        cc = s_pos[cols] * cdim
        for i in range(rdim):
            for j in range(cdim):
                blocks[pidx_e, rr + i, cc + j] = vals3[:, i, j]

    if m0 is None:
        m0 = choose_m0(np.diff(row_ptr), KSc)
    Lb = -(-m0 * KSc // 128) * 128
    bl = _block_rows(KTr, Lb)
    nl_src = (
        len(src_side.leaf_ids) if nl_src_local is None else nl_src_local
    )
    pair_ids, pidx, chunk_tgt = _chunk_layout(
        row_ptr, m0, npairs, ss_l, nl_src, nl_t, bl
    )

    blocks_z = np.concatenate(
        [blocks, np.zeros((1, KTr, KSc), dtype)], axis=0
    )
    Cpad = pair_ids.shape[0]
    A = np.zeros((Cpad, KTr, Lb), dtype)
    A[:, :, : m0 * KSc] = (
        blocks_z[pair_ids]
        .transpose(0, 2, 1, 3)
        .reshape(Cpad, KTr, m0 * KSc)
    )
    return NearPanels(
        A=A,
        pidx=pidx,
        chunk_tgt=chunk_tgt,
        nl_t=nl_t,
        m0=m0,
        npairs=npairs,
        rdim=rdim,
        cdim=cdim,
        KT=KT,
        KS=KS,
    )


def build_near_panels_on_device(
    pair_src_slot,
    pair_tgt_slot,
    src_side,
    tgt_side,
    nl_t,
    blocks_fn,
    corr=None,
    rdim=1,
    cdim=1,
    m0=None,
    dtype=jnp.float32,
    jit_cache=None,
    tgt_slot_local=None,
    src_slot_local=None,
    nl_src_local=None,
):
    """Assemble uniform chunk panels with the interaction blocks
    computed ON the accelerator.

    The regular K-point quadrature entries (the overwhelming bulk) are
    smooth closed-form evaluations — ideal device work — so only the
    near-singular corrections (``corr``) are computed on the host
    (branchy semi-analytical integrals, a few % of entries).  This
    replaces a ~1e8-entry host COO expansion + quadrature loop that
    took minutes per plan on small hosts.

    Parameters
    ----------
    blocks_fn : callable ``(ss, ts) -> [npairs, KT*rdim, KS*cdim]``
        device blocks for the given (src leaf slot, tgt leaf slot)
        pair arrays (the plan wraps the kernel's ``near_block_device``).
    corr : optional ``(rows, cols, vals)`` host COO of near-singular
        entries (Morton body ids; vals already BC-selected,
        [nnz] or [nnz, rdim, cdim]) overwriting the quadrature values.
    Returns (device_dict, NearPanels meta).
    """
    import jax

    KT, KS = tgt_side.leaf_pad, src_side.leaf_pad
    KTr, KSc = KT * rdim, KS * cdim
    ts, ss, ss_l, row_ptr = _sorted_pairs(
        pair_src_slot, pair_tgt_slot, tgt_slot_local, src_slot_local,
        nl_t,
    )
    npairs = len(ts)
    nl_src = (
        len(src_side.leaf_ids) if nl_src_local is None else nl_src_local
    )

    # host: near-singular corrections as FLAT indices into the block
    # array (a 1-D scatter lowers far better than a 3-index one)
    if corr is not None and len(corr[0]):
        rows, cols, vals = corr
        vals = np.asarray(vals)
        vals3 = vals[:, None, None] if vals.ndim == 1 else vals
        s_slot = src_side.box_to_slot[src_side.tree.body_leaf]
        t_slot = tgt_side.box_to_slot[tgt_side.tree.body_leaf]
        s_pos = np.arange(src_side.tree.num_bodies) - \
            src_side.tree.box_body_start[src_side.tree.body_leaf]
        t_pos = np.arange(tgt_side.tree.num_bodies) - \
            tgt_side.tree.box_body_start[tgt_side.tree.body_leaf]
        # GLOBAL slot multiplier: ss and s_slot are global leaf slots
        # even when the charge table is locally renumbered
        mult = int(len(src_side.leaf_ids)) + 1
        pair_key = ts.astype(np.int64) * mult + ss
        entry_key = t_slot[rows].astype(np.int64) * mult + s_slot[cols]
        pidx_e = np.searchsorted(pair_key, entry_key)
        rr = (t_pos[rows] * rdim).astype(np.int64)
        cc = (s_pos[cols] * cdim).astype(np.int64)
    else:
        pidx_e = np.zeros(0, np.int64)
        rr = cc = np.zeros(0, np.int64)
        vals3 = np.zeros((0, rdim, cdim))

    def _flat_idx(pe, rre, cce):
        """Flat indices into a [*, KTr, KSc] block array for the
        near-singular correction entries (1-D scatter lowers far
        better than a 3-index one)."""
        base = pe.astype(np.int64) * KTr * KSc
        return (
            base[:, None, None]
            + (rre[:, None] + np.arange(rdim))[:, :, None] * KSc
            + (cce[:, None] + np.arange(cdim))[:, None, :]
        ).reshape(-1)

    if m0 is None:
        m0 = choose_m0(np.diff(row_ptr), KSc)
    Lb = -(-m0 * KSc // 128) * 128
    bl = _block_rows(KTr, Lb)
    pair_ids, pidx, chunk_tgt = _chunk_layout(
        row_ptr, m0, npairs, ss_l, nl_src, nl_t, bl
    )
    Cpad = pair_ids.shape[0]
    dt = jnp.dtype(dtype)
    if jit_cache is None:
        jit_cache = {}

    # the quadrature-block computation materialises per-pair
    # [KT, KS, 3] geometry — ~16 KB/pair of transient HBM.  One shot
    # at 524k panels (330k pairs) is a 16 GB temp: past ~2 GB the
    # assembly runs in row-chunks, computing only each chunk's pair
    # RANGE (pairs are target-sorted, so a row chunk's pairs are
    # contiguous) with one fixed padded-range executable.
    one_shot_bytes = npairs * KT * KS * 16
    if one_shot_bytes <= ONE_SHOT_LIMIT:
        def assemble(blocks, corr_idx_d, corr_vals_d, pair_ids_d):
            flat = blocks.reshape(-1)
            flat = flat.at[corr_idx_d].set(corr_vals_d)
            blocks = flat.reshape(npairs, KTr, KSc)
            blocks_z = jnp.concatenate(
                [blocks, jnp.zeros((1, KTr, KSc), blocks.dtype)],
                axis=0,
            )
            blk = blocks_z[pair_ids_d]  # [Cpad, m0, KTr, KSc]
            A = blk.transpose(0, 2, 1, 3).reshape(
                Cpad, KTr, m0 * KSc
            )
            if Lb > m0 * KSc:
                A = jnp.pad(A, ((0, 0), (0, 0), (0, Lb - m0 * KSc)))
            return A

        corr_idx = _flat_idx(pidx_e, rr, cc)
        key = ("assemble", npairs, KTr, KSc, Cpad, m0, len(corr_idx))
        if key not in jit_cache:
            jit_cache[key] = jax.jit(assemble)
        blocks = blocks_fn(jnp.asarray(ss), jnp.asarray(ts))
        A_dev = jit_cache[key](
            blocks,
            jnp.asarray(corr_idx),
            jnp.asarray(vals3.reshape(-1), dt),
            jnp.asarray(pair_ids),
        )
    else:
        budget_pairs = (1 << 30) // (KT * KS * 16)
        CH = max(bl, (budget_pairs // max(m0, 1)) // bl * bl)
        spans = []
        PR = 1
        for c0 in range(0, Cpad, CH):
            pids = pair_ids[c0 : c0 + CH]
            real = pids[pids < npairs]
            lo = int(real.min()) if len(real) else 0
            hi = int(real.max()) + 1 if len(real) else 0
            spans.append((c0, lo, hi))
            PR = max(PR, hi - lo)
        ss_p = np.concatenate([ss, np.zeros(PR, ss.dtype)])
        ts_p = np.concatenate([ts, np.zeros(PR, ts.dtype)])

        def assemble_chunk(blocks, corr_idx_d, corr_vals_d, pair_ids_d):
            flat = blocks.reshape(-1)
            # out-of-bucket padding indices drop instead of clipping
            flat = flat.at[corr_idx_d].set(corr_vals_d, mode="drop")
            blocks = flat.reshape(PR, KTr, KSc)
            blocks_z = jnp.concatenate(
                [blocks, jnp.zeros((1, KTr, KSc), blocks.dtype)],
                axis=0,
            )
            blk = blocks_z[pair_ids_d]  # [CH, m0, KTr, KSc]
            A = blk.transpose(0, 2, 1, 3).reshape(CH, KTr, m0 * KSc)
            if Lb > m0 * KSc:
                A = jnp.pad(A, ((0, 0), (0, 0), (0, Lb - m0 * KSc)))
            return A

        # chunks land in a preallocated A via donated dynamic updates —
        # a final concatenate would transiently DOUBLE the multi-GB
        # panel store and OOM exactly at the sizes this path exists for
        key_u = ("assemble_upd", Cpad, CH, KTr, Lb)
        if key_u not in jit_cache:
            jit_cache[key_u] = jax.jit(
                lambda A, part, c0: jax.lax.dynamic_update_slice(
                    A, part, (c0, 0, 0)
                ),
                donate_argnums=0,
            )
        A_dev = jnp.zeros((Cpad, KTr, Lb), dt)
        for c0, lo, hi in spans:
            pids = pair_ids[c0 : c0 + CH]
            if pids.shape[0] < CH:  # tail: pad rows with dummies
                pids = np.concatenate([
                    pids,
                    np.full((CH - pids.shape[0], m0), npairs, np.int32),
                ])
            pl = np.where(
                (pids < npairs) & (pids >= lo) & (pids < hi),
                pids - lo, PR,
            ).astype(np.int32)
            sel = (pidx_e >= lo) & (pidx_e < hi)
            idxl = _flat_idx(pidx_e[sel] - lo, rr[sel], cc[sel])
            vl = vals3[sel].reshape(-1)
            # bucket the correction count so chunks share executables
            nb = max(1 << (max(len(idxl), 1) - 1).bit_length(), 16)
            oob = PR * KTr * KSc + 1  # dropped by mode="drop"
            idxl = np.concatenate(
                [idxl, np.full(nb - len(idxl), oob, np.int64)]
            )
            vl = np.concatenate([vl, np.zeros(nb - len(vl))])
            key = ("assemble_ch", PR, CH, KTr, KSc, m0, nb)
            if key not in jit_cache:
                jit_cache[key] = jax.jit(assemble_chunk)
            blocks = blocks_fn(
                jnp.asarray(ss_p[lo : lo + PR]),
                jnp.asarray(ts_p[lo : lo + PR]),
            )
            part = jit_cache[key](
                blocks,
                jnp.asarray(idxl),
                jnp.asarray(vl, dt),
                jnp.asarray(pl),
            )
            if c0 + CH > Cpad:  # tail rows were padded with dummies
                part = part[: Cpad - c0]
                upd = jax.jit(
                    lambda A, part, c0=c0: jax.lax.dynamic_update_slice(
                        A, part, (c0, 0, 0)
                    ),
                    donate_argnums=0,
                )
                A_dev = upd(A_dev, part)
            else:
                A_dev = jit_cache[key_u](
                    A_dev, part, jnp.asarray(c0, jnp.int32)
                )

    meta = NearPanels(
        A=None,
        pidx=pidx,
        chunk_tgt=chunk_tgt,
        nl_t=nl_t,
        m0=m0,
        npairs=npairs,
        rdim=rdim,
        cdim=cdim,
        KT=KT,
        KS=KS,
    )
    dev = {
        "A": A_dev,
        "pidx": jnp.asarray(pidx),
        "chunk_tgt": jnp.asarray(chunk_tgt),
    }
    return dev, meta


#: register budget of one kernel program: rows x lanes of the panel tile
#: it holds (64 x 128 f32 at the benchmark shapes)
_TILE_ELEMS = 8192


def _contract_triton(A, pidx, chunk_tgt, ql, nl_t, interpret=False):
    """The whole near field as one Pallas kernel (Triton route).

    Chunks are leaf-sorted, so program (l, rt) owns rows rt*R.. of
    target leaf l: it walks the leaf's contiguous chunk range, gathers
    each chunk's m0 source-leaf charge tiles itself, contracts them
    against the streamed panel tile in registers and stores its rows
    once — no gathered-charge or per-chunk result round trip through
    device memory, no atomics, no cross-program carry.
    """
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import triton as plgpu

    KTr = A.shape[1]
    m0 = pidx.shape[1]
    KSc = ql.shape[1]
    mS = m0 * KSc
    L = pl.next_power_of_2(mS)
    R = min(pl.next_power_of_2(KTr), max(1, _TILE_ELEMS // L))
    ptr = jnp.searchsorted(
        chunk_tgt, jnp.arange(nl_t + 1, dtype=chunk_tgt.dtype)
    ).astype(jnp.int32)
    # appended zero tile: the dummy source leaf (pidx == len(ql))
    xq = jnp.concatenate([ql, jnp.zeros((1, KSc), ql.dtype)], axis=0)

    def kern(ptr_ref, pidx_ref, a_ref, xq_ref, o_ref):
        leaf = pl.program_id(0)
        lane = jnp.arange(L)
        lane_ok = lane < mS
        grp = jnp.minimum(lane // KSc, m0 - 1)
        col = lane % KSc
        rows = pl.program_id(1) * R + jnp.arange(R)
        row_ok = rows < KTr
        a_ok = row_ok[:, None] & lane_ok[None, :]

        def body(c, acc):
            src = plgpu.load(pidx_ref.at[c, grp])
            x = plgpu.load(xq_ref.at[src, col], mask=lane_ok, other=0.0)
            a = plgpu.load(
                a_ref.at[c, rows[:, None], lane[None, :]],
                mask=a_ok, other=0.0,
            )
            return acc + jnp.sum(a * x[None, :], axis=1)

        acc = jax.lax.fori_loop(
            ptr_ref[leaf], ptr_ref[leaf + 1], body,
            jnp.zeros((R,), A.dtype),
        )
        plgpu.store(o_ref.at[leaf, rows], acc, mask=row_ok)

    return pl.pallas_call(
        kern,
        out_shape=jax.ShapeDtypeStruct((nl_t, KTr), A.dtype),
        grid=(nl_t, pl.cdiv(KTr, R)),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=4, num_stages=3),
        interpret=interpret,
        name="near_panel_contract",
    )(ptr, pidx, A, xq)


def _contract_xla(A, pidx, chunk_tgt, ql, nl_t):
    """Plain XLA near field: charge gather, batched contraction, sorted
    segment-sum of each leaf's chunks (the reference the kernel is
    tested against)."""
    C, KTr, Lb = A.shape
    m0 = pidx.shape[1]
    KSc = ql.shape[1]
    xq = jnp.concatenate([ql, jnp.zeros((1, KSc), ql.dtype)], axis=0)
    xb = xq[pidx].reshape(C, m0 * KSc)
    if Lb > m0 * KSc:
        xb = jnp.pad(xb, ((0, 0), (0, Lb - m0 * KSc)))
    out = jnp.einsum("lts,ls->lt", A, xb)
    # chunks are leaf-sorted; dummies map to the dropped tail segment
    seg = jax.ops.segment_sum(
        out, chunk_tgt, num_segments=nl_t + 1, indices_are_sorted=True,
    )
    return seg[:nl_t]


def panel_matvec(panels_dev, meta, ql, impl=None):
    """Near-field product from leaf-tiled charges.

    Parameters
    ----------
    panels_dev : dict from NearPanels.device() or the device builder.
    meta : the NearPanels (static chunk shapes).
    ql : [nl_src, KS*cdim] masked per-source-leaf charge tiles.
    impl : "triton" or "xla" to force one implementation; by default
        the Pallas kernel runs where the computation is lowered for a
        CUDA device and plain XLA everywhere else.
    Returns [nl_t, KT*rdim] leaf result tiles in leaf-slot order.
    """
    args = (panels_dev["A"], panels_dev["pidx"], panels_dev["chunk_tgt"],
            ql)
    contract = {"triton": _contract_triton, "xla": _contract_xla}
    if impl is not None:
        return contract[impl](*args, meta.nl_t)
    return jax.lax.platform_dependent(
        *args,
        cuda=lambda *a: _contract_triton(*a, meta.nl_t),
        default=lambda *a: _contract_xla(*a, meta.nl_t),
    )
