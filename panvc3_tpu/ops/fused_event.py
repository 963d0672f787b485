"""Fused projection kernel v4: event-geometry rewrite + segment-space run
detection + realign DP in one dispatch.

The v3 fused kernel (ops/fused.py) spends ~77% of its time in per-unit
work: (B, R) rank/select gathers inside rewrite_math and (B, U)/(B, 2U+1)
expansions for the token-stream run detection.  This kernel removes the
per-unit axis entirely — the only arrays proportional to read length are
the run slices fed to the DP:

1. **rewrite**: the per-pair MSA-difference event tables
   (ops/event_geometry.DeviceEventGeometry) give the initial position and
   the record's overlapping gap/deletion events with one fused fixed-trip
   binary-search loop — no per-unit gathers (the identity
   ``dst.rank0(src.select0(u+1)) == u - G(u) + D(u)``, see
   event_geometry.project_unit);
2. **run detection**: the emitted op stream is piecewise constant between
   op boundaries and event endpoints, so the indel-run checker semantics
   (/root/reference/libpanvc3/indel_run_checker.cc:31-121) run over a
   merged *segment* list of O + 2*GAP_SLOTS + DEL_SLOTS boundaries
   (~40 per record vs 2U+1 ≈ 273 tokens): boundaries are rank-sorted with
   one comparison-count matrix (no jnp.sort), segment attributes decode
   with masked sums, and the v3 prefix-sum/prefix-max run recovery runs
   on the short token axis;
3. **DP**: run compaction, slice gathers and the batched affine DP +
   traceback are shared with the split path (bit-identical engines).

The =/X character comparison is NOT done on device — like the split
path's gap-geometry design, the kernel returns the event wire (dst_pos,
gap bitmask, sparse deletion runs) and the host reconstructs =/X locally
(rewrite_batch.reconstruct_main_code / native finalize_reconstruct);
run *detection* is =/X-insensitive (both break runs), so the device can
realign without the reference/query byte gathers of rewrite_math.

Fallbacks: event-slot/width overflow invalidates the rewrite itself, so
the engine re-dispatches the batch through the v3 gap-math fused kernel
(flags[1]); run-pool/length overflow (flags[0]) keeps the wire outputs
and falls back to host-dispatched realignment only.

Reference semantics: rewrite_cigar
(/root/reference/include/panvc3/rewrite_cigar.hh:59-156) +
indel_run_checker + align_global (align.hh:59-112).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..alphabet import dna5_normalise_device
from ..cigar import D, EQ, I
from .fused import _CONS_QUERY, _CONS_REF, _prefix_max_i
from .realign_batch import dp_align
from .rewrite_batch import CODE_NONE, _IS_MTYPE_OP, _IS_REF_OP


# boundary tie priorities at equal unit position: a gap run ending at u
# stops covering before anything else at u, a gap run starting at u covers
# everything at u, deletion tokens precede the unit's main token, op
# segments come last (zero-length segments make the remaining order moot)
_PR_GAP_OFF = 0
_PR_GAP_ON = 1
_PR_DEL = 2
_PR_OP = 3

_COUNT_BITS = 26  # op counts pack into attr bits [5, 31)


def _fused_event_body(
    geo,
    ref_flat: jnp.ndarray,      # uint8[Nref] (device copy; DP slices only)
    ref_ids: jnp.ndarray,       # int32[B] input reference id per record
    rec_src_pos: jnp.ndarray,   # int32[B]
    n_ref_units: jnp.ndarray,   # int32[B]
    ref_off: jnp.ndarray,       # int32[B]
    ops: jnp.ndarray,           # int8[B, O]
    counts: jnp.ndarray,        # int32[B, O]
    query: jnp.ndarray,         # uint8[B, Lq] dna5-normalised
    go: jnp.ndarray,            # float32
    ge: jnp.ndarray,            # float32
    R: int,
    run_r: int,
    run_q: int,
    slot_pool: int,
    _stage: int = 9,  # profiling aid: truncate after stage N (tools/bench_fused.py)
):
    B, O = ops.shape

    def _cut(*parts):
        """Stage-truncated return: sums keep a data dependency on
        everything computed so far (no DCE)."""
        acc = jnp.int32(0)
        for p in parts:
            acc = acc + jnp.sum(p.astype(jnp.int32) if p.ndim else p)
        z1 = jnp.zeros((1, 1), jnp.int32)
        zu = jnp.zeros((1, 1), jnp.uint8)
        return (acc, zu, zu, zu, jnp.zeros(1, jnp.uint8), z1, jnp.zeros(1, jnp.int32),
                jnp.stack([acc, acc, acc]))

    # ---- stage 1: event rewrite (fixed-trip searches, no unit gathers) ----
    initial, ga, gb, gcnt, d_rel, d_len, dcnt, ov_slots = geo.slots(
        ref_ids, rec_src_pos, n_ref_units, R
    )
    # effective slot widths (geo.effective_slots(R)): every downstream
    # lattice (boundaries, token axis, compaction scatter) scales with them
    KG = ga.shape[1]
    K = d_rel.shape[1]
    # the host-side wire (same layout the split path fetches)
    gapbits = geo.pack_isgap(ga, gb, R)
    d_vals = jnp.minimum(d_len, 255).astype(jnp.uint8)
    d_pos8 = jnp.minimum(d_rel, 255).astype(jnp.uint8)
    d_n8 = jnp.minimum(dcnt, 255).astype(jnp.uint8)
    ev_overflow = (
        ov_slots
        + jnp.sum(jnp.where(d_len >= 255, 1, 0))
        + jnp.where(R > 255, 1, 0)
    ).astype(jnp.int32)
    if _stage <= 0:
        return _cut(initial, ga, gb, gcnt, d_rel, d_len, dcnt)
    if _stage == 1:  # isolate the wire packing (gapbits paint)
        return _cut(initial, gapbits, d_vals, d_pos8, d_n8)

    # ---- stage 2: unit-space boundaries ----------------------------------
    is_ref_op = jnp.asarray(_IS_REF_OP)[ops]
    real_op = ops != CODE_NONE
    unit_per_op = jnp.where(real_op, jnp.where(is_ref_op, counts, 1), 0)
    unit_pref = jnp.cumsum(unit_per_op, axis=1) - unit_per_op  # exclusive
    total_units = unit_pref[:, -1] + unit_per_op[:, -1]
    ref_counts = jnp.where(is_ref_op & real_op, counts, 0)
    ref_pref = jnp.cumsum(ref_counts, axis=1) - ref_counts

    # unit position of ref rank x: u(x) = x + offs(x) where offs counts the
    # pass-through (non-ref) ops sitting before rank x — each contributes
    # exactly one unit and precedes x iff its exclusive ref prefix <= x
    xs = jnp.concatenate([ga, gb, d_rel], axis=1)  # (B, 2KG+K) ref ranks
    pass_op = (real_op & ~is_ref_op).astype(jnp.int32)
    offs = jnp.sum(
        pass_op[:, None, :] * (ref_pref[:, None, :] <= xs[:, :, None]).astype(jnp.int32),
        axis=2,
    )
    gvalid = ga <= gb
    dvalid = d_len > 0
    BIG = R + O + 2  # static sentinel position past every real unit

    pos_on = jnp.where(gvalid, ga + offs[:, :KG], BIG)
    pos_off = jnp.where(gvalid, gb + offs[:, KG:2 * KG] + 1, BIG)
    pos_del = jnp.where(dvalid, d_rel + offs[:, 2 * KG:], BIG)
    pos_op = jnp.where(real_op, unit_pref, BIG)

    NB = O + 2 * KG + K
    pos_all = jnp.concatenate([pos_op, pos_on, pos_off, pos_del], axis=1)
    pr_all = jnp.concatenate(
        [
            jnp.full((B, O), _PR_OP, jnp.int32),
            jnp.full((B, KG), _PR_GAP_ON, jnp.int32),
            jnp.full((B, KG), _PR_GAP_OFF, jnp.int32),
            jnp.full((B, K), _PR_DEL, jnp.int32),
        ],
        axis=1,
    )
    onoff_all = jnp.concatenate(
        [
            jnp.zeros((B, O), jnp.int32),
            jnp.where(gvalid, 1, 0),
            jnp.where(gvalid, -1, 0),
            jnp.zeros((B, K), jnp.int32),
        ],
        axis=1,
    )
    dlen_all = jnp.concatenate(
        [
            jnp.zeros((B, O), jnp.int32),
            jnp.zeros((B, 2 * KG), jnp.int32),
            jnp.where(dvalid, d_len, 0),
        ],
        axis=1,
    )

    # stable rank sort via one comparison-count matrix (NB ~ 40: cheaper
    # and more predictable than a bitonic jnp.sort on this backend)
    if _stage == 2:  # boundaries + offs expansion
        return _cut(pos_on, pos_off, pos_del, pos_op, dlen_all, onoff_all)

    keys = pos_all * 4 + pr_all
    tri = jnp.asarray(np.tril(np.ones((NB, NB), dtype=bool), k=-1))
    rank = jnp.sum(
        (keys[:, None, :] < keys[:, :, None])
        | ((keys[:, None, :] == keys[:, :, None]) & tri[None, :, :]),
        axis=2,
    ).astype(jnp.int32)

    bidx = jnp.arange(B, dtype=jnp.int32)[:, None]
    packed = (pos_all << 2) | (onoff_all + 1)  # pos and on/off share a lane
    z = jnp.zeros((B, NB), jnp.int32)
    sorted_packed = z.at[bidx, rank].set(packed)
    sorted_dlen = z.at[bidx, rank].set(dlen_all)
    sorted_pos = sorted_packed >> 2
    sorted_onoff = (sorted_packed & 3) - 1

    if _stage == 3:  # rank sort + scatters
        return _cut(sorted_packed, sorted_dlen)

    covered = jnp.cumsum(sorted_onoff, axis=1) > 0

    tu = total_units[:, None]
    seg_s = jnp.minimum(sorted_pos, tu)
    seg_e = jnp.minimum(
        jnp.concatenate([sorted_pos[:, 1:], jnp.full((B, 1), BIG, jnp.int32)], axis=1),
        tu,
    )
    n_seg = jnp.maximum(seg_e - seg_s, 0)

    # owning-op attributes via one masked sum (a take_along_axis here would
    # serialize); counts/op-code/is-ref share an int32 lane
    cnt_overflow = jnp.sum(
        jnp.where(counts >= (1 << _COUNT_BITS), 1, 0)
    ).astype(jnp.int32)
    attr = jnp.where(
        real_op,
        (counts << 5) | (ops.astype(jnp.int32) << 1) | is_ref_op.astype(jnp.int32),
        0,
    )
    owns = (unit_pref[:, None, :] <= seg_s[:, :, None]) & (
        seg_s[:, :, None] < (unit_pref + unit_per_op)[:, None, :]
    )
    seg_attr = jnp.sum(jnp.where(owns, attr[:, None, :], 0), axis=2)
    seg_cnt = seg_attr >> 5
    seg_opc = (seg_attr >> 1) & 15
    seg_isref = (seg_attr & 1) == 1

    seg_mtype = jnp.asarray(_IS_MTYPE_OP)[seg_opc] & seg_isref
    # rewrite semantics per ref unit (rewrite_cigar.hh:96-133): mtype ->
    # I on a dst gap else =/X (EQ stands in — =/X break runs identically
    # and the host reconstructs the real byte comparison); D/N -> dropped
    # on a dst gap else D
    main_code = jnp.where(
        seg_isref,
        jnp.where(
            seg_mtype,
            jnp.where(covered, jnp.int32(I), jnp.int32(EQ)),
            jnp.where(covered, jnp.int32(CODE_NONE), jnp.int32(D)),
        ),
        seg_opc,
    )
    # Non-ref (pass-through) ops must be gated on segment width: a boundary
    # landing exactly on the op's unit position (e.g. a dst-gap run ending
    # at the ref rank just before an I/S op) creates a zero-length segment
    # that `owns` still attributes to the op; emitting seg_cnt there would
    # duplicate the op in the token stream and shift every downstream
    # query/run coordinate.  The op's own segment always has n_seg >= 1
    # (_PR_OP sorts last at its position and the next boundary sits at a
    # strictly greater unit position), so exactly one copy survives.
    main_len = jnp.where(
        seg_isref,
        jnp.where(main_code == CODE_NONE, 0, n_seg),
        jnp.where(n_seg > 0, seg_cnt, 0),
    )

    if _stage == 4:  # segment attribute decode
        return _cut(main_code, main_len, seg_s, seg_e)

    # ---- stage 3: token stream + run recovery (v3 formulation, short T) --
    T = 2 * NB + 1
    tok_code = jnp.concatenate(
        [
            jnp.stack(
                [jnp.full((B, NB), D, jnp.int32), main_code], axis=2
            ).reshape(B, 2 * NB),
            jnp.full((B, 1), CODE_NONE, jnp.int32),
        ],
        axis=1,
    )
    tok_len = jnp.concatenate(
        [
            jnp.stack([sorted_dlen, main_len], axis=2).reshape(B, 2 * NB),
            jnp.zeros((B, 1), jnp.int32),
        ],
        axis=1,
    )

    real = tok_len > 0
    is_i = real & (tok_code == I)
    is_d = real & (tok_code == D)
    is_break = real & ~is_i & ~is_d
    is_break = is_break.at[:, -1].set(True)  # synthetic end-of-CIGAR break

    cons_ref = jnp.asarray(_CONS_REF)[tok_code] * tok_len
    cons_query = jnp.asarray(_CONS_QUERY)[tok_code] * tok_len
    incl_ref = jnp.cumsum(cons_ref, axis=1)
    incl_query = jnp.cumsum(cons_query, axis=1)
    incl_i = jnp.cumsum(is_i.astype(jnp.int32), axis=1)
    incl_d_cnt = jnp.cumsum(is_d.astype(jnp.int32), axis=1)

    stacked = jnp.stack([incl_i, incl_d_cnt, incl_ref, incl_query], axis=1)
    at_break = jnp.where(is_break[:, None, :], stacked, 0)
    prev = _prefix_max_i(
        jnp.pad(at_break[:, :, :-1], ((0, 0), (0, 0), (1, 0))), T, 0
    )
    g_i, g_d, g_ref, g_q = prev[:, 0], prev[:, 1], prev[:, 2], prev[:, 3]

    seg_i = incl_i - g_i
    seg_d = incl_d_cnt - g_d
    report = is_break & (seg_i > 0) & (seg_d > 0)

    run_start_ref = initial[:, None] + g_ref
    run_ref_len = (incl_ref - cons_ref) - g_ref
    run_start_query = g_q
    run_query_len = (incl_query - cons_query) - g_q

    if _stage == 5:  # token stream + run recovery
        return _cut(report, run_start_ref, run_ref_len, run_start_query,
                    run_query_len)

    # ---- stage 4: compact runs into a global slot pool --------------------
    # Slot indices come from a per-record (B, T) cumsum + a (B,)-long
    # record-offset prefix — NOT one flat (B*T) cumsum, whose single long
    # sequential axis this backend lowers pathologically (measured ~11 ms
    # of a 22 ms dispatch; same class as the cummax note in CLAUDE.md).
    rep_i = report.astype(jnp.int32)
    row_incl = jnp.cumsum(rep_i, axis=1)
    row_counts = row_incl[:, -1]
    rec_off = jnp.cumsum(row_counts) - row_counts  # (B,) exclusive
    total_runs = rec_off[-1] + row_counts[-1]
    gslot = rec_off[:, None] + row_incl - 1
    pool_overflow = jnp.where(total_runs > slot_pool, 1, 0).astype(jnp.int32)

    # breaks sit only on main-lane tokens (D-lane tokens are I/D by
    # construction) and the final synthetic column, so the scatters run
    # over that (B, NB+1) sub-lattice — 1/2 the elements — and two 16-bit
    # fields share each lane (bounds: incl_ref/incl_query < 2**16 via the
    # R <= 255 event constraint and the engine's Lq/B < 2**16 guards)
    def main_lane(buf):
        return jnp.concatenate([buf[:, 1::2], buf[:, -1:]], axis=1)

    m_report = main_lane(report)
    m_gslot = main_lane(gslot)
    scatter_idx = jnp.where(
        m_report, jnp.clip(m_gslot, 0, slot_pool - 1), slot_pool
    ).reshape(-1)

    rec_b = jnp.broadcast_to(jnp.arange(B)[:, None], (B, T))
    vals = jnp.stack(
        [
            # per-record reference offset folded in: c_sr then indexes
            # ref_flat directly (no ref_off[c_rec] gather at slice time)
            main_lane(run_start_ref + ref_off[:, None]),
            main_lane((run_ref_len << 16) | rec_b),
            main_lane((run_start_query << 16) | run_query_len),
        ],
        axis=2,
    ).reshape(-1, 3)
    compacted = (
        jnp.zeros((slot_pool, 3), jnp.int32)
        .at[scatter_idx].set(vals, mode="drop")
    )
    c_sr = compacted[:, 0]
    c_rl = compacted[:, 1] >> 16
    c_rec = compacted[:, 1] & 0xFFFF
    c_sq = compacted[:, 2] >> 16
    c_ql = compacted[:, 2] & 0xFFFF

    if _stage == 6:  # run compaction
        return _cut(c_sr, c_rl, c_sq, c_ql, c_rec, total_runs)

    # ---- stage 5: slice gathers + shared DP -------------------------------
    rr = jnp.arange(run_r, dtype=jnp.int32)[None, :]
    rq = jnp.arange(run_q, dtype=jnp.int32)[None, :]
    ref_len = jnp.minimum(c_rl, run_r)
    query_len = jnp.minimum(c_ql, run_q)
    len_overflow = jnp.sum(
        jnp.where((c_rl > run_r) | (c_ql > run_q), 1, 0)
    ).astype(jnp.int32)

    ref_idx = c_sr[:, None] + rr
    ref_slice = dna5_normalise_device(
        ref_flat[jnp.clip(ref_idx, 0, ref_flat.shape[0] - 1)]
    )
    ref_slice = jnp.where(rr < ref_len[:, None], ref_slice, 0)

    q_idx = jnp.clip(c_sq[:, None] + rq, 0, query.shape[1] - 1)
    q_slice = query[c_rec[:, None], q_idx]
    q_slice = jnp.where(rq < query_len[:, None], q_slice, 0)

    if _stage == 7:  # slice gathers
        return _cut(ref_slice, q_slice, query_len, ref_len)

    # same dispatch as the split path (realign_batch.dp_align)
    realign_ops, realign_counts = dp_align(
        ref_slice, q_slice, query_len, ref_len, go, ge, run_r, run_q
    )

    flags = jnp.stack(
        [pool_overflow + len_overflow + cnt_overflow, ev_overflow, total_runs]
    )
    return (
        initial, gapbits, d_vals, d_pos8, d_n8,
        realign_ops, realign_counts, flags,
    )


def make_fused_event_kernel(geo):
    """Jitted fused kernel bound to one DeviceEventGeometry's tables."""
    return jax.jit(
        partial(_fused_event_body, geo),
        static_argnames=("R", "run_r", "run_q", "slot_pool", "_stage"),
    )
