"""Fully-fused projection kernel: rewrite + indel-run detection + realign
DP in one device dispatch.

The two-dispatch engine path (rewrite kernel -> host run detection ->
realign kernel) pays two host-device round trips and host work on the critical
path.  This kernel keeps everything on device:

1. rewrite math over (B, R) reference units (ops/rewrite_batch.rewrite_math);
2. indel-run detection with the checker semantics
   (/root/reference/libpanvc3/indel_run_checker.cc:31-121), fully
   vectorised: the emitted op stream is modelled as a token array
   (B, 2U+1) — each unit contributes its inter-position deletion run and
   its main op, plus one synthetic end-of-CIGAR break — and runs are
   recovered with prefix sums / prefix max over the token axis (a maximal
   I/D stretch between breaks is a run iff it contains both op kinds);
3. run compaction into a fixed pool of slots (prefix-sum scatter; overflow
   reported so the host can fall back);
4. gather of the run's reference/query slices (reference bytes
   dna5-normalised on device) and the batched affine DP + traceback.

The host then recomputes run bookkeeping from the collapsed CIGAR (native
single pass, microseconds) and matches realigned runs 1:1 by order — run
order and ranges are identical on collapsed and uncollapsed op streams
because the checker's transitions depend only on op types.

Quality-aware (-q) scoring is not fused (the default pipeline path is the
integer scheme; -q falls back to the two-dispatch path).

v3 formulation: all monotone-index lookups (per-op -> per-unit expansion,
ref-unit -> unit-position expansion, cumsum-at-previous-break) are
gather-free — scatter-delta + prefix sum, or break-masked prefix max —
because this backend serializes take_along_axis element by element
(measured ~155 ms of a 185 ms dispatch in v2).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..alphabet import dna5_normalise_device
from ..cigar import D, EQ, H, I, N, P, S, X
from .rank_select import DeviceGapIndex
from .realign_batch import dp_align
from .rewrite_batch import CODE_NONE, _IS_REF_OP, expand_by_delta, rewrite_math


# emitted-op classification tables (codes 0..15; emitted stream contains
# D/I/EQ/X from ref units and I/S/H/P pass-through ops)
_CONS_REF = np.zeros(16, np.int32)
for _c in (0, EQ, X, D, N):
    _CONS_REF[_c] = 1
_CONS_QUERY = np.zeros(16, np.int32)
for _c in (0, EQ, X, I, S):
    _CONS_QUERY[_c] = 1


def _prefix_max_i(x, axis_len, fill):
    k = 1
    while k < axis_len:
        shifted = jnp.pad(
            x[..., :-k], [(0, 0)] * (x.ndim - 1) + [(k, 0)], constant_values=fill
        )
        x = jnp.maximum(x, shifted)
        k <<= 1
    return x


@partial(
    jax.jit, static_argnames=("R", "U", "run_r", "run_q", "slot_pool", "_stage")
)
def fused_projection_kernel(
    index: DeviceGapIndex,
    ref_flat: jnp.ndarray,     # uint8[Nref]
    src_seq: jnp.ndarray,      # int32[B]
    dst_seq: jnp.ndarray,      # int32[B]
    rec_src_pos: jnp.ndarray,  # int32[B]
    ref_off: jnp.ndarray,      # int32[B]
    ops: jnp.ndarray,          # int8[B, O]
    counts: jnp.ndarray,       # int32[B, O]
    query: jnp.ndarray,        # uint8[B, Lq]
    go: jnp.ndarray,           # float32
    ge: jnp.ndarray,           # float32
    R: int,                    # max reference units
    U: int,                    # max total units (ref units + pass-through ops)
    run_r: int,                # max run ref length (pad)
    run_q: int,                # max run query length (pad)
    slot_pool: int = 0,        # run-slot pool size (0 -> B)
    _stage: int = 5,           # profiling aid: truncate after stage N
):
    B = src_seq.shape[0]

    def _cut(*parts):
        """Stage-truncated return for tools/bench_fused.py: sums keep a
        data dependency on everything computed so far (no DCE)."""
        acc = jnp.int32(0)
        for p in parts:
            acc = acc + jnp.sum(p.astype(jnp.int32) if p.ndim else p)
        z1 = jnp.zeros((1, 1), jnp.int32)
        return (acc, z1, z1, z1, z1, jnp.stack([acc, acc, acc]), z1)

    dst_pos, d_run, main_code = rewrite_math(
        index, ref_flat, src_seq, dst_seq, rec_src_pos, ref_off, ops, counts,
        query, R,
    )
    if _stage <= 0:
        return _cut(dst_pos, d_run, main_code)

    # ---- device-side unit stream over ALL units (ref + pass-through) ----
    is_ref_op = jnp.asarray(_IS_REF_OP)[ops]
    unit_per_op = jnp.where(is_ref_op, counts, 1)
    unit_pref = jnp.cumsum(unit_per_op, axis=1) - unit_per_op  # exclusive
    total_units = unit_pref[:, -1] + unit_per_op[:, -1]

    ref_counts = jnp.where(is_ref_op, counts, 0)
    ref_pref = jnp.cumsum(ref_counts, axis=1) - ref_counts

    u = jnp.arange(U, dtype=jnp.int32)[None, :]
    u_valid = u < total_units[:, None]

    # expand the per-op arrays over the unit stream (gather-free: the map
    # u -> op is monotone, so scatter first differences at each op's first
    # unit and integrate; see rewrite_batch.expand_by_delta).  ops (4 bits)
    # and is_ref (1 bit) share a lane — scatter volume is the cost here.
    per_op = jnp.stack(
        [counts, (ops.astype(jnp.int32) << 1) | is_ref_op.astype(jnp.int32)],
        axis=2,
    )
    e = expand_by_delta(per_op, unit_pref, U)
    u_is_ref = ((e[:, :, 1] & 1) == 1) & u_valid
    u_count = e[:, :, 0]
    e_ops = e[:, :, 1] >> 1

    # d_run/main_code live on the (B, R) ref-unit axis; ref unit r sits at
    # unit position r + (#non-ref units before its op).  That offset is
    # itself a monotone expansion of (unit_pref - ref_pref) over ref units,
    # so both lookups reduce to two more delta-scatters + prefix sums.
    # d_run (<2^27, guarded via the fallback flag) and main_code (4 bits)
    # pack into one int32 lane to halve the (B, R) -> (B, U) scatter.
    offs = expand_by_delta(
        (unit_pref - ref_pref)[:, :, None], ref_pref, R
    )[:, :, 0]
    u_of_ref = jnp.arange(R, dtype=jnp.int32)[None, :] + offs
    pack_overflow = jnp.sum(
        jnp.where(d_run >= (1 << 27), 1, 0)
    ).astype(jnp.int32)
    per_ref = (d_run << 4) | main_code.astype(jnp.int32)
    w = expand_by_delta(per_ref[:, :, None], u_of_ref, U)[:, :, 0]
    u_d = jnp.where(u_is_ref, w >> 4, 0)
    u_main = jnp.where(u_is_ref, w & 15, e_ops)
    u_main_len = jnp.where(
        u_is_ref, jnp.where(u_main == CODE_NONE, 0, 1), u_count
    )
    u_main = jnp.where(u_valid, u_main, CODE_NONE)
    u_d = jnp.where(u_valid, u_d, 0)
    u_main_len = jnp.where(u_valid, u_main_len, 0)
    if _stage <= 1:
        return _cut(u_main, u_d, u_main_len, u_count)

    # ---- token stream: [D-run, main] per unit + synthetic final break ----
    T = 2 * U + 1
    tok_code = jnp.concatenate(
        [
            jnp.stack(
                [jnp.full((B, U), D, jnp.int32), u_main], axis=2
            ).reshape(B, 2 * U),
            jnp.full((B, 1), CODE_NONE, jnp.int32),
        ],
        axis=1,
    )
    tok_len = jnp.concatenate(
        [
            jnp.stack([u_d, u_main_len], axis=2).reshape(B, 2 * U),
            jnp.zeros((B, 1), jnp.int32),
        ],
        axis=1,
    )

    real = tok_len > 0
    is_i = real & (tok_code == I)
    is_d = real & (tok_code == D)
    is_break = real & ~is_i & ~is_d
    # synthetic end-of-CIGAR break (consumes nothing, always breaks)
    is_break = is_break.at[:, -1].set(True)

    cons_ref = jnp.asarray(_CONS_REF)[tok_code] * tok_len
    cons_query = jnp.asarray(_CONS_QUERY)[tok_code] * tok_len
    incl_ref = jnp.cumsum(cons_ref, axis=1)
    incl_query = jnp.cumsum(cons_query, axis=1)
    incl_i = jnp.cumsum(is_i.astype(jnp.int32), axis=1)
    incl_d_cnt = jnp.cumsum(is_d.astype(jnp.int32), axis=1)

    # value of each inclusive cumsum at the previous break strictly before
    # each token.  The arrays are non-negative and non-decreasing, so
    # "gather at the previous break index" is a right-shifted prefix max of
    # the break-masked values — no take_along_axis needed.
    stacked = jnp.stack([incl_i, incl_d_cnt, incl_ref, incl_query], axis=1)
    at_break = jnp.where(is_break[:, None, :], stacked, 0)
    prev = _prefix_max_i(
        jnp.pad(at_break[:, :, :-1], ((0, 0), (0, 0), (1, 0))), T, 0
    )
    g_i, g_d, g_ref, g_q = prev[:, 0], prev[:, 1], prev[:, 2], prev[:, 3]

    seg_i = incl_i - g_i
    seg_d = incl_d_cnt - g_d
    report = is_break & (seg_i > 0) & (seg_d > 0)

    run_start_ref = dst_pos[:, None] + g_ref
    run_ref_len = (incl_ref - cons_ref) - g_ref
    run_start_query = g_q
    run_query_len = (incl_query - cons_query) - g_q
    if _stage <= 2:
        return _cut(report, run_start_ref, run_ref_len, run_start_query,
                    run_query_len)

    # ---- compact runs into a global slot pool ----------------------------
    if not slot_pool:
        slot_pool = B
    flat_report = report.reshape(-1)
    gslot_incl = jnp.cumsum(flat_report.astype(jnp.int32))
    total_runs = gslot_incl[-1]
    gslot = gslot_incl - 1
    pool_overflow = jnp.where(total_runs > slot_pool, 1, 0).astype(jnp.int32)
    scatter_idx = jnp.where(flat_report, jnp.clip(gslot, 0, slot_pool - 1), slot_pool)

    def compact(buf):
        out = jnp.zeros(slot_pool, jnp.int32)
        return out.at[scatter_idx].set(buf.reshape(-1), mode="drop")

    # fold the per-record reference offset in here: c_sr then indexes
    # ref_flat directly, dropping the ref_off[c_rec] gather round
    c_sr = compact(run_start_ref + ref_off[:, None])
    c_rl = compact(run_ref_len)
    c_sq = compact(run_start_query)
    c_ql = compact(run_query_len)
    c_rec = compact(jnp.broadcast_to(jnp.arange(B)[:, None], (B, T)))
    if _stage <= 3:
        return _cut(c_sr, c_rl, c_sq, c_ql, c_rec, total_runs)

    # ---- gather run slices ----------------------------------------------
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
    if _stage <= 4:
        return _cut(ref_slice, q_slice, query_len, ref_len)

    # ---- batched DP ------------------------------------------------------
    # same dispatch as the split path (realign_batch.dp_align): the
    # compiled GPU kernel or the XLA scans — bit-identical
    realign_ops, realign_counts = dp_align(
        ref_slice, q_slice, query_len, ref_len, go, ge, run_r, run_q
    )

    d8 = jnp.minimum(d_run, 255).astype(jnp.uint8)
    d_overflow = jnp.sum(jnp.where(d_run >= 255, 1, 0)).astype(jnp.int32)
    flags = jnp.stack(
        [pool_overflow + len_overflow + pack_overflow, d_overflow, total_runs]
    )
    return dst_pos, d8, main_code, realign_ops, realign_counts, flags, d_run
