"""Batched affine-gap global realignment DP on device.

Device counterpart of :func:`panvc3_tpu.align.align_global` (which mirrors
the reference's seqan3 align_pairwise usage,
/root/reference/include/panvc3/align.hh:59-112).  A batch of (ref slice,
query slice) pairs — the I+D runs found by the indel-run checker — is padded
to a common (R, Q) shape and aligned in parallel:

- the DP fill is a ``lax.scan`` over query rows with an explicit leading
  batch dimension; the in-row horizontal-gap recurrence
  H[j] = max(A[j-1]+open, H[j-1]) + ext is solved row-parallel with a
  log-step doubling prefix max (valid because open <= 0), so each row is
  pure vector ops over the whole batch;
- trace bits (direction 2b + open flags) are stored per cell, matching the
  oracle's tie-breaking exactly: diagonal >= vertical > horizontal, and
  gap-open preferred over extension on ties;
- traceback is a fixed-trip ``lax.scan`` (R+Q steps), batched the same
  way, emitting per-character op codes that the host RLE-collapses.

Scoring: integer hamming (match 0 / mismatch -1) exactly, or the Malde
base-quality scheme quantised to 1/2**MALDE_SHIFT units (align.py): both
paths work on small integers, so the float32 fill is exact and the device
output is byte-identical to the float64 host oracle.  The reference
computes Malde in double (align.hh:21-56); the quantisation deviation is
bounded by (R+Q)/2**(MALDE_SHIFT+1) score units per run — see
align.malde_tables.
"""

from __future__ import annotations

import os
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..cigar import CODE_TO_OP, D, EQ, I, X, Cigar

NEG = jnp.float32(-1e30)

_TR_DIAG = 0
_TR_VERT = 1
_TR_HORIZ = 2


# fill/traceback scan unroll factor: identical math, fewer serialized loop
# iterations; 4 beat 1 by 3-15% on an H100 at 16x16 and 48x48 run pads
# (chip_smoke.py's dp phase times both)
_SCAN_UNROLL = 4


def _substitution_scores(ref, query, ref_qual, query_qual, use_quality):
    """s[i, j] for query i vs ref j. ref/query are uint8 (B, R)/(B, Q).

    The quality path gathers the host-precomputed quantised Malde tables
    (align.malde_tables): every score is a small integer (x MALDE_SCALE),
    so the float32 fill is exact and byte-identical to the float64 host
    oracle — the gap costs arrive pre-scaled by the same factor.

    ``ref_qual=None`` means "reference qualities pinned to phred42 max"
    (the reference ALWAYS does this, alignment_projector.cc:108) — callers
    then ship no ref-quality array at all, and ``query_qual`` may be uint8
    (4x fewer wire bytes than int32; cast here).  Padded cells may score
    differently than with an explicit 0-padded array, but they are masked
    by the m/n lengths and never reach the traceback."""
    eq = query[:, :, None] == ref[:, None, :]
    if not use_quality:
        return jnp.where(eq, 0.0, -1.0).astype(jnp.float32)
    from ..align import malde_tables
    from ..alphabet import PHRED42_MAX

    mt, xt = malde_tables()
    mtj = jnp.asarray(mt, dtype=jnp.float32)
    xtj = jnp.asarray(xt, dtype=jnp.float32)
    qq = query_qual[:, :, None].astype(jnp.int32)
    if ref_qual is None:
        idx = jnp.int32(PHRED42_MAX) * mt.shape[1] + qq  # (B, Q, 1)
    else:
        idx = ref_qual[:, None, :].astype(jnp.int32) * mt.shape[1] + qq
    match_s = jnp.take(mtj.reshape(-1), idx)
    mismatch_s = jnp.take(xtj.reshape(-1), idx)
    return jnp.where(eq, match_s, mismatch_s)


def _prefix_max(x, axis_len):
    """Inclusive prefix maximum along the last axis via log-step doubling.

    Equivalent to jax.lax.cummax, as a handful of pad/shift/max ops.
    Exact: max has no rounding.
    """
    k = 1
    while k < axis_len:
        shifted = jnp.pad(
            x[..., :-k], [(0, 0)] * (x.ndim - 1) + [(k, 0)], constant_values=NEG
        )
        x = jnp.maximum(x, shifted)
        k <<= 1
    return x


def _fill_batch(sub, m, n, go, ge, R, Q, unroll=_SCAN_UNROLL):
    """Manually-batched DP fill.  sub: (B, Q, R); m/n: (B,) actual lengths.

    The recurrences and tie semantics of align.align_global, with an
    explicit leading batch dimension so that each row step is a few vector
    ops over the whole batch.
    Returns packed trace (B, Q+1, R+1) uint8.
    """
    B = sub.shape[0]
    cols = jnp.arange(R + 1)[None, :]                       # (1, R+1)
    col_valid = cols <= n[:, None]                          # (B, R+1)
    neg_col = jnp.full((B, 1), NEG)

    best0 = jnp.where(cols == 0, 0.0, go + ge * cols).astype(jnp.float32)
    best0 = jnp.broadcast_to(best0, (B, R + 1))
    best0 = jnp.where(col_valid, best0, NEG)
    vert0 = jnp.full((B, R + 1), NEG)
    tr0 = jnp.where(cols == 0, 0, _TR_HORIZ).astype(jnp.uint8)
    tr0 = tr0 | jnp.where(cols == 1, jnp.uint8(8), jnp.uint8(0))
    tr0 = jnp.broadcast_to(tr0, (B, R + 1))

    def row_step(carry, row_in):
        best_prev, vert_prev = carry
        i, srow = row_in  # i scalar in [1, Q]; srow: (B, R)
        row_valid = (i <= m)[:, None]                       # (B, 1)

        v_open = best_prev + go + ge
        v_ext = vert_prev + ge
        vopen_bit = v_open >= v_ext
        vert = jnp.maximum(v_open, v_ext)

        diag = jnp.concatenate([neg_col, best_prev[:, :-1] + srow], axis=1)
        diag = jnp.where(cols == 0, NEG, diag)
        a = jnp.maximum(diag, vert)
        border = go + ge * i
        a = a.at[:, 0].set(border)
        vert = vert.at[:, 0].set(border)

        shifted = a + go - ge * cols
        run = _prefix_max(
            jnp.concatenate([neg_col, shifted[:, :-1]], axis=1), R + 1
        )
        horiz = run + ge * cols
        horiz = jnp.where(cols == 0, NEG, horiz)
        best = jnp.maximum(a, horiz)

        h_prev = jnp.concatenate([neg_col, horiz[:, :-1]], axis=1)
        b_prev = jnp.concatenate([neg_col, best[:, :-1]], axis=1)
        hopen_bit = b_prev + go >= h_prev

        tr = jnp.where(diag >= vert, _TR_DIAG, _TR_VERT).astype(jnp.uint8)
        tr = jnp.where(horiz > a, jnp.uint8(_TR_HORIZ), tr)
        tr = jnp.where(cols == 0, jnp.uint8(_TR_VERT), tr)
        packed = (
            tr
            | (jnp.where(vopen_bit, 4, 0) | jnp.where(hopen_bit, 8, 0)).astype(jnp.uint8)
        )
        best = jnp.where(col_valid, best, NEG)
        vert = jnp.where(col_valid, vert, NEG)

        best = jnp.where(row_valid, best, best_prev)
        vert = jnp.where(row_valid, vert, vert_prev)
        packed = jnp.where(row_valid, packed, jnp.uint8(0))
        return (best, vert), packed

    rows = jnp.arange(1, Q + 1)
    # unroll: the scan body is small, so per-step launch overhead is a
    # large fraction of each row; identical math, fewer serialized steps
    (_, _), traces = jax.lax.scan(
        row_step, (best0, vert0), (rows, jnp.swapaxes(sub, 0, 1)),
        unroll=unroll,
    )
    # traces: (Q, B, R+1) -> (B, Q+1, R+1)
    return jnp.concatenate([tr0[:, None, :], jnp.swapaxes(traces, 0, 1)], axis=1)


def _traceback_batch(trace, ref, query, m, n, R, Q, unroll=_SCAN_UNROLL):
    """Manually-batched traceback.  trace: (B, Q+1, R+1).

    Gather/scatter-free: (a) each step reads its cell (and the query/ref
    characters) with a one-hot masked sum over the batch, and (b) since
    ``done`` is monotone, the k-th emitted op is always emitted at step k,
    so the per-step ops stack as scan outputs (no scatter).  Output is
    bit-identical to a ``trace[b, i, j]`` / ``ops.at[b, k].set``
    formulation: entries past ``count`` stay at the 127 filler."""
    B = trace.shape[0]
    max_steps = R + Q
    stride = R + 1
    trace_flat = trace.reshape(B, -1)
    cell_iota = jnp.arange(trace_flat.shape[1], dtype=jnp.int32)[None, :]
    q_iota = jnp.arange(Q, dtype=jnp.int32)[None, :]
    r_iota = jnp.arange(R, dtype=jnp.int32)[None, :]

    def step(carry, _):
        i, j, state, k = carry
        done = (i == 0) & (j == 0)
        idx = i * stride + j
        cell = jnp.sum(
            jnp.where(cell_iota == idx[:, None], trace_flat, jnp.uint8(0)),
            axis=1,
            dtype=jnp.int32,
        )
        tr = cell & 3
        vopen = (cell >> 2) & 1
        hopen = (cell >> 3) & 1

        in_m = state == 0
        eff = jnp.where(in_m, tr, state)
        eff = jnp.where(in_m & (i == 0) & (j > 0), _TR_HORIZ, eff)
        eff = jnp.where(in_m & (j == 0) & (i > 0), _TR_VERT, eff)

        is_diag = (eff == _TR_DIAG) & ~done
        is_vert = (eff == _TR_VERT) & ~done
        is_horiz = (eff == _TR_HORIZ) & ~done

        qc = jnp.sum(
            jnp.where(q_iota == (i - 1)[:, None], query, jnp.uint8(0)),
            axis=1,
            dtype=jnp.int32,
        )
        rc = jnp.sum(
            jnp.where(r_iota == (j - 1)[:, None], ref, jnp.uint8(0)),
            axis=1,
            dtype=jnp.int32,
        )
        op = jnp.where(
            is_diag,
            jnp.where(qc == rc, EQ, X),
            jnp.where(is_vert, I, D),
        ).astype(jnp.int8)
        emit = jnp.where(done, jnp.int8(127), op)
        k = jnp.where(done, k, k + 1)

        ni = jnp.where(is_diag | is_vert, i - 1, i)
        nj = jnp.where(is_diag | is_horiz, j - 1, j)
        ns = jnp.where(
            is_diag,
            0,
            jnp.where(
                is_vert,
                jnp.where(vopen == 1, 0, 1),
                jnp.where(hopen == 1, 0, 2),
            ),
        )
        ns = jnp.where(done, state, ns)
        ni = jnp.where(done, i, ni)
        nj = jnp.where(done, j, nj)
        return (ni, nj, ns, k), emit

    zeros = jnp.zeros(B, jnp.int32)
    (fi, fj, _, count), emits = jax.lax.scan(
        step, (m, n, zeros, zeros), None, length=max_steps,
        unroll=unroll,
    )
    return jnp.swapaxes(emits, 0, 1), count


def dp_align(ref, query, m, n, go, ge, R, Q, qq=None):
    """Batched DP fill + traceback of (B, R) ref / (B, Q) query rows with
    query/ref lengths m/n: (ops int8 (B, R+Q), count int32 (B,)).

    ``qq=None`` scores the integer scheme; otherwise Malde quality scores
    with the reference qualities pinned to phred42 max (the reference's
    rule) and query phreds ``qq`` (B, Q), gap costs pre-scaled by
    MALDE_SCALE."""
    sub = _substitution_scores(ref, query, None, qq, qq is not None)
    trace = _fill_batch(sub, m, n, go, ge, R, Q)
    return _traceback_batch(trace, ref, query, m, n, R, Q)


@partial(jax.jit, static_argnames=("use_quality", "R", "Q"))
def realign_device_kernel(
    ref: jnp.ndarray,        # uint8[B, R]
    query: jnp.ndarray,      # uint8[B, Q]
    ref_len: jnp.ndarray,    # int32[B]
    query_len: jnp.ndarray,  # int32[B]
    go: jnp.ndarray,         # float32 scalar
    ge: jnp.ndarray,         # float32 scalar
    ref_qual: jnp.ndarray | None,   # int32[B, R], or None = phred42 max
    query_qual: jnp.ndarray,        # int (any width)[B, Q]
    use_quality: bool,
    R: int,
    Q: int,
):
    if use_quality and ref_qual is not None:
        # an EXPLICIT ref-quality array (tests only)
        sub = _substitution_scores(ref, query, ref_qual, query_qual, True)
        trace = _fill_batch(sub, query_len, ref_len, go, ge, R, Q)
        return _traceback_batch(trace, ref, query, query_len, ref_len, R, Q)
    return dp_align(
        ref, query, query_len, ref_len, go, ge, R, Q,
        qq=query_qual if use_quality else None,
    )


# ---------------------------------------------------------------------------
# Single-buffer wire format for the fast lane (integer-scoring path): one u8
# array each way, to cut transfers and bytes.  Input row (R+Q+4 B):
# [ref R | query Q | ref_len u16 LE | query_len u16 LE].  Output row
# ((R+Q)/2 + 1 B): [ops nibble-packed (R+Q)/2 | count u8]; valid since the
# run buckets keep R+Q < 256 and op codes are 4-bit.
# ---------------------------------------------------------------------------


def pack_realign_wire_input(
    ref: np.ndarray, query: np.ndarray, rl: np.ndarray, ql: np.ndarray
) -> np.ndarray:
    s, r = ref.shape
    q = query.shape[1]
    out = np.empty((s, r + q + 4), dtype=np.uint8)
    out[:, :r] = ref
    out[:, r:r + q] = query
    out[:, r + q:r + q + 2] = rl.astype("<u2").view(np.uint8).reshape(s, 2)
    out[:, r + q + 2:] = ql.astype("<u2").view(np.uint8).reshape(s, 2)
    return out


def _realign_wire(packed_in, go, ge, R, Q):
    p = packed_in
    ref = p[:, :R]
    query = p[:, R:R + Q]
    tail = p[:, R + Q:].astype(jnp.int32)
    rl = tail[:, 0] | (tail[:, 1] << 8)
    ql = tail[:, 2] | (tail[:, 3] << 8)
    ops, count = dp_align(ref, query, ql, rl, go, ge, R, Q)
    nib = (ops.astype(jnp.uint8)) & 0xF
    packed_ops = nib[:, 0::2] | (nib[:, 1::2] << 4)
    return jnp.concatenate(
        [packed_ops, jnp.minimum(count, 255).astype(jnp.uint8)[:, None]], axis=1
    )


realign_device_kernel_wire = jax.jit(_realign_wire, static_argnames=("R", "Q"))


# ---------------------------------------------------------------------------
# Ref-gather wire: the reference rows stay on device (row-gathered from the
# resident flat reference), and the query ships as 4-bit MATCH-EQUIVALENCE
# codes.  The DP's output depends on the query only through the match
# matrix against dna5-normalised reference bytes ({A,C,G,T,N}) and zero
# padding, so a 7-value code preserves it exactly: A/C/G/T/N round-trip,
# every other byte maps to a canonical non-matching byte (0x01), and NUL
# stays NUL (padding).  Input row (Q/2 + 8 B):
# [query codes 4-bit packed | ref start u32 LE | ref_len u16 | query_len
# u16].  Output row (steps/4 + 1 B): the traceback ops 2-bit packed
# (=,X,I,D are the only codes a traceback emits) plus the count byte.
# ---------------------------------------------------------------------------

# byte -> match-equivalence code
QUERY_CODE = np.full(256, 5, dtype=np.uint8)  # OTHER
for _i, _c in enumerate(b"ACGTN"):
    QUERY_CODE[_c] = _i
QUERY_CODE[0] = 6  # PAD (stays NUL)
# code -> canonical byte (OTHER -> 0x01: never equals a dna5 ref byte or 0)
QUERY_DECODE = np.frombuffer(b"ACGTN\x01\x00\x00", dtype=np.uint8).copy()

_TB_OPS = (7, 8, 1, 2)  # =, X, I, D — the only ops a traceback emits


def pack_realign_refgather_input(
    query: np.ndarray, start: np.ndarray, rl: np.ndarray, ql: np.ndarray
) -> np.ndarray:
    s, q = query.shape
    codes = QUERY_CODE[query]
    out = np.empty((s, q // 2 + 8), dtype=np.uint8)
    out[:, : q // 2] = codes[:, 0::2] | (codes[:, 1::2] << 4)
    out[:, q // 2: q // 2 + 4] = (
        start.astype("<u4").view(np.uint8).reshape(s, 4)
    )
    out[:, q // 2 + 4: q // 2 + 6] = (
        rl.astype("<u2").view(np.uint8).reshape(s, 2)
    )
    out[:, q // 2 + 6:] = ql.astype("<u2").view(np.uint8).reshape(s, 2)
    return out


def unpack_realign_refgather_wire(wire: np.ndarray, steps: int):
    """(ops int8[S, steps], count int32[S]) from a fetched ref-gather wire
    buffer (2-bit op codes); entries past ``count`` are never read
    downstream."""
    s = wire.shape[0]
    quarter = steps // 4
    lut = np.asarray(_TB_OPS, dtype=np.int8)
    ops = np.empty((s, steps), dtype=np.int8)
    body = wire[:, :quarter]
    ops[:, 0::4] = lut[body & 3]
    ops[:, 1::4] = lut[(body >> 2) & 3]
    ops[:, 2::4] = lut[(body >> 4) & 3]
    ops[:, 3::4] = lut[body >> 6]
    count = wire[:, quarter].astype(np.int32)
    return ops, count


def _realign_wire_refgather(packed_in, ref_flat, go, ge, R, Q):
    """Classic wire DP with both wire directions slimmed: reference rows
    row-gathered from the flat reference (raw bytes; the per-contig text
    the fused kernels already keep resident), dna5-normalised +
    zero-padded in-kernel to reproduce stage_realign_runs' staged rows
    exactly (native/fastpath.c pv3_stage_realign_runs writes
    dna5_table[ref[k]] for k < rl and zeros beyond); query rows decoded
    from 4-bit codes; traceback ops returned 2-bit packed."""
    from ..alphabet import dna5_normalise_device

    p = packed_in
    half = Q // 2
    query = _decode_query_codes(p[:, :half], Q)
    tail = p[:, half:].astype(jnp.int32)
    start = tail[:, 0] | (tail[:, 1] << 8) | (tail[:, 2] << 16) | (
        tail[:, 3] << 24
    )
    rl = tail[:, 4] | (tail[:, 5] << 8)
    ql = tail[:, 6] | (tail[:, 7] << 8)
    lane = jnp.arange(R, dtype=jnp.int32)[None, :]
    idx = jnp.clip(start[:, None] + lane, 0, ref_flat.shape[0] - 1)
    ref = dna5_normalise_device(jnp.take(ref_flat, idx, axis=0))
    ref = jnp.where(lane < rl[:, None], ref, jnp.uint8(0))
    ops, count = dp_align(ref, query, ql, rl, go, ge, R, Q)
    return _pack_ops_2bit(ops, count)


# ---------------------------------------------------------------------------
# 2-bit ref-gather wire: when every in-length query byte is A/C/G/T (the
# overwhelmingly common case — N-free windows), the query ships as 2-bit
# codes and the lens as single bytes.  Input row (Q/4 + 6 B):
# [query 2-bit packed Q/4 | ref start u32 LE | ref_len u8 | query_len u8].
# Output row identical to the 4-bit ref-gather wire (2-bit packed ops +
# count).  Positions >= query_len decode arbitrarily and are masked to the
# staged rows' zero padding in-kernel, so the DP sees byte-identical
# inputs to the 4-bit wire.  Requires Q % 4 == 0 and rl/ql <= 255 (the
# aggregate {p,1.5p} buckets guarantee both).
# ---------------------------------------------------------------------------

QUERY_CODE2 = np.full(256, 255, dtype=np.uint8)
for _i, _c in enumerate(b"ACGT"):
    QUERY_CODE2[_c] = _i
_ACGT = np.frombuffer(b"ACGT", dtype=np.uint8).copy()


def query_wire2_eligible(query: np.ndarray, ql: np.ndarray) -> bool:
    """True iff every in-length byte of every row is one of A/C/G/T (rows
    are zero-padded past ql by construction, so padding never disqualifies)."""
    if query.shape[1] % 4:
        return False
    codes = QUERY_CODE2[query]
    in_len = np.arange(query.shape[1], dtype=np.int32)[None, :] < ql[:, None]
    return bool(np.all(codes[in_len] <= 3)) if in_len.any() else True


def pack_realign_refgather2_input(
    query: np.ndarray, start: np.ndarray, rl: np.ndarray, ql: np.ndarray
) -> np.ndarray:
    s, q = query.shape
    codes = QUERY_CODE2[query] & 3  # pad bytes (0) encode as 'A'; masked in-kernel
    quarter = q // 4
    out = np.empty((s, quarter + 6), dtype=np.uint8)
    out[:, :quarter] = (
        codes[:, 0::4]
        | (codes[:, 1::4] << 2)
        | (codes[:, 2::4] << 4)
        | (codes[:, 3::4] << 6)
    )
    out[:, quarter:quarter + 4] = (
        start.astype("<u4").view(np.uint8).reshape(s, 4)
    )
    out[:, quarter + 4] = rl.astype(np.uint8)
    out[:, quarter + 5] = ql.astype(np.uint8)
    return out


def _decode_query_codes2(packed_q, Q, ql):
    """2-bit codes -> canonical A/C/G/T bytes, zero past ql (reproducing
    the staged rows' padding exactly)."""
    codes = jnp.empty((packed_q.shape[0], Q), jnp.uint8)
    codes = codes.at[:, 0::4].set(packed_q & 3)
    codes = codes.at[:, 1::4].set((packed_q >> 2) & 3)
    codes = codes.at[:, 2::4].set((packed_q >> 4) & 3)
    codes = codes.at[:, 3::4].set(packed_q >> 6)
    query = jnp.uint8(0)
    for code, byte in enumerate(_ACGT):
        query = jnp.where(codes == jnp.uint8(code), jnp.uint8(byte), query)
    lane = jnp.arange(Q, dtype=jnp.int32)[None, :]
    return jnp.where(lane < ql[:, None], query, jnp.uint8(0))


def _realign_wire_refgather2(packed_in, ref_flat, go, ge, R, Q):
    from ..alphabet import dna5_normalise_device

    p = packed_in
    quarter = Q // 4
    tail = p[:, quarter:].astype(jnp.int32)
    start = tail[:, 0] | (tail[:, 1] << 8) | (tail[:, 2] << 16) | (
        tail[:, 3] << 24
    )
    rl = tail[:, 4]
    ql = tail[:, 5]
    query = _decode_query_codes2(p[:, :quarter], Q, ql)
    lane = jnp.arange(R, dtype=jnp.int32)[None, :]
    idx = jnp.clip(start[:, None] + lane, 0, ref_flat.shape[0] - 1)
    ref = dna5_normalise_device(jnp.take(ref_flat, idx, axis=0))
    ref = jnp.where(lane < rl[:, None], ref, jnp.uint8(0))
    ops, count = dp_align(ref, query, ql, rl, go, ge, R, Q)
    return _pack_ops_2bit(ops, count)


realign_device_kernel_wire_refgather2 = jax.jit(
    _realign_wire_refgather2, static_argnames=("R", "Q")
)


def pack_realign_refgather2_input_q(
    query: np.ndarray, start: np.ndarray, rl: np.ndarray, ql: np.ndarray,
    qq: np.ndarray,
) -> np.ndarray:
    """-q variant: query phreds are 6-bit (Malde tables have 64 rows), so
    four pack into three bytes.  Row (Q/4 + 3Q/4 + 6 B) =
    [codes 2-bit | qq 6-bit packed | start u32 | rl u8 | ql u8]."""
    s, q = query.shape
    codes = QUERY_CODE2[query] & 3
    quarter = q // 4
    out = np.empty((s, quarter + 3 * quarter + 6), dtype=np.uint8)
    out[:, :quarter] = (
        codes[:, 0::4]
        | (codes[:, 1::4] << 2)
        | (codes[:, 2::4] << 4)
        | (codes[:, 3::4] << 6)
    )
    v = qq.astype(np.uint8)
    v0, v1, v2, v3 = v[:, 0::4], v[:, 1::4], v[:, 2::4], v[:, 3::4]
    out[:, quarter + 0:quarter + 3 * quarter:3] = v0 | (v1 << 6)
    out[:, quarter + 1:quarter + 3 * quarter:3] = (v1 >> 2) | (v2 << 4)
    out[:, quarter + 2:quarter + 3 * quarter:3] = (v2 >> 4) | (v3 << 2)
    out[:, 4 * quarter:4 * quarter + 4] = (
        start.astype("<u4").view(np.uint8).reshape(s, 4)
    )
    out[:, 4 * quarter + 4] = rl.astype(np.uint8)
    out[:, 4 * quarter + 5] = ql.astype(np.uint8)
    return out


def _realign_wire_refgather2_q(packed_in, ref_flat, go, ge, R, Q):
    from ..alphabet import dna5_normalise_device

    p = packed_in
    quarter = Q // 4
    tail = p[:, 4 * quarter:].astype(jnp.int32)
    start = tail[:, 0] | (tail[:, 1] << 8) | (tail[:, 2] << 16) | (
        tail[:, 3] << 24
    )
    rl = tail[:, 4]
    ql = tail[:, 5]
    query = _decode_query_codes2(p[:, :quarter], Q, ql)
    qb = p[:, quarter:4 * quarter].astype(jnp.int32)
    b0, b1, b2 = qb[:, 0::3], qb[:, 1::3], qb[:, 2::3]
    qq = jnp.empty((p.shape[0], Q), jnp.int32)
    qq = qq.at[:, 0::4].set(b0 & 63)
    qq = qq.at[:, 1::4].set((b0 >> 6) | ((b1 & 15) << 2))
    qq = qq.at[:, 2::4].set((b1 >> 4) | ((b2 & 3) << 4))
    qq = qq.at[:, 3::4].set(b2 >> 2)
    lane_q = jnp.arange(Q, dtype=jnp.int32)[None, :]
    qq = jnp.where(lane_q < ql[:, None], qq, 0)
    lane = jnp.arange(R, dtype=jnp.int32)[None, :]
    idx = jnp.clip(start[:, None] + lane, 0, ref_flat.shape[0] - 1)
    ref = dna5_normalise_device(jnp.take(ref_flat, idx, axis=0))
    ref = jnp.where(lane < rl[:, None], ref, jnp.uint8(0))
    ops, count = dp_align(ref, query, ql, rl, go, ge, R, Q, qq=qq)
    return _pack_ops_2bit(ops, count)


realign_device_kernel_wire_refgather2_q = jax.jit(
    _realign_wire_refgather2_q, static_argnames=("R", "Q")
)


def _pack_ops_2bit(ops, count):
    """2-bit encode: ops are in {=,X,I,D}; anything past count is padding
    and may encode arbitrarily (downstream never reads it)."""
    o = ops.astype(jnp.uint8)
    code2 = (
        jnp.where(o == jnp.uint8(8), jnp.uint8(1), jnp.uint8(0))
        | jnp.where(o == jnp.uint8(1), jnp.uint8(2), jnp.uint8(0))
        | jnp.where(o == jnp.uint8(2), jnp.uint8(3), jnp.uint8(0))
    )
    packed_ops = (
        code2[:, 0::4]
        | (code2[:, 1::4] << 2)
        | (code2[:, 2::4] << 4)
        | (code2[:, 3::4] << 6)
    )
    return jnp.concatenate(
        [packed_ops, jnp.minimum(count, 255).astype(jnp.uint8)[:, None]], axis=1
    )


def _decode_query_codes(packed_q, Q):
    """4-bit match-equivalence codes -> canonical query bytes (elementwise
    selects)."""
    codes = jnp.empty((packed_q.shape[0], Q), jnp.uint8)
    codes = codes.at[:, 0::2].set(packed_q & 0xF)
    codes = codes.at[:, 1::2].set(packed_q >> 4)
    query = jnp.uint8(0)
    for code, byte in enumerate(QUERY_DECODE[:6]):
        query = jnp.where(codes == jnp.uint8(code), jnp.uint8(byte), query)
    return query


realign_device_kernel_wire_refgather = jax.jit(
    _realign_wire_refgather, static_argnames=("R", "Q")
)


# ---------------------------------------------------------------------------
# Quality (-q) wire variants: same layouts as their integer twins plus the
# query phreds as u8 (ref qualities are pinned to phred42 max by the
# reference's rule, so none ship).  Output is the 2-bit packed traceback
# both ways (steps % 4 == 0 and steps < 256 required — the aggregate row
# buckets guarantee both).  Gap costs arrive pre-scaled by MALDE_SCALE.
# Input rows:
#   classic    (R + 2Q + 4 B): [ref R | query Q | qq u8 Q | rl u16 | ql u16]
#   ref-gather (Q/2 + Q + 8 B): [query codes | qq u8 | start u32 | rl | ql]
# ---------------------------------------------------------------------------


def pack_realign_wire_input_q(
    ref: np.ndarray, query: np.ndarray, rl: np.ndarray, ql: np.ndarray,
    qq: np.ndarray,
) -> np.ndarray:
    s, r = ref.shape
    q = query.shape[1]
    out = np.empty((s, r + 2 * q + 4), dtype=np.uint8)
    out[:, :r] = ref
    out[:, r:r + q] = query
    out[:, r + q:r + 2 * q] = qq
    out[:, r + 2 * q:r + 2 * q + 2] = (
        rl.astype("<u2").view(np.uint8).reshape(s, 2)
    )
    out[:, r + 2 * q + 2:] = ql.astype("<u2").view(np.uint8).reshape(s, 2)
    return out


def _realign_wire_q(packed_in, go, ge, R, Q):
    p = packed_in
    ref = p[:, :R]
    query = p[:, R:R + Q]
    qq = p[:, R + Q:R + 2 * Q].astype(jnp.int32)
    tail = p[:, R + 2 * Q:].astype(jnp.int32)
    rl = tail[:, 0] | (tail[:, 1] << 8)
    ql = tail[:, 2] | (tail[:, 3] << 8)
    ops, count = dp_align(ref, query, ql, rl, go, ge, R, Q, qq=qq)
    return _pack_ops_2bit(ops, count)


realign_device_kernel_wire_q = jax.jit(
    _realign_wire_q, static_argnames=("R", "Q")
)


def pack_realign_refgather_input_q(
    query: np.ndarray, start: np.ndarray, rl: np.ndarray, ql: np.ndarray,
    qq: np.ndarray,
) -> np.ndarray:
    s, q = query.shape
    codes = QUERY_CODE[query]
    half = q // 2
    out = np.empty((s, half + q + 8), dtype=np.uint8)
    out[:, :half] = codes[:, 0::2] | (codes[:, 1::2] << 4)
    out[:, half:half + q] = qq
    out[:, half + q:half + q + 4] = (
        start.astype("<u4").view(np.uint8).reshape(s, 4)
    )
    out[:, half + q + 4:half + q + 6] = (
        rl.astype("<u2").view(np.uint8).reshape(s, 2)
    )
    out[:, half + q + 6:] = ql.astype("<u2").view(np.uint8).reshape(s, 2)
    return out


def _realign_wire_refgather_q(packed_in, ref_flat, go, ge, R, Q):
    from ..alphabet import dna5_normalise_device

    p = packed_in
    half = Q // 2
    query = _decode_query_codes(p[:, :half], Q)
    qq = p[:, half:half + Q].astype(jnp.int32)
    tail = p[:, half + Q:].astype(jnp.int32)
    start = tail[:, 0] | (tail[:, 1] << 8) | (tail[:, 2] << 16) | (
        tail[:, 3] << 24
    )
    rl = tail[:, 4] | (tail[:, 5] << 8)
    ql = tail[:, 6] | (tail[:, 7] << 8)
    lane = jnp.arange(R, dtype=jnp.int32)[None, :]
    idx = jnp.clip(start[:, None] + lane, 0, ref_flat.shape[0] - 1)
    ref = dna5_normalise_device(jnp.take(ref_flat, idx, axis=0))
    ref = jnp.where(lane < rl[:, None], ref, jnp.uint8(0))
    ops, count = dp_align(ref, query, ql, rl, go, ge, R, Q, qq=qq)
    return _pack_ops_2bit(ops, count)


realign_device_kernel_wire_refgather_q = jax.jit(
    _realign_wire_refgather_q, static_argnames=("R", "Q")
)


def unpack_realign_wire(wire: np.ndarray, steps: int):
    """(ops int8[S, steps], count int32[S]) from a fetched wire buffer.
    Nibble 15 decodes from the int8 padding byte 127 (127 & 0xF == 15);
    entries past ``count`` are never read downstream."""
    s = wire.shape[0]
    half = steps // 2
    ops = np.empty((s, steps), dtype=np.int8)
    ops[:, 0::2] = (wire[:, :half] & 0xF).astype(np.int8)
    ops[:, 1::2] = (wire[:, :half] >> 4).astype(np.int8)
    count = wire[:, half].astype(np.int32)
    return ops, count


def realign_batch(
    refs: list[bytes],
    queries: list[bytes],
    gap_opening: int,
    gap_extension: int,
    ref_quals: list[np.ndarray] | None = None,
    query_quals: list[np.ndarray] | None = None,
    pad_ref: int | None = None,
    pad_query: int | None = None,
) -> list[Cigar]:
    """Align each (ref, query) pair; returns collapsed per-run CIGARs."""
    return realign_batch_finish(
        realign_batch_start(
            refs, queries, gap_opening, gap_extension,
            ref_quals, query_quals, pad_ref, pad_query,
        )
    )


#: Sentinel for ``ref_quals``: reference qualities pinned to phred42 max
#: (the production rule, /root/reference/libpanvc3/alignment_projector.cc:108)
#: without materialising or re-scanning per-run arrays on every dispatch.
PINNED_REF_QUALS = object()


def realign_batch_start(
    refs: list[bytes],
    queries: list[bytes],
    gap_opening: int,
    gap_extension: int,
    ref_quals: list[np.ndarray] | None = None,
    query_quals: list[np.ndarray] | None = None,
    pad_ref: int | None = None,
    pad_query: int | None = None,
):
    """Dispatch the DP fill asynchronously; finish with
    :func:`realign_batch_finish`.  Splitting dispatch from fetch lets the
    engine keep the realignment of batch k on the device while batch k+1's
    rewrite streams (JAX async dispatch)."""
    b = len(refs)
    if b == 0:
        return None
    R = pad_ref if pad_ref is not None else max(1, max(len(r) for r in refs))
    Q = pad_query if pad_query is not None else max(1, max(len(q) for q in queries))
    ref_arr = np.zeros((b, R), dtype=np.uint8)
    q_arr = np.zeros((b, Q), dtype=np.uint8)
    # quality arrays are dead at trace time when quality scoring is off —
    # ship 4-byte dummies instead of zeros
    use_quality = ref_quals is not None
    rq_pinned = ref_quals is PINNED_REF_QUALS
    rq = np.zeros(
        (b, R) if use_quality and not rq_pinned else (1, 1), dtype=np.int32
    )
    qq = np.zeros((b, Q) if use_quality else (1, 1), dtype=np.int32)
    rl = np.zeros(b, dtype=np.int32)
    ql = np.zeros(b, dtype=np.int32)
    for i, (r, q) in enumerate(zip(refs, queries)):
        ref_arr[i, :len(r)] = np.frombuffer(r, dtype=np.uint8)
        q_arr[i, :len(q)] = np.frombuffer(q, dtype=np.uint8)
        rl[i] = len(r)
        ql[i] = len(q)
        if use_quality:
            if not rq_pinned:
                rq[i, :len(r)] = ref_quals[i]
            if query_quals is not None:
                qq[i, :len(q)] = query_quals[i]
    # Adaptive dispatch: a typical batch's runs are a few hundred thousand
    # real DP cells — far below the device round-trip break-even — so run
    # the bit-identical C DP (native realign_runs_host, differentially
    # tested against the kernel) on the host when the cell count is small.
    # Integral gap costs only: both schemes are then exact in float32
    # (hamming, or the quantised Malde tables), so host and device cannot
    # diverge.
    if _host_dp_threshold(gap_opening, gap_extension):
        cells = int(rl.astype(np.int64) @ ql.astype(np.int64))
        if cells <= _host_dp_threshold(gap_opening, gap_extension):
            from ..native import get_native

            nat = get_native()
            if use_quality:
                from ..align import MALDE_SCALE, malde_tables

                if R + Q > 5461:
                    raise ValueError(
                        f"quality-scored realignment run too long for the "
                        f"exact quantised path (R+Q={R + Q} > 5461)"
                    )
                mt, xt = malde_tables()
                if rq_pinned:
                    from ..alphabet import PHRED42_MAX

                    # in-row positions beyond each run's length are never
                    # read by the DP, so a full-constant array is exact
                    rq = np.full((b, R), PHRED42_MAX, dtype=np.int32)
                ops_b, cnt_b = nat.realign_runs_host(
                    ref_arr.tobytes(), q_arr.tobytes(),
                    rl.tobytes(), ql.tobytes(),
                    R, Q,
                    float(gap_opening) * MALDE_SCALE,
                    float(gap_extension) * MALDE_SCALE,
                    np.ascontiguousarray(rq).tobytes(),
                    np.ascontiguousarray(qq).tobytes(),
                    mt.tobytes(), xt.tobytes(),
                )
            else:
                ops_b, cnt_b = nat.realign_runs_host(
                    ref_arr.tobytes(), q_arr.tobytes(),
                    rl.tobytes(), ql.tobytes(),
                    R, Q, float(gap_opening), float(gap_extension),
                )
            return (
                "host",
                np.frombuffer(ops_b, np.int8).reshape(b, R + Q),
                np.frombuffer(cnt_b, np.int32),
            )
    # quality mode: gap costs join the quantised-score units (align.py
    # MALDE_SHIFT); float32 stays exact for R+Q <= 5461
    gscale = 1.0
    if use_quality:
        from ..align import MALDE_SCALE

        gscale = MALDE_SCALE
        if R + Q > 5461:
            raise ValueError(
                f"quality-scored realignment run too long for the exact "
                f"quantised path (R+Q={R + Q} > 5461)"
            )
    # pinned reference qualities (the production rule — engine.py passes
    # PINNED_REF_QUALS) ship as rq=None: dp_align's pinned-quality mode.
    # Explicit arrays (tests) that happen to be all-max collapse the same
    # way; that scan never runs on the production dispatch path.
    rq_dev = rq
    if use_quality:
        from ..alphabet import PHRED42_MAX

        if rq_pinned or all(
            (np.asarray(a) == PHRED42_MAX).all() for a in ref_quals
        ):
            rq_dev = None
    return realign_device_kernel(
        ref_arr,
        q_arr,
        rl,
        ql,
        np.float32(gap_opening * gscale),
        np.float32(gap_extension * gscale),
        rq_dev,
        qq,
        ref_quals is not None,
        R,
        Q,
    )


def _host_dp_threshold(gap_opening, gap_extension) -> int:
    """Real-cell count below which the host C DP replaces the device
    dispatch; 0 when the host path is unavailable or inapplicable."""
    import os

    if os.environ.get("PANVC3_HOST_DP") == "0":
        return 0
    if not (
        float(gap_opening).is_integer() and float(gap_extension).is_integer()
    ):
        return 0
    from ..native import get_native

    nat = get_native()
    if nat is None or not hasattr(nat, "realign_runs_host"):
        return 0
    return int(os.environ.get("PANVC3_HOST_DP_CELLS", "4000000"))


def realign_batch_finish(out) -> list[Cigar]:
    """Fetch + decode the CIGARs of a realign_batch_start dispatch."""
    if out is None:
        return []
    if isinstance(out, tuple) and isinstance(out[0], str):
        _, ops, counts = out
    else:
        ops, counts = jax.device_get(out)
    b = ops.shape[0]
    res: list[Cigar] = []
    for i in range(b):
        k = int(counts[i])
        rev = ops[i, :k][::-1]
        cig: Cigar = []
        for code in rev.tolist():
            ch = CODE_TO_OP[int(code)]
            if cig and cig[-1][1] == ch:
                cig[-1] = (cig[-1][0] + 1, ch)
            else:
                cig.append((1, ch))
        res.append(cig)
    return res
