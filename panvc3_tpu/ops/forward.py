"""The flagship jittable forward step: batched coordinate projection.

One fused, fully-jittable function over fixed-shape arrays combining the
two device stages of the projection pipeline:

1. device-side CIGAR expansion + per-base rewrite math (select0/rank0/bit
   gathers + character comparison) from compact (B, O) op arrays;
2. the batched affine-gap realignment DP fill + traceback over (B, RR, RQ)
   run slices.

This is what ``__graft_entry__.entry`` exposes for the single-chip compile
check and what the multi-chip dry run shards over the batch dimension.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from .rank_select import DeviceGapIndex
from .realign_batch import dp_align
from .rewrite_batch import rewrite_math


@partial(jax.jit, static_argnames=("R", "run_r", "run_q"))
def projection_step(
    index: DeviceGapIndex,
    ref_flat: jnp.ndarray,
    src_seq: jnp.ndarray,       # int32[B]
    dst_seq: jnp.ndarray,       # int32[B]
    rec_src_pos: jnp.ndarray,   # int32[B]
    ref_off: jnp.ndarray,       # int32[B]
    ops: jnp.ndarray,           # int8[B, O]
    counts: jnp.ndarray,        # int32[B, O]
    query: jnp.ndarray,         # uint8[B, Lq]
    run_ref: jnp.ndarray,       # uint8[B, RR] realignment run ref slices
    run_query: jnp.ndarray,     # uint8[B, RQ]
    run_ref_len: jnp.ndarray,   # int32[B]
    run_query_len: jnp.ndarray,  # int32[B]
    go: jnp.ndarray,            # float32
    ge: jnp.ndarray,            # float32
    R: int,
    run_r: int,
    run_q: int,
):
    """Returns (dst_pos, d_run, main_code, realign_ops, realign_counts,
    stats) for one batch."""
    dst_pos, d_run, main_code = rewrite_math(
        index, ref_flat, src_seq, dst_seq, rec_src_pos, ref_off, ops, counts,
        query, R,
    )

    realign_ops, realign_counts = dp_align(
        run_ref, run_query, run_query_len, run_ref_len, go, ge, run_r, run_q
    )

    # global statistics ride a cross-device reduction when sharded
    from .rewrite_batch import CODE_NONE

    stats = jnp.stack(
        [
            jnp.sum(jnp.where(main_code != CODE_NONE, 1, 0)),
            jnp.sum(d_run),
            jnp.sum(realign_counts),
        ]
    )
    return dst_pos, d_run, main_code, realign_ops, realign_counts, stats
