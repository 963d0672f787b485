"""Vectorised rank0/select0 over packed gap bitvectors on device.

The device replacement for sdsl rank/select supports
(/root/reference/include/panvc3/msa_index.hh:43-54): the host-side
GapBitVector arrays (uint32 words + per-word cumulative zero counts) are
concatenated across sequences into flat HBM-resident buffers; queries are
batched arrays of (sequence id, position), answered with gathers +
``lax.population_count`` and fixed-trip-count binary searches — no
data-dependent control flow, so everything fuses under jit and shards
trivially over the query batch dimension.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

from ..bitvec import GapBitVector


# Fallback acceleration-table budget when the backend exposes no memory
# statistics (the CPU backend): 2 GB.  On a GPU, memory_stats() sets it.
DEFAULT_TABLE_BUDGET_BYTES = 2 * 1024 * 1024 * 1024

# Fraction of free device memory the acceleration tables may claim.  The
# tables are a pure speed/space trade (the block-rank fallback answers the
# same queries; msa_index.hh:43-54 is the reference's version of the same
# trade via RRR), so they must never crowd out batch buffers.
TABLE_BUDGET_FRACTION = 0.25


def _table_budget_bytes() -> int:
    """Free-HBM-derived budget for the zsel/rtab acceleration tables."""
    try:
        dev = jax.devices()[0]
        stats = dev.memory_stats()
        if stats and "bytes_limit" in stats:
            free = int(stats["bytes_limit"]) - int(stats.get("bytes_in_use", 0))
            return max(0, int(free * TABLE_BUDGET_FRACTION))
    except Exception:  # noqa: BLE001 — experimental backends lack the API
        pass
    return DEFAULT_TABLE_BUDGET_BYTES


@jax.tree_util.register_pytree_node_class
@dataclass
class DeviceGapIndex:
    """Flattened, device-friendly stack of gap bitvectors.

    Sequences are identified by dense ids (order of construction).  All
    arrays are immutable; the whole structure is a pytree so it can be
    donated/replicated/sharded with jax.device_put or closed over in jit.

    ``zsel`` is an optional explicit select table: the aligned position of
    every zero, concatenated per sequence — select0 becomes one gather
    instead of a ~14-step binary search (the searches gather randomly and
    dominate kernel time otherwise).  It costs 4 bytes per unaligned base
    per sequence and is dropped above SELECT_TABLE_MAX_ZEROS.
    """

    words: jnp.ndarray        # uint32[total_words] packed bits
    brank: jnp.ndarray        # int32[total_brank] per-word cumulative zeros (len nwords+1 per seq)
    seq_word_off: jnp.ndarray  # int32[S]
    seq_brank_off: jnp.ndarray  # int32[S]
    seq_nwords: jnp.ndarray   # int32[S]
    seq_nzeros: jnp.ndarray   # int32[S]
    zsel: jnp.ndarray | None  # int32[total_zeros+PAD] aligned position of each zero
    seq_zsel_off: jnp.ndarray  # int32[S]
    # dense combined table: (rank0(pos) << 1) | gap_bit(pos) per aligned
    # position (len n+1 per seq; bit of the one-past-end entry is 0) — one
    # gather answers rank0_and_bit
    rtab: jnp.ndarray | None  # int32[total_cols+S]
    seq_rtab_off: jnp.ndarray  # int32[S]
    search_steps: int         # static: ceil(log2(max nwords + 1))

    # zsel tail padding so consecutive-rank select can load R-length slices
    # without clamping away valid entries (R above this falls back to the
    # elementwise gather)
    SELECT_SLICE_PAD = 4096

    def tree_flatten(self):
        children = (
            self.words, self.brank, self.seq_word_off, self.seq_brank_off,
            self.seq_nwords, self.seq_nzeros, self.zsel, self.seq_zsel_off,
            self.rtab, self.seq_rtab_off,
        )
        return children, self.search_steps

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children, aux)

    @classmethod
    def build(cls, vectors: list[GapBitVector], with_select_table: bool | None = None,
              with_rank_table: bool | None = None) -> "DeviceGapIndex":
        words_parts = []
        brank_parts = []
        word_off = []
        brank_off = []
        nwords = []
        nzeros = []
        woff = boff = 0
        for gv in vectors:
            words_parts.append(gv.words)
            # per-word zero ranks, materialised transiently for the HBM
            # copy (the host directory is two-level, bitvec.GapBitVector)
            wr = gv._word_rank0().astype(np.int32)
            brank_parts.append(wr)
            word_off.append(woff)
            brank_off.append(boff)
            nwords.append(len(gv.words))
            nzeros.append(gv.n_zeros)
            woff += len(gv.words)
            boff += len(wr)
        max_nwords = max(nwords) if nwords else 1

        total_zeros = sum(nzeros)
        total_cols = sum(gv.n for gv in vectors)
        # HBM policy: enable the explicit select table first (it replaces a
        # ~14-gather binary search per query — the bigger win), then the
        # dense rank table, while they fit the free-memory budget.
        zsel_cost = 4 * total_zeros
        rtab_cost = 4 * (total_cols + len(vectors))
        if with_select_table is None or with_rank_table is None:
            budget = _table_budget_bytes()
            decided = []
            if with_select_table is None:
                with_select_table = zsel_cost <= budget
                decided.append(
                    f"select table {zsel_cost / 2**20:.0f} MB "
                    f"{'on' if with_select_table else 'OFF (over budget)'}"
                )
            remaining = budget - (zsel_cost if with_select_table else 0)
            if with_rank_table is None:
                with_rank_table = rtab_cost <= remaining
                decided.append(
                    f"rank table {rtab_cost / 2**20:.0f} MB "
                    f"{'on' if with_rank_table else 'OFF (over budget)'}"
                )
            if not (with_select_table and with_rank_table) or (
                zsel_cost + rtab_cost > 128 * 2**20
            ):
                from ..utils import log_time

                log_time(
                    "Device gap index tables: "
                    + ", ".join(decided)
                    + f" (budget {budget / 2**20:.0f} MB)."
                )
        from ..bitvec import unpack_bits

        zsel = None
        zsel_off = np.zeros(max(1, len(vectors)), np.int32)
        if with_select_table:
            parts = []
            zoff = 0
            for i, gv in enumerate(vectors):
                zsel_off[i] = zoff
                bits = unpack_bits(gv.words, gv.n)
                parts.append(np.flatnonzero(bits == 0).astype(np.int32))
                zoff += gv.n_zeros
            flat = (
                np.concatenate(parts) if parts else np.zeros(1, np.int32)
            )
            # tail pad: slice loads for the last sequence's end never clamp
            pad = np.full(cls.SELECT_SLICE_PAD, flat[-1], np.int32)
            zsel = jnp.asarray(np.concatenate([flat, pad]))

        rtab = None
        rtab_off = np.zeros(max(1, len(vectors)), np.int32)
        if with_rank_table:
            parts = []
            roff = 0
            for i, gv in enumerate(vectors):
                rtab_off[i] = roff
                bits = unpack_bits(gv.words, gv.n)
                r = np.zeros(gv.n + 1, np.int32)
                np.cumsum(bits == 0, out=r[1:])
                # combined entry: rank << 1 | gap bit (one gather answers
                # rank0_and_bit; the one-past-end bit is 0)
                c = r << 1
                c[:-1] |= bits.astype(np.int32)
                parts.append(c)
                roff += gv.n + 1
            rtab = jnp.asarray(
                np.concatenate(parts) if parts else np.zeros(1, np.int32)
            )
        return cls(
            words=jnp.asarray(np.concatenate(words_parts) if words_parts else np.zeros(1, np.uint32)),
            brank=jnp.asarray(np.concatenate(brank_parts) if brank_parts else np.zeros(1, np.int32)),
            seq_word_off=jnp.asarray(np.array(word_off, np.int32)),
            seq_brank_off=jnp.asarray(np.array(brank_off, np.int32)),
            seq_nwords=jnp.asarray(np.array(nwords, np.int32)),
            seq_nzeros=jnp.asarray(np.array(nzeros, np.int32)),
            zsel=zsel,
            seq_zsel_off=jnp.asarray(zsel_off),
            rtab=rtab,
            seq_rtab_off=jnp.asarray(rtab_off),
            search_steps=max(1, math.ceil(math.log2(max_nwords + 1))),
        )

    # -- queries (all element-wise over same-shaped int32 arrays) ----------

    def rank0(self, seq: jnp.ndarray, pos: jnp.ndarray) -> jnp.ndarray:
        """Zeros strictly before ``pos`` in sequence ``seq``.

        One gather with the dense rank table; two gathers + popcount over
        the block-rank structure otherwise."""
        pos = pos.astype(jnp.int32)
        if self.rtab is not None:
            idx = self.seq_rtab_off[seq] + pos
            return self.rtab[jnp.clip(idx, 0, self.rtab.shape[0] - 1)] >> 1
        wi = pos >> 5
        bi = (pos & 31).astype(jnp.uint32)
        base = self.brank[self.seq_brank_off[seq] + wi]
        w = self.words[self.seq_word_off[seq] + wi]
        mask = ((jnp.uint32(1) << bi) - jnp.uint32(1)).astype(jnp.uint32)
        inword = jax.lax.population_count((~w) & mask).astype(jnp.int32)
        return base + inword

    def bit(self, seq: jnp.ndarray, pos: jnp.ndarray) -> jnp.ndarray:
        pos = pos.astype(jnp.int32)
        if self.rtab is not None:
            idx = self.seq_rtab_off[seq] + pos
            idx = jnp.clip(idx, 0, self.rtab.shape[0] - 1)
            return self.rtab[idx] & 1
        w = self.words[self.seq_word_off[seq] + (pos >> 5)]
        return ((w >> (pos & 31).astype(jnp.uint32)) & jnp.uint32(1)).astype(jnp.int32)

    def rank0_and_bit(self, seq: jnp.ndarray, pos: jnp.ndarray):
        """(rank0(pos), bit(pos)) sharing gathers: ONE combined-table load,
        or one word gather + block rank with the fallback."""
        pos = pos.astype(jnp.int32)
        if self.rtab is not None:
            idx = self.seq_rtab_off[seq] + pos
            idx = jnp.clip(idx, 0, self.rtab.shape[0] - 1)
            v = self.rtab[idx]
            return v >> 1, v & 1
        wi = pos >> 5
        bi = (pos & 31).astype(jnp.uint32)
        base = self.brank[self.seq_brank_off[seq] + wi]
        w = self.words[self.seq_word_off[seq] + wi]
        mask = ((jnp.uint32(1) << bi) - jnp.uint32(1)).astype(jnp.uint32)
        inword = jax.lax.population_count((~w) & mask).astype(jnp.int32)
        bit = ((w >> bi) & jnp.uint32(1)).astype(jnp.int32)
        return base + inword, bit

    def select0_consecutive(self, seq: jnp.ndarray, k0: jnp.ndarray, R: int):
        """``select0(seq, k0 + r)`` for r in [0, R): positions of R
        consecutive zeros starting at 1-based rank ``k0``.

        With the explicit select table this is a contiguous R-length slice
        of ``zsel`` per query — lowered as a slice-gather (DMA of rows)
        instead of B*R independent element gathers.  ``seq``/``k0`` are
        (B,); returns (B, R).  Entries
        beyond the sequence's zero count read the tail pad / next sequence
        and must be masked by the caller (the gap kernels mask by
        n_ref_units).
        """
        if self.zsel is None or R > self.SELECT_SLICE_PAD:
            r = jnp.arange(R, dtype=jnp.int32)[None, :]
            return self.select0(seq[:, None], k0[:, None] + r)
        base = self.seq_zsel_off[seq] + jnp.clip(k0.astype(jnp.int32) - 1, 0, None)
        base = jnp.clip(base, 0, self.zsel.shape[0] - 1 - R)
        return jax.lax.gather(
            self.zsel,
            base[:, None],
            jax.lax.GatherDimensionNumbers(
                offset_dims=(1,),
                collapsed_slice_dims=(),
                start_index_map=(0,),
            ),
            slice_sizes=(R,),
            mode=jax.lax.GatherScatterMode.CLIP,
        )

    def select0(self, seq: jnp.ndarray, k: jnp.ndarray) -> jnp.ndarray:
        """Position of the k-th zero (1-based) in sequence ``seq``.

        One gather when the explicit select table is present; otherwise a
        per-sequence binary search over the block-rank table (fixed
        ``search_steps`` trips) plus a 5-step in-word popcount search.
        """
        if self.zsel is not None:
            k = k.astype(jnp.int32)
            idx = self.seq_zsel_off[seq] + jnp.clip(
                k - 1, 0, None
            )
            return self.zsel[jnp.clip(idx, 0, self.zsel.shape[0] - 1)]
        k = k.astype(jnp.int32)
        boff = self.seq_brank_off[seq]
        n = self.seq_nwords[seq]

        # find largest j in [0, n-1] with brank[boff + j] < k
        lo = jnp.zeros_like(k)
        hi = n - 1  # inclusive
        for _ in range(self.search_steps):
            mid = (lo + hi + 1) >> 1
            go_right = self.brank[boff + mid] < k
            lo = jnp.where(go_right, mid, lo)
            hi = jnp.where(go_right, hi, mid - 1)
        wi = lo
        rem = k - self.brank[boff + wi]  # 1-based zero rank within word
        inv = (~self.words[self.seq_word_off[seq] + wi]).astype(jnp.uint32)

        pos = jnp.zeros_like(k)
        cur = jnp.zeros_like(k)
        shifted = inv
        width = 16
        while width:
            lower = shifted & ((jnp.uint32(1) << jnp.uint32(width)) - jnp.uint32(1))
            cnt = jax.lax.population_count(lower).astype(jnp.int32)
            go_right = cnt < rem - cur
            cur = jnp.where(go_right, cur + cnt, cur)
            pos = jnp.where(go_right, pos + width, pos)
            shifted = jnp.where(go_right, shifted >> jnp.uint32(width), lower).astype(jnp.uint32)
            width >>= 1
        return (wi << 5) + pos
