"""Sequence/quality alphabets as uint8 lookup tables.

Replaces the reference's seqan3 alphabet types (dna5, phred42,
/root/reference/include/panvc3/dna11_alphabet.hh) with plain numpy tables
usable on both host and device.
"""

from __future__ import annotations

import numpy as np

# -- dna5 -------------------------------------------------------------------
# seqan3::dna5 char semantics: A/C/G/T (U->T) upper or lower case map to the
# upper-case letter; everything else maps to 'N'.
DNA5_NORMALISE = np.full(256, ord("N"), dtype=np.uint8)
for _c in "ACGT":
    DNA5_NORMALISE[ord(_c)] = ord(_c)
    DNA5_NORMALISE[ord(_c.lower())] = ord(_c)
DNA5_NORMALISE[ord("U")] = ord("T")
DNA5_NORMALISE[ord("u")] = ord("T")


def normalise_dna5(seq: str | bytes) -> bytes:
    """Normalise a sequence to dna5 characters (A/C/G/T/N)."""
    if isinstance(seq, str):
        seq = seq.encode("latin1")
    arr = np.frombuffer(seq, dtype=np.uint8)
    return DNA5_NORMALISE[arr].tobytes()


def dna5_normalise_device(x):
    """Traced-array DNA5_NORMALISE: identical to the table for every byte
    value (uppercase, U->T, other->N) but pure elementwise vector ops
    instead of a 256-entry table gather (tests/test_device_ops.py asserts
    equality over all 256 inputs)."""
    import jax.numpy as jnp

    up = x & jnp.uint8(0xDF)
    up = jnp.where(up == jnp.uint8(ord("U")), jnp.uint8(ord("T")), up)
    is_acgt = (
        (up == jnp.uint8(ord("A")))
        | (up == jnp.uint8(ord("C")))
        | (up == jnp.uint8(ord("G")))
        | (up == jnp.uint8(ord("T")))
    )
    return jnp.where(is_acgt, up, jnp.uint8(ord("N")))


# -- phred ------------------------------------------------------------------
PHRED42_MAX = 41  # seqan3::phred42 stores phred scores 0..41
PHRED_OFFSET = 33  # SAM QUAL encoding offset


def decode_phred42(qual: str | bytes) -> np.ndarray:
    """Decode a SAM QUAL string into phred42 values (clamped to 0..41)."""
    if isinstance(qual, str):
        qual = qual.encode("latin1")
    arr = np.frombuffer(qual, dtype=np.uint8).astype(np.int32) - PHRED_OFFSET
    return np.clip(arr, 0, PHRED42_MAX)


# -- dna11 ------------------------------------------------------------------
# The reference's 11-letter alphabet for variant-support counting
# (/root/reference/include/panvc3/dna11_alphabet.hh:15-108):
# {A,C,G,N,T} + lower-case soft-clipped variants + '~' deletion marker.
DNA11_CHARS = "ACGNTacgnt~"
DNA11_TO_RANK = {c: i for i, c in enumerate(DNA11_CHARS)}


def dna11_complement(c: str) -> str:
    comp = {"A": "T", "C": "G", "G": "C", "T": "A", "N": "N",
            "a": "t", "c": "g", "g": "c", "t": "a", "n": "n", "~": "~"}
    return comp[c]
