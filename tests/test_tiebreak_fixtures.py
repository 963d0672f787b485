"""Adversarial DP tie-breaking fixtures (VERDICT r3 #7).

tests/data/tiebreak_fixtures.tsv locks the calibrated traceback tie order
(diag >= vert > horiz, open >= extend — the order the reference's golden
projector fixtures pin down, /root/reference/tests/alignment_projector.cc:
157-247, include/panvc3/align.hh:59-112) over 3.4k inputs chosen for
maximal tie degeneracy: exhaustive 2-letter pairs, homopolymers, tandem
repeats, seeded near-tie pairs, and quantised-quality ties.  EVERY engine
must reproduce the table byte-for-byte:

- the host Python oracle (align.align_global),
- the host C DP (PANVC3_HOST_DP=1 realign_batch),
- the XLA scans (PANVC3_HOST_DP=0).

A coordinated recurrence change that keeps the engines mutually
consistent but diverges from the reference's order fails here, not in a
10-case golden file.  Regenerate (only deliberately) with
tools/gen_tiebreak_fixtures.py.
"""

from __future__ import annotations

import numpy as np
import pytest

from panvc3_tpu.align import MALDE_SCALE, align_global
from panvc3_tpu.alphabet import PHRED42_MAX
from panvc3_tpu.cigar import format_cigar
from panvc3_tpu.ops.realign_batch import realign_batch

from .conftest import DATA_DIR


def _load():
    rows = []
    path = DATA_DIR / "tiebreak_fixtures.tsv"
    for line in path.read_text().splitlines():
        if not line or line.startswith("#"):
            continue
        kind, go, ge, s1, s2, quals, score, cigar = line.split("\t")
        rows.append((
            kind, int(go), int(ge), s1, s2,
            None if quals == "-" else [int(q) for q in quals.split(",")],
            int(score), cigar,
        ))
    assert len(rows) > 3000
    return rows


FIXTURES = _load()


def _groups():
    """Cases grouped by (go, ge, quality?) — one engine batch per group."""
    groups: dict[tuple, list] = {}
    for row in FIXTURES:
        _, go, ge, _, _, quals, _, _ = row
        groups.setdefault((go, ge, quals is not None), []).append(row)
    return groups


def test_host_oracle_matches_fixture_table():
    """The Python oracle reproduces every locked CIGAR *and score*."""
    for kind, go, ge, s1, s2, quals, score, cigar in FIXTURES:
        if quals is None:
            got_s, got_c = align_global(s1, s2, go, ge)
            assert int(round(got_s)) == score, (kind, s1, s2)
        else:
            q1 = np.full(len(s1), PHRED42_MAX, np.int32)
            q2 = np.asarray(quals, np.int32)
            got_s, got_c = align_global(s1, s2, go, ge, quals1=q1, quals2=q2)
            assert int(round(got_s * MALDE_SCALE)) == score, (kind, s1, s2)
        assert format_cigar(got_c) == cigar, (
            f"{kind} {s1} {s2} go={go} ge={ge}: "
            f"expected {cigar} got {format_cigar(got_c)}"
        )


@pytest.mark.parametrize(
    "host_dp", ["1", "0"], ids=["host-c-dp", "xla-scans"],
)
def test_engines_match_fixture_table(host_dp, monkeypatch):
    monkeypatch.setenv("PANVC3_HOST_DP", host_dp)
    for (go, ge, quality), rows in _groups().items():
        refs = [r[3].encode() for r in rows]
        queries = [r[4].encode() for r in rows]
        if quality:
            rqs = [np.full(len(r), PHRED42_MAX, np.int32) for r in refs]
            qqs = [np.asarray(r[5], np.int32) for r in rows]
            got = realign_batch(refs, queries, go, ge, rqs, qqs)
        else:
            got = realign_batch(refs, queries, go, ge)
        for row, g in zip(rows, got):
            assert format_cigar(g) == row[7], (
                f"{row[0]} {row[3]} {row[4]} go={go} ge={ge} "
                f"host_dp={host_dp}: "
                f"expected {row[7]} got {format_cigar(g)}"
            )
