#!/usr/bin/env python
"""Generate the adversarial DP tie-breaking fixture table (VERDICT r3 #7).

The realignment DP's traceback tie order (diag >= vert > horiz, open >=
extend; calibrated against the reference's golden fixtures, see
/root/reference/tests/alignment_projector.cc:157-247 and
include/panvc3/align.hh:59-112) is the hardest bit-equality risk in the
whole projection path: three engines (host Python oracle, host C DP, XLA
scans) must agree byte-for-byte, and a coordinated
recurrence change could silently move ALL of them off the reference's
order.  This script locks the CURRENT calibrated answers into
tests/data/tiebreak_fixtures.tsv over inputs chosen for maximal tie
degeneracy:

- exhaustive 2-letter pairs (every tie topology at small scale),
- homopolymer pairs (every gap placement co-optimal),
- tandem-repeat truncations (repeat-period gap placement ties),
- seeded random near-tie pairs over a 2-3 letter alphabet,
- quality-path cases whose quantised Malde scores tie.

Run from the repo root to (re)generate — only with an independent reason
to believe the current engines are right (the suite enforces the table):

    python tools/gen_tiebreak_fixtures.py
"""
from __future__ import annotations

import itertools
import pathlib
import sys

import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

from panvc3_tpu.align import MALDE_SCALE, align_global  # noqa: E402
from panvc3_tpu.alphabet import PHRED42_MAX  # noqa: E402
from panvc3_tpu.cigar import format_cigar  # noqa: E402

OUT = pathlib.Path(__file__).resolve().parent.parent / (
    "tests/data/tiebreak_fixtures.tsv"
)

COSTS = [(0, -1), (-6, -1)]  # reference test costs; tool defaults


def seqs_upto(alpha: str, max_len: int):
    for n in range(1, max_len + 1):
        for tup in itertools.product(alpha, repeat=n):
            yield "".join(tup)


def gen_cases():
    # 1. exhaustive {A,C} pairs, lengths 1..4
    exh = list(seqs_upto("AC", 4))
    for s1, s2 in itertools.product(exh, exh):
        for go, ge in COSTS:
            yield ("exh2", go, ge, s1, s2, None)

    # 2. homopolymers: every gap placement ties
    for i, j in itertools.product(range(1, 11), repeat=2):
        for go, ge in COSTS:
            yield ("homo", go, ge, "A" * i, "A" * j, None)
            if i != j:
                yield ("homo", go, ge, "A" * i, "C" * j, None)

    # 3. tandem repeats: period-length gap placements tie
    for period in ("AC", "ACG", "AAC"):
        rep = (period * 8)
        for k, l in itertools.product(range(1, 13), repeat=2):
            if abs(k - l) > 6:
                continue
            for go, ge in COSTS:
                yield ("tandem", go, ge, rep[:k], rep[:l], None)

    # 4. seeded random near-tie pairs (small alphabet => dense ties)
    rng = np.random.default_rng(20260820)
    for _ in range(150):
        n = int(rng.integers(5, 13))
        m = int(rng.integers(5, 13))
        s1 = "".join("AC"[int(x)] for x in rng.integers(0, 2, n))
        s2 = "".join("ACG"[int(x)] for x in rng.integers(0, 3, m))
        for go, ge in COSTS:
            yield ("rand", go, ge, s1, s2, None)

    # 5. quality path: exhaustive {A,C} len 1..3 with a deterministic
    # query-quality pattern, plus uniform-quality homopolymers (all
    # match-path permutations tie in quantised units)
    qpat = [2, 41, 20, 7, 33, 11]
    small = list(seqs_upto("AC", 3))
    for s1, s2 in itertools.product(small, small):
        quals = [qpat[k % len(qpat)] for k in range(len(s2))]
        yield ("qual", 0, -1, s1, s2, quals)
    for i, j in itertools.product(range(1, 7), repeat=2):
        yield ("qualhomo", 0, -1, "A" * i, "A" * j, [20] * j)
        yield ("qualhomo", -6, -1, "A" * i, "A" * j, [20] * j)


def main():
    rows = []
    for kind, go, ge, s1, s2, quals in gen_cases():
        if quals is None:
            score, cig = align_global(s1, s2, go, ge)
            score_i = int(round(score))
            assert abs(score - score_i) < 1e-9, (s1, s2, score)
            qcol = "-"
        else:
            q1 = np.full(len(s1), PHRED42_MAX, np.int32)
            q2 = np.asarray(quals, np.int32)
            score, cig = align_global(s1, s2, go, ge, quals1=q1, quals2=q2)
            # quality DP is integral in 1/MALDE_SCALE units: lock the
            # quantised integer score exactly
            score_i = int(round(score * MALDE_SCALE))
            assert abs(score * MALDE_SCALE - score_i) < 1e-6, (s1, s2, score)
            qcol = ",".join(str(q) for q in quals)
        rows.append(
            f"{kind}\t{go}\t{ge}\t{s1}\t{s2}\t{qcol}\t{score_i}\t"
            f"{format_cigar(cig)}"
        )
    OUT.write_text(
        "# kind\tgo\tge\tseq1\tseq2\tquals2\tscore\tcigar\n"
        "# score: integer (quality rows: in 1/MALDE_SCALE units)\n"
        "# generated by tools/gen_tiebreak_fixtures.py — locks the\n"
        "# calibrated DP tie order; do not regenerate to paper over a\n"
        "# recurrence change\n"
        + "\n".join(rows) + "\n"
    )
    print(f"{len(rows)} cases -> {OUT}")


if __name__ == "__main__":
    main()
