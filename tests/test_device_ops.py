"""Device kernels must match the host oracles exactly."""

import numpy as np
import pytest

import jax.numpy as jnp

from panvc3_tpu.align import align_global, max_quality_array
from panvc3_tpu.alphabet import normalise_dna5
from panvc3_tpu.bitvec import GapBitVector
from panvc3_tpu.cigar import cigar_ref_length, format_cigar
from panvc3_tpu.msa_index import SequenceEntry, make_sequence_entry_pair
from panvc3_tpu.ops.rank_select import DeviceGapIndex
from panvc3_tpu.ops.realign_batch import realign_batch
from panvc3_tpu.ops.rewrite_batch import expand_cigars, rewrite_batch
from panvc3_tpu.rewrite import rewrite_cigar


def random_bits(rng, n, p=0.3):
    bits = (rng.random(n) < p).astype(np.uint8)
    if bits.all():
        bits[0] = 0
    return bits


def test_device_rank_select_matches_host():
    rng = np.random.default_rng(0)
    vectors = [GapBitVector.from_bits(random_bits(rng, n)) for n in (33, 64, 500, 4097)]
    idx = DeviceGapIndex.build(vectors)
    for s, gv in enumerate(vectors):
        pos = np.arange(gv.n, dtype=np.int32)
        seq = np.full_like(pos, s)
        assert np.array_equal(np.asarray(idx.rank0(jnp.asarray(seq), jnp.asarray(pos))), gv.rank0(pos))
        assert np.array_equal(np.asarray(idx.bit(jnp.asarray(seq), jnp.asarray(pos))), gv.bit_at(pos))
        ks = np.arange(1, gv.n_zeros + 1, dtype=np.int32)
        seq2 = np.full_like(ks, s)
        assert np.array_equal(
            np.asarray(idx.select0(jnp.asarray(seq2), jnp.asarray(ks))), gv.select0(ks)
        )


def random_msa_pair(rng, n_cols):
    """Random aligned pair without all-gap columns on the src side."""
    alpha = np.frombuffer(b"ACGT", dtype=np.uint8)

    def row():
        chars = alpha[rng.integers(0, 4, n_cols)]
        gaps = rng.random(n_cols) < 0.25
        out = np.where(gaps, ord("-"), chars).astype(np.uint8)
        return out.tobytes().decode()

    src = row()
    dst = row()
    if src.replace("-", "") == "":
        src = "A" + src[1:]
    return src, dst


def random_alignment(rng, src_gapless_len, max_read=30):
    """Random (src_pos, cigar, query) consistent with the source length."""
    ops_ref = ["M", "=", "X", "D", "N"]
    src_pos = int(rng.integers(0, max(1, src_gapless_len - 10)))
    budget = src_gapless_len - src_pos
    cigar = []
    qlen = 0
    if rng.random() < 0.3:
        n = int(rng.integers(1, 4))
        cigar.append((n, "S"))
        qlen += n
    n_ops = int(rng.integers(1, 6))
    for _ in range(n_ops):
        kind = rng.random()
        if kind < 0.55:
            op = ops_ref[int(rng.integers(0, 3))]
            n = int(rng.integers(1, min(8, budget) + 1)) if budget else 0
            if n == 0:
                continue
            cigar.append((n, op))
            qlen += n
            budget -= n
        elif kind < 0.75:
            op = "D" if rng.random() < 0.8 else "N"
            n = int(rng.integers(1, min(4, budget) + 1)) if budget else 0
            if n == 0:
                continue
            cigar.append((n, op))
            budget -= n
        elif kind < 0.9:
            n = int(rng.integers(1, 5))
            cigar.append((n, "I"))
            qlen += n
        else:
            cigar.append((int(rng.integers(1, 3)), "H" if rng.random() < 0.5 else "P"))
    if not any(op in "M=XDN" for _, op in cigar):
        cigar.append((1, "="))
        qlen += 1
    alpha = "ACGT"
    query = "".join(alpha[int(x)] for x in rng.integers(0, 4, qlen))
    return src_pos, cigar, query


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_batched_rewrite_matches_oracle(seed):
    rng = np.random.default_rng(seed)
    pairs = [random_msa_pair(rng, int(rng.integers(20, 120))) for _ in range(6)]
    entries = []
    vectors = []
    dst_seqs = []
    for src, dst in pairs:
        se, de = make_sequence_entry_pair(src, dst)
        entries.append((se, de))
        vectors += [se.gaps, de.gaps]
        dst_seqs.append(dst.replace("-", "").encode())
    idx = DeviceGapIndex.build(vectors)
    ref_flat = np.frombuffer(b"".join(dst_seqs), dtype=np.uint8)
    ref_offs = np.cumsum([0] + [len(s) for s in dst_seqs[:-1]]).tolist()

    cigars, positions, queries = [], [], []
    src_ids, dst_ids, rec_ref_offs = [], [], []
    expected = []
    for k in range(40):
        pi = int(rng.integers(0, len(pairs)))
        se, de = entries[pi]
        if se.gaps.n_zeros < 12:
            continue
        src_pos, cigar, query = random_alignment(rng, se.gaps.n_zeros)
        qn = normalise_dna5(query)
        exp_pos, exp_cigar = rewrite_cigar(src_pos, cigar, se, de, qn, dst_seqs[pi])
        expected.append((exp_pos, exp_cigar))
        cigars.append(cigar)
        positions.append(src_pos)
        queries.append(qn)
        src_ids.append(2 * pi)
        dst_ids.append(2 * pi + 1)
        rec_ref_offs.append(ref_offs[pi])

    batch = expand_cigars(cigars, positions, queries, src_ids, dst_ids, rec_ref_offs)
    got_pos, got_cigars = rewrite_batch(idx, ref_flat, batch)
    for i, ((exp_pos, exp_cigar), gp, gc) in enumerate(zip(expected, got_pos, got_cigars)):
        assert gp == exp_pos, f"record {i}"
        assert gc == exp_cigar, (
            f"record {i}: expected {format_cigar(exp_cigar)} got {format_cigar(gc)}"
        )


def random_seq(rng, lo, hi):
    alpha = "ACGT"
    n = int(rng.integers(lo, hi))
    return "".join(alpha[int(x)] for x in rng.integers(0, 4, n)).encode()


def _cigar_malde_score(cigar, ref, query, rq, qq, go, ge):
    """f64 score of an explicit alignment path under the Malde scheme with
    linear-equivalent affine costs (open added per gap run)."""
    from panvc3_tpu.align import malde_score

    score = 0.0
    qpos = rpos = 0
    prev = None
    for n, op in cigar:
        if op in "ID":
            if prev not in ("I", "D"):
                score += go
            score += n * ge
            if op == "I":
                qpos += n
            else:
                rpos += n
        else:  # = / X
            for k in range(n):
                score += malde_score(
                    query[qpos + k] == ref[rpos + k], int(rq[rpos + k]), int(qq[qpos + k])
                )
            qpos += n
            rpos += n
        prev = op
    return score


@pytest.mark.parametrize("seed", [10, 11])
def test_batched_realign_matches_oracle_hamming(seed):
    """The default (quality-free, integer-scored) path must match exactly."""
    rng = np.random.default_rng(seed)
    refs = [random_seq(rng, 1, 12) for _ in range(30)]
    queries = [random_seq(rng, 1, 12) for _ in range(30)]
    got = realign_batch(refs, queries, 0, -1)
    exp = [align_global(r, q, 0, -1)[1] for r, q in zip(refs, queries)]
    for i, (g, e) in enumerate(zip(got, exp)):
        assert g == e, (
            f"pair {i} ref={refs[i]} q={queries[i]}: "
            f"expected {format_cigar(e)} got {format_cigar(g)}"
        )


@pytest.mark.parametrize("host_dp", ["0", "1"])
@pytest.mark.parametrize("seed", [10, 11])
def test_batched_realign_matches_oracle_quality(seed, host_dp, monkeypatch):
    """The quality path uses the quantised Malde scheme (align.MALDE_SHIFT)
    on both host and device: every DP value is a small integer, float32 is
    exact, and the device traceback must equal the host oracle byte for
    byte — same contract as the integer path."""
    monkeypatch.setenv("PANVC3_HOST_DP", host_dp)  # C host DP and device kernel
    rng = np.random.default_rng(seed)
    refs = [random_seq(rng, 1, 12) for _ in range(30)]
    queries = [random_seq(rng, 1, 12) for _ in range(30)]
    go, ge = 0, -1
    rqs = [max_quality_array(len(r)) for r in refs]
    qqs = [np.asarray(rng.integers(10, 42, len(q)), dtype=np.int32) for q in queries]
    got = realign_batch(refs, queries, go, ge, rqs, qqs)
    for i in range(len(refs)):
        _, cigar_exp = align_global(
            refs[i], queries[i], go, ge, quals1=rqs[i], quals2=qqs[i]
        )
        assert got[i] == cigar_exp, (
            f"pair {i} ref={refs[i]} q={queries[i]}: "
            f"expected {format_cigar(cigar_exp)} got {format_cigar(got[i])}"
        )


def _float64_malde_optimum(ref, query, rq, qq, go, ge):
    """Reference-style float64 affine DP optimum score (no quantisation) —
    the bound oracle for the quantisation deviation."""
    from panvc3_tpu.align import malde_score

    n, m = len(ref), len(query)
    NEG = float("-inf")
    best = [[NEG] * (n + 1) for _ in range(m + 1)]
    vert = [[NEG] * (n + 1) for _ in range(m + 1)]
    horiz = [[NEG] * (n + 1) for _ in range(m + 1)]
    best[0][0] = 0.0
    for j in range(1, n + 1):
        horiz[0][j] = go + j * ge
        best[0][j] = horiz[0][j]
    for i in range(1, m + 1):
        vert[i][0] = go + i * ge
        best[i][0] = vert[i][0]
    for i in range(1, m + 1):
        for j in range(1, n + 1):
            vert[i][j] = max(best[i - 1][j] + go + ge, vert[i - 1][j] + ge)
            horiz[i][j] = max(best[i][j - 1] + go + ge, horiz[i][j - 1] + ge)
            s = malde_score(query[i - 1] == ref[j - 1], int(rq[j - 1]), int(qq[i - 1]))
            best[i][j] = max(best[i - 1][j - 1] + s, vert[i][j], horiz[i][j])
    return best[m][n]


@pytest.mark.parametrize("seed", [21, 22])
def test_quantised_quality_score_bound(seed):
    """The quantised path's chosen alignment must score within
    (R+Q)/2**(MALDE_SHIFT+1) of the true float64 Malde optimum."""
    from panvc3_tpu.align import MALDE_SHIFT

    rng = np.random.default_rng(seed)
    go, ge = 0, -1
    for _ in range(25):
        ref = random_seq(rng, 1, 10)
        query = random_seq(rng, 1, 10)
        rq = max_quality_array(len(ref))
        qq = np.asarray(rng.integers(5, 42, len(query)), dtype=np.int32)
        _, cigar = align_global(ref, query, go, ge, quals1=rq, quals2=qq)
        achieved = _cigar_malde_score(cigar, ref, query, rq, qq, go, ge)
        optimum = _float64_malde_optimum(ref, query, rq, qq, go, ge)
        bound = (len(ref) + len(query)) / float(1 << (MALDE_SHIFT + 1)) + 1e-9
        assert optimum - achieved <= bound, (ref, query, achieved, optimum)


@pytest.mark.parametrize("go,ge", [(0, -1), (-2, -1), (-1, -3)])
def test_batched_realign_affine_penalties(go, ge):
    rng = np.random.default_rng(99)
    refs = [random_seq(rng, 1, 15) for _ in range(20)]
    queries = [random_seq(rng, 1, 15) for _ in range(20)]
    got = realign_batch(refs, queries, go, ge)
    exp = [align_global(r, q, go, ge)[1] for r, q in zip(refs, queries)]
    for i, (g, e) in enumerate(zip(got, exp)):
        assert g == e, f"pair {i} ref={refs[i]} q={queries[i]}"


def test_device_select_without_table_matches():
    """The binary-search fallback (no select table) must agree."""
    rng = np.random.default_rng(5)
    vectors = [GapBitVector.from_bits(random_bits(rng, n)) for n in (100, 2048)]
    with_t = DeviceGapIndex.build(vectors, with_select_table=True)
    without_t = DeviceGapIndex.build(vectors, with_select_table=False)
    assert without_t.zsel is None
    for s, gv in enumerate(vectors):
        ks = np.arange(1, gv.n_zeros + 1, dtype=np.int32)
        seq = np.full_like(ks, s)
        a = np.asarray(with_t.select0(jnp.asarray(seq), jnp.asarray(ks)))
        b = np.asarray(without_t.select0(jnp.asarray(seq), jnp.asarray(ks)))
        assert np.array_equal(a, b)
        assert np.array_equal(a, gv.select0(ks))


def test_device_rank_without_table_matches():
    rng = np.random.default_rng(6)
    vectors = [GapBitVector.from_bits(random_bits(rng, n)) for n in (77, 1024)]
    with_t = DeviceGapIndex.build(vectors, with_rank_table=True)
    without_t = DeviceGapIndex.build(vectors, with_rank_table=False)
    assert without_t.rtab is None
    for s, gv in enumerate(vectors):
        pos = np.arange(gv.n, dtype=np.int32)
        seq = np.full_like(pos, s)
        a = np.asarray(with_t.rank0(jnp.asarray(seq), jnp.asarray(pos)))
        b = np.asarray(without_t.rank0(jnp.asarray(seq), jnp.asarray(pos)))
        assert np.array_equal(a, b)
        assert np.array_equal(
            np.asarray(with_t.bit(jnp.asarray(seq), jnp.asarray(pos))), gv.bit_at(pos)
        )


def _random_runs(rng, B, R, Q):
    """(ref, query, m, n, qq): random ACGT rows zero-padded past their
    lengths, with a zero-length and a full-length run at the front."""
    n = rng.integers(0, R + 1, B).astype(np.int32)
    m = rng.integers(0, Q + 1, B).astype(np.int32)
    n[:2] = [0, R][:B]
    m[:2] = [Q, 0][:B]
    ref = rng.integers(65, 69, (B, R)).astype(np.uint8)
    qry = rng.integers(65, 69, (B, Q)).astype(np.uint8)
    ref[np.arange(R)[None, :] >= n[:, None]] = 0
    qry[np.arange(Q)[None, :] >= m[:, None]] = 0
    qq = rng.integers(0, 42, (B, Q)).astype(np.int32)
    return (jnp.asarray(ref), jnp.asarray(qry), jnp.asarray(m),
            jnp.asarray(n), jnp.asarray(qq))


def _oracle_cigars(ref, qry, m, n, go, ge, qq=None):
    """align_global's collapsed CIGAR for every run."""
    out = []
    for b in range(ref.shape[0]):
        r = bytes(np.asarray(ref[b, : int(n[b])]))
        q = bytes(np.asarray(qry[b, : int(m[b])]))
        quals = {}
        if qq is not None:
            quals = dict(
                quals1=max_quality_array(len(r)),
                quals2=np.asarray(qq[b, : int(m[b])]),
            )
        out.append(format_cigar(align_global(r, q, go, ge, **quals)[1]))
    return out


def _device_cigars(ops, cnt):
    from panvc3_tpu.ops.realign_batch import realign_batch_finish

    return [format_cigar(c) for c in realign_batch_finish(("host", ops, cnt))]


@pytest.mark.parametrize(
    "B,R,Q,quality",
    [
        (1, 16, 16, False),   # one run
        (33, 16, 16, True),   # odd batch
        (64, 1, 1, False),    # one-column rows
        (40, 7, 9, True),
        (40, 8, 5, False),    # Q < R
        (70, 24, 48, True),   # Q > R
        (50, 64, 12, False),
        (20, 128, 96, True),  # a wide pad
    ],
)
def test_dp_align_matches_oracle(B, R, Q, quality):
    """The device DP (realign_batch.dp_align, the XLA scans) reproduces
    align_global on every run, zero-length and full-length runs included,
    on both scoring schemes."""
    from panvc3_tpu.align import MALDE_SCALE
    from panvc3_tpu.ops.realign_batch import dp_align

    ref, qry, m, n, qq = _random_runs(np.random.default_rng(B * 131 + R), B, R, Q)
    go, ge = -2, -1
    scale = MALDE_SCALE if quality else 1
    ops, cnt = dp_align(
        ref, qry, m, n, jnp.float32(go * scale), jnp.float32(ge * scale),
        R, Q, qq=qq if quality else None,
    )
    assert ops.shape == (B, R + Q) and cnt.shape == (B,)
    got = _device_cigars(np.asarray(ops), np.asarray(cnt))
    assert got == _oracle_cigars(ref, qry, m, n, go, ge, qq if quality else None)


def test_dp_align_all_zero_length_runs():
    """Empty runs emit only the 127 filler with count 0."""
    from panvc3_tpu.ops.realign_batch import dp_align

    B, R, Q = 5, 16, 16
    z = jnp.zeros((B,), jnp.int32)
    ops, cnt = dp_align(
        jnp.zeros((B, R), jnp.uint8), jnp.zeros((B, Q), jnp.uint8), z, z,
        jnp.float32(0), jnp.float32(-1), R, Q,
    )
    assert np.all(np.asarray(cnt) == 0)
    assert np.all(np.asarray(ops) == 127)


def test_pinned_quality_dp_matches_explicit_ref_quals():
    """The pinned-ref-quality path (ref qualities never shipped) is
    bit-identical to the quality path with an explicit phred42-max
    ref-quality array, at narrow and wide run pads."""
    from panvc3_tpu.align import MALDE_SCALE
    from panvc3_tpu.alphabet import PHRED42_MAX
    from panvc3_tpu.ops.realign_batch import dp_align, realign_device_kernel

    rng = np.random.default_rng(23)
    go = jnp.float32(-6.0 * MALDE_SCALE)
    ge = jnp.float32(-1.0 * MALDE_SCALE)
    for B, Q, R in ((300, 16, 16), (64, 24, 48), (40, 96, 128)):
        ref, qry, m, n, qq = _random_runs(rng, B, R, Q)
        rq = jnp.full((B, R), PHRED42_MAX, jnp.int32)
        ops_x, cnt_x = realign_device_kernel(
            ref, qry, n, m, go, ge, rq, qq, True, R, Q
        )
        ops_p, cnt_p = dp_align(ref, qry, m, n, go, ge, R, Q, qq=qq)
        assert np.array_equal(np.asarray(cnt_x), np.asarray(cnt_p)), (B, Q, R)
        assert np.array_equal(np.asarray(ops_x), np.asarray(ops_p)), (B, Q, R)


@pytest.mark.gpu
@pytest.mark.parametrize("quality", [False, True])
def test_dp_align_on_gpu_matches_oracle(quality):
    """The DP compiled for the card at the aggregate window's width
    (chip_smoke.py also runs 48x48 x 131,072 runs)."""
    import jax

    if jax.default_backend() != "gpu":
        pytest.skip("needs a CUDA GPU (run on the card by chip_smoke.py)")
    from panvc3_tpu.align import MALDE_SCALE
    from panvc3_tpu.ops.realign_batch import dp_align

    B, R, Q = 16384, 16, 16
    ref, qry, m, n, qq = _random_runs(np.random.default_rng(5), B, R, Q)
    scale = MALDE_SCALE if quality else 1
    ops, cnt = jax.jit(dp_align, static_argnames=("R", "Q"))(
        ref, qry, m, n, jnp.float32(-2 * scale), jnp.float32(-1 * scale),
        R=R, Q=Q, qq=qq if quality else None,
    )
    sample = np.random.default_rng(6).choice(B, 256, replace=False)
    got = _device_cigars(np.asarray(ops)[sample], np.asarray(cnt)[sample])
    assert got == _oracle_cigars(
        ref[sample], qry[sample], m[sample], n[sample], -2, -1,
        qq[sample] if quality else None,
    )


def test_table_budget_policy_and_large_n_fallback():
    """The HBM policy disables tables when over budget, and the fallback
    answers match the host at genome-scale-shaped sizes (VERDICT r1 #10;
    the reference's reason for RRR, msa_index.hh:43-54)."""
    import panvc3_tpu.ops.rank_select as rs

    rng = np.random.default_rng(11)
    # large-n: one 4 Mbp-aligned-column vector with ~30% gaps
    n = 4_000_000
    bits = (rng.random(n) < 0.3).astype(np.uint8)
    gv = GapBitVector.from_bits(bits)

    # policy: a budget too small for either table must force the fallback
    orig = rs._table_budget_bytes
    rs._table_budget_bytes = lambda: 1024
    try:
        idx = DeviceGapIndex.build([gv])
    finally:
        rs._table_budget_bytes = orig
    assert idx.zsel is None and idx.rtab is None

    ks = rng.integers(1, gv.n_zeros + 1, 4096).astype(np.int32)
    pos = rng.integers(0, n, 4096).astype(np.int32)
    seq = np.zeros(4096, np.int32)
    assert np.array_equal(
        np.asarray(idx.select0(jnp.asarray(seq), jnp.asarray(ks))), gv.select0(ks)
    )
    assert np.array_equal(
        np.asarray(idx.rank0(jnp.asarray(seq), jnp.asarray(pos))), gv.rank0(pos)
    )
    r, b = idx.rank0_and_bit(jnp.asarray(seq), jnp.asarray(pos))
    assert np.array_equal(np.asarray(r), gv.rank0(pos))
    assert np.array_equal(np.asarray(b), gv.bit_at(pos))

    # a generous budget enables both tables
    rs._table_budget_bytes = lambda: 1 << 40
    try:
        idx2 = DeviceGapIndex.build([gv])
    finally:
        rs._table_budget_bytes = orig
    assert idx2.zsel is not None and idx2.rtab is not None
    assert np.array_equal(
        np.asarray(idx2.select0(jnp.asarray(seq), jnp.asarray(ks))), gv.select0(ks)
    )


class TestWireFormats:
    """Packed single-buffer wire variants must match the multi-array
    kernels exactly (the fast lane ships these to the device)."""

    def test_gap_wire_matches_packed(self):
        import jax

        from panvc3_tpu.bitvec import GapBitVector
        from panvc3_tpu.ops.rank_select import DeviceGapIndex
        from panvc3_tpu.ops.rewrite_batch import (
            pack_gap_wire_input,
            rewrite_gap_kernel_packed,
            rewrite_gap_kernel_wire,
            unpack_gap_wire,
        )

        rng = np.random.default_rng(3)
        n_cols = 800
        vecs = []
        for _ in range(3):
            gaps = rng.random(n_cols) < 0.08
            s = np.where(gaps, ord("-"), ord("A")).astype(np.uint8)
            vecs.append(GapBitVector.from_gap_string(s.tobytes()))
        index = DeviceGapIndex.build(vecs)

        B, R = 64, 32
        src = rng.integers(0, 3, B).astype(np.int32)
        dst = rng.integers(0, 3, B).astype(np.int32)
        n_units = rng.integers(1, R + 1, B).astype(np.int32)
        max_pos = min(v.n_zeros for v in vecs) - R - 2
        pos = rng.integers(0, max_pos, B).astype(np.int32)

        ref = rewrite_gap_kernel_packed(index, src, dst, pos, n_units, R)
        initial, gapbits, d_vals, d_pos, d_n8, overflow, d_run = [
            np.asarray(x) for x in ref
        ]

        wire, overflow_w, d_run_w = rewrite_gap_kernel_wire(
            index, pack_gap_wire_input(pos, n_units, src, dst), R
        )
        wire = np.asarray(wire)
        dst_pos_u, d_n_u, gapbits_u, d_pos_u, d_vals_u = unpack_gap_wire(
            wire, R
        )
        np.testing.assert_array_equal(dst_pos_u, initial)
        np.testing.assert_array_equal(d_n_u, d_n8)
        np.testing.assert_array_equal(gapbits_u, gapbits)
        np.testing.assert_array_equal(d_pos_u, d_pos)
        np.testing.assert_array_equal(d_vals_u, d_vals)
        assert int(overflow_w) == int(overflow)
        np.testing.assert_array_equal(np.asarray(d_run_w), d_run)

    def test_realign_wire_matches_kernel(self):
        from panvc3_tpu.ops.realign_batch import (
            pack_realign_wire_input,
            realign_device_kernel,
            realign_device_kernel_wire,
            unpack_realign_wire,
        )

        rng = np.random.default_rng(5)
        S, R, Q = 48, 8, 8
        bases = np.frombuffer(b"ACGT", dtype=np.uint8)
        ref = rng.choice(bases, (S, R)).astype(np.uint8)
        q = rng.choice(bases, (S, Q)).astype(np.uint8)
        rl = rng.integers(1, R + 1, S).astype(np.int32)
        ql = rng.integers(1, Q + 1, S).astype(np.int32)
        ref[np.arange(R)[None, :] >= rl[:, None]] = 0
        q[np.arange(Q)[None, :] >= ql[:, None]] = 0
        go, ge = np.float32(0), np.float32(-1)

        ops_ref, count_ref = [
            np.asarray(x)
            for x in realign_device_kernel(
                ref, q, rl, ql, go, ge,
                np.zeros((1, 1), np.int32), np.zeros((1, 1), np.int32),
                False, R, Q,
            )
        ]
        wire = np.asarray(
            realign_device_kernel_wire(
                pack_realign_wire_input(ref, q, rl, ql), go, ge, R, Q
            )
        )
        ops_w, count_w = unpack_realign_wire(wire, R + Q)
        np.testing.assert_array_equal(count_w, count_ref)
        for i in range(S):
            np.testing.assert_array_equal(
                ops_w[i, : count_w[i]], ops_ref[i, : count_ref[i]]
            )

    def test_realign_refgather_wire_matches_wire(self):
        """The ref-gather wire variant (reference rows gathered on device
        from the flat reference and dna5-normalised in-kernel; query as
        4-bit match-equivalence codes; traceback 2-bit packed) must equal
        the classic wire kernel fed the staged rows (dna5_table applied,
        zero-padded past rl) — including raw lowercase/N/junk bytes on
        both sides, zero-length padding rows and starts at the buffer
        edges."""
        from panvc3_tpu.alphabet import DNA5_NORMALISE
        from panvc3_tpu.ops.realign_batch import (
            pack_realign_refgather_input,
            pack_realign_wire_input,
            realign_device_kernel_wire,
            realign_device_kernel_wire_refgather,
            unpack_realign_refgather_wire,
            unpack_realign_wire,
        )

        rng = np.random.default_rng(17)
        S, R, Q = 64, 8, 8
        flat = rng.choice(
            np.frombuffer(b"ACGTacgtNnUuXx-\x00", dtype=np.uint8), 4096
        ).astype(np.uint8)
        start = rng.integers(0, len(flat) - R, S).astype(np.int64)
        start[0] = 0
        start[1] = len(flat) - R
        rl = rng.integers(1, R + 1, S).astype(np.int32)
        ql = rng.integers(1, Q + 1, S).astype(np.int32)
        # zero-length padding rows, as the aggregate dispatch emits them
        rl[-4:] = 0
        ql[-4:] = 0
        start[-4:] = 0
        # query bytes include lowercase/N/junk: the 4-bit code must
        # preserve the match matrix vs dna5-normalised reference bytes
        q = rng.choice(
            np.frombuffer(b"ACGTACGTACGTNnat?", dtype=np.uint8), (S, Q)
        ).astype(np.uint8)
        q[np.arange(Q)[None, :] >= ql[:, None]] = 0

        # staged rows, exactly as pv3_stage_realign_runs builds them
        ref = np.zeros((S, R), np.uint8)
        for i in range(S):
            ref[i, : rl[i]] = DNA5_NORMALISE[
                flat[start[i]: start[i] + rl[i]]
            ]
        go, ge = np.float32(0), np.float32(-1)

        classic = np.asarray(
            realign_device_kernel_wire(
                pack_realign_wire_input(ref, q, rl, ql), go, ge, R, Q
            )
        )
        ops_c, cnt_c = unpack_realign_wire(classic, R + Q)
        gathered = np.asarray(
            realign_device_kernel_wire_refgather(
                pack_realign_refgather_input(q, start, rl, ql),
                jnp.asarray(flat), go, ge, R, Q,
            )
        )
        ops_g, cnt_g = unpack_realign_refgather_wire(gathered, R + Q)
        np.testing.assert_array_equal(cnt_g, cnt_c)
        for i in range(S):
            np.testing.assert_array_equal(
                ops_g[i, : cnt_g[i]], ops_c[i, : cnt_c[i]]
            )

    def test_realign_refgather2_wire_matches_wire(self):
        """The 2-bit query wire (A/C/G/T-only windows, u8 lens) must be
        byte-identical to the classic wire on eligible inputs — including
        zero-length padding rows, starts at the buffer edges, and N/junk
        bytes in the REFERENCE (only the query must be clean)."""
        from panvc3_tpu.alphabet import DNA5_NORMALISE
        from panvc3_tpu.ops.realign_batch import (
            pack_realign_refgather2_input,
            pack_realign_wire_input,
            query_wire2_eligible,
            realign_device_kernel_wire,
            realign_device_kernel_wire_refgather2,
            unpack_realign_refgather_wire,
            unpack_realign_wire,
        )

        rng = np.random.default_rng(23)
        S, R, Q = 64, 8, 8
        flat = rng.choice(
            np.frombuffer(b"ACGTacgtNnUuXx-\x00", dtype=np.uint8), 4096
        ).astype(np.uint8)
        start = rng.integers(0, len(flat) - R, S).astype(np.int64)
        start[0] = 0
        start[1] = len(flat) - R
        rl = rng.integers(1, R + 1, S).astype(np.int32)
        ql = rng.integers(1, Q + 1, S).astype(np.int32)
        rl[-4:] = 0
        ql[-4:] = 0
        start[-4:] = 0
        q = rng.choice(
            np.frombuffer(b"ACGT", dtype=np.uint8), (S, Q)
        ).astype(np.uint8)
        q[np.arange(Q)[None, :] >= ql[:, None]] = 0
        assert query_wire2_eligible(q, ql)

        ref = np.zeros((S, R), np.uint8)
        for i in range(S):
            ref[i, : rl[i]] = DNA5_NORMALISE[
                flat[start[i]: start[i] + rl[i]]
            ]
        go, ge = np.float32(0), np.float32(-1)

        classic = np.asarray(
            realign_device_kernel_wire(
                pack_realign_wire_input(ref, q, rl, ql), go, ge, R, Q
            )
        )
        ops_c, cnt_c = unpack_realign_wire(classic, R + Q)
        w2 = np.asarray(
            realign_device_kernel_wire_refgather2(
                pack_realign_refgather2_input(q, start, rl, ql),
                jnp.asarray(flat), go, ge, R, Q,
            )
        )
        ops_2, cnt_2 = unpack_realign_refgather_wire(w2, R + Q)
        np.testing.assert_array_equal(cnt_2, cnt_c)
        for i in range(S):
            np.testing.assert_array_equal(
                ops_2[i, : cnt_2[i]], ops_c[i, : cnt_c[i]]
            )

    def test_query_wire2_eligibility(self):
        from panvc3_tpu.ops.realign_batch import query_wire2_eligible

        q = np.frombuffer(b"ACGTACGT", dtype=np.uint8).reshape(1, 8).copy()
        ql = np.asarray([8], np.int32)
        assert query_wire2_eligible(q, ql)
        # an N inside the length disqualifies the window
        qn = q.copy()
        qn[0, 3] = ord("N")
        assert not query_wire2_eligible(qn, ql)
        # zero padding past ql never disqualifies
        qp = q.copy()
        qp[0, 6:] = 0
        assert query_wire2_eligible(qp, np.asarray([6], np.int32))
        # a zero byte INSIDE the length is not representable -> ineligible
        qz = q.copy()
        qz[0, 2] = 0
        assert not query_wire2_eligible(qz, ql)
        # Q not divisible by 4
        assert not query_wire2_eligible(q[:, :6], np.asarray([6], np.int32))

    def test_event_geometry_matches_gap_kernel(self):
        """Host event-based geometry == device gap kernel on random MSAs
        (the fast lane substitutes the former for the latter)."""
        import jax

        from panvc3_tpu.bitvec import GapBitVector
        from panvc3_tpu.msa_index import SequenceEntry
        from panvc3_tpu.ops.event_geometry import EventGeometry
        from panvc3_tpu.ops.rank_select import DeviceGapIndex
        from panvc3_tpu.ops.rewrite_batch import _gap_math

        rng = np.random.default_rng(11)
        for trial in range(4):
            n_cols = 600
            vecs = []
            for _ in range(3):
                gaps = rng.random(n_cols) < (0.02 + 0.1 * trial)
                s = np.where(gaps, ord("-"), ord("A")).astype(np.uint8)
                vecs.append(GapBitVector.from_gap_string(s.tobytes()))
            entries = [SequenceEntry(str(i), v) for i, v in enumerate(vecs)]
            src_entries = entries
            dst_entries = [entries[0]]
            rim = [0, 0, 0]
            index = DeviceGapIndex.build(vecs)

            B, R = 128, 48
            K = 8
            ref_ids = rng.integers(0, 3, B).astype(np.int32)
            src_dev = ref_ids  # dev id == entry order here
            n_units = rng.integers(0, R + 1, B).astype(np.int32)
            max_pos = min(v.n_zeros for v in vecs) - R - 2
            pos = rng.integers(0, max_pos, B).astype(np.int32)

            initial, d_run, isgap = [
                np.asarray(x)
                for x in jax.jit(_gap_math, static_argnames=("R",))(
                    index, src_dev, np.zeros(B, np.int32), pos, n_units, R
                )
            ]

            eg = EventGeometry(src_entries, dst_entries, rim)
            dst_pos, gapbits, d_vals, d_pos, d_n, use_full, d_full = eg.batch(
                ref_ids, pos, n_units, R, K
            )
            np.testing.assert_array_equal(dst_pos, initial)
            got_isgap = np.unpackbits(
                gapbits, axis=1, bitorder="little", count=R
            )
            np.testing.assert_array_equal(got_isgap, isgap.astype(np.uint8))
            if use_full:
                got_d = np.asarray(d_full).reshape(B, R)
            else:
                got_d = np.zeros((B, R), np.int32)
                kk = np.arange(K)[None, :]
                valid = kk < d_n[:, None]
                rw = np.broadcast_to(np.arange(B)[:, None], valid.shape)[valid]
                got_d[rw, d_pos[valid].astype(np.int64)] = d_vals[valid]
            np.testing.assert_array_equal(got_d, d_run)

    def test_device_event_geometry_matches_gap_kernel(self):
        """The device event-geometry kernel == the device gap kernel's
        packed outputs on random MSAs whenever no record overflows the
        event slots (the kernel reports overflow otherwise)."""
        import jax

        from panvc3_tpu.bitvec import GapBitVector
        from panvc3_tpu.msa_index import SequenceEntry
        from panvc3_tpu.ops.event_geometry import (
            DeviceEventGeometry,
            EventGeometry,
        )
        from panvc3_tpu.ops.rank_select import DeviceGapIndex
        from panvc3_tpu.ops.rewrite_batch import _gap_math_packed

        rng = np.random.default_rng(17)
        for trial in range(4):
            n_cols = 600
            vecs = []
            for _ in range(3):
                gaps = rng.random(n_cols) < (0.02 + 0.06 * trial)
                s = np.where(gaps, ord("-"), ord("A")).astype(np.uint8)
                vecs.append(GapBitVector.from_gap_string(s.tobytes()))
            entries = [SequenceEntry(str(i), v) for i, v in enumerate(vecs)]
            rim = [0, 0, 0]
            index = DeviceGapIndex.build(vecs)

            B, R = 128, 48
            ref_ids = rng.integers(0, 3, B).astype(np.int32)
            n_units = rng.integers(0, R + 1, B).astype(np.int32)
            max_pos = min(v.n_zeros for v in vecs) - R - 2
            pos = rng.integers(0, max_pos, B).astype(np.int32)

            want = [
                np.asarray(x)
                for x in jax.jit(_gap_math_packed, static_argnames=("R",))(
                    index, ref_ids, np.zeros(B, np.int32), pos, n_units, R
                )
            ]

            host = EventGeometry(entries, [entries[0]], rim)
            dev = DeviceEventGeometry(host)
            got = [
                np.asarray(x)
                for x in jax.jit(dev.kernel, static_argnames=("R",))(
                    ref_ids, pos, n_units, R
                )
            ]
            if int(got[5]) or int(want[5]):
                # overflowing trials prove nothing; the slot counts make
                # this rare (assert so the test stays meaningful)
                assert trial >= 2, "unexpected overflow on sparse trial"
                continue
            for g, w, name in zip(
                got[:5], want[:5],
                ("dst_pos", "gapbits", "d_vals", "d_pos", "d_n"),
            ):
                np.testing.assert_array_equal(g, w, err_msg=name)

    def test_event_geometry_native_matches_numpy(self):
        """The C event_geometry_batch is bit-identical to the numpy
        implementation, including the use_full (dense deletion) path and
        position clamping at sequence edges."""
        import os

        from panvc3_tpu.bitvec import GapBitVector
        from panvc3_tpu.msa_index import SequenceEntry
        from panvc3_tpu.native import get_native
        from panvc3_tpu.ops.event_geometry import EventGeometry

        if get_native() is None:
            import pytest

            pytest.skip("native extension not built")

        rng = np.random.default_rng(23)
        # gap_frac 0.35 with runs produces >255-long deletions rarely; add
        # a forced long dst-gap run to exercise use_full
        for trial, (n_cols, gap_frac, K) in enumerate(
            [(600, 0.05, 8), (900, 0.35, 2), (400, 0.0, 8)]
        ):
            vecs = []
            for vi in range(3):
                gaps = rng.random(n_cols) < gap_frac
                if trial == 1 and vi == 0:
                    gaps[50:120] = True  # long run: dst gaps force deletions
                s = np.where(gaps, ord("-"), ord("A")).astype(np.uint8)
                vecs.append(GapBitVector.from_gap_string(s.tobytes()))
            entries = [SequenceEntry(str(i), v) for i, v in enumerate(vecs)]
            rim = [0, 0, 0]

            B, R = 64, 32
            ref_ids = rng.integers(0, 3, B).astype(np.int32)
            n_units = rng.integers(0, R + 1, B).astype(np.int32)
            maxp = max(1, min(v.n_zeros for v in vecs) - 1)
            pos = rng.integers(0, maxp, B).astype(np.int32)
            pos[0] = 0
            pos[1] = maxp - 1  # edge clamps

            eg_native = EventGeometry(entries, [entries[0]], rim)
            assert eg_native._native is not None
            os.environ["PANVC3_EVENT_GEOMETRY_NATIVE"] = "0"
            try:
                eg_np = EventGeometry(entries, [entries[0]], rim)
            finally:
                del os.environ["PANVC3_EVENT_GEOMETRY_NATIVE"]
            assert eg_np._native is None

            got = eg_native.batch(ref_ids, pos, n_units, R, K)
            want = eg_np.batch(ref_ids, pos, n_units, R, K)
            assert got[5] == want[5]  # use_full agrees
            for g, w in zip(got[:5] + (got[6],), want[:5] + (want[6],)):
                np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


def test_realign_runs_host_matches_device_kernel():
    """The C host realignment DP (the latency path for small batches) must
    emit exactly the device kernel's traceback ops and counts — same
    float32 recurrences, same diag>=vert>horiz and open>=extend ties."""
    import pytest

    from panvc3_tpu.native import get_native
    from panvc3_tpu.ops.realign_batch import realign_device_kernel

    nat = get_native()
    if nat is None or not hasattr(nat, "realign_runs_host"):
        pytest.skip("native extension not built")

    rng = np.random.default_rng(11)
    dummy = np.zeros((1, 1), np.int32)
    for trial in range(4):
        S, Rp, Qp = 48, 16, 16
        ref = rng.integers(65, 91, (S, Rp), dtype=np.uint8)
        q = rng.integers(65, 91, (S, Qp), dtype=np.uint8)
        # realistic runs: near-identical pairs with a few mismatches
        for s in range(0, S, 2):
            q[s, :Rp] = ref[s]
            q[s, rng.integers(0, Rp, 3)] = rng.integers(65, 91, 3)
        rl = rng.integers(1, Rp + 1, S).astype(np.int32)
        ql = rng.integers(1, Qp + 1, S).astype(np.int32)
        go, ge = float(-(trial % 3)), -1.0

        dops, dcnt = realign_device_kernel(
            ref, q, rl, ql, np.float32(go), np.float32(ge),
            dummy, dummy, False, Rp, Qp,
        )
        dops, dcnt = np.asarray(dops), np.asarray(dcnt)
        hops_b, hcnt_b = nat.realign_runs_host(
            ref.tobytes(), q.tobytes(), rl.tobytes(), ql.tobytes(),
            Rp, Qp, go, ge,
        )
        hops = np.frombuffer(hops_b, np.int8).reshape(S, Rp + Qp)
        hcnt = np.frombuffer(hcnt_b, np.int32)
        np.testing.assert_array_equal(hcnt, dcnt)
        for s in range(S):
            np.testing.assert_array_equal(
                hops[s, : hcnt[s]], dops[s, : dcnt[s]]
            )


def test_realign_q_wire_kernels_match_host_dp():
    """The -q wire kernels (classic + ref-gather: query phreds as u8, ref
    quals pinned, 2-bit packed traceback out) must decode to the same
    ops/counts as the host C DP with explicit pinned ref quals."""
    from panvc3_tpu.align import MALDE_SCALE, malde_tables
    from panvc3_tpu.alphabet import PHRED42_MAX
    from panvc3_tpu.native import get_native
    from panvc3_tpu.ops.realign_batch import (
        pack_realign_refgather_input_q,
        pack_realign_wire_input_q,
        realign_device_kernel_wire_q,
        realign_device_kernel_wire_refgather_q,
        unpack_realign_refgather_wire,
    )

    nat = get_native()
    if nat is None or not hasattr(nat, "realign_runs_host"):
        pytest.skip("native extension not built")

    rng = np.random.default_rng(41)
    S, Rp, Qp = 300, 16, 16
    steps = Rp + Qp
    flat = rng.choice(
        np.frombuffer(b"ACGTN", np.uint8), 4096
    ).astype(np.uint8)
    start = rng.integers(0, 4096 - Rp, S).astype(np.int64)
    rl = rng.integers(1, Rp + 1, S).astype(np.int32)
    ql = rng.integers(1, Qp + 1, S).astype(np.int32)
    rl[0] = 0
    ql[1] = 0
    lane = np.arange(Rp)
    # flat is already dna5 bytes, so the in-kernel normalisation is identity
    ref = flat[start[:, None] + lane]
    ref = np.where(lane[None, :] < rl[:, None], ref, 0).astype(np.uint8)
    qry = rng.choice(np.frombuffer(b"ACGT", np.uint8), (S, Qp))
    qry = np.where(lane[None, :Qp] < ql[:, None], qry, 0).astype(np.uint8)
    qq = rng.integers(0, 42, (S, Qp)).astype(np.uint8)
    go, ge = -6.0, -1.0
    kgo = np.float32(go * MALDE_SCALE)
    kge = np.float32(ge * MALDE_SCALE)

    mt, xt = malde_tables()
    rq_full = np.full((S, Rp), PHRED42_MAX, np.int32)
    hops_b, hcnt_b = nat.realign_runs_host(
        ref.tobytes(), qry.tobytes(), rl.tobytes(), ql.tobytes(), Rp, Qp,
        float(kgo), float(kge),
        rq_full.tobytes(), qq.astype(np.int32).tobytes(),
        mt.tobytes(), xt.tobytes(),
    )
    hops = np.frombuffer(hops_b, np.int8).reshape(S, steps)
    hcnt = np.frombuffer(hcnt_b, np.int32)

    from panvc3_tpu.ops.realign_batch import (
        pack_realign_refgather2_input_q,
        query_wire2_eligible,
        realign_device_kernel_wire_refgather2_q,
    )

    assert query_wire2_eligible(qry, ql)
    wires = {
        "classic": realign_device_kernel_wire_q(
            pack_realign_wire_input_q(ref, qry, rl, ql, qq),
            kgo, kge, Rp, Qp,
        ),
        "refgather": realign_device_kernel_wire_refgather_q(
            pack_realign_refgather_input_q(qry, start, rl, ql, qq),
            jnp.asarray(flat), kgo, kge, Rp, Qp,
        ),
        "refgather2": realign_device_kernel_wire_refgather2_q(
            pack_realign_refgather2_input_q(qry, start, rl, ql, qq),
            jnp.asarray(flat), kgo, kge, Rp, Qp,
        ),
    }
    for name, w in wires.items():
        dops, dcnt = unpack_realign_refgather_wire(np.asarray(w), steps)
        np.testing.assert_array_equal(hcnt, dcnt, err_msg=name)
        for s in range(S):
            np.testing.assert_array_equal(
                hops[s, : hcnt[s]], dops[s, : dcnt[s]], err_msg=name
            )


def test_event_bucket_search_matches_host_oracle(monkeypatch):
    """The two-level rank-bucket search (deep event tables) must reproduce
    the host event oracle exactly, on a pair dense enough that the bucket
    branch actually activates.  (Bucket-vs-full-search equality was also
    verified directly; the full-range search compiles pathologically
    slowly on XLA CPU at this table depth, so CI compares against the
    oracle instead.)"""
    import jax

    from panvc3_tpu.bitvec import GapBitVector
    from panvc3_tpu.msa_index import SequenceEntry
    from panvc3_tpu.ops.event_geometry import (
        DeviceEventGeometry,
        EventGeometry,
    )

    rng = np.random.default_rng(23)
    n_cols = 400_000
    src_bits = (rng.random(n_cols) < 0.02).astype(np.uint8)
    dst_bits = (rng.random(n_cols) < 0.02).astype(np.uint8)
    src_bits[0] = dst_bits[0] = 0
    src = SequenceEntry("F", GapBitVector.from_bits(src_bits))
    dst = SequenceEntry("REF", GapBitVector.from_bits(dst_bits))
    host = EventGeometry([src], [dst], [0])
    geo = DeviceEventGeometry(host)
    # table deep enough that bucketing engages (else the test is vacuous)
    assert geo.bucket_steps + 2 < max(
        int(np.ceil(np.log2(geo.max_gap + 1))) + 1,
        int(np.ceil(np.log2(geo.max_del + 1))) + 1,
    )

    monkeypatch.delenv("PANVC3_EVENT_BUCKETS", raising=False)
    B, R = 256, 128
    ref_ids = np.zeros(B, np.int32)
    pos = rng.integers(0, src.gaps.n_zeros - 200, B).astype(np.int32)
    # hit the clamp paths too
    pos[:2] = [0, src.gaps.n_zeros - 130]
    n_units = rng.integers(0, 101, B).astype(np.int32)

    got = [
        np.asarray(x)
        for x in jax.jit(geo.kernel, static_argnames=("R",))(
            ref_ids, pos, n_units, R
        )
    ]
    assert int(got[5]) == 0, "unexpected event-slot overflow"
    want = host.batch(ref_ids, pos, n_units, R, 8)
    assert int(want[5]) == 0
    for g, w, name in zip(
        got[:5],
        (want[0], want[1], want[2], want[3], want[4]),
        ("dst_pos", "gapbits", "d_vals", "d_pos", "d_n"),
    ):
        np.testing.assert_array_equal(g, w, err_msg=name)


def test_event_slots_edge_positions_match_host(monkeypatch):
    """Device event slots == the host oracle at clamped/degenerate
    positions (p < 0, p = nz-1, p >= nz, all-gap rows) and boundary
    events (gap run ending at rank nz-1, del_b == 0, del_b == nz) — the
    cases the kernel's derived ju/jd search lanes special-case."""
    import jax

    from panvc3_tpu.bitvec import GapBitVector
    from panvc3_tpu.msa_index import SequenceEntry
    from panvc3_tpu.ops.event_geometry import (
        DeviceEventGeometry,
        EventGeometry,
    )

    def gv(s):
        return GapBitVector.from_gap_string(s.encode())

    # pair 0: gap run ending exactly at rank nz-1, del boundary at nz
    # pair 1: del boundary at 0 (first_db == 0)
    # pair 2: no events at all
    # pair 3: all-gap source row (nz == 0, del_b == [0])
    srcs = ["AA--AAA-", "-AAAA", "AAAA", "----"]
    dsts = ["A-A-AA-A", "AAAAA", "AAAA", "AAAA"]
    src_entries = [
        SequenceEntry(f"F{i}", gv(s)) for i, s in enumerate(srcs)
    ]
    dst_entries = [
        SequenceEntry(f"R{i}", gv(s)) for i, s in enumerate(dsts)
    ]
    rim = [0, 1, 2, 3]

    rids, poss, nus = [], [], []
    for rid, s in enumerate(src_entries):
        nz = s.gaps.n_zeros
        for p in (-2, -1, 0, 1, max(nz - 2, 0), max(nz - 1, 0), nz, nz + 1,
                  nz + 5):
            for nu in (0, 1, 2, 3):
                rids.append(rid)
                poss.append(p)
                nus.append(nu)
    ref_ids = np.asarray(rids, np.int32)
    pos = np.asarray(poss, np.int32)
    n_units = np.asarray(nus, np.int32)
    R, K = 16, 8

    monkeypatch.setenv("PANVC3_EVENT_GEOMETRY_NATIVE", "0")
    host_np = EventGeometry(src_entries, dst_entries, rim)
    monkeypatch.delenv("PANVC3_EVENT_GEOMETRY_NATIVE")
    host_nat = EventGeometry(src_entries, dst_entries, rim)

    dev = DeviceEventGeometry(host_np)
    got = [
        np.asarray(x)
        for x in jax.jit(dev.kernel, static_argnames=("R",))(
            ref_ids, pos, n_units, R
        )
    ]
    assert int(got[5]) == 0, "unexpected event-slot overflow"
    for host in (host_np, host_nat):
        want = host.batch(ref_ids, pos, n_units, R, K)
        assert int(want[5]) == 0
        for g, w, name in zip(
            got[:5], want[:5],
            ("dst_pos", "gapbits", "d_vals", "d_pos", "d_n"),
        ):
            np.testing.assert_array_equal(g, w, err_msg=name)


def test_dna5_normalise_device_matches_table():
    """The vectorised device normaliser == DNA5_NORMALISE on all 256 byte
    values (it replaces the serialized table gather in the fused kernels)."""
    import jax

    from panvc3_tpu.alphabet import DNA5_NORMALISE, dna5_normalise_device

    x = np.arange(256, dtype=np.uint8)
    got = np.asarray(jax.jit(dna5_normalise_device)(x))
    np.testing.assert_array_equal(got, DNA5_NORMALISE[x])


def test_event_slots_random_positions_match_host(monkeypatch):
    """Randomized differential for the derived search lanes: random MSAs,
    positions spanning [-5, nz+5] (including the clamp regions), random
    unit counts — device kernel == host numpy oracle byte for byte."""
    import jax

    from panvc3_tpu.bitvec import GapBitVector
    from panvc3_tpu.msa_index import SequenceEntry
    from panvc3_tpu.ops.event_geometry import (
        DeviceEventGeometry,
        EventGeometry,
    )

    monkeypatch.setenv("PANVC3_EVENT_GEOMETRY_NATIVE", "0")
    rng = np.random.default_rng(31)
    R, K = 32, 8
    for trial in range(6):
        n_cols = 300
        vecs = []
        for _ in range(3):
            gaps = rng.random(n_cols) < (0.02 + 0.05 * trial)
            s = np.where(gaps, ord("-"), ord("A")).astype(np.uint8)
            s[0] = ord("A")
            vecs.append(GapBitVector.from_gap_string(s.tobytes()))
        entries = [SequenceEntry(str(i), v) for i, v in enumerate(vecs)]
        host = EventGeometry(entries, [entries[0]], [0, 0, 0])
        dev = DeviceEventGeometry(host)

        B = 192
        ref_ids = rng.integers(0, 3, B).astype(np.int32)
        nz = np.asarray([vecs[r].n_zeros for r in ref_ids])
        pos = rng.integers(-5, nz + 6).astype(np.int32)
        n_units = rng.integers(0, R + 1, B).astype(np.int32)

        got = [
            np.asarray(x)
            for x in jax.jit(dev.kernel, static_argnames=("R",))(
                ref_ids, pos, n_units, R
            )
        ]
        want = host.batch(ref_ids, pos, n_units, R, K)
        if int(got[5]) or int(want[5]):
            # device overflow is a strict superset of host use_full (the
            # device also flags gap-slot overruns and d_len == 255), so
            # only the implication holds
            assert not int(want[5]) or int(got[5]), "host overflow unseen"
            continue
        for g, w, name in zip(
            got[:5], want[:5],
            ("dst_pos", "gapbits", "d_vals", "d_pos", "d_n"),
        ):
            np.testing.assert_array_equal(g, w, err_msg=name)
