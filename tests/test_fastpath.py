"""The native fast lane must be byte-identical to the object path.

The fast lane (pipeline/fastlane.py + native parse_stage_batch /
splice_apply_format) replaces the SamRecord object pipeline for the
default device-engine configuration; these tests drive both lanes over
workloads exercising every branch of the tag surgery and record filters
(project_alignments.cc:528-572, 735-918) and assert equality of output
bytes, statistics and the realigned-ranges TSV.
"""

import io

import numpy as np
import pytest

from panvc3_tpu.native import get_native
from panvc3_tpu.pipeline.project_alignments import (
    ProjectConfig,
    TagSpec,
    run_project_alignments,
)

from .test_workflow_data import WORKFLOW, founder_seqs, msa_files  # fixtures

pytestmark = pytest.mark.skipif(
    not WORKFLOW.exists() or get_native() is None,
    reason="toy data or native extension absent",
)


def _rich_sam(founder_seqs, n_reads=160, read_len=100, seed=11) -> bytes:
    """Paired reads with mixed CIGARs, a zoo of optional tags, and records
    hitting every skip filter."""
    rng = np.random.default_rng(seed)
    stripped = {sid: s.replace(b"-", b"") for sid, s in founder_seqs.items()}
    lines = ["@HD\tVN:1.6"]
    for sid, s in stripped.items():
        lines.append(f"@SQ\tSN:test/{sid}\tLN:{len(s)}")
    names = [s for s in stripped if s != "REF"]

    for i in range(n_reads):
        sid = names[int(rng.integers(len(names)))]
        s = stripped[sid]
        pos = int(rng.integers(0, len(s) - read_len - 20))
        kind = i % 3
        if kind == 0:
            cigar = f"{read_len}="
            seq = s[pos:pos + read_len]
        elif kind == 1:
            k = int(rng.integers(1, 6))
            half = read_len // 2
            seq = s[pos:pos + half] + s[pos + half + k:pos + half + k + (read_len - half)]
            cigar = f"{half}={k}D{read_len - half}="
        else:
            k = int(rng.integers(1, 6))
            j = int(rng.integers(1, 6))
            half = read_len // 2
            # deliberately weird: bytes() of an int64 array embeds NUL
            # padding, so seq is longer than the CIGAR consumes and holds
            # non-ACGT bytes — lanes must agree even on garbage input
            ins = rng.choice(np.frombuffer(b"ACGT", dtype=np.uint8), k).tobytes()
            seq = (
                s[pos:pos + half]
                + ins
                + s[pos + half + j:pos + half + j + (read_len - half - k)]
            )
            cigar = f"{half}={k}I{j}D{read_len - half - k}="
        q = seq.decode()
        qual = "".join(chr(33 + int(x)) for x in rng.integers(20, 42, len(q)))

        # mate plumbing: pair odd/even reads on the same founder; every
        # third pair points at another founder by name
        flag = 0x1 | (0x10 if i % 2 else 0x20)
        if i % 6 == 5:
            other = names[(names.index(sid) + 1) % len(names)]
            rnext = f"test/{other}"
        else:
            rnext = "="
        pnext = int(rng.integers(1, len(s) - read_len))

        # optional-tag zoo: preserved (AS), removed (XS, MD), arrays,
        # floats, characters, existing OA, NM for the OA field
        tags = [
            f"NM:i:{int(rng.integers(0, 4))}",
            f"AS:i:-{int(rng.integers(0, 30))}",
            f"XS:i:-{int(rng.integers(0, 30))}",
            "MD:Z:50A49",
            "XA:Z:alt,+100,100M,2;",
            f"ZB:B:s,-3,7,{int(rng.integers(0, 100))}",
            "ZF:f:2.5",
            "PG:Z:bowtie2",
        ]
        if i % 7 == 0:
            tags.append("OA:Z:chrX,123,+,100M,17,2;")
        if i % 11 == 0:
            tags.append("CO:Z:a comment with spaces")
        rng.shuffle(tags)

        lines.append(
            f"pair{i // 2}\t{flag}\ttest/{sid}\t{pos + 1}\t60\t{cigar}\t"
            f"{rnext}\t{pnext}\t{int(rng.integers(-400, 400))}\t{q}\t{qual}\t"
            + "\t".join(tags)
        )

        # interleave skip-filter records
        if i % 10 == 3:
            lines.append(f"skip{i}\t4\t*\t0\t0\t*\t*\t0\t0\tACGT\tIIII")
        if i % 10 == 6:
            lines.append(
                f"dup{i}\t1024\ttest/{sid}\t{pos + 1}\t60\t4=\t*\t0\t0\tACGT\tIIII"
            )
        if i % 10 == 9:
            lines.append(
                f"noseq{i}\t0\ttest/{sid}\t{pos + 1}\t60\t*\t*\t0\t0\t*\t*"
            )
    return ("\n".join(lines) + "\n").encode()


def _run(sam, index_path, tmp_path, *, fastlane, engine="device", name="x",
         device_batch_size=32, **cfg_kw):
    ranges_path = tmp_path / f"ranges_{name}.tsv"
    cfg = ProjectConfig(
        msa_index_path=str(index_path),
        reference_path=str(WORKFLOW / "genome/genome.fa.gz"),
        reference_msa_id="REF",
        ref_id_separator="/",
        tags=TagSpec(rec_idx="XI"),
        engine=engine,
        device_batch_size=device_batch_size,
        fastlane=fastlane,
        output_realigned_ranges_path=str(ranges_path),
        preserve_tags=("XA",),
        **cfg_kw,
    )
    out = io.BytesIO()
    stats = run_project_alignments(io.BytesIO(sam), out, cfg)
    return out.getvalue(), stats, ranges_path.read_text()


@pytest.mark.parametrize("use_quality", [False, True])
def test_fastlane_byte_identical(msa_files, founder_seqs, tmp_path, use_quality):
    index_path, _, _ = msa_files
    sam = _rich_sam(founder_seqs)
    kw = dict(use_read_base_qualities=use_quality)

    fast, fast_stats, fast_ranges = _run(
        sam, index_path, tmp_path, fastlane=True, name=f"fast{use_quality}", **kw
    )
    slow, slow_stats, slow_ranges = _run(
        sam, index_path, tmp_path, fastlane=False, name=f"slow{use_quality}", **kw
    )
    if use_quality:
        # the -q device DP is float32 and may pick co-optimal ties vs the
        # float64 host oracle; fast vs object device lanes must still be
        # byte-identical (same kernel, same inputs)
        assert fast == slow
        assert fast_ranges == slow_ranges
        assert fast_stats.realigned_range_count == slow_stats.realigned_range_count
        return
    host, host_stats, host_ranges = _run(
        sam, index_path, tmp_path, fastlane=False, engine="host", name="host"
    )

    assert fast == slow == host
    assert fast_ranges == slow_ranges == host_ranges
    for a, b in ((fast_stats, slow_stats), (fast_stats, host_stats)):
        assert a.matched_reads == b.matched_reads
        assert a.flags_not_matched == b.flags_not_matched
        assert a.ref_id_missing == b.ref_id_missing
        assert a.seq_missing == b.seq_missing
        assert a.realigned_range_count == b.realigned_range_count
        assert a.realigned_range_total_length == b.realigned_range_total_length
        assert a.realignment_cells == b.realignment_cells
        assert a.removed_tag_counts == b.removed_tag_counts
    assert fast_stats.realigned_range_count > 0
    assert fast_stats.flags_not_matched > 0
    assert fast_stats.seq_missing > 0
    assert "XS" in fast_stats.removed_tag_counts


def test_fastlane_debugging_ranges(msa_files, founder_seqs, tmp_path):
    index_path, _, _ = msa_files
    sam = _rich_sam(founder_seqs, n_reads=60)
    for keep, dbg in ((False, True), (True, True)):
        fast = _run(
            sam, index_path, tmp_path, fastlane=True, name=f"f{keep}{dbg}",
            keep_duplicate_ranges=keep, debugging_output=dbg,
        )
        slow = _run(
            sam, index_path, tmp_path, fastlane=False, name=f"s{keep}{dbg}",
            keep_duplicate_ranges=keep, debugging_output=dbg,
        )
        assert fast[0] == slow[0]
        assert fast[2] == slow[2]


def test_fastlane_odd_batch_sizes(msa_files, founder_seqs, tmp_path):
    """Batch boundaries must not shift task groups: odd batch sizes and a
    trailing partial batch still match the object path byte for byte."""
    index_path, _, _ = msa_files
    sam = _rich_sam(founder_seqs, n_reads=90)
    for bs in (8, 20, 64):
        fast = _run(
            sam, index_path, tmp_path, fastlane=True, name=f"fb{bs}",
            device_batch_size=bs,
        )
        slow = _run(
            sam, index_path, tmp_path, fastlane=False, name=f"sb{bs}",
            device_batch_size=bs,
        )
        assert fast[0] == slow[0], f"batch size {bs}"


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fastlane_fuzz_equivalence(msa_files, founder_seqs, tmp_path, seed):
    """Randomized differential test: arbitrary flags/CIGARs/tags/mates
    must produce identical bytes through both lanes."""
    rng = np.random.default_rng(100 + seed)
    stripped = {sid: s.replace(b"-", b"") for sid, s in founder_seqs.items()}
    names = [s for s in stripped if s != "REF"]
    lines = ["@HD\tVN:1.6"]
    for sid, s in stripped.items():
        lines.append(f"@SQ\tSN:test/{sid}\tLN:{len(s)}")

    def rand_cigar(read_len):
        """Valid CIGAR consuming read_len query bases."""
        parts = []
        q = 0
        if rng.random() < 0.3:
            h = int(rng.integers(1, 5))
            parts.append(f"{h}H")
        if rng.random() < 0.3:
            sc = int(rng.integers(1, 8))
            parts.append(f"{sc}S")
            q += sc
        while q < read_len:
            r = rng.random()
            n = int(rng.integers(1, min(20, read_len - q) + 1))
            if r < 0.55:
                parts.append(f"{n}=")
                q += n
            elif r < 0.7:
                parts.append(f"{n}X")
                q += n
            elif r < 0.8:
                parts.append(f"{n}I")
                q += n
            elif r < 0.9:
                parts.append(f"{int(rng.integers(1, 6))}D")
            elif r < 0.95:
                parts.append(f"{int(rng.integers(1, 4))}P")
            else:
                parts.append(f"{int(rng.integers(1, 6))}N")
        if rng.random() < 0.2:
            parts.append(f"{int(rng.integers(1, 5))}H")
        return "".join(parts), q

    def rand_tags():
        out = []
        for _ in range(int(rng.integers(0, 6))):
            r = rng.random()
            if r < 0.3:
                out.append(
                    f"{rng.choice(['AS','XS','NM','ZZ','xy'])}:i:"
                    f"{int(rng.integers(-1000, 1000))}"
                )
            elif r < 0.45:
                out.append(f"ZF:f:{rng.choice(['1.5','-0.25','2','1e2','0.1'])}")
            elif r < 0.6:
                out.append(f"MD:Z:{int(rng.integers(0, 100))}A{int(rng.integers(0, 50))}")
            elif r < 0.7:
                out.append("XA:A:" + chr(int(rng.integers(33, 126))))
            elif r < 0.85:
                sub = rng.choice(["c", "C", "s", "S", "i", "I"])
                items = ",".join(
                    str(int(rng.integers(0, 100))) for _ in range(int(rng.integers(0, 4)))
                )
                out.append(f"ZB:B:{sub}" + ("," + items if items else ""))
            else:
                out.append("CO:Z:free text 123")
        return out

    for i in range(150):
        sid = names[int(rng.integers(len(names)))]
        s = stripped[sid]
        read_len = int(rng.integers(20, 120))
        pos = int(rng.integers(0, len(s) - 200))
        cigar, qlen = rand_cigar(read_len)
        seq = s[pos:pos + qlen].decode() if qlen else "A"
        if qlen == 0:
            cigar = "1="
            qlen = 1
        flag = int(rng.choice([0, 16, 1 | 32, 1 | 16, 4, 1024, 256, 512]))
        if rng.random() < 0.3:
            rnext, pnext = "=", int(rng.integers(1, len(s)))
        elif rng.random() < 0.5:
            other = names[int(rng.integers(len(names)))]
            rnext, pnext = f"test/{other}", int(rng.integers(1, 1000))
        else:
            rnext, pnext = "*", 0
        qual = "".join(chr(33 + int(x)) for x in rng.integers(0, 42, qlen))
        fields = [
            f"q{i}", str(flag), f"test/{sid}", str(pos + 1),
            str(int(rng.integers(0, 61))), cigar, rnext, str(pnext),
            str(int(rng.integers(-500, 500))), seq, qual,
        ] + rand_tags()
        lines.append("\t".join(fields))
    sam = ("\n".join(lines) + "\n").encode()

    index_path, _, _ = msa_files
    fast = _run(sam, index_path, tmp_path, fastlane=True, name=f"fz{seed}",
                device_batch_size=16)
    slow = _run(sam, index_path, tmp_path, fastlane=False, name=f"sz{seed}",
                device_batch_size=16)
    assert fast[0] == slow[0]
    assert fast[2] == slow[2]
    assert fast[1].removed_tag_counts == slow[1].removed_tag_counts


def test_fastlane_splice_thread_invariance(
    msa_files, founder_seqs, tmp_path, monkeypatch
):
    """splice_apply_format fans records out over pthreads; the slab
    concatenation must be byte-identical for any thread count."""
    index_path, _, _ = msa_files
    sam = _rich_sam(founder_seqs, n_reads=120)
    outs = []
    for nt in ("1", "3", "8"):
        monkeypatch.setenv("PANVC3_SPLICE_THREADS", nt)
        outs.append(
            _run(sam, index_path, tmp_path, fastlane=True, name=f"t{nt}")
        )
    assert outs[0][0] == outs[1][0] == outs[2][0]
    assert outs[0][2] == outs[1][2] == outs[2][2]
    a, b, c = (o[1] for o in outs)
    assert (
        a.removed_tag_counts == b.removed_tag_counts == c.removed_tag_counts
    )
    assert (
        a.realignment_cells == b.realignment_cells == c.realignment_cells
    )


@pytest.mark.parametrize("use_quality", [False, True])
def test_fastlane_host_dp_matches_device_path(
    msa_files, founder_seqs, tmp_path, monkeypatch, use_quality
):
    """The adaptive realignment dispatch (host C DP below the cell
    threshold, device kernel above) must be invisible in the output:
    forcing either side produces identical bytes.  Covers both scoring
    schemes — the quantised Malde tables made -q integral too."""
    index_path, _, _ = msa_files
    sam = _rich_sam(founder_seqs, n_reads=120)
    kw = dict(use_read_base_qualities=use_quality)
    monkeypatch.setenv("PANVC3_HOST_DP", "0")
    dev = _run(sam, index_path, tmp_path, fastlane=True,
               name=f"dp_dev{use_quality}", **kw)
    monkeypatch.setenv("PANVC3_HOST_DP", "1")
    monkeypatch.setenv("PANVC3_HOST_DP_CELLS", "1000000000")
    host = _run(sam, index_path, tmp_path, fastlane=True,
                name=f"dp_host{use_quality}", **kw)
    assert dev[0] == host[0]
    assert dev[2] == host[2]
    assert dev[1].realignment_cells == host[1].realignment_cells
    assert dev[1].realigned_range_count == host[1].realigned_range_count
    assert dev[1].realigned_range_count > 0


def test_fastlane_bam_input_output(msa_files, founder_seqs, tmp_path):
    """BAM in / BAM out through the fast lane (C BAM<->SAM-text
    converters) must byte-match the object path's BAM output, and the
    decoded records must match the SAM-text fast lane run."""
    from panvc3_tpu.io.sam import SamReader, SamWriter

    index_path, _, _ = msa_files
    sam = _rich_sam(founder_seqs, n_reads=120)

    # SAM text -> BAM input file
    rd = SamReader(io.BytesIO(sam), is_bam=False)
    bam_in = io.BytesIO()
    w = SamWriter(bam_in, rd.header, bam=True)
    for rec in rd:
        w.write(rec)
    w.close()
    bam_bytes = bam_in.getvalue()

    def run_bam(fastlane, name):
        ranges_path = tmp_path / f"r_{name}.tsv"
        cfg = ProjectConfig(
            msa_index_path=str(index_path),
            reference_path=str(WORKFLOW / "genome/genome.fa.gz"),
            reference_msa_id="REF",
            ref_id_separator="/",
            tags=TagSpec(rec_idx="XI"),
            engine="device",
            device_batch_size=32,
            fastlane=fastlane,
            output_bam=True,
            output_realigned_ranges_path=str(ranges_path),
            preserve_tags=("XA",),
        )
        out = io.BytesIO()
        stats = run_project_alignments(io.BytesIO(bam_bytes), out, cfg)
        return out.getvalue(), stats, ranges_path.read_text()

    fast, fast_stats, fast_ranges = run_bam(True, "fast")
    slow, slow_stats, slow_ranges = run_bam(False, "slow")
    assert fast == slow
    assert fast_ranges == slow_ranges
    assert fast_stats.matched_reads == slow_stats.matched_reads
    assert fast_stats.realigned_range_count == slow_stats.realigned_range_count
    assert fast_stats.removed_tag_counts == slow_stats.removed_tag_counts

    # BAM-lane output decodes to the same records as the SAM-text lane fed
    # the BAM-round-tripped text (BAM normalises invalid SEQ bytes to N,
    # so compare against the same normalised input)
    from panvc3_tpu.io.sam import format_sam_record

    rt = SamReader(io.BytesIO(bam_bytes))
    sam_rt = (
        rt.header.to_text()
        + "\n".join(format_sam_record(r, rt.header) for r in rt)
        + "\n"
    ).encode()
    text_out, _, _ = _run(
        sam_rt, index_path, tmp_path, fastlane=True, name="bamref"
    )
    dec = SamReader(io.BytesIO(fast))
    got = [format_sam_record(r, dec.header) for r in dec]
    want = [
        l for l in text_out.decode().splitlines() if not l.startswith("@")
    ]
    assert got == want

def test_fastlane_match_span_mismatch_offsets(
    msa_files, founder_seqs, tmp_path
):
    """Stress the finalize_reconstruct bulk match-span compare: reads with
    substitutions at every mod-8 offset, clusters straddling the 8-byte
    chunk boundary, X runs, and non-multiple-of-8 read lengths, placed
    both in gap-free and gap-dense founder regions.  The fast lane must
    stay byte-identical to the host oracle."""
    index_path, _, _ = msa_files
    stripped = {sid: s.replace(b"-", b"") for sid, s in founder_seqs.items()}
    names = [s for s in stripped if s != "REF"]
    lines = ["@HD\tVN:1.6"]
    for sid, fs in stripped.items():
        lines.append(f"@SQ\tSN:test/{sid}\tLN:{len(fs)}")

    def mutate(seq: bytes, offsets) -> bytes:
        b = bytearray(seq)
        for o in offsets:
            if o < len(b):
                b[o] = b"ACGT"[(b"ACGT".index(bytes([b[o]])) + 1) % 4] \
                    if bytes([b[o]]) in b"ACGT" else ord("A")
        return bytes(b)

    rid = 0
    rng = np.random.default_rng(42)
    for read_len in (8, 37, 100, 101):
        for sid in names:
            s = stripped[sid]
            for start in (0, 13, len(s) // 2, len(s) - read_len - 1):
                if start < 0 or start + read_len > len(s):
                    continue
                base = s[start:start + read_len]
                layouts = (
                    [],  # pure match span
                    *([o] for o in range(min(16, read_len))),  # each offset
                    [6, 7, 8, 9],          # cluster across chunk boundary
                    list(range(5, 14)),    # 9-long X run
                    [read_len - 1],        # last base
                    sorted(set(int(x) for x in rng.integers(0, read_len, 6))),
                )
                for offs in layouts:
                    seq = mutate(base, offs)
                    lines.append(
                        f"m{rid}\t0\ttest/{sid}\t{start + 1}\t60\t"
                        f"{read_len}=\t*\t0\t0\t{seq.decode()}\t"
                        f"{'I' * read_len}"
                    )
                    rid += 1
    sam = ("\n".join(lines) + "\n").encode()

    fast = _run(sam, index_path, tmp_path, fastlane=True, name="spanfast")
    host = _run(sam, index_path, tmp_path, fastlane=False, engine="host",
                name="spanhost")
    assert fast[0] == host[0]
    assert fast[2] == host[2]


def test_fastlane_device_event_geometry_byte_identical(
    msa_files, founder_seqs, tmp_path, monkeypatch
):
    """PANVC3_EVENT_GEOMETRY=device (the event tables searched on device
    by DeviceEventGeometry.kernel_wire instead of on the host) must stay
    byte-identical to the default host event path, including the ranges
    TSV and a tiny batch size that exercises the bucket padding."""
    index_path, _, _ = msa_files
    sam = _rich_sam(founder_seqs, n_reads=150)
    base, base_stats, base_ranges = _run(
        sam, index_path, tmp_path, fastlane=True, name="devevbase"
    )
    monkeypatch.setenv("PANVC3_EVENT_GEOMETRY", "device")
    dev, dev_stats, dev_ranges = _run(
        sam, index_path, tmp_path, fastlane=True, name="devev"
    )
    dev16, _, dev16_ranges = _run(
        sam, index_path, tmp_path, fastlane=True, name="devev16",
        device_batch_size=16,
    )
    assert dev == base
    assert dev16 == base
    assert dev_ranges == base_ranges
    assert dev16_ranges == base_ranges
    assert dev_stats.matched_reads == base_stats.matched_reads
    assert dev_stats.realigned_range_count == base_stats.realigned_range_count
    assert dev_stats.removed_tag_counts == base_stats.removed_tag_counts


def test_fastlane_parse_in_pool_byte_identical(
    msa_files, founder_seqs, tmp_path, monkeypatch
):
    """The opt-in parse-in-pool mode (PANVC3_PARSE_IN_POOL=1: parse runs
    inside the batch pool jobs with record/task numbering precomputed from
    the scan mask) must stay byte-identical to the default, including the
    filter counters that now ride through the emit payload."""
    index_path, _, _ = msa_files
    sam = _rich_sam(founder_seqs)
    base, base_stats, base_ranges = _run(
        sam, index_path, tmp_path, fastlane=True, name="pipbase"
    )
    monkeypatch.setenv("PANVC3_PARSE_IN_POOL", "1")
    pip, pip_stats, pip_ranges = _run(
        sam, index_path, tmp_path, fastlane=True, name="pip"
    )
    assert pip == base
    assert pip_ranges == base_ranges
    assert pip_stats.matched_reads == base_stats.matched_reads
    assert pip_stats.flags_not_matched == base_stats.flags_not_matched
    assert pip_stats.seq_missing == base_stats.seq_missing
    assert pip_stats.removed_tag_counts == base_stats.removed_tag_counts


def test_cigar_seq_mismatch_rejected(msa_files, founder_seqs):
    """A record whose CIGAR consumes a different number of query bases
    than SEQ holds is rejected with the same typed error on the host and
    fast-lane paths (previously: host IndexError, fast lane silent
    garbage)."""
    index_path, _, _ = msa_files
    stripped = {sid: s.replace(b"-", b"") for sid, s in founder_seqs.items()}
    s = stripped["1"]
    lines = ["@HD\tVN:1.6"]
    for sid, fs in stripped.items():
        lines.append(f"@SQ\tSN:test/{sid}\tLN:{len(fs)}")
    lines.append(
        f"bad\t0\ttest/1\t100\t60\t100=\t*\t0\t0\t{s[99:129].decode()}\t{'I' * 30}"
    )
    sam = ("\n".join(lines) + "\n").encode()
    msgs = {}
    for engine in ("host", "device"):
        cfg = ProjectConfig(
            msa_index_path=str(index_path),
            reference_path=str(WORKFLOW / "genome/genome.fa.gz"),
            reference_msa_id="REF",
            ref_id_separator="/",
            engine=engine,
        )
        with pytest.raises(ValueError) as ei:
            run_project_alignments(io.BytesIO(sam), io.BytesIO(), cfg)
        msgs[engine] = str(ei.value)
    assert msgs["host"] == msgs["device"]
    assert "CIGAR consumes 100 query bases but SEQ has 30" in msgs["host"]


@pytest.mark.parametrize("use_quality", [False, True])
def test_fastlane_dp_aggregation_byte_identical(
    msa_files, founder_seqs, tmp_path, monkeypatch, use_quality
):
    """Cross-batch DP aggregation (the writer thread pools the deferred
    realign runs of the in-flight window into one large dispatch) must not
    change a single output byte vs per-batch dispatch.  PANVC3_HOST_DP=0
    forces every batch onto the device lane so the deferral actually
    engages; a tiny window cap exercises mid-stream flushes."""
    index_path, _, _ = msa_files
    sam = _rich_sam(founder_seqs)
    monkeypatch.setenv("PANVC3_HOST_DP", "0")
    kw = dict(use_read_base_qualities=use_quality)

    outs = {}
    # (aggregate, window cap, flush-on-idle floor): the min_runs=1 case
    # forces flush-on-idle dispatches mid-stream (the writer flushes the
    # window whenever the job queue momentarily drains)
    for agg, batches, min_runs in (
        ("0", "16", None), ("1", "16", None), ("1", "2", None),
        ("1", "16", "1"),
    ):
        monkeypatch.setenv("PANVC3_DP_AGGREGATE", agg)
        monkeypatch.setenv("PANVC3_DP_AGG_BATCHES", batches)
        if min_runs is None:
            monkeypatch.delenv("PANVC3_DP_AGG_MIN_RUNS", raising=False)
        else:
            monkeypatch.setenv("PANVC3_DP_AGG_MIN_RUNS", min_runs)
        out, stats, ranges = _run(
            sam, index_path, tmp_path, fastlane=True,
            name=f"agg{agg}_{batches}_{min_runs}_{use_quality}", **kw
        )
        assert stats.realigned_range_count > 0
        outs[(agg, batches, min_runs)] = (out, ranges)
    base = outs[("0", "16", None)]
    assert outs[("1", "16", None)] == base
    assert outs[("1", "2", None)] == base
    assert outs[("1", "16", "1")] == base


@pytest.mark.parametrize("use_quality", [False, True])
def test_fastlane_refgather_wire_byte_identical(
    msa_files, founder_seqs, tmp_path, monkeypatch, use_quality
):
    """The ref-gather aggregate wire (reference rows gathered on device
    from the resident flat reference instead of shipped) must not change a
    single output byte vs the classic staged-row wire — on both scoring
    schemes (-q rides the same wire plus u8 query phreds)."""
    index_path, _, _ = msa_files
    sam = _rich_sam(founder_seqs)
    monkeypatch.setenv("PANVC3_HOST_DP", "0")  # force the device lane
    monkeypatch.setenv("PANVC3_DP_AGGREGATE", "1")
    kw = dict(use_read_base_qualities=use_quality)

    from panvc3_tpu.pipeline.fastlane import AGG_DIAG

    outs = {}
    for rg in ("0", "1"):
        monkeypatch.setenv("PANVC3_DP_REFGATHER", rg)
        before = dict(AGG_DIAG)
        out, stats, ranges = _run(
            sam, index_path, tmp_path, fastlane=True,
            name=f"rg{rg}_{use_quality}", **kw
        )
        assert stats.realigned_range_count > 0
        # the mode under test must actually engage (regression guard: the
        # event-geometry path once skipped flat-ref ingestion and the
        # refgather wire silently never ran)
        if rg == "1":
            assert AGG_DIAG["refgather"] > before["refgather"]
        else:
            assert AGG_DIAG["refgather"] == before["refgather"]
        outs[rg] = (out, ranges)
    assert outs["1"] == outs["0"]


@pytest.mark.parametrize("use_quality", [False, True])
def test_fastlane_wire2_and_sort_byte_identical(
    msa_files, founder_seqs, tmp_path, monkeypatch, use_quality
):
    """The 2-bit query aggregate wire and the length-sorted window layout
    (order restored by inverse permutation at fetch) must not change a
    single output byte vs the 4-bit unsorted dispatch, in any
    combination."""
    index_path, _, _ = msa_files
    sam = _rich_sam(founder_seqs)
    monkeypatch.setenv("PANVC3_HOST_DP", "0")  # force the device lane
    monkeypatch.setenv("PANVC3_DP_AGGREGATE", "1")
    monkeypatch.setenv("PANVC3_DP_REFGATHER", "1")
    kw = dict(use_read_base_qualities=use_quality)

    from panvc3_tpu.pipeline.fastlane import AGG_DIAG

    outs = {}
    for w2, srt in (("0", "0"), ("1", "0"), ("0", "1"), ("1", "1")):
        monkeypatch.setenv("PANVC3_DP_WIRE2", w2)
        monkeypatch.setenv("PANVC3_DP_AGG_SORT", srt)
        before = dict(AGG_DIAG)
        out, stats, ranges = _run(
            sam, index_path, tmp_path, fastlane=True,
            name=f"w2{w2}_s{srt}_{use_quality}", **kw
        )
        assert stats.realigned_range_count > 0
        assert AGG_DIAG["dispatches"] > before["dispatches"]
        if w2 == "1":  # the variant under test must actually engage
            assert AGG_DIAG["wire2"] > before["wire2"]
        else:
            assert AGG_DIAG["wire2"] == before["wire2"]
        if srt == "1":
            assert AGG_DIAG["sorted"] > before["sorted"]
        else:
            assert AGG_DIAG["sorted"] == before["sorted"]
        outs[(w2, srt)] = (out, ranges)
    base = outs[("0", "0")]
    for k, v in outs.items():
        assert v == base, k


def test_fastlane_wire2_ineligible_window_falls_back(
    msa_files, founder_seqs, tmp_path, monkeypatch
):
    """A window containing an N inside a realigned run's query slice is
    wire2-ineligible; the dispatch must fall back to the 4-bit wire and
    still produce identical bytes."""
    index_path, _, _ = msa_files
    sam_lines = _rich_sam(founder_seqs).decode().splitlines()
    # plant an N inside the inserted bases of every indel read so some
    # realigned query slice carries it
    patched = []
    for line in sam_lines:
        if line.startswith("@") or "I" not in line.split("\t")[5]:
            patched.append(line)
            continue
        f = line.split("\t")
        mid = len(f[9]) // 2
        f[9] = f[9][:mid] + "N" + f[9][mid + 1:]
        patched.append("\t".join(f))
    sam = ("\n".join(patched) + "\n").encode()
    monkeypatch.setenv("PANVC3_HOST_DP", "0")
    monkeypatch.setenv("PANVC3_DP_AGGREGATE", "1")
    from panvc3_tpu.pipeline.fastlane import AGG_DIAG

    outs = {}
    for w2 in ("0", "1"):
        monkeypatch.setenv("PANVC3_DP_WIRE2", w2)
        before = dict(AGG_DIAG)
        out, stats, ranges = _run(
            sam, index_path, tmp_path, fastlane=True, name=f"w2N{w2}"
        )
        assert stats.realigned_range_count > 0
        # every window carries an N run -> the 4-bit fallback must engage
        assert AGG_DIAG["wire2"] == before["wire2"]
        outs[w2] = (out, ranges)
    assert outs["1"] == outs["0"]


def test_fastlane_adaptive_lane_byte_identical(
    msa_files, founder_seqs, tmp_path, monkeypatch
):
    """The realign lane choice (host C DP vs device kernel) is adaptive
    when PANVC3_HOST_DP_CELLS is unset; all three modes — adaptive,
    forced-host, forced-device — must produce identical bytes."""
    index_path, _, _ = msa_files
    sam = _rich_sam(founder_seqs)

    outs = {}
    for name, cells in (("adaptive", None), ("device", "0"), ("host", str(10**15))):
        if cells is None:
            monkeypatch.delenv("PANVC3_HOST_DP_CELLS", raising=False)
        else:
            monkeypatch.setenv("PANVC3_HOST_DP_CELLS", cells)
        out, stats, ranges = _run(
            sam, index_path, tmp_path, fastlane=True, name=f"lane_{name}"
        )
        assert stats.realigned_range_count > 0
        outs[name] = (out, ranges)
    assert outs["adaptive"] == outs["host"] == outs["device"]


def test_engine_lane_arbiter(msa_files, founder_seqs, tmp_path, monkeypatch):
    """Runtime fused/split engine arbitration (VERDICT r4 #4): the split
    fast lane whenever the host has cores; the fused single-dispatch
    engine only when host CPU is scarce AND the D2H leg is healthy.
    Forcing fused through the arbiter must not change a byte."""
    import panvc3_tpu.ops.engine as eng
    from panvc3_tpu.ops.engine import choose_engine_lane

    monkeypatch.delenv("PANVC3_ENGINE_LANE", raising=False)
    # on the CPU backend (the test backend) the split lane is always taken
    assert choose_engine_lane(host_cores=1, d2h_mbps=1000.0) == "split"
    # decision logic proper, with the capability helper reporting a GPU
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(eng, "on_accelerator", lambda: True)
        assert choose_engine_lane(host_cores=4) == "split"
        assert choose_engine_lane(host_cores=2, d2h_mbps=1000.0) == "fused"
        assert choose_engine_lane(host_cores=2, d2h_mbps=10.0) == "split"
    # the env override short-circuits before the backend check
    monkeypatch.setenv("PANVC3_ENGINE_LANE", "fused")
    assert choose_engine_lane(host_cores=16) == "fused"
    monkeypatch.delenv("PANVC3_ENGINE_LANE")

    index_path, _, _ = msa_files
    sam = _rich_sam(founder_seqs)
    out_s, stats_s, rng_s = _run(
        sam, index_path, tmp_path, fastlane=True, name="arb_split"
    )
    assert stats_s.realigned_range_count > 0
    monkeypatch.setenv("PANVC3_ENGINE_LANE", "fused")
    out_f, stats_f, rng_f = _run(
        sam, index_path, tmp_path, fastlane=True, name="arb_fused"
    )
    assert (out_f, rng_f) == (out_s, rng_s)


def test_engine_arbiter_not_consulted_when_fused_cannot_engage(
    msa_files, founder_seqs, tmp_path, monkeypatch
):
    """Under -q (and without native) the fused engine gates itself off
    (engine.use_fused), so arbitrating 'fused' there would only disable
    the fast lane and fall through to the slow object path.  The
    arbitration block must not even consult choose_engine_lane in those
    configurations."""
    import panvc3_tpu.ops.engine as eng

    def boom(*a, **kw):  # pragma: no cover - failure path
        raise AssertionError("choose_engine_lane consulted under -q")

    monkeypatch.delenv("PANVC3_ENGINE_LANE", raising=False)
    monkeypatch.setattr(eng, "choose_engine_lane", boom)
    index_path, _, _ = msa_files
    sam = _rich_sam(founder_seqs)
    out_q, stats_q, _ = _run(
        sam, index_path, tmp_path, fastlane=True, name="arb_q",
        use_read_base_qualities=True,
    )
    assert stats_q.matched_reads > 0


def test_fastlane_chaos_scheduling_byte_identical(
    msa_files, founder_seqs, tmp_path, monkeypatch
):
    """Adversarial scheduling soak (VERDICT r4 #7): PANVC3_FASTLANE_CHAOS
    injects random sub-ms sleeps at every cross-thread handoff (pool job
    start/mid, writer drain, aggregate dispatch, fetch completion),
    permuting thread interleavings.  The writer-thread/emit ordering
    invariants must hold under every schedule: output bytes identical to
    the undisturbed run across >=10 seeds, on both the adaptive default
    and the forced-device aggregate path."""
    index_path, _, _ = msa_files
    # 30 batches at the test batch size: enough in-flight concurrency for
    # the jitter to actually permute job completion orders
    sam = _rich_sam(founder_seqs, n_reads=960, seed=29)

    base = {}
    for lane_env in (None, "0"):  # adaptive and forced-device
        if lane_env is None:
            monkeypatch.delenv("PANVC3_HOST_DP_CELLS", raising=False)
        else:
            monkeypatch.setenv("PANVC3_HOST_DP_CELLS", lane_env)
        monkeypatch.delenv("PANVC3_FASTLANE_CHAOS", raising=False)
        out, stats, ranges = _run(
            sam, index_path, tmp_path, fastlane=True, name=f"chaos_base_{lane_env}"
        )
        assert stats.realigned_range_count > 0
        base[lane_env] = (out, ranges)

    for seed in range(1, 11):
        lane_env = None if seed % 2 else "0"
        if lane_env is None:
            monkeypatch.delenv("PANVC3_HOST_DP_CELLS", raising=False)
        else:
            monkeypatch.setenv("PANVC3_HOST_DP_CELLS", lane_env)
        monkeypatch.setenv("PANVC3_FASTLANE_CHAOS", str(seed))
        out, stats, ranges = _run(
            sam, index_path, tmp_path, fastlane=True, name=f"chaos_{seed}"
        )
        assert (out, ranges) == base[lane_env], seed


def test_lane_controller_probe_and_hysteresis():
    """The adaptive LaneController converges to the measured-faster lane
    using span-level throughput (robust to the ordered drain's damming
    bursts), probes the other lane at a bounded duty cycle, and lets the
    raw cost model override only on extreme batches (asymmetrically)."""
    from panvc3_tpu.pipeline.fastlane import LaneController

    c = LaneController()
    # extreme-batch overrides (priors: 4 ns/cell host, 16 ms device);
    # overrides short-circuit before the probe schedule consumes a tick
    c.tick = c.PROBE_LEN  # park outside the probe window
    assert c.decide(100) is True           # trivial: always host
    assert c.decide(200_000_000) is True   # 800 ms host DP < 64x16 ms: mode
    assert c.decide(1_000_000_000) is False  # 4 s host DP: force device


def test_lane_controller_bootstrap_probe():
    """An unmeasured lane must be probed within BOOTSTRAP_PERIOD
    decisions (r4 waited a full PROBE_PERIOD = ~42 batches, so a
    bench-length run could finish entirely on the slow initial mode), and
    a lane's first spans must not grow the probe back-off (the first
    device window may carry a fresh kernel compile)."""
    from panvc3_tpu.pipeline.fastlane import LaneController

    c = LaneController()
    cells = 10_000_000  # mid-band: neither override fires on the priors
    decisions = [c.decide(cells) for _ in range(c.BOOTSTRAP_PERIOD)]
    assert all(decisions[: c.PROBE_LEN])  # settle on the initial mode
    assert False in decisions             # ...then probe dev early

    t = [0]

    def emit(dev_lane, reads, dt_ns):
        t[0] += dt_ns
        c.observe_emit(dev_lane, reads, t[0])

    # host span, then a catastrophically slow dev probe span (compile)
    for _ in range(8):
        emit(False, 100, 1_000_000)
    for _ in range(7):
        emit(True, 100, 50_000_000)
    emit(False, 100, 1_000_000)  # transition closes the dev span
    assert c.span_count["dev"] == 1
    assert c.backoff == 1  # first dev span: no back-off growth
    # a second slow dev span IS allowed to grow the back-off
    for _ in range(7):
        emit(True, 100, 50_000_000)
    emit(False, 100, 1_000_000)
    assert c.span_count["dev"] == 2
    assert c.backoff == 2


def test_lane_controller_schedule_and_switching():
    """Settled-controller behavior (both lanes measured at least
    BOOTSTRAP_SPANS times): periodic probe cadence, span-level lane
    switching with hysteresis, lane-neutral emits, exponential probe
    back-off."""
    from panvc3_tpu.pipeline.fastlane import LaneController

    c = LaneController()
    # settle past the bootstrap cadence: both lanes already measured
    c.span_count = {"host": c.BOOTSTRAP_SPANS, "dev": c.BOOTSTRAP_SPANS}

    # mid-range: starts on host, probes the device lane in consecutive
    # windows of PROBE_LEN
    mid = 8_000_000
    c.tick = 0
    decisions = [c.decide(mid) for _ in range(c.PROBE_PERIOD * 2)]
    assert decisions.count(False) == 2 * c.PROBE_LEN
    assert decisions.count(True) == 2 * (c.PROBE_PERIOD - c.PROBE_LEN)

    # emit spans: device spans measured 2x faster -> mode flips to device.
    # Shapes mimic the drain's damming: the first batch of each span (the
    # dammed head) carries a huge gap, which span accounting excludes.
    t = [0]

    def span(dev, n, ns_per_batch, head_ns=30_000_000):
        t[0] += head_ns  # lane-transition turbulence (excluded)
        c.observe_emit(dev, reads=1000, now_ns=t[0])
        for _ in range(n - 1):
            t[0] += ns_per_batch
            c.observe_emit(dev, reads=1000, now_ns=t[0])

    for _ in range(8):
        span(False, 40, 2_000_000)
        span(True, 6, 1_000_000)
    assert c.ns_read["dev"] < c.ns_read["host"]
    assert c.mode == "dev"
    # the 2x-losing host spans above grew the probe back-off
    # (BACKOFF_LOSS_RATIO) — a clearly-decided race is probed lazily
    assert c.backoff > 1
    c.backoff = 1  # reset to observe the base cadence
    probe_true = [c.decide(mid) for _ in range(c.PROBE_PERIOD)]
    assert probe_true.count(True) == c.PROBE_LEN  # now host is the probe

    # within 10% hysteresis: no flapping back
    for _ in range(8):
        span(True, 40, 1_000_000)
        span(False, 6, 1_050_000)
    assert c.mode == "dev"
    # host clearly faster again -> flips back
    for _ in range(8):
        span(True, 40, 1_000_000)
        span(False, 6, 500_000)
    assert c.mode == "host"

    # lane-neutral batches join the open span but cannot start one
    c.begin_run()
    before = dict(c.ns_read)
    c.observe_emit(True, reads=1000, now_ns=t[0] + 10**9, attribute=False)
    assert c.span_lane is None and c.ns_read == before

    # probes back off exponentially while the probed lane keeps losing
    # badly (>2x) — short -q streams must not burn 12% of batches probing
    # a 4x-slower lane
    c2 = LaneController()
    t2 = [0]

    def span2(dev, n, ns_per_batch):
        t2[0] += 30_000_000
        c2.observe_emit(dev, reads=1000, now_ns=t2[0])
        for _ in range(n - 1):
            t2[0] += ns_per_batch
            c2.observe_emit(dev, reads=1000, now_ns=t2[0])

    for _ in range(4):
        span2(False, 40, 1_000_000)
        span2(True, 6, 5_000_000)  # losing probe: 5x slower
    span2(False, 4, 1_000_000)  # close the final dev span
    assert c2.mode == "host" and c2.backoff >= 8
    c2.tick = 0
    assert not any(not c2.decide(8_000_000) for _ in range(c2.PROBE_PERIOD))


def test_lane_controller_span_artifact_filters():
    """Two measurement artifacts observed on the realign-heavy bench
    (tools/probe_adaptive.py) must not poison the lane EMAs:

    - a FRAGMENT span (fewer than MIN_SPAN_BATCHES counted batches,
      e.g. the same-lane remnant squeezed between a refresh close and
      the next probe window, stalled by aggregate-window fragmentation)
      measured 3x its lane's clean rate — discarded entirely;
    - a DAM-BURST span (an ordered-drain dam clearing emits the whole
      span in near-zero wall time) measured 311 ns/read against a real
      ~5600 — clamped to BURST_FLOOR_FRACTION x the best measured EMA so
      it cannot flip the mode on one bogus sample, while a genuinely
      faster lane still converges over repeated probes."""
    from panvc3_tpu.pipeline.fastlane import LaneController

    c = LaneController()
    t = [0]

    def span(dev, n, ns_per_batch):
        t[0] += 30_000_000
        c.observe_emit(dev, reads=1000, now_ns=t[0])
        for _ in range(n - 1):
            t[0] += ns_per_batch
            c.observe_emit(dev, reads=1000, now_ns=t[0])

    # clean baselines: dev 1 us/batch, host 2 us/batch -> mode=dev
    for _ in range(4):
        span(False, 13, 2_000_000)
        span(True, 13, 1_000_000)
    assert c.mode == "dev"
    dev_ema = c.ns_read["dev"]
    host_ema = c.ns_read["host"]

    # fragment: a 4-batch dev span at 10x the clean rate is discarded
    span(True, 4, 10_000_000)
    span(False, 13, 2_000_000)  # transition closes the fragment
    assert c.ns_read["dev"] == dev_ema

    # dam burst: a host probe span emitting at ~0 wall time must not
    # flip the mode off dev (it previously measured "host 18x faster")
    c.mode = "dev"
    span(True, 13, 1_000_000)
    span(False, 6, 1_000)  # 1 us/batch burst: implies 1 ns/read
    span(True, 13, 1_000_000)
    assert c.mode == "dev"
    # the clamped update can only move host's EMA a bounded step toward
    # the floor: one burst moves it less than a 2x step
    assert c.ns_read["host"] > 0.5 * host_ema

    # a lane that genuinely got much faster still wins after a few
    # repeated (clamped) probe spans
    for _ in range(6):
        span(True, 13, 8_000_000)   # dev degrades to 8 us/batch
        span(False, 6, 100_000)     # host now truly 100 ns/read
    assert c.mode == "host"

    # a lane's FIRST span measuring below the burst floor ADOPTS the
    # floor (it is not discarded): a genuinely-4x-faster lane measures
    # below the floor legitimately, and discarding would deadlock
    # bootstrap with the controller locked on the slow lane (measured:
    # 135k reads/s all-host vs 205k with the dev lane engaged)
    c2 = LaneController()
    t2 = [0]

    def span_c2(dev, n, ns_per_batch):
        t2[0] += 30_000_000
        c2.observe_emit(dev, reads=1000, now_ns=t2[0])
        for _ in range(n - 1):
            t2[0] += ns_per_batch
            c2.observe_emit(dev, reads=1000, now_ns=t2[0])

    span_c2(False, 13, 2_000_000)   # host baseline
    span_c2(True, 6, 1_000)         # first dev evidence: floor-fast
    span_c2(False, 13, 2_000_000)
    host_ema2 = c2.ns_read["host"]
    assert c2.ns_read["dev"] == pytest.approx(
        c2.BURST_FLOOR_FRACTION * host_ema2, rel=0.35
    )
    assert c2.mode == "dev"  # flipped — correct when genuinely faster

    # ...but a lane whose spans are ALWAYS fragmented (trivial
    # override-routed batches interleaving every few heavy ones) must not
    # freeze: after 3 consecutive discards, >=2-batch fragments are
    # accepted so the EMAs keep tracking reality
    c3 = LaneController()
    t3 = [0]

    def span_c3(dev, n, ns_per_batch):
        t3[0] += 30_000_000
        c3.observe_emit(dev, reads=1000, now_ns=t3[0])
        for _ in range(n - 1):
            t3[0] += ns_per_batch
            c3.observe_emit(dev, reads=1000, now_ns=t3[0])

    for _ in range(6):              # dev fragments interleaved with host
        span_c3(False, 13, 2_000_000)
        span_c3(True, 3, 1_000_000)
    assert c3.ns_read["dev"] is not None  # escape hatch recorded one


def test_lane_controller_regime_reset():
    """ns/read EMAs are only comparable within one workload regime: a
    mixed-workload host span (~30k cells/batch, fast per read) says
    nothing about the host lane on a realign-heavy stream (~20M
    cells/batch).  When cells/read shifts >4x for two consecutive
    batches the controller resets to a fresh bootstrap; a single outlier
    batch does not reset."""
    from panvc3_tpu.pipeline.fastlane import LaneController

    c = LaneController()
    t = [0]

    def emit(dev, reads, dt_ns, cells):
        t[0] += dt_ns
        c.observe_emit(dev, reads, t[0], cells=cells)

    # mixed regime: 4 cells/read, host spans at 1.3 us/read
    for _ in range(14):
        emit(False, 8192, 11_000_000, 8192 * 4)
    assert c.ns_read["host"] is not None
    mixed_host = c.ns_read["host"]

    # one outlier heavy batch: no reset
    emit(False, 8192, 48_000_000, 8192 * 2400)
    assert c.ns_read["host"] is not None

    # back in band, then a real heavy phase: two consecutive heavy
    # batches reset the EMAs and the bootstrap re-measures
    emit(False, 8192, 11_000_000, 8192 * 4)
    emit(False, 8192, 48_000_000, 8192 * 2400)
    emit(False, 8192, 48_000_000, 8192 * 2400)
    assert c.ns_read == {"host": None, "dev": None}
    assert c.span_count == {"host": 0, "dev": 0}
    # the heavy regime's own spans then record cleanly
    for _ in range(14):
        emit(False, 8192, 48_000_000, 8192 * 2400)
    assert c.ns_read["host"] is not None
    assert c.ns_read["host"] > 3 * mixed_host

    # an OSCILLATING bimodal stream must not re-bootstrap forever: at
    # most one reset per cooldown window; during cooldown the regime EMA
    # blends fast, re-centring mid-band so spans keep recording
    c2 = LaneController()
    t2 = [0]

    def emit2(dev, reads, dt_ns, cells):
        t2[0] += dt_ns
        c2.observe_emit(dev, reads, t2[0], cells=cells)

    for _ in range(10):  # alternating 4-batch blocks, 100 <-> 1000 c/r
        for _ in range(4):
            emit2(False, 8192, 11_000_000, 8192 * 100)
        for _ in range(4):
            emit2(False, 8192, 30_000_000, 8192 * 1000)
    # after the single allowed reset + blending, spans record again
    assert c2.ns_read["host"] is not None


def test_lane_controller_graduated_duty(monkeypatch):
    """PANVC3_LANE_MIX=1 (opt-in): near-parity lanes
    alternate PROBE_LEN spans 50/50, a clear winner (>1.5x) keeps the
    rare-probe cadence, and the default leaves mixing off."""
    from panvc3_tpu.pipeline.fastlane import LaneController

    def settled(h_ns, d_ns):
        c = LaneController()
        c.span_count = {"host": 2, "dev": 2}
        c.ns_read = {"host": h_ns, "dev": d_ns}
        return c

    mid = 8_000_000
    monkeypatch.setenv("PANVC3_LANE_MIX", "1")  # opt-in
    c = settled(1000.0, 950.0)  # near parity
    dec = [c.decide(mid) for _ in range(48)]
    assert dec.count(False) == 24  # 50/50 alternation
    c = settled(1000.0, 500.0)  # clear winner
    c.mode = "dev"
    dec = [c.decide(mid) for _ in range(c.PROBE_PERIOD)]
    assert dec.count(True) == c.PROBE_LEN  # rare probes only
    monkeypatch.delenv("PANVC3_LANE_MIX", raising=False)
    c = settled(1000.0, 950.0)
    dec = [c.decide(mid) for _ in range(c.PROBE_PERIOD)]
    assert dec.count(False) == c.PROBE_LEN  # default: rare probes only


def test_lane_controller_active_lane_degradation():
    """A controller locked on one lane must notice that lane DEGRADING
    without waiting for a (possibly backed-off) probe of the other lane:
    long same-lane spans periodically close + restart so the active
    lane's ns/read EMA stays fresh and the cross-lane switch check runs.
    Regression: a transient slowdown left the device lane chosen at 97k
    reads/s while the host lane ran 162k in the same bench window."""
    from panvc3_tpu.pipeline.fastlane import LaneController

    c = LaneController()
    t = [0]

    def span(dev, n, ns_per_batch):
        t[0] += 30_000_000
        c.observe_emit(dev, reads=1000, now_ns=t[0])
        for _ in range(n - 1):
            t[0] += ns_per_batch
            c.observe_emit(dev, reads=1000, now_ns=t[0])

    # converge to the device lane (2x faster), with a measured host EMA
    for _ in range(8):
        span(False, 14, 2_000_000)
        span(True, 14, 1_000_000)
    assert c.mode == "dev"
    # probes back off hard (simulate: the probe schedule is not the test)
    c.backoff = c.BACKOFF_MAX
    # the device lane degrades 4x while it stays the only emitting lane —
    # ONE long span, no host probes, no lane transitions
    span(True, 100, 4_000_000)
    assert c.mode == "host", (
        "active-lane degradation must flip the mode without a probe"
    )


def test_aggregate_pad_ladder_invariants():
    """The {p,1.5p} pad ladders must satisfy the aggregate wire's
    constraints for every reachable value: R/Q buckets divisible by 4
    (4-bit query packing needs even Q; 2-bit op packing needs
    (R+Q) % 4 == 0 for ANY R/Q combination), monotone, >= n, and within
    1.5x of n (the padding-waste bound the ladder exists to provide)."""
    from panvc3_tpu.pipeline.fastlane import _next_row_bucket, _next_rq_bucket

    prev = 0
    for n in range(1, 4097):
        b = _next_rq_bucket(n)
        assert b >= max(n, 8)
        assert b % 4 == 0, (n, b)
        assert b <= max(8, ((n * 3) + 1) // 2), (n, b)  # <=1.5x waste
        assert b >= prev
        prev = b
        r = _next_row_bucket(n)
        assert r >= n
        assert r <= max(1, (n * 3 + 1) // 2)
    # any two ladder values sum to a multiple of 4 (steps = R + Q)
    vals = sorted({_next_rq_bucket(n) for n in range(1, 4097)})
    for a in vals:
        for c in vals:
            assert (a + c) % 4 == 0, (a, c)
