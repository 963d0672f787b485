"""The device engine must produce byte-identical output to the host path."""

import io
import pathlib

import numpy as np
import pytest

from panvc3_tpu.pipeline.project_alignments import ProjectConfig, TagSpec, run_project_alignments

from .test_workflow_data import WORKFLOW, founder_seqs, msa_files  # fixtures

pytestmark = pytest.mark.skipif(not WORKFLOW.exists(), reason="toy data absent")


def _synthesise_indel_sam(founder_seqs, n_reads=120, read_len=100, seed=7) -> bytes:
    """Reads sampled from founders, some with extra indels in the CIGAR, so
    that projection produces I+D runs that trigger realignment."""
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
            # deletion in the middle
            k = int(rng.integers(1, 6))
            half = read_len // 2
            seq = s[pos:pos + half] + s[pos + half + k:pos + half + k + (read_len - half)]
            cigar = f"{half}={k}D{read_len - half}="
        else:
            # adjacent insertion+deletion in the middle -> an I+D run that
            # the projector realigns
            k = int(rng.integers(1, 6))
            j = int(rng.integers(1, 6))
            half = read_len // 2
            ins = rng.choice(np.frombuffer(b"ACGT", dtype=np.uint8), k).tobytes()
            seq = (
                s[pos:pos + half]
                + ins
                + s[pos + half + j:pos + half + j + (read_len - half - k)]
            )
            cigar = f"{half}={k}I{j}D{read_len - half - k}="
        q = seq.decode()
        qual = "".join(chr(33 + int(x)) for x in rng.integers(20, 42, len(q)))
        flag = 0 if i % 2 == 0 else 16
        lines.append(
            f"read{i}\t{flag}\ttest/{sid}\t{pos + 1}\t60\t{cigar}\t*\t0\t0\t{q}\t{qual}\tNM:i:0"
        )
    return ("\n".join(lines) + "\n").encode()


@pytest.mark.parametrize("use_quality", [False, True])
def test_device_engine_matches_host(msa_files, founder_seqs, use_quality):
    index_path, _, _ = msa_files
    sam = _synthesise_indel_sam(founder_seqs)

    outs = {}
    stats = {}
    for engine, fused in (("host", False), ("device", False), ("device", True)):
        cfg = ProjectConfig(
            msa_index_path=str(index_path),
            reference_path=str(WORKFLOW / "genome/genome.fa.gz"),
            reference_msa_id="REF",
            ref_id_separator="/",
            tags=TagSpec(rec_idx="XI"),
            use_read_base_qualities=use_quality,
            engine=engine,
            device_batch_size=64,
            fused_kernel=fused,
        )
        engine = f"{engine}-fused" if fused else engine
        out = io.BytesIO()
        stats[engine] = run_project_alignments(io.BytesIO(sam), out, cfg)
        outs[engine] = out.getvalue()

    assert stats["host"].matched_reads == stats["device"].matched_reads
    assert stats["host"].realigned_range_count > 0  # realignment exercised
    # both schemes are exact on device (integer hamming; quantised Malde,
    # align.MALDE_SHIFT): host and device engines must agree byte-for-byte
    assert outs["host"] == outs["device"]


def test_engine_python_fallback_matches_native(msa_files, founder_seqs, monkeypatch):
    """The numpy fallback path must produce the same output as the native
    finalize path."""
    import panvc3_tpu.ops.engine as eng

    index_path, _, _ = msa_files
    sam = _synthesise_indel_sam(founder_seqs, n_reads=60)

    outs = {}
    for use_native in (True, False):
        if not use_native:
            monkeypatch.setattr(eng, "get_native", lambda: None)
        cfg = ProjectConfig(
            msa_index_path=str(index_path),
            reference_path=str(WORKFLOW / "genome/genome.fa.gz"),
            reference_msa_id="REF",
            ref_id_separator="/",
            engine="device",
            device_batch_size=64,
        )
        out = io.BytesIO()
        run_project_alignments(io.BytesIO(sam), out, cfg)
        outs[use_native] = out.getvalue()
    assert outs[True] == outs[False]


def test_engine_data_parallel_mesh(msa_files, founder_seqs):
    """dp-sharded execution over the virtual 8-device CPU mesh must be
    byte-identical to single-device execution."""
    index_path, _, _ = msa_files
    sam = _synthesise_indel_sam(founder_seqs, n_reads=90)  # not divisible by 8

    outs = {}
    for dp in (0, -1):
        cfg = ProjectConfig(
            msa_index_path=str(index_path),
            reference_path=str(WORKFLOW / "genome/genome.fa.gz"),
            reference_msa_id="REF",
            ref_id_separator="/",
            engine="device",
            device_batch_size=64,
            data_parallel=dp,
        )
        out = io.BytesIO()
        run_project_alignments(io.BytesIO(sam), out, cfg)
        outs[dp] = out.getvalue()
    assert outs[0] == outs[-1]


def test_engine_data_parallel_mesh_fused_v4(msa_files, founder_seqs, monkeypatch):
    """The fused-v4 (event-geometry) kernel sharded over the virtual
    8-device CPU mesh must be byte-identical to single-device execution —
    both fused and split.  Covers the mesh padding with empty records
    (90 reads is not divisible by 8) and the replicated event tables /
    flat reference (VERDICT r3 #3: the multichip path must exercise the
    production fused-v4 wire, not just the legacy split kernel).  Spies
    assert the fused runs really used the device DP — without them a
    broken mesh path could silently divert to the host realign fallback
    (or the gap-math redispatch) and still byte-match."""
    import panvc3_tpu.ops.engine as eng

    index_path, _, _ = msa_files
    sam = _synthesise_indel_sam(founder_seqs, n_reads=90)
    # toy MSA-expanded runs exceed the production run pad of 16; raise it
    # so the fused runs engage the device DP, not the host fallback
    monkeypatch.setattr(eng.BatchProjector, "FUSED_RUN_PAD", 64)

    calls = {"host_realign": 0, "gap_redispatch": 0}
    orig_rs = eng.BatchProjector._realign_and_splice
    orig_fg = eng.BatchProjector._dispatch_fused_gap

    def spy_rs(self, *a, **kw):
        calls["host_realign"] += 1
        return orig_rs(self, *a, **kw)

    def spy_fg(self, *a, **kw):
        calls["gap_redispatch"] += 1
        return orig_fg(self, *a, **kw)

    outs = {}
    for name, dp, fused in (
        ("single_split", 0, False),
        ("single_fused", 0, True),
        ("mesh_fused", -1, True),
    ):
        if fused:
            monkeypatch.setattr(
                eng.BatchProjector, "_realign_and_splice", spy_rs
            )
            monkeypatch.setattr(
                eng.BatchProjector, "_dispatch_fused_gap", spy_fg
            )
        cfg = ProjectConfig(
            msa_index_path=str(index_path),
            reference_path=str(WORKFLOW / "genome/genome.fa.gz"),
            reference_msa_id="REF",
            ref_id_separator="/",
            engine="device",
            device_batch_size=64,
            data_parallel=dp,
            fused_kernel=fused,
        )
        out = io.BytesIO()
        run_project_alignments(io.BytesIO(sam), out, cfg)
        outs[name] = out.getvalue()
    assert calls == {"host_realign": 0, "gap_redispatch": 0}
    assert outs["mesh_fused"] == outs["single_fused"] == outs["single_split"]


def test_fused_overflow_fallback(msa_files, founder_seqs):
    """Records exceeding the fused kernel's run buckets (many runs / long
    runs) must fall back to the split path and still match the host."""
    import numpy as np

    index_path, _, _ = msa_files
    stripped = {sid: s.replace(b"-", b"") for sid, s in founder_seqs.items()}
    s = stripped["1"]
    lines = ["@HD\tVN:1.6"]
    for sid, fs in stripped.items():
        lines.append(f"@SQ\tSN:test/{sid}\tLN:{len(fs)}")
    rng = np.random.default_rng(3)

    # read with 12 adjacent I+D runs (> FUSED_MAX_RUNS)
    pos = 500
    parts = []
    cig = []
    p = pos
    for k in range(12):
        parts.append(s[p:p + 5])
        cig.append("5=")
        ins = rng.choice(np.frombuffer(b"ACGT", dtype=np.uint8), 2).tobytes()
        parts.append(ins)
        cig.append("2I2D")
        p += 7
    seq1 = b"".join(parts).decode()
    cigar1 = "".join(cig)
    lines.append(f"many\t0\ttest/1\t{pos + 1}\t60\t{cigar1}\t*\t0\t0\t{seq1}\t{'I' * len(seq1)}")

    # read with one very long run (> FUSED_RUN_PAD)
    pos2 = 2000
    ins2 = rng.choice(np.frombuffer(b"ACGT", dtype=np.uint8), 40).tobytes()
    seq2 = (s[pos2:pos2 + 20] + ins2 + s[pos2 + 60:pos2 + 80]).decode()
    cigar2 = "20=40I40D20="
    lines.append(f"long\t0\ttest/1\t{pos2 + 1}\t60\t{cigar2}\t*\t0\t0\t{seq2}\t{'I' * len(seq2)}")

    sam = ("\n".join(lines) + "\n").encode()
    outs = {}
    for engine in ("host", "device"):
        cfg = ProjectConfig(
            msa_index_path=str(index_path),
            reference_path=str(WORKFLOW / "genome/genome.fa.gz"),
            reference_msa_id="REF",
            ref_id_separator="/",
            engine=engine,
        )
        out = io.BytesIO()
        stats = run_project_alignments(io.BytesIO(sam), out, cfg)
        assert stats.matched_reads == 2
        outs[engine] = out.getvalue()
    assert outs["host"] == outs["device"]


@pytest.mark.parametrize("depth", [1, 3, 5])
def test_pipeline_depth_output_invariant(msa_files, founder_seqs, depth):
    """The three-stage drain (start / finish_rewrite / finish_realign)
    must emit identical bytes at any pipeline depth, including the
    degenerate synchronous depth=1 and depths larger than the batch
    count."""
    index_path, _, _ = msa_files
    sam = _synthesise_indel_sam(founder_seqs)

    outs = {}
    for d in (2, depth):
        cfg = ProjectConfig(
            msa_index_path=str(index_path),
            reference_path=str(WORKFLOW / "genome/genome.fa.gz"),
            reference_msa_id="REF",
            ref_id_separator="/",
            tags=TagSpec(rec_idx="XI"),
            engine="device",
            device_batch_size=32,
            pipeline_depth=d,
        )
        out = io.BytesIO()
        run_project_alignments(io.BytesIO(sam), out, cfg)
        outs[d] = out.getvalue()
    assert outs[2] == outs[depth]


def test_threaded_pipeline_output_invariant(msa_files, founder_seqs):
    """The worker-thread drain must emit bytes identical to the inline
    drain (same engine, same batches, order preserved by the FIFO)."""
    index_path, _, _ = msa_files
    sam = _synthesise_indel_sam(founder_seqs)

    outs = {}
    stats = {}
    for threaded in (True, False):
        cfg = ProjectConfig(
            msa_index_path=str(index_path),
            reference_path=str(WORKFLOW / "genome/genome.fa.gz"),
            reference_msa_id="REF",
            ref_id_separator="/",
            tags=TagSpec(rec_idx="XI"),
            engine="device",
            device_batch_size=32,
            threaded_pipeline=threaded,
        )
        out = io.BytesIO()
        stats[threaded] = run_project_alignments(io.BytesIO(sam), out, cfg)
        outs[threaded] = out.getvalue()
    assert outs[True] == outs[False]
    assert (
        stats[True].realigned_range_count == stats[False].realigned_range_count
    )
    assert stats[True].matched_reads == stats[False].matched_reads


def test_realigned_ranges_tsv_and_observability(msa_files, founder_seqs, tmp_path):
    """--debugging-output adds QNAME (and with --keep-duplicate-ranges the
    Task id) columns to the ranges TSV (project_alignments.cc:489-503,
    1009-1029), and the realignment observability counters are filled."""
    index_path, _, _ = msa_files
    sam = _synthesise_indel_sam(founder_seqs, n_reads=60)

    variants = {}
    for engine in ("host", "device"):
        for keep, dbg in ((False, False), (False, True), (True, True), (True, False)):
            path = tmp_path / f"r_{engine}_{keep}_{dbg}.tsv"
            cfg = ProjectConfig(
                msa_index_path=str(index_path),
                reference_path=str(WORKFLOW / "genome/genome.fa.gz"),
                reference_msa_id="REF",
                ref_id_separator="/",
                engine=engine,
                device_batch_size=16,
                output_realigned_ranges_path=str(path),
                keep_duplicate_ranges=keep,
                debugging_output=dbg,
            )
            stats = run_project_alignments(io.BytesIO(sam), io.BytesIO(), cfg)
            variants[(engine, keep, dbg)] = path.read_text()

            assert stats.realigned_range_count > 0
            # observability parity fields (project_alignments.cc:931-944)
            assert stats.realignment_time_ns > 0
            assert stats.realigned_range_total_length >= stats.realigned_range_count
            if keep:
                assert stats.written_range_count is None
            else:
                assert stats.written_range_count == len(
                    variants[(engine, keep, dbg)].splitlines()
                ) - 1

    # header shapes
    assert variants[("host", False, False)].startswith("Location\tLength\n")
    assert variants[("host", False, True)].startswith("Location\tLength\tQNAME\n")
    assert variants[("host", True, True)].startswith("Location\tLength\tTask\tQNAME\n")
    assert variants[("host", True, False)].startswith("Location\tLength\n")

    for key, text in variants.items():
        engine, keep, dbg = key
        rows = [l.split("\t") for l in text.splitlines()[1:]]
        if keep and dbg:
            assert all(len(r) == 4 for r in rows)
            # task ids: positive, non-decreasing in output order
            tids = [int(r[2]) for r in rows]
            assert all(t >= 1 for t in tids)
            assert tids == sorted(tids)
            assert all(r[3].startswith("read") for r in rows)
        elif dbg:
            assert all(len(r) == 3 for r in rows)
            # deduplicated and sorted by range
            keys = [(int(r[0]), int(r[1])) for r in rows]
            assert keys == sorted(set(keys))
        else:
            assert all(len(r) == 2 for r in rows)

    # host and device engines agree on every variant
    for keep, dbg in ((False, False), (False, True), (True, True), (True, False)):
        assert variants[("host", keep, dbg)] == variants[("device", keep, dbg)]


def test_long_read_equality(msa_files, founder_seqs):
    """Multi-kb reads (beyond the standard fast-lane buckets) must project
    byte-identically through host and device engines, including realigned
    I+D runs."""
    index_path, _, _ = msa_files
    stripped = {sid: s.replace(b"-", b"") for sid, s in founder_seqs.items()}
    rng = np.random.default_rng(5)
    lines = ["@HD\tVN:1.6"]
    for sid, s in stripped.items():
        lines.append(f"@SQ\tSN:test/{sid}\tLN:{len(s)}")
    names = [s for s in stripped if s != "REF"]
    READ = 4000
    n = 0
    for i in range(16):
        sid = names[int(rng.integers(len(names)))]
        s = stripped[sid]
        if len(s) < READ + 100:
            continue
        pos = int(rng.integers(0, len(s) - READ - 60))
        k = int(rng.integers(1, 8))
        j = int(rng.integers(1, 8))
        half = READ // 2
        ins = rng.choice(np.frombuffer(b"ACGT", dtype=np.uint8), k).tobytes()
        seq = s[pos:pos + half] + ins + s[pos + half + j:pos + half + j + (READ - half - k)]
        cigar = f"{half}={k}I{j}D{READ - half - k}="
        q = seq.decode()
        qual = "".join(chr(33 + int(x)) for x in rng.integers(20, 42, len(q)))
        lines.append(
            f"lr{i}\t0\ttest/{sid}\t{pos + 1}\t60\t{cigar}\t*\t0\t0\t{q}\t{qual}"
        )
        n += 1
    assert n >= 8
    sam = ("\n".join(lines) + "\n").encode()

    outs = {}
    for engine in ("host", "device"):
        cfg = ProjectConfig(
            msa_index_path=str(index_path),
            reference_path=str(WORKFLOW / "genome/genome.fa.gz"),
            reference_msa_id="REF",
            ref_id_separator="/",
            tags=TagSpec(rec_idx="XI"),
            engine=engine,
            device_batch_size=16,
        )
        out = io.BytesIO()
        stats = run_project_alignments(io.BytesIO(sam), out, cfg)
        assert stats.matched_reads == n
        assert stats.realigned_range_count > 0
        outs[engine] = out.getvalue()
    assert outs["host"] == outs["device"]


@pytest.mark.skipif(
    __import__("panvc3_tpu.native", fromlist=["get_native"]).get_native() is None,
    reason="event fast lane needs the native extension (without it the "
    "classic engine legitimately uses the gap-kernel tables)",
)
def test_device_gap_tables_lazy(msa_files, founder_seqs):
    """The default event-geometry run must never build the HBM gap-index
    tables (O(columns) build time + memory — genome-scale cold-start
    regression guard); they exist for the gap-kernel path and the
    event-overflow fallback only."""
    import panvc3_tpu.ops.engine as eng

    index_path, _, _ = msa_files
    sam = _synthesise_indel_sam(founder_seqs, n_reads=40)

    built = []
    orig = eng.DeviceGapIndex.build

    def spy(vectors):
        built.append(len(vectors))
        return orig(vectors)

    eng.DeviceGapIndex.build = staticmethod(spy)
    try:
        cfg = ProjectConfig(
            msa_index_path=str(index_path),
            reference_path=str(WORKFLOW / "genome/genome.fa.gz"),
            reference_msa_id="REF",
            ref_id_separator="/",
            engine="device",
            device_batch_size=32,
        )
        out = io.BytesIO()
        stats = run_project_alignments(io.BytesIO(sam), out, cfg)
        assert stats.matched_reads == 40
    finally:
        eng.DeviceGapIndex.build = orig
    assert built == [], "gap-index tables were built on the event path"


def test_fused_event_matches_gap_variant(msa_files, founder_seqs, monkeypatch):
    """The fused v4 kernel (event-geometry rewrite + segment-space run
    detection, ops/fused_event.py) must be byte-identical to the v3
    gap-math variant, with the no-fallback device path actually engaged."""
    import panvc3_tpu.ops.engine as eng

    index_path, _, _ = msa_files
    sam = _synthesise_indel_sam(founder_seqs, n_reads=120)
    # the toy data's MSA-expanded runs exceed the production run pad of 16;
    # raise it so the device DP path (not the host fallback) is compared
    monkeypatch.setattr(eng.BatchProjector, "FUSED_RUN_PAD", 64)

    calls = {"host_realign": 0}
    orig_rs = eng.BatchProjector._realign_and_splice

    def spy_rs(self, *a, **kw):
        calls["host_realign"] += 1
        return orig_rs(self, *a, **kw)

    monkeypatch.setattr(eng.BatchProjector, "_realign_and_splice", spy_rs)

    outs = {}
    for ev in ("1", "0"):
        monkeypatch.setenv("PANVC3_FUSED_EVENT", ev)
        cfg = ProjectConfig(
            msa_index_path=str(index_path),
            reference_path=str(WORKFLOW / "genome/genome.fa.gz"),
            reference_msa_id="REF",
            ref_id_separator="/",
            engine="device",
            device_batch_size=64,
            fused_kernel=True,
        )
        out = io.BytesIO()
        stats = run_project_alignments(io.BytesIO(sam), out, cfg)
        assert stats.realigned_range_count > 0
        outs[ev] = out.getvalue()
    assert calls["host_realign"] == 0  # device DP results were used
    assert outs["1"] == outs["0"]


@pytest.mark.skipif(
    __import__("panvc3_tpu.native", fromlist=["get_native"]).get_native() is None,
    reason="the fused engine requires the native extension (use_fused gate)",
)
def test_fused_event_overflow_redispatches_gap_variant(tmp_path, monkeypatch):
    """A record overlapping more gap events than the event kernel's slots
    must re-dispatch through the gap-math fused variant (the rewrite
    outputs themselves are invalid on event overflow) and still match the
    host engine byte for byte."""
    from panvc3_tpu.bitvec import GapBitVector
    from panvc3_tpu.msa_index import ChrEntry, MsaIndex, SequenceEntry
    import panvc3_tpu.ops.engine as eng

    rng = np.random.default_rng(9)
    n_cols = 1024
    base = rng.choice(np.frombuffer(b"ACGT", dtype=np.uint8), n_cols)
    ref_aligned = base.copy()
    ref_aligned[7::8] = ord("-")  # a dst gap run every 8 columns
    founder_aligned = base.copy()

    index = MsaIndex()
    ce = ChrEntry("test")
    ce.sequence_entries = sorted(
        [
            SequenceEntry("REF", GapBitVector.from_gap_string(ref_aligned.tobytes())),
            SequenceEntry("1", GapBitVector.from_gap_string(founder_aligned.tobytes())),
        ],
        key=lambda e: e.seq_id,
    )
    index.chr_entries.append(ce)
    index.sort()
    index_path = tmp_path / "msa.npz"
    index.save(str(index_path))
    ref_seq = ref_aligned.tobytes().replace(b"-", b"")
    ref_path = tmp_path / "ref.fa"
    ref_path.write_bytes(b">test\n" + ref_seq + b"\n")

    founder = founder_aligned.tobytes()
    lines = ["@HD\tVN:1.6", f"@SQ\tSN:test/1\tLN:{len(founder)}"]
    # 100bp reads overlap ~12 gap events > GAP_SLOTS=8 -> event overflow;
    # add an indel so realignment runs exist on the re-dispatched path
    for i, pos in enumerate((10, 200, 400)):
        seq = (founder[pos:pos + 50] + b"AC" + founder[pos + 53:pos + 103]).decode()
        cig = "50=2I3D50="
        lines.append(
            f"r{i}\t0\ttest/1\t{pos + 1}\t60\t{cig}\t*\t0\t0\t{seq}\t{'I' * len(seq)}"
        )
    sam = ("\n".join(lines) + "\n").encode()

    calls = {"gap": 0}
    orig_fg = eng.BatchProjector._dispatch_fused_gap

    def spy_fg(self, batch, n):
        calls["gap"] += 1
        return orig_fg(self, batch, n)

    monkeypatch.setattr(eng.BatchProjector, "_dispatch_fused_gap", spy_fg)
    monkeypatch.setattr(eng.BatchProjector, "FUSED_RUN_PAD", 64)

    outs = {}
    for engine, fused in (("host", False), ("device", True)):
        cfg = ProjectConfig(
            msa_index_path=str(index_path),
            reference_path=str(ref_path),
            reference_msa_id="REF",
            ref_id_separator="/",
            engine=engine,
            device_batch_size=64,
            fused_kernel=fused,
        )
        out = io.BytesIO()
        stats = run_project_alignments(io.BytesIO(sam), out, cfg)
        assert stats.matched_reads == 3
        outs[engine] = out.getvalue()
    assert calls["gap"] >= 1  # the event overflow re-dispatch fired
    assert outs["host"] == outs["device"]


def test_fused_event_clip_and_passthrough_ops(msa_files, founder_seqs, monkeypatch):
    """Fused v4's segment machinery must handle pass-through ops (S/H/P/I)
    interleaved with ref ops — clips around indel runs, hard clips at the
    edges, padding ops mid-run — byte-identically to the host engine."""
    import panvc3_tpu.ops.engine as eng

    index_path, _, _ = msa_files
    stripped = {sid: s.replace(b"-", b"") for sid, s in founder_seqs.items()}
    rng = np.random.default_rng(31)
    lines = ["@HD\tVN:1.6"]
    for sid, fs in stripped.items():
        lines.append(f"@SQ\tSN:test/{sid}\tLN:{len(fs)}")
    names = [s for s in stripped if s != "REF"]
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    for i in range(80):
        sid = names[int(rng.integers(len(names)))]
        s = stripped[sid]
        pos = int(rng.integers(0, len(s) - 160))
        kind = i % 5
        if kind == 0:  # soft clips both ends around an I+D run
            sc1, sc2 = int(rng.integers(1, 8)), int(rng.integers(1, 8))
            clip1 = rng.choice(bases, sc1).tobytes()
            clip2 = rng.choice(bases, sc2).tobytes()
            ins = rng.choice(bases, 3).tobytes()
            seq = clip1 + s[pos:pos + 30] + ins + s[pos + 33:pos + 63] + clip2
            cigar = f"{sc1}S30=3I3D30={sc2}S"
        elif kind == 1:  # hard clips (consume nothing)
            ins = rng.choice(bases, 2).tobytes()
            seq = s[pos:pos + 25] + ins + s[pos + 29:pos + 54]
            cigar = "4H25=2I4D25=6H"
        elif kind == 2:  # padding op inside the indel run (P breaks runs)
            ins = rng.choice(bases, 2).tobytes()
            seq = s[pos:pos + 25] + ins + s[pos + 27:pos + 52]
            cigar = "25=2I1P2D25="
        elif kind == 3:  # leading soft clip + pure match
            sc = int(rng.integers(1, 10))
            clip = rng.choice(bases, sc).tobytes()
            seq = clip + s[pos:pos + 60]
            cigar = f"{sc}S60="
        else:  # two separate runs in one read
            ins1 = rng.choice(bases, 2).tobytes()
            ins2 = rng.choice(bases, 3).tobytes()
            seq = (
                s[pos:pos + 20] + ins1 + s[pos + 22:pos + 42]
                + ins2 + s[pos + 46:pos + 66]
            )
            cigar = "20=2I2D20=3I4D20="
        q = seq.decode()
        qual = "I" * len(q)
        lines.append(
            f"c{i}\t0\ttest/{sid}\t{pos + 1}\t60\t{cigar}\t*\t0\t0\t{q}\t{qual}"
        )
    sam = ("\n".join(lines) + "\n").encode()

    monkeypatch.setattr(eng.BatchProjector, "FUSED_RUN_PAD", 64)
    outs = {}
    for engine, fused in (("host", False), ("device", True)):
        cfg = ProjectConfig(
            msa_index_path=str(index_path),
            reference_path=str(WORKFLOW / "genome/genome.fa.gz"),
            reference_msa_id="REF",
            ref_id_separator="/",
            engine=engine,
            device_batch_size=32,
            fused_kernel=fused,
        )
        out = io.BytesIO()
        stats = run_project_alignments(io.BytesIO(sam), out, cfg)
        assert stats.matched_reads == 80
        outs[engine] = out.getvalue()
    assert outs["host"] == outs["device"]


def test_fused_event_zero_width_boundary_on_passthrough_op(tmp_path, monkeypatch):
    """Regression (ADVICE r3): a dst-gap run ending exactly at the ref rank
    immediately preceding a pass-through op (I, or a trailing S) creates a
    zero-length segment owned by that op; fused v4 must NOT emit the op
    twice there (it used to emit seg_cnt ungated by segment width, shifting
    every downstream query/run coordinate and corrupting the CIGAR)."""
    from panvc3_tpu.bitvec import GapBitVector
    from panvc3_tpu.msa_index import ChrEntry, MsaIndex, SequenceEntry
    import panvc3_tpu.ops.engine as eng

    rng = np.random.default_rng(17)
    n_cols = 512
    base = rng.choice(np.frombuffer(b"ACGT", dtype=np.uint8), n_cols)
    founder_aligned = base.copy()
    ref_aligned = base.copy()
    # dst-gap runs covering exactly the leading 2= of reads r0/r1 (so the
    # gap-off boundary lands on the I op's unit position) and the last two
    # ref units before r2's trailing soft clip
    for a, b_ in ((10, 12), (100, 102), (218, 220)):
        ref_aligned[a:b_] = ord("-")

    index = MsaIndex()
    ce = ChrEntry("test")
    ce.sequence_entries = sorted(
        [
            SequenceEntry("REF", GapBitVector.from_gap_string(ref_aligned.tobytes())),
            SequenceEntry("1", GapBitVector.from_gap_string(founder_aligned.tobytes())),
        ],
        key=lambda e: e.seq_id,
    )
    index.chr_entries.append(ce)
    index.sort()
    index_path = tmp_path / "msa.npz"
    index.save(str(index_path))
    ref_path = tmp_path / "ref.fa"
    ref_path.write_bytes(b">test\n" + ref_aligned.tobytes().replace(b"-", b"") + b"\n")

    f = founder_aligned.tobytes()
    lines = ["@HD\tVN:1.6", f"@SQ\tSN:test/1\tLN:{len(f)}"]
    # r0/r1: 2=1I2D20= with the 2= fully under a dst-gap run -> the rewrite
    # turns them into I and the gap-off boundary coincides with the 1I
    for i, pos in enumerate((10, 100)):
        seq = (f[pos:pos + 2] + b"A" + f[pos + 4:pos + 24]).decode()
        lines.append(
            f"r{i}\t0\ttest/1\t{pos + 1}\t60\t2=1I2D20=\t*\t0\t0\t{seq}\t{'I' * len(seq)}"
        )
    # r2: trailing soft clip whose unit position coincides with a gap-off
    seq2 = (f[200:220] + b"AC").decode()
    lines.append(f"r2\t0\ttest/1\t201\t60\t20=2S\t*\t0\t0\t{seq2}\t{'I' * len(seq2)}")
    sam = ("\n".join(lines) + "\n").encode()

    calls = {"gap": 0, "host_realign": 0}
    orig_fg = eng.BatchProjector._dispatch_fused_gap
    orig_rs = eng.BatchProjector._realign_and_splice

    def spy_fg(self, *a, **kw):
        calls["gap"] += 1
        return orig_fg(self, *a, **kw)

    def spy_rs(self, *a, **kw):
        calls["host_realign"] += 1
        return orig_rs(self, *a, **kw)

    monkeypatch.setattr(eng.BatchProjector, "_dispatch_fused_gap", spy_fg)
    monkeypatch.setattr(eng.BatchProjector, "_realign_and_splice", spy_rs)

    outs = {}
    for engine, fused in (("host", False), ("device", True)):
        cfg = ProjectConfig(
            msa_index_path=str(index_path),
            reference_path=str(ref_path),
            reference_msa_id="REF",
            ref_id_separator="/",
            engine=engine,
            device_batch_size=16,
            fused_kernel=fused,
        )
        out = io.BytesIO()
        stats = run_project_alignments(io.BytesIO(sam), out, cfg)
        assert stats.matched_reads == 3
        outs[engine] = out.getvalue()
    assert calls["gap"] == 0  # no event-overflow redispatch: v4 path used
    assert calls["host_realign"] == 0  # device DP results were used
    assert outs["host"] == outs["device"]
