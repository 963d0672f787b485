"""The flagship pipeline: project founder-aligned SAM/BAM records to
standard-reference coordinates.

Reimplements the semantics of the reference tool ``panvc3_project_alignments``
(/root/reference/project-alignments/project_alignments.cc):

- header processing splits input RNAMEs (``chr<sep>seq``) and emits one
  output reference per distinct chr part, optionally honouring a
  user-supplied output order file (process_headers, :1092-1253);
- records that are unmapped / QC-fail / duplicate, lack RNAME/POS, or have
  no sequence are dropped with per-category statistics (:528-572);
- each remaining record's CIGAR+position are projected via the alignment
  projector, the mate's RNEXT/PNEXT are projected via project_position
  (:879-911), and tags are rewritten: only a whitelist of 25 spec tags (plus
  --preserve-tag additions) survives, the original alignment is appended to
  OA, original RNAME/POS/RNEXT/PNEXT go to XR/XP/YR/YP (numeric ref ids),
  realigned query/ref ranges to XB/YB as u32 [start, end) pairs, and the
  record index to the --record-index-tag (:761-877);
- realigned reference ranges can be written as a TSV, deduplicated via a
  sorted union unless --keep-duplicate-ranges (:978-1005).

Batching: records are grouped into fixed-size chunks (CHUNK_SIZE=4 in the
reference, :52) — kept here because the --record-index-tag value is
chunk-granular in the reference (:863-869).  The projection engine is
pluggable: the scalar host oracle, or the batched JAX/Pallas device engine
(panvc3_tpu.ops.engine.BatchProjector).
"""

from __future__ import annotations

import os
import sys
from dataclasses import dataclass, field


from ..alphabet import decode_phred42
from ..cigar import cigar_query_length
from ..io.fasta import FastaReader
from ..io.sam import SamHeader, SamReader, SamRecord, SamWriter
from ..msa_index import MsaIndex, SequenceEntry
from ..native import get_native
from ..projector import project_alignment

CHUNK_SIZE = 4

# SAM spec tags preserved by the reference
# (/root/reference/project-alignments/project_alignments.cc:53-87).
PRESERVED_TAGS = frozenset({
    "AM", "AS", "BC", "BZ", "CB", "CO", "CR", "CS", "CT", "CY", "E2", "FZ",
    "LB", "MI", "ML", "MM", "OA", "OQ", "OX", "PG", "PU", "QT", "QX", "RX",
    "TS",
})


@dataclass
class TagSpec:
    original_rname: str | None = "XR"
    original_pos: str | None = "XP"
    original_rnext: str | None = "YR"
    original_pnext: str | None = "YP"
    realn_query_ranges: str | None = "XB"
    realn_ref_ranges: str | None = "YB"
    rec_idx: str | None = None


@dataclass
class ProjectConfig:
    msa_index_path: str = ""
    reference_path: str = ""
    reference_msa_id: str = ""
    ref_id_separator: str = "_"
    reference_order_path: str | None = None
    preserve_tags: tuple[str, ...] = ()
    tags: TagSpec = field(default_factory=TagSpec)
    use_read_base_qualities: bool = False
    gap_opening_cost: int = 0
    gap_extension_cost: int = -1
    output_realigned_ranges_path: str | None = None
    keep_duplicate_ranges: bool = False
    # --debugging-output: include the task id / QNAME columns in the
    # realigned-ranges TSV (project_alignments.cc:491-497, 1009-1029)
    debugging_output: bool = False
    primary_only: bool = False
    output_bam: bool = False
    status_output_interval: int = 5  # minutes; 0 disables
    command_line: str = "panvc3_tpu project_alignments"
    engine: str = "host"  # "host" or "device"
    device_batch_size: int = 8192  # records per device batch (sweep r2: 8192 beats 4096 by 20% on chip)
    pipeline_depth: int = 2  # batches kept in flight on the device
    # run the finish/apply stages on a worker thread so device fetches
    # (GIL-released) overlap the reader loop's parsing
    threaded_pipeline: bool = True
    # (k, n): this host loads only shard k of the chromosomes (round-robin
    # over sorted ids); input must be pre-routed per shard (e.g. with
    # split_alignments_by_reference).  None = whole index.
    chr_shard: tuple[int, int] | None = None
    # data-parallel sharding over a device mesh: 0 = single device,
    # -1 = all devices, N = first N devices
    data_parallel: int = 0
    # single-dispatch fused kernel (rewrite + run detection + realign on
    # device); opt-in (engine.choose_engine_lane picks it only where host
    # cores are scarce)
    fused_kernel: bool = False
    # native batch fast lane (pipeline/fastlane.py): raw SAM lines are
    # parsed/staged/spliced/formatted entirely in C; byte-identical to the
    # object path (tests/test_fastpath.py).  Off = always use SamRecords.
    fastlane: bool = True


@dataclass
class ProjectStatistics:
    flags_not_matched: int = 0
    ref_id_missing: int = 0
    seq_missing: int = 0
    matched_reads: int = 0
    realigned_range_count: int = 0
    removed_tag_counts: dict[str, int] = field(default_factory=dict)
    # realignment observability (reference delegate hooks + status line,
    # project_alignments.cc:446-481, 931-944): total ns in the realignment
    # DP (batch wall time for the device engine) and total max(ref, query)
    # run length, for the µs/realignment and mean-length status figures
    realignment_time_ns: int = 0
    realigned_range_total_length: int = 0
    # total realignment-DP cells (ref_length x query_length summed over
    # runs) — numerator of the bench's cell-updates/s metric
    realignment_cells: int = 0
    # number of deduplicated ranges written to the ranges TSV
    # ("Re-aligned ranges: N" in the exit stats, :1056-1057)
    written_range_count: int | None = None


def split_ref_id(ref_id: str, separator: str) -> tuple[str, str]:
    """Split ``chr<sep>seq``; the seq part starts one character after the
    separator match (the reference uses substr(1 + pos),
    project_alignments.cc:1330-1334 — single-character separators in
    practice)."""
    pos = ref_id.find(separator)
    if pos < 0:
        raise ValueError(f"separator {separator!r} not found in RNAME {ref_id!r}")
    return ref_id[:pos], ref_id[pos + 1:]


def process_headers(
    input_header: SamHeader,
    separator: str,
    reference_msa_id: str,
    reference_order_path: str | None,
) -> tuple[SamHeader, list[int]]:
    """Build the output header reference set and the input->output reference
    id mapping (mirrors process_headers,
    /root/reference/project-alignments/project_alignments.cc:1092-1253)."""
    input_chr_seq = [split_ref_id(r, separator) for r in input_header.ref_names]

    # Optional user-specified output order.
    order: dict[str, int] = {}
    if reference_order_path:
        unique_chrs = {c for c, _ in input_chr_seq}
        idx = 0
        with open(reference_order_path) as fh:
            for line in fh:
                name = line.rstrip("\n").split("\t")[0]
                if not name:
                    continue
                if name not in unique_chrs:
                    print(
                        f"WARNING: Identifier '{name}' specified in reference "
                        "name order but does not appear in the alignments.",
                        file=sys.stderr,
                    )
                    continue
                if name in order:
                    print(
                        f"WARNING: Identifier '{name}' specified in reference "
                        "name order more than once.",
                        file=sys.stderr,
                    )
                    continue
                order[name] = idx
                idx += 1

    unique: dict[str, int] = {}
    ref_id_mapping: list[int] = []
    next_idx = len(order)
    out_lengths: dict[int, int] = {}
    out_extras: dict[int, str] = {}
    for input_idx, (chr_id, seq_id) in enumerate(input_chr_seq):
        if chr_id in unique:
            out_idx = unique[chr_id]
        elif chr_id in order:
            out_idx = order[chr_id]
            unique[chr_id] = out_idx
        else:
            out_idx = next_idx
            next_idx += 1
            unique[chr_id] = out_idx
            if order:
                print(
                    f"WARNING: Output reference ID '{chr_id}' not found in "
                    "the output order, placing in the end.",
                    file=sys.stderr,
                )
        ref_id_mapping.append(out_idx)
        # LN (and any extra @SQ fields) copied from the projection-target
        # founder's input @SQ entry (project_alignments.cc:1237-1241 copies
        # the whole ref_id_info tuple).
        if seq_id == reference_msa_id:
            out_lengths[out_idx] = input_header.ref_lengths[input_idx]
            if input_idx < len(input_header.ref_extras):
                out_extras[out_idx] = input_header.ref_extras[input_idx]

    n_out = len(unique)
    out_names = [""] * n_out
    for name, i in unique.items():
        out_names[i] = name

    out_header = SamHeader()
    out_header.ref_names = out_names
    # A chromosome whose projection-target founder row is absent from the
    # input header gets LN:0, matching the reference's default-constructed
    # ref_id_info (project_alignments.cc:1229-1240: output_ref_id_info is
    # resize()d and only overwritten for ref_seq_idxs entries).
    out_header.ref_lengths = [out_lengths.get(i, 0) for i in range(n_out)]
    out_header.ref_extras = [out_extras.get(i, "") for i in range(n_out)]
    # Header lines: @HD first (copied or default), then @SQ, then the rest.
    hd = [l for l in input_header.lines if l.startswith("@HD")]
    out_header.lines.extend(hd if hd else ["@HD\tVN:1.6"])
    for name, length, extra in zip(
        out_header.ref_names, out_header.ref_lengths, out_header.ref_extras
    ):
        line = f"@SQ\tSN:{name}\tLN:{length}"
        if extra:
            line += "\t" + extra
        out_header.lines.append(line)
    for line in input_header.lines:
        if line.startswith(("@RG", "@PG", "@CO")):
            out_header.lines.append(line)
    return out_header, ref_id_mapping


def fill_sequence_entries(
    msa_index: MsaIndex,
    input_ref_names: list[str],
    n_output_refs: int,
    separator: str,
    reference_msa_id: str,
    ref_id_mapping: list[int],
    allow_missing: bool = False,
) -> tuple[list[SequenceEntry | None], list[SequenceEntry | None]]:
    """Per input/output ref-id tables of MSA sequence entries (mirrors
    fill_sequence_entries,
    /root/reference/project-alignments/project_alignments.cc:1270-1316).

    With ``allow_missing`` (chromosome-sharded index), header references
    whose chromosome is absent from the index get a None entry — a record
    actually using one then fails as mis-routed input."""
    src_entries: list[SequenceEntry | None] = []
    dst_entries: list[SequenceEntry | None] = [None] * n_output_refs
    for input_idx, ref_id in enumerate(input_ref_names):
        chr_id, seq_id = split_ref_id(ref_id, separator)
        chrom = msa_index.find_chr(chr_id)
        if chrom is None:
            if allow_missing:
                src_entries.append(None)
                continue
            raise KeyError(f"no entry for chromosome ID {chr_id!r} in the MSA index")
        out_idx = ref_id_mapping[input_idx]
        if dst_entries[out_idx] is None:
            dst = chrom.find(reference_msa_id)
            if dst is None:
                raise KeyError(
                    f"no entry for sequence ID {reference_msa_id!r} in the MSA index"
                )
            dst_entries[out_idx] = dst
        src = chrom.find(seq_id)
        if src is None:
            raise KeyError(f"no entry for sequence ID {seq_id!r} in the MSA index")
        src_entries.append(src)
    return src_entries, dst_entries


def _project_record(
    rec: SamRecord,
    input_ref_names: list[str],
    src_entries,
    dst_entries,
    ref_id_mapping,
    ref_seqs: dict[int, bytes],
    cfg: ProjectConfig,
    stats: ProjectStatistics,
    rec_idx_value: int | None,
    realigned_ranges_out: list | None,
    task_id: int = 0,
) -> None:
    """Project one record in place via the scalar host oracle."""
    ref_id = rec.ref_id
    dst_ref_id = ref_id_mapping[ref_id]
    src_entry = src_entries[ref_id]
    dst_entry = dst_entries[dst_ref_id]
    ref_seq = ref_seqs[dst_ref_id]

    quals = None
    if cfg.use_read_base_qualities and rec.qual != "*":
        quals = decode_phred42(rec.qual)

    res = project_alignment(
        rec.pos,
        src_entry,
        dst_entry,
        ref_seq,
        rec.seq,
        rec.cigar,
        quals if cfg.use_read_base_qualities else None,
        cfg.gap_opening_cost,
        cfg.gap_extension_cost,
    )
    apply_projection_result(
        rec,
        res,
        input_ref_names,
        src_entries,
        dst_entries,
        ref_id_mapping,
        cfg,
        stats,
        rec_idx_value,
        realigned_ranges_out,
        task_id,
    )


def apply_projection_result(
    rec: SamRecord,
    res,
    input_ref_names: list[str],
    src_entries,
    dst_entries,
    ref_id_mapping,
    cfg: ProjectConfig,
    stats: ProjectStatistics,
    rec_idx_value: int | None,
    realigned_ranges_out: list | None,
    task_id: int = 0,
) -> None:
    """Apply a computed ProjectionResult to the record: tag surgery, mate
    projection, field updates (project_alignments.cc:735-918)."""
    ref_id = rec.ref_id
    dst_ref_id = ref_id_mapping[ref_id]
    src_pos = rec.pos

    stats.realigned_range_count += res.num_realignments
    stats.realignment_time_ns += res.realignment_time_ns
    stats.realigned_range_total_length += res.realigned_total_length
    for (_, rl), (_, ql) in zip(
        res.realigned_reference_ranges, res.realigned_query_ranges
    ):
        stats.realignment_cells += rl * ql
    if realigned_ranges_out is not None:
        for loc, length in res.realigned_reference_ranges:
            realigned_ranges_out.append((loc, length, rec.qname, task_id))

    # -- tag surgery ------------------------------------------------------
    tags = rec.tags
    original_nm = tags.get("NM", (None, None))[1]

    preserved = PRESERVED_TAGS
    extra = set(cfg.preserve_tags)
    for tag in list(tags):
        if tag in preserved or tag in extra:
            continue
        del tags[tag]
        stats.removed_tag_counts[tag] = stats.removed_tag_counts.get(tag, 0) + 1

    # OA: append "RNAME,pos,strand,CIGAR,MAPQ,NM;".  The reference writes the
    # seqan3 0-based position here (project_alignments.cc:815).
    oa_parts = [
        input_ref_names[ref_id],
        str(src_pos),
        "-" if rec.is_reverse else "+",
        "".join(f"{n}{op}" for n, op in rec.cigar),
        str(rec.mapq),
        "" if original_nm is None else str(original_nm),
    ]
    oa = ",".join(oa_parts) + ";"
    prev_oa = tags.get("OA", ("Z", ""))[1]
    tags["OA"] = ("Z", prev_oa + oa)

    t = cfg.tags
    n_ranges = res.num_realignments
    if t.realn_query_ranges and n_ranges:
        vals: list[int] = []
        for loc, length in res.realigned_query_ranges:
            vals += [loc, loc + length]
        tags[t.realn_query_ranges] = ("B", ("I", vals))
    if t.realn_ref_ranges and n_ranges:
        vals = []
        for loc, length in res.realigned_reference_ranges:
            vals += [loc, loc + length]
        tags[t.realn_ref_ranges] = ("B", ("I", vals))
    if t.rec_idx and rec_idx_value is not None and rec_idx_value <= 0x7FFFFFFF:
        tags[t.rec_idx] = ("i", rec_idx_value)
    if t.original_rname:
        tags[t.original_rname] = ("i", ref_id)
    if t.original_pos:
        tags[t.original_pos] = ("i", src_pos)

    if rec.mate_ref_id >= 0:
        mate_ref_id = rec.mate_ref_id
        dst_mate_ref_id = ref_id_mapping[mate_ref_id]
        rec.mate_ref_id = dst_mate_ref_id
        if t.original_rnext:
            tags[t.original_rnext] = ("i", mate_ref_id)
        if rec.mate_pos >= 0:
            mate_pos = rec.mate_pos
            rec.mate_pos = int(
                src_entries[mate_ref_id].project_position(
                    mate_pos, dst_entries[dst_mate_ref_id]
                )
            )
            if t.original_pnext:
                tags[t.original_pnext] = ("i", mate_pos)
    else:
        rec.mate_pos = -1

    rec.pos = res.dst_pos
    rec.cigar = res.cigar
    rec.ref_id = dst_ref_id


def run_project_alignments(
    input_path_or_fh,
    output_path_or_fh,
    cfg: ProjectConfig,
    *,
    version: str = "0.1",
) -> ProjectStatistics:
    reader = SamReader(input_path_or_fh)
    input_header = reader.header
    out_header, ref_id_mapping = process_headers(
        input_header, cfg.ref_id_separator, cfg.reference_msa_id, cfg.reference_order_path
    )
    out_header.append_program(
        "panvc3.project-alignments",
        "PanVC 3 project_alignments",
        cfg.command_line,
        version,
    )

    msa_index = MsaIndex.load(cfg.msa_index_path, shard=cfg.chr_shard)
    src_entries, dst_entries = fill_sequence_entries(
        msa_index,
        input_header.ref_names,
        len(out_header.ref_names),
        cfg.ref_id_separator,
        cfg.reference_msa_id,
        ref_id_mapping,
        allow_missing=cfg.chr_shard is not None,
    )

    fasta = FastaReader(cfg.reference_path)
    # bounded contig buffers: at most 4 unpinned contigs stay resident
    # (the reference's refcounted sequence_buffer_store with 4 spares,
    # libpanvc3/sequence_buffer_store.cc:14-72); batches hold snapshots so
    # in-flight work keeps its buffers alive across eviction
    from ..seqbuf import SequenceBufferStore

    ref_seqs = SequenceBufferStore(
        lambda rid: fasta.read_sequence(out_header.ref_names[rid]), max_size=4
    )

    writer = SamWriter(output_path_or_fh, out_header, bam=cfg.output_bam)
    stats = ProjectStatistics()

    # (loc, length, qname, task_id) rows; task ids are sequential from 1
    # like the reference's (project_alignments.cc:602-605)
    realigned_ranges: list[tuple[int, int, str, int]] | None = (
        [] if cfg.output_realigned_ranges_path else None
    )
    task_counter = [0]

    if cfg.engine == "device":
        from ..ops.engine import BatchProjector
        from ..utils import enable_compile_cache

        enable_compile_cache()
        mesh = None
        if cfg.data_parallel:
            from ..parallel.mesh import make_mesh

            mesh = make_mesh(cfg.data_parallel if cfg.data_parallel > 0 else None)
        # runtime engine-lane arbitration (in place of the manual
        # --fused-kernel switch): the fused v4 single-dispatch engine
        # engages when host CPU is scarce and the D2H leg is healthy;
        # everywhere else the split fast lane wins.  choose_engine_lane
        # is free unless the core count alone can't decide.
        # PANVC3_ENGINE_LANE / PANVC3_ENGINE_AUTO=0 override.
        if (
            not cfg.fused_kernel
            and mesh is None
            and not cfg.use_read_base_qualities
            and get_native() is not None
            and os.environ.get("PANVC3_ENGINE_AUTO", "1") != "0"
        ):
            # the fused engine itself gates off under -q and without the
            # native extension (engine.use_fused); selecting it in those
            # configurations would only disable the fast lane and fall
            # through to the slow object path
            from ..ops.engine import choose_engine_lane

            if choose_engine_lane() == "fused":
                import dataclasses as _dc

                cfg = _dc.replace(cfg, fused_kernel=True)
        batch_engine = BatchProjector(
            src_entries,
            dst_entries,
            ref_id_mapping,
            cfg.gap_opening_cost,
            cfg.gap_extension_cost,
            mesh=mesh,
        )
        batch_size = max(CHUNK_SIZE, (cfg.device_batch_size // CHUNK_SIZE) * CHUNK_SIZE)

        from .fastlane import fastlane_eligible, run_fast

        if cfg.fastlane and fastlane_eligible(cfg, reader, writer, mesh, batch_engine):
            run_fast(
                reader, writer, cfg, stats, batch_engine,
                input_header, out_header, src_entries, dst_entries,
                ref_id_mapping, ref_seqs, realigned_ranges,
            )
            writer.close()
            stats.realignment_time_ns += batch_engine.realignment_time_ns
            if cfg.output_realigned_ranges_path and realigned_ranges is not None:
                _write_realigned_ranges(cfg, realigned_ranges, stats)
            return stats
    else:
        batch_engine = None
        batch_size = CHUNK_SIZE

    # The record-index tag is granular per CHUNK_SIZE=4 group of valid
    # records: every record in a group gets (last record's global index) -
    # group size + 1 (project_alignments.cc:863-869).  The device engine
    # processes larger batches (a multiple of CHUNK_SIZE) but computes the
    # tag per 4-group, and keeps up to two batches in flight so device
    # work overlaps host post-processing.
    import collections

    chunk: list[tuple[int, SamRecord]] = []
    in_flight: collections.deque = collections.deque()
    MAX_IN_FLIGHT = max(1, cfg.pipeline_depth)

    def apply_batch(batch_records, results):
        for start in range(0, len(batch_records), CHUNK_SIZE):
            sub = batch_records[start:start + CHUNK_SIZE]
            rec_idx_value = sub[-1][0] - len(sub) + 1
            task_counter[0] += 1
            task_id = task_counter[0]
            for off, (_, rec) in enumerate(sub):
                if results is not None:
                    apply_projection_result(
                        rec,
                        results[start + off],
                        input_header.ref_names,
                        src_entries,
                        dst_entries,
                        ref_id_mapping,
                        cfg,
                        stats,
                        rec_idx_value,
                        realigned_ranges,
                        task_id,
                    )
                else:
                    _project_record(
                        rec,
                        input_header.ref_names,
                        src_entries,
                        dst_entries,
                        ref_id_mapping,
                        ref_seqs,
                        cfg,
                        stats,
                        rec_idx_value,
                        realigned_ranges,
                        task_id,
                    )
        for _, rec in batch_records:
            writer.write(rec)

    # three pipeline stages per batch (mirrors the reference's spsc_queue
    # stages, project_alignments.cc:484-655): stage 1 = rewrite dispatch
    # (in_flight), stage 2 = host finalize + realign dispatch
    # (realign_flight), stage 3 = realign fetch + splice + write.  Keeping
    # the realign round-trip of batch k in flight while batch k+1's rewrite
    # streams takes one device round-trip off the critical path.
    realign_flight: collections.deque = collections.deque()

    def drain_realign_one():
        batch_records, handle2 = realign_flight.popleft()
        apply_batch(batch_records, batch_engine.finish_realign(handle2))

    def drain_one():
        batch_records, handle = in_flight.popleft()
        realign_flight.append((batch_records, batch_engine.finish_rewrite(handle)))
        if len(realign_flight) >= MAX_IN_FLIGHT:
            drain_realign_one()

    # Threaded drain: the device fetches release the GIL, so running the
    # finish stages on one worker thread overlaps them with the reader
    # loop's parsing (host work and device waits would otherwise be
    # serialised).  One worker + FIFO
    # queue preserves output order; the reference gets the same overlap
    # from its output dispatch queue (project_alignments.cc:920-927).
    worker_error: list[BaseException] = []
    work_q = None
    worker = None
    if batch_engine is not None and cfg.threaded_pipeline:
        import queue as _queue
        import threading

        work_q = _queue.Queue(maxsize=max(1, cfg.pipeline_depth))

        def _worker_loop():
            rflight: collections.deque = collections.deque()
            try:
                while True:
                    item = work_q.get()
                    if item is None:
                        while rflight:
                            br, h2 = rflight.popleft()
                            apply_batch(br, batch_engine.finish_realign(h2))
                        return
                    br, handle = item
                    rflight.append((br, batch_engine.finish_rewrite(handle)))
                    if len(rflight) >= MAX_IN_FLIGHT:
                        br, h2 = rflight.popleft()
                        apply_batch(br, batch_engine.finish_realign(h2))
            except BaseException as exc:  # propagate to the main thread
                worker_error.append(exc)
                while True:  # unblock the producer
                    item = work_q.get()
                    if item is None:
                        return

        worker = threading.Thread(target=_worker_loop, daemon=True)
        worker.start()

    def flush_chunk():
        nonlocal chunk
        if not chunk:
            return
        if batch_engine is not None:
            snapshot = ref_seqs.require(
                {ref_id_mapping[r.ref_id] for _, r in chunk}
            )
            handle = batch_engine.start_batch([r for _, r in chunk], snapshot, cfg)
            if work_q is not None:
                if worker_error:
                    raise worker_error[0]
                work_q.put((chunk, handle))
            else:
                in_flight.append((chunk, handle))
                if len(in_flight) >= MAX_IN_FLIGHT:
                    drain_one()
            chunk = []
        else:
            apply_batch(chunk, None)
            chunk = []

    FLAG_SKIP = 0x4 | 0x200 | 0x400  # unmapped | QC fail | duplicate

    from ..utils import StatusReporter, log_time

    reporter = StatusReporter(cfg.status_output_interval)

    def _realign_status() -> str:
        # mirrors the reference status line (project_alignments.cc:466-478)
        n = stats.realigned_range_count
        msg = f"; realigned {n} ranges"
        if n:
            from ..utils import format_duration

            t_ns = stats.realignment_time_ns
            if batch_engine is not None:
                t_ns += batch_engine.realignment_time_ns
            usecs = t_ns / 1000.0 / n
            mean_len = stats.realigned_range_total_length / n
            msg += (
                f" (in {format_duration(t_ns / 1e9)}; "
                f"{usecs:.2f} µs / realignment, mean length {mean_len:g} characters)"
            )
        return msg

    reporter.extra_cb = _realign_status

    rec_idx = -1
    try:
        for rec_idx, rec in enumerate(reader):
            if (1 + rec_idx) % 10_000_000 == 0:
                log_time(f"Processed {1 + rec_idx} alignments…")
            reporter.tick(rec_idx)
            if rec.flag & FLAG_SKIP:
                stats.flags_not_matched += 1
                continue
            if cfg.primary_only and rec.flag & 0x100:
                stats.flags_not_matched += 1
                continue
            if rec.ref_id < 0:
                stats.ref_id_missing += 1
                continue
            if rec.pos < 0:
                stats.flags_not_matched += 1
                continue
            if not rec.seq or rec.seq == "*":
                stats.seq_missing += 1
                continue
            qlen = cigar_query_length(rec.cigar)
            if rec.cigar and qlen != len(rec.seq):
                raise ValueError(
                    f"record {rec.qname!r}: CIGAR consumes {qlen} query "
                    f"bases but SEQ has {len(rec.seq)}"
                )
            if src_entries[rec.ref_id] is None:
                raise ValueError(
                    f"record {rec.qname!r} references "
                    f"{input_header.ref_names[rec.ref_id]!r}, which is outside "
                    "this index shard (--msa-index-chr-shard); route the input "
                    "with panvc3_split_alignments_by_reference first"
                )
            stats.matched_reads += 1

            chunk.append((rec_idx, rec))
            if len(chunk) == batch_size:
                flush_chunk()

        flush_chunk()
    finally:
        # always join the worker — exiting with it mid-device-dispatch
        # crashes interpreter teardown (XLA compile on a dying runtime)
        if worker is not None:
            work_q.put(None)
            worker.join()
    if worker is not None and worker_error:
        raise worker_error[0]
    while in_flight:
        drain_one()
    while realign_flight:
        drain_realign_one()
    writer.close()

    if batch_engine is not None:
        stats.realignment_time_ns += batch_engine.realignment_time_ns

    if cfg.output_realigned_ranges_path and realigned_ranges is not None:
        _write_realigned_ranges(cfg, realigned_ranges, stats)

    return stats


def _write_realigned_ranges(
    cfg: ProjectConfig,
    realigned_ranges: list[tuple[int, int, str, int]],
    stats: ProjectStatistics,
) -> None:
    """Write the realigned-ranges TSV (output_realigned_ranges,
    project_alignments.cc:489-503, 1009-1029).

    --keep-duplicate-ranges: per-task output, ranges sorted within each
    task (the reference sorts each task's vector, :756); --debugging-output
    adds the Task and QNAME columns.  Otherwise a global sorted dedup
    (sorted_set_union merge, :986-992); on duplicates the earliest task's
    QNAME is kept, matching the union's keep-first semantics.
    """
    with open(cfg.output_realigned_ranges_path, "w") as fh:
        dbg = cfg.debugging_output
        if cfg.keep_duplicate_ranges:
            fh.write("Location\tLength\tTask\tQNAME\n" if dbg else "Location\tLength\n")
            # rows arrive in task order already; sort within each task
            by_task: dict[int, list] = {}
            task_order: list[int] = []
            for loc, length, qname, tid in realigned_ranges:
                if tid not in by_task:
                    by_task[tid] = []
                    task_order.append(tid)
                by_task[tid].append((loc, length, qname))
            for tid in task_order:
                for loc, length, qname in sorted(by_task[tid], key=lambda r: r[:2]):
                    if dbg:
                        fh.write(f"{loc}\t{length}\t{tid}\t{qname}\n")
                    else:
                        fh.write(f"{loc}\t{length}\n")
        else:
            fh.write("Location\tLength\tQNAME\n" if dbg else "Location\tLength\n")
            seen: dict[tuple[int, int], str] = {}
            for loc, length, qname, _tid in sorted(
                realigned_ranges, key=lambda r: (r[3], r[0], r[1])
            ):
                if (loc, length) not in seen:
                    seen[(loc, length)] = qname
            stats.written_range_count = len(seen)
            for (loc, length), qname in sorted(seen.items()):
                if dbg:
                    fh.write(f"{loc}\t{length}\t{qname}\n")
                else:
                    fh.write(f"{loc}\t{length}\n")
