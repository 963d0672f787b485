"""Native-batch fast lane for project_alignments (SAM text → SAM text).

The object path parses every record into a Python ``SamRecord``, applies
tag surgery in Python and re-serialises — several µs of interpreter work
per record, which round 1 measured as the tool's critical path (host 2.6 s
vs device 1.4 s per 49k reads).  This lane keeps records native end to
end: raw line bytes → C ``parse_stage_batch`` (filters + staged device
arrays + span arena) → packed rewrite kernel → C ``finalize_rewrite`` →
C ``stage_realign_runs`` → realign kernel → C ``splice_apply_format``
(CIGAR splice + tag surgery + SAM text, one blob per batch).  Python only
moves numpy arrays between those steps.

Semantics are identical to the object path (the reference's per-record
loop, /root/reference/project-alignments/project_alignments.cc:670-928);
tests/test_fastpath.py asserts byte-identical output on mixed workloads.
"""

from __future__ import annotations

import os
import time as _time

import numpy as np

from ..native import get_native
from ..utils import StatusReporter, log_time

FLAG_SKIP = 0x4 | 0x200 | 0x400  # unmapped | QC fail | duplicate

# PANVC3_FASTLANE_PROF=1: per-stage wall-time totals printed at the end of
# the run (parse/stage, rewrite fetch, finalize, realign stage, realign
# fetch, splice+format, write)
_PROF = os.environ.get("PANVC3_FASTLANE_PROF") == "1"

# Aggregate-dispatch diagnostics (mutated only on the writer thread; read
# by tests and PANVC3_FASTLANE_PROF reporting): counts of dispatches and
# which wire/layout variants engaged.
AGG_DIAG = {
    "dispatches": 0, "runs": 0, "wire2": 0, "sorted": 0, "refgather": 0,
}

# PANVC3_D2H_PREFETCH=1: issue copy_to_host_async right after each device
# dispatch (opt-in; not measured on the GPU)
_D2H_PREFETCH = os.environ.get("PANVC3_D2H_PREFETCH") == "1"

class LaneController:
    """End-to-end adaptive host/device realign-lane choice.

    A pure cost inequality (cells x host_ns_cell <= device_batch_ns)
    compares RAW per-batch costs, but the two lanes load different parts
    of the pipeline: the host C DP runs inside the worker pool (hidden
    until the cores saturate) while the device lane adds writer-thread
    dispatch + fetch to the ordered drain's critical path — on a
    realignment-heavy bench the inequality picked the device lane while
    the host lane measured 1.6x faster END TO END.  This controller
    optimizes the quantity that matters: per-lane throughput measured
    over EPOCHS — contiguous same-lane spans of emitted batches, clocked
    from the span's first emit to its last — with periodic consecutive
    probe windows on the other lane and a 10% switch hysteresis.
    Per-batch inter-emit gaps would be badly biased here: a deferred
    device batch at the ordered drain's head dams completed host
    payloads (which then emit back-to-back at ~zero gaps), so span-level
    accounting is required for an honest comparison.  The raw cost EMAs
    survive as overrides for extreme batches only, asymmetrically:
    forcing the HOST lane on trivial batches is cheap and safe, while
    forcing the DEVICE lane needs high confidence because dev_ns_batch
    is window-amortized under cross-batch DP aggregation.

    Process-global: the EMAs describe the hardware/link, so every run in
    the process shares and refines them; ``begin_run`` resets only the
    per-run span state.
    """

    PROBE_PERIOD = 48    # decisions between probe windows
    PROBE_LEN = 6        # consecutive probe decisions (one measurable span)
    # an unmeasured (or once-measured, possibly compile-polluted) lane is
    # probed at this short period instead: the r4 controller waited a full
    # PROBE_PERIOD (~42 batches = 344k reads) before first measuring the
    # other lane, so a bench-length adaptive run could finish entirely on
    # the slow initial mode (measured 66k reads/s run 1 vs 256k run 2,
    # tools/probe_adaptive.py)
    BOOTSTRAP_PERIOD = 24
    BOOTSTRAP_SPANS = 2  # spans a lane needs before normal cadence applies
    HYSTERESIS = 0.9     # switch only on a >=10% measured win
    # cheap side: cost-ratio that forces the host lane.  The margin must
    # absorb the window amortization of dev_ns_batch: each deferred batch
    # observes most of its aggregate WINDOW's stage+fetch wall (windows
    # span ~2-8 batches), so the EMA reads several times the true
    # per-batch cost and an 8x margin effectively shrank to ~1x — an
    # instrumented heavy run showed every mid-range batch force-routed to
    # the host lane (5.9 us/read) while the controller's span model had
    # correctly chosen dev (2.9 us/read).  64x keeps the shortcut for its
    # intended audience (trivial-realignment batches: mixed-workload
    # batches run ~30k cells = ~0.1 ms host vs the 16 ms device prior)
    # without overriding the measured span model on heavy streams.
    OVERRIDE_HOST = 64.0
    OVERRIDE_DEV = 64.0  # expensive side: ratio that forces the device lane
    BACKOFF_MAX = 16     # probe-period multiplier when the probe keeps losing
    # a probe that loses by more than this ratio grows the back-off.  It
    # was 2.0, which kept the full 12.5% probe duty whenever the lanes
    # diverged 1.2-2x — exactly today's steady state (dev ~1.5x faster
    # realign-heavy), where each probe window costs its whole rate gap
    # plus aggregate-window fragmentation (~15% of a 24-batch stretch,
    # measured).  1.3 backs clearly-decided races off to ~1.6% duty while
    # true near-ties (<=1.3) keep the close watch; the active lane's
    # SPAN_CLOSE_BATCHES refresh still surfaces its own degradation
    # immediately, so the cost of a stale inactive-lane EMA is bounded by
    # the probe returning within BACKOFF_MAX periods.
    BACKOFF_LOSS_RATIO = 1.3
    # close + restart a long same-lane span every N batches: spans
    # otherwise only close on lane TRANSITIONS, so a controller locked on
    # one lane would never refresh that lane's ns/read EMA and couldn't
    # see the active lane degrade (the device lane once stayed chosen at
    # 97k reads/s while the host lane ran 162k in the same window,
    # because the open dev span never closed)
    SPAN_CLOSE_BATCHES = 12
    # spans carrying fewer counted batches measure lane-transition
    # turbulence, not lane throughput: the same-lane fragment squeezed
    # between a refresh close and the next probe window is stalled by the
    # probe's aggregate-window fragmentation (measured 11.7 us/read on a
    # 4-batch dev fragment whose clean 12-batch neighbours ran 3.8) —
    # discard them.  Probe windows themselves count PROBE_LEN-1 batches
    # (the first emit only starts the clock) and stay eligible.
    MIN_SPAN_BATCHES = 5
    # an ordered-drain dam burst can emit a whole span in near-zero wall
    # time (measured 311 ns/read on a host probe span whose real rate was
    # ~5600): a span implying a rate far beyond every lane's measured EMA
    # carries no sustained-rate information.  Clamp instead of discard so
    # a genuinely faster lane still converges over repeated probes.
    BURST_FLOOR_FRACTION = 0.25

    def __init__(self):
        import threading

        self.lock = threading.Lock()
        # cost EMAs; priors reproduce the historical 4e6-cell threshold
        self.host_ns_cell = 4.0
        self.dev_ns_batch = 16e6
        self.ns_read = {"host": None, "dev": None}
        self.span_count = {"host": 0, "dev": 0}
        self.span_discards = {"host": 0, "dev": 0}
        self.regime_cells_per_read = None
        self._regime_outliers = 0
        self._regime_cooldown = 0
        # burst floor carried across a regime reset (dam bursts are a
        # steady-state artifact, so the first post-reset span needs the
        # protection too); imperfect across regimes but directionally
        # conservative
        self._carried_floor = None
        self.mode = "host"
        self.tick = 0
        self.backoff = 1
        # current same-lane span: lane, first-emit clock, reads since
        self.span_lane = None
        self.span_start_ns = 0
        self.span_last_ns = 0
        self.span_reads = 0
        self.span_batches = 0

    def begin_run(self):
        with self.lock:
            # CLOSE the previous run's open span (its clock ends at its
            # last emit, so cross-run idle time is not counted) instead
            # of dropping it: probe windows fire at the END of each
            # period, which can align with the end of a run (24-batch
            # runs x BOOTSTRAP_PERIOD 24), and dropping the open span
            # then discards every bootstrap probe measurement — the
            # other lane stays unmeasured forever and the controller
            # locks on the initial mode (measured: 143-156k reads/s
            # all-host across every run of a bench while the dev lane
            # ran 183k+, tools/probe_adaptive_bench_seq.py).
            self._close_span()
            self.span_lane = None
            self.span_reads = 0
            self.span_batches = 0
            # a tail fragment at stream end is structural, not evidence
            # of chronic fragmentation — don't let run boundaries arm the
            # fragment escape hatch across runs
            self.span_discards = {"host": 0, "dev": 0}

    def decide(self, real_cells: int) -> bool:
        """True -> host C DP; False -> device lane."""
        with self.lock:
            host_ns = real_cells * self.host_ns_cell
            if host_ns > self.OVERRIDE_DEV * self.dev_ns_batch:
                return False
            if self.OVERRIDE_HOST * host_ns < self.dev_ns_batch:
                return True
            self.tick += 1
            # probe at the END of each period (a start-of-period window
            # would penalize short streams, whose first batches all land
            # in it), with exponential back-off while probes keep losing
            period = self.PROBE_PERIOD * self.backoff
            other = "dev" if self.mode == "host" else "host"
            if self.span_count[other] < self.BOOTSTRAP_SPANS:
                # bootstrap cadence; the first PROBE_LEN batches stay on
                # the current mode so the pipeline settles before a span
                # is worth measuring
                if self.tick <= self.PROBE_LEN:
                    return self.mode == "host"
                period = self.BOOTSTRAP_PERIOD
            elif self.backoff == 1 and os.environ.get(
                "PANVC3_LANE_MIX", "0"
            ) == "1":
                # graduated duty (OPT-IN, default off): when the lanes
                # measure close, send the "losing" lane real work at a
                # higher duty cycle.  The lanes do load disjoint
                # resources, but higher duty fragments the aggregate
                # windows and loads the writer thread; not measured on
                # the GPU.  Kept as PANVC3_LANE_MIX=1 for experiments.
                h, d = self.ns_read["host"], self.ns_read["dev"]
                if h is not None and d is not None:
                    ratio = max(h, d) / max(min(h, d), 1e-9)
                    if ratio <= 1.15:
                        period = 2 * self.PROBE_LEN  # alternate 50/50
                    elif ratio <= 1.5:
                        period = 4 * self.PROBE_LEN
            if self.tick % period >= period - self.PROBE_LEN:
                return self.mode != "host"  # probe the other lane
            return self.mode == "host"

    def observe_host_dp(self, ns: float, cells: int):
        with self.lock:
            self.host_ns_cell = 0.7 * self.host_ns_cell + 0.3 * ns / cells

    def observe_dev_batch(self, total_ns: float):
        with self.lock:
            self.dev_ns_batch = 0.7 * self.dev_ns_batch + 0.3 * total_ns

    def _close_span(self):
        # record the finished span's ns/read (clocked from its FIRST emit,
        # so the lane-transition turbulence of batch 1 is excluded)
        elapsed = self.span_last_ns - self.span_start_ns
        if self.span_lane is not None and self.span_reads > 0 and elapsed > 0:
            if self.span_batches < self.MIN_SPAN_BATCHES:
                # fragment — but a workload whose spans are ALWAYS cut
                # short (e.g. trivial override-routed batches interleaving
                # every few heavy ones) must not freeze the EMAs entirely:
                # after 3 consecutive discards on a lane, accept >=2-batch
                # fragments until a full span records again
                if not (
                    self.span_discards[self.span_lane] >= 3
                    and self.span_batches >= 2
                ):
                    self.span_discards[self.span_lane] += 1
                    return
            was_probe = self.span_lane != self.mode
            ns_read = elapsed / self.span_reads
            cur = self.ns_read[self.span_lane]
            known = [v for v in self.ns_read.values() if v is not None]
            if known or self._carried_floor is not None:
                floor = (
                    self.BURST_FLOOR_FRACTION * min(known)
                    if known
                    else self._carried_floor
                )
                if ns_read < floor:
                    # dam-burst span: cap its influence.  This applies to a
                    # lane's FIRST span too (adopt the floor, don't
                    # discard): a genuinely-4x-faster lane measures below
                    # the floor LEGITIMATELY (measured: dev 1388 ns/read
                    # vs host 6700 end to end), and discarding would
                    # deadlock bootstrap — every probe re-measured, every
                    # measurement "a burst", the controller locked on the
                    # slow lane for the whole stream.  Adopting the floor
                    # flips the mode the right way in the genuine case,
                    # and in the bogus-burst case the adopted value is
                    # pulled to reality by the refresh spans within a few
                    # SPAN_CLOSE_BATCHES windows.
                    ns_read = floor
            self.span_discards[self.span_lane] = 0
            self.ns_read[self.span_lane] = (
                ns_read if cur is None else 0.7 * cur + 0.3 * ns_read
            )
            self.span_count[self.span_lane] += 1
            h, d = self.ns_read["host"], self.ns_read["dev"]
            if h is not None and d is not None:
                if self.mode == "host" and d < self.HYSTERESIS * h:
                    self.mode = "dev"
                elif self.mode == "dev" and h < self.HYSTERESIS * d:
                    self.mode = "host"
                if was_probe:
                    mine = d if self.span_lane == "dev" else h
                    other = h if self.span_lane == "dev" else d
                    if self.span_lane == self.mode:
                        self.backoff = 1  # probe won: watch closely again
                    elif (
                        mine > self.BACKOFF_LOSS_RATIO * other
                        and self.span_count[self.span_lane]
                        >= self.BOOTSTRAP_SPANS
                    ):
                        # never back off on a lane's first spans: the
                        # very first device window may carry a fresh
                        # kernel compile, and parking the probe for
                        # BACKOFF_MAX periods on that evidence would
                        # freeze a wrong verdict
                        self.backoff = min(self.backoff * 2, self.BACKOFF_MAX)
                    else:
                        self.backoff = 1

    def observe_emit(
        self,
        dev_lane: bool,
        reads: int,
        now_ns: int,
        attribute: bool = True,
        cells: int = 0,
    ):
        """Writer-thread signal: one batch emitted.  ``attribute=False``
        (no realign runs — lane-neutral) joins the open span, if any,
        without being able to start or switch one.  ``cells`` (the
        batch's realignment DP cells) feeds workload-regime detection."""
        with self.lock:
            if not attribute:
                if self.span_lane is not None:
                    self.span_reads += reads
                    self.span_last_ns = now_ns
                return
            # ns/read EMAs are only comparable within one workload
            # regime: a mixed-workload host span (~1.3 us/read, realign a
            # tiny slice of each batch) says nothing about the host
            # lane's rate on a realign-heavy stream (~5.9 us/read).
            # Benched back to back, the stale cross-regime EMAs cost the
            # heavy adaptive run most of its first hundred batches
            # re-learning (164k reads/s vs 277k measured heavy-only in
            # the same windows).  Track cells/read; when it shifts >4x,
            # reset to a fresh bootstrap (the 24-tick bootstrap cadence
            # re-measures both lanes within ~2 windows).
            if reads > 0 and cells > 0:
                cpr = cells / reads
                reg = self.regime_cells_per_read
                if self._regime_cooldown > 0:
                    self._regime_cooldown -= 1
                if reg is None:
                    self.regime_cells_per_read = cpr
                elif cpr > 4.0 * reg or cpr < 0.25 * reg:
                    # two consecutive out-of-band batches = a real regime
                    # shift; one is just an outlier batch.  At most one
                    # reset per cooldown window: an OSCILLATING bimodal
                    # stream would otherwise re-bootstrap forever and
                    # never record a span — during cooldown the regime
                    # EMA blends fast (0.3) instead, so a persistent new
                    # regime re-centres without a second reset and an
                    # oscillation lands the centre mid-band where the 4x
                    # band covers both poles (pre-reset blended
                    # behaviour).
                    self._regime_outliers += 1
                    if self._regime_outliers >= 2:
                        self._regime_outliers = 0
                        if self._regime_cooldown == 0:
                            # carry a floor across the reset so the first
                            # post-reset span keeps dam-burst protection
                            known = [
                                v for v in self.ns_read.values()
                                if v is not None
                            ]
                            if known:
                                self._carried_floor = (
                                    self.BURST_FLOOR_FRACTION * min(known)
                                )
                            self.regime_cells_per_read = cpr
                            self.ns_read = {"host": None, "dev": None}
                            self.span_count = {"host": 0, "dev": 0}
                            self.span_discards = {"host": 0, "dev": 0}
                            self.backoff = 1
                            self.span_lane = None  # span mixes regimes
                            self._regime_cooldown = 96
                        else:
                            self.regime_cells_per_read = (
                                0.7 * reg + 0.3 * cpr
                            )
                else:
                    self._regime_outliers = 0
                    self.regime_cells_per_read = 0.9 * reg + 0.1 * cpr
            lane = "dev" if dev_lane else "host"
            if lane != self.span_lane:
                self._close_span()
                self.span_lane = lane
                self.span_start_ns = now_ns
                self.span_last_ns = now_ns
                self.span_reads = 0  # first batch only starts the clock
                self.span_batches = 0
            else:
                self.span_reads += reads
                self.span_last_ns = now_ns
                self.span_batches += 1
                if self.span_batches >= self.SPAN_CLOSE_BATCHES:
                    # periodic refresh: record the chunk and restart the
                    # span on the same lane (this emit is the new clock
                    # start) so active-lane degradation surfaces and the
                    # cross-lane switch check runs without a probe
                    self._close_span()
                    self.span_start_ns = now_ns
                    self.span_last_ns = now_ns
                    self.span_reads = 0
                    self.span_batches = 0


_ADAPT = LaneController()


def fastlane_eligible(cfg, reader, writer, mesh, batch_engine=None) -> bool:
    """The fast lane covers the default tool configuration (now including
    BAM input/output via the C BAM<->SAM-text converters), integer-scoring
    realignment, single-device dispatch.  Device sequence ids must fit the
    u16 wire format (a >65k-sequence shard should use
    --msa-index-chr-shard anyway)."""
    nat = get_native()
    return (
        nat is not None
        and (not reader.is_bam or hasattr(nat, "bam_to_sam_lines"))
        and (not writer.bam or hasattr(nat, "sam_text_to_bam"))
        and not cfg.fused_kernel
        and mesh is None
        and (
            batch_engine is None
            or max(
                max(batch_engine.src_dev_ids, default=0),
                max(batch_engine.dst_dev_ids, default=0),
            )
            < 65536
        )
    )


def run_fast(
    reader,
    writer,
    cfg,
    stats,
    batch_engine,
    input_header,
    out_header,
    src_entries,
    dst_entries,
    ref_id_mapping,
    ref_seqs,
    realigned_ranges,
):
    """Drive the full projection pipeline over raw line batches."""
    import jax

    from ..ops.realign_batch import (
        pack_realign_wire_input,
        realign_device_kernel,
        realign_device_kernel_wire,
        unpack_realign_wire,
    )
    from ..ops.rewrite_batch import (
        D_SPARSE_SLOTS,
        pack_gap_wire_input,
        rewrite_gap_kernel_wire,
        unpack_gap_wire,
    )
    from .project_alignments import PRESERVED_TAGS

    nat = get_native()
    bp = batch_engine

    # Event-based projection geometry (ops/event_geometry.py): the gap
    # structure under a read is determined by the ~1-per-100bp columns
    # where the src/dst gap vectors differ, so the whole rewrite-geometry
    # device dispatch (and its round trip) reduces to host
    # searchsorted + event decoding.  PANVC3_EVENT_GEOMETRY=0 restores
    # the device gap kernel; =device runs the same event math as a device
    # kernel (ops/event_geometry.DeviceEventGeometry — ~3x the gap kernel,
    # for hosts that want the geometry off-CPU), with the host event path
    # as the bit-identical fallback on event-slot overflow.
    from ..ops.event_geometry import project_unit

    event_geo = None
    dev_event = dev_event_wire = dev_event_host = None
    _ev_mode = os.environ.get("PANVC3_EVENT_GEOMETRY", "1")
    if _ev_mode == "device":
        from ..ops.event_geometry import DeviceEventGeometry, EventGeometry

        dev_event_host = EventGeometry(src_entries, dst_entries, ref_id_mapping)
        dev_event = DeviceEventGeometry(dev_event_host)
        dev_event_wire = jax.jit(dev_event.kernel_wire, static_argnames=("R",))
    elif _ev_mode != "0":
        from ..ops.event_geometry import EventGeometry

        event_geo = EventGeometry(src_entries, dst_entries, ref_id_mapping)

    refmap = {name.encode(): i for i, name in enumerate(input_header.ref_names)}
    rim = np.asarray(ref_id_mapping, dtype=np.int32)
    src_dev = np.asarray(bp.src_dev_ids, dtype=np.int32)
    dst_dev = np.asarray(bp.dst_dev_ids, dtype=np.int32)
    preserved = b"".join(
        sorted(
            t.encode()
            for t in (PRESERVED_TAGS | set(cfg.preserve_tags))
            if len(t) == 2
        )
    )
    t = cfg.tags
    tag_names = (
        t.original_rname, t.original_pos, t.original_rnext, t.original_pnext,
        t.realn_query_ranges, t.realn_ref_ranges, t.rec_idx,
    )
    out_names = list(out_header.ref_names)
    in_names = list(input_header.ref_names)
    primary_mask = 0x100 if cfg.primary_only else 0
    want_ranges = 1 if realigned_ranges is not None else 0

    batch_size = max(4, cfg.device_batch_size)
    go = np.float32(cfg.gap_opening_cost)
    ge = np.float32(cfg.gap_extension_cost)
    use_quality = bool(cfg.use_read_base_qualities)

    # Adaptive realignment dispatch: the indel runs of a typical batch are
    # tiny (~10 DP cells each), so when the batch's real cell count is
    # small the device round trip dwarfs the compute — run the
    # bit-identical C DP on the host instead (realign_runs_host; verified
    # equal to the kernel in tests/test_device_ops.py).  Large-run batches
    # still go to the device kernel.  Integral gap costs only, so that
    # float32 arithmetic is exact and host and device cannot diverge.  PANVC3_HOST_DP=0 disables; the cell
    # threshold is PANVC3_HOST_DP_CELLS (default 4e6 ≈ 15 ms of C DP).
    # (The quantised Malde tables made the -q scheme integral too, so the
    # host lane covers both schemes.)
    host_dp_eligible = (
        float(go).is_integer()
        and float(ge).is_integer()
        and os.environ.get("PANVC3_HOST_DP") != "0"
        and hasattr(nat, "realign_runs_host")
    )
    # Host-DP/device crossover: PANVC3_HOST_DP_CELLS sets a hard cell-count
    # threshold; unset, the lane choice is ADAPTIVE (LaneController):
    # per-lane EMAs of emitted ns/read with periodic probe windows and
    # hysteresis, plus raw-cost overrides for extreme batches.  Priors
    # reproduce the old 4e6-cell default (≈4 ns/cell C DP vs ≈16 ms) until
    # real measurements arrive.
    _hdc_env = os.environ.get("PANVC3_HOST_DP_CELLS")
    host_dp_cells = int(_hdc_env) if _hdc_env else None
    adapt = _ADAPT  # process-global LaneController (see its docstring)
    adapt.begin_run()

    # Cross-batch DP aggregation (threaded drain only): batches whose runs
    # go to the DEVICE kernel defer the dispatch; the writer thread pools
    # the staged runs of the in-flight window into ONE large dispatch
    # (results are sliced back per batch), amortising the fixed cost of
    # each dispatch.  Output order is unchanged (the FIFO
    # already restores it).  PANVC3_DP_AGGREGATE=0 disables;
    # PANVC3_DP_AGG_RUNS sets the target runs per aggregate dispatch.
    # Default 16384: smaller windows PIPELINE — dispatch k computes and
    # moves its wire while k+1 stages.  The value has not been swept on
    # the GPU.
    defer_dp = (
        cfg.threaded_pipeline
        and os.environ.get("PANVC3_DP_AGGREGATE", "1") != "0"
    )
    agg_target_runs = int(os.environ.get("PANVC3_DP_AGG_RUNS", "16384"))
    agg_max_batches = int(os.environ.get("PANVC3_DP_AGG_BATCHES", "16"))
    # flush-on-idle floor: a window this large dispatches as soon as the
    # writer has nothing staged to drain, pipelining device compute + wire
    # with the staging of later batches (PANVC3_DP_AGG_MIN_RUNS)
    agg_min_runs = int(os.environ.get("PANVC3_DP_AGG_MIN_RUNS", "16384"))
    # Ref-gather wire (integer path): ship [query | ref start | lens] rows
    # (Q+8 B) and gather + dna5-normalise the reference rows in-kernel from
    # the resident flat reference — R bytes/run less wire, the dominant
    # cost of large-run device batches.  PANVC3_DP_REFGATHER=0 reverts to
    # shipping staged reference rows; PANVC3_REFGATHER_MAX_H2D caps the
    # one-time flat-reference upload the mode may trigger (default 256 MB;
    # a buffer the fused kernels already made resident is always used).
    refgather_ok = os.environ.get("PANVC3_DP_REFGATHER", "1") != "0"
    refgather_max_h2d = int(
        os.environ.get("PANVC3_REFGATHER_MAX_H2D", str(256 << 20))
    )
    # sort aggregate windows by run length (tile-homogeneous dynamic DP
    # bounds; order restored at fetch) — PANVC3_DP_AGG_SORT=0 reverts
    agg_sort = os.environ.get("PANVC3_DP_AGG_SORT", "1") != "0"
    # diagnostic counters (writer-thread-only mutation; read by tests)
    diag = AGG_DIAG

    # shard-aware check data: dev id -1 == entry outside this index shard
    shard_check = cfg.chr_shard is not None

    reporter = StatusReporter(cfg.status_output_interval)

    state = {
        "rec_global": 0,   # input records consumed before current batch
        "task_counter": 0,  # 4-record task groups emitted
        "realign_fetch_ns": 0,  # fetch half of the realignment timing
        "realign_stage_ns": 0,  # staging/dispatch half (folded at emit)
        "ref_off": np.zeros(max(1, len(dst_entries)), dtype=np.int32),
    }
    prof: dict[str, float] = {}
    _prof_lock = __import__("threading").Lock()

    def _tick(key: str, t0: float) -> float:
        t1 = _time.perf_counter()
        with _prof_lock:
            prof[key] = prof.get(key, 0.0) + (t1 - t0)
        return t1

    def realign_status() -> str:
        n = stats.realigned_range_count
        msg = f"; realigned {n} ranges"
        if n:
            from ..utils import format_duration

            t_ns = stats.realignment_time_ns + bp.realignment_time_ns
            usecs = t_ns / 1000.0 / n
            mean_len = stats.realigned_range_total_length / n
            msg += (
                f" (in {format_duration(t_ns / 1e9)}; "
                f"{usecs:.2f} µs / realignment, mean length {mean_len:g} characters)"
            )
        return msg

    reporter.extra_cb = realign_status

    # Fetch prefetch pool: device_get releases the GIL — issuing the gets
    # from a small pool right after each dispatch lets several batches'
    # round trips overlap, while workers A/B keep all host mutation
    # single-threaded.
    fetch_pool = None
    if cfg.threaded_pipeline:
        from concurrent.futures import ThreadPoolExecutor

        fetch_pool = ThreadPoolExecutor(max_workers=4)

    # Flat-reference ingestion for the ref-gather aggregate wire: the
    # event-geometry path (the default) never ran the gap-kernel branch's
    # _ensure_refs, so BatchProjector's flat reference stayed empty and
    # the slim refgather wires silently never engaged — every aggregate
    # dispatch shipped full staged reference rows (R extra bytes/run of
    # H2D).  Grow-only accumulation with batched rebuilds: contigs are
    # added as batches reference them, the flat buffer rebuilds when the
    # pending growth reaches 25% (amortized O(n log n) total copying),
    # and ingestion stops permanently once the total would exceed the
    # refgather H2D cap (the wire could never engage there anyway).
    import threading as _threading

    _rg_accum: dict[int, bytes] = {}
    _rg_state = {"flat": 0, "pending": 0, "idle": 0, "disabled": not refgather_ok}
    _rg_lock = _threading.Lock()

    def _ingest_refs(snap):
        if _rg_state["disabled"]:
            return
        with _rg_lock:
            if _rg_state["disabled"]:
                return
            new = 0
            for rid, seq in snap.items():
                if rid not in _rg_accum:
                    _rg_accum[rid] = seq
                    new += len(seq)
            if new:
                _rg_state["pending"] += new
                _rg_state["idle"] = 0
            elif _rg_state["pending"]:
                # a deferred rebuild must not starve: without this, a
                # contig deferred by the 25% rule is never ingested unless
                # a LATER batch introduces yet another new contig
                _rg_state["idle"] += 1
            if not _rg_state["pending"]:
                return
            total = _rg_state["flat"] + _rg_state["pending"]
            if total > refgather_max_h2d:
                _rg_state["disabled"] = True
                _rg_accum.clear()  # never rebuilt again — free the copies
                return
            if (
                _rg_state["flat"]
                and _rg_state["pending"] * 4 < _rg_state["flat"]
                and _rg_state["idle"] < 4
            ):
                return  # defer the rebuild while new contigs keep arriving
            bp._ensure_refs(_rg_accum)
            _rg_state["flat"] = total
            _rg_state["pending"] = 0
            _rg_state["idle"] = 0

    def start_batch(lines, rec_base, expect_nrec=None):
        """Parse + stage + dispatch the rewrite kernel; returns a context
        dict (kept == 0 when the whole block was filtered out — the parse
        counter deltas still ride in it).  Record/task numbering comes in
        from the caller (precomputed on main from the scan mask), so this
        may run on a pool worker; the stat deltas are folded in emit()."""
        t0 = _time.perf_counter() if _PROF else 0.0
        staged = nat.parse_stage_batch(
            lines, refmap, FLAG_SKIP, primary_mask,
            4, 8 if dev_event is not None else 2, 2,
        )
        if _PROF:
            t0 = _tick("parse_stage", t0)
        if expect_nrec is not None and staged["n_records"] != expect_nrec:
            raise RuntimeError(
                "scan/parse record count mismatch: "
                f"{staged['n_records']} != {expect_nrec}"
            )
        parse_stats = (
            staged["flags_not_matched"],
            staged["ref_id_missing"],
            staged["seq_missing"],
        )
        kept = staged["kept"]
        if kept == 0:
            return {"kept": 0, "parse_stats": parse_stats}
        fields = np.frombuffer(staged["fields"], np.int32).reshape(kept, 7)
        ref_id = fields[:, 1]

        if shard_check:
            bad = src_dev[ref_id] < 0
            if bad.any():
                i = int(np.argmax(bad))
                name = input_header.ref_names[int(ref_id[i])]
                raise ValueError(
                    f"record references {name!r}, which is outside this "
                    "index shard (--msa-index-chr-shard); route the input "
                    "with panvc3_split_alignments_by_reference first"
                )
        dst_rids = rim[ref_id]
        snap = ref_seqs.require(int(r) for r in np.unique(dst_rids))
        _ingest_refs(snap)

        O, R, Lq = staged["O"], staged["R"], staged["Lq"]

        out = fut = None
        if dev_event is not None:
            target = batch_size
            bucket = min(target, _next_pow2(kept))
            n_pad = bucket - kept if kept < bucket else 0

            def _pad(a):
                a = np.ascontiguousarray(a, dtype=np.int32)
                if n_pad:
                    a = np.concatenate([a, np.repeat(a[:1], n_pad)])
                return a

            if _PROF:
                t0 = _tick("stage_arrays", t0)
            out = dev_event_wire(
                _pad(ref_id),
                _pad(fields[:, 2]),
                _pad(np.frombuffer(staged["n_ref_units"], np.int32)),
                R,
            )
            fut = (
                fetch_pool.submit(jax.device_get, out)
                if fetch_pool is not None
                else None
            )
        elif event_geo is None:
            # gap-geometry kernel input: one packed u8 array (10 B/record
            # on the wire); the query/reference stay host-side for the
            # C/numpy comparison
            packed_in = pack_gap_wire_input(
                np.ascontiguousarray(fields[:, 2]),
                np.frombuffer(staged["n_ref_units"], np.int32),
                src_dev[ref_id],
                dst_dev[dst_rids],
            )
            # batch-dimension bucketing (same scheme as
            # BatchProjector.start_batch)
            target = batch_size
            bucket = min(target, _next_pow2(kept))
            n_pad = bucket - kept if kept < bucket else 0
            if n_pad:
                packed_in = np.concatenate(
                    [packed_in, np.repeat(packed_in[:1], n_pad, axis=0)],
                    axis=0,
                )

            if _PROF:
                t0 = _tick("stage_arrays", t0)
            out = rewrite_gap_kernel_wire(bp.index, packed_in, R)
            # D2H prefetch right after dispatch overlaps the transfer with
            # host work on backends with true async copies (opt-in)
            if _D2H_PREFETCH:
                for a in out[:2]:
                    a.copy_to_host_async()
            fut = (
                fetch_pool.submit(jax.device_get, out[:2])
                if fetch_pool is not None
                else None
            )
        if _PROF:
            t0 = _tick("rewrite_dispatch", t0)

        # host mate projection, vectorised per distinct mate reference
        # (project_position, msa_index.hh:253-258); runs on the event
        # prefix sums (project_unit identity) when event geometry is
        # active so no rank/select structure is touched
        mate_dst = np.full(kept, -1, dtype=np.int32)
        mrid = fields[:, 4]
        mpos = fields[:, 5]
        mask = (mrid >= 0) & (mpos >= 0)
        if mask.any():
            geo = event_geo if event_geo is not None else dev_event_host
            for mr in np.unique(mrid[mask]):
                sel = mask & (mrid == mr)
                pe = geo.events[int(mr)] if geo is not None else None
                if pe is not None:
                    sgv = geo.src_gv[int(mr)]
                    u = np.clip(mpos[sel], 0, max(0, sgv.n_zeros - 1))
                    mate_dst[sel] = project_unit(pe, u).astype(np.int32)
                else:
                    dst_e = dst_entries[int(rim[mr])]
                    mate_dst[sel] = src_entries[int(mr)].project_position(
                        mpos[sel], dst_e
                    )

        return {
            "staged": staged,
            "fut": fut,
            "fields": fields,
            "dst_rids": np.ascontiguousarray(dst_rids),
            "kept": kept,
            "rec_base": rec_base,
            "parse_stats": parse_stats,
            "mate_dst": mate_dst,
            "out": out,
            "R": R,
            "Lq": Lq,
            "snap": snap,
        }

    def finish_rewrite(ctx):
        """Fetch rewrite results, finalize + detect runs, dispatch realign."""
        if ctx is None or ctx["kept"] == 0:
            return ctx
        import time as _time

        staged = ctx["staged"]
        kept = ctx["kept"]
        t0 = _time.perf_counter() if _PROF else 0.0
        if dev_event is not None:
            if ctx["fut"] is not None:
                wire, overflow = ctx["fut"].result()
            else:
                wire, overflow = jax.device_get(ctx["out"])
            if int(overflow):
                # rare event-slot overflow: the host event path is
                # bit-identical and handles the dense-deletion case
                fields = ctx["fields"]
                dst_pos_a, gapbits, d_vals, d_pos, d_n, use_full, d_full = (
                    dev_event_host.batch(
                        fields[:, 1],
                        fields[:, 2],
                        np.frombuffer(staged["n_ref_units"], np.int32),
                        ctx["R"],
                        D_SPARSE_SLOTS,
                    )
                )
                d_full = np.ascontiguousarray(d_full)
            else:
                dst_pos_a, d_n, gapbits, d_pos, d_vals = unpack_gap_wire(
                    np.asarray(wire)[:kept], ctx["R"]
                )
                use_full = 0
                d_full = np.zeros(0, np.int32)
            if _PROF:
                t0 = _tick("rewrite_fetch", t0)
        elif event_geo is not None:
            fields = ctx["fields"]
            dst_pos_a, gapbits, d_vals, d_pos, d_n, use_full, d_full = (
                event_geo.batch(
                    fields[:, 1],
                    fields[:, 2],
                    np.frombuffer(staged["n_ref_units"], np.int32),
                    ctx["R"],
                    D_SPARSE_SLOTS,
                )
            )
            d_full = np.ascontiguousarray(d_full)
            if _PROF:
                t0 = _tick("rewrite_fetch", t0)
        else:
            if ctx["fut"] is not None:
                wire, overflow = ctx["fut"].result()
            else:
                wire, overflow = jax.device_get(ctx["out"][:2])
            use_full = int(overflow) != 0
            if use_full:
                d_full = np.ascontiguousarray(
                    jax.device_get(ctx["out"][2])[:kept]
                )
            else:
                d_full = np.zeros(0, np.int32)
            if _PROF:
                t0 = _tick("rewrite_fetch", t0)
            dst_pos_a, d_n, gapbits, d_pos, d_vals = unpack_gap_wire(
                wire[:kept], ctx["R"]
            )
        snap = ctx["snap"]
        ref_list = [snap.get(rid, b"") for rid in range(len(dst_entries))]
        run_ops_b, run_lens_b, runs_per_rec_b, indel_b = (
            nat.finalize_reconstruct(
                staged["unit_op"],
                staged["unit_count"],
                staged["n_units"],
                dst_pos_a,
                d_vals,
                d_pos,
                d_n,
                D_SPARSE_SLOTS,
                d_full,
                int(use_full),
                gapbits,
                ctx["R"],
                staged["query"],
                ctx["Lq"],
                ref_list,
                ctx["dst_rids"],
            )
        )
        nruns = len(indel_b) // 36
        if _PROF:
            t0 = _tick("finalize", t0)

        rh = None
        rh_wire = False
        host_dp = None
        Rp = Qp = S = 0
        if nruns:
            t0 = t0p = _time.perf_counter_ns()
            ref_b, q_b, rl_b, ql_b, Rp, Qp, S, rq_b, qq_b = (
                nat.stage_realign_runs(
                    indel_b, ctx["dst_rids"], ref_list, staged["query"],
                    ctx["Lq"], 8, 8, 256,
                    staged["arena"], staged["spans"], int(use_quality),
                )
            )
            if host_dp_eligible and not (use_quality and Rp + Qp > 5461):
                rl_a = np.frombuffer(rl_b, np.int32)
                ql_a = np.frombuffer(ql_b, np.int32)
                real_cells = int(
                    rl_a.astype(np.int64) @ ql_a.astype(np.int64)
                )
                if host_dp_cells is not None:
                    use_host = real_cells <= host_dp_cells
                else:
                    use_host = adapt.decide(real_cells)
                if use_host:
                    t_dp = _time.perf_counter_ns()
                    if use_quality:
                        from ..align import MALDE_SCALE, malde_tables

                        mt, xt = malde_tables()
                        ops_b, cnt_b = nat.realign_runs_host(
                            ref_b, q_b, rl_b, ql_b, Rp, Qp,
                            float(go) * MALDE_SCALE,
                            float(ge) * MALDE_SCALE,
                            rq_b, qq_b, mt.tobytes(), xt.tobytes(),
                        )
                    else:
                        ops_b, cnt_b = nat.realign_runs_host(
                            ref_b, q_b, rl_b, ql_b, Rp, Qp,
                            float(go), float(ge),
                        )
                    host_dp = (
                        np.frombuffer(ops_b, np.int8),
                        np.frombuffer(cnt_b, np.int32),
                    )
                    dt_dp = _time.perf_counter_ns() - t_dp
                    if real_cells > 1000:  # skip noise-dominated samples
                        adapt.observe_host_dp(dt_dp, real_cells)
            rh_wire = not use_quality and (Rp + Qp) % 2 == 0 and Rp + Qp < 256
            if host_dp is not None:
                pass
            elif defer_dp:
                # device lane: defer — the writer thread aggregates this
                # batch's runs with the rest of the in-flight window into
                # one large dispatch (see _dispatch_aggregate).  The
                # per-run (dst rid, ref start) pairs ride along so the
                # dispatch can gather reference rows on device from the
                # resident flat reference instead of shipping them.
                ind_a = np.frombuffer(indel_b, np.int32).reshape(-1, 9)
                ctx.update(
                    agg=(ref_b, q_b, rl_b, ql_b, Rp, Qp, S, rq_b, qq_b),
                    agg_rid_loc=(
                        np.frombuffer(ctx["dst_rids"], np.int32)[ind_a[:, 0]],
                        ind_a[:, 1].copy(),
                    ),
                    deferred=True,
                )
                ctx["stage_ns"] = _time.perf_counter_ns() - t0
                if _PROF:
                    with _prof_lock:
                        prof["realign_stage"] = prof.get(
                            "realign_stage", 0.0
                        ) + (_time.perf_counter_ns() - t0p) / 1e9
                ctx.update(
                    dst_pos=dst_pos_a,
                    run_ops=run_ops_b,
                    run_lens=run_lens_b,
                    runs_per_rec=runs_per_rec_b,
                    indel=indel_b,
                    rh=None,
                    rh_wire=False,
                    host_dp=None,
                    steps=Rp + Qp,
                )
                return ctx
            elif rh_wire:
                rh = realign_device_kernel_wire(
                    pack_realign_wire_input(
                        np.frombuffer(ref_b, np.uint8).reshape(S, Rp),
                        np.frombuffer(q_b, np.uint8).reshape(S, Qp),
                        np.frombuffer(rl_b, np.int32),
                        np.frombuffer(ql_b, np.int32),
                    ),
                    go,
                    ge,
                    Rp,
                    Qp,
                )
            else:
                if use_quality:
                    # ref quals are pinned to phred42 max (the reference's
                    # rule) — rq=None skips the array entirely; query quals
                    # ship as u8 (4x fewer H2D bytes than the staged i32)
                    rq = None
                    qq = np.frombuffer(qq_b, np.int32).reshape(S, Qp).astype(
                        np.uint8
                    )
                else:
                    # dead at trace time when quality scoring is off —
                    # ship 4-byte dummies, not (S, Rp) zero blocks
                    rq = np.zeros((1, 1), np.int32)
                    qq = np.zeros((1, 1), np.int32)
                if use_quality:
                    # quantised Malde units (align.MALDE_SHIFT): gap costs
                    # scale with the table so the float32 fill stays exact
                    from ..align import MALDE_SCALE

                    if Rp + Qp > 5461:
                        raise ValueError(
                            "quality-scored realignment run too long for "
                            f"the exact quantised path (R+Q={Rp + Qp})"
                        )
                    kgo, kge = go * MALDE_SCALE, ge * MALDE_SCALE
                else:
                    kgo, kge = go, ge
                rh = realign_device_kernel(
                    np.frombuffer(ref_b, np.uint8).reshape(S, Rp),
                    np.frombuffer(q_b, np.uint8).reshape(S, Qp),
                    np.frombuffer(rl_b, np.int32),
                    np.frombuffer(ql_b, np.int32),
                    kgo,
                    kge,
                    rq,
                    qq,
                    use_quality,
                    Rp,
                    Qp,
                )
            if rh is not None and _D2H_PREFETCH:
                for a in rh if isinstance(rh, tuple) else (rh,):
                    a.copy_to_host_async()
            if rh is not None and fetch_pool is not None:
                ctx["rfut"] = fetch_pool.submit(jax.device_get, rh)
            # folded into bp.realignment_time_ns at emit time (this may run
            # on any pool worker; the counters stay single-writer)
            ctx["stage_ns"] = _time.perf_counter_ns() - t0
            if _PROF:
                with _prof_lock:
                    prof["realign_stage"] = prof.get("realign_stage", 0.0) + (
                        _time.perf_counter_ns() - t0p
                    ) / 1e9
        ctx.update(
            dst_pos=dst_pos_a,
            run_ops=run_ops_b,
            run_lens=run_lens_b,
            runs_per_rec=runs_per_rec_b,
            indel=indel_b,
            rh=rh,
            rh_wire=rh is not None and rh_wire,
            host_dp=host_dp,
            steps=Rp + Qp,
        )
        return ctx

    def finish_realign(ctx):
        """Fetch realignment, splice + format the batch.  Returns the emit
        payload (blob + stat deltas); emit() folds it into shared state and
        writes — kept separate so whole batches can run on pool workers
        while all shared mutation stays on the single emitting thread."""
        if ctx is None:
            return None
        if ctx["kept"] == 0:
            return {
                "blob": b"", "removed": {}, "n_realn": 0, "tot_len": 0,
                "cells": 0, "rows": None, "fetch_ns": 0, "stage_ns": 0,
                "kept": 0, "parse_stats": ctx["parse_stats"],
            }
        import time as _time

        fetch_ns = 0
        if ctx.get("realn_override") is not None:
            # aggregated cross-batch dispatch: this batch's row slice of the
            # pooled kernel results (fetch wait measured in _finish_deferred)
            realn_ops, realn_counts, steps = ctx["realn_override"]
            fetch_ns = ctx.get("agg_fetch_ns", 0)
            if _PROF and fetch_ns:
                with _prof_lock:
                    prof["realign_fetch"] = (
                        prof.get("realign_fetch", 0.0) + fetch_ns / 1e9
                    )
        elif ctx["rh"] is not None:
            t0 = _time.perf_counter_ns()
            if ctx.get("rfut") is not None:
                fetched = ctx["rfut"].result()
            else:
                fetched = jax.device_get(ctx["rh"])
            fetch_ns = _time.perf_counter_ns() - t0
            if _PROF:
                with _prof_lock:
                    prof["realign_fetch"] = (
                        prof.get("realign_fetch", 0.0) + fetch_ns / 1e9
                    )
            steps = ctx["steps"]
            if ctx["rh_wire"]:
                realn_ops, realn_counts = unpack_realign_wire(fetched, steps)
            else:
                realn_ops, realn_counts = fetched
                realn_ops = np.ascontiguousarray(realn_ops)
                realn_counts = np.ascontiguousarray(realn_counts)
        elif ctx["host_dp"] is not None:
            realn_ops, realn_counts = ctx["host_dp"]
            steps = ctx["steps"]
        else:
            realn_ops = np.zeros(0, np.int8)
            realn_counts = np.zeros(0, np.int32)
            steps = 0

        staged = ctx["staged"]
        tsp = _time.perf_counter() if _PROF else 0.0
        blob, removed, (n_realn, tot_len, cells), rows, tasks_used = (
            nat.splice_apply_format(
                staged["arena"], staged["spans"], staged["line_index"],
                staged["fields"], staged["n_ops"],
                staged["ops"], staged["counts"], staged["O"],
                ctx["dst_pos"], ctx["run_ops"], ctx["run_lens"],
                ctx["runs_per_rec"], ctx["indel"],
                realn_ops, realn_counts, steps,
                ctx["mate_dst"], rim,
                out_names, in_names, preserved, tag_names,
                ctx["rec_base"], ctx["task_base"], want_ranges,
            )
        )
        if _PROF:
            _tick("splice_format", tsp)
        return {
            "blob": blob,
            "removed": removed,
            "n_realn": n_realn,
            "tot_len": tot_len,
            "cells": cells,
            "rows": rows,
            "fetch_ns": fetch_ns,
            "stage_ns": ctx.get("stage_ns", 0),
            "kept": ctx["kept"],
            "parse_stats": ctx["parse_stats"],
            "dev_realign": (
                ctx.get("realn_override") is not None or ctx["rh"] is not None
            ),
        }

    def emit(payload):
        """Fold one batch's stat deltas and write its blob (single-threaded:
        main on the serial path, the writer thread on the pooled path)."""
        if payload is None:
            return
        pf, pr, ps = payload["parse_stats"]
        stats.flags_not_matched += pf
        stats.ref_id_missing += pr
        stats.seq_missing += ps
        stats.matched_reads += payload["kept"]
        stats.realigned_range_count += payload["n_realn"]
        stats.realigned_range_total_length += payload["tot_len"]
        stats.realignment_cells += payload["cells"]
        for k, v in payload["removed"].items():
            stats.removed_tag_counts[k] = stats.removed_tag_counts.get(k, 0) + v
        rows = payload["rows"]
        if rows is not None and realigned_ranges is not None:
            realigned_ranges.extend(rows)
        state["realign_fetch_ns"] += payload["fetch_ns"]
        state["realign_stage_ns"] += payload["stage_ns"]
        if payload.get("dev_realign"):
            total_ns = payload["stage_ns"] + payload["fetch_ns"]
            if total_ns:
                # observed device realign cost feeds the extreme-batch
                # override of the adaptive lane choice
                adapt.observe_dev_batch(total_ns)
        # end-to-end signal: inter-emit wall time per read, attributed to
        # the emitted batch's realign lane (single-threaded here); batches
        # without realign runs only advance the timestamp
        adapt.observe_emit(
            bool(payload.get("dev_realign")),
            payload["kept"],
            _time.perf_counter_ns(),
            attribute=bool(payload["n_realn"]),
            cells=payload["cells"],
        )
        tw = _time.perf_counter() if _PROF else 0.0
        writer.write_raw(payload["blob"])
        if _PROF:
            _tick("write", tw)

    # ---- pipeline drive --------------------------------------------------
    # Whole-batch parallelism: main parses (start_batch) sequentially —
    # record/task numbering and the reader are inherently ordered — then
    # each parsed batch runs finish_rewrite + finish_realign as ONE pool
    # job (the common event-geometry + host-DP path makes no device calls,
    # so batches are pure CPU and independent).  A writer thread drains the
    # futures strictly in submission order, folding stats and writing
    # blobs, which preserves output order (the role of the reference's
    # serial output queue, project_alignments.cc:920-927) and keeps all
    # shared mutation single-threaded.
    worker_error: list[BaseException] = []
    job_q = None
    pool = None
    writer_thread = None
    n_pool = 0
    if cfg.threaded_pipeline:
        import queue as _queue
        import threading
        from concurrent.futures import ThreadPoolExecutor

        # Autoscale to the box: one core stays for the parsing main thread
        # (the writer thread is I/O-light).  The measured 4-core optimum
        # (3 workers; 4 lost to GIL convoying, ROADMAP knob re-sweep) is the
        # floor and falls out of the same formula; wider hosts get
        # proportionally more workers since the batch jobs are GIL-free C
        # slab loops.  PANVC3_BATCH_WORKERS overrides.
        try:  # respect CPU affinity (fair-share scaling runs pin cores)
            avail = len(os.sched_getaffinity(0))
        except AttributeError:  # non-Linux
            avail = os.cpu_count() or 4
        n_pool = int(
            os.environ.get("PANVC3_BATCH_WORKERS", "0")
        ) or max(2, avail - 1)
        # per-call slab fan-out inside splice/finalize would just
        # oversubscribe the cores the pool already fills
        if hasattr(nat, "set_slab_threads"):
            nat.set_slab_threads(1)
        pool = ThreadPoolExecutor(max_workers=n_pool)
        MAX_IN_FLIGHT = max(cfg.pipeline_depth, n_pool + 1)
        job_q = _queue.Queue(maxsize=MAX_IN_FLIGHT)

        # PANVC3_FASTLANE_CHAOS=<seed>: adversarial scheduling jitter —
        # random sub-ms sleeps at every cross-thread handoff (pool job
        # start, writer drain, aggregate dispatch, fetch) so the ordering
        # invariants documented in CLAUDE.md are machine-checked by the
        # byte-equality suites instead of prose-checked (VERDICT r4 #7).
        # The jitter permutes thread interleavings; output bytes must not
        # change.
        _chaos_env = os.environ.get("PANVC3_FASTLANE_CHAOS")
        if _chaos_env:
            import random as _random

            _chaos_rng = _random.Random(int(_chaos_env))
            _chaos_lock = threading.Lock()

            def _jitter():
                with _chaos_lock:
                    d = _chaos_rng.random() * 0.002
                _time.sleep(d)
        else:
            def _jitter():
                pass

        def _job(ctx):
            _jitter()
            ctx = finish_rewrite(ctx)
            _jitter()
            if ctx is not None and ctx.get("deferred"):
                return ("defer", ctx)
            return finish_realign(ctx)

        def _job_full(lines, rec_base, task_base, nrec):
            # parse included: record/task numbering was precomputed on main
            # from the scan mask, so the whole batch is order-free
            ctx = start_batch(lines, rec_base, nrec)
            ctx["task_base"] = task_base
            return _job(ctx)

        def _dispatch_aggregate(ctxs):
            """ONE realign dispatch for the pooled runs of several batches.

            Per-batch pads differ, so blocks re-pad into a common
            (S_bucket, Rmax/Qmax) layout (bucketed so XLA compiles a
            bounded set of variants); results come back as row slices.
            Returns (parts [(lo, hi)], fetch_future, steps)."""
            from ..ops.realign_batch import (
                pack_realign_refgather2_input as _pack_rg2,
                pack_realign_refgather2_input_q as _pack_rg2_q,
                pack_realign_refgather_input as _pack_rg,
                pack_realign_refgather_input_q as _pack_rg_q,
                pack_realign_wire_input as _pack_wire,
                pack_realign_wire_input_q as _pack_wire_q,
                query_wire2_eligible as _wire2_eligible,
                realign_device_kernel as _kern,
                realign_device_kernel_wire as _kern_wire,
                realign_device_kernel_wire_q as _kern_wire_q,
                realign_device_kernel_wire_refgather as _kern_wire_rg,
                realign_device_kernel_wire_refgather2 as _kern_wire_rg2,
                realign_device_kernel_wire_refgather2_q as _kern_wire_rg2_q,
                realign_device_kernel_wire_refgather_q as _kern_wire_rg_q,
                unpack_realign_refgather_wire as _unpack_rg,
                unpack_realign_wire as _unpack_wire,
            )

            _jitter()
            t0 = _time.perf_counter_ns()
            tp0 = _time.perf_counter()
            # pad to the {p, 1.5p} ladder of the ACTUAL max run lengths —
            # the per-batch blocks are pow2-padded (stage_realign_runs),
            # but their columns beyond each row's length are zeros, so
            # narrower aggregate pads just slice them (48x48 runs: 64x64
            # pow2 pads -> 48x48, 1.78x fewer padded DP cells and R wire
            # bytes)
            Rmax = _next_rq_bucket(max(
                int(np.max(np.frombuffer(c["agg"][2], np.int32), initial=1))
                for c in ctxs
            ))
            Qmax = _next_rq_bucket(max(
                int(np.max(np.frombuffer(c["agg"][3], np.int32), initial=1))
                for c in ctxs
            ))
            S_tot = sum(c["agg"][6] for c in ctxs)
            S_b = _next_row_bucket(max(S_tot, 256))
            steps = Rmax + Qmax
            # the -q wires return the 2-bit-packed traceback, so they also
            # need steps % 4 == 0 (the pow2 buckets guarantee it)
            wire_ok = (
                steps % 2 == 0 and steps < 256
                and (not use_quality or steps % 4 == 0)
            )

            # ref-gather eligibility: every run's dst contig must be in the
            # current flat-reference snapshot (taken under bp's ref lock —
            # main may stream new contigs in concurrently)
            rg_starts = rg_flat = None
            snap_rg = (
                bp.ref_flat_snapshot(refgather_max_h2d)
                if wire_ok and refgather_ok and steps % 4 == 0
                else None
            )
            if snap_rg is not None:
                flat, offmap = snap_rg
                if flat.shape[0] <= 0xFFFFFFFF:
                    off_lut = np.full(
                        max(1, len(dst_entries)), -1, np.int64
                    )
                    for rid_, o_ in offmap.items():
                        off_lut[rid_] = o_
                    starts = np.zeros(S_b, np.int64)
                    off = 0
                    for c in ctxs:
                        rid_arr, loc_arr = c["agg_rid_loc"]
                        n_real = len(rid_arr)
                        if n_real:
                            so = off_lut[rid_arr]
                            if (so < 0).any():
                                starts = None
                                break
                            starts[off:off + n_real] = so + loc_arr
                        off += c["agg"][6]
                    if starts is not None:
                        rg_starts, rg_flat = starts, flat

            ref = None if rg_starts is not None else np.zeros(
                (S_b, Rmax), np.uint8
            )
            qb = np.zeros((S_b, Qmax), np.uint8)
            rl = np.zeros(S_b, np.int32)
            ql = np.zeros(S_b, np.int32)
            qq = None
            if use_quality:
                if Rmax + Qmax > 5461:
                    raise ValueError(
                        "quality-scored realignment run too long for the "
                        f"exact quantised path (R+Q={Rmax + Qmax})"
                    )
                # ref quals are phred42-max by the reference's rule (rq=None
                # in the kernel); query quals ship as u8
                qq = np.zeros((S_b, Qmax), np.uint8)
            parts = []
            off = 0
            for c in ctxs:
                ref_b, q_b, rl_b, ql_b, Rp, Qp, S, rq_b, qq_b = c["agg"]
                # blocks may be padded WIDER than the aggregate buckets
                # (pow2 vs the 1.5p ladder); columns past each row's real
                # length are zeros, so slicing them off is exact
                rc = min(Rp, Rmax)
                qc = min(Qp, Qmax)
                if ref is not None:
                    ref[off:off + S, :rc] = np.frombuffer(
                        ref_b, np.uint8
                    ).reshape(S, Rp)[:, :rc]
                qb[off:off + S, :qc] = np.frombuffer(
                    q_b, np.uint8
                ).reshape(S, Qp)[:, :qc]
                rl[off:off + S] = np.frombuffer(rl_b, np.int32)
                ql[off:off + S] = np.frombuffer(ql_b, np.int32)
                if use_quality:
                    qq[off:off + S, :qc] = np.frombuffer(
                        qq_b, np.int32
                    ).reshape(S, Qp)[:, :qc].astype(np.uint8)
                parts.append((off, off + S))
                off += S

            # sort the window's runs by total length (groups equal-length
            # runs; the XLA scans run fixed trip counts, so on its own this
            # saves no device time — ROADMAP design debt).  Output order is
            # restored by inverse permutation at fetch — bit-identical.
            # PANVC3_DP_AGG_SORT=0 reverts.
            diag["dispatches"] += 1
            diag["runs"] += S_tot
            inv_order = None
            if agg_sort and S_tot > 1:
                key = rl[:S_tot] + ql[:S_tot]
                if np.any(key[:-1] > key[1:]):
                    diag["sorted"] += 1
                    order = np.argsort(key, kind="stable")
                    inv_order = np.empty_like(order)
                    inv_order[order] = np.arange(len(order), dtype=order.dtype)
                    rl[:S_tot] = rl[:S_tot][order]
                    ql[:S_tot] = ql[:S_tot][order]
                    qb[:S_tot] = qb[:S_tot][order]
                    if ref is not None:
                        ref[:S_tot] = ref[:S_tot][order]
                    if qq is not None:
                        qq[:S_tot] = qq[:S_tot][order]
                    if rg_starts is not None:
                        rg_starts[:S_tot] = rg_starts[:S_tot][order]

            def _restore(o, c2):
                _jitter()  # fetch-thread completion timing
                if inv_order is None:
                    return np.ascontiguousarray(o), np.ascontiguousarray(c2)
                return (
                    np.ascontiguousarray(o[inv_order]),
                    np.ascontiguousarray(c2[inv_order]),
                )

            # 2-bit query wire: N-free windows ship 2-bit base codes and
            # u8 lens (Q/4+6 B/run vs Q/2+8), a quarter of the query
            # bytes of the staged rows.  PANVC3_DP_WIRE2=0
            # reverts to the 4-bit wire.
            wire2 = (
                rg_starts is not None
                and Qmax % 4 == 0
                and os.environ.get("PANVC3_DP_WIRE2") != "0"
                and _wire2_eligible(qb, ql)
                and (not use_quality or int(qq.max(initial=0)) < 64)
            )
            if rg_starts is not None:
                diag["refgather"] += 1
            if wire2:
                diag["wire2"] += 1
            if rg_starts is not None:
                if use_quality:
                    from ..align import MALDE_SCALE

                    if wire2:
                        rh = _kern_wire_rg2_q(
                            _pack_rg2_q(qb, rg_starts, rl, ql, qq), rg_flat,
                            go * MALDE_SCALE, ge * MALDE_SCALE, Rmax, Qmax,
                        )
                    else:
                        rh = _kern_wire_rg_q(
                            _pack_rg_q(qb, rg_starts, rl, ql, qq), rg_flat,
                            go * MALDE_SCALE, ge * MALDE_SCALE, Rmax, Qmax,
                        )
                elif wire2:
                    rh = _kern_wire_rg2(
                        _pack_rg2(qb, rg_starts, rl, ql), rg_flat, go, ge,
                        Rmax, Qmax,
                    )
                else:
                    rh = _kern_wire_rg(
                        _pack_rg(qb, rg_starts, rl, ql), rg_flat, go, ge,
                        Rmax, Qmax,
                    )

                def _fetch():
                    w = jax.device_get(rh)
                    o, c2 = _unpack_rg(np.asarray(w)[:S_tot], steps)
                    return _restore(o, c2)
            elif wire_ok:
                if use_quality:
                    from ..align import MALDE_SCALE

                    rh = _kern_wire_q(
                        _pack_wire_q(ref, qb, rl, ql, qq),
                        go * MALDE_SCALE, ge * MALDE_SCALE, Rmax, Qmax,
                    )

                    def _fetch():
                        w = jax.device_get(rh)
                        o, c2 = _unpack_rg(np.asarray(w)[:S_tot], steps)
                        return _restore(o, c2)
                else:
                    rh = _kern_wire(
                        _pack_wire(ref, qb, rl, ql), go, ge, Rmax, Qmax
                    )

                    def _fetch():
                        w = jax.device_get(rh)
                        o, c2 = _unpack_wire(np.asarray(w)[:S_tot], steps)
                        return _restore(o, c2)
            else:
                if use_quality:
                    from ..align import MALDE_SCALE

                    kgo, kge = go * MALDE_SCALE, ge * MALDE_SCALE
                    rqa, qqa = None, qq
                else:
                    kgo, kge = go, ge
                    rqa = np.zeros((1, 1), np.int32)
                    qqa = np.zeros((1, 1), np.int32)
                rh = _kern(
                    ref, qb, rl, ql, kgo, kge, rqa, qqa, use_quality,
                    Rmax, Qmax,
                )

                def _fetch():
                    o, c2 = jax.device_get(rh)
                    return _restore(
                        np.asarray(o)[:S_tot], np.asarray(c2)[:S_tot]
                    )

            # spread the shared dispatch cost across the window's batches
            # so per-batch stage_ns (and the dev_ns_batch EMA fed from it)
            # reflects the amortized device cost, not a lopsided ctxs[0]
            share = (_time.perf_counter_ns() - t0) // len(ctxs)
            for c in ctxs:
                c["stage_ns"] = c.get("stage_ns", 0) + share
            if _PROF:
                _tick("agg_pack_dispatch", tp0)
                with _prof_lock:
                    prof["agg_dispatches"] = prof.get("agg_dispatches", 0) + 1
                    prof["agg_runs"] = prof.get("agg_runs", 0) + S_tot

                inner = _fetch

                def _fetch():
                    tf0 = _time.perf_counter()
                    res = inner()
                    _tick("agg_fetch_wall", tf0)
                    return res

            return parts, fetch_pool.submit(_fetch), steps

        def _finish_deferred(ctx, agg_fut, lo, hi, steps):
            _jitter()
            t0 = _time.perf_counter_ns()
            ops_all, cnt_all = agg_fut.result()
            ctx["agg_fetch_ns"] = _time.perf_counter_ns() - t0
            ctx["realn_override"] = (ops_all[lo:hi], cnt_all[lo:hi], steps)
            return finish_realign(ctx)

        def _writer():
            # Ordered drain with a DP-aggregation window: job results are
            # payloads (emit-ready) or deferred ctxs (runs staged, realign
            # pending).  Deferred ctxs accumulate until the window holds
            # agg_target_runs (or agg_max_batches), then ONE aggregate
            # kernel dispatch covers them and per-batch phase-2 jobs
            # (slice + splice) go back to the pool.  out_q preserves
            # submission order end to end; all shared mutation stays here.
            import collections as _collections

            out_q: _collections.deque = _collections.deque()
            window: list = []  # (entry, ctx) pairs awaiting dispatch
            window_runs = 0

            def flush():
                nonlocal window, window_runs
                if not window:
                    return
                parts, agg_fut, steps = _dispatch_aggregate(
                    [c for _, c in window]
                )
                for (entry, ctx), (lo, hi) in zip(window, parts):
                    entry[1] = pool.submit(
                        _finish_deferred, ctx, agg_fut, lo, hi, steps
                    )
                    entry[0] = "fut"
                window = []
                window_runs = 0

            def drain(block: bool):
                while out_q:
                    kind, val = out_q[0]
                    if kind == "done":
                        emit(val)
                        out_q.popleft()
                    elif kind == "fut":
                        if block or val.done():
                            emit(val.result())
                            out_q.popleft()
                        else:
                            return
                    else:  # pending: needs a window flush first
                        if not block:
                            return
                        flush()

            while True:
                fut = job_q.get()
                _jitter()
                if fut is None:
                    try:
                        flush()
                        drain(block=True)
                    except BaseException as exc:  # noqa: BLE001
                        worker_error.append(exc)
                    return
                try:
                    res = fut.result()
                    if isinstance(res, tuple) and res and res[0] == "defer":
                        ctx = res[1]
                        entry = ["pending", ctx]
                        out_q.append(entry)
                        window.append((entry, ctx))
                        window_runs += ctx["agg"][6]
                        if (
                            window_runs >= agg_target_runs
                            or len(window) >= agg_max_batches
                        ):
                            flush()

                    else:
                        out_q.append(["done", res])
                    drain(block=False)
                    # flush-on-idle: if no further staged batch is ready
                    # and the window already holds a worthwhile dispatch,
                    # send it NOW — the device computes and the wire moves
                    # while later batches stage, instead of one big
                    # serialized dispatch+fetch tail at the end of the
                    # stream (measured: the tail was ~75% of the forced-
                    # device realign-heavy wall).  agg_min_runs keeps the
                    # fixed per-dispatch cost (round trip + launch)
                    # amortized.
                    if (
                        window_runs >= agg_min_runs
                        and job_q.empty()
                    ):
                        flush()
                        drain(block=False)
                    # a deferred head must not dam up completed payloads
                    # behind it indefinitely (memory): force the window out
                    # once a queue's worth of batches is waiting on it
                    if (
                        out_q
                        and out_q[0][0] == "pending"
                        and len(out_q) >= agg_max_batches
                    ):
                        flush()
                        drain(block=False)
                    if len(out_q) > 4 * agg_max_batches:
                        flush()
                        # hard cap: block on the head until the queue
                        # shrinks (everything is dispatched at this point)
                        while len(out_q) > 2 * agg_max_batches:
                            kind, val = out_q.popleft()
                            emit(val.result() if kind == "fut" else val)
                except BaseException as exc:
                    worker_error.append(exc)
                    while True:
                        if job_q.get() is None:
                            return

        writer_thread = threading.Thread(target=_writer, daemon=True)
        writer_thread.start()
    else:
        MAX_IN_FLIGHT = max(1, cfg.pipeline_depth)

    import collections

    in_flight: collections.deque = collections.deque()
    realign_flight: collections.deque = collections.deque()

    # Parse CAN ride in the pool jobs (record/task numbering is precomputed
    # from the scan mask), but measured on 4 cores it LOSES at sustained
    # load — the parse prepass and glue hold the GIL on pool threads and
    # convoy the other jobs (920-942k with parse on main vs 579-637k in
    # pool on the 393k-read workload).  Opt-in for wider machines.  It
    # also requires the event-geometry path: the gap-kernel fallback
    # mutates bp._ensure_refs, which must stay sequential on main.
    parse_in_pool = (
        pool is not None
        and event_geo is not None
        and os.environ.get("PANVC3_PARSE_IN_POOL") == "1"
    )

    def submit(lines, kept_exp, nrec):
        # record/task numbering is deterministic per batch: nrec comes from
        # the scan mask and the task groups are ceil(kept/4) CHUNK_SIZE=4
        # groups (project_alignments.cc:596-615), so both bases are
        # assigned here in submission order even though the batches
        # themselves may parse/complete out of order
        rec_base = state["rec_global"]
        state["rec_global"] += nrec
        task_base = state["task_counter"]
        state["task_counter"] += (kept_exp + 3) // 4
        if pool is not None:
            if worker_error:
                raise worker_error[0]
            if parse_in_pool:
                job_q.put(
                    pool.submit(_job_full, lines, rec_base, task_base, nrec)
                )
            else:
                ctx = start_batch(lines, rec_base, nrec)
                ctx["task_base"] = task_base
                job_q.put(pool.submit(_job, ctx))
        else:
            ctx = start_batch(lines, rec_base, nrec)
            ctx["task_base"] = task_base
            in_flight.append(ctx)
            if len(in_flight) >= MAX_IN_FLIGHT:
                realign_flight.append(finish_rewrite(in_flight.popleft()))
                if len(realign_flight) >= MAX_IN_FLIGHT:
                    emit(finish_realign(realign_flight.popleft()))

    # Batches are formed over KEPT records (exactly batch_size per batch)
    # so the 4-record task groups of the record-index tag partition exactly
    # like the object path's chunk loop (project_alignments.cc:596-615).
    # keep_buf entries: 2 kept, 1 skipped record, 0 whitespace-only.
    lines_buf: list[bytes] = []
    keep_buf = np.zeros(0, dtype=np.uint8)
    kept_in_buf = 0

    def form_batches(eof: bool = False):
        nonlocal lines_buf, keep_buf, kept_in_buf
        while kept_in_buf >= batch_size or (eof and lines_buf):
            if kept_in_buf >= batch_size:
                cut = int(
                    np.searchsorted(
                        np.cumsum(keep_buf == 2), batch_size
                    )
                ) + 1
                batch = lines_buf[:cut]
                nrec = int((keep_buf[:cut] >= 1).sum())
                kept_exp = batch_size
                lines_buf = lines_buf[cut:]
                keep_buf = keep_buf[cut:]
                kept_in_buf -= batch_size
            else:
                batch = lines_buf
                nrec = int((keep_buf >= 1).sum())
                kept_exp = kept_in_buf
                lines_buf = []
                keep_buf = np.zeros(0, dtype=np.uint8)
                kept_in_buf = 0
            n_before = state["rec_global"]
            if n_before and (n_before // 10_000_000) != (
                (n_before + nrec) // 10_000_000
            ):
                log_time(f"Processed {n_before + nrec} alignments…")
            reporter.tick(n_before)
            submit(batch, kept_exp, nrec)

    try:
        for block in reader.raw_record_line_blocks():
            mask = np.frombuffer(
                nat.scan_keep_mask(block, FLAG_SKIP, primary_mask), np.uint8
            )
            lines_buf += block
            keep_buf = np.concatenate([keep_buf, mask])
            kept_in_buf += int((mask == 2).sum())
            form_batches()
        form_batches(eof=True)
    finally:
        if writer_thread is not None:
            job_q.put(None)
            writer_thread.join()
        if pool is not None:
            pool.shutdown(wait=True)
            if hasattr(nat, "set_slab_threads"):
                nat.set_slab_threads(0)
        if fetch_pool is not None:
            fetch_pool.shutdown(wait=True)
    if worker_error:
        raise worker_error[0]
    while in_flight:
        realign_flight.append(finish_rewrite(in_flight.popleft()))
    while realign_flight:
        emit(finish_realign(realign_flight.popleft()))
    bp.realignment_time_ns += state["realign_stage_ns"] + state["realign_fetch_ns"]
    if _PROF:
        total = sum(prof.values())
        parts = ", ".join(f"{k} {v:.3f}s" for k, v in sorted(prof.items()))
        log_time(f"[fastlane prof] {parts} (sum {total:.3f}s)")


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p <<= 1
    return p


def _next_bucket(n: int, floor: int) -> int:
    """Smallest {p, 1.5p} ladder value >= max(n, floor) (p a power of
    two).  A pure pow2 ladder wastes up to 2x padding just above a
    boundary; the half-octave step bounds the waste at 33% while keeping
    the compiled shape set small (two per octave)."""
    p = floor
    while p < n:
        if p + (p >> 1) >= n:
            return p + (p >> 1)
        p <<= 1
    return p


def _next_row_bucket(n: int) -> int:
    """Row (run-count) bucket for the aggregate realign dispatch."""
    return _next_bucket(n, 1)


def _next_rq_bucket(n: int) -> int:
    """R/Q pad bucket for the aggregate dispatch: the ladder from 8 up.
    Every value is divisible by 4 (p pow2 >= 8, and 1.5p with p >= 8), so
    the wire constraints (4-bit query packing needs even Q, 2-bit op
    packing needs steps % 4 == 0) hold for any R/Q combination.  A
    pow2-only ladder wasted up to 2x DP compute AND wire per axis (the
    bench's 48x48 runs padded to 64x64 = 1.78x padded cells)."""
    return _next_bucket(n, 8)
