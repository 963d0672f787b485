#!/usr/bin/env python
"""Smoke run of the projection pipeline on one NVIDIA GPU, at chromosome
scale, through the tools' own command-line entry points.

    python chip_smoke.py             # one card: every phase below
    python chip_smoke.py --cards 4   # four cards: the data-parallel path only

Phases, in order (each prints its findings; any failure ends the run with
a non-zero exit):

  tests    the card-only tests (pytest -m gpu), in a child process that
           exits before this process opens the card
  device   the card's name and power limit (nvidia-smi) and JAX's view of
           it; fails unless JAX's platform is "gpu"
  native   builds _panvc3_native from native/*.c into panvc3_tpu/native_build/
           and fails unless it loads
  data     a founder MSA made from --seed: REF plus 3 founders over 64 Mi
           aligned columns (about GRCh38 chr20), its reference FASTA,
           1,048,576 mixed-CIGAR 100-bp reads and 262,144 realign-heavy reads
  index    index_msa --build-index, then the device bytes of the index
           structures (gap index, select tables, flat reference, event tables)
  tools    project_alignments (defaults; -q; realign-heavy adaptive and with
           the device DP lane forced) and recalculate_mapq; every output
           matches the host oracle on its first 20,000 records, and the
           adaptive and forced-device outputs match at full size
  dp       the realignment DP as XLA compiles it for the card, at the fast
           lane's real widths, against the host C DP and the Python oracle,
           timed at scan unroll 1 and 4

Times printed here are smoke timings of one run, not benchmark cells.  The
last line of standard output is one JSON object naming the device.  After
the tests phase the whole run is one process, so one process holds the
card at any time.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import pathlib
import shutil
import subprocess
import sys
import sysconfig
import tempfile
import time

REPO = pathlib.Path(__file__).resolve().parent

N_COLS = 64 << 20
ROWS = ("REF", "F1", "F2", "F3")
CHR = "chr20"
N_MIXED = 1 << 20
N_HEAVY = 1 << 18
READ_LEN = 100
ORACLE_PREFIX = 20_000
# (runs, R, Q): the fast lane's aggregate window of short runs, and a
# window of realign-heavy 48x48 runs
DP_SHAPES = ((16384, 16, 16), (131072, 48, 48))

# fastlane's per-stage profile, read when the package is imported
os.environ.setdefault("PANVC3_FASTLANE_PROF", "1")


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def peak_bytes(device) -> int:
    return device.memory_stats()["peak_bytes_in_use"]


# -- tests ------------------------------------------------------------------

def tests_phase() -> None:
    """The tests marked ``gpu`` on the card; they skip on the CPU, so a run
    that skips any of them fails here."""
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-m", "gpu", "-rs",
         "-p", "no:cacheprovider", "tests/"],
        cwd=REPO, env={**os.environ, "JAX_PLATFORMS": "cuda"},
        capture_output=True, text=True,
    )
    summary = proc.stdout.strip().splitlines()[-1] if proc.stdout.strip() else ""
    if proc.returncode != 0 or "skipped" in summary or "passed" not in summary:
        sys.stdout.write(proc.stdout[-4000:])
        raise RuntimeError(f"tests: pytest -m gpu: {summary or proc.returncode}")
    log("tests", f"pytest -m gpu on the card: {summary} "
        f"({time.perf_counter() - t0:.1f} s)")


# -- device -----------------------------------------------------------------

def device_phase(n_cards: int) -> tuple[dict, str]:
    import jax

    devs = jax.devices()
    d0 = devs[0]
    log("device", f"jax {jax.__version__}: platform={d0.platform} "
        f"kind={d0.device_kind} count={len(devs)}")
    if d0.platform != "gpu":
        raise SystemExit("chip_smoke: JAX found no GPU; nothing was measured")
    if len(devs) < n_cards:
        raise SystemExit(f"chip_smoke: {n_cards} cards asked, {len(devs)} found")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()
    card = smi[0].strip()
    for line in smi:
        print(line.strip(), flush=True)
    from panvc3_tpu.utils import enable_compile_cache

    log("device", f"compile cache: {enable_compile_cache()}")
    return {"platform": d0.platform, "kind": d0.device_kind,
            "count": len(devs)}, card


# -- native -----------------------------------------------------------------

def native_phase() -> None:
    """Compile the host extension straight from native/*.c with the flags
    of native/setup.py (no setuptools needed), in parallel."""
    t0 = time.perf_counter()
    out_dir = REPO / "panvc3_tpu" / "native_build"
    shutil.rmtree(out_dir, ignore_errors=True)
    out_dir.mkdir(parents=True)
    cc = os.environ.get("CC") or shutil.which("cc") or "gcc"
    flags = ["-O3", "-march=native", "-pthread", "-ffp-contract=off", "-fPIC",
             f"-I{sysconfig.get_paths()['include']}"]
    sources = sorted((REPO / "native").glob("*.c"))
    with tempfile.TemporaryDirectory() as td:
        objs = [pathlib.Path(td) / (s.stem + ".o") for s in sources]
        procs = [
            subprocess.Popen([cc, *flags, "-c", str(s), "-o", str(o)])
            for s, o in zip(sources, objs)
        ]
        if any(p.wait() for p in procs):
            raise RuntimeError("native: compilation failed")
        target = out_dir / ("_panvc3_native" + sysconfig.get_config_var("EXT_SUFFIX"))
        subprocess.run(
            [cc, "-shared", "-pthread", *map(str, objs), "-lz", "-o", str(target)],
            check=True,
        )
    from panvc3_tpu.native import get_native

    nat = get_native()
    if nat is None or pathlib.Path(nat.__file__).parent != out_dir:
        raise RuntimeError("native: the extension built from the tree did not load")
    log("native", f"built {target.name} from {len(sources)} sources with {cc} "
        f"in {time.perf_counter() - t0:.1f} s; loaded from {nat.__file__}")


# -- data -------------------------------------------------------------------

def make_msa(rng, n_cols: int) -> dict[str, "np.ndarray"]:
    """REF + founders over one consensus: 0.2% substitutions and 3% gap
    columns per row (the density of tools/stress_scale.py)."""
    import numpy as np

    bases = np.frombuffer(b"ACGT", np.uint8)
    consensus = bases[rng.integers(0, 4, n_cols, dtype=np.uint8)]
    rows = {}
    for sid in ROWS:
        row = consensus.copy()
        sub = rng.random(n_cols, dtype=np.float32) < 0.002
        row[sub] = bases[rng.integers(0, 4, int(sub.sum()), dtype=np.uint8)]
        row[rng.random(n_cols, dtype=np.float32) < 0.03] = ord("-")
        rows[sid] = row
    return rows


def _sam_header(founders) -> list[bytes]:
    return [b"@HD\tVN:1.6"] + [
        f"@SQ\tSN:{CHR}/{sid}\tLN:{len(s)}".encode()
        for sid, s in founders.items()
    ]


def _write_sam(path, founders, prefix, fid, pos, cigars, seqs, quals, scores):
    names = [f"{CHR}/{sid}".encode() for sid in founders]
    lines = _sam_header(founders)
    width = len(str(len(pos)))
    for i in range(len(pos)):
        lines.append(b"\t".join((
            f"{prefix}{i:0{width}d}".encode(), b"0", names[fid[i]],
            str(int(pos[i]) + 1).encode(), b"60", cigars[i], b"*", b"0", b"0",
            seqs[i], quals[i], b"AS:i:%d" % scores[i],
        )))
    data = b"\n".join(lines) + b"\n"
    pathlib.Path(path).write_bytes(data)
    return len(lines) - len(founders) - 1


def make_mixed_reads(rng, founders, n, path) -> None:
    """The bench's mixed CIGARs (bench.synthesise_records): a third exact
    100=, a third 50=kD50= and a third 50=kIjD(50-k)=, k, j in 1..5."""
    import numpy as np

    seqs_src = list(founders.values())
    fid = rng.integers(0, len(seqs_src), n)
    kind = np.arange(n) % 3
    k = rng.integers(1, 6, n)
    j = rng.integers(1, 6, n)
    t = np.arange(READ_LEN)[None, :]
    half = READ_LEN // 2
    kk, jj = k[:, None], j[:, None]
    off = np.where(kind[:, None] == 1, t + (t >= half) * kk, t)
    off = np.where(kind[:, None] == 2,
                   np.where(t < half, t, t + jj - kk), off)
    is_ins = (kind[:, None] == 2) & (t >= half) & (t < half + kk)
    seq = np.empty((n, READ_LEN), np.uint8)
    pos = np.empty(n, np.int64)
    for f, s in enumerate(seqs_src):
        sel = np.flatnonzero(fid == f)
        pos[sel] = rng.integers(0, len(s) - READ_LEN - 16, len(sel))
        seq[sel] = s[pos[sel, None] + off[sel]]
    bases = np.frombuffer(b"ACGT", np.uint8)
    seq[is_ins] = bases[rng.integers(0, 4, int(is_ins.sum()))]
    cigars = [
        b"100=" if kd == 0 else
        b"50=%dD50=" % a if kd == 1 else
        b"50=%dI%dD%d=" % (a, b, half - a)
        for kd, a, b in zip(kind.tolist(), k.tolist(), j.tolist())
    ]
    scores = np.where(kind == 0, 0, -(5 + 3 * k))
    scores = np.where(kind == 2, scores - (5 + 3 * j), scores)
    qual = b"I" * READ_LEN
    _write_sam(path, founders, "r", fid, pos, cigars,
               [r.tobytes() for r in seq], [qual] * n, scores.tolist())


def make_heavy_reads(rng, founders, n, path) -> None:
    """bench.synthesise_heavy_records: every read carries one adjacent
    48I48D run (a 48x48 realignment), with random base qualities."""
    import numpy as np

    seqs_src = list(founders.values())
    half = (READ_LEN - 48) // 2
    fid = rng.integers(0, len(seqs_src), n)
    t = np.arange(READ_LEN)[None, :]
    seq = np.empty((n, READ_LEN), np.uint8)
    pos = np.empty(n, np.int64)
    for f, s in enumerate(seqs_src):
        sel = np.flatnonzero(fid == f)
        pos[sel] = rng.integers(0, len(s) - READ_LEN - 16, len(sel))
        # the 48I48D run replaces 48 reference bases in place
        seq[sel] = s[pos[sel, None] + t]
    bases = np.frombuffer(b"ACGT", np.uint8)
    seq[:, half:half + 48] = bases[rng.integers(0, 4, (n, 48))]
    quals = (rng.integers(20, 42, (n, READ_LEN)) + 33).astype(np.uint8)
    cigar = b"%d=48I48D%d=" % (half, READ_LEN - half - 48)
    _write_sam(path, founders, "h", fid, pos, [cigar] * n,
               [r.tobytes() for r in seq], [q.tobytes() for q in quals],
               [-(2 * (5 + 3 * 48))] * n)


def sam_prefix(src, dst, n) -> None:
    """Header plus the first n records of src."""
    out = []
    kept = 0
    with open(src, "rb") as fh:
        for line in fh:
            if not line.startswith(b"@"):
                if kept == n:
                    break
                kept += 1
            out.append(line)
    pathlib.Path(dst).write_bytes(b"".join(out))


def data_phase(work: pathlib.Path, seed: int) -> dict:
    import numpy as np

    t0 = time.perf_counter()
    rng = np.random.default_rng(seed)
    rows = make_msa(rng, N_COLS)
    tsv = []
    for sid, row in rows.items():
        p = work / f"{CHR}.{sid}.txt"
        p.write_bytes(row.tobytes())
        tsv.append(f"{CHR}\t{sid}\t{p}")
    (work / "input.tsv").write_text("\n".join(tsv) + "\n")
    founders = {sid: row[row != ord("-")] for sid, row in rows.items()}
    (work / "ref.fa").write_bytes(
        f">{CHR}\n".encode() + founders["REF"].tobytes() + b"\n"
    )
    make_mixed_reads(rng, founders, N_MIXED, work / "mixed.sam")
    make_heavy_reads(rng, founders, N_HEAVY, work / "heavy.sam")
    for name in ("mixed", "heavy"):
        sam_prefix(work / f"{name}.sam", work / f"{name}.prefix.sam",
                   ORACLE_PREFIX)
    log("data", f"seed {seed}: MSA {len(rows)} rows x {N_COLS:,} columns "
        f"(REF {len(founders['REF']):,} bases); {N_MIXED:,} mixed and "
        f"{N_HEAVY:,} realign-heavy reads; {time.perf_counter() - t0:.1f} s")
    return founders


# -- tools ------------------------------------------------------------------

@contextlib.contextmanager
def env(**kw):
    old = {k: os.environ.get(k) for k in kw}
    os.environ.update(kw)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def tool(argv: list[str]) -> float:
    """One tool run through the CLI entry point; returns its wall seconds."""
    from panvc3_tpu.cli.main import main

    t0 = time.perf_counter()
    rc = main(argv)
    dt = time.perf_counter() - t0
    if rc != 0:
        raise RuntimeError(f"{' '.join(argv[:1])} exited {rc}")
    return dt


def sam_body(path, limit=None) -> tuple[list[bytes], list[bytes]]:
    """(header lines without @PG, first ``limit`` record lines)."""
    header, body = [], []
    with open(path, "rb") as fh:
        for line in fh:
            if line.startswith(b"@"):
                if not line.startswith(b"@PG"):
                    header.append(line)
            else:
                if limit is not None and len(body) == limit:
                    break
                body.append(line)
    return header, body


def same_sam(a, b, limit=None) -> None:
    ha, ba = sam_body(a, limit)
    hb, bb = sam_body(b, limit)
    if ha != hb or ba != bb:
        diff = next((i for i, (x, y) in enumerate(zip(ba, bb)) if x != y),
                    min(len(ba), len(bb)))
        raise AssertionError(
            f"{a.name} and {b.name} differ (records: {len(ba)} vs {len(bb)}; "
            f"first difference at record {diff})"
        )


def project_argv(work, inp, out, *extra) -> list[str]:
    return [
        "project_alignments", f"--alignments={inp}", f"--output-path={out}",
        f"--msa-index={work / 'msa.npz'}", f"--reference={work / 'ref.fa'}",
        "--reference-msa-id=REF", "--ref-id-separator=/",
        "--status-output-interval=0", *extra,
    ]


def build_index(work: pathlib.Path) -> None:
    dt = tool(["index_msa", "--build-index",
               f"--sequence-inputs={work / 'input.tsv'}",
               f"--msa-index-output={work / 'msa.npz'}"])
    log("index", f"index_msa --build-index: {dt:.1f} s, "
        f"{(work / 'msa.npz').stat().st_size:,} bytes on disk")


def index_phase(work: pathlib.Path) -> None:
    import jax
    import numpy as np

    from panvc3_tpu.msa_index import MsaIndex
    from panvc3_tpu.ops.event_geometry import DeviceEventGeometry, EventGeometry
    from panvc3_tpu.ops.rank_select import DeviceGapIndex

    build_index(work)

    t0 = time.perf_counter()
    chrom = MsaIndex.load(str(work / "msa.npz")).find_chr(CHR)
    entries = {e.seq_id: e for e in chrom.sequence_entries}
    src = [entries[sid] for sid in ROWS]
    dev = jax.devices()[0]

    def nbytes(tree) -> int:
        return sum(x.nbytes for x in jax.tree_util.tree_leaves(tree))

    gap = DeviceGapIndex.build([e.gaps for e in src])
    jax.block_until_ready(gap)
    events = DeviceEventGeometry(EventGeometry(src, [entries["REF"]], [0] * 4))
    ref = np.frombuffer((work / "ref.fa").read_bytes().split(b"\n")[1], np.uint8)
    flat = jax.device_put(ref)
    jax.block_until_ready(flat)
    tables = nbytes([gap.zsel, gap.rtab])
    ev = nbytes([v for v in vars(events).values() if isinstance(v, jax.Array)])
    log("index", f"device-resident index of {len(src)} rows x "
        f"{chrom.sequence_entries[0].aligned_length:,} columns: gap index "
        f"{nbytes(gap) - tables:,} B, select/rank tables {tables:,} B, flat "
        f"reference {flat.nbytes:,} B, event tables {ev:,} B; device "
        f"peak_bytes_in_use {peak_bytes(dev):,} B; "
        f"{time.perf_counter() - t0:.1f} s")
    del gap, events, flat


def tools_phase(work: pathlib.Path) -> None:
    from panvc3_tpu.pipeline import fastlane

    def run(name, inp, n, *extra, **env_kw) -> pathlib.Path:
        out = work / f"{name}.out.sam"
        for k in fastlane.AGG_DIAG:
            fastlane.AGG_DIAG[k] = 0
        with env(**env_kw):
            dt = tool(project_argv(work, inp, out, *extra))
        d = fastlane.AGG_DIAG
        log("tools", f"project_alignments {name}: {dt:.2f} s, {n / dt:,.0f} "
            f"reads/s (smoke timing); device DP dispatches {d['dispatches']}, "
            f"runs {d['runs']:,}")
        return out

    def oracle(name, inp, *extra) -> pathlib.Path:
        out = work / f"{name}.host.out.sam"
        dt = tool(project_argv(work, inp, out, "--engine=host", *extra))
        log("tools", f"host oracle {name}: {ORACLE_PREFIX:,} records in {dt:.1f} s")
        return out

    def check(out, ref, limit=ORACLE_PREFIX) -> None:
        same_sam(out, ref, limit)
        log("tools", f"{out.name} == {ref.name} on "
            f"{'all' if limit is None else f'the first {limit:,}'} records")

    mixed, heavy = work / "mixed.sam", work / "heavy.sam"
    mixed_out = run("mixed", mixed, N_MIXED)
    check(mixed_out, oracle("mixed", work / "mixed.prefix.sam"))
    out_q = run("mixed_q", mixed, N_MIXED, "-q")
    check(out_q, oracle("mixed_q", work / "mixed.prefix.sam", "-q"))

    adaptive = run("heavy_adaptive", heavy, N_HEAVY)
    forced = run("heavy_device", heavy, N_HEAVY, PANVC3_HOST_DP="0")
    if fastlane.AGG_DIAG["dispatches"] == 0:
        raise AssertionError("the forced-device run dispatched no device DP")
    check(forced, oracle("heavy", work / "heavy.prefix.sam"))
    check(adaptive, forced, None)

    mapq = work / "mapq.out.sam"
    dt = tool(["recalculate_mapq", f"--alignments={mixed_out}",
               f"--output-path={mapq}", "--status-output-interval=0"])
    log("tools", f"recalculate_mapq: {dt:.2f} s, {N_MIXED / dt:,.0f} records/s "
        "(smoke timing)")
    sam_prefix(mixed_out, work / "mixed.projected.prefix.sam", ORACLE_PREFIX)
    with env(PANVC3_MAPQ_FAST="0"):
        tool(["recalculate_mapq",
              f"--alignments={work / 'mixed.projected.prefix.sam'}",
              f"--output-path={work / 'mapq.host.out.sam'}",
              "--status-output-interval=0"])
    check(mapq, work / "mapq.host.out.sam")


# -- dp ---------------------------------------------------------------------

def dp_phase(card: str, seed: int) -> None:
    import functools

    import jax
    import numpy as np

    from panvc3_tpu.align import MALDE_SCALE, align_global, malde_tables
    from panvc3_tpu.alphabet import PHRED42_MAX
    from panvc3_tpu.cigar import CODE_TO_OP, collapse_cigar
    from panvc3_tpu.native import get_native
    from panvc3_tpu.ops import realign_batch as rb

    nat = get_native()
    mt, xt = malde_tables()

    def scans(ref, query, m, n, go, ge, qq, R, Q, unroll):
        sub = rb._substitution_scores(ref, query, None, qq, qq is not None)
        trace = rb._fill_batch(sub, m, n, go, ge, R, Q, unroll=unroll)
        return rb._traceback_batch(trace, ref, query, m, n, R, Q, unroll=unroll)

    def timed(fn, args, reps=20) -> float:
        jax.block_until_ready(fn(*args))
        ts = []
        for _ in range(reps):
            t0 = time.perf_counter()
            jax.block_until_ready(fn(*args))
            ts.append(time.perf_counter() - t0)
        return float(np.median(ts))

    rng = np.random.default_rng(seed)
    for B, R, Q in DP_SHAPES:
        for quality in (False, True):
            ref = rng.integers(65, 69, (B, R)).astype(np.uint8)
            query = rng.integers(65, 69, (B, Q)).astype(np.uint8)
            n = rng.integers(0, R + 1, B).astype(np.int32)
            m = rng.integers(0, Q + 1, B).astype(np.int32)
            ref[np.arange(R)[None, :] >= n[:, None]] = 0
            query[np.arange(Q)[None, :] >= m[:, None]] = 0
            qq = rng.integers(0, 42, (B, Q)).astype(np.int32) if quality else None
            scale = MALDE_SCALE if quality else 1
            go, ge = np.float32(0 * scale), np.float32(-1 * scale)
            args = jax.device_put((ref, query, m, n, go, ge, qq))
            fns = {u: jax.jit(functools.partial(scans, R=R, Q=Q, unroll=u))
                   for u in (1, 4)}
            t_c = time.perf_counter()
            ops, cnt = jax.device_get(fns[4](*args))
            t_c = time.perf_counter() - t_c
            # the host C DP (itself differential-tested against the oracle)
            if quality:
                host = nat.realign_runs_host(
                    ref.tobytes(), query.tobytes(), n.tobytes(), m.tobytes(),
                    R, Q, float(go), float(ge),
                    np.full((B, R), PHRED42_MAX, np.int32).tobytes(),
                    qq.tobytes(), mt.tobytes(), xt.tobytes())
            else:
                host = nat.realign_runs_host(
                    ref.tobytes(), query.tobytes(), n.tobytes(), m.tobytes(),
                    R, Q, float(go), float(ge))
            ops_h = np.frombuffer(host[0], np.int8).reshape(B, R + Q)
            cnt_h = np.frombuffer(host[1], np.int32)
            live = np.arange(R + Q)[None, :] < cnt[:, None]
            if not (np.array_equal(cnt_h, cnt)
                    and np.array_equal(ops_h[live], ops[live])):
                raise AssertionError(f"device DP != host C DP at {R}x{Q} x {B}")
            # the Python oracle on a sample of runs
            for b in rng.choice(B, 64, replace=False).tolist():
                quals = {}
                if quality:
                    quals = dict(quals1=np.full(n[b], PHRED42_MAX, np.int32),
                                 quals2=qq[b, :m[b]])
                _, cig = align_global(ref[b, :n[b]].tobytes(),
                                      query[b, :m[b]].tobytes(), 0, -1, **quals)
                got = collapse_cigar(
                    [(1, CODE_TO_OP[int(c)]) for c in ops[b, :cnt[b]][::-1]])
                if got != collapse_cigar(cig):
                    raise AssertionError(f"device DP != align_global, run {b}")
            t = {u: timed(f, args) for u, f in fns.items()}
            log("dp", f"{R}x{Q} x {B:,} runs, {'-q' if quality else 'integer'}: "
                f"XLA scans bit-identical to the host C DP and (64 runs) "
                f"align_global; unroll 1 {t[1] * 1e3:.3f} ms, unroll 4 "
                f"{t[4] * 1e3:.3f} ms; first call {t_c:.1f} s; {card}")


# -- four cards ---------------------------------------------------------------

def four_card_phase(work: pathlib.Path) -> None:
    import jax

    one = work / "mixed.sam.1card"
    dt1 = tool(project_argv(work, work / "mixed.sam", one))
    dt4 = tool(project_argv(work, work / "mixed.sam", work / "mixed.4cards.sam",
                            "--data-parallel=4"))
    same_sam(work / "mixed.4cards.sam", one)
    used = [peak_bytes(d) for d in jax.devices()[:4]]
    if min(used) == 0:
        raise AssertionError(f"a card held no data-parallel shard: {used}")
    log("cards", f"project_alignments --data-parallel=4: {dt4:.2f} s "
        f"(one card, default lane: {dt1:.2f} s; smoke timings); output "
        f"identical to the one-card run on all {N_MIXED:,} records; "
        f"peak_bytes_in_use per card {used}")
    sys.path.insert(0, str(REPO))
    import __graft_entry__

    __graft_entry__.dryrun_multichip(4)
    log("cards", "__graft_entry__.dryrun_multichip(4) passed")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--cards", type=int, default=1, choices=(1, 4))
    ap.add_argument("--phases", default="tests,native,data,index,tools,dp",
                    help="comma-separated subset of the one-card phases")
    args = ap.parse_args()

    t_start = time.perf_counter()
    phases = set(args.phases.split(","))
    if args.cards == 1 and "tests" in phases:
        tests_phase()
    device, card = device_phase(args.cards)
    native_phase()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as td:
        work = pathlib.Path(td)
        if args.cards == 4:
            data_phase(work, args.seed)
            build_index(work)
            four_card_phase(work)
        else:
            if phases & {"data", "index", "tools"}:
                data_phase(work, args.seed)
            if "index" in phases or "tools" in phases:
                index_phase(work)
            if "tools" in phases:
                tools_phase(work)
            if "dp" in phases:
                dp_phase(card, args.seed)
    log("done", f"{time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"ok": True, "device": device}), flush=True)


if __name__ == "__main__":
    main()
