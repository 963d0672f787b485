"""Microbench of the fused projection kernel only (device-resident inputs,
single fori_loop dispatch) — for A/B-ing kernel formulations on the real
chip without running the whole bench.

Usage: python tools/bench_fused.py [batch_size] [iters]
Prints ms/iter and reads/s; also a SHA of the kernel outputs so two
formulations can be checked for wire identity across runs.
"""

import hashlib
import sys
import time

sys.path.insert(0, ".")

import numpy as np  # noqa: E402

from bench import build_index_entries, synthesise_records  # noqa: E402
from panvc3_tpu.utils import enable_compile_cache  # noqa: E402


def main() -> None:
    batch_size = int(sys.argv[1]) if len(sys.argv) > 1 else 8192
    iters = int(sys.argv[2]) if len(sys.argv) > 2 else 20
    enable_compile_cache()

    import jax
    import jax.numpy as jnp
    from functools import partial

    from panvc3_tpu.alphabet import normalise_dna5
    from panvc3_tpu.ops.engine import BatchProjector, _next_pow2
    from panvc3_tpu.ops.fused import fused_projection_kernel
    from panvc3_tpu.ops.rewrite_batch import expand_cigars

    src_entries, dst_entries, ref_id_mapping, ref_seq, founders = build_index_entries()
    records = synthesise_records(founders, batch_size)

    bp = BatchProjector(src_entries, dst_entries, ref_id_mapping, 0, -1)
    bp._ensure_refs({0: ref_seq})
    recs = records[:batch_size]
    queries = [normalise_dna5(rec.seq) for rec in recs]
    cigars = [rec.cigar for rec in recs]
    max_ops = max(len(c) for c in cigars)
    max_ref_units = max(sum(c for c, op in cig if op in "M=XDN") for cig in cigars)
    batch = expand_cigars(
        cigars,
        [rec.pos for rec in recs],
        queries,
        [bp.src_dev_ids[rec.ref_id] for rec in recs],
        [bp.dst_dev_ids[ref_id_mapping[rec.ref_id]] for rec in recs],
        [0] * len(recs),
        pad_ops=_next_pow2(max_ops),
        pad_ref_units=max(2, _next_pow2(max_ref_units)),
        pad_query=max(2, _next_pow2(max(len(q) for q in queries))),
    )
    dev = [
        jax.device_put(x)
        for x in (
            batch.src_seq, batch.dst_seq, batch.rec_src_pos, batch.ref_off,
            batch.ops, batch.counts, batch.query,
        )
    ]
    R = batch.pad_ref_units
    U = R + batch.ops.shape[1]
    pool = max(256, len(recs) // 2)
    go, ge = np.float32(0), np.float32(-1)
    ref_flat_dev = bp.ref_flat_dev
    dev_index = bp.index

    mode_early = sys.argv[3] if len(sys.argv) > 3 else ""
    if not (mode_early.startswith("v4") and mode_early != "v4"):
        # wire-identity check: one plain call, hash all outputs
        out = fused_projection_kernel(
            dev_index, ref_flat_dev, *dev, go, ge, R, U,
            BatchProjector.FUSED_RUN_PAD, BatchProjector.FUSED_RUN_PAD, pool,
        )
        h = hashlib.sha256()
        for arr in jax.device_get(out):
            h.update(np.ascontiguousarray(arr).tobytes())
        print(f"[fused-bench] output sha256 {h.hexdigest()[:16]}", file=sys.stderr)

    @partial(jax.jit, static_argnames=("n_iters", "stage"))
    def fused_loop(args, n_iters, stage):
        def body(i, carry):
            acc, query = carry
            query = query.at[0, 0].set((acc % 4 + 65).astype(jnp.uint8))
            o = fused_projection_kernel(
                dev_index, ref_flat_dev, *args[:6], query, go, ge, R, U,
                BatchProjector.FUSED_RUN_PAD, BatchProjector.FUSED_RUN_PAD,
                pool, stage,
            )
            return acc + o[5][2], query
        return jax.lax.fori_loop(0, n_iters, body, (jnp.int32(0), args[6]))[0]

    mode = sys.argv[3] if len(sys.argv) > 3 else ""
    stages = (
        (0, 1, 2, 3, 4, 5) if mode == "stages"
        else () if mode.startswith("v4")
        else (5,)
    )
    names = {
        0: "rewrite_math", 1: "+unit expand", 2: "+token stream",
        3: "+compaction", 4: "+slice gather", 5: "full",
    }
    for stage in stages:
        jax.block_until_ready(fused_loop(dev, iters, stage))
        best = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            jax.block_until_ready(fused_loop(dev, iters, stage))
            dt = time.perf_counter() - t0
            best = min(best, dt)
        print(
            f"[fused-bench] stage {stage} ({names[stage]}): "
            f"{best / iters * 1e3:.2f} ms/iter "
            f"{batch_size * iters / best:,.0f} reads/s"
        )

    # ---- fused v4 (event-geometry rewrite + segment-space run detection) --
    from panvc3_tpu.ops.event_geometry import DeviceEventGeometry, EventGeometry
    from panvc3_tpu.ops.fused_event import _fused_event_body

    host_geo = EventGeometry(src_entries, dst_entries, ref_id_mapping)
    geo = DeviceEventGeometry(host_geo)
    rid = jax.device_put(np.asarray([rec.ref_id for rec in recs], np.int32))
    n_units_dev = jax.device_put(np.asarray(batch.n_ref_units))

    _v4_jit = jax.jit(
        partial(_fused_event_body, geo),
        static_argnames=("R", "run_r", "run_q", "slot_pool", "_stage"),
    )
    outs4 = _v4_jit(
        ref_flat_dev, rid, dev[2], n_units_dev, dev[3], dev[4], dev[5],
        dev[6], go, ge, R=R, run_r=BatchProjector.FUSED_RUN_PAD,
        run_q=BatchProjector.FUSED_RUN_PAD, slot_pool=pool,
    )
    flags4 = jax.device_get(outs4[7])
    print(f"[fused-bench] v4 flags {flags4.tolist()}", file=sys.stderr, flush=True)

    @partial(jax.jit, static_argnames=("n_iters", "stage"))
    def fused_v4_loop(args, rid_, nu, n_iters, stage):
        def body(i, carry):
            acc, pos = carry
            pos = pos.at[0].set(acc % 7)
            o = _fused_event_body(
                geo, ref_flat_dev, rid_, pos, nu, args[3], args[4], args[5],
                args[6], go, ge, R, BatchProjector.FUSED_RUN_PAD,
                BatchProjector.FUSED_RUN_PAD, pool, stage,
            )
            # depend on wire + realign outputs so nothing dead-codes away
            acc = (
                acc + o[7][2] + jnp.sum(o[0])
                + jnp.sum(o[1]).astype(jnp.int32)
                + jnp.sum(o[5]).astype(jnp.int32) + jnp.sum(o[6])
            )
            return acc, pos
        return jax.lax.fori_loop(0, n_iters, body, (jnp.int32(0), args[2]))[0]

    v4_names = {
        0: "event slots", 1: "+wire pack", 2: "+boundaries", 3: "+rank sort",
        4: "+seg decode", 5: "+tokens/runs", 6: "+compaction", 7: "+slices",
        9: "full",
    }
    v4_stages = (
        (0, 1, 2, 3, 4, 5, 6, 7, 9)
        if mode == "stages"
        else (0, 3, 5, 7, 9) if mode == "v4stages"
        else (1, 6, 7, 9) if mode == "v4b"
        else tuple(int(s) for s in mode[3:].split(",")) if mode.startswith("v4:")
        else (9,)
    )
    for stage in v4_stages:
        jax.block_until_ready(fused_v4_loop(dev, rid, n_units_dev, iters, stage))
        best = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            jax.block_until_ready(fused_v4_loop(dev, rid, n_units_dev, iters, stage))
            dt = time.perf_counter() - t0
            best = min(best, dt)
        print(
            f"[fused-bench] v4 stage {stage} ({v4_names[stage]}): "
            f"{best / iters * 1e3:.2f} ms/iter "
            f"{batch_size * iters / best:,.0f} reads/s",
            flush=True,
        )


if __name__ == "__main__":
    main()
