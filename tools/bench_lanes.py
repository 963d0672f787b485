#!/usr/bin/env python
"""Measure ONLY the realign-heavy lane rows (device/host/adaptive) from
bench.py — the quick A/B harness for aggregate-dispatch work.  Same
workload and environment knobs as bench.py's _device_lane_metrics."""
from __future__ import annotations

import json
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import bench  # noqa: E402

from panvc3_tpu.utils import enable_compile_cache  # noqa: E402


def main():
    enable_compile_cache()
    (
        cfg, sam, n, records, src_entries, dst_entries, ref_id_mapping,
        ref_seq, founders, batch_size, pipeline_depth,
    ) = bench._setup_headline()
    rows = bench._device_lane_metrics(
        cfg.msa_index_path, cfg.reference_path, founders, src_entries,
        batch_size, pipeline_depth,
    )
    print(json.dumps(rows))


if __name__ == "__main__":
    main()
