"""panvc3_tpu — a pan-genome alignment-projection engine in JAX, run on an
NVIDIA GPU.

A ground-up reimplementation of the capabilities of tsnorri/panvc3
(reference-bias-free variant-calling preprocessing: project alignments made
against founder sequences back to standard-reference coordinates), designed
for an accelerator:

- the per-record, pointer-chasing streaming design of the reference is
  replaced by host-side batching into fixed-shape arrays and data-parallel
  JAX/XLA/Pallas device kernels;
- rank/select over gap bitvectors (reference: sdsl::rrr_vector,
  msa_index.hh:239-258) becomes packed-bit tensors with block-rank tables and
  vectorised popcount gathers;
- the realignment DP (reference: seqan3 align_pairwise, align.hh:59-112)
  becomes one batched fill + traceback program (XLA row scans);
- multi-chip scaling uses jax.sharding Mesh + shard_map over the record batch
  dimension.

Subpackages
-----------
- ``panvc3_tpu.cigar``      CIGAR codes, RLE buffers, equality predicate
- ``panvc3_tpu.bitvec``     packed gap bitvectors with rank0/select0
- ``panvc3_tpu.msa_index``  the MSA coordinate index (build/save/load/query)
- ``panvc3_tpu.rewrite``    CIGAR rewriting between MSA coordinates
- ``panvc3_tpu.indel_runs`` detection of I+D runs for realignment
- ``panvc3_tpu.align``      affine-gap global realignment (host oracle)
- ``panvc3_tpu.projector``  full alignment projection (rewrite+realign)
- ``panvc3_tpu.ops``        JAX/Pallas device kernels (batched versions)
- ``panvc3_tpu.io``         SAM/FASTA/BED/VCF I/O
- ``panvc3_tpu.pipeline``   tool pipelines (project_alignments, …)
- ``panvc3_tpu.parallel``   mesh/sharding utilities
"""

__version__ = "0.1.0"
