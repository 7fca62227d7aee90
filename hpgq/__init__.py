"""hpgq — an accelerator FASTQ QC / preprocessing engine.

A brand-new framework (JAX / XLA / shard_map) with the capabilities of
opencb-hpg/hpg-fastq (reference layout surveyed in SURVEY.md):

* ``stats``  — per-file and per-position QC statistics, optional inline filter,
  optional 5-mer analysis (reference: ``src/stats_fastq.c``, ``src/stats_report.c``).
* ``filter`` — split a FASTQ into passed/failed record sets by length / quality /
  N-count criteria (reference: ``src/filter_fastq.c``).
* ``edit``   — quality-based 5'/3' trimming with optional post-filter
  (reference: ``src/edit_fastq.c``).
* ``prepro`` — legacy preprocessing (``--prep``): fixed-width quality
  end-trim to ``<input>.valid`` files (reference: ``old/README:73-106``).
* ``cgr``    — chaos-game-representation genomic signatures (reference:
  ``old/chaos_game.c``), PGM images, diff vs. a reference-genome signature.
* paired-end processing with pair-consistent discard (reference:
  ``old/main_hpg_fastq_old.c:726-728``, ``old/README:58-60``).

Architecture (accelerator-first, not a port):

* host packer turns FASTQ bytes into padded ``[B, L]`` int8 base-code and
  quality tensors (``hpgq.io``),
* all per-read compute runs as vectorized JAX kernels over those tensors,
  fused by XLA (``hpgq.kernels``),
* histograms/counters accumulate on-device and merge across chips/hosts with
  ``psum`` collectives over a 1-D data mesh (``hpgq.dist``),
* byte-compatible reports are rendered host-side (``hpgq.report``),
* ``hpgq.oracle`` is a pure-numpy executable specification of the reference
  semantics; it doubles as the golden generator and the single-CPU baseline.
"""

__version__ = "1.1.0"


def __getattr__(name):
    """Lazy top-level API (`hpgq.stats(...)` etc.) — keeps `import hpgq`
    free of jax initialization until a command is actually used."""
    if name in ("stats", "filter_reads", "edit", "prepro", "cgr"):
        from . import api

        return getattr(api, name)
    raise AttributeError(name)
