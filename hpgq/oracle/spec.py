"""Executable specification (pure-Python oracle) of the reference semantics.

The reference's compute kernels (``fastq_reads_stats`` / ``fastq_filter`` /
``fastq_edit``) live in submodules that are NOT vendored; their contracts are
reconstructed from call sites (SURVEY.md §2.2).  This module *is* that
contract, written as obviously-correct per-read Python.  It is the single
source of truth: golden tests compare both the vectorized CPU baseline
(``hpgq.oracle.baseline``) and the device engine against it.

Reconstructed-contract decisions (each marked [D#] and cross-referenced from
docstrings):

[D1] ``quality_average`` is the mean of the *raw* ASCII quality bytes (offset
     included), as evidenced by consumer usage (``src/stats_fastq.c:297,317``)
     and report-time normalization (``src/stats_report.c:114-115``).
[D2] Filter/edit quality thresholds are on the Phred scale: a read's mean raw
     quality is compared after subtracting the phred offset (see
     ``hpgq.options`` module docstring for evidence).  Comparisons are done in
     exact integer arithmetic (cross-multiplied), avoiding float ambiguity:
     mean ∈ [lo, hi]  ⇔  lo*n ≤ (qsum - phred*n) ≤ hi*n.
[D3] Left/right windows: the leftmost/rightmost ``min(window, length)``
     nucleotides (a read shorter than the window uses the whole read).
[D4] Edit trims the *whole* window (``left_length`` / ``right_length`` nts,
     clamped to the read) from the corresponding end iff that window's mean
     quality falls OUTSIDE the configured range ("performing a trim of the
     first or last nucleotides if the selected criteria is not acomplished",
     old/README:48-49).  Both windows are evaluated on the original read;
     a read counts as edited if either end was trimmed.
[D5] k-mers are the 4^5=1024 5-mers over alphabet A,C,G,T (id = base-4 number,
     first character most significant, so ids sort lexicographically:
     0="AAAAA", 1023="TTTTT").  A window containing any non-ACGT character is
     skipped.  ``counter_by_pos[p]`` counts windows *starting* at position p;
     a read of length n contributes windows p ∈ [0, n-5].
[D6] Base counters fold case: upper- AND lowercase a/c/g/t/n count toward
     their base (soft-masked FASTQ is ubiquitous and the bases are real).
     DELIBERATE DEVIATION: the reference's observable per-position consumer
     switches on exactly 'A','T','C','G','N' (``src/stats_fastq.c:360-372``)
     and silently drops lowercase from the per-nt tables; we treat that as
     an oversight, not a contract.  Other characters count toward length but
     no base counter.
"""

from __future__ import annotations

import numpy as np

from ..constants import KMER_K, MAX_VALUE, MIN_VALUE, PHRED33
from ..core.counters import StatsCounters
from ..options import FilterCriteria

_BASE_INDEX = {65: 0, 67: 1, 71: 2, 84: 3, 78: 4,
               97: 0, 99: 1, 103: 2, 116: 3, 110: 4}  # A C G T N (+lower)
import os as _os  # noqa: E402

if _os.environ.get("HPGQ_STRICT_CASE"):
    # [D6] strict-compat: literal reference semantics — uppercase only
    # (src/stats_fastq.c:360-372).  Mirrors the engine's BASE_LUT toggle
    # (hpgq.io.packer) so differential tests hold in both modes; PARITY.md
    # quantifies the divergence.
    _BASE_INDEX = {k: v for k, v in _BASE_INDEX.items() if k < 97}


def read_stats(seq: bytes, qual: bytes):
    """Per-read stats, the ``fastq_read_stats_t`` contract (SURVEY §2.2)."""
    n = len(seq)
    counts = [0, 0, 0, 0, 0]
    for b in seq:
        i = _BASE_INDEX.get(b)
        if i is not None:
            counts[i] += 1
    qsum = sum(qual)
    quality_average = float(np.float32(qsum) / np.float32(n)) if n else 0.0  # [D1]
    return {
        "length": n,
        "qsum": qsum,
        "quality_average": quality_average,
        "num_A": counts[0],
        "num_C": counts[1],
        "num_G": counts[2],
        "num_T": counts[3],
        "num_N": counts[4],
    }


def _window_qsum_left(qual: bytes, w: int) -> "tuple[int, int]":
    w = min(w, len(qual))  # [D3]
    return sum(qual[:w]), w


def _window_qsum_right(qual: bytes, w: int) -> "tuple[int, int]":
    w = min(w, len(qual))  # [D3]
    return sum(qual[len(qual) - w:]), w


def filter_verdict(
    seq: bytes, qual: bytes, crit: FilterCriteria, phred: int = PHRED33
) -> bool:
    """The ``fastq_filter`` per-read predicate (6 criteria, SURVEY §2.2).

    ``crit`` must already be default-substituted (``FilterCriteria.substituted``).
    """
    n = len(seq)
    st = read_stats(seq, qual)

    # 1. read length in range
    if not (crit.min_read_length <= n <= crit.max_read_length):
        return False

    # [D8] legacy quality position window: restrict the two quality
    # screens to positions [begin, end) ∩ [0, n).  Default 0/1024 is the
    # whole read (the legacy kernel's own defaults,
    # old/main_hpg_fastq_old.c:100-101); an empty window passes vacuously.
    if crit.quality_window_on:
        wq = qual[crit.begin_quality_nt:crit.end_quality_nt]
    else:
        wq = qual
    wn = len(wq)

    # 2. mean read quality in range  [D2]
    qn = sum(wq) - phred * wn
    if not (crit.min_read_quality * wn <= qn <= crit.max_read_quality * wn):
        return False

    # 3. nts out of the quality range
    if crit.max_out_of_quality != MAX_VALUE:
        out = sum(
            1
            for q in wq
            if (q - phred) < crit.min_read_quality or (q - phred) > crit.max_read_quality
        )
        if out > crit.max_out_of_quality:
            return False

    # 4. left window mean quality  [D2][D3]
    if crit.left_length > MIN_VALUE:
        ls, lw = _window_qsum_left(qual, crit.left_length)
        lqn = ls - phred * lw
        if not (crit.min_left_quality * lw <= lqn <= crit.max_left_quality * lw):
            return False

    # 5. right window mean quality
    if crit.right_length > MIN_VALUE:
        rs, rw = _window_qsum_right(qual, crit.right_length)
        rqn = rs - phred * rw
        if not (crit.min_right_quality * rw <= rqn <= crit.max_right_quality * rw):
            return False

    # 6. number of Ns
    if st["num_N"] > crit.max_N:
        return False
    return True


def trim_lengths(
    seq: bytes, qual: bytes, crit: FilterCriteria, phred: int = PHRED33
) -> "tuple[int, int]":
    """The ``fastq_edit`` per-read trim decision → (left_cut, right_cut). [D4]"""
    lt = rt = 0
    if crit.left_length > MIN_VALUE:
        ls, lw = _window_qsum_left(qual, crit.left_length)
        lqn = ls - phred * lw
        if not (crit.min_left_quality * lw <= lqn <= crit.max_left_quality * lw):
            lt = lw
    if crit.right_length > MIN_VALUE:
        rs, rw = _window_qsum_right(qual, crit.right_length)
        rqn = rs - phred * rw
        if not (crit.min_right_quality * rw <= rqn <= crit.max_right_quality * rw):
            rt = rw
    if lt + rt > len(seq):
        rt = len(seq) - lt
    return lt, rt


def kmer_id(kmer: bytes) -> int:
    """[D5] id of an ACGT 5-mer, first char most significant (base-4)."""
    code = 0
    for b in kmer:
        i = _BASE_INDEX.get(b)
        if i is None or i > 3:
            return -1
        code = code * 4 + i
    return code


def kmer_string(i: int, k: int = KMER_K) -> str:
    s = []
    for _ in range(k):
        s.append("ACGT"[i % 4])
        i //= 4
    return "".join(reversed(s))


def accumulate_read(counters: StatsCounters, seq: bytes, qual: bytes) -> None:
    """Merge one read into the global counters — the reference consumer body
    (``src/stats_fastq.c:282-410``) with dense tensors instead of khash."""
    st = read_stats(seq, qual)
    n = st["length"]
    counters.ensure_length(max(n, 1))

    counters.num_reads += 1
    counters.acc_length += n
    counters.min_length = min(counters.min_length, n)
    counters.max_length = max(counters.max_length, n)
    counters.acc_quality += st["quality_average"]
    counters.num_As += st["num_A"]
    counters.num_Cs += st["num_C"]
    counters.num_Gs += st["num_G"]
    counters.num_Ts += st["num_T"]
    counters.num_Ns += st["num_N"]

    counters.length_hist[n] += 1
    # [D1] mean-quality histogram key: round-half-up of the RATIONAL mean,
    # via exact integer arithmetic (2*qsum + n) // (2n).  The reference
    # rounds the f32 quotient (round(quality_average),
    # src/stats_fastq.c:317); the two differ only when the f32 division
    # rounds across the .5 boundary (~1 in 2^24 reads) — the integer form
    # is bit-identical across every backend, whatever its f32 division.
    counters.quality_hist[(2 * st["qsum"] + n) // (2 * n) if n else 0] += 1
    if n:
        counters.gc_hist[(100 * (st["num_G"] + st["num_C"])) // n] += 1

    for j in range(n):
        counters.count_quality_per_nt[j] += 1
        counters.acc_quality_per_nt[j] += qual[j]
        bi = _BASE_INDEX.get(seq[j])
        if bi is not None:
            counters.base_per_nt[bi, j] += 1

    if counters.kmers_on and n >= KMER_K:
        for p in range(n - KMER_K + 1):
            kid = kmer_id(seq[p : p + KMER_K])
            if kid >= 0:
                counters.kmer_counts[kid] += 1
                counters.kmer_counts_by_pos[kid, p] += 1


def stats_of_file(
    records,
    phred: int = PHRED33,
    kmers_on: bool = False,
    criteria: FilterCriteria = None,
) -> StatsCounters:
    """Full-file oracle stats: iterate (seq, qual) pairs; with ``criteria``
    set, stats cover only passing reads and passed/failed are counted
    (``src/stats_fastq.c:205-248,268-272``)."""
    counters = StatsCounters(phred=phred, kmers_on=kmers_on)
    crit = criteria.substituted() if criteria is not None else None
    counters.filter_on = crit is not None
    for seq, qual in records:
        if crit is not None:
            if filter_verdict(seq, qual, crit, phred):
                counters.num_passed += 1
            else:
                counters.num_failed += 1
                continue
        accumulate_read(counters, seq, qual)
    return counters


def iter_seq_qual(path: str):
    """Convenience: iterate (seq, qual) byte pairs of a FASTQ file."""
    from ..io.fastq import FastqReader

    with FastqReader(path, batch_size=4096) as rd:
        for block in rd:
            for i in range(block.num_reads):
                yield block.sequence(i), block.quality(i)
