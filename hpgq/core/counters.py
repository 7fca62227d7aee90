"""Global statistics counters.

The replacement for the reference's ``stats_counters_t``
(``src/stats_fastq.h:35-73``): where the reference keeps 10 int→int khash
maps mutated serially by the consumer thread (``src/stats_fastq.c:257-417``),
we keep *dense* integer tensors — positions and histogram keys are small
ints, so the hash maps were incidental.  Dense tensors make the merge step a
vector add, which is exactly what ``psum`` needs for the multi-chip merge.

All counters are int64 on host (device partials are int32 and are flushed
before overflow, see ``hpgq.core.accumulator``).  ``acc_quality`` is the one
float accumulator: the reference sums per-read mean qualities in a C float
(``src/stats_fastq.h:48``); we sum in float64, which agrees with the
reference to well below the report's rounding (documented deviation,
SURVEY.md §6 hard-part #1).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..constants import NUM_KMERS, PHRED33

QUAL_BINS = 256  # round(mean raw quality) fits in [0, 255]
GC_BINS = 101    # integer GC% key in [0, 100]


@dataclasses.dataclass
class StatsCounters:
    """Dense global QC counters (host-side, int64)."""

    phred: int = PHRED33
    filter_on: bool = False
    kmers_on: bool = False

    num_reads: int = 0
    num_passed: int = 0
    num_failed: int = 0

    min_length: int = 100000  # reference init, src/stats_fastq.c:24
    max_length: int = 0
    acc_length: int = 0
    acc_quality: float = 0.0  # sum over reads of per-read mean raw quality

    num_As: int = 0
    num_Cs: int = 0
    num_Gs: int = 0
    num_Ts: int = 0
    num_Ns: int = 0

    # histograms (dense; grown on demand along the position/length axis)
    length_hist: np.ndarray = None    # [Lcap+1] count of reads by exact length
    quality_hist: np.ndarray = None   # [QUAL_BINS] count by round(mean raw qual)
    gc_hist: np.ndarray = None        # [GC_BINS] count by 100*(G+C)//len

    # per-position stats, shape [Lcap]
    count_quality_per_nt: np.ndarray = None
    acc_quality_per_nt: np.ndarray = None
    base_per_nt: np.ndarray = None    # [5, Lcap] rows A,C,G,T,N

    # k-mers (5-mers)
    kmer_counts: np.ndarray = None        # [1024]
    kmer_counts_by_pos: np.ndarray = None  # [1024, Lcap]

    def __post_init__(self):
        lcap = 0
        if self.length_hist is None:
            self.length_hist = np.zeros(lcap + 1, dtype=np.int64)
        if self.quality_hist is None:
            self.quality_hist = np.zeros(QUAL_BINS, dtype=np.int64)
        if self.gc_hist is None:
            self.gc_hist = np.zeros(GC_BINS, dtype=np.int64)
        if self.count_quality_per_nt is None:
            self.count_quality_per_nt = np.zeros(lcap, dtype=np.int64)
        if self.acc_quality_per_nt is None:
            self.acc_quality_per_nt = np.zeros(lcap, dtype=np.int64)
        if self.base_per_nt is None:
            self.base_per_nt = np.zeros((5, lcap), dtype=np.int64)
        if self.kmer_counts is None:
            self.kmer_counts = np.zeros(NUM_KMERS, dtype=np.int64)
        if self.kmer_counts_by_pos is None:
            self.kmer_counts_by_pos = np.zeros((NUM_KMERS, lcap), dtype=np.int64)

    # -- capacity management -------------------------------------------------

    @property
    def lcap(self) -> int:
        return self.count_quality_per_nt.shape[0]

    def ensure_length(self, lcap: int) -> None:
        """Grow position-indexed tensors to at least ``lcap`` positions."""
        cur = self.lcap
        if lcap <= cur:
            return
        pad = lcap - cur
        self.count_quality_per_nt = np.pad(self.count_quality_per_nt, (0, pad))
        self.acc_quality_per_nt = np.pad(self.acc_quality_per_nt, (0, pad))
        self.base_per_nt = np.pad(self.base_per_nt, ((0, 0), (0, pad)))
        if self.kmers_on:
            # [1024, lcap] int64 — only pay for it in kmers mode (a long-read
            # run without --kmers would otherwise grow hundreds of MB of
            # zeros per counters object and per checkpoint)
            self.kmer_counts_by_pos = np.pad(
                self.kmer_counts_by_pos, ((0, 0), (0, pad))
            )
        if self.length_hist.shape[0] < lcap + 1:
            self.length_hist = np.pad(
                self.length_hist, (0, lcap + 1 - self.length_hist.shape[0])
            )

    # -- merge ----------------------------------------------------------------

    def merge(self, other: "StatsCounters") -> "StatsCounters":
        """Associative merge (the reference's consumer loop as a vector add)."""
        assert self.phred == other.phred
        # mismatched kmers_on would either broadcast-error or silently drop
        # the other side's k-mer tables — fail loudly instead
        assert self.kmers_on == other.kmers_on, (self.kmers_on, other.kmers_on)
        self.ensure_length(other.lcap)
        o = other
        self.num_reads += o.num_reads
        self.num_passed += o.num_passed
        self.num_failed += o.num_failed
        if o.num_reads:
            self.min_length = min(self.min_length, o.min_length)
            self.max_length = max(self.max_length, o.max_length)
        self.acc_length += o.acc_length
        self.acc_quality += o.acc_quality
        self.num_As += o.num_As
        self.num_Cs += o.num_Cs
        self.num_Gs += o.num_Gs
        self.num_Ts += o.num_Ts
        self.num_Ns += o.num_Ns
        self.length_hist[: o.length_hist.shape[0]] += o.length_hist
        self.quality_hist += o.quality_hist
        self.gc_hist += o.gc_hist
        lo = o.lcap
        self.count_quality_per_nt[:lo] += o.count_quality_per_nt
        self.acc_quality_per_nt[:lo] += o.acc_quality_per_nt
        self.base_per_nt[:, :lo] += o.base_per_nt
        if self.kmers_on:
            self.kmer_counts += o.kmer_counts
            self.kmer_counts_by_pos[:, :lo] += o.kmer_counts_by_pos
        return self

    # -- convenience ----------------------------------------------------------

    def num_nucleotides(self) -> int:
        return self.num_As + self.num_Cs + self.num_Gs + self.num_Ts + self.num_Ns

    def equals(self, other: "StatsCounters") -> bool:
        """Value equality; tolerant of different position capacities and
        side-effect free (no operand is grown)."""
        a, b = self, other
        scalars = all(
            getattr(a, f) == getattr(b, f)
            for f in (
                "num_reads", "num_passed", "num_failed", "acc_length",
                "num_As", "num_Cs", "num_Gs", "num_Ts", "num_Ns",
            )
        )
        if a.num_reads:
            scalars = scalars and a.min_length == b.min_length
            scalars = scalars and a.max_length == b.max_length
        la = max(a.length_hist.shape[0], b.length_hist.shape[0])
        lh_a = np.pad(a.length_hist, (0, la - a.length_hist.shape[0]))
        lh_b = np.pad(b.length_hist, (0, la - b.length_hist.shape[0]))
        return bool(
            scalars
            # acc_quality is a float accumulation (f32 on device, f64 in the
            # oracle; the C reference itself is a naive f32 serial sum) —
            # compare to 1e-5 relative, far below the printed resolution
            and abs(a.acc_quality - b.acc_quality)
            <= 1e-5 * max(1.0, abs(a.acc_quality))
            and np.array_equal(lh_a, lh_b)
            and np.array_equal(a.quality_hist, b.quality_hist)
            and np.array_equal(a.gc_hist, b.gc_hist)
            and _eq_padded(a.count_quality_per_nt, b.count_quality_per_nt)
            and _eq_padded(a.acc_quality_per_nt, b.acc_quality_per_nt)
            and _eq_padded(a.base_per_nt, b.base_per_nt)
            and np.array_equal(a.kmer_counts, b.kmer_counts)
            and _eq_padded(a.kmer_counts_by_pos, b.kmer_counts_by_pos)
        )


def _eq_padded(a: np.ndarray, b: np.ndarray) -> bool:
    """Equality of position-indexed arrays with different capacities: the
    shorter one is treated as zero-extended (capacity is an implementation
    detail, not a value)."""
    if a.shape == b.shape:
        return bool(np.array_equal(a, b))
    m = min(a.shape[-1], b.shape[-1])
    return bool(
        np.array_equal(a[..., :m], b[..., :m])
        and not a[..., m:].any()
        and not b[..., m:].any()
    )
