#!/usr/bin/env python
"""Strict-compat parity audit: quantify, on a large corpus,
how often each documented deviation from literal reference semantics
([D1] quality-key rounding, [D6] case folding, CGR >=53 single-letter runs
— see hpgq/oracle/spec.py and hpgq/kernels/cgr.py) would actually change an
observable output.  Results are recorded in PARITY.md.

Usage: python tools/parity_audit.py [--reads N] [--corpus PATH]
Default corpus: generated 2M reads, 60-160bp, 1% N, 10% lowercase-run reads
(soft-masked-style), phred33 quals 33..73.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from hpgq.io.fastq import FastqReader  # noqa: E402


def ref_round_f32(qsum: np.ndarray, n: np.ndarray) -> np.ndarray:
    """Literal reference quality-hist key: C ``round()`` (half away from
    zero, double) of the f32 quotient (src/stats_fastq.c:317)."""
    q = np.float32(qsum.astype(np.float32)) / n.astype(np.float32)
    qd = q.astype(np.float64)
    return np.floor(qd + 0.5).astype(np.int64)  # qd >= 0 always


def int_key(qsum: np.ndarray, n: np.ndarray) -> np.ndarray:
    """Our backend-exact key: round-half-up of the rational mean [D1]."""
    return (2 * qsum + n) // (2 * n)


def longest_run(seq: np.ndarray) -> int:
    """Longest single-letter run in a uint8 sequence array."""
    if seq.size == 0:
        return 0
    change = np.flatnonzero(np.diff(seq) != 0)
    edges = np.concatenate([[-1], change, [seq.size - 1]])
    return int(np.max(np.diff(edges)))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--reads", type=int, default=2_000_000)
    ap.add_argument("--corpus", default=None)
    args = ap.parse_args()

    path = args.corpus
    if path is None:
        os.makedirs(".bench", exist_ok=True)
        path = os.path.join(".bench", "parity_%d.fq" % args.reads)
        if not os.path.exists(path):
            sys.path.insert(0, os.path.join(
                os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                "tests"))
            from gen import make_fastq

            make_fastq(path, args.reads, min_len=60, max_len=160,
                       n_prob=0.01, lowercase_prob=0.10, seed=99)

    total = 0
    d1_diff = 0            # [D1] f32-rounded key != integer key
    d6_reads = 0           # [D6] reads containing lowercase acgtn
    d6_bases = 0           # [D6] lowercase bases (per-nt rows that differ)
    cgr_runs = 0           # reads with a >=53 single-letter run
    total_bases = 0

    lower = np.zeros(256, bool)
    for ch in b"acgtn":
        lower[ch] = True

    with FastqReader(path, batch_size=100_000) as rd:
        for block in rd:
            n = block.num_reads
            total += n
            qs = np.zeros(n, np.int64)
            for i in range(n):
                seq = np.frombuffer(block.sequence(i), np.uint8)
                qual = np.frombuffer(block.quality(i), np.uint8)
                qs[i] = int(qual.sum())
                low = int(lower[seq].sum())
                if low:
                    d6_reads += 1
                    d6_bases += low
                total_bases += seq.size
                if seq.size >= 53 and longest_run(seq) >= 53:
                    cgr_runs += 1
            lens = block.seq_lens.astype(np.int64)
            nz = lens > 0
            d1_diff += int(
                (ref_round_f32(qs[nz], lens[nz]) != int_key(qs[nz], lens[nz]))
                .sum()
            )

    # exhaustive [D1] characterization: every (length, qsum) pair reachable
    # with phred33 ASCII quals 33..104 up to length 500 — complete coverage
    # of the short-read space, far stronger than corpus sampling
    d1_pairs = 0
    d1_examples = []
    for n in range(1, 501):
        qsums = np.arange(33 * n, 104 * n + 1, dtype=np.int64)
        ns = np.full_like(qsums, n)
        bad = ref_round_f32(qsums, ns) != int_key(qsums, ns)
        c = int(bad.sum())
        d1_pairs += c
        if c and len(d1_examples) < 5:
            for q in qsums[bad][:2]:
                d1_examples.append([int(n), int(q)])

    # [D7] CGR non-ACGTN handling: on a deliberately IUPAC-salted corpus,
    # count reads whose CGR contribution differs between the kernel
    # semantics (code 5 -> N) and the reference's splice fall-through —
    # measured per read with the loop oracle on both interpretations.
    # (On the main corpus above this is structurally 0: gen.py emits only
    # ACGTN.)
    from hpgq.oracle.cgr import fill_tables_loop

    rng = np.random.default_rng(1234)
    d7_reads = 0
    d7_total = 20_000
    k = 7
    for start in range(0, d7_total, 2000):
        B = min(2000, d7_total - start)
        L = 120
        codes = rng.integers(0, 4, size=(B, L)).astype(np.int8)
        codes[rng.random((B, L)) < 0.01] = 4
        codes[rng.random((B, L)) < 0.01] = 5  # IUPAC-ish bytes
        quals = rng.integers(33, 74, size=(B, L)).astype(np.uint8)
        lens = np.full(B, L, np.int32)
        valid = np.ones(B, bool)
        as_n = np.where(codes == 5, np.int8(4), codes)
        for i in range(B):
            a = fill_tables_loop(codes[i:i + 1], quals[i:i + 1],
                                 lens[i:i + 1], valid[i:i + 1], k, 33)
            b = fill_tables_loop(as_n[i:i + 1], quals[i:i + 1],
                                 lens[i:i + 1], valid[i:i + 1], k, 33)
            if (a[2] != b[2] or not np.array_equal(a[0], b[0])
                    or not np.array_equal(a[1], b[1])):
                d7_reads += 1

    out = {
        "corpus": path,
        "total_reads": total,
        "total_bases": total_bases,
        "D1_quality_key_diff_reads": d1_diff,
        "D6_lowercase_reads": d6_reads,
        "D6_lowercase_bases": d6_bases,
        "CGR_run53_reads": cgr_runs,
        "D1_exhaustive_pairs_len_le_500": d1_pairs,
        "D1_examples_n_qsum": d1_examples,
        "D7_iupac_salted_reads_total": d7_total,
        "D7_iupac_salted_reads_divergent": d7_reads,
    }
    print(json.dumps(out, indent=2))


if __name__ == "__main__":
    main()
