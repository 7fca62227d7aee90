#!/usr/bin/env python
"""Paired-pass per-stage attribution: where does the
paired engine's per-read time go vs the single-end engine on the same
machine phase?

Runs, back to back on the same corpora:
  1. single-end stats+filter over mate1 (the headline path)
  2. paired stats+filter over (mate1, mate2)
with StageTimers collected, printed as JSON on stdout.

Usage: python tools/profile_paired.py [--reads 200000] [--rounds 2]
"""

import argparse
import dataclasses
import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import bench
from bench import CRIT, PHRED, corpus
from hpgq.options import StatsOptions
from hpgq.pipeline.run import run_stats
from hpgq.utils.timers import StageTimers


def one(path, mate2, batch_size, br, tmp):
    o = StatsOptions()
    o.in_filename = path
    if mate2:
        o.in_filename2 = mate2
    o.out_dirname = tmp
    o.quality_encoding_value = PHRED
    o.quality_encoding_name = "phred33"
    o.batch_size = batch_size
    o.device_batch_reads = br
    o.criteria = dataclasses.replace(CRIT)
    o.filter_on = True
    t = StageTimers()
    t0 = time.perf_counter()
    c = run_stats(o, t)
    dt = time.perf_counter() - t0
    if mate2:
        c1, _ = c
        n = 2 * (c1.num_passed + c1.num_failed)
    else:
        n = c.num_passed + c.num_failed
    return {"reads": n, "seconds": round(dt, 3),
            "rps": round(n / dt, 1),
            "stages": {k: round(v, 3) for k, v in sorted(t.totals.items())},
            "batches": t.num_batches}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--reads", type=int, default=200_000)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--batch-size", type=int, default=131_072)
    args = ap.parse_args()

    path = corpus(args.reads, 100)
    mate2 = os.path.join(bench.BENCH_DIR,
                         "bench_mate2_%d_%s.fq" % (args.reads,
                                                   bench.QUAL_SHAPE))
    if not os.path.exists(mate2):
        sys.path.insert(0, os.path.join(os.path.dirname(
            os.path.dirname(os.path.abspath(__file__))), "tests"))
        from gen import make_fastq

        make_fastq(mate2, args.reads, min_len=100, max_len=100,
                   n_prob=0.005, seed=13, qual_bins=bench.RTA3_BINS)

    tmp = tempfile.mkdtemp(prefix="hpgq_profpair_")
    # warmup both paths (compile)
    one(path, None, args.batch_size, args.batch_size, tmp)
    one(path, mate2, args.batch_size, args.batch_size, tmp)
    for rnd in range(args.rounds):
        se = one(path, None, args.batch_size, args.batch_size, tmp)
        pe = one(path, mate2, args.batch_size, args.batch_size, tmp)
        print(json.dumps({"round": rnd, "single": se, "paired": pe,
                          "paired_vs_single_per_read":
                          round(se["rps"] / pe["rps"], 3)}))


if __name__ == "__main__":
    main()
