"""Randomized config-space differential fuzzer: random corpora x random
criteria x wire formats x batch/coalescing knobs x paired, across every
command (stats/filter/edit/cgr), engine vs the numpy oracle — the class
of testing that catches interactions the fixed test matrix misses.

    python tools/fuzz_configs.py [--rounds N] [--seed S]   # default 20

Each round draws a corpus (lengths, N rate, lowercase rate, CRLF, final
newline) and a command config, runs the production pipeline, and checks
every counter (stats) or the output byte partition (filter) against the
oracle.  Exits non-zero on the first mismatch, printing the full config
needed to reproduce.
"""

import argparse
import dataclasses
import json
import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(
    0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "tests"))

import numpy as np  # noqa: E402


def _counters_equal(eng, orc):
    bad = []
    for name in vars(orc):
        a, b = getattr(eng, name), getattr(orc, name)
        if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
            a, b = np.asarray(a), np.asarray(b)
            m = min(a.shape[-1], b.shape[-1])
            ok = (np.array_equal(a[..., :m], b[..., :m])
                  and a[..., m:].sum() == 0 and b[..., m:].sum() == 0)
        elif isinstance(a, float) or isinstance(b, float):
            tol = 1e-3 if name == "acc_quality" else 1e-6
            ok = abs(a - b) <= tol * max(1.0, abs(b))
        else:
            ok = a == b
        if not ok:
            bad.append(name)
    return bad


def one_round(rng, rnd: int) -> dict:
    from gen import make_records, write_fastq
    from hpgq.options import (
        FilterCriteria,
        FilterOptions,
        StatsOptions,
    )
    from hpgq.oracle import spec
    from hpgq.pipeline.run import run_filter, run_stats

    cfg = {
        "round": rnd,
        "n": int(rng.integers(200, 4000)),
        "min_len": int(rng.integers(1, 80)),
        "n_prob": float(rng.choice([0.0, 0.01, 0.05])),
        "lowercase_prob": float(rng.choice([0.0, 0.1])),
        "wire": str(rng.choice(["bitpack", "fused4", "pack4", "off"])),
        "qn": str(rng.choice(["0", "1"])),
        # adaptive bitpack ladder: on/off, plus qual-shape draws so every
        # tier is fuzzed — "binned" (4 distinct values, RTA3 style) takes
        # the 2-bit palette tier; the default uniform 2..41 span exceeds
        # 4 distinct but fits 6 bits (6-bit tier); "wide" (max_q=93 ->
        # ASCII '~', a 92-value span) makes long rows misfit BOTH
        # adaptive tiers (native returns 0 -> next rung), so the whole
        # fallback ladder is drawn.
        "wire6": str(rng.choice(["0", "1"])),
        "wire2c": str(rng.choice(["0", "1"])),
        "wire2u": str(rng.choice(["0", "1"])),
        "qshape": str(rng.choice(["uniform", "uniform", "binned", "wide"])),
        "batch_size": int(rng.choice([37, 250, 1000, 10000])),
        "coalesce": int(rng.choice([0, 777, 131072])),
        "paired": bool(rng.integers(0, 2)),
        "kmers": bool(rng.integers(0, 2)),
        "cmd": str(rng.choice(["stats", "filter", "edit", "cgr"])),
        "seed": int(rng.integers(0, 2**31)),
    }
    if cfg["cmd"] == "cgr":
        cfg["k"] = int(rng.choice([3, 4, 5, 7]))
        cfg["n"] = min(cfg["n"], 1500)  # the per-nt loop oracle is slow
    # checkpoint rounds: interrupt after a few batches, resume, and hold
    # the final outputs to the same oracle assertions as a clean run
    cfg["checkpoint"] = bool(rng.integers(0, 4) == 0)
    if cfg["checkpoint"]:
        cfg["batch_size"] = max(20, cfg["n"] // 6)  # guarantee >=~6 batches
        cfg["stop_after"] = int(rng.integers(1, 4))
        # env-forced coalescing would merge the whole corpus into one
        # dispatch — nothing left to interrupt after block 1
        cfg["coalesce"] = 0
    # sharded rounds: drive the real shard_map session over the full
    # device mesh (8 virtual CPU devices standalone — see main(); whatever
    # the host has under pytest).  filter/edit --sharded degenerate to the
    # ordinary pipeline at one process, so only stats/cgr exercise new
    # code.  Combines with the checkpoint arm: the interrupt hook wraps
    # the lockstep iterator, so sharded(-paired) checkpoint interrupt +
    # rotating-rank resume rounds are drawn too.
    cfg["sharded"] = bool(cfg["cmd"] in ("stats", "cgr")
                          and rng.integers(0, 2) == 0)
    if cfg["sharded"]:
        import jax

        cfg["ndev"] = len(jax.devices())
    # ~1/4 of rounds are uniform-length (delta 0) so the 2u tier's
    # conditions get real coverage, not a 1/200 fluke
    cfg["max_len"] = cfg["min_len"] + int(rng.choice(
        [0, int(rng.integers(1, 200))], p=[0.25, 0.75]))
    crit_draw = {
        "min_read_quality": int(rng.choice([-1, 18, 35])),
        "max_read_quality": int(rng.choice([-1, 40, 60])),
        "max_N": int(rng.choice([-1, 0, 2])),
        "min_read_length": int(rng.choice([-1, 30])),
        "max_read_length": int(rng.choice([-1, 150])),
        "max_out_of_quality": int(rng.choice([-1, 50])),
        "left_length": int(rng.choice([-1, 5])),
        "min_left_quality": int(rng.choice([-1, 20])),
        "max_left_quality": int(rng.choice([-1, 65])),
        "right_length": int(rng.choice([-1, 7])),
        "min_right_quality": int(rng.choice([-1, 15])),
        "max_right_quality": int(rng.choice([-1, 70])),
    }
    crit_kw = {k: v for k, v in crit_draw.items() if v != -1}
    # [D8] legacy quality position window: non-default in ~1/4 of rounds,
    # including degenerate shapes (beyond-read, zero-width)
    if rng.integers(0, 4) == 0:
        beg = int(rng.choice([0, 5, 30, 300]))
        end = int(rng.choice([20, 60, 1024]))
        if (beg, end) != (0, 1024):
            crit_kw["begin_quality_nt"] = beg
            crit_kw["end_quality_nt"] = end
    cfg["criteria"] = crit_kw
    filter_on = bool(crit_kw) and (cfg["cmd"] == "filter"
                                   or bool(rng.integers(0, 2)))
    if cfg["cmd"] == "filter" and not crit_kw:
        crit_kw = {"min_read_quality": 20}
        cfg["criteria"] = crit_kw
        filter_on = True
    if cfg["cmd"] == "edit":
        # edit needs at least one trim window; draw one if absent
        if crit_kw.get("left_length", -1) < 0 \
                and crit_kw.get("right_length", -1) < 0:
            crit_kw["left_length"] = 6
            crit_kw.setdefault("min_left_quality", 25)
            crit_kw.setdefault("max_left_quality", 60)
            cfg["criteria"] = crit_kw
        cfg["paired"] = False  # single-end edit fuzz (paired rides filter)
    if cfg["cmd"] == "cgr":
        filter_on = False  # cgr has no inline filter
    cfg["filter_on"] = filter_on

    try:
        return _run_round(cfg, crit_kw, filter_on, make_kw_of(cfg))
    except AssertionError as e:
        e.cfg = cfg
        raise


def _run_maybe_interrupted(cfg, run_fn, opts):
    """Run the command; in checkpoint rounds, first run it with the block
    iterator rigged to raise after ``stop_after`` batches (the production
    interrupt shape the checkpoint tests use), then resume to completion."""
    if not cfg["checkpoint"]:
        return run_fn(opts)

    from hpgq.dist import run_dist as dist_mod
    from hpgq.pipeline import cgr_run as cgr_mod
    from hpgq.pipeline import run as run_mod

    opts.checkpoint_path = os.path.join(opts.out_dirname, "fuzz.ck.npz")
    opts.checkpoint_every = 1
    calls = {"n": 0}

    def wrap(real):
        def limited(*a, **k):
            for b in real(*a, **k):
                if calls["n"] >= cfg["stop_after"]:
                    raise KeyboardInterrupt
                calls["n"] += 1
                yield b
        return limited

    saved = (run_mod._iter_packed, run_mod._iter_with, cgr_mod._iter_blocks,
             run_mod._iter_blocks_paired, dist_mod.iter_lockstep)
    run_mod._iter_packed = wrap(saved[0])
    run_mod._iter_with = wrap(saved[1])
    cgr_mod._iter_blocks = wrap(saved[2])
    run_mod._iter_blocks_paired = wrap(saved[3])
    # the sharded sessions pull lockstep (block, shape) steps — wrapping
    # here lets checkpoint-interrupt rounds reach the rotating-rank
    # checkpoints of the sharded(-paired) paths too
    dist_mod.iter_lockstep = wrap(saved[4])
    interrupted = False
    try:
        try:
            res = run_fn(opts)
        except KeyboardInterrupt:
            interrupted = True
            res = None
    finally:
        (run_mod._iter_packed, run_mod._iter_with, cgr_mod._iter_blocks,
         run_mod._iter_blocks_paired, dist_mod.iter_lockstep) = saved
    if interrupted:
        res = run_fn(opts)  # resume from the checkpoint
    cfg["interrupted"] = interrupted
    return res


def make_kw_of(cfg):
    kw = dict(min_len=cfg["min_len"], max_len=cfg["max_len"],
              n_prob=cfg["n_prob"], lowercase_prob=cfg["lowercase_prob"])
    shape = cfg.get("qshape", "uniform")
    if shape == "binned":
        kw["qual_bins"] = (2, 12, 23, 37)
    elif shape == "wide":
        kw["max_q"] = 93  # ASCII '~', the top of the legal range
    return kw


def _run_round(cfg, crit_kw, filter_on, make_kw):
    from gen import make_records, write_fastq
    from hpgq.options import (
        FilterCriteria,
        FilterOptions,
        StatsOptions,
    )
    from hpgq.oracle import spec
    from hpgq.pipeline.run import run_filter, run_stats

    knobs = ("HPGQ_WIRE", "HPGQ_QN_WIRE", "HPGQ_COALESCE", "HPGQ_WIRE6",
             "HPGQ_WIRE2C", "HPGQ_WIRE2U")
    saved_env = {k: os.environ.get(k) for k in knobs}
    os.environ["HPGQ_WIRE"] = cfg["wire"]
    os.environ["HPGQ_QN_WIRE"] = cfg["qn"]
    os.environ["HPGQ_COALESCE"] = str(cfg["coalesce"])
    os.environ["HPGQ_WIRE6"] = cfg.get("wire6", "1")
    os.environ["HPGQ_WIRE2C"] = cfg.get("wire2c", "1")
    os.environ["HPGQ_WIRE2U"] = cfg.get("wire2u", "1")
    try:
        tmp = tempfile.mkdtemp(prefix="fuzz_")
        f1 = os.path.join(tmp, "a.fq")
        write_fastq(f1, make_records(cfg["n"], seed=cfg["seed"], **make_kw))
        f2 = None
        if cfg["paired"]:
            f2 = os.path.join(tmp, "b.fq")
            write_fastq(f2, make_records(cfg["n"], seed=cfg["seed"] ^ 1,
                                         **make_kw))

        def mk(cls):
            o = cls()
            o.in_filename = f1
            o.in_filename2 = f2
            o.out_dirname = tmp
            o.quality_encoding_value = 33
            o.quality_encoding_name = "phred33"
            o.batch_size = cfg["batch_size"]
            o.batch_size_set = True
            o.criteria = FilterCriteria(**crit_kw)
            o.filter_on = filter_on
            return o

        crit = FilterCriteria(**crit_kw).substituted() if filter_on else None

        if cfg["cmd"] == "stats":
            o = mk(StatsOptions)
            o.kmers_on = cfg["kmers"]
            if cfg["sharded"]:
                from hpgq.dist.run_dist import run_stats_sharded

                got = _run_maybe_interrupted(
                    cfg, lambda o: run_stats_sharded(o, report=False), o)
            else:
                got = _run_maybe_interrupted(
                    cfg, lambda o: run_stats(o, report=False), o)
            if cfg["paired"]:
                c1, c2 = got
                r1 = list(spec.iter_seq_qual(f1))
                r2 = list(spec.iter_seq_qual(f2))
                if crit is not None:
                    both = [spec.filter_verdict(s1, q1, crit, 33)
                            and spec.filter_verdict(s2, q2, crit, 33)
                            for (s1, q1), (s2, q2) in zip(r1, r2)]
                else:
                    both = [True] * len(r1)
                skip = ("filter_on", "num_passed", "num_failed")
                for c, recs in ((c1, r1), (c2, r2)):
                    orc = spec.stats_of_file(
                        (r for r, b in zip(recs, both) if b),
                        kmers_on=cfg["kmers"])
                    bad = [x for x in _counters_equal(c, orc)
                           if x not in skip]
                    assert not bad, bad
                if crit is not None:
                    assert c1.num_passed == sum(both), "num_passed"
            else:
                orc = spec.stats_of_file(
                    spec.iter_seq_qual(f1), kmers_on=cfg["kmers"],
                    criteria=FilterCriteria(**crit_kw) if filter_on else None,
                    phred=33)
                bad = _counters_equal(got, orc)
                assert not bad, bad
        elif cfg["cmd"] == "edit":
            from hpgq.options import EditOptions
            from hpgq.pipeline.run import run_edit

            o = mk(EditOptions)
            res = _run_maybe_interrupted(cfg, run_edit, o)
            crit_raw = FilterCriteria(**crit_kw)
            crit_sub = crit_raw.substituted()
            post = crit_sub.without_windows()
            raw = open(f1, "rb").read().split(b"\n")
            want_edit, want_failed = [], []
            n_edited = 0
            for i in range(0, len(raw) - 1, 4):
                seq, qual = raw[i + 1], raw[i + 3]
                lt, rt = spec.trim_lengths(seq, qual, crit_sub, 33)
                if lt or rt:
                    n_edited += 1
                ts, tq = seq[lt:len(seq) - rt], qual[lt:len(qual) - rt]
                rec = b"\n".join([raw[i], ts, raw[i + 2], tq]) + b"\n"
                if filter_on:
                    ok = spec.filter_verdict(ts, tq, post, 33)
                    (want_edit if ok else want_failed).append(rec)
                else:
                    want_edit.append(rec)
            assert res["num_edited"] == n_edited, "num_edited"
            got = open(os.path.join(tmp, "edit.fq"), "rb").read()
            assert got == b"".join(want_edit), "edit bytes"
            if filter_on:
                gotf = open(os.path.join(tmp, "failed.fq"), "rb").read()
                assert gotf == b"".join(want_failed), "failed bytes"
        elif cfg["cmd"] == "cgr":
            from hpgq.io.fastq import FastqReader
            from hpgq.io.packer import pack_block
            from hpgq.options import CgrOptions
            from hpgq.oracle.cgr import fill_tables_loop
            from hpgq.pipeline.cgr_run import run_cgr

            k = cfg["k"]
            o = mk(CgrOptions)
            o.k = k
            o.filter_on = False
            o.sharded = cfg["sharded"]  # run_cgr self-dispatches to sharded
            res = _run_maybe_interrupted(cfg, run_cgr, o)
            dim = 1 << k
            ots = np.zeros((dim, dim), dtype=np.int64)
            otq = np.zeros((dim, dim), dtype=np.int64)
            ow = 0
            for path in [f1] + ([f2] if cfg["paired"] else []):
                with FastqReader(path, batch_size=1 << 20) as rd:
                    for block in rd:
                        codes, quals, lens, valid = pack_block(block)
                        ts, tq, w = fill_tables_loop(
                            codes, quals, lens, valid, k, 33)
                        ots += ts
                        otq += tq
                        ow += w
            assert res["fq_word_count"] == ow, "cgr word count"
            assert np.array_equal(res["table_seq"], ots), "cgr table_seq"
            assert np.array_equal(res["table_q"], otq), "cgr table_q"
        else:
            o = mk(FilterOptions)
            res = _run_maybe_interrupted(cfg, run_filter, o)
            raw = open(f1, "rb").read().split(b"\n")
            raw2 = open(f2, "rb").read().split(b"\n") if cfg["paired"] else None
            pp, ff = [], []
            for i in range(0, len(raw) - 1, 4):
                rec = b"\n".join(raw[i:i + 4]) + b"\n"
                ok = spec.filter_verdict(raw[i + 1], raw[i + 3], crit, 33)
                if cfg["paired"]:
                    ok = ok and spec.filter_verdict(raw2[i + 1], raw2[i + 3],
                                                    crit, 33)
                (pp if ok else ff).append(rec)
            p_name = "passed_1.fq" if cfg["paired"] else "passed.fq"
            f_name = "failed_1.fq" if cfg["paired"] else "failed.fq"
            assert open(os.path.join(tmp, p_name), "rb").read() == b"".join(pp), "passed bytes"
            assert open(os.path.join(tmp, f_name), "rb").read() == b"".join(ff), "failed bytes"
            assert res["num_passed"] == len(pp) and res["num_failed"] == len(ff)
    finally:
        # restore (not clear): the smoke tests run this inside the pytest
        # session, where clobbering an exported knob would leak into every
        # test collected afterwards
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    return cfg


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--backend", choices=["cpu8", "native"], default="cpu8",
                    help="cpu8 (default): force an 8-virtual-device CPU "
                         "backend so sharded rounds run a real multi-device "
                         "mesh; native: whatever the host provides (GPU)")
    args = ap.parse_args()

    if args.backend == "cpu8":
        # must happen BEFORE the first backend query
        flags = os.environ.get("XLA_FLAGS", "")
        if "xla_force_host_platform_device_count" not in flags:
            os.environ["XLA_FLAGS"] = (
                flags + " --xla_force_host_platform_device_count=8").strip()
        import jax

        jax.config.update("jax_platforms", "cpu")

    from hpgq.utils.compile_cache import enable

    enable()
    rng = np.random.default_rng(args.seed)
    n_multidev = 0
    for r in range(args.rounds):
        try:
            cfg = one_round(rng, r)
            n_multidev += int(cfg.get("ndev", 1) > 1)
            print("PASS", json.dumps(cfg, sort_keys=True), flush=True)
        except AssertionError as e:
            print("FAIL round=%d: %s\n  cfg=%s" % (r, e,
                  json.dumps(getattr(e, "cfg", None), sort_keys=True)),
                  flush=True)
            return 1
    print("OK: %d rounds, %d on a multi-device mesh" % (args.rounds,
                                                        n_multidev),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
