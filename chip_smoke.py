#!/usr/bin/env python
"""Chip smoke test: hpgq's main path on an NVIDIA GPU, end to end, with
every result checked against the repository's own oracles.

    python chip_smoke.py                  # phases 0-9 on one GPU
    python chip_smoke.py --four-cards     # only the multi-device path, 4 GPUs

Everything runs in this one process, through the entry points a user calls
(``hpgq.cli.main.main``); inputs are generated from ``--seed`` by
``tests/gen.py``.  Phases, in order:

0. device      — refuse anything but a GPU; name the card, JAX, the compile
                 cache and the native packer (which must have loaded).
1. stats       — 1M x 150 bp RTA3-binned reads, ``stats --kmers`` with
                 criteria; counters vs ``hpgq.oracle.spec.stats_of_file``
                 (integers exact, ``acc_quality`` to 1e-5 relative) and the
                 report files byte-equal to the writer's output for the
                 oracle's counters.
2. filter      — the same corpus; passed/failed bytes == oracle partition.
3. edit        — left+right quality trims; edit.fq bytes == the numpy trims
                 (``hpgq.oracle.baseline.block_trims``) applied to the input.
4. paired      — 2 x 500k reads, ``filter`` and ``stats`` with criteria;
                 pair-consistent bytes and counters vs the oracle.
5. cgr         — k=7 and k=8 on 200k reads; tables and word count == the
                 f64 loop oracle (``hpgq.oracle.cgr``).
6. long reads  — 2000 reads of 10-25 kbp, ``stats`` with criteria; counters
                 vs the oracle, peak device bytes, padding waste.
7. compressed  — phase 1's corpus as .gz and as BGZF: summary == phase 1's.
8. sharded     — ``stats --sharded`` / ``cgr --sharded`` on the one-device
                 mesh == phases 1 and 5.
9. step time   — a record, not a gate: warm jnp stats and CGR step times
                 beside their HBM byte floors, and the steps' share of
                 phase 1's wall.

The oracles run in a pool of worker processes that never import JAX, so
only this process touches the card.  Each phase prints one line; a failed
phase is reported and the script exits non-zero after the remaining phases.
The last line of stdout is the contract's JSON object and nothing more.
"""

import argparse
import contextlib
import dataclasses
import gzip
import json
import multiprocessing
import os
import shutil
import sys
import threading
import time
import traceback
from concurrent.futures import ProcessPoolExecutor

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.join(HERE, "tests")]

PHRED = 33
RTA3_BINS = (2, 12, 23, 37)  # NovaSeq/NextSeq 4-level quality binning
HBM_BYTES_PER_S = 3.35e12    # H100 SXM device memory (NVIDIA data sheet)

# the stats/filter criteria, as flags and as the oracle's own FilterCriteria
CRIT_FLAGS = ["--read-quality-range", "18,40", "--max-N", "2",
              "--left-length", "10", "--left-quality-range", "15,60"]
CRIT_KW = dict(min_read_quality=18, max_read_quality=40, max_N=2,
               left_length=10, min_left_quality=15, max_left_quality=60)
# long reads carry ~90 Ns each at the corpus' N rate: no N bound there
LONG_FLAGS = CRIT_FLAGS[:2] + CRIT_FLAGS[4:]
LONG_KW = {k: v for k, v in CRIT_KW.items() if k != "max_N"}
EDIT_FLAGS = ["--left-length", "10", "--left-quality-range", "25,93",
              "--right-length", "8", "--right-quality-range", "20,93"]
EDIT_KW = dict(left_length=10, min_left_quality=25, max_left_quality=93,
               right_length=8, min_right_quality=20, max_right_quality=93)


@dataclasses.dataclass
class Sizes:
    reads: int = 1_000_000      # phases 1-3, 7, 8
    read_len: int = 150
    pairs: int = 500_000        # phase 4, per mate
    cgr_reads: int = 200_000    # phases 5, 8
    long_reads: int = 2_000     # phase 6
    long_min: int = 10_000
    long_max: int = 25_000
    step_rows: int = 131_072    # phase 9
    four_reads: int = 400_000   # --four-cards
    batch_size: int = 0         # 0: the CLI's own default (rehearsals set it)


# ---------------------------------------------------------------------------
# oracle workers (run in spawned processes: numpy + hpgq.oracle only)
# ---------------------------------------------------------------------------

def _records(path, start, end):
    """(seq, qual) pairs of the records in bytes [start, end) — parsed here,
    independently of the reader under test."""
    with open(path, "rb") as f:
        f.seek(start)
        lines = f.read(end - start).split(b"\n")
    check(len(lines) % 4 == 1 and lines[-1] == b"", (path, start, end))
    return list(zip(lines[1::4], lines[3::4]))


def _w_stats(path, start, end, kmers_on, crit, sel):
    """spec.stats_of_file over one byte range (``sel``: a precomputed
    selection of its reads, in place of ``crit``)."""
    from hpgq.oracle import spec

    recs = _records(path, start, end)
    if sel is not None:
        recs = [r for r, s in zip(recs, sel) if s]
    return spec.stats_of_file(recs, phred=PHRED, kmers_on=kmers_on,
                              criteria=crit)


def _w_verdicts(path, start, end, crit):
    from hpgq.oracle import spec

    sub = crit.substituted()
    return np.array([spec.filter_verdict(s, q, sub, PHRED)
                     for s, q in _records(path, start, end)], dtype=bool)


def _packed(recs):
    """[N, L] codes/quals in the packed layout (A C G T N = 0..4, other 5,
    case folded; padding codes 5 / quals 0), built from raw records."""
    lut = np.full(256, 5, np.int8)
    for i, ch in enumerate(b"ACGTN"):
        lut[ch] = lut[ch + 32] = i
    lens = np.array([len(s) for s, _ in recs], np.int32)
    L = max(int(lens.max(initial=0)), 1)
    mask = np.arange(L)[None, :] < lens[:, None]
    codes = np.full((len(recs), L), 5, np.int8)
    quals = np.zeros((len(recs), L), np.uint8)
    codes[mask] = lut[np.frombuffer(b"".join(s for s, _ in recs), np.uint8)]
    quals[mask] = np.frombuffer(b"".join(q for _, q in recs), np.uint8)
    return codes, quals, lens


def _w_cgr(path, start, end, k):
    from hpgq.oracle.cgr import fill_tables_loop

    codes, quals, lens = _packed(_records(path, start, end))
    return fill_tables_loop(codes, quals, lens, np.ones(len(lens), bool), k,
                            PHRED)


# ---------------------------------------------------------------------------
# measurement plumbing
# ---------------------------------------------------------------------------

_COMPILE_EVENTS = (
    "/jax/core/compile/jaxpr_trace_duration",
    "/jax/core/compile/jaxpr_to_mlir_module_duration",
    "/jax/core/compile/backend_compile_duration",
    "/jax/compilation_cache/cache_retrieval_time_sec",
)
_COMPILE = {"s": 0.0, "hits": 0, "misses": 0}
_COMPILE_LOCK = threading.Lock()


def _on_duration(event, duration, **_):
    if event in _COMPILE_EVENTS:
        with _COMPILE_LOCK:
            _COMPILE["s"] += duration


def _on_event(event, **_):
    with _COMPILE_LOCK:
        if event == "/jax/compilation_cache/cache_hits":
            _COMPILE["hits"] += 1
        elif event == "/jax/compilation_cache/cache_misses":
            _COMPILE["misses"] += 1


def _peak_bytes(devices=None):
    """Largest ``peak_bytes_in_use`` over ``devices`` (None where the
    backend keeps no such statistic, as the CPU does)."""
    import jax

    peaks = []
    for d in devices or jax.devices()[:1]:
        stats = d.memory_stats() or {}
        if "peak_bytes_in_use" in stats:
            peaks.append(int(stats["peak_bytes_in_use"]))
    return max(peaks) if peaks else None


@contextlib.contextmanager
def spy(module, name):
    """Record the arguments and result of the outermost call of
    ``module.name`` made while the block runs (the CLI looks its command
    runner up at dispatch time, so the recording sees the real call)."""
    orig = getattr(module, name)
    calls = []
    depth = [0]
    lock = threading.Lock()

    def wrapper(*args, **kw):
        with lock:
            depth[0] += 1
        try:
            out = orig(*args, **kw)
        finally:
            with lock:
                depth[0] -= 1
                outer = depth[0] == 0
        if outer:
            calls.append((args, kw, out))
        return out

    setattr(module, name, wrapper)
    try:
        yield calls
    finally:
        setattr(module, name, orig)


class Ctx:
    """Sizes, a scratch directory, the oracle pool and results shared
    between phases (later phases compare against earlier ones)."""

    def __init__(self, sizes: Sizes, seed: int, workdir: str, workers=None):
        self.sizes = sizes
        self.seed = seed
        self.workdir = workdir
        self.workers = workers or max(1, os.cpu_count() or 1)
        self.memo = {}
        self._pool = None
        shutil.rmtree(workdir, ignore_errors=True)
        os.makedirs(workdir)
        self.log = open(os.path.join(workdir, "cli.log"), "w")

    def path(self, *parts):
        p = os.path.join(self.workdir, *parts)
        os.makedirs(os.path.dirname(p), exist_ok=True)
        return p

    def outdir(self, name):
        d = self.path("out", name, "")
        shutil.rmtree(d, ignore_errors=True)
        os.makedirs(d)
        return d

    @property
    def pool(self):
        if self._pool is None:
            self._pool = ProcessPoolExecutor(
                self.workers, mp_context=multiprocessing.get_context("spawn"))
        return self._pool

    def close(self):
        if self._pool is not None:
            self._pool.shutdown(cancel_futures=True)
            self._pool = None
        self.log.close()

    def once(self, key, fn):
        if key not in self.memo:
            self.memo[key] = fn()
        return self.memo[key]

    # -- corpora ------------------------------------------------------------

    def corpus(self, tag, n, seed_off=0, min_len=None, max_len=None):
        """A generated FASTQ and its record end offsets (memoized)."""
        from gen import write_fastq_bulk

        s = self.sizes

        def make():
            path = self.path("data", "%s.fq" % tag)
            ends = write_fastq_bulk(
                path, n, min_len=min_len or s.read_len,
                max_len=max_len or s.read_len, seed=self.seed + seed_off,
                n_prob=0.005, qual_bins=RTA3_BINS)
            return path, ends

        return self.once(("corpus", tag), make)

    def se(self):
        return self.corpus("se", self.sizes.reads)

    # -- CLI ----------------------------------------------------------------

    def cli(self, *args):
        """Run one hpgq command in-process; its console output goes to the
        scratch log.  Returns the wall seconds."""
        from hpgq.cli.main import main

        argv = [str(a) for a in args] + [
            "--log-file", os.path.join(self.workdir, "hpg-fastq.log")]
        if self.sizes.batch_size:
            argv += ["--batch-size", str(self.sizes.batch_size)]
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(self.log):
            rc = main(argv)
        dt = time.perf_counter() - t0
        check(rc == 0, "hpgq %s exited %s" % (" ".join(argv), rc))
        return dt

    # -- oracle fan-out -----------------------------------------------------

    def ranges(self, ends, per_worker=4):
        """Record-aligned byte ranges (start, end, first, last) splitting a
        corpus into about ``per_worker`` pieces per worker."""
        n = len(ends)
        k = max(1, min(n, self.workers * per_worker))
        cuts = np.linspace(0, n, k + 1).astype(np.int64)
        starts = np.concatenate([[0], ends])
        return [(int(starts[a]), int(ends[b - 1]), int(a), int(b))
                for a, b in zip(cuts[:-1], cuts[1:]) if b > a]

    def oracle_stats(self, path, ends, kmers_on=False, crit=None, sel=None):
        from hpgq.core.counters import StatsCounters

        futs = [self.pool.submit(_w_stats, path, s, e, kmers_on, crit,
                                 None if sel is None else sel[a:b])
                for s, e, a, b in self.ranges(ends)]
        total = StatsCounters(phred=PHRED, kmers_on=kmers_on)
        for f in futs:
            total.merge(f.result())
        total.filter_on = crit is not None
        return total

    def oracle_verdicts(self, path, ends, crit):
        futs = [self.pool.submit(_w_verdicts, path, s, e, crit)
                for s, e, _, _ in self.ranges(ends)]
        return np.concatenate([f.result() for f in futs])

    def oracle_cgr(self, path, ends, k):
        futs = [self.pool.submit(_w_cgr, path, s, e, k)
                for s, e, _, _ in self.ranges(ends)]
        dim = 1 << k
        ts = np.zeros((dim, dim), np.int64)
        tq = np.zeros((dim, dim), np.int64)
        words = 0
        for f in futs:
            a, b, w = f.result()
            ts += a
            tq += b
            words += w
        return ts, tq, words


# ---------------------------------------------------------------------------
# comparisons
# ---------------------------------------------------------------------------

def check(cond, *detail):
    """The smoke's gate: unlike ``assert``, it holds under ``python -O``."""
    if not cond:
        raise AssertionError(", ".join(str(d) for d in detail))


def crit_of(kw):
    from hpgq.options import FilterCriteria

    return FilterCriteria(**kw)


def assert_counters(got, want, what):
    """Integer fields exact, acc_quality to 1e-5 relative
    (``StatsCounters.equals``); names the fields that differ."""
    if got.equals(want):
        return
    bad = []
    for name in vars(want):
        a, b = getattr(got, name), getattr(want, name)
        if isinstance(a, np.ndarray):
            m = min(a.shape[-1], b.shape[-1])
            ok = (np.array_equal(a[..., :m], b[..., :m])
                  and not a[..., m:].any() and not b[..., m:].any())
        elif isinstance(a, float):
            ok = abs(a - b) <= 1e-5 * max(1.0, abs(b))
        else:
            ok = a == b
        if not ok:
            bad.append("%s (%s vs oracle %s)" % (
                name, a if np.ndim(a) == 0 else "array",
                b if np.ndim(b) == 0 else "array"))
    raise AssertionError("%s: counters differ from the oracle: %s"
                         % (what, "; ".join(bad) or "equals() is False"))


def assert_same_file(got_path, want_bytes, what):
    with open(got_path, "rb") as f:
        got = f.read()
    if got != want_bytes:
        i = next((j for j, (x, y) in enumerate(zip(got, want_bytes))
                  if x != y), min(len(got), len(want_bytes)))
        raise AssertionError("%s: %s differs from the oracle at byte %d "
                             "(%d vs %d bytes)" % (what, got_path, i,
                                                   len(got), len(want_bytes)))


def assert_reports(ctx, opts, counters, engine_dir, what):
    """The report files the engine wrote == the files the writer makes from
    the oracle's counters (the .gnuplot scripts embed the output path and
    are left out)."""
    from hpgq.report.stats_report import stats_report

    odir = ctx.outdir(what + "_oracle_report")
    stats_report(counters, dataclasses.replace(opts, out_dirname=odir))
    names = sorted(n for n in os.listdir(odir)
                   if n.endswith((".txt", ".data")))
    check(names, "oracle report is empty")
    for n in names:
        with open(os.path.join(odir, n), "rb") as f:
            assert_same_file(os.path.join(engine_dir, n), f.read(), what)
    return len(names)


def record_bytes(path, ends, select):
    """The input records picked by ``select``, concatenated."""
    with open(path, "rb") as f:
        raw = f.read()
    starts = np.concatenate([[0], ends[:-1]])
    return b"".join(raw[s:e] for s, e, k in zip(starts, ends, select) if k)


def summary_lines(path, name):
    with open(path, "rb") as f:
        return [ln for ln in f.read().split(b"\n") if name.encode() not in ln]


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_device(ctx, platform="gpu"):
    """Phase 0: refuse anything but ``platform``; describe the machine
    (``ctx`` is unused: this phase runs before any scratch space exists)."""
    import jax
    import jaxlib

    from hpgq.io import native
    from hpgq.utils.compile_cache import cache_dir
    from hpgq.utils.device import card

    dev = jax.devices()[0]
    if dev.platform != platform:
        raise SystemExit("chip_smoke: JAX found no %s (platform %r)"
                         % (platform, dev.platform))
    print("device: %s x%d (%s)" % (dev.device_kind, len(jax.devices()),
                                   dev.platform))
    print("card: %s" % card())
    print("jax %s, jaxlib %s; compile cache %s" % (
        jax.__version__, jaxlib.__version__, cache_dir()))
    check(native.get_lib() is not None,
          "native packer did not load (the numpy fallback is refused here)")
    print("native packer: %s" % native.loaded_path)
    return {"detail": "%s, native packer loaded" % dev.device_kind}


def phase_stats(ctx):
    """Phase 1: stats + inline filter + k-mers vs the per-read oracle."""
    import hpgq.pipeline.run as run_mod

    path, ends = ctx.se()
    out = ctx.outdir("stats")
    with spy(run_mod, "run_stats") as calls:
        wall = ctx.cli("stats", "-f", path, "-o", out, "--kmers", *CRIT_FLAGS)
    (args, _, got), = calls
    opts, timers = args[0], args[1]
    crit = crit_of(CRIT_KW)
    check(dataclasses.astuple(opts.criteria.substituted())
          == dataclasses.astuple(crit.substituted()),
          "CLI parsed other criteria")
    want = ctx.oracle_stats(path, ends, kmers_on=True, crit=crit)
    assert_counters(got, want, "stats")
    nfiles = assert_reports(ctx, opts, want, out, "stats")
    ctx.memo["stats"] = dict(opts=opts, counters=got, oracle=want,
                             summary=os.path.join(out, "se.fq.summary.txt"),
                             wall=wall, batches=timers.num_batches)
    return {"reads": len(ends), "engine_s": wall,
            "detail": "%d passed / %d failed, %d report files byte-equal"
            % (got.num_passed, got.num_failed, nfiles)}


def phase1_result(ctx):
    """Phase 1's recorded result, running phase 1 first if it has not run."""
    if "stats" not in ctx.memo:
        phase_stats(ctx)
    return ctx.memo["stats"]


def phase_filter(ctx):
    """Phase 2: filter's passed/failed bytes vs the oracle partition."""
    path, ends = ctx.se()
    out = ctx.outdir("filter")
    wall = ctx.cli("filter", "-f", path, "-o", out, *CRIT_FLAGS)
    ok = ctx.oracle_verdicts(path, ends, crit_of(CRIT_KW))
    assert_same_file(out + "passed.fq", record_bytes(path, ends, ok), "filter")
    assert_same_file(out + "failed.fq", record_bytes(path, ends, ~ok),
                     "filter")
    return {"reads": len(ends), "engine_s": wall,
            "detail": "passed/failed bytes == oracle (%d/%d)"
            % (ok.sum(), (~ok).sum())}


def phase_edit(ctx):
    """Phase 3: edit.fq vs the numpy trims applied to the input."""
    from hpgq.oracle.baseline import block_trims

    path, ends = ctx.se()
    out = ctx.outdir("edit")
    wall = ctx.cli("edit", "-f", path, "-o", out, *EDIT_FLAGS)
    with open(path, "rb") as f:
        lines = f.read().split(b"\n")
    recs = list(zip(lines[1::4], lines[3::4]))
    _, quals, lens = _packed(recs)
    lt, rt = block_trims(quals, lens, crit_of(EDIT_KW), PHRED)
    parts = []
    for i, (s, q) in enumerate(recs):
        a, b = int(lt[i]), len(s) - int(rt[i])
        parts.append(b"%s\n%s\n%s\n%s\n" % (lines[4 * i], s[a:b],
                                            lines[4 * i + 2], q[a:b]))
    assert_same_file(out + "edit.fq", b"".join(parts), "edit")
    edited = int(((lt > 0) | (rt > 0)).sum())
    check(0 < edited < len(recs), edited)
    return {"reads": len(ends), "engine_s": wall,
            "detail": "edit.fq == trims applied to input (%d edited)" % edited}


def phase_paired(ctx):
    """Phase 4: paired filter + stats, pair-consistent, vs the oracle."""
    import hpgq.pipeline.run as run_mod

    n = ctx.sizes.pairs
    p1, e1 = ctx.corpus("m1", n, seed_off=1)
    p2, e2 = ctx.corpus("m2", n, seed_off=2)
    crit = crit_of(CRIT_KW)
    fout = ctx.outdir("paired_filter")
    wall = ctx.cli("filter", "--fq1", p1, "--fq2", p2, "-o", fout, *CRIT_FLAGS)
    sout = ctx.outdir("paired_stats")
    with spy(run_mod, "run_stats") as calls:
        wall += ctx.cli("stats", "--fq1", p1, "--fq2", p2, "-o", sout,
                        *CRIT_FLAGS)
    (_, _, (c1, c2)), = calls
    both = ctx.oracle_verdicts(p1, e1, crit) & ctx.oracle_verdicts(p2, e2,
                                                                   crit)
    for name, p, e, keep in (("passed_1", p1, e1, both),
                             ("passed_2", p2, e2, both),
                             ("failed_1", p1, e1, ~both),
                             ("failed_2", p2, e2, ~both)):
        assert_same_file(fout + name + ".fq", record_bytes(p, e, keep),
                         "paired filter")
    for got, p, e in ((c1, p1, e1), (c2, p2, e2)):
        want = ctx.oracle_stats(p, e, sel=both)
        want.filter_on = True
        want.num_passed, want.num_failed = int(both.sum()), int((~both).sum())
        assert_counters(got, want, "paired stats")
    return {"reads": 2 * n, "engine_s": wall,
            "detail": "4 filter outputs + both mates' counters == oracle "
            "(%d pairs passed)" % both.sum()}


def _cgr_run(ctx, path, k, out, *extra):
    import hpgq.pipeline.cgr_run as cgr_mod

    with spy(cgr_mod, "run_cgr") as calls:
        wall = ctx.cli("cgr", "-f", path, "-o", out, "--k", k, *extra)
    (_, _, res), = calls
    return res, wall


def phase_cgr(ctx):
    """Phase 5: CGR tables at k=7 and k=8 vs the f64 loop oracle."""
    path, ends = ctx.corpus("cgr", ctx.sizes.cgr_reads, seed_off=5)
    wall = 0.0
    for k in (7, 8):
        res, dt = _cgr_run(ctx, path, k, ctx.outdir("cgr%d" % k))
        wall += dt
        ts, tq, words = ctx.once(("cgr_oracle", k),
                                 lambda: ctx.oracle_cgr(path, ends, k))
        check(res["fq_word_count"] == words, (k, res["fq_word_count"], words))
        check(np.array_equal(np.asarray(res["table_seq"]), ts),
              "cgr k=%d table_seq differs" % k)
        check(np.array_equal(np.asarray(res["table_q"]), tq),
              "cgr k=%d table_q differs" % k)
        ctx.memo[("cgr", k)] = res
    return {"reads": 2 * len(ends), "engine_s": wall,
            "detail": "k=7,8 tables + word counts exact (%d words at k=8)"
            % words}


def padding_waste(path, batch_size):
    """Share of the device's [rows, lcap] cells that padding fills, for the
    blocks the reader makes of ``path`` (rows bucketed as the session does,
    lcap growing to the longest read so far)."""
    from hpgq.io.fastq import FastqReader
    from hpgq.io.packer import bucket_rows, round_up

    real = padded = 0
    lcap = 128
    with FastqReader(path, batch_size=batch_size) as rd:
        for block in rd:
            lcap = max(lcap, round_up(block.max_len(), 128))
            real += int(block.seq_lens.sum())
            padded += bucket_rows(block.num_reads, batch_size) * lcap
    return 1.0 - real / max(padded, 1)


def phase_long(ctx):
    """Phase 6: long reads (10-25 kbp) with criteria vs the oracle."""
    import hpgq.pipeline.run as run_mod

    s = ctx.sizes
    path, ends = ctx.corpus("long", s.long_reads, seed_off=6,
                            min_len=s.long_min, max_len=s.long_max)
    out = ctx.outdir("long")
    with spy(run_mod, "run_stats") as calls:
        wall = ctx.cli("stats", "-f", path, "-o", out, *LONG_FLAGS)
    (args, _, got), = calls
    want = ctx.oracle_stats(path, ends, crit=crit_of(LONG_KW))
    assert_counters(got, want, "long-read stats")
    waste = padding_waste(path, run_mod._reader_batch(args[0]))
    return {"reads": len(ends), "engine_s": wall,
            "detail": "counters == oracle (%d passed); padding waste %.4f"
            % (got.num_passed, waste)}


def phase_compressed(ctx):
    """Phase 7: the phase-1 corpus as .gz and as BGZF == the plain run."""
    import hpgq.pipeline.run as run_mod
    from hpgq.io.bgzf import write_bgzf

    path, ends = ctx.se()
    ref = phase1_result(ctx)
    with open(path, "rb") as f:
        raw = f.read()
    gz = ctx.path("data", "se.fq.gz")
    with gzip.open(gz, "wb", compresslevel=1) as g:
        g.write(raw)
    bgz = write_bgzf(ctx.path("data", "se.fq.bgz"), raw)
    del raw
    want = summary_lines(ref["summary"], "se.fq")
    wall = 0.0
    for name, p in (("gz", gz), ("bgzf", bgz)):
        out = ctx.outdir("compressed_" + name)
        with spy(run_mod, "run_stats") as calls:
            wall += ctx.cli("stats", "-f", p, "-o", out, "--kmers",
                            *CRIT_FLAGS)
        (_, _, got), = calls
        assert_counters(got, ref["oracle"], name + " stats")
        base = os.path.basename(p)
        got_lines = summary_lines(out + base + ".summary.txt", base)
        check(got_lines == want,
              "%s summary differs from the plain run" % name)
    return {"reads": 2 * len(ends), "engine_s": wall,
            "detail": ".gz and BGZF summaries == plain run"}


def phase_sharded(ctx):
    """Phase 8: --sharded stats and cgr on the one-device mesh."""
    import hpgq.dist.run_dist as dist_mod

    path, ends = ctx.se()
    ref = phase1_result(ctx)
    out = ctx.outdir("sharded_stats")
    with spy(dist_mod, "run_stats_sharded") as calls:
        wall = ctx.cli("stats", "--sharded", "-f", path, "-o", out, "--kmers",
                       *CRIT_FLAGS)
    (_, _, got), = calls
    assert_counters(got, ref["oracle"], "sharded stats")
    with open(ref["summary"], "rb") as f:
        assert_same_file(out + "se.fq.summary.txt", f.read(), "sharded stats")
    cpath, cends = ctx.corpus("cgr", ctx.sizes.cgr_reads, seed_off=5)
    for k in (7, 8):
        want = ctx.once(("cgr", k), lambda: _cgr_run(
            ctx, cpath, k, ctx.outdir("cgr%d" % k))[0])
        res, dt = _cgr_run(ctx, cpath, k, ctx.outdir("sharded_cgr%d" % k),
                           "--sharded")
        wall += dt
        check(res["fq_word_count"] == want["fq_word_count"], k)
        for key in ("table_seq", "table_q"):
            check(np.array_equal(np.asarray(res[key]), np.asarray(want[key])),
                  "sharded cgr k=%d %s differs" % (k, key))
    return {"reads": len(ends) + 2 * len(cends), "engine_s": wall,
            "detail": "1-device mesh == phases 1 and 5"}


def _rand_batch(B, L, seed):
    rng = np.random.default_rng(seed)
    lens = rng.integers(max(1, L - 100), L + 1, size=B).astype(np.int32)
    pos = np.arange(L)[None, :]
    live = pos < lens[:, None]
    codes = np.where(live, rng.integers(0, 4, size=(B, L), dtype=np.int8),
                     np.int8(5))
    quals = np.where(live, np.asarray(RTA3_BINS, np.uint8)[
        rng.integers(0, 4, size=(B, L), dtype=np.uint8)] + PHRED, 0)
    return codes, quals.astype(np.uint8), lens, np.ones(B, bool)


def _time_steps(step, acc, batch, reps):
    """Mean seconds per warm step (device-resident inputs, donated
    accumulator, closed by block_until_ready)."""
    import jax

    acc = jax.block_until_ready(step(acc, *batch))  # compile + warm
    t0 = time.perf_counter()
    for _ in range(reps):
        acc = step(acc, *batch)
    jax.block_until_ready(acc)
    return (time.perf_counter() - t0) / reps


def phase_step_time(ctx, reps=20):
    """Phase 9 (a record, not a gate): warm step times beside the HBM byte
    floor, and the steps' share of phase 1's wall."""
    import jax

    from hpgq.kernels.cgr import make_cgr_step, zero_cgr_acc
    from hpgq.kernels.stats_jnp import make_stats_step, zero_partials

    B = ctx.sizes.step_rows
    crit = crit_of(CRIT_KW)
    times = {}
    for L in (128, 256):
        batch = jax.device_put(_rand_batch(B, L, ctx.seed))
        in_bytes = sum(x.nbytes for x in batch)
        for tag, c, kmers in (("plain", None, False), ("crit", crit, False),
                              ("crit+kmers", crit, True)):
            step = make_stats_step(L, PHRED, kmers, c)
            acc = jax.device_put(zero_partials(L, kmers))
            acc_bytes = sum(x.nbytes for x in jax.tree_util.tree_leaves(acc))
            t = _time_steps(step, acc, batch, reps)
            floor = (in_bytes + 2 * acc_bytes) / HBM_BYTES_PER_S
            times[(L, tag)] = t
            print("  step stats B=%d L=%d %-10s %10.1f us  floor %7.1f us  "
                  "x%.1f" % (B, L, tag, t * 1e6, floor * 1e6, t / floor))
    L = 256
    batch = jax.device_put(_rand_batch(B, L, ctx.seed))
    t = _time_steps(make_cgr_step(7, PHRED),
                    jax.device_put(zero_cgr_acc(7)), batch, reps)
    floor = sum(x.nbytes for x in batch) / HBM_BYTES_PER_S
    times["cgr7"] = t
    print("  step cgr   B=%d L=%d k=7        %10.1f us  floor %7.1f us  x%.1f"
          % (B, L, t * 1e6, floor * 1e6, t / floor))
    ref = ctx.memo.get("stats")
    share = ""
    if ref:
        # device time to step phase 1's reads at the B-row rate, over the
        # phase's wall (the reads are 150 bp, so L=256 is their bucket)
        dev_s = times[(256, "crit+kmers")] * ctx.sizes.reads / B
        share = "; stats step = %.4f of phase-1 wall (%d batches)" % (
            dev_s / ref["wall"], ref["batches"])
    return {"reads": None, "engine_s": None,
            "detail": "B=%d, %d reps each%s" % (B, reps, share)}


PHASES = (
    ("1", "stats+filter+kmers", phase_stats),
    ("2", "filter", phase_filter),
    ("3", "edit", phase_edit),
    ("4", "paired", phase_paired),
    ("5", "cgr", phase_cgr),
    ("6", "long reads", phase_long),
    ("7", "compressed", phase_compressed),
    ("8", "sharded 1-device", phase_sharded),
    ("9", "step time", phase_step_time),
)


def run_phase(num, name, fn, ctx, devices=None):
    """Run one phase; print its line.  Returns True when it passed."""
    with _COMPILE_LOCK:
        c0 = _COMPILE["s"]
    t0 = time.perf_counter()
    try:
        res = fn(ctx)
        status = "PASS"
    except Exception as e:  # reported, and fails the run
        traceback.print_exc(file=sys.stderr)
        res, status = {"detail": "%s: %s" % (type(e).__name__, e)}, "FAIL"
    wall = time.perf_counter() - t0
    with _COMPILE_LOCK:
        compile_s = _COMPILE["s"] - c0
    eng = res.get("engine_s")
    reads = res.get("reads")
    rate = reads / eng if reads and eng else None
    print("phase %s %-18s %s  wall_s=%.3f engine_s=%s reads_per_s=%s "
          "compile_s=%.3f peak_bytes=%s | %s" % (
              num, name, status, wall,
              "%.3f" % eng if eng is not None else "-",
              "%.1f" % rate if rate is not None else "-",
              compile_s, _peak_bytes(devices), res.get("detail", "")),
          flush=True)
    return status == "PASS"


# ---------------------------------------------------------------------------
# --four-cards
# ---------------------------------------------------------------------------

def four_cards(ctx, n=4):
    """The multi-device path on ``jax.devices()[:n]``, each leg compared with
    the same run on ``jax.devices()[:1]`` in this process."""
    import jax

    import __graft_entry__
    import hpgq.dist.run_dist as dist_mod
    import hpgq.pipeline.cgr_run as cgr_mod
    from hpgq.dist.mesh import data_mesh
    from hpgq.io.bgzf import write_bgzf

    devs = jax.devices()
    check(len(devs) == n, "need exactly %d devices, have %d" % (n, len(devs)))
    one = data_mesh(devs[:1])
    s = ctx.sizes
    legs = []

    def leg(name, fn):
        legs.append(run_phase("4c", name, lambda _ctx: fn(), ctx, devs))

    def sharded_stats(argv, out_name):
        out = ctx.outdir(out_name)
        with spy(dist_mod, "run_stats_sharded") as calls:
            wall = ctx.cli("stats", "--sharded", "-o", out, *argv)
        (args, _, got), = calls
        ref = dist_mod.run_stats_sharded(
            dataclasses.replace(args[0], out_dirname=ctx.outdir(
                out_name + "_1dev")), mesh=one)
        return got, ref, wall

    def stats_bgzf():
        path, ends = ctx.corpus("four", s.four_reads, seed_off=40)
        with open(path, "rb") as f:
            bgz = write_bgzf(ctx.path("data", "four.fq.bgz"), f.read())
        got, ref, wall = sharded_stats(["-f", bgz, "--kmers", *CRIT_FLAGS],
                                       "four_stats")
        assert_counters(got, ref, "4-device BGZF stats vs 1 device")
        return {"reads": len(ends), "engine_s": wall,
                "detail": "stats --sharded --kmers over BGZF, %d devices == "
                "1 device" % n}

    def stats_paired():
        p1, e1 = ctx.corpus("four_m1", s.four_reads // 2, seed_off=41)
        p2, _ = ctx.corpus("four_m2", s.four_reads // 2, seed_off=42)
        (g1, g2), (r1, r2), wall = sharded_stats(
            ["--fq1", p1, "--fq2", p2, *CRIT_FLAGS], "four_paired")
        assert_counters(g1, r1, "4-device paired mate 1")
        assert_counters(g2, r2, "4-device paired mate 2")
        return {"reads": 2 * len(e1), "engine_s": wall,
                "detail": "paired stats --sharded == 1 device"}

    def cgr():
        path, ends = ctx.corpus("cgr", s.cgr_reads, seed_off=5)
        out = ctx.outdir("four_cgr")
        with spy(cgr_mod, "run_cgr") as calls:
            wall = ctx.cli("cgr", "--sharded", "-f", path, "-o", out,
                           "--k", 7)
        (args, _, got), = calls
        ref = dist_mod.run_cgr_sharded(
            dataclasses.replace(args[0], out_dirname=ctx.outdir(
                "four_cgr_1dev")), mesh=one)
        check(got["fq_word_count"] == ref["fq_word_count"])
        for key in ("table_seq", "table_q"):
            check(np.array_equal(np.asarray(got[key]),
                                 np.asarray(ref[key])), key)
        return {"reads": len(ends), "engine_s": wall,
                "detail": "cgr --sharded k=7 == 1 device"}

    def checks():
        t0 = time.perf_counter()
        msg = __graft_entry__.multichip_checks(devs[:n])
        return {"reads": None, "engine_s": time.perf_counter() - t0,
                "detail": msg}

    leg("stats BGZF", stats_bgzf)
    leg("paired stats", stats_paired)
    leg("cgr", cgr)
    leg("multichip_checks", checks)
    return all(legs)


# ---------------------------------------------------------------------------

def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reads", type=int, default=None,
                    help="phase-1 corpus size (default 1,000,000); the "
                    "paired and CGR corpora scale with it")
    ap.add_argument("--long-reads", type=int, default=None,
                    help="phase-6 read count (default 2,000)")
    ap.add_argument("--step-rows", type=int, default=None,
                    help="phase-9 batch rows (default 131,072)")
    ap.add_argument("--batch-size", type=int, default=0,
                    help="pass --batch-size to every command (rehearsals "
                    "at a tiny size; default: the CLI's own)")
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the multi-device path on 4 GPUs")
    ap.add_argument("--workdir", default=os.path.join(HERE, ".bench",
                                                      "chip_smoke"))
    ap.add_argument("--rehearse-on-cpu", action="store_true",
                    help="accept the CPU backend (a rehearsal: the last "
                    "line then reports no result)")
    return ap.parse_args(argv)


def sizes_of(args):
    s = Sizes()
    if args.reads:
        s.reads = args.reads
        s.pairs = min(s.pairs, max(1, args.reads // 2))
        s.cgr_reads = min(s.cgr_reads, max(1, args.reads // 5))
        s.four_reads = min(s.four_reads, args.reads)
    if args.long_reads:
        s.long_reads = args.long_reads
    if args.step_rows:
        s.step_rows = args.step_rows
    s.batch_size = args.batch_size
    return s


def main(argv=None):
    args = parse_args(argv)
    os.environ["HPGQ_CHARTS"] = "off"
    import jax

    from hpgq.utils.compile_cache import enable
    from hpgq.utils.device import device_info

    enable()
    jax.monitoring.register_event_duration_secs_listener(_on_duration)
    jax.monitoring.register_event_listener(_on_event)
    platform = "cpu" if args.rehearse_on_cpu else "gpu"
    t0 = time.perf_counter()
    if not run_phase("0", "device", lambda c: phase_device(c, platform),
                     None):
        return 1
    ctx = Ctx(sizes_of(args), args.seed, args.workdir)
    try:
        if args.four_cards:
            ok = four_cards(ctx)
        else:
            ok = all([run_phase(num, name, fn, ctx)
                      for num, name, fn in PHASES])
    finally:
        ctx.close()
    print("total_s=%.3f compile_s=%.3f cache_hits=%d cache_misses=%d" % (
        time.perf_counter() - t0, _COMPILE["s"], _COMPILE["hits"],
        _COMPILE["misses"]), flush=True)
    if not ok:
        return 1
    shutil.rmtree(args.workdir, ignore_errors=True)
    if args.rehearse_on_cpu:
        print(json.dumps({"rehearsal": True, "device": device_info()}))
        return 0
    print(json.dumps({"ok": True, "device": device_info()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
