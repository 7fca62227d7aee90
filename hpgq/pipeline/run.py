"""Command pipelines: stats / filter / edit, single-end and paired-end.

The accelerator reshaping of the reference's producer→worker→consumer
workflows (``src/stats_fastq.c:423-504``, ``src/filter_fastq.c:180-247``,
``src/edit_fastq.c:212-286``): the host streams packed batches to jitted
device kernels; stats accumulate on device (flushed in O(1) syncs), while
filter/edit fetch per-read verdict/trim vectors back and re-slice the
original record bytes in input order (order preservation is trivial because
records never leave the host).

Paired-end (reference capability via the legacy engine,
``old/main_hpg_fastq_old.c:726-728``): mates stream in lockstep and a pair is
discarded when *either* mate fails (pair-consistent discard — both mates
dropped together); outputs are written per mate.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from ..io.fastq import AsyncSpanPump, FastqReader, FastqWriter
from ..kernels.stats_jnp import _crit_key
from ..io.packer import bucket_rows, pack_block, pack_block_fused, round_up
from ..kernels import stats_jnp
from ..options import EditOptions, FilterOptions, StatsOptions
from ..report.stats_report import stats_report
from ..utils.timers import StageTimers
from .session import ShapeCachedFn, ShapeCachedPairFn, StatsSession


def _batch_reads(opts) -> int:
    # an explicit --device-batch-reads is the user's device-memory cap —
    # honor it verbatim (blocks larger than it still dispatch at their own
    # row count; the cap only bounds padding)
    if int(opts.device_batch_reads):
        return int(opts.device_batch_reads)
    # dispatch-coalesced runs bucket merged blocks' rows against the
    # coalescing target, not the (small) reader block size
    return max(256, round_up(max(int(opts.batch_size), _reader_batch(opts),
                                 _coalesce_reads(opts)),
                             256))


def _reader_batch(opts) -> int:
    """Reader block size in reads.

    ``--batch-size`` defaults to the reference's 10,000 for flag parity,
    but on an accelerator that means one host->device transfer and one
    dispatch per 10k reads, each with a fixed cost that a 10k-read batch
    does not amortize.  When the batch knobs were left untouched, feed
    accelerator-sized blocks instead: results are batch-size-invariant by
    construction (tested), and the PARAMETERS echo keeps showing the
    configured value.

    The upgrade is suppressed when any of these holds:
    * the CLI saw an explicit ``--batch-size`` (presence-tracked via
      ``opts.batch_size_set``; an explicit 10000 is honored),
    * ``--device-batch-reads`` is set (the user is hand-tuning batching),
    * a checkpoint is configured (``--checkpoint-every`` counts blocks —
      silently inflating blocks 13x would gut the checkpoint cadence)."""
    from ..constants import DEFAULT_BATCH_SIZE

    if (int(opts.device_batch_reads) == 0
            and not getattr(opts, "batch_size_set", False)
            and int(opts.batch_size) == DEFAULT_BATCH_SIZE
            and not getattr(opts, "checkpoint_path", None)):
        import jax

        if jax.default_backend() != "cpu":
            return 131072
    return int(opts.batch_size)


def _coalesce_reads(opts) -> int:
    """Dispatch-coalescing target in reads (0 = off).

    An explicit small ``--batch-size`` (e.g. the reference's 10000) keeps
    the READER block size exact but makes every block its own device
    round-trip, each with a fixed transfer and dispatch cost.  When the
    dispatch size is otherwise unconstrained, consecutive same-chunk
    blocks are merged (zero-copy, ``io.fastq.coalesce_blocks``) so one
    dispatch covers ~131072 reads; block content, order, and offsets are
    untouched.  Suppressed when:

    * a checkpoint is configured (``--checkpoint-every`` counts blocks),
    * ``--device-batch-reads`` is set (the user hand-tunes dispatching),
    * blocks are already accelerator-sized (incl. the auto upgrade),
    * the backend is local CPU (dispatch latency is negligible).

    ``HPGQ_COALESCE=<reads>`` overrides everything (0 forces off)."""
    env = os.environ.get("HPGQ_COALESCE")
    if env is not None:
        return max(0, int(env))
    if getattr(opts, "checkpoint_path", None):
        return 0
    if int(opts.device_batch_reads):
        return 0
    if _reader_batch(opts) >= 65536:
        return 0
    import jax

    if jax.default_backend() == "cpu":
        return 0
    return 131072


def _coalesced(opts, reader):
    """``reader``'s block iterator, dispatch-coalesced when eligible."""
    tgt = _coalesce_reads(opts)
    if not tgt:
        return reader
    from ..io.fastq import coalesce_blocks

    return coalesce_blocks(iter(reader), tgt)


def _iter_blocks(reader, timers, prefetch_depth: int = 3):
    """Blocks via the background producer thread (read/index run ahead of
    compute; 'read' time below is queue-wait, i.e. non-overlapped read)."""
    from .prefetch import prefetched

    it = prefetched(iter(reader), depth=prefetch_depth)
    while True:
        with timers.stage("read"):
            block = next(it, None)
        if block is None:
            return
        timers.num_batches += 1
        timers.total_reads += block.num_reads
        timers.total_bytes += block.span_bytes
        yield block


def _pack_workers() -> int:
    """Transform-pool width for the packed pipeline (HPGQ_PACK_THREADS;
    0/unset = auto).  Several pack+transfer stages in flight hide both the
    host pack time and the host->device transfer time."""
    n = int(os.environ.get("HPGQ_PACK_THREADS", "0") or 0)
    if n > 0:
        return n
    return max(1, min(4, (os.cpu_count() or 2) - 1))


def _iter_packed(reader, sess, batch_reads: int, timers, depth: int = 0,
                 workers: int = 0):
    """(block, device_arrays) with pack + host->device transfer fanned out
    over a small thread pool — the device step of batch n overlaps the
    read, pack, and transfer of batches n+1..n+depth (SURVEY §2.3 P1/P2)."""
    import jax

    from .prefetch import prefetched

    def transform(block):
        lmax = round_up(max(block.max_len(), 1), 128)
        L = max(lmax, sess.lcap)
        wire = getattr(sess.acc, "wire", None)
        rows = bucket_rows(block.num_reads, batch_reads)
        if wire in ("bitpack", "fused4"):
            from ..io.packer import (
                pack_block_wire,
                try_pack_block_2u,
                wire_len,
            )

            if wire == "bitpack":
                u = try_pack_block_2u(block, pad_reads_to=rows)
                if u is not None:
                    buf, exc, pal, n_valid, Lu = u
                    dbuf, dexc, dpal = jax.device_put((buf, exc, pal))
                    return block, (("2u", dbuf, dexc, dpal, n_valid, Lu),)
            buf = pack_block_wire(block, wire, wire_len(block.max_len(), L),
                                  pad_reads_to=rows, allow6=True,
                                  allow2c=True)
            return block, (jax.device_put(buf),)
        packed = pack_block(block, max_len=L, pad_reads_to=rows)
        if wire == "pack4":
            from ..kernels.stats_jnp import wire_pack4

            packed = (wire_pack4(packed[0]),) + packed[1:]
        return block, jax.device_put(packed)

    workers = workers or _pack_workers()
    it = prefetched(iter(reader), depth=depth or (workers + 2),
                    transform=transform, workers=workers)
    while True:
        with timers.stage("read"):
            item = next(it, None)
        if item is None:
            return
        block, arrs = item
        timers.num_batches += 1
        timers.total_reads += block.num_reads
        timers.total_bytes += block.span_bytes
        yield block, arrs


def _iter_with(reader, fn, timers, depth: int = 0):
    """(block, fn(block)) with ``fn`` (device verdict/trim kernels) running
    in the producer pool — the pack+H2D+compute of batch n+1 overlaps the
    span writes of batch n.  Input order is preserved (the pool resolves
    futures in submission order), so outputs stay byte-identical."""
    from .prefetch import prefetched

    workers = _pack_workers()

    def transform(block):
        with timers.stage("compute"):
            return block, fn(block)

    it = prefetched(iter(reader), depth=depth or (workers + 2),
                    transform=transform, workers=workers)
    for block, out in it:
        timers.num_batches += 1
        timers.total_reads += block.num_reads
        timers.total_bytes += block.span_bytes
        yield block, out


def _iter_packed_paired(pairs, sess, timers, workers: int = 0):
    """(b1, b2, in1, in2) with BOTH mates' pack + host→device transfer
    fanned out over the transform pool — the fused pair step of batch n
    overlaps the read, pack, and transfer of pairs n+1..n+depth (the
    paired analog of ``_iter_packed``; the paired path previously packed
    on the feeding thread, serializing pack+H2D with the dispatch)."""
    import jax

    from .prefetch import prefetched

    def transform(pair):
        b1, b2 = pair
        in1, in2 = sess.pack_pair(b1, b2)

        def dput(x):
            # device_put handles the bare wire buffer, the 2c
            # (buf, exc) pair, and the (codes, quals, lens, valid)
            # tuple; the 2u tagged tuple carries a str + host ints that
            # must stay host-side
            if isinstance(x, tuple) and x and isinstance(x[0], str):
                return (x[0],) + tuple(jax.device_put(x[1:4])) + x[4:]
            return jax.device_put(x)

        return b1, b2, dput(in1), dput(in2)

    workers = workers or _pack_workers()
    it = prefetched(iter(pairs), depth=workers + 2, transform=transform,
                    workers=workers)
    # NOTE: no stage("read") here — the wrapped _iter_blocks_paired already
    # accounts the real reads on the producer thread; tagging the queue
    # wait too would double-count the stage in --t reports
    while True:
        item = next(it, None)
        if item is None:
            return
        yield item


def _iter_blocks_paired(r1, r2, timers):
    """Lockstep paired iteration, re-sliced to common record counts.

    The two mate files have identical record counts but different byte
    layouts, so their readers' chunk boundaries (and therefore block sizes)
    disagree — each side is re-sliced so every yielded pair covers the same
    record range (pair i of b1 = pair i of b2)."""
    from .prefetch import prefetched

    i1 = prefetched(iter(r1), depth=2)
    i2 = prefetched(iter(r2), depth=2)
    b1 = b2 = None
    p1 = p2 = 0
    while True:
        with timers.stage("read"):
            if b1 is None or p1 >= b1.num_reads:
                b1 = next(i1, None)
                p1 = 0
            if b2 is None or p2 >= b2.num_reads:
                b2 = next(i2, None)
                p2 = 0
        if b1 is None and b2 is None:
            return
        if b1 is None or b2 is None:
            raise ValueError(
                "paired-end inputs have mismatched record counts; "
                "both mates must pair up 1:1"
            )
        n = min(b1.num_reads - p1, b2.num_reads - p2)
        s1 = b1.slice(p1, p1 + n)
        s2 = b2.slice(p2, p2 + n)
        p1 += n
        p2 += n
        timers.num_batches += 1
        timers.total_reads += 2 * n
        timers.total_bytes += s1.span_bytes + s2.span_bytes
        yield s1, s2


# ---------------------------------------------------------------------------
# stats
# ---------------------------------------------------------------------------

def _stats_config_key(opts, crit) -> str:
    import dataclasses
    import json

    return json.dumps({
        "cmd": "stats",
        "in": os.path.abspath(opts.in_filename),
        "phred": opts.quality_encoding_value,
        "kmers": opts.kmers_on,
        "crit": dataclasses.astuple(crit) if crit is not None else None,
    }, sort_keys=True)


class _Profiler:
    """jax.profiler trace around the streaming loop (--profile-dir)."""

    def __init__(self, profile_dir):
        self.dir = profile_dir

    def __enter__(self):
        if self.dir:
            import jax

            jax.profiler.start_trace(self.dir)
        return self

    def __exit__(self, *exc):
        if self.dir:
            import jax

            jax.profiler.stop_trace()


def _read_shards() -> int:
    """Concurrent byte-range readers for order-invariant pipelines
    (HPGQ_READ_SHARDS; 0/unset = auto).  Each shard runs its own
    read->index->pack->transfer chain, so the serial chunk indexing stops
    being the pipeline ceiling — the single-host reshaping of the
    reference's N parser threads (``workflow_run_with``,
    src/stats_fastq.c:465)."""
    n = int(os.environ.get("HPGQ_READ_SHARDS", "0") or 0)
    if n > 0:
        return n
    return max(1, min(4, (os.cpu_count() or 2) // 2))


_PARALLEL_MIN_BYTES = 32 << 20  # below this, shard setup outweighs the win


def _run_stats_parallel(opts, timers, crit, br, nshards: int,
                        report: bool = True):
    """Single-end stats over ``nshards`` concurrent byte-range readers.

    Stats accumulation is a commutative monoid, so shards process their
    record-aligned ranges independently (each with its own device
    accumulator) and the host counters merge IN SHARD ORDER at the end —
    results are deterministic for every integer field; the f32
    ``acc_quality`` device sum may differ from the serial order in the last
    bits (same tolerance as batch-order effects, see CLAUDE.md notes)."""
    import threading

    from ..dist.mesh import split_byte_ranges

    ranges = split_byte_ranges(opts.in_filename, nshards)
    results = [None] * nshards
    errors = []

    def work(i: int, start: int, end: int):
        try:
            t = StageTimers()
            sess = StatsSession(
                opts.quality_encoding_value, opts.kmers_on, crit,
                batch_reads=br,
            )
            with FastqReader(opts.in_filename, batch_size=_reader_batch(opts),
                             start_offset=start, end_offset=end) as rd:
                for block, arrs in _iter_packed(_coalesced(opts, rd), sess, br,
                                                t, workers=1):
                    with t.stage("compute"):
                        sess.feed_packed(*arrs)
            with t.stage("compute"):
                results[i] = (sess.finish(), t)
        except BaseException as e:
            errors.append(e)

    threads = [
        threading.Thread(target=work, args=(i, s, e), daemon=True,
                         name="hpgq-shard%d" % i)
        for i, (s, e) in enumerate(ranges)
    ]
    with _Profiler(opts.profile_dir):
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    if errors:
        raise errors[0]
    counters = None
    for res, t in results:
        timers.merge_from(t)
        counters = res if counters is None else counters.merge(res)
    if report:
        with timers.stage("reporting"):
            stats_report(counters, opts)
    return counters


def _run_stats_parallel_paired(opts, timers, report: bool = True):
    """Paired stats over concurrent record-count-aligned shard pairs
    (``split_paired_ranges``): each shard thread runs the serial paired
    loop on its range pair (pair-consistency is per record index, so shard
    boundaries are safe), counters merge in shard order, one report."""
    import dataclasses
    import threading

    from ..dist.mesh import split_paired_ranges

    nshards = _read_shards()
    pairs = split_paired_ranges(opts.in_filename, opts.in_filename2, nshards)
    results = [None] * nshards
    errors = []

    def work(i: int, rp):
        try:
            local = dataclasses.replace(opts)
            local.input_range, local.input_range2 = rp
            t = StageTimers()
            results[i] = (run_stats(local, t, report=False), t)
        except BaseException as e:
            errors.append(e)

    threads = [
        threading.Thread(target=work, args=(i, rp), daemon=True,
                         name="hpgq-pshard%d" % i)
        for i, rp in enumerate(pairs)
    ]
    with _Profiler(opts.profile_dir):
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    if errors:
        raise errors[0]
    c1 = c2 = None
    for (r1, r2), t in results:
        timers.merge_from(t)
        c1 = r1 if c1 is None else c1.merge(r1)
        c2 = r2 if c2 is None else c2.merge(r2)
    if report:
        with timers.stage("reporting"):
            stats_report(c1, opts)
            opts2 = dataclasses.replace(opts, in_filename=opts.in_filename2)
            stats_report(c2, opts2)
    return c1, c2


def run_stats(opts: StatsOptions, timers: Optional[StageTimers] = None,
              report: bool = True):
    """The `stats` command (single- or paired-end). Returns counters
    (a (counters1, counters2) tuple when paired).  ``report=False`` skips
    the file emission (shard workers; the merged result reports once)."""
    timers = timers or StageTimers()
    crit = opts.criteria if opts.filter_on else None
    br = _batch_reads(opts)

    if not opts.paired_end:
        from ..utils.checkpoint import (
            load_counters_checkpoint,
            save_counters_checkpoint,
        )

        if _output_parallel_eligible(opts):
            return _run_stats_parallel(opts, timers, crit, br,
                                       _read_shards(), report=report)

        ck_path = opts.checkpoint_path
        ck_every = opts.checkpoint_every or 50
        ck_key = _stats_config_key(opts, crit) if ck_path else None
        start = 0
        resumed = None
        if ck_path:
            loaded = load_counters_checkpoint(ck_path, ck_key)
            if loaded:
                resumed, start, _ = loaded

        sess = StatsSession(
            opts.quality_encoding_value, opts.kmers_on, crit, batch_reads=br,
            lcap=max(128, resumed.lcap) if resumed else 128,
        )
        if resumed:
            resumed.ensure_length(sess.lcap)
            sess.acc.counters = resumed
        nb = 0
        rng = getattr(opts, "input_range", None) or (0, None)
        with FastqReader(
            opts.in_filename, batch_size=_reader_batch(opts),
            start_offset=max(start, rng[0]), end_offset=rng[1]
        ) as rd, _Profiler(opts.profile_dir):
            for block, arrs in _iter_packed(_coalesced(opts, rd), sess, br,
                                            timers,
                                            depth=getattr(opts, "batch_list_size", 0)):
                with timers.stage("compute"):
                    sess.feed_packed(*arrs)
                nb += 1
                if ck_path and nb % ck_every == 0:
                    with timers.stage("checkpoint"):
                        sess.acc.flush()
                        save_counters_checkpoint(
                            ck_path, sess.acc.counters, block.end_offset, ck_key
                        )
        with timers.stage("compute"):
            counters = sess.finish()
        if ck_path and os.path.exists(ck_path):
            os.unlink(ck_path)  # run completed; stale resume would re-read
        if report:
            with timers.stage("reporting"):
                stats_report(counters, opts)
        return counters

    # paired-end: two accumulators; with filtering, stats cover pairs where
    # BOTH mates pass (pair-consistent), counted per pair.
    if _output_parallel_eligible(opts):
        return _run_stats_parallel_paired(opts, timers, report=report)

    from ..utils.checkpoint import (
        load_counters_checkpoint,
        save_counters_checkpoint,
    )
    from .session import PairedStatsSession

    phred = opts.quality_encoding_value
    # one fused dispatch per batch: verdicts (pair-consistent) + both
    # accumulators inside a single jitted step (make_paired_stats_step) —
    # replaces the 4-dispatch verdict/feed loop
    sess = PairedStatsSession(phred, opts.kmers_on, crit, batch_reads=br)
    ck_path = opts.checkpoint_path
    ck_every = opts.checkpoint_every or 50
    ck_key = (
        _stats_config_key(opts, crit) + "|paired:%s"
        % os.path.abspath(opts.in_filename2)
        if ck_path else None
    )
    start1 = start2 = 0
    if ck_path:
        loaded = load_counters_checkpoint(ck_path, ck_key)
        if loaded:
            resumed1, start1, extra = loaded
            sess.counters1 = resumed1
            sess.counters2 = extra["__counters2__"]
            for c in (sess.counters1, sess.counters2):
                c.ensure_length(sess.lcap)
            start2 = int(extra["offset2"])
            # pass/fail tallies ride inside counters1 (folded from the
            # device accumulator at flush) — nothing extra to restore
    nb = 0
    rng1 = getattr(opts, "input_range", None) or (0, None)
    rng2 = getattr(opts, "input_range2", None) or (0, None)
    with FastqReader(opts.in_filename, batch_size=_reader_batch(opts),
                     start_offset=max(start1, rng1[0]),
                     end_offset=rng1[1]) as r1, \
         FastqReader(opts.in_filename2, batch_size=_reader_batch(opts),
                     start_offset=max(start2, rng2[0]),
                     end_offset=rng2[1]) as r2:
        for b1, b2, in1, in2 in _iter_packed_paired(
            _iter_blocks_paired(_coalesced(opts, r1),
                                _coalesced(opts, r2), timers),
            sess, timers,
        ):
            with timers.stage("compute"):
                sess.feed_pair_packed(in1, in2)
            nb += 1
            if ck_path and nb % ck_every == 0:
                with timers.stage("checkpoint"):
                    sess.flush()
                    save_counters_checkpoint(
                        ck_path, sess.counters1, b1.end_offset, ck_key,
                        extra={"offset2": b2.end_offset},
                        counters2=sess.counters2,
                    )
    with timers.stage("compute"):
        c1, c2 = sess.finish()
    if ck_path and os.path.exists(ck_path):
        os.unlink(ck_path)
    for c in (c1, c2):
        c.filter_on = crit is not None
        c.num_passed, c.num_failed = sess.num_passed, sess.num_failed
    if report:
        with timers.stage("reporting"):
            import dataclasses

            stats_report(c1, opts)
            opts2 = dataclasses.replace(opts, in_filename=opts.in_filename2)
            stats_report(c2, opts2)
    return c1, c2


# ---------------------------------------------------------------------------
# filter
# ---------------------------------------------------------------------------

def _output_parallel_eligible(opts) -> bool:
    """Parallel shard readers for the output commands (filter/edit): no
    checkpoint (resume needs sequential offsets), no explicit range (that
    IS a shard), big enough, byte-seekable input(s).  Paired inputs shard
    by record-count-aligned range pairs (``split_paired_ranges``)."""
    inputs = [opts.in_filename]
    if opts.paired_end:
        inputs.append(opts.in_filename2)
    if (
        opts.checkpoint_path
        or getattr(opts, "input_range", None) is not None
        or _read_shards() <= 1
        or not all(p and os.path.exists(p) for p in inputs)
        or os.path.getsize(opts.in_filename) < _PARALLEL_MIN_BYTES
    ):
        return False
    # auto mode: only worth it on an accelerator, where each shard's
    # read/pack/transfer chain overlaps the others' device steps; on the
    # CPU backend XLA already uses every core and shard threads just
    # contend.  An explicit HPGQ_READ_SHARDS always wins.
    if not os.environ.get("HPGQ_READ_SHARDS"):
        import jax

        if jax.default_backend() == "cpu":
            return False
    from ..dist.mesh import range_splittable

    return all(range_splittable(p) for p in inputs)


_SHARD_OWNER = ".hpgq-owner"  # pid marker inside each .pshard dir


def _read_shard_owner(sd: str):
    try:
        with open(os.path.join(sd, _SHARD_OWNER)) as fh:
            return int(fh.read().strip())
    except (OSError, ValueError):
        return None  # pre-marker or corrupt dir: treat as stale


def _pid_alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except PermissionError:
        return True
    return True


def _run_output_parallel(opts, timers, runner, count_keys):
    """filter/edit over concurrent record-aligned byte-range shards.

    Each shard thread runs the ordinary serial pipeline into a private
    ``.pshardNNNN`` output dir; the final files are the shard files
    concatenated in shard order — byte-identical to the serial run (shards
    are assigned in file order and each shard preserves input order).  The
    in-process analog of the multi-host ``--sharded`` output path
    (hpgq.dist.run_dist._run_output_sharded) and of the reference's N
    worker threads (src/filter_fastq.c:161-170)."""
    import dataclasses
    import shutil
    import threading

    from ..dist.mesh import split_byte_ranges, split_paired_ranges

    nshards = _read_shards()
    if opts.paired_end:
        ranges = split_paired_ranges(opts.in_filename, opts.in_filename2,
                                     nshards)
    else:
        ranges = [(r, None) for r in split_byte_ranges(opts.in_filename,
                                                       nshards)]
    results = [None] * nshards
    errors = []

    def work(i: int, rng):
        try:
            local = dataclasses.replace(opts)
            sd = os.path.join(opts.out_dirname or ".", ".pshard%04d" % i)
            if os.path.isdir(sd):
                # Stale dir from a killed previous run: its leftovers must
                # not be concatenated.  But if the run that made it is still
                # alive, deleting would corrupt that run's in-flight output
                # — refuse instead of racing it.
                owner = _read_shard_owner(sd)
                if owner is not None and owner != os.getpid() \
                        and _pid_alive(owner):
                    raise RuntimeError(
                        "%s is in use by a concurrent run (pid %d) — "
                        "choose a different --out-dir" % (sd, owner)
                    )
                shutil.rmtree(sd)
            os.makedirs(sd)
            with open(os.path.join(sd, _SHARD_OWNER), "w") as fh:
                fh.write(str(os.getpid()))
            local.out_dirname = sd
            local.input_range, local.input_range2 = rng
            t = StageTimers()
            results[i] = (runner(local, t), t, sd)
        except BaseException as e:
            errors.append(e)

    threads = [
        threading.Thread(target=work, args=(i, r), daemon=True,
                         name="hpgq-oshard%d" % i)
        for i, r in enumerate(ranges)
    ]
    with _Profiler(opts.profile_dir):
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    if errors:
        for i in range(nshards):  # incl. the failing worker's dir — but
            # never one owned by a live concurrent run (the refusal case)
            sd = os.path.join(opts.out_dirname or ".", ".pshard%04d" % i)
            owner = _read_shard_owner(sd)
            if owner is None or owner == os.getpid() or not _pid_alive(owner):
                shutil.rmtree(sd, ignore_errors=True)
        raise errors[0]

    out = {k: 0 for k in count_keys}
    names = sorted(n for n in os.listdir(results[0][2]) if n != _SHARD_OWNER)
    with timers.stage("write"):
        for name in names:
            final = os.path.join(opts.out_dirname or ".", name)
            with open(final, "wb") as dst:
                for _, _, sd in results:
                    p = os.path.join(sd, name)
                    if os.path.exists(p):
                        with open(p, "rb") as src:
                            shutil.copyfileobj(src, dst, 16 << 20)
    for res, t, sd in results:
        timers.merge_from(t)
        for k in count_keys:
            out[k] += int(res.get(k, 0))
        shutil.rmtree(sd, ignore_errors=True)
    base = dict(results[0][0])  # non-count keys (output filenames, flags)
    for k, v in base.items():
        if isinstance(v, str) and ".pshard" in v:
            base[k] = os.path.join(opts.out_dirname or ".", os.path.basename(v))
    base.update(out)
    return base


def run_filter(opts: FilterOptions, timers: Optional[StageTimers] = None):
    """The `filter` command → passed/failed FASTQ files. Returns counts."""
    timers = timers or StageTimers()
    crit = opts.criteria
    phred = opts.quality_encoding_value
    br = _batch_reads(opts)
    vfn = ShapeCachedFn(
        lambda: (lambda c, q, l, v: stats_jnp.verdicts(c, q, l, crit, phred) & v),
        br,
        cache_key=("verdict", _crit_key(crit), phred, br),
        qn_ok=True,
    )
    out = {"num_passed": 0, "num_failed": 0}

    if not opts.paired_end:
        if _output_parallel_eligible(opts):
            return _run_output_parallel(
                opts, timers, run_filter, ("num_passed", "num_failed")
            )
        names = getattr(opts, "out_names", None) or ("passed.fq", "failed.fq")
        passed_path = os.path.join(opts.out_dirname, names[0])
        failed_path = os.path.join(opts.out_dirname, names[1])
        ck = _OutputCheckpointer(
            opts, "filter", crit, {"passed": passed_path, "failed": failed_path},
            out, ("num_passed", "num_failed"),
        )
        start, sizes = ck.resume()
        rng = getattr(opts, "input_range", None) or (0, None)
        with FastqReader(opts.in_filename, batch_size=_reader_batch(opts),
                         start_offset=max(start, rng[0]),
                         end_offset=rng[1]) as rd, \
             FastqWriter(passed_path, append_at=sizes.get("passed")) as pw, \
             FastqWriter(failed_path, append_at=sizes.get("failed")) as fw, \
             AsyncSpanPump() as pump:
            for block, ok in _iter_with(
                _coalesced(opts, rd), vfn, timers,
                depth=getattr(opts, "batch_list_size", 0),
            ):
                with timers.stage("write"):
                    out["num_passed"] += block.write_selected(pw, ok,
                                                              pump=pump)
                    out["num_failed"] += block.write_selected(fw, ~ok,
                                                              pump=pump)
                ck.step(block, {"passed": pw, "failed": fw}, timers,
                        pre_save=pump.drain)
            pump.close()
        ck.complete()
        out["passed_filename"] = passed_path
        out["failed_filename"] = failed_path
        return out

    if _output_parallel_eligible(opts):
        return _run_output_parallel(
            opts, timers, run_filter, ("num_passed", "num_failed")
        )
    # fused pair verdict: both mates' batches in ONE device dispatch
    pvfn = ShapeCachedPairFn(
        lambda: (lambda c1, q1, l1, v1, c2, q2, l2, v2:
                 (stats_jnp.verdicts(c1, q1, l1, crit, phred) & v1)
                 & (stats_jnp.verdicts(c2, q2, l2, crit, phred) & v2)),
        br,
        cache_key=("verdict-pair", _crit_key(crit), phred, br),
        qn_ok=True,
    )
    names = getattr(opts, "out_names", None) or (
        "passed_1.fq", "passed_2.fq", "failed_1.fq", "failed_2.fq")
    paths = {
        "passed_1": os.path.join(opts.out_dirname, names[0]),
        "passed_2": os.path.join(opts.out_dirname, names[1]),
        "failed_1": os.path.join(opts.out_dirname, names[2]),
        "failed_2": os.path.join(opts.out_dirname, names[3]),
    }
    ck = _OutputCheckpointer(
        opts, "filter-paired", crit, paths, out, ("num_passed", "num_failed")
    )
    start1, sizes, aux = ck.resume(aux_keys=("offset2",))
    rng1 = getattr(opts, "input_range", None) or (0, None)
    rng2 = getattr(opts, "input_range2", None) or (0, None)
    with FastqReader(opts.in_filename, batch_size=_reader_batch(opts),
                     start_offset=max(start1, rng1[0]),
                     end_offset=rng1[1]) as r1, \
         FastqReader(opts.in_filename2, batch_size=_reader_batch(opts),
                     start_offset=max(aux.get("offset2", 0), rng2[0]),
                     end_offset=rng2[1]) as r2, \
         FastqWriter(paths["passed_1"], append_at=sizes.get("passed_1")) as p1, \
         FastqWriter(paths["passed_2"], append_at=sizes.get("passed_2")) as p2, \
         FastqWriter(paths["failed_1"], append_at=sizes.get("failed_1")) as f1, \
         FastqWriter(paths["failed_2"], append_at=sizes.get("failed_2")) as f2, \
         AsyncSpanPump() as pump:
        writers = {"passed_1": p1, "passed_2": p2, "failed_1": f1, "failed_2": f2}
        for b1, b2 in _iter_blocks_paired(_coalesced(opts, r1),
                                          _coalesced(opts, r2), timers):
            with timers.stage("compute"):
                both = pvfn(b1, b2)  # pair-consistent discard, one dispatch
            with timers.stage("write"):
                out["num_passed"] += b1.write_selected(p1, both, pump=pump)
                b2.write_selected(p2, both, pump=pump)
                out["num_failed"] += b1.write_selected(f1, ~both, pump=pump)
                b2.write_selected(f2, ~both, pump=pump)
            ck.step(b1, writers, timers, aux={"offset2": b2.end_offset},
                    pre_save=pump.drain)
        pump.close()
    ck.complete()
    out.update(paths)
    return out


class _OutputCheckpointer:
    """Checkpoint/resume for append-only output commands (filter/edit,
    single-end).  State = input offset + per-output byte sizes + counts; a
    resume truncates each output to its checkpointed size and continues
    appending, so the result is byte-identical to an uninterrupted run
    (tests/test_checkpoint.py)."""

    def __init__(self, opts, cmd: str, crit, paths: dict, counts: dict,
                 count_keys: tuple):
        import dataclasses
        import json

        self.path = opts.checkpoint_path
        self.every = opts.checkpoint_every or 50
        self.paths = paths
        self.counts = counts
        self.count_keys = count_keys
        self.nb = 0
        def _rng(name):
            r = getattr(opts, name, None)
            return r and [int(r[0]), None if r[1] is None else int(r[1])]

        self.key = json.dumps({
            "cmd": cmd,
            "in": os.path.abspath(opts.in_filename),
            "phred": opts.quality_encoding_value,
            "crit": dataclasses.astuple(crit) if crit is not None else None,
            "outs": sorted(paths),
            # shard ranges (multi-host filter/edit): a resume under a
            # different process count computes different ranges and must
            # be refused, not silently misapplied
            "range": _rng("input_range"),
            "range2": _rng("input_range2"),
        }, sort_keys=True) if self.path else None

    def resume(self, aux_keys: tuple = ()):
        """(input_start_offset, {name: output_append_at or None}, aux)."""
        if not self.path:
            return (0, {}, {}) if aux_keys else (0, {})
        from ..utils.checkpoint import load_counters_checkpoint

        loaded = load_counters_checkpoint(self.path, self.key)
        if not loaded:
            return (0, {}, {k: 0 for k in aux_keys}) if aux_keys else (0, {})
        _, offset, extra = loaded
        sizes = {n: int(extra["bytes_" + n]) for n in self.paths}
        for k in self.count_keys:
            self.counts[k] = int(extra[k])
        if aux_keys:
            aux = {k: int(extra["aux_" + k]) for k in aux_keys}
            return offset, sizes, aux
        return offset, sizes

    def step(self, block, writers: dict, timers, aux: dict = None,
             pre_save=None):
        if not self.path:
            return
        self.nb += 1
        if self.nb % self.every:
            return
        from ..utils.checkpoint import save_counters_checkpoint

        if pre_save is not None:
            # async span pump: in-flight writes must land before the
            # writers' byte sizes are checkpointed
            pre_save()
        with timers.stage("checkpoint"):
            extra = {}
            for name, w in writers.items():
                w.flush()
                extra["bytes_" + name] = w.tell()
            for k in self.count_keys:
                extra[k] = self.counts[k]
            for k, v in (aux or {}).items():
                extra["aux_" + k] = int(v)
            save_counters_checkpoint(
                self.path, None, block.end_offset, self.key, extra=extra
            )

    def complete(self):
        if self.path and os.path.exists(self.path):
            os.unlink(self.path)


# ---------------------------------------------------------------------------
# edit
# ---------------------------------------------------------------------------

def _make_edit_fn(opts: EditOptions, br: int):
    crit = opts.criteria
    phred = opts.quality_encoding_value
    filter_on = opts.filter_on
    post_crit = crit.without_windows()

    def build():
        def fn(codes, quals, lens, valid):
            lens32 = lens.astype(np.int32)
            lt, rt = stats_jnp.trims(quals, lens32, crit, phred)
            if filter_on:
                nc, nq, nl = stats_jnp.apply_trims(codes, quals, lens32, lt, rt)
                ok = stats_jnp.verdicts(nc, nq, nl, post_crit, phred) & valid
            else:
                ok = valid
            return lt, rt, ok

        return fn

    return ShapeCachedFn(
        build, br,
        cache_key=("edit", _crit_key(crit), phred, filter_on, br),
        qn_ok=True,
    )


def _make_edit_pair_fn(opts: EditOptions, br: int):
    """Fused paired trim+post-filter: both mates in one device dispatch
    (pair-consistent discard = AND of the mates' post-trim verdicts)."""
    crit = opts.criteria
    phred = opts.quality_encoding_value
    filter_on = opts.filter_on
    post_crit = crit.without_windows()

    def build():
        def one(codes, quals, lens, valid):
            lens32 = lens.astype(np.int32)
            lt, rt = stats_jnp.trims(quals, lens32, crit, phred)
            if filter_on:
                nc, nq, nl = stats_jnp.apply_trims(codes, quals, lens32, lt, rt)
                ok = stats_jnp.verdicts(nc, nq, nl, post_crit, phred) & valid
            else:
                ok = valid
            return lt, rt, ok

        def fn(c1, q1, l1, v1, c2, q2, l2, v2):
            lt1, rt1, ok1 = one(c1, q1, l1, v1)
            lt2, rt2, ok2 = one(c2, q2, l2, v2)
            return lt1, rt1, lt2, rt2, ok1 & ok2

        return fn

    return ShapeCachedPairFn(
        build, br,
        cache_key=("edit-pair", _crit_key(crit), phred, filter_on, br),
        qn_ok=True,
    )


def run_edit(opts: EditOptions, timers: Optional[StageTimers] = None):
    """The `edit` command → edit.fq (+ failed.fq when filtering).

    Output names are overridable via ``opts.out_names`` — the legacy
    `prepro` command reuses this pipeline to write ``<input>.valid`` files
    (``old/README:76-82``)."""
    timers = timers or StageTimers()
    br = _batch_reads(opts)
    efn = _make_edit_fn(opts, br)
    out = {"num_edited": 0, "num_passed": 0, "num_failed": 0}

    def emit(block, trims, ew, fw, pump=None):
        lt, rt, ok = trims
        with timers.stage("write"):
            out["num_edited"] += int(((lt > 0) | (rt > 0)).sum())
            if opts.filter_on:
                out["num_passed"] += block.write_trimmed(ew, lt, rt,
                                                         select=ok, pump=pump)
                out["num_failed"] += block.write_trimmed(fw, lt, rt,
                                                         select=~ok, pump=pump)
            else:
                block.write_trimmed(ew, lt, rt, pump=pump)

    if not opts.paired_end:
        if _output_parallel_eligible(opts):
            return _run_output_parallel(
                opts, timers, run_edit,
                ("num_edited", "num_passed", "num_failed"),
            )
        names = getattr(opts, "out_names", None) or ("edit.fq",)
        edit_path = os.path.join(opts.out_dirname, names[0])
        failed_path = os.path.join(opts.out_dirname, "failed.fq")
        out["edit_filename"] = edit_path
        out["failed_filename"] = failed_path if opts.filter_on else None
        paths = {"edit": edit_path}
        if opts.filter_on:
            paths["failed"] = failed_path
        ck = _OutputCheckpointer(
            opts, "edit", opts.criteria, paths, out,
            ("num_edited", "num_passed", "num_failed"),
        )
        start, sizes = ck.resume()
        rng = getattr(opts, "input_range", None) or (0, None)
        with FastqReader(opts.in_filename, batch_size=_reader_batch(opts),
                         start_offset=max(start, rng[0]),
                         end_offset=rng[1]) as rd, \
             FastqWriter(edit_path, append_at=sizes.get("edit")) as ew:
            fw = (
                FastqWriter(failed_path, append_at=sizes.get("failed"))
                if opts.filter_on else None
            )
            try:
                with AsyncSpanPump() as pump:
                    for block, trims in _iter_with(
                        _coalesced(opts, rd), efn, timers,
                        depth=getattr(opts, "batch_list_size", 0),
                    ):
                        emit(block, trims, ew, fw, pump=pump)
                        writers = {"edit": ew}
                        if fw:
                            writers["failed"] = fw
                        ck.step(block, writers, timers, pre_save=pump.drain)
                    pump.close()
            finally:
                if fw:
                    fw.close()
        ck.complete()
        return out

    # paired-end edit: trim mates independently; pair-consistent post-filter
    if _output_parallel_eligible(opts):
        return _run_output_parallel(
            opts, timers, run_edit,
            ("num_edited", "num_passed", "num_failed"),
        )
    names = getattr(opts, "out_names", None) or ("edit_1.fq", "edit_2.fq")
    paths = {
        "edit_1": os.path.join(opts.out_dirname, names[0]),
        "edit_2": os.path.join(opts.out_dirname, names[1]),
    }
    if opts.filter_on:
        paths["failed_1"] = os.path.join(opts.out_dirname, "failed_1.fq")
        paths["failed_2"] = os.path.join(opts.out_dirname, "failed_2.fq")
    ck = _OutputCheckpointer(
        opts, "edit-paired", opts.criteria, paths, out,
        ("num_edited", "num_passed", "num_failed"),
    )
    start1, sizes, aux = ck.resume(aux_keys=("offset2",))
    writers = {}
    try:
        rng1 = getattr(opts, "input_range", None) or (0, None)
        rng2 = getattr(opts, "input_range2", None) or (0, None)
        with FastqReader(opts.in_filename, batch_size=_reader_batch(opts),
                         start_offset=max(start1, rng1[0]),
                         end_offset=rng1[1]) as r1, \
             FastqReader(opts.in_filename2, batch_size=_reader_batch(opts),
                         start_offset=max(aux.get("offset2", 0), rng2[0]),
                         end_offset=rng2[1]) as r2:
            # writers are opened (mode "wb": truncating!) only after BOTH
            # readers opened — a bad mate-2 path must not destroy the
            # previous run's outputs
            for key, v in paths.items():
                writers[key] = FastqWriter(v, append_at=sizes.get(key))
            pefn = _make_edit_pair_fn(opts, br)
            with AsyncSpanPump() as pump:
                for b1, b2 in _iter_blocks_paired(_coalesced(opts, r1),
                                                  _coalesced(opts, r2),
                                                  timers):
                    with timers.stage("compute"):
                        lt1, rt1, lt2, rt2, both = pefn(b1, b2)
                    with timers.stage("write"):
                        out["num_edited"] += int(
                            ((lt1 > 0) | (rt1 > 0)).sum()
                            + ((lt2 > 0) | (rt2 > 0)).sum()
                        )
                        if opts.filter_on:
                            out["num_passed"] += b1.write_trimmed(
                                writers["edit_1"], lt1, rt1, select=both,
                                pump=pump,
                            )
                            b2.write_trimmed(writers["edit_2"], lt2, rt2,
                                             select=both, pump=pump)
                            out["num_failed"] += b1.write_trimmed(
                                writers["failed_1"], lt1, rt1, select=~both,
                                pump=pump,
                            )
                            b2.write_trimmed(writers["failed_2"], lt2, rt2,
                                             select=~both, pump=pump)
                        else:
                            b1.write_trimmed(writers["edit_1"], lt1, rt1,
                                             pump=pump)
                            b2.write_trimmed(writers["edit_2"], lt2, rt2,
                                             pump=pump)
                    ck.step(b1, writers, timers,
                            aux={"offset2": b2.end_offset},
                            pre_save=pump.drain)
                pump.close()
    finally:
        for w in writers.values():
            w.close()
    ck.complete()
    out.update(paths)
    return out
