"""Distributed stats pipeline: data-parallel over a device mesh, multi-host
over byte-range shards.

Topology (SURVEY §2.3 P4/P5, §5 'distributed communication backend'):

* every process reads its own slice of the input — a record-aligned byte
  range for plain FASTQ (``split_byte_ranges``), or block striping for gzip
  (not byte-seekable: every process decodes, keeps every p-th block),
* each step packs a global ``[B, L]`` batch whose shards live on the local
  process's devices (``jax.make_array_from_process_local_data``), and runs
  the fused per-device kernel inside ``shard_map`` — NO collectives in the
  steady state,
* hosts step in lockstep; a host whose range is exhausted feeds empty
  (all-invalid) batches while a tiny per-step shape vote — element-wise max
  of each rank's ``(lmax, rows, rawlen)`` buckets, all-zero = "everyone
  done" — keeps step counts AND dispatch shapes (bucketed rows, trimmed
  wire columns) identical across ranks (the only per-step collective, and
  only when ``jax.process_count() > 1``),
* the final merge is one ``psum``/``pmin``/``pmax`` over the mesh
  (``sharded_counters``) — the reference's serial consumer merge
  (``src/stats_fastq.c:257-417``) as a single collective; process 0 writes
  the report.

Single-process multi-device (one host, N chips — or the 8-virtual-device CPU
test mesh) is the degenerate case with no vote and no striping.
"""

from __future__ import annotations

import json
import os
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P

from ..io.fastq import FastqReader
from ..io.packer import bucket_rows, pack_block, round_up, wire_len
from ..options import StatsOptions
from ..report.stats_report import stats_report
from ..utils.timers import StageTimers
from .mesh import (
    data_mesh,
    initialize_distributed,
    make_sharded_paired_stats_step,
    make_sharded_stats_step,
    range_splittable,
    sharded_counters,
    split_byte_ranges,
    split_paired_ranges,
    zero_sharded_partials,
)


def make_global_batch(mesh, sharding, arrays):
    """Per-process local arrays -> global sharded arrays (single- or
    multi-process)."""
    if jax.process_count() == 1:
        return tuple(jax.device_put(a, sharding) for a in arrays)
    return tuple(
        jax.make_array_from_process_local_data(sharding, a) for a in arrays
    )


def striped_blocks(reader, stripe: int, n_stripes: int):
    """Every n-th block of the reader — the gzip multi-host input split
    (gzip is not byte-seekable; each host decodes the stream but computes
    only its stripe)."""
    for i, block in enumerate(reader):
        if i % n_stripes == stripe:
            yield block


# int32-overflow budget for the sharded sessions' periodic collective fold
# (see ShardedStatsSession._after_step); module-level so tests can shrink it
_FLUSH_BUDGET = 1 << 30


class ShardedStatsSession:
    """Streaming stats over a data mesh: per-device accumulators inside
    shard_map, one collective merge at the end."""

    def __init__(self, mesh, phred: int, kmers_on=False, crit=None,
                 batch_reads: int = 16384, lcap: int = 128):
        from ..core.accumulator import resolve_wire

        self.mesh = mesh if mesh is not None else data_mesh()
        self.ndev = self.mesh.devices.size
        self.phred = phred
        self.kmers_on = kmers_on
        self.crit = crit
        self.batch_reads = round_up(max(batch_reads, self.ndev), self.ndev)
        self.lcap = lcap
        self.carry = None  # StatsCounters folded in on lcap growth/flush
        self.wire = resolve_wire()
        # adaptive bitpack tiers (2q palette / 6-bit / 7-bit): the per-step
        # shape vote carries the element-wise-max tier, so every rank
        # dispatches the same wire width from data-dependent quals (the
        # round-3 single-host-only restriction lifted).
        # All ranks must share the HPGQ_WIRE6/HPGQ_QPAL environment.
        from ..io.packer import bitwire_tier_floor

        self._tiered = self.wire == "bitpack"
        # single-end sharded sessions ride the full ladder incl. tier -1
        # (2c: the step variant accepts the exception sidecar); the paired
        # and CGR sharded sessions keep floor >= 0
        self._tier_floor = (bitwire_tier_floor(allow2c=True)
                            if self._tiered else 2)
        # vote-vector width is pinned at construction (env-derived, same
        # on every rank): the sticky escalation below may raise
        # _tier_floor mid-run, which must not change the lockstep vote
        # length across ranks
        self._vote_width = 5 if self._tier_floor < 0 else 4
        self._probe = None  # (block_id, (tier, wl, rows), packed buffer)
        self._tier_miss = 0
        self._step2c = None  # lazily-built 2c step (per lcap)
        self._reset(lcap)

    def _reset(self, lcap: int):
        self.lcap = lcap
        self.acc = zero_sharded_partials(self.mesh, lcap, self.kmers_on)
        self._step = make_sharded_stats_step(
            self.mesh, lcap, self.phred, self.kmers_on, self.crit,
            wire=self.wire,
        )
        self._step2c = None  # rebuilt on first 2c feed at this lcap
        self._sharding = NamedSharding(self.mesh, P("data"))
        self._rows_since_flush = 0

    def _grow(self, lcap: int):
        done = sharded_counters(
            self.acc, self.mesh, self.lcap, self.phred, self.kmers_on
        )
        done.filter_on = self.crit is not None
        if self.carry is not None:
            done = self.carry.merge(done)
        self.carry = done
        self._reset(lcap)

    def local_shape(self, block):
        """``(lmax, rows, rawlen)`` dispatch-shape buckets for a block —
        the per-step lockstep vote vector.  Element-wise max across ranks
        is sound because every element is a per-rank LOWER bound that any
        larger bucket also satisfies (lmax: 128-lane length bucket; rows:
        ndev-divisible 16384-row bucket; rawlen: longest read, from which
        every rank derives the identical trimmed wire width under the
        voted lcap).  ``(0, 0, 0)`` marks an exhausted shard.

        Bitpack wire sessions append a 4th element: the narrowest adaptive
        tier this block fits (-1 = 2c, 0 = 2q palette, 1 = 6-bit,
        2 = 7-bit) — a per-rank lower bound, so element-wise max votes
        the widest tier any rank needs and every rank packs the same row
        width.  (An exhausted shard's all-zero vector maxes a live -1 up
        to 0 on tail steps — a harmless widening, since wider tiers
        always pack.)  Single-end sessions whose floor allows tier -1
        append a 5th element: the per-device exception-bucket count —
        max'd like the rest, every rank then pads its sidecar to the
        voted bucket.  The probe IS a pack (native single-pass, returns
        None on misfit); the buffer is cached and reused by
        ``feed_block`` when the voted shape matches the local one (the
        common case: full buckets, homogeneous corpus)."""
        width = getattr(self, "_vote_width", 4)
        if block is None:
            return (0,) * width if self._tiered else (0, 0, 0)
        lmax = round_up(max(block.max_len(), 1), 128)
        rows = min(self.batch_reads,
                   round_up(bucket_rows(block.num_reads, self.batch_reads),
                            self.ndev))
        rawlen = max(block.max_len(), 1)
        if not self._tiered:
            return (lmax, rows, rawlen)
        wl = wire_len(rawlen, max(self.lcap, lmax))
        tier = self._probe_tier(block, wl, rows)
        if width == 4:
            return (lmax, rows, rawlen, tier)
        excb = 0
        if tier == -1:
            pr = self._probe
            if pr is not None and pr[0] == id(block) and pr[2] is not None:
                excb = self._exc_dev_buckets(pr[2][1], rows, wl)
        return (lmax, rows, rawlen, tier, excb)

    def _probe_tier(self, block, wl: int, rows: int,
                    force_monotone: bool = False,
                    miss_attr: str = "_tier_miss") -> int:
        from ..io.packer import (
            bitwire_tier_valid_off,
            pack_block_bitwire_tier,
        )

        # The vote is element-wise MAX, so a vote must be a tier whose
        # every WIDER tier also fits its block — otherwise another
        # participant's vote could force a repack that fails.  The tiers
        # are not a containment lattice: tier 0 (<= 4 distinct quals)
        # does NOT imply tier 1 (range < 64) — e.g. quals {2, 70} fit
        # the palette but not the 6-bit rebase.  A 2q-fitting block
        # therefore only votes 0 when tier 1 provably fits too (checked
        # from the packed palette columns: range = pal[3] - pal[0]);
        # else it votes 2.  The constraint binds whenever the tier is
        # max'd with ANY other vote: other ranks (multihost) or the
        # other mate (``force_monotone`` — the paired session, even
        # single-process).
        tier = self._tier_floor
        buf = None
        while buf is None:
            buf = pack_block_bitwire_tier(block, wl, tier, pad_reads_to=rows)
            if buf is None:
                tier += 1
        if tier in (-1, 0) and (force_monotone or jax.process_count() > 1):
            # tier -1 -> 0 is containment (2c = 2q palette criterion plus
            # an exception budget), but both palette tiers need the 6-bit
            # guard below before they can be max'd with other votes
            from ..io.packer import bitwire_tier_palette_cols

            ps, pe = bitwire_tier_palette_cols(wl, tier)
            pal = (buf[0] if isinstance(buf, tuple) else buf)[:, ps:pe]
            if int((pal[:, 3].astype(np.int16)
                    - pal[:, 0].astype(np.int16)).max(initial=0)) > 63:
                tier = 2
                buf = pack_block_bitwire_tier(block, wl, tier,
                                              pad_reads_to=rows)
        if tier > self._tier_floor:
            # sticky escalation: data that keeps missing a narrow tier
            # stops paying the failed pack attempt (cf. ShapeCachedFn's
            # palette-misfit flag).  ``miss_attr`` keeps the paired
            # session's two mates on separate counters — a shared one
            # oscillates 0/1 and never escalates.
            miss = getattr(self, miss_attr) + 1
            setattr(self, miss_attr, miss)
            if miss >= 3:
                self._tier_floor = tier
        else:
            setattr(self, miss_attr, 0)
        self._probe = (id(block), (tier, wl, rows), buf)
        return tier

    def feed_block(self, block, sel=None, shape=None):
        """Feed a RecordBlock; ``sel`` restricts which reads count (the
        paired pair-consistent filter) — applied by zeroing the wire rows'
        valid byte (native single-pass pack stays on the fast path).

        ``shape`` is a ``local_shape``-style ``(lmax, rows, rawlen)``: in
        multihost lockstep every rank MUST pass the same globally voted
        tuple (shard_map shapes have to match across processes); defaults
        to this block's local buckets (single-process sessions follow the
        single-chip engine's trimmed dispatch shapes)."""
        if shape is None:
            shape = self.local_shape(block)
        lmax, rows, rawlen = shape[:3]
        if lmax > self.lcap:
            self._grow(lmax)
        if self.wire in ("bitpack", "fused4"):
            from ..io.packer import (
                bitwire_tier_valid_off,
                pack_block_bitwire_tier,
                pack_block_wire,
                zero_wire_sel,
            )

            wl = wire_len(rawlen, self.lcap)
            valid_off = None
            if self._tiered and len(shape) > 3:
                tier = shape[3]
                pr, self._probe = self._probe, None
                if pr is not None and pr[0] == id(block) \
                        and pr[1] == (tier, wl, rows):
                    buf = pr[2]
                else:  # voted shape/tier wider than the local probe
                    buf = pack_block_bitwire_tier(block, wl, tier,
                                                  pad_reads_to=rows)
                valid_off = bitwire_tier_valid_off(wl, tier)
                if tier == -1:
                    buf, exc = buf
                    if sel is not None:
                        zero_wire_sel(buf, sel, valid_off=valid_off)
                    excb = shape[4] if len(shape) > 4 else 0
                    self._feed_wire2c(buf, exc, rows, wl, excb)
                    return
            else:
                buf = pack_block_wire(block, self.wire, wl,
                                      pad_reads_to=rows)
            if sel is not None:
                zero_wire_sel(buf, sel, valid_off=valid_off)
            self._feed_wire(buf)
            return
        codes, quals, lens, valid = pack_block(
            block, max_len=self.lcap, pad_reads_to=rows
        )
        if sel is not None:
            valid = valid.copy()
            valid[: len(sel)] &= np.asarray(sel, bool)
        self.feed_packed(codes, quals, lens, valid)

    def feed_empty(self, shape=None):
        """A lockstep step with no local data (exhausted multi-host shard);
        ``shape`` is the step's voted ``(lmax, rows, rawlen)`` — the empty
        batch must match the other ranks' dispatch shapes exactly."""
        rows = self.batch_reads if shape is None else shape[1]
        wl = self.lcap if shape is None else wire_len(shape[2], self.lcap)
        if self.wire in ("bitpack", "fused4"):
            if self.wire == "bitpack":
                from ..io.packer import bitwire_tier_width

                tier = shape[3] if shape is not None and len(shape) > 3 else 2
                W = bitwire_tier_width(wl, tier)
                if tier == -1:
                    # all-zero rows decode to valid=0; an all-sentinel
                    # sidecar scatters nothing (mode='drop')
                    excb = shape[4] if len(shape) > 4 else 0
                    self._feed_wire2c(np.zeros((rows, W), np.uint8),
                                      np.empty(0, np.int32), rows, wl, excb)
                    return
            else:
                W = wl // 2 + wl + 8
            # all-zero wire rows decode to valid=0 (no reads)
            self._feed_wire(np.zeros((rows, W), np.uint8))
            return
        z = np.zeros((rows, self.lcap), dtype=np.int8)
        self.feed_packed(
            z + np.int8(5),
            np.zeros_like(z, dtype=np.uint8),
            np.zeros(rows, np.int32),
            np.zeros(rows, bool),
        )

    def _feed_wire(self, buf):
        (gbuf,) = make_global_batch(self.mesh, self._sharding, (buf,))
        self.acc = self._step(self.acc, gbuf)
        self._after_step(buf.shape[0])

    @property
    def _local_ndev(self) -> int:
        """Devices THIS process feeds: each process contributes
        process-local rows that shard over its own devices
        (make_array_from_process_local_data), so per-device rows are
        rows / local_ndev — NOT rows / global_ndev (the same trap as the
        round-4 int32-flush-window bug)."""
        return max(1, self.ndev // jax.process_count())

    def _split_exc_by_device(self, exc, rows: int, wl: int):
        """Regroup a local-row exception list (packer output, sorted
        row-major) into per-LOCAL-device lists for the sharded decode:
        local device d owns rows [d*rpd, (d+1)*rpd), its entries
        re-encode as ((device_row * L + pos) << 1) | flag.  Returns
        (list of local_ndev int32 arrays, max per-device count)."""
        ldev = self._local_ndev
        rpd = rows // ldev
        live = exc[exc < np.int32((rows * wl) << 1)]  # strip sentinels
        rowpos = (live >> 1).astype(np.int64)
        dev = (rowpos // wl) // rpd
        local = (((rowpos - dev * (rpd * wl)) << 1)
                 | (live & 1)).astype(np.int32)
        parts = [local[dev == d] for d in range(ldev)]
        return parts, max((p.size for p in parts), default=0)

    def _exc_dev_buckets(self, exc, rows: int, wl: int) -> int:
        """Per-device exception-bucket count for the lockstep vote.

        Must upper-bound the count of ANY device's slice under any voted
        rows >= the local probe's (the vote can widen rows, which widens
        rows-per-device and re-groups the exceptions).  A device slice is
        an aligned window of rpd <= batch_reads/local_ndev consecutive
        rows, and every such window is contained in some SLIDING window
        of rpd_max rows — so the sliding-window max count is a sound
        bound for every grouping the vote can produce."""
        from ..io.native import EXC_BUCKET

        live = exc[exc < np.int32((rows * wl) << 1)]
        r = (live >> 1).astype(np.int64) // wl  # ascending (row-major pack)
        rpd_max = self.batch_reads // self._local_ndev
        if r.size:
            hi = np.searchsorted(r, r + rpd_max, side="left")
            mx = int((hi - np.arange(r.size)).max())
        else:
            mx = 0
        return -(-max(mx, 1) // EXC_BUCKET)

    def _feed_wire2c(self, buf, exc, rows: int, wl: int, excb: int):
        """One sharded 2c step: the wire buffer plus its exception
        sidecar, regrouped per device and padded to the VOTED per-device
        bucket (``excb``) so every rank dispatches identical shapes."""
        from ..io.native import EXC_BUCKET

        if self._step2c is None:
            self._step2c = make_sharded_stats_step(
                self.mesh, self.lcap, self.phred, self.kmers_on, self.crit,
                wire="bitpack2c",
            )
        parts, _ = self._split_exc_by_device(exc, rows, wl)
        ldev = self._local_ndev
        rpd = rows // ldev
        edev = max(excb, 1) * EXC_BUCKET
        sent = np.int32((rpd * wl) << 1)  # OOB for the device's shard
        gexc = np.full(ldev * edev, sent, dtype=np.int32)
        for d, p in enumerate(parts):
            # loud guard: a slice exceeding the voted bucket would spill
            # into the NEXT device's sidecar (silent counter corruption);
            # the voted bound is sound only while every rank shares
            # batch_reads — assert the invariant instead of trusting it
            assert p.size <= edev, (p.size, edev, d)
            gexc[d * edev : d * edev + p.size] = p
        gbuf, gexc = make_global_batch(self.mesh, self._sharding,
                                       (buf, gexc))
        self.acc = self._step2c(self.acc, gbuf, gexc)
        self._after_step(buf.shape[0])

    def feed_packed(self, codes, quals, lens, valid):
        if codes.shape[1] > self.lcap:
            self._grow(codes.shape[1])
        if self.wire in ("bitpack", "fused4"):
            # wire-mode session fed packed arrays (paired pair-consistent
            # path): wire-encode host-side so the step signature matches
            from ..io.packer import wire_bitpack_np
            from ..kernels.stats_jnp import wire_fuse

            enc = (wire_bitpack_np if self.wire == "bitpack" else wire_fuse)
            self._feed_wire(np.asarray(
                enc(codes, quals, lens.astype(np.int32), valid)
            ))
            return
        batch = make_global_batch(
            self.mesh, self._sharding,
            (codes, quals, lens.astype(np.int32), valid),
        )
        self.acc = self._step(self.acc, *batch)
        self._after_step(codes.shape[0])

    def _after_step(self, step_rows: int):
        # Periodic int32-overflow-safe fold (same bound as
        # DeviceAccumulator).  The budget is PER-DEVICE ROWS accumulated
        # since the last fold: each rank feeds step_rows local rows, so a
        # device's shard is step_rows * pcnt / ndev rows — computed ONLY
        # from lockstep-voted quantities (step_rows is the voted rows
        # bucket) and global constants, so every rank crosses the
        # threshold at the SAME step and the collective fold inside
        # _grow() stays synchronized (a rank-local window — e.g. one
        # derived from this rank's own --batch-size — would deadlock the
        # mesh when ranks disagree).
        self._rows_since_flush += max(1, step_rows * jax.process_count()
                                      // self.ndev)
        if self._rows_since_flush * max(self.lcap, 130) >= _FLUSH_BUDGET:
            self._grow(self.lcap)  # fold into carry, reset device partials


    def finish(self):
        c = sharded_counters(
            self.acc, self.mesh, self.lcap, self.phred, self.kmers_on
        )
        c.filter_on = self.crit is not None
        if self.carry is not None:
            c = self.carry.merge(c)
            c.filter_on = self.crit is not None
        return c


class ShardedPairedStatsSession:
    """Paired-end sharded stats: BOTH mates' pair-consistent verdicts +
    accumulation in ONE shard_map dispatch per lockstep step
    (``make_sharded_paired_stats_step``) — the sharded twin of the
    single-host :class:`~hpgq.pipeline.session.PairedStatsSession`, and
    the fusion of the former 3-dispatch loop (pair verdict + one feed per
    mate).  Pair pass/fail tallies live in mate-1's device partials
    (num_passed/num_failed leaves), so checkpoints and the final counters
    carry them with no per-step host sync; the collective merge psums them
    globally.  One shared (lmax, rows, rawlen) bucket covers both mates
    (they grow together)."""

    def __init__(self, mesh, phred: int, kmers_on=False, crit=None,
                 batch_reads: int = 16384, lcap: int = 128):
        from ..core.accumulator import resolve_wire

        self.mesh = mesh if mesh is not None else data_mesh()
        self.ndev = self.mesh.devices.size
        self.phred = phred
        self.kmers_on = kmers_on
        self.crit = crit
        self.batch_reads = round_up(max(batch_reads, self.ndev), self.ndev)
        self.carry1 = None  # StatsCounters folded in on lcap growth/flush
        self.carry2 = None
        w = resolve_wire()
        # pack4 has no single-buffer sharded form; plain arrays there (same
        # degradation as ShardedStatsSession)
        self.wire = w if w in ("bitpack", "fused4") else None
        from ..io.packer import bitwire_tier_floor

        # adaptive tiers, shared across BOTH mates (one width per step);
        # same vote-monotonicity rules as ShardedStatsSession._probe_tier
        self._tiered = self.wire == "bitpack"
        self._tier_floor = bitwire_tier_floor() if self._tiered else 2
        self._probe = None  # (ids(b1,b2), (tier, wl, rows), (buf1, buf2))
        self._tier_miss1 = 0  # per-mate sticky-escalation counters
        self._tier_miss2 = 0
        self._reset(lcap)

    def _reset(self, lcap: int):
        self.lcap = lcap
        self.acc1 = zero_sharded_partials(self.mesh, lcap, self.kmers_on)
        self.acc2 = zero_sharded_partials(self.mesh, lcap, self.kmers_on)
        self._step = make_sharded_paired_stats_step(
            self.mesh, lcap, self.phred, self.kmers_on, self.crit,
            wire=self.wire,
        )
        self._sharding = NamedSharding(self.mesh, P("data"))
        self._rows_since_flush = 0

    def _grow(self, lcap: int):
        """Collective-fold both mates' partials into the host carries and
        rebuild at ``lcap``.  Multihost: collective — every rank must call
        at the same lockstep step (guaranteed by voted shapes / the voted
        flush budget, as for ShardedStatsSession)."""
        for name, acc in (("carry1", self.acc1), ("carry2", self.acc2)):
            done = sharded_counters(
                acc, self.mesh, self.lcap, self.phred, self.kmers_on
            )
            done.filter_on = self.crit is not None
            prev = getattr(self, name)
            setattr(self, name, done if prev is None else prev.merge(done))
        self._reset(lcap)

    def local_shape(self, pair):
        """``(lmax, rows, rawlen[, tier])`` buckets for a lockstep
        mate-block pair (the per-step vote vector; same contract as
        ``ShardedStatsSession.local_shape``; the tier is shared across
        both mates — element-wise max of their narrowest safe tiers).
        All-zeros marks an exhausted shard."""
        if pair is None:
            return (0, 0, 0, 0) if self._tiered else (0, 0, 0)
        b1, b2 = pair
        ml = max(b1.max_len(), b2.max_len(), 1)
        nr = max(b1.num_reads, b2.num_reads)
        lmax = round_up(ml, 128)
        rows = min(self.batch_reads,
                   round_up(bucket_rows(nr, self.batch_reads), self.ndev))
        if not self._tiered:
            return (lmax, rows, ml)
        wl = wire_len(ml, max(self.lcap, lmax))
        return (lmax, rows, ml, self._probe_pair_tier(b1, b2, wl, rows))

    def _probe_pair_tier(self, b1, b2, wl: int, rows: int) -> int:
        """Shared tier for both mates: probe each with the stats session's
        monotone-safe logic (``force_monotone``: the cross-MATE max is a
        vote too, so the lattice constraint binds even single-process),
        take the max, and repack the narrower mate at the shared tier so
        the cache holds matching buffers."""
        from ..io.packer import pack_block_bitwire_tier

        t1 = ShardedStatsSession._probe_tier(
            self, b1, wl, rows, force_monotone=True,
            miss_attr="_tier_miss1")
        p1 = self._probe
        t2 = ShardedStatsSession._probe_tier(
            self, b2, wl, rows, force_monotone=True,
            miss_attr="_tier_miss2")
        p2 = self._probe
        tier = max(t1, t2)
        buf1 = p1[2] if p1[1][0] == tier else pack_block_bitwire_tier(
            b1, wl, tier, pad_reads_to=rows)
        buf2 = p2[2] if p2[1][0] == tier else pack_block_bitwire_tier(
            b2, wl, tier, pad_reads_to=rows)
        self._probe = ((id(b1), id(b2)), (tier, wl, rows), (buf1, buf2))
        return tier

    def feed_pair(self, b1, b2, shape=None):
        """One fused step over a lockstep mate-block pair.  ``shape`` is
        the voted ``(lmax, rows, rawlen[, tier])`` in multihost mode
        (defaults to this pair's local buckets)."""
        if shape is None:
            shape = self.local_shape((b1, b2))
        lmax, rows, rawlen = shape[:3]
        if lmax > self.lcap:
            self._grow(lmax)
        if self.wire:
            from ..io.packer import (
                pack_block_bitwire_tier,
                pack_block_wire,
            )

            wl = wire_len(rawlen, self.lcap)
            if self._tiered and len(shape) > 3:
                tier = shape[3]
                pr, self._probe = self._probe, None
                if pr is not None and pr[0] == (id(b1), id(b2)) \
                        and pr[1] == (tier, wl, rows):
                    in1, in2 = pr[2]
                else:  # voted shape/tier wider than the local probe
                    in1 = pack_block_bitwire_tier(b1, wl, tier,
                                                  pad_reads_to=rows)
                    in2 = pack_block_bitwire_tier(b2, wl, tier,
                                                  pad_reads_to=rows)
            else:
                in1 = pack_block_wire(b1, self.wire, wl, pad_reads_to=rows)
                in2 = pack_block_wire(b2, self.wire, wl, pad_reads_to=rows)
            g1, g2 = make_global_batch(self.mesh, self._sharding, (in1, in2))
        else:
            p1 = pack_block(b1, max_len=self.lcap, pad_reads_to=rows)
            p2 = pack_block(b2, max_len=self.lcap, pad_reads_to=rows)
            g = make_global_batch(
                self.mesh, self._sharding,
                (p1[0], p1[1], p1[2].astype(np.int32), p1[3],
                 p2[0], p2[1], p2[2].astype(np.int32), p2[3]),
            )
            g1, g2 = tuple(g[:4]), tuple(g[4:])
        self.acc1, self.acc2 = self._step(self.acc1, self.acc2, g1, g2)
        self._after_step(rows)

    def feed_empty(self, shape=None):
        """A lockstep step with no local pairs (exhausted multihost shard);
        dispatch shapes must match the other ranks' voted tuple exactly."""
        rows = self.batch_reads if shape is None else shape[1]
        if self.wire:
            wl = self.lcap if shape is None else wire_len(shape[2], self.lcap)
            if self.wire == "bitpack":
                from ..io.packer import bitwire_tier_width

                tier = (shape[3] if shape is not None and len(shape) > 3
                        else 2)
                W = bitwire_tier_width(wl, tier)
            else:
                W = wl // 2 + wl + 8
            # all-zero wire rows decode to valid=0 (no reads)
            z = np.zeros((rows, W), np.uint8)
            g1, g2 = make_global_batch(self.mesh, self._sharding, (z, z))
        else:
            z = np.zeros((rows, self.lcap), dtype=np.int8) + np.int8(5)
            q = np.zeros((rows, self.lcap), np.uint8)
            l = np.zeros(rows, np.int32)
            v = np.zeros(rows, bool)
            g = make_global_batch(self.mesh, self._sharding,
                                  (z, q, l, v, z, q, l, v))
            g1, g2 = tuple(g[:4]), tuple(g[4:])
        self.acc1, self.acc2 = self._step(self.acc1, self.acc2, g1, g2)
        self._after_step(rows)

    def _after_step(self, step_rows: int):
        # per-mate int32 budget — identical to ShardedStatsSession (each
        # mate's accumulator sees step_rows local rows per step); computed
        # only from voted quantities so multihost folds stay lockstep
        self._rows_since_flush += max(1, step_rows * jax.process_count()
                                      // self.ndev)
        if self._rows_since_flush * max(self.lcap, 130) >= _FLUSH_BUDGET:
            self._grow(self.lcap)

    def finish(self):
        """(counters1, counters2) with globally merged stats; the
        pair-consistent pass/fail tallies ride counters1 (mirrored onto
        counters2 by the caller, like the single-host paired runner)."""
        self._grow(self.lcap)
        c1, c2 = self.carry1, self.carry2
        for c in (c1, c2):
            c.filter_on = self.crit is not None
        return c1, c2


_jitted_max = jax.jit(jnp.max)
_jitted_max0 = jax.jit(lambda x: x.max(axis=0))
_jitted_sum0 = jax.jit(lambda x: x.sum(axis=0))


_VOTE_TIMEOUT_MS = 15 * 60 * 1000  # ranks can lag by a full slow batch


class _KvVotes:
    """Host-side cross-process votes over the distributed coordination
    service's key-value store.

    The original implementation voted through a device collective
    (make_array_from_process_local_data + jitted reduce + device_get) —
    measured ~0.85 s PER VOTE on a 2-process CPU mesh (profiled in round
    4), which made the per-step lockstep vote the dominant multihost cost.
    The KV store is a plain RPC to the coordinator (~ms).

    Correctness leans on the lockstep invariant the votes themselves
    guarantee: every rank issues the same votes in the same order, so a
    process-global sequence number keys each round.  A rank entering
    round ``seq`` proves every rank finished round ``seq-1`` (it read all
    their values), hence values from ``seq-2`` are garbage — each rank
    deletes its own ``seq-2`` key on entry."""

    def __init__(self):
        self.seq = 0

    @staticmethod
    def _client():
        """The coordination-service KV client, or None when the private
        JAX API it lives behind has moved (a JAX upgrade renaming
        ``jax._src.distributed.global_state.client`` must degrade to the
        slow-but-correct device-collective vote, not raise)."""
        try:
            from jax._src import distributed

            return distributed.global_state.client
        except (ImportError, AttributeError):
            return None

    def vote(self, vals: np.ndarray, reduce_fn) -> np.ndarray:
        client = self._client()
        pid, pcnt = jax.process_index(), jax.process_count()
        seq = self.seq
        self.seq += 1
        client.key_value_set("hpgq/vote/%d/%d" % (seq, pid),
                             json.dumps(vals.tolist()))
        if seq >= 2:
            try:
                client.key_value_delete("hpgq/vote/%d/%d" % (seq - 2, pid))
            except Exception:
                pass  # cleanup only
        out = vals
        for p in range(pcnt):
            if p == pid:
                continue
            raw = client.blocking_key_value_get(
                "hpgq/vote/%d/%d" % (seq, p), _VOTE_TIMEOUT_MS)
            out = reduce_fn(out, np.asarray(json.loads(raw), vals.dtype))
        return out


_KV_VOTES = _KvVotes()


def _vote_sum(mesh, values) -> np.ndarray:
    """Element-wise cross-process sum of a small host-local int64 vector
    (global output counts for sharded filter/edit).  Single-process: the
    values unchanged."""
    vals = np.atleast_1d(np.asarray(values, dtype=np.int64))
    if jax.process_count() == 1:
        return vals
    if _KvVotes._client() is not None:
        return _KV_VOTES.vote(vals, np.add)
    local = np.zeros((jax.local_device_count(),) + vals.shape, np.int64)
    local[0] = vals  # one carrier device per process
    g = jax.make_array_from_process_local_data(
        NamedSharding(mesh, P("data")), local
    )
    return np.asarray(jax.device_get(_jitted_sum0(g)))


def _barrier(mesh) -> None:
    """All processes reach this point (one tiny collective)."""
    _vote_max(mesh, 1)


def _vote_max(mesh, value: int) -> int:
    """Cross-host max of a small host-local int (one tiny collective).

    Used once per step in multi-host mode to agree on (a) whether any shard
    still has input (max length 0 = everyone done) and (b) the global length
    bucket, so every process grows its shard_map shapes in lockstep."""
    return int(_vote_max_vec(mesh, [int(value)])[0])


def _vote_max_vec(mesh, values) -> np.ndarray:
    """Element-wise cross-process max of a small host-local int vector —
    the per-step multihost shape vote ((lmax, rows, rawlen) in ONE tiny
    collective).  Single-process: the values unchanged."""
    vals = np.atleast_1d(np.asarray(values, dtype=np.int32))
    if jax.process_count() == 1:
        return vals
    if _KvVotes._client() is not None:
        return _KV_VOTES.vote(vals, np.maximum)
    local = np.broadcast_to(
        vals, (jax.local_device_count(),) + vals.shape
    ).copy()
    g = jax.make_array_from_process_local_data(
        NamedSharding(mesh, P("data")), local
    )
    return np.asarray(jax.device_get(_jitted_max0(g)))


def _make_cgr_steps(mesh, k: int, phred: int, wire):
    """(step_arrays, step_wire_or_None) for a sharded CGR session — cached
    process-wide like ``mesh.make_sharded_stats_step`` (a fresh jit per
    session re-traces the shard_map program every pass)."""
    from .mesh import _STEP_CACHE, _step_cache_put, shard_map
    from ..kernels.cgr import cgr_batch_tables

    ck = ("cgr", mesh, k, phred, wire)
    if ck in _STEP_CACHE:
        return _STEP_CACHE[ck]

    def device_fn(codes, quals, lens, valid):
        ts, tq_hi, tq_lo, w = cgr_batch_tables(
            codes, quals, lens, valid, k, phred, vary_axis="data"
        )
        return (
            jax.lax.psum(ts, "data"),
            jax.lax.psum(tq_hi, "data"),
            jax.lax.psum(tq_lo, "data"),
            jax.lax.psum(w, "data"),
        )

    # jit shape-caches per dispatch shape; shard_map retraces under it
    step_arrays = jax.jit(shard_map(
        device_fn, mesh=mesh,
        in_specs=(P("data"),) * 4, out_specs=(P(),) * 4,
    ))
    step_wire = None
    if wire in ("bitpack", "fused4"):
        from ..kernels.stats_jnp import wire_unbits, wire_unfuse

        unf = wire_unbits if wire == "bitpack" else wire_unfuse

        def device_fn_wire(buf):
            return device_fn(*unf(buf))

        step_wire = jax.jit(shard_map(
            device_fn_wire, mesh=mesh,
            in_specs=(P("data"),), out_specs=(P(),) * 4,
        ))
    _step_cache_put(ck, (step_arrays, step_wire))
    return step_arrays, step_wire


class ShardedCgrSession:
    """Chaos-game accumulation data-parallel over the mesh: each device
    fills its own [dim, dim] tables inside shard_map (zero steady-state
    collectives); the merge is one psum (tables are plain sums).  Batches
    ride the active wire format (one uint8 buffer per host per step,
    decoded per device) with the same voted trimmed dispatch shapes as the
    stats sessions."""

    def __init__(self, mesh, k: int, phred: int, batch_reads: int):
        from ..core.accumulator import resolve_wire

        self.mesh = mesh if mesh is not None else data_mesh()
        self.k = k
        self.phred = phred
        self.ndev = ndev = self.mesh.devices.size
        self.batch_reads = round_up(max(batch_reads, ndev), ndev)
        dim = 1 << k
        self.table_seq = np.zeros((dim, dim), dtype=np.int64)
        self.table_q = np.zeros((dim, dim), dtype=np.int64)
        self.word_count = 0
        self.wire = resolve_wire()
        self._sharding = NamedSharding(self.mesh, P("data"))
        self._step_arrays, self._step_wire = _make_cgr_steps(
            self.mesh, k, phred, self.wire
        )
        from ..io.packer import bitwire_tier_floor

        self._tiered = self.wire == "bitpack"
        self._tier_floor = bitwire_tier_floor() if self._tiered else 2
        self._probe = None
        self._tier_miss = 0

    # adaptive-tier probe identical to the stats session's (the decode
    # dispatches on width, and both tiers are lossless for quals)
    _probe_tier = ShardedStatsSession._probe_tier

    def local_shape(self, block):
        """``(lmax, rows, rawlen[, tier])`` vote vector — see
        ``ShardedStatsSession.local_shape`` (lmax floors at the word size
        ``k`` so every step has at least one window column)."""
        if block is None:
            return (0, 0, 0, 0) if self._tiered else (0, 0, 0)
        lmax = round_up(max(block.max_len(), self.k), 128)
        rows = min(self.batch_reads,
                   round_up(bucket_rows(block.num_reads, self.batch_reads),
                            self.ndev))
        rawlen = max(block.max_len(), self.k)
        if not self._tiered:
            return (lmax, rows, rawlen)
        wl = wire_len(rawlen, lmax)
        return (lmax, rows, rawlen, self._probe_tier(block, wl, rows))

    def feed_block(self, block, shape=None):
        if shape is None:
            shape = self.local_shape(block)
        lmax, rows, rawlen = shape[:3]
        if self._step_wire is not None:
            from ..io.packer import pack_block_bitwire_tier, pack_block_wire

            wl = wire_len(rawlen, lmax)
            if self._tiered and len(shape) > 3:
                tier = shape[3]
                pr, self._probe = self._probe, None
                if pr is not None and pr[0] == id(block) \
                        and pr[1] == (tier, wl, rows):
                    buf = pr[2]
                else:
                    buf = pack_block_bitwire_tier(block, wl, tier,
                                                  pad_reads_to=rows)
            else:
                buf = pack_block_wire(block, self.wire, wl,
                                      pad_reads_to=rows)
            self._fold(self._step_wire(*make_global_batch(
                self.mesh, self._sharding, (buf,)
            )))
            return
        self.feed_packed(*pack_block(block, max_len=lmax, pad_reads_to=rows))

    def feed_empty(self, shape=None):
        # default rawlen floors at k so the decoded width always fits at
        # least one CGR window (wire_len(1, 128) would be 8 columns —
        # window_cells needs >= k)
        if shape is None:
            shape = (round_up(max(128, self.k), 128), self.batch_reads,
                     self.k)
        lmax, rows, rawlen = shape[:3]
        if self._step_wire is not None:
            wl = wire_len(rawlen, lmax)
            if self.wire == "bitpack":
                from ..io.packer import bitwire_tier_width

                tier = shape[3] if len(shape) > 3 else 2
                W = bitwire_tier_width(wl, tier)
            else:
                W = wl // 2 + wl + 8
            # all-zero wire rows decode to valid=0 (no reads)
            self._fold(self._step_wire(*make_global_batch(
                self.mesh, self._sharding, (np.zeros((rows, W), np.uint8),)
            )))
            return
        z = np.full((rows, lmax), 5, dtype=np.int8)
        self.feed_packed(z, np.zeros_like(z, dtype=np.uint8),
                         np.zeros(rows, np.int32),
                         np.zeros(rows, bool))

    def feed_packed(self, codes, quals, lens, valid):
        batch = make_global_batch(
            self.mesh, self._sharding,
            (codes, quals, lens.astype(np.int32), valid),
        )
        self._fold(self._step_arrays(*batch))

    def _fold(self, tables) -> None:
        from ..kernels.cgr import combine_quality_limbs

        host = jax.device_get(tables)
        self.table_seq += np.asarray(host[0], dtype=np.int64)
        self.table_q += combine_quality_limbs(host[1], host[2])
        self.word_count += int(host[3])


def open_shard_reader(path: str, opts, pidx: int, pcnt: int,
                      start_offset=None):
    """(reader, block_iterator) for this process's slice of the input:
    record-aligned byte range (plain/BGZF), stripe fallback (plain gzip),
    or the whole file single-process.  ``start_offset`` resumes range/plain
    readers from a checkpointed logical offset."""
    if pcnt > 1 and range_splittable(path):
        start, end = split_byte_ranges(path, pcnt)[pidx]
        if start_offset is not None:
            start = max(start, start_offset)
        reader = FastqReader(path, batch_size=opts.batch_size,
                             start_offset=start, end_offset=end)
        return reader, iter(reader)
    if pcnt > 1:
        reader = FastqReader(path, batch_size=opts.batch_size)
        return reader, striped_blocks(reader, pidx, pcnt)
    reader = FastqReader(path, batch_size=opts.batch_size,
                         start_offset=start_offset or 0)
    return reader, iter(reader)


def iter_lockstep(mesh, blocks, multihost: bool, min_len: int, timers,
                  shape_fn=None):
    """Lockstep iterator over one shard: yields ``(block_or_None, lmax)``
    once per global step.  In multihost mode a tiny collective agrees on
    'anyone left' and the global length bucket every step (so shard_map
    shapes stay identical across processes); a ``None`` block means this
    shard is exhausted but others are not (feed an empty batch).  Single-
    process mode degenerates to plain iteration with local buckets.

    With ``shape_fn`` (trimmed dispatch shapes — the stats sessions):
    ``shape_fn(block_or_None)`` returns this rank's int shape-bucket tuple
    (``ShardedStatsSession.local_shape``; all zeros when exhausted); the
    whole tuple is voted element-wise max in the SAME single collective and
    yielded as ``(block, voted_tuple)``.  ``voted[0] == 0`` (no rank has a
    length bucket) ends the loop."""
    done = False
    while True:
        if done:
            block = None
        else:
            with timers.stage("read"):
                block = next(blocks, None)
        if block is None:
            done = True
        if shape_fn is not None:
            local = shape_fn(block)
            if multihost:
                with timers.stage("vote"):
                    voted = tuple(int(v) for v in _vote_max_vec(mesh, local))
            else:
                voted = tuple(int(v) for v in local)
            if voted[0] == 0:
                return
            yield block, voted
        elif multihost:
            lmax_local = (
                0 if done else round_up(max(block.max_len(), min_len), 128)
            )
            with timers.stage("vote"):
                lmax_global = _vote_max(mesh, lmax_local)
            if lmax_global == 0:
                return
            yield block, lmax_global
        else:
            if done:
                return
            yield block, round_up(max(block.max_len(), min_len), 128)
        if block is not None and hasattr(block, "num_reads"):
            # paired iterators yield (b1, b2) tuples and account their own
            # timers (_iter_blocks_paired); only bare blocks count here
            timers.num_batches += 1
            timers.total_reads += block.num_reads


class _RotatingRankCheckpoint:
    """Per-rank rotating two-slot checkpoints with common-ordinal voting.

    Saves happen at the same lockstep step on every rank, so ranks' latest
    save ordinals differ by at most one after a crash; keeping two slots and
    voting the newest COMMON ordinal (plus an all-ranks-can-resume vote)
    guarantees every rank restores the state of the same global step."""

    def __init__(self, mesh, path: str, key: str, every: int):
        self.mesh = mesh
        self.pcnt = jax.process_count()
        base = path if self.pcnt == 1 else (
            "%s.rank%d" % (path, jax.process_index())
        )
        self.base = base
        self.key = key
        self.every = max(1, every)
        self.ordinal = -1
        self.nsteps = 0

    def resume(self):
        """(counters_or_None, offset, extra) at the common ordinal, or
        None when any rank lacks a usable checkpoint."""
        from ..utils.checkpoint import load_counters_checkpoint

        cands = {}
        for slot in ("a", "b"):
            try:
                got = load_counters_checkpoint(self.base + "." + slot, self.key)
            except ValueError:
                got = None
            if got:
                cands[int(got[2]["ordinal"])] = got
        local_max = max(cands) if cands else -1
        common = local_max
        if self.pcnt > 1:
            common = -_vote_max(self.mesh, -local_max)
        ok = 1 if (common >= 0 and common in cands) else 0
        if self.pcnt > 1:
            ok = -_vote_max(self.mesh, -ok)
        if not ok:
            return None
        self.ordinal = common
        return cands[common]

    def maybe_save(self, counters, offset: int, extra=None, fold=None,
                   counters2=None):
        """Call once per lockstep step; saves every ``every`` steps (running
        ``fold()`` first — e.g. the collective carry fold).  ``counters``/
        ``counters2`` may be callables (evaluated after the fold);
        ``counters2`` holds the mate-2 accumulator for paired stats."""
        from ..utils.checkpoint import save_counters_checkpoint

        self.nsteps += 1
        if self.nsteps % self.every:
            return False
        if fold is not None:
            fold()
        self.ordinal += 1
        slot = "a" if self.ordinal % 2 == 0 else "b"
        payload = dict(extra or {})
        payload["ordinal"] = self.ordinal
        save_counters_checkpoint(
            self.base + "." + slot,
            counters() if callable(counters) else counters,
            offset, self.key, extra=payload,
            counters2=counters2() if callable(counters2) else counters2,
        )
        return True

    def complete(self):
        for slot in ("a", "b"):
            p = self.base + "." + slot
            if os.path.exists(p):
                os.unlink(p)


def _sharded_batch_reads(opts, mesh) -> int:
    """Device batch rows: never below the reader's batch_size (pack_block
    emits max(pad, n) rows — an undersized pad would break even sharding and
    multihost lockstep shapes), always a multiple of the device count."""
    ndev = mesh.devices.size
    want = int(opts.device_batch_reads) or max(ndev * 256,
                                               round_up(opts.batch_size, 256))
    return round_up(max(want, opts.batch_size), ndev)


def run_cgr_sharded(opts, timers: Optional[StageTimers] = None, mesh=None):
    """Multi-device / multi-host `cgr` — the BASELINE config #5 shape:
    per-host input shard (byte range or gzip stripe), per-device CGR tables,
    psum merge, process-0 PGM/report emission."""
    from ..pipeline import cgr_run

    timers = timers or StageTimers()
    initialize_distributed()
    mesh = mesh if mesh is not None else data_mesh()
    multihost = jax.process_count() > 1
    sess = ShardedCgrSession(
        mesh, int(opts.k), opts.quality_encoding_value,
        batch_reads=_sharded_batch_reads(opts, mesh),
    )

    pidx, pcnt = jax.process_index(), jax.process_count()
    inputs = [opts.in_filename]
    if opts.paired_end:
        inputs.append(opts.in_filename2)

    # checkpointing (CGR tables are replicated-global after every batch's
    # psum, so each rank's saved tables + its local offset restore exactly)
    ck_path = getattr(opts, "checkpoint_path", None)
    if ck_path and pcnt > 1 and any(not range_splittable(p) for p in inputs):
        import logging

        logging.getLogger("hpgq").warning(
            "--checkpoint is not supported for striped (plain-gzip) "
            "multi-host input; running without checkpoints"
        )
        ck_path = None
    ck = None
    start_input = 0
    resume_offset = None
    if ck_path:
        import json as _json
        import numpy as _np

        ck_key = _json.dumps({
            "cmd": "cgr-sharded", "k": int(opts.k),
            "phred": opts.quality_encoding_value,
            "in": [os.path.abspath(p) for p in inputs],
            "rank": pidx, "nprocs": pcnt,
        }, sort_keys=True)
        ck = _RotatingRankCheckpoint(mesh, ck_path, ck_key,
                                     opts.checkpoint_every or 50)
        got = ck.resume()
        if got:
            _, resume_offset, extra = got
            sess.table_seq += _np.asarray(extra["table_seq"], dtype=_np.int64)
            sess.table_q += _np.asarray(extra["table_q"], dtype=_np.int64)
            sess.word_count += int(extra["words"])
            start_input = int(extra["input_idx"])

    for input_idx, path in enumerate(inputs):
        if input_idx < start_input:
            continue
        in_offset = resume_offset if input_idx == start_input else None
        resume_offset = None
        reader, blocks = open_shard_reader(path, opts, pidx, pcnt,
                                           start_offset=in_offset)
        last_offset = in_offset or 0
        try:
            for block, shape in iter_lockstep(mesh, blocks, multihost,
                                              sess.k, timers,
                                              shape_fn=sess.local_shape):
                with timers.stage("compute"):
                    if block is None:
                        sess.feed_empty(shape)
                    else:
                        sess.feed_block(block, shape=shape)
                        last_offset = block.end_offset
                if ck is not None:
                    with timers.stage("checkpoint"):
                        ck.maybe_save(
                            None, last_offset,
                            extra={
                                "table_seq": sess.table_seq,
                                "table_q": sess.table_q,
                                "words": sess.word_count,
                                "input_idx": input_idx,
                            },
                        )
        finally:
            reader.close()
    if ck is not None:
        ck.complete()

    if jax.process_index() != 0:
        return {"fq_word_count": sess.word_count, "pgm_files": []}
    return cgr_run.emit_cgr_outputs(opts, sess, timers)


def _run_stats_sharded_paired(opts, timers, mesh, report: bool = True):
    """Paired-end sharded stats: record-count-aligned shard ranges for both
    mates (``split_paired_ranges``), ONE fused shard_map dispatch per step
    (pair-consistent verdict + both mates' accumulation,
    ``ShardedPairedStatsSession``), lockstep shape votes so every process
    grows its shard_map shapes together.  Mirrors the single-process paired
    path (``pipeline.run.run_stats``)."""
    import dataclasses

    from ..kernels.stats_jnp import _crit_key
    from ..pipeline.run import _iter_blocks_paired

    pidx, pcnt = jax.process_index(), jax.process_count()
    multihost = pcnt > 1
    phred = opts.quality_encoding_value
    crit = opts.criteria if opts.filter_on else None
    br = _sharded_batch_reads(opts, mesh)

    if multihost:
        _require_splittable([opts.in_filename, opts.in_filename2],
                            "paired stats")
        (s1, e1), (s2, e2) = split_paired_ranges(
            opts.in_filename, opts.in_filename2, pcnt
        )[pidx]
    else:
        (s1, e1), (s2, e2) = (0, None), (0, None)

    sess = ShardedPairedStatsSession(mesh, phred, opts.kmers_on, crit,
                                     batch_reads=br)

    # checkpointing: per-rank rotating two-slot files with common-ordinal
    # voting (same protocol as single-end sharded stats); state = both
    # mates' folded carries (pass/fail tallies ride inside carry1, folded
    # from the device accumulator) + both local reader offsets.  Saves
    # land at the SAME lockstep step on every rank (incl. empty tail
    # steps), so restored states describe one global step.
    ck = None
    if getattr(opts, "checkpoint_path", None):
        import json as _json

        ck_key = _json.dumps({
            "cmd": "stats-sharded-paired",
            "fused": True,  # pass/fail moved into carry1 — old-format
            # checkpoints (host-side tallies) must not resume here
            "in": [os.path.abspath(opts.in_filename),
                   os.path.abspath(opts.in_filename2)],
            "phred": phred, "kmers": opts.kmers_on,
            "crit": _crit_key(crit),
            "rank": pidx, "nprocs": pcnt,
        }, sort_keys=True)
        ck = _RotatingRankCheckpoint(mesh, opts.checkpoint_path, ck_key,
                                     opts.checkpoint_every or 50)
        got = ck.resume()
        if got:
            carry1, off1, extra = got
            sess.carry1 = carry1
            sess.carry2 = extra["__counters2__"]
            s1 = max(s1, int(off1))
            s2 = max(s2, int(extra["offset2"]))

    last_off1, last_off2 = s1, s2
    with FastqReader(opts.in_filename, batch_size=opts.batch_size,
                     start_offset=s1, end_offset=e1) as r1, \
         FastqReader(opts.in_filename2, batch_size=opts.batch_size,
                     start_offset=s2, end_offset=e2) as r2:
        pairs = _iter_blocks_paired(r1, r2, timers)
        for pair, shape in iter_lockstep(mesh, pairs, multihost, 1, timers,
                                         shape_fn=sess.local_shape):
            if shape[0] > sess.lcap:
                sess._grow(shape[0])
            with timers.stage("compute"):
                if pair is None:
                    sess.feed_empty(shape)
                else:
                    b1, b2 = pair
                    sess.feed_pair(b1, b2, shape=shape)
                    last_off1, last_off2 = b1.end_offset, b2.end_offset
            if ck is not None:
                with timers.stage("checkpoint"):
                    ck.maybe_save(
                        lambda: sess.carry1, last_off1,
                        counters2=lambda: sess.carry2,
                        extra={"offset2": last_off2},
                        fold=lambda: sess._grow(sess.lcap),
                    )

    with timers.stage("compute"):
        c1, c2 = sess.finish()
    if ck is not None:
        ck.complete()
    # pass/fail tallies were psum'd globally by the collective merge into
    # c1; mirror onto c2 like the single-host paired runner
    for c in (c1, c2):
        c.filter_on = crit is not None
        c.num_passed, c.num_failed = c1.num_passed, c1.num_failed
    if report and jax.process_index() == 0:
        with timers.stage("reporting"):
            stats_report(c1, opts)
            opts2 = dataclasses.replace(opts, in_filename=opts.in_filename2)
            stats_report(c2, opts2)
    return c1, c2


# ---------------------------------------------------------------------------
# sharded filter / edit (per-host output shards, deterministic concat)
# ---------------------------------------------------------------------------

def _require_splittable(paths, cmd: str):
    from ..options import OptionsError

    for p in paths:
        if not range_splittable(p):
            raise OptionsError(
                "%s: multi-host --sharded needs a byte-seekable input "
                "(plain or BGZF FASTQ); %r is plain gzip — recompress with "
                "bgzip or run without --sharded" % (cmd, p)
            )


def _shard_path(path: str, pidx: int) -> str:
    return "%s.shard%04d" % (path, pidx)


def _concat_shards(mesh, final_paths, pcnt: int) -> bool:
    """Rank 0: concatenate per-rank output shards (rank order == input
    order, because byte-range shards are assigned in file order) into the
    final files and remove the shards.  Needs the output dir to be a shared
    filesystem; if any shard is missing on rank 0 the shards are left in
    place for manual concat and False is returned."""
    import logging
    import shutil

    _barrier(mesh)  # every rank finished writing its shards
    if jax.process_index() != 0:
        _barrier(mesh)
        return True
    ok = True
    try:
        for final in final_paths:
            shards = [_shard_path(final, i) for i in range(pcnt)]
            if not all(os.path.exists(s) for s in shards):
                logging.getLogger("hpgq").warning(
                    "output dir is not shared across hosts; per-rank shards "
                    "left as %s.shard*", final
                )
                ok = False
                continue
            with open(final, "wb") as out:
                for s in shards:
                    with open(s, "rb") as f:
                        shutil.copyfileobj(f, out, 16 << 20)
            for s in shards:
                os.unlink(s)
    finally:
        _barrier(mesh)  # ranks may not delete shards before concat is done
    return ok


def run_filter_sharded(opts, timers: Optional[StageTimers] = None, mesh=None):
    """Multi-host `filter`: each process filters its own record-aligned
    shard (single- or paired-end) and writes per-rank output shards;
    rank 0 concatenates them in shard order, which reproduces the
    single-process output byte-for-byte (SURVEY §5 dist row).  Counts are
    summed with one collective.  Single-process --sharded degenerates to
    the ordinary pipeline (identical outputs; the verdict kernel is not the
    bottleneck at one host)."""
    from ..pipeline.run import run_filter

    timers = timers or StageTimers()
    initialize_distributed()
    pidx, pcnt = jax.process_index(), jax.process_count()
    if pcnt == 1:
        return run_filter(opts, timers)
    mesh = mesh if mesh is not None else data_mesh()
    return _run_output_sharded(opts, timers, mesh, "filter", run_filter,
                               ("num_passed", "num_failed"))


def run_edit_sharded(opts, timers: Optional[StageTimers] = None, mesh=None):
    """Multi-host `edit` — same sharding scheme as :func:`run_filter_sharded`."""
    from ..pipeline.run import run_edit

    timers = timers or StageTimers()
    initialize_distributed()
    pidx, pcnt = jax.process_index(), jax.process_count()
    if pcnt == 1:
        return run_edit(opts, timers)
    mesh = mesh if mesh is not None else data_mesh()
    return _run_output_sharded(opts, timers, mesh, "edit", run_edit,
                               ("num_edited", "num_passed", "num_failed"))


def _run_output_sharded(opts, timers, mesh, cmd, runner, count_keys):
    """Shared machinery for sharded filter/edit: rewrite opts to this
    process's input range + shard-suffixed output dir, run the ordinary
    pipeline on the shard, then concat + sum counts."""
    import dataclasses

    pidx, pcnt = jax.process_index(), jax.process_count()
    inputs = [opts.in_filename] + (
        [opts.in_filename2] if opts.paired_end else []
    )
    _require_splittable(inputs, cmd)

    if opts.paired_end:
        (s1, e1), (s2, e2) = split_paired_ranges(
            opts.in_filename, opts.in_filename2, pcnt
        )[pidx]
        ranges = {opts.in_filename: (s1, e1), opts.in_filename2: (s2, e2)}
    else:
        ranges = {opts.in_filename: split_byte_ranges(opts.in_filename,
                                                      pcnt)[pidx]}

    # run the ordinary pipeline, but over range-bounded readers and into
    # shard-suffixed outputs (out_dirname gets a per-rank subdir; the
    # final concat lifts files up)
    shard_dir = os.path.join(opts.out_dirname, ".shard%04d" % pidx)
    os.makedirs(shard_dir, exist_ok=True)
    local = dataclasses.replace(opts) if dataclasses.is_dataclass(opts) else opts
    local.out_dirname = shard_dir
    # checkpointing: each rank resumes its own shard independently (no
    # lockstep in the output commands — the only collectives are the final
    # count sum and concat barrier); the per-rank file plus the range in
    # the checkpointer's config key refuse a resume under a different
    # process count (ranges would differ)
    ck_base = getattr(opts, "checkpoint_path", None)
    local.checkpoint_path = ck_base and "%s.rank%04d" % (ck_base, pidx)
    # the range fields both bound the runner's readers AND disable the
    # in-process parallel shard path inside it (this host's range IS one
    # shard; nesting would re-split the whole file)
    if opts.paired_end:
        local.input_range = ranges[opts.in_filename]
        local.input_range2 = ranges[opts.in_filename2]
    else:
        local.input_range = ranges[opts.in_filename]

    out = runner(local, timers)

    # lift shard outputs: <out>/.shardNNNN/passed.fq -> <out>/passed.fq.shardNNNN
    finals = []
    for name in sorted(os.listdir(shard_dir)):
        final = os.path.join(opts.out_dirname, name)
        os.replace(os.path.join(shard_dir, name), _shard_path(final, pidx))
        finals.append(final)
    os.rmdir(shard_dir)

    # global file list (ranks with empty shards still created all writers,
    # so the name set is identical on every rank)
    _concat_shards(mesh, finals, pcnt)
    summed = _vote_sum(mesh, [int(out.get(k, 0)) for k in count_keys])
    for k, v in zip(count_keys, summed):
        out[k] = int(v)
    for k in list(out):
        if isinstance(out[k], str) and ".shard" in out[k]:
            out[k] = out[k].replace(shard_dir, opts.out_dirname)
    return out


# NOTE: both single-process and MULTI-HOST sharded stats use trimmed
# dispatch shapes (bucketed rows + trimmed wire columns, like the
# single-chip engine); in multihost mode the per-step (lmax, rows, rawlen)
# tuple is voted element-wise max across ranks in the one lockstep
# collective (iter_lockstep shape_fn), so every rank dispatches identical
# shard_map shapes.  Readers keep the exact --batch-size: per-rank step
# counts feed the lockstep collectives.
def run_stats_sharded(
    opts: StatsOptions,
    timers: Optional[StageTimers] = None,
    mesh=None,
    report: bool = True,
):
    """Multi-device / multi-host `stats`.  Returns counters — identical on
    every process after the collective merge (a (c1, c2) tuple when
    paired)."""
    timers = timers or StageTimers()
    initialize_distributed()
    mesh = mesh if mesh is not None else data_mesh()
    if opts.paired_end:
        return _run_stats_sharded_paired(opts, timers, mesh, report)
    crit = opts.criteria if opts.filter_on else None
    multihost = jax.process_count() > 1

    sess = ShardedStatsSession(
        mesh, opts.quality_encoding_value, opts.kmers_on, crit,
        batch_reads=_sharded_batch_reads(opts, mesh),
    )

    pidx, pcnt = jax.process_index(), jax.process_count()
    path = opts.in_filename

    # --- checkpointing: one file per process; folds happen at the SAME step
    # on every process (the lockstep loop guarantees equal step counts), so
    # the collective merge inside the fold stays consistent.  The carry each
    # host saves is the replicated GLOBAL total at that step + its own local
    # input offset.  Striped inputs (plain gzip, multihost) can't resume:
    # the stripe phase is not recoverable from an offset.
    ck_path = getattr(opts, "checkpoint_path", None)
    striped = pcnt > 1 and not range_splittable(path)
    if ck_path and striped:
        import logging

        logging.getLogger("hpgq").warning(
            "--checkpoint is not supported for striped (plain-gzip) "
            "multi-host input; running without checkpoints"
        )
        ck_path = None
    ck = None
    resume_offset = None
    if ck_path:
        import json as _json

        from ..kernels.stats_jnp import _crit_key

        ck_key = _json.dumps({
            "cmd": "stats-sharded", "in": os.path.abspath(path),
            "phred": opts.quality_encoding_value, "kmers": opts.kmers_on,
            "crit": _crit_key(crit),
            "rank": pidx, "nprocs": pcnt,
        }, sort_keys=True)
        ck = _RotatingRankCheckpoint(mesh, ck_path, ck_key,
                                     opts.checkpoint_every or 50)
        got = ck.resume()
        if got:
            carry, resume_offset, _ = got
            sess.carry = carry

    reader, blocks = open_shard_reader(path, opts, pidx, pcnt,
                                       start_offset=resume_offset)
    last_offset = resume_offset or 0
    try:
        for block, shape in iter_lockstep(mesh, blocks, multihost, 1, timers,
                                          shape_fn=sess.local_shape):
            if shape[0] > sess.lcap:
                sess._grow(shape[0])
            with timers.stage("compute"):
                if block is None:
                    sess.feed_empty(shape)
                else:
                    sess.feed_block(block, shape=shape)
                    last_offset = block.end_offset
            if ck is not None:
                with timers.stage("checkpoint"):
                    ck.maybe_save(
                        lambda: sess.carry, last_offset,
                        fold=lambda: sess._grow(sess.lcap),
                    )
    finally:
        reader.close()

    with timers.stage("finish-merge"):
        counters = sess.finish()
    if ck is not None:
        ck.complete()
    if report and jax.process_index() == 0:
        with timers.stage("reporting"):
            stats_report(counters, opts)
    return counters
