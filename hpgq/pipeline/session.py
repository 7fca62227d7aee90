"""Engine session: shape management + jit caching for the streaming pipeline.

The streaming loop feeds fixed-shape ``[B, Lbucket]`` batches to jitted device
functions (XLA requires static shapes): read lengths are bucketed to
multiples of 128 lanes, the read dimension is padded to the configured batch
size, and a grown length bucket transparently rebuilds the device accumulator
(host counters carry over — merging is associative).
"""

from __future__ import annotations

import os

import numpy as np
import jax

from ..core.accumulator import DeviceAccumulator
from ..io.packer import bucket_rows, pack_block, round_up, wire_len


def warn_device_batch(rows: int, lcap: int, mates: int = 1) -> bool:
    """Log an actionable warning when long-read growth makes a device
    dispatch large (the user should lower --batch-size /
    --device-batch-reads rather than discover a device OOM).  ``rows`` is
    the ACTUAL dispatch row count (blocks are 16 MB chunk-bound, usually
    far below the configured batch — warning on the configured cap would
    overstate memory ~8x for long reads).  Returns True when it fired, so
    sessions warn once."""
    if mates * lcap * rows > (1 << 28):  # ~0.33 GB of wire bytes
        import logging

        logging.getLogger("hpgq").warning(
            "long reads: device batch is %s%d rows x %d nt (~%.1f GB "
            "packed) — lower --batch-size / --device-batch-reads to "
            "bound device memory",
            "2 x " if mates == 2 else "", rows, lcap,
            mates * rows * lcap * 1.25 / 1e9,
        )
        return True
    return False


class StatsSession:
    """Streaming stats accumulation with automatic length growth."""

    def __init__(self, phred, kmers_on=False, crit=None, batch_reads=16384,
                 device=None, lcap: int = 128):
        self.phred = phred
        self.kmers_on = kmers_on
        self.crit = crit
        self.batch_reads = batch_reads
        self.device = device
        self._warned_big = False
        self.acc = DeviceAccumulator(
            lcap, phred, kmers_on, crit, batch_reads=batch_reads, device=device,
        )

    @property
    def lcap(self):
        return self.acc.lcap

    def _grow(self, lcap: int):
        old = self.acc.finish()
        self.acc = DeviceAccumulator(
            lcap, self.phred, self.kmers_on, self.crit,
            batch_reads=self.batch_reads, device=self.device,
        )
        self.acc.counters = old
        old.ensure_length(lcap)

    def feed_block(self, block, timers=None):
        """Feed a RecordBlock — via the native single-pass wire packer when
        a wire format is active, else as packed numpy arrays."""
        lmax = round_up(max(block.max_len(), 1), 128)
        if lmax > self.lcap:
            self._grow(lmax)
        wire = self.acc.wire
        rows = bucket_rows(block.num_reads, self.batch_reads)
        if not self._warned_big:
            self._warned_big = warn_device_batch(rows, self.lcap)
        if wire in ("bitpack", "fused4"):
            from ..io.packer import pack_block_wire, try_pack_block_2u

            if wire == "bitpack":
                u = try_pack_block_2u(block, pad_reads_to=rows)
                if u is not None:
                    self.acc.update_uniform(u)
                    return
            self.acc.update(pack_block_wire(
                block, wire, wire_len(block.max_len(), self.lcap),
                pad_reads_to=rows, allow6=True, allow2c=True))
            return
        self.feed_packed(*pack_block(
            block, max_len=self.lcap, pad_reads_to=rows
        ))

    def feed_packed(self, codes, quals=None, lens=None, valid=None):
        # quals carry the logical L; a lone wire buffer encodes L in its
        # row width (fused4: W = L/2 + L + 8; bitpack: W = 10L/8 + 8; a
        # (buf, exc) tuple is the 2c tier with its exception sidecar; a
        # ("2u", buf, exc, pal, n_valid, Lu) tagged tuple is the uniform
        # tier whose L travels out-of-band).  Wire widths may be trimmed
        # below lcap (io.packer.wire_len); the device cap itself always
        # stays 128-lane rounded.
        if isinstance(codes, tuple) and len(codes) \
                and isinstance(codes[0], str) and codes[0] == "2u":
            _, buf, exc, pal, n_valid, Lu = codes
            if Lu > self.lcap:
                self._grow(round_up(Lu, 128))
            self.acc.update_uniform((buf, exc, pal, n_valid, Lu))
            return
        if quals is None:
            from ..kernels.stats_jnp import bitwire_logical_len, fused_logical_len

            W = (codes[0] if isinstance(codes, tuple) else codes).shape[1]
            L = (bitwire_logical_len if self.acc.wire == "bitpack"
                 else fused_logical_len)(W)
        else:
            L = quals.shape[1]
        if L > self.lcap:
            self._grow(round_up(L, 128))
        self.acc.update(codes, quals, lens, valid)

    def finish(self):
        return self.acc.finish()


class PairedStatsSession:
    """Streaming paired-end stats: BOTH mates' verdicts + accumulation in
    one fused device dispatch per batch (``make_paired_stats_step``).

    One shared length bucket covers both mates (they grow together), and
    the two device accumulators flush into two host counters on the same
    overflow-safe window as :class:`~hpgq.core.accumulator.DeviceAccumulator`.
    """

    def __init__(self, phred, kmers_on=False, crit=None, batch_reads=16384,
                 lcap: int = 128):
        from ..core.accumulator import resolve_wire, safe_flush_every
        from ..core.counters import StatsCounters

        self.phred = phred
        self.kmers_on = kmers_on
        self.crit = crit
        self.batch_reads = batch_reads
        self.wire = resolve_wire()
        self.counters1 = StatsCounters(phred=phred, kmers_on=kmers_on)
        self.counters2 = StatsCounters(phred=phred, kmers_on=kmers_on)
        self._safe_flush_every = safe_flush_every
        self._since_flush = 0
        self._warned_big = False
        self._rebuild(lcap)

    def _rebuild(self, lcap: int):
        from ..kernels.stats_jnp import make_paired_stats_step, zero_partials

        self.lcap = lcap
        self._step = make_paired_stats_step(
            lcap, self.phred, self.kmers_on, self.crit, wire=self.wire,
        )
        self._acc1 = zero_partials(lcap, self.kmers_on)
        self._acc2 = zero_partials(lcap, self.kmers_on)
        self.flush_every = self._safe_flush_every(self.batch_reads, lcap)

    def _grow(self, lcap: int):
        self.flush()
        self._rebuild(lcap)

    @property
    def num_passed(self) -> int:
        """Pair-consistent passed count (device tallies fold into
        ``counters1`` at flush; callers read after :meth:`flush`)."""
        return self.counters1.num_passed

    @property
    def num_failed(self) -> int:
        return self.counters1.num_failed

    def pack_pair(self, b1, b2):
        """Host-pack a lockstep mate-block pair → ``(in1, in2)`` input
        tuples for :meth:`feed_pair_packed`.  Reads ``self.lcap`` once and
        packs at ``L = max(lmax, lcap)``, so it is safe to run on a
        transform-pool thread while the main thread feeds (mirrors the
        single-end ``_iter_packed`` contract: a concurrent growth just
        means this pair arrives narrower than the new lcap — the step
        pads trimmed widths on device)."""
        lmax = round_up(max(b1.max_len(), b2.max_len(), 1), 128)
        L = max(lmax, self.lcap)
        rows = bucket_rows(max(b1.num_reads, b2.num_reads), self.batch_reads)
        if not self._warned_big:
            self._warned_big = warn_device_batch(rows, L, mates=2)
        if self.wire in ("bitpack", "fused4"):
            from ..io.packer import pack_block_wire, try_pack_block_2u

            if self.wire == "bitpack":
                # uniform tier, both mates (each with its own palette and
                # uniform length — mates may differ): the fused 2u step
                u1 = try_pack_block_2u(b1, pad_reads_to=rows)
                u2 = (try_pack_block_2u(b2, pad_reads_to=rows)
                      if u1 is not None else None)
                if u2 is not None:
                    return ("2u",) + u1, ("2u",) + u2
            wl = wire_len(max(b1.max_len(), b2.max_len()), L)
            in1 = pack_block_wire(b1, self.wire, wl, pad_reads_to=rows,
                                  allow6=True, allow2c=True)
            in2 = pack_block_wire(b2, self.wire, wl, pad_reads_to=rows,
                                  allow6=True, allow2c=True)
        else:
            in1 = pack_block(b1, max_len=L, pad_reads_to=rows)
            in2 = pack_block(b2, max_len=L, pad_reads_to=rows)
            if self.wire == "pack4":
                from ..kernels.stats_jnp import wire_pack4

                in1 = (wire_pack4(np.asarray(in1[0])),) + tuple(in1[1:])
                in2 = (wire_pack4(np.asarray(in2[0])),) + tuple(in2[1:])
        return in1, in2

    def _packed_len(self, in1) -> int:
        # wire mode packs each mate to ONE uint8 buffer (a (buf, exc)
        # 2-tuple for the 2c tier; a ("2u", buf, exc, pal, n_valid, Lu)
        # tagged tuple for the uniform tier); the plain/pack4 modes pass
        # the (codes, quals, lens, valid) tuple
        if self.wire in ("bitpack", "fused4"):
            from ..kernels.stats_jnp import (
                bitwire_logical_len,
                fused_logical_len,
            )

            if isinstance(in1, tuple) and in1 \
                    and isinstance(in1[0], str) and in1[0] == "2u":
                return int(in1[5])
            W = (in1[0] if isinstance(in1, tuple) else in1).shape[1]
            return (bitwire_logical_len if self.wire == "bitpack"
                    else fused_logical_len)(W)
        return in1[1].shape[1]

    def feed_pair_packed(self, in1, in2) -> None:
        """One fused step over a prepacked pair (``pack_pair`` output,
        possibly already device_put by a transform pool).  Never syncs on
        the device — tallies stay in the device accumulators."""
        L = max(self._packed_len(in1), self._packed_len(in2))
        if L > self.lcap:
            self._grow(round_up(L, 128))
        if isinstance(in1, tuple) and in1 and isinstance(in1[0], str):
            from ..kernels.stats_jnp import make_paired_stats_step2u

            _, b1, e1, p1, nv1, L1 = in1
            _, b2, e2, p2, nv2, L2 = in2
            step = make_paired_stats_step2u(
                self.lcap, self.phred, self.kmers_on, self.crit, L1, L2)
            self._acc1, self._acc2 = step(self._acc1, self._acc2,
                                          b1, e1, p1, nv1, b2, e2, p2, nv2)
        else:
            self._acc1, self._acc2 = self._step(self._acc1, self._acc2,
                                                in1, in2)
        self._since_flush += 1
        if self._since_flush >= self.flush_every:
            self.flush()

    def feed_pair(self, b1, b2) -> None:
        """One fused step over a lockstep mate-block pair (equal record
        counts; see ``_iter_blocks_paired``).  Never syncs on the device —
        the pass/fail tallies stay in the device accumulator so host
        packing of the next pair overlaps this step's compute."""
        lmax = round_up(max(b1.max_len(), b2.max_len(), 1), 128)
        if lmax > self.lcap:
            self._grow(lmax)
        in1, in2 = self.pack_pair(b1, b2)
        self.feed_pair_packed(in1, in2)

    def flush(self) -> None:
        if self._since_flush == 0:
            return
        from ..core.accumulator import fold_partials
        from ..kernels.stats_jnp import zero_partials

        fold_partials(self.counters1, jax.device_get(self._acc1))
        fold_partials(self.counters2, jax.device_get(self._acc2))
        self._acc1 = zero_partials(self.lcap, self.kmers_on)
        self._acc2 = zero_partials(self.lcap, self.kmers_on)
        self._since_flush = 0

    def finish(self):
        self.flush()
        return self.counters1, self.counters2


_FN_CACHE = {}  # global so compiled fns survive across pipeline runs


class ShapeCachedFn:
    """jit wrapper dispatching on padded batch shapes (one compile per bucket).

    ``cache_key`` (when hashable and non-None) keys a process-global compile
    cache, so repeated runs with identical static config reuse the jitted
    executable instead of recompiling (jax.jit caches per function object).

    When a wire format is active (bitpack/fused4, opt-in via HPGQ_WIRE),
    the block is packed host-side into the single wire buffer and decoded
    on device, so filter/edit/paired-stats verdict+trim calls ship the same
    bytes per read as the stats engine.

    ``qn_ok=True`` (filter/edit verdict+trim fns) upgrades an active wire
    to a smaller layout: the 2q qual-palette bitpack (5 bits/base) when
    every row has <= 4 distinct qual values (binned production corpora),
    else qn8 (1 byte/base vs bitpack's 10 bits/base — those kernels read
    only quality, length, and the per-base is-N flag,
    ``stats_jnp.wire_unqn8``)."""

    # consecutive palette misses before the dispatcher stops attempting the
    # 2q tier for the rest of the session: on unbinned corpora the numpy
    # fallback's palette attempt costs a full pack + per-row sort per batch
    # just to return None (the native packer bails much cheaper, but the
    # miss is still pure overhead) — data that missed a few consecutive
    # batches will essentially never fit later batches
    _PAL_MISS_LIMIT = 3

    def __init__(self, build_fn, batch_reads: int, cache_key=None,
                 qn_ok: bool = False):
        self._build = build_fn
        self._cache = {}
        self._key = cache_key
        self._qn = qn_ok
        self._pal_miss = 0
        self.batch_reads = batch_reads

    def _fn_for(self, shape, wire, wrap):
        if self._key is not None:
            key = (self._key, wire, shape)
            fn = _FN_CACHE.get(key)
            if fn is None:
                fn = _FN_CACHE[key] = jax.jit(wrap(self._build()))
            return fn
        key = (wire, shape)
        fn = self._cache.get(key)
        if fn is None:
            fn = self._cache[key] = jax.jit(wrap(self._build()))
        return fn

    def _resolved_wire(self):
        from ..core.accumulator import resolve_wire

        wire = resolve_wire()
        if wire in ("bitpack", "fused4"):
            from ..kernels.stats_jnp import (
                wire_unbits,
                wire_unfuse,
                wire_unqn8,
            )

            if self._qn and os.environ.get("HPGQ_QN_WIRE", "1") != "0":
                return "qn8", wire_unqn8
            return wire, (wire_unbits if wire == "bitpack" else wire_unfuse)
        return wire, None

    def __call__(self, block):
        from ..core.accumulator import resolve_wire

        lmax = round_up(max(block.max_len(), 1), 128)
        n = block.num_reads
        wire = resolve_wire()
        if wire in ("bitpack", "fused4"):
            from ..io.packer import pack_block_wire
            from ..kernels.stats_jnp import (
                wire_unbits,
                wire_unfuse,
                wire_unqn8,
            )

            # verdict/trim fns have no lane-width requirement: the wire can
            # carry exactly wire_len columns, no on-device re-pad needed
            wl = wire_len(block.max_len(), lmax)
            rows = bucket_rows(n, self.batch_reads)
            buf = None
            if self._qn and os.environ.get("HPGQ_QN_WIRE", "1") != "0":
                # prefer the narrowest layout that carries what the
                # verdict/trim kernels read: 2c (4.1 bits/base, exact
                # codes via the exception sidecar) over the 2q palette
                # (5 bits/base) over the qn8 upgrade (8 bits/base).
                # Sticky misfit: after _PAL_MISS_LIMIT consecutive misses
                # the session stops paying the attempts.
                if self._pal_miss < self._PAL_MISS_LIMIT:
                    from ..io.packer import (
                        try_pack_block_2c,
                        try_pack_block_palette,
                    )

                    buf = try_pack_block_2c(block, wl, pad_reads_to=rows)
                    if buf is None:
                        buf = try_pack_block_palette(block, wl,
                                                     pad_reads_to=rows)
                    self._pal_miss = 0 if buf is not None \
                        else self._pal_miss + 1
                if buf is not None:
                    wire, unf = "bitpack", wire_unbits
                else:
                    wire, unf = "qn8", wire_unqn8
            else:
                unf = wire_unbits if wire == "bitpack" else wire_unfuse
            if buf is None:
                buf = pack_block_wire(block, wire, wl, pad_reads_to=rows,
                                      allow6=(wire == "bitpack"))
            if isinstance(buf, tuple):  # 2c: (buf, exc) sidecar pair
                from ..kernels.stats_jnp import wire_unbits2c

                wrap2 = lambda inner: (  # noqa: E731
                    lambda b, e: inner(*wire_unbits2c(b, e)))
                out = self._fn_for((buf[0].shape, buf[1].shape),
                                   "bitpack2c", wrap2)(*buf)
            else:
                wrap = lambda inner: (lambda b: inner(*unf(b)))  # noqa: E731
                out = self._fn_for(buf.shape, wire, wrap)(buf)
        else:
            codes, quals, lens, valid = pack_block(
                block, max_len=lmax,
                pad_reads_to=bucket_rows(n, self.batch_reads),
            )
            out = self._fn_for(codes.shape, None, lambda f: f)(
                codes, quals, lens, valid
            )
        return jax.tree_util.tree_map(lambda x: np.asarray(x)[:n], out)


class ShapeCachedPairFn(ShapeCachedFn):
    """Fused paired dispatch: BOTH mates' batches in ONE jitted call.

    ``build_fn()`` must return ``fn(c1, q1, l1, v1, c2, q2, l2, v2)``.
    Paired filter/edit previously paid two serialized device round-trips
    per batch (pack+H2D+dispatch+D2H each); the pair rides one call — the
    same reshaping that fused paired stats
    (``make_paired_stats_step``).  Mates share one (rows, wire-width)
    shape, like :class:`PairedStatsSession`."""

    def __call__(self, b1, b2):
        n = b1.num_reads  # == b2.num_reads (lockstep pair slices)
        lmax = round_up(max(b1.max_len(), b2.max_len(), 1), 128)
        rows = bucket_rows(n, self.batch_reads)
        wire, unf = self._resolved_wire()
        if unf is not None:
            from ..io.packer import pack_block_wire

            wl = wire_len(max(b1.max_len(), b2.max_len()), lmax)
            in1 = in2 = None
            two_c = False
            if wire == "qn8" and self._pal_miss < self._PAL_MISS_LIMIT:
                # narrow-tier preference (see ShapeCachedFn.__call__) —
                # both mates must fit the SAME tier: 2c first (exact
                # codes + exception sidecars), else the 2q palette
                from ..io.packer import (
                    try_pack_block_2c,
                    try_pack_block_palette,
                )

                in1 = try_pack_block_2c(b1, wl, pad_reads_to=rows)
                in2 = (try_pack_block_2c(b2, wl, pad_reads_to=rows)
                       if in1 is not None else None)
                if in2 is not None:
                    two_c = True
                else:
                    in1 = try_pack_block_palette(b1, wl, pad_reads_to=rows)
                    in2 = (try_pack_block_palette(b2, wl, pad_reads_to=rows)
                           if in1 is not None else None)
                if in2 is not None:
                    from ..kernels.stats_jnp import wire_unbits

                    wire, unf = "bitpack", wire_unbits
                    self._pal_miss = 0
                else:
                    in1 = in2 = None
                    self._pal_miss += 1
            if in1 is None:
                a6 = wire == "bitpack"
                in1 = pack_block_wire(b1, wire, wl, pad_reads_to=rows,
                                      allow6=a6)
                in2 = pack_block_wire(b2, wire, wl, pad_reads_to=rows,
                                      allow6=a6)
            if two_c:
                from ..kernels.stats_jnp import wire_unbits2c

                wrap2 = lambda inner: (  # noqa: E731
                    lambda a1, e1, a2, e2: inner(*wire_unbits2c(a1, e1),
                                                 *wire_unbits2c(a2, e2)))
                out = self._fn_for(
                    (in1[0].shape, in1[1].shape, in2[0].shape,
                     in2[1].shape), "bitpack2c", wrap2)(*in1, *in2)
            else:
                wrap = lambda inner: (  # noqa: E731
                    lambda a, b: inner(*unf(a), *unf(b)))
                out = self._fn_for(in1.shape, wire, wrap)(in1, in2)
        else:
            p1 = pack_block(b1, max_len=lmax, pad_reads_to=rows)
            p2 = pack_block(b2, max_len=lmax, pad_reads_to=rows)
            out = self._fn_for(p1[0].shape, None, lambda f: f)(*p1, *p2)
        import jax

        return jax.tree_util.tree_map(lambda x: np.asarray(x)[:n], out)
