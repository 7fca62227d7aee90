"""Device-side stats accumulation with overflow-safe host folding.

Device accumulators are int32 (x64 is off).  The host folds them
into the int64 :class:`~hpgq.core.counters.StatsCounters` every
``flush_every`` batches — chosen so no int32 counter can overflow within a
flush window (worst case is ``acc_length``/``qual_per_nt`` at
``reads_per_flush * Lcap * 126 < 2**31``).  This replaces the reference's
serial consumer thread (SURVEY §2.3 P5): merging is a vector add here and a
``psum``/host-sum across shards at the end of the run.
"""

from __future__ import annotations

import numpy as np
import jax

from ..constants import NUM_KMERS
from .counters import StatsCounters
from ..kernels.stats_jnp import (
    MIN_LENGTH_INIT,
    make_stats_step,
    wire_fuse,
    wire_pack4,
    zero_partials,
)


def resolve_wire(wire=None):
    """'bitpack' | 'fused4' | 'pack4' | None.  Auto: off (the packed
    arrays ship as they are).  Env override:
    HPGQ_WIRE=bitpack|fused4|pack4|off."""
    import os

    # precedence: explicit format > HPGQ_WIRE env > off
    # ('auto' — the DeviceAccumulator default — must NOT shadow the env)
    w = wire
    if w in (None, "auto"):
        w = os.environ.get("HPGQ_WIRE", "auto")
    if w in ("auto", "off", "none", ""):
        return None
    if w not in ("bitpack", "fused4", "pack4"):
        raise ValueError(
            "unknown wire format %r (valid: bitpack, fused4, pack4, off)" % w
        )
    return w


def safe_flush_every(batch_reads: int, lcap: int) -> int:
    """Max batches between flushes with no int32 overflow possible.

    Worst per-batch growth of any single int32 cell:
    - ``acc_length`` / ``base_totals``: <= batch_reads * lcap
    - ``qual_per_nt[p]`` / ``acc_quality`` keys: one read adds at most one
      quality byte (< 130) *per position*, i.e. <= batch_reads * 130 per cell
    - histograms / ``kmer_counts``: <= batch_reads * lcap
    so the bound is batch_reads * max(lcap, 130) — NOT their product (which
    would force a pipeline-stalling host sync every batch at large sizes).
    """
    per_batch = max(1, batch_reads) * max(lcap, 130)
    return max(1, (2**30) // per_batch)


class DeviceAccumulator:
    """Streaming stats accumulator: jitted device update + periodic host fold."""

    def __init__(
        self,
        lcap: int,
        phred: int,
        kmers_on: bool = False,
        crit=None,
        batch_reads: int = 16384,
        device=None,
        jit: bool = True,
        wire="auto",
    ):
        self.lcap = lcap
        self.phred = phred
        self.kmers_on = kmers_on
        self.filter_on = crit is not None
        self.device = device
        self.counters = StatsCounters(phred=phred, kmers_on=kmers_on)
        self.counters.filter_on = self.filter_on
        self.counters.ensure_length(lcap)
        self._crit = crit
        self.wire = resolve_wire(wire)
        self._step = make_stats_step(lcap, phred, kmers_on, crit, jit=jit,
                                     wire=self.wire)
        self._acc = zero_partials(lcap, kmers_on)
        if device is not None:
            self._acc = jax.device_put(self._acc, device)
        self.flush_every = safe_flush_every(batch_reads, lcap)
        self._since_flush = 0

    def update(self, codes, quals=None, lens=None, valid=None) -> None:
        """Feed one batch: either the four packed arrays, or — with the
        fused wire format — a single pre-fused buffer as ``codes`` (a
        ``(buf, exc)`` tuple for the 2c tier's exception sidecar)."""
        if self.wire == "bitpack" and isinstance(codes, tuple) \
                and quals is None:
            buf, exc = codes
            self._acc = self._step(self._acc, buf, exc)
            self._since_flush += 1
            if self._since_flush >= self.flush_every:
                self.flush()
            return
        if self.wire in ("fused4", "bitpack"):
            if quals is None:
                buf = codes
            elif self.wire == "fused4":
                buf = wire_fuse(np.asarray(codes), np.asarray(quals),
                                lens, valid)
            else:
                from ..io.packer import wire_bitpack_np

                buf = wire_bitpack_np(codes, quals, lens, valid)
            self._acc = self._step(self._acc, buf)
        else:
            if self.wire == "pack4" and codes.shape[1] == quals.shape[1]:
                codes = wire_pack4(np.asarray(codes))  # not pre-packed upstream
            self._acc = self._step(self._acc, codes, quals, lens, valid)
        self._since_flush += 1
        if self._since_flush >= self.flush_every:
            self.flush()

    def update_uniform(self, payload) -> None:
        """Feed one bitpack2u (uniform-tier) batch:
        ``(buf, exc, pal, n_valid, Lu)`` — the per-batch sidecar replaces
        the per-row wire tail (see ``stats_jnp.make_stats_step2u``)."""
        from ..kernels.stats_jnp import make_stats_step2u

        buf, exc, pal, n_valid, Lu = payload
        step = make_stats_step2u(self.lcap, self.phred, self.kmers_on,
                                 self._crit, Lu)
        self._acc = step(self._acc, buf, exc, pal, n_valid)
        self._since_flush += 1
        if self._since_flush >= self.flush_every:
            self.flush()

    def flush(self) -> None:
        if self._since_flush == 0:
            return
        host = jax.device_get(self._acc)
        fold_partials(self.counters, host)
        self._acc = zero_partials(self.lcap, self.kmers_on)
        if self.device is not None:
            self._acc = jax.device_put(self._acc, self.device)
        self._since_flush = 0

    def finish(self) -> StatsCounters:
        self.flush()
        return self.counters


def fold_partials(c: StatsCounters, host: dict) -> None:
    """Fold a host copy of the device partials pytree into int64 counters."""
    c.ensure_length(len(np.asarray(host["cov_per_nt"])))
    c.num_reads += int(host["num_reads"])
    c.num_passed += int(host.get("num_passed", 0))
    c.num_failed += int(host.get("num_failed", 0))
    c.acc_length += int(host["acc_length"])
    ml = int(host["min_length"])
    if ml != MIN_LENGTH_INIT:  # INIT sentinel = no valid read in this window
        c.min_length = min(c.min_length, ml)
    c.max_length = max(c.max_length, int(host["max_length"]))
    c.acc_quality += float(host["acc_quality"])
    bt = np.asarray(host["base_totals"], dtype=np.int64)
    c.num_As += int(bt[0])
    c.num_Cs += int(bt[1])
    c.num_Gs += int(bt[2])
    c.num_Ts += int(bt[3])
    c.num_Ns += int(bt[4])
    lh = np.asarray(host["length_hist"], dtype=np.int64)
    c.length_hist[: lh.shape[0]] += lh
    c.quality_hist += np.asarray(host["quality_hist"], dtype=np.int64)
    c.gc_hist += np.asarray(host["gc_hist"], dtype=np.int64)
    lcap = np.asarray(host["cov_per_nt"]).shape[0]
    c.count_quality_per_nt[:lcap] += np.asarray(host["cov_per_nt"], dtype=np.int64)
    c.acc_quality_per_nt[:lcap] += np.asarray(host["qual_per_nt"], dtype=np.int64)
    c.base_per_nt[:, :lcap] += np.asarray(host["base_per_nt"], dtype=np.int64)
    if "kmer_counts" in host:
        c.kmer_counts += np.asarray(host["kmer_counts"], dtype=np.int64)
        c.kmer_counts_by_pos[:, :lcap] += np.asarray(
            host["kmer_per_nt"], dtype=np.int64
        )
