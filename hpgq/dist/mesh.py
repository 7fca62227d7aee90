"""Distribution layer: 1-D data mesh, sharded stats step, collective merge.

The reference is single-node (SURVEY §2.3, §5: no MPI/NCCL anywhere); its
multi-device story is CUDA ``--gpu-num-devices`` (P3/P4) and its merge step
is a serial consumer thread (P5).  Here:

* reads are **data-parallel** over a 1-D ``('data',)`` mesh: each device gets
  a ``[B, L]`` shard of the packed batch (P4),
* each device accumulates its own partials locally inside ``shard_map`` —
  zero per-batch collectives,
* the merge is one ``psum``/``pmin``/``pmax`` at the end of the run (NCCL
  between the cards of one host)
  (P5 as a collective instead of a thread), and across hosts rides the same
  collective via ``jax.distributed``.

Multi-host input: each process reads its own byte range of the FASTQ file
(realigned to record boundaries) and writes its own output shard; the final
stats merge is the collective above.
"""

from __future__ import annotations

import os
from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..kernels import stats_jnp
from ..core.accumulator import fold_partials
from ..core.counters import StatsCounters

shard_map = jax.shard_map


def data_mesh(devices=None) -> Mesh:
    """1-D data-parallel mesh over all local (or given) devices."""
    devices = np.asarray(devices if devices is not None else jax.devices())
    return Mesh(devices, axis_names=("data",))


def initialize_distributed() -> int:
    """Multi-host bootstrap (jax.distributed) when launched under a
    coordinator (JAX_COORDINATOR_ADDRESS / COORDINATOR_ADDRESS); returns
    process_index.

    Must not query the backend before initialize(): any jax call that
    initializes XLA makes a later initialize() raise, so we attempt the
    bootstrap purely from the environment and tolerate 'already
    initialized' (the caller may have bootstrapped explicitly)."""
    if (
        "JAX_COORDINATOR_ADDRESS" in os.environ
        or "COORDINATOR_ADDRESS" in os.environ
    ):
        try:
            jax.distributed.initialize()
        except RuntimeError:
            pass  # already initialized (explicitly or backend already up)
    return jax.process_index()


# ---------------------------------------------------------------------------
# sharded accumulation
# ---------------------------------------------------------------------------

def zero_sharded_partials(mesh: Mesh, lcap: int, kmers_on: bool = False):
    """Per-device accumulator pytree: leaves [ndev, ...] sharded on axis 0."""
    ndev = mesh.devices.size
    base = stats_jnp.zero_partials(lcap, kmers_on)

    def expand(x):
        return jnp.broadcast_to(x[None], (ndev,) + x.shape)

    acc = jax.tree_util.tree_map(expand, base)
    sharding = NamedSharding(mesh, P("data"))
    return jax.device_put(acc, sharding)


_STEP_CACHE: dict = {}
_STEP_CACHE_MAX = 32  # bounds compiled-executable pinning (fuzz sweeps
# run hundreds of criteria configs; evict oldest — insertion order)


def _step_cache_put(key, value):
    while len(_STEP_CACHE) >= _STEP_CACHE_MAX:
        _STEP_CACHE.pop(next(iter(_STEP_CACHE)))
    _STEP_CACHE[key] = value


def _crit_cache_key(crit):
    import dataclasses

    return None if crit is None else dataclasses.astuple(crit)


def make_sharded_stats_step(
    mesh: Mesh,
    lcap: int,
    phred: int,
    kmers_on: bool = False,
    crit=None,
    donate: bool = True,
    wire=None,
):
    """Jitted SPMD stats update over the data mesh.

    acc leaves: [ndev, ...] sharded on 'data'; batch arrays: [ndev*B, L]
    sharded on 'data'.  Each device runs the same fused per-batch kernel on
    its shard and updates its own accumulator slice — no collectives in the
    steady state.

    ``wire='bitpack'``/``'fused4'``: the step takes ONE global uint8 wire
    buffer ``[ndev*B, W]`` sharded on 'data' and decodes per device inside
    shard_map — one host->device array per batch per host instead of four
    (same minimal-H2D design as the single-chip engine).

    Cached process-wide per full static config: a fresh ``jax.jit`` object
    per session would RE-TRACE the shard_map program on every pass
    (measured ~0.15-1 s per trace per rank on a 2-process CPU mesh in
    round 4 — it dominated the multihost per-pass cost).
    """
    ck = ("stats", mesh, lcap, phred, kmers_on, _crit_cache_key(crit),
          donate, wire)
    try:
        if ck in _STEP_CACHE:
            return _STEP_CACHE[ck]
    except TypeError:  # unhashable criteria subclass: build uncached
        ck = None
    step = stats_jnp.make_stats_step(lcap, phred, kmers_on, crit, jit=False,
                                     vary_axis="data")
    acc_spec = jax.tree_util.tree_map(lambda _: P("data"), stats_jnp.zero_partials(lcap, kmers_on))

    if wire == "bitpack2c":
        # 2c tier: the wire buffer travels with its per-device exception
        # sidecar ([ndev*Edev] int32, sharded on 'data' like the rows —
        # entries encode ((local_row * L + pos) << 1) | is_other, padded
        # with per-device OOB sentinels); the decode scatter-restores
        # exact codes per device (stats_jnp.wire_unbits2c)
        def device_fn(acc, buf, exc):
            inner = jax.tree_util.tree_map(lambda x: x[0], acc)
            c, q, l, v = stats_jnp.wire_unbits2c(buf, exc)
            c, q = stats_jnp.pad_wire_cols(c, q, lcap)
            out = step(inner, c, q, l, v)
            return jax.tree_util.tree_map(lambda x: x[None], out)

        fn = shard_map(
            device_fn,
            mesh=mesh,
            in_specs=(acc_spec, P("data"), P("data")),
            out_specs=acc_spec,
        )
        jfn = jax.jit(fn, donate_argnums=(0,) if donate else ())
        if ck is not None:
            _step_cache_put(ck, jfn)
        return jfn

    if wire in ("bitpack", "fused4"):
        unf = (stats_jnp.wire_unbits if wire == "bitpack"
               else stats_jnp.wire_unfuse)

        def device_fn(acc, buf):
            inner = jax.tree_util.tree_map(lambda x: x[0], acc)
            c, q, l, v = unf(buf)
            # single-process sessions trim the wire's length axis
            # (io.packer.wire_len); re-pad to the step's lcap on device
            c, q = stats_jnp.pad_wire_cols(c, q, lcap)
            out = step(inner, c, q, l, v)
            return jax.tree_util.tree_map(lambda x: x[None], out)

        fn = shard_map(
            device_fn,
            mesh=mesh,
            in_specs=(acc_spec, P("data")),
            out_specs=acc_spec,
        )
        jfn = jax.jit(fn, donate_argnums=(0,) if donate else ())
        if ck is not None:
            _step_cache_put(ck, jfn)
        return jfn

    def device_fn(acc, codes, quals, lens, valid):
        inner = jax.tree_util.tree_map(lambda x: x[0], acc)
        out = step(inner, codes, quals, lens, valid)
        return jax.tree_util.tree_map(lambda x: x[None], out)

    fn = shard_map(
        device_fn,
        mesh=mesh,
        in_specs=(acc_spec, P("data"), P("data"), P("data"), P("data")),
        out_specs=acc_spec,
    )
    jfn = jax.jit(fn, donate_argnums=(0,) if donate else ())
    if ck is not None:
        _step_cache_put(ck, jfn)
    return jfn


def make_sharded_paired_stats_step(
    mesh: Mesh,
    lcap: int,
    phred: int,
    kmers_on: bool = False,
    crit=None,
    donate: bool = True,
    wire=None,
):
    """Jitted SPMD paired-stats update over the data mesh: BOTH mates'
    pair-consistent verdicts + accumulation in ONE dispatch per step.

        step(acc1, acc2, in1, in2) -> (acc1', acc2')

    Each device runs the fused paired kernel
    (``stats_jnp.make_paired_stats_step``) on its shard of both mates — no
    steady-state collectives; pair pass/fail tallies accumulate in mate-1's
    device partials (num_passed/num_failed leaves), psum'd by the final
    collective merge.  Replaces the sharded-paired loop's 3 dispatches per
    step (pair verdict + one feed per mate).

    ``wire='bitpack'``/``'fused4'``: ``inN`` is one global uint8 wire
    buffer ``[ndev*B, W]`` sharded on 'data', decoded per device (wire
    columns may be trimmed; the paired step re-pads to lcap on device).
    Otherwise ``inN`` is the mate's plain (codes, quals, lens, valid)
    tuple, each sharded on 'data'.

    Cached process-wide like ``make_sharded_stats_step`` (re-trace per
    session was the dominant multihost per-pass cost)."""
    wire = wire if wire in ("bitpack", "fused4") else None
    ck = ("paired", mesh, lcap, phred, kmers_on, _crit_cache_key(crit),
          donate, wire)
    try:
        if ck in _STEP_CACHE:
            return _STEP_CACHE[ck]
    except TypeError:
        ck = None
    step = stats_jnp.make_paired_stats_step(
        lcap, phred, kmers_on, crit, jit=False, wire=wire, vary_axis="data"
    )
    acc_spec = jax.tree_util.tree_map(
        lambda _: P("data"), stats_jnp.zero_partials(lcap, kmers_on)
    )

    def device_fn(acc1, acc2, in1, in2):
        i1 = jax.tree_util.tree_map(lambda x: x[0], acc1)
        i2 = jax.tree_util.tree_map(lambda x: x[0], acc2)
        o1, o2 = step(i1, i2, in1, in2)
        return (jax.tree_util.tree_map(lambda x: x[None], o1),
                jax.tree_util.tree_map(lambda x: x[None], o2))

    batch_spec = P("data") if wire else (P("data"),) * 4
    fn = shard_map(
        device_fn,
        mesh=mesh,
        in_specs=(acc_spec, acc_spec, batch_spec, batch_spec),
        out_specs=(acc_spec, acc_spec),
    )
    jfn = jax.jit(fn, donate_argnums=(0, 1) if donate else ())
    if ck is not None:
        _step_cache_put(ck, jfn)
    return jfn


_MERGE_CACHE: dict = {}


def make_collective_merge(mesh: Mesh, lcap: int, kmers_on: bool = False):
    """psum/pmin/pmax the sharded accumulator into replicated totals —
    the reference's consumer merge (src/stats_fastq.c:257-417) as one
    collective.  Cached per (mesh, lcap, kmers_on) — rebuilt
    closures would retrace/recompile on every flush."""
    ck = (mesh, lcap, kmers_on)
    if ck in _MERGE_CACHE:
        return _MERGE_CACHE[ck]

    def device_fn(acc):
        def merge_leaf(path, x):
            name = path[-1].key if path else ""
            v = x[0]
            if name == "min_length":
                return jax.lax.pmin(v, "data")
            if name == "max_length":
                return jax.lax.pmax(v, "data")
            return jax.lax.psum(v, "data")

        return jax.tree_util.tree_map_with_path(merge_leaf, acc)

    acc_spec = jax.tree_util.tree_map(
        lambda _: P("data"), stats_jnp.zero_partials(lcap, kmers_on)
    )
    out_spec = jax.tree_util.tree_map(lambda _: P(), stats_jnp.zero_partials(lcap, kmers_on))
    fn = jax.jit(
        shard_map(device_fn, mesh=mesh, in_specs=(acc_spec,), out_specs=out_spec)
    )
    _MERGE_CACHE[ck] = fn
    return fn


def sharded_counters(
    acc, mesh: Mesh, lcap: int, phred: int, kmers_on: bool = False
) -> StatsCounters:
    """Collective-merge the sharded accumulator and fold into host counters."""
    merged = make_collective_merge(mesh, lcap, kmers_on)(acc)
    host = jax.device_get(merged)
    c = StatsCounters(phred=phred, kmers_on=kmers_on)
    c.ensure_length(lcap)
    fold_partials(c, host)
    return c


# ---------------------------------------------------------------------------
# multi-host input splitting
# ---------------------------------------------------------------------------

def _align_to_record(f, pos: int, scan_limit: int = 1 << 30) -> int:
    """Scan forward from byte ``pos`` to the next FASTQ record start.

    A '@' line is a record start iff the line 2 lines below starts with '+'
    (quality lines may begin with '@', so the lookahead disambiguates).
    ``scan_limit`` (1 GiB) only guards against scanning a non-FASTQ file
    forever — a shard boundary inside an ultra-long-read record must widen
    the scan past that record, so the limit sits far above any real read
    length.
    """
    if pos == 0:
        return 0
    f.seek(pos)
    f.readline()  # skip the (possibly partial) current line
    while True:
        start = f.tell()
        line = f.readline()
        if not line:
            return start
        if line.startswith(b"@"):
            after = f.tell()
            f.readline()  # sequence?
            plus = f.readline()
            if plus.startswith(b"+"):
                return start
            # '@' was a quality line (quality byte '@' = Q31 phred33);
            # resume scanning from the NEXT line, not past the lookahead —
            # otherwise real headers get swallowed and never found
            f.seek(after)
        if f.tell() - pos > scan_limit:
            raise ValueError("could not find a FASTQ record boundary")


def range_splittable(path: str) -> bool:
    """True when record-aligned byte ranges work: plain files, or BGZF
    (block-gzip: logical seek is cheap).  Plain gzip streams fall back to
    block striping (``hpgq.dist.run_dist.striped_blocks``)."""
    with open(path, "rb") as f:
        if f.read(2) != b"\x1f\x8b":
            return True
    from ..io.bgzf import is_bgzf

    return is_bgzf(path)


def _open_logical(path: str):
    """(file-like, logical_size) — BgzfFile for BGZF, plain file otherwise
    (offsets are decompressed-stream offsets either way)."""
    with open(path, "rb") as probe:
        gz = probe.read(2) == b"\x1f\x8b"
    if gz:
        from ..io.bgzf import BgzfFile

        f = BgzfFile(path)
        return f, f.logical_size
    f = open(path, "rb")
    return f, os.path.getsize(path)


def count_newlines_in_range(path: str, start: int, end: int) -> int:
    """Newlines in the logical byte range [start, end) — native memchr
    streaming scan (records are 4 lines, so record count = newlines // 4
    for record-aligned ranges)."""
    from ..io.fastq import _find_newlines

    f, _ = _open_logical(path)
    try:
        f.seek(start)
        total = 0
        left = end - start
        while left > 0:
            data = f.read(min(left, 16 << 20))
            if not data:
                break
            total += int(len(_find_newlines(data)))
            left -= len(data)
        return total
    finally:
        f.close()


def record_offsets(path: str, record_indices) -> "list[int]":
    """Logical byte offset of the start of each requested record (sorted
    ascending) via one streaming newline scan — used to map mate-1 shard
    record counts onto mate-2 byte ranges for paired sharding."""
    from ..io.fastq import _find_newlines

    want = sorted(int(r) for r in record_indices)
    out = {}
    for r in want:
        if r == 0:
            out[0] = 0
    remaining = [r for r in want if r != 0]
    if remaining:
        f, _ = _open_logical(path)
        try:
            nl_seen = 0
            base = 0
            ri = 0
            while ri < len(remaining):
                data = f.read(16 << 20)
                if not data:
                    # past EOF: offset = file end for any leftover indices
                    for r in remaining[ri:]:
                        out[r] = base
                    break
                nl = _find_newlines(data)
                while ri < len(remaining):
                    need = remaining[ri] * 4  # newline index ending rec-1
                    if need > nl_seen + len(nl):
                        break
                    out[remaining[ri]] = base + int(nl[need - nl_seen - 1]) + 1
                    ri += 1
                nl_seen += len(nl)
                base += len(data)
        finally:
            f.close()
    return [out[int(r)] for r in record_indices]


def split_paired_ranges(path1: str, path2: str, n_shards: int):
    """Record-count-aligned shard ranges for a mate pair:
    ``[((s1, e1), (s2, e2)), ...]`` such that shard i covers the SAME record
    indices in both files (mate files have equal record counts but different
    byte layouts, so mate-2 cuts come from record counting, not byte
    fractions).  Cost: one streaming newline scan of each file."""
    r1 = split_byte_ranges(path1, n_shards)
    counts = [count_newlines_in_range(path1, s, e) // 4 for s, e in r1]
    # a legal FASTQ may lack the final trailing newline (FastqReader
    # compensates at EOF): the last shard then sees 4N-1 newlines and
    # newlines//4 would drop its final record, misaligning every mate-2 cut
    f, size = _open_logical(path1)
    try:
        if size:
            f.seek(size - 1)
            if f.read(1) != b"\n":
                # credit the record to the last NONEMPTY shard (tiny files
                # can collapse trailing shards to empty (size, size) ranges)
                for i in range(n_shards - 1, -1, -1):
                    if r1[i][0] < r1[i][1]:
                        counts[i] += 1
                        break
    finally:
        f.close()
    prefix = [0]
    for c in counts:
        prefix.append(prefix[-1] + c)
    offs2 = record_offsets(path2, prefix)
    r2 = [(offs2[i], offs2[i + 1]) for i in range(n_shards)]
    return list(zip(r1, r2))


def split_byte_ranges(path: str, n_shards: int):
    """[(start, end)] record-aligned byte ranges covering a FASTQ file.

    Offsets are LOGICAL (decompressed) for BGZF inputs — each host then
    decompresses only its own blocks; plain gzip is not byte-seekable and
    uses striping instead (see ``range_splittable``).
    """
    with open(path, "rb") as probe:
        gz = probe.read(2) == b"\x1f\x8b"
    if gz:
        from ..io.bgzf import BgzfFile

        f = BgzfFile(path)
        size = f.logical_size
    else:
        f = open(path, "rb")
        size = os.path.getsize(path)
    try:
        cuts = [0]
        for i in range(1, n_shards):
            cuts.append(_align_to_record(f, size * i // n_shards))
        cuts.append(size)
    finally:
        f.close()
    # ensure monotonicity (tiny files may collapse some shards to empty)
    for i in range(1, len(cuts)):
        cuts[i] = max(cuts[i], cuts[i - 1])
    return [(cuts[i], cuts[i + 1]) for i in range(n_shards)]
