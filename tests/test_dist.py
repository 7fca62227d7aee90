"""Multi-device tests on the 8-device CPU mesh: sharded accumulation equals
single-device results; byte-range shard-merge invariance (SURVEY §4)."""

import jax
import numpy as np
import pytest
from jax.sharding import NamedSharding, PartitionSpec as P

from hpgq.core.accumulator import DeviceAccumulator
from hpgq.core.counters import StatsCounters
from hpgq.dist.mesh import (
    data_mesh,
    make_sharded_stats_step,
    sharded_counters,
    split_byte_ranges,
    zero_sharded_partials,
)
from hpgq.io import FastqReader, pack_block
from hpgq.options import FilterCriteria
from hpgq.oracle import spec

from gen import make_fastq

CRIT = FilterCriteria(min_read_quality=20, max_read_quality=40, max_N=2)


def _packed(tmp_path, n=512, **kw):
    path = str(tmp_path / "a.fq")
    make_fastq(path, n, **kw)
    with FastqReader(path, batch_size=10**9) as rd:
        (block,) = list(rd)
    return path, pack_block(block, pad_reads_to=n)


@pytest.mark.parametrize("with_filter", [False, True])
def test_sharded_equals_single_device(tmp_path, with_filter):
    path, (codes, quals, lens, valid) = _packed(
        tmp_path, min_len=30, max_len=60, n_prob=0.02, seed=51
    )
    lcap = codes.shape[1]
    crit = CRIT if with_filter else None
    mesh = data_mesh()
    ndev = mesh.devices.size
    assert ndev == 8

    sharding = NamedSharding(mesh, P("data"))
    batch = [jax.device_put(x, sharding) for x in (codes, quals, lens, valid)]
    acc = zero_sharded_partials(mesh, lcap)
    step = make_sharded_stats_step(mesh, lcap, phred=33, crit=crit)
    acc = step(acc, *batch)
    got = sharded_counters(acc, mesh, lcap, phred=33)
    got.filter_on = with_filter

    single = DeviceAccumulator(lcap, phred=33, crit=crit, batch_reads=512)
    single.update(codes, quals, lens, valid)
    ref = single.finish()
    assert got.equals(ref)
    assert got.num_passed == ref.num_passed
    assert got.num_failed == ref.num_failed


def test_byte_range_shard_invariance(tmp_path):
    """stats(file) == merge(stats(byte-range shard_i)) for any sharding."""
    path = str(tmp_path / "a.fq")
    make_fastq(path, 1001, min_len=30, max_len=70, n_prob=0.02, seed=52)

    whole = spec.stats_of_file(spec.iter_seq_qual(path))

    for n_shards in (2, 5):
        ranges = split_byte_ranges(path, n_shards)
        assert ranges[0][0] == 0
        merged = StatsCounters()
        total = 0
        for start, end in ranges:
            part = StatsCounters()
            with FastqReader(path, batch_size=100,
                             start_offset=start, end_offset=end) as rd:
                for block in rd:
                    total += block.num_reads
                    for i in range(block.num_reads):
                        spec.accumulate_read(part, block.sequence(i), block.quality(i))
            merged.merge(part)
        assert total == 1001
        assert merged.equals(whole)


def test_split_ranges_cover_and_align(tmp_path):
    path = str(tmp_path / "a.fq")
    make_fastq(path, 100, min_len=20, max_len=40, seed=53)
    import os

    size = os.path.getsize(path)
    ranges = split_byte_ranges(path, 4)
    assert ranges[0][0] == 0 and ranges[-1][1] == size
    for (s0, e0), (s1, e1) in zip(ranges, ranges[1:]):
        assert e0 == s1
    with open(path, "rb") as f:
        for s, e in ranges:
            if s < size and s > 0:
                f.seek(s)
                assert f.readline().startswith(b"@")


def test_graft_entry_single():
    import importlib.util, os

    spec_ = importlib.util.spec_from_file_location(
        "__graft_entry__",
        os.path.join(os.path.dirname(__file__), "..", "__graft_entry__.py"),
    )
    mod = importlib.util.module_from_spec(spec_)
    spec_.loader.exec_module(mod)
    fn, args = mod.entry()
    out = jax.jit(fn)(*args)
    assert int(out["num_reads"]) >= 0

    mod.dryrun_multichip(8)


def test_run_stats_sharded_pipeline(tmp_path):
    """End-to-end sharded pipeline == single-device pipeline (+ report)."""
    import os

    from hpgq.dist.run_dist import run_stats_sharded
    from hpgq.options import StatsOptions
    from hpgq.pipeline.run import run_stats

    fq = str(tmp_path / "in.fq")
    make_fastq(fq, 3000, min_len=40, max_len=120, n_prob=0.01, seed=9)

    def opts(out):
        o = StatsOptions()
        o.in_filename = fq
        o.out_dirname = str(out)
        o.quality_encoding_value = 33
        o.quality_encoding_name = "phred33"
        o.batch_size = 700
        return o

    out_a, out_b = tmp_path / "a", tmp_path / "b"
    out_a.mkdir(); out_b.mkdir()
    single = run_stats(opts(out_a))
    sharded = run_stats_sharded(opts(out_b))
    assert sharded.equals(single)
    assert (out_b / "in.fq.summary.txt").read_bytes() == (
        out_a / "in.fq.summary.txt"
    ).read_bytes()


def test_run_stats_sharded_through_wire(tmp_path, monkeypatch):
    """Sharded pipeline with the wire-buffer step (one global uint8 array
    per batch, per-device decode inside shard_map) == plain sharded run,
    incl. the pair-consistent paired path (host wire-encode)."""
    import dataclasses

    from hpgq.dist.run_dist import run_stats_sharded
    from hpgq.options import StatsOptions

    f1 = str(tmp_path / "w1.fq")
    f2 = str(tmp_path / "w2.fq")
    make_fastq(f1, 2000, min_len=40, max_len=120, n_prob=0.01, seed=61)
    make_fastq(f2, 2000, min_len=40, max_len=120, n_prob=0.01, seed=62)

    def opts(out, paired=False, flt=False):
        o = StatsOptions()
        o.in_filename = f1
        if paired:
            o.in_filename2 = f2
        o.out_dirname = str(out)
        o.quality_encoding_value = 33
        o.quality_encoding_name = "phred33"
        o.batch_size = 600
        if flt:
            o.criteria = dataclasses.replace(CRIT)
            o.filter_on = True
        return o

    for kw in ({}, {"flt": True}, {"paired": True, "flt": True}):
        a, b = tmp_path / ("wa%s" % kw), tmp_path / ("wb%s" % kw)
        a.mkdir(), b.mkdir()
        monkeypatch.setenv("HPGQ_WIRE", "off")
        plain = run_stats_sharded(opts(a, **kw))
        monkeypatch.setenv("HPGQ_WIRE", "bitpack")
        wired = run_stats_sharded(opts(b, **kw))
        monkeypatch.delenv("HPGQ_WIRE")
        if kw.get("paired"):
            assert wired[0].equals(plain[0]) and wired[1].equals(plain[1]), kw
        else:
            assert wired.equals(plain), kw


def test_sharded_wire_tiers(tmp_path, monkeypatch):
    """Adaptive bitpack tiers in the sharded sessions:
    binned quals ride the 2q palette tier, unbinned the 6-bit tier, and a
    mixed corpus escalates mid-run (different wire widths across steps)
    — every variant must equal the wire-off sharded run on the 8-device
    mesh.  Covers stats (filtered) and CGR."""
    import dataclasses

    from hpgq.dist.run_dist import run_cgr_sharded, run_stats_sharded
    from hpgq.options import CgrOptions, StatsOptions

    binned = str(tmp_path / "b.fq")
    plain = str(tmp_path / "p.fq")
    mixed = str(tmp_path / "m.fq")
    make_fastq(binned, 1500, min_len=40, max_len=120, n_prob=0.01, seed=63,
               qual_bins=(2, 12, 23, 37))
    make_fastq(plain, 1500, min_len=40, max_len=120, n_prob=0.01, seed=64)
    with open(mixed, "wb") as f:
        f.write(open(binned, "rb").read())
        f.write(open(plain, "rb").read())

    def sopts(fq, out):
        o = StatsOptions()
        o.in_filename = fq
        o.out_dirname = str(out)
        o.quality_encoding_value = 33
        o.quality_encoding_name = "phred33"
        o.batch_size = 500
        o.criteria = dataclasses.replace(CRIT)
        o.filter_on = True
        return o

    for i, fq in enumerate((binned, plain, mixed)):
        a, b = tmp_path / ("ta%d" % i), tmp_path / ("tb%d" % i)
        a.mkdir(), b.mkdir()
        monkeypatch.setenv("HPGQ_WIRE", "off")
        ref = run_stats_sharded(sopts(fq, a))
        monkeypatch.setenv("HPGQ_WIRE", "bitpack")
        got = run_stats_sharded(sopts(fq, b))
        monkeypatch.delenv("HPGQ_WIRE")
        assert got.equals(ref), fq

    def copts(fq, out):
        o = CgrOptions()
        o.in_filename = fq
        o.out_dirname = str(out)
        o.quality_encoding_value = 33
        o.quality_encoding_name = "phred33"
        o.batch_size = 500
        o.k = 4
        o.write_gs = True
        return o

    a, b = tmp_path / "ca", tmp_path / "cb"
    a.mkdir(), b.mkdir()
    monkeypatch.setenv("HPGQ_WIRE", "off")
    r0 = run_cgr_sharded(copts(mixed, a))
    monkeypatch.setenv("HPGQ_WIRE", "bitpack")
    r1 = run_cgr_sharded(copts(mixed, b))
    monkeypatch.delenv("HPGQ_WIRE")
    assert r0["fq_word_count"] == r1["fq_word_count"]
    name = "m.fq_k=4.gs"
    assert (a / name).read_bytes() == (b / name).read_bytes()

    # fused sharded-PAIRED with per-step shared-mate tier votes: mixed
    # (binned+unbinned) mate 1 + binned mate 2 forces cross-mate tier
    # reconciliation
    mate2 = str(tmp_path / "m2.fq")
    make_fastq(mate2, 3000, min_len=40, max_len=120, n_prob=0.01, seed=65,
               qual_bins=(2, 12, 23, 37))
    mixed3k = str(tmp_path / "m1.fq")
    with open(mixed3k, "wb") as f:
        f.write(open(mixed, "rb").read())  # 3000 reads, binned+unbinned

    def popts(out):
        o = sopts(mixed3k, out)
        o.in_filename2 = mate2
        return o

    pa, pb = tmp_path / "pa", tmp_path / "pb"
    pa.mkdir(), pb.mkdir()
    monkeypatch.setenv("HPGQ_WIRE", "off")
    ra = run_stats_sharded(popts(pa))
    monkeypatch.setenv("HPGQ_WIRE", "bitpack")
    rb = run_stats_sharded(popts(pb))
    monkeypatch.delenv("HPGQ_WIRE")
    assert rb[0].equals(ra[0]) and rb[1].equals(ra[1])


def test_tier_vote_monotone_under_max(tmp_path, monkeypatch):
    """The tier vote is element-wise MAX, so a rank may only vote a tier
    whose every wider tier also fits its block.  Tier 0 (<= 4 distinct
    quals) does NOT imply tier 1 (range < 64): quals {2, 70} fit the
    palette but not the 6-bit rebase — in multihost mode such a block
    must vote 2, or a peer voting 1 would force a failing repack and
    crash the session (round-4 review finding)."""
    import hpgq.dist.run_dist as rd
    from hpgq.dist.mesh import data_mesh
    from hpgq.io.fastq import FastqReader
    from hpgq.io.packer import pack_block_bitwire_tier, wire_len

    fq = str(tmp_path / "wide.fq")
    seq = b"ACGT" * 25
    q = (chr(33 + 2) * 50 + chr(33 + 70) * 50).encode()
    with open(fq, "wb") as f:
        for i in range(64):
            f.write(b"@r%d\n%s\n+\n%s\n" % (i, seq, q))

    monkeypatch.setenv("HPGQ_WIRE", "bitpack")
    sess = rd.ShardedStatsSession(data_mesh(), 33, batch_reads=16384)
    assert sess._tiered
    with FastqReader(fq, batch_size=1024) as r:
        block = next(iter(r))
    wl = wire_len(block.max_len(), 128)

    # sanity: the lattice really is non-monotone for this block
    assert pack_block_bitwire_tier(block, wl, 0) is not None
    assert pack_block_bitwire_tier(block, wl, 1) is None
    assert pack_block_bitwire_tier(block, wl, -1) is not None  # N-free

    # single-process: local tier is used directly — 2c fits (N-free
    # rows + 2-distinct palette), the narrowest tier of the ladder
    shape = sess.local_shape(block)
    assert shape[3] == -1

    # multihost: must vote a max-safe tier (2)
    sess2 = rd.ShardedStatsSession(data_mesh(), 33, batch_reads=16384)
    monkeypatch.setattr(rd.jax, "process_count", lambda: 2)
    shape = sess2.local_shape(block)
    assert shape[3] == 2
    # and the cached probe buffer matches the voted tier
    assert sess2._probe[1][0] == 2
    sess2.feed_block(block, shape=(shape[0], shape[1], shape[2], 2))


def test_paired_cross_mate_tier_monotone(tmp_path, monkeypatch):
    """The cross-MATE tier max is a vote too: a mate whose quals fit the
    palette but span >= 64 (tier 0 fits, tier 1 does not) paired with a
    mate needing tier 1 must not force a failing tier-1 repack — even
    SINGLE-process, where the stats session's rank-vote guard is off
    (round-4 second-review crash finding)."""
    import numpy as np

    import hpgq.dist.run_dist as rd
    from hpgq.dist.run_dist import run_stats_sharded
    from hpgq.options import StatsOptions

    n = 256
    seq = b"ACGT" * 25
    q_wide = (chr(33 + 2) * 50 + chr(33 + 70) * 50).encode()  # 2 distinct
    rng = np.random.default_rng(9)
    m1 = str(tmp_path / "w1.fq")
    m2 = str(tmp_path / "w2.fq")
    with open(m1, "wb") as f:
        for i in range(n):
            f.write(b"@a%d\n%s\n+\n%s\n" % (i, seq, q_wide))
    with open(m2, "wb") as f:
        for i in range(n):
            q = bytes(33 + int(v) for v in rng.integers(2, 42, len(seq)))
            f.write(b"@a%d\n%s\n+\n%s\n" % (i, seq, q))

    def opts(out, a, b):
        o = StatsOptions()
        o.in_filename, o.in_filename2 = a, b
        o.out_dirname = str(out)
        o.quality_encoding_value = 33
        o.quality_encoding_name = "phred33"
        o.batch_size = 128
        return o

    for j, (a, b) in enumerate(((m1, m2), (m2, m1))):
        pa, pb = tmp_path / ("xa%d" % j), tmp_path / ("xb%d" % j)
        pa.mkdir(), pb.mkdir()
        monkeypatch.setenv("HPGQ_WIRE", "off")
        ra = run_stats_sharded(opts(pa, a, b))
        monkeypatch.setenv("HPGQ_WIRE", "bitpack")
        rb = run_stats_sharded(opts(pb, a, b))  # crashed before the fix
        monkeypatch.delenv("HPGQ_WIRE")
        assert rb[0].equals(ra[0]) and rb[1].equals(ra[1])


def test_split_paired_ranges_no_trailing_newline(tmp_path):
    """A mate file without the final trailing newline (legal; the reader
    compensates at EOF) must not lose its last record from the shard
    counts — mate-2 cuts would misalign and every paired consumer would
    raise a mismatched-record-count error."""
    import os as _os

    from hpgq.options import StatsOptions
    from hpgq.pipeline import run as run_mod

    f1 = str(tmp_path / "n1.fq")
    f2 = str(tmp_path / "n2.fq")
    make_fastq(f1, 101, min_len=40, max_len=80, seed=71)
    make_fastq(f2, 101, min_len=40, max_len=80, seed=72)
    for p in (f1, f2):
        data = open(p, "rb").read()
        open(p, "wb").write(data[:-1])  # strip final newline

    for n in (2, 3):
        o = StatsOptions()
        o.in_filename, o.in_filename2 = f1, f2
        o.out_dirname = str(tmp_path / ("nt%d" % n))
        _os.makedirs(o.out_dirname, exist_ok=True)
        o.quality_encoding_value = 33
        o.quality_encoding_name = "phred33"
        o.batch_size = 25
        _os.environ["HPGQ_READ_SHARDS"] = str(n)
        saved = run_mod._PARALLEL_MIN_BYTES
        run_mod._PARALLEL_MIN_BYTES = 1
        try:
            c1, c2 = run_mod.run_stats(o)  # must not raise mismatched-count
        finally:
            run_mod._PARALLEL_MIN_BYTES = saved
            del _os.environ["HPGQ_READ_SHARDS"]
        assert c1.num_reads == 101 and c2.num_reads == 101


def test_striped_blocks_partition(tmp_path):
    """Striping covers every block exactly once across stripes."""
    from hpgq.dist.run_dist import striped_blocks

    fq = str(tmp_path / "s.fq.gz")
    make_fastq(fq, 1000, min_len=50, max_len=50, seed=2)
    seen = []
    for stripe in range(3):
        with FastqReader(fq, batch_size=128) as rd:
            for b in striped_blocks(rd, stripe, 3):
                seen.append(b.num_reads)
    assert sum(seen) == 1000


def test_run_cgr_sharded_equals_local(tmp_path):
    from hpgq.dist.run_dist import run_cgr_sharded
    from hpgq.options import CgrOptions
    from hpgq.pipeline.cgr_run import run_cgr

    fq = str(tmp_path / "c.fq")
    make_fastq(fq, 1500, min_len=40, max_len=100, n_prob=0.02, seed=13)

    def opts(out):
        o = CgrOptions()
        o.in_filename = fq
        o.out_dirname = str(out)
        o.quality_encoding_value = 33
        o.quality_encoding_name = "phred33"
        o.batch_size = 333
        o.k = 4
        o.write_gs = True
        return o

    out_a, out_b = tmp_path / "a", tmp_path / "b"
    out_a.mkdir(); out_b.mkdir()
    local = run_cgr(opts(out_a))
    sharded = run_cgr_sharded(opts(out_b))
    assert sharded["fq_word_count"] == local["fq_word_count"]
    fa = (out_a / "c.fq_k=4_FG.pgm").read_bytes()
    fb = (out_b / "c.fq_k=4_FG.pgm").read_bytes()
    assert fa == fb
    qa = (out_a / "c.fq_k=4_QQ.pgm").read_bytes()
    qb = (out_b / "c.fq_k=4_QQ.pgm").read_bytes()
    assert qa == qb


def test_sharded_kmers(tmp_path):
    from hpgq.dist.run_dist import run_stats_sharded
    from hpgq.options import StatsOptions
    from hpgq.pipeline.run import run_stats

    fq = str(tmp_path / "k.fq")
    make_fastq(fq, 800, min_len=40, max_len=80, seed=33)

    def opts(out):
        o = StatsOptions()
        o.in_filename = fq
        o.out_dirname = str(out)
        o.quality_encoding_value = 33
        o.quality_encoding_name = "phred33"
        o.batch_size = 256
        o.kmers_on = True
        return o

    a, b = tmp_path / "a", tmp_path / "b"
    a.mkdir(); b.mkdir()
    single = run_stats(opts(a))
    sharded = run_stats_sharded(opts(b))
    assert sharded.equals(single)
    np.testing.assert_array_equal(sharded.kmer_counts, single.kmer_counts)
    assert (b / "k.fq.kmers.txt").read_bytes() == (a / "k.fq.kmers.txt").read_bytes()


def test_sharded_periodic_flush_equivalence(tmp_path, monkeypatch):
    """Forcing a device->host fold every batch changes nothing (the sharded
    session's int32-overflow protection is associative)."""
    from hpgq.dist import run_dist
    from hpgq.dist.run_dist import ShardedStatsSession

    fq = str(tmp_path / "f.fq")
    make_fastq(fq, 1200, min_len=40, max_len=90, n_prob=0.01, seed=44)

    def run(budget):
        monkeypatch.setattr(run_dist, "_FLUSH_BUDGET", budget)
        sess = ShardedStatsSession(data_mesh(), 33, crit=CRIT,
                                   batch_reads=256)
        folds = {"n": 0}
        real = sess._grow

        def counting_grow(lcap):
            folds["n"] += 1
            return real(lcap)

        sess._grow = counting_grow
        with FastqReader(fq, batch_size=256) as rd:
            for block in rd:
                sess.feed_block(block)
        return sess.finish(), folds["n"]

    a, folds_a = run(1)      # budget exhausted every batch -> fold per batch
    b, folds_b = run(1 << 62)  # never fold until finish
    assert folds_a >= 4 and folds_b == 0, (folds_a, folds_b)
    assert a.equals(b)
    assert a.num_passed == b.num_passed and a.num_failed == b.num_failed


def test_sharded_stats_resume(tmp_path):
    """Interrupted sharded run resumes from its checkpoint and matches the
    uninterrupted result byte-for-byte."""
    import os

    from hpgq.dist import run_dist
    from hpgq.dist.run_dist import run_stats_sharded
    from hpgq.options import StatsOptions

    fq = str(tmp_path / "r.fq")
    make_fastq(fq, 2500, min_len=40, max_len=100, n_prob=0.01, seed=55)

    def opts(out, **kw):
        o = StatsOptions()
        o.in_filename = fq
        o.out_dirname = str(out)
        o.quality_encoding_value = 33
        o.quality_encoding_name = "phred33"
        o.batch_size = 256
        for k, v in kw.items():
            setattr(o, k, v)
        return o

    out_a, out_b = tmp_path / "a", tmp_path / "b"
    out_a.mkdir(); out_b.mkdir()
    full = run_stats_sharded(opts(out_a))

    ck = str(tmp_path / "sh.ck.npz")
    ob = opts(out_b, checkpoint_path=ck, checkpoint_every=1)

    class Boom(Exception):
        pass

    real = run_dist.ShardedStatsSession.feed_block
    calls = {"n": 0}

    def limited(self, block, **kw):
        if calls["n"] >= 4:
            raise Boom()
        calls["n"] += 1
        return real(self, block, **kw)

    run_dist.ShardedStatsSession.feed_block = limited
    try:
        with pytest.raises(Boom):
            run_stats_sharded(ob)
    finally:
        run_dist.ShardedStatsSession.feed_block = real
    assert os.path.exists(ck + ".a") or os.path.exists(ck + ".b")

    resumed = run_stats_sharded(ob)
    assert not os.path.exists(ck + ".a") and not os.path.exists(ck + ".b")
    assert resumed.equals(full)
    assert (out_b / "r.fq.summary.txt").read_bytes() == (
        out_a / "r.fq.summary.txt"
    ).read_bytes()


def test_sharded_cgr_resume(tmp_path):
    import os

    from hpgq.dist import run_dist
    from hpgq.dist.run_dist import run_cgr_sharded
    from hpgq.options import CgrOptions

    fq = str(tmp_path / "cg.fq")
    make_fastq(fq, 1500, min_len=50, max_len=90, n_prob=0.02, seed=71)

    def opts(out, **kw):
        o = CgrOptions()
        o.in_filename = fq
        o.out_dirname = str(out)
        o.quality_encoding_value = 33
        o.quality_encoding_name = "phred33"
        o.batch_size = 200
        o.k = 4
        for k, v in kw.items():
            setattr(o, k, v)
        return o

    out_a, out_b = tmp_path / "a", tmp_path / "b"
    out_a.mkdir(); out_b.mkdir()
    full = run_cgr_sharded(opts(out_a))

    ck = str(tmp_path / "cg.ck.npz")
    ob = opts(out_b, checkpoint_path=ck, checkpoint_every=1)

    class Boom(Exception):
        pass

    real = run_dist.ShardedCgrSession.feed_packed
    calls = {"n": 0}

    def limited(self, *a):
        if calls["n"] >= 3:
            raise Boom()
        calls["n"] += 1
        return real(self, *a)

    run_dist.ShardedCgrSession.feed_packed = limited
    try:
        with pytest.raises(Boom):
            run_cgr_sharded(ob)
    finally:
        run_dist.ShardedCgrSession.feed_packed = real
    assert os.path.exists(ck + ".a") or os.path.exists(ck + ".b")

    res = run_cgr_sharded(ob)
    assert not os.path.exists(ck + ".a") and not os.path.exists(ck + ".b")
    assert res["fq_word_count"] == full["fq_word_count"]
    assert (out_b / "cg.fq_k=4_FG.pgm").read_bytes() == (
        out_a / "cg.fq_k=4_FG.pgm"
    ).read_bytes()


def test_sharded_wire_trim_with_growth(tmp_path, monkeypatch):
    """Trimmed wire columns + bucketed rows through shard_map survive a
    mid-stream lcap growth (128 -> 256) and match the untrimmed plain run."""
    from hpgq.dist.run_dist import run_stats_sharded
    from hpgq.options import StatsOptions

    # first blocks short (lcap 128, trimmed wl < 128), later reads long
    # (growth to 256 with wl 160)
    p = str(tmp_path / "g.fq")
    make_fastq(p, 1500, min_len=60, max_len=100, n_prob=0.01, seed=71)
    import io

    with open(p, "ab") as f:
        from gen import make_fastq as mk

        p2 = str(tmp_path / "tail.fq")
        mk(p2, 500, min_len=150, max_len=160, n_prob=0.01, seed=72)
        f.write(open(p2, "rb").read())

    def opts(out):
        o = StatsOptions()
        o.in_filename = p
        o.out_dirname = str(out)
        o.quality_encoding_value = 33
        o.quality_encoding_name = "phred33"
        o.batch_size = 400
        return o

    a, b = tmp_path / "ga", tmp_path / "gb"
    a.mkdir(), b.mkdir()
    monkeypatch.setenv("HPGQ_WIRE", "off")
    plain = run_stats_sharded(opts(a))
    monkeypatch.setenv("HPGQ_WIRE", "bitpack")
    wired = run_stats_sharded(opts(b))
    assert wired.equals(plain)


@pytest.mark.parametrize("wire", ["bitpack", "fused4"])
def test_sharded_cgr_wire_equivalence(tmp_path, monkeypatch, wire):
    """Sharded CGR over each wire format (trimmed voted shapes) produces
    the same tables/words as the arrays path and the local pipeline."""
    import numpy as np

    from hpgq.options import CgrOptions
    from hpgq.dist.run_dist import run_cgr_sharded
    from hpgq.pipeline.cgr_run import run_cgr

    fq = str(tmp_path / "cw.fq")
    make_fastq(fq, 1500, min_len=30, max_len=140, n_prob=0.02, seed=77)

    def opts(out):
        o = CgrOptions()
        o.in_filename = fq
        o.out_dirname = str(out)
        o.quality_encoding_value = 33
        o.quality_encoding_name = "phred33"
        o.batch_size = 400
        o.k = 4
        return o

    outs = [tmp_path / n for n in ("c_off", "c_bit", "c_ref")]
    for o in outs:
        o.mkdir()
    monkeypatch.setenv("HPGQ_WIRE", "off")
    plain = run_cgr_sharded(opts(outs[0]))
    monkeypatch.setenv("HPGQ_WIRE", wire)
    wired = run_cgr_sharded(opts(outs[1]))
    ref = run_cgr(opts(outs[2]))
    for got in (plain, wired):
        assert got["fq_word_count"] == ref["fq_word_count"]
        assert np.array_equal(got["table_seq"], ref["table_seq"])
        assert np.array_equal(got["table_q"], ref["table_q"])
    assert (outs[1] / "cw.fq_k=4_FG.pgm").read_bytes() == (
        outs[2] / "cw.fq_k=4_FG.pgm"
    ).read_bytes()


def test_sharded_paired_stats_resume(tmp_path):
    """Interrupted sharded PAIRED stats resumes from its rotating
    checkpoint (both mates' carries + both offsets + pass/fail tallies)
    and matches the uninterrupted run."""
    import os

    from hpgq.dist import run_dist
    from hpgq.dist.run_dist import run_stats_sharded
    from hpgq.options import StatsOptions

    import dataclasses

    f1 = str(tmp_path / "pr1.fq")
    f2 = str(tmp_path / "pr2.fq")
    make_fastq(f1, 2200, min_len=40, max_len=100, n_prob=0.01, seed=81)
    make_fastq(f2, 2200, min_len=35, max_len=110, n_prob=0.01, seed=82)

    def opts(out, **kw):
        o = StatsOptions()
        o.in_filename = f1
        o.in_filename2 = f2
        o.out_dirname = str(out)
        o.quality_encoding_value = 33
        o.quality_encoding_name = "phred33"
        o.batch_size = 250
        o.criteria = dataclasses.replace(CRIT)
        o.filter_on = True
        for k, v in kw.items():
            setattr(o, k, v)
        return o

    out_a, out_b = tmp_path / "pa", tmp_path / "pb"
    out_a.mkdir(); out_b.mkdir()
    fa1, fa2 = run_stats_sharded(opts(out_a))

    ck = str(tmp_path / "pp.ck.npz")
    ob = opts(out_b, checkpoint_path=ck, checkpoint_every=1)

    class Boom(Exception):
        pass

    real = run_dist.ShardedPairedStatsSession.feed_pair
    calls = {"n": 0}

    def limited(self, b1, b2, **kw):
        if calls["n"] >= 4:  # 1 fused step per pair -> >=4 checkpoints
            raise Boom()
        calls["n"] += 1
        return real(self, b1, b2, **kw)

    run_dist.ShardedPairedStatsSession.feed_pair = limited
    try:
        with pytest.raises(Boom):
            run_stats_sharded(ob)
    finally:
        run_dist.ShardedPairedStatsSession.feed_pair = real
    assert os.path.exists(ck + ".a") or os.path.exists(ck + ".b")

    r1, r2 = run_stats_sharded(ob)
    assert not os.path.exists(ck + ".a") and not os.path.exists(ck + ".b")
    assert r1.equals(fa1) and r2.equals(fa2)
    assert (r1.num_passed, r1.num_failed) == (fa1.num_passed, fa1.num_failed)
    name = os.path.basename(f1) + ".summary.txt"
    assert (out_b / name).read_bytes() == (out_a / name).read_bytes()
