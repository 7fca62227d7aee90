"""Differential tests: jnp engine kernels vs numpy baseline / oracle spec."""

import numpy as np
import pytest

from hpgq.core.accumulator import DeviceAccumulator
from hpgq.io import FastqReader, pack_block
from hpgq.kernels import stats_jnp
from hpgq.options import FilterCriteria
from hpgq.oracle import baseline, spec

from gen import make_fastq

CRIT = FilterCriteria(
    min_read_length=20,
    max_read_length=80,
    min_read_quality=20,
    max_read_quality=40,
    max_out_of_quality=30,
    left_length=10,
    min_left_quality=15,
    max_left_quality=45,
    right_length=8,
    min_right_quality=10,
    max_right_quality=60,
    max_N=2,
)


def _load(tmp_path, n=400, **kw):
    path = str(tmp_path / "a.fq")
    make_fastq(path, n, **kw)
    with FastqReader(path, batch_size=10**9) as rd:
        (block,) = list(rd)
    pairs = [(block.sequence(i), block.quality(i)) for i in range(block.num_reads)]
    return pairs, pack_block(block, pad_reads_to=512)


@pytest.mark.parametrize("kmers_on", [False, True])
def test_stats_accumulator_matches_spec(tmp_path, kmers_on):
    pairs, (codes, quals, lens, valid) = _load(
        tmp_path, min_len=8, max_len=70, n_prob=0.03, seed=31, lowercase_prob=0.05
    )
    lcap = codes.shape[1]
    acc = DeviceAccumulator(lcap, phred=33, kmers_on=kmers_on, batch_reads=512)
    # two chunks to exercise merge
    h = codes.shape[0] // 2
    acc.update(codes[:h], quals[:h], lens[:h], valid[:h])
    acc.update(codes[h:], quals[h:], lens[h:], valid[h:])
    got = acc.finish()
    ref = spec.stats_of_file(pairs, kmers_on=kmers_on)
    assert got.equals(ref)


def test_stats_with_inline_filter(tmp_path):
    pairs, (codes, quals, lens, valid) = _load(
        tmp_path, min_len=8, max_len=90, n_prob=0.03, seed=32
    )
    lcap = codes.shape[1]
    acc = DeviceAccumulator(lcap, phred=33, crit=CRIT, batch_reads=512)
    acc.update(codes, quals, lens, valid)
    got = acc.finish()
    ref = spec.stats_of_file(pairs, criteria=CRIT)
    assert got.equals(ref)
    assert got.num_passed == ref.num_passed
    assert got.num_failed == ref.num_failed
    assert 0 < got.num_passed < len(pairs)


def test_verdicts_vs_baseline(tmp_path):
    pairs, (codes, quals, lens, valid) = _load(
        tmp_path, min_len=8, max_len=90, n_prob=0.05, seed=33
    )
    ref = baseline.block_verdicts(codes, quals, lens, CRIT)
    got = np.asarray(stats_jnp.verdicts(codes, quals, lens, CRIT))
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("begin,end", [(10, 40), (0, 25), (30, 1024),
                                       (150, 1024), (20, 20)])
def test_quality_window_verdicts(tmp_path, begin, end):
    """[D8] legacy --start/--end-quality-nt window: jnp verdicts == numpy
    baseline == per-read oracle, including empty/degenerate windows
    (window beyond the read, zero width)."""
    import dataclasses

    pairs, (codes, quals, lens, valid) = _load(
        tmp_path, min_len=8, max_len=90, n_prob=0.05, seed=35
    )
    crit = dataclasses.replace(CRIT, begin_quality_nt=begin,
                               end_quality_nt=end)
    ref = baseline.block_verdicts(codes, quals, lens, crit)
    got = np.asarray(stats_jnp.verdicts(codes, quals, lens, crit))
    np.testing.assert_array_equal(got, ref)
    scrit = crit.substituted()
    want = np.array([spec.filter_verdict(s, q, scrit) for s, q in pairs])
    np.testing.assert_array_equal(got[: len(pairs)], want)
    if begin == 10 and end == 40:
        # the window must actually change some verdicts vs whole-read
        whole = np.asarray(stats_jnp.verdicts(codes, quals, lens, CRIT))
        assert (got[: len(pairs)] != whole[: len(pairs)]).any()


def test_quality_window_negative_begin_clamped():
    """A negative begin (library API — the CLI refuses it) is clamped to 0
    by substituted(): the oracle's python slice would otherwise read from
    the END of the read while the mask kernels read position 0."""
    import dataclasses

    crit = dataclasses.replace(CRIT, begin_quality_nt=-5, end_quality_nt=40)
    sub = crit.substituted()
    assert (sub.begin_quality_nt, sub.end_quality_nt) == (0, 40)
    assert sub.quality_window_on


def test_trims_vs_baseline(tmp_path):
    pairs, (codes, quals, lens, valid) = _load(
        tmp_path, min_len=5, max_len=60, seed=34
    )
    crit = FilterCriteria(
        left_length=12, min_left_quality=22, max_left_quality=90,
        right_length=6, min_right_quality=25, max_right_quality=90,
    )
    rl, rr = baseline.block_trims(quals, lens, crit)
    gl, gr = stats_jnp.trims(quals, lens, crit)
    np.testing.assert_array_equal(np.asarray(gl), rl)
    np.testing.assert_array_equal(np.asarray(gr), rr)
    assert rl.sum() > 0 and rr.sum() > 0


def test_apply_trims_and_restats(tmp_path):
    """Edit path: trim on device then re-stats matches oracle on trimmed reads."""
    pairs, (codes, quals, lens, valid) = _load(
        tmp_path, min_len=10, max_len=50, seed=35
    )
    crit = FilterCriteria(
        left_length=5, min_left_quality=25, max_left_quality=90,
        right_length=5, min_right_quality=25, max_right_quality=90,
    )
    sub = crit.substituted()
    lt, rt = stats_jnp.trims(quals, lens, crit)
    nc, nq, nl = stats_jnp.apply_trims(codes, quals, lens.astype(np.int32),
                                       np.asarray(lt), np.asarray(rt))
    lcap = codes.shape[1]
    acc = DeviceAccumulator(lcap, phred=33, batch_reads=512)
    acc.update(np.asarray(nc), np.asarray(nq), np.asarray(nl), valid)
    got = acc.finish()

    trimmed_pairs = []
    for s, q in pairs:
        a, b = spec.trim_lengths(s, q, sub)
        trimmed_pairs.append((s[a : len(s) - b], q[a : len(q) - b]))
    ref = spec.stats_of_file(trimmed_pairs)
    assert got.equals(ref)


def test_flush_interval_invariance(tmp_path):
    pairs, (codes, quals, lens, valid) = _load(
        tmp_path, min_len=8, max_len=40, seed=36
    )
    lcap = codes.shape[1]
    a1 = DeviceAccumulator(lcap, phred=33, batch_reads=512)
    a1.flush_every = 1
    a2 = DeviceAccumulator(lcap, phred=33, batch_reads=512)
    a2.flush_every = 1000
    for lo in range(0, codes.shape[0], 128):
        sl = slice(lo, lo + 128)
        a1.update(codes[sl], quals[sl], lens[sl], valid[sl])
        a2.update(codes[sl], quals[sl], lens[sl], valid[sl])
    c1, c2 = a1.finish(), a2.finish()
    assert c1.equals(c2)


def test_wire_pack4_roundtrip_and_step():
    import numpy as np
    import jax.numpy as jnp

    from hpgq.kernels import stats_jnp
    from hpgq.core.accumulator import DeviceAccumulator

    rng = np.random.default_rng(5)
    codes = rng.integers(0, 6, size=(64, 128)).astype(np.int8)
    packed = stats_jnp.wire_pack4(codes)
    assert packed.shape == (64, 64)
    un = np.asarray(stats_jnp.wire_unpack4(jnp.asarray(packed)))
    np.testing.assert_array_equal(un, codes)

    # full step through the wire format == plain step
    lens = rng.integers(1, 129, size=64).astype(np.int32)
    pos = np.arange(128)[None, :]
    codes = np.where(pos < lens[:, None], codes, np.int8(5))
    quals = np.where(pos < lens[:, None],
                     rng.integers(33, 74, size=(64, 128)), 0).astype(np.uint8)
    valid = np.ones(64, bool)

    plain = DeviceAccumulator(128, 33, wire="off")
    wired = DeviceAccumulator(128, 33, wire="pack4")
    plain.update(codes, quals, lens, valid)
    wired.update(codes, quals, lens, valid)
    assert wired.finish().equals(plain.finish())


def test_long_read_growth_and_engine_guard(tmp_path):
    """A 6000-bp read grows the session's length bucket mid-run; the
    rebuilt step stays correct."""
    import numpy as np

    from gen import make_records, write_fastq
    from hpgq.oracle import spec
    from hpgq.options import StatsOptions
    from hpgq.pipeline.run import run_stats

    recs = make_records(50, min_len=60, max_len=100, seed=1)
    long_seq = b"ACGT" * 1500
    recs.append((b"@long read", long_seq, b"I" * len(long_seq)))
    recs += make_records(20, min_len=80, max_len=80, seed=2)
    fq = str(tmp_path / "long.fq")
    write_fastq(fq, recs)

    o = StatsOptions()
    o.in_filename = fq
    o.out_dirname = str(tmp_path)
    o.quality_encoding_value = 33
    o.quality_encoding_name = "phred33"
    o.batch_size = 16
    got = run_stats(o)
    want = spec.stats_of_file(spec.iter_seq_qual(fq))
    assert got.equals(want)
    assert got.max_length == 6000


def test_wire_fused4_roundtrip_and_step():
    import numpy as np
    import jax.numpy as jnp

    from hpgq.kernels import stats_jnp
    from hpgq.core.accumulator import DeviceAccumulator

    rng = np.random.default_rng(6)
    lens = rng.integers(1, 129, size=64).astype(np.int32)
    pos = np.arange(128)[None, :]
    codes = np.where(pos < lens[:, None],
                     rng.integers(0, 6, size=(64, 128)), 5).astype(np.int8)
    quals = np.where(pos < lens[:, None],
                     rng.integers(33, 74, size=(64, 128)), 0).astype(np.uint8)
    valid = rng.random(64) < 0.9

    buf = stats_jnp.wire_fuse(codes, quals, lens, valid)
    assert buf.shape == (64, 64 + 128 + 8)
    c2, q2, l2, v2 = (np.asarray(x) for x in
                      stats_jnp.wire_unfuse(jnp.asarray(buf)))
    np.testing.assert_array_equal(c2, codes)
    np.testing.assert_array_equal(q2, quals)
    np.testing.assert_array_equal(l2, lens)
    np.testing.assert_array_equal(v2, valid)

    plain = DeviceAccumulator(128, 33, wire="off")
    fused = DeviceAccumulator(128, 33, wire="fused4")
    plain.update(codes, quals, lens, valid)
    fused.update(codes, quals, lens, valid)   # host-side fuse path
    fused2 = DeviceAccumulator(128, 33, wire="fused4")
    fused2.update(jnp.asarray(buf))           # pre-fused single-buffer path
    ref = plain.finish()
    assert fused.finish().equals(ref)
    assert fused2.finish().equals(ref)


def test_wire_bitpack_roundtrip_and_step():
    import numpy as np
    import jax.numpy as jnp

    from hpgq.io.packer import wire_bitpack_np
    from hpgq.kernels import stats_jnp
    from hpgq.core.accumulator import DeviceAccumulator

    rng = np.random.default_rng(7)
    lens = rng.integers(1, 129, size=64).astype(np.int32)
    pos = np.arange(128)[None, :]
    codes = np.where(pos < lens[:, None],
                     rng.integers(0, 6, size=(64, 128)), 5).astype(np.int8)
    quals = np.where(pos < lens[:, None],
                     rng.integers(33, 74, size=(64, 128)), 0).astype(np.uint8)
    valid = rng.random(64) < 0.9

    buf = wire_bitpack_np(codes, quals, lens, valid)
    assert buf.shape == (64, 3 * 128 // 8 + 7 * 128 // 8 + 8)
    c2, q2, l2, v2 = (np.asarray(x) for x in
                      stats_jnp.wire_unbits(jnp.asarray(buf)))
    # invalid rows are wire-zeroed (their content never reaches the kernel)
    np.testing.assert_array_equal(c2, np.where(valid[:, None], codes, 0))
    np.testing.assert_array_equal(q2, np.where(valid[:, None], quals, 0))
    np.testing.assert_array_equal(l2, np.where(valid, lens, 0))
    np.testing.assert_array_equal(v2, valid)

    plain = DeviceAccumulator(128, 33, wire="off")
    bp = DeviceAccumulator(128, 33, wire="bitpack")
    plain.update(codes, quals, lens, valid)
    bp.update(codes, quals, lens, valid)      # host-side bitpack path
    bp2 = DeviceAccumulator(128, 33, wire="bitpack")
    bp2.update(jnp.asarray(buf))              # pre-packed single-buffer path
    ref = plain.finish()
    assert bp.finish().equals(ref)
    assert bp2.finish().equals(ref)


def test_quality_key_half_rounds_up_everywhere():
    """Reads whose rational mean quality is exactly k+0.5 must bin to k+1
    (round-half-up) in the spec, numpy baseline and jnp engine — the [D1]
    integer-key formula is backend-exact whatever the f32 division."""
    import numpy as np

    from hpgq.core.counters import StatsCounters
    from hpgq.kernels import stats_jnp
    from hpgq.oracle import baseline as ob, spec

    # qual bytes 70 and 71 -> qsum 141, len 2 -> mean 70.5 -> key 71
    codes = np.full((4, 128), 5, dtype=np.int8)
    codes[:, :2] = 0
    quals = np.zeros((4, 128), dtype=np.uint8)
    quals[:, 0], quals[:, 1] = 70, 71
    lens = np.full(4, 2, dtype=np.int32)
    valid = np.ones(4, bool)

    c = StatsCounters(phred=33)
    spec.accumulate_read(c, b"AA", bytes([70, 71]))
    assert c.quality_hist[71] == 1

    b = ob.block_stats(codes, quals, lens, valid, phred=33)
    assert b.quality_hist[71] == 4

    p = stats_jnp.batch_partials(codes, quals, lens, valid, 128, 33)
    assert int(np.asarray(p["quality_hist"])[71]) == 4


def test_verdicts_long_read_no_overflow():
    """A 30 kb Q30 read with only a min-quality bound set must pass — the
    substituted MAX sentinel (100000) times the length would wrap int32."""
    import numpy as np

    from hpgq.kernels import stats_jnp
    from hpgq.options import FilterCriteria
    from hpgq.oracle import spec

    L = 30720  # 30 kb, multiple of 128
    codes = np.zeros((2, L), dtype=np.int8)
    quals = np.full((2, L), 63, dtype=np.uint8)  # Q30 phred33
    quals[1] = 32  # below the offset: negative normalized sum -> must fail
    lens = np.full(2, L, dtype=np.int32)

    crit = FilterCriteria(min_read_quality=20)  # max unset -> MAX_VALUE
    ok = np.asarray(stats_jnp.verdicts(codes, quals, lens, crit, 33))
    assert ok[0] and not ok[1]

    # min unset (sentinel 0) still rejects negative normalized sums
    crit2 = FilterCriteria(max_read_quality=60)
    ok2 = np.asarray(stats_jnp.verdicts(codes, quals, lens, crit2, 33))
    assert ok2[0] and not ok2[1]

    # oracle agreement
    seq = b"A" * L
    assert spec.filter_verdict(seq, bytes([63]) * L, crit.substituted(), 33)
    assert not spec.filter_verdict(seq, bytes([32]) * L, crit.substituted(), 33)


def test_bitwire_kind_inversions():
    """bitwire_kind recovers (bits, L) for every 7-bit, 6-bit, and
    2q-palette width up to L=65536 — including collision-padded widths —
    and no width is claimed by two (family, L) pairs."""
    from hpgq.io.native import bitwire2q_width, bitwire6_width
    from hpgq.kernels.stats_jnp import bitwire_kind

    padded6 = padded2 = 0
    seen = {}
    for L in range(8, 65537, 8):
        for w, kind in ((10 * L // 8 + 8, 7), (bitwire6_width(L), 6),
                        (bitwire2q_width(L), 2)):
            assert bitwire_kind(w) == (kind, L), (L, w, kind)
            assert seen.setdefault(w, (kind, L)) == (kind, L), (w, seen[w])
        padded6 += int(bitwire6_width(L) != 9 * L // 8 + 8)
        padded2 += int(bitwire2q_width(L) != 5 * L // 8 + 12)
    assert padded6 > 0 and padded2 > 0  # collision cases actually exercised


def test_wire_bitpack6_roundtrip_and_step():
    """[bitpack6] numpy pack -> device decode roundtrip + accumulator
    equivalence across off/7-bit/6-bit wires, incl. a collision-padded
    width (L=80) and the misfit fallback."""
    import numpy as np
    import jax.numpy as jnp

    from hpgq.core.accumulator import DeviceAccumulator
    from hpgq.io.packer import wire_bitpack6_np
    from hpgq.kernels import stats_jnp

    for L in (128, 80):  # 80: 9L/8+8=98 collides with the 7-bit width of 72
        rng = np.random.default_rng(11 + L)
        B = 64
        lens = rng.integers(0, L + 1, size=B).astype(np.int32)
        pos = np.arange(L)[None, :]
        codes = np.where(pos < lens[:, None],
                         rng.integers(0, 6, size=(B, L)), 5).astype(np.int8)
        quals = np.where(pos < lens[:, None],
                         rng.integers(35, 35 + 63, size=(B, L)),
                         0).astype(np.uint8)
        valid = rng.random(B) < 0.9

        buf = wire_bitpack6_np(codes, quals, lens, valid)
        assert buf is not None
        from hpgq.io.native import bitwire6_width

        assert buf.shape == (B, bitwire6_width(L))
        c2, q2, l2, v2 = (np.asarray(x) for x in
                          stats_jnp.wire_unbits(jnp.asarray(buf)))
        np.testing.assert_array_equal(c2, np.where(valid[:, None], codes, 0))
        np.testing.assert_array_equal(q2, np.where(valid[:, None], quals, 0))
        np.testing.assert_array_equal(l2, np.where(valid, lens, 0))
        np.testing.assert_array_equal(v2, valid)

        if L == 128:
            plain = DeviceAccumulator(L, 33, wire="off")
            plain.update(codes, quals, lens, valid)
            b6 = DeviceAccumulator(L, 33, wire="bitpack")
            b6.update(jnp.asarray(buf))  # pre-packed 6-bit buffer
            assert b6.finish().equals(plain.finish())

    # misfit: a row spanning >= 64 qual values refuses (caller falls back)
    quals[0, : min(4, L)] = [33, 120, 40, 50][: min(4, L)]
    lens[0] = max(lens[0], 4)
    valid[0] = True
    assert wire_bitpack6_np(codes, quals, lens, valid) is None


def test_pack_block_bitwire_adaptive(tmp_path):
    """Adaptive packer: normal corpora take the 6-bit layout (native ==
    numpy reference byte-exact); a corpus with a >=64-span qual row falls
    back to the plain 7-bit bitpack; HPGQ_WIRE6=0 forces 7-bit."""
    import os

    from gen import make_fastq, make_records, write_fastq
    from hpgq.io import FastqReader
    from hpgq.io.native import bitwire6_width
    from hpgq.io.packer import (
        pack_block,
        pack_block_bitwire_adaptive,
        wire_bitpack6_np,
    )

    fq = str(tmp_path / "a6.fq")
    make_fastq(fq, 2000, min_len=40, max_len=120, n_prob=0.02,
               lowercase_prob=0.1, seed=61)
    with FastqReader(fq, batch_size=1024) as rd:
        for block in rd:
            got = pack_block_bitwire_adaptive(block, 128, pad_reads_to=2048)
            assert got.shape[1] == bitwire6_width(128)
            want = wire_bitpack6_np(
                *pack_block(block, max_len=128, pad_reads_to=2048))
            np.testing.assert_array_equal(got, want)

    # one read mixing '!' (33) and '~' (126) quals -> whole block 7-bit
    recs = make_records(50, min_len=60, max_len=60, seed=62)
    name, seq, qual = recs[0]
    recs[0] = (name, seq, b"!" + b"~" * 58 + b"!")
    fq2 = str(tmp_path / "a7.fq")
    write_fastq(fq2, recs)
    with FastqReader(fq2, batch_size=1024) as rd:
        (block,) = list(rd)
    got = pack_block_bitwire_adaptive(block, 64, pad_reads_to=64)
    assert got.shape[1] == 10 * 64 // 8 + 8  # fell back to 7-bit

    os.environ["HPGQ_WIRE6"] = "0"
    try:
        with FastqReader(fq, batch_size=1024) as rd:
            block = next(iter(rd))
        got = pack_block_bitwire_adaptive(block, 128)
        assert got.shape[1] == 10 * 128 // 8 + 8
    finally:
        del os.environ["HPGQ_WIRE6"]


def test_wire_bitpack2q_roundtrip_and_step():
    """[bitpack2q] numpy pack -> device decode roundtrip + accumulator
    equivalence vs the unpacked wire on an RTA3-binned corpus, the
    >4-distinct misfit, and degenerate rows (len 0, single qual value)."""
    import numpy as np
    import jax.numpy as jnp

    from hpgq.core.accumulator import DeviceAccumulator
    from hpgq.io.native import bitwire2q_width
    from hpgq.io.packer import wire_bitpack2q_np
    from hpgq.kernels import stats_jnp

    for L, nbins in ((128, 4), (80, 2), (8, 1)):
        rng = np.random.default_rng(100 + L)
        B = 64
        lens = rng.integers(0, L + 1, size=B).astype(np.int32)
        lens[0] = 0  # degenerate: empty read
        pos = np.arange(L)[None, :]
        codes = np.where(pos < lens[:, None],
                         rng.integers(0, 6, size=(B, L)), 5).astype(np.int8)
        bins = np.asarray([35, 45, 56, 70][:nbins], np.uint8)
        quals = np.where(pos < lens[:, None],
                         bins[rng.integers(0, nbins, size=(B, L))],
                         0).astype(np.uint8)
        valid = rng.random(B) < 0.9
        valid[0] = True

        buf = wire_bitpack2q_np(codes, quals, lens, valid)
        assert buf is not None
        assert buf.shape == (B, bitwire2q_width(L))
        c2, q2, l2, v2 = (np.asarray(x) for x in
                          stats_jnp.wire_unbits(jnp.asarray(buf)))
        np.testing.assert_array_equal(c2, np.where(valid[:, None], codes, 0))
        np.testing.assert_array_equal(q2, np.where(valid[:, None], quals, 0))
        np.testing.assert_array_equal(l2, np.where(valid, lens, 0))
        np.testing.assert_array_equal(v2, valid)

        if L == 128:
            plain = DeviceAccumulator(L, 33, wire="off")
            plain.update(codes, quals, lens, valid)
            b2 = DeviceAccumulator(L, 33, wire="bitpack")
            b2.update(jnp.asarray(buf))  # pre-packed palette buffer
            assert b2.finish().equals(plain.finish())

    # misfit: a row with 5 distinct qual values refuses (caller falls back)
    quals[1, :5] = [33, 40, 50, 60, 70]
    lens[1] = max(lens[1], 5)
    valid[1] = True
    assert wire_bitpack2q_np(codes, quals, lens, valid) is None


def test_pack_block_bitwire_adaptive_palette(tmp_path):
    """Adaptive ladder tier selection: an RTA3-binned corpus takes the
    2q-palette layout (native == numpy byte-exact); HPGQ_QPAL=0 drops it
    to the 6-bit tier; a >4-distinct corpus whose range still fits 6 bits
    lands on 6-bit."""
    import os

    import numpy as np

    from gen import make_fastq
    from hpgq.io import FastqReader
    from hpgq.io.native import bitwire2q_width, bitwire6_width
    from hpgq.io.packer import (
        pack_block,
        pack_block_bitwire_adaptive,
        wire_bitpack2q_np,
    )

    fq = str(tmp_path / "p2q.fq")
    make_fastq(fq, 2000, min_len=40, max_len=120, n_prob=0.02,
               lowercase_prob=0.1, seed=63, qual_bins=(2, 12, 23, 37))
    with FastqReader(fq, batch_size=1024) as rd:
        for block in rd:
            got = pack_block_bitwire_adaptive(block, 128, pad_reads_to=2048)
            assert got.shape[1] == bitwire2q_width(128)
            want = wire_bitpack2q_np(
                *pack_block(block, max_len=128, pad_reads_to=2048))
            np.testing.assert_array_equal(got, want)

    os.environ["HPGQ_QPAL"] = "0"
    try:
        with FastqReader(fq, batch_size=1024) as rd:
            block = next(iter(rd))
        got = pack_block_bitwire_adaptive(block, 128)
        assert got.shape[1] == bitwire6_width(128)
    finally:
        del os.environ["HPGQ_QPAL"]

    # unbinned (uniform 2..41) corpus: >4 distinct, range < 64 -> 6-bit
    fq6 = str(tmp_path / "p6.fq")
    make_fastq(fq6, 500, min_len=60, max_len=60, seed=64)
    with FastqReader(fq6, batch_size=1024) as rd:
        (block,) = list(rd)
    got = pack_block_bitwire_adaptive(block, 64)
    assert got.shape[1] == bitwire6_width(64)
