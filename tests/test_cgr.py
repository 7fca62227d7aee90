"""Chaos-game: kernel vs faithful loop oracle, formats, CLI end-to-end."""

import os


import numpy as np
import pytest

from gen import make_fastq

from hpgq.constants import PHRED33
from hpgq.kernels import cgr as kcgr
from hpgq.oracle.cgr import fill_tables_loop
from hpgq.report import pgm


def _rand_batch(B, L, seed=0, n_prob=0.02, varlen=True):
    rng = np.random.default_rng(seed)
    lens = (rng.integers(1, L + 1, size=B) if varlen else np.full(B, L)).astype(
        np.int32
    )
    codes = rng.integers(0, 4, size=(B, L)).astype(np.int8)
    codes[rng.random((B, L)) < n_prob] = 4
    pos = np.arange(L)[None, :]
    codes = np.where(pos < lens[:, None], codes, np.int8(5))
    quals = np.where(
        pos < lens[:, None], rng.integers(33, 74, size=(B, L)), 0
    ).astype(np.uint8)
    valid = rng.random(B) < 0.9
    return codes, quals, lens, valid


@pytest.mark.parametrize("k", [2, 4, 7])
def test_kernel_matches_loop_oracle(k):
    codes, quals, lens, valid = _rand_batch(48, 96, seed=k)
    ts, th, tl, w = kcgr.cgr_batch_tables(
        codes, quals, lens, valid, k, PHRED33, chunk=1024
    )
    tq = kcgr.combine_quality_limbs(th, tl)
    ots, otq, ow = fill_tables_loop(codes, quals, lens, valid, k, PHRED33)
    np.testing.assert_array_equal(np.asarray(ts), ots)
    np.testing.assert_array_equal(np.asarray(tq), otq)
    assert int(w) == ow


def test_kernel_word_edge_cases():
    # reads shorter than k, exactly k, N interrupting a word
    k = 4
    L = 128
    codes = np.full((4, L), 5, dtype=np.int8)
    quals = np.zeros((4, L), dtype=np.uint8)
    lens = np.array([2, 4, 8, 9], dtype=np.int32)
    rows = [
        [0, 1],                         # too short: no word
        [0, 1, 2, 3],                   # exactly one word
        [0, 1, 4, 2, 3, 0, 1, 2],       # N at pos 2: words only after it
        [3, 3, 3, 3, 3, 3, 3, 3, 3],    # 9 Ts: 6 words, all in one cell
    ]
    for i, r in enumerate(rows):
        codes[i, : len(r)] = r
        quals[i, : len(r)] = 40
    valid = np.ones(4, dtype=bool)
    ts, th, tl, w = kcgr.cgr_batch_tables(codes, quals, lens, valid, k,
                                          PHRED33, chunk=256)
    tq = kcgr.combine_quality_limbs(th, tl)
    ots, otq, ow = fill_tables_loop(codes, quals, lens, valid, k, PHRED33)
    np.testing.assert_array_equal(np.asarray(ts), ots)
    np.testing.assert_array_equal(np.asarray(tq), otq)
    assert int(w) == ow == 1 + 2 + 6


def test_batch_invariance():
    """Accumulating in two halves equals one shot (windows are read-local)."""
    k = 5
    codes, quals, lens, valid = _rand_batch(64, 128, seed=77)
    ts, th, tl, w = kcgr.cgr_batch_tables(codes, quals, lens, valid, k,
                                          PHRED33, chunk=512)
    tq = kcgr.combine_quality_limbs(th, tl)
    h = 32
    t1 = kcgr.cgr_batch_tables(codes[:h], quals[:h], lens[:h], valid[:h], k,
                               PHRED33, chunk=512)
    t2 = kcgr.cgr_batch_tables(codes[h:], quals[h:], lens[h:], valid[h:], k,
                               PHRED33, chunk=512)
    np.testing.assert_array_equal(np.asarray(ts), np.asarray(t1[0]) + np.asarray(t2[0]))
    np.testing.assert_array_equal(
        tq,
        kcgr.combine_quality_limbs(t1[1], t1[2])
        + kcgr.combine_quality_limbs(t2[1], t2[2]),
    )


def test_pgm_format_zoom_and_wrap():
    k = 2  # dim 4 -> zoomed 32x to 128
    table = np.array(
        [[0, 1, 2, 3], [4, 5, 6, 300], [8, 9, 10, 11], [12, 13, 14, 15]],
        dtype=np.int64,
    )
    data = pgm.pgm_bytes(table, k, norm=1.0)
    assert data.startswith(b"P5\n128 128\n255\n")
    body = np.frombuffer(data[len(b"P5\n128 128\n255\n"):], dtype=np.uint8)
    img = body.reshape(128, 128)
    assert img[0, 0] == 0
    assert img[0, 32] == 1          # zoom block
    assert img[32, 96] == 300 % 256  # uchar wrap
    # k=7: no zoom
    t7 = np.zeros((128, 128), dtype=np.int64)
    d7 = pgm.pgm_bytes(t7, 7, norm=128.0)
    assert d7.startswith(b"P5\n128 128\n255\n")
    assert len(d7) == len(b"P5\n128 128\n255\n") + 128 * 128


def test_gs_roundtrip(tmp_path):
    rng = np.random.default_rng(1)
    k = 4
    table = rng.integers(0, 1000, size=(16, 16)).astype(np.int64)
    p = str(tmp_path / "ref.gs")
    pgm.write_gs(p, table, k, int(table.sum()))
    t2, k2, wc = pgm.read_gs(p, expect_k=k)
    np.testing.assert_array_equal(t2, table)
    assert k2 == k and wc == int(table.sum())
    assert os.path.getsize(p) == 196 + 16 * 16 * 4
    with pytest.raises(ValueError):
        pgm.read_gs(p, expect_k=5)


def test_quality_normalize_and_diff_semantics():
    tseq = np.array([[0, 2], [4, 1]], dtype=np.int64)
    tq = np.array([[50, 100], [200, 37]], dtype=np.int64)
    qn = pgm.normalize_quality_table(tq, tseq, k=3)
    # C: (q / k) / seq with unsigned integer division
    assert qn[0, 0] == 0           # no words -> 0
    assert qn[0, 1] == (100 // 3) // 2
    assert qn[1, 0] == (200 // 3) // 4
    assert qn[1, 1] == (37 // 3) // 1
    dif, stats = pgm.diff_table(
        np.array([[4, 0], [0, 0]]), np.array([[0, 4], [0, 0]]), 4, 4, k=1
    )
    # fq_norm = gs_norm = 128/(4/4) = 128 -> dif = [[512, -512], [0, 0]]
    assert dif[0, 0] == 512 and dif[0, 1] == -512
    assert stats["highest"] == 512 and stats["lowest"] == -512
    clamped = pgm.abs_clamp_diff(dif)
    assert clamped[0, 0] == 255 and clamped[1, 1] == 0


def test_cgr_cli_end_to_end(tmp_path):
    from hpgq.cli.main import main as cli_main

    fq = str(tmp_path / "sample.fq")
    make_fastq(fq, 300, min_len=50, max_len=90, n_prob=0.01, seed=5)
    out = str(tmp_path / "out")
    os.makedirs(out)
    rc = cli_main([
        "cgr", "-f", fq, "-o", out, "--k", "4", "--write-gs",
        "--batch-size", "128",
    ])
    assert rc in (0, None)
    base = os.path.join(out, "sample.fq_k=4")
    assert os.path.exists(base + "_FG.pgm")
    assert os.path.exists(base + "_QQ.pgm")
    assert os.path.exists(base + ".gs")

    # second run diffing against the signature we just wrote: diff == 0
    out2 = str(tmp_path / "out2")
    os.makedirs(out2)
    rc = cli_main([
        "cgr", "-f", fq, "-o", out2, "--k", "4",
        "--gs-filename", base + ".gs", "--batch-size", "999",
    ])
    assert rc in (0, None)
    dif_pgm = os.path.join(out2, "sample.fq_k=4_FG_dif.pgm")
    with open(dif_pgm, "rb") as f:
        data = f.read()
    body = data.split(b"\n", 3)[3]
    assert set(body) == {0}  # identical signatures -> all-zero diff image


def test_cgr_against_oracle_from_file(tmp_path):
    """File -> pipeline tables == oracle loop over the same packed reads."""
    from hpgq.io.fastq import FastqReader
    from hpgq.io.packer import pack_block
    from hpgq.pipeline.cgr_run import CgrSession

    fq = str(tmp_path / "t.fq")
    make_fastq(fq, 200, min_len=30, max_len=70, n_prob=0.03, seed=12)
    k = 4
    sess = CgrSession(k, PHRED33, batch_reads=256)
    ots = otq = None
    ow = 0
    with FastqReader(fq, batch_size=97) as rd:
        for block in rd:
            sess.feed_block(block)
            codes, quals, lens, valid = pack_block(block)
            ts, tq, w = fill_tables_loop(codes, quals, lens, valid, k, PHRED33)
            ots = ts if ots is None else ots + ts
            otq = tq if otq is None else otq + tq
            ow += w
    np.testing.assert_array_equal(sess.table_seq, ots)
    np.testing.assert_array_equal(sess.table_q, otq)
    assert sess.word_count == ow


def test_cgr_session_through_wire(tmp_path, monkeypatch):
    """CgrSession through the wire formats == plain-array session (the
    opt-in HPGQ_WIRE H2D path; tables and word count exactly equal)."""
    from hpgq.io.fastq import FastqReader
    from hpgq.pipeline.cgr_run import CgrSession

    fq = str(tmp_path / "w.fq")
    make_fastq(fq, 300, min_len=30, max_len=90, n_prob=0.03, seed=14)
    k = 4

    def run(wire):
        monkeypatch.setenv("HPGQ_WIRE", wire)
        sess = CgrSession(k, PHRED33, batch_reads=256)
        with FastqReader(fq, batch_size=120) as rd:
            for block in rd:
                sess.feed_block(block)
        return sess

    ref = run("off")
    for wire in ("bitpack", "fused4"):
        got = run(wire)
        assert got.wire == wire
        np.testing.assert_array_equal(got.table_seq, ref.table_seq)
        np.testing.assert_array_equal(got.table_q, ref.table_q)
        assert got.word_count == ref.word_count


def test_kernel_large_k():
    """k=10 (dim 1024): the chunk auto-bound keeps memory sane and results
    exact vs the loop oracle."""
    codes, quals, lens, valid = _rand_batch(16, 64, seed=3, n_prob=0.01)
    ts, th, tl, w = kcgr.cgr_batch_tables(codes, quals, lens, valid, 10, PHRED33)
    tq = kcgr.combine_quality_limbs(th, tl)
    ots, otq, ow = fill_tables_loop(codes, quals, lens, valid, 10, PHRED33)
    np.testing.assert_array_equal(np.asarray(ts), ots)
    np.testing.assert_array_equal(np.asarray(tq), otq)
    assert int(w) == ow


def test_quality_table_exceeds_int32():
    """A single batch can push one quality cell past 2^31 (confirmed wrap in
    the single-limb int32 design): poly-A high-quality reads all land in one
    cell; the two-limb accumulation must recover the exact int64 total."""
    k = 2
    B, L = 3000, 4096
    codes = np.zeros((B, L), dtype=np.int8)          # all A
    quals = np.full((B, L), 126, dtype=np.uint8)     # max ASCII quality
    lens = np.full(B, L, dtype=np.int32)
    valid = np.ones(B, dtype=bool)
    ts, th, tl, w = kcgr.cgr_batch_tables(codes, quals, lens, valid, k,
                                          PHRED33)
    tq = kcgr.combine_quality_limbs(th, tl)
    nwin = B * (L - k + 1)
    weight = k * 126 - PHRED33 * k
    assert int(w) == nwin
    assert int(np.asarray(ts)[3, 0]) == nwin
    expected = nwin * weight
    assert expected > 2**31  # the scenario the old code wrapped on
    assert int(tq[3, 0]) == expected
    assert tq.sum() == expected


def test_cgr_other_bytes_treated_as_N():
    """[D7]: in-read non-ACGTN bytes (packer code 5 — IUPAC etc.).  The
    reference loop splices k-words across them (and then subtracts the
    wrong quality byte); the kernel deliberately treats them like N.
    Contract: kernel(batch) == loop-oracle(batch with 5 -> N), and the
    oracle on the raw batch genuinely DIVERGES (the deviation is real)."""
    import jax.numpy as jnp

    from hpgq.kernels.cgr import cgr_batch_tables, combine_quality_limbs
    from hpgq.oracle.cgr import fill_tables_loop

    k = 4
    codes, quals, lens, valid = _rand_batch(160, 64, seed=91, n_prob=0.02)
    rng = np.random.default_rng(92)
    pos = np.arange(64)[None, :]
    inread = pos < lens[:, None]
    codes[(rng.random(codes.shape) < 0.05) & inread] = 5  # IUPAC-ish bytes
    valid[:] = True

    ts, hi, lo, w = cgr_batch_tables(
        jnp.asarray(codes), jnp.asarray(quals), jnp.asarray(lens),
        jnp.asarray(valid), k, 33,
    )
    eng = (np.asarray(ts, np.int64), combine_quality_limbs(hi, lo), int(w))

    as_n = np.where(codes == 5, np.int8(4), codes)
    ots, otq, ow = fill_tables_loop(as_n, quals, lens, valid, k, 33)
    assert eng[2] == ow
    assert np.array_equal(eng[0], ots)
    assert np.array_equal(eng[1], otq)

    # the raw (reference-faithful, splicing) oracle differs — the
    # deviation is real on this corpus, not vacuous
    rts, _, rw = fill_tables_loop(codes, quals, lens, valid, k, 33)
    assert rw != ow or not np.array_equal(rts, ots)


def test_cgr_zero_words_graceful(tmp_path):
    """Every read shorter than k: zero counted words must yield all-zero
    (black) PGMs and rc 0 — the reference divides by zero here (UB
    garbage pixels); the all-zero image is the documented sane deviation
    (found by the config fuzzer on uniform short reads)."""
    from hpgq.cli.main import main as cli_main

    fq = str(tmp_path / "short.fq")
    make_fastq(fq, 100, min_len=3, max_len=3, n_prob=0.0, seed=6)
    out = str(tmp_path / "out")
    os.makedirs(out)
    rc = cli_main(["cgr", "-f", fq, "-o", out, "--k", "7", "--write-gs"])
    assert rc in (0, None)
    for suffix in ("_FG.pgm", "_QQ.pgm"):
        path = os.path.join(out, "short.fq_k=7" + suffix)
        body = open(path, "rb").read().split(b"\n", 3)[3]
        assert set(body) == {0}, suffix
