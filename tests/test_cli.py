"""End-to-end CLI tests: run commands in-process and compare against the oracle."""

import os

import numpy as np
import pytest

from hpgq.cli.main import main
from hpgq.options import FilterCriteria, StatsOptions
from hpgq.oracle import spec
from hpgq.report.stats_report import stats_report

from gen import make_fastq


def _fastq(tmp_path, name="in.fq", n=500, **kw):
    path = str(tmp_path / name)
    make_fastq(path, n, **kw)
    return path


def test_cli_stats_matches_oracle_report(tmp_path, capsys):
    path = _fastq(tmp_path, n=400, min_len=40, max_len=60, n_prob=0.01, seed=41)
    out1 = tmp_path / "cli_out"
    out2 = tmp_path / "oracle_out"
    out1.mkdir()
    out2.mkdir()
    rc = main(["stats", "-f", path, "-o", str(out1), "--kmers"])
    assert rc == 0
    stdout = capsys.readouterr().out
    assert "PARAMETERS CONFIGURATION" in stdout
    assert "RESULTS" in stdout
    assert "Filtering: disabled" in stdout

    counters = spec.stats_of_file(spec.iter_seq_qual(path), kmers_on=True)
    opts = StatsOptions(in_filename=path, out_dirname=str(out2), kmers_on=True)
    stats_report(counters, opts)

    names = sorted(os.listdir(out2))
    assert sorted(os.listdir(out1)) == names
    for name in names:
        if name.endswith(".gnuplot"):
            continue
        a = (out1 / name).read_bytes()
        b = (out2 / name).read_bytes()
        assert a == b, "mismatch in %s" % name


def test_cli_stats_with_filter(tmp_path, capsys):
    path = _fastq(tmp_path, n=300, min_len=40, max_len=60, seed=42)
    out1 = tmp_path / "o1"
    out1.mkdir()
    rc = main(
        ["stats", "-f", path, "-o", str(out1),
         "--read-quality-range", "20,40", "--max-N", "3"]
    )
    assert rc == 0
    stdout = capsys.readouterr().out
    assert "Filtering: enabled" in stdout

    crit = FilterCriteria(min_read_quality=20, max_read_quality=40, max_N=3)
    counters = spec.stats_of_file(spec.iter_seq_qual(path), criteria=crit)
    summary = (out1 / "in.fq.summary.txt").read_text()
    assert "Number of reads in file  : 300\n" in summary
    assert (
        "Number of processed reads: %d" % counters.num_reads in summary
    )


def test_cli_filter_matches_oracle(tmp_path, capsys):
    path = _fastq(tmp_path, n=400, min_len=30, max_len=70, n_prob=0.03, seed=43)
    out = tmp_path / "o"
    out.mkdir()
    rc = main(
        ["filter", "-f", path, "-o", str(out),
         "--read-length-range", "35,65",
         "--read-quality-range", "20,40",
         "--max-N", "1",
         "--batch-size", "64"]
    )
    assert rc == 0

    crit = FilterCriteria(
        min_read_length=35, max_read_length=65,
        min_read_quality=20, max_read_quality=40, max_N=1,
    ).substituted()
    passed, failed = [], []
    with open(path, "rb") as f:
        raw = f.read().split(b"\n")
    for i in range(0, len(raw) - 1, 4):
        rec = b"\n".join(raw[i : i + 4]) + b"\n"
        seq, qual = raw[i + 1], raw[i + 3]
        (passed if spec.filter_verdict(seq, qual, crit) else failed).append(rec)
    assert (out / "passed.fq").read_bytes() == b"".join(passed)
    assert (out / "failed.fq").read_bytes() == b"".join(failed)
    stdout = capsys.readouterr().out
    assert "Num. passed reads: %d" % len(passed) in stdout
    assert "Num. failed reads: %d" % len(failed) in stdout


def test_cli_filter_requires_criteria(tmp_path, capsys):
    path = _fastq(tmp_path, n=10, seed=44)
    with pytest.raises(SystemExit):
        main(["filter", "-f", path, "-o", str(tmp_path)])


def test_cli_edit_matches_oracle(tmp_path, capsys):
    path = _fastq(tmp_path, n=300, min_len=30, max_len=60, seed=45)
    out = tmp_path / "o"
    out.mkdir()
    rc = main(
        ["edit", "-f", path, "-o", str(out),
         "--left-length", "8", "--left-quality-range", "25,90",
         "--right-length", "5", "--right-quality-range", "25,90",
         "--batch-size", "77"]
    )
    assert rc == 0

    crit = FilterCriteria(
        left_length=8, min_left_quality=25, max_left_quality=90,
        right_length=5, min_right_quality=25, max_right_quality=90,
    ).substituted()
    expected = []
    n_edited = 0
    with open(path, "rb") as f:
        raw = f.read().split(b"\n")
    for i in range(0, len(raw) - 1, 4):
        name, seq, plus, qual = raw[i : i + 4]
        lt, rt = spec.trim_lengths(seq, qual, crit)
        n_edited += int(lt > 0 or rt > 0)
        expected.append(
            name + b"\n" + seq[lt : len(seq) - rt] + b"\n" + plus + b"\n"
            + qual[lt : len(qual) - rt] + b"\n"
        )
    assert (out / "edit.fq").read_bytes() == b"".join(expected)
    assert n_edited > 0
    stdout = capsys.readouterr().out
    assert "Num. edited reads : %d" % n_edited in stdout


def test_cli_edit_with_postfilter(tmp_path, capsys):
    path = _fastq(tmp_path, n=300, min_len=30, max_len=60, seed=46)
    out = tmp_path / "o"
    out.mkdir()
    rc = main(
        ["edit", "-f", path, "-o", str(out),
         "--left-length", "8", "--left-quality-range", "25,90",
         "--read-quality-range", "22,40"]
    )
    assert rc == 0
    crit = FilterCriteria(
        left_length=8, min_left_quality=25, max_left_quality=90,
        min_read_quality=22, max_read_quality=40,
    )
    sub = crit.substituted()
    post = sub.without_windows()
    epassed, efailed = [], []
    with open(path, "rb") as f:
        raw = f.read().split(b"\n")
    for i in range(0, len(raw) - 1, 4):
        name, seq, plus, qual = raw[i : i + 4]
        lt, rt = spec.trim_lengths(seq, qual, sub)
        ts, tq = seq[lt : len(seq) - rt], qual[lt : len(qual) - rt]
        rec = name + b"\n" + ts + b"\n" + plus + b"\n" + tq + b"\n"
        (epassed if spec.filter_verdict(ts, tq, post) else efailed).append(rec)
    assert (out / "edit.fq").read_bytes() == b"".join(epassed)
    assert (out / "failed.fq").read_bytes() == b"".join(efailed)
    assert len(epassed) > 0 and len(efailed) > 0


def test_cli_paired_filter(tmp_path, capsys):
    p1 = _fastq(tmp_path, name="r1.fq", n=200, min_len=40, max_len=40, seed=47)
    p2 = _fastq(tmp_path, name="r2.fq", n=200, min_len=40, max_len=40, seed=48)
    out = tmp_path / "o"
    out.mkdir()
    rc = main(
        ["filter", "--fq1", p1, "--fq2", p2, "-o", str(out),
         "--read-quality-range", "21,40"]
    )
    assert rc == 0
    crit = FilterCriteria(min_read_quality=21, max_read_quality=40).substituted()

    def verdicts(path):
        with open(path, "rb") as f:
            raw = f.read().split(b"\n")
        return [
            spec.filter_verdict(raw[i + 1], raw[i + 3], crit)
            for i in range(0, len(raw) - 1, 4)
        ]

    v1, v2 = verdicts(p1), verdicts(p2)
    both = [a and b for a, b in zip(v1, v2)]
    assert sum(both) < 200 and sum(both) > 0
    # pair-consistent: passed_1 count == passed_2 count == both count
    n1 = (out / "passed_1.fq").read_bytes().count(b"\n@read_") + 1
    n2 = (out / "passed_2.fq").read_bytes().count(b"\n@read_") + 1
    assert n1 == n2 == sum(both)
    stdout = capsys.readouterr().out
    assert "Num. passed pairs: %d" % sum(both) in stdout


def test_cli_usage(capsys):
    assert main([]) == -1
    assert "Usage:" in capsys.readouterr().out


def test_cli_conf_file(tmp_path, capsys):
    path = _fastq(tmp_path, n=50, seed=49)
    conf = tmp_path / "run.conf"
    conf.write_text('# conf\nmax-N = 2 ;\nread-quality-range = "20,45" ;\n')
    out = tmp_path / "o"
    out.mkdir()
    rc = main(["stats", "-f", path, "-o", str(out), "--conf", str(conf)])
    assert rc == 0
    stdout = capsys.readouterr().out
    assert "Max. number of Ns   : 2" in stdout
    assert "Read quality range  : 20,45" in stdout


def test_stats_pipeline_with_wire_pack4(tmp_path, monkeypatch):
    """End-to-end stats through the nibble wire format == plain run."""
    from gen import make_fastq
    from hpgq.options import StatsOptions
    from hpgq.pipeline.run import run_stats

    fq = str(tmp_path / "w.fq")
    make_fastq(fq, 1200, min_len=40, max_len=100, n_prob=0.02, seed=3)

    def opts(out):
        o = StatsOptions()
        o.in_filename = fq
        o.out_dirname = str(out)
        o.quality_encoding_value = 33
        o.quality_encoding_name = "phred33"
        o.batch_size = 256
        return o

    a, b = tmp_path / "a", tmp_path / "b"
    a.mkdir(); b.mkdir()
    plain = run_stats(opts(a))
    monkeypatch.setenv("HPGQ_WIRE", "pack4")
    wired = run_stats(opts(b))
    assert wired.equals(plain)
    assert (b / "w.fq.summary.txt").read_bytes() == (a / "w.fq.summary.txt").read_bytes()


def test_paired_blocks_reslice_on_uneven_chunks(tmp_path, monkeypatch):
    """Mate files with different byte layouts produce misaligned reader
    blocks; the pairing iterator re-slices to common record ranges."""
    import numpy as np

    import hpgq.io.fastq as fastq_mod
    from gen import make_records, write_fastq
    from hpgq.options import FilterOptions
    from hpgq.pipeline.run import run_filter

    n = 400
    r1 = make_records(n, min_len=60, max_len=60, seed=1)
    # mate 2: same count, much longer headers -> different chunk boundaries
    r2 = [(b"@mate2_" + b"x" * 60 + b"_%d" % i, s, q)
          for i, (_, s, q) in enumerate(make_records(n, min_len=90, max_len=90, seed=2))]
    f1 = str(tmp_path / "r1.fq")
    f2 = str(tmp_path / "r2.fq")
    write_fastq(f1, r1)
    write_fastq(f2, r2)

    monkeypatch.setattr(fastq_mod, "_CHUNK", 4096)  # force many tiny chunks

    o = FilterOptions()
    o.in_filename = f1
    o.in_filename2 = f2
    o.out_dirname = str(tmp_path / "out")
    import os
    os.makedirs(o.out_dirname)
    o.quality_encoding_value = 33
    o.quality_encoding_name = "phred33"
    o.batch_size = 64
    o.criteria.min_read_quality = 15
    o.criteria.max_read_quality = 45

    res = run_filter(o)
    assert res["num_passed"] + res["num_failed"] == n
    # outputs pair up line-for-line
    p1 = open(os.path.join(o.out_dirname, "passed_1.fq"), "rb").read()
    p2 = open(os.path.join(o.out_dirname, "passed_2.fq"), "rb").read()
    n1 = p1.count(b"\n") // 4
    n2 = p2.count(b"\n") // 4
    assert n1 == n2 == res["num_passed"]


def test_stats_sharded_cli_flag(tmp_path):
    """--sharded routes stats through the mesh pipeline; same report bytes."""
    from gen import make_fastq
    from hpgq.cli.main import main

    fq = str(tmp_path / "s.fq")
    make_fastq(fq, 800, min_len=60, max_len=90, seed=6)
    a, b = tmp_path / "a", tmp_path / "b"
    a.mkdir(); b.mkdir()
    assert main(["stats", "-f", fq, "-o", str(a)]) in (0, None)
    assert main(["stats", "-f", fq, "-o", str(b), "--sharded"]) in (0, None)
    assert (b / "s.fq.summary.txt").read_bytes() == (a / "s.fq.summary.txt").read_bytes()


def test_stats_pipeline_with_wire_fused4(tmp_path, monkeypatch):
    from gen import make_fastq
    from hpgq.options import StatsOptions
    from hpgq.pipeline.run import run_stats

    fq = str(tmp_path / "wf.fq")
    make_fastq(fq, 900, min_len=40, max_len=100, n_prob=0.02, seed=4)

    def opts(out):
        o = StatsOptions()
        o.in_filename = fq
        o.out_dirname = str(out)
        o.quality_encoding_value = 33
        o.quality_encoding_name = "phred33"
        o.batch_size = 200
        return o

    a, b = tmp_path / "a", tmp_path / "b"
    a.mkdir(); b.mkdir()
    plain = run_stats(opts(a))
    monkeypatch.setenv("HPGQ_WIRE", "fused4")
    wired = run_stats(opts(b))
    assert wired.equals(plain)
    assert (b / "wf.fq.summary.txt").read_bytes() == (a / "wf.fq.summary.txt").read_bytes()
    c = tmp_path / "c"
    c.mkdir()
    monkeypatch.setenv("HPGQ_WIRE", "bitpack")
    bp = run_stats(opts(c))
    assert bp.equals(plain)
    assert (c / "wf.fq.summary.txt").read_bytes() == (a / "wf.fq.summary.txt").read_bytes()


def test_paired_stats_filter_through_wire(tmp_path, monkeypatch):
    """Paired stats + pair-consistent inline filter with the wire feed
    (PairedStatsSession's fused step over two wire buffers) == plain path."""
    from gen import make_fastq
    from hpgq.options import StatsOptions
    from hpgq.pipeline.run import run_stats

    f1 = str(tmp_path / "m1.fq")
    f2 = str(tmp_path / "m2.fq")
    make_fastq(f1, 800, min_len=50, max_len=90, n_prob=0.02, seed=41)
    make_fastq(f2, 800, min_len=50, max_len=90, n_prob=0.02, seed=42)

    def opts(out):
        o = StatsOptions()
        o.in_filename = f1
        o.in_filename2 = f2
        o.out_dirname = str(out)
        o.quality_encoding_value = 33
        o.quality_encoding_name = "phred33"
        o.batch_size = 150
        o.criteria.min_read_quality = 18
        o.criteria.max_read_quality = 40
        o.filter_on = True
        return o

    a = tmp_path / "a"
    a.mkdir()
    monkeypatch.setenv("HPGQ_WIRE", "off")
    c1, c2 = run_stats(opts(a))
    for wire in ("bitpack", "fused4", "pack4"):
        b = tmp_path / ("b_" + wire)
        b.mkdir()
        monkeypatch.setenv("HPGQ_WIRE", wire)
        w1, w2 = run_stats(opts(b))
        assert w1.equals(c1) and w2.equals(c2), wire
        assert (w1.num_passed, w1.num_failed) == (c1.num_passed, c1.num_failed)


def test_filter_edit_through_wire(tmp_path, monkeypatch):
    """filter/edit verdict+trim kernels through the wire formats (the
    opt-in ShapeCachedFn wire path) == the plain-array path,
    byte-identical outputs."""
    from gen import make_fastq
    from hpgq.options import EditOptions, FilterOptions
    from hpgq.pipeline.run import run_edit, run_filter

    fq = str(tmp_path / "w.fq")
    make_fastq(fq, 1200, min_len=40, max_len=100, n_prob=0.02, seed=17)

    def fopts(out):
        o = FilterOptions()
        o.in_filename = fq
        o.out_dirname = str(out)
        o.quality_encoding_value = 33
        o.quality_encoding_name = "phred33"
        o.batch_size = 300
        o.criteria.min_read_quality = 18
        o.criteria.max_read_quality = 40
        o.criteria.max_N = 1
        o.filter_on = True
        return o

    def eopts(out):
        o = EditOptions()
        o.in_filename = fq
        o.out_dirname = str(out)
        o.quality_encoding_value = 33
        o.quality_encoding_name = "phred33"
        o.batch_size = 300
        o.criteria.left_length = 8
        o.criteria.min_left_quality = 30
        o.criteria.max_left_quality = 60
        return o

    outs = {}
    # bitpack/fused4 auto-upgrade verdict/trim calls to qn8; "bitpack+noqn"
    # pins the upgrade off (HPGQ_QN_WIRE=0) so the raw bitpack decode path
    # is also exercised
    for tag, wire, qn in (("off", "off", "1"), ("bitpack", "bitpack", "1"),
                          ("fused4", "fused4", "1"),
                          ("bitpack+noqn", "bitpack", "0")):
        monkeypatch.setenv("HPGQ_WIRE", wire)
        monkeypatch.setenv("HPGQ_QN_WIRE", qn)
        d = tmp_path / ("f_" + tag)
        d.mkdir()
        rf = run_filter(fopts(d))
        e = tmp_path / ("e_" + tag)
        e.mkdir()
        re_ = run_edit(eopts(e))
        outs[tag] = (
            (d / "passed.fq").read_bytes(), (d / "failed.fq").read_bytes(),
            (e / "edit.fq").read_bytes(),
            rf["num_passed"], rf["num_failed"], re_["num_edited"],
        )
    assert outs["bitpack"] == outs["off"]
    assert outs["fused4"] == outs["off"]
    assert outs["bitpack+noqn"] == outs["off"]


def test_filter_edit_palette_wire(tmp_path, monkeypatch):
    """On an RTA3-binned corpus the verdict/trim dispatch prefers the 2q
    palette wire (5 bits/base) over its qn8 upgrade — outputs byte-equal
    to the palette-disabled run, and the palette path actually engages
    (spied)."""
    import hpgq.io.packer as packer_mod
    from gen import make_fastq
    from hpgq.options import EditOptions, FilterOptions
    from hpgq.pipeline.run import run_edit, run_filter

    fq = str(tmp_path / "wp.fq")
    make_fastq(fq, 1500, min_len=40, max_len=100, n_prob=0.02, seed=19,
               qual_bins=(2, 12, 23, 37))

    def fopts(out):
        o = FilterOptions()
        o.in_filename = fq
        o.out_dirname = str(out)
        o.quality_encoding_value = 33
        o.quality_encoding_name = "phred33"
        o.batch_size = 400
        o.criteria.min_read_quality = 18
        o.criteria.max_read_quality = 40
        o.criteria.max_N = 1
        o.filter_on = True
        return o

    def eopts(out):
        o = EditOptions()
        o.in_filename = fq
        o.out_dirname = str(out)
        o.quality_encoding_value = 33
        o.quality_encoding_name = "phred33"
        o.batch_size = 400
        o.criteria.left_length = 8
        o.criteria.min_left_quality = 25
        o.criteria.max_left_quality = 60
        return o

    hits = {"fit": 0, "fit2c": 0}
    orig = packer_mod.try_pack_block_palette
    orig2c = packer_mod.try_pack_block_2c

    def spy(*a, **k):
        out = orig(*a, **k)
        hits["fit"] += int(out is not None)
        return out

    def spy2c(*a, **k):
        out = orig2c(*a, **k)
        hits["fit2c"] += int(out is not None)
        return out

    monkeypatch.setattr(packer_mod, "try_pack_block_palette", spy)
    monkeypatch.setattr(packer_mod, "try_pack_block_2c", spy2c)
    monkeypatch.setenv("HPGQ_WIRE", "bitpack")
    outs = {}
    for tag, qpal in (("pal", "1"), ("nopal", "0")):
        monkeypatch.setenv("HPGQ_QPAL", qpal)
        d = tmp_path / ("fp_" + tag)
        d.mkdir()
        rf = run_filter(fopts(d))
        e = tmp_path / ("ep_" + tag)
        e.mkdir()
        re_ = run_edit(eopts(e))
        outs[tag] = (
            (d / "passed.fq").read_bytes(), (d / "failed.fq").read_bytes(),
            (e / "edit.fq").read_bytes(),
            rf["num_passed"], rf["num_failed"], re_["num_edited"],
        )
    assert outs["pal"] == outs["nopal"]
    # a narrow tier actually carried batches (2c preferred; the palette
    # only engages for blocks 2c rejects)
    assert hits["fit2c"] + hits["fit"] > 0
    assert hits["fit2c"] > 0  # the 2c tier specifically


def test_phred64_encoding_and_aliases(tmp_path):
    """phred64 quality encoding: stats summary normalizes with offset 64;
    filter thresholds apply in normalized space; legacy aliases accepted."""
    from gen import make_fastq
    from hpgq.cli.main import main
    from hpgq.oracle import spec
    from hpgq.options import StatsOptions
    from hpgq.pipeline.run import run_stats

    fq = str(tmp_path / "p64.fq")
    make_fastq(fq, 600, min_len=60, max_len=90, phred=64, min_q=5, max_q=40,
               seed=9)

    out1 = tmp_path / "o1"; out1.mkdir()
    rc = main(["stats", "-f", fq, "-o", str(out1),
               "--quality-encoding", "phred64"])
    assert rc in (0, None)
    summary = (out1 / "p64.fq.summary.txt").read_bytes()
    # oracle with phred=64 must byte-match
    want = spec.stats_of_file(spec.iter_seq_qual(fq), phred=64)
    o = StatsOptions()
    o.in_filename = fq
    o.out_dirname = str(tmp_path / "o2")
    (tmp_path / "o2").mkdir()
    o.quality_encoding_value = 64
    o.quality_encoding_name = "phred64"
    got = run_stats(o)
    assert got.equals(want)
    assert summary == (tmp_path / "o2" / "p64.fq.summary.txt").read_bytes()
    # normalized mean quality is in the 5..40 band, not the raw 69..104 one
    import re

    m = re.search(rb"Mean quality = (\d+)", summary)
    assert m and 5 <= int(m.group(1)) <= 40

    # solexa alias == phred64
    out3 = tmp_path / "o3"; out3.mkdir()
    rc = main(["stats", "-f", fq, "-o", str(out3),
               "--quality-encoding", "solexa"])
    assert rc in (0, None)
    assert (out3 / "p64.fq.summary.txt").read_bytes() == summary

    # filter with normalized thresholds on phred64 data
    out4 = tmp_path / "o4"; out4.mkdir()
    rc = main(["filter", "-f", fq, "-o", str(out4),
               "--quality-encoding", "phred64", "--read-quality-range", "20,40"])
    assert rc in (0, None)
    import os
    n_p = open(os.path.join(out4, "passed.fq"), "rb").read().count(b"\n") // 4
    n_f = open(os.path.join(out4, "failed.fq"), "rb").read().count(b"\n") // 4
    assert n_p + n_f == 600 and n_p > 0


def test_filter_mixed_length_buckets(tmp_path):
    """Reads spanning several 128-lane length buckets in one stream: the
    shape-bucketed jit dispatch must not change results."""
    import numpy as np

    from gen import make_records, write_fastq
    from hpgq.options import FilterOptions
    from hpgq.pipeline.run import run_filter
    from hpgq.oracle import spec

    rng_lens = [(40, 100), (150, 260), (300, 380), (60, 90)]
    recs = []
    for i, (lo, hi) in enumerate(rng_lens):
        recs += make_records(150, min_len=lo, max_len=hi, seed=i, n_prob=0.02)
    fq = str(tmp_path / "mix.fq")
    write_fastq(fq, recs)

    o = FilterOptions()
    o.in_filename = fq
    o.out_dirname = str(tmp_path / "out")
    import os
    os.makedirs(o.out_dirname)
    o.quality_encoding_value = 33
    o.quality_encoding_name = "phred33"
    o.batch_size = 100   # forces many small batches across buckets
    o.criteria.min_read_length = 80
    o.criteria.max_read_length = 350
    o.criteria.min_read_quality = 15
    o.criteria.max_read_quality = 40
    res = run_filter(o)

    # oracle verdict per record (substituted thresholds, like the pipeline)
    crit = o.criteria.substituted()
    want_pass = 0
    for _, seq, qual in recs:
        v = spec.filter_verdict(seq, qual, crit, 33)
        want_pass += int(v)
    assert res["num_passed"] == want_pass
    assert res["num_passed"] + res["num_failed"] == len(recs)


def test_cli_prepro_equals_equivalent_edit(tmp_path, capsys):
    """`prepro` (legacy --prep, old/README:73-106) == an edit run with the
    same windows, emitted as <input>.valid."""
    path = _fastq(tmp_path, n=300, min_len=40, max_len=80, seed=61)
    po, eo = tmp_path / "p", tmp_path / "e"
    po.mkdir(), eo.mkdir()
    rc = main(["prepro", "-f", path, "-o", str(po),
               "--ltrim-nts", "5", "--rtrim-nts", "3",
               "--min-quality", "27", "--max-quality", "64"])
    assert rc == 0
    stdout = capsys.readouterr().out
    assert "Num. preprocessed reads" in stdout
    assert "in.fq.valid" in stdout
    rc = main(["edit", "-f", path, "-o", str(eo),
               "--left-length", "5", "--left-quality-range", "27,64",
               "--right-length", "3", "--right-quality-range", "27,64"])
    assert rc == 0
    assert (po / "in.fq.valid").read_bytes() == (eo / "edit.fq").read_bytes()


def test_cli_prepro_paired(tmp_path, capsys):
    p1 = _fastq(tmp_path, "m1.fq", n=200, min_len=50, max_len=70, seed=62)
    p2 = _fastq(tmp_path, "m2.fq", n=200, min_len=50, max_len=70, seed=63)
    out = tmp_path / "o"
    out.mkdir()
    rc = main(["prepro", "--fq1", p1, "--fq2", p2, "-o", str(out),
               "--ltrim-nts", "4"])
    assert rc == 0
    v1 = (out / "m1.fq.valid").read_bytes()
    v2 = (out / "m2.fq.valid").read_bytes()
    assert v1.count(b"\n") == 800 and v2.count(b"\n") == 800
    # mate 1 trims match the oracle (quality range = defaults 20,60)
    crit = FilterCriteria(
        left_length=4, min_left_quality=20, max_left_quality=60
    ).substituted()
    with open(p1, "rb") as f:
        raw = f.read().split(b"\n")
    expected = []
    for i in range(0, len(raw) - 1, 4):
        name, seq, plus, qual = raw[i : i + 4]
        lt, rt = spec.trim_lengths(seq, qual, crit)
        expected.append(name + b"\n" + seq[lt:len(seq) - rt] + b"\n" + plus
                        + b"\n" + qual[lt:len(qual) - rt] + b"\n")
    assert v1 == b"".join(expected)


def test_cli_prepro_validation(tmp_path, capsys):
    path = _fastq(tmp_path, n=50, min_len=40, max_len=60, seed=64)
    out = tmp_path / "o"
    out.mkdir()
    # no trim options -> clean exit like edit's "nothing to edit"
    with pytest.raises(SystemExit):
        main(["prepro", "-f", path, "-o", str(out)])
    capsys.readouterr()
    # 1/4-of-min-read-length rule (old/main_hpg_fastq_old.c:680-690)
    with pytest.raises(SystemExit):
        main(["prepro", "-f", path, "-o", str(out), "--ltrim-nts", "20"])
    capsys.readouterr()
    # quality clamps (old/main_hpg_fastq_old.c:289-305): 5 -> 10, 99 -> 70
    rc = main(["prepro", "-f", path, "-o", str(out), "--ltrim-nts", "2",
               "--min-quality", "5", "--max-quality", "99"])
    assert rc == 0
    assert "Quality range            : 10,70" in capsys.readouterr().out


def test_reader_batch_auto(monkeypatch):
    """Default --batch-size auto-upgrades reader blocks on accelerators only;
    explicit values are always honored."""
    import jax

    from hpgq.options import StatsOptions
    from hpgq.pipeline import run as runmod

    o = StatsOptions()  # defaults: batch_size=10000, device_batch_reads=0
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    assert runmod._reader_batch(o) == 131072
    assert runmod._batch_reads(o) == 131072
    monkeypatch.setattr(jax, "default_backend", lambda: "cpu")
    assert runmod._reader_batch(o) == 10000
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    o.batch_size_set = True  # explicit --batch-size 10000: honored exactly
    assert runmod._reader_batch(o) == 10000
    o.batch_size_set = False
    o.checkpoint_path = "ck.npz"  # checkpoint cadence counts blocks
    assert runmod._reader_batch(o) == 10000
    o.checkpoint_path = None
    o.device_batch_reads = 20480  # explicit device rows: no auto upgrade,
    assert runmod._reader_batch(o) == 10000
    assert runmod._batch_reads(o) == 20480  # and honored verbatim as cap
    o.device_batch_reads = 4096
    o.batch_size = 65536
    assert runmod._batch_reads(o) == 4096


def test_cli_filter_legacy_flags(tmp_path, capsys):
    """Legacy getopt filter spellings (old/README:121-142) == the modern
    range-string invocation, byte-identical outputs."""
    path = _fastq(tmp_path, n=400, min_len=40, max_len=80, n_prob=0.02,
                  seed=91)
    a, b = tmp_path / "legacy", tmp_path / "modern"
    a.mkdir(), b.mkdir()
    rc = main(["filter", "-f", path, "-o", str(a),
               "--min-read-length", "45", "--max-read-length", "75",
               "--min-quality", "20", "--max-quality", "65",
               "--max-n-per-read", "1", "--max-nts-mismatch", "30",
               "--lfilter-nts", "10", "--rfilter-nts", "5"])
    assert rc == 0
    capsys.readouterr()
    rc = main(["filter", "-f", path, "-o", str(b),
               "--read-length-range", "45,75",
               "--read-quality-range", "20,65",
               "--max-N", "1", "--max-out-of-quality", "30",
               "--left-length", "10", "--left-quality-range", "20,65",
               "--right-length", "5", "--right-quality-range", "20,65"])
    assert rc == 0
    capsys.readouterr()
    assert (a / "passed.fq").read_bytes() == (b / "passed.fq").read_bytes()
    assert (a / "failed.fq").read_bytes() == (b / "failed.fq").read_bytes()
    # quality clamp: legacy --max-quality 99 -> 70
    c = tmp_path / "clamp"
    c.mkdir()
    rc = main(["filter", "-f", path, "-o", str(c),
               "--min-quality", "5", "--max-quality", "99"])
    assert rc == 0
    assert "Read quality range  : 10,70" in capsys.readouterr().out


def test_cli_legacy_invocation_style(tmp_path, capsys):
    """Legacy single-binary invocations (action flags, no subcommand —
    old/README command-line examples) dispatch to the right subcommands."""
    path = _fastq(tmp_path, n=200, min_len=60, max_len=80, seed=92)
    # prepro example shape (old/README:104-106)
    a = tmp_path / "prep"
    a.mkdir()
    rc = main(["--prep", "--rtrim-nts", "3", "--ltrim-nts", "5",
               "--outdir", str(a), "--fq", path, "--phred-quality", "33",
               "--min-quality", "27", "--max-quality", "64"])
    assert rc == 0
    assert (a / "in.fq.valid").exists()
    capsys.readouterr()
    # filter example shape (old/README:147-148)
    b = tmp_path / "filt"
    b.mkdir()
    rc = main(["--filter", "--lfilter-nts", "10", "--outdir", str(b),
               "--fq", path, "--min-quality", "20", "--max-quality", "65"])
    assert rc == 0
    # legacy naming: <input>.valid/.invalid (old/README:126-131)
    assert (b / "in.fq.valid").exists() and (b / "in.fq.invalid").exists()
    capsys.readouterr()
    # qc + chaos-game combo (old/README:187-188): stats AND cgr outputs,
    # with legacy byte-valued --batch-size converted
    c = tmp_path / "qccg"
    c.mkdir()
    rc = main(["--qc", "--fq", path, "--outdir", str(c), "--kmers",
               "--batch-size", "50000000",
               "--chaos-game", "--k", "4", "--write-gs"])
    assert rc == 0
    assert (c / "in.fq.summary.txt").exists()
    assert (c / "in.fq_k=4_FG.pgm").exists()
    assert (c / "in.fq_k=4.gs").exists()
    capsys.readouterr()
    # conflicting action combo -> clean error
    rc = main(["--filter", "--prep", "--fq", path, "--outdir", str(c)])
    assert rc == -1


def test_cli_legacy_qc_filter_combo(tmp_path, capsys):
    """Legacy --qc --filter: filter, then QC stats over both output sets
    (old/README:144)."""
    path = _fastq(tmp_path, n=200, min_len=50, max_len=70, n_prob=0.02,
                  seed=93)
    out = tmp_path / "o"
    out.mkdir()
    rc = main(["--qc", "--filter", "--fq", path, "--outdir", str(out),
               "--min-quality", "20", "--max-quality", "60",
               "--max-n-per-read", "2"])
    assert rc == 0
    capsys.readouterr()
    assert (out / "in.fq.valid").exists() and (out / "in.fq.invalid").exists()
    # stats reports for BOTH output sets, not filtered again
    sp = (out / "in.fq.valid.summary.txt").read_text()
    sf = (out / "in.fq.invalid.summary.txt").read_text()
    assert "Filter         : Disabled" in sp
    n_pass = (out / "in.fq.valid").read_bytes().count(b"@read_")
    n_fail = (out / "in.fq.invalid").read_bytes().count(b"@read_")
    assert n_pass + n_fail == 200
    assert "Number of reads: %d" % n_pass in sp
    assert "Number of reads: %d" % n_fail in sf


def test_legacy_filter_valid_invalid_names(tmp_path, capsys):
    """Legacy --filter output naming (old/README:126-131): a legacy-style
    invocation writes <input>.valid/<input>.invalid whose BYTES equal the
    modern subcommand's passed.fq/failed.fq — single-end and paired."""
    path = _fastq(tmp_path, n=300, min_len=40, max_len=80, n_prob=0.02,
                  seed=94)
    lg, md = tmp_path / "lg", tmp_path / "md"
    lg.mkdir(), md.mkdir()
    flags = ["--min-quality", "20", "--max-quality", "60",
             "--max-n-per-read", "2"]
    assert main(["--filter", "--fq", path, "--outdir", str(lg)] + flags) == 0
    assert main(["filter", "-f", path, "-o", str(md)] + flags) == 0
    capsys.readouterr()
    assert (lg / "in.fq.valid").read_bytes() == (md / "passed.fq").read_bytes()
    assert (lg / "in.fq.invalid").read_bytes() == (md / "failed.fq").read_bytes()
    assert not (lg / "passed.fq").exists()

    p1 = _fastq(tmp_path, name="p1.fq", n=200, min_len=40, max_len=70, seed=95)
    p2 = _fastq(tmp_path, name="p2.fq", n=200, min_len=40, max_len=70, seed=96)
    lgp, mdp = tmp_path / "lgp", tmp_path / "mdp"
    lgp.mkdir(), mdp.mkdir()
    assert main(["--filter", "--fq1", p1, "--fq2", p2,
                 "--outdir", str(lgp)] + flags) == 0
    assert main(["filter", "--fq1", p1, "--fq2", p2,
                 "-o", str(mdp)] + flags) == 0
    capsys.readouterr()
    for a, b in (("p1.fq.valid", "passed_1.fq"), ("p2.fq.valid", "passed_2.fq"),
                 ("p1.fq.invalid", "failed_1.fq"),
                 ("p2.fq.invalid", "failed_2.fq")):
        assert (lgp / a).read_bytes() == (mdp / b).read_bytes(), (a, b)


def test_legacy_qc_filter_combo_conf_input(tmp_path, capsys):
    """--qc --filter with the input file given via --conf (file overrides
    command line): the combined run's stats legs must look for the SAME
    <input>.valid/.invalid names the filter leg wrote."""
    from gen import make_fastq
    from hpgq.cli.main import main

    fq = str(tmp_path / "cx.fq")
    make_fastq(fq, 200, min_len=50, max_len=70, seed=97)
    conf = tmp_path / "in.conf"
    conf.write_text("fq = %s ;\nmin-quality = 20 ;\nmax-quality = 60 ;\n" % fq)
    out = tmp_path / "o"
    out.mkdir()
    rc = main(["--qc", "--filter", "--conf", str(conf),
               "--outdir", str(out)])
    assert rc == 0
    capsys.readouterr()
    assert (out / "cx.fq.valid").exists() and (out / "cx.fq.invalid").exists()
    assert (out / "cx.fq.valid.summary.txt").exists()
    assert (out / "cx.fq.invalid.summary.txt").exists()


def test_legacy_misc_flags(tmp_path, capsys):
    """Remaining legacy getopt flags: --quality-control action alias,
    --v/--verbose, accepted-but-inert GPU geometry knobs, and negative
    QC position windows refusing cleanly
    (old/main_hpg_fastq_old.c:100-101,131-192)."""
    from gen import make_fastq
    from hpgq.cli.main import main

    fq = str(tmp_path / "lg.fq")
    make_fastq(fq, 300, min_len=50, max_len=90, seed=3)
    out = tmp_path / "o"
    out.mkdir()

    rc = main(["--quality-control", "--fq", fq, "--outdir", str(out),
               "--gpu-num-threads", "512", "--gpu-num-blocks", "16",
               "--gpu-num-devices", "1", "--v"])
    assert rc in (0, None)
    assert (out / "lg.fq.summary.txt").exists()

    with pytest.raises(SystemExit):
        main(["stats", "-f", fq, "-o", str(out), "--start-quality-nt", "-5"])
    assert "must not be negative" in capsys.readouterr().err


def test_legacy_quality_nt_window(tmp_path, capsys):
    """[D8] --start-quality-nt/--end-quality-nt restrict the mean-quality
    and out-of-quality screens to positions [begin, end)
    (old/main_hpg_fastq_old.c:100-101,148-149; reconstructed — PARITY.md).
    The filter pass/fail partition must match the per-read oracle with the
    same window, and differ from the whole-read partition."""
    from gen import make_fastq
    from hpgq.cli.main import main
    from hpgq.io import FastqReader
    from hpgq.options import FilterCriteria
    from hpgq.oracle import spec

    fq = str(tmp_path / "w.fq")
    make_fastq(fq, 400, min_len=30, max_len=100, seed=77)
    out = tmp_path / "o"
    out.mkdir()
    rc = main(["filter", "-f", fq, "-o", str(out),
               "--read-quality-range", "20,23",
               "--start-quality-nt", "10", "--end-quality-nt", "40"])
    assert rc in (0, None)
    capsys.readouterr()

    crit = FilterCriteria(min_read_quality=20, max_read_quality=23,
                          begin_quality_nt=10, end_quality_nt=40).substituted()
    whole = FilterCriteria(min_read_quality=20, max_read_quality=23).substituted()
    with FastqReader(fq, batch_size=10**9) as rd:
        (block,) = list(rd)
    pairs = [(block.sequence(i), block.quality(i))
             for i in range(block.num_reads)]
    want = [spec.filter_verdict(s, q, crit) for s, q in pairs]
    whole_want = [spec.filter_verdict(s, q, whole) for s, q in pairs]
    assert want != whole_want  # the window must actually change the split
    n_pass = (out / "passed.fq").read_bytes().count(b"@read_")
    n_fail = (out / "failed.fq").read_bytes().count(b"@read_")
    assert n_pass == sum(want)
    assert n_fail == len(want) - sum(want)

    # the legacy single-binary argv form with the banner's --begin spelling
    out2 = tmp_path / "o2"
    out2.mkdir()
    rc = main(["--filter", "--fq", fq, "--outdir", str(out2),
               "--min-quality", "20", "--max-quality", "23",
               "--begin-quality-nt=10", "--end-quality-nt=40"])
    assert rc in (0, None)
    capsys.readouterr()
    assert (out2 / "w.fq.valid").read_bytes().count(b"@read_") == sum(want)


def test_legacy_conf_filter_keys(tmp_path):
    """Legacy conf keys (min-quality/max-quality/min-read-length/
    max-n-per-read) reach the FILTER criteria: they map onto the lg_*
    alias dests and the translation runs after the conf is applied."""
    from gen import make_fastq
    from hpgq.cli.main import main

    fq = str(tmp_path / "cf.fq")
    make_fastq(fq, 400, min_len=40, max_len=110, n_prob=0.02, seed=13)
    conf = tmp_path / "legacy.conf"
    conf.write_text(
        "min-quality = 18 ;\nmax-quality = 45 ;\n"
        "min-read-length = 50 ;\nmax-n-per-read = 3 ;\n"
    )
    out = tmp_path / "o"
    out.mkdir()
    rc = main(["filter", "--fq", fq, "-o", str(out), "--conf", str(conf)])
    assert rc in (0, None)
    # equivalent explicit run must partition identically
    out2 = tmp_path / "o2"
    out2.mkdir()
    main(["filter", "--fq", fq, "-o", str(out2),
          "--read-quality-range", "18,45", "--read-length-range", "50,",
          "--max-N", "3"])
    for n in ("passed.fq", "failed.fq"):
        assert (out / n).read_bytes() == (out2 / n).read_bytes(), n


def test_conf_falsy_bool(tmp_path):
    """'kmers = false' in a conf file DISABLES k-mers (bool('false') would
    have enabled it)."""
    from gen import make_fastq
    from hpgq.cli.main import main

    fq = str(tmp_path / "cb.fq")
    make_fastq(fq, 200, min_len=50, max_len=80, seed=14)
    conf = tmp_path / "c.conf"
    conf.write_text("kmers = false ;\n")
    out = tmp_path / "o"
    out.mkdir()
    rc = main(["stats", "-f", fq, "-o", str(out), "--kmers",
               "--conf", str(conf)])
    assert rc in (0, None)
    assert not (out / "cb.fq.kmers.txt").exists()


def test_legacy_qc_with_filter_aliases_and_eq_form(tmp_path):
    """A stock legacy QC command line with filter aliases and the
    '--flag=value' spelling dispatches and filters (the legacy getopt
    table was shared across actions)."""
    from gen import make_fastq
    from hpgq.cli.main import main

    fq = str(tmp_path / "lq.fq")
    make_fastq(fq, 400, min_len=40, max_len=110, n_prob=0.02, seed=15)
    out = tmp_path / "o"
    out.mkdir()
    rc = main(["--qc", "--fq", fq, "--outdir=%s" % out,
               "--min-quality=18", "--max-quality=45"])
    assert rc in (0, None)
    summary = (out / "lq.fq.summary.txt").read_text()
    assert "Filter" in summary
    # inline filtering actually engaged (quality range echoed)
    assert "18" in summary and "45" in summary


def test_fq2_alone_rejected(tmp_path):
    from gen import make_fastq
    from hpgq.cli.main import main

    fq = str(tmp_path / "m2.fq")
    make_fastq(fq, 50, min_len=50, max_len=60, seed=16)
    with pytest.raises(SystemExit):
        main(["stats", "--fq2", fq, "-o", str(tmp_path)])


def test_parse_range_sscanf_prefix():
    """sscanf('%d') semantics: trailing garbage ignored ('80x' -> 80),
    like the reference parser; all-garbage still errors."""
    from hpgq.options import parse_range

    assert parse_range("80x,110", "read length range") == (80, 110)
    assert parse_range(" 20 ,40y", "q") == (20, 40)
    with pytest.raises(SystemExit):
        parse_range("x,40", "q")
