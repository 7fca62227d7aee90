"""Frozen golden-file byte-equality tests.

The reference binary cannot be built (its submodules are empty), so these
goldens freeze the CURRENT oracle-validated output bytes of every report /
filter / edit / CGR format: any future format drift — however small — turns
these red.  The corpora are deterministic (tests/gen.py, fixed seeds), and
the pipeline runs through the real CLI entry points on CPU (conftest).

Regenerate deliberately (after an intentional format change) with:

    HPGQ_REGEN_GOLDEN=1 python -m pytest tests/test_golden.py -q

and review the diff before committing.
"""

import os
import shutil

import pytest

from gen import make_fastq

from hpgq.cli.main import main

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")
REGEN = bool(os.environ.get("HPGQ_REGEN_GOLDEN"))


def _corpus(tmp_path, name="in.fq", n=300, **kw):
    kw.setdefault("min_len", 40)
    kw.setdefault("max_len", 60)
    kw.setdefault("n_prob", 0.02)
    kw.setdefault("lowercase_prob", 0.05)
    kw.setdefault("seed", 77)
    path = str(tmp_path / name)
    make_fastq(path, n, **kw)
    return path


def _normalize(data: bytes, outdir: str) -> bytes:
    """Replace the run's absolute output dir (embedded in .gnuplot scripts)
    with a stable placeholder so goldens are location-independent."""
    return data.replace(os.path.abspath(outdir).encode(), b"<OUTDIR>").replace(
        outdir.encode(), b"<OUTDIR>"
    )


def _check_tree(outdir: str, golden_sub: str, last: bool = True):
    """Byte-compare every file under outdir with tests/golden/<golden_sub>.
    Pass ``last=False`` for all but a test's final tree so regeneration
    reaches every tree before skipping."""
    gdir = os.path.join(GOLDEN, golden_sub)
    if REGEN:
        shutil.rmtree(gdir, ignore_errors=True)
        os.makedirs(gdir)
        for name in sorted(os.listdir(outdir)):
            with open(os.path.join(outdir, name), "rb") as f:
                data = _normalize(f.read(), outdir)
            with open(os.path.join(gdir, name), "wb") as f:
                f.write(data)
        if not last:
            return
        pytest.skip("goldens regenerated; review the diff")
    assert os.path.isdir(gdir), "missing golden dir %s" % gdir
    got = sorted(os.listdir(outdir))
    want = sorted(os.listdir(gdir))
    assert got == want, "file set drift: %r vs golden %r" % (got, want)
    for name in want:
        with open(os.path.join(outdir, name), "rb") as f:
            g = _normalize(f.read(), outdir)
        with open(os.path.join(gdir, name), "rb") as f:
            w = f.read()
        assert g == w, "golden byte drift in %s" % name


def test_golden_stats_kmers_filtered(tmp_path):
    path = _corpus(tmp_path)
    out = tmp_path / "out"
    out.mkdir()
    rc = main([
        "stats", "-f", path, "-o", str(out), "--kmers",
        "--read-length-range", "45,58", "--max-N", "3",
    ])
    assert rc == 0
    _check_tree(str(out), "stats")


def test_golden_filter(tmp_path):
    path = _corpus(tmp_path)
    out = tmp_path / "out"
    out.mkdir()
    rc = main([
        "filter", "-f", path, "-o", str(out),
        "--read-quality-range", "20,40", "--max-N", "2",
    ])
    assert rc == 0
    _check_tree(str(out), "filter")


def test_golden_edit(tmp_path):
    path = _corpus(tmp_path)
    out = tmp_path / "out"
    out.mkdir()
    rc = main([
        "edit", "-f", path, "-o", str(out),
        "--left-length", "8", "--left-quality-range", "28,60",
        "--right-length", "6", "--right-quality-range", "28,60",
        "--read-quality-range", "20,45",
    ])
    assert rc == 0
    _check_tree(str(out), "edit")


def test_golden_cgr(tmp_path):
    path = _corpus(tmp_path, name="cg.fq", seed=78)
    out = tmp_path / "out"
    out.mkdir()
    rc = main(["cgr", "-f", path, "-o", str(out), "--k", "5"])
    assert rc == 0
    _check_tree(str(out), "cgr")


def test_golden_cgr_gs_and_diff(tmp_path):
    """Freeze the .gs signature bytes and the FG_dif.pgm diff-vs-reference
    flow (chaos_game_load_table_gs / _calculate_table_dif, old/chaos_game.c
    :269-372): corpus A writes its signature, corpus B diffs against it."""
    a = _corpus(tmp_path, name="ga.fq", seed=79)
    b = _corpus(tmp_path, name="gb.fq", seed=80)
    out_a, out_b = tmp_path / "oa", tmp_path / "ob"
    out_a.mkdir(), out_b.mkdir()
    rc = main(["cgr", "-f", a, "-o", str(out_a), "--k", "5", "--write-gs"])
    assert rc == 0
    _check_tree(str(out_a), "cgr_gs", last=False)
    gs = os.path.join(str(out_a), "ga.fq_k=5.gs")
    rc = main(["cgr", "-f", b, "-o", str(out_b), "--k", "5",
               "--gs-filename", gs])
    assert rc == 0
    _check_tree(str(out_b), "cgr_diff")


def test_golden_prepro(tmp_path):
    path = _corpus(tmp_path)
    out = tmp_path / "out"
    out.mkdir()
    rc = main(["prepro", "-f", path, "-o", str(out),
               "--ltrim-nts", "5", "--rtrim-nts", "3",
               "--min-quality", "27", "--max-quality", "64"])
    assert rc == 0
    _check_tree(str(out), "prepro")
