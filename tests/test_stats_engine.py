"""Differential tests: the jnp stats step vs the numpy block oracle.

``hpgq.oracle.baseline.block_stats`` / ``block_verdicts`` compute the same
counters in int64 numpy; the device step (``stats_jnp.make_stats_step``)
must match them exactly on every integer field, and on the f32
``acc_quality`` sum to the 1e-5 relative tolerance of
``StatsCounters.equals``.  The cases cover batch shapes, the inline filter
and the legacy quality window, long reads, all-invalid batches, an ``lcap``
wider than the batch, k-mers, the int32 sentinel overflow guard, the
multi-batch step contract, and the fused4 wire through the step.
"""

import dataclasses

import numpy as np
import pytest

from hpgq.constants import PHRED33
from hpgq.core.accumulator import fold_partials
from hpgq.core.counters import StatsCounters
from hpgq.kernels import stats_jnp
from hpgq.options import FilterCriteria
from hpgq.oracle import baseline


def _rand_batch(B, L, seed=0, with_n=True, varlen=True):
    rng = np.random.default_rng(seed)
    lens = (
        rng.integers(1, L + 1, size=B) if varlen else np.full(B, L)
    ).astype(np.int32)
    codes = rng.integers(0, 4, size=(B, L)).astype(np.int8)
    if with_n:
        codes[rng.random((B, L)) < 0.02] = 4
    pos = np.arange(L)[None, :]
    codes = np.where(pos < lens[:, None], codes, np.int8(5))
    quals = np.where(
        pos < lens[:, None], rng.integers(33, 74, size=(B, L)), 0
    ).astype(np.uint8)
    valid = rng.random(B) < 0.9
    return codes, quals, lens, valid


CRIT = FilterCriteria(
    min_read_length=10, max_read_length=100,
    min_read_quality=5, max_read_quality=45,
    left_length=8, min_left_quality=10, max_left_quality=60,
    right_length=8, min_right_quality=10, max_right_quality=60,
    max_out_of_quality=30, max_N=3,
)
# [D8] legacy quality position window active (screens see [12, 60) only)
WCRIT = dataclasses.replace(CRIT, begin_quality_nt=12, end_quality_nt=60)
CRITS = pytest.mark.parametrize("crit", [None, CRIT, WCRIT],
                                ids=["plain", "filtered", "qwindow"])


def _step_counters(batches, lcap, crit=None, kmers_on=False, jit=False,
                   wire=None):
    """Run ``batches`` through one step, fold the device partials into
    int64 counters."""
    step = stats_jnp.make_stats_step(lcap, PHRED33, kmers_on, crit, jit=jit,
                                     donate=False, wire=wire)
    acc = stats_jnp.zero_partials(lcap, kmers_on)
    for batch in batches:
        acc = step(acc, *batch)
    c = StatsCounters(phred=PHRED33, kmers_on=kmers_on)
    c.filter_on = crit is not None
    fold_partials(c, {k: np.asarray(v) for k, v in acc.items()})
    return c


def _oracle_counters(batches, crit=None, kmers_on=False):
    """The numpy oracle over the same batches: verdicts select the reads
    the stats cover, and the pass/fail tallies count valid rows."""
    c = StatsCounters(phred=PHRED33, kmers_on=kmers_on)
    c.filter_on = crit is not None
    for codes, quals, lens, valid in batches:
        sel = valid
        if crit is not None:
            ok = baseline.block_verdicts(codes, quals, lens, crit, PHRED33)
            sel = valid & ok
            c.num_passed += int(sel.sum())
            c.num_failed += int((valid & ~ok).sum())
        part = baseline.block_stats(codes, quals, lens, sel,
                                    kmers_on=kmers_on, phred=PHRED33)
        part.num_passed = part.num_failed = 0
        c.merge(part)
    return c


def _check(batches, lcap, crit=None, **kw):
    got = _step_counters(batches, lcap, crit, **kw)
    want = _oracle_counters(batches, crit, kw.get("kmers_on", False))
    assert got.equals(want)
    return got


@CRITS
@pytest.mark.parametrize("B,L", [(256, 128), (768, 128), (100, 256)])
def test_partials_match_oracle(B, L, crit):
    got = _check([_rand_batch(B, L, seed=B + L)], max(L, 128), crit)
    if crit is not None:
        assert 0 < got.num_passed < got.num_passed + got.num_failed


def test_all_invalid_rows():
    codes, quals, lens, _ = _rand_batch(256, 128, seed=3)
    valid = np.zeros(256, dtype=bool)
    got = _check([(codes, quals, lens, valid)], 128)
    assert got.num_reads == 0
    assert got.max_length == 0
    assert int(got.length_hist.sum()) == 0


def test_lcap_larger_than_l():
    _check([_rand_batch(64, 128, seed=5)], 384)


def test_kmers_ride_along():
    got = _check([_rand_batch(256, 128, seed=9)], 128, kmers_on=True)
    assert int(got.kmer_counts.sum()) > 0


@CRITS
@pytest.mark.parametrize("B,L,lcap", [
    (256, 4608, 4608),     # long reads, one bucket
    (100, 8192, 8192),     # rows that are not a power of two
    (64, 4608, 8192),      # lcap wider than the batch L
])
def test_long_reads_match_oracle(B, L, lcap, crit):
    """Long-read lengths (SURVEY §5 long-context row) through the same
    step at lcap in the thousands."""
    _check([_rand_batch(B, L, seed=B + L)], lcap, crit)


def test_long_read_max_sentinel_no_overflow():
    """Reads longer than ~21474 nt with an unset max quality threshold
    (substituted MAX sentinel 100000): the sentinel multiply would wrap
    int32 and fail every read — the step must skip the vacuous check."""
    L, B = 24576, 32
    # only a MIN threshold set -> max_read_quality substitutes to 100000
    crit = FilterCriteria(min_read_quality=5)
    rng = np.random.default_rng(77)
    lens = np.full(B, L, np.int32)  # every read deep in overflow range
    codes = rng.integers(0, 4, size=(B, L)).astype(np.int8)
    quals = rng.integers(40, 70, size=(B, L)).astype(np.uint8)
    valid = rng.random(B) < 0.9
    got = _check([(codes, quals, lens, valid)], L, crit)
    assert got.num_passed == int(valid.sum())
    assert got.num_failed == 0


def test_long_reads_through_jitted_step():
    """The jitted, donated step at a long-read lcap == the oracle."""
    _check([_rand_batch(256, 4608, seed=31)], 4608, CRIT, jit=True)


def test_stats_step_contract_across_batches():
    """Two batches accumulate into one device pytree (merge_into, Kahan
    acc_quality), with and without the inline filter."""
    codes, quals, lens, valid = _rand_batch(512, 128, seed=11)
    batches = [(codes[s:s + 256], quals[s:s + 256], lens[s:s + 256],
                valid[s:s + 256]) for s in (0, 256)]
    for crit in (None, CRIT):
        _check(batches, 128, crit, jit=True)


def test_fused4_wire_through_step():
    """The fused4 single-buffer wire decodes on device inside the step."""
    codes, quals, lens, valid = _rand_batch(256, 128, seed=21)
    buf = stats_jnp.wire_fuse(codes, quals, lens, valid)
    for crit in (None, CRIT):
        got = _step_counters([(buf,)], 128, crit, wire="fused4")
        assert got.equals(_oracle_counters([(codes, quals, lens, valid)],
                                           crit))
