"""JAX (jnp) compute kernels: per-batch stats partials, filter verdicts, trims.

This is the engine's compute path, left to XLA to fuse.  It is tested
against the numpy baseline and the per-read oracle spec (decision tags
[D1]..[D6] in ``hpgq.oracle.spec``).

Everything here is trace-safe: static shapes ``[B, L]``, no data-dependent
Python control flow, int32 device arithmetic (host folds into int64 before
overflow — see ``hpgq.core.accumulator``).

Replaces the reference's serial consumer merge (``src/stats_fastq.c:257-417``)
with vectorized one-hot reductions + scatter-adds, and the ``fastq_filter`` /
``fastq_edit`` per-read loops with masked reductions (SURVEY §2.2-2.3 P2/P5).
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp

from ..constants import (
    BASE_C,
    BASE_G,
    BASE_N,
    KMER_K,
    MAX_VALUE,
    MIN_VALUE,
    NUM_KMERS,
    PHRED33,
)
from ..core.counters import GC_BINS, QUAL_BINS
from ..options import FilterCriteria

MIN_LENGTH_INIT = 100000  # reference init, src/stats_fastq.c:24


# ---------------------------------------------------------------------------
# partials pytree
# ---------------------------------------------------------------------------

def zero_partials(lcap: int, kmers_on: bool = False):
    """Zero-initialized device accumulator pytree (all int32 except noted)."""
    p = {
        "num_reads": jnp.zeros((), jnp.int32),
        "num_passed": jnp.zeros((), jnp.int32),
        "num_failed": jnp.zeros((), jnp.int32),
        "acc_length": jnp.zeros((), jnp.int32),
        "min_length": jnp.full((), MIN_LENGTH_INIT, jnp.int32),
        "max_length": jnp.zeros((), jnp.int32),
        # Kahan-compensated f32 sum of per-read mean raw qualities [D1]
        "acc_quality": jnp.zeros((), jnp.float32),
        "acc_quality_comp": jnp.zeros((), jnp.float32),
        "base_totals": jnp.zeros((5,), jnp.int32),  # A C G T N
        "length_hist": jnp.zeros((lcap + 1,), jnp.int32),
        "quality_hist": jnp.zeros((QUAL_BINS,), jnp.int32),
        "gc_hist": jnp.zeros((GC_BINS,), jnp.int32),
        "cov_per_nt": jnp.zeros((lcap,), jnp.int32),
        "qual_per_nt": jnp.zeros((lcap,), jnp.int32),
        "base_per_nt": jnp.zeros((5, lcap), jnp.int32),
    }
    if kmers_on:
        p["kmer_counts"] = jnp.zeros((NUM_KMERS,), jnp.int32)
        p["kmer_per_nt"] = jnp.zeros((NUM_KMERS, lcap), jnp.int32)
    return p


# ---------------------------------------------------------------------------
# shared masked reductions
# ---------------------------------------------------------------------------

def _pos_iota(B: int, L: int):
    return jax.lax.broadcasted_iota(jnp.int32, (B, L), 1)


def read_reductions(codes, quals, lens):
    """(mask, qsum[B], nG+nC[B], nN[B]) masked per-read reductions."""
    B, L = codes.shape
    mask = _pos_iota(B, L) < lens[:, None]
    q = quals.astype(jnp.int32)
    qsum = jnp.where(mask, q, 0).sum(axis=1)
    gc = ((codes == BASE_G) | (codes == BASE_C)) & mask
    ngc = gc.sum(axis=1, dtype=jnp.int32)
    nn = ((codes == BASE_N) & mask).sum(axis=1, dtype=jnp.int32)
    return mask, qsum, ngc, nn


def _window_sums(quals, lens, left_len: int, right_len: int, mask):
    """Left/right window quality sums and widths [D3]."""
    B, L = quals.shape
    q = jnp.where(mask, quals.astype(jnp.int32), 0)
    pos = _pos_iota(B, L)
    out = {}
    if left_len > 0:
        w = jnp.minimum(lens, left_len)
        lmask = pos < w[:, None]
        out["left"] = (jnp.where(lmask, q, 0).sum(axis=1), w)
    if right_len > 0:
        w = jnp.minimum(lens, right_len)
        rmask = pos >= (lens - w)[:, None]
        out["right"] = (jnp.where(rmask & mask, q, 0).sum(axis=1), w)
    return out


# ---------------------------------------------------------------------------
# filter / edit kernels
# ---------------------------------------------------------------------------

def verdicts(codes, quals, lens, crit: FilterCriteria, phred: int = PHRED33):
    """fastq_filter predicate, vectorized — bool [B].  [D2][D3]

    ``crit`` values are Python ints (static under jit via closure).
    """
    crit = crit.substituted()
    B, L = codes.shape
    mask, qsum, ngc, nn = read_reductions(codes, quals, lens)
    del ngc
    lens32 = lens.astype(jnp.int32)

    ok = (lens32 >= crit.min_read_length) & (lens32 <= crit.max_read_length)

    # [D8] legacy quality position window (--start/--end-quality-nt):
    # the two quality screens evaluate positions [begin, end) ∩ [0, len);
    # default 0/1024 keeps the whole-read fast path.
    if crit.quality_window_on:
        pos = _pos_iota(B, L)
        qwmask = mask & (pos >= crit.begin_quality_nt) & (pos < crit.end_quality_nt)
        wlen = qwmask.sum(axis=1, dtype=jnp.int32)
        wqsum = jnp.where(qwmask, quals.astype(jnp.int32), 0).sum(axis=1)
    else:
        qwmask = mask
        wlen = lens32
        wqsum = qsum

    qn = wqsum - phred * wlen
    # Overflow care: the substituted MAX sentinel (100000) times a long read
    # length wraps int32 (reads > ~21 kb), but the check is vacuous then
    # (qn <= 126*len < 100000*len always) — skip it.  The MIN sentinel (0)
    # is NOT vacuous (qn < 0 when quality bytes sit below the offset):
    # express it multiply-free.  Set thresholds (<~130) are safe to ~16 Mb.
    if crit.min_read_quality != MIN_VALUE:
        ok &= crit.min_read_quality * wlen <= qn
    else:
        ok &= qn >= 0
    if crit.max_read_quality != MAX_VALUE:
        ok &= qn <= crit.max_read_quality * wlen

    if crit.max_out_of_quality != MAX_VALUE:
        nq = quals.astype(jnp.int32) - phred
        out_of = (
            ((nq < crit.min_read_quality) | (nq > crit.max_read_quality)) & qwmask
        ).sum(axis=1, dtype=jnp.int32)
        ok &= out_of <= crit.max_out_of_quality

    wins = _window_sums(
        quals, lens32,
        crit.left_length if crit.left_length > MIN_VALUE else 0,
        crit.right_length if crit.right_length > MIN_VALUE else 0,
        mask,
    )
    if "left" in wins:
        ls, w = wins["left"]
        lqn = ls - phred * w
        if crit.min_left_quality != MIN_VALUE:
            ok &= crit.min_left_quality * w <= lqn
        else:
            ok &= lqn >= 0
        if crit.max_left_quality != MAX_VALUE:
            ok &= lqn <= crit.max_left_quality * w
    if "right" in wins:
        rs, w = wins["right"]
        rqn = rs - phred * w
        if crit.min_right_quality != MIN_VALUE:
            ok &= crit.min_right_quality * w <= rqn
        else:
            ok &= rqn >= 0
        if crit.max_right_quality != MAX_VALUE:
            ok &= rqn <= crit.max_right_quality * w

    ok &= nn <= crit.max_N
    return ok


def trims(quals, lens, crit: FilterCriteria, phred: int = PHRED33):
    """fastq_edit trim decision — (ltrim, rtrim) int32 [B].  [D4]"""
    crit = crit.substituted()
    B, L = quals.shape
    mask = _pos_iota(B, L) < lens[:, None]
    lens32 = lens.astype(jnp.int32)
    lt = jnp.zeros((B,), jnp.int32)
    rt = jnp.zeros((B,), jnp.int32)
    wins = _window_sums(
        quals, lens32,
        crit.left_length if crit.left_length > MIN_VALUE else 0,
        crit.right_length if crit.right_length > MIN_VALUE else 0,
        mask,
    )
    def window_bad(qn, w, lo, hi):
        # sentinel-aware (see verdicts): MIN=0 -> qn < 0 multiply-free;
        # MAX sentinel check is vacuous (qn <= 126*w) and would overflow
        # int32 for very large windows — skip it
        bad = (qn < lo * w) if lo != MIN_VALUE else (qn < 0)
        if hi != MAX_VALUE:
            bad |= qn > hi * w
        return bad

    if "left" in wins:
        ls, w = wins["left"]
        bad = window_bad(ls - phred * w, w,
                         crit.min_left_quality, crit.max_left_quality)
        lt = jnp.where(bad, w, 0)
    if "right" in wins:
        rs, w = wins["right"]
        bad = window_bad(rs - phred * w, w,
                         crit.min_right_quality, crit.max_right_quality)
        rt = jnp.where(bad, w, 0)
    rt = jnp.minimum(rt, lens32 - lt)
    return lt, rt


def apply_trims(codes, quals, lens, lt, rt):
    """Shift-trim packed arrays on device (gather; edit re-stats path)."""
    B, L = codes.shape
    new_lens = lens - lt - rt
    pos = _pos_iota(B, L)
    src = jnp.minimum(pos + lt[:, None], L - 1)
    nc = jnp.take_along_axis(codes, src, axis=1)
    nq = jnp.take_along_axis(quals, src, axis=1)
    keep = pos < new_lens[:, None]
    nc = jnp.where(keep, nc, jnp.int8(5))
    nq = jnp.where(keep, nq, jnp.uint8(0))
    return nc, nq, new_lens


# ---------------------------------------------------------------------------
# stats partials
# ---------------------------------------------------------------------------

def kmer_codes(codes, lens):
    """[D5] per-window 5-mer codes and validity — ([B, W], [B, W])."""
    B, L = codes.shape
    W = L - KMER_K + 1
    kc = jnp.zeros((B, W), jnp.int32)
    ok = jnp.ones((B, W), jnp.bool_)
    for i in range(KMER_K):
        part = codes[:, i : i + W].astype(jnp.int32)
        kc = kc * 4 + jnp.minimum(part, 3)
        ok &= part < 4
    pos = jax.lax.broadcasted_iota(jnp.int32, (B, W), 1)
    ok &= (pos + KMER_K) <= lens[:, None]
    return kc, ok


def _vary(x, axis):
    """Mark a constant as varying over a shard_map manual axis (vma typing:
    scan carries initialized from constants must match varying outputs)."""
    if axis is None:
        return x
    return jax.lax.pcast(x, (axis,), to="varying")


def kmer_hist2d(kc, ok, lcap: int, vary_axis=None):
    """2D (kmer, position) histogram: an O(B*W) int32 scatter-add, exact
    under colliding indices.  Invalid windows route to a sacrificial
    overflow row."""
    B, W = kc.shape
    kcm = jnp.where(ok, kc, NUM_KMERS)
    pos = jax.lax.broadcasted_iota(jnp.int32, (B, W), 1)
    out = _vary(jnp.zeros((NUM_KMERS + 1, W), jnp.int32), vary_axis)
    out = out.at[kcm, pos].add(1)[:NUM_KMERS]
    if W < lcap:
        out = jnp.pad(out, ((0, 0), (0, lcap - W)))
    else:
        out = out[:, :lcap]
    return out


def batch_partials(codes, quals, lens, valid, lcap: int, phred: int,
                   kmers_on: bool = False, vary_axis=None):
    """All per-batch statistics → partials pytree (no min/max init fields)."""
    B, L = codes.shape
    assert L <= lcap
    mask, qsum, ngc, nn = read_reductions(codes, quals, lens)
    lens32 = lens.astype(jnp.int32)
    v32 = valid.astype(jnp.int32)

    base_counts = jnp.stack(
        [((codes == c) & mask).sum(axis=1, dtype=jnp.int32) for c in range(5)]
    )  # [5, B]

    mean_q = jnp.where(
        lens32 > 0, qsum.astype(jnp.float32) / lens32.astype(jnp.float32), 0.0
    )

    p = {}
    p["num_reads"] = v32.sum()
    p["acc_length"] = (lens32 * v32).sum()
    p["min_length"] = jnp.where(valid, lens32, MIN_LENGTH_INIT).min()
    p["max_length"] = jnp.where(valid, lens32, 0).max()
    p["acc_quality"] = jnp.where(valid, mean_q, 0.0).sum()
    p["base_totals"] = (base_counts * v32[None, :]).sum(axis=1)

    lh = jnp.zeros((lcap + 1,), jnp.int32)
    p["length_hist"] = lh.at[jnp.clip(lens32, 0, lcap)].add(v32)

    # [D1] integer round-half-up of the rational mean — backend-exact
    qkey = jnp.clip(
        (2 * qsum + lens32) // jnp.maximum(2 * lens32, 1), 0, QUAL_BINS - 1
    )
    p["quality_hist"] = jnp.zeros((QUAL_BINS,), jnp.int32).at[qkey].add(v32)

    # zero-length reads take no GC key (the reference would divide by zero)
    gkey = (100 * (base_counts[BASE_G] + base_counts[BASE_C])) // jnp.maximum(lens32, 1)
    gkey = jnp.clip(gkey, 0, GC_BINS - 1)
    gweight = v32 * (lens32 > 0).astype(jnp.int32)
    p["gc_hist"] = jnp.zeros((GC_BINS,), jnp.int32).at[gkey].add(gweight)

    vmask = mask & valid[:, None]
    cov = vmask.sum(axis=0, dtype=jnp.int32)
    qpn = jnp.where(vmask, quals.astype(jnp.int32), 0).sum(axis=0)
    bpn = jnp.stack(
        [((codes == c) & vmask).sum(axis=0, dtype=jnp.int32) for c in range(5)]
    )
    pad = lcap - L
    p["cov_per_nt"] = jnp.pad(cov, (0, pad))
    p["qual_per_nt"] = jnp.pad(qpn, (0, pad))
    p["base_per_nt"] = jnp.pad(bpn, ((0, 0), (0, pad)))

    if kmers_on:
        if L >= KMER_K:
            kc, ok = kmer_codes(codes, lens32)
            ok &= valid[:, None]
            k2d = kmer_hist2d(kc, ok, lcap, vary_axis=vary_axis)
        else:
            k2d = jnp.zeros((NUM_KMERS, lcap), jnp.int32)
        p["kmer_per_nt"] = k2d
        p["kmer_counts"] = k2d.sum(axis=1)
    return p


def merge_into(acc, p):
    """Accumulate batch partials into the running accumulator pytree."""
    out = dict(acc)
    out["num_reads"] = acc["num_reads"] + p["num_reads"]
    out["acc_length"] = acc["acc_length"] + p["acc_length"]
    out["min_length"] = jnp.minimum(acc["min_length"], p["min_length"])
    out["max_length"] = jnp.maximum(acc["max_length"], p["max_length"])
    # Kahan step for the f32 mean-quality sum
    y = p["acc_quality"] - acc["acc_quality_comp"]
    t = acc["acc_quality"] + y
    out["acc_quality_comp"] = (t - acc["acc_quality"]) - y
    out["acc_quality"] = t
    for k in (
        "base_totals", "length_hist", "quality_hist", "gc_hist",
        "cov_per_nt", "qual_per_nt", "base_per_nt", "kmer_counts", "kmer_per_nt",
    ):
        if k in acc and k in p:
            out[k] = acc[k] + p[k]
    return out


# Compiled-step cache: jax.jit caches traces per function *object*, so a
# fresh closure per pipeline run would retrace and recompile every time.
# Key = full static config.
_STEP_CACHE: dict = {}


def _crit_key(crit):
    import dataclasses

    return None if crit is None else dataclasses.astuple(crit)


def wire_pack4(codes):
    """Nibble-pack base codes (values 0..5 fit 4 bits): [B, L] int8 ->
    [B, L//2] uint8, even position in the low nibble.

    This cuts the codes' host->device bytes in half — 25% of the total
    batch — at the price of one trivial unpack op on device."""
    import numpy as np

    c = np.asarray(codes, dtype=np.uint8)
    return (c[:, 0::2] | (c[:, 1::2] << 4)).astype(np.uint8)


def wire_unpack4(packed):
    """Device-side inverse of :func:`wire_pack4` -> [B, L] int8."""
    p = packed.astype(jnp.uint8)
    B, H = p.shape
    lo = (p & 0xF).astype(jnp.int8)
    hi = (p >> 4).astype(jnp.int8)
    return jnp.stack([lo, hi], axis=2).reshape(B, 2 * H)


def wire_fuse(codes, quals, lens, valid):
    """One uint8 wire buffer per batch: row = [codes4 | quals | len_le32 |
    valid | pad3] — a single host->device transfer instead of four."""
    import numpy as np

    B, L = quals.shape
    assert L % 2 == 0
    c4 = codes if codes.shape[1] == L // 2 else wire_pack4(codes)
    lens_b = np.ascontiguousarray(lens, dtype="<i4").view(np.uint8).reshape(B, 4)
    return np.concatenate(
        [
            np.ascontiguousarray(c4, dtype=np.uint8),
            np.ascontiguousarray(quals, dtype=np.uint8),
            lens_b,
            np.asarray(valid, dtype=np.uint8).reshape(B, 1),
            np.zeros((B, 3), dtype=np.uint8),
        ],
        axis=1,
    )


def fused_logical_len(row_width: int) -> int:
    """Logical read length L encoded by a fused wire row (W = L/2 + L + 8)."""
    return (row_width - 8) * 2 // 3


def wire_unfuse(buf):
    """Device-side inverse of :func:`wire_fuse` -> (codes, quals, lens, valid).
    L is recovered from the row width (W = L/2 + L + 8)."""
    B, W = buf.shape
    L = fused_logical_len(W)
    L2 = L // 2
    codes = wire_unpack4(buf[:, :L2])
    quals = buf[:, L2 : L2 + L]
    lb = buf[:, L2 + L : L2 + L + 4].astype(jnp.int32)
    lens = lb[:, 0] | (lb[:, 1] << 8) | (lb[:, 2] << 16) | (lb[:, 3] << 24)
    valid = buf[:, L2 + L + 4] != 0
    return codes, quals, lens, valid


def bitwire_kind(row_width: int):
    """(qual_bits, L) for a bitpack-family wire row width.

    Four layouts, distinguished by width alone (each adaptive family's
    width function bumps past the others' valid widths, so membership
    tests are exact — see ``hpgq.io.native.bitwire6_width`` /
    ``bitwire2q_width`` / ``bitwire2c_width``):

    * 7-bit quals: W = 10L/8 + 8 exactly.
    * 6-bit re-based quals: W = 9L/8 + 8 (+1 pad on 7-bit collision).
    * 2-bit palette indices (qual_bits returned as 2): W = 5L/8 + 12
      (+pads past any 7-/6-bit collision).
    * 2c — 2-bit codes + 2-bit palette indices (qual_bits returned as
      the sentinel -2): W = 4L/8 + 12 (+pads past the other families).
      A 2c buffer cannot be decoded alone — its codes need the exception
      sidecar (:func:`wire_unbits2c`)."""
    from ..io.native import bitwire2c_width, bitwire2q_width, bitwire6_width

    body = (row_width - 8) * 8
    if body % 10 == 0 and (body // 10) % 8 == 0:
        return 7, body // 10
    L6 = (body // 9) // 8 * 8
    if L6 > 0 and bitwire6_width(L6) == row_width:
        return 6, L6
    m = (row_width - 12) // 5
    for mm in (m, m - 1):
        if mm >= 1 and bitwire2q_width(8 * mm) == row_width:
            return 2, 8 * mm
    for d in range(4):  # collision pads bump W by up to a few bytes
        L2 = 2 * (row_width - d - 12)
        if L2 > 0 and L2 % 8 == 0 and bitwire2c_width(L2) == row_width:
            return -2, L2
    raise ValueError("not a bitpack-family row width: %d" % row_width)


def bitwire_logical_len(row_width: int) -> int:
    """Logical read length L encoded by a bitpack-family wire row."""
    return bitwire_kind(row_width)[1]


def pad_wire_cols(codes, quals, lcap: int):
    """Pad a decoded wire's length axis up to the step's ``lcap``.

    The wire carries only ``hpgq.io.packer.wire_len(max_len, lcap)``
    columns to keep H2D bytes proportional to real read length; the
    compute kernels want the full ``[B, lcap]`` layout.  Padding values
    match the packers' own padding (codes 5 = OTHER, quals 0) — every
    kernel masks by ``lens`` anyway."""
    L = codes.shape[1]
    if L >= lcap:
        return codes, quals
    pad = ((0, 0), (0, lcap - L))
    return (jnp.pad(codes, pad, constant_values=5),
            jnp.pad(quals, pad))


def qnwire_logical_len(W: int) -> int:
    """Logical L from a qn8 wire row width (W = L + 8)."""
    return W - 8


def wire_unqn8(buf):
    """Device-side decoder of the qn8 wire (see
    ``hpgq.io.packer.pack_block_qnwire``) -> (codes, quals, lens, valid).

    Row layout (W = L + 8): one byte per base = (qual & 0x7F) | (is_N << 7),
    then len_le32|valid|pad3.  The synthesized codes tensor is 4 (BASE_N)
    where the flag is set and 0 elsewhere — sufficient for the verdict/trim
    kernels, whose only sequence-derived quantity is the N count
    (``read_reductions``; GC is unused on those paths)."""
    B, W = buf.shape
    L = qnwire_logical_len(W)
    body = buf[:, :L]
    quals = body & 0x7F
    codes = ((body >> 7) << 2).astype(jnp.int8)  # 0 | BASE_N(4)
    lb = buf[:, L : L + 4].astype(jnp.int32)
    lens = lb[:, 0] | (lb[:, 1] << 8) | (lb[:, 2] << 16) | (lb[:, 3] << 24)
    valid = buf[:, L + 4] != 0
    return codes, quals, lens, valid


def wire_unbits(buf):
    """Device-side decoder of the bitpack wire (see
    ``hpgq.io.packer.pack_block_bitwire``) -> (codes, quals, lens, valid).

    Row layout (W = 3L/8 + 7L/8 + 8, L % 8 == 0): little-endian bitstreams
    of 3-bit base codes and 7-bit ASCII quals, then len_le32|valid|pad3.
    The decode is reshape + static shifts only (no gathers): every 3 code
    bytes hold 8 values in a 24-bit word; every 7 qual bytes hold 8 values
    in a 56-bit word carried as two uint32 limbs — XLA fuses the whole
    decode into the consuming kernel's first HBM read.

    The adaptive 6-bit layout (``pack_block_bitwire_adaptive``) is
    detected from the row width alone (:func:`bitwire_kind`): quals are
    6-bit values re-based on a per-row ``qbase`` byte (tail slot 5), so
    the decode adds it back and re-zeroes the beyond-length positions to
    keep the exact (codes, quals, lens, valid) contract of the 7-bit
    path."""
    B, W = buf.shape
    qbits, L = bitwire_kind(W)
    if qbits == -2:
        raise ValueError(
            "2c wire rows need their exception sidecar — decode with "
            "wire_unbits2c(buf, exc)")
    if qbits == 6:
        return _unbits6(buf, L)
    if qbits == 2:
        return _unbits2q(buf, L)
    c3 = 3 * L // 8
    q7 = 7 * L // 8
    cb = buf[:, :c3].reshape(B, L // 8, 3)
    codes = _bit_fields(cb, 3, 7).astype(jnp.int8).reshape(B, L)
    qb = buf[:, c3 : c3 + q7].reshape(B, L // 8, 7)
    quals = _bit_fields(qb, 7, 0x7F).reshape(B, L)
    lens, valid = _wire_tail(buf, c3 + q7)
    return codes, quals, lens, valid


def _bit_fields(bytes3d, nbits: int, mask: int):
    """[B, L/8, nbytes] uint8 bitstream groups -> 8 decoded fields.

    All-uint8 arithmetic: field k of a group spans at most two bytes
    (nbits + 7 <= 15), so each field is one shift-or-shift per byte —
    intermediates stay uint8 (8x smaller than a widened-word decode;
    this path is HBM-bound)."""
    out = []
    for k in range(8):
        s = nbits * k
        i0, r = s >> 3, s & 7
        v = bytes3d[..., i0] >> r
        if r + nbits > 8:
            v = v | (bytes3d[..., i0 + 1] << (8 - r))
        out.append(v & mask)
    return jnp.stack(out, axis=-1)


def _wire_tail(buf, off: int):
    """(lens int32, valid bool) from a wire row tail [len_le32 | valid]."""
    lb = buf[:, off : off + 4].astype(jnp.int32)
    lens = lb[:, 0] | (lb[:, 1] << 8) | (lb[:, 2] << 16) | (lb[:, 3] << 24)
    return lens, buf[:, off + 4] != 0


def _unbits6(buf, L: int):
    """bitpack6 decode: 3-bit codes + 6-bit quals + per-row qbase
    (tail slot 5); beyond-length quals re-zeroed so the output contract
    matches the 7-bit path byte-for-byte."""
    B = buf.shape[0]
    c3 = 3 * L // 8
    q6 = 6 * L // 8
    cb = buf[:, :c3].reshape(B, L // 8, 3)
    codes = _bit_fields(cb, 3, 7).astype(jnp.int8).reshape(B, L)
    qb = buf[:, c3 : c3 + q6].reshape(B, L // 8, 6)
    q = _bit_fields(qb, 6, 0x3F).reshape(B, L)
    lens, valid = _wire_tail(buf, c3 + q6)
    qbase = buf[:, c3 + q6 + 5]
    mask = jax.lax.broadcasted_iota(jnp.int32, (B, L), 1) < lens[:, None]
    quals = jnp.where(mask, q + qbase[:, None], jnp.uint8(0))
    return codes, quals, lens, valid


def _unbits2q(buf, L: int):
    """bitpack2q decode: 3-bit codes + 2-bit indices into the per-row
    4-entry qual palette (tail slots 5..8, ascending); beyond-length quals
    re-zeroed so the output contract matches the other bitpack layouts.
    The palette lookup is three uint8 selects (no gather) — XLA fuses it
    into the consuming kernel's first HBM read like the rest of the
    decode."""
    B = buf.shape[0]
    c3 = 3 * L // 8
    q2 = L // 4
    cb = buf[:, :c3].reshape(B, L // 8, 3)
    codes = _bit_fields(cb, 3, 7).astype(jnp.int8).reshape(B, L)
    qb = buf[:, c3 : c3 + q2].reshape(B, L // 8, 2)
    idx = _bit_fields(qb, 2, 3).reshape(B, L)
    lens, valid = _wire_tail(buf, c3 + q2)
    pal = buf[:, c3 + q2 + 5 : c3 + q2 + 9]  # [B, 4] ascending
    lo = jnp.where(idx == 0, pal[:, 0:1], pal[:, 1:2])
    hi = jnp.where(idx == 2, pal[:, 2:3], pal[:, 3:4])
    q = jnp.where(idx < 2, lo, hi)
    mask = jax.lax.broadcasted_iota(jnp.int32, (B, L), 1) < lens[:, None]
    quals = jnp.where(mask, q, jnp.uint8(0))
    return codes, quals, lens, valid


def wire_unbits2c(buf, exc):
    """Device-side decoder of the bitpack2c wire (see
    ``hpgq.io.packer.wire_bitpack2c_np``) -> (codes, quals, lens, valid).

    Row layout (W = 4L/8 + 12 + pads): little-endian 2-bit base codes
    (A..T; N/OTHER positions packed as 0), 2-bit palette indices, then
    len_le32|valid|palette4|pad3.  ``exc`` is the int32 exception sidecar
    — ``((row * L + pos) << 1) | is_other`` entries, row-major, padded
    with out-of-bounds sentinels — scatter-restored here as codes 4/5
    (sorted unique indices, ``mode='drop'`` eats the padding), so every
    downstream kernel sees EXACT codes; beyond-length positions are set
    to 5 (OTHER) to match ``pack_block``'s padding byte-for-byte."""
    B, W = buf.shape
    qbits, L = bitwire_kind(W)
    assert qbits == -2, (W, qbits)
    c2 = L // 4
    q2 = L // 4
    cb = buf[:, :c2].reshape(B, L // 8, 2)
    codes2 = _bit_fields(cb, 2, 3).reshape(B, L)
    idx = exc >> 1
    val = ((exc & 1) + 4).astype(jnp.uint8)
    codes = (
        codes2.reshape(-1)
        .at[idx].max(val, mode="drop", unique_indices=True,
                     indices_are_sorted=True)
        .reshape(B, L)
    )
    qb = buf[:, c2 : c2 + q2].reshape(B, L // 8, 2)
    qidx = _bit_fields(qb, 2, 3).reshape(B, L)
    lens, valid = _wire_tail(buf, c2 + q2)
    pal = buf[:, c2 + q2 + 5 : c2 + q2 + 9]  # [B, 4] ascending
    lo = jnp.where(qidx == 0, pal[:, 0:1], pal[:, 1:2])
    hi = jnp.where(qidx == 2, pal[:, 2:3], pal[:, 3:4])
    q = jnp.where(qidx < 2, lo, hi)
    mask = jax.lax.broadcasted_iota(jnp.int32, (B, L), 1) < lens[:, None]
    quals = jnp.where(mask, q, jnp.uint8(0))
    codes = jnp.where(mask, codes, jnp.uint8(5)).astype(jnp.int8)
    return codes, quals, lens, valid


def wire_unbits2u(buf, exc, pal, n_valid, *, L: int):
    """Device-side decoder of the bitpack2u (uniform) wire (see
    ``hpgq.io.packer.wire_bitpack2u_np``) -> (codes, quals, lens, valid).

    ``buf`` is two bare 2-bit planes [codes2 | qidx2] of W = 4*ceil(L/8)
    bytes; lengths (all == ``L``, static), validity (rows < ``n_valid``)
    and the 4-entry ascending qual palette arrive as the per-batch
    sidecar instead of 12+ bytes per row.  ``exc`` scatter-restores
    exact N/OTHER codes (entries stride Lp = 8*ceil(L/8), the padded
    field count); beyond-length and invalid positions come out as
    codes 5 / quals 0, matching ``pack_block`` byte-for-byte."""
    B, W = buf.shape
    Lp = 2 * W  # fields per row: W bytes * 8 bits / (2+2 bits shared)...
    # two planes of W/2 bytes each -> Lp = (W/2)*4 = 2W fields per plane
    c2 = W // 2
    codes2 = _bit_fields(buf[:, :c2].reshape(B, Lp // 8, 2), 2, 3
                         ).reshape(B, Lp)
    idx = exc >> 1
    val = ((exc & 1) + 4).astype(jnp.uint8)
    codes = (
        codes2.reshape(-1)
        .at[idx].max(val, mode="drop", unique_indices=True,
                     indices_are_sorted=True)
        .reshape(B, Lp)
    )
    qidx = _bit_fields(buf[:, c2:].reshape(B, Lp // 8, 2), 2, 3
                       ).reshape(B, Lp)
    lo = jnp.where(qidx == 0, pal[0], pal[1])
    hi = jnp.where(qidx == 2, pal[2], pal[3])
    q = jnp.where(qidx < 2, lo, hi)
    valid = jax.lax.broadcasted_iota(jnp.int32, (B,), 0) < n_valid
    lens = jnp.where(valid, jnp.int32(L), 0)
    mask = jax.lax.broadcasted_iota(jnp.int32, (B, Lp), 1) < lens[:, None]
    quals = jnp.where(mask, q, jnp.uint8(0))
    codes = jnp.where(mask, codes, jnp.uint8(5)).astype(jnp.int8)
    return codes, quals, lens, valid


def make_stats_step2u(
    lcap: int,
    phred: int,
    kmers_on: bool,
    crit,
    L: int,
    jit: bool = True,
):
    """Jitted per-batch stats update over the bitpack2u (uniform) wire:
    ``step(acc, buf, exc, pal, n_valid) -> acc'``.  ``L`` (the uniform
    read length) is static — the wire width alone cannot recover it.
    Cached process-wide like :func:`make_stats_step`."""
    cache_key = ("2u", lcap, phred, kmers_on, _crit_key(crit), L)
    if jit and cache_key in _STEP_CACHE:
        return _STEP_CACHE[cache_key]
    inner = make_stats_step(lcap, phred, kmers_on, crit, jit=False,
                            donate=False, wire=None)

    def step(acc, buf, exc, pal, n_valid):
        codes, quals, lens, valid = wire_unbits2u(buf, exc, pal, n_valid,
                                                  L=L)
        codes, quals = pad_wire_cols(codes, quals, lcap)
        return inner(acc, codes, quals, lens, valid)

    if jit:
        step = jax.jit(step, donate_argnums=(0,))
        _STEP_CACHE[cache_key] = step
    return step


def make_paired_stats_step2u(
    lcap: int,
    phred: int,
    kmers_on: bool,
    crit,
    L1: int,
    L2: int,
    jit: bool = True,
):
    """Fused paired step over the bitpack2u (uniform) wire — BOTH mates'
    bare bit-planes + sidecars in one dispatch:
    ``step(acc1, acc2, b1, e1, p1, nv1, b2, e2, p2, nv2) -> (acc1', acc2')``.
    ``L1``/``L2`` (the mates' uniform read lengths) are static.  Cached
    process-wide like :func:`make_paired_stats_step`."""
    cache_key = ("p2u", lcap, phred, kmers_on, _crit_key(crit), L1, L2)
    if jit and cache_key in _STEP_CACHE:
        return _STEP_CACHE[cache_key]
    inner = make_paired_stats_step(lcap, phred, kmers_on, crit, jit=False,
                                   wire=None)

    def step(a1, a2, b1, e1, p1, nv1, b2, e2, p2, nv2):
        def dec(b, e, p, nv, L):
            c, q, l, v = wire_unbits2u(b, e, p, nv, L=L)
            c, q = pad_wire_cols(c, q, lcap)
            return c, q, l, v

        return inner(a1, a2, dec(b1, e1, p1, nv1, L1),
                     dec(b2, e2, p2, nv2, L2))

    if jit:
        step = jax.jit(step, donate_argnums=(0, 1))
        _STEP_CACHE[cache_key] = step
    return step


def make_stats_step(
    lcap: int,
    phred: int,
    kmers_on: bool = False,
    crit: Optional[FilterCriteria] = None,
    jit: bool = True,
    donate: bool = True,
    wire: Optional[str] = None,
    vary_axis=None,
):
    """Build the fused per-batch stats update:

    step(acc, codes, quals, lens, valid) -> acc'

    With ``crit`` set, stats are computed over passing reads only and
    num_passed/num_failed are tracked (the `stats --filter` inline-filter
    path, src/stats_fastq.c:205-248).

    ``wire='pack4'``: the step's ``codes`` argument is nibble-packed
    ``[B, L//2]`` uint8 (see :func:`wire_pack4`) and unpacked on device.
    ``wire='fused4'`` / ``wire='bitpack'``: the step signature becomes
    ``step(acc, buf)`` where ``buf`` is the single uint8 wire buffer
    (:func:`wire_fuse` / ``hpgq.io.packer.pack_block_bitwire``).
    """
    cache_key = (lcap, phred, kmers_on, _crit_key(crit), donate, wire,
                 vary_axis)
    if jit and cache_key in _STEP_CACHE:
        return _STEP_CACHE[cache_key]

    def unwire(codes):
        return wire_unpack4(codes) if wire == "pack4" else codes

    def step(acc, codes, quals, lens, valid):
        codes = unwire(codes)
        lens32 = lens.astype(jnp.int32)
        if crit is not None:
            ok = verdicts(codes, quals, lens32, crit, phred)
            passed = valid & ok
            np_ = passed.astype(jnp.int32).sum()
            nf = (valid & ~ok).astype(jnp.int32).sum()
            p = batch_partials(codes, quals, lens32, passed, lcap, phred,
                               kmers_on, vary_axis=vary_axis)
            out = merge_into(acc, p)
            out["num_passed"] = acc["num_passed"] + np_
            out["num_failed"] = acc["num_failed"] + nf
            return out
        p = batch_partials(codes, quals, lens32, valid, lcap, phred,
                           kmers_on, vary_axis=vary_axis)
        return merge_into(acc, p)

    if wire in ("fused4", "bitpack"):
        inner = step
        unfuse = wire_unfuse if wire == "fused4" else wire_unbits

        def step(acc, buf, exc=None):  # noqa: F811 — fused single-buffer
            # entry; ``exc`` is the 2c tier's exception sidecar (the
            # jitted step retraces per argument structure, so the
            # None/array alternation costs one extra trace, not a branch)
            if exc is None:
                codes, quals, lens, valid = unfuse(buf)
            else:
                codes, quals, lens, valid = wire_unbits2c(buf, exc)
            codes, quals = pad_wire_cols(codes, quals, lcap)
            return inner(acc, codes, quals, lens, valid)

    if jit:
        step = jax.jit(step, donate_argnums=(0,) if donate else ())
        _STEP_CACHE[cache_key] = step
    return step


def make_paired_stats_step(
    lcap: int,
    phred: int,
    kmers_on: bool = False,
    crit: Optional[FilterCriteria] = None,
    jit: bool = True,
    wire: Optional[str] = None,
    vary_axis=None,
):
    """Fused per-batch update for BOTH mates of a paired batch in ONE
    dispatch:

        step(acc1, acc2, in1, in2) -> (acc1', acc2')

    where ``inN`` is the mate's wire buffer (with ``wire`` set), nibble-
    packed codes + arrays (``wire='pack4'``), or the plain (codes, quals,
    lens, valid) tuple.  With ``crit``, the pair-consistent verdict (BOTH
    mates pass — src-equivalent of the legacy paired prepro,
    old/main_hpg_fastq_old.c:726-728) selects which pairs count, and the
    per-pair passed/failed tallies fold into ``acc1``'s num_passed /
    num_failed (device-resident — the host never syncs per batch).
    Replaces the 4-dispatch loop (verdict x2 + accumulate x2).

    ``vary_axis``: shard_map manual axis the step runs under (the fused
    sharded-paired step, ``dist.mesh.make_sharded_paired_stats_step``)."""
    cache_key = ("paired", lcap, phred, kmers_on, _crit_key(crit), wire,
                 vary_axis)
    if jit and cache_key in _STEP_CACHE:
        return _STEP_CACHE[cache_key]

    def pfn(codes, quals, lens, valid):
        return batch_partials(codes, quals, lens, valid, lcap, phred,
                              kmers_on, vary_axis=vary_axis)

    if wire in ("fused4", "bitpack"):
        def unf(t):
            if isinstance(t, tuple):  # 2c tier: (buf, exc) sidecar pair
                c, q, l, v = wire_unbits2c(*t)
            else:
                c, q, l, v = (wire_unfuse if wire == "fused4"
                              else wire_unbits)(t)
            c, q = pad_wire_cols(c, q, lcap)
            return c, q, l, v
    elif wire == "pack4":
        def unf(t):
            c, q, l, v = t
            return wire_unpack4(c), q, l, v
    else:
        def unf(t):
            return t

    def step(acc1, acc2, in1, in2):
        c1, q1, l1, v1 = unf(in1)
        c2, q2, l2, v2 = unf(in2)
        l1 = l1.astype(jnp.int32)
        l2 = l2.astype(jnp.int32)
        pair = v1 & v2
        if crit is not None:
            ok = (verdicts(c1, q1, l1, crit, phred)
                  & verdicts(c2, q2, l2, crit, phred))
            sel = pair & ok
            np_ = sel.astype(jnp.int32).sum()
            nf = (pair & ~ok).astype(jnp.int32).sum()
        else:
            sel = pair
        out1 = merge_into(acc1, pfn(c1, q1, l1, sel))
        out2 = merge_into(acc2, pfn(c2, q2, l2, sel))
        if crit is not None:
            out1["num_passed"] = acc1["num_passed"] + np_
            out1["num_failed"] = acc1["num_failed"] + nf
        return out1, out2

    if jit:
        step = jax.jit(step, donate_argnums=(0, 1))
        _STEP_CACHE[cache_key] = step
    return step
