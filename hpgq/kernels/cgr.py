"""Chaos-game-representation kernel: windowed bit codes + one-hot matmul
outer-product histogram.

The reference fills its ``2^k x 2^k`` CGR tables with a sequential f64
iterated-function-system per nucleotide (``old/chaos_game.c:165-267``).  That
recurrence has a closed form: each step is ``f <- (f + bit*dim)/2`` with
``bit_x = 1`` for A/T and ``bit_y = 1`` for G/T, so after the k bases
``b_1..b_k`` (oldest first) of a completed word

    f = f_prior / 2^k  +  sum_m bit(b_m) * 2^(m-1)          (dim = 2^k)

and since ``0 <= f_prior < dim`` in exact arithmetic, ``floor(f)`` is exactly
the k-bit window code (oldest base weight 1, newest 2^(k-1)) independent of
all history — including the reference's coordinate carry-over across reads
and its N-reset (which resets the word counter, not the point,
``old/chaos_game.c:229-233``).  The EPSILON boundary clamp (``:243-251``)
only fires where f64 rounding saturates ``f_prior`` to ``dim`` (a >=53-long
single-letter A/T (x) or G/T (y) run immediately before the window), and in
the all-ones window where it fires the clamp restores the window code — the
closed form's sole numeric divergence is an off-by-one cell for a
non-all-ones window right after such a run; we take the exact-math cell
(documented deviation, verified against the loop oracle ``hpgq.oracle.cgr``
in tests/test_cgr.py).

Deviation [D7] — non-ACGTN bytes (IUPAC codes etc., packer code 5): the
kernel treats them exactly like N (any window containing one is invalid),
whereas the reference's switch lets them FALL THROUGH with no state change
(``old/chaos_game.c:199-234`` has no default case), splicing a k-word
across the unknown byte AND then subtracting the wrong quality byte from
the sliding accumulator (``:259`` indexes quality by original position,
which after a splice is not the oldest counted base).  Splicing artificial
words across unknown bases — with a corrupted quality window — is a
reference quirk we deliberately do not replicate (same stance as the [D6]
case-folding deviation); equivalence contract: kernel(batch) ==
loop-oracle(batch with code 5 mapped to N), tested in tests/test_cgr.py.
PARITY.md quantifies the reach (zero on ACGTN-only corpora).

So per batch the kernel is: sliding-window x/y bit codes (valid iff all k
bases in {A,C,G,T} and the window fits in the read), then a 2-D histogram
accumulated as ``onehot_x^T @ onehot_y`` chunked matmuls, which XLA hands
to the card's matrix units: 2*N*dim^2 flops instead of N colliding
scatters.
The quality table uses the same matmul with the x one-hot scaled by the
window's quality sum minus ``phred*k`` (``old/chaos_game.c:253-257``).

f32 exactness: one-hot entries are 0/1 and per-chunk per-cell sums stay
below 2^24 for chunk <= 16384 windows (worst-case quality weight < 93*k),
so every matmul partial is integer-exact in f32; chunks accumulate in i32.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from ..constants import BASE_A, BASE_G, BASE_T, DEFAULT_CGR_K
from ..io.packer import round_up as _round_up
from .stats_jnp import _vary

CHUNK = 16384  # windows per matmul chunk (f32-exactness bound, see above)


def window_cells(codes, lens, k: int):
    """(ix, iy, ok) int32/bool ``[B, W]`` window codes for W = L-k+1.

    ix/iy bit weights: window base at offset t (0 = oldest) has weight 2^t
    (the IFS closed form above); ok marks windows fully inside the read with
    no N/other base.
    """
    B, L = codes.shape
    W = L - k + 1
    assert W >= 1
    ix = jnp.zeros((B, W), jnp.int32)
    iy = jnp.zeros((B, W), jnp.int32)
    ok = jnp.ones((B, W), jnp.bool_)
    for t in range(k):
        part = codes[:, t : t + W]
        xb = ((part == BASE_A) | (part == BASE_T)).astype(jnp.int32)
        yb = ((part == BASE_G) | (part == BASE_T)).astype(jnp.int32)
        ix += xb << t
        iy += yb << t
        ok &= part < 4
    pos = jax.lax.broadcasted_iota(jnp.int32, (B, W), 1)
    ok &= (pos + k) <= lens[:, None]
    return ix, iy, ok


def window_qsums(quals, k: int):
    """Sliding sum of k raw quality bytes — int32 ``[B, W]``."""
    B, L = quals.shape
    W = L - k + 1
    q = quals.astype(jnp.int32)
    s = jnp.zeros((B, W), jnp.int32)
    for t in range(k):
        s += q[:, t : t + W]
    return s


def cgr_batch_tables(codes, quals, lens, valid, k: int, phred: int,
                     chunk: int = CHUNK, vary_axis=None):
    """(table_seq i32, table_q_hi i32, table_q_lo i32, words i32) for one
    packed batch — exact-integer chunked matmul accumulation.  The quality
    table is returned as two int32 limbs (true value = hi*2^16 + lo,
    recombine with :func:`combine_quality_limbs`): a single cell can exceed
    2^31 within one batch and x64 is off, so there is no int64 on device.

    ``vary_axis``: set to the mesh axis name when called inside shard_map."""
    dim = 1 << k
    # bound the [chunk, dim] one-hot working set to ~64 MB for large k
    # (k=12 -> dim 4096; the f32-exactness bound only tightens with smaller
    # chunks)
    chunk = max(128, min(chunk, (64 << 20) // (4 * dim)))
    B, L = codes.shape
    lens = lens.astype(jnp.int32)
    ix, iy, ok = window_cells(codes, lens, k)
    ok &= valid[:, None]
    wq = window_qsums(quals, k) - phred * k

    W = ix.shape[1]
    N = B * W
    Np = _round_up(N, chunk)
    pad = Np - N

    def flat(a, fill=0):
        f = a.reshape(-1)
        return jnp.pad(f, (0, pad), constant_values=fill) if pad else f

    fx = flat(ix)
    fy = flat(iy)
    fok = flat(ok.astype(jnp.float32))
    fwq = flat(wq)

    bins = jax.lax.broadcasted_iota(jnp.int32, (1, dim), 1)

    def body(i, carry):
        ts, tq_hi, tq_lo = carry
        sl = i * chunk
        cx = jax.lax.dynamic_slice(fx, (sl,), (chunk,))[:, None]
        cy = jax.lax.dynamic_slice(fy, (sl,), (chunk,))[:, None]
        cok = jax.lax.dynamic_slice(fok, (sl,), (chunk,))[:, None]
        cwq = jax.lax.dynamic_slice(fwq, (sl,), (chunk,))[:, None]
        ohx = (cx == bins).astype(jnp.float32) * cok          # [chunk, dim]
        ohy = (cy == bins).astype(jnp.float32)                # [chunk, dim]
        # Precision.HIGHEST is LOAD-BEARING: at default precision a f32
        # matmul may run in TF32 on the GPU (10-bit mantissa).  The 0/1
        # seq one-hots are exact there, but quality weights reach ±93k
        # (651 for k=7) and are not.  HIGHEST keeps true-f32 products, and
        # the chunk bound (docstring) keeps every partial integer-exact in
        # f32.
        seq = jax.lax.dot_general(
            ohx, ohy, (((0,), (0,)), ((), ())),
            preferred_element_type=jnp.float32,
            precision=jax.lax.Precision.HIGHEST,
        )
        qtw = ohx * cwq.astype(jnp.float32)
        qt = jax.lax.dot_general(
            qtw, ohy, (((0,), (0,)), ((), ())),
            preferred_element_type=jnp.float32,
            precision=jax.lax.Precision.HIGHEST,
        )
        # quality totals in two int32 limbs (hi*2^16 + lo): one cell can
        # exceed 2^31 within a batch (millions of low-complexity windows x
        # weight <= ~650) and x64 is off, so there is no int64 on device —
        # normalize after each chunk so lo stays in [0, 2^16)
        tq_lo = tq_lo + qt.astype(jnp.int32)
        shift = tq_lo >> 16  # floor for negatives too (arithmetic shift)
        tq_hi = tq_hi + shift
        tq_lo = tq_lo - (shift << 16)
        return ts + seq.astype(jnp.int32), tq_hi, tq_lo

    ts0 = _vary(jnp.zeros((dim, dim), jnp.int32), vary_axis)
    tq0 = _vary(jnp.zeros((dim, dim), jnp.int32), vary_axis)
    ts, tq_hi, tq_lo = jax.lax.fori_loop(0, Np // chunk, body, (ts0, tq0, tq0))
    words = ok.astype(jnp.int32).sum()
    return ts, tq_hi, tq_lo, words


def combine_quality_limbs(tq_hi, tq_lo):
    """Host-side int64 recombination of the two quality limbs."""
    import numpy as np

    return (np.asarray(tq_hi, dtype=np.int64) << 16) + np.asarray(
        tq_lo, dtype=np.int64
    )


_CGR_STEP_CACHE: dict = {}


def make_cgr_step(k: int = DEFAULT_CGR_K, phred: int = 33, jit: bool = True,
                  wire=None):
    """step(acc, codes, quals, lens, valid) -> acc for
    acc = {"table_seq", "table_q_hi", "table_q_lo", "words"} (device i32).

    ``wire='bitpack'``/``'fused4'``: signature becomes ``step(acc, buf)``
    with the single uint8 wire buffer decoded on device (same minimal-H2D
    trick as the stats engine; see ``stats_jnp.wire_unbits``)."""
    key = (k, phred, wire)
    if jit and key in _CGR_STEP_CACHE:
        return _CGR_STEP_CACHE[key]

    def step(acc, codes, quals, lens, valid):
        ts, tq_hi, tq_lo, w = cgr_batch_tables(codes, quals, lens, valid, k,
                                               phred)
        return {
            "table_seq": acc["table_seq"] + ts,
            "table_q_hi": acc["table_q_hi"] + tq_hi,
            "table_q_lo": acc["table_q_lo"] + tq_lo,
            "words": acc["words"] + w,
        }

    if wire in ("bitpack", "fused4"):
        from .stats_jnp import wire_unbits, wire_unfuse

        inner = step
        unf = wire_unbits if wire == "bitpack" else wire_unfuse

        def step(acc, buf):  # noqa: F811 — fused single-buffer entry
            return inner(acc, *unf(buf))

    if jit:
        step = jax.jit(step, donate_argnums=(0,))
        _CGR_STEP_CACHE[key] = step
    return step


def zero_cgr_acc(k: int):
    dim = 1 << k
    return {
        "table_seq": jnp.zeros((dim, dim), jnp.int32),
        "table_q_hi": jnp.zeros((dim, dim), jnp.int32),
        "table_q_lo": jnp.zeros((dim, dim), jnp.int32),
        "words": jnp.zeros((), jnp.int32),
    }
