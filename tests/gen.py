"""Synthetic FASTQ corpus generation for tests and benchmarks."""

import numpy as np

ALPHABET = b"ACGT"


def make_records(
    n: int,
    min_len: int = 60,
    max_len: int = 60,
    seed: int = 0,
    n_prob: float = 0.0,
    phred: int = 33,
    min_q: int = 2,
    max_q: int = 41,
    lowercase_prob: float = 0.0,
    qual_bins=None,
):
    """Generate n (name, seq, qual) tuples with reproducible randomness.

    ``qual_bins``: draw qualities from this value set instead of the
    uniform [min_q, max_q] range — e.g. ``(2, 12, 23, 37)`` reproduces
    NovaSeq/NextSeq RTA3 4-level quality binning, the dominant shape of
    modern production FASTQ."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(min_len, max_len + 1, size=n)
    out = []
    for i in range(n):
        ln = int(lens[i])
        bases = rng.integers(0, 4, size=ln)
        seq = np.frombuffer(ALPHABET, dtype=np.uint8)[bases].copy()
        if n_prob > 0:
            seq[rng.random(ln) < n_prob] = ord("N")
        if lowercase_prob > 0:
            lower = rng.random(ln) < lowercase_prob
            seq[lower] = seq[lower] + 32
        if qual_bins is not None:
            bins = np.asarray(qual_bins, dtype=np.int64)
            q = bins[rng.integers(0, len(bins), size=ln)] + phred
        else:
            q = rng.integers(min_q, max_q + 1, size=ln) + phred
        out.append(
            (b"@read_%d some description" % i, seq.tobytes(), q.astype(np.uint8).tobytes())
        )
    return out


def write_fastq(path, records, gz: bool = False):
    import gzip

    op = gzip.open if gz else open
    with op(path, "wb") as f:
        for name, seq, qual in records:
            f.write(name + b"\n" + seq + b"\n+\n" + qual + b"\n")
    return path


def make_fastq(path, n: int, **kw):
    gz = str(path).endswith(".gz")
    records = make_records(n, **kw)
    write_fastq(path, records, gz=gz)
    return records


def write_fastq_bulk(path, n: int, min_len: int = 60, max_len: int = 60,
                     seed: int = 0, n_prob: float = 0.0, phred: int = 33,
                     min_q: int = 2, max_q: int = 41, qual_bins=None,
                     chunk: int = 65536):
    """:func:`make_fastq`'s record layout for large corpora, drawn in bulk:
    one generator call per chunk of reads instead of several per read, and
    nothing kept in memory beyond a chunk.  (The draws differ from
    :func:`make_records` for the same seed.)  Returns the byte offset just
    past each record, int64 ``[n]``."""
    rng = np.random.default_rng(seed)
    alphabet = np.frombuffer(ALPHABET, dtype=np.uint8)
    bins = None if qual_bins is None else np.asarray(qual_bins, np.int64)
    ends = np.empty(n, dtype=np.int64)
    pos = 0
    with open(path, "wb") as f:
        for lo in range(0, n, chunk):
            m = min(chunk, n - lo)
            lens = rng.integers(min_len, max_len + 1, size=m)
            total = int(lens.sum())
            seq = alphabet[rng.integers(0, 4, size=total, dtype=np.uint8)]
            if n_prob > 0:
                seq[rng.random(total, dtype=np.float32) < n_prob] = ord("N")
            if bins is not None:
                q = bins[rng.integers(0, len(bins), size=total,
                                      dtype=np.uint8)] + phred
            else:
                q = rng.integers(min_q, max_q + 1, size=total,
                                 dtype=np.uint8) + phred
            seq_b = seq.tobytes()
            qual_b = q.astype(np.uint8).tobytes()
            cut = np.concatenate([[0], np.cumsum(lens)])
            parts = []
            for i in range(m):
                a, b = cut[i], cut[i + 1]
                rec = (b"@read_%d some description\n" % (lo + i) + seq_b[a:b]
                       + b"\n+\n" + qual_b[a:b] + b"\n")
                parts.append(rec)
                pos += len(rec)
                ends[lo + i] = pos
            f.write(b"".join(parts))
    return ends
