"""The `cgr` command pipeline: chaos-game genomic signature of a FASTQ.

Streams packed batches through the one-hot matmul histogram kernel
(``hpgq.kernels.cgr``), folds per-batch int32 tables into host int64 every
batch (the tables are only ``4^k`` cells — a 128 KB transfer — and per-batch
folding keeps any cell overflow window smaller than the reference's own
``unsigned int`` accumulators, ``old/chaos_game.h:77-79``), then emits the
reference's outputs (``chaos_game_write_table_images``,
``old/chaos_game.c:407-465``):

* ``<fq>_k=<k>_FG.pgm``   — sequence-word signature image
* ``<fq>_k=<k>_QQ.pgm``   — quality signature image
* ``<fq>_k=<k>_FG_dif.pgm`` + mean/std — iff a reference signature is given
* ``<fq>_k=<k>.gs``       — this file's signature (``--write-gs``)

Paired-end inputs accumulate BOTH mates into one signature (the signature
is a property of the sample, not the mate; legacy ran CGR within its
paired-end prepro kernel, ``old/main_hpg_fastq_old.c:726-728``).
"""

from __future__ import annotations

import os
from typing import Optional

import jax
import numpy as np

from ..constants import CGR_FASTQ_PGM_SUFFIX # noqa: F401  (re-export convenience)
from ..constants import (
    CGR_DIFF_PGM_SUFFIX,
    CGR_K_VALUE_INFIX,
    CGR_MAX_QUALITY_IN_TABLE,
    CGR_QUALITY_PGM_SUFFIX,
)
from ..io.fastq import FastqReader
from ..io.packer import bucket_rows, pack_block, round_up
from ..kernels.cgr import make_cgr_step, zero_cgr_acc
from ..options import CgrOptions
from ..report import pgm
from ..utils.timers import StageTimers
from .run import _batch_reads, _iter_blocks, _reader_batch


class CgrSession:
    """Streaming CGR accumulation (host int64 tables, device batch kernel)."""

    def __init__(self, k: int, phred: int, batch_reads: int):
        from ..core.accumulator import resolve_wire

        self.k = k
        self.phred = phred
        self.batch_reads = batch_reads
        dim = 1 << k
        self.table_seq = np.zeros((dim, dim), dtype=np.int64)
        self.table_q = np.zeros((dim, dim), dtype=np.int64)
        self.word_count = 0
        self.wire = resolve_wire()
        self._step = make_cgr_step(k, phred, wire=self.wire)

    def block_tables(self, block) -> dict:
        """Host copy of one block's device tables (fresh zero accumulator
        per batch, so calls are independent and thread-safe: no session
        state is touched until :meth:`fold_host`)."""
        lmax = round_up(max(block.max_len(), self.k), 128)
        rows = bucket_rows(block.num_reads, self.batch_reads)
        if self.wire in ("bitpack", "fused4"):
            from ..io.packer import pack_block_wire, wire_len

            # trimmed wire columns like every other wire consumer (floored
            # at k so the decode always fits one CGR window); the cgr step
            # decodes width-agnostically — no on-device re-pad needed
            buf = pack_block_wire(block, self.wire,
                                  wire_len(max(block.max_len(), self.k),
                                           lmax),
                                  pad_reads_to=rows,
                                  allow6=(self.wire == "bitpack"))
            acc = self._step(zero_cgr_acc(self.k), buf)
        else:
            codes, quals, lens, valid = pack_block(
                block, max_len=lmax, pad_reads_to=rows
            )
            acc = self._step(zero_cgr_acc(self.k), codes, quals, lens, valid)
        return jax.device_get(acc)

    def fold_host(self, host: dict) -> None:
        from ..kernels.cgr import combine_quality_limbs

        self.table_seq += np.asarray(host["table_seq"], dtype=np.int64)
        self.table_q += combine_quality_limbs(host["table_q_hi"],
                                              host["table_q_lo"])
        self.word_count += int(host["words"])

    def feed_block(self, block):
        self.fold_host(self.block_tables(block))

    def feed_packed(self, codes, quals, lens, valid):
        step = (self._step if self.wire not in ("bitpack", "fused4")
                else make_cgr_step(self.k, self.phred))  # plain-array entry
        acc = step(zero_cgr_acc(self.k), codes, quals, lens, valid)
        self.fold_host(jax.device_get(acc))


def run_cgr(opts: CgrOptions, timers: Optional[StageTimers] = None) -> dict:
    timers = timers or StageTimers()
    if getattr(opts, "sharded", False):
        from ..dist.run_dist import run_cgr_sharded

        return run_cgr_sharded(opts, timers)
    k = int(opts.k)
    phred = opts.quality_encoding_value
    sess = CgrSession(k, phred, _batch_reads(opts))

    ck_path = opts.checkpoint_path
    ck_every = opts.checkpoint_every or 50
    ck_key = None
    start_input = 0
    start_offset = 0
    if ck_path:
        import json

        from ..utils.checkpoint import (
            load_counters_checkpoint,
            save_counters_checkpoint,
        )

        ck_key = json.dumps({
            "cmd": "cgr", "k": k, "phred": phred,
            "in": os.path.abspath(opts.in_filename),
            "in2": opts.in_filename2 and os.path.abspath(opts.in_filename2),
        }, sort_keys=True)
        loaded = load_counters_checkpoint(ck_path, ck_key)
        if loaded:
            _, start_offset, extra = loaded
            sess.table_seq += extra["table_seq"]
            sess.table_q += extra["table_q"]
            sess.word_count += int(extra["words"])
            start_input = int(extra["input_idx"])

    inputs = [opts.in_filename]
    if opts.paired_end:
        inputs = [opts.in_filename, opts.in_filename2]
    nb = 0
    for idx, path in enumerate(inputs):
        if idx < start_input:
            continue
        offset = start_offset if idx == start_input else 0
        with FastqReader(path, batch_size=_reader_batch(opts),
                         start_offset=offset) as rd:
            if ck_path:
                # checkpointing needs a sequential fold (offsets advance
                # with the fold state) — keep the serial loop
                for block in _iter_blocks(rd, timers):
                    with timers.stage("compute"):
                        sess.feed_block(block)
                    nb += 1
                    if nb % ck_every == 0:
                        with timers.stage("checkpoint"):
                            save_counters_checkpoint(
                                ck_path, None, block.end_offset, ck_key,
                                extra={
                                    "table_seq": sess.table_seq,
                                    "table_q": sess.table_q,
                                    "words": sess.word_count,
                                    "input_idx": idx,
                                },
                            )
            else:
                # per-batch tables are independent (fresh zero accumulator
                # each batch) — fan pack+H2D+device+D2H out over the
                # producer pool and fold host-side in input order
                from .run import _iter_with

                for _block, host in _iter_with(rd, sess.block_tables,
                                               timers):
                    with timers.stage("compute"):
                        sess.fold_host(host)
    if ck_path and os.path.exists(ck_path):
        os.unlink(ck_path)

    return emit_cgr_outputs(opts, sess, timers)


def emit_cgr_outputs(opts: CgrOptions, sess, timers: StageTimers) -> dict:
    """PGM/gs/diff emission from accumulated tables (shared by the local and
    sharded pipelines; reference ``chaos_game_write_table_images``)."""
    k = int(opts.k)
    out: dict = {"fq_word_count": sess.word_count, "pgm_files": []}
    base = os.path.join(
        opts.out_dirname,
        "%s%s%d" % (os.path.basename(opts.in_filename), CGR_K_VALUE_INFIX, k),
    )

    with timers.stage("reporting"):
        fq_norm = pgm.fq_norm_value(sess.word_count, k)
        fg = base + CGR_FASTQ_PGM_SUFFIX
        pgm.write_pgm(fg, sess.table_seq, k, fq_norm)
        out["pgm_files"].append(fg)

        qn = pgm.normalize_quality_table(sess.table_q, sess.table_seq, k)
        q_norm = 256.0 / CGR_MAX_QUALITY_IN_TABLE
        qq = base + CGR_QUALITY_PGM_SUFFIX
        pgm.write_pgm(qq, qn, k, q_norm)
        out["pgm_files"].append(qq)

        if opts.write_gs:
            gs_path = base + ".gs"
            pgm.write_gs(gs_path, sess.table_seq, k, sess.word_count)
            out["gs_file"] = gs_path

        out["mean_dif"] = out["std_dif"] = None
        if opts.gs_filename:
            table_gs, _, ref_words = pgm.read_gs(opts.gs_filename, expect_k=k)
            dif, stats = pgm.diff_table(
                sess.table_seq, table_gs, sess.word_count, ref_words, k
            )
            clamped = pgm.abs_clamp_diff(dif)
            dp = base + CGR_DIFF_PGM_SUFFIX
            pgm.write_pgm(dp, clamped, k, 1.0)
            out["pgm_files"].append(dp)
            out["mean_dif"] = stats["mean"]
            out["std_dif"] = stats["std"]
            out["dif_stats"] = stats

    out["table_seq"] = sess.table_seq
    out["table_q"] = sess.table_q
    return out
