"""True multi-process distributed test: 2 JAX processes x 2 CPU devices.

Validates the real multi-host code path — per-host byte-range input split,
`jax.make_array_from_process_local_data` batches, lockstep length voting,
empty-feed tail steps, and the cross-host psum merge — without accelerators,
by launching two coordinated subprocesses on the CPU backend.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

from gen import make_fastq

_WORKER = r"""
import json, os, sys

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
import jax

jax.config.update("jax_platforms", "cpu")

coord, pid, nproc, fq, outdir, mode, repo = sys.argv[1:8]
jax.distributed.initialize(coord, int(nproc), int(pid))
assert jax.process_count() == int(nproc), jax.process_count()

sys.path.insert(0, repo)
from hpgq.options import StatsOptions
from hpgq.dist.run_dist import run_stats_sharded

o = StatsOptions()
o.in_filename = fq
o.out_dirname = outdir
o.quality_encoding_value = 33
o.quality_encoding_name = "phred33"
o.batch_size = 300
if mode == "filtered":
    o.criteria.min_read_quality = 18
    o.criteria.max_read_quality = 40
    o.filter_on = True

c = run_stats_sharded(o)
print(json.dumps({
    "pid": int(pid),
    "num_reads": c.num_reads,
    "num_passed": c.num_passed,
    "num_failed": c.num_failed,
    "acc_length": c.acc_length,
    "min_length": c.min_length,
    "max_length": c.max_length,
    "num_As": c.num_As,
    "num_Ns": c.num_Ns,
    "length_hist_sum": int(c.length_hist.sum()),
    "qual_per_nt_sum": int(c.acc_quality_per_nt.sum()),
}))
"""


def _free_port():
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.mark.parametrize("mode", ["plain", "filtered"])
@pytest.mark.parametrize("compression", ["plain", "bgzf"])
def test_two_process_sharded_stats(tmp_path, mode, compression):
    n = 2500
    fq = str(tmp_path / "in.fq")
    make_fastq(fq, n, min_len=40, max_len=110, n_prob=0.02, seed=17)
    if compression == "bgzf":
        from hpgq.io.bgzf import write_bgzf

        data = open(fq, "rb").read()
        fq = str(tmp_path / "in.fq.bgz")
        write_bgzf(fq, data, block_size=8192)

    worker = str(tmp_path / "worker.py")
    open(worker, "w").write(_WORKER)
    port = _free_port()
    coord = "localhost:%d" % port

    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}
    outs = [str(tmp_path / ("out%d" % i)) for i in range(2)]
    for o in outs:
        os.makedirs(o)
    procs = [
        subprocess.Popen(
            [sys.executable, worker, coord, str(i), "2", fq, outs[i], mode,
             os.path.dirname(os.path.dirname(os.path.abspath(__file__)))],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            env=env, cwd=os.path.dirname(os.path.abspath(__file__)),
        )
        for i in range(2)
    ]
    results = []
    for p in procs:
        out, err = p.communicate(timeout=240)
        assert p.returncode == 0, err.decode()[-3000:]
        results.append(json.loads(out.decode().strip().splitlines()[-1]))

    # both processes converge to identical global counters
    a, b = results
    for k in a:
        if k != "pid":
            assert a[k] == b[k], (k, a[k], b[k])

    # equal to the single-process truth
    from hpgq.options import StatsOptions
    from hpgq.pipeline.run import run_stats

    o = StatsOptions()
    o.in_filename = fq
    o.out_dirname = str(tmp_path / "ref")
    os.makedirs(o.out_dirname)
    o.quality_encoding_value = 33
    o.quality_encoding_name = "phred33"
    o.batch_size = 512
    if mode == "filtered":
        o.criteria.min_read_quality = 18
        o.criteria.max_read_quality = 40
        o.filter_on = True
    ref = run_stats(o)
    assert a["num_reads"] == ref.num_reads
    assert a["num_passed"] == ref.num_passed
    assert a["num_failed"] == ref.num_failed
    assert a["acc_length"] == ref.acc_length
    assert a["min_length"] == ref.min_length
    assert a["max_length"] == ref.max_length
    assert a["num_As"] == ref.num_As
    assert a["num_Ns"] == ref.num_Ns
    assert a["qual_per_nt_sum"] == int(ref.acc_quality_per_nt.sum())
    # process-0's report matches the single-process report byte-for-byte
    name = os.path.basename(fq) + ".summary.txt"
    assert (
        open(os.path.join(outs[0], name), "rb").read()
        == open(os.path.join(o.out_dirname, name), "rb").read()
    )


def test_two_process_wire_tiers(tmp_path):
    """2-process lockstep with the adaptive bitpack wire: the file's first
    half is RTA3-binned (rank 0's byte range → 2q tier) and the second
    half unbinned (rank 1 → 6-bit tier), so the per-step tier vote must
    escalate every step both ranks are active, and the exhausted-rank
    empty feeds must match the voted width.  Counters must equal the
    single-process wire-off truth."""
    n = 2400
    half = str(tmp_path / "half.fq")
    rest = str(tmp_path / "rest.fq")
    make_fastq(half, n // 2, min_len=40, max_len=110, n_prob=0.02, seed=41,
               qual_bins=(2, 12, 23, 37))
    make_fastq(rest, n // 2, min_len=40, max_len=110, n_prob=0.02, seed=42)
    fq = str(tmp_path / "in.fq")
    with open(fq, "wb") as f:
        f.write(open(half, "rb").read())
        f.write(open(rest, "rb").read())

    worker = str(tmp_path / "worker.py")
    open(worker, "w").write(_WORKER)
    coord = "localhost:%d" % _free_port()
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}
    env["HPGQ_WIRE"] = "bitpack"
    outs = [str(tmp_path / ("out%d" % i)) for i in range(2)]
    for o in outs:
        os.makedirs(o)
    procs = [
        subprocess.Popen(
            [sys.executable, worker, coord, str(i), "2", fq, outs[i],
             "filtered",
             os.path.dirname(os.path.dirname(os.path.abspath(__file__)))],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            env=env, cwd=os.path.dirname(os.path.abspath(__file__)),
        )
        for i in range(2)
    ]
    results = []
    for p in procs:
        out, err = p.communicate(timeout=240)
        assert p.returncode == 0, err.decode()[-3000:]
        results.append(json.loads(out.decode().strip().splitlines()[-1]))
    a, b = results
    for k in a:
        if k != "pid":
            assert a[k] == b[k], (k, a[k], b[k])

    from hpgq.options import StatsOptions
    from hpgq.pipeline.run import run_stats

    o = StatsOptions()
    o.in_filename = fq
    o.out_dirname = str(tmp_path / "ref")
    os.makedirs(o.out_dirname)
    o.quality_encoding_value = 33
    o.quality_encoding_name = "phred33"
    o.batch_size = 512
    o.criteria.min_read_quality = 18
    o.criteria.max_read_quality = 40
    o.filter_on = True
    ref = run_stats(o)
    assert a["num_reads"] == ref.num_reads
    assert a["num_passed"] == ref.num_passed
    assert a["num_failed"] == ref.num_failed
    assert a["acc_length"] == ref.acc_length
    assert a["num_As"] == ref.num_As
    assert a["num_Ns"] == ref.num_Ns
    assert a["qual_per_nt_sum"] == int(ref.acc_quality_per_nt.sum())


def test_two_process_wire_2c(tmp_path):
    """2-process lockstep where the 2c tier WINS the vote: a fully
    RTA3-binned N-containing corpus — both ranks probe tier -1, the
    5-wide vote carries the per-device exception-bucket element, and the
    sharded step decodes each rank's regrouped sidecar.  Counters must
    equal the single-process wire-off truth (incl. num_Ns: the exact-N
    restoration crossing process + device sharding)."""
    n = 2400
    fq = str(tmp_path / "b2c.fq")
    make_fastq(fq, n, min_len=40, max_len=110, n_prob=0.03, seed=43,
               qual_bins=(2, 12, 23, 37))

    worker = str(tmp_path / "worker.py")
    open(worker, "w").write(_WORKER)
    coord = "localhost:%d" % _free_port()
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}
    env["HPGQ_WIRE"] = "bitpack"
    outs = [str(tmp_path / ("out%d" % i)) for i in range(2)]
    for o in outs:
        os.makedirs(o)
    procs = [
        subprocess.Popen(
            [sys.executable, worker, coord, str(i), "2", fq, outs[i],
             "filtered",
             os.path.dirname(os.path.dirname(os.path.abspath(__file__)))],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            env=env, cwd=os.path.dirname(os.path.abspath(__file__)),
        )
        for i in range(2)
    ]
    results = []
    for p in procs:
        out, err = p.communicate(timeout=240)
        assert p.returncode == 0, err.decode()[-3000:]
        results.append(json.loads(out.decode().strip().splitlines()[-1]))
    a, b = results
    for k in a:
        if k != "pid":
            assert a[k] == b[k], (k, a[k], b[k])

    from hpgq.options import StatsOptions
    from hpgq.pipeline.run import run_stats

    o = StatsOptions()
    o.in_filename = fq
    o.out_dirname = str(tmp_path / "ref")
    os.makedirs(o.out_dirname)
    o.quality_encoding_value = 33
    o.quality_encoding_name = "phred33"
    o.batch_size = 512
    o.criteria.min_read_quality = 18
    o.criteria.max_read_quality = 40
    o.filter_on = True
    ref = run_stats(o)
    for k, v in (("num_reads", ref.num_reads),
                 ("num_passed", ref.num_passed),
                 ("num_failed", ref.num_failed),
                 ("acc_length", ref.acc_length),
                 ("num_As", ref.num_As), ("num_Ns", ref.num_Ns),
                 ("qual_per_nt_sum", int(ref.acc_quality_per_nt.sum()))):
        assert a[k] == v, (k, a[k], v)


_OUTPUT_WORKER = r"""
import json, os, sys

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
import jax

jax.config.update("jax_platforms", "cpu")

coord, pid, nproc, fq, outdir, cmd, repo = sys.argv[1:8]
jax.distributed.initialize(coord, int(nproc), int(pid))

sys.path.insert(0, repo)
from hpgq.options import EditOptions, FilterOptions

if cmd == "filter":
    from hpgq.dist.run_dist import run_filter_sharded as runner

    o = FilterOptions()
    o.criteria.min_read_quality = 18
    o.criteria.max_read_quality = 40
    o.criteria.max_N = 3
else:
    from hpgq.dist.run_dist import run_edit_sharded as runner

    o = EditOptions()
    o.criteria.left_length = 8
    o.criteria.min_left_quality = 24
    o.criteria.max_left_quality = 60
    o.criteria.min_read_quality = 18
    o.criteria.max_read_quality = 45
    o.filter_on = True
o.in_filename = fq
o.out_dirname = outdir
o.quality_encoding_value = 33
o.quality_encoding_name = "phred33"
o.batch_size = 300
res = runner(o)
print(json.dumps({"pid": int(pid),
                  "num_passed": res.get("num_passed", 0),
                  "num_failed": res.get("num_failed", 0),
                  "num_edited": res.get("num_edited", 0)}))
"""


@pytest.mark.parametrize("cmd", ["filter", "edit"])
def test_two_process_sharded_output(tmp_path, cmd):
    """2-process sharded filter/edit: shared outdir, per-rank shards,
    deterministic concat == the single-process output byte-for-byte."""
    n = 2400
    fq = str(tmp_path / "in.fq")
    make_fastq(fq, n, min_len=40, max_len=110, n_prob=0.02, seed=31)

    worker = str(tmp_path / "w.py")
    open(worker, "w").write(_OUTPUT_WORKER)
    coord = "localhost:%d" % _free_port()
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}
    shared = str(tmp_path / "out")
    os.makedirs(shared)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    procs = [
        subprocess.Popen(
            [sys.executable, worker, coord, str(i), "2", fq, shared, cmd, repo],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, env=env,
        )
        for i in range(2)
    ]
    results = []
    for p in procs:
        out, err = p.communicate(timeout=240)
        assert p.returncode == 0, err.decode()[-3000:]
        results.append(json.loads(out.decode().strip().splitlines()[-1]))

    # single-process truth
    from hpgq.options import EditOptions, FilterOptions
    from hpgq.pipeline.run import run_edit, run_filter

    ref_dir = str(tmp_path / "ref")
    os.makedirs(ref_dir)
    if cmd == "filter":
        o = FilterOptions()
        o.criteria.min_read_quality = 18
        o.criteria.max_read_quality = 40
        o.criteria.max_N = 3
        runner = run_filter
        names = ["passed.fq", "failed.fq"]
    else:
        o = EditOptions()
        o.criteria.left_length = 8
        o.criteria.min_left_quality = 24
        o.criteria.max_left_quality = 60
        o.criteria.min_read_quality = 18
        o.criteria.max_read_quality = 45
        o.filter_on = True
        runner = run_edit
        names = ["edit.fq", "failed.fq"]
    o.in_filename = fq
    o.out_dirname = ref_dir
    o.quality_encoding_value = 33
    o.quality_encoding_name = "phred33"
    o.batch_size = 512
    ref = runner(o)

    a, b = results
    for k in ("num_passed", "num_failed", "num_edited"):
        assert a[k] == b[k], (k, a, b)
        assert a[k] == ref.get(k, 0), (k, a[k], ref.get(k, 0))
    for name in names:
        got = open(os.path.join(shared, name), "rb").read()
        want = open(os.path.join(ref_dir, name), "rb").read()
        assert got == want, "%s differs from single-process output" % name
    # no shard leftovers
    assert not [f for f in os.listdir(shared) if ".shard" in f]


_PAIRED_WORKER = r"""
import json, os, sys

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
import jax

jax.config.update("jax_platforms", "cpu")

coord, pid, nproc, fq1, fq2, outdir, repo = sys.argv[1:8]
jax.distributed.initialize(coord, int(nproc), int(pid))

sys.path.insert(0, repo)
from hpgq.options import StatsOptions
from hpgq.dist.run_dist import run_stats_sharded

o = StatsOptions()
o.in_filename = fq1
o.in_filename2 = fq2
o.out_dirname = outdir
o.quality_encoding_value = 33
o.quality_encoding_name = "phred33"
o.batch_size = 300
o.criteria.min_read_quality = 18
o.criteria.max_read_quality = 40
o.filter_on = True
c1, c2 = run_stats_sharded(o)
print(json.dumps({
    "pid": int(pid),
    "r1": [c1.num_reads, c1.num_passed, c1.num_failed, c1.acc_length,
           int(c1.length_hist.sum()), int(c1.acc_quality_per_nt.sum())],
    "r2": [c2.num_reads, c2.num_passed, c2.num_failed, c2.acc_length,
           int(c2.length_hist.sum()), int(c2.acc_quality_per_nt.sum())],
}))
"""


def test_two_process_sharded_paired_stats(tmp_path):
    """2-process paired-end sharded stats (record-count-aligned mate
    ranges + pair-consistent inline filter) == single-process paired run."""
    n = 2000
    fq1 = str(tmp_path / "m1.fq")
    fq2 = str(tmp_path / "m2.fq")
    make_fastq(fq1, n, min_len=40, max_len=110, n_prob=0.02, seed=41)
    make_fastq(fq2, n, min_len=35, max_len=120, n_prob=0.02, seed=42)

    worker = str(tmp_path / "pw.py")
    open(worker, "w").write(_PAIRED_WORKER)
    coord = "localhost:%d" % _free_port()
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}
    outs = [str(tmp_path / ("po%d" % i)) for i in range(2)]
    for o in outs:
        os.makedirs(o)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    procs = [
        subprocess.Popen(
            [sys.executable, worker, coord, str(i), "2", fq1, fq2, outs[i],
             repo],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, env=env,
        )
        for i in range(2)
    ]
    results = []
    for p in procs:
        out, err = p.communicate(timeout=240)
        assert p.returncode == 0, err.decode()[-3000:]
        results.append(json.loads(out.decode().strip().splitlines()[-1]))

    from hpgq.options import StatsOptions
    from hpgq.pipeline.run import run_stats

    o = StatsOptions()
    o.in_filename = fq1
    o.in_filename2 = fq2
    o.out_dirname = str(tmp_path / "pref")
    os.makedirs(o.out_dirname)
    o.quality_encoding_value = 33
    o.quality_encoding_name = "phred33"
    o.batch_size = 512
    o.criteria.min_read_quality = 18
    o.criteria.max_read_quality = 40
    o.filter_on = True
    r1, r2 = run_stats(o)

    a, b = results
    assert a["r1"] == b["r1"] and a["r2"] == b["r2"]
    assert a["r1"] == [r1.num_reads, r1.num_passed, r1.num_failed,
                       r1.acc_length, int(r1.length_hist.sum()),
                       int(r1.acc_quality_per_nt.sum())]
    assert a["r2"] == [r2.num_reads, r2.num_passed, r2.num_failed,
                       r2.acc_length, int(r2.length_hist.sum()),
                       int(r2.acc_quality_per_nt.sum())]


_CGR_WORKER = r"""
import json, os, sys

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
import jax

jax.config.update("jax_platforms", "cpu")

coord, pid, nproc, fq, outdir, repo = sys.argv[1:7]
jax.distributed.initialize(coord, int(nproc), int(pid))

sys.path.insert(0, repo)
from hpgq.options import CgrOptions
from hpgq.dist.run_dist import run_cgr_sharded

o = CgrOptions()
o.in_filename = fq
o.out_dirname = outdir
o.quality_encoding_value = 33
o.quality_encoding_name = "phred33"
o.batch_size = 300
o.k = 4
res = run_cgr_sharded(o)
print(json.dumps({"pid": int(pid), "words": int(res["fq_word_count"])}))
"""


def test_two_process_sharded_cgr(tmp_path):
    n = 2000
    fq = str(tmp_path / "c.fq")
    make_fastq(fq, n, min_len=40, max_len=110, n_prob=0.02, seed=23)

    worker = str(tmp_path / "cgr_worker.py")
    open(worker, "w").write(_CGR_WORKER)
    coord = "localhost:%d" % _free_port()
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}
    outs = [str(tmp_path / ("o%d" % i)) for i in range(2)]
    for o in outs:
        os.makedirs(o)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    procs = [
        subprocess.Popen(
            [sys.executable, worker, coord, str(i), "2", fq, outs[i], repo],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, env=env,
        )
        for i in range(2)
    ]
    results = []
    for p in procs:
        out, err = p.communicate(timeout=240)
        assert p.returncode == 0, err.decode()[-3000:]
        results.append(json.loads(out.decode().strip().splitlines()[-1]))
    assert results[0]["words"] == results[1]["words"]

    # local truth
    from hpgq.options import CgrOptions
    from hpgq.pipeline.cgr_run import run_cgr

    o = CgrOptions()
    o.in_filename = fq
    o.out_dirname = str(tmp_path / "ref")
    os.makedirs(o.out_dirname)
    o.quality_encoding_value = 33
    o.quality_encoding_name = "phred33"
    o.batch_size = 512
    o.k = 4
    ref = run_cgr(o)
    assert results[0]["words"] == ref["fq_word_count"]
    # process-0 PGM matches the local PGM byte-for-byte
    name = "c.fq_k=4_FG.pgm"
    assert (
        open(os.path.join(outs[0], name), "rb").read()
        == open(os.path.join(o.out_dirname, name), "rb").read()
    )


_RESUME_WORKER = r"""
import json, os, sys

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
import jax

jax.config.update("jax_platforms", "cpu")

coord, pid, nproc, fq, outdir, repo, ck, mode = sys.argv[1:9]
jax.distributed.initialize(coord, int(nproc), int(pid))

sys.path.insert(0, repo)
from hpgq.options import StatsOptions
from hpgq.dist import run_dist
from hpgq.dist.run_dist import run_stats_sharded

o = StatsOptions()
o.in_filename = fq
o.out_dirname = outdir
o.quality_encoding_value = 33
o.quality_encoding_name = "phred33"
o.batch_size = 200
if ck != "-":
    o.checkpoint_path = ck
    o.checkpoint_every = 1

if mode == "crash":
    real = run_dist.ShardedStatsSession.feed_block
    state = {"n": 0}

    def limited(self, block, **kw):
        if state["n"] >= 3:
            print("CRASHING", flush=True)
            os._exit(3)  # hard kill mid-run, after >=3 checkpoints
        state["n"] += 1
        return real(self, block, **kw)

    run_dist.ShardedStatsSession.feed_block = limited

c = run_stats_sharded(o)
print(json.dumps({
    "num_reads": c.num_reads, "acc_length": c.acc_length,
    "num_As": c.num_As, "min_length": c.min_length,
    "max_length": c.max_length,
    "qph_sum": int(c.acc_quality_per_nt.sum()),
}))
"""


def _run_pair(worker, fq, outs, ck, mode, expect_fail=False):
    coord = "localhost:%d" % _free_port()
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    procs = [
        subprocess.Popen(
            [sys.executable, worker, coord, str(i), "2", fq, outs[i], repo,
             ck, mode],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, env=env,
        )
        for i in range(2)
    ]
    results = []
    for p in procs:
        out, err = p.communicate(timeout=240)
        if expect_fail:
            results.append(p.returncode)
        else:
            assert p.returncode == 0, err.decode()[-3000:]
            results.append(json.loads(out.decode().strip().splitlines()[-1]))
    return results


def test_two_process_sharded_resume(tmp_path):
    n = 2000
    fq = str(tmp_path / "rr.fq")
    make_fastq(fq, n, min_len=50, max_len=100, seed=61)
    worker = str(tmp_path / "w.py")
    open(worker, "w").write(_RESUME_WORKER)

    outs_ref = [str(tmp_path / ("ref%d" % i)) for i in range(2)]
    outs = [str(tmp_path / ("o%d" % i)) for i in range(2)]
    for o in outs_ref + outs:
        os.makedirs(o)

    ref = _run_pair(worker, fq, outs_ref, "-", "plain")
    assert ref[0] == ref[1]

    ck = str(tmp_path / "mp.ck.npz")
    rcs = _run_pair(worker, fq, outs, ck, "crash", expect_fail=True)
    assert 3 in rcs  # at least one process self-killed mid-run
    import glob
    assert glob.glob(ck + ".rank*")

    resumed = _run_pair(worker, fq, outs, ck, "plain")
    assert resumed[0] == resumed[1] == ref[0]
    assert not glob.glob(ck + ".rank*")


_VOTED_WORKER = r"""
import json, os, sys

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
import jax

jax.config.update("jax_platforms", "cpu")

coord, pid, nproc, fq, outdir, repo, wire = sys.argv[1:8]
jax.distributed.initialize(coord, int(nproc), int(pid))

os.environ["HPGQ_WIRE"] = wire
sys.path.insert(0, repo)
from hpgq.options import StatsOptions
from hpgq.dist.run_dist import run_stats_sharded

o = StatsOptions()
o.in_filename = fq
o.out_dirname = outdir
o.quality_encoding_value = 33
o.quality_encoding_name = "phred33"
# deliberately UNEQUAL per-rank batch sizes: the ranks' step counts and
# per-step (lmax, rows, rawlen) buckets all differ, so every step's voted
# trimmed dispatch shape is exercised (incl. empty tail feeds on the
# faster rank)
o.batch_size = 250 if int(pid) == 0 else 700
c = run_stats_sharded(o)
print(json.dumps({
    "num_reads": c.num_reads, "acc_length": c.acc_length,
    "min_length": c.min_length, "max_length": c.max_length,
    "num_As": c.num_As, "num_Ns": c.num_Ns,
    "length_hist_sum": int(c.length_hist.sum()),
    "qual_per_nt_sum": int(c.acc_quality_per_nt.sum()),
    "gc_hist_sum": int((c.gc_hist * range(len(c.gc_hist))).sum()),
}))
"""


@pytest.mark.parametrize("wire", ["bitpack", "off"])
def test_two_process_voted_trimmed_shapes(tmp_path, wire):
    """Multihost lockstep with per-step voted TRIMMED shapes: the two
    ranks see different read-length regimes (short first half, long second
    half, incl. a mid-stream lcap growth past 128) and use different batch
    sizes, so the voted (lmax, rows, rawlen) tuple differs from either
    rank's local buckets on most steps.  Global counters must equal the
    single-process truth."""
    from gen import make_records, write_fastq

    recs = (make_records(1200, min_len=40, max_len=70, seed=71)
            + make_records(1200, min_len=90, max_len=200, n_prob=0.02,
                           seed=72))
    fq = str(tmp_path / "v.fq")
    write_fastq(fq, recs)

    worker = str(tmp_path / "vw.py")
    open(worker, "w").write(_VOTED_WORKER)
    coord = "localhost:%d" % _free_port()
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "XLA_FLAGS", "HPGQ_WIRE")}
    outs = [str(tmp_path / ("vo%d" % i)) for i in range(2)]
    for o in outs:
        os.makedirs(o)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    procs = [
        subprocess.Popen(
            [sys.executable, worker, coord, str(i), "2", fq, outs[i], repo,
             wire],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, env=env,
        )
        for i in range(2)
    ]
    results = []
    for p in procs:
        out, err = p.communicate(timeout=240)
        assert p.returncode == 0, err.decode()[-3000:]
        results.append(json.loads(out.decode().strip().splitlines()[-1]))
    assert results[0] == results[1]

    from hpgq.options import StatsOptions
    from hpgq.pipeline.run import run_stats

    o = StatsOptions()
    o.in_filename = fq
    o.out_dirname = str(tmp_path / "vref")
    os.makedirs(o.out_dirname)
    o.quality_encoding_value = 33
    o.quality_encoding_name = "phred33"
    o.batch_size = 512
    ref = run_stats(o)
    a = results[0]
    assert a["num_reads"] == ref.num_reads
    assert a["acc_length"] == ref.acc_length
    assert a["min_length"] == ref.min_length
    assert a["max_length"] == ref.max_length
    assert a["num_As"] == ref.num_As
    assert a["num_Ns"] == ref.num_Ns
    assert a["length_hist_sum"] == int(ref.length_hist.sum())
    assert a["qual_per_nt_sum"] == int(ref.acc_quality_per_nt.sum())
    assert a["gc_hist_sum"] == int(
        (ref.gc_hist * np.arange(len(ref.gc_hist))).sum()
    )


_PAIRED_RESUME_WORKER = r"""
import json, os, sys

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
import jax

jax.config.update("jax_platforms", "cpu")

coord, pid, nproc, fq1, fq2, outdir, repo, ck, mode = sys.argv[1:10]
jax.distributed.initialize(coord, int(nproc), int(pid))

sys.path.insert(0, repo)
from hpgq.options import StatsOptions
from hpgq.dist import run_dist
from hpgq.dist.run_dist import run_stats_sharded

o = StatsOptions()
o.in_filename = fq1
o.in_filename2 = fq2
o.out_dirname = outdir
o.quality_encoding_value = 33
o.quality_encoding_name = "phred33"
o.batch_size = 200
o.criteria.min_read_quality = 18
o.criteria.max_read_quality = 40
o.filter_on = True
if ck != "-":
    o.checkpoint_path = ck
    o.checkpoint_every = 1

if mode == "crash":
    real = run_dist.ShardedPairedStatsSession.feed_pair
    state = {"n": 0}

    def limited(self, b1, b2, **kw):
        if state["n"] >= 3:  # 1 fused step/pair -> >=3 paired checkpoints
            print("CRASHING", flush=True)
            os._exit(3)
        state["n"] += 1
        return real(self, b1, b2, **kw)

    run_dist.ShardedPairedStatsSession.feed_pair = limited

c1, c2 = run_stats_sharded(o)
print(json.dumps({
    "r1": [c1.num_reads, c1.num_passed, c1.num_failed, c1.acc_length,
           int(c1.length_hist.sum()), int(c1.acc_quality_per_nt.sum())],
    "r2": [c2.num_reads, c2.num_passed, c2.num_failed, c2.acc_length,
           int(c2.length_hist.sum()), int(c2.acc_quality_per_nt.sum())],
}))
"""


def test_two_process_sharded_paired_resume(tmp_path):
    """2-process sharded PAIRED stats crash/resume: per-rank rotating
    checkpoints vote a common ordinal, both mates' offsets restore, final
    counters equal the uninterrupted 2-process run."""
    import glob

    n = 1800
    fq1 = str(tmp_path / "q1.fq")
    fq2 = str(tmp_path / "q2.fq")
    make_fastq(fq1, n, min_len=40, max_len=100, seed=91)
    make_fastq(fq2, n, min_len=35, max_len=110, seed=92)
    worker = str(tmp_path / "prw.py")
    open(worker, "w").write(_PAIRED_RESUME_WORKER)

    def run_pair(ck, mode, expect_fail=False):
        coord = "localhost:%d" % _free_port()
        env = {k: v for k, v in os.environ.items()
               if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}
        repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        outs = []
        for i in range(2):
            d = str(tmp_path / ("pr_%s_%d" % (mode, i)))
            os.makedirs(d, exist_ok=True)
            outs.append(d)
        procs = [
            subprocess.Popen(
                [sys.executable, worker, coord, str(i), "2", fq1, fq2,
                 outs[i], repo, ck, mode],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, env=env,
            )
            for i in range(2)
        ]
        results = []
        for p in procs:
            out, err = p.communicate(timeout=240)
            if expect_fail:
                results.append(p.returncode)
            else:
                assert p.returncode == 0, err.decode()[-3000:]
                results.append(
                    json.loads(out.decode().strip().splitlines()[-1]))
        return results

    ref = run_pair("-", "plain")
    assert ref[0] == ref[1]

    ck = str(tmp_path / "pmp.ck.npz")
    rcs = run_pair(ck, "crash", expect_fail=True)
    assert 3 in rcs
    assert glob.glob(ck + ".rank*")

    resumed = run_pair(ck, "resume")
    assert resumed[0] == resumed[1] == ref[0]
    assert not glob.glob(ck + ".rank*")


_FILTER_RESUME_WORKER = r"""
import json, os, sys

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
import jax

jax.config.update("jax_platforms", "cpu")

coord, pid, nproc, fq, outdir, repo, ck, mode = sys.argv[1:9]
jax.distributed.initialize(coord, int(nproc), int(pid))

sys.path.insert(0, repo)
from hpgq.options import FilterOptions
from hpgq.dist.run_dist import run_filter_sharded

o = FilterOptions()
o.in_filename = fq
o.out_dirname = outdir
o.quality_encoding_value = 33
o.quality_encoding_name = "phred33"
o.batch_size = 200
o.criteria.min_read_quality = 18
o.criteria.max_read_quality = 40
o.criteria.max_N = 3
if ck != "-":
    o.checkpoint_path = ck
    o.checkpoint_every = 1

if mode == "crash":
    from hpgq.io import fastq as fq_mod

    real = fq_mod.RecordBlock.write_selected
    state = {"n": 0}

    def limited(self, out, select, *a, **k):
        if state["n"] >= 6:  # 2 writes/block -> >=3 blocks, >=2 checkpoints
            print("CRASHING", flush=True)
            os._exit(3)
        state["n"] += 1
        return real(self, out, select, *a, **k)

    fq_mod.RecordBlock.write_selected = limited

res = run_filter_sharded(o)
print(json.dumps({"num_passed": res["num_passed"],
                  "num_failed": res["num_failed"]}))
"""


def test_two_process_sharded_filter_resume(tmp_path):
    """2-process sharded filter crash/resume: each rank resumes its own
    shard from its per-rank checkpoint; the concatenated outputs are
    byte-identical to the single-process run."""
    import glob

    n = 2400
    fq = str(tmp_path / "fr.fq")
    make_fastq(fq, n, min_len=40, max_len=110, n_prob=0.02, seed=93)
    worker = str(tmp_path / "frw.py")
    open(worker, "w").write(_FILTER_RESUME_WORKER)
    shared = str(tmp_path / "fout")
    os.makedirs(shared)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

    def run_pair(ck, mode, expect_fail=False):
        coord = "localhost:%d" % _free_port()
        env = {k: v for k, v in os.environ.items()
               if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}
        procs = [
            subprocess.Popen(
                [sys.executable, worker, coord, str(i), "2", fq, shared,
                 repo, ck, mode],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, env=env,
            )
            for i in range(2)
        ]
        results = []
        for p in procs:
            out, err = p.communicate(timeout=240)
            if expect_fail:
                results.append(p.returncode)
            else:
                assert p.returncode == 0, err.decode()[-3000:]
                results.append(
                    json.loads(out.decode().strip().splitlines()[-1]))
        return results

    ck = str(tmp_path / "fmp.ck.npz")
    rcs = run_pair(ck, "crash", expect_fail=True)
    # both ranks die mid-shard: at least one via the injected self-kill
    # (exit 3); the other may instead abort when the coordinator (rank 0)
    # vanishes under it (exit 1) — shards are independent, so either way
    # is a valid crash to resume from
    assert 3 in rcs and all(rc != 0 for rc in rcs), rcs
    assert glob.glob(ck + ".rank*")  # >=1 rank checkpointed before dying

    resumed = run_pair(ck, "resume")
    assert resumed[0] == resumed[1]
    assert not glob.glob(ck + ".rank*")

    # single-process truth, byte-identical outputs
    from hpgq.options import FilterOptions
    from hpgq.pipeline.run import run_filter

    ref_dir = str(tmp_path / "fref")
    os.makedirs(ref_dir)
    o = FilterOptions()
    o.in_filename = fq
    o.out_dirname = ref_dir
    o.quality_encoding_value = 33
    o.quality_encoding_name = "phred33"
    o.batch_size = 512
    o.criteria.min_read_quality = 18
    o.criteria.max_read_quality = 40
    o.criteria.max_N = 3
    ref = run_filter(o)
    assert resumed[0]["num_passed"] == ref["num_passed"]
    assert resumed[0]["num_failed"] == ref["num_failed"]
    for name in ("passed.fq", "failed.fq"):
        assert (
            open(os.path.join(shared, name), "rb").read()
            == open(os.path.join(ref_dir, name), "rb").read()
        ), name
