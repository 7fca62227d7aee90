"""bench.py truncation-guard contract: a SIGALRM/SIGTERM at
ANY point — including before the first measurement — must still yield a
parsable final headline JSON line on stdout and a non-empty
``bench_phase_seconds`` dict on stderr; these tests pin the bounded
time-to-first-metric behavior on the CPU backend (``JAX_PLATFORMS=cpu``).
Every metric line names its device, and without a GPU (and without that
variable) the bench refuses to measure.
"""

import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(REPO, "bench.py")


def _run_bench(tmp_path, budget_s, reads=6000, timeout=240, platforms="cpu"):
    env = dict(os.environ)
    env["HPGQ_BENCH_BUDGET_S"] = str(budget_s)
    env["HPGQ_BENCH_DIR"] = str(tmp_path / "benchdir")
    env["HPGQ_CHARTS"] = "off"
    env.pop("JAX_PLATFORMS", None)
    if platforms:
        env["JAX_PLATFORMS"] = platforms
    r = subprocess.run(
        [sys.executable, BENCH, "--reads", str(reads),
         "--oracle-reads", "3000"],
        capture_output=True, text=True, timeout=timeout, cwd=REPO, env=env,
    )
    return r


def _last_stdout_json(r):
    lines = [ln for ln in r.stdout.strip().splitlines() if ln.strip()]
    assert lines, "no stdout lines:\n%s\n%s" % (r.stdout, r.stderr[-2000:])
    return json.loads(lines[-1])


def _phase_dicts(r):
    out = []
    for ln in r.stderr.splitlines():
        try:
            obj = json.loads(ln)
        except ValueError:
            continue
        if "bench_phase_seconds" in obj:
            out.append(obj)
    return out


def test_bench_truncated_immediately(tmp_path):
    """Alarm fires ~1 s in (mid corpus-gen/bootstrap): the run must still
    end rc=0 with a parsable headline line and phase forensics naming the
    phase that was in flight."""
    r = _run_bench(tmp_path, budget_s=1)
    assert r.returncode == 0, r.stderr[-2000:]
    head = _last_stdout_json(r)
    assert head["metric"] == "stats_filter_reads_per_sec"
    assert "value" in head and "vs_baseline" in head
    assert head["device"]["platform"] == "cpu"
    phases = _phase_dicts(r)
    assert phases, r.stderr[-2000:]
    ph = phases[-1]["bench_phase_seconds"]
    assert ph, "phase dict must not be empty on truncation"
    # the in-flight phase is recorded with an @kill suffix unless the run
    # happened to be exactly between phases
    assert any(k for k in ph), ph


def test_bench_tiny_budget_completes_with_headline(tmp_path):
    """A short-but-workable budget on a tiny CPU corpus: the bootstrap
    registers a provisional headline early, so whether or not the alarm
    fires later, the final stdout line is a real measured headline."""
    r = _run_bench(tmp_path, budget_s=45, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    head = _last_stdout_json(r)
    assert head["metric"] == "stats_filter_reads_per_sec"
    assert head["value"] > 0, (head, r.stderr[-2000:])
    assert head["vs_baseline"] > 0
    assert head.get("qual_shape") == "rta3"
    assert head["device"]["platform"] == head["device"]["kind"] == "cpu"
    assert head["device"]["count"] >= 1
    assert "card" in head
    phases = _phase_dicts(r)
    assert phases and phases[-1]["bench_phase_seconds"]


def test_bench_refuses_without_gpu(tmp_path):
    """No GPU and no JAX_PLATFORMS=cpu: the bench exits non-zero before any
    measurement and prints no metric line (a CPU number must never pass
    for a device number)."""
    r = _run_bench(tmp_path, budget_s=30, timeout=120, platforms=None)
    assert r.returncode != 0
    assert "no GPU found" in r.stderr, r.stderr[-2000:]
    assert '"metric"' not in r.stdout
