"""chip_smoke.py on the CPU at a tiny size: every phase against its oracle,
phase 0's refusal of a non-GPU device, the script's refusal to report a
result without a GPU or without the repository, and the ``--four-cards``
body on 4 virtual CPU devices.  The ``gpu`` test runs the phases on a card.
"""

import json
import os
import shutil
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402

TINY = chip_smoke.Sizes(reads=3000, pairs=1500, cgr_reads=600, long_reads=6,
                        step_rows=512, four_reads=2000, batch_size=256)


@pytest.fixture(scope="module")
def ctx(tmp_path_factory):
    c = chip_smoke.Ctx(TINY, seed=3, workdir=str(
        tmp_path_factory.mktemp("smoke") / "work"), workers=2)
    yield c
    c.close()


@pytest.mark.parametrize("num,name,fn", chip_smoke.PHASES,
                         ids=[p[1] for p in chip_smoke.PHASES])
def test_phase(ctx, num, name, fn):
    assert chip_smoke.run_phase(num, name, fn, ctx)


def test_phase0_refuses_cpu(ctx):
    with pytest.raises(SystemExit, match="no gpu"):
        chip_smoke.phase_device(ctx)


def test_spy_records_outermost_call():
    import types

    mod = types.SimpleNamespace()
    mod.f = lambda n: n if n == 0 else mod.f(n - 1) + 1
    with chip_smoke.spy(mod, "f") as calls:
        assert mod.f(3) == 3
    assert [(a, out) for a, _, out in calls] == [((3,), 3)]
    assert mod.f(2) == 2  # restored


def _run(args, cwd, platforms="cpu", devices=None, timeout=300):
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    env.pop("XLA_FLAGS", None)
    if platforms:
        env["JAX_PLATFORMS"] = platforms
    if devices:
        env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=%d" % devices
    return subprocess.run([sys.executable] + args, cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=timeout)


def test_script_refuses_cpu(tmp_path):
    r = _run([os.path.join(REPO, "chip_smoke.py"), "--workdir",
              str(tmp_path / "w")], REPO)
    assert r.returncode != 0
    assert "no gpu" in r.stderr
    assert '"ok"' not in r.stdout


def test_script_alone_fails(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    r = _run([str(tmp_path / "chip_smoke.py")], str(tmp_path))
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_four_cards_on_virtual_cpus(tmp_path):
    r = _run([os.path.join(REPO, "chip_smoke.py"), "--four-cards",
              "--rehearse-on-cpu", "--reads", "2000", "--batch-size", "256",
              "--workdir", str(tmp_path / "w")], REPO, devices=4)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    lines = r.stdout.strip().splitlines()
    assert json.loads(lines[-1]) == {
        "rehearsal": True,
        "device": {"platform": "cpu", "kind": "cpu", "count": 4}}
    legs = [ln for ln in lines if ln.startswith("phase 4c")]
    assert len(legs) == 4 and all(" PASS " in ln for ln in legs), legs


@pytest.fixture
def gpu():
    import jax

    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs an NVIDIA GPU (JAX_PLATFORMS=cuda)")


@pytest.mark.gpu
def test_phases_on_gpu(gpu, tmp_path):
    c = chip_smoke.Ctx(chip_smoke.Sizes(reads=50_000, pairs=20_000,
                                        cgr_reads=20_000, long_reads=100,
                                        step_rows=16_384),
                       seed=4, workdir=str(tmp_path / "work"))
    try:
        assert chip_smoke.run_phase("0", "device", chip_smoke.phase_device, c)
        for num, name, fn in chip_smoke.PHASES:
            assert chip_smoke.run_phase(num, name, fn, c)
    finally:
        c.close()
