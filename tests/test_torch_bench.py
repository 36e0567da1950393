"""`python -m tpurt_torch.bench`, the port's counterpart of bench.py, on the
CPU at a small size: the last printed line is bench.py's record with
every key, `vs_baseline` null and the box golden within 1e-5; its ray
counts are the renderer's for the same samples; a deadline shorter than
one sample still ends in a final record with a note; the watchdog prints
a record at the deadline; and without a card the harness exits non-zero
instead of falling back to the CPU."""

import json
import os
import subprocess
import sys

import pytest
import torch

from tpurt_torch import bench

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(width=64, height=48, scene_kw=dict(columns=2, foliage=8), spp_per_launch=1)
# bench.py's record (mk_record), plus `note` when partial
KEYS = {"metric", "value", "unit", "vs_baseline", "rays_traced_physical", "rays_logical",
        "mrays_per_sec_logical", "seconds", "samples_done", "bands_timed",
        "time_to_1024spp_s", "rmse_vs_golden"}


def _records(text):
    return [json.loads(line) for line in text.splitlines() if line.startswith("{")]


@pytest.fixture(scope="module")
def sample_counts():
    """{sample: (logical, physical)} of samples 1 and 2 as Renderer.step
    counts them (Renderer.last_stats), the renderer resumed at sample 1."""
    import tempfile

    from tpurt_torch.camera import Camera
    from tpurt_torch.config import RenderConfig, SphereLight
    from tpurt_torch.renderer import Renderer
    from tpurt_torch.scene.procedural import write_sponza_like_scene

    with tempfile.TemporaryDirectory() as tmp:
        path = write_sponza_like_scene(os.path.join(tmp, "s.gltf"), **SMALL["scene_kw"])
        r = Renderer.from_gltf(path, config=RenderConfig(width=64, height=48),
                               camera=Camera.from_angles(*bench.CAMERA),
                               lights=[SphereLight(*x) for x in bench.LIGHTS], device="cpu")
    r.sample_count = 1
    out = {}
    for s in (1, 2):
        r.step()
        out[s] = (r.last_stats.logical, r.last_stats.physical)
    return out


@pytest.fixture(scope="module")
def small_run():
    """One small run (2 timed samples, whole frames) and its stdout."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        final = bench.run(device="cpu", samples=2, band_rows=48, deadline_s=600, **SMALL)
    return final, buf.getvalue()


def test_final_record_has_bench_py_keys(small_run):
    final, out = small_run
    lines = out.strip().splitlines()
    last = json.loads(lines[-1])
    assert last == final
    assert KEYS <= set(last) and "provisional" not in last and "note" not in last
    assert last["metric"] == "sponza_like_64x48_mrays_per_sec" and last["unit"] == "Mrays/s"
    assert last["vs_baseline"] is None
    assert last["samples_done"] == 2 and last["bands_timed"] == 2
    assert last["value"] > 0 and last["rays_traced_physical"] > 0
    assert last["seconds"] == pytest.approx(sum(last["sample_seconds"]))
    assert last["time_to_1024spp_s"] == pytest.approx(1024 * last["seconds"] / 2)
    assert last["rmse_vs_golden"] is not None and last["rmse_vs_golden"] < 1e-5
    recs = _records(out)
    assert recs[0]["note"].startswith("warmup") and recs[0]["provisional"] is True
    assert all(r.get("provisional") for r in recs[:-1])


def test_ray_counts_are_the_renderers(small_run, sample_counts):
    """The record's rays are the sum of Renderer.last_stats over samples
    1..2 at the same seed (the card smoke holds the bench to the render
    phase this way)."""
    final, _ = small_run
    assert final["rays_logical"] == sample_counts[1][0] + sample_counts[2][0]
    assert final["rays_traced_physical"] == sample_counts[1][1] + sample_counts[2][1]


def test_bands_count_the_same_rays(sample_counts, capsys):
    """24-row bands: two timed units per sample, the rays of the whole
    frame."""
    rec = bench.run(device="cpu", samples=1, band_rows=24, deadline_s=600, **SMALL)
    assert rec["bands_timed"] == 2 and rec["samples_done"] == 1
    assert (rec["rays_logical"], rec["rays_traced_physical"]) == sample_counts[1]
    assert rec["time_to_1024spp_s"] == pytest.approx(1024 * rec["seconds"])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == rec


def test_deadline_shorter_than_a_sample_still_prints_a_final_record(capsys):
    rec = bench.run(device="cpu", samples=3, band_rows=16, deadline_s=1.0, **SMALL)
    last = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert last == rec
    assert "provisional" not in last and last["note"].startswith("partial")
    assert last["samples_done"] == 0 and last["bands_timed"] == 1
    assert last["rmse_vs_golden"] is None and last["vs_baseline"] is None


def test_no_card_exits_nonzero_instead_of_falling_back(monkeypatch, capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    monkeypatch.delenv("BENCH_FORCE_CPU", raising=False)
    assert bench.main([]) != 0
    captured = capsys.readouterr()
    assert captured.out == "" and "DeviceNotFound" in captured.err


def test_watchdog_prints_a_record_at_the_deadline():
    """BENCH_FORCE_CPU=1 with a 2-second deadline: the CPU config cannot
    finish its warmup in time, the watchdog prints the best record so far
    as the last line and the process exits 0. The run imports neither
    JAX, tpurt nor Pillow on the way."""
    code = (
        "import sys, threading, time\n"
        "from tpurt_torch import bench\n"
        "def check():\n"
        "    while 'tpurt_torch.scene.procedural' not in sys.modules:\n"
        "        time.sleep(0.02)\n"
        "    bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'tpurt', 'PIL'))\n"
        "    print('imports', bad, file=sys.stderr, flush=True)\n"
        "threading.Thread(target=check, daemon=True).start()\n"
        "sys.exit(bench.main([]))\n")
    env = dict(os.environ, PYTHONPATH=ROOT, BENCH_FORCE_CPU="1", BENCH_DEADLINE_S="2")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=ROOT, env=env, timeout=120)
    assert res.returncode == 0, res.stderr[-2000:]
    assert "imports []" in res.stderr
    assert "internal deadline 2s hit" in res.stderr
    last = json.loads(res.stdout.strip().splitlines()[-1])
    assert last["metric"] == "sponza_like_320x240_mrays_per_sec_cpu"
    assert "note" in last and "provisional" not in last and last["vs_baseline"] is None


def test_cli_bench_subcommand_runs_the_harness(monkeypatch, capsys):
    from tpurt_torch import cli

    seen = []
    monkeypatch.setattr(bench, "main", lambda argv=None: seen.append(argv) or 0)
    assert cli.main(["--platform", "cpu", "bench"]) == 0
    assert cli.main(["bench"]) == 0
    assert seen == [["--device", "cpu"], ["--device", "cuda"]]
