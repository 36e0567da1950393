"""Each cell at a tiny size on the CPU, through the plain kernels: the
result record has the contract's shape, and the check passes. The card
run of run.py is marked `cuda` and skips without a card."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import time

import pytest
import torch

from perfbench import harness
from perfbench.tests import tiny

BENCH = harness.load_json(harness.ROOT, "BENCHMARK.json")
CELLS = [w["name"] for w in BENCH["workloads"]]
RUN = os.path.join(harness.HERE, "run.py")


@pytest.fixture(scope="module")
def cache(tmp_path_factory):
    return str(tmp_path_factory.mktemp("pbcache"))


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("name", CELLS)
def test_cell_record(name, trace, cache):
    s = tiny.spec(name, cache)
    out = harness.run_cell(s, 2 ** 31 + 7, 0.01, bool(trace), time.perf_counter(),
                           devices=tiny.devices(s))
    line = json.loads(json.dumps(out))
    assert list(line)[-1] == "check"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(line)
    assert line["correct"] is True
    assert line["check"]["mismatch_share"]["value"] == 0.0
    assert line["attempted"] >= 1 and line["failed"] == 0
    dev = line["device"]
    assert dev["count"] == int(s["cell"]["chips"]) and "memory_peak_bytes" in dev
    if trace:
        assert dev["window_s"] > 0 and "busy_s" in dev
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
        assert all(len(x) <= 10 for x in line["breakdown"].values())
        names = {m["name"] for m in s["per_layer"]}
        assert set(line["metrics"]) <= names
        # without a card only the host readers find something to read
        assert not any(k.startswith(("device_", "traversal_")) for k in line["metrics"])
    else:
        assert set(line["metrics"]) == {m["name"] for m in s["end_to_end"]}
        for m in s["end_to_end"]:
            assert line["metrics"][m["name"]]["unit"] == m["unit"]
            assert line["metrics"][m["name"]]["value"] > 0


def test_every_cell_reports_what_the_contract_asks():
    for name in CELLS:
        s = harness.cell_spec(name)
        e2e = {m["name"] for m in s["end_to_end"]}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert s["per_layer"]
        for m in s["per_layer"]:
            assert os.path.isfile(os.path.join(harness.HERE, "metrics", m["name"] + ".py"))
            assert m["moves"] in e2e


def test_no_card_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    res = subprocess.run([sys.executable, RUN, "--workload", CELLS[0], "--seed", "1",
                          "--seconds", "1", "--trace", "0"], capture_output=True, text=True,
                         env=env, cwd=harness.ROOT, timeout=120)
    assert res.returncode != 0 and res.stdout == ""


def test_benchmark_files_alone_give_no_result(tmp_path):
    shutil.copy(os.path.join(harness.ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(harness.HERE, tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("_cache", "__pycache__"))
    res = subprocess.run([sys.executable, "perfbench/run.py", "--workload", CELLS[0],
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, cwd=tmp_path, timeout=120)
    assert res.returncode != 0 and res.stdout == ""


@pytest.mark.cuda
def test_run_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    res = subprocess.run([sys.executable, RUN, "--workload", CELLS[0], "--seed", "3",
                          "--seconds", "2", "--trace", "0"], capture_output=True, text=True,
                         cwd=harness.ROOT, timeout=600)
    assert res.returncode == 0, res.stderr[-2000:]
    line = json.loads(res.stdout.strip().splitlines()[-1])
    assert line["correct"] is True and line["device"]["platform"] == "gpu"
