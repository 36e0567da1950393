"""The check rejects what it must: the control (the reference in
bfloat16 in the program's place) and the timed path broken underneath,
once for each fault a cell can have. Tiny sizes on the CPU."""

from __future__ import annotations

import time

import pytest
import torch

from perfbench import harness
from perfbench.tests import tiny

CELLS = [w["name"] for w in harness.load_json(harness.ROOT, "BENCHMARK.json")["workloads"]]


@pytest.fixture(scope="module")
def cache(tmp_path_factory):
    return str(tmp_path_factory.mktemp("pbcache"))


def run(name, cache, **kw):
    s = tiny.spec(name, cache)
    return harness.run_cell(s, 2 ** 31 + 11, 0.01, False, time.perf_counter(),
                            devices=tiny.devices(s), **kw)


@pytest.mark.parametrize("name", CELLS)
def test_control_fails(name, cache):
    out = run(name, cache, control=True)
    assert out["correct"] is True
    assert out["control"]["mismatch_share"] > out["check"]["mismatch_share"]["limit"]


def _wrap_radiance(mp, change):
    from tpurt_torch.integrator import wavefront as W

    orig = W.trace_paths

    def broken(*a, **k):
        rad, stats = orig(*a, **k)
        return change(rad.clone()), stats

    mp.setattr(W, "trace_paths", broken)


def state_unchanged(mp, spec):
    from tpurt_torch import film

    mp.setattr(film, "accumulate", lambda prev, new, count: prev)


def half_batch(mp, spec):
    def change(rad):
        n = rad.shape[0] // 2
        rad[n:] = rad[:n].mean(dim=0)
        return rad

    _wrap_radiance(mp, change)


def answer_altered(mp, spec):
    _wrap_radiance(mp, lambda rad: rad * 1.05)


def exchange_left_out(mp, spec):
    from tpurt_torch.parallel import shard as S

    orig = S.render_rows_stats
    n_spp = int(spec["traffic"]["mesh"]["spp"])
    own = {}

    def broken(scene, bvh, camera, sample_index, row, **kw):
        img, st = orig(scene, bvh, camera, sample_index, row, **kw)
        if sample_index % n_spp == 0:
            own["img"] = img
            return img, st
        return own["img"].clone(), st  # the other cards' tiles never arrive

    mp.setattr(S, "render_rows_stats", broken)


def alpha_retrace_dropped(mp, spec):
    """The alpha re-trace and the shadow recheck never run: every hit the
    kernels leave to the texture test stands as opaque."""
    from tpurt_torch.integrator import wavefront as W

    mp.setattr(W, "_alpha_rejected",
               lambda scene, h, mask, pending=None: torch.zeros_like(mask, dtype=torch.bool))


FAULTS = {"state_unchanged": state_unchanged, "half_batch": half_batch,
          "answer_altered": answer_altered, "exchange_left_out": exchange_left_out,
          "alpha_retrace_dropped": alpha_retrace_dropped}


def _applies(cell, fault):
    spec = harness.cell_spec(cell)
    if fault == "exchange_left_out":
        return bool(spec["traffic"].get("mesh"))
    if fault == "alpha_retrace_dropped":
        return spec["config"].get("alpha_mask_materials", 0) > 0
    return True


CASES = [(c, f) for c in CELLS for f in FAULTS if _applies(c, f)]


@pytest.mark.parametrize("name,fault", CASES)
def test_fault_makes_correct_false(name, fault, cache, monkeypatch):
    FAULTS[fault](monkeypatch, harness.cell_spec(name))
    out = run(name, cache)
    assert out["correct"] is False, out["check"]
