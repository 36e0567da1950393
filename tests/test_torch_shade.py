"""The wave's shading block off the card (kernels/shade.py,
csrc/shade_wave.cu): CPU tensors run the plain PyTorch block and launch
nothing; the constants the kernels take by value are the float32 values
the plain block computes; and the kernels' source, built as plain C++
with g++, follows the plain block lane for lane on whole waves of the
benchmark's scenes at tiny sizes and of the box without lights.

On the card the kernels are held bit for bit against the plain block
(tests/test_torch_shade_card.py). The host build calls glibc's expf,
logf, sinf, cosf and powf, which differ from PyTorch's CPU functions by
an ulp on 1-5% of inputs, so here the RNG states, roulette and miss
counts must agree on every lane and the floats to 1e-4 relative on
every lane but a branch that an ulp flips (at most 0.1% of the lanes,
or two)."""

import ctypes
import dataclasses
import os
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from perfbench import harness
from perfbench.tests import tiny
from tpurt_torch.camera import Camera
from tpurt_torch.config import RenderConfig, SphereLight
from tpurt_torch.integrator import wavefront as W
from tpurt_torch.kernels import bsdf as B
from tpurt_torch.kernels import cudalib, shade
from tpurt_torch.renderer import Renderer
from tpurt_torch.scene.procedural import write_box_scene

SCENES = ("helmet", "sponza", "box")


@pytest.fixture(scope="module")
def host_library(tmp_path_factory):
    """csrc/shade_wave.cu built as plain C++ (g++, no contraction of
    multiply-adds, as nvcc's --fmad=false): its entry points run the lane
    functions in a loop over host memory."""
    so = str(tmp_path_factory.mktemp("shade_host") / "libshade_wave_host.so")
    src = os.path.join(cudalib._CSRC, "shade_wave.cu")
    subprocess.run(["g++", "-x", "c++", "-O2", "-ffp-contract=off", "-std=c++17", "-shared",
                    "-fPIC", "-o", so, src], check=True, capture_output=True, timeout=300)
    lib = ctypes.CDLL(so)
    for name, types in shade._ARGTYPES.items():
        getattr(lib, name).argtypes = types
        getattr(lib, name).restype = ctypes.c_int
    return lib


@pytest.fixture(scope="module")
def cache(tmp_path_factory):
    return str(tmp_path_factory.mktemp("shade"))


def renderer(name, fold, cache, width=32, height=24):
    """A tiny CPU renderer of a benchmark scene (its cell's camera and
    lights) or of the box without lights."""
    if name == "box":
        path = write_box_scene(os.path.join(cache, "box.gltf"))
        return Renderer.from_gltf(path, config=RenderConfig(width=width, height=height,
                                                            seed=2 ** 31 + 9, fold_bsdf_mis=fold),
                                  device="cpu", cache=False)
    cell = {"helmet": "helmet.offline_512", "sponza": "sponza.interactive_640x480"}[name]
    s = tiny.spec(cell, cache)
    config = s["config"]
    gltf, _ = harness.scene_files(config, cache)
    cfg = dataclasses.replace(harness.render_config(s, 2 ** 31 + 9), width=width, height=height,
                              fold_bsdf_mis=fold)
    lights = [SphereLight(tuple(l["position"]), l["radius"], tuple(l["color"]), l["intensity"])
              for l in config["lights"]]
    cam = config["camera"]
    return Renderer.from_gltf(gltf, config=cfg, lights=lights, device="cpu", cache=False,
                              camera=Camera.from_angles(cam["position"], cam["phi"], cam["theta"]))


def test_cpu_tensors_take_the_plain_block(cache, monkeypatch):
    """A CPU render runs shade_nee_plain once a wave and never the kernels'
    path; the launch counters stay 0."""
    calls = {"plain": 0, "card": 0}
    plain, card = W.shade_nee_plain, W.shade_nee_card

    def count(kind, fn):
        def wrapped(*args):
            calls[kind] += 1
            return fn(*args)
        return wrapped

    monkeypatch.setattr(W, "shade_nee_plain", count("plain", plain))
    monkeypatch.setattr(W, "shade_nee_card", count("card", card))
    for k in shade.LAUNCHES:
        shade.LAUNCHES[k] = 0
    r = renderer("box", True, cache)
    r.step()
    assert calls["card"] == 0 and calls["plain"] >= 2
    assert shade.LAUNCHES == {"shade_sample": 0, "shade_mis": 0}


@pytest.mark.parametrize("cfg,nl", [(RenderConfig(), 1), (RenderConfig(), 0),
                                    (RenderConfig(ray_offset=0.0123, rr_threshold=0.9173,
                                                  sky_color=(0.31, 0.07, 1.3), eta_i=1.1,
                                                  eta_t=1.73, emissive_untextured_scale=37.7,
                                                  t_max=12345.678), 5)])
def test_constants_round_as_the_plain_block(cfg, nl):
    """Each packed constant is the float32 the plain block uses: torch's
    rounding of a Python float (the same as np.float32), `_where`'s
    tensor of it, or recip32; one per member of the kernels' struct."""
    c = dict(zip(shade.CONSTANT_NAMES, shade.shade_constants(cfg, nl)))
    src = open(os.path.join(cudalib._CSRC, "shade_wave.cu")).read()
    assert len(c) == len(shade.CONSTANT_NAMES) == int(re.search(r"N_CONSTS = (\d+);", src).group(1))

    def by_torch(x):  # a float32 tensor times a Python float, as the plain block scales
        return (torch.ones(1, dtype=torch.float32) * x).item()

    sky = torch.tensor(cfg.sky_color, dtype=torch.float32).tolist()
    assert [c["sky_r"], c["sky_g"], c["sky_b"]] == sky
    for name, value in (("ray_offset", cfg.ray_offset), ("rr_threshold", cfg.rr_threshold),
                        ("emissive_scale", cfg.emissive_untextured_scale), ("t_max", cfg.t_max),
                        ("nl1", float(nl + 1)), ("pi", B.PI), ("two_pi", 2.0 * B.PI),
                        ("four_pi", 4.0 * B.PI), ("inv_255", 1.0 / 255.0),
                        ("env_pdf2", W._ENV_PDF * W._ENV_PDF)):
        assert c[name] == np.float32(value) == by_torch(value), name
    for name, value in (("eta_i", cfg.eta_i), ("eta_t", cfg.eta_t)):
        assert c[name] == torch.tensor(float(value), dtype=torch.float32).item(), name
    for name, value in (("inv_eta_i", cfg.eta_i), ("inv_eta_t", cfg.eta_t),
                        ("inv_env_pdf", W._ENV_PDF), ("inv_pi", B.PI), ("inv_12_92", 12.92),
                        ("inv_1_055", 1.055)):
        assert c[name] == np.float32(np.float32(1.0) / np.float32(value)), name
    assert c["inv_2_sqrt_pi"] == np.float32(B._INV_2_SQRT_PI)


def close(a, b):
    """Per lane: equal, or (floats) within 1e-4 relative."""
    a, b = a.reshape(a.shape[0], -1), b.reshape(b.shape[0], -1)
    if a.dtype != torch.float32:
        return (a == b).all(dim=1)
    both_nan = torch.isnan(a) & torch.isnan(b)
    return (both_nan | ((a - b).abs() <= 1e-4 * b.abs() + 1e-6)).all(dim=1)


@pytest.mark.skipif(shutil.which("g++") is None, reason="needs g++ for the host build")
@pytest.mark.parametrize("fold", [True, False], ids=["fold", "exact"])
@pytest.mark.parametrize("name", SCENES)
def test_host_build_follows_the_plain_block(cache, host_library, monkeypatch, name, fold):
    """S1 + shadow trace + S2 from the host build against shade_nee_plain
    on every wave of a sample: states, roulette and miss counts on every
    lane, floats within 1e-4 on all but 0.1% of the lanes (or two)."""
    # the kernels' wrappers launch the host build on CPU tensors
    monkeypatch.setattr(shade, "_library", lambda dev: (host_library, None))
    r = renderer(name, fold, cache)
    lanes, off = 0, {}
    plain = W.shade_nee_plain

    def both(*args):
        nonlocal lanes
        p = plain(*args)
        k = W.shade_nee_card(*args)
        lanes += args[-1].numel()
        for field in p._fields:
            a, b = getattr(k, field), getattr(p, field)
            assert a.dtype == b.dtype and a.shape == b.shape, field
            off[field] = off.get(field, 0) + int((~close(a, b)).sum())
        return p

    monkeypatch.setattr(W, "shade_nee", both)
    r.step()
    assert lanes > 100
    for field in ("state", "killed", "miss_inc"):
        assert off[field] == 0, (field, off)
    for field, n in off.items():
        assert n <= max(2, lanes // 1000), (field, n, lanes)
