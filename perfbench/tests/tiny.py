"""The benchmark's cells at a size the CPU runs in seconds: the same
files, with smaller scenes, images, checks and profiled windows, on CPU
devices (the kernels' plain versions)."""

from __future__ import annotations

import copy

from perfbench import harness

SCENES = {"sponza": dict(columns=3, stacks=2, segments=8, rings=6, drapes=2, drape=(4, 3),
                         leaf=1.5, plant_blades=4, texture_size=16, triangles=0),
          "helmet": dict(segments=24, rings=18, texture_size=64, triangles=0)}


def spec(name: str, cache_dir: str) -> dict:
    s = copy.deepcopy(harness.cell_spec(name))
    cfg = s["config"]
    cfg["scene_params"] = dict(cfg["scene_params"], **SCENES[cfg["scene"]])
    t = s["traffic"]
    t["width"], t["height"] = 64, 48
    t["check"] = dict(t["check"], pixels=48)
    if "frames" in t["check"]:
        t["check"]["frames"] = 3
    t["profile_launches"] = t["profile_frames"] = 1
    s["cache_dir"] = cache_dir
    return s


def devices(s: dict):
    return ["cpu"] * int(s["cell"]["chips"])
