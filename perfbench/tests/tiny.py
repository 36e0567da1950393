"""The benchmark's cells at a size the CPU runs in seconds: the same
files, with smaller scenes, images, checks and profiled windows, on CPU
devices (the kernels' plain versions). A configuration's small scene is
its writer's `tiny_scene_params`, from the configuration's own file,
laid over its `scene_params`."""

from __future__ import annotations

import copy
import os

from perfbench import harness


def spec(name: str, cache_dir: str) -> dict:
    s = copy.deepcopy(harness.cell_spec(name))
    cfg = s["config"]
    if "tiny_scene_params" not in cfg:
        path = os.path.join(harness.HERE, "configs", s["cell"]["config"] + ".json")
        raise KeyError(f"{path} has no 'tiny_scene_params': the writer parameters that the "
                       f"CPU tests lay over its 'scene_params'")
    cfg["scene_params"] = dict(cfg["scene_params"], **cfg["tiny_scene_params"])
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
