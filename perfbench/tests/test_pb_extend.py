"""A configuration with a scene writer of its own joins the benchmark by
new files and appended entries alone. In a copy of the benchmark, a
`probe` configuration (its writer, its file with `tiny_scene_params`, a
cell over an existing traffic mix and the cell's check file) runs
correct on the CPU; every file that was there keeps its bytes; the other
configurations' scene files keep their names; and every writer imports
from the benchmark only the shared `gltf_writer`."""

from __future__ import annotations

import ast
import copy
import hashlib
import json
import os
import shutil
import subprocess
import sys

from perfbench import harness

TRAFFIC = "interactive_640x480"
CELL = "probe." + TRAFFIC
WRITER_IMPORTS = {"perfbench.scenes.gltf_writer"}

PROBE_WRITER = '''"""A probe scene: a textured room with a sphere in it and alpha-MASK
cards around the middle, built from gltf_writer's helpers."""

from __future__ import annotations

import numpy as np

from perfbench.scenes.gltf_writer import (GLTFBuilder, box_mesh, quad_mesh, quirk_rotation,
                                         uv_sphere)


def build(segments=16, rings=12, texture_size=32, seed=5) -> GLTFBuilder:
    rng = np.random.RandomState(seed)
    b = GLTFBuilder()
    stone = rng.randint(60, 230, (texture_size, texture_size, 4)).astype(np.uint8)
    stone[..., 3] = 255
    leaf = stone.copy()
    leaf[..., 1] = 200
    yy, xx = np.mgrid[0:texture_size, 0:texture_size]
    leaf[..., 3] = np.where((xx // 4 + yy // 4) % 2 == 0, 255, 0)
    room = b.add_material(roughness=0.8, base_color_texture=b.add_texture(stone))
    cards = b.add_material(roughness=1.0, base_color_texture=b.add_texture(leaf),
                           alpha_mode="MASK", alpha_cutoff=0.5)
    quad = b.add_mesh(*quad_mesh(), material=room)
    b.add_node(mesh=quad, rotation=quirk_rotation(-0.7071068, 0, 0, 0.7071068),
               scale=[20, 20, 1])
    b.add_node(mesh=quad, rotation=quirk_rotation(0.7071068, 0, 0, 0.7071068),
               translation=[0, 8, 0], scale=[20, 20, 1])
    wall = b.add_mesh(*box_mesh(), material=room)
    for t, s in (([0, 4, -10], [20, 8, 0.5]), ([0, 4, 10], [20, 8, 0.5]),
                 ([-10, 4, 0], [0.5, 8, 20]), ([10, 4, 0], [0.5, 8, 20])):
        b.add_node(mesh=wall, translation=t, scale=s)
    b.add_node(mesh=b.add_mesh(*uv_sphere(segments, rings, 1.0), material=room),
               translation=[3, 2, 3])
    card = b.add_mesh(*quad_mesh(), material=cards)
    for k in range(8):
        a = 2 * np.pi * k / 8
        b.add_node(mesh=card, translation=[3 * np.cos(a), 4, 3 * np.sin(a)],
                   rotation=quirk_rotation(0, np.sin(a / 2), 0, np.cos(a / 2)),
                   scale=[2, 2, 1])
    return b
'''

PROBE_CONFIG = {
    "name": "probe",
    "source": "https://github.com/KhronosGroup/glTF-Sample-Models/tree/main/2.0",
    "scene": "probe",
    "scene_params": {"segments": 16, "rings": 12, "texture_size": 32, "seed": 5},
    "tiny_scene_params": {"segments": 8, "rings": 6, "texture_size": 8},
    "alpha_mask_materials": 1,
    "camera": {"position": [0.0, -4.0, 0.0], "phi": 0.7, "theta": -0.1},
    "lights": [{"position": [0.0, -7.0, 0.0], "radius": 0.5, "color": [0.9, 0.9, 0.7],
                "intensity": 1000.0}],
    "render": {"max_depth": 7, "exposure": 3.0, "fov_degrees": 45.0},
    "reduced": [],
}

# Run in the copy: the scene paths of every cell's configuration at full
# and tiny size, and with a cell named, that cell run on the CPU.
DRIVE = '''
import json, sys, time
from perfbench import harness
from perfbench.tests import tiny
cache, cells = sys.argv[1], sys.argv[2].split(",")
out = {"here": harness.HERE, "paths": {}}
for c in cells:
    out["paths"][c] = [harness.scene_paths(harness.cell_spec(c)["config"], cache),
                       harness.scene_paths(tiny.spec(c, cache)["config"], cache)]
if len(sys.argv) > 3:
    s = tiny.spec(sys.argv[3], cache)
    out["run"] = harness.run_cell(s, 2 ** 31 + 13, 0.01, False, time.perf_counter(),
                                  devices=tiny.devices(s))
print(json.dumps(out))
'''


def sha256s(root):
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = hashlib.sha256(fh.read()).hexdigest()
    return out


def only_appended(old, new):
    """`new` is `old` with entries appended to its lists, and nothing else
    changed."""
    if isinstance(old, dict):
        return (isinstance(new, dict) and set(old) == set(new)
                and all(only_appended(old[k], new[k]) for k in old))
    if isinstance(old, list):
        return (isinstance(new, list) and len(new) >= len(old)
                and all(only_appended(a, b) for a, b in zip(old, new)))
    return old == new


def benchmark_imports(path):
    """The modules of the benchmark (`perfbench.*`) that a source imports."""
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            base = (["perfbench", "scenes"][:max(0, 3 - node.level)] if node.level
                    else node.module.split("."))
            if node.level and node.module:
                base += node.module.split(".")
            base = ".".join(base)
            # `from <package> import <module>` imports the module
            names = ([f"{base}.{a.name}" for a in node.names]
                     if base in ("perfbench", "perfbench.scenes") else [base])
        else:
            continue
        yield from (n for n in names if n.split(".")[0] == "perfbench")


def drive(root, cache, cells, run=None):
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(root), harness.ROOT]))
    args = [sys.executable, "-c", DRIVE, cache, ",".join(cells)] + ([run] if run else [])
    res = subprocess.run(args, capture_output=True, text=True, cwd=root, env=env, timeout=300)
    assert res.returncode == 0, res.stderr[-4000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["here"] == os.path.join(str(root), "perfbench")
    return out


def test_a_configuration_with_its_own_writer_joins_by_new_files(tmp_path):
    root = tmp_path / "bench"
    root.mkdir()
    shutil.copy(os.path.join(harness.ROOT, "BENCHMARK.json"), root)
    shutil.copytree(harness.HERE, root / "perfbench",
                    ignore=shutil.ignore_patterns("_cache", "__pycache__"))
    before = sha256s(root)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    old_bench = copy.deepcopy(bench)
    cells = [w["name"] for w in bench["workloads"]]
    cache = str(tmp_path / "cache")
    paths = drive(root, cache, cells)["paths"]

    # the probe: new files, and entries appended to BENCHMARK.json; it
    # reports what the cells over the same traffic report
    pb = root / "perfbench"
    (pb / "scenes" / "probe.py").write_text(PROBE_WRITER)
    (pb / "configs" / "probe.json").write_text(json.dumps(PROBE_CONFIG, indent=2))
    (pb / "checks" / f"{CELL}.json").write_text(
        json.dumps({"tolerance": {"lsb": 1}, "mismatch_share": {"limit": 0.02}}))
    bench["configs"].append({"name": "probe", "source": PROBE_CONFIG["source"],
                             "file": "perfbench/configs/probe.json", "reduced": [],
                             "why": "a writer of its own: textures, alpha-MASK cards"})
    bench["workloads"].append({"name": CELL, "config": "probe", "traffic": TRAFFIC,
                               "chips": 1, "why": "the probe under the interactive traffic"})
    same_traffic = {w["name"] for w in bench["workloads"] if w["traffic"] == TRAFFIC}
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m and same_traffic & set(m["workloads"]):
            m["workloads"].append(CELL)
    (root / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))

    out = drive(root, cache, cells, run=CELL)
    line = out["run"]
    assert line["correct"] is True, line["check"]
    assert line["attempted"] >= 1
    e2e = {m["name"] for m in bench["end_to_end"] if CELL in m.get("workloads", [CELL])}
    assert set(line["metrics"]) == e2e and {"setup_s", "frame_ms_p85"} <= e2e
    assert out["paths"] == paths

    after = sha256s(root)
    assert {k: after[k] for k in before if k != "BENCHMARK.json"} == \
        {k: v for k, v in before.items() if k != "BENCHMARK.json"}
    assert only_appended(old_bench, bench)

    scenes = pb / "scenes"
    for f in sorted(os.listdir(scenes)):
        if f.endswith(".py") and f != "__init__.py":
            allowed = set() if f == "gltf_writer.py" else WRITER_IMPORTS
            assert set(benchmark_imports(scenes / f)) <= allowed, f


def test_writer_imports_are_read_in_every_form(tmp_path):
    src = tmp_path / "w.py"
    src.write_text("import numpy\nimport perfbench.scenes.gltf_writer as g\n"
                   "from perfbench.scenes import gltf_writer, sponza\n"
                   "from . import helmet\nfrom .gltf_writer import GLTFBuilder\n"
                   "from ..harness import CACHE\nfrom perfbench.check import compare\n")
    assert sorted(benchmark_imports(src)) == [
        "perfbench.check", "perfbench.harness", "perfbench.scenes.gltf_writer",
        "perfbench.scenes.gltf_writer", "perfbench.scenes.gltf_writer",
        "perfbench.scenes.helmet", "perfbench.scenes.sponza"]
