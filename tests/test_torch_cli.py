"""The port's CLI (tpurt_torch/cli.py) with `--platform cpu`, the
counterpart of tests/test_cli.py, held against tpurt's CLI: the parse
helpers, `info` line for line, `render` of the box within RMSE 1e-5 of
tpurt's accumulation, checkpoint and resume, camera paths; `view`
serving the renderer it builds; `render --shard` giving ShardedRenderer's
image; `--platform cuda` without a card refused with DeviceNotFound
before anything renders."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import tpurt_torch.cli as cli
from tpurt_torch import film
from tpurt_torch.scene.procedural import write_box_scene, write_sponza_like_scene

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BOX_FLAGS = ["--res", "32x24", "--camera", "1.5,1.2,2.0:-2.5:-0.45",
             "--light", "2,2,2:0.3:1,0.9,0.8:50"]


@pytest.fixture(scope="module")
def box(tmp_path_factory):
    return write_box_scene(str(tmp_path_factory.mktemp("box") / "b.gltf"))


def _render(box, tmp_path, *flags, name="out.png"):
    out = str(tmp_path / name)
    rc = cli.main(["--platform", "cpu", "render", box, *BOX_FLAGS, "-o", out, *flags])
    return rc, out


@pytest.mark.parametrize("kind,text", [("res", "1920x1080"), ("res", "64X48"),
                                       ("camera", "1,2,3:0.5:-0.2"),
                                       ("camera", "0,-4,0:0.7:-0.1"),
                                       ("light", "1,2,3:0.5:0.9,0.8,0.7:100"),
                                       ("light", "-8,-5,-2:0.1:0.8,0.6,0.6:500")])
def test_parse_helpers_match_tpurt(kind, text):
    import tpurt.cli as jcli

    mine, theirs = getattr(cli, f"_parse_{kind}")(text), getattr(jcli, f"_parse_{kind}")(text)
    if kind == "light":
        import dataclasses

        assert dataclasses.astuple(mine) == dataclasses.astuple(theirs)
    else:
        assert mine == theirs


def test_parser_has_tpurts_render_flags():
    import tpurt.cli as jcli

    def flags(parser):
        sub = next(a for a in parser._actions if a.dest == "command")
        r = sub.choices["render"]
        return {a.dest: a.default for a in r._actions if a.dest != "help"}

    mine, theirs = flags(cli.build_parser()), flags(jcli.build_parser())
    assert mine == theirs
    top = {a.dest: a.default for a in cli.build_parser()._actions}
    assert top["platform"] == "cuda"


@pytest.mark.parametrize("scene", ["box", "sponza"])
def test_info_matches_tpurt(box, tmp_path, capsys, scene):
    import tpurt.cli as jcli

    path = box if scene == "box" else write_sponza_like_scene(
        str(tmp_path / "s.gltf"), columns=1, foliage=4, stacks=1, segments=8, rings=6)
    assert jcli.main(["info", path]) == 0
    theirs = capsys.readouterr().out.splitlines()
    assert cli.main(["info", path]) == 0
    mine = capsys.readouterr().out.splitlines()
    assert mine == theirs and len(mine) == 10


def test_render_matches_tpurts_cli(box, tmp_path):
    """Both CLIs render the box at 32x24, 2 spp, with --save-accum; the
    accumulations agree within RMSE 1e-5."""
    import tpurt.cli as jcli

    rc, out = _render(box, tmp_path, "--spp", "2", "--save-accum", str(tmp_path / "acc.npz"))
    assert rc == 0 and os.path.exists(out)
    jout = str(tmp_path / "j.png")
    assert jcli.main(["render", box, *BOX_FLAGS, "-o", jout, "--spp", "2",
                      "--save-accum", str(tmp_path / "jacc.npz")]) == 0
    mine, theirs = np.load(tmp_path / "acc.npz"), np.load(tmp_path / "jacc.npz")
    assert int(mine["sample_count"]) == int(theirs["sample_count"]) == 2
    assert mine["accum"].shape == (24, 32, 4) and mine["accum"].dtype == np.float32
    err = film.rmse(mine["accum"], theirs["accum"])
    assert err < 1e-5, f"RMSE {err} against tpurt's CLI"


def test_checkpoint_every_then_resume(box, tmp_path):
    """--checkpoint-every saves as it goes; a second run resumes from the
    file and continues to the new --spp; the result is bit-equal to an
    uninterrupted render."""
    ck = str(tmp_path / "ck.npz")
    rc, _ = _render(box, tmp_path, "--spp", "2", "--checkpoint", ck, "--checkpoint-every", "1")
    assert rc == 0 and int(np.load(ck)["sample_count"]) == 2
    rc, _ = _render(box, tmp_path, "--spp", "3", "--checkpoint", ck,
                    "--save-accum", str(tmp_path / "resumed.npz"))
    assert rc == 0 and int(np.load(ck)["sample_count"]) == 3
    rc, _ = _render(box, tmp_path, "--spp", "3", "--save-accum", str(tmp_path / "whole.npz"),
                    name="whole.png")
    assert rc == 0
    resumed, whole = np.load(tmp_path / "resumed.npz"), np.load(tmp_path / "whole.npz")
    assert int(resumed["sample_count"]) == 3
    assert resumed["accum"].tobytes() == whole["accum"].tobytes()


@pytest.mark.parametrize("flag,value,frames", [("--orbit", "0,0,0:4:1:2", 2),
                                               ("--fly", "4,0,0;0,0,4:0,0,0:2", 2),
                                               ("--fly", "4,0,0;0,0,4;-4,1,0:0,0,0:2", 4)])
def test_camera_path_frames(box, tmp_path, flag, value, frames):
    outdir = tmp_path / "frames"
    rc = cli.main(["--platform", "cpu", "render", box, "--res", "16x12", "--spp", "1",
                   "-o", str(outdir), flag, value])
    assert rc == 0
    assert sorted(os.listdir(outdir)) == [f"frame_{i:04d}.png" for i in range(frames)]


def test_validate_and_debug_nans(box, tmp_path, capsys):
    rc, out = _render(box, tmp_path, "--spp", "1", "--validate", "--debug-nans")
    assert rc == 0 and os.path.exists(out)
    text = capsys.readouterr().out
    assert "scene validation: ok" in text and "no non-finite pixels" in text


def test_validate_refuses_a_bad_scene(box, tmp_path, capsys):
    rc, out = _render(box, tmp_path, "--spp", "1", "--validate",
                      "--light", "1,1,1:0:1,1,1:10")
    assert rc == 2 and not os.path.exists(out)
    assert "VALIDATION: non-positive light radius" in capsys.readouterr().err


def test_trace_flag_writes_a_trace(box, tmp_path):
    rc, _ = _render(box, tmp_path, "--res", "8x8", "--spp", "1", "--trace",
                    str(tmp_path / "trace"))
    assert rc == 0
    assert [f for f in os.listdir(tmp_path / "trace") if f.endswith(".json")]


def test_view_serves_the_renderer_it_builds(box, monkeypatch):
    from tpurt_torch import viewer

    seen = []

    def serve(renderer, host="127.0.0.1", port=8000, block=True):
        seen.append((renderer, host, port, block))

    monkeypatch.setattr(viewer, "serve", serve)
    rc = cli.main(["--platform", "cpu", "view", box, "--res", "40x30", "--spp", "16",
                   "--port", "0", "--host", "0.0.0.0", "--camera", "1.5,1.2,2.0:-2.5:-0.45",
                   "--light", "2,2,2:0.3:1,0.9,0.8:50"])
    assert rc == 0 and len(seen) == 1
    r, host, port, block = seen[0]
    assert (host, port, block) == ("0.0.0.0", 0, True)
    assert (r.config.width, r.config.height, r.config.max_samples) == (40, 30, 16)
    assert r.device == torch.device("cpu") and r.device_scene.num_lights == 1
    np.testing.assert_allclose(r.camera.position.numpy(), [1.5, 1.2, 2.0])


def test_shard_renders_sharded_renderers_image(box, tmp_path):
    from tpurt_torch.camera import Camera
    from tpurt_torch.config import RenderConfig, SphereLight
    from tpurt_torch.parallel import ShardedRenderer, make_mesh
    from tpurt_torch.renderer import Renderer

    acc = str(tmp_path / "acc.npz")
    rc, out = _render(box, tmp_path, "--spp", "4", "--shard", "2x4", "--save-accum", acc)
    assert rc == 0 and os.path.exists(out)
    got = np.load(acc)
    r = Renderer.from_gltf(box, config=RenderConfig(width=32, height=24, max_samples=4),
                           camera=Camera.from_angles([1.5, 1.2, 2.0], -2.5, -0.45),
                           lights=[SphereLight((2, 2, 2), 0.3, (1, 0.9, 0.8), 50)],
                           device="cpu")
    ShardedRenderer(r, make_mesh(n_tile=2, n_spp=4, devices=["cpu"] * 8)).render(4)
    assert int(got["sample_count"]) == r.sample_count == 4
    np.testing.assert_array_equal(got["accum"], r.image())


def test_shard_1x1_is_the_unsharded_render(box, tmp_path):
    a, b = str(tmp_path / "a.npz"), str(tmp_path / "b.npz")
    assert _render(box, tmp_path, "--spp", "2", "--shard", "1x1", "--save-accum", a)[0] == 0
    assert _render(box, tmp_path, "--spp", "2", "--save-accum", b)[0] == 0
    np.testing.assert_array_equal(np.load(a)["accum"], np.load(b)["accum"])


def test_shard_on_cuda_without_a_card_is_refused(box, tmp_path, capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = str(tmp_path / "never.png")
    rc = cli.main(["render", box, *BOX_FLAGS, "--spp", "1", "--shard", "2x4", "-o", out])
    assert rc != 0 and not os.path.exists(out)
    assert "DeviceNotFound" in capsys.readouterr().err


def test_cuda_without_a_card_is_refused(box, tmp_path, capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = str(tmp_path / "never.png")
    rc = cli.main(["render", box, *BOX_FLAGS, "--spp", "1", "-o", out])
    assert rc != 0 and not os.path.exists(out)
    captured = capsys.readouterr()
    assert "DeviceNotFound" in captured.err and "loading" not in captured.out


def test_module_runs_without_jax_or_pillow(box, tmp_path):
    """`python -m tpurt_torch.cli` renders and imports neither JAX, tpurt
    nor Pillow."""
    code = (
        "import runpy, sys\n"
        f"sys.argv = ['tpurt_torch.cli', '--platform', 'cpu', 'render', {box!r}, "
        f"'--res', '8x8', '--spp', '1', '-o', {str(tmp_path / 'm.png')!r}]\n"
        "try:\n"
        "    runpy.run_module('tpurt_torch.cli', run_name='__main__')\n"
        "except SystemExit as e:\n"
        "    assert e.code == 0, e.code\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'tpurt', 'PIL'))\n"
        "assert not bad, bad\n"
        "print('clean')\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=ROOT, env=dict(os.environ, PYTHONPATH=ROOT), timeout=120)
    assert res.returncode == 0, res.stderr[-2000:]
    assert res.stdout.strip().endswith("clean") and os.path.exists(tmp_path / "m.png")
