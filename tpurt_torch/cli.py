"""Headless render CLI of the port (the counterpart of tpurt/cli.py), with
tpurt's flags and defaults. Runs on the card unless `--platform cpu`.

Usage examples:

  python -m tpurt_torch.cli render scene.gltf --spp 1024 --res 1920x1080 -o out.png
  python -m tpurt_torch.cli render a.gltf b.gltf --camera 0,1,-4:0.5:-0.2 \\
      --light=-8.3,-5.8,-2.3:0.1:0.8,0.6,0.6:500 --checkpoint run.npz
  python -m tpurt_torch.cli render scene.gltf --orbit 0,0,0:5:2:32 --out frames/
  python -m tpurt_torch.cli --platform cpu render scene.gltf --res 64x48 --spp 4
  python -m tpurt_torch.cli --platform cpu render scene.gltf --res 64x48 --shard 2x4
  python -m tpurt_torch.cli view scene.gltf --res 480x360 --port 8000
  python -m tpurt_torch.cli info scene.gltf
  python -m tpurt_torch.cli bench

`render --shard TxS` renders over a T x S (tile x spp) mesh: T * S cards
on cuda, the CPU T * S times with `--platform cpu`.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import sys
import time


def _parse_res(s):
    w, h = s.lower().split("x")
    return int(w), int(h)


def _parse_camera(s):
    """pos_x,pos_y,pos_z:phi:theta (angles in radians)."""
    pos, phi, theta = s.split(":")
    return [float(x) for x in pos.split(",")], float(phi), float(theta)


def _parse_light(s):
    """px,py,pz:radius:r,g,b:intensity."""
    from tpurt_torch.config import SphereLight

    pos, radius, color, intensity = s.split(":")
    return SphereLight(
        tuple(float(x) for x in pos.split(",")),
        float(radius),
        tuple(float(x) for x in color.split(",")),
        float(intensity),
    )


def build_parser():
    p = argparse.ArgumentParser(prog="tpurt_torch", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--platform", default="cuda", choices=["cpu", "cuda"],
                   help="device to render on (default cuda; without a card, "
                        "cuda exits with DeviceNotFound)")
    sub = p.add_subparsers(dest="command", required=True)

    r = sub.add_parser("render", help="render glTF scene(s) to PNG")
    r.add_argument("scenes", nargs="+", help="glTF/GLB files")
    r.add_argument("--res", default="640x480", help="WxH (default 640x480)")
    r.add_argument("--spp", type=int, default=1024, help="samples per pixel (default 1024)")
    r.add_argument("-o", "--out", default="render.png", help="output PNG (or directory for paths)")
    r.add_argument("--camera", type=_parse_camera, default=None,
                   help="pos_x,pos_y,pos_z:phi:theta override (radians)")
    r.add_argument("--light", type=_parse_light, action="append", default=None,
                   help="sphere light px,py,pz:radius:r,g,b:intensity (repeatable; "
                        "--light=... for negative coordinates)")
    r.add_argument("--sponza-lights", action="store_true",
                   help="use the reference's three hard-coded lights")
    r.add_argument("--exposure", type=float, default=3.0)
    r.add_argument("--fov", type=float, default=45.0, help="degrees")
    r.add_argument("--max-depth", type=int, default=7, help="bounce cap")
    r.add_argument("--seed", type=int, default=0)
    r.add_argument("--sky", default="0.4,0.5,0.6", help="sky color")
    r.add_argument("--checkpoint", default=None,
                   help="checkpoint file: resumed if it exists, saved on exit")
    r.add_argument("--checkpoint-every", type=int, default=0,
                   help="save the checkpoint every N samples")
    r.add_argument("--progress-every", type=int, default=64,
                   help="print progress every N samples (0: never)")
    r.add_argument("--orbit", default=None,
                   help="camera path cx,cy,cz:radius:height:frames; renders a frame sequence")
    r.add_argument("--fly", default=None,
                   help="fly-through x,y,z;x,y,z;...:lx,ly,lz:frames_per_leg; renders a "
                        "frame sequence")
    r.add_argument("--shard", default=None,
                   help="TILExSPP device mesh (e.g. 2x4): T*S cards on cuda, the CPU "
                        "T*S times with --platform cpu")
    r.add_argument("--save-accum", default=None,
                   help="also dump the raw accumulation buffer (npz)")
    r.add_argument("--trace", default=None, metavar="DIR",
                   help="write a torch.profiler Chrome trace of the render to DIR "
                        "(utils/profiling.trace)")
    r.add_argument("--debug-nans", action="store_true",
                   help="check every sample for NaN/Inf (utils/debug.with_checks) and "
                        "print a non-finite-pixel report")
    r.add_argument("--validate", action="store_true",
                   help="check DeviceScene invariants before rendering")

    i = sub.add_parser("info", help="print scene statistics")
    i.add_argument("scenes", nargs="+")

    v = sub.add_parser("view", help="interactive progressive viewer (browser)")
    v.add_argument("scenes", nargs="+")
    v.add_argument("--res", default="480x360")
    v.add_argument("--spp", type=int, default=1024)
    v.add_argument("--camera", type=_parse_camera, default=None)
    v.add_argument("--light", type=_parse_light, action="append", default=None)
    v.add_argument("--sponza-lights", action="store_true")
    v.add_argument("--port", type=int, default=8000, help="0: any free port")
    v.add_argument("--host", default="127.0.0.1")

    sub.add_parser("bench", help="run the benchmark harness (tpurt_torch.bench)")
    return p


def cmd_render(args):
    from tpurt_torch.camera import Camera
    from tpurt_torch.config import DEFAULT_SPONZA_LIGHTS, RenderConfig
    from tpurt_torch.renderer import Renderer

    width, height = _parse_res(args.res)
    cfg = RenderConfig(
        width=width,
        height=height,
        max_samples=args.spp,
        exposure=args.exposure,
        fov_degrees=args.fov,
        max_depth=args.max_depth,
        seed=args.seed,
        sky_color=tuple(float(x) for x in args.sky.split(",")),
    )
    lights = list(args.light or [])
    if args.sponza_lights:
        lights.extend(DEFAULT_SPONZA_LIGHTS)

    camera = None
    if args.camera is not None:
        pos, phi, theta = args.camera
        camera = Camera.from_angles(pos, phi, theta)

    print(f"loading {args.scenes} ...")
    t0 = time.perf_counter()
    renderer = Renderer.from_gltf(args.scenes, config=cfg, lights=lights, camera=camera,
                                  device=args.platform)
    print(f"  {renderer.device_scene.num_triangles} triangles, "
          f"{renderer.device_scene.num_lights} lights, "
          f"alpha-tested={renderer.has_alpha}, "
          f"loaded in {time.perf_counter() - t0:.2f}s on {renderer.device}")

    if args.validate:
        from tpurt_torch.utils.debug import validate_scene

        problems = validate_scene(renderer.device_scene)
        if problems:
            for p in problems:
                print(f"  VALIDATION: {p}", file=sys.stderr)
            return 2
        print("  scene validation: ok")

    sharded = None
    if args.shard:
        from tpurt_torch.parallel import ShardedRenderer, make_mesh

        t, s = (int(x) for x in args.shard.lower().split("x"))
        devices = [renderer.device] * (t * s) if renderer.device.type == "cpu" else None
        sharded = ShardedRenderer(renderer, make_mesh(n_tile=t, n_spp=s, devices=devices))
        print(f"  sharding over mesh tile={t} x spp={s}")

    with contextlib.ExitStack() as stack:
        if args.trace:
            from tpurt_torch.utils.profiling import trace

            stack.enter_context(trace(args.trace))
            print(f"  profiler trace -> {args.trace}")
        if args.debug_nans:
            from tpurt_torch.utils.debug import with_checks

            stack.enter_context(with_checks())
        rc = _render_body(args, renderer, sharded)
    if args.debug_nans:
        from tpurt_torch.utils.debug import nan_report

        print(f"  {nan_report(renderer.accum)}")
    return rc


def _render_body(args, renderer, sharded):
    import numpy as np

    from tpurt_torch.camera import fly_path, orbit_path

    target = sharded if sharded is not None else renderer
    if args.orbit or args.fly:
        if args.orbit:
            center_s, radius_s, height_s, frames_s = args.orbit.split(":")
            cams = orbit_path([float(x) for x in center_s.split(",")],
                              float(radius_s), float(height_s), int(frames_s))
        else:
            pts_s, look_s, frames_s = args.fly.split(":")
            waypoints = [[float(x) for x in p.split(",")] for p in pts_s.split(";")]
            cams = fly_path(waypoints, [float(x) for x in look_s.split(",")], int(frames_s))
        os.makedirs(args.out, exist_ok=True)
        for fi, cam in enumerate(cams):
            renderer.set_camera(cam)
            target.render(args.spp)
            frame_path = os.path.join(args.out, f"frame_{fi:04d}.png")
            renderer.save_png(frame_path)
            print(f"  frame {fi + 1}/{len(cams)} -> {frame_path} "
                  f"({renderer.sample_time:.2f}s)")
        return 0

    if args.checkpoint and os.path.exists(args.checkpoint):
        renderer.load_checkpoint(args.checkpoint)
        print(f"  resumed at {renderer.sample_count} spp from {args.checkpoint}")

    start = renderer.sample_count
    if args.checkpoint and args.checkpoint_every:
        while renderer.sample_count < args.spp:
            nxt = min(renderer.sample_count + args.checkpoint_every, args.spp)
            target.render(nxt)
            renderer.save_checkpoint(args.checkpoint)
            print(f"  checkpoint @ {renderer.sample_count} spp -> {args.checkpoint}")
    elif sharded is not None:
        sharded.render(args.spp)
    else:
        renderer.render(args.spp, progress_every=args.progress_every)
    done = renderer.sample_count - start
    print(f"  {renderer.sample_count} spp; {done} rendered in {renderer.sample_time:.2f}s"
          + (f" ({renderer.sample_time / done:.3f} s/sample)" if done else ""))

    renderer.save_png(args.out)
    print(f"wrote {args.out}")
    if args.checkpoint:
        renderer.save_checkpoint(args.checkpoint)
    if args.save_accum:
        np.savez_compressed(args.save_accum, accum=renderer.image(),
                            sample_count=renderer.sample_count)
    return 0


def cmd_info(args):
    from tpurt_torch.scene.gltf import load_gltf

    scene = load_gltf(args.scenes)
    print(f"geometries:  {len(scene.geometries)}")
    print(f"triangles:   {scene.triangle_count}")
    print(f"vertices:    {scene.positions.shape[0]}")
    print(f"materials:   {len(scene.materials)}")
    print(f"textures:    {len(scene.textures)}")
    print(f"images:      {len(scene.images)}")
    print(f"bounds min:  {scene.model_bounds_min}")
    print(f"bounds max:  {scene.model_bounds_max}")
    alpha = sum(g.is_alpha_tested for g in scene.geometries)
    print(f"alpha-tested geometries: {alpha}")
    cam = scene.camera
    print(f"camera: pos={cam.position} dir={cam.direction} fov={cam.fov}")
    return 0


def cmd_view(args):
    from tpurt_torch import viewer
    from tpurt_torch.camera import Camera
    from tpurt_torch.config import DEFAULT_SPONZA_LIGHTS, RenderConfig
    from tpurt_torch.renderer import Renderer

    width, height = _parse_res(args.res)
    cfg = RenderConfig(width=width, height=height, max_samples=args.spp)
    lights = list(args.light or [])
    if args.sponza_lights:
        lights.extend(DEFAULT_SPONZA_LIGHTS)
    camera = None
    if args.camera is not None:
        pos, phi, theta = args.camera
        camera = Camera.from_angles(pos, phi, theta)
    renderer = Renderer.from_gltf(args.scenes, config=cfg, lights=lights, camera=camera,
                                  device=args.platform)
    viewer.serve(renderer, host=args.host, port=args.port)
    return 0


def main(argv=None):
    from tpurt_torch.runtime.device import DeviceNotFound, resolve_device

    args = build_parser().parse_args(argv)
    if args.command == "info":
        return cmd_info(args)
    if args.command == "bench":
        from tpurt_torch import bench

        return bench.main(["--device", args.platform])
    try:
        resolve_device(args.platform)
    except DeviceNotFound as e:
        print(f"tpurt_torch: DeviceNotFound: {e}", file=sys.stderr)
        return 1
    if args.command == "view":
        return cmd_view(args)
    return cmd_render(args)


if __name__ == "__main__":
    sys.exit(main())
