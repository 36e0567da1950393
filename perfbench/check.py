"""The check that decides `correct`: what the timed window produced, at
pixels and frames drawn from the seed, against the plain reference
(reference/pathtrace.py) run on the same scene arrays, cameras, sample
indices and seed.

- offline cells: the accumulation buffer after the window (every launch
  of the window, and of the profiled window with --trace 1) at
  `check.pixels` pixels. The reference renders every launch of those
  pixels, reduces a sharded launch's samples in shard order as the mesh
  does, and runs the same float32 running average.
- interactive cells: `check.frames` of the window's 8-bit frames, at
  `check.pixels` pixels each, against the reference's one-launch render
  of that frame's camera, tonemapped and converted the same way.

The number compared is `mismatch_share`: the share of checked pixels
where some channel differs by more than the cell's tolerance (relative
`rtol` on `|ref| + floor` for float accumulations; `lsb` steps for 8-bit
frames), NaN counting as different. Its limit is in
checks/<cell>.json."""

from __future__ import annotations

import numpy as np
import torch

from perfbench.reference import pathtrace as P


def _rng(seed: int, stream: int):
    return np.random.default_rng([int(seed) & 0xFFFFFFFFFFFFFFFF, stream])


def collect(spec: dict, r, seed: int, frames, frame_poses, poses) -> dict:
    """Copy to the host what the check reads of the program's output."""
    traffic = spec["traffic"]
    width, height = int(traffic["width"]), int(traffic["height"])
    n_px = int(traffic["check"]["pixels"])
    if traffic["kind"] == "interactive":
        rng = _rng(seed, 1)
        n_f = min(int(traffic["check"]["frames"]), len(frames))
        chosen = np.sort(rng.choice(len(frames), size=n_f, replace=False))
        out = []
        for f in chosen:
            px = np.sort(rng.choice(width * height, size=n_px, replace=False))
            out.append((poses[frame_poses[f]], px, frames[f].reshape(-1, 3)[px].copy()))
        return {"frames": out}
    mesh = traffic.get("mesh") or {"tile": 1, "spp": 1}
    per_launch = int(mesh["spp"]) * r.config.spp_per_launch
    px = np.sort(_rng(seed, 1).choice(width * height, size=n_px, replace=False))
    idx = torch.as_tensor(px, device=r.accum.device)
    vals = r.accum.reshape(-1, 4)[idx, :3].float().cpu().numpy()
    return {"pixels": px, "values": vals, "launches": r.sample_count // per_launch}


def render_settings(spec: dict) -> dict:
    """The cell's RenderConfig fields: the configuration's `render`, with
    the traffic's `render` over it."""
    return {**spec["config"]["render"], **spec["traffic"].get("render", {})}


def settings(spec: dict) -> P.Settings:
    return P.Settings(max_depth=int(render_settings(spec)["max_depth"]))


def reference_values(spec: dict, produced: dict, scene: P.RefScene, seed: int) -> list:
    """What the reference computes in place of each produced value:
    float (P, 3) accumulations, or one (P, 3) uint8 array per frame."""
    config, traffic = spec["config"], spec["traffic"]
    render = render_settings(spec)
    width, height = int(traffic["width"]), int(traffic["height"])
    fov = float(render["fov_degrees"])
    cfg = settings(spec)
    k = int(traffic.get("spp_per_launch", 1))
    dev = scene.v0.device
    if traffic["kind"] == "interactive":
        # every checked frame's rays in one batch: (frame, sample, pixel)
        rays = [P.camera_rays(pose, torch.as_tensor(px, device=dev).repeat(k),
                              torch.repeat_interleave(torch.arange(k, device=dev), len(px)),
                              seed, width, height, fov, scene.v0.dtype)
                for pose, px, _ in produced["frames"]]
        rad = P.radiance(scene, cfg, *(torch.cat(x) for x in zip(*rays)))
        out, i = [], 0
        for _, px, _ in produced["frames"]:
            part = rad[i:i + k * len(px)].reshape(k, len(px), 3)
            i += k * len(px)
            part = part[0] if k == 1 else part.mean(dim=0)
            out.append(P.tonemap_srgb8(P.accumulate(None, part, 1),
                                       float(render["exposure"])))
        return out
    cam = config["camera"]
    cam = (cam["position"], cam["phi"], cam["theta"])
    mesh = traffic.get("mesh") or {"tile": 1, "spp": 1}
    s_n = int(mesh["spp"])
    px = torch.as_tensor(produced["pixels"], device=dev)
    n_px = px.shape[0]
    launches = int(produced["launches"])
    # every (launch, shard, sample-in-launch, pixel), launches in blocks
    acc = None
    block = max(1, (1 << 16) // max(n_px * s_n * k, 1))
    for l0 in range(0, launches, block):
        nl = min(block, launches - l0)
        lsk = torch.arange(nl * s_n * k, device=dev)
        samples = torch.repeat_interleave(l0 * s_n * k + lsk, n_px)
        pix = px.repeat(nl * s_n * k)
        rad = P.launch_radiance(scene, cfg, cam, pix, samples, seed, width, height, fov)
        rad = rad.reshape(nl, s_n, k, n_px, 3)
        for i in range(nl):
            per_shard = [rad[i, s, 0] if k == 1 else rad[i, s].mean(dim=0) for s in range(s_n)]
            img = per_shard[0]
            for s in range(1, s_n):
                img = img + per_shard[s]
            if s_n > 1:
                img = img / s_n
            acc = P.accumulate(acc, img, l0 + i + 1)
    return [acc.float().cpu().numpy()]


def mismatch_share(spec: dict, produced: dict, reference: list) -> float:
    tol = spec["check"]["tolerance"]
    if spec["traffic"]["kind"] == "interactive":
        got = np.concatenate([f[2] for f in produced["frames"]]).astype(np.int32)
        ref = np.concatenate(reference).astype(np.int32)
        bad = (np.abs(got - ref) > int(tol["lsb"])).any(axis=1)
    else:
        got = produced["values"].astype(np.float64)
        ref = reference[0].astype(np.float64)
        limit = float(tol["rtol"]) * (np.abs(ref) + float(tol["floor"]))
        with np.errstate(invalid="ignore"):
            bad = ~(np.abs(got - ref) <= limit).all(axis=1)
    return float(bad.mean()) if bad.size else 1.0


def compare(spec: dict, produced: dict, arrays, seed: int, device):
    """({name: {"value", "limit"}} of every number compared, the
    reference's values)."""
    scene = P.make_scene(arrays, _lights(spec["config"]), device)
    ref = reference_values(spec, produced, scene, seed)
    limit = float(spec["check"]["mismatch_share"]["limit"])
    return ({"mismatch_share": {"value": mismatch_share(spec, produced, ref), "limit": limit}},
            ref)


def control_share(spec: dict, produced: dict, arrays, seed: int, device, reference,
                  dtype=torch.bfloat16) -> float:
    """The control's `mismatch_share`: the reference itself, computed in
    `dtype`, put where the program's values were (the same pixels,
    frames and launches) and compared with the float32 reference."""
    scene = P.make_scene(arrays, _lights(spec["config"]), device, dtype=dtype)
    ref = reference_values(spec, produced, scene, seed)
    if spec["traffic"]["kind"] == "interactive":
        control = {"frames": [(pose, px, vals) for (pose, px, _), vals
                              in zip(produced["frames"], ref)]}
    else:
        control = dict(produced, values=ref[0])
    return mismatch_share(spec, control, reference)


def _lights(config: dict):
    return [(l["position"], l["radius"], l["color"], l["intensity"]) for l in config["lights"]]
