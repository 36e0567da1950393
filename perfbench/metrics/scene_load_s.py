"""Seconds the program spent on the scene at set-up, from
Renderer.timings: the warm start's `cache_load_s`, or the cold build's
parts (glTF load, device scene, SAH build, collapse, table packing and
the cache save)."""

COLD = ("gltf_load_s", "device_scene_s", "sah_s", "collapse_s", "pack_s", "cache_save_s")


def read(ctx):
    t = ctx["timings"]
    if "cache_load_s" in t:
        return t["cache_load_s"]
    parts = [t[k] for k in COLD if k in t]
    return sum(parts) if parts else None
