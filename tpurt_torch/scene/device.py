"""Device scene: flat SoA tensors consumed by the integrator and the
traversal kernel (the counterpart of tpurt/scene/device.py). Everything
is built in vectorised numpy on the host, then moved to the device with
one `torch.from_numpy(...).to(device)` per field; the field layout and
every value equal tpurt's.

tpurt's layout notes, which hold here too:

TPU-first layout decisions (vs. the reference's GPU buffer set,
src/Raytracer.cpp:11-126 bindings):

- Triangle attributes are pre-gathered per-triangle at load time: the hot
  shading path does ONE gather by triangle id instead of the reference's
  four-level indirection (instanceCustomIndex -> geometryIndices ->
  GeometryData -> index buffer -> attribute buffers,
  shaders/triangle.rchit:120-150). Random gathers are the expensive
  operation on TPU; this trades ~4x scene memory (tens of MB for Sponza)
  for 4x fewer of them.
- Vertex normals are pre-multiplied by the geometry's normal matrix
  (coordFlip*R, ModelLoader.cpp:550): barycentric interpolation commutes
  with the linear map, so `normalize(M @ interp(n))` == `normalize(interp(M
  @ n))` — bit-equal semantics to triangle.rchit:148 with zero per-hit
  matrix loads.
- Tangents stay raw object-space vectors: the reference never transforms
  them (triangle.rchit:150 normalizes the interpolated attribute directly) —
  a quirk we replicate.
- All textures live in one big RGBA8 atlas with a per-texture region/
  sampler-state table, so texture fetches are gathers into a single array
  (no ragged per-texture arrays, which XLA cannot trace).
- Sphere lights are a small (L, 8) array; they are intersected analytically
  (replacing the procedural-AABB BLAS, AccelerationStructureBuilder.cpp:192-243).
"""

from __future__ import annotations

from typing import NamedTuple, Sequence, Tuple

import numpy as np
import torch

from tpurt_torch import native
from tpurt_torch.config import SphereLight
from tpurt_torch.scene.types import (
    NO_TEXTURE,
    SceneData,
    WRAP_MIRRORED_REPEAT,
    WRAP_REPEAT,
)


class Materials(NamedTuple):
    """SoA mirror of the reference Material SSBO (ModelLoader.hpp:77-94)."""

    albedo_scale: torch.Tensor    # (M, 4)
    roughness: torch.Tensor       # (M,)
    metallic: torch.Tensor        # (M,)
    normal_factor: torch.Tensor   # (M,)
    ior: torch.Tensor             # (M,)
    emissive: torch.Tensor        # (M, 4)
    alpha_cutoff: torch.Tensor    # (M,)
    tex_albedo: torch.Tensor      # (M,) i32, NO_TEXTURE if absent
    tex_mr: torch.Tensor          # (M,) i32
    tex_normal: torch.Tensor      # (M,) i32
    tex_emissive: torch.Tensor    # (M,) i32


class DeviceScene(NamedTuple):
    tri_pos: torch.Tensor      # (T, 3, 3) world-space vertices
    tri_normal: torch.Tensor   # (T, 3, 3) normal-matrix-premultiplied vertex normals
    tri_tangent: torch.Tensor  # (T, 3, 4) raw tangents
    tri_uv: torch.Tensor       # (T, 3, 2)
    tri_mat: torch.Tensor      # (T,) i32 material index
    tri_alpha: torch.Tensor    # (T,) bool, geometry is alpha tested
    # fused any-hit row per triangle (ONE gather in the re-trace hot loop):
    # [tested, cutoff, tex_id, uv0u, uv0v, uv1u, uv1v, uv2u, uv2v,
    #  mask_transparent, mask_opaque] f32 (the two 4x4 cell masks as
    #  f32-exact ints, so the exact alpha test can skip the texture tap
    #  for any hit whose cell is decided)
    tri_alpha_row: torch.Tensor  # (T, 11) f32
    # fused SHADING row per triangle: everything the wave shader reads,
    # as ONE (T, 40) row gather instead of ~12 separate gathers (1-D
    # gathers run on the TPU scalar path at ~8 ns/element). Layout:
    # [0:6]   uv (3 verts x 2)
    # [6:15]  normal-matrix-premultiplied vertex normals (3 x 3)
    # [15:27] raw tangents (3 x 4)
    # [27:30] material albedo_scale rgb      [30] roughness factor
    # [31]    normal_map_factor              [32:35] emissive rgb
    # [35:39] tex ids (albedo, mr, normal, emissive) as f32
    # [39]    pad
    tri_shade_row: torch.Tensor  # (T, 40) f32
    # 16-bit barycentric transparency mask per triangle (4x4 grid over the
    # (u, v) hit coordinates; bit set = the whole cell's alpha is below the
    # cutoff, so the traversal kernel can reject the hit without a texture
    # tap). 0 for non-alpha-tested triangles. Exact-conservative: mixed
    # cells stay 0 and fall through to the XLA re-trace test.
    # Bit 16 marks triangles whose alpha test can actually reject (alpha
    # tested AND a real albedo texture): the occlusion kernel treats hits
    # on unmarked triangles as DEFINITE blockers and early-exits the ray.
    tri_alpha_mask: torch.Tensor  # (T,) i32 (values < 2^17)
    # the dual mask: bit set = the whole cell's alpha is >= the cutoff
    # (fully OPAQUE), so a hit in the cell is a DEFINITE surface — the
    # occlusion kernel early-exits on it even for alpha-tested geometry,
    # and the exact recheck skips its texture tap. 0xFFFF for alpha-
    # tested triangles without a real albedo texture (their alpha is the
    # constant 1.0, unless cutoff > 1 where the transparent mask is
    # 0xFFFF instead).
    tri_alpha_opaque: torch.Tensor  # (T,) i32 (16-bit values)
    materials: Materials
    atlas: torch.Tensor        # (AH, AW, 4) uint8
    # quad atlas: per texel, the 2x2 bilinear footprint [c00 c10 c01 c11]
    # as ONE 16-byte row, so a texture sample is ONE row gather instead of
    # four scalar-path 1-D gathers (measured ~8 ns/elem each on v5e).
    # Neighbors are precomputed in wrapped texel space per (image, wrap)
    # combo — exact for REPEAT and for all NEAREST sampling; MIRRORED/
    # CLAMP bilinear edges can differ from unwrapped-space taps by one
    # texel (documented deviation, kernels/texture.py).
    atlas_quad: torch.Tensor   # (QH, QW, 16) uint8
    # (NT, 10) i32: x, y, w, h, wrap_s, wrap_t, filter, srgb, qx, qy
    tex_table: torch.Tensor
    lights: torch.Tensor       # (L, 8) f32: px, py, pz, radius, r, g, b, intensity

    @property
    def num_triangles(self) -> int:
        return self.tri_pos.shape[0]

    @property
    def num_lights(self) -> int:
        return self.lights.shape[0]


def lights_array(lights: Sequence[SphereLight]) -> np.ndarray:
    """Pack sphere lights like the reference LightData buffer
    (AccelerationStructureBuilder.cpp:245-266: vec4 position=(pos, radius),
    vec4 color=(rgb, intensity))."""
    out = np.zeros((len(lights), 8), np.float32)
    for i, l in enumerate(lights):
        out[i, :3] = l.position
        out[i, 3] = l.radius
        out[i, 4:7] = l.color
        out[i, 7] = l.intensity
    return out


def _pack_atlas(scene: SceneData) -> Tuple[np.ndarray, np.ndarray]:
    """Shelf-pack all images into one RGBA8 atlas.

    Returns (atlas (AH,AW,4) uint8, tex_table (NT,8) int32). Each glTF
    texture gets a table row [x, y, w, h, wrap_s, wrap_t, filter, srgb];
    textures sharing an image share the region.
    """
    if not scene.images:
        atlas = np.zeros((8, 128, 4), np.uint8)
        table = np.zeros((1, 8), np.int32)
        table[0, 2:4] = [1, 1]
        return atlas, table

    # place images: sort by height desc for shelf packing
    order = sorted(range(len(scene.images)), key=lambda i: -scene.images[i].data.shape[0])
    max_w = max(img.data.shape[1] for img in scene.images)
    atlas_w = max(128, 1 << int(np.ceil(np.log2(max_w))))
    # grow width if total area suggests a squarer atlas
    total_area = sum(img.data.shape[0] * img.data.shape[1] for img in scene.images)
    while atlas_w * atlas_w < total_area and atlas_w < 16384:
        atlas_w *= 2

    placements = {}
    x, y, shelf_h = 0, 0, 0
    for i in order:
        h, w = scene.images[i].data.shape[:2]
        if x + w > atlas_w:
            y += shelf_h
            x, shelf_h = 0, 0
        placements[i] = (x, y)
        x += w
        shelf_h = max(shelf_h, h)
    atlas_h = y + shelf_h
    # round up to the f32 sublane multiple so later reshapes tile cleanly
    atlas_h = int(np.ceil(atlas_h / 8.0) * 8)

    atlas = np.zeros((atlas_h, atlas_w, 4), np.uint8)
    for i, (px, py) in placements.items():
        img = scene.images[i].data
        atlas[py : py + img.shape[0], px : px + img.shape[1]] = img

    table = np.zeros((max(len(scene.textures), 1), 8), np.int32)
    for t, tex in enumerate(scene.textures):
        px, py = placements[tex.image_index]
        img = scene.images[tex.image_index]
        h, w = img.data.shape[:2]
        table[t] = [px, py, w, h, tex.wrap_s, tex.wrap_t, tex.filter, int(img.srgb)]
    if not scene.textures:
        table[0, 2:4] = [1, 1]
    return atlas, table


def _pack_atlas_quad(scene: SceneData,
                     table: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Build the quad atlas (see DeviceScene.atlas_quad) and extend
    `table` with (qx, qy) placement columns.

    Each unique (image, wrap_s, wrap_t) combination gets its own region,
    because the precomputed border neighbors depend on the wrap mode;
    textures sharing an image AND wraps share the region."""
    ext = np.zeros((table.shape[0], 10), np.int32)
    ext[:, :8] = table
    if not scene.images:
        return np.zeros((8, 128, 16), np.uint8), ext

    combos = []       # (image_index, wrap_s, wrap_t)
    combo_of_tex = []
    for t, tex in enumerate(scene.textures):
        c = (tex.image_index, tex.wrap_s, tex.wrap_t)
        if c not in combos:
            combos.append(c)
        combo_of_tex.append(combos.index(c))

    order = sorted(range(len(combos)),
                   key=lambda i: -scene.images[combos[i][0]].data.shape[0])
    max_w = max(scene.images[c[0]].data.shape[1] for c in combos)
    quad_w = max(128, 1 << int(np.ceil(np.log2(max_w))))
    total_area = sum(scene.images[c[0]].data.shape[0]
                     * scene.images[c[0]].data.shape[1] for c in combos)
    while quad_w * quad_w < total_area and quad_w < 16384:
        quad_w *= 2

    placements = {}
    x, y, shelf_h = 0, 0, 0
    for i in order:
        h, w = scene.images[combos[i][0]].data.shape[:2]
        if x + w > quad_w:
            y += shelf_h
            x, shelf_h = 0, 0
        placements[i] = (x, y)
        x += w
        shelf_h = max(shelf_h, h)
    quad_h = int(np.ceil((y + shelf_h) / 8.0) * 8)

    quad = np.zeros((quad_h, quad_w, 16), np.uint8)
    for i, (px, py) in placements.items():
        img_i, ws, wt = combos[i]
        img = scene.images[img_i].data
        h, w = img.shape[:2]
        xs1 = _wrap_indices(np.arange(1, w + 1), w, ws)
        ys1 = _wrap_indices(np.arange(1, h + 1), h, wt)
        block = np.concatenate(
            [img, img[:, xs1], img[ys1, :], img[ys1][:, xs1]], axis=-1)
        quad[py : py + h, px : px + w] = block

    for t, ci in enumerate(combo_of_tex):
        ext[t, 8:10] = placements[ci]
    return quad, ext


def _materials_soa(scene: SceneData) -> Materials:
    mats = scene.materials if scene.materials else []
    m = max(len(mats), 1)

    def arr(get, shape, dtype=np.float32, default=0):
        out = np.full((m,) + shape, default, dtype)
        for i, mat in enumerate(mats):
            out[i] = get(mat)
        return out

    return Materials(
        albedo_scale=arr(lambda t: t.albedo_scale, (4,)),
        roughness=arr(lambda t: t.roughness_factor, ()),
        metallic=arr(lambda t: t.metallic_factor, ()),
        normal_factor=arr(lambda t: t.normal_map_factor, ()),
        ior=arr(lambda t: t.ior, (), default=1.5),
        emissive=arr(lambda t: t.emissive_factor, (4,)),
        alpha_cutoff=arr(lambda t: t.alpha_cutoff, ()),
        tex_albedo=arr(lambda t: t.albedo_texture, (), np.int32, NO_TEXTURE),
        tex_mr=arr(lambda t: t.metallic_roughness_texture, (), np.int32, NO_TEXTURE),
        tex_normal=arr(lambda t: t.normal_texture, (), np.int32, NO_TEXTURE),
        tex_emissive=arr(lambda t: t.emissive_texture, (), np.int32, NO_TEXTURE),
    )


def _wrap_indices(arr: np.ndarray, size: int, mode: int) -> np.ndarray:
    if mode == WRAP_REPEAT:
        return np.remainder(arr, size)
    if mode == WRAP_MIRRORED_REPEAT:
        m = np.remainder(arr, 2 * size)
        return np.where(m < size, m, 2 * size - 1 - m)
    return np.clip(arr, 0, size - 1)


def _alpha_cell_masks(tri_alpha, tri_uv, tri_mat, materials: Materials,
                      atlas: np.ndarray, tex_table: np.ndarray,
                      grid: int = 4, texel_cap: int = 1 << 16):
    """Per-triangle barycentric alpha-decision bitmasks (see
    DeviceScene.tri_alpha_mask / tri_alpha_opaque). Returns
    (transparent, opaque): bit set in `transparent` = every sample in the
    cell FAILS the alpha test (hit rejected, no texture tap needed); bit
    set in `opaque` = every sample PASSES (definite surface, no tap).

    Conservative by construction (ADVICE r1): a cell's bit is set only if
    EVERY texel in the texel-space bounding box of the cell's closed UV
    parallelogram is on one side of the cutoff. The closed bbox (f64
    corner evaluation, extrema of an affine map are at corners) is a
    superset of the texels any real-arithmetic hit in the half-open cell
    can NEAREST-sample, so a set bit cannot misclassify a texel. (The
    only theoretical gap is a float32 hit evaluated within ~1e-6 texels
    of a texel boundary rounding across it — sub-noise for a Monte-Carlo
    renderer.) Cells whose bbox exceeds `texel_cap` texels stay 0 in both
    masks (fall through to the exact re-trace test) instead of being
    sampled sparsely.
    """
    t = tri_alpha.shape[0]
    t_masks = np.zeros(t, np.int32)
    o_masks = np.zeros(t, np.int32)
    idxs = np.nonzero(tri_alpha)[0]
    if idxs.size == 0:
        return t_masks, o_masks
    atlas_a = atlas[..., 3].astype(np.float32) / 255.0
    ah, aw = atlas_a.shape
    tex_albedo = np.asarray(materials.tex_albedo)
    cutoffs = np.asarray(materials.alpha_cutoff)
    step = 1.0 / grid
    full = np.int32((1 << (grid * grid)) - 1)

    for ti in idxs:
        tex = int(tex_albedo[tri_mat[ti]])
        cutoff = float(cutoffs[tri_mat[ti]])
        if tex == NO_TEXTURE or tex >= tex_table.shape[0]:
            # no texture: alpha is the constant 1.0, so every cell is
            # decided by the cutoff alone (matches _alpha_rejected's
            # `where(tex == NO_TEXTURE, 1.0, a) < cutoff`)
            if 1.0 < cutoff:
                t_masks[ti] = full
            else:
                o_masks[ti] = full
            continue
        x0, y0, w, h, wrap_s, wrap_t = (int(v) for v in tex_table[tex][:6])
        uv = tri_uv[ti].astype(np.float64)  # (3, 2)
        tmask = 0
        omask = 0
        for ci in range(grid):
            for cj in range(grid):
                # corners of the full cell square in barycentric (u, v);
                # the uv map is affine, so extrema are at corners
                cu = np.array([ci * step, ci * step + step])[:, None]
                cv = np.array([cj * step, cj * step + step])[None, :]
                w0 = 1.0 - cu - cv
                tu = (w0 * uv[0, 0] + cu * uv[1, 0] + cv * uv[2, 0]) * w
                tv = (w0 * uv[0, 1] + cu * uv[1, 1] + cv * uv[2, 1]) * h
                xlo = int(np.floor(tu.min()))
                xhi = int(np.floor(tu.max()))
                ylo = int(np.floor(tv.min()))
                yhi = int(np.floor(tv.max()))
                # spans >= texture size reach every texel on that axis
                # regardless of wrap mode
                if xhi - xlo + 1 >= w:
                    xs = np.arange(w)
                else:
                    xs = _wrap_indices(np.arange(xlo, xhi + 1), w, wrap_s)
                if yhi - ylo + 1 >= h:
                    ys = np.arange(h)
                else:
                    ys = _wrap_indices(np.arange(ylo, yhi + 1), h, wrap_t)
                if xs.size * ys.size > texel_cap:
                    continue  # too large to verify exhaustively: stay 0
                a = atlas_a[np.clip(ys + y0, 0, ah - 1)[:, None],
                            np.clip(xs + x0, 0, aw - 1)[None, :]]
                if (a < cutoff).all():
                    tmask |= 1 << (ci * grid + cj)
                elif (a >= cutoff).all():
                    omask |= 1 << (ci * grid + cj)
        t_masks[ti] = tmask
        o_masks[ti] = omask
    return t_masks, o_masks


def build_device_scene(
    scene: SceneData,
    lights: Sequence[SphereLight] = (),
    pad_multiple: int = 128,
    device="cuda",
) -> DeviceScene:
    """Flatten a loaded SceneData into the DeviceScene SoA pytree.

    Geometry is de-instantiated exactly like the reference (each glTF
    primitive instance contributes its own world-space triangles,
    ModelLoader.cpp:578). The triangle list is padded to `pad_multiple` by
    repeating triangle 0 (harmless duplicates) so downstream kernels see
    lane-aligned shapes.
    """
    pos_chunks, nrm_chunks, tan_chunks, uv_chunks = [], [], [], []
    mat_chunks, alpha_chunks = [], []

    for geom in scene.geometries:
        idx = scene.indices[geom.index_offset : geom.index_offset + geom.index_count]
        idx = idx.reshape(-1, 3).astype(np.int64)
        # world-space triangle pre-gather in the C++ host core
        base_idx = (geom.vertex_offset + idx).astype(np.uint32)
        vw = native.gather_triangles(scene.positions, base_idx, geom.transform)
        pos_chunks.append(vw)

        t = idx.shape[0]
        if geom.has_normals:
            n = scene.normals[geom.normal_offset + idx]
            nw = np.einsum("ij,tkj->tki", geom.normal_transform, n).astype(np.float32)
        else:
            # reference shaders would read garbage normals; we use the
            # geometric normal of the world-space triangle instead
            e1 = vw[:, 1] - vw[:, 0]
            e2 = vw[:, 2] - vw[:, 0]
            fn = np.cross(e1, e2)
            fn /= np.maximum(np.linalg.norm(fn, axis=-1, keepdims=True), 1e-20)
            nw = np.repeat(fn[:, None, :], 3, axis=1).astype(np.float32)
        nrm_chunks.append(nw)

        if geom.has_tangents:
            tan_chunks.append(scene.tangents[geom.tangent_offset + idx].astype(np.float32))
        else:
            tan_chunks.append(np.zeros((t, 3, 4), np.float32))
        if geom.has_uvs:
            uv_chunks.append(scene.uvs[geom.uv_offset + idx].astype(np.float32))
        else:
            uv_chunks.append(np.zeros((t, 3, 2), np.float32))

        mat_chunks.append(np.full(t, geom.material_index, np.int32))
        alpha_chunks.append(np.full(t, geom.is_alpha_tested, bool))

    if pos_chunks:
        tri_pos = np.concatenate(pos_chunks)
        tri_normal = np.concatenate(nrm_chunks)
        tri_tangent = np.concatenate(tan_chunks)
        tri_uv = np.concatenate(uv_chunks)
        tri_mat = np.concatenate(mat_chunks)
        tri_alpha = np.concatenate(alpha_chunks)
    else:
        tri_pos = np.zeros((0, 3, 3), np.float32)
        tri_normal = np.zeros((0, 3, 3), np.float32)
        tri_tangent = np.zeros((0, 3, 4), np.float32)
        tri_uv = np.zeros((0, 3, 2), np.float32)
        tri_mat = np.zeros(0, np.int32)
        tri_alpha = np.zeros(0, bool)

    t = tri_pos.shape[0]
    padded = max(pad_multiple, int(np.ceil(max(t, 1) / pad_multiple) * pad_multiple))
    if t < padded:
        reps = padded - t
        if t > 0:
            pad_idx = np.zeros(reps, np.int64)
            tri_pos = np.concatenate([tri_pos, tri_pos[pad_idx]])
            tri_normal = np.concatenate([tri_normal, tri_normal[pad_idx]])
            tri_tangent = np.concatenate([tri_tangent, tri_tangent[pad_idx]])
            tri_uv = np.concatenate([tri_uv, tri_uv[pad_idx]])
            tri_mat = np.concatenate([tri_mat, tri_mat[pad_idx]])
            tri_alpha = np.concatenate([tri_alpha, tri_alpha[pad_idx]])
        else:
            # empty scene: degenerate zero-area triangles never hit
            tri_pos = np.zeros((padded, 3, 3), np.float32)
            tri_normal = np.zeros((padded, 3, 3), np.float32)
            tri_normal[:, :, 1] = 1.0
            tri_tangent = np.zeros((padded, 3, 4), np.float32)
            tri_uv = np.zeros((padded, 3, 2), np.float32)
            tri_mat = np.zeros(padded, np.int32)
            tri_alpha = np.zeros(padded, bool)

    atlas, tex_table = _pack_atlas(scene)
    atlas_quad, tex_table = _pack_atlas_quad(scene, tex_table)
    materials = _materials_soa(scene)

    # fused alpha-test rows: flag, material cutoff, albedo tex id, 3x uv,
    # transparent/opaque 4x4 cell masks (decided cells skip the tap)
    mats_np = tri_mat.astype(np.int64)
    cutoff_np = np.asarray(materials.alpha_cutoff)[mats_np]
    tex_np = np.asarray(materials.tex_albedo)[mats_np].astype(np.float32)
    tri_mask_t, tri_mask_o = _alpha_cell_masks(tri_alpha, tri_uv, tri_mat,
                                               materials, atlas, tex_table)
    tri_alpha_row = np.concatenate(
        [
            tri_alpha.astype(np.float32)[:, None],
            cutoff_np.astype(np.float32)[:, None],
            tex_np[:, None],
            tri_uv.reshape(tri_uv.shape[0], 6).astype(np.float32),
            tri_mask_t.astype(np.float32)[:, None],
            tri_mask_o.astype(np.float32)[:, None],
        ],
        axis=1,
    )

    t_all = tri_pos.shape[0]
    m_np = tri_mat.astype(np.int64)
    tri_shade_row = np.concatenate(
        [
            tri_uv.reshape(t_all, 6).astype(np.float32),
            tri_normal.reshape(t_all, 9).astype(np.float32),
            tri_tangent.reshape(t_all, 12).astype(np.float32),
            np.asarray(materials.albedo_scale)[m_np, :3].astype(np.float32),
            np.asarray(materials.roughness)[m_np, None].astype(np.float32),
            np.asarray(materials.normal_factor)[m_np, None].astype(np.float32),
            np.asarray(materials.emissive)[m_np, :3].astype(np.float32),
            np.asarray(materials.tex_albedo)[m_np, None].astype(np.float32),
            np.asarray(materials.tex_mr)[m_np, None].astype(np.float32),
            np.asarray(materials.tex_normal)[m_np, None].astype(np.float32),
            np.asarray(materials.tex_emissive)[m_np, None].astype(np.float32),
            np.zeros((t_all, 1), np.float32),
        ],
        axis=1,
    )

    # bit 16: the triangle's alpha test can reject (tested + real texture);
    # hits on triangles WITHOUT this bit are definite occluders in the
    # occlusion kernel (no texture recheck needed)
    tex_valid = (np.asarray(materials.tex_albedo)[mats_np] != NO_TEXTURE)
    tri_alpha_mask = tri_mask_t | ((tri_alpha & tex_valid).astype(np.int32) << 16)

    def dev(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(device)

    return DeviceScene(
        tri_pos=dev(tri_pos),
        tri_normal=dev(tri_normal),
        tri_tangent=dev(tri_tangent),
        tri_uv=dev(tri_uv),
        tri_mat=dev(tri_mat),
        tri_alpha=dev(tri_alpha),
        tri_alpha_row=dev(tri_alpha_row),
        tri_shade_row=dev(tri_shade_row),
        tri_alpha_mask=dev(tri_alpha_mask),
        tri_alpha_opaque=dev(tri_mask_o),
        materials=Materials(*(dev(x) for x in materials)),
        atlas=dev(atlas),
        atlas_quad=dev(atlas_quad),
        tex_table=dev(tex_table),
        lights=dev(lights_array(list(lights))),
    )
