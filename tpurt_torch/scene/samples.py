"""Authored canonical sample scenes (the port's copy of
tpurt/scene/samples.py; it writes the same bytes).

`write_khronos_box` reproduces the Khronos glTF-Sample-Models **Box**
asset (2.0/Box/glTF): the exact document structure — two nodes (the first
carrying the sample's column-major matrix, children [1]; the second the
mesh), one mesh with indexed u16 triangles, normals+positions in a single
byteStride-12 bufferView, and the "Red" material (baseColorFactor
[0.8, 0, 0, 1], metallicFactor 0) — with the canonical 24-vertex /
36-index unit cube geometry (corners at ±0.5, per-face normals).

Anchors the image-parity story (BASELINE.json "Box" config): the scene is
fully specified, so the golden render is comparable against any
implementation of the reference. Note the reference itself IGNORES node
matrices (ModelLoader.cpp:506-522 reads only has_translation/rotation/
scale, never has_matrix), so the Box's rotation matrix is a no-op there —
a quirk tpurt's loader replicates (tests/test_khronos_box.py pins it).
"""

from __future__ import annotations

import json
import os

import numpy as np


def _box_geometry():
    """24 vertices / 36 u16 indices of the canonical unit cube: 6 faces x
    4 corners, outward per-face normals, CCW winding seen from outside."""
    faces = [
        # (normal, corner order in the face plane)
        ((0, 0, 1), [(-1, -1, 1), (1, -1, 1), (-1, 1, 1), (1, 1, 1)]),
        ((0, 0, -1), [(1, -1, -1), (-1, -1, -1), (1, 1, -1), (-1, 1, -1)]),
        ((1, 0, 0), [(1, -1, 1), (1, -1, -1), (1, 1, 1), (1, 1, -1)]),
        ((-1, 0, 0), [(-1, -1, -1), (-1, -1, 1), (-1, 1, -1), (-1, 1, 1)]),
        ((0, 1, 0), [(-1, 1, 1), (1, 1, 1), (-1, 1, -1), (1, 1, -1)]),
        ((0, -1, 0), [(-1, -1, -1), (1, -1, -1), (-1, -1, 1), (1, -1, 1)]),
    ]
    positions, normals, indices = [], [], []
    for fi, (n, corners) in enumerate(faces):
        base = 4 * fi
        for c in corners:
            positions.append([0.5 * c[0], 0.5 * c[1], 0.5 * c[2]])
            normals.append(list(n))
        indices += [base, base + 1, base + 2, base + 2, base + 1, base + 3]
    return (np.asarray(positions, np.float32),
            np.asarray(normals, np.float32),
            np.asarray(indices, np.uint16))


def write_khronos_box(path: str) -> str:
    """Write Box.gltf (+ Box0.bin) replicating the Khronos sample's
    document structure. Returns the .gltf path."""
    positions, normals, indices = _box_geometry()
    idx_bytes = indices.tobytes()
    # one vertex bufferView, byteStride 12: normals at 0, positions at 288
    vert_bytes = normals.tobytes() + positions.tobytes()
    bin_data = idx_bytes + vert_bytes
    bin_name = os.path.splitext(os.path.basename(path))[0] + "0.bin"
    doc = {
        "asset": {"generator": "tpurt authored sample", "version": "2.0"},
        "scene": 0,
        "scenes": [{"nodes": [0]}],
        "nodes": [
            {
                "children": [1],
                "matrix": [1.0, 0.0, 0.0, 0.0,
                           0.0, 0.0, -1.0, 0.0,
                           0.0, 1.0, 0.0, 0.0,
                           0.0, 0.0, 0.0, 1.0],
            },
            {"mesh": 0},
        ],
        "meshes": [{
            "name": "Mesh",
            "primitives": [{
                "attributes": {"NORMAL": 1, "POSITION": 2},
                "indices": 0,
                "material": 0,
                "mode": 4,
            }],
        }],
        "materials": [{
            "name": "Red",
            "pbrMetallicRoughness": {
                "baseColorFactor": [0.800000011920929, 0.0, 0.0, 1.0],
                "metallicFactor": 0.0,
            },
        }],
        "buffers": [{"byteLength": len(bin_data), "uri": bin_name}],
        "bufferViews": [
            {"buffer": 0, "byteOffset": 0, "byteLength": len(idx_bytes),
             "target": 34963},
            {"buffer": 0, "byteOffset": len(idx_bytes),
             "byteLength": len(vert_bytes), "byteStride": 12,
             "target": 34962},
        ],
        "accessors": [
            {"bufferView": 0, "byteOffset": 0, "componentType": 5123,
             "count": int(indices.shape[0]), "type": "SCALAR",
             "max": [int(indices.max())], "min": [0]},
            {"bufferView": 1, "byteOffset": 0, "componentType": 5126,
             "count": 24, "type": "VEC3",
             "max": [1.0, 1.0, 1.0], "min": [-1.0, -1.0, -1.0]},
            {"bufferView": 1, "byteOffset": 288, "componentType": 5126,
             "count": 24, "type": "VEC3",
             "max": [0.5, 0.5, 0.5], "min": [-0.5, -0.5, -0.5]},
        ],
    }
    with open(path, "w") as f:
        json.dump(doc, f, indent=2)
    with open(os.path.join(os.path.dirname(os.path.abspath(path)), bin_name),
              "wb") as f:
        f.write(bin_data)
    return path
