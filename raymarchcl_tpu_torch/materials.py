"""Material/lighting presets.

Parity with the reference's four presets (reference: src/thi/ng/raymarchcl/
materials.clj:3-76). Each preset carries up to 4 point lights and exactly 4
materials (albedo float4, Schlick r0 reflectance, smoothness) plus per-preset
AO amplitude and reflection bounce budget.

Material slot meaning (reference: resources/renderer.cl:205-207):
  slot 0 = ground plane, slots 1..3 selected by voxel value banding
  (v < 84 -> 1, v < 168 -> 2, else 3).
"""

from __future__ import annotations

PRESETS = {
    # materials.clj:4-21
    "orange-stripes": {
        "lightColor": [[28, 18, 8, 0], [8, 18, 28, 0]],
        "lightPos": [[-2, 0, -2, 0], [2, 0, 2, 0]],
        "materials": [
            {"albedo": [1.0, 1.0, 1.0, 1.0], "r0": 0.1, "smoothness": 0.9},
            {"albedo": [4.9, 0.9, 0.05, 1.0], "r0": 0.01, "smoothness": 0.5},
            {"albedo": [1.9, 1.9, 1.9, 1.0], "r0": 0.01, "smoothness": 0.4},
            {"albedo": [0.9, 0.9, 0.9, 1.0], "r0": 0.8, "smoothness": 0.1},
        ],
        "numLights": 2,
        "aoAmp": 0.25,
        "reflectIter": 1,
    },
    # materials.clj:23-40
    "metal": {
        "lightColor": [[28, 18, 8, 0], [16, 36, 56, 0]],
        "lightPos": [[0, 2, 0, 0], [3, 0, 3, 0]],
        "materials": [
            {"albedo": [0.01, 0.01, 0.01, 1.0], "r0": 0.1, "smoothness": 0.5},
            {"albedo": [1.9, 1.9, 1.9, 1.0], "r0": 0.1, "smoothness": 0.5},
            {"albedo": [0.25, 0.27, 0.5, 1.0], "r0": 0.7, "smoothness": 0.1},
            {"albedo": [1.0, 1.0, 1.0, 1.0], "r0": 0.2, "smoothness": 0.1},
        ],
        "numLights": 2,
        "aoAmp": 0.25,
        "reflectIter": 3,
    },
    # materials.clj:42-58
    "metal2": {
        "lightColor": [[28, 18, 8, 0], [8, 18, 28, 0]],
        "lightPos": [[-2, 0, -2, 0], [2, 0, 2, 0]],
        "materials": [
            {"albedo": [0.0, 0.0, 0.0, 1.0], "r0": 0.1, "smoothness": 0.9},
            {"albedo": [1.0, 1.01, 1.075, 1.0], "r0": 0.4, "smoothness": 0.7},
            {"albedo": [1.9, 1.9, 1.9, 1.0], "r0": 0.4, "smoothness": 0.5},
            {"albedo": [0.9, 0.9, 0.9, 1.0], "r0": 0.75, "smoothness": 0.2},
        ],
        "numLights": 2,
        "aoAmp": 0.25,
        "reflectIter": 3,
    },
    # materials.clj:60-76
    "ao": {
        "lightColor": [[50, 50, 50, 0]],
        "materials": [
            {"albedo": [1.0, 1.0, 1.0, 1.0], "r0": 0.0, "smoothness": 1.0},
            {"albedo": [1.0, 1.0, 1.0, 1.0], "r0": 0.0, "smoothness": 1.0},
            {"albedo": [1.0, 1.0, 1.0, 1.0], "r0": 0.0, "smoothness": 1.0},
            {"albedo": [1.0, 1.0, 1.0, 1.0], "r0": 0.0, "smoothness": 1.0},
        ],
        "numLights": 1,
        "aoAmp": 0.25,
        "reflectIter": 0,
    },
}

# Clojure-keyword aliases so `mat=":metal"` style arguments also resolve.
for _k in list(PRESETS):
    PRESETS[":" + _k] = PRESETS[_k]


def get_preset(name):
    """Look up a preset by name; unknown names fall back to the `ao` preset
    (reference: core.clj:74 `(get materials/presets mat (materials/presets :ao))`).
    """
    if name is None:
        return PRESETS["ao"]
    key = name if isinstance(name, str) else str(name)
    return PRESETS.get(key, PRESETS["ao"])
