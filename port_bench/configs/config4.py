"""BASELINE config 4's scene, config 3's overlap scene at its size
(``tests/test_configs.py::overlap_scene`` at 512x512x320, tile floor): the
player at (view_width // 2, 36, view_length // 4), then ``boxes - 1``
boxes of 20**3 drawn from ``numpy.random.default_rng(3)``, x in [0,
view_width - 4), y in [0, 60), z in [0, view_length - 4), one draw of
each in that order a box."""

from __future__ import annotations

import numpy as np

from port_bench.inputs import scene_arrays


def scene(config: dict) -> dict:
    vw, vl = config["view_width"], config["view_length"]
    box = (20, 20, 20)
    rng = np.random.default_rng(3)
    boxes = [((vw // 2, 36, vl // 4), box)]
    for _ in range(config["boxes"] - 1):
        x = int(rng.integers(0, vw - 4))
        y = int(rng.integers(0, 60))
        z = int(rng.integers(0, vl - 4))
        boxes.append(((x, y, z), box))
    return scene_arrays(boxes, config)
