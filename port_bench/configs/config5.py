"""BASELINE config 5's 10k-box scene (the generator of the JAX package's
``tools/bench_scale.py``, tile floor): the player at (500, 36, 80), then
9,999 boxes of 20**3 at x = 37 i mod 1040, z = 53 i mod 300 and y = 20
where i mod 7 = 0, else 0."""

from __future__ import annotations

from port_bench.inputs import scene_arrays


def scene(config: dict) -> dict:
    box = (20, 20, 20)
    boxes = [((500, 36, 80), box)]
    for i in range(config["boxes"] - 1):
        boxes.append((((i * 37) % 1040, 20 if i % 7 == 0 else 0,
                       (i * 53) % 300), box))
    return scene_arrays(boxes, config)
