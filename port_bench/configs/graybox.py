"""The reference's own world (Cons-Cat/Pixel-Art-Raytracer
src/alternative.cpp:519-599), entity for entity in its insertion order:
the player, the tiled floor with its hole, the left wall stack, the right
wall and the beam row, 162,308 boxes of 20**3."""

from __future__ import annotations

from port_bench.inputs import scene_arrays


def scene(config: dict) -> dict:
    vw, vl = config["view_width"], config["view_length"]
    box = (20, 20, 20)
    boxes = [((vw // 2, 36, vl // 4), box)]                     # 520-523
    for i in range(vw):                                         # 527-547
        for j in range(vl):
            x, z = i * 20, j * 20
            if not (vw // 2 - 40 <= x < vw // 2 + 40
                    and vl // 2 - 40 < z < vl // 2 + 40):
                boxes.append(((x, 0, z), box))
    for i in range(6):                                          # 549-568
        for j in range(vl - 10):
            for k in range(1, 6):
                if not (i >= 4 and k >= 4):
                    boxes.append(((i * 20, k * 20, vl - j * 20), box))
    for i in range(1, 3):                                       # 570-584
        for j in range(vl):
            boxes.append(((vw - i * 20, 20, j * 20), box))
    for i in range(1, 20):                                      # 586-598
        boxes.append(((vw - 40 - i * 20, 20, vl - 60), box))
    return scene_arrays(boxes, config)
