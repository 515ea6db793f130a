"""2D overlays: the reference's Bresenham debug line.

Counterpart of ``pixel_art_raytracer_tpu/ops/overlay.py`` (the device
rasteriser) and of ``pixel_art_raytracer_tpu/oracle/cpu_renderer.draw_line``
(the host one the session and the viewer use).  The reference draws a red
line from the hovered pixel to the light with a callback-based Bresenham
(``draw_line``, alternative.cpp:139-175), bounds-checked at the call site
(762-772).  Both rasterisers walk the same serial error-accumulator steps
from the integer endpoints, with the same double step when both
conditions fire; they differ where the JAX pair differs:

* :func:`draw_line` (tensor image, returns a new image) stops after
  ``H + W + 1`` steps, as the JAX device version's bounded loop does, so a
  line to a far off-screen endpoint (a light high above the view) is cut;
* :func:`draw_line_host` (numpy image, written in place) walks to the end.
"""

from __future__ import annotations

import numpy as np
import torch


def line_pixels(x0: int, y0: int, x1: int, y1: int,
                max_steps: int | None = None):
    """Yield the (x, y) points of the serial Bresenham walk from (x0, y0)
    to (x1, y1) (alternative.cpp:139-175), one a step, stopping after
    ``max_steps`` steps when given; bounds are not checked."""
    x0, y0, x1, y1 = int(x0), int(y0), int(x1), int(y1)
    x_delta = abs(x1 - x0)
    y_delta = -abs(y1 - y0)
    x_sign = 1 if x0 < x1 else -1
    y_sign = 1 if y0 < y1 else -1
    error = x_delta + y_delta
    x, y = x0, y0
    steps = 0
    while max_steps is None or steps < max_steps:
        steps += 1
        yield x, y
        if x == x1 and y == y1:
            return
        error2 = 2 * error
        if error2 >= y_delta:
            if x == x1:
                return
            error += y_delta
            x += x_sign
        if error2 <= x_delta:
            if y == y1:
                return
            error += x_delta
            y += y_sign


def draw_line(image: torch.Tensor, x0, y0, x1, y1, color) -> torch.Tensor:
    """Draw a line segment onto an (H, W, C) image; returns the new image
    (the caller's is not written).

    The pixel set is walked on the host from the integer endpoints, at
    most ``H + W + 1`` steps (the JAX device version's bound); the
    in-bounds pixels are written with one ``index_put_`` on the image's
    device.  Out-of-bounds pixels are dropped, matching the reference call
    site's bounds check.
    """
    H, W = image.shape[:2]
    points = [(x, y) for x, y in line_pixels(x0, y0, x1, y1, H + W + 1)
              if 0 <= x < W and 0 <= y < H]
    out = image.clone()
    if points:
        xy = torch.tensor(points, dtype=torch.long).to(image.device)
        value = torch.as_tensor(color, dtype=image.dtype).to(image.device)
        out.index_put_((xy[:, 1], xy[:, 0]), value)
    return out


def draw_line_host(image: np.ndarray, x0: int, y0: int, x1: int, y1: int,
                   color) -> None:
    """Bresenham line with bounds-checked plotting (alternative.cpp:139-175,
    callback at 762-772), walked to its end.  Mutates ``image`` (H, W, C)
    in place."""
    H, W = image.shape[:2]
    for x, y in line_pixels(x0, y0, x1, y1):
        if 0 <= x < W and 0 <= y < H:
            image[y, x] = color
