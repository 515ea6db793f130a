"""The benchmark's plain reference renderer.

Plain PyTorch, written from the reference C++ raytracer's semantics
(Cons-Cat/Pixel-Art-Raytracer ``src/alternative.cpp``): the spatial-hash
rebin, the oblique primary walk, the 7-phase DDA shadow march and the
ambient + L1-Lambert shade, with the box filter of supersampled frames and
the session's Bresenham debug line.  It imports nothing of the measured
program and takes nothing the program made: it bins, traces and shades
every frame again from the scene arrays and the states the benchmark
generated.

Its float arithmetic runs in a dtype it is given: float32, as the
reference states, for the comparison that decides ``correct``, and
bfloat16 for the control that has to fail it.
"""

from .render import (View, box_filter, draw_line, render_frames,
                     scale_scene)

__all__ = ["View", "box_filter", "draw_line", "render_frames",
           "scale_scene"]
