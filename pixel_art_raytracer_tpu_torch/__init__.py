"""pixel_art_raytracer_tpu_torch — the PyTorch + CUDA port of the renderer.

The batched graybox render path of :mod:`pixel_art_raytracer_tpu` on an
NVIDIA H100: spatial-hash rebin, oblique primary visibility, light
geometry, the 7-phase DDA shadow march and the ambient + Lambert shade.
The two hot stages run as hand-written CUDA kernels (``csrc/``); every
kernel keeps an exact plain PyTorch version beside it, which CPU tensors
take.

The JAX-free host modules of the JAX package (configuration, assets, scene
construction, the NumPy and C++ oracles, image writers) are reused by
import, not copied.  This package imports ``torch`` and never ``jax``.
"""

from pixel_art_raytracer_tpu.config import RenderConfig, DEFAULT_CONFIG
from pixel_art_raytracer_tpu.scene import (Scene, SceneBuilder, Light,
                                           graybox_world, demo_world,
                                           default_light)

from .device import require_cuda

__all__ = [
    "RenderConfig", "DEFAULT_CONFIG",
    "Scene", "SceneBuilder", "Light", "graybox_world", "demo_world",
    "default_light", "require_cuda",
]
