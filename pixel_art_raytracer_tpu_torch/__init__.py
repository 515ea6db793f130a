"""pixel_art_raytracer_tpu_torch — the PyTorch + CUDA port of the renderer.

The batched graybox render path of :mod:`pixel_art_raytracer_tpu` on an
NVIDIA H100: spatial-hash rebin, oblique primary visibility, light
geometry, the 7-phase DDA shadow march and the ambient + Lambert shade,
with the JAX batched path's lighting modes (additive multi-light,
directional lights, ordered-dither shading) and supersampled rendering
(``SupersampledRenderer``: the world scaled by s, box-filtered down).  The
hot stages run as hand-written CUDA kernels (``csrc/``): trace and shadow
as two kernels, or as one fused kernel for point lights when the
renderer's ``fuse_trace_shadow`` is set.  Every kernel keeps an exact plain PyTorch
version beside it, which CPU tensors take.

The port keeps its own copies of the host modules it needs (``config``,
``assets``, ``scene``) and its own binding of the C++ oracle
(``runtime/native``): it imports ``torch`` and nothing of JAX or of the JAX
package.
"""

from .config import DEFAULT_CONFIG, RenderConfig
from .device import require_cuda
from .models.supersample import SupersampledRenderer
from .scene import (Light, Scene, SceneBuilder, default_light, demo_world,
                    graybox_world)

__all__ = [
    "RenderConfig", "DEFAULT_CONFIG",
    "Scene", "SceneBuilder", "Light", "graybox_world", "demo_world",
    "default_light", "require_cuda", "SupersampledRenderer",
]
