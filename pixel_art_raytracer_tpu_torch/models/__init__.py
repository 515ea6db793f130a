"""Renderers: the deferred single frame, the frame batch, animation and
supersampling."""

from .deferred import DeferredRenderer, DeviceScene
from .supersample import SupersampledRenderer, scale_scene, scaled_config

__all__ = ["DeviceScene", "DeferredRenderer", "SupersampledRenderer",
           "scaled_config", "scale_scene"]
