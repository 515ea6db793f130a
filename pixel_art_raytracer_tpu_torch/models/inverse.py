"""Differentiable inverse rendering: fit a light position to target frames.

Counterpart of ``pixel_art_raytracer_tpu/models/inverse.py``, the JAX
package's one training path.  Visibility (the primary trace and the shadow
march) is integer or boolean and carries no gradient: it runs under
``torch.no_grad()`` on the port's kernels, ``csrc/trace.cu`` and the point
mode of ``csrc/shadow.cu`` under the renderer's ``shadow_max_steps`` cap.
Gradients flow through the Lambert shading with respect to a continuous
float32 light position, by autograd; the optimiser is ``torch.optim.Adam``
with optax's defaults (betas (0.9, 0.999), eps 1e-8).

Three gradient rules are JAX's, not torch's defaults, and ``soft_frame``
keeps them:

* ``|x|`` at 0 has gradient 1 (``jnp.abs``), not torch's 0: the light's
  offset from a pixel column is exactly 0 whenever the light has an
  integer x;
* ``maximum`` and ``minimum`` split a tie's gradient 0.5 / 0.5, as
  ``torch.maximum`` / ``torch.minimum`` do and ``clamp`` does not (the dot
  is 0 on every background pixel);
* ``/ 255`` divides by a tensor: PyTorch's CUDA ``tensor / python_scalar``
  multiplies by the reciprocal, which is not the IEEE quotient.
"""

from __future__ import annotations

import torch

from ..config import DEFAULT_CONFIG, RenderConfig
from ..device import resolve
from ..ops import shade, shadow_cuda
from ..ops.cstyle import c_div
from .deferred import DeferredRenderer, DeviceScene

ADAM_BETAS = (0.9, 0.999)
ADAM_EPS = 1e-8


def jax_abs(x: torch.Tensor) -> torch.Tensor:
    """``|x|`` with ``jnp.abs``'s gradient: 1 at 0 (and at -0), where
    ``torch.abs`` gives 0."""
    return torch.where(x >= 0, x, -x)


class InverseLightFitter:
    """Optimise a continuous light position so renders match target
    frames."""

    def __init__(self, config: RenderConfig = DEFAULT_CONFIG,
                 renderer: DeferredRenderer | None = None,
                 learning_rate: float = 2.0, with_shadows: bool = True):
        self.config = config
        self.renderer = renderer or DeferredRenderer(config)
        self.learning_rate = learning_rate
        self.with_shadows = with_shadows

    # -- differentiable forward -------------------------------------------

    def soft_frame(self, dscene: DeviceScene, light_f32: torch.Tensor,
                   rows=None) -> torch.Tensor:
        """Render an (H, W, 3) float32 frame in [0, 1], differentiable in
        ``light_f32`` (3,) float32 through the shading, not through
        visibility.  ``rows=(row0, n_rows)``, whole bin rows, renders that
        window only ((n_rows, W, 3)): a row shard's part of the frame.

        As the JAX package's ``soft_frame``: the G-buffer from
        ``build_bins`` and ``trace``; the towards-light direction from the
        float light with an L1 length plus 1e-6; the lit mask from the
        shadow march of the surface rays (``shade.surface_rays``) toward
        the rounded light's bin, with reciprocal directions ``1 / t`` of
        that float direction, under ``shadow_max_steps``."""
        cfg = self.config
        r = self.renderer
        f32 = torch.float32
        dev = dscene.device
        with torch.no_grad():
            bins_ent, counts = r.build_bins(dscene)
            gbuf = r.trace(dscene, bins_ent, counts, rows)
        tlx, tly, tlz = self.towards_light(gbuf.y, gbuf.z, light_f32)
        n = gbuf.normal
        dot = n[..., 0] * tlx + n[..., 1] * tly + n[..., 2] * tlz
        diffuse = torch.maximum(torch.zeros_like(dot), dot)
        gain = torch.minimum(torch.full_like(dot, 1.0 - cfg.ambient),
                             diffuse)
        if self.with_shadows:
            with torch.no_grad():
                lit = shadow_cuda.trace_light(
                    *self.shadow_inputs(dscene, bins_ent, counts, gbuf,
                                        light_f32, (tlx, tly, tlz)),
                    max_steps=r.shadow_max_steps, rows=rows)[0]
            gain = lit.to(f32) * gain
        brightness = cfg.ambient + gain
        base = (gbuf.color[..., :3].to(f32)
                / torch.tensor(255.0, dtype=f32, device=dev))
        return base * brightness[..., None]

    @staticmethod
    def towards_light(gbuf_y, gbuf_z, light_f32):
        """The L1-normalised direction ``(dx, dy, dz) / (|dx| + |dy| + |dz|
        + 1e-6)`` from each surface point (wx, y, z) of a G-buffer's (h, W)
        ``y`` and ``z`` toward the float light, differentiable in it."""
        f32 = torch.float32
        dev = gbuf_y.device
        h, W = gbuf_y.shape
        wx = torch.arange(W, dtype=torch.int32, device=dev).expand(h, W)
        dx = light_f32[0] - wx.to(f32)
        dy = light_f32[1] - gbuf_y.to(f32)
        dz = light_f32[2] - gbuf_z.to(f32)
        eps = torch.tensor(1e-6, dtype=f32, device=dev)
        length = jax_abs(dx) + jax_abs(dy) + jax_abs(dz) + eps
        return dx / length, dy / length, dz / length

    def shadow_inputs(self, dscene, bins_ent, counts, gbuf, light_f32, tl):
        """The arguments of ``shadow_cuda.trace_light`` for the shadow
        rays of ``soft_frame``, before ``max_steps`` and ``rows``: the
        surface rays of G-buffer ``gbuf`` (fields (h, W)) toward the bin of
        the rounded light, with reciprocal directions ``1 / t`` of the
        towards-light direction ``tl``, batched as one frame."""
        cfg = self.config
        bs = cfg.bin_size
        light_i = torch.round(light_f32.detach()).to(torch.int32)
        rb, origin = shade.surface_rays(gbuf.y[None], gbuf.z[None], cfg)
        lb = tuple(c_div(v, bs).view(1, 1, 1) for v in (
            light_i[0], cfg.view_height - light_i[1] - light_i[2],
            light_i[2]))
        inv = tuple(torch.reciprocal(t.detach())[None] for t in tl)
        return (dscene.pos, dscene.ext, bins_ent[None], counts[None], rb, lb,
                gbuf.entity_index[None], origin, inv, dscene.pos[:1], cfg)

    # -- training ----------------------------------------------------------

    def loss(self, light_f32, dscene, target) -> torch.Tensor:
        """MSE against an (H, W, 3) float32 target frame in [0, 1]."""
        pred = self.soft_frame(dscene, light_f32)
        return torch.mean((pred - target) ** 2)

    def batch_loss(self, light_f32, dscene, targets) -> torch.Tensor:
        """Mean loss over a batch of target frames (F, H, W, 3): the mean
        of the frames' MSEs, as the JAX package's ``vmap``.  The frame
        does not depend on the target, so it is rendered once."""
        pred = self.soft_frame(dscene, light_f32)
        losses = torch.mean((pred[None] - targets) ** 2, dim=(1, 2, 3))
        return torch.mean(losses)

    def init(self, light0, device=None):
        """``(light, optimizer)``: ``light0`` as a float32 (3,) leaf
        tensor that requires grad, on ``device`` (default: the tensor's
        own device, else the card), and its Adam optimiser."""
        if device is None and isinstance(light0, torch.Tensor):
            device = light0.device
        light = torch.as_tensor(light0, dtype=torch.float32).detach().to(
            resolve(device), copy=True).requires_grad_()
        optimizer = torch.optim.Adam([light], lr=self.learning_rate,
                                     betas=ADAM_BETAS, eps=ADAM_EPS)
        return light, optimizer

    def train_step_impl(self, light, opt_state, dscene, targets):
        """One optimisation step on a batch of targets; returns
        ``(light, opt_state, loss)``.  ``light`` is updated in place (the
        optimiser holds it); the loss is detached."""
        opt_state.zero_grad(set_to_none=True)
        loss = self.batch_loss(light, dscene, targets)
        loss.backward()
        opt_state.step()
        return light, opt_state, loss.detach()

    def train_step(self, light, opt_state, dscene, targets):
        """:meth:`train_step_impl`, eager (the JAX package jits it)."""
        return self.train_step_impl(light, opt_state, dscene, targets)

    def fit(self, dscene, targets, light0, steps: int = 50):
        """``steps`` Adam steps from ``light0``: ``(light, history)``, the
        fitted (3,) light and each step's loss."""
        light, opt_state = self.init(light0, device=dscene.device)
        history = []
        for _ in range(steps):
            light, opt_state, loss = self.train_step(light, opt_state,
                                                     dscene, targets)
            history.append(float(loss))
        return light.detach(), history
