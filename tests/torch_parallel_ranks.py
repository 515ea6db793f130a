"""Rank bodies for tests/test_torch_parallel.py, run by
``pixel_art_raytracer_tpu_torch.parallel.launch.run_ranks`` in processes
started with ``spawn``: this module imports the port and torch only, so a
rank starts without JAX."""

from __future__ import annotations

from pixel_art_raytracer_tpu_torch.models.animation import AnimationRenderer
from pixel_art_raytracer_tpu_torch.models.deferred import (DeferredRenderer,
                                                           DeviceScene)
from pixel_art_raytracer_tpu_torch.models.inverse import InverseLightFitter
from pixel_art_raytracer_tpu_torch.ops.static_bins import StaticBins
from pixel_art_raytracer_tpu_torch.parallel import (
    make_entity_mesh, make_mesh, render_frame_entity_sharded,
    render_frames_sharded, render_frames_shardmap, sharded_train_step)


def render_case(device, scene, config, players, lights, frame_parallel,
                cached):
    """This rank's (F, H, W, 3) frames of ``render_frames_sharded`` on a
    (frame_parallel, n / frame_parallel) mesh."""
    r = DeferredRenderer(config).configure_for(scene)
    cache = (StaticBins(scene.pos, scene.ext, 1, config, r.spans,
                        device=device) if cached else None)
    anim = AnimationRenderer(r, config, static_bins=cache)
    ds = DeviceScene.from_scene(scene, config, device=device)
    mesh = make_mesh(frame_parallel=frame_parallel)
    render = render_frames_shardmap if cached else render_frames_sharded
    return render(anim, ds, players.to(device), lights.to(device),
                  mesh).cpu()


def train_case(device, scene, config, targets, light0, frame_parallel,
               with_shadows):
    """``(light, loss, grad)`` after one ``sharded_train_step``: ``grad``
    is the light's gradient the step applied, summed over the ranks."""
    r = DeferredRenderer(config, shadow_max_steps=8).configure_for(scene)
    fitter = InverseLightFitter(config, r, with_shadows=with_shadows)
    ds = DeviceScene.from_scene(scene, config, device=device)
    light, opt = fitter.init(light0, device=device)
    light, _, loss = sharded_train_step(fitter, light, opt, ds,
                                        targets.to(device),
                                        make_mesh(frame_parallel=
                                                  frame_parallel))
    return light.detach().cpu(), loss.cpu(), light.grad.cpu()


def entity_case(device, scene, config, light, unchecked=False):
    """This rank's frame of ``render_frame_entity_sharded``."""
    r = DeferredRenderer(config).configure_for(scene)
    ds = DeviceScene.from_scene(scene, config, device=device)
    return render_frame_entity_sharded(r, ds, light, make_entity_mesh(),
                                       unchecked=unchecked).cpu()


CASES = {"render": render_case, "train": train_case, "entity": entity_case}


def run_cases(device, cases):
    """Run ``cases``, a list of ``(name, kind, kwargs)``, in order on this
    rank: ``{name: result}``, where a case that raises ``ValueError``
    gives its message."""
    out = {}
    for name, kind, kwargs in cases:
        try:
            out[name] = CASES[kind](device, **kwargs)
        except ValueError as e:
            out[name] = f"ValueError: {e}"
    return out
