"""Port renderers (``AnimationRenderer``, ``DeferredRenderer``) against the
NumPy and C++ oracles and the JAX package, on identical state.

Frames must be pixel-identical: the small-scene animation against
``oracle.render_frame`` and the JAX ``AnimationRenderer``, and one full
graybox frame at the bench's center light against ``cpp_render_frame``."""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from pixel_art_raytracer_tpu import oracle
from pixel_art_raytracer_tpu.config import DEFAULT_CONFIG, RenderConfig
from pixel_art_raytracer_tpu.models import animation as janimation
from pixel_art_raytracer_tpu.models import deferred as jdeferred
from pixel_art_raytracer_tpu.runtime import native
from pixel_art_raytracer_tpu.scene import (Light, SceneBuilder, default_light,
                                           demo_world, graybox_world)
from pixel_art_raytracer_tpu_torch.models.animation import (
    AnimationRenderer, WorldState, apply_keys)
from pixel_art_raytracer_tpu_torch.models.deferred import (DeferredRenderer,
                                                           DeviceScene)
from pixel_art_raytracer_tpu_torch.ops.static_bins import StaticBins

SMALL = RenderConfig(view_width=80, view_height=80, view_length=80)


@pytest.fixture(autouse=True)
def one_thread():
    """Run each test on one PyTorch thread: the suite runs in several
    worker processes at once, and the plain versions' many small ops slow
    down sharply when every worker also spreads over every core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def small_scene(config=SMALL):
    b = SceneBuilder(config=config)
    b.insert((30, 20, 20), (20, 20, 20))
    for i in range(3):
        for j in range(3):
            b.insert((i * 24, 0, j * 24), (16, 16, 16))
    return b.build()


def states(scene, seed=0, n=3):
    """Seeded player moves and lights, (n, 3) int32 each."""
    rng = np.random.default_rng(seed)
    players = (scene.pos[0] + rng.integers(-10, 11, (n, 3))).astype(np.int32)
    lights = np.column_stack([rng.integers(0, 80, n), rng.integers(30, 90, n),
                              rng.integers(0, 40, n)]).astype(np.int32)
    return players, lights


def oracle_frames(scene, players, lights, config):
    out = []
    for p, l in zip(players, lights):
        moved = dataclasses.replace(scene, pos=scene.pos.copy())
        moved.pos[0] = p
        out.append(oracle.render_frame(moved, Light(*map(int, l)), config)[0])
    return np.stack(out)


@pytest.mark.parametrize("cached", [True, False])
@pytest.mark.parametrize("scene_fn", [small_scene, lambda: demo_world(4, SMALL)],
                         ids=["small", "demo"])
def test_render_states_matches_oracle_and_jax(scene_fn, cached):
    scene = scene_fn()
    players, lights = states(scene)
    # Identical state: the port's tensors come from the JAX package's.
    jds = jdeferred.DeviceScene.from_scene(scene, SMALL)
    ds = DeviceScene.from_numpy({k: np.asarray(v) for k, v in
                                 jds._asdict().items() if v is not None},
                                device="cpu")
    r = DeferredRenderer(SMALL).configure_for(scene)
    cache = (StaticBins(scene.pos, scene.ext, 1, SMALL, r.spans, device="cpu")
             if cached else None)
    anim = AnimationRenderer(r, SMALL, static_bins=cache)
    frames = anim.render_states(ds, torch.from_numpy(players),
                                torch.from_numpy(lights)).numpy()
    assert frames.shape == (3, 80, 80, 3) and frames.dtype == np.uint8
    np.testing.assert_array_equal(
        frames, oracle_frames(scene, players, lights, SMALL))

    jr = jdeferred.DeferredRenderer(SMALL, shadow_max_steps=8,
                                    trace_impl="jnp", shadow_impl="scan")
    jr.spans = jr.spans_for(scene)
    jframes = janimation.AnimationRenderer(jr, SMALL).render_states(
        jds, jnp.asarray(players), jnp.asarray(lights))
    np.testing.assert_array_equal(frames, np.asarray(jframes))


def test_single_frame_is_the_f1_batch():
    scene = small_scene()
    ds = DeviceScene.from_scene(scene, SMALL, device="cpu")
    r = DeferredRenderer(SMALL).configure_for(scene)
    light = np.array([60, 60, 20], np.int32)
    frame = r.render(ds, light)
    cache = StaticBins(scene.pos, scene.ext, 1, SMALL, r.spans, device="cpu")
    batch = AnimationRenderer(r, SMALL, static_bins=cache).render_states(
        ds, ds.pos[:1], torch.from_numpy(light[None]))
    assert torch.equal(frame, batch[0])
    np.testing.assert_array_equal(
        r.render_numpy(scene, Light(60, 60, 20), device="cpu"),
        frame.numpy())


def test_graybox_center_frame_matches_cpp():
    scene = graybox_world(DEFAULT_CONFIG)
    light = default_light(DEFAULT_CONFIG)
    r = DeferredRenderer(DEFAULT_CONFIG).configure_for(scene)
    frame = r.render_numpy(scene, light, device="cpu")
    golden, _ = native.cpp_render_frame(scene, light, DEFAULT_CONFIG)
    np.testing.assert_array_equal(frame, golden)


def test_light_sweep_states_match_jax():
    scene = small_scene()
    anim = AnimationRenderer(DeferredRenderer(SMALL), SMALL)
    janim = janimation.AnimationRenderer(jdeferred.DeferredRenderer(SMALL),
                                         SMALL)
    for kw in ({}, {"center": (20, 40, 60), "radius": 40}):
        players, lights = anim.light_sweep_states(16, scene.pos[0],
                                                  device="cpu", **kw)
        jp, jl = janim.light_sweep_states(16, scene.pos[0], **kw)
        np.testing.assert_array_equal(players.numpy(), np.asarray(jp))
        np.testing.assert_array_equal(lights.numpy(), np.asarray(jl))
        assert players.dtype == lights.dtype == torch.int32


def test_apply_keys_matches_jax():
    keys = ["left", "up", "pageup", "o", "j", "a", "a"]
    s = apply_keys(WorldState(torch.tensor([10, 10, 10], dtype=torch.int32),
                              torch.tensor([0, 0, 0], dtype=torch.int32)),
                   keys)
    js = janimation.apply_keys(
        janimation.WorldState(jnp.asarray([10, 10, 10], jnp.int32),
                              jnp.asarray([0, 0, 0], jnp.int32)), keys)
    np.testing.assert_array_equal(s.player_pos.numpy(),
                                  np.asarray(js.player_pos))
    np.testing.assert_array_equal(s.light.numpy(), np.asarray(js.light))


@pytest.mark.cuda
def test_cuda_render_states_match_cpu(cuda):
    scene = demo_world(4, SMALL)
    players, lights = states(scene, seed=2, n=4)
    r = DeferredRenderer(SMALL).configure_for(scene)
    out = []
    for dev in ("cpu", cuda):
        ds = DeviceScene.from_scene(scene, SMALL, device=dev)
        cache = StaticBins(scene.pos, scene.ext, 1, SMALL, r.spans,
                           device=dev)
        out.append(AnimationRenderer(r, SMALL, static_bins=cache)
                   .render_states(ds, torch.from_numpy(players).to(dev),
                                  torch.from_numpy(lights).to(dev)).cpu())
    assert torch.equal(out[0], out[1])


@pytest.mark.cuda
def test_cuda_graybox_frame_matches_cpp(cuda):
    scene = graybox_world(DEFAULT_CONFIG)
    light = Light(20, 160, 80)
    r = DeferredRenderer(DEFAULT_CONFIG).configure_for(scene)
    frame = r.render_numpy(scene, light, device=cuda)
    golden, _ = native.cpp_render_frame(scene, light, DEFAULT_CONFIG)
    np.testing.assert_array_equal(frame, golden)
