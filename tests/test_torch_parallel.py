"""Port ``parallel/`` (frame x row sharded rendering, the data-parallel
training step, the entity-sharded render) against the single-process port
and the JAX package.

The ranks are processes on the CPU over gloo, started by
``parallel.launch.run_ranks`` (a ``FileStore`` in a temporary directory):
one run of 2 ranks and one of 4, each running every case of
``torch_parallel_ranks``.  Sharded frames must equal the single-process
port's and the JAX ``render_states``' pixel for pixel; the sharded step's
loss must be within 1e-6 and its light within rtol 1e-5 of
``train_step``'s (the bound tests/test_parallel.py holds JAX to: the psum
sums in another order), and so must the gradient it applied, summed over
the ranks, which is not 0 there; entity-sharded frames must equal the unsharded
render.  The windowed kernels are held to the full frame's rows on the
card."""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from pixel_art_raytracer_tpu.config import RenderConfig as JRenderConfig
from pixel_art_raytracer_tpu.models import animation as janimation
from pixel_art_raytracer_tpu.models import deferred as jdeferred
from pixel_art_raytracer_tpu.ops import binning as jbinning
from pixel_art_raytracer_tpu.parallel import entity_sharded as jentity
from pixel_art_raytracer_tpu.scene import SceneBuilder as JSceneBuilder
from pixel_art_raytracer_tpu.scene import demo_world as jdemo_world
from pixel_art_raytracer_tpu_torch.config import RenderConfig
from pixel_art_raytracer_tpu_torch.models import batched
from pixel_art_raytracer_tpu_torch.models.animation import AnimationRenderer
from pixel_art_raytracer_tpu_torch.models.deferred import (DeferredRenderer,
                                                           DeviceScene)
from pixel_art_raytracer_tpu_torch.models.inverse import InverseLightFitter
from pixel_art_raytracer_tpu_torch.ops import (binning, shade, shadow_cuda,
                                               trace, trace_cuda)
from pixel_art_raytracer_tpu_torch.parallel import (
    Mesh, entity_axis, envelope_ok, render_frame_entity_sharded)
from pixel_art_raytracer_tpu_torch.parallel.launch import (backend_for,
                                                           run_ranks)
from pixel_art_raytracer_tpu_torch.scene import SceneBuilder

import torch_parallel_ranks

SMALL = RenderConfig(view_width=80, view_height=80, view_length=80)
# Four bin rows of 40 pixels: whole-bin-row windows for 1, 2 and 4 row
# shards.
TALL = RenderConfig(view_width=80, view_height=160, view_length=80)
ENTITY = dataclasses.replace(SMALL, early_exit=False)
FRAMES = 8
LIGHT0 = np.array([20.0, 20.0, 40.0], np.float32)
ENTITY_LIGHT = (60, 60, 20)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One PyTorch thread for the module, its module fixtures included:
    the suite runs in several worker processes at once, and many threads
    a worker slow the plain versions down sharply on a loaded machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def small_scene(config, builder=SceneBuilder):
    """tests/test_parallel.py:23-29."""
    b = builder(config=config)
    b.insert((30, 20, 20), (20, 20, 20))
    for i in range(3):
        for j in range(3):
            b.insert((i * 24, 0, j * 24), (16, 16, 16))
    return b.build()


def entity_scene(builder=SceneBuilder, config=ENTITY):
    """tests/test_parallel.py:124-129: a player and 15 sparse floor tiles,
    at most 4 a bin (capacity 8), 16 entities."""
    b = builder(config=config)
    b.insert((30, 28, 16), (16, 16, 16))
    for i in range(5):
        for j in range(3):
            b.insert((i * 16, 0, j * 26), (12, 12, 12))
    return b.build()


def states():
    """tests/test_parallel.py:37-41: the player at home, 8 lights."""
    players = np.broadcast_to(np.array([30, 20, 20], np.int32), (FRAMES, 3))
    lights = np.stack([40 + 4 * np.arange(FRAMES), np.full(FRAMES, 60),
                       np.full(FRAMES, 20)], 1).astype(np.int32)
    return np.ascontiguousarray(players), lights


def port_frames(scene, config, players, lights):
    r = DeferredRenderer(config).configure_for(scene)
    ds = DeviceScene.from_scene(scene, config, device="cpu")
    return AnimationRenderer(r, config).render_states(
        ds, torch.from_numpy(players), torch.from_numpy(lights))


def jax_frames(config, players, lights):
    jcfg = JRenderConfig(**dataclasses.asdict(config))
    scene = small_scene(jcfg, JSceneBuilder)
    jr = jdeferred.DeferredRenderer(jcfg, shadow_max_steps=8,
                                    trace_impl="jnp", shadow_impl="scan")
    jr.spans = jr.spans_for(scene)
    jds = jdeferred.DeviceScene.from_scene(scene, jcfg)
    return np.asarray(janimation.AnimationRenderer(jr, jcfg).render_states(
        jds, jnp.asarray(players), jnp.asarray(lights)))


RENDER = [(2, 1, True), (1, 2, False), (4, 1, True), (1, 4, False),
          (2, 2, True)]
TRAIN = [(2, 1, False), (1, 2, True), (2, 2, True), (4, 1, False)]


def cases(world, scene, targets, players, lights):
    """Every case of a run of ``world`` ranks."""
    def render(fp, rp, cached):
        return (f"render {fp}x{rp}", "render", dict(
            scene=scene, config=TALL, players=torch.from_numpy(players),
            lights=torch.from_numpy(lights), frame_parallel=fp,
            cached=cached))

    def train(fp, rp, shadows):
        return (f"train {fp}x{rp} {shadows}", "train", dict(
            scene=scene, config=TALL, targets=targets,
            light0=torch.from_numpy(LIGHT0), frame_parallel=fp,
            with_shadows=shadows))

    out = [render(fp, rp, c) for fp, rp, c in RENDER if fp * rp == world]
    out += [train(fp, rp, s) for fp, rp, s in TRAIN if fp * rp == world]
    out.append((f"entity {world}", "entity", dict(
        scene=entity_scene(), config=ENTITY, light=ENTITY_LIGHT)))
    if world == 4:
        # 80 rows over 4 row shards: windows of 20 rows, half a bin row.
        out.append(("window", "render", dict(
            scene=small_scene(SMALL), config=SMALL,
            players=torch.from_numpy(players),
            lights=torch.from_numpy(lights), frame_parallel=1,
            cached=False)))
    return out


@pytest.fixture(scope="module")
def runs():
    """``{world: [rank results]}`` of one run of 2 ranks and one of 4."""
    scene = small_scene(TALL)
    players, lights = states()
    targets = port_frames(scene, TALL, players, lights).to(
        torch.float32) / 255.0
    out = {}
    for world in (2, 4):
        out[world] = run_ranks(
            torch_parallel_ranks.run_cases, world,
            (cases(world, scene, targets, players, lights),), device="cpu")
    return out


@pytest.fixture(scope="module")
def reference():
    """The single-process port's and the JAX package's frames at TALL, and
    the port's training targets."""
    scene = small_scene(TALL)
    players, lights = states()
    frames = port_frames(scene, TALL, players, lights)
    return scene, frames, jax_frames(TALL, players, lights)


@pytest.mark.parametrize("fp,rp,cached", RENDER)
def test_sharded_frames_match_single_process_and_jax(runs, reference, fp,
                                                     rp, cached):
    _, frames, jframes = reference
    np.testing.assert_array_equal(frames.numpy(), jframes)
    for rank, got in enumerate(runs[fp * rp]):
        assert torch.equal(got[f"render {fp}x{rp}"], frames), rank


@pytest.mark.parametrize("style,multi", [("reference", False),
                                         ("dithered", False),
                                         ("reference", True)])
def test_row_windows_stack_to_the_frames(style, multi):
    """``batched.gbuffer_and_frames`` over windows of whole bin rows, the
    rows a row shard renders, stacks to the whole view's frames and
    G-buffer: point and multi-light, the dither's Bayer phase included;
    directional lights take no window."""
    scene = small_scene(TALL)
    players, lights = (torch.from_numpy(a) for a in states())
    if multi:
        lights = torch.stack([lights, lights.flip(0)], dim=1)
    r = DeferredRenderer(TALL, style=style).configure_for(scene)
    ds = DeviceScene.from_scene(scene, TALL, device="cpu")
    gbuf, frames = batched.gbuffer_and_frames(r, None, ds, players, lights)
    parts = [batched.gbuffer_and_frames(r, None, ds, players, lights,
                                        rows=rows)
             for rows in ((0, 40), (40, 80), (120, 40))]
    assert torch.equal(torch.cat([f for _, f in parts], dim=1), frames)
    for k, field in enumerate(gbuf):
        assert torch.equal(torch.cat([g[k] for g, _ in parts], dim=1), field)
    with pytest.raises(ValueError, match="directional"):
        batched.gbuffer_and_frames(r, None, ds, players,
                                   torch.ones(FRAMES, 3), directional=True,
                                   rows=(0, 40))


def test_window_not_whole_bin_rows_raises(runs):
    for got in runs[4]:
        assert "whole bin rows" in got["window"]
    scene = small_scene(SMALL)
    ds = DeviceScene.from_scene(scene, SMALL, device="cpu")
    r = DeferredRenderer(SMALL).configure_for(scene)
    be, cnt = r.build_bins(ds)
    for rows in ((20, 20), (0, 60), (40, 60), (-40, 40)):
        with pytest.raises(ValueError, match="whole bin rows"):
            trace.row_window(SMALL, rows)
        with pytest.raises(ValueError, match="whole bin rows"):
            r.trace(ds, be, cnt, rows)
    assert trace.row_window(SMALL, (40, 40)) == (40, 40)
    assert trace.row_window(SMALL, None) == (0, 80)


@pytest.mark.parametrize("fp,rp,shadows", TRAIN)
def test_sharded_train_step_matches_train_step(runs, reference, fp, rp,
                                               shadows):
    scene, frames, _ = reference
    r = DeferredRenderer(TALL, shadow_max_steps=8).configure_for(scene)
    fitter = InverseLightFitter(TALL, r, with_shadows=shadows)
    ds = DeviceScene.from_scene(scene, TALL, device="cpu")
    light, opt = fitter.init(torch.from_numpy(LIGHT0))
    light, _, loss = fitter.train_step(light, opt, ds,
                                       frames.to(torch.float32) / 255.0)
    grad = light.grad.numpy()
    # A gradient of 0 would leave the light where it is with or without
    # the exchange between ranks; Adam's first step is about lr * sign(g).
    assert np.all(grad != 0)
    for got in runs[fp * rp]:
        light_sh, loss_sh, grad_sh = got[f"train {fp}x{rp} {shadows}"]
        assert abs(float(loss) - float(loss_sh)) < 1e-6
        np.testing.assert_allclose(grad_sh.numpy(), grad, rtol=1e-5)
        np.testing.assert_allclose(light_sh.numpy(), light.detach().numpy(),
                                   rtol=1e-5)


@pytest.mark.parametrize("world", [2, 4])
def test_entity_sharded_matches_unsharded(runs, world):
    scene = entity_scene()
    r = DeferredRenderer(ENTITY).configure_for(scene)
    ds = DeviceScene.from_scene(scene, ENTITY, device="cpu")
    want = r.render(ds, np.array(ENTITY_LIGHT))
    jcfg = JRenderConfig(**dataclasses.asdict(ENTITY))
    jscene = entity_scene(JSceneBuilder, jcfg)
    jr = jdeferred.DeferredRenderer(jcfg, shadow_impl="scan",
                                    trace_impl="jnp", shadow_max_steps=8)
    jr.spans = jr.spans_for(jscene)
    jwant = np.asarray(jr.render(jdeferred.DeviceScene.from_scene(jscene,
                                                                  jcfg),
                                 jnp.asarray(ENTITY_LIGHT, jnp.int32)))
    np.testing.assert_array_equal(want.numpy(), jwant)
    for got in runs[world]:
        assert torch.equal(got[f"entity {world}"], want)


def stacked_scene(config, builder=SceneBuilder):
    """tests/test_parallel.py:172-175: 16 boxes stacked in one bin."""
    b = builder(config=config)
    for _ in range(16):
        b.insert((4, 4, 4), (8, 8, 8))
    return b.build()


@pytest.mark.parametrize("case", ["early_exit", "overflow", "ok"])
def test_envelope_gives_the_jax_reasons(case):
    config = SMALL if case == "early_exit" else ENTITY
    jcfg = JRenderConfig(**dataclasses.asdict(config))
    build = stacked_scene if case != "ok" else entity_scene
    scene = build(builder=SceneBuilder, config=config)
    jscene = build(builder=JSceneBuilder, config=jcfg)
    got = envelope_ok(scene.pos, scene.ext, config)
    assert got == jentity.envelope_ok(jscene.pos, jscene.ext, jcfg)
    assert got[0] == (case == "ok")
    if case == "ok":
        return
    r = DeferredRenderer(config).configure_for(scene)
    ds = DeviceScene.from_scene(scene, config, device="cpu")
    with pytest.raises(ValueError, match=case):
        render_frame_entity_sharded(r, ds, ENTITY_LIGHT,
                                    Mesh((entity_axis,), (2,)))


@pytest.mark.parametrize("world", ["demo", "small", "stacked"])
def test_bin_totals_match_jax(world):
    jcfg = JRenderConfig()
    config = RenderConfig()
    if world == "demo":
        jscene = jdemo_world(6, jcfg)
    elif world == "small":
        jscene = small_scene(jcfg, JSceneBuilder)
    else:
        jscene = stacked_scene(jcfg, JSceneBuilder)
    np.testing.assert_array_equal(
        binning.bin_totals_numpy(jscene.pos, jscene.ext, config),
        jbinning.bin_totals_numpy(jscene.pos, jscene.ext, jcfg))


def test_backend_rule():
    assert backend_for("cpu", 4) == "gloo"
    if torch.cuda.device_count() < 2:
        assert backend_for("cuda", 2) == "gloo"


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [(0, 40), (40, 80), (120, 40)])
def test_cuda_windowed_kernels_equal_full_frame_rows(cuda, rows):
    """``trace.cu`` and the point mode of ``shadow.cu`` launched over a
    window of bin rows equal the full frame's rows of the same kernels
    and of the plain versions."""
    scene = small_scene(TALL)
    players, lights = states()
    r = DeferredRenderer(TALL).configure_for(scene)
    ds = DeviceScene.from_scene(scene, TALL, device=cuda)
    players, lights = (torch.from_numpy(a).to(cuda) for a in (players,
                                                               lights))
    be, cnt = batched.bin_stage(r, None, ds, players)
    row0, n = rows
    args = (ds.pos, ds.ext, ds.sprite_id, ds.atlas_depth, be, cnt, players,
            TALL)
    best, win = trace_cuda.trace_winners(*args, with_best=True)
    best_w, win_w = trace_cuda.trace_winners(*args, with_best=True,
                                             rows=rows)
    assert torch.equal(win_w, win[:, row0:row0 + n])
    assert torch.equal(best_w, best[:, row0:row0 + n])
    best_p, win_p = trace.trace_winner(*(a.cpu() if torch.is_tensor(a)
                                         else a for a in args), rows=rows)
    assert torch.equal(win_w.cpu(), win_p)
    assert torch.equal(best_w.cpu(), best_p)
    for gbuf, window in ((batched.trace_stage(r, ds, be, cnt, players),
                          None),
                         (batched.trace_stage(r, ds, be, cnt, players, rows),
                          rows)):
        _, inv, origin, rb, lb = shade.light_geometry(gbuf, lights, TALL)
        sargs = (ds.pos, ds.ext, be, cnt, rb, lb, gbuf.entity_index, origin,
                 inv, players, TALL)
        if window is None:
            full = shadow_cuda.trace_light(*sargs)[:, row0:row0 + n]
        else:
            lit = shadow_cuda.trace_light(*sargs, rows=rows)
            assert torch.equal(lit, full)
            plain = shadow_cuda.trace_light(
                *(tuple(t.cpu() for t in a) if isinstance(a, tuple)
                  else a.cpu() if torch.is_tensor(a) else a for a in sargs),
                rows=rows)
            assert torch.equal(lit.cpu(), plain)
