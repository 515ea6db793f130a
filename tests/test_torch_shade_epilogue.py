"""The winner-input point mode of ``csrc/shadow.cu`` (the JAX shadow
kernel's winner-direct inputs and shade epilogue, ``shadow_pallas.py:
766-790, 1140-1216``) and the main path that runs it.

Its plain version, ``ops/shade.point_frames``, goes from the trace
kernel's winners to the frames (and the lit mask); it must equal the
G-buffer chain of ``models/batched.py`` bit for bit on the lights where
the float and integer rules matter: a light on a surface point (length 0,
NaN direction and dot), lights at negative coordinates and below the view
(C's truncating ``/`` for the light bin), a light behind every face (dot
<= 0), and background pixels in every frame.  ``render_states`` on the
main path must equal the JAX package's default batched path (Pallas in
interpret mode) and must call no ``materialize_gbuffer`` or
``light_geometry`` outside the kernel's plain version.  The CUDA cases
(skipped without a card) hold the kernel to its plain version on graybox
and count the main path's launches.
"""

import contextlib

import numpy as np
import pytest
import torch

from pixel_art_raytracer_tpu.config import DEFAULT_CONFIG as JAX_CONFIG
from pixel_art_raytracer_tpu.models import animation as janimation
from pixel_art_raytracer_tpu.models import deferred as jdeferred
from pixel_art_raytracer_tpu.ops import shadow_fast
from pixel_art_raytracer_tpu.ops.static_bins import StaticBins as JStaticBins
from pixel_art_raytracer_tpu.scene import demo_world as jdemo_world
from pixel_art_raytracer_tpu_torch import (DEFAULT_CONFIG, RenderConfig,
                                           SceneBuilder, default_light,
                                           demo_world, graybox_world)
from pixel_art_raytracer_tpu_torch.models import batched
from pixel_art_raytracer_tpu_torch.models.animation import AnimationRenderer
from pixel_art_raytracer_tpu_torch.models.deferred import (DeferredRenderer,
                                                           DeviceScene)
from pixel_art_raytracer_tpu_torch.ops import (shade, shadow_cuda, trace,
                                               trace_cuda)
from pixel_art_raytracer_tpu_torch.ops.cstyle import c_div
from pixel_art_raytracer_tpu_torch.ops.static_bins import StaticBins

SMALL = RenderConfig(view_width=80, view_height=80, view_length=80)


@pytest.fixture(autouse=True)
def one_thread():
    """One PyTorch thread a test: the suite runs in several worker
    processes at once."""
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


def moving_players(scene, n, seed=0):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(
        (scene.pos[0] + rng.integers(-10, 11, (n, 3))).astype(np.int32))


def scene_inputs(device="cpu"):
    """The small scene with a moving player over 3 frames: the renderer,
    the device scene, the players and each frame's bin tables."""
    scene = small_scene()
    ds = DeviceScene.from_scene(scene, SMALL, device=device)
    r = DeferredRenderer(SMALL).configure_for(scene)
    cache = StaticBins(scene.pos, scene.ext, 1, SMALL, r.spans,
                       device=device)
    players = moving_players(scene, 3).to(device)
    be, cnt = batched.bin_stage(r, cache, ds, players)
    return r, ds, players, be, cnt


def edge_lights(case, gbuf):
    """(3, 3) int32 lights of one edge case, from the frames' G-buffer."""
    H = SMALL.view_height
    if case == "ordinary":
        return torch.tensor([[60, 60, 20], [10, 70, 5], [70, 45, 35]],
                            dtype=torch.int32)
    if case == "on_surface":
        # Each frame's light sits on the surface point of a hit pixel.
        rows = []
        for f in range(gbuf.y.shape[0]):
            hit = torch.nonzero(gbuf.entity_index[f] > 0)
            j, i = (int(v) for v in hit[len(hit) // 2])
            rows.append([i, int(gbuf.y[f, j, i]), int(gbuf.z[f, j, i])])
        return torch.tensor(rows, dtype=torch.int32)
    if case == "negative_or_below_view":
        # Negative x and z; and view_h - y - z < 0, not a multiple of the
        # bin size.
        return torch.tensor([[-37, 50, -13], [30, 2 * H + 9, H + 1],
                             [-5, -45, 3]], dtype=torch.int32)
    if case == "behind_every_face":
        # Below every top face and behind every front face.
        return torch.tensor([[40, -30, 300], [0, -1, 250], [79, -60, 400]],
                            dtype=torch.int32)
    raise ValueError(case)


def gbuffer_chain(r, ds, players, be, cnt, lights):
    """The G-buffer path's frames and lit mask, stage by stage."""
    gbuf = batched.trace_stage(r, ds, be, cnt, players)
    dot, *rays = batched.geometry_stage(r, gbuf, lights)
    lit = batched.shadow_stage(r, ds, be, cnt, players, gbuf, *rays)
    frames = batched.shade_stage(r, ds, gbuf,
                                 shade.factor_from_dot(dot, lit, r.config))
    return gbuf, dot, lit, frames


def plain_winner_input(ds, players, be, cnt, winners, lights, frames=True):
    return shade.point_frames(winners, ds.pos, ds.ext, ds.sprite_id,
                              ds.atlas_color, ds.atlas_depth,
                              ds.atlas_normal, ds.palette, be, cnt, players,
                              lights, SMALL, frames=frames)


@pytest.mark.parametrize("case", ["ordinary", "on_surface",
                                  "negative_or_below_view",
                                  "behind_every_face"])
def test_plain_winner_input_matches_gbuffer_chain(case):
    r, ds, players, be, cnt = scene_inputs()
    winners = batched.winner_stage(r, ds, be, cnt, players)
    gbuf0 = trace.materialize_gbuffer(
        winners, ds.pos, ds.ext, ds.sprite_id, ds.atlas_color,
        ds.atlas_depth, ds.atlas_normal, ds.palette, players, SMALL)
    lights = edge_lights(case, gbuf0)
    gbuf, dot, lit, frames = gbuffer_chain(r, ds, players, be, cnt, lights)

    # Every frame holds background pixels, and each case is what it says.
    assert bool((winners < 0).any(dim=(1, 2)).all())
    hit = winners >= 0
    if case == "on_surface":
        assert bool(torch.isnan(dot).any(dim=(1, 2)).all())
    if case == "negative_or_below_view":
        H, bs = SMALL.view_height, SMALL.bin_size
        lb = torch.stack([c_div(lights[:, 0], bs),
                          c_div(H - lights[:, 1] - lights[:, 2], bs),
                          c_div(lights[:, 2], bs)], 1)
        floor = torch.stack([lights[:, 0] // bs,
                             (H - lights[:, 1] - lights[:, 2]) // bs,
                             lights[:, 2] // bs], 1)
        assert bool((lb != floor).any(dim=1).all())
    if case == "behind_every_face":
        assert bool((dot[hit] <= 0).all())
    assert bool(lit.any()) and bool((~lit).any())

    got_lit = plain_winner_input(ds, players, be, cnt, winners, lights,
                                 frames=False)
    got = plain_winner_input(ds, players, be, cnt, winners, lights)
    assert got_lit.dtype == torch.bool and torch.equal(got_lit, lit)
    assert got.shape == (3, 80, 80, 3) and got.dtype == torch.uint8
    assert torch.equal(got, frames)
    # The wrapper takes the plain version for CPU tensors.
    assert torch.equal(shadow_cuda.shade_point(
        winners, ds.pos, ds.ext, ds.sprite_id, ds.atlas_color,
        ds.atlas_depth, ds.atlas_normal, ds.palette, be, cnt, players,
        lights, SMALL), frames)


def test_shade_point_refuses_other_devices():
    r, ds, players, be, cnt = scene_inputs()
    meta = [t.to("meta") for t in (ds.pos, ds.ext, ds.sprite_id,
                                   ds.atlas_color, ds.atlas_depth,
                                   ds.atlas_normal, ds.palette, be, cnt,
                                   players)]
    winners = torch.empty((3, 80, 80), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no kernel for device meta"):
        shadow_cuda.shade_point(winners, *meta[:-1], meta[-1], meta[-1],
                                SMALL)


def test_render_states_matches_jax_default_batched_path():
    """``tests/test_batched.py``'s case: ``demo_world(10)`` at full width,
    the player moved, against the JAX package's default batched path
    (winner-direct shadow inputs, Pallas in interpret mode).  Its two
    player moves take a frame each: two frames, not three, keep the plain
    march on the CPU to ~20 s."""
    jscene = jdemo_world(10)
    jds = jdeferred.DeviceScene.from_scene(jscene)
    jr = jdeferred.DeferredRenderer(
        JAX_CONFIG, shadow_impl="pallas", trace_impl="auto",
        shadow_tables=shadow_fast.default_tables(JAX_CONFIG,
                                                 max_candidates=1024))
    jr.configure_for(jscene)
    janim = janimation.AnimationRenderer(
        jr, JAX_CONFIG, static_bins=JStaticBins(jscene.pos, jscene.ext, 1,
                                                JAX_CONFIG, jr.spans),
        batched=True)
    assert janim._batched_capable(jds)
    light = default_light()
    players, lights = janim.light_sweep_states(
        2, jscene.pos[0], center=(light.x, light.y, light.z), radius=40)
    players = players.at[0, 0].add(25).at[1, 2].add(-15)
    want = np.asarray(janim.render_states(jds, players, lights))

    scene = demo_world(10, DEFAULT_CONFIG)
    np.testing.assert_array_equal(scene.pos, np.asarray(jscene.pos))
    ds = DeviceScene.from_scene(scene, DEFAULT_CONFIG, device="cpu")
    r = DeferredRenderer(DEFAULT_CONFIG).configure_for(scene)
    cache = StaticBins(scene.pos, scene.ext, 1, DEFAULT_CONFIG, r.spans,
                       device="cpu")
    lights_t = torch.from_numpy(np.array(lights))
    assert batched.winner_inputs(r, lights_t, False)
    got = AnimationRenderer(r, DEFAULT_CONFIG, static_bins=cache) \
        .render_states(ds, torch.from_numpy(np.array(players)), lights_t)
    np.testing.assert_array_equal(got.numpy(), want)


@contextlib.contextmanager
def glue_forbidden(monkeypatch, allow_plain: bool):
    """``materialize_gbuffer``, ``light_geometry``, ``factor_from_dot`` and
    ``shade_u8`` raise when called; with ``allow_plain``, not while
    ``shade.point_frames`` (the kernel's plain version, which the wrapper
    runs for CPU tensors in the kernel's place) is running.  Yields the
    calls of the kernel wrappers."""
    inside = [False]
    calls = {"trace_winners": 0, "shade_point": 0}

    def forbid(name, fn):
        def guarded(*a, **k):
            if not inside[0]:
                raise AssertionError(f"{name} called on the main path")
            return fn(*a, **k)
        return guarded

    for mod, name in ((trace, "materialize_gbuffer"),
                      (shade, "light_geometry"),
                      (shade, "factor_from_dot"), (shade, "shade_u8")):
        monkeypatch.setattr(mod, name, forbid(name, getattr(mod, name)))
    point_frames = shade.point_frames

    def plain(*a, **k):
        inside[0] = allow_plain
        try:
            return point_frames(*a, **k)
        finally:
            inside[0] = False

    def counted(name, fn):
        def wrapper(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapper

    monkeypatch.setattr(shade, "point_frames", plain)
    monkeypatch.setattr(trace_cuda, "trace_winners",
                        counted("trace_winners", trace_cuda.trace_winners))
    monkeypatch.setattr(shadow_cuda, "shade_point",
                        counted("shade_point", shadow_cuda.shade_point))
    yield calls


@pytest.mark.parametrize("cached", [True, False])
def test_main_path_materialises_no_gbuffer(monkeypatch, cached):
    scene = demo_world(4, SMALL)
    ds = DeviceScene.from_scene(scene, SMALL, device="cpu")
    r = DeferredRenderer(SMALL).configure_for(scene)
    cache = (StaticBins(scene.pos, scene.ext, 1, SMALL, r.spans,
                        device="cpu") if cached else None)
    anim = AnimationRenderer(r, SMALL, static_bins=cache)
    players = moving_players(scene, 3, seed=1)
    lights = torch.tensor([[60, 60, 20], [10, 70, 5], [70, 45, 35]],
                          dtype=torch.int32)
    want = batched.gbuffer_and_frames(r, cache, ds, players, lights)[1]
    with glue_forbidden(monkeypatch, allow_plain=True) as calls:
        got = anim.render_states(ds, players, lights)
    assert calls == {"trace_winners": 1, "shade_point": 1}
    assert torch.equal(got, want)


@pytest.mark.parametrize("request_kind", ["dithered", "multi_light",
                                          "fused"])
def test_other_requests_keep_the_gbuffer(request_kind):
    """The JAX package's own path choice: the dithered style (of one
    point light or of additive multi-light) and the fused opt-in shade
    from a G-buffer.  (Multi-light in the reference style takes the
    multi-light mode: tests/test_torch_lights3.py.)"""
    scene = demo_world(4, SMALL)
    r = DeferredRenderer(SMALL, style="reference" if request_kind == "fused"
                         else "dithered")
    r.fuse_trace_shadow = request_kind == "fused"
    lights = torch.zeros((2, 3, 3) if request_kind == "multi_light"
                         else (2, 3), dtype=torch.int32)
    assert not batched.winner_inputs(r.configure_for(scene), lights, False)


def graybox_inputs(device, frames):
    cfg = DEFAULT_CONFIG
    scene = graybox_world(cfg)
    r = DeferredRenderer(cfg).configure_for(scene)
    cache = StaticBins(scene.pos, scene.ext, 1, cfg, r.spans, device=device)
    anim = AnimationRenderer(r, cfg, static_bins=cache)
    ds = DeviceScene.from_scene(scene, cfg, device=device)
    light = default_light(cfg)
    players, lights = anim.light_sweep_states(
        frames, scene.pos[0], center=(light.x, light.y, light.z), radius=40,
        device=device)
    return r, cache, anim, ds, players, lights


@pytest.mark.cuda
def test_cuda_shade_point_matches_plain_on_graybox(cuda):
    r, cache, _, ds, players, lights = graybox_inputs(cuda, 8)
    be, cnt = batched.bin_stage(r, cache, ds, players)
    winners = batched.winner_stage(r, ds, be, cnt, players)
    args = (winners, ds.pos, ds.ext, ds.sprite_id, ds.atlas_color,
            ds.atlas_depth, ds.atlas_normal, ds.palette, be, cnt, players,
            lights, DEFAULT_CONFIG)
    for frames in (True, False):
        n = shadow_cuda.shade_launches
        got = shadow_cuda.shade_point(*args, frames=frames)
        torch.cuda.synchronize()
        assert shadow_cuda.shade_launches == n + 1
        assert torch.equal(got, shade.point_frames(*args, frames=frames))


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["ordinary", "on_surface",
                                  "negative_or_below_view",
                                  "behind_every_face"])
def test_cuda_shade_point_matches_plain_on_edge_lights(cuda, case):
    out = []
    for dev in ("cpu", cuda):
        r, ds, players, be, cnt = scene_inputs(dev)
        winners = batched.winner_stage(r, ds, be, cnt, players)
        gbuf = trace.materialize_gbuffer(
            winners.cpu(), ds.pos.cpu(), ds.ext.cpu(), ds.sprite_id.cpu(),
            ds.atlas_color.cpu(), ds.atlas_depth.cpu(),
            ds.atlas_normal.cpu(), ds.palette.cpu(), players.cpu(), SMALL)
        lights = edge_lights(case, gbuf).to(dev)
        out.append([shadow_cuda.shade_point(
            winners, ds.pos, ds.ext, ds.sprite_id, ds.atlas_color,
            ds.atlas_depth, ds.atlas_normal, ds.palette, be, cnt, players,
            lights, SMALL, frames=f).cpu() for f in (True, False)])
    assert torch.equal(out[0][0], out[1][0])
    assert torch.equal(out[0][1], out[1][1])


@pytest.mark.cuda
def test_cuda_main_path_launches_trace_and_shade_once(cuda, monkeypatch):
    r, _, anim, ds, players, lights = graybox_inputs(cuda, 8)
    want = batched.gbuffer_and_frames(r, anim.static_bins, ds, players,
                                      lights)[1]
    counts = (trace_cuda.launches, shadow_cuda.launches,
              shadow_cuda.shade_launches)
    with glue_forbidden(monkeypatch, allow_plain=False) as calls:
        got = anim.render_states(ds, players, lights)
        torch.cuda.synchronize()
    assert calls == {"trace_winners": 1, "shade_point": 1}
    assert (trace_cuda.launches - counts[0], shadow_cuda.launches
            - counts[1], shadow_cuda.shade_launches - counts[2]) == (1, 0, 1)
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_cuda_shade_occupancy(cuda):
    smem, blocks, regs, _ = shadow_cuda.shade_occupancy(DEFAULT_CONFIG)
    assert smem == shadow_cuda.shade_smem_bytes(DEFAULT_CONFIG)
    assert blocks == 4 and regs > 0
