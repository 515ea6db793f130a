"""BASELINE config 4 on the port: the benchmark's ``config4`` scene, its
plain reference (``port_bench/reference/sun.py``) and its cell
``config4.sun64``, on the CPU.

The scene generator builds config 3's overlap scene box for box.  At a
small view whose edge tiles are partial (104 x 104 x 80 in bins of 40, 41
of the generator's boxes), the port's ``render_states(...,
directional=True)`` on ``style="dithered"`` equals the plain reference
pixel for pixel, and both equal the JAX package's batched directional
dithered path (Pallas in interpret mode); the reference computed in
bfloat16, the comparison's control, differs.  A run of the small cell
through ``harness.run`` is correct, with and without the traced split of
its stages, and a run whose frames are altered is not.  The cell's three
readers read their numbers from made-up records and nothing from records
without their inputs, as a program without the directional counter gives.
On the card, the port's frames at the published 512 x 512 equal the
reference's.
"""

from __future__ import annotations

import json
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pixel_art_raytracer_tpu.assets import SpriteAtlas as JAtlas
from pixel_art_raytracer_tpu.config import RenderConfig as JConfig
from pixel_art_raytracer_tpu.models import animation as janimation
from pixel_art_raytracer_tpu.models import deferred as jdeferred
from pixel_art_raytracer_tpu.ops import shadow_fast
from pixel_art_raytracer_tpu.ops.static_bins import StaticBins as JStaticBins
from pixel_art_raytracer_tpu.scene import Scene as JScene
from pixel_art_raytracer_tpu_torch.models import batched
from pixel_art_raytracer_tpu_torch.models.animation import AnimationRenderer
from pixel_art_raytracer_tpu_torch.models.deferred import (DeferredRenderer,
                                                           DeviceScene)
from pixel_art_raytracer_tpu_torch.ops import shadow_cuda
from pixel_art_raytracer_tpu_torch.ops.static_bins import StaticBins
from pixel_art_raytracer_tpu_torch.runtime import kernels
from port_bench import bounds_sun, harness, profiling, program, run, spec
from port_bench.reference import sun
from test_configs import overlap_scene

CPU = torch.device("cpu")
# The small view: 2.6 bins a side, so the right and bottom tiles are
# partial, and a multiple of 8 rows, as the JAX batched path needs.
SMALL = dict(view_width=104, view_height=104, view_length=80, boxes=41)
# Frame 0 faces the sun along (1, 1, 0): its reciprocal direction is
# infinite in z.  The others are seeded.
ANGLES = np.concatenate([[0.0], np.random.default_rng(3).uniform(
    0.0, 2.0 * np.pi, 2)])
READERS = ["dir_march_roofline.batch", "dir_slab_tests_per_pixel.batch",
           "glue_ms_per_frame.batch", "dir_marched_share.batch"]


@pytest.fixture(autouse=True)
def one_thread():
    """One PyTorch thread a test: the suite runs in several workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def cell() -> spec.Cell:
    """The cell ``config4.sun64`` at the small view, batches of 2 frames,
    every frame of the run kept for the comparison."""
    c = spec.make_cell("config4.sun64", "config4", "sun64", 1,
                       json.loads(spec.BENCHMARK.read_text()))
    c.config = dict(c.config, **SMALL)
    c.traffic = dict(c.traffic, frames_per_batch=2, prestaged_batches=3,
                     sample_frames=64)
    return c


def states(arrays):
    """The player at home in each frame and the frames' directions."""
    players = np.broadcast_to(arrays["pos"][0],
                              (len(ANGLES), 3)).astype(np.int32)
    directions = np.stack([np.cos(ANGLES), np.ones_like(ANGLES),
                           0.5 * np.sin(ANGLES)], -1).astype(np.float32)
    return players, directions


def reference_frames(c, arrays, players, directions, fdt=torch.float32):
    return sun.render_frames(
        harness.reference_scene(arrays, c.config, CPU),
        torch.from_numpy(players), torch.from_numpy(directions),
        harness.view(c.config), fdt, c.config["bayer"]).numpy()


def port_frames(c, arrays, players, directions):
    cfg = program.render_config(c.config)
    scene = program.scene(arrays)
    r = DeferredRenderer(cfg, style="dithered").configure_for(scene)
    cache = StaticBins(scene.pos, scene.ext, 1, cfg, r.spans, device=CPU)
    return AnimationRenderer(r, cfg, static_bins=cache).render_states(
        DeviceScene.from_scene(scene, cfg, device=CPU),
        torch.from_numpy(players), torch.from_numpy(directions),
        directional=True).numpy()


def jax_frames(c, arrays, players, directions):
    """The JAX package's batched path on the same scene, states and
    config (its guard off, on tables derived to cover the scene, as
    ``test_torch_lights``' batched comparison)."""
    cfg = program.render_config(c.config)
    jcfg = JConfig(**{k: getattr(cfg, k) for k in (
        *program.CONFIG_KEYS, "background", "palette")})
    scene = JScene(pos=arrays["pos"], ext=arrays["ext"],
                   sprite_id=arrays["sprite_id"],
                   atlas=JAtlas(color=arrays["atlas_color"],
                                depth=arrays["atlas_depth"],
                                normal=arrays["atlas_normal"]))
    jr = jdeferred.DeferredRenderer(
        jcfg, shadow_impl="pallas", trace_impl="auto",
        shadow_tables=shadow_fast.derive_tables(jcfg, scene),
        shadow_guard="none", style="dithered")
    jr.configure_for(scene)
    jds = jdeferred.DeviceScene.from_scene(scene, jcfg)
    janim = janimation.AnimationRenderer(
        jr, jcfg, static_bins=JStaticBins(scene.pos, scene.ext, 1, jcfg,
                                          jr.spans), batched=True)
    assert janim._batched_capable(jds)
    return np.asarray(janim.render_states(jds, jnp.asarray(players),
                                          jnp.asarray(directions),
                                          directional=True))


def test_scene_is_config_3s_overlap_scene():
    c = spec.make_cell("config4.sun64", "config4", "sun64", 1,
                       json.loads(spec.BENCHMARK.read_text()))
    want = overlap_scene(JConfig(view_width=512, view_height=512,
                                 view_length=320))
    got = c.scene()
    assert want.n_entities == c.config["boxes"] == 1025
    np.testing.assert_array_equal(got["pos"], want.pos)
    np.testing.assert_array_equal(got["ext"], want.ext)


def test_port_equals_reference_and_jax_on_small_frames():
    c = cell()
    arrays = c.scene()
    players, directions = states(arrays)
    want = reference_frames(c, arrays, players, directions)
    got = port_frames(c, arrays, players, directions)
    assert got.shape == (len(ANGLES), 104, 104, 3)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(jax_frames(c, arrays, players,
                                             directions), want)
    palette = {tuple(p[:3]) for p in c.config["palette"]}
    assert {tuple(p) for p in want.reshape(-1, 3)} <= palette
    # Shadows and the dither both show: more than two palette colours.
    assert len({tuple(p) for p in want.reshape(-1, 3)}) >= 3


def test_bfloat16_control_differs():
    c = cell()
    arrays = c.scene()
    players, directions = states(arrays)
    want = reference_frames(c, arrays, players, directions)
    control = reference_frames(c, arrays, players, directions,
                               torch.bfloat16)
    assert (control != want).any(-1).sum() > 0


def run_cell(c, trace: bool):
    record, setup_s, peak, compared = harness.run(
        c, 2 ** 31 + 12345, 0.5, trace, CPU, time.perf_counter())
    return record, run.result(c, record, setup_s, peak, compared, CPU,
                              int(trace))


@pytest.mark.parametrize("trace", [False, True])
def test_small_cell_run_is_correct(trace):
    record, out = run_cell(cell(), trace)
    assert out["correct"] is True
    assert out["compared"]["frames_compared"]["value"] >= 2
    if trace:
        assert record.stages["split_ok"]
        assert set(record.stages) >= set(
            spec.load_module(spec.ROOT / "entries" / "sun.py").STAGES)
        # No card, so no directional counter: the slab reader is silent.
        assert set(out["metrics"]) == {"dir_march_roofline.batch",
                                       "glue_ms_per_frame.batch"}
    else:
        assert set(out["metrics"]) == {"setup_s", "mrays_per_s"}


def test_altered_frames_are_caught(monkeypatch):
    # The stage that shades the cell's frames: the winner-input
    # directional mode's.
    real = batched.shade_directional_stage

    def altered(*args, **kw):
        frames = real(*args, **kw).clone()
        frames[..., 0, 0, :] ^= 1
        return frames

    monkeypatch.setattr(batched, "shade_directional_stage", altered)
    assert run_cell(cell(), False)[1]["correct"] is False


@pytest.mark.cuda
def test_cuda_port_equals_reference_at_512():
    """On the card, the port's frames at config 4's published 512 x 512
    (the winner-input directional mode, dithered) equal the plain
    reference's, at two sun positions."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cuda = torch.device("cuda")
    c = spec.make_cell("config4.sun64", "config4", "sun64", 1,
                       json.loads(spec.BENCHMARK.read_text()))
    arrays = c.scene()
    cfg = program.render_config(c.config)
    scene = program.scene(arrays)
    t = np.float32([0.7, 3.9])
    directions = np.stack([np.cos(t), np.ones_like(t), 0.5 * np.sin(t)],
                          -1).astype(np.float32)
    players = np.tile(arrays["pos"][0], (2, 1)).astype(np.int32)
    r = DeferredRenderer(cfg, style="dithered").configure_for(scene)
    cache = StaticBins(scene.pos, scene.ext, 1, cfg, r.spans, device=cuda)
    got = AnimationRenderer(r, cfg, static_bins=cache).render_states(
        DeviceScene.from_scene(scene, cfg, device=cuda),
        torch.from_numpy(players).to(cuda),
        torch.from_numpy(directions).to(cuda), directional=True)
    want = sun.render_frames(
        harness.reference_scene(arrays, c.config, cuda),
        torch.from_numpy(players).to(cuda),
        torch.from_numpy(directions).to(cuda), harness.view(c.config),
        torch.float32, c.config["bayer"])
    assert got.shape == (2, 512, 512, 3)
    assert torch.equal(got, want)


def record(stages=None, traced=True):
    trace = profiling.Trace([(0.0, 0.1, "k")], [], 2.0)
    return harness.RunRecord(
        "x", 3, 12, 1.0, [], 100,
        {"frames": 64, "height": 512, "width": 512, "volume": 1352,
         "capacity": 8}, trace if traced else None, 12, stages)


class Counters:
    """A counter's ``read()`` as a program gives it."""

    def __init__(self, **values):
        self.values = values

    def read(self):
        return dict(self.values)


STAGES = {"split_ok": True, "runs": 2, "frames": 128, "bins": 1.0,
          "trace": 2.0, "gbuffer": 3.0, "dot": 0.5, "march": 4.0,
          "shade": 6.5}


def test_readers_read_their_numbers(monkeypatch):
    monkeypatch.setattr(shadow_cuda, "counters", Counters(
        slab_tests=5000, dir_pixels=1000, dir_shade_pixels=1000,
        dir_marched_pixels=400))
    read = {n: spec.metric_reader(n)(record(STAGES)) for n in READERS}
    bound = bounds_sun.dir_march_bound_s(64, 512, 512, 1352, 8)
    assert read["dir_march_roofline.batch"] == pytest.approx(
        100 * bound * 2 / 4e-3)
    assert read["dir_slab_tests_per_pixel.batch"] == pytest.approx(5.0)
    assert read["glue_ms_per_frame.batch"] == pytest.approx(10.0 / 128)
    assert read["dir_marched_share.batch"] == pytest.approx(40.0)
    # The bytes bound the directional mode: 13 B a pixel, the tables.
    pixels = 64 * 512 * 512
    assert bound == pytest.approx(
        (13 * pixels + 4 * 64 * 1352 * 9 + 36 * 64) / 3.35e12)


# A point-light batch's split, a failed split, no split.
NO_STAGES = [{"split_ok": True, "runs": 2, "frames": 128, "bins": 1.0,
              "trace": 2.0, "shade": 6.5}, {"split_ok": False}, None]


@pytest.mark.parametrize("name", READERS)
def test_readers_without_their_inputs_return_nothing(name, monkeypatch):
    read = spec.metric_reader(name)
    # The program before dir_pixels, and a counter that counted nothing.
    for counters in (Counters(slab_tests=7, shade_pixels=10),
                     kernels.MarchCounters()):
        monkeypatch.setattr(shadow_cuda, "counters", counters)
        for stages in NO_STAGES:
            assert read(record(stages)) is None
    # A run that was not traced.
    monkeypatch.setattr(shadow_cuda, "counters", Counters(
        slab_tests=5000, dir_pixels=1000))
    assert read(record(None, traced=False)) is None
