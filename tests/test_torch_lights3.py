"""The reference world under several point lights
(``port_bench/configs/graybox_lights3``): (F, L, 3) lights in the reference
style take kernel 2's multi-light mode from the winners
(``batched.shade_lights_stage``; on the CPU its plain version
``shade.light_frames``).  On a small graybox world (64x48x64) its frames
equal the G-buffer route's (``multi_light_stage``) and the benchmark's plain
reference (``port_bench/reference/lights.py``) bit for bit at L = 1, 2, 3
and 5, with the lights' order swapped, a light inside a box and a light on
a surface point (NaN directions); at L = 1 they equal the single-light
path's.  The configuration is graybox's with three lights, the mix
orbit64's with one orbit a light; the small cell through ``harness.run``
is correct, with and without the traced split, its bfloat16 control is
not, and altered frames are caught; its readers read their numbers and
nothing without their inputs.  The CUDA cases (skipped without a card)
hold the kernel to the plain version and count one launch a batch.
"""

from __future__ import annotations

import json
import time

import numpy as np
import pytest
import torch

from pixel_art_raytracer_tpu_torch.models import batched
from pixel_art_raytracer_tpu_torch.models.animation import AnimationRenderer
from pixel_art_raytracer_tpu_torch.models.deferred import (DeferredRenderer,
                                                           DeviceScene)
from pixel_art_raytracer_tpu_torch.ops import shade, shadow_cuda, trace
from pixel_art_raytracer_tpu_torch.ops.static_bins import StaticBins
from pixel_art_raytracer_tpu_torch.runtime import kernels
from port_bench import bounds_lights, harness, program, run, spec
from port_bench.reference import lights as reference_lights
from port_bench.tests.cells import CPU, small_cell

CELL = "graybox_lights3.orbit3x64"
SMALL = {"view_width": 64, "view_height": 48, "view_length": 64}
# Lights in and around the small view, one orbit centre each.
CENTERS = [[40, 30, 20], [10, 30, 20], [40, 30, 50]]
ORDINARY = [[50, 40, 20], [10, 45, 10], [40, 30, 50], [20, 60, 30],
            [60, 25, 5]]
# Inside a box of the right wall, (44, 20, 0) to (64, 40, 20).
INSIDE_BOX = [50, 30, 10]
CASES = ("L1", "L2", "L3", "L5", "swapped", "inside_box", "on_surface")
FRAMES = 2


@pytest.fixture(autouse=True)
def one_thread():
    """One PyTorch thread a test: the suite runs in several worker
    processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def config(name):
    return json.loads((spec.ROOT / "configs" / f"{name}.json").read_text())


def small_config():
    return dict(config("graybox_lights3"), **SMALL)


class World:
    """The small graybox world on ``device``, as the benchmark hands it to
    the program and to the reference."""

    def __init__(self, device="cpu"):
        cfg = small_config()
        self.arrays = spec.load_module(
            spec.ROOT / "configs" / "graybox_lights3.py").scene(cfg)
        self.rcfg = program.render_config(cfg)
        scene = program.scene(self.arrays)
        self.renderer = DeferredRenderer(self.rcfg).configure_for(scene)
        self.cache = StaticBins(scene.pos, scene.ext, 1, self.rcfg,
                                self.renderer.spans, device=device)
        self.anim = AnimationRenderer(self.renderer, self.rcfg,
                                      static_bins=self.cache)
        self.ds = DeviceScene.from_scene(scene, self.rcfg, device=device)
        self.ref_scene = harness.reference_scene(self.arrays, cfg, device)
        self.view = harness.view(cfg)
        self.players = torch.tensor([[32, 36, 16], [27, 31, 21]],
                                    dtype=torch.int32, device=device)

    def surface_point(self, f):
        """The surface point of frame f's middle hit pixel."""
        be, cnt = batched.bin_stage(self.renderer, self.cache, self.ds,
                                    self.players)
        win = batched.winner_stage(self.renderer, self.ds, be, cnt,
                                   self.players)
        y, z, _, _ = trace.decode_winner(win, self.ds.pos, self.ds.ext,
                                         self.ds.sprite_id,
                                         self.ds.atlas_depth, self.players,
                                         self.rcfg)
        hit = torch.nonzero(win[f] >= 0)
        j, i = (int(v) for v in hit[len(hit) // 2])
        return [i, int(y[f, j, i]), int(z[f, j, i])]

    def lights(self, case):
        """(F, L, 3) int32 lights of one case."""
        rows = {"L1": ORDINARY[:1], "L2": ORDINARY[:2], "L3": ORDINARY[:3],
                "L5": ORDINARY, "swapped": ORDINARY[2::-1],
                "inside_box": [ORDINARY[0], INSIDE_BOX, ORDINARY[1]]}
        if case == "on_surface":
            per_frame = [[ORDINARY[1], self.surface_point(f), ORDINARY[0]]
                         for f in range(FRAMES)]
        else:
            per_frame = [[[x + 3 * f, y, z] for x, y, z in rows[case]]
                         for f in range(FRAMES)]
        return torch.tensor(per_frame, dtype=torch.int32,
                            device=self.players.device)


@pytest.fixture(scope="module")
def world():
    return World()


@pytest.mark.parametrize("case", CASES)
def test_frames_equal_the_gbuffer_route_and_the_reference(world, case,
                                                          monkeypatch):
    lights = world.lights(case)
    calls = []
    real = shadow_cuda.shade_lights
    monkeypatch.setattr(shadow_cuda, "shade_lights",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    got = world.anim.render_states(world.ds, world.players, lights)
    assert calls == [1]
    want = batched.gbuffer_and_frames(world.renderer, world.cache, world.ds,
                                      world.players, lights)[1]
    assert torch.equal(got, want)
    ref = reference_lights.render_frames(world.ref_scene, world.players,
                                         lights, world.view)
    assert torch.equal(got, ref)
    assert int((got != torch.tensor([127, 127, 127], dtype=torch.uint8)
                ).any(-1).sum()) > 0


def test_one_light_equals_the_single_light_path(world):
    lights = world.lights("L1")
    got = world.anim.render_states(world.ds, world.players, lights)
    assert torch.equal(got, world.anim.render_states(
        world.ds, world.players, lights[:, 0].contiguous()))


def test_routes_and_refusals(world):
    r = world.renderer
    lights = world.lights("L3")
    assert batched.winner_inputs(r, lights, False)
    assert not batched.winner_inputs(r, lights[:, :0], False)
    with pytest.raises(ValueError):
        shadow_cuda.shade_lights(*([None] * 11), lights[:, :0], r.config)


def test_config_is_graybox_with_three_lights():
    got, base = config("graybox_lights3"), config("graybox")
    differ = {k for k in got.keys() | base.keys() if got.get(k) != base.get(k)}
    assert differ == {"lights", "source", "deployment", "assumed"}
    assert got["lights"] == 3 and got["reduced"] == {}
    assert "light_placement" in got["assumed"]
    small = dict(got, **SMALL)
    a = spec.load_module(spec.ROOT / "configs" / "graybox_lights3.py").scene(
        small)
    b = spec.load_module(spec.ROOT / "configs" / "graybox.py").scene(small)
    assert a.keys() == b.keys()
    assert all(np.array_equal(a[k], b[k]) for k in a)


def test_mix_is_orbit64_with_an_orbit_a_light():
    read = lambda n: json.loads(  # noqa: E731
        (spec.ROOT / "traffic" / f"{n}.json").read_text())
    got, base = read("orbit3x64"), read("orbit64")
    assert {k for k in got if got[k] != base[k]} == {"why", "entry", "light"}
    assert got["entry"] == "lights"
    assert {k: v for k, v in got["light"].items() if k != "kind"} == \
        {k: v for k, v in base["light"].items() if k != "kind"}


def orbit_lights(seed, **mix):
    c = spec.load_cell(CELL)
    entry = c.entry()
    return entry.orbit_lights(dict(c.traffic, prestaged_batches=4, **mix),
                              c.config, seed)


def test_each_light_orbits_its_own_centre_from_its_own_phase():
    for seed in (7, 2 ** 31 + 11, 2 ** 40 + 3, -5):
        lights = orbit_lights(seed)
        assert lights.shape == (4, 64, 3, 3) and lights.dtype == np.int32
        assert np.array_equal(lights, orbit_lights(seed))
        centres = np.asarray(spec.load_cell(CELL).traffic["light"]
                             ["centers"])
        off = lights - centres[None, None]
        assert (np.abs(off[..., 0]) <= 40).all()
        assert (off[..., 1] == 0).all() and (np.abs(off[..., 2]) <= 20).all()
        # Each light its own phase: the first frame's angles differ.
        first = np.arctan2(off[0, 0, :, 2] / 20, off[0, 0, :, 0] / 40)
        assert len(set(np.round(first, 1))) == 3
    assert not np.array_equal(orbit_lights(1), orbit_lights(2))
    with pytest.raises(ValueError):
        orbit_lights(1, light={"centers": [[0, 0, 0]], "radius": 40,
                               "period": 256})


def cell():
    c = small_cell(CELL, frames_per_batch=2, prestaged_batches=2,
                   sample_frames=8, light={"kind": "orbits",
                                           "centers": CENTERS,
                                           "radius": 10, "period": 256})
    c.config.update(SMALL)
    return c


# The window's seconds: a batch takes ~0.05 s here alone and several times
# that beside the suite's other workers; the run has to complete at least
# four batches (8 frames) for the sample to fill.
WINDOW_S = 2.0


def run_cell(trace: bool, control=None):
    c = cell()
    record, setup_s, peak, compared = harness.run(
        c, 2 ** 31 + 777, WINDOW_S, trace, CPU, time.perf_counter(),
        control)
    return record, compared, run.result(c, record, setup_s, peak, compared,
                                        CPU, int(trace))


@pytest.mark.parametrize("trace", [False, True])
def test_small_cell_run_is_correct(trace, monkeypatch):
    monkeypatch.setattr(harness, "STAGE_RUNS", 2)
    record, compared, out = run_cell(
        trace, None if trace else torch.bfloat16)
    assert out["correct"] is True
    assert out["compared"]["frames_compared"]["value"] == 8
    assert record.shapes["lights"] == 3
    if trace:
        assert record.stages["split_ok"]
        assert set(record.stages) >= {"bins", "trace", "lights"}
        assert "lights_roofline.batch" in out["metrics"]
    else:
        assert set(out["metrics"]) == {"setup_s", "mrays_per_s"}
        assert compared["control_differing_pixels"] > 0


def test_altered_frames_are_caught(monkeypatch):
    real = batched.shade_lights_stage

    def altered(*args, **kw):
        frames = real(*args, **kw).clone()
        frames[..., :2, :2, :] ^= 4
        return frames

    monkeypatch.setattr(batched, "shade_lights_stage", altered)
    assert run_cell(False)[2]["correct"] is False


def record(stages, shapes, traced=True):
    return harness.RunRecord(CELL, 3, 12, 1.0, [], 100, shapes,
                             object() if traced else None, 0, stages)


BATCH = {"frames": 64, "height": 320, "width": 480, "volume": 768,
         "capacity": 8, "lights": 3}
STAGES = {"split_ok": True, "runs": 2, "frames": 128, "bins": 0.2,
          "trace": 0.3, "lights": 2.6}
ROOFLINE = spec.metric_reader("lights_roofline.batch")
SLAB = spec.metric_reader("lights_slab_tests_per_pixel.batch")


def test_roofline_reader_reads_its_number():
    pixels = 64 * 320 * 480
    n_bytes = 7 * pixels + 4 * 64 * 768 * 9 + 12 * 64 + 36 * 64
    bound = max(n_bytes / 3.35e12, (26 + 3 * 26 + 8) * pixels / 67e12)
    assert bounds_lights.lights_bound_s(64, 320, 480, 768, 8, 3) == \
        pytest.approx(bound)
    assert ROOFLINE(record(STAGES, BATCH)) == pytest.approx(
        100 * bound * 2 / 2.6e-3)


@pytest.mark.parametrize("case", ["no split", "failed split", "no stage",
                                  "no lights"])
def test_roofline_reader_without_its_inputs_returns_nothing(case):
    stages, shapes = STAGES, BATCH
    if case == "no split":
        stages = None
    elif case == "failed split":
        stages = {"split_ok": False}
    elif case == "no stage":  # the batch entry's split
        stages = {k: v for k, v in STAGES.items() if k != "lights"}
    else:
        shapes = {k: v for k, v in BATCH.items() if k != "lights"}
    assert ROOFLINE(record(stages, shapes)) is None


def test_slab_reader_reads_the_counted_tests_a_pixel_light(monkeypatch):
    c = kernels.MarchCounters()
    c.work(torch.device("cpu"))[4] += 900
    c.light_pixels += 150
    monkeypatch.setattr(shadow_cuda, "counters", c)
    assert SLAB(record(None, BATCH)) == pytest.approx(6.0)
    assert SLAB(record(None, BATCH, traced=False)) is None


class ParentCounters:
    """A program's counters without the multi-light mode's keys."""

    def read(self):
        return {"shade_slab_tests": 600, "shade_pixels": 24}


@pytest.mark.parametrize("counters", ["none counted", "no such keys",
                                      "no counters"])
def test_slab_reader_without_its_counter_returns_nothing(counters,
                                                         monkeypatch):
    if counters == "none counted":
        monkeypatch.setattr(shadow_cuda, "counters", kernels.MarchCounters())
    elif counters == "no such keys":
        monkeypatch.setattr(shadow_cuda, "counters", ParentCounters())
    else:
        monkeypatch.delattr(shadow_cuda, "counters")
    assert SLAB(record(None, BATCH)) is None


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES)
def test_cuda_kernel_equals_the_plain_version(cuda, case):
    w = World(cuda)
    lights = w.lights(case)
    be, cnt = batched.bin_stage(w.renderer, w.cache, w.ds, w.players)
    win = batched.winner_stage(w.renderer, w.ds, be, cnt, w.players)
    args = (win, w.ds.pos, w.ds.ext, w.ds.sprite_id, w.ds.atlas_color,
            w.ds.atlas_depth, w.ds.atlas_normal, w.ds.palette, be, cnt,
            w.players, lights, w.rcfg)
    got = shadow_cuda.shade_lights(*args)
    assert torch.equal(got, shade.light_frames(*args))
    assert torch.equal(got, reference_lights.render_frames(
        w.ref_scene, w.players, lights, w.view))


@pytest.mark.cuda
def test_cuda_batch_is_one_launch_of_the_kernel(cuda):
    w = World(cuda)
    lights = w.lights("L3")
    before = (shadow_cuda.light_launches, shadow_cuda.launches,
              shadow_cuda.shade_launches)
    got = w.anim.render_states(w.ds, w.players, lights)
    assert (shadow_cuda.light_launches - before[0],
            shadow_cuda.launches - before[1],
            shadow_cuda.shade_launches - before[2]) == (1, 0, 0)
    host = World()
    assert torch.equal(got.cpu(), host.anim.render_states(
        host.ds, w.players.cpu(), lights.cpu()))
