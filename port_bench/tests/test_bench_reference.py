"""The plain reference against the program's plain path on small scenes,
and the control, which has to fail the comparison."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from pixel_art_raytracer_tpu_torch.models import batched
from pixel_art_raytracer_tpu_torch.models.deferred import (DeferredRenderer,
                                                           DeviceScene)
from pixel_art_raytracer_tpu_torch.models.supersample import (
    SupersampledRenderer)
from port_bench import harness, program, reference
from port_bench.tests.cells import CPU, run_small, small_cell


def states(n, seed):
    r = np.random.default_rng(seed)
    players = np.stack([r.integers(0, 100, n), r.integers(0, 60, n),
                        r.integers(0, 60, n)], 1).astype(np.int32)
    lights = np.stack([r.integers(-40, 160, n), r.integers(0, 120, n),
                       r.integers(-20, 120, n)], 1).astype(np.int32)
    return players, lights


@pytest.mark.parametrize("name", ["graybox.orbit64", "config5.sweep64"])
def test_reference_frames_equal_the_programs_plain_path(name):
    cell = small_cell(name)
    cfg = cell.config
    arrays = cell.scene()
    s = cfg["supersample"]
    players, lights = states(6, 5)
    players, lights = players * s, lights * s
    if s > 1:
        sr = SupersampledRenderer(program.render_config(cfg), s)
        ds = sr.prepare(program.scene(arrays), device=CPU)
        r = sr.renderer
    else:
        r = DeferredRenderer(program.render_config(cfg)).configure_for(
            program.scene(arrays))
        ds = DeviceScene.from_scene(program.scene(arrays),
                                    program.render_config(cfg), device=CPU)
    got = batched.render_states_batched(r, None, ds,
                                        torch.as_tensor(players),
                                        torch.as_tensor(lights))
    want = harness.reference_frames(
        harness.reference_scene(arrays, cfg, CPU), players, lights,
        harness.view(cfg), torch.float32)
    assert torch.equal(got, want)
    control = harness.reference_frames(
        harness.reference_scene(arrays, cfg, CPU), players, lights,
        harness.view(cfg), torch.bfloat16)
    assert (control != want).any(-1).sum() > 0


def test_reference_box_filter_is_the_truncated_block_mean():
    frame = torch.randint(0, 256, (8, 12, 3), dtype=torch.uint8)
    got = reference.box_filter(frame, 2)
    want = frame.double().reshape(4, 2, 6, 2, 3).mean((1, 3)).floor()
    assert torch.equal(got, want.to(torch.uint8))


@pytest.mark.parametrize("name", ["graybox.orbit64", "config5.sweep64",
                                  "graybox.live", "config5.still"])
def test_control_fails_and_the_program_passes(name):
    compared = run_small(name, seconds=2.0, control=torch.bfloat16)[3]
    assert compared["frames_compared"] >= 1
    assert compared["differing_pixels"] == 0
    assert compared["control_differing_pixels"] > 0
