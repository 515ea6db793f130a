"""A run with the timed path broken underneath comes out not correct:
the card check is skipped (the small cells run on the CPU), the rest of
the run is the benchmark's.  Faults: a step that returns its state
unchanged, half of a batch left out, and an answer altered where it is
produced.  No cell spans chips, so none can lose an exchange between
them."""

from __future__ import annotations

import torch

from pixel_art_raytracer_tpu_torch.models import animation, batched
from pixel_art_raytracer_tpu_torch.models.supersample import (
    SupersampledRenderer)
from pixel_art_raytracer_tpu_torch.runtime import session
from port_bench import run
from port_bench.tests.cells import CPU, run_small, small_cell

import pytest

BATCH = ["graybox.orbit64", "config5.sweep64"]
FRAMES = ["graybox.live", "config5.still"]


def correct(name):
    record, setup_s, peak, compared = run_small(name)
    return run.result(small_cell(name), record, setup_s, peak, compared,
                      CPU, 0)["correct"]


def altered(fn):
    """``fn`` with the first pixel of every frame it returns changed."""
    def wrapper(*args, **kw):
        frames = fn(*args, **kw).clone()
        frames[..., 0, 0, :] ^= 1
        return frames
    return wrapper


@pytest.mark.parametrize("name", BATCH + FRAMES)
def test_sound_run_is_correct(name):
    assert correct(name)


@pytest.mark.parametrize("name", BATCH + ["config5.still"])
def test_an_altered_answer_is_caught(monkeypatch, name):
    monkeypatch.setattr(batched, "shade_point_stage",
                        altered(batched.shade_point_stage))
    assert not correct(name)


def test_an_altered_session_frame_is_caught(monkeypatch):
    monkeypatch.setattr(batched, "shade_stage", altered(batched.shade_stage))
    assert not correct("graybox.live")


@pytest.mark.parametrize("name", BATCH)
def test_half_a_batch_left_out_is_caught(monkeypatch, name):
    real = animation.render_states_batched

    def half(renderer, cache, dscene, players, lights, **kw):
        h = players.shape[0] // 2
        frames = real(renderer, cache, dscene, players[:h], lights[:h], **kw)
        return torch.cat([frames, frames])

    monkeypatch.setattr(animation, "render_states_batched", half)
    assert not correct(name)


@pytest.mark.parametrize("name", BATCH)
def test_a_batch_that_keeps_its_first_state_is_caught(monkeypatch, name):
    real = animation.render_states_batched

    def stale(renderer, cache, dscene, players, lights, **kw):
        return real(renderer, cache, dscene, players[:1].expand_as(players),
                    lights[:1].expand_as(lights), **kw)

    monkeypatch.setattr(animation, "render_states_batched", stale)
    assert not correct(name)


def test_a_session_that_ignores_its_keys_is_caught(monkeypatch):
    monkeypatch.setattr(session, "apply_keys", lambda state, keys: state)
    assert not correct("graybox.live")


def test_a_still_that_keeps_its_light_is_caught(monkeypatch):
    real = SupersampledRenderer.render
    first = {}

    def stale(self, dscene, light):
        first.setdefault("light", light)
        return real(self, dscene, first["light"])

    monkeypatch.setattr(SupersampledRenderer, "render", stale)
    assert not correct("config5.still")
