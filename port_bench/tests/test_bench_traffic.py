"""The traffic generator: the same seed gives the same states, another
seed others, and every walk stays inside its bounds."""

from __future__ import annotations

import numpy as np
import pytest

from port_bench import traffic
from port_bench.tests.cells import full_cell

SEEDS = (7, 2 ** 31 + 11, 2 ** 40 + 3, -5)


def batch(cell, seed):
    c = full_cell(cell)
    return traffic.batch_states(dict(c.traffic, prestaged_batches=6),
                                c.config, seed, [240, 36, 80])


def requests(cell, seed, n=200):
    c = full_cell(cell)
    stream = traffic.Requests(c.traffic, c.config, seed, [240, 36, 80])
    return [stream.next() for _ in range(n)]


@pytest.mark.parametrize("cell", ["graybox.orbit64", "config5.sweep64"])
def test_batch_states_are_deterministic_per_seed(cell):
    for seed in SEEDS:
        a, b = batch(cell, seed), batch(cell, seed)
        assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert not np.array_equal(batch(cell, 1)[1], batch(cell, 2)[1])


@pytest.mark.parametrize("cell", ["graybox.live", "config5.still"])
def test_requests_are_deterministic_per_seed(cell):
    for seed in SEEDS:
        a, b = requests(cell, seed), requests(cell, seed)
        assert [r.keys for r in a] == [r.keys for r in b]
        assert [r.mouse for r in a] == [r.mouse for r in b]
    assert [r.keys for r in requests(cell, 1)] != \
        [r.keys for r in requests(cell, 2)]


def test_walks_stay_inside_their_bounds():
    c = full_cell("graybox.orbit64")
    players, _ = batch("graybox.orbit64", 3)
    p = c.traffic["player"]
    assert (players >= p["low"]).all() and (players <= p["high"]).all()
    for cell in ("graybox.live", "config5.still"):
        mix = full_cell(cell).traffic
        for r in requests(cell, 9, 2000):
            assert (r.light >= mix["light_low"]).all()
            assert (r.light <= mix["light_high"]).all()
            lo, hi = mix["keys_per_request"]
            assert lo <= len(r.keys) <= hi


def test_every_seed_renders_every_orbit_centre_alike():
    centres = np.asarray(full_cell("graybox.orbit64")
                         .traffic["light"]["centers"])
    for seed in (1, 2, 3):
        _, lights = batch("graybox.orbit64", seed)
        near = [[int(np.abs(b - c).max() <= 41) for c in centres]
                for b in lights]
        assert all(sum(n) == 1 for n in near)
        assert sorted(int(np.argmax(n)) for n in near[:3]) == [0, 1, 2]


def test_supersampled_states_are_in_traced_units():
    players, lights = batch("config5.sweep64", 4)
    assert (players == np.asarray([240, 36, 80]) * 2).all()
    assert abs(lights[..., 0].mean() - 1024) < 20
