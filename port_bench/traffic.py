"""The one traffic generator: reads a mix's parameters from
``traffic/<name>.json`` and makes its states from the seed.

Two kinds of mix:

* batches (``entry`` "batch"): ``prestaged_batches`` batches of
  ``frames_per_batch`` (player, light) states, cycled through by the run.
  The light orbits: frame n of the long sweep lies at angle ``phase + 2 pi
  n / period`` on a circle of ``radius`` around a centre (x + r cos, y, z
  + (r // 2) sin, truncated to int, as the JAX package's
  ``light_sweep_states``); batch b takes centre ``order[b % len]``, so
  every seed renders each centre alike, in another order and from
  another phase.  The player stays where the scene puts it (``fixed``) or
  walks, one key step a frame.
* requests (any other entry): an endless stream, each request
  ``keys_per_request`` key events drawn from ``keys`` and, with
  ``mouse``, a mouse position in the base view.

Keys are the reference's bindings (alternative.cpp:643-678): each moves
the player or the light 5 units along one axis.  A walk only draws keys
whose move keeps its target inside ``[low, high]``.  Coordinates in the
files are base-world units, multiplied by the configuration's
``supersample`` factor.
"""

from __future__ import annotations

import dataclasses

import numpy as np

KEY_STEP = 5
# Key -> (target, axis, sign).
BINDINGS = {
    "left": ("player", 0, -1), "right": ("player", 0, +1),
    "up": ("player", 2, +1), "down": ("player", 2, -1),
    "pagedown": ("player", 1, -1), "pageup": ("player", 1, +1),
    "a": ("light", 2, -1), "k": ("light", 2, +1),
    "j": ("light", 1, -1), "u": ("light", 1, +1),
    "h": ("light", 0, -1), "o": ("light", 0, +1),
}


def rng(seed: int, stream: int) -> np.random.Generator:
    """The generator of one of a run's streams: any whole seed, negative
    or past 64 bits included, gives its own sequence."""
    return np.random.default_rng([seed % 2 ** 64, stream])


def step(pos: np.ndarray, key: str) -> np.ndarray:
    _, axis, sign = BINDINGS[key]
    out = pos.copy()
    out[axis] += sign * KEY_STEP
    return out


def walk_key(r: np.random.Generator, keys, positions: dict, low, high):
    """A key among ``keys`` whose move keeps its target (``positions``
    by target name) inside ``[low[target], high[target]]``."""
    ok = []
    for k in keys:
        target, axis, sign = BINDINGS[k]
        v = int(positions[target][axis]) + sign * KEY_STEP
        if low[target][axis] <= v <= high[target][axis]:
            ok.append(k)
    return ok[int(r.integers(len(ok)))]


def batch_states(spec: dict, config: dict, seed: int, player0):
    """``(players, lights)``, (prestaged_batches, F, 3) int32 each, in
    traced-world units, from the scene's player position ``player0``
    (base-world units)."""
    s = config["supersample"]
    n, F = spec["prestaged_batches"], spec["frames_per_batch"]
    light = spec["light"]
    r = rng(seed, 0)
    centers = np.asarray(light["centers"], np.int64)
    order = r.permutation(len(centers))
    phase = r.uniform(0.0, 2.0 * np.pi)
    frame = np.arange(n * F).reshape(n, F)
    angle = phase + 2.0 * np.pi * frame / light["period"]
    c = centers[order[np.arange(n) % len(centers)]][:, None, :]
    radius = light["radius"]
    lights = np.stack([c[..., 0] + radius * np.cos(angle),
                       np.broadcast_to(c[..., 1], angle.shape),
                       c[..., 2] + (radius // 2) * np.sin(angle)], axis=-1)
    lights = (lights * s).astype(np.int32)

    player = spec["player"]
    players = np.empty((n * F, 3), np.int64)
    pos = np.asarray(player0, np.int64)
    if player["kind"] == "walk":
        low = {"player": np.asarray(player["low"])}
        high = {"player": np.asarray(player["high"])}
        pr = rng(seed, 1)
        for i in range(n * F):
            pos = step(pos, walk_key(pr, player["keys"], {"player": pos},
                                     low, high))
            players[i] = pos
    else:
        players[:] = pos
    return (players * s).astype(np.int32).reshape(n, F, 3), lights


@dataclasses.dataclass
class Request:
    keys: list[str]
    mouse: tuple[int, int] | None
    player: np.ndarray   # (3,) base-world units, after the keys
    light: np.ndarray    # (3,)


class Requests:
    """The endless request stream of a mix, from the seed and the scene's
    player position (base-world units)."""

    def __init__(self, spec: dict, config: dict, seed: int, player0):
        self.spec = spec
        self.width, self.height = config["view_width"], config["view_height"]
        self.rng = rng(seed, 2)
        self.positions = {"player": np.asarray(player0, np.int64),
                          "light": np.asarray(spec["light_start"], np.int64)}
        self.low = {t: np.asarray(spec.get(f"{t}_low", [-2 ** 31] * 3))
                    for t in ("player", "light")}
        self.high = {t: np.asarray(spec.get(f"{t}_high", [2 ** 31] * 3))
                     for t in ("player", "light")}

    def next(self) -> Request:
        lo, hi = self.spec["keys_per_request"]
        keys = []
        for _ in range(int(self.rng.integers(lo, hi + 1))):
            key = walk_key(self.rng, self.spec["keys"], self.positions,
                           self.low, self.high)
            target = BINDINGS[key][0]
            self.positions[target] = step(self.positions[target], key)
            keys.append(key)
        mouse = None
        if self.spec.get("mouse"):
            mouse = (int(self.rng.integers(self.width)),
                     int(self.rng.integers(self.height)))
        return Request(keys, mouse, self.positions["player"].copy(),
                       self.positions["light"].copy())
