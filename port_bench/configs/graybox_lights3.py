"""The reference's own world under several point lights: graybox's
scene, by ``configs/graybox.py``'s generator (loaded, not copied)."""

from __future__ import annotations

from port_bench import spec


def scene(config: dict) -> dict:
    return spec.load_module(spec.ROOT / "configs" / "graybox.py").scene(
        config)
