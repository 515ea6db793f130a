"""BASELINE config 5 as published: config 5's 10k-box scene, by
``configs/config5.py``'s generator (loaded, not copied)."""

from __future__ import annotations

from port_bench import spec


def scene(config: dict) -> dict:
    return spec.load_module(spec.ROOT / "configs" / "config5.py").scene(
        config)
