"""Checkpoint / resume for long animation renders.

Counterpart of ``pixel_art_raytracer_tpu/utils/checkpoint.py`` (numpy, on
the host).  The reference keeps all state in memory and loses it on exit.
Here animation renders checkpoint at frame-chunk granularity: each chunk of
rendered frames lands in an ``.npz`` beside a manifest, and a restarted
render resumes at the first missing chunk.
"""

from __future__ import annotations

import json
import pathlib

import numpy as np


class FrameCheckpointer:
    """Chunked frame store: ``<dir>/chunk_00003.npz`` + ``manifest.json``."""

    def __init__(self, directory, chunk_size: int = 16):
        self.dir = pathlib.Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.chunk_size = chunk_size
        self.manifest_path = self.dir / "manifest.json"

    def _chunk_path(self, idx: int) -> pathlib.Path:
        return self.dir / f"chunk_{idx:05d}.npz"

    def completed_chunks(self) -> int:
        """Number of leading chunks already on disk."""
        n = 0
        while self._chunk_path(n).exists():
            n += 1
        return n

    def resume_frame(self) -> int:
        """First frame index still to render."""
        return self.completed_chunks() * self.chunk_size

    def save_chunk(self, idx: int, frames: np.ndarray) -> None:
        tmp = self._chunk_path(idx).with_suffix(".tmp.npz")
        np.savez_compressed(tmp, frames=np.asarray(frames, np.uint8))
        tmp.rename(self._chunk_path(idx))
        self.manifest_path.write_text(json.dumps({
            "chunk_size": self.chunk_size,
            "chunks": self.completed_chunks(),
        }))

    def load_all(self) -> np.ndarray:
        chunks = [np.load(self._chunk_path(i))["frames"]
                  for i in range(self.completed_chunks())]
        if not chunks:
            return np.zeros((0,), np.uint8)
        return np.concatenate(chunks)


def render_with_checkpoints(render_chunk, n_frames: int, directory,
                            chunk_size: int = 16) -> np.ndarray:
    """Drive ``render_chunk(start, count) -> (count, H, W, 3)`` with resume.

    Skips the leading chunks already on disk, renders the rest, returns all
    frames.
    """
    ckpt = FrameCheckpointer(directory, chunk_size)
    start = ckpt.resume_frame()
    idx = ckpt.completed_chunks()
    while start < n_frames:
        count = min(chunk_size, n_frames - start)
        frames = np.asarray(render_chunk(start, count))
        ckpt.save_chunk(idx, frames)
        start += count
        idx += 1
    return ckpt.load_all()[:n_frames]
