"""Live terminal viewer: the reference's interactive window, on the card.

Counterpart of ``pixel_art_raytracer_tpu/runtime/viewer.py``.  The
reference presents through an SDL2 streaming texture driven by live
keyboard events (alternative.cpp:604-617, 628-687, 774-788).  This viewer
closes that capability gap without a display server: each frame renders on
the card (``DeferredRenderer.render_with_gbuffer``), is fetched to the host
and streams to the terminal as 24-bit-color half-block cells (two vertical
pixels per character, U+2580), and keys are read raw from stdin with the
reference's exact bindings — arrows / PageUp / PageDown move the player box
by 5, a/k/j/u/h/o move the light by 5, Escape quits
(alternative.cpp:643-678).

Run: ``python -m pixel_art_raytracer_tpu_torch.runtime.viewer
[--scene demo|graybox] [--scale N] [--frames N] [--bench]``.

The render/blit core is pure (``ansi_frame``) and the loop takes injectable
input/output hooks, so the viewer is testable headlessly.
"""

from __future__ import annotations

import sys
import time

import numpy as np

from ..config import DEFAULT_CONFIG, RenderConfig
from ..models.animation import apply_keys, scene_with_player
from ..models.deferred import DeferredRenderer, DeviceScene
from ..ops.overlay import draw_line_host
from ..scene import Light, Scene, default_light
from ..utils.metrics import profiler_trace
from . import tracing
from .session import host_state

# Escape-sequence suffix -> binding key (CSI arrows and page keys).
_CSI_KEYS = {
    "A": "up", "B": "down", "C": "right", "D": "left",
    "5~": "pageup", "6~": "pagedown",
}
_CHAR_KEYS = {c: c for c in "akjuho"}


def downscale(frame: np.ndarray, factor: int) -> np.ndarray:
    """Box-average (H, W, 3) uint8 by an integer factor."""
    if factor <= 1:
        return frame
    h, w = frame.shape[:2]
    h2, w2 = h // factor, w // factor
    f = frame[:h2 * factor, :w2 * factor].astype(np.uint32)
    f = f.reshape(h2, factor, w2, factor, 3).mean(axis=(1, 3))
    return f.astype(np.uint8)


def ansi_frame(frame: np.ndarray, scale: int = 1) -> str:
    """Render an (H, W, 3) uint8 frame as 24-bit half-block rows.

    Each text cell shows two vertically adjacent pixels: the upper one as
    the foreground of U+2580 (upper half block), the lower as background —
    the standard terminal pixel-doubling blit.
    """
    img = downscale(frame, scale)
    h, w = img.shape[:2]
    if h % 2:
        img = np.concatenate([img, np.zeros((1, w, 3), np.uint8)])
        h += 1
    top = img[0::2]
    bot = img[1::2]
    rows = []
    for y in range(h // 2):
        cells = []
        prev = None
        for x in range(w):
            tr, tg, tb = (int(v) for v in top[y, x])
            br, bg_, bb = (int(v) for v in bot[y, x])
            code = (tr, tg, tb, br, bg_, bb)
            if code != prev:
                cells.append(f"\x1b[38;2;{tr};{tg};{tb}m"
                             f"\x1b[48;2;{br};{bg_};{bb}m")
                prev = code
            cells.append("▀")
        cells.append("\x1b[0m")
        rows.append("".join(cells))
    return "\n".join(rows)


def decode_events(raw: str
                  ) -> tuple[list[str], tuple[int, int] | None, bool, str]:
    """Translate raw stdin bytes into binding keys and mouse motion.

    Returns (keys, mouse, quit, rest): ``mouse`` is the LAST reported
    cursor cell as 0-based (col, row) — from xterm SGR mouse sequences
    ``ESC [ < b ; x ; y (M|m)`` (any-motion tracking, enabled by the tty
    hooks) — or None when the chunk carried no mouse event, mirroring the
    reference's SDL_MOUSEMOTION handling (alternative.cpp:683-685).
    ``rest`` is a trailing *incomplete* escape sequence (reads can split
    sequences mid-byte; the caller buffers it into the next chunk).  'q',
    or Escape followed by a non-CSI byte, quits — mirroring the reference's
    SDLK_ESCAPE (alternative.cpp:634-641).  A bare trailing Escape stays in
    ``rest``; the loop promotes it to quit when no continuation bytes
    arrive by the next cycle.
    """
    keys: list[str] = []
    mouse: tuple[int, int] | None = None
    i = 0
    quit_ = False
    n = len(raw)
    while i < n:
        c = raw[i]
        if c == "\x1b":
            if i + 1 == n:
                return keys, mouse, quit_, "\x1b"  # maybe a split sequence
            if raw[i + 1] == "[":
                if raw[i + 2:i + 3] == "<":
                    # SGR mouse report: ESC [ < b ; x ; y (M|m).
                    j = i + 3
                    while j < n and raw[j] not in "Mm":
                        j += 1
                    if j == n:
                        return keys, mouse, quit_, raw[i:]  # split report
                    parts = raw[i + 3:j].split(";")
                    if len(parts) == 3:
                        try:
                            x, y = int(parts[1]) - 1, int(parts[2]) - 1
                            mouse = (max(0, x), max(0, y))
                        except ValueError:
                            pass
                    i = j + 1
                    continue
                rest = raw[i + 2:i + 5]
                if rest[:1] in _CSI_KEYS:
                    keys.append(_CSI_KEYS[rest[:1]])
                    i += 3
                    continue
                if rest[:2] in _CSI_KEYS:
                    keys.append(_CSI_KEYS[rest[:2]])
                    i += 4
                    continue
                if i + 2 >= n or (i + 3 >= n and raw[i + 2] in "56"):
                    return keys, mouse, quit_, raw[i:]  # split mid-CSI
                i += 3
                continue
            quit_ = True
            i += 1
            continue
        if c == "q":
            quit_ = True
        elif c in _CHAR_KEYS:
            keys.append(_CHAR_KEYS[c])
        i += 1
    return keys, mouse, quit_, ""


def decode_keys(raw: str) -> tuple[list[str], bool, str]:
    """Key-only view of :func:`decode_events` (mouse reports dropped)."""
    keys, _, quit_, rest = decode_events(raw)
    return keys, quit_, rest


class LiveViewer:
    """Interactive device-loop -> terminal presentation, rendered on
    ``device`` (default: the card).

    ``input_fn() -> str`` returns any pending raw stdin bytes (non-
    blocking); ``output_fn(text)`` writes to the terminal.  Both are
    injectable for tests; defaults wire to the real tty.
    """

    def __init__(self, scene: Scene, light: Light | None = None,
                 config: RenderConfig = DEFAULT_CONFIG,
                 renderer: DeferredRenderer | None = None,
                 scale: int | None = None, *, device=None):
        self.config = config
        self.renderer = renderer or DeferredRenderer(config)
        self.renderer.configure_for(scene)
        self.dscene = DeviceScene.from_scene(scene, config, device=device)
        light = light or default_light(config)
        self.state = host_state(scene.pos[0], light.as_array())
        if scale is None:
            scale = max(1, config.view_width // 160)
        self.scale = scale
        self.frame_count = 0
        self.mouse = (0, 0)          # cursor in frame pixels
        self.mouse_pixel = (0, 0)    # hovered pixel's world (y, z) readout
        self._pending = ""   # split escape-sequence bytes between reads

    def render_current(self) -> np.ndarray:
        d = scene_with_player(self.dscene, self.state.player_pos)
        return self.renderer.render(d, self.state.light).cpu().numpy()

    def _render_with_overlay(self) -> np.ndarray:
        """Render + the reference's per-frame debug overlay: red Bresenham
        line from the hovered pixel's reconstructed surface point to the
        light (alternative.cpp:762-772), and the hovered pixel's world y/z
        readout (alternative.cpp:698-700) into ``self.mouse_pixel``."""
        cfg = self.config
        with tracing.span("frame"):
            d = scene_with_player(self.dscene, self.state.player_pos)
            gbuf, frame = self.renderer.render_with_gbuffer(d,
                                                            self.state.light)
            with tracing.span("sync.fetch"):
                host = frame.cpu()
            mx = min(max(self.mouse[0], 0), cfg.view_width - 1)
            my = min(max(self.mouse[1], 0), cfg.view_height - 1)
            # Fetch only the hovered texel of the G-buffer: two scalars.
            with tracing.span("sync.readback"):
                mp_y = int(gbuf.y[my, mx])
                mp_z = int(gbuf.z[my, mx])
            self.mouse_pixel = (mp_y, mp_z)
            with tracing.span("frame.overlay"):
                image = host.numpy().copy()
                lx, ly, lz = self.state.light.tolist()
                draw_line_host(image, mx, cfg.view_height - (mp_y + mp_z),
                               lx, cfg.view_height - (ly + lz), (255, 0, 0))
            return image

    def step(self, raw_input_chunk: str) -> tuple[str, bool]:
        """One loop iteration: apply events, render, return (blit, quit)."""
        keys, mouse, quit_, rest = decode_events(
            self._pending + raw_input_chunk)
        if rest == "\x1b" and raw_input_chunk == "" and self._pending:
            quit_ = True       # a held bare Escape with no continuation
            rest = ""
        self._pending = rest
        if keys:
            self.state = apply_keys(self.state, keys)
        if mouse is not None:
            # Terminal cell -> frame pixel: each cell is scale columns wide
            # and 2*scale rows tall (half-block doubling).
            self.mouse = (mouse[0] * self.scale, mouse[1] * 2 * self.scale)
        frame = self._render_with_overlay()
        self.frame_count += 1
        return ansi_frame(frame, self.scale), quit_

    def run(self, input_fn=None, output_fn=None,
            max_frames: int | None = None) -> int:
        """The live loop.  Returns the number of frames presented."""
        if input_fn is None or output_fn is None:
            real_in, real_out, restore = _tty_hooks()
            input_fn = input_fn or real_in
            output_fn = output_fn or real_out
        else:
            restore = lambda: None  # noqa: E731
        try:
            output_fn("\x1b[2J")                  # clear once
            last = time.perf_counter()
            while max_frames is None or self.frame_count < max_frames:
                blit, quit_ = self.step(input_fn())
                now = time.perf_counter()
                ms = (now - last) * 1000.0
                last = now
                mp_y, mp_z = self.mouse_pixel
                output_fn("\x1b[H" + blit +
                          f"\x1b[0m\n{ms:6.1f} ms/frame  "
                          f"pixel <{mp_y}, {mp_z}>  "
                          "(arrows/PgUp/PgDn: player, akjuho: light, "
                          "mouse: inspect, Esc: quit)\n")
                if quit_:
                    break
        finally:
            restore()
        return self.frame_count


def _tty_hooks():
    """Raw non-blocking stdin + stdout writer; returns (in, out, restore)."""
    import select
    import termios
    import tty

    fd = sys.stdin.fileno()
    old = termios.tcgetattr(fd)
    tty.setcbreak(fd)
    # Any-motion mouse tracking in SGR encoding (the live equivalent of the
    # reference's SDL_MOUSEMOTION stream, alternative.cpp:683-685).
    sys.stdout.write("\x1b[?1003h\x1b[?1006h")
    sys.stdout.flush()

    def read_pending() -> str:
        # os.read on the raw fd: sys.stdin.read would pull bytes into
        # Python's buffer where select can no longer see them, stranding
        # the tail of an escape sequence until the next keypress.
        import os

        chunks = []
        while select.select([fd], [], [], 0.0)[0]:
            data = os.read(fd, 1024)
            if not data:
                break
            chunks.append(data.decode("utf-8", "replace"))
        return "".join(chunks)

    def write(text: str) -> None:
        sys.stdout.write(text)
        sys.stdout.flush()

    def restore() -> None:
        sys.stdout.write("\x1b[?1003l\x1b[?1006l")
        sys.stdout.flush()
        termios.tcsetattr(fd, termios.TCSADRAIN, old)

    return read_pending, write, restore


# The --bench key script: light and player moves, one a frame, cycled.
BENCH_SCRIPT = ["h", "o", "\x1b[D", "\x1b[C", "u", "j",
                "\x1b[A", "\x1b[B", "k", "a"]


def bench_loop(viewer: LiveViewer, n_frames: int = 100):
    """Drive the FULL live loop — input decode, per-frame render +
    overlay, frame fetch, ANSI blit build — for ``n_frames`` frames with
    :data:`BENCH_SCRIPT` as input and the output discarded.

    Returns ``(frames, steps, wall)``: the frames presented, the seconds
    between consecutive input reads (one a presented frame, the first
    frame's dropped) and the wall seconds of the whole run.
    """
    times = []
    idx = [0]
    last = [None]

    def timed_input() -> str:
        now = time.perf_counter()
        if last[0] is not None:
            times.append(now - last[0])
        last[0] = now
        key = BENCH_SCRIPT[idx[0] % len(BENCH_SCRIPT)]
        idx[0] += 1
        return key

    t_wall = time.perf_counter()
    n = viewer.run(input_fn=timed_input, output_fn=lambda text: None,
                   max_frames=n_frames)
    return n, times[1:], time.perf_counter() - t_wall


def main(argv=None) -> None:
    import argparse

    from ..scene import demo_world, graybox_world

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--scene", choices=["demo", "graybox"], default="demo")
    ap.add_argument("--scale", type=int, default=None)
    ap.add_argument("--frames", type=int, default=None,
                    help="stop after N frames (default: run until Esc)")
    ap.add_argument("--bench", action="store_true",
                    help="scripted-input timing run (no tty): drives the "
                         "FULL live loop — input decode, per-frame render "
                         "+ overlay, frame fetch, ANSI blit build — with "
                         "a cycling key script and reports per-frame ms "
                         "(the reference's own frame-time print, "
                         "alternative.cpp:815-817)")
    ap.add_argument("--profile", metavar="DIR", default=None,
                    help="record the loop with torch.profiler and write "
                         "a Chrome trace to DIR/trace.json: the program's "
                         "spans (frame, batch, batch.<stage>, sync.*) on "
                         "the kernels' clock")
    args = ap.parse_args(argv)

    scene = graybox_world() if args.scene == "graybox" else demo_world(10)
    viewer = LiveViewer(scene, scale=args.scale)
    if args.bench:
        # The reference is an *interactive* renderer: this measures the
        # per-presented-frame latency of the live loop, including the
        # per-frame launches and the frame fetch to the host.
        with profiler_trace(args.profile):
            n, steps, t_wall = bench_loop(viewer, args.frames or 100)
        steps = sorted(steps)
        if steps:
            med = steps[len(steps) // 2] * 1e3
            best = steps[0] * 1e3
            print(f"\ninteractive loop: {n} frames, median "
                  f"{med:.1f} ms/frame (best {best:.1f}, "
                  f"{1e3 / med:.1f} fps), wall {t_wall:.1f}s "
                  f"(incl. the kernels' first build)")
        return
    with profiler_trace(args.profile):
        n = viewer.run(max_frames=args.frames)
    print(f"\npresented {n} frames")


if __name__ == "__main__":
    main()
