"""The port's interactive runtime against the JAX package's, on identical
state: the per-frame G-buffer path (``DeferredRenderer.render_with_gbuffer``
and its stages), ``Session``, ``LiveViewer``, the terminal blit and input
decoder, and both line rasterisers.

Bit-exact everywhere: images with their overlay, G-buffer fields, mouse
readouts, ``debug_report`` strings, ``normal_view`` images (background
pixels included), blit strings and GIF bytes."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from pixel_art_raytracer_tpu import oracle
from pixel_art_raytracer_tpu.config import RenderConfig
from pixel_art_raytracer_tpu.models import deferred as jdeferred
from pixel_art_raytracer_tpu.ops import overlay as joverlay
from pixel_art_raytracer_tpu.runtime import session as jsession
from pixel_art_raytracer_tpu.runtime import viewer as jviewer
from pixel_art_raytracer_tpu.scene import Light, SceneBuilder
from pixel_art_raytracer_tpu_torch.models.deferred import (DeferredRenderer,
                                                           DeviceScene)
from pixel_art_raytracer_tpu_torch.ops import overlay
from pixel_art_raytracer_tpu_torch.runtime import session, viewer

SMALL = RenderConfig(view_width=80, view_height=80, view_length=80)
LIGHT = Light(60, 60, 20)
# A light far above the view: the overlay line's far end is ~600 rows off
# the top of the frame.
FAR_LIGHT = Light(150, 600, 40)
# One frame's events each: every binding, mouse positions inside the frame,
# on its edges and corners and outside it, and Escape (the frame after it
# is not rendered).
SCRIPT = [
    ([], (10, 70)),
    (["left", "right", "right"], (0, 0)),
    (["up", "pagedown"], (79, 79)),
    (["down", "pageup", "a"], (-7, 40)),
    (["k", "j", "j"], (95, 30)),
    (["u", "h"], (40, -12)),
    (["o", "o", "left"], (123, 140)),
    ([], None),
    (["escape", "h"], (33, 79)),
    (["right"], (5, 5)),
]


@pytest.fixture(autouse=True)
def one_thread():
    """One PyTorch thread a test: the suite runs in several worker
    processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def small_scene(config=SMALL):
    """tests/test_models.py:19-26."""
    b = SceneBuilder(config=config)
    b.insert((30, 20, 20), (20, 20, 20))
    for i in range(3):
        for j in range(3):
            b.insert((i * 24, 0, j * 24), (16, 16, 16))
    return b.build()


@pytest.fixture(scope="module")
def jax_renderer():
    """The JAX renderer as its CPU tests run it; one instance for the
    module, so its jitted frame compiles once."""
    return jdeferred.DeferredRenderer(SMALL, shadow_max_steps=8,
                                      trace_impl="jnp", shadow_impl="scan")


def run_script(s, script):
    """Feed ``script`` frame by frame until Escape stops the session."""
    records = []
    for keys, mouse in script:
        if not s.running:
            break
        records.append(s.feed(keys, mouse))
    return records


@pytest.mark.parametrize("fuse", [False, True], ids=["two_kernel", "fused"])
def test_render_with_gbuffer_matches_jax(jax_renderer, fuse):
    scene = small_scene()
    ds = DeviceScene.from_scene(scene, SMALL, device="cpu")
    r = DeferredRenderer(SMALL).configure_for(scene)
    r.fuse_trace_shadow = fuse
    light = LIGHT.as_array()
    gbuf, frame = r.render_with_gbuffer(ds, light)
    jax_renderer.spans = jax_renderer.spans_for(scene)
    jgbuf, jframe = jax_renderer.render_with_gbuffer(
        jdeferred.DeviceScene.from_scene(scene, SMALL), jnp.asarray(light))
    for name in gbuf._fields:
        np.testing.assert_array_equal(getattr(gbuf, name).numpy(),
                                      np.asarray(getattr(jgbuf, name)),
                                      err_msg=name)
    np.testing.assert_array_equal(frame.numpy(), np.asarray(jframe))
    assert torch.equal(r.render(ds, light), frame)
    # The stages one by one give the same G-buffer and frame.
    bins_ent, counts = r.build_bins(ds)
    assert bins_ent.shape == (SMALL.hash_volume, SMALL.bin_capacity)
    staged = r.trace(ds, bins_ent, counts)
    for name in gbuf._fields:
        assert torch.equal(getattr(staged, name), getattr(gbuf, name)), name
    assert torch.equal(r.shade(ds, staged, bins_ent, counts, light), frame)


@pytest.mark.parametrize("light", [LIGHT, FAR_LIGHT], ids=["near", "far"])
def test_session_matches_jax(jax_renderer, light, tmp_path):
    scene = small_scene()
    s = session.Session(scene, light, SMALL, device="cpu")
    js = jsession.Session(scene, light, SMALL, renderer=jax_renderer)
    got, want = run_script(s, SCRIPT), run_script(js, SCRIPT)
    assert len(got) == len(want) == 9 and not s.running and not js.running
    for k, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(g.image, w.image, err_msg=f"frame {k}")
        assert (g.mouse_pixel_y, g.mouse_pixel_z) == (
            w.mouse_pixel_y, w.mouse_pixel_z), k
    assert any((r.image == (255, 0, 0)).all(-1).any() for r in got)
    np.testing.assert_array_equal(s.state.player_pos.numpy(),
                                  np.asarray(js.state.player_pos))
    np.testing.assert_array_equal(s.state.light.numpy(),
                                  np.asarray(js.state.light))
    assert s.debug_report() == js.debug_report()
    normals = s.normal_view()
    np.testing.assert_array_equal(normals, js.normal_view())
    assert (normals.reshape(-1, 3) == (63, 127, 63)).all(-1).any()
    assert s.save_gif(tmp_path / "port.gif") == "native"
    js.save_gif(tmp_path / "jax.gif")
    assert ((tmp_path / "port.gif").read_bytes()
            == (tmp_path / "jax.gif").read_bytes())


def test_session_line_starts_at_the_unclamped_cursor(jax_renderer):
    """The Session's line starts at the unclamped cursor x; the viewer's
    at the clamped one (both as in the JAX package)."""
    scene = small_scene()
    s = session.Session(scene, LIGHT, SMALL, device="cpu")
    v = viewer.LiveViewer(scene, LIGHT, SMALL, scale=1, device="cpu")
    v.mouse = (-30, 40)
    red_s = (s.feed([], (-30, 40)).image == (255, 0, 0)).all(-1)
    red_v = (v._render_with_overlay() == (255, 0, 0)).all(-1)
    assert red_s.any() and red_v.any() and (red_s != red_v).any()


# -- the live viewer ---------------------------------------------------------

# Raw stdin chunks: keys, SGR mouse reports (one split across chunks), a CSI
# sequence split after its "[", a page key, and a bare Escape that a
# following empty read promotes to quit.
CHUNKS = ["", "h", "\x1b[<35;20;10M", "\x1b[", "D", "ao\x1b[<35;4", ";9M",
          "\x1b[5~", "\x1b[<0;200;3m\x1b[B", "\x1b", ""]


@pytest.mark.parametrize("scale", [1, 2])
def test_live_viewer_steps_match_jax(jax_renderer, scale):
    scene = small_scene()
    v = viewer.LiveViewer(scene, LIGHT, SMALL, scale=scale, device="cpu")
    jv = jviewer.LiveViewer(scene, LIGHT, SMALL, renderer=jax_renderer,
                            scale=scale)
    quits = []
    for k, chunk in enumerate(CHUNKS):
        blit, quit_ = v.step(chunk)
        jblit, jquit = jv.step(chunk)
        assert blit == jblit, f"chunk {k}"
        assert quit_ == jquit and v.mouse == jv.mouse, k
        assert v.mouse_pixel == jv.mouse_pixel and v._pending == jv._pending
        quits.append(quit_)
    assert quits == [False] * (len(CHUNKS) - 1) + [True]
    assert v.frame_count == jv.frame_count == len(CHUNKS)
    np.testing.assert_array_equal(v.render_current(), jv.render_current())


def test_live_viewer_run_matches_jax(jax_renderer):
    """The loop itself: scripted input until ``max_frames``, the output
    stream without its ms/frame figure."""
    scene = small_scene()
    out = {}
    for name, make in (
            ("port", lambda: viewer.LiveViewer(scene, LIGHT, SMALL, scale=2,
                                               device="cpu")),
            ("jax", lambda: jviewer.LiveViewer(scene, LIGHT, SMALL,
                                               renderer=jax_renderer,
                                               scale=2))):
        chunks = iter(["o", "\x1b[<35;3;3M", "k", "\x1b[A"])
        text = []
        n = make().run(input_fn=lambda: next(chunks),
                       output_fn=text.append, max_frames=4)
        assert n == 4
        # Each frame's status line starts with its ms/frame figure, at
        # least 6 characters wide: cut the line from there.
        out[name] = [t.split("ms/frame")[0].rsplit("\n", 1)[0]
                     if "ms/frame" in t else t for t in text]
    assert out["port"] == out["jax"]


def random_frame(rng, h, w, colours=None):
    if colours is None:
        return rng.integers(0, 256, (h, w, 3)).astype(np.uint8)
    lut = rng.integers(0, 256, (colours, 3)).astype(np.uint8)
    return lut[rng.integers(0, colours, (h, w))]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ansi_frame_and_downscale_match_jax(seed):
    rng = np.random.default_rng(seed)
    for h, w, colours in ((4, 3, None), (9, 7, 3), (33, 40, 5),
                          (21, 16, None)):
        frame = random_frame(rng, h, w, colours)
        for scale in (1, 2, 3):
            np.testing.assert_array_equal(viewer.downscale(frame, scale),
                                          jviewer.downscale(frame, scale))
            assert (viewer.ansi_frame(frame, scale)
                    == jviewer.ansi_frame(frame, scale))
    img = np.zeros((4, 3, 3), np.uint8)
    img[0, :, 0] = 255
    assert "38;2;255;0;0" in viewer.ansi_frame(img).split("\n")[0]


DECODE_FIXED = ["\x1b[A\x1b[D\x1b[5~ah", "\x1b", "\x1b[", "q", "\x1b\x1b",
                "\x1b[C", "\x1b[<35;11;6M\x1b[C", "\x1b[<35;2;2M\x1b[<35;7;3M",
                "a\x1b[<35;4", "\x1b[<35;x;9M", "\x1b[<1;2M", "\x1b[6",
                "\x1b[6~\x1b[Zk", "zzq\x1b[B"]
TOKENS = ["\x1b", "[", "<", ";", "M", "m", "~", "5", "6", "A", "B", "C", "D",
          "a", "k", "j", "u", "h", "o", "q", "1", "2", "9", "x", "\x1b[",
          "\x1b[<35;", "12", "\x1b[5~", "\x1b[6~"]


@pytest.mark.parametrize("seed", [0, 1])
def test_decode_events_matches_jax(seed):
    rng = np.random.default_rng(seed)
    chunks = DECODE_FIXED + ["".join(rng.choice(TOKENS, rng.integers(1, 12)))
                             for _ in range(400)]
    for raw in chunks:
        assert viewer.decode_events(raw) == jviewer.decode_events(raw), raw
        assert viewer.decode_keys(raw) == jviewer.decode_keys(raw), raw


# -- line rasterisers --------------------------------------------------------

def random_segments(seed, n=12):
    rng = np.random.default_rng(seed)
    return [(int(x0), int(y0), int(x1), int(y1)) for x0, x1, y0, y1 in zip(
        *rng.integers(-30, 510, (2, n)), *rng.integers(-30, 350, (2, n)))]


# Longer than H + W + 1 = 801 steps: the device rasterisers stop early.  The
# second and third enter the frame only after the cut.
LONG_SEGMENTS = [(10, 300, 470, -5000), (-2000, 50, 400, 200),
                 (470, -3000, 10, 300), (240, 160, 240, 2000)]


def test_device_draw_line_matches_jax():
    f = jax.jit(joverlay.draw_line)
    base = np.random.default_rng(3).integers(0, 256, (320, 480, 3)).astype(
        np.uint8)
    image = torch.from_numpy(base.copy())
    for seg in random_segments(7) + LONG_SEGMENTS:
        got = overlay.draw_line(image, *seg, (255, 0, 0))
        want = np.asarray(f(jnp.asarray(base), *seg,
                            jnp.asarray([255, 0, 0], jnp.uint8)))
        np.testing.assert_array_equal(got.numpy(), want, err_msg=str(seg))
    assert np.array_equal(image.numpy(), base)     # the input is not written
    # The cut shows on the long segments: the host walk goes on.
    for seg in LONG_SEGMENTS[1:3]:
        host = base.copy()
        overlay.draw_line_host(host, *seg, (255, 0, 0))
        assert not np.array_equal(
            overlay.draw_line(torch.from_numpy(base), *seg,
                              (255, 0, 0)).numpy(), host)


def test_host_draw_line_matches_oracle():
    for seg in random_segments(5, 40) + LONG_SEGMENTS + [(7, 7, 7, 7)]:
        got = np.zeros((320, 480, 3), np.uint8)
        want = np.zeros((320, 480, 3), np.uint8)
        overlay.draw_line_host(got, *seg, (0, 255, 0))
        oracle.draw_line(want, *seg, (0, 255, 0))
        np.testing.assert_array_equal(got, want, err_msg=str(seg))
