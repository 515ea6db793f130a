"""The port's host utilities and long-render runtime against the JAX
package's, on identical inputs: GIF and PNG bytes, colour quantisation,
``RenderStats``, the metrics helpers, checkpointed ``render_long`` with
resume, and ``render_script``.

Bit-exact everywhere: file bytes, palettes and indices, strings and
frames."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from pixel_art_raytracer_tpu.config import RenderConfig
from pixel_art_raytracer_tpu.models import animation as janimation
from pixel_art_raytracer_tpu.models import deferred as jdeferred
from pixel_art_raytracer_tpu.scene import SceneBuilder
from pixel_art_raytracer_tpu.utils import gif as jgif
from pixel_art_raytracer_tpu.utils import metrics as jmetrics
from pixel_art_raytracer_tpu.utils import png as jpng
from pixel_art_raytracer_tpu_torch.models.animation import (AnimationRenderer,
                                                            WorldState)
from pixel_art_raytracer_tpu_torch.models.deferred import (DeferredRenderer,
                                                           DeviceScene)
from pixel_art_raytracer_tpu_torch.utils import checkpoint, gif, metrics, png

SMALL = RenderConfig(view_width=80, view_height=80, view_length=80)


@pytest.fixture(autouse=True)
def one_thread():
    """One PyTorch thread a test: the suite runs in several worker
    processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def frames_of(seed, f=3, h=24, w=32, colours=4):
    """Seeded (f, h, w, 3) uint8 frames of ``colours`` colours, or of any
    colour when ``colours`` is None."""
    rng = np.random.default_rng(seed)
    if colours is None:
        return rng.integers(0, 256, (f, h, w, 3)).astype(np.uint8)
    lut = rng.integers(0, 256, (colours, 3)).astype(np.uint8)
    return lut[rng.integers(0, colours, (f, h, w))]


GIF_CASES = {
    "4_colours": dict(seed=0),
    "one_colour": dict(seed=1, colours=1),
    "256_colours": dict(seed=2, f=2, h=40, w=50, colours=256),
    "cube": dict(seed=3, f=2, h=33, w=17, colours=None),
    "one_frame": dict(seed=4, f=1, h=9, w=300, colours=37),
}


@pytest.mark.parametrize("case", list(GIF_CASES))
@pytest.mark.parametrize("encoder", ["native", "python"])
def test_write_gif_matches_jax_bytes(tmp_path, case, encoder):
    """A one-colour palette is refused by the native library (it takes 2
    to 256 colours), so the Python encoder writes it, in both packages."""
    frames = frames_of(**GIF_CASES[case])
    native = encoder == "native"
    ran = "python" if case == "one_colour" else encoder
    ours, theirs = tmp_path / "port.gif", tmp_path / "jax.gif"
    assert gif.write_gif(ours, frames, delay_cs=7,
                         prefer_native=native) == ran
    assert jgif.write_gif(theirs, frames, delay_cs=7,
                          prefer_native=native) == ran
    assert ours.read_bytes() == theirs.read_bytes()


@pytest.mark.parametrize("encoder", ["native", "python"])
def test_gif_round_trips_through_pil(tmp_path, encoder):
    image = pytest.importorskip("PIL.Image")
    frames = frames_of(5, f=3, h=24, w=32, colours=6)
    path = tmp_path / "out.gif"
    assert gif.write_gif(path, frames,
                         prefer_native=encoder == "native") == encoder
    img = image.open(path)
    assert img.size == (32, 24)
    out = []
    try:
        while True:
            out.append(np.asarray(img.convert("RGB")))
            img.seek(img.tell() + 1)
    except EOFError:
        pass
    np.testing.assert_array_equal(np.stack(out), frames)


def test_native_gif_refusal_falls_back_to_python(tmp_path):
    """A path the library cannot open: the native call fails and the
    Python encoder runs, as in the JAX package (which then raises too)."""
    missing = tmp_path / "no_such_dir" / "x.gif"
    with pytest.raises(FileNotFoundError):
        gif.write_gif(missing, frames_of(0))


@pytest.mark.parametrize("case", ["4_colours", "256_colours", "cube"])
def test_quantize_frames_matches_jax(case):
    frames = frames_of(**GIF_CASES[case])
    idx, pal = gif.quantize_frames(frames)
    jidx, jpal = jgif.quantize_frames(frames)
    np.testing.assert_array_equal(idx, jidx)
    np.testing.assert_array_equal(pal, jpal)
    assert idx.dtype == jidx.dtype and pal.dtype == jpal.dtype
    if case != "cube":
        np.testing.assert_array_equal(pal[idx], frames)


@pytest.mark.parametrize("shape", [(24, 32, 3), (17, 5)])
def test_write_png_matches_jax_bytes(tmp_path, shape):
    image = np.random.default_rng(6).integers(0, 256, shape).astype(np.uint8)
    png.write_png(tmp_path / "port.png", image)
    jpng.write_png(tmp_path / "jax.png", image)
    assert ((tmp_path / "port.png").read_bytes()
            == (tmp_path / "jax.png").read_bytes())


@pytest.mark.parametrize("shadow_rays", [True, False])
def test_render_stats_json_matches_jax(shadow_rays):
    for frames, h, w, sec in ((10, 320, 480, 1.0), (64, 320, 480, 0.0061234),
                              (3, 7, 5, 1 / 3)):
        ours = metrics.RenderStats(frames, h, w, sec, shadow_rays)
        theirs = jmetrics.RenderStats(frames, h, w, sec, shadow_rays)
        assert ours.to_json() == theirs.to_json()
        assert ours.rays_per_frame == theirs.rays_per_frame


def test_time_fn_and_checksummed(tmp_path):
    x = torch.arange(12, dtype=torch.int32).reshape(3, 4)

    def fn(a):
        return {"ints": a * 3, "floats": (a.float() / 4, a > 5)}

    best, out = metrics.time_fn(fn, x, warmup=1, iters=2)
    assert best > 0 and torch.equal(out["ints"], x * 3)
    sums = metrics.checksummed(fn)(x)
    jsums = jmetrics.checksummed(lambda a: {
        "ints": a * 3, "floats": (a.astype(jnp.float32) / 4, a > 5)})(
            jnp.asarray(x.numpy()))
    assert [float(s) for s in sums] == [float(s) for s in jsums]
    assert [s.dtype for s in sums] == [torch.float32, torch.int64, torch.int32]
    with metrics.profiler_trace(None):
        pass
    with metrics.profiler_trace(tmp_path / "trace"):
        fn(x)
    assert (tmp_path / "trace" / "trace.json").stat().st_size > 0


def test_checkpointer_resumes_at_the_first_missing_chunk(tmp_path):
    calls = []

    def render_chunk(start, count):
        calls.append((start, count))
        return np.full((count, 4, 4, 3), start, np.uint8)

    out1 = checkpoint.render_with_checkpoints(render_chunk, 10, tmp_path, 4)
    assert calls == [(0, 4), (4, 4), (8, 2)] and out1.shape == (10, 4, 4, 3)
    calls.clear()
    (tmp_path / "chunk_00001.npz").unlink()
    out2 = checkpoint.render_with_checkpoints(render_chunk, 10, tmp_path, 4)
    assert calls == [(4, 4), (8, 2)]
    np.testing.assert_array_equal(out1, out2)
    ck = checkpoint.FrameCheckpointer(tmp_path, chunk_size=4)
    assert ck.completed_chunks() == 3 and ck.resume_frame() == 12


def resume_scene():
    """tests/test_configs.py:75-91."""
    b = SceneBuilder(config=SMALL)
    b.insert((30, 20, 20), (20, 20, 20))
    b.insert((0, 0, 0), (20, 20, 20))
    return b.build()


def jax_animation():
    jr = jdeferred.DeferredRenderer(SMALL, shadow_max_steps=8,
                                    trace_impl="jnp", shadow_impl="scan")
    return janimation.AnimationRenderer(jr, SMALL)


def test_render_long_matches_jax_and_resumes(tmp_path):
    scene = resume_scene()
    ds = DeviceScene.from_scene(scene, SMALL, device="cpu")
    rng = np.random.default_rng(8)
    players = (scene.pos[0] + rng.integers(-6, 7, (5, 3))).astype(np.int32)
    lights = np.column_stack([rng.integers(0, 80, 5), rng.integers(30, 90, 5),
                              rng.integers(0, 40, 5)]).astype(np.int32)
    anim = AnimationRenderer(DeferredRenderer(SMALL).configure_for(scene),
                             SMALL)
    out1 = anim.render_long(ds, players, lights, tmp_path / "port",
                            chunk_size=2)
    assert isinstance(out1, np.ndarray) and out1.shape == (5, 80, 80, 3)
    janim = jax_animation()
    janim.renderer.spans = janim.renderer.spans_for(scene)
    want = janim.render_long(jdeferred.DeviceScene.from_scene(scene, SMALL),
                             players, lights, tmp_path / "jax", chunk_size=2)
    np.testing.assert_array_equal(out1, want)

    # Resume: the last chunk (frame 4, padded to 2 frames) re-renders alone.
    batches = []
    render_states = anim.render_states

    def counted(dscene, p, l, **kw):
        batches.append(p.clone())
        return render_states(dscene, p, l, **kw)

    anim.render_states = counted
    out2 = anim.render_long(ds, players, lights, tmp_path / "port",
                            chunk_size=2)
    assert batches == []
    (tmp_path / "port" / "chunk_00002.npz").unlink()
    out3 = anim.render_long(ds, players, lights, tmp_path / "port",
                            chunk_size=2)
    assert len(batches) == 1
    np.testing.assert_array_equal(batches[0].numpy(), players[[4, 4]])
    np.testing.assert_array_equal(out2, out1)
    np.testing.assert_array_equal(out3, out1)


def test_render_script_matches_jax():
    """tests/test_models.py:61-72, with every binding."""
    scene = resume_scene()
    ds = DeviceScene.from_scene(scene, SMALL, device="cpu")
    script = [["right"], [], ["h"], ["up", "pageup", "a", "k"],
              ["left", "down", "pagedown", "j", "u", "o", "o"]]
    anim = AnimationRenderer(DeferredRenderer(SMALL).configure_for(scene),
                             SMALL)
    init = WorldState(torch.tensor(scene.pos[0], dtype=torch.int32),
                      torch.tensor([60, 60, 20], dtype=torch.int32))
    frames, final = anim.render_script(ds, init, script)
    janim = jax_animation()
    janim.renderer.spans = janim.renderer.spans_for(scene)
    jinit = janimation.WorldState(jnp.asarray(scene.pos[0], jnp.int32),
                                  jnp.asarray([60, 60, 20], jnp.int32))
    jframes, jfinal = janim.render_script(
        jdeferred.DeviceScene.from_scene(scene, SMALL), jinit, script)
    np.testing.assert_array_equal(frames.numpy(), np.asarray(jframes))
    np.testing.assert_array_equal(final.player_pos.numpy(),
                                  np.asarray(jfinal.player_pos))
    np.testing.assert_array_equal(final.light.numpy(),
                                  np.asarray(jfinal.light))
    assert int(final.player_pos[0]) == scene.pos[0][0]
    assert frames.shape == (5, 80, 80, 3)
