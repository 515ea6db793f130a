"""The port's ``BruteForceRenderer`` (``models/brute.py``) against the JAX
package's, the C++ oracle and the port's deferred path, on identical
state.

Bit-exact everywhere: the G-buffer fields and the frames, with and without
the shadow march, at entity chunks that divide the scene and that leave
the last chunk padded."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from pixel_art_raytracer_tpu.config import RenderConfig
from pixel_art_raytracer_tpu.models import brute as jbrute
from pixel_art_raytracer_tpu.models import deferred as jdeferred
from pixel_art_raytracer_tpu.scene import Light, SceneBuilder
from pixel_art_raytracer_tpu_torch.models.brute import BruteForceRenderer
from pixel_art_raytracer_tpu_torch.models.deferred import (DeferredRenderer,
                                                           DeviceScene)
from pixel_art_raytracer_tpu_torch.runtime import native

SMALL = RenderConfig(view_width=80, view_height=80, view_length=80)
CONFIG1 = RenderConfig(view_width=64, view_height=64, view_length=64)
LIGHT = np.array([60, 60, 20], np.int32)


@pytest.fixture(autouse=True)
def one_thread():
    """One PyTorch thread a test: the suite runs in several worker
    processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def small_scene(config=SMALL):
    """tests/test_models.py:19-26."""
    b = SceneBuilder(config=config)
    b.insert((30, 20, 20), (20, 20, 20))
    for i in range(3):
        for j in range(3):
            b.insert((i * 24, 0, j * 24), (16, 16, 16))
    return b.build()


def tie_scene():
    """Boxes with equal depth keys at the same pixels: entity 1 and its
    copies at 2 (the same chunk of 4) and 5 (the next chunk), entity 3 and
    its copy at 7 (chunks 0 and 1 of 4; chunks 1 and 2 of 3), and seeded
    boxes around them."""
    rng = np.random.default_rng(11)
    b = SceneBuilder(config=SMALL)
    b.insert((30, 20, 20), (20, 20, 20))
    for pos in ((10, 0, 10), (10, 0, 10), (40, 10, 30)):
        b.insert(pos, (16, 16, 16))
    b.insert(tuple(int(v) for v in rng.integers(0, 60, 3)), (12, 12, 12))
    b.insert((10, 0, 10), (16, 16, 16))
    b.insert(tuple(int(v) for v in rng.integers(0, 60, 3)), (12, 12, 12))
    b.insert((40, 10, 30), (16, 16, 16))
    return b.build()


def jax_brute(scene, chunk, shadow):
    """The JAX ``BruteForceRenderer``'s G-buffer (numpy fields) and
    frame under ``LIGHT``."""
    r = jbrute.BruteForceRenderer(SMALL, entity_chunk=chunk, shadow=shadow)
    gbuf, frame = r.render_with_gbuffer(
        jdeferred.DeviceScene.from_scene(scene, SMALL),
        jnp.asarray(LIGHT))
    return [np.asarray(t) for t in gbuf], np.asarray(frame)


def port_brute(scene, chunk, shadow, device="cpu"):
    r = BruteForceRenderer(SMALL, entity_chunk=chunk, shadow=shadow)
    gbuf, frame = r.render_with_gbuffer(
        DeviceScene.from_scene(scene, SMALL, device=device), LIGHT)
    return [t.cpu().numpy() for t in gbuf], frame.cpu().numpy()


def assert_gbuffers_equal(got, want):
    for name, g, w in zip(("normal", "color", "y", "z", "entity_index"),
                          got, want):
        np.testing.assert_array_equal(g, w, err_msg=name)


@pytest.mark.parametrize("shadow", [False, True], ids=["lambert", "shadow"])
@pytest.mark.parametrize("chunk", [4, 3])
def test_brute_matches_jax(chunk, shadow):
    """Chunk 4 splits the 10 entities 4 + 4 + 2 (padded), chunk 3 into
    3 + 3 + 3 + 1 (padded)."""
    scene = small_scene()
    gbuf, frame = port_brute(scene, chunk, shadow)
    jgbuf, jframe = jax_brute(scene, chunk, shadow)
    assert frame.shape == (80, 80, 3) and frame.dtype == np.uint8
    assert gbuf[4].shape == (80, 80) and gbuf[0].shape == (80, 80, 3)
    assert_gbuffers_equal(gbuf, jgbuf)
    np.testing.assert_array_equal(frame, jframe)
    assert frame.max() > 31     # something is lit


@pytest.mark.parametrize("chunk", [4, 3])
def test_depth_ties_keep_the_first_entity(chunk):
    scene = tie_scene()
    r = BruteForceRenderer(SMALL, entity_chunk=chunk)
    ds = DeviceScene.from_scene(scene, SMALL, device="cpu")
    jr = jbrute.BruteForceRenderer(SMALL, entity_chunk=chunk)
    jgbuf = jr.trace(jdeferred.DeviceScene.from_scene(scene, SMALL))
    assert_gbuffers_equal([t.numpy() for t in r.trace(ds)],
                          [np.asarray(t) for t in jgbuf])
    # The copies never win: each ties its original at every pixel.
    winners = r.winners(ds).numpy()
    assert {1, 3} <= set(np.unique(winners)) and not (
        {2, 5, 7} & set(np.unique(winners)))


def test_config1_entities_match_cpp():
    """BASELINE config 1 (tests/test_configs.py:99-121): the reference
    sprite on a 64x64 frame."""
    b = SceneBuilder(config=CONFIG1)
    b.insert((10, 0, 10), (20, 20, 20))
    b.insert((30, 10, 20), (20, 20, 20))
    scene = b.build()
    ds = DeviceScene.from_scene(scene, CONFIG1, device="cpu")
    gbuf = BruteForceRenderer(CONFIG1).trace(ds)
    be, cnt = native.cpp_build_bins(scene, CONFIG1)
    want = native.cpp_trace_pixels(scene, be, cnt, CONFIG1)
    np.testing.assert_array_equal(gbuf.entity_index.numpy(),
                                  want.entity_index)
    # With the shadow march, the brute frame is the oracle's frame.
    frame = BruteForceRenderer(CONFIG1, shadow=True).render(
        ds, Light(64, 32, 16).as_array())
    golden, _ = native.cpp_render_frame(scene, Light(64, 32, 16), CONFIG1)
    np.testing.assert_array_equal(frame.numpy(), golden)


def test_brute_matches_deferred_on_quirk_free_scene():
    """No bin of the small scene overflows and no early exit changes a
    winner, so the brute G-buffer and shadowed frame are the deferred
    path's."""
    scene = small_scene()
    ds = DeviceScene.from_scene(scene, SMALL, device="cpu")
    r = DeferredRenderer(SMALL).configure_for(scene)
    gbuf_d, frame_d = r.render_with_gbuffer(ds, LIGHT)
    brute = BruteForceRenderer(SMALL, entity_chunk=4, shadow=True)
    gbuf_b, frame_b = brute.render_with_gbuffer(ds, LIGHT)
    assert_gbuffers_equal([t.numpy() for t in gbuf_b],
                          [t.numpy() for t in gbuf_d])
    assert torch.equal(frame_b, frame_d)


@pytest.mark.cuda
@pytest.mark.parametrize("shadow", [False, True], ids=["lambert", "shadow"])
def test_cuda_brute_matches_cpu(cuda, shadow):
    scene = tie_scene()
    got = port_brute(scene, 3, shadow, device=cuda)
    want = port_brute(scene, 3, shadow)
    assert_gbuffers_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
