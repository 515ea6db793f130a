"""Port ordered-dither shading (``ops/dither.py``) against the JAX package.

Exact: the luminance bit for bit (float32), the Bayer matrix and the
palette indices equal, the frames equal.  The JAX code's luminance is
``rgb.astype(f32) @ weights``, which XLA evaluates on the CPU as the fused
multiply-add chain ``fma(b, w2, fma(g, w1, r * w0))``; the port computes
that chain, and these tests pin that a sequential sum would not do."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from pixel_art_raytracer_tpu.ops import dither as jdither
from pixel_art_raytracer_tpu_torch.config import DEFAULT_PALETTE, RenderConfig
from pixel_art_raytracer_tpu_torch.models.animation import AnimationRenderer
from pixel_art_raytracer_tpu_torch.models.deferred import (DeferredRenderer,
                                                           DeviceScene)
from pixel_art_raytracer_tpu_torch.ops import dither
from pixel_art_raytracer_tpu_torch.scene import SceneBuilder

SMALL = RenderConfig(view_width=80, view_height=80, view_length=80)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")
PALETTE = np.asarray(DEFAULT_PALETTE, np.uint8)[:, :3]
WEIGHTS = jnp.asarray([0.299, 0.587, 0.114], jnp.float32)


@pytest.fixture(autouse=True)
def one_thread():
    """Run each test on one PyTorch thread: the suite runs in several
    worker processes at once, and the plain versions' many small ops slow
    down sharply when every worker also spreads over every core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def bits(a) -> np.ndarray:
    return np.asarray(a, np.float32).view(np.int32)


def jax_luminance(rgb: np.ndarray) -> np.ndarray:
    """The JAX code's luminance (ops/dither.py:69-70 there)."""
    return np.array((jnp.asarray(rgb).astype(jnp.float32) @ WEIGHTS)
                    / 255.0)


def seeded_colours(n=100_000, seed=0) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 256, (n, 3)).astype(
        np.uint8)


@pytest.mark.parametrize("colours", ["default_palette", "seeded"])
def test_luminance_is_bit_equal_to_jax(colours):
    rgb = PALETTE if colours == "default_palette" else seeded_colours()
    got = dither.luminance(torch.from_numpy(rgb)).numpy()
    want = jax_luminance(rgb)
    np.testing.assert_array_equal(bits(got), bits(want))
    # The hazard the FMA chain avoids: the sequential sum differs from JAX
    # (on the default palette's (240, 240, 240) by one ulp).
    f = rgb.astype(np.float32)
    w = np.asarray(WEIGHTS)
    seq = (f[:, 0] * w[0] + f[:, 1] * w[1] + f[:, 2] * w[2]) / np.float32(255)
    assert (bits(seq) != bits(want)).any()


@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_bayer_matrix_matches_jax(n):
    got = dither.bayer_matrix(n)
    want = jdither.bayer_matrix(n)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_bayer_matrix_refuses_other_sizes():
    for n in (0, 3, 6):
        with pytest.raises(ValueError, match="power of two"):
            dither.bayer_matrix(n)


def edge_targets(palette_luma: np.ndarray, H=24, W=20, seed=1):
    """(H, W) float32 targets on palette luminances, on the Bayer threshold
    of their pixel between two entries (frac == threshold), one ulp either
    side of both, below the darkest and above the brightest entry, and
    seeded values in [0, 1]."""
    rng = np.random.default_rng(seed)
    tile = np.tile(dither.bayer_matrix(4), (H // 4, W // 4))
    lo = rng.integers(0, len(palette_luma) - 1, (H, W))
    span = palette_luma[lo + 1] - palette_luma[lo]
    on_threshold = (palette_luma[lo] + tile * span).astype(np.float32)
    on_entry = palette_luma[rng.integers(0, len(palette_luma), (H, W))]
    kind = rng.integers(0, 7, (H, W))
    t = np.where(kind == 0, on_entry, on_threshold)
    t = np.where(kind == 2, np.nextafter(on_threshold, np.float32(2)), t)
    t = np.where(kind == 3, np.nextafter(on_threshold, np.float32(-1)), t)
    t = np.where(kind == 4, np.nextafter(on_entry, np.float32(-1)), t)
    t = np.where(kind == 5, rng.random((H, W)), t)
    t[0, :4] = [0.0, 1.0, palette_luma[0] / 2, 1.5]
    return t.astype(np.float32)


@pytest.mark.parametrize("palette", ["default", "seeded"])
def test_dither_to_palette_matches_jax(palette):
    if palette == "default":
        pal = PALETTE
    else:
        pal = seeded_colours(6, seed=4)
        pal = pal[np.argsort(jax_luminance(pal), kind="stable")]
    luma = jax_luminance(pal)
    target = edge_targets(luma)
    got = dither.dither_to_palette(torch.from_numpy(target),
                                   torch.from_numpy(luma)).numpy()
    want = np.asarray(jdither.dither_to_palette(jnp.asarray(target),
                                                jnp.asarray(luma)))
    np.testing.assert_array_equal(got, want)
    assert len(np.unique(got)) == len(pal)
    # Batched over frames, as the render path calls it.
    stacked = torch.from_numpy(np.stack([target, target[::-1].copy()]))
    got2 = dither.dither_to_palette(stacked, torch.from_numpy(luma)).numpy()
    np.testing.assert_array_equal(got2[0], want)


def seeded_gbuffer(seed, F=2, H=24, W=28):
    """Colours (palette entries, the background and seeded values) and
    brightness factors (ambient, 1, 0 and seeded values in [0, 1])."""
    rng = np.random.default_rng(seed)
    colours = np.concatenate([PALETTE, [[127, 127, 127]],
                              seeded_colours(20, seed)])
    color = colours[rng.integers(0, len(colours), (F, H, W))]
    color = np.concatenate([color, np.zeros((F, H, W, 1), np.uint8)], -1)
    factor = rng.random((F, H, W)).astype(np.float32)
    special = rng.integers(0, 4, (F, H, W))
    factor = np.where(special == 0, np.float32(0.25), factor)
    factor = np.where(special == 1, np.float32(1.0), factor)
    factor[:, 0, 0] = 0.0
    return color, factor


@pytest.mark.parametrize("seed", [0, 1])
def test_shade_dithered_matches_jax(seed):
    color, factor = seeded_gbuffer(seed)
    got = dither.shade_dithered(torch.from_numpy(color),
                                torch.from_numpy(factor),
                                torch.from_numpy(PALETTE)).numpy()
    assert got.shape == color.shape[:-1] + (3,) and got.dtype == np.uint8
    for f in range(color.shape[0]):
        want = np.asarray(jdither.shade_dithered(
            jnp.asarray(color[f]), jnp.asarray(factor[f]),
            jnp.asarray(PALETTE)))
        np.testing.assert_array_equal(got[f], want)


def test_dithered_frames_contain_only_palette_colours():
    b = SceneBuilder(config=SMALL)
    b.insert((30, 20, 20), (20, 20, 20))
    b.insert((0, 0, 0), (16, 16, 16))
    scene = b.build()
    ds = DeviceScene.from_scene(scene, SMALL, device="cpu")
    r = DeferredRenderer(SMALL, style="dithered").configure_for(scene)
    lights = torch.tensor([[60, 60, 20], [10, 70, 30]], dtype=torch.int32)
    frames = AnimationRenderer(r, SMALL).render_states(
        ds, ds.pos[:1].expand(2, 3).contiguous(), lights).numpy()
    colours = {tuple(c) for c in frames.reshape(-1, 3)}
    assert colours <= {tuple(c) for c in PALETTE}
    assert len(colours) > 1


def test_style_is_checked():
    with pytest.raises(ValueError, match="style"):
        DeferredRenderer(SMALL, style="posterized")


@pytest.mark.cuda
def test_cuda_dither_matches_cpu(cuda):
    """On the card as on the CPU: the luminance of 100,000 colours bit for
    bit, and the dithered frames of seeded G-buffers."""
    rgb = torch.from_numpy(seeded_colours())
    got = dither.luminance(rgb.to(cuda)).cpu().numpy()
    np.testing.assert_array_equal(bits(got),
                                  bits(dither.luminance(rgb).numpy()))
    color, factor = seeded_gbuffer(2, H=64, W=96)
    args = [torch.from_numpy(a) for a in (color, factor, PALETTE)]
    want = dither.shade_dithered(*args)
    got = dither.shade_dithered(*(a.to(cuda) for a in args)).cpu()
    assert torch.equal(got, want)
