"""Port light geometry and the shadow march (``light_geometry``,
``trace_light_dynamic`` and the shadow kernel's wrapper) against the JAX
package.

Geometry must be bit-equal float32, lit masks equal, including a light
exactly on a surface point (0/0 -> NaN direction) and lights more than 16
bins away (beyond the JAX package's static step bound)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from pixel_art_raytracer_tpu.config import RenderConfig
from pixel_art_raytracer_tpu.ops import shade as jshade
from pixel_art_raytracer_tpu.ops import shadow as jshadow
from pixel_art_raytracer_tpu.ops.trace import GBufferArrays as JGBuffer
from pixel_art_raytracer_tpu.scene import SceneBuilder
from pixel_art_raytracer_tpu_torch.models.deferred import DeviceScene
from pixel_art_raytracer_tpu_torch.ops import (binning, shade, shadow,
                                               shadow_cuda, trace_cuda, trace)

SMALL = RenderConfig(view_width=80, view_height=80, view_length=80)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def shadow_scene(seed=0, config=SMALL):
    """Floor tiles, a player box and seeded random occluders."""
    rng = np.random.default_rng(seed)
    b = SceneBuilder(config=config)
    b.insert((30, 20, 20), (20, 20, 20))
    for i in range(4):
        for j in range(4):
            b.insert((i * 20, 0, j * 20), (20, 20, 20))
    for _ in range(12):
        b.insert(tuple(int(v) for v in rng.integers(0, 70, 3)),
                 (int(rng.integers(2, 15)), int(rng.integers(2, 15)),
                  int(rng.integers(2, 15))))
    return b.build()


def traced(scene, config, device="cpu"):
    """Port scene, bin tables and G-buffer (one frame) on ``device``."""
    ds = DeviceScene.from_scene(scene, config, device=device)
    spans = binning.entity_span_bound(scene.ext.max(axis=0), config)
    be, cnt = binning.build_bins(ds.pos, ds.ext, config, spans)
    be, cnt = be[None], cnt[None]
    win = trace_cuda.trace_winners(ds.pos, ds.ext, ds.sprite_id,
                                   ds.atlas_depth, be, cnt, ds.pos[:1],
                                   config)
    gb = trace.materialize_gbuffer(win, ds.pos, ds.ext, ds.sprite_id,
                                   ds.atlas_color, ds.atlas_depth,
                                   ds.atlas_normal, ds.palette, ds.pos[:1],
                                   config)
    return ds, be, cnt, gb


def surface_light(gb):
    """A light exactly on the surface point of the first hit pixel."""
    j, i = (int(v) for v in torch.nonzero(gb.entity_index[0] > 0)[0])
    return [i, int(gb.y[0, j, i]), int(gb.z[0, j, i])]


def bits(t):
    a = np.asarray(t)
    return a.view(np.int32) if a.dtype == np.float32 else a


LIGHTS = {
    "near": [60, 60, 20],
    "grazing": [0, 80, 79],
    "far_x": [800, 60, 20],          # 20 bins out along x
    "far_diag": [-700, 300, 700],    # beyond 16 bins on every axis
}


@pytest.mark.parametrize("light", sorted(LIGHTS) + ["on_surface"])
def test_geometry_and_march_match_jax(light):
    scene = shadow_scene()
    ds, be, cnt, gb = traced(scene, SMALL)
    lxyz = surface_light(gb) if light == "on_surface" else LIGHTS[light]
    lights = torch.tensor([lxyz], dtype=torch.int32)

    tl, inv, origin, rb, lb = shade.light_geometry(gb, lights, SMALL)
    jgb = JGBuffer(*(jnp.asarray(t[0].numpy()) for t in gb))
    jtl, jinv, jorigin, jrb, jlb = jshade.light_geometry(
        jgb, jnp.asarray(lxyz, jnp.int32), SMALL)
    for name, got, want in (("tl", tl, jtl), ("inv", inv, jinv),
                            ("origin", origin, jorigin), ("rb", rb, jrb)):
        for a in range(3):
            np.testing.assert_array_equal(bits(got[a][0].numpy()),
                                          bits(want[a]), err_msg=name)
    assert [int(v) for v in lb] == [int(v) for v in jlb]
    if light == "on_surface":
        assert torch.isnan(tl[0]).any() and torch.isnan(inv[0]).any()

    lit = shadow.trace_light_dynamic(ds.pos, ds.ext, be, cnt, rb, lb,
                                     gb.entity_index, origin, inv,
                                     ds.pos[:1], SMALL)
    jlit = jshadow.trace_light_dynamic(
        jnp.asarray(scene.pos), jnp.asarray(scene.ext), jnp.asarray(be[0]),
        jnp.asarray(cnt[0]), jrb, jlb, jgb.entity_index, jorigin, jinv,
        SMALL)
    np.testing.assert_array_equal(lit[0].numpy(), np.asarray(jlit))
    assert not lit.all(), "light is never occluded: the march tests nothing"


def test_lambert_dot_and_factor_match_jax():
    scene = shadow_scene(seed=1)
    _, _, _, gb = traced(scene, SMALL)
    lights = torch.tensor([[60, 60, 20]], dtype=torch.int32)
    tl, *_ = shade.light_geometry(gb, lights, SMALL)
    dot = shade.lambert_dot(gb.normal, tl)
    rng = np.random.default_rng(5)
    lit = rng.random(dot.shape) < 0.5
    factor = shade.factor_from_dot(dot, torch.from_numpy(lit), SMALL)
    jtl = tuple(jnp.asarray(t[0].numpy()) for t in tl)
    jdot = (jnp.asarray(gb.normal[0].numpy())[..., 0] * jtl[0]
            + jnp.asarray(gb.normal[0].numpy())[..., 1] * jtl[1]
            + jnp.asarray(gb.normal[0].numpy())[..., 2] * jtl[2])
    np.testing.assert_array_equal(bits(dot[0].numpy()), bits(jdot))
    jfactor = jshade.factor_from_dot(jdot, jnp.asarray(lit[0]), SMALL)
    np.testing.assert_array_equal(bits(factor[0].numpy()), bits(jfactor))
    rgb = shade.shade_u8(gb.color, factor)
    jrgb = (np.asarray(gb.color[0, ..., :3]).astype(np.float32)
            * np.asarray(jfactor)[..., None]).astype(np.uint8)
    np.testing.assert_array_equal(rgb[0].numpy(), jrgb)


@pytest.mark.cuda
@pytest.mark.parametrize("light", sorted(LIGHTS) + ["on_surface"])
def test_cuda_kernel_matches_plain(cuda, light):
    scene = shadow_scene()
    want = []
    for dev in ("cpu", cuda):
        ds, be, cnt, gb = traced(scene, SMALL, device=dev)
        lxyz = surface_light(gb) if light == "on_surface" else LIGHTS[light]
        lights = torch.tensor([lxyz], dtype=torch.int32, device=dev)
        _, inv, origin, rb, lb = shade.light_geometry(gb, lights, SMALL)
        want.append(shadow_cuda.trace_light(ds.pos, ds.ext, be, cnt, rb, lb,
                                            gb.entity_index, origin, inv,
                                            ds.pos[:1], SMALL).cpu())
    assert torch.equal(want[0], want[1])
