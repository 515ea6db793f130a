"""The port's own host modules (``config``, ``assets``, ``scene``) and its
own binding of the C++ oracle (``runtime/native``) against the JAX
package's.

Arrays must be equal and frames pixel-identical."""

import dataclasses

import numpy as np
import pytest

from pixel_art_raytracer_tpu import assets as jassets
from pixel_art_raytracer_tpu import config as jconfig
from pixel_art_raytracer_tpu import scene as jscene
from pixel_art_raytracer_tpu.runtime import native as jnative
from pixel_art_raytracer_tpu_torch import assets, config, scene
from pixel_art_raytracer_tpu_torch.runtime import native

SMALL = config.RenderConfig(view_width=80, view_height=80, view_length=80)
JSMALL = jconfig.RenderConfig(view_width=80, view_height=80, view_length=80)


def scene_arrays(s):
    return {"pos": s.pos, "ext": s.ext, "sprite_id": s.sprite_id,
            "color": s.atlas.color, "depth": s.atlas.depth,
            "normal": s.atlas.normal}


def assert_scenes_equal(got, want):
    g, w = scene_arrays(got), scene_arrays(want)
    for key in w:
        assert g[key].dtype == w[key].dtype, key
        np.testing.assert_array_equal(g[key], w[key], err_msg=key)


def test_render_config_matches_jax():
    fields = [(f.name, f.default) for f in dataclasses.fields(
        config.RenderConfig)]
    assert fields == [(f.name, f.default) for f in dataclasses.fields(
        jconfig.RenderConfig)]
    for cfg, jcfg in ((config.DEFAULT_CONFIG, jconfig.DEFAULT_CONFIG),
                      (SMALL, JSMALL)):
        for prop in ("hash_width", "hash_height", "hash_length",
                     "hash_volume", "n_pixels"):
            assert getattr(cfg, prop) == getattr(jcfg, prop), prop
        assert cfg.bin_flat_index(3, 2, 1) == jcfg.bin_flat_index(3, 2, 1)
    palette = config.DEFAULT_CONFIG.palette_array
    assert palette.dtype == np.uint8
    np.testing.assert_array_equal(palette,
                                  jconfig.DEFAULT_CONFIG.palette_array)
    with pytest.raises(ValueError, match="power of two"):
        config.RenderConfig(bin_capacity=6)


@pytest.mark.parametrize("case", ["graybox", "demo10", "demo4_small"])
def test_scenes_match_jax(case):
    got, want = {
        "graybox": lambda: (scene.graybox_world(), jscene.graybox_world()),
        "demo10": lambda: (scene.demo_world(10), jscene.demo_world(10)),
        "demo4_small": lambda: (scene.demo_world(4, SMALL),
                                jscene.demo_world(4, JSMALL)),
    }[case]()
    assert_scenes_equal(got, want)


def test_lights_assets_and_builder_match_jax():
    for cfg, jcfg in ((config.DEFAULT_CONFIG, jconfig.DEFAULT_CONFIG),
                      (SMALL, JSMALL)):
        light, jlight = scene.default_light(cfg), jscene.default_light(jcfg)
        assert dataclasses.astuple(light) == dataclasses.astuple(jlight)
        np.testing.assert_array_equal(light.as_array(), jlight.as_array())
    tile, jtile = assets.make_tile_floor(), jassets.make_tile_floor()
    two = assets.concat_atlases(tile, tile)
    jtwo = jassets.concat_atlases(jtile, jtile)
    for a, b in ((tile, jtile), (two, jtwo)):
        for field in ("color", "depth", "normal"):
            np.testing.assert_array_equal(getattr(a, field),
                                          getattr(b, field))
        assert a.depth_is_row_only == b.depth_is_row_only
        np.testing.assert_array_equal(a.row_depth(), b.row_depth())
    b, jb = scene.SceneBuilder(config=SMALL), jscene.SceneBuilder(
        config=JSMALL)
    for builder in (b, jb):
        builder.insert((30, 20, 20), (20, 20, 20))
        builder.insert((0, 0, 0), (16, 16, 16), sprite_id=0)
        with pytest.raises(ValueError, match="exceeds sprite map"):
            builder.insert((0, 0, 0), (21, 5, 5))
    assert_scenes_equal(b.build(), jb.build())


@pytest.mark.parametrize("case", ["demo10", "small_far_light"])
def test_native_binding_matches_jax_binding(case):
    if case == "demo10":
        s, js = scene.demo_world(10), jscene.demo_world(10)
        cfg, jcfg = config.DEFAULT_CONFIG, jconfig.DEFAULT_CONFIG
        light = (300, 200, 40)
    else:
        s, js = scene.demo_world(4, SMALL), jscene.demo_world(4, JSMALL)
        cfg, jcfg = SMALL, JSMALL
        light = (900, -40, 300)
    be, cnt = native.cpp_build_bins(s, cfg)
    jbe, jcnt = jnative.cpp_build_bins(js, jcfg)
    np.testing.assert_array_equal(be, jbe)
    np.testing.assert_array_equal(cnt, jcnt)
    frame, gbuf = native.cpp_render_frame(s, scene.Light(*light), cfg)
    jframe, jgbuf = jnative.cpp_render_frame(js, jscene.Light(*light), jcfg)
    assert frame.shape == (cfg.view_height, cfg.view_width, 3)
    np.testing.assert_array_equal(frame, jframe)
    assert isinstance(gbuf, native.GBuffer)
    for field in native.GBuffer._fields:
        np.testing.assert_array_equal(getattr(gbuf, field),
                                      getattr(jgbuf, field), err_msg=field)
    np.testing.assert_array_equal(
        native.cpp_shade(s, gbuf, be, cnt, scene.Light(*light), cfg), frame)


def test_native_build_goes_to_build_dir_and_raises_on_failure(
        tmp_path, monkeypatch):
    assert native.build_dir().parent == native.REPO / "build"
    assert native.build_dir().name.startswith("native-")
    assert "-ffp-contract=off" in native.CXX_FLAGS
    bad = tmp_path / "bad.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCE", bad)
    monkeypatch.setattr(native, "BUILD_ROOT", tmp_path / "build")
    assert native.build_dir().parent == tmp_path / "build"
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native.build()
