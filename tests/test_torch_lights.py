"""Port lighting modes against the JAX package: directional lights
(``ops/shadow_dir.py`` and the capped march), additive multi-light and the
dithered style of each mode, through ``AnimationRenderer.render_states``.

All comparisons are exact (tolerance zero).  The JAX reference is its
``AnimationRenderer`` on the per-frame scan path (``trace_impl="jnp"``,
``shadow_impl="scan"``): ``shade_directional``, ``shade_multi`` or
``shade``.  That path shades directional and multi-light frames in the
reference style whatever the renderer's style, where the JAX batched path
(``models/batched.py:888-924``) dithers them, so for those two dithered
pairs the reference is the batched path's op sequence built from the JAX
package's own ops (``shade_directional(style="dithered")``;
``lighting_factor`` per light, summed light by light, then
``shade_dithered``).  The port follows the batched path.  The directional
and three-light frames are also checked against the JAX batched path itself
(Pallas in interpret mode)."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from pixel_art_raytracer_tpu.config import RenderConfig
from pixel_art_raytracer_tpu.models import animation as janimation
from pixel_art_raytracer_tpu.models import deferred as jdeferred
from pixel_art_raytracer_tpu.ops import dither as jdither
from pixel_art_raytracer_tpu.ops import shade as jshade
from pixel_art_raytracer_tpu.ops import shadow as jshadow
from pixel_art_raytracer_tpu.ops import shadow_dir as jshadow_dir
from pixel_art_raytracer_tpu.ops import shadow_fast
from pixel_art_raytracer_tpu.ops.static_bins import StaticBins as JStaticBins
from pixel_art_raytracer_tpu.scene import SceneBuilder, demo_world
from pixel_art_raytracer_tpu_torch.models.animation import AnimationRenderer
from pixel_art_raytracer_tpu_torch.models.deferred import (DeferredRenderer,
                                                           DeviceScene)
from pixel_art_raytracer_tpu_torch.ops import (binning, shade, shadow,
                                               shadow_cuda, shadow_dir,
                                               trace, trace_cuda)
from pixel_art_raytracer_tpu_torch.ops.cstyle import c_max, c_min
from pixel_art_raytracer_tpu_torch.ops.static_bins import StaticBins

SMALL = RenderConfig(view_width=80, view_height=80, view_length=80)
# A 10 x 1 x 1 grid: a cap of 13 steps, while a light along +x lies 20 bins
# and more away.
CAP = RenderConfig(view_width=400, view_height=40, view_length=40)


@pytest.fixture(autouse=True)
def one_thread():
    """Run each test on one PyTorch thread: the suite runs in several
    worker processes at once, and the plain versions' many small ops slow
    down sharply when every worker also spreads over every core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def bits(t) -> np.ndarray:
    a = np.asarray(t)
    return a.view(np.int32) if a.dtype == np.float32 else a


# -- direction constants and light bins --------------------------------------

AXES = [(1, 0, 0), (-1, 0, 0), (0, 1, 0), (0, -1, 0), (0, 0, 1), (0, 0, -1)]


def directions(seed=0, n=24) -> np.ndarray:
    """± each axis, (0, 1, 0) and ``n`` seeded directions, (F, 3) float32."""
    rng = np.random.default_rng(seed)
    return np.concatenate([np.asarray(AXES + [(0, 1, 0)], np.float32),
                           rng.uniform(-1, 1, (n, 3)).astype(np.float32)])


def test_direction_constants_and_light_bins_match_jax():
    d = directions()
    tl, inv, K = shadow_dir.direction_constants(torch.from_numpy(d), SMALL)
    assert tl.dtype == inv.dtype == torch.float32 and K.dtype == torch.int32
    rng = np.random.default_rng(1)
    F, H, W = len(d), 12, 20
    y = rng.integers(-60, 400, (F, H, W)).astype(np.int32)
    z = rng.integers(-60, 400, (F, H, W)).astype(np.int32)
    y[:, 0], z[:, 0] = 0, 0  # background
    lb = shadow_dir.pixel_light_bins(torch.from_numpy(y), torch.from_numpy(z),
                                     K, SMALL)
    for f in range(F):
        jtl, jinv, jK = jshadow_dir.direction_constants(jnp.asarray(d[f]),
                                                        SMALL)
        for a in range(3):
            np.testing.assert_array_equal(bits(tl[f, a].numpy()),
                                          bits(jtl[a]))
            np.testing.assert_array_equal(bits(inv[f, a].numpy()),
                                          bits(jinv[a]))
            assert int(K[f, a]) == int(jK[a])
        jlb = jshadow_dir.pixel_light_bins(jnp.asarray(y[f]),
                                           jnp.asarray(z[f]), jK, SMALL)
        for a in range(3):
            np.testing.assert_array_equal(lb[a][f].numpy(),
                                          np.asarray(jlb[a]))
    assert shadow_dir.grid_max_steps(SMALL) == jshadow_dir.grid_max_steps(
        SMALL) == 7
    assert shadow_dir.grid_max_steps(CAP) == 13


# -- the capped march with per-pixel light bins -------------------------------

def occluder_scene(config, seed=0):
    """Floor tiles, a player box and seeded occluders across the view."""
    rng = np.random.default_rng(seed)
    b = SceneBuilder(config=config)
    b.insert((30, 20, 20), (20, 20, 20))
    for i in range(0, config.view_width, 20):
        b.insert((i, 0, 0), (20, 10, 20))
    for _ in range(16):
        b.insert((int(rng.integers(0, config.view_width)),
                  int(rng.integers(0, 50)), int(rng.integers(0, 40))),
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


MARCHES = {
    "small": (SMALL, (0.3, 1.0, -0.2)),
    "small_grazing": (SMALL, (-1.0, 0.2, 0.6)),
    "cap": (CAP, (1.0, 0.1, 0.05)),
}


def march_inputs(case, device="cpu"):
    config, d = MARCHES[case]
    scene = occluder_scene(config)
    ds, be, cnt, gb = traced(scene, config, device)
    tl, inv, K = shadow_dir.direction_constants(
        torch.tensor([d], dtype=torch.float32, device=device), config)
    args = (ds.pos, ds.ext, be, cnt, gb.y, gb.z, gb.entity_index, inv, K,
            ds.pos[:1], config, shadow_dir.grid_max_steps(config))
    return scene, gb, args


@pytest.mark.parametrize("case", sorted(MARCHES))
def test_capped_march_matches_jax_trace_light(case):
    scene, gb, args = march_inputs(case)
    config, max_steps = args[-2], args[-1]
    pos, ext, be, cnt, y, z, ent, inv, K = args[:9]
    lit = shadow_dir.trace_light_directional(*args)
    rb, origin = shade.surface_rays(y, z, config)
    lb = shadow_dir.pixel_light_bins(y, z, K, config)
    assert torch.equal(lit, shadow.trace_light_dynamic(
        pos, ext, be, cnt, rb, lb, ent, origin,
        tuple(inv[:, a].view(1, 1, 1) for a in range(3)), pos[:1], config,
        max_steps=max_steps))
    # The JAX package's march of shade_directional: trace_light, a scan of
    # 7 * max_steps phases.
    j = lambda t: jnp.asarray(t[0].numpy())  # noqa: E731
    jlit = jshadow.trace_light(
        jnp.asarray(scene.pos), jnp.asarray(scene.ext), j(be), j(cnt),
        tuple(map(j, rb)), tuple(map(j, lb)), j(ent), tuple(map(j, origin)),
        tuple(jnp.float32(v) for v in inv[0].tolist()), config, max_steps)
    np.testing.assert_array_equal(lit[0].numpy(), np.asarray(jlit))
    assert not lit.all() and lit.any()
    assert cap_binds(args) == (case == "cap")


def cap_binds(args) -> bool:
    """Whether some ray of these inputs is more than the step cap away
    from its light bin."""
    y, z, K, config, max_steps = args[4], args[5], args[8], *args[-2:]
    rb, _ = shade.surface_rays(y, z, config)
    lb = shadow_dir.pixel_light_bins(y, z, K, config)
    largest = torch.stack([(l - r).abs() for l, r in zip(lb, rb)]).amax(0)
    return int(largest.max()) > max_steps


def keyed_list_march(pos, ext, bins_ent, counts, start_bin, end_bin,
                     start_ent, origin, inv_dir, players, config, max_steps):
    """A CPU model of the directional kernel's list path: the pixels of one
    (start bin, light bin) key test the boxes of that key's visit list
    (``dda_visit_lists`` under the cap) in list order, skipping their own
    entity.  Returns the lit mask."""
    cap = config.bin_capacity
    shape = start_bin[0].shape
    keys = torch.stack([t.expand(shape).reshape(-1)
                        for t in (*start_bin, *end_bin)], dim=1)
    ukeys, inverse = torch.unique(keys, dim=0, return_inverse=True)
    lists = shadow.dda_visit_lists(tuple(ukeys[:, :3].unbind(1)),
                                   tuple(ukeys[:, 3:].unbind(1)), config,
                                   max_steps)
    frame = torch.arange(shape[0])[:, None, None].expand(shape).reshape(-1)
    o = [t.expand(shape).reshape(-1) for t in origin]
    iv = [t.expand(shape).reshape(-1) for t in inv_dir]
    me = start_ent.reshape(-1)
    occ = torch.zeros(keys.shape[0], dtype=torch.bool)
    for u, flats in enumerate(lists):
        mine = inverse == u
        for flat in flats:
            for f in torch.unique(frame[mine]).tolist():
                rays = mine & (frame == f)
                for k in range(min(int(counts[f, flat]), cap)):
                    e = int(bins_ent[f, flat, k])
                    es = max(e, 0)
                    p = players[f] if es == 0 else pos[es]
                    lo = p.to(torch.float32)
                    hi = (p + ext[es]).to(torch.float32)
                    t1 = [(lo[a] - o[a]) * iv[a] for a in range(3)]
                    t2 = [(hi[a] - o[a]) * iv[a] for a in range(3)]
                    near = c_min(t1[0], t2[0])
                    far = c_max(t1[0], t2[0])
                    for a in (1, 2):
                        near = c_max(near, c_min(t1[a], t2[a]))
                        far = c_min(far, c_max(t1[a], t2[a]))
                    occ |= rays & ~occ & (me != e) & (far >= near)
    return ~occ.view(shape)


@pytest.mark.parametrize("case", sorted(MARCHES))
def test_keyed_list_march_matches_capped_march(case):
    _, _, args = march_inputs(case)
    pos, ext, be, cnt, y, z, ent, inv, K, players, config, max_steps = args
    rb, origin = shade.surface_rays(y, z, config)
    lb = shadow_dir.pixel_light_bins(y, z, K, config)
    inv_b = tuple(inv[:, a].view(1, 1, 1) for a in range(3))
    got = keyed_list_march(pos, ext, be, cnt, rb, lb, ent, origin, inv_b,
                           players, config, max_steps)
    assert torch.equal(got, shadow_dir.trace_light_directional(*args))
    # A tile holds more than one (start bin, light bin) key.
    keys = torch.stack([t.reshape(-1) for t in (*rb, *lb)], 1)
    assert torch.unique(keys, dim=0).shape[0] > torch.unique(
        keys[:, :3], dim=0).shape[0]


def test_capped_visit_lists_stop_at_the_cap():
    starts = tuple(torch.tensor([v], dtype=torch.int32) for v in (0, 0, 0))
    light = (30, 0, 0)
    full = shadow.dda_visit_lists(starts, light, CAP)[0]
    capped = shadow.dda_visit_lists(starts, light, CAP, max_steps=3)[0]
    assert capped == full[:len(capped)] and 0 < len(capped) < len(full)


# -- render_states in every mode ----------------------------------------------

MODES = ["directional", "multi2", "multi3", "dithered_point",
         "dithered_directional", "dithered_multi"]


def small_scene(config=SMALL):
    b = SceneBuilder(config=config)
    b.insert((30, 20, 20), (20, 20, 20))
    for i in range(3):
        for j in range(3):
            b.insert((i * 24, 0, j * 24), (16, 16, 16))
    return b.build()


SCENES = {"small": small_scene, "demo": lambda: demo_world(4, SMALL)}


def mode_states(scene, mode, seed=0, n=2):
    """Seeded players and the mode's lights: (n, 3) int32 point lights,
    (n, L, 3) int32 lights or (n, 3) float32 directions."""
    rng = np.random.default_rng(seed)
    players = (scene.pos[0] + rng.integers(-10, 11, (n, 3))).astype(np.int32)

    def points(m):
        return np.stack([rng.integers(0, 80, m), rng.integers(30, 90, m),
                         rng.integers(0, 40, m)], -1).astype(np.int32)

    if mode.endswith("directional"):
        lights = np.asarray([[0.3, 1.0, -0.2], [-1.0, 0.8, 0.5]][:n],
                            np.float32)
    elif mode.endswith("multi") or mode.startswith("multi"):
        L = 2 if mode == "multi2" else 3
        lights = np.stack([points(L) for _ in range(n)])
    else:
        lights = points(n)
    return players, lights


def jax_scene(scene):
    return jdeferred.DeviceScene.from_scene(scene, SMALL)


def port_scene(jds):
    return DeviceScene.from_numpy({k: np.asarray(v) for k, v in
                                   jds._asdict().items() if v is not None},
                                  device="cpu")


def jax_reference(scene, players, lights, mode):
    """The JAX package's frames for ``mode`` (module docstring)."""
    style = "dithered" if mode.startswith("dithered") else "reference"
    jr = jdeferred.DeferredRenderer(SMALL, shadow_max_steps=8,
                                    trace_impl="jnp", shadow_impl="scan",
                                    style=style)
    jr.spans = jr.spans_for(scene)
    jds = jax_scene(scene)
    directional = mode.endswith("directional")
    if mode not in ("dithered_directional", "dithered_multi"):
        return np.asarray(janimation.AnimationRenderer(jr, SMALL)
                          .render_states(jds, jnp.asarray(players),
                                         jnp.asarray(lights),
                                         directional=directional))

    @jax.jit
    def one(player, light):
        sf = janimation.scene_with_player(jds, player)
        be, cnt = jr.build_bins(sf)
        gbuf = jr.trace(sf, be, cnt)
        pal = sf.palette[:, :3]
        if directional:
            return jshade.shade_directional(sf.pos, sf.ext, gbuf, be, cnt,
                                            light, SMALL, style="dithered",
                                            palette_rgb=pal)
        ambient = jnp.float32(SMALL.ambient)
        diffuse = jnp.zeros(gbuf.y.shape, jnp.float32)
        for li in range(light.shape[0]):
            # 8 steps cover every light bin of the 2 x 2 x 2 grid.
            fl = jshade.lighting_factor(sf.pos, sf.ext, gbuf, be, cnt,
                                        light[li], SMALL, 8, "scan",
                                        guard="none")
            diffuse = diffuse + jnp.maximum(fl - ambient, 0.0)
        factor = jnp.minimum(1.0, ambient + diffuse)
        return jdither.shade_dithered(gbuf.color, factor, pal)

    return np.stack([np.asarray(one(jnp.asarray(p), jnp.asarray(l)))
                     for p, l in zip(players, lights)])


def port_frames(scene, ds, players, lights, mode, fuse, cached=True,
                device="cpu"):
    style = "dithered" if mode.startswith("dithered") else "reference"
    r = DeferredRenderer(SMALL, style=style).configure_for(scene)
    r.fuse_trace_shadow = fuse
    cache = (StaticBins(scene.pos, scene.ext, 1, SMALL, r.spans,
                        device=device) if cached else None)
    return AnimationRenderer(r, SMALL, static_bins=cache).render_states(
        ds, torch.from_numpy(players).to(device),
        torch.from_numpy(lights).to(device),
        directional=mode.endswith("directional")).cpu().numpy()


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("scene_name", sorted(SCENES))
def test_render_states_modes_match_jax(scene_name, mode):
    scene = SCENES[scene_name]()
    players, lights = mode_states(scene, mode)
    ds = port_scene(jax_scene(scene))
    frames = port_frames(scene, ds, players, lights, mode, fuse=False,
                         cached=scene_name == "demo")
    assert frames.shape == (2, 80, 80, 3) and frames.dtype == np.uint8
    np.testing.assert_array_equal(
        frames, jax_reference(scene, players, lights, mode))
    # The fused setting renders these modes as the JAX package does: the
    # fused kernel for a point light, two kernels otherwise; same frames.
    np.testing.assert_array_equal(
        port_frames(scene, ds, players, lights, mode, fuse=True), frames)
    if mode.startswith("dithered"):
        palette = {tuple(c) for c in SMALL.palette_array[:, :3]}
        assert {tuple(c) for c in frames.reshape(-1, 3)} <= palette


@pytest.mark.parametrize("mode", ["directional", "multi3"])
def test_render_states_match_jax_batched_path(mode):
    """The JAX batched path (Pallas in interpret mode) agrees: directional
    frames on its extended tables, and three lights summed light by
    light."""
    scene = demo_world(4, SMALL)
    players, lights = mode_states(scene, mode, seed=3, n=1)
    jds = jax_scene(scene)
    # The guard off, as in tests/test_batched.py's directional test: the
    # comparison exercises the kernel's fast path, not the reroute, on
    # tables derived to cover the scene.
    jr = jdeferred.DeferredRenderer(
        SMALL, shadow_impl="pallas", trace_impl="auto",
        shadow_tables=shadow_fast.derive_tables(SMALL, scene),
        shadow_guard="none")
    jr.configure_for(scene)
    janim = janimation.AnimationRenderer(
        jr, SMALL, static_bins=JStaticBins(scene.pos, scene.ext, 1, SMALL,
                                           jr.spans), batched=True)
    assert janim._batched_capable(jds)
    directional = mode == "directional"
    want = np.asarray(janim.render_states(jds, jnp.asarray(players),
                                          jnp.asarray(lights),
                                          directional=directional))
    got = port_frames(scene, port_scene(jds), players, lights, mode,
                      fuse=False)
    np.testing.assert_array_equal(got, want)


def test_directional_multi_light_is_refused():
    scene = small_scene()
    ds = DeviceScene.from_scene(scene, SMALL, device="cpu")
    anim = AnimationRenderer(DeferredRenderer(SMALL).configure_for(scene),
                             SMALL)
    with pytest.raises(ValueError, match="directional"):
        anim.render_states(ds, ds.pos[:1],
                           torch.ones((1, 2, 3), dtype=torch.float32),
                           directional=True)


# -- on the card -------------------------------------------------------------

def wide_inputs(seed, config, F=2):
    """``(inputs, directions)``: seeded directional-kernel inputs whose
    surface points spread over many start and light bins (tiles with more
    keys than the table holds), background pixels, own entities and -1
    slots, and the (F, 3) float32 directions their ``inv`` and ``K`` come
    from."""
    rng = np.random.default_rng(seed)
    H, W, V, cap = (config.view_height, config.view_width,
                    config.hash_volume, config.bin_capacity)
    N = 60
    pos = rng.integers(-20, 100, (N, 3))
    pos[:, 0] = rng.integers(-20, W + 20, N)
    ext = rng.integers(1, 25, (N, 3))
    be = rng.integers(-1, N, (F, V, cap))
    cnt = rng.integers(0, 3 * cap, (F, V))
    y = rng.integers(-60, H + 60, (F, H, W))
    z = rng.integers(-60, config.view_length + 60, (F, H, W))
    bg = rng.random((F, H, W)) < 0.2
    y[bg], z[bg] = 0, 0
    d = rng.uniform(-1, 1, (F, 3)).astype(np.float32)
    d[0, 2] = 0.0  # an infinite inverse component
    _, inv, K = shadow_dir.direction_constants(torch.from_numpy(d), config)

    def i32(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.int32))

    args = (i32(pos), i32(ext), i32(be), i32(cnt), i32(y), i32(z),
            i32(rng.integers(-1, N, (F, H, W))), inv, K,
            i32(rng.integers(0, 80, (F, 3))), config,
            shadow_dir.grid_max_steps(config))
    return args, d


FINE = dataclasses.replace(SMALL, view_length=160, bin_size=10)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["small", "cap", "overflow"])
def test_cuda_directional_kernel_matches_plain(cuda, case):
    """Scene tiles take the list path only, and stage the union entries
    that ``shadow_dir.tile_unions`` counts; spread surface points overflow
    the table into the direct march; the cap binds on CAP."""
    if case == "overflow":
        args = wide_inputs(5, FINE)[0]
    else:
        args = march_inputs(case)[2]
    want = shadow_dir.trace_light_directional(*args)
    dev = tuple(a.to(cuda) if torch.is_tensor(a) else a for a in args)
    shadow_cuda.counters.reset()
    n = shadow_cuda.directional_launches
    got = shadow_cuda.trace_light_directional(*dev)
    torch.cuda.synchronize()
    stats = shadow_cuda.counters.read()
    assert shadow_cuda.directional_launches == n + 1
    assert torch.equal(got.cpu(), want)
    if case == "overflow":
        assert 0 < stats["direct_pixels"] < want.numel()
        assert stats["max_starts"] == shadow_dir.TABLE_KEYS + 1
    else:
        assert stats["direct_pixels"] == 0
        y, z, K, config, max_steps = args[4], args[5], args[8], *args[-2:]
        unions = shadow_dir.tile_unions(y, z, K, config, max_steps)
        assert stats["staged_entries"] == unions["staged"]
        assert stats["max_starts"] == unions["keys"]
        assert stats["max_list"] == unions["longest"]
    assert cap_binds(args) == (case == "cap")


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["directional", "multi3",
                                  "dithered_point", "dithered_directional"])
def test_cuda_modes_match_cpu(cuda, mode):
    scene = demo_world(4, SMALL)
    players, lights = mode_states(scene, mode, seed=2)
    out = []
    for dev in ("cpu", cuda):
        ds = DeviceScene.from_scene(scene, SMALL, device=dev)
        out.append(port_frames(scene, ds, players, lights, mode, fuse=True,
                               device=dev))
    np.testing.assert_array_equal(out[1], out[0])


@pytest.mark.cuda
def test_cuda_march_occupancy(cuda):
    """The G-buffer point mode takes the point march's block (56,048 B,
    4 blocks per SM on graybox); the directional mode's key masks and
    union list take a word per grid bin each, whatever the step cap."""
    graybox = RenderConfig()
    assert shadow_cuda.occupancy(graybox)[:2] == (56048, 4)
    for cfg in (SMALL, FINE, CAP, graybox):
        smem, blocks, regs, _ = shadow_cuda.directional_occupancy(cfg)
        assert smem <= shadow_cuda.MAX_SMEM
        assert blocks >= 1 and 0 < regs <= 255
    assert shadow_cuda.directional_occupancy(graybox)[:2] == (33848, 4)
