"""The port's fused trace+shadow path (``ops/fused.trace_shadow``, the fused
kernel's wrapper and ``render_states`` with ``fuse_trace_shadow``) against
the JAX package's ops and fused path, the port's two-kernel path and the
C++ oracle.

The tolerance is exact: 0 differing pixels and 0 differing values, for
winners, best depths, surface points, lit masks and frames."""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from pixel_art_raytracer_tpu import config as jconfig
from pixel_art_raytracer_tpu import scene as jscene
from pixel_art_raytracer_tpu.models import animation as janimation
from pixel_art_raytracer_tpu.models import deferred as jdeferred
from pixel_art_raytracer_tpu.ops import binning as jbinning
from pixel_art_raytracer_tpu.ops import fused_pallas
from pixel_art_raytracer_tpu.ops import shade as jshade
from pixel_art_raytracer_tpu.ops import shadow as jshadow
from pixel_art_raytracer_tpu.ops import shadow_fast
from pixel_art_raytracer_tpu.ops import trace as jtrace
from pixel_art_raytracer_tpu.ops.static_bins import StaticBins as JStaticBins
from pixel_art_raytracer_tpu_torch import bench_scale, config, scene
from pixel_art_raytracer_tpu_torch.models import batched
from pixel_art_raytracer_tpu_torch.models.animation import AnimationRenderer
from pixel_art_raytracer_tpu_torch.models.deferred import (DeferredRenderer,
                                                           DeviceScene)
from pixel_art_raytracer_tpu_torch.models.supersample import scaled_config
from pixel_art_raytracer_tpu_torch.ops import (binning, fused, fused_cuda,
                                               shade, shadow, shadow_cuda,
                                               trace_cuda)
from pixel_art_raytracer_tpu_torch.ops import trace
from pixel_art_raytracer_tpu_torch.ops.static_bins import StaticBins
from pixel_art_raytracer_tpu_torch.runtime import native

JSMALL = jconfig.RenderConfig(view_width=80, view_height=80, view_length=80)


def port_config(jcfg):
    """The port's RenderConfig with the JAX config's field values."""
    return config.RenderConfig(**{f.name: getattr(jcfg, f.name)
                                  for f in dataclasses.fields(jcfg)})


SMALL = port_config(JSMALL)
DEFAULT = port_config(jconfig.DEFAULT_CONFIG)


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


def shadow_scene(config=SMALL, seed=0):
    """Floor tiles, a player box and seeded random occluders."""
    rng = np.random.default_rng(seed)
    b = scene.SceneBuilder(config=config)
    b.insert((30, 20, 20), (20, 20, 20))
    for i in range(4):
        for j in range(4):
            b.insert((i * 20, 0, j * 20), (20, 20, 20))
    for _ in range(12):
        b.insert(tuple(int(v) for v in rng.integers(0, 70, 3)),
                 (int(rng.integers(2, 15)), int(rng.integers(2, 15)),
                  int(rng.integers(2, 15))))
    return b.build()


def depth_spread_scene(config):
    """Boxes spread over the whole z range with mixed heights
    (tests/test_batched.py::test_fused_depth_spread_scene)."""
    b = scene.SceneBuilder(config=config)
    b.insert((config.view_width // 2, 36, config.view_length // 4),
             (20, 20, 20))
    for i in range(12):
        for j in range(14):
            y = (i * 5 + j * 11) % 3 * 20
            b.insert((i * 40, y, j * 22), (20, 20, 20))
    return b.build()


PLAYERS = np.array([[30, 20, 20], [10, 0, 45]], np.int32)
LIGHTS = {
    "near": [[60, 60, 20], [20, 70, 5]],
    "grazing": [[0, 80, 79], [79, 80, 0]],
    "far": [[800, 60, 20], [-700, 300, 700]],
}


def port_tables(s, players, config):
    """Per-frame bin tables of scene ``s`` with entity 0 at ``players[f]``,
    (F, V, cap) and (F, V)."""
    spans = binning.entity_span_bound(s.ext.max(axis=0), config)
    tables = []
    for p in players:
        pos = torch.from_numpy(s.pos.copy())
        pos[0] = torch.from_numpy(p)
        tables.append(binning.build_bins(pos, torch.from_numpy(s.ext),
                                         config, spans))
    return (torch.stack([b for b, _ in tables]),
            torch.stack([c for _, c in tables]))


@pytest.mark.parametrize("light", sorted(LIGHTS))
def test_plain_matches_jax_ops(light):
    s = shadow_scene()
    ds = DeviceScene.from_scene(s, SMALL, device="cpu")
    be, cnt = port_tables(s, PLAYERS, SMALL)
    players = torch.from_numpy(PLAYERS)
    lights = torch.tensor(LIGHTS[light], dtype=torch.int32)
    best, win, lit = fused.trace_shadow(ds.pos, ds.ext, ds.sprite_id,
                                        ds.atlas_depth, be, cnt, players,
                                        lights, SMALL)
    y, z, ent, _ = trace.decode_winner(win, ds.pos, ds.ext, ds.sprite_id,
                                       ds.atlas_depth, players, SMALL)
    assert not lit.all() and lit.any()

    a = s.atlas
    for f in range(len(PLAYERS)):
        pos = s.pos.copy()
        pos[0] = PLAYERS[f]
        jpos, jext = jnp.asarray(pos), jnp.asarray(s.ext)
        spans = jbinning.entity_span_bound(s.ext.max(axis=0), JSMALL)
        jbe, jcnt = jbinning.build_bins(jpos, jext, JSMALL, spans)
        sid = jnp.asarray(s.sprite_id)
        jbest, jwin = jtrace.trace_winner(jpos, jext, sid,
                                          jnp.asarray(a.depth), jbe, jcnt,
                                          JSMALL)
        jgb = jtrace.materialize_gbuffer(
            jwin, jpos, jext, sid, jnp.asarray(a.color),
            jnp.asarray(a.depth), jnp.asarray(a.normal),
            jnp.asarray(JSMALL.palette_array), JSMALL)
        _, jinv, jorigin, jrb, jlb = jshade.light_geometry(
            jgb, jnp.asarray(LIGHTS[light][f], jnp.int32), JSMALL)
        jlit = jshadow.trace_light_dynamic(jpos, jext, jbe, jcnt, jrb, jlb,
                                           jgb.entity_index, jorigin, jinv,
                                           JSMALL)
        for name, got, want in (("best", best, jbest), ("winner", win, jwin),
                                ("y", y, jgb.y), ("z", z, jgb.z),
                                ("entity", ent, jgb.entity_index),
                                ("lit", lit, jlit)):
            np.testing.assert_array_equal(got[f].numpy(), np.asarray(want),
                                          err_msg=f"{name} frame {f}")


def port_anim(s, config, cached=True):
    r = DeferredRenderer(config).configure_for(s)
    cache = (StaticBins(s.pos, s.ext, 1, config, r.spans, device="cpu")
             if cached else None)
    return AnimationRenderer(r, config, static_bins=cache)


def render(anim, ds, players, lights, fuse: bool) -> np.ndarray:
    anim.renderer.fuse_trace_shadow = fuse
    return anim.render_states(ds, torch.as_tensor(players),
                              torch.as_tensor(lights)).numpy()


@pytest.mark.parametrize("cached", [True, False])
@pytest.mark.parametrize("case", ["shadow_scene", "demo4"])
def test_fused_path_matches_two_kernel_path(case, cached):
    s = (shadow_scene() if case == "shadow_scene"
         else scene.demo_world(4, SMALL))
    ds = DeviceScene.from_scene(s, SMALL, device="cpu")
    anim = port_anim(s, SMALL, cached)
    players = PLAYERS.copy()
    players[0] = s.pos[0]
    lights = np.array(LIGHTS["near"], np.int32)
    launches = fused_cuda.launches
    two = render(anim, ds, players, lights, fuse=False)
    one = render(anim, ds, players, lights, fuse=True)
    assert fused_cuda.launches == launches  # CPU tensors: plain version
    np.testing.assert_array_equal(one, two)


def test_fused_path_matches_jax_fused_kernel(monkeypatch):
    """The JAX package's fused path runs the real ``_fused_kernel`` (in
    interpret mode on the CPU), as tests/test_batched.py does."""
    calls = []
    real = fused_pallas.fused_call_batched

    def counted(*args, **kwargs):
        calls.append(1)
        return real(*args, **kwargs)

    monkeypatch.setattr(fused_pallas, "fused_call_batched", counted)
    jcfg = jconfig.DEFAULT_CONFIG
    js = jscene.demo_world(10)
    tables = shadow_fast.default_tables(jcfg, max_candidates=1024)
    jr = jdeferred.DeferredRenderer(jcfg, shadow_impl="pallas",
                                    trace_impl="auto", shadow_tables=tables)
    jr.configure_for(js)
    jr.fuse_trace_shadow = True
    janim = janimation.AnimationRenderer(
        jr, jcfg, static_bins=JStaticBins(js.pos, js.ext, 1, jcfg, jr.spans),
        batched=True)
    light = jscene.default_light(jcfg)
    players, lights = janim.light_sweep_states(
        2, js.pos[0], center=(light.x, light.y, light.z), radius=40)
    players = players.at[1, 0].add(25)  # the player moves in frame 1
    jds = jdeferred.DeviceScene.from_scene(js)
    want = np.asarray(janim.render_states(jds, players, lights))
    assert calls, "the JAX path did not reach _fused_kernel"

    s = scene.demo_world(10, DEFAULT)
    ds = DeviceScene.from_numpy({k: np.asarray(v) for k, v in
                                 jds._asdict().items() if v is not None},
                                device="cpu")
    got = render(port_anim(s, DEFAULT), ds, np.array(players),
                 np.array(lights), fuse=True)
    assert got.shape == want.shape == (2, 320, 480, 3)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("case", ["far_light", "l1_beyond_2_13",
                                  "depth_spread"])
def test_fused_path_matches_cpp(case):
    """Lights outside the JAX fused kernel's domain (its static 16-bin step
    bound, its L1 < 2**13 division domain) and the depth-spread scene."""
    if case == "depth_spread":
        cfg = DEFAULT
        s = depth_spread_scene(cfg)
        players = np.stack([s.pos[0], s.pos[0] + [25, 0, 0]]).astype(np.int32)
        lights = np.array([[480, 160, 80], [440, 160, 60]], np.int32)
    elif case == "far_light":
        cfg = SMALL
        s = shadow_scene()
        players = PLAYERS
        lights = np.array([[60, 60, 20], [2000, 900, 80]], np.int32)
    else:
        cfg = SMALL
        s = shadow_scene()
        players = PLAYERS
        lights = np.array([[4200, 4150, -4100], [-8400, 60, 20]], np.int32)
        for f in range(2):  # every pixel's L1 distance to the light
            assert np.abs(lights[f]).sum() - 3 * 80 >= 2 ** 13
    ds = DeviceScene.from_scene(s, cfg, device="cpu")
    frames = render(port_anim(s, cfg), ds, players, lights, fuse=True)
    for f in range(2):
        pos = s.pos.copy()
        pos[0] = players[f]
        golden, _ = native.cpp_render_frame(s.replace_pos(pos),
                                            scene.Light(*map(int, lights[f])),
                                            cfg)
        bad = int((frames[f] != golden).any(axis=-1).sum())
        assert bad == 0, f"frame {f}: {bad} pixels differ"


def test_wrapper_refuses_other_devices_and_sizes_shared_memory():
    s = shadow_scene()
    ds = DeviceScene.from_scene(s, SMALL, device="meta")
    be, cnt = (t.to("meta") for t in port_tables(s, PLAYERS, SMALL))
    players = torch.from_numpy(PLAYERS).to("meta")
    with pytest.raises(ValueError, match="no kernel"):
        fused_cuda.trace_shadow(ds.pos, ds.ext, ds.sprite_id, ds.atlas_depth,
                                be, cnt, players, players, SMALL)
    # The block is the point march's (shadow_cuda.shade_smem_bytes) at the
    # most staged list entries, up to 32, at which 4 blocks fit an SM: a
    # head of `chunk` staged entries of 8 boxes of 32 B, 11 x 4 start bins
    # of 8 B (each warp's and the band's), 4 key states of 64 B, the
    # entries' live counts and bins, 10 warps' counts and 4 table indices,
    # 2 control ints and a mask of `words` words per start bin; then 29 B
    # for each of the 1,600 pixels of a band, which hold the walk's
    # per-pixel state first; then the column's 8 bins of 65 ints.  The
    # walk's draw list (4 + 16 * 64 ints) fits the head.
    def march_head(chunk, words):
        return (32 * chunk * 8 + 8 * 11 * 4 + 64 * 4
                + 4 * (2 * chunk + 10 + 10 * 4 + 2) + 4 * 4 * words)

    column = 4 * 8 * 65
    assert trace_cuda.draw_bytes(DEFAULT) == 4 * (4 + 16 * 64) \
        < march_head(29, 24)
    assert fused_cuda.smem_bytes(DEFAULT) == (march_head(29, 24)
                                              + 29 * 1600 + column) == 57336
    # 29 entries keep 4 blocks on an SM, 30 would not.
    for chunk, fits in ((29, True), (30, False)):
        assert (shadow_cuda.MARCH_BLOCKS_PER_SM
                * (fused_cuda.smem_bytes(DEFAULT, chunk)
                   + shadow_cuda.BLOCK_RESERVED_SMEM)
                <= shadow_cuda.SM_SMEM) == fits
    # 80- and 160-pixel tiles take bands of 1,600 pixels, so the block is
    # graybox's on graybox's grid; on config 5's 26 x 26 x 8 grid the
    # masks take 169 words, and 20 entries keep 4 blocks on an SM.
    for s in (2, 4):
        assert fused_cuda.smem_bytes(scaled_config(DEFAULT, s)) == 57336
    config5 = config.RenderConfig(1024, 1024, 320)
    for s in (1, 2, 4):
        assert fused_cuda.smem_bytes(scaled_config(config5, s)) == (
            march_head(20, 169) + 29 * 1600 + column) == 57280


def port_kernel_inputs(s, config, device, lights):
    ds = DeviceScene.from_scene(s, config, device=device)
    be, cnt = (t.to(device) for t in port_tables(s, PLAYERS, config))
    return (ds.pos, ds.ext, ds.sprite_id, ds.atlas_depth, be, cnt,
            torch.from_numpy(PLAYERS).to(device),
            torch.tensor(lights, dtype=torch.int32, device=device), config)


@pytest.mark.cuda
@pytest.mark.parametrize("light", sorted(LIGHTS) + ["on_surface"])
def test_cuda_kernel_matches_plain(cuda, light):
    s = shadow_scene()
    if light == "on_surface":
        # A light exactly on a surface point of each frame (0/0 -> NaN).
        args = port_kernel_inputs(s, SMALL, "cpu", LIGHTS["near"])
        _, win, _ = fused.trace_shadow(*args)
        y, z, _, _ = trace.decode_winner(win, *args[:4], args[6], SMALL)
        lxyz = []
        for f in range(len(PLAYERS)):
            j, i = (int(v) for v in torch.nonzero(win[f] > 0)[0])
            lxyz.append([i, int(y[f, j, i]), int(z[f, j, i])])
    else:
        lxyz = LIGHTS[light]
    want = fused.trace_shadow(*port_kernel_inputs(s, SMALL, "cpu", lxyz))
    launches = fused_cuda.launches
    fused_cuda.counters.reset()
    got = fused_cuda.trace_shadow(*port_kernel_inputs(s, SMALL, cuda, lxyz),
                                  with_best=True)
    torch.cuda.synchronize()
    assert fused_cuda.launches == launches + 1
    for name, g, w in zip(("best", "winner", "lit"), got, want):
        assert torch.equal(g.cpu(), w), name
    assert fused_cuda.counters.read()["direct_pixels"] == 0


@pytest.mark.cuda
def test_cuda_kernels_render_a_21632_bin_grid(cuda):
    """One frame of the config-5 scene generator on a 2048**2 view at bin
    40 (52 x 52 x 8 bins, the grid of test_torch_shade_march's
    test_cuda_shade_point_renders_a_21632_bin_grid, past the ~12,800 bins
    the tile-sized march took): the fused kernel and the G-buffer point
    mode of shadow.cu equal their plain versions."""
    cfg = config.RenderConfig(view_width=2048, view_height=2048,
                              view_length=320)
    assert cfg.hash_volume == 21_632
    assert fused_cuda.smem_bytes(cfg) <= fused_cuda.MAX_SMEM
    s = bench_scale.config5_scene(config=cfg)
    r = DeferredRenderer(cfg).configure_for(s)
    ds = DeviceScene.from_scene(s, cfg, device=cuda)
    cache = StaticBins(s.pos, s.ext, 1, cfg, r.spans, device=cuda)
    players = torch.tensor(s.pos[:1], device=cuda)
    lights = torch.tensor([[1024, 400, 160]], dtype=torch.int32, device=cuda)
    be, cnt = batched.bin_stage(r, cache, ds, players)
    # The plain versions run on the card's tensors: on the host they take
    # minutes at 2048**2.
    fargs = (ds.pos, ds.ext, ds.sprite_id, ds.atlas_depth, be, cnt, players,
             lights, cfg)
    got = fused_cuda.trace_shadow(*fargs, with_best=True)
    for name, g, w in zip(("best", "winner", "lit"), got,
                          fused.trace_shadow(*fargs)):
        assert torch.equal(g, w), name
    gbuf = batched.trace_stage(r, ds, be, cnt, players)
    _, inv, origin, rb, lb = shade.light_geometry(gbuf, lights, cfg)
    sargs = (ds.pos, ds.ext, be, cnt, rb, lb, gbuf.entity_index, origin,
             inv, players, cfg)
    lit = shadow_cuda.trace_light(*sargs)
    assert bool(lit.any()) and bool((~lit).any())
    assert torch.equal(lit, shadow.trace_light_dynamic(*sargs))


# 10-pixel bins over a deep view: a bin column's pixels see surfaces in
# many z bins, so its tile has more start bins than the table holds.
FINE = dataclasses.replace(SMALL, view_length=160, bin_size=10)


def deep_scene(config=FINE, seed=3):
    """A player box and seeded small boxes spread over the whole depth."""
    rng = np.random.default_rng(seed)
    b = scene.SceneBuilder(config=config)
    b.insert((30, 20, 20), (10, 10, 10))
    for _ in range(160):
        b.insert((int(rng.integers(0, 76)), int(rng.integers(0, 60)),
                  int(rng.integers(0, 150))),
                 tuple(int(v) for v in rng.integers(3, 11, 3)))
    return b.build()


def start_bins_per_band(args):
    """The most distinct start bins of one band of a bin-column tile (the
    point march's block: ``trace_cuda.band_rows`` rows), from the plain
    version's surface points."""
    cfg = args[-1]
    bs = cfg.bin_size
    _, win, _ = fused.trace_shadow(*args)
    y, z, _, _ = trace.decode_winner(win, *args[:4], args[6], cfg)
    F, H, W = win.shape
    i = torch.arange(W).expand(F, H, W)
    keys = torch.stack([torch.div(t, bs, rounding_mode="trunc")
                        for t in (i, cfg.view_height - y - z, z)], -1)
    tiles = keys.reshape(F, H // bs, bs, W // bs, bs, 3).permute(
        0, 1, 3, 2, 4, 5)
    return max(len(torch.unique(b.reshape(-1, 3), dim=0))
               for band in tiles.split(trace_cuda.band_rows(cfg), dim=3)
               for b in band.reshape(-1, band.shape[3] * bs, 3))


def test_deep_scene_tiles_overflow_the_start_table():
    args = port_kernel_inputs(deep_scene(), FINE, "cpu", LIGHTS["near"])
    assert start_bins_per_band(args) > shadow_cuda.STARTS


@pytest.mark.cuda
@pytest.mark.parametrize("light", sorted(LIGHTS))
def test_cuda_kernel_matches_plain_on_many_start_bins(cuda, light):
    s = deep_scene()
    want = fused.trace_shadow(*port_kernel_inputs(s, FINE, "cpu",
                                                  LIGHTS[light]))
    fused_cuda.counters.reset()
    got = fused_cuda.trace_shadow(*port_kernel_inputs(s, FINE, cuda,
                                                      LIGHTS[light]),
                                  with_best=True)
    torch.cuda.synchronize()
    for name, g, w in zip(("best", "winner", "lit"), got, want):
        assert torch.equal(g.cpu(), w), name
    stats = fused_cuda.counters.read()
    assert 0 < stats["direct_pixels"] < want[2].numel()
    assert stats["max_starts"] == shadow_cuda.STARTS + 1


@pytest.mark.cuda
def test_cuda_shared_memory_matches_layout(cuda):
    for cfg in (SMALL, FINE, DEFAULT, scaled_config(SMALL, 2),
                scaled_config(SMALL, 4),
                scaled_config(config.RenderConfig(1024, 1024, 320), 4)):
        smem, blocks, regs, _ = fused_cuda.occupancy(cfg)
        assert smem == fused_cuda.smem_bytes(cfg)
        assert blocks >= 1 and 0 < regs <= 255


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["dense", "tie", "early_exit",
                                  "empty_reset", "ragged", "multi_frame",
                                  "dense7_s2", "dense7_s4", "early_exit_s4",
                                  "ragged_s2"])
def test_cuda_kernel_matches_plain_on_walk_scenes(cuda, case):
    """The trace tests' scenes of the walk (tests/test_torch_trace.py
    kernel_inputs), the supersampled ones (``_s2``, ``_s4``) walked and
    marched in bands: winners, best depths and lit masks."""
    from test_torch_trace import kernel_inputs
    args = kernel_inputs(case, "cpu")
    F = args[4].shape[0]
    lights = torch.tensor([[60, 60, 20], [20, 70, 5], [70, 10, 60]][:F],
                          dtype=torch.int32)
    cfg = args[-1]
    want = fused.trace_shadow(*args[:-1], lights, cfg)
    got = fused_cuda.trace_shadow(
        *(t.to(cuda) for t in args[:-1]), lights.to(cuda), cfg,
        with_best=True)
    torch.cuda.synchronize()
    for name, g, w in zip(("best", "winner", "lit"), got, want):
        assert torch.equal(g.cpu(), w), name


@pytest.mark.cuda
def test_cuda_graybox_block_keeps_four_blocks_per_sm(cuda):
    """The walk's state and draw list reuse the march's shared memory, and
    the staged chunk is the most that leaves room for the column, so the
    graybox block takes 57,336 B at 4 blocks per SM."""
    smem, blocks, _, _ = fused_cuda.occupancy(DEFAULT)
    assert smem == 57336
    assert blocks >= 4
    # Config 5 at s = 4: one band of 1,600 pixels a block, 4 blocks per SM.
    smem, blocks, _, _ = fused_cuda.occupancy(
        scaled_config(config.RenderConfig(1024, 1024, 320), 4))
    assert smem == 57280 and blocks >= 4
