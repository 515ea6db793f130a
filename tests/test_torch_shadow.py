"""Port light geometry and the shadow march (``light_geometry``,
``trace_light_dynamic``, ``dda_visit_lists`` and the shadow kernel's
wrapper) against the JAX package.

Geometry must be bit-equal float32, lit masks equal, including a light
exactly on a surface point (0/0 -> NaN direction) and lights more than 16
bins away (beyond the JAX package's static step bound).  Visit lists must
equal the JAX package's DDA probe sets exactly, and an OR over them (the
kernels' list path, modelled here) must give the same lit masks."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from pixel_art_raytracer_tpu.config import RenderConfig
from pixel_art_raytracer_tpu.ops import shade as jshade
from pixel_art_raytracer_tpu.ops import shadow as jshadow
from pixel_art_raytracer_tpu.ops import shadow_fast
from pixel_art_raytracer_tpu.ops.trace import GBufferArrays as JGBuffer
from pixel_art_raytracer_tpu.scene import SceneBuilder
from pixel_art_raytracer_tpu_torch.models.deferred import DeviceScene
from pixel_art_raytracer_tpu_torch.ops import (binning, shade, shadow,
                                               shadow_cuda, trace_cuda, trace)
from pixel_art_raytracer_tpu_torch.runtime import kernels

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
        shadow_cuda.counters.reset()
        want.append(shadow_cuda.trace_light(ds.pos, ds.ext, be, cnt, rb, lb,
                                            gb.entity_index, origin, inv,
                                            ds.pos[:1], SMALL).cpu())
    assert torch.equal(want[0], want[1])
    # Every tile holds at most three start bins: the list path takes all.
    assert shadow_cuda.counters.read()["direct_pixels"] == 0


def lit_inputs(light):
    """One shadow_scene frame: port tables, G-buffer and light geometry."""
    scene = shadow_scene()
    ds, be, cnt, gb = traced(scene, SMALL)
    lxyz = surface_light(gb) if light == "on_surface" else LIGHTS[light]
    lights = torch.tensor([lxyz], dtype=torch.int32)
    _, inv, origin, rb, lb = shade.light_geometry(gb, lights, SMALL)
    return scene, ds, be, cnt, gb, inv, origin, rb, lb


def unique_starts(start_bin):
    """Distinct start bins (U, 3) and each ray's index into them."""
    keys = torch.stack([r.reshape(-1) for r in start_bin], dim=1)
    return torch.unique(keys, dim=0, return_inverse=True)


@pytest.mark.parametrize("light", sorted(LIGHTS) + ["on_surface"])
def test_visit_lists_match_jax_probe_flats(light):
    *_, rb, lb = lit_inputs(light)
    ukeys, inverse = unique_starts(rb)
    starts = tuple(ukeys.unbind(1))
    lbin = tuple(int(b) for b in lb)
    lists = shadow.dda_visit_lists(starts, lbin, SMALL)
    assert max(len(v) for v in lists) > 1

    # The JAX package's dense probe simulation, (7, K, P) in phase-major
    # order, with K steps covering every start's int(largest).
    K = max(1, int((torch.tensor(lbin) - ukeys).abs().max()))
    V = SMALL.hash_volume
    flats = np.asarray(shadow_fast._dda_probe_flats_from(
        *(jnp.asarray(s.numpy()) for s in starts), lbin, SMALL, K))
    flats = flats.reshape(7, K, -1).transpose(1, 0, 2).reshape(7 * K, -1)
    want = [list(dict.fromkeys(int(v) for v in flats[:, p] if v != V))
            for p in range(flats.shape[1])]
    assert lists == want

    # Each pixel's own probes, as the plain march makes them, give its
    # start bin's list.
    probes = torch.stack([torch.where(probe, flat, -1).reshape(-1)
                          for flat, probe in shadow.dda_probes(rb, lb,
                                                               SMALL)], 1)
    for p, row in enumerate(probes.tolist()):
        assert list(dict.fromkeys(v for v in row if v >= 0)) == \
            lists[int(inverse[p])]


def slab_hit_np(lo, hi, origin, inv):
    """The slab test in numpy float32, in the reference's min/max order."""
    c_min = lambda a, b: np.where(b < a, b, a)  # noqa: E731
    c_max = lambda a, b: np.where(a < b, b, a)  # noqa: E731
    with np.errstate(invalid="ignore", over="ignore"):
        t1 = [(lo[a] - origin[a]) * inv[a] for a in range(3)]
        t2 = [(hi[a] - origin[a]) * inv[a] for a in range(3)]
    near = c_min(t1[0], t2[0])
    far = c_max(t1[0], t2[0])
    for a in (1, 2):
        near = c_max(near, c_min(t1[a], t2[a]))
        far = c_min(far, c_max(t1[a], t2[a]))
    return far >= near


def list_march(pos, ext, bins_ent, counts, start_bin, end_bin, start_ent,
               origin, inv_dir, players, config):
    """A CPU model of the kernels' list path: every ray tests the boxes of
    its start bin's visit list in list order (raw ids; -1 tested as entity
    0), skipping its own entity.  Returns the lit mask."""
    F = bins_ent.shape[0]
    cap = config.bin_capacity
    occ = np.zeros(start_bin[0].shape, bool)
    for f in range(F):
        ukeys, inverse = unique_starts([r[f] for r in start_bin])
        lists = shadow.dda_visit_lists(
            tuple(ukeys.unbind(1)), [int(b.reshape(F)[f]) for b in end_bin],
            config)
        o = [t[f].reshape(-1).numpy() for t in origin]
        iv = [t[f].reshape(-1).numpy() for t in inv_dir]
        me = start_ent[f].reshape(-1).numpy()
        occ_f = occ[f].reshape(-1)
        for u, flats in enumerate(lists):
            mine = (inverse == u).numpy()
            for flat in flats:
                for k in range(min(int(counts[f, flat]), cap)):
                    e = int(bins_ent[f, flat, k])
                    es = max(e, 0)
                    p = (players[f] if es == 0 else pos[es]).numpy()
                    lo = p.astype(np.float32)
                    hi = (p + ext[es].numpy()).astype(np.float32)
                    test = mine & ~occ_f & (me != e)
                    occ_f |= test & slab_hit_np(lo, hi, o, iv)
    return torch.from_numpy(~occ)


@pytest.mark.parametrize("light", sorted(LIGHTS) + ["on_surface"])
def test_list_march_matches_port_and_jax(light):
    scene, ds, be, cnt, gb, inv, origin, rb, lb = lit_inputs(light)
    args = (ds.pos, ds.ext, be, cnt, rb, lb, gb.entity_index, origin, inv,
            ds.pos[:1], SMALL)
    got = list_march(*args)
    assert torch.equal(got, shadow.trace_light_dynamic(*args))
    jgb = JGBuffer(*(jnp.asarray(t[0].numpy()) for t in gb))
    jlit = jshadow.trace_light_dynamic(
        jnp.asarray(scene.pos), jnp.asarray(scene.ext), jnp.asarray(be[0]),
        jnp.asarray(cnt[0]), tuple(jnp.asarray(r[0].numpy()) for r in rb),
        tuple(int(b) for b in lb), jgb.entity_index,
        tuple(jnp.asarray(t[0].numpy()) for t in origin),
        tuple(jnp.asarray(t[0].numpy()) for t in inv), SMALL)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(jlit))
    assert not got.all() and got.any()


@pytest.mark.parametrize("occluder, every_probe, needed, lit", [
    (False, 6, 3, True),
    (True, 3, 3, False),
])
def test_slab_test_count_skips_repeated_probes(occluder, every_probe,
                                               needed, lit):
    """A ray from bin (0, 0, 0) toward light bin (1, 1, 0) probes bins
    (1, 0, 0), (0, 1, 0), the start (skipped), (1, 1, 0), then (1, 0, 0)
    and (0, 1, 0) again and (1, 1, 0) again.  Bin (1, 0, 0) holds one box
    and bin (0, 1, 0) two: six tests at every probe, three that the
    function needs.  With the second box of (0, 1, 0) in the ray's way,
    the ray stops there after three tests either way."""
    cfg = SMALL  # 2 x 2 x 2 bins
    flat = cfg.bin_flat_index
    pos = torch.tensor([[0, 0, 0], [100, 0, 0], [0, 100, 0],
                        [0, 0, 100]], dtype=torch.int32)
    if occluder:
        pos[3] = torch.tensor([5, 5, 5])
    ext = torch.ones((4, 3), dtype=torch.int32)
    be = torch.full((1, 8, cfg.bin_capacity), -1, dtype=torch.int32)
    cnt = torch.zeros((1, 8), dtype=torch.int32)
    be[0, flat(1, 0, 0), 0] = 1
    be[0, flat(0, 1, 0), :2] = torch.tensor([2, 3])
    cnt[0, flat(1, 0, 0)] = 1
    cnt[0, flat(0, 1, 0)] = 2

    def one(v, dt=torch.int32):
        return torch.full((1, 1, 1), v, dtype=dt)

    rb = (one(0), one(0), one(0))
    lb = (one(1), one(1), one(0))
    origin = (one(0.0, torch.float32),) * 3
    inv = (one(1.0, torch.float32),) * 3
    work = {}
    got = shadow.trace_light_dynamic(pos, ext, be, cnt, rb, lb, one(0),
                                     origin, inv, pos[:1], cfg, work=work)
    assert bool(got) == lit
    assert int(work["slab_tests_every_probe"]) == every_probe
    assert int(work["slab_tests"]) == needed
    assert int(work["slab_tests_finite"]) == needed  # inv is finite
    assert shadow.dda_visit_lists(tuple(r.reshape(1) for r in rb),
                                  (1, 1, 0), cfg) == [
        [flat(1, 0, 0), flat(0, 1, 0), flat(1, 1, 0)]]


# A config whose 10-pixel bins give long visit lists (an 8 x 8 x 16 grid).
FINE = RenderConfig(view_width=80, view_height=80, view_length=160,
                    bin_size=10)


def random_rays(seed, config, starts_per_tile, frames=2):
    """Seeded random inputs of ``shadow_cuda.trace_light``: start bins
    inside and outside the grid (so aliased flats), counts up to three times
    the capacity (quirk Q3), entity -1 slots and own entities, rays with
    zero and NaN direction components, light bins inside and outside the
    grid.  Each bin-column tile draws its pixels' start bins from
    ``starts_per_tile`` random bins, or each pixel its own with None."""
    rng = np.random.default_rng(seed)
    cfg = config
    F, H, W = frames, cfg.view_height, cfg.view_width
    V, cap, bs = cfg.hash_volume, cfg.bin_capacity, cfg.bin_size
    N = 60
    dims = np.array([cfg.hash_width, cfg.hash_height, cfg.hash_length])
    pos = rng.integers(-20, 100, (N, 3))
    pos[:, 2] = rng.integers(-20, cfg.view_length + 20, N)
    ext = rng.integers(1, 25, (N, 3))
    be = rng.integers(-1, N, (F, V, cap))
    cnt = rng.integers(0, 3 * cap, (F, V))
    players = rng.integers(0, 80, (F, 3))
    if starts_per_tile is None:
        rb = rng.integers(-2, dims + 2, (F, H, W, 3))
    else:
        ty, tx = np.arange(H)[:, None] // bs, np.arange(W)[None, :] // bs
        pool = rng.integers(-2, dims + 2,
                            (F, H // bs, W // bs, starts_per_tile, 3))
        pick = rng.integers(0, starts_per_tile, (F, H, W))
        rb = pool[np.arange(F)[:, None, None], ty, tx, pick]
    origin = rng.uniform(-10, 90, (F, H, W, 3))
    d = rng.uniform(-1, 1, (F, H, W, 3))
    d[rng.random(d.shape) < 0.05] = 0.0
    with np.errstate(divide="ignore"):
        inv = (1 / d.astype(np.float32)).astype(np.float32)
    inv[rng.random(inv.shape) < 0.02] = np.nan
    ent = rng.integers(-1, N, (F, H, W))
    lbin = rng.integers(-3, dims + 3, (F, 3))

    def i32(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.int32))

    def f32(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32))

    return (i32(pos), i32(ext), i32(be), i32(cnt),
            tuple(i32(rb[..., a]) for a in range(3)),
            tuple(i32(lbin[:, a].reshape(F, 1, 1)) for a in range(3)),
            i32(ent), tuple(f32(origin[..., a]) for a in range(3)),
            tuple(f32(inv[..., a]) for a in range(3)), i32(players), cfg)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["few", "overflow", "scattered"])
def test_cuda_kernel_matches_plain_on_random_rays(cuda, case):
    """Tiles of 3 start bins take the list path only; tiles of 6, or of a
    start bin a pixel, also the in-kernel direct march."""
    starts = {"few": 3, "overflow": 6, "scattered": None}[case]
    args = random_rays(7, FINE, starts)
    want = shadow.trace_light_dynamic(*args)
    dev = [tuple(t.to(cuda) for t in a) if isinstance(a, tuple)
           else a.to(cuda) if torch.is_tensor(a) else a for a in args]
    shadow_cuda.counters.reset()
    got = shadow_cuda.trace_light(*dev)
    torch.cuda.synchronize()
    stats = shadow_cuda.counters.read()
    assert torch.equal(got.cpu(), want)
    n_pix = want.numel()
    if case == "few":
        assert stats["direct_pixels"] == 0
        assert stats["max_starts"] == 3
    else:
        assert 0 < stats["direct_pixels"] < n_pix
        assert stats["max_starts"] == shadow_cuda.STARTS + 1
    if case == "few":
        # A list longer than one staged chunk: the chunk loop runs.
        assert stats["max_list"] > shadow_cuda.shade_chunk(FINE)


@pytest.mark.cuda
def test_cuda_shared_memory_matches_layout(cuda):
    for cfg in (SMALL, FINE, RenderConfig()):
        smem, blocks, regs, _ = shadow_cuda.occupancy(cfg)
        assert smem == shadow_cuda.shade_smem_bytes(cfg)
        assert blocks >= 1 and 0 < regs <= 255


def test_march_counters_sum_direct_pixels_and_max_the_rest():
    counters = kernels.MarchCounters()
    zero = {"direct_pixels": 0, "max_starts": 0, "max_list": 0,
            "staged_entries": 0, "slab_tests": 0, "shade_slab_tests": 0,
            "shade_marched_pixels": 0, "shade_pixels": 0,
            "light_slab_tests": 0, "light_marched_pixels": 0,
            "light_pixels": 0, "dir_pixels": 0, "dir_shade_pixels": 0,
            "dir_marched_pixels": 0}
    assert counters.read() == zero
    t = counters.tensor(torch.device("cpu"))
    assert counters.tensor(torch.device("cpu")) is t
    t += torch.tensor([5, 2, 29], dtype=torch.int32)
    w = counters.work(torch.device("cpu"))
    assert counters.work(torch.device("cpu")) is w and w.dtype == torch.int64
    w += torch.tensor([41, 3 << 32, 7 << 33, 5 << 31, 9 << 32, 3 << 31,
                       11 << 31])
    counters.shade_pixels += 64
    counters.light_pixels += 192
    counters.dir_pixels += 128
    counters.dir_shade_pixels += 96
    assert counters.read() == {"direct_pixels": 5, "max_starts": 2,
                               "max_list": 29, "staged_entries": 41,
                               "slab_tests": 3 << 32,
                               "shade_slab_tests": 7 << 33,
                               "shade_marched_pixels": 5 << 31,
                               "shade_pixels": 64,
                               "light_slab_tests": 9 << 32,
                               "light_marched_pixels": 3 << 31,
                               "light_pixels": 192, "dir_pixels": 128,
                               "dir_shade_pixels": 96,
                               "dir_marched_pixels": 11 << 31}
    counters.reset()
    assert counters.read() == zero
