"""The directional mode of ``csrc/shadow.cu`` modelled on the CPU.

The kernel marches a bin-column tile over one union of its keys' visit
lists: the tile's distinct (start bin, light bin) keys of the pixels whose
key fits the packed fields (``ops/shadow_dir.key_fields``), the distinct
bins of their lists in flat order, each with a mask of the keys that visit
it, and every pixel walking the union in that order, testing an entry only
where the mask holds its key, skipping its own entity and stopping at its
first hit.  A pixel whose key does not fit marches its own list.

:func:`union_march` is that walk in numpy.  It is held, bit for bit
(tolerance zero), to the port's plain version
(``ops/shadow_dir.trace_light_directional``) and to the JAX package's
``shade_directional`` on the CPU; its staged entries to
``ops/shadow_dir.tile_unions``, which ``chip_smoke.py`` holds the kernel's
counter to.  The CUDA-marked tests hold the kernel's lit mask and its
counters (staged entries, slab tests performed) to it on the card, and
the direct march's slab tests to the plain march's count.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pixel_art_raytracer_tpu.config import RenderConfig
from pixel_art_raytracer_tpu.ops import shade as jshade
from pixel_art_raytracer_tpu.ops.trace import GBufferArrays
from pixel_art_raytracer_tpu_torch.models.supersample import scaled_config
from pixel_art_raytracer_tpu_torch.ops import shadow, shadow_cuda, shadow_dir
from test_torch_lights import (CAP, FINE, MARCHES, SMALL, march_inputs,
                               occluder_scene, traced, wide_inputs)

# Tiles of 80 x 80 pixels: 6,400 a tile, so the kernel's threads take their
# pixels in several rounds of registers.
BIG = RenderConfig(view_width=160, view_height=160, view_length=160,
                   bin_size=80)
FINE_DIRECTIONS = ((0.3, 1.0, -0.2), (-1.0, 0.2, 0.6))
# A config whose packed key needs more than KEY_BITS bits.
HUGE = RenderConfig(view_width=1 << 20, view_height=1 << 20,
                    view_length=1 << 20, bin_size=1)


@pytest.fixture(autouse=True)
def one_thread():
    """One PyTorch thread a test: the suite runs in several workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def scene_inputs(config, directions):
    """Directional inputs of the occluder scene on ``config``, one frame a
    direction, the player at home."""
    ds, be, cnt, gb = traced(occluder_scene(config), config)
    F = len(directions)
    d = torch.tensor(directions, dtype=torch.float32)
    _, inv, K = shadow_dir.direction_constants(d, config)

    def rep(t):
        return t.expand(F, *t.shape[1:]).contiguous()

    return (ds.pos, ds.ext, rep(be), rep(cnt), rep(gb.y), rep(gb.z),
            rep(gb.entity_index), inv, K, rep(ds.pos[:1]), config,
            shadow_dir.grid_max_steps(config))


def case_inputs(case):
    """``(inputs of trace_light_directional, (F, 3) directions)``."""
    if case in MARCHES:
        return march_inputs(case)[2], np.float32([MARCHES[case][1]])
    if case == "fine":
        return (scene_inputs(FINE, FINE_DIRECTIONS),
                np.float32(FINE_DIRECTIONS))
    if case == "big":
        return scene_inputs(BIG, FINE_DIRECTIONS), np.float32(FINE_DIRECTIONS)
    if case == "flipped":
        # Boxes with negative extents: a box's low corner lies above its
        # high one on some axes.
        (pos, ext, *rest), d = wide_inputs(7, FINE)
        ext = ext.clone()
        ext[::2, ::2] *= -1
        return (pos, ext, *rest), d
    return wide_inputs(5, FINE)


CASES = ["small", "small_grazing", "cap", "fine", "wide", "flipped", "big"]


def c_div(a, b):
    """C's truncating division of int64 arrays by b > 0."""
    return np.where(a < 0, -((-a) // b), a // b)


def slab_hit(lo, hi, o, iv):
    """The reference's slab test in float32, std::min/std::max order."""
    def cmin(a, b):
        return np.where(b < a, b, a)

    def cmax(a, b):
        return np.where(a < b, b, a)

    with np.errstate(invalid="ignore", over="ignore"):
        t1 = [(lo[a] - o[a]) * iv[a] for a in range(3)]
        t2 = [(hi[a] - o[a]) * iv[a] for a in range(3)]
    near = cmin(t1[0], t2[0])
    far = cmax(t1[0], t2[0])
    for a in (1, 2):
        near = cmax(near, cmin(t1[a], t2[a]))
        far = cmin(far, cmax(t1[a], t2[a]))
    return far >= near


def union_march(pos, ext, bins_ent, counts, gbuf_y, gbuf_z, start_ent, inv,
                K, players, config, max_steps):
    """numpy model of the directional kernel.

    Returns ``(lit, staged, tests, keys)``: the (F, H, W) lit mask, the
    union entries summed over the tiles, the slab tests of the pixels whose
    key fits, and the most keys in a tile (the kernel's table holds
    ``shadow_dir.TABLE_KEYS``: the counts are the kernel's where no tile
    holds more).
    """
    pos, ext, be, cnt, y, z, me, inv, K, players = (
        t.numpy().astype(np.int64) if t.dtype != torch.float32 else t.numpy()
        for t in (pos, ext, bins_ent, counts, gbuf_y, gbuf_z, start_ent,
                  inv, K, players))
    cfg = config
    F, H, W = y.shape
    bs, cap, V = cfg.bin_size, cfg.bin_capacity, cfg.hash_volume
    f = np.broadcast_to(np.arange(F)[:, None, None], (F, H, W)).reshape(-1)
    j = np.broadcast_to(np.arange(H)[None, :, None], (F, H, W)).reshape(-1)
    i = np.broadcast_to(np.arange(W)[None, None, :], (F, H, W)).reshape(-1)
    y, z, me = y.reshape(-1), z.reshape(-1), me.reshape(-1)
    hy = H - y - z
    kx, ky, kz = K[f, 0], K[f, 1], K[f, 2]
    start = (c_div(i, bs), c_div(hy, bs), c_div(z, bs))
    light = (c_div(i + kx, bs), c_div(hy - (ky + kz), bs),
             c_div(z + kz, bs))

    # Each distinct key's visit list, as a (keys, V) membership matrix.
    keys, key_of = np.unique(np.stack([*start, *light], 1), axis=0,
                             return_inverse=True)
    key_of = key_of.reshape(-1)
    kt = torch.from_numpy(keys.astype(np.int32))
    flats, first = shadow.dda_first_visits(
        tuple(kt[:, a] for a in range(3)), tuple(kt[:, a] for a in (3, 4, 5)),
        cfg, max_steps)
    visits = np.zeros((len(keys), V), bool)
    rows = np.broadcast_to(np.arange(len(keys)), flats.shape)
    visits[rows[first.numpy()], flats[first].numpy()] = True

    # Groups of pixels that walk one union: a tile's fitting pixels, or the
    # pixels of one key that does not fit (marched on its own).
    values = (start[1], start[2], light[0] - start[0], light[1] - start[1],
              light[2] - start[2])
    fits = np.ones_like(y, bool)
    for v, (lo, bits) in zip(values, shadow_dir.key_fields(cfg)):
        fits &= (v >= lo) & (v < lo + (1 << bits))
    tile = (f * cfg.hash_width + i // bs) * cfg.hash_height + j // bs
    groups, group_of = np.unique(
        np.stack([tile, np.where(fits, -1, key_of)], 1), axis=0,
        return_inverse=True)
    group_of = group_of.reshape(-1)
    pairs = np.unique(np.stack([group_of, key_of], 1), axis=0)
    union = np.zeros((len(groups), V), bool)
    np.logical_or.at(union, pairs[:, 0], visits[pairs[:, 1]])
    fitting_group = groups[:, 1] < 0
    staged = int(union[fitting_group].sum())
    most_keys = int(np.bincount(pairs[fitting_group[pairs[:, 0]], 0]).max())
    # Each group's union in flat order (padded past its length).
    length = union.sum(1)
    lists = np.argsort(~union, axis=1, kind="stable")[:, :length.max()]

    # The walk: entry r of each pixel's union, every slot in order, for the
    # pixels not yet occluded whose key visits the entry.
    o = np.stack([i, y, z]).astype(np.float32)
    iv = inv[f].T
    occ = np.zeros(y.shape, bool)
    tests = 0
    remaining = length[group_of]
    for r in range(lists.shape[1]):
        px = np.flatnonzero((remaining > r) & ~occ)
        flat = lists[group_of[px], r]
        keep = visits[key_of[px], flat]
        px, flat = px[keep], flat[keep]
        fp = f[px]
        live = np.minimum(cnt[fp, flat], cap)
        hit = np.zeros(px.shape, bool)
        for k in range(cap):
            e = be[fp, flat, k]
            act = ~hit & (k < live) & (e != me[px])
            tests += int((act & fits[px]).sum())
            es = np.maximum(e, 0)
            p = np.where((es == 0)[:, None], players[fp], pos[es])
            lo = p.astype(np.float32).T
            hi = (p + ext[es]).astype(np.float32).T
            hit |= act & slab_hit(lo, hi, o[:, px], iv[:, px])
        occ[px] |= hit
    return torch.from_numpy(~occ.reshape(F, H, W)), staged, tests, most_keys


def jax_lit(args, directions):
    """The lit mask of the JAX package's ``shade_directional`` on these
    inputs, frame by frame: a white G-buffer whose normals face the light
    shades a lit pixel 255 and a shadowed one the ambient's 63."""
    pos, ext, be, cnt, y, z, ent, _, _, players, cfg, steps = args
    F, H, W = y.shape
    lit = []
    for f in range(F):
        pos_f = pos.numpy().copy()
        pos_f[0] = players[f].numpy()  # entity 0 moves with the player
        normal = np.broadcast_to(np.sign(directions[f]).astype(np.float32),
                                 (H, W, 3))
        gbuf = GBufferArrays(
            normal=jnp.asarray(normal),
            color=jnp.full((H, W, 4), 255, jnp.uint8),
            y=jnp.asarray(y[f].numpy()), z=jnp.asarray(z[f].numpy()),
            entity_index=jnp.asarray(ent[f].numpy()))
        rgb = jshade.shade_directional(
            jnp.asarray(pos_f), jnp.asarray(ext.numpy()),
            gbuf, jnp.asarray(be[f].numpy()), jnp.asarray(cnt[f].numpy()),
            jnp.asarray(directions[f]), cfg, steps)
        rgb = np.asarray(rgb)
        assert set(np.unique(rgb)) <= {63, 255}
        lit.append(rgb[..., 0] == 255)
    return np.stack(lit)


@pytest.mark.parametrize("case", CASES)
def test_union_march_matches_plain_and_jax(case):
    args, directions = case_inputs(case)
    lit, staged, tests, keys = union_march(*args)
    plain = shadow_dir.trace_light_directional(*args)
    assert torch.equal(lit, plain)
    np.testing.assert_array_equal(lit.numpy(), jax_lit(args, directions))
    assert not plain.all() and plain.any()
    assert 0 < staged and 0 < tests
    if case in ("wide", "flipped"):
        # Tiles with more keys than the table holds, and pixels whose key
        # does not fit the fields; frame 0 has an infinite reciprocal
        # direction component, frame 1 none.
        assert keys > shadow_dir.TABLE_KEYS
        assert not args[7][0].isfinite().all() and args[7][1].isfinite().all()


# The union entries and per-key list entries of each case (the kernel
# stages the first; a march over per-key lists stages the second).
STAGED = {"small": (18, 57), "small_grazing": (23, 101), "cap": (55, 281),
          "fine": (5361, 14356)}


@pytest.mark.parametrize("case", sorted(STAGED))
def test_tile_unions_count_the_union_entries(case):
    args, _ = case_inputs(case)
    _, staged, _, keys = union_march(*args)
    y, z, K, cfg, steps = args[4], args[5], args[8], args[10], args[11]
    unions = shadow_dir.tile_unions(y, z, K, cfg, steps)
    assert unions["keys"] == keys <= shadow_dir.TABLE_KEYS
    assert (unions["staged"], unions["key_entries"]) == STAGED[case]
    assert unions["staged"] == staged < unions["key_entries"]
    # FINE's largest union spans two of the kernel's staged chunks of 64
    # entries (kDirChunk in csrc/shadow.cu).
    assert (unions["largest"] > 64) == (case == "fine")


@pytest.mark.parametrize("case", sorted(STAGED))
def test_tile_unions_count_only_live_pixels_keys(case):
    """With a ``live`` mask the unions are those of the live pixels alone:
    the same as with the other pixels' surface points moved two view
    heights down, where no key fits the fields; all True is no mask, all
    False keys nothing."""
    args, _ = case_inputs(case)
    y, z, K, cfg, steps = args[4], args[5], args[8], args[10], args[11]
    live = (torch.arange(y.numel()).view(y.shape) % 3 != 0) \
        & (y % 2 == 0)
    assert bool(live.any()) and not bool(live.all())
    moved = torch.where(live, y, y - 2 * cfg.view_height)
    got = shadow_dir.tile_unions(y, z, K, cfg, steps, live=live)
    assert got == shadow_dir.tile_unions(moved, z, K, cfg, steps)
    assert got["staged"] <= shadow_dir.tile_unions(y, z, K, cfg,
                                                   steps)["staged"]
    assert shadow_dir.tile_unions(y, z, K, cfg, steps,
                                  live=torch.ones_like(live)) == \
        shadow_dir.tile_unions(y, z, K, cfg, steps)
    assert set(shadow_dir.tile_unions(y, z, K, cfg, steps,
                                      live=torch.zeros_like(live))
               .values()) == {0}


def test_finite_slab_tests_count_the_frames_with_finite_directions():
    """``work["slab_tests_finite"]`` (the kernel's near/far test, which
    ``chip_smoke.py`` bounds at fewer operations) counts the needed tests
    of the frames whose reciprocal direction is finite on every axis: on
    the wide case, frame 1's and not frame 0's."""
    args, _ = case_inputs("wide")
    per_frame = []
    for f in range(2):
        work = {}
        one = tuple(a[f:f + 1] if torch.is_tensor(a) and a.shape[0] == 2
                    else a for a in args)
        shadow_dir.trace_light_directional(*one, work=work)
        per_frame.append(work)
    work = {}
    shadow_dir.trace_light_directional(*args, work=work)
    assert int(work["slab_tests"]) == sum(int(w["slab_tests"])
                                          for w in per_frame)
    assert int(per_frame[0]["slab_tests_finite"]) == 0
    assert (int(work["slab_tests_finite"])
            == int(per_frame[1]["slab_tests_finite"])
            == int(per_frame[1]["slab_tests"]) > 0)


def test_key_fields_fit_the_repo_configs():
    graybox = RenderConfig()
    assert shadow_dir.key_fields(graybox) == ((0, 4), (-8, 5), (-25, 6),
                                              (-49, 7), (-25, 6))
    config5 = RenderConfig(view_width=1024, view_height=1024,
                           view_length=320)
    for cfg in (graybox, SMALL, CAP, FINE, BIG, scaled_config(config5, 2),
                scaled_config(config5, 4)):
        fields = shadow_dir.key_fields(cfg)
        assert sum(bits for _, bits in fields) <= shadow_dir.KEY_BITS
    with pytest.raises(ValueError, match="key_fields"):
        shadow_dir.key_fields(HUGE)


# -- on the card -------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES)
def test_cuda_directional_counters_match_model(cuda, case):
    """The kernel's lit mask equals the model's and, where no tile holds
    more keys than the table, its staged entries and slab tests performed
    equal the model's counts: on FINE a tile's union spans two staged
    chunks, on BIG a thread takes its pixels in four rounds.  The spread
    cases take both slab tests (an infinite reciprocal direction component
    in frame 0, none in frame 1) and the direct march."""
    args, _ = case_inputs(case)
    lit, staged, tests, keys = union_march(*args)
    dev = tuple(a.to(cuda) if torch.is_tensor(a) else a for a in args)
    shadow_cuda.counters.reset()
    got = shadow_cuda.trace_light_directional(*dev)
    torch.cuda.synchronize()
    stats = shadow_cuda.counters.read()
    assert torch.equal(got.cpu(), lit)
    if keys <= shadow_dir.TABLE_KEYS:
        assert stats["direct_pixels"] == 0
        assert stats["staged_entries"] == staged
        assert stats["slab_tests"] == tests
    else:
        assert stats["direct_pixels"] > 0


@pytest.mark.cuda
def test_cuda_direct_march_counts_its_slab_tests(cuda):
    """A pixel whose key does not fit the packed fields marches on its own,
    and its slab tests add to ``slab_tests``: the fine case's surface
    points moved two view heights down put every start bin's row past the
    field's 16 values, so every pixel takes the direct march, which tests
    a probed bin's boxes at every probe up to its first hit (the plain
    march's ``slab_tests_every_probe``); each launch adds its F * H * W
    pixels to ``dir_pixels``."""
    args = list(case_inputs("fine")[0])
    args[4] = args[4] - 2 * FINE.view_height
    work = {}
    lit = shadow_dir.trace_light_directional(*args, work=work)
    dev = tuple(a.to(cuda) if torch.is_tensor(a) else a for a in args)
    shadow_cuda.counters.reset()
    got = shadow_cuda.trace_light_directional(*dev)
    torch.cuda.synchronize()
    stats = shadow_cuda.counters.read()
    n_pix = args[4].numel()
    assert torch.equal(got.cpu(), lit)
    assert stats["direct_pixels"] == stats["dir_pixels"] == n_pix
    assert stats["slab_tests"] == int(work["slab_tests_every_probe"]) > 0


@pytest.mark.cuda
def test_cuda_directional_refuses_unfit_keys(cuda):
    args = list(march_inputs("small", cuda)[2])
    args[10] = HUGE
    with pytest.raises(ValueError, match="key_fields"):
        shadow_cuda.trace_light_directional(*args)
