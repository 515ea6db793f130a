"""Port ``models/inverse.py`` (``InverseLightFitter``) against the JAX
package's fitter on the same numpy-made inputs.

``soft_frame`` must be bit-exact with and without shadows, including a
light so far away that the step cap ``shadow_max_steps`` decides the lit
mask (the JAX package's statically bounded march); the loss's gradient at
an integer-valued light (where ``|dx| = 0`` on a pixel column and the
Lambert dot ties 0 on the background) within rtol 1e-5 (the sums over
pixels run in another order); 25 Adam steps within rtol 1e-4 of optax's at
every step (optax and ``torch.optim.Adam`` round their updates in
another order), and the loss decreasing.  The port is held to the JAX
package's eager ``soft_frame``: its jitted ``train_step`` renders another
frame (XLA's rewrites move most pixels by an ulp and, with shadows at the
integer start light, flip lit pixels, which moves the first step's
gradient by ~4e-4), so the shadowed steps are held to its un-jitted
``train_step_impl``.  The JAX fitter runs on its plain trace
(``trace_impl="jnp"``), as the JAX package's CPU tests run it, with its
visibility stages jitted (integer gathers, the same under jit) and its
shading eager."""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from pixel_art_raytracer_tpu.config import RenderConfig as JRenderConfig
from pixel_art_raytracer_tpu.models import deferred as jdeferred
from pixel_art_raytracer_tpu.models.inverse import (
    InverseLightFitter as JFitter)
from pixel_art_raytracer_tpu.scene import SceneBuilder as JSceneBuilder
from pixel_art_raytracer_tpu_torch.config import RenderConfig
from pixel_art_raytracer_tpu_torch.models.deferred import (DeferredRenderer,
                                                           DeviceScene)
from pixel_art_raytracer_tpu_torch.models.inverse import (InverseLightFitter,
                                                          jax_abs)
from pixel_art_raytracer_tpu_torch.ops import shade, shadow, shadow_cuda
from pixel_art_raytracer_tpu_torch.ops.cstyle import c_div
from pixel_art_raytracer_tpu_torch.ops.trace import GBufferArrays

SMALL = RenderConfig(view_width=80, view_height=80, view_length=80)
JSMALL = JRenderConfig(view_width=80, view_height=80, view_length=80)
START = [20.0, 20.0, 40.0]
TRUE_LIGHT = [70.0, 60.0, 10.0]
# int(largest) = 13 bins from the floor's start bins, over the cap of 8:
# the capped march leaves N_CAPPED pixels lit that the exact one shadows.
FAR_LIGHT = [300.0, 600.0, 10.0]
N_CAPPED = 72
STEPS = 25
# Eager JAX steps take ~3.5 s each on the CPU.
SHADOW_STEPS = 2


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def small_scene():
    """tests/test_models.py:19-26."""
    b = JSceneBuilder(config=JSMALL)
    b.insert((30, 20, 20), (20, 20, 20))
    for i in range(3):
        for j in range(3):
            b.insert((i * 24, 0, j * 24), (16, 16, 16))
    return b.build()


@functools.cache
def fitters(shadows, lr=2.0, max_steps=8, device="cpu"):
    """``(jax_fitter, jax_scene, port_fitter, port_scene)`` on one scene,
    the port's tensors from the JAX package's arrays (cached: the fitters
    hold no state, and the JAX renderer's jitted stages compile once)."""
    scene = small_scene()
    jr = jdeferred.DeferredRenderer(JSMALL, shadow_max_steps=max_steps,
                                    trace_impl="jnp")
    jr.spans = jr.spans_for(scene)
    # Visibility is integer gathers, the same under jit: jit it for speed,
    # and keep the shading eager, where XLA's rewrites would change floats.
    jr.build_bins = jax.jit(jr.build_bins)
    jr.trace = jax.jit(jr.trace)
    jds = jdeferred.DeviceScene.from_scene(scene, JSMALL)
    ds = DeviceScene.from_numpy({k: np.asarray(v) for k, v in
                                 jds._asdict().items() if v is not None},
                                device=device)
    r = DeferredRenderer(SMALL, shadow_max_steps=max_steps)
    r.spans = tuple(jr.spans)
    return (JFitter(JSMALL, jr, learning_rate=lr, with_shadows=shadows), jds,
            InverseLightFitter(SMALL, r, learning_rate=lr,
                               with_shadows=shadows), ds)


def bits(a):
    return np.asarray(a).view(np.int32)


@pytest.mark.parametrize("shadows", [False, True])
@pytest.mark.parametrize("light", [START, TRUE_LIGHT, [33.3, 41.7, 12.5],
                                   FAR_LIGHT], ids=["start", "true",
                                                    "fractional", "far"])
def test_soft_frame_bit_exact(shadows, light):
    jf, jds, f, ds = fitters(shadows)
    want = jf.soft_frame(jds, jnp.asarray(light, jnp.float32))
    got = f.soft_frame(ds, torch.tensor(light, dtype=torch.float32))
    assert got.shape == (80, 80, 3) and got.dtype == torch.float32
    np.testing.assert_array_equal(bits(got.numpy()), bits(want))


def test_step_cap_decides_lit():
    """The far light's rays run 13 steps: the capped march (8) differs
    from the exact one (the point mode without ``max_steps``) on pixels
    the exact march shadows, those pixels of the frame are lit, and the
    JAX fitter's frame is the capped one."""
    jf, jds, f, ds = fitters(True)
    r = f.renderer
    light = torch.tensor(FAR_LIGHT)
    capped = f.soft_frame(ds, light)
    want = jf.soft_frame(jds, jnp.asarray(FAR_LIGHT, jnp.float32))
    np.testing.assert_array_equal(bits(capped.numpy()), bits(want))
    be, cnt = r.build_bins(ds)
    gbuf = r.trace(ds, be, cnt)
    args = f.shadow_inputs(ds, be, cnt, gbuf, light,
                           f.towards_light(gbuf.y, gbuf.z, light))
    lit = shadow_cuda.trace_light(*args, max_steps=r.shadow_max_steps)[0]
    exact = shadow_cuda.trace_light(*args)[0]
    differ = lit != exact
    assert int(differ.sum()) == N_CAPPED
    # Every differing pixel is one the exact march shadows ...
    assert not bool(exact[differ].any())
    # ... and the capped frame lights it above the ambient term.
    ambient = (gbuf.color[..., :3].to(torch.float32) / torch.tensor(255.0)
               * SMALL.ambient)
    assert int((capped != ambient).any(-1)[differ].sum()) == N_CAPPED


def test_capped_march_stops_at_the_cap():
    """``trace_light_dynamic`` under a cap of k probes 7k phases: a cap of
    int(largest) or more is the exact march, and the cap cuts lists to
    7 * k bins."""
    _, _, f, ds = fitters(True)
    r = f.renderer
    be, cnt = r.build_bins(ds)
    gbuf = r.trace(ds, be, cnt)
    rb, origin = shade.surface_rays(gbuf.y[None], gbuf.z[None], SMALL)
    light = torch.tensor(FAR_LIGHT).round().to(torch.int32)
    lb = tuple(c_div(v, 40).view(1, 1, 1) for v in (
        light[0], 80 - light[1] - light[2], light[2]))
    _, inv, _, _, _ = shade.light_geometry(
        GBufferArrays(*(t[None] for t in gbuf)), light[None], SMALL)
    args = (ds.pos, ds.ext, be[None], cnt[None], rb, lb,
            gbuf.entity_index[None], origin, inv, ds.pos[:1], SMALL)
    exact = shadow_cuda.trace_light(*args)
    assert torch.equal(shadow_cuda.trace_light(*args, max_steps=13), exact)
    assert not torch.equal(shadow_cuda.trace_light(*args, max_steps=8),
                           exact)
    lists = shadow.dda_visit_lists(tuple(t.reshape(-1)[:1] for t in rb),
                                   tuple(int(v) for v in lb), SMALL, 2)
    assert len(lists[0]) <= 14
    with pytest.raises(ValueError, match="max_steps"):
        shadow_cuda.trace_light(*args, max_steps=-1)
    for cap in (None, 0):
        with pytest.raises(ValueError, match="shadow_max_steps"):
            DeferredRenderer(SMALL, shadow_max_steps=cap)


@pytest.mark.parametrize("shadows", [False, True])
def test_loss_and_grad_at_integer_light(shadows):
    jf, jds, f, ds = fitters(shadows)
    target = jf.soft_frame(jds, jnp.asarray(TRUE_LIGHT, jnp.float32))
    jloss, jgrad = jax.value_and_grad(jf.loss)(
        jnp.asarray(START, jnp.float32), jds, target)
    light = torch.tensor(START, requires_grad=True)
    loss = f.loss(light, ds, torch.from_numpy(np.array(target)))
    loss.backward()
    # The hazards exist at this light: dx == 0 on a whole pixel column,
    # and the Lambert dot ties 0 (every background pixel).
    gbuf = f.renderer.trace(ds, *f.renderer.build_bins(ds))
    assert (START[0] - torch.arange(80.0) == 0).any()
    assert bool((gbuf.entity_index == 0).any()) and bool(
        (gbuf.normal == 0).all(-1).any())
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-6)
    np.testing.assert_allclose(light.grad.numpy(), np.asarray(jgrad),
                               rtol=1e-5)
    assert (light.grad != 0).all()


def test_abs_and_tie_gradients_are_jax_rules():
    x = torch.tensor([0.0, -0.0, 2.0, -3.0], requires_grad=True)
    jax_abs(x).sum().backward()
    assert x.grad.tolist() == [1.0, 1.0, 1.0, -1.0]
    jx = jax.grad(lambda v: jnp.abs(v).sum())(jnp.asarray([0.0, -0.0, 2.0,
                                                           -3.0]))
    assert np.asarray(jx).tolist() == x.grad.tolist()
    y = torch.tensor([0.0, 1.0], requires_grad=True)
    torch.maximum(torch.zeros(2), y).sum().backward()
    jy = jax.grad(lambda v: jnp.maximum(0.0, v).sum())(jnp.asarray([0.0,
                                                                    1.0]))
    assert y.grad.tolist() == np.asarray(jy).tolist() == [0.5, 1.0]


def test_fit_follows_optax_step_by_step():
    """25 steps without shadows, as tests/test_models.py's TestInverse fits,
    beside the JAX package's jitted ``train_step``."""
    jf, jds, f, ds = fitters(False, lr=3.0)
    target = jf.soft_frame(jds, jnp.asarray(TRUE_LIGHT, jnp.float32))[None]
    jlight, jstate = jf.init(np.array(START))
    light, opt = f.init(torch.tensor(START))
    targets = torch.from_numpy(np.array(target))
    history = []
    for step in range(STEPS):
        jlight, jstate, _ = jf.train_step(jlight, jstate, jds, target)
        light, opt, loss = f.train_step(light, opt, ds, targets)
        np.testing.assert_allclose(light.detach().numpy(),
                                   np.asarray(jlight), rtol=1e-4,
                                   err_msg=f"step {step}")
        history.append(float(loss))
    assert history[-1] < history[0]
    fitted, fit_history = f.fit(ds, targets, START, steps=STEPS)
    assert fit_history == history
    assert torch.equal(fitted, light.detach())


def test_fit_with_shadows_follows_the_eager_jax_step():
    """With shadows, beside the JAX package's un-jitted ``train_step_impl``
    (its jitted step renders another frame at this integer light, see the
    module docstring): the light within rtol 1e-4 and the loss within 1e-6
    at every step."""
    jf, jds, f, ds = fitters(True, lr=3.0)
    target = jf.soft_frame(jds, jnp.asarray(TRUE_LIGHT, jnp.float32))[None]
    jlight, jstate = jf.init(np.array(START))
    light, opt = f.init(torch.tensor(START))
    targets = torch.from_numpy(np.array(target))
    for step in range(SHADOW_STEPS):
        jlight, jstate, jloss = jf.train_step_impl(jlight, jstate, jds,
                                                   target)
        light, opt, loss = f.train_step(light, opt, ds, targets)
        np.testing.assert_allclose(light.detach().numpy(),
                                   np.asarray(jlight), rtol=1e-4,
                                   err_msg=f"step {step}")
        assert abs(float(loss) - float(jloss)) < 1e-6, step


@pytest.mark.cuda
def test_cuda_capped_point_mode_matches_plain(cuda):
    """The point mode of ``shadow.cu`` under a step cap equals the capped
    plain march, on the far light where the cap decides."""
    _, _, f, ds = fitters(True, device=cuda)
    r = f.renderer
    be, cnt = r.build_bins(ds)
    gbuf = r.trace(ds, be, cnt)
    rb, origin = shade.surface_rays(gbuf.y[None], gbuf.z[None], SMALL)
    light = torch.tensor(FAR_LIGHT, device=cuda).round().to(torch.int32)
    lb = tuple(c_div(v, 40).view(1, 1, 1) for v in (
        light[0], 80 - light[1] - light[2], light[2]))
    _, inv, _, _, _ = shade.light_geometry(
        GBufferArrays(*(t[None] for t in gbuf)), light[None], SMALL)
    args = (ds.pos, ds.ext, be[None], cnt[None], rb, lb,
            gbuf.entity_index[None], origin, inv, ds.pos[:1], SMALL)
    cpu = tuple(tuple(t.cpu() for t in a) if isinstance(a, tuple)
                else a.cpu() if torch.is_tensor(a) else a for a in args)
    for cap in (None, 2, 8, 13):
        got = shadow_cuda.trace_light(*args, max_steps=cap)
        want = shadow.trace_light_dynamic(*cpu, max_steps=cap)
        assert torch.equal(got.cpu(), want), cap


@pytest.mark.cuda
@pytest.mark.parametrize("shadows", [False, True])
def test_cuda_soft_frame_and_grad_match_cpu(cuda, shadows):
    """``soft_frame`` and the gradient on the card equal the CPU's, at the
    integer start light (t == 0 on a pixel column: inv = +inf there) and
    the far light."""
    _, _, f, ds = fitters(shadows)
    _, _, fc, dsc = fitters(shadows, device=cuda)
    target = f.soft_frame(ds, torch.tensor(TRUE_LIGHT))
    for light0 in (START, FAR_LIGHT):
        lc = torch.tensor(light0, device=cuda, requires_grad=True)
        l0 = torch.tensor(light0, requires_grad=True)
        got = fc.soft_frame(dsc, lc)
        want = f.soft_frame(ds, l0)
        np.testing.assert_array_equal(bits(got.detach().cpu().numpy()),
                                      bits(want.detach().numpy()))
        fc.loss(lc, dsc, target.to(cuda)).backward()
        f.loss(l0, ds, target).backward()
        np.testing.assert_allclose(lc.grad.cpu().numpy(), l0.grad.numpy(),
                                   rtol=1e-5)
