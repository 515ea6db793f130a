"""Port C-semantics helpers against the JAX package's NumPy branch.

Every comparison is exact: these helpers carry the reference's integer
division, NaN ordering and truncating casts, which pixel parity needs.
"""

import numpy as np
import pytest
import torch

from pixel_art_raytracer_tpu.ops import cstyle as ref
from pixel_art_raytracer_tpu_torch.ops import cstyle

NAN = float("nan")
INF = float("inf")

PAIRS = [(1.0, 2.0), (2.0, 1.0), (3.0, NAN), (NAN, 3.0), (NAN, NAN),
         (INF, 1.0), (-INF, 1.0), (0.0, -0.0), (-0.0, 0.0)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def f32(v):
    return torch.tensor(v, dtype=torch.float32)


def same_bits(a, b):
    """Bitwise float32 equality (NaN == NaN, -0.0 != 0.0)."""
    a = np.asarray(a, np.float32).view(np.int32)
    b = np.asarray(b, np.float32).view(np.int32)
    return np.array_equal(a, b)


@pytest.mark.parametrize("a,b", PAIRS)
def test_c_min_c_max_keep_argument_order(a, b):
    for fn in ("c_min", "c_max"):
        got = getattr(cstyle, fn)(f32(a), f32(b)).numpy()
        want = getattr(ref, fn)(np.float32(a), np.float32(b))
        assert same_bits(got, want), (fn, a, b, got, want)


def test_c_max_nan_keeps_first_not_minimum():
    # std::max(0, nan) == 0 where torch.maximum propagates NaN.
    assert float(cstyle.c_max(f32(0.0), f32(NAN))) == 0.0
    assert torch.isnan(torch.maximum(f32(0.0), f32(NAN)))


@pytest.mark.parametrize("a,b,expect", [
    (7, 2, 3), (-7, 2, -3), (7, -2, -3), (-7, -2, 3),
    (-20, 40, 0), (-40, 40, -1), (-41, 40, -1), (-79, 40, -1),
    (-80, 40, -2), (39, 40, 0), (40, 40, 1),
])
def test_c_div_truncates_toward_zero(a, b, expect):
    got = cstyle.c_div(torch.tensor(a, dtype=torch.int32), b)
    assert int(got) == expect == int(ref.c_div(np.int32(a), np.int32(b)))
    assert got.dtype == torch.int32


def test_c_div_array_matches_numpy_branch():
    rng = np.random.default_rng(0)
    a = rng.integers(-1000, 1000, 4096).astype(np.int32)
    got = cstyle.c_div(torch.from_numpy(a), 40).numpy()
    np.testing.assert_array_equal(got, ref.c_div(a, np.int32(40)))
    # torch's // floors, which the reference never does.
    assert not np.array_equal(got, a // 40)


def test_trunc_to_int():
    x = np.array([-2.7, -0.5, -0.0, 0.5, 2.7, 39.999], np.float32)
    np.testing.assert_array_equal(
        cstyle.trunc_to_int(torch.from_numpy(x)).numpy(), ref.trunc_to_int(x))


def test_scale_color_u8_truncates():
    rng = np.random.default_rng(1)
    c = rng.integers(0, 256, (64, 3)).astype(np.uint8)
    fac = rng.random(64).astype(np.float32)
    got = cstyle.scale_color_u8(torch.from_numpy(c),
                                torch.from_numpy(fac)[:, None]).numpy()
    np.testing.assert_array_equal(got, ref.scale_color_u8(c, fac[:, None]))
    np.testing.assert_array_equal(
        cstyle.scale_color_u8(torch.tensor([100, 140, 255], dtype=torch.uint8),
                              0.25).numpy(), [25, 35, 63])


def test_l1_normalize_bits_including_zero_length():
    rng = np.random.default_rng(2)
    v = rng.integers(-50, 50, (3, 256)).astype(np.float32)
    v[:, 0] = 0.0                                  # 0/0 -> NaN
    got = cstyle.l1_normalize(*(torch.from_numpy(a) for a in v))
    want = ref.l1_normalize(*v)
    for g, w in zip(got, want):
        assert same_bits(g.numpy(), w)
    assert np.isnan(got[0][0].item())


@pytest.mark.cuda
def test_cuda_matches_cpu(cuda):
    rng = np.random.default_rng(3)
    a = torch.from_numpy(rng.integers(-1000, 1000, 4096).astype(np.int32))
    assert torch.equal(cstyle.c_div(a.to(cuda), 40).cpu(), cstyle.c_div(a, 40))
    x = torch.from_numpy(rng.standard_normal(4096).astype(np.float32))
    x[::7] = NAN
    y = torch.from_numpy(rng.standard_normal(4096).astype(np.float32))
    for fn in (cstyle.c_min, cstyle.c_max):
        assert same_bits(fn(x.to(cuda), y.to(cuda)).cpu().numpy(),
                         fn(x, y).numpy())
