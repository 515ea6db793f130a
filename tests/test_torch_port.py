"""Port packaging: no JAX, no build at import, the kernel build flags, and
the features the port refuses instead of rendering another path."""

import pathlib
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from pixel_art_raytracer_tpu.config import RenderConfig
from pixel_art_raytracer_tpu.scene import SceneBuilder
from pixel_art_raytracer_tpu_torch.device import require_cuda
from pixel_art_raytracer_tpu_torch.models.animation import AnimationRenderer
from pixel_art_raytracer_tpu_torch.models.batched import render_states_batched
from pixel_art_raytracer_tpu_torch.models.deferred import (DeferredRenderer,
                                                           DeviceScene)
from pixel_art_raytracer_tpu_torch.runtime import kernels

REPO = pathlib.Path(__file__).resolve().parent.parent
PACKAGE = REPO / "pixel_art_raytracer_tpu_torch"
SMALL = RenderConfig(view_width=80, view_height=80, view_length=80)


def small_scene(config=SMALL):
    b = SceneBuilder(config=config)
    b.insert((30, 20, 20), (20, 20, 20))
    for i in range(3):
        for j in range(3):
            b.insert((i * 24, 0, j * 24), (16, 16, 16))
    return b.build()


def run_python(code: str, env_path: str | None = None):
    env = {"PYTHONPATH": str(REPO), "PATH": env_path or "/usr/bin:/bin"}
    return subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                          capture_output=True, text=True, env=env,
                          cwd=REPO, timeout=300)


def test_port_imports_and_renders_with_jax_blocked():
    proc = run_python("""
        import sys
        sys.modules["jax"] = None          # any 'import jax' now fails
        import numpy as np
        from pixel_art_raytracer_tpu.config import RenderConfig
        from pixel_art_raytracer_tpu.scene import SceneBuilder, Light
        import pixel_art_raytracer_tpu_torch
        from pixel_art_raytracer_tpu_torch.models.deferred import (
            DeferredRenderer)
        cfg = RenderConfig(view_width=80, view_height=80, view_length=80)
        b = SceneBuilder(config=cfg)
        b.insert((30, 20, 20), (20, 20, 20))
        b.insert((0, 0, 0), (16, 16, 16))
        scene = b.build()
        r = DeferredRenderer(cfg).configure_for(scene)
        frame = r.render_numpy(scene, Light(60, 60, 20), device="cpu")
        assert frame.shape == (80, 80, 3) and frame.max() > 0
        loaded = [m for m in sys.modules
                  if m.startswith(("jax", "pixel_art_raytracer_tpu."))
                  and sys.modules[m] is not None]
        print("OK", sorted(loaded))
    """)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("OK")
    # Only the JAX package's numpy-only host modules were reused.
    assert "pixel_art_raytracer_tpu.ops" not in proc.stdout
    assert "pixel_art_raytracer_tpu.models" not in proc.stdout


def test_package_sources_never_import_jax():
    for path in PACKAGE.rglob("*.py"):
        for line in path.read_text().splitlines():
            stripped = line.strip()
            assert not stripped.startswith(("import jax", "from jax")), path


def test_kernel_modules_import_without_triton_or_nvcc():
    proc = run_python("""
        import sys
        sys.modules["triton"] = None
        import shutil
        assert shutil.which("nvcc") is None
        from pixel_art_raytracer_tpu_torch.ops import shadow_cuda, trace_cuda
        from pixel_art_raytracer_tpu_torch.runtime import kernels
        assert kernels.library.cache_info().currsize == 0, "built at import"
        assert shadow_cuda.launches == trace_cuda.launches == 0
        print("OK")
    """, env_path="/nonexistent")
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "OK"


def test_nvcc_command_targets_hopper_with_ieee_math():
    cmd = kernels.nvcc_command("nvcc", pathlib.Path("/tmp/lib.so"))
    assert "arch=compute_90a,code=sm_90a" in cmd
    assert "-fmad=false" in cmd
    assert not any("fast_math" in a or "fast-math" in a for a in cmd)
    assert not any(a.startswith(("-prec-div", "-ftz", "-prec-sqrt"))
                   for a in cmd)
    units = {pathlib.Path(a).name for a in cmd if a.endswith(".cu")}
    assert units == {p.name for p in (PACKAGE / "csrc").glob("*.cu")}
    assert {"trace.cu", "shadow.cu"} <= units
    assert kernels.build_dir().parent == REPO / "build"


def test_build_dir_hash_follows_sources(tmp_path, monkeypatch):
    for p in kernels.sources():
        (tmp_path / p.name).write_bytes(p.read_bytes())
    monkeypatch.setattr(kernels, "CSRC", tmp_path)
    before = kernels.build_dir()
    (tmp_path / "trace.cu").write_text("// edited\n")
    assert kernels.build_dir() != before


@pytest.mark.parametrize("case", ["directional", "multi_light", "dithered",
                                  "upto"])
def test_unported_features_raise(case):
    scene = small_scene()
    ds = DeviceScene.from_scene(scene, SMALL, device="cpu")
    style = "dithered" if case == "dithered" else "reference"
    r = DeferredRenderer(SMALL, style=style).configure_for(scene)
    players = ds.pos[:1]
    lights = torch.tensor([[60, 60, 20]], dtype=torch.int32)
    with pytest.raises(NotImplementedError, match="ROADMAP|stage"):
        if case == "directional":
            AnimationRenderer(r, SMALL).render_states(
                ds, players, lights.float(), directional=True)
        elif case == "multi_light":
            AnimationRenderer(r, SMALL).render_states(ds, players,
                                                      lights[:, None])
        elif case == "upto":
            render_states_batched(r, None, ds, players, lights, upto="trace")
        else:
            r.render(ds, np.array([60, 60, 20]))


def test_require_cuda():
    if torch.cuda.is_available():
        assert require_cuda().type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            require_cuda()
