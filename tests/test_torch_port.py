"""Port packaging: no JAX and nothing of the JAX package, no build at
import, the kernel build flags, entry points that default to the card, the
lighting modes rendering on both paths, and the requests the port refuses
instead of rendering another path."""

import ctypes
import pathlib
import re
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from pixel_art_raytracer_tpu_torch.config import RenderConfig
from pixel_art_raytracer_tpu_torch.device import require_cuda
from pixel_art_raytracer_tpu_torch.models.animation import AnimationRenderer
from pixel_art_raytracer_tpu_torch.models.batched import render_states_batched
from pixel_art_raytracer_tpu_torch.models.brute import BruteForceRenderer
from pixel_art_raytracer_tpu_torch.models.deferred import (DeferredRenderer,
                                                           DeviceScene)
from pixel_art_raytracer_tpu_torch.models.inverse import InverseLightFitter
from pixel_art_raytracer_tpu_torch.ops.static_bins import StaticBins
from pixel_art_raytracer_tpu_torch.parallel.launch import run_ranks
from pixel_art_raytracer_tpu_torch.runtime import kernels, viewer
from pixel_art_raytracer_tpu_torch.runtime.session import Session
from pixel_art_raytracer_tpu_torch.runtime.viewer import LiveViewer
from pixel_art_raytracer_tpu_torch.scene import Light, SceneBuilder

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


def run_python(code: str, env_path: str | None = None, cwd=REPO,
               pythonpath=REPO):
    env = {"PYTHONPATH": str(pythonpath), "PATH": env_path or "/usr/bin:/bin"}
    return subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                          capture_output=True, text=True, env=env,
                          cwd=cwd, timeout=300)


def test_port_imports_and_renders_with_jax_blocked():
    proc = run_python("""
        import sys
        # Any 'import jax' or 'import pixel_art_raytracer_tpu' now fails.
        sys.modules["jax"] = None
        sys.modules["pixel_art_raytracer_tpu"] = None
        import chip_smoke                  # imports all it needs at the top
        import pixel_art_raytracer_tpu_torch as port
        from pixel_art_raytracer_tpu_torch.models.deferred import (
            DeferredRenderer)
        from pixel_art_raytracer_tpu_torch.runtime import native
        cfg = port.RenderConfig(view_width=80, view_height=80,
                                view_length=80)
        b = port.SceneBuilder(config=cfg)
        b.insert((30, 20, 20), (20, 20, 20))
        b.insert((0, 0, 0), (16, 16, 16))
        scene = b.build()
        r = DeferredRenderer(cfg).configure_for(scene)
        light = port.Light(60, 60, 20)
        frame = r.render_numpy(scene, light, device="cpu")
        assert frame.shape == (80, 80, 3) and frame.max() > 0
        r.fuse_trace_shadow = True
        assert (r.render_numpy(scene, light, device="cpu") == frame).all()
        assert (native.cpp_render_frame(scene, light, cfg)[0] == frame).all()
        loaded = [m for m in sys.modules
                  if m.split(".")[0] in ("jax", "pixel_art_raytracer_tpu")
                  and sys.modules[m] is not None]
        print("OK", sorted(loaded))
    """)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "OK []"


def imported_roots(path: pathlib.Path) -> set[str]:
    """Top-level package names of the import statements in ``path``."""
    roots = set()
    for line in path.read_text().splitlines():
        words = line.replace(",", " ").replace("(", " ").split()
        if words[:1] == ["import"]:
            roots |= {w.split(".")[0] for w in words[1:] if w != "as"}
        elif words[:1] == ["from"] and len(words) > 1:
            roots.add(words[1].split(".")[0])
    return roots


PORT_SOURCES = [*PACKAGE.rglob("*.py"), REPO / "chip_smoke.py"]


def test_package_sources_never_import_jax():
    for path in PORT_SOURCES:
        assert "jax" not in imported_roots(path), path


def test_package_sources_never_import_pil():
    """The machine with the card has no PIL: GIF and PNG are written by the
    port's own encoders."""
    for path in PACKAGE.rglob("*.py"):
        assert "PIL" not in imported_roots(path), path


def test_package_sources_never_import_the_jax_package():
    for path in PORT_SOURCES:
        roots = imported_roots(path)
        assert "pixel_art_raytracer_tpu" not in roots, path
        assert "optax" not in roots, path
    assert {"inverse.py", "mesh.py", "entity_sharded.py", "bench.py",
            "bench_scale.py", "make_demo.py"} <= {
        p.name for p in PORT_SOURCES}
    assert "pixel_art_raytracer_tpu_torch" in imported_roots(
        REPO / "chip_smoke.py")


def test_kernel_modules_import_without_triton_or_nvcc():
    proc = run_python("""
        import sys
        sys.modules["triton"] = None
        import shutil
        assert shutil.which("nvcc") is None
        from pixel_art_raytracer_tpu_torch.ops import (fused_cuda,
                                                       shadow_cuda,
                                                       trace_cuda)
        from pixel_art_raytracer_tpu_torch.runtime import kernels, native
        assert kernels.library.cache_info().currsize == 0, "built at import"
        assert native.library.cache_info().currsize == 0, "built at import"
        assert shadow_cuda.launches == trace_cuda.launches == 0
        assert fused_cuda.launches == 0
        print("OK")
    """, env_path="/nonexistent")
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "OK"


def test_nvcc_command_targets_hopper_with_ieee_math():
    lib = pathlib.Path("/tmp/lib.so")
    compiles, link = kernels.nvcc_commands("nvcc", lib)
    units = set()
    for cmd in compiles:
        assert "arch=compute_90a,code=sm_90a" in cmd
        assert "-fmad=false" in cmd and "-c" in cmd
        assert not any("fast_math" in a or "fast-math" in a for a in cmd)
        assert not any(a.startswith(("-prec-div", "-ftz", "-prec-sqrt"))
                       for a in cmd)
        (src,) = [a for a in cmd if a.endswith(".cu")]
        units.add(pathlib.Path(src).name)
    # One compile per source (run in parallel), then one link of them all.
    assert len(compiles) == len(units)
    assert units == {p.name for p in (PACKAGE / "csrc").glob("*.cu")}
    assert {"trace.cu", "shadow.cu", "fused.cu"} <= units
    assert "arch=compute_90a,code=sm_90a" in link
    assert link[link.index("-o") + 1] == str(lib)
    assert sum(a.endswith(".o") for a in link) == len(units)
    assert kernels.build_dir().parent == REPO / "build"


def c_entries() -> dict[str, list[str]]:
    """Each ``extern "C"`` entry point of ``csrc/*.cu``: name -> its
    parameters' declarations."""
    entries = {}
    for src in sorted((PACKAGE / "csrc").glob("*.cu")):
        for name, params in re.findall(
                r'extern "C" (?:const )?\w+\*? (\w+)\(([^)]*)\)',
                src.read_text()):
            entries[name] = [p.strip() for p in params.split(",")]
    return entries


@pytest.mark.parametrize("name", sorted(kernels.SIGNATURES))
def test_signatures_match_the_c_entry_points(name):
    """ctypes passes each argument as its entry in SIGNATURES declares it:
    a pointer as void* (a plain int would be cut to 32 bits), an int as
    int, a float as float."""
    kind = {ctypes.c_void_p: "*", ctypes.c_int: "int", ctypes.c_float:
            "float"}
    params = c_entries()[name]
    got = ["*" if "*" in p else p.split()[0] for p in params]
    assert got == [kind[t] for t in kernels.SIGNATURES[name]]


def test_build_dir_hash_follows_sources(tmp_path, monkeypatch):
    for p in kernels.sources():
        (tmp_path / p.name).write_bytes(p.read_bytes())
    monkeypatch.setattr(kernels, "CSRC", tmp_path)
    before = kernels.build_dir()
    (tmp_path / "trace.cu").write_text("// edited\n")
    assert kernels.build_dir() != before


FEATURES = ["directional", "multi_light", "dithered", "upto",
            "directional_multi"]
# Arguments of the JAX package that pick among its TPU shadow march's
# variants; the port has one march, with no step bound.
JAX_ONLY_ARGUMENTS = ["brute_shadow_max_steps", "viewer_shadow"]


@pytest.mark.parametrize("case", FEATURES + JAX_ONLY_ARGUMENTS)
def test_unported_features_raise(case):
    if case == "brute_shadow_max_steps":
        with pytest.raises(TypeError, match="shadow_max_steps"):
            BruteForceRenderer(SMALL, shadow=True, shadow_max_steps=16)
        return
    if case == "viewer_shadow":
        with pytest.raises(SystemExit):
            viewer.main(["--shadow", "fast", "--bench"])
        return
    check_feature(case, fuse=False)


@pytest.mark.parametrize("case", FEATURES)
def test_unported_features_raise_on_the_fused_path(case):
    check_feature(case, fuse=True)


def check_feature(case, fuse: bool):
    """The JAX batched path's lighting modes render on both settings of
    ``fuse_trace_shadow`` (their parity with the JAX package is in
    tests/test_torch_lights.py); ``upto=`` stage cuts still raise, and
    directional lights given as (F, L, 3) raise as in the JAX package."""
    scene = small_scene()
    ds = DeviceScene.from_scene(scene, SMALL, device="cpu")
    style = "dithered" if case == "dithered" else "reference"
    r = DeferredRenderer(SMALL, style=style).configure_for(scene)
    r.fuse_trace_shadow = fuse
    anim = AnimationRenderer(r, SMALL)
    players = ds.pos[:1]
    lights = torch.tensor([[60, 60, 20]], dtype=torch.int32)
    if case == "upto":
        with pytest.raises(NotImplementedError, match="stage"):
            render_states_batched(r, None, ds, players, lights, upto="trace")
        return
    if case == "directional_multi":
        with pytest.raises(ValueError, match="directional"):
            anim.render_states(ds, players, lights[:, None].float(),
                               directional=True)
        return
    if case == "directional":
        frames = anim.render_states(ds, players, torch.tensor(
            [[0.3, 1.0, -0.2]]), directional=True)
    elif case == "multi_light":
        frames = anim.render_states(ds, players, torch.tensor(
            [[[60, 60, 20], [10, 70, 30]]], dtype=torch.int32))
    else:
        frames = r.render(ds, np.array([60, 60, 20]))[None]
    assert frames.shape == (1, 80, 80, 3) and frames.dtype == torch.uint8
    point = AnimationRenderer(DeferredRenderer(SMALL).configure_for(scene),
                              SMALL).render_states(ds, players, lights)
    assert not torch.equal(frames, point)


def rank_tensor(device):
    """A rank's result for ``run_ranks``: 1 on a CUDA device, else 0."""
    return torch.tensor(int(device.type == "cuda"), device=device)


@pytest.mark.parametrize("entry", ["from_scene", "from_numpy",
                                   "render_numpy", "light_sweep_states",
                                   "static_bins", "session", "live_viewer",
                                   "render_long", "inverse_init",
                                   "run_ranks"])
def test_entry_points_default_to_the_card(entry, tmp_path):
    scene = small_scene()
    r = DeferredRenderer(SMALL).configure_for(scene)
    light = Light(60, 60, 20)
    call = {
        "from_scene": lambda: DeviceScene.from_scene(scene, SMALL).pos,
        "from_numpy": lambda: DeviceScene.from_numpy(
            {"pos": scene.pos, "ext": scene.ext,
             "sprite_id": scene.sprite_id, "atlas_color": scene.atlas.color,
             "atlas_depth": scene.atlas.depth,
             "atlas_normal": scene.atlas.normal,
             "palette": SMALL.palette_array}).pos,
        "render_numpy": lambda: torch.as_tensor(
            r.render_numpy(scene, Light(60, 60, 20))),
        "light_sweep_states": lambda: AnimationRenderer(r, SMALL)
        .light_sweep_states(4, scene.pos[0])[0],
        "static_bins": lambda: StaticBins(scene.pos, scene.ext, 1, SMALL,
                                          r.spans).static_total,
        "session": lambda: Session(scene, light, SMALL).dscene.pos,
        "live_viewer": lambda: LiveViewer(scene, light, SMALL).dscene.pos,
        "render_long": lambda: torch.as_tensor(
            AnimationRenderer(r, SMALL).render_long(
                DeviceScene.from_scene(scene, SMALL), scene.pos[:1],
                light.as_array()[None], tmp_path)),
        "inverse_init": lambda: InverseLightFitter(SMALL, r).init(
            [20.0, 20.0, 40.0])[0],
        "run_ranks": lambda: run_ranks(rank_tensor, 1)[0],
    }[entry]
    if torch.cuda.is_available():
        # render_numpy and render_long return numpy frames; a rank's
        # result comes back on the CPU, holding its device's type.
        if entry == "run_ranks":
            assert int(call()) == 1
        elif entry not in ("render_numpy", "render_long"):
            assert call().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            call()


@pytest.mark.parametrize("where", ["repo", "alone"])
def test_chip_smoke_fails_without_card_or_repo(where, tmp_path):
    """Without a card, or copied alone into an empty directory, chip_smoke
    exits non-zero and prints no result."""
    if where == "alone":
        (tmp_path / "chip_smoke.py").write_bytes(
            (REPO / "chip_smoke.py").read_bytes())
        cwd = pythonpath = tmp_path
    elif torch.cuda.is_available():
        pytest.skip("the card is present")
    else:
        cwd = pythonpath = REPO
    proc = subprocess.run([sys.executable, "chip_smoke.py"],
                          capture_output=True, text=True, cwd=cwd,
                          env={"PYTHONPATH": str(pythonpath),
                               "PATH": "/usr/bin:/bin"}, timeout=300)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout and '"kernels"' not in proc.stdout
    assert ("pixel_art_raytracer_tpu_torch" if where == "alone"
            else "no CUDA device") in proc.stderr


def test_require_cuda():
    if torch.cuda.is_available():
        assert require_cuda().type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            require_cuda()
