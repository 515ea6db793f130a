"""Build ``csrc/*.cu`` with nvcc into one shared library, load it with ctypes.

The library has a plain C interface (no PyTorch headers), so each source
compiles in seconds: one nvcc process per source, all started together,
then one link.  It is built at first use into a directory of ``build/``
named by a hash of the sources and flags, so an edited source gets a fresh
build and an unchanged one is loaded as it is.

The flags keep the float arithmetic IEEE, as the parity with the C++
reference needs: ``-fmad=false`` forbids contracting a multiply and an add
into an FMA, and nvcc's defaults ``-prec-div=true -ftz=false`` stay (no
``--use_fast_math``).

Each C entry point launches on the stream it is given and returns
``cudaGetLastError()``; :func:`check` raises on anything but 0.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess

import torch

PACKAGE = pathlib.Path(__file__).resolve().parent.parent
CSRC = PACKAGE / "csrc"
BUILD_ROOT = PACKAGE.parent / "build"
LIB_NAME = "libpar_kernels.so"

GENCODE = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*GENCODE, "-std=c++17", "-O3", "-fmad=false",
              "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# Argument types of each C entry point: pointers and the stream as void*,
# sizes as int, the ambient factor and a luminance as float.
SIGNATURES = {
    "par_trace_winners": [_P] * 9 + [_I] * 14 + [_P],
    "par_shadow_lit": [_P] * 18 + [_I] * 13 + [_P],
    "par_shadow_shade": [_P] * 16 + [_I] * 13 + [_F] + [_I] * 2 + [_P],
    "par_shadow_lights": [_P] * 16 + [_I] * 14 + [_F] + [_I] * 2 + [_P],
    "par_shadow_dir_lit": [_P] * 13 + [_I] * 9 + [_P, _I, _P],
    "par_shadow_dir_shade": [_P] * 18 + [_I] * 16 + [_F] * 2
                            + [_P, _I, _P],
    "par_fused_trace_shadow": [_P] * 12 + [_I] * 13 + [_P],
    "par_bin_tables": [_P] * 6 + [_I] * 15 + [_P],
    "par_bin_merge": [_P] * 8 + [_I] * 19 + [_P],
    "par_box_filter": [_P] * 2 + [_I] * 3 + [_P],
    "par_trace_occupancy": [_I] * 8 + [_P],
    "par_shadow_occupancy": [_I] * 9 + [_P],
    "par_shadow_dir_occupancy": [_I] * 8 + [_P],
    "par_shadow_dir_shade_occupancy": [_I] * 8 + [_P],
    "par_shadow_shade_occupancy": [_I] * 10 + [_P],
    "par_shadow_lights_occupancy": [_I] * 10 + [_P],
    "par_fused_occupancy": [_I] * 9 + [_P],
}


def sources() -> list[pathlib.Path]:
    """Kernel sources and headers, in a fixed order."""
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def find_nvcc() -> str:
    """nvcc on ``PATH``, else the CUDA toolkit's default location."""
    found = shutil.which("nvcc")
    if found:
        return found
    default = pathlib.Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def nvcc_commands(nvcc: str, output: pathlib.Path):
    """The nvcc invocations that build the library at ``output``:
    ``(compiles, link)``, one compile per ``.cu`` source into an object
    beside ``output``, then the link of those objects."""
    compiles, objects = [], []
    for src in sources():
        if src.suffix != ".cu":
            continue
        obj = output.with_name(f"{output.name}.{src.stem}.o")
        compiles.append([nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)])
        objects.append(str(obj))
    return compiles, [nvcc, *GENCODE, "-shared", "-o", str(output), *objects]


def build_dir() -> pathlib.Path:
    """``build/kernels-<hash>``: the hash covers the flags and sources."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_ROOT / f"kernels-{h.hexdigest()[:16]}"


def build() -> pathlib.Path:
    """Build the library unless this hash's build exists; returns its path.

    Raises ``RuntimeError`` with nvcc's output when the build fails.
    """
    out_dir = build_dir()
    lib = out_dir / LIB_NAME
    if lib.exists():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out_dir / f"{LIB_NAME}.{os.getpid()}.tmp"
    compiles, link = nvcc_commands(find_nvcc(), tmp)
    procs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True))
             for cmd in compiles]
    # Wait for every compile before raising, so no nvcc outlives the call.
    results = [(cmd, proc.communicate()[0], proc.returncode)
               for cmd, proc in procs]
    for cmd, out, rc in results:
        _check_nvcc(cmd, out, rc)
    proc = subprocess.run(link, stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT, text=True)
    _check_nvcc(link, proc.stdout, proc.returncode)
    os.replace(tmp, lib)
    return lib


def _check_nvcc(cmd: list[str], output: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"nvcc failed ({rc}):\n{' '.join(cmd)}\n{output}")


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library (built at first use)."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.par_cuda_error_string.argtypes = [ctypes.c_int]
    lib.par_cuda_error_string.restype = ctypes.c_char_p
    return lib


def check(rc: int, name: str) -> None:
    """Raise if a launch entry point reported a CUDA error."""
    if rc != 0:
        msg = library().par_cuda_error_string(rc).decode()
        raise RuntimeError(f"{name}: CUDA error {rc} ({msg})")


def stream_handle(device: torch.device) -> int:
    """PyTorch's current stream on ``device``, as the C interface takes it."""
    return torch.cuda.current_stream(device).cuda_stream


def occupancy(name: str, config, threads: int,
              *extra: int) -> tuple[int, ...]:
    """``(shared bytes per block, blocks per SM, registers per thread,
    local bytes per thread)`` of a kernel at ``threads`` threads, from the
    C entry point ``name``
    (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``,
    ``cudaFuncGetAttributes``); ``extra`` ints follow ``threads``."""
    cfg = config
    out = (ctypes.c_int * 4)()
    rc = getattr(library(), name)(
        cfg.view_width, cfg.view_height, cfg.bin_size, cfg.bin_capacity,
        cfg.hash_width, cfg.hash_height, cfg.hash_length, threads, *extra,
        ctypes.addressof(out))
    check(rc, name)
    return tuple(out)


class MarchCounters:
    """The march kernels' device counters, per device, that each launch
    adds to: a (3,) int32 tensor (csrc/common.cuh MarchStat) of pixels
    marched directly, the most keys one band of the point march held
    (``max_starts``: start bins; in the directional mode, (start bin,
    light bin) pairs of one tile; the table's size + 1 where some did not
    fit) and the longest visit list;
    and a (7,) int64 tensor (csrc/shadow.cu MarchWork) of the directional
    mode's union entries staged (``staged_entries``, summed over the tiles)
    and the slab tests it performed (``slab_tests``: its union lists and
    its direct march), the slab tests of the winner-input mode's
    launches that count (``shade_slab_tests``: its lists and its direct
    march) and their pixels marched (``shade_marched_pixels``: those not
    settled; where a launch stores frames, the pixels whose colour the
    march can change), and the same two of the multi-light mode's launches
    that count, over their lights (``light_slab_tests``,
    ``light_marched_pixels``: pixel-lights), and the pixels the
    winner-input directional mode marched, in every launch of it
    (``dir_marched_pixels``: those not settled, the pixels whose colour the
    march can change).  The counting point and multi-light launches run
    only while the program is traced (``runtime/tracing.active``); their
    pixels, F * H * W a launch, add to the host count ``shade_pixels``
    beside the tensor (the multi-light mode's pixel-lights, F * H * W * L a
    launch, to ``light_pixels``), every directional launch's (lit mask or
    frames) to ``dir_pixels``, and those of the directional launches that
    shade the frames to ``dir_shade_pixels``."""

    def __init__(self):
        self._stats: dict[torch.device, torch.Tensor] = {}
        self._work: dict[torch.device, torch.Tensor] = {}
        self.shade_pixels = 0
        self.light_pixels = 0
        self.dir_pixels = 0
        self.dir_shade_pixels = 0

    def tensor(self, device: torch.device) -> torch.Tensor:
        """The (3,) int32 counters a launch on ``device`` writes to."""
        if device not in self._stats:
            self._stats[device] = torch.zeros(3, dtype=torch.int32,
                                              device=device)
        return self._stats[device]

    def work(self, device: torch.device) -> torch.Tensor:
        """The (7,) int64 counters a directional or counting winner-input
        or multi-light launch on ``device`` adds to."""
        if device not in self._work:
            self._work[device] = torch.zeros(7, dtype=torch.int64,
                                             device=device)
        return self._work[device]

    def reset(self) -> None:
        for t in (*self._stats.values(), *self._work.values()):
            t.zero_()
        self.shade_pixels = 0
        self.light_pixels = 0
        self.dir_pixels = 0
        self.dir_shade_pixels = 0

    def read(self) -> dict[str, int]:
        """The counters since the last reset, over every device."""
        vals = [t.tolist() for t in self._stats.values()] or [[0, 0, 0]]
        work = [t.tolist() for t in self._work.values()] or [[0] * 7]
        return {"direct_pixels": sum(v[0] for v in vals),
                "max_starts": max(v[1] for v in vals),
                "max_list": max(v[2] for v in vals),
                "staged_entries": sum(w[0] for w in work),
                "slab_tests": sum(w[1] for w in work),
                "shade_slab_tests": sum(w[2] for w in work),
                "shade_marched_pixels": sum(w[3] for w in work),
                "shade_pixels": self.shade_pixels,
                "light_slab_tests": sum(w[4] for w in work),
                "light_marched_pixels": sum(w[5] for w in work),
                "light_pixels": self.light_pixels,
                "dir_pixels": self.dir_pixels,
                "dir_shade_pixels": self.dir_shade_pixels,
                "dir_marched_pixels": sum(w[6] for w in work)}


def require(t: torch.Tensor, name: str, dtype: torch.dtype,
            shape: tuple, device: torch.device,
            contiguous: bool = True) -> None:
    """Raise unless ``t`` is a ``dtype`` tensor on ``device`` whose shape
    matches ``shape`` (``None`` matches any size), contiguous unless
    ``contiguous`` is False (for a kernel that reads its strides)."""
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if t.dim() != len(shape) or any(
            s is not None and s != n for s, n in zip(shape, t.shape)):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")
    if contiguous and not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")
