"""The port's spans and its counted march (``runtime/tracing.py``).

On CPU tensors under a CPU profiler, the batched path, the G-buffer frame
and the session's request open the spans their docstrings name, nested as
the calls are; with no profiler no ``record_function`` is entered.  The
benchmark's readers of those spans and of the winner-input march's
counter read their numbers from hand-made records, and nothing from a
record without them; the viewer's ``--profile`` writes them into a Chrome
trace.  The CUDA cases (skipped without a card) hold the
counting kernel's slab tests to the plain march's count, check that an
untraced launch passes no counter, and run the batch path and the
session's request with every synchronisation outside a ``sync.*`` span
turned into an error.
"""

from __future__ import annotations

import contextlib

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from pixel_art_raytracer_tpu_torch import RenderConfig, SceneBuilder
from pixel_art_raytracer_tpu_torch.models import batched
from pixel_art_raytracer_tpu_torch.models.animation import AnimationRenderer
from pixel_art_raytracer_tpu_torch.models.deferred import (DeferredRenderer,
                                                           DeviceScene)
from pixel_art_raytracer_tpu_torch.ops import shade, shadow_cuda, trace_cuda
from pixel_art_raytracer_tpu_torch.ops.static_bins import StaticBins
from pixel_art_raytracer_tpu_torch.runtime import kernels, tracing
from pixel_art_raytracer_tpu_torch.runtime.session import Session
from pixel_art_raytracer_tpu_torch.scene import Light

from port_bench import harness, profiling, spans, spec

SMALL = RenderConfig(view_width=80, view_height=80, view_length=80)
LIGHTS = [[60, 60, 20], [10, 70, 5], [70, 45, 35], [-37, 50, -13]]


@pytest.fixture(autouse=True)
def one_thread():
    """One PyTorch thread a test: the suite runs in several worker
    processes at once."""
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
    b = SceneBuilder(config=SMALL)
    b.insert((30, 20, 20), (20, 20, 20))
    for i in range(3):
        for j in range(3):
            b.insert((i * 24, 0, j * 24), (16, 16, 16))
    return b.build()


def batch_inputs(device):
    """The renderer, device scene, bin cache, players and point lights of
    four frames of the small scene, the player moving."""
    scene = small_scene()
    r = DeferredRenderer(SMALL).configure_for(scene)
    ds = DeviceScene.from_scene(scene, SMALL, device=device)
    cache = StaticBins(scene.pos, scene.ext, 1, SMALL, r.spans,
                       device=device)
    rng = np.random.default_rng(5)
    players = torch.from_numpy((scene.pos[0] + rng.integers(
        -10, 11, (len(LIGHTS), 3))).astype(np.int32)).to(device)
    lights = torch.tensor(LIGHTS, dtype=torch.int32, device=device)
    return r, ds, cache, players, lights


def run_path(path: str, device):
    """Drive one request of ``path`` (after one unrecorded warm-up call
    made by the caller, where it wants one): returns a callable."""
    if path == "render_states_batched":
        r, ds, cache, players, lights = batch_inputs(device)
        anim = AnimationRenderer(r, SMALL, static_bins=cache)
        return lambda: anim.render_states(ds, players, lights)
    if path == "render_with_gbuffer":
        r, ds, _, _, _ = batch_inputs(device)
        light = Light(60, 60, 20).as_array()
        return lambda: r.render_with_gbuffer(ds, light)
    if path == "session_feed":
        s = Session(small_scene(), Light(60, 60, 20), SMALL, device=device)
        return lambda: s.feed(["left", "a"], mouse=(30, 40))
    raise ValueError(path)


def span_tree(prof) -> list:
    """The program's spans of a profile as nested ``(name, [children])``,
    in start order."""
    evs = sorted(((ev.start_ns(), ev.start_ns() + ev.duration_ns(),
                   ev.name())
                  for ev in prof.profiler.kineto_results.events()
                  if spans.is_span(ev.name())),
                 key=lambda t: (t[0], -t[1]))
    root: list = []
    stack: list = []   # (end_ns, children)
    for s, e, name in evs:
        while stack and s >= stack[-1][0]:
            stack.pop()
        node = (name, [])
        (stack[-1][1] if stack else root).append(node)
        stack.append((e, node[1]))
    return root


BINS = ("batch.bins", [("sync.upload", [])])
# A full rebin: the offsets' upload, then bincount's read of its range.
REBIN = ("batch.bins", [("sync.upload", []), ("sync.bincount", [])])
GBUFFER_BATCH = ("batch", [REBIN, ("batch.trace", [("sync.upload", [])]),
                           ("batch.geometry", []), ("batch.shadow", []),
                           ("batch.shade", [])])
TREES = {
    # The main path: the plain winner-input mode uploads the background
    # colour for its shade on the CPU.
    "render_states_batched": [
        ("batch", [BINS, ("batch.trace", []),
                   ("batch.shade", [("sync.upload", [])])])],
    # The light's upload, then one batch span (never two).
    "render_with_gbuffer": [("sync.upload", []), GBUFFER_BATCH],
    "session_feed": [
        ("frame", [("sync.upload", []), ("sync.upload", []), GBUFFER_BATCH,
                   ("sync.fetch", []), ("sync.readback", []),
                   ("frame.overlay", []), ("frame.keep", [])])],
}


@pytest.mark.parametrize("path", sorted(TREES))
def test_spans_nest_as_the_paths_call_them(path):
    go = run_path(path, torch.device("cpu"))
    assert not tracing.active()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert tracing.active()
        go()
    assert not tracing.active()
    assert span_tree(prof) == TREES[path]


@pytest.mark.parametrize("path", sorted(TREES))
def test_no_record_function_is_entered_without_a_profiler(path, monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) entered")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    run_path(path, torch.device("cpu"))()
    assert tracing.span("batch") is tracing.span("sync.fetch")


def test_spanned_keeps_the_function_and_opens_its_span():
    @tracing.spanned("batch.test")
    def add(a, b=1):
        """Adds."""
        return a + b

    assert add(2, b=3) == 5 and add.__doc__ == "Adds."
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert add(1) == 2
    names = [ev.name() for ev in prof.profiler.kineto_results.events()]
    assert names.count("batch.test") == 1


# -- the benchmark's readers of the spans and the counter --------------------

def record(host_ops, frames=4):
    trace = profiling.Trace(activities=[(0.0, 0.1, "k")],
                            host_ops=sorted(host_ops), window_s=2.0)
    return harness.RunRecord("x", 3, 12, 1.0, [], 100,
                             {"frames": frames, "height": 2, "width": 3},
                             trace, 12)


# Two batch requests of 4 frames (3 ms and 5 ms, 0.5 + 0.25 ms and 1 ms of
# sync.* inside), a sync span outside any request, a request cut at the
# window's end (the last), and an operator.
BATCH_OPS = [
    (10.000, 10.003, "batch"), (10.0005, 10.001, "batch.bins"),
    (10.0006, 10.0011, "sync.upload"), (10.002, 10.00225, "sync.fetch"),
    (10.0021, 10.0022, "aten::add"),
    (10.010, 10.015, "batch"), (10.011, 10.012, "sync.upload"),
    (10.020, 10.021, "sync.upload"),
    (10.030, 10.040, "batch"), (10.031, 10.039, "sync.upload"),
]
# Two frames (10 and 20 ms; sync 4 + 1 and 6 ms; overlay + keep 1 + 0.5
# and 2 ms), the cut last one, a batch span inside each.
FRAME_OPS = [
    (5.00, 5.01, "frame"), (5.001, 5.005, "sync.upload"),
    (5.002, 5.004, "batch"), (5.006, 5.007, "sync.fetch"),
    (5.007, 5.008, "frame.overlay"), (5.008, 5.0085, "frame.keep"),
    (5.02, 5.04, "frame"), (5.021, 5.027, "sync.readback"),
    (5.03, 5.032, "frame.overlay"),
    (5.05, 5.06, "frame"), (5.051, 5.059, "sync.fetch"),
]
READS = {
    "host_ms_per_frame.batch": (BATCH_OPS, (3 + 5) / 8),
    "sync_ms_per_frame.batch": (BATCH_OPS, (0.5 + 0.25 + 1) / 8),
    "sync_ms.frame": (FRAME_OPS, (5 + 6) / 2),
    "host_tail_ms.frame": (FRAME_OPS, (1.5 + 2) / 2),
}


@pytest.mark.parametrize("name", sorted(READS))
def test_span_readers_read_requests_inside_the_window(name):
    ops, want = READS[name]
    assert spec.metric_reader(name)(record(ops)) == pytest.approx(want)


def counters_with(tests: int, pixels: int) -> kernels.MarchCounters:
    c = kernels.MarchCounters()
    c.work(torch.device("cpu"))[2] += tests
    c.shade_pixels += pixels
    return c


def test_slab_reader_reads_the_counted_tests_a_pixel(monkeypatch):
    monkeypatch.setattr(shadow_cuda, "counters", counters_with(600, 24))
    read = spec.metric_reader("slab_tests_per_pixel.batch")
    assert read(record([])) == pytest.approx(25.0)
    # A run that was not traced has nothing to read.
    assert read(harness.RunRecord("x", 3, 12, 1.0, [], 100, {})) is None


NEW = sorted(READS) + ["slab_tests_per_pixel.batch"]


@pytest.mark.parametrize("name", NEW)
def test_new_readers_with_nothing_to_read_return_nothing(name, monkeypatch):
    # A counter that counted nothing, spans the parent program does not
    # open, and a request cut at the window's end alone.
    monkeypatch.setattr(shadow_cuda, "counters", counters_with(0, 0))
    read = spec.metric_reader(name)
    for ops in ([], [(1.0, 2.0, "aten::mul")], [(1.0, 2.0, "batch"),
                                                (1.5, 2.0, "frame")]):
        assert read(record(ops)) is None


def test_requests_take_their_parts_once_and_skip_other_names():
    ops = [(1.0, 2.0, "batch"), (1.2, 1.4, "batch.bins"),
           (1.25, 1.3, "sync.upload"), (3.0, 4.0, "batch"),
           (5.0, 6.0, "aten::cat")]
    got = spans.requests(profiling.Trace([], ops, 6.0), "batch")
    assert got == [(1.0, 2.0, [(1.2, 1.4, "batch.bins"),
                               (1.25, 1.3, "sync.upload")]),
                   (3.0, 4.0, [])]
    assert spans.part_s(got[0], "sync.") == pytest.approx(0.05)


# -- on the card --------------------------------------------------------------

def card_inputs(cuda):
    r, ds, cache, players, lights = batch_inputs(cuda)
    be, cnt = batched.bin_stage(r, cache, ds, players)
    winners = trace_cuda.trace_winners(ds.pos, ds.ext, ds.sprite_id,
                                       ds.atlas_depth, be, cnt, players,
                                       SMALL)
    return (winners, ds.pos, ds.ext, ds.sprite_id, ds.atlas_color,
            ds.atlas_depth, ds.atlas_normal, ds.palette, be, cnt, players,
            lights, SMALL)


@pytest.mark.cuda
def test_cuda_counted_slab_tests_equal_the_plain_march(cuda):
    args = card_inputs(cuda)
    plain = shadow_cuda.shade_point(*args)
    shadow_cuda.counters.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        counted = shadow_cuda.shade_point(*args)
    torch.cuda.synchronize()
    c = shadow_cuda.counters.read()
    work = {}
    want = shade.point_frames(*(a.cpu() if torch.is_tensor(a) else a
                                for a in args), work=work)
    assert c["direct_pixels"] == 0
    assert torch.equal(counted, plain) and torch.equal(counted.cpu(), want)
    assert c["shade_pixels"] == len(LIGHTS) * 80 * 80
    assert c["shade_slab_tests"] == int(work["slab_tests"]) > 0


@pytest.mark.cuda
def test_cuda_untraced_launch_passes_no_counter(cuda, monkeypatch):
    args = card_inputs(cuda)
    lib = kernels.library()
    real = lib.par_shadow_shade
    seen = []

    def spy(*a):
        seen.append(a[15])
        return real(*a)

    monkeypatch.setattr(lib, "par_shadow_shade", spy)
    work = shadow_cuda.counters.work(args[8].device)
    shadow_cuda.counters.reset()
    shadow_cuda.shade_point(*args)
    torch.cuda.synchronize()
    c = shadow_cuda.counters.read()
    assert seen == [None]
    assert c["shade_slab_tests"] == 0 and c["shade_pixels"] == 0
    with profile(activities=[ProfilerActivity.CPU]):
        shadow_cuda.shade_point(*args)
    assert seen[1] == work.data_ptr()
    assert not tracing.active()


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["render_states_batched", "session_feed"])
def test_cuda_paths_sync_only_inside_sync_spans(cuda, path, monkeypatch):
    go = run_path(path, cuda)
    go()
    torch.cuda.synchronize()

    @contextlib.contextmanager
    def allow_sync(name):
        if not name.startswith("sync."):
            yield
            return
        mode = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode(0)
        try:
            yield
        finally:
            torch.cuda.set_sync_debug_mode(mode)

    monkeypatch.setattr(tracing, "span", allow_sync)
    torch.cuda.set_sync_debug_mode("error")
    try:
        go()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()


def test_viewer_profile_flag_writes_the_spans_into_a_chrome_trace(
        tmp_path, monkeypatch):
    import json

    from pixel_art_raytracer_tpu_torch.models import deferred
    from pixel_art_raytracer_tpu_torch.runtime import viewer

    monkeypatch.setattr(deferred, "resolve",
                        lambda device=None: torch.device("cpu"))
    viewer.main(["--scene", "demo", "--bench", "--frames", "1",
                 "--profile", str(tmp_path)])
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    names = [e.get("name") for e in events]
    assert names.count("frame") == 1
    assert {"batch", "batch.bins", "sync.upload", "sync.fetch",
            "sync.readback", "frame.overlay"} <= set(names)


def test_span_split_reads_each_span_of_a_live_request():
    from pixel_art_raytracer_tpu_torch import span_split

    session = Session(small_scene(), config=SMALL, device="cpu")
    ms = span_split.split(session, requests=3, warm_up=1)
    assert {"frame", "frame.overlay", "frame.keep", "batch", "batch.bins",
            "sync.upload", "sync.fetch", "sync.readback"} <= set(ms)
    assert all(n.startswith(span_split.PREFIXES) for n in ms)
    assert all(v > 0 for v in ms.values())
    # A span's time holds the spans inside it.
    assert ms["frame"] >= ms["batch"] >= ms["batch.bins"]
    assert len(session.frames) == 4
