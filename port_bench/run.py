"""The port's benchmark: one run of one cell on the card.

    python -m port_bench.run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Reads the cell from ``BENCHMARK.json`` beside this folder, makes its
scene and traffic from the seed, sets up and warms the program
(``pixel_art_raytracer_tpu_torch``), measures for ``--seconds`` and
compares a seeded sample of what the window delivered with the plain
reference (``port_bench/reference``), pixel for pixel.  With ``--trace 0``
the result carries the cell's end-to-end metrics; with ``--trace 1`` its
per-layer metrics, read from a profiler trace of the window's last
seconds and from a stage-by-stage drive with CUDA events, with the device
trace's busy time and the most time-consuming operations and idle gaps.

The last line of standard output is one JSON object (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1``
``breakdown``, and last ``compared``: each number compared with its
limit); the last lines of standard error repeat what was compared.  It
exits with another code than 0 and prints no result without enough CUDA
cards, or when the JAX package, ``jax``, ``jaxlib`` or ``flax`` is loaded
once the window has closed.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402

from port_bench import harness, spec  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "pixel_art_raytracer_tpu")
# The comparison: no pixel may differ from the reference's frame.
DIFFERING_PIXELS_LIMIT = 0


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name, compared whole, is one the
    benchmark must not load."""
    return sorted({m for m in sys.modules if m.split(".")[0] in FORBIDDEN})


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else ""


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def result(cell, record, setup_s, peak, compared, device, trace) -> dict:
    """The result line's object."""
    values = harness.end_to_end(record, setup_s)
    metrics = {}
    if trace:
        for m in cell.per_layer:
            v = spec.metric_reader(m["name"])(record)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        for m in cell.end_to_end:
            if m["name"] in values:
                metrics[m["name"]] = {"value": values[m["name"]],
                                      "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": cell.chips, "memory_peak_bytes": peak}
    out = {"correct": None, "attempted": record.attempted, "failed": 0,
           "metrics": metrics, "device": dev}
    if trace and record.trace is not None:
        dev["busy_s"] = record.trace.busy_s
        dev["window_s"] = record.trace.window_s
        out["breakdown"] = {"device_ops": record.trace.device_ops(),
                            "idle_gaps": record.trace.idle_gaps()}
    want = min(record.units, cell.traffic.get(
        "sample_frames", cell.traffic.get("sample_requests")))
    out["compared"] = {
        "differing_pixels": {"value": compared["differing_pixels"],
                             "limit": DIFFERING_PIXELS_LIMIT,
                             "holds": "at most"},
        "frames_compared": {"value": compared["frames_compared"],
                            "limit": want, "holds": "at least"}}
    out["correct"] = (compared["differing_pixels"] <= DIFFERING_PIXELS_LIMIT
                      and compared["frames_compared"] >= want)
    return out


def main(argv=None) -> int:
    args = parse(argv)
    cell = spec.load_cell(args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"{cell.name} needs {cell.chips} CUDA card(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    # One process, one host thread for the CPU's operators: the host
    # paces the graybox cells, and idle worker threads only add noise.
    torch.set_num_threads(1)
    record, setup_s, peak, compared = harness.run(
        cell, args.seed, args.seconds, bool(args.trace), device, T_START)
    out = result(cell, record, setup_s, peak, compared, device, args.trace)
    found = forbidden_modules()
    if found:
        print(f"loaded after the window: {', '.join(found)}", file=sys.stderr)
        return 3
    card = card_line()
    print(f"card: {card}", file=sys.stderr)
    print(f"{record.attempted} requests, {record.units} "
          f"{'frames' if not record.latencies_s else 'answered'} in "
          f"{record.window_s:.3f} s", file=sys.stderr)
    done = record.completed
    if record.latencies_s:
        done = np.cumsum(record.latencies_s)
    if len(done) > 1:
        done = np.asarray(done) - done[0]
        per_s = np.bincount(done.astype(int))
        print(f"completed a second: {per_s.tolist()}", file=sys.stderr)
    if record.latencies_s:
        q = np.percentile(record.latencies_s, [50, 90, 95, 99, 100]) * 1e3
        print(f"latency ms over {len(record.latencies_s)} requests: p50 "
              f"{q[0]:.4f}, p90 {q[1]:.4f}, p95 {q[2]:.4f}, p99 {q[3]:.4f}, "
              f"max {q[4]:.4f}", file=sys.stderr)
    for name, c in out["compared"].items():
        print(f"{name} {c['value']} (limit: {c['holds']} {c['limit']})",
              file=sys.stderr)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
