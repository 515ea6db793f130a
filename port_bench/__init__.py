"""The benchmark of the PyTorch and CUDA port (``pixel_art_raytracer_tpu_torch``).

``python3 -m port_bench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` on the card.  Each
configuration (``configs/``), traffic mix (``traffic/``), entry
point's loop (``entries/``) and per-layer metric (``metrics/``) is a file
found by its name; the plain reference that decides ``correct`` is
``reference/``.  Nothing here imports ``jax`` or the JAX package.
"""
