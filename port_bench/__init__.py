"""The benchmark of ``realism_effects_tpu_torch`` on one NVIDIA H100.

``python -m port_bench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json``: its configuration
(``configs/<config>.json``: scene generator, effect stack), its traffic
(``traffic/<traffic>.json``: resolution, camera and object motion,
warm-up, the comparison's limits, the table of kernel launches a frame)
and its per-layer metrics (``metrics/<metric>.py``), each found by the
name the manifest gives it. Scenes and motions are generators under
``scenes/`` and ``motions/``; each CUDA kernel's bytes and operations a
launch are in ``kernels/<kernel>.py``; ``reference/`` holds the plain
PyTorch reference the outputs are held against.
"""
