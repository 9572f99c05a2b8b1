"""The benchmark of the PyTorch/CUDA port (``k8s_gpu_scheduler_tpu_torch``).

    python -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything that belongs to one configuration, traffic mix, cell or metric
lives in a file of its own, found by the name ``BENCHMARK.json`` gives it:
``configs/<config>.json``, ``traffic/<mix>.json``, ``workloads/<cell>.json``
and ``metrics/<metric>.py``. ``reference/`` is the plain float32 PyTorch
reference that decides ``correct``; it imports nothing of the port.
"""
