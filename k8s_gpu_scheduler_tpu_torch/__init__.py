"""PyTorch/CUDA port of the k8s_gpu_scheduler_tpu workload layer.

This package sits beside the JAX package and keeps its module names:
``ops/`` holds the transformer primitives and the paged attention entry
points (each a hand-written CUDA kernel for Hopper plus its plain PyTorch
version), ``models/`` holds the Llama decoder and the paged, prefix-cached
``ContinuousBatcher``; ``api/``, ``cluster/``, ``sched/``, ``plugins/`` and
``cmd/`` hold the scheduler's control plane that places the pods. It imports ``torch`` and ``numpy`` only — never
``jax`` and nothing of the JAX package, whose numpy-only modules it keeps
trimmed copies of.

Entry points take ``device=`` and default to ``"cuda"``: without a card
they raise unless the caller asked for the CPU (``device.resolve_device``).
On a CPU tensor every kernel wrapper runs its plain version; on a CUDA
tensor it launches the kernel or raises.
"""
__all__ = ["resolve_device"]


def __getattr__(name):
    # Imported at first use: the node agent, the registry CLI and the
    # scheduler import subpackages of this one and never need torch.
    if name == "resolve_device":
        from .device import resolve_device
        return resolve_device
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
