"""Executable entry points of the port's control plane. Run the scheduler
with ``python -m k8s_gpu_scheduler_tpu_torch.cmd.scheduler``."""
