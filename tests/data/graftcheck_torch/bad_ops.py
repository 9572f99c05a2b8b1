"""Seeded-bad fixture: op-audit true positives in one toy step
(``GRAFTCHECK_TORCH_OP_AUDIT``), the four defects of the JAX package's
``bad_jaxpr.py`` in the form the port's op audit sees them:

- it uploads a 4 MiB host weight matrix on every call instead of keeping
  it on the device (``per-call-upload``, JAX's ``captured-const``);
- it upcasts a large bf16 activation to f32 mid-path (``f32-upcast``);
- it reads a value back to the host on every tick of its loop
  (``host-transfer``, an error: the count grows with the loop);
- it computes a product nothing reads (``dead-output``).

Imports only numpy, torch and the port, so the card's machine runs it.
"""
import numpy as np
import torch

from k8s_gpu_scheduler_tpu_torch.analysis.opaudit import OpEntry

_W = np.ones((1024, 1024), np.float32)          # 4 MiB of host weights


def _bad_toy_step(device, loop):
    x0 = torch.zeros((512, 1024), dtype=torch.bfloat16, device=device)

    def step(x):
        w = torch.as_tensor(_W, device=device)          # uploaded every call
        for _ in range(loop):
            float(x[0, 0])                              # host round trip
            h = (x @ w.to(torch.bfloat16)).float()      # upcast
            unused = h * 2.0                            # dead output
            x = h.to(torch.bfloat16)
        return x

    return step, (x0,)


GRAFTCHECK_TORCH_OP_AUDIT = [
    ("bad_toy_step", OpEntry(_bad_toy_step, loop=(2, 3))),
]
