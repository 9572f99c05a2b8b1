"""Seeded-bad fixture: dispatch-body and host-sync true positives.

Run through the port's graftcheck (``python -m
k8s_gpu_scheduler_tpu_torch.analysis tests/data/graftcheck_torch``) it
must fail: ``decode_step`` is registered as a dispatch body (the
``GRAFTCHECK_DISPATCH_BODIES`` opt-in), and it reads the host clock, runs
host numpy, reads a value back, casts a tensor to a Python int (through
``_pick``, a same-module callee) and opens a span; ``summary`` reads a
tensor back outside any dispatch. tests/test_torch_graftcheck.py asserts
each rule fires.
"""
import time

import numpy as np
import torch

GRAFTCHECK_DISPATCH_BODIES = ("decode_step",)


def _pick(probs):
    return int(probs.argmax())                  # host-sync-in-dispatch


def decode_step(x, tracer):
    t0 = time.perf_counter()                    # host-time-in-dispatch
    scale = np.sqrt(x.shape[-1])                # numpy-in-dispatch
    probs = torch.softmax(x / scale, dim=-1)
    if probs.max().item() > 0.5:                # host-sync-in-dispatch
        tracer.span("decode", t0)               # trace-in-dispatch
    return _pick(probs)


def summary(x):
    return x.cpu()                              # host-sync
