"""Seeded-bad fixture: a tail prefill that scatters into a SHARED prefix
page (``shared-page-write``, ``GRAFTCHECK_TORCH_ALIAS_AUDIT``).

The engine mounts a donated system-prompt page for a live request; the
dispatch below hands the prefill that page as the tail's OWN page — the
page-id mix-up that would overwrite every sharing slot's system prompt.
Imports only numpy and the port, so the card's machine (no JAX) runs it.
"""
import numpy as np

from k8s_gpu_scheduler_tpu_torch.analysis.entrypoints import (
    TINY, _pools, _prefix_engine, _shared, _tokens)


def _scatter_into_shared(device, size=TINY):
    eng, rng = _prefix_engine(device, size)
    shared = _shared(eng)
    ps = eng.page_size
    kw = dict(slots=np.ones(2, np.int32),
              page_ids=np.full((2, 1), shared[0], np.int32),   # the bug
              prefix_tables=np.zeros((2, 0), np.int32),
              hit_lens=np.zeros(2, np.int32),
              tokens=np.asarray([_tokens(rng, eng, ps)] * 2, np.int32),
              tail_lens=np.full(2, ps, np.int32), seed=(eng.seed, 1, 7))
    return (lambda: eng._op_prefill(**kw)), _pools(eng), shared


GRAFTCHECK_TORCH_ALIAS_AUDIT = [
    ("prefill_scatters_into_shared_page", _scatter_into_shared)]
