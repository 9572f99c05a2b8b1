"""Seeded-bad fixture: a pool copied per dispatch (``storage-not-kept``,
``GRAFTCHECK_TORCH_STEADY_AUDIT``).

``CopyingBatcher`` takes a "defensive" copy of its page pool before every
decode dispatch: the streams stay right, but every dispatch holds two
pools for a moment and a captured graph's pointers dangle. The steady
audit sees the pool's storage change after warm-up.
"""
import numpy as np

from k8s_gpu_scheduler_tpu_torch.analysis import entrypoints as eps
from k8s_gpu_scheduler_tpu_torch.analysis.steady import engine_tensors
from k8s_gpu_scheduler_tpu_torch.models.serving import ContinuousBatcher


class CopyingBatcher(ContinuousBatcher):
    def _op_decode(self, active, seed):
        self._k, self._v = self._k.clone(), self._v.clone()     # the bug
        return super()._op_decode(active, seed)


def _copying_pool(device, size=eps.TINY):
    cfg = eps._cfg(size)
    eng = CopyingBatcher(eps._model(size, cfg, device), cfg, n_slots=2,
                         max_len=size.max_len, chunk=size.chunk,
                         kv_layout="paged", page_size=size.page_size,
                         device=device)
    rng = np.random.default_rng(0)

    def warmup():
        for _ in range(2):
            eng.submit([int(t) for t in rng.integers(0, cfg.vocab, 12)],
                       max_new=24)
        eng.step()
        eng.step()

    return warmup, [eng.step] * 3, lambda: engine_tensors(eng)


GRAFTCHECK_TORCH_STEADY_AUDIT = [("pool_copied_per_dispatch", _copying_pool)]
