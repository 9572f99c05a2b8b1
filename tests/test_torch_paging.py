"""The port's page allocator and radix prefix cache against the JAX
package's on one recorded trace of admissions and reaps.

Both sides are host-side bookkeeping over page ids, so they must agree
exactly: every match, allocation, adoption and eviction returns the same
page ids, the counters end equal, and the pool partitions cleanly after
every operation."""
import numpy as np
import pytest

from k8s_gpu_scheduler_tpu.models.paging import PageAllocator as JAllocator
from k8s_gpu_scheduler_tpu.models.prefix_cache import PrefixCache as JCache
from k8s_gpu_scheduler_tpu_torch.models.paging import NULL_PAGE, PageAllocator
from k8s_gpu_scheduler_tpu_torch.models.prefix_cache import PrefixCache

PS = 4


def replay(alloc_cls, cache_cls, seed, n_pages=24, steps=120):
    """Drive one allocator + cache through a seeded trace of admissions
    (match, retain the hit, evict for room, allocate the rest) and reaps
    (donate the conversation's full pages, free the others). Returns every
    value the two classes handed back, and their final metrics."""
    rng = np.random.default_rng(seed)
    alloc = alloc_cls(n_pages)
    cache = cache_cls(alloc, PS)
    systems = [list(rng.integers(0, 50, 3 * PS)) for _ in range(3)]
    live, log = [], []
    for _ in range(steps):
        if live and (len(live) >= 4 or rng.random() < 0.4):
            tokens, hits, own = live.pop(int(rng.integers(len(live))))
            conv = tokens + list(rng.integers(0, 50, int(rng.integers(0, 6))))
            n_full = min(len(conv) // PS, len(hits) + len(own))
            adopted = cache.insert(conv[:n_full * PS], (hits + own)[:n_full],
                                   prompt_len=len(tokens))
            alloc.free([p for p in hits + own if p not in set(adopted)])
            log.append(("reap", adopted))
        else:
            sys_p = systems[int(rng.integers(len(systems)))]
            tokens = sys_p[:int(rng.integers(0, len(sys_p) + 1))] + list(
                rng.integers(0, 50, int(rng.integers(1, 7))))
            hits = cache.match(tokens)
            if hits:
                alloc.retain(hits)
            need = -(-(len(tokens) + 4) // PS) - len(hits)
            evicted = (cache.evict(need - alloc.free_count)
                       if need > alloc.free_count else 0)
            own = alloc.alloc(need)
            if own is None:
                if hits:
                    alloc.free(hits)
            else:
                live.append((tokens, hits, own))
            log.append(("admit", hits, evicted, own))
        alloc.assert_consistent()
    return log, alloc.metrics(), cache.metrics()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_trace_matches_jax(seed):
    got = replay(PageAllocator, PrefixCache, seed)
    ref = replay(JAllocator, JCache, seed)
    assert got[0] == ref[0]
    assert got[1] == {k: ref[1][k] for k in got[1]}
    assert got[2] == {k: ref[2][k] for k in got[2]}
    # The trace really exercised sharing, donation and eviction.
    assert got[2]["prefix_lookup_hits"] > 0
    assert got[2]["prefix_inserted_pages"] > 0
    assert got[2]["prefix_evictions"] > 0


def test_allocator_refuses_what_would_corrupt_the_pool():
    for cls in (PageAllocator, JAllocator):
        alloc = cls(4)
        pages = alloc.alloc(2)
        with pytest.raises(ValueError):
            alloc.free([NULL_PAGE])
        alloc.free(pages[:1])
        with pytest.raises(RuntimeError, match="double free"):
            alloc.free(pages[:1])
        alloc.adopt(pages[1:])
        with pytest.raises(RuntimeError, match="still cached"):
            alloc.free(pages[1:])
        assert alloc.alloc(5) is None
        alloc.assert_consistent()
