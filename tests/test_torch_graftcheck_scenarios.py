"""The port's dynamic graftcheck scenarios on the CPU, at the tiny
config (2 layers, page 8): every shared-page scenario leaves its shared
pages byte-identical, and every steady-state scenario keeps its storage
with no rebuild; the block table keeps its storage across admissions.
The same scenarios run on the card in tests/test_torch_gpu.py and
chip_smoke.py phase 21."""
import numpy as np
import pytest
import torch

from k8s_gpu_scheduler_tpu_torch.analysis import entrypoints as eps
from k8s_gpu_scheduler_tpu_torch.analysis.alias import audit_shared_pages
from k8s_gpu_scheduler_tpu_torch.analysis.steady import run_steady


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The tiny scenarios' tensors are too small to split among threads:
    one thread keeps them from contending with other test processes for
    the cores (about 3x faster under load)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name,build", eps.alias_scenarios(),
                         ids=[n for n, _ in eps.alias_scenarios()])
def test_alias_scenario_clean_on_cpu(name, build):
    assert audit_shared_pages(build, name, torch.device("cpu")) == []


@pytest.mark.parametrize("name,build", eps.steady_scenarios(),
                         ids=[n for n, _ in eps.steady_scenarios()])
def test_steady_scenario_clean_on_cpu(name, build):
    findings, stats = run_steady(build, name, torch.device("cpu"))
    assert findings == []
    assert stats["tracked"], "the scenario tracked nothing"
    # On the CPU the wrappers call their plain versions: the steady
    # dispatches went through a kernel's wrapper.
    assert stats["launches"] and all(
        k.endswith("_reference") for k in stats["launches"])


def test_block_table_keeps_its_storage_across_admissions():
    """The paged engine's device block table is brought up to the host
    mirror in place: admissions between dispatches change its contents,
    never its storage (the steady-state audit's table check)."""
    eng, rng = eps._engine(torch.device("cpu"), eps.TINY, n_slots=2)
    ptr = eng._table.untyped_storage().data_ptr()
    seen = set()
    for wave in range(3):
        for _ in range(2):
            eng.submit(eps._tokens(rng, eng, 6 + wave), max_new=3)
        while eng.pending:
            eng.step()
            seen.add(eng._table.clone().numpy().tobytes())
            assert eng._table.untyped_storage().data_ptr() == ptr
    assert len(seen) > 1, "the table never changed"
    np.testing.assert_array_equal(eng._device_table().numpy(),
                                  eng._table_np)
