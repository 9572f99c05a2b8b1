"""Tier-1 gate: the port's tree must stay graftcheck-clean.

The port's twin of tests/test_graftcheck_clean.py. Runs the port's FAST
passes (the AST lint with its dispatch-body, host-sync, lock, retry,
trace and suppression rules; the lock-order and in-place-buffer audit;
the determinism lint; the shared-memory budgeter) over
k8s_gpu_scheduler_tpu_torch/, and fails with the rendered
``file:line: [rule] message`` list if anything regressed. The dynamic
passes (shared pages, steady state, wire formats) have their tests in
tests/test_torch_graftcheck.py; the whole run is ``python -m
k8s_gpu_scheduler_tpu_torch.analysis --device cpu``.

Suppression policy: ``# graftcheck: ignore[rule]`` with a rationale in
the same comment or the comment-only line above (README, "graftcheck for
the port").
"""
from k8s_gpu_scheduler_tpu_torch.analysis import package_root, run_fast_passes


def test_port_tree_is_graftcheck_clean():
    report = run_fast_passes([package_root()])
    assert not report.findings, "\n" + report.render(
        header="graftcheck regressions in the port (fix them or suppress "
               "WITH a rationale — see README):")
    assert set(report.pass_seconds) == {"astlint", "lockorder",
                                        "determinism", "smem"}
