"""The port's deploy entry point, ``python -m
k8s_gpu_scheduler_tpu_torch.models.llama``, on the CPU: ``main()``'s
flags are the JAX entry point's, its ``--serve`` branch runs the serve
loop of the JAX ``main()`` (warmup, waves, the wave line, SIGTERM →
drain at the wave boundary → exit 0, boot from the drained snapshot), its
training branch refuses the 32-layer llama3_8b step before allocating,
and ``train_loop`` resumed from a ``TrainCheckpointer`` continues bit for
bit. The serve tests patch ``LlamaConfig.serve`` to the tiny f32 config
(the full width runs on the card, ``chip_smoke.py`` phase 10)."""
import dataclasses
import inspect
import re
import signal

import numpy as np
import pytest
import torch

from k8s_gpu_scheduler_tpu.models import llama as jllama
from k8s_gpu_scheduler_tpu_torch.models import lifecycle, llama
from k8s_gpu_scheduler_tpu_torch.models.llama import (
    LlamaConfig, init_params, main, make_optimizer, serve_loop, train_loop)
from k8s_gpu_scheduler_tpu_torch.models.serving import ContinuousBatcher

WAVE = re.compile(r"^llama serve qps=([\d.]+) decode_tok_s=([\d.]+) "
                  r"prefill_tok=(\d+) slo=([\d.]+) p99_ms=([\d.]+)$")
TINY = dataclasses.replace(LlamaConfig.tiny(), dtype=torch.float32,
                           decode_attn="fused")


class AfterWaves(lifecycle.PreemptionGuard):
    """A guard whose drain request comes at the wave boundary after
    ``waves`` waves (the first read is before the first wave)."""

    waves = 1

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.reads = 0

    @property
    def requested(self):
        self.reads += 1
        return self.reads > self.waves or super().requested


@pytest.fixture
def sigterm():
    prev = signal.getsignal(signal.SIGTERM)
    yield
    signal.signal(signal.SIGTERM, prev)


def test_flags_are_the_jax_entry_points():
    """Every flag and default of JAX's ``main()`` parser, and no other."""
    def flags(src):
        return re.findall(r'add_argument\(\s*"(--[\w-]+)"(?:[^)]*?default='
                          r'([^,)\n]+))?', src)
    port = flags(inspect.getsource(main))
    want = flags(inspect.getsource(jllama.main))
    assert port == want and len(port) == 9


def test_help_states_the_fused_decode(capsys):
    with pytest.raises(SystemExit) as e:
        main(["--help"], device="cpu")
    assert e.value.code == 0
    assert "decode_attn='fused'" in capsys.readouterr().out


def test_serve_loop_drains_at_the_wave_boundary(tmp_path, capsys):
    """One wave, a drain request from the publish hook, then the drain:
    the wave line parses, ``publish`` got (qps, p99_ms), the loop exits
    0, and the drained directory loads with ``load_snapshot`` (no request
    in flight: a wave drains what it submits)."""
    model = init_params(TINY, torch.Generator().manual_seed(0), "cpu")
    eng = ContinuousBatcher(model, TINY, n_slots=2, max_len=64, chunk=4,
                            prefill_bucket=16, kv_layout="paged",
                            page_size=8, device="cpu")
    guard = lifecycle.PreemptionGuard()
    calls, slept = [], []

    def publish(qps, p99_ms=0.0):
        calls.append((qps, p99_ms))
        guard.request()

    snap_dir = str(tmp_path / "serve_snapshot")
    with pytest.raises(SystemExit) as e:
        serve_loop(eng, TINY, 12, 4, guard, snap_dir=snap_dir,
                   publish=publish, slo=0.5, sleep=slept.append)
    assert e.value.code == 0
    out = capsys.readouterr().out.splitlines()
    m = WAVE.match(out[0])
    assert m and float(m.group(2)) > 0 and m.group(3) == str(8 * 12)
    assert m.group(4) == "0.5"
    assert out[1] == f"llama serve worker=0 drained 0 requests to {snap_dir}"
    assert len(calls) == 1 and calls[0][0] > 0 and calls[0][1] > 0
    assert len(slept) == 1
    snap = lifecycle.load_snapshot(snap_dir)
    assert snap is not None and snap.n_requests_in_flight == 0
    assert snap.fingerprint == eng.fingerprint()


def test_serve_loop_stops_after_max_waves():
    model = init_params(TINY, torch.Generator().manual_seed(0), "cpu")
    eng = ContinuousBatcher(model, TINY, n_slots=2, max_len=64, chunk=4,
                            prefill_bucket=16, kv_layout="paged",
                            page_size=8, device="cpu")
    assert serve_loop(eng, TINY, 8, 3, lifecycle.PreemptionGuard(),
                      max_waves=2, sleep=lambda s: None) == 2
    assert not eng.pending


def test_main_serves_drains_and_boots_from_the_snapshot(
        tmp_path, capsys, monkeypatch, sigterm):
    """``main(["--serve", ...])`` twice on one ``--ckpt-dir``: each serves
    a wave, drains on the guard's request and exits 0 (the second after
    booting through ``resume_or_fresh`` from the first's snapshot, the
    lineage's second persisted step); ``--int8`` serves too."""
    monkeypatch.setattr(LlamaConfig, "serve", staticmethod(lambda: TINY))
    monkeypatch.setattr(lifecycle, "PreemptionGuard", AfterWaves)
    restored = []
    real_restore = ContinuousBatcher.restore
    monkeypatch.setattr(ContinuousBatcher, "restore", lambda self, s: (
        restored.append(s.n_requests_in_flight), real_restore(self, s))[1])
    argv = ["--serve", "--prompt-len", "16", "--max-new", "4",
            "--ckpt-dir", str(tmp_path)]
    lines = []
    for extra in ([], [], ["--int8"]):
        with pytest.raises(SystemExit) as e:
            main(argv + extra, device="cpu")
        assert e.value.code == 0
        lines.append(capsys.readouterr().out.splitlines())
    for out in lines:
        assert len(out) == 2 and WAVE.match(out[0])
        assert out[1].endswith("drained 0 requests to "
                               f"{tmp_path}/serve_snapshot")
    assert restored == [0, 0]
    assert lifecycle.load_snapshot(str(tmp_path / "serve_snapshot"))


def test_training_branch_refuses_before_allocating(monkeypatch):
    """Without ``--serve`` the 32-layer llama3_8b step is refused with its
    state's byte count, naming the multi-device item, and nothing is
    allocated."""
    monkeypatch.setattr(llama, "init_params", lambda *a, **k: pytest.fail(
        "allocated"))
    with pytest.raises(SystemExit) as e:
        main(["--ckpt-dir", "unused"], device="cpu")
    msg = str(e.value.code)
    assert str(llama.train_state_bytes(LlamaConfig.llama3_8b())) in msg
    assert "Multi-device" in msg
    assert llama.train_state_bytes(LlamaConfig.llama3_8b()) == \
        8 * 8_030_261_248


def test_a_gang_of_workers_is_refused(monkeypatch):
    """A gang of workers trains (``tests/test_torch_shard_train.py``) and
    serves ``make_server_step`` (``tests/test_torch_gang_serve.py``);
    ``--serve`` on a gang refuses the four flags that handler cannot
    honour (full precision, greedy, a fixed budget) with JAX's message,
    which names the gang's process count, before anything is allocated
    or any rank joins."""
    monkeypatch.setenv("TPU_WORKER_HOSTNAMES", "w0.gang,w1.gang")
    monkeypatch.setattr(llama, "init_params", lambda *a, **k: pytest.fail(
        "allocated"))
    monkeypatch.setattr(llama, "_serve_rank", lambda *a, **k: pytest.fail(
        "joined"))
    for flags in (["--int8"], ["--temperature", "0.7"], ["--top-k", "5"],
                  ["--eos-id", "3"]):
        with pytest.raises(SystemExit) as e:
            main(["--serve", *flags], device="cpu")
        assert e.value.code == (
            "--int8/--temperature/--top-k/--eos-id need the continuous "
            "batcher, which is single-process only; this gang has 2 "
            "processes"), flags


def test_parameter_count_is_the_modules():
    """Dense, GQA and MoE (experts and router counted; the f32 router's
    state at 4 bytes an entry)."""
    for cfg in (TINY, dataclasses.replace(TINY, n_kv_heads=2),
                dataclasses.replace(TINY, n_experts=4,
                                    dtype=torch.bfloat16)):
        model = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
        assert llama.n_params(cfg) == sum(p.numel()
                                          for p in model.parameters())
        assert llama.train_state_bytes(cfg) == 4 * sum(
            p.numel() * p.element_size() for p in model.parameters())
    mixtral = dataclasses.replace(LlamaConfig.llama3_8b(), vocab=32000,
                                  n_experts=8)
    assert llama.n_params(mixtral) == 46_702_792_704


def test_wave_p99_is_the_jax_loops_pick():
    lats = {i: {"latency_s": x} for i, x in enumerate(
        np.random.default_rng(0).random(33))}
    ms = sorted(m["latency_s"] * 1000 for m in lats.values())
    assert llama.wave_p99_ms(lats) == ms[round(0.99 * 32)]
    assert llama.wave_p99_ms({}) == 0.0


def test_train_loop_resumes_bit_for_bit(tmp_path, capsys):
    """Four steps straight, against two steps checkpointed at step 2 by
    ``TrainCheckpointer`` and steps 3–4 on fresh objects restored from
    it: the losses are equal bit for bit (flash attention's plain
    versions, remat, f32)."""
    from k8s_gpu_scheduler_tpu_torch.utils.checkpoint import (
        TrainCheckpointer)

    cfg = dataclasses.replace(LlamaConfig.tiny("flash"), dtype=torch.float32,
                              remat=True)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (2, 32)))
    batch = {"tokens": tokens, "targets": torch.roll(tokens, -1, 1)}

    def fresh():
        model = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
        return model, make_optimizer(model, 3e-4)

    ref = train_loop(*fresh(), batch, max_steps=4)
    d = str(tmp_path / "ck")
    first = train_loop(*fresh(), batch, TrainCheckpointer(d), every=2,
                       max_steps=2)
    ck = TrainCheckpointer(d)
    step_no, (model, opt) = ck.restore_or(fresh)
    assert step_no == 2
    rest = train_loop(model, opt, batch, ck, step_no=step_no, every=2,
                      max_steps=4)
    assert [x.item() for x in first + rest] == [x.item() for x in ref]
    assert TrainCheckpointer(d).all_steps() == [2, 4]
    out = capsys.readouterr().out.splitlines()
    assert out[-1].startswith("llama pretrain worker=0 step=4 tok/s=")


def test_main_signature():
    sig = inspect.signature(main)
    assert sig.parameters["device"].default == "cuda"
    assert sig.parameters["device"].kind is inspect.Parameter.KEYWORD_ONLY
