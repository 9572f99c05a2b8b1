"""The port's workload utilities against the JAX package's: the training
checkpointer, the enforcement of the scheduler-injected limits, the RESP
registry client and the recommender publisher.

- ``TrainCheckpointer``: one save sequence through both (orbax in JAX,
  ``torch.save`` step directories in the port) keeps the same steps —
  numbering, ``maybe_save`` cadence, ``max_to_keep`` pruning — and a
  restore gives back a model and its AdamW state exactly (bit for bit),
  so training continues as if never stopped.
- Enforcement: the memory fraction and every pacing sleep equal JAX's
  for the same env and per-chip bytes (exact floats; the clocks are
  replaced by a fake one in both modules).
- The registry client and the publisher talk to one in-process RESP
  server on 127.0.0.1; the keys and values the two packages write are
  equal (the sample's ``at`` wall time aside)."""
import dataclasses
import json
import os
import socketserver
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_gpu_scheduler_tpu.recommender import collector as jcollector
from k8s_gpu_scheduler_tpu.registry import client as jclient
from k8s_gpu_scheduler_tpu.utils import checkpoint as jcheckpoint
from k8s_gpu_scheduler_tpu.utils import enforcement as jenf
from k8s_gpu_scheduler_tpu_torch.models.llama import (
    LlamaConfig, init_params, make_optimizer, make_train_step)
from k8s_gpu_scheduler_tpu_torch.recommender import collector
from k8s_gpu_scheduler_tpu_torch.registry import client, inventory
from k8s_gpu_scheduler_tpu_torch.utils import checkpoint, enforcement

V5E = "tpu-v5-lite-podslice"
V5E_CHIP_HBM = 16 * (1 << 30)


# -- TrainCheckpointer ------------------------------------------------------
def tiny_training(seed=0):
    cfg = dataclasses.replace(LlamaConfig.tiny(), dtype=torch.float32)
    model = init_params(cfg, torch.Generator().manual_seed(seed), "cpu")
    opt = make_optimizer(model, 3e-3)
    tokens = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab, (2, 32)))
    batch = {"tokens": tokens, "targets": torch.roll(tokens, -1, 1)}
    return cfg, model, opt, batch


def test_save_sequence_keeps_the_steps_orbax_keeps(tmp_path):
    """Saves through ``maybe_save(every=2)`` over steps 1..9 at
    ``max_to_keep=3``, then a forced save: the same saves happen, the same
    step directories remain and the latest step agrees."""
    _, model, opt, _ = tiny_training()
    got = []
    for name, make, state in (
            ("jax", jcheckpoint.TrainCheckpointer,
             {"x": jnp.arange(4.0)}),
            ("port", checkpoint.TrainCheckpointer, (model, opt))):
        d = str(tmp_path / name)
        ck = make(d, max_to_keep=3)
        made = [ck.maybe_save(s, state, every=2) for s in range(1, 10)]
        made.append(ck.save(11, state))
        ck.wait()
        got.append((made, ck.latest_step(),
                    sorted(int(x) for x in os.listdir(d) if x.isdigit())))
        ck.close()
    assert got[1] == got[0]
    assert got[1][2] == [6, 8, 11]


def test_restore_round_trips_model_and_adamw_exactly(tmp_path):
    """Three steps, a save, two more steps; a fresh model and optimizer
    restored from the save take the same two steps: losses and every
    weight equal bit for bit. Restoring with no checkpoint raises, and
    ``restore_or`` hands back the fresh state at step 0."""
    cfg, model, opt, batch = tiny_training()
    step = make_train_step(cfg, None, opt)
    for _ in range(3):
        step(model, batch)
    with checkpoint.TrainCheckpointer(str(tmp_path / "ck")) as ck:
        assert ck.save(3, (model, opt))
        assert not ck.save(3, (model, opt))        # on disk already
    ref = [step(model, batch) for _ in range(2)]
    _, model2, opt2, _ = tiny_training(seed=5)     # other weights
    with checkpoint.TrainCheckpointer(str(tmp_path / "ck")) as ck:
        n, (model2, opt2) = ck.restore_or(lambda: (model2, opt2))
    assert n == 3
    step2 = make_train_step(cfg, None, opt2)
    got = [step2(model2, batch) for _ in range(2)]
    assert [x.item() for x in got] == [x.item() for x in ref]
    for (_, a), (_, b) in zip(model.named_parameters(),
                              model2.named_parameters()):
        assert torch.equal(a, b)
    for a, b in zip(opt.state.values(), opt2.state.values()):
        assert all(torch.equal(a[k], b[k]) for k in a)
    with checkpoint.TrainCheckpointer(str(tmp_path / "none")) as ck:
        with pytest.raises(FileNotFoundError):
            ck.restore()
        assert ck.restore_or(lambda: "fresh") == (0, "fresh")
    with checkpoint.TrainCheckpointer(str(tmp_path / "ck")) as ck:
        raw = ck.restore()
    assert set(raw) == {"model", "opt"} and \
        raw["model"]["embed"].device.type == "cpu"


# -- enforcement -----------------------------------------------------------
ENVS = [
    {"TPU_HBM_LIMIT_BYTES": str(V5E_CHIP_HBM), "TPU_VISIBLE_CHIPS": "0,1"},
    {"TPU_HBM_LIMIT_BYTES": str(4 * V5E_CHIP_HBM), "TPU_VISIBLE_CHIPS": "0"},
    {"TPU_HBM_LIMIT_BYTES": "0", "TPU_VISIBLE_CHIPS": "0,1,2,3"},
    {"TPU_HBM_LIMIT_BYTES": "123456789"},
    {"TPU_HBM_LIMIT_BYTES": "garbage"},
    {"TPU_HBM_LIMIT_BYTES": "-5"},
    {},
]


@pytest.mark.parametrize("env", ENVS, ids=range(len(ENVS)))
def test_memory_fraction_matches_jax(env):
    """The fraction for one env and the chip's bytes is JAX's, exactly
    (None where JAX sets none)."""
    want = jenf.apply_hbm_limit(dict(env, TPU_ACCELERATOR_TYPE=V5E))
    assert enforcement.hbm_fraction(env, V5E_CHIP_HBM) == want


def test_memory_limit_on_the_cpu_sets_nothing():
    assert enforcement.apply_hbm_limit(dict(ENVS[0]), device="cpu") is None
    t = enforcement.apply_env_limits(
        {"TPU_DUTY_CYCLE_PERCENTAGE": "50", **ENVS[0]}, device="cpu")
    assert t is not None and t.pct == 50


class FakeTime:
    """A clock that moves only when told, or when something sleeps."""

    def __init__(self):
        self.now = 100.0
        self.slept = []

    def perf_counter(self):
        return self.now

    def sleep(self, s):
        self.slept.append(s)
        self.now += s


def test_pacing_sleeps_match_jax(monkeypatch):
    """One schedule of active and idle intervals through both throttles
    (25 %, 50 % with a small credit cap): every sleep is equal."""
    got = []
    for mod in (jenf, enforcement):
        clock = FakeTime()
        monkeypatch.setattr(mod, "time", clock)
        out = []
        for pct, cap in ((25, 1.0), (50, 0.02)):
            t = mod.duty_throttle({"TPU_DUTY_CYCLE_PERCENTAGE": str(pct)})
            t.credit_cap_s = cap
            for active, idle in ((0.01, 0.0), (0.004, 0.04), (0.05, 0.08),
                                 (0.0, 0.0), (0.02, 0.001)):
                clock.now += idle
                with t:
                    clock.now += active
                out.append(t.pace(active))
        got.append((out, clock.slept))
    assert got[1] == got[0]
    assert any(got[1][1])


@pytest.mark.parametrize("raw", ["", "100", "junk", "0", "25"])
def test_duty_env_parse_matches_jax(raw):
    env = {"TPU_DUTY_CYCLE_PERCENTAGE": raw} if raw else {}
    a, b = jenf.duty_throttle(env), enforcement.duty_throttle(env)
    assert (a is None) == (b is None)
    assert b is None or b.pct == a.pct


# -- registry client and publisher -----------------------------------------
class _Resp(socketserver.StreamRequestHandler):
    """The RESP subset the clients speak: PING, SET, GET, MGET, KEYS,
    DEL, EXISTS."""

    def _reply(self, v):
        if v is None:
            self.wfile.write(b"$-1\r\n")
        elif isinstance(v, int):
            self.wfile.write(b":%d\r\n" % v)
        elif isinstance(v, list):
            self.wfile.write(b"*%d\r\n" % len(v))
            for x in v:
                self._reply(x)
        elif v in ("OK", "PONG"):
            self.wfile.write(f"+{v}\r\n".encode())
        else:
            data = v.encode()
            self.wfile.write(b"$%d\r\n%s\r\n" % (len(data), data))

    def handle(self):
        kv = self.server.kv
        while True:
            line = self.rfile.readline()
            if not line:
                return
            argv = []
            for _ in range(int(line[1:])):
                n = int(self.rfile.readline()[1:])
                argv.append(self.rfile.read(n + 2)[:-2].decode())
            cmd, args = argv[0].upper(), argv[1:]
            if cmd == "PING":
                self._reply("PONG")
            elif cmd == "SET":
                kv[args[0]] = args[1]
                self._reply("OK")
            elif cmd == "GET":
                self._reply(kv.get(args[0]))
            elif cmd == "MGET":
                self._reply([kv.get(k) for k in args])
            elif cmd == "KEYS":
                pre = args[0].rstrip("*")
                self._reply(sorted(k for k in kv if k.startswith(pre)))
            elif cmd == "DEL":
                self._reply(sum(kv.pop(k, None) is not None for k in args))
            elif cmd == "EXISTS":
                self._reply(int(args[0] in kv))


@pytest.fixture
def registry():
    srv = socketserver.ThreadingTCPServer(("127.0.0.1", 0), _Resp)
    srv.daemon_threads = True
    srv.kv = {}
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    yield srv
    srv.shutdown()
    srv.server_close()


def test_registry_client_matches_jax(registry):
    """The same commands through both clients read the same replies."""
    port = registry.server_address[1]
    got = []
    for mod in (jclient, client):
        with mod.Client("127.0.0.1", port) as c:
            c.set(f"node/a-{mod.__name__}", "1")
            got.append((c.ping(), c.get("missing"), c.exists("missing"),
                        sorted(k.split("-")[0] for k in c.get_keys("node/*")),
                        c.mget("node/a-" + mod.__name__, "nope"),
                        c.delete("node/a-" + mod.__name__)))
    assert got[1][1:] == got[0][1:] and got[1][0] is True


def published(collector_mod, registry, monkeypatch):
    port = registry.server_address[1]
    for k, v in {"WORKLOAD_NAME": "llama3_8b_serve",
                 "TPU_SCHED_REGISTRY_HOST": "127.0.0.1",
                 "TPU_SCHED_REGISTRY_PORT": str(port),
                 "TPU_VISIBLE_CHIPS": "0,1,2,3",
                 "TPU_ACCELERATOR_TYPE": V5E, "HOSTNAME": "pod-0",
                 "TPU_NEIGHBORS": "b,a"}.items():
        monkeypatch.setenv(k, v)
    registry.kv.clear()
    pub = collector_mod.make_workload_publisher(n_devices=1)
    pub(12.5)                                  # env neighbours
    registry.kv["neighbors/pod-0"] = ""        # the pod is alone now
    pub(13.0, p99_ms=41.5)
    out = {}
    for k, v in registry.kv.items():
        if k.startswith(inventory.OBSERVED_KEY_PREFIX):
            doc = json.loads(v)
            assert doc.pop("at") > 0
            out[k] = doc
    return out


def test_publisher_writes_what_jax_writes(registry, monkeypatch):
    """Keys and values of two samples (co-located, then solo) are JAX's;
    without WORKLOAD_NAME there is no publisher, and with no registry the
    publisher is disabled instead of failing the workload."""
    want = published(jcollector, registry, monkeypatch)
    got = published(collector, registry, monkeypatch)
    assert got == want
    assert sorted(got) == ["observed/llama3_8b_serve/4P_V5E",
                           "observed/llama3_8b_serve/4P_V5E/co"]
    assert got["observed/llama3_8b_serve/4P_V5E"]["p99_ms"] == 41.5
    monkeypatch.setenv("TPU_SCHED_REGISTRY_PORT", "1")
    assert collector.make_workload_publisher() is None
    monkeypatch.delenv("WORKLOAD_NAME")
    assert collector.make_workload_publisher() is None


def test_observation_and_keys_match_jax():
    from k8s_gpu_scheduler_tpu.registry import inventory as jinv

    o = inventory.Observation("w", "8P_V5E", 3.5, 1.0, ["x"], 9.0)
    assert jinv.Observation.from_json(o.to_json()) == jinv.Observation(
        "w", "8P_V5E", 3.5, 1.0, ["x"], 9.0)
    for fn in ("observed_key", "latency_key", "replica_key"):
        args = ("w", "c") if fn != "observed_key" else ("w", "c", True)
        assert getattr(inventory, fn)(*args) == getattr(jinv, fn)(*args)
