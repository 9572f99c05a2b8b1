"""The port's dispatch bodies and audit scenarios, as registries.

- ``DISPATCH_BODIES``: the functions whose work the card runs, by file —
  the engine's five dispatches and the seven kernel wrappers (K1–K7).
  The AST passes read it (astlint.py, lockorder.py); eager PyTorch has
  no ``jit`` wrapper to find them by, so they are listed.
- ``alias_scenarios()``: every dispatch that runs with shared prefix
  pages mounted in the pool (analysis/alias.py).
- ``steady_scenarios()``: the single-card steady states (analysis/
  steady.py) — the engines, ``generate`` and the train step;
  ``tp_steady_scenarios()``: the two tp steady states, on each rank of
  the spawned world of two (analysis/world.py).
- ``op_entrypoints()``, ``traffic_entrypoints()``/``traffic_contracts()``
  and ``gspmd_entrypoints()``: the op, traffic and sharding audits'
  entries, under the JAX package's names.

A scenario is ``(name, build)``; ``build(device, size)`` makes a fresh
engine on the explicit device at ``size`` (``TINY`` by default; chip_smoke
passes the serve config's full widths) and returns the audit's operands.
Imports are lazy: the fast passes import this module, and nothing here
builds a model until a scenario runs.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

# file (package-qualified) -> the dispatch bodies it defines.
DISPATCH_BODIES: Dict[str, Tuple[str, ...]] = {
    "k8s_gpu_scheduler_tpu_torch/models/serving.py": (
        "_decode_chunk_paged_fn", "_verify_chunk_paged_fn",
        "_prefill_multi_paged_fn", "_decode_chunk_fn", "_prefill_multi_fn"),
    "k8s_gpu_scheduler_tpu_torch/ops/decode_attention.py": (
        "paged_decode_attention", "paged_prefill_attention",
        "paged_verify_attention", "flash_decode_attention"),
    "k8s_gpu_scheduler_tpu_torch/ops/flash_attention.py": (
        "launch_forward", "launch_backward_dq", "launch_backward_dkv"),
}

# The tiny config the CPU tests and the card tests audit at: 2 layers, a
# 64-wide head (the kernels' smallest) over 2 query and 1 kv heads, f32.
TINY_CFG = dict(vocab=256, d_model=128, n_layers=2, n_heads=2, n_kv_heads=1,
                d_ff=256, max_seq=128)
UNIQ = 4            # tokens a request has after the shared system prompt
TRAIN_LAYERS = 2    # the train step's depth at every size


@dataclasses.dataclass(frozen=True)
class ScenarioSize:
    """How big a scenario's engine is. The default is the tiny config at
    page 8; chip_smoke phase 21 passes the serve config's full widths
    (``cfg``, ``make_model`` drawing the weights on the card, page 64,
    a 384-token system prompt, gamma 4)."""
    cfg: Optional[object] = None            # LlamaConfig; None: tiny, f32
    make_model: Optional[Callable] = None   # (cfg, device) -> Llama
    page_size: int = 8
    sys_len: int = 8                        # shared prompt, page multiple
    kv_dtype: Optional[str] = "int8"
    max_len: int = 64
    chunk: int = 2
    gamma: int = 2
    train_bt: Tuple[int, int] = (2, 16)


TINY = ScenarioSize()


def _cfg(size: ScenarioSize):
    if size.cfg is not None:
        return size.cfg
    import torch

    from ..models.llama import LlamaConfig

    return LlamaConfig(**TINY_CFG, dtype=torch.float32, decode_attn="fused",
                       remat=False)


def _model(size: ScenarioSize, cfg, device):
    if size.make_model is not None:
        return size.make_model(cfg, device)
    import torch

    from ..models.llama import init_params

    return init_params(cfg, torch.Generator().manual_seed(0), device)


def _engine(device, size: ScenarioSize, **kw):
    """A fresh engine of ``size`` on ``device`` (paged unless ``kw`` says
    otherwise) and an rng for its traffic."""
    import numpy as np

    from ..models.serving import ContinuousBatcher

    cfg = _cfg(size)
    opts = dict(n_slots=2, max_len=size.max_len, chunk=size.chunk,
                prefill_bucket=size.page_size, kv_dtype=size.kv_dtype,
                device=device)
    if kw.get("kv_layout", "paged") == "paged":
        opts.update(kv_layout="paged", page_size=size.page_size)
    opts.update(kw)
    eng = ContinuousBatcher(_model(size, cfg, device), cfg, **opts)
    return eng, np.random.default_rng(0)


def _tokens(rng, eng, n: int) -> list:
    return [int(t) for t in rng.integers(0, eng.cfg.vocab, n)]


def _pools(eng) -> list:
    return [t for t in (eng._k, eng._v, eng._ks, eng._vs) if t is not None]


def _shared(eng) -> list:
    return sorted({p for pages in eng._slot_shared.values() for p in pages})


def _active(eng):
    import numpy as np

    return np.asarray([s in eng._slot_req for s in range(eng.n_slots)])


# -- shared-page (copy-on-write) scenarios ------------------------------------

def _prefix_engine(device, size: ScenarioSize, **kw):
    """A warmed prefix-cache engine whose tree holds the system prompt's
    pages, with a live request MOUNTING them mid-decode."""
    eng, rng = _engine(device, size, prefix_cache=True, **kw)
    system = _tokens(rng, eng, size.sys_len)
    eng.submit(system + _tokens(rng, eng, 3), max_new=2)
    eng.run()                        # the reap donates the system pages
    eng.submit(system + _tokens(rng, eng, UNIQ),
               max_new=4 * size.chunk + 1)
    eng.step()
    if not _shared(eng):
        raise RuntimeError("the scenario must actually share a page")
    return eng, rng


def _tail_prefill(eng, rng, shared: list):
    """The tail-prefill dispatch (K2) of a throwaway tail page over the
    mounted prefix ``shared`` (padded to the engine's hb bucket)."""
    import numpy as np

    from ..models.paging import NULL_PAGE

    own = eng._alloc.alloc(1)        # a throwaway tail page to scatter to
    eng._alloc.retain(shared)        # mirror admission's mount
    hb = eng._hb_bucket(len(shared))
    row = shared + [NULL_PAGE] * (hb - len(shared))
    ps = eng.page_size
    kw = dict(slots=np.ones(2, np.int32),
              page_ids=np.full((2, 1), own[0], np.int32),
              prefix_tables=np.asarray([row] * 2, np.int32),
              hit_lens=np.full(2, len(shared) * ps, np.int32),
              tokens=np.asarray([_tokens(rng, eng, ps)] * 2, np.int32),
              tail_lens=np.full(2, min(4, ps), np.int32),
              seed=(eng.seed, 1, 99))
    return lambda: eng._op_prefill(**kw)


def _alias_prefill(device, size: ScenarioSize = TINY):
    """The tail prefill with a mounted shared prefix: its page-granular
    scatter must touch only the entry's OWN page."""
    eng, rng = _prefix_engine(device, size)
    shared = _shared(eng)
    return _tail_prefill(eng, rng, shared), _pools(eng), shared


def _alias_prefill_decoded(device, size: ScenarioSize = TINY):
    """The tail prefill over a mounted prefix that INCLUDES a decoded-
    suffix page (turn 1 of a conversation reaped with donate_decoded):
    the copy-on-write proof for both halves of the multi-turn path."""
    eng, rng = _engine(device, size, prefix_cache=True)
    ps = eng.page_size
    first = _tokens(rng, eng, 2 * ps)
    eng.submit(first, max_new=ps + ps // 2)                 # turn 1
    done: dict = {}
    while eng.pending:
        done.update(eng.step())
    (reply,) = done.values()
    if eng.pool_metrics()["decoded_pages_donated_total"] < 1:
        raise RuntimeError("the scenario must donate a decoded page")
    eng.submit(first + reply + _tokens(rng, eng, UNIQ),
               max_new=4 * size.chunk + 1)                  # turn 2
    eng.step()
    shared = _shared(eng)
    if len(shared) < 3:
        raise RuntimeError("turn 2 must mount prompt AND decoded pages")
    return _tail_prefill(eng, rng, shared), _pools(eng), shared


def _alias_decode(device, size: ScenarioSize = TINY):
    """A decode chunk (K1) over a block table whose prefix rows are
    shared: the per-slot write at ``lens`` lands past the mounted prefix."""
    eng, _ = _prefix_engine(device, size)
    active = _active(eng)
    return (lambda: eng._op_decode(active, (eng.seed, 0, 99)), _pools(eng),
            _shared(eng))


def _alias_promoted(device, size: ScenarioSize = TINY):
    """A decode chunk over a block table whose mounted prefix pages came
    back through a host-tier demote→promote round trip: build time checks
    the promoted pages hold exactly the donated bytes (readback, host
    tier, upload into FRESH page ids), and the audit then proves the next
    dispatch leaves them untouched."""
    eng, rng = _engine(device, size, prefix_cache=True, kv_tiering=True,
                       dram_pages=32, n_pages=10)
    ps = eng.page_size
    prompts = [_tokens(rng, eng, 3 * ps + ps // 2) for _ in range(3)]
    eng.submit(prompts[0], max_new=8)
    eng.run()                        # the reap donates prompts[0]'s path
    path0 = eng._prefix.match(prompts[0])
    if len(path0) < 2:
        raise RuntimeError("the scenario must donate a multi-page path")
    before = [t[:, path0].clone() for t in _pools(eng)]
    for p in prompts[1:]:            # pool pressure: LRU demotion
        eng.submit(p, max_new=8)
        eng.run()
    if not eng.pool_metrics()["page_demotions_total"]:
        raise RuntimeError("the scenario must demote")
    eng.submit(prompts[0], max_new=4 * size.chunk + 1)
    eng.step()                       # promote + mount, then mid-decode
    if not eng.pool_metrics()["page_promotions_total"]:
        raise RuntimeError("the scenario must serve through a promotion")
    path1 = eng._prefix.match(prompts[0])
    if len(path1) != len(path0) or not set(path1) <= set(_shared(eng)):
        raise RuntimeError("the whole promoted path must be mounted")
    from .alias import _same_bytes

    if not all(_same_bytes(b, t[:, path1])
               for b, t in zip(before, _pools(eng))):
        raise RuntimeError("promoted pages differ from the donated bytes")
    active = _active(eng)
    return (lambda: eng._op_decode(active, (eng.seed, 0, 99)), _pools(eng),
            _shared(eng))


def _alias_verify(device, size: ScenarioSize = TINY):
    """A speculative verify dispatch (K3) over shared prefix rows: the
    whole 1+gamma window, including the overshoot a rejection rewinds,
    lands past the mounted prefix."""
    import numpy as np

    eng, _ = _prefix_engine(device, size, speculative=True,
                            gamma=size.gamma)
    active = _active(eng)
    props = np.zeros((eng.n_slots, eng.gamma), np.int32)
    eff = np.full(eng.n_slots, eng.gamma, np.int32)
    return (lambda: eng._op_verify(props, active, (eng.seed, 2, 99), eff,
                                   None), _pools(eng), _shared(eng))


def alias_scenarios() -> List[Tuple[str, Callable]]:
    """(name, build) pairs for the shared-page audit: every dispatch that
    runs with aliased prefix pages in its pool."""
    return [
        ("batcher_prefill_paged_prefix", _alias_prefill),
        ("batcher_prefill_prefix_kernel", _alias_prefill_decoded),
        ("batcher_decode_paged_prefix", _alias_decode),
        ("batcher_decode_paged_promoted", _alias_promoted),
        ("batcher_verify_paged_prefix", _alias_verify),
    ]


# -- steady-state scenarios ---------------------------------------------------

def _steady_engine(device, size: ScenarioSize, shared_prefix=False,
                   long_prompt=False, **kw):
    """Two requests decoding (behind a donated system prompt with
    ``shared_prefix``; beside a third prompt prefilled a page a step with
    ``long_prompt``): the warm-up admits them and runs three steps, each
    steady function is one more step, with no admission."""
    from .steady import engine_tensors

    if kw.get("speculative"):
        kw.setdefault("gamma", size.gamma)
    if long_prompt:
        kw.update(n_slots=3, prefill_chunk_tokens=size.page_size)
    eng, rng = _engine(device, size, **kw)
    system = _tokens(rng, eng, size.sys_len)
    budget = size.max_len - size.sys_len - UNIQ - size.gamma - 1

    def warmup():
        if shared_prefix:
            eng.submit(system + _tokens(rng, eng, 3), max_new=2)
            eng.run()
        for _ in range(2):
            eng.submit(system + _tokens(rng, eng, UNIQ),
                       max_new=budget)
        if long_prompt:
            eng.submit(_tokens(rng, eng, 6 * size.page_size), max_new=2)
        for _ in range(3):
            eng.step()

    return warmup, [eng.step] * 3, lambda: engine_tensors(eng)


def _steady(**kw):
    return lambda device, size=TINY: _steady_engine(device, size, **kw)


def _generate_steady(device, size: ScenarioSize = TINY):
    """``generate``'s decode loop over a cache that outlives the call.
    The warm-up runs ``generate`` once (its prefill and decode
    instantiations), then prefills a cache of its own; each steady
    function is one of ``generate``'s per-token steps on that cache
    (``forward_with_cache`` of the last token, K4), which writes its K/V
    in place. The cache is what is tracked: ``generate`` itself makes a
    new one on every call (``init_cache``)."""
    import torch

    from ..models.serving import forward_with_cache, generate, init_cache

    cfg = _cfg(size)
    model = _model(size, cfg, device)
    prompt = torch.randint(0, cfg.vocab, (2, size.sys_len + UNIQ),
                           generator=torch.Generator().manual_seed(0)
                           ).to(model.device)
    state: dict = {}

    @torch.no_grad()
    def forward(tokens):
        logits, state["cache"] = forward_with_cache(model, tokens, cfg,
                                                    state["cache"])
        state["last"] = torch.argmax(logits[:, -1], dim=-1)

    def warmup():
        generate(model, prompt, cfg, max_new=3, max_len=size.max_len)
        state["cache"] = init_cache(cfg, prompt.shape[0], size.max_len,
                                    device=model.device)
        forward(prompt)

    def step():
        forward(state["last"][:, None])

    return warmup, [step] * 3, lambda: {
        "cache:k": state["cache"]["k"], "cache:v": state["cache"]["v"]}


def _train_steady(device, size: ScenarioSize = TINY):
    import torch

    from ..models.llama import make_optimizer, make_train_step
    from .steady import train_tensors

    cfg = dataclasses.replace(_cfg(size), n_layers=TRAIN_LAYERS,
                              attn_impl="flash")
    model = _model(size, cfg, device)
    opt = make_optimizer(model, 3e-4)
    step = make_train_step(cfg, None, opt)
    B, T = size.train_bt
    tokens = torch.randint(0, cfg.vocab, (B, T),
                           generator=torch.Generator().manual_seed(0))
    batch = {"tokens": tokens.to(device),
             "targets": torch.roll(tokens, -1, dims=1).to(device)}

    def call():
        step(model, batch)

    return call, [call] * 3, lambda: train_tensors(model, opt)


def _traced(device, size: ScenarioSize = TINY):
    from ..obs import Tracer, VirtualClock

    clock = VirtualClock()
    return _steady_engine(device, size, tracer=Tracer(clock=clock),
                          clock=clock)


def steady_scenarios() -> List[Tuple[str, Callable]]:
    """(name, build) pairs for the steady-state audit: the single-card
    steady states of the JAX package's recompile scenarios, and the train
    step."""
    return [
        ("batcher_steady_decode", _steady(kv_layout="contiguous")),
        ("batcher_steady_decode_paged", _steady()),
        ("batcher_steady_decode_paged_traced", _traced),
        ("batcher_steady_decode_paged_prefix",
         _steady(shared_prefix=True, prefix_cache=True)),
        ("batcher_steady_decode_paged_tiered",
         _steady(shared_prefix=True, prefix_cache=True, kv_tiering=True,
                 dram_pages=32)),
        ("batcher_steady_decode_paged_spec", _steady(speculative=True)),
        ("batcher_steady_decode_paged_spec_sampled",
         _steady(speculative=True, temperature=0.7, top_k=4)),
        ("batcher_steady_mixed_chunked", _steady(long_prompt=True)),
        ("batcher_steady_prefix_kernel",
         _steady(shared_prefix=True, prefix_cache=True,
                 donate_decoded=True)),
        ("generate_steady_state", _generate_steady),
        ("train_steady_state", _train_steady),
    ]


def tp_steady_scenarios() -> List[Tuple[str, Callable]]:
    """The JAX package's two tp steady states, which run on each rank of
    the spawned world of two (``_steady_tp``, ``world.py``)."""
    return [("batcher_steady_decode_paged_tp", _steady_tp(False)),
            ("batcher_steady_decode_paged_tp_wsharded", _steady_tp(True))]


# -- meshes of a spawned world -------------------------------------------------

_MESHES: dict = {}


def _mesh(device, **axes):
    """A mesh over the ranks of the default process group (made once per
    shape in a rank): ``axes`` sizes, every other of the five axes 1."""
    import torch

    from ..parallel import MeshSpec, make_mesh

    dev = torch.device(device)
    key = (dev.type, tuple(sorted(axes.items())))
    if key not in _MESHES:
        spec = (MeshSpec(dict(axes)) if "pp" in axes
                else MeshSpec.for_devices(_world_size(), **axes))
        _MESHES[key] = make_mesh(spec, dev.type)
    return _MESHES[key]


def _world_size() -> int:
    import torch.distributed as dist

    return dist.get_world_size()


# -- op audit (analysis/opaudit.py) ---------------------------------------------

# JAX's jaxpr_entrypoints() names, in its order.
OP_AUDIT_NAMES: Tuple[str, ...] = (
    "llama_generate", "llama_train_step", "batcher_prefill",
    "batcher_decode", "batcher_prefill_paged", "batcher_prefill_paged_prefix",
    "batcher_decode_paged", "batcher_verify_paged_spec",
    "pipeline_loss_grad", "flash_decode_attention", "dense_decode_reference",
    "paged_decode_attention", "paged_verify_attention",
    "paged_prefill_attention")
OP_LOOP = (2, 3)                # the two hot-loop lengths an entry runs at


def _op_cfg(**kw):
    """The op audit's config: the tiny widths (a 64-wide head, the
    kernels' smallest) in bf16, JAX's ``LlamaConfig.tiny()`` dtype, so an
    f32 upcast is one."""
    import torch

    from ..models.llama import LlamaConfig

    return dataclasses.replace(
        LlamaConfig(**TINY_CFG, dtype=torch.bfloat16, decode_attn="fused",
                    remat=False), **kw)


def _op_engine(device, chunk: int = 2, **kw):
    """JAX's op-audit engines: two slots, 32 rows, int8 KV."""
    from ..models.serving import ContinuousBatcher

    cfg = _op_cfg()
    opts = dict(n_slots=2, max_len=32, chunk=chunk, prefill_bucket=8,
                kv_dtype="int8", device=device)
    if kw.get("kv_layout", "paged") == "paged":
        opts.update(kv_layout="paged", page_size=8)
    opts.update(kw)
    return ContinuousBatcher(_model(TINY, cfg, device), cfg, **opts)


def _op_generate(device, loop):
    import torch

    from ..models.serving import generate

    cfg = _op_cfg()
    model = _model(TINY, cfg, device)
    prompt = torch.zeros((2, 8), dtype=torch.int64, device=device)
    return (lambda: generate(model, prompt, cfg, max_new=loop,
                             max_len=32)), ()


def _op_train(device, loop):
    """The train step with ``make_optimizer``'s AdamW on its multi-tensor
    (``_foreach_*``) update, the one torch picks on the card: set on the
    CPU too, where those ops also run, so that the card's record of the
    step the port runs holds to the CPU's op for op."""
    import torch

    from ..models.llama import make_optimizer, make_train_step

    cfg = _op_cfg(attn_impl="flash")
    model = _model(TINY, cfg, device)
    opt = make_optimizer(model, 1e-3)
    opt.defaults["foreach"] = True
    for group in opt.param_groups:
        group["foreach"] = True
    step = make_train_step(cfg, None, opt)
    tokens = torch.zeros((2, 8), dtype=torch.int64, device=device)
    return step, (model, {"tokens": tokens, "targets": tokens})


def _op_prefill_contiguous(device, loop):
    import numpy as np

    from ..models.serving import _prefill_multi_fn

    eng = _op_engine(device, kv_layout="contiguous")
    return (lambda: _prefill_multi_fn(
        eng.model, eng.cfg, eng._k, eng._v, eng._ks, eng._vs, eng._bitmap,
        eng._rope_pos, eng._last, slots=[0, 1], cursors=[4, 4],
        tokens=np.zeros((2, 4), np.int32), real_lens=[4, 4],
        seed=(eng.seed, 1, 1))), ()


def _op_decode_contiguous(device, loop):
    import numpy as np
    import torch

    from ..models.serving import _decode_chunk_fn

    eng = _op_engine(device, chunk=loop, kv_layout="contiguous")
    active = np.asarray([True, False])
    return (lambda: _decode_chunk_fn(
        eng.model, eng.cfg, eng.chunk, eng._k, eng._v, eng._ks, eng._vs,
        eng._bitmap, 4, eng._rope_pos, eng._last,
        torch.as_tensor(active, device=eng.device), eng._angles,
        (eng.seed, 0, 1))), ()


def _op_prefill_paged(hb: int):
    def build(device, loop):
        import numpy as np

        eng = _op_engine(device)
        kw = dict(slots=np.zeros(2, np.int32),
                  page_ids=np.ones((2, 1), np.int32),
                  prefix_tables=np.full((2, hb), 2, np.int32),
                  hit_lens=np.full(2, 8 * hb, np.int32),
                  tokens=np.zeros((2, 8), np.int32),
                  tail_lens=np.full(2, 4, np.int32), seed=(eng.seed, 1, 1))
        return (lambda: eng._op_prefill(**kw)), ()
    return build


def _op_decode_paged(device, loop):
    import numpy as np

    eng = _op_engine(device, chunk=loop)
    return eng._op_decode, (np.asarray([True, False]), (eng.seed, 0, 1))


def _op_verify_paged(device, loop):
    import numpy as np

    eng = _op_engine(device, speculative=True, gamma=2)
    return eng._op_verify, (np.zeros((2, 2), np.int32),
                            np.asarray([True, False]), (eng.seed, 2, 1),
                            np.full(2, 2, np.int32), None)


def _op_pipeline(device, loop):
    """JAX's pipeline entry: the GPipe loss and its gradients over a pp
    mesh of two stages (on each rank of the spawned world)."""
    import torch

    from ..models.llama import init_params
    from ..models.pipeline import pp_loss_fn

    cfg = _op_cfg()
    mesh = _mesh(device, pp=2)
    model = init_params(cfg, torch.Generator().manual_seed(0), device,
                        mesh=mesh)
    model.requires_grad_(True)
    tokens = torch.zeros((4, 8), dtype=torch.int64, device=device)

    def call():
        loss = pp_loss_fn(model, {"tokens": tokens, "targets": tokens}, cfg,
                          mesh, 2)
        loss.backward()
        return loss.detach()

    return call, ()


def _kernel_operands(device):
    """JAX's kernel-entry operands at the port's smallest head (64): q
    [2, 8, 64] bf16 against a [2, 64, 8, 64] cache, or a 16-page pool of
    8-row pages through an [2, 8] table."""
    import torch

    g = torch.Generator().manual_seed(0)

    def rand(*shape):
        return torch.randn(shape, generator=g).to(torch.bfloat16).to(device)

    def full(n, v):
        return torch.full((n,), v, dtype=torch.int32, device=device)

    table = torch.arange(1, 9, dtype=torch.int32).repeat(2, 1).to(device)
    return rand, full, table


def _op_kernel(which: str):
    def build(device, loop):
        from ..ops import decode_attention as da

        rand, full, table = _kernel_operands(device)
        if which in ("flash_decode_attention", "dense_decode_reference"):
            q, kc, lens = rand(2, 8, 64), rand(2, 64, 8, 64), full(2, 17)
            if which == "dense_decode_reference":
                return (lambda: da.dense_decode_reference(
                    q, kc, kc, lengths=lens)), ()
            return da.flash_decode_attention, (q, kc, kc, lens)
        pool = rand(17, 8, 8, 64)
        if which == "paged_decode_attention":
            return da.paged_decode_attention, (rand(2, 8, 64), pool, pool,
                                               table, full(2, 17))
        if which == "paged_verify_attention":
            return da.paged_verify_attention, (rand(2, 3, 8, 64), pool, pool,
                                               table, full(2, 9))
        tail = rand(2, 16, 8, 64)
        return da.paged_prefill_attention, (
            rand(2, 16, 8, 64), pool, pool,
            table[:, :2].contiguous(), full(2, 16), tail, tail)
    return build


def op_entrypoints() -> List[Tuple[str, object]]:
    """(name, OpEntry) for the op audit — JAX's 14 names. An entry with a
    hot loop (a decode chunk, ``generate``'s tokens) runs at two of its
    lengths; ``pipeline_loss_grad`` runs on each rank of a spawned world
    of two (a pp mesh needs two ranks, as JAX's needs two devices)."""
    from .opaudit import OpEntry

    entries = {
        "llama_generate": OpEntry(_op_generate, OP_LOOP),
        "llama_train_step": OpEntry(_op_train),
        "batcher_prefill": OpEntry(_op_prefill_contiguous),
        "batcher_decode": OpEntry(_op_decode_contiguous, OP_LOOP),
        "batcher_prefill_paged": OpEntry(_op_prefill_paged(0)),
        "batcher_prefill_paged_prefix": OpEntry(_op_prefill_paged(1)),
        "batcher_decode_paged": OpEntry(_op_decode_paged, OP_LOOP),
        "batcher_verify_paged_spec": OpEntry(_op_verify_paged),
        "pipeline_loss_grad": OpEntry(_op_pipeline, world=2),
    }
    for k in OP_AUDIT_NAMES[9:]:
        entries[k] = OpEntry(_op_kernel(k))
    return [(n, entries[n]) for n in OP_AUDIT_NAMES]


# -- traffic audit (analysis/traffic.py) ----------------------------------------

# The audit engines' geometry (JAX's TRAFFIC_GEOMETRY's rule): every
# SCALE-bearing dim (n_pages, S, hit, tb, W, M) has a value distinct from
# every other dim in play, the tp-sliced widths included (d/tp = 128,
# d_ff/tp = 160, Hkv·hd/tp = 128), so a shape resolves to one monomial.
# JAX's head dim 12 is no port kernel's; a 64-wide head would put the
# rope tables' hd/2 = 32 on hit = hb·ps = 4·8, so the heads are 128 wide
# (the kernels' other head dim), d_model = 2 × 128, and max_seq (the rope
# table's rows) is 112. Structural dims (heads, head_dim, page size...)
# may collide — they are vocabulary, never policed. Order is resolution
# priority. ``d`` and ``d_ff`` double as the FULL-weight dims of the
# replicated-weight check.
TRAFFIC_GEOMETRY: Dict[str, int] = {
    "n_pages": 23, "S": 56, "hit": 32, "tb": 16, "W": 5, "M": 3,
    "L": 2, "vocab": 384, "d_ff": 320, "d": 256,
    "Hkv": 2, "hd": 128, "ps": 8,
}


@dataclasses.dataclass(frozen=True)
class TrafficSize:
    """How big the traffic engines are: the audit geometry by default;
    chip_smoke phase 22b passes the serve config's full width (``cfg``,
    ``make_model``, page 64, its own distinct scale dims)."""
    cfg: Optional[object] = None            # LlamaConfig; None: the audit's
    make_model: Optional[Callable] = None
    slots: int = 3                          # M
    max_len: int = 56                       # S
    n_pages: int = 23
    page_size: int = 8
    tb: int = 16
    hb: int = 4                             # hit = hb · page_size
    gamma: int = 4                          # W = 1 + gamma
    kv_dtype: Optional[str] = "int8"

    def geometry(self) -> Dict[str, int]:
        cfg = self.cfg or _traffic_cfg()
        return {"n_pages": self.n_pages, "S": self.max_len,
                "hit": self.hb * self.page_size, "tb": self.tb,
                "W": 1 + self.gamma, "M": self.slots, "L": cfg.n_layers,
                "vocab": cfg.vocab, "d_ff": cfg.d_ff, "d": cfg.d_model,
                "Hkv": cfg.n_kv_heads, "hd": cfg.head_dim,
                "ps": self.page_size}


TRAFFIC_SIZE = TrafficSize()


def _traffic_cfg():
    """The traffic audit's config — tiny-scale, with widths chosen so every
    dim in play (full AND tp-sliced) resolves to one geometry symbol."""
    import torch

    from ..models.llama import LlamaConfig

    return LlamaConfig(vocab=384, d_model=256, n_layers=2, n_heads=2,
                       n_kv_heads=2, d_ff=320, max_seq=112,
                       dtype=torch.bfloat16, decode_attn="fused", remat=False)


def traffic_contracts() -> Dict[str, object]:
    """JAX's contracts, field for field (``donated`` as ``in_place``)."""
    from .traffic import TrafficContract

    gather = ("retained dense-gather fallback: the numerical parity "
              "reference, and the runtime fallback for plan-rejected rungs "
              "— counted, never silent")
    return {
        "traffic_decode_chunk": TrafficContract(
            kv_scale={"S": 1}, in_place=(1, 2, 3, 4, 5)),
        "traffic_verify_window": TrafficContract(
            kv_scale={"S": 1, "W": 2}, in_place=(1, 2, 3, 4, 5)),
        "traffic_verify_window_sampled": TrafficContract(
            kv_scale={"S": 1, "W": 2}, in_place=(1, 2, 3, 4, 5)),
        "traffic_prefill_tb16_hb0": TrafficContract(
            kv_scale={"tb": 2}, in_place=(1, 2, 3, 4)),
        "traffic_prefill_tb16_hb4_kernel": TrafficContract(
            kv_scale={"tb": 2}, in_place=(1, 2, 3, 4)),
        "traffic_prefill_tb16_hb4_gather": TrafficContract(
            kv_scale={"tb": 2, "hit": 1}, dense_ok=True, rationale=gather,
            in_place=(1, 2, 3, 4)),
        "traffic_decode_chunk_tp2": TrafficContract(
            kv_scale={"S": 1}, in_place=(1, 2, 3, 4, 5), tp=2,
            weight_sharded=True),
        "traffic_decode_chunk_tp2_psum": TrafficContract(
            kv_scale={"S": 1}, in_place=(1, 2, 3, 4, 5), tp=2,
            weight_sharded=True),
        "traffic_verify_window_tp2": TrafficContract(
            kv_scale={"S": 1, "W": 2}, in_place=(1, 2, 3, 4, 5), tp=2,
            weight_sharded=True),
        "traffic_prefill_tb16_hb0_tp2": TrafficContract(
            kv_scale={"tb": 2}, in_place=(1, 2, 3, 4), tp=2,
            weight_sharded=True),
        "traffic_prefill_tb16_hb4_kernel_tp2": TrafficContract(
            kv_scale={"tb": 2}, in_place=(1, 2, 3, 4), tp=2,
            weight_sharded=True),
        "traffic_prefill_tb16_hb4_gather_tp2": TrafficContract(
            kv_scale={"tb": 2, "hit": 1}, dense_ok=True,
            rationale="retained dense-gather fallback (see the non-tp "
                      "row) — the island edition carries the same "
                      "sanction",
            in_place=(1, 2, 3, 4), tp=2, weight_sharded=True),
        "traffic_promote_upload": TrafficContract(
            kv_scale={}, in_place=(0, 1, 2, 3)),
        "traffic_decode_chunk_tp2_replicated": TrafficContract(
            kv_scale={"S": 1}, in_place=(1, 2, 3, 4, 5), tp=2),
    }


# THE single source of the traffic registry (JAX's _TRAFFIC_ENTRIES).
_TRAFFIC_ENTRIES: Tuple[Tuple[str, dict], ...] = (
    ("traffic_decode_chunk", {"kind": "decode"}),
    ("traffic_verify_window", {"kind": "verify"}),
    ("traffic_verify_window_sampled",
     {"kind": "verify", "temperature": 0.6}),
    ("traffic_prefill_tb16_hb0", {"kind": "prefill", "hb": 0}),
    ("traffic_prefill_tb16_hb4_kernel",
     {"kind": "prefill", "hb": 4, "attn": "kernel"}),
    ("traffic_prefill_tb16_hb4_gather",
     {"kind": "prefill", "hb": 4, "attn": "gather"}),
    ("traffic_promote_upload", {"kind": "promote"}),
    ("traffic_decode_chunk_tp2", {"kind": "decode", "tp": True}),
    ("traffic_decode_chunk_tp2_psum",
     {"kind": "decode", "tp": True, "combine": "psum"}),
    ("traffic_decode_chunk_tp2_replicated",
     {"kind": "decode", "tp": True, "ws": False}),
    ("traffic_verify_window_tp2", {"kind": "verify", "tp": True}),
    ("traffic_prefill_tb16_hb0_tp2",
     {"kind": "prefill", "hb": 0, "tp": True}),
    ("traffic_prefill_tb16_hb4_kernel_tp2",
     {"kind": "prefill", "hb": 4, "attn": "kernel", "tp": True}),
    ("traffic_prefill_tb16_hb4_gather_tp2",
     {"kind": "prefill", "hb": 4, "attn": "gather", "tp": True}),
)
GATHER_REFUSAL = "prefill_attn='gather' is refused"


def _traffic_engine(device, size: TrafficSize, speculative=False,
                    prefill_attn=None, tp=False, weight_sharding=True,
                    tp_combine="all_gather", temperature=0.0):
    """A paged audit engine at ``size`` (fused decode, int8 KV by default
    — every operand class in play); tp engines join a tp mesh over the
    world's ranks."""
    import torch

    from ..models.llama import init_params
    from ..models.serving import ContinuousBatcher

    cfg = size.cfg or _traffic_cfg()
    model = (size.make_model(cfg, device) if size.make_model is not None
             else init_params(cfg, torch.Generator().manual_seed(0), device))
    kw: dict = {}
    if speculative:
        kw.update(speculative=True, gamma=size.gamma)
    if temperature:
        kw.update(temperature=temperature, top_k=8)
    if tp:
        kw.update(mesh=_mesh(device, tp=_world_size()),
                  weight_sharding=weight_sharding, tp_combine=tp_combine)
    return ContinuousBatcher(
        model, cfg, n_slots=size.slots, max_len=size.max_len, chunk=2,
        prefill_bucket=size.tb, kv_dtype=size.kv_dtype, kv_layout="paged",
        page_size=size.page_size, n_pages=size.n_pages,
        prefill_attn=prefill_attn, device=device, **kw)


def _decode_call(eng):
    """JAX's ``eng._decode`` argument order over the port's decode body:
    (model, k, v, k_scale, v_scale, table, lens, last, active, seed) —
    the pool planes and the table at positions 1-5."""
    import torch

    from ..models.serving import _decode_chunk_paged_fn

    def call(model, k, v, ks, vs, table, lens, last, active, seed):
        return _decode_chunk_paged_fn(
            model, eng.cfg, eng.chunk, eng.page_size, k, v, ks, vs, table,
            lens, last, torch.as_tensor(active, device=eng.device),
            eng._angles, seed, eng.temperature, eng.top_k,
            isl=eng._island)
    return call


def _verify_call(eng):
    import torch

    from ..models.serving import _verify_chunk_paged_fn

    def call(model, k, v, ks, vs, table, lens, last, props, active, seed,
             eff):
        dev = eng.device
        return _verify_chunk_paged_fn(
            model, eng.cfg, eng.gamma, eng.page_size, k, v, ks, vs, table,
            lens, last, torch.as_tensor(props, device=dev),
            torch.as_tensor(active, device=dev), eng._angles, seed,
            eff=torch.as_tensor(eff, device=dev), q=None,
            temperature=eng.temperature, top_k=eng.top_k, isl=eng._island)
    return call


def _prefill_call(eng):
    from ..models.serving import _prefill_multi_paged_fn

    def call(model, k, v, ks, vs, lens, last, slots, pids, ptbl, hits,
             tokens, tail_lens, seed):
        return _prefill_multi_paged_fn(
            model, eng.cfg, eng.page_size, k, v, ks, vs, lens, last, slots,
            pids, ptbl, hits, tokens, tail_lens, eng._angles, seed,
            eng.temperature, eng.top_k, isl=eng._island)
    return call


def _engine_args(eng, *rest):
    return (eng.model, eng._k, eng._v, eng._ks, eng._vs) + rest


def _traffic_call(device, kind: str, hb: int = 0, attn=None, tp: bool = False,
                  ws: bool = True, combine: str = "all_gather",
                  temperature: float = 0.0, size: TrafficSize = TRAFFIC_SIZE):
    """(engine, dispatch, its arguments) of one traffic entry: the
    dispatch takes JAX's argument order, so the contract's ``in_place``
    positions are JAX's ``donated`` ones."""
    import numpy as np

    M, ps = size.slots, size.page_size
    if kind == "promote":
        # The tier promotion upload (``_op_scatter``, the one page
        # relocation path of restore, absorb and promotion): payloads
        # shaped like a 7-page promotion — 7 is no geometry value, so
        # the moved-pages dim is a constant.
        eng = _traffic_engine(device, size)
        P = 7

        def pay(pool):
            shape = (pool.shape[0], P) + tuple(pool.shape[2:])
            return np.zeros(shape, np.float32 if pool.dtype.is_floating_point
                            else np.int8)

        def scatter(k, v, ks, vs, idx, pk, pv, pks, pvs):
            eng._op_scatter([int(p) for p in idx], [pk, pv, pks, pvs])

        return eng, scatter, (eng._k, eng._v, eng._ks, eng._vs,
                              np.arange(1, 1 + P, dtype=np.int32),
                              pay(eng._k), pay(eng._v), pay(eng._ks),
                              pay(eng._vs))
    if kind == "decode":
        eng = _traffic_engine(device, size, tp=tp, weight_sharding=ws,
                              tp_combine=combine)
        active = np.asarray([True] * (M - 1) + [False])
        return eng, _decode_call(eng), _engine_args(
            eng, eng._device_table(), eng._lens, eng._last, active,
            (eng.seed, 0, 1))
    if kind == "verify":
        eng = _traffic_engine(device, size, speculative=True, tp=tp,
                              weight_sharding=ws, tp_combine=combine,
                              temperature=temperature)
        active = np.asarray([True] * (M - 1) + [False])
        return eng, _verify_call(eng), _engine_args(
            eng, eng._device_table(), eng._lens, eng._last,
            np.zeros((M, size.gamma), np.int32), active,
            (eng.seed, 2, 1), np.full(M, size.gamma, np.int32))
    eng = _traffic_engine(device, size, prefill_attn=attn, tp=tp,
                          weight_sharding=ws, tp_combine=combine)
    npg = size.tb // ps
    pids = np.tile(np.arange(1 + hb, 1 + hb + npg, dtype=np.int32), (M, 1))
    if hb:
        ptbl = np.tile(np.arange(1, 1 + hb, dtype=np.int32)[None], (M, 1))
        hits = np.full(M, hb * ps, np.int32)
    else:
        ptbl = np.zeros((M, 0), np.int32)
        hits = np.zeros(M, np.int32)
    return eng, _prefill_call(eng), _engine_args(
        eng, eng._lens, eng._last, np.arange(M, dtype=np.int32), pids,
        ptbl, hits, np.zeros((M, size.tb), np.int32),
        np.full(M, size.tb, np.int32), (eng.seed, 1, 1))


def _make_traffic_build(**spec):
    def build(device, rank=0, world=1):
        return _traffic_call(device, **spec)[1:]
    return build


def traffic_entrypoints(size: TrafficSize = TRAFFIC_SIZE
                        ) -> List[Tuple[str, object]]:
    """(name, TrafficEntry) for the traffic audit, with the contracts of
    ``traffic_contracts()``. The ``_tp2`` entries run on each rank of a
    spawned world of two; the two gather rungs are refused by the port
    (F5: ``prefill_attn="gather"``), so their build asserts the refusal
    and they are reported as refused."""
    from .traffic import TrafficEntry

    contracts = traffic_contracts()
    geo = size.geometry()
    return [(name, TrafficEntry(
        _make_traffic_build(size=size, **spec), geo, contracts.get(name),
        world=2 if spec.get("tp") else 1,
        refused=GATHER_REFUSAL if spec.get("attn") == "gather" else ""))
        for name, spec in _TRAFFIC_ENTRIES]


def traffic_entry_names() -> List[str]:
    return [name for name, _spec in _TRAFFIC_ENTRIES]


# -- sharding audit (analysis/gspmd.py) -----------------------------------------

GSPMD_NAMES: Tuple[str, ...] = (
    "generate_sharded", "batcher_decode_paged_tp", "batcher_prefill_paged_tp",
    "batcher_prefill_paged_prefix_tp", "batcher_verify_paged_tp",
    "batcher_decode_paged_tp_psum", "batcher_decode_paged_tp_replicated")


def _gspmd_generate(device, rank, world):
    import torch

    from ..models.llama import init_params
    from ..models.serving import generate
    from ..parallel.sharding import mesh_coords
    from .gspmd import RankView

    cfg = _traffic_cfg()
    mesh = _mesh(device, tp=world)
    model = init_params(cfg, torch.Generator().manual_seed(0), device,
                        mesh=mesh)
    prompt = torch.zeros((2, 8), dtype=torch.int64, device=device)
    sizes, index = mesh_coords(mesh)
    return RankView(sizes, index, run=lambda: generate(
        model, prompt, cfg, max_new=4, mesh=mesh, max_len=32),
        cache_full=(cfg.n_layers, 2, 32, cfg.n_kv_heads, cfg.head_dim))


def _rank_tensors(eng, weights: bool) -> list:
    """The rank's pool planes (and Megatron weights) against their whole
    shapes and the rules table's specs."""
    from ..parallel.sharding import WEIGHT_SPECS
    from .gspmd import Sharded, pool_spec, weight_spec

    cfg = eng.cfg
    out = []
    for label, t in (("k pool", eng._k), ("v pool", eng._v),
                     ("k scales", eng._ks), ("v scales", eng._vs)):
        if t is not None:
            full = tuple(t.shape[:3]) + (cfg.n_kv_heads, t.shape[4])
            out.append(Sharded(label, t, full, pool_spec(), "pool"))
    if weights:
        d, hd = cfg.d_model, cfg.head_dim
        whole = {"wq": (d, cfg.n_heads * hd), "wk": (d, cfg.n_kv_heads * hd),
                 "wv": (d, cfg.n_kv_heads * hd), "wo": (cfg.n_heads * hd, d),
                 "w_gate": (d, cfg.d_ff), "w_up": (d, cfg.d_ff),
                 "w_down": (cfg.d_ff, d)}
        for i, blk in enumerate(eng.model.blocks):
            for name, kind in WEIGHT_SPECS.items():
                out.append(Sharded(f"blocks.{i}.{name}", getattr(blk, name),
                                   whole[name], weight_spec(kind), "weight"))
    return out


def _gspmd_engine(kind: str, hb: int = 0, ws: bool = True,
                  combine: str = "all_gather"):
    def build(device, rank, world):
        from ..parallel.island import Island
        from ..parallel.sharding import mesh_coords
        from .gspmd import RankView

        size = TrafficSize(slots=2, max_len=32, n_pages=None, tb=8, hb=1,
                           gamma=2)
        spec = {"kind": kind, "hb": hb, "tp": True, "ws": ws,
                "combine": combine}
        if kind == "prefill" and hb:
            spec["attn"] = "kernel"
        eng, fn, args = _traffic_call(device, size=size, **spec)
        sizes, index = mesh_coords(_mesh(device, tp=world))
        return RankView(sizes, index, _rank_tensors(eng, ws),
                        island=isinstance(eng._island, Island),
                        run=lambda: fn(*args))
    return build


def gspmd_entrypoints() -> List[Tuple[str, object]]:
    """(name, GspmdEntry) for the sharding audit — JAX's 7 names, each run
    on every rank of a spawned world of two: ``generate(mesh=)``'s cache
    (``cache_spec``), the tp islands' pools and weights (``pool_spec``,
    ``weight_specs``), and the replicated-weight island (pool only)."""
    from .gspmd import GspmdEntry

    both = {"pool_spec": True, "weight_specs": True}
    return [
        ("generate_sharded", GspmdEntry(_gspmd_generate,
                                        {"cache_spec": True})),
        ("batcher_decode_paged_tp", GspmdEntry(_gspmd_engine("decode"),
                                               both)),
        ("batcher_prefill_paged_tp", GspmdEntry(_gspmd_engine("prefill"),
                                                both)),
        ("batcher_prefill_paged_prefix_tp",
         GspmdEntry(_gspmd_engine("prefill", hb=1), both)),
        ("batcher_verify_paged_tp", GspmdEntry(_gspmd_engine("verify"),
                                               both)),
        ("batcher_decode_paged_tp_psum",
         GspmdEntry(_gspmd_engine("decode", combine="psum"), both)),
        ("batcher_decode_paged_tp_replicated",
         GspmdEntry(_gspmd_engine("decode", ws=False), {"pool_spec": True})),
    ]


# -- tp steady states (analysis/steady.py, on each rank of a world) ------------

def _steady_tp(weight_sharding: bool):
    """JAX's ``_sharded_paged_batcher_scenario`` on a rank of a tp world:
    the leader drives the engine and, after the warm-up and after each
    steady step, stops its followers' ``follow()`` with one "stop"
    command; a follower replays each stretch (``follow()`` returns at the
    stop). Every rank audits its own pool slice and table."""
    def build(device, size=TINY):
        import numpy as np

        from ..models.serving import ContinuousBatcher
        from .steady import engine_tensors

        cfg = _traffic_cfg()
        eng = ContinuousBatcher(
            _model(TINY, cfg, device), cfg, n_slots=2, max_len=64, chunk=2,
            prefill_bucket=8, kv_dtype="int8", kv_layout="paged",
            page_size=8, device=device, mesh=_mesh(device, tp=_world_size()),
            weight_sharding=weight_sharding)
        rng = np.random.default_rng(0)

        def stretch(fn):
            def go():
                if eng.is_leader:
                    fn()
                    eng._island.send("stop", {})
                else:
                    eng.follow()
            return go

        def warmup():
            for n in (6, 7):
                eng.submit(_tokens(rng, eng, n), max_new=40)
            for _ in range(3):
                eng.step()

        return stretch(warmup), [stretch(eng.step)] * 3, \
            lambda: engine_tensors(eng)
    return build
