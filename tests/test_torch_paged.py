"""The port's paged KV engine (``serve/paged.py``) against the JAX package's
``PagedServeEngine`` and the flat engines (CPU, f32 dense weights carried
across from JAX).

JAX's seven cases (``tests/test_paged.py``) on tiny-llama and tiny-opt:
tokens, finish order and the free list after a drain equal JAX's paged
engine; a decode across page boundaries; backpressure with a pool too small
for two requests; sampling determinism; int8 pools; snapshot / restore of
the page bookkeeping; a sliding-window family. Then what JAX's engine does
not keep: quantum 4 and 8 across page boundaries, and a prompt that fills
its page-aligned bucket exactly, held to the flat engine's tokens (JAX's
paged engine writes those positions to its scratch page).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pt2tpu.models import decoder as jdec
from pt2tpu.models import registry as jreg
from pt2tpu.serve.paged import PagedServeEngine as JPaged
from pt2tpu.utils import checkpoint as jckpt
from pt2tpu_torch.models.registry import get_config
from pt2tpu_torch.serve.engine import ServeEngine, load_engine_state, save_engine_state
from pt2tpu_torch.serve.paged import PagedKV, PagedServeEngine, init_paged
from pt2tpu_torch.serve.sampling import SamplingConfig
from pt2tpu_torch.utils.checkpoint import params_from_numpy

PS = 16


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Eager torch on tiny shapes runs on one intra-op thread (under xdist
    idle OpenMP threads slow every small op)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def to_port(tree):
    flat, structure = {}, {}
    jckpt._flatten("", tree, flat, structure)
    return params_from_numpy(structure, {k: np.asarray(v) for k, v in flat.items()}, "cpu")


def prompts_of(cfg, seed, lens):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32) for n in lens]


def run(eng, prompts, max_news, sampl=None):
    reqs = [eng.submit(p, m, sampling=(sampl[i] if sampl else None))
            for i, (p, m) in enumerate(zip(prompts, max_news))]
    eng.run(max_steps=300)
    assert all(r.done for r in reqs)
    return [r.out for r in reqs], [r.uid for r in eng.finished]


# (seed of the prompts, their lengths, max_new, engine keywords) of JAX's cases
CASES = {
    "dense": (0, (3, 9, 5, 17, 4), (6, 4, 8, 5, 7), {}),
    "crossing": (1, (5,), (24,), {}),
    "backpressure": (2, (9, 7, 5), (5, 6, 4), {"kv_pages": 3}),
    "int8": (5, (4, 9, 6), (6, 5, 7), {"kv_quant": True}),
}


@pytest.fixture(scope="module", params=["tiny-llama", "tiny-opt"])
def model(request):
    jcfg = jreg.get_config(request.param)
    params = jdec.init_params(jcfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    want = {}
    for name, (seed, lens, news, kw) in CASES.items():
        eng = JPaged(jcfg, params, max_batch=2, max_len=64, page_size=PS, **kw)
        outs, order = run(eng, prompts_of(jcfg, seed, lens), news)
        want[name] = (outs, order, list(eng._free))
    return get_config(request.param), to_port(params), want


def port_paged(cfg, params, **kw):
    return PagedServeEngine(cfg, params, max_batch=2, max_len=64, page_size=PS, **kw)


@pytest.mark.parametrize("case", list(CASES))
def test_paged_equals_jax(model, case):
    """Tokens, finish order and the free list after the drain equal JAX's
    paged engine; the flat port engine gives the same tokens."""
    cfg, params, want = model
    seed, lens, news, kw = CASES[case]
    prompts = prompts_of(cfg, seed, lens)
    eng = port_paged(cfg, params, **kw)
    outs, order = run(eng, prompts, news)
    w_outs, w_order, w_free = want[case]
    assert outs == w_outs
    assert order == w_order
    assert eng._free == w_free
    n_pages = kw.get("kv_pages", 2 * 64 // PS)
    assert sorted(eng._free) == list(range(1, n_pages + 1))  # every page back; 0 is scratch
    assert eng.cache.quantized == kw.get("kv_quant", False)
    flat_kw = {"kv_quant": True} if kw.get("kv_quant") else {}
    flat = ServeEngine(cfg, params, max_batch=2, max_len=64, **flat_kw)
    assert run(flat, prompts, news)[0] == outs


def test_paged_sampling_is_deterministic(model):
    cfg, params, _ = model
    prompts = prompts_of(cfg, 3, (4,))
    sc = SamplingConfig(temperature=0.8, top_k=12)
    a = run(port_paged(cfg, params, seed=5), prompts, [6], sampl=[sc])[0]
    b = run(port_paged(cfg, params, seed=5), prompts, [6], sampl=[sc])[0]
    assert a == b
    assert all(0 <= t < cfg.vocab_size for t in a[0])
    # sampled rows draw from the flat engine's stream: the same tokens
    flat = ServeEngine(cfg, params, max_batch=2, max_len=64, seed=5)
    assert run(flat, prompts, [6], sampl=[sc])[0] == a


def test_paged_snapshot_restore(model, tmp_path):
    """Snapshot / restore carries the page bookkeeping: a restored engine
    finishes with the uninterrupted run's tokens and free list."""
    cfg, params, _ = model
    prompts = prompts_of(cfg, 7, (5, 9))
    news = (10, 8)
    whole = port_paged(cfg, params)
    want = run(whole, prompts, news)[0]
    eng = port_paged(cfg, params)
    for p, m in zip(prompts, news):
        eng.submit(p, m)
    for _ in range(3):
        eng.step()
    assert any(eng._pages)
    save_engine_state(eng, str(tmp_path / "snap"))
    eng2 = port_paged(cfg, params)
    restored = load_engine_state(eng2, str(tmp_path / "snap"))
    assert eng2._free == eng._free and eng2._pages == eng._pages
    eng2.run(max_steps=300)
    got = {r.uid: r.out for r in restored}
    assert [got[u] for u in range(2)] == want
    assert eng2._free == whole._free


@pytest.fixture(scope="module")
def sliding():
    jcfg = jreg.get_config("tiny-gemma3")
    params = jdec.init_params(jcfg, jax.random.PRNGKey(3), dtype=jnp.float32)
    prompts = prompts_of(jcfg, 7, (3, 21, 12))
    news = (8, 6, 14)
    eng = JPaged(jcfg, params, max_batch=2, max_len=64, page_size=PS)
    return get_config("tiny-gemma3"), to_port(params), prompts, news, run(eng, prompts, news)


def test_paged_sliding_equals_jax(sliding):
    cfg, params, prompts, news, (w_outs, w_order) = sliding
    eng = port_paged(cfg, params)
    outs, order = run(eng, prompts, news)
    assert outs == w_outs and order == w_order
    assert len(eng._free) == 2 * 64 // PS
    assert run(ServeEngine(cfg, params, max_batch=2, max_len=64), prompts, news)[0] == outs


@pytest.mark.parametrize("kv_quant", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("quantum", [4, 8])
def test_paged_quantum_across_pages_equals_flat(model, quantum, kv_quant):
    """JAX's paged engine at quantum 8 gives other tokens than its flat
    engine on these requests (its quantum writes past the current page go to
    the scratch page); the port allocates every page of the quantum first."""
    cfg, params, _ = model
    prompts = prompts_of(cfg, 0, (3, 9, 5, 17, 4))
    news = (30, 28, 26, 25, 29)
    flat = ServeEngine(cfg, params, max_batch=2, max_len=64, kv_quant=kv_quant,
                       decode_quantum=quantum)
    eng = port_paged(cfg, params, kv_quant=kv_quant, decode_quantum=quantum)
    assert run(eng, prompts, news) == run(flat, prompts, news)
    assert sorted(eng._free) == list(range(1, 9))


def test_paged_exact_bucket_prompt_equals_flat(model):
    """A prompt that fills its page-aligned bucket (16 and 32 ids at page
    size 16): its first decode position opens a page the admission did not
    allocate (JAX's engine writes it to the scratch page)."""
    cfg, params, _ = model
    prompts = prompts_of(cfg, 4, (16, 32, 7))
    news = (12, 9, 20)
    flat = ServeEngine(cfg, params, max_batch=2, max_len=64)
    assert run(port_paged(cfg, params), prompts, news) == run(flat, prompts, news)


def test_paged_pool_geometry_and_refusals():
    cfg = get_config("tiny-llama")
    pool = init_paged(cfg, 5, PS, 2, 4, device="cpu")
    assert isinstance(pool, PagedKV) and pool.max_len == 64 and pool.page_size == PS
    assert pool.k.shape == (cfg.n_layers, 5, PS, cfg.kv_heads, cfg.hd)
    assert [t.dtype for t in pool.leaves()] == [torch.bfloat16] * 2 + [torch.int32]
    q = init_paged(cfg, 5, PS, 2, 4, quantized=True, device="cpu")
    assert q.quantized and len(q.leaves()) == 5 and q.k_scale.shape[-1] == 1
    with pytest.raises(ValueError, match="multiple of page_size"):
        PagedServeEngine(cfg, {"embed": torch.zeros(1)}, max_len=60, page_size=PS)


def test_paged_pool_exhausted_mid_decode_raises(model):
    """Two rows that both cross into a second page with one page left: the
    decode that needs it raises JAX's RuntimeError."""
    cfg, params, _ = model
    eng = port_paged(cfg, params, kv_pages=3)
    for p in prompts_of(cfg, 6, (10, 10)):
        eng.submit(p, 20)
    with pytest.raises(RuntimeError, match="paged KV pool exhausted mid-decode"):
        eng.run(max_steps=300)
