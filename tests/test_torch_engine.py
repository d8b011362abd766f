"""The port's continuous-batching ``ServeEngine`` against
``pt2tpu.serve.engine.ServeEngine`` on tiny-llama-gqa in f32: five requests
of mixed lengths through two slots (one stops at an EOS mid-stream), bf16
and int8 KV, quantum 1 and 4 -> identical tokens and the same finish order.
Each JAX engine run happens once per module (it compiles)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pt2tpu.models import registry as jreg
from pt2tpu.serve.engine import ServeEngine as JEngine
from pt2tpu.utils import checkpoint as jckpt
from pt2tpu.utils import randmodel as jrand
from pt2tpu_torch.models.registry import get_config
from pt2tpu_torch.serve import engine as teng
from pt2tpu_torch.serve.engine import ServeEngine, load_engine_state, save_engine_state
from pt2tpu_torch.serve.generate import greedy_generate
from pt2tpu_torch.serve.sampling import SamplingConfig
from pt2tpu_torch.utils.checkpoint import params_from_numpy

NAME = "tiny-llama-gqa"
LENS = (3, 17, 9, 4, 30)
MAX_NEW = (6, 4, 9, 7, 5)
EOS_REQ = 2  # the request that gets an EOS mid-stream


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Eager torch on tiny shapes runs on one intra-op thread: under
    pytest-xdist the workers share the cores, and idle OpenMP threads that
    spin for work slow every small op many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def to_port(tree):
    flat, structure = {}, {}
    jckpt._flatten("", tree, flat, structure)
    return params_from_numpy(structure, {k: np.asarray(v) for k, v in flat.items()}, "cpu")


@pytest.fixture(scope="module")
def model():
    jcfg = jreg.get_config(NAME)
    params = jrand.random_ternary_params(jcfg, jax.random.PRNGKey(3), dtype=jnp.float32,
                                         perm_mode="ssr")
    tparams = to_port(params)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, jcfg.vocab_size, size=n).astype(np.int32) for n in LENS]
    ref = greedy_generate(get_config(NAME), tparams, torch.from_numpy(prompts[EOS_REQ])[None],
                          MAX_NEW[EOS_REQ], max_len=64)[0].tolist()
    # the first token from the third on that has not come before: the
    # stream stops there, mid-way
    stop = next(j for j in range(2, len(ref) - 1) if ref.index(ref[j]) == j)
    eos_ids = [ref[stop] if i == EOS_REQ else None for i in range(len(LENS))]
    return jcfg, params, tparams, prompts, eos_ids, stop + 1


def _run(engine, prompts, eos_ids):
    reqs = [engine.submit(p, m, eos_id=e) for p, m, e in zip(prompts, MAX_NEW, eos_ids)]
    engine.run(max_steps=200)
    return [r.out for r in reqs], [r.uid for r in engine.finished]


@pytest.fixture(scope="module")
def jax_runs(model):
    jcfg, params, _, prompts, eos_ids, _ = model
    return {
        (kvq, q): _run(JEngine(jcfg, params, max_batch=2, max_len=64, kv_quant=kvq,
                               decode_quantum=q), prompts, eos_ids)
        for kvq in (False, True) for q in (1, 4)
    }


@pytest.mark.parametrize("quantum", [1, 4])
@pytest.mark.parametrize("kv_quant", [False, True], ids=["bf16", "int8"])
def test_engine_tokens_and_finish_order_equal_jax(model, jax_runs, kv_quant, quantum):
    _, _, tparams, prompts, eos_ids, stop_len = model
    eng = ServeEngine(get_config(NAME), tparams, max_batch=2, max_len=64, kv_quant=kv_quant,
                      decode_quantum=quantum)
    outs, order = _run(eng, prompts, eos_ids)
    want_outs, want_order = jax_runs[(kv_quant, quantum)]
    assert outs == want_outs
    assert order == want_order
    assert len(outs[EOS_REQ]) == stop_len < MAX_NEW[EOS_REQ]  # stopped at the EOS
    st = eng.stats
    assert st["admitted"] == st["completed"] == len(LENS)
    assert st["tokens"] == sum(len(o) for o in outs) - len(LENS)  # first tokens come from prefill
    assert st["t_admit_s"] > 0 and st["t_decode_s"] > 0


@pytest.mark.parametrize("kv_quant", [False, True], ids=["bf16", "int8"])
def test_slot_reuse_no_stale_state(model, kv_quant):
    """One slot: a long request, then a short one in the same row; each
    equals lockstep greedy decoding of its prompt alone."""
    _, _, tparams, prompts, _, _ = model
    cfg = get_config(NAME)
    eng = ServeEngine(cfg, tparams, max_batch=1, max_len=64, kv_quant=kv_quant)
    r1, r2 = eng.submit(prompts[4], 8), eng.submit(prompts[0], 8)
    eng.run(max_steps=100)
    for r, p in ((r1, prompts[4]), (r2, prompts[0])):
        want = greedy_generate(cfg, tparams, torch.from_numpy(p)[None], 8, max_len=64,
                               kv_quant=kv_quant)[0].tolist()
        assert r.out == want


def test_freed_slot_near_the_end_never_writes_past_it(model):
    """A request that fills the cache (prompt + max_new == max_len) retires
    while a long one keeps a quantum of 4 going: the freed row's stale
    position would step past max_len - 1; it is clamped, and the other row's
    tokens are those of greedy decoding alone."""
    _, _, tparams, prompts, _, _ = model
    cfg = get_config(NAME)
    eng = ServeEngine(cfg, tparams, max_batch=2, max_len=40, decode_quantum=4)
    full = eng.submit(prompts[4], 10)  # 30 + 10 == 40
    other = eng.submit(prompts[0], 33)
    eng.run(max_steps=100)
    assert full.done and other.done and len(other.out) == 33
    want = greedy_generate(cfg, tparams, torch.from_numpy(prompts[0])[None], 33,
                           max_len=40)[0].tolist()
    assert other.out == want


def test_snapshot_restore_continues_identically(model, tmp_path):
    _, _, tparams, prompts, eos_ids, _ = model
    cfg = get_config(NAME)
    sc = SamplingConfig(temperature=0.8, top_k=20, top_p=0.9)

    def fresh():
        return ServeEngine(cfg, tparams, max_batch=2, max_len=64, kv_quant=True, seed=11)

    def submit_all(eng):
        return [eng.submit(p, m, eos_id=e, sampling=sc if i % 2 else None)
                for i, (p, m, e) in enumerate(zip(prompts, MAX_NEW, eos_ids))]

    whole = fresh()
    want = submit_all(whole)
    whole.run()
    first = fresh()
    submit_all(first)
    for _ in range(4):
        first.step()
    save_engine_state(first, str(tmp_path))
    second = fresh()
    restored = load_engine_state(second, str(tmp_path))
    assert sorted(r.uid for r in restored) == sorted(
        [r.uid for r in first.slots if r is not None] + [r.uid for r in first.queue])
    second.run()
    got = {r.uid: r.out for r in first.finished + second.finished}
    assert [got[r.uid] for r in want] == [r.out for r in want]


@pytest.mark.parametrize("arg", ["draft", "prefill_fn", "decode_fn", "cache_factory",
                                 "kv_heads", "multihost"])
def test_unported_arguments_raise(model, arg):
    """``kv_heads`` builds JAX's pool shape (that many KV heads: a
    tensor-parallel rank's), and ``multihost`` in one process (no
    ``torch.distributed`` world) is off, as JAX's with one process, so the
    engine gives the default engine's tokens. ``draft`` is
    ported (speculative decoding): the model as its own draft gives JAX's
    speculative engine's tokens and counters, which are the default
    engine's. The strategy overrides are ported (JAX's contracts): the
    engine runs the ``prefill_fn`` / ``decode_fn`` it is given and threads
    the pool that a ``cache_factory`` makes, with the default engine's
    tokens, and refuses a ``cache_factory`` beside ``kv_quant`` as JAX's
    does."""
    jcfg, params, tparams, prompts, _, _ = model
    cfg = get_config(NAME)
    if arg == "kv_heads":
        jeng = JEngine(jcfg, params, max_batch=2, max_len=64, kv_heads=1)
        eng = ServeEngine(cfg, tparams, max_batch=2, max_len=64, kv_heads=1)
        assert tuple(eng.cache.k.shape) == tuple(jeng.cache.k.shape)
        assert eng.cache.k.shape[-2] == 1 != cfg.kv_heads
        return
    if arg == "multihost":
        want = _run(ServeEngine(cfg, tparams, max_batch=2, max_len=64), prompts[:3], [None] * 3)
        eng = ServeEngine(cfg, tparams, max_batch=2, max_len=64, multihost=True)
        assert not eng._mh and _run(eng, prompts[:3], [None] * 3) == want
        return
    if arg == "draft":
        jeng = JEngine(jcfg, params, max_batch=2, max_len=64, draft=(jcfg, params), spec_k=2)
        want = _run(jeng, prompts[:3], [None] * 3)
        eng = ServeEngine(cfg, tparams, max_batch=2, max_len=64, draft=(cfg, tparams), spec_k=2)
        assert _run(eng, prompts[:3], [None] * 3) == want
        assert eng.stats_spec == jeng.stats_spec
        plain = ServeEngine(cfg, tparams, max_batch=2, max_len=64)
        assert _run(plain, prompts[:3], [None] * 3)[0] == want[0]
        return
    calls = []
    default = {"prefill_fn": teng._prefill_into_slot, "decode_fn": teng._decode_step,
               "cache_factory": lambda c, b, m: teng.init_cache(c, b, m, device="cpu")}[arg]

    def recorded(*a):
        calls.append(arg)
        return default(*a)

    def run(**kw):
        eng = ServeEngine(cfg, tparams, max_batch=2, max_len=64, **kw)
        reqs = [eng.submit(p, 4) for p in prompts[:3]]
        eng.run()
        return [r.out for r in reqs]

    assert run(**{arg: recorded}) == run() and calls
    if arg == "cache_factory":
        with pytest.raises(ValueError, match="cache_factory replaces the KV pool"):
            ServeEngine(cfg, tparams, max_len=64, kv_quant=True, cache_factory=recorded)


def test_too_long_request_finishes_empty(model):
    _, _, tparams, prompts, _, _ = model
    eng = ServeEngine(get_config(NAME), tparams, max_batch=2, max_len=32)
    r = eng.submit(prompts[4], 5)  # 30 + 5 > 32
    ok = eng.submit(prompts[0], 3)
    eng.run()
    assert r.done and r.out == [] and len(ok.out) == 3


def test_bucket_and_quantum_rules():
    assert [teng._bucket(n) for n in (1, 16, 17, 100, 512, 513)] == [16, 16, 32, 128, 512, 1024]
    eng = ServeEngine.__new__(ServeEngine)
    eng.decode_quantum = 8
    eng.slots = [None] * 3
    assert eng._quantum_q() == 1
    from pt2tpu_torch.serve.engine import Request
    eng.slots = [Request(0, np.zeros(3, np.int32), 20, out=[1] * 14), None,
                 Request(1, np.zeros(3, np.int32), 40, out=[1])]
    assert eng._quantum_q() == 4  # 6 left -> 4


@pytest.fixture(scope="module")
def a8_runs():
    """tiny-llama in the "down" layout (SSR on down only, as the quantizer
    emits it at dim >= 640), the module's five requests, the JAX engine in
    W2A8 (impl="a8"), bf16 KV, quantum 1: its tokens and finish order."""
    jcfg = jreg.get_config("tiny-llama")
    params = jrand.random_ternary_params(jcfg, jax.random.PRNGKey(5), dtype=jnp.float32,
                                         perm_mode="down")
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, jcfg.vocab_size, size=n).astype(np.int32) for n in LENS]
    eos_ids = [None] * len(LENS)
    want = _run(JEngine(jcfg, params, max_batch=2, max_len=64, impl="a8"), prompts, eos_ids)
    return to_port(params), prompts, eos_ids, want


def test_engine_a8_tokens_and_finish_order_equal_jax(a8_runs):
    """W2A8 serving (on the card its admission prefills run K1 on the int8
    tensor cores, its decode steps K1 on the CUDA cores) gives the JAX
    engine's greedy tokens and finish order."""
    tparams, prompts, eos_ids, (want_outs, want_order) = a8_runs
    eng = ServeEngine(get_config("tiny-llama"), tparams, max_batch=2, max_len=64, impl="a8")
    outs, order = _run(eng, prompts, eos_ids)
    assert outs == want_outs
    assert order == want_order
    assert [len(o) for o in outs] == list(MAX_NEW)


@pytest.fixture(scope="module")
def gemma_runs():
    """tiny-gemma (GeGLU, norms by 1 + w, scaled and tied embeddings) in the
    full-SSR layout the quantizer emits at its width, the module's five
    requests through two slots, the JAX engine with bf16 and int8 KV,
    quantum 1: its tokens and finish order."""
    jcfg = jreg.get_config("tiny-gemma")
    params = jrand.random_ternary_params(jcfg, jax.random.PRNGKey(9), dtype=jnp.float32,
                                         perm_mode="ssr")
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, jcfg.vocab_size, size=n).astype(np.int32) for n in LENS]
    eos_ids = [None] * len(LENS)
    want = {kvq: _run(JEngine(jcfg, params, max_batch=2, max_len=64, kv_quant=kvq), prompts,
                      eos_ids) for kvq in (False, True)}
    return to_port(params), prompts, eos_ids, want


@pytest.mark.parametrize("kv_quant", [False, True], ids=["bf16", "int8"])
def test_gemma_engine_tokens_and_finish_order_equal_jax(gemma_runs, kv_quant):
    tparams, prompts, eos_ids, want = gemma_runs
    cfg = get_config("tiny-gemma")
    assert tparams["lm_head"] is None  # tied embeddings
    eng = ServeEngine(cfg, tparams, max_batch=2, max_len=64, kv_quant=kv_quant)
    outs, order = _run(eng, prompts, eos_ids)
    want_outs, want_order = want[kv_quant]
    assert outs == want_outs
    assert order == want_order
    assert [len(o) for o in outs] == list(MAX_NEW)
