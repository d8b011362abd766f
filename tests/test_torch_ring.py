"""Ring KV caches (``serve/ring.py``) against the JAX package on the CPU:
the seven cases of ``tests/test_ring.py``, each also held to JAX's
``ring_generate`` or JAX's ring engine, on tiny-gemma3 (W = 16, layers
sliding / global alternating) and a tiny gemma2-layout config (sandwich
norms, softcaps, W = 8, odd layers global). Greedy tokens are compared for
identity; nothing here has a tolerance.

Besides: the engine's refusals (JAX's), a snapshot of a ring engine
restored mid-run, and ``cli generate --ring-kv`` printing JAX's ids.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pt2tpu import cli as jcli
from pt2tpu.models import decoder as jdec
from pt2tpu.models import registry as jreg
from pt2tpu.serve.engine import ServeEngine as JEngine
from pt2tpu.serve.ring import init_ring_caches as jinit_ring
from pt2tpu.serve.ring import make_ring_engine_fns as jmake_ring
from pt2tpu.serve.ring import ring_generate as jring_generate
from pt2tpu.utils import checkpoint as jckpt
from pt2tpu.utils import randmodel as jrand
from pt2tpu_torch import cli as tcli
from pt2tpu_torch.models import registry as treg
from pt2tpu_torch.serve import ring as tring
from pt2tpu_torch.serve.engine import ServeEngine as TEngine
from pt2tpu_torch.serve.engine import load_engine_state, save_engine_state
from pt2tpu_torch.serve.generate import greedy_generate as tgreedy
from pt2tpu_torch.serve.kvcache import init_cache

from test_torch_packed_gather import to_port

GEMMA2_LAYOUT = dict(family="gemma2", n_layers=4, sandwich_norm=True, sliding_window=8,
                     layer_globals=(False, True, False, True), attn_scale=32 ** -0.5,
                     attn_softcap=50.0, final_softcap=30.0)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def configs(name):
    """(JAX config, port config): tiny-gemma3, or tiny-gemma with gemma2's
    layout ("tiny-gemma2")."""
    if name == "tiny-gemma2":
        return (jreg.get_config("tiny-gemma").with_(**GEMMA2_LAYOUT),
                treg.get_config("tiny-gemma").with_(**GEMMA2_LAYOUT))
    return jreg.get_config(name), treg.get_config(name)


def dense_params(jcfg, seed):
    return jdec.init_params(jcfg, jax.random.PRNGKey(seed), dtype=jnp.float32)


def check_lockstep(name, jparams, Lp, max_new, max_len=96, seed=0):
    """The port's ring_generate == JAX's ring_generate == the port's flat
    greedy decode, on two prompts."""
    jcfg, tcfg = configs(name)
    prompt = np.random.default_rng(seed).integers(0, jcfg.vocab_size, (2, Lp)).astype(np.int32)
    want = np.asarray(jring_generate(jcfg, jparams, jnp.asarray(prompt), max_new=max_new,
                                     max_len=max_len, impl="xla"))
    tparams = to_port(jparams)
    got = tring.ring_generate(tcfg, tparams, torch.from_numpy(prompt), max_new=max_new,
                              max_len=max_len)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    flat = tgreedy(tcfg, tparams, torch.from_numpy(prompt), max_new=max_new, max_len=max_len)
    np.testing.assert_array_equal(flat.numpy(), want)


@pytest.mark.parametrize("name", ["tiny-gemma3", "tiny-gemma2"])
def test_ring_matches_flat_past_eviction(name):
    """Decode far past the window, so the ring's slots wrap."""
    check_lockstep(name, dense_params(configs(name)[0], 0), Lp=9, max_new=24)


@pytest.mark.parametrize("name", ["tiny-gemma3", "tiny-gemma2"])
def test_ring_prefill_longer_than_window(name):
    """A prompt longer than the window: the prefill keeps the newest W
    positions, in their ring slots."""
    check_lockstep(name, dense_params(configs(name)[0], 1), Lp=23, max_new=10, seed=1)


@pytest.mark.parametrize("name", ["tiny-gemma3", "tiny-gemma2"])
def test_ring_quantized_params(name):
    jcfg = configs(name)[0]
    params = jrand.random_ternary_params(jcfg, jax.random.PRNGKey(2), perm_mode="ssr",
                                         dtype=jnp.float32)
    check_lockstep(name, params, Lp=7, max_new=20, seed=2)


@pytest.mark.parametrize("name", ["tiny-llama", "tiny-bloom"])
def test_ring_plain_model_degenerates_to_flat(name):
    """A config with no sliding layer: every layer in the global stack
    (tiny-bloom: ALiBi through the causal mask, as JAX's)."""
    check_lockstep(name, dense_params(configs(name)[0], 3), Lp=6, max_new=8, seed=3)
    caches = tring.init_ring_caches(configs(name)[1], 2, 96, device="cpu")
    assert caches.ring.k.shape[0] == 0 and caches.glob.k.shape[0] == configs(name)[1].n_layers


@pytest.mark.parametrize("name", ["tiny-gemma3", "tiny-gemma2"])
def test_ring_cache_memory_shape(name):
    jcfg, tcfg = configs(name)
    W = tcfg.sliding_window
    want = jinit_ring(jcfg, batch=2, max_len=96)
    got = tring.init_ring_caches(tcfg, 2, 96, device="cpu")
    assert tuple(got.ring.k.shape) == tuple(want.ring.k.shape) == (2, 2, W, tcfg.kv_heads, tcfg.hd)
    assert tuple(got.glob.k.shape) == tuple(want.glob.k.shape) == (2, 2, 96, tcfg.kv_heads,
                                                                    tcfg.hd)
    assert got.ring.k.dtype == torch.bfloat16 and (got.max_len, got.window) == (96, W)
    flat = init_cache(tcfg, 2, 96, device="cpu")
    assert got.nbytes == (2 * 96 + 2 * W) * 2 * tcfg.kv_heads * tcfg.hd * 2 * 2
    assert got.nbytes < flat.k.numel() * 2 * 2


PROMPT_LENS = (3, 23, 9, 5)  # 23 > W: the prefill's ring gather wraps
MAX_NEWS = (6, 5, 7, 4)


def run_engine(engine, prompts, max_news=MAX_NEWS):
    reqs = [engine.submit(p, m) for p, m in zip(prompts, max_news)]
    engine.run(max_steps=200)
    return [list(r.out) for r in reqs]


@pytest.mark.parametrize("name", ["tiny-gemma3", "tiny-gemma2"])
def test_ring_engine_matches_default(name):
    """The ring engine == JAX's ring engine == the port's flat-pool engine."""
    jcfg, tcfg = configs(name)
    jparams = dense_params(jcfg, 5)
    tparams = to_port(jparams)
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, jcfg.vocab_size, size=n).astype(np.int32) for n in PROMPT_LENS]
    jpf, jdf, jfac = jmake_ring(jcfg, impl="xla")
    want = run_engine(JEngine(jcfg, jparams, max_batch=2, max_len=64, impl="xla",
                              prefill_fn=jpf, decode_fn=jdf, cache_factory=jfac), prompts)
    pf, df, fac = tring.make_ring_engine_fns(tcfg, device="cpu")
    eng = TEngine(tcfg, tparams, max_batch=2, max_len=64, prefill_fn=pf, decode_fn=df,
                  cache_factory=fac)
    assert isinstance(eng.cache, tring.RingCaches)
    assert run_engine(eng, prompts) == want
    assert run_engine(TEngine(tcfg, tparams, max_batch=2, max_len=64), prompts) == want


@pytest.mark.parametrize("name", ["tiny-llama", "tiny-bloom"])
def test_ring_engine_plain_model(name):
    """A config with no sliding layer through the ring engine's fns: the
    all-global path, the default engine's tokens (and JAX's ring engine's
    for tiny-llama; its ring decode passes no ALiBi bias, so for tiny-bloom
    the port's default engine is the reference)."""
    jcfg, tcfg = configs(name)
    jparams = dense_params(jcfg, 6)
    tparams = to_port(jparams)
    p = [np.random.default_rng(6).integers(0, jcfg.vocab_size, size=5).astype(np.int32)]
    pf, df, fac = tring.make_ring_engine_fns(tcfg, device="cpu")
    got = run_engine(TEngine(tcfg, tparams, max_batch=1, max_len=64, prefill_fn=pf,
                             decode_fn=df, cache_factory=fac), p, (6,))
    assert got == run_engine(TEngine(tcfg, tparams, max_batch=1, max_len=64), p, (6,))
    if name == "tiny-llama":
        jpf, jdf, jfac = jmake_ring(jcfg, impl="xla")
        assert got == run_engine(JEngine(jcfg, jparams, max_batch=1, max_len=64, impl="xla",
                                         prefill_fn=jpf, decode_fn=jdf, cache_factory=jfac),
                                 p, (6,))


def test_engine_override_refusals():
    """JAX's refusals: a cache_factory with kv_quant or kv_heads; a draft
    beside the ring's strategy overrides or on a sliding-window config (the
    speculative engine's). Without a cache_factory, kv_heads sets the flat
    pool's KV heads, as JAX's does."""
    tcfg = treg.get_config("tiny-gemma3")
    tparams = to_port(dense_params(configs("tiny-gemma3")[0], 7))
    pf, df, fac = tring.make_ring_engine_fns(tcfg, device="cpu")
    with pytest.raises(ValueError, match="cache_factory replaces the KV pool"):
        TEngine(tcfg, tparams, kv_quant=True, prefill_fn=pf, decode_fn=df, cache_factory=fac)
    with pytest.raises(ValueError, match="cache_factory replaces the KV pool"):
        TEngine(tcfg, tparams, kv_heads=1, prefill_fn=pf, decode_fn=df, cache_factory=fac)
    assert TEngine(tcfg, tparams, max_len=64, kv_heads=1).cache.k.shape[-2] == 1 != tcfg.kv_heads
    with pytest.raises(ValueError, match="default engine programs"):
        TEngine(tcfg, tparams, draft=(tcfg, tparams), prefill_fn=pf, decode_fn=df,
                cache_factory=fac)
    with pytest.raises(ValueError, match="sliding-window"):
        TEngine(tcfg, tparams, draft=(tcfg, tparams))
    # the pool must lie where the params do (no silent copy to the card)
    with pytest.raises(ValueError, match="pool lies on"):
        TEngine(tcfg, tparams, prefill_fn=pf, decode_fn=df,
                cache_factory=lambda c, b, m: tring.init_ring_caches(c, b, m, device="meta"))


def test_ring_engine_snapshot_and_sampled_rows(tmp_path):
    """A ring engine snapshotted mid-run and restored into a new one
    continues token for token, sampled rows included (their draws depend
    on (seed, uid, position) only)."""
    from pt2tpu_torch.serve.sampling import SamplingConfig

    tcfg = treg.get_config("tiny-gemma3")
    tparams = to_port(dense_params(configs("tiny-gemma3")[0], 8))
    rng = np.random.default_rng(8)
    prompts = [rng.integers(0, tcfg.vocab_size, size=n).astype(np.int32) for n in (4, 19, 7)]
    samp = [None, SamplingConfig(temperature=0.8, top_k=20), None]

    def engine():
        pf, df, fac = tring.make_ring_engine_fns(tcfg, device="cpu")
        return TEngine(tcfg, tparams, max_batch=2, max_len=64, seed=3, prefill_fn=pf,
                       decode_fn=df, cache_factory=fac)

    whole = engine()
    reqs = [whole.submit(p, 12, sampling=s) for p, s in zip(prompts, samp)]
    whole.run()
    half = engine()
    for p, s in zip(prompts, samp):
        half.submit(p, 12, sampling=s)
    for _ in range(5):
        half.step()
    save_engine_state(half, str(tmp_path))
    resumed = engine()
    restored = load_engine_state(resumed, str(tmp_path))
    resumed.run()
    done = {r.uid: r.out for r in resumed.finished} | {r.uid: r.out for r in half.finished}
    assert len(restored) >= 1
    assert [done[r.uid] for r in reqs] == [r.out for r in reqs]


def test_cli_ring_kv_prints_jax_ids(tmp_path, capsys):
    """``cli generate --ring-kv`` on a gemma3 artifact prints the ids of
    JAX's ring_generate and of the flat route. (JAX's own CLI cannot take
    that artifact with --ring-kv: its loaded config holds layer_globals as a
    list, which jit refuses as a static argument; JAX's refusals come first
    and are compared below.)"""
    jcfg = jreg.get_config("tiny-gemma3")
    params = jrand.random_ternary_params(jcfg, jax.random.PRNGKey(9), perm_mode="down")
    jckpt.save_model(str(tmp_path), jcfg, params)
    ids = list(range(3, 63, 3))  # 20 > W = 16
    argv = ["generate", "--model", str(tmp_path), "--prompt-ids", ",".join(map(str, ids)),
            "--max-new", "7", "--ring-kv"]
    want = np.asarray(jring_generate(jcfg, params, jnp.asarray([ids], jnp.int32), max_new=7,
                                     max_len=len(ids) + 7))[0].tolist()
    tcli.main(argv + ["--device", "cpu"])
    got = capsys.readouterr().out.strip().splitlines()[-1]
    assert got == ",".join(map(str, want))
    tcli.main(argv[:-1] + ["--device", "cpu"])  # the flat route
    assert capsys.readouterr().out.strip().splitlines()[-1] == got
    for extra, msg in ((["--temperature", "0.7"], "greedy-only"), (["--kv-int8"], "bf16")):
        with pytest.raises(SystemExit, match=msg):
            jcli.main(argv + extra)
        with pytest.raises(SystemExit, match=msg):
            tcli.main(argv + extra + ["--device", "cpu"])
