"""Every dense family of the JAX registry in the port, against the JAX
package on the CPU, and the cases that tests/test_torch_families_engine.py
and tests/test_torch_families_quant.py share with it: the tiny configs of
every dense family besides llama and gemma v1, each in both packages, and
their parameters made once by JAX and carried into the port.

The families: tiny-qwen3 (qk-norm), tiny-opt (LayerNorm, learned positions
with OPT's offset, relu, an ungated MLP, biases), tiny-gpt2 (the same with
gelu), tiny-bloom (ALiBi with 4 heads, the embedding LayerNorm), tiny-gemma3
(qk-norm by 1 + w, sandwich norms, a window of 16 on every other layer with
a local RoPE base, linear scaling on the global layers) and tiny-qwen2, a
tiny llama with qwen2's q/k/v bias and RoPE base 1e6. Norm weights and
biases are drawn at random (the registry's inits leave them ones and
zeros), so every norm and bias takes part.

- The registry: every JAX entry (the mixture-of-experts ones too) equals
  the port's field for field, ``get_model_type`` agrees on a list of names.
- Logits of ``forward`` in f32 (dense weights, and packed ones in the
  "ssr" and "down" layouts) within 1e-4 of max|logit|: the same f32 math in
  another summation order.
- ``greedy_generate``: tokens identical, bf16 and int8 KV, whole and
  chunked prefill (tiny-gemma3's window of 16 binds in both and in decode;
  tiny-bloom's ALiBi takes the mask on single-token steps).
- The pieces: ALiBi slopes for 4, 6 and 12 heads (two not powers of two)
  and the bias exactly; the embeddings within 1e-6, LayerNorm within 1e-6
  relative and 1e-5 absolute, the attention masks (per head, per row) and
  the softcap within 1e-5; ``sliding_adjust``'s three branches exactly (its
  RoPE tables within 2^-23 per position: XLA's and torch's f32 pow).

Torch runs on one intra-op thread, as in the engine tests."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pt2tpu.models import common as jcommon
from pt2tpu.models import decoder as jdec
from pt2tpu.models import registry as jreg
from pt2tpu.serve.generate import greedy_generate as jgreedy
from pt2tpu.utils import checkpoint as jckpt
from pt2tpu.utils import randmodel as jrand
from pt2tpu_torch.models import common as tcommon
from pt2tpu_torch.models import decoder as tdec
from pt2tpu_torch.models import registry as treg
from pt2tpu_torch.serve.generate import greedy_generate
from pt2tpu_torch.utils.checkpoint import params_from_numpy

FAMILIES = ("tiny-qwen3", "tiny-opt", "tiny-gpt2", "tiny-bloom", "tiny-gemma3", "tiny-qwen2")
QWEN2 = dict(family="qwen", qkv_bias=True, rope_theta=1000000.0)


def configs(name):
    """(JAX config, port config) of a family case."""
    if name == "tiny-qwen2":
        return (jreg.get_config("tiny-llama-gqa").with_(**QWEN2),
                treg.get_config("tiny-llama-gqa").with_(**QWEN2))
    return jreg.get_config(name), treg.get_config(name)


def _is_bias(key):
    return key.endswith((".b", ".bias", "_b"))


def _is_norm(key):
    return key.split(".")[-1] in ("ln1_w", "ln2_w", "lnf_w", "emb_ln_w", "q_norm_w",
                                  "k_norm_w", "post_attn_w", "post_mlp_w")


def jax_params(name, layout, seed):
    """JAX parameters of a case: ``init_params`` ("dense") or
    ``random_ternary_params`` in a perm layout, f32, with random norm
    weights and biases."""
    jcfg, _ = configs(name)
    key = jax.random.PRNGKey(seed)
    if layout == "dense":
        tree = jdec.init_params(jcfg, key, dtype=jnp.float32)
    else:
        tree = jrand.random_ternary_params(jcfg, key, dtype=jnp.float32, perm_mode=layout)
    flat, structure = {}, {}
    jckpt._flatten("", tree, flat, structure)
    rng = np.random.default_rng(seed + 100)
    arrays = {}
    for k, v in flat.items():
        a = np.asarray(v)
        if _is_bias(k):
            a = rng.normal(0.0, 0.1, a.shape).astype(a.dtype)
        elif _is_norm(k):
            base = 0.0 if jcfg.norm_plus_one else 1.0
            a = (base + rng.normal(0.0, 0.1, a.shape)).astype(a.dtype)
        arrays[k] = a
    return jckpt._unflatten("", structure, {k: jnp.asarray(v) for k, v in arrays.items()})


def to_port(tree):
    """A JAX parameter tree, carried into the port on the CPU."""
    flat, structure = {}, {}
    jckpt._flatten("", tree, flat, structure)
    return params_from_numpy(structure, {k: np.asarray(v) for k, v in flat.items()}, "cpu")


LOGIT_TOL = 1e-4  # of max|logit|
PIECE_TOL = 1e-6


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_registry_entries_equal_jax():
    assert sorted(jreg.CONFIGS) == sorted(treg.CONFIGS)
    for name in jreg.CONFIGS:
        assert dataclasses.asdict(treg.get_config(name)) == dataclasses.asdict(
            jreg.get_config(name)), name
        tdec.check_supported(treg.get_config(name))
    for name in ("mixtral-8x7b", "qwen3-30b-a3b", "tiny-moe"):
        assert treg.get_config(name).is_moe and jreg.get_config(name).is_moe
        assert treg.get_config(name).expert_inter == jreg.get_config(name).expert_inter
    with pytest.raises(KeyError, match="unknown model config"):
        treg.get_config("mixtral-8x22b")
    names = ["meta-llama/Llama-2-7b-hf", "Meta-Llama-3-8B", "llama-7b", "Qwen/Qwen2-7B",
             "Qwen3-8B", "qwen3-30b-a3b", "facebook/opt-1.3b", "gpt2-xl", "openai-gpt-2",
             "bigscience/bloom-560m", "google/gemma-2b", "gemma-2-9b", "google/gemma-2",
             "gemma2-27b", "google/gemma-3-4b-pt", "gemma3-1b", "mistralai/Mixtral-8x7B",
             "something-else", "/models/local/ckpt"]
    assert [treg.get_model_type(n) for n in names] == [jreg.get_model_type(n) for n in names]


def test_layer_globals_cycle_when_cut():
    jcfg, tcfg = configs("tiny-gemma3")
    for n in (1, 2, 3, 7):
        assert tcfg.with_(n_layers=n).globals_list() == jcfg.with_(n_layers=n).globals_list()
    g = treg.get_config("gemma3-4b").globals_list()
    assert len(g) == 34 and sum(g) == 5 and g[5] and not g[4]


@pytest.mark.parametrize("layout", ["dense", "ssr", "down"])
@pytest.mark.parametrize("name", FAMILIES)
def test_logits_match_jax(name, layout):
    jcfg, tcfg = configs(name)
    params = jax_params(name, layout, seed=len(name) + len(layout))
    tokens = np.random.default_rng(1).integers(0, jcfg.vocab_size, size=(2, 40))
    want = np.asarray(jdec.forward(jcfg, params, jnp.asarray(tokens, jnp.int32)))
    got = tdec.forward(tcfg, to_port(params), torch.from_numpy(tokens)).numpy()
    assert got.shape == want.shape and np.isfinite(got).all()
    assert np.abs(got - want).max() <= LOGIT_TOL * np.abs(want).max()


# chunked prefill on the families with windows, ALiBi and learned positions
GREEDY_CASES = [(n, None) for n in FAMILIES] + [(n, 8) for n in ("tiny-gemma3", "tiny-bloom",
                                                                   "tiny-opt")]


@pytest.mark.parametrize("kv_quant", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("name,chunk", GREEDY_CASES,
                         ids=[f"{n}-{'chunk8' if c else 'whole'}" for n, c in GREEDY_CASES])
def test_greedy_tokens_equal_jax(name, chunk, kv_quant):
    jcfg, tcfg = configs(name)
    params = jax_params(name, "ssr", seed=7)
    prompts = np.random.default_rng(2).integers(0, jcfg.vocab_size, size=(2, 21)).astype(np.int32)
    want = np.asarray(jgreedy(jcfg, params, jnp.asarray(prompts), 12, max_len=40,
                              kv_quant=kv_quant, prefill_chunk=chunk or 0))
    got = greedy_generate(tcfg, to_port(params), torch.from_numpy(prompts), 12, max_len=40,
                          kv_quant=kv_quant, prefill_chunk=chunk or 0).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n_heads", [4, 6, 12])
def test_alibi_slopes_and_bias_equal_jax(n_heads):
    np.testing.assert_array_equal(tcommon.alibi_slopes(n_heads).numpy(),
                                  np.asarray(jcommon.alibi_slopes(n_heads)))
    q_pos = np.array([0, 3, 9])
    want = np.asarray(jcommon.alibi_bias(n_heads, jnp.asarray(q_pos), 11))
    got = tcommon.alibi_bias(n_heads, torch.from_numpy(q_pos), 11).numpy()
    np.testing.assert_array_equal(got, want)


def test_layer_norm_equals_jax():
    rng = np.random.default_rng(3)
    x = rng.normal(2.0, 3.0, size=(3, 5, 64)).astype(np.float32)
    w, b = rng.normal(size=64).astype(np.float32), rng.normal(size=64).astype(np.float32)
    want = np.asarray(jcommon.layer_norm(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), 1e-5))
    got = tcommon.layer_norm(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b))
    np.testing.assert_allclose(got.numpy(), want, rtol=PIECE_TOL, atol=PIECE_TOL * 10)


@pytest.mark.parametrize("mask_kind", ["shared", "per_head", "per_row_shared", "per_row"])
@pytest.mark.parametrize("softcap", [0.0, 5.0])
def test_attention_masks_and_softcap_equal_jax(mask_kind, softcap):
    rng = np.random.default_rng(4)
    B, Lq, H, Hkv, M, hd = 2, 3, 6, 2, 10, 16
    q = rng.normal(size=(B, Lq, H, hd)).astype(np.float32)
    k = rng.normal(size=(B, M, Hkv, hd)).astype(np.float32)
    v = rng.normal(size=(B, M, Hkv, hd)).astype(np.float32)
    shape = {"shared": (Lq, M), "per_head": (H, Lq, M), "per_row_shared": (B, 1, Lq, M),
             "per_row": (B, H, Lq, M)}[mask_kind]
    mask = rng.normal(size=shape).astype(np.float32)
    mask[..., -2:] = -np.inf
    valid = np.arange(M)[None, :] < np.array([[7], [9]])
    want = np.asarray(jcommon.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                        jnp.asarray(mask), jnp.asarray(valid), scale=0.3,
                                        softcap=softcap))
    got = tcommon.attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                            torch.from_numpy(mask), torch.from_numpy(valid), scale=0.3,
                            softcap=softcap)
    np.testing.assert_allclose(got.numpy(), want, rtol=PIECE_TOL * 10, atol=PIECE_TOL * 10)


@pytest.mark.parametrize("name", ["tiny-opt", "tiny-gpt2", "tiny-bloom", "tiny-gemma3"])
def test_embeddings_equal_jax(name):
    """embed_tokens at an offset and embed_tokens_per_row (learned positions
    with OPT's offset, bloom's embedding norm, gemma's scale)."""
    jcfg, tcfg = configs(name)
    params = jax_params(name, "dense", seed=5)
    tparams = to_port(params)
    toks = np.random.default_rng(5).integers(0, jcfg.vocab_size, size=(3, 4))
    want = np.asarray(jdec.embed_tokens(jcfg, params, jnp.asarray(toks, jnp.int32), pos0=7))
    got = tdec.embed_tokens(tcfg, tparams, torch.from_numpy(toks), pos0=7).numpy()
    np.testing.assert_allclose(got, want, rtol=PIECE_TOL, atol=PIECE_TOL)
    pos = np.array([[0, 1, 2, 3], [9, 10, 11, 12], [30, 31, 32, 33]])
    want = np.asarray(jdec.embed_tokens_per_row(jcfg, params, jnp.asarray(toks), jnp.asarray(pos)))
    got = tdec.embed_tokens_per_row(tcfg, tparams, torch.from_numpy(toks),
                                    torch.from_numpy(pos)).numpy()
    np.testing.assert_allclose(got, want, rtol=PIECE_TOL, atol=PIECE_TOL)
    want = np.asarray(jdec.embed_tokens_per_row(jcfg, params, jnp.asarray(toks[:, 0]),
                                                jnp.asarray(pos[:, 0])))
    got = tdec.embed_tokens_per_row(tcfg, tparams, torch.from_numpy(toks[:, 0]),
                                    torch.from_numpy(pos[:, 0])).numpy()
    np.testing.assert_allclose(got, want, rtol=PIECE_TOL, atol=PIECE_TOL)


@pytest.mark.parametrize("layer", [0, 1], ids=["sliding", "global"])
@pytest.mark.parametrize("branch", ["shared_mask", "cached_mask", "per_row", "scalar_kv_valid"])
def test_sliding_adjust_equals_jax(branch, layer):
    """The window (16) folded into a shared mask (no cache, and a cached
    chunk at position 20), into per-row ``kv_valid`` (the engine's decode)
    and into a scalar-position ``kv_valid`` (a lockstep step masked by
    ``kv_valid`` alone); the RoPE tables switch to the local pair on the
    sliding layer only."""
    jcfg, tcfg = configs("tiny-gemma3")
    M, B = 48, 3
    jtab = jdec.pos_tables(jcfg, M)
    ttab = tdec.pos_tables(tcfg, M)
    for a, b in zip(jtab, ttab):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0, atol=M * 2.0**-23)
    jc, js, jcl, jsl = jtab
    tc, ts, tcl, tsl = ttab

    class _Cache:  # JAX's sliding_adjust reads cache.k's positions when kv_valid is None
        k = jnp.zeros((B, M, 1, 1))

    rng = np.random.default_rng(6)
    if branch == "shared_mask":
        L, pos, valid = 24, None, None
        jmask, tmask = jcommon.causal_mask(L, L), tcommon.causal_mask(L, L)
        jcache = None
    elif branch == "cached_mask":
        L, pos, valid = 8, 20, None
        jmask, tmask = jcommon.causal_mask(L, M, 20), tcommon.causal_mask(L, M, 20)
        jcache = _Cache()
    elif branch == "per_row":
        L, valid = 1, rng.random((B, M)) < 0.9
        pos = np.array([3, 20, 40])
        jmask = tmask = None
        jcache = _Cache()
    else:
        L, pos, valid = 1, 30, np.broadcast_to(np.arange(M)[None, :] <= 30, (B, M))
        jmask = tmask = None
        jcache = _Cache()
    jpos = None if pos is None else jnp.asarray(pos)
    tpos = torch.from_numpy(pos) if isinstance(pos, np.ndarray) else pos
    jvalid = None if valid is None else jnp.asarray(valid)
    tvalid = None if valid is None else torch.from_numpy(np.ascontiguousarray(valid))
    want = jdec.sliding_adjust(jcfg, jnp.int32(layer), jc, js, jcl, jsl, jmask, jvalid,
                               jcache, jpos, B, L)
    got = tdec.sliding_adjust(tcfg, layer, tc, ts, tcl, tsl, tmask, tvalid, tpos, L,
                              jcache is not None)
    for a, b in zip(want, got):
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0, atol=M * 2.0**-23)
    if layer == 0:
        changed = got[2] if got[2] is not None else got[3]
        unchanged = tmask if tmask is not None else tvalid
        assert not torch.equal(changed, unchanged)  # the window binds
