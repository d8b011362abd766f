"""The sampled lockstep ``generate`` and ``sample`` (``serve/generate.py``,
``serve/sampling.py``) against the JAX package on the CPU.

Greedy (``sampling`` None or temperature 0) gives JAX's tokens exactly.
Sampled rows draw from a ``torch.Generator``, JAX's from threefry: the
draws cannot be equal, so they are held to the filtered distribution (the
support that top-k and top-p leave, JAX's filter on the same logits; a
chi-square test of the frequencies) and to determinism under a seed. The
CLI takes JAX's flags with JAX's defaults.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pt2tpu import cli as jcli
from pt2tpu.models import registry as jreg
from pt2tpu.serve import sampling as jsampling
from pt2tpu.serve.generate import generate as jgenerate
from pt2tpu.utils import checkpoint as jckpt
from pt2tpu.utils import randmodel as jrand
from pt2tpu_torch import cli as tcli
from pt2tpu_torch.models.registry import get_config
from pt2tpu_torch.serve.generate import generate as tgenerate
from pt2tpu_torch.serve.generate import greedy_generate as tgreedy
from pt2tpu_torch.serve.sampling import SamplingConfig, filtered_logits, sample

from test_torch_packed_gather import to_port


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _model(name="tiny-llama", seed=0):
    jcfg = jreg.get_config(name)
    params = jrand.random_ternary_params(jcfg, jax.random.PRNGKey(seed), perm_mode="ssr",
                                         dtype=jnp.float32)
    return jcfg, get_config(name), params


@pytest.mark.parametrize("name", ["tiny-llama", "tiny-gemma3"])
@pytest.mark.parametrize("sampling", [None, SamplingConfig(), SamplingConfig(0.0, 5, 0.5)],
                         ids=["none", "default", "temp0"])
def test_greedy_config_gives_jax_tokens(name, sampling):
    jcfg, tcfg, params = _model(name, 1)
    prompt = np.random.default_rng(1).integers(0, jcfg.vocab_size, (3, 8)).astype(np.int32)
    jsc = None if sampling is None else jsampling.SamplingConfig(*dataclass_values(sampling))
    want = np.asarray(jgenerate(jcfg, params, jnp.asarray(prompt), 7, impl="xla",
                                sampling=jsc))
    got = tgenerate(tcfg, to_port(params), torch.from_numpy(prompt), 7, sampling=sampling)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        tgreedy(tcfg, to_port(params), torch.from_numpy(prompt), 7).numpy(), want)


def dataclass_values(sc):
    return (sc.temperature, sc.top_k, sc.top_p)


def _logits(seed=0, B=4, V=64):
    return torch.from_numpy(np.random.default_rng(seed).normal(0, 2, (B, V)).astype(np.float32))


def test_sample_greedy_is_argmax_and_needs_a_generator():
    lg = _logits()
    np.testing.assert_array_equal(sample(lg).numpy(), np.asarray(
        jsampling.sample(jnp.asarray(lg.numpy()))))
    with pytest.raises(ValueError, match="torch.Generator"):
        sample(lg, None, SamplingConfig(temperature=1.0))


@pytest.mark.parametrize("cfg", [SamplingConfig(1.0, 5, 1.0), SamplingConfig(0.7, 0, 0.6),
                                 SamplingConfig(1.3, 9, 0.8)], ids=["topk", "topp", "both"])
def test_sample_support_is_jax_filtered_support(cfg):
    """Every draw lies in the support JAX's sampler leaves on the same
    logits (its top-k then top-p masks), and the draws cover it."""
    lg = _logits(3, B=2, V=48)
    jl = jnp.asarray(lg.numpy()) / cfg.temperature
    if cfg.top_k:
        kth = jnp.sort(jl, axis=-1)[:, -cfg.top_k][:, None]
        jl = jnp.where(jl >= kth, jl, -jnp.inf)
    if cfg.top_p < 1.0:
        srt = jnp.sort(jl, axis=-1)[:, ::-1]
        cum = jnp.cumsum(jax.nn.softmax(srt, axis=-1), axis=-1)
        cut = jnp.take_along_axis(srt, jnp.sum(cum < cfg.top_p, axis=-1)[:, None], axis=-1)
        jl = jnp.where(jl >= cut, jl, -jnp.inf)
    support = [set(np.flatnonzero(np.isfinite(np.asarray(jl[b])))) for b in range(2)]
    g = torch.Generator().manual_seed(11)
    seen = [set(), set()]
    for _ in range(400):
        tok = sample(lg, g, cfg)
        for b in range(2):
            seen[b].add(int(tok[b]))
    assert seen == support


def test_sample_frequencies_follow_the_filtered_softmax():
    """Chi-square of 4000 draws of one row against softmax(filtered logits)."""
    cfg = SamplingConfig(temperature=0.9, top_k=6)
    lg = _logits(5, B=1, V=32)
    p = torch.softmax(filtered_logits(lg, torch.tensor([0.9]), torch.tensor([6]),
                                      torch.tensor([1.0])), dim=-1)[0].numpy()
    g = torch.Generator().manual_seed(2)
    counts = np.bincount([int(sample(lg, g, cfg)[0]) for _ in range(4000)], minlength=32)
    keep = p > 0
    assert counts[~keep].sum() == 0
    exp = 4000 * p[keep]
    chi2 = float(((counts[keep] - exp) ** 2 / exp).sum())
    assert chi2 < 20.5  # 5 degrees of freedom: p = 0.001


def test_sampled_generate_is_deterministic_under_a_seed():
    jcfg, tcfg, params = _model("tiny-llama", 2)
    tparams = to_port(params)
    prompt = torch.from_numpy(
        np.random.default_rng(2).integers(0, jcfg.vocab_size, (2, 6)).astype(np.int32))
    sc = SamplingConfig(temperature=1.0, top_k=40, top_p=0.95)

    def run(seed):
        g = torch.Generator().manual_seed(seed)
        return tgenerate(tcfg, tparams, prompt, 10, sampling=sc, generator=g)

    a, b, c = run(7), run(7), run(8)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert a.shape == (2, 10) and a.dtype == torch.int32
    # no generator: one seeded with 0, as JAX's default PRNGKey(0)
    assert torch.equal(tgenerate(tcfg, tparams, prompt, 10, sampling=sc), run(0))


def test_cli_sampling_flags_take_jax_defaults(tmp_path, capsys):
    jp, tp = jcli.build_parser(), tcli.build_parser()
    base = ["generate", "--model", "m"]
    for extra in ([], ["--temperature", "0.8", "--top_k", "7", "--top_p", "0.9"]):
        ja, ta = jp.parse_args(base + extra), tp.parse_args(base + extra)
        assert (ta.temperature, ta.top_k, ta.top_p, ta.ring_kv) == (
            ja.temperature, ja.top_k, ja.top_p, ja.ring_kv)
    jcfg = jreg.get_config("tiny-llama")
    params = jrand.random_ternary_params(jcfg, jax.random.PRNGKey(4), perm_mode="down")
    jckpt.save_model(str(tmp_path), jcfg, params)
    argv = ["generate", "--model", str(tmp_path), "--prompt-ids", "5,17,3,99", "--max-new",
            "6", "--device", "cpu"]
    # temperature 0 with top-k / top-p set is greedy: JAX's ids
    jcli.main(argv[:-2] + ["--top_k", "3"])
    want = capsys.readouterr().out.strip().splitlines()[-1]
    tcli.main(argv + ["--top_k", "3"])
    assert capsys.readouterr().out.strip().splitlines()[-1] == want
    outs = []
    for seed in ("3", "3", "4"):
        tcli.main(argv + ["--temperature", "1.5", "--top_k", "50", "--seed", seed])
        outs.append(capsys.readouterr().out.strip().splitlines()[-1])
    assert outs[0] == outs[1] and len(outs[0].split(",")) == 6
