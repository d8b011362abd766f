"""Greedy tokens of the port are identical to ``pt2tpu.serve.generate``'s
(llama and gemma), and the two CLIs print the same ids for the same
artifact."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pt2tpu import cli as jcli
from pt2tpu.models import registry as jreg
from pt2tpu.serve.generate import _auto_prefill_chunk as j_auto_prefill_chunk
from pt2tpu.serve.generate import generate as jgenerate
from pt2tpu.utils import checkpoint as jckpt
from pt2tpu.utils import randmodel as jrand
from pt2tpu_torch import cli as tcli
from pt2tpu_torch.models.registry import get_config
from pt2tpu_torch.serve import generate as tgen
from pt2tpu_torch.utils.checkpoint import params_from_numpy


def to_port(tree):
    flat, structure = {}, {}
    jckpt._flatten("", tree, flat, structure)
    return params_from_numpy(structure, {k: np.asarray(v) for k, v in flat.items()}, "cpu")


CASES = [
    # (config, layout, batch, prompt len, max_new, prefill_chunk, impl)
    ("tiny-llama", "down", 1, 7, 8, None, "auto"),
    ("tiny-llama", "down", 3, 7, 8, None, "auto"),
    ("tiny-llama-gqa", "ssr", 3, 10, 6, 4, "auto"),  # chunked: 4 + 4 + 2
    ("tiny-llama-gqa", "down", 1, 8, 6, 4, "auto"),  # chunked: 4 + 4
    ("tiny-llama", "down", 3, 6, 6, None, "a8"),
    ("tiny-gemma", "ssr", 3, 7, 8, None, "auto"),
    ("tiny-gemma", "down", 2, 10, 6, 4, "auto"),  # chunked: 4 + 4 + 2
    ("tiny-gemma", "down", 2, 6, 6, None, "a8"),
]


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(map(str, c)))
def test_greedy_tokens_identical(case):
    name, layout, B, Lp, max_new, chunk, impl = case
    jcfg = jreg.get_config(name)
    params = jrand.random_ternary_params(
        jcfg, jax.random.PRNGKey(B * 10 + Lp), dtype=jnp.float32, perm_mode=layout
    )
    prompt = np.random.default_rng(Lp).integers(0, jcfg.vocab_size, size=(B, Lp)).astype(np.int32)
    want = np.asarray(jgenerate(
        jcfg, params, jnp.asarray(prompt), max_new, impl="xla" if impl == "auto" else impl,
        prefill_chunk=chunk,
    ))
    got = tgen.greedy_generate(
        get_config(name), to_port(params), torch.from_numpy(prompt), max_new,
        impl=impl, prefill_chunk=chunk,
    )
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_auto_prefill_chunk_rule_matches():
    cfg = jreg.get_config("llama-2-7b")
    for B, Lp, M in [(1, 128, 160), (4, 128, 160), (8, 1024, 1088), (2, 4000, 4100)]:
        assert tgen._auto_prefill_chunk(cfg, B, Lp, M) == j_auto_prefill_chunk(cfg, B, Lp, M)


def test_cli_prints_same_ids(tmp_path, capsys):
    cfg = jreg.get_config("tiny-llama")
    params = jrand.random_ternary_params(cfg, jax.random.PRNGKey(7), perm_mode="down")
    jckpt.save_model(str(tmp_path), cfg, params)
    argv = ["generate", "--model", str(tmp_path), "--prompt-ids", "5,17,3,99", "--max-new", "6"]
    jcli.main(argv)
    want = capsys.readouterr().out.strip().splitlines()[-1]
    tcli.main(argv + ["--device", "cpu"])
    got = capsys.readouterr().out.strip().splitlines()[-1]
    assert got == want
    assert len(got.split(",")) == 6


def test_cli_gemma_artifact(tmp_path, capsys):
    """A gemma artifact written by JAX: both CLIs print the same ids, and
    ``info`` names the family."""
    cfg = jreg.get_config("tiny-gemma")
    params = jrand.random_ternary_params(cfg, jax.random.PRNGKey(8), perm_mode="ssr")
    jckpt.save_model(str(tmp_path), cfg, params)
    argv = ["generate", "--model", str(tmp_path), "--prompt-ids", "9,200,3,41,7", "--max-new", "5"]
    jcli.main(argv)
    want = capsys.readouterr().out.strip().splitlines()[-1]
    tcli.main(argv + ["--device", "cpu"])
    assert capsys.readouterr().out.strip().splitlines()[-1] == want
    tcli.main(["info", "--model", str(tmp_path)])
    info = capsys.readouterr().out
    assert '"family": "gemma"' in info and '"act": "gelu"' in info
