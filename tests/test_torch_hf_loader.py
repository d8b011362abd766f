"""The port's HuggingFace loader (``pt2tpu_torch.models.hf_loader``) against
``pt2tpu.models.hf_loader`` on tiny checkpoints that ``transformers`` writes
(random weights, CPU, f32 unless stated).

For every dense family of tests/test_hf_parity.py (llama, llama-3.1's rope
scaling, opt, gpt2, bloom, gemma, qwen3, gemma2, gemma3) and qwen2 (q/k/v
bias): ``config_from_hf`` equals JAX's field for field; every tensor of the
parameter tree equals JAX's exactly (bloom's per-head q/k/v de-interleaved,
gpt2's Conv1D weights transposed), with the same keys; ``forward``'s
logits equal JAX's ``load_hf_model`` logits within 1e-5 of max|logit| (f32
summation order).

The reader: the port's own safetensors reader gives the bytes of the
``safetensors`` package's reader for f32, bf16, f16 and i64 tensors (JAX's
numpy reader takes no bf16), a bf16 checkpoint loads as the bf16 rounding
of the f32 one (the JAX loader's values for it), sharded files and
``pytorch_model.bin`` files load like one safetensors file, ``device="cpu"``
keeps the model on the host. The mixture-of-experts layouts (mixtral,
qwen3-moe): configs, routers and expert stacks equal JAX's, logits JAX's and
transformers' own (within 1e-4 of max|logit|), and ``write_safetensors``
writes both layouts back."""

import dataclasses
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pt2tpu.models import decoder as jdec
from pt2tpu.models import hf_loader as jhf
from pt2tpu.utils import checkpoint as jckpt
from pt2tpu_torch.models import decoder as tdec
from pt2tpu_torch.models import hf_loader as thf
from pt2tpu_torch.utils import checkpoint as tckpt

transformers = pytest.importorskip("transformers")
safetensors_torch = pytest.importorskip("safetensors.torch")

LOGIT_TOL = 1e-5  # of max|logit|


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tiny(kind):
    """A tiny random HF model of each family (the configs of
    tests/test_hf_parity.py)."""
    T = transformers
    torch.manual_seed(len(kind))
    if kind == "llama":
        c = T.LlamaConfig(vocab_size=99, hidden_size=32, intermediate_size=64,
                          num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
                          max_position_embeddings=64, tie_word_embeddings=False)
        return T.LlamaForCausalLM(c)
    if kind == "llama31":
        c = T.LlamaConfig(vocab_size=99, hidden_size=32, intermediate_size=64,
                          num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
                          max_position_embeddings=64, tie_word_embeddings=False,
                          rope_theta=500000.0,
                          rope_scaling={"rope_type": "llama3", "factor": 8.0,
                                        "low_freq_factor": 1.0, "high_freq_factor": 4.0,
                                        "original_max_position_embeddings": 16})
        return T.LlamaForCausalLM(c)
    if kind == "qwen2":
        c = T.Qwen2Config(vocab_size=99, hidden_size=32, intermediate_size=64,
                          num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
                          max_position_embeddings=64, tie_word_embeddings=False)
        return T.Qwen2ForCausalLM(c)
    if kind == "opt":
        c = T.OPTConfig(vocab_size=99, hidden_size=32, ffn_dim=64, num_hidden_layers=2,
                        num_attention_heads=4, max_position_embeddings=64,
                        do_layer_norm_before=True, word_embed_proj_dim=32)
        return T.OPTForCausalLM(c)
    if kind == "gpt2":
        return T.GPT2LMHeadModel(T.GPT2Config(vocab_size=99, n_embd=32, n_layer=2, n_head=4,
                                              n_positions=64))
    if kind == "bloom":
        return T.BloomForCausalLM(T.BloomConfig(vocab_size=99, hidden_size=32, n_layer=2,
                                                n_head=4))
    if kind == "gemma":
        c = T.GemmaConfig(vocab_size=99, hidden_size=32, intermediate_size=64,
                          num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=4,
                          head_dim=8, max_position_embeddings=64)
        return T.GemmaForCausalLM(c)
    if kind == "qwen3":
        c = T.Qwen3Config(vocab_size=99, hidden_size=32, intermediate_size=64,
                          num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
                          head_dim=8, max_position_embeddings=64, tie_word_embeddings=False)
        return T.Qwen3ForCausalLM(c)
    if kind == "gemma2":
        c = T.Gemma2Config(vocab_size=99, hidden_size=32, intermediate_size=64,
                           num_hidden_layers=4, num_attention_heads=4, num_key_value_heads=2,
                           head_dim=8, max_position_embeddings=64, sliding_window=4,
                           query_pre_attn_scalar=8, attn_logit_softcapping=50.0,
                           final_logit_softcapping=30.0)
        return T.Gemma2ForCausalLM(c)
    if kind == "gemma3":
        c = T.Gemma3TextConfig(vocab_size=99, hidden_size=32, intermediate_size=64,
                               num_hidden_layers=4, num_attention_heads=4, num_key_value_heads=2,
                               head_dim=8, max_position_embeddings=64, sliding_window=4,
                               sliding_window_pattern=2, query_pre_attn_scalar=8,
                               rope_theta=1000000.0, rope_local_base_freq=10000.0,
                               rope_scaling={"rope_type": "linear", "factor": 8.0})
        return T.Gemma3ForCausalLM(c)
    if kind == "mixtral":
        c = T.MixtralConfig(vocab_size=99, hidden_size=32, intermediate_size=64,
                            num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
                            num_local_experts=4, num_experts_per_tok=2,
                            max_position_embeddings=64)
        return T.MixtralForCausalLM(c)
    if kind == "qwen3_moe":
        c = T.Qwen3MoeConfig(vocab_size=99, hidden_size=32, intermediate_size=64,
                             moe_intermediate_size=48, num_experts=4, num_experts_per_tok=2,
                             num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
                             head_dim=8, max_position_embeddings=64, tie_word_embeddings=False)
        return T.Qwen3MoeForCausalLM(c)
    raise KeyError(kind)


KINDS = ("llama", "llama31", "qwen2", "opt", "gpt2", "bloom", "gemma", "qwen3", "gemma2",
         "gemma3")


def _save(model, d, **kw):
    model.eval()
    model.save_pretrained(str(d), **kw)
    return str(d)


def _flat_jax(tree):
    flat, structure = {}, {}
    jckpt._flatten("", tree, flat, structure)
    return {k: np.asarray(v, np.float32) for k, v in flat.items()}, structure


def _flat_port(tree):
    flat, structure = {}, {}
    tckpt._flatten("", tree, flat, structure)
    return {k: v.float().numpy() for k, v in flat.items()}, structure


def _same_tree(tparams, jparams):
    ft, st = _flat_port(tparams)
    fj, sj = _flat_jax(jparams)
    assert st == sj  # the same keys, kinds and biases
    assert ft.keys() == fj.keys()
    for k in fj:
        np.testing.assert_array_equal(ft[k], fj[k], err_msg=k)


def _logits_equal(tcfg, tparams, jcfg, jparams):
    toks = np.random.default_rng(0).integers(0, jcfg.vocab_size, size=(2, 9))
    want = np.asarray(jdec.forward(jcfg, jparams, jnp.asarray(toks, jnp.int32), impl="xla"))
    got = tdec.forward(tcfg, tparams, torch.from_numpy(toks)).numpy()
    assert np.abs(got - want).max() <= LOGIT_TOL * np.abs(want).max()
    return got, toks


@pytest.mark.parametrize("kind", KINDS)
def test_config_tensors_and_logits_equal_jax(kind, tmp_path):
    model = _tiny(kind)
    d = _save(model, tmp_path / "ckpt", safe_serialization=True)
    assert dataclasses.asdict(thf.config_from_hf(d)) == dataclasses.asdict(jhf.config_from_hf(d))
    jcfg, jparams = jhf.load_hf_model(d, dtype=jnp.float32)
    tcfg, tparams = thf.load_hf_model(d, dtype=torch.float32, device="cpu")
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    _same_tree(tparams, jparams)
    got, toks = _logits_equal(tcfg, tparams, jcfg, jparams)
    if kind in ("llama", "qwen2", "bloom", "gemma", "qwen3", "gemma2", "gemma3"):
        # and transformers' own logits (opt and gpt2 differ there in the JAX
        # package too; tests/test_hf_parity.py holds their log-softmax)
        with torch.no_grad():
            hf = model(torch.from_numpy(toks)).logits.float().numpy()
        assert np.abs(got - hf).max() <= 1e-4 * np.abs(hf).max()


@pytest.mark.parametrize("kind", ["llama", "bloom", "gpt2"])
def test_shards_and_bin_files_load_alike(kind, tmp_path):
    model = _tiny(kind)
    one = _save(model, tmp_path / "one", safe_serialization=True)
    shards = _save(model, tmp_path / "shards", safe_serialization=True, max_shard_size="20KB")
    assert len([f for f in os.listdir(shards) if f.endswith(".safetensors")]) > 1
    binary = _save(model, tmp_path / "bin", safe_serialization=False)
    assert any(f.startswith("pytorch_model") and f.endswith(".bin") for f in os.listdir(binary))
    _, want = thf.load_hf_model(one, dtype=torch.float32, device="cpu")
    for d in (shards, binary):
        tcfg, got = thf.load_hf_model(d, dtype=torch.float32, device="cpu")
        assert _flat_port(got)[1] == _flat_port(want)[1]
        for k, v in _flat_port(want)[0].items():
            np.testing.assert_array_equal(_flat_port(got)[0][k], v, err_msg=k)
    jcfg, jparams = jhf.load_hf_model(binary, dtype=jnp.float32)
    _same_tree(got, jparams)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16, torch.int64])
def test_reader_gives_the_safetensors_bytes(dtype, tmp_path):
    g = torch.Generator().manual_seed(3)
    tensors = {
        "w": (torch.randn((17, 5), generator=g) * 3).to(dtype) if dtype != torch.int64
        else torch.randint(-(2**40), 2**40, (17, 5), generator=g),
        "v": torch.arange(7).to(dtype),
        "s": torch.ones(()).to(dtype),
        "e": torch.zeros((0, 3)).to(dtype),
    }
    path = str(tmp_path / "x.safetensors")
    safetensors_torch.save_file(tensors, path, metadata={"format": "pt"})
    got = thf.read_safetensors(path)
    want = safetensors_torch.load_file(path)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape
        assert torch.equal(got[k], want[k]), k


def test_writer_gives_files_the_safetensors_package_reads(tmp_path):
    """write_safetensors (what the card machine, which lacks the package,
    writes its test checkpoints with) against the package's own reader."""
    g = torch.Generator().manual_seed(4)
    tensors = {"a.weight": torch.randn((33, 8), generator=g).bfloat16(),
               "b": torch.randn((5,), generator=g), "c": torch.arange(6).reshape(2, 3),
               "d": torch.randn((2, 2), generator=g).half(), "e": torch.zeros((0,))}
    path = str(tmp_path / "w.safetensors")
    thf.write_safetensors(path, tensors)
    got = safetensors_torch.load_file(path)
    assert got.keys() == tensors.keys()
    for k, t in tensors.items():
        assert got[k].dtype == t.dtype and torch.equal(got[k], t), k
    back = thf.read_safetensors(path)
    assert all(torch.equal(back[k], t) for k, t in tensors.items())


@pytest.mark.parametrize("kind", ["qwen3", "gpt2"])
def test_bf16_checkpoint_is_the_rounded_f32_one(kind, tmp_path):
    """A bf16 checkpoint loads as the bf16 rounding of the f32 weights: the
    JAX loader's tensors and logits on the same (rounded) weights written
    in f32."""
    model = _tiny(kind)
    bf = _save(model.to(torch.bfloat16), tmp_path / "bf16", safe_serialization=True)
    st = [f for f in os.listdir(bf) if f.endswith(".safetensors")]
    with open(os.path.join(bf, st[0]), "rb") as f:  # the file really holds bf16
        header = json.loads(f.read(int.from_bytes(f.read(8), "little")))
    assert {v["dtype"] for k, v in header.items() if k != "__metadata__"} == {"BF16"}
    f32 = _save(model.to(torch.float32), tmp_path / "f32", safe_serialization=True)
    tcfg, tparams = thf.load_hf_model(bf, dtype=torch.float32, device="cpu")
    jcfg, jparams = jhf.load_hf_model(f32, dtype=jnp.float32)
    _same_tree(tparams, jparams)
    _logits_equal(tcfg, tparams, jcfg, jparams)
    # loaded as bf16, the leaves are the same values
    _, bparams = thf.load_hf_model(bf, device="cpu")
    assert bparams["embed"].dtype == torch.bfloat16
    assert torch.equal(bparams["embed"].float(), tparams["embed"])


def test_moe_checkpoint_raises_naming_it(tmp_path):
    """The tiny mixtral checkpoint (what raised before the mixture-of-experts
    slice) loads: its config, router and (E, out, in) expert stacks equal
    JAX's loader's, and its logits JAX's and transformers' own."""
    _moe_loads_equal("mixtral", tmp_path)


def _moe_loads_equal(kind, tmp_path):
    model = _tiny(kind)
    d = _save(model, tmp_path / kind, safe_serialization=True)
    assert dataclasses.asdict(thf.config_from_hf(d)) == dataclasses.asdict(jhf.config_from_hf(d))
    jcfg, jparams = jhf.load_hf_model(d, dtype=jnp.float32)
    tcfg, tparams = thf.load_hf_model(d, dtype=torch.float32, device="cpu")
    assert tcfg.is_moe and tcfg.n_experts == 4
    lay = tparams["layers"]
    assert lay["router"].w.shape == (2, 4, 32)
    assert lay["gate"].w.shape == lay["up"].w.shape == (2, 4, tcfg.expert_inter, 32)
    assert lay["down"].w.shape == (2, 4, 32, tcfg.expert_inter)
    _same_tree(tparams, jparams)
    got, toks = _logits_equal(tcfg, tparams, jcfg, jparams)
    with torch.no_grad():
        hf = model(torch.from_numpy(toks)).logits.float().numpy()
    assert np.abs(got - hf).max() <= 1e-4 * np.abs(hf).max()
    return d, tparams


@pytest.mark.parametrize("kind", ["mixtral", "qwen3_moe"])
def test_moe_checkpoints_load_and_write(kind, tmp_path):
    """Both expert layouts (mixtral's ``block_sparse_moe.experts.N.w1/w3/w2``,
    qwen3-moe's ``mlp.experts.N.{gate,up,down}_proj``) load equal to JAX's
    loader, and written back with ``write_safetensors`` load the same tree."""
    d, tparams = _moe_loads_equal(kind, tmp_path)
    tensors = thf.read_hf_tensors(d)
    assert any(".experts.3." in k for k in tensors)
    out = tmp_path / "rewritten"
    out.mkdir()
    thf.write_safetensors(str(out / "model.safetensors"), tensors)
    with open(os.path.join(d, "config.json")) as f:
        (out / "config.json").write_text(f.read())
    _, again = thf.load_hf_model(str(out), dtype=torch.float32, device="cpu")
    a, b = _flat_port(tparams), _flat_port(again)
    assert a[1] == b[1]
    for k, v in a[0].items():
        np.testing.assert_array_equal(b[0][k], v, err_msg=k)


def test_hf_loader_imports_no_safetensors_or_transformers():
    """The card machine has neither package: the loader reads files itself."""
    import ast

    with open(thf.__file__) as f:
        tree = ast.parse(f.read())
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names]
    names += [n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom) and n.module]
    assert not [m for m in names if m.split(".")[0] in ("safetensors", "transformers")]
