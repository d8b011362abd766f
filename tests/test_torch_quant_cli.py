"""The port's CLI end to end on the CPU: ``quantize --model tiny-llama
--calib synthetic`` (random dense weights from --seed, calibration, the
packed artifact with its journal and metrics), then ``eval`` and
``generate`` over the artifact; the JAX package's CLI generates the same ids
from it. A local HuggingFace directory (a tiny llama that ``transformers``
writes): ``quantize`` in the port and in JAX write the same artifact bytes,
``info`` prints its config, ``generate`` and ``eval`` read it; the 4 GiB
residency rule is JAX's; a directory without a checkpoint raises; a tiny
mixtral checkpoint quantizes to JAX's artifact bytes."""

import json
import os

import numpy as np
import pytest
import torch

from pt2tpu import cli as jcli
from pt2tpu_torch import cli as tcli


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_quantize_eval_generate(tmp_path, capsys):
    out = str(tmp_path / "art")
    tcli.main(["quantize", "--model", "tiny-llama", "--calib", "synthetic", "--num_samples", "4",
               "--seq_len", "32", "--output", out, "--device", "cpu", "--seed", "3", "--eval",
               "--eval_dataset", "synthetic", "--max_windows", "2"])
    text = capsys.readouterr().out
    assert "calibration: synthetic[requested] (4, 32)" in text
    assert "bits/weight" in text and "perplexity [synthetic[requested]]" in text
    with open(os.path.join(out, "manifest.json")) as f:
        man = json.load(f)
    assert man["quant_config"]["ssr_scope"] == "auto" and man["quant_config"]["block_size"] == 128
    assert man["report"]["provenance"] == {"model": "random-init",
                                           "calibration": "synthetic[requested]"}
    assert len(man["report"]["layers"]) == 2 and man["report"]["bits_per_weight"] > 2
    assert sorted(os.listdir(os.path.join(out, "layers"))) == [
        "0000.json", "0000.npz", "0001.json", "0001.npz"]
    with open(os.path.join(out, "quantize_metrics.jsonl")) as f:
        events = [json.loads(line)["event"] for line in f]
    assert events.count("layer_quantized") == 8 and events[-1] == "model_quantized"

    tcli.main(["eval", "--model", out, "--eval_dataset", "synthetic", "--seq_len", "32",
               "--max_windows", "3", "--device", "cpu"])
    ppl = capsys.readouterr().out
    assert "perplexity [synthetic[requested]]" in ppl and "over 93 tokens" in ppl

    argv = ["generate", "--model", out, "--prompt-ids", "5,17,3,99", "--max-new", "6"]
    tcli.main(argv + ["--device", "cpu"])
    got = capsys.readouterr().out.strip().splitlines()[-1]
    jcli.main(argv)
    assert capsys.readouterr().out.strip().splitlines()[-1] == got
    assert len(got.split(",")) == 6

    # a second quantize into the same directory resumes from the journal
    tcli.main(["quantize", "--model", "tiny-llama", "--calib", "synthetic", "--num_samples", "4",
               "--seq_len", "32", "--output", out, "--device", "cpu", "--seed", "3"])
    capsys.readouterr()
    with open(os.path.join(out, "quantize_metrics.jsonl")) as f:
        assert any(json.loads(line)["event"] == "resume_from_journal" for line in f)


def test_registry_model_and_refusals(tmp_path, capsys):
    """A registry name is a random dense model (eval, generate; tiny-moe's
    too); a directory without a manifest is read as an HF checkpoint: one
    without its files raises; a mixture-of-experts one quantizes in the port
    as in JAX, to the same artifact bytes, and generates JAX's ids."""
    tcli.main(["eval", "--model", "tiny-llama", "--eval_dataset", "synthetic", "--seq_len", "16",
               "--max_windows", "1", "--device", "cpu"])
    assert "over 15 tokens" in capsys.readouterr().out
    tcli.main(["generate", "--model", "tiny-gemma", "--prompt-ids", "1,2", "--max-new", "3",
               "--device", "cpu"])
    assert len(capsys.readouterr().out.strip().splitlines()[-1].split(",")) == 3
    with pytest.raises(FileNotFoundError):
        tcli.main(["quantize", "--model", str(tmp_path), "--device", "cpu"])
    tcli.main(["generate", "--model", "tiny-moe", "--prompt-ids", "1,2", "--max-new", "3",
               "--device", "cpu"])
    assert len(capsys.readouterr().out.strip().splitlines()[-1].split(",")) == 3
    tcli.main(["eval", "--model", "tiny-moe", "--eval_dataset", "synthetic", "--seq_len", "16",
               "--max_windows", "1", "--device", "cpu"])
    assert "over 15 tokens" in capsys.readouterr().out
    transformers = pytest.importorskip("transformers")
    torch.manual_seed(1)
    c = transformers.MixtralConfig(vocab_size=99, hidden_size=32, intermediate_size=64,
                                   num_hidden_layers=1, num_attention_heads=4,
                                   num_key_value_heads=2, num_local_experts=4,
                                   max_position_embeddings=64)
    moe = str(tmp_path / "moe")
    transformers.MixtralForCausalLM(c).save_pretrained(moe)
    tcli.main(["info", "--model", moe])
    assert json.loads(capsys.readouterr().out)["model_config"]["n_experts"] == 4
    common = ["quantize", "--model", moe, "--calib", "synthetic", "--num_samples", "8",
              "--seq_len", "32", "--seed", "5"]
    tout, jout = str(tmp_path / "port"), str(tmp_path / "jax")
    tcli.main(common + ["--output", tout, "--device", "cpu"])
    text = capsys.readouterr().out
    assert "[hf]" in text and "bits/weight" in text
    jcli.main(common + ["--output", jout])
    capsys.readouterr()
    want, got = _npz(os.path.join(jout, "arrays.npz")), _npz(os.path.join(tout, "arrays.npz"))
    assert sorted(got) == sorted(want)
    for k in want:
        if k != "__bf16_keys__":
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    with open(os.path.join(tout, "manifest.json")) as f:
        tman = json.load(f)
    with open(os.path.join(jout, "manifest.json")) as f:
        jman = json.load(f)
    assert tman["structure"] == jman["structure"]
    assert tman["structure"]["layers.gateup"]["kind"] == "ternary"
    argv = ["generate", "--model", tout, "--prompt-ids", "5,17,3", "--max-new", "4"]
    tcli.main(argv + ["--device", "cpu"])
    got_ids = capsys.readouterr().out.strip().splitlines()[-1]
    jcli.main(argv)
    assert capsys.readouterr().out.strip().splitlines()[-1] == got_ids


def _npz(path):
    with np.load(path, allow_pickle=True) as z:
        return {k: z[k] for k in z.files}


def test_hf_directory_quantize_equals_jax(tmp_path, capsys):
    transformers = pytest.importorskip("transformers")
    torch.manual_seed(0)
    c = transformers.LlamaConfig(vocab_size=99, hidden_size=32, intermediate_size=64,
                                 num_hidden_layers=2, num_attention_heads=4,
                                 num_key_value_heads=2, max_position_embeddings=64,
                                 tie_word_embeddings=False)
    hf = str(tmp_path / "hf")
    transformers.LlamaForCausalLM(c).save_pretrained(hf)
    tcli.main(["info", "--model", hf])
    info = json.loads(capsys.readouterr().out)
    assert info["model_config"]["dim"] == 32 and info["model_config"]["n_layers"] == 2
    assert info["checkpoint_bytes"] > 0
    common = ["quantize", "--model", hf, "--calib", "synthetic", "--num_samples", "4",
              "--seq_len", "32", "--seed", "5"]
    tout, jout = str(tmp_path / "port"), str(tmp_path / "jax")
    tcli.main(common + ["--output", tout, "--device", "cpu"])
    assert "[hf]" in capsys.readouterr().out
    jcli.main(common + ["--output", jout])
    capsys.readouterr()
    want, got = _npz(os.path.join(jout, "arrays.npz")), _npz(os.path.join(tout, "arrays.npz"))
    assert sorted(got) == sorted(want)
    for k in want:
        if k != "__bf16_keys__":
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert sorted(got["__bf16_keys__"].tolist()) == sorted(want["__bf16_keys__"].tolist())
    with open(os.path.join(tout, "manifest.json")) as f:
        tman = json.load(f)
    with open(os.path.join(jout, "manifest.json")) as f:
        jman = json.load(f)
    assert tman["structure"] == jman["structure"]
    assert tman["model_config"] == jman["model_config"]
    assert tman["report"]["provenance"] == jman["report"]["provenance"]
    argv = ["generate", "--model", hf, "--prompt-ids", "5,17,3", "--max-new", "4"]
    tcli.main(argv + ["--device", "cpu"])
    got_ids = capsys.readouterr().out.strip().splitlines()[-1]
    jcli.main(argv)
    assert capsys.readouterr().out.strip().splitlines()[-1] == got_ids
    tcli.main(["eval", "--model", hf, "--eval_dataset", "synthetic", "--seq_len", "16",
               "--max_windows", "1", "--device", "cpu"])
    assert "over 15 tokens" in capsys.readouterr().out


def test_residency_rule_is_jax_s():
    """More than 4 GiB of weight files loads on the host when the run is on
    the card; on the CPU everything is host memory anyway."""
    big, small = (4 << 30) + 1, 4 << 30
    assert tcli.host_resident(big, torch.device("cuda"))
    assert not tcli.host_resident(small, torch.device("cuda"))
    assert not tcli.host_resident(big, torch.device("cpu"))
