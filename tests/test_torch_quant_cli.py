"""The port's CLI end to end on the CPU: ``quantize --model tiny-llama
--calib synthetic`` (random dense weights from --seed, calibration, the
packed artifact with its journal and metrics), then ``eval`` and
``generate`` over the artifact; the JAX package's CLI generates the same ids
from it. A local checkpoint directory raises (no HF loader in the port)."""

import json
import os

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
    """A registry name is a random dense model (eval, generate); a directory
    without a manifest needs the HF loader."""
    tcli.main(["eval", "--model", "tiny-llama", "--eval_dataset", "synthetic", "--seq_len", "16",
               "--max_windows", "1", "--device", "cpu"])
    assert "over 15 tokens" in capsys.readouterr().out
    tcli.main(["generate", "--model", "tiny-gemma", "--prompt-ids", "1,2", "--max-new", "3",
               "--device", "cpu"])
    assert len(capsys.readouterr().out.strip().splitlines()[-1].split(",")) == 3
    with pytest.raises(NotImplementedError, match="hf_loader"):
        tcli.main(["quantize", "--model", str(tmp_path), "--device", "cpu"])
