"""``pt2tpu_torch.utils.profiling`` and ``utils.debug`` against the JAX
package's ``pt2tpu.utils`` modules on the CPU.

- ``model_weight_bytes`` equals JAX's for every registry config (and the
  dense bf16 count too), ``ternary_decode_roofline`` at the same explicit
  ``hbm_gbps``; the port's default bandwidth is the H100 SXM's.
- ``nan_debug`` raises at a ``log(-1)``; ``assert_finite_tree`` names the
  bad paths as JAX's does; ``deterministic_mode`` restores the flags.
- ``trace`` writes a Chrome trace, ``time_fn`` returns a positive best time.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from pt2tpu.models import registry as jreg
from pt2tpu.utils import debug as jdebug
from pt2tpu.utils import profiling as jprof
from pt2tpu_torch.models import registry as treg
from pt2tpu_torch.utils import debug as tdebug
from pt2tpu_torch.utils import profiling as tprof


@pytest.mark.parametrize("name", sorted(treg.CONFIGS))
def test_model_weight_bytes_match_jax(name):
    cj, ct = jreg.get_config(name), treg.get_config(name)
    for ternary in (True, False):
        assert (tprof.model_weight_bytes(ct, ternary=ternary)
                == jprof.model_weight_bytes(cj, ternary=ternary))


@pytest.mark.parametrize("name", ["llama-2-7b", "llama-3-8b", "gemma-2b", "tiny-llama"])
@pytest.mark.parametrize("gbps", [819.0, 3350.0])
def test_roofline_matches_jax(name, gbps):
    want = jprof.ternary_decode_roofline(jreg.get_config(name), hbm_gbps=gbps)
    got = tprof.ternary_decode_roofline(treg.get_config(name), hbm_gbps=gbps)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-12)


def test_roofline_default_is_the_h100():
    cfg = treg.get_config("llama-3-8b")
    assert tprof.ternary_decode_roofline(cfg) == tprof.ternary_decode_roofline(cfg, 3350.0)
    assert tprof.H100_HBM_GBPS == 3350.0


def test_nan_debug_raises_at_the_op():
    x = torch.tensor([-1.0, 2.0])
    with pytest.raises(FloatingPointError, match="log"):
        with tdebug.nan_debug():
            torch.log(x)
    with tdebug.nan_debug():  # finite outputs pass
        y = torch.log(x.abs()) + 1
    assert torch.isfinite(y).all()
    assert torch.isnan(torch.log(x)).any()  # off again outside the context


@dataclasses.dataclass
class _Box:
    w: torch.Tensor
    codes: torch.Tensor


def test_assert_finite_tree_names_the_bad_path():
    tree = {"a": torch.ones(3), "layers": [{"w": torch.tensor([1.0, float("nan")])},
                                           _Box(torch.tensor([float("inf")]),
                                                torch.zeros(2, dtype=torch.int8))]}
    with pytest.raises(FloatingPointError) as e:
        tdebug.assert_finite_tree(tree, "params")
    msg = str(e.value)
    assert "params" in msg and "['layers'][0]['w']" in msg and "['layers'][1].w" in msg
    assert "['a']" not in msg and "codes" not in msg
    tdebug.assert_finite_tree({"a": torch.ones(2), "n": 3, "i": torch.arange(3)})
    # JAX's names the same leaves (its key strings)
    jtree = {"a": np.ones(3, np.float32), "w": np.array([np.nan], np.float32)}
    with pytest.raises(FloatingPointError, match=r"\['w'\]"):
        jdebug.assert_finite_tree(jtree, "params")
    with pytest.raises(FloatingPointError, match=r"\['w'\]"):
        tdebug.assert_finite_tree({k: torch.from_numpy(v) for k, v in jtree.items()}, "params")


def test_deterministic_mode_restores_the_flags():
    prev = torch.are_deterministic_algorithms_enabled()
    prev_ws = os.environ.get("CUBLAS_WORKSPACE_CONFIG")
    with tdebug.deterministic_mode():
        assert torch.are_deterministic_algorithms_enabled()
        assert os.environ["CUBLAS_WORKSPACE_CONFIG"] == ":4096:8"
    assert torch.are_deterministic_algorithms_enabled() == prev
    assert os.environ.get("CUBLAS_WORKSPACE_CONFIG") == prev_ws
    with pytest.raises(RuntimeError):
        with tdebug.deterministic_mode():
            raise RuntimeError("inside")
    assert torch.are_deterministic_algorithms_enabled() == prev


def test_trace_writes_a_chrome_trace(tmp_path):
    with tprof.trace(str(tmp_path)) as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    with open(tmp_path / "trace.json") as f:
        assert "traceEvents" in json.load(f)
    assert any("mm" in e.key for e in prof.key_averages())


def test_time_fn_best_of_reps():
    calls = []
    t = tprof.time_fn(lambda x: calls.append(1) or x * 2, torch.ones(8), reps=4)
    assert t > 0 and len(calls) == 5  # one warm-up and four timed
