"""gemma3-4b at its full width over 8 layers, the port against the JAX
package on the CPU: JAX's random packed weights ("down" layout, seed 24)
carried into the port, the vocabulary cut to 16384 rows (the rest of the
model at its published widths: D 2560, 8 heads and 4 KV heads of 256, I
10240, the window and RoPE bases of the registry), 128 random ids.

- f32: the port's logits within 1e-4 of max|logit| of JAX's (the same math
  in another summation order).
- bf16: each package's bf16 logits sit at a relative L2 distance from its
  own f32 logits, and the port's distance lies within 10 % of JAX's. With
  random weights this drift grows with depth (its norms multiply by 1 + 1,
  so attention is near hard-max and a bf16 rounding can move a pick), and
  it belongs to the model: JAX's own bf16 route leaves its f32 logits by
  more than 0.05 here. On the card, chip_smoke.py holds the 34-layer
  engine's answers to that drift's reach for the same reason.

Torch runs on one intra-op thread, as in the engine tests."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pt2tpu.models import decoder as jdec
from pt2tpu.models import registry as jreg
from pt2tpu.utils import randmodel as jrand
from pt2tpu_torch.models import decoder as tdec
from pt2tpu_torch.models import registry as treg
from test_torch_families import to_port

LOGIT_TOL = 1e-4  # of max|logit|
DRIFT_REL_TOL = 0.1  # the port's bf16 drift vs JAX's
DRIFT_FLOOR = 0.05  # JAX's own bf16 drift at this depth is at least this
GEMMA3_CUT = dict(n_layers=8, vocab_size=16384)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel_l2(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def test_gemma3_4b_full_width_drift_matches_jax():
    jcfg = jreg.get_config("gemma3-4b").with_(**GEMMA3_CUT)
    tcfg = treg.get_config("gemma3-4b").with_(**GEMMA3_CUT)
    jp = jrand.random_ternary_params(jcfg, jax.random.PRNGKey(24), perm_mode="down")
    jp32 = jax.tree_util.tree_map(
        lambda a: a.astype(jnp.float32) if getattr(a, "dtype", None) == jnp.bfloat16 else a, jp)
    toks = np.random.default_rng(0).integers(0, jcfg.vocab_size, (1, 128)).astype(np.int32)

    j_bf16, j_f32 = (np.asarray(jdec.forward(jcfg, p, jnp.asarray(toks)), np.float32)[0]
                     for p in (jp, jp32))
    tp = to_port(jp)
    tp32 = tdec._map(lambda t: t.float() if t.dtype == torch.bfloat16 else t, tp)
    with torch.inference_mode():
        t_bf16, t_f32 = (tdec.forward(tcfg, p, torch.from_numpy(toks).long(), impl="plain")[0]
                         .float().numpy() for p in (tp, tp32))

    f32_gap = np.abs(t_f32 - j_f32).max() / np.abs(j_f32).max()
    d_jax, d_port = _rel_l2(j_bf16, j_f32), _rel_l2(t_bf16, t_f32)
    print(f"gemma3-4b, 8 layers at full width: f32 logits {f32_gap:.3e} of max|logit| from "
          f"JAX's; bf16 vs f32 relative L2 JAX {d_jax:.4f}, port {d_port:.4f}")
    assert f32_gap <= LOGIT_TOL
    assert d_jax > DRIFT_FLOOR, d_jax
    assert abs(d_port - d_jax) <= DRIFT_REL_TOL * d_jax, (d_port, d_jax)
