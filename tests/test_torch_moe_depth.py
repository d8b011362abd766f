"""mixtral-8x7b's random model drifts in bf16, in the JAX package as in the
port (CPU): the port's random packed weights ("down" layout) carried into
JAX through an artifact, mixtral's attention and router at their published
widths (D 4096, 32 heads and 8 KV heads of 128, 8 experts, 2 a token), the
experts' width cut to MOE_CUT's 1024 (from 14336), the vocabulary to 4096
rows and the depth to 4 layers; 2 sequences of 96 random ids.

- f32: the port's logits within 1e-4 of max|logit| of JAX's, and the same
  experts picked for every token in every layer (no routing margin of
  these ids is below 1e-5, tests/test_torch_moe.py's near-tie rule).
- bf16: the noise that each package's bf16 route puts into the first
  layer's router logits (their relative L2 distance from its own f32
  route's) is the same within NOISE_REL_TOL; from there each bf16 route
  picks other experts than its own f32 route for some (layer, token) pairs
  ("flips": the noise moves a router's k-th and (k+1)-th weights past each
  other, and a flipped expert moves the token's state by a whole expert's
  output), and its logits leave its own f32 logits. JAX flips too and
  drifts by more than DRIFT_FLOOR: the drift belongs to the model. The flip
  counts are printed, not compared: they are few and discrete (over single
  sequences of other seeds the two packages counted 0 / 5, 6 / 5, 5 / 4,
  37 / 39). On the card, chip_smoke.py
  holds mixtral's 32-layer answers to that drift's reach
  (MIXTRAL_DEEP_TOL) and a 2-layer cut to TOKEN_TOL.

Torch runs on one intra-op thread, as in the engine tests."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pt2tpu.models import decoder as jdec
from pt2tpu.models import registry as jreg
from pt2tpu.utils import checkpoint as jckpt
from pt2tpu_torch.models import decoder as tdec
from pt2tpu_torch.models import registry as treg
from pt2tpu_torch.utils import checkpoint as tckpt
from pt2tpu_torch.utils.randmodel import random_ternary_params

LOGIT_TOL = 1e-4  # of max|logit|
NEAR_TIE = 1e-5
NOISE_REL_TOL = 0.1  # the port's bf16 noise in the router logits vs JAX's
DRIFT_FLOOR = 0.01  # JAX's own bf16 drift here is at least this
MOE_CUT = dict(n_layers=4, vocab_size=4096, moe_inter=1024)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel_l2(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _jax_run(cfg, params, toks):
    """(f32 logits, (layers, B, T, E) routing sets, layer 0's f32 router
    logits) of JAX's plain route."""
    B, T = toks.shape
    h = jdec.embed_tokens(cfg, params, jnp.asarray(toks))
    cos, sin, _, _ = jdec.pos_tables(cfg, T)
    mask = jdec.build_mask(cfg, T, T)
    sets = []
    for li in range(cfg.n_layers):
        lp = jdec.layer_slice(params["layers"], li)
        h, io = jdec.layer_forward(cfg, lp, h, cos, sin, mask, impl="xla", layer_idx=li,
                                   return_taps=True)
        sets.append(np.asarray(io.taps["moe_w"]) > 0)
        if li == 0:
            router = (np.asarray(io.taps["mlp_in"], np.float32)
                      @ np.asarray(lp["router"].w, np.float32).T)
    return np.asarray(jdec.unembed(cfg, params, h), np.float32), np.stack(sets), router


def _port_run(cfg, params, toks):
    """(f32 logits, routing sets, layer 0's f32 router logits, smallest
    routing margin) of the port's plain route."""
    B, T = toks.shape
    k = cfg.experts_per_token
    with torch.inference_mode():
        h = tdec.embed_tokens(cfg, params, torch.from_numpy(toks).long())
        cos, sin, _, _ = tdec.pos_tables(cfg, T)
        mask = tdec.build_mask(cfg, T, T)
        sets, margin = [], float("inf")
        for li in range(cfg.n_layers):
            lp = tdec.layer_view(params["layers"], li)
            h, io = tdec.layer_forward(cfg, lp, h, cos, sin, mask, impl="plain", layer_idx=li,
                                       return_taps=True)
            sets.append(io.taps["moe_w"].numpy() > 0)
            logits = io.taps["mlp_in"].float() @ lp["router"].w.t().float()
            router = logits.numpy() if li == 0 else router
            top = torch.softmax(logits, -1).sort(-1, descending=True).values
            margin = min(margin, float((top[..., k - 1] - top[..., k]).min()))
        return tdec.unembed(cfg, params, h).float().numpy(), np.stack(sets), router, margin


def _flips(a, b):
    return int((a != b).any(-1).sum())


def test_mixtral_drift_matches_jax(tmp_path):
    jcfg = jreg.get_config("mixtral-8x7b").with_(**MOE_CUT)
    tcfg = treg.get_config("mixtral-8x7b").with_(**MOE_CUT)
    tp = random_ternary_params(tcfg, seed=2, perm_mode="down", device="cpu")
    tckpt.save_model(str(tmp_path), tcfg, tp)
    _, jp = jckpt.load_model(str(tmp_path))
    jp32 = jax.tree_util.tree_map(
        lambda a: a.astype(jnp.float32) if getattr(a, "dtype", None) == jnp.bfloat16 else a, jp)
    tp32 = tdec._map(lambda t: t.float() if t.dtype == torch.bfloat16 else t, tp)
    toks = np.random.default_rng(2).integers(0, jcfg.vocab_size, (2, 96)).astype(np.int32)

    (j_bf16, j_sb, j_rb), (j_f32, j_sf, j_rf) = _jax_run(jcfg, jp, toks), _jax_run(jcfg, jp32,
                                                                                  toks)
    (t_bf16, t_sb, t_rb, _), (t_f32, t_sf, t_rf, margin) = (_port_run(tcfg, tp, toks),
                                                            _port_run(tcfg, tp32, toks))
    f32_gap = np.abs(t_f32 - j_f32).max() / np.abs(j_f32).max()
    n_jax, n_port = _rel_l2(j_rb, j_rf), _rel_l2(t_rb, t_rf)
    d_jax, d_port = _rel_l2(j_bf16, j_f32), _rel_l2(t_bf16, t_f32)
    f_jax, f_port = _flips(j_sb, j_sf), _flips(t_sb, t_sf)
    print(f"mixtral-8x7b, {tcfg.n_layers} layers, experts cut to {tcfg.expert_inter}, 2 x 96 ids: "
          f"f32 logits {f32_gap:.3e} of max|logit| from JAX's, {_flips(j_sf, t_sf)} f32 routing "
          f"differences (smallest margin {margin:.2e}); bf16 vs f32: layer 0's router logits "
          f"relative L2 JAX {n_jax:.4e}, port {n_port:.4e}; flips JAX {f_jax}, port {f_port}; "
          f"logits relative L2 JAX {d_jax:.4f}, port {d_port:.4f}")
    assert margin >= NEAR_TIE and _flips(j_sf, t_sf) == 0
    assert f32_gap <= LOGIT_TOL
    assert abs(n_port - n_jax) <= NOISE_REL_TOL * n_jax, (n_port, n_jax)
    assert d_jax > DRIFT_FLOOR and f_jax > 0 and f_port > 0, (d_jax, f_jax, f_port)
