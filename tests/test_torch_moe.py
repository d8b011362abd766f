"""The port's mixture-of-experts path against the JAX package on the CPU
(tiny-moe: dim 64, 2 layers, 4 experts, 2 per token), f32 compute.

- ``moe_router_weights``: the combine weights, top-k weights and picks of
  JAX's within 1e-6 (the same f32 softmax in another order), picks equal;
  with duplicated router rows (exact ties) the lower index comes first,
  as ``lax.top_k`` orders them, with and without ``norm_topk``.
- ``_moe_mlp``: both plans (one row: the top-k experts with device-index
  picks; more rows: every expert weighted) within 1e-5 of max|out| of
  JAX's, dense and packed experts.
- ``forward`` logits within 1e-4 of max|logit| (LOGIT_TOL), dense weights
  (JAX's ``init_params``) and packed ones (the port's ``random_ternary_params``
  in the "ssr" and "down" layouts, carried to JAX through an artifact).
  Near-tie rule: a row's logits are compared up to its first token whose
  routing margin (the k-th minus the (k+1)-th softmax weight, in any layer)
  is below NEAR_TIE; the excluded positions are counted and at most a few.
- ``greedy_generate`` tokens equal at batch 1 (the top-k plan at decode) and
  batch 2 (the all-experts plan), bf16 KV; ``ServeEngine`` tokens and finish
  order equal at quantum 1 and 4.
- Artifacts both ways: the port's written artifact read by JAX and written
  back gives the same bytes, key for key.
- ``random_ternary_params`` for tiny-moe ("ssr") has the leaf names, shapes,
  dtypes and flags of what JAX's ``quantize_model`` emits for tiny-moe (its
  default scope at dim 64 is full SSR); the dense leaves are bf16 in the
  random model, f32 in JAX's quantized f32 model.
- A device index (a 0-d int32 tensor) through ``ternary_linear_apply_stacked``
  gives exactly the host-index route's result on the CPU; the plain
  versions of K1s / K3s equal JAX's stacked Pallas kernels (scalar-prefetch
  index) in interpret mode within 1e-5 of max|ref|; ``linear_route`` names
  a device-index entry for every kernel of every route (K3s by default,
  K6s under P2, K4s or K5s then K1s with both fused routes off).

Torch runs on one intra-op thread, as in the engine tests."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from pt2tpu.core import packing as jpack
from pt2tpu.models import decoder as jdec
from pt2tpu.models import registry as jreg
from pt2tpu.ops.kernels import pallas_ternary as jpt
from pt2tpu.quant import pipeline as jpipe
from pt2tpu.serve.engine import ServeEngine as JEngine
from pt2tpu.serve.generate import greedy_generate as jgreedy
from pt2tpu.utils import checkpoint as jckpt
from pt2tpu_torch.models import decoder as tdec
from pt2tpu_torch.models.common import DenseLinear
from pt2tpu_torch.models.registry import get_config
from pt2tpu_torch.ops import gather as tgather
from pt2tpu_torch.ops import ternary_matmul as ttm
from pt2tpu_torch.ops.kernels import ternary as tk
from pt2tpu_torch.serve.engine import ServeEngine
from pt2tpu_torch.serve.generate import greedy_generate
from pt2tpu_torch.utils import checkpoint as tckpt
from pt2tpu_torch.utils.randmodel import random_ternary_params

NAME = "tiny-moe"
LOGIT_TOL = 1e-4  # of max|logit|
NEAR_TIE = 1e-5  # routing margin below which f32 ulps may swap the k-th expert
PIECE_TOL = 1e-6
MLP_TOL = 1e-5
REL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def to_port(tree):
    flat, structure = {}, {}
    jckpt._flatten("", tree, flat, structure)
    return tckpt.params_from_numpy(structure, {k: np.asarray(v) for k, v in flat.items()}, "cpu")


def _dense_f32(tree):
    """Every dense leaf in f32; packed linears keep their bf16 scales."""
    if isinstance(tree, dict):
        return {k: _dense_f32(v) for k, v in tree.items()}
    if isinstance(tree, DenseLinear):
        return DenseLinear(w=tree.w.float(), b=None if tree.b is None else tree.b.float())
    if isinstance(tree, torch.Tensor) and tree.is_floating_point():
        return tree.float()
    return tree


def _t(a):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


@pytest.fixture(scope="module")
def cfgs():
    return jreg.get_config(NAME), get_config(NAME)


@pytest.fixture(scope="module")
def dense(cfgs):
    jcfg, _ = cfgs
    jp = jdec.init_params(jcfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    return jp, to_port(jp)


@pytest.fixture(scope="module")
def packed(cfgs, tmp_path_factory):
    """The port's random packed tiny-moe in the "ssr" and "down" layouts
    (dense leaves in f32), each carried to JAX through an artifact."""
    _, tcfg = cfgs
    out = {}
    for i, layout in enumerate(("ssr", "down")):
        tp = _dense_f32(random_ternary_params(tcfg, seed=5 + i, perm_mode=layout, device="cpu"))
        d = str(tmp_path_factory.mktemp(f"moe-{layout}"))
        tckpt.save_model(d, tcfg, tp)
        _, jp = jckpt.load_model(d)
        out[layout] = (jp, tp, d)
    return out


def test_registry_moe_configs_equal_jax():
    for name in ("mixtral-8x7b", "qwen3-30b-a3b", "tiny-moe"):
        j, t = jreg.get_config(name), get_config(name)
        assert dataclasses.asdict(t) == dataclasses.asdict(j), name
        assert t.is_moe and t.expert_inter == j.expert_inter
        tdec.check_supported(t)
    assert get_config("mixtral-8x7b").expert_inter == 14336
    assert get_config("qwen3-30b-a3b").expert_inter == 768


@pytest.mark.parametrize("norm_topk", [True, False])
@pytest.mark.parametrize("k", [2, 3])
def test_router_weights_equal_jax(cfgs, k, norm_topk):
    jcfg, tcfg = cfgs
    jcfg, tcfg = (c.with_(experts_per_token=k, norm_topk=norm_topk) for c in (jcfg, tcfg))
    rng = np.random.default_rng(k + 10 * norm_topk)
    h = rng.normal(size=(2, 5, 64)).astype(np.float32)
    w = rng.normal(0, 0.2, size=(4, 64)).astype(np.float32)
    jw = jdec.moe_router_weights(jcfg, jdec.DenseLinear(w=jnp.asarray(w)), jnp.asarray(h))
    tw = tdec.moe_router_weights(tcfg, DenseLinear(w=torch.from_numpy(w)), torch.from_numpy(h))
    assert tw[2].dtype == torch.int32 and tw[0].dtype == tw[1].dtype == torch.float32
    np.testing.assert_array_equal(tw[2].numpy(), np.asarray(jw[2]))
    for a, b in zip(tw[:2], jw[:2]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=PIECE_TOL)


@pytest.mark.parametrize("norm_topk", [True, False])
def test_router_ties_lower_index_first(cfgs, norm_topk):
    """Experts 1 and 3 have the same router row, expert 0 the zero row: their
    softmax weights tie exactly, and JAX's ``lax.top_k`` puts the lower index
    first; so does the port's stable sort."""
    jcfg, tcfg = (c.with_(norm_topk=norm_topk) for c in cfgs)
    rng = np.random.default_rng(7)
    w = rng.normal(0, 0.3, size=(4, 64)).astype(np.float32)
    w[3] = w[1]
    w[0] = 0.0
    h = rng.normal(size=(1, 6, 64)).astype(np.float32)
    h[0, :3] = 0.0  # every weight ties: picks 0 and 1
    jw = jdec.moe_router_weights(jcfg, jdec.DenseLinear(w=jnp.asarray(w)), jnp.asarray(h))
    tw = tdec.moe_router_weights(tcfg, DenseLinear(w=torch.from_numpy(w)), torch.from_numpy(h))
    np.testing.assert_array_equal(tw[2].numpy(), np.asarray(jw[2]))
    np.testing.assert_array_equal(tw[2][0, :3].numpy(), [[0, 1]] * 3)
    for picks in tw[2][0, 3:].tolist():
        if 3 in picks:  # its twin 1 ties with it and comes first
            assert 1 in picks and picks.index(1) < picks.index(3)
    for a, b in zip(tw[:2], jw[:2]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=PIECE_TOL)


def _layer(params, tparams, li):
    return jdec.layer_slice(params["layers"], li), tdec.layer_view(tparams["layers"], li)


@pytest.mark.parametrize("rows", [(1, 1), (2, 3), (1, 7)])
@pytest.mark.parametrize("which", ["dense", "ssr", "down"])
def test_moe_mlp_plans_equal_jax(cfgs, dense, packed, which, rows):
    """One row takes the top-k plan (the picks as 0-d tensors, which on the
    CPU the wrappers read), more rows the all-experts plan; both within
    MLP_TOL of JAX's on the rows whose routing margin is at least NEAR_TIE
    (the others counted: none here)."""
    jcfg, tcfg = cfgs
    jp, tp = dense if which == "dense" else packed[which][:2]
    rng = np.random.default_rng(sum(rows))
    h = rng.normal(size=rows + (64,)).astype(np.float32)
    excluded = 0
    for li in range(tcfg.n_layers):
        jl, tl = jdec.layer_slice(jp["layers"], li), tdec.layer_view(tp["layers"], li)
        probs = torch.softmax(torch.from_numpy(h) @ tl["router"].w.t().float(), -1)
        top = probs.sort(-1, descending=True).values
        keep = ((top[..., 1] - top[..., 2]) >= NEAR_TIE).numpy()
        excluded += int((~keep).sum())
        want = np.asarray(jdec._moe_mlp(jcfg, jl, jnp.asarray(h), "xla", li))[keep]
        got = tdec._moe_mlp(tcfg, tl, torch.from_numpy(h), "plain", li).numpy()
        auto = tdec._moe_mlp(tcfg, tl, torch.from_numpy(h), "auto", li).numpy()
        np.testing.assert_array_equal(auto, got)
        assert np.abs(got[keep] - want).max() <= MLP_TOL * np.abs(want).max()
    assert excluded == 0


def _margins(cfg, params, toks):
    """(B, L) the smallest routing margin of each token over the layers, from
    the port's f32 forward."""
    B, L = toks.shape
    h = tdec.embed_tokens(cfg, params, toks)
    mask = tdec.build_mask(cfg, L, L)
    cos, sin, _, _ = tdec.pos_tables(cfg, L)
    out = torch.full((B, L), float("inf"))
    k = cfg.experts_per_token
    for li in range(cfg.n_layers):
        lp = tdec.layer_view(params["layers"], li)
        h, io = tdec.layer_forward(cfg, lp, h, cos, sin, mask, impl="plain", layer_idx=li,
                                   return_taps=True)
        probs = torch.softmax(io.taps["mlp_in"].float() @ lp["router"].w.t().float(), -1)
        top = probs.sort(-1, descending=True).values
        out = torch.minimum(out, top[..., k - 1] - top[..., k])
    return out


@pytest.mark.parametrize("which", ["dense", "ssr", "down"])
def test_forward_logits_equal_jax(cfgs, dense, packed, which):
    jcfg, tcfg = cfgs
    jp, tp = dense if which == "dense" else packed[which][:2]
    toks = np.random.default_rng(3).integers(0, 256, size=(3, 24))
    lj = np.asarray(jdec.forward(jcfg, jp, jnp.asarray(toks), impl="xla"))
    lt = tdec.forward(tcfg, tp, torch.from_numpy(toks).long(), impl="plain").numpy()
    margins = _margins(tcfg, tp, torch.from_numpy(toks).long()).numpy()
    excluded = 0
    for b in range(toks.shape[0]):
        near = np.flatnonzero(margins[b] < NEAR_TIE)
        end = near[0] if near.size else toks.shape[1]
        excluded += toks.shape[1] - end
        assert np.abs(lt[b, :end] - lj[b, :end]).max() <= LOGIT_TOL * np.abs(lj[b, :end]).max()
    assert excluded <= 8, excluded
    # auto on the CPU is the plain route
    la = tdec.forward(tcfg, tp, torch.from_numpy(toks).long()).numpy()
    np.testing.assert_array_equal(la, lt)


@pytest.mark.parametrize("batch", [1, 2])
def test_greedy_tokens_equal_jax(cfgs, packed, batch):
    """Batch 1 decodes on the top-k plan, batch 2 on the all-experts plan."""
    jcfg, tcfg = cfgs
    jp, tp, _ = packed["ssr"]
    prompt = np.random.default_rng(batch).integers(0, 256, size=(batch, 9)).astype(np.int32)
    want = np.asarray(jgreedy(jcfg, jp, jnp.asarray(prompt), 12, max_len=32))
    got = greedy_generate(tcfg, tp, torch.from_numpy(prompt), 12, max_len=32)
    np.testing.assert_array_equal(got.numpy(), want)


LENS = (5, 17, 9)
MAX_NEW = (6, 4, 8)


def _run(engine, prompts):
    reqs = [engine.submit(p, m) for p, m in zip(prompts, MAX_NEW)]
    engine.run(max_steps=100)
    return [r.out for r in reqs], [r.uid for r in engine.finished]


@pytest.mark.parametrize("quantum", [1, 4])
def test_engine_tokens_equal_jax(cfgs, packed, quantum):
    jcfg, tcfg = cfgs
    jp, tp, _ = packed["down"]
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, 256, size=n).astype(np.int32) for n in LENS]
    want = _run(JEngine(jcfg, jp, max_batch=2, max_len=64, decode_quantum=quantum), prompts)
    got = _run(ServeEngine(tcfg, tp, max_batch=2, max_len=64, decode_quantum=quantum), prompts)
    assert got == want


def _npz(path):
    with np.load(os.path.join(path, "arrays.npz"), allow_pickle=True) as z:
        return {k: z[k] for k in z.files}


def test_artifacts_both_ways(cfgs, packed, tmp_path):
    """The port's artifact, loaded by JAX and saved again, has the same
    structure and bytes; the port loads JAX's copy equal to its own params."""
    jcfg, tcfg = cfgs
    for layout in ("ssr", "down"):
        jp, tp, d = packed[layout]
        back = str(tmp_path / layout)
        jckpt.save_model(back, jcfg, jp)
        a, b = _npz(d), _npz(back)
        assert sorted(a) == sorted(b)
        for k in a:
            if k != "__bf16_keys__":
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        _, again = tckpt.load_model(back, device="cpu")
        for name in ("router", "gateup", "down"):
            x, y = tp["layers"][name], again["layers"][name]
            for f in ("w", "packed", "alpha", "mu", "perm"):
                if hasattr(x, f):
                    assert torch.equal(getattr(x, f), getattr(y, f)), (layout, name, f)
        assert again["layers"]["gateup"].packed.shape == (2, 4, 256, 256)


@pytest.fixture(scope="module")
def jax_quantized(cfgs):
    jcfg, _ = cfgs
    jp = jdec.init_params(jcfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    calib = jax.random.randint(jax.random.PRNGKey(7), (8, 32), 0, jcfg.vocab_size)
    q, _ = jpipe.quantize_model(jcfg, jp, calib, jpipe.QuantConfig())
    return q


def test_randmodel_structure_matches_jax_quantize(cfgs, jax_quantized):
    _, tcfg = cfgs
    tflat, ts, jflat, js = {}, {}, {}, {}
    tckpt._flatten("", random_ternary_params(tcfg, seed=0, perm_mode="ssr", device="cpu"),
                   tflat, ts)
    jckpt._flatten("", jax_quantized, jflat, js)
    ta = {k: (tuple(v.shape), str(v.dtype).replace("torch.", "")) for k, v in tflat.items()}
    ja = {k: (tuple(np.shape(v)), str(np.asarray(v).dtype)) for k, v in jflat.items()}
    assert ts == js  # leaf names, kinds, in_features and every flag
    assert sorted(ta) == sorted(ja)
    for k, (shape, dtype) in ja.items():
        assert ta[k][0] == shape, k
        packed_leaf = k.split(".")[-1] in ("packed", "perm", "alpha", "mu")
        assert ta[k][1] == (dtype if packed_leaf else "bfloat16"), (k, ta[k], dtype)
    for name in ("gateup", "down"):
        assert ts[f"layers.{name}"]["kind"] == "ternary"
    assert ts["layers.gateup"]["gather_in_features"] == 64
    assert ts["layers.down"]["input_folded"] and ts["layers.gateup"]["out_folded"]


def _stack(rng, S, K, n, bs):
    codes = rng.integers(-1, 2, size=(S, n, K)).astype(np.int8)
    packed = np.stack([np.asarray(jpack.pack_ternary(jnp.asarray(c), block_size=bs))
                       for c in codes])
    alpha = jnp.asarray(rng.integers(8, 40, size=(S, K // bs, n)) / 256.0, jnp.bfloat16)
    mu = jnp.asarray(rng.integers(-30, 31, size=(S, K // bs, n)) / 1024.0, jnp.bfloat16)
    return packed, alpha, mu


@pytest.mark.parametrize("a8", [False, True])
def test_idx_plain_versions_match_pallas_stacked_interpret(a8):
    """K1s / K3s's plain versions (the slot base + sel through K1's / K3's
    plain version) against JAX's scalar-prefetch stacked kernels."""
    rng = np.random.default_rng(40 + a8)
    S, B, m, K, n = 4, 1, 200, 256, 256
    packed, alpha, mu = _stack(rng, S, K, n, 128)
    perms = np.stack([np.concatenate([rng.permutation(m), np.full(K - m, m)]).astype(np.int32)
                      for _ in range(S)])
    x = np.asarray(jnp.asarray(rng.normal(size=(B, K)), jnp.bfloat16).astype(jnp.float32))
    for slot in range(S):
        sel = torch.tensor([slot - 2 if slot >= 2 else slot], dtype=torch.int32)
        base = 2 if slot >= 2 else 0
        with pltpu.force_tpu_interpret_mode():
            want = np.asarray(jpt.ternary_matmul_pallas_stacked(
                jnp.asarray(x), jnp.asarray(packed), alpha, mu, jnp.int32(slot), tile_n=128,
                blocks_per_step=1, a8=a8))
            want_g = np.asarray(jpt.ternary_matmul_pallas_igathered_stacked(
                jnp.asarray(x[:, :m]), jnp.asarray(perms), jnp.asarray(packed), alpha, mu,
                jnp.int32(slot), tile_n=128, a8=a8))
        got = tk.ternary_matmul_idx_plain(_t(x), _t(packed), _t(alpha), _t(mu), sel, base,
                                          a8=a8).numpy()
        got_g = tk.ternary_matmul_igathered_idx_plain(_t(x[:, :m]), _t(perms), _t(packed),
                                                      _t(alpha), _t(mu), sel, base, a8=a8).numpy()
        assert np.abs(got - want).max() <= REL * np.abs(want).max()
        assert np.abs(got_g - want_g).max() <= REL * np.abs(want_g).max()
        # the wrappers on CPU tensors are the plain versions
        np.testing.assert_array_equal(
            tk.ternary_matmul_idx(_t(x), _t(packed), _t(alpha), _t(mu), sel, base, a8=a8).numpy(),
            got)
    with pytest.raises(IndexError):
        tk.ternary_matmul_idx_plain(_t(x), _t(packed), _t(alpha), _t(mu),
                                    torch.tensor([3], dtype=torch.int32), 2)


@pytest.mark.parametrize("impl", ["auto", "a8", "plain"])
@pytest.mark.parametrize("layout", ["ssr", "down"])
def test_device_index_equals_host_index_on_cpu(cfgs, layout, impl):
    _, tcfg = cfgs
    tp = random_ternary_params(tcfg, seed=2, perm_mode=layout, device="cpu")
    rng = np.random.default_rng(1)
    for name, m in (("gateup", 64), ("down", 128)):
        flat = tdec._flatten_expert_stack(tp["layers"][name])
        assert flat.packed.data_ptr() == tp["layers"][name].packed.data_ptr()  # a view
        x = torch.from_numpy(rng.normal(size=(1, m)).astype(np.float32)).bfloat16()
        for slot in range(8):
            e = torch.tensor(slot % 4, dtype=torch.int32)
            base = (slot // 4) * 4
            got = ttm.ternary_linear_apply_stacked(flat, x, e, impl=impl, base=base)
            want = ttm.ternary_linear_apply_stacked(flat, x, slot, impl=impl)
            assert torch.equal(got, want), (name, slot)
            assert torch.equal(want, ttm.ternary_linear_apply(
                tp["layers"][name].layer(slot // 4).layer(slot % 4), x, impl=impl))


def test_flatten_refuses_a_copy(cfgs):
    _, tcfg = cfgs
    p = random_ternary_params(tcfg, seed=2, perm_mode="down", device="cpu")["layers"]["down"]
    t = dataclasses.replace(p, packed=p.packed.transpose(0, 1))
    with pytest.raises(ValueError, match="not contiguous"):
        tdec._flatten_expert_stack(t)


def test_linear_route_names_device_index_entries(cfgs, monkeypatch):
    _, tcfg = cfgs
    tp = random_ternary_params(get_config("mixtral-8x7b").with_(n_layers=1, n_experts=2,
                                                                 dim=256, intermediate=256,
                                                                 n_heads=2, n_kv_heads=2,
                                                                 vocab_size=64),
                               seed=0, perm_mode="ssr", device="cpu")
    gu = tdec._flatten_expert_stack(tp["layers"]["gateup"])
    dn = tdec._flatten_expert_stack(tp["layers"]["down"])
    assert ttm.linear_route(gu, 1, "auto", "cuda", device_index=True) == (
        "ternary_matmul_igathered_idx",)
    assert ttm.linear_route(dn, 1, "a8", "cuda", device_index=True) == ("ternary_matmul_idx",)
    assert ttm.linear_route(gu, 1, "auto", "cpu", device_index=True) == ()
    monkeypatch.setattr(ttm, "IGATHER_FUSED", False)
    monkeypatch.setattr(ttm, "FUSED_GATHER", True)
    assert ttm.linear_route(gu, 1, "auto", "cuda", device_index=True) == (
        "ternary_matmul_gathered_idx",)  # K6s
    monkeypatch.setattr(ttm, "FUSED_GATHER", False)
    assert ttm.linear_route(gu, 1, "auto", "cuda", device_index=True) == (
        "onehot_gather_idx", "ternary_matmul_idx")  # K4s, then K1s
    monkeypatch.setattr(tgather, "GATHER_KERNEL", "packed")
    assert ttm.linear_route(gu, 1, "a8", "cuda", device_index=True) == (
        "onehot_matmul_idx", "ternary_matmul_idx")  # K5s, then K1s
