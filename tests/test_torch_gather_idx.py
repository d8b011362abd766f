"""K4s, K5s and K6s (the gather kernels and K6 with the slot read from device
memory) of the port against the JAX package's stacked kernels with a traced
index (CPU), and a routed expert's decode under every gather route.

- The plain versions of K4s and K5s against ``onehot_iota_pallas_stacked``
  and ``onehot_matmul_pallas_stacked`` in interpret mode, every slot of a
  stack, the index a jnp int32: bit-exact (both copy x[b, perm[k]], the
  second as an f32 sum with one nonzero term). K6s's against
  ``ternary_matmul_pallas_gathered_stacked``: REL = 1e-5 of max|ref| (f32
  summation order; W2A8 rows as ``held_to_pallas`` states).
- ``gather_apply`` on a stacked gather at a host slot and at a device index
  gives the bits of JAX's ``gather_apply`` with ``layer_idx``.
- ``linear_route(..., device_index=True)`` names a device-index entry for
  every kernel of every route under the G4, G5 and P2 flags and the
  defaults, as JAX's stacked route picks its kernels.
- The slice as a whole: tiny-moe widened to dim 128 (so that its scale
  blocks are 128 lanes and K3 / K6 take its projections, as they take
  mixtral's) in the "ssr" layout, at batch 1 (the top-k plan's device
  index at every decode step) through both packages under the G4, G5 and
  P2 flags: the port on the route the card takes (``linear_route`` asked
  for CUDA, each wrapper its plain version on the CPU, K1's operand cast
  to bf16 as its wrapper casts it), JAX through its Pallas kernels in
  interpret mode (``impl="pallas"``). The same greedy tokens, and logits
  within P2_TOL relative L2, the bound of
  ``tests/test_torch_packed_gather.py``'s P2 model and for its reasons (a
  bf16 cast turns f32-order differences into whole bf16 steps of a few
  operands; the TPU kernels' telescoped unpack).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from pt2tpu.models import registry as jreg
from pt2tpu.ops import gather as jgather
from pt2tpu.ops import ternary_matmul as jtm
from pt2tpu.ops.kernels import pallas_gather as jpg
from pt2tpu.ops.kernels import pallas_ternary as jpt
from pt2tpu.serve.generate import forward_cached as jforward_cached
from pt2tpu.serve.kvcache import init_cache as jinit_cache
from pt2tpu.utils import checkpoint as jckpt
from pt2tpu_torch.models import decoder as tdec
from pt2tpu_torch.models.registry import get_config
from pt2tpu_torch.ops import gather as tgather
from pt2tpu_torch.ops import ternary_matmul as ttm
from pt2tpu_torch.ops.kernels import gather as tkg
from pt2tpu_torch.ops.kernels import ternary as tk
from pt2tpu_torch.serve.generate import forward_cached as tforward_cached
from pt2tpu_torch.serve.kvcache import init_cache as tinit_cache
from pt2tpu_torch.utils import checkpoint as tckpt
from pt2tpu_torch.utils.randmodel import random_ternary_params

from test_torch_gather import _t, bf16_values, held_to_pallas, rand_layer, ssr_perm
from test_torch_moe import _dense_f32

S = 4  # slots of every stack here
P2_TOL = 5e-3
# (GATHER_KERNEL, IGATHER_FUSED, FUSED_GATHER)
FLAG_SETS = {"G4": ("iota", False, False), "G5": ("packed", False, False),
             "P2": ("packed", False, True), "defaults": ("iota", True, False)}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def planes(perm, m):
    """The JAX package's packed one-hot planes of ``perm`` over m features."""
    return np.array(jgather.make_packed_gather(jnp.asarray(perm), m).packed)


def slots():
    """(slot, sel, base) for every slot of the stack: the index a 0-d int32
    tensor, the base a host offset, as the MoE plan passes them."""
    return [(s, torch.tensor(s % 2, dtype=torch.int32), s - s % 2) for s in range(S)]


@pytest.mark.parametrize("rows,m,K", [(1, 256, 256), (4, 200, 384), (15, 300, 512)])
def test_k4s_k5s_plain_bit_exact_vs_pallas_stacked_interpret(rows, m, K):
    rng = np.random.default_rng(rows + m)
    perms = np.stack([ssr_perm(rng, m, K, interleave=m != 256) for _ in range(S)])
    gs = np.stack([planes(p, m) for p in perms])
    D = gs.shape[1] * 4
    x = rng.normal(size=(rows, m)).astype(np.float32)
    tx, tperm, tgs = torch.from_numpy(x), torch.from_numpy(perms), torch.from_numpy(gs)
    for slot, sel, base in slots():
        with pltpu.force_tpu_interpret_mode():
            want4 = np.asarray(jpg.onehot_iota_pallas_stacked(
                jnp.asarray(x), jnp.asarray(perms), jnp.int32(slot), D=D))
            want5 = np.asarray(jpg.onehot_matmul_pallas_stacked(
                jnp.asarray(x), jnp.asarray(gs), jnp.int32(slot), tile_n=128,
                blocks_per_step=1))
        got4 = tkg.onehot_gather_idx_plain(tx, tperm, sel, base)
        got5 = tkg.onehot_matmul_idx_plain(tx, tgs, sel, base)
        assert got4.dtype == got5.dtype == torch.float32 and got4.shape == (rows, K)
        np.testing.assert_array_equal(got4.numpy(), want4)
        np.testing.assert_array_equal(got5.numpy(), want5)
        # the wrappers on CPU tensors are the plain versions
        np.testing.assert_array_equal(tkg.onehot_gather_idx(tx, tperm, sel, base).numpy(), want4)
        np.testing.assert_array_equal(tkg.onehot_matmul_idx(tx, tgs, sel, base).numpy(), want5)


@pytest.mark.parametrize("a8", [False, True])
@pytest.mark.parametrize("rows,m,K,n", [(1, 200, 256, 256), (4, 600, 640, 128)])
def test_k6s_plain_matches_pallas_stacked_interpret(rows, m, K, n, a8):
    rng = np.random.default_rng(60 + rows + int(a8))
    layers = [rand_layer(rng, K, n) for _ in range(S)]
    packed = np.stack([lay[0] for lay in layers])
    alpha = jnp.stack([lay[1] for lay in layers])
    mu = jnp.stack([lay[2] for lay in layers])
    perms = np.stack([ssr_perm(rng, m, K, interleave=True) for _ in range(S)])
    gs = np.stack([planes(p, m) for p in perms])
    x = bf16_values(rng, (rows, m))
    tstack = [_t(a) for a in (gs, packed, alpha, mu)]
    for slot, sel, base in slots():
        with pltpu.force_tpu_interpret_mode():
            want = np.asarray(jpt.ternary_matmul_pallas_gathered_stacked(
                jnp.asarray(x), jnp.asarray(gs), jnp.asarray(packed), alpha, mu,
                jnp.int32(slot), tile_n=128, a8=a8))
        got = tk.ternary_matmul_gathered_idx_plain(_t(x), *tstack, sel, base, a8=a8)
        assert got.shape == want.shape == (rows, n)
        held_to_pallas(got.numpy(), x, perms[slot], packed[slot], alpha[slot], mu[slot], want,
                       a8)
        np.testing.assert_array_equal(
            tk.ternary_matmul_gathered_idx(_t(x), *tstack, sel, base, a8=a8).numpy(),
            got.numpy())


@pytest.mark.parametrize("kernel", ["iota", "packed"])
def test_gather_apply_at_a_slot_matches_jax(kernel, monkeypatch):
    """A stacked gather at a host slot and at a device index: the bits of
    JAX's gather_apply with layer_idx, through its index form and through
    its Pallas kernel in interpret mode; the index on the device never
    changes the result."""
    monkeypatch.setattr(jgather, "GATHER_KERNEL", kernel)
    monkeypatch.setattr(tgather, "GATHER_KERNEL", kernel)
    rng = np.random.default_rng(8)
    m, K = 200, 384
    perms = np.stack([ssr_perm(rng, m, K, interleave=True) for _ in range(S)])
    gs = np.stack([planes(p, m) for p in perms])
    jg = jgather.PackedGather(jnp.asarray(gs), jnp.asarray(perms), m)
    tg = tgather.PackedGather(torch.from_numpy(gs), torch.from_numpy(perms), m)
    x = rng.normal(size=(2, 3, m)).astype(np.float32)
    for slot, sel, base in slots():
        want = np.asarray(jgather.gather_apply(jg, jnp.asarray(x), "xla", jnp.int32(slot)))
        with pltpu.force_tpu_interpret_mode():
            pallas = np.asarray(jgather.gather_apply(jg, jnp.asarray(x), "pallas",
                                                     jnp.int32(slot)))
        np.testing.assert_array_equal(pallas, want)
        for impl in ("auto", "plain"):
            for idx in (sel, slot - base):
                got = tgather.gather_apply(tg, torch.from_numpy(x), impl, idx, base)
                assert got.shape == (2, 3, K)
                np.testing.assert_array_equal(got.numpy(), want)
    with pytest.raises(ValueError, match="layer_idx"):
        tgather.gather_apply(tg, torch.from_numpy(x))


@pytest.mark.parametrize("flags", sorted(FLAG_SETS))
def test_linear_route_names_a_device_index_entry_for_every_kernel(flags, monkeypatch):
    """One row of an "ssr" expert stack whose shapes K3 and K6 take, and one
    whose out width they refuse (416): every kernel the host-index route
    launches has its device-index entry in the route, in order."""
    from pt2tpu_torch.utils.randmodel import random_expert_stack

    gk, igf, fg = FLAG_SETS[flags]
    monkeypatch.setattr(tgather, "GATHER_KERNEL", gk)
    monkeypatch.setattr(ttm, "IGATHER_FUSED", igf)
    monkeypatch.setattr(ttm, "FUSED_GATHER", fg)
    gen = torch.Generator().manual_seed(1)
    for n_out in (512, 416):
        flat = tdec._flatten_expert_stack(random_expert_stack(gen, 1, 2, n_out, 256, "ssr",
                                                              device="cpu"))
        host = ttm.linear_route(flat.layer(1), 1, "auto", "cuda")
        dev = ttm.linear_route(flat, 1, "auto", "cuda", device_index=True)
        assert dev == tuple(name + "_idx" for name in host)
        fused = n_out % 128 == 0 and (igf or fg)
        assert len(dev) == (1 if fused else 2)
        assert dev[-1] in ("ternary_matmul_igathered_idx", "ternary_matmul_gathered_idx",
                           "ternary_matmul_idx")


# ---- the slice as a whole
@pytest.fixture(scope="module")
def moe128(tmp_path_factory):
    """tiny-moe at dim 128 ("ssr": qkv, o and the experts' gateup gather,
    down folded), the port's random packed model in f32 dense leaves, and
    JAX's copy through an artifact."""
    tcfg = get_config("tiny-moe").with_(dim=128)
    jcfg = jreg.get_config("tiny-moe").with_(dim=128)
    tp = _dense_f32(random_ternary_params(tcfg, seed=7, perm_mode="ssr", device="cpu"))
    d = str(tmp_path_factory.mktemp("moe128"))
    tckpt.save_model(d, tcfg, tp)
    _, jp = jckpt.load_model(d)
    assert tp["layers"]["gateup"].block_size == tp["layers"]["qkv"].block_size == 128
    return jcfg, jp, tcfg, tp


@pytest.fixture
def fresh_jax_traces():
    """JAX's jitted steps bake the routing flags in when traced: trace anew
    under this test's flags, and leave no trace of them behind."""
    jax.clear_caches()
    yield
    jax.clear_caches()


@pytest.mark.parametrize("flags", ["G4", "G5", "P2"])
def test_tiny_moe_decode_under_gather_routes_matches_jax_pallas(moe128, flags, monkeypatch,
                                                               fresh_jax_traces):
    jcfg, jp, tcfg, tp = moe128
    gk, igf, fg = FLAG_SETS[flags]
    for mod_j, mod_t, name, value in ((jgather, tgather, "GATHER_KERNEL", gk),
                                      (jtm, ttm, "IGATHER_FUSED", igf),
                                      (jtm, ttm, "FUSED_GATHER", fg)):
        monkeypatch.setattr(mod_j, name, value)
        monkeypatch.setattr(mod_t, name, value)
    route = ttm.linear_route
    monkeypatch.setattr(ttm, "linear_route", lambda p, rows, impl="auto", device="cuda",
                        device_index=False: route(p, rows, impl, "cuda", device_index))
    launched = []

    def spy(mod, name, tag, cast=False):
        fn = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda x, *a, **kw: launched.append(tag) or fn(
            x.bfloat16() if cast else x, *a, **kw))

    spy(ttm, "ternary_matmul", "K1", cast=True)
    spy(ttm, "ternary_matmul_idx", "K1s", cast=True)
    spy(ttm, "ternary_matmul_gathered", "K6")
    spy(ttm, "ternary_matmul_gathered_idx", "K6s")
    spy(tgather, "onehot_gather_idx", "K4s")
    spy(tgather, "onehot_matmul_idx", "K5s")
    Lp, steps = 9, 4
    prompt = np.random.default_rng(3).integers(0, jcfg.vocab_size, size=(1, Lp)).astype(np.int32)
    jcache = jinit_cache(jcfg, 1, Lp + 8)
    tcache = tinit_cache(tcfg, 1, Lp + 8, device="cpu")
    jtok, ttok = jnp.asarray(prompt), torch.from_numpy(prompt).long()
    per_step = []
    with torch.inference_mode():
        for step in range(steps):
            pos = 0 if step == 0 else Lp + step - 1
            launched.clear()
            with pltpu.force_tpu_interpret_mode():
                jl, jcache = jforward_cached(jcfg, jp, jtok, jcache, pos, "pallas")
            tl, _ = tforward_cached(tcfg, tp, ttok, tcache, pos, "auto")
            want, got = np.asarray(jl), tl.float().numpy()
            assert np.linalg.norm(got - want) <= P2_TOL * np.linalg.norm(want)
            np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
            per_step.append(list(launched))
            jtok, ttok = jnp.argmax(jl, -1)[:, None], tl.argmax(-1)[:, None]
    # a decode step's calls in order, but for the host-index route's gathers
    # (on the CPU, gather_apply takes the index form for them)
    L, k = tcfg.n_layers, tcfg.experts_per_token
    if fg:  # P2: qkv, o through K6; each top-k expert's gateup K6s, its down K1s
        layer = ["K6", "K6"] + ["K6s", "K1s"] * k
    else:  # G4 / G5: qkv, o through K1 after their gathers; each expert's
        # gateup the gather's device-index entry then K1s, its down K1s
        layer = ["K1", "K1"] + ["K4s" if gk == "iota" else "K5s", "K1s", "K1s"] * k
    for decode in per_step[1:]:
        assert decode == layer * L
