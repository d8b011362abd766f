"""K1-K4 on the card against their plain versions. Needs an NVIDIA GPU;
every test skips without one. This file imports neither JAX nor the JAX
package, so on a machine without JAX it runs as

    python -m pytest --noconftest tests/test_torch_kernels_cuda.py -q

Tolerances: K1 and K3 get the same bf16 inputs as their plain versions and
accumulate in f32 in different orders, so they agree to 1e-4 of the
output's largest magnitude. K4 copies values: bit-exact. K2 rounds mid =
silu(gate) * up to bf16 as its plain version does, but gate and up differ
in their last f32 bits between the two, so a few mid values round to the
neighbouring bf16 (2^-8 relative) and K2 is held to 1e-3."""

import pytest
import torch

from pt2tpu_torch.core.packing import pack_ternary
from pt2tpu_torch.models import decoder as tdec
from pt2tpu_torch.models.registry import get_config
from pt2tpu_torch.ops.kernels import gather as tkg
from pt2tpu_torch.ops.kernels import ternary as tk
from pt2tpu_torch.serve.generate import greedy_generate
from pt2tpu_torch.utils.randmodel import random_ternary_params

TOL = 1e-4
MLP_TOL = 1e-3


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (K1 has no CPU mode)")
    return torch.device("cuda")


def _layer(g, dev, K, n, bs):
    T = torch.randint(-1, 2, (n, K), generator=g, device=dev, dtype=torch.int8)
    nb = K // bs
    alpha = (0.05 + 0.01 * torch.rand((nb, n), generator=g, device=dev)).bfloat16()
    mu = (0.01 * torch.randn((nb, n), generator=g, device=dev)).bfloat16()
    return pack_ternary(T, bs), alpha, mu


@pytest.mark.cuda
@pytest.mark.parametrize("a8", [False, True])
@pytest.mark.parametrize("B,K,n,bs", [
    (1, 1024, 384, 128), (2, 14336, 4096, 128), (3, 640, 96, 64), (16, 4096, 256, 128),
    (70, 2304, 128, 128), (9, 512, 64, 16),
])
def test_kernel_matches_plain(cuda_device, B, K, n, bs, a8):
    g = torch.Generator(device=cuda_device).manual_seed(B + K)
    packed, alpha, mu = _layer(g, cuda_device, K, n, bs)
    x = torch.randn((B, K), generator=g, device=cuda_device).bfloat16()
    before = tk.ternary_matmul.launches
    got = tk.ternary_matmul(x, packed, alpha, mu, block_size=bs, a8=a8)
    torch.cuda.synchronize()
    assert tk.ternary_matmul.launches == before + 1
    plain = tk.ternary_matmul_plain_a8 if a8 else tk.ternary_matmul_plain
    want = plain(x, packed, alpha, mu, bs)
    assert got.shape == want.shape and got.dtype == torch.float32
    assert (got - want).abs().max().item() <= TOL * want.abs().max().item()


@pytest.mark.cuda
def test_kernel_on_stacked_view(cuda_device):
    g = torch.Generator(device=cuda_device).manual_seed(1)
    layers = [_layer(g, cuda_device, 1024, 256, 128) for _ in range(3)]
    packed = torch.stack([l[0] for l in layers])
    alpha = torch.stack([l[1] for l in layers])
    mu = torch.stack([l[2] for l in layers])
    x = torch.randn((4, 1024), generator=g, device=cuda_device).bfloat16()
    for li in range(3):
        got = tk.ternary_matmul(x, packed[li], alpha[li], mu[li])
        want = tk.ternary_matmul_plain(x, *layers[li])
        assert (got - want).abs().max().item() <= TOL * want.abs().max().item()


@pytest.mark.cuda
def test_wrapper_rejects_what_the_kernel_does_not_take(cuda_device):
    g = torch.Generator(device=cuda_device).manual_seed(2)
    packed, alpha, mu = _layer(g, cuda_device, 256, 128, 128)
    x = torch.randn((2, 256), device=cuda_device).bfloat16()
    with pytest.raises(TypeError):
        tk.ternary_matmul(x, packed, alpha.float(), mu.float())
    with pytest.raises(ValueError):
        tk.ternary_matmul(x[:, :128], packed, alpha, mu)
    with pytest.raises(ValueError):
        tk.ternary_matmul(x, packed[:, :96].contiguous()[:, :80], alpha[:, :80], mu[:, :80])


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["tiny-llama", "tiny-llama-gqa"])
def test_tiny_model_kernel_vs_plain(cuda_device, name):
    cfg = get_config(name)
    params = random_ternary_params(cfg, seed=3, perm_mode="down", device=cuda_device)
    tokens = torch.randint(0, cfg.vocab_size, (2, 9), device=cuda_device)
    before = tk.ternary_matmul.launches
    with torch.inference_mode():
        auto = tdec.forward(cfg, params, tokens, impl="auto").float()
        plain = tdec.forward(cfg, params, tokens, impl="plain").float()
    assert tk.ternary_matmul.launches == before + 4 * cfg.n_layers
    rel = ((auto - plain).norm() / plain.norm()).item()
    assert rel <= 1e-2  # bf16 activations round at different points


def _perm(g, dev, m, K, interleave=False):
    perm = torch.cat([torch.randperm(m, generator=g, device=dev),
                      torch.full((K - m,), m, device=dev)])
    if interleave:
        perm = perm[torch.randperm(K, generator=g, device=dev)]
    return perm.to(torch.int32)


def _rel(got, want):
    return (got - want).abs().max().item() / want.abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("rows,m,K", [(1, 4096, 4096), (5, 200, 384), (40, 640, 1024)])
def test_gather_kernel_bit_exact(cuda_device, rows, m, K, dtype):
    g = torch.Generator(device=cuda_device).manual_seed(rows + m)
    perm = _perm(g, cuda_device, m, K, interleave=m == 200)
    x = torch.randn((rows, m), generator=g, device=cuda_device).to(dtype)
    before = tkg.onehot_gather.launches
    got = tkg.onehot_gather(x, perm)
    torch.cuda.synchronize()
    assert tkg.onehot_gather.launches == before + 1
    want = tkg.onehot_gather_plain(x, perm)
    assert got.dtype == dtype and torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("a8", [False, True])
@pytest.mark.parametrize("B,m,K,n", [(1, 4096, 4096, 6144), (2, 4096, 4096, 28672),
                                     (4, 200, 256, 256), (16, 640, 768, 384),
                                     (33, 512, 2048, 128)])
def test_igathered_kernel_matches_plain(cuda_device, B, m, K, n, a8):
    g = torch.Generator(device=cuda_device).manual_seed(B + m + n)
    packed, alpha, mu = _layer(g, cuda_device, K, n, 128)
    perm = _perm(g, cuda_device, m, K, interleave=m == 200)
    x = torch.randn((B, m), generator=g, device=cuda_device).bfloat16()
    before = tk.ternary_matmul_igathered.launches
    got = tk.ternary_matmul_igathered(x, perm, packed, alpha, mu, a8=a8)
    torch.cuda.synchronize()
    assert tk.ternary_matmul_igathered.launches == before + 1
    want = tk.ternary_matmul_igathered_plain(x, perm, packed, alpha, mu, a8=a8)
    assert got.shape == want.shape and _rel(got, want) <= TOL


def _mlp_layer(g, dev, Kg, I, n, L=None):
    """Gateup (Kg lanes -> 2I, gate | up) and down (I -> n, its block count
    padded to 16 as make_packed_linear pads it), optionally stacked L deep."""
    def one():
        gu = _layer(g, dev, Kg, 2 * I, 128)
        nbd = -(-(I // 128) // 16) * 16
        dn = _layer(g, dev, nbd * 128, n, 128)
        return gu + dn
    if L is None:
        return one()
    parts = [one() for _ in range(L)]
    return tuple(torch.stack([p[i] for p in parts]) for i in range(6))


@pytest.mark.cuda
@pytest.mark.parametrize("gather", [True, False], ids=["ssr", "down"])
@pytest.mark.parametrize("B,D,I,n", [(1, 512, 1408, 512), (2, 4096, 14336, 4096),
                                     (4, 4096, 14336, 4096), (16, 512, 1024, 256),
                                     (33, 256, 512, 384)])
def test_mlp_kernel_matches_plain(cuda_device, B, D, I, n, gather):
    g = torch.Generator(device=cuda_device).manual_seed(B + I)
    # with a gather its perm covers D lanes; without, x is zero-padded to the
    # 16-block multiple of lanes that make_packed_linear gives gateup
    Kg = D if gather else -(-D // 2048) * 2048
    gp, ga, gm, dp, da, dm = _mlp_layer(g, cuda_device, Kg, I, n)
    perm = _perm(g, cuda_device, D, Kg) if gather else None
    x = torch.randn((B, D), generator=g, device=cuda_device).bfloat16()
    before = tk.ternary_mlp.launches
    got = tk.ternary_mlp(x, perm, gp, ga, gm, dp, da, dm, intermediate=I)
    torch.cuda.synchronize()
    assert tk.ternary_mlp.launches == before + 1
    want = tk.ternary_mlp_plain(x, perm, gp, ga, gm, dp, da, dm, intermediate=I)
    assert got.shape == want.shape == (B, n) and _rel(got, want) <= MLP_TOL


@pytest.mark.cuda
def test_k2_k3_k4_on_stacked_views(cuda_device):
    g = torch.Generator(device=cuda_device).manual_seed(5)
    D, I, n, L = 512, 1024, 256, 3
    gp, ga, gm, dp, da, dm = _mlp_layer(g, cuda_device, D, I, n, L=L)
    perms = torch.stack([_perm(g, cuda_device, D, D) for _ in range(L)])
    x = torch.randn((4, D), generator=g, device=cuda_device).bfloat16()
    for li in range(L):
        got = tk.ternary_mlp(x, perms[li], gp[li], ga[li], gm[li], dp[li], da[li], dm[li], I)
        want = tk.ternary_mlp_plain(x, perms[li], gp[li], ga[li], gm[li], dp[li], da[li], dm[li], I)
        assert _rel(got, want) <= MLP_TOL
        got = tk.ternary_matmul_igathered(x, perms[li], gp[li], ga[li], gm[li])
        want = tk.ternary_matmul_igathered_plain(x, perms[li], gp[li], ga[li], gm[li])
        assert _rel(got, want) <= TOL
        assert torch.equal(tkg.onehot_gather(x, perms[li]), tkg.onehot_gather_plain(x, perms[li]))


@pytest.mark.cuda
def test_new_wrappers_reject_what_their_kernels_do_not_take(cuda_device):
    g = torch.Generator(device=cuda_device).manual_seed(6)
    x = torch.randn((4, 256), generator=g, device=cuda_device).bfloat16()
    perm = _perm(g, cuda_device, 256, 256)
    with pytest.raises(TypeError):  # K4: int64 perm, f16 x
        tkg.onehot_gather(x, perm.long())
    with pytest.raises(TypeError):
        tkg.onehot_gather(x.half(), perm)
    with pytest.raises(ValueError):  # K4: 3-D x
        tkg.onehot_gather(x[None], perm)
    packed, alpha, mu = _layer(g, cuda_device, 256, 128, 128)
    with pytest.raises(ValueError):  # K3: perm of the wrong length
        tk.ternary_matmul_igathered(x, perm[:128], packed, alpha, mu)
    with pytest.raises(TypeError):  # K3: f32 scales
        tk.ternary_matmul_igathered(x, perm, packed, alpha.float(), mu.float())
    gp, ga, gm, dp, da, dm = _mlp_layer(g, cuda_device, 256, 512, 256)
    with pytest.raises(ValueError):  # K2: more than 64 rows
        tk.ternary_mlp(torch.zeros((65, 256), device=cuda_device).bfloat16(), perm,
                       gp, ga, gm, dp, da, dm, 512)
    with pytest.raises(ValueError):  # K2: blocks of 64
        tk.ternary_mlp(x, perm, gp, ga, gm, dp, da, dm, 512, block_size=64)
    with pytest.raises(TypeError):  # K2: f32 scales
        tk.ternary_mlp(x, perm, gp, ga.float(), gm, dp, da, dm, 512)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["ssr", "down"])
def test_ssr_model_routes_through_k2_k3_k4(cuda_device, layout):
    """A 256-wide model whose gateup needs no pad blocks (I = 1024 is 8
    blocks): prefill through K4 + K1, decode through K3 + K2 ("ssr"),
    against the plain route. In the "down" layout decode stays on K1: the
    identity gateup has 2048 lanes (16 blocks, make_packed_linear's pad) for
    a 256-wide x, which fused_mlp_ok rejects, as the JAX predicate does."""
    cfg = get_config("tiny-llama").with_(dim=256, intermediate=1024)
    params = random_ternary_params(cfg, seed=4, perm_mode=layout, device=cuda_device)
    tokens = torch.randint(0, cfg.vocab_size, (2, 40), device=cuda_device)
    counts = lambda: (tk.ternary_matmul.launches, tk.ternary_matmul_igathered.launches,  # noqa: E731
                      tk.ternary_mlp.launches, tkg.onehot_gather.launches)
    c0 = counts()
    with torch.inference_mode():
        auto = tdec.forward(cfg, params, tokens, impl="auto").float()  # 80 rows: prefill route
        plain = tdec.forward(cfg, params, tokens, impl="plain").float()
    c1 = counts()
    gathers = 3 if layout == "ssr" else 0
    assert [b - a for a, b in zip(c0, c1)] == [4 * cfg.n_layers, 0, 0, gathers * cfg.n_layers]
    assert ((auto - plain).norm() / plain.norm()).item() <= 1e-2
    greedy_generate(cfg, params, tokens, 3)  # an 80-row prefill, then 2 decode steps
    c2 = counts()
    L = cfg.n_layers
    if layout == "ssr":  # prefill K4 x3 + K1 x4; each step K3 x2 (qkv, o) + K2
        want = [4 * L, 2 * 2 * L, 2 * L, 3 * L]
    else:  # prefill K1 x4; each step K1 x4
        want = [4 * L + 2 * 4 * L, 0, 0, 0]
    assert [b - a for a, b in zip(c1, c2)] == want
