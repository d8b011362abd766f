"""K1 on the card against its plain version. Needs an NVIDIA GPU; every test
skips without one. This file imports neither JAX nor the JAX package, so on
a machine without JAX it runs as

    python -m pytest --noconftest tests/test_torch_kernels_cuda.py -q

Tolerance: the kernel and the plain version get the same bf16 inputs and
accumulate in f32 in different orders, so they agree to 1e-4 of the
output's largest magnitude."""

import pytest
import torch

from pt2tpu_torch.core.packing import pack_ternary
from pt2tpu_torch.models import decoder as tdec
from pt2tpu_torch.models.registry import get_config
from pt2tpu_torch.ops.kernels import ternary as tk
from pt2tpu_torch.utils.randmodel import random_ternary_params

TOL = 1e-4


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
    (1, 1024, 384, 128), (3, 640, 96, 64), (16, 4096, 256, 128),
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
