"""The inpaint encode, ``AutoencoderKL.encode_fp32``, is fp32 whatever the
caller's TF32 switches: it turns both off (cuBLAS's matmuls,
``torch.backends.cuda.matmul.allow_tf32``; cuDNN's convs,
``torch.backends.cudnn.allow_tf32``, on by PyTorch's default) for its own
duration and restores them, also when the encode raises.

On the CPU, hooks on a conv and a linear inside the encode read both
switches there.  On the card (``gpu`` marker, skipped without one), the
encode under PyTorch's default switches equals, bit for bit, the same
encode with both switches off.

This file imports neither jax nor gligen_tpu, so it also runs where JAX is
not installed (the GPU machine):

    python -m pytest tests/test_torch_encode_fp32.py -m gpu --noconftest -q
"""

import pytest
import torch

from gligen_tpu_torch.models.layers import Conv2d, Dense, computing_in
from gligen_tpu_torch.models.vae import AutoencoderKL

SMALL_VAE = dict(ch=32, ch_mult=(1, 2), num_res_blocks=1, resolution=16)


def switches():
    return torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32


@pytest.fixture
def restore_switches():
    saved = switches()
    yield
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


@pytest.mark.parametrize("start", [True, False])
@pytest.mark.parametrize("raises", [False, True])
def test_encode_fp32_pins_tf32_off_and_restores(restore_switches, start, raises):
    torch.manual_seed(0)
    vae = AutoencoderKL(**SMALL_VAE, dtype=torch.bfloat16)
    conv = vae.encoder.conv_in
    linear = next(m for m in vae.encoder.modules() if isinstance(m, Dense))
    assert isinstance(conv, Conv2d)
    seen = []

    def hook(module, args):
        seen.append((type(module).__name__, switches()))
        if raises and module is linear:
            raise RuntimeError("raised inside the encode")

    handles = [m.register_forward_pre_hook(hook) for m in (conv, linear)]
    torch.backends.cuda.matmul.allow_tf32 = start
    torch.backends.cudnn.allow_tf32 = start
    x, noise = torch.rand(1, 16, 16, 3) * 2 - 1, torch.randn(1, 8, 8, 4)
    try:
        if raises:
            with pytest.raises(RuntimeError, match="inside the encode"):
                vae.encode_fp32(x, noise)
        else:
            with torch.no_grad():
                assert vae.encode_fp32(x, noise).dtype == torch.float32
    finally:
        for h in handles:
            h.remove()
    assert [name for name, _ in seen] == ["Conv2d", "Dense"]
    assert all(flags == (False, False) for _, flags in seen), seen
    assert switches() == (start, start)
    assert vae.encoder.conv_in.compute_dtype == torch.bfloat16


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: cuDNN's and the kernels' fp32 routes")
    return torch.device("cuda")


@pytest.mark.gpu
def test_encode_fp32_is_bit_identical_under_default_switches(cuda, restore_switches):
    """At a width where cuDNN's convs take TF32 when allowed (the first
    assertion shows that they do, so the test can see a TF32 conv), the
    encode under PyTorch's defaults (matmul off, cuDNN on) equals the
    encode with both switches off, bit for bit."""
    gen = torch.Generator(device=cuda).manual_seed(3)
    vae = AutoencoderKL(ch=128, ch_mult=(1, 2), num_res_blocks=1, resolution=64,
                        dtype=torch.bfloat16).to(cuda)
    x = torch.rand((2, 64, 64, 3), generator=gen, device=cuda) * 2 - 1
    noise = torch.randn((2, 32, 32, 4), generator=gen, device=cuda)

    def plain_encode(cudnn_tf32):
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = cudnn_tf32
        with torch.no_grad(), computing_in(vae, torch.float32):
            return vae.encode(x, noise)

    fp32, tf32 = plain_encode(False), plain_encode(True)
    assert not torch.equal(fp32, tf32), "no conv took TF32: the test would not see it"
    torch.backends.cuda.matmul.allow_tf32 = False  # PyTorch's defaults
    torch.backends.cudnn.allow_tf32 = True
    with torch.no_grad():
        got = vae.encode_fp32(x, noise)
    assert switches() == (False, True)
    assert torch.equal(got, fp32)
