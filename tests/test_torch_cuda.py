"""The port's CUDA kernels on the card, each against its plain version.

Marked ``cuda``: on a host without a GPU every test skips. On the card:
``python -m pytest tests/test_torch_cuda.py -q --noconftest``."""

import pytest
import torch

from qwen_tts_tpu_torch.ops.cuda.decode_attention import (
    decode_attention,
    decode_attention_plain,
)

pytestmark = pytest.mark.cuda

# f32: summation order only. bf16: the output rounds to bf16 (8 bits of
# mantissa) on values of magnitude ~1, so a couple of ulps.
TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("window", [None, 9])
@pytest.mark.parametrize("heads,kv,hd,s_max", [(16, 2, 64, 97), (16, 8, 128, 16),
                                               (8, 8, 64, 40), (16, 1, 128, 33)])
def test_decode_attention_kernel_matches_plain(device, heads, kv, hd, s_max, window, dtype):
    g = torch.Generator(device=device).manual_seed(0)
    b = 4
    q = torch.randn(b, heads, hd, generator=g, device=device).to(dtype)
    k = torch.randn(b, s_max, kv, hd, generator=g, device=device).to(dtype)
    v = torch.randn(b, s_max, kv, hd, generator=g, device=device).to(dtype)
    cur_len = torch.tensor([s_max, 1, s_max // 2, 3], dtype=torch.int32, device=device)
    valid_from = torch.tensor([0, 0, 2, 3], dtype=torch.int32, device=device)  # row 3 empty
    before = decode_attention.launches
    got = decode_attention(q, k, v, cur_len, valid_from, window)
    torch.cuda.synchronize()
    assert decode_attention.launches == before + 1
    want = decode_attention_plain(q, k, v, cur_len, valid_from, window)
    torch.testing.assert_close(got.float(), want.float(), atol=TOL[dtype], rtol=0)


def test_decode_attention_rejects_what_it_does_not_take(device):
    q = torch.zeros(1, 16, 96, device=device)
    k = torch.zeros(1, 8, 2, 96, device=device)
    lens = torch.ones(1, dtype=torch.int32, device=device)
    with pytest.raises(ValueError):
        decode_attention(q, k, k, lens, lens * 0)
    with pytest.raises(TypeError):
        decode_attention(q[..., :64].half().contiguous(), k[..., :64].half().contiguous(),
                         k[..., :64].half().contiguous(), lens, lens * 0)
