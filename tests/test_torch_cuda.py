"""The hand-written Hopper kernels against their plain versions, on the
card. Needs an NVIDIA GPU and nvcc: each test skips where
torch.cuda.is_available() is false (decided inside the fixture, never at
import). Run on a GPU machine with `python -m pytest -m cuda
tests/test_torch_cuda.py -q`.

Tolerances: the kernels and the plain versions round the same
intermediates to bf16; they differ by float32 summation order, which
flips an occasional bf16 rounding of an intermediate (one bf16 ulp,
2^-8 relative), so values agree to a few bf16 ulps of the tensor's range.
"""

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels run only on the card)")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    from tpupose_torch.models.simple_baseline import SimpleBaseline

    g = torch.Generator().manual_seed(0)
    return SimpleBaseline("resnet50", 17, dtype=torch.bfloat16,
                          device="cuda", generator=g)


def _rel(a, b):
    a, b = a.float(), b.float()
    return ((a - b).abs().max() / b.abs().max().clamp_min(1e-12)).item()


def test_stem_kernel(card):
    from tpupose_torch.ops.cuda_stem import (fold_stem_weights, stem_pool,
                                             stem_pool_reference)

    g = torch.Generator().manual_seed(1)
    x = (torch.rand((2, 256, 192, 3), generator=g) * 4 - 2).cuda() \
        .to(torch.bfloat16)
    w = fold_stem_weights(card.backbone)
    assert _rel(stem_pool(x, w), stem_pool_reference(x, w)) < 2e-2


def test_layer1_and_bridge_kernels(card):
    from tpupose_torch.ops.cuda_bridge import (bridge, bridge_reference,
                                               fold_bridge_weights)
    from tpupose_torch.ops.cuda_layer1 import (fold_layer1_weights, layer1,
                                               layer1_reference)

    g = torch.Generator().manual_seed(2)
    x = torch.rand((2, 64, 48, 64), generator=g).cuda().to(torch.bfloat16)
    w = fold_layer1_weights(card.backbone)
    assert _rel(layer1(x, w), layer1_reference(x, w)) < 2e-2
    y = torch.rand((2, 64, 48, 256), generator=g).cuda().to(torch.bfloat16)
    wb = fold_bridge_weights(card.backbone)
    assert _rel(bridge(y, wb), bridge_reference(y, wb)) < 2e-2


def test_dark_decode_kernel(card):
    from tpupose_torch.ops.cuda_decode import (dark_decode,
                                               dark_decode_reference)

    rs = np.random.RandomState(3)
    ys, xs = np.mgrid[0:64, 0:48]
    mu = rs.uniform(3, 44, (4, 17, 2))
    hm = np.exp(-((xs - mu[..., 0, None, None]) ** 2
                  + (ys - mu[..., 1, None, None]) ** 2) / 8.0)
    hm[0, 0] = 0.0
    hm = torch.from_numpy(hm.astype(np.float32)).cuda()
    c, s = dark_decode(hm)
    rc, rsc = dark_decode_reference(hm)
    assert torch.equal(s, rsc)
    assert (c - rc).abs().max().item() < 1e-3
