"""The SimpleBaseline-R50 serving route of `cli.serve` on the CPU: the
gate that sends a model to the composed kernel forward (K1 stem, K2
layer1, K3 block2_0, then the model's own tail) decides by the model's
compute dtype, so the Builder's model (float32 master weights under bf16
autocast) takes the kernel route on the card. The card's decision is
taken here on the `meta` device, which has no plain-version shortcut.

Tolerance of the route against the model's own autocast forward: max rel
0.06, mean rel 5e-3 (the bf16 bounds of chip_smoke.py phase 4 and
tests/test_pallas_stem.py): both round to bf16, at other points.
"""

import copy

import numpy as np
import pytest
import torch

from tpupose_torch.configs import load_config
from tpupose_torch.engine.builder import Builder
from tpupose_torch.ops.cuda_stem import (compute_dtype, fold_fast_r50,
                                         is_fast_r50)
from torch_threads import one_torch_thread  # noqa: F401

CFG = "tpupose/configs/method/simple_baseline.yaml"


def _cfg(**overrides):
    return load_config(CFG, {k: str(v) for k, v in overrides.items()})


@pytest.fixture(scope="module")
def r50():
    """The model cli.serve builds for simple_baseline.yaml: float32
    masters, bf16 compute (train.mixed_precision defaults to true)."""
    return Builder(_cfg(), device="cpu").model()


def test_builder_model_keeps_float32_masters_and_bf16_compute(r50):
    assert next(r50.parameters()).dtype == torch.float32
    assert compute_dtype(r50) == torch.bfloat16


def test_gate_takes_the_bf16_compute_model_on_the_card(r50):
    """On a device without plain versions the gate keys on the compute
    dtype: the float32-master model is taken (the parameter dtype alone
    would refuse it and hide the kernels behind cuDNN)."""
    assert is_fast_r50(copy.deepcopy(r50).to("meta"))


def test_gate_refuses_a_float32_compute_model_on_the_card():
    m = Builder(_cfg(**{"train.mixed_precision": "false"}),
                device="cpu").model()
    assert compute_dtype(m) == torch.float32
    assert is_fast_r50(m)                     # the CPU runs plain versions
    assert not is_fast_r50(m.to("meta"))      # the kernels are bf16


def test_gate_takes_the_ema_model_a_checkpoint_serves(r50):
    """cli.serve --ckpt serves TrainState.for_eval(): the EMA copy keeps
    the compute dtype, so it takes the same route."""
    from tpupose_torch.engine.train_state import TrainState

    b = Builder(_cfg(), device="cpu")
    m = b.model()
    ev = TrainState(m, b.optimizer(m, 1), ema_decay=0.999).for_eval()
    assert ev is not m and compute_dtype(ev) == torch.bfloat16
    assert is_fast_r50(ev.to("meta"))


def _assert_bf16_folds(w):
    assert w["stem"]["w"].dtype == torch.bfloat16
    assert w["stem"]["bias"].dtype == torch.float32
    for blk in w["layer1"] + [w["bridge"]]:
        for k, t in blk.items():
            want = torch.float32 if k[0] == "b" else torch.bfloat16
            assert t.dtype == want, k


def test_folded_weights_are_bf16_from_float32_masters(r50):
    _assert_bf16_folds(fold_fast_r50(r50))


def test_cli_predictor_folds_bf16_weights():
    from tpupose_torch.cli.serve import build_predictor

    pred = build_predictor(_cfg(), "", device="cpu")
    ev = pred.evaluator
    assert ev.fast_weights is not None and ev.fast_dtype == torch.bfloat16
    _assert_bf16_folds(ev.fast_weights)


def test_route_heatmaps_match_the_autocast_forward(r50):
    """Two 256x192 crops through the evaluator's forward (the route: plain
    versions of K1-K3 in bf16, then the model's tail under its autocast)
    against model(x), which runs under the same autocast."""
    from tpupose_torch.engine.evaluator import TopDownEvaluator
    from tpupose_torch.ops.preprocess import normalize_images

    ev = TopDownEvaluator(r50, (64, 48), device="cpu")
    assert ev.fast_weights is not None
    crops = np.random.default_rng(0).integers(0, 256, (2, 256, 192, 3),
                                              dtype=np.uint8)
    x = normalize_images(torch.from_numpy(crops))
    got = ev.forward(x).float()
    with torch.no_grad():
        want = r50(x).float()
    assert got.shape == want.shape == (2, 64, 48, 17)
    assert torch.isfinite(got).all()
    d = (got - want).abs()
    den = want.abs().max()
    assert (d.max() / den).item() < 0.06
    assert (d.mean() / den).item() < 5e-3


def test_cuda_tensor_bridge_launches_the_kernel_or_raises(monkeypatch):
    """K3's wrapper on (fake) CUDA tensors: it goes to csrc/bridge.cu
    (here a stubbed build that records the launch), never to the plain
    version, and raises ValueError on what the kernel does not take: an
    odd count of 8x8 output tiles per image (a cluster takes two), or
    weights not folded on the card (without their tensor maps)."""
    import warnings

    from torch._subclasses.fake_tensor import FakeTensorMode

    from tpupose_torch.ops import _build, cuda_bridge

    def plain(*a, **k):
        raise AssertionError("the plain version was reached for CUDA")

    launched = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(cuda_bridge, "bridge_reference", plain)
    monkeypatch.setattr(_build, "bind", lambda src, name, argtypes: (
        lambda *args: launched.append((src, name, args[6:9])) or 0))
    monkeypatch.setattr(_build, "stream_of", lambda t: 0)
    monkeypatch.setattr(cuda_bridge, "_MAPS_CACHE", type(
        cuda_bridge._MAPS_CACHE)())
    n0 = cuda_bridge.bridge.launches
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)   # fake data_ptr()
        with FakeTensorMode(allow_non_fake_inputs=True):
            w = {k: torch.empty(shp, device="cuda", dtype=torch.float32
                                if k[0] == "b" else torch.bfloat16)
                 for k, shp in cuda_bridge._SHAPES.items()}
            w["tmaps"] = torch.empty(512, dtype=torch.uint8)
            x = torch.empty((2, 64, 48, 256), dtype=torch.bfloat16,
                            device="cuda")
            out = cuda_bridge.bridge(x, w)
            x48 = torch.empty((2, 48, 48, 256), dtype=torch.bfloat16,
                              device="cuda")
            with pytest.raises(ValueError, match="even count"):
                cuda_bridge.bridge(x48, w)                # 3 x 3 tiles
            with pytest.raises(ValueError, match="tensor maps"):
                cuda_bridge.bridge(x, {k: v for k, v in w.items()
                                       if k != "tmaps"})
            with pytest.raises(ValueError, match="bfloat16"):
                cuda_bridge.bridge(torch.empty((2, 64, 48, 256),
                                               device="cuda"), w)
    assert out.device.type == "cuda" and tuple(out.shape) == (2, 32, 24, 512)
    # the op encodes the tensor maps of the weights it is given (once per
    # set of addresses), then launches
    assert launched == [("bridge.cu", "tp_bridge_weight_maps", ()),
                        ("bridge.cu", "tp_bridge", (2, 64, 48))]
    assert cuda_bridge.bridge.launches == n0 + 1


def test_layer1_tiles_fit_the_r50_shape():
    """K2's tile rule (csrc/bottleneck.cu, mirrored by check_tiles): the
    R50 layer1 output 64x48 splits into 4 x 6 tiles of 16x8, an even count
    (a cluster takes two); other shapes are refused; the kernel's shared
    memory fits the card's 227 KB."""
    from tpupose_torch.ops import cuda_layer1

    cuda_layer1.check_tiles(64, 48)
    cuda_layer1.check_tiles(32, 16)
    for h, w in ((48, 40), (56, 48), (64, 44), (16, 8)):
        with pytest.raises(ValueError, match="16x8"):
            cuda_layer1.check_tiles(h, w)
    assert cuda_layer1._smem_bytes() <= 232448


def test_cuda_tensor_layer1_launches_the_kernel_or_raises(monkeypatch):
    """K2's wrapper on (fake) CUDA tensors: three launches of
    csrc/bottleneck.cu (variant 0, then 1 twice; here a stubbed build that
    records them), never the plain version; ValueError on an odd count of
    16x8 tiles per image and on a float32 input."""
    import warnings

    from torch._subclasses.fake_tensor import FakeTensorMode

    from tpupose_torch.ops import _build, cuda_layer1

    def plain(*a, **k):
        raise AssertionError("the plain version was reached for CUDA")

    launched = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(cuda_layer1, "layer1_reference", plain)
    monkeypatch.setattr(cuda_layer1, "bottleneck_reference", plain)
    monkeypatch.setattr(_build, "bind", lambda src, name, argtypes: (
        lambda *args: launched.append((src, name, args[9:13])) or 0))
    monkeypatch.setattr(_build, "stream_of", lambda t: 0)
    n0 = cuda_layer1.layer1.launches

    def block(cin, ds):
        shp = {"w1": (cin, 64), "w2": (3, 3, 64, 64), "w3": (64, 256),
               "b1": (64,), "b2": (64,), "b3": (256,)}
        if ds:
            shp["wds"] = (cin, 256)
        return {k: torch.empty(s, device="cuda", dtype=torch.float32
                               if k[0] == "b" else torch.bfloat16)
                for k, s in shp.items()}

    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)   # fake data_ptr()
        with FakeTensorMode(allow_non_fake_inputs=True):
            w = [block(64, True), block(256, False), block(256, False)]
            x = torch.empty((2, 64, 48, 64), dtype=torch.bfloat16,
                            device="cuda")
            out = cuda_layer1.layer1(x, w)
            with pytest.raises(ValueError, match="even count"):
                cuda_layer1.layer1(x.new_empty((2, 48, 40, 64)), w)
            with pytest.raises(ValueError, match="bfloat16"):
                cuda_layer1.layer1(torch.empty((2, 64, 48, 64),
                                               device="cuda"), w)
    assert out.device.type == "cuda" and tuple(out.shape) == (2, 64, 48, 256)
    assert launched == [("bottleneck.cu", "tp_bottleneck", (v, 2, 64, 48))
                        for v in (0, 1, 1)]
    assert cuda_layer1.layer1.launches == n0 + 3


def test_cuda_tensor_stem_launches_the_kernel_or_raises(monkeypatch):
    """K1's wrapper on (fake) CUDA tensors: it goes to csrc/stem.cu (here
    a stubbed build that records the launch) with the wgmma N that
    stem_tile chose, never to the plain version, and raises ValueError on
    a float32 input or weights that are not bf16."""
    import warnings

    from torch._subclasses.fake_tensor import FakeTensorMode

    from tpupose_torch.ops import _build, cuda_stem

    def plain(*a, **k):
        raise AssertionError("the plain version was reached for CUDA")

    launched = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(cuda_stem, "stem_pool_reference", plain)
    monkeypatch.setattr(_build, "bind", lambda src, name, argtypes: (
        lambda *args: launched.append((src, name, args[4:8])) or 0))
    monkeypatch.setattr(_build, "stream_of", lambda t: 0)
    n0 = cuda_stem.stem_pool.launches
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)   # fake data_ptr()
        with FakeTensorMode(allow_non_fake_inputs=True):
            w = {"w": torch.empty((7, 7, 3, 64), dtype=torch.bfloat16,
                                  device="cuda"),
                 "bias": torch.empty(64, device="cuda")}
            x = torch.empty((2, 256, 192, 3), dtype=torch.bfloat16,
                            device="cuda")
            out = cuda_stem.stem_pool(x, w)
            wide = cuda_stem.stem_pool(torch.empty(
                (1, 384, 288, 3), dtype=torch.bfloat16, device="cuda"), w)
            with pytest.raises(ValueError, match="bfloat16"):
                cuda_stem.stem_pool(torch.empty((2, 256, 192, 3),
                                                device="cuda"), w)
            with pytest.raises(ValueError, match="fold_stem_weights"):
                cuda_stem.stem_pool(x, {"w": w["w"].float(),
                                        "bias": w["bias"]})
    assert out.device.type == "cuda" and tuple(out.shape) == (2, 64, 48, 64)
    assert tuple(wide.shape) == (1, 96, 72, 64)
    assert launched == [("stem.cu", "tp_stem_pool", (2, 256, 192, 104)),
                        ("stem.cu", "tp_stem_pool", (1, 384, 288, 152))]
    assert cuda_stem.stem_pool.launches == n0 + 2


@pytest.mark.parametrize("hw,want", [
    ((256, 192), (104, 1, 4)), ((384, 288), (152, 1, 6)),
    ((37, 53), (104, 1, 1)), ((64, 64), (104, 1, 1)),
    ((1024, 1024), (152, 4, 16)), ((3, 1), (104, 1, 1))])
def test_stem_tile_and_shared_memory(hw, want):
    """K1's chooser (mirrored from csrc/stem.cu): wgmma N 104 while one
    chunk of 51 pooled columns covers the width, else 152 with chunks of
    75; strips of 16 pooled rows; the chunks cover every pooled column and
    the shared memory of either N fits the card's 227 KB."""
    from tpupose_torch.ops import cuda_stem

    nt, chunks, strips = cuda_stem.stem_tile(*hw)
    assert (nt, chunks, strips) == want
    hp, wp = (cuda_stem._pooled(n) for n in hw)
    pc = (nt - 1) // 2
    assert (chunks - 1) * pc < wp <= chunks * pc
    assert (strips - 1) * 16 < hp <= strips * 16
    # a chunk's conv columns 2 p0 - 1 .. 2 p0 + 2 pc - 1 fit the wgmma's N
    assert 2 * pc + 1 <= nt
    assert cuda_stem._smem_bytes(nt) <= 232448
