"""Boundaries of the port: tpupose_torch and chip_smoke.py import neither
JAX nor the JAX package, and a CUDA request without CUDA raises instead
of running on the CPU."""

import ast
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]


def _port_files():
    return sorted((ROOT / "tpupose_torch").rglob("*.py")) + [
        ROOT / "chip_smoke.py"]


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_jax_and_no_tpupose(path):
    tree = ast.parse(path.read_text(), str(path))
    for node in ast.walk(tree):
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        for n in names:
            top = n.split(".")[0]
            assert top not in ("jax", "jaxlib", "flax", "optax", "tpupose"), \
                f"{path.relative_to(ROOT)} imports {n}"


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_cuda_request_raises_without_cuda(no_cuda):
    from tpupose_torch import resolve_device
    from tpupose_torch.models.simple_baseline import SimpleBaseline

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        SimpleBaseline("resnet18", 4, (8,))       # default device="cuda"
    assert resolve_device("cpu") == torch.device("cpu")


def test_predictor_defaults_to_cuda(no_cuda):
    from tpupose_torch.engine.predictor import HeatmapPredictor
    from tpupose_torch.models.simple_baseline import SimpleBaseline

    m = SimpleBaseline("resnet18", 4, (8,), dtype=torch.float32,
                       device="cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        HeatmapPredictor(m, (16, 16))
    c, s = HeatmapPredictor(m, (16, 16), device="cpu")(
        np.zeros((2, 64, 64, 3), np.uint8))
    assert c.shape == (2, 4, 2) and s.shape == (2, 4)


def test_server_on_cpu_coalesces():
    """The port's PoseServer over a CPU predictor: concurrent .npy posts
    come back with K keypoints each."""
    import io
    import json
    import threading
    import urllib.request

    from tpupose_torch.engine.predictor import HeatmapPredictor
    from tpupose_torch.engine.server import PoseServer
    from tpupose_torch.models.simple_baseline import SimpleBaseline

    g = torch.Generator().manual_seed(0)
    m = SimpleBaseline("resnet18", 5, (8,), dtype=torch.float32,
                       device="cpu", generator=g)
    srv = PoseServer(HeatmapPredictor(m, (16, 16), device="cpu"), (64, 64),
                     max_batch=4, window_ms=50)
    srv.start_background()
    try:
        buf = io.BytesIO()
        np.save(buf, np.random.RandomState(0).randint(
            0, 256, (64, 64, 3)).astype(np.uint8))
        body = buf.getvalue()
        out = [None] * 4

        def post(i):
            req = urllib.request.Request(
                f"http://127.0.0.1:{srv.port}/predict", data=body,
                headers={"Content-Type": "application/octet-stream"})
            with urllib.request.urlopen(req, timeout=60) as r:
                out[i] = json.loads(r.read())

        ts = [threading.Thread(target=post, args=(i,)) for i in range(4)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in ts)
        assert all(len(o["keypoints"]) == 5 for o in out)
        assert srv.batcher.stats()["requests"] == 4
    finally:
        srv.shutdown()


def test_trainer_and_cli_default_to_cuda(no_cuda, tmp_path):
    """Trainer(cfg) and the training CLI without --device ask for CUDA
    and raise where it is absent."""
    from tpupose_torch.cli.train import main
    from tpupose_torch.configs import default_config
    from tpupose_torch.engine.trainer import Trainer

    cfg = default_config()
    cfg.train.output_dir = str(tmp_path)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Trainer(cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(["model.backbone=resnet18", f"train.output_dir={tmp_path}"])


def test_cuda_tensor_warp_never_takes_the_plain_version(monkeypatch):
    """A CUDA tensor goes to the kernel (here a stubbed build that records
    the launch) and never to the plain version. Fake CUDA tensors stand
    in for real ones on a machine without a card."""
    import warnings

    from torch._subclasses.fake_tensor import FakeTensorMode

    from tpupose_torch.ops import _build, cuda_warp

    def plain(*a, **k):
        raise AssertionError("the plain version was reached for CUDA")

    launched = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(cuda_warp, "batched_affine_warp", plain)
    monkeypatch.setattr(cuda_warp, "_plain_crops", plain)
    monkeypatch.setattr(_build, "bind", lambda src, name, argtypes: (
        lambda *args: launched.append((src, name, args[3:11])) or 0))
    monkeypatch.setattr(_build, "stream_of", lambda t: 0)
    n0, c0 = cuda_warp.affine_warp.launches, \
        cuda_warp.crops_from_frames.launches
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)   # fake data_ptr()
        with FakeTensorMode(allow_non_fake_inputs=True):
            x = torch.empty((2, 16, 12, 3), dtype=torch.uint8, device="cuda")
            m = torch.empty((2, 2, 3), device="cuda")
            out = cuda_warp.affine_warp(x, m, (9, 7))
            crops = cuda_warp.crops_from_frames(x, torch.empty(
                (6, 2, 3), device="cuda"), (8, 6))
    assert out.device.type == "cuda" and tuple(out.shape) == (2, 9, 7, 3)
    assert tuple(crops.shape) == (6, 8, 6, 3)
    assert launched == [
        ("warp.cu", "tp_affine_warp", (1, 2, 16, 12, 3, 9, 7, 1)),
        ("warp.cu", "tp_affine_warp", (1, 6, 16, 12, 3, 8, 6, 3))]
    assert cuda_warp.affine_warp.launches == n0 + 1
    assert cuda_warp.crops_from_frames.launches == c0 + 1


def test_cuda_warp_gather_count_is_passed_or_refused(monkeypatch):
    """K7's optional gather counter: one int32 on the images' device goes
    to the kernel as its pointer (null when absent); any other tensor is
    refused before a launch."""
    import warnings

    from torch._subclasses.fake_tensor import FakeTensorMode

    from tpupose_torch.ops import _build, cuda_warp

    launched = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(_build, "bind", lambda src, name, argtypes: (
        lambda *args: launched.append(args[11]) or 0))
    monkeypatch.setattr(_build, "stream_of", lambda t: 0)
    n0 = cuda_warp.affine_warp.launches
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)   # fake data_ptr()
        with FakeTensorMode(allow_non_fake_inputs=True):
            x = torch.empty((2, 16, 12, 3), dtype=torch.uint8, device="cuda")
            m = torch.empty((2, 2, 3), device="cuda")
            cnt = torch.zeros(1, dtype=torch.int32, device="cuda")
            cuda_warp.affine_warp(x, m, (9, 7))
            cuda_warp.affine_warp(x, m, (9, 7), gather_count=cnt)
            for bad in (torch.zeros(1, device="cuda"),
                        torch.zeros(2, dtype=torch.int32, device="cuda"),
                        torch.zeros(1, dtype=torch.int32)):
                with pytest.raises(ValueError, match="gather_count"):
                    cuda_warp.affine_warp(x, m, (9, 7), gather_count=bad)
    assert len(launched) == 2 and launched[0] is None
    assert launched[1] is not None
    assert cuda_warp.affine_warp.launches == n0 + 2


def test_cuda_int8_chain_goes_to_k5_never_the_plain_version(monkeypatch):
    """The int8 engine's forward on fake CUDA crops: K1, the 16 bottleneck
    launches (K5) and the 3 deconvs (K6) reach their stubbed kernels and
    never a plain version; each block's weight maps are encoded once,
    before any launch; run_chunk.launches rises by 16 and each launch carries the
    tile that pick_tile chose. Fake CUDA tensors stand in for real ones on
    a machine without a card."""
    import dataclasses
    import warnings

    from torch._subclasses.fake_tensor import FakeTensorMode

    from tpupose_torch.models.simple_baseline import SimpleBaseline
    from tpupose_torch.ops import _build, cuda_engine, cuda_stages
    from tpupose_torch.ops.int8_engine import fold_simple_baseline

    def plain(*a, **k):
        raise AssertionError("a plain version was reached for CUDA")

    model = SimpleBaseline("resnet50", 17, dtype=torch.float32, device="cpu",
                           generator=torch.Generator().manual_seed(0))
    nodes = fold_simple_baseline(model)[0]
    n_amax = sum(1 for nd in nodes if nd.quant and nd.kind in ("conv", "add"))
    eng = cuda_engine.CudaServingEngine.from_amax(
        model, np.linspace(2.0, 9.0, n_amax), device="cpu")

    launched = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    for mod, name in ((cuda_stages, "chunk_reference"),
                      (cuda_engine, "chunk_reference"),
                      (cuda_engine, "stem_pool_reference"),
                      (cuda_engine, "deconv_reference")):
        monkeypatch.setattr(mod, name, plain)
    monkeypatch.setattr(_build, "bind", lambda src, name, argtypes: (
        lambda *args: launched.append((name, args)) or 0))
    monkeypatch.setattr(_build, "stream_of", lambda t: 0)
    # the centering before K1 is torch elementwise work, whose constants a
    # fake CUDA tensor cannot take in; stand in for it
    monkeypatch.setattr(cuda_engine, "center_raw", lambda x: torch.empty(
        x.shape, dtype=torch.float32, device=x.device))
    n0 = cuda_stages.run_chunk.launches
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)   # fake data_ptr()
        with FakeTensorMode(allow_non_fake_inputs=True):
            def card_like(t):              # a fake CUDA tensor of t's kind
                return torch.empty(t.shape, dtype=t.dtype, device="cuda")

            def on_card(obj):
                return dataclasses.replace(obj, **{
                    f.name: card_like(getattr(obj, f.name))
                    for f in dataclasses.fields(obj)
                    if isinstance(getattr(obj, f.name), torch.Tensor)})

            def with_maps(blk):            # what Int8Block.to does on a card
                return dataclasses.replace(
                    blk, tmaps=cuda_stages._weight_maps(blk))

            card = cuda_engine.CudaServingEngine(
                {k: card_like(v) for k, v in eng.stem_w.items()},
                eng.s_stem, [with_maps(on_card(b)) for b in eng.blocks],
                [on_card(d) for d in eng.deconvs], eng.num_joints,
                torch.device("cuda:0"))
            n_maps = len(launched)
            crops = torch.empty((3, 256, 192, 3), dtype=torch.uint8,
                                device="cuda")
            hm = card.forward(crops)
    assert tuple(hm.shape) == (3, 64, 48, 17) and hm.device.type == "cuda"
    names = [n for n, _ in launched]
    assert names[:n_maps] == ["tp_int8_bottleneck_weight_maps"] * 16
    assert all(b.tmaps is not None and b.tmaps.device.type == "cpu"
               for b in card.blocks)
    assert names[n_maps:] == (["tp_stem_pool"] + ["tp_int8_bottleneck"] * 16
                              + ["tp_int8_deconv"] * 3)
    assert cuda_stages.run_chunk.launches == n0 + 16
    k5 = [a for n, a in launched if n == "tp_int8_bottleneck"]
    assert [a[12:16] for a in k5[:4]] == [(3, 64, 48, 64), (3, 64, 48, 256),
                                          (3, 64, 48, 256), (3, 64, 48, 256)]
    for a, blk in zip(k5, card.blocks):
        B, H, W, cin, cmid, cout, s, th, tw, ni = a[12:22]
        assert (cin, cmid, cout, s) == (blk.cin, blk.cmid, blk.cout,
                                        blk.stride)
        ho, wo = (H - 1) // s + 1, (W - 1) // s + 1
        assert (th, tw, ni) == cuda_stages.pick_tile(
            B, ho, wo, s, cin, cmid, cout, blk.wp is not None)
        assert (a[8] is None) == (blk.wp is None)        # mp: projection
