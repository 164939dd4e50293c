"""The port's XLA-style int8 engine (ops/int8_engine: `fold_hrnet_pose`,
`folded_fp32_forward`, `_assign_store`, `_defer_requant`, `_scale_map`,
`_forward_int8`, `Int8Engine`) held against tpupose/ops/int8_engine.py on
the CPU, on the models of tests/test_torch_quant.py.

Tolerances, with their reasons:
  - the folded float32 graph: 1e-4 of the heatmaps' range;
  - each side's own build: the same nodes and storage, calibration within
    1e-5, int8 weights within 1 count (XLA folds BatchNorm with rsqrt, so
    the folded weights differ in the last float32 bit), their steps and
    biases within 1e-6; the engine's heatmaps against the model's float32
    forward within tests/test_pallas_engine.py's int8 bounds (max 0.15,
    mean 0.02 of the range), as JAX's own engine;
  - the int8 forward given the same int8 weights and scales: equal to
    JAX's in every element (JAX run op by op, so XLA fuses no multiply and
    add into an FMA), which is within the bar of one int8 step on under 1%
    of the elements. Two independent builds are not compared element by
    element: a scale 1e-6 apart moves a rounding boundary, one int8 count
    changes, and a randomly initialised network amplifies it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpupose.ops import int8_engine as j_int8
from tpupose_torch.ops import int8_engine as t_int8
from tpupose_torch.ops.preprocess import normalize_images

from test_torch_quant import (  # noqa: F401
    HW, _imgs, _pair, _rel, one_torch_thread, tiny_spec)

T = torch.from_numpy


@pytest.fixture(scope="module")
def models(tiny_spec):  # noqa: F811
    return {n: _pair(n) for n in HW}


@pytest.mark.parametrize("name,hw", [("resnet50", (64, 64)),
                                     ("resnet50", (100, 100)),
                                     ("hrnet_t8", (64, 64)),
                                     ("hrnet_t8", (100, 100))],
                         ids=["r50-64x64", "r50-100x100", "hrnet-64x64",
                              "hrnet-100x100"])
def test_folded_fp32_forward_matches_jax(name, hw):
    """tpupose's folded_fp32_forward against the port's on the same
    weights; 100x100 gives non-integer fuse ratios and an odd-sized
    ResNet."""
    if name == "resnet50":
        from test_torch_model import _flax_pair

        jm, v, tm = _flax_pair("resnet50", deconv=(32, 32, 32))
    else:
        _, v, tm, _ = _pair(name, seed=5, hw=hw)
    imgs = np.random.RandomState(6).randint(0, 256, (2, *hw, 3)).astype(
        np.uint8)
    want = np.asarray(j_int8.folded_fp32_forward(v, name)(imgs))
    got = t_int8.folded_fp32_forward(tm)(T(imgs)).numpy()
    assert np.abs(got - want).max() / np.abs(want).max() < 1e-4


def _engine_build(models, name, **kw):
    jm, v, tm, _ = models[name]
    imgs = _imgs(name)
    je = j_int8.Int8Engine.build(v, backbone=name, calib=imgs, **kw)
    te = t_int8.Int8Engine.build(tm, calib=imgs, device="cpu", **kw)
    return je, te, imgs


@pytest.fixture(scope="module")
def builds(models):
    """Each side's default build (bf16 storage) of both models."""
    return {n: _engine_build(models, n) for n in HW}


@pytest.mark.parametrize("name", list(HW))
def test_int8_engine_build_matches_jax(models, builds, name):
    """The port's own build against JAX's: the same node names and
    storage, calibration within 1e-5, int8 weights within 1 count (and
    their steps and biases within 1e-6); both engines' heatmaps within
    the int8 bounds of the float32 model."""
    je, te, imgs = builds[name]
    conv = [n for n in je._nodes if n.kind == "conv"]
    assert [n.spec.name for n in conv] == [
        n.spec.name for n in te._nodes if n.kind == "conv"]
    assert [(n.kind, n.store, n.quant) for n in je._nodes] == [
        (n.kind, n.store, n.quant) for n in te._nodes]
    np.testing.assert_allclose(te._scales, je._scales, rtol=1e-5)
    for n in conv:
        wq, ws, b = te._qw[n.spec.name]
        jwq, jws, jb = (np.asarray(a) for a in je._qw[n.spec.name])
        want = jwq if not n.spec.deconv else jwq[::-1, ::-1]
        assert np.abs(wq.numpy().astype(int) - want.astype(int)).max() <= 1
        np.testing.assert_allclose(ws.numpy(), jws, rtol=1e-6)
        np.testing.assert_allclose(b.numpy(), jb, rtol=1e-6,
                                   atol=1e-6 * np.abs(jb).max())
    _, _, tm, _ = models[name]
    with torch.no_grad():
        hm32 = tm(normalize_images(T(imgs), dtype=torch.float32)).numpy()
    for label, hm in (("port", te(imgs).numpy()),
                      ("jax", np.asarray(je(imgs)))):
        mrel, meanrel = _rel(hm, hm32)
        print(f"{name} {label} Int8Engine vs float32: max rel {mrel:.3g}, "
              f"mean rel {meanrel:.3g}")
        assert mrel < 0.15 and meanrel < 0.02, (label, mrel, meanrel)


def _shared_forward(je, te, imgs):
    """JAX's _forward_int8, op by op, on the port engine's int8 weights
    (deconvs rotated to the flax orientation) and scales."""
    kinds = {n.spec.name: n.spec.deconv for n in te._nodes if n.kind == "conv"}
    qw = {k: (jnp.asarray(wq.numpy()[::-1, ::-1] if kinds[k]
                          else wq.numpy()),
              jnp.asarray(ws.numpy()), jnp.asarray(b.numpy()))
          for k, (wq, ws, b) in te._qw.items()}
    with jax.disable_jit():
        return np.asarray(j_int8._forward_int8(
            je._nodes, qw, te._scales, je._pad, je._in_pad,
            jnp.asarray(imgs)))


@pytest.mark.parametrize("name,kw", [
    ("hrnet_t8", {}),
    ("resnet18", {"min_int8_channels": 0}),
    ("resnet18", {"min_int8_channels": 64, "defer_requant": True})],
    ids=["hrnet-bf16-store", "r18-int8-store", "r18-mixed-deferred"])
def test_int8_forward_equals_jax_given_the_same_weights(models, builds, name,
                                                        kw):
    """Given the same int8 weights and scales, the port's _forward_int8
    and JAX's agree in every element: bf16 storage with requant on read
    (the default), int8 storage with the requant in the epilogue, and
    the mixed policy with _defer_requant's float32 branches."""
    je, te, imgs = builds[name] if not kw else _engine_build(models, name,
                                                             **kw)
    assert [n.store for n in je._nodes] == [n.store for n in te._nodes]
    if kw.get("defer_requant"):
        assert any(n.kind == "conv" and not n.quant and n.spec.name
                   != "final" for n in te._nodes)
    want = _shared_forward(je, te, imgs)
    got = te(imgs).numpy()
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)
