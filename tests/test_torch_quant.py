"""The port's post-training quantization (ops/quant: the exact int8
products, `calibrate`, the intercept `make_quant_interceptor` /
`quantized_apply`) held against the JAX package on the CPU. The
Int8Engine is held in tests/test_torch_int8_engine.py, eval.int8 and
eval.int8_engine through Trainer.evaluate in
tests/test_torch_int8_eval.py.

Models are tiny: a SimpleBaseline-R18 (deconvs of 32) at 64x64 and the
width-8 HRNet "hrnet_t8" (one module per stage) at 64x48, float32, with
non-trivial BatchNorm statistics; inputs from numpy seeds. The port's
module names meet JAX's flax paths through the converters' `paths=`.

Tolerances, with their reasons:
  - the int8 products: exact (compared with float64 products);
  - calibration amax: 1e-5 relative (float32 sums in another order);
  - the intercept's heatmaps, given JAX's scales: within 5e-2 of the
    range at most and 5e-3 on average (the float32 layers between the
    int8 products sum in another order, so an activation meets a
    rounding boundary on one side only now and then, moves one int8
    count, and a randomly initialised network amplifies it);
  - a single int8 Dense or ConvTranspose: float32 rounding.
"""


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpupose.models.backbones import hrnet as jhrnet
from tpupose.models.simple_baseline import SimpleBaseline as JSimpleBaseline
from tpupose.ops import quant as j_quant
from tpupose.ops.preprocess import normalize_images as j_norm
from tpupose_torch.models.backbones import hrnet as thrnet
from tpupose_torch.models.backbones.hrnet import HRNetPose
from tpupose_torch.models.simple_baseline import SimpleBaseline
from tpupose_torch.ops import int8_engine as t_int8
from tpupose_torch.ops import quant as t_quant
from tpupose_torch.ops.preprocess import normalize_images
from tpupose_torch.utils.convert import (from_flax_hrnet,
                                         from_flax_simple_baseline)

from test_torch_model import _randomize_bn

T = torch.from_numpy
TINY = {"width": 8, "modules": (1, 1, 1)}
K = 4
HW = {"resnet18": (64, 64), "hrnet_t8": (64, 48)}


@pytest.fixture(scope="module", autouse=True)
def tiny_spec():
    mp = pytest.MonkeyPatch()
    mp.setitem(jhrnet.HRNET_SPECS, "hrnet_t8", TINY)
    mp.setitem(thrnet.HRNET_SPECS, "hrnet_t8", TINY)
    yield
    mp.undo()


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """torch on one CPU thread for the module: the suite runs files in
    parallel worker processes, and a pool of a thread a core in each of
    them oversubscribes the cores, where its OpenMP barriers spin (a
    6-second HRNet training took minutes beside the other workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(name, seed=0, hw=None):
    """(flax model, variables, port model, {port name: flax path})."""
    hw = hw or HW[name]
    if name == "resnet18":
        jm = JSimpleBaseline(backbone="resnet18", num_keypoints=K,
                             deconv_channels=(32, 32, 32), dtype=jnp.float32)
    else:
        jm = jhrnet.HRNetPose(variant=name, num_keypoints=K,
                              dtype=jnp.float32)
    init = jax.jit(jm.init, static_argnames="train")
    v = init(jax.random.PRNGKey(seed), jnp.zeros((1, *hw, 3)), train=False)
    v = jax.tree_util.tree_map(lambda a: np.array(a, np.float32), v)
    v = _randomize_bn(v, np.random.RandomState(seed + 1))
    paths = {}
    if name == "resnet18":
        tm = SimpleBaseline("resnet18", K, (32, 32, 32), dtype=torch.float32,
                            device="cpu")
        tm.load_state_dict(from_flax_simple_baseline(v, paths))
    else:
        tm = HRNetPose(name, K, dtype=torch.float32, device="cpu")
        tm.load_state_dict(from_flax_hrnet(v, paths))
    return jm, v, tm, paths


@pytest.fixture(scope="module")
def models(tiny_spec):
    return {n: _pair(n) for n in HW}


def _imgs(name, n=2, seed=2):
    return np.random.RandomState(seed).randint(
        0, 256, (n, *HW[name], 3)).astype(np.uint8)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    den = max(np.abs(want).max(), 1e-12)
    return np.abs(got - want).max() / den, np.abs(got - want).mean() / den


# ---------------------------------------------------------------------------
# exact int8 products
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["3x3s1", "3x3s2", "1x1s2", "stem27",
                                  "deconv4x4s2"])
def test_int8_products_are_exact(case):
    """int8_conv2d / int8_conv_transpose2d (torch._int_mm on an im2col,
    K and N padded to multiples of 8, M to 17 rows) against float64
    convolutions of the same integers: equal."""
    import torch.nn.functional as F

    rs = np.random.RandomState(3)
    cin, cout, k, s = {"3x3s1": (24, 17, 3, 1), "3x3s2": (16, 40, 3, 2),
                       "1x1s2": (32, 8, 1, 2), "stem27": (3, 64, 3, 2),
                       "deconv4x4s2": (16, 12, 4, 2)}[case]
    x = T(rs.randint(-127, 128, (2, 7, 5, cin)).astype(np.int8))
    w = T(rs.randint(-127, 128, (k, k, cin, cout)).astype(np.int8))
    xd = x.double().permute(0, 3, 1, 2)
    if case.startswith("deconv"):
        got = t_quant.int8_conv_transpose2d(x, w, (2, 2), (1, 1))
        want = F.conv_transpose2d(xd, w.double().permute(2, 3, 0, 1),
                                  stride=2, padding=1)
    else:
        p = k // 2
        got = t_quant.int8_conv2d(x, w, (s, s), ((p, p), (p, p)))
        want = F.conv2d(xd, w.double().permute(3, 2, 0, 1), stride=s,
                        padding=p)
    assert got.dtype == torch.int32
    assert torch.equal(got.double(), want.permute(0, 2, 3, 1))


def test_engine_products_go_through_int_mm_and_are_exact(monkeypatch):
    """Every conv of the CPU Int8Engine's HRNet forward is one
    torch._int_mm whose int32 result equals the float64 product of its
    operands."""
    tm = HRNetPose("hrnet_t8", K, dtype=torch.float32, device="cpu",
                   generator=torch.Generator().manual_seed(0))
    imgs = _imgs("hrnet_t8")
    eng = t_int8.Int8Engine.build(tm, calib=imgs, device="cpu")
    real, seen = torch._int_mm, []

    def spy(a, b):
        out = real(a, b)
        seen.append(torch.equal(out.double(), a.double() @ b.double()))
        return out

    monkeypatch.setattr(torch, "_int_mm", spy)
    eng(imgs)
    assert len(seen) == sum(n.kind == "conv" for n in eng._nodes)
    assert all(seen)


# ---------------------------------------------------------------------------
# the PTQ intercept
# ---------------------------------------------------------------------------


def _jax_scales(jm, v, imgs):
    return j_quant.calibrate(jm.apply, v, [jnp.asarray(imgs)],
                             preprocess=lambda im: j_norm(
                                 im, dtype=jnp.float32), train=False)


@pytest.mark.parametrize("name", list(HW))
def test_calibrate_matches_jax(models, name):
    """{port module name: amax} against JAX's {flax path: amax}: the same
    layers, each within 1e-5."""
    jm, v, tm, paths = models[name]
    imgs = _imgs(name)
    want = _jax_scales(jm, v, imgs)
    got = t_quant.calibrate(tm, [T(imgs)], preprocess=lambda b:
                            normalize_images(b, dtype=torch.float32))
    assert {paths[n] for n in got} == set(want)
    for n, a in got.items():
        assert a == pytest.approx(want[paths[n]], rel=1e-5), n


@pytest.mark.parametrize("name", list(HW))
def test_quantized_apply_matches_jax(models, name):
    """The intercept's heatmaps with JAX's scales (carried to the port's
    names) against tpupose's quantized_apply: within the whole-chain
    bounds (module docstring); the forward of every module is restored
    afterwards."""
    jm, v, tm, paths = models[name]
    imgs = _imgs(name)
    jsc = _jax_scales(jm, v, imgs)
    scales = {n: jsc[p] for n, p in paths.items()}
    x = j_norm(jnp.asarray(imgs), dtype=jnp.float32)
    want = np.asarray(jax.jit(lambda a: j_quant.quantized_apply(
        jm.apply, v, jsc, a, train=False))(x))
    got = t_quant.quantized_apply(tm, scales, normalize_images(
        T(imgs), dtype=torch.float32)).numpy()
    mrel, meanrel = _rel(got, want)
    assert mrel < 5e-2 and meanrel < 5e-3, (mrel, meanrel)
    assert not any("forward" in vars(m) for m in tm.modules())


def test_interceptor_restores_on_exception_and_skips_what_it_cannot():
    """The forwards come back when the body raises; grouped and dilated
    convs and uncalibrated layers keep their own forward."""
    m = torch.nn.Sequential(torch.nn.Conv2d(8, 8, 3, padding=1),
                            torch.nn.Conv2d(8, 8, 3, padding=1, groups=2),
                            torch.nn.Conv2d(8, 8, 3, padding=2, dilation=2),
                            torch.nn.Linear(4, 4), torch.nn.Conv2d(8, 8, 1))
    scales = {"0": 1.0, "1": 1.0, "2": 1.0, "3": 1.0}
    with pytest.raises(RuntimeError, match="boom"):
        with t_quant.make_quant_interceptor(m, scales):
            assert [("forward" in vars(mod)) for mod in m] == \
                [True, False, False, True, False]
            raise RuntimeError("boom")
    assert not any("forward" in vars(mod) for mod in m)


def test_int8_dense_and_deconv_match_jax():
    """One nn.Linear and one 4x4/2 ConvTranspose2d in int8, against the
    JAX intercept's flax Dense and ConvTranspose on the same weights
    (the flax kernel is the torch one rotated 180 degrees): equal to
    float32 rounding."""
    import flax.linen as nn

    from tpupose_torch.utils.convert import deconv_weight

    rs = np.random.RandomState(7)
    kd = rs.normal(0, 0.2, (12, 10)).astype(np.float32)
    bd = rs.normal(0, 0.1, 10).astype(np.float32)
    kt = rs.normal(0, 0.2, (4, 4, 6, 5)).astype(np.float32)
    xd = rs.normal(0, 1, (3, 12)).astype(np.float32)
    xt = rs.normal(0, 1, (2, 5, 4, 6)).astype(np.float32)
    dense, deconv = nn.Dense(10), nn.ConvTranspose(
        5, (4, 4), (2, 2), padding="SAME", use_bias=False)
    want_d = j_quant.quantized_apply(
        dense.apply, {"params": {"kernel": kd, "bias": bd}}, {"": 2.5},
        jnp.asarray(xd))
    want_t = j_quant.quantized_apply(
        deconv.apply, {"params": {"kernel": kt}}, {"": 3.0}, jnp.asarray(xt))
    lin = torch.nn.Linear(12, 10)
    ct = torch.nn.ConvTranspose2d(6, 5, 4, 2, 1, bias=False)
    with torch.no_grad():
        lin.weight.copy_(T(kd.T.copy()))
        lin.bias.copy_(T(bd))
        ct.weight.copy_(deconv_weight(kt))
    got_d = t_quant.quantized_apply(lin, {"": 2.5}, T(xd)).numpy()
    got_t = t_quant.quantized_apply(ct, {"": 3.0}, T(xt).permute(
        0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got_d, np.asarray(want_d), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(got_t, np.asarray(want_t), rtol=1e-6,
                               atol=1e-6)


def test_int8_engine_rejects_what_it_does_not_serve():
    with pytest.raises(ValueError, match="SimpleBaseline"):
        t_int8.Int8Engine.build(torch.nn.Linear(2, 2), calib=np.zeros(
            (1, 64, 48, 3), np.uint8), device="cpu")
    r18 = SimpleBaseline("resnet18", K, (8,), dtype=torch.float32,
                         device="cpu")
    with pytest.raises(ValueError, match="calibration"):
        t_int8.Int8Engine.build(r18, calib=(), device="cpu")
