"""The port's int8 serving path (ops/quant, ops/int8_engine, ops/cuda_stages,
ops/cuda_head, ops/cuda_engine and the int8 route of the evaluator) held
against the JAX package on the CPU. Inputs come from numpy seeds and go to
both sides; the port runs its kernels' plain versions (device="cpu").

Tolerances, with their reasons:
  - the quantizers and packers: bit-equal (same float64 arithmetic);
  - int8 tensors of the plain versions vs the JAX oracles: at most 1 count
    on under 1% of the elements. The port's products are exact; the JAX
    oracles sum int values in float32, which is not exact for the deepest
    sums (up to 4608 terms), so an occasional requant rounds the other way;
  - float32 outputs: within 1e-3 of their range (tests/test_pallas_engine.py
    bounds), or as stated at each test.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from test_torch_model import _flax_pair

from tpupose.engine.evaluator import TopDownEvaluator as JEvaluator
from tpupose.engine.train_state import TrainState
from tpupose.ops import int8_engine as j_int8
from tpupose.ops import quant as j_quant
from tpupose.ops.pallas_engine import PallasServingEngine
from tpupose.ops.pallas_head import build_deconv_spec as j_deconv_spec
from tpupose.ops.pallas_head import deconv_oracle
from tpupose.ops.pallas_stages import build_stage_chunks, chunk_oracle
from tpupose.ops.pallas_stages import quantize_per_col as j_qpc
from tpupose.ops.pallas_stem import center_raw as j_center_raw
from tpupose.ops.pallas_stem import fold_stem_weights as j_fold_stem
from tpupose.ops.pallas_stem import fused_stem_apply, stem_pool_pallas, stem_s2d
from tpupose_torch.engine.evaluator import TopDownEvaluator
from tpupose_torch.ops import int8_engine as t_int8
from tpupose_torch.ops import quant as t_quant
from tpupose_torch.ops.cuda_engine import CudaServingEngine
from tpupose_torch.ops.cuda_head import build_deconv_spec, deconv_reference
from tpupose_torch.ops.cuda_stages import (_smem_bytes, build_stage,
                                           chunk_reference, pick_tile,
                                           quantize_per_col, run_chunk)
from tpupose_torch.ops.cuda_stem import (center_raw, fold_stem_weights,
                                         stem_pool_reference)
from tpupose_torch.utils.convert import conv_weight, deconv_weight
from torch_threads import one_torch_thread  # noqa: F401

STD = np.array([0.229, 0.224, 0.225])


def _count_diff(a, b):
    a, b = np.asarray(a, np.int32), np.asarray(b, np.int32)
    assert a.shape == b.shape, (a.shape, b.shape)
    d = np.abs(a - b)
    return d.max(), (d > 0).mean()


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    den = max(np.abs(want).max(), 1e-12)
    return np.abs(got - want).max() / den, np.abs(got - want).mean() / den


# ---------------------------------------------------------------------------
# quantizers
# ---------------------------------------------------------------------------


def test_quantize_per_col_bit_equal():
    rs = np.random.RandomState(0)
    k = rs.normal(0, 0.1, (576, 96))
    k[:, 5] = 0.0                      # an all-zero column: scale 1
    k[3, 7] = 0.5 * k[:, 7].max()      # ties at .5 exercise half-to-even
    wq, sw = quantize_per_col(k)
    jwq, jsw = j_qpc(k)
    assert wq.dtype == np.int8 and np.array_equal(wq, jwq)
    assert np.array_equal(sw, jsw)


def test_quant_helpers_match_jax():
    rs = np.random.RandomState(1)
    k = rs.normal(0, 0.1, (3, 3, 16, 8)).astype(np.float32)
    wq, ws = t_quant.quantize_weight(torch.from_numpy(k))
    jwq, jws = j_quant.quantize_weight(jnp.asarray(k))
    assert np.abs(wq.numpy().astype(np.int32)
                  - np.asarray(jwq, np.int32)).max() <= 1
    np.testing.assert_allclose(ws.numpy(), np.asarray(jws), rtol=1e-7)
    x = rs.normal(0, 1, (4, 9)).astype(np.float32)
    got = t_quant.quantize_activation(torch.from_numpy(x), 2.5)
    want = j_quant.quantize_activation(jnp.asarray(x), 2.5)
    assert np.abs(got.numpy().astype(np.int32)
                  - np.asarray(want, np.int32)).max() <= 1


# ---------------------------------------------------------------------------
# stage packer + plain bottleneck vs build_stage_chunks + chunk_oracle
# ---------------------------------------------------------------------------


def _rand_stage(rs, cin, cmid, cout):
    """Two bottlenecks B_0 (projection) and B_1 in JAX layout (HWIO), float32
    values (as folded weights are), so both sides quantize the same."""
    w = {}
    for blk, ci in (("B_0", cin), ("B_1", cout)):
        w[f"{blk}/c0"] = (rs.normal(0, 0.1, (1, 1, ci, cmid)),
                          rs.normal(0, 0.05, cmid))
        w[f"{blk}/c1"] = (rs.normal(0, 0.1, (3, 3, cmid, cmid)),
                          rs.normal(0, 0.05, cmid))
        w[f"{blk}/c2"] = (rs.normal(0, 0.1, (1, 1, cmid, cout)),
                          rs.normal(0, 0.05, cout))
    w["B_0/proj"] = (rs.normal(0, 0.1, (1, 1, cin, cout)),
                     rs.normal(0, 0.05, cout))
    return {k: (a.astype(np.float32), b.astype(np.float32))
            for k, (a, b) in w.items()}


def _to_torch(weights):
    return {k: (conv_weight(v[0]), torch.from_numpy(np.asarray(v[1])))
            for k, v in weights.items()}


def _f32_scales(weights, xf, stride):
    """Calibrated scales from a float64 forward of the two blocks (torch
    convs), as the engine's calibration would give them."""
    tw = _to_torch(weights)

    def conv(h, name, s=1, pad=0):
        k, b = tw[name]
        return torch.nn.functional.conv2d(h, k.double(), b.double(),
                                          stride=s, padding=pad)

    x = torch.from_numpy(xf).double().permute(0, 3, 1, 2)
    sc, add = {}, {}
    h = torch.relu(conv(x, "B_0/c0"))
    sc["B_0/c0"] = h.max().item() / 127
    h = torch.relu(conv(h, "B_0/c1", stride, 1))
    sc["B_0/c1"] = h.max().item() / 127
    h = torch.relu(conv(h, "B_0/c2") + conv(x, "B_0/proj", stride))
    add[0] = h.max().item() / 127
    y = torch.relu(conv(h, "B_1/c0"))
    sc["B_1/c0"] = y.max().item() / 127
    y = torch.relu(conv(y, "B_1/c1", 1, 1))
    sc["B_1/c1"] = y.max().item() / 127
    add[1] = torch.relu(conv(y, "B_1/c2") + h).max().item() / 127
    return sc, add


@pytest.mark.parametrize("case", ["stride1", "stride2", "layer1_cmid64"])
def test_stage_packer_and_reference_match_jax(case):
    """Mini stages of tests/test_pallas_engine.py (B=2, 8x8, 128 -> 128 ->
    256) at stride 1 and 2, and a layer1-shaped stage whose real widths
    are 64 (cin, cmid): the JAX packer pads them to 128 lanes, the port
    does not, so the JAX side gets the input zero-padded to 128 channels."""
    stride = 2 if case == "stride2" else 1
    cin, cmid = (64, 64) if case == "layer1_cmid64" else (128, 128)
    rs = np.random.RandomState(0)
    weights = _rand_stage(rs, cin, cmid, 256)
    s_in = 0.05
    x = rs.randint(0, 90, (2, 8, 8, cin)).astype(np.int8)
    conv_scale, add_scales = _f32_scales(weights, x.astype(np.float32)
                                         * s_in, stride)
    chunks, j_out = build_stage_chunks(
        weights, conv_scale, add_scales, (0, 1), s_in, 8, 8, 128, 128,
        stride, block_prefix="B")
    blocks, t_out = build_stage(_to_torch(weights), conv_scale, add_scales,
                                (0, 1), s_in, stride, block_prefix="B")
    assert len(chunks) == 1 and len(blocks) == 2 and t_out == j_out

    # packed integers and requant vectors: the JAX matrices restricted to
    # the real widths (w2 of stride 2 is a phase layout; its scales pin it)
    args, base = chunks[0].args, 0
    for blk, meta in zip(blocks, chunks[0].metas):
        a = [np.asarray(t) for t in args[base:base + meta.n_args]]
        base += meta.n_args
        assert np.array_equal(blk.w1.numpy().T, a[0][:blk.cin, :blk.cmid])
        assert np.array_equal(blk.w3.numpy().T, a[6][:blk.cmid])
        for got, want in ((blk.m1, a[1]), (blk.b1, a[2]), (blk.m2, a[4]),
                          (blk.b2, a[5]), (blk.m3, a[7]), (blk.b3, a[8])):
            assert np.array_equal(got.numpy(), want[0, :got.shape[0]])
        if stride == 1:
            w2 = a[3].reshape(9, 128, -1)[:, :blk.cmid, :blk.cmid]
            assert np.array_equal(blk.w2.numpy().T, w2.reshape(-1, blk.cmid))
        if blk.wp is not None:
            assert np.array_equal(blk.wp.numpy().T, a[9][:blk.cin])
            assert np.array_equal(blk.mp.numpy(), a[10][0])
        else:
            assert blk.r == float(np.float32(chunks[0].metas[1].r))

    xj = np.pad(x, ((0, 0), (0, 0), (0, 0), (0, 128 - cin)))
    want = np.asarray(chunk_oracle(jnp.asarray(xj), chunks[0]))
    got = torch.from_numpy(x)
    for blk in blocks:
        got = run_chunk(got, blk)                 # CPU: the plain version
    assert got.shape == (2, 8 // stride, 8 // stride, 256)
    mx, frac = _count_diff(got.numpy(), want)
    assert mx <= 1 and frac < 0.01, (mx, frac)


def test_tiles_fit_every_r50_stage():
    """The kernel's tile choice at the R50 serving shapes: divides the
    output, at most 128 GEMM rows a block, several images only where the
    tile is the whole image, fits the 227 KB of shared memory."""
    for batch in (1, 3, 128):
        for ho, wo, s, cin, cmid, cout, proj in (
                (64, 48, 1, 64, 64, 256, True), (64, 48, 1, 256, 64, 256, False),
                (32, 24, 2, 256, 128, 512, True),
                (32, 24, 1, 512, 128, 512, False),
                (16, 12, 2, 512, 256, 1024, True),
                (16, 12, 1, 1024, 256, 1024, False),
                (8, 6, 2, 1024, 512, 2048, True),
                (8, 6, 1, 2048, 512, 2048, False)):
            th, tw, ni = pick_tile(batch, ho, wo, s, cin, cmid, cout, proj)
            assert ho % th == 0 and wo % tw == 0 and ni * th * tw <= 128
            assert ni == 1 or (th, tw) == (ho, wo)
            assert _smem_bytes(ni, th, tw, s, cmid) <= 232448


@pytest.mark.parametrize("hw", [(8, 6), (16, 12), (32, 24)],
                         ids=["deconv0", "deconv1", "deconv2"])
def test_deconv_tile_fills_a_block_at_every_r50_head_shape(hw):
    """K6's block rows (csrc/int8_deconv.cu, chosen by deconv_tile): at the
    three R50 head shapes TH whole input rows of NI images fill all 192
    GEMM rows (4 images of 8x6, one of 16x12, 8 rows of 24), TH divides h,
    several images only where TH == h; the kernel's shared memory fits the
    card's 227 KB with and without the final conv."""
    from tpupose_torch.ops import cuda_head

    h, w = hw
    th, ni = cuda_head.deconv_tile(h, w)
    assert h % th == 0 and (ni == 1 or th == h) and th * w * ni == 192
    for fin in (False, True):
        assert cuda_head._smem_bytes(256, fin) <= 232448


def test_deconv_tile_at_other_sizes():
    from tpupose_torch.ops.cuda_head import deconv_tile

    for h in range(1, 41):
        for w in range(1, 193):
            th, ni = deconv_tile(h, w)
            assert h % th == 0 and (ni == 1 or th == h)
            assert 0 < th * w * ni <= 192
    with pytest.raises(ValueError, match="width"):
        deconv_tile(4, 193)


def test_cuda_deconv_launch_carries_its_tile(monkeypatch):
    """run_deconv on (fake) CUDA tensors: one launch of
    csrc/int8_deconv.cu (a stubbed build that records it) carrying the
    tile deconv_tile chose, never the plain version, with and without the
    final conv; ValueError on widths the kernel does not take."""
    import dataclasses
    import warnings

    from torch._subclasses.fake_tensor import FakeTensorMode

    from tpupose_torch.ops import _build, cuda_head

    def plain(*a, **k):
        raise AssertionError("the plain version was reached for CUDA")

    rs = np.random.RandomState(7)
    k = torch.from_numpy(rs.normal(0, 0.1, (128, 128, 4, 4)))
    kf = torch.from_numpy(rs.normal(0, 0.2, (17, 128, 1, 1)))
    specs = [build_deconv_spec(k, torch.zeros(128), 0.04, 0.03),
             build_deconv_spec(k, torch.zeros(128), 0.04, 0.03,
                               final=(kf, torch.zeros(17), 0.03)),
             build_deconv_spec(k[:64], torch.zeros(128), 0.04, 0.03)]
    launched = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(cuda_head, "deconv_reference", plain)
    monkeypatch.setattr(_build, "bind", lambda src, name, argtypes: (
        lambda *args: launched.append((name, args[8:17])) or 0))
    monkeypatch.setattr(_build, "stream_of", lambda t: 0)
    n0 = cuda_head.run_deconv.launches
    outs = []
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)   # fake data_ptr()
        with FakeTensorMode(allow_non_fake_inputs=True):
            card = [dataclasses.replace(d, **{
                f.name: torch.empty(getattr(d, f.name).shape,
                                    dtype=getattr(d, f.name).dtype,
                                    device="cuda")
                for f in dataclasses.fields(d)
                if isinstance(getattr(d, f.name), torch.Tensor)})
                for d in specs]
            for d, hw in ((card[0], (8, 6)), (card[1], (32, 24))):
                x = torch.empty((3, *hw, 128), dtype=torch.int8,
                                device="cuda")
                outs.append(cuda_head.run_deconv(x, d))
            with pytest.raises(ValueError, match="multiples of 128"):
                cuda_head.run_deconv(torch.empty((3, 8, 6, 64),
                                                 dtype=torch.int8,
                                                 device="cuda"), card[2])
    assert [tuple(o.shape) for o in outs] == [(3, 16, 12, 128),
                                              (3, 64, 48, 17)]
    assert outs[1].dtype == torch.float32
    assert launched == [("tp_int8_deconv", (3, 8, 6, 128, 128, 0, 0, 8, 4)),
                        ("tp_int8_deconv", (3, 32, 24, 128, 128, 17, 32, 8,
                                            1))]
    assert cuda_head.run_deconv.launches == n0 + 2


# ---------------------------------------------------------------------------
# deconv packer + plain deconv vs build_deconv_spec + deconv_oracle
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fused_final", [False, True])
def test_deconv_packer_and_reference_match_jax(fused_final):
    """(2, 8, 6, 128) -> 64 channels. The port gets the flax kernel carried
    to torch ConvTranspose2d orientation (rotated 180 degrees), so equal
    phase integers pin the port's tap table for its own orientation."""
    rs = np.random.RandomState(1)
    k, b, kf, bf = (a.astype(np.float32) for a in (
        rs.normal(0, 0.1, (4, 4, 128, 64)), rs.normal(0, 0.05, 64),
        rs.normal(0, 0.2, (1, 1, 64, 17)), rs.normal(0, 0.1, 17)))
    x = rs.randint(0, 90, (2, 8, 6, 128)).astype(np.int8)
    jspec = j_deconv_spec(k, b, 0.04, 0.03,
                          final=(kf, bf, 0.03) if fused_final else None)
    spec = build_deconv_spec(
        deconv_weight(k).double(), torch.from_numpy(b), 0.04, 0.03,
        final=((conv_weight(kf).double(), torch.from_numpy(bf), 0.03)
               if fused_final else None))
    for ph in range(4):
        assert np.array_equal(spec.w[ph].numpy().T,
                              np.asarray(jspec.args[2 * ph]))
        assert np.array_equal(spec.mv[ph].numpy(),
                              np.asarray(jspec.args[2 * ph + 1])[0])
    want = np.asarray(deconv_oracle(jnp.asarray(x), jspec, 8, 6))
    got = deconv_reference(torch.from_numpy(x), spec).numpy()
    if not fused_final:
        assert got.shape == (2, 16, 12, 64) and got.dtype == np.int8
        mx, frac = _count_diff(got, want)
        assert mx <= 1 and frac < 0.01, (mx, frac)
    else:
        assert got.shape == (2, 16, 12, 17) and got.dtype == np.float32
        want = want[..., :17]
        np.testing.assert_allclose(got, want,
                                   atol=1e-3 * np.abs(want).max())


# ---------------------------------------------------------------------------
# R50: calibration, the input-scale stem, the engine end to end
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def r50():
    jm, v, tm = _flax_pair("resnet50", deconv=(256, 256, 256))
    imgs = np.random.RandomState(7).randint(
        0, 256, (2, 256, 192, 3)).astype(np.uint8)
    return jm, v, tm, imgs


@pytest.fixture(scope="module")
def engines(r50):
    """The JAX engine (interpret=True) and the port's, built once."""
    _, v, tm, imgs = r50
    return (PallasServingEngine.build(v, calib=imgs, interpret=True),
            CudaServingEngine.build(tm, calib=imgs, device="cpu"))


@pytest.fixture(scope="module")
def jax_calib(r50):
    """tpupose.ops.int8_engine's fold and calibration forward: (amax list,
    stem pad, input pad, node names)."""
    _, v, _, imgs = r50
    nodes, weights, pad, in_pad = j_int8.fold_simple_baseline(v)
    _, amax = jax.jit(lambda im: j_int8._forward_calib(
        nodes, weights, pad, in_pad, im))(jnp.asarray(imgs))
    names = [n.spec.name for n in nodes if n.kind == "conv"]
    return [float(a) for a in amax], np.asarray(pad), in_pad, names


def test_calibration_amax_matches_jax(r50, jax_calib):
    _, _, tm, imgs = r50
    want, pad, in_pad, names = jax_calib
    tn, tw, tpad, tin_pad = t_int8.fold_simple_baseline(tm)
    _, got = t_int8._forward_calib(tn, tw, tpad, tin_pad,
                                   torch.from_numpy(imgs))
    assert np.array_equal(tpad.numpy(), pad) and tin_pad == in_pad
    assert [n.spec.name for n in tn if n.kind == "conv"] == names
    want = np.asarray(want)
    got = np.asarray([float(a) for a in got])
    # the stem, 16 x (c0, c1, c2, add), 4 projections, 3 deconvs
    assert got.shape == want.shape == (1 + 16 * 4 + 4 + 3,)
    np.testing.assert_allclose(got, want, rtol=1e-4)


def test_input_scale_stem_matches_jax(r50):
    """center_raw + fold_stem_weights(input_scale=1/(255*std)) on raw
    pixels, in bf16: the port's plain stem vs the JAX Pallas stem
    (interpret mode), at the bounds of tests/test_pallas_stem.py:94."""
    _, v, tm, imgs = r50
    w = j_fold_stem(v, input_scale=1.0 / (255.0 * STD))
    xc = j_center_raw(jnp.asarray(imgs)).astype(jnp.bfloat16)
    want = np.asarray(fused_stem_apply(xc, w, interpret=True,
                                       out_channels=64), np.float32)
    tw = fold_stem_weights(tm.backbone, torch.bfloat16,
                           input_scale=1.0 / (255.0 * STD))
    x = center_raw(torch.from_numpy(imgs)).to(torch.bfloat16)
    got = stem_pool_reference(x, tw).float().numpy()
    np.testing.assert_allclose(got, want, rtol=0.05, atol=0.07)


def _jax_chain(eng, imgs):
    """The JAX engine's forward with the interpret-mode stem and the jnp
    oracles in place of run_chunk / run_deconv. Returns (heatmaps, the
    int8 input of each of the four stages, the head's int8 input)."""
    x = j_center_raw(jnp.asarray(imgs)).astype(jnp.bfloat16)
    f = stem_pool_pallas(stem_s2d(x), eng.stem_w, interpret=True)
    y = jnp.clip(jnp.round(f.astype(jnp.float32) / eng.s_stem), 0.0,
                 127.0).astype(jnp.int8)
    stage_in, it = [], iter(eng.chunks)
    for n in (3, 4, 6, 3):
        stage_in.append(np.asarray(y))
        done = 0
        while done < n:
            ch = next(it)
            y = chunk_oracle(y, ch)
            done += len(ch.metas)
    head_in = np.asarray(y)
    h, w = head_in.shape[1:3]
    for d in eng.deconvs:
        y = deconv_oracle(y, d, h, w)
        h, w = 2 * h, 2 * w
    return np.asarray(y)[..., :eng.num_joints], stage_in, head_in


@pytest.fixture(scope="module")
def jax_chain(r50, engines):
    return _jax_chain(engines[0], r50[3])


def test_engine_stages_match_jax(r50, jax_calib, jax_chain):
    """Each stage fed the same int8 input on both sides (the JAX chain's),
    the port's engine built from the JAX calibration (`from_amax`) so that
    both sides quantize with the same scales."""
    teng = CudaServingEngine.from_amax(r50[2], jax_calib[0], device="cpu")
    _, stage_in, head_in = jax_chain
    blocks = iter(teng.blocks)
    for i, n in enumerate((3, 4, 6, 3)):
        blk = [next(blocks) for _ in range(n)]
        y = torch.from_numpy(stage_in[i][..., :blk[0].cin].copy())
        for b in blk:
            y = chunk_reference(y, b)
        want = stage_in[i + 1] if i < 3 else head_in
        mx, frac = _count_diff(y.numpy(), want)
        assert mx <= 1 and frac < 0.01, (i, mx, frac)


def test_engine_heatmaps_match_jax(r50, engines, jax_chain):
    """Whole chain, uint8 -> heatmaps, each side on its own. Each stage's
    occasional 1-count differences (and stem bf16 summation order)
    propagate, so the bound is relative to the heatmaps' range: max 0.05,
    mean 2e-3 (the int8-vs-fp32 bounds of tests/test_pallas_engine.py are
    0.15 and 0.02)."""
    _, _, tm, imgs = r50
    _, teng = engines
    want = jax_chain[0]
    got = teng(imgs)
    assert got.shape == (2, 64, 48, 17) and got.dtype == torch.float32
    assert np.array_equal(got.numpy(), teng.forward_reference(imgs).numpy())
    mrel, meanrel = _rel(got.numpy(), want)
    assert mrel < 0.05 and meanrel < 2e-3, (mrel, meanrel)


def test_evaluator_int8_coords_match_jax(r50, engines):
    """uint8 -> source coords with flip test through the port's
    TopDownEvaluator(int8_engine=...) vs the JAX evaluator with the same
    engine in its int8_engine slot (a host callback). With random weights
    the heatmaps are near-flat, so the two chains' small differences would
    move argmaxes; one engine on both sides holds the evaluator's own
    composition (raw-pixel flip, merge, decode, back-projection) to the
    bounds of tests/test_torch_model.py's slice test."""
    jm, v, tm, imgs = r50
    _, teng = engines
    rs = np.random.RandomState(8)
    centers = rs.uniform(80, 120, (2, 2)).astype(np.float32)
    scales = rs.uniform(150, 250, (2, 2)).astype(np.float32)

    class Slot:                      # the JAX evaluator's int8_engine slot
        _qw = ()

        def forward_traceable(self, im, qw):
            return jax.pure_callback(
                lambda a: teng(np.array(a)).numpy(),
                jax.ShapeDtypeStruct((im.shape[0], 64, 48, 17),
                                     jnp.float32), im)

    state = TrainState(step=jnp.zeros((), jnp.int32), params=v["params"],
                       batch_stats=v["batch_stats"], opt_state=(),
                       apply_fn=jm.apply, tx=optax.sgd(0.0))
    jev = JEvaluator(state, (64, 48), decode="dark", flip_test=True,
                     int8_engine=Slot())
    want_c, want_s = jev._step(state, jnp.asarray(imgs),
                               jnp.asarray(centers), jnp.asarray(scales))
    ev = TopDownEvaluator(tm, (64, 48), decode="dark", flip_test=True,
                          device="cpu", int8_engine=teng)
    got_c, got_s = ev.step(imgs, centers, scales)
    assert got_c.shape == (2, 17, 2) and ev.fast_weights is None
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s),
                               rtol=1e-3, atol=1e-3 * np.abs(want_s).max())
    # 1e-2 px in heatmap space; back-projection scales by scale / size
    px = float(np.max(scales / np.array([48, 64])))
    np.testing.assert_allclose(got_c.numpy(), np.asarray(want_c),
                               atol=1e-2 * px)


def test_engine_rejects_bad_input(r50, engines):
    _, teng = engines
    with pytest.raises(ValueError, match="256, 192"):
        teng(np.zeros((1, 128, 96, 3), np.uint8))
    from tpupose_torch.models.simple_baseline import SimpleBaseline

    r18 = SimpleBaseline("resnet18", 4, (8,), dtype=torch.float32,
                         device="cpu")
    with pytest.raises(ValueError, match="R50"):
        CudaServingEngine.build(r18, np.zeros((1, 256, 192, 3), np.uint8),
                                device="cpu")
    with pytest.raises(ValueError, match="heatmap family"):
        TopDownEvaluator(r50[2], (64, 48), device="cpu", int8_engine=teng,
                         family="simcc")


@pytest.mark.parametrize("calib", ["empty_tuple", "empty_generator"])
def test_engine_build_rejects_empty_calibration(r50, calib):
    """A generator is listed first, so it fails as ValueError like an empty
    tuple (the JAX engine's len() check raises TypeError on it)."""
    tm = r50[2]
    arg = () if calib == "empty_tuple" else (i for i in ())
    with pytest.raises(ValueError, match="calibration"):
        CudaServingEngine.build(tm, calib=arg, device="cpu")
