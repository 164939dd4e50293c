"""tpupose_torch's ViT family against the JAX package on the CPU: the
attention plain version, 2D RoPE, ViTBlock, DinoViT, ViTPose (classic and
simple decoders) through `from_flax_vitpose`, and the whole uint8 ->
source-coords predict with flip test and DARK decode. The flax models
are built with dtype=float32 at a "tiny" size (depth 2, dim 64, 2 heads,
added to both packages' VIT_SIZES), on 64x48 images; JAX's
fused_attention takes its non-TPU branch here, as
tests/test_fused_attention.py runs it. Each trap where a natural torch
choice differs from flax has a test showing that the natural choice
misses. Tolerances: 1e-6 for the RoPE tables and rotation, 2e-5 for
attention (the bound of tests/test_fused_attention.py), 1e-4 relative
for the float32 models, 1e-3 px and 1e-5 for the predict's coords and
scores."""

import io
import json
import urllib.request
from pathlib import Path

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

from tpupose.engine.evaluator import TopDownEvaluator as JEvaluator
from tpupose.engine.train_state import TrainState as JTrainState
from tpupose.models.backbones import vit as jvit
from tpupose.models.vitpose import ViTPose as JViTPose
from tpupose.ops.attention import fused_attention as j_fused_attention
from tpupose_torch.engine.predictor import HeatmapPredictor
from tpupose_torch.models.backbones import vit as tvit
from tpupose_torch.models.vitpose import ViTPose
from tpupose_torch.ops.attention import attention_reference, fused_attention
from tpupose_torch.utils.convert import from_flax_vitpose
from torch_threads import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
VITPOSE_S = str(ROOT / "tpupose" / "configs" / "method" / "vitpose_s.yaml")
TINY = {"depth": 2, "dim": 64, "heads": 2}
HW = (64, 48)


@pytest.fixture(autouse=True)
def tiny_size(monkeypatch):
    monkeypatch.setitem(jvit.VIT_SIZES, "tiny", TINY)
    monkeypatch.setitem(tvit.VIT_SIZES, "tiny", TINY)


def _rel(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-12)


def _randomize(tree, rs):
    """Non-trivial LayerNorm affines, layer scales (O(1), so that the
    blocks do not vanish under flax's 1e-5), tokens and BatchNorm
    statistics in a flax ViTPose tree."""
    p, s = tree["params"], tree.get("batch_stats", {})
    vp = p["DinoViT_0"]
    for k in ("cls_token", "storage_tokens"):
        vp[k] = rs.normal(0, 0.5, vp[k].shape).astype(np.float32)
    for name, blk in vp.items():
        if name.startswith("ViTBlock"):
            for ls in ("ls1", "ls2"):
                blk[ls] = rs.uniform(0.2, 0.6, blk[ls].shape) \
                    .astype(np.float32)
    for d in [vp["norm"]] + [b[k] for b in vp.values()
                             if isinstance(b, dict)
                             for k in ("LayerNorm_0", "LayerNorm_1")
                             if k in b]:
        d["scale"] = rs.uniform(0.7, 1.3, d["scale"].shape) \
            .astype(np.float32)
        d["bias"] = rs.normal(0, 0.1, d["bias"].shape).astype(np.float32)
    for k in list(p):
        if k.startswith("BatchNorm"):
            n = p[k]["scale"].shape
            p[k]["scale"] = rs.uniform(0.5, 1.0, n).astype(np.float32)
            p[k]["bias"] = rs.normal(0, 0.1, n).astype(np.float32)
            s[k]["mean"] = rs.normal(0, 0.3, n).astype(np.float32)
            s[k]["var"] = rs.uniform(0.5, 2.0, n).astype(np.float32)
    return tree


def _pair(decoder, seed=0, num_keypoints=17):
    # module fixtures are built before the autouse fixture runs
    jvit.VIT_SIZES["tiny"] = TINY
    tvit.VIT_SIZES["tiny"] = TINY
    jm = JViTPose(backbone="vit_tiny", num_keypoints=num_keypoints,
                  decoder=decoder, deconv_channels=(32, 32),
                  dtype=jnp.float32)
    v = jm.init(jax.random.PRNGKey(seed), jnp.zeros((1, *HW, 3)),
                train=False)
    v = jax.tree_util.tree_map(lambda a: np.array(a, np.float32), v)
    v = _randomize(v, np.random.RandomState(seed + 1))
    tm = ViTPose("vit_tiny", num_keypoints, decoder, (32, 32),
                 dtype=torch.float32, device="cpu")
    tm.load_state_dict(from_flax_vitpose(v))
    return jm, v, tm


@pytest.fixture(scope="module")
def classic():
    return _pair("classic")


@pytest.fixture(scope="module")
def simple():
    return _pair("simple", seed=3)


def _images(seed, n=2):
    return np.random.RandomState(seed).uniform(-2, 2, (n, *HW, 3)) \
        .astype(np.float32)


# -- attention -----------------------------------------------------------------

def _sdpa(q, k, v, scale):
    """tests/test_fused_attention.py's reference."""
    s = jnp.einsum("bqhd,bkhd->bhqk", q, k).astype(jnp.float32) * scale
    p = jax.nn.softmax(s, axis=-1)
    return jnp.einsum("bhqk,bkhd->bqhd", p.astype(q.dtype), v)


@pytest.mark.parametrize("scale", [None, 0.5], ids=["default", "explicit"])
@pytest.mark.parametrize("L", [1, 17, 37])
def test_attention_reference_matches_jax(L, scale):
    rs = np.random.RandomState(L)
    q, k, v = (rs.randn(2, L, 3, 16).astype(np.float32) for _ in range(3))
    s = 1.0 / np.sqrt(16) if scale is None else scale
    got = fused_attention(*(torch.from_numpy(t) for t in (q, k, v)),
                          scale=scale).numpy()
    assert np.array_equal(got, attention_reference(
        *(torch.from_numpy(t) for t in (q, k, v)), s).numpy())
    jq, jk, jv = (jnp.asarray(t) for t in (q, k, v))
    for want in (jax.nn.dot_product_attention(jq, jk, jv, scale=s),
                 _sdpa(jq, jk, jv, s), j_fused_attention(jq, jk, jv, s)):
        np.testing.assert_allclose(got, np.asarray(want), atol=2e-5,
                                   rtol=2e-5)


def test_attention_reference_keeps_bf16_and_plain_impl():
    rs = np.random.RandomState(5)
    q, k, v = (torch.from_numpy(rs.randn(1, 9, 2, 64).astype(np.float32))
               .bfloat16() for _ in range(3))
    out = fused_attention(q, k, v, impl="plain")
    assert out.dtype == torch.bfloat16
    assert torch.equal(out, fused_attention(q, k, v))
    with pytest.raises(ValueError, match="impl"):
        fused_attention(q, k, v, impl="sdpa")


def test_cuda_tensors_go_to_the_kernel_never_the_plain_version(monkeypatch):
    """A CUDA tensor goes to K8 (a stubbed build that records the launch)
    and never to the plain version; bf16 strided views from a qkv
    projection pass, float32 and head dim 48 raise ValueError. Fake CUDA
    tensors stand in for real ones on a machine without a card."""
    import warnings

    from torch._subclasses.fake_tensor import FakeTensorMode

    from tpupose_torch.ops import _build, attention, cuda_attention

    def plain(*a, **k):
        raise AssertionError("the plain version was reached for CUDA")

    launched = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(attention, "attention_reference", plain)
    monkeypatch.setattr(_build, "bind", lambda src, name, argtypes: (
        lambda *args: launched.append((src, name, args[4:16])) or 0))
    monkeypatch.setattr(_build, "stream_of", lambda t: 0)
    n0 = cuda_attention.flash_attention.launches
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)   # fake data_ptr()
        with FakeTensorMode(allow_non_fake_inputs=True):
            qkv = torch.empty((2, 21, 3 * 2 * 64), dtype=torch.bfloat16,
                              device="cuda")
            q, k, v = qkv.view(2, 21, 3, 2, 64).unbind(2)
            out = attention.fused_attention(q, k, v)
            with pytest.raises(ValueError, match="bfloat16"):
                attention.fused_attention(q.float(), k.float(), v.float())
            x48 = torch.empty((2, 21, 2, 48), dtype=torch.bfloat16,
                              device="cuda")
            with pytest.raises(ValueError, match="got 48"):
                attention.fused_attention(x48, x48, x48)
    assert out.device.type == "cuda" and tuple(out.shape) == (2, 21, 2, 64)
    s = (21 * 384, 384, 64)
    assert launched == [("flash_attention.cu", "tp_flash_attention",
                         (2, 21, 2, *s, *s, *s))]
    assert cuda_attention.flash_attention.launches == n0 + 1


# -- RoPE --------------------------------------------------------------------

@pytest.mark.parametrize("h,w,dim", [(4, 3, 32), (16, 12, 64), (1, 5, 16)])
def test_rope_tables_match(h, w, dim):
    js, jc = jvit.rope_2d_sincos(h, w, dim)
    ts, tc = tvit.rope_2d_sincos(h, w, dim)
    assert ts.shape == (h * w, dim // 2)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-6)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_rope_matches_with_the_cast_to_q_dtype(dtype):
    """sin/cos are cast to q's dtype before the products: in bf16 the
    port equals JAX to 1e-6, and the same rotation with float32 tables
    (no cast) misses."""
    rs = np.random.RandomState(6)
    q = rs.randn(2, 12, 2, 32).astype(np.float32)
    js, jc = jvit.rope_2d_sincos(4, 3, 32)
    jq = jnp.asarray(q, getattr(jnp, dtype))
    want = np.asarray(jvit.apply_rope(jq, js, jc), np.float32)
    ts, tc = tvit.rope_2d_sincos(4, 3, 32)
    tq = torch.from_numpy(q).to(getattr(torch, dtype))
    got = tvit.apply_rope(tq, ts, tc)
    assert got.dtype == tq.dtype
    np.testing.assert_allclose(got.float().numpy(), want, atol=1e-6)
    if dtype == "bfloat16":
        d2 = 16
        q1, q2 = tq[..., :d2].float(), tq[..., d2:].float()
        s, c = ts[:, None], tc[:, None]
        uncast = torch.cat([q1 * c - q2 * s, q2 * c + q1 * s], -1)
        assert np.abs(uncast.numpy() - want).max() > 1e-3


def test_rope_is_split_half_and_patch_tokens_only(monkeypatch):
    """RopeAttention against flax (1e-5), and two natural variants that
    miss: the rotation written on interleaved pairs, and RoPE on the
    prefix tokens too (rotated like the first patches)."""
    rs = np.random.RandomState(7)
    dim, heads, p = 64, 2, 5
    x = rs.randn(2, p + 12, dim).astype(np.float32)
    js, jc = jvit.rope_2d_sincos(4, 3, dim // heads)
    jm = jvit.RopeAttention(dim, heads, p, dtype=jnp.float32)
    v = jm.init(jax.random.PRNGKey(0), jnp.asarray(x), js, jc)
    want = np.asarray(jm.apply(v, jnp.asarray(x), js, jc))
    tm = tvit.RopeAttention(dim, heads, p)
    sd = {}
    for n in ("qkv", "proj"):
        sd[f"{n}.weight"] = torch.from_numpy(
            np.asarray(v["params"][n]["kernel"]).T.copy())
        sd[f"{n}.bias"] = torch.tensor(np.asarray(v["params"][n]["bias"]))
    tm.load_state_dict(sd)
    ts, tc = tvit.rope_2d_sincos(4, 3, dim // heads)
    xt = torch.from_numpy(x)
    with torch.no_grad():
        assert _rel(tm(xt, ts, tc).numpy(), want) < 1e-5
        tm.num_prefix = 0
        every = tm(xt, torch.cat([ts[:p], ts]), torch.cat([tc[:p], tc]))
        tm.num_prefix = p
        assert _rel(every.numpy(), want) > 1e-2

        def interleaved(q, sin, cos):
            q1, q2 = q[..., 0::2], q[..., 1::2]
            s, c = sin[:, None], cos[:, None]
            return torch.stack([q1 * c - q2 * s, q2 * c + q1 * s],
                               -1).flatten(-2)

        monkeypatch.setattr(tvit, "apply_rope", interleaved)
        assert _rel(tm(xt, ts, tc).numpy(), want) > 1e-2


def test_qkv_split_is_q_k_v_first_heads_second():
    """jnp.split(qkv, 3) then (B, T, heads, hd): the port's view
    (B, T, 3, heads, hd) gives the same q; (B, T, heads, 3, hd) does
    not."""
    rs = np.random.RandomState(8)
    qkv = rs.randn(2, 7, 3 * 64).astype(np.float32)
    jq = np.asarray(jnp.split(jnp.asarray(qkv), 3, axis=-1)[0]) \
        .reshape(2, 7, 2, 32)
    t = torch.from_numpy(qkv)
    assert np.array_equal(t.view(2, 7, 3, 2, 32)[:, :, 0].numpy(), jq)
    assert not np.allclose(t.view(2, 7, 2, 3, 32)[:, :, :, 0].numpy(), jq)


# -- traps of the other layers -------------------------------------------------

def test_gelu_is_the_tanh_form():
    x = np.linspace(-4, 4, 801).astype(np.float32)
    want = np.asarray(fnn.gelu(jnp.asarray(x)))
    t = torch.from_numpy(x)
    np.testing.assert_allclose(F.gelu(t, approximate="tanh").numpy(), want,
                               atol=1e-6)
    assert np.abs(F.gelu(t).numpy() - want).max() > 1e-4


def test_layernorm_epsilon_is_1e_6():
    """Inputs with a small spread (as after a layer scale) show the
    epsilon: 1e-6 matches flax, torch's default 1e-5 misses."""
    rs = np.random.RandomState(9)
    x = (rs.randn(4, 64) * 3e-3).astype(np.float32)
    jln = fnn.LayerNorm(epsilon=1e-6, dtype=jnp.float32)
    want = np.asarray(jln.apply(jln.init(jax.random.PRNGKey(0),
                                         jnp.asarray(x)), jnp.asarray(x)))
    t = torch.from_numpy(x)
    got = F.layer_norm(t, (64,), eps=tvit.LN_EPS).numpy()
    assert tvit.ViTBlock(64, 2, 5).norm1.eps == 1e-6
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)
    assert np.abs(F.layer_norm(t, (64,)).numpy() - want).max() > 1e-2


def test_bilinear_upsample_matches_jax_resize_edges_included():
    """jax.image.resize(bilinear) x4 == F.interpolate(bilinear,
    align_corners=False, antialias=False) on a map whose edges differ
    from its interior; align_corners=True misses."""
    rs = np.random.RandomState(10)
    m = rs.randn(2, 4, 3, 5).astype(np.float32)
    m[:, 0] += 5.0
    m[:, :, -1] -= 4.0
    want = np.asarray(jax.image.resize(jnp.asarray(m), (2, 16, 12, 5),
                                       method="bilinear"))
    t = torch.from_numpy(m).permute(0, 3, 1, 2)
    got = F.interpolate(t, scale_factor=4, mode="bilinear",
                        align_corners=False, antialias=False)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                               atol=1e-5)
    corners = F.interpolate(t, scale_factor=4, mode="bilinear",
                            align_corners=True).permute(0, 2, 3, 1).numpy()
    assert np.abs(corners - want).max() > 0.1


# -- modules -------------------------------------------------------------------

def test_vit_block_matches(classic):
    _, v, tm = classic
    rs = np.random.RandomState(11)
    x = rs.randn(2, 5 + 12, 64).astype(np.float32)
    js, jc = jvit.rope_2d_sincos(4, 3, 32)
    jb = jvit.ViTBlock(64, 2, 5, dtype=jnp.float32)
    want = jb.apply({"params": v["params"]["DinoViT_0"]["ViTBlock_0"]},
                    jnp.asarray(x), js, jc)
    ts, tc = tvit.rope_2d_sincos(4, 3, 32)
    with torch.no_grad():
        got = tm.backbone.blocks[0](torch.from_numpy(x), ts, tc)
    assert _rel(got.numpy(), want) < 1e-4


def test_dino_vit_matches_every_output(classic):
    _, v, tm = classic
    x = _images(12)
    jb = jvit.DinoViT.from_size("tiny", intermediates=(0, 1),
                                dtype=jnp.float32)
    want = jb.apply({"params": v["params"]["DinoViT_0"]}, jnp.asarray(x),
                    train=False)
    tb = tm.backbone
    tb.intermediates = (0, 1)
    try:
        with torch.no_grad():
            got = tb(torch.from_numpy(x))
    finally:
        tb.intermediates = ()
    assert set(got) == set(want) == {"cls", "storage", "patches",
                                     "feature_map", "intermediates"}
    assert got["feature_map"].shape == (2, 4, 3, 64)
    assert got["storage"].shape == (2, 4, 64)
    for key in ("cls", "storage", "patches", "feature_map"):
        assert _rel(got[key].numpy(), want[key]) < 1e-4, key
    assert set(got["intermediates"]) == set(want["intermediates"]) == {0, 1}
    for i in (0, 1):
        assert _rel(got["intermediates"][i].numpy(),
                    want["intermediates"][i]) < 1e-4


@pytest.mark.parametrize("decoder", ["classic", "simple"])
def test_vitpose_matches(decoder, classic, simple):
    jm, v, tm = classic if decoder == "classic" else simple
    x = _images(13)
    want = np.asarray(jm.apply(v, jnp.asarray(x), train=False))
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    assert got.shape == (2, 16, 12, 17)
    assert _rel(got, want) < 1e-4


def test_layer_scale_hides_the_blocks_at_flax_init():
    """With flax's layer-scale init (1e-5) a wrong attention barely shows
    in the output; with O(1) layer scales it does. This is why the card
    checks draw layer scales at O(1)."""
    from tpupose_torch.models.vitpose import init_vitpose_like_flax

    x = torch.from_numpy(_images(14))
    out = {}
    for init in ("flax", "seeded"):
        g = torch.Generator().manual_seed(0)
        m = ViTPose("vit_tiny", 5, "classic", (32, 32), dtype=torch.float32,
                    device="cpu", generator=g if init == "seeded" else None)
        if init == "flax":
            init_vitpose_like_flax(m, g)
        with torch.no_grad():
            ref = m(x)
            for a in m.modules():
                if isinstance(a, tvit.RopeAttention):
                    a.proj.weight.mul_(-1.0)
            out[init] = _rel(m(x).numpy(), ref.numpy())
    assert out["flax"] < 1e-3 < 1e-1 < out["seeded"]


# -- the slice -----------------------------------------------------------------

def test_slice_predict_matches_jax_evaluator(classic):
    """uint8 crops -> flip test -> DARK -> source coords through the
    port's HeatmapPredictor on the CPU vs tpupose's TopDownEvaluator on
    the same converted weights."""
    jm, v, tm = classic
    rs = np.random.RandomState(15)
    imgs = rs.randint(0, 256, (3, *HW, 3)).astype(np.uint8)
    centers = rs.uniform(80, 120, (3, 2)).astype(np.float32)
    scales = rs.uniform(150, 250, (3, 2)).astype(np.float32)
    state = JTrainState(step=jnp.zeros((), jnp.int32), params=v["params"],
                        batch_stats=v["batch_stats"], opt_state=(),
                        apply_fn=jm.apply, tx=optax.sgd(0.0))
    jev = JEvaluator(state, (16, 12), decode="dark", flip_test=True)
    want_c, want_s = jev._step(state, jnp.asarray(imgs), jnp.asarray(centers),
                               jnp.asarray(scales))
    pred = HeatmapPredictor(tm, (16, 12), flip_test=True, device="cpu")
    assert pred.evaluator.fast_weights is None
    got_c, got_s = pred(imgs, centers, scales)
    assert got_c.shape == (3, 17, 2) and np.isfinite(got_c).all()
    np.testing.assert_allclose(got_s, np.asarray(want_s), atol=1e-5)
    np.testing.assert_allclose(got_c, np.asarray(want_c), atol=1e-3)


def test_int8_engine_with_vitpose_raises(classic):
    from tpupose_torch.engine.evaluator import TopDownEvaluator

    with pytest.raises(ValueError, match="SimpleBaseline-R50 only"):
        TopDownEvaluator(classic[2], (16, 12), device="cpu",
                         int8_engine=object())


def test_remat_and_unknown_decoder_raise():
    """SimpleBaseline's remat is ported: the Builder threads it into the
    ResNet instead of raising (its remat-equals-plain step is held in
    tests/test_torch_hrnet.py, ViTPose's in
    tests/test_torch_vit_train.py); an unknown decoder raises."""
    from tpupose_torch.engine.builder import Builder

    cfg, _ = _cfg("model.name=simple_baseline", "model.backbone=resnet18",
                  "train.remat=true")
    assert Builder(cfg, "cpu").model().backbone.remat is True
    with pytest.raises(ValueError, match="decoder"):
        ViTPose("vit_tiny", 5, "fancy", device="cpu")


# -- builder, trainer, CLI -----------------------------------------------------

def _cfg(*overrides):
    from tpupose_torch.configs import parse_args, update_config
    from tpupose_torch.configs.default import default_config

    args = parse_args(["--cfg", VITPOSE_S, "--device", "cpu", *overrides])
    return update_config(default_config(), args), args


def test_builder_builds_vitpose_s_with_the_flax_names_and_init():
    """Builder(vitpose_s.yaml).model(): ViT-S/16 with the classic decoder,
    every name and shape of the flax ViTPose tree (abstract init, nothing
    compiled), flax's init and the SimpleBaseline's dtype policy."""
    from tpupose_torch.engine.builder import Builder

    cfg, _ = _cfg()
    model = Builder(cfg, "cpu").model()
    assert isinstance(model, ViTPose)
    assert model.compute_dtype == torch.bfloat16
    assert next(model.parameters()).dtype == torch.float32
    jm = JViTPose(backbone="vit_small", num_keypoints=17,
                  deconv_channels=(256, 256))
    shapes = jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 256, 192, 3)), train=False))
    zeros = jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, np.float32), shapes)
    sd = from_flax_vitpose(zeros)
    own = model.state_dict()
    assert set(sd) == set(own)
    assert all(tuple(sd[k].shape) == tuple(own[k].shape) for k in sd)
    vit = model.backbone
    assert len(vit.blocks) == 12 and vit.dim == 384 and vit.heads == 6
    assert torch.all(vit.blocks[3].ls2.gamma == 1e-5)
    assert 0.012 < vit.storage_tokens.std().item() < 0.022
    assert vit.cls_token.abs().max().item() <= 0.04
    fc1 = vit.blocks[0].mlp.fc1.weight
    assert abs(fc1.std().item() * 384 ** 0.5 - 1.0) < 0.05
    assert torch.all(vit.blocks[0].mlp.fc1.bias == 0)


def test_trainer_builds_vitpose_on_the_cpu(tmp_path):
    """The Trainer takes vitpose_s.yaml (tiny backbone): a ViTPose in
    train mode after one step, the heatmap family, AdamW over every
    parameter with the head/base split (training itself is held in
    tests/test_torch_vit_train.py)."""
    from tpupose_torch.engine.trainer import Trainer

    cfg, _ = _cfg("model.backbone=vit_tiny", "data.image_size=[64,48]",
                  "model.heatmap_size=[16,12]",
                  "model.deconv_channels=[32,32]",
                  "train.mixed_precision=false", "train.batch_size=4",
                  f"train.output_dir={tmp_path}")
    tr = Trainer(cfg, device="cpu")
    assert isinstance(tr.model, ViTPose) and tr.family == "heatmap"
    inner = tr.state.optimizer.inner
    assert isinstance(inner, torch.optim.AdamW)
    assert {g["label"] for g in inner.param_groups} == {"base", "head"}
    assert all(g["weight_decay"] == 0.1 for g in inner.param_groups)
    assert sum(len(g["params"]) for g in inner.param_groups) == \
        len(list(tr.model.parameters()))
    m = tr.train_step(tr.state, tr._prepare_batch(
        next(iter(tr.train_loader))))
    assert tr.model.training and tr.state.step == 1
    assert np.isfinite(m["loss"].item())


def test_cli_serve_answers_a_request_on_the_cpu():
    """cli.serve on vitpose_s.yaml with --device cpu and tiny overrides:
    one .npy post through the PoseServer, 17 keypoints back."""
    from tpupose_torch.cli.serve import make_server

    cfg, args = _cfg("model.backbone=vit_tiny", "data.image_size=[64,48]",
                     "model.heatmap_size=[16,12]",
                     "model.deconv_channels=[32,32]",
                     "train.mixed_precision=false", "serve.port=0",
                     "serve.max_batch=2")
    srv = make_server(cfg, args.ckpt, args.device)
    srv.start_background()
    try:
        buf = io.BytesIO()
        np.save(buf, np.random.RandomState(16).randint(
            0, 256, (*HW, 3)).astype(np.uint8))
        req = urllib.request.Request(
            f"http://127.0.0.1:{srv.port}/predict", data=buf.getvalue(),
            headers={"Content-Type": "application/octet-stream"})
        with urllib.request.urlopen(req, timeout=60) as r:
            out = json.loads(r.read())
    finally:
        srv.shutdown()
    assert len(out["keypoints"]) == 17
    assert np.isfinite(np.asarray(out["keypoints"], np.float64)).all()


def test_cli_serve_restores_a_checkpoint(tmp_path):
    """--ckpt goes through engine/checkpoint.restore_path: the served
    model carries the saved parameters."""
    from tpupose_torch.cli.serve import build_predictor
    from tpupose_torch.engine.builder import Builder
    from tpupose_torch.engine.checkpoint import CheckpointManager
    from tpupose_torch.engine.train_state import TrainState

    cfg, _ = _cfg("model.backbone=vit_tiny", "data.image_size=[64,48]",
                  "model.heatmap_size=[16,12]",
                  "model.deconv_channels=[32,32]",
                  "train.mixed_precision=false", "train.ema_decay=0")
    b = Builder(cfg, "cpu")
    m = b.model()
    with torch.no_grad():
        m.backbone.norm.bias.fill_(0.25)
    CheckpointManager(str(tmp_path)).save(7, TrainState(m, b.optimizer(m, 1)),
                                          force=True)
    pred = build_predictor(cfg, str(tmp_path), "cpu")
    served = pred.evaluator.model
    assert torch.all(served.backbone.norm.bias == 0.25)


def test_cli_serve_refuses_what_is_not_ported():
    """hrnet is served since its port (tests/test_torch_hrnet.py);
    a family the port lacks and the int8 engine on a ViTPose raise."""
    from tpupose_torch.cli.serve import build_predictor

    cfg, _ = _cfg("model.name=dinov3_pose")
    with pytest.raises(SystemExit):
        build_predictor(cfg, "", "cpu")
    cfg, _ = _cfg("model.backbone=vit_tiny", "eval.int8_engine=true")
    with pytest.raises(SystemExit, match="SimpleBaseline"):
        build_predictor(cfg, "", "cpu")
