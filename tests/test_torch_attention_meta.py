"""tpupose_torch's Attention, GatedAttention, AttentionBlock,
gaussian_pool and MetaSpace against the JAX package on the CPU, float32,
on the same seeded numpy inputs and JAX's weights carried across
(utils/convert). Tolerance: 1e-4 of the reference's largest magnitude for
the forwards, 1e-5 for the pooling and the memory buffers (plain float32
sums)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpupose.models.attention import Attention as JAttention
from tpupose.models.attention import GatedAttention as JGatedAttention
from tpupose.models.meta import MetaSpace as JMetaSpace
from tpupose.models.meta import gaussian_pool as j_gaussian_pool
from tpupose.models.necks import AttentionBlock as JAttentionBlock
from tpupose_torch.models.attention import Attention, GatedAttention
from tpupose_torch.models.meta import MetaSpace, gaussian_pool
from tpupose_torch.models.necks import AttentionBlock
from tpupose_torch.utils import convert
from torch_threads import one_torch_thread  # noqa: F401


def _rel(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-12)


def _perturb_biases(tree, rs):
    """flax initialises biases at zero; give them values so that the bias
    mapping is checked too."""
    for k, v in tree.items():
        if isinstance(v, dict):
            _perturb_biases(v, rs)
        elif k == "bias":
            tree[k] = rs.normal(0, 0.1, np.shape(v)).astype(np.float32)
    return tree


def _params(module, *args, seed=0, **kw):
    v = module.init(jax.random.PRNGKey(seed), *args, **kw)
    return jax.tree_util.tree_map(np.asarray, v)


def _mask(B, T, masked):
    m = np.ones((B, T), bool)
    for b, t in masked:
        m[b, t] = False
    return m


@pytest.mark.parametrize("with_mask", [False, True], ids=["nomask", "mask"])
def test_attention_matches_jax(with_mask):
    rs = np.random.RandomState(0)
    x = rs.randn(2, 10, 32).astype(np.float32)
    jm = JAttention(dim=32, num_heads=4, dtype=jnp.float32)
    v = _params(jm, jnp.asarray(x))
    v["params"] = _perturb_biases(v["params"], rs)
    mask = _mask(2, 10, [(0, 0), (1, 3), (1, 7)]) if with_mask else None
    want = np.asarray(jm.apply(v, jnp.asarray(x),
                               mask=None if mask is None
                               else jnp.asarray(mask)))
    tm = Attention(32, 4)
    sd = {}
    convert._attention(sd, "", v["params"])
    tm.load_state_dict(sd)
    with torch.no_grad():
        got = tm(torch.from_numpy(x),
                 mask=None if mask is None else torch.from_numpy(mask))
    assert np.isfinite(got.numpy()).all()
    assert _rel(got, want) < 1e-4


@pytest.mark.parametrize("mode", ["elementwise", "headwise"])
@pytest.mark.parametrize("with_mask", [False, True], ids=["nomask", "mask"])
def test_gated_attention_matches_jax(mode, with_mask):
    rs = np.random.RandomState(1)
    x = rs.randn(2, 6, 32).astype(np.float32)
    jm = JGatedAttention(dim=32, num_heads=4, gate_mode=mode,
                         dtype=jnp.float32)
    v = _params(jm, jnp.asarray(x))
    v["params"] = _perturb_biases(v["params"], rs)
    mask = _mask(2, 6, [(0, 2), (1, 5)]) if with_mask else None
    jmask = None if mask is None else jnp.asarray(mask)
    want, want_gate = jm.apply(v, jnp.asarray(x), mask=jmask,
                               return_gate=True)
    tm = GatedAttention(32, 4, gate_mode=mode)
    sd = {}
    convert._gated_attention(sd, "", v["params"])
    tm.load_state_dict(sd)
    with torch.no_grad():
        got, gate = tm(torch.from_numpy(x), return_gate=True,
                       mask=None if mask is None else torch.from_numpy(mask))
    assert gate.shape == want_gate.shape
    assert _rel(got, want) < 1e-4
    assert _rel(gate, want_gate) < 1e-5


def test_fully_masked_row_is_uniform_as_in_jax():
    """A masked token's query row is masked at every key: JAX's -1e9 bias
    gives it uniform weights (the mean of v); a boolean SDPA mask gives
    NaN or zeros there, depending on torch's version."""
    rs = np.random.RandomState(2)
    x = rs.randn(1, 5, 16).astype(np.float32)
    mask = _mask(1, 5, [(0, 1)])
    jm = JAttention(dim=16, num_heads=2, dtype=jnp.float32)
    v = _params(jm, jnp.asarray(x))
    want = np.asarray(jm.apply(v, jnp.asarray(x), mask=jnp.asarray(mask)))
    tm = Attention(16, 2)
    sd = {}
    convert._attention(sd, "", v["params"])
    tm.load_state_dict(sd)
    with torch.no_grad():
        got = tm(torch.from_numpy(x), mask=torch.from_numpy(mask))
        # row 1 attends uniformly: proj(mean over tokens of v)
        qkv = tm.qkv(torch.from_numpy(x))
        vv = qkv[..., 32:]
        uniform = tm.proj(vv.mean(1))
    assert np.isfinite(got.numpy()).all()
    assert _rel(got, want) < 1e-4
    assert _rel(got[0, 1], uniform[0]) < 1e-5
    q = torch.from_numpy(x).view(1, 5, 2, 8)
    sdpa = torch.nn.functional.scaled_dot_product_attention(
        q.transpose(1, 2), q.transpose(1, 2), q.transpose(1, 2),
        attn_mask=torch.from_numpy(mask[:, None, :] & mask[:, :, None])[:,
                                                                        None])
    v_mean = q.mean(1)                                   # (1, heads, d)
    row = sdpa[0, :, 1]
    assert torch.isnan(row).any() or not torch.allclose(row, v_mean[0])


def test_unknown_gate_mode_raises():
    with pytest.raises(ValueError, match="gate_mode"):
        GatedAttention(16, 2, gate_mode="channelwise")


def test_attention_block_matches_jax():
    rs = np.random.RandomState(3)
    x = rs.randn(2, 4, 5, 32).astype(np.float32)            # NHWC
    jm = JAttentionBlock(num_heads=4, dtype=jnp.float32)
    v = _params(jm, jnp.asarray(x))
    p = _perturb_biases(v["params"], rs)
    for ln in ("LayerNorm_0", "LayerNorm_1"):
        p[ln]["scale"] = rs.uniform(0.7, 1.3, 32).astype(np.float32)
    want = np.asarray(jm.apply({"params": p}, jnp.asarray(x)))
    tm = AttentionBlock(32, num_heads=4)
    sd = {}
    convert._ln(sd, "norm1", p["LayerNorm_0"])
    convert._attention(sd, "attn.", p["Attention_0"])
    convert._ln(sd, "norm2", p["LayerNorm_1"])
    convert._dense(sd, "fc1", p["Dense_0"])
    convert._dense(sd, "fc2", p["Dense_1"])
    tm.load_state_dict(sd)
    with torch.no_grad():
        got = tm(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert _rel(got, want) < 1e-4


def test_gaussian_pool_matches_jax():
    """Integer, half-pixel (round half to even: 2.5 -> 2, 3.5 -> 4),
    border and far out-of-bounds keypoints (clamped to the border; the
    clamp keeps the centre tap in bounds, so the weight sum never
    vanishes there), and an invisible one."""
    rs = np.random.RandomState(4)
    feat = rs.randn(2, 9, 11, 6).astype(np.float32)
    kpts = np.array([[[3.0, 4.0], [2.5, 3.5], [0.0, 0.0], [-50.0, 4.0]],
                     [[10.0, 8.0], [5.5, 0.5], [40.0, 30.0], [6.2, 2.7]]],
                    np.float32)
    vis = np.array([[2, 1, 2, 2], [2, 2, 2, 0]], np.float32)
    want = np.asarray(j_gaussian_pool(jnp.asarray(feat), jnp.asarray(kpts),
                                      jnp.asarray(vis)))
    got = gaussian_pool(torch.from_numpy(feat), torch.from_numpy(kpts),
                        torch.from_numpy(vis))
    assert _rel(got, want) < 1e-5
    assert np.abs(got[1, 3].numpy()).max() == 0.0


def test_gaussian_pool_half_pixel_rounds_to_even():
    feat = np.zeros((1, 8, 8, 1), np.float32)
    feat[0, 4, 2, 0] = 1.0                 # (x=2, y=4)
    kpts = torch.tensor([[[2.5, 3.5]]])    # -> (2, 4), not (3, 4)
    got = gaussian_pool(torch.from_numpy(feat), kpts, torch.ones(1, 1))
    want = j_gaussian_pool(jnp.asarray(feat), jnp.asarray(kpts.numpy()),
                           jnp.ones((1, 1)))
    w = np.exp(-(np.arange(-2, 3)[:, None] ** 2
                 + np.arange(-2, 3)[None] ** 2) / 8.0)
    assert float(got) == pytest.approx(1.0 / w.sum(), rel=1e-6)
    assert float(got) == pytest.approx(float(want[0, 0, 0]), rel=1e-6)


def test_metaspace_accumulate_update_fuse_matches_jax():
    K, D, L = 3, 16, 2
    rs = np.random.RandomState(5)
    feats = [rs.randn(2, 8, 8, D).astype(np.float32) for _ in range(L)]
    kpts = [rs.uniform(1, 6, (2, K, 2)).astype(np.float32) for _ in range(L)]
    vis = np.array([[2, 2, 0], [2, 1, 2]], np.float32)
    jf = [jnp.asarray(f) for f in feats]
    jk = [jnp.asarray(k) for k in kpts]
    jms = JMetaSpace(num_keypoints=K, dim=D, num_levels=L, dtype=jnp.float32)
    v = jax.tree_util.tree_map(
        np.asarray, jms.init(jax.random.PRNGKey(0), jf, jk,
                             jnp.asarray(vis)))
    v["params"] = _perturb_biases(v["params"], rs)
    v = jax.tree_util.tree_map(jnp.asarray, v)

    tms = MetaSpace(K, D, num_levels=L)
    tms.load_state_dict(convert.from_flax_meta_space(v))
    tf = [torch.from_numpy(f) for f in feats]
    tk = [torch.from_numpy(k) for k in kpts]
    tv = torch.from_numpy(vis)

    variables = v
    for epoch in range(2):
        outs, mut = jms.apply(variables, jf, jk, jnp.asarray(vis),
                              mutable=["meta_space"])
        with torch.no_grad():
            got = tms(tf, tk, tv)
        for g, w in zip(got, outs):
            assert _rel(g, w) < 1e-4, epoch
        for name in ("feature_sum", "feature_count"):
            assert _rel(getattr(tms, name),
                        mut["meta_space"][name]) < 1e-5, (epoch, name)
        _, mut = jms.apply({"params": v["params"], **mut},
                           method=jms.update_meta_spaces,
                           mutable=["meta_space"])
        tms.update_meta_spaces()
        assert float(tms.feature_count.sum()) == 0.0
        assert _rel(tms.meta_features,
                    mut["meta_space"]["meta_features"]) < 1e-5, epoch
        variables = {"params": v["params"], **mut}
    # the invisible keypoint (0, 2) has memory from image 1 only
    assert float(tms.meta_features.abs().sum()) > 0
