"""tpupose_torch's few-shot pieces against the JAX package on the CPU:
the episodic data (episodes bit-equal to JAX's from the same seed), every
FSKD head and fusion, the feature extractors, FSKD end to end,
fskd_episode_loss and maml_adapt (the adapted parameters and the
second-order outer gradient). The models are float32 on a depth-3 ViT
("t3": dim 64, 2 heads, added to both packages' VIT_SIZES; the extractor
reads blocks 0, 1 and 2) at 32x32, with JAX's weights carried across by
utils/convert.from_flax_fskd after the zero-initialised biases, the
LayerNorm scales, the 1e-5 layer scales and the tokens were given O(1)
values. JAX's fused_attention takes its non-TPU branch here, the port's
its plain version. Tolerances: 1e-4 of the reference's largest magnitude
for forwards, 1e-3 for the inner-loop updates and the second-order
gradient (float32 through three gradient evaluations)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import functional_call

from tpupose.data import episodic as jepisodic
from tpupose.models import fskd as jfskd
from tpupose.models.backbones import vit as jvit
from tpupose.ops.attention import fused_attention as j_fused_attention
from tpupose_torch.data import episodic as tepisodic
from tpupose_torch.models import fskd as tfskd
from tpupose_torch.models.backbones import vit as tvit
from tpupose_torch.ops.attention import fused_attention
from tpupose_torch.utils import convert
from torch_threads import one_torch_thread  # noqa: F401

T3 = {"depth": 3, "dim": 64, "heads": 2}


@pytest.fixture(autouse=True)
def t3_size(monkeypatch):
    monkeypatch.setitem(jvit.VIT_SIZES, "t3", T3)
    monkeypatch.setitem(tvit.VIT_SIZES, "t3", T3)


def _rel(got, want):
    got = np.asarray(got.detach() if isinstance(got, torch.Tensor) else got,
                     np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-12)


def _randomize(tree, rs):
    """O(1) values where flax's init leaves a module near a no-op or a
    mapping unchecked: biases, norm scales, layer scales, tokens, `mix`,
    modality embeddings."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _randomize(v, rs)
            continue
        v = np.asarray(v, np.float32)
        if k == "bias" or k in ("mix", "modality_embed"):
            v = rs.normal(0, 0.1, v.shape)
        elif k == "scale":
            v = rs.uniform(0.7, 1.3, v.shape)
        elif k in ("ls1", "ls2"):
            v = rs.uniform(0.2, 0.6, v.shape)
        elif k in ("cls_token", "storage_tokens"):
            v = rs.normal(0, 0.5, v.shape)
        out[k] = v.astype(np.float32)
    return out


def _init(module, *args, seed=0, **kw):
    """flax's init, jitted (eager, it takes seconds on the ViT)."""
    v = jax.jit(functools.partial(module.init, **kw))(
        jax.random.PRNGKey(seed), *args)
    return _randomize(jax.tree_util.tree_map(np.asarray, v["params"]),
                      np.random.RandomState(seed + 100))


def _j(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


# -- episodic data --------------------------------------------------------

class _ClassDataset:
    """Base dataset: per-class intensity, seeded keypoints."""

    def __init__(self, n_classes=7, per_class=7, K=4):
        rs = np.random.RandomState(0)
        self.samples = [
            {"class_id": c,
             "image": rs.randint(0, 256, (8, 8, 3)).astype(np.uint8),
             "keypoints": rs.uniform(0, 1, (K, 3)).astype(np.float32)}
            for c in range(n_classes) for _ in range(per_class)]

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, i):
        return self.samples[i]


def _same_episode(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("sampling", ["random", "balanced", "fixed"])
def test_episodes_bit_equal_to_jax(sampling):
    kw = dict(n_way=3, k_shot=2, n_query=3, episodes_per_epoch=6,
              class_sampling=sampling, fixed_classes=[5, 1, 3], seed=7)
    jd = jepisodic.FewShotDataset(_ClassDataset(), **kw)
    td = tepisodic.FewShotDataset(_ClassDataset(), **kw)
    assert td.classes == jd.classes and len(td) == len(jd)
    for i in range(len(jd)):
        _same_episode(td[i], jd[i])
    assert dict(td._class_use_count) == dict(jd._class_use_count)
    jb = list(jepisodic.EpisodicDataLoader(jd, batch_size=2))
    tb = list(tepisodic.EpisodicDataLoader(td, batch_size=2))
    assert len(tb) == len(jb) == 3
    for a, b in zip(tb, jb):
        _same_episode(a, b)


def test_weighted_sampler_draws_equal_to_jax():
    kw = dict(n_way=3, k_shot=1, n_query=1, seed=3)
    jd = jepisodic.FewShotDataset(_ClassDataset(), **kw)
    td = tepisodic.FewShotDataset(_ClassDataset(), **kw)
    js = jepisodic.WeightedEpisodeSampler(jd, seed=5)
    ts = tepisodic.WeightedEpisodeSampler(td, seed=5)
    for step in range(6):
        picks = ts.sample_classes()
        assert picks == js.sample_classes(), step
        for c in picks:
            loss = 0.5 + 0.1 * c + step
            js.record_difficulty(c, loss)
            ts.record_difficulty(c, loss)
    assert ts.difficulty == js.difficulty


def test_too_few_classes_raises_as_in_jax():
    with pytest.raises(ValueError, match="classes"):
        tepisodic.FewShotDataset(_ClassDataset(n_classes=2), n_way=3)


# -- heads, fusions, extractors -------------------------------------------

def _feats(rs, *shape):
    return rs.randn(*shape).astype(np.float32)


def test_compute_prototypes_matches_jax():
    rs = np.random.RandomState(1)
    f = _feats(rs, 7, 3, 5)
    lbl = np.array([0, 2, 2, 1, 0, 2, 3], np.int32)   # class 4 unseen
    want = jfskd.compute_prototypes(jnp.asarray(f), jnp.asarray(lbl), 5)
    got = tfskd.compute_prototypes(torch.from_numpy(f), torch.from_numpy(lbl),
                                   5)
    assert _rel(got, want) < 1e-6
    assert float(got[4].abs().max()) == 0.0


@pytest.mark.parametrize("multi", [False, True], ids=["proto", "multi"])
def test_prototypical_heads_match_jax(multi):
    rs = np.random.RandomState(2)
    q, cp, kp = _feats(rs, 6, 32), _feats(rs, 3, 32), _feats(rs, 3, 4, 32)
    if multi:
        jm = jfskd.MultiPrototypicalHead(4, 32, dtype=jnp.float32)
        args = (q, cp, kp)
        tm = tfskd.MultiPrototypicalHead(4, 32)
    else:
        jm = jfskd.PrototypicalHead(4, 32, dtype=jnp.float32)
        args = (q, cp)
        tm = tfskd.PrototypicalHead(4, 32)
    p = _init(jm, *map(jnp.asarray, args))
    want = jm.apply({"params": _j(p)}, *map(jnp.asarray, args))
    sd = {}
    convert._proto_head(sd, "", p)
    tm.load_state_dict(sd)
    with torch.no_grad():
        got = tm(*map(torch.from_numpy, args))
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == torch.float32
        assert _rel(got[k], want[k]) < 1e-4, k


@pytest.mark.parametrize("adaptive", [False, True],
                         ids=["fusion", "adaptive"])
def test_attention_fusions_match_jax(adaptive):
    rs = np.random.RandomState(3)
    q, protos = _feats(rs, 6, 32), _feats(rs, 3, 32)
    cls_j = jfskd.AdaptiveAttentionFusion if adaptive \
        else jfskd.AttentionFusion
    cls_t = tfskd.AdaptiveAttentionFusion if adaptive \
        else tfskd.AttentionFusion
    jm = cls_j(32, num_heads=4, dtype=jnp.float32)
    p = _init(jm, jnp.asarray(q), jnp.asarray(protos))
    want = jm.apply({"params": _j(p)}, jnp.asarray(q), jnp.asarray(protos))
    tm = cls_t(32, num_heads=4)
    sd = {}
    convert._fskd_fusion(sd, "", p)
    tm.load_state_dict(sd)
    with torch.no_grad():
        got = tm(torch.from_numpy(q), torch.from_numpy(protos))
    assert _rel(got, want) < 1e-4


@pytest.mark.parametrize("cross", [False, True], ids=["plain", "crossmodal"])
def test_feature_extractors_match_jax(cross):
    rs = np.random.RandomState(4)
    x = rs.uniform(0, 1, (3, 32, 32, 3)).astype(np.float32)
    if cross:
        jm = jfskd.CrossModalFeatureExtractor("t3", 32, dtype=jnp.float32)
        tm = tfskd.CrossModalFeatureExtractor("t3", 32)
        kw_j, kw_t = {"modality_id": 1}, {"modality_id": 1}
    else:
        jm = jfskd.FeatureExtractor("t3", 32, dtype=jnp.float32)
        tm = tfskd.FeatureExtractor("t3", 32)
        kw_j, kw_t = {}, {}
    p = _init(jm, jnp.asarray(x), train=False, **kw_j)
    w_cls, w_patch = jax.jit(functools.partial(jm.apply, train=False,
                                               **kw_j))(
        {"params": _j(p)}, jnp.asarray(x))
    sd = {}
    convert._fskd_extractor(sd, "", p)
    tm.load_state_dict(sd)
    assert tm.ids == (0, 1, 2)
    with torch.no_grad():
        cls, patch = tm(torch.from_numpy(x), **kw_t)
    assert _rel(cls, w_cls) < 1e-4
    assert _rel(patch, w_patch) < 1e-4


# -- FSKD, its loss, MAML ------------------------------------------------

def _episode(n_way=2, per=2, K=3, seed=5):
    rs = np.random.RandomState(seed)
    S = n_way * per
    return dict(
        s_imgs=rs.uniform(0, 1, (S, 32, 32, 3)).astype(np.float32),
        s_lbl=np.repeat(np.arange(n_way), per).astype(np.int32),
        s_kpts=rs.uniform(0.1, 0.9, (S, K, 2)).astype(np.float32),
        s_vis=rs.choice([0.0, 2.0], (S, K), p=[0.2, 0.8]).astype(np.float32),
        q_imgs=rs.uniform(0, 1, (5, 32, 32, 3)).astype(np.float32),
        q_lbl=rs.randint(0, n_way, 5).astype(np.int32),
        q_kpts=rs.uniform(0.1, 0.9, (5, K, 2)).astype(np.float32),
        q_vis=rs.choice([0.0, 2.0], (5, K), p=[0.2, 0.8]).astype(np.float32))


def _pair(use_fusion=True, n_way=2, K=3):
    """The flax FSKD and its params, the port's FSKD with them."""
    e = _episode(n_way, K=K)
    jm = jfskd.FSKD(n_way=n_way, num_keypoints=K, dim=32, vit_size="t3",
                    use_fusion=use_fusion, dtype=jnp.float32)
    p = _init(jm, jnp.asarray(e["s_imgs"]), jnp.asarray(e["s_lbl"]),
              jnp.asarray(e["q_imgs"]), train=False)
    tm = tfskd.FSKD(n_way=n_way, num_keypoints=K, dim=32, vit_size="t3",
                    use_fusion=use_fusion, dtype=torch.float32, device="cpu")
    tm.load_state_dict(convert.from_flax_fskd({"params": p}))
    return jm, p, tm, e


def _t(e):
    return {k: torch.from_numpy(v) for k, v in e.items()}


@pytest.mark.parametrize("use_fusion", [True, False],
                         ids=["fusion", "nofusion"])
def test_fskd_and_episode_loss_match_jax(use_fusion):
    jm, p, tm, e = _pair(use_fusion)
    want = jax.jit(lambda p_, s, lbl, q: jm.apply({"params": p_}, s, lbl,
                                                   q, train=True))(
        _j(p), e["s_imgs"], e["s_lbl"], e["q_imgs"])
    wl, wparts = jfskd.fskd_episode_loss(want, e["q_lbl"], e["q_kpts"],
                                         e["q_vis"])
    te = _t(e)
    with torch.no_grad():
        got = tm(te["s_imgs"], te["s_lbl"], te["q_imgs"])
        gl, gparts = tfskd.fskd_episode_loss(got, te["q_lbl"], te["q_kpts"],
                                             te["q_vis"])
    for k in ("logits", "keypoints", "confidence"):
        assert _rel(got[k], want[k]) < 1e-4, k
    assert _rel(gl, wl) < 1e-5
    for k in ("cls", "kpt", "conf"):
        assert _rel(gparts[k], wparts[k]) < 1e-5, k


def _grads_as_port(tree):
    """A flax gradient tree -> {port name: array} (from_flax_fskd maps a
    gradient tree as it maps the params: the transposes are linear)."""
    return {k: v.numpy() for k, v in
            convert.from_flax_fskd({"params": tree}).items()}


def test_maml_adapt_matches_jax_to_second_order():
    """Two inner steps at lr 0.05: the adapted parameters' updates, then
    the gradient of the query loss through the adapted parameters with
    respect to the initial ones, against jax.grad of the same
    composition (full second-order MAML)."""
    jm, p, tm, e = _pair()
    lr, steps = 0.05, 2
    args = [jnp.asarray(e[k]) for k in ("s_imgs", "s_lbl", "s_kpts",
                                        "s_vis")]

    def j_outer(params):
        v2 = jfskd.maml_adapt(jm, {"params": params}, *args, inner_lr=lr,
                              inner_steps=steps)
        out = jm.apply(v2, args[0], args[1], jnp.asarray(e["q_imgs"]))
        return jfskd.fskd_episode_loss(out, e["q_lbl"], e["q_kpts"],
                                       e["q_vis"])[0], v2["params"]

    (j_loss, j_adapted), j_grad = jax.jit(
        jax.value_and_grad(j_outer, has_aux=True))(_j(p))
    te = _t(e)
    init = {n: q.detach().clone() for n, q in tm.named_parameters()}
    adapted = tfskd.maml_adapt(tm, None, te["s_imgs"], te["s_lbl"],
                               te["s_kpts"], te["s_vis"], inner_lr=lr,
                               inner_steps=steps)
    out = functional_call(tm, adapted, (te["s_imgs"], te["s_lbl"],
                                        te["q_imgs"]))
    loss, _ = tfskd.fskd_episode_loss(out, te["q_lbl"], te["q_kpts"],
                                      te["q_vis"])
    names = [n for n, _ in tm.named_parameters()]
    grads = torch.autograd.grad(loss, [dict(tm.named_parameters())[n]
                                       for n in names], allow_unused=True)
    assert _rel(loss, j_loss) < 1e-5

    want_adapted = _grads_as_port(jax.tree_util.tree_map(np.asarray,
                                                         j_adapted))
    dw = {n: want_adapted[n] - init[n].numpy() for n in names}
    scale = max(np.abs(d).max() for d in dw.values())
    assert scale > 1e-3                       # the inner loop moved
    for n in names:
        d = (adapted[n] - init[n]).detach().numpy()
        assert np.abs(d - dw[n]).max() <= 1e-3 * scale, n

    want_grad = _grads_as_port(jax.tree_util.tree_map(np.asarray, j_grad))
    gscale = max(np.abs(g).max() for g in want_grad.values())
    for n, g in zip(names, grads):
        g = np.zeros_like(want_grad[n]) if g is None else g.numpy()
        assert np.abs(g - want_grad[n]).max() <= 1e-3 * gscale, n


def test_maml_adapt_reduces_the_support_loss():
    _, _, tm, e = _pair()
    te = _t(e)

    def support_loss(params):
        with torch.no_grad():
            out = functional_call(tm, params, (te["s_imgs"], te["s_lbl"],
                                               te["s_imgs"]))
            return float(tfskd.fskd_episode_loss(out, te["s_lbl"],
                                                 te["s_kpts"],
                                                 te["s_vis"])[0])

    before = support_loss(dict(tm.named_parameters()))
    adapted = tfskd.maml_adapt(tm, None, te["s_imgs"], te["s_lbl"],
                               te["s_kpts"], te["s_vis"], inner_lr=0.001,
                               inner_steps=2)
    assert support_loss(adapted) < before


def test_plain_attention_second_order_matches_jax():
    """The plain route of fused_attention (the CPU's, and impl="plain")
    is differentiable twice: the gradient of |d<o, w>/dq|^2 with respect
    to q, k and v against JAX's fused_attention (its non-TPU branch).
    On the card the kernel route's backward (K8b) is once_differentiable
    and raises instead (tests/test_torch_cuda.py)."""
    rs = np.random.RandomState(6)
    q, k, v, w = (rs.randn(2, 9, 2, 16).astype(np.float32) for _ in range(4))

    def j_f(q, k, v):
        gq = jax.grad(lambda q_: jnp.sum(j_fused_attention(q_, k, v) * w))(q)
        return jnp.sum(gq ** 2)

    want = jax.grad(j_f, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    o = fused_attention(tq, tk, tv, impl="plain")
    (gq,) = torch.autograd.grad((o * torch.from_numpy(w)).sum(), tq,
                                create_graph=True)
    got = torch.autograd.grad((gq ** 2).sum(), (tq, tk, tv))
    for g, wnt in zip(got, want):
        assert _rel(g, wnt) < 1e-4


@pytest.mark.parametrize("param_dtype", [torch.float32, torch.bfloat16],
                         ids=["autocast", "bf16_build"])
def test_fskd_float32_islands_under_bf16(param_dtype):
    """JAX computes the offset, confidence and strategy layers, the norms,
    the cosine logits and the strategy mix in float32 whatever the
    model's dtype: under bf16 (autocast over float32 masters, or a bf16
    build) those layers keep float32 weights, the head's outputs are
    float32, and they stay within bf16's reach of the float32 model's."""
    _, p, ref, e = _pair()
    tm = tfskd.FSKD(n_way=2, num_keypoints=3, dim=32, vit_size="t3",
                    dtype=torch.bfloat16, device="cpu",
                    param_dtype=param_dtype)
    tm.load_state_dict(convert.from_flax_fskd({"params": p}))
    for layer in (tm.head.offset, tm.head.confidence, tm.fusion.strategy):
        assert layer.weight.dtype == torch.float32
    te = _t(e)
    with torch.no_grad():
        got = tm(te["s_imgs"], te["s_lbl"], te["q_imgs"])
        want = ref(te["s_imgs"], te["s_lbl"], te["q_imgs"])
    for k in ("logits", "keypoints", "confidence"):
        assert got[k].dtype == torch.float32, k
        assert _rel(got[k], want[k].numpy()) < 5e-2, k
