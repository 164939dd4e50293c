"""ViTPose training through tpupose_torch held against the JAX package on
the CPU, float32, at the "tiny" ViT size of tests/test_torch_vit.py
(depth 2, dim 64, 2 heads; its `tiny_size` fixture) on 64x48 images,
with seeded numpy inputs and O(1) layer scales (flax's 1e-5 would hide
attention and its gradients):

  - (a) the attention backward: `attention_backward_reference` and autograd
    of `attention_reference` against jax.vjp of tpupose's fused_attention
    (jax.nn.dot_product_attention off the TPU), L = 1, 63, 64, 65, 197;
  - (b) parameter gradients of ViTBlock, DinoViT and ViTPose (classic
    decoder, train-mode BatchNorm) against jax.grad of the flax apply;
  - (c) remat: the same outputs, gradients and state_dict keys with the
    blocks checkpointed or not;
  - (d) three train steps against tpupose's make_heatmap_train_step with
    AdamW (weight decay 0.1) and SGD + EMA;
  - (e) freeze_backbone as JAX's stop_gradient: no backbone gradient, the
    backbone unchanged by a step;
  - (f) the Trainer and cli.train on vitpose_s.yaml with --device cpu;
  - (g) on a (fake) CUDA tensor the backward reaches K8b's wrapper, never
    the plain version.

Each tolerance is stated where it is used, with its reason.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tpupose.configs.default import OptimizerConfig as JOptimizerConfig
from tpupose.engine.builder import is_backbone_path as j_is_backbone
from tpupose.engine.optimizers import make_optimizer as j_make_optimizer
from tpupose.engine.train_state import create_train_state
from tpupose.engine.train_state import make_heatmap_train_step as j_train_step
from tpupose.losses.heatmap import joints_mse_loss as j_mse
from tpupose.models.backbones import vit as jvit
from tpupose.models.vitpose import ViTPose as JViTPose
from tpupose.ops.attention import fused_attention as j_fused_attention
from tpupose_torch.configs.default import OptimizerConfig
from tpupose_torch.engine.builder import is_backbone_path
from tpupose_torch.engine.optimizers import make_optimizer
from tpupose_torch.engine.train_state import (TrainState,
                                              make_heatmap_train_step)
from tpupose_torch.losses.heatmap import joints_mse_loss
from tpupose_torch.models.backbones import vit as tvit
from tpupose_torch.models.vitpose import ViTPose
from tpupose_torch.ops.attention import (attention_backward_reference,
                                         attention_reference)
from tpupose_torch.utils.convert import from_flax_vitpose

from test_torch_train import _jitter_draws
from test_torch_vit import (HW, VITPOSE_S, _cfg, _images, _pair, _rel,  # noqa: F401
                            classic, tiny_size)
from torch_threads import one_torch_thread  # noqa: F401

T = torch.from_numpy
HM = (16, 12)


def _sd_rel(got: dict, want: dict, keys=None):
    """{name: max |got - want| / max |want|} over `keys` (default: all of
    want's but BatchNorm's step counter)."""
    keys = keys or [k for k in want if not k.endswith("num_batches_tracked")]
    return {k: _rel(got[k].detach().numpy(), want[k].numpy()) for k in keys}


def _grads_sd(model) -> dict:
    return {n: p.grad for n, p in model.named_parameters()}


# -- (a) the attention backward ----------------------------------------------

@pytest.mark.parametrize("route", ["backward_reference", "autograd"])
@pytest.mark.parametrize("L", [1, 63, 64, 65, 197])
def test_attention_gradients_match_jax(L, route):
    """dq, dk, dv for a seeded output gradient: the plain backward (the
    oracle K8b is held to on the card) and autograd of the plain forward
    against jax.vjp of tpupose's fused_attention. Float32 sums in another
    order: within 2e-5 of each gradient's max |value|, or of 1 where that
    is smaller (at L = 1 the softmax is constant and dq is 0 up to
    rounding). L = 63, 64, 65 and 197 put the ragged edge of K8b's 64-row
    tiles in every position."""
    rs = np.random.RandomState(100 + L)
    q, k, v, do = (rs.randn(2, L, 2, 64).astype(np.float32)
                   for _ in range(4))
    scale = 0.125
    _, vjp = jax.vjp(lambda a, b, c: j_fused_attention(a, b, c, scale),
                     jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(do))
    tq, tk, tv, tdo = (T(a) for a in (q, k, v, do))
    if route == "backward_reference":
        got = attention_backward_reference(tq, tk, tv, tdo, scale)
    else:
        for t in (tq, tk, tv):
            t.requires_grad_()
        got = torch.autograd.grad(attention_reference(tq, tk, tv, scale),
                                  (tq, tk, tv), tdo)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == torch.float32
        w = np.asarray(w)
        err = np.abs(g.detach().numpy() - w).max()
        assert err <= 2e-5 * max(np.abs(w).max(), 1.0), (name, err)


def test_attention_backward_reference_uses_the_stored_bf16_output():
    """In bf16 the plain backward takes Delta = rowsum(dO * O) on O rounded
    to bf16, the O a kernel stores, and returns bf16; it agrees with the
    float32 backward to bf16 precision (2e-2 of the max gradient)."""
    rs = np.random.RandomState(7)
    q, k, v, do = (T(rs.randn(2, 65, 2, 64).astype(np.float32))
                   for _ in range(4))
    got = attention_backward_reference(*(t.bfloat16() for t in (q, k, v, do)),
                                       0.125)
    want = attention_backward_reference(q, k, v, do, 0.125)
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16
        assert _rel(g.float().numpy(), w.numpy()) < 2e-2


# -- (b) module gradients ------------------------------------------------------

def test_vit_block_gradients_match_jax(classic):
    """d(sum(block(x) * w)) / d(params, x), flax ViTBlock_0 against the
    port's block on the same weights: within 1e-4 of each tensor's max
    |gradient| (float32, the forward's 1e-4 bound)."""
    _, v, tm = classic
    rs = np.random.RandomState(21)
    x = rs.randn(2, 5 + 12, 64).astype(np.float32)
    w = rs.randn(2, 5 + 12, 64).astype(np.float32)
    js, jc = jvit.rope_2d_sincos(4, 3, 32)
    jb = jvit.ViTBlock(64, 2, 5, dtype=jnp.float32)
    bp = v["params"]["DinoViT_0"]["ViTBlock_0"]

    def jloss(p, xx):
        return jnp.sum(jb.apply({"params": p}, xx, js, jc) * w)

    jg, jgx = jax.grad(jloss, argnums=(0, 1))(bp, jnp.asarray(x))
    tree = jax.tree_util.tree_map(np.asarray, v)
    tree["params"]["DinoViT_0"]["ViTBlock_0"] = jax.device_get(jg)
    pre = "backbone.blocks.0."
    want = {k[len(pre):]: a for k, a in from_flax_vitpose(tree).items()
            if k.startswith(pre)}
    blk = tm.backbone.blocks[0]
    blk.zero_grad()
    xt = T(x).requires_grad_()
    ts, tc = tvit.rope_2d_sincos(4, 3, 32)
    (blk(xt, ts, tc) * T(w)).sum().backward()
    rel = _sd_rel(_grads_sd(blk), want)
    assert set(rel) == {n for n, _ in blk.named_parameters()}
    assert max(rel.values()) < 1e-4, rel
    assert _rel(xt.grad.numpy(), jgx) < 1e-4


def test_dino_vit_gradients_match_jax(classic):
    """d(sum(feature_map * w) + sum(cls * w2)) / d(backbone params), flax
    DinoViT against the port's: within 1e-4 of each tensor's max
    |gradient|, every parameter (tokens, patch embedding, both blocks,
    the final norm) covered."""
    _, v, tm = classic
    x = _images(22)
    rs = np.random.RandomState(23)
    w = rs.randn(2, 4, 3, 64).astype(np.float32)
    w2 = rs.randn(2, 64).astype(np.float32)
    jb = jvit.DinoViT.from_size("tiny", dtype=jnp.float32)

    def jloss(p):
        out = jb.apply({"params": p}, jnp.asarray(x), train=True)
        return jnp.sum(out["feature_map"] * w) + jnp.sum(out["cls"] * w2)

    jg = jax.grad(jloss)(v["params"]["DinoViT_0"])
    tree = jax.tree_util.tree_map(np.asarray, v)
    tree["params"]["DinoViT_0"] = jax.device_get(jg)
    want = {k: a for k, a in from_flax_vitpose(tree).items()
            if k.startswith("backbone.")}
    vit = tm.backbone
    vit.zero_grad()
    out = vit(T(x))
    ((out["feature_map"] * T(w)).sum() + (out["cls"] * T(w2)).sum()) \
        .backward()
    rel = _sd_rel({f"backbone.{n}": p.grad
                   for n, p in vit.named_parameters()}, want)
    assert set(rel) == set(want)
    assert max(rel.values()) < 1e-4, rel


def _vitpose_loss_case(seed):
    rs = np.random.RandomState(seed)
    x = _images(seed)
    tgt = rs.uniform(0, 1, (2, *HM, 17)).astype(np.float32)
    tw = (rs.uniform(0, 1, (2, 17)) > 0.3).astype(np.float32)
    return x, tgt, tw


def _vitpose_grads_jax(jm, v, x, tgt, tw):
    def jloss(p):
        out, _ = jm.apply({"params": p, "batch_stats": v["batch_stats"]},
                          jnp.asarray(x), train=True, mutable=["batch_stats"])
        return j_mse(out, tgt, tw)

    loss, g = jax.value_and_grad(jloss)(v["params"])
    return float(loss), from_flax_vitpose(
        {"params": jax.device_get(g), "batch_stats": v["batch_stats"]})


def test_vitpose_gradients_match_jax(classic):
    """JointsMSE (target weight) of the classic ViTPose in train mode
    (BatchNorm on batch statistics) against jax.value_and_grad of the
    flax apply with train=True: loss rtol 1e-5, every parameter's
    gradient within 1e-4 of its max |gradient|."""
    jm, v, tm = classic
    x, tgt, tw = _vitpose_loss_case(24)
    jl, want = _vitpose_grads_jax(jm, v, x, tgt, tw)
    tm.train()
    try:
        tm.zero_grad()
        loss = joints_mse_loss(tm(T(x)), T(tgt), T(tw))
        loss.backward()
    finally:
        tm.load_state_dict(from_flax_vitpose(v))     # running statistics
        tm.eval()
    np.testing.assert_allclose(loss.item(), jl, rtol=1e-5)
    rel = _sd_rel(_grads_sd(tm), want, [n for n, _ in tm.named_parameters()])
    print(f"ViTPose gradients: max rel {max(rel.values()):.3g}")
    assert max(rel.values()) < 1e-4, rel
    tm.zero_grad()


# -- (c) remat -------------------------------------------------------------------

def test_remat_keeps_outputs_gradients_and_names(classic, monkeypatch):
    """ViTPose(remat=True) on the same weights: identical state_dict keys
    (tests/test_remat.py's point for flax), outputs and parameter
    gradients equal to the run without remat (the recompute repeats the
    same float32 operations on the CPU: bit for bit); one checkpoint per
    block while gradients are recorded, none under no_grad."""
    _, v, _ = classic
    x, tgt, tw = _vitpose_loss_case(25)
    calls = []
    ckpt = tvit.checkpoint
    monkeypatch.setattr(tvit, "checkpoint",
                        lambda *a, **k: calls.append(1) or ckpt(*a, **k))
    runs = {}
    for remat in (False, True):
        m = ViTPose("vit_tiny", 17, "classic", (32, 32), dtype=torch.float32,
                    device="cpu", remat=remat)
        m.load_state_dict(from_flax_vitpose(v))
        assert m.backbone.remat is remat
        m.train()
        out = m(T(x))
        joints_mse_loss(out, T(tgt), T(tw)).backward()
        runs[remat] = (list(m.state_dict()), out.detach(), _grads_sd(m))
        assert len(calls) == (2 if remat else 0)
        with torch.no_grad():
            m(T(x))
        assert len(calls) == (2 if remat else 0)
    (k0, o0, g0), (k1, o1, g1) = runs[False], runs[True]
    assert k0 == k1
    assert torch.equal(o0, o1)
    for n in g0:
        assert torch.equal(g0[n], g1[n]), n


def test_builder_threads_remat_into_vitpose():
    from tpupose_torch.engine.builder import Builder

    cfg, _ = _cfg("model.backbone=vit_tiny", "train.remat=true")
    assert Builder(cfg, "cpu").model().backbone.remat is True
    cfg, _ = _cfg("model.backbone=vit_tiny")
    assert Builder(cfg, "cpu").model().backbone.remat is False


# -- (d) three train steps against JAX ----------------------------------------

B = 4
AUG = dict(color_jitter_strength=0.2, jitter_seed=5, heatmap_size=HM,
           sigma=2.0)


def _batch():
    """Noise pixels and joints spread over the 16x12 heatmap."""
    rs = np.random.RandomState(26)
    return {"images": rs.randint(0, 256, (B, *HW, 3)).astype(np.uint8),
            "joints": np.stack([rs.uniform(1, 11, (B, 17)),
                                rs.uniform(1, 15, (B, 17))], -1)
            .astype(np.float32),
            "visibility": (rs.uniform(0, 1, (B, 17)) > 0.2)
            .astype(np.float32)}


def _run_vit_steps(opt_name, lrs, ema_decay, weight_decay=0.0, n_steps=3):
    """tests/test_torch_train.py's `_run_steps` for ViTPose: n_steps of
    tpupose's jitted heatmap train step and of the port's, float32, from
    the same flax init with O(1) layer scales and non-trivial BatchNorm
    statistics, color jitter on with the JAX draws handed to the port.
    Returns the per-step ((jax loss, grad_norm), (port loss, grad_norm)),
    the initial state dict, JAX's final variables and EMA as the port's
    state dicts, and the port's TrainState."""
    jm, v, _ = _pair("classic", seed=30)
    kw = dict(name=opt_name, lr=lrs[0], head_lr=lrs[1], momentum=0.9,
              weight_decay=weight_decay)
    tx = j_make_optimizer(JOptimizerConfig(**kw), params=v["params"],
                          is_head=lambda p: not j_is_backbone(p),
                          grad_clip_norm=10.0)
    sample = jnp.zeros((1, *HW, 3), jnp.float32)
    state = create_train_state(jm, jax.random.PRNGKey(0), sample, tx,
                               ema_decay=ema_decay)
    params = jax.tree_util.tree_map(jnp.asarray, v["params"])
    state = state.replace(
        params=params, batch_stats=jax.tree_util.tree_map(
            jnp.asarray, v["batch_stats"]), opt_state=tx.init(params),
        ema_params=(jax.tree_util.tree_map(jnp.array, params)
                    if ema_decay > 0 else None))

    init_sd = from_flax_vitpose(v)
    model = ViTPose("vit_tiny", 17, "classic", (32, 32), dtype=torch.float32,
                    device="cpu", param_dtype=torch.float32)
    model.load_state_dict(init_sd)
    opt = make_optimizer(OptimizerConfig(**kw), model.named_parameters(),
                         is_head=lambda n: not is_backbone_path(n),
                         grad_clip_norm=10.0)
    tstate = TrainState(model, opt, ema_decay=ema_decay)

    batch = _batch()
    jstep = j_train_step(lambda p, t, w: j_mse(p, t, w), **AUG)
    tstep = make_heatmap_train_step(lambda p, t, w: joints_mse_loss(p, t, w),
                                    **AUG)
    jb = {k: jnp.asarray(a) for k, a in batch.items()}
    tb = {k: T(a) for k, a in batch.items()}
    out = []
    for t in range(n_steps):
        state, jmet = jstep(state, jb)
        rng = jax.random.fold_in(jax.random.PRNGKey(AUG["jitter_seed"]), t)
        _, rng_jit = jax.random.split(rng)
        jit = _jitter_draws(rng_jit, B, AUG["color_jitter_strength"])
        tmet = tstep(tstate, tb, draws={"jitter": jit})
        out.append(((float(jmet["loss"]), float(jmet["grad_norm"])),
                    (tmet["loss"].item(), tmet["grad_norm"].item())))
    jvars = {"params": jax.device_get(state.params),
             "batch_stats": jax.device_get(state.batch_stats)}
    jema = (None if state.ema_params is None else from_flax_vitpose(
        {"params": jax.device_get(state.ema_params),
         "batch_stats": jvars["batch_stats"]}))
    return out, init_sd, from_flax_vitpose(jvars), jema, tstate


@pytest.fixture(scope="module")
def adamw_run():
    return _run_vit_steps("adamw", (5e-4, 5e-4), 0.0, weight_decay=0.1)


@pytest.fixture(scope="module")
def sgd_run():
    return _run_vit_steps("sgd", (0.01, 0.02), 0.99)


def _report(steps, label):
    for t, ((jl, jg), (tl, tg)) in enumerate(steps):
        print(f"{label} step {t}: loss rel {abs(tl / jl - 1):.3g}, "
              f"grad_norm rel {abs(tg / jg - 1):.3g}")


def test_vit_train_step_adamw_matches_jax(adamw_run):
    """AdamW (vitpose_s.yaml's: lr 5e-4 both groups, weight decay 0.1,
    clip 10), 3 jittered steps: every loss and grad_norm rtol 1e-4 (no
    BatchNorm in the backbone, so none of the R50 step's float32
    cancellation); every parameter within lr / 10 of JAX's after 3 steps
    (Adam's first updates are about lr * sign(g), so a gradient that
    differs in its last bits moves a parameter by at most a fraction of
    lr) and every parameter moved."""
    steps, init, want_sd, _, tstate = adamw_run
    _report(steps, "adamw")
    for (jl, jg), (tl, tg) in steps:
        np.testing.assert_allclose(tl, jl, rtol=1e-4)
        np.testing.assert_allclose(tg, jg, rtol=1e-4)
    got = tstate.model.state_dict()
    worst = 0.0
    for n, _ in tstate.model.named_parameters():
        d = np.abs(got[n].numpy() - want_sd[n].numpy()).max()
        worst = max(worst, d)
        assert d <= 5e-5, n
        assert not np.array_equal(want_sd[n].numpy(), init[n].numpy()), n
    print(f"adamw params after 3 steps: max abs diff {worst:.3g}")


def test_vit_train_step_sgd_and_ema_match_jax(sgd_run):
    """SGD (momentum 0.9, clip 10, lr 0.01 backbone / 0.02 head) with EMA
    0.99, 3 jittered steps: loss and grad_norm rtol 1e-4; params, running
    statistics and the EMA within 1e-4 of each tensor's max |value| (the
    update is linear in the gradient)."""
    steps, _, want_sd, jema, tstate = sgd_run
    _report(steps, "sgd")
    for (jl, jg), (tl, tg) in steps:
        np.testing.assert_allclose(tl, jl, rtol=1e-4)
        np.testing.assert_allclose(tg, jg, rtol=1e-4)
    rel = _sd_rel(tstate.model.state_dict(), want_sd)
    assert max(rel.values()) < 1e-4, rel
    names = [n for n, _ in tstate.model.named_parameters()]
    ema = {n: e for n, e in zip(names, tstate.ema)}
    rel = _sd_rel(ema, jema, names)
    assert max(rel.values()) < 1e-4, rel


def test_for_eval_copies_the_vit_with_the_ema(sgd_run):
    """TrainState.for_eval on a ViTPose: a deep copy carrying the EMA
    parameters and the live BatchNorm statistics, in eval mode, whose
    forward equals the model's own with the EMA loaded."""
    _, _, _, _, tstate = sgd_run
    em = tstate.for_eval()
    assert em is not tstate.model and not em.training
    for e, p in zip(em.parameters(), tstate.ema):
        assert torch.equal(e, p)
    for e, b in zip(em.buffers(), tstate.model.buffers()):
        assert torch.equal(e, b)
    x = T(_images(27))
    ref = ViTPose("vit_tiny", 17, "classic", (32, 32), dtype=torch.float32,
                  device="cpu")
    ref.load_state_dict(em.state_dict())
    with torch.no_grad():
        assert torch.equal(em(x), ref(x))


def test_adamw_decays_every_parameter_like_optax():
    """optax.adamw without a mask decays every leaf: one AdamW update on a
    zero gradient (the Adam term is 0 / (0 + eps) = 0) leaves each
    parameter at p * (1 - lr * wd), biases, LayerNorm affines, layer
    scales and tokens included, in the port as in optax (rtol 1e-6)."""
    _, v, tm = _pair("classic", seed=31)
    lr, wd = 5e-4, 0.1
    cfg = dict(name="adamw", lr=lr, head_lr=lr, weight_decay=wd)
    tx = j_make_optimizer(JOptimizerConfig(**cfg), params=v["params"],
                          is_head=lambda p: not j_is_backbone(p))
    zeros = jax.tree_util.tree_map(jnp.zeros_like, v["params"])
    upd, _ = tx.update(zeros, tx.init(v["params"]), v["params"])
    want = from_flax_vitpose({"params": jax.device_get(
        optax.apply_updates(v["params"], upd)),
        "batch_stats": v["batch_stats"]})
    opt = make_optimizer(OptimizerConfig(**cfg), tm.named_parameters(),
                         is_head=lambda n: not is_backbone_path(n))
    before = {n: p.detach().clone() for n, p in tm.named_parameters()}
    for p in tm.parameters():
        p.grad = torch.zeros_like(p)
    opt.step()
    for n, p in tm.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[n].numpy(),
                                   rtol=1e-6, atol=1e-12, err_msg=n)
        np.testing.assert_allclose(p.detach().numpy(),
                                   before[n].numpy() * (1 - lr * wd),
                                   rtol=1e-6, atol=1e-12, err_msg=n)


# -- (e) freeze_backbone ---------------------------------------------------------

def test_freeze_backbone_is_stop_gradient():
    """freeze_backbone: JAX's gradients of every backbone parameter are 0
    (stop_gradient on the feature map); the port computes none (grad is
    None) and the head's gradients equal JAX's (1e-4 of each tensor's
    max); a Builder-style AdamW step with the backbone frozen leaves the
    backbone unchanged (no decay either, as optax's set_to_zero) and
    moves the head."""
    _, v, _ = _pair("classic", seed=32)
    jm = JViTPose(backbone="vit_tiny", num_keypoints=17, decoder="classic",
                  deconv_channels=(32, 32), dtype=jnp.float32,
                  freeze_backbone=True)
    x, tgt, tw = _vitpose_loss_case(28)
    _, want = _vitpose_grads_jax(jm, v, x, tgt, tw)
    tm = ViTPose("vit_tiny", 17, "classic", (32, 32), dtype=torch.float32,
                 device="cpu", freeze_backbone=True)
    tm.load_state_dict(from_flax_vitpose(v))
    tm.train()
    joints_mse_loss(tm(T(x)), T(tgt), T(tw)).backward()
    for n, p in tm.named_parameters():
        if is_backbone_path(n):
            assert p.grad is None, n
            assert not want[n].abs().max().item(), n
        else:
            assert _rel(p.grad.numpy(), want[n].numpy()) < 1e-4, n
    opt = make_optimizer(OptimizerConfig(name="adamw", lr=5e-4, head_lr=5e-4,
                                         weight_decay=0.1),
                         tm.named_parameters(),
                         is_head=lambda n: not is_backbone_path(n),
                         is_frozen=is_backbone_path, grad_clip_norm=10.0)
    before = {n: p.detach().clone() for n, p in tm.named_parameters()}
    opt.step()
    for n, p in tm.named_parameters():
        assert torch.equal(p, before[n]) == is_backbone_path(n), n


# -- (f) the Trainer and the CLI -------------------------------------------------

TINY_OVERRIDES = ("model.backbone=vit_tiny", "data.image_size=[64,48]",
                  "model.heatmap_size=[16,12]",
                  "model.deconv_channels=[32,32]",
                  "train.mixed_precision=false", "train.batch_size=16",
                  "train.warmup_epochs=0", "train.log_interval=100")


@pytest.fixture(scope="module")
def vit_trained(tmp_path_factory):
    """Two epochs of the ViTPose Trainer on the CPU (vitpose_s.yaml with
    the tiny overrides), a checkpoint after each."""
    from tpupose_torch.engine.trainer import Trainer

    out = tmp_path_factory.mktemp("vit_out")
    cfg, _ = _cfg(*TINY_OVERRIDES, "train.epochs=2",
                  f"train.output_dir={out}")
    tr = Trainer(cfg, device="cpu")
    losses = []
    for epoch in range(2):
        losses.append(tr.iter_one_epoch(epoch))
        tr.save_checkpoint(metric=losses[-1])
    return tr, cfg, losses


def test_vit_trainer_loss_falls_and_validates(vit_trained):
    tr, _, (l0, l1) = vit_trained
    assert isinstance(tr.model, ViTPose) and tr.family == "heatmap"
    assert tr.steps_per_epoch == 16
    assert np.isfinite(l0) and np.isfinite(l1)
    assert l1 < l0, f"loss did not fall: {l0} -> {l1}"
    assert np.isfinite(tr.validate())


def test_vit_trainer_checkpoint_round_trip_is_exact(vit_trained):
    """A fresh Trainer restores the step, every parameter, buffer and
    optimizer state, and its next step equals the original's."""
    from tpupose_torch.engine.trainer import Trainer

    tr, cfg, _ = vit_trained
    tr2 = Trainer(cfg, device="cpu")
    assert tr2.load_checkpoint() == tr.state.step == tr2.state.step
    for (k, a), b in zip(tr.model.state_dict().items(),
                         tr2.model.state_dict().values()):
        assert torch.equal(a, b), k
    batch = next(iter(tr.train_loader))
    m1 = tr.train_step(tr.state, tr._prepare_batch(batch))
    m2 = tr2.train_step(tr2.state, tr2._prepare_batch(batch))
    assert m1["loss"].item() == m2["loss"].item()
    for a, b in zip(tr.model.parameters(), tr2.model.parameters()):
        assert torch.equal(a, b)


def test_cli_trains_vitpose_one_epoch_on_cpu(tmp_path):
    from tpupose_torch.cli.train import main

    assert main(["--cfg", VITPOSE_S, "--device", "cpu", *TINY_OVERRIDES,
                 "train.epochs=1", "train.remat=true",
                 f"train.output_dir={tmp_path}"]) == 0
    assert list(tmp_path.rglob("*ckpt*"))


# -- (g) the CUDA route ----------------------------------------------------------

def test_cuda_backward_goes_to_k8b_never_the_plain_version(monkeypatch):
    """The route of a CUDA attention that will be differentiated, on fake
    CUDA tensors (a torch without CUDA cannot record an autograd graph on
    them, so the autograd.Function's two halves are called as the engine
    calls them): fused_attention goes through the autograd.Function
    exactly when grad is enabled and an input requires grad, and
    otherwise straight to K8 (an eager call runs the body of K8's
    torch.library op); the Function's forward hands K8 a non-null LSE
    pointer and saves q, k, v, o and the LSE, the call without autograd
    a null one;
    the backward is one launch of K8b's wrapper with the saved q/k/v
    strides. Neither plain version is reached."""
    import warnings

    from torch._subclasses.fake_tensor import FakeTensorMode

    from tpupose_torch.ops import _build, attention, cuda_attention

    def plain(*a, **k):
        raise AssertionError("a plain version was reached for CUDA")

    class Ctx:
        def save_for_backward(self, *ts):
            self.saved_tensors = ts

    launched, applied = [], []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(attention, "attention_reference", plain)
    monkeypatch.setattr(attention, "attention_backward_reference", plain)
    monkeypatch.setattr(_build, "bind", lambda src, name, argtypes: (
        lambda *args: launched.append((name, args)) or 0))
    monkeypatch.setattr(_build, "stream_of", lambda t: 0)
    fn = cuda_attention._FlashAttention
    n0 = cuda_attention.flash_attention.launches
    b0 = cuda_attention.flash_attention_backward.launches
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)   # fake data_ptr()
        with FakeTensorMode(allow_non_fake_inputs=True):
            qkv = torch.empty((2, 21, 3 * 2 * 64), dtype=torch.bfloat16,
                              device="cuda")
            q, k, v = qkv.view(2, 21, 3, 2, 64).unbind(2)
            monkeypatch.setattr(cuda_attention, "_FlashAttention", type(
                "Stub", (), {"apply": staticmethod(
                    lambda *a: applied.append(a[-1]))}))
            attention.fused_attention(q, k, v)
            q.requires_grad_()
            attention.fused_attention(q, k, v)
            with torch.no_grad():
                attention.fused_attention(q, k, v)
            q.requires_grad_(False)
            ctx = Ctx()
            out = fn.forward(ctx, q, k, v, 0.125)
            grads = fn.backward(ctx, torch.ones_like(out))
    assert applied == [0.125]                # the one call that needs grad
    assert [len(t.shape) for t in ctx.saved_tensors] == [4, 4, 4, 4, 3]
    assert [tuple(g.shape) for g in grads[:3]] == [(2, 21, 2, 64)] * 3
    assert grads[3:] == (None,)
    assert [n for n, _ in launched] == ["tp_flash_attention",
                                        "tp_flash_attention",
                                        "tp_flash_attention",
                                        "tp_flash_attention_bwd"]
    nograd1, nograd2, fwd, bwd = (a for _, a in launched)
    assert fwd[-2] is not None                                 # lse pointer
    assert nograd1[-2] is None and nograd2[-2] is None
    s = (21 * 384, 384, 64)
    assert bwd[10:22] == (2, 21, 2, *s, *s, *s)
    assert cuda_attention.flash_attention.launches == n0 + 3
    assert cuda_attention.flash_attention_backward.launches == b0 + 1
