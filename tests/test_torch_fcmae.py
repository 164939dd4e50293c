"""tpupose_torch's FCMAE against the JAX package on the CPU: the random
patch mask, patchify, the stem mask's nearest upsampling, and FCMAE's
loss, prediction and gradients with the same mask handed to both, on
ConvNeXtV2-atto at 64x64 (patch 32: 4 cells), decoder width 64, float32,
JAX's weights carried across by utils/convert.from_flax_fcmae after the
zero-initialised biases, GRN parameters, layer scale and mask token were
given O(1) values. Tolerances: 1e-4 of the reference's largest magnitude
for the loss and the prediction, 1e-3 for the gradients."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpupose.models.fcmae import FCMAE as JFCMAE
from tpupose.models.fcmae import patchify as j_patchify
from tpupose_torch.models.fcmae import FCMAE, gen_random_mask, patchify
from tpupose_torch.utils.convert import from_flax_fcmae
from torch_threads import one_torch_thread  # noqa: F401


def _rel(got, want):
    got = np.asarray(got.detach() if isinstance(got, torch.Tensor) else got,
                     np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-12)


@pytest.mark.parametrize("L,ratio", [(16, 0.5), (49, 0.6), (5, 0.5),
                                     (4, 0.75)])
def test_gen_random_mask_counts(L, ratio):
    """Exactly round(ratio * L) ones a row (Python's round: 2.5 -> 2),
    reproducible from the generator's seed, different across rows."""
    g = torch.Generator().manual_seed(3)
    m = gen_random_mask(g, 6, L, ratio)
    assert m.shape == (6, L) and m.dtype == torch.float32
    assert (m.sum(1) == round(ratio * L)).all()
    again = gen_random_mask(torch.Generator().manual_seed(3), 6, L, ratio)
    assert torch.equal(m, again)
    if 0 < round(ratio * L) < L:
        assert len({tuple(r.tolist()) for r in m}) > 1


def test_patchify_matches_jax():
    x = np.random.RandomState(0).rand(2, 64, 96, 3).astype(np.float32)
    want = j_patchify(jnp.asarray(x), 32)
    got = patchify(torch.from_numpy(x), 32)
    assert got.shape == (2, 6, 32 * 32 * 3)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_stem_mask_is_jax_nearest_resize():
    """The stem mask: nearest x(p/4) upsampling of the (B, H/p, W/p) mask,
    as jax.image.resize(..., "nearest") at an integer factor."""
    m = (np.random.RandomState(1).rand(2, 3, 4) > 0.5).astype(np.float32)
    want = jax.image.resize(jnp.asarray(m), (2, 24, 32), method="nearest")
    t = torch.from_numpy(m)
    got = t.repeat_interleave(8, 1).repeat_interleave(8, 2)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _randomize(tree, rs):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _randomize(v, rs)
            continue
        v = np.asarray(v, np.float32)
        if k in ("bias", "beta", "mask_token"):
            v = rs.normal(0, 0.1, v.shape)
        elif k == "scale":
            v = rs.uniform(0.7, 1.3, v.shape)
        elif k == "gamma":
            v = rs.uniform(0.2, 0.6, v.shape)
        out[k] = v.astype(np.float32)
    return out


@pytest.fixture(scope="module")
def pair():
    """flax FCMAE (atto, patch 32, decoder 64) and its randomized params,
    the port's FCMAE with them."""
    jm = JFCMAE(size="atto", patch_size=32, mask_ratio=0.5, decoder_dim=64,
                dtype=jnp.float32)
    x = jnp.zeros((1, 64, 64, 3), jnp.float32)
    v = jax.jit(functools.partial(jm.init, train=False))(
        {"params": jax.random.PRNGKey(0), "mask": jax.random.PRNGKey(1)}, x)
    p = _randomize(jax.tree_util.tree_map(np.asarray, v["params"]),
                   np.random.RandomState(2))
    tm = FCMAE(size="atto", patch_size=32, mask_ratio=0.5, decoder_dim=64,
               dtype=torch.float32, device="cpu")
    tm.load_state_dict(from_flax_fcmae({"params": p}))
    return jm, p, tm


@pytest.mark.parametrize("norm_pix", [True, False], ids=["normpix", "raw"])
def test_fcmae_loss_pred_and_grads_match_jax(pair, norm_pix):
    jm, p, tm = pair
    jm = jm.clone(norm_pix=norm_pix)
    tm.norm_pix = norm_pix
    rs = np.random.RandomState(3)
    x = rs.uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)
    mask = np.array([[1, 0, 0, 1], [0, 1, 1, 0]], np.float32)

    def j_loss(params):
        loss, out = jm.apply({"params": params}, jnp.asarray(x),
                             mask=jnp.asarray(mask), train=True)
        return loss, out["pred"]

    (want, want_pred), want_g = jax.jit(
        jax.value_and_grad(j_loss, has_aux=True))(
        jax.tree_util.tree_map(jnp.asarray, p))
    tm.zero_grad()
    loss, out = tm(torch.from_numpy(x), mask=torch.from_numpy(mask))
    loss.backward()
    assert _rel(loss, want) < 1e-4
    assert _rel(out["pred"], want_pred) < 1e-4
    assert torch.equal(out["mask"], torch.from_numpy(mask))
    wg = from_flax_fcmae({"params": jax.tree_util.tree_map(np.asarray,
                                                          want_g)})
    scale = max(float(g.abs().max()) for g in wg.values())
    for n, q in tm.named_parameters():
        got = q.grad if q.grad is not None else torch.zeros_like(q)
        assert float((got - wg[n]).abs().max()) <= 1e-3 * scale, n


def test_fcmae_masked_pixels_reach_no_prediction(pair):
    """The stem zeroes every 4x4 cell of a masked patch, so no later layer
    sees its pixels (what the sparse encoder computes on the visible
    set): the prediction is the same whatever they are. The loss is not:
    its target is those pixels."""
    _, _, tm = pair
    rs = np.random.RandomState(4)
    x = torch.from_numpy(rs.uniform(0, 1, (1, 64, 64, 3)).astype(np.float32))
    mask = torch.tensor([[1.0, 0.0, 0.0, 0.0]])
    y = x.clone()
    y[:, :32, :32] = 0.5                    # patch 0, masked
    with torch.no_grad():
        la, a = tm(x, mask=mask)
        lb, b = tm(y, mask=mask)
    assert torch.equal(a["pred"], b["pred"])
    assert float(la) != float(lb)


def test_fcmae_draws_its_mask_from_the_generator(pair):
    _, _, tm = pair
    x = torch.rand(3, 64, 64, 3, generator=torch.Generator().manual_seed(5))
    with torch.no_grad():
        la, a = tm(x, generator=torch.Generator().manual_seed(6))
        lb, b = tm(x, generator=torch.Generator().manual_seed(6))
    assert torch.equal(a["mask"], b["mask"]) and float(la) == float(lb)
    assert (a["mask"].sum(1) == 2).all()
    with pytest.raises(ValueError, match="multiple of the patch size"):
        tm(torch.rand(1, 48, 64, 3), generator=torch.Generator())
