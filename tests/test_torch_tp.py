"""The port's tensor-parallel 'model' axis (tpupose_torch/parallel/
tensor_parallel.py, mesh.py and the Trainer under a (data, model) mesh)
against JAX's model = 2 step and against the port's own model = 1.

The parallel runs are spawned gloo processes over a FileStore under
tmp_path (tests/torch_dp_worker.py, which imports no JAX), every
collective with a timeout; the parent joins them with a deadline and
kills what is left. One two-rank run (data 1 x model 2) carries every
two-rank case (`tp_suite`), one four-rank run the data 2 x model 2 case
(`tp_axes`); each model = 1 reference is one process without a group.
JAX's model = 2 step runs in the test process, on a data 1 x model 2
mesh over 2 of the 8 CPU devices tests/conftest.py makes.

Bounds:
  - against JAX's model = 2 step (tests/test_model_axis_tp.py's setting,
    the weights carried across by from_flax_simple_baseline): JAX's own,
    loss rtol 1e-5, every updated tensor rtol 1e-4 / atol 1e-6, plus
    what the float32 gradient floor moves AdamW's first step by on
    near-zero gradients (_adam_slack);
  - gradients at model = 2 against model = 1 (float32, SGD): 1e-5 abs +
    1e-4 rel, and a doubled gradient (what torch's all_gather backward
    gives after a replicated computation) must fail that bound;
  - data 2 x model 2 against one process at the global batch:
    tests/test_torch_dp.py's bounds for the same augmented step;
  - module level and optimizers: 1e-5 abs + 1e-4 rel.
"""

import multiprocessing as mp
import shutil
import time

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import torch_dp_worker as worker
from tpupose.engine.train_state import create_train_state
from tpupose.engine.train_state import make_heatmap_train_step as j_step
from tpupose.losses.heatmap import joints_mse_loss as j_mse
from tpupose.models.simple_baseline import SimpleBaseline as JSimpleBaseline
from tpupose.parallel.mesh import MeshManager as JMeshManager
from tpupose_torch.parallel import mesh
from tpupose_torch.utils.convert import from_flax_simple_baseline

from torch_threads import one_torch_thread  # noqa: F401

DEADLINE_S = 240


def _start(tmp_path, case: str, world: int):
    ctx = mp.get_context("spawn")
    store = tmp_path / f"store_{case}"
    procs = [ctx.Process(target=worker.run,
                         args=(r, world, str(store), str(tmp_path), case))
             for r in range(world)]
    for p in procs:
        p.start()
    return procs


def _join(tmp_path, case: str, procs):
    end = time.monotonic() + DEADLINE_S
    for p in procs:
        p.join(max(0.0, end - time.monotonic()))
    hung = [p for p in procs if p.is_alive()]
    for p in hung:
        p.kill()
        p.join()
    assert not hung, f"{case}: {len(hung)} rank(s) still running after " \
                     f"{DEADLINE_S} s, killed"
    assert [p.exitcode for p in procs] == [0] * len(procs)
    return [torch.load(tmp_path / f"{case}_{r}.pt", weights_only=False)
            for r in range(len(procs))]


def _jax_setting():
    """tests/test_model_axis_tp.py's model, batch and initial state."""
    net = JSimpleBaseline(backbone="resnet18", num_keypoints=4,
                          deconv_channels=(64, 64, 64), dtype=jnp.float32)
    rng = np.random.RandomState(0)
    batch = {"images": rng.randint(0, 255, (8, 64, 64, 3)).astype(np.uint8),
             "joints": rng.uniform(2, 12, (8, 4, 2)).astype(np.float32),
             "visibility": np.ones((8, 4), np.float32)}
    state = create_train_state(net, jax.random.PRNGKey(0),
                               jnp.zeros((1, 64, 64, 3)), optax.adamw(1e-3))
    return state, batch


def _jax_model2_step(state, batch):
    """JAX's step on a data 1 x model 2 mesh (2 of the 8 CPU devices),
    through MeshManager.shard_state, as tests/test_model_axis_tp.py."""
    mgr = JMeshManager(data=1, model=2)
    state = mgr.shard_state(state)
    specs = jax.tree_util.tree_leaves(jax.tree_util.tree_map(
        lambda x: str(x.sharding.spec), state.params))
    assert any("model" in s for s in specs)
    step = j_step(j_mse, heatmap_size=(16, 16))
    state, metrics = step(state, mgr.shard_batch(batch))
    got = from_flax_simple_baseline({
        "params": jax.device_get(state.params),
        "batch_stats": jax.device_get(state.batch_stats)})
    return float(metrics["loss"]), got


def _port_grads(init_sd, batch, f64) -> dict:
    """Each parameter's gradient of the step's loss, in float64 (how far
    from zero each element's gradient really is) or float32 (the port's
    model and loss, no augmentation, as the step runs them)."""
    from tpupose_torch.losses.heatmap import joints_mse_loss
    from tpupose_torch.models.simple_baseline import SimpleBaseline
    from tpupose_torch.ops.heatmap import gaussian_heatmaps
    from tpupose_torch.ops.preprocess import normalize_images

    f64 = torch.float64 if f64 else torch.float32
    model = SimpleBaseline("resnet18", 4, (64, 64, 64), dtype=f64,
                           device="cpu", param_dtype=f64)
    model.load_state_dict(init_sd)
    imgs = normalize_images(torch.from_numpy(batch["images"])).to(f64)
    t, tw = gaussian_heatmaps(torch.from_numpy(batch["joints"]),
                              torch.from_numpy(batch["visibility"]),
                              (16, 16), 2.0)
    loss = joints_mse_loss(model.train()(imgs), t.permute(0, 2, 3, 1).to(f64),
                           tw.to(f64))
    loss.backward()
    return {n: p.grad for n, p in model.named_parameters()}


def _copy_ckpt(src, dst):
    shutil.copytree(src / "default" / "ckpt", dst)


@pytest.fixture(scope="module")
def tp(tmp_path_factory):
    """The two-rank suite and its model = 1 references, run side by side:
    JAX's model = 2 step runs in this process while the ranks work."""
    tmp = tmp_path_factory.mktemp("tp")
    run = tmp / "run_tp_suite"
    run.mkdir()
    jstate, jbatch = _jax_setting()
    init_sd = from_flax_simple_baseline({
        "params": jax.device_get(jstate.params),
        "batch_stats": jax.device_get(jstate.batch_stats)})
    torch.save(init_sd, run / "init.pt")
    torch.save({k: torch.from_numpy(v) for k, v in jbatch.items()},
               run / "batch.pt")
    ref = tmp / "ref"
    ref.mkdir()
    ckpt1 = worker.tp_checkpoint(str(ref / "ckpt"), model=1)
    _copy_ckpt(ref / "ckpt", run / "restore_me")
    procs = _start(tmp, "tp_suite", 2)
    try:
        jax_loss, jax_state = _jax_model2_step(jstate, jbatch)
        one = {"grads": worker.tp_grads(str(ref / "grads"), model=1),
               "modules": worker.tp_modules(str(ref), model=1),
               "optimizers": worker.tp_optimizers(str(ref), model=1),
               "checkpoint": ckpt1,
               "evaluate": worker.tp_evaluate(str(ref / "eval"), model=1)}
        g64 = _port_grads(init_sd, jbatch, True)
        g32 = _port_grads(init_sd, jbatch, False)
    finally:
        ranks = _join(tmp, "tp_suite", procs)
    return {"ranks": ranks, "one": one, "jax": (jax_loss, jax_state, g64),
            "g32": g32, "tmp": tmp}


def _close(got, want, rtol, atol, label):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol, err_msg=label)


# AdamW's first step moves an element by lr g / (|g| + eps), whose
# derivative in g is lr eps / (|g| + eps)^2: where an element's gradient
# is near 0 a float32 gradient error moves the step far more than the
# bound. Both float32 gradients are off the float64 one: flax's by up to
# 1.66e-5 of a tensor's largest element on this setting, the port's by
# less (asserted below against F32_GRAD_ERR). So each element is held at
# JAX's bound plus what an error of F32_GRAD_ERR of its tensor's largest
# gradient, g_err, moves that step by, lr eps g_err / (|g64| - g_err +
# eps)^2, capped at 2 lr (the two signs); where |g64| is 100 g_err or
# more that term is below 1e-8.
F32_GRAD_ERR = 2e-5
LR, EPS, ATOL, RTOL = 1e-3, 1e-8, 1e-6, 1e-4


def _adam_slack(g64: torch.Tensor) -> np.ndarray:
    """Each element's allowance for the float32 gradient floor (above)."""
    g = g64.abs()
    err = F32_GRAD_ERR * g.max()
    d = (g - err).clamp_min(0.0) + EPS
    return (LR * EPS * err / (d * d)).clamp_max(2 * LR).numpy()


def test_model2_step_matches_jax_model2(tp):
    """The Trainer's AdamW step at data 1 x model 2 against JAX's at data
    1 x model 2 on test_model_axis_tp.py's setting: loss rtol 1e-5,
    every updated parameter and BatchNorm statistic rtol 1e-4 / atol
    1e-6 plus _adam_slack's float32 gradient floor (1e-8 or less but on
    near-zero gradients), the port's float32 gradient within that floor
    of float64; both ranks hold the same
    full model, and the model really is sharded (the head's
    deconvolutions and every ResNet conv of 64 or more channels)."""
    jax_loss, want, g64 = tp["jax"]
    r0, r1 = (r["jax"] for r in tp["ranks"])
    np.testing.assert_allclose(r0["loss"], jax_loss, rtol=1e-5)
    assert r0["loss"] == r1["loss"]
    assert {"head.deconv_layers.0.weight", "head.deconv_layers.3.weight",
            "head.deconv_layers.6.weight", "backbone.conv1.weight",
            "backbone.layer4.1.conv2.weight"} <= set(r0["sharded"])
    assert r0["state"].keys() == want.keys()
    for k, g in tp["g32"].items():
        assert (g.double() - g64[k]).abs().max() <= \
            F32_GRAD_ERR * g64[k].abs().max(), k
    wide, total = 0, 0
    for k, w in want.items():
        if not w.is_floating_point():
            continue
        assert torch.equal(r0["state"][k], r1["state"][k]), k
        got, w = r0["state"][k].numpy(), w.numpy()
        slack = _adam_slack(g64[k]) if k in g64 else np.zeros(w.shape)
        bound = ATOL + RTOL * np.abs(w) + slack
        assert (np.abs(got - w) <= bound).all(), \
            f"{k}: {np.abs(got - w).max()} (bound {bound.min()})"
        wide += int((slack > ATOL).sum())
        total += w.size
    print(f"elements whose bound the float32 floor widens past 1e-6: "
          f"{wide} of {total}")


def test_model2_gradients_equal_model1(tp):
    """Float32 SGD, two steps: every parameter's gradient, gathered, at
    model = 2 equals model = 1's within 1e-5 abs + 1e-4 rel, on each
    rank, and so do the losses (rtol 1e-5) and the parameters after
    (1e-5 abs + 1e-4 rel)."""
    one = tp["one"]["grads"]
    assert one["sharded"] == []
    for r in tp["ranks"]:
        got = r["grads"]
        assert got["names"] == one["names"] and len(got["sharded"]) >= 20
        np.testing.assert_allclose(got["loss"], one["loss"], rtol=1e-5)
        for step, (gs, ws) in enumerate(zip(got["grads"], one["grads"])):
            for n, g, w in zip(one["names"], gs, ws):
                _close(g.numpy(), w.numpy(), 1e-4, 1e-5, f"{step} {n}")
        for k, w in one["state"].items():
            if w.is_floating_point():
                _close(got["state"][k].numpy(), w.numpy(), 1e-4, 1e-5, k)


def test_a_doubled_gradient_fails_the_gradient_bound(tp):
    """The bound above can fail: twice the model = 2 gradients (what
    torch.distributed.nn.functional.all_gather's summing backward gives
    after a replicated computation, a conv's weight gradient included)
    is refused for every sharded weight."""
    one = tp["one"]["grads"]
    got = tp["ranks"][0]["grads"]
    sharded = set(got["sharded"])
    refused = 0
    for n, g, w in zip(one["names"], got["grads"][0], one["grads"][0]):
        if n not in sharded:
            continue
        with pytest.raises(AssertionError):
            _close(2 * g.numpy(), w.numpy(), 1e-4, 1e-5, n)
        refused += 1
    assert refused == len(sharded) >= 20


def test_vit_and_convnext_block_sharded_equal_unsharded(tp):
    """A depth-2 dim-64 ViT (plain attention; qkv, proj, fc1, fc2 and the
    patch embedding sharded), a ConvNeXt block (the depthwise conv by
    whole groups, pwconv1, pwconv2) and yolo_head's Float32Conv under
    bf16 autocast (its own forward kept: float32 out) at model = 2
    against model = 1: outputs, input gradients and every parameter's
    gradient within 1e-5 abs + 1e-4 rel. gather_full's copy of the
    block has torch's own layers and full channel and group counts
    back."""
    one = tp["one"]["modules"]
    for r in tp["ranks"]:
        got = r["modules"]
        names = got["sharded"]
        for part in ("attn.qkv", "attn.proj", "mlp.fc1", "mlp.fc2",
                     "patch_embed.proj", "blk.dwconv", "blk.pwconv1",
                     "blk.pwconv2", "f32conv"):
            assert any(part in n for n in names), part
        assert got["f32"].dtype == torch.float32
        assert got["full_blk"] == one["full_blk"] == [
            ("Conv2d", 64, 64, 64), ("Linear", 64, 256, 0),
            ("Linear", 256, 64, 0)]
        for k in ("out", "y", "gx", "gz", "f32"):
            _close(got[k].numpy(), one[k].numpy(), 1e-4, 1e-5, k)
        for i, (g, w) in enumerate(zip(got["grads"], one["grads"])):
            _close(g.numpy(), w.numpy(), 1e-4, 1e-5, f"grad {i}")


@pytest.mark.parametrize("name", ["sgd", "lamb", "lars", "fromage"])
def test_optimizers_under_tensor_parallelism_equal_model1(tp, name):
    """grad_clip_norm (sgd clipped at 0.05, so the clip scales every
    step), and the trust-ratio rules lamb, lars and fromage, whose
    per-leaf norms and the global norm take a sharded leaf's whole norm:
    two steps at model = 2 equal model = 1 (norms rtol 1e-5, parameters
    1e-5 abs + 1e-4 rel)."""
    want = tp["one"]["optimizers"][name]
    for r in tp["ranks"]:
        got = r["optimizers"][name]
        assert len(got["sharded"]) == 2
        np.testing.assert_allclose(got["norms"], want["norms"], rtol=1e-5)
        if name == "sgd":
            assert min(want["norms"]) > 0.05
        for i, (g, w) in enumerate(zip(got["params"], want["params"])):
            _close(g.numpy(), w.numpy(), 1e-4, 1e-5, f"{name} {i}")


def _load(path):
    return torch.load(path, weights_only=True)


def _flat(sd, prefix=""):
    """{dotted key: tensor or value} of a nested checkpoint dict."""
    out = {}
    for k, v in (sd.items() if isinstance(sd, dict) else enumerate(sd)):
        key = f"{prefix}{k}"
        if isinstance(v, (dict, list, tuple)):
            out.update(_flat(v, key + "."))
        else:
            out[key] = v
    return out


def test_checkpoint_is_the_model1_format_and_restores_both_ways(tp, tmp_path):
    """A model = 2 checkpoint (EMA, momentum) has a model = 1
    checkpoint's keys and shapes, and its values within 1e-5 abs + 1e-4
    rel; the model = 1 checkpoint restored at model = 2 and saved again
    is the same file content exactly (EMA and moments sliced and
    gathered back); the model = 2 checkpoint restored at model = 1 gives
    back that file's state exactly."""
    from tpupose_torch.engine.trainer import Trainer

    run = tp["tmp"] / "run_tp_suite"
    f1 = _flat(_load(run / "restore_me" / "periodic" / "1.pt"))
    f2 = _flat(_load(run / "ckpt" / "default" / "ckpt" / "periodic" / "1.pt"))
    assert f1.keys() == f2.keys()
    assert any(".momentum_buffer" in k for k in f1) and any(
        k.startswith("ema.") for k in f1)
    for k, w in f1.items():
        g = f2[k]
        if torch.is_tensor(w):
            assert g.shape == w.shape and g.dtype == w.dtype, k
            if w.is_floating_point():
                _close(g.numpy(), w.numpy(), 1e-4, 1e-5, k)
        else:
            assert g == w, k
    back = _flat(_load(run / "ckpt" / "resaved" / "periodic" / "1.pt"))
    assert back.keys() == f1.keys()
    for k, w in f1.items():
        assert (torch.equal(back[k], w) if torch.is_tensor(w)
                else back[k] == w), k
    tr = Trainer(worker.tp_cfg(str(tmp_path), 1, **worker.CKPT_OVER),
                 device="cpu")
    tr.load_checkpoint(str(run / "ckpt" / "default" / "ckpt"))
    mine = _flat(tr.state.state_dict())
    assert mine.keys() == f2.keys()
    for k, w in f2.items():
        assert (torch.equal(mine[k], w) if torch.is_tensor(w)
                else mine[k] == w), k


def test_eval_model_is_the_gathered_ema(tp):
    """for_eval() at model = 2 is a full, unsharded copy carrying the
    gathered EMA and the live statistics: model = 1's within 1e-5 abs +
    1e-4 rel, the same on both ranks."""
    want = tp["one"]["checkpoint"]["eval"]
    r0, r1 = (r["checkpoint"]["eval"] for r in tp["ranks"])
    assert r0.keys() == want.keys()
    for k, w in want.items():
        assert r0[k].shape == w.shape, k
        if w.is_floating_point():
            _close(r0[k].numpy(), w.numpy(), 1e-4, 1e-5, k)
        assert torch.equal(r0[k], r1[k]), k


def test_evaluate_under_model2_gives_model1_metrics(tp):
    """Trainer.evaluate() on the gathered model at model = 2 (flip test,
    DARK decode, PCK, MPJPE, OKS-AP; the plain route on the CPU) gives
    model = 1's metrics within 1e-6 on both ranks."""
    want = tp["one"]["evaluate"]
    assert {"pck", "mpjpe"} <= set(want)
    for r in tp["ranks"]:
        got = r["evaluate"]
        assert got.keys() == want.keys()
        for k, w in want.items():
            np.testing.assert_allclose(got[k], w, rtol=1e-6, atol=1e-6,
                                       err_msg=k)


def test_data2_model2_equals_one_process_at_the_global_batch(tmp_path):
    """data 2 x model 2 (4 ranks): each rank's mesh coordinates are
    rank = d * 2 + m with its data and model groups, the loader and the
    draws keyed on the data rank; the ranks' augmented inputs (device
    affine, color jitter) put together per data rank equal one process's
    at the global batch bit for bit, and the model ranks of a data index
    see the same; the loss (rtol 1e-5), the grad norm (rtol 2e-3, as
    tests/test_torch_dp.py's augmented step) and every parameter and
    BatchNorm statistic (1e-5 abs + 1e-4 rel) equal one process's; the
    yolo mosaic draws are equal across model ranks and differ across
    data ranks."""
    ranks = _join(tmp_path, "tp_axes", _start(tmp_path, "tp_axes", 4))
    cfg_out = str(tmp_path / "single")
    one = worker.trainer_steps(cfg_out, augment=True, deconv=64)
    for r, res in enumerate(ranks):
        d, m = divmod(r, 2)
        assert res["coords"] == (d, m)
        assert res["groups"] == ([m, 2 + m], [2 * d, 2 * d + 1])
        assert res["dp"] == (d, 2, (d, 2))
        assert len(res["sharded"]) >= 20
    for d in range(2):
        a, b = ranks[2 * d], ranks[2 * d + 1]
        for x, y in zip(a["inputs"][0], b["inputs"][0]):
            assert torch.equal(x, y)
        for k, v in a["mosaic"].items():
            assert torch.equal(v, b["mosaic"][k]), k
    assert any(not torch.equal(v, ranks[2]["mosaic"][k])
               for k, v in ranks[0]["mosaic"].items())
    for a, b, w in zip(ranks[0]["inputs"][0], ranks[2]["inputs"][0],
                       one["inputs"][0]):
        assert torch.equal(torch.cat([a, b]), w)
    for res in ranks:
        np.testing.assert_allclose(res["loss"], one["loss"], rtol=1e-5)
        np.testing.assert_allclose(res["grad_norm"], one["grad_norm"],
                                   rtol=2e-3)
        for k, w in one["state"].items():
            if w.is_floating_point():
                _close(res["state"][k].numpy(), w.numpy(), 1e-4, 1e-5, k)


def test_mesh_layout_and_errors():
    """Ranks map row-major onto (data, model); JAX's errors for sizes
    that do not divide, and a single process's (1, 1) layout."""
    assert [mesh.mesh_coords(r, 2) for r in range(4)] == \
        [(0, 0), (0, 1), (1, 0), (1, 1)]
    assert mesh.mesh_coords(5, 3) == (1, 2)
    assert mesh.mesh_shape(-1, 2, world=8) == (4, 2)
    assert mesh.mesh_shape(2, 4, world=8) == (2, 4)
    assert mesh.mesh_shape(1, 8, world=8) == (1, 8)
    with pytest.raises(ValueError, match="8 devices not divisible by "
                                         "model=3"):
        mesh.mesh_shape(-1, 3, world=8)
    with pytest.raises(ValueError, match="needs 16 devices, have 8"):
        mesh.mesh_shape(4, 4, world=8)
    with pytest.raises(ValueError, match="without a place"):
        mesh.mesh_shape(1, 2, world=8)
    with pytest.raises(ValueError, match="1 devices not divisible by "
                                         "model=2"):
        mesh.MeshManager(model=2, device="cpu")
    mm = mesh.MeshManager(device="cpu")
    assert (mm.data_rank, mm.model_rank, mm.data_size, mm.model_size) == \
        (0, 0, 1, 1)
    assert mm.data_group is None and mm.model_group is None


def test_mesh_flags_reach_cfg_mesh():
    """--mesh-data / --mesh-model (JAX's parser flags) set cfg.mesh, and
    a dotted override after them still wins, as in JAX."""
    from tpupose_torch.configs import default_config, parse_args, update_config

    args = parse_args(["--mesh-data", "2", "--mesh-model", "4",
                       "--device", "cpu"])
    cfg = update_config(default_config(), args)
    assert (cfg.mesh.data, cfg.mesh.model) == (2, 4)
    args = parse_args(["--mesh-model", "2", "mesh.model=8"])
    assert update_config(default_config(), args).mesh.model == 8
    cfg = update_config(default_config(), parse_args([]))
    assert (cfg.mesh.data, cfg.mesh.model) == (-1, 1)


def test_step_draws_depend_on_the_seed_on_the_cpu():
    """A CPU generator keeps only the low 32 bits of its seed: the step
    seed's low bits carry the run's seed too, so two seeds (and two
    ranks' mosaic seeds) draw differently on the CPU, and one seed and
    step draw the same values again."""
    from tpupose_torch.engine.train_state import (make_yolo_train_step,
                                                  step_seed)

    assert len({step_seed(s, t) & 0xFFFFFFFF for s in range(4)
                for t in range(4)}) == 16
    step = make_yolo_train_step(None, mosaic_prob=0.5, mosaic_seed=3)
    a, b = (step.draws_for(0, 4, "cpu", r)["mosaic"] for r in (0, 1))
    again = step.draws_for(0, 4, "cpu", 0)["mosaic"]
    assert not torch.equal(a["centers"], b["centers"])
    assert all(torch.equal(v, again[k]) for k, v in a.items())
