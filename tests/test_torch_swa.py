"""SWA checkpoint averaging in the port (engine/checkpoint.
average_checkpoints, `python -m tpupose_torch.cli.tools average-ckpts`)
against the JAX package's, on the CPU.

Three seeded flax SimpleBaseline-R18 variable sets (non-trivial BatchNorm
statistics; an EMA set each, apart from the parameters) are saved as
orbax checkpoints by tpupose's CheckpointManager and, carried across by
`from_flax_simple_baseline`, as the port's checkpoints at the same steps.
Both packages average them; the port's parameters, statistics and EMA
equal JAX's average carried across within 1e-6 of each tensor's largest
|value| (float32 sums of 2-3 terms in another order), and the numpy mean
of the converted tensors likewise.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tpupose.engine.checkpoint import CheckpointManager as JManager
from tpupose.engine.checkpoint import average_checkpoints as j_average
from tpupose.engine.train_state import create_train_state
from tpupose.models.simple_baseline import SimpleBaseline as JSimpleBaseline
from tpupose_torch.configs.default import OptimizerConfig
from tpupose_torch.engine.checkpoint import (CheckpointManager,
                                             average_checkpoints,
                                             restore_for_eval)
from tpupose_torch.engine.optimizers import make_optimizer
from tpupose_torch.engine.train_state import TrainState
from tpupose_torch.models.simple_baseline import SimpleBaseline
from tpupose_torch.utils.convert import from_flax_simple_baseline

from test_torch_model import _randomize_bn
from torch_threads import one_torch_thread  # noqa: F401

K = 4
STEPS = (10, 20, 30)
TOL = 1e-6


def _flax_vars(seed):
    jm = JSimpleBaseline(backbone="resnet18", num_keypoints=K,
                         deconv_channels=(16, 16, 16), dtype=jnp.float32)
    v = jm.init(jax.random.PRNGKey(seed), jnp.zeros((1, 32, 32, 3)),
                train=False)
    v = jax.tree_util.tree_map(lambda a: np.array(a, np.float32), v)
    return jm, _randomize_bn(v, np.random.RandomState(seed + 1))


def _port_model():
    return SimpleBaseline("resnet18", K, (16, 16, 16), dtype=torch.float32,
                          device="cpu")


def _port_state(ema: bool):
    m = _port_model()
    opt = make_optimizer(OptimizerConfig(name="sgd", lr=0.0),
                         m.named_parameters())
    return TrainState(m, opt, ema_decay=0.99 if ema else 0.0)


def _ema_sd(params_tree, batch_stats):
    return from_flax_simple_baseline({"params": params_tree,
                                      "batch_stats": batch_stats})


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    """{ema: (jax dir, port dir)} for ema in (False, True), the converted
    state dicts and EMA state dicts of each step."""
    root = tmp_path_factory.mktemp("swa")
    out, sds, emas = {}, [], []
    for ema in (False, True):
        jdir, pdir = str(root / f"jax{int(ema)}"), str(root / f"port{int(ema)}")
        jmgr, pmgr = JManager(jdir), CheckpointManager(pdir)
        for i, step in enumerate(STEPS):
            jm, v = _flax_vars(10 + i)
            ema_params = jax.tree_util.tree_map(
                lambda a: a * np.float32(0.5) + np.float32(0.01 * i),
                v["params"])
            js = create_train_state(jm, jax.random.PRNGKey(0),
                                    jnp.zeros((1, 32, 32, 3)),
                                    optax.sgd(0.0),
                                    ema_decay=0.99 if ema else 0.0)
            js = js.replace(step=jnp.asarray(step, jnp.int32),
                            params=v["params"], batch_stats=v["batch_stats"],
                            ema_params=ema_params if ema else None)
            jmgr.save(step, js, force=True)
            ps = _port_state(ema)
            sd = from_flax_simple_baseline(v)
            ps.model.load_state_dict(sd)
            ps.step = step
            if ema:
                esd = _ema_sd(ema_params, v["batch_stats"])
                ps.ema = [esd[n].clone() for n, _ in
                          ps.model.named_parameters()]
                emas.append(esd)
            else:
                sds.append(sd)
            pmgr.save(step, ps, force=True)
        jmgr.close()
        out[ema] = (jdir, pdir)
    return out, sds, emas


def _assert_close(got, want, name):
    got, want = got.float().numpy(), want.float().numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=TOL * max(np.abs(want).max(), 1e-30),
                               err_msg=name)


@pytest.mark.parametrize("ema", [False, True], ids=["raw", "ema"])
@pytest.mark.parametrize("sel", ["all", "last2", "steps"])
def test_average_matches_jax(ckpts, ema, sel):
    """The port's average against JAX's carried across, and against the
    mean of the converted tensors: every parameter and BatchNorm
    statistic (and the EMA where the template tracks one); the step is
    the newest used; num_batches_tracked is the newest checkpoint's."""
    (dirs, sds, emas) = ckpts
    jdir, pdir = dirs[ema]
    kw = {"all": {}, "last2": {"last": 2}, "steps": {"steps": [30, 10]}}[sel]
    used_want = {"all": [10, 20, 30], "last2": [20, 30],
                 "steps": [30, 10]}[sel]
    jm, v = _flax_vars(0)
    jtmpl = create_train_state(jm, jax.random.PRNGKey(0),
                               jnp.zeros((1, 32, 32, 3)), optax.sgd(0.0),
                               ema_decay=0.99 if ema else 0.0)
    javg, jused = j_average(jdir, jtmpl, **kw)
    pavg, pused = average_checkpoints(pdir, _port_state(ema), **kw)
    assert list(jused) == pused == used_want
    assert pavg.step == int(javg.step) == max(used_want)
    want = from_flax_simple_baseline({"params": jax.device_get(javg.params),
                                      "batch_stats": jax.device_get(
                                          javg.batch_stats)})
    got = pavg.model.state_dict()
    idx = [STEPS.index(s) for s in used_want]
    if not ema:
        for k, w in want.items():
            if k.endswith("num_batches_tracked"):
                assert torch.equal(got[k], sds[max(idx)][k]), k
                continue
            _assert_close(got[k], w, k)
            mean = torch.stack([sds[i][k] for i in idx]).mean(0)
            _assert_close(got[k], mean, k)
    else:
        jema = _ema_sd(jax.device_get(javg.ema_params),
                       jax.device_get(javg.batch_stats))
        for (n, _), e in zip(pavg.model.named_parameters(), pavg.ema):
            _assert_close(e, jema[n], n)
            mean = torch.stack([emas[i][n] for i in idx]).mean(0)
            _assert_close(e, mean, n)


def test_average_refuses_what_jax_refuses(ckpts, tmp_path):
    """Steps that are not kept (ValueError) and a directory without
    periodic checkpoints (FileNotFoundError), in both packages; a
    checkpoint without EMA under a template that tracks one (ValueError
    naming the step) in the port. JAX's has the same check, but its
    restore seeds a missing EMA from the parameters first, so there it
    never fires and such a step's parameters join the EMA average."""
    dirs, _, _ = ckpts
    jm, _ = _flax_vars(0)

    def jtmpl(ema):
        return create_train_state(jm, jax.random.PRNGKey(0),
                                  jnp.zeros((1, 32, 32, 3)), optax.sgd(0.0),
                                  ema_decay=0.99 if ema else 0.0)

    with pytest.raises(ValueError, match="not in"):
        j_average(dirs[False][0], jtmpl(False), steps=[10, 99])
    with pytest.raises(ValueError, match="not in"):
        average_checkpoints(dirs[False][1], _port_state(False),
                            steps=[10, 99])
    with pytest.raises(ValueError, match="step 10 has no EMA"):
        average_checkpoints(dirs[False][1], _port_state(True))
    empty = str(tmp_path / "empty")
    with pytest.raises(FileNotFoundError):
        j_average(empty, jtmpl(False))
    with pytest.raises(FileNotFoundError):
        average_checkpoints(empty, _port_state(False))


def test_cli_average_ckpts_round_trip(tmp_path):
    """`cli.tools average-ckpts --last 2` on a config of the port: the
    averaged checkpoint loads through restore_for_eval (the config
    tracks an EMA; the averaged checkpoint has none, so the EMA starts
    from the averaged parameters) with the mean of the newest two
    checkpoints' parameters and statistics, at the newest step. The data
    tools raise, citing Queue A item 12."""
    from tpupose_torch.cli import tools
    from tpupose_torch.configs import load_config
    from tpupose_torch.engine.builder import Builder

    cfg_path = tmp_path / "cfg.yaml"                 # JSON is YAML
    cfg_path.write_text(json.dumps({
        "model": {"backbone": "resnet18", "num_keypoints": K,
                  "heatmap_size": [8, 8], "deconv_channels": [16, 16, 16]},
        "data": {"image_size": [32, 32]},
        "train": {"mixed_precision": False, "ema_decay": 0.9}}))
    cfg = load_config(str(cfg_path))
    builder = Builder(cfg, "cpu")
    model = builder.model()
    state = TrainState(model, builder.optimizer(model, 1), ema_decay=0.9)
    mgr = CheckpointManager(str(tmp_path / "run" / "ckpt"))
    g = torch.Generator().manual_seed(0)
    saved = []
    for step in (4, 8, 12):
        with torch.no_grad():
            for p in model.parameters():
                p.add_(torch.randn(p.shape, generator=g))
        state.step = step
        mgr.save(step, state, force=True)
        saved.append({k: v.clone() for k, v in model.state_dict().items()})
    out = str(tmp_path / "avg")
    assert tools.main(["average-ckpts", "--cfg", str(cfg_path), "--ckpt",
                       str(tmp_path / "run" / "ckpt"), "--out", out,
                       "--last", "2", "--device", "cpu"]) == 0
    fresh = Builder(cfg, "cpu").model()
    ev = restore_for_eval(builder, fresh, out)
    assert CheckpointManager(out).latest_step() == 12
    for k, v in ev.state_dict().items():
        if v.is_floating_point():
            _assert_close(v, (saved[1][k] + saved[2][k]) / 2, k)
    for name in ("check-data", "check-labels", "resize", "convert-coco"):
        with pytest.raises(ValueError, match="item 12"):
            tools.main([name])
