"""tpupose_torch's EpisodicTrainer (FSKD) and MAETrainer (FCMAE) on the
CPU: three EpisodicTrainer steps against JAX's jitted step (adamw, cosine)
from the same weights (JAX's, carried across by
utils/convert.from_flax_fskd) on the same episodes (the same seed draws
them bit for bit), MAETrainer training stable as in JAX's test, and
cli.train's dispatch of fskd and fcmae with `--device cpu` (and its
refusal of the default CUDA device where there is none). The FSKD ViT is
a depth-3 "t3" (dim 64, 2 heads) added to both packages' VIT_SIZES, at
32x32, float32. Tolerances: each step's loss and its parts within 1e-4 of
JAX's (relative), step 1 from identical weights and the later ones after
Adam's updates in two frameworks."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpupose.configs.default import default_config as j_default_config
from tpupose.engine.episodic_trainer import \
    EpisodicTrainer as JEpisodicTrainer
from tpupose.engine.episodic_trainer import \
    _synthetic_class_dataset as j_synthetic_class_dataset
from tpupose.models import fskd as jfskd
from tpupose.models.backbones import vit as jvit
from tpupose_torch.cli import train as cli_train
from tpupose_torch.configs import default_config
from tpupose_torch.data.synthetic import SyntheticTopDownDataset
from tpupose_torch.engine.episodic_trainer import (EpisodicTrainer,
                                                   MAETrainer,
                                                   _synthetic_class_dataset)
from tpupose_torch.models.backbones import vit as tvit
from tpupose_torch.utils.convert import from_flax_fskd
from torch_threads import one_torch_thread  # noqa: F401

T3 = {"depth": 3, "dim": 64, "heads": 2}
FSKD_YAML = "tpupose/configs/method/fskd_small.yaml"
FCMAE_YAML = "tpupose/configs/method/fcmae.yaml"


@pytest.fixture(autouse=True)
def t3_size(monkeypatch):
    monkeypatch.setitem(jvit.VIT_SIZES, "t3", T3)
    monkeypatch.setitem(tvit.VIT_SIZES, "t3", T3)


def _fskd_cfg(cfg, tmp_path):
    cfg.model.name = "fskd"
    cfg.model.backbone = "vit_t3"
    cfg.model.num_keypoints = 4
    cfg.data.image_size = (32, 32)
    cfg.data.n_way = 3
    cfg.data.k_shot = 1
    cfg.data.n_query = 2
    cfg.data.episodes_per_epoch = 6
    cfg.train.epochs = 1
    cfg.train.warmup_epochs = 0
    cfg.train.mixed_precision = False
    cfg.train.log_interval = 2
    cfg.train.output_dir = str(tmp_path)
    cfg.optimizer.name = "adamw"
    cfg.optimizer.lr = 3e-4
    cfg.lr_scheduler.name = "cosine"
    return cfg


def _randomize(tree, rs):
    """O(1) layer scales, tokens and norm scales, so that the ViT's blocks
    are not the near no-ops of flax's 1e-5 layer scales."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _randomize(v, rs)
            continue
        v = np.asarray(v, np.float32)
        if k in ("ls1", "ls2"):
            v = rs.uniform(0.2, 0.6, v.shape)
        elif k in ("cls_token", "storage_tokens"):
            v = rs.normal(0, 0.5, v.shape)
        elif k == "bias":
            v = rs.normal(0, 0.05, v.shape)
        out[k] = v.astype(np.float32)
    return out


def test_synthetic_class_dataset_equals_jax():
    a = _synthetic_class_dataset(5, 4, (16, 24), per_class=3, seed=2)
    b = j_synthetic_class_dataset(5, 4, (16, 24), per_class=3, seed=2)
    assert len(a) == len(b) == 15
    for i in range(len(a)):
        assert a[i]["class_id"] == b[i]["class_id"]
        np.testing.assert_array_equal(a[i]["image"], b[i]["image"])
        np.testing.assert_array_equal(a[i]["keypoints"], b[i]["keypoints"])


class _JitInitFSKD(jfskd.FSKD):
    """JAX's FSKD with its init jitted (eager, it takes seconds)."""

    def init(self, rng, *args, **kw):
        return jax.jit(functools.partial(super().init, **kw))(rng, *args)


def test_episodic_trainer_steps_match_jax(tmp_path, monkeypatch):
    monkeypatch.setattr(jfskd, "FSKD", _JitInitFSKD)
    jcfg = _fskd_cfg(j_default_config(), tmp_path / "jax")
    tcfg = _fskd_cfg(default_config(), tmp_path / "torch")
    base = dict(num_classes=5, num_keypoints=4, image_size=(32, 32),
                per_class=6)
    jtr = JEpisodicTrainer(jcfg, base_dataset=j_synthetic_class_dataset(
        **base))
    ttr = EpisodicTrainer(tcfg, base_dataset=_synthetic_class_dataset(
        **base), device="cpu")
    params = _randomize(jax.tree_util.tree_map(np.asarray, jtr.state.params),
                        np.random.RandomState(0))
    jtr.state = jtr.state.replace(
        params=jax.tree_util.tree_map(jnp.asarray, params))
    ttr.model.load_state_dict(from_flax_fskd({"params": params}))
    assert ttr.model.extractor.ids == (0, 1, 2)
    for i in range(3):
        jep, tep = jtr.episodes[i], ttr.episodes[i]
        for k in jep:
            np.testing.assert_array_equal(tep[k], jep[k], err_msg=k)
        jtr.state, jm = jtr._step(jtr.state, jtr._to_device(jep))
        tm = ttr.train_step(ttr.to_device(tep))
        assert tm.keys() == jm.keys()
        for k in jm:
            w = float(jm[k])
            assert abs(float(tm[k]) - w) <= 1e-4 * abs(w), (i, k)
    assert ttr.state.step == 3


def test_episodic_trainer_trains_and_checkpoints(tmp_path):
    cfg = _fskd_cfg(default_config(), tmp_path)
    cfg.data.episodes_per_epoch = 3
    tr = EpisodicTrainer(cfg, base_dataset=_synthetic_class_dataset(
        5, 4, (32, 32), per_class=6), device="cpu")
    loss = tr.train()
    assert np.isfinite(loss)
    assert (tmp_path / "default" / "ckpt").is_dir()


def _fcmae_cfg(cfg, tmp_path, epochs):
    cfg.model.name = "fcmae"
    cfg.model.backbone = "convnext_atto"
    cfg.model.num_keypoints = 4
    cfg.data.image_size = (64, 64)
    cfg.train.batch_size = 8
    cfg.train.epochs = epochs
    cfg.train.warmup_epochs = 0
    cfg.train.mixed_precision = False
    cfg.train.output_dir = str(tmp_path)
    cfg.optimizer.lr = 1e-3
    return cfg


def test_mae_trainer_is_stable(tmp_path):
    """As JAX's test: one epoch finite, three epochs' last mean within
    1.5x of the first epoch's (reconstruction improves or holds)."""
    ds = SyntheticTopDownDataset(num_samples=32, image_size=(64, 64),
                                 num_keypoints=4)
    l1 = MAETrainer(_fcmae_cfg(default_config(), tmp_path / "a", 1),
                    dataset=ds, device="cpu").train()
    assert np.isfinite(l1)
    tr = MAETrainer(_fcmae_cfg(default_config(), tmp_path / "b", 3),
                    dataset=ds, device="cpu")
    l3 = tr.train()
    assert l3 < l1 * 1.5
    assert tr.state.step == 12


def test_mae_trainer_masks_come_from_its_generator(tmp_path):
    """Two trainers from one seed draw the same masks: equal losses."""
    ds = SyntheticTopDownDataset(num_samples=8, image_size=(64, 64),
                                 num_keypoints=4)
    cfg = _fcmae_cfg(default_config(), tmp_path, 1)
    a = MAETrainer(cfg, dataset=ds, device="cpu")
    b = MAETrainer(cfg, dataset=ds, device="cpu")
    imgs = torch.from_numpy(next(iter(a.loader))["images"])
    assert float(a.train_step(imgs)) == float(b.train_step(imgs))


@pytest.mark.parametrize("yaml,over", [
    (FSKD_YAML, ["model.backbone=vit_t3", "data.image_size=[32,32]",
                 "data.episodes_per_epoch=2", "model.num_keypoints=4"]),
    (FCMAE_YAML, ["data.image_size=[64,64]", "model.num_keypoints=4"]),
], ids=["fskd", "fcmae"])
def test_cli_train_dispatches(yaml, over, tmp_path, monkeypatch):
    import tpupose_torch.engine.episodic_trainer as et

    ran = {}
    for name in ("EpisodicTrainer", "MAETrainer"):
        cls = getattr(et, name)

        class Spy(cls):
            def train(self, _name=name):
                ran[_name] = super().train()
                return ran[_name]

        monkeypatch.setattr(et, name, Spy)
    if yaml == FCMAE_YAML:
        small = SyntheticTopDownDataset(num_samples=16, image_size=(64, 64),
                                        num_keypoints=4)
        monkeypatch.setattr("tpupose_torch.data.synthetic."
                            "SyntheticTopDownDataset",
                            lambda **kw: small)
    argv = ["--cfg", yaml, "--device", "cpu", *over, "train.epochs=1",
            "train.warmup_epochs=0", "train.mixed_precision=false",
            "train.batch_size=8", f"train.output_dir={tmp_path}"]
    assert cli_train.main(argv) == 0
    want = "EpisodicTrainer" if yaml == FSKD_YAML else "MAETrainer"
    assert list(ran) == [want] and np.isfinite(ran[want])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli_train.main([a for a in argv if a not in ("--device", "cpu")])
