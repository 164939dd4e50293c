"""The ranks of tests/test_torch_dp.py's data-parallel runs and
tests/test_torch_tp.py's tensor-parallel ones: each is a process
started by `spawn` (so this module imports no JAX), joined to a gloo
group over a FileStore under the test's tmp_path (no TCP port shared
between test workers), with a timeout on every collective. `run` writes
the rank's results to `<out>/<case>_<rank>.pt`."""

import datetime

import numpy as np
import torch
import torch.distributed as dist

K = 4


def tiny_cfg(out_dir: str, batch: int = 8, augment: bool = False):
    """SimpleBaseline-R18 at 64x64 on the synthetic set, SGD at lr 1e-2
    with clipping at 10: the step JAX's tests/test_dp_equivalence.py
    shards; `augment` adds the device affine and color jitter."""
    from tpupose_torch.configs import default_config

    cfg = default_config()
    cfg.model.backbone = "resnet18"
    cfg.model.num_keypoints = K
    cfg.model.heatmap_size = (16, 16)
    cfg.model.deconv_channels = (16, 16, 16)
    cfg.data.image_size = (64, 64)
    cfg.data.device_affine = augment
    cfg.data.color_jitter = 0.2 if augment else 0.0
    cfg.data.num_workers = 0
    cfg.train.batch_size = batch
    cfg.train.epochs = 1
    cfg.train.warmup_epochs = 0
    cfg.train.mixed_precision = False
    cfg.train.grad_clip_norm = 10.0
    cfg.train.output_dir = out_dir
    cfg.optimizer.name = "sgd"
    cfg.optimizer.lr = 1e-2
    cfg.optimizer.head_lr = 1e-2
    return cfg


def trainer_steps(out_dir: str, augment: bool = False, steps: int = 1,
                  deconv: int = 16):
    """`steps` steps of the Trainer (DDP + SyncBatchNorm2d under a group, the
    plain model without one) with `deconv` channels in the head: per-step
    loss and grad norm, each step's augmented model input, joints and
    visibility, and the model's state_dict after."""
    import tpupose_torch.engine.train_state as ts
    from tpupose_torch.engine.trainer import Trainer

    seen = []
    augment_fn = ts._augment

    def recording(*a, **k):
        out = augment_fn(*a, **k)
        seen.append([t.float().clone() for t in out])
        return out

    ts._augment = recording
    try:
        cfg = tiny_cfg(out_dir, augment=augment)
        cfg.model.deconv_channels = (deconv,) * 3
        tr = Trainer(cfg, device="cpu")
        losses, norms = [], []
        for i, db in enumerate(tr._prefetched(tr.train_loader)):
            m = tr.train_step(tr.state, db)
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
            if i + 1 == steps:
                break
    finally:
        ts._augment = augment_fn
    bn = type(tr.model.backbone.bn1).__name__
    return {"loss": losses, "grad_norm": norms, "bn": bn, "inputs": seen,
            "ddp": tr.state.ddp is not None,
            "state": {k: v.detach().clone()
                      for k, v in tr.model.state_dict().items()}}


class TinyNet(torch.nn.Module):
    """JAX's test_shard_map_step TinyNet: conv, LayerNorm over channels,
    ReLU, 1x1 conv (no BatchNorm)."""

    def __init__(self):
        super().__init__()
        g = torch.Generator().manual_seed(0)
        self.c1 = torch.nn.Conv2d(3, 16, 3, padding=1)
        self.ln = torch.nn.LayerNorm(16)
        self.c2 = torch.nn.Conv2d(16, 4, 1)
        with torch.no_grad():
            for p in self.parameters():
                p.copy_(torch.randn(p.shape, generator=g) * 0.2)

    def forward(self, x):
        y = self.c1(x.permute(0, 3, 1, 2))
        y = self.ln(y.permute(0, 2, 3, 1)).relu()
        return self.c2(y.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


def _allreduce_data(n=16):
    rs = np.random.RandomState(0)
    return (torch.from_numpy(rs.rand(n, 8, 8, 3).astype(np.float32)),
            torch.from_numpy(rs.rand(n, 8, 8, 4).astype(np.float32)))


def allreduce_steps(sync_bn: bool, steps: int = 2):
    """make_allreduce_train_step over this rank's slice of a global batch
    of 16: TinyNet with SGD, or (sync_bn) a SimpleBaseline-R18 with its
    BatchNorms synchronised and joints_mse on random targets."""
    from tpupose_torch.losses.heatmap import joints_mse_loss
    from tpupose_torch.parallel.mesh import local_slice, rank_and_world
    from tpupose_torch.parallel.shard_map_step import \
        make_allreduce_train_step
    from tpupose_torch.parallel.sync_bn import convert_sync_batchnorm

    rank, world = rank_and_world()
    if sync_bn:
        from tpupose_torch.models.simple_baseline import SimpleBaseline

        model = SimpleBaseline("resnet18", K, (16, 16, 16),
                               dtype=torch.float32, device="cpu",
                               generator=torch.Generator().manual_seed(1))
        convert_sync_batchnorm(model)
        rs = np.random.RandomState(1)
        x = torch.from_numpy(rs.normal(0, 1, (16, 64, 64, 3))
                             .astype(np.float32))
        t = torch.from_numpy(rs.rand(16, 16, 16, K).astype(np.float32))

        def loss_fn(p, tgt):
            return joints_mse_loss(p, tgt, None)
    else:
        model = TinyNet()
        x, t = _allreduce_data()

        def loss_fn(p, tgt):
            return ((p - tgt) ** 2).mean()
    opt = torch.optim.SGD(model.parameters(), lr=1e-2)
    step = make_allreduce_train_step(model, loss_fn, opt)
    rows = local_slice(len(x), rank, world)
    losses = [float(step(x[rows], t[rows])) for _ in range(steps)]
    return {"loss": losses,
            "state": {k: v.detach().clone()
                      for k, v in model.state_dict().items()}}


def sync_bn_world1():
    """SyncBatchNorm2d's train forward and backward inside a one-rank
    group against the plain BatchNorm2d on the same input."""
    from tpupose_torch.models.backbones.resnet import BatchNorm2d
    from tpupose_torch.parallel.sync_bn import SyncBatchNorm2d

    g = torch.Generator().manual_seed(2)
    x = (torch.randn(4, 8, 6, 5, generator=g) * 3 + 1).requires_grad_()
    out = {}
    for name, cls in (("plain", BatchNorm2d), ("sync", SyncBatchNorm2d)):
        bn = cls(8)
        with torch.no_grad():
            bn.weight.uniform_(0.5, 1.5, generator=torch.Generator()
                               .manual_seed(3))
            bn.bias.uniform_(-0.5, 0.5, generator=torch.Generator()
                             .manual_seed(4))
        y = bn.train()(x)
        (gx,) = torch.autograd.grad((y * y.detach().cos()).sum(), x)
        out[name] = {"y": y.detach(), "gx": gx,
                     "mean": bn.running_mean.clone(),
                     "var": bn.running_var.clone()}
    return out


# -- tensor parallelism (tests/test_torch_tp.py) ----------------------------------

def tp_cfg(out_dir: str, model: int = 1, opt: str = "sgd", **over):
    """tiny_cfg with deconv channels 64 (so the head's deconvolutions are
    sharded too) on a (-1, model) mesh, without color jitter, clipping
    or warmup: the optimizer `opt` at a constant lr 1e-2."""
    cfg = tiny_cfg(out_dir)
    cfg.model.deconv_channels = (64, 64, 64)
    cfg.data.color_jitter = 0.0
    cfg.train.grad_clip_norm = 0.0
    cfg.optimizer.name = opt
    cfg.optimizer.momentum = 0.0
    cfg.lr_scheduler.name = "constant"
    cfg.mesh.model = model
    for k, v in over.items():
        cfg.merge_dotted({k: v})
    return cfg


def noise_batch(n: int = 8, seed: int = 5) -> dict:
    """A global batch of noise pixels (every BatchNorm channel keeps its
    spread, see tests/test_torch_train.py's _batch) with joints inside
    the 16x16 heatmap."""
    rs = np.random.RandomState(seed)
    return {"images": torch.from_numpy(
                rs.randint(0, 256, (n, 64, 64, 3)).astype(np.uint8)),
            "joints": torch.from_numpy(
                rs.uniform(2, 12, (n, K, 2)).astype(np.float32)),
            "visibility": torch.ones(n, K)}


def _record_grads(tr, seen: list):
    """Wrap tr's optimizer so that each step records every parameter's
    gradient, gathered to the full tensor, as the update takes it."""
    from tpupose_torch.parallel.tensor_parallel import full_tensor, shard_of

    opt = tr.state.optimizer
    step = opt.step

    def recording():
        seen.append([full_tensor(p.grad, shard_of(p)).clone()
                     for p in tr.model.parameters()])
        return step()

    opt.step = recording


def _full_state(tr) -> dict:
    from tpupose_torch.parallel.tensor_parallel import full_state_dict

    return {k: v.detach().clone() for k, v in full_state_dict(tr.model).items()}


def tp_jax_step(out_dir: str, model: int = 2):
    """One AdamW (lr 1e-3, weight decay 1e-4) step of the Trainer on the
    setting of JAX's tests/test_model_axis_tp.py, from the weights and on
    the batch its parent wrote (`<out>/init.pt`, `<out>/batch.pt`)."""
    from tpupose_torch.engine.trainer import Trainer
    from tpupose_torch.parallel.tensor_parallel import load_full_state_dict

    base = out_dir.rsplit("/", 1)[0]
    cfg = tp_cfg(out_dir, model, "adamw")
    cfg.optimizer.lr = cfg.optimizer.head_lr = 1e-3
    cfg.optimizer.weight_decay = 1e-4
    tr = Trainer(cfg, device="cpu")
    load_full_state_dict(tr.model, torch.load(f"{base}/init.pt"))
    batch = {k: v[_rows(tr)] for k, v in torch.load(f"{base}/batch.pt").items()}
    m = tr.train_step(tr.state, batch)
    return {"loss": float(m["loss"]), "state": _full_state(tr),
            "sharded": _sharded_names(tr.model)}


def _rows(tr):
    from tpupose_torch.parallel.mesh import local_slice

    mm = tr.mesh_mgr
    return local_slice(8, mm.data_rank, mm.data_size)


def _sharded_names(model) -> list:
    from tpupose_torch.parallel.tensor_parallel import shard_of

    return [n for n, p in model.named_parameters() if shard_of(p) is not None]


def tp_grads(out_dir: str, model: int = 2, steps: int = 2):
    """`steps` float32 SGD steps (momentum 0, lr 1e-2) of the Trainer on
    noise_batch: each step's gathered gradients, losses, and the full
    state after."""
    from tpupose_torch.engine.trainer import Trainer

    tr = Trainer(tp_cfg(out_dir, model), device="cpu")
    seen, losses = [], []
    _record_grads(tr, seen)
    batch = {k: v[_rows(tr)] for k, v in noise_batch().items()}
    for _ in range(steps):
        losses.append(float(tr.train_step(tr.state, batch)["loss"]))
    return {"grads": seen, "loss": losses, "state": _full_state(tr),
            "names": [n for n, _ in tr.model.named_parameters()],
            "sharded": _sharded_names(tr.model)}


def tp_axes(out_dir: str):
    """data 2 x model 2: trainer_steps with the device affine and color
    jitter on the deconv-64 model, each rank's mesh coordinates and
    groups, and the yolo step's mosaic draws for this rank."""
    import torch.distributed as dist

    import tpupose_torch.engine.train_state as ts
    from tpupose_torch.engine.trainer import Trainer

    seen = []
    augment_fn = ts._augment

    def recording(*a, **k):
        out = augment_fn(*a, **k)
        seen.append([t.float().clone() for t in out])
        return out

    ts._augment = recording
    try:
        cfg = tiny_cfg(out_dir, augment=True)
        cfg.model.deconv_channels = (64, 64, 64)
        cfg.mesh.model = 2
        tr = Trainer(cfg, device="cpu")
        db = next(iter(tr._prefetched(tr.train_loader)))
        m = tr.train_step(tr.state, db)
    finally:
        ts._augment = augment_fn
    mm = tr.mesh_mgr
    step = ts.make_yolo_train_step(None, mosaic_prob=0.5, mosaic_seed=3)
    mosaic = step.draws_for(0, 4, "cpu", tr.state.dp_rank)["mosaic"]
    return {"loss": [float(m["loss"])], "grad_norm": [float(m["grad_norm"])],
            "inputs": seen, "state": _full_state(tr),
            "coords": (mm.data_rank, mm.model_rank),
            "groups": (dist.get_process_group_ranks(mm.data_group),
                       dist.get_process_group_ranks(mm.model_group)),
            "dp": (tr.state.dp_rank, tr.state.dp_world,
                   tr.train_loader.shard),
            "mosaic": {k: v.clone() for k, v in mosaic.items()},
            "sharded": _sharded_names(tr.model)}


def _vit_and_block():
    """A depth-2, dim-64 DinoViT (plain attention, patch 16) and a
    ConvNeXt block of dim 64, seeded."""
    from tpupose_torch.models.backbones.vit import DinoViT
    from tpupose_torch.models.necks import ConvNeXtBlock

    g = torch.Generator().manual_seed(7)
    vit = DinoViT(depth=2, dim=64, heads=2, num_storage_tokens=1)
    blk = ConvNeXtBlock(64)
    with torch.no_grad():
        for p in list(vit.parameters()) + list(blk.parameters()):
            p.copy_(torch.randn(p.shape, generator=g) * 0.2)
    for m in vit.modules():
        if hasattr(m, "impl"):
            m.impl = "plain"
    return vit, blk


def tp_modules(out_dir: str, model: int = 2):
    """The ViT, the ConvNeXt block and a Float32Conv sharded over the
    model group, forward (the conv under bf16 autocast) and backward on
    seeded inputs: outputs, input gradients and every gathered parameter
    gradient, and the layers of gather_full's copy of the block (the
    same at model = 1, without a group)."""
    from tpupose_torch.models.yolo_head import Float32Conv
    from tpupose_torch.parallel.mesh import MeshManager
    from tpupose_torch.parallel.tensor_parallel import (full_tensor,
                                                        gather_full,
                                                        shard_of)

    vit, blk = _vit_and_block()
    conv = Float32Conv(64, 64, 3, padding=1)
    sharded = []
    if model > 1:
        from tpupose_torch.parallel.sharding import shard_params

        mm = MeshManager(model=model, device="cpu")
        for m in (vit, blk, conv):
            shard_params(m, model, mm.model_rank, mm.model_group)
        sharded = _sharded_names(vit) + [
            "blk." + n for n in _sharded_names(blk)] + [
            "f32conv." + n for n in _sharded_names(conv)]
    g = torch.Generator().manual_seed(8)
    x = torch.randn(2, 32, 48, 3, generator=g).requires_grad_()
    z = torch.randn(2, 64, 9, 7, generator=g).requires_grad_()
    out = vit(x)["patches"]
    y = blk(z)
    with torch.autocast("cpu", dtype=torch.bfloat16):
        f32 = conv(z)
    ((out * out.detach().cos()).sum() + (y * y.detach().sin()).sum()
     + f32.sum()).backward()
    grads = [full_tensor(p.grad, shard_of(p))
             for p in list(vit.parameters()) + list(blk.parameters())
             + list(conv.parameters())]
    full = gather_full(blk)
    layers = [(type(m).__name__, getattr(m, "in_channels", m.in_features
                                         if hasattr(m, "in_features") else 0),
               getattr(m, "out_channels", getattr(m, "out_features", 0)),
               getattr(m, "groups", 0))
              for m in (full.dwconv, full.pwconv1, full.pwconv2)]
    return {"out": out.detach(), "y": y.detach(), "f32": f32.detach(),
            "gx": x.grad, "gz": z.grad, "grads": grads, "sharded": sharded,
            "full_blk": layers}


def tp_optimizers(out_dir: str, model: int = 2):
    """Two steps of grad_clip_norm (sgd, clipping at 0.05) and of lamb,
    lars and fromage on a small conv and linear model sharded over the
    model group: the gathered parameters after each rule."""
    from tpupose_torch.configs.default import OptimizerConfig
    from tpupose_torch.engine.optimizers import make_optimizer
    from tpupose_torch.parallel.mesh import MeshManager
    from tpupose_torch.parallel.tensor_parallel import full_tensor, shard_of

    out = {}
    for name, clip in (("sgd", 0.05), ("lamb", 0.0), ("lars", 0.0),
                       ("fromage", 0.0)):
        g = torch.Generator().manual_seed(9)
        net = torch.nn.Sequential(
            torch.nn.Conv2d(3, 64, 3, padding=1), torch.nn.ReLU(),
            torch.nn.Conv2d(64, 8, 1), torch.nn.Flatten(),
            torch.nn.Linear(8 * 36, 64), torch.nn.Tanh(),
            torch.nn.Linear(64, 4))
        with torch.no_grad():
            for p in net.parameters():
                p.copy_(torch.randn(p.shape, generator=g) * 0.3)
        opt = make_optimizer(OptimizerConfig(name=name, lr=1e-2, head_lr=1e-2,
                                             weight_decay=1e-2),
                             net.named_parameters(), grad_clip_norm=clip)
        if model > 1:
            from tpupose_torch.parallel.sharding import shard_params

            mm = MeshManager(model=model, device="cpu")
            shard_params(net, model, mm.model_rank, mm.model_group)
        x = torch.randn(4, 3, 6, 6, generator=g)
        norms = []
        for _ in range(2):
            opt.zero_grad()
            (net(x) ** 2).sum().backward()
            norms.append(float(opt.step()))
        out[name] = {"norms": norms,
                     "params": [full_tensor(p.detach(), shard_of(p))
                                for p in net.parameters()],
                     "sharded": _sharded_names(net)}
    return out


# tp_checkpoint's Trainer: an EMA and a moment of every parameter (Adam's
# first step, lr x the sign of each gradient, would make the files of
# model = 1 and 2 differ by 2 lr where a float32 gradient is ~0)
CKPT_OVER = {"train.ema_decay": "0.9", "optimizer.momentum": "0.9"}


def tp_checkpoint(out_dir: str, model: int = 2):
    """A Trainer with EMA and momentum (SGD, 0.9): one step, a saved
    checkpoint
    (`<out>/ckpt`); then a restore of `<out>/../restore_me` where the
    parent put one (a checkpoint directory), re-saved under
    `<out>/resaved`; and the gathered eval model's state."""
    import os

    from tpupose_torch.engine.checkpoint import CheckpointManager
    from tpupose_torch.engine.trainer import Trainer

    cfg = tp_cfg(out_dir, model, **CKPT_OVER)
    tr = Trainer(cfg, device="cpu")
    batch = {k: v[_rows(tr)] for k, v in noise_batch().items()}
    tr.train_step(tr.state, batch)
    tr.save_checkpoint()
    res = {"eval": {k: v.clone() for k, v in
                    tr.state.for_eval().state_dict().items()}}
    src = os.path.join(out_dir.rsplit("/", 1)[0], "restore_me")
    if os.path.isdir(src):
        tr.load_checkpoint(src)
        CheckpointManager(os.path.join(out_dir, "resaved")).save(
            tr.state.step, tr.state, force=True)
    return res


def tp_evaluate(out_dir: str, model: int = 2):
    """Trainer.evaluate() (the plain route on the CPU) after one SGD
    step, on 8 validation images."""
    from tpupose_torch.data.synthetic import SyntheticTopDownDataset
    from tpupose_torch.engine.trainer import Trainer

    cfg = tp_cfg(out_dir, model, **{"eval.batch_size": "8"})
    tr = Trainer(cfg, device="cpu")
    tr.valid_ds = SyntheticTopDownDataset(8, (64, 64), (16, 16), K, seed=1)
    tr.valid_loader = tr.builder.dataloader(tr.valid_ds, "valid")
    batch = {k: v[_rows(tr)] for k, v in noise_batch().items()}
    tr.train_step(tr.state, batch)
    return tr.evaluate()


# the R50 step of the card test (tests/test_torch_cuda.py), as
# chip_smoke.py's phase 21 takes it: 256x192, float32 with TF32 off,
# global B = 8, device affine, plain SGD (momentum 0), its update
# proportional to the gradient
R50_TP = {"data.device_affine": "true", "train.batch_size": "8",
          "train.mixed_precision": "false", "train.epochs": "1",
          "train.warmup_epochs": "0", "data.num_workers": "0",
          "optimizer.name": "sgd", "optimizer.momentum": "0",
          "optimizer.lr": "0.1", "optimizer.head_lr": "0.1",
          "lr_scheduler.name": "constant"}


def tp_r50_card(out_dir: str, model: int = 2, float64: bool = False):
    """One R50_TP step of simple_baseline.yaml's Trainer on this rank's
    card, on the loader's joints and seeded noise pixels (float64: the
    model in float64, without a group): the loss, the gathered gradients
    and the full state before and after (CPU)."""
    import pathlib

    from tpupose_torch.configs import load_config
    from tpupose_torch.engine.trainer import Trainer

    yaml = pathlib.Path(__file__).resolve().parents[1] / "tpupose_torch" \
        / "configs" / "method" / "simple_baseline.yaml"
    cfg = load_config(str(yaml), dict(R50_TP, **{
        "mesh.model": str(model), "train.output_dir": out_dir}))
    tr = Trainer(cfg, device="cuda")
    if float64:
        tr.model.double()
        tr.model.compute_dtype = tr.model.param_dtype = torch.float64
    grads = []
    _record_grads(tr, grads)
    db = next(iter(tr._prefetched(tr.train_loader)))
    g = torch.Generator(device="cuda").manual_seed(2100)
    db["images"] = torch.randint(0, 256, tuple(db["images"].shape),
                                 generator=g, device="cuda",
                                 dtype=torch.uint8)
    before = {k: v.float().cpu() for k, v in _full_state(tr).items()
              if v.is_floating_point()}
    loss = float(tr.train_step(tr.state, db)["loss"])
    return {"loss": loss, "grads": [g.float().cpu() for g in grads[0]],
            "before": before,
            "state": {k: v.float().cpu() for k, v in _full_state(tr).items()
                      if v.is_floating_point()}}


def tp_suite(out_dir: str):
    """Every two-rank (data 1 x model 2) case of tests/test_torch_tp.py
    in one process group."""
    return {"jax": tp_jax_step(out_dir + "/jax"),
            "grads": tp_grads(out_dir + "/grads"),
            "modules": tp_modules(out_dir),
            "optimizers": tp_optimizers(out_dir),
            "checkpoint": tp_checkpoint(out_dir + "/ckpt"),
            "evaluate": tp_evaluate(out_dir + "/eval")}


CASES = {"trainer": lambda out: trainer_steps(out),
         "trainer_augment": lambda out: trainer_steps(out, augment=True),
         "allreduce": lambda out: allreduce_steps(False),
         "allreduce_sync_bn": lambda out: allreduce_steps(True),
         "sync_bn_world1": lambda out: sync_bn_world1(),
         "tp_suite": tp_suite,
         "tp_axes": tp_axes,
         "tp_r50_card": tp_r50_card}


def card_group(backend: str, rank: int, world: int, store_path: str):
    """A process group over a FileStore for a run on the card, this rank
    on cuda:<rank> (NCCL, one rank a card), TF32 off."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(rank)
    dist.init_process_group(backend, store=dist.FileStore(store_path, world),
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=300))


def run(rank: int, world: int, store_path: str, out_dir: str, case: str):
    torch.set_num_threads(1)
    if case == "tp_r50_card":
        card_group("nccl", rank, world, store_path)
    else:
        dist.init_process_group("gloo", store=dist.FileStore(store_path,
                                                             world),
                                rank=rank, world_size=world,
                                timeout=datetime.timedelta(seconds=60))
    try:
        res = CASES[case](f"{out_dir}/run_{case}")
        torch.save(res, f"{out_dir}/{case}_{rank}.pt")
    finally:
        dist.destroy_process_group()
