"""The ranks of tests/test_torch_dp.py's data-parallel runs: each is a
process started by `spawn` (so this module imports no JAX), joined to a
gloo group over a FileStore under the test's tmp_path (no TCP port shared
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


def trainer_steps(out_dir: str, augment: bool = False, steps: int = 1):
    """`steps` steps of the Trainer (DDP + SyncBatchNorm2d under a group, the
    plain model without one): per-step loss and grad norm, each step's
    augmented model input, joints and visibility, and the model's
    state_dict after."""
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
        tr = Trainer(tiny_cfg(out_dir, augment=augment), device="cpu")
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


CASES = {"trainer": lambda out: trainer_steps(out),
         "trainer_augment": lambda out: trainer_steps(out, augment=True),
         "allreduce": lambda out: allreduce_steps(False),
         "allreduce_sync_bn": lambda out: allreduce_steps(True),
         "sync_bn_world1": lambda out: sync_bn_world1()}


def run(rank: int, world: int, store_path: str, out_dir: str, case: str):
    torch.set_num_threads(1)
    store = dist.FileStore(store_path, world)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=60))
    try:
        res = CASES[case](f"{out_dir}/run_{case}")
        torch.save(res, f"{out_dir}/{case}_{rank}.pt")
    finally:
        dist.destroy_process_group()
