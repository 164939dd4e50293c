"""The port's data parallelism (tpupose_torch/parallel/: mesh.py,
sharding.py, sync_bn.py, shard_map_step.py; the Trainer under a process
group) against one process at the global batch, the equivalence JAX's
tests/test_dp_equivalence.py and tests/test_shard_map_step.py hold for
the JAX package's jit sharding and shard_map steps (with the device
affine and color jitter too, the inputs bit for bit).

Each parallel run is two (or one) spawned processes in a gloo group over
a FileStore under tmp_path, every collective with a timeout; the parent
joins them with a deadline and kills what is left. Tolerances are JAX's
test_dp_equivalence bounds: loss within 1e-5 relative, grad norm 1e-4,
parameters and BatchNorm statistics 1e-5 absolute + 1e-4 relative;
SyncBatchNorm2d in a one-rank group against the plain BatchNorm2d within
1e-5 (E[x^2] - E[x]^2 against Welford's variance).
"""

import multiprocessing as mp
import time

import numpy as np
import pytest
import torch

import torch_dp_worker as worker
from tpupose_torch.parallel import mesh

from torch_threads import one_torch_thread  # noqa: F401

DEADLINE_S = 150


def _spawn(tmp_path, case: str, world: int):
    ctx = mp.get_context("spawn")
    store = tmp_path / f"store_{case}"
    procs = [ctx.Process(target=worker.run,
                         args=(r, world, str(store), str(tmp_path), case))
             for r in range(world)]
    for p in procs:
        p.start()
    end = time.monotonic() + DEADLINE_S
    for p in procs:
        p.join(max(0.0, end - time.monotonic()))
    hung = [p for p in procs if p.is_alive()]
    for p in hung:
        p.kill()
        p.join()
    assert not hung, f"{case}: {len(hung)} rank(s) still running after " \
                     f"{DEADLINE_S} s, killed"
    assert [p.exitcode for p in procs] == [0] * world
    return [torch.load(tmp_path / f"{case}_{r}.pt", weights_only=False)
            for r in range(world)]


def _close_states(got: dict, want: dict):
    assert got.keys() == want.keys()
    for k, w in want.items():
        g = got[k]
        if not w.is_floating_point():
            assert torch.equal(g, w), k
            continue
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=1e-5,
                                   rtol=1e-4, err_msg=k)


def test_trainer_two_ranks_equal_one_process(tmp_path):
    """A step of the Trainer on two ranks (DDP, SyncBatchNorm2d, each
    rank loading half of the global batch of 8, the losses normalised
    over the global batch) against one process at the global batch, as
    JAX's test_dp_equivalence holds its sharded step: loss, grad norm,
    then parameters and BatchNorm statistics at its bounds; both ranks
    hold the same model."""
    r0, r1 = _spawn(tmp_path, "trainer", 2)
    one = worker.trainer_steps(str(tmp_path / "single"))
    assert r0["ddp"] and r0["bn"] == "SyncBatchNorm2d"
    assert not one["ddp"] and one["bn"] == "BatchNorm2d"
    np.testing.assert_allclose(r0["loss"], one["loss"], rtol=1e-5)
    np.testing.assert_allclose(r0["grad_norm"], one["grad_norm"], rtol=1e-4)
    assert r0["loss"] == r1["loss"] and r0["grad_norm"] == r1["grad_norm"]
    _close_states(r0["state"], one["state"])
    for k, v in r0["state"].items():
        assert torch.equal(v, r1["state"][k]), k


def test_trainer_two_ranks_draw_the_global_batchs_augmentation(tmp_path):
    """With the device affine (K7's plain version) and color jitter, the
    two ranks' model inputs, joints and visibility, put together, equal
    one process's at the global batch bit for bit (each rank slices the
    global batch's draws), and so do the losses within 1e-5. The grad
    norm is held at 2e-3: the warp's zero-filled borders leave
    BatchNorm's float32 backward cancelling, so convolutions blocked for
    4 images instead of 8 move it by up to 6e-4 (3e-6 without the
    affine, the previous test)."""
    r0, r1 = _spawn(tmp_path, "trainer_augment", 2)
    one = worker.trainer_steps(str(tmp_path / "single"), augment=True)
    assert len(one["inputs"]) == 1
    for step, want in enumerate(one["inputs"]):
        for a, b, w in zip(r0["inputs"][step], r1["inputs"][step], want):
            assert torch.equal(torch.cat([a, b]), w)
    np.testing.assert_allclose(r0["loss"], one["loss"], rtol=1e-5)
    np.testing.assert_allclose(r0["grad_norm"], one["grad_norm"], rtol=2e-3)


@pytest.mark.parametrize("case", ["allreduce", "allreduce_sync_bn"])
def test_allreduce_step_two_ranks_equal_one_process(tmp_path, case):
    """make_allreduce_train_step, the explicit all-reduce form: JAX's
    BN-free TinyNet, and a SimpleBaseline-R18 with synchronised
    BatchNorms (its statistics over the global batch), two SGD steps on
    two ranks against one process at the global batch of 16."""
    ranks = _spawn(tmp_path, case, 2)
    one = worker.allreduce_steps(case.endswith("sync_bn"))
    for r in ranks:
        np.testing.assert_allclose(r["loss"], one["loss"], rtol=1e-5)
        _close_states(r["state"], one["state"])
    if case.endswith("sync_bn"):
        assert any(k.endswith("running_var") for k in one["state"])


def test_sync_batchnorm_in_a_one_rank_group_equals_batchnorm(tmp_path):
    """SyncBatchNorm2d's all-reduced statistics at world size 1: output,
    input gradient and running statistics equal the plain BatchNorm2d's
    (flax's update) within 1e-5."""
    (res,) = _spawn(tmp_path, "sync_bn_world1", 1)
    for k in ("y", "gx", "mean", "var"):
        torch.testing.assert_close(res["sync"][k], res["plain"][k],
                                   rtol=1e-5, atol=1e-5)


def test_sync_batchnorm_without_a_group_is_batchnorm():
    """Outside a process group (and in eval mode) SyncBatchNorm2d is the
    plain BatchNorm2d; convert_sync_batchnorm swaps every BatchNorm2d of a
    model in place, its parameters untouched."""
    from tpupose_torch.models.simple_baseline import SimpleBaseline
    from tpupose_torch.parallel.sync_bn import (SyncBatchNorm2d,
                                                convert_sync_batchnorm)

    m = SimpleBaseline("resnet18", 4, (8, 8, 8), dtype=torch.float32,
                       device="cpu", generator=torch.Generator().manual_seed(0))
    x = torch.randn(2, 32, 32, 3, generator=torch.Generator().manual_seed(1))
    want = m.train()(x)
    sd = {k: v.clone() for k, v in m.state_dict().items()}
    ref = SimpleBaseline("resnet18", 4, (8, 8, 8), dtype=torch.float32,
                         device="cpu")
    ref.load_state_dict(sd)
    convert_sync_batchnorm(ref)
    n_bn = sum(isinstance(mod, SyncBatchNorm2d) for mod in ref.modules())
    assert n_bn == sum(type(mod).__name__ == "BatchNorm2d"
                       for mod in m.modules()) > 10
    m.load_state_dict(sd)
    assert torch.equal(ref.train()(x), m.train()(x))
    assert torch.equal(ref.eval()(x), m.eval()(x))
    assert want.shape == (2, 8, 8, 4)


def test_mesh_layout_and_errors():
    """JAX's mesh errors for sizes that do not divide; a single process
    has no group and a (1, 1) layout; the batch slices are P('data')'s."""
    assert mesh.setup_distributed("cpu") is False
    assert mesh.rank_and_world() == (0, 1) and mesh.is_master()
    assert mesh.mesh_shape(-1, 1, world=8) == (8, 1)
    assert mesh.create_mesh(-1, 1, "cpu") is None
    with pytest.raises(ValueError, match="needs 16 devices, have 8"):
        mesh.mesh_shape(16, 1, world=8)
    with pytest.raises(ValueError, match="without a place"):
        mesh.mesh_shape(4, 1, world=8)
    assert mesh.local_slice(8, 1, 2) == slice(4, 8)
    with pytest.raises(ValueError, match="not divisible by data axis 3"):
        mesh.local_slice(8, 0, 3)
    b = {"x": np.arange(8), "y": torch.arange(16).reshape(8, 2)}
    got = mesh.shard_batch(b, rank=1, world=4)
    assert got["x"].tolist() == [2, 3]
    assert got["y"].tolist() == [[4, 5], [6, 7]]
    mm = mesh.MeshManager(device="cpu")
    assert not mm.distributed and mm.is_master
    assert (mm.data_size, mm.model_size) == (1, 1)
    assert mm.local_batch_size(64) == 64


def test_sharded_loader_loads_each_ranks_slice_of_the_global_batch():
    """BatchLoader(shard=(rank, world)): each rank's batches are its
    contiguous slices of the one-process loader's global batches, in the
    same order, and together they are those batches."""
    from tpupose_torch.data.loader import BatchLoader

    class DS:
        def __len__(self):
            return 20

        def __getitem__(self, i):
            return {"i": np.int64(i)}

    one = [b["i"] for b in BatchLoader(DS(), 8, seed=3)]
    parts = [[b["i"] for b in BatchLoader(DS(), 8, seed=3, shard=(r, 2))]
             for r in range(2)]
    assert len(one) == 2 and all(len(p) == 2 for p in parts)
    for step, want in enumerate(one):
        np.testing.assert_array_equal(
            np.concatenate([parts[0][step], parts[1][step]]), want)
    with pytest.raises(ValueError, match="whole global batches"):
        BatchLoader(DS(), 8, drop_last=False, shard=(0, 2))


def _loss_inputs(name):
    """Small seeded inputs of each Builder loss whose weighted count the
    loss normalises by (8 weights, 5 of them set)."""
    g = torch.Generator().manual_seed(5)
    w = torch.tensor([[1., 0., 1., 1.], [0., 1., 1., 0.]])
    if name in ("joints_mse", "joints_mse_weighted"):
        return (torch.rand(2, 8, 6, 4, generator=g),
                torch.rand(2, 8, 6, 4, generator=g), w)
    if name == "coord_mse":
        return (torch.rand(2, 4, 2, generator=g),
                torch.rand(2, 4, 2, generator=g), w)
    if name == "rle":
        return (torch.rand(2, 4, 2, generator=g),
                torch.rand(2, 4, 2, generator=g) + 0.1,
                torch.randn(2, 4, generator=g),
                torch.rand(2, 4, 2, generator=g), w)
    tx = torch.softmax(torch.randn(2, 4, 12, generator=g), -1)
    ty = torch.softmax(torch.randn(2, 4, 16, generator=g), -1)
    return ((torch.randn(2, 4, 12, generator=g),
             torch.randn(2, 4, 16, generator=g)), (tx, ty), w)


@pytest.mark.parametrize("name", ["joints_mse", "joints_mse_weighted",
                                  "coord_mse", "rle", "simcc_kl"])
def test_builder_loss_normalises_by_the_count_it_is_given(name):
    """The data-parallel normaliser reaches the losses as an argument
    (Builder.loss(count), MeshManager.loss_count), never as ambient
    state: the loss built with a count is the plain loss scaled by
    local/given normaliser, and without one it is the plain loss."""
    from tpupose_torch.configs import load_config
    from tpupose_torch.engine.builder import Builder

    b = Builder(load_config("", {"loss.name": name}), "cpu")
    args = _loss_inputs(name)
    seen = []

    def count(n):
        seen.append(float(n))
        return torch.clamp_min(n, 1.0) * 4.0

    plain = b.loss()(*args)
    got = b.loss(count)(*args)
    assert seen == [5.0]
    torch.testing.assert_close(got * 4.0, plain, rtol=1e-6, atol=0.0)
    assert mesh.MeshManager(device="cpu").loss_count() is None


def test_losses_know_nothing_of_the_process_group():
    """No loss module imports tpupose_torch.parallel: the data-parallel
    decision stays with the Trainer."""
    import ast
    import pathlib

    import tpupose_torch.losses as losses

    for path in pathlib.Path(losses.__file__).parent.glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, (ast.Import, ast.ImportFrom)):
                names = [node.module or ""] if isinstance(
                    node, ast.ImportFrom) else [a.name for a in node.names]
                assert not any(n.startswith("tpupose_torch.parallel")
                               for n in names), path.name
