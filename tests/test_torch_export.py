"""The port's export (tpupose_torch/engine/exporter.py, cli/export.py) and
the kernels as torch.library ops (ops/cuda_stem, cuda_layer1,
cuda_bridge, cuda_decode, cuda_attention), against the JAX package's
exporter and export CLI (tests/test_predictor_exporter_tracker.py's
recipes) on the same weights.

Tolerances: each op passes torch.library.opcheck on CPU tensors and
equals its plain version bit for bit; a loaded program equals the port's
eager step bit for bit on the CPU; against JAX's `export_stablehlo`
program on the converted weights, source coordinates within 2e-2
heatmap px (a random model's flat heatmaps make DARK's Newton step
ill-conditioned, tests/test_torch_evaluate.py) and scores within 1e-4,
SimCC and detections at tests/test_torch_simcc.py's and
tests/test_torch_video.py's bounds, bottom-up's grouped people equal
where both keep them (coordinates within 1e-3 px); npz weights exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpupose.engine.evaluator import TopDownEvaluator as JEvaluator
from tpupose.engine.exporter import export_npz as j_export_npz
from tpupose.engine.exporter import export_stablehlo, load_stablehlo
from tpupose.models.simple_baseline import SimpleBaseline as JSimpleBaseline
from tpupose_torch.engine import exporter
from tpupose_torch.engine.evaluator import TopDownEvaluator
from tpupose_torch.models.simple_baseline import SimpleBaseline
from tpupose_torch.ops import (cuda_attention, cuda_bridge, cuda_decode,
                               cuda_layer1, cuda_stem)
from tpupose_torch.utils.convert import from_flax_simple_baseline

from test_torch_evaluate import _jstate, _randomize_bn
from torch_threads import one_torch_thread  # noqa: F401

K = 4
HW = (64, 64)


def T(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _crops(n=2, hw=HW, seed=0):
    imgs = np.random.RandomState(seed).randint(
        0, 256, (n, *hw, 3)).astype(np.uint8)
    H, W = hw
    c = np.tile([[W / 2, H / 2]], (n, 1)).astype(np.float32)
    s = np.tile([[W * 1.1, H * 1.1]], (n, 1)).astype(np.float32)
    return imgs, c, s


# -- the ops -------------------------------------------------------------------

def _block(rs, cin, cm, cout, ds):
    d = {"w1": rs.normal(0, .1, (cin, cm)), "b1": rs.normal(0, .1, cm),
         "w2": rs.normal(0, .05, (3, 3, cm, cm)), "b2": rs.normal(0, .1, cm),
         "w3": rs.normal(0, .1, (cm, cout)), "b3": rs.normal(0, .1, cout)}
    if ds:
        d["wds"] = rs.normal(0, .1, (cin, cout))
    return {k: T(v.astype(np.float32)) for k, v in d.items()}


def _op_cases():
    rs = np.random.RandomState(0)
    stem = {"w": T(rs.normal(0, .1, (7, 7, 3, 64)).astype(np.float32)),
            "bias": T(rs.normal(0, .1, 64).astype(np.float32))}
    x1 = T(rs.normal(0, 1, (2, 32, 24, 3)).astype(np.float32))
    l1 = [_block(rs, 64, 64, 256, True), _block(rs, 256, 64, 256, False),
          _block(rs, 256, 64, 256, False)]
    x2 = T(rs.normal(0, 1, (2, 16, 8, 64)).astype(np.float32))
    br = _block(rs, 256, 128, 512, True)
    x3 = T(rs.normal(0, 1, (2, 16, 16, 256)).astype(np.float32))
    hm = T(rs.uniform(0, 1, (2, 3, 16, 12)).astype(np.float32))
    q, k, v = (T(rs.normal(0, 1, (2, 9, 3, 64)).astype(np.float32))
               for _ in range(3))
    # name: (op, its arguments, the plain version, the wrapper's call)
    return {
        "stem_pool": (cuda_stem.stem_pool_op, (x1, stem["w"], stem["bias"]),
                      lambda: cuda_stem.stem_pool_reference(x1, stem),
                      lambda: cuda_stem.stem_pool(x1, stem)),
        "layer1": (cuda_layer1.layer1_op,
                   (x2, cuda_layer1.flatten_layer1(l1)),
                   lambda: cuda_layer1.layer1_reference(x2, l1),
                   lambda: cuda_layer1.layer1(x2, l1)),
        "bridge": (cuda_bridge.bridge_op,
                   (x3, *(br[n] for n in ("w1", "b1", "w2", "b2", "w3",
                                          "b3", "wds"))),
                   lambda: cuda_bridge.bridge_reference(x3, br),
                   lambda: cuda_bridge.bridge(x3, br)),
        "dark_decode": (cuda_decode.dark_decode_op, (hm, 11, 2.0),
                        lambda: cuda_decode.dark_decode_reference(hm),
                        lambda: cuda_decode.dark_decode(hm, 11, 2.0)),
        "flash_attention_lse": (cuda_attention.flash_attention_op,
                                (q, k, v, 0.125, True), None, None),
        "flash_attention": (cuda_attention.flash_attention_op,
                            (q, k, v, 0.125, False), None,
                            lambda: (cuda_attention.flash_attention(
                                q, k, v, 0.125),)),
    }


@pytest.mark.parametrize("name", list(_op_cases()))
def test_op_passes_opcheck_and_equals_its_plain_version(name):
    """Schema, fake (meta) kernel, and the dispatcher paths of each op,
    by torch.library.opcheck on CPU tensors; the op's CPU output equals
    its plain version."""
    from tpupose_torch.ops.attention import attention_reference

    op, args, ref, _ = _op_cases()[name]
    torch.library.opcheck(op, args)
    got = op(*args)
    if name.startswith("flash"):
        q, k, v, scale, with_lse = args
        assert torch.equal(got[0], attention_reference(q, k, v, scale))
        s = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
        want_lse = (torch.logsumexp(s, -1) / np.log(2.0)) if with_lse \
            else torch.empty(0)
        torch.testing.assert_close(got[1], want_lse, rtol=1e-6, atol=1e-6)
        return
    want = ref()
    for g, w in zip(got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,)):
        assert torch.equal(g, w)


def test_layer1_flattening_round_trips():
    rs = np.random.RandomState(1)
    blocks = [_block(rs, 64, 64, 256, True), _block(rs, 256, 64, 256, False),
              _block(rs, 256, 64, 256, False)]
    flat = cuda_layer1.flatten_layer1(blocks)
    assert len(flat) == 19 and flat[6] is blocks[0]["wds"]
    back = cuda_layer1.unflatten_layer1(flat)
    assert [sorted(b) for b in back] == [sorted(b) for b in blocks]
    assert all(back[i][k] is blocks[i][k] for i in range(3)
               for k in blocks[i])
    with pytest.raises(ValueError, match="19 weight tensors"):
        cuda_layer1.unflatten_layer1(flat[:-1])


class _Decode(torch.nn.Module):
    def forward(self, hm):
        return cuda_decode.dark_decode(hm)


class _Attention(torch.nn.Module):
    def forward(self, q, k, v):
        return cuda_attention.flash_attention(q, k, v, 0.125)


@pytest.mark.parametrize("name", ["dark_decode", "flash_attention"])
def test_programs_record_k4_and_k8_as_ops(tmp_path, name):
    """A program that calls K4's or K8's wrapper records the kernel's op
    as a tpupose_torch:: node and, loaded back, equals the eager call."""
    rs = np.random.RandomState(2)
    if name == "dark_decode":
        mod, args = _Decode(), (T(rs.uniform(0, 1, (2, 3, 16, 12))
                                  .astype(np.float32)),)
    else:
        mod, args = _Attention(), tuple(
            T(rs.normal(0, 1, (1, 7, 2, 64)).astype(np.float32))
            for _ in range(3))
    path = exporter.export_program(mod, args, str(tmp_path / "p.pt2"))
    prog = exporter.load_program(path)
    assert exporter.program_ops(prog) == [f"tpupose_torch.{name}.default"]
    for g, w in zip(torch.utils._pytree.tree_leaves(prog(*args)),
                    torch.utils._pytree.tree_leaves(mod(*args))):
        assert torch.equal(g, w)


@pytest.mark.parametrize("name", ["stem_pool", "layer1", "bridge",
                                  "dark_decode", "flash_attention"])
def test_eager_wrapper_calls_the_body_not_the_op(monkeypatch, name):
    """Outside tracing a kernel's wrapper calls its op's body straight,
    without the op's dispatch (ops/_build.op_or_body): with the op
    replaced by one that raises, the wrapper still answers, equal to the
    op on the same inputs."""
    op, args, _, wrapper = _op_cases()[name]
    want = op(*args)
    want = want[:1] if name == "flash_attention" else want
    mod = {"stem_pool": cuda_stem, "layer1": cuda_layer1,
           "bridge": cuda_bridge, "dark_decode": cuda_decode,
           "flash_attention": cuda_attention}[name]

    def refuse(*a, **k):
        raise AssertionError(f"{name}: an eager call went through the op")

    monkeypatch.setattr(mod, f"{name}_op", refuse)
    got = wrapper()
    for g, w in zip(got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,)):
        assert torch.equal(g, w)


def test_aten_export_entry_point_is_pinned(monkeypatch):
    """export_program traces through torch's private
    torch.export._trace._export(strict=, pre_dispatch=): this torch is
    one of the versions it was run with (exporter.ATEN_EXPORT_TESTED),
    the entry point takes those keywords, and a torch whose entry point
    lost them is refused by name before any tracing."""
    from torch.export import _trace

    assert ".".join(torch.__version__.split(".")[:2]) in \
        exporter.ATEN_EXPORT_TESTED, torch.__version__
    assert exporter.aten_export() is _trace._export
    monkeypatch.setattr(_trace, "_export", lambda mod, args, strict=True:
                        None)
    with pytest.raises(RuntimeError, match="pre_dispatch= is gone"):
        exporter.export_program(_Decode(), (torch.zeros(1, 1, 4, 4),),
                                "unused.pt2")


# -- npz ------------------------------------------------------------------------

def test_npz_round_trip(tmp_path):
    """export_npz writes params/<name> and batch_stats/<name> in the
    port's names; load_npz + npz_state_dict restore a fresh model
    exactly."""
    g = torch.Generator().manual_seed(0)
    m = SimpleBaseline("resnet18", K, (16, 16, 16), dtype=torch.float32,
                       device="cpu", generator=g)
    with torch.no_grad():
        for b in m.buffers():
            if b.is_floating_point():
                b.uniform_(0.5, 1.5, generator=g)
    p = exporter.export_npz(m, str(tmp_path / "w.npz"))
    tree = exporter.load_npz(p)
    assert set(tree) == {"params", "batch_stats"}
    assert set(tree["params"]) == {n for n, _ in m.named_parameters()}
    assert "backbone.bn1.running_var" in tree["batch_stats"]
    fresh = SimpleBaseline("resnet18", K, (16, 16, 16), dtype=torch.float32,
                           device="cpu")
    fresh.load_state_dict(exporter.npz_state_dict(tree))
    for (n, a), b in zip(m.state_dict().items(), fresh.state_dict().values()):
        assert torch.equal(a, b), n


def test_jax_npz_loads_into_the_port(tmp_path):
    """A `.npz` written by JAX's export_npz loads through the port's
    load_npz into JAX's nested tree, and from_flax_simple_baseline turns
    it into a port model whose forward matches flax's."""
    jm = JSimpleBaseline(backbone="resnet18", num_keypoints=K,
                         deconv_channels=(32, 32, 32), dtype=jnp.float32)
    v = jax.jit(jm.init, static_argnames="train")(
        jax.random.PRNGKey(1), jnp.zeros((1, *HW, 3)), train=False)
    v = jax.tree_util.tree_map(lambda a: np.array(a, np.float32), v)
    v = _randomize_bn(v, np.random.RandomState(2))
    path = j_export_npz(_jstate(jm.apply, v), str(tmp_path / "j.npz"))
    tree = exporter.load_npz(path)
    flat_j = jax.tree_util.tree_leaves_with_path(v)
    flat_p = jax.tree_util.tree_leaves_with_path(tree)
    assert [p for p, _ in flat_j] == [p for p, _ in flat_p]
    tm = SimpleBaseline("resnet18", K, (32, 32, 32), dtype=torch.float32,
                        device="cpu")
    tm.load_state_dict(from_flax_simple_baseline(tree))
    x = np.random.RandomState(3).normal(0, 1, (2, *HW, 3)).astype(np.float32)
    want = np.asarray(jm.apply(v, jnp.asarray(x), train=False))
    got = tm.eval()(T(x)).detach().numpy()
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()


# -- the four families' programs ------------------------------------------------

@pytest.fixture(scope="module")
def r18():
    jm = JSimpleBaseline(backbone="resnet18", num_keypoints=K,
                         deconv_channels=(32, 32, 32), dtype=jnp.float32)
    v = jax.jit(jm.init, static_argnames="train")(
        jax.random.PRNGKey(3), jnp.zeros((1, *HW, 3)), train=False)
    v = jax.tree_util.tree_map(lambda a: np.array(a, np.float32), v)
    v = _randomize_bn(v, np.random.RandomState(4))
    tm = SimpleBaseline("resnet18", K, (32, 32, 32), dtype=torch.float32,
                        device="cpu")
    tm.load_state_dict(from_flax_simple_baseline(v))
    return jm, v, tm


def _round_trip(tmp_path, module, args):
    path = exporter.export_program(module, args, str(tmp_path / "prog.pt2"))
    return exporter.load_program(path)


def _jax_program(tmp_path, fn, args):
    path = export_stablehlo(fn, args, str(tmp_path / "prog.stablehlo"))
    return load_stablehlo(path)


@pytest.mark.parametrize("flip", [True, False])
def test_heatmap_program_matches_eager_and_jax(tmp_path, r18, flip):
    """The heatmap program (normalize, forward, flip merge, DARK,
    back-projection), loaded back, equals TopDownEvaluator.step, and
    JAX's export_stablehlo program of the same weights within the
    evaluator's bounds."""
    jm, v, tm = r18
    pairs = np.array([(1, 2)])
    ev = TopDownEvaluator(tm, (16, 16), flip_test=flip, flip_pairs=pairs,
                          device="cpu")
    imgs, c, s = _crops()
    prog = _round_trip(tmp_path, exporter.HeatmapProgram(ev),
                       (T(imgs), T(c), T(s)))
    got = prog(T(imgs), T(c), T(s))
    eager = ev.step(imgs, c, s)
    for g, e in zip(got, eager):
        assert torch.equal(g, e)
    jev = JEvaluator(_jstate(jm.apply, v), (16, 16), flip_test=flip,
                     flip_pairs=pairs)
    call = _jax_program(tmp_path, lambda i, cc, ss: jev._eval_step(
        jev.state, i, cc, ss), (imgs, c, s))
    wc, ws = call(imgs, c, s)
    tol = 2e-2 * float(np.max(s / 16.0))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(wc), atol=tol)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(ws), rtol=1e-4,
                               atol=1e-6)


def test_r50_program_records_k1_k3_ops_and_matches_eager(tmp_path):
    """SimpleBaseline-R50 at 256x192 takes the kernel route (K1-K3's
    plain versions on the CPU): its program records stem_pool, layer1 and
    bridge once per forward (twice under flip), holds the folded weights
    as buffers, and, loaded back, equals the eager step."""
    m = SimpleBaseline("resnet50", 17, dtype=torch.float32, device="cpu",
                       generator=torch.Generator().manual_seed(0))
    ev = TopDownEvaluator(m, (64, 48), device="cpu")
    assert ev.fast_weights is not None
    prog_mod = exporter.HeatmapProgram(ev)
    bufs = dict(prog_mod.named_buffers())
    assert "fast_stem_0_w" in bufs and "fast_layer1_2_w3" in bufs \
        and "fast_bridge_0_wds" in bufs
    imgs, c, s = _crops(1, (256, 192), seed=4)
    prog = _round_trip(tmp_path, prog_mod, (T(imgs), T(c), T(s)))
    assert exporter.program_ops(prog) == [
        f"tpupose_torch.{n}.default"
        for n in ("stem_pool", "layer1", "bridge")] * 2
    for g, e in zip(prog(T(imgs), T(c), T(s)), ev.step(imgs, c, s)):
        assert torch.equal(g, e)
