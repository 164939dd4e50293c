"""Tensor parallelism over the mesh's 'model' axis (no counterpart file in
tpupose/: there, parallel/sharding.shard_params places wide kernels'
output channels on 'model' and XLA's GSPMD inserts the collectives;
here this module does both).

The layout is JAX's rule: each Conv2d, ConvTranspose2d and Linear whose
output channels are at least `min_channels` and divisible by the model
axis keeps only its model rank's contiguous block of output channels
(dim 0 of a Conv2d or Linear weight, dim 1 of a ConvTranspose2d weight
(in, out, kh, kw)); a grouped or depthwise Conv2d keeps whole groups and
takes the matching block of input channels. Biases, normalisation
parameters, layer scales, tokens and buffers stay full on every rank.

A sharded layer is column-parallel with a gathered output (Megatron's
"f" and "g", for convolutions as well as linears):

    x -> _CopyToModel -> local conv / linear -> _GatherFromModel -> + bias

`_CopyToModel` is the identity whose backward sums the input gradient
over the model group (each rank holds the part its output channels
contribute). `_GatherFromModel` all-gathers the output channels in rank
order; its backward returns this rank's slice of the gradient, which is
already the full, identical gradient on every model rank because
everything after the gather is computed replicated. So no BatchNorm ever
sees a channel-sharded activation, and the model's loss, gradients and
update are one process's up to float rounding.

torch's own pieces do not carry this layout.
`torch.distributed.nn.functional.all_gather`'s backward sums the output
gradients over the ranks (a reduce-scatter, or an all-to-all and a sum),
which after a replicated computation gives `model` times the gradient.
DTensor's convolution rule takes the output's placement from the input's
and has none for a weight sharded on its output channels.

A sharded parameter carries its `Shard` as the attribute `tp_shard`;
`full_tensor` / `local_part` move a tensor of that layout (a weight, its
optimizer moments, its EMA) between the shard and the full tensor, and
`full_state_dict` / `load_full_state_dict` do it for a module, so that a
checkpoint has the one-process format at any model-axis size.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

__all__ = ["Shard", "shard_of", "shard_module", "gather_full", "full_tensor",
           "local_part", "full_state_dict", "load_full_state_dict",
           "model_group_of"]

SHARD_ATTR = "tp_shard"


@dataclass(frozen=True)
class Shard:
    """Where a sharded tensor's block lies: dimension `dim` of the full
    tensor, of length `full`, cut into `size` equal blocks of which this
    rank holds block `rank`; `group` is the model group."""
    dim: int
    rank: int
    size: int
    full: int
    group: object


def shard_of(t) -> Shard | None:
    return getattr(t, SHARD_ATTR, None)


def model_group_of(params):
    """The model group of the first sharded parameter (None: none is)."""
    for p in params:
        s = shard_of(p)
        if s is not None:
            return s.group
    return None


# -- the two collectives --------------------------------------------------------

class _CopyToModel(torch.autograd.Function):
    """Identity; the backward all-reduces (sums) the gradient over the
    model group."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _GatherFromModel(torch.autograd.Function):
    """All-gather along `dim` in rank order; the backward returns this
    rank's block of the (replicated) gradient, without communication."""

    @staticmethod
    def forward(ctx, y, dim, group):
        size = dist.get_world_size(group)
        ctx.dim, ctx.n = dim, y.shape[dim]
        ctx.rank = dist.get_rank(group)
        y = y.contiguous()
        parts = [torch.empty_like(y) for _ in range(size)]
        dist.all_gather(parts, y, group=group)
        return torch.cat(parts, dim)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.rank * ctx.n, ctx.n).contiguous(), \
            None, None


def _add_bias(y, bias, dim):
    if bias is None:
        return y
    shape = [1] * y.dim()
    shape[dim] = -1
    return y + bias.to(y.dtype).view(shape)


# -- column-parallel layers -------------------------------------------------------
# Each mixin sits between the model's own class and torch's layer in the
# method order (a subclass such as yolo_head.Float32Conv keeps its own
# forward, whose super() call then reaches the mixin). A sharded layer
# holds `tp_group`, `tp_in` (the block of input channels a grouped
# Conv2d's shard reads, else None) and `tp_full` (its own class and full
# channel counts, for gather_full).

class _ColumnParallelConv2d(nn.Conv2d):
    def _conv_forward(self, x, weight, bias):
        x = _CopyToModel.apply(x, self.tp_group)
        if self.tp_in is not None:
            x = x[:, self.tp_in]
        y = super()._conv_forward(x, weight, None)
        return _add_bias(_GatherFromModel.apply(y, 1, self.tp_group), bias, 1)


class _ColumnParallelConvTranspose2d(nn.ConvTranspose2d):
    def forward(self, x, output_size=None):
        out_pad = self._output_padding(x, output_size, self.stride,
                                       self.padding, self.kernel_size, 2,
                                       self.dilation)
        x = _CopyToModel.apply(x, self.tp_group)
        y = F.conv_transpose2d(x, self.weight, None, self.stride,
                               self.padding, out_pad, self.groups,
                               self.dilation)
        return _add_bias(_GatherFromModel.apply(y, 1, self.tp_group),
                         self.bias, 1)


class _ColumnParallelLinear(nn.Linear):
    def forward(self, x):
        x = _CopyToModel.apply(x, self.tp_group)
        y = F.linear(x, self.weight)
        return _add_bias(_GatherFromModel.apply(y, -1, self.tp_group),
                         self.bias, -1)


_MIXINS = ((nn.ConvTranspose2d, _ColumnParallelConvTranspose2d),
           (nn.Conv2d, _ColumnParallelConv2d),
           (nn.Linear, _ColumnParallelLinear))
_CLASSES: dict = {}


def _parallel_class(cls):
    """The column-parallel class of a layer of class `cls`."""
    if cls not in _CLASSES:
        base, mixin = next((b, m) for b, m in _MIXINS if issubclass(cls, b))
        _CLASSES[cls] = mixin if cls is base else type(
            f"ColumnParallel{cls.__name__}", (cls, mixin), {})
    return _CLASSES[cls]


def _out_dim(m: nn.Module, size: int):
    """(the weight's output-channel dim, output channels) of a layer
    JAX's rule may shard at model size `size`; None for any other
    module, and for a grouped layer whose groups would straddle ranks."""
    if isinstance(m, nn.ConvTranspose2d):
        return (1, m.out_channels) if m.groups == 1 else None
    if isinstance(m, nn.Conv2d):
        grouped = m.groups > 1 and m.groups % size
        return None if grouped else (0, m.out_channels)
    if isinstance(m, nn.Linear):
        return 0, m.out_features
    return None


@torch.no_grad()
def shard_module(module: nn.Module, rank: int, size: int, group,
                 min_channels: int = 64) -> list:
    """Shard `module` in place over a model group of `size` ranks, this
    process being `rank` of it: every Conv2d, ConvTranspose2d and Linear
    with at least `min_channels` output channels divisible by `size`
    keeps its block of output channels (a grouped Conv2d whole groups
    and their input channels), becomes column-parallel, and its weight
    is tagged with its Shard. The Parameter objects stay the same, so an
    optimizer built over them goes on working (its state must still be
    empty). Returns the names of the sharded weights ([] for size 1)."""
    if size <= 1:
        return []
    names = []
    for name, m in module.named_modules():
        layout = _out_dim(m, size)
        if layout is None or hasattr(m, "tp_group"):
            continue
        dim, out = layout
        if out < min_channels or out % size:
            continue
        w = m.weight
        s = Shard(dim, rank, size, out, group)
        full = {"cls": type(m)}
        m.tp_in = None
        if isinstance(m, nn.Linear):
            full["out_features"] = out
            m.out_features = out // size
        else:
            full["out_channels"] = out
            m.out_channels = out // size
        if isinstance(m, nn.Conv2d) and m.groups > 1:
            full.update(in_channels=m.in_channels, groups=m.groups)
            n_in = m.in_channels // size
            m.tp_in = slice(rank * n_in, (rank + 1) * n_in)
            m.in_channels, m.groups = n_in, m.groups // size
        w.data = local_part(w.data, s)
        setattr(w, SHARD_ATTR, s)
        m.tp_group, m.tp_full = group, full
        m.__class__ = _parallel_class(type(m))
        names.append(f"{name}.weight" if name else "weight")
    return names


def full_tensor(t: torch.Tensor, s: Shard | None) -> torch.Tensor:
    """The full tensor of which `t` is this rank's block `s` (t itself
    where s is None); a collective over the model group."""
    if s is None:
        return t
    t = t.detach().contiguous()
    parts = [torch.empty_like(t) for _ in range(s.size)]
    dist.all_gather(parts, t, group=s.group)
    return torch.cat(parts, s.dim)


def local_part(t: torch.Tensor, s: Shard | None) -> torch.Tensor:
    """This rank's block `s` of the full tensor `t` (t where s is None)."""
    if s is None:
        return t
    n = s.full // s.size
    return t.narrow(s.dim, s.rank * n, n).clone()


@torch.no_grad()
def gather_full(module: nn.Module, out: nn.Module | None = None,
                params=None):
    """A full, unsharded module with `module`'s parameters (or `params`,
    tensors in module.parameters()'s order and layout, such as its EMA)
    and buffers: `out` (made by an earlier call) refreshed in place, or
    a new copy whose layers are the model's own classes again. Every
    model rank must call it (one all-gather a sharded weight)."""
    if out is None:
        # process groups (the layers', synchronised BatchNorms') are
        # shared, not copied
        memo = {id(v): v for m in module.modules() for v in vars(m).values()
                if isinstance(v, dist.ProcessGroup)}
        out = copy.deepcopy(module, memo)
        for o in out.modules():
            full = o.__dict__.pop("tp_full", None)
            if full is None:
                continue
            del o.tp_group, o.tp_in
            o.__class__ = full.pop("cls")
            for k, v in full.items():
                setattr(o, k, v)
        for mp, op in zip(module.parameters(), out.parameters()):
            s = shard_of(mp)
            if s is not None:
                shape = list(mp.shape)
                shape[s.dim] = s.full
                op.data = mp.new_empty(shape)
    mps = list(module.parameters())
    for mp, src, op in zip(mps, mps if params is None else params,
                           out.parameters()):
        op.copy_(full_tensor(src, shard_of(mp)))
    for mb, ob in zip(module.buffers(), out.buffers()):
        ob.copy_(mb)
    return out


def full_state_dict(module: nn.Module) -> dict:
    """module.state_dict() with every sharded weight gathered: the
    one-process format (a collective over the model group)."""
    sd = module.state_dict()
    for name, p in module.named_parameters():
        s = shard_of(p)
        if s is not None:
            sd[name] = full_tensor(p, s)
    return sd


def load_full_state_dict(module: nn.Module, sd: dict):
    """Load a one-process state dict into a sharded `module`: each
    sharded weight takes its block."""
    sd = dict(sd)
    for name, p in module.named_parameters():
        s = shard_of(p)
        if s is not None and name in sd:
            sd[name] = local_part(sd[name], s)
    return module.load_state_dict(sd)
