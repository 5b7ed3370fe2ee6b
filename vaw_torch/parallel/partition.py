"""Tensor parallelism, FSDP and pipeline ownership of the parameters
(counterpart of vaw_tpu/parallel/partition.py).

Tensor parallelism is Megatron's column/row split of each transformer
block's attention and MLP over the mesh's "model" axis, written as a rule
table over the port's parameter names (vaw_tpu/parallel/partition.py:27-41)
and applied with ``parallelize_module``: the first Linear of a pair is
column-parallel (its ``[out, in]`` weight and its bias sharded on dim 0;
a Flax kernel is ``[in, out]``, so the JAX spec is ``P(None, "model")``),
the second row-parallel (weight dim 1, bias replicated), and the
row-parallel product ends in one all-reduce.

The fused qkv Linear is split head-aligned. A contiguous split of its
``3 * H * D`` rows would give rank 0 all of q and half of k, and the fused
attention kernels read their input as ``[3, H, D]``; so its rows are first
permuted to ``[tp, 3, H / tp, D]`` (``head_aligned_rows``), then split
contiguously: rank r holds the q, k and v rows of heads
[r H / tp, (r + 1) H / tp), and its attention runs on a local
``[B, T, 3 (H / tp) D]`` at H / tp heads with no gather. The row-parallel
proj reads exactly those heads' columns. Checkpoints and gathered state
dicts undo the permutation (``full_tensors``), so they keep the reference
layout.

FSDP is ``fully_shard`` (FSDP2) on every block and then on the root, over
the "data" sub-mesh, composed with tensor parallelism on the 2-D mesh. It
shards every parameter on dim 0, where the JAX package keeps leaves under
``FSDP_MIN_SIZE`` replicated (:130-168): the layout differs, the numbers
do not; ``sharding_census`` says which leaves are sharded. EMA and the
Adam moments are made from the (DTensor) parameters and so carry their
placements (the port's ``tree_shardings_like``). Under pipeline
parallelism stage s owns blocks [s L / S, (s + 1) L / S)
(``pp_param_shardings``); the others' weights are dropped from the rank.
"""

from __future__ import annotations

import re
from typing import Dict, List, Mapping, Optional, Tuple

import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Replicate, Shard

__all__ = ["TRANSFORMER_RULES", "FSDP_MIN_SIZE", "transformer_partition_rules",
           "partition_specs", "param_shardings", "shard_params",
           "fsdp_partition_specs", "fsdp_param_shardings", "pp_param_shardings",
           "tree_shardings_like", "tp_rule_census", "assert_tp_rules_applied",
           "head_aligned_rows", "tp_local_shard", "apply_tensor_parallel",
           "apply_fsdp", "sharding_census", "full_tensors", "local_like",
           "to_local", "replication_factor", "tp_split_dit_block",
           "tp_split_dit_block_forward"]

_BLOCK = r"(?:^|.*\.)(?:blocks\.\d+|\w+_blocks\.\d+|mid_block)"
# (parameter-name regex, "col" or "row"), first match wins. Matched by
# weight names (2-D and up, as the JAX census counts kernels); a bias
# follows its Linear. attn.qkv/attn.proj are the DiT's and the ViT's
# attention (JAX: MultiHeadSelfAttention_i and ViTAttention_i); U-ViT's
# attention is inline in its JAX block and matches no rule there, so only
# its MLPs match here too (blocks.{i}, in_blocks.{i}, mid_block,
# out_blocks.{i}).
TRANSFORMER_RULES: Tuple[Tuple[str, str], ...] = (
    (r"(?:^|.*\.)blocks\.\d+\.attn\.qkv\.weight", "col"),
    (_BLOCK + r"\.mlp\.fc1\.weight", "col"),
    (r"(?:^|.*\.)blocks\.\d+\.attn\.proj\.weight", "row"),
    (_BLOCK + r"\.mlp\.fc2\.weight", "row"),
)

# The JAX package's threshold for keeping a leaf replicated under FSDP;
# fully_shard shards every leaf, and the census reports against it.
FSDP_MIN_SIZE = 1 << 14


def transformer_partition_rules():
    return TRANSFORMER_RULES


def _named(params) -> Dict[str, torch.Tensor]:
    return dict(params.named_parameters()) if isinstance(params, nn.Module) else dict(params)


def _rule_for(name: str, rules) -> Optional[str]:
    for pattern, kind in rules:
        if re.fullmatch(pattern, name):
            return kind
    return None


def _kind(name: str, rules) -> Optional[str]:
    """The rule of a parameter: a weight's own, a bias its weight's."""
    if name.endswith(".bias"):
        return _rule_for(name[:-len("bias")] + "weight", rules)
    return _rule_for(name, rules)


def tp_rule_census(params, rules=TRANSFORMER_RULES) -> Tuple[List[str], List[str]]:
    """-> (matched weight names, unmatched weight names); a weight is any
    parameter of 2 or more dims, as the JAX census counts kernels."""
    matched, unmatched = [], []
    for name, p in _named(params).items():
        if p.dim() < 2:
            continue
        (matched if _rule_for(name, rules) else unmatched).append(name)
    return matched, unmatched


def assert_tp_rules_applied(params, model_axis_size: int, rules=TRANSFORMER_RULES,
                            verbose: bool = True):
    """Fail fast when tensor parallelism is asked for and the rules match no
    weight: a renamed module must not silently replicate
    (vaw_tpu/parallel/partition.py:63-85)."""
    if model_axis_size <= 1:
        return
    matched, unmatched = tp_rule_census(params, rules)
    if not matched:
        sample = sorted(unmatched)[:6]
        raise ValueError(
            f"model_axis={model_axis_size} but no TP partition rule matched any "
            f"kernel; the model would silently replicate. Kernel paths seen: "
            f"{sample}{'...' if len(unmatched) > 6 else ''} — extend "
            "TRANSFORMER_RULES or run with model_axis=1.")
    if verbose:
        print(f"[tp] model_axis={model_axis_size}: {len(matched)} kernels sharded, "
              f"{len(unmatched)} replicated")


def partition_specs(params, rules=TRANSFORMER_RULES) -> Dict[str, Tuple]:
    """{name: spec}: for each dim of the parameter, "model" where it is
    split over the model axis, else None; () for a replicated one."""
    specs = {}
    for name, p in _named(params).items():
        kind = _kind(name, rules)
        dim = {"col": 0, "row": 1}.get(kind)
        if dim is None or dim >= p.dim():  # replicated, or a row-parallel bias
            specs[name] = ()
        else:
            specs[name] = tuple("model" if i == dim else None for i in range(p.dim()))
    return specs


def param_shardings(mesh: DeviceMesh, params, rules=TRANSFORMER_RULES):
    """{name: [placement]} on the mesh's "model" axis."""
    return {name: [Shard(spec.index("model")) if spec else Replicate()]
            for name, spec in partition_specs(params, rules).items()}


def head_aligned_rows(rows: int, num_heads: int, tp: int) -> torch.Tensor:
    """The permutation of a fused qkv Linear's rows (reference order
    [3, H, D]) into [tp, 3, H / tp, D]: new = old[perm]."""
    d = rows // (3 * num_heads)
    idx = torch.arange(rows).reshape(3, tp, num_heads // tp, d)
    return idx.permute(1, 0, 2, 3).reshape(-1)


def tp_local_shard(name: str, tensor: torch.Tensor, rank: int, tp: int,
                   num_heads: Optional[int] = None, rules=TRANSFORMER_RULES
                   ) -> torch.Tensor:
    """Rank `rank`'s shard of the full reference-layout parameter `name` at
    tensor-parallel degree `tp`: what apply_tensor_parallel leaves on that
    rank. A qkv weight or bias (num_heads given) is split head-aligned."""
    kind = _kind(name, rules)
    if kind is None or (kind == "row" and name.endswith(".bias")):
        return tensor
    dim = 0 if kind == "col" else 1
    if num_heads is not None:
        tensor = tensor[head_aligned_rows(tensor.shape[0], num_heads, tp)]
    return tensor.chunk(tp, dim=dim)[rank]


def _qkv_parent(model: nn.Module, module_name: str) -> Optional[nn.Module]:
    if not module_name.endswith(".qkv"):
        return None
    return model.get_submodule(module_name[:-len(".qkv")])


def apply_tensor_parallel(model: nn.Module, mesh: DeviceMesh,
                          rules=TRANSFORMER_RULES) -> Dict[str, int]:
    """Split `model`'s matched Linears over mesh["model"] in place (the
    qkv rows permuted head-aligned first; each attention then runs its
    local heads) and return {parameter name: heads} of the permuted qkv
    parameters, which full_tensors needs to undo the permutation."""
    from torch.distributed.tensor.parallel import (
        ColwiseParallel,
        RowwiseParallel,
        parallelize_module,
    )

    tp = mesh["model"].size()
    assert_tp_rules_applied(model, tp, rules, verbose=False)
    if getattr(model, "rel_pos_bias", None) is not None:
        raise ValueError("--model_axis > 1 does not split the ViT's shared relative "
                         "position bias over heads")
    plan, permuted = {}, {}
    for name, _ in list(model.named_parameters()):
        kind = _rule_for(name, rules)
        if kind is None:
            continue
        module_name = name[:-len(".weight")]
        plan[module_name] = ColwiseParallel() if kind == "col" else RowwiseParallel()
        attn = _qkv_parent(model, module_name)
        if attn is None:
            continue
        heads = attn.num_heads
        if heads % tp:
            raise ValueError(f"{module_name}: {heads} heads do not split over "
                             f"--model_axis {tp}")
        linear = model.get_submodule(module_name)
        perm = head_aligned_rows(linear.weight.shape[0], heads, tp)
        with torch.no_grad():
            for leaf in ("weight", "bias"):
                p = getattr(linear, leaf)
                if p is not None:
                    p.copy_(p[perm.to(p.device)])
                    permuted[f"{module_name}.{leaf}"] = heads
        attn.num_heads = heads // tp
    parallelize_module(model, mesh["model"], plan)
    return permuted


def shard_params(mesh: DeviceMesh, model: nn.Module, rules=TRANSFORMER_RULES):
    """Tensor-parallel `model` in place over mesh["model"]."""
    return apply_tensor_parallel(model, mesh, rules)


def apply_fsdp(model: nn.Module, mesh: DeviceMesh) -> nn.Module:
    """fully_shard each block of each top-level block list (and U-ViT's
    mid block), then the root, over mesh["data"]."""
    from torch.distributed.fsdp import fully_shard

    data = mesh["data"]
    for name, child in model.named_children():
        blocks = child if isinstance(child, nn.ModuleList) else (
            [child] if name == "mid_block" else [])
        for block in blocks:
            fully_shard(block, mesh=data)
    fully_shard(model, mesh=data)
    return model


def fsdp_partition_specs(params, data_axis_size: int, rules=TRANSFORMER_RULES):
    """The TP specs with dim 0 also split over "data" (fully_shard's
    layout, every leaf; the JAX package keeps leaves under FSDP_MIN_SIZE
    replicated): a tuple of axis names on a dim split over two axes."""
    specs, named = {}, _named(params)
    for name, spec in partition_specs(named, rules).items():
        p = named[name]
        spec = list(spec) or [None] * p.dim()
        if data_axis_size > 1 and p.dim():
            spec[0] = "data" if spec[0] is None else ("data", spec[0])
        specs[name] = tuple(spec)
    return specs


def fsdp_param_shardings(mesh: DeviceMesh, model: nn.Module):
    """fully_shard `model` over mesh["data"] and return its census."""
    apply_fsdp(model, mesh)
    return sharding_census(model)


def _splits(placement) -> bool:
    """Whether a placement splits the tensor (Shard, or FSDP2's strided
    shard over a tensor-parallel one, which is_shard() does not count)."""
    return not (placement.is_replicate() or placement.is_partial())


def sharding_census(params) -> Dict[str, object]:
    """{"sharded": names split over some mesh axis, "replicated": the rest,
    "below_min_size": sharded leaves the JAX package would keep
    replicated (fewer than FSDP_MIN_SIZE elements)}."""
    sharded, replicated, small = [], [], []
    for name, p in _named(params).items():
        if isinstance(p, DTensor) and any(_splits(pl) for pl in p.placements):
            sharded.append(name)
            if p.numel() < FSDP_MIN_SIZE:
                small.append(name)
        else:
            replicated.append(name)
    return {"sharded": sharded, "replicated": replicated, "below_min_size": small}


def pp_param_shardings(depth: int, num_stages: int, stage: int) -> range:
    """The blocks stage `stage` owns: [s L / S, (s + 1) L / S)."""
    if depth % num_stages:
        raise ValueError(f"depth {depth} does not split over {num_stages} stages")
    per = depth // num_stages
    return range(stage * per, (stage + 1) * per)


def tree_shardings_like(tree: Mapping[str, torch.Tensor],
                        params: Mapping[str, torch.Tensor]) -> Dict[str, object]:
    """{name: placements}: a state tree's entries that share a parameter's
    name take that parameter's placements (None where the parameter is a
    plain tensor); EMA and moments made with zeros_like/clone of the
    parameters already have them."""
    return {k: (params[k].placements if isinstance(params.get(k), DTensor) else None)
            for k in tree}


def to_local(t: torch.Tensor) -> torch.Tensor:
    """This rank's shard of a DTensor (a view: updates in place reach it);
    a plain tensor as it is. Call under torch.no_grad to update in place."""
    return t.to_local() if isinstance(t, DTensor) else t


def _unpermute(name: str, t: torch.Tensor, permuted: Mapping[str, int], tp: int):
    heads = permuted.get(name)
    if heads is None:
        return t
    perm = head_aligned_rows(t.shape[0], heads, tp).to(t.device)
    return t[torch.argsort(perm)]


def full_tensors(tree: Mapping[str, torch.Tensor], permuted: Mapping[str, int] = (),
                 tp: int = 1) -> Dict[str, torch.Tensor]:
    """Full, reference-layout copies of a (possibly sharded) state tree:
    DTensors gathered (a collective: every rank calls it), qkv rows put
    back in [3, H, D] order."""
    permuted = dict(permuted)
    out = {}
    for name, t in tree.items():
        t = t.detach()
        if isinstance(t, DTensor):
            t = t.full_tensor()
        out[name] = _unpermute(name, t, permuted, tp)
    return out


def local_like(name: str, full: torch.Tensor, like: torch.Tensor,
               permuted: Mapping[str, int] = (), tp: int = 1) -> torch.Tensor:
    """This rank's part, in `like`'s layout, of the reference-layout tensor
    `full`: the qkv rows permuted head-aligned, then the shard `like`'s
    placements give this rank (no communication)."""
    heads = dict(permuted).get(name)
    full = full.to(device=to_local(like).device, dtype=like.dtype)
    if heads is not None:
        full = full[head_aligned_rows(full.shape[0], heads, tp).to(full.device)]
    if not isinstance(like, DTensor):
        return full
    mesh = like.device_mesh
    replicated = DTensor.from_local(full, mesh, [Replicate()] * mesh.ndim, run_check=False)
    return replicated.redistribute(mesh, like.placements).to_local()


def replication_factor(t: torch.Tensor) -> int:
    """How many ranks of the process group hold each element of `t`'s local
    shard: the world for a plain tensor, the world over the sizes of the
    mesh axes that split a DTensor."""
    n = dist.get_world_size() if dist.is_initialized() else 1
    if isinstance(t, DTensor):
        for i, pl in enumerate(t.placements):
            if _splits(pl):
                n //= t.device_mesh.size(i)
    return n




def tp_split_dit_block(block: nn.Module, tp: int) -> List[nn.Module]:
    """The `tp` ranks' shards of one DiT block, each a copy of the block
    holding ``tp_local_shard`` of every parameter (the rules read it as
    ``blocks.0``) and num_heads / tp heads: what apply_tensor_parallel
    leaves on each rank of the model axis, in one process."""
    import copy

    heads = block.attn.num_heads
    if heads % tp:
        raise ValueError(f"{heads} heads do not split over {tp} ranks")
    shards = []
    for r in range(tp):
        local = copy.deepcopy(block)
        for name, p in list(local.named_parameters()):
            full = dict(block.named_parameters())[name].detach()
            qkv = name.startswith("attn.qkv.")
            shard = tp_local_shard(f"blocks.0.{name}", full, r, tp, heads if qkv else None)
            module, leaf = local.get_submodule(name.rsplit(".", 1)[0]), name.rsplit(".", 1)[1]
            setattr(module, leaf, nn.Parameter(shard.clone()))
        local.attn.num_heads = heads // tp
        shards.append(local)
    return shards


def tp_split_dit_block_forward(shards: List[nn.Module], x: torch.Tensor,
                               c: torch.Tensor) -> torch.Tensor:
    """A DiT block's forward from its tensor-parallel shards in one
    process: each rank's column-parallel products and attention on its own
    heads, the row-parallel partials summed (the all-reduce) and their
    bias added once; the single-process reference of the split."""
    import torch.nn.functional as F

    from ..models.dit import _layer_norm
    from ..models.layers import modulate
    from ..ops.attention import multi_head_attention_fused

    first = shards[0]
    (shift_msa, scale_msa, gate_msa,
     shift_mlp, scale_mlp, gate_mlp) = first.adaLN_modulation(c).chunk(6, dim=-1)

    def row_parallel(partials, bias):
        return sum(partials) + bias.to(partials[0].dtype)

    h = modulate(_layer_norm(x), shift_msa, scale_msa)
    attn = row_parallel([
        F.linear(multi_head_attention_fused(s.attn.qkv(h), s.attn.num_heads),
                 s.attn.proj.weight.to(h.dtype)) for s in shards], first.attn.proj.bias)
    x = x + gate_msa[:, None] * attn
    h = modulate(_layer_norm(x), shift_mlp, scale_mlp)
    mlp = row_parallel([
        F.linear(F.gelu(s.mlp.fc1(h), approximate=s.mlp.approximate),
                 s.mlp.fc2.weight.to(h.dtype)) for s in shards], first.mlp.fc2.bias)
    return x + gate_mlp[:, None] * mlp
