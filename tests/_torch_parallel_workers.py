"""Rank functions of the port's multi-rank tests, run by _torch_ranks.py on
gloo CPU ranks. They import torch and vaw_torch only (never JAX): the test
files compute the JAX side in the parent and hand numpy arrays over."""

from __future__ import annotations

import glob
import os

import numpy as np
import torch
import torch.distributed as dist

from vaw_torch.parallel.distributed import process_allgather, rank, world_size


def _np(t):
    return None if t is None else t.detach().float().cpu().numpy()


# ---------------------------------------------------------------- mesh

def mesh_layout(data_axis, model_axis, pp_stages, sp_degree):
    """The meshes' shapes, names and this rank's coordinates, its rows of a
    global batch, and process_allgather of its rank."""
    from vaw_torch.parallel.mesh import (
        batch_sharding,
        make_mesh,
        make_pp_mesh,
        make_sp_mesh,
        shard_batch,
    )

    out = {}
    for key, mesh in (("dp_tp", make_mesh(data_axis, model_axis)),
                      ("pp", make_pp_mesh(pp_stages)), ("sp", make_sp_mesh(sp_degree))):
        out[key] = {"shape": tuple(mesh.mesh.shape), "names": mesh.mesh_dim_names,
                    "ranks": mesh.mesh.tolist(),
                    "coords": [mesh.get_local_rank(n) for n in mesh.mesh_dim_names],
                    "rows": shard_batch(mesh, {"x": np.arange(8)})["x"].tolist(),
                    "slice": repr(batch_sharding(mesh))}
    out["gathered"] = process_allgather(np.full((2, 3), rank(), np.int64))
    out["scalar"] = process_allgather(np.asarray(10.0 * rank(), np.float32))
    return out


# ---------------------------------------------------------------- ring

def ring(q, k, v, g, dtype):
    """This rank's output rows and q/k/v gradient rows of ring attention
    over all ranks, loss sum(out * g)."""
    from torch.distributed.device_mesh import init_device_mesh

    from vaw_torch.parallel.ring_attention import ring_attention

    mesh = init_device_mesh("cpu", (world_size(),), mesh_dim_names=("sp",))
    rows = q.shape[1] // world_size()
    sl = slice(rank() * rows, (rank() + 1) * rows)
    dt = getattr(torch, dtype)
    ql, kl, vl = (torch.tensor(a[:, sl], dtype=dt, requires_grad=True) for a in (q, k, v))
    out = ring_attention(ql, kl, vl, mesh)
    (out.float() * torch.from_numpy(g[:, sl])).sum().backward()
    return [_np(t) for t in (out, ql.grad, kl.grad, vl.grad)]


# ---------------------------------------------------------------- pipelines

def _dit(spec, sd):
    from vaw_torch.models.dit import DiT

    model = DiT(**spec)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()}, strict=True)
    return model


def _named_grads(model):
    return {k: _np(p.grad) for k, p in model.named_parameters()
            if p.grad is not None and not p.is_meta}


def generic_pipeline(weights, x, aux, microbatches):
    """parallel.pipeline over all ranks as stages on a stack of
    tanh(x @ W + aux) blocks: outputs and the gradients of sum(y)."""
    from torch.distributed.device_mesh import init_device_mesh

    from vaw_torch.parallel.pipeline import pipeline, stack_stage_params

    mesh = init_device_mesh("cpu", (1, world_size()), mesh_dim_names=("data", "stage"))
    blocks = [{"w": torch.tensor(w, requires_grad=True)} for w in weights]
    xt = torch.tensor(x, requires_grad=True)
    at = torch.tensor(aux, requires_grad=True)
    pp = pipeline(lambda b, h, a: torch.tanh(h @ b["w"] + a), mesh, microbatches)
    mine = stack_stage_params(blocks, world_size())[rank()]
    y = pp(mine, xt, at)
    y.sum().backward()
    return {"y": _np(y), "gx": _np(xt.grad), "gaux": _np(at.grad),
            "gw": {i: _np(b["w"].grad)
                   for i, b in enumerate(blocks) if b["w"].grad is not None}}


def dit_pipeline(spec, sd, x, t, y, g, configs, data_axis):
    """The pipelined DiT at each (stages, micro-batches) of `configs` on a
    (data_axis, stages) mesh: this rank's data rows' output and the
    gradients of sum(out * g) (its stage's blocks and the replicated
    parameters)."""
    from vaw_torch.parallel.dit_pipeline import pipelined_dit_apply
    from vaw_torch.parallel.mesh import make_pp_mesh, shard_batch

    results = []
    for stages, micro in configs:
        mesh = make_pp_mesh(stages)
        model = _dit(spec, sd)
        apply_fn = pipelined_dit_apply(model, mesh, micro, batch_axis="data")
        for i, block in enumerate(model.blocks):
            if i not in apply_fn.owned_blocks:
                block.to("meta")
        b = shard_batch(mesh, {"x": x, "t": t, "y": y, "g": g})
        out = apply_fn(torch.from_numpy(b["x"]), torch.from_numpy(b["t"]),
                       torch.from_numpy(b["y"]).long())
        (out * torch.from_numpy(b["g"])).sum().backward()
        results.append({"out": _np(out), "grads": _named_grads(model),
                        "data": mesh.get_local_rank("data"),
                        "stage": mesh.get_local_rank("stage")})
    return results


def sp_dit(spec, sd, x, t, y, g, sp_degree):
    """The sequence-parallel DiT on a (world / sp, sp) mesh: this rank's
    data rows' output and the parameters' gradients of sum(out * g),
    summed over the sp group as the Trainer sums them."""
    from vaw_torch.parallel.mesh import make_sp_mesh, shard_batch
    from vaw_torch.parallel.sp_dit import sequence_parallel_dit_apply

    mesh = make_sp_mesh(sp_degree)
    model = _dit(spec, sd)
    apply_fn = sequence_parallel_dit_apply(model, mesh, batch_axis="data")
    b = shard_batch(mesh, {"x": x, "t": t, "y": y, "g": g})
    out = apply_fn(torch.from_numpy(b["x"]), torch.from_numpy(b["t"]),
                   torch.from_numpy(b["y"]).long())
    (out * torch.from_numpy(b["g"])).sum().backward()
    grads = {k: p.grad for k, p in model.named_parameters()}
    for v in grads.values():
        dist.all_reduce(v, group=mesh.get_group("sp"))
    return {"out": _np(out), "grads": {k: _np(v) for k, v in grads.items()},
            "data": mesh.get_local_rank("data")}


# ---------------------------------------------------------------- train steps

def _diffusion():
    from vaw_torch.core import GaussianDiffusion, ModelMeanType, get_named_beta_schedule
    from vaw_torch.core import make_schedule

    return GaussianDiffusion(schedule=make_schedule(get_named_beta_schedule("cosine", 1000)),
                             model_mean_type=ModelMeanType.EPSILON, weight_type="lambda")


def _draw_feeder(draws):
    """A Trainer.draw that returns the given global micro-batch draws in
    order (t, noise, drop as numpy)."""
    it = iter(draws)

    def draw(batch):
        d = next(it)
        return {"t": torch.from_numpy(d["t"]).long(), "weights": None,
                "noise": torch.from_numpy(d["noise"]), "latent": None,
                "drop": torch.from_numpy(d["drop"])}

    return draw


def train_steps(cfg_kwargs, spec, sd, batches, draws, layout, save_dir=None, load=None):
    """Steps of the Trainer on this rank's rows of each global batch, under
    `layout` (data_axis, model_axis, fsdp; None: no mesh), each step fed
    its global micro-batch draws. Returns, from every rank, the losses and
    grad norms, the full params and EMA after the steps (gathered, in the
    reference layout), the sharding census; writes a checkpoint to
    `save_dir` and starts from the file `load` when given."""
    from vaw_torch.models.dit import DiT
    from vaw_torch.parallel.mesh import make_mesh, shard_batch
    from vaw_torch.parallel.partition import sharding_census
    from vaw_torch.train import Trainer, load_train_state, save_checkpoint
    from vaw_torch.utils.config import TrainConfig

    mesh = None
    if layout is not None:
        mesh = make_mesh(layout["data_axis"], layout["model_axis"])
        cfg_kwargs = dict(cfg_kwargs, model_axis=layout["model_axis"], fsdp=layout["fsdp"])
    cfg = TrainConfig(**cfg_kwargs)
    model = _dit(spec, sd)
    trainer = Trainer(cfg, model, _diffusion(), mesh=mesh)
    state = trainer.init_state()
    if load is not None:
        load_train_state(load, state, trainer if mesh is not None else None)
    losses, norms = [], []
    for batch, step_draws in zip(batches, draws):
        trainer.draw = _draw_feeder(step_draws)
        local = shard_batch(mesh, batch) if mesh is not None else batch
        local = {"image": torch.from_numpy(local["image"]),
                 "label": torch.from_numpy(local["label"]).long()}
        state, metrics = trainer.step(state, local)
        losses.append(float(metrics["loss"]))
        norms.append(float(metrics["grad_norm"]))
    full = trainer.full if mesh is not None else (lambda t: t)
    out = {"losses": losses, "norms": norms, "step": state.step, "count": state.count,
           "census": sharding_census(model)}
    if state.resampler is not None:
        out["resampler"] = {"loss_history": _np(state.resampler.loss_history),
                            "loss_counts": _np(state.resampler.loss_counts)}
    for tree in ("params", "ema", "mu", "nu"):
        out[tree] = {k: _np(v) for k, v in full(getattr(state, tree)).items()}
    if save_dir is not None:
        out["path"] = save_checkpoint(cfg, state.step, state, logdir=save_dir,
                                      trainer=trainer if mesh is not None else None)
    return out


# ---------------------------------------------------------------- the CLI

def _tiny_dit_s():
    """The registry's DiT-S at width 64, depth 2, 4 heads, for the CLI runs."""
    from vaw_torch.models import dit, registry

    tiny = dit._make_dit(64, 2, 4)
    dit.DiT_models["DiT-S"] = tiny
    registry.DiT_models["DiT-S"] = tiny


def cli(argv):
    """vaw_torch.cli.main.main(argv) on this rank: the rows of its first
    train batch and, from rank 0, the run's checkpoints and sample grids."""
    from vaw_torch.cli import main as train_cli
    from vaw_torch.train import Trainer

    _tiny_dit_s()
    first = []
    step = Trainer.step

    def recording(self, state, batch):
        if not first:
            first.append(batch["image"].numpy().copy())
        return step(self, state, batch)

    Trainer.step = recording
    try:
        ctx = train_cli.main(argv)
    finally:
        Trainer.step = step
    out = {"first_batch": first[0] if first else None, "step": ctx["state"].step,
           "logdir": ctx["trainer"].cfg.logdir}
    if rank() == 0:
        out["checkpoints"] = {os.path.basename(p): torch.load(p, weights_only=True)
                              for p in glob.glob(os.path.join(out["logdir"], "checkpoint", "*.pt"))}
        from PIL import Image

        out["grids"] = {os.path.basename(p): np.asarray(Image.open(p))
                        for p in glob.glob(os.path.join(out["logdir"], "sample", "*.png"))}
    return out


def vit_tensor_parallel(spec, sd, x, t, y, g):
    """A ViT split over all ranks as the model axis: its output and the
    full, reference-layout gradients of sum(out * g)."""
    from vaw_torch.models.vit import ViT
    from vaw_torch.parallel.mesh import make_mesh
    from vaw_torch.parallel.partition import apply_tensor_parallel, full_tensors

    model = ViT(**spec)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()}, strict=True)
    permuted = apply_tensor_parallel(model, make_mesh(1, world_size()))
    out = model(torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(y).long())
    (out * torch.from_numpy(g)).sum().backward()
    grads = full_tensors({k: p.grad for k, p in model.named_parameters()}, permuted,
                         world_size())
    return {"out": _np(out), "grads": {k: _np(v) for k, v in grads.items()},
            "heads": model.blocks[0].attn.num_heads}
