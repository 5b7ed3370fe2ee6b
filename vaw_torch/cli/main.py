"""Training entry point, flag-compatible with the reference main.py (counterpart
of vaw_tpu/cli/main.py; reference: main.py:36-405).

    python -m vaw_torch.cli.main --train True --eval False --model DiT-B ...

parse_args -> init (logdir, dataset, diffusion, model, trainer, sampler)
-> the step loop with periodic logging, sample grids and checkpoints.
Runs on the first CUDA card; ``VAW_PLATFORM=cpu`` selects the CPU, and with
no card and no CPU request it raises rather than fall back. Batches come
from ``load_dataset`` (every dataset of the JAX CLI) through
``prefetch_to_device``, which assembles and copies them on a background
thread; --async_checkpoint writes checkpoints on a thread. Metrics go
through the writers of utils/kvlogger that --log_formats names (csv and
json by default, as the JAX CLI writes); each record carries wait_data, the
seconds the loop waited on the prefetcher since the one before. As the JAX
CLI does, ``init`` draws one batch from the loader before it builds the
state (vaw_tpu/cli/main.py:229), which starts the loader's first epoch, so
training reads from the second epoch on in both. Not ported yet, and
refused at start: evaluation (--eval True, ROADMAP A14), the parallel
layouts (A16), classifier guidance (A15).
"""

from __future__ import annotations

import argparse
import copy
import signal
import time

import numpy as np
import torch

from ..core import (
    FlowMatching,
    GaussianDiffusion,
    LossType,
    ModelMeanType,
    ModelVarType,
    get_named_beta_schedule,
    make_schedule,
)
from ..data import load_dataset, prefetch_to_device
from ..models import build_model, cast_for_compute
from ..samplers import Sampler
from ..train import (
    AsyncCheckpointWriter,
    Trainer,
    load_train_state,
    save_checkpoint,
)
from ..utils import (
    add_train_args,
    config_from_args,
    generate_logdir,
    kvlogger,
    save_grid_png,
)
from .sample import select_device

__all__ = ["parse_args", "build_diffusion", "init", "train", "main"]


def parse_args(argv=None):
    parser = argparse.ArgumentParser(
        description="Train diffusion models (PyTorch, CUDA)")
    add_train_args(parser)
    return config_from_args(parser.parse_args(argv))


def build_diffusion(cfg):
    """The training process (reference: main.py:224-256;
    vaw_tpu/cli/main.py:68-99): a GaussianDiffusion, or a FlowMatching under
    --model_mode flow; the respaced DDIM process of the JAX CLI comes with
    its sampler (A15)."""
    if cfg.model_mode == "flow":
        return FlowMatching(
            model_mean_type=ModelMeanType[cfg.mean_type.upper()],
            path_type=cfg.path_type, sampler_type=cfg.sampler_type,
            weight_type=cfg.weight_type, p2_k=cfg.p2_k, p2_gamma=cfg.p2_gamma,
            gamma=cfg.gamma, learn_align=cfg.learn_align,
            align_type=cfg.align_type, time_dist=tuple(cfg.time_dist))
    if cfg.model_mode != "diffusion":
        raise ValueError(f"Unsupported model_mode: {cfg.model_mode}")
    return GaussianDiffusion(
        schedule=make_schedule(
            get_named_beta_schedule(cfg.path_type, cfg.diffusion_steps)),
        model_mean_type=ModelMeanType[cfg.mean_type.upper()],
        model_var_type=ModelVarType[cfg.var_type.upper()],
        loss_type=LossType[cfg.loss_type.upper()],
        weight_type=cfg.weight_type, p2_k=cfg.p2_k, p2_gamma=cfg.p2_gamma,
        learn_align=cfg.learn_align,
    )


def _refuse_unported(cfg):
    """Raise, naming the ROADMAP item, for what the port does not do yet."""
    if cfg.eval:
        raise NotImplementedError(
            "evaluation (FID/IS) is not ported yet: ROADMAP A14; pass --eval False")
    parallel = {"parallel": False, "fsdp": False, "model_axis": 1,
                "pp_stages": 1, "pp_microbatches": 0, "sp_degree": 1}
    changed = [k for k, v in parallel.items() if getattr(cfg, k) != v]
    if changed:
        raise NotImplementedError(
            f"--{' --'.join(changed)}: data, tensor, pipeline and sequence "
            "parallelism are not ported yet: ROADMAP A16")
    if cfg.use_classifier:
        raise NotImplementedError("classifier guidance is not ported yet: ROADMAP A15")


def init(cfg) -> dict:
    """(reference: main.py:319-391)"""
    _refuse_unported(cfg)
    device = select_device()
    generate_logdir(cfg)
    train_loader, _ = load_dataset(
        cfg.data_dir, cfg.dataset, cfg.batch_size, cfg.image_size,
        num_workers=cfg.num_workers, seed=cfg.seed,
        num_classes=cfg.num_classes if cfg.class_cond else 0,
        channels=cfg.in_chans)
    diffusion = build_diffusion(cfg)
    torch.manual_seed(cfg.seed)  # the model's initial weights
    model = build_model(cfg, device=device)
    trainer = Trainer(cfg, model, diffusion)
    # The JAX CLI's shape-init batch (vaw_tpu/cli/main.py:229): drawing it
    # starts the loader's first epoch, so both CLIs train from the second.
    next(iter(train_loader))
    state = trainer.init_state()
    if cfg.resume:
        state = load_train_state(cfg.resume, state)
        print(f"==> Resumed from {cfg.resume} at step {state.step}")

    sampler = sample_model = None
    if cfg.sample_freq > 0:
        if cfg.in_chans == 4:
            print("[vae] decoder unavailable (the SD-VAE decode is not ported "
                  "yet: ROADMAP A9); samples stay in latent space")
        # One copy of the model in the compute dtype (a head the JAX model
        # keeps in f32 stays f32), given the EMA weights at each sampling
        # event.
        sample_model = cast_for_compute(copy.deepcopy(model), cfg.compute_dtype).eval()
        sample_model.requires_grad_(False)
        sampler = Sampler(cfg, sample_model, diffusion=diffusion, device=device)
    return {"device": device, "trainer": trainer, "state": state,
            "train_loader": train_loader, "sampler": sampler,
            "sample_model": sample_model}


def generate_samples(cfg, step: int, ctx) -> np.ndarray:
    """A grid of 64 samples from the EMA weights
    (reference: tools/utils.py:123-165), saved as {logdir}/sample/{step}.png."""
    model, state = ctx["sample_model"], ctx["state"]
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.copy_(state.ema[name])
    generator = torch.Generator(device=ctx["device"]).manual_seed(cfg.seed + step)
    samples, _ = ctx["sampler"].sample(generator, 64, min(cfg.sample_size, 64),
                                       cfg.image_size, cfg.num_classes)
    print(f"[sample] grid saved: {save_grid_png(cfg.logdir, step, samples)}")
    return samples


def train(cfg, ctx):
    """The step loop (reference: main.py:278-316; vaw_tpu/cli/main.py:429-598)."""
    from tqdm import trange

    trainer, state, device = ctx["trainer"], ctx["state"], ctx["device"]
    print(f"Model params: {sum(p.numel() for p in state.params.values()) / 1e6:.2f} M")
    print(f"Total batch size (per update step): "
          f"{cfg.batch_size * cfg.grad_accumulation}")
    start_step = state.step
    micro = cfg.batch_size * max(1, cfg.grad_accumulation)
    loader = ctx["train_loader"]
    if start_step:
        # Resume determinism: replay the loader to where the interrupted
        # run left off, before the prefetcher reads ahead of it; exact only
        # when every loader batch is full.
        consumed = start_step * micro
        if consumed % loader.batch_size == 0 and loader.drop_last:
            loader.fast_forward(consumed // loader.batch_size)
        else:
            print("[resume] step*batch not divisible by the loader batch; the "
                  "loader restarts at epoch 0")
    data_iter = prefetch_to_device(_rebatched(loader, micro), device)
    kvlogger.configure(cfg.logdir, formats=cfg.log_formats.split(","))
    last_dump_t, last_dump_step = None, start_step
    # The writer's pinned snapshot buffers are allocated here, before the
    # step loop, not in its first save.
    async_writer = AsyncCheckpointWriter(state) if cfg.async_checkpoint else None

    # SIGTERM/SIGINT set a flag; the loop checkpoints at the next step
    # boundary and exits, so a preempted run resumes from its last step.
    preempted = {"signum": None}

    def _request_stop(signum, frame):
        preempted["signum"] = signum

    prev_handlers = {s: signal.signal(s, _request_stop)
                     for s in (signal.SIGTERM, signal.SIGINT)}
    try:
        with trange(start_step, cfg.total_steps, initial=start_step,
                    total=cfg.total_steps, dynamic_ncols=True) as pbar:
            for step in range(start_step + 1, cfg.total_steps + 1):
                # wait_data: the seconds the loop waited on the prefetcher
                # since the last record.
                with kvlogger.profile_kv("data"):
                    batch = next(data_iter)
                state, metrics = trainer.step(state, batch)
                if step % 50 == 0 or step == cfg.total_steps:
                    # float() reads the loss back, closing the queue of
                    # device work: the rate below is an honest one.
                    mse = float(metrics.get("mse", metrics["loss"]))
                    pbar.set_postfix(mse=f"{mse:.4f}")
                    kvlogger.logkv("step", step)
                    kvlogger.logkv("loss", float(metrics["loss"]))
                    kvlogger.logkv("mse", mse)
                    if "vb" in metrics:
                        kvlogger.logkv("vb", float(metrics["vb"]))
                    if "grad_norm" in metrics:
                        kvlogger.logkv("grad_norm", float(metrics["grad_norm"]))
                    now = time.perf_counter()
                    if last_dump_t is not None:
                        kvlogger.logkv("imgs_per_sec", (step - last_dump_step)
                                       * micro / (now - last_dump_t))
                    last_dump_t, last_dump_step = now, step
                    kvlogger.dumpkvs()
                pbar.update(1)
                if cfg.sample_freq > 0 and step % cfg.sample_freq == 0:
                    generate_samples(cfg, step, ctx)
                if cfg.save_step > 0 and step % cfg.save_step == 0:
                    if async_writer is not None:
                        print(f"Checkpoint saving (async): "
                              f"{async_writer.save(cfg, step, state)}")
                    else:
                        print(f"Checkpoint saved: {save_checkpoint(cfg, step, state)}")
                if preempted["signum"] is not None:
                    if async_writer is not None:
                        # A write of this very step may be in flight to the
                        # same file: finish it before the synchronous save.
                        async_writer.wait()
                    path = save_checkpoint(cfg, step, state)
                    print(f"[preempt] signal {preempted['signum']}: checkpoint "
                          f"saved at step {step}: {path}; resume with --resume")
                    break
    finally:
        for s, h in prev_handlers.items():
            signal.signal(s, h if h is not None else signal.SIG_DFL)
        kvlogger.get_current().close()
        data_iter.close()  # stops the prefetch worker
    if async_writer is not None:
        async_writer.wait()
        async_writer.close()
    return state


def _rebatched(loader, batch_size):
    """Regroup loader batches to the micro*accum batch size."""
    if loader.batch_size == batch_size:
        yield from loader.forever()
        return
    buf = None
    for batch in loader.forever():
        buf = batch if buf is None else {
            k: np.concatenate([buf[k], batch[k]]) for k in batch}
        while len(next(iter(buf.values()))) >= batch_size:
            yield {k: v[:batch_size] for k, v in buf.items()}
            buf = {k: v[batch_size:] for k, v in buf.items()}


def main(argv=None):
    cfg = parse_args(argv)
    ctx = init(cfg)
    if cfg.train:
        train(cfg, ctx)
    return ctx


if __name__ == "__main__":
    main()
