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
training reads from the second epoch on in both; under --learn_align that
batch must carry features or pixels when no teacher loads. Latent sample
grids are decoded by the SD-VAE where its checkpoint is on the machine
(``VAW_VAE_PATH``), in the compute dtype.

Under --eval True every --eval_step steps (and once, at the checkpoint's
step, under --train False) the EMA weights sample --num_samples images,
written to the run's generate_sample/ npz, and the evaluator (evals/: the
frozen InceptionV3 graph of ``VAW_INCEPTION_PB`` on the same device) adds
IS, FID, sFID, precision and recall against --ref_batch as a row of
metrics.csv. With the default --ref_batch, a missing file or graph turns
evaluation off with a message; a --ref_batch given on the command line
must work. A latent run under --eval True needs the VAE decoder.
--use_classifier adds classifier guidance to the DDIM sampling path.

On more than one GPU: ``torchrun --nproc_per_node N -m vaw_torch.cli.main
...``, one process per card over NCCL (gloo under ``VAW_PLATFORM=cpu``).
The mesh and the apply function are built as the JAX CLI builds them
(vaw_tpu/cli/main.py:137-225, with its errors): ("data", "model") from
--data_axis/--model_axis with --fsdp, ("data", "stage") under --pp_stages
(the DiT family with --scan_blocks; --pp_microbatches, default the stage
count), ("data", "sp") under --sp_degree (the DiT family). A parallel flag
in a single process makes a one-process group. Each data row reads its
shard of the dataset at batch_size / data ranks, and ranks of one row
read the same shard; I/O (logs, grids, metrics, the checkpoint's write)
runs on rank 0. Sampling events run on every rank: each samples
ceil(n / P) with its rank folded into the seed, gathered in rank order,
where every rank holds the whole EMA (data and sequence parallelism);
otherwise every rank samples the same batch from the gathered EMA.
--parallel is accepted and changes nothing, as in the JAX CLI.
"""

from __future__ import annotations

import argparse
import copy
import os
import signal
import time

import numpy as np
import torch
import torch.distributed as dist

from ..core import (
    FlowMatching,
    GaussianDiffusion,
    LossType,
    ModelMeanType,
    ModelVarType,
    get_named_beta_schedule,
    make_schedule,
    respace_schedule,
    space_timesteps,
)
from ..data import load_dataset, prefetch_to_device
from ..encoders import initialize_encoders
from ..models import build_model, cast_for_compute
from ..parallel.distributed import (
    cleanup_distributed,
    is_main_process,
    process_allgather,
    rank,
    setup_distributed,
    world_size,
)
from ..parallel.mesh import data_index, make_mesh, make_pp_mesh, make_sp_mesh
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
    save_eval_npz,
    save_grid_png,
    save_metrics_to_csv,
)
from .sample import load_decoder, select_device

__all__ = ["parse_args", "build_diffusion", "build_mesh", "build_apply_fn", "init",
           "train", "evaluate", "main"]


def parse_args(argv=None):
    parser = argparse.ArgumentParser(
        description="Train diffusion models (PyTorch, CUDA)")
    add_train_args(parser)
    return config_from_args(parser.parse_args(argv))


def build_diffusion(cfg, use_ddim: bool = False):
    """(reference: main.py:224-256; vaw_tpu/cli/main.py:68-99) A
    GaussianDiffusion, or a FlowMatching under --model_mode flow. With
    `use_ddim` the Gaussian process is respaced to --sample_steps (the
    DDIM sampler's) where that is fewer than --diffusion_steps."""
    if cfg.model_mode == "flow":
        return FlowMatching(
            model_mean_type=ModelMeanType[cfg.mean_type.upper()],
            path_type=cfg.path_type, sampler_type=cfg.sampler_type,
            weight_type=cfg.weight_type, p2_k=cfg.p2_k, p2_gamma=cfg.p2_gamma,
            gamma=cfg.gamma, learn_align=cfg.learn_align,
            align_type=cfg.align_type, time_dist=tuple(cfg.time_dist))
    if cfg.model_mode != "diffusion":
        raise ValueError(f"Unsupported model_mode: {cfg.model_mode}")
    schedule = make_schedule(get_named_beta_schedule(cfg.path_type, cfg.diffusion_steps))
    if use_ddim and cfg.sample_steps < cfg.diffusion_steps:
        schedule = respace_schedule(
            schedule, space_timesteps(cfg.diffusion_steps, f"ddim{cfg.sample_steps}"))
    return GaussianDiffusion(
        schedule=schedule,
        model_mean_type=ModelMeanType[cfg.mean_type.upper()],
        model_var_type=ModelVarType[cfg.var_type.upper()],
        loss_type=LossType[cfg.loss_type.upper()],
        weight_type=cfg.weight_type, p2_k=cfg.p2_k, p2_gamma=cfg.p2_gamma,
        gamma=cfg.gamma, learn_align=cfg.learn_align, align_type=cfg.align_type,
    )


def uses_mesh(cfg) -> bool:
    """Whether the run lays the model out on a mesh: under the launcher, or
    with any parallel flag."""
    return (dist.is_initialized() or cfg.fsdp or cfg.model_axis != 1
            or cfg.data_axis != -1 or cfg.pp_stages > 1 or cfg.sp_degree > 1)


def build_mesh(cfg):
    """The run's mesh, with the JAX CLI's errors (vaw_tpu/cli/main.py:
    137-171): ("data", "stage") under --pp_stages, ("data", "sp") under
    --sp_degree, ("data", "model") otherwise."""
    if cfg.pp_stages > 1:
        if cfg.model_axis != 1:
            raise ValueError("--pp_stages composes with dp, not tp")
        if cfg.sp_degree != 1:
            raise ValueError("--pp_stages and --sp_degree are exclusive")
        if not cfg.scan_blocks:
            raise ValueError("--pp_stages requires --scan_blocks")
        if not cfg.model.startswith("DiT"):
            raise ValueError("--pp_stages supports the DiT family (scan-blocks layout)")
        return make_pp_mesh(cfg.pp_stages)
    if cfg.sp_degree > 1:
        if cfg.model_axis != 1:
            raise ValueError("--sp_degree composes with dp, not tp")
        if cfg.fsdp:
            raise ValueError("--sp_degree does not compose with --fsdp")
        if not cfg.model.startswith("DiT"):
            raise ValueError("--sp_degree supports the DiT family")
        return make_sp_mesh(cfg.sp_degree)
    return make_mesh(data_axis=cfg.data_axis, model_axis=cfg.model_axis)


def build_apply_fn(cfg, model, mesh):
    """The pipelined or sequence-parallel forward (vaw_tpu/cli/main.py:
    210-223); None for the model's own."""
    names = mesh.mesh_dim_names if mesh is not None else ()
    if "stage" in names:
        from ..parallel import pipelined_dit_apply

        return pipelined_dit_apply(model, mesh, cfg.pp_microbatches or cfg.pp_stages,
                                   batch_axis="data")
    if "sp" in names:
        from ..parallel import sequence_parallel_dit_apply

        return sequence_parallel_dit_apply(model, mesh, batch_axis="data")
    return None


def _share_logdir(cfg):
    """Rank 0 makes the run directory; every rank takes its name."""
    if is_main_process():
        generate_logdir(cfg)
    if world_size() > 1:
        name = [cfg.logdir]
        dist.broadcast_object_list(name, src=0)
        cfg.logdir = name[0]


def _build_evaluator(cfg, device):
    """The metrics stack and the reference batch's activations and
    statistics, or Nones (reference: main.py:370-384;
    vaw_tpu/cli/main.py:102-134). With the default --ref_batch a missing
    file or graph turns evaluation off with a message (a machine with no
    network can still train); a --ref_batch given on the command line is a
    promise, and any failure then raises."""
    from ..evals import Evaluator
    from ..utils.config import TrainConfig

    explicit = cfg.ref_batch != TrainConfig.ref_batch
    try:
        if not os.path.exists(cfg.ref_batch):
            raise FileNotFoundError(f"--ref_batch {cfg.ref_batch} does not exist")
        evaluator = Evaluator(device=device)
        ref_acts = evaluator.read_activations(cfg.ref_batch)
        ref_stats, ref_stats_spatial = evaluator.read_statistics(cfg.ref_batch, ref_acts)
        return evaluator, ref_acts, ref_stats, ref_stats_spatial
    except Exception as e:  # noqa: BLE001 - classified just below
        if explicit:
            raise RuntimeError(
                f"--ref_batch {cfg.ref_batch!r} was given but the evaluator failed to "
                f"build: {e}. Fix the path/graph or drop the flag.") from e
        print(f"[eval] evaluator unavailable ({e}); FID eval disabled")
        return None, None, None, None


def init(cfg) -> dict:
    """(reference: main.py:319-391)"""
    device = select_device()
    mesh = build_mesh(cfg) if uses_mesh(cfg) else None
    _share_logdir(cfg)
    # Each data row reads its shard at its share of the batch; the ranks
    # of one row (model, stage or sp) read the same one
    # (vaw_tpu/cli/main.py:176-190).
    data_rank, data_ranks = data_index(mesh)
    if cfg.batch_size % data_ranks:
        raise ValueError(f"batch_size {cfg.batch_size} not divisible by "
                         f"{data_ranks} data ranks")
    train_loader, _ = load_dataset(
        cfg.data_dir, cfg.dataset, cfg.batch_size // data_ranks, cfg.image_size,
        num_workers=cfg.num_workers, seed=cfg.seed,
        num_classes=cfg.num_classes if cfg.class_cond else 0,
        channels=cfg.in_chans, num_shards=data_ranks, shard_index=data_rank)
    diffusion = build_diffusion(cfg)
    torch.manual_seed(cfg.seed)  # the model's initial weights, the same on every rank
    model = build_model(cfg, device=device)
    # The sampler's copy is made before the model is laid out on the mesh.
    sample_model = None
    if cfg.sample_freq > 0 or cfg.eval:
        sample_model = cast_for_compute(copy.deepcopy(model), cfg.compute_dtype).eval()
        sample_model.requires_grad_(False)
    encoder_fn = align_load_error = None
    if cfg.learn_align:
        try:
            encoder_fn, _ = initialize_encoders(cfg.enc_type, cfg.image_size,
                                                device=device)
        except Exception as e:  # noqa: BLE001 - checked against the first
            # batch below: the dataset may carry features or pixels instead
            align_load_error = e
            print(f"[align] teacher encoder unavailable ({e}); "
                  "checking the dataset for precomputed features")
    trainer = Trainer(cfg, model, diffusion, encoder_fn=encoder_fn, mesh=mesh,
                      apply_fn=build_apply_fn(cfg, model, mesh))
    # The JAX CLI's shape-init batch (vaw_tpu/cli/main.py:229): drawing it
    # starts the loader's first epoch, so both CLIs train from the second.
    sample_batch = next(iter(train_loader))
    if (cfg.learn_align and encoder_fn is None and "features" not in sample_batch
            and "pixels" not in sample_batch):
        # Without a teacher or stored features the align loss the user
        # asked for could not be computed.
        raise RuntimeError(
            f"--learn_align requires teacher weights for {cfg.enc_type!r} "
            f"(load failed: {align_load_error}) or a dataset with "
            "precomputed features/pixels (Latent_Pixel).")
    state = trainer.init_state()
    if cfg.resume:
        state = load_train_state(cfg.resume, state, trainer if mesh is not None else None)
        if is_main_process():
            print(f"==> Resumed from {cfg.resume} at step {state.step}")

    classifier_fn = None
    if cfg.use_classifier:
        # Checked at start, not at the first sampling event, which may come
        # after hours of training (vaw_tpu/cli/main.py:270-297).
        if not (cfg.model_mode == "diffusion" and cfg.solver == "ddim"):
            raise ValueError(
                "--use_classifier requires --model_mode diffusion --solver ddim (got "
                f"model_mode={cfg.model_mode!r}, solver={cfg.solver!r})")
        from ..samplers.classifier import build_classifier

        classifier_fn, _ = build_classifier(cfg, device=device)
        print(f"==> Classifier guidance from {cfg.use_classifier}")

    sampler = None
    if sample_model is not None:
        vae_decode_fn = None
        if cfg.in_chans == 4:
            vae_decode_fn = load_decoder(cfg, device, "; samples stay in latent space")
            if vae_decode_fn is None and cfg.eval:
                # FID over undecoded latents is meaningless: fail before
                # the training run (vaw_tpu/cli/main.py:246-267).
                raise RuntimeError(
                    f"latent training with --eval True needs the VAE decoder "
                    f"(sd-vae-ft-{cfg.vae}), which failed to load. Provide the weights "
                    "(VAW_VAE_PATH) or pass --eval False.")
        # The sampler's copy of the model, in the compute dtype (a head the
        # JAX model keeps in f32 stays f32), is given the EMA weights at
        # each sampling event.
        sample_diffusion = (build_diffusion(cfg, use_ddim=True)
                            if cfg.model_mode == "diffusion" and cfg.solver == "ddim"
                            else diffusion)
        sampler = Sampler(cfg, sample_model, diffusion=sample_diffusion,
                          vae_decode_fn=vae_decode_fn, classifier_fn=classifier_fn,
                          device=device)
    # The metrics stack lives on rank 0 (reference: main.py:370-384).
    evaluator, ref_acts, ref_stats, ref_stats_spatial = (
        _build_evaluator(cfg, device) if cfg.eval and is_main_process() else (None,) * 4)
    return {"device": device, "mesh": mesh, "trainer": trainer, "state": state,
            "train_loader": train_loader, "sampler": sampler,
            "sample_model": sample_model, "evaluator": evaluator, "ref_acts": ref_acts,
            "ref_stats": ref_stats, "ref_stats_spatial": ref_stats_spatial}


def generate_samples(cfg, step: int, ctx, save_grid: bool = True) -> np.ndarray:
    """Samples from the EMA weights (reference: tools/utils.py:123-165): a
    grid of 64 saved as {logdir}/sample/{step}.png, or --num_samples of
    them saved to the run's generate_sample/ npz for evaluation. Every rank
    calls it (vaw_tpu/cli/main.py:336-380): where each holds the whole
    EMA, each samples ceil(n / P) with its rank folded into the seed and
    the samples are gathered in rank order; otherwise the EMA is gathered
    and every rank samples the same batch. Rank 0 writes."""
    model, state, trainer = ctx["sample_model"], ctx["state"], ctx["trainer"]
    mesh = ctx.get("mesh")
    ema = state.ema if mesh is None else trainer.full(state.ema)
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.copy_(ema[name])
    del ema
    n = 64 if save_grid else cfg.num_samples
    procs = world_size()
    replicated = procs > 1 and not trainer.holds_subset and trainer.tp == 1 and not cfg.fsdp
    n_local = -(-n // procs) if replicated else n
    seed = cfg.seed + step
    if replicated:
        seed = seed * 1_000_003 + rank()
    generator = torch.Generator(device=ctx["device"]).manual_seed(seed)
    samples, labels = ctx["sampler"].sample(generator, n_local, min(cfg.sample_size, n_local),
                                            cfg.image_size, cfg.num_classes,
                                            progress_bar=not save_grid and is_main_process())
    if replicated:
        samples = np.concatenate(list(process_allgather(samples)))[:n]
        if labels is not None:
            labels = np.concatenate(list(process_allgather(labels)))[:n]
    if is_main_process():
        if save_grid:
            print(f"[sample] grid saved: {save_grid_png(cfg.logdir, step, samples)}")
        else:
            save_eval_npz(cfg.logdir, cfg.dataset, samples, labels)
    return samples


def evaluate(cfg, step: int, ctx):
    """--num_samples EMA samples, then IS, FID, sFID, precision and recall
    against the reference batch, printed and appended to metrics.csv
    (reference: main.py:258-275, tools/utils.py:168-188;
    vaw_tpu/cli/main.py:384-427). Sampling runs on every rank, the metrics
    on rank 0, whose decision to evaluate every rank follows."""
    evaluator = ctx["evaluator"]
    run_eval = [evaluator is not None]
    if world_size() > 1:
        dist.broadcast_object_list(run_eval, src=0)
    if not run_eval[0]:
        print("[eval] skipped (no evaluator)")
        return None
    arr = generate_samples(cfg, step, ctx, save_grid=False)
    if not is_main_process():
        return None
    batches = [arr[i: i + cfg.sample_size] for i in range(0, len(arr), cfg.sample_size)]
    sample_acts = evaluator.compute_activations(batches)
    sample_stats, sample_stats_spatial = (evaluator.compute_statistics(x)
                                          for x in sample_acts)
    is_score = evaluator.compute_inception_score(sample_acts[0])
    fid = sample_stats.frechet_distance(ctx["ref_stats"])
    sfid = sample_stats_spatial.frechet_distance(ctx["ref_stats_spatial"])
    pre, rec = evaluator.compute_prec_recall(ctx["ref_acts"][0], sample_acts[0])
    print(f"Model(EMA): IS:{is_score:.2f}, FID:{fid:.2f}, sFID:{sfid:.2f}, "
          f"Pre:{pre:.2f}, Rec:{rec:.2f}")
    metrics = {"IS (EMA)": is_score, "FID (EMA)": fid, "sFID (EMA)": sfid,
               "Pre. (EMA)": pre, "Rec. (EMA)": rec}
    save_metrics_to_csv(cfg.logdir, metrics, step)
    return metrics


def train(cfg, ctx):
    """The step loop (reference: main.py:278-316; vaw_tpu/cli/main.py:429-598).
    Every rank runs it on its rows; rank 0 logs and writes."""
    from tqdm import trange

    trainer, state, device = ctx["trainer"], ctx["state"], ctx["device"]
    main_proc = is_main_process()
    if main_proc:
        # numel() of a sharded (or another stage's) parameter is the whole one's
        n_params = sum(p.numel() for p in trainer.model.parameters())
        print(f"Model params: {n_params / 1e6:.2f} M")
        print(f"Total batch size (per update step): "
              f"{cfg.batch_size * cfg.grad_accumulation}")
    start_step = state.step
    # This rank's rows of the global micro*accum batch.
    micro = (cfg.batch_size // trainer.data_size) * max(1, cfg.grad_accumulation)
    loader = ctx["train_loader"]
    if start_step:
        # Resume determinism: replay the loader to where the interrupted
        # run left off, before the prefetcher reads ahead of it; exact only
        # when every loader batch is full.
        consumed = start_step * micro
        if consumed % loader.batch_size == 0 and loader.drop_last:
            loader.fast_forward(consumed // loader.batch_size)
        elif main_proc:
            print("[resume] step*batch not divisible by the loader batch; the "
                  "loader restarts at epoch 0")
    data_iter = prefetch_to_device(_rebatched(loader, micro), device)
    kvlogger.configure(cfg.logdir, formats=cfg.log_formats.split(",") if main_proc else ())
    last_dump_t, last_dump_step = None, start_step
    # The writer's pinned snapshot buffers are allocated here, before the
    # step loop, not in its first save.
    async_writer = AsyncCheckpointWriter(state) if cfg.async_checkpoint else None
    layout = trainer if ctx.get("mesh") is not None else None

    # SIGTERM/SIGINT set a flag; the loop checkpoints at the next step
    # boundary and exits, so a preempted run resumes from its last step.
    # Across processes the ranks agree on the step (a max over the flags).
    preempted = {"signum": None}

    def _request_stop(signum, frame):
        preempted["signum"] = signum

    def stop_now() -> bool:
        if world_size() == 1:
            return preempted["signum"] is not None
        flag = torch.tensor([0 if preempted["signum"] is None else preempted["signum"]],
                            device=device)
        dist.all_reduce(flag, op=dist.ReduceOp.MAX)
        if flag.item() and preempted["signum"] is None:
            preempted["signum"] = int(flag.item())
        return bool(flag.item())

    prev_handlers = {s: signal.signal(s, _request_stop)
                     for s in (signal.SIGTERM, signal.SIGINT)}
    try:
        with trange(start_step, cfg.total_steps, initial=start_step,
                    total=cfg.total_steps, dynamic_ncols=True,
                    disable=not main_proc) as pbar:
            for step in range(start_step + 1, cfg.total_steps + 1):
                # wait_data: the seconds the loop waited on the prefetcher
                # since the last record.
                with kvlogger.profile_kv("data"):
                    batch = next(data_iter)
                state, metrics = trainer.step(state, batch)
                ctx["state"] = state  # the EMA weights that sampling events read
                if main_proc and (step % 50 == 0 or step == cfg.total_steps):
                    # float() reads the loss back, closing the queue of
                    # device work: the rate below is an honest one.
                    mse = float(metrics.get("mse", metrics["loss"]))
                    pbar.set_postfix(mse=f"{mse:.4f}")
                    kvlogger.logkv("step", step)
                    kvlogger.logkv("loss", float(metrics["loss"]))
                    kvlogger.logkv("mse", mse)
                    for name in ("vb", "align"):
                        if name in metrics:
                            kvlogger.logkv(name, float(metrics[name]))
                    if "grad_norm" in metrics:
                        kvlogger.logkv("grad_norm", float(metrics["grad_norm"]))
                    now = time.perf_counter()
                    if last_dump_t is not None:
                        kvlogger.logkv("imgs_per_sec", (step - last_dump_step)
                                       * micro * trainer.data_size / (now - last_dump_t))
                    last_dump_t, last_dump_step = now, step
                    kvlogger.dumpkvs()
                pbar.update(1)
                if cfg.sample_freq > 0 and step % cfg.sample_freq == 0:
                    generate_samples(cfg, step, ctx, save_grid=True)
                if cfg.save_step > 0 and step % cfg.save_step == 0:
                    if async_writer is not None:
                        path = async_writer.save(cfg, step, state, trainer=layout)
                        if main_proc:
                            print(f"Checkpoint saving (async): {path}")
                    else:
                        path = save_checkpoint(cfg, step, state, trainer=layout)
                        if main_proc:
                            print(f"Checkpoint saved: {path}")
                if cfg.eval and cfg.eval_step > 0 and step % cfg.eval_step == 0:
                    evaluate(cfg, step, ctx)
                if stop_now():
                    if async_writer is not None:
                        # A write of this very step may be in flight to the
                        # same file: finish it before the synchronous save.
                        async_writer.wait()
                    path = save_checkpoint(cfg, step, state, trainer=layout)
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
    # The launcher's process group first (vaw_tpu/cli/main.py:618-623); a
    # no-op in a single process.
    joined_before = dist.is_initialized()
    setup_distributed()
    cfg = parse_args(argv)
    try:
        if cfg.eval and not cfg.train and not cfg.resume:
            raise ValueError("Evaluation requires a checkpoint path provided with --resume")
        if uses_mesh(cfg) and not dist.is_initialized():
            setup_distributed(world_size=1)
        ctx = init(cfg)
        if cfg.train:
            ctx["state"] = train(cfg, ctx)
        elif cfg.eval:
            evaluate(cfg, ctx["state"].step, ctx)
    finally:
        if not joined_before:
            cleanup_distributed()
    return ctx


if __name__ == "__main__":
    main()
