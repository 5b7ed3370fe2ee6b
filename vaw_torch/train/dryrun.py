"""Multi-rank dry run: the full train step on n gloo CPU ranks
(counterpart of vaw_tpu/train/dryrun.py).

    python -m vaw_torch.train.dryrun --n_devices 8

``dryrun_multichip(n)`` starts n processes, one rank each, that meet on a
FileStore in a temporary directory, run on the CPU under gloo and never
touch a card (CUDA_VISIBLE_DEVICES is emptied, as the JAX dry run pins the
CPU backend, vaw_tpu/train/dryrun.py:81-84). On DiT-S geometry (hidden
384, depth 12, 6 heads) over 8x8x4 latents with grad_accumulation=2 the
core legs run one step each on a ("data", "model") mesh, model axis 2
where n is even: dp+tp and dp+tp+fsdp, each with its collective census
(a dispatch mode's count of the c10d collectives, and a count of the
point-to-point sends, standing in for the HLO census) and its loss held
to the one-rank step on the global batch. Then a tiny scanned DiT's
plain-dp step is the baseline of the pp leg (GPipe over a ("data",
"stage") mesh) and the sp leg (ring attention over ("data", "sp")), each
held to it in loss and parameters. Every leg prints ``[leg] <name>
start`` and ``[leg] <name> done <s>s``, partial results as they come, and
the optional pp/sp legs are skipped once the run is past
``VAW_DRYRUN_BUDGET_S`` (default 420 s).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import subprocess
import sys
import tempfile
import time
from dataclasses import replace

import numpy as np
import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode

__all__ = ["dryrun_multichip"]

_COLLECTIVES = ("all-reduce", "reduce-scatter", "all-gather", "collective-permute",
                "broadcast")
# Dispatched c10d op names, by the JAX census' names.
_OPS = {"all-reduce": ("allreduce", "all_reduce"),
        "reduce-scatter": ("reduce_scatter",),
        "all-gather": ("allgather", "all_gather"),
        "broadcast": ("broadcast",)}


class _Clock:
    def __init__(self):
        self.t0 = time.monotonic()

    def elapsed(self) -> float:
        return time.monotonic() - self.t0


def _say(*args):
    if dist.get_rank() == 0:
        print(*args, flush=True)


@contextlib.contextmanager
def _leg(clock: _Clock, name: str):
    """Per-leg telemetry: a run killed mid-leg leaves `start` without
    `done`, naming the culprit."""
    _say(f"[leg] {name} start t+{clock.elapsed():.0f}s")
    t = time.monotonic()
    yield
    _say(f"[leg] {name} done {time.monotonic() - t:.0f}s")


class _CountCollectives(TorchDispatchMode):
    """Counts the c10d ops dispatched inside (torch.distributed's, FSDP's
    and DTensor's functional collectives) by the JAX census' names."""

    def __init__(self, counts: dict):
        super().__init__()
        self.counts = counts

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if "c10d" in func.namespace:
            name = func.__name__
            for key, words in _OPS.items():
                if any(w in name for w in words):
                    self.counts[key] += 1
        return func(*args, **(kwargs or {}))


@contextlib.contextmanager
def _census(counts: dict):
    """Count the collectives run inside: the dispatched c10d ops, and the
    sends of the point-to-point transfers (the ring's and the pipeline's,
    all through batch_isend_irecv) as collective-permutes."""
    original = dist.batch_isend_irecv

    def counting(ops):
        counts["collective-permute"] += sum(op.op is dist.isend for op in ops)
        return original(ops)

    dist.batch_isend_irecv = counting
    try:
        with _CountCollectives(counts):
            yield
    finally:
        dist.batch_isend_irecv = original


def _new_counts() -> dict:
    return dict.fromkeys(_COLLECTIVES, 0)


def _process():
    from ..core.diffusion import GaussianDiffusion
    from ..core.schedules import get_named_beta_schedule, make_schedule
    from ..core.types import LossType, ModelMeanType, ModelVarType

    return GaussianDiffusion(
        schedule=make_schedule(get_named_beta_schedule("linear", 50)),
        model_mean_type=ModelMeanType.EPSILON, model_var_type=ModelVarType.FIXED_LARGE,
        loss_type=LossType.MSE, weight_type="lambda")


def _dit(**kwargs):
    from ..models.dit import DiT

    torch.manual_seed(0)  # the same initial weights on every rank
    return DiT(**kwargs)


def _step(cfg, model, process, batch, mesh=None, apply_fn=None, counts=None):
    """One train step of a fresh state; -> (loss, trainer, state)."""
    from ..parallel.mesh import shard_batch
    from .trainer import Trainer

    trainer = Trainer(cfg, model, process, mesh=mesh, apply_fn=apply_fn)
    state = trainer.init_state()
    local = shard_batch(mesh, batch) if mesh is not None else batch
    with _census(counts) if counts is not None else contextlib.nullcontext():
        state, metrics = trainer.step(state, local)
    loss = float(metrics["loss"])
    assert math.isfinite(loss) and state.step == 1, (loss, state.step)
    return loss, trainer, state


def _batch(rows: int, seed: int) -> dict:
    rs = np.random.RandomState(seed)
    return {"image": torch.from_numpy(rs.randn(rows, 8, 8, 4).astype(np.float32)),
            "label": torch.arange(rows) % 10}


def _assert_matches(label, loss, params, plain_loss, plain_params):
    assert abs(loss - plain_loss) <= 1e-4, (label, loss, plain_loss)
    for k, v in plain_params.items():
        np.testing.assert_allclose(params[k].detach().cpu().numpy(),
                                   v.detach().cpu().numpy(), atol=1e-4, rtol=1e-4,
                                   err_msg=f"{label} {k}")


def _worker(n: int, budget: float):
    """One rank's legs; rank 0 prints."""
    from ..parallel.dit_pipeline import pipelined_dit_apply
    from ..parallel.mesh import make_mesh, make_pp_mesh, make_sp_mesh
    from ..parallel.sp_dit import sequence_parallel_dit_apply
    from ..utils.config import TrainConfig

    clock = _Clock()
    model_axis = 2 if n % 2 == 0 else 1
    dp_core = n // model_axis
    mesh = make_mesh(data_axis=dp_core, model_axis=model_axis)
    # The smallest multiple of the data axis that is >= 8 rows a micro-batch.
    core_bs = dp_core * max(1, -(-8 // dp_core))
    cfg = TrainConfig(model="DiT-S", image_size=8, in_chans=4, patch_size=2,
                      num_classes=10, class_cond=True, batch_size=core_bs,
                      weight_type="lambda", mean_type="EPSILON", drop_label_prob=0.1,
                      grad_accumulation=2, amp=False, model_axis=model_axis)
    geometry = dict(image_size=8, patch_size=2, in_channels=4, hidden_size=384, depth=12,
                    num_heads=6, num_classes=10, class_dropout_prob=0.1)
    process = _process()
    batch = _batch(core_bs * cfg.grad_accumulation, seed=0)
    losses, census = {}, {}
    with _leg(clock, "plain-core"):
        plain_core, _, _ = _step(replace(cfg, model_axis=1), _dit(**geometry), process, batch)
    for label, fsdp in (("dp+tp", False), ("dp+tp+fsdp", True)):
        with _leg(clock, label):
            census[label] = _new_counts()
            losses[label], _, _ = _step(replace(cfg, fsdp=fsdp), _dit(**geometry), process,
                                        batch, mesh=mesh, counts=census[label])
            if n > 1:  # dp grad mean / tp rows
                assert census[label]["all-reduce"] > 0, (label, census[label])
            if fsdp and dp_core > 1:
                # FSDP gathers the sharded params and scatters the grads.
                assert census[label]["all-gather"] > 0, (label, census[label])
                assert census[label]["reduce-scatter"] > 0, (label, census[label])
            assert abs(losses[label] - plain_core) <= 1e-5 * abs(plain_core), (
                label, losses[label], plain_core)
        _say(f"[partial] {label}: loss={losses[label]:.6f} (one rank {plain_core:.6f}) "
             f"census={json.dumps(census[label])}")
    if dp_core > 1:
        assert census["dp+tp+fsdp"]["all-gather"] > census["dp+tp"]["all-gather"], census
    _say(f"[partial] CORE OK: dp+tp/fsdp loss equality {losses['dp+tp']:.6f} "
         f"t+{clock.elapsed():.0f}s")

    skipped = []
    tiny = dict(image_size=8, patch_size=2, in_channels=4, hidden_size=32, depth=4,
                num_heads=2, num_classes=10, class_dropout_prob=0.0)
    sbs = n * max(1, -(-8 // n))
    shared_cfg = replace(cfg, batch_size=sbs, grad_accumulation=1, drop_label_prob=0.0,
                         scan_blocks=True, model_axis=1)
    shared_batch = _batch(sbs, seed=3)
    if clock.elapsed() > budget:
        skipped += ["plain-baseline", "pp", "sp"]
        _say(f"[leg] pp/sp SKIPPED: t+{clock.elapsed():.0f}s > budget {budget:.0f}s "
             "(VAW_DRYRUN_BUDGET_S)")
    elif n % 2:
        skipped += ["pp", "sp"]
        _say("[leg] pp/sp SKIPPED: the tiny model's 4 blocks and 4 token rows split "
             "over 2 or 4 ranks of an even count")
    else:
        with _leg(clock, "plain-baseline"):
            plain_loss, _, plain_state = _step(shared_cfg, _dit(**tiny), process, shared_batch)
        _say(f"[partial] plain-baseline: loss={plain_loss:.6f}")
        for leg in ("pp", "sp"):
            if clock.elapsed() > budget:
                skipped.append(leg)
                _say(f"[leg] {leg} SKIPPED: over budget")
                continue
            with _leg(clock, leg):
                model = _dit(**tiny)
                degree = 4 if n % 4 == 0 else 2
                if leg == "pp":
                    stages = degree
                    leg_mesh = make_pp_mesh(stages)
                    apply_fn = pipelined_dit_apply(model, leg_mesh, 2, batch_axis="data")
                    leg_cfg = replace(shared_cfg, pp_stages=stages, pp_microbatches=2)
                else:
                    leg_mesh = make_sp_mesh(degree)
                    apply_fn = sequence_parallel_dit_apply(model, leg_mesh, batch_axis="data")
                    leg_cfg = replace(shared_cfg, sp_degree=degree)
                    # Forward equality on the baseline's post-step params.
                    ref = _dit(**tiny)
                    ref.load_state_dict({k: v.detach() for k, v in plain_state.params.items()},
                                        strict=False)
                    x, t = shared_batch["image"], torch.zeros(sbs)
                    with torch.no_grad():
                        got = sequence_parallel_dit_apply(ref, leg_mesh)(
                            x, t, shared_batch["label"])
                        want = ref(x, t, shared_batch["label"])
                    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-4, rtol=1e-4)
                census[leg] = _new_counts()
                loss, trainer, state = _step(leg_cfg, model, process, shared_batch,
                                             mesh=leg_mesh, apply_fn=apply_fn,
                                             counts=census[leg])
                assert census[leg]["collective-permute"] > 0, (leg, census[leg])
                _assert_matches(leg, loss, trainer.full(state.params), plain_loss,
                                plain_state.params)
                losses[leg] = loss
            _say(f"[partial] {leg}: loss={loss:.6f} == plain census={json.dumps(census[leg])}")
    assert not torch.cuda.is_initialized(), "the dry run touched a card"
    _say("collective census:", json.dumps(census))
    if skipped:
        _say(f"skipped legs (budget {budget:.0f}s): {skipped}")
    _say(f"dryrun_multichip({n}): mesh={{'data': {dp_core}, 'model': {model_axis}}} "
         f"losses={losses} total={clock.elapsed():.0f}s OK")


def dryrun_multichip(n_devices: int, timeout_s: float = 1800) -> None:
    """Run the legs on `n_devices` gloo CPU ranks; raise if a rank fails
    (with its output) or the run outlives `timeout_s`."""
    budget = os.environ.get("VAW_DRYRUN_BUDGET_S", "420")
    with tempfile.TemporaryDirectory(prefix="vaw_dryrun_") as tmp:
        env = dict(os.environ, VAW_PLATFORM="cpu", CUDA_VISIBLE_DEVICES="",
                   OMP_NUM_THREADS="1", VAW_DRYRUN_BUDGET_S=budget)
        root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
        env["PYTHONPATH"] = os.pathsep.join(filter(None, [root, env.get("PYTHONPATH")]))
        logs = [open(os.path.join(tmp, f"rank{r}.log"), "w+") for r in range(n_devices)]
        procs = [subprocess.Popen(
            [sys.executable, "-m", "vaw_torch.train.dryrun", "--worker", str(r),
             "--n_devices", str(n_devices), "--store", os.path.join(tmp, "store")],
            env=env, stdout=logs[r], stderr=subprocess.STDOUT) for r in range(n_devices)]
        deadline = time.monotonic() + timeout_s
        try:
            while any(p.poll() is None for p in procs):
                if time.monotonic() > deadline or any(
                        p.poll() not in (None, 0) for p in procs):
                    break
                time.sleep(0.2)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                p.wait()
        outputs = []
        for log in logs:
            log.seek(0)
            outputs.append(log.read())
            log.close()
        print(outputs[0], end="", flush=True)
        failed = [r for r, p in enumerate(procs) if p.returncode != 0]
        if failed:
            detail = "\n".join(f"--- rank {r} ---\n{outputs[r][-4000:]}" for r in failed)
            raise RuntimeError(f"dryrun_multichip({n_devices}): ranks {failed} failed "
                               f"or timed out\n{detail}")


def main(argv=None):
    parser = argparse.ArgumentParser(description="Multi-rank dry run on gloo CPU ranks")
    parser.add_argument("--n_devices", type=int, default=8)
    parser.add_argument("--worker", type=int, default=None, help=argparse.SUPPRESS)
    parser.add_argument("--store", default=None, help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    if args.worker is None:
        dryrun_multichip(args.n_devices)
        return
    from ..parallel.distributed import cleanup_distributed, setup_distributed

    torch.set_num_threads(1)
    os.environ.update({"RANK": str(args.worker), "WORLD_SIZE": str(args.n_devices),
                       "LOCAL_RANK": str(args.worker)})
    setup_distributed(init_method="file://" + args.store, world_size=args.n_devices,
                      rank=args.worker, timeout_s=600)
    try:
        _worker(args.n_devices, float(os.environ.get("VAW_DRYRUN_BUDGET_S", "420")))
    finally:
        cleanup_distributed()


if __name__ == "__main__":
    main()
