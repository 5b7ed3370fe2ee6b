"""Run a function on N gloo CPU ranks, each a fresh Python process, for the
port's multi-rank tests.

    results = run_ranks("module:function", world, tmp_path, *args)

Each rank imports torch (never JAX), joins a process group that meets on a
FileStore in `tmp_path` (no TCP port, so parallel test workers never race
for one), calls ``module.function(*args)`` and pickles its result; the
parent returns the results in rank order. A rank that raises fails the
call with that rank's traceback; a group that outlives `timeout` is killed
and fails it too. Run as a script it is one rank:

    python _torch_ranks.py <spec.pkl> <rank>
"""

from __future__ import annotations

import os
import pickle
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def run_ranks(target: str, world: int, tmp_path, *args, timeout: float = 150,
              env: dict = None):
    run_dir = os.path.join(str(tmp_path), f"ranks_{time.monotonic_ns()}")
    os.makedirs(run_dir)
    spec = os.path.join(run_dir, "spec.pkl")
    with open(spec, "wb") as f:
        pickle.dump({"target": target, "world": world, "args": args,
                     "store": os.path.join(run_dir, "store")}, f)
    child_env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    child_env.update({"VAW_PLATFORM": "cpu", "OMP_NUM_THREADS": "1",
                      "PYTHONPATH": os.pathsep.join([ROOT, HERE])})
    child_env.update(env or {})
    procs = []
    for r in range(world):
        log = open(os.path.join(run_dir, f"rank{r}.log"), "w")
        procs.append((subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), spec, str(r)],
            cwd=run_dir, env=child_env, stdout=log, stderr=subprocess.STDOUT), log))
    deadline = time.monotonic() + timeout
    try:
        for p, _ in procs:
            p.wait(timeout=max(deadline - time.monotonic(), 0.1))
    except subprocess.TimeoutExpired:
        pass
    finally:
        timed_out = [r for r, (p, _) in enumerate(procs) if p.poll() is None]
        for p, log in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            log.close()

    def logs(ranks):
        return "\n".join(f"--- rank {r} ---\n" + open(
            os.path.join(run_dir, f"rank{r}.log")).read()[-6000:] for r in ranks)

    if timed_out:
        raise AssertionError(f"{target} on {world} ranks: ranks {timed_out} still "
                             f"running after {timeout} s\n{logs(range(world))}")
    failed = [r for r, (p, _) in enumerate(procs) if p.returncode != 0]
    if failed:
        raise AssertionError(f"{target} on {world} ranks: ranks {failed} failed\n"
                             f"{logs(failed)}")
    out = []
    for r in range(world):
        with open(os.path.join(run_dir, f"result{r}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out


def _main(spec_path: str, rank: int):
    import importlib

    import torch

    with open(spec_path, "rb") as f:
        spec = pickle.load(f)
    world = spec["world"]
    os.environ.update({"RANK": str(rank), "WORLD_SIZE": str(world),
                       "LOCAL_RANK": str(rank)})
    torch.set_num_threads(1)
    from vaw_torch.parallel.distributed import cleanup_distributed, setup_distributed

    setup_distributed(init_method="file://" + spec["store"], world_size=world,
                      rank=rank, timeout_s=120)
    module, name = spec["target"].split(":")
    try:
        result = getattr(importlib.import_module(module), name)(*spec["args"])
    finally:
        cleanup_distributed()
    out = os.path.join(os.path.dirname(spec_path), f"result{rank}.pkl")
    with open(out + ".tmp", "wb") as f:
        pickle.dump(result, f)
    os.replace(out + ".tmp", out)


if __name__ == "__main__":
    _main(sys.argv[1], int(sys.argv[2]))
