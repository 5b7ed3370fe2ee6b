"""The port's GPipe pipeline (vaw_torch/parallel/pipeline.py) and the
pipelined DiT (dit_pipeline.py) on gloo CPU ranks: the generic schedule
against the sequential stack, and the pipelined DiT against JAX's
pipelined_dit_apply (a scan-blocks DiT, hidden 32, depth 4, 8x8x4, every
leaf randomised, weights carried by models/convert.py) at 2 and 4 stages
and 1, 2 and 8 micro-batches, output and the gradients of sum(out * g),
and data x pipeline parallelism on 2 x 2 ranks.

Tolerances (f32 on both sides, different summation orders): outputs within
1e-5 absolute and relative; gradients within 1e-5 of the leaf's max|g|
plus 1e-6."""

from __future__ import annotations

import jax
import numpy as np
import pytest
from jax.sharding import Mesh

from _torch_jax_dit import inputs, tiny, value_and_grads
from _torch_ranks import run_ranks
from vaw_tpu.parallel import make_pp_mesh, pipelined_dit_apply


def _close_grads(got, want):
    assert set(got) == set(want)
    for k, g in got.items():
        np.testing.assert_allclose(g, want[k], rtol=0,
                                   atol=1e-5 * np.abs(want[k]).max() + 1e-6, err_msg=k)


@pytest.mark.parametrize("stages,micro", [(2, 4), (4, 2)])
def test_pipeline_matches_the_sequential_stack(stages, micro, tmp_path):
    rs = np.random.RandomState(stages)
    weights = [rs.randn(6, 6).astype(np.float32) * 0.5 for _ in range(8)]
    x = rs.randn(8, 6).astype(np.float32)
    aux = rs.randn(8, 6).astype(np.float32)
    out = run_ranks("_torch_parallel_workers:generic_pipeline", stages, tmp_path,
                    weights, x, aux, micro)
    import torch

    xt = torch.tensor(x, requires_grad=True)
    at = torch.tensor(aux, requires_grad=True)
    ws = [torch.tensor(w, requires_grad=True) for w in weights]
    h = xt
    for w in ws:
        h = torch.tanh(h @ w + at)
    h.sum().backward()
    for o in out:  # every stage gets the stack's output and x's and aux's grads
        np.testing.assert_allclose(o["y"], h.detach().numpy(), rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(o["gx"], xt.grad.numpy(), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(o["gaux"], at.grad.numpy(), rtol=1e-5, atol=1e-6)
    per = 8 // stages
    for s, o in enumerate(out):  # each stage its own blocks' grads
        assert sorted(o["gw"]) == list(range(s * per, (s + 1) * per))
        for i, g in o["gw"].items():
            np.testing.assert_allclose(g, ws[i].grad.numpy(), rtol=1e-5, atol=1e-6)


def _jax_pipelined(model, params, stages, micro, data=1):
    x, t, y, g = inputs(8, 8)
    if data == 1:
        mesh = Mesh(np.array(jax.devices()[:stages]), ("stage",))
        apply_fn = pipelined_dit_apply(model, mesh, micro)
    else:
        mesh = make_pp_mesh(stages, devices=jax.devices()[:data * stages])
        apply_fn = pipelined_dit_apply(model, mesh, micro, batch_axis="data")
    return value_and_grads(apply_fn, params, x, t, y, g)


def _assemble(results, stages, data=1):
    """The full batch's output (data rows in order) and gradients (each
    block from its stage, summed over the data rows; the replicated ones
    from stage 0, summed over the data rows)."""
    out = np.concatenate([r["out"] for r in results if r["stage"] == 0])
    grads = {}
    for r in results:
        for k, g in r["grads"].items():
            if k.startswith("blocks.") or r["stage"] == 0:
                grads[k] = grads.get(k, 0) + g
    for r in results:  # every stage's replicated grads and output agree
        np.testing.assert_allclose(r["out"], out.reshape(data, -1, *out.shape[1:])[r["data"]],
                                   rtol=0, atol=1e-6)
    return out, grads


@pytest.mark.parametrize("stages", [2, 4])
def test_pipelined_dit_matches_jax(stages, tmp_path):
    model, params, spec, sd = tiny(8, depth=4, scan_blocks=True)
    x, t, y, g = inputs(8, 8)
    configs = [(stages, m) for m in (1, 2, 8)]
    per_rank = run_ranks("_torch_parallel_workers:dit_pipeline", stages, tmp_path,
                         spec, sd, x, t, y, g, configs, 1)
    for i, (_, micro) in enumerate(configs):
        want_out, want_grads = _jax_pipelined(model, params, stages, micro)
        out, grads = _assemble([r[i] for r in per_rank], stages)
        np.testing.assert_allclose(out, want_out, rtol=1e-5, atol=1e-5)
        _close_grads(grads, want_grads)


def test_data_times_pipeline_on_four_ranks(tmp_path):
    model, params, spec, sd = tiny(8, depth=4, scan_blocks=True)
    x, t, y, g = inputs(8, 8)
    per_rank = run_ranks("_torch_parallel_workers:dit_pipeline", 4, tmp_path,
                         spec, sd, x, t, y, g, [(2, 2)], 2)
    want_out, want_grads = _jax_pipelined(model, params, 2, 2, data=2)
    out, grads = _assemble([r[0] for r in per_rank], 2, data=2)
    np.testing.assert_allclose(out, want_out, rtol=1e-5, atol=1e-5)
    _close_grads(grads, want_grads)
