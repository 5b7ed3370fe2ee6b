"""The port's sequence-parallel DiT (vaw_torch/parallel/sp_dit.py, the
DiT's seq hook and the ring) on gloo CPU ranks against JAX's
sequence_parallel_dit_apply on the virtual mesh (a DiT of hidden 32,
depth 2, 16x16x4, every leaf randomised, weights carried by
models/convert.py): sp 2 and 4, and data x sp on 2 x 2 ranks; the output
and the gradients of sum(out * g). The REPA tap is refused.

Tolerances (f32 on both sides, different summation orders): outputs within
2e-5 absolute and 1e-4 relative (the bound of tests/test_sp_dit.py);
gradients within 1e-5 of the leaf's max|g| plus 1e-6."""

from __future__ import annotations

import jax
import numpy as np
import pytest
from jax.sharding import Mesh

from _torch_jax_dit import inputs, tiny, value_and_grads
from _torch_ranks import run_ranks
from vaw_tpu.parallel.sp_dit import sequence_parallel_dit_apply


@pytest.mark.parametrize("data,sp", [(1, 2), (1, 4), (2, 2)])
def test_sp_dit_matches_jax(data, sp, tmp_path):
    model, params, spec, sd = tiny(16, depth=2)
    x, t, y, g = inputs(4, 16, seed=sp + data)
    if data == 1:
        mesh = Mesh(np.array(jax.devices()[:sp]), ("sp",))
        apply_fn = sequence_parallel_dit_apply(model, mesh)
    else:
        mesh = Mesh(np.array(jax.devices()[:data * sp]).reshape(data, sp), ("data", "sp"))
        apply_fn = sequence_parallel_dit_apply(model, mesh, batch_axis="data")
    want_out, want_grads = value_and_grads(apply_fn, params, x, t, y, g)
    per_rank = run_ranks("_torch_parallel_workers:sp_dit", data * sp, tmp_path,
                         spec, sd, x, t, y, g, sp)
    rows = {}
    grads = {}
    for r in per_rank:
        rows.setdefault(r["data"], r["out"])
        np.testing.assert_allclose(r["out"], rows[r["data"]], rtol=0, atol=0)
    for r in per_rank[::sp]:  # one rank per data row: its sp-summed grads
        for k, v in r["grads"].items():
            grads[k] = grads.get(k, 0) + v
    out = np.concatenate([rows[i] for i in range(data)])
    np.testing.assert_allclose(out, want_out, rtol=1e-4, atol=2e-5)
    assert set(grads) == set(want_grads)
    for k, v in grads.items():
        np.testing.assert_allclose(v, want_grads[k], rtol=0,
                                   atol=1e-5 * np.abs(want_grads[k]).max() + 1e-6, err_msg=k)


def test_sp_refuses_the_repa_tap(tmp_path, monkeypatch):
    from vaw_torch.models.dit import DiT
    from vaw_torch.parallel import distributed
    from vaw_torch.parallel.mesh import make_sp_mesh
    from vaw_torch.parallel.sp_dit import sequence_parallel_dit_apply as port_sp

    monkeypatch.setenv("VAW_PLATFORM", "cpu")
    model = DiT(image_size=8, patch_size=2, in_channels=4, hidden_size=32, depth=2,
                num_heads=2, num_classes=0, learn_align=True, encoder_depth=1,
                z_dims=16, projector_dim=32)
    try:
        distributed.setup_distributed(world_size=1)
        with pytest.raises(ValueError, match="REPA tap"):
            port_sp(model, make_sp_mesh(1))
    finally:
        distributed.cleanup_distributed()
