"""The port's CLIs with the UNet family, end to end on the CPU: two training
steps of --model LDM through vaw_torch.cli.main, its checkpoint read back,
and sampling from that checkpoint through vaw_torch.cli.sample at CFG 1.5.
The registry's LDM entry is patched to a narrow create_unet_model (32
channels, mult (1, 2), one res block a level, heads of 8, attention at both
levels) so that a checkpoint is a few megabytes (the full-width LDM's f32
train state is about 5.5 GB); the code path is the full model's. At
--image_size 16 the first level's attention has T = 256 and takes the p5
route (its plain versions on the CPU), the second's T = 64 the general one.
"""

from __future__ import annotations

import glob

import pytest
import torch

from vaw_torch.cli import main as train_cli
from vaw_torch.cli import sample as sample_cli
from vaw_torch.models import unet
from vaw_torch.ops import flash_attention as port_flash
from vaw_torch.train import load_checkpoint

MODEL = ["--model", "LDM", "--image_size", "16", "--in_chans", "4",
         "--num_classes", "10", "--class_cond", "True"]
TRAIN = MODEL + [
    "--drop_label_prob", "0.1", "--dataset", "Gaussian", "--batch_size", "4",
    "--weight_type", "lambda", "--mean_type", "EPSILON", "--path_type", "cosine",
    "--betas", "0.9", "0.95", "--eval", "False", "--sample_freq", "0",
    "--amp", "True", "--lr", "1e-3"]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread a test, restored after it: the suite runs several
    test processes side by side, and torch's default of a thread per core
    in each oversubscribes the machine, which makes these many small ops
    many times slower."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _narrow_ldm(**kwargs):
    return unet.create_unet_model(
        image_size=16, num_channels=32, num_res_blocks=1, channel_mult="1,2",
        attention_resolutions="16,8", num_heads=1, num_head_channels=8, **kwargs)


@pytest.fixture
def narrow_ldm(monkeypatch):
    monkeypatch.setenv("VAW_PLATFORM", "cpu")
    monkeypatch.setitem(unet.UNet_models, "LDM", _narrow_ldm)
    routes = []
    for name in ("_FlashP5", "_FlashPacked"):
        real = getattr(port_flash, name).apply
        monkeypatch.setattr(getattr(port_flash, name), "apply",
                            lambda *a, name=name, real=real: routes.append(name) or real(*a))
    return routes


def test_train_two_steps_then_sample_with_cfg(narrow_ldm, tmp_path, capsys):
    ctx = train_cli.main(TRAIN + ["--logdir", str(tmp_path / "logs"),
                                  "--total_steps", "2", "--save_step", "2"])
    assert ctx["state"].step == 2
    # A step's forward: three 16x16 blocks (T = 256, p5) and four 8x8 ones
    # (T = 64, the middle one among them).
    assert narrow_ldm.count("_FlashP5") == 2 * 3 and narrow_ldm.count("_FlashPacked") == 2 * 4
    (ckpt,) = glob.glob(str(tmp_path / "logs" / "*" / "checkpoint" /
                            "LDM_EPSILON_cosine_2.pt"))
    payload = torch.load(ckpt, weights_only=True)
    assert payload["step"] == 2
    model = _narrow_ldm(num_classes=10, in_channels=4, drop_label_prob=0.1)
    assert load_checkpoint(ckpt, model) == 2
    for name, p in model.named_parameters():
        torch.testing.assert_close(p.detach(), payload["ema"][name], rtol=0, atol=0)
    assert model.label_emb.weight.shape == (11, 512)

    sample_cli.main(MODEL + ["--drop_label_prob", "0.1", "--guidance_scale", "1.5",
                             "--sample_steps", "3", "--sample_size", "4",
                             "--num_samples", "4", "--resume", ckpt,
                             "--save_path", str(tmp_path / "samples")])
    assert len(list((tmp_path / "samples").rglob("*.png"))) == 4
    assert "Saved 4 samples" in capsys.readouterr().out


@pytest.mark.parametrize("name,category", [
    ("sm90_xmma_dgrad_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc", "conv (cuDNN)"),
    ("void cudnn::engines_precompiled::nchwToNhwcKernel<__nv_bfloat16>", "conv (cuDNN)"),
    ("sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x128x64", "matmul (cuBLAS)"),
    ("nvjet_tst_128x256_64x4_1x2_h_bz_coopA_NNT", "matmul (cuBLAS)"),
    ("sm90_xmma_gemm_f32f32_f32f32_f32_tn_n_tilesize128x128x32", "matmul f32 (cuBLAS)"),
    ("cutlass_80_simt_sgemm_128x128_8x4_nn_align1", "matmul f32 (cuBLAS)"),
    ("void (anonymous namespace)::flash_p5_bwd_dq_bf16<2>(...)", "p5 attention bwd kernel"),
    ("void (anonymous namespace)::flash_fwd_bf16<2>(...)", "general attention fwd kernel"),
    ("void at::native::ComputeInternalGradientsCUDAKernel<float>(...)", "group norm"),
    ("void (anonymous namespace)::conv3x3_fwd_bf16<true>(...)", "conv3x3 fwd/dgrad kernel"),
    ("void (anonymous namespace)::conv3x3_fwd_f32<128, 64, 8, 4>(...)",
     "conv3x3 fwd/dgrad kernel"),
    ("void (anonymous namespace)::conv3x3_wgrad_bf16<true, true>(...)",
     "conv3x3 wgrad kernel"),
    ("void (anonymous namespace)::conv3x3_wgrad_reduce<__nv_bfloat16>(...)",
     "conv3x3 wgrad kernel"),
    ("void (anonymous namespace)::conv3x3_wgrad_wgmma<192, 4>(CUtensorMap, ...)",
     "conv3x3 wgrad kernel"),
    ("void (anonymous namespace)::flash_p5_fwd_wgmma<32, 8>(CUtensorMap, ...)",
     "p5 attention fwd kernel"),
    ("void (anonymous namespace)::flash_fwd_wgmma<32, 3, 8>(CUtensorMap, ...)",
     "general attention fwd kernel"),
    ("void (anonymous namespace)::flash_bwd_dq_wgmma<64, 7>(CUtensorMap, ...)",
     "general attention bwd kernel"),
    ("void (anonymous namespace)::flash_bwd_dkdv_wgmma<64, 7>(CUtensorMap, ...)",
     "general attention bwd kernel"),
])
def test_profile_sorts_the_unet_kernels(name, category):
    """The categories of `python -m vaw_torch.cli.profile_train --model LDM`:
    cuDNN's implicit-GEMM convs, which are sm90_xmma kernels like cuBLAS's
    GEMMs, go to the conv category; the hand-written conv kernels of
    VAW_PALLAS_CONV=1 to their own."""
    from vaw_torch.cli.profile_train import kernel_category

    assert kernel_category(name) == category


def test_train_cli_trains_under_pallas_conv(narrow_ldm, tmp_path, monkeypatch):
    """VAW_PALLAS_CONV=1 sends the narrow UNet's stride-1 3x3 convs to
    conv3x3 (its plain versions on the CPU) in a CLI run that trains and
    writes its checkpoint; the checkpoint loads into a model built without
    the flag (same state dict)."""
    monkeypatch.setenv("VAW_PALLAS_CONV", "1")
    convs = []
    real = unet.conv3x3
    monkeypatch.setattr(unet, "conv3x3", lambda x, w: convs.append(x.shape) or real(x, w))
    ctx = train_cli.main(TRAIN + ["--logdir", str(tmp_path / "logs"),
                                  "--total_steps", "2", "--save_step", "2"])
    assert ctx["state"].step == 2
    # A forward: the stem, two convs in each of the narrow UNet's ten
    # ResBlocks but the up-sampling one's first, and the f32 head.
    assert len(convs) == 2 * 21
    assert isinstance(ctx["trainer"].model.out[2], unet.PallasConv3x3)
    (ckpt,) = glob.glob(str(tmp_path / "logs" / "*" / "checkpoint" /
                            "LDM_EPSILON_cosine_2.pt"))
    monkeypatch.setenv("VAW_PALLAS_CONV", "0")
    model = _narrow_ldm(num_classes=10, in_channels=4, drop_label_prob=0.1)
    assert load_checkpoint(ckpt, model) == 2
    assert not any(isinstance(m, unet.PallasConv3x3) for m in model.modules())


@pytest.mark.parametrize("pallas_conv", ["0", "1"])
@pytest.mark.parametrize("policy", ["full", "dots"])
def test_train_cli_remats_the_unet(policy, pallas_conv, narrow_ldm, tmp_path,
                                   monkeypatch):
    """--use_checkpoint True under either policy and either VAW_PALLAS_CONV
    value trains the state the run without remat trains, bit for bit (f32,
    dropout 0.1: the recompute replays the dropout generator)."""
    monkeypatch.setenv("VAW_PALLAS_CONV", pallas_conv)
    args = TRAIN + ["--total_steps", "2", "--save_step", "0", "--amp", "False",
                    "--dropout", "0.1"]
    states = []
    for flags in ([], ["--use_checkpoint", "True", "--remat_policy", policy]):
        ctx = train_cli.main(args + flags + ["--logdir", str(tmp_path / "logs")])
        assert ctx["trainer"].model.use_checkpoint == bool(flags)
        states.append(ctx["state"])
    plain, rematted = states
    assert rematted.step == 2
    for k, p in plain.params.items():
        assert torch.equal(rematted.params[k], p), k
