"""The port's serving entry point on the CPU: the same printed lines as
``repro.launch.serve``, no silent fallback to the CPU, and no kernel
launches for CPU tensors."""
import dataclasses
import re
import sys

import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

import torch  # noqa: E402

from repro.launch import serve as jserve  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.kernels import burst_gather as bg  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import mamba2_scan as m2  # noqa: E402
from repro_torch.kernels import moe_gmm as gmm  # noqa: E402
from repro_torch.kernels import rwkv6_scan as r6  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.model import convert, lm  # noqa: E402

FLAGS = ["--reduced", "--batch", "2", "--prompt-len", "8", "--gen", "5"]
LINES = [r"prefill 8 tokens x 2: \d+\.\d\ds",
         r"decoded 5 x 2 tokens in \d+\.\d\ds \(\d+\.\d tok/s\)",
         r"sample token ids: \[(\d+, ){4}\d+\]"]


def _same_lines_as_jax(capsys, monkeypatch, flags):
    monkeypatch.setattr(sys, "argv", ["serve", *flags])
    jserve.main()
    jax_lines = capsys.readouterr().out.splitlines()
    serve.main([*flags, "--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    for got, want, pattern in zip(lines, jax_lines, LINES, strict=True):
        assert re.fullmatch(pattern, want), want
        assert re.fullmatch(pattern, got), got


def test_serve_prints_the_lines_of_the_jax_entry_point(capsys, monkeypatch):
    _same_lines_as_jax(capsys, monkeypatch, FLAGS)


@pytest.mark.parametrize("arch", ["zamba2-7b", "rwkv6-1.6b"])
def test_serve_prints_the_lines_of_the_jax_entry_point_for_ssm_archs(
        capsys, monkeypatch, arch):
    _same_lines_as_jax(capsys, monkeypatch, ["--arch", arch, *FLAGS])


@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m", "arctic-480b"])
def test_serve_prints_the_lines_of_the_jax_entry_point_for_moe_archs(
        capsys, monkeypatch, arch):
    _same_lines_as_jax(capsys, monkeypatch, ["--arch", arch, *FLAGS])


def _raise_without_a_gpu(monkeypatch, arch, flags):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = configs.get_reduced(arch)
    with pytest.raises(RuntimeError):
        lm.init_params(cfg)
    params = lm.init_params(cfg, device="cpu")
    with pytest.raises(RuntimeError):
        lm.init_cache(params, cfg, 1, 8)
    with pytest.raises(RuntimeError):
        serve.main(flags)
    with pytest.raises(RuntimeError):
        convert.from_jax_params({}, cfg)


def test_entry_points_raise_without_a_gpu(monkeypatch):
    _raise_without_a_gpu(monkeypatch, "granite-8b", FLAGS)


@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m", "arctic-480b"])
def test_entry_points_raise_without_a_gpu_for_moe_archs(monkeypatch, arch):
    _raise_without_a_gpu(monkeypatch, arch, ["--arch", arch, *FLAGS])


KERNELS = (fa.flash_attention, fa.decode_attention, bg.burst_gather,
           m2.mamba2_scan, r6.rwkv6_scan, gmm.moe_gmm)


def _generate_launches_no_kernel(arch):
    for fn in KERNELS:
        fn.launches = 0
    cfg = configs.get_reduced(arch)
    params = lm.init_params(cfg, seed=3, device="cpu")
    prompts = serve.make_prompts(cfg, 2, 8, "cpu")
    res = serve.generate(params, cfg, prompts, 4)
    assert res.tokens.shape == (2, 4) and res.tokens.dtype == torch.int32
    assert res.logits.shape == (5, 2, cfg.vocab_padded)
    assert torch.isfinite(res.logits.float()).all()
    assert int(res.tokens.max()) < cfg.vocab
    assert [fn.launches for fn in KERNELS] == [0] * len(KERNELS)


def test_cpu_generation_launches_no_kernel():
    _generate_launches_no_kernel("granite-8b")


@pytest.mark.parametrize("arch", ["zamba2-7b", "rwkv6-1.6b"])
def test_cpu_generation_of_ssm_archs_launches_no_kernel(arch):
    _generate_launches_no_kernel(arch)


@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m", "arctic-480b"])
def test_cpu_generation_of_moe_archs_launches_no_kernel(arch):
    _generate_launches_no_kernel(arch)


@pytest.mark.parametrize("name", ["gemma3-12b", "chatglm3-6b",
                                  "whisper-tiny", "gemma2-27b"])
def test_unported_archs_name_their_roadmap_item(name):
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        configs.get(name)


@pytest.mark.parametrize("pattern", ["GX", "XG", "LX"])
def test_layer_specs_refuse_unported_layer_kinds(pattern):
    cfg = dataclasses.replace(configs.get_reduced("granite-8b"),
                              layer_pattern=pattern)
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        lm.build_specs(cfg)
