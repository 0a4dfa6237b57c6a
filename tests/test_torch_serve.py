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


#: the attention families: gemma's post-norms, softcaps and local layers,
#: chatglm3's partial rope at g = 2, llama-vision's cross-attention over
#: the stub patch embeddings, whisper's encoder over the stub frames
ATTN_FAMILIES = ["gemma2-27b", "gemma3-12b", "chatglm3-6b",
                 "llama-3.2-vision-11b", "whisper-tiny"]


@pytest.mark.parametrize("arch", ATTN_FAMILIES)
def test_serve_prints_the_lines_of_the_jax_entry_point_for_attn_families(
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


@pytest.mark.parametrize("arch", ATTN_FAMILIES)
def test_entry_points_raise_without_a_gpu_for_attn_families(monkeypatch,
                                                            arch):
    _raise_without_a_gpu(monkeypatch, arch, ["--arch", arch, *FLAGS])


KERNELS = (fa.flash_attention, fa.decode_attention, bg.burst_gather,
           m2.mamba2_scan, r6.rwkv6_scan, gmm.moe_gmm)


def _generate_launches_no_kernel(arch):
    for fn in KERNELS:
        fn.launches = 0
    cfg = configs.get_reduced(arch)
    params = lm.init_params(cfg, seed=3, device="cpu")
    prompts = serve.make_prompts(cfg, 2, 8, "cpu")
    res = serve.generate(params, cfg, prompts, 4,
                         extra=serve.frontend_inputs(cfg, 2, "cpu"))
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


@pytest.mark.parametrize("arch", ATTN_FAMILIES)
def test_cpu_generation_of_attn_families_launches_no_kernel(arch):
    _generate_launches_no_kernel(arch)


@pytest.mark.parametrize("name", ["gemma3-12b", "chatglm3-6b",
                                  "whisper-tiny", "gemma2-27b"])
def test_unported_archs_name_their_roadmap_item(name):
    """No architecture is left unported: these four, once pending, now
    give their configs, and an unknown name raises ``KeyError``."""
    assert name in configs.ARCHS
    assert configs.get(name).name == name
    assert configs.get_reduced(name).name.endswith("-reduced")
    with pytest.raises(KeyError):
        configs.get(f"{name}-unknown")


@pytest.mark.parametrize("pattern", ["GX", "XG", "LX"])
def test_layer_specs_refuse_unported_layer_kinds(pattern):
    """X is ported: it takes G's spec.  A kind the model does not know is
    refused."""
    cfg = dataclasses.replace(configs.get_reduced("granite-8b"),
                              layer_pattern=pattern)
    specs = lm.build_specs(cfg)
    assert specs[pattern.index("X")] == lm.build_specs(
        dataclasses.replace(cfg, layer_pattern="G"))[0]
    with pytest.raises(ValueError, match="unknown layer kinds"):
        lm.build_specs(dataclasses.replace(
            cfg, layer_pattern=pattern.replace("X", "Q")))


#: the port's own ``ArchConfig`` fields: what the JAX package decides from
#: the config's name
PORT_FIELDS = ("embed_scale", "global_rope_theta")


def _shared_fields(cfg):
    fields = dataclasses.asdict(cfg)
    for f in PORT_FIELDS:
        fields.pop(f, None)
    return fields


def test_every_arch_of_the_jax_package_is_served():
    """``configs.ARCHS`` names every architecture of the JAX package's; each
    builds a port ``LM`` at its reduced size on the CPU, its other fields
    equal the JAX package's, ``embed_scale`` is set where the JAX package's
    name test scales, and its specs equal the JAX package's (gemma3's
    global layers at 50 x theta)."""
    from repro import configs as jconfigs
    from repro.model import lm as jlm

    assert set(configs.ARCHS) == set(jconfigs.ARCHS)
    for name in configs.ARCHS:
        cfg = configs.get_reduced(name)
        assert _shared_fields(cfg) == _shared_fields(
            jconfigs.get_reduced(name))
        assert _shared_fields(configs.get(name)) == _shared_fields(
            jconfigs.get(name))
        for c in (cfg, configs.get(name)):
            assert c.embed_scale == c.name.startswith("gemma")
        lm.check_supported(cfg)
        lm.check_supported(configs.get(name))
        assert [dataclasses.asdict(s) for s in lm.build_specs(cfg)] == \
            [dataclasses.asdict(s) for s in jlm.build_specs(cfg)]
        assert isinstance(lm.LM(cfg, "cpu"), lm.LM)


@pytest.mark.parametrize("arch", ["gemma2-27b", "gemma3-12b"])
def test_renamed_gemma_config_keeps_its_scale_and_theta(arch):
    """The embedding scale and gemma3's global theta come from the config's
    fields, not its name: a renamed config embeds and specs alike."""
    cfg = configs.get_reduced(arch)
    renamed = dataclasses.replace(cfg, name="renamed")
    assert lm.build_specs(renamed) == lm.build_specs(cfg)
    want = 1e6 if arch == "gemma3-12b" else 1e4
    assert lm.build_specs(renamed)[cfg.layer_pattern.index("G")] \
        .rope_theta == want
    params = lm.init_params(cfg, seed=0, device="cpu")
    tokens = torch.arange(8).view(1, 8)
    got = lm._embed(params, renamed, tokens)
    assert torch.equal(got, lm._embed(params, cfg, tokens))
    plain = lm._embed(params, dataclasses.replace(cfg, embed_scale=False),
                      tokens)
    assert torch.equal(got, plain * 8.0)   # sqrt(64) in bf16
