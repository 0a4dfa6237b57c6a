"""The plain reference against the program, both in f32 on the CPU: the
program's first training steps (``launch.train.train_step``) and its
served logits (``launch.serve.generate``) equal the reference's from the
same weights and inputs, dense and MoE, so that what a run on the card
compares is precision alone."""
from __future__ import annotations

import pytest
import torch

from portbench import compare, harness, weights
from portbench.drivers import serve, train
from portbench.tests import _tiny
from portbench.traffic import TrainTokens


@pytest.fixture
def f32_program(monkeypatch):
    from repro_torch.model import layers, lm
    monkeypatch.setattr(layers, "PDTYPE", torch.float32)
    monkeypatch.setattr(lm, "PDTYPE", torch.float32)


def _f32_params(c, seed):
    from repro_torch.model import lm
    pc = harness.program_config(c.config)
    params = lm.LM(pc, "cpu")
    drawn = weights.draw(c.model, seed, "cpu", torch.float32)
    with torch.no_grad():
        for k, p in params.named_parameters():
            p.copy_(drawn[k])
    return pc, params, drawn


@pytest.mark.parametrize("cell", ["train4k.granite-8b", "moe"])
def test_training_steps_equal_the_reference_in_f32(cell, f32_program):
    from repro_torch.launch import train as program
    from repro_torch.optim import adamw_init
    c = _tiny.moe() if cell == "moe" else _tiny.cell(cell)
    m, tr, seed = c.model, c.traffic, 12
    pc, params, start = _f32_params(c, seed)
    params.requires_grad_(True)
    opt = adamw_init(dict(params.named_parameters()))
    src = TrainTokens(m["vocab"], seed, tr)
    prog = {"losses": [], "grad_norms": {}, "change_norms": {}}
    for i in range(tr["check_steps"]):
        batch = torch.from_numpy(src.batch(i, 0, tr["batch"], tr["seq"]))
        loss, _ = program.train_step(params, pc, opt, batch, tr["lr"])
        prog["losses"].append(float(loss))
        if i == 0:
            prog["grad_norms"] = {
                k: float(torch.linalg.vector_norm(mo)) / (1 - tr["b1"])
                for k, mo in opt["m"].items()}
    prog["change_norms"] = {
        k: float(torch.linalg.vector_norm(p.detach() - start[k]))
        for k, p in params.named_parameters()}
    ref = train.reference(c, seed, torch.device("cpu"))
    got = compare.train_numbers(prog, ref)
    assert got["loss_gap"] < 1e-6
    assert got["grad_gap"] < 1e-5
    assert got["change_gap"] < 1e-5


@pytest.mark.parametrize("cell", ["serve-longprompt.granite-8b"])
def test_served_logits_equal_the_reference_in_f32(cell, f32_program):
    """Prefill then decode through the cache, against the reference's
    forward over each prompt with its served tokens."""
    from repro_torch.launch import serve as program
    c = _tiny.cell(cell)
    m, tr, seed = c.model, c.traffic, 4
    pc, params, _ = _f32_params(c, seed)
    prompts = serve.traffic.prompts(m["vocab"], seed, 0, tr, "cpu")
    res = program.generate(params, pc, prompts, tr["gen"])
    seqs = torch.cat([prompts.long(), res.tokens.long()], 1)
    ref = serve.reference_logits(c, seed, seqs, torch.device("cpu"))
    got = res.logits[:tr["gen"], :, :m["vocab"]].transpose(0, 1)
    assert torch.allclose(got, ref, atol=1e-4, rtol=1e-4)
    assert float(compare.token_gaps(ref, res.tokens).max()) == 0.0
