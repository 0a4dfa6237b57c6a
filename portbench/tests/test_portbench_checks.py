"""The comparison that decides ``correct`` fails when the timed path is
broken: a whole small run on the CPU (the look for a chip skipped), with
each fault a cell can have planted in the program underneath, reads
``correct`` false under the cell's own limits; and the control (the
reference at fp8, the precision below the configurations' bf16) fails
them too."""
from __future__ import annotations

import copy

import pytest
import torch

from portbench import compare
from portbench.drivers import serve, train
from portbench.reference.precision import FP8
from portbench.tests import _tiny


def _state_unchanged(monkeypatch):
    from repro_torch.launch import train as program
    monkeypatch.setattr(program, "adamw_update",
                        lambda params, grads, state, **kw: (params, state))


def _half_batch(monkeypatch):
    """The loss's mean over the first half of the targets only."""
    from repro_torch.model import lm
    forward = lm.forward

    def loss_fn(params, cfg, batch, *, remat=False):
        tokens = batch["tokens"]
        logits, aux = forward(params, cfg, tokens)
        lg = logits[:, :-1].float().reshape(-1, logits.shape[-1])
        tg = tokens[:, 1:].reshape(-1).long()
        half = tg.numel() // 2
        ce = torch.logsumexp(lg[:half], -1) - lg[:half].gather(
            -1, tg[:half, None])[:, 0]
        return ce.mean() + 0.01 * aux

    monkeypatch.setattr(lm, "loss_fn", loss_fn)


def _wrap_step(monkeypatch, change):
    from repro_torch.model import lm
    step = lm.step
    monkeypatch.setattr(lm, "step",
                        lambda params, cfg, cache, tokens:
                        change(step, params, cfg, cache, tokens))


def _token_altered(monkeypatch):
    """The first served token of every request, one id off."""
    from repro_torch.launch import serve as program
    generate = program.generate

    def altered(params, cfg, prompts, gen, **kw):
        res = generate(params, cfg, prompts, gen, **kw)
        res.tokens[:, 0] = (res.tokens[:, 0] + 1) % cfg.vocab
        return res

    monkeypatch.setattr(program, "generate", altered)


def _serve_half_batch(monkeypatch):
    """Every step's second half of the batch answered with the first
    half's logits."""
    def change(step, params, cfg, cache, tokens):
        logits, cache = step(params, cfg, cache, tokens)
        half = logits.shape[0] // 2
        logits = torch.cat([logits[:half], logits[:logits.shape[0] - half]])
        return logits, cache

    _wrap_step(monkeypatch, change)


def _cache_unchanged(monkeypatch):
    """Decode steps that leave the cache as the prefill left it: each
    runs on a copy, and the position stays."""
    def change(step, params, cfg, cache, tokens):
        if tokens.shape[1] > 1:
            return step(params, cfg, cache, tokens)
        logits, _ = step(params, cfg, copy.deepcopy(cache), tokens)
        return logits, cache

    _wrap_step(monkeypatch, change)


FAULTS = [("train4k.granite-8b", _state_unchanged),
          ("train4k.granite-8b", _half_batch),
          ("serve-longprompt.granite-8b", _token_altered),
          ("serve-longprompt.granite-8b", _serve_half_batch),
          ("serve-longprompt.granite-8b", _cache_unchanged)]


@pytest.mark.parametrize("cell,fault", FAULTS,
                         ids=[f"{c}-{f.__name__[1:]}" for c, f in FAULTS])
def test_a_fault_in_the_timed_path_makes_the_run_incorrect(cell, fault,
                                                           monkeypatch):
    fault(monkeypatch)
    out = _tiny.run(_tiny.cell(cell))
    assert out["correct"] is False, out["checks"]


def test_the_fp8_control_fails_the_training_cells_limits():
    c = _tiny.cell("train4k.granite-8b")
    dev = torch.device("cpu")
    ref = train.reference(c, 21, dev)
    ok, checks = compare.judge(compare.train_numbers(
        train.reference(c, 21, dev, FP8), ref), c.limits)
    assert not ok, checks


def test_the_fp8_control_fails_the_serving_cells_limit():
    c = _tiny.cell("serve-longprompt.granite-8b")
    dev = torch.device("cpu")
    tokens = torch.randint(0, c.model["vocab"], (2, c.traffic["batch"],
                                                 c.traffic["gen"]))
    seqs = serve.sample(c, 21, tokens, dev)
    ref = serve.reference_logits(c, 21, seqs, dev)
    low = serve.reference_logits(c, 21, seqs, dev, FP8)
    gap = float(compare.token_gaps(ref, low.argmax(-1)).max())
    assert gap > c.limits["logit_gap"]


@pytest.mark.card
def test_controls_on_the_card():
    """On the card, at the cells' own sizes: the program passes and the
    control fails, for one seed of each cell (``control.py``)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from portbench import control, harness
    for cell in ("train4k.granite-8b", "serve-longprompt.granite-8b"):
        lines = control.readings(cell, [31], {31})
        limits = harness.find_cell(cell).limits
        assert compare.judge(lines[0]["program"], limits)[0], lines
        assert not compare.judge(lines[0]["control"], limits)[0], lines
