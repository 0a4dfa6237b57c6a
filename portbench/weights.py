"""The benchmark's weights: every leaf of a configuration, by name, drawn
on the card from the run's seed.

Both sides get the same numbers: the harness copies them into the
program's parameters, and the reference draws them again after the window
(``draw`` is deterministic for a seed and a device).  The names are the
program's (``layers.3.attn.wq``), so that the two sides' leaves pair by
name; nothing here imports the program.

Matrices are normal at std 1/sqrt(fan_in) (fan_in the second-to-last
dim), the embedding and the router at 0.02, norm weights 1.  Every drawn
leaf comes out of one ``torch.randn`` over all of them in bf16, the dtype
they are served in, so a leaf holds bf16 values whatever its dtype (the
f32 router too).
"""
from __future__ import annotations

import torch

from portbench.costs import vocab_padded

#: std of the leaves not drawn at 1/sqrt(fan_in)
STD = {"embed": 0.02, "router": 0.02}


def leaves(m: dict) -> list[tuple[str, tuple[int, ...], torch.dtype, str]]:
    """(name, shape, dtype, init) of every leaf, init "normal" or "ones"."""
    d, H, Hkv, D = m["d_model"], m["n_heads"], m["n_kv_heads"], m["head_dim"]
    bf, f32 = torch.bfloat16, torch.float32
    out = [("embed", (vocab_padded(m), d), bf, "normal"),
           ("ln_f.w", (d,), f32, "ones")]
    for i in range(m["n_layers"]):
        p = f"layers.{i}."
        out += [(p + "ln_attn.w", (d,), f32, "ones"),
                (p + "attn.wq", (d, H * D), bf, "normal"),
                (p + "attn.wk", (d, Hkv * D), bf, "normal"),
                (p + "attn.wv", (d, Hkv * D), bf, "normal"),
                (p + "attn.wo", (H * D, d), bf, "normal"),
                (p + "ln_mlp.w", (d,), f32, "ones")]
        if m.get("n_experts"):
            E, f = m["n_experts"], m["moe_d_ff"]
            out += [(p + "moe.router", (d, E), f32, "normal"),
                    (p + "moe.w_up", (E, d, f), bf, "normal"),
                    (p + "moe.w_down", (E, f, d), bf, "normal"),
                    (p + "moe.w_gate", (E, d, f), bf, "normal")]
        else:
            f = m["d_ff"]
            out += [(p + "mlp.w_up", (d, f), bf, "normal"),
                    (p + "mlp.w_down", (f, d), bf, "normal"),
                    (p + "mlp.w_gate", (d, f), bf, "normal")]
    return out


def _numel(shape) -> int:
    n = 1
    for s in shape:
        n *= s
    return n


def draw(m: dict, seed: int, device, dtype=None) -> dict[str, torch.Tensor]:
    """Every leaf of ``leaves(m)`` for ``seed`` on ``device``: one bf16
    draw of all the normal leaves from a ``torch.Generator`` on the
    device, scaled leaf by leaf.  A leaf takes its own dtype, or ``dtype``
    where given (the reference's f32)."""
    specs = leaves(m)
    total = sum(_numel(s) for _, s, _, init in specs if init == "normal")
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(total, generator=gen, dtype=torch.bfloat16,
                       device=device)
    out, off = {}, 0
    for name, shape, dt, init in specs:
        dt = dtype or dt
        if init == "ones":
            out[name] = torch.ones(shape, dtype=dt, device=device)
            continue
        n = _numel(shape)
        std = STD.get(name.rsplit(".", 1)[-1],
                      shape[-2] ** -0.5 if len(shape) > 1 else 1.0)
        # scaled in bf16, so every dtype holds the same bf16 values
        out[name] = (flat[off:off + n].view(shape) * std).to(dt)
        off += n
    del flat
    return out
