"""Device time of the training backward kernels at the train phase's
shapes, split by the kernels each call launches, on one GPU.

  PYTHONPATH=src python -m repro_torch.launch.profile_bwd [--reps N]
      [--only NAME,..]

``flash_attention_bwd`` at granite-8b's training shape (B 4, S 1024, 32 /
8 heads, D 128, causal, bf16) and gemma3-12b's (16 / 8 heads, D 256: the
same products), each with SDPA's backward at that shape (timed here as a
yardstick, never called by the port), the bound and the library's launches
by path, then the attention passes' registers and spills;
``burst_gather_bwd`` at its embedding
(the first training batch's 4,100 Zipfian ids into the (49152, 4096) bf16
table), ``mamba2_scan_bwd`` at zamba2-7b's M layers (B 4, S 1024, 112
heads, P 64, N 64, bf16 x, B and C sliced from one projection: the
chunked path, a states pass ``mamba2_chunked<1, true, true>``, then
``mamba2_bwd_chunked`` and ``mamba2_bwd_sum``) and ``rwkv6_scan_bwd`` at
rwkv6-1.6b's (B 4, S 1024, 32 heads, D 64, bf16: ``rwkv6_bwd_scan`` and
``rwkv6_bwd_sum``) and ``moe_gmm_bwd`` at granite-moe-3b-a800m's two
grouped products (32,800 routed rows, the top 8 of 40 experts for 4,100
tokens, sorted as the dispatch sorts them, bf16; gate/up K 1536 -> N
512, down 512 -> 1536; on the layer's shared plan: dX and dW).
``--only`` keeps the named ones of
``flash_attention_bwd``, ``burst_gather_bwd``, ``mamba2_scan_bwd``,
``rwkv6_scan_bwd`` and ``moe_gmm_bwd``.
For each it prints the median device time of one call from CUDA
events (the L2 flushed before each call) and the device time per call of
each kernel the call launches, from ``torch.profiler``, after the card's
name and power limit; for ``moe_gmm_bwd`` also its kernels' registers and
spills (``_build.kernel_report``).  It calls only the wrappers' public
entry points, so it also measures another checkout's kernels:
``PYTHONPATH=<checkout>/src python src/repro_torch/launch/profile_bwd.py``.
It needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import re
import statistics
import subprocess

import torch

from repro_torch import configs
from repro_torch.data import SyntheticTokens
from repro_torch.kernels import burst_gather as bg
from repro_torch.kernels import costs
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import mamba2_scan as m2
from repro_torch.kernels import moe_gmm as gmm
from repro_torch.kernels import rwkv6_scan as r6
from repro_torch.launch.profile_serve import _device_ops, _traced

B, S, HQ, HKV, D = 4, 1024, 32, 8, 128
ARCH = "granite-8b"
#: the attention backward's training shapes (B, S, Hq, Hkv, D), causal:
#: granite-8b's under ``flash_attention_bwd``, gemma3-12b's head size 256
BWD_ATTN_SHAPES = {"flash_attention_bwd": (B, S, HQ, HKV, D),
               "flash_attention_bwd[gemma3]": (B, S, 16, 8, 256)}
#: the scans' heads at the train phase's B and S: zamba2-7b's (H, P, N),
#: rwkv6-1.6b's (H, D)
M2_HPN, R6_HD = (112, 64, 64), (32, 64)
#: granite-moe-3b-a800m's grouped products at the train phase's B and S:
#: (tokens, top k, experts), and (K, N) of each product
MOE_TKE = (B * (S + 1), 8, 40)
MOE_KN = {"gate-up": (1536, 512), "down": (512, 1536)}
NAMES = ("flash_attention_bwd", "burst_gather_bwd", "mamba2_scan_bwd",
         "rwkv6_scan_bwd", "moe_gmm_bwd")
#: clock cycles the card idles before each timed call (~0.5 ms at 2 GHz):
#: longer than the host takes to issue the slowest wrapper ``chip_smoke.py``
#: times, the split-KV decode with its scratch and two launches
SPIN_CYCLES = 1_000_000


def time_ms(fn, flush, reps=25):
    """Median device time of one call, with L2 flushed before each.

    Before each call the card spins for ``SPIN_CYCLES``, so the host has
    enqueued the call, and its end event, before the card reaches them: the
    events then time the call's kernels and not the host's issuing of them,
    which for a wrapper around one short kernel is the larger part.  A
    Python loop of launches, as the plain scans are, takes longer to issue
    than the spin lasts, and its time stays its host's."""
    fn()
    marks = []
    for _ in range(reps):
        flush.zero_()
        torch.cuda._sleep(SPIN_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        marks.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in marks)


def _short(name: str) -> str:
    """``void (anonymous namespace)::bwd_write<float, true>(float const*,
    ...)`` -> ``bwd_write<float, true>``."""
    name = re.sub(r"^void |\(anonymous namespace\)::", "", name)
    depth = 0
    for i, ch in enumerate(name):
        depth += ch == "<"
        depth -= ch == ">"
        if ch == "(" and depth == 0 and i > 0:
            return name[:i].strip()
    return name.strip()


def kernel_split(fn, reps=10) -> dict[str, float]:
    """Device ms per call of each kernel (or memset) that ``fn`` launches,
    by name, from ``torch.profiler`` over ``reps`` calls after one
    untraced call."""
    fn()
    prof, _ = _traced(lambda: [fn() for _ in range(reps)])
    split: dict[str, float] = {}
    for name, start, end in _device_ops(prof):
        key = _short(name)
        split[key] = split.get(key, 0.0) + (end - start) / reps / 1e6
    return split


def embedding_ids(batch=B, seq=S, device="cuda"):
    """The first training batch of ``ARCH``, flattened: the ids its
    embedding gathers (Zipfian, so heavily repeated), int32."""
    toks = SyntheticTokens(configs.get(ARCH).vocab, seed=0).batch(
        0, 0, batch, seq)
    return torch.from_numpy(toks).reshape(-1).to(device, torch.int32)


def attention_inputs(gen, shape=(B, S, HQ, HKV, D)):
    """q, k, v, do at a training shape (B, S, Hq, Hkv, D), and the
    forward's o and lse."""
    b, s, hq, hkv, d = shape
    q, do = (torch.randn((b, s, hq, d), generator=gen, device="cuda")
             .bfloat16() for _ in range(2))
    k, v = (torch.randn((b, s, hkv, d), generator=gen, device="cuda")
            .bfloat16() for _ in range(2))
    lse = torch.empty((b, hq, s), dtype=torch.float32, device="cuda")
    o = fa._launch("flash_attention_fwd", q, k, v, causal=True, window=None,
                   softcap=None, scale=None, q_offset=0, kv_len=None,
                   lse=lse)
    return q, k, v, o, lse, do


def mamba2_bwd_inputs(gen, b=B, s=S, hpn=M2_HPN, dtype=torch.bfloat16):
    """x, dt, A, B, C, state (None), dy of ``mamba2_scan_bwd`` as the model
    gives them: x, B and C sliced from one (b, s, H P + 2 N) projection, dt
    after softplus, A < 0 in f32; dy contiguous in x's dtype."""
    h, p, n = hpn
    fused = torch.randn((b, s, h * p + 2 * n), generator=gen,
                        device="cuda").to(dtype)
    x, Bm, Cm = torch.split(fused, [h * p, n, n], dim=-1)
    dt = torch.nn.functional.softplus(
        torch.randn((b, s, h), generator=gen, device="cuda"))
    A = -torch.exp(torch.randn((h,), generator=gen, device="cuda"))
    dy = torch.randn((b, s, h, p), generator=gen, device="cuda").to(dtype)
    return x.unflatten(2, (h, p)), dt, A, Bm, Cm, None, dy


def rwkv6_bwd_inputs(gen, b=B, s=S, hd=R6_HD, dtype=torch.bfloat16):
    """r, k, v, w (= exp(-exp(z))), u, state (None), dy of
    ``rwkv6_scan_bwd``: r, k, v, w and dy in ``dtype``, u in f32."""
    h, d = hd
    r, k, v, z, dy = (torch.randn((b, s, h, d), generator=gen, device="cuda")
                      for _ in range(5))
    w = torch.exp(-torch.exp(z))
    u = 0.3 * torch.randn((h, d), generator=gen, device="cuda")
    return (*(t.to(dtype) for t in (r, k, v, w)), u, None, dy.to(dtype))


def sdpa_bwd(q, k, v, do, causal=True):
    """The backward of ``scaled_dot_product_attention`` (enable_gqa) on
    the same inputs, as a function of no argument: the library yardstick,
    never called by the port."""
    qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_(True)
                  for t in (q, k, v))
    with torch.enable_grad():
        out = torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal, enable_gqa=True)
    dot = do.transpose(1, 2).contiguous()
    return lambda: torch.autograd.grad(out, (qt, kt, vt), dot,
                                       retain_graph=True)


def attention_bound(q, k, do, lse, causal=True):
    """(ms, "bytes" or "operations") of the attention backward's bound:
    the five products of its (query, key) pairs, 2 x 5 D flops a pair,
    against q, k, v, o, dO, lse read and dq, dk, dv written once."""
    b, s, hq, d = q.shape
    flops = costs.attention_bwd_flops(
        costs.attention_pairs(b, s, k.shape[1], hq, causal=causal), d)
    nbytes = q.element_size() * (3 * q.numel() + 2 * do.numel()
                                 + 4 * k.numel()) + 4 * lse.numel()
    return costs.bound(flops, nbytes)


def attention_bwd(out, gen, flush, reps):
    """``flash_attention_bwd`` at each of ``BWD_ATTN_SHAPES`` into
    ``out``: ms, kernels_ms, sdpa_ms, bound_ms and bound_by, and the
    library's launches by path over the timed calls (``fa.bwd_paths``,
    where the measured checkout has it); then the attention backward's
    kernels' registers and spills."""
    from repro_torch.kernels import _build

    paths = getattr(fa, "bwd_paths", None)
    for name, shape in BWD_ATTN_SHAPES.items():
        q, k, v, o, lse, do = attention_inputs(gen, shape)

        def attn():
            return fa.flash_attention_bwd(q, k, v, o, lse, do, causal=True)
        before = paths() if paths else None
        row = {"shape": shape, "ms": time_ms(attn, flush, reps),
               "kernels_ms": kernel_split(attn),
               "sdpa_ms": time_ms(sdpa_bwd(q, k, v, do), flush, reps)}
        row["bound_ms"], row["bound_by"] = attention_bound(q, k, do, lse)
        if paths:
            row["paths"] = {p: n - before[p] for p, n in paths().items()}
        out[name] = row
        del q, k, v, o, lse, do
    out["flash_attention_bwd_kernels"] = {
        k: v for k, v in _build.kernel_report("flash_attention").items()
        if k.startswith("flash_bwd")}


def moe_bwd_inputs(gen, K, N, tke=MOE_TKE):
    """x, w, ids, dy and the plan of one grouped product's backward as the
    MoE layer gives them: the ids the top k of random router scores,
    sorted by expert as the dispatch sorts them; x and dy standard normal,
    w at std 1/sqrt(K); bf16."""
    tokens, k, E = tke
    ids = torch.randn((tokens, E), generator=gen, device="cuda").topk(
        k, -1).indices.reshape(-1).sort().values.to(torch.int32)
    x = torch.randn((tokens * k, K), generator=gen, device="cuda").bfloat16()
    w = (torch.randn((E, K, N), generator=gen, device="cuda") *
         K ** -0.5).bfloat16()
    dy = torch.randn((tokens * k, N), generator=gen, device="cuda").bfloat16()
    return x, w, ids, dy, gmm.plan(ids, E)


def moe_bwd(out, gen, flush, reps):
    """``moe_gmm_bwd`` at both products into ``out``: ms and kernels_ms,
    and ``ms_alone`` of a call that asks for dX alone and one for dW alone
    (the profiler's kernel times of the whole call overlap where dW starts
    beside dX's last tiles); then the grouped matmul's kernels' registers
    and spills."""
    from repro_torch.kernels import _build

    for prod, (K, N) in MOE_KN.items():
        x, w, ids, dy, plan = moe_bwd_inputs(gen, K, N)

        def call():
            return gmm.moe_gmm_bwd(dy, x, w, ids, plan)
        row = {"ms": time_ms(call, flush, reps),
               "kernels_ms": kernel_split(call),
               "ms_alone": {k: time_ms(lambda need=need: gmm.moe_gmm_bwd(
                   dy, x, w, ids, plan, need=need), flush, reps)
                   for k, need in (("dx", (True, False)),
                                   ("dw", (False, True)))}}
        out[f"moe_gmm_bwd[{prod}]"] = row
        del x, w, ids, dy, plan
    out["moe_gmm_kernels"] = {
        k: v for k, v in _build.kernel_report("moe_gmm").items()
        if "wgmma" in k}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=25)
    ap.add_argument("--only", default=",".join(NAMES),
                    help="comma-separated kernels to time, of " +
                    ", ".join(NAMES))
    args = ap.parse_args(argv)
    only = set(args.only.split(","))
    if only - set(NAMES):
        raise SystemExit(f"profile_bwd: unknown --only {only - set(NAMES)}")
    if not torch.cuda.is_available():
        raise SystemExit("profile_bwd: no CUDA device is available")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0])
    flush = torch.empty(64 << 20, dtype=torch.int8, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    out = {"device": torch.cuda.get_device_name(0)}

    if "flash_attention_bwd" in only:
        attention_bwd(out, gen, flush, args.reps)

    if "burst_gather_bwd" in only:
        R = configs.get(ARCH).vocab_padded
        idx = embedding_ids()
        dout = torch.randn((idx.numel(), 4096), generator=gen,
                           device="cuda").bfloat16()

        def gather():
            return bg.burst_gather_bwd(dout, idx, R)
        out["burst_gather_bwd"] = {"ms": time_ms(gather, flush, args.reps),
                                   "kernels_ms": kernel_split(gather)}
        del idx, dout

    for name, fn, inputs in (
            ("mamba2_scan_bwd", m2.mamba2_scan_bwd, mamba2_bwd_inputs),
            ("rwkv6_scan_bwd", r6.rwkv6_scan_bwd, rwkv6_bwd_inputs)):
        if name not in only:
            continue

        def scan(fn=fn, inputs=inputs(gen)):
            return fn(*inputs)
        out[name] = {"ms": time_ms(scan, flush, args.reps),
                     "kernels_ms": kernel_split(scan)}
    if "moe_gmm_bwd" in only:
        moe_bwd(out, gen, flush, args.reps)
    for name, row in out.items():
        if not isinstance(row, dict) or "ms" not in row:
            continue
        parts = ", ".join(f"{k} {v:.4f}" for k, v in
                          row["kernels_ms"].items())
        alone = "".join(f"; {k} alone {v:.4f} ms" for k, v in
                        row.get("ms_alone", {}).items())
        if "sdpa_ms" in row:
            alone += (f"; SDPA backward {row['sdpa_ms']:.4f} ms, bound "
                      f"{row['bound_ms']:.4f} ms ({row['bound_by']}); "
                      f"launches by path {row.get('paths')}")
        print(f"{name}: {row['ms']:.4f} ms a call; by kernel (profiler, "
              f"ms a call): {parts}{alone}")
    for source in ("flash_attention", "moe_gmm"):
        for kernel, r in out.get(f"{source}_kernels", {}).items():
            print(f"ptxas {source}.cu {kernel}: {r.get('registers')} "
                  f"registers, spill stores {r.get('spill_stores')} B, spill "
                  f"loads {r.get('spill_loads')} B, HGMMA {r.get('hgmma')}")
    print(json.dumps(out))


if __name__ == "__main__":
    main()
