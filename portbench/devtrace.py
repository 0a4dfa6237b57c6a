"""The traced window's arithmetic, from ``torch.profiler``'s events.

Replaces the sums of ``repro_torch/launch/profile_serve.py::_report``,
which added kernels' device times over the wall time of the profiled
region: overlapping kernels counted twice there, and the profiler's
recording of every host op stretched the region (granite-moe's step
0.54 s untraced, 0.87 s so traced).  Here the device is busy where the
union of its operations' intervals lies, and ``profile`` records the
device alone (``host=False``: CUDA activity, whose runtime calls mark the
window) for every number, and the host's ops (``host=True``) only to name
the idle gaps of a separate step.

- ``busy_s``: the union of the device's operations (kernels, copies,
  fills) inside the window;
- ``device_ops``: seconds by operation name, the sum of its intervals;
- ``idle_gaps``: the window's stretches that no device operation covers,
  each named by the innermost host operation open over its middle.
"""
from __future__ import annotations

import dataclasses

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile as _profile
from torch.profiler import record_function

#: the annotation around the traced work; the benchmark's annotations all
#: start with "portbench." (their mirrors on the device are no operation)
WINDOW = "portbench.window"


@dataclasses.dataclass
class Op:
    name: str
    start: int          # ns
    end: int

    @property
    def s(self) -> float:
        return (self.end - self.start) * 1e-9


@dataclasses.dataclass
class Trace:
    device: list[Op]     # every device operation inside the window
    host: list[Op]       # every host operation (and annotation)
    start: int
    end: int
    units: int           # steps or calls traced

    @property
    def span_s(self) -> float:
        return (self.end - self.start) * 1e-9

    def kernels(self) -> list[Op]:
        """The device operations that are kernel launches (not copies or
        fills)."""
        return [o for o in self.device
                if not o.name.startswith(("Memcpy", "Memset"))]

    def busy(self) -> list[tuple[int, int]]:
        """The union of the device operations' intervals, in order."""
        merged: list[list[int]] = []
        for o in sorted(self.device, key=lambda o: o.start):
            a, b = max(o.start, self.start), min(o.end, self.end)
            if b <= a:
                continue
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        return [(a, b) for a, b in merged]

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy()) * 1e-9

    def gaps(self) -> list[tuple[int, int]]:
        out, t = [], self.start
        for a, b in self.busy():
            if a > t:
                out.append((t, a))
            t = max(t, b)
        if self.end > t:
            out.append((t, self.end))
        return out

    def host_at(self, t: int) -> str:
        """The innermost host operation open at ``t``."""
        open_ = [o for o in self.host if o.start <= t <= o.end]
        if not open_:
            return "(no host op)"
        return max(open_, key=lambda o: (o.start, -o.end)).name

    def device_ops(self, top: int = 10) -> list[list]:
        total: dict[str, float] = {}
        for o in self.device:
            total[o.name] = total.get(o.name, 0.0) + o.s
        return [[n, s] for n, s in sorted(total.items(),
                                          key=lambda kv: -kv[1])[:top]]

    def idle_gaps(self, top: int = 10) -> list[list]:
        longest = sorted(self.gaps(), key=lambda g: g[0] - g[1])[:top]
        return [[self.host_at((a + b) // 2), (b - a) * 1e-9]
                for a, b in longest]

    def time_of(self, match) -> tuple[float, int]:
        """(seconds, launches) of the kernels whose name ``match`` takes."""
        ks = [o for o in self.kernels() if match(o.name)]
        return sum(o.s for o in ks), len(ks)


#: the runtime call ``torch.cuda.synchronize`` makes; ``profile`` makes one
#: at each end of the window
SYNC = "cudaDeviceSynchronize"


def collect(prof, units: int) -> Trace:
    """The Trace of a finished ``torch.profiler.profile`` of ``profile``'s
    window: the ``WINDOW`` annotation where the host's ops were recorded,
    else from the end of its first ``SYNC`` to the end of its last."""
    device, host, window, syncs = [], [], None, []
    for e in prof.profiler.kineto_results.events():
        op = Op(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
        if e.device_type() == DeviceType.CPU:
            host.append(op)
            if op.name == WINDOW:
                window = op
            elif op.name == SYNC:
                syncs.append(op)
        elif not (op.name.startswith("portbench.")
                  or getattr(e, "is_user_annotation", lambda: False)()):
            device.append(op)
    if window is None and len(syncs) >= 2:
        syncs.sort(key=lambda o: o.end)
        window = Op(WINDOW, syncs[0].end, syncs[-1].end)
    if window is None:
        raise RuntimeError(f"the trace marks no window ({WINDOW}, {SYNC})")
    device = [o for o in device
              if o.end > window.start and o.start < window.end]
    return Trace(device, host, window.start, window.end, units)


def profile(fn, units: int, device, *, host: bool) -> Trace:
    """``fn(i)`` for i < ``units`` under ``torch.profiler``, between two
    synchronizes.  On a card it records the device's operations and the
    runtime's calls, and with ``host`` every host op too; on the CPU the
    host's ops."""
    cuda = device.type == "cuda"
    acts = [ProfilerActivity.CUDA] if cuda else []
    if host or not cuda:
        acts.append(ProfilerActivity.CPU)

    def sync():
        if cuda:
            torch.cuda.synchronize(device)

    sync()
    with _profile(activities=acts) as prof:
        with record_function(WINDOW):
            sync()
            for i in range(units):
                with record_function("portbench.unit"):
                    fn(i)
            sync()
    return collect(prof, units)
