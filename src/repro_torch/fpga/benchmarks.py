"""The paper's benchmark suite as TAPA task graphs (§7.2, Fig. 11).

Six AutoBridge families (stencil chain, CNN grid, Gaussian triangle, bucket
sort crossbars, page-rank with cycles, genome broadcast) swept over size x
{U250, U280} = 43 designs, plus the four §7.4 HBM designs (SASA-1/2, SpMM,
SpMV_A16/A24).

Module areas are reverse-calibrated from the paper's utilization tables
(Tables 4-9) so the generated designs occupy the same device fractions.  IO
module areas are the paper's Table 3 measurements:

    mmap (Vitis default):  LUT 1189, FF 3740, BRAM 15
    async_mmap (TAPA §3.4): LUT 1466, FF  162, BRAM  0
"""
from __future__ import annotations

from repro_torch.core import TaskGraph, TaskGraphBuilder

MMAP_IO = {"LUT": 1189.0, "FF": 3740.0, "BRAM": 15.0}
ASYNC_IO = {"LUT": 1466.0, "FF": 162.0, "BRAM": 0.0}


def _io_area(use_async: bool, hbm: bool = False) -> dict[str, float]:
    a = dict(ASYNC_IO if use_async else MMAP_IO)
    if hbm:
        a["hbm_channels"] = 1.0
    else:
        a["ddr_channels"] = 1.0
    return a


# ---------------------------------------------------------------------------
# SODA stencil: linear chain of large kernels (Fig. 11 top-left)
# ---------------------------------------------------------------------------

def stencil(n_kernels: int, use_async: bool = False) -> TaskGraph:
    """Each kernel uses ~half the resources of a slot (paper §7.3)."""
    b = TaskGraphBuilder(f"stencil_x{n_kernels}")
    kern = {"LUT": 100e3, "FF": 150e3, "BRAM": 180.0, "DSP": 288.0}
    b.stream("ld", width=512)
    for i in range(n_kernels - 1):
        b.stream(f"k{i}", width=512)
    b.stream("st", width=512)
    b.invoke("Load", area=_io_area(use_async), outs=["ld"])
    for i in range(n_kernels):
        ins = ["ld"] if i == 0 else [f"k{i-1}"]
        outs = ["st"] if i == n_kernels - 1 else [f"k{i}"]
        b.invoke(f"Kernel{i}", area=dict(kern), ins=ins, outs=outs)
    b.invoke("Store", area=_io_area(use_async), ins=["st"])
    return b.build()


# ---------------------------------------------------------------------------
# PolySA CNN: 13 x N systolic grid (Fig. 11; Tables 4, 11)
# ---------------------------------------------------------------------------

def cnn(n_cols: int, n_rows: int = 13, use_async: bool = False) -> TaskGraph:
    """Grid of PEs + local drains, double row-feeder chains, column feeders
    and drains; 3 DDR IO modules + 2 controllers.  13x2 -> 87 modules / ~141
    streams, matching Table 11's vertex/edge counts."""
    b = TaskGraphBuilder(f"cnn_{n_rows}x{n_cols}")
    PE = {"LUT": 2950.0, "FF": 5200.0, "BRAM": 4.0, "DSP": 40.0}
    LD = {"LUT": 700.0, "FF": 1200.0, "BRAM": 2.0}
    RF = {"LUT": 7600.0, "FF": 14000.0, "BRAM": 30.0}
    CF = {"LUT": 1500.0, "FF": 2500.0, "BRAM": 16.0}
    CTRL = {"LUT": 1000.0, "FF": 1500.0}

    def S(name, width=256):
        b.stream(name, width=width)
        return name

    # IO + controllers
    b.invoke("A_load", area=_io_area(use_async), outs=[S("a_bus", 512)])
    b.invoke("B_load", area=_io_area(use_async), outs=[S("b_bus", 512)])
    b.invoke("C_store", area=_io_area(use_async), ins=[S("c_bus", 512)])
    b.invoke("ctrl0", area=dict(CTRL), outs=[S("cmd0", 32)])
    b.invoke("ctrl1", area=dict(CTRL), ins=[S("st0", 32)])

    # double row-feeder chains down the 13 rows
    prev = "a_bus"
    for r in range(n_rows):
        nxt = S(f"rf{r}", 512) if r < n_rows - 1 else None
        outs = [S(f"a{r}", 256)] + ([nxt] if nxt else [])
        b.invoke(f"RFa_{r}", area=dict(RF), ins=[prev], outs=outs)
        prev = nxt
    prev = "cmd0"
    for r in range(n_rows):
        nxt = S(f"rg{r}", 64) if r < n_rows - 1 else S("gtail", 32)
        outs = [S(f"g{r}", 64), nxt]
        b.invoke(f"RFb_{r}", area=dict(RF), ins=[prev], outs=outs)
        prev = nxt

    # column feeders (B) chained off b_bus, column drains chained into c_bus
    prevb = "b_bus"
    for c in range(n_cols):
        nxtb = S(f"cfb{c}", 512) if c < n_cols - 1 else None
        outs = [S(f"b{c}", 256)] + ([nxtb] if nxtb else [])
        b.invoke(f"CF_{c}", area=dict(CF), ins=[prevb], outs=outs)
        prevb = nxtb
    for c in range(n_cols):
        ins = [S(f"d{c}", 256)]
        if c > 0:
            ins.append(f"dc{c-1}")
        outs = [S(f"dc{c}", 512)] if c < n_cols - 1 else ["c_bus"]
        b.invoke(f"CD_{c}", area=dict(CF), ins=ins, outs=outs)

    # the PE grid: A flows right, B flows down, results drain via LDs
    for r in range(n_rows):
        for c in range(n_cols):
            ins = [f"a{r}" if c == 0 else f"ah_{r}_{c-1}",
                   f"b{c}" if r == 0 else f"bv_{r-1}_{c}"]
            if c == 0:
                ins.append(f"g{r}")   # per-row command lane
            outs = []
            if c < n_cols - 1:
                outs.append(S(f"ah_{r}_{c}", 256))
            if r < n_rows - 1:
                outs.append(S(f"bv_{r}_{c}", 256))
            outs.append(S(f"pd_{r}_{c}", 256))
            b.invoke(f"PE_{r}_{c}", area=dict(PE), ins=ins, outs=outs)
            # local drain chain: LD[r,c] joins PE output with drain from above
            ld_ins = [f"pd_{r}_{c}"]
            if r > 0:
                ld_ins.append(f"ldv_{r-1}_{c}")
            ld_out = S(f"ldv_{r}_{c}", 256) if r < n_rows - 1 else f"d{c}"
            b.invoke(f"LD_{r}_{c}", area=dict(LD), ins=ld_ins, outs=[ld_out])

    # status chain terminates in ctrl1
    b.invoke("status", area=dict(CTRL), ins=["gtail"], outs=["st0"])
    return b.build()


# ---------------------------------------------------------------------------
# AutoSA Gaussian elimination: triangular PE array (Fig. 11; Table 5)
# ---------------------------------------------------------------------------

def gaussian(n: int, use_async: bool = False) -> TaskGraph:
    b = TaskGraphBuilder(f"gaussian_{n}x{n}")
    PE = {"LUT": 2660.0, "FF": 3400.0, "DSP": 4.5}
    MEM = {"LUT": 5000.0, "FF": 9000.0, "BRAM": 28.0}

    def S(name, width=256):
        b.stream(name, width=width)
        return name

    # fixed memory/feed infrastructure (BRAM-heavy, ~constant across sizes,
    # Table 5 shows BRAM pinned at 13.24%)
    b.invoke("Load", area=_io_area(use_async), outs=[S("feed_bus", 512)])
    b.invoke("Store", area=_io_area(use_async), ins=[S("drain_bus", 512)])
    prev = "feed_bus"
    n_mem = 22
    for i in range(n_mem):
        nxt = S(f"mem{i}", 512) if i < n_mem - 1 else S("mem_tail", 64)
        outs = [nxt] + ([S(f"mf{i}", 256)] if i < n else [])
        b.invoke(f"Mem_{i}", area=dict(MEM), ins=[prev], outs=outs)
        prev = nxt
    b.invoke("MemSink", area={"LUT": 200.0}, ins=["mem_tail"])

    # upper-triangular PE array: PE(i,j), 0 <= i <= j < n
    drains = []
    for i in range(n):
        for j in range(i, n):
            ins = []
            if j == i:   # diagonal fed by mem feeders (mf_i for i < n_mem)
                ins.append(f"mf{i}" if i < n_mem else S(f"xf{i}", 256))
                if i >= n_mem:
                    b.invoke(f"XF_{i}", area=dict(MEM), outs=[f"xf{i}"])
            else:
                ins.append(f"gr_{i}_{j-1}")
            if i > 0:
                ins.append(f"gd_{i-1}_{j}")
            outs = []
            if j < n - 1:
                outs.append(S(f"gr_{i}_{j}", 256))
            if i < n - 1 and j > i:
                outs.append(S(f"gd_{i}_{j}", 256))
            if j == n - 1:
                outs.append(S(f"dr_{i}", 256))
                drains.append(f"dr_{i}")
            b.invoke(f"PE_{i}_{j}", area=dict(PE), ins=ins, outs=outs)

    # drain collector chain
    prev = None
    for i, d in enumerate(drains):
        ins = [d] + ([prev] if prev else [])
        out = S(f"dchain{i}", 512) if i < len(drains) - 1 else "drain_bus"
        b.invoke(f"DR_{i}", area={"LUT": 600.0, "FF": 900.0}, ins=ins,
                 outs=[out])
        prev = f"dchain{i}" if i < len(drains) - 1 else None
    return b.build()


# ---------------------------------------------------------------------------
# HBM bucket sort: two fully-connected 8x8 crossbars (Fig. 11; Table 6)
# ---------------------------------------------------------------------------

def bucket_sort(use_async: bool = False) -> TaskGraph:
    b = TaskGraphBuilder("bucket_sort")
    DEC = {"LUT": 13600.0, "FF": 15000.0, "BRAM": 8.0}
    SORT = {"LUT": 16600.0, "FF": 18000.0, "BRAM": 40.0, "DSP": 0.5}
    MRG = {"LUT": 13600.0, "FF": 14000.0, "BRAM": 8.0}

    def S(name, width=256):
        b.stream(name, width=width)
        return name

    for i in range(8):
        b.invoke("In", area=_io_area(use_async, hbm=True),
                 outs=[S(f"in{i}", 512)])
        b.invoke("Dec", area=dict(DEC), ins=[f"in{i}"],
                 outs=[S(f"x1_{i}_{j}") for j in range(8)])
    for j in range(8):
        b.invoke("Sort", area=dict(SORT), ins=[f"x1_{i}_{j}" for i in range(8)],
                 outs=[S(f"x2_{j}_{k}") for k in range(8)])
    for k in range(8):
        b.invoke("Mrg", area=dict(MRG), ins=[f"x2_{j}_{k}" for j in range(8)],
                 outs=[S(f"out{k}", 512)])
        b.invoke("Out", area=_io_area(use_async, hbm=True), ins=[f"out{k}"])
    return b.build()


# ---------------------------------------------------------------------------
# HBM page rank: 8 PUs + central controller, with dependency cycles
# (Fig. 11; Table 7)
# ---------------------------------------------------------------------------

def page_rank(use_async: bool = False) -> TaskGraph:
    b = TaskGraphBuilder("page_rank")
    GATH = {"LUT": 26000.0, "FF": 30000.0, "BRAM": 40.0, "DSP": 70.0}
    APPL = {"LUT": 28000.0, "FF": 34000.0, "BRAM": 50.0, "DSP": 85.0}
    CTRL = {"LUT": 46000.0, "FF": 56000.0, "BRAM": 60.0, "DSP": 60.0}

    def S(name, width=256):
        b.stream(name, width=width)
        return name

    # central controller with 5 HBM ports
    ctrl_ins, ctrl_outs = [], []
    for p in range(5):
        b.invoke("CtrlIO", area=_io_area(use_async, hbm=True),
                 outs=[S(f"cio{p}", 512)])
        ctrl_ins.append(f"cio{p}")
    for i in range(8):
        # command/status handshakes are per-iteration control, not
        # per-token dataflow: latency-tolerant (closes the dependency cycle)
        b.stream(f"cmd{i}", width=64, control=True)
        b.stream(f"stat{i}", width=64, control=True)
        ctrl_outs.append(f"cmd{i}")
        ctrl_ins.append(f"stat{i}")
    b.invoke("Ctrl", area=dict(CTRL), ins=ctrl_ins, outs=ctrl_outs)

    for i in range(8):
        b.invoke("PuIO_a", area=_io_area(use_async, hbm=True),
                 outs=[S(f"pa{i}", 512)])
        b.invoke("PuIO_b", area=_io_area(use_async, hbm=True),
                 outs=[S(f"pb{i}", 512)])
        b.invoke("Gather", area=dict(GATH),
                 ins=[f"pa{i}", f"cmd{i}"], outs=[S(f"gu{i}", 512)])
        # Apply reports status back to Ctrl: the dependency cycle
        b.invoke("Apply", area=dict(APPL),
                 ins=[f"gu{i}", f"pb{i}"], outs=[f"stat{i}"])
    return b.build()


# ---------------------------------------------------------------------------
# Genome sequencing (Minimap2 overlapping): broadcast topology (Fig. 11)
# ---------------------------------------------------------------------------

def genome(n_pe: int = 24, use_async: bool = False) -> TaskGraph:
    b = TaskGraphBuilder(f"genome_x{n_pe}")
    PE = {"LUT": 26000.0, "FF": 34000.0, "BRAM": 44.0, "DSP": 110.0}
    DIST = {"LUT": 9000.0, "FF": 12000.0, "BRAM": 30.0}

    def S(name, width=512):
        b.stream(name, width=width)
        return name

    b.invoke("Load", area=_io_area(use_async), outs=[S("in_bus")])
    b.invoke("Dist", area=dict(DIST), ins=["in_bus"],
             outs=[S(f"bc{i}") for i in range(n_pe)])
    b.invoke("Coll", area=dict(DIST), ins=[S(f"res{i}") for i in range(n_pe)],
             outs=[S("out_bus")])
    b.invoke("Store", area=_io_area(use_async), ins=["out_bus"])
    for i in range(n_pe):
        b.invoke("PE", area=dict(PE), ins=[f"bc{i}"], outs=[f"res{i}"])
    return b.build()


# ---------------------------------------------------------------------------
# §7.4 HBM designs: SASA stencil, SpMM, SpMV
# ---------------------------------------------------------------------------

def sasa(version: int, use_async: bool = True) -> TaskGraph:
    """Hybrid spatial/temporal stencil over many HBM channels; v1 = 24
    channels (12 tiles), v2 = 27 channels (13 tiles + halo unit)."""
    n_tiles = 12 if version == 1 else 13
    b = TaskGraphBuilder(f"sasa_v{version}")
    KERN = ({"LUT": 32000.0, "FF": 42000.0, "DSP": 130.0} if version == 1
            else {"LUT": 32500.0, "FF": 48000.0, "DSP": 330.0})

    def S(name, width=512):
        b.stream(name, width=width)
        return name

    for i in range(n_tiles):
        b.invoke("In", area=_io_area(use_async, hbm=True), outs=[S(f"i{i}")])
        ins = [f"i{i}"]
        if i > 0:
            ins.append(f"halo{i-1}")
        outs = [S(f"o{i}")]
        if i < n_tiles - 1:
            outs.append(S(f"halo{i}", 256))
        b.invoke("Kern", area=dict(KERN), ins=ins, outs=outs)
        b.invoke("Out", area=_io_area(use_async, hbm=True), ins=[f"o{i}"])
    if version == 2:
        b.invoke("HaloIO", area=_io_area(use_async, hbm=True),
                 outs=[S("hx", 256)])
        b.invoke("HaloUnit", area={"LUT": 8000.0, "FF": 10000.0},
                 ins=["hx"], outs=[S("hy", 256)])
        b.invoke("HaloSink", area={"LUT": 2000.0}, ins=["hy"])
    return b.build()


def spmm(use_async: bool = True) -> TaskGraph:
    """Sextans SpMM: 29 HBM channels, URAM-heavy (Table 8)."""
    b = TaskGraphBuilder("spmm")
    PEG = {"LUT": 52000.0, "FF": 60000.0, "BRAM": 306.0, "URAM": 64.0,
           "DSP": 462.0}

    def S(name, width=512):
        b.stream(name, width=width)
        return name

    # 24 sparse-A channels feeding 8 PE groups, 2 dense-B, 2 C, 1 ctrl
    for g in range(8):
        S(f"bb{g}", 512)   # dense-B broadcast lanes (produced by BCast)
    for g in range(8):
        ins = []
        for k in range(3):
            b.invoke("AIn", area=_io_area(use_async, hbm=True),
                     outs=[S(f"a{g}_{k}")])
            ins.append(f"a{g}_{k}")
        b.invoke("PEG", area=dict(PEG), ins=ins + [f"bb{g}"],
                 outs=[S(f"c{g}")])
    for j in range(2):
        b.invoke("BIn", area=_io_area(use_async, hbm=True),
                 outs=[S(f"b{j}")])
        b.invoke("BCast", area={"LUT": 6000.0, "FF": 8000.0},
                 ins=[f"b{j}"], outs=[f"bb{4*j+i}" for i in range(4)])
    for j in range(2):
        b.invoke("CMerge", area={"LUT": 9000.0, "FF": 12000.0},
                 ins=[f"c{4*j+i}" for i in range(4)], outs=[S(f"cm{j}")])
        b.invoke("COut", area=_io_area(use_async, hbm=True), ins=[f"cm{j}"])
    b.invoke("CtrlIO", area=_io_area(use_async, hbm=True), outs=[S("ct", 64)])
    b.invoke("Ctrl", area={"LUT": 4000.0}, ins=["ct"])
    return b.build()


def spmv(n_ch: int, use_async: bool = True) -> TaskGraph:
    """Serpens SpMV: A16 = 20 channels, A24 = 28 channels (Table 8)."""
    n_a = 16 if n_ch == 20 else 24
    b = TaskGraphBuilder(f"spmv_a{n_a}")
    PE = {"LUT": 13000.0, "FF": 16000.0, "BRAM": 80.0, "URAM": 16.0,
          "DSP": 46.0}

    def S(name, width=512):
        b.stream(name, width=width)
        return name

    for i in range(n_a):
        S(f"xb{i}", 256)   # x broadcast lanes (produced by XBcast)
    for i in range(n_a):
        b.invoke("AIn", area=_io_area(use_async, hbm=True), outs=[S(f"a{i}")])
        b.invoke("PE", area=dict(PE), ins=[f"a{i}", f"xb{i}"],
                 outs=[S(f"y{i}", 256)])
    b.invoke("XIn", area=_io_area(use_async, hbm=True), outs=[S("x", 512)])
    b.invoke("XBcast", area={"LUT": 7000.0, "FF": 9000.0}, ins=["x"],
             outs=[f"xb{i}" for i in range(n_a)])
    # adder tree into 3 result channels
    b.invoke("Tree", area={"LUT": 12000.0, "FF": 16000.0, "DSP": 64.0},
             ins=[f"y{i}" for i in range(n_a)],
             outs=[S(f"r{j}") for j in range(3)])
    for j in range(3):
        b.invoke("YOut", area=_io_area(use_async, hbm=True), ins=[f"r{j}"])
    return b.build()


# ---------------------------------------------------------------------------
# suites
# ---------------------------------------------------------------------------

def autobridge_suite() -> list[tuple[str, str, TaskGraph]]:
    """The 43 designs of §7.3: (name, board, graph)."""
    out = []
    for k in range(1, 9):
        out.append((f"stencil_x{k}", "u250", stencil(k)))
        out.append((f"stencil_x{k}", "u280", stencil(k)))
    for n in (2, 4, 6, 8, 10, 12, 14, 16):
        out.append((f"cnn_13x{n}", "u250", cnn(n)))
        out.append((f"cnn_13x{n}", "u280", cnn(n)))
    for n in (12, 16, 20, 24):
        out.append((f"gaussian_{n}", "u250", gaussian(n)))
        out.append((f"gaussian_{n}", "u280", gaussian(n)))
    out.append(("bucket_sort", "u280", bucket_sort()))
    out.append(("page_rank", "u280", page_rank()))
    out.append(("genome_x24", "u250", genome(24)))
    return out


def hbm_suite(use_async: bool = True) -> list[tuple[str, str, TaskGraph]]:
    """The §7.4 HBM designs (always U280)."""
    return [
        ("sasa_v1", "u280", sasa(1, use_async)),
        ("sasa_v2", "u280", sasa(2, use_async)),
        ("spmm", "u280", spmm(use_async)),
        ("spmv_a16", "u280", spmv(20, use_async)),
        ("spmv_a24", "u280", spmv(28, use_async)),
    ]
