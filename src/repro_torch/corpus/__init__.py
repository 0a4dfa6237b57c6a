"""Generated design corpus: seeded parametric task graphs + the
differential fuzz harness over the full search stack.

The paper's evidence is 43 hand-written designs; the corpus closes the
scenario-diversity gap (ROADMAP) with *families* of generated graphs —
layered DAGs with reconvergence, control-closed cycles, SDF-rate
annotated streams, wide crossbar-ish fan-outs, and HBM-bound IO designs
whose channel demands exercise the ``hbm_splits`` search axis — each
design a deterministic function of ``(family, seed)`` with a sha256
content fingerprint.  ``run_differential`` pushes a corpus through
analysis -> autobridge -> all simulator backends -> parallel search and
cross-checks every stage against an independent oracle (the table is in
``repro_torch.corpus.differential``).

Counterpart of ``repro.corpus``: the same ``(family, seed)`` gives the
same graph and the same fingerprint in both packages, and the simulator
stages run on ``run_differential``'s ``device`` (default ``"cuda"``).

>>> from repro_torch.corpus import FAMILIES, generate_design, sample_corpus
>>> d = generate_design(7, FAMILIES["dag"])
>>> d.name, len(d.fingerprint)
('dag-00007', 16)
>>> d.fingerprint == generate_design(7, FAMILIES["dag"]).fingerprint
True
>>> batch = sample_corpus("hbm", 4, seed=100)
>>> [b.seed for b in batch]
[100, 101, 102, 103]
>>> any("hbm_channels" in t.area for t in batch[0].graph.tasks.values())
True

Fingerprints track content, not seeds — different seeds, different
graphs:

>>> generate_design(1, FAMILIES["sdf"]).fingerprint != d.fingerprint
True

The fuzz family (and only it) generates broken graphs on purpose; the
differential harness cross-checks the static verdicts against the event
engine on exactly those:

>>> from repro_torch.corpus import run_differential
>>> rep = run_differential(sample_corpus("fuzz", 6), floorplan_limit=0,
...                        device="cpu")
>>> rep.ok, rep.verdicts_checked, rep.sims_checked, rep.torch_checked
(True, 6, 6, 6)
"""
from .spec import CLEAN_FAMILIES, FAMILIES, CorpusSpec
from .generator import (CorpusDesign, generate_design, generate_graph,
                        graph_fingerprint, random_graph, sample_corpus)
from .differential import DifferentialReport, run_differential

__all__ = [
    "CLEAN_FAMILIES", "FAMILIES", "CorpusSpec", "CorpusDesign",
    "generate_design", "generate_graph", "graph_fingerprint",
    "random_graph", "sample_corpus", "DifferentialReport",
    "run_differential",
]
