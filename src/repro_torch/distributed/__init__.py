"""The models' execution plan: a model as a TAPA task graph, floorplanned
onto a mesh of slots (``taskgraph``, ``sharding``), and replanned when a
slot fails or straggles (``elastic``).  Host only.

Counterpart of the planning half of ``repro/distributed/``; the runtime
that executes a plan over several cards (the reference's ``baseline``,
``pipeline``, ``collectives`` and ``sharding.refined_mesh``) is not ported
yet."""
