"""The models' execution plan and the runtime that executes it.

The plan: a model as a TAPA task graph, floorplanned onto a mesh of slots
(``taskgraph``, ``sharding``), and replanned when a slot fails or
straggles (``elastic``), on the host.  The runtime, on
``torch.distributed`` (NCCL on the card, gloo on the CPU): the ranks laid
out as (stage, data, tp) by the floorplan (``sharding.refined_mesh``), the
GSPMD-style baseline (``baseline``: tensor parallel over the whole model
axis, ZeRO-1 data parallel), the floorplanned pipeline (``pipeline``),
Megatron-style tensor-parallel layers (``tensor_parallel``) and the
collectives they share (``collectives``).  The step builders are in
``repro_torch.launch.steps``.

Counterpart of ``repro/distributed/``.  Tensor parallelism covers the G
and L layers; the other layer kinds, MoE experts and whisper's encoder
under tp > 1, the context-parallel cache and Adafactor across data ranks
or stages raise, naming ROADMAP item 8c."""
