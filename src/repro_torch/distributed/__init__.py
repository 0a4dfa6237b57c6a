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

Counterpart of ``repro/distributed/``.  Tensor parallelism covers every
layer kind, MoE experts (by expert or by the FFN dim) and whisper's
encoder, and splits an attention whose heads do not divide over a divisor
of tp; serving keeps the KV cache split by heads or by its length."""
