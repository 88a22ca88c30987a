"""Multi-device layer: the (data, fsdp, tensor) mesh, parameter placements
and the gathers that read them, and the spawn helper for CPU process groups."""
