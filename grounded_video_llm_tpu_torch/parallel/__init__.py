"""Multi-device layer: the (data, fsdp, tensor) mesh, parameter placements
and the gathers that read them, the tensor axis's split products, and the
spawn helper for CPU process groups."""
