"""Data- and tensor-parallel training: the (data × model) mesh, its groups
and the model axis's sharding rule (``mesh.py``), and the collectives the
layers, the train step, the loss and the loop need (``collectives.py``),
over a ``torch.distributed`` process group: NCCL on the card, gloo on the
CPU, one process per device, launched by ``torchrun``."""
