"""Data-parallel training: the ``data`` axis of the mesh (``mesh.py``) and
the collectives the train step, the loss and the loop need
(``collectives.py``), over a ``torch.distributed`` process group: NCCL on
the card, gloo on the CPU, one process per device, launched by
``torchrun``."""
