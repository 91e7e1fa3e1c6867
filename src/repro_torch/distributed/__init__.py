"""Checkpoint/restart and fault tolerance of the training loop
(``repro.distributed``): ``checkpoint.Checkpointer`` and
``fault_tolerance``'s supervisor, elastic plan and straggler policy."""
