"""Mean host milliseconds of the port's ``save.join`` span a save
(``core/checkpoint.save_checkpoint`` with the training driver's
``CheckpointWriter``: the wait for the previous save's write on the
writer's thread before this save gathers the state; its attr ``waited``
says whether that write was still running), over the saves wholly inside
the traced window (``benchmark/program_spans.py``). A port that writes its
saves on the main thread records no such span: nothing to read. Unit ms."""

from benchmark import program_spans


def read(facts: dict):
    return program_spans.mean_ms(facts, "save.join")
