"""Mean host milliseconds of the port's ``save.gather`` span a save
(``core/checkpoint.save_checkpoint``: the collectives and the state copied
to the host, after the queued step, before the file is written), over the
saves wholly inside the traced window (``benchmark/program_spans.py``).
Unit ms."""

from benchmark import program_spans


def read(facts: dict):
    return program_spans.mean_ms(facts, "save.gather")
