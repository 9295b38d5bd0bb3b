"""Mean milliseconds of the port's ``loader.decode`` span a batch
(``data/loader.ClipLoader``'s decode threads: one batch's clips read and
stacked), over all threads and the spans wholly inside the traced window
(``benchmark/program_spans.py``). Unit ms."""

from benchmark import program_spans


def read(facts: dict):
    return program_spans.mean_ms(facts, "loader.decode")
