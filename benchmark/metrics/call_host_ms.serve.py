"""Mean host milliseconds of the port's ``serve.call`` span
(``cli/export.load_exported``'s serving call: the graph's replay and the
output's clone queued), over the calls wholly inside the traced window
(``benchmark/program_spans.py``). Unit ms."""

from benchmark import program_spans


def read(facts: dict):
    return program_spans.mean_ms(facts, "serve.call")
