"""Mean host milliseconds of the port's ``loader.stage`` span a batch
(``data/loader.device_prefetch``: the batch put in pinned memory and its
copy to the card queued), over the spans wholly inside the traced window
(``benchmark/program_spans.py``). Unit ms."""

from benchmark import program_spans


def read(facts: dict):
    return program_spans.mean_ms(facts, "loader.stage")
