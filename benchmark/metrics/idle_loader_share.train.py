"""Share of the traced training window in which the card was idle while the
main thread's innermost program span was the loader's: ``loader.wait``
(``data/loader.ClipLoader``: the head batch not decoded yet) or
``loader.stage`` (``data/loader.device_prefetch``: one batch's pinned
staging and its copy queued), from the port's own spans
(``benchmark/program_spans.py``). Unit %."""

from benchmark import program_spans


def read(facts: dict):
    return program_spans.idle_share(facts, ("loader.wait", "loader.stage"))
