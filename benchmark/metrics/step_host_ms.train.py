"""Mean host milliseconds of the port's ``train.step`` span
(``core/train.run_training`` around the step: the draws, the plan, the
table's copy, the graph's replay and the scalars' clones), over the steps
wholly inside the traced window (``benchmark/program_spans.py``). Unit ms."""

from benchmark import program_spans


def read(facts: dict):
    return program_spans.mean_ms(facts, "train.step")
