"""Share of the training window the driver (``core/train.run_training``)
spends waiting on its own work rather than the card's: the loader's next
batch with its copy queued (``data/loader.device_prefetch``) and the
epoch-top saves (``core/checkpoint.save_checkpoint``), from the benchmark's
host spans around each. The read-back of the previous step's loss waits for
the card's step and is not counted. Unit %."""


def read(facts: dict):
    if not facts.get("steps"):
        return None
    return 100.0 * facts["stall_s"] / facts["window_s"]
