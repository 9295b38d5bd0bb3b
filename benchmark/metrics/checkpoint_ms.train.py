"""Mean host milliseconds of the epoch-top saves (``core/checkpoint.
save_checkpoint``) that fall inside the training window, from the
benchmark's host span around each save. Nothing to read without a save in
the window."""


def read(facts: dict):
    saves = facts.get("saves_ms") or []
    return sum(saves) / len(saves) if saves else None
