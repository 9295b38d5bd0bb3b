"""The training window's clip rate outside the driver's own stalls: clips
stepped, over the window's seconds less the loader waits and epoch-top saves
that ``driver_stall_share.train`` counts. It follows the step on the card
and its host dispatch, and leaves out the host's data path, whose speed
moves with the host's other load from run to run. Unit clips/s."""


def read(facts: dict):
    if not facts.get("steps") or not facts.get("clips"):
        return None
    return facts["clips"] / (facts["window_s"] - facts["stall_s"])
