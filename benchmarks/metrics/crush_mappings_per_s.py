"""crush_mappings_per_s: placement groups whose up set was computed, over
every epoch of the window (which closes when the epoch under way at
--seconds completes), over the window's seconds."""


def read(run):
    return run.rate() if run.op == "remap" and run.requests else None
