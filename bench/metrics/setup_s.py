"""Process start to the first timed step: imports, the model built, the
weights and prompts drawn, the PIM schedules compiled or loaded from the
disk cache, and the cell's prefill and decode shapes warmed."""


def read(run):
    return run.setup_s
