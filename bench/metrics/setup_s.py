"""Process start to the first timed step: imports, the model built, the
weights and prompts drawn, the PIM schedules compiled or loaded from the
disk cache, and the shapes of the cell's traffic warmed (the first job's
prefill, and one decode step where a job has them)."""


def read(run):
    return run.setup_s
