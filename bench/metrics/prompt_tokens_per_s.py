"""Every prompt token of every job whose prefill ran in the window and
that completed in it, over the window's seconds."""


def read(run):
    jobs = run.window_jobs()
    if not jobs:
        return None
    return sum(j.prompts.numel() for j in jobs) / run.window_s
