"""Every token generated in the window (every sequence: a prefill's
first token and a decode step's each), over the window's seconds; a
prefill that falls in the window counts its time."""


def read(run):
    return sum(s.gen_tokens for s in run.steps) / run.window_s
