"""Every token that the window's decode steps generated, over the
window's seconds: decode-step time. A new job's prefill, which runs
between two steps when the last job is done, is kept off both (its token
is not counted, its seconds are not on the clock)."""


def read(run):
    return sum(s.gen_tokens for s in run.steps) / run.window_s
