"""Model FLOPs of the window's tokens (``pimbench.work.model_flops``:
2 per active parameter a token, attention's 4 q_dim an attended position
a layer) over the window's seconds and the card's int8 peak, in %. A
window holds one phase: a prefill cell's prompt tokens, or a decode
cell's generated tokens over decode-step time (a new job's prefill is
kept off it, its tokens and its seconds alike)."""
from pimbench.work import PEAK_OPS, model_flops


def read(run):
    tokens = sum(s.prompt_tokens if s.kind == "prefill" else s.gen_tokens
                 for s in run.steps)
    attended = sum(s.attended for s in run.steps)
    return (100.0 * model_flops(run.cfg, tokens, attended)
            / run.window_s / PEAK_OPS)
