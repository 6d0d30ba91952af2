"""The PIM linear calls' share of their roofline in the profiled
segment, in %: the sum over calls of the least time the card could take
(``pimbench.work``: ops at the int8 peak or bytes at the HBM peak,
whichever is longer) over the sum of their device time."""
from pimbench.work import bound_s, linear_work, ragged_work


def read(run):
    t = run.trace
    if t is None or len(run.calls) != len(t.pim_call_s):
        return None
    bound = 0.0
    for (kind, rows, k, n, bits, counts) in run.calls:
        work = (linear_work(rows, k, n, bits) if kind == "linear"
                else ragged_work(counts, k, n, bits))
        bound += bound_s(*work)
    spent = sum(t.pim_call_s)
    return 100.0 * bound / spent if spent else None
