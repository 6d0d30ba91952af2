"""Small crossbar tables shared by the port's kernel tests, as dense
numpy tables ``(gate_id, in_cols, out_col, init_mask)``; column C - 1
is the scratch column, which NOP slots name. Each test file builds its
own package's packed program from them."""
import numpy as np


def held_table(dup: bool = False):
    """Random gates over 60 columns whose cycles read columns they write
    (the kernels' held path); with ``dup``, cycle 0's first two ops are
    NORs that write one column (a cycle ANDs both writes)."""
    rng = np.random.default_rng(3)
    t, m, c = 40, 12, 60
    gate = rng.integers(0, 7, (t, m)).astype(np.int32)
    ins = rng.integers(0, c - 1, (t, m, 3)).astype(np.int32)
    out = np.stack([rng.permutation(c - 1)[:m] for _ in range(t)]
                   ).astype(np.int32)
    out[gate == 0] = c - 1
    init = rng.random((t, c)) < 0.05
    init[:, c - 1] = False
    if dup:
        gate[0, :2] = 2                           # NOR, NOR
        out[0, 1] = out[0, 0]
    return gate, ins, out, init


def dup_write_table():
    """Two NOTs in one cycle read columns 0 and 1 and both write column
    2; column 3 is the scratch column."""
    ins = np.full((1, 2, 3), 3, np.int32)
    ins[0, :, 0] = [0, 1]
    return (np.full((1, 2), 1, np.int32), ins, np.array([[2, 2]], np.int32),
            np.zeros((1, 4), bool))


def random_dup_table(seed: int):
    """Random gates over 24 columns whose outputs fall in 8 columns, so
    most cycles write some column twice (and read columns they write)."""
    rng = np.random.default_rng(seed)
    t, m, c = 30, 10, 24
    gate = rng.integers(0, 7, (t, m)).astype(np.int32)
    ins = rng.integers(0, c - 1, (t, m, 3)).astype(np.int32)
    out = rng.integers(0, 8, (t, m)).astype(np.int32)
    out[gate == 0] = c - 1
    init = rng.random((t, c)) < 0.05
    init[:, c - 1] = False
    return gate, ins, out, init
