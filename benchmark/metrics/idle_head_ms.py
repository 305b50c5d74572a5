"""``idle_head_ms``: milliseconds an iteration that the card sat idle while
the host was in the mask head (``voicesplit.head``: the d-vector concat,
the LSTM, the FCs and the sigmoid; `spans.idle_ms`)."""

from spans import idle_ms


def read(ctx):
    return idle_ms(ctx, ("voicesplit.head",))
