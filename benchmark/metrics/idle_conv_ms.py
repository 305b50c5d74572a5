"""``idle_conv_ms``: milliseconds an iteration that the card sat idle while
the host was in the mask net's conv stack (``voicesplit.convs``, every
route; `spans.idle_ms`)."""

from spans import idle_ms


def read(ctx):
    return idle_ms(ctx, ("voicesplit.convs",))
