"""``idle_dsp_ms``: milliseconds an iteration that the card sat idle while
the host was in the DSP front or back (``voicesplit.wav2spec``,
``voicesplit.spec2wav``): the idle intervals' overlap with those spans
(`spans.idle_ms`)."""

from spans import idle_ms


def read(ctx):
    return idle_ms(ctx, ("voicesplit.wav2spec", "voicesplit.spec2wav"))
