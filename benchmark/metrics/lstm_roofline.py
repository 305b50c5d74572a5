"""``lstm_roofline``: the LSTM kernels' share of their roofline.

`costs.lstm_bound` of the iteration's walks (and `costs.lstm_bwd_bound` in
training), times the iterations, over the device time of the kernels whose
names hold ``lstm``, in percent.  Nothing to read where none ran."""


def read(ctx):
    lstm_s = ctx.trace.seconds_by_kind().get("lstm", 0.0) if ctx.trace is not None else 0.0
    if lstm_s <= 0.0:
        return None
    return 100.0 * ctx.lstm_bound_ms * 1e-3 * ctx.iterations / lstm_s
