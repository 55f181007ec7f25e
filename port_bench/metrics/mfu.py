"""The whole step's share of the card's bf16 peak, %: the model FLOPs of
the work one unit (frame, image) takes, counted on the reference by
`FlopCounterMode`, times the units a second of the traced run's window,
over the card's dense bf16 rate (`work.PEAKS`)."""


def read(ctx):
    c, p = ctx.counters, ctx.peaks
    if p is None or c.model_flops_per_unit <= 0 or c.units_per_s <= 0:
        return None
    return 100.0 * c.model_flops_per_unit * c.units_per_s / p.bf16
