"""Host seconds of the set-up's ``fit_bins`` (binning layer)."""


def read(ctx):
    return sum(ctx.spans.durations("fit_bins")) or None
