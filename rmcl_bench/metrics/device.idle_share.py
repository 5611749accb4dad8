"""Share of the traced stretch in which the card ran no operation, in %;
on several cards the mean of the cards. Device trace."""

from rmcl_bench.metrics_common import idle_share


def read(ctx):
    return idle_share(ctx)
