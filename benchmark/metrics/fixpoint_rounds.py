"""fixpoint_rounds: the mean fixpoint rounds a stream over the window, as
`decode_v3.decode_group` returns them (the program's counter)."""
import statistics


def read(ctx):
    rounds = ctx.window.counters.get("rounds")
    return statistics.fmean(rounds) if rounds else None
