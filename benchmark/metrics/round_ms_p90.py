"""``round_ms_p90``: the 90th percentile of every round's wall time in the
window, as the trainer logs it (``phase == "round"``, ``seconds``, taken
around a round that ends in a synchronize); host clock.  A round here is
the fit's: a refinement logs one entry for all its rounds (``phase ==
"refine"``), which this leaves out."""

import statistics


def read(run):
    rounds = run.round_seconds
    if len(rounds) < 10:
        return None
    return 1e3 * statistics.quantiles(rounds, n=10)[8]
