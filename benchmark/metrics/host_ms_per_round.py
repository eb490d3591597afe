"""``host_ms_per_round`` (engine, ``engine/trainer.py``): a round's logged
seconds less its step spans (motion epochs, Grams, trace update), per
round of the window: the audit, the finiteness checks, host reads and
logging between the steps.  The fit's rounds only: nothing in a cell that
refines, whose refinement's spans lie outside the rounds' seconds."""


def read(run):
    if run.spans is None or not run.rounds_done or run.refine_rounds:
        return None
    steps = sum(run.spans.values())
    return 1e3 * (sum(run.round_seconds) - steps) / run.rounds_done
