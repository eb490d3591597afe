"""``replay_host_ms_per_round`` (compiled programs, ``models/graphs.py``):
the host milliseconds inside the program's ``span.graphs.replay`` labels
(a captured step's graph launch, host side) over the profiled job's
``span.engine.round`` labels.  Under the profiler the launch carries
CUPTI's cost per kernel node, so this reads the launch as profiled: on
an H100 a whole-brain Grams launch reads ~338 ms profiled and ~3.5 ms
without a profiler.  Nothing where the program has no such labels.  A
round is a ``span.engine.round`` label, which only the fit's rounds
carry: in a cell that refines, the refinement's count without its
rounds."""


def read(run):
    if run.profile is None:
        return None
    labels = run.profile.labels
    rounds = sum(1 for n, _, _ in labels if n == "span.engine.round")
    replays = [e - s for n, s, e in labels if n == "span.graphs.replay"]
    if not rounds or not replays:
        return None
    return 1e-3 * sum(replays) / rounds
